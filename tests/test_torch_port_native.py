"""The port's native resampler (``mlagg_unet_torch/native``, built from
``mlagg_unet_torch/csrc/resample.cpp``) against the JAX package's and scipy.

The port's library must be bit-equal to the JAX package's native path (the
same arithmetic on every element, with less work in the order-3 prefilter,
and the same flags), both within 1e-9 of scipy's ``map_coordinates``;
processes that build it at once into an empty folder all load it and agree;
a compiler that fails raises.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent

CASES = (  # (input shape, output shape, order)
    ((7, 9), (13, 5), 0), ((7, 9), (13, 5), 1), ((7, 9), (13, 5), 3),
    ((5, 8, 9), (7, 12, 13), 0), ((5, 8, 9), (7, 12, 13), 1), ((5, 8, 9), (7, 12, 13), 3),
    ((9, 20, 18), (4, 11, 9), 1), ((9, 20, 18), (4, 11, 9), 3),   # downsampling
    ((32, 30), (16, 15), 3),
    ((1, 16, 12), (1, 9, 23), 3), ((1, 16, 12), (1, 9, 23), 1),   # singleton axis
    ((6, 1, 10), (9, 1, 7), 3),
    ((61, 47), (58, 45), 3), ((4, 70, 45), (6, 64, 50), 3),   # several line blocks
)


def _scipy_resize(x, new_shape, order):
    from scipy.ndimage import map_coordinates

    coords = np.meshgrid(*[(np.arange(n) + 0.5) * (o / n) - 0.5
                           for o, n in zip(x.shape, new_shape)], indexing="ij")
    return map_coordinates(x.astype(float), np.array(coords), order=order, mode="nearest")


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's loader. It rebuilds ``csrc/_mlagg_native.so`` in
    place when the file is older than its source, and caches a failed load:
    a parallel worker that finds the file half-written retries here until
    the other worker's build has finished."""
    import time

    from mlagg_unet_tpu import native

    for _ in range(60):
        if native.get_lib() is not None:
            return native
        native._tried = False
        time.sleep(1)
    pytest.fail("the JAX package's native resampler did not load")


@pytest.mark.parametrize("shape, new_shape, order", CASES,
                         ids=[f"{a}-{b}-o{o}" for a, b, o in CASES])
def test_native_resize_bit_equal_to_jax(jax_native, shape, new_shape, order):
    from mlagg_unet_torch.native import native_resize

    x = np.random.RandomState(sum(shape) + order).randn(*shape)
    got = native_resize(x, new_shape, order)
    ref = jax_native.native_resize(x, new_shape, order)
    assert got.shape == tuple(new_shape) and got.dtype == np.float64
    assert np.array_equal(got, ref)
    sp = _scipy_resize(x, new_shape, order)
    assert np.abs(got - sp).max() <= 1e-9
    assert np.abs(ref - sp).max() <= 1e-9


@pytest.mark.parametrize("is_seg", (False, True))
def test_resize_equal_in_both_packages(jax_native, is_seg):
    """``_resize`` and the data/seg resampling of both packages."""
    from mlagg_unet_tpu.preprocessing import resampling as jr
    from mlagg_unet_torch.preprocessing import resampling as tr

    rs = np.random.RandomState(5)
    x = rs.randn(9, 21, 17)
    assert np.array_equal(tr._resize(x, (6, 30, 11), 3), jr._resize(x, (6, 30, 11), 3))
    data = (rs.rand(1, 6, 21, 17) * 3).astype(np.float32)
    if is_seg:
        data = np.floor(data)
    kw = dict(new_shape=(6, 30, 25), current_spacing=(3.0, 0.8, 0.8),
              new_spacing=(3.0, 0.56, 0.544), is_seg=is_seg, order=1 if is_seg else 3,
              order_z=0)
    assert np.array_equal(tr.resample_data_or_seg_to_shape(data, **kw),
                          jr.resample_data_or_seg_to_shape(data, **kw))


def test_unsupported_requests_go_to_scipy(monkeypatch):
    from mlagg_unet_torch import native
    from mlagg_unet_torch.preprocessing.resampling import _resize

    x = np.random.RandomState(0).randn(6, 7)
    assert native.native_resize(x, (9, 4), 2) is None
    assert native.native_resize(np.zeros((2, 3, 4, 5)), (2, 3, 4, 6), 1) is None
    assert np.abs(_resize(x, (9, 4), 2) - _scipy_resize(x, (9, 4), 2)).max() == 0
    monkeypatch.setenv("MLAGG_DISABLE_NATIVE", "1")
    assert native.native_resize(x, (9, 4), 3) is None
    assert np.array_equal(_resize(x, (9, 4), 3), _scipy_resize(x, (9, 4), 3))


_BUILD_AND_RESIZE = """
import sys, numpy as np
from pathlib import Path
from mlagg_unet_torch import native
native.BUILD_DIR = Path(sys.argv[1])
x = np.random.RandomState(0).randn(5, 30, 28)
out = native.native_resize(x, (7, 41, 19), 3)
np.save(sys.argv[2], out)
print(native.library_path().name)
"""


def test_concurrent_builds_into_an_empty_folder(tmp_path):
    """Four processes build into the same empty folder at once: each loads a
    whole library (compiled under a temporary name, then moved into place)
    and they agree."""
    build = tmp_path / "_build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_RESIZE, str(build),
                               str(tmp_path / f"out{i}.npy")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in build.iterdir()) == sorted(names)  # no temporary left
    results = [np.load(tmp_path / f"out{i}.npy") for i in range(4)]
    for r in results[1:]:
        assert np.array_equal(r, results[0])
    x = np.random.RandomState(0).randn(5, 30, 28)
    assert np.abs(results[0] - _scipy_resize(x, (7, 41, 19), 3)).max() <= 1e-9


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises with its stderr (no quiet scipy)."""
    from mlagg_unet_torch import native
    from mlagg_unet_torch.preprocessing.resampling import _resize

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "FLAG_SETS", tuple(
        f + ["-fno-such-option-at-all"] for f in native.FLAG_SETS))
    with pytest.raises(RuntimeError, match="no-such-option-at-all"):
        _resize(np.ones((4, 5)), (6, 7), 3)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-compiler-here"))
    with pytest.raises(RuntimeError, match="building the native resampler failed"):
        native.native_resize(np.ones((4, 5)), (6, 7), 1)
