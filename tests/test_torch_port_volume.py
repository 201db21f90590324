"""The PyTorch port's finished VolumePredictor against the JAX package's:
its options (no Gaussian, bf16 transfer, fp32 upload, the host-accumulator
fallback), ``make_tile_predictor``, ``predict_sliding_window_return_logits``
with 2D tiles in z mode and with 3D tiles, and the pure tile-batch
functions (fp32, max|diff| <= 1e-4 * max|ref| + 1e-5 unless stated)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mlagg_unet_tpu.inference import memory_budget as jmb
from mlagg_unet_tpu.inference import sliding_window as jsw
from mlagg_unet_tpu.models.mlla_uper import MLLAUper as JaxMLLAUper
from mlagg_unet_torch.inference import memory_budget as tmb
from mlagg_unet_torch.inference import sliding_window as tsw
from mlagg_unet_torch.models.mlla_uper import MLLAUper
from port_helpers import (assert_close, load_jax_params, one_torch_thread,  # noqa: F401
                          random_jax_params)

TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship in both packages with the same random weights, and
    a 1x2x40x30 volume (W 30 < 32: padded in-plane)."""
    jm = JaxMLLAUper(out_channels=3, **TINY)
    params = random_jax_params(jm, jnp.zeros((1, 32, 32, 1)), seed=1)
    tm = load_jax_params(MLLAUper(1, 3, **TINY), params)
    data = np.random.RandomState(0).rand(1, 2, 40, 30).astype(np.float32)
    return jm, params, tm, data


class _CountHost:
    """Counts a predictor class's ``_run_host`` calls."""

    def __init__(self, monkeypatch, cls):
        self.calls = 0
        orig = cls._run_host

        def wrapped(vp, *a, **k):
            self.calls += 1
            return orig(vp, *a, **k)

        monkeypatch.setattr(cls, "_run_host", wrapped)


@pytest.mark.parametrize("case", ["no_gaussian", "transfer_bf16", "upload_fp32",
                                  "host_accumulator"])
def test_volume_predictor_options_match_jax(case, tiny, monkeypatch):
    jm, params, tm, data = tiny
    kw_j, kw_t, rel = {}, {}, 1e-4
    if case == "no_gaussian":
        kw_j = kw_t = dict(use_gaussian=False)
    elif case == "transfer_bf16":
        kw_j, kw_t, rel = dict(transfer_dtype=jnp.bfloat16), dict(transfer_dtype=torch.bfloat16), 1e-2
    elif case == "upload_fp32":
        kw_j, kw_t = dict(upload_dtype=jnp.float32), dict(upload_dtype=torch.float32)
    else:  # a budget too small for the accumulator: the host path on both sides
        monkeypatch.setenv("MLAGG_HBM_BYTES", "1000")
        count_j, count_t = (_CountHost(monkeypatch, jsw.VolumePredictor),
                            _CountHost(monkeypatch, tsw.VolumePredictor))
    ref = jsw.VolumePredictor(jm.apply, params, (32, 32), 3, (0, 1), tile_batch_size=3,
                              **kw_j)(data)
    got = tsw.VolumePredictor(tm, (32, 32), 3, (0, 1), tile_batch_size=3, device="cpu",
                              **kw_t)(data)
    assert got.dtype == np.float32 and got.shape == ref.shape == (3, 2, 40, 30)
    assert_close(got, np.asarray(ref, np.float32), rel=rel)
    if case == "host_accumulator":
        assert count_j.calls == count_t.calls == 1
    if case == "upload_fp32":
        # under bf16 compute an fp32 upload gives exactly the auto (bf16) upload
        a, b = (tsw.VolumePredictor(tm, (32, 32), 3, (0, 1), tile_batch_size=3, device="cpu",
                                    compute_dtype=torch.bfloat16, upload_dtype=u)(data)
                for u in ("auto", torch.float32))
        np.testing.assert_array_equal(a, b)


def test_tile_batch_none_raises_on_cpu(tiny):
    with pytest.raises(ValueError, match="tile_batch_size"):
        tsw.VolumePredictor(tiny[2], (32, 32), 3, device="cpu")


def test_make_tile_predictor_matches_jax(linear):
    apply_fn, params, model = linear(1)
    tiles = np.random.RandomState(2).rand(4, 32, 32, 1).astype(np.float32)
    ref = jsw.make_tile_predictor(apply_fn, params, (32, 32), 3, (0, 1), 4)(tiles)
    got = tsw.make_tile_predictor(model, (32, 32), 3, (0, 1), 4, device="cpu")(tiles)
    assert got.shape == (4, 32, 32, 3)
    assert_close(got, np.asarray(ref))


def test_predict_sliding_window_z_mode_matches_jax(linear, tiny):
    """2D tiles over a 3D volume go through the volume path (step 0.5)."""
    apply_fn, params, model = linear(1)
    data = tiny[3]
    ref = jsw.predict_sliding_window_return_logits(apply_fn, params, data, (32, 32), 3,
                                                   (0, 1), tile_batch_size=5)
    got = tsw.predict_sliding_window_return_logits(model, data, (32, 32), 3, (0, 1),
                                                   tile_batch_size=5, device="cpu")
    assert got.shape == (3, 2, 40, 30)
    assert_close(got, ref)


class _Linear(nn.Module):
    """A one-layer per-pixel linear "network" on channels-last tiles."""

    def __init__(self, w, b):
        super().__init__()
        self.lin = nn.Linear(w.shape[0], w.shape[1])
        self.lin.weight.data = torch.from_numpy(w.T.copy())
        self.lin.bias.data = torch.from_numpy(b)

    def forward(self, x):
        return self.lin(x)


def _linear_apply(variables, x):
    return x @ variables["params"]["w"] + variables["params"]["b"]


@pytest.fixture(scope="module")
def linear():
    """(in_channels) -> the linear network as JAX (apply_fn, params) and as
    the port's module, 3 classes, the same random weights."""
    def make(cin):
        rs = np.random.RandomState(3)
        w, b = rs.randn(cin, 3).astype(np.float32), rs.randn(3).astype(np.float32)
        return _linear_apply, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, _Linear(w, b)
    return make


@pytest.fixture(scope="module")
def linear3d(linear):
    data = np.random.RandomState(4).rand(2, 12, 40, 36).astype(np.float32)
    return (*linear(2), data)


@pytest.mark.parametrize("step,gauss", [(0.5, True), (0.3, False)])
def test_predict_sliding_window_3d_matches_jax(linear3d, step, gauss):
    """3D tiles at any step, with or without the Gaussian, mirror TTA over
    all three axes and a padded tail batch."""
    apply_fn, params, model, data = linear3d
    ref = jsw.predict_sliding_window_return_logits(
        apply_fn, params, data, (8, 32, 32), 3, (0, 1, 2), tile_step_size=step,
        tile_batch_size=3, use_gaussian=gauss)
    got = tsw.predict_sliding_window_return_logits(
        model, data, (8, 32, 32), 3, (0, 1, 2), tile_step_size=step, tile_batch_size=3,
        use_gaussian=gauss, device="cpu")
    assert got.shape == ref.shape == (3, 12, 40, 36)
    assert_close(got, ref)


def test_volume_predictor_3d_tiles_matches_jax(linear3d):
    apply_fn, params, model, data = linear3d
    ref = jsw.VolumePredictor(apply_fn, params, (8, 32, 32), 3, (1, 2), tile_batch_size=4)(data)
    got = tsw.VolumePredictor(model, (8, 32, 32), 3, (1, 2), tile_batch_size=4,
                              device="cpu")(data)
    assert_close(got, ref)


@pytest.mark.parametrize("n_tiles", [0, 1, 7, 40, 41, 400])
@pytest.mark.parametrize("per_tile", [1, 3_000_000, 10 ** 9])
@pytest.mark.parametrize("granule", [1, 2])
def test_select_tile_batch_matches_jax(n_tiles, per_tile, granule):
    for budget, fixed in ((64 * 10 ** 9, 10 ** 8), (10 ** 9, 5 * 10 ** 8), (10 ** 6, 0)):
        assert (tmb.select_tile_batch(budget, fixed, per_tile, n_tiles, granule)
                == jmb.select_tile_batch(budget, fixed, per_tile, n_tiles, granule))
    assert (tmb.accumulator_bytes((10, 320, 260), 4, 1)
            == jmb.accumulator_bytes((10, 320, 260), 4, 1))


@pytest.mark.parametrize("tb_max", [1, 2, 3, 4, 8, 16, 40, 64])
@pytest.mark.parametrize("n_combos", [1, 2, 4, 8])
def test_autotune_candidates_match_jax(tb_max, n_combos):
    assert (tsw.VolumePredictor.autotune_candidates(tb_max, n_combos)
            == jsw.VolumePredictor.autotune_candidates(tb_max, n_combos))


def test_autotune_cache_is_keyed_on_channels_and_cap(tiny, monkeypatch):
    """A second volume with a smaller budget cap is tuned again among its own
    candidates, not handed the first volume's pick."""
    vp = tsw.VolumePredictor(tiny[2], (32, 32), 3, (0, 1), tile_batch_size=2, device="cpu")
    vp.device = torch.device("cuda")   # the timing itself is stubbed below
    timed = []

    def fake_time(t, in_channels):     # larger batches are faster per tile
        timed.append((t, in_channels))
        return 1.0 / t

    monkeypatch.setattr(vp, "_time_tile_batch", fake_time)
    assert vp._autotune_tb(40, 1) == 8          # candidates 2, 4, 8
    assert vp._autotune_tb(40, 1) == 8 and len(timed) == 3   # cached
    assert vp._autotune_tb(3, 1) == 3           # candidates 2, 3: tuned again
    assert vp._autotune_tb(40, 2) == 8          # another channel count
    assert timed == [(2, 1), (4, 1), (8, 1), (2, 1), (3, 1), (2, 2), (4, 2), (8, 2)]
    assert vp.autotune_ms[(1, 3)] == {2: 0.5, 3: 1 / 3}
    assert set(vp.autotune_ms) == {(1, 40), (1, 3), (2, 40)}
    monkeypatch.setenv("MLAGG_AUTOTUNE_TB", "0")
    assert vp._autotune_tb(16, 3) == 16
