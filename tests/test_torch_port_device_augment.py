"""The port's on-device augmentation (``mlagg_unet_torch/data/device_augment.py``)
against JAX's (``mlagg_unet_tpu/data/device_augment.py``) on the same inputs.

The draws differ by construction (``jax.random`` keys against a host
``torch.Generator``), so each transform is held with forced parameters, as
``tests/test_device_augment.py`` forces them: gate probabilities above 1 and
degenerate ranges. Data within 1e-5·max of JAX, seg equal. A draw that
cannot be forced (the noise) is held by its statistic."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.data import device_augment as J
from mlagg_unet_torch.data import device_augment as T
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_augment_parity import _bg_rot3d

KEY = jax.random.PRNGKey(0)
TOL = 1e-5
ROT3 = {"x": (0.3, 0.3), "y": (-0.2, -0.2), "z": (0.15, 0.15)}
ROT2 = {"x": (0.4, 0.4), "y": (0, 0), "z": (0, 0)}


def gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), err


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_spatial(data, seg, patch, rotation, **kw):
    fn = jax.jit(partial(J.spatial_augment_device, patch_size=patch,
                         rotation_for_da=rotation, **kw))
    d, s = fn(jnp.asarray(data), jnp.asarray(seg), KEY)
    return np.asarray(d), np.asarray(s)


def test_rot3d_matches_jax_and_batchgenerators():
    angles = [torch.tensor([0.3, -1.1]), torch.tensor([-0.2, 0.4]), torch.tensor([0.15, 2.0])]
    got = T._rot3d(*angles).numpy()
    for i in range(2):
        a = [float(x[i]) for x in angles]
        close(got[i], J._rot3d(*(jnp.float32(v) for v in a)), 1e-6)
        close(got[i], _bg_rot3d(*a), 1e-6)
    close(T._rot2d(torch.tensor([0.4]))[0], J._rot2d(jnp.float32(0.4)), 1e-6)


@pytest.mark.parametrize("dim,interp", [(2, "ord1"), (2, "ord3"), (3, "ord1"), (3, "ord3")])
def test_spatial_matches_jax(dim, interp):
    """Rotation and scale forced (p 1.1, degenerate ranges): data order 1 or
    3, seg order 0 or the one-hot order 1, two samples of two channels."""
    rs = np.random.RandomState(dim)
    inflated, patch = ((30, 34), (16, 19)) if dim == 2 else ((26, 30, 28), (12, 14, 10))
    data = rs.randn(2, 2, *inflated).astype(np.float32)
    seg = rs.randint(0, 4, (2, *inflated)).astype(np.int32)
    seg[:, :3] = -1      # the loader's padding
    kw = dict(scale_range=(1.1, 1.1), p_rot=1.1, p_scale=1.1,
              order_data=3 if interp == "ord3" else 1, order_seg=1 if interp == "ord3" else 0,
              num_classes=4)
    rot = ROT2 if dim == 2 else ROT3
    d, s = T.spatial_augment_device(t(data), t(seg), gen(), patch, rot, **kw)
    assert d.shape == (2, 2, *patch) and s.shape == (2, *patch)
    for i in range(2):
        jd, js = jax_spatial(data[i], seg[i].astype(np.float32), patch, rot, **kw)
        close(d[i], jd)
        np.testing.assert_array_equal(s[i].numpy(), js)


def test_spatial_without_rotation_or_scale_is_the_centre_crop():
    """p 0: every coordinate an integer or, where the inflated and the final
    size differ in parity, an integer + 0.5 (the flagship's 301 -> 224 axis).
    Both profiles equal JAX's; order 1 and 3 give the centre crop where the
    coordinates are integers."""
    rs = np.random.RandomState(7)
    inflated, patch = (21, 25), (12, 14)        # 21 -> 12 half-integer, 25 -> 14 too
    data = rs.randn(1, 1, *inflated).astype(np.float32)
    seg = rs.randint(0, 3, (1, *inflated)).astype(np.int32)
    for interp in ("ord1", "ord3"):
        kw = dict(p_rot=0.0, p_scale=0.0, order_data=3 if interp == "ord3" else 1,
                  order_seg=1 if interp == "ord3" else 0, num_classes=3)
        d, s = T.spatial_augment_device(t(data), t(seg), gen(), patch, ROT2, **kw)
        jd, js = jax_spatial(data[0], seg[0].astype(np.float32), patch, ROT2, **kw)
        close(d[0], jd)
        np.testing.assert_array_equal(s[0].numpy(), js)
    inflated3, patch3 = (20, 22, 24), (12, 14, 16)    # integer offsets
    data3 = rs.randn(1, 1, *inflated3).astype(np.float32)
    seg3 = rs.randint(0, 3, (1, *inflated3)).astype(np.int32)
    sl = tuple(slice((s - p) // 2, (s - p) // 2 + p) for s, p in zip(inflated3, patch3))
    for order in (1, 3):
        d, s = T.spatial_augment_device(t(data3), t(seg3), gen(), patch3, ROT3, p_rot=0.0,
                                        p_scale=0.0, order_data=order, order_seg=order // 3,
                                        num_classes=3)
        close(d[0, 0], data3[0, 0][sl], 1e-5)
        np.testing.assert_array_equal(s[0].numpy(), seg3[0][sl])


def test_blur_and_low_resolution_match_jax():
    """Blur (sigma 0.8 forced, every channel) and the low-resolution pass at
    zoom 0.62 with the order-1 and the cubic upsample, in 2-D and 3-D."""
    rs = np.random.RandomState(8)
    for shape in ((2, 2, 24, 26), (2, 1, 14, 17, 11)):
        x = rs.randn(*shape).astype(np.float32)
        got = T.gaussian_blur_device(t(x), gen(), p=1.1, sigma_range=(0.8, 0.8),
                                     p_per_channel=1.1)
        for up in (1, 3):
            low = T.simulate_low_resolution_device(t(x), gen(), p=1.1, zoom_range=(0.62, 0.62),
                                                   p_per_channel=1.1, up_order=up)
            ref = jax.jit(partial(J.simulate_low_resolution_device, p=1.1,
                                  zoom_range=(0.62, 0.62), p_per_channel=1.1, up_order=up))
            for i in range(2):
                close(low[i], ref(jnp.asarray(x[i]), KEY))
        for i in range(2):
            close(got[i], J.gaussian_blur_device(jnp.asarray(x[i]), KEY, p=1.1,
                                                 sigma_range=(0.8, 0.8), p_per_channel=1.1))


def test_intensity_transforms_match_jax():
    """Gamma (inverted and not, gamma 1.3 forced), contrast (0.8, range
    kept) and brightness (x1.1) on two samples of two channels."""
    rs = np.random.RandomState(9)
    x = (rs.randn(2, 2, 18, 21) * 2 + 1).astype(np.float32)
    for invert in (True, False):
        got = T.gamma_transform_device(t(x), gen(), p=1.1, gamma_range=(1.3, 1.3),
                                       invert_image=invert)
        for i in range(2):
            close(got[i], J.gamma_transform_device(jnp.asarray(x[i]), KEY, p=1.1,
                                                   gamma_range=(1.3, 1.3),
                                                   invert_image=invert))
    got = T.contrast_augmentation_device(t(x), gen(), p=1.1, contrast_range=(0.8, 0.8))
    bright = T.brightness_multiplicative_device(t(x), gen(), p=1.1, mult_range=(1.1, 1.1))
    for i in range(2):
        close(got[i], J.contrast_augmentation_device(jnp.asarray(x[i]), KEY, p=1.1,
                                                     contrast_range=(0.8, 0.8)))
        close(bright[i], J.brightness_multiplicative_device(jnp.asarray(x[i]), KEY, p=1.1,
                                                           mult_range=(1.1, 1.1)))


def test_mirror_and_identity_at_p0():
    """A flipped sample's data and seg flip together, over several draws;
    every gated transform at p 0 returns its input."""
    rs = np.random.RandomState(10)
    data = t(rs.randn(4, 1, 8, 10).astype(np.float32))
    seg = t(rs.randint(0, 2, (4, 8, 10)).astype(np.int32))
    g, flips = gen(3), 0
    for _ in range(4):
        d, s = T.mirror_device(data, seg, g, (0, 1))
        for b in range(4):
            for axes in ((), (0,), (1,), (0, 1)):
                if torch.equal(d[b], data[b].flip([a + 1 for a in axes]) if axes else data[b]):
                    ref = seg[b].flip(list(axes)) if axes else seg[b]
                    assert torch.equal(s[b], ref)
                    flips += bool(axes)
                    break
            else:
                raise AssertionError("a sample was neither kept nor flipped")
    assert flips > 0
    g, ng = gen(), torch.Generator().manual_seed(1)
    assert T.gaussian_noise_device(data, g, ng, p=0.0) is data
    assert T.gaussian_blur_device(data, g, p=0.0) is data
    assert T.brightness_multiplicative_device(data, g, p=0.0) is data
    assert T.contrast_augmentation_device(data, g, p=0.0) is data
    assert T.simulate_low_resolution_device(data, g, p=0.0) is data
    assert T.gamma_transform_device(data, g, p=0.0) is data


def test_noise_statistic():
    """The noise cannot be forced: at variance 0.04 forced, the added noise
    has mean 0 and standard deviation 0.2 (as JAX's has), and the draws of
    one seed repeat."""
    x = torch.zeros(2, 1, 64, 64)
    got = T.gaussian_noise_device(x, gen(), torch.Generator().manual_seed(5), p=1.1,
                                  noise_variance=(0.04, 0.04))
    again = T.gaussian_noise_device(x, gen(), torch.Generator().manual_seed(5), p=1.1,
                                    noise_variance=(0.04, 0.04))
    ref = np.asarray(J.gaussian_noise_device(jnp.zeros((1, 64, 64)), KEY, p=1.1,
                                             noise_variance=(0.04, 0.04)))
    assert torch.equal(got, again)
    for sample in (got.numpy(), ref):
        assert abs(sample.mean()) < 0.01 and abs(sample.std() - 0.2) < 0.01


def test_flag_values():
    """JAX's gate: '' and '0' off, '1' and 'ord3' the reference default,
    'ord1' the order-1/0 profile; anything else raises naming ord3."""
    for value, want in (("", ""), ("0", ""), ("1", "ord3"), ("ord3", "ord3"), ("ord1", "ord1")):
        assert T.parse_device_aug_flag(value) == J.parse_device_aug_flag(value) == want
    for bad in ("true", "yes", "ord0", "2"):
        with pytest.raises(ValueError, match="ord3"):
            T.parse_device_aug_flag(bad)
    with pytest.raises(ValueError, match="num_classes"):
        T.DeviceTrainingTransforms((8, 8), ROT2, (0, 1), interp="ord3")


@pytest.mark.parametrize("interp", ["ord1", "ord3"])
def test_full_stack_shapes_and_finiteness(interp):
    """``DeviceTrainingTransforms`` end to end in 2-D and 3-D: channels-last
    contiguous float32 data, int32 seg with the padding's -1 removed, finite
    values; the same generator seeds give the same batch."""
    rs = np.random.RandomState(11)
    for inflated, patch in (((3, 2, 36, 40), (24, 28)), ((2, 1, 20, 24, 22), (12, 16, 14))):
        dim = len(patch)
        rot = {"x": (-0.3, 0.3), "y": (-0.3, 0.3), "z": (-0.3, 0.3)}
        tr = T.DeviceTrainingTransforms(patch, rot, tuple(range(dim)), interp=interp,
                                        num_classes=3)
        data = t(rs.randn(*inflated).astype(np.float32))
        seg = t(rs.randint(-1, 3, (inflated[0], *inflated[2:])).astype(np.int32))
        d, s = tr(data, seg, gen(1), torch.Generator().manual_seed(2))
        assert d.shape == (inflated[0], *patch, inflated[1]) and d.dtype == torch.float32
        assert d.is_contiguous()
        assert s.shape == (inflated[0], *patch) and s.dtype == torch.int32
        assert torch.isfinite(d).all() and int(s.min()) >= 0 and int(s.max()) <= 2
        d2, s2 = tr(data, seg, gen(1), torch.Generator().manual_seed(2))
        assert torch.equal(d, d2) and torch.equal(s, s2)
