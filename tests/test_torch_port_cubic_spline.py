"""The port's cubic B-spline sampling (``mlagg_unet_torch/ops/cubic_spline.py``)
against JAX's (``mlagg_unet_tpu/ops/cubic_spline.py``) and scipy on the same
inputs: the prefilter (JAX's 6·x at n = 1 included), order-3 sampling in
2-D and on a rotated 3-D grid, the one-hot seg pass, the order-0 and order-1
samplers against ``jax.scipy.ndimage.map_coordinates`` at half-integer
coordinates, and the low-resolution upsample. Tolerance 1e-5·max against
JAX; the seg and the order-0/1 samplers equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from jax.scipy.ndimage import map_coordinates as jax_map_coordinates

from mlagg_unet_tpu.ops import cubic_spline as J
from mlagg_unet_torch.ops import cubic_spline as T
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_augment_parity import _bg_rot3d

TOL = 1e-5
# JAX's functions jitted: eagerly each jnp op compiles on its own first
J_FILTER_1D = jax.jit(J.spline_filter_cubic_1d)
J_FILTER = jax.jit(J.spline_filter_cubic)
J_CUBIC = jax.jit(J.map_coordinates_cubic, static_argnames="cval")
J_LOWRES = jax.jit(J.lowres_axis_cubic_up, static_argnums=2)


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), err


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [1, 2, 5, 64, 200])
def test_prefilter_matches_jax_and_scipy(n):
    """At n = 1 JAX returns 6·x (scipy x), and so does the port."""
    x = np.random.RandomState(n).randn(3, n).astype(np.float32)
    got = T.spline_filter_cubic_1d(t(x)).numpy()
    close(got, J_FILTER_1D(jnp.asarray(x)))
    if n == 1:
        np.testing.assert_array_equal(got, 6 * x)
    else:
        close(got, ndi.spline_filter1d(x.astype(np.float64), order=3, mode="mirror"))


def test_prefilter_over_batched_axes():
    """Every axis of a 3-D array, and the same from a leading batch axis on:
    each sample filtered alone."""
    x = np.random.RandomState(1).randn(4, 9, 11, 6).astype(np.float32)
    close(T.spline_filter_cubic(t(x[0])), J_FILTER(jnp.asarray(x[0])))
    close(T.spline_filter_cubic(t(x[0])),
          ndi.spline_filter(x[0].astype(np.float64), order=3, mode="mirror"))
    batched = T.spline_filter_cubic(t(x), first_axis=1).numpy()
    for i in range(4):
        close(batched[i], J_FILTER(jnp.asarray(x[i])))


def test_map_coordinates_cubic_2d():
    """Points inside, on the edges and outside (cval) of a 20x23 image."""
    rs = np.random.RandomState(2)
    x = rs.randn(20, 23).astype(np.float32)
    co = [rs.uniform(-2, 21, (30, 7)).astype(np.float32),
          rs.uniform(-2, 24, (30, 7)).astype(np.float32)]
    co[0][0, :3] = [0.0, 19.0, 19.0001]
    got = T.map_coordinates_cubic(t(x), [t(c) for c in co], cval=0.5)
    close(got, J_CUBIC(jnp.asarray(x), [jnp.asarray(c) for c in co], cval=0.5))
    close(got, ndi.map_coordinates(x.astype(np.float64), np.stack(co), order=3,
                                   mode="constant", cval=0.5))


def test_map_coordinates_cubic_rotated_3d():
    """The spatial transform's grid: rotated, scaled and centred in an
    inflated 3-D patch."""
    rs = np.random.RandomState(3)
    inflated, patch = (22, 26, 24), (12, 14, 10)
    x = rs.randn(*inflated).astype(np.float32)
    mesh = np.stack(np.meshgrid(*[np.arange(s, dtype=float) - (s - 1) / 2 for s in patch],
                                indexing="ij"))
    coords = (np.einsum("ij,jzyx->izyx", _bg_rot3d(0.4, -0.3, 0.2).T, mesh) * 1.2
              + np.array([(s - 1) / 2 for s in inflated]).reshape(3, 1, 1, 1)).astype(np.float32)
    got = T.map_coordinates_cubic(t(x), [t(c) for c in coords])
    close(got, J_CUBIC(jnp.asarray(x), [jnp.asarray(c) for c in coords]))
    close(got, ndi.map_coordinates(x.astype(np.float64), coords, order=3, mode="constant"))


def test_seg_onehot_pass_equals_jax():
    """Labels 0-3 at rotated points, some outside (cval -1 in the score):
    equal to JAX's, and to the host's batchgenerators pass."""
    from mlagg_unet_tpu.data.augment import _interpolate_seg

    rs = np.random.RandomState(4)
    seg = rs.randint(0, 4, (18, 21)).astype(np.float32)
    co = np.stack([rs.uniform(-1.5, 18.5, (25, 9)), rs.uniform(-1.5, 21.5, (25, 9))]
                  ).astype(np.float32)
    got = T.map_coordinates_seg_linear_onehot(t(seg).long(), [t(c) for c in co], 4).numpy()
    ref = np.asarray(J.map_coordinates_seg_linear_onehot(
        jnp.asarray(seg), [jnp.asarray(c) for c in co], 4))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _interpolate_seg(seg, co.astype(np.float64), order=1,
                                                        cval=-1))


def test_order0_and_order1_samplers_equal_jax_at_half_integers():
    """Half-integer coordinates, the common case of a centre crop: order 0
    rounds half away from zero (``torch.round`` would round 2.5 to 2)."""
    rs = np.random.RandomState(5)
    x = rs.randint(-1, 4, (11, 13)).astype(np.float32)
    co = [np.round(rs.uniform(-2, 12, (40,)) * 2) / 2, np.round(rs.uniform(-2, 14, (40,)) * 2) / 2]
    co = [c.astype(np.float32) for c in co]
    co[0][:4] = [2.5, -0.5, 10.5, -1.5]
    pts = torch.stack([t(c) for c in co])[None]
    for order, fn in ((0, T.nearest_sample), (1, T.linear_sample)):
        ref = jax_map_coordinates(jnp.asarray(x), [jnp.asarray(c) for c in co], order=order,
                                  mode="constant", cval=-1.0)
        np.testing.assert_array_equal(fn(t(x)[None, None], pts, cval=-1.0)[0, 0].numpy(),
                                      np.asarray(ref))
    np.testing.assert_array_equal(T.round_half_away_from_zero(t(np.float32([2.5, -2.5, 0.5,
                                                                             1.49999988])))
                                  .numpy(), [3, -3, 1, 1])


@pytest.mark.parametrize("frac", ["one", "half", "all"])
def test_lowres_axis_cubic_up(frac):
    """Downsample to t = 1, n / 2 and n along each axis of a 3-D array, then
    the cubic upsample; and one length per channel on a batch."""
    rs = np.random.RandomState(6)
    x = rs.randn(3, 14, 17, 11).astype(np.float32)
    for ax in range(3):
        n = x.shape[ax + 1]
        tt = {"one": 1, "half": n // 2, "all": n}[frac]
        close(T.lowres_axis_cubic_up(t(x[0]), tt, ax),
              J_LOWRES(jnp.asarray(x[0]), tt, ax))
        lengths = [max(1, tt - 1), tt, max(1, (tt + n) // 2)]
        got = T.lowres_axis_cubic_up(t(x), torch.tensor(lengths, dtype=torch.float32), ax + 1)
        for g, tg in enumerate(lengths):
            close(got[g], J_LOWRES(jnp.asarray(x[g]), tg, ax))
