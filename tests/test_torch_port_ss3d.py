"""The 12-direction SS3D cell and its parts in the PyTorch port against the
JAX package on the CPU: the 12-path scan layouts and their merge, ``SS3D12``
with and without z, ``VSSBlock3D`` with both MLPs, the shifted-window block
of the SwinT bottleneck (a window larger than the map, padding, the shift
mask), the helpers of the window attention, and ``ConvTransposeTorch`` with
``output_padding``.

Weights come from numpy seeds into the JAX param tree
(``port_helpers.random_jax_params``) and are carried across with
``jax_params_to_state_dict``; inputs from numpy seeds. fp32 outputs within
1e-4 x max|ref| (+1e-5); the layouts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import layers as JL
from mlagg_unet_tpu.models import vmunet3d as JV
from mlagg_unet_torch.models import layers as TL
from mlagg_unet_torch.models import vmunet3d as TV
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, load_jax_params, one_torch_thread, random_jax_params)

T = torch.from_numpy


def _x(shape, seed=0):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _run(jm, tm, x, params=None):
    params = params if params is not None else random_jax_params(jm, x)
    ref = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = load_jax_params(tm, params)(T(np.array(x)))
    return got, ref


def test_scan12_and_merge_match_jax():
    """The 12 paths (six axis orders, then the six reversed) and their merge
    equal JAX's exactly; merging the paths of one map gives 12 times it."""
    x = _x((2, 3, 4, 5, 6))
    xs = TV.scan12_3d(T(np.array(x)))
    assert xs.shape == (2, 12, 6, 60)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(JV._scan12_3d(x)))
    ys = _x((2, 12, 6, 60), seed=1)
    np.testing.assert_array_equal(TV.merge12_3d(T(np.array(ys)), 3, 4, 5).numpy(),
                                  np.asarray(JV._merge12_3d(ys, 3, 4, 5)))
    back = TV.merge12_3d(xs, 3, 4, 5)  # 12 equal terms: the sum rounds
    np.testing.assert_allclose(back.numpy(), 12 * np.asarray(x).transpose(0, 4, 1, 2, 3)
                               .reshape(2, 6, 60), rtol=1e-6)


@pytest.mark.parametrize("no_z", [False, True])
@pytest.mark.parametrize("d_state", [1, 16])
def test_ss3d12_matches_jax(no_z, d_state):
    """The cell with and without the z gate, at the SS3D U-Mambas' d_state 1
    and VM-UNet-3D's 16 (a 3x4x5 map: every axis order differs)."""
    x = _x((2, 3, 4, 5, 8))
    got, ref = _run(JV.SS3D12(d_model=8, d_state=d_state, no_z=no_z),
                    TV.SS3D12(8, d_state=d_state, no_z=no_z), x)
    assert_close(got, ref)


@pytest.mark.parametrize("mlp_type", ["plain", "conv_glu"])
def test_vss_block3d_matches_jax(mlp_type):
    """The block with monai's plain MLP (U-Mamba Enc SS3D) and the
    ConvolutionalGLU (VM-UNet-3D, U-Mamba Bot SS3D)."""
    x = _x((2, 3, 4, 5, 8), seed=2)
    got, ref = _run(JV.VSSBlock3D(d_state=1, mlp_ratio=2.0, no_z=True, mlp_type=mlp_type),
                    TV.VSSBlock3D(8, d_state=1, mlp_ratio=2.0, no_z=True, mlp_type=mlp_type), x)
    assert_close(got, ref)


@pytest.mark.parametrize("shift", [False, True])
def test_swin_block3d_matches_jax(shift):
    """A (2, 3, 2) window on a 3x5x4 map: padded to 4x6x4, and shifted by
    (1, 1, 1) with the mask between rolled regions. JAX's mask is built from
    concrete arrays, so its shifted block runs eagerly (its params' shapes
    come from the unshifted block)."""
    x = _x((2, 3, 5, 4, 8), seed=3)
    params = random_jax_params(JV.SwinBlock3D(num_heads=2, window_size=(2, 3, 2)), x)
    got, ref = _run(JV.SwinBlock3D(num_heads=2, window_size=(2, 3, 2), shift=shift),
                    TV.SwinBlock3D(8, 2, (2, 3, 2), shift=shift), x, params)
    assert_close(got, ref)


def test_window_helpers_match_jax():
    """The relative-position index, the shift mask and the window partition
    and its reverse equal JAX's; a window clamped to the map takes the
    configured index's top-left block."""
    np.testing.assert_array_equal(TV.rel_pos_index3d((5, 6, 7)), JV._rel_pos_index3d((5, 6, 7)))
    np.testing.assert_array_equal(TV.shift_mask3d((4, 6, 4), (2, 3, 2), (1, 1, 1)),
                                  JV._shift_mask3d((4, 6, 4), (2, 3, 2), (1, 1, 1)))
    x = _x((2, 4, 6, 4, 3), seed=4)
    win = TV.window_partition3d(T(np.array(x)), (2, 3, 2))
    np.testing.assert_array_equal(win.numpy(), np.asarray(JV._window_partition3d(x, (2, 3, 2))))
    np.testing.assert_array_equal(TV.window_reverse3d(win, (2, 3, 2), 4, 6, 4).numpy(),
                                  np.asarray(x))
    attn = TV.WindowAttention3D(8, 2, (5, 6, 7))
    assert attn.relative_position_bias_table.shape == (9 * 11 * 13, 2)
    assert attn.index.shape == (210, 210)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_output_padding_matches_jax(k):
    """3-D kernels 2 and 4 (VM-UNet-3D's (2, 4, 4) up block) with padding
    (k - 1) // 2 and output padding s + 2p - k: the output is exactly the
    stride times the input, and equals JAX's."""
    ks = (2, k, k)
    ps = tuple((i - 1) // 2 for i in ks)
    ops = tuple(s + 2 * p - i for s, p, i in zip(ks, ps, ks))
    x = _x((2, 3, 4, 5, 6), seed=5)
    jm = JL.ConvTransposeTorch(4, ks, ks, ps, spatial_dims=3, output_padding=ops)
    params = random_jax_params(jm, x)
    tm = load_jax_params(TL.ConvTransposeTorch(6, 4, ks, ks, ps, ops), params, "transp_conv/")
    with torch.no_grad():
        got = tm(T(np.array(x)))
    assert got.shape == (2, 3 * 2, 4 * k, 5 * k, 4)
    assert_close(got, jm.apply({"params": params}, x))
