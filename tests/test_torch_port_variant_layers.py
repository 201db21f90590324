"""The layer pieces of the Mamba variants in the PyTorch port against the
JAX package on the CPU: GroupNorm, the parameterless InstanceNorm, a dilated
conv, a 1-D conv, 2x max-pool and nearest upsampling, align-corners bilinear
upsampling (an extent of 1 included), half-pixel linear upsampling with
per-axis factors, and the UNETR blocks in 3-D with per-axis kernels; the
flagship's 2-D blocks keep their parameter names. Each within 1e-5 of JAX
(``max |diff| <= 1e-5 x max |ref| + 1e-6``), from weights drawn with numpy
into JAX's param tree and carried by ``jax_params_to_state_dict``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mlagg_unet_tpu.models import layers as JL
from mlagg_unet_tpu.models import mamba_variants as JMV
from mlagg_unet_tpu.models import unetr_blocks as JUB
from mlagg_unet_torch.models import layers as TL
from mlagg_unet_torch.models import unetr_blocks as TUB
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, load_jax_params, one_torch_thread, random_jax_params)

T = torch.from_numpy


def x_of(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, ref):
    assert_close(got, np.asarray(ref), rel=1e-5, atol=1e-6)


def run_both(jm, tm, x):
    """JAX's module with random numpy weights, the port's with the same."""
    params = random_jax_params(jm, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    load_jax_params(tm, params)
    with torch.no_grad():
        return tm(T(x)), ref


@pytest.mark.parametrize("shape,groups", [((2, 6, 7, 16), 8), ((1, 3, 4, 5, 8), 4),
                                          ((2, 9, 9, 12), 4)])
def test_group_norm_matches_flax(shape, groups):
    """``GroupNorm(C, G)`` is flax's ``nn.GroupNorm(num_groups=G)``: stats
    over the spatial axes and each group's channels, per-channel scale and
    bias."""
    got, ref = run_both(nn.GroupNorm(num_groups=groups, epsilon=1e-5),
                        TL.GroupNorm(shape[-1], groups), 3 * x_of(shape) + 1)
    close(got, ref)


def test_parameterless_instance_norm_matches_jax():
    """``instance_norm`` without a weight is JAX's parameterless
    ``InstanceNorm(affine=False)``: each channel normalised over the
    spatial axes, in both variance forms."""
    x = 2 * x_of((2, 3, 5, 6, 4)) - 1
    jm = JL.InstanceNorm(affine=False)
    assert jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)) == {}
    ref = jm.apply({}, jnp.asarray(x))
    close(TL.instance_norm(T(x)), ref)
    close(TL.instance_norm(T(x), two_pass=True), ref)


def test_dilated_conv_matches_flax():
    """UltraLight's spatial attention conv: 7x7, dilation 3, padding 9."""
    got, ref = run_both(nn.Conv(1, (7, 7), padding=9, kernel_dilation=3),
                        TL.Conv(2, 1, (7, 7), padding=9, dilation=3), x_of((2, 20, 24, 2)))
    close(got, ref)


def test_conv1d_matches_flax():
    """UltraLight's ``get_all_att``: a 1-D conv of kernel 3 over the
    channel axis taken as the length, no bias."""
    got, ref = run_both(nn.Conv(1, (3,), padding=1, use_bias=False),
                        TL.Conv(1, 1, (3,), padding=1, bias=False), x_of((3, 128, 1)))
    close(got, ref)


@pytest.mark.parametrize("shape", [(2, 7, 8, 3), (1, 4, 5, 6, 2)])
def test_max_pool_and_nearest_match_jax(shape):
    """2x max-pool (an odd extent drops its last row) and 2x nearest
    upsampling, 2-D and 3-D."""
    x = x_of(shape)
    close(TL.max_pool2(T(x)), JMV._maxpool2(jnp.asarray(x)))
    np.testing.assert_array_equal(TL.nearest2(T(x)).numpy(),
                                  np.asarray(JMV._nearest2(jnp.asarray(x))))


def test_bilinear_align_corners_matches_jax():
    """2x align-corners bilinear upsampling, axes of extent 1 among them
    (repeated)."""
    for shape in [(2, 5, 7, 3), (1, 1, 4, 2), (1, 3, 1, 2), (1, 1, 1, 4)]:
        x = x_of(shape)
        close(TL.bilinear_ac(T(x)), JMV._bilinear_ac(jnp.asarray(x)))


def test_linear_upsampling_matches_jax():
    """Half-pixel linear upsampling by per-axis factors (1 the identity),
    3-D and 2-D."""
    for shape, scale in [((1, 3, 4, 5, 2), (2, 2, 2)), ((2, 2, 3, 4, 3), (1, 2, 2)),
                         ((1, 4, 3, 2), (2, 1))]:
        x = x_of(shape)
        close(TL.linear_resize(T(x), scale), JMV._trilinear(jnp.asarray(x), scale))


def test_unetr_blocks_3d_match_jax():
    """``UnetrBasicBlock`` (with its projection) and ``UnetrUpBlock`` at an
    upsampling of (1, 2, 2) in 3-D against JAX's, and the basic block with
    a per-axis kernel and stride."""
    x = x_of((2, 4, 6, 6, 3))
    got, ref = run_both(JUB.UnetrBasicBlock(8), TUB.UnetrBasicBlock(3, 8, spatial_dims=3), x)
    close(got, ref)
    got, ref = run_both(JUB.UnetrBasicBlock(8, kernel_size=(1, 3, 3), stride=(1, 2, 2)),
                        TUB.UnetrBasicBlock(3, 8, (1, 3, 3), (1, 2, 2), spatial_dims=3), x)
    close(got, ref)

    h, skip = x_of((1, 3, 4, 5, 8)), x_of((1, 3, 8, 10, 4), seed=1)
    jm = JUB.UnetrUpBlock(4, upsample_kernel_size=(1, 2, 2))
    params = random_jax_params(jm, jnp.asarray(h), jnp.asarray(skip))
    ref = jm.apply({"params": params}, jnp.asarray(h), jnp.asarray(skip))
    tm = TUB.UnetrUpBlock(8, 4, 4, upsample_kernel_size=(1, 2, 2), spatial_dims=3)
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(T(h), T(skip))
    close(got, ref)


def test_flagship_blocks_keep_their_names():
    """The 2-D blocks the flagship builds keep their state_dict keys and
    shapes: a projecting basic block and an up block."""
    basic = TUB.UnetrBasicBlock(1, 48, kernel_size=3)
    assert {k: tuple(v.shape) for k, v in basic.state_dict().items()} == {
        "layer.conv1.weight": (48, 1, 3, 3), "layer.conv1.bias": (48,),
        "layer.norm1.GroupNorm_0.weight": (48,), "layer.norm1.GroupNorm_0.bias": (48,),
        "layer.conv2.weight": (48, 48, 3, 3), "layer.conv2.bias": (48,),
        "layer.norm2.GroupNorm_0.weight": (48,), "layer.norm2.GroupNorm_0.bias": (48,),
        "layer.conv3.weight": (48, 1, 1, 1), "layer.conv3.bias": (48,),
        "layer.norm3.GroupNorm_0.weight": (48,), "layer.norm3.GroupNorm_0.bias": (48,)}
    up = TUB.UnetrUpBlock(96, 48, 48, kernel_size=3, upsample_kernel_size=2)
    shapes = {k: tuple(v.shape) for k, v in up.state_dict().items()}
    assert shapes["transp_conv.weight"] == (96, 48, 2, 2)
    assert shapes["conv_block.conv1.weight"] == (48, 96, 3, 3)
    assert "conv_block.conv3.weight" in shapes and len(shapes) == 14
