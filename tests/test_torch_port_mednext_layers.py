"""MedNeXt's layers in the PyTorch port against the JAX package on the CPU:
the transposed conv with groups and per-axis kernel, stride and padding,
``pad_top_left`` with per-axis amounts, MedNeXt's up and down blocks
(isotropic and anisotropic strides, with GRN), the multi-scale Mamba skip
over five scales (JAX pads the concatenated sequence to its scan's chunk and
cuts it again; the port scans it as it is), and the gradients of MedNeXt S
with that skip.

Weights come from numpy seeds into the JAX param tree and through
``weights.jax_params_to_state_dict`` (the depthwise transposed kernel of an
up block among them); inputs from numpy seeds. Outputs are held within 1e-4
x max|ref| (+1e-5), gradients within 2e-4 x max|ref| (+1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_zoo
from mlagg_unet_tpu.models import layers as JL
from mlagg_unet_tpu.models import mamba_skip as JMS
from mlagg_unet_tpu.models import mednext as JMX
from mlagg_unet_torch.models import layers as TL
from mlagg_unet_torch.models import mamba_skip as TMS
from mlagg_unet_torch.models import mednext as TMX
from port_helpers import assert_close, load_jax_params, one_torch_thread  # noqa: F401
from port_helpers import random_jax_params

T = torch.from_numpy


def x_of(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (input shape, out channels, kernel, stride, padding, output padding, groups)
CONV_T = {
    "2d_depthwise": ((2, 5, 6, 6), 6, 3, 2, 1, 0, 6),
    "3d_depthwise_anisotropic": ((1, 3, 4, 5, 4), 4, (1, 3, 3), (1, 2, 2), (0, 1, 1), 0, 4),
    "2d_two_groups_per_axis": ((1, 5, 4, 4), 6, (3, 2), (2, 1), (1, 0), (1, 0), 2),
}


def grouped_kernel_to_torch(kernel: np.ndarray, groups: int) -> np.ndarray:
    """JAX's (*k, in / g, out) kernel as torch's (in, out / g, *k): torch's
    ``weight[g in/g + i, j]`` is JAX's ``[..., i, g out/g + j]``."""
    *k, cin_g, cout = kernel.shape
    w = kernel.reshape(*k, cin_g, groups, cout // groups)
    d = len(k)
    w = w.transpose(d + 1, d, d + 2, *range(d))          # (g, in/g, out/g, *k)
    return np.ascontiguousarray(w.reshape(groups * cin_g, cout // groups, *k))


@pytest.mark.parametrize("case", list(CONV_T))
def test_conv_transpose_grouped_matches_jax(case):
    """``ConvTransposeTorch`` with groups and per-axis kernel, stride,
    padding and output padding equals JAX's; its weight is JAX's kernel by
    the grouped layout rule."""
    shape, cout, k, s, p, op, g = CONV_T[case]
    d = len(shape) - 2
    jm = JL.ConvTransposeTorch(cout, k, s, p, feature_group_count=g, spatial_dims=d,
                               output_padding=op)
    x = x_of(shape)
    params = random_jax_params(jm, jnp.asarray(x), seed=3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = TL.ConvTransposeTorch(shape[-1], cout, k if d == 2 or not isinstance(k, int) else (k,) * 3,
                               s, p, op, groups=g)
    tm.load_state_dict({"weight": T(grouped_kernel_to_torch(np.asarray(params["kernel"]), g)),
                        "bias": T(np.asarray(params["bias"]))}, strict=True)
    with torch.no_grad():
        assert_close(tm(T(x)), ref)


@pytest.mark.parametrize("shape,amount", [((2, 3, 4, 5), 1), ((1, 2, 3, 4, 2), (0, 1, 2))])
def test_pad_top_left_matches_jax(shape, amount):
    """The leading side of each spatial axis padded by its amount, exactly."""
    x = x_of(shape)
    np.testing.assert_array_equal(TL.pad_top_left(T(x), amount).numpy(),
                                  np.asarray(JL.pad_top_left(jnp.asarray(x), amount)))


# (JAX block, port block, input shape, out channels, stride, grn)
BLOCKS = {
    "up_2d": (JMX.MedNeXtUpBlock, TMX.MedNeXtUpBlock, (2, 5, 6, 8), 6, 2, False),
    "up_3d_anisotropic_grn": (JMX.MedNeXtUpBlock, TMX.MedNeXtUpBlock, (1, 3, 4, 5, 8), 6,
                              (1, 2, 2), True),
    "down_3d_anisotropic_grn": (JMX.MedNeXtDownBlock, TMX.MedNeXtDownBlock, (1, 3, 8, 6, 8), 12,
                                (1, 2, 2), True),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_mednext_up_and_down_blocks_match_jax(case):
    """MedNeXt's up block (the depthwise transposed conv1, the top/left pad
    of every strided axis, the transposed 1x1 residual) and down block equal
    JAX's, isotropic and anisotropic, with GRN; the up block's output is
    exactly ``stride`` times its input."""
    jcls, tcls, shape, cout, s, grn = BLOCKS[case]
    d = len(shape) - 2
    jm = jcls(cout, exp_r=2, kernel_size=3, grn=grn, stride=s, spatial_dims=d)
    x = x_of(shape, seed=1)
    params = random_jax_params(jm, jnp.asarray(x), seed=4)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    up = tcls is TMX.MedNeXtUpBlock   # the scope names MedNeXtNet gives them
    tm = load_jax_params(tcls(shape[-1], cout, 2, 3, grn=grn, stride=s, spatial_dims=d), params,
                         "up_0/" if up else "down_0/")
    with torch.no_grad():
        got = tm(T(x))
    assert_close(got, ref)
    if up:
        assert got.shape[1:-1] == tuple(n * si for n, si in zip(shape[1:-1], TL._ntuple(s, d)))


def test_mamba_skip_over_five_scales_matches_jax():
    """``VSSConvLayer`` over five scales (MedNeXt's 32 to 512 channels at
    hidden 16) equals JAX's on each scale: JAX pads the 488-token sequence
    of the five scales to its scan's chunk and cuts it again, the port scans
    it unpadded, and the split back into scales agrees."""
    dims = [32, 64, 128, 256, 512]
    sizes = [(20, 18), (10, 9), (5, 5), (3, 3), (2, 2)]
    xs = [x_of((2, h, w, c), seed=10 + i) for i, ((h, w), c) in enumerate(zip(sizes, dims))]
    jm = JMS.VSSConvLayer(feature_dims=dims, hidden_dim=16, depth=1)
    params = random_jax_params(jm, [jnp.asarray(x) for x in xs], seed=5)
    refs = jax.jit(jm.apply)({"params": params}, [jnp.asarray(x) for x in xs])
    tm = load_jax_params(TMS.VSSConvLayer(dims, 16, depth=1), params)
    with torch.no_grad():
        got = tm([T(x) for x in xs])
    assert len(got) == len(refs) == 5
    for g, r in zip(got, refs):
        assert_close(g, np.asarray(r))


def test_mednext_mambaskip_gradients_match_jax():
    """MedNeXt S with its Mamba skip: every gradient against ``jax.grad``
    (the biases of convs a norm follows against their kernel's scale)."""
    nets = port_zoo.build_nets(["mednext_s_2d_mambaskip"])
    port_zoo.check_grads(nets["mednext_s_2d_mambaskip"], port_zoo.MEDNEXT_NORM_FED)
