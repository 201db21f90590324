"""LKM-UNet's bidirectional Mamba layers in the PyTorch port against the
JAX package on the CPU: the pixel layer over p-strided sub-grids (2-D period
5p, 3-D periods (5p, 7p, 6p)) and its whole-map fallback where an extent
does not divide, the window layer (average pool by p, nearest unpool) and
its fallback, each with the gradient in its input; and the shared
bidirectional block in bf16, which answers in fp32 as flax's promotion does.

Weights come from numpy seeds into the JAX param tree (the scan's
parameters near their init, ``mamba_params``); inputs from numpy seeds.
Outputs are held within 1e-4 x max|ref| (+1e-5), input gradients within
2e-4 x max|ref| (+1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import lkm_unet as JLK
from mlagg_unet_torch.models import lkm_unet as TLK
from port_helpers import assert_close, load_jax_params, one_torch_thread  # noqa: F401
from test_torch_port_mamba import mamba_params

T = torch.from_numpy
DIM = 8

# (layer, input shape, p_raw): the sub-grid (or pooled) case and the
# fallback of each layer in 2-D and 3-D
LAYERS = {
    "pixel_2d_subgrids": ("pixel", (2, 10, 15, DIM), 1),
    "pixel_2d_fallback": ("pixel", (1, 12, 10, DIM), 1),
    "pixel_3d_subgrids": ("pixel", (1, 5, 14, 6, DIM), 1),
    "pixel_3d_fallback": ("pixel", (1, 4, 7, 6, DIM), 1),
    "window_2d_pooled": ("window", (2, 8, 6, DIM), 2),
    "window_2d_fallback": ("window", (1, 9, 8, DIM), 2),
    "window_3d_pooled": ("window", (1, 4, 6, 8, DIM), 2),
}
CLASSES = {"pixel": (JLK.BiPixelMambaLayer, TLK.BiPixelMambaLayer),
           "window": (JLK.BiWindowMambaLayer, TLK.BiWindowMambaLayer)}


def _pair(kind, shape, p_raw, seed=0):
    jcls, tcls = CLASSES[kind]
    jm = jcls(DIM, p_raw)
    x = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    params = mamba_params(jm, x, seed=seed + 1)
    return jm, load_jax_params(tcls(DIM, p_raw), params), params, x


@pytest.mark.parametrize("case", list(LAYERS))
def test_bi_mamba_layer_matches_jax(case):
    """The layer's output and its gradient in the input equal JAX's."""
    kind, shape, p_raw = LAYERS[case]
    jm, tm, params, x = _pair(kind, shape, p_raw)
    cot = np.random.RandomState(9).randn(*shape).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, x)
    gx = jax.jit(jax.grad(lambda xx: jnp.sum(jm.apply({"params": params}, xx) * cot)))(x)
    tx = T(np.array(x)).requires_grad_(True)
    out = tm(tx)
    (out * T(cot)).sum().backward()
    assert_close(out, np.asarray(ref))
    assert_close(tx.grad, np.asarray(gx), rel=2e-4, atol=1e-6)


def test_bi_mamba_in_bf16_answers_in_fp32_as_jax():
    """Parameters and input in bf16: the shared out_proj takes the Mamba
    blocks' fp32 output and answers in fp32, as flax's Dense promotes, and
    the port's output sits within twice the distance bf16 moves JAX's own
    layer of JAX's bf16 output."""
    jm, tm, params, x = _pair("pixel", (2, 10, 15, DIM), 1, seed=3)
    p16 = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params)
    apply = jax.jit(jm.apply)
    j16 = apply({"params": p16}, x.astype(jnp.bfloat16))
    assert str(j16.dtype) == "float32"
    j16, j32 = np.asarray(j16), np.asarray(apply({"params": params}, x))
    with torch.no_grad():
        t16 = tm.to(torch.bfloat16)(T(np.array(x)).to(torch.bfloat16))
    assert t16.dtype == torch.float32
    gap = np.linalg.norm(j16 - j32) / np.linalg.norm(j32)
    assert 0 < np.linalg.norm(t16.numpy() - j16) / np.linalg.norm(j16) <= 2 * gap
