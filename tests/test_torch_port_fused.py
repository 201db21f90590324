"""Parity of the port's fused configuration with the JAX package, on the CPU.

The plain twins of K6 (fused local attention) and of K7 + K8 (fused instance
norm, and its gradients) against the JAX package's fused ops, whose Pallas
kernels run in interpret mode off the TPU. The network level (the tiny
flagship, ``UnetResBlock``, the switches) is in
``test_torch_port_fused_flagship.py``. Inputs come from numpy seeds;
tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.ops.fused_norm import fused_instance_norm as j_fused_in
from mlagg_unet_tpu.ops.mlla_attn_fused import local_aggregated_attention_fused as j_local
from mlagg_unet_torch.ops.fused_norm import fused_instance_norm, instance_norm_plain
from mlagg_unet_torch.ops.mlla_attn_fused import (
    local_aggregated_attention_fused,
    local_attention_fused_plain,
)
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

T = torch.from_numpy


def _max_rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------- K6


@pytest.mark.parametrize("ch,nh", [(48, 1), (96, 2)])
def test_local_attention_plain_matches_jax_kernel(ch, nh):
    """K6's plain twin against the JAX kernel (interpret mode) on an odd
    7 x 9 map, fp32: max|diff| <= 1e-5 * max|ref|."""
    rs = np.random.RandomState(ch)
    B, H, W = 2, 7, 9
    hd = ch // nh // 2
    x = (rs.randn(B, H, W, ch) * 0.5).astype(np.float32)
    wq = (rs.randn(ch, ch) / np.sqrt(ch)).astype(np.float32)      # JAX (in, out)
    wkv = (rs.randn(ch, 2 * ch) / np.sqrt(ch)).astype(np.float32)
    bq, bkv = (0.1 * rs.randn(n).astype(np.float32) for n in (ch, 2 * ch))
    sub = (1 + 0.2 * rs.randn(2 * hd)).astype(np.float32)
    lepe_k = (rs.randn(3, 3, 1, ch) / 3).astype(np.float32)
    lepe_b = (0.1 * rs.randn(ch)).astype(np.float32)
    lam = np.float32(0.37)
    ref = j_local(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bq), jnp.asarray(wkv),
                  jnp.asarray(bkv), jnp.asarray(sub), jnp.asarray(lepe_k),
                  jnp.asarray(lepe_b), jnp.asarray(lam), nh)
    args = (T(x), T(wq.T.copy()), T(bq), T(wkv.T.copy()), T(bkv), T(sub),
            T(lepe_k.transpose(3, 2, 0, 1).copy()), T(lepe_b), torch.tensor(lam), nh)
    got = local_attention_fused_plain(*args)
    assert _max_rel(got, ref) <= 1e-5
    # the wrapper takes the twin on a CPU tensor
    assert torch.equal(local_aggregated_attention_fused(*args), got)


# ---------------------------------------------------------------- K7 + K8


def _norm_inputs(seed, mode, shape=(2, 9, 7, 8)):
    rs = np.random.RandomState(seed)
    C = shape[-1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    vecs = [(1 + 0.2 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32)]
    kw = {}
    if mode:
        kw["residual"] = (rs.randn(*shape) - 0.3).astype(np.float32)
    if mode == 2:
        kw["res_scale"] = (1 + 0.2 * rs.randn(C)).astype(np.float32)
        kw["res_bias"] = (0.1 * rs.randn(C)).astype(np.float32)
    return x, vecs, kw


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fused_instance_norm_matches_jax(mode, act):
    """fp32, modes 0 (none), 1 (raw residual) and 2 (normed residual), with
    and without LeakyReLU: max|diff| <= 1e-5 * max|ref|."""
    x, (s, b), kw = _norm_inputs(10 + mode, mode)
    ref = j_fused_in(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), act=act,
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    got = fused_instance_norm(T(x), T(s), T(b), act=act, **{k: T(v) for k, v in kw.items()})
    assert got.dtype == torch.float32
    assert _max_rel(got, ref) <= 1e-5


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fused_instance_norm_grads_match_jax(mode):
    """Gradients for x, scale, bias and (where given) the residual and its
    scale and bias against jax.grad of the JAX op (its custom_vjp), act on:
    max|diff| <= 1e-4 * max|ref| each."""
    x, (s, b), kw = _norm_inputs(20 + mode, mode)
    g = np.random.RandomState(30 + mode).randn(*x.shape).astype(np.float32)
    names = ["x", "scale", "bias", *kw]
    vals = [x, s, b, *kw.values()]

    def j_loss(*a):
        out = j_fused_in(a[0], a[1], a[2], act=True, **dict(zip(kw, a[3:])))
        return jnp.sum(out * g)

    ref = jax.grad(j_loss, argnums=tuple(range(len(vals))))(*map(jnp.asarray, vals))
    leaves = [T(v.copy()).requires_grad_() for v in vals]
    out = fused_instance_norm(leaves[0], leaves[1], leaves[2], act=True,
                              **dict(zip(kw, leaves[3:])))
    assert type(out.grad_fn).__name__ == "_FusedInstanceNormBackward"
    (out * T(g)).sum().backward()
    for name, leaf, r in zip(names, leaves, ref):
        assert _max_rel(leaf.grad, r) <= 1e-4, name


def test_instance_norm_plain_keeps_the_unclamped_variance():
    """A constant channel: E[x^2] - E[x]^2 is a rounding residue that the
    fused form keeps (layers.InstanceNorm clamps it at 0), so the twin
    follows the JAX kernel, not the unfused layer."""
    x = torch.full((1, 4, 4, 2), 3.0) + torch.tensor([0.0, 1e-3])
    s, b = torch.ones(2), torch.zeros(2)
    y = instance_norm_plain(x, s, b)
    xf = x.float()
    mean = xf.mean((1, 2), keepdim=True)
    var = (xf * xf).mean((1, 2), keepdim=True) - mean * mean
    torch.testing.assert_close(y, (xf - mean) * torch.rsqrt(var + 1e-5), rtol=0, atol=0)


# ---------------------------------------------------------------- blocks


# ---------------------------------------------------------------- switches


