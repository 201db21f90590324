"""The Mamba zoo's ops and blocks in the PyTorch port against the JAX package
on the CPU: the one-scale cross-scan layouts, ``MambaBlock`` (forward and
every gradient, causality, its param tree) and the SS2D forward-type parser;
the plain scan in fp64. ``SS2D`` is in ``test_torch_port_ss2d.py``, both
blocks in bf16 in ``test_torch_port_mamba_bf16.py``.

Inputs and weights come from numpy seeds (weights into the JAX param tree,
then ``jax_params_to_state_dict`` -> ``load_state_dict(strict=True)``); the
JAX side takes its XLA scan, the port its plain twins. Layouts are held
exactly, forwards within 1e-4 x max|ref| (+1e-5), gradients within 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import mamba_block as JMB
from mlagg_unet_tpu.ops import cross_scan as JCS
from mlagg_unet_torch.models import mamba_block as TMB
from mlagg_unet_torch.ops import cross_scan as TCS
from mlagg_unet_torch.weights import jax_params_to_state_dict, state_dict_to_jax_params
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, flat_params, one_torch_thread, random_jax_params)

T = torch.from_numpy
TOL_GRAD = 2e-4


def mamba_params(module, *inputs, seed: int = 0):
    """``random_jax_params`` with MambaBlock's scan parameters near their
    init: A_log (A_b_log...) near log(1..n), D near 1, the dt bias the
    softplus-inverse of dt in [1e-3, 0.1], the dt weight U(-1, 1) / sqrt(r);
    and the variants' ``skip_scale`` near its init of 1."""
    params = random_jax_params(module, *inputs, seed=seed)
    rs = np.random.RandomState(seed + 1000)

    def redraw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name.startswith("A") and name.endswith("_log"):
            v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * rs.randn(*shape)
        elif name in ("D", "D_b", "D_s", "skip_scale"):
            v = 1 + 0.1 * rs.randn(*shape)
        elif name.startswith("dt_proj") and name.endswith("_bias"):
            dt = np.exp(rs.uniform(np.log(1e-3), np.log(0.1), shape))
            v = dt + np.log(-np.expm1(-dt))
        elif name.startswith("dt_proj") and name.endswith("_weight"):
            v = rs.uniform(-1, 1, shape) / np.sqrt(shape[-1])
        else:
            return leaf
        return jnp.asarray(np.asarray(v, np.float32))

    return jax.tree_util.tree_map_with_path(redraw, params)


def load(module, params):
    module.load_state_dict(jax_params_to_state_dict(flat_params(params)), strict=True)
    return module.eval()


def grads_pair(jmod, tmod, params, x, seed=7):
    """Output and the gradients of sum(out * cotangent) in the input and
    every parameter, JAX (``jax.grad``) and port (autograd)."""
    rs = np.random.RandomState(seed)
    ref = jmod.apply({"params": params}, x)
    cot = rs.randn(*ref.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * cot),
                      argnums=(0, 1))(params, x)
    tx = T(np.array(x)).requires_grad_(True)
    out = tmod(tx)
    (out * T(cot)).sum().backward()
    flat = flat_params(gp)
    got = state_dict_to_jax_params({k: p.grad for k, p in tmod.named_parameters()}, flat)
    return (out, ref), (tx.grad, gx), got, flat


def check_grads(pair, gx_pair, got, ref):
    assert_close(*pair)
    assert_close(gx_pair[0], np.asarray(gx_pair[1]), rel=TOL_GRAD, atol=1e-6)
    for k in ref:
        assert_close(got[k], ref[k], rel=TOL_GRAD, atol=1e-6)


# ---------------------------------------------------------------- cross scan

SCANS = {"4dir": ("cross_scan_2d", "cross_merge_2d"),
         "1dir": ("cross_scan_1direction", "cross_merge_1direction"),
         "2dir": ("cross_scan_2direction", "cross_merge_2direction")}


@pytest.mark.parametrize("kind", list(SCANS))
def test_cross_scan_and_merge_match_jax(kind):
    """Each one-scale scan layout equals JAX's exactly, on a non-square map;
    each merge of a (B, 4, C, L) stack within 1e-6."""
    scan, merge = SCANS[kind]
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5, 7, 3).astype(np.float32)
    got = getattr(TCS, scan)(T(x))
    ref = np.asarray(getattr(JCS, scan)(jnp.asarray(x)))
    assert got.shape == ref.shape == (2, 4, 3, 35)
    np.testing.assert_array_equal(got.numpy(), ref)
    ys = rs.randn(2, 4, 3, 35).astype(np.float32)
    assert_close(getattr(TCS, merge)(T(ys), 5, 7),
                 getattr(JCS, merge)(jnp.asarray(ys), 5, 7), rel=1e-6, atol=1e-6)


def test_merge_inverts_the_four_directions():
    """Merging the scan of a map gives four times the map (channels-first):
    each direction's layout is undone."""
    x = torch.randn(1, 4, 6, 2, generator=torch.Generator().manual_seed(0))
    merged = TCS.cross_merge_2d(TCS.cross_scan_2d(x), 4, 6)
    torch.testing.assert_close(merged, 4 * x.permute(0, 3, 1, 2).reshape(1, 2, 24))


# ---------------------------------------------------------------- MambaBlock

MAMBA = {"plain": dict(), "bimamba_v3": dict(bimamba_type="v3", nslices=4),
         "no_out_proj": dict(project_out=False)}


@pytest.mark.parametrize("case", list(MAMBA))
def test_mamba_block_forward_and_grads_match_jax(case):
    """MambaBlock (d_model 8, L 20): the output, and the gradients of the
    input and of every parameter against ``jax.grad``."""
    kw = MAMBA[case]
    x = jnp.asarray(np.random.RandomState(1).randn(2, 20, 8).astype(np.float32))
    jmod = JMB.MambaBlock(d_model=8, **kw)
    params = mamba_params(jmod, x)
    tmod = load(TMB.MambaBlock(8, **kw), params)
    pair, gx, got, ref = grads_pair(jmod, tmod, params, x)
    assert pair[0].shape == ((2, 20, 8) if kw.get("project_out", True) else (2, 20, 16))
    check_grads(pair, gx, got, ref)
    assert len(ref) == len(list(tmod.parameters()))


def test_mamba_block_is_causal():
    """Changing the tokens from step 11 on leaves the outputs of steps 0-10
    exactly as they were."""
    x = np.random.RandomState(2).randn(1, 24, 8).astype(np.float32)
    jmod = JMB.MambaBlock(d_model=8)
    tmod = load(TMB.MambaBlock(8), mamba_params(jmod, jnp.asarray(x)))
    y = x.copy()
    y[:, 11:] += np.random.RandomState(3).randn(1, 13, 8).astype(np.float32)
    with torch.no_grad():
        a, b = tmod(T(x)), tmod(T(y))
    assert torch.equal(a[:, :11], b[:, :11])
    assert not torch.equal(a[:, 11:], b[:, 11:])


def test_mamba_block_tree_round_trip_and_raises():
    """The block's JAX tree -> state_dict -> JAX tree exactly (conv1d's
    (k, 1, d) kernel as torch's (d, 1, k)); an unknown bimamba type and
    nslices not dividing L raise."""
    x = jnp.zeros((1, 12, 8))
    flat = flat_params(mamba_params(JMB.MambaBlock(d_model=8, bimamba_type="v3",
                                                   nslices=3), x))
    sd = jax_params_to_state_dict(flat)
    assert tuple(sd["conv1d_b.weight"].shape) == (16, 1, 4)
    assert tuple(sd["A_s_log"].shape) == (1, 16, 16)
    back = state_dict_to_jax_params(sd, flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(NotImplementedError):
        TMB.MambaBlock(8, bimamba_type="v2")
    m = load(TMB.MambaBlock(8, bimamba_type="v3", nslices=5),
             mamba_params(JMB.MambaBlock(d_model=8, bimamba_type="v3", nslices=5),
                          jnp.zeros((1, 10, 8))))
    with pytest.raises(ValueError, match="nslices"):
        m(torch.zeros(1, 12, 8))


# ---------------------------------------------------------------- SS2D


def test_forward_type_parse():
    """Tags stripped in any order; the scan's dtype and directions as JAX
    decides them."""
    cases = {"v0": (True, 4), "v05_noz_onsoftmax": (False, 4), "v2_no32": (False, 4),
             "v31d": (False, 1), "v052d_nozact": (False, 2), "v3": (False, 4)}
    for ft, (fp32, dirs) in cases.items():
        flags, force, d = TMB.parse_forward_type(ft)
        jflags, jforce, jd = JMB.SS2D(d_model=4, forward_type=ft)._parse_forward_type()
        assert (flags, force, d) == (jflags, jforce, jd) and (force, d) == (fp32, dirs), ft


# ---------------------------------------------------------------- bf16


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_scan_in_fp64(reverse):
    """fp64 operands make the plain scan compute in fp64: y and every
    gradient of ``selective_scan_bwd_plain`` against autograd through the
    step-by-step scan in fp64 within 1e-10 (fp32 arithmetic would leave
    ~1e-7); fp32 operands still give fp32."""
    from mlagg_unet_torch.ops.selective_scan import (
        selective_scan, selective_scan_bwd_plain, selective_scan_seq_ref)

    rs = np.random.RandomState(9)
    b, g, d, n, L = 2, 2, 3, 16, 300
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    ops = [f64(rs.randn(b, g, d, L)), f64(0.5 * rs.randn(b, g, d, L)),
           f64(-np.tile(np.arange(1, n + 1), (g, d, 1))), f64(rs.randn(b, g, n, L)),
           f64(rs.randn(b, g, n, L)), f64(1 + 0.1 * rs.randn(g, d)), f64(rs.randn(g, d) - 3)]
    gy = f64(rs.randn(b, g, d, L))
    y = selective_scan(*ops, delta_softplus=True, chunk_size=64, reverse=reverse)
    assert y.dtype == torch.float64
    leaves = [t.clone().requires_grad_(True) for t in ops]
    ref = selective_scan_seq_ref(*leaves, delta_softplus=True, reverse=reverse)
    (ref * gy).sum().backward()
    assert_close(y, ref.detach().numpy(), rel=1e-10, atol=0)
    got = selective_scan_bwd_plain(*ops, True, reverse, gy, chunk_size=64)
    for gt, leaf in zip(got, leaves):
        assert gt.dtype == torch.float64
        assert_close(gt, leaf.grad.numpy(), rel=1e-10, atol=0)
    y32 = selective_scan(*(t.float() for t in ops), delta_softplus=True, reverse=reverse)
    assert y32.dtype == torch.float32
    assert_close(y32, ref.detach().numpy(), rel=1e-5, atol=0)
