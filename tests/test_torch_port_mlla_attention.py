"""MLLA's full-attention block (``models/mlla.py::Attention``, the
``sr_ratio == 1`` branch of ``MLLABlock``) in the port against JAX (fp32,
max|diff| <= 1e-4 * max|ref| + 1e-5): the module, the block in eval (fused
tail twin) and training form, its input gradient, an ``MLLAEncoder`` whose
last stage runs at ``sr_ratio`` 1, and the state dict's round trip through
``jax_params_to_state_dict``. Weights come from a numpy seed into JAX's
param tree; no registry network reaches this block in either package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import mlla as JMLLA
from mlagg_unet_torch.models import mlla as TMLLA
from mlagg_unet_torch.weights import jax_params_to_state_dict, state_dict_to_jax_tree
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, flat_params, load_jax_params, one_torch_thread, random_jax_params)


def _maps(seed, shape, c, batch=2):
    rs = np.random.RandomState(seed)
    return jnp.asarray(rs.randn(batch, *shape, c).astype(np.float32))


def _pair(jmod, tmod, x, seed=0):
    params = random_jax_params(jmod, x, seed=seed)
    return params, load_jax_params(tmod, params)


@pytest.mark.parametrize("dim,heads,shape", [(32, 2, (6, 5)), (48, 4, (8, 7)), (64, 2, (3, 9))])
def test_attention_matches_jax(dim, heads, shape):
    """q pre-scaled by head_dim ** -0.5, the attention at scale 1.0, LePE
    on v: head dims 16, 12 and 32."""
    x = _maps(dim, shape, dim)
    params, tm = _pair(JMLLA.Attention(heads), TMLLA.Attention(dim, heads), x)
    ref = jax.jit(JMLLA.Attention(heads).apply)({"params": params}, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(x)))
    assert_close(got, ref)
    assert set(flat_params(params)) == {"qkv/kernel", "qkv/bias", "lepe/Conv_0/kernel",
                                        "lepe/Conv_0/bias"}


@pytest.mark.parametrize("training", [False, True])
def test_block_at_sr_ratio_1_matches_jax(training):
    """Eval (the fused front and tail's twins) and training (unfused; drop
    path 0, so deterministic) forms of ``MLLABlock(sr_ratio=1)``."""
    x = _maps(3, (8, 7), 32)
    jmod = JMLLA.MLLABlock(num_heads=4, mlp_ratio=2.0, sr_ratio=1)
    params, tm = _pair(jmod, TMLLA.MLLABlock(32, 4, 2.0, sr_ratio=1), x)
    ref = jax.jit(lambda p, v: jmod.apply({"params": p}, v, deterministic=not training))(params, x)
    tm.train(training)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(x)))
    assert_close(got, ref)
    assert not hasattr(tm, "attn_local") and not hasattr(tm, "attn_pool")


def test_block_at_sr_ratio_1_runs_one_flash_attention(monkeypatch):
    """The block's attention goes through ``ops.flash_attention`` (K4 on the
    card, its twin here), once per call, at scale 1.0."""
    calls = []
    real = TMLLA.flash_attention

    def recording(q, k, v, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), scale))
        return real(q, k, v, scale)

    monkeypatch.setattr(TMLLA, "flash_attention", recording)
    x = _maps(4, (8, 7), 32)
    _, tm = _pair(JMLLA.MLLABlock(num_heads=4, mlp_ratio=2.0, sr_ratio=1),
                  TMLLA.MLLABlock(32, 4, 2.0, sr_ratio=1), x)
    with torch.no_grad():
        tm(torch.from_numpy(np.array(x)))
    assert calls == [((2, 4, 56, 8), (2, 4, 56, 8), 1.0)]


def test_attention_input_gradient_matches_jax():
    """d(sum(out * w)) / dx of ``Attention`` against ``jax.grad``."""
    x = _maps(5, (5, 6), 32)
    jmod = JMLLA.Attention(2)
    params, tm = _pair(jmod, TMLLA.Attention(32, 2), x)
    w = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(jmod.apply({"params": params}, v) * w))(x)
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    (tm(xt) * torch.from_numpy(w)).sum().backward()
    assert_close(xt.grad, ref)


def test_encoder_whose_last_stage_runs_full_attention():
    """A tiny ``MLLAEncoder`` with sr_ratio (8, 4, 2, 1): all five outputs."""
    cfg = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
               mlp_ratio=2, sr_ratio=(8, 4, 2, 1))
    x = _maps(7, (64, 48), 1)
    jmod = JMLLA.MLLAEncoder(**cfg)
    params, tm = _pair(jmod, TMLLA.MLLAEncoder(1, **cfg, drop_path_rate=0.0), x)
    ref = jax.jit(jmod.apply)({"params": params}, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(x)))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert_close(g, r)
    assert hasattr(tm.layer3.block0, "attn") and hasattr(tm.layer2.block0, "attn_pool")


def test_state_dict_round_trip():
    """JAX tree -> state dict -> JAX tree is the identity for the block at
    sr_ratio 1, and the port's keys are JAX's scopes."""
    x = _maps(8, (4, 4), 32)
    params = random_jax_params(JMLLA.MLLABlock(num_heads=4, mlp_ratio=2.0, sr_ratio=1), x)
    flat = flat_params(params)
    sd = jax_params_to_state_dict(flat)
    assert {"attn.qkv.weight", "attn.qkv.bias", "attn.lepe.Conv_0.weight"} <= set(sd)
    tm = TMLLA.MLLABlock(32, 4, 2.0, sr_ratio=1)
    tm.load_state_dict(sd, strict=True)
    back = flat_params(state_dict_to_jax_tree(tm.state_dict()))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)
