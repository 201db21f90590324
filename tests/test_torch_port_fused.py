"""Parity of the port's fused configuration with the JAX package, on the CPU.

The plain twins of K6 (fused local attention) and of K7 + K8 (fused instance
norm) against the JAX package's fused ops, whose Pallas kernels run in
interpret mode off the TPU; ``UnetResBlock`` and the tiny flagship with the
fused switches on against the JAX package with ``MLAGG_FUSED_IN=1`` (its
local attention kernel runs on a TPU only, so its CPU side is the unfused
branch, the same math); the switches' defaults and the ``MLAGG_FUSED_TAIL``
switch. Inputs and weights come from numpy seeds; tolerances are stated per
test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import unetr_blocks as JUB
from mlagg_unet_tpu.models.mlla_uper import MLLAUper as JaxMLLAUper
from mlagg_unet_tpu.ops.fused_norm import fused_instance_norm as j_fused_in
from mlagg_unet_tpu.ops.mlla_attn_fused import local_aggregated_attention_fused as j_local
from mlagg_unet_tpu.training import losses as JLoss
from mlagg_unet_tpu.training.registry import get_trainer_config as j_trainer_config
from mlagg_unet_torch.models import mlla as TMLLA
from mlagg_unet_torch.models import unetr_blocks as TUB
from mlagg_unet_torch.models.mlla_uper import MLLAUper, build_flagship
from mlagg_unet_torch.ops.fused_norm import fused_instance_norm, instance_norm_plain
from mlagg_unet_torch.ops.mlla_attn_fused import (
    local_aggregated_attention_fused,
    local_attention_fused_plain,
)
from mlagg_unet_torch.training.trainer import Trainer
from mlagg_unet_torch.weights import state_dict_to_jax_params
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, flat_params, load_jax_params, one_torch_thread, random_jax_params)

T = torch.from_numpy
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))
FUSED = dict(fused_local_attn=True, fused_instance_norm=True, fused_tail=True)
SWITCHES = ("MLAGG_FUSED_LOCAL_ATTN", "MLAGG_FUSED_IN", "MLAGG_FUSED_TAIL")


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


@pytest.mark.parametrize("cin,cout", [(3, 6), (6, 6)], ids=["has_proj", "identity_residual"])
def test_unet_res_block_fused_matches_jax(monkeypatch, cin, cout):
    """UnetResBlock with the fused norms (mode 2 with the projection, mode 1
    without) against the JAX block at MLAGG_FUSED_IN=1, loading its param
    tree strictly (the fused path keeps the GroupNorm_0 names): fp32,
    max|diff| <= 1e-4 * max|ref| + 1e-5."""
    monkeypatch.setenv("MLAGG_FUSED_IN", "1")
    x = jnp.asarray(np.random.RandomState(cin).randn(2, 10, 6, cin).astype(np.float32))
    jm = JUB.UnetResBlock(cout)
    params = random_jax_params(jm, x, seed=cin)
    ref = jax.jit(jm.apply)({"params": params}, x)
    tm = load_jax_params(TUB.UnetResBlock(cin, cout, fused_instance_norm=True), params)
    assert tm.fused and tm.has_proj == (cin != cout)
    with torch.no_grad():
        assert_close(tm(T(np.array(x))), ref)


@pytest.fixture(scope="module")
def tiny_params():
    return random_jax_params(JaxMLLAUper(out_channels=3, **TINY),
                             jnp.zeros((1, 64, 64, 1)), seed=5)


def test_tiny_flagship_fused_forward_matches_jax(monkeypatch, tiny_params):
    """The tiny flagship with all three switches on, eval mode, against the
    JAX flagship at MLAGG_FUSED_IN=1: all 5 outputs, fp32, max|diff| <=
    1e-4 * max|ref| + 1e-5."""
    monkeypatch.setenv("MLAGG_FUSED_IN", "1")
    jm = JaxMLLAUper(out_channels=3, **TINY)
    x = np.random.RandomState(11).randn(2, 64, 64, 1).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": tiny_params}, jnp.asarray(x))
    tm = load_jax_params(MLLAUper(1, 3, **TINY, **FUSED), tiny_params)
    with torch.no_grad():
        got = tm(T(x))
    assert len(got) == len(ref) == 5
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


def test_tiny_flagship_fused_train_batch_matches_jax(monkeypatch, tiny_params):
    """One batch through the trainer with fused_instance_norm=True (fp32,
    train mode, drop path off) against jax.value_and_grad of the JAX network
    at MLAGG_FUSED_IN=1 (the fused op's custom_vjp): loss within 1e-5
    relative, every gradient within 1e-3 * max|ref| + 1e-6."""
    monkeypatch.setenv("MLAGG_FUSED_IN", "1")
    jm = JaxMLLAUper(out_channels=3, **TINY)
    rs = np.random.RandomState(12)
    x = rs.randn(2, 64, 64, 1).astype(np.float32)
    y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
    scales = j_trainer_config("nnUNetTrainer_MLAgg_2D_dt_MS").deep_supervision_scales_override
    weights = JLoss.deep_supervision_weights(5)

    def loss_fn(p):
        outs = jm.apply({"params": p}, jnp.asarray(x), True)
        return JLoss.deep_supervision_loss(
            lambda o, t: JLoss.dc_and_ce_loss(o, t, batch_dice=False, do_bg=False),
            outs, JLoss.downsample_seg_for_ds(jnp.asarray(y), scales), weights)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(tiny_params)
    tr = Trainer(patch_size=(64, 64), batch_size=2, num_classes=3, device="cpu",
                 compute_dtype=torch.float32,
                 network_overrides=dict(TINY, drop_path_rate=0.0, skip_drop_path=0.0,
                                        fused_instance_norm=True))
    assert tr.network.encoder0.layer.fused and tr.network.decoder0.conv_block.fused
    load_jax_params(tr.network, tiny_params)
    loss = tr.forward_loss(T(x), T(y).long())
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    flat_ref = flat_params(ref_grads)
    got = state_dict_to_jax_params(
        {k: p.grad for k, p in tr.network.named_parameters()}, flat_ref.keys())
    for k, r in flat_ref.items():
        err = float(np.abs(got[k] - r).max())
        assert err <= 1e-3 * float(np.abs(r).max()) + 1e-6, (k, err)


# ---------------------------------------------------------------- switches


def _flags(model):
    blocks = [m for m in model.modules() if isinstance(m, TMLLA.MLLABlock)]
    res = [m for m in model.modules() if isinstance(m, TUB.UnetResBlock)]
    local = {b.attn_local.fused for b in blocks}
    tail = {b.fused_tail for b in blocks}
    norm = {r.fused for r in res}
    assert len(local) == len(tail) == len(norm) == 1, (local, tail, norm)
    assert not any(b.attn_pool.fused for b in blocks)
    return local.pop(), norm.pop(), tail.pop()


def test_switch_defaults_follow_the_jax_variables(monkeypatch):
    """None reads MLAGG_FUSED_LOCAL_ATTN == "1", MLAGG_FUSED_IN == "1" and
    MLAGG_FUSED_TAIL != "0" once, at construction; a bool overrides them;
    the trainer reaches them through network_overrides."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    model = MLLAUper(1, 3, **TINY)
    assert _flags(model) == (False, False, True)
    for name, value in zip(SWITCHES, ("1", "1", "0")):
        monkeypatch.setenv(name, value)
    assert _flags(MLLAUper(1, 3, **TINY)) == (True, True, False)
    assert _flags(model) == (False, False, True)      # read at construction only
    assert _flags(MLLAUper(1, 3, **TINY, fused_local_attn=False, fused_instance_norm=False,
                           fused_tail=True)) == (False, False, True)
    monkeypatch.setenv("MLAGG_FUSED_IN", "yes")          # only "1" switches it on
    monkeypatch.setenv("MLAGG_FUSED_TAIL", "false")      # only "0" switches it off
    assert _flags(MLLAUper(1, 3, **TINY))[1:] == (False, True)
    tr = Trainer(patch_size=(64, 64), batch_size=1, device="cpu",
                 network_overrides=dict(TINY, **FUSED))
    assert _flags(tr.network) == (True, True, True)


def test_fused_configs_share_one_param_tree():
    """The switches change no parameter name, shape or seeded value."""
    a = build_flagship(3, device="cpu", seed=4, **TINY)
    b = build_flagship(3, device="cpu", seed=4, **TINY, **FUSED)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_fused_tail_off_keeps_k2_k3_out_of_eval(monkeypatch):
    """MLAGG_FUSED_TAIL=0: an eval forward never calls the K2/K3 wrappers,
    and gives the fused forward's outputs (1e-5 relative on the CPU, where
    both are plain math); on by default, each of the 4 blocks calls each."""
    calls = []
    _spy(monkeypatch, TMLLA, "mlla_front", calls)
    _spy(monkeypatch, TMLLA, "mlla_tail", calls)
    x = T(np.random.RandomState(13).randn(1, 64, 64, 1).astype(np.float32))
    monkeypatch.setenv("MLAGG_FUSED_TAIL", "0")
    off = build_flagship(3, device="cpu", seed=2, **TINY)
    with torch.no_grad():
        a = off(x)
    assert calls == []
    monkeypatch.delenv("MLAGG_FUSED_TAIL")
    on = build_flagship(3, device="cpu", seed=2, **TINY)
    with torch.no_grad():
        b = on(x)
    assert calls.count("mlla_front") == calls.count("mlla_tail") == 4
    for g_, r_ in zip(a, b):
        assert_close(g_, r_, rel=1e-5, atol=1e-6)


def test_fused_local_attention_runs_in_eval_only(monkeypatch):
    """With fused_local_attn, each block's local half calls the K6 wrapper in
    eval mode and never in train mode; the pooled half never does."""
    calls = []
    _spy(monkeypatch, TMLLA, "local_aggregated_attention_fused", calls)
    model = build_flagship(3, device="cpu", seed=3, fused_local_attn=True, **TINY)
    x = T(np.random.RandomState(14).randn(2, 64, 64, 1).astype(np.float32))
    with torch.no_grad():
        model(x)
    assert len(calls) == 4
    model.train()
    model(x, torch.Generator().manual_seed(0))
    assert len(calls) == 4
