"""Parity of the port's training slice with the JAX package, on the CPU.

Losses, learning-rate schedules and the clip + AdamW chain against their
JAX / optax counterparts on numpy-seeded inputs; DropPath's own contract;
and one training batch of the tiny flagship (train mode, drop path off)
against the JAX network at ``deterministic=True``, which on the CPU runs
the same unfused block math with no dropout. Tolerances are stated per
test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlagg_unet_tpu.models.mlla_uper import MLLAUper as JaxMLLAUper
from mlagg_unet_tpu.training import losses as JLoss
from mlagg_unet_tpu.training import lr_schedule as JLR
from mlagg_unet_tpu.training.registry import get_trainer_config as j_trainer_config
from mlagg_unet_torch.models.layers import DropPath
from mlagg_unet_torch.training import losses as TLoss
from mlagg_unet_torch.training import lr_schedule as TLR
from mlagg_unet_torch.training.optim import OptimizerChain
from mlagg_unet_torch.training.registry import get_trainer_config
from mlagg_unet_torch.training.trainer import Trainer
from mlagg_unet_torch.weights import state_dict_to_jax_params
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, flat_params, load_jax_params, one_torch_thread, random_jax_params)

T = torch.from_numpy
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))
NO_DROP = dict(drop_path_rate=0.0, skip_drop_path=0.0)


def _logits_and_target(seed, b=2, hw=(12, 10), c=4, ignore=None):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(b, *hw, c) * 2).astype(np.float32)
    target = rs.randint(0, c, size=(b, *hw)).astype(np.int32)
    if ignore is not None:
        target[rs.rand(b, *hw) < 0.2] = ignore
    return logits, target


def _close(got, ref, rel=1e-6):
    assert_close(got, np.asarray(ref), rel=rel, atol=rel)


LOSS_CASES = {
    "dice_default": lambda L, x, t, m: L.memory_efficient_soft_dice_loss(x, t),
    "dice_batch_nobg": lambda L, x, t, m: L.memory_efficient_soft_dice_loss(
        x, t, batch_dice=True, do_bg=False, smooth=1e-5),
    "dice_mask": lambda L, x, t, m: L.memory_efficient_soft_dice_loss(
        x, t, do_bg=False, loss_mask=m),
    "ce": lambda L, x, t, m: L.robust_cross_entropy_loss(x, t),
    "dc_ce": lambda L, x, t, m: L.dc_and_ce_loss(x, t),
    "dc_ce_batch_dice": lambda L, x, t, m: L.dc_and_ce_loss(x, t, batch_dice=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    """Each loss at 1e-6 (relative to the loss, plus 1e-6)."""
    x, t = _logits_and_target(0)
    m = (np.random.RandomState(1).rand(*t.shape) > 0.3).astype(np.float32)
    fn = LOSS_CASES[case]
    ref = fn(JLoss, jnp.asarray(x), jnp.asarray(t), jnp.asarray(m))
    _close(fn(TLoss, T(x), T(t).long(), T(m)), ref)


def test_losses_with_ignore_label():
    x, t = _logits_and_target(2, ignore=4)
    _close(TLoss.robust_cross_entropy_loss(T(x), T(t).long(), ignore_index=4),
           JLoss.robust_cross_entropy_loss(jnp.asarray(x), jnp.asarray(t), ignore_index=4))
    _close(TLoss.dc_and_ce_loss(T(x), T(t).long(), ignore_label=4),
           JLoss.dc_and_ce_loss(jnp.asarray(x), jnp.asarray(t), ignore_label=4))


def test_dice_terms_and_tp_fp_fn_tn():
    x, t = _logits_and_target(3)
    probs = jax.nn.softmax(jnp.asarray(x), -1)
    onehot = jax.nn.one_hot(jnp.asarray(t), 4)
    m = (np.random.RandomState(4).rand(*t.shape) > 0.5).astype(np.float32)
    for got, ref in zip(TLoss.soft_dice_terms(T(np.array(probs)), T(np.array(onehot)), T(m)),
                        JLoss.soft_dice_terms(probs, onehot, jnp.asarray(m))):
        _close(got, ref)
    hard = jax.nn.one_hot(jnp.argmax(probs, -1), 4)
    for reduce in (True, False):
        for got, ref in zip(
                TLoss.get_tp_fp_fn_tn(T(np.array(hard)), T(np.array(onehot)), T(m), reduce),
                JLoss.get_tp_fp_fn_tn(hard, onehot, jnp.asarray(m), reduce)):
            _close(got, ref)


def test_deep_supervision_loss_and_targets():
    """The flagship's five scales: strided targets, weights not zeroed at
    the lowest scale, the weighted DC+CE sum."""
    scales = get_trainer_config("nnUNetTrainer_MLAgg_2D_dt_MS").deep_supervision_scales_override
    assert scales == j_trainer_config("nnUNetTrainer_MLAgg_2D_dt_MS").deep_supervision_scales_override
    rs = np.random.RandomState(5)
    t = rs.randint(0, 3, size=(2, 32, 48)).astype(np.int32)
    outs = [rs.randn(2, 32 // 2 ** i, 48 // 2 ** i, 3).astype(np.float32) for i in range(5)]
    jt = JLoss.downsample_seg_for_ds(jnp.asarray(t), scales)
    tt = TLoss.downsample_seg_for_ds(T(t).long(), scales)
    for g_, r_ in zip(tt, jt):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
    w = TLoss.deep_supervision_weights(5)
    np.testing.assert_allclose(w, JLoss.deep_supervision_weights(5), rtol=1e-12)
    assert w[-1] > 0
    np.testing.assert_allclose(TLoss.deep_supervision_weights(5, 1),
                               JLoss.deep_supervision_weights(5, 1), rtol=1e-12)
    ref = JLoss.deep_supervision_loss(JLoss.dc_and_ce_loss, [jnp.asarray(o) for o in outs], jt, w)
    _close(TLoss.deep_supervision_loss(TLoss.dc_and_ce_loss, [T(o) for o in outs], tt, w), ref)


@pytest.mark.parametrize("kind", ["poly", "cosine", "cosine_no_warmup"])
def test_lr_schedules_match_jax(kind):
    """Every epoch of a 500-epoch run, stepped per iteration: max|diff| <=
    1e-7 * the peak lr plus one fp32 ulp of it. Both compute the cosine in
    fp32; XLA's and torch's fp32 cos differ in the last bit at a few epochs,
    which moves those lrs by one ulp."""
    make = {"poly": lambda L: L.poly_lr(1e-2, 500),
            "cosine": lambda L: L.cosine_warmup_lr(5e-4, 500, warmup_epochs=10),
            "cosine_no_warmup": lambda L: L.cosine_warmup_lr(5e-4, 500, warmup_epochs=0)}[kind]
    peak = 1e-2 if kind == "poly" else 5e-4
    j = JLR.epoch_schedule_to_step_schedule(make(JLR), 3)
    t = TLR.epoch_schedule_to_step_schedule(make(TLR), 3)
    err = max(abs(float(j(s)) - t(s)) for s in range(0, 1500, 2))
    assert err <= 1e-7 * peak + float(np.spacing(np.float32(peak))), err


def test_clip_adamw_matches_optax():
    """Three steps of clip_by_global_norm(12) -> AdamW on fixed gradients,
    two of them above the clip norm, the lr on a warmup schedule, against
    the optax chain of the JAX trainer: 1e-6 relative to each parameter."""
    rs = np.random.RandomState(6)
    params = {"w": rs.randn(7, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (10.0, 0.5, 30.0)]
    sched_j = JLR.epoch_schedule_to_step_schedule(JLR.cosine_warmup_lr(5e-4, 500), 1)
    sched_t = TLR.epoch_schedule_to_step_schedule(TLR.cosine_warmup_lr(5e-4, 500), 1)
    opt = optax.chain(optax.clip_by_global_norm(12.0),
                      optax.adamw(sched_j, eps=1e-4, weight_decay=3e-5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in params.items()}
    chain = OptimizerChain(tp.values(), "adamw", sched_t, 12.0, 1e-4, 3e-5)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        chain.zero_grad()
        for k, p in tp.items():
            p.grad = T(g[k].copy())
        chain.step()
    for k in params:
        _close(tp[k].detach(), jp[k])


def test_drop_path_contract():
    """Reproducible from its seed; each sample kept whole and scaled by
    1 / keep, or zeroed; the identity in eval mode and at rate 0; training
    above rate 0 without a generator raises."""
    x = torch.randn(400, 3, 5, 2, generator=torch.Generator().manual_seed(0)) + 3.0
    dp = DropPath(0.25).train()
    a = dp(x, torch.Generator().manual_seed(7))
    b = dp(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = (a != 0).flatten(1).all(1)
    dropped = (a == 0).flatten(1).all(1)
    assert torch.all(kept | dropped)
    torch.testing.assert_close(a[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.65 < kept.float().mean().item() < 0.85
    assert not torch.equal(a, dp(x, torch.Generator().manual_seed(8)))
    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x
    with pytest.raises(ValueError, match="Generator"):
        dp.train()(x)


def test_flagship_drop_path_rates():
    """Encoder blocks at linspace(0, 0.1, 8) (mlla.py:482), the skip at 0.1."""
    tr = Trainer(patch_size=(64, 64), batch_size=1, device="cpu")
    rates = [m.drop_path.rate for name, m in tr.network.mlla.named_modules()
             if name.endswith(("block0", "block1")) and hasattr(m, "drop_path")]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 8), rtol=1e-12)
    assert tr.network.mambaskip.block0.drop_path.rate == 0.1
    assert tr.network.training


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JaxMLLAUper(out_channels=3, **TINY)
    params = random_jax_params(jm, jnp.zeros((1, 64, 64, 1)), seed=3)
    return jm, params


def test_tiny_flagship_train_batch_matches_jax(tiny_pair):
    """One batch through the port's trainer (fp32, train mode, drop path
    off) against jax.value_and_grad of the JAX network at deterministic=True
    with the flagship's DS DC+CE loss: loss within 1e-5 relative, every
    parameter gradient within 1e-3 * max|ref| + 1e-6."""
    jm, params = tiny_pair
    rs = np.random.RandomState(8)
    x = rs.randn(2, 64, 64, 1).astype(np.float32)
    y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
    cfg = j_trainer_config("nnUNetTrainer_MLAgg_2D_dt_MS")
    scales = cfg.deep_supervision_scales_override
    weights = JLoss.deep_supervision_weights(5)

    def loss_fn(p):
        outs = jm.apply({"params": p}, jnp.asarray(x), True)
        return JLoss.deep_supervision_loss(
            lambda o, t: JLoss.dc_and_ce_loss(o, t, batch_dice=False, do_bg=False),
            outs, JLoss.downsample_seg_for_ds(jnp.asarray(y), scales), weights)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tr = Trainer(patch_size=(64, 64), batch_size=2, num_classes=3, device="cpu",
                 compute_dtype=torch.float32, network_overrides=dict(TINY, **NO_DROP))
    load_jax_params(tr.network, params)
    loss = tr.forward_loss(T(x), T(y).long())
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    flat_ref = flat_params(ref_grads)
    got = state_dict_to_jax_params(
        {k: p.grad for k, p in tr.network.named_parameters()}, flat_ref.keys())
    assert len(got) == len(dict(tr.network.named_parameters()))
    for k, r in flat_ref.items():
        err = float(np.abs(got[k] - r).max())
        assert err <= 1e-3 * float(np.abs(r).max()) + 1e-6, (k, err)


def test_trainer_steps_and_validation():
    """bf16 steps on the tiny flagship: finite losses that fall on a fixed
    batch, the optimizer's count and lr follow the schedule, the validation
    step gives per-class counts, and a non-finite loss raises."""
    tr = Trainer(patch_size=(64, 64), batch_size=2, num_classes=3, device="cpu",
                 seed=2, network_overrides=TINY)
    x = T(np.random.RandomState(9).randn(2, 64, 64, 1).astype(np.float32))
    y = (x[..., 0] > 0.3).long() + (x[..., 0] > 1.2).long()
    losses = tr.run_steps([(x, y)] * 4)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert tr.optimizer.count == 4
    assert tr.optimizer.opt.param_groups[0]["lr"] == tr.optimizer.schedule(3)
    loss, tp, fp, fn = tr.val_step(x, y)
    assert torch.isfinite(loss) and tp.shape == fp.shape == fn.shape == (2,)
    assert (tp + fn).sum().item() == (y > 0).sum().item()
    assert tr.network.training
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.run_steps([(torch.full_like(x, float("nan")), y)])
    with pytest.raises(ValueError, match="batch"):
        tr.train_step(x[:1], y[:1])
