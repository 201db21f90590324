"""Parity of the port's training slice with the JAX package, on the CPU.

Losses, deep supervision's loss and targets and the learning-rate
schedules against their JAX counterparts on numpy-seeded inputs. The train
step (the optimizer chain, DropPath, a tiny-flagship batch) is in
``test_torch_port_training_step.py``. Tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.training import losses as JLoss
from mlagg_unet_tpu.training import lr_schedule as JLR
from mlagg_unet_tpu.training.registry import get_trainer_config as j_trainer_config
from mlagg_unet_torch.training import losses as TLoss
from mlagg_unet_torch.training import lr_schedule as TLR
from mlagg_unet_torch.training.registry import get_trainer_config
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, one_torch_thread)

T = torch.from_numpy


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


