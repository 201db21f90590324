"""The port's train step against the JAX package, on the CPU: the clip +
AdamW chain against optax, DropPath's own contract and the flagship's drop
path rates, one training batch of the tiny flagship (train mode, drop path
off) against the JAX network at ``deterministic=True``, which on the CPU
runs the same unfused block math with no dropout, and the ``Trainer``'s
steps and validation step. Tolerances are stated per test.
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
from mlagg_unet_torch.training import lr_schedule as TLR
from mlagg_unet_torch.training.optim import OptimizerChain
from mlagg_unet_torch.training.trainer import Trainer
from mlagg_unet_torch.weights import state_dict_to_jax_params
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    flat_params, load_jax_params, one_torch_thread, random_jax_params)
from test_torch_port_training import _close

T = torch.from_numpy
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))
NO_DROP = dict(drop_path_rate=0.0, skip_drop_path=0.0)


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JaxMLLAUper(out_channels=3, **TINY)
    params = random_jax_params(jm, jnp.zeros((1, 64, 64, 1)), seed=3)
    return jm, params


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
