"""The port's plans U-Net and the default recipe's parts against the JAX
package, on the CPU.

``PlainConvUNet`` in 2-D and 3-D, with instance and batch norm, deep
supervision on and off (fp32 outputs within 1e-4 relative); one train-mode
BatchNorm forward's running statistics against flax's mutable
``batch_stats`` (1e-5); ``BasicBlockD`` and ``StackedResidualBlocks``; the
rank-5 and ``decoder_transp`` weights both ways; three steps of each
optimizer chain against optax on the same gradients (1e-6 relative); the
constant schedule; each recipe loss with and without an ignore label (1e-5)
through both trainers' dispatch; and every JAX registry name built on the
plans U-Net, resolved in the port with the same field values. The networks
are tiny: 3 stages, features 4/8/16, patches of 8x16x16 with a [1, 3, 3]
kernel and a [1, 2, 2] stride. Weights go from a numpy-drawn flax tree
through ``jax_params_to_state_dict``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mlagg_unet_tpu.models import dynamic_unet as J
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.adan import adan as j_adan
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.models import dynamic_unet as P
from mlagg_unet_torch.models.layers import BatchNorm
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.lr_schedule import constant_lr, epoch_schedule_to_step_schedule
from mlagg_unet_torch.training.optim import OPTIMIZERS, OptimizerChain
from mlagg_unet_torch.training.trainer import Trainer, _check_ported, _epoch_schedule
from mlagg_unet_torch.weights import (
    jax_variables_to_state_dict,
    module_to_jax_variables,
    state_dict_to_jax_params,
)
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, flat_params, one_torch_thread, random_jax_params)

T = torch.from_numpy
SHAPES = {2: ([[3, 3]] * 3, [[1, 1], [2, 2], [2, 2]], (2, 16, 16)),
          3: ([[1, 3, 3], [3, 3, 3], [3, 3, 3]], [[1, 1, 1], [1, 2, 2], [2, 2, 2]],
              (2, 8, 16, 16))}


def _unet_kwargs(dim, norm, ds):
    ks, ps, _ = SHAPES[dim]
    return dict(n_stages=3, features_per_stage=[4, 8, 16], conv_kernel_sizes=ks,
                pool_op_kernel_sizes=ps, n_conv_per_stage_encoder=[2, 2, 2],
                n_conv_per_stage_decoder=[2, 2], deep_supervision=ds, norm=norm)


def _input(dim, cin=1, seed=0):
    return np.random.RandomState(seed).randn(*SHAPES[dim][2], cin).astype(np.float32)


def _jax_variables(module, x, seed=0):
    """Params drawn from numpy and, for BatchNorm, running statistics too
    (mean near 0, var near 1), so that eval mode reads them."""
    variables = {"params": random_jax_params(module, jnp.asarray(x), seed=seed)}
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    if "batch_stats" in shapes:
        rs = np.random.RandomState(seed + 1)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(
                (0.1 * rs.randn(*leaf.shape) if path[-1].key == "mean"
                 else 1 + 0.2 * rs.rand(*leaf.shape)).astype(np.float32)),
            shapes["batch_stats"])
    return variables


def _port_from(module, variables):
    module.load_state_dict(jax_variables_to_state_dict(
        variables["params"], {k: v for k, v in variables.items() if k != "params"}),
        strict=True)
    return module.eval()


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("ds", [True, False], ids=["ds", "no_ds"])
@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("dim", [2, 3])
def test_plain_conv_unet_matches_jax(dim, norm, ds):
    """The eval forward (BatchNorm on its running statistics), every output
    in JAX's order, highest resolution first: fp32 within 1e-4 relative."""
    kw = _unet_kwargs(dim, norm, ds)
    x = _input(dim)
    jm = J.PlainConvUNet(num_classes=3, **kw)
    variables = _jax_variables(jm, x)
    tm = _port_from(P.PlainConvUNet(1, 3, **kw), variables)
    ref = _outputs(jm.apply(variables, jnp.asarray(x)))
    got = _outputs(tm(T(x)))
    assert len(got) == len(ref) == (2 if ds else 1)
    assert got[0].shape[1:-1] == x.shape[1:-1]
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r), rel=1e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_batchnorm_train_forward_and_stats_match_jax(dim):
    """One train-mode forward: the outputs (1e-4) and the new running mean
    and variance of every BatchNorm against flax's mutable batch_stats
    (1e-5)."""
    kw = _unet_kwargs(dim, "batch", True)
    x = _input(dim, seed=3)
    jm = J.PlainConvUNet(num_classes=3, **kw)
    variables = _jax_variables(jm, x, seed=4)
    tm = _port_from(P.PlainConvUNet(1, 3, **kw), variables).train()
    ref, state = jm.apply(variables, jnp.asarray(x), False, mutable=["batch_stats"])
    got = tm(T(x))
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r), rel=1e-4)
    buffers = dict(tm.named_buffers())
    new = flat_params(state["batch_stats"])
    assert len(new) == len(buffers) == 2 * 2 * (3 + 2)   # mean, var of 10 norms
    for key, arr in new.items():
        assert_close(buffers[key.replace("/", ".")], arr, rel=1e-5, atol=1e-6)


def test_batchnorm_updates_with_the_biased_variance():
    """flax (and so the port) moves the running variance towards the biased
    batch variance; torch's F.batch_norm towards the unbiased one, n/(n-1)
    larger."""
    x = np.random.RandomState(5).randn(2, 3, 4, 6).astype(np.float32)
    bn = BatchNorm(6).train()
    bn.init_parameters(None)
    bn(T(x))
    flat = x.reshape(-1, 6)
    n = flat.shape[0]
    assert_close(bn.var, 0.9 + 0.1 * flat.var(0), rel=1e-6, atol=1e-7)
    assert_close(bn.mean, 0.1 * flat.mean(0), rel=1e-6, atol=1e-7)
    rm, rv = torch.zeros(6), torch.ones(6)
    F.batch_norm(T(x).permute(0, 3, 1, 2), rm, rv, training=True, momentum=0.1)
    assert_close(rv, 0.9 + 0.1 * flat.var(0) * n / (n - 1), rel=1e-6, atol=1e-7)
    assert not torch.allclose(rv, bn.var)


@pytest.mark.parametrize("case", ["block_same", "block_strided", "stack_2", "stack_bn"])
@pytest.mark.parametrize("dim", [2, 3])
def test_residual_blocks_match_jax(dim, case):
    """BasicBlockD with and without its 1x1 skip conv, and
    StackedResidualBlocks (instance and batch norm): fp32 within 1e-4."""
    ks, ps, _ = SHAPES[dim]
    k, s, ones = ks[1], ps[2], [1] * dim
    cin = 8 if case == "block_same" else 4
    norm = "batch" if case == "stack_bn" else "instance"
    if case.startswith("block"):
        stride = ones if case == "block_same" else s
        jm, tm = J.BasicBlockD(8, k, stride), P.BasicBlockD(cin, 8, k, stride)
        assert (tm.skip is None) == (case == "block_same")
    else:
        jm = J.StackedResidualBlocks(2, 8, k, s, norm=norm)
        tm = P.StackedResidualBlocks(2, cin, 8, k, s, norm=norm)
    x = _input(dim, cin=cin, seed=6)
    variables = _jax_variables(jm, x, seed=7)
    _port_from(tm, variables)
    assert_close(tm(T(x)), np.asarray(jm.apply(variables, jnp.asarray(x))), rel=1e-4)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_weights_round_trip_rank5_and_transposed(norm):
    """The 3-D U-Net's flax tree (rank-5 conv and decoder_transp kernels,
    batch_stats) into the port and back: the same keys, shapes and values;
    the kernels in the port's layouts."""
    kw = _unet_kwargs(3, norm, True)
    x = _input(3)
    jm = J.PlainConvUNet(num_classes=3, **kw)
    variables = _jax_variables(jm, x)
    tm = _port_from(P.PlainConvUNet(1, 3, **kw), variables)
    jp = flat_params(variables["params"])
    sd = tm.state_dict()
    assert sd["encoder_stage0.conv0.conv.weight"].shape == (4, 1, 1, 3, 3)
    assert sd["decoder_transp0.weight"].shape == (16, 8, 2, 2, 2)   # (in, out, *k)
    assert sd["decoder_transp1.weight"].shape == (8, 4, 1, 2, 2)
    assert np.array_equal(sd["decoder_transp1.weight"].numpy(),
                          jp["decoder_transp1/kernel"].transpose(3, 4, 0, 1, 2))
    back = state_dict_to_jax_params(sd, [k for k in jp])
    for k in jp:
        assert np.array_equal(back[k], jp[k]), k
    params, state = module_to_jax_variables(tm)
    assert flat_params(params).keys() == jp.keys()
    if norm == "batch":
        jb = flat_params(variables["batch_stats"])
        tb = flat_params(state["batch_stats"])
        assert tb.keys() == jb.keys() and all(np.array_equal(tb[k], jb[k]) for k in jb)
    else:
        assert state == {}
    joined = jax_variables_to_state_dict(params, state)
    assert joined.keys() == sd.keys() and all(torch.equal(joined[k], sd[k]) for k in sd)


def _optax_chain(kind, schedule, wd, eps):
    clip = optax.clip_by_global_norm(12.0)
    return {
        "sgd": optax.chain(clip, optax.add_decayed_weights(wd),
                           optax.sgd(schedule, momentum=0.99, nesterov=True)),
        "adamw": optax.chain(clip, optax.adamw(schedule, eps=eps, weight_decay=wd)),
        "adan": optax.chain(clip, j_adan(schedule, weight_decay=wd)),
        "adamw_amsgrad": optax.chain(clip, optax.scale_by_amsgrad(eps=eps),
                                     optax.add_decayed_weights(wd),
                                     optax.scale_by_learning_rate(schedule)),
        "adam_l2": optax.chain(clip, optax.add_decayed_weights(wd),
                               optax.adam(schedule, eps=eps)),
    }[kind]


@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_optimizer_chain_matches_optax(kind):
    """Three steps of clip -> the chain on the same gradients (the second
    large enough to be clipped) from the same params, the lr from a
    per-step schedule: params within 1e-6 relative to their largest."""
    rs = np.random.RandomState(8)
    params = {"a": rs.randn(5, 4).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * (20 if i == 1 else 1)).astype(np.float32)
              for k, v in params.items()} for i in range(3)]
    sched = lambda step: 1e-2 * (1 - step / 10) ** 0.9   # noqa: E731
    wd, eps = 3e-5, 1e-8
    chain = _optax_chain(kind, sched, wd, eps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = chain.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in params.items()}
    ours = OptimizerChain(tp.values(), kind, sched, 12.0, eps, wd)
    for g in grads:
        upd, state = chain.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = T(g[k].copy())
        ours.step()
    assert ours.count == 3
    for k in params:
        assert_close(tp[k], np.asarray(jp[k]), rel=1e-6, atol=1e-7)


def test_constant_schedule_and_its_recipe():
    """'constant' holds the initial lr at every epoch and step, in the
    trainer's schedule as in JAX's (trainer.py:272-273)."""
    cfg = dataclasses.replace(treg.get_trainer_config("nnUNetTrainer"), name="const",
                              lr_scheduler="constant", initial_lr=3e-3)
    _check_ported(cfg)
    step = epoch_schedule_to_step_schedule(_epoch_schedule(cfg), 250)
    assert [step(s) for s in (0, 249, 250, 10 ** 6)] == [3e-3] * 4
    assert constant_lr(0.5)(999) == 0.5


LOSSES = ["default", "ce", "dice", "dc_topk", "topk10", "topk10_ls01"]


@pytest.mark.parametrize("ignore", [False, True], ids=["labels", "ignore_label"])
@pytest.mark.parametrize("loss", LOSSES)
def test_recipe_losses_match_jax(loss, ignore):
    """Each recipe loss through both trainers' dispatch (the port's
    ``Trainer._single_loss``, JAX's ``_loss_for_outputs`` without deep
    supervision), 3-D logits, with and without an ignore label (3, one past
    the classes): within 1e-5."""
    rs = np.random.RandomState(9)
    logits = (rs.randn(2, 4, 6, 5, 3) * 2).astype(np.float32)
    target = rs.randint(0, 3, size=(2, 4, 6, 5)).astype(np.int32)
    il = 3 if ignore else None
    if ignore:
        target[rs.rand(*target.shape) < 0.2] = 3
    cfg = dataclasses.replace(jreg.get_trainer_config("nnUNetTrainer"), loss=loss,
                              enable_deep_supervision=False)
    jself = SimpleNamespace(
        cfg=cfg, label_manager=SimpleNamespace(has_regions=False, ignore_label=il,
                                               has_ignore_label=ignore),
        configuration_manager=SimpleNamespace(batch_dice=True))
    ref = NNUNetTrainerTPU._loss_for_outputs(jself, jnp.asarray(logits), jnp.asarray(target))
    tself = SimpleNamespace(cfg=cfg, ignore_label=il, regions=None, batch_dice=True)
    got = Trainer._single_loss(tself, T(logits), T(target))
    assert_close(got, np.asarray(ref), rel=1e-5, atol=1e-6)


def _plans_unet_names():
    return [k for k, v in jreg.TRAINER_REGISTRY.items()
            if v.network in ("plans_unet", "plans_unet_bn")]


@pytest.mark.parametrize("name", _plans_unet_names())
def test_plans_unet_recipe_resolves_with_jax_fields(name):
    """Every JAX trainer name on the plans U-Net resolves in the port with
    the same field values and passes the port's check."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    assert got.network in treg.NETWORK_BUILDERS
