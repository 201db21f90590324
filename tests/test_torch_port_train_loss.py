"""The port's training run against the JAX package's, on the CPU: sklearn's
KFold permutation as the split takes it, and the loss and the validation
step's (tp, fp, fn) for labels, regions and the ignore label, with and
without deep supervision, on a one-Dense network. Tolerances are stated per
test.
"""
from dataclasses import replace

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_tpu.training.trainer import kfold_like_sklearn as j_kfold
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import Trainer, kfold_like_sklearn
from mlagg_unet_torch.weights import jax_params_to_state_dict
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TINY_DATASET_JSON, flat_params, one_torch_thread, tiny_plans)
from test_torch_port_train_loop import DATASET, TR, env  # noqa: F401  (env: a fixture)

T = torch.from_numpy


class _JaxHead(nn.Module):
    """One Dense over the channels at three scales: a network whose step
    functions compile in a second."""
    out_channels: int
    deep_supervision: bool = True

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        dense = nn.Dense(self.out_channels, name="Dense_0")
        outs = [dense(x), dense(x[:, ::2, ::2]), dense(x[:, ::4, ::4])]
        return outs if self.deep_supervision else outs[0]


class _TorchHead(torch.nn.Module):
    def __init__(self, cin, cout, ds):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(cin, cout)
        self.ds = ds

    def forward(self, x, generator=None):
        outs = [self.Dense_0(x), self.Dense_0(x[:, ::2, ::2]), self.Dense_0(x[:, ::4, ::4])]
        return outs if self.ds else outs[0]


# ------------------------------------------------------------------ split
@pytest.mark.parametrize("n", [5, 7, 11, 23])
def test_kfold_like_sklearn_matches_jax(n):
    keys = [f"case_{i:03d}" for i in range(n)][::-1]
    assert kfold_like_sklearn(keys, 5) == j_kfold(keys, 5)


REGIMES = {
    "labels": {"background": 0, "a": 1, "b": 2},
    "ignore": {"background": 0, "a": 1, "b": 2, "ignore": 3},
    "regions": {"background": 0, "whole": [1, 2], "core": 2},
    "regions_ignore": {"background": 0, "whole": [1, 2], "core": 2, "ignore": 3},
}


@pytest.mark.parametrize("ds", [True, False])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_loss_and_val_step_match_jax(env, regime, ds):
    """The loss (plans-derived deep supervision, batch dice) and the
    validation step's loss and (tp, fp, fn) of a one-layer network on 4
    input channels, labels / regions / the ignore label: loss within 1e-6
    relative, the counts equal."""
    name = f"{TR}_{regime}_{ds}"
    labels = REGIMES[regime]
    dj = dict(TINY_DATASET_JSON, labels=labels,
              channel_names={str(i): f"c{i}" for i in range(4)},
              **({"regions_class_order": [1, 2]} if "regions" in regime else {}))
    plans = tiny_plans(DATASET, patch=(16, 16))
    plans["configurations"]["2d"]["pool_op_kernel_sizes"] = [[1, 1], [2, 2], [2, 2]]
    mp = env["mp"]
    mp.setitem(jreg.NETWORK_BUILDERS, "head", lambda cm, cin, cout, d: _JaxHead(cout, d))
    mp.setitem(treg.NETWORK_BUILDERS, "head",
               lambda patch, cin, cout, d, **kw: _TorchHead(cin, cout, d))
    for reg in (jreg, treg):
        mp.setitem(reg.TRAINER_REGISTRY, name, replace(
            reg.TRAINER_REGISTRY[TR], name=name, network="head", enable_deep_supervision=ds,
            deep_supervision_scales_override=None))
    jtr = NNUNetTrainerTPU(plans, "2d", 0, dj, trainer_name=name, num_devices=1)
    lm = jtr.label_manager
    ttr = Trainer(name, num_input_channels=4, num_classes=lm.num_segmentation_heads,
                  batch_size=2, batch_dice=True, device="cpu",
                  regions=lm.all_regions if lm.has_regions else None,
                  ignore_label=lm.ignore_label, configuration_manager=jtr.configuration_manager)
    rs = np.random.RandomState(11)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    y = rs.randint(0, max(v if isinstance(v, int) else max(v) for v in labels.values()) + 1,
                   size=(2, 16, 16)).astype(np.int32)
    outs = [rs.randn(2, 16 // s, 16 // s, lm.num_segmentation_heads).astype(np.float32)
            for s in (1, 2, 4)]
    jtr.ds_scales = jtr._get_deep_supervision_scales()
    assert ttr.ds_scales == jtr.ds_scales
    got = ttr.loss([T(o) for o in outs] if ds else T(outs[0]), T(y))
    ref = jtr._loss_for_outputs([jnp.asarray(o) for o in outs] if ds else jnp.asarray(outs[0]),
                                jnp.asarray(y))
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref)) + 1e-7

    jtr.network, jtr.model_state = _JaxHead(lm.num_segmentation_heads, ds), {}
    params = jtr.network.init(__import__("jax").random.PRNGKey(0), jnp.asarray(x))["params"]
    ttr.network.load_state_dict(jax_params_to_state_dict(flat_params(params)), strict=True)
    jtr._build_step_fns()
    ref = jtr._val_step(params, {}, jnp.asarray(x), jnp.asarray(y))
    got = ttr.val_step(T(x), T(y))
    assert abs(got[0].item() - float(ref[0])) <= 1e-6 * abs(float(ref[0])) + 1e-7
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1].shape == (lm.num_segmentation_heads - (0 if lm.has_regions else 1),)
