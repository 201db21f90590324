"""The port's training run against the JAX package's, on the CPU: what the
trainer derives from the dataset and the plans. The 5-fold split written and
read by either package (``splits_final.json``) and the deep-supervision
scales and loss weights of the flagship's fixed levels and of the plans'
pooling. Tolerances are stated per test.
"""
import os
from dataclasses import replace

import numpy as np
import pytest

from mlagg_unet_tpu.plans.plans_handler import PlansManager as JPlansManager
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import (
    NNUNetTrainer,
    deep_supervision_loss_weights,
    deep_supervision_scales,
)
from port_helpers import TINY_DATASET_JSON, one_torch_thread, tiny_plans  # noqa: F401
from test_torch_port_train_loop import PLANS, TR, env  # noqa: F401  (env: a fixture)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fold", [0, 3, 4, 7, "all"])
def test_do_split_matches_jax(env, fold, writer):
    """The same split from splits_final.json whichever package wrote it; a
    fold past the fifth takes the 80:20 fallback in both."""
    plans = tiny_plans("Dataset994_PortSplit")
    pre = env["root"] / "preprocessed" / "Dataset994_PortSplit"
    os.makedirs(pre / "nnUNetPlans_2d", exist_ok=True)
    for i in range(9):
        (pre / "nnUNetPlans_2d" / f"c{i}.npz").touch()
    if (pre / "splits_final.json").exists():
        os.remove(pre / "splits_final.json")
    port = NNUNetTrainer(plans, "2d", fold, TINY_DATASET_JSON, trainer_name=TR, device="cpu")
    jax_ = NNUNetTrainerTPU(plans, "2d", fold, TINY_DATASET_JSON, trainer_name=TR,
                            num_devices=1)
    first, second = (port, jax_) if writer == "port" else (jax_, port)
    got = first.do_split()
    assert (pre / "splits_final.json").exists() == (fold != "all")
    assert second.do_split() == got


# --------------------------------------------------- deep supervision, losses
@pytest.mark.parametrize("recipe", ["flagship", "plans"])
def test_deep_supervision_scales_and_weights_match_jax(env, recipe):
    """The flagship's fixed scales keep the lowest weight; scales from the
    plans' pooling (the lowest level dropped) zero the lowest output."""
    config = {} if recipe == "flagship" else dict(deep_supervision_scales_override=None)
    env["mp"].setitem(jreg.TRAINER_REGISTRY, TR + recipe,
                      replace(jreg.TRAINER_REGISTRY[TR], name=TR + recipe, **config))
    cfg = replace(treg.TRAINER_REGISTRY[TR], name=TR + recipe, **config)
    jtr = NNUNetTrainerTPU(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR + recipe,
                           num_devices=1)
    cm = JPlansManager(PLANS).get_configuration("2d")
    assert deep_supervision_scales(cfg, cm) == jtr._get_deep_supervision_scales()
    for n in range(1, 7):
        np.testing.assert_allclose(deep_supervision_loss_weights(cfg, n),
                                   jtr._get_ds_weights(n), rtol=1e-12)
    assert (deep_supervision_loss_weights(cfg, 5)[-1] == 0) == (recipe == "plans")
