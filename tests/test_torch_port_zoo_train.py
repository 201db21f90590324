"""``run_training`` of a tiny U-Mamba Bot recipe in the PyTorch port against
the JAX package's, on the CPU: SGD, the poly schedule and deep supervision in
fp32, from JAX's init on one batch sequence; the logged losses and pseudo
dice within 1e-4.
"""
import dataclasses
import os
from dataclasses import replace

import numpy as np
import pytest

from mlagg_unet_tpu.models import umamba as JUM
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import NNUNetTrainer
from mlagg_unet_torch.weights import jax_params_to_state_dict
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TINY_DATASET_JSON, flat_params, one_torch_thread, set_paths, tiny_plans)
from test_torch_port_mamba import mamba_params


# ---------------------------------------------------------------- run_training
DATASET = "Dataset991_PortUMamba"

TR = "nnUNetTrainerUMambaBot_PortTiny"

EPOCHS, STEPS, VAL_STEPS = 2, 2, 1


def _tiny_umamba_plans():
    """3 stages (an 8x8 bottleneck of 16 channels). With CM_2D's 4 stages
    the run is chaotic at the recipe's SGD step: JAX's own epoch-2
    validation loss moves by 3.4e-4 under a 1e-7 relative change of its
    init; here by 1.5e-6."""
    plans = tiny_plans(DATASET)
    plans["configurations"]["2d"].update(
        pool_op_kernel_sizes=[[1, 1], [2, 2], [2, 2]], conv_kernel_sizes=[[3, 3]] * 3,
        UNet_base_num_features=4, unet_max_num_features=16,
        n_conv_per_stage_encoder=[2, 2, 2], n_conv_per_stage_decoder=[2, 2])
    return plans


class _SeqLoader:
    def __init__(self, batches, per_epoch, cycle=False):
        self.batches, self.per_epoch, self.cycle, self.pos = batches, per_epoch, cycle, 0

    def __iter__(self):
        for _ in range(self.per_epoch):
            yield self.get_batch()

    def get_batch(self):
        batch = self.batches[self.pos % len(self.batches) if self.cycle else self.pos]
        self.pos += 1
        return batch

    def stop(self):
        pass


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(2, 32, 32, 1).astype(np.float32)
        y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
        out.append({"data": x, "target": y})
    return out


def _stand_in_loaders(trainer, train, val):
    def get_dataloaders():
        trainer.dataloader_train = _SeqLoader(train, STEPS)
        trainer.dataloader_val = _SeqLoader(val, VAL_STEPS, cycle=True)
        return trainer.dataloader_train, trainer.dataloader_val
    trainer.get_dataloaders = get_dataloaders


class _NumpyInitUMamba(JUM.UMambaUNet):
    """JAX's U-Mamba with its init drawn from numpy (``mamba_params``), not
    flax's threefry init."""

    def init(self, rngs, *args, **kwargs):
        plain = JUM.UMambaUNet(**_fields(self), parent=None)
        return {"params": mamba_params(plain, *args)}


def _fields(module):
    return {f.name: getattr(module, f.name) for f in dataclasses.fields(JUM.UMambaUNet)
            if f.name not in ("parent", "name")}


def _jax_tiny_builder(cm, cin, cout, ds):
    return _NumpyInitUMamba(**_fields(JUM.umamba_from_plans(cm, cin, cout, ds, "bot")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run_training of the tiny U-Mamba Bot recipe (SGD, poly, deep
    supervision; fp32) in both packages from JAX's init, on one batch
    sequence."""
    root = tmp_path_factory.mktemp("port_umamba_train")
    plans = _tiny_umamba_plans()
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        net = TR + "_network"
        mp.setitem(jreg.NETWORK_BUILDERS, net, _jax_tiny_builder)
        mp.setitem(treg.NETWORK_BUILDERS, net, treg.NETWORK_BUILDERS["umamba_bot"])
        for reg in (jreg, treg):
            mp.setitem(reg.TRAINER_REGISTRY, TR, replace(
                reg.TRAINER_REGISTRY["nnUNetTrainerUMambaBot"], name=TR, network=net,
                num_epochs=EPOCHS, num_iterations_per_epoch=STEPS,
                num_val_iterations_per_epoch=VAL_STEPS, compute_dtype="float32"))
        train, val = _batches(EPOCHS * STEPS, 1), _batches(1, 2)
        jtr = NNUNetTrainerTPU(plans, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                               unpack_data=False, num_devices=1)
        jtr.initialize()
        init = {k: np.array(v) for k, v in flat_params(jtr.params).items()}
        _stand_in_loaders(jtr, train, val)
        jtr.run_training()
        ttr = NNUNetTrainer(plans, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                            unpack_data=False, device="cpu")
        ttr.initialize()
        ttr.step.network.load_state_dict(jax_params_to_state_dict(init), strict=True)
        _stand_in_loaders(ttr, train, val)
        ttr.run_training()
        yield jtr, ttr


@pytest.mark.parametrize("key", ["train_losses", "val_losses", "mean_fg_dice"])
def test_umamba_run_training_matches_jax(runs, key):
    """The logged series of both runs within 1e-4 relative, and the port's
    checkpoint_final written."""
    jtr, ttr = runs
    got = ttr.logger.my_fantastic_logging[key]
    ref = jtr.logger.my_fantastic_logging[key]
    assert len(got) == len(ref) == EPOCHS
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-4, atol=1e-7)
    assert os.path.isfile(os.path.join(ttr.output_folder, "checkpoint_final.ckpt"))
