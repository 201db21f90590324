"""``run_training`` of a tiny SegMamba recipe in the PyTorch port against
the JAX package's, on the CPU: ``nnUNetTrainer_SegMamba``'s AdamW, its
cosine warm-up schedule and no deep supervision, in 3-D and fp32, from
JAX's init on one batch sequence; the logged losses and pseudo dice within
1e-4 relative.
"""
import dataclasses
import os
from dataclasses import replace

import numpy as np
import pytest

import port_zoo
from mlagg_unet_tpu.models import mamba_variants as JMV
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import NNUNetTrainer
from mlagg_unet_torch.weights import jax_params_to_state_dict
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TINY_DATASET_JSON, flat_params, one_torch_thread, set_paths, tiny_plans)
from test_torch_port_mamba import mamba_params
from test_torch_port_zoo_train import _SeqLoader, _stand_in_loaders

DATASET = "Dataset989_PortSegMamba"
TR = "nnUNetTrainer_SegMamba_PortTiny"
EPOCHS, STEPS, VAL_STEPS = 2, 2, 1
# SegMamba's stages scan 512, 64, 8 and 1 tokens over 8, 4, 2 and 1 slices.
# The pseudo dice counts argmax voxels, and JAX's own is not determined by
# its fp32 arithmetic at a 16x32x32 patch: under a 3e-6 relative change of
# its init (which moves its losses by 5e-6, as far as the port's sit from
# them) it moved by 6.1e-4; here by under 1e-5
PATCH = (8, 16, 16)
TINY = dict(port_zoo.SEGMAMBA, num_slices_list=(8, 4, 2, 1))


def _plans_3d():
    """The tiny 2d plan made a 3d_fullres one at PATCH."""
    plans = tiny_plans(DATASET)
    cfg = plans["configurations"].pop("2d")
    cfg.update(data_identifier="nnUNetPlans_3d_fullres", patch_size=list(PATCH),
               spacing=[1.0, 1.0, 1.0],
               pool_op_kernel_sizes=[[1, 1, 1], [2, 2, 2], [2, 2, 2], [2, 2, 2]])
    plans["configurations"]["3d_fullres"] = cfg
    return plans


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(2, *PATCH, 1).astype(np.float32)
        y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
        out.append({"data": x, "target": y})
    return out


class _NumpyInitSegMamba(JMV.SegMamba):
    """JAX's tiny SegMamba with its init drawn from numpy (``mamba_params``),
    not flax's threefry init."""

    def init(self, rngs, *args, **kwargs):
        plain = JMV.SegMamba(**_fields(self), parent=None)
        return {"params": mamba_params(plain, *args)}


def _fields(module):
    return {f.name: getattr(module, f.name) for f in dataclasses.fields(JMV.SegMamba)
            if f.name not in ("parent", "name")}


def _jax_tiny_builder(cm, cin, cout, ds):
    return _NumpyInitSegMamba(num_classes=cout, **TINY)


def _port_tiny_builder(cm, cin, cout, ds, **kwargs):
    return treg.NETWORK_BUILDERS["segmamba"](cm, cin, cout, ds, **kwargs, **TINY)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run_training of the tiny SegMamba recipe (AdamW, cosine warm-up, no
    deep supervision; fp32) in both packages from JAX's init, on one batch
    sequence."""
    root = tmp_path_factory.mktemp("port_segmamba_train")
    plans = _plans_3d()
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        net = TR + "_network"
        mp.setitem(jreg.NETWORK_BUILDERS, net, _jax_tiny_builder)
        mp.setitem(treg.NETWORK_BUILDERS, net, _port_tiny_builder)
        for reg in (jreg, treg):
            mp.setitem(reg.TRAINER_REGISTRY, TR, replace(
                reg.TRAINER_REGISTRY["nnUNetTrainer_SegMamba"], name=TR, network=net,
                num_epochs=EPOCHS, num_iterations_per_epoch=STEPS, warmup_epochs=1,
                num_val_iterations_per_epoch=VAL_STEPS, compute_dtype="float32"))
        train, val = _batches(EPOCHS * STEPS, 1), _batches(1, 2)
        jtr = NNUNetTrainerTPU(plans, "3d_fullres", 0, TINY_DATASET_JSON, trainer_name=TR,
                               unpack_data=False, num_devices=1)
        jtr.initialize()
        init = {k: np.array(v) for k, v in flat_params(jtr.params).items()}
        _stand_in_loaders(jtr, train, val)
        jtr.run_training()
        ttr = NNUNetTrainer(plans, "3d_fullres", 0, TINY_DATASET_JSON, trainer_name=TR,
                            unpack_data=False, device="cpu")
        ttr.initialize()
        ttr.step.network.load_state_dict(jax_params_to_state_dict(init), strict=True)
        _stand_in_loaders(ttr, train, val)
        ttr.run_training()
        yield jtr, ttr


@pytest.mark.parametrize("key", ["train_losses", "val_losses", "mean_fg_dice"])
def test_segmamba_run_training_matches_jax(runs, key):
    """The logged series of both runs within 1e-4 relative, and the port's
    checkpoint_final written."""
    jtr, ttr = runs
    got = ttr.logger.my_fantastic_logging[key]
    ref = jtr.logger.my_fantastic_logging[key]
    assert len(got) == len(ref) == EPOCHS
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-4, atol=1e-7)
    assert os.path.isfile(os.path.join(ttr.output_folder, "checkpoint_final.ckpt"))

