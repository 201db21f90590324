"""The Mamba zoo's trainer names in the PyTorch port against the JAX
package's registry: the first family's names (and the two aliases of its
networks) resolve with JAX's field values and pass the port's check, and
the registry's builders take what JAX's take. Every JAX name, each with
its network built by the port, is in ``test_torch_port_zoo_all_names.py``;
the 3-D and MSVM names are in ``test_torch_port_zoo3d_train.py``.
"""
import dataclasses
from types import SimpleNamespace

import pytest

import port_zoo
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.models import umamba as TUM
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported


# ---------------------------------------------------------------- the trainer names
PORTED = ("nnUNetTrainerUMambaBot", "nnUNetTrainerUMambaEnc", "nnUNetTrainer_VMUNet",
          "nnUNetTrainer_MambaUNet", "nnUNetTrainerSwinUMambaScratch",
          "nnUNetTrainerSwinUMambaDScratch", "nnUNetTrainerVMUNet", "nnUNetTrainerMambaUNet")


@pytest.mark.parametrize("name", PORTED)
def test_ported_zoo_trainer_resolves(name):
    """The family's names (and the two aliases of its networks) resolve with
    JAX's field values and pass the port's check."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)


def test_builders_follow_jax():
    """The registry's builders: U-Mamba from the plans only, the 2-D
    networks refuse a 3-D plan, deep supervision where the network has it,
    the recipes' optimizers and schedules as JAX's."""
    cm = SimpleNamespace(**vars(port_zoo.CM_2D))
    net = treg.get_network_builder("umamba_enc")(cm, 1, 3, False, device="cpu")
    assert isinstance(net, TUM.UMambaUNet) and not net.training and not net.deep_supervision
    with pytest.raises(ValueError, match="ConfigurationManager"):
        treg.get_network_builder("umamba_bot")((32, 32), 1, 3, True, device="cpu")
    with pytest.raises(ValueError, match="2D"):
        treg.get_network_builder("vmunet")((8, 16, 16), 1, 3, False, device="cpu")
    sw = treg.get_network_builder("swin_umamba_d")((64, 64), 1, 2, True, device="cpu",
                                                   dims=port_zoo.DIMS)
    assert sw.deep_supervision and hasattr(sw, "seg0")
    vm = treg.get_trainer_config("nnUNetTrainer_VMUNet")
    assert (vm.optimizer, vm.initial_lr, vm.weight_decay, vm.lr_scheduler,
            vm.enable_deep_supervision) == ("adamw", 1e-4, 1e-3, "cosine_warmup", False)
    assert treg.get_trainer_config("nnUNetTrainer_MambaUNet").initial_lr == 1e-3
