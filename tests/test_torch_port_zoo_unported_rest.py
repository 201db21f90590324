"""The Mamba zoo's trainer names that the port does not build yet: each
resolves with the JAX registry's field values and raises at the port's
check, naming ROADMAP's A16. These are the zoo's other
networks, after ``mamba_variants.py``: MLLA-UNet, TransUNet, Swin-UNet,
LKM-UNet, SwinUNETR and MedNeXt (with its Mamba skip), under all of their
names.
"""
import dataclasses

import pytest

from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported

# every zoo network outside the plans' U-Net, the flagship, the ported ones
# and those of mamba_variants.py (test_torch_port_zoo_unported.py)
NEXT = ("segmamba", "lightm_unet", "ultralight_vmunet", "nnmamba")
UNPORTED = [k for k, v in jreg.TRAINER_REGISTRY.items()
            if v.network not in ("plans_unet", "plans_unet_bn", "mlla_uper", *NEXT)
            and v.network not in treg.NETWORK_BUILDERS]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_zoo_trainer_raises(name):
    """The name resolves with JAX's values and raises at the check, naming
    A16."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    with pytest.raises(NotImplementedError, match="A16"):
        _check_ported(got)
