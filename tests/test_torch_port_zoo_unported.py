"""The Mamba zoo's trainer names that the port does not build yet: each
resolves with the JAX registry's field values and raises at the port's
check, naming ROADMAP's A16. These are the networks of
``models/mamba_variants.py``, A16's next step: SegMamba, LightM-UNet,
UltraLight VM-UNet and nnMamba, under both of their names.
"""
import dataclasses

import pytest

from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported

# the networks of mamba_variants.py (registry.py:243-300) and their aliases
NEXT = ("segmamba", "lightm_unet", "ultralight_vmunet", "nnmamba")
UNPORTED = [k for k, v in jreg.TRAINER_REGISTRY.items() if v.network in NEXT]


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_zoo_trainer_raises(name):
    """The name resolves with JAX's values and raises at the check, naming
    A16."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    with pytest.raises(NotImplementedError, match="A16"):
        _check_ported(got)
