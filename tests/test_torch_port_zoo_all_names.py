"""Every trainer name of the JAX package's registry in the PyTorch port:
each resolves with JAX's field values, its network has a builder in the
port's ``NETWORK_BUILDERS``, and it passes the port's check
(``_check_ported``). Cheap: nothing is built.
"""
import dataclasses

import pytest

from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported

NAMES = sorted(jreg.TRAINER_REGISTRY)


def test_the_port_knows_every_jax_name_and_network():
    """The port's registry holds JAX's 87 names, and a builder for each of
    their networks."""
    assert len(NAMES) == 87
    assert set(NAMES) <= set(treg.TRAINER_REGISTRY)
    assert {jreg.get_trainer_config(n).network for n in NAMES} <= set(treg.NETWORK_BUILDERS)


@pytest.mark.parametrize("name", NAMES)
def test_trainer_name_resolves_and_is_ported(name):
    """The name resolves with JAX's field values, its network is in
    ``NETWORK_BUILDERS``, and the port's check passes."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    assert got.network in treg.NETWORK_BUILDERS
    _check_ported(got)


def test_an_unknown_network_raises_at_the_check():
    """A recipe whose network the registry has no builder for raises at the
    check, naming it."""
    cfg = dataclasses.replace(treg.get_trainer_config("nnUNetTrainer"), name="x",
                              network="no_such_network")
    with pytest.raises(NotImplementedError, match="no_such_network.*not ported"):
        _check_ported(cfg)
