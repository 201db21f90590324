"""The trainer names of ``models/mamba_variants.py`` in the PyTorch port
against the JAX package's registry, on the CPU: SegMamba, LightM-UNet,
UltraLight VM-UNet and nnMamba under both of their names resolve with JAX's
field values, pass the port's check and build at full width at their plans
with JAX's parameter count; the builders refuse what their networks cannot
take, and nnMamba takes its strides from the plans as JAX's builder does.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.models import mamba_variants as TMV
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

VARIANTS = ("segmamba", "lightm_unet", "ultralight_vmunet", "nnmamba")
NAMES = sorted(k for k, v in jreg.TRAINER_REGISTRY.items() if v.network in VARIANTS)
# the plans they are trained at on the card: the 3-D bench topology at
# 64x128x128 (pools [1,1,1], [2,2,2] x 4, [1,2,2]) and nnU-Net's 2d plan at
# 320x320 (7 stages)
CM_3D = SimpleNamespace(patch_size=[64, 128, 128],
                        pool_op_kernel_sizes=[[1, 1, 1]] + [[2, 2, 2]] * 4 + [[1, 2, 2]])
CM_2D = SimpleNamespace(patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6)
PLAN = {"segmamba": (CM_3D, 3), "nnmamba": (CM_3D, 3), "lightm_unet": (CM_2D, 4),
        "ultralight_vmunet": (CM_2D, 4)}
# a small input of each plan's dimension that every network takes (the
# parameter count does not depend on it)
SMALL = {3: (1, 16, 64, 64, 1), 2: (1, 64, 64, 1)}


def test_the_names_are_the_variants():
    """Eight names: the four networks under both of their names."""
    assert len(NAMES) == 8
    assert {jreg.get_trainer_config(n).network for n in NAMES} == set(VARIANTS)


@pytest.mark.parametrize("name", NAMES)
def test_zoo_variant_trainer_builds(name):
    """The name resolves with JAX's field values, passes the port's check,
    and its network builds at its plan with JAX's parameter count."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    cm, classes = PLAN[got.network]
    net = treg.get_network_builder(got.network)(cm, 1, classes, got.enable_deep_supervision,
                                                device="cpu")
    assert not net.training
    jm = jreg.get_network_builder(got.network)(cm, 1, classes, got.enable_deep_supervision)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros(SMALL[len(cm.patch_size)], jnp.float32))["params"]
    want = sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in net.parameters()) == want


def test_builders_refuse_what_the_networks_cannot_take():
    """SegMamba is 3-D (its strides are); UltraLight 2-D with a patch
    divisible by 32; nnMamba takes its strides from the plans, padded with
    ones, so it needs the ConfigurationManager; LightM-UNet takes the
    patch's dimension."""
    build = treg.get_network_builder
    with pytest.raises(ValueError, match="3D"):
        build("segmamba")(CM_2D, 1, 3, False, device="cpu")
    with pytest.raises(ValueError, match="divides by 32"):
        build("ultralight_vmunet")((320, 300), 1, 3, False, device="cpu")
    with pytest.raises(ValueError, match="divides by 32"):
        build("ultralight_vmunet")((32, 64, 64), 1, 3, False, device="cpu")
    with pytest.raises(ValueError, match="ConfigurationManager"):
        build("nnmamba")((32, 64, 64), 1, 3, False, device="cpu")
    cm = SimpleNamespace(patch_size=[32, 64], pool_op_kernel_sizes=[[1, 1], [2, 2], [1, 2]])
    nn_ = build("nnmamba")(cm, 1, 3, False, device="cpu", channels=16)
    assert nn_.strides == [(2, 2), (1, 2), (1, 1), (1, 1)]
    assert nn_.layer1_block0.conv1.weight.ndim == 4
    lm = build("lightm_unet")((16, 32, 32), 1, 3, False, device="cpu", init_filters=8)
    assert isinstance(lm, TMV.LightMUNet) and lm.convInit.dw.weight.ndim == 5
