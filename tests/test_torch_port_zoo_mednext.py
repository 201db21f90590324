"""MedNeXt in the PyTorch port against the JAX package on the CPU: the
S preset in 2-D with deep supervision, in 2-D with its multi-scale Mamba
skip over the four skips and the bottleneck, and in 3-D at kernel 5 with
deep supervision; the forward in fp32 and in bf16 against JAX's bf16, the
param tree both ways (the up blocks' depthwise transposed kernels), the
reference ``.pth`` converter of ``mednext_b3`` / ``mednext_b5``, and the
three MedNeXt trainer names built at full width from nnU-Net's 2d plan with
JAX's parameter counts.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds (``port_zoo``). Every fp32 output is held within 1e-4 x max|ref|
(+1e-5), a bf16 output within twice the distance bf16 moves JAX's own
network.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

import port_zoo
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.models.mednext_net import MedNeXtNet
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["mednext_s_2d", "mednext_s_2d_mambaskip", "mednext_s_3d"]
CM_2D = SimpleNamespace(patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6)
# JAX's counts at that plan, 4 classes, with deep supervision
PARAMS_2D = {"mednext_b3": 10_451_316, "mednext_b3_mambaskip": 13_344_620}
TRAINERS = ["nnUNetTrainer_MedNeXt", "nnUNetTrainer_MedNeXt_new",
            "nnUNetTrainer_MedNeXt_Mambaskip"]


@pytest.fixture(scope="module")
def nets():
    """The file's networks of both packages with one seeded param tree, and
    JAX's output on the seeded input (jitted)."""
    return port_zoo.build_nets(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(nets, name):
    """Every deep-supervision output equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[name])


@pytest.mark.parametrize("name", NAMES[:2])
def test_bf16_network_follows_jax(nets, name):
    """In bf16 (parameters and input cast, as both predictors do) the port
    computes JAX's function: the output answers in JAX's dtype, and sits
    from the port's fp32 output and from JAX's bf16 output within twice the
    distance JAX's bf16 output sits from JAX's fp32 output."""
    port_zoo.check_bf16(nets[name])


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_round_trip(nets, name):
    """JAX tree -> state_dict -> JAX tree, exactly, for every parameter."""
    port_zoo.check_tree(nets[name])


@pytest.mark.parametrize("name", ["mednext_s_2d", "mednext_s_3d"])
def test_reference_pth_converts_and_loads_strict(nets, name):
    """A reference-format state_dict (the up blocks' depthwise
    ConvTranspose, the heads as ConvTranspose of kernel 1) maps back through
    JAX's converter exactly; the port's converter loads it strict, and the
    network then matches JAX's forward."""
    port_zoo.check_pth(nets[name])


@pytest.mark.parametrize("name", TRAINERS)
def test_mednext_trainer_builds_at_full_width(name):
    """The name resolves with JAX's field values, passes the port's check,
    and its network (B, kernel 3, the Mamba skip where the name says)
    builds from nnU-Net's 2d plan with JAX's parameter count."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    net = treg.get_network_builder(got.network)(CM_2D, 1, 4, got.enable_deep_supervision,
                                                device="cpu")
    assert isinstance(net, MedNeXtNet) and not net.training
    assert net.use_mamba_skip == got.network.endswith("mambaskip")
    jm = jreg.get_network_builder(got.network)(CM_2D, 1, 4, got.enable_deep_supervision)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    want = sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes))
    assert want == PARAMS_2D[got.network]
    assert sum(p.numel() for p in net.parameters()) == want
    if net.use_mamba_skip:
        with pytest.raises(ValueError, match="2-D only"):
            treg.get_network_builder(got.network)((32, 64, 64), 1, 4, True, device="cpu")
