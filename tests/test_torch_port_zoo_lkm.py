"""LKM-UNet in the PyTorch port against the JAX package on the CPU: the
residual encoder with a pixel-level and a window-level bidirectional Mamba
layer after every stage, and the residual decoder; at sizes whose every
stage takes the p-strided sub-grids (2-D: 3 stages at 40x40; 3-D: 2 stages
at 20x28x24) and at the JAX package's own sizes (16x16, 8x8x8), which take
the whole-map fallback. The forward in fp32, every gradient against
``jax.grad``, bf16 against JAX's bf16, the param tree both ways (the
transposed convs ``transpconv*``), the reference ``.pth`` converter, and
``nnUNetTrainer_LKM_UNet`` built at full width from nnU-Net's 2d plan with
JAX's parameter count.

Weights come from numpy seeds into the JAX param tree (the scan's
parameters near their init); inputs from numpy seeds (``port_zoo``). Every
fp32 output is held within 1e-4 x max|ref| (+1e-5), every gradient within
2e-4 x max|ref| (+1e-6) (a conv bias that a norm follows, whose gradient is
rounding around 0, within 2e-4 x max|its kernel's gradient|), a bf16 output
within twice the distance bf16 moves JAX's own network.
"""
import dataclasses
from types import SimpleNamespace

import pytest

import port_zoo
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["lkm_unet_2d", "lkm_unet_3d", "lkm_unet_2d_small", "lkm_unet_3d_small"]
SUBGRIDS = NAMES[:2]
# nnU-Net's 2d plan at 320x320 as the card's phase 11 takes it: 7 stages,
# features 32 to 512, 3x3 kernels, 2 blocks a stage
CM_2D = SimpleNamespace(
    patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6,
    conv_kernel_sizes=[[3, 3]] * 7, UNet_base_num_features=32, unet_max_num_features=512,
    n_conv_per_stage_encoder=[2] * 7, n_conv_per_stage_decoder=[2] * 6)
LKM_PARAMS_2D = 81_397_688     # JAX's count at this plan


@pytest.fixture(scope="module")
def nets():
    """The file's networks of both packages with one seeded param tree, and
    JAX's output on the seeded input (jitted)."""
    return port_zoo.build_nets(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(nets, name):
    """Every deep-supervision output equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[name])


@pytest.mark.parametrize("name", SUBGRIDS)
def test_gradients_match_jax(nets, name):
    """The gradients in the input and in every parameter equal
    ``jax.grad``'s."""
    port_zoo.check_grads(nets[name], port_zoo.LKM_NORM_FED)


def test_bf16_network_follows_jax(nets):
    """In bf16 (parameters and input cast) the port computes JAX's
    function: fp32 from the first Mamba block's output on, as flax
    promotes."""
    port_zoo.check_bf16(nets["lkm_unet_2d"])


@pytest.mark.parametrize("name", SUBGRIDS)
def test_param_tree_round_trip(nets, name):
    """JAX tree -> state_dict -> JAX tree, exactly, for every parameter."""
    port_zoo.check_tree(nets[name])


@pytest.mark.parametrize("name", SUBGRIDS)
def test_reference_pth_converts_and_loads_strict(nets, name):
    """A reference-format state_dict (the shared out_proj of each
    bidirectional layer, ``dt_proj`` as a Linear) maps back through JAX's
    converter exactly; the port's converter loads it strict, and the network
    then matches JAX's forward."""
    port_zoo.check_pth(nets[name])


def test_lkm_trainer_builds_at_full_width():
    """``nnUNetTrainer_LKM_UNet`` resolves with JAX's field values, passes
    the port's check, and builds from nnU-Net's 2d plan with deep
    supervision and JAX's 81,397,688 parameters."""
    import jax
    import jax.numpy as jnp

    name = "nnUNetTrainer_LKM_UNet"
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    net = treg.get_network_builder(got.network)(CM_2D, 1, 4, True, device="cpu")
    assert not net.training and net.deep_supervision and net.n_stages == 7
    jm = jreg.get_network_builder(got.network)(CM_2D, 1, 4, True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    assert sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes)) == LKM_PARAMS_2D
    assert sum(p.numel() for p in net.parameters()) == LKM_PARAMS_2D
    with pytest.raises(ValueError, match="ConfigurationManager"):
        treg.get_network_builder(got.network)((320, 320), 1, 4, True, device="cpu")
