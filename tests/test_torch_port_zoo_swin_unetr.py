"""SwinUNETR (2-D) in the PyTorch port against the JAX package on the CPU:
monai's swin encoder (windows clamped to the map, padded to the window,
shifted with the -100 region mask, a ``PatchMergingV2`` after every stage,
the parameter-free LayerNorm on each hidden state) and the UNETR decoder.
The forward in fp32 at narrow widths on 64x64 with the window of 7 (stages
at 32, 16 and 8 pad and shift, at 4 the window is clamped), every gradient
against ``jax.grad`` (the UNETR blocks' conv biases, each before an
InstanceNorm, held to their kernel's gradient scale), the reference ``.pth``
converter, the blocks at odd sizes, and ``nnUNetTrainerSwinUNETR_2d`` built
at full width from nnU-Net's 2d plan with JAX's parameter count.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds (``port_zoo``). Every fp32 output is held within 1e-4 x max|ref|
(+1e-5), every gradient within 2e-4 x max|ref| (+1e-6).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_zoo
from mlagg_unet_tpu.models import swin_unetr as JSW
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.models import swin_unetr as TSW
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported
from port_helpers import assert_close, load_jax_params, one_torch_thread  # noqa: F401
from port_helpers import random_jax_params

NAME = "swin_unetr"
# nnU-Net's 2d plan at 320x320 as the card's phase 15 takes it
CM_2D = SimpleNamespace(
    patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6,
    conv_kernel_sizes=[[3, 3]] * 7, UNet_base_num_features=32, unet_max_num_features=512,
    n_conv_per_stage_encoder=[2] * 7, n_conv_per_stage_decoder=[2] * 6)
SWIN_UNETR_PARAMS = 100_485_358     # JAX's count at this plan, 4 classes


@pytest.fixture(scope="module")
def nets():
    return port_zoo.build_nets([NAME])


def test_network_matches_jax(nets):
    """The output equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[NAME])


def test_gradients_match_jax(nets):
    """The gradients in the input and in every parameter equal
    ``jax.grad``'s."""
    port_zoo.check_grads(nets[NAME], port_zoo.UNETR_NORM_FED)


def test_param_tree_round_trip(nets):
    """JAX tree -> state_dict -> JAX tree, exactly (the transposed convs
    ``decoder*/transp_conv``, the bias tables)."""
    port_zoo.check_tree(nets[NAME])


def test_reference_pth_converts_and_loads_strict(nets):
    """A monai-named state_dict (``layers1.0``, ``blocks.0``, ``linear1``,
    the relative-position index) maps back through JAX's converter exactly;
    the port's converter loads it strict, and the network then matches
    JAX's forward."""
    port_zoo.check_pth(nets[NAME])


def _block_pair(jmod, tmod, x, seed):
    params = random_jax_params(jmod, x, seed=seed)
    return np.asarray(jmod.apply({"params": params}, x)), load_jax_params(tmod, params)


@pytest.mark.parametrize("hw,shift", [((10, 13), True), ((17, 9), True), ((4, 5), True),
                                      ((14, 14), False)])
def test_swin_block_pads_shifts_and_clamps(hw, shift):
    """A Swin block at maps the window of 7 does not divide (padded, then
    shifted by 3 on the axes longer than 7 and masked), at a map smaller
    than the window (clamped, not shifted), and unshifted, against JAX's."""
    x = port_zoo.x_of((2, *hw, 8), seed=3)
    ref, blk = _block_pair(JSW.SwinBlock(2, 7, shift=shift), TSW.SwinBlock(8, 2, 7, shift), x, 4)
    with torch.no_grad():
        assert_close(blk(torch.from_numpy(np.array(x))), ref)


def test_shift_mask_and_index_match_jax():
    """The region mask at padded maps (-100 across regions, 0 within) and the
    relative-position index equal JAX's."""
    for dims, ws, ss in (((14, 21), (7, 7), (3, 3)), ((35, 14), (7, 7), (3, 0)),
                         ((8, 10), (4, 5), (2, 2))):
        np.testing.assert_array_equal(TSW.shift_mask(dims, ws, ss),
                                      JSW._shift_mask(dims, ws, ss))
    np.testing.assert_array_equal(TSW.rel_pos_index((7, 7)), JSW._rel_pos_index((7, 7)))
    np.testing.assert_array_equal(TSW.rel_pos_index((3, 5)), JSW._rel_pos_index((3, 5)))


def test_patch_merging_v2_order_and_padding():
    """``PatchMergingV2`` on an odd map (padded) concatenates the 2x2
    neighbourhood in monai's order [h0w0, h1w0, h0w1, h1w1], as JAX's."""
    x = port_zoo.x_of((2, 7, 9, 6), seed=5)
    ref, merge = _block_pair(JSW.PatchMergingV2(), TSW.PatchMergingV2(6), x, 6)
    with torch.no_grad():
        got = merge(torch.from_numpy(np.array(x)))
    assert got.shape == (2, 4, 5, 12)
    assert_close(got, ref)


def test_swin_unetr_trainer_builds_at_full_width():
    """``nnUNetTrainerSwinUNETR_2d`` and its alias resolve with JAX's field
    values and pass the port's check; the builder makes the network at
    feature size 96 with JAX's 100,485,358 parameters from nnU-Net's 2d
    plan, and refuses a 3-D one, as JAX's does."""
    for name in ("nnUNetTrainerSwinUNETR_2d", "nnUNetTrainer_SwinUNETR_2d"):
        got = treg.get_trainer_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
        _check_ported(got)
    net = treg.get_network_builder("swin_unetr")(CM_2D, 1, 4, False, device="cpu")
    jm = jreg.get_network_builder("swin_unetr")(CM_2D, 1, 4, False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    assert sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes)) == SWIN_UNETR_PARAMS
    assert sum(p.numel() for p in net.parameters()) == SWIN_UNETR_PARAMS
    assert not net.training
    cm3 = SimpleNamespace(**{**vars(CM_2D), "patch_size": [32, 64, 64]})
    with pytest.raises(ValueError, match="2D"):
        treg.get_network_builder("swin_unetr")(cm3, 1, 4, False, device="cpu")
