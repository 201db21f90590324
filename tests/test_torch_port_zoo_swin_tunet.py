"""Swin-TUNet in the PyTorch port against the JAX package on the CPU: Swin
stages with the swin-v1 ``PatchMergingSwin`` between them, VM-UNet's
``PatchExpand2D`` decoder with the skips added, MedNeXt's 1x1 head. The
forward in fp32 at narrow widths on 64x64 with the window of 7 (stages at
16 and 8 pad and shift), every gradient against ``jax.grad``, the param
tree both ways, the traps: the merge's neighbourhood order [h0w0, h0w1,
h1w0, h1w1] (not ``PatchMergingV2``'s) and its and the patch norm's
LayerNorm at flax's eps 1e-6 (torch's default is 1e-5); and
``nnUNetTrainer_SwinTUNet`` built at full width from nnU-Net's 2d plan with
JAX's parameter count. JAX has no reference ``.pth`` converter for it, and
the port has none.

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
from mlagg_unet_torch.models.layers import LayerNorm
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training import torch_import as tti
from mlagg_unet_torch.training.trainer import _check_ported
from port_helpers import assert_close, load_jax_params, one_torch_thread  # noqa: F401
from port_helpers import random_jax_params

NAME = "swin_tunet"
CM_2D = SimpleNamespace(
    patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6,
    conv_kernel_sizes=[[3, 3]] * 7, UNet_base_num_features=32, unet_max_num_features=512,
    n_conv_per_stage_encoder=[2] * 7, n_conv_per_stage_decoder=[2] * 6)
SWIN_TUNET_PARAMS = 6_106_915     # JAX's count, 4 classes


@pytest.fixture(scope="module")
def nets():
    return port_zoo.build_nets([NAME])


def test_network_matches_jax(nets):
    """The output equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[NAME])


def test_gradients_match_jax(nets):
    """The gradients in the input and in every parameter equal
    ``jax.grad``'s (no conv bias here is followed by a norm that cancels
    it)."""
    port_zoo.check_grads(nets[NAME], None)


def test_param_tree_round_trip(nets):
    """JAX tree -> state_dict -> JAX tree, exactly."""
    port_zoo.check_tree(nets[NAME])


def test_merge_orders_differ_and_each_matches_jax():
    """On one input and one set of weights, ``PatchMergingSwin`` (order
    [h0w0, h0w1, h1w0, h1w1], padded at odd sizes) and ``PatchMergingV2``
    ([h0w0, h1w0, h0w1, h1w1]) each equal their JAX module and not each
    other."""
    x = port_zoo.x_of((2, 7, 9, 6), seed=8)
    params = random_jax_params(JSW.PatchMergingSwin(), x, seed=9)
    outs = []
    for jm, tm in ((JSW.PatchMergingSwin(), TSW.PatchMergingSwin(6)),
                   (JSW.PatchMergingV2(), TSW.PatchMergingV2(6))):
        ref = np.asarray(jm.apply({"params": params}, x))
        with torch.no_grad():
            got = load_jax_params(tm, params)(torch.from_numpy(np.array(x)))
        assert_close(got, ref)
        outs.append(got)
    assert outs[0].shape == (2, 4, 5, 12)
    assert (outs[0] - outs[1]).abs().max() > 0.1


def test_layer_norms_take_flax_eps():
    """The merge's and the patch embed's LayerNorms take flax's eps 1e-6:
    on an input of variance ~1e-6 the merge equals JAX's, and a LayerNorm
    at torch's 1e-5 would not."""
    x = 1e-3 * port_zoo.x_of((1, 4, 4, 6), seed=10)
    params = random_jax_params(JSW.PatchMergingSwin(), x, seed=11)
    ref = np.asarray(JSW.PatchMergingSwin().apply({"params": params}, x))
    merge = load_jax_params(TSW.PatchMergingSwin(6), params)
    with torch.no_grad():
        xt = torch.from_numpy(np.array(x))
        assert_close(merge(xt), ref)
        assert merge.norm.eps == 1e-6 and isinstance(merge.norm, LayerNorm)
        merge.norm.eps = 1e-5
        assert np.abs(merge(xt).numpy() - ref).max() > 1e-2 * np.abs(ref).max()
    net = treg.get_network_builder(NAME)((64, 64), 1, 3, False, device="cpu")
    assert net.patch_norm.eps == 1e-6 and net.merge0.norm.eps == 1e-6


def test_swin_tunet_trainer_builds_at_full_width():
    """``nnUNetTrainer_SwinTUNet`` resolves with JAX's field values and
    passes the port's check; the builder makes the network at embed 48 with
    JAX's 6,106,915 parameters from nnU-Net's 2d plan and refuses a 3-D
    one; JAX has no reference converter for it, and the port raises."""
    name = "nnUNetTrainer_SwinTUNet"
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    net = treg.get_network_builder(NAME)(CM_2D, 1, 4, False, device="cpu")
    jm = jreg.get_network_builder(NAME)(CM_2D, 1, 4, False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    assert sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes)) == SWIN_TUNET_PARAMS
    assert sum(p.numel() for p in net.parameters()) == SWIN_TUNET_PARAMS
    with torch.no_grad():
        assert net(torch.zeros(1, 64, 64, 1)).shape == (1, 64, 64, 4)
    cm3 = SimpleNamespace(**{**vars(CM_2D), "patch_size": [32, 64, 64]})
    with pytest.raises(ValueError, match="2D"):
        treg.get_network_builder(NAME)(cm3, 1, 4, False, device="cpu")
    with pytest.raises(NotImplementedError, match="no converter"):
        tti.reference_state_dict_to_port(NAME, {})
