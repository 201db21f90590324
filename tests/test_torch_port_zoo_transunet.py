"""TransUNet (R50-ViT-B/16) in the PyTorch port against the JAX package on
the CPU: the ResNetV2 of weight-standardised convs (its max-pool's
off-by-one: block 1 at 15x15 on a 64x64 input, padded to 16 for the skip),
the ViT on the 1/16 grid with its learned position embedding, the cup
decoder (BatchNorm, align-corners bilinear). The forward in fp32 at narrow
widths on 64x64 in eval mode and in training mode (BatchNorm's batch
statistics and running averages), every gradient against ``jax.grad``, the
reference ``.pth`` converter, ``StdConv`` (fp32 standardisation, cast to a
bf16 input), the bilinear upsampling at an axis of 1, and
``nnUNetTrainerTransUNet`` built at full width from nnU-Net's 2d plan with
JAX's parameter count.

Weights come from numpy seeds into the JAX param tree (BatchNorm's running
statistics drawn beside them); inputs from numpy seeds (``port_zoo``).
Every fp32 output is held within 1e-4 x max|ref| (+1e-5), every gradient
within 2e-4 x max|ref| (+1e-6).
"""
import copy
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_zoo
from mlagg_unet_tpu.models import transunet as JTU
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.models import layers as TL
from mlagg_unet_torch.models import transunet as TTU
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported
from mlagg_unet_torch.weights import state_dict_to_jax_params
from port_helpers import assert_close, flat_params, load_jax_params, one_torch_thread  # noqa: F401
from port_helpers import random_jax_params

NAME = "transunet"
CM_2D = SimpleNamespace(
    patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6,
    conv_kernel_sizes=[[3, 3]] * 7, UNet_base_num_features=32, unet_max_num_features=512,
    n_conv_per_stage_encoder=[2] * 7, n_conv_per_stage_decoder=[2] * 6)
TRANSUNET_PARAMS = 105_426_756     # JAX's count at 320x320, 4 classes


@pytest.fixture(scope="module")
def nets():
    return port_zoo.build_nets([NAME])


def test_network_matches_jax(nets):
    """The output equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[NAME])


def test_gradients_match_jax(nets):
    """The gradients in the input and in every parameter equal
    ``jax.grad``'s (eval mode; no conv bias here is cancelled by a norm)."""
    port_zoo.check_grads(nets[NAME], None)


def test_reference_pth_converts_and_loads_strict(nets):
    """A reference-named state_dict (``transformer.embeddings.hybrid_model.
    body.block1.unit1``, the position embedding, ``decoder.blocks.0.conv1.0``
    and its BatchNorm's running statistics) maps back through JAX's
    converter exactly; the port's converter loads it strict, and the network
    then matches JAX's forward."""
    port_zoo.check_pth(nets[NAME])


def test_training_mode_follows_jax(nets):
    """In training mode the output (BatchNorm on the batch's statistics) and
    every updated running mean and variance equal JAX's
    (``deterministic=False``, ``mutable=["batch_stats"]``)."""
    n = nets[NAME]
    ref, upd = n["jm"].apply(n["variables"], n["x"], deterministic=False,
                             mutable=["batch_stats"])
    tm = copy.deepcopy(n["tm"]).train()
    with torch.no_grad():
        assert_close(tm(torch.from_numpy(np.array(n["x"]))), np.asarray(ref))
    want = flat_params(upd["batch_stats"])
    got = state_dict_to_jax_params(dict(tm.named_buffers()), want)
    for k in want:
        assert_close(got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_std_conv_matches_jax(dtype):
    """``StdConv`` (3x3, stride 2, padding 1): the kernel standardised per
    output channel in fp32, cast to the input's dtype, as JAX's; in bf16 the
    output is bf16 and within bf16's rounding of JAX's."""
    x = port_zoo.x_of((2, 9, 11, 5), seed=12)
    jm, tm = JTU.StdConv(8, (3, 3), 2, padding=1), TTU.StdConv(5, 8, 3, 2, padding=1)
    params = random_jax_params(jm, x, seed=13)
    params = jax.tree_util.tree_map(lambda v: v * 3.0 + 0.5, params)   # off zero mean
    load_jax_params(tm, params)
    jdt = getattr(jnp, dtype)
    ref = jm.apply({"params": jax.tree_util.tree_map(lambda v: v.astype(jdt), params)},
                   x.astype(jdt))
    with torch.no_grad():
        got = tm.to(getattr(torch, dtype))(torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    ref32 = np.asarray(ref, np.float32)
    if dtype == "float32":
        assert_close(got, ref32)
    else:
        assert np.abs(got.float().numpy() - ref32).max() <= 2 ** -7 * np.abs(ref32).max()


def test_bilinear_is_jax_upsample_align_corners():
    """``layers.bilinear_ac`` is JAX's ``upsample_bilinear_x2_align_corners``,
    an axis of extent 1 (repeated) included."""
    for shape in ((2, 5, 7, 3), (1, 1, 4, 2), (1, 3, 1, 2), (1, 1, 1, 4)):
        x = port_zoo.x_of(shape, seed=14)
        ref = np.asarray(JTU.upsample_bilinear_x2_align_corners(x))
        assert_close(TL.bilinear_ac(torch.from_numpy(np.array(x))), ref)


def test_transunet_trainer_builds_at_full_width():
    """``nnUNetTrainerTransUNet`` resolves with JAX's field values and
    passes the port's check; the builder makes R50-ViT-B/16 for the plan's
    320x320 patch with JAX's 105,426,756 parameters (a 20x20 grid), refuses
    a tile of another size (the position embedding is the patch's) and a
    3-D plan."""
    name = "nnUNetTrainerTransUNet"
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    net = treg.get_network_builder(NAME)(CM_2D, 1, 4, False, device="cpu")
    jm = jreg.get_network_builder(NAME)(CM_2D, 1, 4, False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 320, 320, 1)))["params"]
    assert sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes)) == TRANSUNET_PARAMS
    assert sum(p.numel() for p in net.parameters()) == TRANSUNET_PARAMS
    assert net.position_embeddings.shape == (1, 400, 768)
    with pytest.raises(ValueError, match="320x320"):
        net(torch.zeros(1, 128, 128, 1))
    cm3 = SimpleNamespace(**{**vars(CM_2D), "patch_size": [32, 64, 64]})
    with pytest.raises(ValueError, match="2D"):
        treg.get_network_builder(NAME)(cm3, 1, 4, False, device="cpu")
