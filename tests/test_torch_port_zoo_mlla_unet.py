"""MLLA-UNet (linear attention with RoPE) in the PyTorch port against the
JAX package on the CPU: the conv-BatchNorm stem, MLLA blocks with
``LinearAttention`` (ELU + 1, RoPE on q and k, the normaliser from the k
without RoPE, LePE), conv patch merging and expanding (a depthwise,
bias-free transposed conv), ``concat_back`` Denses, the 16x expand. The
forward in fp32 at narrow widths on 64x64 in eval mode and in training
mode (BatchNorm's batch statistics and running averages; drop path 0),
every gradient against ``jax.grad``, the param tree both ways, the
reference ``.pth`` converter (its RoPE buffer dropped), the RoPE table and
rotation in fp32 and bf16, and ``nnUNetTrainer_MLLA_UNet`` built at full
width from nnU-Net's 2d plan with JAX's parameter count.

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
from mlagg_unet_tpu.models import mlla_unet as JML
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch.models import mlla_unet as TML
from mlagg_unet_torch.models.layers import DropPath
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import _check_ported
from mlagg_unet_torch.weights import state_dict_to_jax_params
from port_helpers import assert_close, flat_params, load_jax_params, one_torch_thread  # noqa: F401
from port_helpers import random_jax_params

NAME = "mlla_unet"
CM_2D = SimpleNamespace(
    patch_size=[320, 320], pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 6,
    conv_kernel_sizes=[[3, 3]] * 7, UNet_base_num_features=32, unet_max_num_features=512,
    n_conv_per_stage_encoder=[2] * 7, n_conv_per_stage_decoder=[2] * 6)
MLLA_UNET_PARAMS = 28_504_416     # JAX's count, 4 classes


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


def test_param_tree_round_trip(nets):
    """JAX tree -> state_dict -> JAX tree, exactly (the depthwise
    transposed ``deconv`` kernels among them)."""
    port_zoo.check_tree(nets[NAME])


def test_reference_pth_converts_and_loads_strict(nets):
    """A reference-named state_dict (``layers.0.blocks.0``,
    ``layers_up.1.upsample.conv.1``, ``concat_back_dim``, the RoPE buffer,
    the BatchNorms' running statistics) maps back through JAX's converter
    exactly; the port's converter loads it strict, and the network then
    matches JAX's forward."""
    port_zoo.check_pth(nets[NAME])


def test_training_mode_follows_jax(nets):
    """In training mode (drop path 0 in both) the output and every updated
    running mean and variance equal JAX's."""
    n = nets[NAME]
    jm = JML.MLLAUNet(num_classes=3, **port_zoo.MLLA_UNET, drop_path_rate=0.0)
    ref, upd = jm.apply(n["variables"], n["x"], deterministic=False, mutable=["batch_stats"])
    tm = copy.deepcopy(n["tm"]).train()
    for m in tm.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    with torch.no_grad():
        assert_close(tm(torch.from_numpy(np.array(n["x"]))), np.asarray(ref))
    want = flat_params(upd["batch_stats"])
    got = state_dict_to_jax_params(dict(tm.named_buffers()), want)
    for k in want:
        assert_close(got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    """The cos / sin table (y angles first, then x) equals JAX's; the
    rotation of interleaved pairs runs in fp32 and returns the input's
    dtype, equal to JAX's."""
    rot = TML.rope_rotations(5, 7, 16)
    np.testing.assert_array_equal(rot, JML.rope_rotations(5, 7, 16))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = port_zoo.x_of((2, 5, 7, 16), seed=15)
    ref = np.asarray(JML.apply_rope(x.astype(jdt), jnp.asarray(rot)), np.float32)
    got = TML.apply_rope(torch.from_numpy(np.array(x)).to(tdt), torch.from_numpy(rot))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=1e-6)


def test_linear_attention_matches_jax():
    """``LinearAttention`` on a 6x5 map at 2 heads equals JAX's."""
    x = port_zoo.x_of((2, 6, 5, 8), seed=16)
    jm = JML.LinearAttention(2)
    params = random_jax_params(jm, x, seed=17)
    ref = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = load_jax_params(TML.LinearAttention(8, 2), params)(torch.from_numpy(np.array(x)))
    assert_close(got, ref)


def test_mlla_unet_trainer_builds_at_full_width():
    """``nnUNetTrainer_MLLA_UNet`` resolves with JAX's field values (the
    flagship's recipe at lr 1e-4, no deep supervision) and passes the
    port's check; the builder makes the network at embed 64 with JAX's
    28,504,416 parameters from nnU-Net's 2d plan, and refuses a 3-D one."""
    name = "nnUNetTrainer_MLLA_UNet"
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)
    net = treg.get_network_builder(NAME)(CM_2D, 1, 4, False, device="cpu")
    jm = jreg.get_network_builder(NAME)(CM_2D, 1, 4, False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    assert sum(leaf.size for leaf in jax.tree_util.tree_leaves(shapes)) == MLLA_UNET_PARAMS
    assert sum(p.numel() for p in net.parameters()) == MLLA_UNET_PARAMS
    cm3 = SimpleNamespace(**{**vars(CM_2D), "patch_size": [32, 64, 64]})
    with pytest.raises(ValueError, match="2D"):
        treg.get_network_builder(NAME)(cm3, 1, 4, False, device="cpu")
