"""nnMamba in the PyTorch port against the JAX package on the CPU: the
BatchNorm double convs and ResNet blocks, the Mamba layer that runs one
``MambaBlock`` on four views of the tokens (as they are, flipped over the
channels, over the sequence and both) and is shared by two blocks of each
residual layer, the SE gates and the linear-upsampling decoder; the forward
in fp32 (eval: the running statistics) and in bf16 against JAX's bf16, the
param tree both ways and the reference ``.pth`` converter (the shared
layer under both of its blocks, the running statistics into the port's
buffers); in training mode BatchNorm normalises by the batch and updates
its statistics as flax does, the shared layer's twice.

Weights come from numpy seeds into the JAX param tree, the running
statistics drawn beside them; inputs from numpy seeds (``port_zoo``). Every
fp32 output is held within 1e-4 x max|ref| (+1e-5), a bf16 output within
twice the distance bf16 moves JAX's own network.
"""
import jax
import numpy as np
import pytest
import torch

import port_zoo
from mlagg_unet_tpu.models import mamba_variants as JMV
from mlagg_unet_torch.models import mamba_variants as TMV
from mlagg_unet_torch.models.mamba_block import MambaBlock
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["nnmamba"]


@pytest.fixture(scope="module")
def nets():
    """The file's networks of both packages with one seeded param tree, and
    JAX's output on the seeded input (jitted)."""
    return port_zoo.build_nets(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(nets, name):
    """The port's output equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[name])


@pytest.mark.parametrize("name", NAMES)
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


@pytest.mark.parametrize("name", NAMES)
def test_reference_pth_converts_and_loads_strict(nets, name):
    """A reference-format state_dict (the shared layer under both of its
    blocks) maps back through JAX's converter exactly; the port's converter
    loads it strict, the running statistics into the port's buffers, and
    the network then matches JAX's forward."""
    port_zoo.check_pth(nets[name])


def test_nnmamba_train_mode_batch_norm_follows_flax(nets):
    """In training mode the port's output equals JAX's with
    ``deterministic=False`` and ``mutable=["batch_stats"]`` within 1e-4, and
    every running mean and variance after the step equals flax's within
    1e-5 (momentum 0.9, the biased batch variance; the shared Mamba
    layer's norms updated by both of its calls)."""
    n = nets["nnmamba"]
    jm = JMV.NNMamba(num_classes=3, **port_zoo.NNMAMBA)
    ref, updates = jax.jit(lambda v, x: jm.apply(v, x, deterministic=False,
                                                 mutable=["batch_stats"]))(
        n["variables"], n["x"])
    tm = TMV.NNMamba(1, 3, **port_zoo.NNMAMBA)
    tm.load_state_dict(n["tm"].state_dict(), strict=True)
    tm.train()
    with torch.no_grad():
        got = tm(port_zoo.T(np.array(n["x"])))
    port_zoo.assert_close(got, np.asarray(ref))
    stats = port_zoo.flat_params(updates["batch_stats"])
    buffers = dict(tm.named_buffers())
    assert len(stats) == len(buffers) > 0
    for k, v in stats.items():
        port_zoo.assert_close(buffers[k.replace("/", ".")], np.asarray(v), rel=1e-5, atol=1e-7)


def test_the_shared_mamba_layer_is_one_module(nets):
    """Each residual layer's Mamba layer is one module with one
    ``mamba{idx}`` scope (no copy under its blocks), called by blocks 1 and
    2, each call running its MambaBlock on the four views: 3 blocks, 24
    calls a forward."""
    tm = nets["nnmamba"]["tm"]
    assert not [k for k in tm.state_dict() if ".mamba" in k and k.startswith("layer")]
    blocks = {n: m for n, m in tm.named_modules() if isinstance(m, MambaBlock)}
    assert sorted(blocks) == ["mamba1.mamba", "mamba2.mamba", "mamba3.mamba"]
    calls = []
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: calls.append(n))
             for n, m in blocks.items()]
    with torch.no_grad():
        tm(port_zoo.T(np.array(nets["nnmamba"]["x"])))
    for h in hooks:
        h.remove()
    assert {n: calls.count(n) for n in blocks} == dict.fromkeys(blocks, 8)
