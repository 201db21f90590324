"""MSVM-UNet in the PyTorch port against the JAX package on the CPU: the
VSSM encoder's SS2D at d_state 1 in ``v05_noz`` (the scan in the input
dtype), the LKPE decoder with BatchNorm's running statistics, the forward in
fp32 and in bf16 against JAX's bf16, the param tree both ways and the
reference ``.pth`` converter (the running statistics into the port's
buffers); in training mode BatchNorm normalises by the batch and updates
its statistics as flax does.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds (``port_zoo``). Every fp32 output is held within 1e-4 x max|ref|
(+1e-5), a bf16 output within twice the distance bf16 moves JAX's own
network.
"""
import pytest
import jax
import numpy as np
import torch

import port_zoo
from mlagg_unet_tpu.models import msvm_unet as JMS
from mlagg_unet_torch.models import msvm_unet as TMS
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["msvm_unet"]


@pytest.fixture(scope="module")
def nets():
    """The file's networks of both packages with one seeded param tree, and
    JAX's output on the seeded input (jitted)."""
    return port_zoo.build_nets(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(nets, name):
    """Every output (each deep-supervision scale) of the port's network
    equals JAX's within 1e-4."""
    port_zoo.check_forward(nets[name])


@pytest.mark.parametrize("name", NAMES)
def test_bf16_network_follows_jax(nets, name):
    """In bf16 (parameters and input cast, as both predictors do) the port
    computes JAX's function: every output answers in JAX's dtype (fp32: the
    Mamba blocks' fp32 output promotes the layers after them), the port's
    bf16 output sits from its fp32 output within twice the distance JAX's
    sits from JAX's fp32 output, and from JAX's bf16 output within twice
    that distance too. Two bf16 implementations of these networks differ by
    about what bf16 itself moves them (measured: 0.5-1.2x JAX's own gap, which is 1.5e-2 to 5.2e-1 here), so the distance is held to
    the network's own gap and not to a fixed tolerance."""
    port_zoo.check_bf16(nets[name])


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_round_trip(nets, name):
    """JAX tree -> state_dict -> JAX tree, exactly, for every parameter."""
    port_zoo.check_tree(nets[name])


@pytest.mark.parametrize("name", NAMES)
def test_reference_pth_converts_and_loads_strict(nets, name):
    """A reference-format state_dict of the same weights maps back through
    JAX's converter exactly; the port's converter (``CONVERTERS_BY_NETWORK``
    composed with ``jax_params_to_state_dict``) loads it strict, and the
    network then matches JAX's forward."""
    port_zoo.check_pth(nets[name])


def test_msvm_train_mode_batch_norm_follows_flax(nets):
    """In training mode (drop path 0 in both) the port's output equals JAX's
    with ``deterministic=False`` and ``mutable=["batch_stats"]`` within
    1e-4, and every running mean and variance after the step equals flax's
    (momentum 0.99, the biased batch variance)."""
    n = nets["msvm_unet"]
    no_drop = dict(drop_path_rate=0.0, decoder_drop_path_rate=0.0)
    jm = JMS.MSVMUNet(num_classes=3, **port_zoo.MSVM, **no_drop)
    ref, updates = jax.jit(lambda v, x: jm.apply(v, x, deterministic=False,
                                                 mutable=["batch_stats"]))(
        n["variables"], n["x"])
    tm = TMS.MSVMUNet(1, 3, **port_zoo.MSVM, **no_drop)
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
