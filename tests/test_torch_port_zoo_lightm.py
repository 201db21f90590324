"""LightM-UNet in the PyTorch port against the JAX package on the CPU, in
2-D and in 3-D: the depthwise-separable convs, the Mamba layers whose one
LayerNorm runs twice around the ``skip_scale`` residual, GroupNorm(8), the
max-pool and nearest-upsampling skeleton; the forward in fp32 and in bf16
against JAX's bf16, the param tree both ways and the reference ``.pth``
converter.

Weights come from numpy seeds into the JAX param tree (``skip_scale`` near
its init of 1); inputs from numpy seeds (``port_zoo``). Every fp32 output is
held within 1e-4 x max|ref| (+1e-5), a bf16 output within twice the
distance bf16 moves JAX's own network.
"""
import pytest

import port_zoo
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["lightm_unet", "lightm_unet_3d"]


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
    """A reference-format state_dict of the same weights maps back through
    JAX's converter exactly; the port's converter loads it strict, and the
    network then matches JAX's forward."""
    port_zoo.check_pth(nets[name])
