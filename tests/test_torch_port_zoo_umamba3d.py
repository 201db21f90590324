"""U-Mamba Bot and Enc in 3-D in the PyTorch port against the JAX package on
the CPU: the forward in fp32 (Enc against JAX in fp64: four Mamba layers
and norms over a few voxels leave JAX's own fp32 output 1.9e-4 x max from
its fp64 one, the port's 3.8e-5) and in bf16 against JAX's bf16, the param
tree both ways and the reference ``.pth`` converter.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds (``port_zoo``). Every fp32 output is held within 1e-4 x max|ref|
(+1e-5), a bf16 output within twice the distance bf16 moves JAX's own
network.
"""
import pytest

import port_zoo
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["umamba_bot_3d", "umamba_enc_3d"]


@pytest.fixture(scope="module")
def nets():
    """The file's networks of both packages with one seeded param tree, and
    JAX's output on the seeded input (jitted)."""
    return port_zoo.build_nets(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_network_matches_jax(nets, name):
    """Every output (each deep-supervision scale) of the port's network
    equals JAX's within 1e-4 (U-Mamba Enc 3-D: JAX's in fp64)."""
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
