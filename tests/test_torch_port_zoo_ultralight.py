"""UltraLight VM-UNet in the PyTorch port against the JAX package on the
CPU: the PVM layers (one ``MambaBlock(C / 4)`` on each channel quarter,
d_inner 12 to 32), GroupNorm(4), the SC attention bridge (a dilated 7x7
conv shared by the five skips, a 1-D conv over the channels, a Dense gate
per skip), the align-corners bilinear decoder; the forward in fp32 and in
bf16 against JAX's bf16, the param tree both ways and the reference
``.pth`` converter.

Weights come from numpy seeds into the JAX param tree (``skip_scale`` near
its init of 1); inputs from numpy seeds (``port_zoo``). Every fp32 output is
held within 1e-4 x max|ref| (+1e-5), a bf16 output within twice the
distance bf16 moves JAX's own network.
"""
import numpy as np
import pytest
import torch

import port_zoo
from mlagg_unet_torch.models.mamba_block import MambaBlock
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["ultralight_vmunet"]


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


def test_pvm_layers_share_one_mamba_over_the_quarters(nets):
    """Each PVM layer holds one ``MambaBlock`` of a quarter of its width and
    calls it on the four quarters: 6 blocks, 24 calls a forward, at d_inner
    12 to 32 (the published widths)."""
    tm = nets["ultralight_vmunet"]["tm"]
    blocks = {n: m for n, m in tm.named_modules() if isinstance(m, MambaBlock)}
    calls = []
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: calls.append((n, i[0].shape[-1])))
             for n, m in blocks.items()]
    with torch.no_grad():
        tm(port_zoo.T(np.array(nets["ultralight_vmunet"]["x"])))
    for h in hooks:
        h.remove()
    assert len(blocks) == 6 and len(calls) == 24
    assert {n: calls.count((n, blocks[n].d_inner // 2)) for n in blocks} == dict.fromkeys(blocks, 4)
    assert sorted(b.d_inner for b in blocks.values()) == [12, 16, 16, 24, 24, 32]
