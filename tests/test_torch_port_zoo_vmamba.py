"""VM-UNet and Mamba-UNet in the PyTorch port against the JAX package on
the CPU: the forward in fp32 and in bf16 against JAX's bf16, the param tree
both ways, the reference ``.pth`` converters, and the transfer of a
reference checkpoint's weights for fine-tuning.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds (``port_zoo``). Every fp32 output is held within 1e-4 x max|ref|
(+1e-5), a bf16 output within twice the distance bf16 moves JAX's own
network.
"""
import pytest
import torch

import port_zoo
from mlagg_unet_torch.models import vmamba as TVM
from mlagg_unet_torch.training import torch_import as tti
from port_helpers import flat_params, one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["vmunet", "mamba_unet"]


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


def test_pretrained_pth_transfer_and_raises(nets, tmp_path):
    """``load_pretrained_torch_weights`` of a reference VM-UNet ``.pth``
    transfers every tensor into a fresh port network; a network without a
    converter (Swin-TUNet's, as in JAX) and a checkpoint of another family
    raise, saying which."""
    n = nets["vmunet"]
    path = str(tmp_path / "vmunet.pth")
    torch.save({"network_weights": port_zoo.reference_state_dict(flat_params(n["params"]), "vmunet")},
               path)
    fresh = TVM.VMUNet(1, 3, dims=port_zoo.VMUNET_DIMS)
    n_tr, n_tot = tti.load_pretrained_torch_weights(fresh, path, network_key="vmunet")
    assert n_tr == n_tot == len(fresh.state_dict())
    for k, v in n["tm"].state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(NotImplementedError, match="no converter"):
        tti.load_pretrained_torch_weights(fresh, path, network_key="swin_tunet")
    with pytest.raises(NotImplementedError, match="another family"):
        tti.load_pretrained_torch_weights(nets["mamba_unet"]["tm"], path,
                                          network_key="umamba_bot")
