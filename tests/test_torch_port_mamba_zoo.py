"""U-Mamba Bot and Enc in 2-D in the PyTorch port against the JAX package
on the CPU: the forward in fp32 and in bf16 against JAX's bf16, the param
tree both ways and the reference ``.pth`` converter, and the channel-token
rule that places the Mamba layers. The rest of the Mamba zoo's first family
is in ``test_torch_port_zoo_*.py``; ``port_zoo`` holds the networks and the
checks.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds (``port_zoo``). Every fp32 output is held within 1e-4 x max|ref|
(+1e-5), a bf16 output within twice the distance bf16 moves JAX's own
network.
"""
import pytest

import port_zoo
from mlagg_unet_torch.models import umamba as TUM
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

NAMES = ["umamba_bot_2d", "umamba_enc_2d"]


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


def test_umamba_channel_token_stages():
    """The channel-token rule and the alternating 2-D placement: Enc 2-D
    scans after stages 1 and 3, stage 3 over its 16 channels (d_model = its
    4x4 map); Enc 3-D after every stage, stages 2 and 3 over channels
    (d_model 32 and 4); Bot only at the bottleneck, over tokens; the SS3D
    modes put 12-direction VSS blocks at d_state 1 in those places instead
    (Enc after every stage, the plain MLP at ratio 2, then 4; Bot ConvGLU)."""
    CM_2D, CM_3D = port_zoo.CM_2D, port_zoo.CM_3D
    enc2 = TUM.umamba_from_plans(CM_2D, 1, 3, True, "enc")
    assert enc2.mamba_stages == [1, 3]
    assert enc2.enc_mamba3.channel_token and enc2.enc_mamba3.mamba.d_inner == 32
    assert not enc2.enc_mamba1.channel_token and enc2.enc_mamba1.mamba.d_inner == 16
    enc3 = TUM.umamba_from_plans(CM_3D, 1, 3, True, "enc")
    assert enc3.mamba_stages == [0, 1, 2, 3]
    assert [getattr(enc3, f"enc_mamba{s}").channel_token for s in range(4)] == [
        False, False, True, True]
    assert enc3.enc_mamba2.mamba.d_inner == 64 and enc3.enc_mamba3.mamba.d_inner == 8
    bot = TUM.umamba_from_plans(CM_2D, 1, 3, False, "bot")
    assert bot.mamba_stages == [] and not bot.bot_mamba.channel_token
    enc_ss3d = TUM.umamba_from_plans(CM_3D, 1, 3, True, "enc_ss3d")
    assert enc_ss3d.mamba_stages == [] and not hasattr(enc_ss3d, "bot_vss0")
    for s in range(4):
        vss = getattr(enc_ss3d, f"enc_vss{s}")
        assert vss.self_attention.d_state == 1 and vss.self_attention.no_z
        assert vss.mlp.linear1.out_features == (2 if s < 2 else 4) * [8, 16, 32, 32][s]
    bot_ss3d = TUM.umamba_from_plans(CM_3D, 1, 3, True, "bot_ss3d")
    assert bot_ss3d.bot_vss0.self_attention.d_state == 1 and hasattr(bot_ss3d.bot_vss0.mlp, "dwconv")
    assert not hasattr(bot_ss3d, "enc_vss0")
