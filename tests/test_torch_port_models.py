"""Parity of the PyTorch port's modules and of the whole tiny flagship with
the JAX package (fp32, tolerance max|diff| <= 1e-4 * max|ref| + 1e-5).

Weights are drawn from a numpy seed into the JAX param tree (shapes from
``jax.eval_shape(init)``, see ``port_helpers.random_jax_params``), then go
``jax_params_to_state_dict`` -> ``load_state_dict(strict=True)``; inputs
come from numpy seeds. The JAX side runs jitted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import mamba_skip as JMS
from mlagg_unet_tpu.models import mednext as JMN
from mlagg_unet_tpu.models import mlla as JMLLA
from mlagg_unet_tpu.models import unetr_blocks as JUB
from mlagg_unet_tpu.models.mlla_uper import MLLAUper as JaxMLLAUper
from mlagg_unet_torch.models import mamba_skip as TMS
from mlagg_unet_torch.models import mednext as TMN
from mlagg_unet_torch.models import mlla as TMLLA
from mlagg_unet_torch.models import unetr_blocks as TUB
from mlagg_unet_torch.models.layers import init_parameters
from mlagg_unet_torch.models.mlla_uper import MLLAUper, build_flagship
from mlagg_unet_torch.weights import state_dict_to_jax_params
from port_helpers import assert_close, flat_params, load_jax_params, random_jax_params

T = torch.from_numpy
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))


def _run_pair(jmod, tmod, inputs, seed=0, prefix=""):
    params = random_jax_params(jmod, *inputs, seed=seed)
    ref = jax.jit(jmod.apply)({"params": params}, *inputs)
    tm = load_jax_params(tmod, params, prefix)
    with torch.no_grad():
        got = tm(*[[T(np.array(a)) for a in x] if isinstance(x, list) else T(np.array(x))
                   for x in inputs])
    return got, ref


def _maps(seed, shapes, c):
    rs = np.random.RandomState(seed)
    return [jnp.asarray(rs.randn(2, h, w, c).astype(np.float32)) for h, w in shapes]


def test_ss2d_skip():
    xs = _maps(0, [(8, 6), (4, 3)], 8)
    got, ref = _run_pair(JMS.SS2DSkip(d_model=8, stage_num=2), TMS.SS2DSkip(8, stage_num=2), [xs])
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


def test_vss_conv_block():
    rs = np.random.RandomState(1)
    xs = [jnp.asarray(rs.randn(2, h, w, c).astype(np.float32))
          for (h, w), c in (((8, 6), 16), ((4, 3), 24))]
    got, ref = _run_pair(JMS.VSSConvBlock(feature_dims=[16, 24], hidden_dim=8),
                         TMS.VSSConvBlock([16, 24], 8), [xs])
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


@pytest.mark.parametrize("local", [True, False])
def test_aggregated_attention(local):
    x = _maps(2, [(12, 8)], 32)[0]
    got, ref = _run_pair(JMLLA.AggregatedAttention(2, local=local, sr_ratio=4),
                         TMLLA.AggregatedAttention(32, 2, local=local, sr_ratio=4), [x])
    assert_close(got, ref)


def test_mlla_block():
    x = _maps(3, [(12, 8)], 32)[0]
    got, ref = _run_pair(JMLLA.MLLABlock(num_heads=4, mlp_ratio=2.0, sr_ratio=4),
                         TMLLA.MLLABlock(32, 4, 2.0, 4), [x])
    assert_close(got, ref)


BLOCK_CASES = {
    "patch_embed": (lambda: JMLLA.PatchEmbed(2, 16), lambda: TMLLA.PatchEmbed(1, 2, 16), 1, ""),
    "mednext_block": (lambda: JMN.MedNeXtBlock(8, exp_r=2, kernel_size=3),
                      lambda: TMN.MedNeXtBlock(8, 8, 2, 3), 8, ""),
    "mednext_block_grn": (lambda: JMN.MedNeXtBlock(8, exp_r=2, kernel_size=3, grn=True),
                          lambda: TMN.MedNeXtBlock(8, 8, 2, 3, grn=True), 8, ""),
    "mednext_down": (lambda: JMN.MedNeXtDownBlock(16, exp_r=2),
                     lambda: TMN.MedNeXtDownBlock(8, 16, 2), 8, ""),
    "patch_expand": (lambda: JMN.PatchExpand(4), lambda: TMN.PatchExpand(8, 4), 8, "up_0/"),
    "unetr_basic": (lambda: JUB.UnetrBasicBlock(6), lambda: TUB.UnetrBasicBlock(1, 6), 1, ""),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_blocks(case):
    jmod, tmod, cin, prefix = BLOCK_CASES[case]
    x = _maps(4, [(10, 6)], cin)[0]
    # prefix: the transposed-conv layout rule keys on the flagship's scope names
    got, ref = _run_pair(jmod(), tmod(), [x], prefix=prefix)
    assert_close(got, ref)


def test_unetr_up_block():
    x, skip = _maps(5, [(5, 4)], 16)[0], _maps(6, [(10, 8)], 8)[0]
    jm = JUB.UnetrUpBlock(8, kernel_size=3, upsample_kernel_size=2)
    got, ref = _run_pair(jm, TUB.UnetrUpBlock(16, 8, 8), [x, skip], prefix="decoder0/")
    assert_close(got, ref)


@pytest.fixture(scope="module")
def tiny_flagship():
    """JAX tiny flagship params and the port model carrying them."""
    jm = JaxMLLAUper(out_channels=3, **TINY)
    params = random_jax_params(jm, jnp.zeros((1, 64, 64, 1)))
    tm = load_jax_params(MLLAUper(1, 3, **TINY), params)
    return jm, params, tm


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_mlla_uper_all_outputs(tiny_flagship, hw):
    """All 5 deep-supervision outputs; 96x64 guards the H/W transposes."""
    jm, params, tm = tiny_flagship
    x = np.random.RandomState(7).randn(2, *hw, 1).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    assert len(got) == len(ref) == 5
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_)


def test_state_dict_round_trip(tiny_flagship):
    """jax_params_to_state_dict -> load -> state_dict() gives back every JAX
    leaf exactly."""
    _, params, tm = tiny_flagship
    flat = flat_params(params)
    back = state_dict_to_jax_params(tm.state_dict(), flat.keys())
    assert len(tm.state_dict()) == len(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_init_distributions():
    """The port's own seeded init: S4D A_log, D = 1, the dt bias inside the
    softplus-inverse range, the same seed giving the same weights."""
    m1 = build_flagship(3, device="cpu", seed=3, **TINY)
    m2 = init_parameters(MLLAUper(1, 3, **TINY), torch.Generator().manual_seed(3))
    ss = m1.mambaskip.block0.self_attention
    np.testing.assert_allclose(ss.A_logs[0, 0].detach().numpy(),
                               np.log(np.arange(1, 17, dtype=np.float32)))
    assert torch.all(ss.Ds == 1)
    dt = torch.nn.functional.softplus(ss.dt_projs_bias)
    assert dt.min() >= 1e-4 - 1e-7 and dt.max() <= 0.1 + 1e-6
    assert not m1.training
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
