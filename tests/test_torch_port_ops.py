"""Parity of the PyTorch port's layers and ops with the JAX package.

Same inputs (numpy, seeded) through the JAX function and its port
counterpart; fp32 tolerance max|diff| <= 1e-4 * max|ref| + 1e-5 unless a
test says otherwise. Pallas kernels run in interpret mode on the CPU, as
the JAX package's own tests run them. The CUDA kernels against their plain
twins are in ``test_torch_port_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as jnn

from mlagg_unet_tpu.models import layers as JL
from mlagg_unet_tpu.ops import cross_scan as jcs
from mlagg_unet_tpu.ops import local_attention as jla
from mlagg_unet_tpu.ops.flash_attention import attention_reference as j_attention
from mlagg_unet_tpu.ops.mlla_fused import mlla_block_front_fused, mlla_block_tail_fused
from mlagg_unet_tpu.ops.selective_scan import selective_scan_seq_ref as j_scan_ref
from mlagg_unet_tpu.ops.selective_scan_pallas import selective_scan_pallas
from mlagg_unet_torch.models import layers as TL
from mlagg_unet_torch.ops import cross_scan as tcs
from mlagg_unet_torch.ops import local_attention as tla
from mlagg_unet_torch.ops.flash_attention import attention_reference, flash_attention
from mlagg_unet_torch.ops.mlla_fused import mlla_front, mlla_tail
from mlagg_unet_torch.ops.selective_scan import selective_scan, selective_scan_seq_ref
from mlagg_unet_torch.ops.selective_scan_cuda import selective_scan_fwd
from port_helpers import assert_close, load_jax_params

T = torch.from_numpy
C_IN = 8

# (flax module, port module, scope prefix for the layout rules)
LAYER_CASES = {
    "layer_norm": (lambda: jnn.LayerNorm(epsilon=1e-6), lambda: TL.LayerNorm(C_IN), ""),
    "instance_norm": (lambda: JL.InstanceNorm(), lambda: TL.InstanceNorm(C_IN), ""),
    "rms_norm": (lambda: JL.RMSNorm(), lambda: TL.RMSNorm(C_IN), ""),
    "dense": (lambda: jnn.Dense(12), lambda: TL.Dense(C_IN, 12), ""),
    "pointwise_conv": (lambda: JL.PointwiseConv(12), lambda: TL.PointwiseConv(C_IN, 12), ""),
    "depthwise_conv": (lambda: JL.DepthwiseConv(3), lambda: TL.DepthwiseConv(C_IN, 3), ""),
    "dwconv2d": (lambda: JL.DWConv2d(), lambda: TL.DWConv2d(C_IN), ""),
    "conv_stride2": (lambda: jnn.Conv(12, (3, 3), strides=(2, 2), padding=1),
                     lambda: TL.Conv(C_IN, 12, 3, 2, padding=1), ""),
    "conv_depthwise_stride2": (
        lambda: jnn.Conv(C_IN, (3, 3), strides=(2, 2), padding=1, feature_group_count=C_IN),
        lambda: TL.Conv(C_IN, C_IN, 3, 2, padding=1, groups=C_IN), ""),
    "conv_transpose_k3s2": (lambda: JL.ConvTransposeTorch(12, 3, 2, 1),
                            lambda: TL.ConvTransposeTorch(C_IN, 12, 3, 2, 1), "transp_conv/"),
    "conv_transpose_k2s2": (lambda: JL.ConvTransposeTorch(12, 2, 2, 0),
                            lambda: TL.ConvTransposeTorch(C_IN, 12, 2, 2, 0), "transp_conv/"),
    "conv_glu": (lambda: JL.ConvolutionalGLU(hidden_features=24, act=jax.nn.silu),
                 lambda: TL.ConvolutionalGLU(C_IN, 24, act=F.silu), ""),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_parity(case):
    jmod, tmod, prefix = LAYER_CASES[case]
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 9, 7, C_IN) * 2 + 0.5).astype(np.float32)
    jm = jmod()
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # randomise scales and biases so nothing sits at its init value
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(p + 0.1 * rs.randn(*p.shape).astype(np.float32)), params)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_jax_params(tmod(), params, prefix)
    with torch.no_grad():
        assert_close(tm(T(x)), ref)


@pytest.mark.parametrize("hw,out", [((8, 6), (4, 3)), ((9, 7), (4, 3))])
def test_avg_pool_to_and_gelu(hw, out):
    x = np.random.RandomState(2).randn(2, *hw, 5).astype(np.float32)
    assert_close(TL.avg_pool_to(T(x), out), JL.avg_pool_to(jnp.asarray(x), out))
    assert_close(TL.gelu(T(x)), JL.gelu(jnp.asarray(x)))


def _scan_inputs(seed=0, b=2, g=2, d=8, n=16, l=70):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, g, d, l).astype(np.float32),
            (rs.randn(b, g, d, l) * 0.5).astype(np.float32),
            -np.exp(rs.randn(g, d, n).astype(np.float32) * 0.3),
            rs.randn(b, g, n, l).astype(np.float32),
            rs.randn(b, g, n, l).astype(np.float32),
            rs.randn(g, d).astype(np.float32),
            (rs.randn(g, d) * 0.1).astype(np.float32))


def _flip_l(args):
    u, dl, A, B, C, D, db = args
    return (u[..., ::-1], dl[..., ::-1], A, B[..., ::-1], C[..., ::-1], D, db)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_plain_matches_jax_step_reference(reverse):
    """Chunked plain scan (chunk 16, so L = 70 spans a ragged tail) and the
    step loop against JAX's step reference (reverse = flip, scan, flip)."""
    args = _scan_inputs()
    src = _flip_l(args) if reverse else args
    ref = np.asarray(j_scan_ref(*map(jnp.asarray, src), delta_softplus=True))
    if reverse:
        ref = ref[..., ::-1]
    targs = [T(np.ascontiguousarray(a)) for a in args]
    assert_close(selective_scan(*targs, delta_softplus=True, chunk_size=16,
                                reverse=reverse), ref)
    assert_close(selective_scan_seq_ref(*targs, delta_softplus=True,
                                        reverse=reverse), ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_pallas_interpret(reverse):
    args = _scan_inputs(seed=1, b=1, d=8, l=64)
    ref = selective_scan_pallas(*map(jnp.asarray, args), delta_softplus=True,
                                reverse=reverse)
    y = selective_scan_fwd(*map(T, args), delta_softplus=True, reverse=reverse)
    assert y.dtype == torch.float32
    assert_close(y, ref)


def test_scan_without_optionals():
    u, dl, A, B, C, _, _ = _scan_inputs(seed=3, l=40)
    ref = j_scan_ref(*map(jnp.asarray, (u, dl, A, B, C)))
    assert_close(selective_scan(*map(T, (u, dl, A, B, C)), chunk_size=16), ref)


@pytest.mark.parametrize("reverse_scales", [False, True])
def test_cross_scan_and_merge(reverse_scales):
    rs = np.random.RandomState(4)
    xs = [rs.randn(2, h, w, 6).astype(np.float32) for h, w in ((6, 4), (3, 2), (2, 1))]
    ref, ref_split = jcs.cross_scan_multiscale_2dir([jnp.asarray(x) for x in xs],
                                                    reverse_scales=reverse_scales)
    got, split = tcs.cross_scan_multiscale_2dir([T(x) for x in xs], reverse_scales)
    assert split == ref_split
    assert_close(got, ref, rel=0, atol=0)
    L = sum(split)
    yf, yr = (rs.randn(2, 2, 6, L).astype(np.float32) for _ in range(2))
    shapes = [x.shape[1:3] for x in xs]
    ref_m = jcs.cross_merge_multiscale_tokens_2dir(jnp.asarray(yf), jnp.asarray(yr),
                                                   shapes, split)
    got_m = tcs.cross_merge_multiscale_tokens_2dir(T(yf), T(yr), shapes, split)
    for g_, r_ in zip(got_m, ref_m):
        assert_close(g_, r_)


def test_local_window_attention():
    rs = np.random.RandomState(5)
    q, k = (rs.randn(2, 5, 4, 3, 6).astype(np.float32) for _ in range(2))
    v = rs.randn(2, 5, 4, 3, 10).astype(np.float32)
    ref = jla.local_window_attention_logits(jnp.asarray(q), jnp.asarray(k), 3)
    got = tla.local_window_attention_logits(T(q), T(k), 3)
    assert_close(got, ref)
    attn = jax.nn.softmax(ref, axis=-1)
    assert_close(tla.local_window_attention_apply(T(np.array(attn)), T(v), 3),
                 jla.local_window_attention_apply(attn, jnp.asarray(v), 3))


def test_attention_reference_dk_ne_dv():
    rs = np.random.RandomState(6)
    q = rs.randn(2, 3, 37, 8).astype(np.float32)
    k = rs.randn(2, 3, 11, 8).astype(np.float32)
    v = rs.randn(2, 3, 11, 16).astype(np.float32)
    ref = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3)
    assert_close(attention_reference(T(q), T(k), T(v), 0.3), ref)
    assert_close(flash_attention(T(q), T(k), T(v), 0.3), ref)  # CPU -> plain twin


def _mlla_weights(C, rs):
    Hd = 2 * C
    w = lambda *s: (rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)  # noqa: E731
    b = lambda n: (0.1 * rs.randn(n)).astype(np.float32)  # noqa: E731
    return dict(lw=1 + b(C), lb=b(C), wa=w(C, C), ba=b(C), wi=w(C, C), bi=b(C),
                wo=w(C, C), bo=b(C), w1=w(C, Hd), b1=b(Hd), w2=w(Hd, C), b2=b(C))


def test_mlla_front_matches_pallas_interpret():
    rs = np.random.RandomState(7)
    C = 32
    p = _mlla_weights(C, rs)
    x = rs.randn(2, 77, C).astype(np.float32)  # 154 tokens: not a block multiple
    ref_a, ref_h = mlla_block_front_fused(*map(jnp.asarray, (
        x, p["lw"], p["lb"], p["wa"], p["ba"], p["wi"], p["bi"])))
    a, h = mlla_front(T(x), T(p["lw"]), T(p["lb"]), T(p["wa"].T.copy()), T(p["ba"]),
                      T(p["wi"].T.copy()), T(p["bi"]))
    assert_close(a, ref_a)
    assert_close(h, ref_h)


def test_mlla_tail_matches_pallas_interpret():
    rs = np.random.RandomState(8)
    C = 32
    p = _mlla_weights(C, rs)
    h, a, s = (rs.randn(2, 77, C).astype(np.float32) for _ in range(3))
    ref = mlla_block_tail_fused(*map(jnp.asarray, (
        h, a, s, p["wo"], p["bo"], p["lw"], p["lb"], p["w1"], p["b1"], p["w2"], p["b2"])))
    got = mlla_tail(T(h), T(a), T(s), T(p["wo"].T.copy()), T(p["bo"]), T(p["lw"]),
                    T(p["lb"]), T(p["w1"].T.copy()), T(p["b1"]), T(p["w2"].T.copy()),
                    T(p["b2"]))
    assert_close(got, ref)
