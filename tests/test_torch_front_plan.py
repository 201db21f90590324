"""K2's launch plan (``mlagg_unet_torch.ops.mlla_fused.front_launch_plan``) and
the twin that rounds where the bf16 kernel rounds.

The plan is pure Python over M, C, the type, the number of SMs and the
operands' dtype, device, layout and alignment, so it is held here on CPU
tensors: the kernel it picks from the type, tokens per CTA, the output
columns a CTA holds, the shared memory, the grid, and what it refuses. The
kernels run only on the card (``test_torch_port_cuda.py``).
``mlla_front_bf16_operands_plain`` is held against JAX's Pallas front in
interpret mode, as ``test_torch_port_ops.py`` holds the fp32 twin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.mlla_fused import (
    FrontPlan,
    front_launch_plan,
    mlla_front_bf16_operands_plain,
    mlla_front_plain,
)
from mlagg_unet_tpu.ops.mlla_fused import mlla_block_front_fused
from port_helpers import assert_close, one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
SMS = 132              # an H100 SXM's SM count
SMEM_OPTIN = 232_448   # an H100's shared memory per block (opt-in)
SMEM_PER_SM = 233_472  # an H100's shared memory per SM (228 KB)
STAGES = [(96, 14336), (192, 3584), (384, 896), (768, 224)]  # C, tokens per tile


@pytest.mark.parametrize("C,N,plan", [
    # weights resident: all of [Wa; Wi], 2 CTAs per SM walking 3584 tiles of 64 tokens
    (96, 14336, FrontPlan("front_mma_kernel", 64, 192, 87_808, 264, 14)),
    # all of [Wa; Wi] resident (147 KB), one CTA per SM
    (192, 3584, FrontPlan("front_mma_kernel", 64, 384, 223_744, 132, 7)),
    # 6 chunks of 128 weight rows x 22 CTAs each
    (384, 896, FrontPlan("front_mma_kernel", 64, 128, 217_088, 132, 11)),
    # x resident: 56 tiles x 2 groups of 24 chunks of 32 weight rows
    (768, 224, FrontPlan("front_mma_kernel", 64, 32, 207_872, 112, 1)),
])
def test_plan_at_the_flagship_stages(C, N, plan):
    """Model batch 16: M = 16 N tokens."""
    assert front_launch_plan(16 * N, C, BF16, SMS) == plan


@pytest.mark.parametrize("C,N", STAGES)
def test_plan_keeps_the_shared_memory_and_grid_rules(C, N):
    M = 16 * N
    plan = front_launch_plan(M, C, BF16, SMS)
    per_sm = 2 if C <= 96 else 1
    assert plan.smem_bytes <= SMEM_OPTIN
    assert per_sm * (plan.smem_bytes + 1024) <= SMEM_PER_SM  # 1 KB reserved per CTA
    chunks = -(-2 * C // plan.col_chunk)
    tiles = -(-M // plan.tokens_per_cta)
    assert plan.tokens_per_cta == 64 and plan.col_chunk % 32 == 0
    assert plan.grid <= per_sm * SMS  # one wave
    if C > 384:  # x resident: tiles x groups of chunks, none empty
        groups = plan.grid // tiles
        span = -(-chunks // groups)
        assert plan.grid % tiles == 0 and (groups - 1) * span < chunks
    else:  # weights resident: chunks x CTAs walking tiles
        per_chunk = plan.grid // chunks
        assert plan.grid % chunks == 0 and per_chunk <= tiles
        assert plan.waves * per_chunk >= tiles > (plan.waves - 1) * per_chunk


@pytest.mark.parametrize("C,N,tm,grid", [(96, 14336, 128, 1792), (192, 3584, 128, 448),
                                         (384, 896, 64, 224), (768, 224, 32, 112)])
def test_plan_picks_the_scalar_kernel_for_fp32(C, N, tm, grid):
    """fp32 keeps the scalar kernel: one CTA per tile of the most tokens (8
    per warp step) whose C fp32 values and the weight slice fit 112 KB."""
    plan = front_launch_plan(16 * N, C, torch.float32, SMS)
    assert plan == FrontPlan("front_kernel", tm, 2 * C, (tm * C + 64 * 33) * 4, grid,
                             -(-grid // SMS))


@pytest.mark.parametrize("M,C,chunk,grid,waves", [
    (1, 96, 192, 1, 1), (65, 96, 192, 2, 1),        # ragged: masked, not padded
    (1000, 96, 192, 16, 1), (257, 192, 384, 5, 1),
    (5000, 224, 128, 132, 3),                       # 2 C = 448: a last chunk of 64 rows
    (33, 768, 32, 48, 1),                           # one tile, 48 groups of one chunk
    (3589, 768, 32, 114, 1),                        # 57 tiles x 2 groups
    (77, 32, 64, 2, 1), (40, 736, 32, 46, 1),       # the narrowest, a width under 768
    (100, 416, 32, 52, 1),
    (0, 384, 128, 0, 0),                            # no tokens: nothing to launch
])
def test_plan_at_small_and_ragged_token_counts(M, C, chunk, grid, waves):
    plan = front_launch_plan(M, C, BF16, SMS)
    assert plan.kernel == "front_mma_kernel"
    assert (plan.tokens_per_cta, plan.col_chunk, plan.grid, plan.waves) == (64, chunk, grid, waves)


def test_plan_gives_each_tile_a_cta_on_a_small_card():
    """Fewer SMs than tiles at C = 768: one group of all 48 chunks per tile."""
    plan = front_launch_plan(3584, 768, BF16, 4)
    assert (plan.grid, plan.waves) == (56, 14)


def _operands(C=64, M=20, dtype=BF16):
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return [z(M, C), z(C), z(C), z(C, C), z(C), z(C, C), z(C)]


def _shifted(shape, dtype=BF16):
    """A contiguous bf16 tensor starting 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[1:1 + n].view(shape)


def _bad(name):
    ops = _operands()
    if name == "mixed dtypes":
        ops[4] = ops[4].float()
    elif name == "mixed devices":
        ops[3] = torch.zeros(64, 64, dtype=BF16, device="meta")
    elif name == "non-contiguous":
        ops[0] = torch.zeros(64, 20, dtype=BF16).t()
    elif name == "misaligned x":
        ops[0] = _shifted((20, 64))
    elif name == "misaligned wi":
        ops[5] = _shifted((64, 64))
    elif name == "fp32 operands, bf16 plan":
        ops = _operands(dtype=torch.float32)
    else:
        raise KeyError(name)
    return ops


@pytest.mark.parametrize("name", ["mixed dtypes", "mixed devices", "non-contiguous",
                                  "misaligned x", "misaligned wi",
                                  "fp32 operands, bf16 plan"])
def test_plan_raises_on_operands_the_kernel_does_not_take(name):
    with pytest.raises(ValueError):
        front_launch_plan(20, 64, BF16, SMS, _bad(name))


def test_plan_takes_aligned_operands_and_unaligned_vectors():
    """Only x and the two weights are read with 16-byte copies."""
    ops = _operands()
    ops[1] = _shifted((64,))
    assert front_launch_plan(20, 64, BF16, SMS, ops).kernel == "front_mma_kernel"


def test_plan_raises_on_a_grad_request():
    ops = _operands()
    ops[3].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        front_launch_plan(20, 64, BF16, SMS, ops)
    with torch.no_grad():  # no gradient asked: planned as usual
        assert front_launch_plan(20, 64, BF16, SMS, ops).kernel == "front_mma_kernel"


@pytest.mark.parametrize("C", [40,    # not a multiple of 16
                               48,    # of 16, not of 32: a warp's quarter of a pass
                               800,   # wider than the kernel's 768
                               0])
def test_plan_raises_on_widths_the_bf16_kernel_does_not_take(C):
    with pytest.raises(ValueError):
        front_launch_plan(100, C, BF16, SMS)


def test_plan_raises_where_fp32_does_not_fit_shared_memory():
    with pytest.raises(ValueError):  # 8 tokens of C floats over 112 KB
        front_launch_plan(100, 4096, torch.float32, SMS)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        front_launch_plan(100, 96, dtype, SMS)


def _front_inputs(C, tokens, seed):
    rs = np.random.RandomState(seed)
    w = lambda: (rs.randn(C, C) / np.sqrt(C)).astype(np.float32)  # noqa: E731
    b = lambda: (0.1 * rs.randn(C)).astype(np.float32)  # noqa: E731
    x = (rs.randn(tokens, C) * 2 + 0.5).astype(np.float32)
    return [x, 1 + b(), b(), w(), b(), w(), b()]


@pytest.mark.parametrize("C,tokens", [(32, 77), (96, 50)])
def test_bf16_operands_twin_matches_pallas_interpret(C, tokens):
    """fp32 inputs: rounding y and the weights to bf16 stays within 1e-2 of
    max|ref| of JAX's all-fp32 Pallas front (two operands of each product
    rounded to 2^-9 relative; their errors over C terms add up as a random
    walk, ~5e-3 of max|ref| at these widths)."""
    x = _front_inputs(C, tokens, seed=11)
    jx = [jnp.asarray(x[0][None])] + [jnp.asarray(t) for t in x[1:]]
    for i in (3, 5):  # torch's (out, in) -> the Pallas kernel's (in, out)
        jx[i] = jx[i].T
    ref_a, ref_h = (np.asarray(r)[0] for r in mlla_block_front_fused(*jx))
    a, h = mlla_front_bf16_operands_plain(*map(torch.from_numpy, x))
    assert a.dtype == h.dtype == torch.float32
    assert_close(a, ref_a, rel=1e-2, atol=0)
    assert_close(h, ref_h, rel=1e-2, atol=0)


def test_bf16_operands_twin_against_the_bf16_twin():
    """bf16 inputs: the twin that rounds only the kernel's operands and the
    bf16 twin (which also rounds LN's output and each product's output before
    the bias and SiLU) agree within the 2e-2 that the card tests hold the
    kernel to against the latter."""
    x = [torch.from_numpy(t).bfloat16() for t in _front_inputs(64, 50, seed=12)]
    got = mlla_front_bf16_operands_plain(*x)
    ref = mlla_front_plain(*x)
    for g, r in zip(got, ref):
        assert r.dtype == BF16
        assert_close(g, r.float().numpy(), rel=2e-2, atol=0)
