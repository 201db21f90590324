"""K3's launch plan (``mlagg_unet_torch.ops.mlla_fused.tail_launch_plan``) and
the twin that rounds where the bf16 kernel rounds.

The plan is pure Python over M, C, Hd, the type, the number of SMs and the
operands' dtype, device, layout and alignment, so it is held here on CPU
tensors: the kernel it picks from the type, tokens per CTA, the hidden
chunk, the shared memory, the grid, and what it refuses. The kernels run
only on the card (``test_torch_port_cuda.py``).
``mlla_tail_bf16_operands_plain`` is held against JAX's Pallas tail in
interpret mode, as ``test_torch_port_ops.py`` holds the fp32 twin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.mlla_fused import (
    TailPlan,
    mlla_tail_bf16_operands_plain,
    mlla_tail_plain,
    tail_launch_plan,
)
from mlagg_unet_tpu.ops.mlla_fused import mlla_block_tail_fused
from port_helpers import assert_close, one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
SMS = 132              # an H100 SXM's SM count
SMEM_OPTIN = 232_448   # an H100's shared memory per block (opt-in)
STAGES = [(96, 14336), (192, 3584), (384, 896), (768, 224)]  # C, tokens per tile


@pytest.mark.parametrize("C,N,plan", [
    (96, 14336, TailPlan("tail_mma_kernel", 64, 128, 73_728, 3584, 14)),
    (192, 3584, TailPlan("tail_mma_kernel", 64, 128, 106_496, 896, 4)),
    (384, 896, TailPlan("tail_mma_kernel", 64, 128, 161_792, 224, 2)),
    # the last stage: 112 CTAs, one wave on 112 of the 132 SMs
    (768, 224, TailPlan("tail_mma_kernel", 32, 256, 190_464, 112, 1)),
])
def test_plan_at_the_flagship_stages(C, N, plan):
    """Model batch 16: M = 16 N tokens, Hd = 2 C."""
    assert tail_launch_plan(16 * N, C, 2 * C, BF16, SMS) == plan


@pytest.mark.parametrize("C,N", STAGES)
def test_plan_keeps_the_shared_memory_and_token_tile_rules(C, N):
    plan = tail_launch_plan(16 * N, C, 2 * C, BF16, SMS)
    assert plan.smem_bytes <= SMEM_OPTIN
    assert plan.tokens_per_cta % 16 == 0 and plan.tokens_per_cta >= 32
    assert plan.grid * plan.tokens_per_cta >= 16 * N > (plan.grid - 1) * plan.tokens_per_cta
    assert (2 * C) % 32 == 0 and plan.hidden_chunk % 32 == 0


@pytest.mark.parametrize("C,N,tm,grid", [(96, 14336, 64, 3584), (192, 3584, 32, 1792),
                                         (384, 896, 16, 896), (768, 224, 8, 448)])
def test_plan_picks_the_scalar_kernel_for_fp32(C, N, tm, grid):
    """fp32 keeps the scalar kernel: the most tokens (8 per warp step) whose
    2 C + Hd fp32 values and the weight slice fit 112 KB."""
    plan = tail_launch_plan(16 * N, C, 2 * C, torch.float32, SMS)
    assert plan == TailPlan("tail_kernel", tm, 2 * C, (tm * 4 * C + 64 * 33) * 4, grid,
                            -(-grid // SMS))


@pytest.mark.parametrize("M,C,tm,grid", [
    (1, 96, 64, 1), (65, 96, 64, 2), (1000, 96, 64, 16),  # ragged: masked, not padded
    (33, 768, 32, 2), (3589, 768, 32, 113), (257, 192, 64, 5),
    (77, 32, 64, 2), (40, 736, 32, 2),                    # the narrowest, a width under 768
    (0, 384, 64, 0),                                      # no tokens: nothing to launch
])
def test_plan_at_small_and_ragged_token_counts(M, C, tm, grid):
    plan = tail_launch_plan(M, C, 2 * C, BF16, SMS)
    assert (plan.kernel, plan.tokens_per_cta, plan.grid) == ("tail_mma_kernel", tm, grid)


@pytest.mark.parametrize("C,Hd,chunk", [(96, 192, 128), (96, 96, 128), (768, 1536, 256),
                                        (768, 64, 256), (384, 3072, 128)])
def test_plan_chunks_the_hidden_dim(C, Hd, chunk):
    """The chunk is fixed per width; Hd need not be a multiple of it (the
    last chunk is narrower)."""
    assert tail_launch_plan(500, C, Hd, BF16, SMS).hidden_chunk == chunk


def _operands(C=64, M=20, Hd=None, dtype=BF16):
    Hd = Hd or 2 * C
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return [z(M, C), z(M, C), z(M, C), z(C, C), z(C), z(C), z(C), z(Hd, C), z(Hd),
            z(C, Hd), z(C)]


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
        ops[0] = torch.zeros(20, 64, dtype=BF16, device="meta")
    elif name == "non-contiguous":
        ops[1] = torch.zeros(64, 20, dtype=BF16).t()
    elif name == "misaligned h":
        ops[0] = _shifted((20, 64))
    elif name == "misaligned w2":
        ops[9] = _shifted((64, 128))
    elif name == "fp32 operands, bf16 plan":
        ops = _operands(dtype=torch.float32)
    else:
        raise KeyError(name)
    return ops


@pytest.mark.parametrize("name", ["mixed dtypes", "mixed devices", "non-contiguous",
                                  "misaligned h", "misaligned w2",
                                  "fp32 operands, bf16 plan"])
def test_plan_raises_on_operands_the_kernel_does_not_take(name):
    with pytest.raises(ValueError):
        tail_launch_plan(20, 64, 128, BF16, SMS, _bad(name))


def test_plan_raises_on_a_grad_request():
    ops = _operands()
    ops[3].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tail_launch_plan(20, 64, 128, BF16, SMS, ops)
    with torch.no_grad():  # no gradient asked: planned as usual
        assert tail_launch_plan(20, 64, 128, BF16, SMS, ops).kernel == "tail_mma_kernel"


@pytest.mark.parametrize("C,Hd", [(40, 80),     # not a multiple of 16
                                  (48, 96),     # of 16, not of 32: a warp's quarter of C
                                  (800, 1600),  # wider than the kernel's 768
                                  (96, 200),    # Hd not a multiple of 32
                                  (0, 64)])
def test_plan_raises_on_widths_the_bf16_kernel_does_not_take(C, Hd):
    with pytest.raises(ValueError):
        tail_launch_plan(100, C, Hd, BF16, SMS)


def test_plan_raises_where_fp32_does_not_fit_shared_memory():
    with pytest.raises(ValueError):  # 8 tokens of 2 C + Hd floats over 112 KB
        tail_launch_plan(100, 1024, 2048, torch.float32, SMS)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        tail_launch_plan(100, 96, 192, dtype, SMS)


def _tail_inputs(C, tokens, seed):
    rs = np.random.RandomState(seed)
    Hd = 2 * C
    w = lambda o, i: (rs.randn(o, i) / np.sqrt(i)).astype(np.float32)  # noqa: E731
    b = lambda n: (0.1 * rs.randn(n)).astype(np.float32)  # noqa: E731
    h, a, s = (rs.randn(tokens, C).astype(np.float32) for _ in range(3))
    return [h, a, s, w(C, C), b(C), 1 + b(C), b(C), w(Hd, C), b(Hd), w(C, Hd), b(C)]


def test_bf16_operands_twin_matches_pallas_interpret():
    """fp32 inputs at C = 32, 77 tokens: rounding the three A operands and
    the weights to bf16 stays within 1e-2 of max|ref| of JAX's all-fp32
    Pallas tail (about 3 bf16 roundings in a row of products)."""
    x = _tail_inputs(32, 77, seed=9)
    jx = [jnp.asarray(t[None]) for t in x[:3]] + [jnp.asarray(t) for t in x[3:]]
    for i in (3, 7, 9):  # torch's (out, in) -> the Pallas kernel's (in, out)
        jx[i] = jx[i].T
    ref = np.asarray(mlla_block_tail_fused(*jx))[0]
    got = mlla_tail_bf16_operands_plain(*map(torch.from_numpy, x))
    assert got.dtype == torch.float32
    assert_close(got, ref, rel=1e-2, atol=0)


def test_bf16_operands_twin_against_the_bf16_twin():
    """bf16 inputs: the twin that rounds only the kernel's operands and the
    bf16 twin (which also rounds x2 and every product's output) agree within
    the 2e-2 that the card tests hold the kernel to against the latter."""
    x = [torch.from_numpy(t).bfloat16() for t in _tail_inputs(64, 50, seed=10)]
    got = mlla_tail_bf16_operands_plain(*x)
    ref = mlla_tail_plain(*x)
    assert ref.dtype == BF16
    assert_close(got, ref.float().numpy(), rel=2e-2, atol=0)
