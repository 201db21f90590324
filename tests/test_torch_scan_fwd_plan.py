"""K1's launch plan (``mlagg_unet_torch.ops.selective_scan_cuda.scan_fwd_launch_plan``)
and the twin that splits the scan's forward over tiles as K1 does.

The plan is pure Python over the shape, the type, the number of SMs, the
shared memory a block may opt into and the operands' dtype, device, layout
and alignment, so it is held here on CPU tensors: the tiles per CTA, the
three grids, the CTA sizes, the shared memory, the scratch, the 16-byte
accesses and what it refuses. The kernels run only on the card
(``test_torch_port_cuda.py``).

``selective_scan_fwd_tiled_plain`` (per tile the scan from a zero entry
state, the carry of the state across tiles, the rescan of each tile from its
entry state) is held against ``selective_scan``, ``selective_scan_seq_ref``,
``selective_scan_states`` and the Pallas scan in interpret mode. Tolerance:
max|diff| <= 1e-5 * max|ref| in fp32: the carry composes the state across
tiles in another order than a walk step by step, and the decay of a tile is
exp(A * sum delta), not the product of its steps' exps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_fwd_tiled_plain,
    selective_scan_seq_ref,
    selective_scan_states,
)
from mlagg_unet_torch.ops.selective_scan_cuda import ScanFwdPlan, scan_fwd_launch_plan
from mlagg_unet_tpu.ops.selective_scan_pallas import selective_scan_pallas
from port_helpers import assert_close, one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
SMS = 132              # an H100 SXM's SM count
SMEM_OPTIN = 232_448   # an H100's shared memory per block (opt-in)
KERNELS = ("scan_fwd_group_kernel", "scan_fwd_carry_kernel", "scan_fwd_out_kernel")
TOL = 1e-5


def _inputs(l, optionals=True, seed=0, b=2, g=2, d=8, n=16):
    rs = np.random.RandomState(seed)
    dl = rs.randn(b, g, d, l) * 0.5
    args = [rs.randn(b, g, d, l), dl if optionals else np.abs(dl),
            -np.exp(rs.randn(g, d, n) * 0.3), rs.randn(b, g, n, l), rs.randn(b, g, n, l),
            rs.randn(g, d), rs.randn(g, d) * 0.1]
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    if not optionals:  # no D, no bias, softplus off with positive deltas
        t[5] = t[6] = None
    return t


@pytest.mark.parametrize("optionals", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("l,tile", [(1, 64), (63, 64), (64, 64), (65, 64), (300, 64),
                                    (65, 16), (300, 16), (64, 128), (300, 128)])
def test_tiled_twin_matches_plain_scan(l, tile, reverse, optionals):
    """L under one tile, a whole tile, a ragged last tile (65 = 64 + 1,
    300 = 4 * 64 + 44 = 18 * 16 + 12 = 2 * 128 + 44), and one tile longer
    than L; against the chunked scan and the step-by-step scan."""
    args = _inputs(l, optionals)
    got = selective_scan_fwd_tiled_plain(*args, optionals, reverse, tile)
    assert got.shape == args[0].shape and got.dtype == torch.float32
    for ref in (selective_scan(*args, optionals, reverse=reverse),
                selective_scan_seq_ref(*args, optionals, reverse)):
        assert_close(got, ref.numpy(), rel=TOL, atol=0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("l,tile", [(65, 16), (300, 64), (200, 128)])
def test_tiled_twin_states_match_plain_states(l, tile, reverse):
    """The entry state of every tile in scan order (a reverse scan's tiles
    counted from the right end), and y the same with or without them."""
    args = _inputs(l, seed=2)
    y, states = selective_scan_fwd_tiled_plain(*args, True, reverse, tile, with_states=True)
    u, dl, A, B, C, _, db = args
    ref = selective_scan_states(u, dl, A, B, C, db, True, tile, reverse)
    assert states.shape == ref.shape == (2, 2, -(-l // tile), 8, 16)
    assert_close(states, ref.numpy(), rel=TOL, atol=0)
    assert torch.equal(y, selective_scan_fwd_tiled_plain(*args, True, reverse, tile))


@pytest.mark.parametrize("reverse", [False, True])
def test_tiled_twin_matches_pallas_interpret(reverse):
    """y against the Pallas forward (interpret mode, 128-step chunks) at
    L = 300 over 64-step tiles."""
    args = _inputs(300, seed=5, b=1)
    ref = selective_scan_pallas(*(jnp.asarray(a.numpy()) for a in args), delta_softplus=True,
                                chunk_size=128, reverse=reverse)
    got = selective_scan_fwd_tiled_plain(*args, True, reverse)
    assert_close(got, np.asarray(ref), rel=TOL, atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_tiled_twin_takes_bf16_operands(reverse):
    """bf16 u, delta, B, C: fp32 arithmetic on the rounded values, as the
    chunked scan does; y in fp32."""
    args = _inputs(70, seed=7)
    args = [a.bfloat16() if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    got = selective_scan_fwd_tiled_plain(*args, True, reverse, 32)
    assert got.dtype == torch.float32
    assert_close(got, selective_scan(*args, True, reverse=reverse).numpy(), rel=TOL, atol=0)


# ---- the launch plan

@pytest.mark.parametrize("dtype,smem", [(BF16, (6_400, 0, 12_800)),
                                        (torch.float32, (8_448, 0, 16_896))])
def test_plan_at_the_serving_shape(dtype, smem):
    """Model batch 16, 2 scan groups, d = 96, L = 19040 (298 tiles): 96
    channels in one CTA of 3 warps; 2 tiles per CTA leave 4768 CTAs, 6.02
    rounds over the 792 slots (6 per SM); the carry pass one thread per
    (row, d, n)."""
    plan = scan_fwd_launch_plan(16, 2, 96, 19040, dtype, SMS, SMEM_OPTIN)
    assert plan == ScanFwdPlan(KERNELS, 2, 149, (4768, 192, 4768), (96, 256, 96), smem, 1,
                               4 * 32 * 149 * 96 * 17)


def test_plan_at_the_training_shape():
    """Batch 10: 20 rows take one tile per CTA (5960 CTAs; 2 would leave
    2980, under 6 rounds)."""
    plan = scan_fwd_launch_plan(10, 2, 96, 19040, BF16, SMS, SMEM_OPTIN)
    assert (plan.tiles_per_cta, plan.groups, plan.grids) == (1, 298, (5960, 120, 5960))
    assert plan.scratch_bytes == 4 * 20 * 298 * 96 * 17


@pytest.mark.parametrize("L", [1, 50, 63])
def test_plan_under_one_tile(L):
    """L < 64: one ragged tile per row, one group, element-by-element
    accesses (L % 8 != 0)."""
    plan = scan_fwd_launch_plan(10, 2, 96, L, BF16, SMS, SMEM_OPTIN)
    assert (plan.tiles_per_cta, plan.groups, plan.grids) == (1, 1, (20, 120, 20))
    assert plan.vec == 0


@pytest.mark.parametrize("d,threads", [(20, 32), (40, 64), (96, 96), (128, 128)])
def test_plan_at_d_under_one_chunk(d, threads):
    """Up to 128 channels: one CTA per (row, group) with a thread per
    channel, rounded up to whole warps (d = 20: 12 idle lanes)."""
    plan = scan_fwd_launch_plan(10, 2, d, 19040, BF16, SMS, SMEM_OPTIN)
    assert plan.threads == (threads, 256, threads)
    assert plan.grids[0] == plan.grids[2] == 20 * plan.groups
    assert plan.grids[1] == -(-20 * d * 16 // 256)
    assert plan.scratch_bytes == 4 * 20 * plan.groups * d * 17


@pytest.mark.parametrize("d,chunks,threads", [(130, 2, 96), (192, 2, 96), (384, 3, 128),
                                              (257, 3, 96)])
def test_plan_splits_wide_channels_evenly(d, chunks, threads):
    """Over 128 channels: the fewest chunks of at most 128, as even as can
    be (130 = 2 x 65 on 96 threads)."""
    plan = scan_fwd_launch_plan(2, 2, d, 1024, BF16, SMS, SMEM_OPTIN)
    assert plan.threads[0] == threads
    assert plan.grids[0] == 4 * plan.groups * chunks


def test_plan_launches_nothing_for_an_empty_batch():
    plan = scan_fwd_launch_plan(0, 2, 96, 19040, BF16, SMS, SMEM_OPTIN)
    assert plan.grids == (0, 0, 0) and plan.scratch_bytes == 0


SHAPES = [(16, 2, 96, 19040), (10, 2, 96, 19040), (1, 2, 40, 1000), (2, 1, 20, 65),
          (3, 2, 96, 4096), (1, 1, 8, 64), (64, 2, 192, 19040), (1980, 2, 40, 1024),
          (792, 2, 40, 1280), (2, 4, 96, 640)]


@pytest.mark.parametrize("b,g,d,L", SHAPES)
def test_plan_keeps_the_grid_and_tile_rules(b, g, d, L):
    """Passes 1 and 3: rows x groups x chunks; pass 2: a thread per
    (row, d, n) in 256-thread CTAs. Tiles per CTA: the fewest that give the
    fewest groups that keep 6 rounds of CTAs over the SMs' slots (18 warps
    each), at most 16, else 1; groups are then as even as can be."""
    plan = scan_fwd_launch_plan(b, g, d, L, BF16, SMS, SMEM_OPTIN)
    rows, tiles, k = b * g, -(-L // 64), plan.tiles_per_cta
    chunks = -(-d // 128)
    assert plan.groups == -(-tiles // k)
    assert plan.grids == (rows * plan.groups * chunks, -(-rows * d * 16 // 256),
                          rows * plan.groups * chunks)
    slots = SMS * (18 // (plan.threads[0] // 32))

    def rounds(groups):
        return rows * chunks * groups / slots

    assert 1 <= k <= min(16, tiles)
    if k > 1:
        assert rounds(plan.groups) >= 6
        assert -(-tiles // (k - 1)) > plan.groups  # no smaller k gives as few groups
    for k_ in range(k + 1, min(16, tiles) + 1):  # fewer groups leave fewer rounds
        if -(-tiles // k_) < plan.groups:
            assert rounds(-(-tiles // k_)) < 6


@pytest.mark.parametrize("b,k", [(1980, 8), (792, 4)])
def test_plan_takes_large_groups_for_many_rows(b, k):
    """The card tests' shapes (d = 40): 3960 rows of 16 tiles take 2 groups
    of 8; 1584 rows of 20 tiles take 5 groups of 4 (4 of 5 would leave too
    few CTAs)."""
    L = 1024 if k == 8 else 1280
    plan = scan_fwd_launch_plan(b, 2, 40, L, BF16, SMS, SMEM_OPTIN)
    assert (plan.tiles_per_cta, plan.groups) == (k, -(-L // 64 // k))


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plan_keeps_the_shared_memory_rules(dtype):
    """Pass 1 stages B, pass 3 B and C: raw rows of 64 steps plus 16 bytes,
    and fp32 [step][state]; six CTAs of either fit an SM many times over."""
    group, carry, out = scan_fwd_launch_plan(16, 2, 96, 19040, dtype, SMS, SMEM_OPTIN).smem_bytes
    es = torch.finfo(dtype).bits // 8
    assert carry == 0
    assert group == 16 * (64 * es + 16) + 64 * 16 * 4
    assert out == 2 * group
    assert 6 * (out + 1024) <= SMEM_OPTIN


def test_plan_scratch_is_small():
    """The fp32 group end states and delta sums at the serving shape: 31 MB,
    against the 234 MB of y the launch writes."""
    plan = scan_fwd_launch_plan(16, 2, 96, 19040, BF16, SMS, SMEM_OPTIN)
    assert plan.scratch_bytes == 4 * 32 * plan.groups * 96 * (16 + 1) < 32e6


def _operands(b=1, g=2, d=8, L=128, dtype=BF16, n=16):
    z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt)  # noqa: E731
    f = torch.float32
    return [z(b, g, d, L), z(b, g, d, L), z(g, d, n, dt=f), z(b, g, n, L), z(b, g, n, L),
            z(g, d, dt=f), z(g, d, dt=f)]


def _shifted(shape, dtype=BF16):
    """A contiguous tensor starting 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[4 // base.element_size():][:n].view(shape)


@pytest.mark.parametrize("i", [0, 1, 3, 4])
def test_plan_goes_element_by_element_for_an_unaligned_operand(i):
    ops = _operands()
    ops[i] = _shifted(tuple(ops[i].shape), ops[i].dtype)
    assert scan_fwd_launch_plan(1, 2, 8, 128, BF16, SMS, SMEM_OPTIN, ops).vec == 0


def test_plan_takes_16_bytes_at_a_time_where_it_can():
    assert scan_fwd_launch_plan(1, 2, 8, 128, BF16, SMS, SMEM_OPTIN, _operands()).vec == 1
    assert scan_fwd_launch_plan(1, 2, 8, 1000, BF16, SMS, SMEM_OPTIN).vec == 1
    assert scan_fwd_launch_plan(1, 2, 8, 1001, BF16, SMS, SMEM_OPTIN).vec == 0


def _bad(name):
    ops = _operands()
    if name == "8 states":
        ops = _operands(n=8)
    elif name == "B's shape":
        ops[3] = torch.zeros(1, 2, 16, 127, dtype=BF16)
    elif name == "C's dtype":
        ops[4] = ops[4].float()
    elif name == "mixed dtypes":
        ops[1] = ops[1].float()
    elif name == "non-contiguous u":
        ops[0] = torch.zeros(1, 2, 128, 8, dtype=BF16).transpose(2, 3)
    elif name == "non-contiguous B":
        ops[3] = torch.zeros(1, 2, 128, 16, dtype=BF16).transpose(2, 3)
    elif name == "A's shape":
        ops[2] = torch.zeros(2, 8, 15)
    elif name == "D's shape":
        ops[5] = torch.zeros(3)
    elif name == "delta_bias's shape":
        ops[6] = torch.zeros(2, 9)
    elif name == "u of another shape":
        ops = _operands(L=64)
    elif name == "u of another dtype":
        ops = _operands(dtype=torch.float32)
    else:
        raise KeyError(name)
    return ops


@pytest.mark.parametrize("name", ["8 states", "B's shape", "C's dtype", "mixed dtypes",
                                  "non-contiguous u", "non-contiguous B", "A's shape",
                                  "D's shape", "delta_bias's shape", "u of another shape",
                                  "u of another dtype"])
def test_plan_raises_on_operands_the_kernels_do_not_take(name):
    with pytest.raises(ValueError):
        scan_fwd_launch_plan(1, 2, 8, 128, BF16, SMS, SMEM_OPTIN, _bad(name))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        scan_fwd_launch_plan(1, 2, 8, 128, dtype, SMS, SMEM_OPTIN)


@pytest.mark.parametrize("b,g,d,L", [(1, 2, 8, 0), (1, 2, 0, 128), (1, 0, 8, 128),
                                     (-1, 2, 8, 128)])
def test_plan_rejects_empty_or_negative_shapes(b, g, d, L):
    with pytest.raises(ValueError):
        scan_fwd_launch_plan(b, g, d, L, BF16, SMS, SMEM_OPTIN)


def test_plan_raises_past_the_grid_limit():
    """2^32 rows of one tile each: more CTAs than a 1-D grid holds."""
    with pytest.raises(ValueError, match="grid"):
        scan_fwd_launch_plan(2 ** 30, 4, 8, 64, BF16, SMS, SMEM_OPTIN)


def test_plan_raises_where_shared_memory_is_short():
    """A device whose blocks may opt into less than pass 3's 12.8 KB."""
    with pytest.raises(ValueError, match="shared memory"):
        scan_fwd_launch_plan(16, 2, 96, 19040, BF16, SMS, 8 * 1024)
