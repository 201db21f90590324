"""K5's launch plan (``mlagg_unet_torch.ops.selective_scan_cuda.scan_bwd_launch_plan``)
and the twin that splits the scan's backward over tiles as K5 does.

The plan is pure Python over the shape, the type, the number of SMs, the
shared memory a block may opt into and the operands' dtype, device, layout
and alignment, so it is held here on CPU tensors: the tiles per CTA, the
three grids, the shared memory, the scratch, the 16-byte staging and what
it refuses. The kernels run only on the card (``test_torch_port_cuda.py``).

``selective_scan_bwd_tiled_plain`` (phase 1 per tile with zero carry-in,
the carry across tiles, phase 3 per tile from its carry) is held against
``selective_scan_bwd_plain``, autograd through the step-by-step scan and
``jax.grad`` of the Pallas scan in interpret mode. Tolerance: max|diff| <=
2e-4 * max|ref| per gradient (``PARITY.md:70``): the carry composes the
adjoint across tiles in another order than a walk step by step, and the sums
over n, d and L run in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.selective_scan import (
    selective_scan_bwd_plain,
    selective_scan_bwd_tiled_plain,
    selective_scan_seq_ref,
)
from mlagg_unet_torch.ops.selective_scan_cuda import ScanBwdPlan, scan_bwd_launch_plan
from mlagg_unet_tpu.ops.selective_scan_pallas import selective_scan_pallas
from port_helpers import assert_close, one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
SMS = 132              # an H100 SXM's SM count
SMEM_OPTIN = 232_448   # an H100's shared memory per block (opt-in)
SMEM_PER_SM = 233_472  # an H100's shared memory per SM (228 KB)
KERNELS = ("scan_bwd_group_kernel", "scan_bwd_carry_kernel", "scan_bwd_tile_kernel")
TOL = 2e-4


def _inputs(l, optionals=True, seed=0, b=2, g=2, d=8, n=16):
    rs = np.random.RandomState(seed)
    dl = rs.randn(b, g, d, l) * 0.5
    args = [rs.randn(b, g, d, l), dl if optionals else np.abs(dl),
            -np.exp(rs.randn(g, d, n) * 0.3), rs.randn(b, g, n, l), rs.randn(b, g, n, l),
            rs.randn(g, d), rs.randn(g, d) * 0.1]
    gy = rs.randn(b, g, d, l)
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in args + [gy]]
    if not optionals:  # no D, no bias, softplus off with positive deltas
        t[5] = t[6] = None
    return t[:7], t[7]


def _close_all(got, ref):
    for g_, r_ in zip(got, ref):
        if r_ is None:
            assert g_ is None
            continue
        assert g_.shape == r_.shape and g_.dtype == r_.dtype
        assert_close(g_, r_.detach().numpy(), rel=TOL, atol=0)


@pytest.mark.parametrize("optionals", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("l,tile", [(1, 64), (63, 64), (64, 64), (65, 64), (300, 64),
                                    (65, 16), (300, 16), (64, 128)])
def test_tiled_twin_matches_plain_backward(l, tile, reverse, optionals):
    """L under one tile, a whole tile, a ragged last tile (65 = 64 + 1,
    300 = 4 * 64 + 44 = 18 * 16 + 12), and one tile longer than L."""
    args, gy = _inputs(l, optionals)
    got = selective_scan_bwd_tiled_plain(*args, optionals, reverse, gy, tile=tile)
    _close_all(got, selective_scan_bwd_plain(*args, optionals, reverse, gy))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("l,tile", [(65, 16), (300, 64)])
def test_tiled_twin_matches_autograd_of_step_scan(l, tile, reverse):
    args, gy = _inputs(l, seed=3)
    leaves = [a.clone().requires_grad_() for a in args]
    y = selective_scan_seq_ref(*leaves, delta_softplus=True, reverse=reverse)
    ref = torch.autograd.grad(y, leaves, gy)
    _close_all(selective_scan_bwd_tiled_plain(*args, True, reverse, gy, tile=tile), ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_tiled_twin_matches_pallas_interpret(reverse):
    """All seven gradients against jax.grad of the Pallas scan's custom_vjp
    (interpret mode, 128-step chunks) at L = 300 over 64-step tiles."""
    args, gy = _inputs(300, seed=5, b=1)
    np_args = [a.numpy() for a in args]
    gy_np = gy.numpy()

    def loss(*a):
        y = selective_scan_pallas(*a, delta_softplus=True, chunk_size=128, reverse=reverse)
        return (y * gy_np).sum()

    ref = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, np_args))
    got = selective_scan_bwd_tiled_plain(*args, True, reverse, gy)
    for g_, r_ in zip(got, ref):
        assert_close(g_, r_, rel=TOL, atol=0)


def test_tiled_twin_keeps_the_input_dtypes():
    """bf16 operands: the gradients come back in the operands' dtypes, like
    the plain backward's."""
    args, gy = _inputs(70, seed=7)
    args = [a.bfloat16() if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    got = selective_scan_bwd_tiled_plain(*args, True, False, gy, tile=32)
    ref = selective_scan_bwd_plain(*args, True, False, gy)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == r_.dtype
        assert_close(g_.float(), r_.float().numpy(), rel=1e-2, atol=0)


# ---- the launch plan

@pytest.mark.parametrize("dtype,smem", [(BF16, 71_168), (torch.float32, 75_264)])
def test_plan_at_the_training_shape(dtype, smem):
    """Batch 10, 2 scan groups, d = 96, L = 19040 (298 tiles): 2 tiles per
    CTA leave 2980 phase 3 CTAs, 7.5 rounds over the 396 slots (3 per SM);
    phase 1 has one CTA per chunk of 32 channels too."""
    plan = scan_bwd_launch_plan(10, 2, 96, 19040, dtype, SMS, SMEM_OPTIN)
    assert plan == ScanBwdPlan(KERNELS, 2, 149, (8940, 120, 2980), (128, 256, 128),
                               (21_120, 0, smem), 1, 4 * 20 * 149 * 96 * 50)


def test_plan_at_the_serving_rows():
    """Model batch 16: 32 rows take 4 tiles per CTA (75 groups, 2400 CTAs)."""
    plan = scan_bwd_launch_plan(16, 2, 96, 19040, BF16, SMS, SMEM_OPTIN)
    assert (plan.tiles_per_cta, plan.groups, plan.grids) == (4, 75, (7200, 192, 2400))


@pytest.mark.parametrize("L", [1, 50, 63])
def test_plan_under_one_tile(L):
    """L < 64: one ragged tile per row, one group, element-by-element
    staging (L % 8 != 0) except where L % 8 == 0."""
    plan = scan_bwd_launch_plan(10, 2, 96, L, BF16, SMS, SMEM_OPTIN)
    assert (plan.tiles_per_cta, plan.groups, plan.grids) == (1, 1, (60, 120, 20))
    assert plan.vec == 0


def test_plan_at_d_20():
    """d = 20: one chunk of 32 channels (12 empty), so phase 1 has as many
    CTAs as phase 3; phase 2 one thread per (row, d, n)."""
    plan = scan_bwd_launch_plan(10, 2, 20, 19040, BF16, SMS, SMEM_OPTIN)
    assert plan.grids == (2980, 25, 2980)
    assert plan.scratch_bytes == 4 * 20 * 149 * 20 * 50


SHAPES = [(10, 2, 96, 19040), (16, 2, 96, 19040), (1, 2, 40, 1000), (2, 1, 20, 65),
          (3, 2, 96, 4096), (1, 1, 8, 64), (64, 2, 192, 19040), (2, 4, 96, 640)]


@pytest.mark.parametrize("b,g,d,L", SHAPES)
def test_plan_keeps_the_grid_and_tile_rules(b, g, d, L):
    """Phase 1: rows x groups x chunks of 32 channels; phase 2: a thread per
    (row, d, n) in 256-thread CTAs; phase 3: rows x groups. Tiles per CTA:
    the most up to 8 that keep 6 rounds of phase 3 CTAs over the SMs' 3
    slots each, else 1."""
    plan = scan_bwd_launch_plan(b, g, d, L, BF16, SMS, SMEM_OPTIN)
    rows, tiles, k = b * g, -(-L // 64), plan.tiles_per_cta
    assert plan.groups == -(-tiles // k)
    assert plan.grids == (rows * plan.groups * -(-d // 32), -(-rows * d * 16 // 256),
                          rows * plan.groups)

    def waves(k_):
        return rows * -(-tiles // k_) / (3 * SMS)

    assert 1 <= k <= min(8, tiles)
    if k > 1:
        assert waves(k) >= 6
    if k < min(8, tiles):
        assert waves(k + 1) < 6


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plan_keeps_the_shared_memory_rules(dtype):
    """Three phase 3 CTAs and six phase 1 CTAs fit an SM (1 KB reserved per
    CTA), and each fits the opt-in limit."""
    group, carry, tile = scan_bwd_launch_plan(10, 2, 96, 19040, dtype, SMS, SMEM_OPTIN).smem_bytes
    assert carry == 0 and max(group, tile) <= SMEM_OPTIN
    assert 3 * (tile + 1024) <= SMEM_PER_SM
    assert 6 * (group + 1024) <= SMEM_PER_SM


def test_plan_scratch_is_small():
    """The fp32 carry, product and dA / dD / dbias partials at the training
    shape: under 60 MB, against the 0.585 GB of dB / dC partials per launch
    that the kernel before kept."""
    plan = scan_bwd_launch_plan(10, 2, 96, 19040, BF16, SMS, SMEM_OPTIN)
    assert plan.scratch_bytes == 4 * 20 * plan.groups * 96 * (3 * 16 + 2) < 60e6


def _operands(b=1, g=2, d=8, L=128, dtype=BF16, n=16):
    z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt)  # noqa: E731
    f = torch.float32
    return [z(b, g, d, L), z(b, g, d, L), z(g, d, n, dt=f), z(b, g, n, L), z(b, g, n, L),
            z(g, d, dt=f), z(g, d, dt=f), z(b, g, d, L, dt=f), z(b, g, -(-L // 64), d, 16, dt=f)]


def _shifted(shape, dtype=BF16):
    """A contiguous tensor starting 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[4 // base.element_size():][:n].view(shape)


@pytest.mark.parametrize("i", [0, 1, 3, 4, 7])
def test_plan_stages_element_by_element_for_an_unaligned_operand(i):
    ops = _operands()
    ops[i] = _shifted(tuple(ops[i].shape), ops[i].dtype)
    assert scan_bwd_launch_plan(1, 2, 8, 128, BF16, SMS, SMEM_OPTIN, ops).vec == 0


def test_plan_stages_16_bytes_at_a_time_where_it_can():
    assert scan_bwd_launch_plan(1, 2, 8, 128, BF16, SMS, SMEM_OPTIN, _operands()).vec == 1
    assert scan_bwd_launch_plan(1, 2, 8, 1000, BF16, SMS, SMEM_OPTIN).vec == 1
    assert scan_bwd_launch_plan(1, 2, 8, 1001, BF16, SMS, SMEM_OPTIN).vec == 0


def _bad(name):
    ops = _operands()
    if name == "65 states":  # over MAX_STATE
        ops = _operands(n=65)
        ops[8] = torch.zeros(1, 2, 2, 8, 65)
    elif name == "B's shape":
        ops[3] = torch.zeros(1, 2, 16, 127, dtype=BF16)
    elif name == "mixed dtypes":
        ops[1] = ops[1].float()
    elif name == "non-contiguous u":
        ops[0] = torch.zeros(1, 2, 128, 8, dtype=BF16).transpose(2, 3)
    elif name == "states of another length":
        ops[8] = torch.zeros(1, 2, 3, 8, 16)
    elif name == "bf16 states":
        ops[8] = ops[8].bfloat16()
    elif name == "no gy":
        ops[7] = None
    elif name == "bf16 gy":
        ops[7] = ops[7].bfloat16()
    elif name == "gy's shape":
        ops[7] = torch.zeros(1, 2, 8, 127)
    elif name == "D's shape":
        ops[5] = torch.zeros(3)
    elif name == "u of another shape":
        ops = _operands(L=64)
    else:
        raise KeyError(name)
    return ops


@pytest.mark.parametrize("name", ["65 states", "B's shape", "mixed dtypes", "non-contiguous u",
                                  "states of another length", "bf16 states", "no gy",
                                  "bf16 gy", "gy's shape", "D's shape", "u of another shape"])
def test_plan_raises_on_operands_the_kernels_do_not_take(name):
    with pytest.raises(ValueError):
        scan_bwd_launch_plan(1, 2, 8, 128, BF16, SMS, SMEM_OPTIN, _bad(name))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_plan_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        scan_bwd_launch_plan(1, 2, 8, 128, dtype, SMS, SMEM_OPTIN)


@pytest.mark.parametrize("b,g,d,L", [(1, 2, 8, 0), (1, 2, 0, 128), (1, 0, 8, 128),
                                     (-1, 2, 8, 128)])
def test_plan_rejects_empty_or_negative_shapes(b, g, d, L):
    with pytest.raises(ValueError):
        scan_bwd_launch_plan(b, g, d, L, BF16, SMS, SMEM_OPTIN)


def test_plan_raises_past_the_grid_limit():
    """2^32 rows of one tile each: more phase 3 CTAs than a 1-D grid holds."""
    with pytest.raises(ValueError, match="grid"):
        scan_bwd_launch_plan(2 ** 30, 4, 8, 64, BF16, SMS, SMEM_OPTIN)


def test_plan_raises_where_shared_memory_is_short():
    """A device whose blocks may opt into less than phase 3's ~70 KB."""
    with pytest.raises(ValueError, match="shared memory"):
        scan_bwd_launch_plan(10, 2, 96, 19040, BF16, SMS, 64 * 1024)
