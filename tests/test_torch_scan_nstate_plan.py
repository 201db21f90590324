"""K1's and K5's launch plans at state counts other than 16 (pure Python, on
the CPU): the kernels' N and passes at n = 1, 16 and 64, their shared
memory and CTAs, and every plan at the scan shapes the SS3D U-Mambas,
VM-UNet-3D and MSVM-UNet give the kernels at the card script's full widths
(``chip_smoke.py --only ss3d``): shared memory per CTA within the H100's
227 KB, CTAs of whole warps, grids under 2^31 CTAs.
"""
import pytest
import torch

from mlagg_unet_torch.ops.selective_scan_cuda import (
    _bwd_smem,
    _fwd_ctas_per_sm,
    _fwd_smem,
    scan_bwd_launch_plan,
    scan_fwd_launch_plan,
)

SMS = 132              # an H100 SXM's SM count
SMEM_OPTIN = 232_448   # an H100's shared memory per block (opt-in), 227 KB
BF16, F32 = torch.bfloat16, torch.float32


def _umamba_ss3d(b):
    """U-Mamba Enc SS3D on the 3-D plan (patch 64x128x128, features
    32-320): after each of its 6 stages, 12 paths at d_inner = 2 x width
    (Bot: the last only)."""
    maps = [(64, 128, 128), (32, 64, 64), (16, 32, 32), (8, 16, 16), (4, 8, 8), (4, 4, 4)]
    return [(b, 12, 2 * w, d * h * x, 1) for (d, h, x), w in zip(maps, (32, 64, 128, 256, 320, 320))]


def _vmunet3d(b):
    """VM-UNet-3D on the same patch: stages of 96-768 at 32^3 ... 8x4x4."""
    maps = [(32, 32, 32), (16, 16, 16), (8, 8, 8), (8, 4, 4)]
    return [(b, 12, 2 * w, d * h * x, 16) for (d, h, x), w in zip(maps, (96, 192, 384, 768))]


def _msvm(b):
    """MSVM-UNet at 320x320: SS2D at d_state 1, ratio 1, two groups per
    direction pass, the encoder's four maps (the decoder's three repeat)."""
    return [(b, 2, w, s * s, 1) for s, w in ((80, 96), (40, 192), (20, 384), (10, 768))]


# training batches (2 in 3-D, 4 in 2-D) and served model batches (tile
# batch x mirrors: up to 8 x 8 in 3-D, 16 x 4 in 2-D)
SHAPES = sorted({s for b in (2, 64) for s in _umamba_ss3d(b) + _vmunet3d(b)}
                | {s for b in (4, 64) for s in _msvm(b)})


def _check(plan, b, g, d, L, n):
    assert (plan.n_state, plan.passes) == ((1, 1) if n == 1 else (16, -(-n // 16)))
    assert max(plan.smem_bytes) <= SMEM_OPTIN
    assert all(t >= 32 and t % 32 == 0 for t in plan.threads)
    assert 0 < max(plan.grids) < 2 ** 31
    assert plan.groups == -(-(-(-L // 64)) // plan.tiles_per_cta)


@pytest.mark.parametrize("b,g,d,L,n", SHAPES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fwd_plan_at_the_families_shapes(b, g, d, L, n, dtype):
    """K1 at every scan of the three families' forwards."""
    plan = scan_fwd_launch_plan(b, g, d, L, dtype, SMS, SMEM_OPTIN, n_state=n)
    _check(plan, b, g, d, L, n)
    assert plan.grids[1] == -(-b * g * d * plan.n_state // 256)
    assert plan.scratch_bytes == 4 * b * g * plan.groups * d * (plan.n_state + 1)


@pytest.mark.parametrize("b,g,d,L,n", SHAPES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_bwd_plan_at_the_families_shapes(b, g, d, L, n, dtype):
    """K5 at every scan of the three families' backwards."""
    plan = scan_bwd_launch_plan(b, g, d, L, dtype, SMS, SMEM_OPTIN, n_state=n)
    _check(plan, b, g, d, L, n)
    assert plan.threads == ((128, 256, 128) if n == 16 else (32, 256, 32))
    assert plan.scratch_bytes == 4 * b * g * plan.groups * d * (3 * plan.n_state + 2)


@pytest.mark.parametrize("n,N,passes", [(1, 1, 1), (16, 16, 1), (64, 16, 4)])
def test_plans_take_the_kernels_n_and_passes(n, N, passes):
    """n = 1 and 16 are instances; 64 runs as four passes of 16, each
    planned as n = 16 (the same smem, grids and scratch)."""
    for fn in (scan_fwd_launch_plan, scan_bwd_launch_plan):
        plan = fn(2, 12, 64, 32768, F32, SMS, SMEM_OPTIN, n_state=n)
        assert (plan.n_state, plan.passes) == (N, passes)
        assert plan._replace(passes=1) == fn(2, 12, 64, 32768, F32, SMS, SMEM_OPTIN,
                                             n_state=N)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_shared_memory_at_one_state(dtype):
    """At n = 1 K1 stages one B (and C) row a tile: ~0.5 and ~1 KB; K5's
    CTA is one warp of 32 channels, its phase 3 ~40-53 KB (the next chunk's
    raw delta dominates), four CTAs an SM."""
    es = torch.finfo(dtype).bits // 8
    assert _fwd_smem(es, 1) == (64 * es + 16 + 64 * 4, 0, 2 * (64 * es + 16) + 2 * 64 * 4)
    group, _, tile = _bwd_smem(es, 1)
    assert group == (32 * 65 + 32 * 68 + 64) * 4
    assert tile == 2 * 32 * 64 * es + 32 * (72 if es == 2 else 68) * es + (
        32 * 68 + 2 * 32 * 65 + 2 * 64 + 2 * 8 * 32 + 64 * 3) * 4
    assert 4 * (tile + 1024) <= 233_472


def test_fwd_ctas_per_sm_follow_shared_memory():
    """Resident CTAs of passes 1 and 3: the warps' 18 at most, fewer where
    pass 3's shared memory allows fewer (fp32 at n = 16: 13 of one warp)."""
    assert _fwd_ctas_per_sm(1, _fwd_smem(4, 16)[2]) == 13
    assert _fwd_ctas_per_sm(1, _fwd_smem(4, 1)[2]) == 18
    assert _fwd_ctas_per_sm(3, _fwd_smem(2, 16)[2]) == 6
