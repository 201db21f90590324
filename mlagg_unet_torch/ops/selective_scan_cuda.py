"""Selective scan on the GPU: kernels K1 (forward, ``csrc/selective_scan_fwd.cu``)
and K5 (backward, ``csrc/selective_scan_bwd.cu``).

K1 replaces the Pallas forward kernels ``_fwd_kernel_v2`` / ``_fwd_kernel``
and K5 the backward kernels ``_bwd_kernel_v2`` / ``_bwd_kernel`` of
``mlagg_unet_tpu/ops/selective_scan_pallas.py``; ``_SelectiveScan`` ties them
together as the custom_vjp there does (``:1092-1117``): the forward of a
training step runs K1 with its tile-entry states, and the backward runs K5
on them. Both are three kernels launched by one call, parallel over groups
of consecutive 64-step tiles. K1 (``scan_fwd_launch_plan``): per group the
scan from a zero entry state (``scan_fwd_group_kernel``), the carry of the
state across groups in scan order (``scan_fwd_carry_kernel``), then y and
the tile-entry states from each group's true entry state
(``scan_fwd_out_kernel``). K5 (``scan_bwd_launch_plan``): per group the
adjoint with zero carry-in, the carry across groups, then the gradients.

``selective_scan_fwd`` takes the contract of ``ops.selective_scan``. When no
gradient is needed (serving) it runs K1 alone, without states, on a CUDA
tensor, or the plain chunked scan on a CPU tensor. When one is, it goes
through ``_SelectiveScan``, whose backward is K5 on a CUDA tensor and
``selective_scan_bwd_plain`` on a CPU tensor. On any other device, or on
operands a kernel does not take, it raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from mlagg_unet_torch.ops import _ext
from mlagg_unet_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_bwd_plain,
    selective_scan_states,
)

VP, I32, I64 = _ext.VP, _ext.I32, _ext.I64
FWD = _ext.Kernel(
    "selective_scan_fwd",
    _ext.KernelLib("selective_scan_fwd.cu", {
        "mlagg_scan_fwd": [VP] * 11 + [I32] * 4 + [I64] + [I32] * 8 + [VP],
        "mlagg_scan_fwd_occupancy": [I32] * 3 + [VP],
    }),
    "mlagg_scan_fwd",
)
BWD = _ext.Kernel(
    "selective_scan_bwd",
    _ext.KernelLib("selective_scan_bwd.cu", {
        "mlagg_scan_bwd": [VP] * 18 + [I32] * 4 + [I64] + [I32] * 7 + [VP],
    }),
    "mlagg_scan_bwd",
)
N_STATE = 16
STATE_EVERY = 64   # K1 saves h at the entry of every tile of this many steps

# K5's geometry (mirrors csrc/selective_scan_bwd.cu): a CTA of phases 1 and 3
# holds 32 channels x 16 states on 128 threads; phase 3's walks the row's
# channels in chunks of 32 and keeps 8 sub-tiles' entry states, u, gy,
# delta's softplus and sigmoid, B and C of a tile, and its dB / dC sums in
# shared memory; three phase 3 CTAs fit an SM
BWD_KERNELS = ("scan_bwd_group_kernel", "scan_bwd_carry_kernel", "scan_bwd_tile_kernel")
_BWD_CH, _BWD_THREADS, _BWD_CARRY_THREADS = 32, 128, 256
_BWD_SUB = 8           # steps per sub-tile of phase 3's adjoint
_BWD_CTAS_PER_SM = 3
_BWD_MAX_TILES = 8     # tiles per CTA at most
_BWD_MIN_WAVES = 6     # rounds of phase 3 CTAs over the SMs, at least, where L allows
_MAX_GRID = 2 ** 31 - 1


class ScanBwdPlan(NamedTuple):
    kernels: Tuple[str, str, str]    # phase 1 (group sums), 2 (carry), 3 (gradients)
    tiles_per_cta: int               # consecutive 64-step tiles of a phase 1 / 3 CTA
    groups: int                      # tile groups per row: ceil(ceil(L / 64) / tiles_per_cta)
    grids: Tuple[int, int, int]      # CTAs of each kernel (1-D grids)
    threads: Tuple[int, int, int]    # threads per CTA of each
    smem_bytes: Tuple[int, int, int]  # dynamic shared memory of each
    vec: int                         # 1: 16-byte cp.async staging and stores
    scratch_bytes: int               # fp32 carry, product, dA / dD / dbias partials


def _bwd_smem(esize: int) -> Tuple[int, int, int]:
    lt, ch, n = STATE_EVERY, _BWD_CH, N_STATE
    pt, gp, acc = lt + 1, lt + 4, 2 * n + 1          # padded rows
    up = lt + 8 if esize == 2 else lt + 4             # u row: 16-byte multiple
    group = (ch * pt + ch * gp + lt * n) * 4
    # the sub-tile entry states, with room for the next chunk's raw delta
    hent = max(lt // _BWD_SUB * _BWD_THREADS * 16, 2 * ch * lt * esize)
    tile = hent + ch * up * esize + (ch * gp + 2 * ch * pt + 2 * lt * n + 2 * 4 * _BWD_SUB * 32
                                     + lt * acc) * 4
    return group, 0, tile


def _bwd_tiles_per_cta(rows: int, n_tiles: int, num_sms: int) -> int:
    """The tiles each CTA walks: the most, up to 8 (less scratch, a shorter
    carry pass), that leave the grid ``_BWD_MIN_WAVES`` rounds of CTAs over
    the SMs' slots, so that CTAs finishing at different times keep the SMs
    evenly loaded; 1 where even that leaves fewer."""
    slots = _BWD_CTAS_PER_SM * num_sms
    return max((k for k in range(1, min(_BWD_MAX_TILES, n_tiles) + 1)
                if rows * -(-n_tiles // k) >= _BWD_MIN_WAVES * slots), default=1)


def scan_bwd_launch_plan(b: int, g: int, d: int, L: int, dtype, num_sms: int,
                         smem_optin: int, operands=()) -> ScanBwdPlan:
    """K5's kernels and launch for u of shape (b, g, d, L) in ``dtype``;
    raises on what the kernels do not take, including, for the given
    ``operands`` (u, delta, A, B, C, D, delta_bias, gy, states), other dtypes,
    n != 16, shapes, devices, non-contiguous tensors, a gy that is not fp32
    and the states' shape. Works on tensors of any device (the CPU tests call
    it); the C launcher ``mlagg_scan_bwd`` checks the same numbers.

    A row's ceil(L / 64) tiles are cut into groups of ``tiles_per_cta``
    (``_bwd_tiles_per_cta``); phase 1 launches one 128-thread CTA per (row,
    group, chunk of 32 channels), phase 2 one thread per (row, d, n), phase 3
    one 128-thread CTA per (row, group), which walks the row's chunks. ``vec``
    needs L % 8 == 0 and 16-byte aligned u, delta, B, C and gy (assumed
    without operands).
    """
    name = "selective_scan_bwd"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported")
    if b < 0 or g < 1 or d < 1 or L < 1:
        raise ValueError(f"{name}: b={b}, g={g}, d={d}, L={L}")
    n_tiles = -(-L // STATE_EVERY)
    vec = int(L % 8 == 0)
    if operands:
        u, delta, A, B, C, D, delta_bias, gy, states = operands
        if _check(name, u, delta, A, B, C) != (b, g, d, L) or u.dtype != dtype:
            raise ValueError(f"{name}: u {tuple(u.shape)} {u.dtype}, plan is for "
                             f"{(b, g, d, L)} {dtype}")
        for nm, t in (("D", D), ("delta_bias", delta_bias)):
            if t is not None and (t.numel() != g * d or t.device != u.device):
                raise ValueError(f"{name}: {nm} must hold (g, d) = {(g, d)} values on {u.device}")
        if (gy is None or gy.shape != u.shape or gy.dtype != torch.float32
                or gy.device != u.device or not gy.is_contiguous()):
            raise ValueError(f"{name}: gy must be contiguous fp32 {tuple(u.shape)} on {u.device}")
        shape = (b, g, n_tiles, d, N_STATE)
        if (states is None or states.shape != shape or states.dtype != torch.float32
                or states.device != u.device or not states.is_contiguous()):
            raise ValueError(f"{name}: states must be contiguous fp32 {shape} on {u.device}")
        vec = int(vec and all(t.data_ptr() % 16 == 0 for t in (u, delta, B, C, gy)))
    k = _bwd_tiles_per_cta(b * g, n_tiles, num_sms)
    groups = -(-n_tiles // k)
    grid = b * g * groups
    grids = (grid * -(-d // _BWD_CH), -(-b * g * d * N_STATE // _BWD_CARRY_THREADS), grid)
    if max(grids) > _MAX_GRID:
        raise ValueError(f"{name}: {max(grids)} CTAs exceed the grid's {_MAX_GRID}")
    smem = _bwd_smem(torch.finfo(dtype).bits // 8)
    if max(smem) > smem_optin:
        raise ValueError(f"{name}: the kernels need {max(smem)} bytes of shared memory "
                         f"per block, the device allows {smem_optin}")
    scratch = 4 * b * g * groups * d * (3 * N_STATE + 2)
    return ScanBwdPlan(BWD_KERNELS, k, groups, grids,
                       (_BWD_THREADS, _BWD_CARRY_THREADS, _BWD_THREADS), smem, vec, scratch)


# K1's geometry (mirrors csrc/selective_scan_fwd.cu): a CTA of passes 1 and 3
# holds one thread per channel, all 16 states in registers, up to 128
# channels of one row; it stages B (and C) of a tile in shared memory, raw
# by 16-byte cp.async into rows 16 bytes longer than a tile, then as fp32
# [step][state]
FWD_KERNELS = ("scan_fwd_group_kernel", "scan_fwd_carry_kernel", "scan_fwd_out_kernel")
_FWD_MAX_CH, _FWD_CARRY_THREADS = 128, 256
_FWD_WARPS_PER_SM = 18  # resident warps of passes 1 and 3 (96 registers a thread)
_FWD_MAX_TILES = 16     # tiles per CTA at most
_FWD_MIN_WAVES = 6      # rounds of CTAs over the SMs, at least, where L allows


class ScanFwdPlan(NamedTuple):
    kernels: Tuple[str, str, str]    # pass 1 (zero-entry group scan), 2 (carry), 3 (output)
    tiles_per_cta: int               # consecutive 64-step tiles of a pass 1 / 3 CTA
    groups: int                      # tile groups per row: ceil(ceil(L / 64) / tiles_per_cta)
    grids: Tuple[int, int, int]      # CTAs of each kernel (1-D grids)
    threads: Tuple[int, int, int]    # threads per CTA of each
    smem_bytes: Tuple[int, int, int]  # dynamic shared memory of each
    vec: int                         # 1: 16-byte loads of u, delta, cp.async of B, C, stores of y
    scratch_bytes: int               # fp32 group end states and delta sums


def _fwd_channels(d: int) -> Tuple[int, int, int]:
    """(chunks, channels per CTA, threads per CTA) for d channels: chunks of
    at most 128 channels, as even as can be, on whole warps."""
    chunks = -(-d // _FWD_MAX_CH)
    width = -(-d // chunks)
    return chunks, width, 32 * -(-width // 32)


def _fwd_smem(esize: int) -> Tuple[int, int, int]:
    lt, n = STATE_EVERY, N_STATE
    raw_pitch = lt + 16 // esize
    group, out = (nm * n * raw_pitch * esize + lt * nm * n * 4 for nm in (1, 2))
    return group, 0, out


def _fwd_tiles_per_cta(ctas_per_tile_row: int, n_tiles: int, num_sms: int, warps: int) -> int:
    """The tiles each CTA walks: the most, up to 16 (less scratch, a shorter
    carry pass), that leave the grid ``_FWD_MIN_WAVES`` rounds of CTAs over
    the SMs' slots, then the fewest that give as many groups (groups of
    even length); 1 where even one tile per CTA leaves fewer rounds."""
    slots = num_sms * max(1, _FWD_WARPS_PER_SM // warps)
    k = max((k for k in range(1, min(_FWD_MAX_TILES, n_tiles) + 1)
             if ctas_per_tile_row * -(-n_tiles // k) >= _FWD_MIN_WAVES * slots), default=1)
    return -(-n_tiles // -(-n_tiles // k))


def scan_fwd_launch_plan(b: int, g: int, d: int, L: int, dtype, num_sms: int,
                         smem_optin: int, operands=()) -> ScanFwdPlan:
    """K1's kernels and launch for u of shape (b, g, d, L) in ``dtype``;
    raises on what the kernels do not take, including, for the given
    ``operands`` (u, delta, A, B, C, D, delta_bias), other dtypes, n != 16,
    shapes, devices and non-contiguous tensors. Works on tensors of any
    device (the CPU tests call it); the C launcher ``mlagg_scan_fwd`` checks
    the same numbers. The plan does not depend on whether the tile-entry
    states are written, so y is the same either way.

    A row's ceil(L / 64) tiles are cut into groups of ``tiles_per_cta``
    (``_fwd_tiles_per_cta``); passes 1 and 3 launch one CTA per (row, group,
    chunk of at most 128 channels) with a thread per channel, pass 2 one
    thread per (row, d, n). ``vec`` needs L % 8 == 0 and 16-byte aligned u,
    delta, B and C (assumed without operands; y is allocated aligned).
    """
    name = "selective_scan_fwd"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported")
    if b < 0 or g < 1 or d < 1 or L < 1:
        raise ValueError(f"{name}: b={b}, g={g}, d={d}, L={L}")
    n_tiles = -(-L // STATE_EVERY)
    vec = int(L % 8 == 0)
    if operands:
        u, delta, A, B, C, D, delta_bias = operands
        if _check(name, u, delta, A, B, C) != (b, g, d, L) or u.dtype != dtype:
            raise ValueError(f"{name}: u {tuple(u.shape)} {u.dtype}, plan is for "
                             f"{(b, g, d, L)} {dtype}")
        for nm, t in (("D", D), ("delta_bias", delta_bias)):
            if t is not None and (t.numel() != g * d or t.device != u.device):
                raise ValueError(f"{name}: {nm} must hold (g, d) = {(g, d)} values on {u.device}")
        vec = int(vec and all(t.data_ptr() % 16 == 0 for t in (u, delta, B, C)))
    chunks, _, threads = _fwd_channels(d)
    k = _fwd_tiles_per_cta(b * g * chunks, n_tiles, num_sms, threads // 32)
    groups = -(-n_tiles // k)
    grid = b * g * groups * chunks
    grids = (grid, -(-b * g * d * N_STATE // _FWD_CARRY_THREADS), grid)
    if max(grids) > _MAX_GRID:
        raise ValueError(f"{name}: {max(grids)} CTAs exceed the grid's {_MAX_GRID}")
    smem = _fwd_smem(torch.finfo(dtype).bits // 8)
    if max(smem) > smem_optin:
        raise ValueError(f"{name}: the kernels need {max(smem)} bytes of shared memory "
                         f"per block, the device allows {smem_optin}")
    scratch = 4 * b * g * groups * d * (N_STATE + 1)
    return ScanFwdPlan(FWD_KERNELS, k, groups, grids, (threads, _FWD_CARRY_THREADS, threads),
                       smem, vec, scratch)


def scan_fwd_occupancy(dtype, reverse: bool, threads: int) -> dict:
    """Resident CTAs per SM and registers per thread of K1's passes 1 and 3
    in CTAs of ``threads`` threads, as the card's runtime reports them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); builds K1 if needed."""
    import ctypes

    out = (ctypes.c_int * 4)()
    rc = FWD.lib.load().mlagg_scan_fwd_occupancy(
        _ext.BF16 if dtype == torch.bfloat16 else _ext.F32, int(reverse), threads, out)
    if rc != 0:
        raise RuntimeError(f"selective_scan_fwd: occupancy query failed, CUDA error {rc}")
    return {"group": dict(ctas_per_sm=out[0], registers=out[1]),
            "out": dict(ctas_per_sm=out[2], registers=out[3])}


def scan_fwd_plain(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus=False, reverse=False):
    """K1's plain twin: the chunked PyTorch scan."""
    return selective_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                          reverse=reverse)


def _check(name, u, delta, A, B, C):
    """The operands a scan kernel takes; returns (b, g, d, l)."""
    b, g, d, l = u.shape
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {u.dtype} not supported")
    if A.shape != (g, d, N_STATE):
        raise ValueError(f"{name}: A {tuple(A.shape)}, kernel takes (g, d, {N_STATE})")
    for nm, t, shape in (("u", u, (b, g, d, l)),
                         ("delta", delta, (b, g, d, l)),
                         ("B", B, (b, g, N_STATE, l)),
                         ("C", C, (b, g, N_STATE, l))):
        if t.shape != shape or t.dtype != u.dtype or t.device != u.device:
            raise ValueError(f"{name}: {nm} {tuple(t.shape)} "
                             f"{t.dtype} {t.device} != {shape} {u.dtype} {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    return b, g, d, l


def _params32(u, A, D, delta_bias, g, d):
    """Per-channel parameters are tiny: the kernels read them as fp32."""
    def f32(t):
        return (None if t is None
                else t.to(u.device, torch.float32).reshape(g, d).contiguous())
    return A.to(u.device, torch.float32).contiguous(), f32(D), f32(delta_bias)


def _dtype_code(t):
    return _ext.BF16 if t.dtype == torch.bfloat16 else _ext.F32


def _launch_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse,
                with_states):
    props = torch.cuda.get_device_properties(u.device)
    plan = scan_fwd_launch_plan(*u.shape, u.dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin,
                                (u, delta, A, B, C, D, delta_bias))
    b, g, d, l = u.shape
    A32, D32, bias32 = _params32(u, A, D, delta_bias, g, d)
    f32 = dict(device=u.device, dtype=torch.float32)
    y = torch.empty(b, g, d, l, **f32)
    states = (torch.empty(b, g, math.ceil(l / STATE_EVERY), d, N_STATE, **f32)
              if with_states else None)
    carry = torch.empty(b, g, plan.groups, d, N_STATE, **f32)
    dsum = torch.empty(b, g, plan.groups, d, **f32)
    if b:
        FWD.launch(
            *map(_ext.ptr, (u, delta, A32, B, C, D32, bias32, y, states, carry, dsum)),
            b, g, d, N_STATE, l, int(delta_softplus), int(reverse), _dtype_code(u),
            plan.tiles_per_cta, plan.vec, plan.threads[0], plan.smem_bytes[0],
            plan.smem_bytes[2], _ext.stream_ptr(u.device))
    return y, states


def selective_scan_fwd_states(u, delta, A, B, C, D=None, delta_bias=None,
                              delta_softplus=False, reverse=False):
    """K1 with its tile-entry states: (y fp32 (b, g, d, l), states fp32
    (b, g, ceil(l / 64), d, 16)). On a CPU tensor, the plain twins."""
    if _ext.use_plain(u):
        return (scan_fwd_plain(u, delta, A, B, C, D, delta_bias, delta_softplus,
                               reverse),
                selective_scan_states(u, delta, A, B, C, delta_bias,
                                      delta_softplus, STATE_EVERY, reverse))
    return _launch_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus,
                       reverse, with_states=True)


def selective_scan_bwd(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False, gy=None,
                       states=None):
    """K5: the gradients of the scan for the output gradient ``gy``, from
    the states of ``selective_scan_fwd_states`` with the same operands.
    Returns (du, ddelta, dA, dB, dC, dD, ddelta_bias) in the inputs' dtypes,
    as ``selective_scan_bwd_plain`` does (which runs on a CPU tensor)."""
    if _ext.use_plain(u):
        return selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus, reverse, gy)
    gy32 = None if gy is None else gy.to(u.device, torch.float32).contiguous()
    props = torch.cuda.get_device_properties(u.device)
    plan = scan_bwd_launch_plan(*u.shape, u.dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin,
                                (u, delta, A, B, C, D, delta_bias, gy32, states))
    b, g, d, l = u.shape
    A32, D32, bias32 = _params32(u, A, D, delta_bias, g, d)
    f32 = dict(device=u.device, dtype=torch.float32)
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    part = (b, g, plan.groups, d)
    carry, prod, dA_p = (torch.empty(*part, N_STATE, **f32) for _ in range(3))
    dD_p, dbias_p = torch.empty(*part, **f32), torch.empty(*part, **f32)
    if b:
        BWD.launch(
            *map(_ext.ptr, (u, delta, A32, B, C, D32, bias32, gy32, states, du,
                            ddelta, dB, dC, carry, prod, dA_p, dD_p, dbias_p)),
            b, g, d, N_STATE, l, int(delta_softplus), int(reverse),
            _dtype_code(u), plan.tiles_per_cta, plan.vec, plan.smem_bytes[0],
            plan.smem_bytes[2], _ext.stream_ptr(u.device))
    # the per-(row, group) partials of dA, dD and dbias, summed here
    return (du, ddelta, dA_p.sum((0, 2)).to(A.dtype), dB, dC,
            None if D is None else dD_p.sum((0, 2)).to(D.dtype),
            None if delta_bias is None else dbias_p.sum((0, 2)).to(delta_bias.dtype))


class _SelectiveScan(torch.autograd.Function):
    """K1 with states forward, K5 backward (their plain twins on the CPU)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus, reverse):
        if _ext.use_plain(u):  # the plain backward recomputes its own states
            y, states = scan_fwd_plain(u, delta, A, B, C, D, delta_bias,
                                       delta_softplus, reverse), None
        else:
            y, states = _launch_fwd(u, delta, A, B, C, D, delta_bias,
                                    delta_softplus, reverse, with_states=True)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, states)
        ctx.flags = (delta_softplus, reverse)
        return y

    @staticmethod
    def backward(ctx, gy):
        u, delta, A, B, C, D, delta_bias, states = ctx.saved_tensors
        grads = selective_scan_bwd(u, delta, A, B, C, D, delta_bias, *ctx.flags,
                                   gy, states)
        return (*grads, None, None)


def selective_scan_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False) -> torch.Tensor:
    """u, delta: (b, g, d, l); A: (g, d, 16); B, C: (b, g, 16, l); D,
    delta_bias: (g, d) or None. Returns fp32 (b, g, d, l), differentiable in
    every tensor argument."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (u, delta, A, B, C, D, delta_bias)):
        return _SelectiveScan.apply(u, delta, A, B, C, D, delta_bias,
                                    bool(delta_softplus), bool(reverse))
    if _ext.use_plain(u):
        return scan_fwd_plain(u, delta, A, B, C, D, delta_bias,
                              delta_softplus, reverse)
    return _launch_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus,
                       reverse, with_states=False)[0]
