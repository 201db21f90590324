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

Both kernels are built for 1 and 16 states per channel (``N_INSTANCES``).
Any other n from 1 to 64 (``MAX_STATE``) is served exactly by zero padding:
A, B and C of n from 2 to 15 are padded to 16 states (a padded state has
A = 0 and B = 0, so it stays 0, and C = 0, so it adds nothing to y; its
gradients are 0 and are sliced off), and n from 17 to 64 runs as
ceil(n / 16) passes of 16 states, the last one padded: the states of a
scan are independent, so y, du, ddelta and dbias are the sums of the
passes' (D enters the first pass only) and dA, dB, dC and the tile-entry
states their concatenation. Above 64 the wrappers raise.

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
import torch.nn.functional as F

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
        "mlagg_scan_fwd_occupancy": [I32] * 4 + [VP],
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
N_INSTANCES = (1, 16)  # the state counts the kernels are built for
MAX_STATE = 64         # the most states a wrapper takes (passes of 16)
STATE_EVERY = 64       # K1 saves h at the entry of every tile of this many steps
# the H100's shared memory per SM, and what the runtime keeps of it per CTA:
# with a CTA's own, they bound the resident CTAs of a kernel
_SMEM_PER_SM, _SMEM_PER_CTA_RESERVED = 233_472, 1_024


def state_instance(n: int) -> Tuple[int, int]:
    """(N, passes): the kernels' state count that serves ``n`` states and
    the passes of N states it takes (1 unless n > 16)."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective scan: d_state {n}; the kernels take 1 to {MAX_STATE} "
                         f"states (built for {N_INSTANCES}, others padded)")
    return (1, 1) if n == 1 else (16, -(-n // 16))


# K5's geometry (mirrors csrc/selective_scan_bwd.cu): a CTA of phases 1 and 3
# holds 32 channels x N states, min(4, N) states a thread (128 threads at N =
# 16, 32 at N = 1); phase 3's walks the row's channels in chunks of 32 and
# keeps 8 sub-tiles' entry states, u, gy, delta's softplus and sigmoid, B and
# C of a tile, and its dB / dC sums in shared memory; three phase 3 CTAs fit
# an SM at N = 16, four at N = 1 (the launch bounds')
BWD_KERNELS = ("scan_bwd_group_kernel", "scan_bwd_carry_kernel", "scan_bwd_tile_kernel")
_BWD_CH, _BWD_CARRY_THREADS = 32, 256
_BWD_SUB = 8           # steps per sub-tile of phase 3's adjoint
_BWD_TILE_CTAS = {16: 3, 1: 4}  # phase 3's launch bounds
_BWD_MAX_TILES = 8     # tiles per CTA at most
_BWD_MIN_WAVES = 6     # rounds of phase 3 CTAs over the SMs, at least, where L allows
_MAX_GRID = 2 ** 31 - 1


def _bwd_threads(n: int) -> int:
    """K5's CTA: 32 channels of n / min(4, n) lanes each."""
    return _BWD_CH * (n // min(4, n))


class ScanBwdPlan(NamedTuple):
    kernels: Tuple[str, str, str]    # phase 1 (group sums), 2 (carry), 3 (gradients)
    tiles_per_cta: int               # consecutive 64-step tiles of a phase 1 / 3 CTA
    groups: int                      # tile groups per row: ceil(ceil(L / 64) / tiles_per_cta)
    grids: Tuple[int, int, int]      # CTAs of each kernel (1-D grids)
    threads: Tuple[int, int, int]    # threads per CTA of each
    smem_bytes: Tuple[int, int, int]  # dynamic shared memory of each
    vec: int                         # 1: 16-byte cp.async staging and stores
    scratch_bytes: int               # fp32 carry, product, dA / dD / dbias partials (a pass)
    n_state: int = 16                # the kernels' N (1 or 16)
    passes: int = 1                  # launches of N states each (n > 16)


def _bwd_smem(esize: int, n: int = 16) -> Tuple[int, int, int]:
    lt, ch = STATE_EVERY, _BWD_CH
    threads, qs = _bwd_threads(n), min(4, n)
    pt, gp, acc = lt + 1, lt + 4, 2 * n + 1          # padded rows
    up = lt + 8 if esize == 2 else lt + 4             # u row: 16-byte multiple
    group = (ch * pt + ch * gp + lt * n) * 4
    # the sub-tile entry states, with room for the next chunk's raw delta
    hent = max(lt // _BWD_SUB * threads * qs * 4, 2 * ch * lt * esize)
    tile = hent + ch * up * esize + (ch * gp + 2 * ch * pt + 2 * lt * n
                                     + 2 * threads // 32 * _BWD_SUB * 32 + lt * acc) * 4
    return group, 0, tile


def _bwd_ctas_per_sm(esize: int, n: int) -> int:
    """Phase 3's resident CTAs per SM: its launch bounds', or fewer where
    its shared memory allows fewer."""
    tile = _bwd_smem(esize, n)[2]
    return min(_BWD_TILE_CTAS[n], _SMEM_PER_SM // (tile + _SMEM_PER_CTA_RESERVED))


def _bwd_tiles_per_cta(rows: int, n_tiles: int, num_sms: int, ctas_per_sm: int = 3) -> int:
    """The tiles each CTA walks: the most, up to 8 (less scratch, a shorter
    carry pass), that leave the grid ``_BWD_MIN_WAVES`` rounds of CTAs over
    the SMs' slots, so that CTAs finishing at different times keep the SMs
    evenly loaded; 1 where even that leaves fewer."""
    slots = ctas_per_sm * num_sms
    return max((k for k in range(1, min(_BWD_MAX_TILES, n_tiles) + 1)
                if rows * -(-n_tiles // k) >= _BWD_MIN_WAVES * slots), default=1)


def scan_bwd_launch_plan(b: int, g: int, d: int, L: int, dtype, num_sms: int,
                         smem_optin: int, operands=(), n_state: int = 16) -> ScanBwdPlan:
    """K5's kernels and launch for u of shape (b, g, d, L) in ``dtype`` at
    ``n_state`` states (A's last axis when ``operands`` are given): the
    kernels' N (``state_instance``) and the passes of N states; raises on
    what the kernels do not take, including, for the given ``operands`` (u,
    delta, A, B, C, D, delta_bias, gy, states), other dtypes, more than 64
    states, shapes, devices, non-contiguous tensors, a gy that is not fp32
    and the states' shape. Works on tensors of any device (the CPU tests call
    it); the C launcher ``mlagg_scan_bwd`` checks the same numbers.

    A row's ceil(L / 64) tiles are cut into groups of ``tiles_per_cta``
    (``_bwd_tiles_per_cta``); phase 1 launches one CTA per (row, group, chunk
    of 32 channels), phase 2 one thread per (row, d, n), phase 3 one CTA per
    (row, group), which walks the row's chunks; a CTA is 128 threads at N =
    16 and 32 at N = 1. ``vec`` needs L % 8 == 0 and 16-byte aligned u,
    delta, B, C and gy (assumed without operands).
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
        n_state = A.shape[-1]
        if _check(name, u, delta, A, B, C) != (b, g, d, L) or u.dtype != dtype:
            raise ValueError(f"{name}: u {tuple(u.shape)} {u.dtype}, plan is for "
                             f"{(b, g, d, L)} {dtype}")
        for nm, t in (("D", D), ("delta_bias", delta_bias)):
            if t is not None and (t.numel() != g * d or t.device != u.device):
                raise ValueError(f"{name}: {nm} must hold (g, d) = {(g, d)} values on {u.device}")
        if (gy is None or gy.shape != u.shape or gy.dtype != torch.float32
                or gy.device != u.device or not gy.is_contiguous()):
            raise ValueError(f"{name}: gy must be contiguous fp32 {tuple(u.shape)} on {u.device}")
        shape = (b, g, n_tiles, d, n_state)
        if (states is None or states.shape != shape or states.dtype != torch.float32
                or states.device != u.device or not states.is_contiguous()):
            raise ValueError(f"{name}: states must be contiguous fp32 {shape} on {u.device}")
        vec = int(vec and all(t.data_ptr() % 16 == 0 for t in (u, delta, B, C, gy)))
    n, passes = state_instance(n_state)
    esize = torch.finfo(dtype).bits // 8
    k = _bwd_tiles_per_cta(b * g, n_tiles, num_sms, _bwd_ctas_per_sm(esize, n))
    groups = -(-n_tiles // k)
    grid = b * g * groups
    grids = (grid * -(-d // _BWD_CH), -(-b * g * d * n // _BWD_CARRY_THREADS), grid)
    if max(grids) > _MAX_GRID:
        raise ValueError(f"{name}: {max(grids)} CTAs exceed the grid's {_MAX_GRID}")
    smem = _bwd_smem(esize, n)
    if max(smem) > smem_optin:
        raise ValueError(f"{name}: the kernels need {max(smem)} bytes of shared memory "
                         f"per block, the device allows {smem_optin}")
    scratch = 4 * b * g * groups * d * (3 * n + 2)
    threads = _bwd_threads(n)
    return ScanBwdPlan(BWD_KERNELS, k, groups, grids,
                       (threads, _BWD_CARRY_THREADS, threads), smem, vec, scratch, n, passes)


# K1's geometry (mirrors csrc/selective_scan_fwd.cu): a CTA of passes 1 and 3
# holds one thread per channel, all N states in registers, up to 128
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
    scratch_bytes: int               # fp32 group end states and delta sums (a pass)
    n_state: int = 16                # the kernels' N (1 or 16)
    passes: int = 1                  # launches of N states each (n > 16)


def _fwd_channels(d: int) -> Tuple[int, int, int]:
    """(chunks, channels per CTA, threads per CTA) for d channels: chunks of
    at most 128 channels, as even as can be, on whole warps."""
    chunks = -(-d // _FWD_MAX_CH)
    width = -(-d // chunks)
    return chunks, width, 32 * -(-width // 32)


def _fwd_smem(esize: int, n: int = 16) -> Tuple[int, int, int]:
    lt = STATE_EVERY
    raw_pitch = lt + 16 // esize
    group, out = (nm * n * raw_pitch * esize + lt * nm * n * 4 for nm in (1, 2))
    return group, 0, out


def _fwd_ctas_per_sm(warps: int, smem_out: int) -> int:
    """Resident CTAs of passes 1 and 3 per SM: the warps their registers
    allow, or fewer where pass 3's shared memory allows fewer."""
    return max(1, min(_FWD_WARPS_PER_SM // warps,
                      _SMEM_PER_SM // (smem_out + _SMEM_PER_CTA_RESERVED)))


def _fwd_tiles_per_cta(ctas_per_tile_row: int, n_tiles: int, num_sms: int, warps: int,
                       smem_out: int = 0) -> int:
    """The tiles each CTA walks: the most, up to 16 (less scratch, a shorter
    carry pass), that leave the grid ``_FWD_MIN_WAVES`` rounds of CTAs over
    the SMs' slots, then the fewest that give as many groups (groups of
    even length); 1 where even one tile per CTA leaves fewer rounds."""
    slots = num_sms * _fwd_ctas_per_sm(warps, smem_out)
    k = max((k for k in range(1, min(_FWD_MAX_TILES, n_tiles) + 1)
             if ctas_per_tile_row * -(-n_tiles // k) >= _FWD_MIN_WAVES * slots), default=1)
    return -(-n_tiles // -(-n_tiles // k))


def scan_fwd_launch_plan(b: int, g: int, d: int, L: int, dtype, num_sms: int,
                         smem_optin: int, operands=(), n_state: int = 16) -> ScanFwdPlan:
    """K1's kernels and launch for u of shape (b, g, d, L) in ``dtype`` at
    ``n_state`` states (A's last axis when ``operands`` are given): the
    kernels' N (``state_instance``) and the passes of N states; raises on
    what the kernels do not take, including, for the given ``operands`` (u,
    delta, A, B, C, D, delta_bias), other dtypes, more than 64 states,
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
        n_state = A.shape[-1]
        if _check(name, u, delta, A, B, C) != (b, g, d, L) or u.dtype != dtype:
            raise ValueError(f"{name}: u {tuple(u.shape)} {u.dtype}, plan is for "
                             f"{(b, g, d, L)} {dtype}")
        for nm, t in (("D", D), ("delta_bias", delta_bias)):
            if t is not None and (t.numel() != g * d or t.device != u.device):
                raise ValueError(f"{name}: {nm} must hold (g, d) = {(g, d)} values on {u.device}")
        vec = int(vec and all(t.data_ptr() % 16 == 0 for t in (u, delta, B, C)))
    n, passes = state_instance(n_state)
    smem = _fwd_smem(torch.finfo(dtype).bits // 8, n)
    chunks, _, threads = _fwd_channels(d)
    k = _fwd_tiles_per_cta(b * g * chunks, n_tiles, num_sms, threads // 32, smem[2])
    groups = -(-n_tiles // k)
    grid = b * g * groups * chunks
    grids = (grid, -(-b * g * d * n // _FWD_CARRY_THREADS), grid)
    if max(grids) > _MAX_GRID:
        raise ValueError(f"{name}: {max(grids)} CTAs exceed the grid's {_MAX_GRID}")
    if max(smem) > smem_optin:
        raise ValueError(f"{name}: the kernels need {max(smem)} bytes of shared memory "
                         f"per block, the device allows {smem_optin}")
    scratch = 4 * b * g * groups * d * (n + 1)
    return ScanFwdPlan(FWD_KERNELS, k, groups, grids, (threads, _FWD_CARRY_THREADS, threads),
                       smem, vec, scratch, n, passes)


def scan_fwd_occupancy(dtype, reverse: bool, threads: int, n_state: int = 16) -> dict:
    """Resident CTAs per SM and registers per thread of K1's passes 1 and 3
    at ``n_state`` (1 or 16) in CTAs of ``threads`` threads, as the card's
    runtime reports them (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
    builds K1 if needed."""
    import ctypes

    out = (ctypes.c_int * 4)()
    rc = FWD.lib.load().mlagg_scan_fwd_occupancy(
        n_state, _ext.BF16 if dtype == torch.bfloat16 else _ext.F32, int(reverse), threads,
        out)
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
    n = A.shape[-1]
    if A.shape != (g, d, n):
        raise ValueError(f"{name}: A {tuple(A.shape)}, kernel takes (g, d, n) = {(g, d, n)}")
    state_instance(n)
    for nm, t, shape in (("u", u, (b, g, d, l)),
                         ("delta", delta, (b, g, d, l)),
                         ("B", B, (b, g, n, l)),
                         ("C", C, (b, g, n, l))):
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


def _passes(A, B, C):
    """(A, B, C) of each launch: the state axis zero-padded to the kernels'
    N (``state_instance``) and cut into passes of N states (one unless n >
    16); unchanged at n = 1 and n = 16."""
    n = A.shape[-1]
    N, passes = state_instance(n)
    pad = N * passes - n
    if pad:
        A = F.pad(A, (0, pad))
        B, C = (F.pad(t, (0, 0, 0, pad)) for t in (B, C))
    if passes == 1:
        return [(A, B, C)]
    return [(A[..., k * N:(k + 1) * N].contiguous(), B[:, :, k * N:(k + 1) * N].contiguous(),
             C[:, :, k * N:(k + 1) * N].contiguous()) for k in range(passes)]


def _launch_fwd_pass(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse,
                     with_states):
    props = torch.cuda.get_device_properties(u.device)
    plan = scan_fwd_launch_plan(*u.shape, u.dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin,
                                (u, delta, A, B, C, D, delta_bias))
    b, g, d, l = u.shape
    n = plan.n_state
    A32, D32, bias32 = _params32(u, A, D, delta_bias, g, d)
    f32 = dict(device=u.device, dtype=torch.float32)
    y = torch.empty(b, g, d, l, **f32)
    states = (torch.empty(b, g, math.ceil(l / STATE_EVERY), d, n, **f32)
              if with_states else None)
    carry = torch.empty(b, g, plan.groups, d, n, **f32)
    dsum = torch.empty(b, g, plan.groups, d, **f32)
    if b:
        FWD.launch(
            *map(_ext.ptr, (u, delta, A32, B, C, D32, bias32, y, states, carry, dsum)),
            b, g, d, n, l, int(delta_softplus), int(reverse), _dtype_code(u),
            plan.tiles_per_cta, plan.vec, plan.threads[0], plan.smem_bytes[0],
            plan.smem_bytes[2], _ext.stream_ptr(u.device))
    return y, states


def fwd_over_passes(launch, u, delta, A, B, C, D, delta_bias, delta_softplus, reverse,
                    with_states):
    """``launch`` (one forward of N states -> (y, states or None)) over the
    passes of ``_passes``: y summed (D in the first pass only), the states
    joined and sliced back to A's n. ``launch`` is K1 on the card; the CPU
    tests hand it the plain twins."""
    n = A.shape[-1]
    y, states = None, []
    for k, (Ak, Bk, Ck) in enumerate(_passes(A, B, C)):
        yk, sk = launch(u, delta, Ak, Bk, Ck, D if k == 0 else None, delta_bias,
                        delta_softplus, reverse, with_states)
        y = yk if y is None else y.add_(yk)
        states.append(sk)
    if not with_states:
        return y, None
    st = states[0] if len(states) == 1 else torch.cat(states, -1)
    return y, (st if st.shape[-1] == n else st[..., :n].contiguous())


def _launch_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse, with_states):
    return fwd_over_passes(_launch_fwd_pass, u, delta, A, B, C, D, delta_bias, delta_softplus,
                           reverse, with_states)


def selective_scan_fwd_states(u, delta, A, B, C, D=None, delta_bias=None,
                              delta_softplus=False, reverse=False):
    """K1 with its tile-entry states: (y fp32 (b, g, d, l), states fp32
    (b, g, ceil(l / 64), d, n)). On a CPU tensor, the plain twins."""
    if _ext.use_plain(u):
        return (scan_fwd_plain(u, delta, A, B, C, D, delta_bias, delta_softplus,
                               reverse),
                selective_scan_states(u, delta, A, B, C, delta_bias,
                                      delta_softplus, STATE_EVERY, reverse))
    return _launch_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus,
                       reverse, with_states=True)


def _launch_bwd_pass(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse, gy32,
                     states):
    props = torch.cuda.get_device_properties(u.device)
    plan = scan_bwd_launch_plan(*u.shape, u.dtype, props.multi_processor_count,
                                props.shared_memory_per_block_optin,
                                (u, delta, A, B, C, D, delta_bias, gy32, states))
    b, g, d, l = u.shape
    n = plan.n_state
    A32, D32, bias32 = _params32(u, A, D, delta_bias, g, d)
    f32 = dict(device=u.device, dtype=torch.float32)
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    part = (b, g, plan.groups, d)
    carry, prod, dA_p = (torch.empty(*part, n, **f32) for _ in range(3))
    dD_p, dbias_p = torch.empty(*part, **f32), torch.empty(*part, **f32)
    if b:
        BWD.launch(
            *map(_ext.ptr, (u, delta, A32, B, C, D32, bias32, gy32, states, du,
                            ddelta, dB, dC, carry, prod, dA_p, dD_p, dbias_p)),
            b, g, d, n, l, int(delta_softplus), int(reverse),
            _dtype_code(u), plan.tiles_per_cta, plan.vec, plan.smem_bytes[0],
            plan.smem_bytes[2], _ext.stream_ptr(u.device))
    # the per-(row, group) partials of dA, dD and dbias, summed here
    return (du, ddelta, dA_p.sum((0, 2)).to(A.dtype), dB, dC,
            None if D is None else dD_p.sum((0, 2)).to(D.dtype),
            None if delta_bias is None else dbias_p.sum((0, 2)).to(delta_bias.dtype))


def selective_scan_bwd(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False, gy=None,
                       states=None):
    """K5: the gradients of the scan for the output gradient ``gy``, from
    the states of ``selective_scan_fwd_states`` with the same operands.
    Returns (du, ddelta, dA, dB, dC, dD, ddelta_bias) in the inputs' dtypes,
    as ``selective_scan_bwd_plain`` does (which runs on a CPU tensor); at n
    other than 1 and 16 over the passes of ``bwd_over_passes``."""
    if _ext.use_plain(u):
        return selective_scan_bwd_plain(u, delta, A, B, C, D, delta_bias,
                                        delta_softplus, reverse, gy)
    gy32 = None if gy is None else gy.to(u.device, torch.float32).contiguous()
    return bwd_over_passes(_launch_bwd_pass, u, delta, A, B, C, D, delta_bias,
                           delta_softplus, reverse, gy32, states)


def bwd_over_passes(launch, u, delta, A, B, C, D, delta_bias, delta_softplus, reverse, gy,
                    states):
    """``launch`` (one backward of N states from its tile-entry states) over
    the passes of ``_passes``: du, ddelta and ddelta_bias summed (D in the
    first pass only), dA, dB and dC joined and sliced back to A's n. K5 on
    the card; the CPU tests hand it the plain twin."""
    n = A.shape[-1]
    N, passes = state_instance(n)
    if states is not None and N * passes != n:
        states = F.pad(states, (0, N * passes - n))
    grads = [launch(
        u, delta, Ak, Bk, Ck, D if k == 0 else None, delta_bias, delta_softplus, reverse,
        gy, states if passes == 1 else states[..., k * N:(k + 1) * N].contiguous())
        for k, (Ak, Bk, Ck) in enumerate(_passes(A, B, C))]
    if len(grads) == 1 and N == n:
        return grads[0]
    du, ddelta, _, _, _, dD, dbias = grads[0]
    for gk in grads[1:]:
        du, ddelta = du + gk[0], ddelta + gk[1]
        dbias = None if dbias is None else dbias + gk[6]
    dA, dB, dC = (torch.cat([gk[i] for gk in grads], axis)
                  for i, axis in ((2, -1), (3, 2), (4, 2)))
    return (du, ddelta, dA[..., :n].contiguous(), dB[:, :, :n].contiguous(),
            dC[:, :, :n].contiguous(), dD, dbias)


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
    """u, delta: (b, g, d, l); A: (g, d, n); B, C: (b, g, n, l), n from 1 to
    64; D, delta_bias: (g, d) or None. Returns fp32 (b, g, d, l),
    differentiable in every tensor argument."""
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
