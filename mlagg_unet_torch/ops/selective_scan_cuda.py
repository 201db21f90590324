"""Selective scan on the GPU: kernels K1 (forward, ``csrc/selective_scan_fwd.cu``)
and K5 (backward, ``csrc/selective_scan_bwd.cu``).

K1 replaces the Pallas forward kernels ``_fwd_kernel_v2`` / ``_fwd_kernel``
and K5 the backward kernels ``_bwd_kernel_v2`` / ``_bwd_kernel`` of
``mlagg_unet_tpu/ops/selective_scan_pallas.py``; ``_SelectiveScan`` ties them
together as the custom_vjp there does (``:1092-1117``): the forward of a
training step runs K1 with its tile-entry states, and the backward runs K5
on them.

``selective_scan_fwd`` takes the contract of ``ops.selective_scan``. When no
gradient is needed (serving) it runs K1 alone, without states, on a CUDA
tensor, or the plain chunked scan on a CPU tensor. When one is, it goes
through ``_SelectiveScan``, whose backward is K5 on a CUDA tensor and
``selective_scan_bwd_plain`` on a CPU tensor. On any other device, or on
operands a kernel does not take, it raises.
"""
from __future__ import annotations

import math

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
        "mlagg_scan_fwd": [VP] * 9 + [I32] * 4 + [I64] + [I32] * 3 + [VP],
    }),
    "mlagg_scan_fwd",
)
BWD = _ext.Kernel(
    "selective_scan_bwd",
    _ext.KernelLib("selective_scan_bwd.cu", {
        "mlagg_scan_bwd": [VP] * 16 + [I32] * 4 + [I64] + [I32] * 3 + [VP],
        "mlagg_scan_bwd_smem_bytes": [],
    }),
    "mlagg_scan_bwd",
)
N_STATE = 16
STATE_EVERY = 64   # K1 saves h at the entry of every tile of this many steps
CHANNELS_PER_CTA = 8


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
    b, g, d, l = _check("selective_scan_fwd", u, delta, A, B, C)
    A32, D32, bias32 = _params32(u, A, D, delta_bias, g, d)
    y = torch.empty(b, g, d, l, device=u.device, dtype=torch.float32)
    states = (torch.empty(b, g, math.ceil(l / STATE_EVERY), d, N_STATE,
                          device=u.device, dtype=torch.float32)
              if with_states else None)
    FWD.launch(
        _ext.ptr(u), _ext.ptr(delta), _ext.ptr(A32), _ext.ptr(B), _ext.ptr(C),
        _ext.ptr(D32), _ext.ptr(bias32), _ext.ptr(y), _ext.ptr(states),
        b, g, d, N_STATE, l, int(delta_softplus), int(reverse),
        _dtype_code(u), _ext.stream_ptr(u.device))
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
    b, g, d, l = _check("selective_scan_bwd", u, delta, A, B, C)
    shape = (b, g, math.ceil(l / STATE_EVERY), d, N_STATE)
    if (states is None or states.shape != shape or states.dtype != torch.float32
            or states.device != u.device or not states.is_contiguous()):
        raise ValueError(f"selective_scan_bwd: states must be contiguous fp32 "
                         f"{shape} on {u.device}")
    if gy is None or gy.shape != u.shape:
        raise ValueError(f"selective_scan_bwd: gy must have u's shape {tuple(u.shape)}")
    lib = BWD.lib.load()
    need = lib.mlagg_scan_bwd_smem_bytes()
    have = torch.cuda.get_device_properties(u.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"selective_scan_bwd: the kernel needs {need} bytes of "
                         f"shared memory per block, the device allows {have}")
    A32, D32, bias32 = _params32(u, A, D, delta_bias, g, d)
    gy32 = gy.to(u.device, torch.float32).contiguous()
    f32 = dict(device=u.device, dtype=torch.float32)
    du, ddelta = torch.empty_like(u), torch.empty_like(delta)
    dA_p = torch.empty(b, g, d, N_STATE, **f32)
    n_blk = math.ceil(d / CHANNELS_PER_CTA)
    dB_p = torch.empty(n_blk, b, g, N_STATE, l, **f32)
    dC_p = torch.empty(n_blk, b, g, N_STATE, l, **f32)
    dD_p, dbias_p = torch.empty(b, g, d, **f32), torch.empty(b, g, d, **f32)
    BWD.launch(
        *map(_ext.ptr, (u, delta, A32, B, C, D32, bias32, gy32, states, du,
                        ddelta, dA_p, dB_p, dC_p, dD_p, dbias_p)),
        b, g, d, N_STATE, l, int(delta_softplus), int(reverse),
        _dtype_code(u), _ext.stream_ptr(u.device))
    # the batch (and, for dB / dC, the CTAs' channel blocks) summed here
    return (du, ddelta, dA_p.sum(0).to(A.dtype), dB_p.sum(0).to(B.dtype),
            dC_p.sum(0).to(C.dtype),
            None if D is None else dD_p.sum(0).to(D.dtype),
            None if delta_bias is None else dbias_p.sum(0).to(delta_bias.dtype))


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
