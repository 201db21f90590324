"""Selective-scan forward on the GPU: kernel K1 (``csrc/selective_scan_fwd.cu``).

Replaces the Pallas forward kernels ``_fwd_kernel_v2`` / ``_fwd_kernel`` of
``mlagg_unet_tpu/ops/selective_scan_pallas.py``. Serving only: no chunk
states are emitted, so there is no backward yet.

``selective_scan_fwd`` takes the contract of ``ops.selective_scan``: on a CPU
tensor it runs the plain chunked scan; on a CUDA tensor it launches K1 or
raises.
"""
from __future__ import annotations

import torch

from mlagg_unet_torch.ops import _ext
from mlagg_unet_torch.ops.selective_scan import selective_scan

KERNEL = _ext.Kernel(
    "selective_scan_fwd",
    _ext.KernelLib("selective_scan_fwd.cu", {
        "mlagg_scan_fwd": [_ext.VP] * 8 + [_ext.I32] * 4 + [_ext.I64]
        + [_ext.I32] * 3 + [_ext.VP],
    }),
    "mlagg_scan_fwd",
)
N_STATE = 16


def scan_fwd_plain(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus=False, reverse=False):
    """The kernel's plain twin: the chunked PyTorch scan."""
    return selective_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                          reverse=reverse)


def selective_scan_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False) -> torch.Tensor:
    """u, delta: (b, g, d, l); A: (g, d, 16); B, C: (b, g, 16, l); D,
    delta_bias: (g, d) or None. Returns fp32 (b, g, d, l)."""
    if _ext.use_plain(u):
        return scan_fwd_plain(u, delta, A, B, C, D, delta_bias,
                              delta_softplus, reverse)
    b, g, d, l = u.shape
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"selective_scan_fwd: dtype {u.dtype} not supported")
    if A.shape != (g, d, N_STATE):
        raise ValueError(f"selective_scan_fwd: A {tuple(A.shape)}, kernel takes (g, d, {N_STATE})")
    for name, t, shape in (("delta", delta, (b, g, d, l)),
                           ("B", B, (b, g, N_STATE, l)),
                           ("C", C, (b, g, N_STATE, l))):
        if t.shape != shape or t.dtype != u.dtype or t.device != u.device:
            raise ValueError(f"selective_scan_fwd: {name} {tuple(t.shape)} "
                             f"{t.dtype} {t.device} != {shape} {u.dtype} {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan_fwd: {name} must be contiguous")
    if not u.is_contiguous():
        raise ValueError("selective_scan_fwd: u must be contiguous")
    # per-channel parameters are tiny: the kernel reads them as fp32
    A32 = A.to(u.device, torch.float32).contiguous()
    D32 = None if D is None else D.to(u.device, torch.float32).reshape(g, d).contiguous()
    bias32 = (None if delta_bias is None
              else delta_bias.to(u.device, torch.float32).reshape(g, d).contiguous())
    y = torch.empty(b, g, d, l, device=u.device, dtype=torch.float32)
    KERNEL.launch(
        _ext.ptr(u), _ext.ptr(delta), _ext.ptr(A32), _ext.ptr(B), _ext.ptr(C),
        _ext.ptr(D32), _ext.ptr(bias32), _ext.ptr(y), b, g, d, N_STATE, l,
        int(delta_softplus), int(reverse),
        _ext.BF16 if u.dtype == torch.bfloat16 else _ext.F32,
        _ext.stream_ptr(u.device))
    return y
