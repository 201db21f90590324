"""Selective scan (Mamba S6 recurrence) in plain PyTorch.

Counterpart of ``mlagg_unet_tpu/ops/selective_scan.py`` with the same
contract. Per batch b, group g, channel d, state n and step l::

    delta = softplus(delta_raw + delta_bias)          [if delta_softplus]
    h_l   = exp(delta_l * A) * h_{l-1} + delta_l * B_l * u_l
    y_l   = sum_n C_l[n] * h_l[n] + D * u_l

u, delta: (b, g, d, l); A: (g, d, n); B, C: (b, g, n, l); D, delta_bias:
(g, d) or None. All arithmetic is fp32 and y is fp32 whatever the input
dtype. ``reverse=True`` scans right to left and returns y at the natural
positions.

``selective_scan`` is the vectorised chunked form: a log-depth doubling scan
inside each chunk and a loop over chunks for the carried state. It is the
plain twin of the CUDA kernel (``selective_scan_cuda.py``) and the CPU path.
``selective_scan_seq_ref`` is the step-by-step ground truth for tests.
"""
from __future__ import annotations

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus == logaddexp(x, 0); torch's threshold=20 shortcut
    # differs from it by < 2e-9, so use the exact form
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _prep(u, delta, A, B, C, delta_bias, delta_softplus):
    b, g, d, l = u.shape
    n = A.shape[-1]
    if A.shape != (g, d, n):
        raise ValueError(f"A shape {tuple(A.shape)} != {(g, d, n)}")
    if B.shape != (b, g, n, l) or C.shape != (b, g, n, l):
        raise ValueError(f"B/C shape {tuple(B.shape)}/{tuple(C.shape)} != {(b, g, n, l)}")
    u, delta, A, B, C = (t.float() for t in (u, delta, A, B, C))
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, :, None]
    if delta_softplus:
        delta = _softplus(delta)
    return u, delta, A, B, C


def _add_d(y, u, D):
    if D is not None:
        y = y + D.float()[None, :, :, None] * u
    return y


def selective_scan_seq_ref(u, delta, A, B, C, D=None, delta_bias=None,
                           delta_softplus: bool = False,
                           reverse: bool = False) -> torch.Tensor:
    """Step-by-step loop over l (slow; numerics ground truth)."""
    u, delta, A, B, C = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    b, g, d, l = u.shape
    h = u.new_zeros(b, g, d, A.shape[-1])
    y = u.new_empty(b, g, d, l)
    for t in (range(l - 1, -1, -1) if reverse else range(l)):
        dt = delta[..., t]
        h = torch.exp(dt[..., None] * A) * h + (dt * u[..., t])[..., None] * B[:, :, None, :, t]
        y[..., t] = (h * C[:, :, None, :, t]).sum(-1)
    return _add_d(y, u, D)


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus: bool = False, chunk_size: int = 256,
                   reverse: bool = False) -> torch.Tensor:
    """Chunked scan: doubling scan within each chunk, state carried across
    chunks. Returns (b, g, d, l) fp32."""
    if reverse:
        flip = lambda t: t.flip(-1)  # noqa: E731
        return flip(selective_scan(flip(u), flip(delta), A, flip(B), flip(C),
                                   D, delta_bias, delta_softplus, chunk_size))
    u, delta, A, B, C = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    b, g, d, l = u.shape
    n = A.shape[-1]
    h = u.new_zeros(b, g, d, 1, n)
    ys = []
    for s in range(0, l, chunk_size):
        dt = delta[..., s:s + chunk_size]                        # (b,g,d,lc)
        a = torch.exp(dt[..., None] * A[None, :, :, None, :])    # (b,g,d,lc,n)
        bx = (dt * u[..., s:s + chunk_size])[..., None] * \
            B[..., s:s + chunk_size].transpose(-1, -2)[:, :, None]
        lc = dt.shape[-1]
        # inclusive doubling scan of (a, bx) under
        # (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2) along the step axis
        k = 1
        while k < lc:
            bx = torch.cat([bx[..., :k, :], bx[..., k:, :] + a[..., k:, :] * bx[..., :-k, :]], dim=-2)
            a = torch.cat([a[..., :k, :], a[..., k:, :] * a[..., :-k, :]], dim=-2)
            k *= 2
        hc = bx + a * h                                          # (b,g,d,lc,n)
        h = hc[..., -1:, :]
        ys.append(torch.einsum("bgdln,bgnl->bgdl", hc, C[..., s:s + chunk_size]))
    return _add_d(torch.cat(ys, dim=-1), u, D)
