"""Selective scan (Mamba S6 recurrence) in plain PyTorch.

Counterpart of ``mlagg_unet_tpu/ops/selective_scan.py`` with the same
contract. Per batch b, group g, channel d, state n and step l::

    delta = softplus(delta_raw + delta_bias)          [if delta_softplus]
    h_l   = exp(delta_l * A) * h_{l-1} + delta_l * B_l * u_l
    y_l   = sum_n C_l[n] * h_l[n] + D * u_l

u, delta: (b, g, d, l); A: (g, d, n); B, C: (b, g, n, l); D, delta_bias:
(g, d) or None. All arithmetic is fp32 and y is fp32 whatever the input
dtype, except that an fp64 u makes both fp64 (a reference for the fp32
scan). ``reverse=True`` scans right to left and returns y at the natural
positions.

``selective_scan`` is the vectorised chunked form: a log-depth doubling scan
inside each chunk and a loop over chunks for the carried state. It is the
plain twin of the CUDA forward kernel (``selective_scan_cuda.py``) and the
CPU path. ``selective_scan_seq_ref`` is the step-by-step ground truth for
tests.

``selective_scan_bwd_plain`` is the backward: the adjoint of the linear
recurrence is the reversed recurrence ``g_t = gy_t C_t + a_{t+1} g_{t+1}``
(``a_t = exp(delta_t A)``), run chunk by chunk from the scan's end with h
recomputed per chunk from the chunk's saved start state, as the Pallas
backward does (``selective_scan_pallas.py:30-36``). It builds no autograd
graph, so its memory is a few chunk-sized tensors at any length. It is the
plain twin of the CUDA backward kernel and the CPU backward.
``selective_scan_bwd_tiled_plain`` computes the same gradients decomposed as
the CUDA backward decomposes them (a pass per tile with zero carry-in, the
carry across tiles, the gradients per tile from its carry), vectorised over
tiles; the tests and ``chip_smoke.py`` hold the kernel's design against it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus == logaddexp(x, 0); torch's threshold=20 shortcut
    # differs from it by < 2e-9, so use the exact form
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _work_dtype(u: torch.Tensor) -> torch.dtype:
    """The arithmetic's dtype: fp32, or fp64 where u is fp64."""
    return torch.promote_types(u.dtype, torch.float32)


def _prep(u, delta, A, B, C, delta_bias, delta_softplus):
    b, g, d, l = u.shape
    n = A.shape[-1]
    if A.shape != (g, d, n):
        raise ValueError(f"A shape {tuple(A.shape)} != {(g, d, n)}")
    if B.shape != (b, g, n, l) or C.shape != (b, g, n, l):
        raise ValueError(f"B/C shape {tuple(B.shape)}/{tuple(C.shape)} != {(b, g, n, l)}")
    wd = _work_dtype(u)
    u, delta, A, B, C = (t.to(wd) for t in (u, delta, A, B, C))
    if delta_bias is not None:
        delta = delta + delta_bias.to(delta.dtype)[None, :, :, None]
    if delta_softplus:
        delta = _softplus(delta)
    return u, delta, A, B, C


def _add_d(y, u, D):
    if D is not None:
        y = y + D.to(u.dtype)[None, :, :, None] * u
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


def default_chunk(l: int) -> int:
    """The plain scans' chunk: 256 steps, or more where L is long so that a
    row walks at most 64 chunks (the loop over chunks is their cost on a
    card: 16,384-step chunks at L = 1,048,576)."""
    return max(256, 1 << max(0, (l - 1).bit_length() - 6))


def _linear_scan(a, bx, h0):
    """h_k = a_k h_{k-1} + bx_k along axis -2 with h_{-1} = h0, for every k:
    an inclusive doubling scan of (a, bx) under (a1, b1) . (a2, b2) =
    (a1 a2, b1 a2 + b2). a, bx: (..., lc, n); h0: (..., 1, n)."""
    lc = a.shape[-2]
    k = 1
    while k < lc:
        bx = torch.cat([bx[..., :k, :], bx[..., k:, :] + a[..., k:, :] * bx[..., :-k, :]], dim=-2)
        a = torch.cat([a[..., :k, :], a[..., k:, :] * a[..., :-k, :]], dim=-2)
        k *= 2
    return bx + a * h0


def _chunk(u, dt, A, B, s, chunk_size):
    """a = exp(dt A) and bx = dt u B over steps [s, s + chunk_size),
    each (b, g, d, lc, n)."""
    dtc = dt[..., s:s + chunk_size]                              # (b,g,d,lc)
    a = torch.exp(dtc[..., None] * A[None, :, :, None, :])
    bx = (dtc * u[..., s:s + chunk_size])[..., None] * \
        B[..., s:s + chunk_size].transpose(-1, -2)[:, :, None]
    return a, bx


def _scan_chunks(u, dt, A, B, chunk_size):
    """Walk the prepped forward-direction scan chunk by chunk: yields
    (start, h at the chunk's entry (b, g, d, 1, n), h at every step of the
    chunk (b, g, d, lc, n))."""
    b, g, d, l = u.shape
    h = u.new_zeros(b, g, d, 1, A.shape[-1])
    for s in range(0, l, chunk_size):
        hc = _linear_scan(*_chunk(u, dt, A, B, s, chunk_size), h)
        yield s, h, hc
        h = hc[..., -1:, :]


def _flip_l(*ts):
    return tuple(t.flip(-1) for t in ts)


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus: bool = False, chunk_size: Optional[int] = None,
                   reverse: bool = False) -> torch.Tensor:
    """Chunked scan: doubling scan within each chunk (``default_chunk``
    steps unless given), state carried across chunks. Returns (b, g, d, l)
    fp32."""
    chunk_size = chunk_size or default_chunk(u.shape[-1])
    if reverse:
        u, delta, B, C = _flip_l(u, delta, B, C)
        return selective_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                              chunk_size).flip(-1)
    u, delta, A, B, C = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    ys = [torch.einsum("bgdln,bgnl->bgdl", hc, C[..., s:s + chunk_size])
          for s, _, hc in _scan_chunks(u, delta, A, B, chunk_size)]
    return _add_d(torch.cat(ys, dim=-1), u, D)


@torch.no_grad()
def selective_scan_fwd_tiled_plain(u, delta, A, B, C, D=None, delta_bias=None,
                                   delta_softplus: bool = False,
                                   reverse: bool = False, tile: int = 64,
                                   with_states: bool = False):
    """y of ``selective_scan``, decomposed as the CUDA forward (K1)
    decomposes it, over tiles of ``tile`` steps in scan order (the last one
    ragged, padded with steps that change nothing: delta = 0, so a = 1 and
    no input). With a_t = exp(delta_t A), vectorised over tiles:

    1. per tile i, the scan from a zero entry state: its end state X_i, and
       its decay P_i = exp(A * sum_t delta_t), formed from the sum of delta
       as the kernel forms it (not as the product of the a_t);
    2. the state entering each tile in scan order, h_0 = 0 and
       h_{i+1} = X_i + P_i h_i;
    3. per tile, the scan again from h_i, and y = C . h + D u.

    K1's groups of 64-step tiles are this function's tiles of 64 * k steps.
    Returns y (fp32 (b, g, d, l)), and with ``with_states`` also the entry
    states (fp32 (b, g, ceil(l / tile), d, n), in scan order, as
    ``selective_scan_states(..., every=tile)``)."""
    if reverse:
        u, delta, B, C = _flip_l(u, delta, B, C)
        out = selective_scan_fwd_tiled_plain(u, delta, A, B, C, D, delta_bias,
                                             delta_softplus, False, tile, with_states)
        return (out[0].flip(-1), out[1]) if with_states else out.flip(-1)
    u32, dt, A32, B32, C32 = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    b, g, d, l = u32.shape
    n = A32.shape[-1]
    nt = -(-l // tile)

    def tiles(x):  # (..., l) -> (..., nt, tile), zeros after step l
        return F.pad(x, (0, nt * tile - l)).unflatten(-1, (nt, tile))

    def steps(x):  # (b, g, n, l) -> (b, g, 1, nt, tile, n)
        return tiles(x).permute(0, 1, 3, 4, 2)[:, :, None]

    dtt = tiles(dt)
    a = torch.exp(dtt[..., None] * A32[None, :, :, None, None, :])  # (b,g,d,nt,tile,n)
    bx = (dtt * tiles(u32))[..., None] * steps(B32)
    # 1. from a zero entry state
    X = _linear_scan(a, bx, a.new_zeros(b, g, d, nt, 1, n))[..., -1, :]   # (b,g,d,nt,n)
    P = torch.exp(dtt.sum(-1)[..., None] * A32[None, :, :, None, :])
    # 2. the entry state of each tile
    h_in = torch.empty_like(X)
    h = X.new_zeros(b, g, d, n)
    for i in range(nt):
        h_in[..., i, :] = h
        h = X[..., i, :] + P[..., i, :] * h
    # 3. the rescan from it
    hs = _linear_scan(a, bx, h_in[..., None, :])
    y = torch.einsum("bgdtkn,bgxtkn->bgdtk", hs, steps(C32)).flatten(-2)[..., :l]
    y = _add_d(y, u32, D)
    return (y, h_in.transpose(2, 3).contiguous()) if with_states else y


def selective_scan_states(u, delta, A, B, C, delta_bias=None,
                          delta_softplus: bool = False, every: int = 64,
                          reverse: bool = False) -> torch.Tensor:
    """The scan's state at the entry of each ``every``-step tile, in scan
    order: fp32 (b, g, ceil(l / every), d, n). Tile i of a forward scan
    starts at step i * every; a reverse scan's tiles are counted from the
    right end, so tile i ends at l - i * every and its entry state is the one
    at its right edge. The first tile's entry state is 0."""
    if reverse:
        u, delta, B, C = _flip_l(u, delta, B, C)
    u, delta, A, B, C = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    return torch.stack([h[..., 0, :] for _, h, _ in
                        _scan_chunks(u, delta, A, B, every)], dim=2)


@torch.no_grad()
def selective_scan_bwd_plain(u, delta, A, B, C, D=None, delta_bias=None,
                             delta_softplus: bool = False,
                             reverse: bool = False, gy=None,
                             chunk_size: Optional[int] = None):
    """Gradients of ``selective_scan`` for the output gradient ``gy``
    (b, g, d, l): (du, ddelta, dA, dB, dC, dD, ddelta_bias), each in its
    input's dtype (dD, ddelta_bias None where D, delta_bias are None).
    fp32 arithmetic (fp64 for an fp64 u), no autograd graph; chunks of
    ``default_chunk`` steps unless given."""
    chunk_size = chunk_size or default_chunk(u.shape[-1])
    if reverse:
        u, delta, B, C, gy = _flip_l(u, delta, B, C, gy)
        du, ddt, dA, dB, dC, dD, dbias = selective_scan_bwd_plain(
            u, delta, A, B, C, D, delta_bias, delta_softplus, False, gy,
            chunk_size)
        du, ddt, dB, dC = _flip_l(du, ddt, dB, dC)
        return du, ddt, dA, dB, dC, dD, dbias
    dtypes = [None if t is None else t.dtype
              for t in (u, delta, A, B, C, D, delta_bias)]
    pre = delta.to(_work_dtype(u))
    if delta_bias is not None:
        pre = pre + delta_bias.to(pre.dtype)[None, :, :, None]
    u32, dt, A32, B32, C32 = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    gy = gy.to(u32.dtype)
    b, g, d, l = u.shape
    n = A.shape[-1]
    starts = [(s, h) for s, h, _ in _scan_chunks(u32, dt, A32, B32, chunk_size)]
    du, ddt = torch.empty_like(u32), torch.empty_like(u32)
    dB, dC = torch.empty_like(B32), torch.empty_like(C32)
    dA = A32.new_zeros(g, d, n)
    a_carry = g_carry = u32.new_zeros(b, g, d, 1, n)  # the step after the chunk
    for s, h0 in reversed(starts):
        sl = slice(s, s + chunk_size)
        a, bx = _chunk(u32, dt, A32, B32, s, chunk_size)
        h = _linear_scan(a, bx, h0)                          # (b,g,d,lc,n)
        h_prev = torch.cat([h0, h[..., :-1, :]], dim=-2)
        # adjoint g_t = gy_t C_t + a_{t+1} g_{t+1}, solved right to left
        G = gy[..., sl, None] * C32[..., sl].transpose(-1, -2)[:, :, None]
        a_next = torch.cat([a[..., 1:, :], a_carry], dim=-2)
        gc = _linear_scan(a_next.flip(-2), G.flip(-2), g_carry).flip(-2)
        a_carry, g_carry = a[..., :1, :], gc[..., :1, :]
        dda = gc * h_prev * a                                # d/d(delta A)
        gB = torch.einsum("bgdln,bgnl->bgdl", gc, B32[..., sl])
        dtc = dt[..., sl]
        du[..., sl] = dtc * gB
        dd = u32[..., sl] * gB + torch.einsum("bgdln,gdn->bgdl", dda, A32)
        if delta_softplus:
            dd = dd * torch.sigmoid(pre[..., sl])
        ddt[..., sl] = dd
        dB[..., sl] = torch.einsum("bgdln,bgdl->bgnl", gc, dtc * u32[..., sl])
        dC[..., sl] = torch.einsum("bgdln,bgdl->bgnl", h, gy[..., sl])
        dA += torch.einsum("bgdln,bgdl->gdn", dda, dtc)
    dD = None
    if D is not None:
        du += D.to(gy.dtype)[None, :, :, None] * gy
        dD = (gy * u32).sum((0, 3))
    dbias = None if delta_bias is None else ddt.sum((0, 3))
    grads = (du, ddt, dA, dB, dC, dD, dbias)
    return tuple(None if t is None else t.to(dt_) for t, dt_ in zip(grads, dtypes))


@torch.no_grad()
def selective_scan_bwd_tiled_plain(u, delta, A, B, C, D=None, delta_bias=None,
                                   delta_softplus: bool = False,
                                   reverse: bool = False, gy=None, tile: int = 64):
    """The gradients of ``selective_scan_bwd_plain``, decomposed as the CUDA
    backward (K5) decomposes them, over tiles of ``tile`` steps in scan order
    (the last one ragged, padded with steps that change nothing: delta, u,
    gy, B, C = 0). With a_t = exp(delta_t A) and g the adjoint
    g_t = gy_t C_t + a_{t+1} g_{t+1}, vectorised over tiles:

    1. per tile i, the adjoint with zero carry-in, X_i = a_s g_s at its first
       step s and P_i = prod_t a_t over it;
    2. the carry into each tile from the scan's end, c_last = 0 and
       c_{i-1} = X_i + P_i c_i (c_i = a g at the step after tile i);
    3. per tile, the adjoint again from g = c_i and a_next = 1, h from the
       tile's entry state, and the gradients.

    K5's groups of 64-step tiles are this function's tiles of 64 * k steps.
    Returns what ``selective_scan_bwd_plain`` returns."""
    if reverse:
        u, delta, B, C, gy = _flip_l(u, delta, B, C, gy)
        du, ddt, dA, dB, dC, dD, dbias = selective_scan_bwd_tiled_plain(
            u, delta, A, B, C, D, delta_bias, delta_softplus, False, gy, tile)
        du, ddt, dB, dC = _flip_l(du, ddt, dB, dC)
        return du, ddt, dA, dB, dC, dD, dbias
    dtypes = [None if t is None else t.dtype
              for t in (u, delta, A, B, C, D, delta_bias)]
    pre = delta.to(_work_dtype(u))
    if delta_bias is not None:
        pre = pre + delta_bias.to(pre.dtype)[None, :, :, None]
    u32, dt, A32, B32, C32 = _prep(u, delta, A, B, C, delta_bias, delta_softplus)
    gy = gy.to(u32.dtype)
    b, g, d, l = u.shape
    n = A.shape[-1]
    nt = -(-l // tile)

    def tiles(x):  # (..., l) -> (..., nt, tile), zeros after step l
        return F.pad(x, (0, nt * tile - l)).unflatten(-1, (nt, tile))

    def steps(x):  # (b, g, n, l) -> (b, g, 1, nt, tile, n)
        return tiles(x).permute(0, 1, 3, 4, 2)[:, :, None]

    ut, dtt, gyt, Bs, Cs = tiles(u32), tiles(dt), tiles(gy), steps(B32), steps(C32)
    a = torch.exp(dtt[..., None] * A32[None, :, :, None, None, :])  # (b,g,d,nt,tile,n)
    G = gyt[..., None] * Cs
    zero = a.new_zeros(b, g, d, nt, 1, n)

    def adjoint(a_last, carry):  # g in every step of every tile, right to left
        a_next = torch.cat([a[..., 1:, :], a_last], dim=-2)
        return _linear_scan(a_next.flip(-2), G.flip(-2), carry).flip(-2)

    # 1. zero carry-in
    g0 = adjoint(zero, zero)
    X, P = a[..., 0, :] * g0[..., 0, :], a.prod(-2)                  # (b,g,d,nt,n)
    # 2. the carry into each tile
    c = torch.empty_like(X)
    carry = X.new_zeros(b, g, d, n)
    for i in range(nt - 1, -1, -1):
        c[..., i, :] = carry
        carry = X[..., i, :] + P[..., i, :] * carry
    # 3. per tile from its carry; h from the tile-entry states
    gc = adjoint(torch.ones_like(zero), c[..., None, :])
    bx = (dtt * ut)[..., None] * Bs
    h_local = _linear_scan(a, bx, zero)
    entry = torch.empty_like(X)
    h = X.new_zeros(b, g, d, n)
    for i in range(nt):
        entry[..., i, :] = h
        h = h_local[..., i, -1, :] + P[..., i, :] * h
    h = h_local + a.cumprod(-2) * entry[..., None, :]
    h_prev = torch.cat([entry[..., None, :], h[..., :-1, :]], dim=-2)
    dda = gc * h_prev * a                                            # d/d(delta A)
    gB = torch.einsum("bgdtkn,bgxtkn->bgdtk", gc, Bs)
    dd = ut * gB + torch.einsum("bgdtkn,gdn->bgdtk", dda, A32)
    if delta_softplus:
        dd = dd * torch.sigmoid(tiles(pre))

    def untile(x):
        return x.flatten(-2)[..., :l]

    du, ddt = untile(dtt * gB), untile(dd)
    dB = untile(torch.einsum("bgdtkn,bgdtk->bgntk", gc, dtt * ut))
    dC = untile(torch.einsum("bgdtkn,bgdtk->bgntk", h, gyt))
    dA = torch.einsum("bgdtkn,bgdtk->gdn", dda, dtt)
    dD = None
    if D is not None:
        du = du + D.to(gy.dtype)[None, :, :, None] * gy
        dD = (gy * u32).sum((0, 3))
    dbias = None if delta_bias is None else ddt.sum((0, 3))
    grads = (du, ddt, dA, dB, dC, dD, dbias)
    return tuple(None if t is None else t.to(dt_) for t, dt_ in zip(grads, dtypes))
