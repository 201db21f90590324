"""Cubic B-spline interpolation on tensors of any device, scipy's order-3
semantics (counterpart of ``mlagg_unet_tpu/ops/cubic_spline.py``).

``scipy.ndimage.map_coordinates(order=3, mode='constant', cval)`` is what the
reference's default augmentation resamples data with (nnUNetTrainer.py:649):

  * prefilter: the cubic B-spline coefficients with the MIRROR boundary
    (scipy applies the mirror-boundary filter for mode='constant');
  * interpolation: 4 taps per axis with the cubic B-spline weights, the taps
    mirror-folded at the edges;
  * mode='constant': a point whose coordinate lies outside [0, n - 1] on any
    axis gives cval.

The prefilter along an axis of n >= 2 samples is one matrix product: the
coefficients c solve (c[i-1] + 4 c[i] + c[i+1]) / 6 = x[i] with c[-1] = c[1]
and c[n] = c[n-2], so c = M x with M the inverse of that tridiagonal system,
computed once per n in float64 and applied in float32. JAX runs the same
filter as two first-order recurrences (a causal and an anticausal
``associative_scan``); both are the exact mirror-boundary filter, and they
differ by float32 rounding. At n = 1 JAX returns 6·x (scipy returns x), and
so does the port.

The 4^dim-tap gather folds the sample and channel into the gather index: one
gather per tap for a whole batch. The order-0 and order-1 samplers
(``nearest_sample``, ``linear_sample``) follow
``jax.scipy.ndimage.map_coordinates``: order 0 rounds half away from zero
(``torch.round`` rounds half to even), order 1 adds each corner's
``weight * (value or cval)`` in ``itertools.product`` order.

Everything here is plain PyTorch; nothing launches a kernel of the port's own.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

_GAIN = 6.0   # JAX's prefilter gain, returned alone at n = 1


@functools.lru_cache(maxsize=32)
def _prefilter_matrix(n: int, device: torch.device) -> torch.Tensor:
    """M with c = M x the mirror-boundary cubic B-spline coefficients of x
    (n >= 2), float32 on ``device`` (read only)."""
    a = np.zeros((n, n))
    idx = np.arange(n)
    a[idx, idx] = 4.0
    a[idx[1:], idx[:-1]] = 1.0
    a[idx[:-1], idx[1:]] = 1.0
    a[0, 1] += 1.0          # c[-1] = c[1]
    a[n - 1, n - 2] += 1.0  # c[n] = c[n-2]
    return torch.from_numpy(np.linalg.inv(a / 6.0).astype(np.float32)).to(device)


def spline_filter_cubic_1d(x: torch.Tensor) -> torch.Tensor:
    """Cubic spline prefilter along the last axis, mirror boundary (scipy's
    ``spline_filter1d(order=3, mode='mirror')``), float32. n = 1 gives 6·x,
    as JAX's does."""
    n = x.shape[-1]
    if n == 1:
        return x * _GAIN
    m = _prefilter_matrix(n, x.device)
    return torch.matmul(x.float(), m.t())


def spline_filter_cubic(x: torch.Tensor, first_axis: int = 0) -> torch.Tensor:
    """Prefilter over every axis of x from ``first_axis`` on (the leading
    ones are batch axes)."""
    for ax in range(first_axis, x.ndim):
        x = spline_filter_cubic_1d(x.movedim(ax, -1)).movedim(-1, ax)
    return x


def _cubic_weights(f: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 4 cubic B-spline weights of fractional position f in [0, 1): taps
    at floor - 1, floor, floor + 1, floor + 2."""
    f2 = f * f
    f3 = f2 * f
    omf = 1.0 - f
    return (omf * omf * omf / 6.0,
            (4.0 - 6.0 * f2 + 3.0 * f3) / 6.0,
            (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) / 6.0,
            f3 / 6.0)


def _mirror_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Fold an index into [0, n - 1] by mirroring about the edge samples
    (period 2n - 2, scipy's 'mirror' extension)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = torch.remainder(idx.abs(), period)
    return torch.where(idx >= n, period - idx, idx)


def _strides(shape: Sequence[int]) -> List[int]:
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return out[::-1]


def _gather(values: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """values (B, C, S), addr (B, P) -> (B, C, P)."""
    b, c, _ = values.shape
    return torch.gather(values, 2, addr[:, None, :].expand(b, c, addr.shape[-1]))


def cubic_sample(coeffs: torch.Tensor, coords: torch.Tensor,
                 cval: float = 0.0) -> torch.Tensor:
    """The batched order-3 sampler on prefiltered coefficients: coeffs
    (B, C, *shape), coords (B, dim, P) float32 -> (B, C, P) float32."""
    b, c = coeffs.shape[:2]
    shape = coeffs.shape[2:]
    dim = len(shape)
    strides = _strides(shape)
    flat = coeffs.reshape(b, c, -1)
    addrs, weights, valid = [], [], None
    for ax in range(dim):
        co = coords[:, ax]
        fl = torch.floor(co)
        base = fl.long() - 1
        weights.append(_cubic_weights(co - fl))
        addrs.append([_mirror_index(base + k, shape[ax]) * strides[ax] for k in range(4)])
        v = (co >= 0) & (co <= shape[ax] - 1)
        valid = v if valid is None else valid & v
    out = None
    for tap in range(4 ** dim):
        t, addr, w = tap, None, None
        for ax in range(dim):    # axis 0 varies fastest, as in JAX
            k = t % 4
            t //= 4
            addr = addrs[ax][k] if addr is None else addr + addrs[ax][k]
            w = weights[ax][k] if w is None else w * weights[ax][k]
        term = w[:, None, :] * _gather(flat, addr)
        out = term if out is None else out + term
    return torch.where(valid[:, None, :], out, torch.full_like(out, cval))


def map_coordinates_cubic(x: torch.Tensor, coords: Sequence[torch.Tensor],
                          cval: float = 0.0, prefiltered: bool = False) -> torch.Tensor:
    """``scipy.ndimage.map_coordinates(x, coords, order=3, mode='constant',
    cval=cval)``: x a dim-D tensor, coords dim tensors of one shape S;
    returns S, float32. ``prefiltered=True`` takes x as the coefficients
    (``spline_filter_cubic(x)``)."""
    assert len(coords) == x.ndim
    c = x.float() if prefiltered else spline_filter_cubic(x)
    out_shape = coords[0].shape
    pts = torch.stack([co.float().reshape(-1) for co in coords])[None]
    return cubic_sample(c[None, None], pts, cval)[0, 0].reshape(out_shape)


def round_half_away_from_zero(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest integer, halves away from zero (``lax.round``,
    which ``jax.scipy.ndimage.map_coordinates(order=0)`` uses)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def _linear_corners(coords: torch.Tensor, shape: Sequence[int]):
    """The 2^dim corners of order-1 sampling at coords (B, dim, P), in
    ``itertools.product`` order (the last axis fastest): (flat address, all
    axes in range, product of the axes' weights in axis order)."""
    strides = _strides(shape)
    per_axis = []
    for ax, n in enumerate(shape):
        co = coords[:, ax]
        lower = torch.floor(co)
        upper_w = co - lower
        lower_w = 1 - upper_w
        i0 = lower.long()
        per_axis.append([(i, (i >= 0) & (i < n), w) for i, w in ((i0, lower_w), (i0 + 1, upper_w))])
    for items in itertools.product(*per_axis):
        addr, valid, w = None, None, None
        for ax, (i, v, wt) in enumerate(items):
            a = i.clamp(0, shape[ax] - 1) * strides[ax]
            addr = a if addr is None else addr + a
            valid = v if valid is None else valid & v
            w = wt if w is None else w * wt
        yield addr, valid, w


def linear_sample(values: torch.Tensor, coords: torch.Tensor,
                  cval: float = 0.0) -> torch.Tensor:
    """Batched ``jax.scipy.ndimage.map_coordinates(order=1, mode='constant')``:
    values (B, C, *shape), coords (B, dim, P) -> (B, C, P) float32."""
    b, c = values.shape[:2]
    flat = values.float().reshape(b, c, -1)
    out = None
    for addr, valid, w in _linear_corners(coords, values.shape[2:]):
        g = torch.where(valid[:, None, :], _gather(flat, addr), torch.full((), cval))
        term = w[:, None, :] * g
        out = term if out is None else out + term
    return out


def nearest_sample(values: torch.Tensor, coords: torch.Tensor,
                   cval: float = 0.0) -> torch.Tensor:
    """Batched ``jax.scipy.ndimage.map_coordinates(order=0, mode='constant')``:
    values (B, C, *shape), coords (B, dim, P) -> (B, C, P), the values'
    dtype."""
    b, c = values.shape[:2]
    shape = values.shape[2:]
    strides = _strides(shape)
    addr, valid = None, None
    for ax, n in enumerate(shape):
        i = round_half_away_from_zero(coords[:, ax]).long()
        v = (i >= 0) & (i < n)
        a = i.clamp(0, n - 1) * strides[ax]
        addr = a if addr is None else addr + a
        valid = v if valid is None else valid & v
    g = _gather(values.reshape(b, c, -1), addr)
    return torch.where(valid[:, None, :], g, torch.full((), cval, dtype=g.dtype))


def seg_onehot_linear_sample(seg: torch.Tensor, coords: torch.Tensor, num_classes: int,
                             cval: float = -1.0) -> torch.Tensor:
    """Batched ``map_coordinates_seg_linear_onehot``: seg (B, *shape) of
    label ids, coords (B, dim, P) -> (B, P) float32. Each corner's labels are
    gathered once and scored for every label."""
    b = seg.shape[0]
    flat = seg.reshape(b, -1)
    corners = [(torch.gather(flat, 1, addr), valid, w)
               for addr, valid, w in _linear_corners(coords, seg.shape[1:])]
    out = torch.zeros(coords[:, 0].shape, dtype=torch.float32, device=seg.device)
    cv = torch.full((), cval)
    for lab in range(num_classes):
        score = None
        for g, valid, w in corners:
            term = w * torch.where(valid, (g == lab).float(), cv)
            score = term if score is None else score + term
        out = torch.where(score >= 0.5, torch.full((), float(lab)), out)
    return out


def map_coordinates_seg_linear_onehot(seg: torch.Tensor, coords: Sequence[torch.Tensor],
                                      num_classes: int, cval: float = -1.0) -> torch.Tensor:
    """batchgenerators ``interpolate_img(is_seg=True, order=1)``: each label
    in ascending order is interpolated as a one-hot channel at order 1
    (out-of-range corners add cval to the score), and positions scoring
    >= 0.5 take that label; positions where no label reaches 0.5 stay 0.
    Returns float32 of the coords' shape."""
    assert len(coords) == seg.ndim
    pts = torch.stack([co.float().reshape(-1) for co in coords])[None]
    return seg_onehot_linear_sample(seg[None], pts, num_classes, cval)[0].reshape(
        coords[0].shape)


def lowres_axis_cubic_up(x: torch.Tensor, t, axis: int) -> torch.Tensor:
    """Nearest downsample to length t, then cubic upsample back, along
    ``axis``: the reference SimulateLowResolutionTransform's down (order 0)
    and up (order 3) pair under scipy ``zoom(mode='nearest',
    grid_mode=True)``. ``t`` is a number, or a tensor with one length per
    index of x's first axis (then ``axis`` >= 1).

    The downsampled signal is edge-extended into a buffer of n + 24 samples
    (scipy prepads 12 for mode='nearest'), prefiltered with the mirror
    boundary, and sampled with clamped taps. The downsample rounds
    floor(c + 0.5), as scipy's order 0 does."""
    xm = x.movedim(axis, -1).float()
    n = xm.shape[-1]
    tf = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    if tf.ndim:
        assert axis != 0 and tf.shape == (x.shape[0],)
        tf = tf.reshape(-1, *([1] * (xm.ndim - 1)))
    i = torch.arange(n, dtype=torch.float32, device=x.device)
    i_e = torch.minimum(i, tf - 1)
    src = torch.clamp(torch.floor((i_e + 0.5) * n / tf), 0, n - 1).long()
    d_ext = torch.gather(xm, -1, src.expand(xm.shape))

    pad = 12
    coeffs = spline_filter_cubic_1d(torch.cat(
        [d_ext[..., :1].expand(*xm.shape[:-1], pad), d_ext,
         d_ext[..., -1:].expand(*xm.shape[:-1], pad)], dim=-1))   # (..., n + 24)

    pcoord = (i + 0.5) * tf / n - 0.5
    fl = torch.floor(pcoord)
    w = _cubic_weights(pcoord - fl)
    base = fl.long() - 1 + pad
    y = torch.zeros_like(d_ext)
    for k in range(4):
        idx = torch.clamp(base + k, 0, n + 2 * pad - 1).expand(xm.shape)
        y = y + w[k] * torch.gather(coeffs, -1, idx)
    return y.movedim(-1, axis)

