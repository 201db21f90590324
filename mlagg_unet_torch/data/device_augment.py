"""On-device training augmentation, ``MLAGG_DEVICE_AUG`` (counterpart of
``mlagg_unet_tpu/data/device_augment.py``).

The host pipeline (``data/augment.py``) is the semantics reference, and it is
host-bound: a 3-D batch costs seconds of single-core NumPy/SciPy. Here the
loader's workers only crop the inflated patch, and the transform stack of
``TrainingTransforms`` runs on the batch where it lies (the card in
training), in plain PyTorch: spatial (rotation, scale, centre crop), noise,
blur, brightness, contrast, low resolution, gamma (inverted, then plain),
mirror and ``RemoveLabelTransform`` last, with the host stack's
probabilities and ranges.

Two interpolation profiles, as in JAX (``parse_device_aug_flag``):
  * ``ord3`` (or ``1``): the reference default, scipy-exact: order-3 cubic
    spline data, order-1 one-hot seg, order-3 low-resolution upsample
    (``ops/cubic_spline.py``);
  * ``ord1``: order-1 data, order-0 seg, order-1 upsample (a named opt-in:
    it differs from nnUNetTrainer.py:649-650).

The draws. JAX draws every parameter with per-sample ``jax.random`` keys,
computes each gated transform and selects (``jnp.where``). The port draws
the same parameters (one value per sample, or per sample and channel, from
the same ranges) on the host from a CPU ``torch.Generator`` and computes a
transform only for the samples or channels its gate selects; the noise is
drawn on the batch's device from a generator there. No draw reads the
device, so a batch costs no host sync. The streams differ from JAX's by
construction; the tests hold the maths with forced parameters (a gate
probability above 1, degenerate ranges), as ``tests/test_device_augment.py``
does.

Every transform takes the batch: data (B, C, *spatial) float32, seg
(B, *spatial), and returns new tensors (the input is not written).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from mlagg_unet_torch.ops.cubic_spline import (
    cubic_sample,
    linear_sample,
    lowres_axis_cubic_up,
    nearest_sample,
    seg_onehot_linear_sample,
    spline_filter_cubic,
)


def parse_device_aug_flag(value: str) -> str:
    """The ``MLAGG_DEVICE_AUG`` gate: '' (off, for '' and '0'), 'ord3' (for
    'ord3' and '1') or 'ord1'; any other value raises."""
    if not value or value == "0":
        return ""
    if value in ("ord1", "ord3", "1"):
        return "ord3" if value == "1" else value
    raise ValueError(
        f"MLAGG_DEVICE_AUG={value!r}: set 'ord3' (or '1') for on-device augmentation "
        "with the reference-default interpolation semantics (order-3 data / order-1 "
        "one-hot seg, scipy-exact), 'ord1' to explicitly opt into the faster order-1 "
        "data / order-0 seg profile (differs from the reference default, "
        "nnUNetTrainer.py:649-650), or unset it for the host pipeline.")


def _uniform(gen: torch.Generator, shape=(), lo: float = 0.0, hi: float = 1.0
             ) -> torch.Tensor:
    """float32 uniform draws in [lo, hi) on the host (lo where lo == hi)."""
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to a card through pinned memory, so the
    copy does not wait for the work queued ahead of it."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _selected(mask: torch.Tensor, device: torch.device):
    """The indices where a host mask is set: on the host (for the host's
    parameters) and on ``device`` (for the batch); None where none is."""
    host = mask.nonzero(as_tuple=True)
    if not len(host[0]):
        return None, None
    return host, tuple(_to(i, device) for i in host)


def _rot2d(a: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 2, 2)."""
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _rot3d(ax: torch.Tensor, ay: torch.Tensor, az: torch.Tensor) -> torch.Tensor:
    """batchgenerators' create_matrix_rotation chain I @ Rx @ Ry @ Rz for
    (B,) angles -> (B, 3, 3) (``augment._rot_matrix_3d``)."""
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return rx @ ry @ rz


def spatial_augment_device(data: torch.Tensor, seg: torch.Tensor, gen: torch.Generator,
                           patch_size: Sequence[int], rotation_for_da: dict,
                           scale_range=(0.7, 1.4), p_rot: float = 0.2, p_scale: float = 0.2,
                           order_data: int = 1, order_seg: int = 0, num_classes: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """data (B, C, *inflated), seg (B, *inflated) -> the centre patch (B, C,
    *patch) float32 and (B, *patch) float32 with the host coordinate chain
    (``augment.spatial_augment``): the rotation applied transposed, the
    zoom-out-biased scale, the centre crop. ``order_data=3, order_seg=1``
    is the reference default (``num_classes`` for the one-hot seg)."""
    b, dim = data.shape[0], len(patch_size)
    dev = data.device
    do_rot = _uniform(gen, (b,)) < p_rot
    do_scale = _uniform(gen, (b,)) < p_scale
    if dim == 2:
        rot = _rot2d(_uniform(gen, (b,), *rotation_for_da["x"]))
    else:
        rot = _rot3d(*(_uniform(gen, (b,), *rotation_for_da[k]) for k in ("x", "y", "z")))
    # zoom-out-biased scale (augment.py:131-137); JAX draws lo and hi from one key
    branch = _uniform(gen, (b,)) < 0.5
    u = _uniform(gen, (b,))
    top = max(scale_range[0], 1.0)
    lo = u * (1.0 - scale_range[0]) + scale_range[0]
    hi = u * (scale_range[1] - top) + top
    sc = torch.where(branch & (scale_range[0] < 1), lo, hi)

    axes = [torch.arange(s, dtype=torch.float32, device=dev) - (s - 1) / 2 for s in patch_size]
    grid = torch.stack([g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")])
    coords = grid.expand(b, *grid.shape)
    if do_rot.any():
        # transposed application (coords^T @ M), as the host path
        rotated = torch.matmul(_to(rot.transpose(1, 2).contiguous(), dev), grid)
        coords = torch.where(_to(do_rot, dev)[:, None, None], rotated, coords)
    if do_scale.any():
        coords = torch.where(_to(do_scale, dev)[:, None, None],
                             coords * _to(sc, dev)[:, None, None], coords)
    ctr = _to(torch.tensor([(s - 1) / 2 for s in data.shape[2:]], dtype=torch.float32), dev)
    coords = coords + ctr[:, None]

    if order_data == 3:
        out_data = cubic_sample(spline_filter_cubic(data.float(), first_axis=2), coords, 0.0)
    else:
        out_data = linear_sample(data, coords, 0.0)
    if order_seg == 1:
        if num_classes <= 0:
            raise ValueError("order_seg=1 (the one-hot seg pass) needs num_classes")
        out_seg = seg_onehot_linear_sample(seg, coords, num_classes, -1.0)
    else:
        out_seg = nearest_sample(seg[:, None], coords, -1)[:, 0].float()
    return (out_data.reshape(*data.shape[:2], *patch_size),
            out_seg.reshape(b, *patch_size))


def gaussian_noise_device(data: torch.Tensor, gen: torch.Generator,
                          noise_gen: torch.Generator, p: float = 0.1,
                          noise_variance=(0.0, 0.1)) -> torch.Tensor:
    b = data.shape[0]
    take = _uniform(gen, (b,)) < p
    var = _uniform(gen, (b,), *noise_variance)
    sel, dsel = _selected(take, data.device)
    if sel is None:
        return data
    std = _to(var[sel].sqrt(), data.device).reshape(-1, *([1] * (data.ndim - 1)))
    noise = torch.randn((len(sel[0]), *data.shape[1:]), generator=noise_gen,
                        device=data.device) * std
    return data.index_put(dsel, data[dsel] + noise)


def _gauss_kernels(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """(G,) sigmas -> (G, 2 radius + 1) normalised Gaussian taps, float32."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    w = torch.exp(-0.5 * (x / sigma[:, None]) ** 2)
    return w / w.sum(-1, keepdim=True)


def _symmetric_index(n: int, radius: int, device) -> torch.Tensor:
    """numpy's 'symmetric' padding (scipy's 'reflect') of an axis of n by
    radius on each side, as indices (period 2n)."""
    j = torch.remainder(torch.arange(-radius, n + radius, device=device), 2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def _blur_axis(x: torch.Tensor, w: torch.Tensor, axis: int, radius: int) -> torch.Tensor:
    """Separable correlation of x (G, ...) along ``axis`` >= 1 with each
    entry's own taps w (G, 2 radius + 1), scipy's 'reflect' border."""
    n = x.shape[axis]
    xp = x.index_select(axis, _symmetric_index(n, radius, x.device))
    wb = _to(w, x.device).reshape(w.shape[0], *([1] * (x.ndim - 1)), w.shape[1])
    out = None
    for k in range(2 * radius + 1):
        term = wb[..., k] * xp.narrow(axis, k, n)
        out = term if out is None else out + term
    return out


def gaussian_blur_device(data: torch.Tensor, gen: torch.Generator, p: float = 0.2,
                         sigma_range=(0.5, 1.0), p_per_channel: float = 0.5,
                         radius: int = 4) -> torch.Tensor:
    """scipy ``gaussian_filter(sigma, truncate=4)``: radius 4 for sigma <= 1."""
    b, c = data.shape[:2]
    apply_all = _uniform(gen, (b,)) < p
    sigma = _uniform(gen, (b, c), *sigma_range)
    take = apply_all[:, None] & (_uniform(gen, (b, c)) < p_per_channel)
    sel, dsel = _selected(take, data.device)
    if sel is None:
        return data
    w = _gauss_kernels(sigma[sel], radius)
    y = data[dsel]
    for ax in range(1, y.ndim):
        y = _blur_axis(y, w, ax, radius)
    return data.index_put(dsel, y)


def brightness_multiplicative_device(data: torch.Tensor, gen: torch.Generator,
                                     p: float = 0.15, mult_range=(0.75, 1.25),
                                     per_channel: bool = True) -> torch.Tensor:
    b, c = data.shape[:2]
    take = _uniform(gen, (b,)) < p
    m = _uniform(gen, (b, c) if per_channel else (b, 1), *mult_range)
    sel, dsel = _selected(take, data.device)
    if sel is None:
        return data
    mult = _to(m[sel], data.device).reshape(-1, m.shape[1], *([1] * (data.ndim - 2)))
    return data.index_put(dsel, data[dsel] * mult)


def contrast_augmentation_device(data: torch.Tensor, gen: torch.Generator,
                                 p: float = 0.15, contrast_range=(0.75, 1.25),
                                 preserve_range: bool = True) -> torch.Tensor:
    b, c = data.shape[:2]
    take = _uniform(gen, (b,)) < p
    factor = _uniform(gen, (b, c), *contrast_range)
    sel, dsel = _selected(take, data.device)
    if sel is None:
        return data
    x = data[dsel]
    axes = tuple(range(2, x.ndim))
    f = _to(factor[sel], x.device).reshape(*x.shape[:2], *([1] * len(axes)))
    mn = x.mean(dim=axes, keepdim=True)
    out = (x - mn) * f + mn
    if preserve_range:
        out = torch.minimum(torch.maximum(out, x.amin(dim=axes, keepdim=True)),
                            x.amax(dim=axes, keepdim=True))
    return data.index_put(dsel, out)


def _lowres_axis(x: torch.Tensor, zoom, axis: int) -> torch.Tensor:
    """Nearest down and linear up along ``axis`` with pixel-area (grid_mode)
    alignment and edge clamping: the 'ord1' low-resolution pass. ``zoom`` is
    a number, or one zoom per index of x's first axis (then ``axis`` >= 1).
    The down-map rounds floor(c + 0.5), as scipy's order 0."""
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    z = torch.as_tensor(zoom, dtype=torch.float32, device=x.device)
    if z.ndim:
        z = z.reshape(-1, *([1] * (xm.ndim - 1)))
    t = torch.clamp(torch.round(n * z), 1, n)
    j = torch.arange(n, dtype=torch.float32, device=x.device)
    pcoord = (j + 0.5) * t / n - 0.5
    i0 = torch.floor(pcoord)
    frac = pcoord - i0
    i0c = torch.minimum(torch.clamp(i0, min=0), t - 1)
    i1c = torch.minimum(torch.clamp(i0 + 1, min=0), t - 1)

    def src(i):
        s = torch.floor((i + 0.5) * n / t)
        return torch.clamp(s, 0, n - 1).long().expand(xm.shape)

    g0 = torch.gather(xm, -1, src(i0c))
    g1 = torch.gather(xm, -1, src(i1c))
    return (g0 * (1 - frac) + g1 * frac).movedim(-1, axis)


def simulate_low_resolution_device(data: torch.Tensor, gen: torch.Generator,
                                   p: float = 0.25, zoom_range=(0.5, 1.0),
                                   p_per_channel: float = 0.5, ignore_axes=(),
                                   up_order: int = 1) -> torch.Tensor:
    """``up_order=3`` is the scipy-exact cubic upsample (the reference
    default, order_upsample=3), ``up_order=1`` the 'ord1' profile."""
    b, c = data.shape[:2]
    apply_all = _uniform(gen, (b,)) < p
    zoom = _uniform(gen, (b, c), *zoom_range)
    take = apply_all[:, None] & (_uniform(gen, (b, c)) < p_per_channel)
    sel, dsel = _selected(take, data.device)
    if sel is None:
        return data
    z = zoom[sel]
    y = data[dsel]                        # (G, *spatial)
    for ax in range(y.ndim - 1):
        if ax in tuple(ignore_axes):
            continue
        if up_order == 3:
            n = y.shape[ax + 1]
            # host: np.round(shape * zoom) (half to even), at least 1
            t = torch.clamp(torch.round(n * z), 1, n)
            y = lowres_axis_cubic_up(y, _to(t, y.device), ax + 1)
        else:
            y = _lowres_axis(y, _to(z, y.device), ax + 1)
    return data.index_put(dsel, y)


def gamma_transform_device(data: torch.Tensor, gen: torch.Generator, p: float,
                           gamma_range=(0.7, 1.5), invert_image: bool = False,
                           retain_stats: bool = True, epsilon: float = 1e-7) -> torch.Tensor:
    """Per-channel batchgenerators gamma (augment.py:397-423)."""
    b, c = data.shape[:2]
    apply_all = _uniform(gen, (b,)) < p
    branch = _uniform(gen, (b, c)) < 0.5
    glo = _uniform(gen, (b, c), gamma_range[0], 1.0)
    ghi = _uniform(gen, (b, c), max(gamma_range[0], 1.0), gamma_range[1])
    gamma = torch.where(branch & (gamma_range[0] < 1), glo, ghi)
    sel, dsel = _selected(apply_all, data.device)
    if sel is None:
        return data
    x = data[dsel]
    axes = tuple(range(2, x.ndim))
    g = _to(gamma[sel], x.device).reshape(*x.shape[:2], *([1] * len(axes)))
    sl = -x if invert_image else x
    mn = sl.mean(dim=axes, keepdim=True)
    sd = sl.std(dim=axes, correction=0, keepdim=True)
    minm = sl.amin(dim=axes, keepdim=True)
    rnge = sl.amax(dim=axes, keepdim=True) - minm
    y = torch.pow((sl - minm) / (rnge + epsilon), g) * rnge + minm
    if retain_stats:
        y = (y - y.mean(dim=axes, keepdim=True)) / (
            y.std(dim=axes, correction=0, keepdim=True) + 1e-8) * sd + mn
    return data.index_put(dsel, -y if invert_image else y)


def mirror_device(data: torch.Tensor, seg: torch.Tensor, gen: torch.Generator,
                  mirror_axes: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random flips per sample; spatial axis i is data axis i + 2 and seg
    axis i + 1."""
    b = data.shape[0]
    for ax in mirror_axes:
        _, dsel = _selected(_uniform(gen, (b,)) < 0.5, data.device)
        if dsel is not None:
            data = data.index_put(dsel, data[dsel].flip(ax + 2))
            seg = seg.index_put(dsel, seg[dsel].flip(ax + 1))
    return data, seg


class DeviceTrainingTransforms:
    """The batch augmentation: data (B, C, *inflated) float32 and seg
    (B, *inflated) label ids -> data (B, *patch, C) float32, contiguous (the
    channels-last layout the train step takes) and seg (B, *patch) int32.
    The host ``TrainingTransforms`` stack (augment.py:420-500) without the
    cascade's transforms.

    interp='ord3' is the reference default (order-3 cubic data, order-1
    one-hot seg, order-3 low-resolution upsample; needs num_classes);
    interp='ord1' the order-1/0 profile."""

    def __init__(self, patch_size, rotation_for_da, mirror_axes,
                 scale_range=(0.7, 1.4), interp: str = "ord3", num_classes: int = 0):
        if interp not in ("ord1", "ord3"):
            raise ValueError(f"interp {interp!r}: 'ord1' or 'ord3'")
        if interp == "ord3" and num_classes <= 0:
            raise ValueError("interp='ord3' needs num_classes for the one-hot seg pass")
        self.patch_size = tuple(int(p) for p in patch_size)
        self.rotation_for_da = rotation_for_da
        self.mirror_axes = tuple(mirror_axes or ())
        self.scale_range = scale_range
        self.interp = interp
        self.num_classes = int(num_classes)

    def __call__(self, data: torch.Tensor, seg: torch.Tensor, gen: torch.Generator,
                 noise_gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        ord3 = self.interp == "ord3"
        data, seg = spatial_augment_device(
            data, seg, gen, self.patch_size, self.rotation_for_da, self.scale_range,
            order_data=3 if ord3 else 1, order_seg=1 if ord3 else 0,
            num_classes=self.num_classes)
        data = gaussian_noise_device(data, gen, noise_gen)
        data = gaussian_blur_device(data, gen)
        data = brightness_multiplicative_device(data, gen)
        data = contrast_augmentation_device(data, gen)
        data = simulate_low_resolution_device(data, gen, up_order=3 if ord3 else 1)
        data = gamma_transform_device(data, gen, p=0.1, invert_image=True)
        data = gamma_transform_device(data, gen, p=0.3, invert_image=False)
        if self.mirror_axes:
            data, seg = mirror_device(data, seg, gen, self.mirror_axes)
        seg = torch.where(seg == -1, torch.zeros_like(seg), seg)   # RemoveLabelTransform
        return data.movedim(1, -1).contiguous(), seg.to(torch.int32)


class DeviceAugLoader:
    """Wraps a prefetch loader whose workers only crop (``transforms=None``:
    the batches come at the inflated patch size, channels last), sends each
    batch to the device through ``feed(name, array)`` (the trainer's
    ``DeviceFeeder``) and augments it there. The parameters are drawn from a
    CPU generator seeded ``seed``, the noise from one on the batch's device
    with the same seed (the trainer passes 777 + fold)."""

    def __init__(self, inner, transforms: DeviceTrainingTransforms,
                 feed: Callable[[str, np.ndarray], torch.Tensor], seed: int = 0):
        self._inner = inner
        self._tf = transforms
        self._feed = feed
        self._seed = seed
        self._gen = torch.Generator().manual_seed(seed)
        self._noise_gen: Optional[torch.Generator] = None
        self.num_batches_per_epoch = inner.num_batches_per_epoch

    def get_batch(self) -> dict:
        batch = self._inner.get_batch()
        data = self._feed("aug_data", batch["data"]).movedim(-1, 1)
        seg = self._feed("aug_target", batch["target"])
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device=data.device).manual_seed(self._seed)
        out = dict(batch)
        out["data"], out["target"] = self._tf(data, seg, self._gen, self._noise_gen)
        return out

    def __iter__(self):
        for _ in range(self.num_batches_per_epoch):
            yield self.get_batch()

    def stop(self):
        self._inner.stop()
