"""Sliding-window inference with Gaussian blending and mirror TTA.

Counterpart of ``mlagg_unet_tpu/inference/sliding_window.py``: half-overlap
tile grid, Gaussian importance map with sigma = tile / 8, mirror TTA over
every flip combination of the allowed axes stacked on the batch axis of ONE
network call, and a Gaussian-weighted scatter-add into an fp32 accumulator
on the device. A 2D network over a 3D volume runs in "z mode": every
z-slice is tiled in-plane and the slices' tiles are batched together.

Tiles run in fixed-size batches (``tile_batch_size`` tiles x the mirror
variants); the tail batch is padded to the same size and its padded tiles
are masked out of the scatter. ``tile_batch_size=None`` picks the batch on
the card: the largest that the memory budget allows
(``memory_budget.py``), then the fastest of a few candidates, timed once
per predictor. Where the volume's fp32 accumulator does not fit on the
card, the accumulator moves to the host and tiles still run on the card.
Under ``compute_dtype=torch.bfloat16`` the predictor's copy of the model is
cast to bf16, every parameter included, the volume is uploaded in bf16 (the
same values the model would see after a device-side cast, at half the
bytes) and the accumulator stays fp32.

Not ported yet: multi-device sharding (the JAX ``mesh`` argument).
"""
from __future__ import annotations

import copy
import itertools
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.inference import memory_budget as mb

log = logging.getLogger(__name__)


def compute_gaussian(tile_size: Sequence[int], sigma_scale: float = 1.0 / 8,
                     value_scaling_factor: float = 1.0) -> np.ndarray:
    """Separable Gaussian importance map, max 1, no zeros."""
    center = [i // 2 for i in tile_size]
    sigmas = [i * sigma_scale for i in tile_size]
    g = np.ones(tile_size, np.float64)
    for ax, (s, c, sig) in enumerate(zip(tile_size, center, sigmas)):
        x = np.arange(s, dtype=np.float64)
        k = np.exp(-((x - c) ** 2) / (2 * sig ** 2))
        shape = [1] * len(tile_size)
        shape[ax] = s
        g = g * k.reshape(shape)
    g = (g / g.max() * value_scaling_factor).astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def compute_steps_for_sliding_window(image_size: Sequence[int],
                                     tile_size: Sequence[int],
                                     tile_step_size: float) -> List[List[int]]:
    assert all(i >= j for i, j in zip(image_size, tile_size))
    assert 0 < tile_step_size <= 1
    target = [i * tile_step_size for i in tile_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target, tile_size)]
    steps = []
    for dim in range(len(tile_size)):
        max_step = image_size[dim] - tile_size[dim]
        actual = max_step / (num_steps[dim] - 1) if num_steps[dim] > 1 else 99999999999
        steps.append([int(np.round(actual * i)) for i in range(num_steps[dim])])
    return steps


def get_tile_positions(image_size: Sequence[int], tile_size: Sequence[int],
                       tile_step_size: float = 0.5) -> np.ndarray:
    """All tile corners, (n_tiles, dim) int32."""
    steps = compute_steps_for_sliding_window(image_size, tile_size, tile_step_size)
    return np.array(list(itertools.product(*steps)), dtype=np.int32)


def pad_to_min_size(data: np.ndarray, min_size: Sequence[int]
                    ) -> Tuple[np.ndarray, List[List[int]]]:
    """Centre-pad the trailing spatial dims up to min_size. Returns the
    padded array and the bounds that undo it."""
    spatial = data.shape[-len(min_size):]
    pads = []
    for s, m in zip(spatial, min_size):
        total = max(0, m - s)
        pads.append((total // 2, total - total // 2))
    full_pad = [(0, 0)] * (data.ndim - len(min_size)) + pads
    padded = np.pad(data, full_pad) if any(p != (0, 0) for p in pads) else data
    bounds = [[p[0], p[0] + s] for p, s in zip(pads, spatial)]
    return padded, bounds


def mirror_variants(mirror_axes: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """Every flip combination of the axes, the identity first."""
    combos = [()]
    for r in range(1, len(mirror_axes) + 1):
        combos += list(itertools.combinations(mirror_axes, r))
    return combos


def _tile_slices(pos, tile_size, z_mode):
    """Index of one tile: (z, y-slice, x-slice) in z mode, else a slice per
    axis."""
    sl = tuple(slice(int(p), int(p) + t) for p, t in zip(pos[-len(tile_size):], tile_size))
    return (int(pos[0]),) + sl if z_mode else sl


class HostCopy:
    """A device-to-host copy in flight: a pinned host buffer filled by a
    ``non_blocking`` copy, and a CUDA event recorded after it. A CPU tensor
    is its own copy. ``wait`` returns the values as an fp32 numpy array."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.float().numpy()


class VolumePredictor:
    """Whole-volume sliding-window prediction on one device.

    ``model`` maps NHWC tiles to NHWC logits (or a list whose first entry is
    the full-resolution logits). The predictor works on its own copy of the
    model, moved to ``device`` (the GPU unless the caller passes another;
    raises without one) and cast to ``compute_dtype``.

    tile_batch_size=None (default) selects the batch on the card from its
    memory budget (``budget_fraction`` of it, 0.8 by default) and the
    network's measured bytes per tile, then times the TTA forward at a few
    candidate batches and keeps the fastest (``MLAGG_AUTOTUNE_TB=0`` keeps
    the budget's batch). On a CPU device the batch must be pinned. When the
    volume's fp32 accumulator does not fit the budget, it lives on the host
    (``_run_host``) and tiles still run on the device.

    transfer_dtype: dtype of the device->host logits copy; None keeps fp32,
    torch.bfloat16 halves the bytes. ``finalize`` returns fp32 either way.
    upload_dtype: dtype of the host->device volume copy; "auto" follows
    compute_dtype (tiles are cast to it before the model anyway).
    """

    def __init__(self, model: nn.Module, tile_size: Sequence[int],
                 num_classes: int, mirror_axes: Sequence[int] = (),
                 tile_batch_size: Optional[int] = None, use_gaussian: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 budget_fraction: Optional[float] = None,
                 transfer_dtype: Optional[torch.dtype] = None,
                 upload_dtype="auto", device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if tile_batch_size is None and self.device.type != "cuda":
            raise ValueError(
                f"tile_batch_size=None selects the batch from a CUDA card's memory; "
                f"on {self.device} pass a tile_batch_size")
        self.tile_size = tuple(tile_size)
        self.num_classes = num_classes
        self.mirror_axes = tuple(mirror_axes)
        self.combos = mirror_variants(self.mirror_axes)
        self.tb = None if tile_batch_size is None else int(tile_batch_size)
        self.use_gaussian = use_gaussian
        self.compute_dtype = compute_dtype
        self.transfer_dtype = transfer_dtype
        self.upload_dtype = compute_dtype if upload_dtype == "auto" else upload_dtype
        self.model = copy.deepcopy(model).to(self.device, dtype=compute_dtype).eval()
        # a CPU device has no memory to budget unless MLAGG_HBM_BYTES says
        # so; a pinned batch then runs on the device path
        has_budget = self.device.type == "cuda" or os.environ.get("MLAGG_HBM_BYTES")
        self._budget = (mb.inference_budget_bytes(
            self.device, budget_fraction or mb.DEFAULT_BUDGET_FRACTION)
            if has_budget else None)
        self._params_bytes = mb.params_bytes(self.model)
        self._tile_bytes_cache: Dict[int, int] = {}
        self._tb_tuned: Dict[Tuple[int, int], int] = {}
        # ms per tile of each autotune candidate, by (in_channels, tb_max)
        self.autotune_ms: Dict[Tuple[int, int], Dict[int, float]] = {}
        self.last_tile_batch: Optional[int] = None

    @property
    def model_batch(self) -> int:
        """Tiles per network call: tile batch x mirror variants (the pinned
        batch, else the last one chosen)."""
        return (self.tb or self.last_tile_batch) * len(self.combos)

    @torch.inference_mode()
    def predict_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """(T, *tile, C) -> fp32 (T, *tile, K), averaged over the mirror
        variants, which run stacked on the batch axis of one call."""
        variants = [tiles.flip([1 + ax for ax in c]) if c else tiles
                    for c in self.combos]
        stacked = torch.cat(variants, dim=0)
        if self.compute_dtype is not None:
            stacked = stacked.to(self.compute_dtype)
        out = self.model(stacked)
        if isinstance(out, (list, tuple)):
            out = out[0]
        out = out.float()
        T = tiles.shape[0]
        acc = torch.zeros((T, *self.tile_size, self.num_classes),
                          dtype=torch.float32, device=out.device)
        for i, c in enumerate(self.combos):
            o = out[i * T:(i + 1) * T]
            acc = acc + (o.flip([1 + ax for ax in c]) if c else o)
        return acc / len(self.combos)

    # ---- tile batch: budget, then autotune ----

    def _probe_tile_bytes(self, in_channels: int) -> int:
        """Per-tile device bytes of the TTA forward (cached)."""
        if in_channels not in self._tile_bytes_cache:
            self._tile_bytes_cache[in_channels] = mb.probe_network_tile_bytes(
                self.predict_tiles, self.tile_size, in_channels, self.device,
                self.upload_dtype or torch.float32)
        return self._tile_bytes_cache[in_channels]

    def _select_tb(self, n_tiles: int, in_channels: int, fixed_bytes: int) -> int:
        """Tile batch from the memory budget; a pinned batch wins."""
        if self.tb is not None:
            return self.tb
        return mb.select_tile_batch(
            self._budget, fixed_bytes + self._params_bytes,
            self._probe_tile_bytes(in_channels), max(1, n_tiles))

    @staticmethod
    def autotune_candidates(tb_max: int, n_combos: int) -> List[int]:
        """Tile-batch candidates to time: model batches ~8/16/32 (where
        scan-/attention-heavy nets peak) plus the budget's own choice
        when its model batch is small enough that evaluating it costs
        less than it could win (conv nets do like big batches)."""
        nc = max(1, n_combos)
        cands = sorted({max(1, m // nc) for m in (8, 16, 32)})
        cands = [t for t in cands if t <= tb_max]
        if tb_max * nc <= 64 and tb_max not in cands:
            cands.append(tb_max)
        return cands

    def _autotune_tb(self, tb_max: int, in_channels: int) -> int:
        """The fastest tile batch up to ``tb_max``: the budget gives the
        largest batch that fits, but throughput can peak well below it for
        scan- and attention-heavy nets. Times the TTA forward of each
        candidate with CUDA events after one warm-up call, once per
        (in_channels, tb_max). CUDA only; ``MLAGG_AUTOTUNE_TB=0`` keeps the
        budget's batch."""
        if (os.environ.get("MLAGG_AUTOTUNE_TB", "1") == "0" or tb_max <= 1
                or self.device.type != "cuda"):
            return tb_max
        key = (in_channels, tb_max)
        if key in self._tb_tuned:
            return self._tb_tuned[key]
        cands = self.autotune_candidates(tb_max, len(self.combos))
        if len(cands) <= 1:
            self._tb_tuned[key] = tb_max
            return tb_max
        times = {}
        for t in cands:
            times[t] = self._time_tile_batch(t, in_channels)
            log.info("autotune: tile batch %d (model batch %d): %.4f ms per tile",
                     t, t * len(self.combos), times[t])
        best = min(times, key=times.get)
        self.autotune_ms[key] = times
        self._tb_tuned[key] = best
        return best

    def _time_tile_batch(self, t: int, in_channels: int) -> float:
        """ms per tile of the TTA forward at tile batch ``t``: CUDA events
        around ``max(3, 24 // t)`` calls after one warm-up call."""
        x = torch.zeros((t, *self.tile_size, in_channels),
                        dtype=self.upload_dtype or torch.float32, device=self.device)
        self.predict_tiles(x)
        iters = max(3, 24 // t)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            self.predict_tiles(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters / t

    # ---- the volume ----

    def _positions(self, vol_shape, z_mode):
        tile = self.tile_size
        if not z_mode:
            return get_tile_positions(vol_shape, tile, 0.5)
        inplane = get_tile_positions(vol_shape[1:], tile, 0.5)
        return np.concatenate([
            np.concatenate([np.full((len(inplane), 1), z, np.int32), inplane], 1)
            for z in range(vol_shape[0])])

    def _gaussian(self) -> np.ndarray:
        return (compute_gaussian(self.tile_size) if self.use_gaussian
                else np.ones(self.tile_size, np.float32))

    @torch.inference_mode()
    def _run(self, data: np.ndarray):
        """data: (c, *spatial) host array. Queues the whole volume and
        returns (logits (*vol, K), bounds, z_mode) without waiting: the
        logits are on the device, in ``transfer_dtype``, or fp32 on the host
        after the host-accumulator fallback."""
        tile = self.tile_size
        spatial = data.shape[1:]
        z_mode = len(tile) == len(spatial) - 1
        if not (z_mode or len(tile) == len(spatial)):
            raise ValueError(f"data of shape {data.shape} (c, *spatial) does not "
                             f"fit {len(tile)}-D tiles")
        padded, bounds = pad_to_min_size(data, tile)
        vol_shape = padded.shape[1:]
        positions = self._positions(vol_shape, z_mode)
        n_tiles = len(positions)
        C = data.shape[0]
        fixed = mb.accumulator_bytes(vol_shape, self.num_classes, C)
        if self.tb is not None and (self._budget is None
                                    or fixed + self._params_bytes < 0.5 * self._budget):
            # pinned batch on a comfortably fitting volume: no probe
            tb = self.tb
        else:
            # probe the network's per-tile bytes; host fallback when the
            # device-resident volume state plus one minimal batch overflows
            min_net = (self._probe_tile_bytes(C)
                       if fixed + self._params_bytes < self._budget
                       and self.device.type == "cuda" else 0)
            if fixed + self._params_bytes + min_net >= self._budget:
                return self._run_host(padded, bounds, z_mode, positions, C)
            tb = self._autotune_tb(self._select_tb(n_tiles, C, fixed), C)
        self.last_tile_batch = tb
        pad_n = (-n_tiles) % tb
        valid = np.concatenate([np.ones(n_tiles, bool), np.zeros(pad_n, bool)])
        positions = np.concatenate(
            [positions, np.zeros((pad_n, positions.shape[1]), np.int32)])

        vol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, 0, -1)))
        if self.upload_dtype is not None:
            # host-side cast: the model sees the same values after its own cast
            vol = vol.to(self.upload_dtype)
        vol = vol.to(self.device)
        g = torch.from_numpy(self._gaussian()).to(self.device)
        acc = torch.zeros((*vol_shape, self.num_classes), dtype=torch.float32,
                          device=self.device)
        n = torch.zeros(vol_shape, dtype=torch.float32, device=self.device)
        for b0 in range(0, len(positions), tb):
            slices = [_tile_slices(p, tile, z_mode) for p in positions[b0:b0 + tb]]
            tl = self.predict_tiles(torch.stack([vol[s] for s in slices]))
            for i, s in enumerate(slices):
                if valid[b0 + i]:  # padded tail tiles are masked out
                    acc[s] += tl[i] * g[..., None]
                    n[s] += g
        out = acc / n[..., None]
        if self.transfer_dtype is not None:
            out = out.to(self.transfer_dtype)
        return out, bounds, z_mode

    @torch.inference_mode()
    def _run_host(self, padded, bounds, z_mode, positions, in_channels):
        """Large-volume path: fp32 logits and n-map accumulate in host RAM;
        tiles are gathered on the host and forwarded on the device in
        batches, one batch in flight: batch b's copy to a pinned buffer and
        its scatter overlap batch b+1's forward. Mirrors the reference's
        CPU-accumulator fallback (sliding_window_prediction.py:169-184)."""
        tile = self.tile_size
        vol_shape = padded.shape[1:]
        # the budget only needs the params and one batch's network bytes
        tb = self.tb or mb.select_tile_batch(
            self._budget, self._params_bytes,
            self._probe_tile_bytes(in_channels), len(positions))
        self.last_tile_batch = tb
        gaussian = self._gaussian()
        vol_cl = np.ascontiguousarray(np.moveaxis(padded, 0, -1))
        acc = np.zeros((*vol_shape, self.num_classes), np.float32)
        nmap = np.zeros(vol_shape, np.float32)
        pending = None
        for b in range(0, len(positions), tb):
            batch_pos = positions[b:b + tb]
            # the tail is padded with zero tiles to the batch's shape
            tiles = np.zeros((tb, *tile, in_channels), np.float32)
            for i, pos in enumerate(batch_pos):
                tiles[i] = vol_cl[_tile_slices(pos, tile, z_mode)]
            out = HostCopy(self.predict_tiles(torch.from_numpy(tiles).to(self.device)))
            if pending is not None:
                self._scatter_host(acc, nmap, pending[0].wait(), pending[1], gaussian, z_mode)
            pending = (out, batch_pos)
        if pending is not None:
            self._scatter_host(acc, nmap, pending[0].wait(), pending[1], gaussian, z_mode)
        acc /= nmap[..., None]
        return torch.from_numpy(acc), bounds, z_mode

    @staticmethod
    def _scatter_host(acc, nmap, tile_logits, batch_pos, gaussian, z_mode):
        tile = gaussian.shape
        for i, pos in enumerate(batch_pos):
            sl = _tile_slices(pos, tile, z_mode)
            acc[sl] += tile_logits[i] * gaussian[..., None]
            nmap[sl] += gaussian

    def predict_device(self, data: np.ndarray):
        """data: (c, *spatial) host array. Queues the whole volume and the
        copy of its logits to a pinned host buffer, and returns
        (HostCopy, bounds, z_mode) without waiting for either; ``finalize``
        waits and unpads."""
        logits, bounds, z_mode = self._run(data)
        return HostCopy(logits), bounds, z_mode

    def finalize(self, result) -> np.ndarray:
        """Wait for a ``predict_device`` result and unpad it: fp32
        (K, *spatial)."""
        fetch, bounds, z_mode = result
        logits_np = np.moveaxis(fetch.wait(), -1, 0)
        lead = [slice(None)] * (2 if z_mode else 1)
        return logits_np[tuple(lead + [slice(lo, hi) for lo, hi in bounds])]

    def __call__(self, data: np.ndarray) -> np.ndarray:
        """data: (c, *spatial) host array -> fp32 logits (K, *spatial)."""
        return self.finalize(self.predict_device(data))


def make_tile_predictor(model: nn.Module, tile_size: Sequence[int], num_classes: int,
                        mirror_axes: Tuple[int, ...] = (), tile_batch_size: int = 8,
                        compute_dtype: Optional[torch.dtype] = None,
                        device: DeviceLike = "cuda") -> Callable:
    """A function (tiles (T, *tile, C)) -> fp32 logits (T, *tile, K) on the
    device, averaging over all mirror variants in a single network call.
    compute_dtype=torch.bfloat16 casts the model and the activations."""
    vp = VolumePredictor(model, tile_size, num_classes, mirror_axes, tile_batch_size,
                         compute_dtype=compute_dtype, device=device)

    def predict(tiles) -> torch.Tensor:
        return vp.predict_tiles(torch.as_tensor(tiles).to(vp.device))

    return predict


def predict_sliding_window_return_logits(
    model: nn.Module,
    data: np.ndarray,
    tile_size: Sequence[int],
    num_classes: int,
    mirror_axes: Tuple[int, ...] = (),
    tile_step_size: float = 0.5,
    tile_batch_size: int = 8,
    use_gaussian: bool = True,
    precomputed_predictor: Optional[Callable] = None,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """data: (c, *spatial) host array (reference layout). Returns fp32
    logits (num_classes, *spatial).

    For 2D networks on 3D volumes, pass tile_size of length 2: each z-slice
    is tiled in-plane with slices batched together, through
    ``VolumePredictor`` at step 0.5 (as the JAX package does, whatever
    ``tile_step_size`` says).
    """
    dim = len(tile_size)
    spatial = data.shape[1:]
    if dim == len(spatial) - 1:
        return VolumePredictor(model, tile_size, num_classes, mirror_axes,
                               tile_batch_size, use_gaussian, device=device)(data)
    if dim != len(spatial):
        raise ValueError(f"data of shape {data.shape} (c, *spatial) does not "
                         f"fit {dim}-D tiles")

    padded, bounds = pad_to_min_size(data, tile_size)
    img_shape = padded.shape[1:]
    positions = get_tile_positions(img_shape, tile_size, tile_step_size)
    gaussian = (compute_gaussian(tile_size) if use_gaussian
                else np.ones(tile_size, np.float32))
    predictor = precomputed_predictor or make_tile_predictor(
        model, tile_size, num_classes, mirror_axes, tile_batch_size, device=device)
    dev = resolve_device(device)
    with torch.inference_mode():
        vol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, 0, -1))).to(dev)
        g = torch.from_numpy(gaussian).to(dev)
        acc = torch.zeros((*img_shape, num_classes), dtype=torch.float32, device=dev)
        n = torch.zeros(img_shape, dtype=torch.float32, device=dev)
        tb = tile_batch_size
        for b0 in range(0, len(positions), tb):
            slices = [_tile_slices(p, tile_size, False) for p in positions[b0:b0 + tb]]
            tiles = torch.stack([vol[s] for s in slices])
            if len(slices) < tb:  # pad the tail batch to its fixed size
                tiles = torch.cat([tiles, tiles.new_zeros((tb - len(slices), *tiles.shape[1:]))])
            tl = predictor(tiles)
            for i, s in enumerate(slices):
                acc[s] += tl[i] * g[..., None]
                n[s] += g
        logits = np.moveaxis((acc / n[..., None]).cpu().numpy(), -1, 0)
    return logits[tuple([slice(None)] + [slice(lo, hi) for lo, hi in bounds])]
