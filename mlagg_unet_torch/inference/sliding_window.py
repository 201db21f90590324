"""Sliding-window inference with Gaussian blending and mirror TTA.

Counterpart of ``VolumePredictor`` in
``mlagg_unet_tpu/inference/sliding_window.py``: half-overlap tile grid,
Gaussian importance map with sigma = tile / 8, mirror TTA over every flip
combination of the allowed axes stacked on the batch axis of ONE network
call, and a Gaussian-weighted scatter-add into an fp32 accumulator on the
device. A 2D network over a 3D volume runs in "z mode": every z-slice is
tiled in-plane and the slices' tiles are batched together.

Tiles run in fixed-size batches (``tile_batch_size`` tiles x the mirror
variants); the tail batch is padded to the same size and its padded tiles
are masked out of the scatter. Under ``compute_dtype=torch.bfloat16`` the
predictor's copy of the model is cast to bf16, every parameter included, the
volume is uploaded in bf16 (the same values the model would see after a
device-side cast, at half the bytes) and the accumulator stays fp32.

Not ported yet: the memory-budget tile-batch selection, the throughput
autotuner, the host-accumulator fallback and multi-device sharding.
"""
from __future__ import annotations

import copy
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mlagg_unet_torch.device import DeviceLike, resolve_device


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


class VolumePredictor:
    """Whole-volume sliding-window prediction on one device.

    ``model`` maps NHWC tiles to NHWC logits (or a list whose first entry is
    the full-resolution logits). The predictor works on its own copy of the
    model, moved to ``device`` (the GPU unless the caller passes another;
    raises without one) and cast to ``compute_dtype``.
    """

    def __init__(self, model: nn.Module, tile_size: Sequence[int],
                 num_classes: int, mirror_axes: Sequence[int] = (),
                 tile_batch_size: int = 4,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.tile_size = tuple(tile_size)
        self.num_classes = num_classes
        self.mirror_axes = tuple(mirror_axes)
        self.combos = mirror_variants(self.mirror_axes)
        self.tb = int(tile_batch_size)
        self.compute_dtype = compute_dtype
        self.model = copy.deepcopy(model).to(self.device, dtype=compute_dtype).eval()

    @property
    def model_batch(self) -> int:
        """Tiles per network call: tile batch x mirror variants."""
        return self.tb * len(self.combos)

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

    def _positions(self, vol_shape, z_mode):
        tile = self.tile_size
        if not z_mode:
            return get_tile_positions(vol_shape, tile, 0.5)
        inplane = get_tile_positions(vol_shape[1:], tile, 0.5)
        return np.concatenate([
            np.concatenate([np.full((len(inplane), 1), z, np.int32), inplane], 1)
            for z in range(vol_shape[0])])

    def _tile_slices(self, pos, z_mode):
        sl = tuple(slice(p, p + t) for p, t in zip(pos[-len(self.tile_size):],
                                                   self.tile_size))
        return (int(pos[0]),) + sl if z_mode else sl

    @torch.inference_mode()
    def predict_device(self, data: np.ndarray):
        """data: (c, *spatial) host array. Queues the whole volume on the
        device and returns (device logits (*vol, K), bounds, z_mode) without
        waiting for it; ``finalize`` fetches and unpads."""
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
        pad_n = (-n_tiles) % self.tb
        valid = np.concatenate([np.ones(n_tiles, bool), np.zeros(pad_n, bool)])
        positions = np.concatenate(
            [positions, np.zeros((pad_n, positions.shape[1]), np.int32)])

        vol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, 0, -1)))
        vol = vol.to(self.compute_dtype or vol.dtype).to(self.device)
        g = torch.from_numpy(compute_gaussian(tile)).to(self.device)
        acc = torch.zeros((*vol_shape, self.num_classes), dtype=torch.float32,
                          device=self.device)
        n = torch.zeros(vol_shape, dtype=torch.float32, device=self.device)
        for b0 in range(0, len(positions), self.tb):
            slices = [self._tile_slices(p, z_mode) for p in positions[b0:b0 + self.tb]]
            tl = self.predict_tiles(torch.stack([vol[s] for s in slices]))
            for i, s in enumerate(slices):
                if valid[b0 + i]:  # padded tail tiles are masked out
                    acc[s] += tl[i] * g[..., None]
                    n[s] += g
        return acc / n[..., None], bounds, z_mode

    def finalize(self, result) -> np.ndarray:
        """Fetch and unpad a ``predict_device`` result: fp32 (K, *spatial)."""
        logits, bounds, z_mode = result
        logits_np = np.moveaxis(logits.cpu().numpy(), -1, 0)
        lead = [slice(None)] * (2 if z_mode else 1)
        return logits_np[tuple(lead + [slice(lo, hi) for lo, hi in bounds])]

    def __call__(self, data: np.ndarray) -> np.ndarray:
        """data: (c, *spatial) host array -> fp32 logits (K, *spatial)."""
        return self.finalize(self.predict_device(data))
