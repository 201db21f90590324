"""Device-memory budget for sliding-window inference on a CUDA card.

Counterpart of ``mlagg_unet_tpu/inference/memory_budget.py``. The budget is
planned before dispatch, as in JAX:

  (a) the card's memory: ``MLAGG_HBM_BYTES`` if set, else
      ``torch.cuda.get_device_properties(dev).total_memory``;
  (b) the TTA network forward's bytes per tile, measured by running it at a
      probe batch between ``reset_peak_memory_stats`` and
      ``max_memory_allocated`` (there is no compile-time memory analysis to
      ask);
  (c) the largest tile batch that fits, balanced over the batches
      (``select_tile_batch``, a verbatim copy);
  (d) where the whole-volume fp32 accumulator cannot fit, the predictor
      falls back to a host-resident accumulator.

A CPU device has nothing to probe: there a tile batch must be pinned.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Sequence

import numpy as np
import torch

# Fraction of the card's memory inference plans against. Leaves room for
# the caching allocator's fragmentation, cuBLAS workspaces and the kernels'
# scratch.
DEFAULT_BUDGET_FRACTION = 0.80


def device_hbm_bytes(device: torch.device) -> int:
    """Total device memory in bytes: ``MLAGG_HBM_BYTES`` if set, else the
    card's ``total_memory``. Raises on a CPU device."""
    env = os.environ.get("MLAGG_HBM_BYTES")
    if env:
        return int(env)
    if device.type != "cuda":
        raise ValueError(
            f"no device memory to budget on {device}: pin tile_batch_size "
            "(or set MLAGG_HBM_BYTES)")
    return int(torch.cuda.get_device_properties(device).total_memory)


def inference_budget_bytes(device: torch.device,
                           fraction: float = DEFAULT_BUDGET_FRACTION) -> int:
    return int(device_hbm_bytes(device) * fraction)


def params_bytes(model: torch.nn.Module) -> int:
    """Bytes of the (cast) model's parameters and buffers."""
    return int(sum(t.numel() * t.element_size()
                   for t in (*model.parameters(), *model.buffers())))


def accumulator_bytes(vol_shape: Sequence[int], num_classes: int,
                      in_channels: int) -> int:
    """Device-resident bytes for the fused whole-volume path: fp32 logits
    accumulator (*vol, K), fp32 n-counts (*vol,), fp32 input volume
    (*vol, C). (sliding_window.py VolumePredictor._run)."""
    vox = int(np.prod(vol_shape))
    return vox * 4 * (num_classes + 1 + in_channels)


def probe_network_tile_bytes(predict_tiles_fn: Callable[[torch.Tensor], torch.Tensor],
                             tile_size: Sequence[int], in_channels: int,
                             device: torch.device, dtype: torch.dtype = torch.float32,
                             probe_tb: int = 2) -> int:
    """Per-tile device bytes of the TTA-averaged network forward: the rise
    of the allocator's peak over one forward of ``probe_tb`` tiles (input
    included), divided by ``probe_tb``.

    predict_tiles_fn: (tb, *tile, C) -> (tb, *tile, K), the exact function
    the sliding-window loop calls (mirror variants included, so the V-fold
    batch blow-up is part of the measurement)."""
    if device.type != "cuda":
        raise ValueError(
            f"cannot probe the network's memory on {device}: pin tile_batch_size")
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    x = torch.zeros((probe_tb, *tile_size, in_channels), dtype=dtype, device=device)
    out = predict_tiles_fn(x)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del x, out
    return max(1, math.ceil((peak - base) / probe_tb))


def select_tile_batch(budget_bytes: int, fixed_bytes: int,
                      per_tile_bytes: int, n_tiles: int,
                      granule: int = 1, max_tb: int = 64) -> int:
    """Largest tile batch (multiple of granule, capped at max_tb) whose
    network temp fits in budget - fixed, then BALANCED so the padded tail
    batch wastes as little compute as possible: with the memory-limited
    batch count fixed, shrink tb to ceil(n_tiles / n_batches). (40 tiles
    at a memory cap of 33 would otherwise run as 2x33 = 66 tile slots
    instead of the balanced 2x20.) Returns at least `granule`."""
    if n_tiles <= 0:
        # degenerate call (no tiles): return the granule instead of
        # ceil-dividing by a zero batch count below
        return granule
    avail = budget_bytes - fixed_bytes
    tb = int(avail // max(1, per_tile_bytes))
    tb = min(tb, max_tb, max(granule, n_tiles))
    tb = (tb // granule) * granule
    tb = max(granule, tb)
    n_batches = -(-n_tiles // tb)
    balanced = -(-n_tiles // n_batches)
    balanced = -(-balanced // granule) * granule
    return max(granule, min(tb, balanced))
