"""Patch-sampling data loaders
(reference: training/dataloading/base_data_loader.py:10-139,
data_loader_2d.py, data_loader_3d.py) plus a thread-pool prefetch pipeline
replacing batchgenerators' NonDetMultiThreadedAugmenter
(LimitedLenWrapper, limited_length_multithreaded_augmenter.py:4).

Semantics preserved: infinite random case sampling; the LAST
oversample_foreground_percent of each batch is foreground-forced, with the
patch centered on a sampled class voxel from the preprocessed
class_locations; crop-then-pad (data: 0, seg: -1). 2D loader selects a slice
first (a labeled one when forcing fg).

Output layout is channels-LAST device-ready: data (B, *patch, C) float32,
seg (B, *patch) int32 (the NHWC departure from the reference's NCHW).

Copied from ``mlagg_unet_tpu/data/loader.py`` with the imports rewritten.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from mlagg_unet_torch.data.augment import (
    TrainingTransforms,
    ValidationTransforms,
    get_patch_size,
)
from mlagg_unet_torch.data.dataset import nnUNetDataset


class nnUNetDataLoaderBase:
    def __init__(
        self,
        data: nnUNetDataset,
        batch_size: int,
        patch_size: Sequence[int],
        final_patch_size: Sequence[int],
        oversample_foreground_percent: float = 0.33,
        sampling_probabilities: Optional[np.ndarray] = None,
        pad_sides: Optional[Sequence[int]] = None,
        annotated_classes_key: Optional[tuple] = None,
        has_ignore: bool = False,
        transforms=None,
        seed: Optional[int] = None,
        probabilistic_oversampling: bool = False,
    ):
        self._data = data
        self.batch_size = batch_size
        self.patch_size = list(patch_size)          # inflated sampling size
        self.final_patch_size = list(final_patch_size)
        self.oversample_foreground_percent = oversample_foreground_percent
        self.indices = list(data.keys())
        self.sampling_probabilities = sampling_probabilities
        self.annotated_classes_key = annotated_classes_key
        self.has_ignore = has_ignore
        self.transforms = transforms
        self.probabilistic_oversampling = probabilistic_oversampling
        self.rng = np.random.RandomState(seed)
        self.need_to_pad = (
            np.array(self.patch_size) - np.array(self.final_patch_size)
        ).astype(int)
        if pad_sides is not None:
            for d in range(len(self.need_to_pad)):
                self.need_to_pad[d] += pad_sides[d]

    def get_indices(self) -> List[str]:
        return [
            self.indices[i]
            for i in self.rng.choice(
                len(self.indices), self.batch_size, replace=True,
                p=self.sampling_probabilities,
            )
        ]

    def _oversample_last_XX_percent(self, sample_idx: int) -> bool:
        """reference base_data_loader.py:43-47; the probabilistic variant
        (variants/sampling/nnUNetTrainer_probabilisticOversampling.py) draws
        per-sample instead of forcing the last XX% of the batch."""
        if self.probabilistic_oversampling:
            return self.rng.uniform() < self.oversample_foreground_percent
        return not sample_idx < round(
            self.batch_size * (1 - self.oversample_foreground_percent)
        )

    def get_bbox(self, data_shape: np.ndarray, force_fg: bool,
                 class_locations: Union[dict, None],
                 overwrite_class=None) -> Tuple[List[int], List[int]]:
        """reference base_data_loader.py:64-139."""
        need_to_pad = self.need_to_pad.copy()
        dim = len(data_shape)
        for d in range(dim):
            if need_to_pad[d] + data_shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - data_shape[d]

        lbs = [-need_to_pad[i] // 2 for i in range(dim)]
        ubs = [
            data_shape[i] + need_to_pad[i] // 2 + need_to_pad[i] % 2
            - self.patch_size[i]
            for i in range(dim)
        ]

        if not force_fg and not self.has_ignore:
            bbox_lbs = [self.rng.randint(lbs[i], ubs[i] + 1) for i in range(dim)]
        else:
            if not force_fg and self.has_ignore:
                selected_class = self.annotated_classes_key
                if class_locations is None or \
                        len(class_locations.get(selected_class, [])) == 0:
                    selected_class = None
            elif force_fg:
                assert class_locations is not None
                eligible = [k for k in class_locations.keys()
                            if len(class_locations[k]) > 0]
                tmp = [
                    k == self.annotated_classes_key if isinstance(k, tuple)
                    else False for k in eligible
                ]
                if any(tmp) and len(eligible) > 1:
                    eligible.pop(int(np.where(tmp)[0][0]))
                if len(eligible) == 0:
                    selected_class = None
                else:
                    selected_class = (
                        eligible[self.rng.choice(len(eligible))]
                        if (overwrite_class is None
                            or overwrite_class not in eligible)
                        else overwrite_class
                    )
            else:
                raise RuntimeError()
            voxels = (class_locations[selected_class]
                      if selected_class is not None else None)
            if voxels is not None and len(voxels) > 0:
                selected_voxel = voxels[self.rng.choice(len(voxels))]
                bbox_lbs = [
                    max(lbs[i], selected_voxel[i + 1] - self.patch_size[i] // 2)
                    for i in range(dim)
                ]
            else:
                bbox_lbs = [self.rng.randint(lbs[i], ubs[i] + 1)
                            for i in range(dim)]

        bbox_ubs = [bbox_lbs[i] + self.patch_size[i] for i in range(dim)]
        return bbox_lbs, bbox_ubs

    @staticmethod
    def _crop_and_pad(arr: np.ndarray, bbox_lbs, bbox_ubs, pad_value):
        """arr: (c, *spatial). bbox may exceed bounds -> pad."""
        dim = len(bbox_lbs)
        shape = arr.shape[1:]
        valid_lbs = [max(0, bbox_lbs[i]) for i in range(dim)]
        valid_ubs = [min(shape[i], bbox_ubs[i]) for i in range(dim)]
        slicer = tuple([slice(None)] + [slice(valid_lbs[i], valid_ubs[i])
                                        for i in range(dim)])
        cropped = np.asarray(arr[slicer])
        padding = [(0, 0)] + [
            (-min(0, bbox_lbs[i]), max(bbox_ubs[i] - shape[i], 0))
            for i in range(dim)
        ]
        if any(p != (0, 0) for p in padding):
            cropped = np.pad(cropped, padding, mode="constant",
                             constant_values=pad_value)
        return cropped


class nnUNetDataLoader3D(nnUNetDataLoaderBase):
    def generate_train_batch(self):
        selected_keys = self.get_indices()
        data_batch, seg_batch = [], []
        for j, key in enumerate(selected_keys):
            force_fg = self._oversample_last_XX_percent(j)
            data, seg, properties = self._data.load_case(key)
            shape = np.array(data.shape[1:])
            class_locations = properties.get("class_locations")
            bbox_lbs, bbox_ubs = self.get_bbox(shape, force_fg, class_locations)
            d = self._crop_and_pad(data, bbox_lbs, bbox_ubs, 0)
            s = self._crop_and_pad(seg, bbox_lbs, bbox_ubs, -1)
            if self.transforms is not None:
                d, s = self.transforms(d, s, self.rng)
            data_batch.append(d)
            seg_batch.append(s)
        data_b = np.stack(data_batch)   # (B, c, *patch)
        seg_b = np.stack(seg_batch)     # (B, 1, *patch)
        # NHWC device layout
        data_b = np.moveaxis(data_b, 1, -1)
        return {"data": data_b.astype(np.float32),
                "target": seg_b[:, 0].astype(np.int32),
                "keys": selected_keys}


class nnUNetDataLoader2D(nnUNetDataLoaderBase):
    """Selects a slice, then an in-plane bbox (reference data_loader_2d.py:
    fg-forced samples pick a slice containing the selected class)."""

    def generate_train_batch(self):
        selected_keys = self.get_indices()
        data_batch, seg_batch = [], []
        for j, key in enumerate(selected_keys):
            force_fg = self._oversample_last_XX_percent(j)
            data, seg, properties = self._data.load_case(key)
            class_locations = properties.get("class_locations")

            if not force_fg or class_locations is None:
                selected_slice = self.rng.choice(data.shape[1])
                sliced_locations = None
                if self.has_ignore and class_locations is not None:
                    sliced_locations = self._filter_locations_to_slice(
                        class_locations, selected_slice
                    )
            else:
                eligible = [k for k in class_locations.keys()
                            if len(class_locations[k]) > 0]
                if len(eligible) > 0:
                    cls = eligible[self.rng.choice(len(eligible))]
                    voxels = class_locations[cls]
                    v = voxels[self.rng.choice(len(voxels))]
                    selected_slice = int(v[1])
                    sliced_locations = self._filter_locations_to_slice(
                        class_locations, selected_slice
                    )
                else:
                    selected_slice = self.rng.choice(data.shape[1])
                    sliced_locations = None
                    force_fg = False

            d3 = np.asarray(data[:, selected_slice])
            s3 = np.asarray(seg[:, selected_slice])
            shape = np.array(d3.shape[1:])
            bbox_lbs, bbox_ubs = self.get_bbox(shape, force_fg, sliced_locations)
            d = self._crop_and_pad(d3, bbox_lbs, bbox_ubs, 0)
            s = self._crop_and_pad(s3, bbox_lbs, bbox_ubs, -1)
            if self.transforms is not None:
                d, s = self.transforms(d, s, self.rng)
            data_batch.append(d)
            seg_batch.append(s)
        data_b = np.stack(data_batch)
        seg_b = np.stack(seg_batch)
        data_b = np.moveaxis(data_b, 1, -1)
        return {"data": data_b.astype(np.float32),
                "target": seg_b[:, 0].astype(np.int32),
                "keys": selected_keys}

    @staticmethod
    def _filter_locations_to_slice(class_locations: dict, slice_idx: int):
        """Keep voxels on the selected slice; re-key coords so that
        voxel[1] stays the slice index convention used by get_bbox
        (it indexes selected_voxel[i+1] for in-plane dims)."""
        out = {}
        for k, v in class_locations.items():
            if len(v) == 0:
                out[k] = v
                continue
            v = np.asarray(v)
            sel = v[v[:, 1] == slice_idx]
            # drop the slice axis: coords become (c_idx, y, x)
            out[k] = np.concatenate([sel[:, 0:1], sel[:, 2:]], axis=1) \
                if len(sel) else sel
        return out


class PrefetchLoader:
    """Thread-pool prefetcher feeding device-ready batches — replaces
    batchgenerators' process-based NonDetMultiThreadedAugmenter. NumPy/SciPy
    augmentation releases the GIL for its hot parts, so threads suffice and
    avoid spawn/pickle overhead; each worker gets an independent RNG."""

    def __init__(self, make_loader, num_workers: int = 4, queue_size: int = 6,
                 num_batches_per_epoch: int = 250):
        self.num_batches_per_epoch = num_batches_per_epoch
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        # worker exceptions land here (never silently dropped, even when
        # the queue is full); get_batch re-raises them
        self._errors: list = []
        self._workers = []
        for w in range(max(1, num_workers)):
            loader = make_loader(w)
            t = threading.Thread(target=self._worker, args=(loader,), daemon=True)
            t.start()
            self._workers.append(t)

    def _worker(self, loader):
        while not self._stop.is_set():
            try:
                batch = loader.generate_train_batch()
            except BaseException as e:  # propagate to the consumer
                self._errors.append(e)
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        for _ in range(self.num_batches_per_epoch):
            yield self.get_batch()

    def get_batch(self):
        while True:
            # drain already-produced batches before surfacing errors so a
            # failing worker doesn't discard its queued good batches
            try:
                return self._queue.get_nowait()
            except queue.Empty:
                pass
            if self._errors:
                self.stop()
                raise RuntimeError("data loader worker failed") \
                    from self._errors[0]
            try:
                return self._queue.get(timeout=1.0)
            except queue.Empty:
                if not any(t.is_alive() for t in self._workers):
                    raise RuntimeError("all data loader workers exited")

    def stop(self):
        self._stop.set()
        # drain so workers blocked on put() can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


class ProcessPrefetchLoader:
    """Process-pool prefetcher — the GIL-free counterpart of
    PrefetchLoader for augmentation stacks dominated by GIL-holding NumPy
    (3D order-3 spatial aug + the seg one-hot interpolator; measured:
    thread workers give ZERO scaling there — 0.17 b/s at 12 threads ==
    0.18 b/s at 1). Matches the reference's process-based
    NonDetMultiThreadedAugmenter semantics
    (limited_length_multithreaded_augmenter.py:4, batchgenerators
    nondet_multi_threaded_augmenter).

    fork-started workers inherit make_loader without pickling; they touch
    only NumPy/SciPy (never CUDA) so the forked runtime state is inert.
    Batches come back through a multiprocessing queue; worker exceptions
    are forwarded as ("error", traceback) and re-raised in get_batch.
    """

    def __init__(self, make_loader, num_workers: int = 4, queue_size: int = 6,
                 num_batches_per_epoch: int = 250):
        import multiprocessing as mp

        self.num_batches_per_epoch = num_batches_per_epoch
        ctx = mp.get_context("fork")
        self._queue = ctx.Queue(maxsize=queue_size)
        self._stop = ctx.Event()
        self._workers = []
        for w in range(max(1, num_workers)):
            p = ctx.Process(target=self._worker_main,
                            args=(make_loader, w, self._queue, self._stop),
                            daemon=True)
            p.start()
            self._workers.append(p)

    @staticmethod
    def _worker_main(make_loader, worker_id, q, stop):
        import traceback

        try:
            loader = make_loader(worker_id)
            while not stop.is_set():
                batch = loader.generate_train_batch()
                while not stop.is_set():
                    try:
                        q.put(("batch", batch), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException:
            try:
                q.put(("error", traceback.format_exc()), timeout=5.0)
            except Exception:
                pass

    def __iter__(self):
        for _ in range(self.num_batches_per_epoch):
            yield self.get_batch()

    def get_batch(self):
        while True:
            try:
                kind, payload = self._queue.get(timeout=1.0)
            except queue.Empty:
                if not any(p.is_alive() for p in self._workers):
                    raise RuntimeError("all data loader workers exited")
                continue
            if kind == "error":
                self.stop()
                raise RuntimeError(
                    f"data loader worker failed:\n{payload}")
            return payload

    def stop(self):
        self._stop.set()
        # drain so workers blocked on put() can exit, then reap
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for p in self._workers:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
