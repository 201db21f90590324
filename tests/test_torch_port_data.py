"""The port's data pipeline against the JAX package's, on the CPU.

Every transform of ``data/augment.py``, the 2D and 3D patch loaders, the
case dataset and the prefetch pipelines are numpy copies; each case feeds
both packages the same seeded inputs and the same ``RandomState`` seed and
requires bit-equal outputs. Also: a batch of two
input channels, which the loader hands out channels-last and not
C-contiguous, reaches the step ``Trainer`` as a contiguous tensor.
"""
import os

import numpy as np
import pytest
import torch

from mlagg_unet_tpu.data import augment as JA
from mlagg_unet_tpu.data import dataset as JD
from mlagg_unet_tpu.data import loader as JL
from mlagg_unet_torch.data import augment as TA
from mlagg_unet_torch.data import dataset as TD
from mlagg_unet_torch.data import loader as TL
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training.trainer import DeviceFeeder, Trainer
from mlagg_unet_torch.utils.helpers import write_pickle
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))
ROT2D = {"x": (-np.pi, np.pi), "y": (0, 0), "z": (0, 0)}
ROT3D = {"x": (-np.pi / 6, np.pi / 6), "y": (-np.pi / 6, np.pi / 6),
         "z": (-np.pi / 6, np.pi / 6)}


def _blobs(rs, shape, channels=1):
    from scipy.ndimage import gaussian_filter

    data = np.stack([gaussian_filter(rs.randn(*shape), 2.0) for _ in range(channels)])
    data = (data / data.std()).astype(np.float32)
    seg = (data[:1] > 0.3).astype(np.int16) + (data[:1] > 1.0)
    return data, seg


def _assert_equal(got, ref):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_equal(g, r)
        return
    if ref is None:
        assert got is None
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------- transforms
def _training(mod, dim, seed, **kw):
    rot = ROT2D if dim == 2 else ROT3D
    patch = [24, 20] if dim == 2 else [8, 16, 16]
    return mod.TrainingTransforms(patch, rot, tuple(range(dim)), **kw)


def _inputs(seed, dim, channels=1, cascade=False):
    rs = np.random.RandomState(100 + seed)
    shape = (34, 30) if dim == 2 else (12, 24, 24)
    data, seg = _blobs(rs, shape, channels)
    seg = seg.astype(np.int16)
    seg[(slice(None),) + tuple(slice(0, 2) for _ in shape)] = -1   # outside the mask
    if cascade:
        seg = np.concatenate([seg, (data[:1] > 0.5).astype(np.int16) * 2], 0)
    return data, seg


TRANSFORMS = {
    "training_2d": lambda m, s: _training(m, 2, s),
    "training_2d_two_channels_mask": lambda m, s: _training(
        m, 2, s, use_mask_for_norm=[True, False]),
    "training_2d_order0": lambda m, s: _training(
        m, 2, s, order_resampling_data=0, order_resampling_seg=0),
    "training_3d": lambda m, s: _training(m, 3, s),
    "training_3d_dummy_2d": lambda m, s: m.TrainingTransforms(
        [8, 16, 16], ROT2D, (1, 2), do_dummy_2d_data_aug=True),
    "training_3d_cascade": lambda m, s: _training(
        m, 3, s, is_cascaded=True, foreground_labels=[1, 2]),
    "da5_2d": lambda m, s: m.DA5TrainingTransforms([24, 20], ROT2D, (0, 1)),
    "validation_2d": lambda m, s: m.ValidationTransforms([24, 20]),
    "validation_3d_cascade": lambda m, s: m.ValidationTransforms(
        [8, 16, 16], True, [1, 2]),
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_stack_matches_jax(name, seed):
    """Each transform stack on seeded inputs with the same RandomState: the
    augmented data and seg bit-equal."""
    dim = 2 if "2d" in name and "dummy" not in name else 3
    channels = 2 if "two_channels" in name else 1
    data, seg = _inputs(seed, dim, channels, cascade="cascade" in name)
    got = TRANSFORMS[name](TA, seed)(data.copy(), seg.copy(), np.random.RandomState(seed))
    ref = TRANSFORMS[name](JA, seed)(data.copy(), seg.copy(), np.random.RandomState(seed))
    _assert_equal(tuple(got), tuple(ref))


INTENSITY = {
    "gaussian_noise": lambda m, d, s, r: m.gaussian_noise(d, r, p=1.0),
    "gaussian_blur": lambda m, d, s, r: m.gaussian_blur(d, r, p=1.0, p_per_channel=1.0),
    "brightness": lambda m, d, s, r: m.brightness_multiplicative(d, r, p=1.0),
    "contrast": lambda m, d, s, r: m.contrast_augmentation(d, r, p=1.0),
    "low_resolution": lambda m, d, s, r: m.simulate_low_resolution(
        d, r, p=1.0, p_per_channel=1.0),
    "gamma_inverted": lambda m, d, s, r: m.gamma_transform(d, r, 1.0, invert_image=True),
    "gamma": lambda m, d, s, r: m.gamma_transform(d, r, 1.0),
    "mirror": lambda m, d, s, r: m.mirror(d, s, r, (0, 1)),
    "mask_for_norm": lambda m, d, s, r: m.apply_mask_for_norm(d, s, [True, False]),
    "additive_brightness": lambda m, d, s, r: m.additive_brightness(d, r, p=1.0,
                                                                    p_per_channel=1.0),
    "sharpening": lambda m, d, s, r: m.sharpening(d, r, p=1.0, p_per_channel=1.0),
    "spatial_order3_seg1": lambda m, d, s, r: m.spatial_augment(
        d, s, [20, 16], ROT2D, p_rot=1.0, p_scale=1.0, rng=r),
    "spatial_seg_order3": lambda m, d, s, r: m.spatial_augment(
        d, s, [20, 16], ROT2D, p_rot=1.0, p_scale=1.0, order_seg=3, rng=r),
    "move_seg_to_data": lambda m, d, s, r: m.move_seg_as_one_hot_to_data(
        d, np.concatenate([s, (d[:1] > 0.2).astype(s.dtype)]), [1, 2]),
    "cascade_binary_aug": lambda m, d, s, r: m.cascade_binary_aug(
        np.concatenate([d, (d > 0.2).astype(np.float32)]), 2, r, 1.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(INTENSITY))
def test_single_transform_matches_jax(name):
    """Each transform alone, forced on (p = 1), 2 channels: bit-equal."""
    data, seg = _inputs(7, 2, channels=2)
    got = INTENSITY[name](TA, data.copy(), seg.copy(), np.random.RandomState(3))
    ref = INTENSITY[name](JA, data.copy(), seg.copy(), np.random.RandomState(3))
    _assert_equal(got if isinstance(got, tuple) else (got,),
                  ref if isinstance(ref, tuple) else (ref,))


@pytest.mark.parametrize("patch, rot, scale", [
    ([256, 224], (-np.pi / 12, np.pi / 12), (0.85, 1.25)),
    ([32, 32], (-np.pi, np.pi), (0.85, 1.25)),
    ([20, 64, 64], (-np.pi / 6, np.pi / 6), (0.85, 1.25)),
    ([40, 48, 56], (-np.pi, np.pi), (0.7, 1.4))])
def test_get_patch_size_matches_jax(patch, rot, scale):
    got = TA.get_patch_size(patch, rot, rot if len(patch) == 3 else (0, 0),
                            rot if len(patch) == 3 else (0, 0), scale)
    ref = JA.get_patch_size(patch, rot, rot if len(patch) == 3 else (0, 0),
                            rot if len(patch) == 3 else (0, 0), scale)
    _assert_equal(got, ref)


# ------------------------------------------------------------ the dataset
def _write_case(folder, name, data, seg, labels, ignore=None):
    locs = list(labels) + ([tuple([0, *labels, ignore])] if ignore is not None else [])
    props = {"class_locations": DefaultPreprocessor._sample_foreground_locations(seg, locs),
             "spacing": [1.0] * (data.ndim - 1)}
    np.savez_compressed(os.path.join(folder, name + ".npz"), data=data, seg=seg)
    write_pickle(props, os.path.join(folder, name + ".pkl"))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Preprocessed cases: 3D volumes larger and smaller than the patch, with
    labels 1 and 2, and a copy with an ignore label 3; one folder each."""
    root = tmp_path_factory.mktemp("port_data")
    rs = np.random.RandomState(0)
    folders = {}
    for kind in ("labels", "ignore"):
        folder = root / kind
        folder.mkdir()
        for i, shape in enumerate([(12, 40, 36), (6, 20, 18), (9, 33, 50)]):
            data, seg = _blobs(rs, shape)
            if kind == "ignore":
                seg[:, :, :3] = 3
            _write_case(str(folder), f"case_{i}", data, seg.astype(np.int8), [1, 2],
                        3 if kind == "ignore" else None)
        folders[kind] = str(folder)
    return folders


@pytest.mark.parametrize("unpacked", [False, True])
def test_dataset_matches_jax(cases, tmp_path, unpacked):
    """nnUNetDataset from .npz and from the unpacked .npy / _seg.npy: the
    same keys, data, seg and properties."""
    import shutil

    folder = str(tmp_path / "ds")
    shutil.copytree(cases["labels"], folder)
    if unpacked:
        TD.unpack_dataset(folder, num_processes=2)
        assert sorted(f for f in os.listdir(folder) if f.endswith(".npy")) == sorted(
            [f"case_{i}.npy" for i in range(3)] + [f"case_{i}_seg.npy" for i in range(3)])
    assert TD.get_case_identifiers(folder) == JD.get_case_identifiers(folder)
    t, j = TD.nnUNetDataset(folder), JD.nnUNetDataset(folder)
    assert list(t.keys()) == list(j.keys()) == ["case_0", "case_1", "case_2"]
    for k in t.keys():
        (dt, st, pt), (dj, sj, pj) = t.load_case(k), j.load_case(k)
        assert isinstance(dt, np.memmap) == unpacked
        _assert_equal((np.asarray(dt), np.asarray(st)), (np.asarray(dj), np.asarray(sj)))
        assert pt.keys() == pj.keys()


LOADERS = {
    "2d": dict(cls="nnUNetDataLoader2D", patch=[40, 36], final=[32, 32]),
    "3d": dict(cls="nnUNetDataLoader3D", patch=[10, 40, 40], final=[8, 32, 32]),
}


@pytest.mark.parametrize("oversampling", ["deterministic", "probabilistic"])
@pytest.mark.parametrize("labels", ["labels", "ignore"])
@pytest.mark.parametrize("dim", sorted(LOADERS))
def test_loader_batches_match_jax(cases, dim, labels, oversampling):
    """Three batches of 4 from each package's loader with one worker's seed,
    foreground oversampling, the cases larger and smaller than the patch,
    the training transforms: bit-equal data, target and keys."""
    spec = LOADERS[dim]
    ignore = labels == "ignore"

    def batches(mod, aug):
        ds = mod[1].nnUNetDataset(cases[labels])
        rot = ROT2D if dim == "2d" else ROT3D
        tf = aug.TrainingTransforms(spec["final"], rot, tuple(range(len(spec["final"]))))
        loader = getattr(mod[0], spec["cls"])(
            ds, 4, spec["patch"], spec["final"], 0.5,
            annotated_classes_key=(0, 1, 2, 3) if ignore else (0, 1, 2),
            has_ignore=ignore, transforms=tf, seed=1000,
            probabilistic_oversampling=oversampling == "probabilistic")
        return [loader.generate_train_batch() for _ in range(3)]

    got, ref = batches((TL, TD), TA), batches((JL, JD), JA)
    for g, r in zip(got, ref):
        assert g["keys"] == r["keys"]
        _assert_equal((g["data"], g["target"]), (r["data"], r["target"]))
        assert g["data"].shape == (4, *spec["final"], 1)


@pytest.mark.parametrize("dim", sorted(LOADERS))
def test_get_bbox_matches_jax(cases, dim):
    """get_bbox for shapes smaller and larger than the patch, forced to the
    foreground and not: the same boxes from the same RandomState."""
    spec = LOADERS[dim]
    nd = len(spec["final"])
    boxes = []
    for mod in ((TL, TD), (JL, JD)):
        loader = getattr(mod[0], spec["cls"])(mod[1].nnUNetDataset(cases["labels"]), 2,
                                              spec["patch"], spec["final"], seed=5)
        _, _, props = loader._data.load_case("case_0")
        locs = props["class_locations"] if nd == 3 else {1: np.array([[0, 3, 4]]), 2: []}
        out = []
        for shape in ([4] * nd, [60] * nd, spec["patch"]):
            for force in (False, True):
                out.append(loader.get_bbox(np.array(shape), force, locs))
        boxes.append(out)
    assert boxes[0] == boxes[1]


class _Failing:
    def generate_train_batch(self):
        raise ValueError("worker broke")


class _Counting:
    def __init__(self):
        self.i = 0

    def generate_train_batch(self):
        self.i += 1
        return {"i": self.i}


@pytest.mark.parametrize("pool", ["PrefetchLoader", "ProcessPrefetchLoader"])
def test_prefetch_loader_reraises_a_workers_error(pool):
    """A worker's exception surfaces in the consumer's get_batch, and the
    pool stops; a healthy pool yields num_batches_per_epoch batches."""
    cls = getattr(TL, pool)
    bad = cls(lambda w: _Failing(), num_workers=2, queue_size=2, num_batches_per_epoch=3)
    with pytest.raises(RuntimeError, match="data loader worker failed") as info:
        bad.get_batch()
    if pool == "PrefetchLoader":
        assert isinstance(info.value.__cause__, ValueError)
    else:
        assert "worker broke" in str(info.value)
    bad.stop()
    good = cls(lambda w: _Counting(), num_workers=1, queue_size=2, num_batches_per_epoch=3)
    try:
        assert [b["i"] for b in good] == [1, 2, 3]
    finally:
        good.stop()


def test_two_channel_batch_reaches_the_trainer_contiguous(tmp_path):
    """The 2D loader's channels-last batch of 2 channels is not C-contiguous;
    DeviceFeeder gives the step Trainer contiguous tensors equal to it, and
    the step runs on them."""
    rs = np.random.RandomState(4)
    for i in range(2):
        data, seg = _blobs(rs, (3, 40, 40), channels=2)
        _write_case(str(tmp_path), f"c{i}", data, seg.astype(np.int8), [1, 2])
    loader = TL.nnUNetDataLoader2D(TD.nnUNetDataset(str(tmp_path)), 2, [32, 32], [32, 32],
                                   transforms=TA.ValidationTransforms([32, 32]), seed=0)
    batch = loader.generate_train_batch()
    assert batch["data"].shape == (2, 32, 32, 2) and not batch["data"].flags.c_contiguous
    data, target = DeviceFeeder(torch.device("cpu")).batch(batch)
    assert data.is_contiguous() and target.is_contiguous()
    np.testing.assert_array_equal(data.numpy(), batch["data"])
    tr = Trainer(patch_size=(32, 32), batch_size=2, num_input_channels=2, num_classes=3,
                 device="cpu", compute_dtype=torch.float32, network_overrides=TINY)
    seen = []
    forward = tr.network.forward
    tr.network.forward = lambda x, *a, **k: (seen.append(x.is_contiguous()),
                                             forward(x, *a, **k))[1]
    assert np.isfinite(tr.train_step(data, target).item()) and seen == [True]
