"""The PyTorch port's image I/O, preprocessing and export against the JAX
package's (numpy copies of the same code): every reader/writer of the
registry round-trips in both directions, ``run_case_npy`` and
``export_prediction_from_logits`` agree within 1e-6."""
import os

import numpy as np
import pytest

from mlagg_unet_tpu.imageio import reader_writer_registry as jreg
from mlagg_unet_tpu.inference import export as jexport
from mlagg_unet_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from mlagg_unet_tpu.preprocessing.preprocessor import DefaultPreprocessor as JaxPreprocessor
from mlagg_unet_torch.imageio import reader_writer_registry as treg
from mlagg_unet_torch.inference import export as texport
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor

IO_NAMES = [cls.__name__ for cls in jreg.LIST_OF_IO_CLASSES]


def test_registry_lists_the_same_readers():
    assert [c.__name__ for c in treg.LIST_OF_IO_CLASSES] == IO_NAMES
    for name in IO_NAMES:
        assert treg.recursive_find_reader_writer_by_name(name).__module__.startswith(
            "mlagg_unet_torch.imageio.")


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
@pytest.mark.parametrize("name", IO_NAMES)
def test_reader_writer_round_trip(name, direction, tmp_path):
    """A label map written by one package reads back equal, with its
    spacing, through the other package and through its own."""
    if name == "NaturalImage2DIO":
        pytest.importorskip("PIL")
    writer_reg, reader_reg = (treg, jreg) if direction == "port_writes" else (jreg, treg)
    writer = writer_reg.recursive_find_reader_writer_by_name(name)()
    reader = reader_reg.recursive_find_reader_writer_by_name(name)()
    own = writer_reg.recursive_find_reader_writer_by_name(name)()
    rng = np.random.RandomState(IO_NAMES.index(name))
    seg = rng.randint(0, 4, (1 if name == "NaturalImage2DIO" else 4, 6, 5)).astype(np.uint8)
    spacing = (3.0, 2.0, 1.5)
    f = str(tmp_path / ("seg" + writer.supported_file_endings[0]))
    writer.write_seg(seg, f, {"spacing": spacing})
    got, props = reader.read_seg(f)
    ref, ref_props = own.read_seg(f)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], seg)
    assert tuple(props["spacing"]) == tuple(ref_props["spacing"])
    if name != "NaturalImage2DIO":  # 2D images carry no spacing
        np.testing.assert_allclose(props["spacing"], spacing)
    img, img_props = reader.read_images([f])
    np.testing.assert_array_equal(img, own.read_images([f])[0])
    assert tuple(img_props["spacing"]) == tuple(props["spacing"])


def _plans(spacing_3d, spacing_2d, norm):
    resampling = dict(
        resampling_fn_data="resample_data_or_seg_to_shape",
        resampling_fn_data_kwargs={"is_seg": False, "order": 3, "order_z": 0,
                                   "force_separate_z": None},
        resampling_fn_seg="resample_data_or_seg_to_shape",
        resampling_fn_seg_kwargs={"is_seg": True, "order": 1, "order_z": 0,
                                  "force_separate_z": None},
        resampling_fn_probabilities="resample_data_or_seg_to_shape",
        resampling_fn_probabilities_kwargs={"is_seg": False, "order": 1, "order_z": 0,
                                            "force_separate_z": None})
    common = dict(normalization_schemes=[norm], use_mask_for_norm=[norm == "ZScoreNormalization"],
                  **resampling)
    return {
        "dataset_name": "Dataset999_Port", "plans_name": "nnUNetPlans",
        "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "original_median_spacing_after_transp": [4.0, 1.0, 1.0],
        "original_median_shape_after_transp": [6, 30, 28],
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": 1.2, "std": 0.7, "percentile_00_5": 0.05, "percentile_99_5": 2.4}},
        "configurations": {
            "3d_fullres": dict(common, patch_size=[4, 16, 16], spacing=spacing_3d,
                               data_identifier="3d"),
            "2d": dict(common, patch_size=[16, 16], spacing=spacing_2d, data_identifier="2d"),
        },
    }


def _case(seed, shape=(6, 30, 28)):
    """An image that is zero outside an off-centre box (crop-to-nonzero has
    work to do) and a 3-class label map inside it."""
    rng = np.random.RandomState(seed)
    img = np.zeros((1, *shape), np.float32)
    seg = np.zeros((1, *shape), np.int16)
    box = (slice(1, shape[0] - 1), slice(3, shape[1] - 4), slice(2, shape[2] - 5))
    img[(0, *box)] = rng.rand(*[s.stop - s.start for s in box]) * 2 + 0.1
    seg[(0, *box)] = rng.randint(0, 3, [s.stop - s.start for s in box])
    return img, seg, {"spacing": (4.0, 1.0, 1.0)}


DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2}, "file_ending": ".nii.gz",
                "channel_names": {"0": "MRI"}}
DATASET_JSON_REGIONS = {"labels": {"background": 0, "whole": [1, 2], "core": [2]},
                        "regions_class_order": [1, 2], "file_ending": ".nii.gz",
                        "channel_names": {"0": "MRI"}}
# 3d: anisotropic (4.0 / 0.8 > 3), so z is resampled apart from the plane
CASES = {
    "zscore_3d_anisotropic": ("ZScoreNormalization", "3d_fullres", True),
    "ct_3d_anisotropic": ("CTNormalization", "3d_fullres", True),
    "zscore_2d": ("ZScoreNormalization", "2d", True),
    "ct_2d_no_seg": ("CTNormalization", "2d", False),
}


def _run_both(norm, config, with_seg, seed=0):
    plans = _plans([3.0, 0.8, 0.9], [0.8, 0.9], norm)
    img, seg, props = _case(seed)
    seg = seg if with_seg else None
    pm_j, pm_t = JaxPlansManager(plans), PlansManager(plans)
    ref = JaxPreprocessor().run_case_npy(img, seg, dict(props), pm_j,
                                         pm_j.get_configuration(config), DATASET_JSON)
    got = DefaultPreprocessor().run_case_npy(img, seg, dict(props), pm_t,
                                             pm_t.get_configuration(config), DATASET_JSON)
    return ref, got, pm_j, pm_t


@pytest.mark.parametrize("case", list(CASES))
def test_run_case_npy_matches_jax(case):
    """Crop to nonzero, ZScore or CT normalization, resampling (separate z
    where anisotropic): data within 1e-6 of JAX's, seg and properties equal."""
    (data_j, seg_j, props_j), (data_t, seg_t, props_t), _, _ = _run_both(*CASES[case])
    assert data_t.shape == data_j.shape and data_t.dtype == data_j.dtype
    assert data_t.shape != (1, 6, 30, 28)  # cropped and resampled
    err = np.abs(data_t - data_j).max()
    assert err <= 1e-6 * max(1.0, np.abs(data_j).max()), err
    if seg_j is None:
        assert seg_t is None
    else:
        np.testing.assert_array_equal(seg_t, seg_j)
    assert props_t.keys() == props_j.keys()
    for k in ("shape_before_cropping", "bbox_used_for_cropping",
              "shape_after_cropping_and_before_resampling"):
        assert np.array_equal(np.asarray(props_t[k]), np.asarray(props_j[k])), k
    if seg_j is not None:
        for c in props_j["class_locations"]:
            np.testing.assert_array_equal(props_t["class_locations"][c],
                                          props_j["class_locations"][c])


@pytest.mark.parametrize("regions", [False, True], ids=["labels", "regions"])
@pytest.mark.parametrize("config", ["3d_fullres", "2d"])
def test_export_prediction_matches_jax(config, regions, tmp_path):
    """Logits on the preprocessed grid -> resampled back, cropping reverted,
    segmentation and probabilities written: equal segmentations,
    probabilities within 1e-6."""
    dataset_json = DATASET_JSON_REGIONS if regions else DATASET_JSON
    (data, _, props), _, pm_j, pm_t = _run_both("ZScoreNormalization", config, False)
    heads = pm_t.get_label_manager(dataset_json).num_segmentation_heads
    logits = np.random.RandomState(1).randn(heads, *data.shape[1:]).astype(np.float32) * 3
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export_prediction_from_logits(logits, dict(props), pm_j.get_configuration(config),
                                          pm_j, dataset_json, out_j, True)
    texport.export_prediction_from_logits(logits, dict(props), pm_t.get_configuration(config),
                                          pm_t, dataset_json, out_t, True)
    rw = pm_t.image_reader_writer_class()
    seg_j, _ = rw.read_seg(out_j + ".nii.gz")
    seg_t, props_t = rw.read_seg(out_t + ".nii.gz")
    assert seg_t.shape == (1, 6, 30, 28)
    np.testing.assert_array_equal(seg_t, seg_j)
    assert seg_t.max() > 0 and seg_t[0, 0].max() == 0  # the cropped-away slice is background
    p_j = np.load(out_j + ".npz")["probabilities"]
    p_t = np.load(out_t + ".npz")["probabilities"]
    assert p_t.shape == (heads, 6, 30, 28)
    assert np.abs(p_t - p_j).max() <= 1e-6
    assert os.path.isfile(out_t + ".pkl")
    np.testing.assert_array_equal(
        seg_t[0], texport.convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, pm_t, pm_t.get_configuration(config),
            pm_t.get_label_manager(dataset_json), dict(props)))
