"""The trainer names of the SS3D U-Mambas, VM-UNet-3D and MSVM-UNet in the
PyTorch port, on the CPU: each resolves with the JAX registry's field
values and passes the port's check, and the train verb (``train_entry``)
runs one step of each 3-D name, its validation step and its final
validation, on a 3d_fullres plan cut to the CPU (patch 8x32x32, three
stages of 4-16 features; VM-UNet-3D at widths 8-64 with 2 heads in place of
its 96-768 and 24). The networks themselves are held against JAX in
``test_torch_port_zoo_ss3d.py``, ``_vmunet3d.py`` and ``_msvm.py``.
"""
import dataclasses
import os
from dataclasses import replace

import numpy as np
import pytest

from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_torch import paths as tpaths
from mlagg_unet_torch.cli.entrypoints import train_entry
from mlagg_unet_torch.imageio.nifti_io import write_nifti
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.training.trainer import _check_ported
from mlagg_unet_torch.utils.helpers import save_json
from port_helpers import one_torch_thread, set_paths  # noqa: F401  (an autouse fixture)

NEW = ("nnUNetTrainerUMambaBot_SS3D", "nnUNetTrainerUMambaEnc_SS3D", "nnUNetTrainer_VMUNet3D",
       "nnUNetTrainer_VMUNet3D_woinit", "nnUNetTrainer_VMUNet3D_woinit_new",
       "nnUNetTrainer_VMUNet3D_woinit_new_SwinT", "nnUNetTrainer_MSVM_UNet")
NEW_3D = NEW[:-1]
DATASET = "Dataset995_PortZoo3D"
CASES, SHAPE = 4, (10, 36, 36)
DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz",
                "numTraining": CASES, "labels": {"background": 0, "a": 1, "b": 2}}
TINY_VMUNET3D = dict(dims=(8, 16, 32, 64), num_heads=2)


@pytest.mark.parametrize("name", NEW)
def test_new_zoo_trainer_resolves(name):
    """The name resolves with JAX's field values and passes the check."""
    got = treg.get_trainer_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(jreg.get_trainer_config(name))
    _check_ported(got)


def _plans():
    def resampling(is_seg, order):
        return {"is_seg": is_seg, "order": order, "order_z": 0, "force_separate_z": None}

    fullres = {
        "data_identifier": "nnUNetPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
        "batch_size": 2, "patch_size": [8, 32, 32], "spacing": [1.0, 1.0, 1.0],
        "median_image_size_in_voxels": list(SHAPE),
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 16, "n_conv_per_stage_encoder": [2, 2, 2],
        "n_conv_per_stage_decoder": [2, 2], "num_pool_per_axis": [2, 2, 2],
        "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
        "conv_kernel_sizes": [[3, 3, 3], [3, 3, 3], [3, 3, 3]],
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": resampling(False, 3),
        "resampling_fn_seg": "resample_data_or_seg_to_shape",
        "resampling_fn_seg_kwargs": resampling(True, 1),
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": resampling(False, 1),
        "batch_dice": True}
    return {
        "dataset_name": DATASET, "plans_name": "nnUNetPlans", "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "original_median_spacing_after_transp": [1.0, 1.0, 1.0],
        "original_median_shape_after_transp": list(SHAPE),
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": 0.0, "std": 1.0, "percentile_00_5": -3.0, "percentile_99_5": 3.0}},
        "configurations": {"3d_fullres": fullres}}


def _write_dataset(root, plans):
    from scipy.ndimage import gaussian_filter

    raw = root / "raw" / DATASET
    pre = root / "preprocessed" / DATASET
    for d in (raw / "imagesTr", raw / "labelsTr", pre / "gt_segmentations"):
        os.makedirs(d, exist_ok=True)
    save_json(plans, str(pre / "nnUNetPlans.json"), sort_keys=False)
    save_json(DATASET_JSON, str(pre / "dataset.json"), sort_keys=False)
    pm = PlansManager(plans)
    cm = pm.get_configuration("3d_fullres")
    os.makedirs(pre / cm.data_identifier, exist_ok=True)
    rs = np.random.RandomState(0)
    for i in range(CASES):
        img = gaussian_filter(rs.randn(*SHAPE), 2).astype(np.float32)
        img /= img.std()
        lab = ((img > 0.2).astype(np.uint8) + (img > 1.0)).astype(np.uint8)
        image = str(raw / "imagesTr" / f"c{i}_0000.nii.gz")
        label = str(raw / "labelsTr" / f"c{i}.nii.gz")
        write_nifti(image, img.transpose(2, 1, 0), (1.0, 1.0, 1.0))
        write_nifti(label, lab.transpose(2, 1, 0), (1.0, 1.0, 1.0))
        write_nifti(str(pre / "gt_segmentations" / f"c{i}.nii.gz"), lab.transpose(2, 1, 0),
                    (1.0, 1.0, 1.0))
        DefaultPreprocessor().run_case_save(str(pre / cm.data_identifier / f"c{i}"), [image],
                                            label, pm, cm, DATASET_JSON)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Paths under a temporary root, 3-D loaders on threads, the six 3-D
    names cut to one epoch of one step and one validation step in fp32, the
    VM-UNet-3D builders at CPU widths, and the dataset."""
    root = tmp_path_factory.mktemp("port_zoo3d_train")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        mp.setattr(tpaths, "nnUNet_results", str(root / "results"))
        mp.setenv("MLAGG_DA_BACKEND", "threads")
        for name in NEW_3D:
            mp.setitem(treg.TRAINER_REGISTRY, name, replace(
                treg.TRAINER_REGISTRY[name], num_epochs=1, num_iterations_per_epoch=1,
                num_val_iterations_per_epoch=1, compute_dtype="float32"))
        for key in ("vmunet3d", "vmunet3d_new", "vmunet3d_swint"):
            build = treg.NETWORK_BUILDERS[key]
            mp.setitem(treg.NETWORK_BUILDERS, key,
                       lambda *a, _build=build, **kw: _build(*a, **kw, **TINY_VMUNET3D))
        _write_dataset(root, _plans())
        yield root


@pytest.mark.parametrize("name", NEW_3D)
def test_train_entry_runs_one_step(env, name):
    """The train verb on the CPU: one step, the validation step, the final
    checkpoint (finite losses in its log) and the final validation's
    summary."""
    train_entry([DATASET, "3d_fullres", "0", "-tr", name, "-device", "cpu"])
    out = os.path.join(tpaths.nnUNet_results, DATASET, f"{name}__nnUNetPlans__3d_fullres",
                       "fold_0")
    ckpt = load_checkpoint(os.path.join(out, "checkpoint_final.ckpt"))
    log = ckpt["logging"]
    assert len(log["train_losses"]) == 1 and np.isfinite(log["train_losses"][0])
    assert np.isfinite(log["val_losses"][0])
    assert os.path.isfile(os.path.join(out, "validation", "summary.json"))
