"""The port's training run with on-device augmentation (``MLAGG_DEVICE_AUG``)
on the CPU: ``run_training`` of a tiny plans U-Net in 3-D and 2-D with
``ord3`` and ``ord1`` (the workers only crop, ``DeviceAugLoader`` augments,
each step takes the final patch, the checkpoint is written); JAX's gate keeps
the host path for dummy 2-D, a cascade's stage, DA5 and ``disable_da``; a
batch already on the device passes ``DeviceFeeder`` untouched."""
import os
from dataclasses import replace

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from mlagg_unet_torch.data.device_augment import DeviceAugLoader, DeviceTrainingTransforms
from mlagg_unet_torch.imageio.nifti_io import write_nifti
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.trainer import DeviceFeeder, NNUNetTrainer
from mlagg_unet_torch.utils.helpers import save_json
from port_helpers import one_torch_thread, set_paths  # noqa: F401  (an autouse fixture)

DATASET = "Dataset991_PortDevAug"
TR = "nnUNetTrainer_PortDevAug"
CASES, SHAPE = 4, (12, 24, 24)
DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz",
                "numTraining": CASES, "labels": {"background": 0, "a": 1, "b": 2}}


def _configuration(identifier, patch, pools, kernels):
    def resampling(is_seg, order):
        return {"is_seg": is_seg, "order": order, "order_z": 0, "force_separate_z": None}

    n = len(pools)
    return {
        "data_identifier": identifier, "preprocessor_name": "DefaultPreprocessor",
        "batch_size": 2, "patch_size": list(patch), "spacing": [1.0] * len(patch),
        "median_image_size_in_voxels": list(SHAPE[-len(patch):]),
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 8, "n_conv_per_stage_encoder": [1] * n,
        "n_conv_per_stage_decoder": [1] * (n - 1),
        "num_pool_per_axis": [1] * len(patch), "pool_op_kernel_sizes": pools,
        "conv_kernel_sizes": kernels,
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": resampling(False, 3),
        "resampling_fn_seg": "resample_data_or_seg_to_shape",
        "resampling_fn_seg_kwargs": resampling(True, 1),
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": resampling(False, 1),
        "batch_dice": True}


PLANS = {
    "dataset_name": DATASET, "plans_name": "nnUNetPlans", "image_reader_writer": "NiftiIO",
    "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
    "original_median_spacing_after_transp": [1.0, 1.0, 1.0],
    "original_median_shape_after_transp": list(SHAPE),
    "foreground_intensity_properties_per_channel": {"0": {
        "mean": 0.0, "std": 1.0, "percentile_00_5": -3.0, "percentile_99_5": 3.0}},
    "configurations": {
        "3d_fullres": _configuration("nnUNetPlans_3d_fullres", (8, 16, 16),
                                     [[1, 1, 1], [2, 2, 2]], [[3, 3, 3], [3, 3, 3]]),
        "2d": _configuration("nnUNetPlans_2d", (16, 16), [[1, 1], [2, 2]], [[3, 3], [3, 3]]),
        # the patch's in-plane axes over 3x its first: dummy 2-D augmentation
        "3d_aniso": {"inherits_from": "3d_fullres", "patch_size": [4, 16, 16]},
        "3d_cascade_fullres": {"inherits_from": "3d_fullres", "previous_stage": "2d"}}}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tiny recipe (1 epoch of 2 steps and 1 validation step, fp32), its
    DA5 and no-DA twins, and 4 cases preprocessed by the port in 3-D and
    2-D; the loaders on threads."""
    root = tmp_path_factory.mktemp("port_device_aug")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        mp.setenv("MLAGG_DA_BACKEND", "threads")
        base = replace(treg.TRAINER_REGISTRY["nnUNetTrainer"], network="plans_unet",
                       num_epochs=1, num_iterations_per_epoch=2,
                       num_val_iterations_per_epoch=1, compute_dtype="float32")
        for name, extra in ((TR, {}), (TR + "DA5", {"da_level": "DA5"}),
                            (TR + "NoDA", {"disable_da": True})):
            mp.setitem(treg.TRAINER_REGISTRY, name, replace(base, name=name, **extra))
        raw, pre = root / "raw" / DATASET, root / "preprocessed" / DATASET
        for d in (raw / "imagesTr", raw / "labelsTr", pre):
            os.makedirs(d, exist_ok=True)
        save_json(PLANS, str(pre / "nnUNetPlans.json"), sort_keys=False)
        save_json(DATASET_JSON, str(pre / "dataset.json"), sort_keys=False)
        pm = PlansManager(PLANS)
        rs = np.random.RandomState(0)
        for i in range(CASES):
            img = gaussian_filter(rs.randn(*SHAPE), 2).astype(np.float32)
            img /= img.std()
            lab = ((img > 0.2).astype(np.uint8) + (img > 1.0)).astype(np.uint8)
            image, label = (str(raw / "imagesTr" / f"c{i}_0000.nii.gz"),
                            str(raw / "labelsTr" / f"c{i}.nii.gz"))
            write_nifti(image, img.transpose(2, 1, 0), (1.0, 1.0, 1.0))
            write_nifti(label, lab.transpose(2, 1, 0), (1.0, 1.0, 1.0))
            for c in ("3d_fullres", "2d"):
                cm = pm.get_configuration(c)
                os.makedirs(pre / cm.data_identifier, exist_ok=True)
                DefaultPreprocessor().run_case_save(str(pre / cm.data_identifier / f"c{i}"),
                                                    [image], label, pm, cm, DATASET_JSON)
        yield dict(root=root, mp=mp)


@pytest.mark.parametrize("configuration,mode", [("3d_fullres", "ord3"), ("3d_fullres", "ord1"),
                                                ("2d", "1"), ("2d", "ord1")])
def test_run_training_with_device_augmentation(env, configuration, mode, monkeypatch):
    """The loader is a ``DeviceAugLoader`` whose workers emit the inflated
    patch; each step takes the final patch (channels last, int32 labels in
    0-2); every loss is finite and the checkpoint is written."""
    monkeypatch.setenv("MLAGG_DEVICE_AUG", mode)
    tr = NNUNetTrainer(PLANS, configuration, 0, DATASET_JSON, trainer_name=TR,
                       unpack_data=False, device="cpu")
    tr.initialize()
    seen, inflated, train_step = [], [], tr.step.train_step
    transforms = DeviceTrainingTransforms.__call__

    def recording(data, target):
        seen.append((tuple(data.shape), target.dtype, int(target.min()), int(target.max())))
        return train_step(data, target)

    def recording_transforms(self, data, seg, gen, noise_gen):
        inflated.append(tuple(data.shape))
        return transforms(self, data, seg, gen, noise_gen)

    tr.step.train_step = recording
    monkeypatch.setattr(DeviceTrainingTransforms, "__call__", recording_transforms)
    tr.run_training()
    assert isinstance(tr.dataloader_train, DeviceAugLoader)
    patch = tuple(tr.configuration_manager.patch_size)
    want = tuple(int(s) for s in
                 tr.configure_rotation_dummyDA_mirroring_and_initial_patch_size()[2])
    assert inflated == [(2, 1, *want)] * 2 and want != patch
    assert len(seen) == 2
    for shape, dtype, lo, hi in seen:
        assert shape == (2, *patch, 1) and dtype == torch.int32 and 0 <= lo <= hi <= 2
    lg = tr.logger.my_fantastic_logging
    assert all(np.isfinite(lg["train_losses"])) and all(np.isfinite(lg["val_losses"]))
    assert os.path.isfile(os.path.join(tr.output_folder, "checkpoint_final.ckpt"))


@pytest.mark.parametrize("case", ["dummy_2d", "cascade", "DA5", "disable_da"])
def test_gate_keeps_the_host_path(env, case, monkeypatch):
    """JAX's exclusions (trainer.py:563-567): with the flag on, dummy 2-D, a
    cascade's stage, DA5 and no-DA keep the host loader."""
    monkeypatch.setenv("MLAGG_DEVICE_AUG", "ord3")
    configuration, trainer = {"dummy_2d": ("3d_aniso", TR), "cascade": ("3d_cascade_fullres", TR),
                              "DA5": ("3d_fullres", TR + "DA5"),
                              "disable_da": ("3d_fullres", TR + "NoDA")}[case]
    tr = NNUNetTrainer(PLANS, configuration, 0, DATASET_JSON, trainer_name=trainer,
                       unpack_data=False, device="cpu")
    train, val = tr.get_dataloaders()
    try:
        assert not isinstance(train, DeviceAugLoader)
        assert type(train) is type(val)
        if case == "dummy_2d":
            assert tr.configure_rotation_dummyDA_mirroring_and_initial_patch_size()[1]
    finally:
        train.stop()
        val.stop()


def test_device_feeder_passes_a_device_batch_untouched(monkeypatch):
    """A tensor on the feeder's device (a mocked one: 'meta') comes back as
    the same object, with no host array made; host arrays still go through
    the copy."""
    def no_host_copy(*a, **k):
        raise AssertionError("a device batch went through the host")

    feed = DeviceFeeder(torch.device("meta"))
    x = torch.empty(2, 8, 8, 1, device="meta")
    y = torch.empty(2, 8, 8, dtype=torch.int32, device="meta")
    with monkeypatch.context() as mp:
        mp.setattr(torch, "from_numpy", no_host_copy)
        data, target = feed.batch({"data": x, "target": y})
    assert data is x and target is y
    cpu = DeviceFeeder(torch.device("cpu"))
    w = torch.zeros(3)
    assert cpu("data", w) is w
    z = cpu("data", np.ones((2, 3), np.float32))
    assert isinstance(z, torch.Tensor) and z.is_contiguous()
