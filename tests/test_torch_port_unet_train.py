"""The default recipe's training run, BatchNorm checkpoints and the
lowres -> cascade stages, the port against the JAX package on the CPU.

A tiny 3-D dataset (7 cases of 12x24x24 at 1 mm, seeded blobs labelled by
two thresholds; one held out as a test case) preprocessed by the port for a
3d_fullres plan (3 stages, features 4/8/16, patch 8x16x16, a [1, 3, 3]
kernel and a [1, 2, 2] stride), a 3d_lowres plan at 1.5 mm and the
3d_cascade_fullres stage after it, as ``tests/test_label_regimes.py``
writes them. Then:

- ``run_training`` of an ``nnUNetTrainer``-derived recipe (SGD, poly, deep
  supervision; fp32, 2 epochs of 2 steps and 1 validation step) and of its
  BatchNorm variant, both packages from JAX's init on one batch sequence:
  the logged losses and pseudo dice within 1e-4;
- a BatchNorm checkpoint written by the port served by JAX's predictor,
  and the reverse: logits within 1e-4;
- the lowres stage's final validation from the port's weights in both
  packages (fp32 predictors): ``predicted_next_stage`` segmentations equal;
- the cascade stage: 1 + 2 input channels, one epoch on the real loaders
  from the previous stage's segmentations, its final validation;
  ``_stack_prev_stage`` equal to JAX's; ``predict_from_files`` with the
  previous stage's predictions equal to JAX's (fp32), and the predict verb
  with ``-prev_stage_predictions``.
"""
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from mlagg_unet_tpu.inference import sliding_window as j_sw
from mlagg_unet_tpu.inference.predictor import NNUNetPredictor as JaxPredictor
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch import paths as tpaths
from mlagg_unet_torch.cli.entrypoints import main
from mlagg_unet_torch.imageio.nifti_io import NiftiIO, write_nifti
from mlagg_unet_torch.inference import sliding_window as t_sw
from mlagg_unet_torch.inference.predictor import NNUNetPredictor
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.training.trainer import NNUNetTrainer
from mlagg_unet_torch.utils.helpers import save_json
from mlagg_unet_torch.weights import jax_variables_to_state_dict
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, flat_params, one_torch_thread, set_paths)

DATASET = "Dataset992_PortUNet"
TR, TR_BN = "nnUNetTrainer_PortUNet", "nnUNetTrainerBN_PortUNet"
EPOCHS, STEPS, VAL_STEPS = 2, 2, 1
CASES, SHAPE = 7, (12, 24, 24)
DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz", "numTraining": 6,
                "labels": {"background": 0, "a": 1, "b": 2}}


def _plans():
    def resampling(is_seg, order):
        return {"is_seg": is_seg, "order": order, "order_z": 0, "force_separate_z": None}

    fullres = {
        "data_identifier": "nnUNetPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
        "batch_size": 2, "patch_size": [8, 16, 16], "spacing": [1.0, 1.0, 1.0],
        "median_image_size_in_voxels": list(SHAPE),
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 16, "n_conv_per_stage_encoder": [2, 2, 2],
        "n_conv_per_stage_decoder": [2, 2], "num_pool_per_axis": [1, 2, 2],
        "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2], [2, 2, 2]],
        "conv_kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3]],
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
        "configurations": {
            "3d_fullres": fullres,
            "3d_lowres": {**fullres, "data_identifier": "nnUNetPlans_3d_lowres",
                          "spacing": [1.5, 1.5, 1.5], "median_image_size_in_voxels": [8, 16, 16],
                          "batch_dice": False, "next_stage": "3d_cascade_fullres"},
            "3d_cascade_fullres": {"inherits_from": "3d_fullres",
                                   "previous_stage": "3d_lowres"}}}


PLANS = _plans()


class _SeqLoader:
    """A stand-in loader: each epoch yields the next ``per_epoch`` batches
    (``cycle``: round and round)."""

    def __init__(self, batches, per_epoch, cycle=False):
        self.batches, self.per_epoch, self.cycle, self.pos = batches, per_epoch, cycle, 0

    def __iter__(self):
        for _ in range(self.per_epoch):
            yield self.get_batch()

    def get_batch(self):
        batch = self.batches[self.pos % len(self.batches) if self.cycle else self.pos]
        self.pos += 1
        return batch

    def stop(self):
        pass


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randn(2, 8, 16, 16, 1).astype(np.float32)
        y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
        out.append({"data": x, "target": y})
    return out


def _stand_in_loaders(trainer, train, val):
    def get_dataloaders():
        trainer.dataloader_train = _SeqLoader(train, STEPS)
        trainer.dataloader_val = _SeqLoader(val, VAL_STEPS, cycle=True)
        return trainer.dataloader_train, trainer.dataloader_val
    trainer.get_dataloaders = get_dataloaders


def _write_dataset(root):
    """Raw images and labels, the ground truth, and the 3d_fullres and
    3d_lowres cases preprocessed by the port; the last case is a test case."""
    from scipy.ndimage import gaussian_filter

    raw = root / "raw" / DATASET
    pre = root / "preprocessed" / DATASET
    for d in (raw / "imagesTr", raw / "labelsTr", raw / "imagesTs", pre / "gt_segmentations"):
        os.makedirs(d, exist_ok=True)
    save_json(PLANS, str(pre / "nnUNetPlans.json"), sort_keys=False)
    save_json(DATASET_JSON, str(pre / "dataset.json"), sort_keys=False)
    pm = PlansManager(PLANS)
    rs = np.random.RandomState(0)
    for i in range(CASES):
        img = gaussian_filter(rs.randn(*SHAPE), 2).astype(np.float32)
        img /= img.std()
        lab = ((img > 0.2).astype(np.uint8) + (img > 1.0)).astype(np.uint8)
        if i == CASES - 1:
            write_nifti(str(raw / "imagesTs" / f"c{i}_0000.nii.gz"), img.transpose(2, 1, 0),
                        (1.0, 1.0, 1.0))
            continue
        image = str(raw / "imagesTr" / f"c{i}_0000.nii.gz")
        label = str(raw / "labelsTr" / f"c{i}.nii.gz")
        write_nifti(image, img.transpose(2, 1, 0), (1.0, 1.0, 1.0))
        write_nifti(label, lab.transpose(2, 1, 0), (1.0, 1.0, 1.0))
        shutil.copyfile(label, pre / "gt_segmentations" / f"c{i}.nii.gz")
        for c in ("3d_fullres", "3d_lowres"):
            cm = pm.get_configuration(c)
            os.makedirs(pre / cm.data_identifier, exist_ok=True)
            DefaultPreprocessor().run_case_save(str(pre / cm.data_identifier / f"c{i}"),
                                                [image], label, pm, cm, DATASET_JSON)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Both packages' paths (the port's results apart from JAX's), the tiny
    recipes in both registries, the dataset; 3-D loaders on threads."""
    root = tmp_path_factory.mktemp("port_unet_train")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        mp.setattr(tpaths, "nnUNet_results", str(root / "port_results"))
        mp.setenv("MLAGG_DA_BACKEND", "threads")
        for reg in (jreg, treg):
            base = reg.TRAINER_REGISTRY["nnUNetTrainer"]
            for name, network in ((TR, "plans_unet"), (TR_BN, "plans_unet_bn")):
                mp.setitem(reg.TRAINER_REGISTRY, name, replace(
                    base, name=name, network=network, num_epochs=EPOCHS,
                    num_iterations_per_epoch=STEPS, num_val_iterations_per_epoch=VAL_STEPS,
                    compute_dtype="float32"))
        _write_dataset(root)
        yield dict(root=root, mp=mp)


def _jax_init_state_dict(jtr):
    return jax_variables_to_state_dict(
        {k: np.array(v) for k, v in flat_params(jtr.params).items()},
        {k: {kk: np.array(vv) for kk, vv in flat_params(v).items()}
         for k, v in jtr.model_state.items()})


@pytest.fixture(scope="module")
def runs(env):
    """run_training of both recipes in both packages from JAX's init, on one
    batch sequence."""
    out = {}
    train, val = _batches(EPOCHS * STEPS, 1), _batches(1, 2)
    for name in (TR, TR_BN):
        jtr = NNUNetTrainerTPU(PLANS, "3d_fullres", 0, DATASET_JSON, trainer_name=name,
                               unpack_data=False, num_devices=1)
        jtr.initialize()
        init = _jax_init_state_dict(jtr)
        _stand_in_loaders(jtr, train, val)
        jtr.run_training()
        ttr = NNUNetTrainer(PLANS, "3d_fullres", 0, DATASET_JSON, trainer_name=name,
                            unpack_data=False, device="cpu")
        ttr.initialize()
        ttr.step.network.load_state_dict(init, strict=True)
        _stand_in_loaders(ttr, train, val)
        ttr.run_training()
        out[name] = (jtr, ttr)
    return out


@pytest.mark.parametrize("key", ["train_losses", "val_losses", "mean_fg_dice"])
@pytest.mark.parametrize("name", [TR, TR_BN])
def test_run_training_matches_jax(runs, name, key):
    """The logged series of both runs within 1e-4 relative (fp32; the pseudo
    dice counts voxels, so a difference there is a flipped argmax)."""
    jtr, ttr = runs[name]
    got = ttr.logger.my_fantastic_logging[key]
    ref = jtr.logger.my_fantastic_logging[key]
    assert len(got) == len(ref) == EPOCHS
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-4, atol=1e-7)


def _model_folder(folder):
    save_json(PLANS, os.path.join(folder, "plans.json"), sort_keys=False)
    save_json(DATASET_JSON, os.path.join(folder, "dataset.json"), sort_keys=False)
    return folder


def _fp32(module, monkeypatch):
    """The final validation of the trainer that imports ``VolumePredictor``
    from ``module`` predicts in fp32 from then on."""
    orig = module.VolumePredictor
    monkeypatch.setattr(module, "VolumePredictor", lambda *a, **k: orig(
        *a, **{**k, "compute_dtype": None}))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_batchnorm_checkpoint_serves_in_both_packages(runs, writer):
    """The BN recipe's checkpoint_final (running statistics in model_state),
    written by one package and served by both predictors (fp32, tile batch
    2): logits of a preprocessed case within 1e-4."""
    jtr, ttr = runs[TR_BN]
    folder = _model_folder((ttr if writer == "port" else jtr).output_folder_base)
    ck = load_checkpoint(os.path.join(folder, "fold_0", "checkpoint_final.ckpt"))
    assert set(ck["model_state"]) == {"batch_stats"}
    data = np.load(os.path.join(ttr.preprocessed_dataset_folder, "c0.npz"))["data"]
    tp = NNUNetPredictor(tile_batch_size=2, compute_dtype=torch.float32, device="cpu")
    tp.initialize_from_trained_model_folder(folder, (0,))
    jp = JaxPredictor(tile_batch_size=2, compute_dtype="float32")
    jp.initialize_from_trained_model_folder(folder, (0,))
    ref = jp.predict_logits_from_preprocessed_data(data)
    assert_close(tp.predict_logits_from_preprocessed_data(data), ref, rel=1e-4)


@pytest.fixture(scope="module")
def cascade(env, runs):
    """The lowres stage trained by the port (stand-in loaders) and validated
    by both packages from its weights (fp32); the missing training cases'
    previous-stage segmentations fabricated, as test_label_regimes.py does;
    then the cascade stage trained on the real loaders and validated by the
    port."""
    mp = env["mp"]
    low = NNUNetTrainer(PLANS, "3d_lowres", 0, DATASET_JSON, trainer_name=TR,
                        unpack_data=False, device="cpu")
    _stand_in_loaders(low, _batches(EPOCHS * STEPS, 3), _batches(1, 4))
    low.run_training()
    _fp32(t_sw, mp)
    _fp32(j_sw, mp)
    low.perform_actual_validation()
    jlow = NNUNetTrainerTPU(PLANS, "3d_lowres", 0, DATASET_JSON, trainer_name=TR,
                            unpack_data=False, num_devices=1)
    jlow.initialize()
    jlow.load_checkpoint_file(os.path.join(low.output_folder, "checkpoint_final.ckpt"))
    jlow.perform_actual_validation()
    nxt = os.path.join(low.output_folder_base, "predicted_next_stage", "3d_cascade_fullres")
    jnxt = os.path.join(jlow.output_folder_base, "predicted_next_stage", "3d_cascade_fullres")
    written = sorted(os.listdir(nxt))
    segs = {f: (np.load(os.path.join(nxt, f))["seg"], np.load(os.path.join(jnxt, f))["seg"])
            for f in written}
    rs = np.random.RandomState(0)
    full = os.path.join(low.preprocessed_dataset_folder_base, "nnUNetPlans_3d_fullres")
    for f in sorted(os.listdir(full)):
        if f.endswith(".npz") and not os.path.isfile(os.path.join(nxt, f)):
            shape = np.load(os.path.join(full, f))["data"].shape[1:]
            np.savez_compressed(os.path.join(nxt, f),
                                seg=rs.randint(0, 3, shape).astype(np.int8)[None])
    cas = NNUNetTrainer(PLANS, "3d_cascade_fullres", 0, DATASET_JSON, trainer_name=TR,
                        unpack_data=False, device="cpu")
    cas.run_training()
    cas.perform_actual_validation()
    return dict(low=low, cas=cas, written=written, segs=segs)


def test_lowres_next_stage_segmentations_match_jax(cascade):
    """The lowres final validation writes each validation case's
    segmentation at the 3d_fullres shape; the port's equal JAX's from the
    same weights."""
    assert cascade["written"] == sorted(k + ".npz" for k in cascade["low"].do_split()[1])
    for f, (got, ref) in cascade["segs"].items():
        assert got.dtype == np.int8 and got.shape == (1, *SHAPE)
        assert np.array_equal(got, ref), f


def test_cascade_stage_trains_on_previous_stage_segmentations(cascade):
    """The cascade stage takes 1 + n_fg input channels, trains on the real
    loaders with the previous stage's one-hot channels, and its final
    validation (the one-hot stacked on each case) writes a summary."""
    cas = cascade["cas"]
    assert cas.num_input_channels == 1 + 2
    assert cas.step.network.encoder_stage0.conv0.conv.weight.shape[1] == 3
    assert np.isfinite(cas.logger.my_fantastic_logging["train_losses"][0])
    assert os.path.isfile(os.path.join(cas.output_folder, "validation", "summary.json"))


def _cascade_folders(cascade):
    low, cas = cascade["low"], cascade["cas"]
    return _model_folder(low.output_folder_base), _model_folder(cas.output_folder_base)


def test_stack_prev_stage_and_predict_from_files_match_jax(cascade, env, tmp_path):
    """The previous stage's segmentation one-hot on the cascade's input
    equals JAX's; ``predict_from_files`` of the lowres stage, then of the
    cascade with its predictions, equals JAX's (fp32, tile batch 2)."""
    low_dir, cas_dir = _cascade_folders(cascade)
    images = str(env["root"] / "raw" / DATASET / "imagesTs")
    preds = {}
    for pkg, make in (("port", lambda: NNUNetPredictor(
            tile_batch_size=2, compute_dtype=torch.float32, device="cpu")),
            ("jax", lambda: JaxPredictor(tile_batch_size=2, compute_dtype="float32"))):
        lo, ca = make(), make()
        lo.initialize_from_trained_model_folder(low_dir, (0,))
        ca.initialize_from_trained_model_folder(cas_dir, (0,))
        lo.predict_from_files(images, str(tmp_path / pkg / "low"))
        ca.predict_from_files(images, str(tmp_path / pkg / "cas"),
                              folder_with_segs_from_prev_stage=str(tmp_path / pkg / "low"))
        preds[pkg] = ca
    rs = np.random.RandomState(1)
    data = rs.randn(1, *SHAPE).astype(np.float32)
    prev = rs.randint(0, 3, (8, 16, 16)).astype(np.uint8)
    got = preds["port"]._stack_prev_stage(data, prev)
    ref = preds["jax"]._stack_prev_stage(data, None, prev, {})
    assert got.shape == (3, *SHAPE) and np.array_equal(got, ref)
    for stage in ("low", "cas"):
        a = NiftiIO().read_seg(str(tmp_path / "port" / stage / "c6.nii.gz"))[0]
        b = NiftiIO().read_seg(str(tmp_path / "jax" / stage / "c6.nii.gz"))[0]
        assert a.shape == (1, *SHAPE) and np.array_equal(a, b), stage


def test_predict_verb_with_prev_stage_predictions(cascade, env, tmp_path):
    """The predict verbs through ``main`` on the CPU (bf16): the lowres
    stage, then the cascade with ``-prev_stage_predictions``; without them
    the cascade raises."""
    low_dir, cas_dir = _cascade_folders(cascade)
    images = str(env["root"] / "raw" / DATASET / "imagesTs")
    common = ["-device", "cpu", "-tile_batch_size", "2", "-f", "0"]
    main(["predict_from_modelfolder", "-i", images, "-o", str(tmp_path / "low"),
          "-m", low_dir, *common])
    main(["predict", "-i", images, "-o", str(tmp_path / "cas"), "-m", cas_dir,
          "-prev_stage_predictions", str(tmp_path / "low"), *common])
    seg = NiftiIO().read_seg(str(tmp_path / "cas" / "c6.nii.gz"))[0]
    assert seg.shape == (1, *SHAPE) and set(np.unique(seg)) <= {0, 1, 2}
    with pytest.raises(ValueError, match="prev_stage_predictions"):
        main(["predict", "-i", images, "-o", str(tmp_path / "x"), "-m", cas_dir, *common])
