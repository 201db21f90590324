"""The port's train verb end to end on the CPU, and what it writes against
the JAX package.

The tiny flagship (fp32, drop path 0) trains through
``main(["train", ..., "-device", "cpu"])`` on a preprocessed dataset the
port writes (``run_case_save``), with the real loaders; then:
- JAX's ``perform_actual_validation`` from the same checkpoint writes the
  port's ``validation/summary.json``, within a stated Dice tolerance (both
  predict in bf16);
- ``compute_metrics_on_folder`` of both packages agree exactly;
- ``--c`` on a finished run of one more epoch trains that epoch alone,
  ``--val`` validates again, and the card default raises without a card.
"""
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from mlagg_unet_tpu.evaluation import metrics as JM
from mlagg_unet_tpu.imageio.nifti_io import NiftiIO as JNiftiIO
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.cli import entrypoints
from mlagg_unet_torch.evaluation import metrics as TM
from mlagg_unet_torch.imageio.nifti_io import NiftiIO
from mlagg_unet_torch.inference.predictor import NNUNetPredictor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.training.trainer import NNUNetTrainer
from mlagg_unet_torch.utils.helpers import load_json
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TINY_DATASET_JSON, one_torch_thread, register_tiny_trainer, set_paths, tiny_plans,
    write_preprocessed_dataset)

DATASET = "Dataset995_PortTrainVerb"
TR = "nnUNetTrainer_PortTrainVerb"
PLANS = tiny_plans(DATASET)
EPOCHS = 2
CASES = 6            # fold 0 validates 2 of them
DICE_TOL = 0.05      # per label and case: bf16 predictions of two packages, a
                     # few boundary voxels of a 3x40x36 case apart


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The dataset, then the verb's run of 2 epochs of 4 steps and 2
    validation steps on fold 0."""
    root = tmp_path_factory.mktemp("port_train_verb")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        register_tiny_trainer(mp, TR, num_epochs=EPOCHS, num_iterations_per_epoch=4,
                              num_val_iterations_per_epoch=2, compute_dtype="float32")
        write_preprocessed_dataset(root, DATASET, PLANS, TINY_DATASET_JSON, cases=CASES)
        entrypoints.main(["train", "995", "2d", "0", "-tr", TR, "-device", "cpu"])
        base = root / "results" / DATASET / f"{TR}__nnUNetPlans__2d"
        yield dict(root=root, mp=mp, base=base, fold=base / "fold_0")


def test_verb_writes_the_run(trained):
    """plans and dataset.json beside the folds; the three checkpoints with
    finite losses; a summary with a Dice per label for each validation case."""
    base, fold = trained["base"], trained["fold"]
    assert (base / "plans.json").exists() and (base / "dataset.json").exists()
    for name in ("checkpoint_final.ckpt", "checkpoint_best.ckpt", "checkpoint_latest.ckpt",
                 "debug.json"):
        assert (fold / name).exists(), name
    ck = load_checkpoint(str(fold / "checkpoint_final.ckpt"))
    assert ck["current_epoch"] == EPOCHS and ck["inference_allowed_mirroring_axes"] == (0, 1)
    assert len(ck["logging"]["train_losses"]) == EPOCHS
    assert all(np.isfinite(ck["logging"]["train_losses"] + ck["logging"]["val_losses"]))
    summary = load_json(str(fold / "validation" / "summary.json"))
    assert len(summary["metric_per_case"]) == 2
    for case in summary["metric_per_case"]:
        assert sorted(case["metrics"]) == ["1", "2"]
        assert all(np.isfinite(m["Dice"]) for m in case["metrics"].values())


def test_final_validation_matches_jax(trained, tmp_path):
    """JAX's perform_actual_validation from the port's checkpoint_final: the
    same validation cases, each label's Dice within DICE_TOL of the port's."""
    jtr = NNUNetTrainerTPU(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                           num_devices=1)
    jtr.output_folder = str(tmp_path / "fold_0")
    os.makedirs(jtr.output_folder)
    shutil.copy(trained["fold"] / "checkpoint_final.ckpt", jtr.output_folder)
    ref = jtr.perform_actual_validation()
    got = load_json(str(trained["fold"] / "validation" / "summary.json"))
    assert [os.path.basename(c["reference_file"]) for c in got["metric_per_case"]] == \
        [os.path.basename(c["reference_file"]) for c in ref["metric_per_case"]]
    for g, r in zip(got["metric_per_case"], ref["metric_per_case"]):
        for label in ("1", "2"):
            assert abs(g["metrics"][label]["Dice"] - r["metrics"][int(label)]["Dice"]) \
                <= DICE_TOL, (g["reference_file"], label)
    assert abs(got["foreground_mean"]["Dice"] - ref["foreground_mean"]["Dice"]) <= DICE_TOL


@pytest.mark.parametrize("labels", [[1, 2], [(1, 2), (2,)]], ids=["labels", "regions"])
def test_compute_metrics_on_folder_matches_jax(trained, labels, tmp_path):
    """Both packages' compute_metrics_on_folder on the port's validation
    outputs against the ground truth: equal results."""
    gt = str(trained["root"] / "preprocessed" / DATASET / "gt_segmentations")
    pred = str(trained["fold"] / "validation")
    got = TM.compute_metrics_on_folder(gt, pred, str(tmp_path / "t.json"), NiftiIO(),
                                       ".nii.gz", labels)
    ref = JM.compute_metrics_on_folder(gt, pred, str(tmp_path / "j.json"), JNiftiIO(),
                                       ".nii.gz", labels)
    assert got == ref
    assert load_json(str(tmp_path / "t.json")) == load_json(str(tmp_path / "j.json"))
    simple = TM.compute_metrics_on_folder_simple(gt, pred, [0, 1, 2], ignore_label=None)
    assert simple == JM.compute_metrics_on_folder_simple(gt, pred, [0, 1, 2])


def test_verb_resumes_and_validates(trained):
    """``--c`` on the finished run, with one more epoch in the recipe, loads
    checkpoint_final and trains epoch 2 alone, keeping the logger's first
    epochs; ``--val`` alone writes the summary again."""
    fold = trained["fold"]
    before = load_checkpoint(str(fold / "checkpoint_final.ckpt"))
    mp = trained["mp"]
    mp.setitem(treg.TRAINER_REGISTRY, TR, replace(treg.TRAINER_REGISTRY[TR],
                                                  num_epochs=EPOCHS + 1))
    try:
        entrypoints.main(["train", "995", "2d", "0", "-tr", TR, "-device", "cpu", "--c"])
    finally:
        mp.setitem(treg.TRAINER_REGISTRY, TR, replace(treg.TRAINER_REGISTRY[TR],
                                                      num_epochs=EPOCHS))
    after = load_checkpoint(str(fold / "checkpoint_final.ckpt"))
    assert after["current_epoch"] == EPOCHS + 1
    for k in ("train_losses", "val_losses", "mean_fg_dice", "ema_fg_dice"):
        assert after["logging"][k][:EPOCHS] == before["logging"][k]
    assert after["opt_state"]["count"] == before["opt_state"]["count"] + 4
    os.remove(fold / "validation" / "summary.json")
    entrypoints.main(["train", "995", "2d", "0", "-tr", TR, "-device", "cpu", "--val"])
    assert (fold / "validation" / "summary.json").exists()


def test_pretrained_weights_are_transferred(trained, tmp_path):
    """load_pretrained_weights (the verb's ``-pretrained_weights`` for a
    ``.ckpt``) with the run's own checkpoint into a fresh network: every
    parameter transferred, equal to the checkpoint's."""
    from mlagg_unet_torch.training.load_pretrained_weights import load_pretrained_weights

    tr = NNUNetTrainer(PLANS, "2d", 1, TINY_DATASET_JSON, trainer_name=TR, device="cpu")
    tr.initialize()
    n_tr, n_tot = load_pretrained_weights(tr.step.network,
                                          str(trained["fold"] / "checkpoint_final.ckpt"))
    assert n_tr == n_tot == len(list(tr.step.network.parameters()))
    ref = NNUNetPredictor(tile_batch_size=2, device="cpu")
    ref.initialize_from_trained_model_folder(str(trained["base"]), (0,))
    for k, v in tr.step.network.state_dict().items():
        assert torch.equal(v, ref.list_of_parameters[0][k]), k


def test_verb_needs_the_card_unless_told(trained, monkeypatch):
    """Without ``-device`` the verb runs on the card and raises without one;
    what is not ported raises saying so, and so does a value of
    ``MLAGG_DEVICE_AUG`` that JAX refuses; a stage of a cascade
    reads its previous stage's predictions from beside that stage's folds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entrypoints.main(["train", "995", "2d", "0", "-tr", TR])
    monkeypatch.setitem(treg.TRAINER_REGISTRY, TR + "_zoo", replace(
        treg.TRAINER_REGISTRY[TR], name=TR + "_zoo", network="no_such_network"))
    with pytest.raises(NotImplementedError, match="not ported"):
        entrypoints.main(["train", "995", "2d", "0", "-tr", TR + "_zoo", "-device", "cpu"])
    tr = NNUNetTrainer(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR, device="cpu")
    for value in ("2", "yes"):   # JAX's flag: ord3, 1 and ord1 turn it on
        monkeypatch.setenv("MLAGG_DEVICE_AUG", value)
        with pytest.raises(ValueError, match="ord3"):
            tr.get_dataloaders()
    monkeypatch.delenv("MLAGG_DEVICE_AUG")
    cascade = tiny_plans(DATASET)
    cascade["configurations"]["2d"]["next_stage"] = "2d_cascade"
    cascade["configurations"]["2d_cascade"] = {"inherits_from": "2d", "previous_stage": "2d"}
    first = NNUNetTrainer(cascade, "2d", 0, TINY_DATASET_JSON, trainer_name=TR, device="cpu")
    second = NNUNetTrainer(cascade, "2d_cascade", 0, TINY_DATASET_JSON, trainer_name=TR,
                           device="cpu")
    assert first.previous_stage_folder() is None and first.num_input_channels == 1
    assert second.num_input_channels == 1 + 2 and second.previous_stage_folder() == os.path.join(
        first.output_folder_base, "predicted_next_stage", "2d_cascade")
    with pytest.raises(NotImplementedError, match="no converter"):
        entrypoints.main(["train", "995", "2d", "0", "-tr", TR, "-device", "cpu",
                          "-pretrained_weights", _other_family_pth(trained["root"])])


def _other_family_pth(root) -> str:
    path = str(root / "other_family.pth")
    torch.save({"network_weights": {"encoder.stages.0.0.convs.0.conv.weight":
                                    torch.zeros(8, 1, 3, 3)}}, path)
    return path
