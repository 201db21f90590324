"""The port's training run against the JAX package's, on the CPU.

``run_training`` itself: 2 epochs of 2 steps and 1
validation step of the tiny flagship (fp32, drop path 0) from one init on
one fixed batch sequence, in both packages. Then the port alone: resume from
``checkpoint_latest``, and the finite-loss guard; and JAX's predictor
serving the port's ``checkpoint_final.ckpt``. Tolerances are stated per
test.
"""
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from mlagg_unet_tpu.inference.predictor import NNUNetPredictor as JaxPredictor
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_torch.imageio.nifti_io import NiftiIO, write_nifti
from mlagg_unet_torch.inference.predictor import NNUNetPredictor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.training.trainer import NNUNetTrainer
from mlagg_unet_torch.utils.helpers import load_json, save_json
from mlagg_unet_torch.weights import jax_params_to_state_dict
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    TINY_DATASET_JSON, assert_close, flat_params, one_torch_thread, register_tiny_trainer,
    set_paths, tiny_plans)

T = torch.from_numpy
DATASET = "Dataset993_PortTrainLoop"
TR = "nnUNetTrainer_PortTrainLoop"
PLANS = tiny_plans(DATASET)
EPOCHS, STEPS, VAL_STEPS = 2, 2, 1


class _SeqLoader:
    """A stand-in for a data loader: each epoch yields the next ``per_epoch``
    of fixed batches (``cycle``: round and round)."""

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
        x = rs.randn(2, 32, 32, 1).astype(np.float32)
        y = ((x[..., 0] > 0.2).astype(np.int32) + (x[..., 0] > 1.0)).astype(np.int32)
        out.append({"data": x, "target": y})
    return out


def _stand_in_loaders(trainer, train, val):
    def get_dataloaders():
        trainer.dataloader_train = _SeqLoader(train, STEPS)
        trainer.dataloader_val = _SeqLoader(val, VAL_STEPS, cycle=True)
        return trainer.dataloader_train, trainer.dataloader_val
    trainer.get_dataloaders = get_dataloaders


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tiny trainer in both registries and paths under a temporary root."""
    root = tmp_path_factory.mktemp("port_train_loop")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        register_tiny_trainer(mp, TR, num_epochs=EPOCHS, num_iterations_per_epoch=STEPS,
                              num_val_iterations_per_epoch=VAL_STEPS, compute_dtype="float32")
        yield dict(root=root, mp=mp)


@pytest.fixture(scope="module")
def runs(env):
    """run_training of both packages from the JAX trainer's init, on the same
    batch sequence."""
    train, val = _batches(EPOCHS * STEPS, 1), _batches(1, 2)
    jtr = NNUNetTrainerTPU(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                           unpack_data=False, num_devices=1)
    jtr.initialize()
    init = {k: np.array(v) for k, v in flat_params(jtr.params).items()}
    _stand_in_loaders(jtr, train, val)
    jtr.run_training()
    ttr = NNUNetTrainer(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                        unpack_data=False, device="cpu")
    ttr.initialize()
    ttr.step.network.load_state_dict(jax_params_to_state_dict(init), strict=True)
    _stand_in_loaders(ttr, train, val)
    ttr.run_training()
    return jtr, ttr


# ------------------------------------------------------------ run_training
@pytest.mark.parametrize("key", ["train_losses", "val_losses", "mean_fg_dice", "ema_fg_dice",
                                 "dice_per_class_or_region", "lrs"])
def test_run_training_matches_jax(runs, key):
    """The logged series of both runs: within 1e-4 relative (fp32; the
    pseudo dice counts voxels, so any difference there is a flipped argmax)."""
    jtr, ttr = runs
    got = ttr.logger.my_fantastic_logging[key]
    ref = jtr.logger.my_fantastic_logging[key]
    assert len(got) == len(ref) == EPOCHS
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=1e-4, atol=1e-7)


def test_run_training_checkpoints(runs):
    """best, latest and final in the JAX package's format: the epoch count,
    the logger, the JAX param tree and the port's AdamW state."""
    jtr, ttr = runs
    folder = ttr.output_folder
    names = sorted(f for f in os.listdir(folder) if f.endswith(".ckpt"))
    assert names == ["checkpoint_best.ckpt", "checkpoint_final.ckpt", "checkpoint_latest.ckpt"]
    ck = load_checkpoint(os.path.join(folder, "checkpoint_final.ckpt"))
    assert ck["current_epoch"] == EPOCHS and ck["trainer_name"] == TR
    assert ck["logging"]["train_losses"] == ttr.logger.my_fantastic_logging["train_losses"]
    assert ck["opt_state"]["count"] == EPOCHS * STEPS
    assert ck["inference_allowed_mirroring_axes"] is None   # stand-in loaders
    jflat = flat_params(jtr.params)
    tflat = flat_params(ck["network_weights"])
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert_close(tflat[k], jflat[k], rel=1e-3, atol=1e-6)


def test_resume_from_latest_continues(runs, env, tmp_path):
    """A trainer of one more epoch resumes from checkpoint_latest: the epoch
    count, the logger's epochs, AdamW's moments and count; it trains
    epoch 2 alone."""
    _, done = runs
    env["mp"].setitem(treg.TRAINER_REGISTRY, TR + "_3",
                      replace(treg.TRAINER_REGISTRY[TR], name=TR + "_3", num_epochs=EPOCHS + 1))
    tr = NNUNetTrainer(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR + "_3",
                       unpack_data=False, device="cpu")
    tr.output_folder = str(tmp_path)
    tr.initialize()
    tr.load_checkpoint_file(os.path.join(done.output_folder, "checkpoint_latest.ckpt"))
    assert tr.current_epoch == EPOCHS and tr.step.optimizer.count == EPOCHS * STEPS
    for (k, a), b in zip(tr.step.optimizer.opt.state.items(),
                         done.step.optimizer.opt.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and int(a["step"]) == int(b["step"])
    for a, b in zip(tr.step.network.parameters(), done.step.network.parameters()):
        assert torch.equal(a, b)
    before = {k: list(v) for k, v in done.logger.my_fantastic_logging.items()}
    _stand_in_loaders(tr, _batches(STEPS, 5), _batches(1, 2))
    tr.run_training()
    lg = tr.logger.my_fantastic_logging
    assert len(lg["train_losses"]) == EPOCHS + 1 and np.isfinite(lg["train_losses"][-1])
    for k in ("train_losses", "val_losses", "mean_fg_dice", "ema_fg_dice"):
        assert lg[k][:EPOCHS] == before[k][:EPOCHS]
    assert tr.step.optimizer.count == (EPOCHS + 1) * STEPS
    assert load_checkpoint(os.path.join(tr.output_folder, "checkpoint_final.ckpt"))[
        "current_epoch"] == EPOCHS + 1


def test_non_finite_loss_raises(env):
    """The finite-loss guard: an epoch whose loss is NaN raises and names
    the first bad iteration."""
    tr = NNUNetTrainer(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR,
                       unpack_data=False, device="cpu")
    bad = _batches(STEPS, 3)
    bad[1] = dict(bad[1], data=np.full_like(bad[1]["data"], np.nan))
    _stand_in_loaders(tr, bad, _batches(1, 2))
    with pytest.raises(RuntimeError, match="first bad iteration 1 of 2"):
        tr.run_training()


def test_jax_predictor_serves_the_ports_checkpoint(runs, tmp_path):
    """JAX's NNUNetPredictor on the port's checkpoint_final gives the port
    predictor's segmentations (fp32, tile batch 2)."""
    _, ttr = runs
    base = ttr.output_folder_base
    save_json(PLANS, os.path.join(base, "plans.json"), sort_keys=False)
    save_json(TINY_DATASET_JSON, os.path.join(base, "dataset.json"), sort_keys=False)
    cases = tmp_path / "in"
    cases.mkdir()
    rs = np.random.RandomState(6)
    for i in (0, 1):
        write_nifti(str(cases / f"c{i}_0000.nii.gz"), rs.randn(36, 40, 3).astype(np.float32),
                    (1.0, 1.0, 2.0))
    jp = JaxPredictor(tile_batch_size=2, compute_dtype=None)
    jp.initialize_from_trained_model_folder(base, (0,))
    jp.predict_from_files(str(cases), str(tmp_path / "jax"))
    tp = NNUNetPredictor(tile_batch_size=2, compute_dtype=None, device="cpu")
    tp.initialize_from_trained_model_folder(base, (0,))
    tp.predict_from_files(str(cases), str(tmp_path / "port"))
    for i in (0, 1):
        seg_t, _ = NiftiIO().read_seg(str(tmp_path / "port" / f"c{i}.nii.gz"))
        seg_j, _ = NiftiIO().read_seg(str(tmp_path / "jax" / f"c{i}.nii.gz"))
        assert seg_t.shape == (1, 3, 40, 36) and set(np.unique(seg_t)) <= {0, 1, 2}
        np.testing.assert_array_equal(seg_t, seg_j)


def test_benchmark_cached_batch_and_profile(env, tmp_path, monkeypatch):
    """A recipe with ``no_data_loading`` and ``benchmark``: every step takes
    the loader's first batch (the loader is asked for one batch only), the
    fastest epoch is written keyed by the device and the torch version, and
    ``MLAGG_PROFILE_DIR`` receives a trace of epoch 1."""
    env["mp"].setitem(treg.TRAINER_REGISTRY, TR + "_bench", replace(
        treg.TRAINER_REGISTRY[TR], name=TR + "_bench", no_data_loading=True, benchmark=True))
    monkeypatch.setenv("MLAGG_PROFILE_DIR", str(tmp_path / "trace"))
    tr = NNUNetTrainer(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR + "_bench",
                       unpack_data=False, device="cpu")
    tr.output_folder = str(tmp_path / "fold_0")
    _stand_in_loaders(tr, _batches(EPOCHS * STEPS, 1), _batches(1, 2))
    tr.run_training()
    assert tr.dataloader_train.pos == 1
    assert tr.step.optimizer.count == EPOCHS * STEPS
    result = load_json(os.path.join(tr.output_folder, "benchmark_result.json"))
    key = f"cpu__torch_{torch.__version__}"
    assert list(result) == [key] and len(result[key]["epoch_times"]) == EPOCHS
    assert result[key]["fastest_epoch"] == min(result[key]["epoch_times"])
    assert (tmp_path / "trace" / "epoch_1.trace.json").stat().st_size > 0
