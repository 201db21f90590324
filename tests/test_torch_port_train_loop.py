"""The port's training run against the JAX package's, on the CPU.

The 5-fold split, the deep-supervision scales and weights from the plans,
the loss and the validation step's (tp, fp, fn) for labels, regions and the
ignore label, and ``run_training`` itself: 2 epochs of 2 steps and 1
validation step of the tiny flagship (fp32, drop path 0) from one init on
one fixed batch sequence, in both packages. Then the port alone: resume from
``checkpoint_latest``, and the finite-loss guard; and JAX's predictor
serving the port's ``checkpoint_final.ckpt``. Tolerances are stated per
test.
"""
import os
from dataclasses import replace

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.inference.predictor import NNUNetPredictor as JaxPredictor
from mlagg_unet_tpu.plans.plans_handler import PlansManager as JPlansManager
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.trainer import NNUNetTrainerTPU
from mlagg_unet_tpu.training.trainer import kfold_like_sklearn as j_kfold
from mlagg_unet_torch.imageio.nifti_io import NiftiIO, write_nifti
from mlagg_unet_torch.inference.predictor import NNUNetPredictor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.training.trainer import (
    NNUNetTrainer,
    Trainer,
    deep_supervision_loss_weights,
    deep_supervision_scales,
    kfold_like_sklearn,
)
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


# ------------------------------------------------------------------ split
@pytest.mark.parametrize("n", [5, 7, 11, 23])
def test_kfold_like_sklearn_matches_jax(n):
    keys = [f"case_{i:03d}" for i in range(n)][::-1]
    assert kfold_like_sklearn(keys, 5) == j_kfold(keys, 5)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fold", [0, 3, 4, 7, "all"])
def test_do_split_matches_jax(env, fold, writer):
    """The same split from splits_final.json whichever package wrote it; a
    fold past the fifth takes the 80:20 fallback in both."""
    plans = tiny_plans("Dataset994_PortSplit")
    pre = env["root"] / "preprocessed" / "Dataset994_PortSplit"
    os.makedirs(pre / "nnUNetPlans_2d", exist_ok=True)
    for i in range(9):
        (pre / "nnUNetPlans_2d" / f"c{i}.npz").touch()
    if (pre / "splits_final.json").exists():
        os.remove(pre / "splits_final.json")
    port = NNUNetTrainer(plans, "2d", fold, TINY_DATASET_JSON, trainer_name=TR, device="cpu")
    jax_ = NNUNetTrainerTPU(plans, "2d", fold, TINY_DATASET_JSON, trainer_name=TR,
                            num_devices=1)
    first, second = (port, jax_) if writer == "port" else (jax_, port)
    got = first.do_split()
    assert (pre / "splits_final.json").exists() == (fold != "all")
    assert second.do_split() == got


# --------------------------------------------------- deep supervision, losses
@pytest.mark.parametrize("recipe", ["flagship", "plans"])
def test_deep_supervision_scales_and_weights_match_jax(env, recipe):
    """The flagship's fixed scales keep the lowest weight; scales from the
    plans' pooling (the lowest level dropped) zero the lowest output."""
    config = {} if recipe == "flagship" else dict(deep_supervision_scales_override=None)
    env["mp"].setitem(jreg.TRAINER_REGISTRY, TR + recipe,
                      replace(jreg.TRAINER_REGISTRY[TR], name=TR + recipe, **config))
    cfg = replace(treg.TRAINER_REGISTRY[TR], name=TR + recipe, **config)
    jtr = NNUNetTrainerTPU(PLANS, "2d", 0, TINY_DATASET_JSON, trainer_name=TR + recipe,
                           num_devices=1)
    cm = JPlansManager(PLANS).get_configuration("2d")
    assert deep_supervision_scales(cfg, cm) == jtr._get_deep_supervision_scales()
    for n in range(1, 7):
        np.testing.assert_allclose(deep_supervision_loss_weights(cfg, n),
                                   jtr._get_ds_weights(n), rtol=1e-12)
    assert (deep_supervision_loss_weights(cfg, 5)[-1] == 0) == (recipe == "plans")


class _JaxHead(nn.Module):
    """One Dense over the channels at three scales: a network whose step
    functions compile in a second."""
    out_channels: int
    deep_supervision: bool = True

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        dense = nn.Dense(self.out_channels, name="Dense_0")
        outs = [dense(x), dense(x[:, ::2, ::2]), dense(x[:, ::4, ::4])]
        return outs if self.deep_supervision else outs[0]


class _TorchHead(torch.nn.Module):
    def __init__(self, cin, cout, ds):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(cin, cout)
        self.ds = ds

    def forward(self, x, generator=None):
        outs = [self.Dense_0(x), self.Dense_0(x[:, ::2, ::2]), self.Dense_0(x[:, ::4, ::4])]
        return outs if self.ds else outs[0]


REGIMES = {
    "labels": {"background": 0, "a": 1, "b": 2},
    "ignore": {"background": 0, "a": 1, "b": 2, "ignore": 3},
    "regions": {"background": 0, "whole": [1, 2], "core": 2},
    "regions_ignore": {"background": 0, "whole": [1, 2], "core": 2, "ignore": 3},
}


@pytest.mark.parametrize("ds", [True, False])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_loss_and_val_step_match_jax(env, regime, ds):
    """The loss (plans-derived deep supervision, batch dice) and the
    validation step's loss and (tp, fp, fn) of a one-layer network on 4
    input channels, labels / regions / the ignore label: loss within 1e-6
    relative, the counts equal."""
    name = f"{TR}_{regime}_{ds}"
    labels = REGIMES[regime]
    dj = dict(TINY_DATASET_JSON, labels=labels,
              channel_names={str(i): f"c{i}" for i in range(4)},
              **({"regions_class_order": [1, 2]} if "regions" in regime else {}))
    plans = tiny_plans(DATASET, patch=(16, 16))
    plans["configurations"]["2d"]["pool_op_kernel_sizes"] = [[1, 1], [2, 2], [2, 2]]
    mp = env["mp"]
    mp.setitem(jreg.NETWORK_BUILDERS, "head", lambda cm, cin, cout, d: _JaxHead(cout, d))
    mp.setitem(treg.NETWORK_BUILDERS, "head",
               lambda patch, cin, cout, d, **kw: _TorchHead(cin, cout, d))
    for reg in (jreg, treg):
        mp.setitem(reg.TRAINER_REGISTRY, name, replace(
            reg.TRAINER_REGISTRY[TR], name=name, network="head", enable_deep_supervision=ds,
            deep_supervision_scales_override=None))
    jtr = NNUNetTrainerTPU(plans, "2d", 0, dj, trainer_name=name, num_devices=1)
    lm = jtr.label_manager
    ttr = Trainer(name, num_input_channels=4, num_classes=lm.num_segmentation_heads,
                  batch_size=2, batch_dice=True, device="cpu",
                  regions=lm.all_regions if lm.has_regions else None,
                  ignore_label=lm.ignore_label, configuration_manager=jtr.configuration_manager)
    rs = np.random.RandomState(11)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    y = rs.randint(0, max(v if isinstance(v, int) else max(v) for v in labels.values()) + 1,
                   size=(2, 16, 16)).astype(np.int32)
    outs = [rs.randn(2, 16 // s, 16 // s, lm.num_segmentation_heads).astype(np.float32)
            for s in (1, 2, 4)]
    jtr.ds_scales = jtr._get_deep_supervision_scales()
    assert ttr.ds_scales == jtr.ds_scales
    got = ttr.loss([T(o) for o in outs] if ds else T(outs[0]), T(y))
    ref = jtr._loss_for_outputs([jnp.asarray(o) for o in outs] if ds else jnp.asarray(outs[0]),
                                jnp.asarray(y))
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref)) + 1e-7

    jtr.network, jtr.model_state = _JaxHead(lm.num_segmentation_heads, ds), {}
    params = jtr.network.init(__import__("jax").random.PRNGKey(0), jnp.asarray(x))["params"]
    ttr.network.load_state_dict(jax_params_to_state_dict(flat_params(params)), strict=True)
    jtr._build_step_fns()
    ref = jtr._val_step(params, {}, jnp.asarray(x), jnp.asarray(y))
    got = ttr.val_step(T(x), T(y))
    assert abs(got[0].item() - float(ref[0])) <= 1e-6 * abs(float(ref[0])) + 1e-7
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1].shape == (lm.num_segmentation_heads - (0 if lm.has_regions else 1),)


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
