"""The nnU-Net pipeline through the port's verbs alone, on the CPU.

A tiny raw dataset goes through ``plan_and_preprocess``; the 2d plan's patch
and network are then set to the tiny flagship's (as ``tests/test_posthoc.py``
edits its plan); a tiny registered trainer trains folds 0 and 1 with
``-device cpu --npz``; ``find_best_configuration`` chooses and writes the
postprocessing; ``predict -device cpu`` and ``apply_postprocessing`` finish
the test case. Also: every ``mlaggtorch_*`` script resolves to a verb of the
port, and each verb's ``--help`` exits 0.
"""
from pathlib import Path

import numpy as np
import pytest

from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    one_torch_thread, register_tiny_trainer, set_paths, tiny_plans)

REPO = Path(__file__).resolve().parent.parent
DATASET = "Dataset804_PortPipeline"
TR = "nnUNetTrainer_PortPipeline"
CASES = 6


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    from mlagg_unet_tpu.utils.synthetic_data import generate_synthetic_dataset
    from mlagg_unet_torch.cli.entrypoints import main
    from mlagg_unet_torch.utils.helpers import load_json, save_json

    root = tmp_path_factory.mktemp("port_pipeline")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, root)
        register_tiny_trainer(mp, TR, num_epochs=1, num_iterations_per_epoch=2,
                              num_val_iterations_per_epoch=1, compute_dtype="float32")
        generate_synthetic_dataset(str(root / "raw"), DATASET, num_train=CASES, num_test=1,
                                   shape=(3, 40, 36), spacing=(2.0, 1.0, 1.0), seed=1)
        main(["plan_and_preprocess", "-d", "804", "-c", "2d", "-np", "1",
              "--verify_dataset_integrity"])
        pre = root / "preprocessed" / DATASET
        plans_file = str(pre / "nnUNetPlans.json")
        plans = load_json(plans_file)
        planned = dict(plans["configurations"]["2d"])
        tiny = tiny_plans(DATASET)["configurations"]["2d"]
        for key in ("patch_size", "batch_size", "pool_op_kernel_sizes"):
            plans["configurations"]["2d"][key] = tiny[key]
        save_json(plans, plans_file, sort_keys=False)
        for fold in ("0", "1"):
            main(["train", "804", "2d", fold, "-tr", TR, "-device", "cpu", "--npz"])
        main(["find_best_configuration", "804", "-c", "2d", "-tr", TR, "-f", "0", "1"])
        info = load_json(str(root / "results" / DATASET / "inference_information.json"))
        out = root / "predicted"
        main(["predict", "-i", str(root / "raw" / DATASET / "imagesTs"), "-o", str(out),
              "-d", "804", "-c", "2d", "-tr", TR, "-f", "0", "1", "-device", "cpu",
              "-tile_batch_size", "4"])
        pkl = info["best_model_or_ensemble"]["postprocessing_file"]
        main(["apply_postprocessing", "-i", str(out), "-o", str(root / "final"),
              "-pp_pkl_file", pkl, "-np", "1"])
        yield dict(root=root, pre=pre, planned=planned, info=info, pkl=pkl,
                   model=root / "results" / DATASET / f"{TR}__nnUNetPlans__2d")


def test_plan_and_preprocess_wrote(pipeline):
    pre = pipeline["pre"]
    fp = (pre / "dataset_fingerprint.json")
    assert fp.exists() and (pre / "dataset.json").exists()
    assert pipeline["planned"]["data_identifier"] == "nnUNetPlans_2d"
    assert len(pipeline["planned"]["patch_size"]) == 2
    cases = sorted((pre / "nnUNetPlans_2d").glob("*.npz"))
    assert len(cases) == CASES
    assert all(c.with_suffix(".pkl").exists() for c in cases)
    assert len(list((pre / "gt_segmentations").glob("*.nii.gz"))) == CASES


def test_training_wrote_both_folds(pipeline):
    from mlagg_unet_torch.utils.helpers import load_json

    for fold in (0, 1):
        f = pipeline["model"] / f"fold_{fold}"
        assert (f / "checkpoint_final.ckpt").exists()
        summary = load_json(str(f / "validation" / "summary.json"))
        assert np.isfinite(summary["foreground_mean"]["Dice"])
        assert list((f / "validation").glob("*.npz"))


def test_find_best_configuration_chose(pipeline):
    best = pipeline["info"]["best_model_or_ensemble"]
    assert best["identifier"] == f"{TR}__nnUNetPlans__2d"
    assert Path(pipeline["pkl"]).exists()
    merged = pipeline["model"] / "crossval_results_folds_0_1"
    val = [p.name for f in (0, 1)
           for p in (pipeline["model"] / f"fold_{f}" / "validation").glob("*.nii.gz")]
    assert sorted(p.name for p in merged.glob("*.nii.gz")) == sorted(val)
    assert (merged / "summary.json").exists()


def test_predicted_and_postprocessed(pipeline):
    from mlagg_unet_torch.imageio.nifti_io import NiftiIO

    root = pipeline["root"]
    for folder in ("predicted", "final"):
        files = sorted((root / folder).glob("*.nii.gz"))
        assert [f.name for f in files] == ["case_ts_000.nii.gz"]
        seg, props = NiftiIO().read_seg(str(files[0]))
        assert seg.shape == (1, 3, 40, 36)
        assert set(np.unique(seg)) <= {0, 1, 2}


def _scripts():
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items() if k.startswith("mlaggtorch_")}


@pytest.mark.parametrize("script", sorted(_scripts()))
def test_script_resolves_to_a_port_verb(script):
    from mlagg_unet_torch.cli import entrypoints

    module, fn = _scripts()[script].split(":")
    assert module == "mlagg_unet_torch.cli.entrypoints"
    assert getattr(entrypoints, fn) in entrypoints._VERBS.values()


def _verbs():
    from mlagg_unet_torch.cli.entrypoints import _VERBS

    return sorted(_VERBS)


def test_every_verb_has_a_script():
    from mlagg_unet_torch.cli import entrypoints

    targets = {v.split(":")[1] for v in _scripts().values()}
    assert {f.__name__ for f in entrypoints._VERBS.values()} == targets
    assert len(targets) == 20 and "download_model_entry" not in targets


@pytest.mark.parametrize("verb", _verbs())
def test_verb_help_exits_zero(verb, capsys):
    from mlagg_unet_torch.cli.entrypoints import main

    with pytest.raises(SystemExit) as e:
        main([verb, "--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out
