"""The port's post-hoc verbs against the JAX package's on the CPU.

Seeded validation folders of two trainers (folds 0 and 1: ``.nii.gz``
segmentations, ``.npz`` probabilities and ``.pkl`` properties), their ground
truth and a 2d plan are copied into a JAX root and a port root. The JAX
package's ``find_best_configuration`` verb and the port's then run on each:
every ``summary.json``, the ensemble's segmentations, ``postprocessing.pkl``
and ``inference_information.json`` (apart from the roots) must be equal.
The ensembling, postprocessing and evaluation verbs are held the same way,
and a model goes through the export/install zip round trip.
"""
import json
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from port_helpers import one_torch_thread, set_paths, tiny_plans  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
DATASET = "Dataset803_PortPosthoc"
TRAINERS = ("TrA", "TrB")
FOLDS = {0: (0, 1, 2), 1: (3, 4, 5)}
SHAPE = (4, 24, 20)           # (z, y, x)
SPACING_XYZ = (1.0, 1.0, 2.0)
DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz", "numTraining": 6,
                "labels": {"background": 0, "a": 1, "b": 2}}


def _ball(center, radius):
    z, y, x = np.indices(SHAPE)
    return ((z - center[0]) * 2) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2 \
        <= radius ** 2


def _gt(rs):
    """One blob of label 1 with a blob of label 2 inside it."""
    c = (rs.randint(1, 3), rs.randint(9, 15), rs.randint(8, 12))
    seg = _ball(c, rs.uniform(6, 8)).astype(np.uint8)
    seg[_ball(c, rs.uniform(2.5, 4))] = 2
    return seg


def _prediction(rs, gt):
    """Probabilities of a noisy model: the truth's one-hot plus noise, and a
    few small islands of each label away from the blob."""
    logits = 2.5 * np.eye(3, dtype=np.float32)[gt].transpose(3, 0, 1, 2)
    logits += rs.randn(*logits.shape).astype(np.float32)
    for label in (1, 2):
        for _ in range(rs.randint(1, 3)):
            z, y, x = rs.randint(0, SHAPE[0]), rs.randint(0, 5), rs.randint(0, SHAPE[2] - 2)
            logits[label, z, y:y + 2, x:x + 2] += 8
    e = np.exp(logits - logits.max(0))
    return (e / e.sum(0)).astype(np.float32)


def write_seed(root: Path) -> None:
    """raw/, preprocessed/ and results/ of the dataset under ``root``."""
    from mlagg_unet_tpu.imageio.nifti_io import NiftiIO, write_nifti
    from mlagg_unet_tpu.utils.helpers import save_json

    raw = root / "raw" / DATASET
    gt_dir = root / "preprocessed" / DATASET / "gt_segmentations"
    for d in (raw / "labelsTr", gt_dir):
        d.mkdir(parents=True)
    plans = tiny_plans(DATASET)
    save_json(DATASET_JSON, str(raw / "dataset.json"), sort_keys=False)
    save_json(plans, str(root / "preprocessed" / DATASET / "nnUNetPlans.json"), sort_keys=False)
    rs = np.random.RandomState(11)
    gts = [_gt(rs) for _ in range(6)]
    for i, gt in enumerate(gts):
        for d in (raw / "labelsTr", gt_dir):
            write_nifti(str(d / f"case_{i}.nii.gz"), gt.transpose(2, 1, 0), SPACING_XYZ)
    _, props = NiftiIO().read_seg(str(gt_dir / "case_0.nii.gz"))
    for tr in TRAINERS:
        folder = root / "results" / DATASET / f"{tr}__nnUNetPlans__2d"
        folder.mkdir(parents=True)
        save_json(plans, str(folder / "plans.json"), sort_keys=False)
        save_json(DATASET_JSON, str(folder / "dataset.json"), sort_keys=False)
        for fold, cases in FOLDS.items():
            val = folder / f"fold_{fold}" / "validation"
            val.mkdir(parents=True)
            (folder / f"fold_{fold}" / "checkpoint_final.ckpt").write_bytes(
                rs.bytes(64))
            for i in cases:
                probs = _prediction(rs, gts[i])
                NiftiIO().write_seg(probs.argmax(0).astype(np.uint8),
                                    str(val / f"case_{i}.nii.gz"), props)
                np.savez_compressed(val / f"case_{i}.npz", probabilities=probs)
                with open(val / f"case_{i}.pkl", "wb") as f:
                    pickle.dump(props, f)


FIND_BEST = ["803", "-c", "2d", "-tr", *TRAINERS, "-f", "0", "1"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_posthoc")
    seed = base / "seed"
    write_seed(seed)
    jroot, troot = base / "jax", base / "port"
    shutil.copytree(seed, jroot)
    shutil.copytree(seed, troot)
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, jroot, troot)
        from mlagg_unet_tpu.cli import entrypoints as jcli
        from mlagg_unet_torch.cli import entrypoints as tcli

        jcli.find_best_configuration_entry(FIND_BEST)
        tcli.find_best_configuration_entry(FIND_BEST)
    return {"seed": seed, "jax": jroot, "port": troot}


def _json(path: Path, *roots: Path):
    text = path.read_text()
    for i, root in enumerate(roots):
        text = text.replace(str(root), f"<ROOT{i}>")
    return json.loads(text)


def _seg(path):
    from mlagg_unet_tpu.imageio.nifti_io import NiftiIO

    seg, props = NiftiIO().read_seg(str(path))
    return seg, props["spacing"]


def assert_segs_equal(got_dir: Path, ref_dir: Path) -> None:
    names = sorted(p.name for p in ref_dir.glob("*.nii.gz"))
    assert names and names == sorted(p.name for p in got_dir.glob("*.nii.gz"))
    for n in names:
        (g, gs), (r, rsp) = _seg(got_dir / n), _seg(ref_dir / n)
        assert np.array_equal(g, r) and list(gs) == list(rsp), n


def _rel(roots, pkg, *parts) -> Path:
    return roots[pkg].joinpath("results", DATASET, *parts)


@pytest.mark.parametrize("trainer", TRAINERS)
def test_crossval_summaries_equal(roots, trainer):
    sub = (f"{trainer}__nnUNetPlans__2d", "crossval_results_folds_0_1")
    got = _json(_rel(roots, "port", *sub, "summary.json"), roots["port"])
    ref = _json(_rel(roots, "jax", *sub, "summary.json"), roots["jax"])
    assert got == ref and len(ref["metric_per_case"]) == 6
    assert_segs_equal(_rel(roots, "port", *sub), _rel(roots, "jax", *sub))


def test_ensemble_equal(roots):
    ens = "ensemble___TrA__nnUNetPlans__2d___TrB__nnUNetPlans__2d___0_1"
    assert_segs_equal(_rel(roots, "port", "ensembles", ens), _rel(roots, "jax", "ensembles", ens))
    assert _json(_rel(roots, "port", "ensembles", ens, "summary.json"), roots["port"]) == \
        _json(_rel(roots, "jax", "ensembles", ens, "summary.json"), roots["jax"])


def test_inference_information_and_postprocessing_equal(roots):
    got = _json(_rel(roots, "port", "inference_information.json"), roots["port"])
    ref = _json(_rel(roots, "jax", "inference_information.json"), roots["jax"])
    assert got == ref
    assert set(ref["all_results"]) == {"TrA__nnUNetPlans__2d", "TrB__nnUNetPlans__2d",
                                       "ensemble___TrA__nnUNetPlans__2d___TrB__"
                                       "nnUNetPlans__2d___0_1"}
    best = got["best_model_or_ensemble"]
    pkl = Path(best["postprocessing_file"].replace("<ROOT0>", str(roots["port"])))
    ref_pkl = Path(best["postprocessing_file"].replace("<ROOT0>", str(roots["jax"])))
    with open(pkl, "rb") as f, open(ref_pkl, "rb") as g:
        pp, pp_ref = pickle.load(f), pickle.load(g)
    assert pp == pp_ref and pp["fn_names"], pp
    folder = pkl.parent
    ref_folder = ref_pkl.parent
    assert _json(folder / "postprocessing.json", roots["port"]) == \
        _json(ref_folder / "postprocessing.json", roots["jax"])
    assert_segs_equal(Path(str(folder) + "_postprocessed"), Path(str(ref_folder) + "_postprocessed"))


def test_accumulate_crossval_results_equal(roots, tmp_path, monkeypatch):
    from mlagg_unet_tpu.postprocessing.find_best_configuration import accumulate_cv_results
    from mlagg_unet_torch.cli.entrypoints import accumulate_crossval_results_entry

    set_paths(monkeypatch, roots["jax"], roots["port"])
    model = _rel(roots, "jax", "TrB__nnUNetPlans__2d")
    accumulate_cv_results(str(model), str(tmp_path / "jax"), (0, 1), num_processes=1)
    accumulate_crossval_results_entry(["803", "-c", "2d", "-tr", "TrB", "-f", "0", "1",
                                       "-o", str(tmp_path / "port")])
    assert_segs_equal(tmp_path / "port", tmp_path / "jax")
    assert _json(tmp_path / "port" / "summary.json", tmp_path / "port", roots["port"]) == \
        _json(tmp_path / "jax" / "summary.json", tmp_path / "jax", roots["jax"])


def _predict_folders(roots, tmp_path):
    """Two folders as the predict verb writes them with --save_probabilities."""
    out = []
    for tr in TRAINERS:
        d = tmp_path / f"pred_{tr}"
        d.mkdir()
        model = roots["seed"] / "results" / DATASET / f"{tr}__nnUNetPlans__2d"
        for f in (model / "fold_0" / "validation").iterdir():
            shutil.copy(f, d / f.name)
        for f in ("plans.json", "dataset.json"):
            shutil.copy(model / f, d / f)
        out.append(d)
    return out


def test_ensemble_folders_equal(roots, tmp_path):
    from mlagg_unet_tpu.postprocessing.ensembling import ensemble_folders
    from mlagg_unet_torch.cli.entrypoints import ensemble_entry

    folders = _predict_folders(roots, tmp_path)
    ensemble_folders([str(f) for f in folders], str(tmp_path / "jax"), num_processes=1)
    ensemble_entry(["-i", *map(str, folders), "-o", str(tmp_path / "port")])
    assert_segs_equal(tmp_path / "port", tmp_path / "jax")
    assert len(list((tmp_path / "port").glob("*.nii.gz"))) == len(FOLDS[0])


def test_determine_and_apply_postprocessing_equal(roots, tmp_path):
    """determine_postprocessing in both packages, then apply_postprocessing:
    the port applying the pkl that JAX wrote, and JAX the port's."""
    from mlagg_unet_tpu.postprocessing.remove_connected_components import (
        apply_postprocessing_to_folder, determine_postprocessing)
    from mlagg_unet_torch.cli.entrypoints import (apply_postprocessing_entry,
                                                  determine_postprocessing_entry)

    gt = roots["seed"] / "preprocessed" / DATASET / "gt_segmentations"
    pred = _predict_folders(roots, tmp_path)[0]
    jdir, tdir = tmp_path / "jax_pred", tmp_path / "port_pred"
    shutil.copytree(pred, jdir)
    shutil.copytree(pred, tdir)
    determine_postprocessing(str(jdir), str(gt), str(jdir / "plans.json"),
                             str(jdir / "dataset.json"), num_processes=1)
    determine_postprocessing_entry(["-i", str(tdir), "-ref", str(gt)])
    with open(jdir / "postprocessing.pkl", "rb") as f, open(tdir / "postprocessing.pkl", "rb") as g:
        pp_ref, pp = pickle.load(f), pickle.load(g)
    assert pp == pp_ref and pp["fn_names"]
    assert _json(tdir / "postprocessing.json", tmp_path) == \
        _json(jdir / "postprocessing.json", tmp_path)
    assert_segs_equal(Path(str(tdir) + "_postprocessed"), Path(str(jdir) + "_postprocessed"))

    apply_postprocessing_entry(["-i", str(pred), "-o", str(tmp_path / "port_applied"),
                                "-pp_pkl_file", str(jdir / "postprocessing.pkl")])
    apply_postprocessing_to_folder(str(pred), str(tmp_path / "jax_applied"),
                                   str(tdir / "postprocessing.pkl"), num_processes=1)
    assert_segs_equal(tmp_path / "port_applied", tmp_path / "jax_applied")
    assert_segs_equal(tmp_path / "port_applied", Path(str(jdir) + "_postprocessed"))


_APPLY_WITHOUT_JAX = """
import sys
from mlagg_unet_torch.cli.entrypoints import main
main(["apply_postprocessing", "-i", sys.argv[1], "-o", sys.argv[2], "-pp_pkl_file", sys.argv[3]])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "mlagg_unet_tpu")]
assert not bad, bad
"""


def test_jax_pkl_applies_without_jax(roots, tmp_path):
    """A postprocessing.pkl the JAX package wrote (function names, no
    pickled functions) applies in a fresh interpreter with no JAX module."""
    pkl = _rel(roots, "jax", "ensembles",
               "ensemble___TrA__nnUNetPlans__2d___TrB__nnUNetPlans__2d___0_1",
               "postprocessing.pkl")
    inp = _rel(roots, "jax", "TrA__nnUNetPlans__2d", "crossval_results_folds_0_1")
    subprocess.run([sys.executable, "-c", _APPLY_WITHOUT_JAX, str(inp), str(tmp_path / "out"),
                    str(pkl)], cwd=REPO, check=True, timeout=120)
    from mlagg_unet_tpu.postprocessing.remove_connected_components import (
        apply_postprocessing_to_folder)

    apply_postprocessing_to_folder(str(inp), str(tmp_path / "ref"), str(pkl), num_processes=1)
    assert_segs_equal(tmp_path / "out", tmp_path / "ref")


@pytest.mark.parametrize("verb", ("evaluate_folder", "evaluate_simple"))
def test_evaluate_equal(roots, tmp_path, verb):
    from mlagg_unet_tpu.cli import entrypoints as jcli
    from mlagg_unet_torch.cli import entrypoints as tcli

    gt = roots["seed"] / "preprocessed" / DATASET / "gt_segmentations"
    pred = _predict_folders(roots, tmp_path)[1]
    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        outs[name] = tmp_path / f"{name}.json"
        if verb == "evaluate_folder":
            args = [str(gt), str(pred), "-djfile", str(pred / "dataset.json"),
                    "-pfile", str(pred / "plans.json"), "-o", str(outs[name])]
        else:
            args = [str(gt), str(pred), "-l", "1", "2", "-o", str(outs[name]), "-np", "1"]
        getattr(cli, verb + "_entry")(args)
    got, ref = json.loads(outs["port"].read_text()), json.loads(outs["jax"].read_text())
    assert got == ref and np.isfinite(ref["foreground_mean"]["Dice"])


def test_export_install_round_trip(roots, tmp_path, monkeypatch):
    """The port's export holds what JAX's export holds; the port's install
    into a fresh results root restores those files byte for byte."""
    from mlagg_unet_tpu.postprocessing.model_sharing import export_pretrained_model
    from mlagg_unet_torch import paths
    from mlagg_unet_torch.cli.entrypoints import export_model_entry, install_model_entry

    set_paths(monkeypatch, roots["jax"], roots["port"])
    export_pretrained_model(DATASET, str(tmp_path / "jax.zip"), ("2d",), "TrA",
                            folds=(0, 1))
    export_model_entry(["-d", "803", "-o", str(tmp_path / "port.zip"), "-c", "2d",
                        "-tr", "TrA", "-f", "0", "1"])
    import zipfile

    with zipfile.ZipFile(tmp_path / "port.zip") as z, zipfile.ZipFile(tmp_path / "jax.zip") as y:
        names = sorted(z.namelist())
        assert names == sorted(y.namelist())
    assert f"{DATASET}/TrA__nnUNetPlans__2d/fold_1/checkpoint_final.ckpt" in names
    assert f"{DATASET}/inference_information.json" in names
    monkeypatch.setattr(paths, "nnUNet_results", str(tmp_path / "fresh"))
    install_model_entry([str(tmp_path / "port.zip")])
    for n in names:
        assert (tmp_path / "fresh" / n).read_bytes() == \
            (roots["port"] / "results" / n).read_bytes(), n
