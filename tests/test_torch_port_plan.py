"""The port's fingerprint, planner and preprocessing verbs against the JAX
package's on the CPU.

One synthetic raw dataset (``mlagg_unet_tpu.utils.synthetic_data``, each
case then given its own spacing so that preprocessing resamples it) goes
through the JAX chain (fingerprint extractor, planner, preprocessor) and
through the port's ``plan_and_preprocess`` verb into two preprocessed roots:
the fingerprint and the plans must be equal, the preprocessed cases' seg
exact, their data within 1e-6 of max |data| and their properties (class
locations included) equal.
"""
import shutil

import numpy as np
import pytest

from port_helpers import one_torch_thread, set_paths  # noqa: F401  (autouse)

DATASET = "Dataset801_PortPlan"
TARGET = "Dataset802_PortPlanTarget"
CONFIGS = ("2d", "3d_fullres")
# (z, y, x) spacing per case: in-plane and z vary, so both configurations resample
SPACINGS = ((3.0, 0.8, 0.8), (3.0, 0.75, 0.75), (2.6, 0.85, 0.8), (3.0, 0.8, 0.9),
            (3.4, 0.7, 0.75))


def _respace(path: str, spacing_zyx) -> None:
    from mlagg_unet_tpu.imageio.nifti_io import read_nifti, write_nifti

    data, _ = read_nifti(path)
    write_nifti(path, data, tuple(spacing_zyx[::-1]))


def write_raw(raw_root, name: str, seed: int = 3) -> None:
    from mlagg_unet_tpu.utils.synthetic_data import generate_synthetic_dataset

    base = generate_synthetic_dataset(str(raw_root), name, num_train=len(SPACINGS),
                                      num_test=0, shape=(6, 40, 36), seed=seed)
    for i, sp in enumerate(SPACINGS):
        _respace(f"{base}/imagesTr/case_{i:03d}_0000.nii.gz", sp)
        _respace(f"{base}/labelsTr/case_{i:03d}.nii.gz", sp)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_plan")
    jroot, troot = base / "jax", base / "port"
    write_raw(jroot / "raw", DATASET)
    shutil.copytree(jroot / "raw", troot / "raw")
    with pytest.MonkeyPatch.context() as mp:
        set_paths(mp, jroot, troot)
        from mlagg_unet_tpu.cli.verify_dataset_integrity import verify_dataset_integrity
        from mlagg_unet_tpu.plans.experiment_planner import ExperimentPlanner
        from mlagg_unet_tpu.plans.fingerprint import DatasetFingerprintExtractor
        from mlagg_unet_tpu.preprocessing.preprocessor import DefaultPreprocessor
        from mlagg_unet_torch.cli.entrypoints import plan_and_preprocess_entry

        verify_dataset_integrity(str(jroot / "raw" / DATASET))
        DatasetFingerprintExtractor(DATASET, num_processes=1).run(overwrite_existing=True)
        ExperimentPlanner(DATASET).plan_experiment()
        for c in CONFIGS:
            DefaultPreprocessor().run(DATASET, c, num_processes=1)
        plan_and_preprocess_entry(["-d", "801", "-c", *CONFIGS, "-np", "1",
                                   "--verify_dataset_integrity"])
    return {"base": base, "raw": troot / "raw", "jax": jroot / "preprocessed" / DATASET,
            "port": troot / "preprocessed" / DATASET}


def _load_json(path):
    import json

    with open(path) as f:
        return json.load(f)


def assert_tree_equal(a, b, where="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(map(str, a)) == set(map(str, b)), where
        bs = {str(k): v for k, v in b.items()}
        for k, v in a.items():
            assert_tree_equal(v, bs[str(k)], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def test_fingerprint_equal(roots):
    got = _load_json(roots["port"] / "dataset_fingerprint.json")
    ref = _load_json(roots["jax"] / "dataset_fingerprint.json")
    assert_tree_equal(got, ref)
    # the cases were resampled: their spacings differ
    assert len({tuple(s) for s in ref["spacings"]}) == len(SPACINGS)


@pytest.mark.parametrize("part", ("top", *CONFIGS))
def test_plans_equal(roots, part):
    got = _load_json(roots["port"] / "nnUNetPlans.json")
    ref = _load_json(roots["jax"] / "nnUNetPlans.json")
    assert list(got["configurations"]) == list(ref["configurations"])
    if part == "top":
        assert_tree_equal({k: v for k, v in got.items() if k != "configurations"},
                          {k: v for k, v in ref.items() if k != "configurations"})
    else:
        assert_tree_equal(got["configurations"][part], ref["configurations"][part])
    assert (roots["port"] / "dataset.json").read_bytes() == \
        (roots["jax"] / "dataset.json").read_bytes()


def _cases(folder):
    return sorted(p.name[:-4] for p in folder.glob("*.npz"))


def assert_cases_equal(got_dir, ref_dir) -> None:
    import pickle

    names = _cases(ref_dir)
    assert names and _cases(got_dir) == names
    for n in names:
        got, ref = np.load(got_dir / f"{n}.npz"), np.load(ref_dir / f"{n}.npz")
        assert np.array_equal(got["seg"], ref["seg"]), n
        assert got["data"].shape == ref["data"].shape and got["data"].dtype == ref["data"].dtype
        err = np.abs(got["data"].astype(np.float64) - ref["data"]).max()
        assert err <= 1e-6 * np.abs(ref["data"]).max(), (n, err)
        with open(got_dir / f"{n}.pkl", "rb") as f:
            p_got = pickle.load(f)
        with open(ref_dir / f"{n}.pkl", "rb") as f:
            p_ref = pickle.load(f)
        assert "class_locations" in p_ref
        assert_tree_equal(p_got, p_ref, n)


@pytest.mark.parametrize("config", CONFIGS)
def test_preprocessed_cases_equal(roots, config):
    ident = f"nnUNetPlans_{config}"
    assert_cases_equal(roots["port"] / ident, roots["jax"] / ident)
    # the cases were resampled to the plan's spacing
    plans = _load_json(roots["jax"] / "nnUNetPlans.json")
    sp = plans["configurations"][config]["spacing"]
    shapes = {np.load(p)["data"].shape for p in (roots["jax"] / ident).glob("*.npz")}
    assert len(shapes) > 1, (sp, shapes)


def test_gt_segmentations_copied(roots):
    got = sorted(p.name for p in (roots["port"] / "gt_segmentations").iterdir())
    assert got == sorted(p.name for p in (roots["raw"] / DATASET / "labelsTr").iterdir())
    for n in got:
        assert (roots["port"] / "gt_segmentations" / n).read_bytes() == \
            (roots["jax"] / "gt_segmentations" / n).read_bytes()


def test_preprocess_two_processes_equal_one(roots, tmp_path, monkeypatch):
    """``-np 2`` (spawned workers) writes what ``-np 1`` wrote, and the
    native resampler is built once in the parent before the workers start."""
    from mlagg_unet_torch import native, paths
    from mlagg_unet_torch.cli.entrypoints import preprocess_entry

    builds = []
    build = native.build
    monkeypatch.setattr(native, "build", lambda: builds.append(1) or build())

    pre = tmp_path / DATASET
    pre.mkdir()
    for f in ("dataset_fingerprint.json", "nnUNetPlans.json", "dataset.json"):
        shutil.copy(roots["port"] / f, pre / f)
    monkeypatch.setattr(paths, "nnUNet_raw", str(roots["raw"]))
    monkeypatch.setattr(paths, "nnUNet_preprocessed", str(tmp_path))
    preprocess_entry(["-d", DATASET, "-c", "2d", "-np", "2"])
    assert builds == [1]
    assert_cases_equal(pre / "nnUNetPlans_2d", roots["port"] / "nnUNetPlans_2d")


@pytest.mark.parametrize("broken", (False, True), ids=("complete", "missing_label"))
@pytest.mark.parametrize("package", ("jax", "port"))
def test_verify_dataset_integrity(roots, tmp_path, package, broken):
    if package == "jax":
        from mlagg_unet_tpu.cli.verify_dataset_integrity import verify_dataset_integrity
    else:
        from mlagg_unet_torch.cli.verify_dataset_integrity import verify_dataset_integrity
    folder = tmp_path / DATASET
    shutil.copytree(roots["raw"] / DATASET, folder)
    if broken:
        (folder / "labelsTr" / "case_002.nii.gz").unlink()
        with pytest.raises(AssertionError, match="missing label file for case_002"):
            verify_dataset_integrity(str(folder))
    else:
        verify_dataset_integrity(str(folder))


def test_move_plans_between_datasets_equal(roots, monkeypatch):
    from mlagg_unet_tpu.plans.move_plans import move_plans_between_datasets
    from mlagg_unet_torch.cli.entrypoints import move_plans_between_datasets_entry

    jroot, troot = roots["base"] / "jax", roots["base"] / "port"
    for root in (jroot, troot):
        shutil.copytree(root / "raw" / DATASET, root / "raw" / TARGET, dirs_exist_ok=True)
        (root / "preprocessed" / TARGET).mkdir(exist_ok=True)
    set_paths(monkeypatch, jroot, troot)
    ref = move_plans_between_datasets(DATASET, TARGET, "nnUNetPlans", "nnUNetPlansMoved")
    move_plans_between_datasets_entry(["-s", "801", "-t", "802", "-sp", "nnUNetPlans",
                                       "-tp", "nnUNetPlansMoved"])
    got = troot / "preprocessed" / TARGET / "nnUNetPlansMoved.json"
    assert_tree_equal(_load_json(got), _load_json(ref))
    assert _load_json(got)["configurations"]["2d"]["data_identifier"] == "nnUNetPlansMoved_2d"


@pytest.mark.parametrize("spacing, patch", (
    ((0.8, 0.8), (320, 260)), ((3.0, 0.8, 0.8), (10, 320, 260)),
    ((1.0, 1.0, 1.0), (128, 128, 128)), ((5.0, 0.7, 0.7), (40, 512, 512)),
    ((1.0, 2.5), (200, 90))))
def test_topology_and_feature_map_estimate_equal(spacing, patch):
    """``get_pool_and_conv_props`` and the planner's feature-map count."""
    from mlagg_unet_tpu.plans import experiment_planner as jplan
    from mlagg_unet_tpu.plans import network_topology as jtopo
    from mlagg_unet_torch.plans import experiment_planner as tplan
    from mlagg_unet_torch.plans import network_topology as ttopo

    ref = jtopo.get_pool_and_conv_props(spacing, patch, 4, 999999)
    got = ttopo.get_pool_and_conv_props(spacing, patch, 4, 999999)
    assert_tree_equal(list(got), list(ref))
    pools = ref[1]
    n = len(pools)
    args = (tuple(ref[3]), n, tuple(tuple(p) for p in pools),
            tuple(min(512, 32 * 2 ** i) for i in range(n)), (2,) * n, (2,) * (n - 1), 1, 4)
    assert tplan.compute_unet_feature_map_elements(*args) == \
        jplan.compute_unet_feature_map_elements(*args)
