"""The rest of the CLI in the port (numpy-only copies) against the JAX
package's modules on the same synthetic inputs: the synthetic dataset,
``generate_dataset_json``, every converter ``tests/test_aux.py`` drives and
the two converter verbs, surface Dice on random masks and spacings, the
benchmark evaluation, the overlays and their verb, the batch-run commands;
each pair writes equal files and values. Also the profiling functions off
the card (zero totals, as JAX's off the TPU)."""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from mlagg_unet_tpu import paths as jpaths
from mlagg_unet_tpu.cli import entrypoints as jcli
from mlagg_unet_tpu.dataset_conversion import converters as JC
from mlagg_unet_tpu.dataset_conversion import generate_dataset_json as JG
from mlagg_unet_tpu.evaluation import benchmark_eval as JB
from mlagg_unet_tpu.evaluation import surface_dice as JSD
from mlagg_unet_tpu.utils import batch_running as JBR
from mlagg_unet_tpu.utils import overlay_plots as JO
from mlagg_unet_tpu.utils import synthetic_data as JS
from mlagg_unet_torch import paths as tpaths
from mlagg_unet_torch.cli import entrypoints as tcli
from mlagg_unet_torch.dataset_conversion import converters as TC
from mlagg_unet_torch.dataset_conversion import generate_dataset_json as TG
from mlagg_unet_torch.evaluation import benchmark_eval as TB
from mlagg_unet_torch.evaluation import surface_dice as TSD
from mlagg_unet_torch.imageio.nifti_io import read_nifti, write_nifti
from mlagg_unet_torch.imageio.tiff_io import read_tiff, write_tiff
from mlagg_unet_torch.utils import batch_running as TBR
from mlagg_unet_torch.utils import overlay_plots as TO
from mlagg_unet_torch.utils import profiling as TP
from mlagg_unet_torch.utils import synthetic_data as TS
from mlagg_unet_torch.utils.helpers import load_json, save_json
from port_helpers import one_torch_thread  # noqa: F401  (an autouse fixture)


def _read(path: str):
    """A file's content in a comparable form."""
    if path.endswith(".nii.gz"):
        arr, props = read_nifti(path)
        return arr, props
    if path.endswith(".json"):
        return load_json(path)
    if path.endswith((".png", ".jpg")):
        from PIL import Image

        return np.asarray(Image.open(path))
    if path.endswith(".tif"):
        return read_tiff(path)
    with open(path, "rb") as f:
        return f.read()


def assert_same_tree(a: str, b: str) -> int:
    """Same relative file names under a and b, each with equal content;
    returns the count."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    fa, fb = files(a), files(b)
    assert fa == fb and fa
    for rel in fa:
        x, y = _read(os.path.join(a, rel)), _read(os.path.join(b, rel))
        if isinstance(x, tuple):
            np.testing.assert_array_equal(x[0], y[0], err_msg=rel)
            assert x[1] == y[1], rel
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=rel)
        else:
            assert x == y, rel
    return len(fa)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Each package's nnUNet_raw / _preprocessed / _results under its own
    root."""
    out = {}
    for tag, p in (("jax", jpaths), ("port", tpaths)):
        base = tmp_path / tag
        for var, sub in (("nnUNet_raw", "raw"), ("nnUNet_preprocessed", "preprocessed"),
                         ("nnUNet_results", "results")):
            os.makedirs(base / sub)
            monkeypatch.setattr(p, var, str(base / sub))
        out[tag] = base
    out["src"] = tmp_path / "src"
    return out


def test_synthetic_dataset_and_dataset_json(tmp_path):
    """``generate_synthetic_dataset`` (plain, regions, ignore label, two
    channels) and ``generate_dataset_json`` write equal trees."""
    for i, kw in enumerate((dict(), dict(with_regions=True, num_channels=2),
                            dict(with_ignore_label=True, anisotropic=True))):
        j, t = tmp_path / f"j{i}", tmp_path / f"t{i}"
        for mod, root in ((JS, j), (TS, t)):
            mod.generate_synthetic_dataset(str(root), "Dataset990_Synth", num_train=3,
                                           num_test=1, shape=(8, 12, 10), seed=4, **kw)
        channels = kw.get("num_channels", 1)
        assert assert_same_tree(str(j), str(t)) == 3 * channels + 3 + channels + 1
    for args, kw in (((({0: "CT", 1: "MR"}), {"background": 0, "a": 1}, 7, ".nii.gz"),
                      dict(dataset_name="X", license="cc", description="d")),
                     (({0: "CT"}, {"background": 0, "whole": [1, 2], "core": 2}, 3, ".png"),
                      dict(regions_class_order=(1, 2), overwrite_image_reader_writer="IO"))):
        (tmp_path / "dj" / "j").mkdir(parents=True, exist_ok=True)
        (tmp_path / "dj" / "t").mkdir(parents=True, exist_ok=True)
        JG.generate_dataset_json(str(tmp_path / "dj" / "j"), *args, **kw)
        TG.generate_dataset_json(str(tmp_path / "dj" / "t"), *args, **kw)
        assert_same_tree(str(tmp_path / "dj" / "j"), str(tmp_path / "dj" / "t"))
    with pytest.raises(AssertionError):
        TG.generate_dataset_json(str(tmp_path), {0: "CT"}, {"background": 0, "w": [1, 2]},
                                 1, ".nii.gz")


def _nifti_sources(src, rng):
    """BraTS, KiTS, BTCV, AMOS and ACDC layouts (tests/test_aux.py's)."""
    for c in ("BraTS2021_00000", "BraTS2021_00002"):
        (src / "brats" / c).mkdir(parents=True)
        for mod in ("t1", "t1ce", "t2", "flair"):
            write_nifti(str(src / "brats" / c / f"{c}_{mod}.nii.gz"),
                        rng.rand(6, 6, 6).astype(np.float32), (1, 1, 1))
        write_nifti(str(src / "brats" / c / f"{c}_seg.nii.gz"),
                    rng.choice([0, 1, 2, 4], size=(6, 6, 6)).astype(np.uint8), (1, 1, 1))
    for c in ("case_00000", "case_00001"):
        d = src / "kits" / c
        d.mkdir(parents=True)
        write_nifti(str(d / "imaging.nii.gz"), rng.rand(4, 4, 4).astype(np.float32), (1, 1, 1))
        write_nifti(str(d / "segmentation.nii.gz"),
                    rng.choice([0, 1, 2, 3], (4, 4, 4)).astype(np.uint8), (1, 1, 1))
    for sub in ("Training/img", "Training/label", "Testing/img"):
        (src / "btcv" / sub).mkdir(parents=True)
    write_nifti(str(src / "btcv/Training/img/img0001.nii.gz"),
                rng.rand(4, 4, 4).astype(np.float32), (1, 1, 1))
    write_nifti(str(src / "btcv/Training/label/label0001.nii.gz"),
                rng.choice(range(14), (4, 4, 4)).astype(np.uint8), (1, 1, 1))
    amos = src / "amos"
    for sub in ("imagesTr", "labelsTr", "imagesVa", "labelsVa", "imagesTs"):
        (amos / sub).mkdir(parents=True)
    for ident in ("amos_0007", "amos_0550"):
        write_nifti(str(amos / "imagesTr" / f"{ident}.nii.gz"),
                    rng.rand(4, 4, 4).astype(np.float32), (1, 1, 1))
        write_nifti(str(amos / "labelsTr" / f"{ident}.nii.gz"),
                    rng.choice([0, 1], (4, 4, 4)).astype(np.uint8), (1, 1, 1))
    save_json({"labels": {"0": "background", "1": "spleen"},
               "training": [{"image": f"./imagesTr/amos_{i}.nii.gz"} for i in ("0007", "0550")],
               "validation": [], "test": []}, str(amos / "dataset.json"))
    for p in (1, 21):
        d = src / "acdc" / f"patient{p:03d}"
        d.mkdir(parents=True)
        for fr in (1, 12):
            write_nifti(str(d / f"patient{p:03d}_frame{fr:02d}.nii.gz"),
                        rng.rand(5, 4, 3).astype(np.float32), (1.5, 1.5, 5))
            write_nifti(str(d / f"patient{p:03d}_frame{fr:02d}_gt.nii.gz"),
                        rng.choice(4, (5, 4, 3)).astype(np.uint8), (1.5, 1.5, 5))


def test_nifti_converters(roots):
    """BraTS (and its back-conversion), KiTS, BTCV, AMOS tasks 1 and 2, ACDC
    (with its official split) and the ACDC splits alone."""
    src = roots["src"]
    _nifti_sources(src, np.random.RandomState(0))
    runs = [("convert_brats21", (str(src / "brats"), 937), {}),
            ("convert_kits2023", (str(src / "kits"), 920), {}),
            ("convert_btcv", (str(src / "btcv"), 917), {}),
            ("convert_amos", (str(src / "amos"),), dict(task=1, output_dataset_id=918)),
            ("convert_amos", (str(src / "amos"),), dict(task=2, output_dataset_id=919)),
            ("convert_acdc", (str(src / "acdc"), 27), {})]
    for name, args, kw in runs:
        a, b = getattr(JC, name)(*args, **kw), getattr(TC, name)(*args, **kw)
        assert os.path.relpath(a, roots["jax"]) == os.path.relpath(b, roots["port"])
        assert_same_tree(a, b)
    assert_same_tree(str(roots["jax"] / "preprocessed"), str(roots["port"] / "preprocessed"))
    back = {}
    for tag, mod in (("jax", JC), ("port", TC)):
        back[tag] = str(roots[tag] / "back")
        mod.convert_folder_with_preds_back_to_brats(
            str(roots[tag] / "raw" / "Dataset937_BraTS2021" / "labelsTr"), back[tag])
    assert_same_tree(back["jax"], back["port"])
    idents = [f"patient{p:03d}_frame01" for p in range(1, 101)]
    assert TC.acdc_official_splits(idents) == JC.acdc_official_splits(idents)


def test_image_converters(roots):
    """The PNG 2-D converter, ISIC 2017, road segmentation and Fluo C3DH."""
    from PIL import Image

    rng, src = np.random.RandomState(1), roots["src"]
    for sub in ("imgs", "masks", "isic/ISIC-2017_Training_Data",
                "isic/ISIC-2017_Training_Part1_GroundTruth", "road/training/input",
                "road/training/output"):
        (src / sub).mkdir(parents=True)
    for i in range(3):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(src / f"imgs/im{i}.png")
        Image.fromarray(((rng.rand(32, 32) > 0.5) * 255).astype(np.uint8)).save(
            src / f"masks/im{i}.png")
    for i in range(2):
        Image.fromarray((rng.rand(64, 48, 3) * 255).astype(np.uint8)).save(
            src / "isic/ISIC-2017_Training_Data" / f"ISIC_{i:07d}.jpg")
        Image.fromarray(((rng.rand(64, 48) > 0.5) * 255).astype(np.uint8)).save(
            src / "isic/ISIC-2017_Training_Part1_GroundTruth" / f"ISIC_{i:07d}_segmentation.png")
    img = (rng.rand(20, 20, 3) * 200).astype(np.uint8)
    img[:10, :10] = 255
    Image.fromarray(img).save(src / "road/training/input/a.png")
    Image.fromarray(np.full((20, 20), 255, np.uint8)).save(src / "road/training/output/a.png")
    for seq in ("01", "02"):
        (src / "fluo" / seq).mkdir(parents=True)
        (src / "fluo" / (seq + "_GT") / "SEG").mkdir(parents=True)
        write_tiff(str(src / "fluo" / seq / "t000.tif"), (rng.rand(3, 6, 5) * 100).astype(np.uint16))
        write_tiff(str(src / "fluo" / (seq + "_GT") / "SEG" / "seg000.tif"),
                   rng.choice([0, 1], (3, 6, 5)).astype(np.uint8))
    runs = [("convert_png_2d_dataset", (str(src / "imgs"), str(src / "masks"), 901, "Test"), {}),
            ("convert_isic2017", (str(src / "isic"),), dict(output_dataset_id=916)),
            ("convert_road_segmentation", (str(src / "road"),), dict(output_dataset_id=921)),
            ("convert_fluo_c3dh", (str(src / "fluo"),), dict(output_dataset_id=973))]
    for name, args, kw in runs:
        assert_same_tree(getattr(JC, name)(*args, **kw), getattr(TC, name)(*args, **kw))


def test_converter_verbs(roots, monkeypatch, capsys):
    """``convert_MSD_dataset`` and ``convert_old_nnUNet_dataset`` through
    each package's verb on the same source folders."""
    rng, src = np.random.RandomState(2), roots["src"]
    msd = src / "Task04_Hippo"
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        (msd / sub).mkdir(parents=True)
    for i in range(2):
        write_nifti(str(msd / "imagesTr" / f"hippo_{i}.nii.gz"),
                    rng.rand(5, 6, 4).astype(np.float32), (1, 1, 1.5))
        write_nifti(str(msd / "labelsTr" / f"hippo_{i}.nii.gz"),
                    rng.choice(3, (5, 6, 4)).astype(np.uint8), (1, 1, 1.5))
    write_nifti(str(msd / "imagesTs" / "hippo_9.nii.gz"), rng.rand(5, 6, 4).astype(np.float32),
                (1, 1, 1.5))
    save_json({"name": "Hippo campus", "modality": {"0": "MRI"},
               "labels": {"0": "background", "1": "Anterior", "2": "Posterior"},
               "training": [{"image": f"./imagesTr/hippo_{i}.nii.gz",
                             "label": f"./labelsTr/hippo_{i}.nii.gz"} for i in range(2)],
               "test": ["./imagesTs/hippo_9.nii.gz"]}, str(msd / "dataset.json"))
    old = src / "Task005_Old"
    shutil.copytree(msd / "imagesTr", old / "imagesTr")
    shutil.copytree(msd / "labelsTr", old / "labelsTr")
    save_json({"name": "Old", "tensorImageSize": "3D", "numTest": 0, "training": [], "test": [],
               "modality": {"0": "MRI"}, "labels": {"0": "background", "1": "a"},
               "numTraining": 2}, str(old / "dataset.json"))
    for cli in (jcli, tcli):
        cli.convert_msd_dataset_entry(["-i", str(msd)])
        cli.convert_msd_dataset_entry(["-i", str(msd), "-overwrite_id", "77"])
        cli.convert_old_nnunet_dataset_entry([str(old), "Dataset005_Old"])
    tcli.main(["convert_MSD_dataset", "-i", str(msd), "-overwrite_id", "78"])
    jcli.convert_msd_dataset_entry(["-i", str(msd), "-overwrite_id", "78"])
    assert "wrote" in capsys.readouterr().out
    assert assert_same_tree(str(roots["jax"] / "raw"), str(roots["port"] / "raw")) == 3 * 6 + 5
    with pytest.raises(RuntimeError, match="already exists"):
        tcli.convert_old_nnunet_dataset_entry([str(old), "Dataset005_Old"])


def test_surface_dice_on_random_masks():
    """Surface distances, NSD, overlap, average distance, HD95 and Dice on
    random 3-D and 2-D masks at random anisotropic spacings, empty masks
    included: equal to JAX's."""
    from scipy.ndimage import gaussian_filter

    rs = np.random.RandomState(3)
    cases = []
    for _ in range(4):
        shape = tuple(rs.randint(6, 14, 3))
        gt = gaussian_filter(rs.randn(*shape), 1.5) > 0.1
        pred = gaussian_filter(rs.randn(*shape), 1.5) > 0.1
        cases.append((gt, pred, tuple(rs.uniform(0.5, 3.0, 3))))
    cases.append((np.zeros_like(cases[0][1]), cases[0][1], (1.0, 1.0, 2.0)))
    cases.append((cases[1][0][:, :, :1].repeat(3, 2), cases[1][1][:, :, :1].repeat(3, 2),
                  (1.0, 0.8, 1.2)))
    for gt, pred, spacing in cases:
        a = JSD.compute_surface_distances(gt, pred, spacing)
        b = TSD.compute_surface_distances(gt, pred, spacing)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        for tol in (0.0, 1.0, 2.5):
            np.testing.assert_array_equal(JSD.compute_surface_dice_at_tolerance(a, tol),
                                          TSD.compute_surface_dice_at_tolerance(b, tol))
            np.testing.assert_array_equal(JSD.compute_surface_overlap_at_tolerance(a, tol),
                                          TSD.compute_surface_overlap_at_tolerance(b, tol))
        np.testing.assert_array_equal(JSD.compute_average_surface_distance(a),
                                      TSD.compute_average_surface_distance(b))
        np.testing.assert_array_equal(JSD.compute_robust_hausdorff(a, 95),
                                      TSD.compute_robust_hausdorff(b, 95))
        np.testing.assert_array_equal(JSD.compute_dice_coefficient(gt, pred),
                                      TSD.compute_dice_coefficient(gt, pred))
    assert TSD.ABDOMEN_TOLERANCES_MM == JSD.ABDOMEN_TOLERANCES_MM


def test_benchmark_eval_csv(tmp_path):
    """``evaluate_folder`` on two cases with three labels (one missing from
    a prediction) and a preset's tolerances: equal summaries and CSVs."""
    rs = np.random.RandomState(4)
    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    for i in range(2):
        seg = rs.choice(4, (12, 10, 8), p=[0.55, 0.15, 0.15, 0.15]).astype(np.uint8)
        pred = np.roll(seg, 1, axis=i)
        if i:
            pred[pred == 3] = 0
        write_nifti(str(gt_dir / f"case{i}.nii.gz"), seg, (1, 1.5, 2))
        write_nifti(str(pred_dir / f"case{i}.nii.gz"), pred, (1, 1.5, 2))
    tols = {1: 1.0, 2: 2.0, 3: 3.0}
    a = JB.evaluate_folder(str(gt_dir), str(pred_dir), [1, 2, 3], tols, str(tmp_path / "j.csv"))
    b = TB.evaluate_folder(str(gt_dir), str(pred_dir), [1, 2, 3], tols, str(tmp_path / "t.csv"))
    np.testing.assert_equal(a, b)
    assert (tmp_path / "j.csv").read_text() == (tmp_path / "t.csv").read_text()
    assert TB.PRESETS == JB.PRESETS


def test_overlays_and_their_verb(roots, monkeypatch):
    """``generate_overlay`` on a 2-D slice and ``plot_overlay_pngs`` over a
    synthetic raw dataset through each package's verb: equal PNGs."""
    rs = np.random.RandomState(5)
    img, seg = rs.rand(24, 20).astype(np.float32), rs.choice(3, (24, 20))
    np.testing.assert_array_equal(TO.generate_overlay(img, seg), JO.generate_overlay(img, seg))
    for tag in ("jax", "port"):
        JS.generate_synthetic_dataset(str(roots[tag] / "raw"), "Dataset989_Ov", num_train=2,
                                      num_test=0, shape=(6, 16, 12), seed=1)
    jcli.plot_overlay_pngs_entry(["-d", "989", "-o", str(roots["jax"] / "png"), "-np", "1"])
    tcli.main(["plot_overlay_pngs", "-d", "989", "-o", str(roots["port"] / "png"), "-np", "1"])
    assert assert_same_tree(str(roots["jax"] / "png"), str(roots["port"] / "png")) == 2


def test_batch_running(roots):
    """The train and benchmarking commands (the port's script name in place
    of JAX's) and the benchmark-result CSV from the same result files."""
    kw = dict(configurations=("2d",), folds=(0, 1), submit_template="sub \"{cmd}\"")
    assert TBR.generate_train_commands([4, 5], **kw) == [
        c.replace("mlaggtpu_train", "mlaggtorch_train")
        for c in JBR.generate_train_commands([4, 5], **kw)]
    assert TBR.generate_benchmarking_commands([4], fold=1) == [
        c.replace("mlaggtpu_train", "mlaggtorch_train")
        for c in JBR.generate_benchmarking_commands([4], fold=1)]
    for tag, p in (("jax", jpaths), ("port", tpaths)):
        for c, tr in (("2d", "nnUNetTrainerBenchmark_5epochs"),
                      ("3d_fullres", "nnUNetTrainerBenchmark_5epochs_noDataLoading")):
            folder = os.path.join(p.nnUNet_results, "Dataset004_Hippo",
                                  f"{tr}__nnUNetPlans__{c}", "fold_0")
            os.makedirs(folder)
            save_json({"H100__torch_2": {"fastest_epoch": 1.5 if c == "2d" else 2.5,
                                         "num_devices": 1}},
                      os.path.join(folder, "benchmark_result.json"))
    (roots["jax"] / "raw" / "Dataset004_Hippo").mkdir()
    (roots["port"] / "raw" / "Dataset004_Hippo").mkdir()
    a = JBR.summarize_benchmark_results([4], str(roots["jax"] / "b.csv"))
    b = TBR.summarize_benchmark_results([4], str(roots["port"] / "b.csv"))
    assert a == b and len(a) == 2
    assert (roots["jax"] / "b.csv").read_text() == (roots["port"] / "b.csv").read_text()


def test_profiling_off_the_card():
    """Off the card the two functions give zero totals and empty lists, as
    JAX's do off the TPU (tests/test_aux.py); the scope hooks still open a
    range per module call, and the attribution assigns each launch to the
    innermost range around it."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                                torch.nn.Sequential(torch.nn.Linear(4, 2)))
    x = torch.randn(3, 4)
    assert TP.device_time_ms(model, x, iters=1) == (0.0, [])
    assert TP.device_time_by_scope(model, x, iters=1) == (0.0, [], [])
    with pytest.raises(TypeError):
        TP.device_time_by_scope(lambda v: v, x)
    handles = TP._scope_hooks(model)
    try:
        prof = TP.trace(lambda: model(x), iters=2)
    finally:
        for h in handles:
            h.remove()
    ranges, launches = TP.scope_ranges_and_launches(prof)
    assert sorted({r[2] for r in ranges}) == ["scope::0", "scope::1", "scope::2", "scope::2.0",
                                              "scope::Sequential"]
    assert len(ranges) == 10 and launches == []
    assert TP.device_events(prof) == [] and TP.device_events_averaged(prof) == []
    by, un = TP.attribute_to_scopes(
        [(0, 100, "scope::a"), (10, 50, "scope::a.b.c.d"), (60, 70, "scope::a.e")],
        [(20, 1.0, "k1"), (65, 2.0, "k2"), (80, 3.0, "k3"), (200, 4.0, "k4"), (-1, 5.0, "k5")],
        depth=2)
    assert by == {"a.b": 1.0, "a.e": 2.0, "a": 3.0} and un == {"k4": 4.0, "k5": 5.0}
    assert "jax" not in sys.modules["mlagg_unet_torch.utils.profiling"].__dict__
