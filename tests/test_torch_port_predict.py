"""The PyTorch port's predict verbs against the JAX package's, end to end:
a two-fold model folder written by the JAX package (its checkpoints with
an optax optimizer state inside) is served by both ``NNUNetPredictor``s
over NIfTI cases; the written segmentations must be equal and the
probabilities and logits within max|diff| <= 1e-4 * max|ref| + 1e-5 (fp32).
Also: the verb through ``main`` in bf16, reading a JAX-written checkpoint
without importing JAX, and a reference-format ``.pth`` of the flagship."""
import os
import re
import shutil
import subprocess
import sys
import warnings
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlagg_unet_tpu.imageio.nifti_io import write_nifti
from mlagg_unet_tpu.inference.predictor import NNUNetPredictor as JaxPredictor
from mlagg_unet_tpu.models.mlla_uper import MLLAUper as JaxMLLAUper
from mlagg_unet_tpu.training import registry as jreg
from mlagg_unet_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from mlagg_unet_tpu.training.torch_import import convert_reference_flagship_state_dict
from mlagg_unet_tpu.utils.helpers import save_json
from mlagg_unet_tpu.utils.synthetic_data import make_case
from mlagg_unet_torch.cli import entrypoints
from mlagg_unet_torch.imageio.nifti_io import NiftiIO
from mlagg_unet_torch.inference.predictor import NNUNetPredictor
from mlagg_unet_torch.models.mlla_uper import build_flagship
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from port_helpers import assert_close, flat_params, one_torch_thread, random_jax_params  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))
TRAINER = "nnUNetTrainer_PortTinyFlagship"
NETWORK = "mlla_uper_port_tiny"
DATASET = "Dataset997_PortPredict"
CASES = 4
SHAPE = (3, 44, 38)                       # (z, y, x) of each case on disk
BOX = (slice(0, 3), slice(4, 40), slice(3, 33))  # nonzero: cropped to 3x36x30
SPACING = (2.5, 1.0, 1.0)                 # (z, y, x)
TB = 4

PLANS = {
    "dataset_name": DATASET, "plans_name": "nnUNetPlans", "image_reader_writer": "NiftiIO",
    "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
    "original_median_spacing_after_transp": list(SPACING),
    "original_median_shape_after_transp": [3, 36, 30],
    "foreground_intensity_properties_per_channel": {"0": {
        "mean": 1.0, "std": 1.0, "percentile_00_5": 0.0, "percentile_99_5": 3.0}},
    "configurations": {"2d": {
        "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
        "batch_size": 2, "patch_size": [32, 32], "spacing": [1.0, 1.2],
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [True],
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, "order_z": 0,
                                      "force_separate_z": None},
        "resampling_fn_seg": "resample_data_or_seg_to_shape",
        "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, "order_z": 0,
                                     "force_separate_z": None},
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1, "order_z": 0,
                                               "force_separate_z": None},
        "batch_dice": True}},
}
DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz", "numTraining": 0,
                "labels": {"background": 0, "class1": 1, "class2": 2}}


def _jax_tiny(cin, cout, ds):
    return JaxMLLAUper(out_channels=cout, deep_supervision=ds, **TINY)


def _port_tiny(patch, cin, cout, ds, *, device="cuda", **kw):
    return build_flagship(cout, cin, device=device, deep_supervision=ds, **TINY)


def _register(mp):
    """The tiny flagship as a trainer name in both packages' registries."""
    mp.setitem(jreg.NETWORK_BUILDERS, NETWORK, lambda cm, cin, cout, ds: _jax_tiny(cin, cout, ds))
    mp.setitem(jreg.TRAINER_REGISTRY, TRAINER, replace(
        jreg.TRAINER_REGISTRY["nnUNetTrainer_MLAgg_2D_dt_MS"], name=TRAINER, network=NETWORK))
    mp.setitem(treg.NETWORK_BUILDERS, NETWORK, _port_tiny)
    mp.setitem(treg.TRAINER_REGISTRY, TRAINER, replace(
        treg.TRAINER_REGISTRY["nnUNetTrainer_MLAgg_2D_dt_MS"], name=TRAINER, network=NETWORK))


def _write_cases(folder):
    """Cases of ``synthetic_data.make_case``, zero outside one box (so that
    every case crops to the same shape) and nonzero inside it."""
    os.makedirs(folder)
    rng = np.random.RandomState(0)
    for i in range(CASES):
        img, _ = make_case(rng, SHAPE, 3, SPACING)
        vol = np.zeros(SHAPE, np.float32)
        vol[BOX] = img[BOX] + 0.1
        write_nifti(os.path.join(folder, f"case_{i:03d}_0000.nii.gz"),
                    vol.transpose(2, 1, 0), SPACING[::-1])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The model folder (two folds of JAX-written checkpoints) under
    ``nnUNet_results``, the cases, and the JAX predictor's outputs: files
    written with num_parts=2 and the fold-averaged logits of case 0."""
    root = tmp_path_factory.mktemp("port_predict")
    with pytest.MonkeyPatch.context() as mp:
        _register(mp)
        model = root / "results" / DATASET / f"{TRAINER}__nnUNetPlans__2d"
        os.makedirs(model)
        save_json(PLANS, str(model / "plans.json"))
        save_json(DATASET_JSON, str(model / "dataset.json"))
        jm = _jax_tiny(1, 3, True)
        opt_state = None
        for fold in (0, 1):
            params = random_jax_params(jm, jnp.zeros((1, 32, 32, 1)), seed=fold + 1)
            # the trainer's optimizer state, as the JAX trainer pickles it
            opt_state = opt_state or jax.jit(optax.adamw(1e-3).init)(params)
            os.makedirs(model / f"fold_{fold}")
            jax_save_checkpoint({
                "network_weights": params, "model_state": {},
                "opt_state": opt_state, "current_epoch": 1,
                "trainer_name": TRAINER, "init_args": {"configuration": "2d", "fold": fold},
                "inference_allowed_mirroring_axes": (0, 1),
            }, str(model / f"fold_{fold}" / "checkpoint_final.ckpt"))
        cases = str(root / "imagesTs")
        _write_cases(cases)
        jp = JaxPredictor(tile_batch_size=TB, compute_dtype=None)
        jp.initialize_from_trained_model_folder(str(model), (0, 1))
        out = str(root / "jax_out")
        for part in (0, 1):
            jp.predict_from_files(cases, out, save_probabilities=True, num_parts=2, part_id=part)
        case0 = NiftiIO().read_images([os.path.join(cases, "case_000_0000.nii.gz")])
        yield dict(root=root, model=str(model), cases=cases, jax_out=out, jax=jp,
                   params=params, case0=case0)


def _predictor():
    return NNUNetPredictor(tile_batch_size=TB, compute_dtype=None, device="cpu")


def test_predict_from_files_matches_jax(served, tmp_path):
    """Both folds, num_parts=2, probabilities saved: segmentations equal,
    probabilities within tolerance."""
    p = _predictor()
    p.initialize_from_trained_model_folder(served["model"], (0, 1))
    assert p.allowed_mirroring_axes == (0, 1) and len(p.list_of_parameters) == 2
    out = str(tmp_path / "port_out")
    for part in (0, 1):
        p.predict_from_files(served["cases"], out, save_probabilities=True, num_parts=2,
                             part_id=part)
    names = sorted(f for f in os.listdir(served["jax_out"]) if f.endswith(".nii.gz"))
    assert len(names) == CASES and sorted(
        f for f in os.listdir(out) if f.endswith(".nii.gz")) == names
    for name in names:
        seg_t, props_t = NiftiIO().read_seg(os.path.join(out, name))
        seg_j, props_j = NiftiIO().read_seg(os.path.join(served["jax_out"], name))
        assert seg_t.shape == (1, *SHAPE) and props_t["spacing"] == props_j["spacing"]
        np.testing.assert_array_equal(seg_t, seg_j)
        assert set(np.unique(seg_t)) <= {0, 1, 2} and seg_t[0][BOX].max() > 0
        stem = name[:-len(".nii.gz")]
        prob_t = np.load(os.path.join(out, stem + ".npz"))["probabilities"]
        prob_j = np.load(os.path.join(served["jax_out"], stem + ".npz"))["probabilities"]
        assert prob_t.shape == (3, *SHAPE)
        assert_close(prob_t, prob_j)


def test_fold_averaged_logits_match_jax(served):
    """The preprocessed case 0 through both folds: the fold-averaged logits
    within tolerance of JAX's."""
    p = _predictor()
    p.initialize_from_trained_model_folder(served["model"], None)   # auto-detected folds
    assert len(p.list_of_parameters) == 2
    data, props = served["case0"]
    pre, _, _ = DefaultPreprocessor().run_case_npy(
        data, None, dict(props), p.plans_manager, p.configuration_manager, p.dataset_json)
    got = p.predict_logits_from_preprocessed_data(pre)
    ref = served["jax"].predict_logits_from_preprocessed_data(pre)
    assert got.shape == ref.shape == (3, 3, 36, 25)
    assert_close(got, ref)
    seg = p.predict_single_npy_array(data, props)
    seg_j = served["jax"].predict_single_npy_array(data, props)
    np.testing.assert_array_equal(seg, seg_j)


@pytest.mark.parametrize("form", ["modelfolder", "predict_m", "predict_d_c"])
def test_verb_main_bf16_writes_every_case(served, form, tmp_path, monkeypatch):
    """The verb through ``main`` on the CPU at the default bf16 compute:
    every case written, shaped as its image, with the dataset's labels."""
    from mlagg_unet_torch import paths

    monkeypatch.setattr(paths, "nnUNet_results", str(served["root"] / "results"))
    out = str(tmp_path / form)
    common = ["-i", served["cases"], "-o", out, "-device", "cpu",
              "-tile_batch_size", "3"]
    argv = {"modelfolder": ["predict_from_modelfolder", "-m", served["model"], "-f", "0"],
            "predict_m": ["predict", "-m", served["model"], "--disable_tta"],
            "predict_d_c": ["predict", "-d", "997", "-c", "2d", "-tr", TRAINER,
                            "-num_parts", "2", "-part_id", "1"]}[form]
    entrypoints.main(argv + common)
    names = sorted(f for f in os.listdir(out) if f.endswith(".nii.gz"))
    want = [f"case_{i:03d}.nii.gz" for i in range(CASES)]
    assert names == (want[1::2] if form == "predict_d_c" else want)
    for name in names:
        seg, _ = NiftiIO().read_seg(os.path.join(out, name))
        assert seg.shape == (1, *SHAPE) and set(np.unique(seg)) <= {0, 1, 2}


def test_verb_needs_the_card_unless_told(served, tmp_path, monkeypatch):
    """Without ``-device`` the verb runs on the card and raises without one;
    on the CPU the tile batch must be given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["predict_from_modelfolder", "-i", served["cases"], "-o", str(tmp_path / "o"),
            "-m", served["model"]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entrypoints.main(args)
    with pytest.raises(ValueError, match="tile_batch_size"):
        entrypoints.main(args + ["-device", "cpu"])
    with pytest.raises(NotImplementedError, match="A13"):
        entrypoints.main(args + ["-device", "cpu", "-tile_batch_size", "2",
                                 "-prev_stage_predictions", str(tmp_path)])


def test_step_size_other_than_half_warns():
    """Volumes tile at step 0.5 in both packages: another step size is
    warned about, not silently taken."""
    from mlagg_unet_torch.inference.predictor import NNUNetPredictor

    with pytest.warns(UserWarning, match="tile_step_size=0.25 has no effect"):
        NNUNetPredictor(tile_step_size=0.25, tile_batch_size=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        NNUNetPredictor(tile_step_size=0.5, tile_batch_size=2, device="cpu")


def test_load_jax_checkpoint_without_jax(served):
    """A fresh interpreter reads a JAX-written checkpoint (optax state
    inside), builds the predictor and predicts; no JAX module is loaded."""
    code = f"""
import sys
import warnings
sys.path.insert(0, {str(REPO)!r})
from dataclasses import replace
import numpy as np
from mlagg_unet_torch.models.mlla_uper import build_flagship
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training import registry as treg
from mlagg_unet_torch.training.checkpoint import ForeignObject, load_checkpoint
from mlagg_unet_torch.inference.predictor import NNUNetPredictor
ckpt = load_checkpoint({served['model'] + '/fold_0/checkpoint_final.ckpt'!r})
assert ckpt["trainer_name"] == {TRAINER!r} and ckpt["init_args"]["configuration"] == "2d"
assert isinstance(ckpt["network_weights"]["mlla"], dict)
assert any(isinstance(s, ForeignObject) for s in ckpt["opt_state"]), ckpt["opt_state"]
TINY = {TINY!r}
treg.NETWORK_BUILDERS[{NETWORK!r}] = lambda patch, cin, cout, ds, device="cuda", **kw: \\
    build_flagship(cout, cin, device=device, deep_supervision=ds, **TINY)
treg.register_trainer(replace(treg.TRAINER_REGISTRY["nnUNetTrainer_MLAgg_2D_dt_MS"],
                              name={TRAINER!r}, network={NETWORK!r}))
p = NNUNetPredictor(tile_batch_size=2, compute_dtype=None, device="cpu")
p.initialize_from_trained_model_folder({served['model']!r}, (0,))
out = p.predict_logits_from_preprocessed_data(np.ones((1, 1, 32, 32), np.float32))
assert out.shape == (3, 1, 32, 32) and np.isfinite(out).all()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mlagg_unet_tpu")]
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


# the inverse of REFERENCE_FLAGSHIP_RULES on the flagship's flax keys: one
# reference name for each (the converter must map it back exactly)
_TO_REFERENCE = [
    (r"^mlla\.layer(\d+)\.block(\d+)\.", r"mlla.layers.\1.blocks.\2."),
    (r"^mlla\.down(\d+)\.norm\.GroupNorm_0\.", r"mlla.downs.\1.norm."),
    (r"^mlla\.down(\d+)\.", r"mlla.downs.\1."),
    (r"\.attn_local\.", ".attn.0."),
    (r"\.attn_pool\.", ".attn.1."),
    (r"^mambaskip\.block(\d+)\.", r"mambaskip.blocks.\1."),
    (r"\.conv2d_(\d+)\.", r".conv2d.\1."),
    (r"\.mlp(\d+)\.", r".mlps.\1."),
    (r"\.conv_branch(\d+)\.", r".conv_branches.\1.0."),
    (r"\.conv_norm(\d+)\.GroupNorm_0\.", r".conv_branches.\1.1."),
    (r"^dec_block_(\d+)_(\d+)\.norm\.GroupNorm_0\.", r"dec_block_\1.\2.norm."),
    (r"^dec_block_(\d+)_(\d+)\.", r"dec_block_\1.\2."),
    (r"\.DWConv2d_0\.Conv_0\.", ".dwconv.dwconv."),
    (r"\.dwc\.Conv_0\.", ".dwc."),
    (r"\.lepe\.Conv_0\.", ".lepe."),
    (r"\.Dense_0\.", ".fc1."),
    (r"\.Dense_1\.", ".fc2."),
    (r"^(up_\d+)\.norm\.GroupNorm_0\.", r"\1.norm."),
    (r"^(encoder0|decoder0)\.(.*)\.norm(\d)\.GroupNorm_0\.", r"\1.\2.norm\3."),
    (r"^(encoder0|decoder0)\.(.*)\.(conv\d)\.$", r"\1.\2.\3.conv."),
    (r"^out_(\d)\.conv_out\.", r"out_\1.conv_out.conv."),
]
_REF_TRANSPOSED = re.compile(r"(transp_conv|transpconvs\.\d+|up_\d+\.conv1|up_\d+\.res_conv"
                             r"|out_\d+\.conv_out)(\.conv)?\.(weight|bias)$")


def _reference_state_dict(flat):
    """A reference-named torch state_dict for flax params ``{"a/b/kernel"}``."""
    sd = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        name = ".".join(path) + "."
        for pat, rep in _TO_REFERENCE:
            name = re.sub(pat, rep, name)
        if leaf == "A_logs":
            arr = arr.reshape(-1, arr.shape[-1])
        elif leaf == "Ds":
            arr = arr.reshape(-1)
        elif leaf == "kernel":
            leaf = "weight"
            if arr.ndim >= 3:
                transposed = _REF_TRANSPOSED.search(name + "weight") and arr.shape[-1] != 1
                arr = np.moveaxis(arr, (-2, -1), (0, 1)) if transposed else \
                    np.moveaxis(arr, (-1, -2), (0, 1))
            else:
                arr = arr.T
        elif leaf == "scale":
            leaf = "weight"
        sd[name + leaf] = torch.from_numpy(np.array(arr))
    return sd


def test_reference_pth_loads_and_predicts_like_the_ckpt(served, tmp_path):
    """A reference-format fold_0/checkpoint_final.pth of the same weights:
    JAX's converter maps its names back exactly, the port loads it strict
    and predicts the .ckpt's logits."""
    flat = flat_params(served["params"])
    sd = _reference_state_dict(flat)
    back = convert_reference_flagship_state_dict(sd)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    folder = tmp_path / "pth_model"
    os.makedirs(folder / "fold_1")
    for f in ("plans.json", "dataset.json"):
        shutil.copy(os.path.join(served["model"], f), folder / f)
    torch.save({"network_weights": {"module." + k: v for k, v in sd.items()},
                "trainer_name": TRAINER, "init_args": {"configuration": "2d", "fold": 1},
                "inference_allowed_mirroring_axes": (0, 1)},
               folder / "fold_1" / "checkpoint_final.pth")
    x = np.random.RandomState(5).randn(1, 2, 36, 30).astype(np.float32)
    got = _predictor()
    got.initialize_from_trained_model_folder(str(folder), None, "checkpoint_final.pth")
    ref = _predictor()
    ref.initialize_from_trained_model_folder(served["model"], (1,))
    assert_close(got.predict_logits_from_preprocessed_data(x),
                 ref.predict_logits_from_preprocessed_data(x))
    ckpt = load_checkpoint(os.path.join(served["model"], "fold_1", "checkpoint_final.ckpt"))
    assert ckpt["network_weights"]["mlla"].keys() == served["params"]["mlla"].keys()
