"""Helpers shared by the tests of the PyTorch port (``tests/test_torch_port_*``).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU, as ``conftest.py`` forces) and the port; weights go from a
flax ``init`` through ``jax_params_to_state_dict`` into the port's module.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from mlagg_unet_torch.weights import jax_params_to_state_dict


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the importing test module's torch ops on one CPU thread. Its ops
    are tiny, and under the suite's parallel workers torch's intra-op
    threads oversubscribe the cores: each op's thread barrier then waits on
    descheduled threads (a tiny-flagship train step ran ~50x slower in a
    full run than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_jax_params(module, *inputs, seed: int = 0):
    """A flax module's param tree with random values from a numpy seed.

    The tree's shapes come from ``jax.eval_shape(module.init, ...)``; the
    values are drawn here instead of by flax's init, whose threefry draws
    cost the CPU more (~25 s jitted for the tiny flagship) than the forward
    they feed. Scales sit near 1, biases near 0, kernels at variance
    1/fan_in, and the scan's A_logs, Ds and dt bias near their S4D init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        n = rs.randn(*shape).astype(np.float32)
        if name == "kernel" or name == "x_proj_weight":
            v = n / np.sqrt(np.prod(shape) / shape[-1])
        elif name in ("scale", "Ds"):
            v = 1 + 0.1 * n
        elif name == "A_logs":
            v = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32)) + 0.1 * n
        elif name == "dt_projs_bias":
            dt = np.exp(rs.uniform(np.log(1e-3), np.log(0.1), shape))
            v = dt + np.log(-np.expm1(-dt))
        elif name == "dt_projs_weight":
            v = rs.uniform(-1, 1, shape) / np.sqrt(shape[-1])
        else:  # biases, lambda_*, grn_*
            v = 0.1 * n
        return jnp.asarray(np.asarray(v, np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flat_params(params, prefix: str = "") -> dict:
    return {prefix + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(params).items()}


def load_jax_params(module: torch.nn.Module, params, prefix: str = ""):
    """Load a flax param tree into ``module`` (strict). ``prefix`` names
    the scope for rules keyed on it (transposed convs) and is stripped."""
    sd = jax_params_to_state_dict(flat_params(params, prefix))
    strip = prefix.replace("/", ".")
    module.load_state_dict({k[len(strip):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def assert_close(got, ref, rel: float = 1e-4, atol: float = 1e-5):
    """max |got - ref| <= rel * max |ref| + atol (the port's fp32 tolerance)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    bound = rel * float(np.abs(ref).max()) + atol
    assert err <= bound, f"max |diff| {err:.3e} > {bound:.3e}"


# --------------------------------------------------------------------------
# the tiny flagship as a trainer of both packages, for the training-run tests
# --------------------------------------------------------------------------
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))


def _jax_tiny_class():
    import dataclasses

    from mlagg_unet_tpu.models.mlla_uper import MLLAUper

    class DeterministicTiny(MLLAUper):
        """The JAX flagship with no stochastic depth in training (its skip's
        drop path is fixed at 0.1), so that a train step is the port's at
        drop path 0; ``init`` draws from numpy (``random_jax_params``), as
        flax's own init takes ~100 s on the CPU."""

        def init(self, rngs, *args, **kwargs):
            plain = MLLAUper(**{f.name: getattr(self, f.name)
                                for f in dataclasses.fields(MLLAUper)
                                if f.name not in ("parent", "name")}, parent=None)
            return {"params": random_jax_params(plain, *args)}

        def __call__(self, x, deterministic: bool = True):
            return super().__call__(x, True)

    return DeterministicTiny


def register_tiny_trainer(mp, name: str, **config):
    """``name``: the flagship recipe on the tiny flagship (drop path 0), in
    both packages' registries, with ``config`` replacing recipe fields."""
    from dataclasses import replace

    from mlagg_unet_tpu.training import registry as jreg
    from mlagg_unet_torch.models.mlla_uper import build_flagship
    from mlagg_unet_torch.training import registry as treg

    network = name + "_network"
    jax_cls = _jax_tiny_class()
    mp.setitem(jreg.NETWORK_BUILDERS, network, lambda cm, cin, cout, ds: jax_cls(
        out_channels=cout, deep_supervision=ds, drop_path_rate=0.0, **TINY))
    mp.setitem(treg.NETWORK_BUILDERS, network,
               lambda patch, cin, cout, ds, *, seed=0, device="cuda", **kw: build_flagship(
                   cout, cin, seed=seed, device=device, deep_supervision=ds,
                   drop_path_rate=0.0, skip_drop_path=0.0, **TINY, **kw))
    for reg in (jreg, treg):
        mp.setitem(reg.TRAINER_REGISTRY, name, replace(
            reg.TRAINER_REGISTRY["nnUNetTrainer_MLAgg_2D_dt_MS"], name=name,
            network=network, **config))


def set_paths(mp, root, port_root=None) -> None:
    """nnUNet_raw / _preprocessed / _results under ``root``, in both
    packages, or the port's under ``port_root`` when given."""
    from mlagg_unet_tpu import paths as jpaths
    from mlagg_unet_torch import paths as tpaths

    for p, base in ((jpaths, root), (tpaths, root if port_root is None else port_root)):
        for var, sub in (("nnUNet_raw", "raw"), ("nnUNet_preprocessed", "preprocessed"),
                         ("nnUNet_results", "results")):
            mp.setattr(p, var, str(base / sub))


def tiny_plans(dataset_name: str, patch=(32, 32), batch: int = 2) -> dict:
    """A 2d plan at the tiny flagship's patch: ZScore, NiftiIO, no resampling."""
    resample = "resample_data_or_seg_to_shape"
    return {
        "dataset_name": dataset_name, "plans_name": "nnUNetPlans",
        "image_reader_writer": "NiftiIO", "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "original_median_spacing_after_transp": [2.0, 1.0, 1.0],
        "original_median_shape_after_transp": [3, 40, 36],
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": 0.0, "std": 1.0, "percentile_00_5": -3.0, "percentile_99_5": 3.0}},
        "configurations": {"2d": {
            "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": batch, "patch_size": list(patch), "spacing": [1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
            "resampling_fn_data": resample,
            "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, "order_z": 0,
                                          "force_separate_z": None},
            "resampling_fn_seg": resample,
            "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, "order_z": 0,
                                         "force_separate_z": None},
            "resampling_fn_probabilities": resample,
            "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1,
                                                   "order_z": 0, "force_separate_z": None},
            "batch_dice": True,
            "pool_op_kernel_sizes": [[1, 1], [2, 2], [2, 2], [2, 2], [2, 2]]}},
    }


TINY_DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz",
                     "numTraining": 5, "labels": {"background": 0, "a": 1, "b": 2}}


def write_preprocessed_dataset(root, dataset_name: str, plans: dict, dataset_json: dict,
                               cases: int = 5, shape=(3, 40, 36)) -> None:
    """Raw images and labels of smooth seeded blobs (labels: two thresholds
    of the image) under nnUNet_raw, their ground truth and the preprocessed
    2d cases (the port's ``run_case_save``), the plans and dataset.json
    under nnUNet_preprocessed."""
    import os

    from scipy.ndimage import gaussian_filter

    from mlagg_unet_torch.imageio.nifti_io import write_nifti
    from mlagg_unet_torch.plans.plans_handler import PlansManager
    from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
    from mlagg_unet_torch.utils.helpers import save_json

    raw = root / "raw" / dataset_name
    pre = root / "preprocessed" / dataset_name
    for d in (raw / "imagesTr", raw / "labelsTr", pre / "gt_segmentations",
              pre / "nnUNetPlans_2d"):
        os.makedirs(d, exist_ok=True)
    save_json(plans, str(pre / "nnUNetPlans.json"), sort_keys=False)
    save_json(dataset_json, str(pre / "dataset.json"), sort_keys=False)
    save_json(dataset_json, str(raw / "dataset.json"), sort_keys=False)
    pm = PlansManager(plans)
    cm = pm.get_configuration("2d")
    rs = np.random.RandomState(0)
    for i in range(cases):
        img = gaussian_filter(rs.randn(*shape), (0, 2, 2)).astype(np.float32)
        img /= img.std()
        lab = ((img > 0.2).astype(np.uint8) + (img > 1.0)).astype(np.uint8)
        spacing = (1.0, 1.0, 2.0)   # (x, y, z) on disk
        write_nifti(str(raw / "imagesTr" / f"c{i}_0000.nii.gz"), img.transpose(2, 1, 0), spacing)
        for folder in (raw / "labelsTr", pre / "gt_segmentations"):
            write_nifti(str(folder / f"c{i}.nii.gz"), lab.transpose(2, 1, 0), spacing)
        DefaultPreprocessor().run_case_save(
            str(pre / "nnUNetPlans_2d" / f"c{i}"), [str(raw / "imagesTr" / f"c{i}_0000.nii.gz")],
            str(raw / "labelsTr" / f"c{i}.nii.gz"), pm, cm, dataset_json)
