"""Command-line verbs of the port (``mlaggtorch_*``).

Counterparts of ``predict_entry`` and ``predict_from_modelfolder_entry`` in
``mlagg_unet_tpu/cli/entrypoints.py`` (the upstream ``nnUNetv2_predict``
and its model-folder form), with the upstream ``-device`` flag: ``cuda``
(the default) raises without a card, ``cpu`` runs on the CPU. On the CPU a
tile batch must be given (``-tile_batch_size``); on the card it is chosen
from the card's memory and timed when not given. Also invocable as
``python -m mlagg_unet_torch.cli.entrypoints <verb> ...``.
"""
from __future__ import annotations

import argparse
import sys

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import join, maybe_convert_to_dataset_name


def _add_predict_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-i", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("-f", nargs="+", default=None)
    p.add_argument("-chk", default="checkpoint_final.ckpt")
    p.add_argument("-step_size", type=float, default=0.5,
                   help="kept for the upstream interface: volumes tile at step "
                        "0.5, as in the JAX package")
    p.add_argument("--disable_tta", action="store_true")
    p.add_argument("--save_probabilities", action="store_true")
    p.add_argument("-num_parts", type=int, default=1)
    p.add_argument("-part_id", type=int, default=0)
    p.add_argument("-prev_stage_predictions", default=None)
    p.add_argument("-device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-tile_batch_size", type=int, default=None,
                   help="tiles per network call before mirroring; default: "
                        "chosen on the card (required with -device cpu)")


def _predict(a, model_dir: str, overwrite: bool = True) -> None:
    from mlagg_unet_torch.inference.predictor import NNUNetPredictor

    predictor = NNUNetPredictor(tile_step_size=a.step_size,
                                use_mirroring=not a.disable_tta,
                                tile_batch_size=a.tile_batch_size,
                                device=a.device)
    predictor.initialize_from_trained_model_folder(model_dir, a.f, checkpoint_name=a.chk)
    predictor.predict_from_files(
        a.i, a.o, save_probabilities=a.save_probabilities, overwrite=overwrite,
        num_parts=a.num_parts, part_id=a.part_id,
        folder_with_segs_from_prev_stage=a.prev_stage_predictions,
    )


def predict_entry(args=None):
    """The model folder is ``-m``, or ``nnUNet_results/<dataset>/<tr>__<p>__<c>``
    from ``-d`` and ``-c``."""
    p = argparse.ArgumentParser("mlaggtorch_predict")
    p.add_argument("-d", default=None)
    p.add_argument("-c", default=None)
    p.add_argument("-tr", default="nnUNetTrainer")
    p.add_argument("-p", default="nnUNetPlans")
    p.add_argument("-m", default=None, help="trained model folder (instead of -d, -c)")
    _add_predict_args(p)
    a = p.parse_args(args)
    if a.m is None:
        if a.d is None or a.c is None:
            p.error("give -m, or -d and -c")
        dataset_name = maybe_convert_to_dataset_name(a.d)
        a.m = join(paths.nnUNet_results, dataset_name, f"{a.tr}__{a.p}__{a.c}")
    _predict(a, a.m)


def predict_from_modelfolder_entry(args=None):
    """reference predict_from_raw_data.py:354 — predict with an explicit
    model folder instead of nnUNet_results lookup."""
    p = argparse.ArgumentParser("mlaggtorch_predict_from_modelfolder")
    p.add_argument("-m", required=True, help="trained model folder "
                   "(contains fold_X subfolders)")
    p.add_argument("--continue_prediction", "--c", action="store_true",
                   dest="continue_prediction")
    _add_predict_args(p)
    a = p.parse_args(args)
    _predict(a, a.m, overwrite=not a.continue_prediction)


_VERBS = {
    "predict": predict_entry,
    "predict_from_modelfolder": predict_from_modelfolder_entry,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in _VERBS:
        print(f"usage: python -m mlagg_unet_torch.cli.entrypoints "
              f"{{{','.join(_VERBS)}}} ...", file=sys.stderr)
        sys.exit(1)
    _VERBS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
