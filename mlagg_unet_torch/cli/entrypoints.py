"""Command-line verbs of the port (``mlaggtorch_*``).

Counterparts of ``train_entry``, ``predict_entry`` and
``predict_from_modelfolder_entry`` in ``mlagg_unet_tpu/cli/entrypoints.py``
(the upstream ``nnUNetv2_train``, ``nnUNetv2_predict`` and its model-folder
form), with the upstream ``-device`` flag in place of the JAX verb's
``-num_devices``: ``cuda`` (the default) raises without a card, ``cpu`` runs
on the CPU. On the CPU the predict verbs need a tile batch
(``-tile_batch_size``); on the card it is chosen from the card's memory and
timed when not given. Also invocable as
``python -m mlagg_unet_torch.cli.entrypoints <verb> ...``.
"""
from __future__ import annotations

import argparse
import sys

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import (
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
    maybe_mkdir_p,
    save_json,
)


def train_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_train")
    p.add_argument("dataset_name_or_id")
    p.add_argument("configuration")
    p.add_argument("fold", help="0-4 or 'all'")
    p.add_argument("-tr", default="nnUNetTrainer")
    p.add_argument("-p", default="nnUNetPlans")
    p.add_argument("--c", action="store_true", help="continue training")
    p.add_argument("--npz", action="store_true",
                   help="save softmax of validation predictions")
    p.add_argument("--val", action="store_true", help="only run validation")
    p.add_argument("-device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("-pretrained_weights", default=None,
                   help="checkpoint to transfer name/shape-matched weights from")
    a = p.parse_args(args)

    from mlagg_unet_torch.training.trainer import NNUNetTrainer

    dataset_name = maybe_convert_to_dataset_name(a.dataset_name_or_id)
    plans = load_json(join(paths.nnUNet_preprocessed, dataset_name, a.p + ".json"))
    dataset_json = load_json(join(paths.nnUNet_preprocessed, dataset_name, "dataset.json"))
    fold = a.fold if a.fold == "all" else int(a.fold)
    trainer = NNUNetTrainer(plans, a.configuration, fold, dataset_json,
                            trainer_name=a.tr, device=a.device)

    # plans and dataset json beside the results, for the predictor
    maybe_mkdir_p(trainer.output_folder_base)
    save_json(plans, join(trainer.output_folder_base, "plans.json"), sort_keys=False)
    save_json(dataset_json, join(trainer.output_folder_base, "dataset.json"),
              sort_keys=False)

    if not a.val:
        if a.pretrained_weights:
            trainer.initialize()
            if a.pretrained_weights.endswith((".pth", ".pt")):
                # reference torch checkpoints (torch.save state dicts)
                from mlagg_unet_torch.training.torch_import import (
                    load_pretrained_torch_weights,
                )

                n_tr, n_tot = load_pretrained_torch_weights(trainer.step.network,
                                                            a.pretrained_weights)
            else:
                from mlagg_unet_torch.training.load_pretrained_weights import (
                    load_pretrained_weights,
                )

                n_tr, n_tot = load_pretrained_weights(trainer.step.network,
                                                      a.pretrained_weights)
            print(f"transferred {n_tr}/{n_tot} parameter tensors")
        if a.c:
            for name in ("checkpoint_final.ckpt", "checkpoint_latest.ckpt",
                         "checkpoint_best.ckpt"):
                f = join(trainer.output_folder, name)
                if isfile(f):
                    if not trainer.was_initialized:
                        trainer.initialize()
                    trainer.load_checkpoint_file(f)
                    break
        trainer.run_training()
    trainer.perform_actual_validation(save_probabilities=a.npz)


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
    "train": train_entry,
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
