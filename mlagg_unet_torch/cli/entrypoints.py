"""Command-line verbs of the port (``mlaggtorch_*``).

Counterparts of the verbs of ``mlagg_unet_tpu/cli/entrypoints.py``, with
the JAX package's arguments: fingerprint, plan and preprocess; train and
predict; evaluate, ensemble, postprocessing, find_best_configuration and
accumulate_crossval_results; model export and install; moving plans
between datasets; overlay PNGs; the old-nnU-Net and MSD dataset converters.
Only ``train`` and the predict verbs touch a device. They
take the upstream ``-device`` flag in place of the JAX verb's
``-num_devices``: ``cuda`` (the default) raises without a card, ``cpu`` runs
on the CPU. On the CPU the predict verbs need a tile batch
(``-tile_batch_size``); on the card it is chosen from the card's memory and
timed when not given. Also invocable as
``python -m mlagg_unet_torch.cli.entrypoints <verb> ...``.

The download verb is never ported: it needs the network.
"""
from __future__ import annotations

import argparse
import sys

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import (
    get_output_folder,
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
    maybe_mkdir_p,
    save_json,
)


def extract_fingerprint_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_extract_fingerprint")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-np", type=int, default=8)
    p.add_argument("--verify_dataset_integrity", action="store_true")
    a = p.parse_args(args)
    from mlagg_unet_torch.plans.fingerprint import DatasetFingerprintExtractor

    for d in a.d:
        if a.verify_dataset_integrity:
            from mlagg_unet_torch.cli.verify_dataset_integrity import (
                verify_dataset_integrity,
            )

            verify_dataset_integrity(
                join(paths.nnUNet_raw, maybe_convert_to_dataset_name(d)))
        DatasetFingerprintExtractor(d, num_processes=a.np).run(
            overwrite_existing=True)


def plan_experiment_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_plan_experiment")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-gpu_memory_target", type=float, default=8)
    p.add_argument("-overwrite_plans_name", default="nnUNetPlans")
    a = p.parse_args(args)
    from mlagg_unet_torch.plans.experiment_planner import ExperimentPlanner

    for d in a.d:
        ExperimentPlanner(d, gpu_memory_target_in_gb=a.gpu_memory_target,
                          plans_name=a.overwrite_plans_name).plan_experiment()


def preprocess_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_preprocess")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    p.add_argument("-np", type=int, default=8)
    p.add_argument("-plans_name", default="nnUNetPlans")
    a = p.parse_args(args)
    from mlagg_unet_torch.plans.plans_handler import PlansManager
    from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor

    for d in a.d:
        dataset_name = maybe_convert_to_dataset_name(d)
        plans_file = join(paths.nnUNet_preprocessed, dataset_name,
                          a.plans_name + ".json")
        pm = PlansManager(plans_file)
        for c in a.c:
            if c not in pm.available_configurations:
                print(f"skipping configuration {c} (not in plans)")
                continue
            DefaultPreprocessor().run(d, c, a.plans_name, num_processes=a.np)


def plan_and_preprocess_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_plan_and_preprocess")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    p.add_argument("-np", type=int, default=8)
    p.add_argument("--verify_dataset_integrity", action="store_true")
    a = p.parse_args(args)
    fp_args = ["-d", *a.d, "-np", str(a.np)]
    if a.verify_dataset_integrity:
        fp_args.append("--verify_dataset_integrity")
    extract_fingerprint_entry(fp_args)
    plan_experiment_entry(["-d", *a.d])
    preprocess_entry(["-d", *a.d, "-c", *a.c, "-np", str(a.np)])


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

                n_tr, n_tot = load_pretrained_torch_weights(
                    trainer.step.network, a.pretrained_weights, network_key=trainer.cfg.network)
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
        a.m = get_output_folder(dataset_name, a.tr, a.p, a.c)
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


def evaluate_folder_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_evaluate_folder")
    p.add_argument("gt_folder")
    p.add_argument("pred_folder")
    p.add_argument("-djfile", required=True, help="dataset.json")
    p.add_argument("-pfile", required=True, help="plans.json")
    p.add_argument("-o", default=None)
    a = p.parse_args(args)

    from mlagg_unet_torch.evaluation.metrics import compute_metrics_on_folder
    from mlagg_unet_torch.plans.plans_handler import PlansManager

    dataset_json = load_json(a.djfile)
    pm = PlansManager(load_json(a.pfile))
    lm = pm.get_label_manager(dataset_json)
    rw = pm.image_reader_writer_class()
    out = a.o or join(a.pred_folder, "summary.json")
    labels_or_regions = (lm.foreground_regions if lm.has_regions
                         else lm.foreground_labels)
    result = compute_metrics_on_folder(
        a.gt_folder, a.pred_folder, out, rw, dataset_json["file_ending"],
        labels_or_regions, lm.ignore_label,
    )
    print("mean foreground Dice:", result["foreground_mean"]["Dice"])


def ensemble_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_ensemble")
    p.add_argument("-i", nargs="+", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("-np", type=int, default=8)
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.ensembling import ensemble_folders

    ensemble_folders(a.i, a.o, num_processes=a.np)


def apply_postprocessing_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_apply_postprocessing")
    p.add_argument("-i", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("-pp_pkl_file", required=True)
    p.add_argument("-np", type=int, default=8)
    p.add_argument("-plans_json", default=None)
    p.add_argument("-dataset_json", default=None)
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.remove_connected_components import (
        apply_postprocessing_to_folder,
    )

    apply_postprocessing_to_folder(a.i, a.o, a.pp_pkl_file,
                                   plans_json=a.plans_json,
                                   dataset_json=a.dataset_json,
                                   num_processes=a.np)


def find_best_configuration_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_find_best_configuration")
    p.add_argument("dataset_name_or_id")
    p.add_argument("-p", nargs="+", default=["nnUNetPlans"])
    p.add_argument("-c", nargs="+",
                   default=["2d", "3d_fullres", "3d_lowres",
                            "3d_cascade_fullres"])
    p.add_argument("-tr", nargs="+", default=["nnUNetTrainer"])
    p.add_argument("-f", nargs="+", type=int, default=(0, 1, 2, 3, 4))
    p.add_argument("--disable_ensembling", action="store_true")
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.find_best_configuration import (
        dumb_trainer_config_plans_to_trained_models_dict,
        find_best_configuration,
    )

    models = dumb_trainer_config_plans_to_trained_models_dict(a.tr, a.c, a.p)
    find_best_configuration(a.dataset_name_or_id, models, allow_ensembling=not
                            a.disable_ensembling, folds=tuple(a.f))


def accumulate_crossval_results_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_accumulate_crossval_results")
    p.add_argument("dataset_name_or_id")
    p.add_argument("-c", required=True)
    p.add_argument("-tr", default="nnUNetTrainer")
    p.add_argument("-p", default="nnUNetPlans")
    p.add_argument("-f", nargs="+", type=int, default=(0, 1, 2, 3, 4))
    p.add_argument("-o", default=None)
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.find_best_configuration import (
        accumulate_cv_results,
    )
    dataset_name = maybe_convert_to_dataset_name(a.dataset_name_or_id)
    trained_model_folder = get_output_folder(dataset_name, a.tr, a.p, a.c)
    out = a.o or join(trained_model_folder, "crossval_results_folds_"
                      + "_".join(str(i) for i in a.f))
    accumulate_cv_results(trained_model_folder, out, tuple(a.f))


def export_model_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_export_model_to_zip")
    p.add_argument("-d", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("-c", nargs="+", required=True)
    p.add_argument("-tr", default="nnUNetTrainer")
    p.add_argument("-p", default="nnUNetPlans")
    p.add_argument("-f", nargs="+", default=(0, 1, 2, 3, 4))
    p.add_argument("-chk", nargs="+", default=("checkpoint_final.ckpt",))
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.model_sharing import (
        export_pretrained_model,
    )

    export_pretrained_model(a.d, a.o, a.c, a.tr, a.p, tuple(a.f),
                            tuple(a.chk))


def determine_postprocessing_entry(args=None):
    """reference remove_connected_components.py:298 — writes
    postprocessing.pkl/json into the input folder."""
    p = argparse.ArgumentParser("mlaggtorch_determine_postprocessing")
    p.add_argument("-i", required=True, help="folder with predictions")
    p.add_argument("-ref", required=True, help="folder with gt labels")
    p.add_argument("-plans_json", default=None)
    p.add_argument("-dataset_json", default=None)
    p.add_argument("-np", type=int, default=8)
    p.add_argument("--remove_postprocessed", action="store_true")
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.remove_connected_components import (
        determine_postprocessing,
    )

    plans = a.plans_json or join(a.i, "plans.json")
    dsj = a.dataset_json or join(a.i, "dataset.json")
    determine_postprocessing(a.i, a.ref, plans, dsj, num_processes=a.np,
                             keep_postprocessed_files=not
                             a.remove_postprocessed)


def evaluate_simple_entry(args=None):
    """reference evaluate_predictions.py:235 — evaluate without plans/
    dataset json, labels given explicitly."""
    p = argparse.ArgumentParser("mlaggtorch_evaluate_simple")
    p.add_argument("gt_folder")
    p.add_argument("pred_folder")
    p.add_argument("-l", type=int, nargs="+", required=True)
    p.add_argument("-il", type=int, default=None, help="ignore label")
    p.add_argument("-o", default=None)
    p.add_argument("-np", type=int, default=8)
    a = p.parse_args(args)
    from mlagg_unet_torch.evaluation.metrics import (
        compute_metrics_on_folder_simple,
    )

    out = a.o or join(a.pred_folder, "summary.json")
    result = compute_metrics_on_folder_simple(
        a.gt_folder, a.pred_folder, a.l, output_file=out,
        num_processes=a.np, ignore_label=a.il)
    print("mean foreground Dice:", result["foreground_mean"]["Dice"])


def move_plans_between_datasets_entry(args=None):
    """reference move_plans_between_datasets.py:58."""
    p = argparse.ArgumentParser("mlaggtorch_move_plans_between_datasets")
    p.add_argument("-s", required=True, help="source dataset name or id")
    p.add_argument("-t", required=True, help="target dataset name or id")
    p.add_argument("-sp", required=True, help="source plans identifier")
    p.add_argument("-tp", default=None, help="target plans identifier")
    a = p.parse_args(args)
    from mlagg_unet_torch.plans.move_plans import move_plans_between_datasets

    out = move_plans_between_datasets(a.s, a.t, a.sp, a.tp)
    print("wrote", out)


def plot_overlay_pngs_entry(args=None):
    """reference overlay_plots.py:242."""
    p = argparse.ArgumentParser("mlaggtorch_plot_overlay_pngs")
    p.add_argument("-d", required=True, help="dataset name or id")
    p.add_argument("-o", required=True, help="output folder")
    p.add_argument("-np", type=int, default=8)
    a = p.parse_args(args)
    from mlagg_unet_torch.utils.overlay_plots import generate_overlays_for_dataset

    generate_overlays_for_dataset(a.d, a.o, num_processes=a.np)


def convert_old_nnunet_dataset_entry(args=None):
    """reference convert_raw_dataset_from_old_nnunet_format.py:43."""
    p = argparse.ArgumentParser("mlaggtorch_convert_old_nnUNet_dataset")
    p.add_argument("input_folder", help="old TaskXXX_NAME folder path")
    p.add_argument("output_dataset_name", help="DatasetXXX_NAME (name, not path)")
    a = p.parse_args(args)
    from mlagg_unet_torch.dataset_conversion.converters import convert_old_nnunet_dataset

    out = convert_old_nnunet_dataset(a.input_folder, a.output_dataset_name)
    print("wrote", out)


def convert_msd_dataset_entry(args=None):
    """reference convert_MSD_dataset.py:117."""
    p = argparse.ArgumentParser("mlaggtorch_convert_MSD_dataset")
    p.add_argument("-i", required=True, help="extracted MSD task folder")
    p.add_argument("-overwrite_id", type=int, default=None)
    p.add_argument("-np", type=int, default=8)
    a = p.parse_args(args)
    from mlagg_unet_torch.dataset_conversion.converters import convert_msd_dataset

    out = convert_msd_dataset(a.i, a.overwrite_id)
    print("wrote", out)


def install_model_entry(args=None):
    p = argparse.ArgumentParser("mlaggtorch_install_pretrained_model_from_zip")
    p.add_argument("zip_file")
    a = p.parse_args(args)
    from mlagg_unet_torch.postprocessing.model_sharing import (
        install_model_from_zip_file,
    )

    install_model_from_zip_file(a.zip_file)


_VERBS = {
    "plan_and_preprocess": plan_and_preprocess_entry,
    "extract_fingerprint": extract_fingerprint_entry,
    "plan_experiment": plan_experiment_entry,
    "preprocess": preprocess_entry,
    "train": train_entry,
    "predict": predict_entry,
    "predict_from_modelfolder": predict_from_modelfolder_entry,
    "evaluate_folder": evaluate_folder_entry,
    "evaluate_simple": evaluate_simple_entry,
    "ensemble": ensemble_entry,
    "determine_postprocessing": determine_postprocessing_entry,
    "apply_postprocessing": apply_postprocessing_entry,
    "find_best_configuration": find_best_configuration_entry,
    "accumulate_crossval_results": accumulate_crossval_results_entry,
    "move_plans_between_datasets": move_plans_between_datasets_entry,
    "plot_overlay_pngs": plot_overlay_pngs_entry,
    "export_model": export_model_entry,
    "install_model": install_model_entry,
    "convert_old_nnUNet_dataset": convert_old_nnunet_dataset_entry,
    "convert_MSD_dataset": convert_msd_dataset_entry,
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
