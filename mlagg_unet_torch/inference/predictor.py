"""End-to-end predictor (reference: inference/predict_from_raw_data.py:113-575).

Counterpart of ``mlagg_unet_tpu/inference/predictor.py``: initialize from
a trained model folder (the checkpoint carries the trainer name and init
args, so the right architecture is rebuilt, :83-99), fold ensembling by
logits averaging on the device (:261-324), num_parts/part_id case striping
(:185-187), the cascade's previous-stage segmentations stacked on the
input as one-hot channels (:162-178, ``folder_with_segs_from_prev_stage``)
and optional probability export. Preprocessing runs on host threads while
the card predicts; export runs on other host threads.

A folder's checkpoints are either the JAX package's ``.ckpt`` (read
without JAX, ``training/checkpoint.py``; with BatchNorm's running
statistics in ``model_state``) or the reference's ``.pth`` (converted by
``training/torch_import.py``: the flagship's and the ported zoo's). The network is built from
the checkpoint's configuration in the plans, as the trainer built it.
"""
from __future__ import annotations

import os
import warnings
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.inference.export import (
    convert_predicted_logits_to_segmentation_with_correct_shape,
    export_prediction_from_logits,
)
from mlagg_unet_torch.inference.sliding_window import HostCopy, VolumePredictor
from mlagg_unet_torch.plans.fingerprint import (
    create_lists_from_splitted_dataset_folder,
    get_identifiers_from_splitted_dataset_folder,
)
from mlagg_unet_torch.plans.label_handling import (
    convert_labelmap_to_one_hot,
    determine_num_input_channels,
)
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.training.registry import get_network_builder, get_trainer_config
from mlagg_unet_torch.utils.helpers import isfile, join, load_json, maybe_mkdir_p
from mlagg_unet_torch.weights import jax_variables_to_state_dict


class NNUNetPredictor:
    def __init__(
        self,
        tile_step_size: float = 0.5,
        use_gaussian: bool = True,
        use_mirroring: bool = True,
        tile_batch_size: Optional[int] = None,  # None = budget + autotune on the card
        verbose: bool = False,
        compute_dtype: Union[torch.dtype, str, None] = torch.bfloat16,
        device: DeviceLike = "cuda",
    ):
        """compute_dtype: torch.bfloat16 (default), torch.float32 or None
        (fp32), or the dtype's name. The volume path tiles at step 0.5
        whatever ``tile_step_size`` says, as the JAX package does; another
        value draws a warning."""
        if tile_step_size != 0.5:
            warnings.warn(f"tile_step_size={tile_step_size} has no effect: volumes tile "
                          "at step 0.5, as in the JAX package", stacklevel=2)
        self.device = resolve_device(device)
        if tile_batch_size is None and self.device.type != "cuda":
            raise ValueError(
                f"tile_batch_size=None selects the batch from a CUDA card's memory; "
                f"on {self.device} pass a tile_batch_size")
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.tile_batch_size = tile_batch_size
        self.verbose = verbose
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if isinstance(compute_dtype, str) else compute_dtype)

        self.network = None
        self.list_of_parameters: List[dict] = []
        self.plans_manager: Optional[PlansManager] = None
        self.configuration_manager = None
        self.dataset_json = None
        self.trainer_name = None
        self.allowed_mirroring_axes: Tuple[int, ...] = ()
        self.label_manager = None
        self._volume_predictors = None

    # ------------------------------------------------------------------
    def initialize_from_trained_model_folder(
        self, model_training_output_dir: str,
        use_folds: Union[Sequence[Union[int, str]], None],
        checkpoint_name: str = "checkpoint_final.ckpt",
    ):
        if use_folds is None:
            use_folds = self.auto_detect_available_folds(
                model_training_output_dir, checkpoint_name)
        dataset_json = load_json(join(model_training_output_dir, "dataset.json"))
        plans = load_json(join(model_training_output_dir, "plans.json"))
        plans_manager = PlansManager(plans)

        is_torch = checkpoint_name.endswith((".pth", ".pt"))
        parameters = []
        trainer_name = configuration_name = mirroring = None
        for f in use_folds:
            f = int(f) if f != "all" else f
            path = join(model_training_output_dir, f"fold_{f}", checkpoint_name)
            if is_torch:
                # reference-format torch checkpoint (predict_from_raw_data.py:83-99)
                ckpt = torch.load(path, map_location="cpu", weights_only=False)
            else:
                ckpt = load_checkpoint(path)
            if trainer_name is None:
                trainer_name = ckpt["trainer_name"]
                configuration_name = ckpt["init_args"]["configuration"]
                mirroring = ckpt.get("inference_allowed_mirroring_axes") or ()
            parameters.append((ckpt["network_weights"], ckpt.get("model_state")))

        configuration_manager = plans_manager.get_configuration(configuration_name)
        num_input_channels = determine_num_input_channels(
            plans_manager, configuration_manager, dataset_json)
        cfg = get_trainer_config(trainer_name)
        label_manager = plans_manager.get_label_manager(dataset_json)
        network = get_network_builder(cfg.network)(
            configuration_manager, num_input_channels,
            label_manager.num_segmentation_heads, cfg.enable_deep_supervision,
            device="cpu")
        if is_torch:
            from mlagg_unet_torch.training.torch_import import reference_state_dict_to_port

            state_dicts = [reference_state_dict_to_port(cfg.network, sd)
                           for sd, _ in parameters]
        else:
            state_dicts = [jax_variables_to_state_dict(*p) for p in parameters]
        for sd in state_dicts:  # every fold must load exactly
            network.load_state_dict(sd, strict=True)

        self.plans_manager = plans_manager
        self.configuration_manager = configuration_manager
        self.list_of_parameters = state_dicts
        self.network = network
        self.dataset_json = dataset_json
        self.trainer_name = trainer_name
        self.allowed_mirroring_axes = tuple(mirroring or ())
        self.label_manager = label_manager
        self._volume_predictors = None

    def manual_initialization(self, network, plans_manager,
                              configuration_manager, parameters,
                              dataset_json, trainer_name,
                              inference_allowed_mirroring_axes):
        """reference :100-111 (used by trainer final validation).
        ``parameters``: one state_dict of ``network`` per fold."""
        self.network = network
        self.plans_manager = plans_manager
        self.configuration_manager = configuration_manager
        self.list_of_parameters = parameters
        self.dataset_json = dataset_json
        self.trainer_name = trainer_name
        self.allowed_mirroring_axes = tuple(inference_allowed_mirroring_axes or ())
        self.label_manager = plans_manager.get_label_manager(dataset_json)
        self._volume_predictors = None

    @staticmethod
    def auto_detect_available_folds(model_dir: str, checkpoint_name: str
                                    ) -> List[int]:
        folds = []
        for f in os.listdir(model_dir):
            if f.startswith("fold_") and f != "fold_all" and \
                    isfile(join(model_dir, f, checkpoint_name)):
                folds.append(int(f.split("_")[-1]))
        if not folds:
            raise FileNotFoundError(f"no usable folds in {model_dir}")
        return sorted(folds)

    # ------------------------------------------------------------------
    def _ensure_volume_predictors(self) -> List[VolumePredictor]:
        if self._volume_predictors is None:
            tile_size = self.configuration_manager.patch_size
            num_classes = self.label_manager.num_segmentation_heads
            mirror_axes = self.allowed_mirroring_axes if self.use_mirroring else ()
            # 16-bit logits fetch when computing in bf16: the reference
            # ships HALF logits to the CPU; the device-side Gaussian
            # accumulation stays fp32
            tdt = torch.bfloat16 if self.compute_dtype == torch.bfloat16 else None
            vps = []
            for sd in self.list_of_parameters:
                self.network.load_state_dict(sd, strict=True)
                vps.append(VolumePredictor(
                    self.network, tile_size, num_classes, mirror_axes,
                    self.tile_batch_size, self.use_gaussian,
                    compute_dtype=self.compute_dtype, transfer_dtype=tdt,
                    device=self.device))
            self._volume_predictors = vps
        return self._volume_predictors

    def predict_logits_from_preprocessed_data(self, data: np.ndarray) -> np.ndarray:
        """data: (c, *spatial) preprocessed. Averages logits over folds
        (reference :261-324)."""
        return self._finalize_device_logits(self._predict_logits_device(data))

    def _predict_logits_device(self, data: np.ndarray):
        """Queue every fold's volume, average their logits on the device and
        start the copy to the host, without waiting: one copy per volume,
        not per fold. Lets ``predict_from_files`` overlap volume k's copy
        and export with volume k+1's compute."""
        vps = self._ensure_volume_predictors()
        acc = bounds = z_mode = None
        for vp in vps:
            logits, bounds, z_mode = vp._run(data)
            acc = logits if acc is None else acc + logits
        if len(vps) > 1:
            acc = acc / len(vps)
        return HostCopy(acc), bounds, z_mode

    def _finalize_device_logits(self, result) -> np.ndarray:
        """Wait for and unpad a ``_predict_logits_device`` result."""
        return self._volume_predictors[0].finalize(result)

    def predict_single_npy_array(
        self, input_image: np.ndarray, image_properties: dict,
        segmentation_previous_stage: np.ndarray = None,
        output_file_truncated: str = None,
        save_or_return_probabilities: bool = False,
    ):
        """reference :354-436."""
        data, properties = self._preprocess(input_image, dict(image_properties),
                                            segmentation_previous_stage)
        logits = self.predict_logits_from_preprocessed_data(data)
        if output_file_truncated is not None:
            export_prediction_from_logits(
                logits, properties, self.configuration_manager,
                self.plans_manager, self.dataset_json, output_file_truncated,
                save_or_return_probabilities,
            )
            return None
        return convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, self.plans_manager, self.configuration_manager,
            self.label_manager, properties,
            return_probabilities=save_or_return_probabilities,
        )

    def _preprocess(self, image: np.ndarray, properties: dict,
                    prev_stage_seg: Optional[np.ndarray] = None, preprocessor=None):
        """(preprocessed data, properties) of one case. In a cascade the
        previous stage's segmentation (in the raw image's frame) goes through
        ``run_case_npy`` with the image, transposed, cropped and resampled as
        the image is, and its one-hot over the foreground labels is stacked
        after the image channels (reference PreprocessAdapter :58-60); the
        -1 outside the crop's nonzero mask one-hot encodes to zeros. These
        are the channels the stage was trained on, read from
        ``predicted_next_stage`` in the preprocessed frame."""
        preprocessor = preprocessor or DefaultPreprocessor(verbose=self.verbose)
        seg = (None if prev_stage_seg is None
               else np.asarray(prev_stage_seg, np.float32)[None])
        data, seg, properties = preprocessor.run_case_npy(
            image, seg, properties, self.plans_manager, self.configuration_manager,
            self.dataset_json)
        if prev_stage_seg is not None:
            onehot = convert_labelmap_to_one_hot(seg[0], self.label_manager.foreground_labels,
                                                 data.dtype)
            data = np.vstack([data, onehot])
        return data, properties

    # ------------------------------------------------------------------
    def predict_from_files(
        self,
        list_of_lists_or_source_folder: Union[str, List[List[str]]],
        output_folder_or_list_of_truncated_output_files: Union[str, List[str]],
        save_probabilities: bool = False,
        overwrite: bool = True,
        num_parts: int = 1,
        part_id: int = 0,
        folder_with_segs_from_prev_stage: str = None,
    ):
        prev_stage_name = self.configuration_manager.previous_stage_name
        if prev_stage_name is not None and folder_with_segs_from_prev_stage is None:
            raise ValueError(f"this configuration is the cascade stage after "
                             f"{prev_stage_name!r}: give folder_with_segs_from_prev_stage "
                             "(-prev_stage_predictions), that stage's predictions")
        dataset_json = self.dataset_json
        file_ending = dataset_json["file_ending"]

        if isinstance(list_of_lists_or_source_folder, str):
            source = list_of_lists_or_source_folder
            identifiers = get_identifiers_from_splitted_dataset_folder(source, file_ending)
            lists = create_lists_from_splitted_dataset_folder(source, file_ending, identifiers)
        else:
            lists = list_of_lists_or_source_folder
            identifiers = [os.path.basename(l[0])[: -(len(file_ending) + 5)] for l in lists]

        if isinstance(output_folder_or_list_of_truncated_output_files, str):
            output_folder = output_folder_or_list_of_truncated_output_files
            maybe_mkdir_p(output_folder)
            out_truncated = [join(output_folder, i) for i in identifiers]
        else:
            out_truncated = output_folder_or_list_of_truncated_output_files
            output_folder = os.path.dirname(out_truncated[0]) if out_truncated else "."

        # num_parts/part_id striping (reference :185-187)
        lists = lists[part_id::num_parts]
        out_truncated = out_truncated[part_id::num_parts]
        identifiers = identifiers[part_id::num_parts]

        rw = self.plans_manager.image_reader_writer_class()
        preprocessor = DefaultPreprocessor(verbose=self.verbose)

        def _load_and_preprocess(image_files, ident):
            """Reading and preprocessing of one case (a host thread); in a
            cascade with the previous stage's segmentation (``_preprocess``)."""
            data, props = rw.read_images(image_files)
            seg_prev = None
            if prev_stage_name is not None:
                seg_prev = rw.read_seg(join(folder_with_segs_from_prev_stage,
                                            ident + file_ending))[0][0]
            return self._preprocess(data, props, seg_prev, preprocessor)

        # Pipeline: preprocessing of case k+1..k+depth and export of finished
        # cases overlap the card predicting case k (reference
        # predict_from_raw_data.py:211-254, incl. the export busy-throttle
        # :231-254 that bounds pending exports).
        todo = [(f, o, i) for f, o, i in zip(lists, out_truncated, identifiers)
                if overwrite or not isfile(o + file_ending)]
        n_pre = max(1, int(os.environ.get("MLAGG_PREPROCESS_WORKERS", "3")))
        n_exp = max(1, int(os.environ.get("MLAGG_EXPORT_WORKERS", "3")))

        with ThreadPoolExecutor(n_pre) as pre_pool, ThreadPoolExecutor(n_exp) as exp_pool:
            # bounded prefetch: at most n_pre + 1 preprocessed volumes in
            # flight so large datasets don't pile up in host memory
            pending = deque()
            next_i = 0
            while next_i < len(todo) and len(pending) <= n_pre:
                f, o, i = todo[next_i]
                pending.append((pre_pool.submit(_load_and_preprocess, f, i), o))
                next_i += 1
            export_futs = []
            # 1-deep device pipeline: volume k's copy to the host and its
            # export run while volume k+1's tiles compute on the card
            inflight = None  # (device result, pprops, out_trunc)

            def _drain_inflight():
                dev, pprops_, out_ = inflight
                logits = self._finalize_device_logits(dev)
                export_futs.append(exp_pool.submit(
                    export_prediction_from_logits,
                    logits, pprops_, self.configuration_manager,
                    self.plans_manager, self.dataset_json, out_,
                    save_probabilities,
                ))

            while pending:
                fut, out_trunc = pending.popleft()
                pdata, pprops = fut.result()
                if next_i < len(todo):
                    f, o, i = todo[next_i]
                    pending.append((pre_pool.submit(_load_and_preprocess, f, i), o))
                    next_i += 1
                dev = self._predict_logits_device(pdata)
                if inflight is not None:
                    _drain_inflight()
                inflight = (dev, pprops, out_trunc)
                # busy-throttle: keep at most 2 * n_exp exports in flight
                while sum(not f.done() for f in export_futs) >= 2 * n_exp:
                    wait(export_futs, return_when=FIRST_COMPLETED)
            if inflight is not None:
                _drain_inflight()
            for f in export_futs:
                f.result()  # propagate worker exceptions
        return output_folder
