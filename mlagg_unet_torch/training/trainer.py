"""Training: the recipes' train and validation steps, and the nnU-Net
training run around them.

``Trainer`` holds one network, its optimizer chain and the step functions
of ``NNUNetTrainerTPU._build_step_fns`` (``mlagg_unet_tpu/training/
trainer.py:350-467``): the recipe's loss for labels, regions and the ignore
label with the deep-supervision scales fixed by the recipe or taken from
the plans, the train step and the validation step with its online
pseudo-dice counts.

``NNUNetTrainer`` is the counterpart of ``NNUNetTrainerTPU`` (``:117-949``)
built around one ``Trainer``: the output folders, the 5-fold split, the data
loaders with augmentation, the epoch loop with the online pseudo dice and
its EMA, checkpoints (final, latest, best) and resume, and the final
sliding-window validation with its evaluation into
``validation/summary.json``. A stage of a cascade reads the previous
stage's segmentations (``predicted_next_stage/<configuration>`` beside the
previous stage's folds) as 1 + n_fg input channels, and a stage with a next
stage writes its validation cases' segmentations there for it.

A train step runs the network in the recipe's compute dtype (bf16): the fp32
master parameters are cast inside ``torch.func.functional_call``, as the
JAX step casts its param tree (``:412-417``), so the gradients reach the
fp32 masters; the buffers (BatchNorm's running statistics) are not cast,
stay fp32 and are updated once per training step by that bf16 forward, as
JAX's ``mutable`` apply updates ``batch_stats`` (``:419-440``); the
validation step normalises by them. Stochastic depth draws from the
trainer's own ``torch.Generator`` on the device. The deep-supervision loss
is fp32, then the gradients are clipped to the recipe's global norm and the
recipe's optimizer steps (``optim.OptimizerChain``) with its schedule at
the step's epoch.

Checkpoints keep the JAX package's format (``training/checkpoint.py``):
``network_weights`` is the JAX param tree and ``model_state`` the
``batch_stats`` tree of the running statistics, or ``{}``
(``weights.module_to_jax_variables``), so both packages' trainers and
predictors read them. ``opt_state`` is the port's own:
``{"count": steps taken, <optimizer>: the torch optimizer's state_dict}``
with numpy arrays for tensors; an optax state from a JAX checkpoint is not
converted, and a resume from one starts fresh moments at the epoch's step
of the schedule.

With ``MLAGG_DEVICE_AUG`` set (``ord3``, ``1`` or ``ord1``) the training
loader's workers only crop, and ``data/device_augment.py`` augments each
batch on the device, as JAX gates it. Not ported yet, and raised as such:
multi-GPU training (A14). Every network of
the JAX registry is built; a trainer whose network the registry does not
know raises at ``_check_ported``.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from mlagg_unet_torch import paths
from mlagg_unet_torch.configuration import ANISO_THRESHOLD, default_n_proc_DA
from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.training import losses
from mlagg_unet_torch.training.checkpoint import load_checkpoint, save_checkpoint
from mlagg_unet_torch.training.logger import NNUNetLogger
from mlagg_unet_torch.training.lr_schedule import (
    constant_lr,
    cosine_warmup_lr,
    epoch_schedule_to_step_schedule,
    poly_lr,
)
from mlagg_unet_torch.training.optim import OPTIMIZERS, OptimizerChain
from mlagg_unet_torch.training.registry import (
    NETWORK_BUILDERS,
    TrainerConfig,
    get_network_builder,
    get_trainer_config,
)
from mlagg_unet_torch.utils.helpers import (get_output_folder, isfile, join, load_json,
                                           maybe_mkdir_p, save_json)
from mlagg_unet_torch.weights import jax_variables_to_state_dict, module_to_jax_variables

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _epoch_schedule(cfg: TrainerConfig):
    if cfg.lr_scheduler == "poly":
        return poly_lr(cfg.initial_lr, cfg.num_epochs)
    if cfg.lr_scheduler == "cosine_warmup":
        return cosine_warmup_lr(cfg.initial_lr, cfg.num_epochs,
                                warmup_epochs=cfg.warmup_epochs)
    if cfg.lr_scheduler == "constant":
        return constant_lr(cfg.initial_lr)
    raise ValueError(f"lr scheduler {cfg.lr_scheduler!r}: 'poly', 'cosine_warmup' or "
                     "'constant'")


LOSSES = ("default", "ce", "dice", "dc_topk", "topk10", "topk10_ls01")


def _check_ported(cfg: TrainerConfig) -> None:
    if cfg.network not in NETWORK_BUILDERS:
        raise NotImplementedError(
            f"trainer {cfg.name!r}: network {cfg.network!r} is not ported (no builder in "
            f"the registry); ported: {sorted(NETWORK_BUILDERS)}")
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"trainer {cfg.name!r}: optimizer {cfg.optimizer!r}, not one "
                         f"of {OPTIMIZERS}")
    if cfg.loss not in LOSSES:
        raise ValueError(f"trainer {cfg.name!r}: loss {cfg.loss!r}, not one of {LOSSES}")
    _epoch_schedule(cfg)


def kfold_like_sklearn(keys: List[str], n_splits: int = 5, seed: int = 12345
                       ) -> List[Dict[str, List[str]]]:
    """sklearn.model_selection.KFold(n_splits, shuffle=True,
    random_state=seed) as the reference's do_split uses it: a permutation of
    the sorted keys, then contiguous folds with the remainder spread over
    the first folds."""
    keys = sorted(keys)
    n = len(keys)
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    rng.shuffle(idx)
    fold_sizes = np.full(n_splits, n // n_splits, dtype=int)
    fold_sizes[: n % n_splits] += 1
    splits = []
    current = 0
    for fs in fold_sizes:
        test_idx = idx[current: current + fs]
        train_idx = np.concatenate([idx[:current], idx[current + fs:]])
        splits.append({
            "train": [keys[i] for i in sorted(train_idx)],
            "val": [keys[i] for i in sorted(test_idx)],
        })
        current += fs
    return splits


def deep_supervision_scales(cfg: TrainerConfig, configuration_manager=None):
    """The recipe's fixed scales, or those of the plans' pooling without the
    lowest (``trainer.py:182-192``); None without deep supervision."""
    if not cfg.enable_deep_supervision:
        return None
    if cfg.deep_supervision_scales_override is not None:
        return [list(s) for s in cfg.deep_supervision_scales_override]
    if configuration_manager is None:
        raise ValueError(f"trainer {cfg.name!r} takes its deep-supervision scales from "
                         "the plans: pass a configuration_manager")
    return [list(i) for i in 1 / np.cumprod(
        np.vstack(configuration_manager.pool_op_kernel_sizes), axis=0)][:-1]


def deep_supervision_loss_weights(cfg: TrainerConfig, num_outputs: int) -> List[float]:
    """1 / 2^i per output, normalised; the plans-derived scales zero the
    lowest one, a recipe's fixed scales keep it (``trainer.py:194-200``)."""
    drop = int(cfg.deep_supervision_scales_override is None and num_outputs > 1)
    return losses.deep_supervision_weights(num_outputs, drop)


class Trainer:
    """One network, its optimizer chain and its train / validation steps.

    ``data`` is (batch, *patch, channels) float and ``target`` (batch, *patch)
    integer labels, both on the trainer's device. ``regions`` (the label
    manager's ``all_regions``) selects DC+BCE on region channels;
    ``ignore_label`` masks those voxels out of the loss and the pseudo dice.
    With a ``configuration_manager`` the patch size and, for a recipe without
    fixed scales, the deep-supervision scales come from it, and the network
    builder gets it. ``compute_dtype`` and ``network_overrides`` (passed to
    the network builder, e.g. smaller widths or drop-path rates) replace the
    recipe's own where given.
    """

    def __init__(self, trainer_name: str = "nnUNetTrainer_MLAgg_2D_dt_MS",
                 patch_size: Sequence[int] = (256, 224), batch_size: int = 10,
                 num_input_channels: int = 1, num_classes: int = 4,
                 batch_dice: bool = False, seed: int = 0,
                 device: DeviceLike = "cuda",
                 compute_dtype: Optional[torch.dtype] = None,
                 network_overrides: Optional[dict] = None,
                 regions: Optional[Sequence] = None,
                 ignore_label: Optional[int] = None,
                 configuration_manager=None):
        self.device = resolve_device(device)
        self.cfg = get_trainer_config(trainer_name)
        _check_ported(self.cfg)
        if configuration_manager is not None:
            patch_size = configuration_manager.patch_size
        self.ds_scales = deep_supervision_scales(self.cfg, configuration_manager)
        self.patch_size = tuple(patch_size)
        self.batch_size = int(batch_size)
        self.num_input_channels = num_input_channels
        self.num_classes = num_classes
        self.batch_dice = batch_dice
        self.regions = None if regions is None else list(regions)
        self.ignore_label = ignore_label
        self.compute_dtype = compute_dtype or _DTYPES[self.cfg.compute_dtype]
        self.network = get_network_builder(self.cfg.network)(
            configuration_manager if configuration_manager is not None else self.patch_size,
            num_input_channels, num_classes, self.cfg.enable_deep_supervision,
            seed=seed, device=self.device, **(network_overrides or {})).train()
        schedule = epoch_schedule_to_step_schedule(
            _epoch_schedule(self.cfg), self.cfg.num_iterations_per_epoch)
        self.optimizer = OptimizerChain(self.network.parameters(), self.cfg.optimizer,
                                        schedule, self.cfg.grad_clip_norm,
                                        self.cfg.adam_eps, self.cfg.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------- steps
    def _check_batch(self, data: torch.Tensor, target: torch.Tensor) -> None:
        want = (self.batch_size, *self.patch_size, self.num_input_channels)
        if tuple(data.shape) != want or tuple(target.shape) != want[:-1]:
            raise ValueError(f"batch: data {tuple(data.shape)}, target "
                             f"{tuple(target.shape)}; the trainer takes {want} "
                             f"and {want[:-1]}")
        if data.device != self.device or target.device != self.device:
            raise ValueError(f"batch on {data.device}/{target.device}, the "
                             f"trainer runs on {self.device}")

    def forward(self, data: torch.Tensor):
        """The network on ``data`` in the compute dtype, differentiable in
        the fp32 master parameters. Only the parameters are cast: buffers
        (running statistics) stay fp32 and are updated in place."""
        cdt = self.compute_dtype
        if cdt == torch.float32:
            return self.network(data.float(), self.generator)
        params = {k: v.to(cdt) for k, v in self.network.named_parameters()}
        return functional_call(self.network, params, (data.to(cdt),),
                               {"generator": self.generator})

    def _single_loss(self, out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The recipe's loss of one output (``trainer.py:350-391``)."""
        il, kind = self.ignore_label, self.cfg.loss
        if self.regions is not None:
            t_regions = losses.convert_seg_to_regions(target, self.regions, il)
            return losses.dc_and_bce_loss(out, t_regions, batch_dice=self.batch_dice,
                                          use_ignore_label=il is not None)
        if kind == "ce":
            return losses.robust_cross_entropy_loss(out, target, ignore_index=il)
        if kind == "dice":
            mask = td = None
            if il is not None:
                mask = (target != il).float()
                td = torch.where(target == il, torch.zeros_like(target), target)
            return losses.memory_efficient_soft_dice_loss(
                out, target if td is None else td, batch_dice=self.batch_dice, do_bg=False,
                smooth=1e-5, loss_mask=mask)
        if kind == "dc_topk":
            return losses.dc_and_topk_loss(out, target, batch_dice=self.batch_dice,
                                           do_bg=False, ignore_label=il)
        if kind in ("topk10", "topk10_ls01"):
            return losses.topk_cross_entropy_loss(
                out, target, k_percent=10.0,
                label_smoothing=0.1 if kind == "topk10_ls01" else 0.0, ignore_index=il)
        return losses.dc_and_ce_loss(out, target, batch_dice=self.batch_dice, do_bg=False,
                                     ignore_label=il)

    def loss(self, outputs, target: torch.Tensor) -> torch.Tensor:
        """The recipe's loss (DC+CE by default, DC+BCE for regions), fp32,
        summed over the deep-supervision scales with their weights
        (``trainer.py:350-404``)."""
        if self.cfg.enable_deep_supervision and isinstance(outputs, (list, tuple)):
            targets = losses.downsample_seg_for_ds(target, self.ds_scales)
            weights = deep_supervision_loss_weights(self.cfg, len(outputs))
            return losses.deep_supervision_loss(self._single_loss, outputs, targets, weights)
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        return self._single_loss(out, target)

    def forward_loss(self, data: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The training loss of one batch, before any step."""
        self._check_batch(data, target)
        self.network.train()
        return self.loss(self.forward(data), target)

    def train_step(self, data: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Forward, loss, backward, clip and one optimizer step. Returns the
        loss as a 0-d tensor on the device (no host sync)."""
        self.optimizer.zero_grad()
        loss = self.forward_loss(data, target)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def val_step(self, data: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(loss, tp, fp, fn) of one batch in eval mode: the loss as in
        training, and the hard per-foreground-class (or per-region) counts
        of the online pseudo dice, the ignored voxels masked out
        (``trainer.py:442-464``)."""
        self._check_batch(data, target)
        self.network.eval()
        try:
            outputs = self.forward(data)
            loss = self.loss(outputs, target)
        finally:
            self.network.train()
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        mask = None if self.ignore_label is None else (target != self.ignore_label).float()
        if self.regions is not None:
            pred = (torch.sigmoid(out) > 0.5).float()
            tgt = losses.convert_seg_to_regions(target, self.regions)
        else:
            n_cls = out.shape[-1]
            labels = target if self.ignore_label is None else torch.where(
                target == self.ignore_label, torch.zeros_like(target), target)
            pred = F.one_hot(out.argmax(-1), n_cls)[..., 1:]
            tgt = F.one_hot(labels.long(), n_cls)[..., 1:]
        tp, fp, fn, _ = losses.get_tp_fp_fn_tn(pred, tgt, mask)
        return loss, tp, fp, fn

    def run_steps(self, batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]
                  ) -> List[float]:
        """Train on every (data, target) batch; returns the losses. Raises
        if any loss is not finite, checked once after the last step so the
        loop adds no host syncs."""
        step_losses = [self.train_step(data, target) for data, target in batches]
        if not step_losses:
            return []
        values = torch.stack(step_losses).cpu()
        bad = (~torch.isfinite(values)).nonzero().flatten().tolist()
        if bad:
            raise RuntimeError(f"non-finite training loss at step {bad[0]} of "
                               f"{len(values)} (steps {bad})")
        return values.tolist()


class DeviceFeeder:
    """Moves the loaders' host batches to the device, the counterpart of
    ``jax.device_put``. On a card each array is copied into one of two
    pinned staging buffers, contiguous whatever the array's strides (a
    channels-last batch of several channels is not C-contiguous), and sent
    with a non-blocking copy; a buffer is refilled only after the copy that
    last read it has finished. On the CPU the array becomes a contiguous
    tensor. A tensor (a batch the device augmentation made) passes through
    as it is when it lies on the device already."""

    def __init__(self, device: torch.device):
        self.device = device
        self._rings: Dict[str, list] = {}

    def __call__(self, name: str, array: np.ndarray) -> torch.Tensor:
        if isinstance(array, torch.Tensor):   # made on the device already
            return array.to(self.device)
        src = torch.from_numpy(np.asarray(array))
        if self.device.type != "cuda":
            return src.to(self.device).contiguous()
        ring = self._rings.get(name)
        if ring is None or ring[0][0].shape != src.shape or ring[0][0].dtype != src.dtype:
            ring = self._rings[name] = [
                [torch.empty(src.shape, dtype=src.dtype, pin_memory=True), None]
                for _ in range(2)]
        slot = ring[0]
        ring.append(ring.pop(0))
        if slot[1] is not None:
            slot[1].synchronize()
        slot[0].copy_(src)
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out

    def batch(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        return self("data", batch["data"]), self("target", batch["target"])


class NNUNetTrainer:
    """The training run of one fold: ``initialize``, ``run_training``,
    ``perform_actual_validation``. The network and the steps live on
    ``device`` (the GPU unless the caller passes another; raises without
    one)."""

    def __init__(self, plans: dict, configuration: str, fold, dataset_json: dict,
                 trainer_name: str = "nnUNetTrainer", unpack_data: bool = True,
                 device: DeviceLike = "cuda"):
        from mlagg_unet_torch.plans.label_handling import determine_num_input_channels
        from mlagg_unet_torch.plans.plans_handler import PlansManager

        self.plans_manager = PlansManager(plans)
        self.configuration_manager = self.plans_manager.get_configuration(configuration)
        self.configuration_name = configuration
        self.dataset_json = dataset_json
        self.fold = fold
        self.trainer_name = trainer_name
        self.cfg: TrainerConfig = get_trainer_config(trainer_name)
        _check_ported(self.cfg)
        cm = self.configuration_manager
        self.is_cascaded = cm.previous_stage_name is not None
        self.device = resolve_device(device)
        self.unpack_data = unpack_data

        self.label_manager = self.plans_manager.get_label_manager(dataset_json)
        self.num_input_channels = determine_num_input_channels(
            self.plans_manager, cm, dataset_json)

        self.preprocessed_dataset_folder_base = join(
            paths.nnUNet_preprocessed, self.plans_manager.dataset_name)
        self.preprocessed_dataset_folder = join(
            self.preprocessed_dataset_folder_base, cm.data_identifier)
        self.output_folder_base = get_output_folder(
            self.plans_manager.dataset_name, trainer_name, self.plans_manager.plans_name,
            configuration)
        self.output_folder = join(self.output_folder_base, f"fold_{fold}")

        self.logger = NNUNetLogger()
        self.current_epoch = 0
        self._best_ema = None
        self.step: Optional[Trainer] = None
        self.was_initialized = False
        self.log_file = None
        self.feed = DeviceFeeder(self.device)
        self.dataloader_train = self.dataloader_val = None

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def configure_rotation_dummyDA_mirroring_and_initial_patch_size(self):
        """reference :354-410."""
        from mlagg_unet_torch.data.augment import get_patch_size

        patch_size = self.configuration_manager.patch_size
        dim = len(patch_size)
        if dim == 2:
            do_dummy_2d = False
            if max(patch_size) / min(patch_size) > 1.5:
                rotation = {"x": (-np.pi / 12, np.pi / 12), "y": (0, 0), "z": (0, 0)}
            else:
                rotation = {"x": (-np.pi, np.pi), "y": (0, 0), "z": (0, 0)}
            mirror_axes = (0, 1)
        elif dim == 3:
            do_dummy_2d = (max(patch_size) / patch_size[0]) > ANISO_THRESHOLD
            if do_dummy_2d:
                rotation = {"x": (-np.pi, np.pi), "y": (0, 0), "z": (0, 0)}
            else:
                rotation = {"x": (-np.pi / 6, np.pi / 6),
                            "y": (-np.pi / 6, np.pi / 6),
                            "z": (-np.pi / 6, np.pi / 6)}
            mirror_axes = (0, 1, 2)
        else:
            raise RuntimeError(f"patch size {patch_size}: 2D or 3D only")

        initial_patch_size = get_patch_size(
            patch_size[-dim:], rotation["x"], rotation["y"], rotation["z"], (0.85, 1.25))
        if do_dummy_2d:
            initial_patch_size[0] = patch_size[0]
        self.inference_allowed_mirroring_axes = mirror_axes
        return rotation, do_dummy_2d, initial_patch_size, mirror_axes

    def initialize(self):
        if self.was_initialized:
            raise RuntimeError("the trainer is initialized already")
        maybe_mkdir_p(self.output_folder)
        lm, cm = self.label_manager, self.configuration_manager
        self.step = Trainer(
            self.trainer_name, cm.patch_size, cm.batch_size, self.num_input_channels,
            lm.num_segmentation_heads, cm.batch_dice,
            seed=12345 + (0 if self.fold == "all" else int(self.fold)), device=self.device,
            regions=lm.all_regions if lm.has_regions else None,
            ignore_label=lm.ignore_label, configuration_manager=cm)
        self.was_initialized = True
        self._save_debug_information()

    def _save_debug_information(self):
        """Environment and configuration dump (reference nnUNetTrainer.py:215-248)."""
        dct = {
            "trainer_name": self.trainer_name,
            "trainer_config": {k: getattr(self.cfg, k) for k in self.cfg.__dataclass_fields__},
            "configuration_name": self.configuration_name,
            "configuration": self.configuration_manager.configuration,
            "fold": self.fold,
            "num_input_channels": self.num_input_channels,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": str(self.device),
            "device_name": self._device_name(),
        }
        save_json(dct, join(self.output_folder, "debug.json"))

    def previous_stage_folder(self) -> Optional[str]:
        """Where the previous stage of a cascade wrote this configuration's
        inputs (``trainer.py:521-528``); None outside a cascade."""
        prev = self.configuration_manager.previous_stage_name
        if prev is None:
            return None
        return join(self.output_folder_base.replace(f"__{self.configuration_name}",
                                                    f"__{prev}"),
                    "predicted_next_stage", self.configuration_name)

    def _device_name(self) -> str:
        return (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")

    # ------------------------------------------------------------------
    # split / data loaders
    # ------------------------------------------------------------------
    def do_split(self) -> Tuple[List[str], List[str]]:
        from mlagg_unet_torch.data.dataset import get_case_identifiers

        case_identifiers = get_case_identifiers(self.preprocessed_dataset_folder)
        if self.fold == "all":
            return case_identifiers, case_identifiers
        splits_file = join(self.preprocessed_dataset_folder_base, "splits_final.json")
        if not isfile(splits_file):
            splits = kfold_like_sklearn(case_identifiers, 5)
            save_json(splits, splits_file)
        else:
            splits = load_json(splits_file)
        if self.fold < len(splits):
            return splits[self.fold]["train"], splits[self.fold]["val"]
        # the reference falls back to a random 80:20 (:531-541)
        rnd = np.random.RandomState(12345 + self.fold)
        keys = np.array(case_identifiers)
        idx = rnd.choice(len(keys), len(keys), replace=False)
        n_tr = int(len(keys) * 0.8)
        return keys[idx[:n_tr]].tolist(), keys[idx[n_tr:]].tolist()

    def get_dataloaders(self):
        from mlagg_unet_torch.data.augment import (
            DA5TrainingTransforms,
            TrainingTransforms,
            ValidationTransforms,
        )
        from mlagg_unet_torch.data.dataset import nnUNetDataset
        from mlagg_unet_torch.data.loader import (
            PrefetchLoader,
            ProcessPrefetchLoader,
            nnUNetDataLoader2D,
            nnUNetDataLoader3D,
        )

        from mlagg_unet_torch.data.device_augment import (
            DeviceAugLoader,
            DeviceTrainingTransforms,
            parse_device_aug_flag,
        )

        dev_aug_mode = parse_device_aug_flag(os.environ.get("MLAGG_DEVICE_AUG", ""))
        patch_size = self.configuration_manager.patch_size
        dim = len(patch_size)
        rotation, do_dummy_2d, initial_patch_size, mirror_axes = (
            self.configure_rotation_dummyDA_mirroring_and_initial_patch_size())
        if self.cfg.disable_mirroring:
            mirror_axes = ()
            self.inference_allowed_mirroring_axes = ()
        elif self.cfg.mirror_axes_override is not None:
            # nnUNetTrainer_onlyMirror01: axes 0, 1 in 3D / axis 0 in 2D
            allowed = tuple(a for a in self.cfg.mirror_axes_override
                            if a < dim - (0 if dim == 3 else 1))
            mirror_axes = allowed
            self.inference_allowed_mirroring_axes = allowed

        tr_keys, val_keys = self.do_split()
        prev = self.previous_stage_folder()
        ds_tr = nnUNetDataset(self.preprocessed_dataset_folder, tr_keys, prev)
        ds_val = nnUNetDataset(self.preprocessed_dataset_folder, val_keys, prev)

        fg_labels = self.label_manager.foreground_labels
        if self.cfg.disable_da:
            tr_transforms = ValidationTransforms(patch_size, self.is_cascaded, fg_labels)
            sample_patch = list(patch_size)
        else:
            tf_cls = DA5TrainingTransforms if self.cfg.da_level == "DA5" else TrainingTransforms
            tr_transforms = tf_cls(
                list(patch_size), rotation, mirror_axes, do_dummy_2d,
                self.configuration_manager.use_mask_for_norm,
                order_resampling_data=self.cfg.order_resampling_data,
                order_resampling_seg=self.cfg.order_resampling_seg,
                is_cascaded=self.is_cascaded, foreground_labels=fg_labels)
            sample_patch = list(initial_patch_size)
        val_transforms = ValidationTransforms(patch_size, self.is_cascaded, fg_labels)

        # on-device augmentation (trainer.py:558-580): the workers only crop the
        # inflated patch and the stack runs on the batch's device; the host path
        # keeps dummy 2-D, the cascade's stages and DA5
        device_aug = None
        if (dev_aug_mode and not self.cfg.disable_da and not do_dummy_2d
                and not self.is_cascaded and self.cfg.da_level != "DA5"):
            device_aug = DeviceTrainingTransforms(
                patch_size, rotation, mirror_axes, interp=dev_aug_mode,
                num_classes=max(self.label_manager.all_labels) + 1)
            tr_transforms = None

        annotated_key = tuple(self.label_manager.all_labels)
        loader_cls = nnUNetDataLoader2D if dim == 2 else nnUNetDataLoader3D
        batch_size = self.configuration_manager.batch_size
        oversample = self.cfg.oversample_foreground_percent
        if self.cfg.probabilistic_oversampling and oversample < 0:
            # sentinel: the deterministic sampler's effective percent at this
            # batch size (reference sampling/:19-26)
            oversample = float(np.mean([i >= round(batch_size * (1 - 0.33))
                                        for i in range(batch_size)]))
        has_ignore = self.label_manager.has_ignore_label

        def make_tr(worker_id):
            return loader_cls(
                ds_tr, batch_size, sample_patch, list(patch_size), oversample,
                annotated_classes_key=annotated_key, has_ignore=has_ignore,
                transforms=tr_transforms, seed=1000 + worker_id,
                probabilistic_oversampling=self.cfg.probabilistic_oversampling)

        def make_val(worker_id):
            return loader_cls(
                ds_val, batch_size, list(patch_size), list(patch_size), oversample,
                annotated_classes_key=annotated_key, has_ignore=has_ignore,
                transforms=val_transforms, seed=2000 + worker_id)

        n_proc = default_n_proc_DA
        # threads for the 2D stacks, fork processes for 3D, whose GIL-holding
        # numpy augmentation gains nothing from threads (trainer.py:610-619)
        backend = os.environ.get("MLAGG_DA_BACKEND", "processes" if dim == 3 else "threads")
        loader_pool = ProcessPrefetchLoader if backend == "processes" else PrefetchLoader
        self.dataloader_train = loader_pool(
            make_tr, num_workers=n_proc, queue_size=6,
            num_batches_per_epoch=self.cfg.num_iterations_per_epoch)
        if device_aug is not None:
            self.dataloader_train = DeviceAugLoader(
                self.dataloader_train, device_aug, self.feed,
                seed=777 + (0 if self.fold == "all" else int(self.fold)))
        self.dataloader_val = loader_pool(
            make_val, num_workers=max(1, n_proc // 2), queue_size=3,
            num_batches_per_epoch=self.cfg.num_val_iterations_per_epoch)
        return self.dataloader_train, self.dataloader_val

    # ------------------------------------------------------------------
    # logging
    # ------------------------------------------------------------------
    def print_to_log_file(self, *args, also_print_to_console: bool = True):
        maybe_mkdir_p(self.output_folder)
        if self.log_file is None:
            timestamp = time.strftime("%Y_%m_%d_%H_%M_%S")
            self.log_file = join(self.output_folder, f"training_log_{timestamp}.txt")
        msg = " ".join(str(a) for a in args)
        with open(self.log_file, "a") as f:
            f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')}: {msg}\n")
        if also_print_to_console:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def save_checkpoint(self, filename: str):
        params, model_state = module_to_jax_variables(self.step.network)
        state = {
            "network_weights": params,
            "model_state": model_state,
            "opt_state": self.step.optimizer.state_dict(),
            "current_epoch": self.current_epoch + 1,
            "logging": self.logger.get_checkpoint(),
            "_best_ema": self._best_ema,
            "trainer_name": self.trainer_name,
            "init_args": {"configuration": self.configuration_name, "fold": self.fold},
            "inference_allowed_mirroring_axes": getattr(
                self, "inference_allowed_mirroring_axes", None),
        }
        save_checkpoint(state, join(self.output_folder, filename))

    def load_checkpoint_file(self, path: str):
        ckpt = load_checkpoint(path)
        self.step.network.load_state_dict(jax_variables_to_state_dict(
            ckpt["network_weights"], ckpt.get("model_state")), strict=True)
        self.current_epoch = ckpt["current_epoch"]
        opt, opt_state = self.step.optimizer, ckpt.get("opt_state")
        if opt.holds_state(opt_state):
            opt.load_state_dict(_to_tensors(opt_state))
        else:
            # an optax state (a JAX checkpoint) or another optimizer's: fresh
            # moments, the schedule at the checkpoint's epoch
            opt.count = self.current_epoch * self.cfg.num_iterations_per_epoch
            self.print_to_log_file(f"{path}: optimizer state not in the port's {opt.kind} "
                                   f"format; {opt.kind} restarts its moments at step "
                                   f"{opt.count}")
        self.logger.load_checkpoint(ckpt["logging"])
        self._best_ema = ckpt["_best_ema"]
        self.inference_allowed_mirroring_axes = ckpt.get("inference_allowed_mirroring_axes")

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def run_training(self):
        from mlagg_unet_torch.data.dataset import unpack_dataset

        if not self.was_initialized:
            self.initialize()
        if self.unpack_data:
            unpack_dataset(self.preprocessed_dataset_folder, num_processes=4)
        self.get_dataloaders()
        step = self.step

        cached = None
        if self.cfg.no_data_loading:
            # one cached batch isolates the device's speed (reference
            # nnUNetTrainerBenchmark_5epochs_noDataLoading)
            cached = self.feed.batch(self.dataloader_train.get_batch())

        save_every = 50
        # MLAGG_PROFILE_DIR: a torch.profiler trace of epoch 1
        profile_dir = os.environ.get("MLAGG_PROFILE_DIR")
        prof = None
        try:
            for epoch in range(self.current_epoch, self.cfg.num_epochs):
                if profile_dir and epoch == 1:
                    from torch.profiler import ProfilerActivity, profile

                    prof = profile(activities=[ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if self.device.type == "cuda" else []))
                    prof.start()
                self.logger.log("epoch_start_timestamps", time.time(), epoch)
                if cached is not None:
                    train_losses = [step.train_step(*cached)
                                    for _ in range(self.cfg.num_iterations_per_epoch)]
                else:
                    train_losses = [step.train_step(*self.feed.batch(b))
                                    for b in self.dataloader_train]
                # the losses reach the host once per epoch (trainer.py:746-747)
                values = torch.stack(train_losses).float().cpu().numpy()
                tr_loss = float(np.mean(values.astype(np.float64)))
                if not np.isfinite(tr_loss):
                    bad = np.flatnonzero(~np.isfinite(values))
                    raise RuntimeError(
                        f"Non-finite training loss in epoch {epoch} (first bad iteration "
                        f"{bad[0] if len(bad) else '?'} of {len(values)}). Checkpoints up "
                        f"to the previous epoch are intact in {self.output_folder}; resume "
                        "with --c after lowering the learning rate or inspecting data.")
                self.logger.log("train_losses", tr_loss, epoch)

                val_losses, counts = [], []
                for b in self.dataloader_val:
                    loss, tp, fp, fn = step.val_step(*self.feed.batch(b))
                    val_losses.append(loss)
                    counts.append(torch.stack([tp, fp, fn]))
                val_loss = float(torch.stack(val_losses).double().mean().cpu())
                tp, fp, fn = torch.stack(counts).sum(0).cpu().numpy()
                dice_per_class = [
                    float(2 * i / (2 * i + j + k)) if (2 * i + j + k) > 0 else 0.0
                    for i, j, k in zip(tp, fp, fn)]
                mean_fg_dice = float(np.nanmean(dice_per_class))
                self.logger.log("val_losses", val_loss, epoch)
                self.logger.log("mean_fg_dice", mean_fg_dice, epoch)
                self.logger.log("dice_per_class_or_region", dice_per_class, epoch)
                self.logger.log("lrs", float(self._current_lr(epoch)), epoch)
                self.logger.log("epoch_end_timestamps", time.time(), epoch)
                ema = self.logger.my_fantastic_logging["ema_fg_dice"][epoch]
                self.print_to_log_file(
                    f"Epoch {epoch}: train_loss {tr_loss:.4f} val_loss {val_loss:.4f} "
                    f"pseudo dice {['%.4f' % d for d in dice_per_class]} ema {ema:.4f}")

                if prof is not None:
                    prof.stop()
                    maybe_mkdir_p(profile_dir)
                    prof.export_chrome_trace(join(profile_dir, "epoch_1.trace.json"))
                    prof = None

                self.current_epoch = epoch
                if self._best_ema is None or ema > self._best_ema:
                    self._best_ema = ema
                    self.save_checkpoint("checkpoint_best.ckpt")
                if (epoch + 1) % save_every == 0 or epoch == self.cfg.num_epochs - 1:
                    self.save_checkpoint("checkpoint_latest.ckpt")
                try:
                    self.logger.plot_progress_png(self.output_folder)
                except Exception:
                    pass  # no matplotlib (the reference's plot is optional too)

            self.save_checkpoint("checkpoint_final.ckpt")
            if self.cfg.benchmark:
                self._save_benchmark_result()
        finally:
            if prof is not None:
                prof.stop()
            self.dataloader_train.stop()
            self.dataloader_val.stop()

    def _save_benchmark_result(self):
        """The fastest epoch's seconds, keyed by the card and the torch
        version (reference nnUNetTrainerBenchmark_5epochs.py:36-66)."""
        lg = self.logger.my_fantastic_logging
        epoch_times = [e - s for s, e in zip(lg["epoch_start_timestamps"],
                                              lg["epoch_end_timestamps"])
                       if s is not None and e is not None]
        result = {
            "trainer": self.trainer_name,
            "fastest_epoch": float(np.min(epoch_times)),
            "epoch_times": [float(t) for t in epoch_times],
            "device": self._device_name(),
            "num_devices": 1,
            "torch_version": torch.__version__,
        }
        save_json({f"{result['device']}__torch_{result['torch_version']}": result},
                  join(self.output_folder, "benchmark_result.json"))

    def perform_actual_validation(self, save_probabilities: bool = False):
        """The final sliding-window validation of the fold's validation cases
        (reference :1056-1200): each case predicted with the final weights,
        mirror TTA over the allowed axes, tile batch 4, bf16; exported through
        the inverse preprocessing; metrics against the ground truth into
        ``validation/summary.json``. A cascade stage stacks the previous
        stage's one-hot segmentation on the case, as the reference does
        (:1110-1113; the JAX package leaves it out); a stage with next stages
        writes each case's segmentation at the next stage's shape into
        ``predicted_next_stage/<next>`` (:1146-1181)."""
        from mlagg_unet_torch.data.dataset import nnUNetDataset
        from mlagg_unet_torch.evaluation.metrics import compute_metrics_on_folder
        from mlagg_unet_torch.inference.export import (
            export_prediction_from_logits,
            resample_and_save,
        )
        from mlagg_unet_torch.inference.sliding_window import VolumePredictor
        from mlagg_unet_torch.plans.label_handling import convert_labelmap_to_one_hot

        if not self.was_initialized:
            self.initialize()
            final = join(self.output_folder, "checkpoint_final.ckpt")
            if isfile(final):
                self.load_checkpoint_file(final)

        validation_output_folder = join(self.output_folder, "validation")
        maybe_mkdir_p(validation_output_folder)
        _, val_keys = self.do_split()
        ds_val = nnUNetDataset(self.preprocessed_dataset_folder, val_keys,
                               self.previous_stage_folder())

        mirror_axes = getattr(self, "inference_allowed_mirroring_axes", None)
        if mirror_axes is None:
            mirror_axes = tuple(range(len(self.configuration_manager.patch_size)))
        predictor = VolumePredictor(
            self.step.network, self.configuration_manager.patch_size,
            self.label_manager.num_segmentation_heads, tuple(mirror_axes),
            tile_batch_size=4, compute_dtype=torch.bfloat16, device=self.device)
        next_stages = self.configuration_manager.next_stage_names or []
        for k in val_keys:
            data, seg, properties = ds_val.load_case(k)
            data = np.array(data)   # a writable copy of an unpacked memmap
            if self.is_cascaded:
                data = np.vstack([data, convert_labelmap_to_one_hot(
                    seg[-1], self.label_manager.foreground_labels, data.dtype)])
            logits = predictor(data)
            export_prediction_from_logits(
                logits, properties, self.configuration_manager, self.plans_manager,
                self.dataset_json, join(validation_output_folder, k),
                save_probabilities=save_probabilities)
            for ns in next_stages:
                next_cm = self.plans_manager.get_configuration(ns)
                next_dir = join(self.preprocessed_dataset_folder_base, next_cm.data_identifier)
                if not isfile(join(next_dir, k + ".npz")):
                    continue
                d_next, _, _ = nnUNetDataset(next_dir, [k]).load_case(k)
                out_dir = join(self.output_folder_base, "predicted_next_stage", ns)
                maybe_mkdir_p(out_dir)
                resample_and_save(logits, d_next.shape[1:], join(out_dir, k + ".npz"),
                                  self.plans_manager, self.configuration_manager,
                                  properties, self.dataset_json)

        gt_folder = join(self.preprocessed_dataset_folder_base, "gt_segmentations")
        if not os.path.isdir(gt_folder):
            gt_folder = join(paths.nnUNet_raw, self.plans_manager.dataset_name, "labelsTr")
        lm = self.label_manager
        metrics = compute_metrics_on_folder(
            gt_folder, validation_output_folder,
            join(validation_output_folder, "summary.json"),
            self.plans_manager.image_reader_writer_class(),
            self.dataset_json["file_ending"],
            lm.foreground_regions if lm.has_regions else lm.foreground_labels,
            lm.ignore_label)
        self.print_to_log_file("Validation complete. Mean foreground Dice:",
                               metrics["foreground_mean"]["Dice"])
        return metrics

    def _current_lr(self, epoch: int) -> float:
        return float(_epoch_schedule(self.cfg)(epoch))


def _to_tensors(tree):
    """numpy arrays (as a checkpoint holds them) back to tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    return tree

