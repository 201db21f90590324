"""Train and validation steps of the flagship recipe on one device.

Counterpart of the step functions of ``NNUNetTrainerTPU._build_step_fns``
(``mlagg_unet_tpu/training/trainer.py:406-467``) and of the finite-loss
guard of its epoch loop (``:748-761``). ``Trainer`` is built from a trainer
name of ``training.registry``, the patch and batch size, the input channels
and classes, ``batch_dice``, a seed and a device; plans, dataset folders,
epochs, checkpoints and the final validation wait for the data-pipeline
slice, so batches come from the caller.

A train step runs the network in the recipe's compute dtype (bf16): the fp32
master parameters are cast inside ``torch.func.functional_call``, as the
JAX step casts its param tree (``:412-417``), so the gradients reach the
fp32 masters. Stochastic depth draws from the trainer's own
``torch.Generator`` on the device. The deep-supervision DC+CE loss is fp32,
then the gradients are clipped to a global norm of 12 and AdamW steps with
the cosine schedule at the step's epoch.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.training import losses
from mlagg_unet_torch.training.lr_schedule import (
    cosine_warmup_lr,
    epoch_schedule_to_step_schedule,
    poly_lr,
)
from mlagg_unet_torch.training.optim import AdamWChain
from mlagg_unet_torch.training.registry import (
    TrainerConfig,
    get_network_builder,
    get_trainer_config,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _epoch_schedule(cfg: TrainerConfig):
    if cfg.lr_scheduler == "poly":
        return poly_lr(cfg.initial_lr, cfg.num_epochs)
    if cfg.lr_scheduler == "cosine_warmup":
        return cosine_warmup_lr(cfg.initial_lr, cfg.num_epochs,
                                warmup_epochs=cfg.warmup_epochs)
    raise NotImplementedError(f"lr scheduler {cfg.lr_scheduler!r} is not ported yet")


class Trainer:
    """One network, its AdamW chain and its train / validation steps.

    ``data`` is (batch, *patch, channels) float and ``target`` (batch, *patch)
    integer labels, both on the trainer's device. ``compute_dtype`` and
    ``network_overrides`` (passed to the network builder, e.g. smaller widths
    or drop-path rates) replace the recipe's own where given.
    """

    def __init__(self, trainer_name: str = "nnUNetTrainer_MLAgg_2D_dt_MS",
                 patch_size: Sequence[int] = (256, 224), batch_size: int = 10,
                 num_input_channels: int = 1, num_classes: int = 4,
                 batch_dice: bool = False, seed: int = 0,
                 device: DeviceLike = "cuda",
                 compute_dtype: Optional[torch.dtype] = None,
                 network_overrides: Optional[dict] = None):
        self.device = resolve_device(device)
        self.cfg = get_trainer_config(trainer_name)
        if self.cfg.optimizer != "adamw":
            raise NotImplementedError(f"optimizer {self.cfg.optimizer!r} is not ported yet")
        if self.cfg.loss != "default":
            raise NotImplementedError(f"loss {self.cfg.loss!r} is not ported yet")
        scales = self.cfg.deep_supervision_scales_override
        if self.cfg.enable_deep_supervision and scales is None:
            raise NotImplementedError("deep-supervision scales from plans wait "
                                      "for the data-pipeline slice")
        self.patch_size = tuple(patch_size)
        self.batch_size = int(batch_size)
        self.num_input_channels = num_input_channels
        self.num_classes = num_classes
        self.batch_dice = batch_dice
        self.compute_dtype = compute_dtype or _DTYPES[self.cfg.compute_dtype]
        self.network = get_network_builder(self.cfg.network)(
            self.patch_size, num_input_channels, num_classes,
            self.cfg.enable_deep_supervision, seed=seed, device=self.device,
            **(network_overrides or {})).train()
        self.ds_scales = [list(s) for s in scales] if scales is not None else None
        # a fixed-scale recipe keeps the lowest scale's weight; only the
        # plans-derived scales zero it (trainer.py:194-200)
        self.ds_weights = (losses.deep_supervision_weights(len(scales))
                           if scales is not None else None)
        schedule = epoch_schedule_to_step_schedule(
            _epoch_schedule(self.cfg), self.cfg.num_iterations_per_epoch)
        self.optimizer = AdamWChain(self.network.parameters(), schedule,
                                    self.cfg.grad_clip_norm, self.cfg.adam_eps,
                                    self.cfg.weight_decay)
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
        the fp32 master parameters."""
        cdt = self.compute_dtype
        if cdt == torch.float32:
            return self.network(data.float(), self.generator)
        params = {k: v.to(cdt) for k, v in self.network.named_parameters()}
        return functional_call(self.network, params, (data.to(cdt),),
                               {"generator": self.generator})

    def loss(self, outputs, target: torch.Tensor) -> torch.Tensor:
        """DC+CE (no background in the dice), fp32, summed over the
        deep-supervision scales with their weights."""
        def single(o, t):
            return losses.dc_and_ce_loss(o, t, batch_dice=self.batch_dice,
                                         do_bg=False)

        if self.cfg.enable_deep_supervision and isinstance(outputs, (list, tuple)):
            targets = losses.downsample_seg_for_ds(target, self.ds_scales)
            return losses.deep_supervision_loss(single, outputs, targets,
                                                self.ds_weights)
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        return single(out, target)

    def forward_loss(self, data: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The training loss of one batch, before any step."""
        self._check_batch(data, target)
        self.network.train()
        return self.loss(self.forward(data), target)

    def train_step(self, data: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Forward, loss, backward, clip and one AdamW step. Returns the
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
        training, and the hard per-foreground-class counts of the online
        pseudo dice (``trainer.py:442-464``)."""
        self._check_batch(data, target)
        self.network.eval()
        try:
            outputs = self.forward(data)
            loss = self.loss(outputs, target)
        finally:
            self.network.train()
        out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
        n_cls = out.shape[-1]
        pred = F.one_hot(out.argmax(-1), n_cls)[..., 1:]
        tgt = F.one_hot(target.long(), n_cls)[..., 1:]
        tp, fp, fn, _ = losses.get_tp_fp_fn_tn(pred, tgt)
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
