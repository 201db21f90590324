"""Training logger (reference: training/logging/nnunet_logger.py:9-103):
per-epoch series, EMA pseudo-dice (lambda=0.9), 3-panel progress.png,
serialized into checkpoints.

Copied from ``mlagg_unet_tpu/training/logger.py``. ``plot_progress_png``
imports matplotlib when called.
"""
from __future__ import annotations

from typing import List

import numpy as np


class NNUNetLogger:
    def __init__(self, verbose: bool = False):
        self.my_fantastic_logging = {
            "mean_fg_dice": [],
            "ema_fg_dice": [],
            "dice_per_class_or_region": [],
            "train_losses": [],
            "val_losses": [],
            "lrs": [],
            "epoch_start_timestamps": [],
            "epoch_end_timestamps": [],
        }
        self.verbose = verbose

    def log(self, key: str, value, epoch: int):
        assert key in self.my_fantastic_logging, f"unknown log key {key}"
        series = self.my_fantastic_logging[key]
        if len(series) < epoch + 1:
            series += [None] * (epoch + 1 - len(series))
        series[epoch] = value

        # EMA dice (reference :49-52)
        if key == "mean_fg_dice":
            ema = self.my_fantastic_logging["ema_fg_dice"]
            prev = ema[epoch - 1] if epoch > 0 and len(ema) >= epoch else None
            new_ema = (prev * 0.9 + 0.1 * value) if prev is not None else value
            self.log("ema_fg_dice", new_ema, epoch)

    def plot_progress_png(self, output_folder: str):
        import matplotlib

        matplotlib.use("agg")
        import matplotlib.pyplot as plt

        lg = self.my_fantastic_logging
        epoch = min(len(lg["train_losses"]), len(lg["val_losses"])) - 1
        if epoch < 0:
            return
        xs = list(range(epoch + 1))
        fig, axes = plt.subplots(3, 1, figsize=(10, 12))
        ax = axes[0]
        ax.plot(xs, lg["train_losses"][: epoch + 1], label="tr_loss")
        ax.plot(xs, lg["val_losses"][: epoch + 1], label="val_loss")
        ax.legend()
        ax2 = axes[0].twinx()
        ax2.plot(xs, lg["mean_fg_dice"][: epoch + 1], color="g",
                 label="pseudo dice")
        ax2.plot(xs, lg["ema_fg_dice"][: epoch + 1], color="b", ls="--",
                 label="pseudo dice (ema)")
        ax2.legend(loc="lower right")
        axes[1].plot(xs, [
            (e - s) if (e is not None and s is not None) else np.nan
            for s, e in zip(lg["epoch_start_timestamps"][: epoch + 1],
                            lg["epoch_end_timestamps"][: epoch + 1])
        ])
        axes[1].set_ylabel("epoch time [s]")
        axes[2].plot(xs, lg["lrs"][: epoch + 1])
        axes[2].set_ylabel("lr")
        axes[2].set_xlabel("epoch")
        plt.tight_layout()
        fig.savefig(f"{output_folder}/progress.png")
        plt.close(fig)

    def get_checkpoint(self) -> dict:
        return self.my_fantastic_logging

    def load_checkpoint(self, checkpoint: dict):
        self.my_fantastic_logging = checkpoint
