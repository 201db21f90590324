"""MLAgg-UNet in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``mlagg_unet_tpu`` (JAX/Pallas), which stays in the repository as
the numerical reference. This package imports ``torch`` and never ``jax``,
``flax`` or ``mlagg_unet_tpu``. Public functions keep the JAX package's
layouts: NHWC activations in the models, ``(b, g, d, l)`` for the selective
scan and ``(b, h, l, d)`` for attention.

Entry points (``build_flagship``, ``VolumePredictor``, ``Trainer``,
``inference.predictor.NNUNetPredictor`` and the predict verbs of
``cli/entrypoints.py``) run on the GPU unless the caller passes
``device="cpu"``; without a GPU they raise.
"""
from mlagg_unet_torch.device import resolve_device
from mlagg_unet_torch.inference.sliding_window import VolumePredictor
from mlagg_unet_torch.models.mlla_uper import build_flagship
from mlagg_unet_torch.training.trainer import Trainer

__all__ = ["resolve_device", "build_flagship", "VolumePredictor", "Trainer"]
