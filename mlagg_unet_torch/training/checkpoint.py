"""Checkpoints in the JAX package's format.

Counterpart of ``mlagg_unet_tpu/training/checkpoint.py``: one atomically
written pickle of a tree of numpy arrays, with the reference's payload
(``network_weights``, ``trainer_name``, ``init_args``,
``inference_allowed_mirroring_axes``, ...). ``network_weights`` is the
JAX package's nested param tree (``weights.state_dict_to_jax_tree``), so
either package reads what the other wrote.

A checkpoint written by the JAX trainer also pickles its optax optimizer
state, whose classes would import ``optax`` and with it ``jax``.
``load_checkpoint`` reads such a file without them: every class from
``jax*``, ``flax*``, ``optax*``, ``chex*`` or ``mlagg_unet_tpu*`` becomes an
inert placeholder that keeps its arguments (flax's ``FrozenDict`` becomes a
plain dict). Unpickle only files this program or the JAX package wrote:
unpickling can run code.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import torch

_FOREIGN = ("jax", "jaxlib", "flax", "optax", "chex", "mlagg_unet_tpu")


class ForeignObject:
    """Stands in for an object of a foreign package; keeps what it was
    built with."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _FOREIGN:
            if name == "FrozenDict":
                return dict
            return type(name, (ForeignObject,), {"__module__": module})
        return super().find_class(module, name)


def _to_numpy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy_tree(v) for v in tree)
    return tree


def save_checkpoint(state: dict, path: str) -> None:
    """Atomic single-file pickle of ``state`` with every tensor as a numpy
    array."""
    state = _to_numpy_tree(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=4)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return _Unpickler(f).load()

