"""Carry weights between the JAX package's parameter tree and the port.

The port's submodules are named after the flax scopes, so a flat JAX key
``"mlla/layer0/block0/attn_pool/kv/kernel"`` becomes the state-dict key
``"mlla.layer0.block0.attn_pool.kv.weight"``. Only layouts change:

- a Dense kernel (in, out) is transposed to (out, in);
- a conv kernel (kh, kw, in / g, out) becomes (out, in / g, kh, kw);
- a transposed-conv kernel (kh, kw, in, out) becomes torch's (in, out, kh, kw);
- ``scale`` becomes ``weight``;
- raw params (``A_logs``, ``Ds``, ``x_proj_weight``, ``dt_projs_*``,
  ``lambda_*``, ``grn_*``) and biases keep the JAX shape.

Transposed convs are told apart by their scope names in the flagship
(``up_*/conv1``, ``up_*/res_conv``, ``transp_conv``).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_TRANSPOSED = re.compile(r"(^|/)(up_\d+/(conv1|res_conv)|transp_conv)/kernel$")


def _torch_name(key: str) -> str:
    parts = key.split("/")
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _kernel_perm(key: str, ndim: int):
    """Axis order taking a JAX kernel to the port's layout."""
    if ndim == 2:
        return (1, 0)
    if ndim == 4:
        return (2, 3, 0, 1) if _TRANSPOSED.search(key) else (3, 2, 0, 1)
    raise ValueError(f"{key}: kernel of rank {ndim}")


def jax_params_to_state_dict(flat: Mapping[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """``{"a/b/kernel": array}`` -> a state_dict for the port's model
    (``load_state_dict(strict=True)``)."""
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if key.rsplit("/", 1)[-1] == "kernel":
            arr = arr.transpose(_kernel_perm(key, arr.ndim))
        out[_torch_name(key)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def state_dict_to_jax_params(state_dict: Mapping[str, torch.Tensor],
                             jax_keys) -> Dict[str, np.ndarray]:
    """Inverse of ``jax_params_to_state_dict`` for the given flat JAX keys."""
    out = {}
    for key in jax_keys:
        arr = state_dict[_torch_name(key)].detach().cpu().numpy()
        if key.rsplit("/", 1)[-1] == "kernel":
            arr = arr.transpose(np.argsort(_kernel_perm(key, arr.ndim)))
        out[key] = np.ascontiguousarray(arr)
    return out


def jax_key(name: str, ndim: int) -> str:
    """The flat JAX key of a state-dict entry: a ``weight`` of rank >= 2 is
    a ``kernel``, of rank 1 a ``scale``."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim >= 2 else "scale"
    return "/".join(parts)


def state_dict_to_jax_tree(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A state_dict as the JAX package's nested param tree of numpy arrays
    (what its checkpoints hold under ``network_weights``)."""
    flat = state_dict_to_jax_params(
        state_dict, [jax_key(k, v.ndim) for k, v in state_dict.items()])
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def jax_tree_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Inverse of ``state_dict_to_jax_tree``: a nested param tree to a
    state_dict for ``load_state_dict(strict=True)``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(tree, "")
    return jax_params_to_state_dict(flat)
