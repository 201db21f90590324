"""Carry weights between the JAX package's parameter tree and the port.

The port's submodules are named after the flax scopes, so a flat JAX key
``"mlla/layer0/block0/attn_pool/kv/kernel"`` becomes the state-dict key
``"mlla.layer0.block0.attn_pool.kv.weight"``. Only layouts change:

- a Dense kernel (in, out) is transposed to (out, in);
- a conv kernel (*k, in / g, out), 1-D, 2-D or 3-D, becomes (out, in / g, *k)
  (a depthwise conv1d's (k, 1, d) becomes (d, 1, k));
- a transposed-conv kernel (*k, in, out) becomes torch's (in, out, *k); a
  depthwise one (*k, 1, C) (MedNeXt's up blocks, ``groups = C``) becomes
  torch's (C, 1, *k), as a forward conv's kernel does: torch's
  ``weight[g in/g + i, j]`` is JAX's ``[..., i, g out/g + j]``, which for one
  input and one output channel a group is the forward conv's order. A
  transposed kernel with one input channel a group is taken as depthwise;
- ``scale`` becomes ``weight``;
- raw params (``A_logs``, ``Ds``, ``x_proj_weight``, ``dt_projs_*``,
  MambaBlock's ``dt_proj*_weight``, ``dt_proj*_bias``, ``A*_log`` and
  ``D*``, ``lambda_*``, ``grn_*``, the variants' ``skip_scale``) and biases
  keep the JAX shape.

A parameterless norm (JAX's ``InstanceNorm(affine=False)``, the port's
``instance_norm``) has no key on either side; a module that several blocks call (nnMamba's shared Mamba layer) is
one scope on both.

Transposed convs are told apart by their scope names (the flagship's and
MedNeXt's ``up_*/conv1``, ``up_*/res_conv`` and ``transp_conv``, the U-Net's
``decoder_transp*``, LKM-UNet's ``transpconv*``).

BatchNorm's running statistics, flax's ``batch_stats`` collection
(``.../norm/mean``, ``.../norm/var``), are the port's module buffers of the
same names: ``module_to_jax_variables`` splits a module into the param tree
and the ``model_state`` that the JAX package's checkpoints hold, and
``jax_variables_to_state_dict`` joins them again.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_TRANSPOSED = re.compile(
    r"(^|/)(up_\d+/(conv1|res_conv)|transp_conv|decoder_transp\d+|transpconv\d+)/kernel$")


def _torch_name(key: str) -> str:
    parts = key.split("/")
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _transposed(key: str, arr: np.ndarray, channel_axis: int) -> bool:
    """Whether ``arr`` takes the transposed-conv layout: a transposed conv's
    kernel whose ``channel_axis`` (JAX's in / groups, torch's out / groups)
    is not 1. A depthwise one is laid out as a forward conv's."""
    return arr.ndim > 2 and arr.shape[channel_axis] != 1 and bool(_TRANSPOSED.search(key))


def _kernel_perm(key: str, ndim: int, transposed: bool):
    """Axis order taking a JAX kernel to the port's layout."""
    if ndim == 2:
        return (1, 0)
    if ndim in (3, 4, 5):
        spatial = tuple(range(ndim - 2))
        io = (ndim - 2, ndim - 1) if transposed else (ndim - 1, ndim - 2)
        return io + spatial
    raise ValueError(f"{key}: kernel of rank {ndim}")


def jax_params_to_state_dict(flat: Mapping[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """``{"a/b/kernel": array}`` -> a state_dict for the port's model
    (``load_state_dict(strict=True)``)."""
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if key.rsplit("/", 1)[-1] == "kernel":
            arr = arr.transpose(_kernel_perm(key, arr.ndim, _transposed(key, arr, -2)))
        out[_torch_name(key)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def state_dict_to_jax_params(state_dict: Mapping[str, torch.Tensor],
                             jax_keys) -> Dict[str, np.ndarray]:
    """Inverse of ``jax_params_to_state_dict`` for the given flat JAX keys."""
    out = {}
    for key in jax_keys:
        arr = state_dict[_torch_name(key)].detach().cpu().numpy()
        if key.rsplit("/", 1)[-1] == "kernel":
            arr = arr.transpose(np.argsort(_kernel_perm(key, arr.ndim,
                                                        _transposed(key, arr, 1))))
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


def module_to_jax_variables(module: torch.nn.Module) -> Tuple[dict, dict]:
    """(param tree, model_state) of a module as the JAX package's checkpoints
    hold them: its parameters as ``network_weights``, and its buffers (the
    BatchNorm running statistics) as ``{"batch_stats": tree}``, or ``{}``
    for a network without them."""
    params = state_dict_to_jax_tree(dict(module.named_parameters()))
    buffers = dict(module.named_buffers())
    return params, ({"batch_stats": state_dict_to_jax_tree(buffers)} if buffers else {})


def jax_variables_to_state_dict(params: Mapping, model_state: Optional[Mapping] = None
                                ) -> Dict[str, torch.Tensor]:
    """Inverse of ``module_to_jax_variables``: a param tree and a
    ``model_state`` (its collections, e.g. ``batch_stats``) to one state_dict
    for ``load_state_dict(strict=True)``."""
    out = jax_tree_to_state_dict(params)
    for tree in (model_state or {}).values():
        out.update(jax_tree_to_state_dict(tree))
    return out
