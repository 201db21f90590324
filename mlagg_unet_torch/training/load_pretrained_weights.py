"""Pretrained-weight transfer for fine-tuning (the train verb's
``-pretrained_weights``; reference: run/load_pretrained_weights.py:5).

Counterpart of ``mlagg_unet_tpu/training/load_pretrained_weights.py``: a
parameter whose name and shape match one in the checkpoint is copied into
the network; every other keeps its fresh initialization. The checkpoint is
one in the JAX package's format (``network_weights``, the JAX param tree) or
that tree alone.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from mlagg_unet_torch.training.checkpoint import load_checkpoint
from mlagg_unet_torch.weights import jax_key, jax_params_to_state_dict


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[prefix + k] = v
    return flat


@torch.no_grad()
def transfer_matching(network: torch.nn.Module, source: Mapping[str, torch.Tensor],
                      verbose: bool = False) -> Tuple[int, int]:
    """Copy each entry of the state_dict ``source`` whose name and shape
    match a parameter of ``network``; returns (n_transferred, n_total)."""
    n_transferred = 0
    params = dict(network.named_parameters())
    for name, p in params.items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(p.shape):
            p.copy_(src.to(p.device, p.dtype))
            n_transferred += 1
            if verbose:
                print(f"transfer: {name} {tuple(p.shape)}")
        elif verbose:
            print(f"keep init: {name} {tuple(p.shape)}")
    return n_transferred, len(params)


def load_pretrained_weights(network: torch.nn.Module, pretrained_checkpoint_path: str,
                            verbose: bool = False) -> Tuple[int, int]:
    """Load the name- and shape-matched parameters of a checkpoint into
    ``network`` in place; returns (n_transferred, n_total)."""
    ckpt = load_checkpoint(pretrained_checkpoint_path)
    flat = _flatten(ckpt["network_weights"] if "network_weights" in ckpt else ckpt)
    # only the entries that name a parameter of this network are converted
    wanted = {jax_key(n, p.ndim) for n, p in network.named_parameters()}
    source = jax_params_to_state_dict({k: v for k, v in flat.items() if k in wanted})
    return transfer_matching(network, source, verbose)
