"""Reference-checkpoint import for the flagship.

Copied from ``mlagg_unet_tpu/training/torch_import.py``: the reference's
``MLLA_Uper`` key rules (``REFERENCE_FLAGSHIP_RULES``, the ConvTranspose
keys) and the converter to the JAX package's flat layout. Composed with
``weights.jax_params_to_state_dict`` they take a reference
``fold_X/checkpoint_final.pth``'s ``network_weights`` to a state_dict the
port's ``MLLAUper`` loads with ``strict=True``, and
``load_pretrained_torch_weights`` transfers a reference flagship's weights
for fine-tuning (the train verb's ``-pretrained_weights``). The other
families' converters wait for their models (ROADMAP queue A, A16).
"""
from __future__ import annotations

import re as _re
from typing import Dict

import numpy as np
import torch

from mlagg_unet_torch.weights import jax_params_to_state_dict

REFERENCE_FLAGSHIP_RULES = [
    (r"^mlla\.layers\.(\d+)\.blocks\.(\d+)\.", r"mlla.layer\1.block\2."),
    (r"^mlla\.layers\.(\d+)\.downsample\.", r"mlla.down\1."),
    (r"^mlla\.downs\.(\d+)\.norm\.", r"mlla.down\1.norm.GroupNorm_0."),
    (r"^mlla\.downs\.(\d+)\.", r"mlla.down\1."),
    (r"\.attn\.0\.", ".attn_local."),
    (r"\.attn\.1\.", ".attn_pool."),
    (r"^mambaskip\.blocks\.(\d+)\.", r"mambaskip.block\1."),
    (r"\.conv2d\.(\d+)\.", r".conv2d_\1."),
    (r"\.mlps\.(\d+)\.", r".mlp\1."),
    (r"\.conv_branches\.(\d+)\.0\.", r".conv_branch\1."),
    (r"\.conv_branches\.(\d+)\.1\.", r".conv_norm\1.GroupNorm_0."),
    (r"^dec_block_(\d+)\.(\d+)\.", r"dec_block_\1_\2."),
    (r"\.dwconv\.dwconv\.", ".DWConv2d_0.Conv_0."),
    (r"\.dwc\.", ".dwc.Conv_0."),
    (r"\.lepe\.", ".lepe.Conv_0."),
    (r"\.fc1\.", ".Dense_0."),
    (r"\.fc2\.", ".Dense_1."),
    (r"^(encoder0|decoder0)\.(.*)\.conv\.", r"\1.\2."),
    (r"^(dec_block_\d+_\d+)\.norm\.", r"\1.norm.GroupNorm_0."),
    (r"^(up_\d+)\.norm\.", r"\1.norm.GroupNorm_0."),
    (r"^(encoder0|decoder0)\.(.*)\.norm(\d)\.", r"\1.\2.norm\3.GroupNorm_0."),
    (r"^out_(\d)\.conv_out\.conv\.", r"out_\1.conv_out."),
]

# keys whose tensors use torch's ConvTranspose layout (I, O/g, *k) —
# including OutBlock, which the reference implements as ConvTranspose(k=1)
_REFERENCE_TRANSPOSED = _re.compile(
    r"(transp_conv|transpconvs\.\d+|up_\d+\.conv1|up_\d+\.res_conv"
    r"|out_\d+\.conv_out)(\.conv)?\.(weight|bias)$")


def _convert_reference_state_dict(state_dict, rules,
                                  k_dirs: int = 4) -> Dict[str, np.ndarray]:
    out = {}
    for key, tensor in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key == "dummy_tensor" or key.endswith("num_batches_tracked"):
            continue
        arr = np.asarray(tensor.detach().cpu().numpy()
                         if hasattr(tensor, "detach") else tensor)
        # reference merges the K scan directions: A_logs (K*d, n),
        # Ds (K*d,) (MambaSkip.py:339-341; K=12 for the VMUNet3D SS3D);
        # ours keep the K axis
        leaf_name = key.split(".")[-1]
        if leaf_name == "A_logs":
            arr = arr.reshape(k_dirs, -1, arr.shape[-1])
        elif leaf_name == "Ds":
            arr = arr.reshape(k_dirs, -1)
        elif leaf_name in ("A_log", "A_b_log", "A_s_log") and arr.ndim == 2:
            # mamba_ssm keeps (d, n); our MambaBlock holds (1, d, n)
            # (_b/_s: SegMamba tri-orientated branches)
            arr = arr[None]
        elif key.endswith(("grn_beta", "grn_gamma")):
            # torch channels-first (1, C, 1, 1[, 1]) -> channels-last
            arr = np.moveaxis(arr, 1, -1)
        transposed = bool(_REFERENCE_TRANSPOSED.search(key))
        mapped = key
        dropped = False
        for pat, rep in rules:
            if rep is None:
                if _re.search(pat, mapped):
                    dropped = True
                    break
                continue
            mapped = _re.sub(pat, rep, mapped)
        if dropped:
            continue
        parts = mapped.split(".")
        leaf = parts[-1]
        if leaf == "weight":
            if arr.ndim >= 3:
                # torch ConvTranspose stores (I, O/g, *k); ours is
                # (*k, I/g, O). For DEPTHWISE transposed convs (O/g == 1,
                # e.g. MedNeXtUpBlock conv1) the torch dim-0 is the group
                # axis and maps to our LAST axis — same as a forward conv.
                if transposed and arr.shape[1] != 1:
                    arr = np.moveaxis(arr, (0, 1), (-2, -1))
                else:
                    arr = np.moveaxis(arr, (0, 1), (-1, -2))
                leaf = "kernel"
            elif arr.ndim == 2:
                arr = arr.T
                leaf = "kernel"
            else:
                leaf = "scale"
        out["/".join(parts[:-1] + [leaf])] = arr
    return out


def convert_reference_flagship_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch MLLA_Uper state_dict -> {'a/b/c': array} in flax layout."""
    return _convert_reference_state_dict(state_dict,
                                         REFERENCE_FLAGSHIP_RULES)


def reference_flagship_state_dict_to_port(state_dict) -> Dict[str, torch.Tensor]:
    """A reference ``MLLA_Uper`` state_dict -> the port's ``MLLAUper``
    state_dict (``load_state_dict(strict=True)``)."""
    return jax_params_to_state_dict(convert_reference_flagship_state_dict(state_dict))


def load_torch_checkpoint_state_dict(path: str):
    """The state_dict of a reference ``.pth``/``.pt``: its
    ``network_weights``, its ``state_dict`` or the file itself."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "network_weights" in ckpt:
        return ckpt["network_weights"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def load_pretrained_torch_weights(network: torch.nn.Module, torch_checkpoint_path: str,
                                  verbose: bool = False):
    """Name- and shape-matched transfer from a reference flagship
    checkpoint (``MLLA_Uper``, the flagship's key rules) into ``network``
    in place; returns (n_transferred, n_total). A checkpoint of another
    family raises: its converters are not ported yet."""
    from mlagg_unet_torch.training.load_pretrained_weights import transfer_matching

    state_dict = load_torch_checkpoint_state_dict(torch_checkpoint_path)
    keys = [k[len("module."):] if k.startswith("module.") else k for k in state_dict]
    if not any(k.startswith("mlla.layers.") for k in keys):
        raise NotImplementedError(
            f"{torch_checkpoint_path} is not a reference MLLA_Uper checkpoint: the other "
            "families' converters are not ported yet (ROADMAP queue A, A16)")
    return transfer_matching(network, reference_flagship_state_dict_to_port(state_dict),
                             verbose)
