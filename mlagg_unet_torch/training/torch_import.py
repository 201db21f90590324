"""Reference-checkpoint import for the flagship and the ported zoo.

Copied from ``mlagg_unet_tpu/training/torch_import.py``: the reference's key
rules of ``MLLA_Uper`` (``REFERENCE_FLAGSHIP_RULES``, the ConvTranspose
keys), U-Mamba Bot / Enc (also SS3D, whose A_logs / Ds merge 12 scan
paths), VM-UNet, Mamba-UNet, Swin-UMamba(-D), VM-UNet-3D, MSVM-UNet,
SegMamba, LightM-UNet, UltraLight VM-UNet, nnMamba, MedNeXt, LKM-UNet,
MLLA-UNet, TransUNet and SwinUNETR (``:109-258``, ``:259-350``, ``:397-493``,
``:559-604``), the converter to the JAX package's flat layout and
``CONVERTERS_BY_NETWORK`` (``:661-688``): every converter of the JAX package
(Swin-TUNet has none). nnMamba's shared Mamba layer sits under both of its blocks
in a reference state_dict (the same tensors); both keys map to its one
``mamba{k}`` scope. Composed with ``weights.jax_params_to_state_dict`` (and the
BatchNorm running statistics renamed to the port's buffers) they take a
reference ``fold_X/checkpoint_final.pth``'s ``network_weights`` to a
state_dict the port's network loads with ``strict=True``
(``reference_state_dict_to_port``),
and ``load_pretrained_torch_weights`` transfers a reference checkpoint's
weights for fine-tuning (the train verb's ``-pretrained_weights``).
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


# Swin-UMamba checkpoints (variants/mamba/nnUNetTrainerSwinUMambaScratch.py
# :556-734 and nnUNetTrainerSwinUMambaDScratch.py:728-744)
_SWIN_UMAMBA_SHARED = [
    (r"^(decoder\.)?vssm_encoder\.patch_embed\.proj\.",
     "vssm_encoder.patch_embed_proj."),
    (r"^(decoder\.)?vssm_encoder\.patch_embed\.norm\.",
     "vssm_encoder.patch_embed_norm."),
    (r"^vssm_encoder\.layers\.(\d+)\.blocks\.(\d+)\.",
     r"vssm_encoder.layer\1.block\2."),
    (r"^vssm_encoder\.downsamples\.(\d+)\.", r"vssm_encoder.downsample\1."),
]

REFERENCE_SWIN_UMAMBA_RULES = _SWIN_UMAMBA_SHARED + [
    (r"^stem\.0\.", "stem_conv."),
    (r"^stem\.1\.", "stem_norm.GroupNorm_0."),
    (r"^out_layers\.(\d+)\.conv\.conv\.", r"out\1.conv."),
    (r"\.transp_conv\.conv\.", ".transp_conv."),
    (r"\.(conv1|conv2|conv3)\.conv\.", r".\1."),
    (r"\.(norm1|norm2|norm3)\.", r".\1.GroupNorm_0."),
]

REFERENCE_SWIN_UMAMBA_D_RULES = _SWIN_UMAMBA_SHARED + [
    (r"^decoder\.expand_layers\.(\d+)\.", r"expand\1."),
    (r"^decoder\.stages\.(\d+)\.blocks\.(\d+)\.", r"stage\1.block\2."),
    (r"^decoder\.concat_back_dim\.(\d+)\.", r"concat_back_dim\1."),
    (r"^decoder\.seg_layers\.(\d+)\.", r"seg\1."),
]


# U-Mamba checkpoints (variants/mamba/UMambaBot_2d.py:367-441 /
# UMambaEnc_2d.py:421-489 and their _3d twins)
REFERENCE_UMAMBA_RULES = [
    (r"^decoder\.encoder\.", None),        # duplicate module registration
    # SS3D variants: VSS blocks at the bottleneck / per stage
    # (UMambaBot_SS3D.py:806-821, UMambaEnc_SS3D.py:645-660)
    (r"^mamba_layer\.blocks\.(\d+)\.", r"bot_vss\1."),
    (r"^encoder\.mamba_layers\.(\d+)\.blocks\.0\.", r"enc_vss\1."),
    (r"\.mlp\.dwconv\.dwconv\.", ".mlp.dwconv."),
    # protect the VSS blocks' LayerNorms from the BasicResBlock
    # InstanceNorm rewrite below (marker stripped by the last rule)
    (r"^((?:bot|enc)_vss\d+)\.norm", r"\1.@ln@norm"),
    (r"^encoder\.stem\.(\d+)\.", r"stem_block\1."),
    (r"^encoder\.stages\.(\d+)\.(\d+)\.", r"stage\1_block\2."),
    (r"^encoder\.mamba_layers\.(\d+)\.", r"enc_mamba\1."),
    (r"^mamba_layer\.", "bot_mamba."),
    (r"^decoder\.upsample_layers\.(\d+)\.", r"up\1."),
    (r"^decoder\.stages\.(\d+)\.(\d+)\.", r"dec_stage\1_block\2."),
    (r"^decoder\.seg_layers\.(\d+)\.", r"seg\1."),
    (r"\.(conv1|conv2)\.norm\.", r".\1.norm.GroupNorm_0."),   # BasicBlockD
    (r"\.norm([12])\.", r".norm\1.GroupNorm_0."),             # BasicResBlock
    (r"\.dt_proj\.weight$", ".dt_proj_weight"),
    (r"\.dt_proj\.bias$", ".dt_proj_bias"),
    (r"@ln@", ""),
]


# VM-UNet-3D / VSSM_UNETR (nnUNetTrainer_VMUNet3D.py:660-808: 3D VSSM with
# 12-direction SS3D cells + UNETR decoder)
REFERENCE_VMUNET3D_RULES = [
    (r"relative_position_index$", None),     # buffer, recomputed statically
    (r"^vssm\.downsample\.0\.", "vssm.patch_embed."),
    # PatchMerging3D.reduction = Sequential[Permute, Conv3d, Permute, LN]
    (r"^vssm\.downsample\.(\d+)\.reduction\.1\.", r"vssm.merge\1.reduction."),
    (r"^vssm\.downsample\.(\d+)\.reduction\.3\.", r"vssm.merge\1.norm."),
    (r"^vssm\.layers\.(\d+)\.blocks\.(\d+)\.", r"vssm.stage\1_block\2."),
    (r"\.mlp\.dwconv\.dwconv\.", ".mlp.dwconv."),
    (r"^(encoder\d)\.layer\.", r"\1."),
    (r"\.transp_conv\.conv\.", ".transp_conv."),
    (r"\.(conv1|conv2|conv3)\.conv\.", r".\1."),
    (r"^((?:encoder|decoder)\d.*)\.(norm1|norm2|norm3)\.", r"\1.\2.GroupNorm_0."),
    (r"^out\.conv\.conv\.", "out."),
]


# MSVM-UNet (nnUNetTrainer_MSVM_UNet.py:2685-2960: VSSM tiny_0230s encoder +
# LKPE/MSVSS decoder)
REFERENCE_MSVM_RULES = [
    (r"^encoder\.layer0\.0\.", "encoder.patch_embed.conv1."),
    (r"^encoder\.layer0\.2\.", "encoder.patch_embed.norm1."),
    (r"^encoder\.layer1\.0\.", "encoder.patch_embed.conv2."),
    (r"^encoder\.layer1\.2\.", "encoder.patch_embed.norm2."),
    (r"^encoder\.layers\.(\d+)\.blocks\.(\d+)\.", r"encoder.layer\1_block\2."),
    (r"^encoder\.downsamples\.(\d+)\.1\.", r"encoder.downsample\1.conv."),
    (r"^encoder\.downsamples\.(\d+)\.3\.", r"encoder.downsample\1.norm."),
    (r"^decoder\.layers\.(\d+)\.up\.expand\.0\.", r"up\1.up.expand_conv1."),
    (r"^decoder\.layers\.(\d+)\.up\.expand\.1\.", r"up\1.up.bn."),
    (r"^decoder\.layers\.(\d+)\.up\.expand\.3\.", r"up\1.up.expand_dwconv."),
    (r"^decoder\.layers\.(\d+)\.up\.norm\.", r"up\1.up.norm."),
    (r"^decoder\.layers\.(\d+)\.concat_layer\.", r"up\1.concat_layer."),
    (r"^decoder\.layers\.(\d+)\.vss_layer\.blocks\.(\d+)\.", r"up\1.block\2."),
    (r"^decoder\.out_layers\.0\.expand\.0\.", "final.expand_conv1."),
    (r"^decoder\.out_layers\.0\.expand\.1\.", "final.bn."),
    (r"^decoder\.out_layers\.0\.expand\.3\.", "final.expand_dwconv."),
    (r"^decoder\.out_layers\.0\.norm\.", "final.norm."),
    (r"^decoder\.out_layers\.0\.out\.", "final.out."),
    (r"\.multiscale_conv\.dw_convs\.(\d+)\.", r".multiscale_conv.dw\1."),
]


# VM-UNet (nnUNetTrainer_VMUNet.py:713-880); SS2D-internal names match the
# cell directly
REFERENCE_VMUNET_RULES = [
    (r"^vmunet\.patch_embed\.proj\.", "patch_embed."),
    (r"^vmunet\.patch_embed\.norm\.", "patch_norm."),
    (r"^vmunet\.layers\.(\d+)\.blocks\.(\d+)\.", r"layer\1_block\2."),
    (r"^vmunet\.layers\.(\d+)\.downsample\.", r"downsample\1."),
    (r"^vmunet\.layers_up\.(\d+)\.blocks\.(\d+)\.", r"uplayer\1_block\2."),
    (r"^vmunet\.layers_up\.(\d+)\.upsample\.", r"up\1."),
    (r"^vmunet\.", ""),                      # final_up / final_conv
]


# Mamba-UNet (nnUNetTrainer_MambaUNet.py:772-915, Swin-UNet-style VSSM)
REFERENCE_MAMBA_UNET_RULES = [
    (r"^patch_embed\.proj\.", "patch_embed."),
    (r"^patch_embed\.norm\.", "patch_norm."),
    (r"^layers\.(\d+)\.blocks\.(\d+)\.", r"layer\1_block\2."),
    (r"^layers\.(\d+)\.downsample\.", r"downsample\1."),
    (r"^layers_up\.0\.", "up0."),
    (r"^layers_up\.(\d+)\.blocks\.(\d+)\.", r"uplayer\1_block\2."),
    (r"^layers_up\.(\d+)\.upsample\.", r"up\1."),
    (r"^concat_back_dim\.(\d+)\.", r"concat_back\1."),
]


# SegMamba (nnUNetTrainer_SegMamba.py:264-416: MambaEncoder 'vit' + monai's
# UnetrBasicBlock / UnetrUpBlock decoder); the tri-orientated branches'
# dt_proj_b / dt_proj_s flatten as the main branch's
REFERENCE_SEGMAMBA_RULES = [
    (r"^vit\.downsample_layers\.0\.0\.", "vit.stem."),
    (r"^vit\.downsample_layers\.(\d+)\.1\.", r"vit.downsample\1."),
    (r"^vit\.gscs\.(\d+)\.", r"vit.gsc\1."),
    (r"^vit\.stages\.(\d+)\.(\d+)\.", r"vit.stage\1_\2."),
    (r"^vit\.mlps\.(\d+)\.", r"vit.mlp\1."),
    (r"\.dt_proj(_b|_s)?\.(weight|bias)$", r".dt_proj\1_\2"),
    (r"^out\.conv\.conv\.", "out."),
    (r"\.transp_conv\.conv\.", ".transp_conv."),
    (r"\.(conv1|conv2|conv3)\.conv\.", r".\1."),
    (r"\.(norm1|norm2|norm3)\.", r".\1.GroupNorm_0."),
]


# LightM-UNet (nnUNetTrainer_LightMUNet.py:292-417, MONAI SegResNet skeleton)
REFERENCE_LIGHTM_RULES = [
    (r"^convInit\.0\.conv\.", "convInit.dw."),
    (r"^convInit\.1\.conv\.", "convInit.pw."),
    (r"^down_layers\.(\d+)\.0\.0\.", r"down\1_mamba."),
    (r"^down_layers\.(\d+)\.(\d+)\.", lambda m: (
        f"down{m.group(1)}_block{int(m.group(2)) - 1}.")),
    (r"^up_samples\.(\d+)\.0\.conv\.", r"up\1_conv."),
    (r"^up_layers\.(\d+)\.(\d+)\.", r"up\1_block\2."),
    (r"^conv_final\.0\.", "final_norm.GroupNorm_0."),
    (r"^conv_final\.2\.0\.conv\.", "conv_final.dw."),
    (r"^conv_final\.2\.1\.conv\.", "conv_final.pw."),
    (r"\.conv\.0\.conv\.", ".conv.dw."),        # ResUpBlock dwconv
    (r"\.conv\.1\.conv\.", ".conv.pw."),
    (r"\.(norm1|norm2)\.", r".\1.GroupNorm_0."),
    (r"\.dt_proj\.(weight|bias)$", r".dt_proj_\1"),
]


# UltraLight VM-UNet (nnUNetTrainer_UltraLightVMUNet.py:209-326)
REFERENCE_ULTRALIGHT_RULES = [
    (r"^(encoder|decoder)(\d+)\.0\.", r"\1\2."),
    (r"^scab\.catt\.get_all_att\.", "scab.get_all_att."),
    (r"^scab\.catt\.att(\d+)\.", r"scab.att\1."),
    (r"^scab\.satt\.shared_conv2d\.0\.", "scab.satt_conv."),
    (r"\.dt_proj\.(weight|bias)$", r".dt_proj_\1"),
]


# nnMamba (nnUNetTrainer_nnMamba.py:237-296); the layer-shared MambaLayer
# appears under both owning blocks (the same tensors), both mapped to the
# one mamba{k} scope; BatchNorm's running statistics come out as
# .../running_mean|running_var
REFERENCE_NNMAMBA_RULES = [
    (r"^layer(\d+)\.\d+\.mamba_layer\.", r"mamba\1."),
    (r"^layer(\d+)\.(\d+)\.", r"layer\1_block\2."),
    (r"\.downsample\.0\.", ".ds_conv."),
    (r"\.downsample\.1\.", ".ds_bn."),
    (r"^att(\d+)\.layer(\d+)\.", r"att\1_layer\2."),
    (r"\.conv\.0\.", ".conv_a."),
    (r"\.conv\.1\.", ".bn_a."),
    (r"\.conv\.3\.", ".conv_b."),
    (r"\.conv\.4\.", ".bn_b."),
    (r"\.dt_proj\.(weight|bias)$", r".dt_proj_\1"),
]


# MedNeXt (network_architecture/mednextv1/MedNextV1_new.py and
# MedNextV1_new_Mambaskip.py)
REFERENCE_MEDNEXT_RULES = [
    # MSMM skip module (Mambaskip variant)
    (r"^mambaskip\.blocks\.(\d+)\.", r"mambaskip.block\1."),
    (r"\.conv2d\.(\d+)\.", r".conv2d_\1."),
    (r"\.mlps\.(\d+)\.", r".mlp\1."),
    (r"\.conv_branches\.(\d+)\.0\.", r".conv_branch\1."),
    (r"\.conv_branches\.(\d+)\.1\.", r".conv_norm\1.GroupNorm_0."),
    (r"\.dwconv\.dwconv\.", ".DWConv2d_0.Conv_0."),
    (r"\.fc1\.", ".Dense_0."),
    (r"\.fc2\.", ".Dense_1."),
    # MedNeXt trunk
    (r"^(enc_block|dec_block)_(\d+)\.(\d+)\.", r"\1_\2_\3."),
    (r"^bottleneck\.(\d+)\.", r"bottleneck_\1."),
    (r"\.norm\.", ".norm.GroupNorm_0."),
    (r"^out_(\d)\.conv_out\.conv\.", r"out_\1.conv_out."),
]

# LKM-UNet (variants/mamba/nnUNetTrainer_LKM_UNet.py:122-730)
REFERENCE_LKM_RULES = [
    (r"^decoder\.encoder\.", None),        # duplicate module registration
    (r"^encoder\.stem\.convs\.(\d+)\.norm\.",
     r"stem.conv\1.norm.GroupNorm_0."),
    (r"^encoder\.stem\.convs\.(\d+)\.", r"stem.conv\1."),
    (r"^encoder\.stages\.(\d+)\.blocks\.(\d+)\.", r"stage\1.block\2."),
    (r"^encoder\.mamba_layers\.(\d+)\.", r"pixel_mamba\1.bi."),
    (r"^encoder\.w_mamba_layers\.(\d+)\.", r"window_mamba\1.bi."),
    (r"^decoder\.transpconvs\.(\d+)\.", r"transpconv\1."),
    (r"^decoder\.stages\.(\d+)\.blocks\.(\d+)\.", r"dec_stage\1.block\2."),
    (r"^decoder\.seg_layers\.(\d+)\.", r"seg\1."),
    (r"\.skip\.0\.", ".skip.conv."),
    (r"\.skip\.1\.", ".skip.norm.GroupNorm_0."),
    (r"\.(conv1|conv2)\.norm\.", r".\1.norm.GroupNorm_0."),
    (r"\.dt_proj\.weight$", ".dt_proj_weight"),
    (r"\.dt_proj\.bias$", ".dt_proj_bias"),
]


# MLLA-UNet (nnUNetTrainer_MLLA_UNet.py:89-850); the RoPE table is a buffer
REFERENCE_MLLA_UNET_RULES = [
    (r"\.rope\.rotations$", None),
    (r"^layers\.(\d+)\.blocks\.(\d+)\.", r"layer\1_block\2."),
    (r"^layers\.(\d+)\.downsample\.conv\.(\d+)\.", r"down\1.conv_\2."),
    (r"^layers_up\.0\.conv\.1\.", "up0.deconv."),
    (r"^layers_up\.0\.conv\.(\d+)\.", r"up0.conv_\1."),
    (r"^layers_up\.0\.norm\.", "up0.norm."),
    (r"^layers_up\.(\d+)\.blocks\.(\d+)\.", r"layer_up\1_block\2."),
    (r"^layers_up\.(\d+)\.upsample\.conv\.1\.", r"layer_up\1_upsample.deconv."),
    (r"^layers_up\.(\d+)\.upsample\.conv\.(\d+)\.", r"layer_up\1_upsample.conv_\2."),
    (r"^layers_up\.(\d+)\.upsample\.norm\.", r"layer_up\1_upsample.norm."),
    (r"^concat_back_dim\.(\d+)\.", r"concat_back\1."),
    (r"^up\.expand\.", "up_expand."),
    (r"^up\.norm\.", "up_norm."),
    (r"^patch_embed\.conv(\d)\.(\d)\.", r"patch_embed.conv\1_\2."),
    (r"\.cpe1\.", ".cpe1.Conv_0."),
    (r"\.cpe2\.", ".cpe2.Conv_0."),
    (r"\.dwc\.", ".dwc.Conv_0."),
    (r"\.lepe\.", ".lepe.Conv_0."),
    (r"\.fc1\.", ".Dense_0."),
    (r"\.fc2\.", ".Dense_1."),
]

# TransUNet R50-ViT-B/16 (nnUNetTrainerTransUNet.py:211-803)
REFERENCE_TRANSUNET_RULES = [
    (r"^transformer\.embeddings\.hybrid_model\.root\.conv\.", "hybrid_model.root_conv."),
    (r"^transformer\.embeddings\.hybrid_model\.root\.gn\.", "hybrid_model.root_gn."),
    (r"^transformer\.embeddings\.hybrid_model\.body\.block(\d+)\.unit(\d+)\.",
     r"hybrid_model.block\1_unit\2."),
    (r"^transformer\.embeddings\.patch_embeddings\.", "patch_embeddings."),
    (r"^transformer\.embeddings\.position_embeddings$", "position_embeddings"),
    (r"^transformer\.encoder\.layer\.(\d+)\.", r"encoder_block\1."),
    (r"^transformer\.encoder\.encoder_norm\.", "encoder_norm."),
    (r"\.ffn\.fc1\.", ".ffn.Dense_0."),
    (r"\.ffn\.fc2\.", ".ffn.Dense_1."),
    (r"^decoder\.conv_more\.0\.", "conv_more.conv."),
    (r"^decoder\.conv_more\.1\.", "conv_more.bn."),
    (r"^decoder\.blocks\.(\d+)\.conv(\d)\.0\.", r"decoder_block\1.conv\2.conv."),
    (r"^decoder\.blocks\.(\d+)\.conv(\d)\.1\.", r"decoder_block\1.conv\2.bn."),
    (r"^segmentation_head\.0\.", "seg_head."),
]

# SwinUNETR 2-D (nnUNetTrainerSwinUNETR_2d.py:38-46, monai's SwinUNETR); the
# window attention's relative-position index is a buffer
REFERENCE_SWIN_UNETR_RULES = [
    (r"\.relative_position_index$", None),
    (r"^swinViT\.layers(\d)\.0\.", r"swinViT.layers\1."),
    (r"\.blocks\.(\d+)\.", r".blocks\1."),
    (r"\.mlp\.linear1\.", ".mlp.Dense_0."),
    (r"\.mlp\.linear2\.", ".mlp.Dense_1."),
    (r"^swinViT\.patch_embed\.proj\.", "swinViT.patch_embed."),
    # the swin LayerNorms kept from the instance-norm rewrite below
    (r"^(swinViT\..*)\.norm([12])\.", r"\1.@ln@norm\2."),
    (r"\.transp_conv\.conv\.", ".transp_conv."),
    (r"\.(conv1|conv2|conv3)\.conv\.", r".\1."),
    (r"\.(norm1|norm2|norm3)\.", r".\1.GroupNorm_0."),
    (r"^out\.conv\.conv\.", "out."),
    (r"@ln@", ""),
]


def convert_reference_flagship_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch MLLA_Uper state_dict -> {'a/b/c': array} in flax layout."""
    return _convert_reference_state_dict(state_dict,
                                         REFERENCE_FLAGSHIP_RULES)


def convert_reference_mednext_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch MedNeXt (MedNextV1_new) state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_MEDNEXT_RULES)


def convert_reference_lkm_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch LKMUNet state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_LKM_RULES)


def convert_reference_swin_umamba_state_dict(
        state_dict, d_variant: bool = False) -> Dict[str, np.ndarray]:
    """torch SwinUMamba / SwinUMambaD state_dict -> flax layout."""
    rules = (REFERENCE_SWIN_UMAMBA_D_RULES if d_variant
             else REFERENCE_SWIN_UMAMBA_RULES)
    return _convert_reference_state_dict(state_dict, rules)


def convert_reference_umamba_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch UMambaBot/UMambaEnc state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_UMAMBA_RULES)


def convert_reference_vmunet_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch VMUNet state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_VMUNET_RULES)


def convert_reference_mamba_unet_state_dict(state_dict
                                            ) -> Dict[str, np.ndarray]:
    """torch Mamba-UNet VSSM state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict,
                                         REFERENCE_MAMBA_UNET_RULES)


def convert_reference_umamba_ss3d_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch UMambaBot/Enc_SS3D state_dict -> flax layout (the VSS blocks'
    A_logs / Ds merge K = 12 scan paths)."""
    return _convert_reference_state_dict(state_dict, REFERENCE_UMAMBA_RULES, k_dirs=12)


def convert_reference_vmunet3d_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch VSSM_UNETR state_dict -> flax layout (K = 12 scan paths)."""
    return _convert_reference_state_dict(state_dict, REFERENCE_VMUNET3D_RULES, k_dirs=12)


def convert_reference_msvm_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch MSVMUNet state_dict -> flax layout. BatchNorm running statistics
    come out as .../running_mean|running_var."""
    return _convert_reference_state_dict(state_dict, REFERENCE_MSVM_RULES)


def convert_reference_segmamba_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch SegMamba state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_SEGMAMBA_RULES)


def convert_reference_lightm_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch LightMUNet state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_LIGHTM_RULES)


def convert_reference_ultralight_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch UltraLight_VM_UNet state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_ULTRALIGHT_RULES)


def convert_reference_nnmamba_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch nnMambaSeg state_dict -> flax layout. BatchNorm running
    statistics come out as .../running_mean|running_var."""
    return _convert_reference_state_dict(state_dict, REFERENCE_NNMAMBA_RULES)


def convert_reference_mlla_unet_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch MLLA_UNet state_dict -> flax layout. BatchNorm running
    statistics come out as .../running_mean|running_var."""
    return _convert_reference_state_dict(state_dict, REFERENCE_MLLA_UNET_RULES)


def convert_reference_transunet_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch TransUNet (VisionTransformer R50-ViT-B_16) state_dict -> flax
    layout. BatchNorm running statistics come out as
    .../running_mean|running_var."""
    return _convert_reference_state_dict(state_dict, REFERENCE_TRANSUNET_RULES)


def convert_reference_swin_unetr_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """torch (monai) SwinUNETR 2-D state_dict -> flax layout."""
    return _convert_reference_state_dict(state_dict, REFERENCE_SWIN_UNETR_RULES)


def _swin_umamba_d_converter(state_dict):
    return convert_reference_swin_umamba_state_dict(state_dict,
                                                    d_variant=True)


CONVERTERS_BY_NETWORK = {
    "mlla_uper": convert_reference_flagship_state_dict,
    "umamba_bot": convert_reference_umamba_state_dict,
    "umamba_enc": convert_reference_umamba_state_dict,
    "vmunet": convert_reference_vmunet_state_dict,
    "mamba_unet": convert_reference_mamba_unet_state_dict,
    "swin_umamba": convert_reference_swin_umamba_state_dict,
    "swin_umamba_d": _swin_umamba_d_converter,
    "umamba_bot_ss3d": convert_reference_umamba_ss3d_state_dict,
    "umamba_enc_ss3d": convert_reference_umamba_ss3d_state_dict,
    "vmunet3d": convert_reference_vmunet3d_state_dict,
    "vmunet3d_new": convert_reference_vmunet3d_state_dict,
    "vmunet3d_swint": convert_reference_vmunet3d_state_dict,
    "msvm_unet": convert_reference_msvm_state_dict,
    "segmamba": convert_reference_segmamba_state_dict,
    "lightm_unet": convert_reference_lightm_state_dict,
    "ultralight_vmunet": convert_reference_ultralight_state_dict,
    "nnmamba": convert_reference_nnmamba_state_dict,
    "lkm_unet": convert_reference_lkm_state_dict,
    "mednext_b3": convert_reference_mednext_state_dict,
    "mednext_b5": convert_reference_mednext_state_dict,
    "mlla_unet": convert_reference_mlla_unet_state_dict,
    "transunet": convert_reference_transunet_state_dict,
    "swin_unetr": convert_reference_swin_unetr_state_dict,
}


def _converter(network_key: str):
    """The family's converter; a network registered under a name that
    extends the flagship's (``mlla_uper...``) is the flagship's."""
    conv = CONVERTERS_BY_NETWORK.get(
        "mlla_uper" if network_key.startswith("mlla_uper") else network_key)
    if conv is None:
        raise NotImplementedError(
            f"reference checkpoints of network {network_key!r} have no converter (the JAX "
            f"package has none either); convertible: {sorted(CONVERTERS_BY_NETWORK)}")
    return conv


_RUNNING_STATS = _re.compile(r"/running_(mean|var)$")


def reference_state_dict_to_port(network_key: str, state_dict) -> Dict[str, torch.Tensor]:
    """A reference state_dict of the network ``network_key`` (a registry
    network) -> the port's state_dict of that network
    (``load_state_dict(strict=True)``); BatchNorm's running statistics go to
    the port's ``mean`` / ``var`` buffers (flax's ``batch_stats`` leaves)."""
    flat = _converter(network_key)(state_dict)
    return jax_params_to_state_dict({_RUNNING_STATS.sub(r"/\1", k): v for k, v in flat.items()})


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
                                  verbose: bool = False, network_key: str = "mlla_uper"):
    """Name- and shape-matched transfer from a reference checkpoint of the
    network ``network_key`` (converted by its family's key rules) into
    ``network`` in place; returns (n_transferred, n_total). A network with no
    converter raises, and so does a checkpoint none of whose converted keys
    names a parameter of ``network`` (another family's)."""
    from mlagg_unet_torch.training.load_pretrained_weights import transfer_matching

    state_dict = load_torch_checkpoint_state_dict(torch_checkpoint_path)
    converted = reference_state_dict_to_port(network_key, state_dict)
    if not set(converted) & set(network.state_dict()):
        raise NotImplementedError(
            f"{torch_checkpoint_path} is not a reference checkpoint of network "
            f"{network_key!r}: no key of it names a parameter of the network (a checkpoint "
            "of another family)")
    return transfer_matching(network, converted, verbose)
