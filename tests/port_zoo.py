"""The Mamba zoo's networks of both packages at tiny widths, and the checks
the zoo's test files run on each: the forward in fp32 against JAX, bf16
against JAX's bf16, the param tree both ways, and a reference-format
``.pth`` through JAX's converter and the port's.

Each test file of the zoo (``test_torch_port_zoo_*.py``,
``test_torch_port_mamba_zoo.py``) builds its own few networks with
``build_nets`` in a module fixture, so a file's fixture costs only its own
networks' JAX compiles. Weights come from numpy seeds into the JAX param
tree (``test_torch_port_mamba.mamba_params``; BatchNorm's running statistics
drawn beside them), then ``jax_variables_to_state_dict`` ->
``load_state_dict(strict=True)``; inputs from numpy seeds. Every fp32 output
is held within 1e-4 x max|ref| (+1e-5), a bf16 output within twice the
distance bf16 moves JAX's own network.
"""
import copy
import re
from types import SimpleNamespace
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mlagg_unet_tpu.models import lkm_unet as JLK
from mlagg_unet_tpu.models import mamba_variants as JMV
from mlagg_unet_tpu.models import mednext_net as JMN
from mlagg_unet_tpu.models import mlla_unet as JML
from mlagg_unet_tpu.models import more_variants as JMO
from mlagg_unet_tpu.models import msvm_unet as JMS
from mlagg_unet_tpu.models import swin_umamba as JSU
from mlagg_unet_tpu.models import swin_unetr as JSW
from mlagg_unet_tpu.models import transunet as JTU
from mlagg_unet_tpu.models import umamba as JUM
from mlagg_unet_tpu.models import vmamba as JVM
from mlagg_unet_tpu.models import vmunet3d as JV3
from mlagg_unet_tpu.training import torch_import as jti
from mlagg_unet_torch.models import lkm_unet as TLK
from mlagg_unet_torch.models import mamba_variants as TMV
from mlagg_unet_torch.models import mednext_net as TMN
from mlagg_unet_torch.models import mlla_unet as TML
from mlagg_unet_torch.models import more_variants as TMO
from mlagg_unet_torch.models import msvm_unet as TMS
from mlagg_unet_torch.models import swin_umamba as TSU
from mlagg_unet_torch.models import swin_unetr as TSW
from mlagg_unet_torch.models import transunet as TTU
from mlagg_unet_torch.models import umamba as TUM
from mlagg_unet_torch.models import vmamba as TVM
from mlagg_unet_torch.models import vmunet3d as TV3
from mlagg_unet_torch.training import torch_import as tti
from mlagg_unet_torch.weights import (
    jax_params_to_state_dict,
    jax_variables_to_state_dict,
    state_dict_to_jax_params,
)
from port_helpers import assert_close, flat_params
from test_torch_port_mamba import mamba_params

T = torch.from_numpy

# tiny plans: 2-D puts stage 3 (4x4 = 16 <= 16 channels) in channel-token
# mode, 3-D stages 2 (2x4x4 = 32 <= 32) and 3 (1x2x2 = 4 <= 32); Enc 2-D has
# Mamba layers after stages 1 and 3, Enc 3-D after every stage (stage 0:
# 2048 tokens). At 3-D widths 4-16 this network is ill-conditioned: JAX's own
# output moves by up to 3.4e-4 x max under a 1e-7 relative change of the
# input, so the 3-D plan runs at widths 8-32 (2e-5 to 3e-5 there).
CM_2D = SimpleNamespace(
    patch_size=[32, 32], pool_op_kernel_sizes=[[1, 1], [2, 2], [2, 2], [2, 2]],
    conv_kernel_sizes=[[3, 3]] * 4, UNet_base_num_features=4, unet_max_num_features=16,
    n_conv_per_stage_encoder=[2, 2, 2, 2], n_conv_per_stage_decoder=[2, 2, 2])
CM_3D = SimpleNamespace(
    patch_size=[8, 16, 16], pool_op_kernel_sizes=[[1, 1, 1], [2, 2, 2], [2, 2, 2], [2, 2, 2]],
    conv_kernel_sizes=[[1, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]], UNet_base_num_features=8,
    unet_max_num_features=32, n_conv_per_stage_encoder=[2, 2, 2, 2],
    n_conv_per_stage_decoder=[2, 2, 2])
DIMS = (8, 16, 32, 64)
# VM-UNet's last LayerNorm normalises dims[0] / 4 channels: at dims[0] = 8
# two, and JAX's own output then moves by 3.8e-3 x max under a 1e-7
# relative change of the input; at 16 (four channels) by under 1e-5
VMUNET_DIMS = (16, 32, 64, 128)
# Enc 3-D runs four Mamba layers and norms over a few voxels in fp32: JAX's
# own fp32 output is 1.9e-4 x max from its fp64 one there, the port's 3.8e-5;
# its reference is JAX in fp64
FP64_REFERENCE = ("umamba_enc_3d",)
# VM-UNet-3D: the 2-4-4 patch, then 2-2-2, 2-2-2, 1-2-2: a 8x32x32 input
# ends at 1x1x1; the SwinT variant takes 16x64x64 so that its last stage is
# 2x2x2 and the (5, 6, 7) window is clamped to it
VMUNET3D = dict(dims=DIMS)
MSVM = dict(dims=(16, 32, 64, 128), depths=(1, 1, 2, 1), decoder_depths=(1, 1, 1, 1))
# the variants of mamba_variants.py. SegMamba keeps the reference's slices
# (64, 32, 16, 8): a 16x32x32 input scans 4,096, 512, 64 and 8 tokens.
# LightM-UNet at 16 filters (GroupNorm(8) on 2 channels a group), in 2-D
# and 3-D; UltraLight at its published widths; nnMamba at 16 channels on a
# batch of 2 (its BatchNorm statistics over two samples)
SEGMAMBA = dict(depths=(1, 1, 1, 1), feat_size=(8, 16, 16, 32), hidden_size=32)
LIGHTM = dict(init_filters=16)
LIGHTM_3D = dict(init_filters=16, blocks_down=(1, 1, 1, 1))
NNMAMBA = dict(channels=16, strides=((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)))
# LKM-UNet: 3 stages at 40x40 take the p-strided sub-grids at every stage
# (periods 10, 5, 5; windows pooled by 2, 1, 1), 2 stages at 20x28x24 the
# 3-D ones (periods (5, 7, 6) at both stages); the JAX package's own sizes
# (16x16, 8x8x8, test_variant_zoo.py) take the whole-map fallback
LKM_2D = dict(n_stages=3, features_per_stage=(8, 16, 32), kernel_sizes=((3, 3),) * 3,
              strides=((1, 1), (2, 2), (2, 2)), n_conv_per_stage=(1, 1, 1),
              n_conv_per_stage_decoder=(1, 1))
LKM_3D = dict(n_stages=2, features_per_stage=(8, 16), kernel_sizes=((3, 3, 3),) * 2,
              strides=((1, 1, 1), (2, 2, 2)), n_conv_per_stage=(1, 1),
              n_conv_per_stage_decoder=(1,), deep_supervision=False)
LKM_2D_SMALL = dict(LKM_2D, features_per_stage=(4, 8, 16), deep_supervision=False)
LKM_3D_SMALL = dict(LKM_3D, features_per_stage=(4, 8))
# MedNeXt S (create_mednext_v1): 2-D with deep supervision, 2-D with the
# five-scale Mamba skip, 3-D at kernel 5 with deep supervision
# (preset, kernel, deep supervision, spatial dims, Mamba skip)
MEDNEXT = {"mednext_s_2d": ("S", 3, True, 2, False),
           "mednext_s_2d_mambaskip": ("S", 3, False, 2, True),
           "mednext_s_3d": ("S", 5, True, 3, False)}
# the transformer baselines at narrow widths on 64x64. SwinUNETR takes two
# input channels: with one, encoder1's 1x1 projection (one weight a channel)
# is scale-invariant under its InstanceNorm, and its kernel's gradient is
# rounding around 0 like its bias's. The Swins keep the
# window of 7: SwinUNETR's stages at 32, 16, 8 pad to the window and shift,
# at 4 the window is clamped; Swin-TUNet's at 16 and 8 pad and shift.
# TransUNet: units (1, 2, 1) at width 32 (GroupNorm's 32 groups), a 4x4 grid;
# its 64 -> 32 -> 15 max-pool leaves block 1 at 15x15, padded to 16 for the
# skip. MLLA-UNet at embed 16 on four stages (16 to 2)
SWIN_UNETR = dict(feature_size=12, num_heads=(1, 2, 2, 4))
SWIN_TUNET = dict(embed_dim=16, num_heads=(1, 2, 2, 4))
TRANSUNET = dict(hidden_size=32, mlp_dim=64, num_heads=2, num_layers=2, resnet_units=(1, 2, 1),
                 width=32, decoder_channels=(32, 16, 16, 8))
MLLA_UNET = dict(embed_dim=16, depths=(1, 2, 1, 1), depths_decoder=(1, 1, 1, 1),
                 num_heads=(1, 2, 2, 4))


def _mednext(name):
    model_id, k, ds, d, skip = MEDNEXT[name]
    return (JMN.create_mednext_v1(1, 3, model_id, k, ds, d, skip),
            TMN.create_mednext_v1(1, 3, model_id, k, ds, d, skip))


def x_of(shape, seed=0):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _umamba(cm, mode):
    return (JUM.umamba_from_plans(cm, 1, 3, True, mode), TUM.umamba_from_plans(cm, 1, 3, True, mode),
            x_of((2, *cm.patch_size, 1)))


def _vmunet3d(**kw):
    return JV3.VMUNet3D(num_classes=3, **VMUNET3D, **kw), TV3.VMUNet3D(1, 3, **VMUNET3D, **kw)


# name: () -> (JAX module, port module, input, network key of the converter).
# The order fixes each network's seed.
FACTORIES = {
    "umamba_bot_2d": lambda: (*_umamba(CM_2D, "bot"), "umamba_bot"),
    "umamba_enc_2d": lambda: (*_umamba(CM_2D, "enc"), "umamba_enc"),
    "umamba_bot_3d": lambda: (*_umamba(CM_3D, "bot"), "umamba_bot"),
    "umamba_enc_3d": lambda: (*_umamba(CM_3D, "enc"), "umamba_enc"),
    "vmunet": lambda: (JVM.VMUNet(num_classes=3, dims=VMUNET_DIMS),
                       TVM.VMUNet(1, 3, dims=VMUNET_DIMS), x_of((1, 64, 64, 1)), "vmunet"),
    "mamba_unet": lambda: (JVM.MambaUNet(num_classes=3, dims=DIMS), TVM.MambaUNet(1, 3, dims=DIMS),
                           x_of((1, 64, 64, 1)), "mamba_unet"),
    "swin_umamba": lambda: (JSU.SwinUMamba(num_classes=2, feat_size=(4, 8, 16, 32, 64),
                                           hidden_size=64, vssm_depths=(1, 1, 1, 1),
                                           deep_supervision=True),
                            TSU.SwinUMamba(1, 2, feat_size=(4, 8, 16, 32, 64), hidden_size=64,
                                           vssm_depths=(1, 1, 1, 1), deep_supervision=True),
                            x_of((1, 64, 64, 1)), "swin_umamba"),
    "swin_umamba_d": lambda: (JSU.SwinUMambaD(num_classes=2, dims=DIMS, deep_supervision=True),
                              TSU.SwinUMambaD(1, 2, dims=DIMS, deep_supervision=True),
                              x_of((1, 64, 64, 1)), "swin_umamba_d"),
    "umamba_bot_ss3d": lambda: (*_umamba(CM_3D, "bot_ss3d"), "umamba_bot_ss3d"),
    "umamba_enc_ss3d": lambda: (*_umamba(CM_3D, "enc_ss3d"), "umamba_enc_ss3d"),
    "vmunet3d": lambda: (*_vmunet3d(), x_of((1, 8, 32, 32, 1)), "vmunet3d"),
    "vmunet3d_new": lambda: (*_vmunet3d(no_z=True, use_encoder5=False),
                             x_of((1, 8, 32, 32, 1)), "vmunet3d_new"),
    "vmunet3d_swint": lambda: (*_vmunet3d(no_z=True, use_encoder5=False, last_stage_swin=True,
                                          num_heads=2),
                               x_of((1, 16, 64, 64, 1)), "vmunet3d_swint"),
    "msvm_unet": lambda: (JMS.MSVMUNet(num_classes=3, **MSVM), TMS.MSVMUNet(1, 3, **MSVM),
                          x_of((1, 64, 64, 1)), "msvm_unet"),
    "segmamba": lambda: (JMV.SegMamba(num_classes=3, **SEGMAMBA), TMV.SegMamba(1, 3, **SEGMAMBA),
                         x_of((1, 16, 32, 32, 1)), "segmamba"),
    "lightm_unet": lambda: (JMV.LightMUNet(num_classes=3, **LIGHTM),
                            TMV.LightMUNet(1, 3, **LIGHTM), x_of((1, 32, 32, 1)), "lightm_unet"),
    "lightm_unet_3d": lambda: (JMV.LightMUNet(num_classes=3, **LIGHTM_3D),
                               TMV.LightMUNet(1, 3, **LIGHTM_3D, spatial_dims=3),
                               x_of((1, 16, 16, 16, 1)), "lightm_unet"),
    "ultralight_vmunet": lambda: (JMV.UltraLightVMUNet(num_classes=3),
                                  TMV.UltraLightVMUNet(1, 3), x_of((1, 64, 64, 1)),
                                  "ultralight_vmunet"),
    "nnmamba": lambda: (JMV.NNMamba(num_classes=3, **NNMAMBA), TMV.NNMamba(1, 3, **NNMAMBA),
                        x_of((2, 8, 16, 16, 1)), "nnmamba"),
    "lkm_unet_2d": lambda: (JLK.LKMUNet(num_classes=3, **LKM_2D), TLK.LKMUNet(1, 3, **LKM_2D),
                            x_of((1, 40, 40, 1)), "lkm_unet"),
    "lkm_unet_3d": lambda: (JLK.LKMUNet(num_classes=3, **LKM_3D), TLK.LKMUNet(1, 3, **LKM_3D),
                            x_of((1, 20, 28, 24, 1)), "lkm_unet"),
    "lkm_unet_2d_small": lambda: (JLK.LKMUNet(num_classes=2, **LKM_2D_SMALL),
                                  TLK.LKMUNet(1, 2, **LKM_2D_SMALL), x_of((1, 16, 16, 1)),
                                  "lkm_unet"),
    "lkm_unet_3d_small": lambda: (JLK.LKMUNet(num_classes=2, **LKM_3D_SMALL),
                                  TLK.LKMUNet(1, 2, **LKM_3D_SMALL), x_of((1, 8, 8, 8, 1)),
                                  "lkm_unet"),
    "mednext_s_2d": lambda: (*_mednext("mednext_s_2d"), x_of((1, 32, 32, 1)), "mednext_b3"),
    "mednext_s_2d_mambaskip": lambda: (*_mednext("mednext_s_2d_mambaskip"),
                                       x_of((1, 32, 32, 1)), None),
    "mednext_s_3d": lambda: (*_mednext("mednext_s_3d"), x_of((1, 16, 32, 32, 1)), "mednext_b5"),
    "swin_unetr": lambda: (JSW.SwinUNETR(num_classes=3, **SWIN_UNETR),
                           TSW.SwinUNETR(2, 3, **SWIN_UNETR), x_of((1, 64, 64, 2)), "swin_unetr"),
    "swin_tunet": lambda: (JMO.SwinTUNet(num_classes=3, **SWIN_TUNET),
                           TMO.SwinTUNet(1, 3, **SWIN_TUNET), x_of((1, 64, 64, 1)), None),
    "transunet": lambda: (JTU.TransUNet(num_classes=3, **TRANSUNET),
                          TTU.TransUNet(1, 3, img_size=(64, 64), **TRANSUNET),
                          x_of((1, 64, 64, 1)), "transunet"),
    "mlla_unet": lambda: (JML.MLLAUNet(num_classes=3, **MLLA_UNET), TML.MLLAUNet(1, 3, **MLLA_UNET),
                          x_of((1, 64, 64, 1)), "mlla_unet"),
}
ORDER = list(FACTORIES)


def outputs(o):
    return list(o) if isinstance(o, (list, tuple)) else [o]


def _batch_stats(jm, x, seed):
    """The module's ``batch_stats`` (BatchNorm's running mean and variance),
    drawn from numpy near flax's init; {} for a network without them."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    if "batch_stats" not in shapes:
        return {}
    rs = np.random.RandomState(seed + 2000)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(np.asarray(
            0.1 * rs.randn(*leaf.shape) if path[-1].key == "mean"
            else 1 + 0.2 * rs.rand(*leaf.shape), np.float32)), shapes["batch_stats"])


def build_nets(names):
    """Each named network of both packages with one seeded variable tree,
    JAX's output on the seeded input (jitted), and the port's network
    holding the same weights."""
    out = {}
    for name in names:
        jm, tm, x, key = FACTORIES[name]()
        seed = ORDER.index(name)
        params = mamba_params(jm, x, seed=seed)
        variables = {"params": params}
        stats = _batch_stats(jm, x, seed)
        if stats:
            variables["batch_stats"] = stats
        apply = jax.jit(jm.apply)
        if name in FP64_REFERENCE:
            with jax.enable_x64():
                f64 = lambda t: jnp.asarray(np.asarray(t), jnp.float64)  # noqa: E731
                ref = [np.asarray(r, np.float32) for r in outputs(jax.jit(jm.apply)(
                    jax.tree_util.tree_map(f64, variables), f64(x)))]
        else:
            ref = apply(variables, x)
        numpy_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        tm.load_state_dict(jax_variables_to_state_dict(
            numpy_tree(params), {"batch_stats": numpy_tree(stats)} if stats else None),
            strict=True)
        out[name] = dict(jm=jm, apply=apply, tm=tm.eval(), x=x, key=key, params=params,
                         stats=stats, variables=variables, ref=ref)
    return out


def check_forward(n):
    """Every output (each deep-supervision scale) of the port's network
    equals JAX's within 1e-4."""
    with torch.no_grad():
        got = outputs(n["tm"](T(np.array(n["x"]))))
    ref = outputs(n["ref"])
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        assert_close(g, np.asarray(r))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_bf16(n):
    """In bf16 (the variables and the input cast, as both predictors do) the
    port computes JAX's function: every output answers in JAX's dtype, the
    port's bf16 output sits from its fp32 output within twice the distance
    JAX's sits from JAX's fp32 output, and from JAX's bf16 output within
    twice that distance too."""
    v16 = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), n["variables"])
    j16 = outputs(n["apply"](v16, n["x"].astype(jnp.bfloat16)))
    j32 = outputs(n["apply"](n["variables"], n["x"]))
    x = T(np.array(n["x"]))
    with torch.no_grad():
        t32 = outputs(n["tm"](x))
        t16 = outputs(copy.deepcopy(n["tm"]).to(torch.bfloat16)(x.to(torch.bfloat16)))
    assert len(t16) == len(j16)
    for a, b in zip(t16, j16):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
    gap = rel_l2(np.asarray(j16[0], np.float32), np.asarray(j32[0]))
    assert 0 < rel_l2(t16[0].float(), t32[0]) <= 2 * gap
    assert rel_l2(t16[0].float(), np.asarray(j16[0], np.float32)) <= 2 * gap


def check_tree(n):
    """JAX tree -> state_dict -> JAX tree, exactly, for every parameter."""
    flat = flat_params(n["params"])
    back = state_dict_to_jax_params(jax_params_to_state_dict(flat), flat)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# --------------------------------------------------------------- reference .pth
_SWIN_SHARED = [
    (r"^vssm_encoder\.patch_embed_proj\.", "vssm_encoder.patch_embed.proj."),
    (r"^vssm_encoder\.patch_embed_norm\.", "vssm_encoder.patch_embed.norm."),
    (r"^vssm_encoder\.layer(\d+)\.block(\d+)\.", r"vssm_encoder.layers.\1.blocks.\2."),
    (r"^vssm_encoder\.downsample(\d+)\.", r"vssm_encoder.downsamples.\1."),
]
_UMAMBA = [
    (r"^stem_block(\d+)\.", r"encoder.stem.\1."),
    (r"^stage(\d+)_block(\d+)\.", r"encoder.stages.\1.\2."),
    (r"^enc_mamba(\d+)\.", r"encoder.mamba_layers.\1."),
    (r"^bot_mamba\.", "mamba_layer."),
    (r"^up(\d+)\.", r"decoder.upsample_layers.\1."),
    (r"^dec_stage(\d+)_block(\d+)\.", r"decoder.stages.\1.\2."),
    (r"^seg(\d+)\.", r"decoder.seg_layers.\1."),
    (r"\.GroupNorm_0\.", "."),
]
_VMUNET3D = [
    (r"^vssm\.patch_embed\.", "vssm.downsample.0."),
    (r"^vssm\.merge(\d+)\.reduction\.", r"vssm.downsample.\1.reduction.1."),
    (r"^vssm\.merge(\d+)\.norm\.", r"vssm.downsample.\1.reduction.3."),
    (r"^vssm\.stage(\d+)_block(\d+)\.", r"vssm.layers.\1.blocks.\2."),
    (r"\.mlp\.dwconv\.", ".mlp.dwconv.dwconv."),
    (r"^(encoder\d)\.", r"\1.layer."),
    (r"\.transp_conv\.", ".transp_conv.conv."),
    (r"\.(conv1|conv2|conv3)\.", r".\1.conv."),
    (r"\.GroupNorm_0\.", "."),
    (r"^out\.", "out.conv.conv."),
]
_MSVM = [
    (r"^encoder\.patch_embed\.conv1\.", "encoder.layer0.0."),
    (r"^encoder\.patch_embed\.norm1\.", "encoder.layer0.2."),
    (r"^encoder\.patch_embed\.conv2\.", "encoder.layer1.0."),
    (r"^encoder\.patch_embed\.norm2\.", "encoder.layer1.2."),
    (r"^encoder\.layer(\d+)_block(\d+)\.", r"encoder.layers.\1.blocks.\2."),
    (r"^encoder\.downsample(\d+)\.conv\.", r"encoder.downsamples.\1.1."),
    (r"^encoder\.downsample(\d+)\.norm\.", r"encoder.downsamples.\1.3."),
    (r"^up(\d+)\.up\.expand_conv1\.", r"decoder.layers.\1.up.expand.0."),
    (r"^up(\d+)\.up\.bn\.", r"decoder.layers.\1.up.expand.1."),
    (r"^up(\d+)\.up\.expand_dwconv\.", r"decoder.layers.\1.up.expand.3."),
    (r"^up(\d+)\.up\.norm\.", r"decoder.layers.\1.up.norm."),
    (r"^up(\d+)\.concat_layer\.", r"decoder.layers.\1.concat_layer."),
    (r"^up(\d+)\.block(\d+)\.", r"decoder.layers.\1.vss_layer.blocks.\2."),
    (r"^final\.expand_conv1\.", "decoder.out_layers.0.expand.0."),
    (r"^final\.bn\.", "decoder.out_layers.0.expand.1."),
    (r"^final\.expand_dwconv\.", "decoder.out_layers.0.expand.3."),
    (r"^final\.norm\.", "decoder.out_layers.0.norm."),
    (r"^final\.out\.", "decoder.out_layers.0.out."),
    (r"\.multiscale_conv\.dw(\d+)\.", r".multiscale_conv.dw_convs.\1."),
]
# the port's (flax's) names -> the reference's, the inverse of each family's
# REFERENCE_*_RULES
TO_REFERENCE = {
    "umamba_bot": _UMAMBA,
    "umamba_enc": _UMAMBA,
    "umamba_bot_ss3d": [(r"^bot_vss(\d+)\.", r"mamba_layer.blocks.\1."),
                        (r"^enc_vss(\d+)\.", r"encoder.mamba_layers.\1.blocks.0."),
                        (r"\.mlp\.dwconv\.", ".mlp.dwconv.dwconv.")] + _UMAMBA,
    "vmunet": [
        (r"^patch_embed\.", "vmunet.patch_embed.proj."),
        (r"^patch_norm\.", "vmunet.patch_embed.norm."),
        (r"^layer(\d+)_block(\d+)\.", r"vmunet.layers.\1.blocks.\2."),
        (r"^downsample(\d+)\.", r"vmunet.layers.\1.downsample."),
        (r"^uplayer(\d+)_block(\d+)\.", r"vmunet.layers_up.\1.blocks.\2."),
        (r"^up(\d+)\.", r"vmunet.layers_up.\1.upsample."),
        (r"^(final_up|final_conv)\.", r"vmunet.\1."),
    ],
    "mamba_unet": [
        (r"^patch_embed\.", "patch_embed.proj."),
        (r"^patch_norm\.", "patch_embed.norm."),
        (r"^layer(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
        (r"^downsample(\d+)\.", r"layers.\1.downsample."),
        (r"^up0\.", "layers_up.0."),
        (r"^uplayer(\d+)_block(\d+)\.", r"layers_up.\1.blocks.\2."),
        (r"^up(\d+)\.", r"layers_up.\1.upsample."),
        (r"^concat_back(\d+)\.", r"concat_back_dim.\1."),
    ],
    "swin_umamba": _SWIN_SHARED + [
        (r"^stem_conv\.", "stem.0."),
        (r"^stem_norm\.GroupNorm_0\.", "stem.1."),
        (r"^out(\d+)\.conv\.", r"out_layers.\1.conv.conv."),
        (r"\.transp_conv\.", ".transp_conv.conv."),
        (r"\.(conv1|conv2|conv3)\.", r".\1.conv."),
        (r"\.(norm1|norm2|norm3)\.GroupNorm_0\.", r".\1."),
    ],
    "swin_umamba_d": _SWIN_SHARED + [
        (r"^expand(\d+)\.", r"decoder.expand_layers.\1."),
        (r"^stage(\d+)\.block(\d+)\.", r"decoder.stages.\1.blocks.\2."),
        (r"^concat_back_dim(\d+)\.", r"decoder.concat_back_dim.\1."),
        (r"^seg(\d+)\.", r"decoder.seg_layers.\1."),
    ],
    "vmunet3d": _VMUNET3D,
    "msvm_unet": _MSVM,
}
TO_REFERENCE.update({
    "segmamba": [
        (r"^vit\.stem\.", "vit.downsample_layers.0.0."),
        (r"^vit\.downsample(\d+)\.", r"vit.downsample_layers.\1.1."),
        (r"^vit\.gsc(\d+)\.", r"vit.gscs.\1."),
        (r"^vit\.stage(\d+)_(\d+)\.", r"vit.stages.\1.\2."),
        (r"^vit\.mlp(\d+)\.", r"vit.mlps.\1."),
        (r"^out\.", "out.conv.conv."),
        (r"\.transp_conv\.", ".transp_conv.conv."),
        (r"\.(conv1|conv2|conv3)\.", r".\1.conv."),
        (r"\.(norm1|norm2|norm3)\.GroupNorm_0\.", r".\1."),
    ],
    "lightm_unet": [
        (r"^convInit\.dw\.", "convInit.0.conv."),
        (r"^convInit\.pw\.", "convInit.1.conv."),
        (r"^down(\d+)_mamba\.", r"down_layers.\1.0.0."),
        (r"^down(\d+)_block(\d+)\.",
         lambda m: f"down_layers.{m.group(1)}.{int(m.group(2)) + 1}."),
        (r"^up(\d+)_conv\.", r"up_samples.\1.0.conv."),
        (r"^up(\d+)_block(\d+)\.", r"up_layers.\1.\2."),
        (r"^final_norm\.GroupNorm_0\.", "conv_final.0."),
        (r"^conv_final\.dw\.", "conv_final.2.0.conv."),
        (r"^conv_final\.pw\.", "conv_final.2.1.conv."),
        (r"\.conv\.dw\.", ".conv.0.conv."),
        (r"\.conv\.pw\.", ".conv.1.conv."),
        (r"\.(norm1|norm2)\.GroupNorm_0\.", r".\1."),
    ],
    "ultralight_vmunet": [
        (r"^(encoder|decoder)(\d+)\.", r"\1\2.0."),
        (r"^scab\.get_all_att\.", "scab.catt.get_all_att."),
        (r"^scab\.att(\d+)\.", r"scab.catt.att\1."),
        (r"^scab\.satt_conv\.", "scab.satt.shared_conv2d.0."),
    ],
    # the shared Mamba layer under its first user; ``reference_state_dict``
    # writes it under the second one too, as the reference's state_dict does
    "nnmamba": [
        (r"^mamba(\d+)\.", r"layer\1.1.mamba_layer."),
        (r"^layer(\d+)_block(\d+)\.", r"layer\1.\2."),
        (r"\.ds_conv\.", ".downsample.0."),
        (r"\.ds_bn\.", ".downsample.1."),
        (r"^att(\d+)_layer(\d+)\.", r"att\1.layer\2."),
        (r"\.conv_a\.", ".conv.0."),
        (r"\.bn_a\.", ".conv.1."),
        (r"\.conv_b\.", ".conv.3."),
        (r"\.bn_b\.", ".conv.4."),
    ],
    "lkm_unet": [
        (r"^stem\.conv(\d+)\.norm\.GroupNorm_0\.", r"encoder.stem.convs.\1.norm."),
        (r"^stem\.conv(\d+)\.", r"encoder.stem.convs.\1."),
        (r"^stage(\d+)\.block(\d+)\.", r"encoder.stages.\1.blocks.\2."),
        (r"^pixel_mamba(\d+)\.bi\.", r"encoder.mamba_layers.\1."),
        (r"^window_mamba(\d+)\.bi\.", r"encoder.w_mamba_layers.\1."),
        (r"^transpconv(\d+)\.", r"decoder.transpconvs.\1."),
        (r"^dec_stage(\d+)\.block(\d+)\.", r"decoder.stages.\1.blocks.\2."),
        (r"^seg(\d+)\.", r"decoder.seg_layers.\1."),
        (r"\.skip\.conv\.", ".skip.0."),
        (r"\.skip\.norm\.GroupNorm_0\.", ".skip.1."),
        (r"\.(conv1|conv2)\.norm\.GroupNorm_0\.", r".\1.norm."),
    ],
    "mednext_b3": [
        (r"^mambaskip\.block(\d+)\.", r"mambaskip.blocks.\1."),
        (r"\.conv2d_(\d+)\.", r".conv2d.\1."),
        (r"\.mlp(\d+)\.", r".mlps.\1."),
        (r"\.conv_branch(\d+)\.", r".conv_branches.\1.0."),
        (r"\.conv_norm(\d+)\.GroupNorm_0\.", r".conv_branches.\1.1."),
        (r"\.DWConv2d_0\.Conv_0\.", ".dwconv.dwconv."),
        (r"\.Dense_0\.", ".fc1."),
        (r"\.Dense_1\.", ".fc2."),
        (r"^(enc_block|dec_block)_(\d+)_(\d+)\.", r"\1_\2.\3."),
        (r"^bottleneck_(\d+)\.", r"bottleneck.\1."),
        (r"\.norm\.GroupNorm_0\.", ".norm."),
    ],
    "mlla_unet": [
        (r"^layer(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
        (r"^down(\d+)\.conv_(\d+)\.", r"layers.\1.downsample.conv.\2."),
        (r"^up0\.deconv\.", "layers_up.0.conv.1."),
        (r"^up0\.conv_(\d+)\.", r"layers_up.0.conv.\1."),
        (r"^up0\.norm\.", "layers_up.0.norm."),
        (r"^layer_up(\d+)_block(\d+)\.", r"layers_up.\1.blocks.\2."),
        (r"^layer_up(\d+)_upsample\.deconv\.", r"layers_up.\1.upsample.conv.1."),
        (r"^layer_up(\d+)_upsample\.conv_(\d+)\.", r"layers_up.\1.upsample.conv.\2."),
        (r"^layer_up(\d+)_upsample\.norm\.", r"layers_up.\1.upsample.norm."),
        (r"^concat_back(\d+)\.", r"concat_back_dim.\1."),
        (r"^up_expand\.", "up.expand."),
        (r"^up_norm\.", "up.norm."),
        (r"^patch_embed\.conv(\d)_(\d)\.", r"patch_embed.conv\1.\2."),
        (r"\.(cpe1|cpe2|dwc|lepe)\.Conv_0\.", r".\1."),
        (r"\.Dense_0\.", ".fc1."),
        (r"\.Dense_1\.", ".fc2."),
    ],
    "transunet": [
        (r"^\.$", "transformer.embeddings."),   # the position embedding, a top-level leaf
        (r"^hybrid_model\.root_conv\.", "transformer.embeddings.hybrid_model.root.conv."),
        (r"^hybrid_model\.root_gn\.", "transformer.embeddings.hybrid_model.root.gn."),
        (r"^hybrid_model\.block(\d+)_unit(\d+)\.",
         r"transformer.embeddings.hybrid_model.body.block\1.unit\2."),
        (r"^patch_embeddings\.", "transformer.embeddings.patch_embeddings."),
        (r"^encoder_block(\d+)\.", r"transformer.encoder.layer.\1."),
        (r"^encoder_norm\.", "transformer.encoder.encoder_norm."),
        (r"\.ffn\.Dense_0\.", ".ffn.fc1."),
        (r"\.ffn\.Dense_1\.", ".ffn.fc2."),
        (r"^conv_more\.conv\.", "decoder.conv_more.0."),
        (r"^conv_more\.bn\.", "decoder.conv_more.1."),
        (r"^decoder_block(\d+)\.conv(\d)\.conv\.", r"decoder.blocks.\1.conv\2.0."),
        (r"^decoder_block(\d+)\.conv(\d)\.bn\.", r"decoder.blocks.\1.conv\2.1."),
        (r"^seg_head\.", "segmentation_head.0."),
    ],
    "swin_unetr": [
        (r"^swinViT\.layers(\d)\.", r"swinViT.layers\1.0."),
        (r"\.blocks(\d+)\.", r".blocks.\1."),
        (r"\.mlp\.Dense_0\.", ".mlp.linear1."),
        (r"\.mlp\.Dense_1\.", ".mlp.linear2."),
        (r"^swinViT\.patch_embed\.", "swinViT.patch_embed.proj."),
        (r"\.transp_conv\.", ".transp_conv.conv."),
        (r"\.(conv1|conv2|conv3)\.", r".\1.conv."),
        (r"\.(norm1|norm2|norm3)\.GroupNorm_0\.", r".\1."),
        (r"^out\.", "out.conv.conv."),
    ],
})
TO_REFERENCE["mednext_b5"] = TO_REFERENCE["mednext_b3"]
TO_REFERENCE["umamba_enc_ss3d"] = TO_REFERENCE["umamba_bot_ss3d"]
TO_REFERENCE["vmunet3d_new"] = TO_REFERENCE["vmunet3d_swint"] = _VMUNET3D
# the reference's ConvTranspose layout (in, out / groups, *k): the zoo's
# transposed convs, LKM-UNet's, MedNeXt's up blocks and its heads (a
# ConvTranspose of kernel 1 in the reference). A depthwise one (one input
# channel a group, JAX (*k, 1, C)) is (C, 1, *k), the forward conv's order
_REF_TRANSPOSED = re.compile(
    r"(transp_conv(\.conv)?|transpconvs\.\d+|up_\d+\.(conv1|res_conv)|out_\d+\.conv_out)\.weight$")


def reference_state_dict(flat, key, stats=None):
    """A reference-named, reference-layout torch state_dict of flax params
    (and of flax's ``batch_stats``, as torch's running statistics), with the
    reference's buffers the converters drop (the window attention's
    relative-position index, BatchNorm's ``num_batches_tracked``)."""
    sd = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        prefix = ".".join(path) + "."
        for pat, rep in TO_REFERENCE[key]:
            prefix = re.sub(pat, rep, prefix)
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim >= 3:
                transposed = (_REF_TRANSPOSED.search(prefix + leaf) and arr.shape[-1] != 1
                              and arr.shape[-2] != 1)
                arr = np.moveaxis(arr, (-2, -1), (0, 1)) if transposed else \
                    np.moveaxis(arr, (-1, -2), (0, 1))
            else:
                arr = arr.T
        elif leaf == "scale":
            leaf = "weight"
        elif leaf == "A_logs":
            arr = arr.reshape(-1, arr.shape[-1])
        elif leaf == "Ds":
            arr = arr.reshape(-1)
        elif re.fullmatch(r"A(_b|_s)?_log", leaf):
            arr = arr[0]
        elif re.fullmatch(r"dt_proj(_b|_s)?_(weight|bias)", leaf):
            leaf = re.sub(r"_(weight|bias)$", r".\1", leaf)
        elif leaf == "relative_position_bias_table":
            sd[prefix + "relative_position_index"] = torch.zeros(8, 8, dtype=torch.long)
        elif key == "mlla_unet" and prefix.endswith(".attn.qk."):   # the RoPE buffer
            sd[prefix[:-len("qk.")] + "rope.rotations"] = torch.zeros(4, 4, 8, 2)
        sd[prefix + leaf] = torch.from_numpy(np.array(arr))
    for name, arr in (stats or {}).items():
        *path, leaf = name.split("/")
        prefix = ".".join(path) + "."
        for pat, rep in TO_REFERENCE[key]:
            prefix = re.sub(pat, rep, prefix)
        sd[prefix + "running_" + leaf] = torch.from_numpy(np.array(arr))
        sd[prefix + "num_batches_tracked"] = torch.tensor(7)
    if key == "nnmamba":   # the shared layer again under its second block
        sd.update({re.sub(r"^layer(\d+)\.1\.mamba_layer\.", r"layer\1.2.mamba_layer.", k): v
                   for k, v in sd.items() if ".1.mamba_layer." in k})
    return sd


def check_pth(n):
    """A reference-format state_dict of the same weights maps back through
    JAX's converter exactly; the port's converter (``CONVERTERS_BY_NETWORK``
    composed with ``jax_params_to_state_dict``) loads it strict, BatchNorm's
    running statistics included, and the network then matches JAX's
    forward."""
    flat = flat_params(n["params"])
    stats = flat_params(n["stats"]) if n["stats"] else {}
    sd = {"module." + k: v for k, v in reference_state_dict(flat, n["key"], stats).items()}
    back = jti.convert_reference_network_state_dict(n["key"], sd)
    want = {**flat, **{k.rsplit("/", 1)[0] + "/running_" + k.rsplit("/", 1)[1]: v
                       for k, v in stats.items()}}
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    tm = copy.deepcopy(n["tm"])
    tm.load_state_dict(tti.reference_state_dict_to_port(n["key"], sd), strict=True)
    with torch.no_grad():
        got = outputs(tm(T(np.array(n["x"]))))
    for g, r in zip(got, outputs(n["ref"])):
        assert_close(g, np.asarray(r))


# conv biases that a norm follows: their gradient is zero in exact arithmetic,
# and both packages' values are rounding noise, held to their conv kernel's
LKM_NORM_FED = r"/conv/bias$"
MEDNEXT_NORM_FED = r"(^(enc_block|dec_block|bottleneck|down|up)_[\d_]+/conv1|/conv_branch\d+)/bias$"
UNETR_NORM_FED = r"/(conv1|conv2|conv3)/bias$"   # the UNETR blocks' convs, each before an IN


def check_grads(n, norm_fed: Optional[str], seed: int = 7, rel: float = 2e-4):
    """The gradients of sum(output * cotangent) over every output, in the
    input and in every parameter, against ``jax.grad``: each within ``rel``
    x its max|ref| + 1e-6 (the scan gradients' fp32 tolerance, PARITY.md),
    a bias matching ``norm_fed`` (a norm follows its conv: its gradient is
    zero but for rounding) within ``rel`` x max|its kernel's gradient|.
    ``norm_fed`` None: the network has no such bias."""
    rs = np.random.RandomState(seed)
    cots = [rs.randn(*np.shape(r)).astype(np.float32) for r in outputs(n["ref"])]
    variables = n["variables"]

    def loss(p, xx):
        outs = outputs(n["jm"].apply({**variables, "params": p}, xx))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(n["params"], n["x"])
    tm = copy.deepcopy(n["tm"])
    tx = T(np.array(n["x"])).requires_grad_(True)
    sum((o * T(c)).sum() for o, c in zip(outputs(tm(tx)), cots)).backward()
    assert_close(tx.grad, np.asarray(gx), rel=rel, atol=1e-6)
    ref = {k: np.asarray(v) for k, v in flat_params(gp).items()}
    got = state_dict_to_jax_params({k: p.grad for k, p in tm.named_parameters()}, ref)
    fed = [k for k in ref if norm_fed and re.search(norm_fed, k)]
    assert fed or norm_fed is None, f"no bias matches {norm_fed}"
    for k in ref:
        if k in fed:
            bound = rel * np.abs(ref[k[:-len("bias")] + "kernel"]).max() + 1e-6
            err = np.abs(got[k] - ref[k]).max()
            assert err <= bound, f"{k}: max |diff| {err:.3e} > {bound:.3e}"
        else:
            assert_close(got[k], ref[k], rel=rel, atol=1e-6)
