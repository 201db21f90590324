"""How far bf16 serving sits from fp32 for the Mamba zoo's networks, in the
JAX package and in the port, on the CPU.

Both packages compute in bf16 as their predictors do: the variables and
the input cast to bf16, the network applied, the output read in fp32. The
networks run at full width on a plan cut for the CPU (U-Mambas: nnU-Net's
2d topology at 160x160, 6 stages, 32-512 features; VM-UNet and MSVM-UNet
at their published widths on 160x160; the SS3D U-Mambas on the 3-D bench
topology, 6 stages, 32-320 features, and VM-UNet-3D at its published
widths, on 16x64x64; SegMamba and nnMamba (its strides from the 3-D plan)
at their published widths on 16x64x64, LightM-UNet and UltraLight VM-UNet
on 160x160; LKM-UNet on the U-Mambas' 2d cut, MedNeXt B k3 with and
without its Mamba skip on 160x160), from one seeded JAX param tree (BatchNorm's running
statistics at flax's init) loaded into the port, on a seeded batch (2 in
2-D, 1 in 3-D). For each network it prints the rel L2 of bf16 against fp32
in each package and of the port's bf16 against JAX's.

    python tests/port_bf16_gap.py [network ...]

Networks: umamba_bot, umamba_enc, vmunet, umamba_bot_ss3d, umamba_enc_ss3d,
vmunet3d, vmunet3d_new, vmunet3d_swint, msvm_unet, segmamba, nnmamba,
lightm_unet, ultralight_vmunet, lkm_unet, mednext_b3, mednext_b3_mambaskip,
swin_unetr, swin_tunet, transunet, mlla_unet (all by default; the last four
at their published widths on 160x160, TransUNet built for that patch). Takes
a few minutes and a few GiB on the CPU.
"""
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mlagg_unet_tpu.models import lkm_unet as JLK  # noqa: E402
from mlagg_unet_tpu.models import mamba_variants as JMV  # noqa: E402
from mlagg_unet_tpu.models import mednext_net as JMN  # noqa: E402
from mlagg_unet_tpu.models import mlla_unet as JML  # noqa: E402
from mlagg_unet_tpu.models import more_variants as JMO  # noqa: E402
from mlagg_unet_tpu.models import msvm_unet as JMS  # noqa: E402
from mlagg_unet_tpu.models import swin_unetr as JSW  # noqa: E402
from mlagg_unet_tpu.models import transunet as JTU  # noqa: E402
from mlagg_unet_tpu.models import umamba as JUM  # noqa: E402
from mlagg_unet_tpu.models import vmamba as JVM  # noqa: E402
from mlagg_unet_tpu.models import vmunet3d as JV3  # noqa: E402
from mlagg_unet_torch.models import lkm_unet as TLK  # noqa: E402
from mlagg_unet_torch.models import mamba_variants as TMV  # noqa: E402
from mlagg_unet_torch.models import mednext_net as TMN  # noqa: E402
from mlagg_unet_torch.models import mlla_unet as TML  # noqa: E402
from mlagg_unet_torch.models import more_variants as TMO  # noqa: E402
from mlagg_unet_torch.models import msvm_unet as TMS  # noqa: E402
from mlagg_unet_torch.models import swin_unetr as TSW  # noqa: E402
from mlagg_unet_torch.models import transunet as TTU  # noqa: E402
from mlagg_unet_torch.models import umamba as TUM  # noqa: E402
from mlagg_unet_torch.models import vmamba as TVM  # noqa: E402
from mlagg_unet_torch.models import vmunet3d as TV3  # noqa: E402
from mlagg_unet_torch.weights import jax_variables_to_state_dict  # noqa: E402
from test_torch_port_mamba import mamba_params  # noqa: E402

PATCH = (160, 160)
CM = SimpleNamespace(
    patch_size=list(PATCH), UNet_base_num_features=32, unet_max_num_features=512,
    conv_kernel_sizes=[[3, 3]] * 6, pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 5,
    n_conv_per_stage_encoder=[2] * 6, n_conv_per_stage_decoder=[2] * 5)
CLASSES = 4
PATCH_3D = (16, 64, 64)
CM_3D = SimpleNamespace(
    patch_size=list(PATCH_3D), UNet_base_num_features=32, unet_max_num_features=320,
    conv_kernel_sizes=[[3, 3, 3]] * 6,
    pool_op_kernel_sizes=[[1, 1, 1]] + [[2, 2, 2]] * 4 + [[1, 2, 2]],
    n_conv_per_stage_encoder=[2] * 6, n_conv_per_stage_decoder=[2] * 5)
CLASSES_3D = 3
# nnMamba's strides: pool_op_kernel_sizes[1:5] of the 3-D plan
NNMAMBA_STRIDES = tuple(tuple(p) for p in CM_3D.pool_op_kernel_sizes[1:5])


def networks():
    """name: () -> (JAX module, port module, input shape)."""
    def umamba(cm, classes, mode):
        return (JUM.umamba_from_plans(cm, 1, classes, False, mode),
                TUM.umamba_from_plans(cm, 1, classes, False, mode))

    def vmunet3d(**kw):
        return JV3.VMUNet3D(num_classes=CLASSES_3D, **kw), TV3.VMUNet3D(1, CLASSES_3D, **kw)

    def mednext(skip):
        return (JMN.create_mednext_v1(1, CLASSES, "B", 3, use_mamba_skip=skip),
                TMN.create_mednext_v1(1, CLASSES, "B", 3, use_mamba_skip=skip))

    x2, x3 = (2, *PATCH, 1), (1, *PATCH_3D, 1)
    lkm = dict(n_stages=len(CM.conv_kernel_sizes), features_per_stage=(32, 64, 128, 256, 512, 512),
               kernel_sizes=CM.conv_kernel_sizes, strides=CM.pool_op_kernel_sizes,
               n_conv_per_stage=CM.n_conv_per_stage_encoder,
               n_conv_per_stage_decoder=CM.n_conv_per_stage_decoder, deep_supervision=False)
    new = dict(no_z=True, use_encoder5=False)
    return {
        "umamba_bot": lambda: (*umamba(CM, CLASSES, "bot"), x2),
        "umamba_enc": lambda: (*umamba(CM, CLASSES, "enc"), x2),
        "vmunet": lambda: (JVM.VMUNet(num_classes=CLASSES), TVM.VMUNet(1, CLASSES), x2),
        "umamba_bot_ss3d": lambda: (*umamba(CM_3D, CLASSES_3D, "bot_ss3d"), x3),
        "umamba_enc_ss3d": lambda: (*umamba(CM_3D, CLASSES_3D, "enc_ss3d"), x3),
        "vmunet3d": lambda: (*vmunet3d(), x3),
        "vmunet3d_new": lambda: (*vmunet3d(**new), x3),
        "vmunet3d_swint": lambda: (*vmunet3d(**new, last_stage_swin=True), x3),
        "msvm_unet": lambda: (JMS.MSVMUNet(num_classes=CLASSES), TMS.MSVMUNet(1, CLASSES), x2),
        "segmamba": lambda: (JMV.SegMamba(num_classes=CLASSES_3D),
                             TMV.SegMamba(1, CLASSES_3D), x3),
        "nnmamba": lambda: (JMV.NNMamba(num_classes=CLASSES_3D, strides=NNMAMBA_STRIDES),
                            TMV.NNMamba(1, CLASSES_3D, strides=NNMAMBA_STRIDES), x3),
        "lightm_unet": lambda: (JMV.LightMUNet(num_classes=CLASSES),
                                TMV.LightMUNet(1, CLASSES), x2),
        "ultralight_vmunet": lambda: (JMV.UltraLightVMUNet(num_classes=CLASSES),
                                      TMV.UltraLightVMUNet(1, CLASSES), x2),
        "lkm_unet": lambda: (JLK.LKMUNet(num_classes=CLASSES, **lkm),
                             TLK.LKMUNet(1, CLASSES, **lkm), x2),
        "mednext_b3": lambda: (*mednext(False), x2),
        "mednext_b3_mambaskip": lambda: (*mednext(True), x2),
        "swin_unetr": lambda: (JSW.SwinUNETR(num_classes=CLASSES), TSW.SwinUNETR(1, CLASSES), x2),
        "swin_tunet": lambda: (JMO.SwinTUNet(num_classes=CLASSES), TMO.SwinTUNet(1, CLASSES), x2),
        "transunet": lambda: (JTU.TransUNet(num_classes=CLASSES),
                              TTU.TransUNet(1, CLASSES, img_size=PATCH), x2),
        "mlla_unet": lambda: (JML.MLLAUNet(num_classes=CLASSES), TML.MLLAUNet(1, CLASSES), x2),
    }


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def first(o):
    return o[0] if isinstance(o, (list, tuple)) else o


def main(names):
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for name in names:
        t0 = time.perf_counter()
        jm, tm, shape = networks()[name]()
        x = np.random.RandomState(6).rand(*shape).astype(np.float32)
        variables = {"params": mamba_params(jm, jnp.asarray(x))}
        stats = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)).get("batch_stats")
        if stats:  # flax's init: mean 0, var 1
            variables["batch_stats"] = jax.tree_util.tree_map_with_path(
                lambda path, v: jnp.full(v.shape, 0.0 if path[-1].key == "mean" else 1.0,
                                         v.dtype), stats)
        apply = jax.jit(jm.apply)
        j32 = np.asarray(first(apply(variables, jnp.asarray(x))), np.float32)
        v16 = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), variables)
        j16 = first(apply(v16, jnp.asarray(x, jnp.bfloat16)))
        jdt, j16 = j16.dtype, np.asarray(j16, np.float32)
        numpy_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        net = tm.eval()
        net.load_state_dict(jax_variables_to_state_dict(
            numpy_tree(variables["params"]),
            {"batch_stats": numpy_tree(stats and variables["batch_stats"])} if stats else None),
            strict=True)
        with torch.no_grad():
            t32 = first(net(torch.from_numpy(x))).numpy()
            t16 = first(net.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16)))
            tdt, t16 = t16.dtype, t16.float().numpy()
        print(f"{name} at {shape[1:-1]}, batch {shape[0]}: bf16 vs fp32 rel L2 JAX {rel_l2(j16, j32):.3e}, "
              f"port {rel_l2(t16, t32):.3e}; port bf16 vs JAX bf16 {rel_l2(t16, j16):.3e}, "
              f"fp32 {rel_l2(t32, j32):.3e}; output dtypes JAX {jdt}, port {tdt} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(networks()))
