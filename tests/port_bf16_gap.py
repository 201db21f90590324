"""How far bf16 serving sits from fp32 for the U-Mambas and VM-UNet, in the
JAX package and in the port, on the CPU.

Both packages compute in bf16 as their predictors do: the parameters and
the input cast to bf16, the network applied, the output read in fp32. The
networks run at full width on a plan cut for the CPU (U-Mambas: nnU-Net's
2d topology at 160x160, 6 stages, 32-512 features; VM-UNet at its
published widths on 160x160), from one seeded JAX param tree loaded into
the port, on a seeded batch of 2. For each network it prints the rel L2 of
bf16 against fp32 in each package and of the port's bf16 against JAX's.

    python tests/port_bf16_gap.py [network ...]

Networks: umamba_bot, umamba_enc, vmunet (all by default). Takes a few
minutes and a few GiB on the CPU.
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

from mlagg_unet_tpu.models import umamba as JUM  # noqa: E402
from mlagg_unet_tpu.models import vmamba as JVM  # noqa: E402
from mlagg_unet_torch.models import umamba as TUM  # noqa: E402
from mlagg_unet_torch.models import vmamba as TVM  # noqa: E402
from test_torch_port_mamba import load, mamba_params  # noqa: E402

PATCH = (160, 160)
CM = SimpleNamespace(
    patch_size=list(PATCH), UNet_base_num_features=32, unet_max_num_features=512,
    conv_kernel_sizes=[[3, 3]] * 6, pool_op_kernel_sizes=[[1, 1]] + [[2, 2]] * 5,
    n_conv_per_stage_encoder=[2] * 6, n_conv_per_stage_decoder=[2] * 5)
CLASSES = 4


def networks():
    return {
        "umamba_bot": lambda: (JUM.umamba_from_plans(CM, 1, CLASSES, False, "bot"),
                               TUM.umamba_from_plans(CM, 1, CLASSES, False, "bot")),
        "umamba_enc": lambda: (JUM.umamba_from_plans(CM, 1, CLASSES, False, "enc"),
                               TUM.umamba_from_plans(CM, 1, CLASSES, False, "enc")),
        "vmunet": lambda: (JVM.VMUNet(num_classes=CLASSES), TVM.VMUNet(1, CLASSES)),
    }


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def first(o):
    return o[0] if isinstance(o, (list, tuple)) else o


def main(names):
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = np.random.RandomState(6).rand(2, *PATCH, 1).astype(np.float32)
    for name in names:
        t0 = time.perf_counter()
        jm, tm = networks()[name]()
        params = mamba_params(jm, jnp.asarray(x))
        apply = jax.jit(jm.apply)
        j32 = np.asarray(first(apply({"params": params}, jnp.asarray(x))), np.float32)
        p16 = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params)
        j16 = first(apply({"params": p16}, jnp.asarray(x, jnp.bfloat16)))
        jdt, j16 = j16.dtype, np.asarray(j16, np.float32)
        net = load(tm, params)
        with torch.no_grad():
            t32 = first(net(torch.from_numpy(x))).numpy()
            t16 = first(net.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16)))
            tdt, t16 = t16.dtype, t16.float().numpy()
        print(f"{name} at {PATCH}, batch 2: bf16 vs fp32 rel L2 JAX {rel_l2(j16, j32):.3e}, "
              f"port {rel_l2(t16, t32):.3e}; port bf16 vs JAX bf16 {rel_l2(t16, j16):.3e}, "
              f"fp32 {rel_l2(t32, j32):.3e}; output dtypes JAX {jdt}, port {tdt} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(networks()))
