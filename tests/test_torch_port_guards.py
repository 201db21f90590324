"""Guards of the PyTorch port: it imports nothing of JAX, and its entry
points never fall back to the CPU quietly."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TINY = dict(embed_dim=16, patch_size=2, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
            mlp_ratio=2, sr_ratio=(8, 4, 2, 2))

FORBIDDEN = ("jax", "flax", "mlagg_unet_tpu", "jaxlib")


def _port_sources():
    return sorted((REPO / "mlagg_unet_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_port_import_loads_no_jax():
    """Importing every module of the port (and chip_smoke) in a fresh
    interpreter leaves no JAX module in sys.modules."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _port_sources()]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device given means the GPU; without one the entry points raise
    instead of running on the CPU."""
    import mlagg_unet_torch as port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.build_flagship(3, **TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.VolumePredictor(torch.nn.Identity(), (32, 32), 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.Trainer(patch_size=(64, 64), batch_size=1,
                     network_overrides=dict(TINY))
    assert port.resolve_device("cpu") == torch.device("cpu")


# the networks the registry builds since the SS3D slice, each with the input
# its builder takes (a plan of the right rank) and CPU-sized widths
_CM_3D = dict(patch_size=[8, 32, 32], pool_op_kernel_sizes=[[1, 1, 1], [2, 2, 2], [2, 2, 2]],
              conv_kernel_sizes=[[3, 3, 3]] * 3, UNet_base_num_features=4,
              unet_max_num_features=16, n_conv_per_stage_encoder=[2, 2, 2],
              n_conv_per_stage_decoder=[2, 2])
_NEW_BUILDERS = {
    "umamba_bot_ss3d": ({}, {}), "umamba_enc_ss3d": ({}, {}),
    "vmunet3d": ({}, dict(dims=(8, 16, 32, 64))),
    "vmunet3d_new": ({}, dict(dims=(8, 16, 32, 64))),
    "vmunet3d_swint": ({}, dict(dims=(8, 16, 32, 64), num_heads=2)),
    "msvm_unet": (dict(patch_size=[64, 64]), dict(dims=(8, 16, 32, 64))),
}


@pytest.mark.parametrize("key", sorted(_NEW_BUILDERS))
def test_new_zoo_builders_default_to_the_card(monkeypatch, key):
    """The registry's SS3D U-Mamba, VM-UNet-3D and MSVM-UNet builders take
    the GPU unless the caller names another device: without CUDA they raise,
    with ``device="cpu"`` they build on the CPU."""
    from types import SimpleNamespace

    from mlagg_unet_torch.training.registry import get_network_builder

    cm_kw, overrides = _NEW_BUILDERS[key]
    cm = SimpleNamespace(**{**_CM_3D, **cm_kw})
    build = get_network_builder(key)
    net = build(cm, 1, 3, False, device="cpu", **overrides)
    assert next(net.parameters()).device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(cm, 1, 3, False, **overrides)
