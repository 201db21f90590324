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
    assert port.resolve_device("cpu") == torch.device("cpu")
