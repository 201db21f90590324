"""Helpers shared by the tests of the PyTorch port (``tests/test_torch_port_*``).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU, as ``conftest.py`` forces) and the port; weights go from a
flax ``init`` through ``jax_params_to_state_dict`` into the port's module.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from mlagg_unet_torch.weights import jax_params_to_state_dict


def random_jax_params(module, *inputs, seed: int = 0):
    """A flax module's param tree with random values from a numpy seed.

    The tree's shapes come from ``jax.eval_shape(module.init, ...)``; the
    values are drawn here instead of by flax's init, whose threefry draws
    cost the CPU more (~25 s jitted for the tiny flagship) than the forward
    they feed. Scales sit near 1, biases near 0, kernels at variance
    1/fan_in, and the scan's A_logs, Ds and dt bias near their S4D init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        n = rs.randn(*shape).astype(np.float32)
        if name == "kernel" or name == "x_proj_weight":
            v = n / np.sqrt(np.prod(shape) / shape[-1])
        elif name in ("scale", "Ds"):
            v = 1 + 0.1 * n
        elif name == "A_logs":
            v = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32)) + 0.1 * n
        elif name == "dt_projs_bias":
            dt = np.exp(rs.uniform(np.log(1e-3), np.log(0.1), shape))
            v = dt + np.log(-np.expm1(-dt))
        elif name == "dt_projs_weight":
            v = rs.uniform(-1, 1, shape) / np.sqrt(shape[-1])
        else:  # biases, lambda_*, grn_*
            v = 0.1 * n
        return jnp.asarray(np.asarray(v, np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flat_params(params, prefix: str = "") -> dict:
    return {prefix + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(params).items()}


def load_jax_params(module: torch.nn.Module, params, prefix: str = ""):
    """Load a flax param tree into ``module`` (strict). ``prefix`` names
    the scope for rules keyed on it (transposed convs) and is stripped."""
    sd = jax_params_to_state_dict(flat_params(params, prefix))
    strip = prefix.replace("/", ".")
    module.load_state_dict({k[len(strip):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def assert_close(got, ref, rel: float = 1e-4, atol: float = 1e-5):
    """max |got - ref| <= rel * max |ref| + atol (the port's fp32 tolerance)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    bound = rel * float(np.abs(ref).max()) + atol
    assert err <= bound, f"max |diff| {err:.3e} > {bound:.3e}"
