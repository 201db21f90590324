"""``MambaBlock`` and ``SS2D`` in bf16 in the PyTorch port against the JAX
package's bf16 on the CPU: the output's dtype follows flax's promotion (the
scan's fp32 output promotes the layers after it), and the port's bf16
output sits from its fp32 output, and from JAX's bf16 output, within twice
the distance JAX's bf16 output sits from JAX's fp32 one.

Weights come from numpy seeds into the JAX param tree; inputs from numpy
seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.models import mamba_block as JMB
from mlagg_unet_torch.models import mamba_block as TMB
from port_helpers import one_torch_thread, random_jax_params  # noqa: F401  (autouse fixture)
from test_torch_port_mamba import MAMBA, load, mamba_params

T = torch.from_numpy


def bf16_pair(jmod, tmod, params, x):
    """The module in bf16 in both packages (parameters and input cast, as
    the predictors cast them): (port output, JAX output, JAX fp32 output)."""
    p16 = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params)
    j16 = jmod.apply({"params": p16}, x.astype(jnp.bfloat16))
    j32 = jmod.apply({"params": params}, x)
    with torch.no_grad():
        t16 = load(tmod, params).to(torch.bfloat16)(T(np.array(x)).to(torch.bfloat16))
    return t16, j16, j32


def assert_bf16_follows(t16, j16, j32):
    """The port's bf16 output in JAX's dtype (fp32: the scan's fp32 output
    promotes the gate and out_proj), within 2e-2 rel L2 of JAX's bf16
    output (measured up to 9.4e-3; bf16 itself moves these modules by
    4e-3 to 1.2e-2 from fp32)."""
    assert str(t16.dtype).replace("torch.", "") == str(j16.dtype) == "float32"
    a, b = t16.double().numpy(), np.asarray(j16, np.float64)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2e-2
    assert np.linalg.norm(b - np.asarray(j32)) > 0    # bf16 did round


@pytest.mark.parametrize("case", list(MAMBA))
def test_mamba_block_bf16_follows_jax(case):
    """MambaBlock in bf16 against JAX's in bf16."""
    kw = MAMBA[case]
    x = jnp.asarray(np.random.RandomState(1).randn(2, 20, 8).astype(np.float32))
    jmod = JMB.MambaBlock(d_model=8, **kw)
    assert_bf16_follows(*bf16_pair(jmod, TMB.MambaBlock(8, **kw), mamba_params(jmod, x), x))


@pytest.mark.parametrize("forward_type", ["v0", "v04", "v05_noz", "v31d", "v2_onsoftmax",
                                          "v2_ondwconv3"])
def test_ss2d_bf16_follows_jax(forward_type):
    """SS2D in bf16 against JAX's in bf16: the fp32 scan (v0), the scan in
    bf16 (v04, v05_noz, v31d) and the out-norm tails that take the scan's
    output."""
    x = jnp.asarray(np.random.RandomState(4).randn(2, 5, 6, 8).astype(np.float32))
    jmod = JMB.SS2D(d_model=8, forward_type=forward_type)
    assert_bf16_follows(*bf16_pair(jmod, TMB.SS2D(8, forward_type=forward_type),
                                   random_jax_params(jmod, x), x))
