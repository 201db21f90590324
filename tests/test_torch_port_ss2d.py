"""VMamba's single-scale ``SS2D`` cell in the PyTorch port against the JAX
package on the CPU: the forward in ten forward types (fp32 and input-dtype
scans, one, two and four directions, the z gate's and the out-norm's
variants) and the parameter gradients of v0 and v05_noz against
``jax.grad``.

Weights come from numpy seeds into the JAX param tree, then
``jax_params_to_state_dict`` -> ``load_state_dict(strict=True)``; inputs from
numpy seeds. Forwards within 1e-4 x max|ref| (+1e-5), gradients within 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from mlagg_unet_tpu.models import mamba_block as JMB
from mlagg_unet_torch.models import mamba_block as TMB
from port_helpers import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    assert_close, one_torch_thread, random_jax_params)
from test_torch_port_mamba import TOL_GRAD, check_grads, grads_pair, load


FORWARD_TYPES = ["v0", "v2", "v04", "v05_noz", "v31d", "v32d", "v2_nozact",
                 "v2_onsoftmax", "v2_onsigmoid", "v2_ondwconv3"]


@pytest.mark.parametrize("forward_type", FORWARD_TYPES)
def test_ss2d_matches_jax(forward_type):
    """SS2D (d_model 8, a 5x6 map) per forward type: the output and the
    input's gradient."""
    x = jnp.asarray(np.random.RandomState(4).randn(2, 5, 6, 8).astype(np.float32))
    jmod = JMB.SS2D(d_model=8, forward_type=forward_type)
    params = random_jax_params(jmod, x)
    tmod = load(TMB.SS2D(8, forward_type=forward_type), params)
    pair, gx, _, _ = grads_pair(jmod, tmod, params, x)
    assert_close(*pair)
    assert_close(gx[0], np.asarray(gx[1]), rel=TOL_GRAD, atol=1e-6)


@pytest.mark.parametrize("forward_type", ["v0", "v05_noz"])
def test_ss2d_parameter_grads_match_jax(forward_type):
    """Every parameter's gradient of SS2D against ``jax.grad``: v0 (the
    zoo's cell, fp32 scan, 4 directions) and v05_noz (the scan in the input
    dtype, no z)."""
    x = jnp.asarray(np.random.RandomState(5).randn(1, 4, 6, 8).astype(np.float32))
    jmod = JMB.SS2D(d_model=8, forward_type=forward_type)
    params = random_jax_params(jmod, x, seed=1)
    tmod = load(TMB.SS2D(8, forward_type=forward_type), params)
    check_grads(*grads_pair(jmod, tmod, params, x))
