"""The selective scan at state counts other than 16 in the PyTorch port, on
the CPU: the plain scan (K1's and K5's twins) at n = 1, 4 and 5 against the
JAX package's ``selective_scan`` and its gradients, and the wrappers' rule
for the state counts the kernels are not built for (``state_instance``):
zero padding up to 16 gives the unpadded result bit for bit on the plain
path, and n > 16 in passes of 16 gives it within the fp32 rounding of the
passes' sums.

Operands come from numpy seeds, the gradients from ``jax.grad`` and torch's
autograd through ``selective_scan_fwd`` (the plain forward and
``selective_scan_bwd_plain`` on a CPU tensor). y within 1e-4 x max|ref|, the
gradients within 2e-4 x max|ref| (``PARITY.md:70``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlagg_unet_tpu.ops import selective_scan as jax_scan
from mlagg_unet_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_bwd_plain,
    selective_scan_states,
)
from mlagg_unet_torch.ops.selective_scan_cuda import (
    bwd_over_passes,
    fwd_over_passes,
    selective_scan_fwd,
    state_instance,
)
from port_helpers import assert_close, one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _operands(n, b=2, g=3, d=6, L=200, seed=0):
    rs = np.random.RandomState(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f(rs.randn(b, g, d, L)), f(0.5 * rs.randn(b, g, d, L)),
            f(-np.exp(0.3 * rs.randn(g, d, n))), f(rs.randn(b, g, n, L)),
            f(rs.randn(b, g, n, L)), f(1 + 0.1 * rs.randn(g, d)), f(0.1 * rs.randn(g, d))]


@pytest.mark.parametrize("n", [1, 4, 5])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_scan_matches_jax_at_state_count(n, reverse):
    """y and every gradient of the port's scan (the plain forward and
    backward on the CPU) against JAX's ``selective_scan`` and ``jax.grad``."""
    ops = _operands(n, seed=n)
    cot = np.random.RandomState(99).randn(*ops[0].shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(jax_scan(*a, delta_softplus=True, reverse=reverse) * cot)

    ref_y = jax_scan(*map(jnp.asarray, ops), delta_softplus=True, reverse=reverse)
    ref_g = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, ops))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops]
    y = selective_scan_fwd(*leaves, delta_softplus=True, reverse=reverse)
    (y * torch.from_numpy(cot)).sum().backward()
    assert_close(y, np.asarray(ref_y))
    for name, leaf, r in zip(NAMES, leaves, ref_g):
        assert leaf.grad.shape == leaf.shape, name
        assert_close(leaf.grad, np.asarray(r), rel=2e-4, atol=0)


def _fwd_pass(u, delta, A, B, C, D, bias, softplus, reverse, with_states):
    """One pass of the plain twins, as K1's launch is one pass."""
    assert A.shape[-1] in (1, 16)
    return (selective_scan(u, delta, A, B, C, D, bias, softplus, reverse=reverse),
            selective_scan_states(u, delta, A, B, C, bias, softplus, 64, reverse)
            if with_states else None)


def _bwd_pass(u, delta, A, B, C, D, bias, softplus, reverse, gy, states):
    assert A.shape[-1] in (1, 16) and states.shape[-1] == A.shape[-1]
    return selective_scan_bwd_plain(u, delta, A, B, C, D, bias, softplus, reverse, gy)


@pytest.mark.parametrize("n,exact", [(5, True), (15, True), (40, False)])
def test_state_counts_are_padded_or_passed_exactly(n, exact):
    """n = 5 and 15 run as one pass of 16 (padded), n = 40 as three: y, the
    tile-entry states and every gradient against the unpadded plain scan,
    bit for bit where the states are only padded, within 1e-6 x max where
    passes are summed; dA, dB, dC sliced back to n states."""
    t = [torch.from_numpy(a) for a in _operands(n, seed=10 + n)]
    gy = torch.from_numpy(np.random.RandomState(3).randn(*t[0].shape).astype(np.float32))
    y, states = fwd_over_passes(_fwd_pass, *t, True, False, True)
    ref_y = selective_scan(*t, True)
    ref_s = selective_scan_states(*t[:5], t[6], True, 64)
    got = bwd_over_passes(_bwd_pass, *t, True, False, gy, states)
    ref = selective_scan_bwd_plain(*t, True, False, gy)
    assert states.shape == ref_s.shape
    for g_, r_ in [(y, ref_y), (states, ref_s), *zip(got, ref)]:
        assert g_.shape == r_.shape
        if exact:
            assert torch.equal(g_, r_)
        else:
            assert_close(g_, r_.numpy(), rel=1e-6, atol=0)


def test_state_instance_and_its_limit():
    """1 and 16 are the kernels' own; 2-16 pad to 16; 17-64 take passes of
    16; 0 and over 64 raise, naming the limit."""
    assert [state_instance(n) for n in (1, 2, 15, 16, 17, 32, 33, 64)] == [
        (1, 1), (16, 1), (16, 1), (16, 1), (16, 2), (16, 2), (16, 3), (16, 4)]
    for n in (0, 65):
        with pytest.raises(ValueError, match="1 to 64"):
            state_instance(n)
