"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda`` and skipped without a card. The file imports no JAX, so it
also runs on a machine that has none:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``
(``tests/conftest.py`` imports JAX). Tolerance: fp32 I/O, max|diff| <=
1e-4 * max|ref| (only the order of fp32 sums differs).
"""
import numpy as np
import pytest
import torch

from mlagg_unet_torch.ops.flash_attention import attention_reference, flash_attention
from mlagg_unet_torch.ops.mlla_fused import (
    mlla_front, mlla_front_plain, mlla_tail, mlla_tail_plain)
from mlagg_unet_torch.ops.selective_scan import selective_scan
from mlagg_unet_torch.ops.selective_scan_cuda import selective_scan_fwd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev, dtype)


def _close(got, ref):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-4 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_matches_plain(cuda_device, dtype, reverse):
    b, g, d, n, l = 3, 2, 40, 16, 1000  # d and l not multiples of the tiles
    u = _rand((b, g, d, l), cuda_device, dtype, 0)
    dl = _rand((b, g, d, l), cuda_device, dtype, 1, 0.5)
    B, C = _rand((b, g, n, l), cuda_device, dtype, 2), _rand((b, g, n, l), cuda_device, dtype, 3)
    A = -torch.exp(_rand((g, d, n), cuda_device, torch.float32, 4, 0.3))
    D = _rand((g, d), cuda_device, torch.float32, 5)
    db = _rand((g, d), cuda_device, torch.float32, 6, 0.1)
    y = selective_scan_fwd(u, dl, A, B, C, D, db, True, reverse)
    assert y.dtype == torch.float32
    _close(y, selective_scan(u, dl, A, B, C, D, db, True, reverse=reverse))


@pytest.mark.parametrize("C,tokens", [(96, 1000), (192, 257), (768, 33)])
def test_mlla_kernels_match_plain(cuda_device, C, tokens):
    """Every stage width, token counts that are not a multiple of the CTA's
    token tile."""
    def w(n_out, n_in, seed):  # (out, in), variance 1 / n_in
        return _rand((n_out, n_in), cuda_device, torch.float32, seed, n_in ** -0.5)

    def b(n, seed):
        return _rand((n,), cuda_device, torch.float32, seed, 0.1)

    x, h, a = (_rand((tokens, C), cuda_device, torch.float32, i) for i in range(3))
    lw, lb = 1 + b(C, 10), b(C, 11)
    fa = (x, lw, lb, w(C, C, 20), b(C, 12), w(C, C, 21), b(C, 13))
    ta = (h, a, x, w(C, C, 22), b(C, 14), lw, lb, w(2 * C, C, 23), b(2 * C, 15),
          w(C, 2 * C, 24), b(C, 16))
    for got, ref in zip(mlla_front(*fa), mlla_front_plain(*fa)):
        _close(got, ref)
    _close(mlla_tail(*ta), mlla_tail_plain(*ta))


@pytest.mark.parametrize("lq,lk,dk,dv", [(1000, 56, 24, 48), (130, 200, 32, 32)])
def test_attention_kernel_matches_plain(cuda_device, lq, lk, dk, dv):
    q = _rand((2, 3, lq, dk), cuda_device, torch.float32, 0, dk ** -0.5)
    k = _rand((2, 3, lk, dk), cuda_device, torch.float32, 1)
    v = _rand((2, 3, lk, dv), cuda_device, torch.float32, 2)
    _close(flash_attention(q, k, v, 0.2), attention_reference(q, k, v, 0.2))


def test_attention_kernel_takes_strided_head_views(cuda_device):
    """The pooled branch hands the kernel q and k as views of (B, N, nh, 2, hd)."""
    qg = _rand((2, 300, 4, 2, 24), cuda_device, torch.float32, 0, 0.2)
    kg = _rand((2, 56, 4, 2, 24), cuda_device, torch.float32, 1)
    v = _rand((2, 56, 4, 48), cuda_device, torch.float32, 2).transpose(1, 2)
    q, k = qg[:, :, :, 1].transpose(1, 2), kg[:, :, :, 1].transpose(1, 2)
    _close(flash_attention(q, k, v, 0.2), attention_reference(q, k, v, 0.2))


def test_wrappers_raise_on_what_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 1, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):  # dv = 0
        flash_attention(q, q, torch.zeros(1, 1, 8, 0, device=cuda_device))
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros(4, 8, 32, device=cuda_device)
    w = torch.zeros(32, 32, device=cuda_device)
    bias = torch.zeros(32, device=cuda_device)
    with pytest.raises(ValueError):  # mixed dtypes
        mlla_front(x, bias, bias, w, bias, w, bias.double())
    u = torch.zeros(1, 1, 4, 10, device=cuda_device)
    with pytest.raises(ValueError):  # 8 states: the kernel takes 16
        selective_scan_fwd(u, u, torch.zeros(1, 4, 8, device=cuda_device),
                           torch.zeros(1, 1, 8, 10, device=cuda_device),
                           torch.zeros(1, 1, 8, 10, device=cuda_device))


def test_model_on_card_matches_cpu(cuda_device):
    """A small flagship, fp32, the card's kernels against the CPU's twins."""
    from mlagg_unet_torch import build_flagship

    tiny = dict(embed_dim=32, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
                sr_ratio=(8, 4, 2, 2))
    model = build_flagship(3, device=cuda_device, seed=1, **tiny)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 96, 1).astype(np.float32))
    with torch.inference_mode():
        gpu = model(x.to(cuda_device))
        cpu = build_flagship(3, device="cpu", seed=1, **tiny)(x)
    for g_, c_ in zip(gpu, cpu):
        err = (g_.cpu() - c_).abs().max().item()
        assert err <= 1e-3 * c_.abs().max().item(), err
