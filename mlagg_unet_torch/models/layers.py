"""Shared layers of the flagship network, NHWC.

Counterparts of ``mlagg_unet_tpu/models/layers.py``. Activations are
channels-last ``(B, H, W, C)`` as in the JAX package; convolutions permute to
NCHW only around ``F.conv2d``. The flax defaults the JAX model uses are kept:
LayerNorm eps 1e-6 with the fast variance ``E[x^2] - E[x]^2``, Dense as
``x @ kernel + bias``, symmetric padding for stride-2 convs, and the flipped
kernel of a transposed conv (``F.conv_transpose2d`` already correlates with
the flipped kernel).

Submodules are named after the flax scopes (``Conv_0``, ``GroupNorm_0``,
``Dense_0``...), so ``weights.jax_params_to_state_dict`` only changes layouts.
Parameters are made empty and filled by ``init_parameters(module, generator)``
with the JAX package's distributions. Stochastic depth (``DropPath``) draws
its masks from a ``torch.Generator`` that the caller hands to the model's
forward; it is the identity in ``eval()`` mode.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IntOr2 = Union[int, Sequence[int]]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


def _pair(v: IntOr2) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _empty(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


# ---------------------------------------------------------------- init

_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _LECUN_TRUNC
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def torch_bias_(b: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """torch's default conv/linear bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
    The JAX package uses it where a zero bias would hand a LayerNorm an
    exactly-zero vector over padded image regions (``layers.py:341``)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.uniform_(b, -bound, bound, generator=gen)


def init_parameters(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` with the JAX package's init
    distributions, in ``module.modules()`` order, from ``gen``."""
    for m in module.modules():
        fn = getattr(m, "init_parameters", None)
        if fn is not None:
            fn(gen)
    return module


class _Affine(nn.Module):
    """weight (ones) + bias (zeros) of a normalisation layer."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = _empty(channels)
        self.bias = _empty(channels)

    def init_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


# ---------------------------------------------------------------- stochastic depth

class DropPath(nn.Module):
    """Per-sample stochastic depth (``layers.py:25-42``): in training mode
    each sample of the batch is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, or zeroed. The identity in ``eval()`` mode
    or at rate 0. The mask is drawn from ``generator``, which must lie on
    x's device; training at a rate above 0 without one raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training mode needs a torch.Generator "
                             "on the input's device")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


# ---------------------------------------------------------------- linear

class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``; ``weight`` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = _empty(out_features, in_features)
        self.bias = _empty(out_features) if bias else None

    def init_parameters(self, gen):
        lecun_normal_(self.weight, self.in_features, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PointwiseConv(Dense):
    """1x1 conv as a channel matmul. Its weight keeps the conv layout
    (out, in, 1, 1) so it converts like every other conv kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self.weight = _empty(out_features, in_features, 1, 1)

    def forward(self, x):
        return F.linear(x, self.weight.view(self.out_features, self.in_features),
                        self.bias)


# ---------------------------------------------------------------- convs

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC with symmetric integer padding (``padding=1``
    or the SAME padding ``k // 2`` of an odd kernel at stride 1). ``weight``
    is (out, in / groups, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOr2,
                 stride: IntOr2 = 1, padding: Optional[IntOr2] = None,
                 groups: int = 1, torch_bias: bool = False):
        super().__init__()
        k = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding) if padding is not None else (k[0] // 2, k[1] // 2)
        self.groups = groups
        self.torch_bias = torch_bias
        self.weight = _empty(out_channels, in_channels // groups, *k)
        self.bias = _empty(out_channels)

    def init_parameters(self, gen):
        fan_in = self.weight[0].numel()
        lecun_normal_(self.weight, fan_in, gen)
        if self.torch_bias:
            torch_bias_(self.bias, fan_in, gen)
        else:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        y = F.conv2d(_nchw(x), self.weight, self.bias, self.stride,
                     self.padding, 1, self.groups)
        return _nhwc(y)


class DepthwiseConv(Conv):
    """Stride-1 SAME depthwise conv (``layers.py:98``); params ``weight``
    (C, 1, k, k) and ``bias`` as flax's ``kernel``/``bias``."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__(channels, channels, kernel_size, groups=channels)


class DWConv2d(nn.Module):
    """Depthwise 3x3 conv whose params sit in a child ``Conv_0``
    (``layers.py:148``)."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.Conv_0 = DepthwiseConv(channels, kernel_size)

    def forward(self, x):
        return self.Conv_0(x)


class ConvTransposeTorch(nn.Module):
    """Transposed conv with torch's output size ``(in - 1) s - 2p + k``
    (``layers.py:239``). ``weight`` is torch's (in, out, kh, kw); the JAX
    kernel (kh, kw, in, out) is the same array, and JAX flips it in its
    forward because ``conv_transpose2d`` does. Groups are not on the
    flagship's path and are not supported."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr2, stride: IntOr2, padding: IntOr2 = 0):
        super().__init__()
        k = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.weight = _empty(in_channels, out_channels, *k)
        self.bias = _empty(out_channels)

    def init_parameters(self, gen):
        lecun_normal_(self.weight, self.weight.shape[0] * self.weight[0, 0].numel(), gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        y = F.conv_transpose2d(_nchw(x), self.weight, self.bias, self.stride,
                               self.padding)
        return _nhwc(y)


def pad_top_left(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Pad the leading side of H and W (``layers.py:298``)."""
    return F.pad(x, (0, 0, amount, 0, amount, 0))


# ---------------------------------------------------------------- norms

def _norm_dtype(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.dtype:
    return x.dtype if w is None else torch.promote_types(x.dtype, w.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis: fp32 stats with the fast
    variance (clipped at 0), output in the promoted input/param dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float()) + bias.float()
    return y.to(_norm_dtype(x, weight))


class LayerNorm(_Affine):
    """flax ``nn.LayerNorm`` (default eps 1e-6)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels)
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """fp32 RMS norm over the last axis, output in x's dtype."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _empty(channels)

    def init_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class InstanceNorm(nn.Module):
    """flax ``GroupNorm(num_groups=C)`` == InstanceNorm with affine
    (``layers.py:199``; also ``ChannelGroupNorm``). Params in a child
    ``GroupNorm_0``; fp32 stats over H, W with the fast variance."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.GroupNorm_0 = _Affine(channels)

    def forward(self, x):
        p = self.GroupNorm_0
        xf = x.float()
        mu = xf.mean((1, 2), keepdim=True)
        var = torch.clamp((xf * xf).mean((1, 2), keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * p.weight.float()) + p.bias.float()
        return y.to(_norm_dtype(x, p.weight))


# ---------------------------------------------------------------- blocks

class ConvolutionalGLU(nn.Module):
    """TransNeXt ConvGLU (``layers.py:164``): fc1 -> split -> act(dwconv(x1))
    * v -> fc2, with ``hidden = int(2 * hidden_features / 3)``."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None,
                 act: Callable = gelu):
        super().__init__()
        hidden = int(2 * hidden_features / 3)
        self.act = act
        self.Dense_0 = Dense(in_features, 2 * hidden)
        self.DWConv2d_0 = DWConv2d(hidden)
        self.Dense_1 = Dense(hidden, out_features or in_features)

    def forward(self, x):
        x1, v = self.Dense_0(x).chunk(2, dim=-1)
        return self.Dense_1(self.act(self.DWConv2d_0(x1)) * v)


# ---------------------------------------------------------------- pooling

def _adaptive_pool_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) averaging matrix with torch AdaptiveAvgPool bin edges."""
    m = torch.zeros(out_size, in_size)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


def avg_pool_to(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NHWC, fp32 sums (``layers.py:308-335``)."""
    B, H, W, C = x.shape
    oh, ow = out_hw
    if H % oh == 0 and W % ow == 0:
        xr = x.reshape(B, oh, H // oh, ow, W // ow, C)
        return xr.float().mean(dim=(2, 4)).to(x.dtype)
    mh = _adaptive_pool_matrix(H, oh).to(x.device)
    mw = _adaptive_pool_matrix(W, ow).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x.float())
    y = torch.einsum("pw,bowc->bopc", mw, y)
    return y.to(x.dtype)
