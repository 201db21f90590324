"""Shared layers of the port's networks, channels-last.

Counterparts of ``mlagg_unet_tpu/models/layers.py`` and of the flax layers
the JAX networks use. Activations are channels-last, ``(B, H, W, C)`` or
``(B, D, H, W, C)``, as in the JAX package; convolutions permute to
channels-first only around ``F.conv2d`` / ``F.conv3d``. A contiguous
channels-last tensor permuted so is a view in ``torch.channels_last`` /
``torch.channels_last_3d``, which cuDNN convolves in place and answers in the
same layout, so the permute back is a view too and no activation is copied.
The flax defaults the JAX models use are kept: LayerNorm eps 1e-6 with the
fast variance ``E[x^2] - E[x]^2``, Dense as ``x @ kernel + bias``, symmetric
padding for strided convs, the flipped kernel of a transposed conv
(``F.conv_transpose2d`` already correlates with the flipped kernel), and
BatchNorm's running averages updated with the biased batch variance.

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

IntOrN = Union[int, Sequence[int]]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


def _ntuple(v: IntOrN, n: int) -> Tuple[int, ...]:
    return tuple(int(i) for i in v) if isinstance(v, (tuple, list)) else (int(v),) * n


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

def _channels_first(x):
    """(B, *spatial, C) -> (B, C, *spatial), a view."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _channels_last(x):
    """(B, C, *spatial) -> (B, *spatial, C), a view."""
    return x.permute(0, *range(2, x.ndim), 1)


_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


class Conv(nn.Module):
    """flax ``nn.Conv`` on channels-last 2-D or 3-D input with symmetric
    integer padding (``padding=1``, or by default ``k // 2`` per axis, the
    SAME padding of an odd kernel at stride 1). The kernel's length sets the
    dimension (an int kernel is 2-D); strides may differ per axis. ``weight``
    is (out, in / groups, *kernel); ``bias=False`` drops the bias, as flax's
    ``use_bias=False`` does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrN,
                 stride: IntOrN = 1, padding: Optional[IntOrN] = None,
                 groups: int = 1, torch_bias: bool = False, bias: bool = True):
        super().__init__()
        k = _ntuple(kernel_size, 2)
        self.stride = _ntuple(stride, len(k))
        self.padding = (_ntuple(padding, len(k)) if padding is not None
                        else tuple(i // 2 for i in k))
        self.groups = groups
        self.torch_bias = torch_bias
        self.weight = _empty(out_channels, in_channels // groups, *k)
        self.bias = _empty(out_channels) if bias else None

    def init_parameters(self, gen):
        fan_in = self.weight[0].numel()
        lecun_normal_(self.weight, fan_in, gen)
        if self.bias is None:
            return
        if self.torch_bias:
            torch_bias_(self.bias, fan_in, gen)
        else:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        y = _CONV[self.weight.ndim - 2](_channels_first(x), self.weight, self.bias,
                                       self.stride, self.padding, 1, self.groups)
        return _channels_last(y)


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
    (``layers.py:239``), 2-D or 3-D as the kernel's length says. ``weight``
    is torch's (in, out, *kernel); the JAX kernel (*kernel, in, out) is the
    same array, and JAX flips it in its forward because
    ``conv_transpose2d`` / ``conv_transpose3d`` do. Groups are not
    supported."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrN, stride: IntOrN, padding: IntOrN = 0):
        super().__init__()
        k = _ntuple(kernel_size, 2)
        self.stride, self.padding = _ntuple(stride, len(k)), _ntuple(padding, len(k))
        self.weight = _empty(in_channels, out_channels, *k)
        self.bias = _empty(out_channels)

    def init_parameters(self, gen):
        lecun_normal_(self.weight, self.weight.shape[0] * self.weight[0, 0].numel(), gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        y = _CONV_T[self.weight.ndim - 2](_channels_first(x), self.weight, self.bias,
                                         self.stride, self.padding)
        return _channels_last(y)


def pad_top_left(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Pad the leading side of H and W (``layers.py:298``)."""
    return F.pad(x, (0, 0, amount, 0, amount, 0))


# ---------------------------------------------------------------- norms

def _norm_dtype(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.dtype:
    return x.dtype if w is None else torch.promote_types(x.dtype, w.dtype)


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's statistics dtype: at least fp32 (fp64 input stays fp64)."""
    return torch.promote_types(x.dtype, torch.float32)


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
    ``GroupNorm_0``; stats over every spatial axis in at least fp32, the
    variance flax's fast ``E[x^2] - E[x]^2`` (clipped at 0), or with
    ``two_pass`` ``E[(x - E[x])^2]`` from ``torch.var_mean``: the same
    function, which needs no squared copy and keeps two fp32 temporaries of
    the activation where the fast form keeps four (the 3-D U-Net's
    activations are large), and does not cancel where a channel's mean is
    large against its spread."""

    def __init__(self, channels: int, eps: float = 1e-5, two_pass: bool = False):
        super().__init__()
        self.eps = eps
        self.two_pass = two_pass
        self.GroupNorm_0 = _Affine(channels)

    def forward(self, x):
        p = self.GroupNorm_0
        xf = x.to(_stats_dtype(x))
        axes = tuple(range(1, x.ndim - 1))
        if self.two_pass:
            # one reduction kernel and no squared copy; xf is dropped once
            # it is centred, so the fp32 temporaries are two, not four
            var, mu = torch.var_mean(xf, axes, correction=0, keepdim=True)
            d = xf - mu
            del xf
            scale = torch.rsqrt(var + self.eps) * p.weight.to(d.dtype)
            return torch.addcmul(p.bias.to(d.dtype), d, scale).to(_norm_dtype(x, p.weight))
        mu = xf.mean(axes, keepdim=True)
        var = torch.clamp((xf * xf).mean(axes, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * p.weight.to(xf.dtype)) \
            + p.bias.to(xf.dtype)
        return y.to(_norm_dtype(x, p.weight))


class BatchNorm(_Affine):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over every axis but
    the channels. In training mode it normalises by the batch's fp32 mean
    and biased variance (the fast variance ``E[x^2] - E[x]^2``, clipped at
    0) and updates the running buffers ``mean`` and ``var`` (flax's
    ``batch_stats``) as flax does, ``ra = momentum ra + (1 - momentum) s``
    with the biased variance: torch's ``F.batch_norm`` would update with the
    unbiased one, n / (n - 1) larger. In eval mode it normalises by the
    running buffers. The arithmetic is at least fp32; the output takes the
    promoted input/param dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__(channels)
        self.eps, self.momentum = eps, momentum
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def init_parameters(self, gen):
        super().init_parameters(gen)
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        xf = x.to(_stats_dtype(x))
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mu = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mu * mu, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mu.detach())
                self.var.copy_(m * self.var + (1 - m) * var.detach())
        else:
            mu, var = self.mean.to(xf.dtype), self.var.to(xf.dtype)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)) \
            + self.bias.to(xf.dtype)
        return y.to(_norm_dtype(x, self.weight))


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
