"""The transforms of both model families (mirrors shallow_ntc_tpu/models/transforms.py),
under the JAX package's class names: every transform of the JAX registry
(ElicAnalysis and ElicSynthesis live in models/elic.py).

Every module takes and returns NHWC tensors and keeps its parameters in the
flax layout under the flax names (`kernel` [k, k, C_in, C_out], `bias`,
GDN's `beta`/`gamma`), so a flax parameter tree loads one to one
(shallow_ntc_tpu_torch/params.py). Convolutions run in the input's dtype.
"""

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shallow_ntc_tpu_torch.ops import fast_deconv as fd
from shallow_ntc_tpu_torch.ops import int8ops
from shallow_ntc_tpu_torch.ops.jpegl_decode import jpegl_synthesize
from shallow_ntc_tpu_torch.ops.math import lower_bound
from shallow_ntc_tpu_torch.ops.twolayer_final import final_deconv_phase
from shallow_ntc_tpu_torch.utils import profiling

_GDN_PEDESTAL = 2.0**-18


def _nonneg(param: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
  """tfc GDNParameter reparameterization: value = max(p, bound)^2 - pedestal."""
  bound = math.sqrt(minimum + _GDN_PEDESTAL)
  return torch.square(lower_bound(param, bound)) - _GDN_PEDESTAL


class Conv(nn.Module):
  """SAME strided conv with a flax [k, k, C_in, C_out] kernel.

  lax SAME pads the high side more when the total padding is odd, which
  torch's symmetric `padding=` cannot express, so odd cases pad explicitly.
  With SNTC_INT8_ENCODE=1 a stride-1 conv of C_in >= 32 runs on int8
  operands (ops/int8ops.conv_s1_int8) and then adds its bias, as the JAX
  package's Conv (transforms.py:223-234).
  """

  def __init__(self, in_features: int, features: int, kernel_size: int, stride: int):
    super().__init__()
    self.stride = stride
    self.kernel = nn.Parameter(torch.zeros(kernel_size, kernel_size, in_features, features))
    self.bias = nn.Parameter(torch.zeros(features))

  def flops(self, shape) -> int:
    """The conv's FLOPs at an input of `shape`, on the float or the int8 route."""
    return profiling.conv_flops(shape, self.kernel.shape[3], self.kernel.shape[0], self.stride)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    k, s = self.kernel.shape[0], self.stride
    h_lo, h_hi = profiling.same_pads(x.shape[1], k, s)
    w_lo, w_hi = profiling.same_pads(x.shape[2], k, s)
    if s == 1 and x.shape[-1] >= 32 and int8ops.encode_enabled():
      return int8ops.conv_s1_int8(x, self.kernel.to(x.dtype), h_lo, h_hi, x.dtype, self.bias)
    xn = x.permute(0, 3, 1, 2)
    weight = self.kernel.to(x.dtype).permute(3, 2, 0, 1)
    if h_lo == h_hi and w_lo == w_hi:
      out = F.conv2d(xn, weight, self.bias.to(x.dtype), s, padding=(h_lo, w_lo))
    else:
      out = F.conv2d(F.pad(xn, (w_lo, w_hi, h_lo, h_hi)), weight, self.bias.to(x.dtype), s)
    return out.permute(0, 2, 3, 1)


class FastConvTranspose(nn.Module):
  """SAME transposed conv with a flax [k, k, C_in, C_out] kernel (flax ConvTranspose).

  With use_bias=False there is no `bias` parameter, as in flax.
  """

  def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
               use_bias: bool = True):
    super().__init__()
    self.stride = stride
    self.kernel = nn.Parameter(torch.zeros(kernel_size, kernel_size, in_features, features))
    self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

  def flops(self, shape) -> int:
    """The transposed conv's FLOPs at an input of `shape`, on every route."""
    return profiling.conv_flops(shape, self.kernel.shape[3], self.kernel.shape[0], self.stride,
                                transpose=True)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return fd.fast_conv_transpose(x, self.kernel, self.bias, self.stride)


class GDN(nn.Module):
  """Generalized divisive normalization (Balle 2016):
  y = x / (beta + |x|^alpha @ gamma)^epsilon, or x * (...) if inverse.

  Classic GDN has (alpha, epsilon) = (2, 0.5); GDN1 (Johnston 2018) pins
  (1, 1). rectify applies a relu first.
  """

  def __init__(self, channels: int, inverse: bool = False, alpha: float = 1.0,
               epsilon: float = 1.0, rectify: bool = False):
    super().__init__()
    self.inverse = inverse
    self.alpha = alpha
    self.epsilon = epsilon
    self.rectify = rectify
    self.beta = nn.Parameter(torch.zeros(channels))
    self.gamma = nn.Parameter(torch.zeros(channels, channels))

  def effective_params(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beta, gamma) after the nonnegative reparameterization."""
    return _nonneg(self.beta, 1e-6).to(dtype), _nonneg(self.gamma, 0.0).to(dtype)

  def flops(self, shape) -> int:
    """The 1x1 conv of |x|^alpha with gamma, as XLA counts it (the
    elementwise rest is not counted)."""
    return 2 * math.prod(shape) * self.gamma.shape[0]

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    beta, gamma = self.effective_params(x.dtype)
    if self.rectify:
      x = F.relu(x)
    return fd.gdn(x, beta, gamma, self.inverse, self.alpha, self.epsilon)


class GDN1(GDN):
  """GDN pinned to alpha = epsilon = 1."""

  def __init__(self, channels: int, inverse: bool = False):
    super().__init__(channels, inverse)


class PReLU(nn.Module):
  """Parametric ReLU with a learned per-channel negative slope (flax name
  `negative_slope`, initialized to 0.25)."""

  def __init__(self, channels: int):
    super().__init__()
    self.negative_slope = nn.Parameter(torch.zeros(channels))

  def flops(self, shape) -> int:
    return 0  # elementwise: no linear map

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * self.negative_slope.to(x.dtype))


class Pointwise(nn.Module):
  """A parameterless elementwise activation (nothing in the state dict)."""

  def __init__(self, name: str, fn):
    super().__init__()
    self.name = name
    self.fn = fn

  def flops(self, shape) -> int:
    return 0  # elementwise: no linear map

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.fn(x)

  def extra_repr(self) -> str:
    return self.name


# jax.nn's activations by name, as make_activation resolves them there.
_POINTWISE = {
    "relu": F.relu, "relu6": F.relu6, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "silu": F.silu, "swish": F.silu, "gelu": functools.partial(F.gelu, approximate="tanh"),
    "elu": F.elu, "selu": F.selu, "celu": F.celu, "softplus": F.softplus,
    "soft_sign": F.softsign, "log_sigmoid": F.logsigmoid, "hard_tanh": F.hardtanh,
    "hard_sigmoid": F.hardsigmoid, "hard_silu": F.hardswish, "hard_swish": F.hardswish,
    # The reference resolves 'lrelu' to tf.nn.leaky_relu, whose slope is 0.2
    # (the JAX package keeps it; torch's and jax.nn's default is 0.01).
    "lrelu": functools.partial(F.leaky_relu, negative_slope=0.2),
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.2),
}


def make_activation(name: Optional[str], channels: int) -> Optional[nn.Module]:
  """The activation of a transform by name (models/transforms.py:135-160):
  prelu, gdn / gdn1, igdn / igdn1, or a jax.nn activation's name."""
  if name is None:
    return None
  lowered = name.lower()
  if lowered == "prelu":
    return PReLU(channels)
  if lowered in ("gdn", "gdn1"):
    return GDN1(channels)
  if lowered in ("igdn", "igdn1"):
    return GDN1(channels, inverse=True)
  if lowered not in _POINTWISE:
    raise ValueError(f"Unknown activation: {name}")
  return Pointwise(lowered, _POINTWISE[lowered])


class _ConvStack(nn.Module):
  """Sequential (conv | deconv, activation) stack; children `convs_i`, `acts_i`."""

  def __init__(self, in_features: int,
               layer_specs: Sequence[Tuple[int, int, int, Optional[str], bool]]):
    super().__init__()
    self.n = len(layer_specs)
    c = in_features
    for i, (features, kernel, stride, act, transpose) in enumerate(layer_specs):
      maker = FastConvTranspose if transpose else Conv
      setattr(self, f"convs_{i}", maker(c, features, kernel, stride))
      setattr(self, f"acts_{i}", make_activation(act, features))
      c = features

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.n):
      x = getattr(self, f"convs_{i}")(x)
      act = getattr(self, f"acts_{i}")
      if act is not None:
        x = act(x)
    return x


class HyperAnalysis(nn.Module):
  """Hyper-encoder: k3s1 + 2 x k5s2."""

  downsample_factor = 4

  def __init__(self, in_features: int, bottleneck_size: int, activation_type: str = "relu"):
    super().__init__()
    b, a = bottleneck_size, activation_type
    self.output_depth = b
    self.stack = _ConvStack(in_features, ((b, 3, 1, a, False), (b, 5, 2, a, False),
                                          (b, 5, 2, None, False)))

  def forward(self, x):
    return self.stack(x)


class HyperSynthesis(nn.Module):
  """Hyper-decoder: 2 x k5s2 deconv + k3s1 to 2*bottleneck (mu, sigma)."""

  def __init__(self, in_features: int, bottleneck_size: int, activation_type: str = "relu"):
    super().__init__()
    b, a = bottleneck_size, activation_type
    self.stack = _ConvStack(in_features, ((b, 5, 2, a, True), (int(b * 1.5), 5, 2, a, True),
                                          (b * 2, 3, 1, None, True)))

  def forward(self, x):
    return self.stack(x)


class HyperAnalysisSmall(nn.Module):
  """Two-layer hyper-encoder for small images: k3s1 relu + k5s2."""

  downsample_factor = 2

  def __init__(self, in_features: int, bottleneck_size: int):
    super().__init__()
    b = bottleneck_size
    self.output_depth = b
    self.stack = _ConvStack(in_features, ((b, 3, 1, "relu", False), (b, 5, 2, None, False)))

  def forward(self, x):
    return self.stack(x)


class HyperSynthesisSmall(nn.Module):
  """Two-layer hyper-decoder for small images: k5s2 relu + k3s1 deconvs."""

  upsample_factor = 2

  def __init__(self, in_features: int, bottleneck_size: int):
    super().__init__()
    b = bottleneck_size
    self.output_depth = b * 2
    self.stack = _ConvStack(in_features, ((int(b * 1.5), 5, 2, "relu", True),
                                          (int(b * 2), 3, 1, None, True)))

  def forward(self, x):
    return self.stack(x)


class BLS2017Analysis(nn.Module):
  """Balle 2017 analysis: 9x9 s4 + 5x5 s2 + 5x5 s2 convs, GDN1 between."""

  downsample_factor = 16

  def __init__(self, in_features: int, num_filters: int):
    super().__init__()
    n = num_filters
    self.output_depth = n
    self.stack = _ConvStack(in_features, ((n, 9, 4, "gdn", False), (n, 5, 2, "gdn", False),
                                          (n, 5, 2, None, False)))

  def forward(self, x):
    return self.stack(x)


class BLS2017Synthesis(nn.Module):
  """Balle 2017 synthesis: the mirrored deconvs, IGDN1 between."""

  upsample_factor = 16
  output_depth = 3

  def __init__(self, in_features: int, num_filters: int):
    super().__init__()
    n = num_filters
    self.stack = _ConvStack(in_features, ((n, 5, 2, "igdn", True), (n, 5, 2, "igdn", True),
                                          (3, 9, 4, None, True)))

  def forward(self, x):
    return self.stack(x)


class _ConvGDNLayers(nn.Module):
  """n_layers of 5x5 s2 (de)convs with classic GDN (alpha 2, epsilon 0.5)
  between, as Minnen 2018; children `convs_i`, `acts_i` on the module itself
  and no activation after the last conv."""

  def __init__(self, in_features: int, channels_base: int, n_layers: int,
               output_channels: Optional[int], transpose: bool):
    super().__init__()
    self.n = n_layers
    self.output_depth = output_channels if output_channels is not None else channels_base
    maker = FastConvTranspose if transpose else Conv
    c = in_features
    for i in range(n_layers):
      last = i + 1 == n_layers
      features = self.output_depth if last else channels_base
      setattr(self, f"convs_{i}", maker(c, features, 5, 2))
      setattr(self, f"acts_{i}", None if last else GDN(features, inverse=transpose,
                                                        alpha=2.0, epsilon=0.5))
      c = features

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.n):
      x = getattr(self, f"convs_{i}")(x)
      act = getattr(self, f"acts_{i}")
      if act is not None:
        x = act(x)
    return x


class MBT2018Analysis(_ConvGDNLayers):
  """Minnen 2018 analysis: n_layers x (5x5 s2 conv + GDN)."""

  def __init__(self, in_features: int, channels_base: int, n_layers: int = 4,
               output_channels: Optional[int] = None):
    super().__init__(in_features, channels_base, n_layers, output_channels, transpose=False)
    self.downsample_factor = 2**n_layers


class MBT2018Synthesis(_ConvGDNLayers):
  """Minnen 2018 synthesis: n_layers x (5x5 s2 deconv + IGDN)."""

  def __init__(self, in_features: int, channels_base: int, n_layers: int = 4,
               output_channels: int = 3):
    super().__init__(in_features, channels_base, n_layers, output_channels, transpose=True)
    self.upsample_factor = 2**n_layers


class CNNAnalysis(nn.Module):
  """Four 5x5 s2 convs, the activation (leaky relu, slope 0.2) between."""

  downsample_factor = 16

  def __init__(self, in_features: int, channels_base: int,
               output_channels: Optional[int] = None, activation_type: str = "leaky_relu"):
    super().__init__()
    cb, a = channels_base, activation_type
    self.output_depth = output_channels if output_channels is not None else cb
    self.stack = _ConvStack(in_features, ((cb, 5, 2, a, False), (cb, 5, 2, a, False),
                                          (cb, 5, 2, a, False),
                                          (self.output_depth, 5, 2, None, False)))

  def forward(self, x):
    return self.stack(x)


class CNNSynthesis(nn.Module):
  """Four 5x5 s2 deconvs, the activation (leaky relu, slope 0.2) between."""

  upsample_factor = 16

  def __init__(self, in_features: int, channels_base: int, output_channels: int = 3,
               activation_type: str = "leaky_relu"):
    super().__init__()
    cb, a = channels_base, activation_type
    self.output_depth = output_channels
    self.stack = _ConvStack(in_features, ((cb, 5, 2, a, True), (cb, 5, 2, a, True),
                                          (cb, 5, 2, a, True),
                                          (output_channels, 5, 2, None, True)))

  def forward(self, x):
    return self.stack(x)


def _final_deconv_packed(mid_p: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                         s1: int, s2: int, mid_channels: int) -> torch.Tensor:
  """Final small deconv from phase space.

  The flagship geometry (s1=8, s2=2, k<=7, 8*c_in <= 128) goes to the
  final_deconv_phase kernel at any batch and height; other geometries take
  the packed dense conv, or the plain subpixel path for wide mid tensors.
  """
  if s1 * mid_channels <= 128 and s1 == 8 and s2 == 2 and kernel.shape[0] <= 7:
    return final_deconv_phase(mid_p.contiguous(), kernel, bias, mid_channels)
  if mid_channels < 64:
    return fd.packed_conv_transpose(fd.partial_depth_to_space(mid_p, s1, s1),
                                    kernel, bias, s2, s1)
  return fd.fast_conv_transpose(fd.depth_to_space(mid_p, s1), kernel, bias, s2)


def _apply_act_phase(act, x_p: torch.Tensor, num_phases: int) -> torch.Tensor:
  """Apply an activation to a phase-space tensor [.., num_phases*C]."""
  if act is None:
    return x_p
  if isinstance(act, GDN):
    beta, gamma = act.effective_params(x_p.dtype)
    return fd.gdn_phase(x_p, beta, gamma, num_phases, act.inverse, act.alpha, act.epsilon)
  return act(x_p)  # pointwise activations are phase-agnostic


class TwoLayerSynthesis(nn.Module):
  """Two deconvs with an activation between (the paper's non-residual
  two-layer decoder): conv2(act(conv1(z))), children `conv1`, `act`, `conv2`.

  The fused form keeps the mid activation in s1 phase space: conv1 runs as
  one phase conv, the activation applies per phase, and the final deconv
  reads the phase tensor directly (final_deconv_phase at the k13s8 + k5s2
  geometry). PReLU does not fuse, as in the JAX package.
  """

  def __init__(self, in_features: int, channels: Tuple[int, int] = (24, 3),
               strides: Tuple[int, int] = (8, 2), kernel_sizes: Tuple[int, int] = (13, 5),
               activation_type: Optional[str] = "igdn", fused: bool = True):
    super().__init__()
    self.channels = tuple(channels)
    self.strides = tuple(strides)
    self.fused = fused
    self.upsample_factor = strides[0] * strides[1]
    self.output_depth = channels[-1]
    self.conv1 = FastConvTranspose(in_features, channels[0], kernel_sizes[0], strides[0])
    self.act = make_activation(activation_type, channels[0])
    self.conv2 = FastConvTranspose(channels[0], channels[1], kernel_sizes[1], strides[1])

  def flops(self, shape) -> int:
    """conv1, the activation and conv2, whichever route computes them."""
    b, h, w, _ = shape
    mid = (b, h * self.strides[0], w * self.strides[0], self.channels[0])
    act = 0 if self.act is None else self.act.flops(mid)
    return self.conv1.flops(shape) + act + self.conv2.flops(mid)

  def forward(self, z: torch.Tensor) -> torch.Tensor:
    if not self.fused or isinstance(self.act, PReLU):
      x = self.conv1(z)
      if self.act is not None:
        x = self.act(x)
      return self.conv2(x)
    s1 = self.strides[0]
    x_p = fd.phase_conv(z, self.conv1.kernel.to(z.dtype), self.conv1.bias, s1)
    mid_p = _apply_act_phase(self.act, x_p, s1 * s1)
    return _final_deconv_packed(mid_p, self.conv2.kernel.to(z.dtype), self.conv2.bias,
                                s1, self.strides[1], self.channels[0])


class TwoLayerResSynthesis(nn.Module):
  """Two-layer synthesis with a parallel residual branch:
  out_conv(act(base_conv(z)) + res(z)).

  res_type="conv": res is a second deconv like base_conv (`res_conv`).
  res_type="d2s": res is the pixel-shuffle stack depth_to_space(2), a 1x1
  Conv to 192 (a fixed width, as in JAX), leaky relu (slope 0.2),
  depth_to_space(2), a 1x1 Conv to 4 * channels[0], leaky relu,
  depth_to_space(2) (`res_conv1`, `res_conv2`; transforms.py:827-843).

  The fused form (res_type="conv" only) keeps the mid activation in s1
  phase space: base and residual run as one phase conv, the (I)GDN and the
  sum apply per phase, and the final k5s2 deconv reads the phase tensor
  directly (final_deconv_phase). PReLU and d2s do not fuse.
  """

  def __init__(self, in_features: int, channels: Tuple[int, int] = (12, 3),
               strides: Tuple[int, int] = (8, 2), kernel_sizes: Tuple[int, int] = (13, 5),
               activation_type: str = "igdn", res_type: str = "conv", fused: bool = True):
    super().__init__()
    self.channels = tuple(channels)
    self.strides = tuple(strides)
    self.res_type = res_type
    self.fused = fused and res_type == "conv"
    self.upsample_factor = strides[0] * strides[1]
    self.output_depth = channels[-1]
    c, s1 = channels[0], strides[0]
    self.base_conv = FastConvTranspose(in_features, c, kernel_sizes[0], s1)
    self.base_act = make_activation(activation_type, c)
    if res_type == "conv":
      self.res_conv = FastConvTranspose(in_features, c, kernel_sizes[0], s1)
    elif res_type == "d2s":
      self.res_conv1 = Conv(in_features // 4, 192, 1, 1)
      self.res_conv2 = Conv(192 // 4, c * 4, 1, 1)
    else:
      raise NotImplementedError(res_type)
    self.out_conv = FastConvTranspose(c, channels[1], kernel_sizes[1], strides[1])

  def flops(self, shape) -> int:
    """The base and residual branches, the activation and the output
    deconv, whichever route computes them (the fused phase form counts as
    the two k13s8 deconvs and the k5s2 one it computes)."""
    b, h, w, c_in = shape
    mid = (b, h * self.strides[0], w * self.strides[0], self.channels[0])
    if self.res_type == "conv":
      res = self.res_conv.flops(shape)
    else:
      res = (self.res_conv1.flops((b, 2 * h, 2 * w, c_in // 4))
             + self.res_conv2.flops((b, 4 * h, 4 * w, self.res_conv2.kernel.shape[2])))
    act = 0 if self.base_act is None else self.base_act.flops(mid)
    return self.base_conv.flops(shape) + act + res + self.out_conv.flops(mid)

  def _res(self, z: torch.Tensor) -> torch.Tensor:
    if self.res_type == "conv":
      return self.res_conv(z)
    lrelu = _POINTWISE["leaky_relu"]
    x = lrelu(self.res_conv1(fd.depth_to_space(z, 2)))
    x = lrelu(self.res_conv2(fd.depth_to_space(x, 2)))
    return fd.depth_to_space(x, 2)

  def forward(self, z: torch.Tensor) -> torch.Tensor:
    if not self.fused or isinstance(self.base_act, PReLU):
      base = self.base_conv(z)
      if self.base_act is not None:
        base = self.base_act(base)
      return self.out_conv(base + self._res(z))
    s1, c = self.strides[0], self.channels[0]
    kernel_br = torch.cat([self.base_conv.kernel, self.res_conv.kernel], dim=-1)
    bias_br = torch.cat([self.base_conv.bias, self.res_conv.bias], dim=-1)
    both_p = fd.phase_conv(z, kernel_br.to(z.dtype), bias_br, s1)
    # phase layout is [.., s*s*(2c)] with the 2c split innermost.
    lead = both_p.shape[:-1]
    both = both_p.reshape(lead + (s1 * s1, 2 * c))
    base_p = both[..., :c].reshape(lead + (s1 * s1 * c,))
    res_p = both[..., c:].reshape(lead + (s1 * s1 * c,))
    mid_p = _apply_act_phase(self.base_act, base_p, s1 * s1) + res_p
    return _final_deconv_packed(mid_p, self.out_conv.kernel.to(z.dtype), self.out_conv.bias,
                                s1, self.strides[1], c)


class JPEGLikeSynthesis(nn.Module):
  """Single-deconv synthesis: one affine map from each latent vector to a k x k
  x output_channels patch (kernel_size 18, strides 16 in the paper: patches
  overlap by 2 px).

  use_offset appends a channel of ones to the latents (the conv then has
  C + 1 inputs). use_pallas sends kernel_size == strides to the
  jpegl_synthesize kernel (ops/jpegl_decode.py) with the conv's own
  parameters, so `conv/kernel` and `conv/bias` load the same on both routes.
  """

  def __init__(self, in_features: int, output_channels: int = 3, kernel_size: int = 16,
               strides: int = 16, padding: str = "SAME", use_bias: bool = True,
               use_offset: bool = False, use_pallas: bool = False):
    super().__init__()
    if padding != "SAME":
      raise NotImplementedError(f"padding {padding!r} is not ported")
    self.upsample_factor = strides
    self.output_depth = output_channels
    self.use_offset = use_offset
    self.kernel_route = use_pallas and kernel_size == strides
    self.conv = FastConvTranspose(in_features + int(use_offset), output_channels, kernel_size,
                                  strides, use_bias=use_bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.use_offset:
      x = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], -1)
    if self.kernel_route:
      return jpegl_synthesize(x.contiguous(), self.conv.kernel, self.conv.bias)
    return self.conv(x)


class JPEGLikeHyperSynthesis(nn.Module):
  """JPEG-like hyper-decoder: one k6s4 deconv to 2 * bottleneck channels (mu, scale)."""

  upsample_factor = 4

  def __init__(self, in_features: int, bottleneck_size: int, kernel_size: int = 6):
    super().__init__()
    self.output_depth = bottleneck_size * 2
    self.conv = FastConvTranspose(in_features, bottleneck_size * 2, kernel_size, 4)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.conv(x)


def build_transform(cfg: dict, in_features: int, **extra) -> nn.Module:
  """Instantiate a transform from a {'cls': name, **kwargs} config dict, by
  the JAX package's class names (models/transforms.py:956-976)."""
  from shallow_ntc_tpu_torch.models.elic import ElicAnalysis, ElicSynthesis

  cfg = dict(cfg)
  name = cfg.pop("cls")
  cls = {c.__name__: c for c in (
      BLS2017Analysis, BLS2017Synthesis, CNNAnalysis, CNNSynthesis, HyperAnalysis,
      HyperSynthesis, MBT2018Analysis, MBT2018Synthesis, HyperAnalysisSmall,
      HyperSynthesisSmall, ElicAnalysis, ElicSynthesis, JPEGLikeSynthesis, TwoLayerSynthesis,
      TwoLayerResSynthesis, JPEGLikeHyperSynthesis)}.get(name)
  if cls is None:
    raise KeyError(f"Unknown class {name!r}")
  return cls(in_features, **{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg.items()}, **extra)
