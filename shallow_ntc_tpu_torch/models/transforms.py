"""Transforms of the flagship model (mirrors shallow_ntc_tpu/models/transforms.py).

Every module takes and returns NHWC tensors and keeps its parameters in the
flax layout under the flax names (`kernel` [k, k, C_in, C_out], `bias`,
GDN's `beta`/`gamma`), so a flax parameter tree loads one to one
(shallow_ntc_tpu_torch/params.py). Convolutions run in the input's dtype.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shallow_ntc_tpu_torch.ops import fast_deconv as fd
from shallow_ntc_tpu_torch.ops.math import lower_bound
from shallow_ntc_tpu_torch.ops.twolayer_final import final_deconv_phase

_GDN_PEDESTAL = 2.0**-18


def _nonneg(param: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
  """tfc GDNParameter reparameterization: value = max(p, bound)^2 - pedestal."""
  bound = math.sqrt(minimum + _GDN_PEDESTAL)
  return torch.square(lower_bound(param, bound)) - _GDN_PEDESTAL


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
  """lax SAME padding (low, high) of a stride-s conv over n samples."""
  total = max((-(-n // s) - 1) * s + k - n, 0)
  return total // 2, total - total // 2


class Conv(nn.Module):
  """SAME strided conv with a flax [k, k, C_in, C_out] kernel.

  lax SAME pads the high side more when the total padding is odd, which
  torch's symmetric `padding=` cannot express, so odd cases pad explicitly.
  """

  def __init__(self, in_features: int, features: int, kernel_size: int, stride: int):
    super().__init__()
    self.stride = stride
    self.kernel = nn.Parameter(torch.zeros(kernel_size, kernel_size, in_features, features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    k, s = self.kernel.shape[0], self.stride
    xn = x.permute(0, 3, 1, 2)
    h_lo, h_hi = _same_pads(x.shape[1], k, s)
    w_lo, w_hi = _same_pads(x.shape[2], k, s)
    weight = self.kernel.to(x.dtype).permute(3, 2, 0, 1)
    if h_lo == h_hi and w_lo == w_hi:
      out = F.conv2d(xn, weight, self.bias.to(x.dtype), s, padding=(h_lo, w_lo))
    else:
      out = F.conv2d(F.pad(xn, (w_lo, w_hi, h_lo, h_hi)), weight, self.bias.to(x.dtype), s)
    return out.permute(0, 2, 3, 1)


class FastConvTranspose(nn.Module):
  """SAME transposed conv with a flax [k, k, C_in, C_out] kernel (flax ConvTranspose)."""

  def __init__(self, in_features: int, features: int, kernel_size: int, stride: int):
    super().__init__()
    self.stride = stride
    self.kernel = nn.Parameter(torch.zeros(kernel_size, kernel_size, in_features, features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return fd.fast_conv_transpose(x, self.kernel, self.bias, self.stride)


class GDN(nn.Module):
  """GDN1 (Johnston 2018): y = x / (beta + |x| @ gamma), or x * (...) if inverse."""

  def __init__(self, channels: int, inverse: bool = False):
    super().__init__()
    self.inverse = inverse
    self.beta = nn.Parameter(torch.zeros(channels))
    self.gamma = nn.Parameter(torch.zeros(channels, channels))

  def effective_params(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(beta, gamma) after the nonnegative reparameterization."""
    return _nonneg(self.beta, 1e-6).to(dtype), _nonneg(self.gamma, 0.0).to(dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    beta, gamma = self.effective_params(x.dtype)
    norm = torch.abs(x) @ gamma + beta
    return x * norm if self.inverse else x / norm


def make_activation(name: Optional[str], channels: int):
  """relu, GDN1 or IGDN1: the activations of the flagship's transforms."""
  if name is None:
    return None
  lowered = name.lower()
  if lowered == "relu":
    return nn.ReLU()
  if lowered in ("gdn", "gdn1"):
    return GDN(channels)
  if lowered in ("igdn", "igdn1"):
    return GDN(channels, inverse=True)
  raise NotImplementedError(f"activation {name!r} is not ported yet")


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
    return fd.gdn_phase(x_p, beta, gamma, num_phases, act.inverse)
  return act(x_p)  # pointwise activations are phase-agnostic


class TwoLayerResSynthesis(nn.Module):
  """Two-layer synthesis with a parallel residual deconv (res_type="conv").

  out_conv(act(base_conv(z)) + res_conv(z)). The fused form keeps the mid
  activation in s1 phase space: base and residual run as one phase conv, the
  (I)GDN and the sum apply per phase, and the final k5s2 deconv reads the
  phase tensor directly (final_deconv_phase).
  """

  def __init__(self, in_features: int, channels: Tuple[int, int] = (12, 3),
               strides: Tuple[int, int] = (8, 2), kernel_sizes: Tuple[int, int] = (13, 5),
               activation_type: str = "igdn", res_type: str = "conv", fused: bool = True):
    super().__init__()
    if res_type != "conv":
      raise NotImplementedError(f"res_type {res_type!r} is not ported yet")
    self.channels = tuple(channels)
    self.strides = tuple(strides)
    self.fused = fused
    c, s1 = channels[0], strides[0]
    self.base_conv = FastConvTranspose(in_features, c, kernel_sizes[0], s1)
    self.base_act = make_activation(activation_type, c)
    self.res_conv = FastConvTranspose(in_features, c, kernel_sizes[0], s1)
    self.out_conv = FastConvTranspose(c, channels[1], kernel_sizes[1], strides[1])

  def forward(self, z: torch.Tensor) -> torch.Tensor:
    if not self.fused:
      base = self.base_conv(z)
      if self.base_act is not None:
        base = self.base_act(base)
      return self.out_conv(base + self.res_conv(z))
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


def build_transform(cfg: dict, in_features: int, **extra) -> nn.Module:
  """Instantiate a ported transform from a {'cls': name, **kwargs} config dict."""
  from shallow_ntc_tpu_torch.models.elic import ElicAnalysis

  cfg = dict(cfg)
  name = cfg.pop("cls")
  cls = {c.__name__: c for c in (ElicAnalysis, HyperAnalysis, HyperSynthesis,
                                 TwoLayerResSynthesis)}.get(name)
  if cls is None:
    raise NotImplementedError(f"transform {name} is not ported yet")
  return cls(in_features, **{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg.items()}, **extra)
