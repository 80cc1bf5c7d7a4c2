"""ELIC transforms (mirrors shallow_ntc_tpu/models/elic.py): the analysis and
the synthesis.

Child names are the flax ones (Conv_N, FastConvTranspose_N, ResidualBlock_N,
SimpleAttention_N), so the flax parameter paths are the state-dict keys.

The residual blocks route as the JAX package routes them, by the same
switches read at call time (elic.py:78-155), in this order of precedence:
  SNTC_FUSED_RB_CHAIN=1  every chain of consecutive blocks goes through
                         ops/rb_chain.fused_rb_chain;
  SNTC_FUSED_RESBLOCK=1  (chain off) each block goes through
                         ops/resblock.fused_resblock;
  SNTC_INT8_ENCODE=1     (both off) the block's stride-1 convs of C_in >= 32
                         run on int8 operands (models/transforms.Conv).
So a kernel takes its blocks' convs away from the int8 encode gate, as in
JAX. All are off by default: the blocks then run as three cuDNN convolutions.
"""

import os
from typing import Sequence, Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.models.transforms import Conv, FastConvTranspose
from shallow_ntc_tpu_torch.ops import rb_chain
from shallow_ntc_tpu_torch.ops import resblock


class ResidualBlock(nn.Module):
  """Cheng-2020 residual block: x + 1x1(relu(3x3(relu(1x1 x)))), C -> C/2 -> C/2 -> C."""

  def __init__(self, features: int):
    super().__init__()
    c = features
    self.Conv_0 = Conv(c, c // 2, 1, 1)
    self.Conv_1 = Conv(c // 2, c // 2, 3, 1)
    self.Conv_2 = Conv(c // 2, c, 1, 1)

  def fused_params(self) -> Tuple[torch.Tensor, ...]:
    """(w1 [C, C/2], b1, w2 [3, 3, C/2, C/2], b2, w3 [C/2, C], b3) for the kernels."""
    return (self.Conv_0.kernel[0, 0], self.Conv_0.bias, self.Conv_1.kernel, self.Conv_1.bias,
            self.Conv_2.kernel[0, 0], self.Conv_2.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if os.environ.get("SNTC_FUSED_RESBLOCK") == "1":
      return resblock.fused_resblock(x.contiguous(), *self.fused_params())
    h = torch.relu(self.Conv_0(x))
    h = torch.relu(self.Conv_1(h))
    return x + self.Conv_2(h)


def run_rb_chain(blocks: Sequence[ResidualBlock], x: torch.Tensor) -> torch.Tensor:
  """Consecutive residual blocks: the fused chain kernel under
  SNTC_FUSED_RB_CHAIN=1, else block by block."""
  if blocks and os.environ.get("SNTC_FUSED_RB_CHAIN", "0") == "1":
    return rb_chain.fused_rb_chain(x.contiguous(), [b.fused_params() for b in blocks])
  for block in blocks:
    x = block(x)
  return x


class SimpleAttention(nn.Module):
  """Cheng-2020 simplified attention: x + trunk(x) * sigmoid(Conv_0(branch(x)))."""

  def __init__(self, features: int):
    super().__init__()
    for i in range(6):
      setattr(self, f"ResidualBlock_{i}", ResidualBlock(features))
    self.Conv_0 = Conv(features, features, 1, 1)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    trunk = run_rb_chain([getattr(self, f"ResidualBlock_{i}") for i in range(3)], x)
    branch = run_rb_chain([getattr(self, f"ResidualBlock_{i}") for i in range(3, 6)], x)
    return x + trunk * torch.sigmoid(self.Conv_0(branch))


class _ElicStages(nn.Module):
  """A stack of ELIC stages in flax creation order: each stage is a child
  name, or a tuple of the names of one chain of residual blocks."""

  def __init__(self, in_features: int, channels: Tuple[int, ...],
               kernel_sizes: Tuple[int, ...], strides: Tuple[int, ...]):
    super().__init__()
    if len(channels) not in (3, 4) or not len(channels) == len(kernel_sizes) == len(strides):
      raise ValueError(f"ELIC uses 3 or 4 conv layers (not {channels}).")
    self._order = []
    self._counts = {}
    self._c = in_features
    self._layers = tuple(zip(channels, kernel_sizes, strides))
    self.output_depth = channels[-1]

  def _add(self, kind: str, module: nn.Module):
    name = f"{kind}_{self._counts.get(kind, 0)}"
    self._counts[kind] = self._counts.get(kind, 0) + 1
    setattr(self, name, module)
    return name

  def _conv(self, i: int, transpose: bool = False):
    c, k, s = self._layers[i]
    maker = FastConvTranspose if transpose else Conv
    self._order.append(self._add(maker.__name__, maker(self._c, c, k, s)))
    self._c = c

  def _res_blocks(self, n: int):
    self._order.append(tuple(self._add("ResidualBlock", ResidualBlock(self._c))
                             for _ in range(n)))

  def _attention(self):
    self._order.append(self._add("SimpleAttention", SimpleAttention(self._c)))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for stage in self._order:
      if isinstance(stage, tuple):
        x = run_rb_chain([getattr(self, name) for name in stage], x)
      else:
        x = getattr(self, stage)(x)
    return x


class ElicAnalysis(_ElicStages):
  """ELIC (He 2022) analysis transform; paper channels (192, 192, 192, 320).

  For 4 conv layers: conv0, RBs, conv1, RBs, attention, conv2, RBs, conv3,
  attention (3 layers drop the first conv and its RBs).
  """

  def __init__(self, in_features: int, channels: Tuple[int, ...] = (128, 160, 192, 192),
               kernel_sizes: Tuple[int, ...] = (5, 5, 5, 5),
               strides: Tuple[int, ...] = (2, 2, 2, 2), num_residual_blocks: int = 3):
    super().__init__(in_features, channels, kernel_sizes, strides)
    self.downsample_factor = 2 ** len(channels)
    n = len(channels)
    if n == 4:
      self._conv(0)
      self._res_blocks(num_residual_blocks)
    self._conv(n - 3)
    self._res_blocks(num_residual_blocks)
    self._attention()
    self._conv(n - 2)
    self._res_blocks(num_residual_blocks)
    self._conv(n - 1)
    self._attention()


class ElicSynthesis(_ElicStages):
  """ELIC synthesis transform (elic.py:238-296), default channels (192, 160,
  128, 3), k5s2 deconvs: attention, deconv0, RBs, deconv1, attention, RBs,
  deconv2, and for 4 layers RBs and deconv3. No config of either package
  uses it."""

  def __init__(self, in_features: int, channels: Tuple[int, ...] = (192, 160, 128, 3),
               kernel_sizes: Tuple[int, ...] = (5, 5, 5, 5),
               strides: Tuple[int, ...] = (2, 2, 2, 2), num_residual_blocks: int = 3):
    super().__init__(in_features, channels, kernel_sizes, strides)
    self.upsample_factor = 2 ** len(channels)
    self._attention()
    self._conv(0, transpose=True)
    self._res_blocks(num_residual_blocks)
    self._conv(1, transpose=True)
    self._attention()
    self._res_blocks(num_residual_blocks)
    self._conv(2, transpose=True)
    if len(channels) == 4:
      self._res_blocks(num_residual_blocks)
      self._conv(3, transpose=True)
