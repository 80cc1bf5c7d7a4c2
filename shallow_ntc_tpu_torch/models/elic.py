"""ELIC analysis transform (mirrors shallow_ntc_tpu/models/elic.py).

Child names are the flax ones (Conv_N, ResidualBlock_N, SimpleAttention_N),
so the flax parameter paths are the state-dict keys.

The residual blocks route as the JAX package routes them, by the same
switches read at call time (elic.py:78-155):
  SNTC_FUSED_RB_CHAIN=1  every chain of consecutive blocks goes through
                         ops/rb_chain.fused_rb_chain;
  SNTC_FUSED_RESBLOCK=1  (chain off) each block goes through
                         ops/resblock.fused_resblock.
Both are off by default: the blocks then run as three cuDNN convolutions.
"""

import os
from typing import Sequence, Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.models.transforms import Conv
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


class ElicAnalysis(nn.Module):
  """ELIC (He 2022) analysis transform; paper channels (192, 192, 192, 320).

  For 4 conv layers: conv0, RBs, conv1, RBs, attention, conv2, RBs, conv3,
  attention (3 layers drop the first conv and its RBs).
  """

  def __init__(self, in_features: int, channels: Tuple[int, ...] = (128, 160, 192, 192),
               kernel_sizes: Tuple[int, ...] = (5, 5, 5, 5),
               strides: Tuple[int, ...] = (2, 2, 2, 2), num_residual_blocks: int = 3):
    super().__init__()
    if len(channels) not in (3, 4) or not len(channels) == len(kernel_sizes) == len(strides):
      raise ValueError(f"ELIC uses 3 or 4 conv layers (not {channels}).")
    self.downsample_factor = 2 ** len(channels)
    self.output_depth = channels[-1]
    # Stages in flax creation order: a child name, or a tuple of the names
    # of one chain of residual blocks.
    self._order = []
    counts = {"Conv": 0, "ResidualBlock": 0, "SimpleAttention": 0}
    c = in_features

    def add(kind, module):
      name = f"{kind}_{counts[kind]}"
      counts[kind] += 1
      setattr(self, name, module)
      return name

    def conv(i):
      nonlocal c
      self._order.append(add("Conv", Conv(c, channels[i], kernel_sizes[i], strides[i])))
      c = channels[i]

    def res_blocks():
      self._order.append(tuple(add("ResidualBlock", ResidualBlock(c))
                               for _ in range(num_residual_blocks)))

    def attention():
      self._order.append(add("SimpleAttention", SimpleAttention(c)))

    n = len(channels)
    if n == 4:
      conv(0)
      res_blocks()
    conv(n - 3)
    res_blocks()
    attention()
    conv(n - 2)
    res_blocks()
    conv(n - 1)
    attention()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for stage in self._order:
      if isinstance(stage, tuple):
        x = run_rb_chain([getattr(self, name) for name in stage], x)
      else:
        x = getattr(self, stage)(x)
    return x
