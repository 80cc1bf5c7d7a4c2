"""ELIC analysis transform (mirrors shallow_ntc_tpu/models/elic.py).

Child names are the flax ones (Conv_N, ResidualBlock_N, SimpleAttention_N),
so the flax parameter paths are the state-dict keys.
"""

from typing import Tuple

import torch
from torch import nn

from shallow_ntc_tpu_torch.models.transforms import Conv


class ResidualBlock(nn.Module):
  """Cheng-2020 residual block: x + 1x1(relu(3x3(relu(1x1 x)))), C -> C/2 -> C/2 -> C."""

  def __init__(self, features: int):
    super().__init__()
    c = features
    self.Conv_0 = Conv(c, c // 2, 1, 1)
    self.Conv_1 = Conv(c // 2, c // 2, 3, 1)
    self.Conv_2 = Conv(c // 2, c, 1, 1)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(self.Conv_0(x))
    h = torch.relu(self.Conv_1(h))
    return x + self.Conv_2(h)


class SimpleAttention(nn.Module):
  """Cheng-2020 simplified attention: x + trunk(x) * sigmoid(Conv_0(branch(x)))."""

  def __init__(self, features: int):
    super().__init__()
    for i in range(6):
      setattr(self, f"ResidualBlock_{i}", ResidualBlock(features))
    self.Conv_0 = Conv(features, features, 1, 1)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    trunk = x
    for i in range(3):
      trunk = getattr(self, f"ResidualBlock_{i}")(trunk)
    branch = x
    for i in range(3, 6):
      branch = getattr(self, f"ResidualBlock_{i}")(branch)
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
    # (kind, name) in flax creation order.
    self._order = []
    counts = {"Conv": 0, "ResidualBlock": 0, "SimpleAttention": 0}
    c = in_features

    def add(kind, module):
      name = f"{kind}_{counts[kind]}"
      counts[kind] += 1
      setattr(self, name, module)
      self._order.append(name)

    def conv(i):
      nonlocal c
      add("Conv", Conv(c, channels[i], kernel_sizes[i], strides[i]))
      c = channels[i]

    def res_blocks():
      for _ in range(num_residual_blocks):
        add("ResidualBlock", ResidualBlock(c))

    n = len(channels)
    if n == 4:
      conv(0)
      res_blocks()
    conv(n - 3)
    res_blocks()
    add("SimpleAttention", SimpleAttention(c))
    conv(n - 2)
    res_blocks()
    conv(n - 1)
    add("SimpleAttention", SimpleAttention(c))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for name in self._order:
      x = getattr(self, name)(x)
    return x
