"""One ELIC residual block as one kernel: the N=1 case of ops/rb_chain.py.

fused_resblock(x, w1, b1, w2, b2, w3, b3) computes
x + 1x1(relu(3x3_SAME(relu(1x1 x)))). It replaces
shallow_ntc_tpu/ops/pallas/resblock.py:fused_resblock, and launches the
same CUDA kernel (csrc/rb_chain.cu) as the chain, under its own launch
count. On a CPU tensor it runs the plain version, _dense_resblock; the
backward pass goes through that plain version's autograd.
"""

import torch

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.ops import rb_chain

SOURCE = rb_chain.SOURCE
STATS = cuda_build.KernelStats("fused_resblock")
_dense_resblock = rb_chain.dense_resblock


def fused_resblock_cuda(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
  """Launch the one-block kernel and count it."""
  out = rb_chain.block_cuda(x, w1, b1, w2, b2, w3, b3)
  STATS.launches += 1
  return out


def _one_block(x, params):
  (block,) = params
  return fused_resblock_cuda(x, *block)


def fused_resblock(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
  """x [B, H, W, C], w1 [C, C/2], w2 [3, 3, C/2, C/2], w3 [C/2, C]; differentiable."""
  return rb_chain.FusedBlocks.apply(_one_block, x, w1, b1, w2, b2, w3, b3)
