"""ELIC residual-block chain: CUDA kernel and plain version.

fused_rb_chain(x, params) runs N residual blocks, each
x + 1x1(relu(3x3_SAME(relu(1x1 x)))) with C -> C/2 -> C/2 -> C, on NHWC x.
params holds per block (w1 [C, C/2], b1, w2 [3, 3, C/2, C/2], b2,
w3 [C/2, C], b3) in the flax layout. It replaces
shallow_ntc_tpu/ops/pallas/rb_chain.py:fused_rb_chain (without `keep_pad`,
which no caller uses).

On a CUDA tensor the forward pass launches the hand-written kernel of
csrc/rb_chain.cu once per block (one fused kernel per block: the whole
chain does not fit one CTA's shared memory at these widths) or raises; on a
CPU tensor it runs the plain version, dense_rb_chain (cuDNN's convs on the
card). The backward pass recomputes through the plain version's autograd,
as the JAX custom VJP goes through dense_rb_chain. STATS counts one launch
per chain (its N block kernels).
"""

import ctypes
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from shallow_ntc_tpu_torch.ops import cuda_build

SOURCE = "rb_chain.cu"
MAX_HIDDEN = 160  # C/2 <= 160: the kernel's register tile (csrc/rb_chain.cu kMaxRN)
STATS = cuda_build.KernelStats("fused_rb_chain")
_SYMBOLS = {torch.float32: "rb_block_f32", torch.bfloat16: "rb_block_bf16"}

BlockParams = Tuple[torch.Tensor, ...]  # (w1, b1, w2, b2, w3, b3)


def _kernel_fn(dtype):
  fn = getattr(cuda_build.load(SOURCE), _SYMBOLS[dtype])
  fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


def dense_resblock(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
  """The plain version of one block, with the kernels' rounding: weights
  rounded to x's dtype, float32 biases and accumulation, and h1, h2 and the
  residual h3 rounded to x's dtype after their bias (as the Pallas kernel,
  shallow_ntc_tpu/ops/pallas/rb_chain.py:129-166). In float32 every
  rounding is the identity."""
  dt = x.dtype

  def conv(h, w, b, padding=0):
    out = F.conv2d(h, w.to(dt).float(), b.float(), padding=padding)
    return out.to(dt).float()

  xn = x.permute(0, 3, 1, 2).float()
  h = torch.relu(conv(xn, w1.t()[:, :, None, None], b1))
  h = torch.relu(conv(h, w2.permute(3, 2, 0, 1), b2, padding=1))
  h = conv(h, w3.t()[:, :, None, None], b3).to(dt)
  return x + h.permute(0, 2, 3, 1)


def dense_rb_chain(x: torch.Tensor, params: Sequence[BlockParams]) -> torch.Tensor:
  """The plain version of the chain (the CPU path and the backward pass)."""
  for p in params:
    x = dense_resblock(x, *p)
  return x


def block_cuda(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
  """Launch the one-block kernel on PyTorch's current stream; raise on what it
  does not take. Counts nothing: the public wrappers count."""
  if not x.is_cuda:
    raise ValueError(f"the residual-block kernel needs a CUDA tensor, got {x.device}")
  if x.dtype not in _SYMBOLS:
    raise TypeError(f"the residual-block kernel takes float32 or bfloat16, got {x.dtype}")
  if x.ndim != 4 or not x.is_contiguous():
    raise ValueError(f"x must be a contiguous [B, H, W, C] tensor, got {tuple(x.shape)}")
  c = x.shape[-1]
  ch = w1.shape[-1]
  shapes = ((w1, (c, ch)), (b1, (ch,)), (w2, (3, 3, ch, ch)), (b2, (ch,)), (w3, (ch, c)),
            (b3, (c,)))
  for t, shape in shapes:
    if tuple(t.shape) != shape:
      raise ValueError(f"block parameter of shape {tuple(t.shape)}, expected {shape}")
    if t.device != x.device:
      raise ValueError("x and the block parameters must be on one device")
  if not 1 <= ch <= MAX_HIDDEN:
    raise ValueError(f"the kernel takes C/2 in [1, {MAX_HIDDEN}], got {ch}")
  # Weights rounded to x's dtype, biases kept in float32 (the Pallas contract).
  w = [(t.detach() if i % 2 else t.detach().to(x.dtype)).float().contiguous()
       for i, (t, _) in enumerate(shapes)]
  out = torch.empty_like(x)
  b, h, wd, _ = x.shape
  stream = torch.cuda.current_stream(x.device).cuda_stream
  rc = _kernel_fn(x.dtype)(x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(),
                           b, h, wd, c, ch, stream)
  if rc != 0:
    raise RuntimeError(f"residual-block kernel launch failed: CUDA error {rc}")
  return out


def rb_chain_cuda(x: torch.Tensor, params: Sequence[BlockParams]) -> torch.Tensor:
  """The chain on the card: one kernel launch per block; counts one chain."""
  if not params:
    raise ValueError("fused_rb_chain needs at least one block")
  for p in params:
    x = block_cuda(x, *p)
  STATS.launches += 1
  return x


def _blocks(flat: Sequence[torch.Tensor]) -> Tuple[BlockParams, ...]:
  return tuple(tuple(flat[i : i + 6]) for i in range(0, len(flat), 6))


class FusedBlocks(torch.autograd.Function):
  """Forward through `cuda_fn` on the card (the plain version on the CPU);
  backward through the plain version's autograd. Gradients for x and for
  every weight and bias."""

  @staticmethod
  def forward(ctx, cuda_fn: Callable, x, *flat):
    ctx.save_for_backward(x, *flat)
    if x.device.type == "cpu":
      return dense_rb_chain(x, _blocks(flat))
    return cuda_fn(x, _blocks(flat))

  @staticmethod
  def backward(ctx, g):
    saved = [t.detach().requires_grad_(need)
             for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
    wanted = [t for t in saved if t.requires_grad]
    with torch.enable_grad():
      y = dense_rb_chain(saved[0], _blocks(saved[1:]))
      grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
    return (None,) + tuple(next(grads) if t.requires_grad else None for t in saved)


def fused_rb_chain(x: torch.Tensor, params: Sequence[BlockParams]) -> torch.Tensor:
  """x [B, H, W, C] through len(params) residual blocks; differentiable."""
  flat = [t for p in params for t in p]
  if len(flat) != 6 * len(params) or not params:
    raise ValueError("params must be a non-empty sequence of (w1, b1, w2, b2, w3, b3)")
  return FusedBlocks.apply(rb_chain_cuda, x, *flat)
