"""ELIC residual-block chain: CUDA kernel and plain version.

fused_rb_chain_padded(x, params, keep_pad) runs N residual blocks, each
x + 1x1(relu(3x3_SAME(relu(1x1 x)))) with C -> C/2 -> C/2 -> C, on NHWC x.
params holds per block (w1 [C, C/2], b1, w2 [3, 3, C/2, C/2], b2,
w3 [C/2, C], b3) in the flax layout. With keep_pad the result is
[B, H, W + 2N, C]: the chain's output in columns [N, N + W) and zeros in the
N columns on each side (the Pallas kernel leaves those as they are, its
dense route zero-pads; here they are zeros on every route). fused_rb_chain
is keep_pad=False. They replace shallow_ntc_tpu/ops/pallas/rb_chain.py's
fused_rb_chain_padded and fused_rb_chain; the activation is relu, the only
one the models use, so there is no `act_name`.

On a CUDA tensor the forward pass launches the hand-written kernel of
csrc/rb_chain.cu once per block (one fused kernel per block: the whole
chain does not fit one CTA's shared memory at these widths) or raises; with
keep_pad the last block stores its rows straight into the padded output,
allocated by torch.zeros. On a CPU tensor it runs the plain version,
dense_rb_chain (cuDNN's convs on the card), zero-padded for keep_pad. The
backward pass recomputes through the plain version's autograd, as the JAX
custom VJP goes through dense_rb_chain. STATS counts one launch per chain
(its N block kernels).
"""

import ctypes
import functools
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.utils import profiling

SOURCE = "rb_chain.cu"
MAX_HIDDEN = 160  # C/2 <= 160: the kernel's register tile (csrc/rb_chain.cu, RN <= 5)
SLAB_K = 32  # rows of a packed weight slab (csrc/rb_chain.cu kSlabK)
STATS = cuda_build.KernelStats("fused_rb_chain")
_SYMBOLS = {torch.float32: "rb_block_f32", torch.bfloat16: "rb_block_bf16"}

BlockParams = Tuple[torch.Tensor, ...]  # (w1, b1, w2, b2, w3, b3)


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype):
  fn = getattr(cuda_build.load(SOURCE), _SYMBOLS[dtype])
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


def _ceil(a: int, b: int) -> int:
  return -(-a // b)


def slab_layout(c: int, ch: int) -> Tuple[int, int, int, int, int]:
  """(ldn, s1, s2, passes, s3) of the packed weights: a slab row holds
  ldn = 32 RN + 8 floats (RN = ceil(ch / 32)); w1 takes s1 slabs, w2 s2
  (rows tap * ch8 + channel), and w3 `passes` column passes of 32 RN columns
  of s3 slabs each (csrc/rb_chain.cu, Slabs)."""
  rn, ch8 = _ceil(ch, 32), 8 * _ceil(ch, 8)
  return (32 * rn + 8, _ceil(c, SLAB_K), _ceil(9 * ch8, SLAB_K), _ceil(c, 32 * rn),
          _ceil(ch8, SLAB_K))


@functools.lru_cache(maxsize=None)
def _slab_index(c: int, ch: int, device: torch.device) -> torch.Tensor:
  """Where each packed entry comes from in [0, w1, w2, w3] flattened (0 for
  padding): the positions 1, 2, ... laid out in slabs, once per shape."""
  ldn, s1, s2, passes, s3 = slab_layout(c, ch)
  width, ch8 = ldn - 8, 8 * _ceil(ch, 8)
  sizes = (c * ch, 9 * ch * ch, ch * c)
  w1, w2, w3 = torch.arange(1, sum(sizes) + 1, dtype=torch.float64).split(sizes)

  def pad(m, rows, cols):
    return F.pad(m, (0, cols - m.shape[-1], 0, rows - m.shape[-2]))

  p1 = pad(w1.view(c, ch), SLAB_K * s1, ldn)
  p2 = pad(pad(w2.view(9, ch, ch), ch8, ch).reshape(9 * ch8, ch), SLAB_K * s2, ldn)
  p3 = pad(pad(w3.view(ch, c), SLAB_K * s3, passes * width).reshape(SLAB_K * s3, passes, width)
           .transpose(0, 1), SLAB_K * s3, ldn).reshape(-1, ldn)
  return torch.cat([p1, p2, p3]).long().to(device)


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
  """w1 [C, Ch], w2 [3, 3, Ch, Ch], w3 [Ch, C], rounded to dtype, as the
  kernel's float32 stream of [SLAB_K, ldn] slabs: w1's rows, then w2's
  (tap, channel) rows, then w3 pass by pass; zero wherever no weight lies.
  One gather, so that packing costs a few launches per block."""
  flat = torch.cat([w1.new_zeros(1), w1.reshape(-1), w2.reshape(-1), w3.reshape(-1)])
  return flat.detach().to(dtype).float()[_slab_index(*w1.shape, w1.device)]


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


def pad_width(y: torch.Tensor, pad: int) -> torch.Tensor:
  """y [B, H, W, C] with `pad` zero columns on each side of W."""
  return F.pad(y, (0, 0, pad, pad)) if pad else y


def block_cuda(x: torch.Tensor, w1, b1, w2, b2, w3, b3, pad: int = 0) -> torch.Tensor:
  """Launch the one-block kernel on PyTorch's current stream; raise on what it
  does not take. With pad > 0 the result is [B, H, W + 2 pad, C], the block's
  output in columns [pad, pad + W) and zeros elsewhere. Counts nothing: the
  public wrappers count."""
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
  wp = pack_weights(w1, w2, w3, x.dtype)
  biases = [t.detach().float().contiguous() for t in (b1, b2, b3)]
  b, h, wd, _ = x.shape
  out = x.new_zeros(b, h, wd + 2 * pad, c) if pad else torch.empty_like(x)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  rc = _kernel_fn(x.dtype)(x.data_ptr(), wp.data_ptr(), *(t.data_ptr() for t in biases),
                           out.data_ptr(), b, h, wd, c, ch, out.shape[2], pad, stream)
  if rc != 0:
    raise RuntimeError(f"residual-block kernel launch failed: CUDA error {rc}")
  return out


def rb_chain_cuda(x: torch.Tensor, params: Sequence[BlockParams],
                  keep_pad: bool = False) -> torch.Tensor:
  """The chain on the card: one kernel launch per block, the last one into
  the padded output with keep_pad; counts one chain."""
  if not params:
    raise ValueError("fused_rb_chain needs at least one block")
  n = len(params)
  for i, p in enumerate(params):
    x = block_cuda(x, *p, pad=n if keep_pad and i == n - 1 else 0)
  STATS.launches += 1
  return x


def _blocks(flat: Sequence[torch.Tensor]) -> Tuple[BlockParams, ...]:
  return tuple(tuple(flat[i : i + 6]) for i in range(0, len(flat), 6))


class FusedBlocks(torch.autograd.Function):
  """Forward through `cuda_fn` on the card (the plain version on the CPU),
  with `pad` zero columns on each side of W (cuda_fn writes them itself);
  backward through the plain version's autograd, of g's interior columns.
  Gradients for x and for every weight and bias."""

  @staticmethod
  def forward(ctx, cuda_fn: Callable, pad: int, x, *flat):
    ctx.save_for_backward(x, *flat)
    ctx.pad = pad
    if x.device.type == "cpu":
      return pad_width(dense_rb_chain(x, _blocks(flat)), pad)
    return cuda_fn(x, _blocks(flat))

  @staticmethod
  def backward(ctx, g):
    if ctx.pad:
      g = g[:, :, ctx.pad : g.shape[2] - ctx.pad]
    saved = [t.detach().requires_grad_(need)
             for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
    wanted = [t for t in saved if t.requires_grad]
    with torch.enable_grad():
      y = dense_rb_chain(saved[0], _blocks(saved[1:]))
      grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
    return (None, None) + tuple(next(grads) if t.requires_grad else None for t in saved)


def flops(x_shape: Sequence[int], hidden: int, n_blocks: int = 1) -> int:
  """Model FLOPs of n_blocks residual blocks on x [B, H, W, C], C/2 = hidden:
  2 B H W C hidden for each 1x1 conv, and the 3x3 SAME conv's 2 hidden^2
  per tap that lands inside the image (padding is no work)."""
  b, h, w, c = x_shape
  return n_blocks * (4 * b * h * w * c * hidden
                     + profiling.conv_flops((b, h, w, hidden), hidden, 3, 1))


def fused_rb_chain_padded(x: torch.Tensor, params: Sequence[BlockParams],
                          keep_pad: bool = False) -> torch.Tensor:
  """x [B, H, W, C] through N = len(params) residual blocks; differentiable.
  Returns [B, H, W, C], or with keep_pad [B, H, W + 2N, C] with zeros in the
  N columns on each side of the chain's output."""
  flat = [t for p in params for t in p]
  if len(flat) != 6 * len(params) or not params:
    raise ValueError("params must be a non-empty sequence of (w1, b1, w2, b2, w3, b3)")
  pad = len(params) if keep_pad else 0
  with profiling.counted(lambda: flops(x.shape, params[0][0].shape[-1], len(params))):
    return FusedBlocks.apply(functools.partial(rb_chain_cuda, keep_pad=keep_pad), pad, x, *flat)


def fused_rb_chain(x: torch.Tensor, params: Sequence[BlockParams]) -> torch.Tensor:
  """x [B, H, W, C] through len(params) residual blocks; differentiable."""
  return fused_rb_chain_padded(x, params, False)
