"""Final stage of the two-layer residual decoder: CUDA kernel and plain version.

final_deconv_phase(mid_p, kernel, bias, c_in) computes
conv_transpose_SAME(depth_to_space(mid_p, 8), kernel, stride=2) + bias:
mid_p [B, H, W, 64*c_in] (s1=8 phase space) -> [B, 16H, 16W, c_out].
It replaces shallow_ntc_tpu/ops/pallas/twolayer_final.py:final_deconv_phase.

On a CUDA tensor the forward pass launches the hand-written kernel in
csrc/final_deconv.cu or raises; on a CPU tensor it runs the plain version,
final_deconv_plain (the dense packed conv-transpose). The backward pass
goes through the plain version's autograd, as the JAX custom VJP goes
through the dense XLA form.

The kernel computes each mid pixel's 2x2 output quad as one row of a GEMM
against the phase-folded kernel (fold_index): K is (tap (d, e), input
channel padded to 16), N is (parity (r, s), output channel) in chunks of 4.
"""

import ctypes
import functools

import numpy as np
import torch

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.ops import fast_deconv as fd

S1 = 8        # phase factor of the mid tensor
S2 = 2        # stride of the final deconv
SP = S1 * S2  # 16
SOURCE = "final_deconv.cu"


STATS = cuda_build.KernelStats("final_deconv_phase")
_SYMBOLS = {torch.float32: "final_deconv_f32", torch.bfloat16: "final_deconv_bf16"}
MAX_K = 7      # the kernel's tap window covers d in [-2, 1]
K_PAD = 16     # input channels per tap in the GEMM (c_in <= 16)
CO_CHUNK = 4   # output channels per GEMM pass: N = 4 parities x 4


def quad_taps(k: int) -> tuple:
  """(d0, nd): the mid offsets d in [d0, 1] that a k-tap stride-2 output quad reads."""
  nd = 4 if k == 7 else 3
  return 2 - nd, nd


@functools.lru_cache(maxsize=None)
def fold_index(k: int, c_in: int, c_out: int, device=None) -> torch.Tensor:
  """The folding of a flax kernel [k, k, c_in, c_out] into the quad GEMM's B.

  int32 [ceil(c_out / 4), nd * nd, 16, 16]: chunk, tap (dy, dx) = (d - d0,
  e - d0), input channel (past c_in: zero), column (r * 2 + s) * 4 + output
  channel in the chunk. Each entry indexes kernel.flatten() at
  [p0 - r + 2d, p0 - s + 2e, ci, co], since output pixel (2X + r, 2Y + s)
  reads mid pixel (X + d, Y + e) through that tap; where the tap lies
  outside the kernel the weight is zero and the entry is k * k * c_in * c_out.
  """
  d0, nd = quad_taps(k)
  p0 = k - 1 - max(k - S2, 0) // 2
  n_chunks = -(-c_out // CO_CHUNK)
  idx = np.full((n_chunks, nd, nd, K_PAD, S2, S2, CO_CHUNK), k * k * c_in * c_out, np.int32)
  ci = np.arange(c_in)[:, None]
  co = np.arange(c_out)[None, :]
  for dy in range(nd):
    for dx in range(nd):
      for r in range(S2):
        for s in range(S2):
          th, tw = p0 - r + S2 * (d0 + dy), p0 - s + S2 * (d0 + dx)
          if 0 <= th < k and 0 <= tw < k:
            idx[co // CO_CHUNK, dy, dx, ci, r, s, co % CO_CHUNK] = (
                ((th * k + tw) * c_in + ci) * c_out + co)
  return torch.as_tensor(idx.reshape(n_chunks, nd * nd, K_PAD, S2 * S2 * CO_CHUNK),
                         device=device)


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype):
  fn = getattr(cuda_build.load(SOURCE), _SYMBOLS[dtype])
  fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def final_deconv_plain(mid_p: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       c_in: int) -> torch.Tensor:
  """The plain version: packed_conv_transpose(partial_depth_to_space(mid_p, 8, 8)),
  the weights rounded to mid_p's type, products summed and the bias added in
  float32, and one rounding to mid_p's type (as the Pallas kernel)."""
  del c_in
  out = fd.packed_conv_transpose(fd.partial_depth_to_space(mid_p, S1, S1).float(),
                                 kernel.to(mid_p.dtype).float(), None, S2, S1)
  return (out + bias.float()).to(mid_p.dtype)


def final_deconv_cuda(mid_p: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      c_in: int) -> torch.Tensor:
  """Launch the CUDA kernel on PyTorch's current stream; raise on what it does not take."""
  if not mid_p.is_cuda:
    raise ValueError(f"final_deconv_cuda needs a CUDA tensor, got {mid_p.device}")
  if mid_p.dtype not in _SYMBOLS:
    raise TypeError(f"final_deconv_cuda takes float32 or bfloat16, got {mid_p.dtype}")
  if mid_p.ndim != 4 or mid_p.shape[-1] != S1 * S1 * c_in:
    raise ValueError(f"mid_p must be [B, H, W, {S1 * S1 * c_in}], got {tuple(mid_p.shape)}")
  if not mid_p.is_contiguous():
    raise ValueError("mid_p must be contiguous")
  k = kernel.shape[0]
  if kernel.ndim != 4 or kernel.shape[1] != k or kernel.shape[2] != c_in:
    raise ValueError(f"kernel must be [k, k, {c_in}, c_out], got {tuple(kernel.shape)}")
  if not 1 <= k <= MAX_K or not 1 <= c_in <= K_PAD:
    raise ValueError(f"the kernel takes k <= {MAX_K} and c_in <= {K_PAD}, got k={k}, "
                     f"c_in={c_in}")
  if mid_p.shape[1] * mid_p.shape[2] * mid_p.shape[3] >= 2**31:
    raise ValueError("the kernel takes images of fewer than 2**31 mid values")
  c_out = kernel.shape[3]
  if bias.shape != (c_out,):
    raise ValueError(f"bias must be [{c_out}], got {tuple(bias.shape)}")
  if kernel.device != mid_p.device or bias.device != mid_p.device:
    raise ValueError("mid_p, kernel and bias must be on one device")
  b, h, w, _ = mid_p.shape
  # Weights in mid_p's type, as the plain version rounds them; the bias in
  # float32 or bfloat16 (a flag tells the kernel), added in float32. A model
  # in one type passes both on as they are, with no launch.
  w_t = kernel.detach().to(mid_p.dtype).contiguous()
  b_t = bias.detach()
  b_t = (b_t if b_t.dtype in _SYMBOLS else b_t.float()).contiguous()
  idx = fold_index(k, c_in, c_out, mid_p.device)
  out = torch.empty((b, SP * h, SP * w, c_out), dtype=mid_p.dtype, device=mid_p.device)
  stream = torch.cuda.current_stream(mid_p.device).cuda_stream
  rc = _kernel_fn(mid_p.dtype)(mid_p.data_ptr(), w_t.data_ptr(), idx.data_ptr(),
                               b_t.data_ptr(), int(b_t.dtype == torch.bfloat16),
                               out.data_ptr(), b, h, w, c_in, c_out, k, stream)
  if rc != 0:
    raise RuntimeError(f"final_deconv kernel launch failed: CUDA error {rc}")
  STATS.launches += 1
  return out


class _FinalDeconvPhase(torch.autograd.Function):

  @staticmethod
  def forward(ctx, mid_p, kernel, bias, c_in):
    ctx.save_for_backward(mid_p, kernel, bias)
    ctx.c_in = c_in
    if mid_p.device.type == "cpu":
      return final_deconv_plain(mid_p, kernel, bias, c_in)
    return final_deconv_cuda(mid_p, kernel, bias, c_in)

  @staticmethod
  def backward(ctx, g):
    saved = [t.detach().requires_grad_(need)
             for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in saved if t.requires_grad]
    with torch.enable_grad():
      y = final_deconv_plain(*saved, ctx.c_in)
      grads = iter(torch.autograd.grad(y, wanted, g))
    return tuple(next(grads) if t.requires_grad else None for t in saved) + (None,)


def final_deconv_phase(mid_p: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       c_in: int) -> torch.Tensor:
  """mid_p [B, H, W, 64*c_in] -> image [B, 16H, 16W, c_out]; differentiable."""
  return _FinalDeconvPhase.apply(mid_p, kernel, bias, c_in)
