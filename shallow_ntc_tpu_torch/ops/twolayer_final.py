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
"""

import ctypes

import torch

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.ops import fast_deconv as fd

S1 = 8        # phase factor of the mid tensor
S2 = 2        # stride of the final deconv
SP = S1 * S2  # 16
SOURCE = "final_deconv.cu"


class KernelStats:
  """Launch count of one CUDA kernel: a plain integer, reset by the caller."""

  def __init__(self, name: str):
    self.name = name
    self.launches = 0


STATS = KernelStats("final_deconv_phase")
_SYMBOLS = {torch.float32: "final_deconv_f32", torch.bfloat16: "final_deconv_bf16"}


def _kernel_fn(dtype):
  fn = getattr(cuda_build.load(SOURCE), _SYMBOLS[dtype])
  fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


def final_deconv_plain(mid_p: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       c_in: int) -> torch.Tensor:
  """The plain version: packed_conv_transpose(partial_depth_to_space(mid_p, 8, 8))."""
  del c_in
  return fd.packed_conv_transpose(fd.partial_depth_to_space(mid_p, S1, S1),
                                  kernel, bias, S2, S1)


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
  c_out = kernel.shape[3]
  if bias.shape != (c_out,):
    raise ValueError(f"bias must be [{c_out}], got {tuple(bias.shape)}")
  if kernel.device != mid_p.device or bias.device != mid_p.device:
    raise ValueError("mid_p, kernel and bias must be on one device")
  b, h, w, _ = mid_p.shape
  w32 = kernel.detach().float().contiguous()
  b32 = bias.detach().float().contiguous()
  out = torch.empty((b, SP * h, SP * w, c_out), dtype=mid_p.dtype, device=mid_p.device)
  stream = torch.cuda.current_stream(mid_p.device).cuda_stream
  rc = _kernel_fn(mid_p.dtype)(mid_p.data_ptr(), w32.data_ptr(), b32.data_ptr(),
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
