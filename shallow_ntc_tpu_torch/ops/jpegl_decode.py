"""JPEG-like decode at kernel_size == strides: CUDA kernel and plain version.

jpegl_synthesize(z, kernel, bias) computes the SAME transposed conv of the
JPEG-like synthesis when its patches do not overlap (k == s): every latent
vector maps to its own k x k x c_out patch,

  out[b, h_l*k + r, w_l*k + rc, co]
      = bias[co] + sum_c z[b, h_l, w_l, c] * kernel[k-1-r, k-1-rc, c, co],

z [B, H_l, W_l, C] -> out [B, H_l*k, W_l*k, c_out], NHWC, with the flax
ConvTranspose kernel [k, k, C, c_out]. It replaces
shallow_ntc_tpu/ops/pallas/jpegl_decode.py:jpegl_synthesize.

Rounding, as the Pallas kernel: the weights are rounded to z's dtype, the
bias is added in float32 (a bfloat16 bias widened exactly), products are
summed in float32, and the output is rounded once to z's dtype.

On a CUDA tensor the forward pass launches the hand-written kernel of
csrc/jpegl_decode.cu or raises; on a CPU tensor it runs the plain version,
jpegl_synthesize_plain (a per-patch-row matmul with the packed weights).
There is no backward: JAX cannot differentiate its kernel either (jax.grad
through the pallas_call fails), and the paper's k=18 decoder, which is what
training runs, takes the plain transposed conv.
"""

import ctypes
from typing import Optional, Tuple

import torch

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.utils import profiling

SOURCE = "jpegl_decode.cu"
STATS = cuda_build.KernelStats("jpegl_synthesize")
_SYMBOLS = {torch.float32: "jpegl_synthesize_f32", torch.bfloat16: "jpegl_synthesize_bf16"}


def _kernel_fn(dtype):
  fn = getattr(cuda_build.load(SOURCE), _SYMBOLS[dtype])
  fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def pack_weights(kernel: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
  """flax ConvTranspose kernel [k, k, C, c_out] (k == s) -> per-patch-row matmul
  weights [k, C, k*c_out] and bias rows [k, k*c_out] (zeros if bias is None).

  The transposed conv correlates the unflipped kernel over the dilated input,
  so output offset r reads kernel index k-1-r in both spatial axes.
  """
  k, _, c_in, c_out = kernel.shape
  w = kernel.flip(0, 1).permute(0, 2, 1, 3).reshape(k, c_in, k * c_out)
  if bias is None:
    bias = torch.zeros(c_out, dtype=kernel.dtype, device=kernel.device)
  return w, bias.reshape(1, 1, c_out).expand(k, k, c_out).reshape(k, k * c_out)


def jpegl_synthesize_plain(z: torch.Tensor, kernel: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """The plain version: row h_l*k + r of the image is z[:, h_l] @ W_r + bias_r."""
  b, hl, wl, _ = z.shape
  k, c_out = kernel.shape[0], kernel.shape[3]
  w, bias_rows = pack_weights(kernel, bias)
  w = w.to(z.dtype).float()
  out = torch.einsum("bhwc,rcn->bhrwn", z.float(), w) + bias_rows.float()[:, None, :]
  return out.to(z.dtype).reshape(b, hl * k, wl * k, c_out)


def jpegl_synthesize_cuda(z: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          strides: Optional[int] = None) -> torch.Tensor:
  """Launch the CUDA kernel on PyTorch's current stream; raise on what it does
  not take. `strides` (default k) must equal the kernel size k: overlapping
  patches are a plain transposed conv."""
  if not z.is_cuda:
    raise ValueError(f"the jpegl_synthesize kernel needs a CUDA tensor, got {z.device}")
  if z.dtype not in _SYMBOLS:
    raise TypeError(f"the jpegl_synthesize kernel takes float32 or bfloat16, got {z.dtype}")
  if z.ndim != 4 or not z.is_contiguous():
    raise ValueError(f"z must be a contiguous [B, H_l, W_l, C] tensor, got {tuple(z.shape)}")
  b, hl, wl, c_in = z.shape
  k, c_out = kernel.shape[0], kernel.shape[-1]
  if kernel.shape != (k, k, c_in, c_out):
    raise ValueError(f"kernel must be [k, k, {c_in}, c_out], got {tuple(kernel.shape)}")
  if bias is not None and bias.shape != (c_out,):
    raise ValueError(f"bias must be [{c_out}], got {tuple(bias.shape)}")
  if kernel.device != z.device or (bias is not None and bias.device != z.device):
    raise ValueError("z, kernel and bias must be on one device")
  if strides is not None and strides != k:
    raise ValueError(f"the kernel computes kernel_size == strides only, got {k} and {strides}")
  # The kernel reads the flax kernel as it is, in z's dtype, and the bias in
  # float32 or bfloat16: with the model's parameters in z's dtype a call
  # launches the kernel alone.
  w = kernel.detach().to(z.dtype).contiguous()
  if bias is not None:
    bias = bias.detach()
    bias = (bias if bias.dtype in _SYMBOLS else bias.float()).contiguous()
  out = torch.empty((b, hl * k, wl * k, c_out), dtype=z.dtype, device=z.device)
  stream = torch.cuda.current_stream(z.device).cuda_stream
  rc = _kernel_fn(z.dtype)(z.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
                           int(bias is not None and bias.dtype == torch.bfloat16),
                           out.data_ptr(), b, hl, wl, c_in, c_out, k, stream)
  if rc != 0:
    raise RuntimeError(f"jpegl_synthesize kernel launch failed: CUDA error {rc}")
  STATS.launches += 1
  return out


class _JpeglSynthesize(torch.autograd.Function):

  @staticmethod
  def forward(ctx, z, kernel, bias):
    if z.device.type == "cpu":
      return jpegl_synthesize_plain(z, kernel, bias)
    return jpegl_synthesize_cuda(z, kernel, bias)

  @staticmethod
  def backward(ctx, g):
    raise NotImplementedError(
        "jpegl_synthesize has no gradient (nor has the JAX kernel); train with the "
        "transposed conv (use_pallas=False)")


def flops(z_shape, kernel_shape) -> int:
  """Model FLOPs of one call: 2 C per output element (k == s: every tap of
  every latent lands on its own output pixel)."""
  k, _, c_in, c_out = kernel_shape
  return profiling.conv_flops(z_shape, c_out, k, k, transpose=True)


def jpegl_synthesize(z: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """z [B, H_l, W_l, C] -> image [B, H_l*k, W_l*k, c_out], kernel [k, k, C, c_out], k == s."""
  with profiling.counted(lambda: flops(z.shape, kernel.shape)):
    return _JpeglSynthesize.apply(z, kernel, bias)
