"""Phase-space (subpixel) forms of the SAME transposed convolution.

Mirrors shallow_ntc_tpu/ops/fast_deconv.py. Kernels keep the flax layout
[k, k, C_in, C_out], cross-correlated unflipped over the s-dilated input
padded by P = k-1-max(k-s,0)//2 on the low side, so output o = s*b + r is

    out[s*b + r] = sum_d z[b + d] * K[P - r + s*d]   for P - r + s*d in [0, k).

Phase r is a stride-1 conv over z with taps d in a small window; all s*s
phases stack into one conv with s*s*C_out output channels ("phase space",
channels (r_h, r_w, c) with c innermost, TF depth-to-space order -- not
torch.pixel_shuffle's). Tensors are NHWC at every function here.

conv_s1 is the funnel of the phase convs (JAX: _s1_conv): with the int8
decode gate on (ops/int8ops.enabled()) it runs int8ops.conv_s1_int8, and so
does fast_conv_transpose, through the phase kernel. packed_conv_transpose
stays float, as in the JAX package.
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from shallow_ntc_tpu_torch.ops import int8ops


def conv_s1(x: torch.Tensor, w_hwio: torch.Tensor, pad_lo: int, pad_hi: int) -> torch.Tensor:
  """Stride-1 conv of NHWC `x` with an HWIO kernel, padded (lo, hi) per axis,
  int8 under the decode gate.

  Negative pads crop, as lax.conv_general_dilated's do.
  """
  if int8ops.enabled():
    return int8ops.conv_s1_int8(x, w_hwio, pad_lo, pad_hi, x.dtype)
  return _conv_s1_float(x, w_hwio, pad_lo, pad_hi)


def _conv_s1_float(x: torch.Tensor, w_hwio: torch.Tensor, pad_lo: int,
                   pad_hi: int) -> torch.Tensor:
  xn = F.pad(x.permute(0, 3, 1, 2), (pad_lo, pad_hi, pad_lo, pad_hi))
  return F.conv2d(xn, w_hwio.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def depth_to_space(x: torch.Tensor, block: int) -> torch.Tensor:
  """NHWC depth_to_space in TF order (channels (bh, bw, c), c innermost)."""
  b, h, w, c = x.shape
  x = x.reshape(b, h, w, block, block, c // (block * block))
  x = x.permute(0, 1, 3, 2, 4, 5)
  return x.reshape(b, h * block, w * block, c // (block * block))


@functools.lru_cache(maxsize=None)
def _phase_geometry(k: int, s: int) -> Tuple[int, int]:
  """(dmin, T): the union tap window over all s phases, per axis."""
  p = k - 1 - max(k - s, 0) // 2
  ds = [d for r in range(s) for d in range(-(k // s) - 1, k // s + 2)
        if 0 <= p - r + s * d < k]
  return min(ds), max(ds) - min(ds) + 1


def phase_kernel(kernel: torch.Tensor, stride: int) -> Tuple[torch.Tensor, int, int]:
  """[k, k, C_in, C_out] -> ([T, T, C_in, s*s*C_out], dmin, T).

  Pad + slice + reshape + flip of the kernel: the map (r, j) ->
  t = P - r + s*(dmin + j) is a contiguous re-chunking of the zero-padded
  kernel in terms of r' = s-1-r.
  """
  k = kernel.shape[0]
  s = stride
  dmin, T = _phase_geometry(k, s)
  p = k - 1 - max(k - s, 0) // 2
  start = p + s * dmin - s + 1
  total = T * s
  pad_front = max(0, -start)
  pad_back = max(0, start + total - k)
  kp = F.pad(kernel, (0, 0, 0, 0, pad_front, pad_back, pad_front, pad_back))
  off = start + pad_front
  kp = kp[off : off + total, off : off + total]
  c_in, c_out = kernel.shape[2], kernel.shape[3]
  w = kp.reshape(T, s, T, s, c_in, c_out).flip(1, 3)  # r' = s-1-r -> phase order r
  w = w.permute(0, 2, 4, 1, 3, 5)  # [T, T, C_in, s, s, C_out]
  return w.reshape(T, T, c_in, s * s * c_out), dmin, T


def phase_conv(z: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
               stride: int) -> torch.Tensor:
  """Conv-transpose output in phase space: [B, h, w, s*s*C_out].

  depth_to_space(phase_conv(...), s) == fast_conv_transpose(...).
  """
  s = stride
  w_phase, dmin, T = phase_kernel(kernel, s)
  out = conv_s1(z, w_phase.to(z.dtype), -dmin, T - 1 + dmin)
  if bias is not None:
    out = out + bias.repeat(s * s).to(out.dtype)
  return out


def gdn(x: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor, inverse: bool,
        alpha: float = 1.0, epsilon: float = 1.0) -> torch.Tensor:
  """GDN over the last axis: x / (beta + |x|^alpha @ gamma)^epsilon, or x * (...)
  if inverse. |x| for alpha 1, x^2 for 2; sqrt for epsilon 0.5, as the JAX
  package's GDN (models/transforms.py:99-110)."""
  if alpha == 1.0:
    pool = torch.abs(x)
  elif alpha == 2.0:
    pool = torch.square(x)
  else:
    pool = torch.abs(x) ** alpha
  norm = pool @ gamma.to(x.dtype) + beta.to(x.dtype)
  if epsilon == 0.5:
    norm = torch.sqrt(norm)
  elif epsilon != 1.0:
    norm = norm**epsilon
  return x * norm if inverse else x / norm


def gdn_phase(x_p: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor,
              num_phases: int, inverse: bool, alpha: float = 1.0,
              epsilon: float = 1.0) -> torch.Tensor:
  """GDN applied to a phase-space tensor [.., num_phases*C].

  GDN mixes channels only within one phase, so the per-phase (C, C) matmul
  equals the JAX package's block-diagonal kron(I, gamma) form.
  """
  c = gamma.shape[0]
  x = x_p.reshape(x_p.shape[:-1] + (num_phases, c))
  return gdn(x, beta, gamma, inverse, alpha, epsilon).reshape(x_p.shape)


def partial_depth_to_space(x_p: torch.Tensor, s: int, keep: int) -> torch.Tensor:
  """[B, h, w, s*s*C] -> [B, h*s/keep, w*s/keep, keep*keep*C]: s2d(d2s(x, s), keep)."""
  if s % keep:
    raise ValueError(f"keep={keep} must divide s={s}")
  e = s // keep
  b, h, w, c_p = x_p.shape
  c = c_p // (s * s)
  x = x_p.reshape(b, h, w, e, keep, e, keep, c)
  x = x.permute(0, 1, 3, 2, 5, 4, 6, 7)
  return x.reshape(b, h * e, w * e, keep * keep * c)


@functools.lru_cache(maxsize=None)
def _packed_geometry(k: int, s: int, p: int):
  """Per-axis taps of a stride-s SAME deconv reading a p-packed input.

  Returns (delta_min, Tp, entries); each entry (delta, a_src, t, P) says that
  output phase P (of s*p) reads packed slot a_src at cell offset delta with
  kernel tap t.
  """
  p0 = k - 1 - max(k - s, 0) // 2
  entries = []
  for a in range(p):
    for r in range(s):
      for a_src in range(p):
        for delta in range(-(k // (s * p)) - 2, k // (s * p) + 3):
          t = p0 - r + s * (p * delta + a_src - a)
          if 0 <= t < k:
            entries.append((delta, a_src, t, s * a + r))
  deltas = [e[0] for e in entries]
  return min(deltas), max(deltas) - min(deltas) + 1, tuple(entries)


@functools.lru_cache(maxsize=None)
def _packed_taps(k: int, s: int, p: int, device: torch.device) -> Tuple[torch.Tensor, int, int]:
  """(0/1 tensor [Tp, p, s*p, k] of _packed_geometry's entries on `device`,
  delta_min, Tp), made once per geometry and device: a copy to the device
  per call would wait for the device each time."""
  dmin, tp, entries = _packed_geometry(k, s, p)
  kh = np.zeros((tp, p, s * p, k), np.float32)
  for d, a, t, ph in entries:
    kh[d - dmin, a, ph, t] = 1.0
  return torch.as_tensor(kh, device=device), dmin, tp


def packed_conv_transpose(x_packed: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor], stride: int,
                          pack: int) -> torch.Tensor:
  """SAME conv-transpose of a p-packed input [.., p*p*C_in] as one dense
  stride-1 conv + depth_to_space(s*p)."""
  s, p = stride, pack
  k = kernel.shape[0]
  c_in, c_out = kernel.shape[2], kernel.shape[3]
  khj, dmin, tp = _packed_taps(k, s, p, kernel.device)
  w_full = torch.einsum("dapt,ebqu,tuio->deabipqo", khj, khj, kernel.float())
  w_full = w_full.reshape(tp, tp, p * p * c_in, (s * p) * (s * p) * c_out)
  out_small = _conv_s1_float(x_packed, w_full.to(x_packed.dtype), -dmin, tp - 1 + dmin)
  out = depth_to_space(out_small, s * p)
  if bias is not None:
    out = out + bias.to(out.dtype)
  return out


def fast_conv_transpose(z: torch.Tensor, kernel: torch.Tensor,
                        bias: Optional[torch.Tensor], stride: int) -> torch.Tensor:
  """SAME conv-transpose with a flax [k, k, C_in, C_out] kernel, NHWC in and out.

  torch's conv_transpose2d convolves the flipped kernel, so the flax kernel
  is flipped and its in/out axes swapped. With no padding the full output
  has (n-1)*s + k rows; SAME keeps rows [q, q + n*s), q = max(k-s, 0)//2.

  Under the int8 decode gate it is the phase conv + depth_to_space: JAX
  quantizes the phase kernel [T, T, C_in, s*s*C_out] per (phase, c_out), and
  the original kernel per c_out would give other numbers. JAX's grouped
  pieces (k5s2; fast_deconv.py:500-506) quantize each group's window per
  (phase, c_out), which zero taps leave equal to the dense phase kernel's.
  """
  s = stride
  k = kernel.shape[0]
  if k < s:
    raise ValueError(f"kernel {k} smaller than stride {s} is not supported")
  if int8ops.enabled():
    w_phase, dmin, T = phase_kernel(kernel.to(z.dtype), s)
    out = depth_to_space(conv_s1(z, w_phase, -dmin, T - 1 + dmin), s)
    return out if bias is None else out + bias.to(out.dtype)
  q = max(k - s, 0) // 2
  h, w = z.shape[1], z.shape[2]
  weight = kernel.flip(0, 1).permute(2, 3, 0, 1).to(z.dtype)  # [C_in, C_out, k, k]
  out = F.conv_transpose2d(z.permute(0, 3, 1, 2), weight, stride=s)
  out = out[:, :, q : q + h * s, q : q + w * s].permute(0, 2, 3, 1)
  return out if bias is None else out + bias.to(out.dtype)
