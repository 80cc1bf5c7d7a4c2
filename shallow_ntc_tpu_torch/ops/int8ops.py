"""Int8 inference path of the stride-1 convolutions (mirrors
shallow_ntc_tpu/ops/int8ops.py, whose numbers it reproduces bit for bit).

Scheme (dynamic post-training quantization):
  * activations: symmetric per-input-channel int8, scale absmax / 127 over
    every axis but the channels; the scales fold into the weights along
    the contraction axis (w'[.., k, j] = s[k] * w[.., k, j]);
  * weights, after the fold: symmetric per-output-channel int8;
  * an int8 x int8 product with int32 accumulation, then one float32 rescale
    by the weights' scales and a cast to the output type.
A quantizer computes round(v / scale) in float32 with a true division, rounds
half to even (torch.round, as jnp.round) and clips to +-127. The scale is
max(absmax, 1e-12) times the float32 reciprocal of 127: the JAX package runs
every int8 path under jit, where XLA turns the division by the constant 127
into that product (and keeps v / scale a division), so these are the scales
of its evals, bit for bit.

PyTorch has no int8 convolution on CUDA, so conv_s1_int8 lays the T x T taps
of the padded int8 input out as an im2col matrix [B*H*W, T*T*C_in] and
multiplies it with torch._int_mm: cuBLASLt's int8 GEMM with int32
accumulation on the card, an exact integer product on the CPU too. A product
that _int_mm refuses raises; nothing falls back to a float convolution.

Gates, read at call time:
  mode()            SNTC_INT8_DECODE: "" (off), "syn" (the synthesis only) or
                    "all" ("1" means "all"); decode_mode(...) sets it for a
                    `with` block over the environment, which the CLIs use;
  enabled()         the decode gate: every phase conv (ops/fast_deconv.conv_s1)
                    and every FastConvTranspose. So the decoders of the
                    factorized family, mbt2018, jpegl_rd (k18), ElicSynthesis
                    and the unfused two-layer syntheses quantize their last
                    deconv too. Only the flagship's final stage
                    (final_deconv_phase), the packed final conv
                    (packed_conv_transpose) and jpegl_synthesize (k == s)
                    stay float. force(value) overrides it: "syn" mode runs
                    the hyper-decoder under force(False), so mu, the scale
                    indexes and the rate equal the float path's;
  encode_enabled()  SNTC_INT8_ENCODE=1: every stride-1 Conv with C_in >= 32
                    (models/transforms.Conv), unless a residual-block kernel
                    takes the block (models/elic.py).
Inference only: round() has a zero gradient, so the train and itinf CLIs call
assert_training_safe() first.
"""

import contextlib
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_FORCED: Optional[bool] = None  # force(): overrides enabled()
_MODE: Optional[str] = None  # decode_mode(): overrides SNTC_INT8_DECODE
_MODES = ("", "syn", "all")
_INV_127 = np.float32(1.0) / np.float32(127.0)  # XLA's rewrite of "/ 127.0"


def mode() -> str:
  """'' (off) | 'all' (every decode conv) | 'syn' (the synthesis only).

  'syn' keeps the hyper-decoder float, so mu and the scale indexes, and with
  them the rate, are bit-identical to the float path's; the int8 error then
  touches only the reconstruction. 'all' quantizes the hyper-decoder too,
  and its error shows as a rate overhead."""
  if _MODE is not None:
    return _MODE
  v = os.environ.get("SNTC_INT8_DECODE", "")
  return {"1": "all"}.get(v, v)


def hyper_exempt() -> bool:
  return mode() == "syn"


def enabled() -> bool:
  if _FORCED is not None:
    return _FORCED
  return mode() in ("all", "syn")


def encode_enabled() -> bool:
  """The analysis-side gate, SNTC_INT8_ENCODE=1. It moves the latents, so
  rate and distortion both move. Environment only (force() is the decode
  gate's)."""
  return os.environ.get("SNTC_INT8_ENCODE") == "1"


def assert_training_safe():
  """Raise if an int8 gate is on in a process that takes gradients.

  round() in the quantizers has a zero gradient: with a gate on, the
  transforms it reaches would silently stop learning."""
  leaked = []
  if mode() in ("all", "syn"):  # the effective mode: SNTC_INT8_DECODE=0 is off
    leaked.append("SNTC_INT8_DECODE")
  if encode_enabled():
    leaked.append("SNTC_INT8_ENCODE")
  if leaked:
    raise RuntimeError(
        f"{'/'.join(leaked)} set in a training/itinf process: the int8 "
        "quantizers have zero gradient and would silently stop the affected "
        "transforms from learning. Unset the variable(s); int8 is an "
        "inference-only path (eval.py --decode_dtype / compress.py).")


@contextlib.contextmanager
def force(value: Optional[bool]):
  """Override the decode gate inside a `with` block (None: the mode decides)."""
  global _FORCED
  prev = _FORCED
  _FORCED = value
  try:
    yield
  finally:
    _FORCED = prev


@contextlib.contextmanager
def decode_mode(value: Optional[str]):
  """Set mode() to '', 'syn' or 'all' inside a `with` block, over
  SNTC_INT8_DECODE; None leaves it as it is. The earlier mode comes back on
  exit, so nothing leaks into the rest of the process."""
  global _MODE
  if value is not None and value not in _MODES:
    raise ValueError(f"int8 decode mode {value!r} is none of {_MODES}")
  prev = _MODE
  _MODE = _MODE if value is None else value
  try:
    yield
  finally:
    _MODE = prev


def _quantize(v: torch.Tensor, reduce_dims) -> Tuple[torch.Tensor, torch.Tensor]:
  v = v.float()
  absmax = v.abs().amax(dim=reduce_dims) if reduce_dims else v.abs().max()
  scale = torch.clamp_min(absmax, 1e-12) * _INV_127
  q = torch.clamp(torch.round(v / scale), -127, 127)
  return q.to(torch.int8), scale


def quantize_weight_per_cout(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-output-channel int8; w is [..., c_out] (HWIO)."""
  return _quantize(w, tuple(range(w.ndim - 1)))


def quantize_act_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-tensor dynamic int8."""
  return _quantize(x, ())


def quantize_act_per_channel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Symmetric per-channel dynamic int8 over the last (channel) axis."""
  return _quantize(x, tuple(range(x.ndim - 1)))


def _round_up(n: int, m: int) -> int:
  return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
  """a [M, K] int8 @ b_t.T -> int32 [M, N], exact; b_t is [N, K] int8.

  torch._int_mm on CUDA takes M > 16 and K, N multiples of 8 (torch 2.11 on
  an H100 refuses M = 16 and takes K = N = 8, with b in either layout). Zero
  rows and columns pad a shape that breaks a rule, which changes no sum; the
  CPU gets the same padding. A shape it still refuses raises."""
  m, k = a.shape
  n = b_t.shape[0]
  mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
  if (mp, kp) != (m, k):
    a = F.pad(a, (0, kp - k, 0, mp - m))
  if (np_, kp) != (n, k):
    b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
  out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
  return out[:m, :n]


def _im2col(xq: torch.Tensor, t: int, pad_lo: int,
            pad_hi: int) -> Tuple[torch.Tensor, int, int]:
  """[B, H, W, C] -> ([B*H'*W', t*t*C], H', W'): the taps (i, j, c) of each
  output of a stride-1 t x t conv over x padded (lo, hi) per axis (negative
  pads crop)."""
  xp = F.pad(xq, (0, 0, pad_lo, pad_hi, pad_lo, pad_hi))
  ho, wo = xp.shape[1] - t + 1, xp.shape[2] - t + 1
  cols = torch.cat([xp[:, i:i + ho, j:j + wo] for i in range(t) for j in range(t)], dim=-1)
  return cols.reshape(-1, cols.shape[-1]), ho, wo


def int8_operands(x: torch.Tensor, w_hwio: torch.Tensor, pad_lo: int, pad_hi: int):
  """The int8 GEMM of conv_s1_int8: (im2col [M, K], weights [N, K], the
  weights' float32 scales [N], H', W'). x's per-channel scales are folded
  into the weights before those are quantized per output channel."""
  t = w_hwio.shape[0]
  if w_hwio.shape[1] != t:
    raise ValueError(f"square kernels only, got {tuple(w_hwio.shape)}")
  xq, sx = quantize_act_per_channel(x)
  wq, sw = quantize_weight_per_cout(w_hwio.float() * sx[:, None])
  cols, ho, wo = _im2col(xq, t, pad_lo, pad_hi)
  return cols, wq.reshape(-1, wq.shape[-1]).t(), sw, ho, wo


def conv_s1_int8(x: torch.Tensor, w_hwio: torch.Tensor, pad_lo: int, pad_hi: int,
                 out_dtype: torch.dtype, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Stride-1 conv of NHWC x with an HWIO kernel, padded (lo, hi) per axis,
  on int8 operands; float32 rescale, then out_dtype, plus `bias` (one value
  per output channel) where given. Drop-in for fast_deconv.conv_s1 (JAX:
  int8ops.conv_s1_int8 at the same pads, and the bias add after it).

  In float32 the JAX package's jitted paths fuse the rescale and the bias
  add into one multiply-add, rounded once. So does this: the float32
  product of the int32 sum and the scale is exact in float64, and its sum
  with the bias rounds once there and once more to float32, which differs
  from one rounding only where float64 lands on a float32 tie. In bfloat16
  the rescale rounds to bfloat16 before the add, in both packages."""
  cols, b_t, sw, ho, wo = int8_operands(x, w_hwio, pad_lo, pad_hi)
  acc = int8_matmul(cols, b_t).float()
  if bias is None:
    out = (acc * sw).to(out_dtype)
  elif out_dtype == torch.float32:
    out = (acc.double() * sw.double() + bias.double()).float()
  else:
    out = (acc * sw).to(out_dtype) + bias.to(out_dtype)
  return out.reshape(x.shape[0], ho, wo, -1)
