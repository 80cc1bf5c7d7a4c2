"""Entropy models (mirrors shallow_ntc_tpu/ops/entropy.py).

The entropy-model calls take the training-mode uniform noise explicitly
(`noise`) or draw it from a torch.Generator (`generator`). The SGA branch
samples its latents itself (latents.py) and evaluates them here.

DeepFactorizedPrior is the side prior (tfc.NoisyDeepFactorized); the main
latent is coded under a 64-scale indexed noisy Gaussian. Parameter names
are the flax ones (`matrix_i`, `bias_i`, `factor_i`).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shallow_ntc_tpu_torch.ops.math import lower_bound, upper_bound
from shallow_ntc_tpu_torch.ops.rounding import round_st, sample_unoise

NUM_SCALES = 64
SCALE_MIN = 0.11
SCALE_MAX = 256.0
SCALE_FACTOR = (math.log(SCALE_MAX) - math.log(SCALE_MIN)) / (NUM_SCALES - 1.0)
CODING_RANK = 3

LOG2_E = 1.0 / math.log(2.0)
# tfc's ContinuousEntropyModel likelihood_bound (1e-9). It must stay a normal
# float32: a subnormal floor flushed to zero gives log(0) = -inf bits.
_LIKELIHOOD_FLOOR = 1e-9
_LOG_LIKELIHOOD_FLOOR = math.log(_LIKELIHOOD_FLOOR)


def scale_fn(i: torch.Tensor) -> torch.Tensor:
  """Map a (continuous) scale index in [0, NUM_SCALES) to a positive scale."""
  return torch.exp(math.log(SCALE_MIN) + SCALE_FACTOR * i.float())


def bits_from_log_prob(log_probs: torch.Tensor, coding_rank: int = CODING_RANK) -> torch.Tensor:
  """Total information content in bits, reduced over the last `coding_rank` axes."""
  return torch.sum(log_probs, dim=tuple(range(-coding_rank, 0))) * (-LOG2_E)


def _stable_log_diff(big: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
  """log(exp(big) - exp(small)) for big >= small, safe when big ~= small."""
  return big + torch.log(-torch.expm1(torch.clamp(small - big, max=-1e-20)))


def noisy_normal_log_prob(centered: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """log p(y) for y ~ N(0, scale^2) * U(-.5, .5), floored at the tfc bound.

  Evaluated on the left tail (p(y) = p(-y)) with log_ndtr so deep tails keep
  finite values and gradients.
  """
  y = -torch.abs(centered)
  big = torch.special.log_ndtr((y + 0.5) / scale)
  small = torch.special.log_ndtr((y - 0.5) / scale)
  return lower_bound(_stable_log_diff(big, small), _LOG_LIKELIHOOD_FLOOR)


class DeepFactorizedPrior(nn.Module):
  """Per-channel learned CDF sigmoid(f_K(...f_1(x))), convolved with U(-.5, .5)."""

  def __init__(self, channels: int, num_filters: Tuple[int, ...] = (3, 3, 3)):
    super().__init__()
    self.channels = channels
    self.num_filters = tuple(num_filters)
    filters = (1,) + self.num_filters + (1,)
    for i in range(len(self.num_filters) + 1):
      self.register_parameter(
          f"matrix_{i}", nn.Parameter(torch.zeros(channels, filters[i + 1], filters[i])))
      self.register_parameter(
          f"bias_{i}", nn.Parameter(torch.zeros(channels, filters[i + 1], 1)))
      if i < len(self.num_filters):
        self.register_parameter(
            f"factor_{i}", nn.Parameter(torch.zeros(channels, filters[i + 1], 1)))

  def logits_cdf(self, x: torch.Tensor) -> torch.Tensor:
    """Logits of the CDF at x. x has shape (..., C); returns the same shape."""
    orig_shape = x.shape
    if orig_shape[-1] != self.channels:
      raise ValueError(f"expected {self.channels} channels, got {tuple(orig_shape)}")
    # (C, 1, N), in float32: a bfloat16 x (the eval of a model whose
    # transforms compute in bfloat16) promotes, as in the JAX einsum.
    logits = x.reshape(-1, self.channels).t()[:, None, :].float()
    n_layers = len(self.num_filters) + 1
    for i in range(n_layers):
      m = F.softplus(getattr(self, f"matrix_{i}"))
      logits = torch.bmm(m, logits) + getattr(self, f"bias_{i}")
      if i < n_layers - 1:
        logits = logits + torch.tanh(getattr(self, f"factor_{i}")) * torch.tanh(logits)
    return logits[:, 0, :].t().reshape(orig_shape)

  def log_prob_noisy(self, y: torch.Tensor) -> torch.Tensor:
    """log(c(y+.5) - c(y-.5)) with the tfc sign trick for tail stability."""
    lo = self.logits_cdf(y - 0.5)
    up = self.logits_cdf(y + 0.5)
    # Where lo + up is exactly 0 the sign is 0, p = 0 and the floor applies,
    # as in the JAX package and tfc (ROADMAP.md queue 3).
    sign = -torch.sign(lo + up).detach()
    p = torch.abs(torch.sigmoid(sign * up) - torch.sigmoid(sign * lo))
    return torch.log(lower_bound(p, _LIKELIHOOD_FLOOR))

  @torch.no_grad()
  def quantile_from_logit(self, target_logit: float, num_iters: int = 60) -> torch.Tensor:
    """Per-channel x with logits_cdf(x) == target_logit, by bisection."""
    device = self.matrix_0.device
    target = torch.full((self.channels,), float(target_logit), device=device)
    lo = torch.full((self.channels,), -256.0, device=device)
    hi = torch.full((self.channels,), 256.0, device=device)
    for _ in range(num_iters):
      mid = 0.5 * (lo + hi)
      val = self.logits_cdf(mid[None, :])[0]
      lo = torch.where(val < target, mid, lo)
      hi = torch.where(val >= target, mid, hi)
    return 0.5 * (lo + hi)

  def median(self, num_iters: int = 60) -> torch.Tensor:
    """Per-channel median of the continuous density (logit target 0)."""
    return self.quantile_from_logit(0.0, num_iters)

  def quantization_offset(self) -> torch.Tensor:
    """tfc offset heuristic: median - round(median), no gradient. Shape (C,)."""
    med = self.median()
    return med - torch.round(med)


def batched_em_call(prior: DeepFactorizedPrior, y: torch.Tensor,
                    offset: Optional[torch.Tensor], coding_rank: int = CODING_RANK,
                    training: bool = False, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
  """tfc ContinuousBatchedEntropyModel.__call__ (entropy.py:210-233).

  Training: y plus uniform noise (`offset` unused). Eval: straight-through
  round about `offset`. Bits from the noisy likelihood of the sample.
  Returns (sample, bits[batch...]).
  """
  if training:
    sample = sample_unoise(y, noise, generator)
  else:
    sample = batched_em_quantize(y, offset)
  return sample, bits_from_log_prob(prior.log_prob_noisy(sample), coding_rank)


def batched_em_quantize(y: torch.Tensor, offset: Optional[torch.Tensor]) -> torch.Tensor:
  """tfc ContinuousBatchedEntropyModel.quantize: straight-through rounding
  about the offset grid (entropy.py:233)."""
  return round_st(y, offset)


def normalize_indexes(indexes: torch.Tensor) -> torch.Tensor:
  """Clip continuous scale indexes into [0, NUM_SCALES-1] (identity-if-towards)."""
  return upper_bound(lower_bound(indexes, 0.0), NUM_SCALES - 1.0)


def indexed_em_call(y: torch.Tensor, indexes: torch.Tensor, loc: torch.Tensor,
                    coding_rank: int = CODING_RANK, training: bool = False,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
  """tfc LocationScaleIndexedEntropyModel.__call__ (entropy.py:247-276).

  `indexes` are continuous scale indexes, clipped to [0, 63] and mapped
  through the log-spaced scale table; `loc` shifts the coding grid. The
  training noise is added to the centered y - loc, and loc added back.
  """
  scales = scale_fn(normalize_indexes(indexes))
  centered = y - loc
  if training:
    sample_c = sample_unoise(centered, noise, generator)
  else:
    sample_c = round_st(centered)
  bits = bits_from_log_prob(noisy_normal_log_prob(sample_c, scales), coding_rank)
  return sample_c + loc, bits


def indexed_em_log_prob_centered(sample: torch.Tensor, indexes: torch.Tensor,
                                 loc: torch.Tensor) -> torch.Tensor:
  """log p of an explicit (SGA) sample under the indexed prior: the sample is
  centered by `loc` before it is evaluated under the zero-mean Gaussian
  (entropy.py:279-288)."""
  scales = scale_fn(normalize_indexes(indexes))
  return noisy_normal_log_prob(sample - loc, scales)


def indexed_em_quantize(y: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
  """tfc LocationScaleIndexedEntropyModel.quantize: straight-through rounding
  about `loc` (entropy.py:274)."""
  return round_st(y, offset=loc)
