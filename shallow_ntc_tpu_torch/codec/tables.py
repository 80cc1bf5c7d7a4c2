"""Quantized-CDF tables of the learned priors (mirrors shallow_ntc_tpu/codec/tables.py).

The device evaluates the continuous noisy likelihoods on an integer grid;
the host quantizes them to 16-bit frequency tables for the rANS coder. Tail
mass beyond each table's range goes to the escape slot (raw-coded), so the
tables stay compact without risk to correctness.

The Gaussian tables are float64 host arithmetic with the standard library's
erfc and inverse normal CDF in place of scipy.stats.norm.
"""

import math
import statistics
from typing import Optional

import numpy as np
import torch

from shallow_ntc_tpu_torch.codec.bindings import CdfTables
from shallow_ntc_tpu_torch.ops import entropy

PROB_SCALE = 1 << 16
# Tail quantile for sizing integer alphabets: mass outside the range is
# escape-coded (~34 bits each), so it must be rare, not impossible.
TAIL_LOGIT = 18.0  # sigmoid(18) ~ 1 - 1.5e-8
ESCAPE_MASS = 1e-8


def quantize_pmf(pmf: np.ndarray, escape_mass: Optional[float] = None) -> np.ndarray:
  """Quantize a pmf (last slot = escape) to a 16-bit CDF with no zero freqs."""
  pmf = np.maximum(np.asarray(pmf, np.float64), 0.0)
  if escape_mass is not None:
    pmf = np.append(pmf, max(escape_mass, 1.0 - pmf.sum()))
  total = pmf.sum()
  if total <= 0:
    pmf = np.ones_like(pmf)
    total = pmf.sum()
  freqs = np.maximum(1, np.round(pmf / total * PROB_SCALE)).astype(np.int64)
  # Repair the sum by walking the largest frequencies.
  diff = PROB_SCALE - freqs.sum()
  order = np.argsort(-freqs)
  i = 0
  while diff != 0:
    j = order[i % len(order)]
    step = 1 if diff > 0 else -1
    if freqs[j] + step >= 1:
      freqs[j] += step
      diff -= step
    i += 1
  cdf = np.zeros(len(freqs) + 1, np.uint32)
  np.cumsum(freqs, out=cdf[1:])
  return cdf


class FactorizedTables:
  """Per-channel tables of the deep-factorized prior.

  Coding grid: sample = k + offset_c (the tfc offset heuristic); the symbol
  of an element of channel c is k - kmin[c]. The host arithmetic is float32,
  as the eval path's.
  """

  def __init__(self, tables: CdfTables, kmin: np.ndarray, offset: np.ndarray):
    self.tables = tables
    self.kmin = kmin.astype(np.int32)  # [C]
    self.offset = offset.astype(np.float32)  # [C]

  @property
  def channels(self):
    return len(self.kmin)

  def symbols_from_latent(self, y: np.ndarray) -> np.ndarray:
    """y: [..., C] continuous latent -> table-local int32 symbols."""
    k = np.round(y - self.offset).astype(np.int32)
    return k - self.kmin

  def latent_from_symbols(self, symbols: np.ndarray) -> np.ndarray:
    return (symbols + self.kmin).astype(np.float32) + self.offset

  def channel_indexes(self, shape) -> np.ndarray:
    """Per-element table index = channel index, for a [..., C] layout."""
    return np.ascontiguousarray(np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape))


@torch.no_grad()
def build_factorized_tables(prior: entropy.DeepFactorizedPrior,
                            offset_heuristic: bool = True) -> FactorizedTables:
  """Per-channel quantized CDFs of a DeepFactorizedPrior; its offset, ±18-logit
  quantiles and pmf on the shared integer grid run on the prior's device."""
  device = prior.matrix_0.device
  if offset_heuristic:
    offset = prior.quantization_offset().cpu().numpy()
  else:
    offset = np.zeros((prior.channels,), np.float32)
  lo = prior.quantile_from_logit(-TAIL_LOGIT).cpu().numpy()
  hi = prior.quantile_from_logit(TAIL_LOGIT).cpu().numpy()
  kmin = np.floor(lo - offset).astype(np.int64) - 1
  kmax = np.ceil(hi - offset).astype(np.int64) + 1

  # One shared integer grid, per-channel trimmed tables.
  k_lo, k_hi = int(kmin.min()), int(kmax.max())
  grid = np.arange(k_lo, k_hi + 1, dtype=np.float32)  # [L]
  samples = torch.from_numpy(grid[:, None] + offset[None, :]).to(device)  # [L, C]
  pmf = torch.exp(prior.log_prob_noisy(samples)).cpu().numpy()

  cdfs = [quantize_pmf(pmf[kmin[c] - k_lo : kmax[c] - k_lo + 1, c], escape_mass=ESCAPE_MASS)
          for c in range(prior.channels)]
  return FactorizedTables(CdfTables(cdfs), kmin, offset)


class GaussianTables:
  """64-scale-indexed tables of the conditional Gaussian (loc-shifted grid).

  Coding grid: sample = k + mu; symbol = k - kmin[scale_index]; the scale
  index of an element is round(clip(continuous_index, 0, 63)), the integer
  snap tfc applies at compression time (np.round: half to even, as JAX's).
  """

  def __init__(self, tables: CdfTables, kmin: np.ndarray):
    self.tables = tables
    self.kmin = kmin.astype(np.int32)  # [NUM_SCALES]

  def snap_indexes(self, continuous_indexes: np.ndarray) -> np.ndarray:
    idx = np.clip(np.round(continuous_indexes), 0, entropy.NUM_SCALES - 1)
    return idx.astype(np.int32)

  def symbols_from_latent(self, y, mu, idx) -> np.ndarray:
    k = np.round(y - mu).astype(np.int32)
    return k - self.kmin[idx]

  def latent_from_symbols(self, symbols, mu, idx) -> np.ndarray:
    return (symbols + self.kmin[idx]).astype(np.float32) + mu


def _normal_cdf(x: np.ndarray) -> np.ndarray:
  return np.array([0.5 * math.erfc(-v / math.sqrt(2.0)) for v in x.tolist()])


def build_gaussian_tables(max_half_range: int = 2048) -> GaussianTables:
  """Tables of the fixed 64-entry log-spaced scale grid (entropy.scale_fn):
  host float64, the same on every device."""
  cdfs, kmins = [], []
  z = -statistics.NormalDist().inv_cdf(1.5e-8)  # the tail quantile, isf(1.5e-8)
  for i in range(entropy.NUM_SCALES):
    scale = float(np.exp(math.log(entropy.SCALE_MIN) + entropy.SCALE_FACTOR * i))
    half = min(max_half_range, int(math.ceil(scale * z + 0.5)) + 1)
    k = np.arange(-half, half + 1, dtype=np.float64)
    pmf = _normal_cdf((k + 0.5) / scale) - _normal_cdf((k - 0.5) / scale)
    cdfs.append(quantize_pmf(pmf, escape_mass=ESCAPE_MASS))
    kmins.append(-half)
  return GaussianTables(CdfTables(cdfs), np.asarray(kmins))
