"""Quantization ops (mirrors shallow_ntc_tpu/ops/rounding.py): rounding, the
additive uniform noise of training, and the relaxations of iterative
inference (soft rounding and stochastic Gumbel annealing).

Random draws are given explicitly (`noise=`; tests feed JAX's draws) or
made from a torch.Generator on the input's device.
"""

from typing import Optional

import numpy as np
import torch


def round_st(x: torch.Tensor, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Straight-through rounding: forward rounds (about `offset`), grad is identity."""
  if offset is None:
    rounded = torch.round(x)
  else:
    rounded = torch.round(x - offset) + offset
  return x + (rounded - x).detach()


def _check_noise(noise: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
  if noise.shape != loc.shape:
    raise ValueError(f"noise of shape {tuple(noise.shape)} for a loc of {tuple(loc.shape)}")
  return noise


def sample_unoise(loc: torch.Tensor, noise: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
  """Additive uniform noise U(-.5, .5): the Balle-2017 proxy for quantization.

  `noise` is given explicitly (tests feed JAX's draws) or drawn from
  `generator` on loc's device.
  """
  if noise is None:
    noise = torch.rand(loc.shape, generator=generator, dtype=loc.dtype, device=loc.device) - 0.5
  return loc + _check_noise(noise, loc)


def quantize_eval(loc: torch.Tensor, offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Hard rounding about an offset grid: the eval-time sample."""
  if offset is None:
    return torch.round(loc)
  return torch.round(loc - offset) + offset


def _with_offset(op, x: torch.Tensor, offset: Optional[torch.Tensor]) -> torch.Tensor:
  return op(x) if offset is None else op(x - offset) + offset


def soft_round(x: torch.Tensor, alpha: float,
               offset: Optional[torch.Tensor] = None) -> torch.Tensor:
  """tfc.soft_round, optionally about an offset grid: m + tanh(alpha r) /
  (2 tanh(alpha / 2)) with m = floor(x) + .5, r = x - m. alpha -> 0 is the
  identity (taken exactly below 1e-4), alpha -> inf hard rounding."""
  def op(v):
    if alpha < 1e-4:
      return v
    m = torch.floor(v) + 0.5
    return m + torch.tanh(alpha * (v - m)) / float(np.tanh(np.float32(alpha) / 2) * 2)

  return _with_offset(op, x, offset)


def logistic(shape, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> torch.Tensor:
  """Standard logistic draws log(u / (1 - u)), u uniform on the open (0, 1):
  as jax.random.logistic, u starts at the smallest normal float, so no draw
  is infinite."""
  u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
  u = torch.clamp(u, min=torch.finfo(dtype).tiny)
  return torch.log(u / (1 - u))


def sga_round(mu: torch.Tensor, tau: float, offset: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              epsilon: float = 1e-5) -> torch.Tensor:
  """One stochastic-Gumbel-annealing rounding sample, optionally to the grid
  shifted by `offset` (shallow_ntc_tpu/ops/rounding.py:70-108).

  The direction (floor or ceil) is a two-way Concrete sample at temperature
  tau with logits -atanh(distance to the grid point) / tau; with two
  categories it collapses to a sigmoid of the logit difference plus one
  standard logistic draw per element (`noise`, or drawn from `generator`).
  As in the reference, tau divides the logit difference and then the sum
  again.
  """
  tau = float(tau)
  if noise is None:
    noise = logistic(mu.shape, generator, mu.dtype, mu.device)
  noise = _check_noise(noise, mu)

  def op(v):
    v_floor = torch.floor(v)
    v_ceil = torch.ceil(v)
    d_floor = torch.clamp(v - v_floor, -1.0 + epsilon, 1.0 - epsilon)
    d_ceil = torch.clamp(v_ceil - v, -1.0 + epsilon, 1.0 - epsilon)
    logit_diff = (torch.atanh(d_floor) - torch.atanh(d_ceil)) / tau
    w_ceil = torch.sigmoid((logit_diff + noise) / tau)
    return v_floor + (v_ceil - v_floor) * w_ceil

  return _with_offset(op, mu, offset)


def _fma(a, b, c) -> np.float32:
  # A float32 product is exact in float64; one rounding after the add.
  return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _exp_f32(x) -> np.float32:
  """exp of a float32 scalar as XLA's CPU backend computes it (the Cephes
  polynomial with fused multiply-adds), so that a schedule equals the JAX
  package's bit for bit; within 1 ulp of the true exp."""
  f = np.float32
  x = np.clip(f(x), f(-87.8), f(88.8))
  n = np.clip(np.floor(_fma(x, f(1.44269504088896341), f(0.5))), f(-127), f(127))
  a = _fma(-f(0.693359375), n, x)
  a = _fma(-f(-2.12194440e-4), n, a)
  z = _fma(a, f(1.9875691500e-4), f(1.3981999507e-3))
  for p in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
    z = _fma(z, a, f(p))
  z = f(1) + _fma(z, a * a, a)
  return f(z * np.array((int(n) + 127) << 23, np.int32).view(np.float32))


def sga_schedule_at_step(t: int, r: float, ub: float, lb: float = 1e-8, t0: float = 200.0,
                         scheme: str = "exp") -> np.float32:
  """SGA temperature at step t in float32, clipped to [lb, ub]: 'exp' is
  ub * exp(-r (t - t0)), 'linear' ub - r (t - t0) (one fused multiply-add,
  as XLA's CPU backend contracts it)."""
  f = np.float32
  if scheme == "exp":
    tau = f(ub) * _exp_f32(f(-r) * (f(t) - f(t0)))
  elif scheme == "linear":
    tau = _fma(f(-r), f(t) - f(t0), f(ub))
  else:
    raise NotImplementedError(f"unknown SGA schedule scheme {scheme!r}")
  return f(min(max(tau, f(lb)), f(ub)))
