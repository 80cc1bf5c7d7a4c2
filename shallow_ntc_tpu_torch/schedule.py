"""Training schedules (mirrors shallow_ntc_tpu/schedule.py:22-144).

Scalar functions of an integer step, evaluated in float32 as the JAX
package evaluates them, so the port's learning rate and rd-lambda equal
JAX's bit for bit. Only the piecewise-constant interpolation is ported: the
JAX package's piecewise_sine_schedule has no caller there.
"""

from typing import Callable, Optional, Sequence

import numpy as np

HIGHER_LAMBDA_UNTIL = 0.2
HIGHER_LAMBDA_FACTOR = 10.0


def piecewise_constant_schedule(step: int, boundaries: Sequence[int],
                                values: Sequence[float]) -> np.float32:
  """values[i] on [boundaries[i-1], boundaries[i])."""
  if len(values) != len(boundaries) + 1:
    raise ValueError("The number of values must be one more than the number of boundaries: "
                     f"{len(values)} != {len(boundaries) + 1}")
  index = sum(1 for b in boundaries if b <= step)
  return np.float32(values[index])


def schedule_at_step(step: int, vals: Sequence[float], boundaries: Sequence[int],
                     warmup_steps: int = 0) -> np.float32:
  """Piecewise-constant value at `step`, times the linear warmup
  min(1, (step + 1) / warmup_steps) when warmup_steps > 0."""
  if len(boundaries) == 0:
    return np.float32(np.squeeze(np.asarray(vals, np.float32)))
  value = piecewise_constant_schedule(step, boundaries, vals)
  if warmup_steps > 0:
    ramp = (np.float32(step) + np.float32(1)) / np.float32(warmup_steps)
    value = value * np.minimum(np.float32(1.0), ramp)
  return np.float32(value)


def compression_schedule(base_learning_rate: float, total_num_steps: int,
                         warmup_until: float = 0.0, warmup_steps: Optional[int] = None,
                         drop_after: float = 0.85,
                         drop_factor: float = 0.1) -> Callable[[int], np.float32]:
  """LR schedule for compression: linear warmup, then a constant drop by
  `drop_factor` after `drop_after` of the steps. Returns step -> lr."""
  if warmup_steps is None:
    warmup_steps = int(warmup_until * total_num_steps)
  boundaries = [int(drop_after * total_num_steps)]
  vals = [1.0, drop_factor]

  def lr_fn(step: int) -> np.float32:
    return np.float32(np.float32(base_learning_rate)
                      * schedule_at_step(step, vals, boundaries, warmup_steps))

  return lr_fn


def scheduled_rd_lambda(rd_lambda: float, step: int, scheduled_num_steps: int,
                        itinf: bool = False) -> float:
  """10x rd_lambda during the first 20% of training when lambda <= 0.01;
  never during iterative inference (itinf).

  The product is taken in float32, as the JAX package takes it.
  """
  if (rd_lambda <= 0.01 and not itinf
      and step < int(scheduled_num_steps * HIGHER_LAMBDA_UNTIL)):
    return float(np.float32(rd_lambda) * np.float32(HIGHER_LAMBDA_FACTOR))
  return rd_lambda
