"""rd-lambda warm-up schedule (mirrors shallow_ntc_tpu/schedule.py:117)."""

import numpy as np

HIGHER_LAMBDA_UNTIL = 0.2
HIGHER_LAMBDA_FACTOR = 10.0


def scheduled_rd_lambda(rd_lambda: float, step: int, scheduled_num_steps: int) -> float:
  """10x rd_lambda during the first 20% of training when lambda <= 0.01.

  The product is taken in float32, as the JAX package takes it. (Iterative
  inference, which disables the warm-up, is not ported yet.)
  """
  if rd_lambda <= 0.01 and step < int(scheduled_num_steps * HIGHER_LAMBDA_UNTIL):
    return float(np.float32(rd_lambda) * np.float32(HIGHER_LAMBDA_FACTOR))
  return rd_lambda
