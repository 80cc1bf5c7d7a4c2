"""Timing of the transforms (mirrors shallow_ntc_tpu/utils/profiling.py:46-96).

On the card a call is timed by CUDA events recorded before and after it on
the current stream (the host waits for the end event), on the CPU by the
host clock. transform_timings gives the eval's profile keys in seconds, as
the JAX package names them: analysis_time, hyper_synthesis_time (the
mshyper family) and synthesis_time.
"""

import time
from typing import Callable, Dict

import torch


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
  """Median time per call of fn(*args), in seconds; on the card when an
  argument is a CUDA tensor."""
  cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
  with torch.no_grad():
    for _ in range(warmup):
      fn(*args)
    times = []
    for _ in range(iters):
      if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
      else:
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
  times.sort()
  return times[len(times) // 2]


def transform_timings(model, x: torch.Tensor, iters: int = 5) -> Dict[str, float]:
  """Per-transform times (seconds) of one eval pass of the image batch `x`
  (on the model's device): the analysis, the hyper-synthesis of the rounded
  z (mshyper) and the synthesis of the rounded y."""
  with torch.no_grad():
    latents = model.infer_latent_rvs(x)
  out = {"analysis_time": time_fn(model.infer_latent_rvs, x, iters=iters)}
  if hasattr(model, "hyper_synthesize"):
    out["hyper_synthesis_time"] = time_fn(model.hyper_synthesize,
                                          torch.round(latents.uq[0].loc), iters=iters)
    y_loc = latents.uq[1].loc
  else:
    y_loc = latents.uq[0].loc
  out["synthesis_time"] = time_fn(model.synthesize, torch.round(y_loc), iters=iters)
  return out
