"""Profiling: model FLOPs counted from the shapes, timing and traces.

Mirrors shallow_ntc_tpu/utils/profiling.py:

  get_flops       the FLOPs of one call of a function. JAX asks XLA for the
                  compiled program's cost; that counts whatever a route
                  executes (a phase conv's zero taps, a dense stand-in), so
                  here the port's layers declare the work of the model they
                  compute, from their shapes (`flops(input_shape)` on the
                  layer classes, `flops(...)` beside each kernel wrapper).
                  The count is 2 x the (output element, kernel tap, input
                  channel) triples whose input element is a real pixel: not
                  SAME padding, not a hole of a transposed conv's dilated
                  input. That is how XLA's HloCostAnalysis counts a plain
                  convolution. While a counted layer or kernel call runs,
                  every count inside it is suspended, so one model counts
                  the same on every route (fused or not, a kernel or its
                  plain version, int8 or float, CPU or card, any dtype).
                  Outside counted layers aten ops (mm, bmm, addmm,
                  convolution, ...) count by torch.utils.flop_counter's
                  rules, as FlopCounterMode counts them.
  with_timing     (result, seconds), after the card has finished.
  time_fn, transform_timings  the eval's per-transform times.
  trace           a torch.profiler trace of a block, written as Chrome
                  trace JSON (tensorboard_trace_handler).
"""

import contextlib
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
# FLOPs from the shapes
# ---------------------------------------------------------------------------
def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
  """lax SAME padding (low, high) of a stride-s conv over n samples."""
  total = max((-(-n // s) - 1) * s + k - n, 0)
  return total // 2, total - total // 2


def _pairs_in(n: int, k: int, s: int, lo: int, n_out: int) -> int:
  """#(o, t), o in [0, n_out), t in [0, k), with 0 <= o*s + t - lo < n."""
  count = 0
  for t in range(k):
    first = max(0, -((t - lo) // s))   # o*s >= lo - t
    last = min(n_out - 1, (n - 1 + lo - t) // s)
    count += max(0, last - first + 1)
  return count


def conv_pairs(n: int, k: int, s: int) -> int:
  """Real (output, tap) pairs along one axis of a SAME stride-s conv of n samples."""
  return _pairs_in(n, k, s, same_pads(n, k, s)[0], -(-n // s))


def deconv_pairs(n: int, k: int, s: int) -> int:
  """Real (input, tap) pairs along one axis of a SAME stride-s transposed
  conv of n samples (flax ConvTranspose): input i reaches output
  i*s + t - q through tap t, q = max(k - s, 0) // 2, and the output keeps
  [0, n*s)."""
  return _pairs_in(n * s, k, s, max(k - s, 0) // 2, n)


def conv_flops(shape: Sequence[int], features: int, kernel_size: int, stride: int,
               transpose: bool = False) -> int:
  """FLOPs of a SAME conv (or flax transposed conv) of an NHWC input of
  `shape` to `features` channels."""
  b, h, w, c = shape
  pairs = deconv_pairs if transpose else conv_pairs
  return (2 * b * pairs(h, kernel_size, stride) * pairs(w, kernel_size, stride) * c
          * features)


class _Count:
  def __init__(self):
    self.total = 0
    self.depth = 0  # counted layers now running


_active: Optional[_Count] = None


class counted:
  """With-block of one counted layer or kernel call: adds flops() (called
  only while get_flops counts) unless an enclosing counted layer already
  holds this work, and suspends every count inside."""

  __slots__ = ("flops",)

  def __init__(self, flops: Callable[[], int]):
    self.flops = flops

  def __enter__(self):
    count = _active
    if count is not None:
      if count.depth == 0:
        count.total += self.flops()
      count.depth += 1

  def __exit__(self, *exc):
    if _active is not None:
      _active.depth -= 1


def _enter_layer(module, args):
  if _active is not None and hasattr(type(module), "flops"):
    if _active.depth == 0:
      _active.total += module.flops(tuple(args[0].shape))
    _active.depth += 1


def _exit_layer(module, args, out):
  if _active is not None and hasattr(type(module), "flops"):
    _active.depth -= 1


def get_flops(fn: Callable, *args, **kwargs) -> float:
  """Model FLOPs of one call fn(*args, **kwargs), run once under
  torch.no_grad() on the arguments' device (see the module docstring)."""
  from torch.utils._python_dispatch import TorchDispatchMode
  from torch.utils.flop_counter import flop_registry

  class AtenFlops(TorchDispatchMode):

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      kwargs = kwargs or {}
      out = func(*args, **kwargs)
      rule = flop_registry.get(func.overloadpacket)
      if rule is not None and _active.depth == 0:
        _active.total += rule(*args, **kwargs, out_val=out)
      return out

  global _active
  if _active is not None:
    raise RuntimeError("get_flops is already counting")
  _active = _Count()
  hooks = (torch.nn.modules.module.register_module_forward_pre_hook(_enter_layer),
           torch.nn.modules.module.register_module_forward_hook(_exit_layer, always_call=True))
  try:
    with torch.no_grad(), AtenFlops():
      fn(*args, **kwargs)
    return float(_active.total)
  finally:
    for hook in hooks:
      hook.remove()
    _active = None


def get_flops_per_pixel(fn: Callable, image_hw: Tuple[int, int], *args) -> float:
  return get_flops(fn, *args) / float(image_hw[0] * image_hw[1])


# ---------------------------------------------------------------------------
# Timing and traces
# ---------------------------------------------------------------------------
def with_timing(fn: Callable) -> Callable:
  """Wrap fn to return (result, wall seconds), timed until the card (if in
  use) has finished the call's work."""

  def timed(*args, **kwargs):
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    if torch.cuda.is_initialized():
      torch.cuda.synchronize()
    return result, time.perf_counter() - t0

  return timed


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
  z (mshyper) and the synthesis of the rounded y, as the JAX package names
  them: analysis_time, hyper_synthesis_time and synthesis_time. On the card
  a call is timed by CUDA events, on the CPU by the host clock."""
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


@contextlib.contextmanager
def trace(logdir: str):
  """torch.profiler over a block (the CPU, and the card's kernels when CUDA
  is available), written under `logdir` as a Chrome trace
  (<worker>.<time>.pt.trace.json)."""
  from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
    yield
    if torch.cuda.is_initialized():
      torch.cuda.synchronize()
