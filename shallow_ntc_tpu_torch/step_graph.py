"""Captured steps: the port's counterpart of the JAX package's compiled step
programs (the jitted train step and its lax.scan window, ItinfJit.step and
run_stream: shallow_ntc_tpu/train_lib.py:395-414, itinf_lib.py:184-227).

A train or SGA step splits into host work and device work. The host fills
the step's scalars (StepScalars: the scheduled rd_lambda, SGA's tau, Adam's
learning rate and bias corrections, as 0-dim float32 tensors), draws its
noise from the seeded generator and stages its batch into static tensors
(BatchStager). The device work (the forward, the gradients, Adam's update)
reads only tensors that outlive it, so CapturedStep records it once as a
CUDA graph and replays it every step: one launch from the host where the
eager step issues some 500.

The dispatch of a train or SGA loop (`dispatch`, a function argument):
  eager   the step as Python issues it, op by op (the CPU's default);
  static  the step on static tensors, run eagerly: the function a graph
          captures, on any device;
  graph   that function captured once and replayed (the default on CUDA);
          a capture or replay that fails raises, and nothing falls back;
  auto    graph on CUDA, eager elsewhere; eager in a process group, whose
          allreduce is not captured.
"""

import json
import os
import subprocess
import sys
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from shallow_ntc_tpu_torch.ops import cuda_build

DISPATCHES = ("auto", "eager", "static", "graph")
# What each dispatch is called in the records (<workdir>/step_dispatch.json).
RECORD_NAMES = {"eager": "eager", "static": "static", "graph": "cuda_graph"}


def resolve_dispatch(dispatch: str, device, data_parallel: bool = False) -> str:
  """The dispatch ("eager", "static" or "graph") that `dispatch` names on
  `device`; raises where it cannot run there."""
  if dispatch not in DISPATCHES:
    raise ValueError(f"dispatch {dispatch!r} is not one of {DISPATCHES}")
  cuda = torch.device(device).type == "cuda"
  if dispatch == "auto":
    return "graph" if cuda and not data_parallel else "eager"
  if data_parallel and dispatch != "eager":
    raise ValueError(f"dispatch {dispatch!r}: the data-parallel step runs eagerly (its "
                     "allreduce is not captured)")
  if dispatch == "graph" and not cuda:
    raise ValueError(f"dispatch 'graph' needs a CUDA device, got {device}")
  return dispatch


class StepScalars:
  """The scalars of one step as 0-dim float32 tensors on `device`, which the
  step's device work reads in place of host floats, and their host values.

  fill() writes each value (a float32 number) with one fill_ launch; the
  tensors are made on first fill, so before any capture that reads them.
  """

  def __init__(self, device):
    self.device = torch.device(device)
    self.tensors: Dict[str, torch.Tensor] = {}
    self.values: Dict[str, np.float32] = {}

  def fill(self, values: Mapping[str, float]) -> None:
    for name, value in values.items():
      value = np.float32(value)
      t = self.tensors.get(name)
      if t is None:
        t = self.tensors[name] = torch.zeros((), dtype=torch.float32, device=self.device)
      t.fill_(float(value))
      self.values[name] = value

  def __getitem__(self, name: str) -> torch.Tensor:
    return self.tensors[name]


class BatchStager:
  """Host batches to a device through pinned staging buffers and
  non_blocking copies. Two buffers alternate, and each is refilled only once
  its last copy has run, so a copy never reads bytes of a later batch. On a
  CPU device the array is taken as it is."""

  def __init__(self, device):
    self.device = torch.device(device)
    self._buffers = [None, None]
    self._events = [None, None]
    self._next = 0

  def __call__(self, array, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`array` on the device: in `out` (a tensor of its shape) when given,
    else in a new tensor."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    if self.device.type != "cuda":
      if out is None:
        return src.to(self.device)
      return out.copy_(src)
    i = self._next
    self._next = 1 - i
    buf = self._buffers[i]
    if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
      buf = self._buffers[i] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    elif self._events[i] is not None:
      self._events[i].synchronize()
    buf.copy_(src)
    if out is None:
      out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
    out.copy_(buf, non_blocking=True)
    event = self._events[i] = torch.cuda.Event()
    event.record(torch.cuda.current_stream(self.device))
    return out


def launch_counts() -> Dict[str, int]:
  """{kernel name: launches} of every kernel wrapper imported so far."""
  return {st.name: st.launches for st in cuda_build.KernelStats.registry}


def _set_launch_counts(counts: Mapping[str, int]) -> None:
  for st in cuda_build.KernelStats.registry:
    st.launches = counts.get(st.name, 0)


class CapturedStep:
  """body() -> {name: tensor}, the device work of a step, issued as one CUDA
  graph on `device`.

  The first `warmup` calls run body eagerly on a side stream, as PyTorch's
  graph documentation asks: cuDNN's and cuBLAS's choices, the kernels'
  library builds (ops/cuda_build.py) and their cached index tensors happen
  there. The next call captures body on that stream and replays it; every
  later call replays it and returns the same output tensors, refilled. body
  reads and writes only tensors that outlive it (static inputs, parameters,
  Adam's moments, StepScalars) and waits for nothing on the host.

  The kernel wrappers count a launch on the host when their Python runs: a
  capture's counts are taken back, kept in `launches_per_replay` and added
  at each replay, so the counts stay the launches the card made.
  """

  def __init__(self, body: Callable[[], Dict[str, torch.Tensor]], device, warmup: int = 1):
    self.body = body
    self.device = torch.device(device)
    self.warmup = warmup
    self.calls = 0
    self.graph = None
    self.outputs: Dict[str, torch.Tensor] = {}
    self.launches_per_replay: Dict[str, int] = {}
    self._stream = None

  def __call__(self) -> Dict[str, torch.Tensor]:
    if self.graph is None and self.calls < self.warmup:
      self.calls += 1
      return self._warmup()
    if self.graph is None:
      before = launch_counts()
      try:
        self.outputs = self._capture()
      finally:
        captured = launch_counts()
        _set_launch_counts(before)
      self.launches_per_replay = {k: n - before.get(k, 0) for k, n in captured.items()
                                  if n != before.get(k, 0)}
    self._replay()
    for st in cuda_build.KernelStats.registry:
      st.launches += self.launches_per_replay.get(st.name, 0)
    self.calls += 1
    return dict(self.outputs)

  def _side_stream(self):
    if self._stream is None:
      self._stream = torch.cuda.Stream(self.device)
    self._stream.wait_stream(torch.cuda.current_stream(self.device))
    return self._stream

  def _warmup(self) -> Dict[str, torch.Tensor]:
    stream = self._side_stream()
    with torch.cuda.stream(stream):
      out = self.body()
    torch.cuda.current_stream(self.device).wait_stream(stream)
    return out

  def _capture(self) -> Dict[str, torch.Tensor]:
    stream = self._side_stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
      out = self.body()
    self.graph = graph
    return out

  def _replay(self) -> None:
    self.graph.replay()


_CAPTURE_FAILURE = """
import torch
from shallow_ntc_tpu_torch import step_graph
x = torch.ones(4, device="cuda")
step = step_graph.CapturedStep(lambda: {"y": x * x.sum().item()}, "cuda", warmup=0)
try:
  step()
except RuntimeError as e:
  print("raised:", str(e).strip().splitlines()[0])
else:
  raise SystemExit("the capture did not raise")
"""


def run_capture_failure(cwd: str, timeout: float = 300) -> subprocess.CompletedProcess:
  """Capture a step whose body waits for the card (.item()), in a process of
  its own (a failed capture may leave its CUDA context unusable), from `cwd`,
  a directory that holds this package. The capture must raise: the process
  then exits 0 with stdout "raised: <the error's first line>"."""
  return subprocess.run([sys.executable, "-c", _CAPTURE_FAILURE], cwd=cwd, capture_output=True,
                        text=True, timeout=timeout)


def write_dispatch_record(path: str, dispatch: str, **extra) -> None:
  """<path>: {"step_dispatch": the record name of `dispatch`, **extra}."""
  record = {"step_dispatch": RECORD_NAMES[dispatch], **extra}
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, "w") as f:
    json.dump(record, f, indent=2)
