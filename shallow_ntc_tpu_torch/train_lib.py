"""Training of the port: optimizer, train/eval steps, checkpoints and the loop.

Mirrors shallow_ntc_tpu/train_lib.py. The JAX step is a pure function of a
TrainState pytree; here the state (model, optimizer, step, noise generator)
is updated in place and the step returns its metrics. The optimizer is
optax's chain(clip_by_global_norm, adam) written out (Adam's eps 1e-7, the
learning rate lr_fn(count) with the count taken before the update), so the
two packages take the same steps. Checkpoints are torch.save files.
The experiment bookkeeping is JAX's: setup_workdir makes
<experiments_dir>/<xid>/[wid=<wid>-]<run name>/ with config.json,
run_info.json and copies of the config script and the model sources, and
train_eval_config's warm_start (a checkpoints directory, a workdir, or an
experiment directory searched by warm_start_wid) starts a run from another
run's params and step with a fresh optimizer.

Data parallel (train_lib.py:318-345, :371-378, :419-444): in a process
group (parallel/distributed.initialize), every rank iterates the same
seeded global batches and keeps its rows, the loss goes through
DistributedDataParallel (parallel/mesh.py), which averages the gradients,
and the optimizer clips and steps on that global gradient on every rank.
The training noise is drawn for the global batch from the state's
generator and each rank takes its rows, so the run equals a one-process
run of the global batch up to the order of its float sums, and the
generators stay equal. Logged train
metrics and val metrics are means over the global batch. Only rank 0
writes record.jsonl files, checkpoints and the workdir's files; the
others wait at a barrier before they restore or warm-start.
Checkpoints hold the plain module's state dict either way.
The writers are utils/writers.create_default_writer's (<workdir>/train/ and
<workdir>/val/: record.jsonl, and TensorBoard when tensorboardX imports);
each val pass also writes a grid of the first val batch's reconstruction
(center crops of at most 256x256) as the image "reconstruction".
On the card each train step is one CUDA graph, captured once and replayed
(StaticTrainStep, step_graph.CapturedStep): the counterpart of JAX's jitted
train step. The CPU, and a process group, issue the step eagerly
(make_train_step); a caller can ask for either (`dispatch`). JAX's
steps_per_dispatch, a lax.scan window of steps a dispatch, is accepted and
not ported: each step is one replay.
"""

import dataclasses
import glob
import hashlib
import json
import logging
import os
import re
import shutil
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import schedule as schedule_lib
from shallow_ntc_tpu_torch import step_graph
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.models import families
from shallow_ntc_tpu_torch.ops import metrics_ops
from shallow_ntc_tpu_torch.parallel import distributed
from shallow_ntc_tpu_torch.parallel import mesh as mesh_lib
from shallow_ntc_tpu_torch.utils import runname as runname_utils
from shallow_ntc_tpu_torch.utils import writers as writers_lib


class Metrics:
  """Host-side accumulator of scalar dicts and image batches (train_lib.py:40-90)."""

  def __init__(self):
    self.scalars: Dict[str, Any] = {}
    self.images: Dict[str, np.ndarray] = {}

  def record_scalars(self, d: Mapping[str, Any]):
    self.scalars.update(d)

  def record_image(self, key: str, value):
    self.images[key] = value

  def scalars_float(self) -> Dict[str, float]:
    return {k: float(v) for k, v in self.scalars.items()}

  def images_grid(self, crop_to_max_dim: int = 256) -> Dict[str, np.ndarray]:
    """Each image batch tiled into one grid (metrics_ops.visualize_image_batch)."""
    return {k: metrics_ops.visualize_image_batch(v, crop_to_max_dim=crop_to_max_dim)
            for k, v in self.images.items()}

  @staticmethod
  def merge_metrics(metrics_list: Iterable["Metrics"]) -> "Metrics":
    """Mean over each scalar."""
    metrics_list = list(metrics_list)
    merged = Metrics()
    if metrics_list:
      for k in metrics_list[0].scalars:
        merged.scalars[k] = float(np.mean([float(m.scalars[k]) for m in metrics_list
                                           if k in m.scalars]))
    return merged


class Adam:
  """optax.chain(clip_by_global_norm(global_clipnorm), adam(lr_fn, b1, b2, eps)).

  Clipping scales by global_clipnorm / norm only when norm >= global_clipnorm
  (torch's clip_grad_norm_ adds 1e-6 to the norm and differs). Moments and
  bias corrections follow optax's scale_by_adam; the step is -lr_fn(count)
  times the Adam direction, with count the number of earlier updates.

  An update is host work, prepare() (the count, and the learning rate and
  bias corrections as float32 values filled into 0-dim tensors on the
  params' device, `scalars`), then device work, apply(grads), which reads
  those tensors and waits for nothing: a captured step replays apply().
  update() is the two in turn.
  """

  def __init__(self, params: Sequence[torch.Tensor], lr_fn: Callable[[int], float],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
               global_clipnorm: Optional[float] = None):
    self.params = list(params)
    self.lr_fn = lr_fn
    self.b1, self.b2, self.eps = b1, b2, eps
    self.global_clipnorm = global_clipnorm
    self.count = 0
    self.mu = [torch.zeros_like(p) for p in self.params]
    self.nu = [torch.zeros_like(p) for p in self.params]
    self.scalars = step_graph.StepScalars(self.params[0].device if self.params else "cpu")
    self._fill_scalars(np.float32(0), np.float32(1), np.float32(1))

  def update(self, grads: Sequence[torch.Tensor]) -> None:
    """Apply one update to the params from `grads` (one per param)."""
    self.prepare()
    self.apply(grads)

  def prepare(self) -> None:
    """The host half of an update: fill the scalars of update count + 1.

    The bias corrections divide as PyTorch divides by a host number: on the
    card a multiply by its float32 reciprocal ("inv_bc1", "inv_bc2"), on the
    CPU a division ("bc1", "bc2"), so the update is the one it was with host
    floats, bit for bit, on either. That CUDA lowering is PyTorch's, not a
    documented contract, so it is checked, not assumed: chip_smoke.py's
    adam_check (phase 8) holds this update against the per-parameter loop
    with host floats, unclipped bit for bit, and fails if a PyTorch upgrade
    moves it. sga_round (ops/rounding.py) takes the other way: it divides
    truly on both devices, so eager SGA on the card differs in the last bit
    from a host-float tau."""
    lr = np.float32(self.lr_fn(self.count))
    self.count += 1
    self._fill_scalars(lr, np.float32(1) - np.power(np.float32(self.b1), np.float32(self.count)),
                       np.float32(1) - np.power(np.float32(self.b2), np.float32(self.count)))

  def _fill_scalars(self, lr: np.float32, bc1: np.float32, bc2: np.float32) -> None:
    if self.scalars.device.type == "cuda":
      self.scalars.fill({"neg_lr": -lr, "inv_bc1": np.float32(1) / bc1,
                         "inv_bc2": np.float32(1) / bc2})
    else:
      self.scalars.fill({"neg_lr": -lr, "bc1": bc1, "bc2": bc2})

  def _unbias(self, tensors: List[torch.Tensor], name: str) -> List[torch.Tensor]:
    if self.scalars.device.type == "cuda":
      return torch._foreach_mul(tensors, self.scalars["inv_" + name])
    return torch._foreach_div(tensors, self.scalars[name])

  @torch.no_grad()
  def apply(self, grads: Sequence[torch.Tensor]) -> None:
    """The device half of an update, with the scalars prepare() filled.

    Multi-tensor: torch._foreach_* ops over all the tensors at once, so the
    host dispatches the same 25 ops whatever their number. Per element the
    arithmetic is the per-tensor form's, op for op:
    mu = (1-b1)*g + b1*mu, nu = (1-b2)*g*g + b2*nu,
    p += -lr * (mu/bc1) / (sqrt(nu/bc2) + eps).
    """
    grads = list(grads)
    if self.global_clipnorm is not None:
      # optax's select with no host sync: g / 1 * 1 == g exactly when kept,
      # else (g / norm) * global_clipnorm.
      norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
      keep = norm < self.global_clipnorm
      grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
      clipnorm = torch.full_like(norm, self.global_clipnorm)
      torch._foreach_mul_(grads, torch.where(keep, 1.0, clipnorm))
    step = torch._foreach_mul(grads, 1 - self.b1)
    torch._foreach_mul_(self.mu, self.b1)
    torch._foreach_add_(self.mu, step)
    step = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(step, 1 - self.b2)
    torch._foreach_mul_(self.nu, self.b2)
    torch._foreach_add_(self.nu, step)
    denom = self._unbias(self.nu, "bc2")
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, self.eps)
    step = self._unbias(self.mu, "bc1")
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, self.scalars["neg_lr"])
    torch._foreach_add_(self.params, step)

  def reset(self) -> None:
    """Back to no update: count 0, the moments zeroed in place."""
    self.count = 0
    with torch.no_grad():
      torch._foreach_zero_(self.mu + self.nu)

  def state_dict(self) -> Dict[str, Any]:
    return {"count": self.count, "mu": [t.clone() for t in self.mu],
            "nu": [t.clone() for t in self.nu]}

  def load_state_dict(self, state: Mapping[str, Any]) -> None:
    self.count = int(state["count"])
    with torch.no_grad():
      for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
        dst.copy_(src)


def make_optimizer(params: Sequence[torch.Tensor], optimizer_config: Mapping[str, Any],
                   scheduled_num_steps: int) -> Tuple[Adam, Callable[[int], float]]:
  """Adam with the compression LR schedule (train_lib.py:105-139).

  Config keys: learning_rate (1e-4), reduce_lr_after (0.8), reduce_lr_factor
  (0.1), warmup_steps | warmup_until (0.02), global_clipnorm (optional),
  beta_1, beta_2, epsilon (1e-7, Keras' default, as the JAX package).
  """
  cfg = dict(optimizer_config or {})
  learning_rate = cfg.pop("learning_rate", 1e-4)
  reduce_lr_after = cfg.pop("reduce_lr_after", 0.8)
  reduce_lr_factor = cfg.pop("reduce_lr_factor", 0.1)
  warmup_steps = cfg.pop("warmup_steps", None)
  warmup_until = cfg.pop("warmup_until", 0.02)
  global_clipnorm = cfg.pop("global_clipnorm", None)
  beta_1 = cfg.pop("beta_1", 0.9)
  beta_2 = cfg.pop("beta_2", 0.999)
  epsilon = cfg.pop("epsilon", 1e-7)
  if cfg:
    raise ValueError(f"Unknown optimizer_config keys: {sorted(cfg)}")
  lr_fn = schedule_lib.compression_schedule(
      base_learning_rate=learning_rate, total_num_steps=scheduled_num_steps,
      warmup_until=warmup_until, warmup_steps=warmup_steps, drop_after=reduce_lr_after,
      drop_factor=reduce_lr_factor)
  return Adam(params, lr_fn, beta_1, beta_2, epsilon, global_clipnorm), lr_fn


@dataclasses.dataclass
class TrainState:
  """What a checkpoint holds: the model's params, the optimizer's moments
  and count, the step, and the generator of the training noise."""

  model: nn.Module
  optimizer: Adam
  step: int
  generator: torch.Generator


def create_train_state(model: nn.Module, optimizer_config: Mapping[str, Any],
                       seed: int = 0) -> Tuple[TrainState, Callable[[int], float]]:
  """Optimizer and noise generator for `model` (already on its device)."""
  params = list(model.parameters())
  optimizer, lr_fn = make_optimizer(params, optimizer_config, model.scheduled_num_steps)
  generator = torch.Generator(device=params[0].device)
  generator.manual_seed(seed)
  return TrainState(model=model, optimizer=optimizer, step=0, generator=generator), lr_fn


def _train_host_metrics(model: nn.Module, scalars: step_graph.StepScalars, step: int,
                        lr_fn: Callable[[int], float]) -> Dict[str, torch.Tensor]:
  """Fill the model scalars of train step `step`; return its host metrics."""
  values = models_base.step_scalar_values(model, step)
  scalars.fill(values)
  return {**models_base.host_step_metrics(values),
          "scheduled_lr": torch.tensor(float(lr_fn(step)))}


def _loss_and_grads(model: nn.Module, params: List[torch.Tensor], batch: torch.Tensor,
                    step: int, scalars: step_graph.StepScalars, noise=None, generator=None):
  """(metrics, one gradient per param) of the training loss: the device half
  of a train step before Adam's update. The gradients go to p.grad, laid
  out as their params (autograd.grad's could be laid out otherwise, and the
  clip's norm sums in the order of the layout); in a captured step they
  live in the graph's pool, and no code outside it resets them."""
  for p in params:
    p.grad = None
  loss, metrics, _ = model.end_to_end_frame_loss(batch, training=True, step=step, noise=noise,
                                                 generator=generator, scalars=scalars)
  loss.backward()
  return ({k: v.detach() for k, v in metrics.items()},
          [torch.zeros_like(p) if p.grad is None else p.grad for p in params])


def make_train_step(model: nn.Module, optimizer: Adam, lr_fn: Callable[[int], float]):
  """(state, batch, noise=None) -> metrics; updates the state in place,
  issued eagerly.

  `noise`, one uniform draw per latent ((u_z, u_y) for mshyper, (u_y,) for
  factorized) of the global batch, replaces the draws from the state's
  generator. In a process group the batch is this rank's rows of the global
  batch, the step takes its rows of the noise (drawn for the global batch
  when not given) and DDP averages the gradients; the metrics are this
  rank's. Outside one, the step reads the scheduled lambda from a 0-dim
  tensor as StaticTrainStep does, so the two take the same steps.
  """
  params = list(model.parameters())
  ddp = mesh_lib.data_parallel(model) if distributed.in_group() else None
  scalars = step_graph.StepScalars(params[0].device)

  def train_step(state: TrainState, batch: torch.Tensor,
                 noise: Optional[Tuple[torch.Tensor, ...]] = None):
    if ddp is None:
      host = _train_host_metrics(model, scalars, state.step, lr_fn)
      metrics, grads = _loss_and_grads(
          model, params, batch, state.step, scalars, noise,
          generator=None if noise is not None else state.generator)
      optimizer.update(grads)
      metrics = {**metrics, **host}
    else:
      for p in params:
        p.grad = None
      global_shape = (batch.shape[0] * distributed.process_count(),) + tuple(batch.shape[1:])
      if noise is None:
        noise = model.training_noise(global_shape, state.generator)
      start, stop = distributed.local_batch_slice(global_shape[0])
      loss, metrics, _ = ddp(batch, state.step, tuple(n[start:stop] for n in noise))
      loss.backward()
      optimizer.update([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
      metrics = {k: v.detach() for k, v in metrics.items()}
      metrics["scheduled_lr"] = torch.tensor(float(lr_fn(state.step)))
    state.step += 1
    return metrics

  return train_step


class StaticTrainStep:
  """(state, host batch) -> metrics: the train step on static tensors, the
  function that a CUDA graph captures (capture=True: step_graph.CapturedStep,
  one capture per batch shape) or that runs eagerly (capture=False), with
  make_train_step's arithmetic.

  Before each step the host stages the batch into the static batch (pinned
  memory, a non_blocking copy: step_graph.BatchStager), draws the unoise
  noise from state.generator into static buffers (model.training_noise:
  the draws the eager step takes, in its order, so checkpoints resume as
  theirs), fills the scheduled lambda and Adam's scalars (Adam.prepare) and
  then runs the device work: the forward, the gradients (p.grad, in the
  graph's pool) and Adam.apply on the parameters and moments in place. The
  noise is uniform: the step of a unoise or mixedq model.
  """

  def __init__(self, model: nn.Module, optimizer: Adam, lr_fn: Callable[[int], float],
               capture: bool):
    method = model.latent_config.get("uq", {}).get("method", "unoise")
    if method not in ("unoise", "mixedq"):
      raise ValueError(f"the static train step draws uniform noise; uq method {method!r}")
    self.model, self.optimizer, self.lr_fn, self.capture = model, optimizer, lr_fn, capture
    self.params = list(model.parameters())
    self.device = self.params[0].device
    self.scalars = step_graph.StepScalars(self.device)
    self.stager = step_graph.BatchStager(self.device)
    self.shapes: Dict[tuple, Tuple[torch.Tensor, Tuple[torch.Tensor, ...], Callable]] = {}
    self._step = 0

  def _static(self, shape, dtype):
    key = (tuple(shape), dtype)
    if key not in self.shapes:
      batch = torch.empty(shape, dtype=dtype, device=self.device)
      noise = tuple(torch.zeros_like(n) for n in self.model.training_noise(
          shape, torch.Generator(device=self.device)))

      def body():
        metrics, grads = _loss_and_grads(self.model, self.params, batch, self._step,
                                         self.scalars, noise)
        self.optimizer.apply(grads)
        return metrics

      run = step_graph.CapturedStep(body, self.device) if self.capture else body
      self.shapes[key] = (batch, noise, run)
    return self.shapes[key]

  def __call__(self, state: TrainState, array) -> Dict[str, torch.Tensor]:
    array = np.asarray(array)
    batch, noise, run = self._static(array.shape,
                                     torch.from_numpy(np.empty(0, array.dtype)).dtype)
    self.stager(array, out=batch)
    host = _train_host_metrics(self.model, self.scalars, state.step, self.lr_fn)
    with torch.no_grad():
      for buf, draw in zip(noise, self.model.training_noise(array.shape, state.generator)):
        buf.copy_(draw)
    self.optimizer.prepare()
    self._step = state.step
    metrics = {**run(), **host}
    state.step += 1
    return metrics

  def launches_per_replay(self) -> Dict[str, Dict[str, int]]:
    """{batch shape: the kernel launches of one replay} of each capture."""
    return {"x".join(map(str, key[0])): dict(run.launches_per_replay)
            for key, (_, _, run) in self.shapes.items()
            if isinstance(run, step_graph.CapturedStep)}


def make_eval_step(model: nn.Module):
  """(state, batch) -> (metrics, reconstruction on the 255 scale), training=False."""

  def eval_step(state: TrainState, batch: torch.Tensor):
    with torch.no_grad():
      _, metrics, rec255 = model.end_to_end_frame_loss(batch, training=False, step=state.step)
    return metrics, rec255

  return eval_step


def train_stepper(model: nn.Module, optimizer: Adam, lr_fn: Callable[[int], float],
                  dispatch: str) -> Callable[[TrainState, Any], Dict[str, torch.Tensor]]:
  """(state, host batch) -> metrics: a train step issued as `dispatch`
  ("eager": make_train_step's, its batch staged through pinned memory;
  "static" or "graph": a StaticTrainStep)."""
  if dispatch != "eager":
    return StaticTrainStep(model, optimizer, lr_fn, capture=dispatch == "graph")
  eager_step = make_train_step(model, optimizer, lr_fn)
  stager = step_graph.BatchStager(next(model.parameters()).device)
  return lambda state, array: eager_step(state, stager(array))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def checkpoint_dir(workdir: str) -> str:
  return os.path.join(workdir, "train", "checkpoints")


def _checkpoint_steps(ckpt_dir: str) -> List[int]:
  if not os.path.isdir(ckpt_dir):
    return []
  return sorted(int(m.group(1)) for m in map(re.compile(r"ckpt_(\d+)\.pt$").match,
                                             os.listdir(ckpt_dir)) if m)


def save_checkpoint(workdir: str, state: TrainState, max_to_keep: int = 1) -> str:
  """Write train/checkpoints/ckpt_<step>.pt; keep the newest `max_to_keep`
  (0: every one)."""
  d = checkpoint_dir(workdir)
  os.makedirs(d, exist_ok=True)
  path = os.path.join(d, f"ckpt_{state.step}.pt")
  payload = {"step": state.step, "model": state.model.state_dict(),
             "optimizer": state.optimizer.state_dict(),
             "generator": state.generator.get_state()}
  torch.save(payload, path + ".tmp")
  os.replace(path + ".tmp", path)
  for step in _checkpoint_steps(d)[:-max_to_keep] if max_to_keep else []:
    os.remove(os.path.join(d, f"ckpt_{step}.pt"))
  return path


def load_newest_checkpoint(ckpt_dir: str, map_location="cpu") -> Dict[str, Any]:
  """The payload of the newest ckpt_<step>.pt under a checkpoints directory."""
  steps = _checkpoint_steps(ckpt_dir)
  if not steps:
    raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
  return torch.load(os.path.join(ckpt_dir, f"ckpt_{steps[-1]}.pt"), map_location=map_location,
                    weights_only=True)


def params_digest(state_dict: Mapping[str, torch.Tensor]) -> str:
  """SHA-256 of a state dict's names, dtypes, shapes and bytes in name order:
  equal digests mean bit-equal params."""
  h = hashlib.sha256()
  for name in sorted(state_dict):
    t = state_dict[name].detach().cpu().contiguous()
    h.update(f"{name}:{t.dtype}:{tuple(t.shape)};".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
  return h.hexdigest()


def latest_checkpoint_step(workdir: str) -> Optional[int]:
  steps = _checkpoint_steps(checkpoint_dir(workdir))
  return steps[-1] if steps else None


def model_from_checkpoint(workdir: str, model_config: Mapping[str, Any],
                          device: Optional[str] = "cuda", family: str = "mshyper") -> nn.Module:
  """The `family` model of `model_config` with the params of the newest
  checkpoint under `workdir`, on `device` in eval mode."""
  step = latest_checkpoint_step(workdir)
  if step is None:
    raise FileNotFoundError(f"no checkpoint under {checkpoint_dir(workdir)}")
  device = eval_lib.resolve_device(device)
  payload = torch.load(os.path.join(checkpoint_dir(workdir), f"ckpt_{step}.pt"),
                       map_location="cpu", weights_only=True)
  model, _ = families.build_model(model_config, family)
  model.load_state_dict(payload["model"])
  return model.to(device).eval()


def restore_checkpoint(workdir: str, state: TrainState) -> TrainState:
  """Load the newest checkpoint under `workdir` into `state` (in place)."""
  step = latest_checkpoint_step(workdir)
  if step is None:
    return state
  device = next(state.model.parameters()).device
  payload = torch.load(os.path.join(checkpoint_dir(workdir), f"ckpt_{step}.pt"),
                       map_location=device, weights_only=True)
  state.model.load_state_dict(payload["model"])
  state.optimizer.load_state_dict(payload["optimizer"])
  state.generator.set_state(payload["generator"].cpu())
  state.step = int(payload["step"])
  return state


def resolve_warm_start_dir(warm_start: str, wid=None) -> Optional[str]:
  """The checkpoints directory of `warm_start` (train_lib.py:271-288): a
  checkpoints directory itself, a workdir, or an experiment directory whose
  work unit wid=<wid>-* holds one."""
  if not warm_start:
    return None
  if os.path.basename(os.path.normpath(warm_start)) == "checkpoints":
    return warm_start
  cand = checkpoint_dir(warm_start)
  if os.path.isdir(cand):
    return cand
  if wid is not None:
    matches = sorted(glob.glob(os.path.join(warm_start, f"wid={wid}-*")))
    if matches:
      return checkpoint_dir(matches[0])
  raise FileNotFoundError(
      f"Could not resolve warm start checkpoints from {warm_start!r} (wid={wid})")


def restore_params_from_dir(ckpt_dir: str, state: TrainState) -> TrainState:
  """Load the params and step of the newest checkpoint under `ckpt_dir` into
  `state` (in place); the optimizer and the noise generator stay as they
  are, fresh for a warm start (train_lib.py:291-314)."""
  payload = load_newest_checkpoint(ckpt_dir, next(state.model.parameters()).device)
  state.model.load_state_dict(payload["model"])
  state.step = int(payload["step"])
  return state


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------
def evaluate_model(eval_step, state: TrainState, val_iter: Iterable,
                   max_batches: Optional[int] = None) -> Metrics:
  """Mean metrics of eval_step over up to `max_batches` batches, and the
  first batch's reconstruction (0..255 floats) as the image
  "reconstruction" (train_lib.py:318-348); in a process group, each rank
  takes its rows of every batch (and keeps its rows of the image) and the
  means are over the global batches."""
  device = next(state.model.parameters()).device
  all_metrics = []
  images = None
  for i, batch in enumerate(distributed.shard_batches(val_iter)):
    if max_batches is not None and i >= max_batches:
      break
    metrics, rec = eval_step(state, torch.as_tensor(np.asarray(batch), device=device))
    m = Metrics()
    m.record_scalars({k: float(v) for k, v in metrics.items()})
    all_metrics.append(m)
    if images is None:
      images = rec.float().cpu().numpy()
  merged = Metrics.merge_metrics(all_metrics)
  merged.scalars = distributed.mean_over_processes(merged.scalars)
  if images is not None:
    merged.record_image("reconstruction", images)
  return merged


def simple_train_eval_loop(train_eval_config: Mapping[str, Any], workdir: str, model: nn.Module,
                           optimizer_config: Mapping[str, Any], train_iter: Iterable,
                           val_iter_factory: Callable[[], Iterable],
                           seed: int = 0, dispatch: str = "auto") -> TrainState:
  """Train with periodic logging, checkpoints and eval (train_lib.py:331-460);
  resumes from the newest checkpoint under `workdir`, or else warm-starts
  from train_eval_config's warm_start (and warm_start_wid). In a process
  group (see the module docstring) only rank 0 writes. Returns the state.

  `dispatch` (step_graph.DISPATCHES) issues the steps: by default on the
  card a CUDA graph of StaticTrainStep replayed a step, on the CPU and in
  a process group make_train_step's eager step. Each step is one replay:
  train_eval_config's steps_per_dispatch (JAX's lax.scan window) is
  accepted and not ported. <workdir>/step_dispatch.json says how the steps
  were issued and, at the end, each graph's kernel launches per replay."""
  cfg = dict(train_eval_config)
  num_steps = cfg.get("num_steps", 100)
  log_every = cfg.get("log_metrics_every_steps", 100)
  ckpt_every = cfg.get("checkpoint_every_steps", 10000)
  eval_every = cfg.get("eval_every_steps", 10000)
  max_val_batches = cfg.get("max_validation_steps", 16)
  primary = distributed.is_primary()
  train_writer = writers_lib.create_default_writer(workdir, just_logging=not primary,
                                                   collection="train")
  val_writer = writers_lib.create_default_writer(workdir, just_logging=not primary,
                                                 collection="val")
  device = next(model.parameters()).device

  state, lr_fn = create_train_state(model, optimizer_config, seed)
  distributed.barrier()  # rank 0 has set up the workdir
  if latest_checkpoint_step(workdir) is not None:
    restore_checkpoint(workdir, state)
  elif cfg.get("warm_start"):
    restore_params_from_dir(resolve_warm_start_dir(cfg["warm_start"], cfg.get("warm_start_wid")),
                            state)
  dispatch = step_graph.resolve_dispatch(dispatch, device, distributed.in_group())
  record_path = os.path.join(workdir, "step_dispatch.json")
  train_step = train_stepper(model, state.optimizer, lr_fn, dispatch)
  if primary:
    step_graph.write_dispatch_record(record_path, dispatch)
  eval_step = make_eval_step(model)

  train_it = iter(distributed.shard_batches(iter(train_iter)))
  t_last, steps_since_log = time.time(), 0
  while state.step < num_steps:
    metrics = train_step(state, next(train_it))
    steps_since_log += 1
    step = state.step
    if step % log_every == 0 or step == num_steps:
      scalars = distributed.mean_over_processes(metrics)
      scalars["steps_per_sec"] = steps_since_log / max(time.time() - t_last, 1e-9)
      t_last, steps_since_log = time.time(), 0
      train_writer.write_scalars(step, scalars)
    if primary and (step % ckpt_every == 0 or step == num_steps):
      save_checkpoint(workdir, state, max_to_keep=cfg.get("max_to_keep", 1))
    if step % eval_every == 0 or step == num_steps:
      val = evaluate_model(eval_step, state, val_iter_factory(), max_batches=max_val_batches)
      val_writer.write_scalars(step, val.scalars_float())
      try:
        val_writer.write_images(step, val.images_grid())
      except ValueError as e:  # a grid cannot tile some ragged batches
        logging.warning("Skipping image grid: %s", e)
  train_writer.close()
  val_writer.close()
  if primary and isinstance(train_step, StaticTrainStep):
    step_graph.write_dispatch_record(record_path, dispatch,
                                     launches_per_replay=train_step.launches_per_replay())
  distributed.barrier()  # the last checkpoint is written
  return state


def build_model(model_config: Mapping[str, Any], init_seed: int, device: Optional[str] = "cuda",
                family: str = "mshyper") -> Tuple[nn.Module, Dict[str, Any]]:
  """(the `family` Model with a seeded flax-style init on `device`, its
  optimizer_config)."""
  model = eval_lib.build_model(model_config, init_seed=init_seed, device=device, family=family)
  return model.train(), dict(model_config.get("optimizer_config", {}))


def _train(cfg: Dict[str, Any], family: str, workdir: str, device: Optional[str],
           init_seed: int, dispatch: str = "auto") -> TrainState:
  """Build the `family` model of cfg["model_config"] and run the loop in
  `workdir` on cfg's data (train_lib.py:529-583), data-parallel in a
  process group; `init_seed` seeds the init, the data and the noise."""
  model, optimizer_config = build_model(cfg["model_config"], init_seed, device, family)
  train_cfg = cfg["train_data_config"]
  val_cfg = cfg.get("val_data_config") or train_cfg
  train_iter = data_lib.get_dataset(train_cfg["dataset"], "train", train_cfg["batchsize"],
                                    train_cfg["patchsize"], seed=init_seed)

  def val_iter_factory():
    return data_lib.get_dataset(val_cfg["dataset"], "test", val_cfg["batchsize"],
                                val_cfg.get("patchsize"))

  return simple_train_eval_loop(cfg["train_eval_config"], workdir, model, optimizer_config,
                                train_iter, val_iter_factory, seed=init_seed, dispatch=dispatch)


def _plain(config: Mapping[str, Any]) -> Dict[str, Any]:
  return {k: dict(v) if isinstance(v, Mapping) else v for k, v in config.items()}


def train_and_eval(config: Mapping[str, Any], workdir: str, device: Optional[str] = "cuda",
                   init_seed: int = 0, num_steps: Optional[int] = None,
                   images: Optional[str] = None, dispatch: str = "auto") -> TrainState:
  """The fixed-name train CLI's entry (train.py): build the model of
  config["model_family"] (mshyper when absent), train, checkpoint and
  evaluate in `workdir`.

  `images` (a glob of .npy images) replaces the config's synthetic data;
  `num_steps` cuts the loop, not the schedules (as a JAX dot-override of
  train_eval_config.num_steps does); `dispatch` is simple_train_eval_loop's.
  """
  cfg = _plain(config)
  if num_steps is not None:
    cfg["train_eval_config"]["num_steps"] = num_steps
  if images is not None:
    cfg["train_data_config"] = dict(cfg["train_data_config"], dataset=images)
    cfg["val_data_config"] = dict(cfg.get("val_data_config") or cfg["train_data_config"],
                                  dataset=images)
  os.makedirs(workdir, exist_ok=True)
  with open(os.path.join(workdir, "config.json"), "w") as f:
    json.dump(cfg, f, indent=2, default=list)
  return _train(cfg, cfg.get("model_family", "mshyper"), workdir, device, init_seed, dispatch)


def setup_workdir(config: Mapping[str, Any], experiments_dir: str, runname: str,
                  config_script: Optional[str] = None) -> str:
  """Make <experiments_dir>/<xid>/[wid=<wid>-]<runname>/ with config.json,
  a copy of the config script, run_info.json and copies of the model
  sources (train_lib.py:503-526); return its path."""
  xid = runname_utils.get_xid()
  wid = runname_utils.get_wid()
  wu_name = f"wid={wid}-{runname}" if wid is not None else runname
  workdir = os.path.join(experiments_dir, str(xid), wu_name)
  os.makedirs(workdir, exist_ok=True)
  runname_utils.dump_json(config, os.path.join(workdir, "config.json"))
  if config_script and os.path.isfile(config_script):
    shutil.copy(config_script, os.path.join(workdir, os.path.basename(config_script)))
  runname_utils.log_run_info(workdir)
  from shallow_ntc_tpu_torch.models import factorized as factorized_models
  from shallow_ntc_tpu_torch.models import mshyper as mshyper_models

  for mod in (factorized_models, mshyper_models):
    shutil.copy(mod.__file__, os.path.join(workdir, os.path.basename(mod.__file__)))
  return workdir


def train_and_eval_experiment(config: Mapping[str, Any], model_family: str,
                              experiments_dir: str, runname: str,
                              config_script: Optional[str] = None,
                              device: Optional[str] = "cuda", seed: int = 0,
                              dispatch: str = "auto") -> Tuple[TrainState, str]:
  """The experiment CLIs' entry (train_lib.py:529-583): set up the workdir
  (rank 0 of a process group, which sends its path to the others: a
  timestamp xid is rank 0's), then train the `model_family` model of the
  resolved `config` on its datasets, data-parallel in a process group.
  `seed` seeds the init, the data and the training noise, 0 as the JAX
  package's train_and_eval by default; `dispatch` is
  simple_train_eval_loop's. Returns (state, workdir)."""
  cfg = _plain(config)
  workdir = None
  if distributed.is_primary():
    workdir = setup_workdir(cfg, experiments_dir, runname, config_script)
  workdir = distributed.broadcast_from_primary(workdir)
  return _train(cfg, model_family, workdir, device, seed, dispatch), workdir
