"""Training of the port: optimizer, train/eval steps, checkpoints and the loop.

Mirrors shallow_ntc_tpu/train_lib.py. The JAX step is a pure function of a
TrainState pytree; here the state (model, optimizer, step, noise generator)
is updated in place and the step returns its metrics. The optimizer is
optax's chain(clip_by_global_norm, adam) written out (Adam's eps 1e-7, the
learning rate lr_fn(count) with the count taken before the update), so the
two packages take the same steps. Checkpoints are torch.save files.
Not ported: steps_per_dispatch (a TPU scan window), warm start, the
multi-host bookkeeping and the image grids.
"""

import dataclasses
import json
import os
import re
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import schedule as schedule_lib
from shallow_ntc_tpu_torch.models import families


class Metrics:
  """Host-side accumulator of scalar dicts (train_lib.py:40-90, no images)."""

  def __init__(self):
    self.scalars: Dict[str, Any] = {}

  def record_scalars(self, d: Mapping[str, Any]):
    self.scalars.update(d)

  def scalars_float(self) -> Dict[str, float]:
    return {k: float(v) for k, v in self.scalars.items()}

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

  @torch.no_grad()
  def update(self, grads: Sequence[torch.Tensor]) -> None:
    """Apply one update to the params from `grads` (one per param)."""
    grads = list(grads)
    if self.global_clipnorm is not None:
      norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
      keep = norm < self.global_clipnorm  # a select, as optax's, with no host sync
      grads = [torch.where(keep, g, (g / norm) * self.global_clipnorm) for g in grads]
    lr = float(self.lr_fn(self.count))
    self.count += 1
    bc1 = float(np.float32(1) - np.power(np.float32(self.b1), np.float32(self.count)))
    bc2 = float(np.float32(1) - np.power(np.float32(self.b2), np.float32(self.count)))
    for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
      mu.copy_((1 - self.b1) * g + self.b1 * mu)
      nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
      direction = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
      p.add_(-lr * direction)

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


def make_train_step(model: nn.Module, optimizer: Adam, lr_fn: Callable[[int], float]):
  """(state, batch, noise=None) -> metrics; updates the state in place.

  `noise`, one uniform draw per latent ((u_z, u_y) for mshyper, (u_y,) for
  factorized), replaces the draws from the state's generator.
  """
  params = list(model.parameters())

  def train_step(state: TrainState, batch: torch.Tensor,
                 noise: Optional[Tuple[torch.Tensor, ...]] = None):
    for p in params:
      p.grad = None
    loss, metrics, _ = model.end_to_end_frame_loss(
        batch, training=True, step=state.step, noise=noise,
        generator=None if noise is not None else state.generator)
    loss.backward()
    optimizer.update([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["scheduled_lr"] = torch.tensor(float(lr_fn(state.step)))
    state.step += 1
    return metrics

  return train_step


def make_eval_step(model: nn.Module):
  """(state, batch) -> (metrics, reconstruction on the 255 scale), training=False."""

  def eval_step(state: TrainState, batch: torch.Tensor):
    with torch.no_grad():
      _, metrics, rec255 = model.end_to_end_frame_loss(batch, training=False, step=state.step)
    return metrics, rec255

  return eval_step


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
def checkpoint_dir(workdir: str) -> str:
  return os.path.join(workdir, "train", "checkpoints")


def _checkpoint_steps(workdir: str) -> List[int]:
  d = checkpoint_dir(workdir)
  if not os.path.isdir(d):
    return []
  return sorted(int(m.group(1)) for m in map(re.compile(r"ckpt_(\d+)\.pt$").match,
                                             os.listdir(d)) if m)


def save_checkpoint(workdir: str, state: TrainState, max_to_keep: int = 1) -> str:
  """Write train/checkpoints/ckpt_<step>.pt; keep the newest `max_to_keep`."""
  d = checkpoint_dir(workdir)
  os.makedirs(d, exist_ok=True)
  path = os.path.join(d, f"ckpt_{state.step}.pt")
  payload = {"step": state.step, "model": state.model.state_dict(),
             "optimizer": state.optimizer.state_dict(),
             "generator": state.generator.get_state()}
  torch.save(payload, path + ".tmp")
  os.replace(path + ".tmp", path)
  for step in _checkpoint_steps(workdir)[:-max_to_keep]:
    os.remove(os.path.join(d, f"ckpt_{step}.pt"))
  return path


def latest_checkpoint_step(workdir: str) -> Optional[int]:
  steps = _checkpoint_steps(workdir)
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


# ---------------------------------------------------------------------------
# Writers and the loop
# ---------------------------------------------------------------------------
class JsonlWriter:
  """record.jsonl: one {"step": ..., metric: ...} object per line
  (shallow_ntc_tpu/utils/writers.py:JsonlWriter)."""

  def __init__(self, logdir: str, filename: str = "record.jsonl"):
    os.makedirs(logdir, exist_ok=True)
    self.path = os.path.join(logdir, filename)

  def write_scalars(self, step: int, scalars: Mapping[str, Any]):
    if not scalars or set(scalars) == {"steps_per_sec"}:
      return
    record = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
    with open(self.path, "a") as f:
      f.write(json.dumps(record) + "\n")


def evaluate_model(eval_step, state: TrainState, val_iter: Iterable,
                   max_batches: Optional[int] = None) -> Metrics:
  """Mean metrics of eval_step over up to `max_batches` batches."""
  device = next(state.model.parameters()).device
  all_metrics = []
  for i, batch in enumerate(val_iter):
    if max_batches is not None and i >= max_batches:
      break
    metrics, _ = eval_step(state, torch.as_tensor(np.asarray(batch), device=device))
    m = Metrics()
    m.record_scalars({k: float(v) for k, v in metrics.items()})
    all_metrics.append(m)
  return Metrics.merge_metrics(all_metrics)


def simple_train_eval_loop(train_eval_config: Mapping[str, Any], workdir: str, model: nn.Module,
                           optimizer_config: Mapping[str, Any], train_iter: Iterable,
                           val_iter_factory: Callable[[], Iterable],
                           seed: int = 0) -> TrainState:
  """Train with periodic logging, checkpoints and eval (train_lib.py:331-460);
  resumes from the newest checkpoint under `workdir`. Returns the state."""
  cfg = dict(train_eval_config)
  num_steps = cfg.get("num_steps", 100)
  log_every = cfg.get("log_metrics_every_steps", 100)
  ckpt_every = cfg.get("checkpoint_every_steps", 10000)
  eval_every = cfg.get("eval_every_steps", 10000)
  max_val_batches = cfg.get("max_validation_steps", 16)
  train_writer = JsonlWriter(os.path.join(workdir, "train"))
  val_writer = JsonlWriter(os.path.join(workdir, "val"))
  device = next(model.parameters()).device

  state, lr_fn = create_train_state(model, optimizer_config, seed)
  restore_checkpoint(workdir, state)
  train_step = make_train_step(model, state.optimizer, lr_fn)
  eval_step = make_eval_step(model)

  train_it = iter(train_iter)
  t_last, steps_since_log = time.time(), 0
  while state.step < num_steps:
    batch = torch.as_tensor(np.asarray(next(train_it)), device=device)
    metrics = train_step(state, batch)
    steps_since_log += 1
    step = state.step
    if step % log_every == 0 or step == num_steps:
      scalars = {k: float(v) for k, v in metrics.items()}
      scalars["steps_per_sec"] = steps_since_log / max(time.time() - t_last, 1e-9)
      t_last, steps_since_log = time.time(), 0
      train_writer.write_scalars(step, scalars)
    if step % ckpt_every == 0 or step == num_steps:
      save_checkpoint(workdir, state, max_to_keep=cfg.get("max_to_keep", 1))
    if step % eval_every == 0 or step == num_steps:
      val = evaluate_model(eval_step, state, val_iter_factory(), max_batches=max_val_batches)
      val_writer.write_scalars(step, val.scalars_float())
  return state


def build_model(model_config: Mapping[str, Any], init_seed: int, device: Optional[str] = "cuda",
                family: str = "mshyper") -> Tuple[nn.Module, Dict[str, Any]]:
  """(the `family` Model with a seeded flax-style init on `device`, its
  optimizer_config)."""
  model = eval_lib.build_model(model_config, init_seed=init_seed, device=device, family=family)
  return model.train(), dict(model_config.get("optimizer_config", {}))


def train_and_eval(config: Mapping[str, Any], workdir: str, device: Optional[str] = "cuda",
                   init_seed: int = 0, num_steps: Optional[int] = None,
                   images: Optional[str] = None) -> TrainState:
  """The train CLI's entry: build the model of config["model_family"]
  (mshyper when absent), train, checkpoint and evaluate.

  `images` (a glob of .npy images) replaces the config's synthetic data;
  `num_steps` cuts the loop, not the schedules (as a JAX dot-override of
  train_eval_config.num_steps does).
  """
  cfg = {k: dict(v) if isinstance(v, Mapping) else v for k, v in config.items()}
  if num_steps is not None:
    cfg["train_eval_config"]["num_steps"] = num_steps
  model, optimizer_config = build_model(cfg["model_config"], init_seed, device,
                                        cfg.get("model_family", "mshyper"))
  train_cfg = cfg["train_data_config"]
  val_cfg = cfg.get("val_data_config") or train_cfg
  if images is not None:
    train_cfg = dict(train_cfg, dataset=images)
    val_cfg = dict(val_cfg, dataset=images)
  train_iter = data_lib.get_dataset(train_cfg["dataset"], "train", train_cfg["batchsize"],
                                    train_cfg["patchsize"], seed=init_seed)

  def val_iter_factory():
    return data_lib.get_dataset(val_cfg["dataset"], "test", val_cfg["batchsize"],
                                val_cfg["patchsize"])

  os.makedirs(workdir, exist_ok=True)
  with open(os.path.join(workdir, "config.json"), "w") as f:
    json.dump(cfg, f, indent=2, default=list)
  return simple_train_eval_loop(cfg["train_eval_config"], workdir, model, optimizer_config,
                                train_iter, val_iter_factory, seed=init_seed)
