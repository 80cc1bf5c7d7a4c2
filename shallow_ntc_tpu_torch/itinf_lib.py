"""Iterative inference (SGA encoding) of the port: the per-image optimization
of the latents at encode time (mirrors shallow_ntc_tpu/itinf_lib.py).

The model's parameters are frozen; its latents ((z, y) for mshyper, (y,)
for factorized) start from the analysis and take `num_steps` Adam steps on
the SGA-relaxed rd_loss, the relaxation's temperature tau annealed by the
step. Each step runs the synthesis (and the hyper-synthesis) forward and
backward (the flagship's final_deconv_phase once) and Adam's update, and
never waits for the device; metrics are read only at the log rows. On the
card the step is captured once as a CUDA graph (StaticSgaStep,
step_graph.CapturedStep) and replayed every step: the counterpart of JAX's
compiled step programs (ItinfJit.step, run_stream and the fused scan, which
the config's `step_dispatch` chooses among). On the CPU, or where a caller
asks (`dispatch`), the eager loop issues the same step op by op.

The draws of step s are those of a generator seeded by (seed, s), in the
latents' order (z's first), or `noise_fn(s)` where a caller gives them; a
val pass draws nothing. The eager step draws inside the forward; the
static step draws the same values before the step (step_draws), so both
take one trajectory, and a run split into segments by mid-run val passes
takes the same trajectory as one segment.

itinf_eval_experiment is the experiment CLIs' entry: it sets up a workdir
as training does and warm-starts from a training experiment's work unit
(train_eval_config's warm_start_exp_dir and warm_start_wid), the config's
model_config laid over the checkpoint's.
"""

import json
import os
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import step_graph
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
from shallow_ntc_tpu_torch.models import base as models_base
from shallow_ntc_tpu_torch.ops import rounding
from shallow_ntc_tpu_torch.utils import writers as writers_lib

Noise = Tuple[torch.Tensor, ...]  # one draw per latent, in the latents' order

# train_eval_config["transforms_dtype"] -> Model(transforms_dtype=...).
TRANSFORMS_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ItinfFunctions(NamedTuple):
  """The SGA surface of one model (itinf_lib.py:30-181).

  init(batch) -> (latents, optimizer): the analysis's latents as float32
      leaves and Adam over them;
  step(batch, latents, optimizer, step, offset, noise=None, generator=None)
      -> metrics: one SGA update in place, issued eagerly, with the log
      row's metrics (scheduled_lr included) as tensors;
  eval(batch, latents, step, offset) -> metrics: training=False (a hard
      round about the offset), with MS-SSIM;
  frozen_offset() -> the offset heuristic's grid, or None when it is off;
  static(batch, offset, capture) -> the StaticSgaStep of batch's shape and
      dtype, loaded with batch and its init latents: made (and on the card
      captured) once a pass for each shape, kept in `statics`.
  """
  init: Callable[[torch.Tensor], Tuple[LatentRVCollection, train_lib.Adam]]
  step: Callable[..., Dict[str, torch.Tensor]]
  eval: Callable[..., Dict[str, torch.Tensor]]
  frozen_offset: Callable[[], Optional[torch.Tensor]]
  static: Callable[..., "StaticSgaStep"]
  statics: Dict[tuple, "StaticSgaStep"]


class StaticSgaStep:
  """The SGA step of one batch shape on static tensors: the function that a
  CUDA graph captures (step_graph.CapturedStep, capture=True) or that runs
  eagerly (capture=False), with the eager step's arithmetic.

  The batch, the offset, the latents (leaves that require grad), Adam's
  moments, the step's draws and its scalars (lambda, tau, Adam's learning
  rate and bias corrections) are tensors that live as long as this object.
  Before each step the host fills the scalars and copies in the step's
  draws, which it makes as the eager loop's generator makes them
  (step_draws), so both take one trajectory; load() copies in a new batch
  of the same shape and its init latents and zeroes the moments, so one
  capture serves a pass.
  """

  def __init__(self, fill, device_step, batch, latents, optimizer, offset, capture):
    self._fill = fill
    self.batch = batch.clone()
    self.latents = latents
    self.optimizer = optimizer
    self.offset = None if offset is None else offset.clone()
    self.noise = tuple(torch.zeros_like(rv.loc) for rv in latents.uq)
    self.scalars = step_graph.StepScalars(batch.device)
    self._step = 0

    def body():
      return device_step(self.batch, self.latents, self._step, self.offset, self.scalars,
                         optimizer.apply, noise=self.noise)

    self.run = step_graph.CapturedStep(body, batch.device) if capture else body

  @torch.no_grad()
  def load(self, batch, latents, offset) -> None:
    self.batch.copy_(batch)
    for dst, src in zip(self.latents.uq, latents.uq):
      dst.loc.copy_(src.loc)
    if offset is not None:
      self.offset.copy_(offset)
    self.optimizer.reset()

  def __call__(self, step: int, noise: Noise) -> Dict[str, torch.Tensor]:
    """One SGA update with `noise`, one draw per latent; the step's metrics
    (on the card: the graph's output tensors, refilled at the next step)."""
    host = self._fill(self.scalars, self.optimizer, step)
    self.optimizer.prepare()
    with torch.no_grad():
      for buf, draw in zip(self.noise, noise):
        buf.copy_(draw)
    self._step = step
    return {**self.run(), **host}


def make_itinf_functions(model: nn.Module, optimizer_config: Mapping[str, Any],
                         num_steps: int) -> ItinfFunctions:
  """The SGA functions of `model`, whose parameters this freezes
  (requires_grad False): gradients are taken with respect to the latents
  alone. The learning-rate schedule spans `num_steps`."""
  model.requires_grad_(False)

  def latents_of(batch):
    with torch.no_grad():
      rvs = model.infer_latent_rvs(batch)
    # The optimized latents and Adam's moments stay float32 when the
    # transforms compute in bfloat16: that type is the frozen convs', not
    # the latents' storage type.
    return LatentRVCollection(uq=tuple(
        UQLatentRV(loc=rv.loc.float().contiguous().requires_grad_(True)) for rv in rvs.uq))

  def init(batch):
    latents = latents_of(batch)
    optimizer, _ = train_lib.make_optimizer([rv.loc for rv in latents.uq], optimizer_config,
                                            num_steps)
    return latents, optimizer

  def frozen_offset():
    return model.prior_quantization_offset()

  def fill(scalars, optimizer, step):
    """The host half of a step's model scalars; returns its host metrics."""
    values = models_base.step_scalar_values(model, step, itinf=True)
    scalars.fill(values)
    return {**models_base.host_step_metrics(values),
            "scheduled_lr": torch.tensor(optimizer.lr_fn(step))}

  def device_step(batch, latents, step, offset, scalars, update, noise=None, generator=None):
    loss, metrics, _ = model.frame_loss_given_latent_rvs(
        batch, latents, training=True, step=step, noise=noise, generator=generator,
        frozen_offset=offset, itinf=True, scalars=scalars)
    update(torch.autograd.grad(loss, [rv.loc for rv in latents.uq]))
    return {k: v.detach() for k, v in metrics.items()}

  eager_scalars: Dict[torch.device, step_graph.StepScalars] = {}

  def step(batch, latents, optimizer, step, offset, noise=None, generator=None):
    scalars = eager_scalars.get(batch.device)
    if scalars is None:
      scalars = eager_scalars[batch.device] = step_graph.StepScalars(batch.device)
    host = fill(scalars, optimizer, step)
    return {**device_step(batch, latents, step, offset, scalars, optimizer.update, noise,
                          generator), **host}

  def eval_fn(batch, latents, step, offset):
    with torch.no_grad():
      _, metrics, _ = model.frame_loss_given_latent_rvs(
          batch, latents, training=False, step=step, frozen_offset=offset, itinf=True)
    return metrics

  statics: Dict[tuple, StaticSgaStep] = {}

  def static(batch, offset, capture):
    key = (tuple(batch.shape), batch.dtype, batch.device, offset is None, capture)
    if key not in statics:
      latents, optimizer = init(batch)
      statics[key] = StaticSgaStep(fill, device_step, batch, latents, optimizer, offset, capture)
    else:
      statics[key].load(batch, latents_of(batch), offset)
    return statics[key]

  return ItinfFunctions(init, step, eval_fn, frozen_offset, static, statics)


def seed_step(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
  """Seed `generator` for the draws of `step` of a run seeded by `seed`: a
  32-bit hash of both (the CPU generator keeps only 32 bits of a seed)."""
  return generator.manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1)[0]))


def step_draws(model: nn.Module, latents: LatentRVCollection,
               generator: torch.Generator) -> Noise:
  """The draws an SGA step of `model` takes from `generator` when the step
  is given none, one per latent in the latents' order, made before the
  step: logistic for 'sga', uniform for 'unoise' and 'mixedq'; 'soft_round'
  draws nothing (zeros, unread)."""
  method = model.latent_config.get("uq", {}).get("method", "unoise")
  locs = [rv.loc for rv in latents.uq]
  if method == "sga":
    return tuple(rounding.logistic(t.shape, generator, t.dtype, t.device) for t in locs)
  if method in ("unoise", "mixedq"):
    return tuple(rounding.uniform_noise(t.shape, generator, t.dtype, t.device) for t in locs)
  return tuple(torch.zeros_like(t, requires_grad=False) for t in locs)


def sga_stepper(model: nn.Module, fns: ItinfFunctions, batch: torch.Tensor,
                offset: Optional[torch.Tensor], dispatch: str, seed: int = 0,
                noise_fn: Optional[Callable[[int], Noise]] = None):
  """(run_step, latents): run_step(s) takes SGA step s of `batch` (on the
  model's device) from its init latents, issued as `dispatch` ("eager",
  "static" or "graph") says, and returns its metrics; `latents` are the
  ones it optimizes. The draws of step s come from a generator seeded by
  (seed, s), or from noise_fn(s)."""
  generator = torch.Generator(device=batch.device) if noise_fn is None else None
  if dispatch == "eager":
    latents, optimizer = fns.init(batch)

    def run_step(s):
      if noise_fn is None:
        return fns.step(batch, latents, optimizer, s, offset,
                        generator=seed_step(generator, seed, s))
      return fns.step(batch, latents, optimizer, s, offset, noise=noise_fn(s))
  else:
    sga = fns.static(batch, offset, capture=dispatch == "graph")
    latents = sga.latents

    def run_step(s):
      if noise_fn is None:
        return sga(s, step_draws(model, latents, seed_step(generator, seed, s)))
      return sga(s, noise_fn(s))
  return run_step, latents


def _float_dict(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
  return {k: float(v) for k, v in metrics.items()}


STEP_DISPATCH_KEYS = ("auto", "stream", "fused")


def itinf_on_data_batch(model: nn.Module, data_batch, train_eval_config: Mapping[str, Any],
                        optimizer_config: Mapping[str, Any], workdir: Optional[str] = None,
                        seed: int = 0, fns: Optional[ItinfFunctions] = None,
                        offset: Optional[torch.Tensor] = None,
                        noise_fn: Optional[Callable[[int], Noise]] = None,
                        dispatch: str = "auto"):
  """Optimize the latents of one batch (itinf_lib.py:289-383).

  train_eval_config: num_steps (3000), log_metrics_every_steps (100),
  eval_every_steps (200): a val pass after every eval_every steps and at
  the end. Within each segment between val passes, log row r holds the
  metrics of the segment's step min((r + 1) * log_every, seg) - 1, written
  to <workdir>/train/record.jsonl at the count of steps done; the val
  passes go to <workdir>/val/record.jsonl. `offset` is frozen_offset(),
  computed here unless given; `noise_fn(step)` gives a step's draws, one
  per latent, in place of the seeded generator's.

  `dispatch` (step_graph.DISPATCHES) issues the steps: on the card by
  default as one CUDA graph replayed a step (fns.static, captured once per
  batch shape and pass), on the CPU eagerly. The config's step_dispatch
  ("auto", "stream", "fused": JAX's compiled step loops) is accepted; each
  of its values is the captured step on the card. Val passes run eagerly.

  Returns (train_metrics, val_metrics, itinf_vars): the last log row, the
  last val pass, and {"uq_<i>_loc": latent i} as float32 arrays (uq_0 z and
  uq_1 y for mshyper, uq_0 y for factorized).
  """
  cfg = dict(train_eval_config)
  num_steps = cfg.get("num_steps", 3000)
  log_every = cfg.get("log_metrics_every_steps", 100)
  eval_every = cfg.get("eval_every_steps", 200)
  if cfg.get("step_dispatch", "auto") not in STEP_DISPATCH_KEYS:
    raise ValueError(f"step_dispatch {cfg['step_dispatch']!r} is not one of "
                     f"{STEP_DISPATCH_KEYS}")
  writer = val_writer = None
  if workdir:
    writer = writers_lib.create_default_writer(workdir, collection="train")
    val_writer = writers_lib.create_default_writer(workdir, collection="val")
  fns = fns or make_itinf_functions(model, optimizer_config, num_steps)
  device = next(model.parameters()).device
  dispatch = step_graph.resolve_dispatch(dispatch, device)
  if offset is None:
    offset = fns.frozen_offset()
  batch = torch.as_tensor(np.asarray(data_batch, np.float32), device=device)
  run_step, latents = sga_stepper(model, fns, batch, offset, dispatch, seed, noise_fn)

  train_m = val_m = None
  step = 0
  while step < num_steps:
    seg = min(eval_every, num_steps - step)
    logged = {min((r + 1) * log_every, seg) for r in range(-(-seg // log_every))}
    for i in range(seg):
      s = step + i
      metrics = run_step(s)
      if i + 1 in logged:
        train_m = _float_dict(metrics)  # copies the row out of a graph's outputs
        if writer is not None:
          writer.write_scalars(s + 1, train_m)
    step += seg
    val_m = _float_dict(fns.eval(batch, latents, step, offset))
    if val_writer is not None:
      val_writer.write_scalars(step, val_m)
  if writer is not None:
    writer.close()
    val_writer.close()
  itinf_vars = {f"uq_{i}_loc": rv.loc.detach().cpu().numpy() for i, rv in enumerate(latents.uq)}
  return train_m, val_m, itinf_vars


def _dump_json(obj, path: str):
  with open(path, "w") as f:
    json.dump(obj, f, indent=2)


def itinf_eval(model: nn.Module, images: Iterable, config: Mapping[str, Any], out_dir: str,
               seed: int = 0, dispatch: str = "auto") -> List[Dict[str, Any]]:
  """SGA of every batch of `images` (itinf_lib.py:386-512): per batch
  <out_dir>/batch_id=<i>/ with train/ and val/record.jsonl, metrics.json
  ({"train": last log row, "val": last val pass}) and itinf_vars.npz; then
  <out_dir>/metrics.json, the list of {"batch_id": i, **val metrics}, and
  <out_dir>/step_dispatch.json, how the steps were issued (`dispatch`, as
  itinf_on_data_batch takes it) and each captured graph's kernel launches
  per replay. The offset heuristic's grid is computed once for the pass,
  and one static step (one capture on the card) serves each batch shape.
  Returns the list."""
  te_cfg = dict(config["train_eval_config"])
  optimizer_config = dict(config["model_config"].get("optimizer_config", {}))
  fns = make_itinf_functions(model, optimizer_config, te_cfg.get("num_steps", 3000))
  offset = fns.frozen_offset()
  dispatch = step_graph.resolve_dispatch(dispatch, next(model.parameters()).device)
  os.makedirs(out_dir, exist_ok=True)
  all_metrics = []
  for batch_id, batch in enumerate(images):
    batch_dir = os.path.join(out_dir, f"batch_id={batch_id}")
    train_m, val_m, itinf_vars = itinf_on_data_batch(
        model, batch, te_cfg, optimizer_config, workdir=batch_dir, seed=seed, fns=fns,
        offset=offset, dispatch=dispatch)
    _dump_json({"train": train_m, "val": val_m}, os.path.join(batch_dir, "metrics.json"))
    np.savez(os.path.join(batch_dir, "itinf_vars.npz"), **itinf_vars)
    all_metrics.append({"batch_id": batch_id, **val_m})
  _dump_json(all_metrics, os.path.join(out_dir, "metrics.json"))
  step_graph.write_dispatch_record(
      os.path.join(out_dir, "step_dispatch.json"), dispatch,
      launches_per_replay={"x".join(map(str, key[0])): dict(st.run.launches_per_replay)
                           for key, st in fns.statics.items()
                           if isinstance(st.run, step_graph.CapturedStep)})
  return all_metrics


# train_eval_config["transforms_dtype"] of a config script -> load_latest_ckpt's.
_SCRIPT_TRANSFORMS_DTYPES = dict(TRANSFORMS_DTYPES, none=None)


def itinf_eval_experiment(config: Mapping[str, Any], model_family: str, experiments_dir: str,
                          runname: str, config_script: Optional[str] = None,
                          device: Optional[str] = "cuda",
                          dispatch: str = "auto") -> Tuple[str, List[Dict[str, Any]]]:
  """SGA of every batch of config["data_config"]'s dataset with the params of
  the newest checkpoint of the training work unit warm_start_wid (default 0)
  under warm_start_exp_dir (itinf_lib.py:386-512). Writes the artifacts of
  itinf_eval (its steps issued by `dispatch`) into a workdir made by
  train_lib.setup_workdir, seeded 0 as the JAX package, and warm_start.json:
  the work unit, the checkpoint's step and train_lib.params_digest of the
  params that SGA starts from. Returns (workdir, the per-batch metrics)."""
  from shallow_ntc_tpu_torch import data as data_lib
  from shallow_ntc_tpu_torch import eval_lib

  te_cfg = dict(config["train_eval_config"])
  workdir = train_lib.setup_workdir(config, experiments_dir, runname, config_script)
  exp_dir, wid = te_cfg.get("warm_start_exp_dir"), te_cfg.get("warm_start_wid", 0)
  model, restored = eval_lib.load_latest_ckpt_from_experiment(
      exp_dir, wid, model_family, update_model_config=config.get("model_config"),
      transforms_dtype=_SCRIPT_TRANSFORMS_DTYPES[te_cfg.get("transforms_dtype", "none")],
      device=device)
  _dump_json({"warm_start_exp_dir": exp_dir, "warm_start_wid": wid,
              "step": restored["_restored_step"],
              "params_sha256": train_lib.params_digest(model.state_dict())},
             os.path.join(workdir, "warm_start.json"))
  data_cfg = config["data_config"]
  dataset = data_lib.get_dataset(data_cfg["dataset"], "test", data_cfg["batchsize"],
                                 data_cfg.get("patchsize"))
  return workdir, itinf_eval(model, dataset, config, workdir, dispatch=dispatch)
