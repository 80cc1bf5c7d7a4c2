"""Iterative inference (SGA encoding) of the port: the per-image optimization
of the latents at encode time (mirrors shallow_ntc_tpu/itinf_lib.py).

The model's parameters are frozen; its latents ((z, y) for mshyper, (y,)
for factorized) start from the analysis and take `num_steps` Adam steps on
the SGA-relaxed rd_loss, the relaxation's temperature tau annealed by the
step. One eager loop runs the steps: each runs the synthesis (and the
hyper-synthesis) forward and backward (the flagship's final_deconv_phase
once) and never waits for the device; metrics are read only at the log
rows. JAX's dispatch shapes (a fused scan, a stream of
jitted steps: `step_dispatch`) are TPU tactics, and the port has one loop.

The draws of step s are those of a generator seeded by (seed, s), in the
latents' order (z's first), or `noise_fn(s)` where a caller gives them; a
val pass draws nothing.
So a run split into segments by mid-run val passes takes the same
trajectory as one segment.
"""

import json
import os
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV

Noise = Tuple[torch.Tensor, ...]  # one draw per latent, in the latents' order

# train_eval_config["transforms_dtype"] -> Model(transforms_dtype=...).
TRANSFORMS_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ItinfFunctions(NamedTuple):
  """The SGA surface of one model (itinf_lib.py:30-181).

  init(batch) -> (latents, optimizer): the analysis's latents as float32
      leaves and Adam over them;
  step(batch, latents, optimizer, step, offset, noise=None, generator=None)
      -> metrics: one SGA update in place, with the log row's metrics
      (scheduled_lr included) as tensors;
  eval(batch, latents, step, offset) -> metrics: training=False (a hard
      round about the offset), with MS-SSIM;
  frozen_offset() -> the offset heuristic's grid, or None when it is off.
  """
  init: Callable[[torch.Tensor], Tuple[LatentRVCollection, train_lib.Adam]]
  step: Callable[..., Dict[str, torch.Tensor]]
  eval: Callable[..., Dict[str, torch.Tensor]]
  frozen_offset: Callable[[], Optional[torch.Tensor]]


def make_itinf_functions(model: nn.Module, optimizer_config: Mapping[str, Any],
                         num_steps: int) -> ItinfFunctions:
  """The SGA functions of `model`, whose parameters this freezes
  (requires_grad False): gradients are taken with respect to the latents
  alone. The learning-rate schedule spans `num_steps`."""
  model.requires_grad_(False)

  def init(batch):
    with torch.no_grad():
      rvs = model.infer_latent_rvs(batch)
    # The optimized latents and Adam's moments stay float32 when the
    # transforms compute in bfloat16: that type is the frozen convs', not
    # the latents' storage type.
    latents = LatentRVCollection(uq=tuple(
        UQLatentRV(loc=rv.loc.float().contiguous().requires_grad_(True)) for rv in rvs.uq))
    optimizer, _ = train_lib.make_optimizer([rv.loc for rv in latents.uq], optimizer_config,
                                            num_steps)
    return latents, optimizer

  def frozen_offset():
    return model.prior_quantization_offset()

  def step(batch, latents, optimizer, step, offset, noise=None, generator=None):
    loss, metrics, _ = model.frame_loss_given_latent_rvs(
        batch, latents, training=True, step=step, noise=noise, generator=generator,
        frozen_offset=offset, itinf=True)
    optimizer.update(torch.autograd.grad(loss, [rv.loc for rv in latents.uq]))
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["scheduled_lr"] = torch.tensor(optimizer.lr_fn(step))
    return metrics

  def eval_fn(batch, latents, step, offset):
    with torch.no_grad():
      _, metrics, _ = model.frame_loss_given_latent_rvs(
          batch, latents, training=False, step=step, frozen_offset=offset, itinf=True)
    return metrics

  return ItinfFunctions(init, step, eval_fn, frozen_offset)


def seed_step(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
  """Seed `generator` for the draws of `step` of a run seeded by `seed`: a
  32-bit hash of both (the CPU generator keeps only 32 bits of a seed)."""
  return generator.manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1)[0]))


def _float_dict(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
  return {k: float(v) for k, v in metrics.items()}


def itinf_on_data_batch(model: nn.Module, data_batch, train_eval_config: Mapping[str, Any],
                        optimizer_config: Mapping[str, Any], workdir: Optional[str] = None,
                        seed: int = 0, fns: Optional[ItinfFunctions] = None,
                        offset: Optional[torch.Tensor] = None,
                        noise_fn: Optional[Callable[[int], Noise]] = None):
  """Optimize the latents of one batch (itinf_lib.py:289-383).

  train_eval_config: num_steps (3000), log_metrics_every_steps (100),
  eval_every_steps (200): a val pass after every eval_every steps and at
  the end. Within each segment between val passes, log row r holds the
  metrics of the segment's step min((r + 1) * log_every, seg) - 1, written
  to <workdir>/train/record.jsonl at the count of steps done; the val
  passes go to <workdir>/val/record.jsonl. `offset` is frozen_offset(),
  computed here unless given; `noise_fn(step)` gives a step's draws, one
  per latent, in place of the seeded generator's.

  Returns (train_metrics, val_metrics, itinf_vars): the last log row, the
  last val pass, and {"uq_<i>_loc": latent i} as float32 arrays (uq_0 z and
  uq_1 y for mshyper, uq_0 y for factorized).
  """
  cfg = dict(train_eval_config)
  num_steps = cfg.get("num_steps", 3000)
  log_every = cfg.get("log_metrics_every_steps", 100)
  eval_every = cfg.get("eval_every_steps", 200)
  writer = val_writer = None
  if workdir:
    writer = train_lib.JsonlWriter(os.path.join(workdir, "train"))
    val_writer = train_lib.JsonlWriter(os.path.join(workdir, "val"))
  fns = fns or make_itinf_functions(model, optimizer_config, num_steps)
  device = next(model.parameters()).device
  if offset is None:
    offset = fns.frozen_offset()
  batch = torch.as_tensor(np.asarray(data_batch, np.float32), device=device)
  latents, optimizer = fns.init(batch)
  generator = torch.Generator(device=device) if noise_fn is None else None

  train_m = val_m = None
  step = 0
  while step < num_steps:
    seg = min(eval_every, num_steps - step)
    logged = {min((r + 1) * log_every, seg) for r in range(-(-seg // log_every))}
    for i in range(seg):
      s = step + i
      if noise_fn is None:
        metrics = fns.step(batch, latents, optimizer, s, offset,
                           generator=seed_step(generator, seed, s))
      else:
        metrics = fns.step(batch, latents, optimizer, s, offset, noise=noise_fn(s))
      if i + 1 in logged:
        train_m = _float_dict(metrics)
        if writer is not None:
          writer.write_scalars(s + 1, train_m)
    step += seg
    val_m = _float_dict(fns.eval(batch, latents, step, offset))
    if val_writer is not None:
      val_writer.write_scalars(step, val_m)
  itinf_vars = {f"uq_{i}_loc": rv.loc.detach().cpu().numpy() for i, rv in enumerate(latents.uq)}
  return train_m, val_m, itinf_vars


def _dump_json(obj, path: str):
  with open(path, "w") as f:
    json.dump(obj, f, indent=2)


def itinf_eval(model: nn.Module, images: Iterable, config: Mapping[str, Any], out_dir: str,
               seed: int = 0) -> List[Dict[str, Any]]:
  """SGA of every batch of `images` (itinf_lib.py:386-512): per batch
  <out_dir>/batch_id=<i>/ with train/ and val/record.jsonl, metrics.json
  ({"train": last log row, "val": last val pass}) and itinf_vars.npz; then
  <out_dir>/metrics.json, the list of {"batch_id": i, **val metrics}.
  The offset heuristic's grid is computed once for the pass. Returns that
  list."""
  te_cfg = dict(config["train_eval_config"])
  optimizer_config = dict(config["model_config"].get("optimizer_config", {}))
  fns = make_itinf_functions(model, optimizer_config, te_cfg.get("num_steps", 3000))
  offset = fns.frozen_offset()
  os.makedirs(out_dir, exist_ok=True)
  all_metrics = []
  for batch_id, batch in enumerate(images):
    batch_dir = os.path.join(out_dir, f"batch_id={batch_id}")
    train_m, val_m, itinf_vars = itinf_on_data_batch(
        model, batch, te_cfg, optimizer_config, workdir=batch_dir, seed=seed, fns=fns,
        offset=offset)
    _dump_json({"train": train_m, "val": val_m}, os.path.join(batch_dir, "metrics.json"))
    np.savez(os.path.join(batch_dir, "itinf_vars.npz"), **itinf_vars)
    all_metrics.append({"batch_id": batch_id, **val_m})
  _dump_json(all_metrics, os.path.join(out_dir, "metrics.json"))
  return all_metrics
