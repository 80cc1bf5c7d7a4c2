"""The port's captured steps on the CPU (shallow_ntc_tpu_torch/step_graph.py):
the train and SGA steps with their scalars (the scheduled lambda, SGA's
tau, Adam's learning rate and bias corrections) as 0-dim tensors against
the steps with host floats, bit for bit; the static-buffer steps (the
function a CUDA graph captures, run eagerly here) against the eager loops,
bit for bit, through val passes, a pass of two batches and a resumed run;
the launch counts of a replay with a stand-in graph; the dispatch choices.
The models are the flagship (two_layer_syn_rd) at narrow ELIC widths and
the factorized bls2017_rd at 8 filters, 64x64 images. The parity of these
steps with the JAX package is held by tests/test_torch_train.py,
test_torch_itinf.py and test_torch_factorized.py."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import itinf_lib
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch import step_graph
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.models import families
from shallow_ntc_tpu_torch.ops import cuda_build

FLAGSHIP = copy.deepcopy(configs.TWO_LAYER_SYN_RD)
FLAGSHIP["transform_config"]["analysis"]["channels"] = (8, 8, 8, 16)
FACTORIZED = copy.deepcopy(configs.BLS2017_RD)
FACTORIZED["transform_config"]["analysis"]["num_filters"] = 8
FACTORIZED["transform_config"]["synthesis"]["num_filters"] = 8
BASES = {"mshyper": FLAGSHIP, "factorized": FACTORIZED}
# SGA annealed within a few steps (tau leaves its upper bound at step 2).
SGA = dict(method="sga", tau_r=0.1, tau_ub=0.5, tau_t0=2)
SGA_OPTIMIZER = configs.ITINF["model_config"]["optimizer_config"]
TRAIN_OPTIMIZER = dict(
    configs.TRAIN_CONFIGS["two_layer_syn_rd"]["model_config"]["optimizer_config"],
    warmup_until=0.0)


def _model(family, seed=0, sga=False, transforms_dtype=None, offset_heuristic=True):
  """The narrow model of `family` with a seeded init on the CPU; rd_lambda
  0.005 over 10 scheduled steps, so its lambda drops 10x at step 2."""
  cfg = copy.deepcopy(BASES[family])
  cfg.pop("optimizer_config", None)
  cfg.update(rd_lambda=0.005, scheduled_num_steps=10, offset_heuristic=offset_heuristic,
             transforms_dtype=transforms_dtype)
  if sga:
    cfg["latent_config"] = dict(uq=dict(SGA))
  model, _ = families.build_model(cfg, family)
  params_lib.load_params(model, params_lib.init_params(model, seed))
  return model


def _images(b, seed):
  rng = np.random.default_rng(seed)
  return rng.uniform(-0.5, 0.5, (b, 64, 64, 3)).astype(np.float32)


def _host_float_update(opt, grads):
  """train_lib.Adam.update with the learning rate and bias corrections as
  Python numbers, as it was before they became 0-dim tensors: the
  reference of the tensor-scalar update."""
  with torch.no_grad():
    grads = list(grads)
    if opt.global_clipnorm is not None:
      norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
      keep = norm < opt.global_clipnorm
      grads = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
      clipnorm = torch.full_like(norm, opt.global_clipnorm)
      torch._foreach_mul_(grads, torch.where(keep, 1.0, clipnorm))
    lr = float(opt.lr_fn(opt.count))
    opt.count += 1
    bc1 = float(np.float32(1) - np.power(np.float32(opt.b1), np.float32(opt.count)))
    bc2 = float(np.float32(1) - np.power(np.float32(opt.b2), np.float32(opt.count)))
    step = torch._foreach_mul(grads, 1 - opt.b1)
    torch._foreach_mul_(opt.mu, opt.b1)
    torch._foreach_add_(opt.mu, step)
    step = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(step, 1 - opt.b2)
    torch._foreach_mul_(opt.nu, opt.b2)
    torch._foreach_add_(opt.nu, step)
    denom = torch._foreach_div(opt.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    step = torch._foreach_div(opt.mu, bc1)
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, -lr)
    torch._foreach_add_(opt.params, step)


def _equal_tensors(a, b):
  return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _floats(metrics):
  return {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("family", ["mshyper", "factorized"])
def test_sga_step_with_tensor_scalars_equals_the_host_float_step(family):
  """4 SGA steps through fns.step (lambda, tau, lr and the bias corrections
  as 0-dim tensors) against the step with host floats (the model's loss
  without `scalars`, _host_float_update), from the same latents and draws:
  latents, Adam's moments and every metric bit for bit, tau annealing over
  the steps (at its upper bound until step 2)."""
  model = _model(family, seed=1, sga=True)
  x = torch.from_numpy(_images(1, 2))
  fns = itinf_lib.make_itinf_functions(model, SGA_OPTIMIZER, 30)
  offset = fns.frozen_offset()
  new_lat, new_opt = fns.init(x)
  old_lat, old_opt = fns.init(x)
  gen_new, gen_old = torch.Generator(), torch.Generator()
  taus = set()
  for s in range(4):
    m_new = fns.step(x, new_lat, new_opt, s, offset, generator=itinf_lib.seed_step(gen_new, 3, s))
    draws = itinf_lib.step_draws(model, old_lat, itinf_lib.seed_step(gen_old, 3, s))
    loss, m_old, _ = model.frame_loss_given_latent_rvs(
        x, old_lat, training=True, step=s, noise=draws, frozen_offset=offset, itinf=True)
    _host_float_update(old_opt, torch.autograd.grad(loss, [rv.loc for rv in old_lat.uq]))
    m_old = {**{k: v.detach() for k, v in m_old.items()},
             "scheduled_lr": torch.tensor(old_opt.lr_fn(s))}
    assert list(m_new) == list(m_old) and _floats(m_new) == _floats(m_old), s
    assert _equal_tensors([rv.loc for rv in new_lat.uq], [rv.loc for rv in old_lat.uq]), s
    assert _equal_tensors(new_opt.mu + new_opt.nu, old_opt.mu + old_opt.nu), s
    taus.add(float(m_new["tau"]))
  assert len(taus) == 2 and new_opt.count == old_opt.count == 4


@pytest.mark.parametrize("family", ["mshyper", "factorized"])
def test_train_step_with_tensor_scalars_equals_the_host_float_step(family):
  """3 steps of make_train_step (the scheduled lambda, 10x until step 2, and
  Adam's scalars as 0-dim tensors) against the step with host floats (the
  model's loss without `scalars`, _host_float_update), on
  the same batches and draws: params, moments and metrics bit for bit."""
  new, old = _model(family), _model(family)
  state, lr_fn = train_lib.create_train_state(new, TRAIN_OPTIMIZER, seed=2)
  old_opt, _ = train_lib.make_optimizer(list(old.parameters()), TRAIN_OPTIMIZER,
                                        old.scheduled_num_steps)
  step_fn = train_lib.make_train_step(new, state.optimizer, lr_fn)
  gen = torch.Generator().manual_seed(9)
  lambdas = set()
  for s in range(3):
    x = torch.from_numpy(_images(2, 10 + s))
    noise = new.training_noise(tuple(x.shape), gen)
    m_new = step_fn(state, x, noise=noise)
    old.zero_grad(set_to_none=True)
    loss, m_old, _ = old.end_to_end_frame_loss(x, training=True, step=s, noise=noise)
    loss.backward()
    _host_float_update(old_opt, [torch.zeros_like(p) if p.grad is None else p.grad
                                 for p in old.parameters()])
    m_old = {**{k: v.detach() for k, v in m_old.items()},
             "scheduled_lr": torch.tensor(float(lr_fn(s)))}
    assert list(m_new) == list(m_old) and _floats(m_new) == _floats(m_old), s
    assert _equal_tensors(list(new.parameters()), list(old.parameters())), s
    assert _equal_tensors(state.optimizer.mu + state.optimizer.nu, old_opt.mu + old_opt.nu), s
    lambdas.add(float(m_new["sched_rd_lambda"]))
  assert lambdas == {float(np.float32(0.005) * np.float32(10)), float(np.float32(0.005))}


SGA_CASES = {"flagship f32 B=1": ("mshyper", 1, None, True),
             "flagship bf16 B=2": ("mshyper", 2, torch.bfloat16, False),
             "factorized f32 B=1": ("factorized", 1, None, True)}


@pytest.mark.parametrize("case", list(SGA_CASES))
def test_static_sga_step_equals_the_eager_loop(case, tmp_path):
  """20 SGA steps with val passes after steps 7 and 14 (log rows every 3),
  through itinf_on_data_batch's static-buffer step (dispatch "static": the
  function the card captures, run eagerly) and its eager loop: every log
  row, every val pass and the latents bit for bit."""
  family, b, dtype, offset_heuristic = SGA_CASES[case]
  model = _model(family, seed=4, sga=True, transforms_dtype=dtype,
                 offset_heuristic=offset_heuristic).eval()
  x = _images(b, 5)
  te = dict(num_steps=20, log_metrics_every_steps=3, eval_every_steps=7)
  runs = {}
  for dispatch in ("eager", "static"):
    wd = str(tmp_path / dispatch)
    runs[dispatch] = itinf_lib.itinf_on_data_batch(model, x, te, SGA_OPTIMIZER, workdir=wd,
                                                   seed=6, dispatch=dispatch)
  (t_e, v_e, vars_e), (t_s, v_s, vars_s) = runs["eager"], runs["static"]
  assert t_e == t_s and v_e == v_s
  assert all(np.array_equal(vars_e[k], vars_s[k]) for k in vars_e)
  for name in ("train", "val"):
    rows = [[json.loads(line) for line in open(tmp_path / d / name / "record.jsonl")]
            for d in ("eager", "static")]
    assert rows[0] == rows[1] and len(rows[0]) == {"train": 8, "val": 3}[name]


def test_static_sga_step_serves_a_pass_of_batches():
  """Two batches of one shape through one ItinfFunctions, dispatch "static":
  one static step (one capture on the card) loaded with each batch, its
  moments zeroed, each run equal to a fresh eager run bit for bit."""
  model = _model("mshyper", seed=4, sga=True).eval()
  te = dict(num_steps=6, log_metrics_every_steps=2, eval_every_steps=6)
  fns = itinf_lib.make_itinf_functions(model, SGA_OPTIMIZER, 6)
  for i in range(2):
    x = _images(1, 20 + i)
    static = itinf_lib.itinf_on_data_batch(model, x, te, SGA_OPTIMIZER, fns=fns,
                                           dispatch="static")
    eager = itinf_lib.itinf_on_data_batch(model, x, te, SGA_OPTIMIZER, dispatch="eager")
    assert static[0] == eager[0] and static[1] == eager[1]
    assert all(np.array_equal(static[2][k], eager[2][k]) for k in eager[2])
  assert len(fns.statics) == 1


def _train_run(family, workdir, dispatch, batches, num_steps, seed=3):
  model = _model(family, seed=7).train()
  cfg = dict(num_steps=num_steps, log_metrics_every_steps=1, eval_every_steps=2,
             checkpoint_every_steps=3, max_validation_steps=1)
  val = _images(2, 99)
  state = train_lib.simple_train_eval_loop(cfg, str(workdir), model, TRAIN_OPTIMIZER,
                                           iter(batches), lambda: [val], seed=seed,
                                           dispatch=dispatch)
  return state


def _records(workdir):
  out = {}
  for name in ("train", "val"):
    with open(os.path.join(workdir, name, "record.jsonl")) as f:
      rows = [json.loads(line) for line in f]
    out[name] = [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in rows]
  return out


@pytest.mark.parametrize("family", ["mshyper", "factorized"])
def test_static_train_step_equals_the_eager_loop_and_resumes(family, tmp_path):
  """5 train steps through simple_train_eval_loop with the static-buffer
  step (dispatch "static") and with the eager step, val passes after steps
  2 and 4: params, Adam's state, the generator and every record row bit for
  bit. A static run stopped at its step-3 checkpoint and resumed to step 5
  on the remaining batches equals both. The workdir records the dispatch."""
  batches = [_images(2, 30 + s) for s in range(5)]
  runs = {d: _train_run(family, tmp_path / d, d, batches, 5) for d in ("eager", "static")}
  _train_run(family, tmp_path / "resumed", "static", batches[:3], 3)
  runs["resumed"] = _train_run(family, tmp_path / "resumed", "static", batches[3:], 5)
  ref = runs["eager"]
  for name, st in runs.items():
    assert st.step == 5 and st.optimizer.count == 5, name
    assert _equal_tensors(list(st.model.parameters()), list(ref.model.parameters())), name
    assert _equal_tensors(st.optimizer.mu + st.optimizer.nu,
                          ref.optimizer.mu + ref.optimizer.nu), name
    assert torch.equal(st.generator.get_state(), ref.generator.get_state()), name
  records = {d: _records(str(tmp_path / d)) for d in runs}
  assert records["static"] == records["eager"]
  assert records["resumed"]["train"][-2:] == records["eager"]["train"][-2:]
  with open(tmp_path / "static" / "step_dispatch.json") as f:
    assert json.load(f) == {"step_dispatch": "static", "launches_per_replay": {}}
  with open(tmp_path / "eager" / "step_dispatch.json") as f:
    assert json.load(f) == {"step_dispatch": "eager"}


class StandInGraph(step_graph.CapturedStep):
  """CapturedStep with CPU stand-ins for the side stream, the capture and
  the replay: the capture runs body once (the host code a real capture
  runs), a replay launches nothing from Python."""

  replays = 0

  def _warmup(self):
    return self.body()

  def _capture(self):
    self.graph = "stand-in"
    return self.body()

  def _replay(self):
    self.replays += 1


def test_launch_counts_of_a_replay_with_a_stand_in_graph():
  """A body whose Python counts two launches of a kernel: the warm-up call
  counts its two, the capture's two are taken back, and each replay adds
  two (launches_per_replay); a kernel the body does not run is untouched.
  A capture that raises leaves the counts as they were and no graph."""
  kernel = cuda_build.KernelStats("stand_in_kernel")
  other = cuda_build.KernelStats("stand_in_other")
  try:
    def body():
      kernel.launches += 2
      return {"out": torch.ones(())}

    step = StandInGraph(body, "cpu")
    counts = []
    for _ in range(4):
      assert float(step()["out"]) == 1.0
      counts.append(kernel.launches)
    assert counts == [2, 4, 6, 8] and step.replays == 3 and other.launches == 0
    assert step.launches_per_replay == {"stand_in_kernel": 2}

    def failing():
      kernel.launches += 1
      raise RuntimeError("operation not permitted when stream is capturing")

    bad = StandInGraph(failing, "cpu", warmup=0)
    with pytest.raises(RuntimeError, match="capturing"):
      bad()
    assert kernel.launches == 8 and bad.replays == 0
  finally:
    for st in (kernel, other):
      cuda_build.KernelStats.registry.remove(st)


def test_dispatch_choices():
  """auto is the eager loop on the CPU and in a process group and the graph
  on CUDA; a graph on the CPU, a static or graphed data-parallel step and
  an unknown name raise; the config's step_dispatch takes JAX's values."""
  assert step_graph.resolve_dispatch("auto", "cpu") == "eager"
  assert step_graph.resolve_dispatch("auto", "cuda") == "graph"
  assert step_graph.resolve_dispatch("auto", "cuda", data_parallel=True) == "eager"
  assert step_graph.resolve_dispatch("static", "cpu") == "static"
  with pytest.raises(ValueError, match="needs a CUDA device"):
    step_graph.resolve_dispatch("graph", "cpu")
  with pytest.raises(ValueError, match="data-parallel"):
    step_graph.resolve_dispatch("static", "cuda", data_parallel=True)
  with pytest.raises(ValueError, match="not one of"):
    step_graph.resolve_dispatch("fused", "cpu")
  model = _model("mshyper", sga=True).eval()
  te = dict(num_steps=1, log_metrics_every_steps=1, eval_every_steps=1)
  for key in ("auto", "stream", "fused"):
    itinf_lib.itinf_on_data_batch(model, _images(1, 0), dict(te, step_dispatch=key),
                                  SGA_OPTIMIZER)
  with pytest.raises(ValueError, match="step_dispatch"):
    itinf_lib.itinf_on_data_batch(model, _images(1, 0), dict(te, step_dispatch="scan"),
                                  SGA_OPTIMIZER)
  with pytest.raises(ValueError, match="uniform noise"):
    train_lib.StaticTrainStep(model, None, None, capture=False)


def test_adam_prepare_apply_and_reset():
  """update() is prepare() then apply(); the scalars hold update count + 1's
  float32 values; reset() zeroes the moments in place and restarts the
  count, after which the next update equals a fresh optimizer's."""
  rng = np.random.default_rng(0)
  params = [torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)) for _ in range(2)]
  grads = [[torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)) for _ in range(2)]
           for _ in range(3)]
  opt, lr_fn = train_lib.make_optimizer([p.clone() for p in params], TRAIN_OPTIMIZER, 100)
  split, _ = train_lib.make_optimizer([p.clone() for p in params], TRAIN_OPTIMIZER, 100)
  for g in grads[:2]:
    opt.update(g)
    split.prepare()
    split.apply(g)
  assert _equal_tensors(opt.params + opt.mu + opt.nu, split.params + split.mu + split.nu)
  assert float(opt.scalars["neg_lr"]) == -float(lr_fn(1))
  assert float(opt.scalars["bc2"]) == float(np.float32(1) - np.float32(opt.b2) ** np.float32(2))
  moments = [t.data_ptr() for t in opt.mu + opt.nu]
  opt.reset()
  assert opt.count == 0 and [t.data_ptr() for t in opt.mu + opt.nu] == moments
  assert all(not t.any() for t in opt.mu + opt.nu)
  fresh, _ = train_lib.make_optimizer([p.clone() for p in opt.params], TRAIN_OPTIMIZER, 100)
  opt.update(grads[2])
  fresh.update(grads[2])
  assert _equal_tensors(opt.params + opt.mu + opt.nu, fresh.params + fresh.mu + fresh.nu)


def test_batch_stager_reads_the_same_bytes():
  """On the CPU the stager hands over the array's bytes, into `out` too."""
  x = _images(2, 1)
  stager = step_graph.BatchStager("cpu")
  assert np.array_equal(stager(x).numpy(), x)
  out = torch.empty(x.shape)
  assert stager(x, out=out) is out and np.array_equal(out.numpy(), x)


def test_measure_dispatch_runs_agree_on_the_cpu():
  """measure.sga_dispatch_runs and train_dispatch_runs (what the card's
  graph-against-eager checks call) with the eager and the static step: the
  same latents, params and moments bit for bit, no kernel launched here."""
  from shallow_ntc_tpu_torch import measure

  model = _model("mshyper", seed=2, sga=True).eval()
  sga = measure.sga_dispatch_runs(model, _images(1, 3), 5, SGA_OPTIMIZER,
                                  dispatches=("eager", "static"))
  assert _equal_tensors(sga["eager"]["latents"], sga["static"]["latents"])
  assert all(r["launches"] == {} and r["launches_per_replay"] is None for r in sga.values())
  model_config = configs.TRAIN_CONFIGS["smoke"]["model_config"]
  train = measure.train_dispatch_runs(model_config, [_images(2, s) for s in range(4)], "cpu",
                                      dispatches=("eager", "static"))
  e, s = train["eager"], train["static"]
  assert _equal_tensors(e["params"] + e["mu"] + e["nu"], s["params"] + s["mu"] + s["nu"])
  assert e["ms"] > 0 and s["ms"] > 0


def test_seed_and_dispatch_reach_the_train_loop(tmp_path, monkeypatch):
  """The experiment train CLI's --seed and --dispatch reach the loop (seed
  0 and "auto" by default, as before), and the R-D driver gives a point at
  another seed its own experiment ids and passes the seed on."""
  import importlib.util

  from shallow_ntc_tpu_torch.utils import cli

  seen = []

  def train(cfg, family, workdir, device, seed, dispatch):
    seen.append((seed, dispatch))
    return train_lib.TrainState(model=None, optimizer=None, step=0, generator=None)

  monkeypatch.setattr(train_lib, "_train", train)
  monkeypatch.setenv("SLURM_ARRAY_JOB_ID", "5")
  argv = ["--config", "shallow_ntc_tpu_torch/mshyper/configs/smoke.py", "--hid", "0",
          "--experiments_dir", str(tmp_path), "--device", "cpu", "--dp_devices", "1"]
  for extra in ([], ["--seed", "3", "--dispatch", "eager"]):
    cli.run_train_main("mshyper", argv + extra)
  assert seen == [(0, "auto"), (3, "eager")]
  spec = importlib.util.spec_from_file_location(
      "_torch_rd_run", os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                                    "torch_rd_run.py"))
  rd_run = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(rd_run)
  base, seeded = (rd_run.Point("two_layer_syn_rd", 6, [], seed) for seed in (0, 1))
  assert (base.xid, base.sga_xid, base.seed) == ("torchrd", "torchrd_sga", 0)
  assert (seeded.xid, seeded.sga_xid, seeded.seed) == ("torchrd_seed1", "torchrd_sga_seed1", 1)
  assert seeded.runname == base.runname
