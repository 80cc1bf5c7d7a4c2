"""The port's SGA iterative inference against the JAX package (CPU): the
rounding relaxations and their schedules, the SGA loss and its latent
gradients, multi-step trajectories in float32 and with bfloat16 transforms,
and the itinf CLI. The model is the flagship architecture at narrow ELIC
widths (tests/torch_parity.SMALL_CONFIG), 64x64 images, B=1 and B=2. JAX's
own draws (fold_in(PRNGKey(seed), step), split into z's and y's keys, one
jax.random.logistic each) are fed to the port."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu import itinf_lib as jax_itinf_lib
from shallow_ntc_tpu import latents as jax_latents
from shallow_ntc_tpu import schedule as jax_schedule
from shallow_ntc_tpu.models import mshyper as jax_mshyper
from shallow_ntc_tpu.ops import entropy as jax_entropy
from shallow_ntc_tpu.ops import rounding as jax_rounding
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import itinf as itinf_cli
from shallow_ntc_tpu_torch import itinf_lib
from shallow_ntc_tpu_torch import schedule
from shallow_ntc_tpu_torch.latents import LatentRVCollection, UQLatentRV
from shallow_ntc_tpu_torch.ops import entropy
from shallow_ntc_tpu_torch.ops import rounding
from tests.torch_parity import SMALL_CONFIG, images, models, rand, to_numpy, to_torch

# SGA annealed within a few steps (tau leaves its upper bound at step 2).
SGA = dict(method="sga", tau_r=0.1, tau_ub=0.5, tau_t0=2)
OPTIMIZER = configs.ITINF["model_config"]["optimizer_config"]
STEPS = 6
TRAIN_EVAL = dict(num_steps=STEPS, log_metrics_every_steps=2, eval_every_steps=STEPS)


def _config(offset_heuristic):
  cfg = copy.deepcopy(SMALL_CONFIG)
  cfg.update(latent_config=dict(uq=dict(SGA)), offset_heuristic=offset_heuristic)
  return cfg


def _batch(b):
  return np.concatenate([images(i, (64, 64)) for i in range(b)])


def _jax_draws(key, step, z_shape, y_shape):
  """The logistic draws of one JAX SGA step (itinf_lib.py:91, mshyper.py:126-128)."""
  rng_z, rng_y = jax.random.split(jax.random.fold_in(key, step))
  return (to_torch(jax.random.logistic(rng_z, z_shape, jnp.float32)),
          to_torch(jax.random.logistic(rng_y, y_shape, jnp.float32)))


@pytest.mark.parametrize("with_offset", [False, True])
@pytest.mark.parametrize("method", ["sga", "soft_round"])
def test_relaxed_rounding_matches_jax(method, with_offset):
  """sga_round (JAX's logistic draws) and soft_round, about an offset grid or
  not: values within 1e-6, gradients within 1e-5 of JAX's."""
  rng = np.random.default_rng(4)
  mu = rand(rng, (2, 3, 4, 5), 3.0)
  mu[0, 0, 0, :2] = (-1.0, 2.0)  # on the grid: floor == ceil
  offset = rand(rng, (5,), 0.3) if with_offset else None
  cot = rand(rng, mu.shape)
  key = jax.random.PRNGKey(3)
  if method == "sga":
    tau = np.float32(0.37)
    jfn = lambda m: jax_rounding.sga_round(key, m, tau, offset=offset)  # noqa: E731
    noise = to_torch(jax.random.logistic(key, mu.shape, jnp.float32))
    tfn = lambda m: rounding.sga_round(  # noqa: E731
        m, tau, None if offset is None else to_torch(offset), noise=noise)
  else:
    jfn = lambda m: jax_rounding.soft_round(m, 2.5, offset=offset)  # noqa: E731
    tfn = lambda m: rounding.soft_round(  # noqa: E731
        m, 2.5, None if offset is None else to_torch(offset))
  out_j, vjp = jax.vjp(jfn, jnp.asarray(mu))
  mu_t = to_torch(mu).requires_grad_(True)
  out_t = tfn(mu_t)
  out_t.backward(to_torch(cot))
  np.testing.assert_allclose(to_numpy(out_t), np.asarray(out_j), rtol=0, atol=1e-6)
  np.testing.assert_allclose(to_numpy(mu_t.grad), np.asarray(vjp(jnp.asarray(cot))[0]),
                             rtol=1e-5, atol=1e-5)


def test_soft_round_below_alpha_1e4_is_the_identity():
  x = to_torch(rand(np.random.default_rng(0), (50,), 2.0))
  assert torch.equal(rounding.soft_round(x, 5e-5), x)
  np.testing.assert_array_equal(to_numpy(rounding.soft_round(x, 5e-5)),
                                np.asarray(jax_rounding.soft_round(to_numpy(x), 5e-5)))


def test_logistic_draws_are_finite_and_logistic(monkeypatch):
  """The port's own draws: mean 0, variance pi^2 / 3, and a uniform draw of
  exactly 0 gives a finite value (u starts at the smallest normal float)."""
  draws = rounding.logistic((200_000,), torch.Generator().manual_seed(0))
  assert torch.isfinite(draws).all()
  assert abs(float(draws.mean())) < 0.02 and abs(float(draws.var()) - np.pi**2 / 3) < 0.05
  monkeypatch.setattr(torch, "rand", lambda shape, **kw: torch.zeros(shape))
  assert torch.isfinite(rounding.logistic((3,))).all()
  with pytest.raises(ValueError, match="noise of shape"):
    rounding.sga_round(torch.zeros(3), 0.5, noise=torch.zeros(4))


@pytest.mark.parametrize("scheme", ["exp", "linear"])
def test_sga_schedule_matches_jax_bit_for_bit(scheme):
  """Every step 0..3599 of the itinf config's schedule (r 5e-4, ub .5, t0
  200; linear with r 1.5e-4 so it crosses lb), equal in float32."""
  r = 5e-4 if scheme == "exp" else 1.5e-4
  steps = np.arange(3600)
  ref = np.asarray(jax.jit(jax.vmap(lambda t: jax_rounding.sga_schedule_at_step(
      t, r, 0.5, t0=200.0, scheme=scheme)))(jnp.asarray(steps, jnp.int32)))
  out = np.array([rounding.sga_schedule_at_step(int(t), r, 0.5, t0=200.0, scheme=scheme)
                  for t in steps])
  assert out.dtype == np.float32
  np.testing.assert_array_equal(out, ref)
  with pytest.raises(NotImplementedError):
    rounding.sga_schedule_at_step(0, r, 0.5, scheme="cosine")


@pytest.mark.parametrize("itinf", [False, True])
@pytest.mark.parametrize("step", [0, 599, 600, 2999])
def test_scheduled_rd_lambda_itinf_matches_jax(itinf, step):
  """With itinf the 10x warm-up is off: lambda 0.01 over 3000 steps."""
  ref = jax_schedule.scheduled_rd_lambda(0.01, jnp.int32(step), 3000, itinf=itinf)
  assert np.float32(schedule.scheduled_rd_lambda(0.01, step, 3000, itinf=itinf)) == np.asarray(
      ref)


@pytest.mark.parametrize("case", ["unoise", "sga", "soft_round", "eval"])
def test_uq_latent_rv_sample_matches_jax(case):
  """UQLatentRV.sample in each method and in eval mode (a hard round about
  the offset), against JAX's with the same draws; quantize is the
  straight-through round."""
  rng = np.random.default_rng(5)
  loc = rand(rng, (1, 2, 3, 4), 4.0)
  offset = rand(rng, (4,), 0.3)
  key = jax.random.PRNGKey(11)
  kw = {"sga": dict(tau=np.float32(0.2)), "soft_round": dict(alpha=3.0)}.get(case, {})
  training = case != "eval"
  method = None if case == "eval" else case
  ref = jax_latents.UQLatentRV(loc=loc).sample(key, training, method, offset=offset, **kw)
  noise = None
  if case == "unoise":
    noise = to_torch(jax.random.uniform(key, loc.shape, jnp.float32, -0.5, 0.5))
  elif case == "sga":
    noise = to_torch(jax.random.logistic(key, loc.shape, jnp.float32))
  out = UQLatentRV(loc=to_torch(loc)).sample(training, method, offset=to_torch(offset),
                                              noise=noise, **kw)
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=0, atol=1e-6)
  np.testing.assert_array_equal(
      to_numpy(UQLatentRV(loc=to_torch(loc)).quantize(to_torch(offset))),
      np.asarray(jax_latents.UQLatentRV(loc=loc).quantize(offset)))
  with pytest.raises(NotImplementedError):
    UQLatentRV(loc=to_torch(loc)).sample(True, "mixedq")


def test_indexed_em_log_prob_centered_matches_jax():
  """rtol 1e-5, as tests/test_torch_train.py holds the indexed model's bits
  (log_ndtr differs in the last bits: 2.9e-6 relative measured)."""
  rng = np.random.default_rng(6)
  y, loc = rand(rng, (2, 4, 4, 6), 3.0), rand(rng, (2, 4, 4, 6))
  idx = np.abs(rand(rng, (2, 4, 4, 6))) * 25
  ref = jax_entropy.indexed_em_log_prob_centered(y, idx, loc)
  out = entropy.indexed_em_log_prob_centered(to_torch(y), to_torch(idx), to_torch(loc))
  np.testing.assert_allclose(to_numpy(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("offset_heuristic,b", [(False, 1), (True, 2)])
def test_sga_loss_and_latent_gradients_match_jax(offset_heuristic, b):
  """The SGA frame loss (training=True, itinf) at step 3 with JAX's draws and
  the offset once computed: loss and metrics rtol 1e-5, each latent's
  gradient within 1e-4 * max(1, max|g|) (as tests/test_torch_train.py holds
  parameter gradients); then training=False (a hard round about the offset
  and about mu): metrics rtol 1e-4, (MS-)SSIM atol 1e-5."""
  jax_model, params, port = models(_config(offset_heuristic), seed=1)
  x = _batch(b)
  cls = jax_mshyper.Model
  rv = jax_model.apply({"params": params}, x, method=cls.infer_latent_rvs)
  offset_j = jax_model.apply({"params": params}, method=cls.prior_quantization_offset)
  offset_t = port.prior_quantization_offset()
  assert (offset_j is None) == (offset_t is None) == (not offset_heuristic)
  if offset_heuristic:
    np.testing.assert_allclose(to_numpy(offset_t), np.asarray(offset_j), atol=1e-5)
  key, step = jax.random.PRNGKey(2), 3

  def loss_fn(latents):
    loss, metrics, _ = jax_model.apply(
        {"params": params}, x, latents, training=True, rng=jax.random.fold_in(key, step),
        step=step, itinf=True, frozen_offset=offset_j, method=cls.frame_loss_given_latent_rvs)
    return loss, metrics

  (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(rv)
  locs = [to_torch(r.loc).requires_grad_(True) for r in rv.uq]
  latents = LatentRVCollection(uq=tuple(UQLatentRV(loc=t) for t in locs))
  noise = _jax_draws(key, step, rv.uq[0].loc.shape, rv.uq[1].loc.shape)
  loss_t, m_t, rec = port.frame_loss_given_latent_rvs(
      to_torch(x), latents, training=True, step=step, noise=noise, frozen_offset=offset_t,
      itinf=True)
  grads = torch.autograd.grad(loss_t, locs)
  assert set(m_t) == set(m_j) and "tau" in m_t and rec.shape == x.shape
  for k in m_j:
    np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]), rtol=1e-5, err_msg=k)
  for name, g_t, g_ref in zip(("z", "y"), grads, g_j.uq):
    g_ref = np.asarray(g_ref.loc)
    np.testing.assert_allclose(to_numpy(g_t), g_ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(g_ref).max())), err_msg=name)

  _, v_j, _ = jax.jit(lambda p, latents: jax_model.apply(
      {"params": p}, x, latents, training=False, rng=None, step=step, itinf=True,
      frozen_offset=offset_j, method=cls.frame_loss_given_latent_rvs))(params, rv)
  with torch.no_grad():
    _, v_t, _ = port.frame_loss_given_latent_rvs(to_torch(x), latents, training=False,
                                                 step=step, frozen_offset=offset_t, itinf=True)
  assert set(v_t) == set(v_j)
  for k in v_j:
    if k.startswith("msssim"):
      np.testing.assert_allclose(float(v_t[k]), float(v_j[k]), atol=1e-5, err_msg=k)
    else:
      np.testing.assert_allclose(float(v_t[k]), float(v_j[k]), rtol=1e-4, err_msg=k)


def _rows(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


@pytest.mark.parametrize("dtype,b,offset_heuristic", [
    ("float32", 1, False), ("float32", 2, True), ("bfloat16", 1, False)])
def test_itinf_trajectory_matches_jax(tmp_path, dtype, b, offset_heuristic):
  """STEPS SGA steps with JAX's draws, against JAX's jitted itinf step
  (itinf_lib.make_jitted_itinf) and itinf_on_data_batch.

  float32: the latents after every step within 0.05 * lr of JAX's (Adam
  moves an element by ~lr whatever the size of its gradient, so a
  gradient near zero whose last bits differ moves it by a fraction of lr;
  as tests/test_torch_train.py holds parameters); the log rows and the val
  pass rtol 1e-4 ((MS-)SSIM atol 1e-5).
  bfloat16 transforms: the analysis's latents already differ (each bfloat16
  op rounds to 2^-8 relative, and XLA and oneDNN sum in other orders: 1.8%
  of max|y| measured, 1.3% in L2), and the difference does not grow over
  the steps; so the latents are held after every step within 2^-5 *
  max|latent| + 0.05 * lr, and rd_loss in the log rows and the val pass
  within rtol 2e-2 (measured up to 0.9%).
  """
  bf16 = dtype == "bfloat16"
  cfg = _config(offset_heuristic)
  jax_model, params, port = models(cfg, seed=2)
  if bf16:
    jax_model = jax_mshyper.Model(**cfg, dtype=jnp.bfloat16)
    port.transforms_dtype = torch.bfloat16
  x = _batch(b)
  te_cfg = dict(TRAIN_EVAL, step_dispatch="stream")  # the port ignores the key
  fns = jax_itinf_lib.make_jitted_itinf(jax_model, OPTIMIZER, STEPS)
  offset_j = fns.offset(params)
  key = jax.random.PRNGKey(0)
  lat_j, opt_j = fns.init(params, x)
  shapes = [r.loc.shape for r in lat_j.uq]

  def noise_fn(step):
    return _jax_draws(key, step, *shapes)

  t_fns = itinf_lib.make_itinf_functions(port, OPTIMIZER, STEPS)
  offset_t = t_fns.frozen_offset()
  lat_t, opt_t = t_fns.init(to_torch(x))
  for step in range(STEPS):
    lat_j, opt_j = fns.step(params, x, lat_j, opt_j, jnp.int32(step), key, offset_j)
    t_fns.step(to_torch(x), lat_t, opt_t, step, offset_t, noise=noise_fn(step))
    lr = float(opt_t.lr_fn(step))
    for name, a, r in zip(("z", "y"), lat_t.uq, lat_j.uq):
      ref = np.array(r.loc)
      atol = 0.05 * lr + (2**-5 * np.abs(ref).max() if bf16 else 0.0)
      err = np.abs(to_numpy(a.loc) - ref)
      assert (err <= atol).all(), f"step {step} {name}: max|err| {err.max()}"

  train_j, val_j, vars_j = jax_itinf_lib.itinf_on_data_batch(
      jax_model, params, x, te_cfg, OPTIMIZER, workdir=str(tmp_path / "jax"), seed=0,
      jitted_fns=fns, offset=offset_j)
  train_t, val_t, vars_t = itinf_lib.itinf_on_data_batch(
      port, x, te_cfg, OPTIMIZER, workdir=str(tmp_path / "port"), noise_fn=noise_fn)
  assert set(vars_t) == set(vars_j) == {"uq_0_loc", "uq_1_loc"}
  assert all(v.dtype == np.float32 for v in vars_t.values())
  rows_j = _rows(tmp_path / "jax" / "train" / "record.jsonl")
  rows_t = _rows(tmp_path / "port" / "train" / "record.jsonl")
  assert [r["step"] for r in rows_t] == [r["step"] for r in rows_j] == [2, 4, 6]
  assert rows_t[-1] == {"step": STEPS, **train_t}
  assert _rows(tmp_path / "port" / "val" / "record.jsonl") == [{"step": STEPS, **val_t}]
  for row_t, row_j in [*zip(rows_t, rows_j), (val_t, val_j)]:
    assert set(row_t) == set(row_j)
    for k in row_j:
      if k == "step" or (bf16 and k != "rd_loss"):
        continue
      if k.startswith("msssim"):
        np.testing.assert_allclose(row_t[k], row_j[k], atol=1e-5, err_msg=k)
      else:
        np.testing.assert_allclose(row_t[k], row_j[k], rtol=2e-2 if bf16 else 1e-4, err_msg=k)
  for k in ("scheduled_lr", "tau", "sched_rd_lambda"):
    assert [r[k] for r in rows_t] == [r[k] for r in rows_j]


def test_segmented_run_takes_the_one_segment_trajectory(monkeypatch):
  """The port's own draws depend only on the seed and the step, and a val pass
  draws nothing: 3 segments with mid-run val passes end on the latents and
  the last log row of one segment bit for bit. With the offset heuristic
  off (as configs.ITINF) the offset's bisection never runs."""
  _, _, port = models(_config(False), seed=3)
  monkeypatch.setattr(port._prior, "quantization_offset",
                      lambda: pytest.fail("the offset's bisection ran"))
  x = _batch(1)
  runs = [itinf_lib.itinf_on_data_batch(port, x, dict(TRAIN_EVAL, eval_every_steps=every),
                                        OPTIMIZER, seed=7) for every in (2, STEPS)]
  (train_a, _, vars_a), (train_b, val_b, vars_b) = runs
  assert train_a == train_b
  assert all(np.array_equal(vars_a[k], vars_b[k]) for k in vars_b)
  other = itinf_lib.itinf_on_data_batch(port, x, TRAIN_EVAL, OPTIMIZER, seed=8)
  assert not np.array_equal(other[2]["uq_1_loc"], vars_b["uq_1_loc"])
  assert "msssim" in val_b and "msssim" not in train_b


def test_itinf_eval_computes_the_offset_once_per_pass(tmp_path, monkeypatch):
  """With the offset heuristic on, a 2-image pass runs the bisection once."""
  _, _, port = models(_config(True), seed=3)
  calls = []
  offset = port._prior.quantization_offset
  monkeypatch.setattr(port._prior, "quantization_offset", lambda: calls.append(1) or offset())
  config = dict(model_config=dict(optimizer_config=OPTIMIZER),
                train_eval_config=dict(TRAIN_EVAL, num_steps=2))
  metrics = itinf_lib.itinf_eval(port, [_batch(1), _batch(1)], config, str(tmp_path))
  assert [m["batch_id"] for m in metrics] == [0, 1] and len(calls) == 1


def test_itinf_config_is_the_jax_one():
  """configs.ITINF carries mshyper/configs/itinf.py's schedule, optimizer,
  relaxation and dtype over the flagship (ml_collections is read here, as a
  test-only dependency)."""
  from shallow_ntc_tpu.mshyper.configs import itinf as jax_itinf_config

  ref = jax_itinf_config.get_config()
  port = configs.ITINF
  ref_te = ref.train_eval_config.to_dict()
  for key in ("warm_start_exp_dir", "warm_start_wid"):
    ref_te.pop(key)
  assert port["train_eval_config"] == ref_te
  assert port["model_config"] == {**copy.deepcopy(configs.TWO_LAYER_SYN_RD),
                                  **ref.model_config.to_dict()}
  assert {k: v for k, v in port["data_config"].items() if k != "dataset"} == {
      k: v for k, v in ref.data_config.items() if k != "dataset"}


def test_itinf_cli_writes_the_jax_artifacts(tmp_path, monkeypatch):
  """The CLI end to end on the CPU at the small config: two .npy images, 4
  steps logged every 2, bfloat16 transforms (the config's); the per-image
  metrics.json and itinf_vars.npz (float32 z and y) and the top-level
  metrics.json, as the JAX itinf writes them. Without --device it needs CUDA."""
  monkeypatch.setattr(configs, "ITINF", dict(
      configs.ITINF, model_config=dict(configs.ITINF["model_config"],
                                       transform_config=SMALL_CONFIG["transform_config"])))
  rng = np.random.default_rng(0)
  for i in range(2):
    np.save(tmp_path / f"img{i}.npy", rng.integers(0, 256, (48, 80, 3)).astype(np.uint8))
  out = tmp_path / "out"
  argv = ["--init_seed", "0", "--images", str(tmp_path / "img*.npy"), "--num_steps", "4",
          "--log_every", "2", "--out", str(out)]
  metrics = itinf_cli.main(argv + ["--device", "cpu"])
  val_keys = {"rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda", "hyper_latent_bpp",
              "latent_bpp", "tau", "msssim", "msssim_db"}
  assert [m["batch_id"] for m in metrics] == [0, 1]
  with open(out / "metrics.json") as f:
    assert json.load(f) == metrics
  assert set(metrics[0]) == val_keys | {"batch_id"}
  for i in range(2):
    d = out / f"batch_id={i}"
    with open(d / "metrics.json") as f:
      per = json.load(f)
    assert set(per["train"]) == val_keys - {"msssim", "msssim_db"} | {"scheduled_lr"}
    assert per["val"] == {k: v for k, v in metrics[i].items() if k != "batch_id"}
    assert [r["step"] for r in _rows(d / "train" / "record.jsonl")] == [2, 4]
    with np.load(d / "itinf_vars.npz") as npz:
      assert sorted(npz.files) == ["uq_0_loc", "uq_1_loc"]
      assert npz["uq_0_loc"].dtype == npz["uq_1_loc"].dtype == np.float32
          # 48x80 pads to 64x128: z 1x2, y 4x8.
      assert npz["uq_0_loc"].shape == (1, 1, 2, 16) and npz["uq_1_loc"].shape == (1, 4, 8, 16)
  with open(out / "config.json") as f:
    assert json.load(f)["train_eval_config"]["num_steps"] == 4
  assert all(np.isfinite(v) for m in metrics for v in m.values())
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    itinf_cli.main(argv)


def test_transforms_dtype_casts_the_transforms_inputs_only():
  """With bfloat16 transforms the analysis, the hyper pair and the synthesis
  compute in bfloat16, and mixed float32/bfloat16 arithmetic promotes to
  float32 in torch as in JAX: the sample about a bfloat16 mu, the bits and
  the loss are float32, and so are the latents' gradients."""
  _, _, port = models(_config(False), seed=4)
  port.transforms_dtype = torch.bfloat16
  x = to_torch(_batch(1))
  with torch.no_grad():
    rv = port.infer_latent_rvs(x)
    mu, idx = port.hyper_synthesize(rv.uq[0].loc.float())
    rec = port.synthesize(rv.uq[1].loc.float())
  assert {r.loc.dtype for r in rv.uq} == {mu.dtype, idx.dtype, rec.dtype} == {torch.bfloat16}
  assert (to_torch(np.zeros(3)) - mu.flatten()[:3]).dtype == torch.float32
  locs = [r.loc.float().requires_grad_(True) for r in rv.uq]
  latents = LatentRVCollection(uq=tuple(UQLatentRV(loc=t) for t in locs))
  loss, metrics, _ = port.frame_loss_given_latent_rvs(
      x, latents, training=True, step=0, generator=torch.Generator().manual_seed(0), itinf=True)
  assert loss.dtype == torch.float32 and all(v.dtype == torch.float32 for v in metrics.values())
  assert all(g.dtype == torch.float32 for g in torch.autograd.grad(loss, locs))
  assert all(p.dtype == torch.float32 for p in port.parameters())
  # A mixedq model builds, with its offset heuristic turned off
  # (models/base.py:effective_offset_heuristic, as the JAX model factory).
  mixedq = eval_lib.build_model(dict(SMALL_CONFIG, latent_config=dict(uq=dict(method="mixedq"))),
                                init_seed=0, device="cpu")
  assert not mixedq.offset_heuristic and mixedq.prior_quantization_offset() is None
