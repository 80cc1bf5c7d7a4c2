"""The port's training path against the JAX package (CPU, float32): the
schedules, the optimizer, the training-mode loss and its gradients, two
full train steps, checkpoints and the train CLI. The model is the flagship
architecture at narrow ELIC widths (the smoke config), B=2, 64x64."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shallow_ntc_tpu import schedule as jax_schedule
from shallow_ntc_tpu import train_lib as jax_train_lib
from shallow_ntc_tpu.models import mshyper as jax_mshyper
from shallow_ntc_tpu.ops import entropy as jax_entropy
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import schedule
from shallow_ntc_tpu_torch import train as train_cli
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.ops import entropy
from shallow_ntc_tpu_torch.ops import rounding
from tests.torch_parity import models, rand, to_numpy, to_torch

SMOKE = configs.TRAIN_CONFIGS["smoke"]
OPTIMIZER_CONFIG = SMOKE["model_config"]["optimizer_config"]
MODEL_CONFIG = {k: v for k, v in SMOKE["model_config"].items() if k != "optimizer_config"}
FLAGSHIP_OPTIMIZER = configs.TRAIN_CONFIGS["two_layer_syn_rd"]["model_config"]["optimizer_config"]


def _flax_path(torch_name: str) -> str:
  return torch_name.replace(".", "/")


def _flat(tree):
  return {"/".join(str(k.key) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(seed, b=2, hw=64):
  rng = np.random.default_rng(seed)
  return (rng.integers(0, 256, (b, hw, hw, 3)).astype(np.float32) / 255.0 - 0.5)


def _jax_noise(rng_key, step, b=2, hw=64, c=16):
  """JAX's training draws: fold_in(rng, step), split, z then y
  (train_lib.py:188-207, mshyper.py:125-128)."""
  rng_z, rng_y = jax.random.split(jax.random.fold_in(rng_key, step))
  u_z = jax.random.uniform(rng_z, (b, hw // 64, hw // 64, c), jnp.float32, -0.5, 0.5)
  u_y = jax.random.uniform(rng_y, (b, hw // 16, hw // 16, c), jnp.float32, -0.5, 0.5)
  return to_torch(u_z), to_torch(u_y)


@pytest.fixture(scope="module")
def small_models():
  return models(MODEL_CONFIG, seed=0)


@pytest.mark.parametrize("step", [0, 1, 599, 600, 23999, 24000, 5999, 6000])
def test_flagship_schedules_match_jax(step):
  """The LR at step 0, at the end of warmup (600), either side of the drop
  (24000) and of the lambda warm-up (6000): equal in float32."""
  jax_lr = jax_schedule.compression_schedule(1e-4, 30_000, warmup_until=0.02, drop_after=0.8,
                                             drop_factor=0.1)
  lr = schedule.compression_schedule(1e-4, 30_000, warmup_until=0.02, drop_after=0.8,
                                     drop_factor=0.1)
  assert lr(step) == np.asarray(jax_lr(jnp.int32(step)))
  assert np.float32(schedule.scheduled_rd_lambda(0.01, step, 30_000)) == np.asarray(
      jax_schedule.scheduled_rd_lambda(0.01, jnp.int32(step), 30_000))


def test_optimizer_matches_optax():
  """Two Adam + global-clip updates on the same gradients, atol 1e-7: one
  update clipped (norm above 1), one not."""
  rng = np.random.default_rng(0)
  params = {"a": rand(rng, (5, 7)), "b": rand(rng, (3,))}
  grads = [{"a": rand(rng, (5, 7), 2.0), "b": rand(rng, (3,), 2.0)},
           {"a": rand(rng, (5, 7), 0.01), "b": rand(rng, (3,), 0.01)}]
  tx, jax_lr = jax_train_lib.make_optimizer(dict(FLAGSHIP_OPTIMIZER, warmup_until=0.0), 30_000)
  state = tx.init(params)
  p_j = params
  p_t = [to_torch(params["a"]), to_torch(params["b"])]
  opt, lr_fn = train_lib.make_optimizer(p_t, dict(FLAGSHIP_OPTIMIZER, warmup_until=0.0), 30_000)
  assert opt.eps == 1e-7 and lr_fn(0) == np.asarray(jax_lr(0))
  for g in grads:
    updates, state = tx.update(g, state, p_j)
    p_j = optax.apply_updates(p_j, updates)
    opt.update([to_torch(g["a"]), to_torch(g["b"])])
  assert opt.count == 2
  np.testing.assert_allclose(to_numpy(p_t[0]), np.asarray(p_j["a"]), rtol=0, atol=1e-7)
  np.testing.assert_allclose(to_numpy(p_t[1]), np.asarray(p_j["b"]), rtol=0, atol=1e-7)


def test_training_entropy_calls_match_jax():
  """Noise on z itself; on the centered y - mu for the indexed model; exact
  given the same draws."""
  rng = np.random.default_rng(3)
  y, loc, idx = rand(rng, (2, 4, 4, 6), 3.0), rand(rng, (2, 4, 4, 6)), rand(rng, (2, 4, 4, 6))
  idx = np.abs(idx) * 20
  key = jax.random.PRNGKey(5)
  u = jax.random.uniform(key, y.shape, jnp.float32, -0.5, 0.5)
  s_j, bits_j = jax_entropy.indexed_em_call(y, idx, loc, True, key)
  s_t, bits_t = entropy.indexed_em_call(to_torch(y), to_torch(idx), to_torch(loc),
                                        training=True, noise=to_torch(u))
  np.testing.assert_allclose(to_numpy(s_t), np.asarray(s_j), atol=1e-6)
  np.testing.assert_allclose(to_numpy(bits_t), np.asarray(bits_j), rtol=1e-5)
  # sample_unoise: loc + u, and a generator draw lies in [-.5, .5).
  np.testing.assert_array_equal(to_numpy(rounding.sample_unoise(to_torch(y), to_torch(u))),
                                y + np.asarray(u))
  g = torch.Generator().manual_seed(0)
  draw = rounding.sample_unoise(torch.zeros(1000), generator=g)
  assert draw.min() >= -0.5 and draw.max() < 0.5 and draw.std() > 0.25
  with pytest.raises(ValueError, match="noise of shape"):
    rounding.sample_unoise(torch.zeros(3), torch.zeros(4))


def test_training_loss_and_gradients_match_jax(small_models):
  """The training=True loss and metrics with JAX's noise: rtol 1e-5. Every
  parameter gradient within atol 1e-4 * max(1, max|g| of that parameter):
  at this random init the MSE is ~5e4 and gradients reach ~4e4, where one
  float32 ulp is ~4e-3, so a flat 1e-4 cannot hold; measured worst
  relative error 1.2e-6."""
  jax_model, params, port = small_models
  port.zero_grad()
  x = _batch(0)
  key = jax.random.PRNGKey(0)
  rng = jax.random.fold_in(key, 0)

  def loss_fn(p):
    loss, metrics, _ = jax_model.apply({"params": p}, x, training=True, rng=rng, step=0,
                                       method=jax_mshyper.Model.end_to_end_frame_loss)
    return loss, metrics

  (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
  loss_t, m_t, rec = port.end_to_end_frame_loss(to_torch(x), training=True, step=0,
                                                noise=_jax_noise(key, 0))
  loss_t.backward()
  assert set(m_t) == set(m_j) and "msssim" not in m_t
  assert rec.shape == x.shape
  for k in m_j:
    np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]), rtol=1e-5, err_msg=k)
  g_j = _flat(g_j)
  for name, p in port.named_parameters():
    g = g_j[_flax_path(name)]
    np.testing.assert_allclose(to_numpy(p.grad), g, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)
  port.zero_grad()


def check_two_train_steps_match_jax(model_config, optimizer_config, seed=1, family="mshyper",
                                    noise_fn=_jax_noise):
  """JAX make_train_step against the port's, twice, from the same params and
  with the same noise (noise_fn(key, step), JAX's draws): the loss within
  rtol 1e-4 at each step, and every parameter afterwards within atol 0.05 *
  lr of that step (Adam moves a parameter by ~lr * g / (|g| + 1e-7), so a
  gradient near zero whose last bits differ can move it by a fraction of
  lr)."""
  jax_model, params, port = models(model_config, seed=seed, family=family)
  tx, jax_lr = jax_train_lib.make_optimizer(optimizer_config, jax_model.scheduled_num_steps)
  key = jax.random.PRNGKey(7)
  state_j = jax_train_lib.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                     opt_state=tx.init(params), rng=key)
  step_j = jax.jit(jax_train_lib.make_train_step(jax_model, tx, jax_lr))
  state_t, lr_fn = train_lib.create_train_state(port.train(), optimizer_config)
  step_t = train_lib.make_train_step(port, state_t.optimizer, lr_fn)
  for step in range(2):
    x = _batch(10 + step)
    state_j, m_j = step_j(state_j, x)
    m_t = step_t(state_t, to_torch(x), noise=noise_fn(key, step))
    assert set(m_t) == set(m_j)
    np.testing.assert_allclose(float(m_t["rd_loss"]), float(m_j["rd_loss"]), rtol=1e-4)
    assert float(m_t["scheduled_lr"]) == float(m_j["scheduled_lr"])
    atol = 0.05 * float(lr_fn(step))
    p_j = _flat(state_j.params)
    for name, p in port.named_parameters():
      np.testing.assert_allclose(to_numpy(p), p_j[_flax_path(name)], rtol=0, atol=atol,
                                 err_msg=f"step {step}: {name}")
  assert state_t.step == int(state_j.step) == 2


def test_two_train_steps_match_jax():
  check_two_train_steps_match_jax(MODEL_CONFIG, OPTIMIZER_CONFIG)


def test_checkpoint_round_trip_resumes(tmp_path):
  """A restored state equals the saved one bit for bit and resumes at its
  step: the next step from it equals the next step of the live state."""
  model, opt_cfg = train_lib.build_model(SMOKE["model_config"], init_seed=0, device="cpu")
  state, lr_fn = train_lib.create_train_state(model, opt_cfg, seed=3)
  step_fn = train_lib.make_train_step(model, state.optimizer, lr_fn)
  batches = [torch.from_numpy(_batch(s)) for s in range(3)]
  step_fn(state, batches[0])
  train_lib.save_checkpoint(str(tmp_path), state)
  assert train_lib.latest_checkpoint_step(str(tmp_path)) == 1

  model2, _ = train_lib.build_model(SMOKE["model_config"], init_seed=9, device="cpu")
  state2, lr_fn2 = train_lib.create_train_state(model2, opt_cfg, seed=4)
  train_lib.restore_checkpoint(str(tmp_path), state2)
  assert state2.step == 1 and state2.optimizer.count == 1
  for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
    assert torch.equal(a, b), name
  for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                  state2.optimizer.mu + state2.optimizer.nu):
    assert torch.equal(a, b)
  assert torch.equal(state.generator.get_state(), state2.generator.get_state())

  m1 = step_fn(state, batches[1])
  m2 = train_lib.make_train_step(model2, state2.optimizer, lr_fn2)(state2, batches[1])
  assert float(m1["rd_loss"]) == float(m2["rd_loss"]) and state.step == state2.step == 2
  for a, b in zip(model.parameters(), model2.parameters()):
    assert torch.equal(a, b)
  train_lib.save_checkpoint(str(tmp_path), state)
  assert sorted(os.listdir(train_lib.checkpoint_dir(str(tmp_path)))) == ["ckpt_2.pt"]


def test_train_cli_writes_the_jax_record_keys(tmp_path):
  """3 CPU steps of the smoke config: record.jsonl with JAX's keys, a
  checkpoint at step 3, and a second call resumes (no further step)."""
  workdir = str(tmp_path / "wd")
  state = train_cli.main(["--config", "smoke", "--workdir", workdir, "--num_steps", "3",
                          "--device", "cpu"])
  assert state.step == 3
  with open(os.path.join(workdir, "train", "record.jsonl")) as f:
    train_records = [json.loads(line) for line in f]
  with open(os.path.join(workdir, "val", "record.jsonl")) as f:
    val_records = [json.loads(line) for line in f]
  assert [r["step"] for r in train_records] == [3]
  assert set(train_records[0]) == {
      "step", "rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda", "hyper_latent_bpp",
      "latent_bpp", "scheduled_lr", "steps_per_sec"}
  assert train_records[0]["scheduled_lr"] == pytest.approx(1e-3)
  assert set(val_records[0]) == {
      "step", "rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda", "hyper_latent_bpp",
      "latent_bpp", "msssim", "msssim_db"}
  assert all(np.isfinite(v) for r in train_records + val_records for v in r.values())
  assert train_lib.latest_checkpoint_step(workdir) == 3
  with open(os.path.join(workdir, "config.json")) as f:
    assert json.load(f)["train_eval_config"]["num_steps"] == 3
  assert train_cli.main(["--config", "smoke", "--workdir", workdir, "--num_steps", "3",
                         "--device", "cpu"]).step == 3


def test_train_cli_needs_cuda_unless_told_otherwise(monkeypatch, tmp_path):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    train_cli.main(["--config", "two_layer_syn_rd", "--workdir", str(tmp_path),
                    "--num_steps", "1"])
  assert not os.path.exists(os.path.join(str(tmp_path), "train"))


def test_npy_random_crops_are_seeded(tmp_path):
  rng = np.random.default_rng(0)
  np.save(tmp_path / "a.npy", rng.integers(0, 256, (80, 90, 3)).astype(np.uint8))
  np.save(tmp_path / "b.npy", rng.integers(0, 256, (20, 20, 3)).astype(np.uint8))  # too small
  crops = data_lib.get_dataset(str(tmp_path / "*.npy"), "train", 3, 64, seed=5)
  assert [os.path.basename(f) for f in crops.files] == ["a.npy"]
  first = [b for _, b in zip(range(2), crops)]
  again = [b for _, b in zip(range(2), crops)]
  assert first[0].shape == (3, 64, 64, 3) and first[0].dtype == np.float32
  assert np.array_equal(first[1], again[1]) and not np.array_equal(first[0], first[1])
  assert first[0].min() >= -0.5 and first[0].max() <= 0.5
  test_split = list(data_lib.get_dataset(str(tmp_path / "*.npy"), "test", 1, None))
  assert [t.shape for t in test_split] == [(1, 80, 90, 3), (1, 20, 20, 3)]
  with pytest.raises(RuntimeError, match="at least 128 px"):
    data_lib.get_dataset(str(tmp_path / "*.npy"), "train", 1, 128)


def test_flagship_train_config_is_two_layer_syn_rd():
  """The port's flagship train config is the model and optimizer of
  mshyper/configs/two_layer_syn_rd.py (read here as a module, since
  ml_collections is a test-only dependency)."""
  from shallow_ntc_tpu.mshyper.configs import two_layer_syn_rd

  ref = two_layer_syn_rd.get_config()
  port = configs.TRAIN_CONFIGS["two_layer_syn_rd"]
  ref_model = copy.deepcopy(ref.model_config.to_dict())
  assert port["model_config"] == {
      **ref_model, "transform_config": port["model_config"]["transform_config"]}
  assert eval_lib.parse_runname(configs.TWO_LAYER_SYN_RD_RUNNAME)["lmbda"] == str(
      ref_model["rd_lambda"])
  for key in ("num_steps", "log_metrics_every_steps", "checkpoint_every_steps",
              "eval_every_steps", "max_validation_steps"):
    assert port["train_eval_config"][key] == ref.train_eval_config[key]
  assert {k: port["train_data_config"][k] for k in ("batchsize", "patchsize")} == {
      "batchsize": 8, "patchsize": 256}
