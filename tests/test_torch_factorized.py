"""The port's factorized-prior family (Balle 2017) against the JAX package on
the CPU, float32: the model's eval, its training loss and gradients (unoise
and mixedq), two train steps, a 6-step SGA trajectory, FactorizedCodec, and
the eval, train, compress and itinf CLIs with --config bls2017_rd /
itinf_factorized. BLS2017 at 8 filters (bls2017_rd's schedule and lambda),
64x64 images unless stated. JAX's factorized model takes its draws from the
step's key itself (no split: one latent), and the port is fed them.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_ntc_tpu import itinf_lib as jax_itinf_lib
from shallow_ntc_tpu.codec import api as jax_api
from shallow_ntc_tpu.codec import bindings as jax_bindings
from shallow_ntc_tpu.models import factorized as jax_factorized
from shallow_ntc_tpu_torch import compress as compress_cli
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import itinf as itinf_cli
from shallow_ntc_tpu_torch import itinf_lib
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch import train as train_cli
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.codec import api, bindings
from shallow_ntc_tpu_torch.models import factorized
from shallow_ntc_tpu_torch.models import families
from tests.test_torch_train import _batch, _flat, check_two_train_steps_match_jax
from tests.torch_parity import images, models, to_numpy, to_torch

SMALL = copy.deepcopy(configs.BLS2017_RD)
SMALL["transform_config"]["analysis"]["num_filters"] = 8
SMALL["transform_config"]["synthesis"]["num_filters"] = 8
JAX_CLS = jax_factorized.Model
BOUNDARY = 1e-4  # symbols are compared where the value lies farther than this from a .5


def _uniform(key, step, shape):
  return to_torch(jax.random.uniform(jax.random.fold_in(key, step), shape, jnp.float32, -0.5, 0.5))


def _logistic(key, step, shape):
  return to_torch(jax.random.logistic(jax.random.fold_in(key, step), shape, jnp.float32))


@pytest.fixture(scope="module")
def small_models():
  return models(SMALL, seed=0, family="factorized")


@pytest.mark.parametrize("hw", [(64, 64), (72, 104)])
def test_eval_matches_jax(small_models, hw):
  """training=False: y atol 1e-4; the synthesis of JAX's rounded y atol 1e-4 *
  max(1, max|ref|); the prior's log-likelihood at those latents rtol 1e-5;
  the metrics rtol 1e-3, the total rate (the prior's alone) included, and no
  latent_bpp key (one rate term); (MS-)SSIM atol 1e-5. 72x104 pads to
  80x112 and unpads the reconstruction."""
  jax_model, params, port = small_models
  x = images(hw[1], hw)

  def apply(method, *args):
    return jax.jit(functools.partial(jax_model.apply, method=method))({"params": params}, *args)

  (rv,) = apply(JAX_CLS.infer_latent_rvs, x).uq
  y_j = np.asarray(rv.loc)
  with torch.no_grad():
    y_t = to_numpy(port.infer_latent_rvs(to_torch(x)).uq[0].loc)
  np.testing.assert_allclose(y_t, y_j, atol=1e-4)
  offset = np.asarray(apply(JAX_CLS.prior_quantization_offset))
  y_hat = np.round(y_j - offset) + offset
  rec_j = np.asarray(apply(JAX_CLS.synthesize, y_hat))
  log_p_j = np.asarray(apply(JAX_CLS.prior_log_prob_noisy, y_hat))
  with torch.no_grad():
    rec_t = to_numpy(port.synthesize(to_torch(y_hat)))
    log_p_t = to_numpy(port._prior.log_prob_noisy(to_torch(y_hat)))
  np.testing.assert_allclose(rec_t, rec_j, atol=1e-4 * max(1.0, float(np.abs(rec_j).max())))
  np.testing.assert_allclose(log_p_t, log_p_j, rtol=1e-5, atol=1e-6)

  _, m_j, _ = jax.jit(lambda q, xx: jax_model.apply(
      {"params": q}, xx, training=False, rng=None, step=0,
      method=JAX_CLS.end_to_end_frame_loss))(params, x)
  with torch.no_grad():
    _, m_t, rec255 = port.end_to_end_frame_loss(to_torch(x), training=False)
  assert rec255.shape == x.shape
  assert set(m_t) == set(m_j) and "latent_bpp" not in m_t
  for key in ("bpp", "psnr", "mse", "rd_loss"):
    np.testing.assert_allclose(float(m_t[key]), float(m_j[key]), rtol=1e-3, err_msg=key)
  assert float(m_t["sched_rd_lambda"]) == float(m_j["sched_rd_lambda"])
  np.testing.assert_allclose(float(m_t["msssim"]), float(m_j["msssim"]), atol=1e-5)


def test_numpy_init_has_the_flax_tree():
  jax_model = JAX_CLS(**SMALL)
  shapes = jax.eval_shape(lambda: jax_model.init(
      jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), training=False))["params"]
  flax_flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
  flat = params_lib.init_params(families.build_model(SMALL, "factorized")[0], seed=3)
  assert {k: v.shape for k, v in flat.items()} == flax_flat
  with pytest.raises(ValueError, match="unknown model family"):
    families.build_model(SMALL, "hyperprior")


@pytest.mark.parametrize("method", ["unoise", "mixedq"])
def test_training_loss_and_gradients_match_jax(method):
  """training=True with JAX's uniform draw: loss and metrics rtol 1e-5, every
  parameter gradient within 1e-4 * max(1, max|g|) (as
  tests/test_torch_train.py). mixedq: the bits of the noisy sample, the
  rounded y into the synthesis, offset heuristic off."""
  cfg = dict(SMALL, latent_config=dict(uq=dict(method=method)))
  jax_model, params, port = models(cfg, seed=1, family="factorized")
  assert port.offset_heuristic == (method == "unoise") == jax_model.offset_heuristic
  port.train()
  x = _batch(2)
  key = jax.random.PRNGKey(4)

  def loss_fn(p):
    loss, metrics, _ = jax_model.apply({"params": p}, x, training=True,
                                       rng=jax.random.fold_in(key, 0), step=0,
                                       method=JAX_CLS.end_to_end_frame_loss)
    return loss, metrics

  (_, m_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
  loss_t, m_t, _ = port.end_to_end_frame_loss(to_torch(x), training=True, step=0,
                                              noise=(_uniform(key, 0, (2, 4, 4, 8)),))
  loss_t.backward()
  assert set(m_t) == set(m_j) and "msssim" not in m_t
  for k in m_j:
    np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]), rtol=1e-5, err_msg=k)
  g_j = _flat(g_j)
  for name, p in port.named_parameters():
    g = g_j[name.replace(".", "/")]
    np.testing.assert_allclose(to_numpy(p.grad), g, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(g).max())), err_msg=name)


def test_two_train_steps_match_jax():
  check_two_train_steps_match_jax(
      SMALL, configs.TRAIN_CONFIGS["bls2017_rd"]["model_config"]["optimizer_config"],
      family="factorized", noise_fn=lambda key, step: (_uniform(key, step, (2, 4, 4, 8)),))


# --- SGA -------------------------------------------------------------------------
SGA = dict(method="sga", tau_r=0.1, tau_ub=0.5, tau_t0=2)
OPTIMIZER = configs.ITINF_FACTORIZED["model_config"]["optimizer_config"]
STEPS = 6
TRAIN_EVAL = dict(num_steps=STEPS, log_metrics_every_steps=2, eval_every_steps=STEPS,
                  step_dispatch="stream")


def _rows(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


@pytest.mark.parametrize("b,offset_heuristic", [(1, False), (2, True)])
def test_itinf_trajectory_matches_jax(tmp_path, b, offset_heuristic):
  """STEPS SGA steps of the one latent y with JAX's logistic draws, against
  JAX's jitted itinf step and itinf_on_data_batch, with the tolerances of
  tests/test_torch_itinf.py: y after every step within 0.05 * lr; the log
  rows and the val pass rtol 1e-4 ((MS-)SSIM atol 1e-5); the schedules'
  scalars equal."""
  cfg = dict(SMALL, latent_config=dict(uq=dict(SGA)), offset_heuristic=offset_heuristic)
  jax_model, params, port = models(cfg, seed=2, family="factorized")
  x = np.concatenate([images(i, (64, 64)) for i in range(b)])
  fns = jax_itinf_lib.make_jitted_itinf(jax_model, OPTIMIZER, STEPS)
  offset_j = fns.offset(params)
  key = jax.random.PRNGKey(0)
  lat_j, opt_j = fns.init(params, x)
  (shape,) = [r.loc.shape for r in lat_j.uq]

  def noise_fn(step):
    return (_logistic(key, step, shape),)

  t_fns = itinf_lib.make_itinf_functions(port, OPTIMIZER, STEPS)
  offset_t = t_fns.frozen_offset()
  assert (offset_t is None) == (not offset_heuristic)
  lat_t, opt_t = t_fns.init(to_torch(x))
  for step in range(STEPS):
    lat_j, opt_j = fns.step(params, x, lat_j, opt_j, jnp.int32(step), key, offset_j)
    t_fns.step(to_torch(x), lat_t, opt_t, step, offset_t, noise=noise_fn(step))
    err = np.abs(to_numpy(lat_t.uq[0].loc) - np.array(lat_j.uq[0].loc))
    tol = 0.05 * float(opt_t.lr_fn(step))
    assert (err <= tol).all(), f"step {step}: max|err| {err.max()}"

  train_j, val_j, vars_j = jax_itinf_lib.itinf_on_data_batch(
      jax_model, params, x, TRAIN_EVAL, OPTIMIZER, workdir=str(tmp_path / "jax"), seed=0,
      jitted_fns=fns, offset=offset_j)
  train_t, val_t, vars_t = itinf_lib.itinf_on_data_batch(
      port, x, TRAIN_EVAL, OPTIMIZER, workdir=str(tmp_path / "port"), noise_fn=noise_fn)
  assert set(vars_t) == set(vars_j) == {"uq_0_loc"} and vars_t["uq_0_loc"].dtype == np.float32
  rows_j = _rows(tmp_path / "jax" / "train" / "record.jsonl")
  rows_t = _rows(tmp_path / "port" / "train" / "record.jsonl")
  assert [r["step"] for r in rows_t] == [r["step"] for r in rows_j] == [2, 4, 6]
  for row_t, row_j in [*zip(rows_t, rows_j), (val_t, val_j)]:
    assert set(row_t) == set(row_j) and "latent_bpp" not in row_t
    for k in row_j:
      if k == "step":
        continue
      if k.startswith("msssim"):
        np.testing.assert_allclose(row_t[k], row_j[k], atol=1e-5, err_msg=k)
      else:
        np.testing.assert_allclose(row_t[k], row_j[k], rtol=1e-4, err_msg=k)
  for k in ("scheduled_lr", "tau", "sched_rd_lambda"):
    assert [r[k] for r in rows_t] == [r[k] for r in rows_j]


def test_segmented_sga_run_takes_the_one_segment_trajectory():
  """One latent: the draws of step s depend on (seed, s) alone, so mid-run
  val passes leave the trajectory bit for bit."""
  cfg = dict(SMALL, latent_config=dict(uq=dict(SGA)), offset_heuristic=False)
  _, _, port = models(cfg, seed=3, family="factorized")
  x = images(9, (64, 64))
  runs = [itinf_lib.itinf_on_data_batch(port, x, dict(TRAIN_EVAL, eval_every_steps=every),
                                        OPTIMIZER, seed=7) for every in (2, STEPS)]
  assert runs[0][0] == runs[1][0]
  np.testing.assert_array_equal(runs[0][2]["uq_0_loc"], runs[1][2]["uq_0_loc"])


# --- the codec -------------------------------------------------------------------
@pytest.fixture(scope="module")
def codecs(small_models):
  jax_model, params, port = small_models
  return jax_api.FactorizedCodec(jax_model, params), api.make_codec(port), port


def test_make_codec_gives_the_factorized_codec(codecs):
  _, codec, port = codecs
  assert isinstance(codec, api.FactorizedCodec) and codec.model is port
  with pytest.raises(TypeError):
    api.make_codec(torch.nn.Linear(2, 2))


def test_tables_match_jax(codecs):
  """kmin and table sizes equal, the offset within 1e-5 (a float32 bisection,
  as tests/test_torch_codec.py holds the side prior's), every CDF within 2 of
  65536 (the difference is reported), the offset equal to the eval path's."""
  jax_codec, codec, port = codecs
  ours, theirs = codec.tables, jax_codec.tables
  np.testing.assert_array_equal(ours.kmin, theirs.kmin)
  np.testing.assert_allclose(ours.offset, theirs.offset, atol=1e-5)
  np.testing.assert_array_equal(ours.tables.sizes, theirs.tables.sizes)
  diff = np.abs(ours.tables.cdfs.astype(np.int64) - theirs.tables.cdfs.astype(np.int64))
  print(f"factorized CDFs: largest count difference {diff.max()} of 65536 "
        f"({np.count_nonzero(diff)} of {diff.size} entries differ)")
  assert diff.max() <= 2
  np.testing.assert_array_equal(ours.offset, port.prior_quantization_offset().numpy())


def test_rans_bytes_equal_jax(codecs):
  """The JAX codec's symbols under its tables, coded by the port's coder, are
  the JAX blob byte for byte, and the port reads the JAX container: family
  0, one tensor."""
  jax_codec, _, _ = codecs
  x = images(3, (96, 80))
  blob = jax_codec.compress(x).bitstring
  y = np.asarray(jax.device_get(jax_codec._analyze(jax_codec.params, jnp.asarray(x))))
  t = jax_codec.tables
  syms = t.symbols_from_latent(y)
  port_tables = bindings.CdfTables(np.split(t.tables.cdfs, t.tables.offsets[1:]))
  chunks = bindings.rans_encode_striped(syms, t.channel_indexes(y.shape), port_tables)
  assert api._pack_header(api.VERSION, api.FACTORIZED_FAMILY, 96, 80) + api._pack_tensor(
      chunks) == blob
  assert api._unpack_header(blob)[:4] == (2, 0, 96, 80)
  assert api.stream_counts(blob) == jax_api.stream_counts(blob) == [1]
  np.testing.assert_array_equal(
      bindings.rans_decode_striped(chunks, t.channel_indexes(y.shape), port_tables),
      jax_bindings.rans_decode_striped(chunks, t.channel_indexes(y.shape), t.tables))


@pytest.mark.parametrize("seed,hw", [(1, (96, 80)), (2, (50, 70))])
def test_roundtrip_is_bit_exact_and_symbols_match_jax(codecs, seed, hw):
  """decompress(compress(x)) is the encoder's image, uint8 [h, w, 3] (50x70
  pads to 64x80); the symbols equal the JAX codec's where y - offset lies
  farther than 1e-4 from a .5 in both packages (the rest are counted), and
  the blob length is within 0.5% of JAX's."""
  jax_codec, codec, _ = codecs
  x = images(seed, hw)
  result = codec.compress(x[0])
  rec = codec.decompress(result.bitstring)
  assert rec.dtype == np.uint8 and rec.shape == hw + (3,)
  np.testing.assert_array_equal(rec, result.reconstruction)
  assert result.bpp == len(result.bitstring) * 8 / (hw[0] * hw[1])
  (y_t,) = codec._fetch(codec._analyze(x))()
  y_j = np.asarray(jax.device_get(jax_codec._analyze(jax_codec.params, jnp.asarray(x))))
  pre_t, pre_j = y_t - codec.tables.offset, y_j - jax_codec.tables.offset
  safe = np.logical_and.reduce([np.abs(np.abs(v - np.floor(v)) - 0.5) > BOUNDARY
                                for v in (pre_t, pre_j)])
  print(f"{hw}: y symbols near a boundary {np.count_nonzero(~safe)} of {safe.size}")
  np.testing.assert_array_equal(codec.tables.symbols_from_latent(y_t)[safe],
                                jax_codec.tables.symbols_from_latent(y_j)[safe])
  n_theirs = len(jax_codec.compress(x).bitstring)
  assert abs(len(result.bitstring) - n_theirs) <= 0.005 * n_theirs


def test_decoded_latent_equals_the_eval_paths_within_an_ulp(codecs):
  """The decoded y_hat is k + o; the eval's straight-through round about o
  (y + (round(y - o) + o - y)) lands on it or within an ulp of the larger of
  |y| and |y_hat| (the sum's rounding); the share that moves is reported."""
  _, codec, port = codecs
  x = images(4, (96, 80))
  _, _, y_hat = codec.decode_latent(codec.compress(x).bitstring)
  with torch.no_grad():
    y = port.infer_latent_rvs(torch.from_numpy(x)).uq[0].loc
    offset = port.prior_quantization_offset()
    y_eval = (y + (torch.round(y - offset) + offset - y)).numpy()
  y = y.numpy()
  print(f"{np.mean(y_eval != y_hat):.4f} of y_hat moves, by <= {np.abs(y_eval - y_hat).max():.3e}")
  assert np.all(np.abs(y_eval - y_hat) <= np.spacing(np.maximum(np.abs(y), np.abs(y_hat))))


def test_batch_paths_match_the_per_image_path(codecs):
  """Byte-identical bitstreams; reconstructions equal under strict=True and
  within +-1 otherwise. Two shapes, chunks of 2."""
  _, codec, _ = codecs
  xs = [images(5, (96, 80)), images(6, (96, 80)), images(7, (64, 64)), images(8, (96, 80))]
  singles = [codec.compress(x) for x in xs]
  batch = codec.compress_batch(xs, reconstruct=True, chunk_size=2)
  assert [b.bitstring for b in batch] == [s.bitstring for s in singles]
  for b, s in zip(batch, singles):
    assert np.abs(b.reconstruction.astype(int) - s.reconstruction).max() <= 1
  assert all(r.reconstruction is None for r in codec.compress_batch(xs[:2]))
  blobs = [s.bitstring for s in singles]
  for rec, s in zip(codec.decompress_batch(blobs, chunk_size=2, strict=True), singles):
    np.testing.assert_array_equal(rec, s.reconstruction)
  for rec, s in zip(codec.decompress_batch(blobs, chunk_size=2), singles):
    assert rec.shape == s.reconstruction.shape
    assert np.abs(rec.astype(int) - s.reconstruction).max() <= 1


def test_each_codec_refuses_the_other_familys_blob(codecs):
  _, codec, _ = codecs
  blob = codec.compress(images(1, (64, 64))[0]).bitstring
  flagship = api.make_codec(models(seed=0)[2])
  with pytest.raises(ValueError, match="family 0"):
    flagship.decompress(blob)
  with pytest.raises(ValueError, match="family 1"):
    codec.decompress(flagship.compress(images(1, (64, 64))[0]).bitstring)


# --- the CLIs --------------------------------------------------------------------
def _npy_images(tmp_path, n, hw):
  rng = np.random.default_rng(0)
  for i in range(n):
    np.save(tmp_path / f"img{i}.npy", rng.integers(0, 256, hw + (3,)).astype(np.uint8))
  return str(tmp_path / "img*.npy")


def test_eval_cli_with_config_bls2017_rd(tmp_path, monkeypatch):
  """The factorized run name and record keys (one rate term), at 8 filters."""
  monkeypatch.setattr(configs, "BLS2017_RD", SMALL)
  path = eval_cli.main(["--config", "bls2017_rd", "--init_seed", "0", "--images",
                        _npy_images(tmp_path, 2, (40, 72)), "--device", "cpu",
                        "--results_dir", str(tmp_path / "out")])
  assert os.path.basename(path) == "factorized-lmbda=0.02-num_steps=20000-step=0-xid=init_seed=0.json"
  with open(path) as f:
    records = json.load(f)
  assert [r["instance_id"] for r in records] == [0, 1]
  assert set(records[0]) == {"rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda", "msssim",
                             "msssim_db", "instance_id", "lmbda", "num_steps"}
  assert records[0]["lmbda"] == "0.02" and records[0]["num_steps"] == "20000"


def test_train_cli_with_config_bls2017_rd(tmp_path, monkeypatch):
  """3 CPU steps at 8 filters, B=2 64x64: JAX's record keys of the family, a
  checkpoint the factorized model loads back, and a resume."""
  cfg = copy.deepcopy(configs.TRAIN_CONFIGS["bls2017_rd"])
  cfg["model_config"]["transform_config"] = SMALL["transform_config"]
  cfg["train_data_config"].update(batchsize=2, patchsize=64)
  cfg["val_data_config"].update(patchsize=64)
  cfg["train_eval_config"].update(log_metrics_every_steps=3, max_validation_steps=1)
  monkeypatch.setitem(configs.TRAIN_CONFIGS, "bls2017_rd", cfg)
  workdir = str(tmp_path / "wd")
  argv = ["--config", "bls2017_rd", "--workdir", workdir, "--num_steps", "3", "--device", "cpu"]
  state = train_cli.main(argv)
  assert state.step == 3 and isinstance(state.model, factorized.Model)
  train_rows = _rows(os.path.join(workdir, "train", "record.jsonl"))
  val_rows = _rows(os.path.join(workdir, "val", "record.jsonl"))
  assert set(train_rows[0]) == {"step", "rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda",
                                "scheduled_lr", "steps_per_sec"}
  assert set(val_rows[0]) == {"step", "rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda",
                              "msssim", "msssim_db"}
  assert all(np.isfinite(v) for r in train_rows + val_rows for v in r.values())
  restored = train_lib.model_from_checkpoint(workdir, cfg["model_config"], "cpu", "factorized")
  for (k, a), b in zip(state.model.state_dict().items(), restored.state_dict().values()):
    assert torch.equal(a, b), k
  with open(os.path.join(workdir, "config.json")) as f:
    assert json.load(f)["model_family"] == "factorized"
  assert train_cli.main(argv).step == 3


def test_compress_cli_with_config_bls2017_rd(tmp_path):
  """Full width (192 filters) on a 40x56 image: compress with --init_seed,
  decompress with the same weights from --params, against the in-process
  codec; roundtrip is bit-exact."""
  img = np.random.default_rng(0).integers(0, 256, (40, 56, 3)).astype(np.uint8)
  np.save(tmp_path / "img.npy", img)
  model, _ = families.build_model(configs.BLS2017_RD, "factorized")
  flat = params_lib.init_params(model, 0)
  np.savez(tmp_path / "params.npz", **flat)
  common = ["--config", "bls2017_rd", "--device", "cpu"]
  compress_cli.main(["compress", "--init_seed", "0", "--input", str(tmp_path / "img.npy"),
                     "--output", str(tmp_path / "img.sntc")] + common)
  compress_cli.main(["decompress", "--params", str(tmp_path / "params.npz"), "--input",
                     str(tmp_path / "img.sntc"), "--output", str(tmp_path / "rec.npy")] + common)
  params_lib.load_params(model, flat)
  result = api.make_codec(model.eval()).compress(img.astype(np.float32) / 255.0 - 0.5)
  assert (tmp_path / "img.sntc").read_bytes() == result.bitstring
  np.testing.assert_array_equal(np.load(tmp_path / "rec.npy"), result.reconstruction)
  line = compress_cli.main(["roundtrip", "--init_seed", "0", "--input",
                            str(tmp_path / "img.npy")] + common)
  assert line.endswith("bit_exact=True") and f"bytes={len(result.bitstring)}" in line


def test_itinf_cli_with_config_itinf_factorized(tmp_path, monkeypatch):
  """--config itinf_factorized at 8 filters: two 48x80 images, 4 steps logged
  every 2; itinf_vars.npz holds the one latent, float32 [1, 3, 5, 8]."""
  monkeypatch.setattr(configs, "ITINF_FACTORIZED", dict(
      configs.ITINF_FACTORIZED, model_config=dict(configs.ITINF_FACTORIZED["model_config"],
                                                  transform_config=SMALL["transform_config"])))
  out = tmp_path / "out"
  metrics = itinf_cli.main(["--config", "itinf_factorized", "--init_seed", "0", "--images",
                            _npy_images(tmp_path, 2, (48, 80)), "--num_steps", "4",
                            "--log_every", "2", "--out", str(out), "--device", "cpu"])
  assert [m["batch_id"] for m in metrics] == [0, 1]
  assert set(metrics[0]) == {"batch_id", "rd_loss", "bpp", "mse", "psnr", "sched_rd_lambda",
                             "tau", "msssim", "msssim_db"}
  with np.load(out / "batch_id=1" / "itinf_vars.npz") as npz:
    assert npz.files == ["uq_0_loc"]
    assert npz["uq_0_loc"].dtype == np.float32 and npz["uq_0_loc"].shape == (1, 3, 5, 8)
  with open(out / "config.json") as f:
    assert json.load(f)["model_family"] == "factorized"
  assert all(np.isfinite(v) for m in metrics for v in m.values())
