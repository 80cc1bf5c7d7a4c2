"""The port's multi-device layer (shallow_ntc_tpu_torch/parallel) on the CPU,
the counterpart of tests/test_parallel.py and tests/test_multihost.py:

  * the batch slicing against the JAX functions on the same numbers;
  * the train CLI with --dp_devices 2 (two spawned gloo ranks, 3 steps,
    global batch 4, 64x64, the smoke config's widths) against a one-process
    run of the same global batches, rank 0 the only writer;
  * one data-parallel step of the port (two gloo ranks) against JAX's
    shard_train_functions step on a 2-device mesh, with the same params,
    global batch and noise (JAX's draws);
  * the height-split eval against JAX's spatial_devices=4 eval and the
    port's unsplit one, the split transforms against the unsplit ones, the
    halo of every transform against the rows a strip really gets wrong, and
    a halo one stride short, which must differ;
  * the codec: a 2-strip bitstream decodes with the unsplit codec and the
    reverse, bit for bit;
  * the CLIs' flags, and the codec CLI on PNGs of a bls2017_rd.py workdir.

The data-parallel tolerances are tests/test_parallel.py:59-68's (loss rtol
1e-4; params rtol 2e-3, atol 2e-6), the eval's :136-137 (rtol 1e-4), the
split analysis's :114-116 (rtol 1e-4, atol 1e-5).
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from shallow_ntc_tpu import eval_lib as jax_eval_lib
from shallow_ntc_tpu import train_lib as jax_train_lib
from shallow_ntc_tpu.codec import api as jax_api
from shallow_ntc_tpu.parallel import distributed as jax_distributed
from shallow_ntc_tpu.parallel import mesh as jax_mesh
from shallow_ntc_tpu_torch import compress as compress_cli
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import eval_lib, train_lib
from shallow_ntc_tpu_torch import params as params_lib
from shallow_ntc_tpu_torch.codec import api
from shallow_ntc_tpu_torch.models import transforms as T
from shallow_ntc_tpu_torch.models.elic import ElicAnalysis, ElicSynthesis
from shallow_ntc_tpu_torch.parallel import distributed, mesh
from shallow_ntc_tpu_torch.utils import cli
from shallow_ntc_tpu_torch.utils import config as config_lib
from tests import torch_parallel_worker
from tests.torch_parity import SMALL_CONFIG, images, models, nest

SMOKE = "shallow_ntc_tpu_torch/mshyper/configs/smoke.py"
BLS = "shallow_ntc_tpu_torch/factorized/configs/bls2017_rd.py"
SMOKE_CFG = config_lib.resolve_config(SMOKE, [], None)
TINY = {k: v for k, v in SMOKE_CFG["model_config"].items() if k != "optimizer_config"}
OPTIMIZER = SMOKE_CFG["model_config"]["optimizer_config"]
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-3, 2e-6
BOUNDARY = 1e-4  # symbols are compared where the value lies farther than this from a .5


def _free_port():
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def _flat(tree):
  return {"/".join(str(k.key) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _check_params(got, want):
  """got: {torch name: tensor}; want: {flax path: array}."""
  assert len(got) == len(want)
  for name, p in got.items():
    np.testing.assert_allclose(p.numpy(), want[name.replace(".", "/")], rtol=PARAM_RTOL,
                               atol=PARAM_ATOL, err_msg=name)


# --- batch slicing ---------------------------------------------------------------
@pytest.mark.parametrize("count,index,batchsize", [
    (1, 0, 3), (2, 0, 4), (2, 1, 4), (4, 3, 8), (3, 1, 9), (2, 1, 5), (4, 0, 6)])
def test_batch_slicing_matches_jax(monkeypatch, count, index, batchsize):
  """local_batch_slice and shard_batches give this process's rows in order,
  as the JAX functions do for the same process count and index; both raise
  ValueError when the batch does not divide."""
  monkeypatch.setattr(jax_distributed.jax, "process_count", lambda: count)
  monkeypatch.setattr(jax_distributed.jax, "process_index", lambda: index)
  monkeypatch.setattr(distributed, "process_count", lambda: count)
  monkeypatch.setattr(distributed, "process_index", lambda: index)
  batches = [np.arange(batchsize * 2 * k, batchsize * 2 * (k + 1)).reshape(batchsize, 2)
             for k in range(2)]
  if batchsize % count:
    for fn in (jax_distributed.local_batch_slice, distributed.local_batch_slice):
      with pytest.raises(ValueError, match="not divisible"):
        fn(batchsize)
    with pytest.raises(ValueError):
      list(distributed.shard_batches(iter(batches)))
    return
  assert distributed.local_batch_slice(batchsize) == jax_distributed.local_batch_slice(batchsize)
  ours = list(distributed.shard_batches(iter(batches)))
  theirs = list(jax_distributed.shard_batches(iter(batches)))
  assert len(ours) == len(theirs) == 2
  for a, b in zip(ours, theirs):
    np.testing.assert_array_equal(a, b)


# --- data-parallel training --------------------------------------------------------
def _train_cli(tmp_path, monkeypatch, xid, extra):
  monkeypatch.setenv("SLURM_ARRAY_JOB_ID", xid)
  monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "0")
  te = "--config.train_eval_config."
  argv = ["--config", SMOKE, "--hid", "0", "--device", "cpu",
          "--experiments_dir", str(tmp_path / "xms"), f"{te}num_steps=3",
          f"{te}log_metrics_every_steps=1", f"{te}eval_every_steps=3",
          f"{te}checkpoint_every_steps=3", f"{te}max_validation_steps=1",
          "--config.train_data_config.batchsize=4", "--config.val_data_config.batchsize=2"]
  _, workdir = cli.run_train_main("mshyper", argv + extra)
  return workdir


def _records(workdir, collection):
  with open(os.path.join(workdir, collection, "record.jsonl")) as f:
    return [json.loads(line) for line in f]


def test_dp_train_cli_matches_one_process(tmp_path, monkeypatch):
  """--dp_devices 2 (two spawned gloo ranks) against --dp_devices 1 on the
  same global batches and noise: the logged (global-mean) rd_loss of each
  step and the val metrics within rtol 1e-4, the params within rtol 2e-3
  atol 2e-6. Only rank 0 wrote: one line a step, one checkpoint, and its
  params load into the plain eval's model."""
  dp = _train_cli(tmp_path, monkeypatch, "dp", ["--dp_devices", "2"])
  one = _train_cli(tmp_path, monkeypatch, "one", ["--dp_devices", "1"])
  assert dp == str(tmp_path / "xms" / "dp" / "wid=0-mshyper-lmbda=0.01-uq=unoise")
  rows_dp, rows_one = _records(dp, "train"), _records(one, "train")
  assert [r["step"] for r in rows_dp] == [r["step"] for r in rows_one] == [1, 2, 3]
  for a, b in zip(rows_dp, rows_one):
    np.testing.assert_allclose(a["rd_loss"], b["rd_loss"], rtol=LOSS_RTOL)
  (val_dp,), (val_one,) = _records(dp, "val"), _records(one, "val")
  assert set(val_dp) == set(val_one)
  for key in ("rd_loss", "bpp", "psnr", "msssim"):
    np.testing.assert_allclose(val_dp[key], val_one[key], rtol=LOSS_RTOL, err_msg=key)
  assert os.listdir(train_lib.checkpoint_dir(dp)) == ["ckpt_3.pt"]
  ckpt = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(dp))
  want = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(one))
  assert ckpt["step"] == want["step"] == 3 and ckpt["optimizer"]["count"] == 3
  _check_params(ckpt["model"], {k.replace(".", "/"): v.numpy()
                                for k, v in want["model"].items()})
  model, config = eval_lib.load_latest_ckpt(dp, device="cpu")
  assert config["_restored_step"] == 3
  for k, v in model.state_dict().items():
    assert torch.equal(v, ckpt["model"][k]), k
  (record,) = eval_lib.evaluate_images(model, images(0, (64, 64)))
  assert np.isfinite(record["rd_loss"])


def _jax_draws(key, step, b, hw):
  """JAX's training draws of the smoke model: fold_in(rng, step), split, z
  then y (train_lib.py:188-207, mshyper.py:125-128); z is hw/32, y hw/16."""
  rng_z, rng_y = jax.random.split(jax.random.fold_in(key, step))
  u_z = jax.random.uniform(rng_z, (b, hw // 32, hw // 32, 12), jnp.float32, -0.5, 0.5)
  u_y = jax.random.uniform(rng_y, (b, hw // 16, hw // 16, 12), jnp.float32, -0.5, 0.5)
  return np.asarray(u_z), np.asarray(u_y)


def _dp_step_against_jax(tmp_path, sync):
  """(rank 0's result of one port step of two gloo ranks, JAX's metrics,
  JAX's params) of test_dp_step_matches_jax_two_device_mesh; sync=False
  steps each rank on its own gradients."""
  jax_model, params, port = models(TINY, seed=0)
  tx, lr_fn = jax_train_lib.make_optimizer(OPTIMIZER, jax_model.scheduled_num_steps)
  key = jax.random.PRNGKey(7)
  state = jax_train_lib.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=tx.init(params), rng=key)
  mesh_2 = jax_mesh.make_mesh(2)
  dp_step, _, dp_state = jax_mesh.shard_train_functions(
      mesh_2, jax_train_lib.make_train_step(jax_model, tx, lr_fn),
      jax_train_lib.make_eval_step(jax_model), state)
  batch = np.random.default_rng(3).uniform(-0.5, 0.5, (4, 64, 64, 3)).astype(np.float32)
  state_j, metrics_j = dp_step(dp_state, jax_mesh.put_batch(batch, mesh_2))

  flat = {k.replace(".", "/"): v.numpy() for k, v in port.state_dict().items()}
  out = str(tmp_path / "rank0.pt")
  torch.multiprocessing.start_processes(
      torch_parallel_worker.dp_step,
      args=(2, f"127.0.0.1:{_free_port()}", TINY, OPTIMIZER, flat, batch,
            _jax_draws(key, 0, 4, 64), out, sync), nprocs=2, start_method="spawn")
  return (torch.load(out, weights_only=True), metrics_j,
          _flat(jax.device_get(state_j.params)))


def test_dp_step_matches_jax_two_device_mesh(tmp_path):
  """One step of two gloo ranks (train_lib.make_train_step in the default
  group: DDP, each rank its rows of the global batch and noise) against
  JAX's shard_train_functions step on a 2-device 'data' mesh, from the same
  params, on the same global batch (4 x 64x64) and JAX's draws: the loss
  within rtol 1e-4, every param within rtol 2e-3 atol 2e-6."""
  result, metrics_j, params_j = _dp_step_against_jax(tmp_path, sync=True)
  assert result["step"] == 1
  np.testing.assert_allclose(result["metrics"]["rd_loss"], float(metrics_j["rd_loss"]),
                             rtol=LOSS_RTOL)
  _check_params(result["model"], params_j)


def test_dp_step_without_gradient_sync_differs(tmp_path):
  """The control of the test above: the same step with each rank on its own
  gradients (the loss called past DDP's forward) leaves params outside
  that tolerance, so the comparison sees gradients that are not averaged."""
  result, _, params_j = _dp_step_against_jax(tmp_path, sync=False)
  assert result["step"] == 1
  worst = max(np.max(np.abs(p.numpy() - params_j[name.replace(".", "/")])
                      / (PARAM_ATOL + PARAM_RTOL * np.abs(params_j[name.replace(".", "/")])))
              for name, p in result["model"].items())
  print(f"max |p - p_jax| / (atol + rtol |p_jax|) without gradient sync: {worst:.3f}")
  assert worst > 1


# --- height split -----------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
  return models(TINY, seed=0)


@pytest.mark.parametrize("hw", [(128, 64), (192, 64)])
def test_split_eval_matches_jax_spatial_eval(tiny, hw):
  """evaluate_images on 4 strips (devices=[cpu] * 4) against JAX's
  evaluate_images(spatial_devices=4) and the port's unsplit eval: bpp, PSNR
  and rd_loss within rtol 1e-4. At 192 rows the strips are 48 rows high,
  edges that fall on no multiple of 64."""
  jax_model, params, port = tiny
  img = np.random.default_rng(5).uniform(-0.5, 0.5, (1,) + hw + (3,)).astype(np.float32)
  (theirs,) = jax_eval_lib.evaluate_images(jax_model, params, img, spatial_devices=4)
  (whole,) = eval_lib.evaluate_images(port, img)
  (split,) = eval_lib.evaluate_images(port, img, devices=["cpu"] * 4)
  for key in ("bpp", "psnr", "rd_loss"):
    np.testing.assert_allclose(split[key], whole[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(split[key], theirs[key], rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("config,hw,strips", [("tiny", (128, 64), 4),
                                               ("flagship", (256, 64), 2),
                                               ("flagship", (320, 96), 3)])
def test_split_analysis_matches_the_whole(tiny, config, hw, strips):
  """The analysis's y on strips against the whole image's, rtol 1e-4 atol
  1e-5 (tests/test_parallel.py:114-116); the synthesis of round(y) too."""
  port = tiny[2] if config == "tiny" else models(SMALL_CONFIG, seed=0)[2]
  x = torch.from_numpy(images(2, hw))
  with torch.no_grad():
    y = port._analysis(x)
    y_split = mesh.HeightSplit(port._analysis, ["cpu"] * strips)(x)
    rec = port._synthesis(torch.round(y))
    rec_split = mesh.HeightSplit(port._synthesis, ["cpu"] * strips)(torch.round(y))
  np.testing.assert_allclose(y_split.numpy(), y.numpy(), rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(rec_split.numpy(), rec.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("part", ["analysis", "synthesis"])
def test_a_halo_one_stride_short_differs(part, monkeypatch):
  """The flagship's transforms (ELIC at narrow widths) in float64 on 2
  strips: with row_halo's halo the strips equal the whole; with one coarse
  row less at each edge (one stride of the input for the analysis; row_halo
  patched) they differ, at rows next to the strip edge only."""
  port = models(SMALL_CONFIG, seed=0)[2].double()
  transform = getattr(port, f"_{part}")
  halo = mesh.row_halo(transform)
  top, bottom, _, rows_out = halo
  rng = np.random.default_rng(1)
  if part == "analysis":
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 256, 64, 3)))
  else:
    x = torch.from_numpy(np.round(rng.normal(0, 3, (1, 16, 4, 16))))
  with torch.no_grad():
    whole = transform(x)
    exact = mesh.HeightSplit(transform, ["cpu"] * 2)(x)
    monkeypatch.setattr(mesh, "row_halo", lambda t: (top - 1, bottom - 1, *halo[2:]))
    short = mesh.HeightSplit(transform, ["cpu"] * 2)(x)
  np.testing.assert_allclose(exact.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)
  rows = torch.nonzero((short - whole).abs().amax(dim=(0, 2, 3))).flatten().tolist()
  edge = whole.shape[1] // 2
  assert rows, "a halo one row short gave the whole image's result"
  assert all(edge - rows_out <= r < edge + rows_out for r in rows), rows


def _bad_rows_measured(transform, x):
  """(top, bottom) rows of the output that a strip computes differently
  from the whole, at a cut in the middle of x: the bottom edge of the
  upper strip and the top edge of the lower one."""
  whole = transform(x)
  cut = x.shape[1] // 2
  upper, lower = transform(x[:, :cut]), transform(x[:, cut:])
  n = upper.shape[1]
  d_up = torch.nonzero((upper - whole[:, :n]).abs().amax(dim=(0, 2, 3))).flatten()
  d_lo = torch.nonzero((lower - whole[:, n:]).abs().amax(dim=(0, 2, 3))).flatten()
  return (int(d_lo.max()) + 1 if len(d_lo) else 0), (n - int(d_up.min()) if len(d_up) else 0)


TRANSFORMS = {
    "ElicAnalysis": (lambda: ElicAnalysis(3, channels=(8, 8, 8, 16)), 3, 256),
    "CNNAnalysis": (lambda: T.CNNAnalysis(3, 8), 3, 256),
    "BLS2017Analysis": (lambda: T.BLS2017Analysis(3, 8), 3, 256),
    "MBT2018Analysis": (lambda: T.MBT2018Analysis(3, 8), 3, 256),
    "TwoLayerResSynthesis": (lambda: T.TwoLayerResSynthesis(16), 16, 16),
    "TwoLayerResSynthesis d2s": (lambda: T.TwoLayerResSynthesis(16, res_type="d2s"), 16, 16),
    "TwoLayerSynthesis": (lambda: T.TwoLayerSynthesis(16, channels=(6, 3)), 16, 16),
    "JPEGLikeSynthesis k18": (lambda: T.JPEGLikeSynthesis(16, kernel_size=18), 16, 16),
    "BLS2017Synthesis": (lambda: T.BLS2017Synthesis(8, 8), 8, 16),
    "MBT2018Synthesis": (lambda: T.MBT2018Synthesis(8, 8), 8, 16),
    "CNNSynthesis": (lambda: T.CNNSynthesis(8, 8), 8, 16),
    "ElicSynthesis": (lambda: ElicSynthesis(16, channels=(16, 8, 8, 3)), 16, 16),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_row_halo_covers_what_a_strip_gets_wrong(name):
  """Every transform a split can run, seeded, float64: the rows a strip
  really computes wrong at a cut (measured) are at most row_halo's, and 3
  strips with row_halo's halo equal the whole."""
  make, c_in, rows = TRANSFORMS[name]
  transform = make()
  params_lib.load_params(transform, {k: v + 0.01 for k, v in
                                     params_lib.init_params(transform, 0).items()})
  transform = transform.double()
  x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, rows, 16, c_in)))
  top, bottom, rows_in, rows_out = mesh.row_halo(transform)
  with torch.no_grad():
    bad_top, bad_bottom = _bad_rows_measured(transform, x)
    split = mesh.HeightSplit(transform, ["cpu"] * 3)(x)
    whole = transform(x)
  assert -(-bad_top // rows_out) <= top and -(-bad_bottom // rows_out) <= bottom, (
      (bad_top, bad_bottom), (top, bottom))
  np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)


def test_row_halo_of_the_flagship():
  """The flagship's halos from its layers: ELIC's analysis needs 8 latent
  rows above a strip and 9 below (128 and 144 pixels), its two-layer
  synthesis 1 latent row each side."""
  port = models(SMALL_CONFIG, seed=0)[2]
  assert mesh.row_halo(port._analysis) == (8, 9, 16, 1)
  assert mesh.row_halo(port._synthesis) == (1, 1, 1, 16)
  assert mesh.strip_bounds(32, 3) == [(0, 10), (10, 21), (21, 32)]
  assert mesh.strip_bounds(2, 4) == [(0, 1), (1, 2)]


def test_row_halo_refuses_an_unknown_layer():
  """A transform with a leaf layer that row_layers does not know (a plain
  nn.Conv2d, 3 rows high, here) raises, and is not split on a halo that
  leaves the layer out."""
  transform = nn.Sequential(T.Conv(3, 8, 5, 2), T.GDN1(8), nn.Conv2d(8, 8, 3, padding=1))
  with pytest.raises(TypeError, match="Conv2d"):
    mesh.row_halo(transform)
  with pytest.raises(TypeError, match="Conv2d"):
    mesh.HeightSplit(transform, ["cpu"] * 2)
  assert mesh.row_halo(nn.Sequential(T.Conv(3, 8, 5, 2), T.GDN1(8))) == (1, 1, 2, 1)


def test_split_refuses_the_int8_paths(tiny, monkeypatch):
  monkeypatch.setenv("SNTC_INT8_ENCODE", "1")
  with pytest.raises(NotImplementedError, match="int8"):
    mesh.HeightSplit(tiny[2]._analysis, ["cpu"] * 2)(torch.zeros(1, 64, 32, 3))


# --- the codec ----------------------------------------------------------------------
FACTORIZED_SMALL = dict(
    scheduled_num_steps=20, rd_lambda=0.01,
    transform_config=dict(analysis=dict(cls="BLS2017Analysis", num_filters=8),
                          synthesis=dict(cls="BLS2017Synthesis", num_filters=8)))


@pytest.mark.parametrize("family", ["mshyper", "factorized"])
def test_split_and_unsplit_bitstreams_decode_across(family):
  """A 2-strip codec's bitstream decodes with the unsplit codec to the
  2-strip encoder's reconstruction bit for bit, and the reverse; the
  decoded latents are equal. 96x80 and 50x70 images (padded)."""
  if family == "mshyper":
    port = models(SMALL_CONFIG, seed=0)[2]
  else:
    port = models(FACTORIZED_SMALL, seed=0, family="factorized")[2]
  whole, split = api.make_codec(port), api.make_codec(port, devices=["cpu", "cpu"])
  for seed, hw in ((1, (96, 80)), (2, (50, 70))):
    x = images(seed, hw)
    for enc, dec in ((split, whole), (whole, split)):
      result = enc.compress(x)
      np.testing.assert_array_equal(dec.decompress(result.bitstring), result.reconstruction)
      np.testing.assert_array_equal(dec.decode_latent(result.bitstring)[2],
                                    enc.decode_latent(result.bitstring)[2])


# --- the CLIs -----------------------------------------------------------------------
def test_train_cli_parallel_flags():
  args, _ = cli.parse_args(["--config", SMOKE, "--dp_devices", "2"], "x", "", parallel=True)
  assert args.dp_devices == 2 and args.coordinator is None and args.dist_backend is None
  args, _ = cli.parse_args(["--config", SMOKE, "--coordinator", "127.0.0.1:1234",
                            "--num_processes", "2", "--process_id", "1", "--dist_backend",
                            "gloo"], "x", "", parallel=True)
  assert (args.coordinator, args.num_processes, args.process_id) == ("127.0.0.1:1234", 2, 1)
  for bad in (["--dp_devices", "2", "--coordinator", "127.0.0.1:1234", "--num_processes", "2",
               "--process_id", "0"],
              ["--coordinator", "127.0.0.1:1234"]):
    with pytest.raises(SystemExit):
      cli.parse_args(["--config", SMOKE] + bad, "x", "", parallel=True)
  with pytest.raises(SystemExit):  # the itinf CLIs take none of them
    cli.parse_args(["--config", SMOKE, "--dp_devices", "2"], "x", "")


def test_spatial_devices_needs_that_many_gpus(tmp_path):
  """--spatial_devices 2 of the eval and codec CLIs asks for cuda:0 and
  cuda:1, and raises where they are missing, as JAX's make_mesh asserts."""
  np.save(tmp_path / "img.npy", np.zeros((32, 32, 3), np.uint8))
  with pytest.raises(ValueError, match="spatial_devices=2"):
    eval_cli.main(["--config", "bls2017_rd", "--init_seed", "0", "--images",
                   str(tmp_path / "img.npy"), "--device", "cpu", "--spatial_devices", "2",
                   "--results_dir", str(tmp_path)])
  with pytest.raises(ValueError, match="spatial_devices=2"):
    compress_cli.main(["roundtrip", "--config", "bls2017_rd", "--init_seed", "0", "--input",
                       str(tmp_path / "img.npy"), "--device", "cpu", "--spatial_devices", "2"])
  assert mesh.spatial_device_list(1) is None


def test_compress_cli_pngs_of_a_bls2017_rd_workdir(tmp_path, monkeypatch):
  """bls2017_rd.py (8 filters) trained 2 steps by the experiment train CLI;
  the codec CLI compresses a PNG and decompresses to a PNG with --workdir
  alone (the family from config.json, no --config): the bytes are the
  in-process codec's, the PNG its reconstruction, and the symbols equal the
  JAX codec's on the checkpoint's params where y - offset lies farther than
  1e-4 from a .5 (the rest are counted), the blob within 0.5% of JAX's
  (tests/test_torch_codec.py)."""
  monkeypatch.setenv("SLURM_ARRAY_JOB_ID", "5151")
  monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "0")
  overrides = [("train_eval_config.num_steps", "2"),
               ("train_data_config.dataset", "synthetic"), ("train_data_config.batchsize", "2"),
               ("train_data_config.patchsize", "32"), ("val_data_config.dataset", "synthetic"),
               ("train_eval_config.max_validation_steps", "1"),
               ("model_config.transform_config.analysis.num_filters", "8"),
               ("model_config.transform_config.synthesis.num_filters", "8")]
  _, workdir = cli.run_train_main(
      "factorized", ["--config", BLS, "--hid", "0", "--experiments_dir", str(tmp_path / "xms"),
                     "--device", "cpu"] + [f"--config.{k}={v}" for k, v in overrides])
  from shallow_ntc_tpu_torch import data as data_lib

  img = np.random.default_rng(4).integers(0, 256, (56, 72, 3), dtype=np.uint8)
  data_lib.write_png(str(tmp_path / "img.png"), img)
  common = ["--workdir", workdir, "--device", "cpu"]
  compress_cli.main(["compress", "--input", str(tmp_path / "img.png"), "--output",
                     str(tmp_path / "img.sntc")] + common)
  compress_cli.main(["decompress", "--input", str(tmp_path / "img.sntc")] + common)
  blob = (tmp_path / "img.sntc").read_bytes()
  model, _ = eval_lib.load_latest_ckpt(workdir, device="cpu")
  codec = api.make_codec(model)
  x = img.astype(np.float32)[None] / 255.0 - 0.5
  result = codec.compress(x)
  assert blob == result.bitstring and api._unpack_header(blob)[:2] == (2, 0)
  np.testing.assert_array_equal(data_lib.read_png(str(tmp_path / "img.sntc.png")),
                                result.reconstruction)

  with open(os.path.join(workdir, "config.json")) as f:
    jax_model, _ = jax_train_lib.build_model_from_config(json.load(f)["model_config"],
                                                         "factorized")
  flat = {k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()}
  jax_codec = jax_api.FactorizedCodec(jax_model, jax.tree_util.tree_map(np.asarray, nest(flat)))
  (y_t,) = codec._fetch(codec._analyze(x))()
  y_j = np.asarray(jax.device_get(jax_codec._analyze(jax_codec.params, jnp.asarray(x))))
  pre_t, pre_j = y_t - codec.tables.offset, y_j - jax_codec.tables.offset
  safe = np.logical_and.reduce([np.abs(np.abs(v - np.floor(v)) - 0.5) > BOUNDARY
                                for v in (pre_t, pre_j)])
  print(f"y symbols near a boundary {np.count_nonzero(~safe)} of {safe.size}")
  np.testing.assert_array_equal(codec.tables.symbols_from_latent(y_t)[safe],
                                jax_codec.tables.symbols_from_latent(y_j)[safe])
  n_theirs = len(jax_codec.compress(x).bitstring)
  assert abs(len(blob) - n_theirs) <= 0.005 * n_theirs
