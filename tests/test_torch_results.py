"""The port's R-D result tools (shallow_ntc_tpu_torch/results.py and
scripts/torch_*.py) against the JAX package's scripts, on the CPU.

One small experiment: the flagship at narrow ELIC widths (configs'
"smoke" train config: ELIC (8, 8, 8, 16), synthesis (12, 3)) trained 2
steps by the port, 2 SGA steps warm-started from it by wid, and three
40x56 dead-leaves PNGs. The JAX scripts run unchanged on the port's
workdirs: their checkpoint loader (eval_lib.load_latest_ckpt) is replaced by
one that builds JAX's model from the workdir's config.json as JAX's does and
takes the port checkpoint's params across by their flax paths (params.py).
Each CLI of the port runs with --device cpu into a tmp dir.

Tolerances: eval metrics and the likelihood bpp rtol 1e-5 (one f32 forward
on the same params; the eval parity tests hold 1e-3 only because they
start from separately computed latents), MS-SSIM atol 1e-5 (in [0, 1]) and
its dB atol 1e-4 (that error, amplified by 4.3 / (1 - MS-SSIM)); the
int8 arms rtol 1e-4 on bpp, PSNR and rd_loss as tests/test_torch_int8.py;
the basis functions atol 1e-4 (tests/torch_parity's transform bound); the
codec's real bytes and the SGA records exactly.
"""

import copy
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from shallow_ntc_tpu import eval_lib as jax_eval_lib
from shallow_ntc_tpu import train_lib as jax_train_lib
from shallow_ntc_tpu.codec import api as jax_codec_api
from shallow_ntc_tpu.utils import jax_setup
from shallow_ntc_tpu_torch import configs
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import deadleaves
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import itinf_lib
from shallow_ntc_tpu_torch import results
from shallow_ntc_tpu_torch import train_lib
from tests.torch_parity import nest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XID, WID, SGA_XID = "4242", "3", "5151"
TRAIN_STEPS, SGA_STEPS = 2, 2
RUNNAME = f"mshyper-lmbda=0.01-num_steps={TRAIN_STEPS}"
RTOL = 1e-5


def _script(name):
  """The module of scripts/<name>.py."""
  spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                os.path.join(REPO, "scripts", f"{name}.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _load(path):
  with open(path) as f:
    return json.load(f)


@pytest.fixture(scope="module")
def rd(tmp_path_factory):
  """The trained work unit, its SGA workdir and the eval PNGs."""
  tmp = tmp_path_factory.mktemp("results")
  for i in range(3):
    data_lib.write_png(str(tmp / "eval" / f"dle{i:03d}.png"),
                       deadleaves.deadleaves_image(900000 + i, 40, 56))
  workdir = str(tmp / "xms" / XID / f"wid={WID}-{RUNNAME}")
  train_lib.train_and_eval(configs.TRAIN_CONFIGS["smoke"], workdir, device="cpu",
                           num_steps=TRAIN_STEPS)
  itinf_cfg = copy.deepcopy(configs.ITINF)
  itinf_cfg["model_config"].pop("transform_config")  # the checkpoint's
  itinf_cfg["data_config"] = dict(dataset=str(tmp / "eval" / "*.png"), batchsize=1,
                                  patchsize=None)
  itinf_cfg["train_eval_config"].update(
      num_steps=SGA_STEPS, log_metrics_every_steps=1, eval_every_steps=SGA_STEPS,
      transforms_dtype="float32", warm_start_exp_dir=os.path.dirname(workdir),
      warm_start_wid=int(WID))
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("SLURM_ARRAY_JOB_ID", SGA_XID)
    mp.setenv("SLURM_ARRAY_TASK_ID", WID)
    itinf_wd, sga = itinf_lib.itinf_eval_experiment(
        itinf_cfg, "mshyper", str(tmp / "ixms"), "mshyper-wwid=3-uq=sga", device="cpu")
  return dict(tmp=tmp, workdir=workdir, itinf=itinf_wd, sga=sga,
              pngs=str(tmp / "eval" / "*.png"))


@pytest.fixture
def jax_reads_port_workdirs(monkeypatch):
  """JAX's load_latest_ckpt on a port workdir: JAX's model of its config.json
  (build_model_from_config, update_model_config laid over), the params of the
  port's newest checkpoint by their flax paths. JAX's process setup (its
  compilation cache under $HOME) is left out."""
  def load_latest_ckpt(workdir, model_family=None, update_model_config=None, model_cls=None,
                       transforms_dtype=None):
    config = _load(os.path.join(workdir, "config.json"))
    model_config = copy.deepcopy(config["model_config"])
    if update_model_config:
      model_config = eval_lib._deep_update(model_config, copy.deepcopy(dict(update_model_config)))
    family = model_family or config.get("model_family", "mshyper")
    model, _ = jax_train_lib.build_model_from_config(model_config, family,
                                                     dtype=transforms_dtype)
    payload = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(workdir))
    params = nest({k.replace(".", "/"): v.numpy() for k, v in payload["model"].items()})
    config.update(model_config=model_config, _restored_step=int(payload["step"]))
    return model, params, config

  monkeypatch.setattr(jax_eval_lib, "load_latest_ckpt", load_latest_ckpt)
  monkeypatch.setattr(jax_setup, "setup_jax", lambda **kwargs: None)
  return load_latest_ckpt


def _atol(key):
  """MS-SSIM atol 1e-5, so its dB (-10 log10(1 - msssim)) 1e-4; 0 elsewhere."""
  if key.startswith("msssim_db"):
    return 1e-4
  return 1e-5 if key.startswith("msssim") else 0.0


def _close(got, ref, msg=""):
  """Record values: numbers rtol 1e-5 or _atol, others equal."""
  assert set(got) == set(ref), msg
  for k, v in ref.items():
    if isinstance(v, float):
      np.testing.assert_allclose(got[k], v, rtol=0 if _atol(k) else RTOL, atol=_atol(k),
                                 err_msg=f"{msg} {k}")
    else:
      assert got[k] == v, f"{msg} {k}"


@pytest.mark.parametrize("warm_start", ["experiment", "workdir"])
def test_itinf_records_equal_jax_convert_workdir(rd, warm_start, tmp_path):
  """The SGA workdir as eval-style records: file name and records equal to
  scripts/itinf_to_results.py's convert_workdir, with warm_start_exp_dir the
  experiment (lambda through the work unit wid=3) or the workdir itself;
  then the port's CLI over a glob writes the same file."""
  itinf = rd["itinf"]
  if warm_start == "workdir":
    itinf = str(tmp_path / "ixms" / SGA_XID / os.path.basename(rd["itinf"]))
    shutil.copytree(rd["itinf"], itinf)
    cfg = _load(os.path.join(itinf, "config.json"))
    cfg["train_eval_config"]["warm_start_exp_dir"] = rd["workdir"]
    with open(os.path.join(itinf, "config.json"), "w") as f:
      json.dump(cfg, f)
  ref_path = _script("itinf_to_results").convert_workdir(itinf, str(tmp_path / "jax"))
  name, records = results.itinf_workdir_to_records(itinf)
  assert name == os.path.basename(ref_path) == f"mshyper+sga-lmbda=0.01-step={SGA_STEPS}-xid={SGA_XID}.json"
  assert records == _load(ref_path)
  assert [r["instance_id"] for r in records] == [0, 1, 2]
  assert all(r["num_images"] == 1 and r["lmbda"] == "0.01" for r in records)
  paths = _script("torch_itinf_to_results").main(
      ["--itinf_glob", os.path.join(os.path.dirname(itinf), "*"), "--out", str(tmp_path / "port")])
  assert [os.path.basename(p) for p in paths] == [name] and _load(paths[0]) == records


def test_aggregate_of_the_port_jsons_equals_jax(rd, jax_reads_port_workdirs, tmp_path, monkeypatch):
  """The port's eval JSON (eval_lib.eval_workdir) and SGA JSON through
  scripts/aggregate_results.py, against JAX's eval_workdir of the same
  workdir and JAX's convert_workdir: the same methods, lambdas and image
  counts, every metric within rtol 1e-5; collect_train_curves.py takes the
  port's train/record.jsonl."""
  runs = {}
  for side in ("port", "jax"):
    out = tmp_path / side
    if side == "port":
      eval_lib.eval_workdir(rd["workdir"], data_lib.get_dataset(rd["pngs"], "test", 1, None),
                            rd["pngs"], str(out / "json"), device="cpu")
      results.convert_itinf_workdir(rd["itinf"], str(out / "json"))
    else:
      from shallow_ntc_tpu import data as jax_data

      jax_eval_lib.eval_workdir(rd["workdir"], jax_data.get_dataset(rd["pngs"], "test", 1, None),
                                rd["pngs"], str(out / "json"))
      _script("itinf_to_results").convert_workdir(rd["itinf"], str(out / "json"))
    assert sorted(os.listdir(out / "json")) == [
        f"mshyper+sga-lmbda=0.01-step={SGA_STEPS}-xid={SGA_XID}.json",
        f"{RUNNAME}-step={TRAIN_STEPS}-xid={XID}.json"]
    monkeypatch.setattr(sys, "argv", ["aggregate_results.py", "--results_glob",
                                      str(out / "json" / "*.json"), "--out", str(out / "agg")])
    _script("aggregate_results").main()
    runs[side] = _load(out / "agg" / "aggregate.json")
    assert sorted(os.listdir(out / "agg")) == ["aggregate.json", "mshyper+sga-detailed.json",
                                               "mshyper-detailed.json"]
  port, ref = runs["port"], runs["jax"]
  assert set(port) == set(ref) == {"mshyper", "mshyper+sga"}
  for method in ref:
    assert port[method]["rd_lambda"] == ref[method]["rd_lambda"] == [0.01]
    assert port[method]["num_images"] == ref[method]["num_images"] == [3]
    assert set(port[method]) == set(ref[method])
    for k, v in ref[method].items():
      np.testing.assert_allclose(port[method][k], v, rtol=RTOL, atol=_atol(k),
                                 err_msg=f"{method} {k}")

  out = tmp_path / "curves.json"
  monkeypatch.setattr(sys, "argv", ["collect_train_curves.py", "--workdirs_glob",
                                    os.path.join(os.path.dirname(rd["workdir"]), "*"),
                                    "--out", str(out), "--every", "1"])
  _script("collect_train_curves").main()
  with open(os.path.join(rd["workdir"], "train", "record.jsonl")) as f:
    rows = [json.loads(line) for line in f]
  (curve,) = _load(out)
  assert curve["runname"] == os.path.basename(rd["workdir"])
  assert [p["step"] for p in curve["points"]] == [r["step"] for r in rows] != []
  assert all(p["rd_loss"] == round(r["rd_loss"], 5) for p, r in zip(curve["points"], rows))


def test_codec_overhead_matches_jax(rd, jax_reads_port_workdirs, tmp_path):
  """The port's CLI (--device cpu) against scripts/measure_codec_overhead.py
  (--cpu) on 2 images: the real bytes equal, the likelihood bpp and PSNR
  within rtol 1e-5 (overhead_pct follows from them), every round trip
  lossless; the gap's framing and flush add up to JAX's
  fixed_overhead_bytes of JAX's bitstream."""
  port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
  argv = ["--workdir", rd["workdir"], "--dataset", rd["pngs"], "--max_images", "2"]
  _script("torch_measure_codec_overhead").main(argv + ["--device", "cpu", "--out",
                                                       str(port_out)])
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(sys, "argv", ["measure_codec_overhead.py", *argv, "--cpu", "--out", str(jax_out)])
    _script("measure_codec_overhead").main()
  port, ref = _load(port_out), _load(jax_out)
  assert set(port) - set(ref) == {"mean_header_bpp", "mean_flush_bpp", "mean_coding_bpp"}
  assert port["all_lossless"] and ref["all_lossless"] and len(port["per_image"]) == 2
  model, params, _ = jax_reads_port_workdirs(rd["workdir"])
  codec = jax_codec_api.make_codec(model, params)
  for row, ref_row, img in zip(port["per_image"], ref["per_image"],
                               data_lib.get_dataset(rd["pngs"], "test", 1, None)):
    assert set(row) - set(ref_row) == {"flush_bpp", "coding_bpp", "real_bytes",
                                       "likelihood_latent_bpp"}
    assert (row["instance_id"], row["h"], row["w"]) == (ref_row["instance_id"], 40, 56)
    assert row["real_bpp"] == ref_row["real_bpp"] and row["roundtrip_lossless"]
    for k in ("likelihood_bpp", "psnr"):
      np.testing.assert_allclose(row[k], ref_row[k], rtol=RTOL, err_msg=k)
    # overhead_pct amplifies the likelihood's error by real / (real - like).
    np.testing.assert_allclose(
        row["overhead_pct"], 100.0 * (row["real_bpp"] / row["likelihood_bpp"] - 1.0), rtol=1e-9)
    blob = codec.compress(img[0]).bitstring
    fixed = jax_codec_api.fixed_overhead_bytes(jax_codec_api.stream_counts(blob))
    assert len(blob) == row["real_bytes"]
    np.testing.assert_allclose(row["header_bpp"] + row["flush_bpp"], 8.0 * fixed / (40 * 56),
                               rtol=1e-12)
    np.testing.assert_allclose(row["header_bpp"] + row["flush_bpp"] + row["coding_bpp"],
                               row["real_bpp"] - row["likelihood_bpp"], rtol=1e-9, atol=1e-12)
  np.testing.assert_allclose(port["mean_likelihood_bpp"], ref["mean_likelihood_bpp"], rtol=RTOL)
  assert port["mean_real_bpp"] == ref["mean_real_bpp"]


def test_int8_quality_matches_jax(rd, jax_reads_port_workdirs, tmp_path, monkeypatch):
  """The port's CLI (--device cpu) against scripts/int8_quality.py on the
  same 3 images: the float, int8_syn and int8_all arms (JAX's also runs its
  encode arms) per image within tests/test_torch_int8.py's rtol 1e-4 on bpp,
  PSNR and rd_loss, MS-SSIM atol 1e-5; int8_syn's rate is the float
  path's exactly."""
  for gate in ("SNTC_INT8_DECODE", "SNTC_INT8_ENCODE"):  # the JAX script sets them
    monkeypatch.setenv(gate, "")
  port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
  port = _script("torch_int8_quality").main(["--workdir", rd["workdir"], "--dataset", rd["pngs"],
                                             "--out", str(port_out), "--device", "cpu"])
  assert _load(port_out) == json.loads(json.dumps(port))
  monkeypatch.setattr(sys, "argv", ["int8_quality.py", "--workdir", rd["workdir"], "--dataset",
                                    rd["pngs"], "--out", str(jax_out)])
  _script("int8_quality").main()
  ref = _load(jax_out)
  assert port["num_images"] == ref["num_images"] == 3
  assert set(port) == set(ref)
  assert all(set(arms) == {"f32", "syn", "syn_delta", "all", "all_delta"}
             for arms in port["summary"].values())
  assert port["summary"]["bpp"]["syn_delta"] == 0.0
  for row, ref_row in zip(port["per_image"], ref["per_image"]):
    assert set(row) <= set(ref_row) and len(row) == 12
    for k, v in row.items():
      if "msssim" in k:
        np.testing.assert_allclose(v, ref_row[k], atol=1e-5, err_msg=k)
      else:
        np.testing.assert_allclose(v, ref_row[k], rtol=1e-4, err_msg=k)
    assert row["syn_bpp"] == row["f32_bpp"] and row["all_psnr"] != row["f32_psnr"]


def test_synthesis_basis_matches_jax(rd, jax_reads_port_workdirs, tmp_path, monkeypatch):
  """The basis functions g(e_i) - g(0) of the port's CLI (--device cpu,
  --save_basis) against JAX's synthesis of the same impulses within 1e-4,
  and its PNG against scripts/vis_syn_filters.py's within one grey level
  (the 0..255 scaling truncates)."""
  import jax.numpy as jnp

  from shallow_ntc_tpu.models import mshyper as jax_mshyper

  port_png, jax_png, npy = tmp_path / "port.png", tmp_path / "jax.png", tmp_path / "basis.npy"
  basis = _script("torch_vis_syn_filters").main(
      ["--workdir", rd["workdir"], "--out", str(port_png), "--num", "12", "--scale", "8",
       "--save_basis", str(npy), "--device", "cpu"])
  np.testing.assert_array_equal(np.load(npy), basis)
  assert basis.shape == (12, 48, 48, 3)  # 16 channels, 12 asked; 3 latent pixels of 16
  model, params, _ = jax_reads_port_workdirs(rd["workdir"])
  zeros = jnp.zeros((1, 8, 8, 16), jnp.float32)
  synth = lambda v: np.asarray(model.apply(  # noqa: E731
      {"params": params}, v, method=jax_mshyper.Model.synthesize))
  g0 = synth(zeros)
  ref = np.stack([(synth(zeros.at[0, 4, 4, i].set(8.0)) - g0)[0, 40:88, 40:88]
                  for i in range(12)])
  np.testing.assert_allclose(basis, ref, rtol=0, atol=1e-4)
  monkeypatch.setattr(sys, "argv", ["vis_syn_filters.py", "--workdir", rd["workdir"], "--out",
                                    str(jax_png), "--num", "12"])
  _script("vis_syn_filters").main()
  got, want = data_lib.read_png(str(port_png)), data_lib.read_png(str(jax_png))
  assert got.shape == want.shape == (3 * 48, 4 * 48, 3)
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_recompute_itinf_metrics_matches_jax(rd, jax_reads_port_workdirs, tmp_path, monkeypatch):
  """The saved SGA latents evaluated again: the port's CLI (--device cpu) on
  one copy of the SGA workdir equals the SGA's own last val pass (float32
  transforms, same device) bit for bit, and scripts/recompute_itinf_metrics.py
  on another copy within rtol 1e-5 (MS-SSIM atol 1e-5); each rewrites the
  per-batch metrics.json's val section."""
  copies = {}
  for side in ("port", "jax"):
    copies[side] = str(tmp_path / side / SGA_XID / os.path.basename(rd["itinf"]))
    shutil.copytree(rd["itinf"], copies[side])
    # Stale values, which each side rewrites.
    with open(os.path.join(copies[side], "metrics.json"), "w") as f:
      json.dump([], f)
    with open(os.path.join(copies[side], "batch_id=0", "metrics.json"), "w") as f:
      json.dump({"train": {}, "val": {}}, f)
  out = _script("torch_recompute_itinf_metrics").main(
      ["--itinf_glob", os.path.join(tmp_path, "port", SGA_XID, "*"), "--device", "cpu"])
  port = out[copies["port"]]
  assert port == rd["sga"] == _load(os.path.join(copies["port"], "metrics.json"))
  assert _load(os.path.join(copies["port"], "batch_id=0", "metrics.json"))["val"] == {
      k: v for k, v in port[0].items() if k != "batch_id"}
  monkeypatch.setattr(sys, "argv", ["recompute_itinf_metrics.py", "--itinf_glob",
                                    os.path.join(tmp_path, "jax", SGA_XID, "*")])
  _script("recompute_itinf_metrics").main()
  ref = _load(os.path.join(copies["jax"], "metrics.json"))
  assert [m["batch_id"] for m in ref] == [m["batch_id"] for m in port] == [0, 1, 2]
  for got, want in zip(port, ref):
    _close(got, want, f"batch {want['batch_id']}")
  assert _load(os.path.join(copies["jax"], "batch_id=1", "metrics.json"))["val"].keys() == {
      k for k in port[1] if k != "batch_id"}


# The measurement CLIs (shallow_ntc_tpu_torch/measure.py) and whether each takes --workdir.
MEASURE_CLIS = {"torch_spatial_codec_e2e": True, "torch_codec_latency": True,
                "torch_codec_e2e_bench": True, "torch_itinf_bench": True,
                "torch_bench_suite": False, "torch_encode_roofline": False}


@pytest.mark.parametrize("name", ["torch_measure_codec_overhead", "torch_int8_quality",
                                  "torch_vis_syn_filters", "torch_recompute_itinf_metrics",
                                  *MEASURE_CLIS])
def test_clis_default_to_the_card(rd, name, tmp_path, monkeypatch):
  """Without --device each CLI runs on CUDA, so here it raises."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  arg = (["--itinf_glob", os.path.join(os.path.dirname(rd["itinf"]), "*")]
         if name == "torch_recompute_itinf_metrics" else ["--workdir", rd["workdir"]])
  if name in MEASURE_CLIS:
    arg = (arg if MEASURE_CLIS[name] else []) + ["--out", str(tmp_path / "x.json")]
  elif name == "torch_vis_syn_filters":
    arg += ["--out", str(tmp_path / "x.png")]
  elif name == "torch_int8_quality":
    arg += ["--out", str(tmp_path / "x.json"), "--dataset", rd["pngs"]]
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    _script(name).main(arg)


def test_itinf_to_results_cli_refuses_an_empty_glob(tmp_path):
  with pytest.raises(SystemExit, match="No itinf workdirs"):
    _script("torch_itinf_to_results").main(["--itinf_glob", str(tmp_path / "*"), "--out",
                                            str(tmp_path / "out")])


def test_counted_runner_writes_the_launch_counts(rd, tmp_path):
  """shallow_ntc_tpu_torch.utils.counted runs a script as `python` does and
  writes the kernels' launch counts at its end; SIGTERM (how
  scripts/torch_rd_run.py stops a training run) exits 143 with the counts
  written."""
  import signal
  import subprocess

  env = dict(os.environ, PYTHONPATH=REPO)
  counted = [sys.executable, "-m", "shallow_ntc_tpu_torch.utils.counted"]
  proc = subprocess.run(
      [*counted, str(tmp_path / "a.json"), os.path.join(REPO, "scripts", "torch_itinf_to_results.py"),
       "--itinf_glob", os.path.join(os.path.dirname(rd["itinf"]), "*"), "--out",
       str(tmp_path / "out")], env=env, capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  zeros = {"final_deconv_phase": 0, "fused_rb_chain": 0, "fused_resblock": 0,
           "jpegl_synthesize": 0}
  assert _load(tmp_path / "a.json") == zeros and len(os.listdir(tmp_path / "out")) == 1
  (tmp_path / "sleeper.py").write_text("import time\nprint('ready', flush=True)\ntime.sleep(300)\n")
  with subprocess.Popen([*counted, str(tmp_path / "b.json"), str(tmp_path / "sleeper.py")],
                        env=env, stdout=subprocess.PIPE, text=True) as proc:
    assert proc.stdout.readline().strip() == "ready"
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=120) == 143
  assert _load(tmp_path / "b.json") == zeros
