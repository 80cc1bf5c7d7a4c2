"""The port's experiment workflow on the CPU, held to the JAX package's
layout: the train CLI of a config script with --hid and dot overrides, the
itinf CLI warm-started from that experiment by wid, eval --workdir on a
PNG glob (with --profile), warm-started training, a factorized workdir, and
the launchers (smoke.py and bls2017_rd.py at small sizes).

The JAX side is read without running a JAX training: its resolved config
and run name come from its CLI's config flags (tests/test_torch_config.py),
its result-file hparams from its parse_runname.
"""

import glob
import importlib.util
import json
import os
import shutil
import socket

import numpy as np
import pytest
import torch
from PIL import Image

from shallow_ntc_tpu.utils import runname as jax_runname
from shallow_ntc_tpu_torch import data as data_lib
from shallow_ntc_tpu_torch import eval as eval_cli
from shallow_ntc_tpu_torch import eval_lib
from shallow_ntc_tpu_torch import itinf_lib
from shallow_ntc_tpu_torch import launch
from shallow_ntc_tpu_torch import launch_eval
from shallow_ntc_tpu_torch import project_configs
from shallow_ntc_tpu_torch import slurm_template
from shallow_ntc_tpu_torch import train_lib
from shallow_ntc_tpu_torch.utils import cli
from shallow_ntc_tpu_torch.utils import config as config_lib
from tests.test_torch_config import jax_resolve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = "shallow_ntc_tpu_torch/mshyper/configs/smoke.py"
JAX_SMOKE = "shallow_ntc_tpu/mshyper/configs/smoke.py"
ITINF = "shallow_ntc_tpu_torch/mshyper/configs/itinf.py"
JAX_ITINF = "shallow_ntc_tpu/mshyper/configs/itinf.py"
BLS = "shallow_ntc_tpu_torch/factorized/configs/bls2017_rd.py"
TRAIN_OVERRIDES = [("train_eval_config.num_steps", "2")]
XID, WID = "4242", "1"


def _json_normal(obj):
  return json.loads(json.dumps(obj))


def _decoy_work_unit(workdir, wid):
  """A work unit wid=<wid>-decoy beside `workdir` in its experiment: its
  config, and its newest checkpoint with every float param shifted by 1, the
  params that a warm start by the wrong wid would find."""
  decoy = os.path.join(os.path.dirname(workdir), f"wid={wid}-decoy")
  os.makedirs(train_lib.checkpoint_dir(decoy))
  shutil.copy(os.path.join(workdir, "config.json"), decoy)
  payload = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(workdir))
  payload["model"] = {k: v + 1 if v.is_floating_point() else v
                      for k, v in payload["model"].items()}
  torch.save(payload, os.path.join(train_lib.checkpoint_dir(decoy), f"ckpt_{payload['step']}.pt"))
  return decoy


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
  """One smoke.py work unit (hid 1) trained for 2 steps under SLURM ids,
  a decoy work unit wid=0 beside it, and two PNGs to evaluate on."""
  tmp = tmp_path_factory.mktemp("workflow")
  rng = np.random.default_rng(0)
  for i, (h, w) in enumerate([(64, 96), (64, 64)]):
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp / f"im{i}.png")
  argv = ["--config", SMOKE, "--hid", WID, "--experiments_dir", str(tmp / "xms"),
          "--device", "cpu"] + [f"--config.{k}={v}" for k, v in TRAIN_OVERRIDES]
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv("SLURM_ARRAY_JOB_ID", XID)
    mp.setenv("SLURM_ARRAY_TASK_ID", WID)
    state, workdir = cli.run_train_main("mshyper", argv)
  return dict(tmp=tmp, state=state, workdir=workdir, decoy=_decoy_work_unit(workdir, 0),
              pngs=str(tmp / "im*.png"))


def test_train_cli_writes_the_jax_experiment_layout(experiment):
  ref_cfg, ref_name = jax_resolve(JAX_SMOKE, TRAIN_OVERRIDES, int(WID), "mshyper")
  workdir = experiment["workdir"]
  assert workdir == os.path.join(str(experiment["tmp"] / "xms"), XID, f"wid={WID}-{ref_name}")
  assert experiment["state"].step == 2
  with open(os.path.join(workdir, "config.json")) as f:
    got = json.load(f)
  assert got.pop("config_filename") == SMOKE and ref_cfg.pop("config_filename") == JAX_SMOKE
  assert got == _json_normal(ref_cfg)
  with open(os.path.join(workdir, "run_info.json")) as f:
    run_info = json.load(f)
  assert set(run_info) == {"cmdline", "most_recent_version", "host_name", "SLURM_ARRAY_JOB_ID"}
  assert run_info["SLURM_ARRAY_JOB_ID"] == XID
  for name in ("smoke.py", "mshyper.py", "factorized.py", "train/record.jsonl",
               "val/record.jsonl", "train/checkpoints/ckpt_2.pt"):
    assert os.path.isfile(os.path.join(workdir, name)), name


def test_itinf_cli_warm_starts_by_wid(experiment, monkeypatch):
  """The itinf CLI finds work unit wid=1 under the experiment directory (not
  the decoy wid=0) and runs SGA with its checkpoint's params exactly, bf16
  transforms and the config's SGA relaxation; it writes the JAX itinf's
  artifacts, and the digest of the params it started from."""
  seen = []
  run = itinf_lib.itinf_eval

  def spy(model, *args, **kwargs):
    seen.append({k: v.clone() for k, v in model.state_dict().items()})
    seen.append(model)
    return run(model, *args, **kwargs)

  monkeypatch.setattr(itinf_lib, "itinf_eval", spy)
  monkeypatch.setenv("SLURM_ARRAY_JOB_ID", "5151")
  monkeypatch.setenv("SLURM_ARRAY_TASK_ID", WID)
  overrides = [("train_eval_config.warm_start_exp_dir",
                os.path.dirname(experiment["workdir"])),
               ("train_eval_config.num_steps", "2"),
               ("train_eval_config.log_metrics_every_steps", "1"),
               ("data_config.dataset", experiment["pngs"])]
  workdir, metrics = cli.run_itinf_main(
      "mshyper", ["--config", ITINF, "--hid", WID, "--experiments_dir",
                  str(experiment["tmp"] / "ixms"), "--device", "cpu"]
      + [f"--config.{k}={v}" for k, v in overrides])
  ref_cfg, ref_name = jax_resolve(JAX_ITINF, overrides, int(WID), "mshyper")
  assert workdir == os.path.join(str(experiment["tmp"] / "ixms"), "5151", f"wid={WID}-{ref_name}")
  with open(os.path.join(workdir, "config.json")) as f:
    got = json.load(f)
  got.pop("config_filename"), ref_cfg.pop("config_filename")
  assert got == _json_normal(ref_cfg)
  params, model = seen
  ckpt = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(experiment["workdir"]))
  assert ckpt["step"] == 2 and params.keys() == ckpt["model"].keys()
  for k, v in ckpt["model"].items():
    assert torch.equal(params[k], v), k
  assert model.transforms_dtype == torch.bfloat16 and not model.offset_heuristic
  with open(os.path.join(workdir, "warm_start.json")) as f:
    warm = json.load(f)
  decoy = train_lib.load_newest_checkpoint(train_lib.checkpoint_dir(experiment["decoy"]))
  assert warm["warm_start_wid"] == int(WID) and warm["step"] == 2
  assert warm["params_sha256"] == train_lib.params_digest(ckpt["model"])
  assert warm["params_sha256"] != train_lib.params_digest(decoy["model"])
  assert [m["batch_id"] for m in metrics] == [0, 1]
  for name in ("metrics.json", "run_info.json", "itinf.py", "warm_start.json",
               "batch_id=0/metrics.json",
               "batch_id=0/itinf_vars.npz", "batch_id=1/train/record.jsonl",
               "batch_id=1/val/record.jsonl"):
    assert os.path.isfile(os.path.join(workdir, name)), name
  with np.load(os.path.join(workdir, "batch_id=0", "itinf_vars.npz")) as npz:
    assert set(npz.files) == {"uq_0_loc", "uq_1_loc"}


def test_eval_workdir_writes_the_jax_results(experiment, tmp_path):
  workdir = experiment["workdir"]
  wu_name = os.path.basename(workdir)
  runname = wu_name.split("-", 1)[1]
  path = eval_cli.main(["--workdir", workdir, "--dataset", experiment["pngs"], "--device", "cpu",
                        "--results_dir", str(tmp_path / "res")])
  assert os.path.basename(path) == f"{runname}-step=2-xid={XID}.json"
  with open(path) as f:
    records = json.load(f)
  cfg = config_lib.resolve_config(SMOKE, TRAIN_OVERRIDES, int(WID))
  model = train_lib.model_from_checkpoint(workdir, cfg["model_config"], "cpu", "mshyper")
  ref = list(eval_lib.evaluate_images(
      model, data_lib.get_dataset(experiment["pngs"], "test", 1, None), step=2))
  hparams = dict(jax_runname.parse_runname(wu_name))
  assert hparams == {"wid": WID, "lmbda": "0.08", "uq": "unoise"}
  assert records == [dict(r, instance_id=i, **hparams) for i, r in enumerate(ref)]
  argv = ["--workdir", workdir, "--dataset", experiment["pngs"], "--device", "cpu",
          "--results_dir", str(tmp_path / "res")]
  os.utime(path, ns=(0, 0))
  assert eval_cli.main(argv) == path
  assert os.stat(path).st_mtime_ns == 0  # --skip_existing (the default) keeps it
  assert eval_cli.main(argv + ["--noskip_existing"]) == path
  assert os.stat(path).st_mtime_ns > 0 and json.load(open(path)) == records

  prof = eval_cli.main(["--workdir", workdir, "--dataset", experiment["pngs"], "--device", "cpu",
                        "--results_dir", str(tmp_path / "prof"), "--profile"])
  sub = os.path.join("profile", f"device=cpu-host={socket.gethostname()}")
  assert prof == os.path.join(str(tmp_path / "prof"), sub, os.path.basename(path))
  link = os.path.join(str(tmp_path / "prof"), os.path.basename(path))
  assert os.path.islink(link) and os.readlink(link) == os.path.join(sub, os.path.basename(path))
  with open(link) as f:
    timed = json.load(f)
  times = ("analysis_time", "hyper_synthesis_time", "synthesis_time")
  for rec, plain in zip(timed, records):
    assert all(rec[k] > 0 for k in times)
    assert {k: v for k, v in rec.items() if k not in times} == plain


def test_eval_models_path_and_workdir_lookup(experiment, tmp_path):
  """--models_path builds the workdir's model from the file's `Model` class
  (here the family's, subclassed), with the same records; a work unit is
  found by wid, as the workdir itself, or as an experiment's only workdir,
  as JAX's find_workdir_by_wid does."""
  workdir = experiment["workdir"]
  models_file = tmp_path / "my_models.py"
  models_file.write_text("from shallow_ntc_tpu_torch.models import mshyper\n\n\n"
                         "class Model(mshyper.Model):\n  pass\n")
  model_cls = eval_lib.load_model_class(str(models_file))
  model, cfg = eval_lib.load_latest_ckpt(workdir, model_cls=model_cls, device="cpu")
  assert type(model) is model_cls and cfg["_restored_step"] == 2
  argv = ["--workdir", workdir, "--dataset", experiment["pngs"], "--device", "cpu"]
  plain = eval_cli.main(argv + ["--results_dir", str(tmp_path / "plain")])
  custom = eval_cli.main(argv + ["--results_dir", str(tmp_path / "custom"),
                                 "--models_path", str(models_file)])
  assert json.load(open(custom)) == json.load(open(plain))

  exp_dir = os.path.dirname(workdir)
  assert eval_lib.find_workdir_by_wid(exp_dir, WID) == workdir
  assert eval_lib.find_workdir_by_wid(exp_dir, 0) == experiment["decoy"]
  assert eval_lib.find_workdir_by_wid(workdir, WID) == workdir
  lone = tmp_path / "lone"
  os.makedirs(lone / "run-a" / "train" / "checkpoints")
  assert eval_lib.find_workdir_by_wid(str(lone), 3) == str(lone / "run-a")
  os.makedirs(lone / "run-b" / "train" / "checkpoints")
  with pytest.raises(FileNotFoundError):
    eval_lib.find_workdir_by_wid(str(lone), 3)


def test_training_warm_starts_from_an_experiment(experiment, tmp_path, monkeypatch):
  """train_eval_config.warm_start (+ warm_start_wid) restores the params and
  step of the experiment's work unit, with a fresh optimizer; an existing
  checkpoint of the run itself takes precedence."""
  monkeypatch.delenv("SLURM_ARRAY_JOB_ID", raising=False)
  monkeypatch.delenv("SLURM_JOB_ID", raising=False)
  monkeypatch.delenv("SLURM_ARRAY_TASK_ID", raising=False)
  exp_dir = os.path.dirname(experiment["workdir"])
  ckpt_dir = train_lib.checkpoint_dir(experiment["workdir"])
  assert train_lib.resolve_warm_start_dir(exp_dir, WID) == ckpt_dir
  assert train_lib.resolve_warm_start_dir(experiment["workdir"]) == ckpt_dir
  assert train_lib.resolve_warm_start_dir(ckpt_dir) == ckpt_dir
  assert train_lib.resolve_warm_start_dir("") is None
  with pytest.raises(FileNotFoundError):
    train_lib.resolve_warm_start_dir(exp_dir, 7)
  ckpt = train_lib.load_newest_checkpoint(ckpt_dir)

  def run(num_steps, name):
    cfg = config_lib.resolve_config(SMOKE, [("train_eval_config.num_steps", str(num_steps))],
                                    int(WID))
    cfg["train_eval_config"].update(warm_start=exp_dir, warm_start_wid=WID)
    return train_lib.train_and_eval_experiment(cfg, "mshyper", str(tmp_path / "ws"), name,
                                               device="cpu")

  state, workdir = run(2, "mshyper-restored")
  assert os.path.dirname(os.path.dirname(workdir)) == str(tmp_path / "ws")
  assert state.step == 2 and state.optimizer.count == 0
  for k, v in state.model.state_dict().items():
    assert torch.equal(v, ckpt["model"][k]), k
  state, workdir = run(3, "mshyper-continued")
  assert state.step == 3 and state.optimizer.count == 1
  with open(os.path.join(workdir, "train", "record.jsonl")) as f:
    assert [json.loads(line)["step"] for line in f] == [3]
  assert not all(torch.equal(v, ckpt["model"][k]) for k, v in state.model.state_dict().items())
  state, _ = run(3, "mshyper-continued")  # its own checkpoint, not the warm start
  assert state.step == 3


def test_factorized_workdir_infers_its_family(experiment, tmp_path, monkeypatch):
  monkeypatch.setenv("SLURM_ARRAY_JOB_ID", "7373")
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
  assert os.path.basename(workdir) == "wid=0-factorized-lmbda=0.00125-num_steps=2"
  config = json.load(open(os.path.join(workdir, "config.json")))
  assert eval_lib.infer_model_family(workdir, config) == "factorized"
  config.pop("model_family")
  assert eval_lib.infer_model_family(workdir, config) == "factorized"  # by the run name
  model, cfg = eval_lib.load_latest_ckpt(workdir, device="cpu")
  assert type(model).__module__.endswith("models.factorized") and cfg["_restored_step"] == 2
  path = eval_cli.main(["--workdir", workdir, "--dataset", experiment["pngs"], "--device", "cpu",
                        "--results_dir", str(tmp_path / "res")])
  records = json.load(open(path))
  assert len(records) == 2 and "hyper_latent_bpp" not in records[0]
  assert records[0]["lmbda"] == "0.00125" and records[0]["num_steps"] == "2"


def _root_slurm_template():
  spec = importlib.util.spec_from_file_location("root_slurm_template",
                                                os.path.join(REPO, "slurm_template.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_launch_local_sweep_and_launch_eval(tmp_path, monkeypatch):
  """launch --backend local runs smoke.py's two work units in parallel into
  wid=0-... and wid=1-... under one xid, each from the frozen copy of the
  config; launch_eval evaluates both."""
  monkeypatch.setattr(project_configs, "slurm_jobs_dir", str(tmp_path / "jobs"))
  monkeypatch.setenv("SLURM_ARRAY_JOB_ID", "6161")
  monkeypatch.setenv("PYTHONPATH", REPO)
  xms = tmp_path / "xms"
  launch.main(["--main", "shallow_ntc_tpu_torch.mshyper.train", "--config", SMOKE,
               "--parallel", "2", "--extra_args",
               f"--config.train_eval_config.num_steps=1 --experiments_dir {xms} --device cpu"])
  workdirs = sorted(glob.glob(str(xms / "6161" / "wid=*")))
  assert [os.path.basename(w) for w in workdirs] == [
      "wid=0-mshyper-lmbda=0.01-uq=unoise", "wid=1-mshyper-lmbda=0.08-uq=unoise"]
  frozen = glob.glob(str(tmp_path / "jobs" / "*_smoke.py"))
  assert len(frozen) == 1
  for wd in workdirs:
    assert json.load(open(os.path.join(wd, "config.json")))["config_filename"] == frozen[0]
    assert train_lib.latest_checkpoint_step(wd) == 1
  launch_eval.main(["--workdirs", str(xms / "6161" / "wid=*"), "--dataset", "synthetic",
                    "--extra_args", f"--device cpu --results_dir {tmp_path / 'res'} "
                                    "--patchsize 64"])
  assert sorted(os.listdir(tmp_path / "res")) == [
      "mshyper-lmbda=0.01-uq=unoise-step=1-xid=6161.json",
      "mshyper-lmbda=0.08-uq=unoise-step=1-xid=6161.json"]


def test_slurm_backend_and_template(tmp_path, monkeypatch):
  """The sbatch script is the root template's rendering (a GPU by default);
  the slurm backend submits it and links <job id>_config.py."""
  args = dict(job_name="train", last_hid=6, jobs_dir="/j", project_dir="/p",
              srun_command="srun python -m x --hid $SLURM_ARRAY_TASK_ID")
  root = _root_slurm_template()
  for gres in ("gpu:1", "tpu:1", ""):
    assert slurm_template.render(**args, gres=gres) == root.render(**args, gres=gres)
  assert "#SBATCH --gres=gpu:1" in slurm_template.render(**args)
  monkeypatch.setattr(project_configs, "slurm_jobs_dir", str(tmp_path / "jobs"))
  submitted = []

  def fake_sbatch(cmd, *a, **k):
    submitted.append(cmd)
    return b"99\n"

  monkeypatch.setattr(launch.subprocess, "check_output", fake_sbatch)
  launch.main(["--main", "shallow_ntc_tpu_torch.mshyper.train", "--config", SMOKE,
               "--backend", "slurm"])
  (script,) = glob.glob(str(tmp_path / "jobs" / "*_smoke.sbatch"))
  assert submitted == [["sbatch", "--parsable", script]]
  text = open(script).read()
  assert "#SBATCH --array=0-1" in text and "#SBATCH --gres=gpu:1" in text
  assert "-m shallow_ntc_tpu_torch.mshyper.train --config" in text
  assert text.rstrip().endswith("--hid $SLURM_ARRAY_TASK_ID")
  link = tmp_path / "jobs" / "99_config.py"
  assert os.path.islink(link) and os.readlink(link) == os.path.basename(script)[:-7] + ".py"
