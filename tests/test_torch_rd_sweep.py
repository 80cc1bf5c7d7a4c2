"""scripts/torch_rd_run.py, the port's R-D sweep, on the CPU.

The sweep starts each CLI in a process of its own under
shallow_ntc_tpu_torch.utils.counted. Here those commands run in this process
instead (counted.main with the command's environment, working directory and
arguments; tests/test_torch_results.py runs counted itself in processes), so
the whole sweep runs in seconds (the data step's PNGs made small: 8 train
at 64x64, 4 valid and 2 eval at 64x96): two points of bls2017_rd.py (--hids
0,3; 8 filters) into a copy of the committed results/torch_rd_deadleaves,
and the flagship's default point (ELIC (8, 8, 8, 16)) into an empty --out,
each trained 2 steps of B=2 64x64, and the flagship's SGA 2 steps; the
environment each command ran in; the save rule of the hyper-decoder's .npz
with torch_int8_quality.py stood in for by a script that writes set int8
records; a flagship run stopped at the deadline before its num_steps;
scripts/aggregate_results.py on the committed JSONs.
"""

import contextlib
import importlib.util
import io
import json
import os
import runpy
import shutil
import signal
import subprocess
import sys
import time
import types

import pytest
import torch

from shallow_ntc_tpu_torch import project_configs
from shallow_ntc_tpu_torch.utils import counted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "results", "torch_rd_deadleaves")
SMALL = ["--num_train", "8", "--num_eval", "2", "--codec_images", "1", "--device", "cpu",
         *(f"--train_override={o}" for o in (
             "train_eval_config.num_steps=2", "train_eval_config.checkpoint_every_steps=2",
             "train_eval_config.eval_every_steps=2", "train_eval_config.max_validation_steps=1",
             "train_data_config.batchsize=2", "train_data_config.patchsize=64"))]
FACTORIZED = ["--config", "bls2017_rd", "--hids", "0,3",
              "--train_override=model_config.transform_config.analysis.num_filters=8",
              "--train_override=model_config.transform_config.synthesis.num_filters=8"]
FLAGSHIP = ["--train_override=model_config.transform_config.analysis.channels=(8,8,8,16)",
            "--sga_override=train_eval_config.num_steps=2"]


def _sweep_module():
  spec = importlib.util.spec_from_file_location(
      "_torch_rd_run", os.path.join(REPO, "scripts", "torch_rd_run.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _load(path):
  with open(path) as f:
    return json.load(f)


@contextlib.contextmanager
def _process_state(env, cwd):
  """The environment (with the dataset names it resolves:
  project_configs), working directory, argv, SIGTERM handler and TF32 flags
  of a command, restored after it."""
  saved = (dict(os.environ), os.getcwd(), list(sys.argv), signal.getsignal(signal.SIGTERM),
           torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
  os.environ.clear()
  os.environ.update(env)
  os.chdir(cwd)
  importlib.reload(project_configs)
  try:
    yield
  finally:
    os.environ.clear()
    os.environ.update(saved[0])
    os.chdir(saved[1])
    importlib.reload(project_configs)
    sys.argv[:] = saved[2]
    signal.signal(signal.SIGTERM, saved[3])
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[4:]


COMMANDS = []  # (argv, environment) of every command _in_process ran
STAND_INS = {}  # a script's file name -> the script that runs in its place


def _in_process(cmd, env, cwd):
  """Run `python -m shallow_ntc_tpu_torch.utils.counted COUNTS TARGET ARGS` or
  `python SCRIPT.py ARGS` here; (its return code, its output)."""
  COMMANDS.append((list(cmd), dict(env or {})))
  if cmd[:3] == [sys.executable, "-m", "shallow_ntc_tpu_torch.utils.counted"]:
    if cmd[4] == "shallow_ntc_tpu_torch.deadleaves":
      cmd = [*cmd, "--train_size", "64", "--eval_hw", "64x96"]  # small PNGs
    cmd = [*cmd[:4], STAND_INS.get(os.path.basename(cmd[4]), cmd[4]), *cmd[5:]]
    run = lambda: counted.main(cmd[3:])  # noqa: E731
  elif cmd[0] == sys.executable and cmd[1].endswith(".py"):
    def run():
      sys.argv = cmd[1:]
      runpy.run_path(cmd[1], run_name="__main__")
  else:
    raise FileNotFoundError(cmd[0])  # nvidia-smi: none here
  out = io.StringIO()
  with _process_state(env, cwd), contextlib.redirect_stdout(out):
    try:
      run()
      code = 0
    except SystemExit as e:
      code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
  return code, out.getvalue()


class _FinishedPopen:
  """subprocess.Popen of a command that has run to its end in this process."""

  def __init__(self, cmd, cwd, env, stdout, stderr):
    self.returncode, text = _in_process(cmd, env, cwd)
    stdout.write(text)

  def poll(self):
    return self.returncode

  def wait(self, timeout=None):
    return self.returncode

  def kill(self):
    pass

  send_signal = kill


def _run(cmd, cwd=None, env=None, timeout=None, **kwargs):
  code, text = _in_process(cmd, env, cwd)
  return subprocess.CompletedProcess(cmd, code, stdout=text)


def _drive(argv):
  """The sweep's main(argv) with its commands run in this process; (its
  return, its log)."""
  mod = _sweep_module()
  mod.subprocess = types.SimpleNamespace(
      run=_run, Popen=_FinishedPopen, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT,
      TimeoutExpired=subprocess.TimeoutExpired, SubprocessError=subprocess.SubprocessError)
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    result = mod.main(argv)
  return result, out.getvalue()


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
  """The factorized points into a copy of the committed --out, then the
  flagship's point into an empty one, both on one --root."""
  tmp = tmp_path_factory.mktemp("rd_sweep")
  out = tmp / "out"
  shutil.copytree(COMMITTED, out)
  root = str(tmp / "root")
  factorized = _drive([*FACTORIZED, *SMALL, "--root", root, "--out", str(out)])
  del COMMANDS[:]
  flagship = _drive([*FLAGSHIP, *SMALL, "--root", root, "--out", str(tmp / "flagship")])
  return dict(tmp=tmp, root=root, out=out, flagship_out=tmp / "flagship",
              factorized=factorized, flagship=flagship, flagship_commands=list(COMMANDS))


def test_factorized_points_run_and_are_recorded(sweep):
  (result, log) = sweep["factorized"]
  assert result["ran"] == ["bls2017_rd_hid0", "bls2017_rd_hid3"] and result["stopped"] is None
  out = sweep["out"]
  index = _load(out / "runs.json")
  assert index == {**_load(os.path.join(COMMITTED, "runs.json")),
                   "bls2017_rd_hid0": "bls2017_rd_hid0/run.json",
                   "bls2017_rd_hid3": "bls2017_rd_hid3/run.json"}
  for key, lmbda in (("bls2017_rd_hid0", 0.00125), ("bls2017_rd_hid3", 0.01)):
    run = _load(out / index[key])
    assert (run["config"], run["family"], run["xid"]) == ("bls2017_rd", "factorized",
                                                         "torchrd_bls2017_rd")
    assert run["runname"] == f"factorized-lmbda={lmbda}-num_steps=2"
    assert run["checkpoint_step"] == 2 and run["train_end"] == "finished"
    assert set(run["skipped"]) == {"sga", "itinf_to_results", "recompute"}
    assert set(run["steps"]) == {"train", "eval", "codec_overhead", "int8_quality",
                                 "train_curves", "basis"}
    # The factorized family launches no kernel.
    assert all(n == 0 for s in run["steps"].values() for n in s["launches"].values())
    assert "hyper_ranges" not in _load(out / key / "int8_quality.json")
    # Codec overhead takes the factorized family: its one latent's rate is the whole bpp.
    codec = _load(out / key / "codec_overhead.json")
    assert codec["all_lossless"] and all(
        r["likelihood_latent_bpp"] == r["likelihood_bpp"] for r in codec["per_image"])
    assert (out / "json" / f"factorized-lmbda={lmbda}-num_steps=2-step=2-xid="
            "torchrd_bls2017_rd.json").is_file()
    for name in ("train_record.jsonl", "val_record.jsonl", "codec_overhead.json",
                 "train_curves.json", "basis.png"):
      assert (out / key / name).is_file(), name
  assert "skipped" not in log


def test_aggregate_holds_the_points_that_ran(sweep):
  """The 2 eval images of each point that ran join its rd_lambda's row
  (aggregate_results.py's method drops num_steps, so the committed 20000
  -step points of the same lambda share it); the other rows keep theirs."""
  committed = _load(os.path.join(COMMITTED, "aggregate.json")).get(
      "factorized", {"rd_lambda": [], "num_images": []})
  images = dict(zip(committed["rd_lambda"], committed["num_images"]))
  for lmbda in (0.00125, 0.01):
    images[lmbda] = images.get(lmbda, 0) + 2
  agg = _load(sweep["out"] / "aggregate.json")
  assert set(agg) == {"mshyper", "mshyper+sga", "factorized", "mshyper-synthesis=jpegl"}
  assert dict(zip(agg["factorized"]["rd_lambda"], agg["factorized"]["num_images"])) == images
  flagship = _load(sweep["flagship_out"] / "aggregate.json")
  assert set(flagship) == {"mshyper", "mshyper+sga"}
  assert flagship["mshyper"]["rd_lambda"] == flagship["mshyper+sga"]["rd_lambda"] == [0.01]


def test_committed_rows_are_left_as_they_were(sweep):
  committed = _load(os.path.join(COMMITTED, "aggregate.json"))
  agg = _load(sweep["out"] / "aggregate.json")
  assert {"mshyper", "mshyper+sga"} <= set(committed)
  for method in ("mshyper", "mshyper+sga"):
    assert agg[method] == committed[method]
    assert (_load(sweep["out"] / f"{method}-detailed.json")
            == _load(os.path.join(COMMITTED, f"{method}-detailed.json")))
  assert (_load(sweep["out"] / "two_layer_syn_rd_hid3" / "run.json")
          == _load(os.path.join(COMMITTED, "two_layer_syn_rd_hid3", "run.json")))


def test_a_rerun_skips_the_finished_points(sweep):
  out = sweep["out"]
  before = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()
            and p.name != "aggregate.json" and not p.name.endswith("-detailed.json")}
  result, log = _drive([*FACTORIZED, *SMALL, "--root", sweep["root"], "--out", str(out)])
  assert result["ran"] == []
  assert "bls2017_rd_hid0: skipped" in log and "bls2017_rd_hid3: skipped" in log
  assert "data: not needed" in log
  after = {p: p.stat().st_mtime_ns for p in before}
  assert after == before


def test_the_default_point_is_the_flagships_and_is_skipped_where_committed(sweep, tmp_path):
  """No flags: the flagship at rd_lambda 0.01 (two_layer_syn_rd.py --hid 3,
  experiment torchrd), whose eval JSON the committed --out holds, so the
  sweep makes no data and trains nothing."""
  mod = _sweep_module()
  point = mod.Point("two_layer_syn_rd", 3, [])
  assert (point.runname, point.xid, point.sga_xid, point.family) == (
      "mshyper-lmbda=0.01-num_steps=30000", "torchrd", "torchrd_sga", "mshyper")
  assert [os.path.basename(p) for p in point.eval_jsons(sweep["out"])] == [
      "mshyper-lmbda=0.01-num_steps=30000-step=30000-xid=torchrd.json"]
  result, log = _drive(["--device", "cpu", "--root", str(tmp_path / "root"), "--out",
                        str(sweep["out"])])
  assert result["ran"] == [] and "two_layer_syn_rd_hid3: skipped" in log
  assert not (tmp_path / "root" / "data").exists()


def test_the_flagship_point_runs_every_stage(sweep):
  (result, _) = sweep["flagship"]
  assert result["ran"] == ["two_layer_syn_rd_hid3"]
  out = sweep["flagship_out"]
  run = _load(out / "two_layer_syn_rd_hid3" / "run.json")
  assert run["skipped"] == {} and run["runname"] == "mshyper-lmbda=0.01-num_steps=2"
  assert list(run["steps"]) == ["train", "eval", "codec_overhead", "int8_quality",
                                "train_curves", "basis", "sga", "itinf_to_results",
                                "recompute"]
  ranges = _load(out / "two_layer_syn_rd_hid3" / "int8_quality.json")["hyper_ranges"]
  assert [len(c["input_absmax"]) for c in ranges["convs"]] == [16, 16, 24]
  assert ranges["index_count"] == sum(r["index_count"] for r in ranges["per_image"])
  assert sorted(os.listdir(out / "json")) == [
      "mshyper+sga-lmbda=0.01-step=2-xid=torchrd_sga.json",
      "mshyper-lmbda=0.01-num_steps=2-step=2-xid=torchrd.json"]
  for name in ("sga_metrics.json", "sga_recomputed.json", "sga_batch_id=0_val_record.jsonl"):
    assert (out / "two_layer_syn_rd_hid3" / name).is_file(), name


@pytest.mark.parametrize("which", ["out", "flagship_out"])
def test_jax_aggregate_script_gives_the_sweeps_aggregate(sweep, which, tmp_path):
  """scripts/aggregate_results.py, run unchanged in its own process on the
  port's JSONs, writes the sweep's aggregate.json and -detailed.json files."""
  out = sweep[which]
  proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "aggregate_results.py"),
                         "--results_glob", str(out / "json" / "*.json"), "--out", str(tmp_path)],
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  for path in tmp_path.iterdir():
    assert _load(path) == _load(out / path.name), path.name
  assert {p.name for p in tmp_path.iterdir()} == {
      p.name for p in out.iterdir() if p.name == "aggregate.json" or p.name.endswith(
          "-detailed.json")}


def test_the_deadline_stops_before_a_point_that_cannot_end(sweep, tmp_path):
  """With no time left, the first point runs (no rate is known yet: on the
  sweep's root its training resumes at its last step) and the second is not
  started; the stop is logged and returned."""
  argv = [*FACTORIZED, *SMALL, "--root", sweep["root"], "--out", str(tmp_path / "out"),
          "--deadline_s", "0", "--reserve_s", "0", "--skip",
          "codec_overhead,int8_quality,train_curves,basis"]
  result, log = _drive(argv)
  assert result["ran"] == ["bls2017_rd_hid0"]
  assert result["stopped"].startswith("stopped before bls2017_rd_hid3: the last point took")
  assert result["stopped"] in log
  run = _load(tmp_path / "out" / "bls2017_rd_hid0" / "run.json")
  assert set(run["steps"]) == {"train", "eval"}
  assert run["skipped"]["basis"] == "--skip"


def test_hids_and_stages_parse():
  mod = _sweep_module()
  assert mod.parse_hids("3") == [3]
  assert mod.parse_hids("0-6") == list(range(7))
  assert mod.parse_hids("0,3,5-6") == [0, 3, 5, 6]
  with pytest.raises(SystemExit):
    mod.main(["--skip", "train", "--device", "cpu"])
  with pytest.raises(SystemExit):
    mod.main(["--config", "two_layer_syn", "--device", "cpu"])


def test_keep_checkpoints_makes_a_workdir_of_each(tmp_path):
  """--keep_checkpoints: each checkpoint the train loop writes is hard-linked
  into kept/step=<n>/ beside config.json, once, whatever the loop deletes
  later."""
  mod = _sweep_module()
  ckpts = tmp_path / "wd" / "train" / "checkpoints"
  ckpts.mkdir(parents=True)
  (tmp_path / "wd" / "config.json").write_text("{}")
  (ckpts / "ckpt_5.pt").write_bytes(b"5")
  kept = tmp_path / "kept"
  mod.keep_checkpoints(str(tmp_path / "wd"), str(kept))
  (ckpts / "ckpt_5.pt").unlink()
  (ckpts / "ckpt_9.pt").write_bytes(b"9")
  mod.keep_checkpoints(str(tmp_path / "wd"), str(kept))
  mod.keep_checkpoints(str(tmp_path / "wd"), str(kept))
  assert sorted(os.listdir(kept)) == ["step=5", "step=9"]
  for n in (5, 9):
    assert (kept / f"step={n}" / "train" / "checkpoints" / f"ckpt_{n}.pt").read_bytes() == (
        str(n).encode())
    assert (kept / f"step={n}" / "config.json").read_text() == "{}"


def test_training_runs_without_the_chain_and_every_other_step_with_it(sweep):
  """The flagship's train CLI runs with no kernel gate set (the chain's
  backward recomputes through cuDNN, so the step is faster without it); its
  eval, codec overhead, int8 quality and SGA run the ELIC blocks through
  the residual-block kernel."""
  names, gates = _sweep_module().GATES, {}
  for cmd, env in sweep["flagship_commands"]:
    if "shallow_ntc_tpu_torch.utils.counted" in cmd:
      gates[os.path.basename(cmd[3])[:-len(".counts")]] = {g: env[g] for g in names if g in env}
  assert gates["train"] == {}
  for name in ("eval", "codec_overhead", "int8_quality", "sga"):
    assert gates[name] == {"SNTC_FUSED_RB_CHAIN": "1"}, name


@pytest.mark.parametrize("deltas,expected", [
    ({1000: 0.01, 2000: 0.21, 3000: 0.9}, 2000),
    ({1000: 0.35, 2000: 0.01}, 1000),
    ({1000: 0.2, 2000: -0.4}, None),
    ({1000: 0.01, 2000: 0.3}, 2000),  # the final checkpoint counts too
    ({}, None)])
def test_departed_step_is_the_first_kept_checkpoint_past_the_bound(tmp_path, deltas, expected):
  records = {}
  for n, d in deltas.items():
    records[n] = str(tmp_path / f"int8_quality_step={n}.json")
    with open(records[n], "w") as f:
      json.dump({"summary": {"bpp": {"f32": 0.5, "all": 0.5 + d, "all_delta": d}}}, f)
  mod = _sweep_module()
  assert mod.DEPART_BPP == 0.2
  assert mod.departed_step(dict(reversed(records.items()))) == expected


_INT8_STAND_IN = """
import argparse, json, os
p = argparse.ArgumentParser()
for a in ("--workdir", "--out", "--save_hyper", "--dataset", "--device"):
  p.add_argument(a)
p.add_argument("--ranges", action="store_true")
args = p.parse_args()
name = os.path.basename(os.path.normpath(args.workdir))
step = int(name.split("=")[1]) if name.startswith("step=") else 3
delta = DELTAS[step]
os.makedirs(os.path.dirname(args.out), exist_ok=True)
with open(args.out, "w") as f:
  json.dump({"summary": {"bpp": {"all_delta": delta}}, "hyper_ranges": {"step": step}}, f)
if args.save_hyper:
  with open(args.save_hyper, "wb") as f:
    f.write(b"%d" % step)
"""


@pytest.mark.parametrize("deltas,departed", [
    ({1: 0.1, 2: 0.25, 3: 0.5}, 2),
    ({1: 0.1, 2: 0.1, 3: 0.5}, 3),
    ({1: 0.1, 2: 0.1, 3: 0.1}, None)])
def test_hyper_decoder_saves_of_the_departed_and_final_checkpoints_stay_under_root(
    tmp_path, deltas, departed):
  """--keep_checkpoints on the flagship (--hids 2), 3 steps with a
  checkpoint after each: the train loop keeps all three (--max_to_keep 0),
  each becomes a workdir under kept/, and int8 quality runs on each with
  --save_hyper (the stand-in sets int8_all - float bpp by step); the .npz of
  the first step past DEPART_BPP (the final one included) and of the final
  step stay under --root, the others are removed, none is under --out, and
  run.json names them."""
  root, out = tmp_path / "root", tmp_path / "out"
  stand_in = tmp_path / "torch_int8_quality.py"
  stand_in.write_text(f"DELTAS = {deltas!r}\n" + _INT8_STAND_IN)
  STAND_INS["torch_int8_quality.py"] = str(stand_in)
  del COMMANDS[:]
  try:
    result, _ = _drive([*FLAGSHIP, *SMALL, "--train_override=train_eval_config.num_steps=3",
                        "--train_override=train_eval_config.checkpoint_every_steps=1",
                        "--hids", "2", "--keep_checkpoints", "--skip",
                        "eval,codec_overhead,train_curves,basis,sga", "--root", str(root),
                        "--out", str(out)])
  finally:
    del STAND_INS["torch_int8_quality.py"]
  assert result["ran"] == ["two_layer_syn_rd_hid2"]
  counts = str(root / "logs" / "two_layer_syn_rd_hid2" / "train.counts")
  (train_cmd,) = [cmd for cmd, _ in COMMANDS if cmd[3:4] == [counts]]
  assert train_cmd[train_cmd.index("--max_to_keep") + 1] == "0"
  kept = root / "kept" / "two_layer_syn_rd_hid2"
  assert sorted(os.listdir(kept)) == ["step=1", "step=2", "step=3"]
  run = _load(out / "two_layer_syn_rd_hid2" / "run.json")
  assert run["checkpoint_step"] == 3 and run["departed_step"] == departed
  assert list(run["steps"]) == ["train", "int8_quality_step=1", "int8_quality_step=2",
                                "int8_quality"]
  hyper = "hyper/two_layer_syn_rd_hid2"
  saved = sorted({3} | ({departed} if departed else set()))
  assert run["hyper_saves"] == {str(n): f"{hyper}/step={n}.npz" for n in saved}
  assert sorted(os.listdir(root / hyper)) == [f"step={n}.npz" for n in saved]
  for n in saved:
    assert (root / hyper / f"step={n}.npz").read_bytes() == str(n).encode()
  assert not list(out.rglob("*.npz"))
  for n in (1, 2):
    assert _load(out / "two_layer_syn_rd_hid2" / f"int8_quality_step={n}.json")[
        "hyper_ranges"] == {"step": n}


class _StoppedPopen(_FinishedPopen):
  """A train command that the sweep stops at its deadline after the
  checkpoint and val pass of step 2 of 4: the run is made to its end here,
  then what it wrote after step 2 is taken away; poll() says it is still
  running until it is sent SIGTERM."""

  def __init__(self, cmd, cwd, env, stdout, stderr):
    super().__init__(cmd, cwd, env, stdout, stderr)
    self.returncode = None
    if os.path.basename(cmd[3]) != "train.counts":
      raise AssertionError(f"only the train CLI is started with Popen: {cmd}")
    exp = os.path.join(cmd[cmd.index("--experiments_dir") + 1], "torchrd")
    (workdir,) = [os.path.join(exp, d) for d in os.listdir(exp)]
    os.remove(os.path.join(workdir, "train", "checkpoints", "ckpt_4.pt"))
    for name in ("train", "val"):
      path = os.path.join(workdir, name, "record.jsonl")
      with open(path) as f:
        rows = [line for line in f if json.loads(line)["step"] <= 2]
      with open(path, "w") as f:
        f.writelines(rows)

  def send_signal(self, sig):
    assert sig == signal.SIGTERM
    self.returncode = 128 + sig


def test_a_run_stopped_before_num_steps_is_kept_out_of_the_aggregate(tmp_path):
  """The flagship's point (--keep_checkpoints, as its runs on the card)
  stopped at the deadline after step 2 of 4 (a checkpoint every 2): its eval and SGA JSONs are written beside its
  records under their real steps, json/ and the aggregate stay empty, and
  a later call does not skip the point."""
  mod = _sweep_module()
  mod.subprocess = types.SimpleNamespace(
      run=_run, Popen=_StoppedPopen, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT,
      TimeoutExpired=subprocess.TimeoutExpired, SubprocessError=subprocess.SubprocessError)
  mod.time = types.SimpleNamespace(time=time.time, sleep=lambda s: None, strftime=time.strftime)
  root, out = tmp_path / "root", tmp_path / "out"
  with contextlib.redirect_stdout(io.StringIO()) as log:
    result = mod.main([*FLAGSHIP, *SMALL, "--train_override=train_eval_config.num_steps=4",
                       "--keep_checkpoints", "--skip",
                       "codec_overhead,int8_quality,train_curves,basis,recompute",
                       "--deadline_s", "0", "--reserve_s", "0", "--root", str(root), "--out",
                       str(out)])
  assert result["ran"] == ["two_layer_syn_rd_hid3"]
  dest = out / "two_layer_syn_rd_hid3"
  run = _load(dest / "run.json")
  assert run["checkpoint_step"] == 2 and run["train_end"].startswith(
      "stopped after the val pass of step 2")
  assert run["steps"]["train"]["returncode"] == 143
  assert os.listdir(out / "json") == [] and not (out / "aggregate.json").exists()
  evals = _load(dest / "mshyper-lmbda=0.01-num_steps=4-step=2-xid=torchrd.json")
  assert [r["instance_id"] for r in evals] == [0, 1]
  assert (dest / "mshyper+sga-lmbda=0.01-step=2-xid=torchrd_sga.json").is_file()
  assert "is short of num_steps" in log.getvalue()
  assert mod.Point("two_layer_syn_rd", 3, ["train_eval_config.num_steps=4"]).eval_jsons(
      str(out)) == []


def test_aggregate_of_the_committed_jsons_is_the_committed_aggregate(tmp_path):
  """scripts/aggregate_results.py on results/torch_rd_deadleaves/json/
  rebuilds the committed aggregate.json and -detailed.json files bit for
  bit (the factorized family's, the flagship's with and without SGA, and
  jpegl_rd's), the flagship's rows holding every λ trained on the card to
  step 30000 (a point cut short keeps its eval JSON beside its records):
  the seven λ of the JAX run's mshyper row (results/rd_deadleaves/)."""
  proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "aggregate_results.py"),
                         "--results_glob", os.path.join(COMMITTED, "json", "*.json"), "--out",
                         str(tmp_path)], capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  names = {p.name for p in tmp_path.iterdir()}
  assert names == {"aggregate.json", "factorized-detailed.json", "mshyper-detailed.json",
                   "mshyper+sga-detailed.json", "mshyper-synthesis=jpegl-detailed.json"}
  for name in names:
    with open(tmp_path / name, "rb") as a, open(os.path.join(COMMITTED, name), "rb") as b:
      assert a.read() == b.read(), name
  agg = _load(tmp_path / "aggregate.json")
  # The λ of every flagship point in runs.json whose run reached its 30000
  # steps, by the point's hid in the sweep script's RD_LAMBDAS.
  from shallow_ntc_tpu_torch.mshyper.configs import two_layer_syn_rd

  prefix = "two_layer_syn_rd_hid"
  full = sorted(two_layer_syn_rd.RD_LAMBDAS[int(key[len(prefix):])]
                for key, path in _load(os.path.join(COMMITTED, "runs.json")).items()
                if key.startswith(prefix)
                and _load(os.path.join(COMMITTED, path))["checkpoint_step"] == 30000)
  jax_rows = _load(os.path.join(REPO, "results", "rd_deadleaves", "aggregate.json"))
  assert full == sorted(jax_rows["mshyper"]["rd_lambda"]) and len(full) == 7
  assert agg["mshyper"]["rd_lambda"] == agg["mshyper+sga"]["rd_lambda"] == full
