#!/usr/bin/env python
"""The flagship's R-D point through the PyTorch port on one GPU, from the
data to the R-D table, in one command.

  python scripts/torch_rd_run.py [--root rd_run] [--out results/torch_rd_deadleaves]

The steps, each through the port's own CLI in a process of its own:
  1. data      python -m shallow_ntc_tpu_torch.deadleaves: the JAX run's set,
               1200 train PNGs at 320x320, 4 valid and 24 eval at 512x768;
  2. train     python -m shallow_ntc_tpu_torch.mshyper.train --config
               shallow_ntc_tpu_torch/mshyper/configs/two_layer_syn_rd.py
               --hid 3 (rd_lambda 0.01, 30000 steps of B=8 256x256, a val
               pass and a checkpoint every 5000) with SNTC_FUSED_RB_CHAIN=1.
               Where --deadline_s would not leave --reserve_s for the rest
               after the next val pass (at the rate of the last interval),
               the run is stopped just after a val pass and its checkpoint,
               and the rest uses that checkpoint;
  3. eval      python -m shallow_ntc_tpu_torch.eval --workdir on the 24 eval
               images;
  4. codec     scripts/torch_measure_codec_overhead.py on 8 of them;
  5. int8      scripts/torch_int8_quality.py on all 24;
  6. SGA       python -m shallow_ntc_tpu_torch.mshyper.itinf with
               mshyper/configs/itinf.py, warm-started by wid: 3 batches of 8
               eval images, 3000 steps, float32 transforms, a val pass
               every 200 steps (the JAX run's settings);
  7. results   scripts/collect_train_curves.py and
               scripts/torch_vis_syn_filters.py (before SGA), then
               scripts/torch_itinf_to_results.py, scripts/aggregate_results.py
               over the eval and SGA JSONs and
               scripts/torch_recompute_itinf_metrics.py on a copy of the SGA
               workdir.
Into --out: aggregate.json and its -detailed.json files, json/ (the eval's
and SGA's per-image JSONs), codec_overhead.json, int8_quality.json,
train_curves.json, train_record.jsonl, val_record.jsonl, sga_metrics.json,
each SGA batch's train and val records, sga_recomputed.json, basis.png and
run.json (the step reached, each step's seconds, the kernels' launches, the
card; rewritten after each stage). The workdirs (checkpoints
included) stay under --root. Dot overrides for the train and SGA CLIs
(--train_override, --sga_override; repeatable) cut a rehearsal short;
--device cpu runs it on the CPU.
"""

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
XID, SGA_XID, HID = "torchrd", "torchrd_sga", 3

def log(msg):
  print(f"[torch_rd_run {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def read_jsonl(path):
  if not os.path.isfile(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


class Runner:
  """Starts each command in its own process under
  shallow_ntc_tpu_torch.utils.counted and keeps its seconds and launch
  counts."""

  def __init__(self, root, env):
    self.root, self.env = root, env
    self.steps = {}

  def argv(self, name, target, args):
    return [sys.executable, "-m", "shallow_ntc_tpu_torch.utils.counted",
            os.path.join(self.root, f"{name}.counts"), target, *args]

  def finish(self, name, t, returncode):
    with open(os.path.join(self.root, f"{name}.counts")) as f:
      counts = json.load(f)
    self.steps[name] = dict(seconds=time.time() - t, launches=counts, returncode=returncode)
    log(f"{name}: {self.steps[name]}")
    return counts

  def run(self, name, target, args, timeout=1800, **extra_env):
    t = time.time()
    proc = subprocess.run(self.argv(name, target, args), cwd=self.root,
                          env=dict(self.env, **extra_env), timeout=timeout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(os.path.join(self.root, f"{name}.log"), "w") as f:
      f.write(proc.stdout)
    if proc.returncode:
      print(proc.stdout[-6000:], file=sys.stderr, flush=True)
      raise RuntimeError(f"{name} exited with {proc.returncode}")
    self.finish(name, t, proc.returncode)
    return proc.stdout


def train(runner, args, exp):
  """Step 2: the train CLI, stopped after a val pass where the next one would
  not leave args.reserve_s before args.deadline_s. Returns (its workdir
  under the experiment directory `exp`, why the run ended)."""
  cfg = os.path.join(REPO, "shallow_ntc_tpu_torch", "mshyper", "configs", "two_layer_syn_rd.py")
  cmd = runner.argv("train", "shallow_ntc_tpu_torch.mshyper.train",
                    ["--config", cfg, "--hid", str(HID), "--experiments_dir",
                     os.path.join(args.root, "train_xms"), "--device", args.device,
                     *(f"--config.{o}" for o in args.train_override)])
  t = time.time()
  with open(os.path.join(args.root, "train.log"), "w") as out:
    proc = subprocess.Popen(cmd, cwd=args.root, env=dict(runner.env, SNTC_FUSED_RB_CHAIN="1"),
                            stdout=out, stderr=subprocess.STDOUT)
    try:
      last_val, t_last, reason, next_report = 0, t, "finished", t + 300
      workdir = None
      while proc.poll() is None:
        time.sleep(5)
        now = time.time()
        workdir = workdir or next(iter(glob.glob(os.path.join(exp, f"wid={HID}-*"))), None)
        if workdir is None:
          continue
        vals = read_jsonl(os.path.join(workdir, "val", "record.jsonl"))
        if now >= next_report:
          rows = read_jsonl(os.path.join(workdir, "train", "record.jsonl"))
          if rows:
            log(f"train step {rows[-1]['step']}: rd_loss {rows[-1]['rd_loss']:.4f}, "
                f"{1e3 / rows[-1]['steps_per_sec']:.1f} ms a step")
          next_report = now + 300
        if vals and vals[-1]["step"] > last_val:
          step = vals[-1]["step"]
          per_step = (now - t_last) / (step - last_val)
          log(f"val at step {step}: {vals[-1]}; {per_step * 1e3:.1f} ms a step since step "
              f"{last_val}")
          last_val, t_last = step, now
          te_cfg = read_train_eval(workdir)
          gap = te_cfg["eval_every_steps"] * per_step * 1.02
          if step < te_cfg["num_steps"] and now + gap > T0 + args.deadline_s - args.reserve_s:
            reason = (f"stopped after the val pass of step {step}: the next would end "
                      f"{now + gap - T0:.0f} s into the run, past {args.deadline_s} - "
                      f"{args.reserve_s} s")
            break
        if now > T0 + args.deadline_s - args.reserve_s:
          reason = f"stopped at the deadline, {now - T0:.0f} s into the run"
          break
      if proc.poll() is None:
        log(f"train: {reason}")
        proc.send_signal(signal.SIGTERM)
        try:
          proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
          proc.kill()
          proc.wait()
    finally:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  if proc.returncode not in (0, 143):
    with open(os.path.join(args.root, "train.log")) as f:
      print(f.read()[-6000:], file=sys.stderr, flush=True)
    raise RuntimeError(f"train exited with {proc.returncode}")
  runner.finish("train", t, proc.returncode)
  (workdir,) = glob.glob(os.path.join(exp, f"wid={HID}-*"))
  return workdir, reason


def read_train_eval(workdir):
  """The workdir's train_eval_config (its config.json)."""
  with open(os.path.join(workdir, "config.json")) as f:
    return json.load(f)["train_eval_config"]


def smi_line():
  try:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()
  except (OSError, subprocess.SubprocessError) as e:
    return f"nvidia-smi failed: {e}"


T0 = time.time()


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--root", default="rd_run", help="data and workdirs")
  p.add_argument("--out", default="results/torch_rd_deadleaves")
  p.add_argument("--deadline_s", type=float, default=3480.0,
                 help="seconds from the start by which everything should be done")
  p.add_argument("--reserve_s", type=float, default=400.0,
                 help="seconds kept for the steps after training")
  p.add_argument("--num_train", type=int, default=1200)
  p.add_argument("--num_eval", type=int, default=24)
  p.add_argument("--codec_images", type=int, default=8)
  p.add_argument("--train_override", action="append", default=[],
                 help="a dot override of the train CLI, e.g. train_eval_config.num_steps=20")
  p.add_argument("--sga_override", action="append", default=[],
                 help="a dot override of the itinf CLI")
  p.add_argument("--device", default="cuda", help="the device of every CLI")
  args = p.parse_args(argv)
  args.root, args.out = os.path.abspath(args.root), os.path.abspath(args.out)
  os.makedirs(args.root, exist_ok=True)
  os.makedirs(os.path.join(args.out, "json"), exist_ok=True)
  smi = smi_line()
  log(f"card: {smi}")
  env = dict(os.environ, PYTHONPATH=REPO, SHALLOW_NTC_PROJECT_DIR=args.root,
             SLURM_ARRAY_JOB_ID=XID, SLURM_ARRAY_TASK_ID=str(HID))
  for gate in ("SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK", "SNTC_INT8_DECODE",
               "SNTC_INT8_ENCODE"):
    env.pop(gate, None)
  runner = Runner(args.root, env)
  chain = dict(SNTC_FUSED_RB_CHAIN="1")
  run = dict(card=smi, argv=sys.argv[1:] if argv is None else list(argv))

  # 1. data
  runner.run("data", "shallow_ntc_tpu_torch.deadleaves",
             ["--out", os.path.join(args.root, "data", "deadleaves"), "--num_train",
              str(args.num_train), "--num_valid", "4", "--num_eval", str(args.num_eval)])

  # 2. train
  exp = os.path.join(args.root, "train_xms", XID)
  workdir, reason = train(runner, args, exp)
  from shallow_ntc_tpu_torch import train_lib

  step = train_lib.latest_checkpoint_step(workdir)
  vals = read_jsonl(os.path.join(workdir, "val", "record.jsonl"))
  rows = read_jsonl(os.path.join(workdir, "train", "record.jsonl"))
  run.update(workdir=os.path.relpath(workdir, args.root), checkpoint_step=step,
             last_val_step=vals[-1]["step"] if vals else None, train_end=reason,
             train_step_ms=[1e3 / r["steps_per_sec"] for r in rows])
  log(f"trained to the checkpoint of step {step} ({reason}); val rows at "
      f"{[v['step'] for v in vals]}")
  if step is None:
    raise RuntimeError("the run reached no checkpoint")
  for name in ("train", "val"):
    shutil.copy(os.path.join(workdir, name, "record.jsonl"),
                os.path.join(args.out, f"{name}_record.jsonl"))

  def save():
    run.update(steps=runner.steps, seconds=time.time() - T0)
    with open(os.path.join(args.out, "run.json"), "w") as f:
      json.dump(run, f, indent=1)

  # 3-5. eval, codec overhead, int8 quality; the train curve and the basis
  scripts = os.path.join(REPO, "scripts")
  runner.run("eval", "shallow_ntc_tpu_torch.eval",
             ["--workdir", workdir, "--dataset", "deadleaves_eval", "--results_dir",
              os.path.join(args.out, "json"), "--device", args.device], **chain)
  runner.run("codec_overhead", os.path.join(scripts, "torch_measure_codec_overhead.py"),
             ["--workdir", workdir, "--dataset", "deadleaves_eval", "--max_images",
              str(args.codec_images), "--out", os.path.join(args.out, "codec_overhead.json"),
              "--device", args.device], **chain)
  runner.run("int8_quality", os.path.join(scripts, "torch_int8_quality.py"),
             ["--workdir", workdir, "--dataset", "deadleaves_eval", "--out",
              os.path.join(args.out, "int8_quality.json"), "--device", args.device], **chain)
  runner.run("train_curves", os.path.join(scripts, "collect_train_curves.py"),
             ["--workdirs_glob", os.path.join(exp, "*"), "--out",
              os.path.join(args.out, "train_curves.json")])
  runner.run("basis", os.path.join(scripts, "torch_vis_syn_filters.py"),
             ["--workdir", workdir, "--out", os.path.join(args.out, "basis.png"), "--device",
              args.device])
  save()

  # 6. SGA, warm-started by wid from the experiment
  te = "--config.train_eval_config."
  runner.run("sga", "shallow_ntc_tpu_torch.mshyper.itinf",
             ["--config", os.path.join(REPO, "shallow_ntc_tpu_torch", "mshyper", "configs",
                                       "itinf.py"),
              "--hid", str(HID), f"{te}warm_start_exp_dir={exp}",
              "--config.data_config.dataset=deadleaves_eval", "--config.data_config.batchsize=8",
              f"{te}transforms_dtype=float32", f"{te}log_metrics_every_steps=100",
              f"{te}eval_every_steps=200", "--experiments_dir",
              os.path.join(args.root, "itinf_xms"), "--device", args.device,
              *(f"--config.{o}" for o in args.sga_override)],
             timeout=3600, SLURM_ARRAY_JOB_ID=SGA_XID, **chain)
  (sga_wd,) = glob.glob(os.path.join(args.root, "itinf_xms", SGA_XID, f"wid={HID}-*"))
  shutil.copy(os.path.join(sga_wd, "metrics.json"), os.path.join(args.out, "sga_metrics.json"))
  for d in sorted(glob.glob(os.path.join(sga_wd, "batch_id=*"))):
    for name in ("train", "val"):
      shutil.copy(os.path.join(d, name, "record.jsonl"),
                  os.path.join(args.out, f"sga_{os.path.basename(d)}_{name}_record.jsonl"))
  save()

  # 7. the SGA records, the aggregate, the saved latents evaluated again
  runner.run("itinf_to_results", os.path.join(scripts, "torch_itinf_to_results.py"),
             ["--itinf_glob", os.path.join(args.root, "itinf_xms", SGA_XID, "*"), "--out",
              os.path.join(args.out, "json")])
  runner.run("aggregate", os.path.join(scripts, "aggregate_results.py"),
             ["--results_glob", os.path.join(args.out, "json", "*.json"), "--out", args.out])
  copy = os.path.join(args.root, "itinf_recompute", SGA_XID, os.path.basename(sga_wd))
  shutil.rmtree(os.path.dirname(copy), ignore_errors=True)
  shutil.copytree(sga_wd, copy)
  runner.run("recompute", os.path.join(scripts, "torch_recompute_itinf_metrics.py"),
             ["--itinf_glob", os.path.join(os.path.dirname(copy), "*"), "--device", args.device])
  shutil.copy(os.path.join(copy, "metrics.json"), os.path.join(args.out, "sga_recomputed.json"))

  save()
  log(f"done in {run['seconds']:.0f} s; wrote {args.out}  [{smi}]")
  return run


if __name__ == "__main__":
  main()
