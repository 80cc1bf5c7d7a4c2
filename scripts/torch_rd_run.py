#!/usr/bin/env python
"""R-D points through the PyTorch port on one GPU, from the data to the R-D
table: the port's counterpart of scripts/run_rd_sweep.sh, for any of its
config scripts and rd_lambda values.

  python scripts/torch_rd_run.py [--config two_layer_syn_rd|bls2017_rd|jpegl_rd]
      [--hids 3 | 0-6 | 0,3] [--root rd_run] [--out results/torch_rd_deadleaves]

With no flags it runs the flagship's point at rd_lambda 0.01
(two_layer_syn_rd.py --hid 3). --config names one of the sweep scripts
(CONFIGS); its model_family picks the train and itinf CLIs
(models/families.py); --hids the entries of its get_hyper() sweep, run one
after the other. Each step is the port's own CLI in a process of its own:
  1. data      python -m shallow_ntc_tpu_torch.deadleaves, once per --root:
               the JAX run's set, 1200 train PNGs at 320x320, 4 valid and 24
               eval at 512x768;
then for each point (work unit wid=<hid> of the experiment CONFIGS names):
  2. train     the family's train CLI with the config and --hid, the
               residual-block kernel off (run_point says why). Where --deadline_s
               would not leave --reserve_s after the next val pass (at the
               rate of the last interval), the run is stopped just after a val
               pass and its checkpoint, and the rest uses that checkpoint;
  3. eval      python -m shallow_ntc_tpu_torch.eval --workdir on the 24 eval
               images, into --out/json/ (a run stopped before its num_steps:
               into --out/<config>_hid<N>/, out of the aggregate, and its
               SGA JSON too);
  4. codec     scripts/torch_measure_codec_overhead.py on 8 of them;
  5. int8      scripts/torch_int8_quality.py on all 24, with the
               hyper-decoder's int8 ranges (--ranges) for the mshyper family;
               with --keep_checkpoints also on every checkpoint the run wrote
               (the train CLI's --max_to_keep 0), and for the mshyper family
               each pass writes its --save_hyper .npz under --root
               (hyper/<config>_hid<N>/step=<n>.npz), of which the final
               checkpoint's stays and that of the first checkpoint whose
               int8_all bpp exceeds float's by more than DEPART_BPP;
  6. curves    scripts/collect_train_curves.py and the basis functions
               (scripts/torch_vis_syn_filters.py);
  7. SGA       for the configs whose SGA run_rd_sweep.sh runs
               (two_layer_syn_rd): python -m shallow_ntc_tpu_torch.mshyper
               .itinf with mshyper/configs/itinf.py warm-started by wid, 3
               batches of 8 eval images, 3000 steps, float32 transforms, a val
               pass every 200 steps (the JAX run's settings); then
               scripts/torch_itinf_to_results.py into --out/json/ and
               scripts/torch_recompute_itinf_metrics.py on a copy of the SGA
               workdir.
Every step but training runs the flagship's ELIC blocks through the
residual-block kernel (SNTC_FUSED_RB_CHAIN=1).
Then scripts/aggregate_results.py over every JSON in --out/json/ rebuilds
--out/aggregate.json and its -detailed.json files.

A point whose eval JSON is already in --out/json/ is skipped (run_rd_sweep.sh's
idempotency), so a sweep can span calls that share --out. No point starts
that the last point's seconds say cannot end before --deadline_s less
--reserve_s. Each point's files go to --out/<config>_hid<N>/: run.json (the
step reached, each step's seconds and kernel launches, the card, the stages
skipped and why, the .npz saved), train_record.jsonl, val_record.jsonl,
codec_overhead.json, int8_quality.json (and int8_quality_step=<n>.json of
each kept checkpoint), train_curves.json, basis.png and for SGA
sga_metrics.json, each SGA batch's records and sga_recomputed.json. --out/runs.json names every
point's run.json. The workdirs (checkpoints included) stay under --root.
--seed N (default 0) seeds the training's init, data and noise (the train
CLI's --seed, JAX's train_and_eval seed); a seed other than 0 gives the
point its own experiment ids (<xid>_seed<N>), so give it its own --out too.
The SGA draws stay seeded 0, as the JAX run's. run.json also records how
the train and SGA steps were issued (each CLI's step_dispatch.json: a CUDA
graph a step on the card, by default). Dot overrides for the train and SGA
CLIs (--train_override, --sga_override; repeatable) and
--num_train/--num_eval cut a rehearsal short; --skip leaves out stages;
--device cpu runs it on the CPU.
"""

import argparse
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Config name -> (its script, the experiment id of its training, of its SGA or
# None where run_rd_sweep.sh runs no SGA). results/rd_deadleaves holds SGA of
# the flagship's points only, and itinf_to_results names a record
# <family>+sga, which a jpegl_rd point would share with the flagship's.
_CONFIGS_DIR = os.path.join(REPO, "shallow_ntc_tpu_torch", "{}", "configs", "{}.py")
CONFIGS = {
    "two_layer_syn_rd": (_CONFIGS_DIR.format("mshyper", "two_layer_syn_rd"), "torchrd",
                         "torchrd_sga"),
    "bls2017_rd": (_CONFIGS_DIR.format("factorized", "bls2017_rd"), "torchrd_bls2017_rd", None),
    "jpegl_rd": (_CONFIGS_DIR.format("mshyper", "jpegl_rd"), "torchrd_jpegl_rd", None),
}
SGA_STAGES = ("sga", "itinf_to_results", "recompute")
STAGES = ("eval", "codec_overhead", "int8_quality", "train_curves", "basis", *SGA_STAGES)
GATES = ("SNTC_FUSED_RB_CHAIN", "SNTC_FUSED_RESBLOCK", "SNTC_INT8_DECODE", "SNTC_INT8_ENCODE")
DEPART_BPP = 0.2  # int8_all's mean bpp over float's at which the hyper-decoder departs


def log(msg):
  print(f"[torch_rd_run {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def read_jsonl(path):
  if not os.path.isfile(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def dump(obj, path):
  with open(path, "w") as f:
    json.dump(obj, f, indent=1)


def parse_hids(text):
  """'3' -> [3]; '0-6' -> [0..6]; '0,3,5-6' -> [0, 3, 5, 6]."""
  hids = []
  for part in text.split(","):
    lo, _, hi = part.partition("-")
    hids.extend(range(int(lo), int(hi or lo) + 1))
  return hids


class Runner:
  """Starts each command in its own process under
  shallow_ntc_tpu_torch.utils.counted from `cwd`, keeps its log and launch
  counts under `logs`, and its seconds and launches in `steps`."""

  def __init__(self, cwd, logs, env):
    self.cwd, self.logs, self.env = cwd, logs, env
    self.steps = {}
    os.makedirs(logs, exist_ok=True)

  def argv(self, name, target, args):
    return [sys.executable, "-m", "shallow_ntc_tpu_torch.utils.counted",
            os.path.join(self.logs, f"{name}.counts"), target, *args]

  def finish(self, name, t, returncode):
    with open(os.path.join(self.logs, f"{name}.counts")) as f:
      counts = json.load(f)
    self.steps[name] = dict(seconds=time.time() - t, launches=counts, returncode=returncode)
    log(f"{name}: {self.steps[name]}")
    return counts

  def run(self, name, target, args, timeout=1800, **extra_env):
    t = time.time()
    proc = subprocess.run(self.argv(name, target, args), cwd=self.cwd,
                          env=dict(self.env, **extra_env), timeout=timeout,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with open(os.path.join(self.logs, f"{name}.log"), "w") as f:
      f.write(proc.stdout)
    if proc.returncode:
      print(proc.stdout[-6000:], file=sys.stderr, flush=True)
      raise RuntimeError(f"{name} exited with {proc.returncode}")
    self.finish(name, t, proc.returncode)
    return proc.stdout


class Point:
  """One work unit: config `name`, sweep entry `hid`, its resolved config
  (the train overrides applied), family, run name and experiment ids."""

  def __init__(self, name, hid, train_override, seed=0):
    from shallow_ntc_tpu_torch.utils import cli
    from shallow_ntc_tpu_torch.utils import config as config_lib

    self.name, self.hid = name, hid
    self.script, self.xid, self.sga_xid = CONFIGS[name]
    self.seed = seed
    if seed:
      self.xid = f"{self.xid}_seed{seed}"
      self.sga_xid = self.sga_xid and f"{self.sga_xid}_seed{seed}"
    _, overrides = config_lib.split_overrides([f"--config.{o}" for o in train_override])
    self.cfg = config_lib.resolve_config(self.script, overrides, hid)
    self.family = self.cfg["model_family"]
    self.runname = cli.get_runname(self.cfg, self.script, self.family)
    self.key = f"{name}_hid{hid}"

  def eval_jsons(self, out):
    return sorted(glob.glob(os.path.join(out, "json", f"{glob.escape(self.runname)}-step=*"
                                         f"-xid={self.xid}.json")))


def keep_checkpoints(workdir, kept):
  """Hard-link each checkpoint under `workdir` into kept/step=<n>/ beside a
  copy of config.json, a workdir of that one checkpoint (the CLIs load a
  workdir's newest)."""
  from shallow_ntc_tpu_torch import train_lib

  ckpts = train_lib.checkpoint_dir(workdir)
  names = os.listdir(ckpts) if os.path.isdir(ckpts) else []
  for m in filter(None, map(re.compile(r"ckpt_(\d+)\.pt$").match, names)):
    dst = os.path.join(kept, f"step={m.group(1)}")
    if os.path.isdir(dst):
      continue
    tmp = train_lib.checkpoint_dir(dst + ".tmp")
    os.makedirs(tmp, exist_ok=True)
    try:
      os.link(os.path.join(ckpts, m.group(0)), os.path.join(tmp, m.group(0)))
    except FileNotFoundError:  # replaced by a newer one meanwhile
      shutil.rmtree(dst + ".tmp")
      continue
    shutil.copy(os.path.join(workdir, "config.json"), dst + ".tmp")
    os.replace(dst + ".tmp", dst)
    log(f"kept the checkpoint of step {m.group(1)} in {dst}")


def train(runner, args, point, exp, env):
  """Step 2: the train CLI, stopped after a val pass where the next one would
  not leave args.reserve_s before args.deadline_s. Returns (its workdir
  under the experiment directory `exp`, why the run ended)."""
  from shallow_ntc_tpu_torch.models import families

  cmd = runner.argv("train", families.TRAIN_MODULES[point.family],
                    ["--config", point.script, "--hid", str(point.hid), "--experiments_dir",
                     os.path.dirname(exp), "--device", args.device, "--seed", str(point.seed),
                     *(["--max_to_keep", "0"] if args.keep_checkpoints else []),
                     *(f"--config.{o}" for o in args.train_override)])
  kept = os.path.join(args.root, "kept", point.key) if args.keep_checkpoints else None
  t = time.time()
  with open(os.path.join(runner.logs, "train.log"), "w") as out:
    proc = subprocess.Popen(cmd, cwd=args.root, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
      last_val, t_last, reason, next_report = 0, t, "finished", t + 300
      workdir = None
      while proc.poll() is None:
        time.sleep(5)
        now = time.time()
        workdir = workdir or next(iter(glob.glob(os.path.join(exp, f"wid={point.hid}-*"))), None)
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
          if step < te_cfg["num_steps"] and now + gap > args.t0 + args.deadline_s - args.reserve_s:
            reason = (f"stopped after the val pass of step {step}: the next would end "
                      f"{now + gap - args.t0:.0f} s into the run, past {args.deadline_s} - "
                      f"{args.reserve_s} s")
            break
        if now > args.t0 + args.deadline_s - args.reserve_s:
          reason = f"stopped at the deadline, {now - args.t0:.0f} s into the run"
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
    with open(os.path.join(runner.logs, "train.log")) as f:
      print(f.read()[-6000:], file=sys.stderr, flush=True)
    raise RuntimeError(f"train exited with {proc.returncode}")
  runner.finish("train", t, proc.returncode)
  (workdir,) = glob.glob(os.path.join(exp, f"wid={point.hid}-*"))
  if kept:
    keep_checkpoints(workdir, kept)
  return workdir, reason


def departed_step(records):
  """The first step of `records` ({step: its int8 quality JSON}) whose
  record gives int8_all a mean bpp more than DEPART_BPP above float's, or
  None."""
  for n in sorted(records):
    with open(records[n]) as f:
      if json.load(f)["summary"]["bpp"]["all_delta"] > DEPART_BPP:
        return n
  return None


def read_json(path):
  """The JSON at `path`, or None where there is no file."""
  if not os.path.isfile(path):
    return None
  with open(path) as f:
    return json.load(f)


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


def skipped_stages(args, point):
  """{stage: why} of the stages this point leaves out."""
  skipped = {s: "--skip" for s in args.skip}
  if point.sga_xid is None:
    skipped.update({s: f"run_rd_sweep.sh runs no SGA of {point.name}" for s in SGA_STAGES})
  elif "sga" in args.skip:
    skipped.update({s: "--skip sga" for s in SGA_STAGES if s not in skipped})
  return skipped


def run_point(args, point, base_env, smi):
  """Steps 2-7 of one point; returns its record (also in <out>/<key>/run.json)."""
  from shallow_ntc_tpu_torch import train_lib

  t_point = time.time()
  dest = os.path.join(args.out, point.key)
  os.makedirs(dest, exist_ok=True)
  env = dict(base_env, SLURM_ARRAY_JOB_ID=point.xid, SLURM_ARRAY_TASK_ID=str(point.hid))
  runner = Runner(args.root, os.path.join(args.root, "logs", point.key), env)
  # The flagship's ELIC blocks run through the residual-block kernel in every
  # step but training: the kernel's backward recomputes the blocks through
  # cuDNN, so at the train CLI's TF32 the step is faster without it
  # (scripts/torch_train_profile.py --tf32, chip_smoke.py "timing"), and the
  # JAX package's sweep trains without its Pallas chain too.
  chain = dict(SNTC_FUSED_RB_CHAIN="1") if point.family == "mshyper" else {}
  skipped = skipped_stages(args, point)
  run = dict(config=point.name, hid=point.hid, family=point.family, runname=point.runname,
             xid=point.xid, seed=point.seed, card=smi, argv=args.argv, skipped=skipped)

  def save():
    run.update(steps=runner.steps, seconds=time.time() - t_point)
    dump(run, os.path.join(dest, "run.json"))

  exp = os.path.join(args.root, "train_xms", point.xid)
  workdir, reason = train(runner, args, point, exp, env)
  step = train_lib.latest_checkpoint_step(workdir)
  vals = read_jsonl(os.path.join(workdir, "val", "record.jsonl"))
  rows = read_jsonl(os.path.join(workdir, "train", "record.jsonl"))
  run.update(workdir=os.path.relpath(workdir, args.root), checkpoint_step=step,
             last_val_step=vals[-1]["step"] if vals else None, train_end=reason,
             train_dispatch=read_json(os.path.join(workdir, "step_dispatch.json")),
             train_step_ms=[1e3 / r["steps_per_sec"] for r in rows])
  log(f"{point.key}: trained to the checkpoint of step {step} ({reason}); val rows at "
      f"{[v['step'] for v in vals]}")
  if step is None:
    raise RuntimeError("the run reached no checkpoint")
  # A run stopped before its num_steps is not the point's: its eval and SGA
  # JSONs go beside its records, out of the aggregate, and a later call
  # trains the point again.
  results_dir = os.path.join(args.out, "json")
  if step < point.cfg["train_eval_config"]["num_steps"]:
    results_dir = dest
    log(f"{point.key}: step {step} is short of num_steps; its eval and SGA JSONs go to {dest}")
  for name in ("train", "val"):
    shutil.copy(os.path.join(workdir, name, "record.jsonl"),
                os.path.join(dest, f"{name}_record.jsonl"))
  save()

  scripts = os.path.join(REPO, "scripts")
  dev = ["--device", args.device]
  if "eval" not in skipped:
    runner.run("eval", "shallow_ntc_tpu_torch.eval",
               ["--workdir", workdir, "--dataset", "deadleaves_eval", "--results_dir",
                results_dir, *dev], **chain)
  if "codec_overhead" not in skipped:
    runner.run("codec_overhead", os.path.join(scripts, "torch_measure_codec_overhead.py"),
               ["--workdir", workdir, "--dataset", "deadleaves_eval", "--max_images",
                str(args.codec_images), "--out", os.path.join(dest, "codec_overhead.json"), *dev],
               **chain)
  if "int8_quality" not in skipped:
    mshyper = point.family == "mshyper"
    ranges = ["--ranges"] if mshyper else []
    kept_root = os.path.join(args.root, "kept", point.key)
    kept = sorted(int(d.rsplit("=", 1)[1]) for d in glob.glob(
        os.path.join(kept_root, "step=*"))) if args.keep_checkpoints else []
    if kept and kept[-1] != step:
      raise RuntimeError(f"the newest kept checkpoint is of step {kept[-1]}, not {step}")
    # Each pass on a kept checkpoint of the mshyper family saves its
    # hyper-decoder (under --root); the final one's stays, and the first
    # departed one's.
    saving = mshyper and bool(kept)
    hyper = os.path.join(args.root, "hyper", point.key)
    records, saves = {}, {}
    for n in kept[:-1] + [step]:
      final = n == step
      records[n] = os.path.join(dest, "int8_quality.json" if final
                                else f"int8_quality_step={n}.json")
      extra = []
      if saving:
        os.makedirs(hyper, exist_ok=True)
        saves[n] = os.path.join(hyper, f"step={n}.npz")
        extra = ["--save_hyper", saves[n]]
      runner.run("int8_quality" if final else f"int8_quality_step={n}",
                 os.path.join(scripts, "torch_int8_quality.py"),
                 ["--workdir", workdir if final else os.path.join(kept_root, f"step={n}"),
                  "--dataset", "deadleaves_eval", "--out", records[n], *ranges, *extra, *dev],
                 **chain)
    if saving:
      departed = departed_step(records)
      for n in [n for n in saves if n not in (departed, step)]:
        os.remove(saves.pop(n))
      run.update(departed_step=departed, hyper_saves={
          str(n): os.path.relpath(p, args.root) for n, p in sorted(saves.items())})
  if "train_curves" not in skipped:
    runner.run("train_curves", os.path.join(scripts, "collect_train_curves.py"),
               ["--workdirs_glob", glob.escape(workdir), "--out",
                os.path.join(dest, "train_curves.json")])
  if "basis" not in skipped:
    runner.run("basis", os.path.join(scripts, "torch_vis_syn_filters.py"),
               ["--workdir", workdir, "--out", os.path.join(dest, "basis.png"), *dev])
  save()

  if "sga" not in skipped:
    from shallow_ntc_tpu_torch.models import families

    te = "--config.train_eval_config."
    sga_env = dict(chain, SLURM_ARRAY_JOB_ID=point.sga_xid)
    runner.run("sga", families.ITINF_MODULES[point.family],
               ["--config", os.path.join(REPO, "shallow_ntc_tpu_torch", "mshyper", "configs",
                                         "itinf.py"),
                "--hid", str(point.hid), f"{te}warm_start_exp_dir={exp}",
                "--config.data_config.dataset=deadleaves_eval",
                "--config.data_config.batchsize=8", f"{te}transforms_dtype=float32",
                f"{te}log_metrics_every_steps=100", f"{te}eval_every_steps=200",
                "--experiments_dir", os.path.join(args.root, "itinf_xms"), *dev,
                *(f"--config.{o}" for o in args.sga_override)],
               timeout=3600, **sga_env)
    (sga_wd,) = glob.glob(os.path.join(args.root, "itinf_xms", point.sga_xid,
                                       f"wid={point.hid}-*"))
    shutil.copy(os.path.join(sga_wd, "metrics.json"), os.path.join(dest, "sga_metrics.json"))
    run.update(sga_dispatch=read_json(os.path.join(sga_wd, "step_dispatch.json")))
    for d in sorted(glob.glob(os.path.join(sga_wd, "batch_id=*"))):
      for name in ("train", "val"):
        shutil.copy(os.path.join(d, name, "record.jsonl"),
                    os.path.join(dest, f"sga_{os.path.basename(d)}_{name}_record.jsonl"))
    save()
    if "itinf_to_results" not in skipped:
      runner.run("itinf_to_results", os.path.join(scripts, "torch_itinf_to_results.py"),
                 ["--itinf_glob", glob.escape(sga_wd), "--out", results_dir])
    if "recompute" not in skipped:
      copy = os.path.join(args.root, "itinf_recompute", point.sga_xid,
                          os.path.basename(sga_wd))
      shutil.rmtree(copy, ignore_errors=True)
      shutil.copytree(sga_wd, copy)
      runner.run("recompute", os.path.join(scripts, "torch_recompute_itinf_metrics.py"),
                 ["--itinf_glob", glob.escape(copy), *dev])
      shutil.copy(os.path.join(copy, "metrics.json"), os.path.join(dest, "sga_recomputed.json"))
  save()
  log(f"{point.key}: done in {run['seconds']:.0f} s; wrote {dest}")
  return run


def main(argv=None):
  t0 = time.time()
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--config", default="two_layer_syn_rd", choices=sorted(CONFIGS),
                 help="the sweep script")
  p.add_argument("--hids", default="3", help="sweep entries: 3, 0-6 or 0,3")
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
  p.add_argument("--skip", default="", help=f"comma-separated stages to leave out: {STAGES}")
  p.add_argument("--keep_checkpoints", action="store_true",
                 help="keep every checkpoint of the run and take int8 quality of each")
  p.add_argument("--device", default="cuda", help="the device of every CLI")
  p.add_argument("--seed", type=int, default=0,
                 help="seed of the training's init, data and noise (its own xids unless 0)")
  args = p.parse_args(argv)
  args.t0, args.argv = t0, sys.argv[1:] if argv is None else list(argv)
  args.skip = [s for s in args.skip.split(",") if s]
  unknown = set(args.skip) - set(STAGES)
  if unknown:
    p.error(f"unknown stages {sorted(unknown)}: the stages are {STAGES}")
  from shallow_ntc_tpu_torch import eval_lib

  eval_lib.resolve_device(args.device)  # no CUDA: raise before any work
  args.root, args.out = os.path.abspath(args.root), os.path.abspath(args.out)
  os.makedirs(args.root, exist_ok=True)
  os.makedirs(os.path.join(args.out, "json"), exist_ok=True)
  points = [Point(args.config, hid, args.train_override, args.seed)
            for hid in parse_hids(args.hids)]
  smi = smi_line()
  log(f"card: {smi}; {args.config} hids {[pt.hid for pt in points]}")
  env = dict(os.environ, PYTHONPATH=REPO, SHALLOW_NTC_PROJECT_DIR=args.root)
  for gate in GATES:
    env.pop(gate, None)

  # 1. data, once per root, where a point is still to run
  data = os.path.join(args.root, "data", "deadleaves")
  marker = os.path.join(data, "made.json")
  made = dict(num_train=args.num_train, num_valid=4, num_eval=args.num_eval)
  if all(pt.eval_jsons(args.out) for pt in points):
    log("data: not needed, every point's eval is in --out")
  elif os.path.isfile(marker) and json.load(open(marker)) == made:
    log(f"data: {data} already holds {made}")
  else:
    Runner(args.root, os.path.join(args.root, "logs"), env).run(
        "data", "shallow_ntc_tpu_torch.deadleaves",
        ["--out", data, "--num_train", str(args.num_train), "--num_valid", "4", "--num_eval",
         str(args.num_eval)])
    dump(made, marker)

  # 2-7. the points
  index_path = os.path.join(args.out, "runs.json")
  index = json.load(open(index_path)) if os.path.isfile(index_path) else {}
  done, last_seconds, stop = [], None, None
  for point in points:
    if point.eval_jsons(args.out):
      log(f"{point.key}: skipped, its eval is in {point.eval_jsons(args.out)[-1]}")
      continue
    left = t0 + args.deadline_s - args.reserve_s - time.time()
    if last_seconds is not None and last_seconds > left:
      stop = (f"stopped before {point.key}: the last point took {last_seconds:.0f} s and "
              f"{left:.0f} s are left before {args.deadline_s} - {args.reserve_s} s")
      log(stop)
      break
    run = run_point(args, point, env, smi)
    last_seconds = run["seconds"]
    done.append(point.key)
    index[point.key] = os.path.join(point.key, "run.json")
    dump(index, index_path)

  # The aggregate over every point's JSONs in --out, this call's and earlier
  # ones'. aggregate_results.py imports neither package, so it runs as it is,
  # without the launch counts (and the torch import) of the other steps.
  if glob.glob(os.path.join(args.out, "json", "*.json")):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "aggregate_results.py"), "--results_glob",
         os.path.join(args.out, "json", "*.json"), "--out", args.out], cwd=args.root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    if proc.returncode:
      print(proc.stdout[-6000:], file=sys.stderr, flush=True)
      raise RuntimeError(f"aggregate_results.py exited with {proc.returncode}")
    log(f"aggregate: {proc.stdout.strip()}")
  log(f"done in {time.time() - t0:.0f} s: ran {done}{'; ' + stop if stop else ''}; "
      f"wrote {args.out}  [{smi}]")
  return dict(ran=done, stopped=stop, seconds=time.time() - t0)


if __name__ == "__main__":
  main()
