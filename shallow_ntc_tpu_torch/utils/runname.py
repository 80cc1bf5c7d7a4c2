"""Run names and run bookkeeping (mirrors shallow_ntc_tpu/utils/runname.py).

A run name encodes hparams as `key=value` segments, and the eval parses them
back into every result record, so both directions must round-trip. The
experiment id (xid) and work-unit id (wid) come from the same SLURM_*
variables as in the JAX package.
"""

import datetime
import json
import os
import re
import socket
import subprocess
import sys
from collections import OrderedDict

import numpy as np


def config_dict_to_str(cfg, record_keys=None, skip_falsy=True, prefix=None, args_abbr=None,
                       primary_delimiter="-", secondary_delimiter="_"):
  """Encode a flat dict of hparams as a run name string."""
  if args_abbr is None:
    from shallow_ntc_tpu_torch import project_configs

    args_abbr = project_configs.args_abbr
  kv_strs = []
  if record_keys is None:
    record_keys = iter(cfg)
  for key in record_keys:
    val = cfg[key]
    if skip_falsy and not val:
      continue
    if isinstance(val, (list, tuple)):
      val_str = secondary_delimiter.join(map(str, val))
    else:
      val_str = str(val)
    if args_abbr:
      key = args_abbr.get(key, key)
    kv_strs.append(f"{key}={val_str}")
  substrs = ([prefix] if prefix else []) + kv_strs
  return primary_delimiter.join(substrs)


def parse_runname(s, parse_numbers=False):
  """Recover key=value pairs from a run name.

  >>> list(parse_runname('dir-lamb=2-arch=2_4_8/tau=1.0-step=0').items())
  [('lamb', '2'), ('arch', '2_4_8'), ('tau', '1.0'), ('step', '0')]
  """
  sequence_delimiter = "_"
  pattern = (rf"(\w+)=((\d+{sequence_delimiter})+\d+"
             r"|(-?\d*\.?\d+(?:e[+-]?\d+)?)+|\w+)")
  res = OrderedDict()
  for match in re.finditer(pattern, s):
    key = match.group(1)
    val = match.group(2)
    if match.group(3) is not None:
      if parse_numbers:
        val = tuple(map(int, val.split(sequence_delimiter)))
    elif parse_numbers:
      try:
        fval = float(val)
        val = int(fval) if fval == int(fval) else fval
      except ValueError:
        pass
    res[key] = val
  return res


def get_time_str(strftime_format="%Y,%m,%d,%H%M%S"):
  return datetime.datetime.now().strftime(strftime_format)


def get_xid():
  """Experiment id from the scheduler's environment, else a timestamp."""
  for var in ("SLURM_ARRAY_JOB_ID", "SLURM_JOB_ID"):
    xid = os.environ.get(var)
    if xid:
      return xid
  return get_time_str()


def get_wid():
  """Work-unit id from the scheduler's environment, or None."""
  return os.environ.get("SLURM_ARRAY_TASK_ID", None)


def get_git_revision_short_hash():
  try:
    return subprocess.check_output(["git", "rev-parse", "--short", "HEAD"],
                                   stderr=subprocess.DEVNULL).decode("ascii").strip()
  except (OSError, subprocess.CalledProcessError):
    return "unknown"


def log_run_info(workdir):
  """Write the command line, git hash and host name to <workdir>/run_info.json."""
  run_info = {
      "cmdline": " ".join(sys.argv),
      "most_recent_version": get_git_revision_short_hash(),
      "host_name": socket.gethostname(),
  }
  for env_var in ("SLURM_JOB_ID", "SLURM_ARRAY_JOB_ID"):
    if env_var in os.environ:
      run_info[env_var] = os.environ[env_var]
  with open(os.path.join(workdir, "run_info.json"), "w") as f:
    json.dump(run_info, f, indent=2)


class MyJSONEncoder(json.JSONEncoder):
  """JSON encoder that also takes numpy scalars and arrays (and tensors)."""

  def default(self, obj):
    if isinstance(obj, np.integer):
      return int(obj)
    if isinstance(obj, np.floating):
      return float(obj)
    if isinstance(obj, np.ndarray):
      return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
      return obj.item()
    if hasattr(obj, "tolist"):
      return obj.tolist()
    return super().default(obj)


def load_json(path):
  with open(path, "r") as f:
    return json.load(f)


def dump_json(obj, path):
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, "w") as f:
    json.dump(obj, f, indent=2, cls=MyJSONEncoder)
