"""Hyperparameter sweep combinators (a copy of shallow_ntc_tpu/utils/hyper.py).

Sweeps are lists of flat {dotted.key: value} dicts; each entry is one work
unit, selected by --hid in the train and itinf CLIs.
"""

import itertools


def sweep(key, vals):
  """One work unit per value of `key`."""
  return [{key: v} for v in vals]


def izip(*sweeps):
  """Element-wise zip of sweeps (all must have equal length)."""
  lengths = {len(s) for s in sweeps}
  if len(lengths) != 1:
    raise ValueError(f"izip requires equal-length sweeps, got {lengths}")
  return [{k: v for d in dicts for (k, v) in d.items()} for dicts in zip(*sweeps)]


def product(*sweeps):
  """Cartesian product of sweeps."""
  out = []
  for dicts in itertools.product(*sweeps):
    merged = {}
    for d in dicts:
      merged.update(d)
    out.append(merged)
  return out
