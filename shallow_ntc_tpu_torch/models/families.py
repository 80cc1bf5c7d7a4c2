"""The model families by name, and the model of a model_config (mirrors
shallow_ntc_tpu/train_lib.py:build_model_from_config)."""

import copy
from typing import Any, Dict, Mapping, Optional, Tuple

from torch import nn

from shallow_ntc_tpu_torch.models import base
from shallow_ntc_tpu_torch.models import factorized
from shallow_ntc_tpu_torch.models import mshyper

FAMILIES = {"mshyper": mshyper.Model, "factorized": factorized.Model}


def build_model(model_config: Mapping[str, Any], family: str,
                model_cls: Optional[type] = None) -> Tuple[nn.Module, Dict]:
  """(the family's Model of `model_config`, or model_cls's where given (the
  eval's --models_path); its optimizer_config); mixedq turns the offset
  heuristic off (base.effective_offset_heuristic)."""
  if model_cls is None and family not in FAMILIES:
    raise ValueError(f"unknown model family {family!r}: one of {sorted(FAMILIES)}")
  cfg = copy.deepcopy(dict(model_config))
  optimizer_config = cfg.pop("optimizer_config", None) or {}
  cfg["offset_heuristic"] = base.effective_offset_heuristic(cfg)
  return (model_cls or FAMILIES[family])(**cfg), optimizer_config


# Each family's train and itinf CLIs (python -m <module>), as the JAX
# package's shallow_ntc_tpu/<family>/train.py and itinf.py.
TRAIN_MODULES = {family: f"shallow_ntc_tpu_torch.{family}.train" for family in FAMILIES}
ITINF_MODULES = {family: f"shallow_ntc_tpu_torch.{family}.itinf" for family in FAMILIES}
