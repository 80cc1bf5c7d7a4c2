"""Model configurations of the port, as plain dicts, read from the config
scripts under mshyper/configs/ and factorized/configs/ (copies of the JAX
package's), so that each has one source.

TWO_LAYER_SYN is the model_config of mshyper/configs/two_layer_syn.py (the
paper's flagship: ELIC analysis + two-layer residual synthesis), without
the optimizer settings that only training reads. TWO_LAYER_SYN_RD is
two_layer_syn_rd.py's (rd_lambda 0.01, 30k scheduled steps): the committed
checkpoint's config.

JPEGL_RD is the model_config of mshyper/configs/jpegl_rd.py: ELIC analysis
and the JPEG-like synthesis, one k18s16 deconv (the paper's third headline
method), rd_lambda 0.01, 30k scheduled steps. JPEGL_K16 is the same model
with a k16s16 synthesis and use_pallas=True: not a published configuration,
but the test configuration that reaches the jpegl_synthesize kernel, as
tests/test_pallas.py reaches the Pallas kernel (at k=18 the patches overlap
and the synthesis is a plain transposed conv).

The factorized family (Balle 2017, one latent under a deep-factorized
prior): BLS2017 is factorized/configs/bls2017.py (256 filters), BLS2017_RD
bls2017_rd.py (192 filters, rd_lambda 0.02, 20k steps: the λ=0.02 run of
the factorized R-D sweep). Two more mshyper configurations:
TWO_LAYER_SYN2 is mshyper/configs/two_layer_syn2.py (CNN analysis 256 ->
320, the non-residual TwoLayerSynthesis, mixedq, offset heuristic off) and
MBT2018 mbt2018.py (Minnen 2018, 192 / 320). Each *_RUNNAME is its
script's run name at its defaults (family + "-" + get_cfg_str).

TRAIN_CONFIGS hold what the fixed-name train CLI (train.py) reads: each
script's model_family, model_config with its optimizer_config and
train_eval_config, on the synthetic source (or a .npy glob given to the
CLI) at the script's batch and patch size, validated on 4 synthetic
256x256 images. "smoke" is mshyper/configs/smoke.py's schedule (20 steps,
lr 1e-3, no warmup, B=2 64x64) with the flagship transforms at narrow ELIC
widths: for tests and CPU runs. The experiment CLIs (mshyper/train.py and
the others) read the scripts themselves, with their own datasets.

ITINF is mshyper/configs/itinf.py, SGA iterative inference on the flagship:
model_config is TWO_LAYER_SYN_RD with itinf.py's overrides (the SGA
relaxation, offset heuristic off, its optimizer), and train_eval_config its
schedule and transforms dtype without the warm-start keys, which the
fixed-name itinf CLI (itinf.py) takes as its weights flags. data_config
names the synthetic source (the CLI takes --images). step_dispatch, the JAX
package's choice among its compiled SGA step programs, is accepted: every
value of it is the port's captured step on the card (step_graph.py).
ITINF_FACTORIZED is the
same file's overrides on BLS2017_RD, as the JAX factorized itinf reads it.
"""

import copy

from shallow_ntc_tpu_torch.factorized.configs import bls2017 as _bls2017
from shallow_ntc_tpu_torch.factorized.configs import bls2017_rd as _bls2017_rd
from shallow_ntc_tpu_torch.mshyper.configs import itinf as _itinf
from shallow_ntc_tpu_torch.mshyper.configs import jpegl_rd as _jpegl_rd
from shallow_ntc_tpu_torch.mshyper.configs import mbt2018 as _mbt2018
from shallow_ntc_tpu_torch.mshyper.configs import smoke as _smoke
from shallow_ntc_tpu_torch.mshyper.configs import two_layer_syn as _two_layer_syn
from shallow_ntc_tpu_torch.mshyper.configs import two_layer_syn2 as _two_layer_syn2
from shallow_ntc_tpu_torch.mshyper.configs import two_layer_syn_rd as _two_layer_syn_rd


def _model_config(script):
  """The script's model_config without the optimizer settings."""
  cfg = script.get_config()["model_config"]
  cfg.pop("optimizer_config")
  return cfg


def _runname(script):
  cfg = script.get_config()
  return cfg["model_family"] + "-" + script.get_cfg_str(cfg)


TWO_LAYER_SYN = _model_config(_two_layer_syn)
TWO_LAYER_SYN_RD = _model_config(_two_layer_syn_rd)
# The hparams that the eval parses back from the run name into every record.
TWO_LAYER_SYN_RD_RUNNAME = _runname(_two_layer_syn_rd)

JPEGL_RD = _model_config(_jpegl_rd)
# The run name of the JPEG-like R-D run (train_xms_rd/jpegl01/ and
# results/rd_deadleaves/mshyper-synthesis=jpegl-detailed.json).
JPEGL_RD_RUNNAME = _runname(_jpegl_rd)

JPEGL_K16 = copy.deepcopy(JPEGL_RD)
JPEGL_K16["transform_config"]["synthesis"] = dict(cls="JPEGLikeSynthesis", kernel_size=16,
                                                  strides=16, use_pallas=True)

BLS2017 = _model_config(_bls2017)
BLS2017_RUNNAME = _runname(_bls2017)
BLS2017_RD = _model_config(_bls2017_rd)
# The λ=0.02 run of the factorized R-D sweep (train_xms_rd/201b91d1/).
BLS2017_RD_RUNNAME = _runname(_bls2017_rd)

TWO_LAYER_SYN2 = _model_config(_two_layer_syn2)
TWO_LAYER_SYN2_RUNNAME = _runname(_two_layer_syn2)

MBT2018 = _model_config(_mbt2018)
MBT2018_RUNNAME = _runname(_mbt2018)


def _eval_configs():
  return {"two_layer_syn_rd": (TWO_LAYER_SYN_RD, TWO_LAYER_SYN_RD_RUNNAME, "mshyper"),
          "jpegl_rd": (JPEGL_RD, JPEGL_RD_RUNNAME, "mshyper"),
          "two_layer_syn2": (TWO_LAYER_SYN2, TWO_LAYER_SYN2_RUNNAME, "mshyper"),
          "mbt2018": (MBT2018, MBT2018_RUNNAME, "mshyper"),
          "bls2017": (BLS2017, BLS2017_RUNNAME, "factorized"),
          "bls2017_rd": (BLS2017_RD, BLS2017_RD_RUNNAME, "factorized")}


def eval_config(name: str):
  """(model_config, run name, model family) of an eval or codec CLI --config,
  read at call time."""
  return _eval_configs()[name]


EVAL_CONFIG_NAMES = tuple(_eval_configs())


def _synthetic_train_config(script):
  """The script's train config on the synthetic source: its batch and patch
  size, validation on 4 synthetic 256x256 images."""
  cfg = script.get_config()
  train_eval_config = dict(cfg["train_eval_config"])
  train_eval_config.setdefault("max_validation_steps", 4)
  return dict(
      model_family=cfg["model_family"],
      model_config=cfg["model_config"],
      train_data_config=dict(cfg["train_data_config"], dataset="synthetic"),
      val_data_config=dict(dataset="synthetic", batchsize=1, patchsize=256),
      train_eval_config=train_eval_config)


def _smoke_train_config():
  cfg = _smoke.get_config()
  model_config = dict(copy.deepcopy(TWO_LAYER_SYN_RD), scheduled_num_steps=20,
                      optimizer_config=cfg["model_config"]["optimizer_config"])
  model_config["transform_config"]["analysis"]["channels"] = (8, 8, 8, 16)
  return dict(cfg, model_config=model_config)


TRAIN_CONFIGS = {
    "two_layer_syn_rd": _synthetic_train_config(_two_layer_syn_rd),
    "jpegl_rd": _synthetic_train_config(_jpegl_rd),
    "two_layer_syn2": _synthetic_train_config(_two_layer_syn2),
    "mbt2018": _synthetic_train_config(_mbt2018),
    "bls2017": _synthetic_train_config(_bls2017),
    "bls2017_rd": _synthetic_train_config(_bls2017_rd),
    "smoke": _smoke_train_config(),
}


def _itinf_config(model_config, family):
  cfg = _itinf.get_config()
  train_eval_config = cfg["train_eval_config"]
  for key in ("warm_start_exp_dir", "warm_start_wid"):
    train_eval_config.pop(key)
  return dict(
      model_family=family,
      model_config=dict(copy.deepcopy(model_config), **cfg["model_config"]),
      data_config=dict(cfg["data_config"], dataset="synthetic"),
      train_eval_config=train_eval_config)


ITINF = _itinf_config(TWO_LAYER_SYN_RD, "mshyper")
ITINF_FACTORIZED = _itinf_config(BLS2017_RD, "factorized")


def itinf_config(name: str):
  """The itinf CLI's --config (itinf | itinf_factorized), read at call time."""
  return {"itinf": ITINF, "itinf_factorized": ITINF_FACTORIZED}[name]
