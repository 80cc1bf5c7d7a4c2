"""Model configurations of the port, as plain dicts.

TWO_LAYER_SYN is the model_config of shallow_ntc_tpu/mshyper/configs/
two_layer_syn.py (the paper's flagship: ELIC analysis + two-layer residual
synthesis), without the optimizer settings that only training reads.
TWO_LAYER_SYN_RD is the same model as two_layer_syn_rd.py trained it
(rd_lambda 0.01, 30k scheduled steps): the committed checkpoint's config.

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
MBT2018 mbt2018.py (Minnen 2018, 192 / 320). Each has the run name of its
JAX config at its defaults.

TRAIN_CONFIGS hold what the train CLI reads (model_family, model_config
with its optimizer_config, the data configs and train_eval_config):
  two_layer_syn_rd  mshyper/configs/two_layer_syn_rd.py; the dead-leaves set
                    is not in the repository, so the data are the synthetic
                    source (or a .npy glob given to the CLI); validation on
                    4 synthetic 256x256 images.
  jpegl_rd          mshyper/configs/jpegl_rd.py, on the same synthetic data;
  two_layer_syn2, mbt2018, bls2017, bls2017_rd   their config files, on the
                    same synthetic data;
  smoke             mshyper/configs/smoke.py's schedule (20 steps, lr 1e-3,
                    no warmup, B=2 64x64) with the flagship transforms at
                    narrow ELIC widths: for tests and CPU runs.

ITINF is mshyper/configs/itinf.py, SGA iterative inference on the flagship:
model_config is TWO_LAYER_SYN_RD with itinf.py's overrides (the SGA
relaxation, offset heuristic off, its optimizer), and train_eval_config its
schedule and transforms dtype. The Kodak set is not in the repository, so
data_config names the synthetic source (the itinf CLI takes --images), and
the warm-start keys are the CLI's weights flags. step_dispatch is a TPU
dispatch tactic that the port accepts and ignores. ITINF_FACTORIZED is the
same file's overrides on BLS2017_RD, as the JAX factorized itinf reads it.
"""

import copy

TWO_LAYER_SYN = dict(
    scheduled_num_steps=1_800_000,
    rd_lambda=0.08,
    transform_config=dict(
        analysis=dict(cls="ElicAnalysis", channels=(192, 192, 192, 320)),
        synthesis=dict(
            cls="TwoLayerResSynthesis",
            channels=(12, 3),
            strides=(8, 2),
            kernel_sizes=(13, 5),
            activation_type="igdn",
            res_type="conv",
        ),
    ),
    latent_config=dict(uq=dict(method="unoise")),
)

TWO_LAYER_SYN_RD = copy.deepcopy(TWO_LAYER_SYN)
TWO_LAYER_SYN_RD.update(scheduled_num_steps=30_000, rd_lambda=0.01)

# The hparams that the JAX eval parses back from the run name
# (mshyper-lmbda=0.01-num_steps=30000) into every result record.
TWO_LAYER_SYN_RD_RUNNAME = "mshyper-lmbda=0.01-num_steps=30000"

JPEGL_RD = dict(
    scheduled_num_steps=30_000,
    rd_lambda=0.01,
    transform_config=dict(
        analysis=dict(cls="ElicAnalysis", channels=(192, 192, 192, 320)),
        synthesis=dict(cls="JPEGLikeSynthesis", kernel_size=18, strides=16),
    ),
    latent_config=dict(uq=dict(method="unoise")),
)
# The run name of the JPEG-like R-D run (train_xms_rd/jpegl01/ and
# results/rd_deadleaves/mshyper-synthesis=jpegl-detailed.json).
JPEGL_RD_RUNNAME = "mshyper-synthesis=jpegl-lmbda=0.01-num_steps=30000"

JPEGL_K16 = copy.deepcopy(JPEGL_RD)
JPEGL_K16["transform_config"]["synthesis"] = dict(cls="JPEGLikeSynthesis", kernel_size=16,
                                                  strides=16, use_pallas=True)


BLS2017 = dict(
    scheduled_num_steps=1_800_000,
    rd_lambda=0.08,
    transform_config=dict(
        analysis=dict(cls="BLS2017Analysis", num_filters=256),
        synthesis=dict(cls="BLS2017Synthesis", num_filters=256),
    ),
)
BLS2017_RUNNAME = "factorized-lmbda=0.08-num_filters=256"

BLS2017_RD = dict(
    scheduled_num_steps=20_000,
    rd_lambda=0.02,
    transform_config=dict(
        analysis=dict(cls="BLS2017Analysis", num_filters=192),
        synthesis=dict(cls="BLS2017Synthesis", num_filters=192),
    ),
)
# The λ=0.02 run of the factorized R-D sweep (train_xms_rd/201b91d1/).
BLS2017_RD_RUNNAME = "factorized-lmbda=0.02-num_steps=20000"

TWO_LAYER_SYN2 = dict(
    scheduled_num_steps=1_800_000,
    rd_lambda=0.08,
    transform_config=dict(
        analysis=dict(cls="CNNAnalysis", channels_base=256, output_channels=320),
        synthesis=dict(cls="TwoLayerSynthesis", channels=(12, 3), strides=(8, 2),
                       kernel_sizes=(13, 5), activation_type="igdn"),
    ),
    latent_config=dict(uq=dict(method="mixedq")),
    offset_heuristic=False,
)
TWO_LAYER_SYN2_RUNNAME = ("mshyper-ana=CNNAnalysis-ana_cb=256-lmbda=0.08-hc=12-k1=13-k2=5-"
                          "act=igdn-uq=mixedq")

MBT2018 = dict(
    scheduled_num_steps=2_000_000,
    rd_lambda=0.08,
    transform_config=dict(
        analysis=dict(cls="MBT2018Analysis", channels_base=192, output_channels=320),
        synthesis=dict(cls="MBT2018Synthesis", channels_base=192, output_channels=3),
    ),
)
MBT2018_RUNNAME = "mshyper-lmbda=0.08-csize=320-channels_base=192"


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


_FLAGSHIP_OPTIMIZER = dict(learning_rate=1e-4, reduce_lr_after=0.8, reduce_lr_factor=0.1,
                           global_clipnorm=1.0)



def _synthetic_train_config(model_config, family, **train_eval_config):
  """A train config on the synthetic source: B=8 256x256 crops, validation on
  4 synthetic 256x256 images."""
  return dict(
      model_family=family,
      model_config=dict(copy.deepcopy(model_config), optimizer_config=dict(_FLAGSHIP_OPTIMIZER)),
      train_data_config=dict(dataset="synthetic", batchsize=8, patchsize=256),
      val_data_config=dict(dataset="synthetic", batchsize=1, patchsize=256),
      train_eval_config=dict(train_eval_config, max_validation_steps=4))


_RD_SCHEDULE = dict(log_metrics_every_steps=250, checkpoint_every_steps=5_000,
                    eval_every_steps=5_000)
_LONG_SCHEDULE = dict(log_metrics_every_steps=1000, checkpoint_every_steps=10_000,
                      eval_every_steps=10_000)

TRAIN_CONFIGS = {
    "two_layer_syn_rd": _synthetic_train_config(TWO_LAYER_SYN_RD, "mshyper", num_steps=30_000,
                                                **_RD_SCHEDULE),
    "jpegl_rd": _synthetic_train_config(JPEGL_RD, "mshyper", num_steps=30_000, **_RD_SCHEDULE),
    "two_layer_syn2": _synthetic_train_config(TWO_LAYER_SYN2, "mshyper", num_steps=1_800_000,
                                              **_LONG_SCHEDULE),
    "mbt2018": _synthetic_train_config(MBT2018, "mshyper", num_steps=2_000_000,
                                       **_LONG_SCHEDULE),
    "bls2017": _synthetic_train_config(BLS2017, "factorized", num_steps=1_800_000,
                                       **_LONG_SCHEDULE),
    "bls2017_rd": _synthetic_train_config(BLS2017_RD, "factorized", num_steps=20_000,
                                          **_RD_SCHEDULE),
    "smoke": dict(
        model_family="mshyper",
        model_config=dict(copy.deepcopy(TWO_LAYER_SYN_RD), scheduled_num_steps=20,
                          optimizer_config=dict(learning_rate=1e-3, warmup_until=0.0,
                                                global_clipnorm=1.0)),
        train_data_config=dict(dataset="synthetic", batchsize=2, patchsize=64),
        val_data_config=dict(dataset="synthetic", batchsize=2, patchsize=64),
        train_eval_config=dict(num_steps=20, log_metrics_every_steps=5,
                               checkpoint_every_steps=10, eval_every_steps=10,
                               max_validation_steps=2),
    ),
}
TRAIN_CONFIGS["smoke"]["model_config"]["transform_config"]["analysis"]["channels"] = (
    8, 8, 8, 16)

_ITINF_OVERRIDES = dict(
    scheduled_num_steps=3000,
    optimizer_config=dict(learning_rate=5e-3, reduce_lr_after=0.9, reduce_lr_factor=0.1,
                          global_clipnorm=None, warmup_until=0.0),
    latent_config=dict(uq=dict(method="sga", tau_r=5e-4, tau_ub=0.5, tau_t0=200)),
    offset_heuristic=False,
)


def _itinf_config(model_config, family):
  return dict(
      model_family=family,
      model_config=dict(copy.deepcopy(model_config), **copy.deepcopy(_ITINF_OVERRIDES)),
      data_config=dict(dataset="synthetic", batchsize=1, patchsize=None),
      train_eval_config=dict(num_steps=3000, log_metrics_every_steps=300,
                             eval_every_steps=3000, transforms_dtype="bfloat16",
                             step_dispatch="auto"))


ITINF = _itinf_config(TWO_LAYER_SYN_RD, "mshyper")
ITINF_FACTORIZED = _itinf_config(BLS2017_RD, "factorized")


def itinf_config(name: str):
  """The itinf CLI's --config (itinf | itinf_factorized), read at call time."""
  return {"itinf": ITINF, "itinf_factorized": ITINF_FACTORIZED}[name]
