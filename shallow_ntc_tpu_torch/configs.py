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

TRAIN_CONFIGS hold what the train CLI reads (model_config with its
optimizer_config, the data configs and train_eval_config):
  two_layer_syn_rd  mshyper/configs/two_layer_syn_rd.py; the dead-leaves set
                    is not in the repository, so the data are the synthetic
                    source (or a .npy glob given to the CLI); validation on
                    4 synthetic 256x256 images.
  jpegl_rd          mshyper/configs/jpegl_rd.py, on the same synthetic data.
  smoke             mshyper/configs/smoke.py's schedule (20 steps, lr 1e-3,
                    no warmup, B=2 64x64) with the flagship transforms at
                    narrow ELIC widths: for tests and CPU runs.

ITINF is mshyper/configs/itinf.py, SGA iterative inference on the flagship:
model_config is TWO_LAYER_SYN_RD with itinf.py's overrides (the SGA
relaxation, offset heuristic off, its optimizer), and train_eval_config its
schedule and transforms dtype. The Kodak set is not in the repository, so
data_config names the synthetic source (the itinf CLI takes --images), and
the warm-start keys are the CLI's weights flags. step_dispatch is a TPU
dispatch tactic that the port accepts and ignores.
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


def eval_config(name: str):
  """(model_config, run name) of an eval CLI --config, read at call time."""
  return {"two_layer_syn_rd": (TWO_LAYER_SYN_RD, TWO_LAYER_SYN_RD_RUNNAME),
          "jpegl_rd": (JPEGL_RD, JPEGL_RD_RUNNAME)}[name]


_FLAGSHIP_OPTIMIZER = dict(learning_rate=1e-4, reduce_lr_after=0.8, reduce_lr_factor=0.1,
                           global_clipnorm=1.0)

TRAIN_CONFIGS = {
    "two_layer_syn_rd": dict(
        model_config=dict(copy.deepcopy(TWO_LAYER_SYN_RD),
                          optimizer_config=dict(_FLAGSHIP_OPTIMIZER)),
        train_data_config=dict(dataset="synthetic", batchsize=8, patchsize=256),
        val_data_config=dict(dataset="synthetic", batchsize=1, patchsize=256),
        train_eval_config=dict(num_steps=30_000, log_metrics_every_steps=250,
                               checkpoint_every_steps=5_000, eval_every_steps=5_000,
                               max_validation_steps=4),
    ),
    "jpegl_rd": dict(
        model_config=dict(copy.deepcopy(JPEGL_RD), optimizer_config=dict(_FLAGSHIP_OPTIMIZER)),
        train_data_config=dict(dataset="synthetic", batchsize=8, patchsize=256),
        val_data_config=dict(dataset="synthetic", batchsize=1, patchsize=256),
        train_eval_config=dict(num_steps=30_000, log_metrics_every_steps=250,
                               checkpoint_every_steps=5_000, eval_every_steps=5_000,
                               max_validation_steps=4),
    ),
    "smoke": dict(
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

ITINF = dict(
    model_config=dict(
        copy.deepcopy(TWO_LAYER_SYN_RD),
        scheduled_num_steps=3000,
        optimizer_config=dict(learning_rate=5e-3, reduce_lr_after=0.9, reduce_lr_factor=0.1,
                              global_clipnorm=None, warmup_until=0.0),
        latent_config=dict(uq=dict(method="sga", tau_r=5e-4, tau_ub=0.5, tau_t0=200)),
        offset_heuristic=False,
    ),
    data_config=dict(dataset="synthetic", batchsize=1, patchsize=None),
    train_eval_config=dict(num_steps=3000, log_metrics_every_steps=300, eval_every_steps=3000,
                           transforms_dtype="bfloat16", step_dispatch="auto"),
)
