"""The JPEG-like synthesis on the dead-leaves corpus: the budgeted R-D run
(30k steps, the paper's seven rd_lambda values).

A copy of shallow_ntc_tpu/mshyper/configs/jpegl_rd.py with plain dicts: the same
keys, values, run name and sweep.
"""

RD_LAMBDAS = [0.00125, 0.0025, 0.005, 0.01, 0.02, 0.04, 0.08]


def get_config():
  config = {}
  config["model_family"] = "mshyper"

  config["train_data_config"] = dict(
      dataset="deadleaves_train",
      batchsize=8,
      patchsize=256,
  )
  config["val_data_config"] = dict(
      dataset="deadleaves_valid",
      batchsize=1,
      patchsize=None,
  )
  config["train_eval_config"] = dict(
      num_steps=30_000,
      log_metrics_every_steps=250,
      checkpoint_every_steps=5_000,
      eval_every_steps=5_000,
      max_validation_steps=4,
      steps_per_dispatch=25,  # JAX's scan window; the port replays a graph a step
  )

  config["model_config"] = dict(
      scheduled_num_steps=config["train_eval_config"]["num_steps"],
      rd_lambda=0.01,
      optimizer_config=dict(
          learning_rate=1e-4,
          reduce_lr_after=0.8,
          reduce_lr_factor=0.1,
          global_clipnorm=1.0,
      ),
      transform_config=dict(
          analysis=dict(cls="ElicAnalysis", channels=(192, 192, 192, 320)),
          synthesis=dict(cls="JPEGLikeSynthesis", kernel_size=18, strides=16),
      ),
      latent_config=dict(uq=dict(method="unoise")),
  )
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["synthesis"] = "jpegl"
  d["rd_lambda"] = config["model_config"]["rd_lambda"]
  d["num_steps"] = config["train_eval_config"]["num_steps"]
  return runname.config_dict_to_str(d)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  return hyper.sweep("model_config.rd_lambda", RD_LAMBDAS)
