"""The Balle-2017 factorized-prior baseline.

A copy of shallow_ntc_tpu/factorized/configs/bls2017.py with plain dicts: the same
keys, values, run name and sweep.
"""

RD_LAMBDAS = [0.08, 0.02, 0.005, 0.00125, 0.04, 0.01, 0.0025]


def get_config():
  config = {}
  config["model_family"] = "factorized"

  config["train_data_config"] = dict(dataset="cocotrain", batchsize=8, patchsize=256)
  config["val_data_config"] = dict(dataset="kodak_landscape", batchsize=1, patchsize=None)
  config["train_eval_config"] = dict(
      num_steps=1_800_000,
      log_metrics_every_steps=1000,
      checkpoint_every_steps=10_000,
      eval_every_steps=10_000,
  )

  config["model_config"] = dict(
      scheduled_num_steps=config["train_eval_config"]["num_steps"],
      rd_lambda=0.08,
      optimizer_config=dict(
          learning_rate=1e-4, reduce_lr_after=0.8, reduce_lr_factor=0.1,
          global_clipnorm=1.0,
      ),
      transform_config=dict(
          analysis=dict(cls="BLS2017Analysis", num_filters=256),
          synthesis=dict(cls="BLS2017Synthesis", num_filters=256),
      ),
  )
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["rd_lambda"] = config["model_config"]["rd_lambda"]
  d["num_filters"] = config["model_config"]["transform_config"]["analysis"]["num_filters"]
  return runname.config_dict_to_str(d)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  return hyper.sweep("model_config.rd_lambda", RD_LAMBDAS)
