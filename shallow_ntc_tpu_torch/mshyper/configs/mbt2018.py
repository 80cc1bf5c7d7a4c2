"""The mean-scale hyperprior baseline (Minnen 2018).

A copy of shallow_ntc_tpu/mshyper/configs/mbt2018.py with plain dicts: the same
keys, values, run name and sweep.
"""

RD_LAMBDAS = [0.08, 0.02, 0.005, 0.00125, 0.04, 0.01, 0.0025]


def get_config():
  config = {}
  config["model_family"] = "mshyper"

  config["train_data_config"] = dict(dataset="cocotrain", batchsize=8, patchsize=256)
  config["val_data_config"] = dict(dataset="kodak_landscape", batchsize=1, patchsize=None)
  config["train_eval_config"] = dict(
      num_steps=2_000_000,
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
          analysis=dict(cls="MBT2018Analysis", channels_base=192, output_channels=320),
          synthesis=dict(cls="MBT2018Synthesis", channels_base=192, output_channels=3),
      ),
  )
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["rd_lambda"] = config["model_config"]["rd_lambda"]
  d["bottleneck_size"] = config["model_config"]["transform_config"]["analysis"]["output_channels"]
  d["channels_base"] = config["model_config"]["transform_config"]["analysis"]["channels_base"]
  return runname.config_dict_to_str(d)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  return hyper.sweep("model_config.rd_lambda", RD_LAMBDAS)
