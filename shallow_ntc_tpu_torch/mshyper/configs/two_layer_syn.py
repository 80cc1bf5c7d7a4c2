"""ELIC analysis + two-layer residual synthesis (the paper's flagship); the
sweep covers the 7 published rd_lambda values.

A copy of shallow_ntc_tpu/mshyper/configs/two_layer_syn.py with plain dicts: the same
keys, values, run name and sweep.
"""

# The 7 rate points of the published R-D curves.
RD_LAMBDAS = [0.08, 0.02, 0.005, 0.00125, 0.04, 0.01, 0.0025]


def get_config():
  config = {}
  config["model_family"] = "mshyper"

  config["train_data_config"] = dict(
      dataset="cocotrain",
      batchsize=8,
      patchsize=256,
  )
  config["val_data_config"] = dict(
      dataset="kodak_landscape",
      batchsize=1,
      patchsize=None,
  )
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
          learning_rate=1e-4,
          reduce_lr_after=0.8,
          reduce_lr_factor=0.1,
          global_clipnorm=1.0,
      ),
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
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["rd_lambda"] = config["model_config"]["rd_lambda"]
  d["bottleneck_size"] = config["model_config"]["transform_config"]["analysis"]["channels"][-1]
  d["hidden_channels"] = config["model_config"]["transform_config"]["synthesis"]["channels"][0]
  d["k1"] = config["model_config"]["transform_config"]["synthesis"]["kernel_sizes"][0]
  d["k2"] = config["model_config"]["transform_config"]["synthesis"]["kernel_sizes"][1]
  d["act"] = config["model_config"]["transform_config"]["synthesis"]["activation_type"]
  d["uq_method"] = config["model_config"]["latent_config"]["uq"]["method"]
  return runname.config_dict_to_str(d)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  return hyper.product(hyper.sweep("model_config.rd_lambda", RD_LAMBDAS))
