"""Tiny synthetic-data config for CLI smoke tests (no dataset files needed).

A copy of shallow_ntc_tpu/mshyper/configs/smoke.py with plain dicts: the same
keys, values, run name and sweep.
"""

RD_LAMBDAS = [0.01, 0.08]


def get_config():
  config = {}
  config["model_family"] = "mshyper"

  config["train_data_config"] = dict(dataset="synthetic", batchsize=2, patchsize=64)
  config["val_data_config"] = dict(dataset="synthetic", batchsize=2, patchsize=64)
  config["train_eval_config"] = dict(
      num_steps=20,
      log_metrics_every_steps=5,
      checkpoint_every_steps=10,
      eval_every_steps=10,
      max_validation_steps=2,
  )

  config["model_config"] = dict(
      scheduled_num_steps=config["train_eval_config"]["num_steps"],
      rd_lambda=0.01,
      optimizer_config=dict(learning_rate=1e-3, warmup_until=0.0, global_clipnorm=1.0),
      transform_config=dict(
          analysis=dict(cls="CNNAnalysis", channels_base=8, output_channels=12),
          synthesis=dict(cls="TwoLayerSynthesis", channels=(6, 3), strides=(8, 2),
                         kernel_sizes=(13, 5)),
          hyper_analysis=dict(cls="HyperAnalysisSmall", bottleneck_size=12),
          hyper_synthesis=dict(cls="HyperSynthesisSmall", bottleneck_size=12),
      ),
      latent_config=dict(uq=dict(method="unoise")),
  )
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["rd_lambda"] = config["model_config"]["rd_lambda"]
  d["uq_method"] = config["model_config"]["latent_config"]["uq"]["method"]
  return runname.config_dict_to_str(d)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  return hyper.sweep("model_config.rd_lambda", RD_LAMBDAS)
