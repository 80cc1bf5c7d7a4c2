"""CNN analysis + two-layer (non-residual) synthesis, mixedq training, offset
heuristic off; the sweep crosses 4 rd_lambda values with hidden channels
24 and 48.

A copy of shallow_ntc_tpu/mshyper/configs/two_layer_syn2.py with plain dicts: the same
keys, values, run name and sweep.
"""

RD_LAMBDAS = [0.08, 0.02, 0.005, 0.00125]
HIDDEN_CHANNELS = [24, 48]


def get_config():
  config = {}
  config["model_family"] = "mshyper"

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
          analysis=dict(cls="CNNAnalysis", channels_base=256, output_channels=320),
          synthesis=dict(
              cls="TwoLayerSynthesis", channels=(12, 3), strides=(8, 2),
              kernel_sizes=(13, 5), activation_type="igdn",
          ),
      ),
      latent_config=dict(uq=dict(method="mixedq")),
      offset_heuristic=False,
  )
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["ana"] = config["model_config"]["transform_config"]["analysis"]["cls"]
  d["ana_cb"] = config["model_config"]["transform_config"]["analysis"]["channels_base"]
  d["rd_lambda"] = config["model_config"]["rd_lambda"]
  d["hidden_channels"] = config["model_config"]["transform_config"]["synthesis"]["channels"][0]
  d["k1"] = config["model_config"]["transform_config"]["synthesis"]["kernel_sizes"][0]
  d["k2"] = config["model_config"]["transform_config"]["synthesis"]["kernel_sizes"][1]
  d["act"] = config["model_config"]["transform_config"]["synthesis"]["activation_type"]
  d["uq_method"] = config["model_config"]["latent_config"]["uq"]["method"]
  return runname.config_dict_to_str(d)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  lambdas = hyper.sweep("model_config.rd_lambda", RD_LAMBDAS)
  channels = hyper.sweep(
      "model_config.transform_config.synthesis.channels",
      [(hc, 3) for hc in HIDDEN_CHANNELS],
  )
  return hyper.product(lambdas, channels)
