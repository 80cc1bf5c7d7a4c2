"""SGA iterative-inference encoding on a trained checkpoint: point
train_eval_config.warm_start_exp_dir at a training experiment directory;
the sweep runs one SGA job per warm_start_wid (one per trained lambda).

A copy of shallow_ntc_tpu/mshyper/configs/itinf.py with plain dicts: the same
keys, values, run name and sweep.
"""

NUM_WIDS = 7


def get_config():
  config = {}
  config["model_family"] = "mshyper"

  config["data_config"] = dict(
      dataset="kodak_landscape",
      batchsize=1,  # >1 speeds SGA but requires equal image shapes
      patchsize=None,
  )
  config["train_eval_config"] = dict(
      num_steps=3000,
      # A val pass after every eval_every_steps steps and at the end; the
      # default, num_steps, gives one val pass at the end.
      log_metrics_every_steps=300,
      eval_every_steps=3000,
      warm_start_exp_dir="project_dir/train_xms/my_xid",
      warm_start_wid=0,
      # Computation dtype of the frozen transforms ("bfloat16" / "float32" /
      # "none"); the entropy math and the optimized latents stay float32.
      transforms_dtype="bfloat16",
      # The JAX package's dispatch shape (one fused scan, or a stream of
      # jitted steps). Every value is the port's captured step on the card
      # (shallow_ntc_tpu_torch/step_graph.py).
      step_dispatch="auto",
  )

  config["model_config"] = dict(
      # Unspecified settings are loaded from the checkpoint's config.json.
      scheduled_num_steps=config["train_eval_config"]["num_steps"],
      optimizer_config=dict(
          learning_rate=5e-3, reduce_lr_after=0.9, reduce_lr_factor=0.1,
          global_clipnorm=None, warmup_until=0.0,
      ),
      latent_config=dict(
          uq=dict(method="sga", tau_r=5e-4, tau_ub=0.5, tau_t0=200),
      ),
      offset_heuristic=False,  # set False if training used mixedq
  )
  return config


def get_cfg_str(config):
  from collections import OrderedDict

  from shallow_ntc_tpu_torch.utils import runname

  d = OrderedDict()
  d["wwid"] = config["train_eval_config"]["warm_start_wid"]
  d["uq_method"] = config["model_config"]["latent_config"]["uq"]["method"]
  return runname.config_dict_to_str(d, skip_falsy=False)


def get_hyper():
  from shallow_ntc_tpu_torch.utils import hyper

  return hyper.sweep("train_eval_config.warm_start_wid", list(range(NUM_WIDS)))
