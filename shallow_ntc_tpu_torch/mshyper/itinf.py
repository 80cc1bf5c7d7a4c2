"""SGA iterative-inference encoding for the mean-scale hyperprior family.

Example:
  python -m shallow_ntc_tpu_torch.mshyper.itinf \\
      --config shallow_ntc_tpu_torch/mshyper/configs/itinf.py --hid 0 \\
      --config.train_eval_config.warm_start_exp_dir=./train_xms/<xid>
"""

from shallow_ntc_tpu_torch.utils import cli

if __name__ == "__main__":
  cli.run_itinf_main("mshyper", default_experiments_dir="./itinf_xms")
