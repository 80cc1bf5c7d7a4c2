"""Train the mean-scale hyperprior family.

Example:
  python -m shallow_ntc_tpu_torch.mshyper.train \\
      --config shallow_ntc_tpu_torch/mshyper/configs/two_layer_syn.py --hid 0
"""

from shallow_ntc_tpu_torch.utils import cli

if __name__ == "__main__":
  cli.run_train_main("mshyper", default_experiments_dir="./train_xms")
