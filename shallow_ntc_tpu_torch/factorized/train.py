"""Train the factorized-prior family.

Example:
  python -m shallow_ntc_tpu_torch.factorized.train \\
      --config shallow_ntc_tpu_torch/factorized/configs/bls2017.py --hid 0
"""

from shallow_ntc_tpu_torch.utils import cli

if __name__ == "__main__":
  cli.run_train_main("factorized", default_experiments_dir="./train_xms")
