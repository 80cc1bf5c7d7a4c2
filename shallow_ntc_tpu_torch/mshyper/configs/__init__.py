"""Config scripts of the mean-scale hyperprior family (--config of the CLIs)."""
