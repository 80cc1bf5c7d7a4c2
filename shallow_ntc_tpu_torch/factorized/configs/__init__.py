"""Config scripts of the factorized-prior family (--config of the CLIs)."""
