"""Utilities of the port: sweeps, run names, config scripts, the train and
itinf CLIs' machinery, and timing (mirrors shallow_ntc_tpu/utils)."""
