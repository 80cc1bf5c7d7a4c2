"""Numeric ops of the port (mirrors shallow_ntc_tpu/ops)."""
