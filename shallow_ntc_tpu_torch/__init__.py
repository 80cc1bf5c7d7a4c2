"""PyTorch/CUDA port of shallow_ntc_tpu (the JAX package is the reference).

The port keeps the JAX package's module names and its NHWC layout at every
public function. It imports torch, numpy and the standard library only.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
