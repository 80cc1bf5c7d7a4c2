"""The port's CUDA kernels on the card, against their plain versions.

Tests marked gpu skip without an NVIDIA GPU. This file imports no JAX, so on
a machine with a GPU it runs as
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
(--noconftest: tests/conftest.py imports JAX, which a GPU machine need not have).
"""

import numpy as np
import pytest
import torch

from shallow_ntc_tpu_torch.ops import cuda_build
from shallow_ntc_tpu_torch.ops import twolayer_final as tl


def _inputs(seed, b, h, w, device, dtype, k=5, c_in=12, c_out=3):
  rng = np.random.default_rng(seed)
  mid = torch.from_numpy(rng.standard_normal((b, h, w, 64 * c_in), np.float32))
  kernel = torch.from_numpy(rng.standard_normal((k, k, c_in, c_out), np.float32) * 0.1)
  bias = torch.from_numpy(rng.standard_normal((c_out,), np.float32) * 0.1)
  return mid.to(device, dtype), kernel.to(device, dtype), bias.to(device)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


def test_build_names_the_missing_compiler(monkeypatch, tmp_path):
  monkeypatch.setenv("PATH", str(tmp_path))
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  with pytest.raises(RuntimeError, match="nvcc not found"):
    cuda_build.find_nvcc()
  assert cuda_build.library_path(tl.SOURCE).startswith(cuda_build.BUILD_DIR)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,dtype,k", [
    (1, 32, 48, torch.float32, 5), (8, 32, 48, torch.bfloat16, 5),
    (3, 5, 7, torch.float32, 5), (2, 3, 4, torch.float32, 7)])
def test_final_deconv_kernel_matches_plain(cuda_device, b, h, w, dtype, k):
  """f32 within 1e-4; bf16 within 2e-2 of max|y| (both round the output to bf16)."""
  mid, kernel, bias = _inputs(b + h, b, h, w, cuda_device, dtype, k=k)
  launches = tl.STATS.launches
  out = tl.final_deconv_cuda(mid, kernel, bias, 12)
  torch.cuda.synchronize()
  assert tl.STATS.launches == launches + 1
  ref = tl.final_deconv_plain(mid, kernel, bias, 12)
  err = (out.float() - ref.float()).abs().max().item()
  scale = ref.float().abs().max().item()
  assert err <= (1e-4 if dtype == torch.float32 else 2e-2 * scale), (err, scale)


@pytest.mark.gpu
def test_final_deconv_kernel_gradients_match_plain(cuda_device):
  mid, kernel, bias = _inputs(5, 2, 3, 4, cuda_device, torch.float32)
  cot = torch.randn(2, 48, 64, 3, device=cuda_device)
  grads = []
  for fn in (tl.final_deconv_phase, tl.final_deconv_plain):
    leaves = [t.clone().requires_grad_(True) for t in (mid, kernel, bias)]
    fn(*leaves, 12).backward(cot)
    grads.append([leaf.grad for leaf in leaves])
  for a, b_ in zip(*grads):
    torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
def test_final_deconv_kernel_refuses_what_it_does_not_take(cuda_device):
  mid, kernel, bias = _inputs(0, 1, 2, 2, cuda_device, torch.float32)
  with pytest.raises(TypeError):
    tl.final_deconv_cuda(mid.half(), kernel, bias, 12)
  with pytest.raises(ValueError, match="contiguous"):
    tl.final_deconv_cuda(mid.transpose(1, 2), kernel, bias, 12)
  with pytest.raises(ValueError, match="kernel"):
    tl.final_deconv_cuda(mid, kernel[:, :, :6], bias, 12)
