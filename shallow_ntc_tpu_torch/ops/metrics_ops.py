"""Image math: padding, MSE/PSNR, SSIM and MS-SSIM on NHWC tensors, and
the image grids of the val records (numpy in, numpy out).

Mirrors shallow_ntc_tpu/ops/metrics_ops.py (tf.image defaults: 11x11
Gaussian, sigma 1.5, k1=.01, k2=.03, the five MS-SSIM power factors and
VALID-windowed statistics). All filtering runs in float32.
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _nchw(x):
  return x.permute(0, 3, 1, 2)


def _nhwc(x):
  return x.permute(0, 2, 3, 1)


def quantize_image(x: torch.Tensor) -> torch.Tensor:
  """Round and saturate to the uint8 grid, kept as float."""
  return torch.clamp(torch.round(x), 0, 255)


def mse_psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 255.0):
  """Per-image MSE and PSNR over a [B, H, W, C] batch."""
  x = x.float()
  y = y.float()
  mses = torch.mean(torch.square(x - y), dim=tuple(range(1, x.ndim)))
  psnrs = -10.0 * (torch.log(mses) - 2.0 * math.log(max_val)) / math.log(10.0)
  return mses, psnrs


def pad_images(x: torch.Tensor, div: int, mode: str = "reflect") -> torch.Tensor:
  """Reflect-pad bottom/right so H and W are divisible by `div`."""
  _, h, w, _ = x.shape
  ph = (-h) % div
  pw = (-w) % div
  if ph == 0 and pw == 0:
    return x
  return _nhwc(F.pad(_nchw(x), (0, pw, 0, ph), mode=mode))


def unpad_images(x: torch.Tensor, unpadded_shape) -> torch.Tensor:
  """Crop back to the original (top-left) extent."""
  return x[:, : unpadded_shape[1], : unpadded_shape[2], :]


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def center_crop_image(image, target_height: int, target_width: int):
  """Center crop of [..., H, W, C] (metrics_ops.py:55-61)."""
  h, w = image.shape[-3], image.shape[-2]
  h0 = (h - target_height) // 2
  w0 = (w - target_width) // 2
  return image[..., h0 : h0 + target_height, w0 : w0 + target_width, :]


def visualize_image_batch(images, crop_to_max_dim: Optional[int] = None,
                          ncol: Optional[int] = None) -> np.ndarray:
  """Tile a [B, H, W, C] batch into one [H', W', C] grid image, each image
  first center-cropped to crop_to_max_dim when both its sides exceed it;
  without ncol the grid takes the divisor pair of B nearest its square
  root, wider than tall (metrics_ops.py:64-88)."""
  images = np.asarray(images)
  if (crop_to_max_dim and images.shape[1] > crop_to_max_dim
      and images.shape[2] > crop_to_max_dim):
    images = center_crop_image(images, crop_to_max_dim, crop_to_max_dim)
  batch_size = images.shape[0]
  if ncol is None:
    ncol = int(math.ceil(math.sqrt(batch_size)))
    while batch_size % ncol:
      ncol -= 1
    nrow = batch_size // ncol
    nrow, ncol = min(ncol, nrow), max(ncol, nrow)
  else:
    nrow = batch_size // ncol
    if nrow * ncol != batch_size:
      raise ValueError(f"ncol={ncol} does not divide the batch of {batch_size}")
  h, w = images.shape[1], images.shape[2]
  grid = images.reshape(nrow, ncol, h, w, -1)
  return grid.swapaxes(1, 2).reshape(nrow * h, ncol * w, -1)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
  coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
  g = torch.exp(-(coords**2) / (2.0 * sigma**2))
  return g / torch.sum(g)


def _filter2d_valid(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
  """Separable depthwise Gaussian filtering (VALID) on NCHW, in full float32
  whatever the process's TF32 setting (JAX's Precision.HIGHEST,
  metrics_ops.py:109-124): under TF32 the E[x^2] - E[x]^2 cancellation
  gives cs terms above 1 or below 0."""
  c = x.shape[1]
  k = kernel1d.shape[0]
  tf32 = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    x = F.conv2d(x, kernel1d.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return F.conv2d(x, kernel1d.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
  finally:
    torch.backends.cudnn.allow_tf32 = tf32


def _ssim_luminance_cs(x, y, max_val, filter_size=11, filter_sigma=1.5,
                       k1=0.01, k2=0.03):
  """Per-image mean luminance and contrast-structure terms over VALID windows (NCHW).

  An image smaller than the filter has no window: both terms are NaN, as the
  JAX mean over an empty VALID conv output is.
  """
  if min(x.shape[2], x.shape[3]) < filter_size:
    nan = torch.full((x.shape[0],), float("nan"), device=x.device)
    return nan, nan
  c1 = (k1 * max_val) ** 2
  c2 = (k2 * max_val) ** 2
  kernel = _gaussian_kernel(filter_size, filter_sigma, x.device)
  mu_x = _filter2d_valid(x, kernel)
  mu_y = _filter2d_valid(y, kernel)
  mu_xx = _filter2d_valid(x * x, kernel)
  mu_yy = _filter2d_valid(y * y, kernel)
  mu_xy = _filter2d_valid(x * y, kernel)
  var_x = mu_xx - mu_x * mu_x
  var_y = mu_yy - mu_y * mu_y
  cov_xy = mu_xy - mu_x * mu_y
  lum = (2.0 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)
  cs = (2.0 * cov_xy + c2) / (var_x + var_y + c2)
  return torch.mean(lum, dim=(1, 2, 3)), torch.mean(cs, dim=(1, 2, 3))


def ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
  """Per-image SSIM over [B, H, W, C] (tf.image.ssim defaults)."""
  lum, cs = _ssim_luminance_cs(_nchw(x.float()), _nchw(y.float()), max_val)
  return lum * cs


def _downsample2x(x: torch.Tensor) -> torch.Tensor:
  """2x2 average pooling (NCHW), edge-padding bottom/right to even dims."""
  h, w = x.shape[2], x.shape[3]
  if h % 2 or w % 2:
    x = F.pad(x, (0, w % 2, 0, h % 2), mode="replicate")
  return F.avg_pool2d(x, 2, 2)


def msssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
  """Per-image multi-scale SSIM over [B, H, W, C] (Wang 2003 / tf defaults)."""
  x = _nchw(x.float())
  y = _nchw(y.float())
  mcs = []
  lum = None
  for scale in range(len(_MSSSIM_WEIGHTS)):
    lum, cs = _ssim_luminance_cs(x, y, max_val)
    mcs.append(torch.relu(cs))
    if scale < len(_MSSSIM_WEIGHTS) - 1:
      x = _downsample2x(x)
      y = _downsample2x(y)
  weights = torch.tensor(_MSSSIM_WEIGHTS, dtype=torch.float32, device=x.device)
  cs_part = torch.prod(torch.stack(mcs[:-1], 0) ** weights[:-1, None], dim=0)
  return cs_part * (torch.relu(lum) * mcs[-1]) ** weights[-1]


def msssim_or_ssim(x: torch.Tensor, y: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
  """MS-SSIM, falling back to SSIM for images below 160 px on both sides."""
  h, w = x.shape[1], x.shape[2]
  if h < 160 and w < 160:
    return ssim(x, y, max_val)
  return msssim(x, y, max_val)
