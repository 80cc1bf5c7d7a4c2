"""Generate the dead-leaves image dataset (a copy of
scripts/make_deadleaves_dataset.py that writes through the port's PNG
writer).

The classic dead-leaves occlusion model: disks with a power-law radius
distribution p(r) ~ r^-3 drawn front to back, each with a correlated colour
and a gentle linear shading, then a slight blur and sensor-like noise. The
same seeds, sizes and file names as the script, so the files hold the same
pixels:
  <out>/train/dl<i:05d>.png   (default 1200 x 320x320, seeds 1000 + i)
  <out>/valid/dlv<i:03d>.png  (default 4 x 512x768, seeds 500000 + i)
  <out>/eval/dle<i:03d>.png   (default 8 x 512x768, seeds 900000 + i)
An existing file is kept.

  python -m shallow_ntc_tpu_torch.deadleaves --out ./data/deadleaves
"""

import argparse
import multiprocessing as mp
import os

import numpy as np

from shallow_ntc_tpu_torch import data as data_lib


def _sample_radius(rng, rmin, rmax, alpha=3.0):
  """Power-law p(r) ~ r^-alpha via inverse CDF."""
  a = 1.0 - alpha
  u = rng.uniform()
  return (rmin**a + u * (rmax**a - rmin**a)) ** (1.0 / a)


def _sample_color(rng):
  """Correlated RGB: a luminance base plus small chroma offsets."""
  lum = rng.uniform(0.05, 0.95)
  chroma = rng.normal(0, 0.12, 3)
  return np.clip(lum + chroma, 0.0, 1.0)


def deadleaves_image(seed: int, h: int, w: int, rmin=4.0, rmax=None,
                     max_disks=20000) -> np.ndarray:
  """A uint8 [h, w, 3] dead-leaves image drawn from np.random.default_rng(seed)."""
  rng = np.random.default_rng(seed)
  if rmax is None:
    rmax = 0.6 * min(h, w)
  img = np.zeros((h, w, 3), np.float32)
  filled = np.zeros((h, w), bool)
  yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
  remaining = h * w
  for _ in range(max_disks):
    r = _sample_radius(rng, rmin, rmax)
    cy = rng.uniform(-r, h + r)
    cx = rng.uniform(-r, w + r)
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r) + 2)
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r) + 2)
    if y0 >= y1 or x0 >= x1:
      continue
    sub_f = filled[y0:y1, x0:x1]
    if sub_f.all():
      continue
    dy = yy[y0:y1, x0:x1] - cy
    dx = xx[y0:y1, x0:x1] - cx
    inside = (dy * dy + dx * dx) <= r * r
    new = inside & ~sub_f
    if not new.any():
      continue
    color = _sample_color(rng)
    # Gentle linear shading across the disk (keeps regions non-constant).
    gdir = rng.normal(0, 1, 2)
    gdir /= np.hypot(*gdir) + 1e-9
    shade = 1.0 + rng.uniform(0.0, 0.25) * (dy * gdir[0] + dx * gdir[1]) / r
    patch = np.clip(color[None, None, :] * shade[..., None], 0.0, 1.0)
    sub_i = img[y0:y1, x0:x1]
    sub_i[new] = patch[new]
    filled[y0:y1, x0:x1] = sub_f | inside
    remaining -= int(new.sum())
    if remaining <= 0:
      break
  # Residual uncovered pixels (rare): fill with a neutral gray.
  img[~filled] = 0.5

  # Optical blur + sensor noise so the source is not piecewise-ideal. The
  # script skips the blur without scipy; here scipy is required, so that
  # the files always hold the script's pixels.
  from scipy.ndimage import gaussian_filter

  img = gaussian_filter(img, sigma=(0.6, 0.6, 0.0))
  img = img + rng.normal(0, 1.2 / 255.0, img.shape).astype(np.float32)
  return (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def _job(args):
  path, seed, h, w = args
  if not os.path.exists(path):
    data_lib.write_png(path, deadleaves_image(seed, h, w))
  return path


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--out", default="./data/deadleaves")
  p.add_argument("--num_train", type=int, default=1200)
  p.add_argument("--train_size", type=int, default=320)
  p.add_argument("--num_valid", type=int, default=4)
  p.add_argument("--num_eval", type=int, default=8)
  p.add_argument("--eval_hw", default="512x768")
  p.add_argument("--workers", type=int, default=os.cpu_count())
  args = p.parse_args(argv)

  eh, ew = (int(v) for v in args.eval_hw.split("x"))
  jobs = []
  for i in range(args.num_train):
    jobs.append((os.path.join(args.out, "train", f"dl{i:05d}.png"),
                 1000 + i, args.train_size, args.train_size))
  for i in range(args.num_valid):
    jobs.append((os.path.join(args.out, "valid", f"dlv{i:03d}.png"), 500000 + i, eh, ew))
  for i in range(args.num_eval):
    jobs.append((os.path.join(args.out, "eval", f"dle{i:03d}.png"), 900000 + i, eh, ew))

  for sub in ("train", "valid", "eval"):
    os.makedirs(os.path.join(args.out, sub), exist_ok=True)

  with mp.get_context("spawn").Pool(args.workers) as pool:
    for n, _ in enumerate(pool.imap_unordered(_job, jobs)):
      if (n + 1) % 100 == 0:
        print(f"{n + 1}/{len(jobs)}", flush=True)
  print(f"Wrote {len(jobs)} images under {args.out}")


if __name__ == "__main__":
  main()
