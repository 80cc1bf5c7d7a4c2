"""Build a CUDA source of the port into a shared library and load it.

The sources under shallow_ntc_tpu_torch/csrc/ have a plain C interface and
include no PyTorch header, so one `nvcc` call builds each in seconds. The
library goes to shallow_ntc_tpu_torch/_build/ under a name that carries the
source's hash, so an edited source is rebuilt and an unchanged one is not.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()


class KernelStats:
  """Launch count of one CUDA kernel wrapper: a plain integer, reset by the
  caller. Every instance is in `registry`, which a captured step reads
  (step_graph.CapturedStep)."""

  registry = []

  def __init__(self, name: str):
    self.name = name
    self.launches = 0
    KernelStats.registry.append(self)

_loaded = {}


def find_nvcc() -> str:
  nvcc = shutil.which("nvcc")
  if nvcc is None:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
  if not os.path.exists(nvcc):
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
  return nvcc


def library_path(source: str) -> str:
  """Where the library built from csrc/<source> lives."""
  with open(os.path.join(CSRC_DIR, source), "rb") as f:
    digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  stem = os.path.splitext(source)[0]
  return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def compile_library(cmd, out: str) -> str:
  """Run the compiler command `cmd` + ["-o", <temporary file>] into BUILD_DIR
  and move the result to `out`; return `out`."""
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  try:
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
      source = next(a for a in cmd if a.endswith((".cu", ".cc")))
      raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({proc.returncode}) for "
                         f"{os.path.basename(source)}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return out


def build(source: str) -> str:
  """Compile csrc/<source> with nvcc unless its library exists; return its path."""
  out = library_path(source)
  if os.path.exists(out):
    return out
  return compile_library([find_nvcc(), *NVCC_FLAGS, os.path.join(CSRC_DIR, source)], out)


def load(source: str) -> ctypes.CDLL:
  """Build (if needed) and load csrc/<source>; one CDLL per source per process."""
  with _lock:
    lib = _loaded.get(source)
    if lib is None:
      lib = ctypes.CDLL(build(source))
      _loaded[source] = lib
    return lib
