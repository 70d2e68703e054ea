"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, writes into ``build/tpu_nbody_torch/<hash>/`` at the root
of the checkout (keyed by a hash of the sources and flags), and raises with
the compiler's output if ``nvcc`` is missing or the build fails. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "tpu_nbody_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libtpu_nbody_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every extern "C" launcher; each returns cudaError_t
SIGNATURES = {
    # pos, mass, out, cap, band, soft2, a, switch, stream
    "tnt_band_short_range": [_P, _P, _P, _I, _I, _F, _F, _I, _P],
    # targets, sources, masses, out, nt, ns, dim, soft2, stream
    "tnt_allpairs": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
}

_lib = None
last_build: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of tpu_nbody_torch cannot be built")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. Records the build seconds and compiler output in
    :data:`last_build`."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        last_build.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=(out_dir / "build.log").read_text()
                          if (out_dir / "build.log").is_file() else "")
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, lib_path)          # atomic: concurrent builds are safe
    last_build.update(path=str(lib_path), seconds=secs, cached=False, log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tnt_error_string.argtypes = [ctypes.c_int]
        lib.tnt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(name: str, rc: int):
    """Raise if a launcher returned a CUDA error (checked right after the
    launch: a refused launch never runs and a later synchronize would not
    report it)."""
    if rc != 0:
        msg = library().tnt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): {msg}")


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device=None):
    """Validate a kernel argument: a contiguous float32 CUDA tensor of the
    given shape (on ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor (CPU tensors take "
                         f"the plain version), got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
