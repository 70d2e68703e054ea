"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, writes into ``build/tpu_nbody_torch/<hash>/`` at the root of the
checkout (keyed by a hash of the sources, the ``csrc/*.cuh`` headers they
include and the flags), and raises with the
compiler's output if ``nvcc`` is missing or the build fails. Nothing here
runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "tpu_nbody_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libtpu_nbody_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of every extern "C" launcher; each returns cudaError_t
SIGNATURES = {
    # pos, mass, out, cap, band, soft2, inv_scale (1/(4a²) poly4, 1/a²
    # exp4), switch, T, B, stream
    "tnt_band_short_range": [_P, _P, _P, _I, _I, _F, _F, _I, _I, _I, _P],
    # targets, sources, masses, scratch (float64), out, nt, ns, dim, soft2,
    # splits, stream
    "tnt_allpairs": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # dim -> blocks of that kernel one SM holds at once (0 on error)
    "tnt_allpairs_blocks_per_sm": [_I],
    # trows, tid, prows, pidx, pvalid, out, walked (or null), m, k, band,
    # soft2, inv_scale, cut (NaN: no skip), switch, T, R, stream
    "tnt_rescue_pairs": [_P] * 7 + [_I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
    # pos, mass, alive, X, box, uni (or null), stats (or null), cap, band,
    # stream
    "tnt_block_boxes": [_P] * 7 + [_I, _I, _P],
    # targets, sources, masses, out, part, flags, tickets (the three null
    # with one split), M, C, NT, S, soft2, T, tpg, lanes, splits, stream
    "tnt_bh_pairs": [_P] * 7 + [_I] * 4 + [_F] + [_I] * 4 + [_P],
    # T, tpg, lanes -> pair-kernel CTAs one SM holds at once (0 on error)
    "tnt_bh_pairs_blocks_per_sm": [_I, _I, _I],
    # node_rows, body_rows, spos, ids, cvalid, kend, gstart, gcount,
    # gvalid, gmin, gmax, out, counts (or null), walked (or null), groups,
    # K, CH, GS, cap, NC, stage, theta2, soft2, stream
    "tnt_bh_hier": [_P] * 14 + [_I] * 7 + [_F, _F, _P],
    # rows, n_nodes, gmin, gmax, plan (host ints), levels, ids (host
    # pointers), totals, cvalid, needs, slots (host ints), n_slots,
    # scratch, scratch_bytes, NC, g_pad, LC, theta2, soft2, stream
    "tnt_bh_lists": [_P] * 5 + [_I] + [_P] * 5 + [_I, _P, _L] + [_I] * 3
                    + [_F, _F, _P],
    # tbox, cbox, cuni, cgid (or null), cvalid (or null), mval, midx, cnt,
    # stats, count, tgid0, M, C, kh, kthr, rcut2, warps, tile, bufcap,
    # smem, grid, stream
    "tnt_rescue_select": [_P] * 9 + [_I, _L] + [_I] * 4 + [_F] + [_I] * 5
                         + [_P],
    # threads, smem -> selection CTAs one SM holds at once (0 on error)
    "tnt_rescue_select_blocks_per_sm": [_I, _I],
    # cbox, uni, stats, C, stream
    "tnt_select_unions": [_P, _P, _P, _I, _P],
    # pos, mass, alive, n, dim, max_mass, md2, H, grid, scratch,
    # scratch_bytes, mass_out, alive_out, need_out, stream
    "tnt_merge": [_P, _P, _P, _I, _I, _F, _F, _I, _I, _P, _L, _P, _P, _P,
                  _P],
    # dim -> CTAs of the one-launch merge one SM holds at once (0 on error)
    "tnt_merge_blocks_per_sm": [_I],
    # pos, mass, alive, n, dim, max_mass, H, gid0, scratch, scratch_bytes,
    # tpos, tgid, tvalid, stream
    "tnt_merge_heavies": [_P, _P, _P, _I, _I, _F, _I, _I, _P, _L, _P, _P,
                          _P, _P],
    # pos, mass, alive, n, dim, gid0, md2, tpos, tgid, tvalid, nT, scratch,
    # scratch_bytes, mass_out, alive_out, gained, stream
    "tnt_merge_apply": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P, _I, _P, _L,
                        _P, _P, _P, _P],
    # fx, fy, base, is64, w, out, n, K, nw, ld, stream
    "tnt_interp_windows": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    # T, L, base, is64, w, out, n, K, has_frac, frac, stream
    "tnt_interp_table": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _F, _P],
    # pos, mass, base, w, rho (null: cells only), n, order, ox, oy, h, nw,
    # ny, ld, rows, stream
    "tnt_deposit_cells": [_P] * 5 + [_I, _I, _F, _F, _F] + [_I] * 4 + [_P],
    # mass, base, is64, w, rho, n, K, nw, ld, rows, stream
    "tnt_deposit_given": [_P, _P, _I, _P, _P] + [_I] * 5 + [_P],
    # src, R, W, rows, cols, c1, c2, c3, fx, fy, stream
    "tnt_fd_gradient": [_P, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P],
    # pos, vel, mass, alive, fb, n, pd, vd, width, height, mode, params
    # (13 host floats), stream
    "tnt_render_splat": [_P] * 5 + [_I] * 6 + [_P, _P],
    # pos, alive, n, ox, oy, scale, codes, stream
    "tnt_bh_codes": [_P, _P, _I, _F, _F, _F, _P, _P],
    # -> tree-build CTAs one SM holds at once (0 on error)
    "tnt_bh_tree_blocks_per_sm": [],
    # pos, mass, codes, order, cap, NC, leaf_size, max_depth, ox, oy,
    # scale, unit, side, grid, scratch, scratch_bytes, outs (host
    # pointers), stream
    "tnt_bh_tree": [_P] * 4 + [_I] * 4 + [_F] * 5 + [_I, _P, _L, _P, _P],
}

_lib = None
_lib_lock = threading.Lock()   # sharded ranks may reach it at once
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their joined output, or raise
    with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return log


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. Records the build seconds and compiler output in
    :data:`last_build`."""
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):          # sources and headers
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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [str(Path(tmp) / (p.stem + ".o")) for p in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                        for p, o in zip(srcs, objs)])
        lib_tmp = str(Path(tmp) / LIB_NAME)
        log += _run_all([[nvcc, "-shared", "-o", lib_tmp, *objs]])
        (out_dir / "build.log").write_text(log)
        os.replace(lib_tmp, lib_path)  # atomic: concurrent builds are safe
    secs = time.perf_counter() - t0
    last_build.update(path=str(lib_path), seconds=secs, cached=False, log=log)
    return lib_path


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel in an ``-Xptxas -v`` log:
    one dict (``name``, ``registers``, ``spill_bytes``) per entry point."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append(dict(name=m.group(1), registers=None, spill_bytes=0))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Every function in
    :data:`SIGNATURES` returns a C int."""
    global _lib
    with _lib_lock:
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


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch:
    the handle ``torch.cuda.current_stream(device).cuda_stream`` gives,
    from torch's own accessor, without the ``torch.cuda.Stream`` object
    that call builds each time (microseconds of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def stream_counters(device: torch.device, name: str, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters for the kernel ``name`` on
    ``device``'s current stream, kept from call to call: the kernel
    leaves them ready for its next launch (the pair kernel's last CTA of a
    set resets its ticket), so only a new buffer is filled, once, with
    zeros. Each stream has its own, so launches on two streams never
    share a counter; launches on one stream run in turn."""
    key = (name, device.index, stream(device))
    with _COUNTERS_LOCK:
        t = _COUNTERS.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros((max(n, 1024),), dtype=torch.int32,
                            device=device)
            _COUNTERS[key] = t
    return t


# the kernels, each the name its launches pass to check_launch
KERNELS = ("band", "rescue", "rescue_select", "select_unions", "boxes",
           "allpairs", "bh_pairs", "bh_hier", "bh_lists", "bh_tree", "merge",
           "interp", "deposit", "fd", "render")
# launches of each of KERNELS, and "allpairs_pairs", the target x source
# pairs of every all-pairs pass on either device
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()   # sharded ranks launch from threads


def count(name: str, n: int = 1):
    """Add ``n`` to the tally ``name`` of :data:`LAUNCHES`."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += n


def launches(*names: str) -> int:
    """The sum of the tallies ``names`` of :data:`LAUNCHES`."""
    with _LAUNCHES_LOCK:
        return sum(LAUNCHES[n] for n in names)


def raise_on_error(name: str, rc: int):
    """Raise if a launcher returned a CUDA error (checked right after the
    launch: a refused launch never runs and a later synchronize would not
    report it)."""
    if rc != 0:
        msg = library().tnt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): {msg}")


def check_launch(name: str, rc: int):
    """:func:`raise_on_error`, then count one launch of the kernel
    ``name``."""
    raise_on_error(name, rc)
    count(name)


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device=None,
                 align: int = 4, dtype=torch.float32):
    """Validate a kernel argument: a contiguous CUDA tensor of ``dtype``
    (float32 by default) and the given shape (on ``device`` when given)
    whose data starts on an ``align``-byte boundary (the kernels read some
    as 8-byte pairs)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor (CPU tensors take "
                         f"the plain version), got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must start on a {align}-byte "
                         f"boundary")
