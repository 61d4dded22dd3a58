"""Grouped f64 sums over packed group ids: a hand-written CUDA kernel.

Counterpart of ``trino_tpu/ops/pallas_groupby.py`` (``grouped_sums``, the
one Pallas TPU kernel), with the same public function: per-group f64 sums
of K lanes. The kernel is ``csrc/grouped_sums.cu``, compiled for
``sm_90a`` into a shared library with a plain C interface and loaded with
ctypes; its header states what bounds it and what the design does about
that.

Dispatch: a CPU tensor goes to ``grouped_sums_plain``; a CUDA tensor
launches the kernel or raises (on a build failure, a launch error, a wrong
dtype or a non-contiguous input). There is no fallback. ``LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

# packed domains above this stay off the kernel (ops/groupby.py keeps the
# same FAST_DOMAIN_LIMIT as the JAX engine)
MAX_GROUPS = 64

LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "grouped_sums.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_THREADS = 256          # kThreads in the source
_MIN_CHUNK = 16 * _THREADS
_TARGET_CHUNKS = 1024

_lib: Optional[ctypes.CDLL] = None
# how the library was obtained: seconds, and nvcc's register/spill report
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the grouped_sums CUDA kernel "
                       "cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libgrouped_sums-{tag[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.grouped_sums_launch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.grouped_sums_launch.restype = ctypes.c_int
    lib.grouped_sums_max_lanes.argtypes = []
    lib.grouped_sums_max_lanes.restype = ctypes.c_int
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(so),
                      compiled=bool(log), ptxas=log)
    _lib = lib
    return lib


def partition(cap: int):
    """(chunk, P): rows cut into P chunks of ``chunk`` rows, a multiple
    of the block size; it depends only on ``cap``, so the summation
    order, and with it every bit of the result, is fixed per shape."""
    per = -(-cap // _TARGET_CHUNKS)
    chunk = max(_MIN_CHUNK, -(-per // _THREADS) * _THREADS)
    return chunk, max(1, -(-cap // chunk))


def grouped_sums_plain(gid: torch.Tensor, lanes: Sequence[torch.Tensor],
                       nseg: int) -> List[torch.Tensor]:
    """Plain PyTorch version: a weighted bincount per lane into nseg + 1
    slots, the last (rows with an id outside [0, nseg)) dropped."""
    g = gid.to(torch.int64)
    g = torch.where((g >= 0) & (g < nseg), g, nseg)
    return [torch.bincount(g, weights=lane.to(torch.float64),
                           minlength=nseg + 1)[:nseg] for lane in lanes]


def _check(gid: torch.Tensor, lanes: Sequence[torch.Tensor], nseg: int):
    if gid.dim() != 1 or gid.dtype != torch.int32 \
            or not gid.is_contiguous():
        raise ValueError("grouped_sums: gid must be a contiguous 1-D "
                         f"int32 tensor, got {gid.dtype} {tuple(gid.shape)}")
    if not 1 <= nseg <= MAX_GROUPS:
        raise ValueError(f"grouped_sums: nseg={nseg} outside [1, "
                         f"{MAX_GROUPS}]")
    for lane in lanes:
        if lane.device != gid.device or lane.dtype != torch.float64 \
                or lane.shape != gid.shape or not lane.is_contiguous():
            raise ValueError(
                "grouped_sums: every lane must be a contiguous float64 "
                f"tensor shaped like gid on {gid.device}, got {lane.dtype}"
                f" {tuple(lane.shape)} on {lane.device}")


def grouped_sums(gid: torch.Tensor, lanes: Sequence[torch.Tensor],
                 nseg: int) -> List[torch.Tensor]:
    """Per-group f64 sums for every lane.

    ``gid``: int32 [cap] packed group ids; rows whose id is outside
    [0, nseg) contribute to no lane (the caller gives dead rows the id
    nseg). Per-lane exclusion is the caller's job (a zero in the lane).
    Returns one f64 [nseg] tensor per lane.
    """
    global LAUNCHES
    lanes = list(lanes)
    if gid.device.type == "cpu":
        return grouped_sums_plain(gid, lanes, nseg)
    _check(gid, lanes, nseg)
    if not lanes:
        return []
    lib = build()
    cap = int(gid.shape[0])
    chunk, nchunks = partition(cap)
    step = lib.grouped_sums_max_lanes()
    outs: List[torch.Tensor] = []
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for start in range(0, len(lanes), step):
            group = lanes[start:start + step]
            k = len(group)
            partial = torch.empty((nchunks, k, nseg), dtype=torch.float64,
                                  device=gid.device)
            out = torch.empty((k, nseg), dtype=torch.float64,
                              device=gid.device)
            ptrs = (ctypes.c_void_p * k)(*[x.data_ptr() for x in group])
            rc = lib.grouped_sums_launch(
                gid.data_ptr(), ptrs, k, cap, chunk, nchunks, nseg,
                partial.data_ptr(), out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"grouped_sums kernel launch failed: CUDA error {rc}")
            LAUNCHES += 1
            outs.extend(out.unbind(0))
    return outs
