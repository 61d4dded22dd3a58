"""Grouped f64 sums over packed group ids: a hand-written CUDA kernel.

Counterpart of ``trino_tpu/ops/pallas_groupby.py`` (``grouped_sums``, the
one Pallas TPU kernel), with the same public function: per-group f64 sums
of K lanes. The kernel is ``csrc/grouped_sums.cu``, compiled for
``sm_90a`` into a shared library with a plain C interface and loaded with
ctypes; its header states what bounds it and what the design does about
that.

The lanes are one f64 [K, ld] buffer (``ld`` the rows rounded up to even,
so every row is 16-byte aligned), as the TPU kernel takes ``vals [K8,
cap]``; ``ops/groupby.py`` writes each lane into its row. A list of lanes
is stacked into such a buffer first. The result is one f64 [K, nseg]
tensor, a row per lane.

Dispatch: a CPU tensor goes to ``grouped_sums_plain``; a CUDA tensor
launches the kernel, once a call, or raises (on a build failure, a launch
error, a wrong dtype, shape, stride or alignment). There is no fallback.
``LAUNCHES`` counts kernel launches. Query threads of one coordinator
may reach the first launch together: ``build`` runs under a lock (one
compile, ``BUILDS`` counts the loads) into a temporary name of its own,
and ``LAUNCHES`` moves under a lock too. The host's work a call does not grow
with K: two tensors checked, one ``torch.empty``, one ctypes call. The
source owns the call's layout (blocks, scratch, tickets):
``scratch_rows`` asks it for the size of that one allocation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Union

import torch

# packed domains above this stay off the kernel (ops/groupby.py keeps the
# same FAST_DOMAIN_LIMIT as the JAX engine)
MAX_GROUPS = 64

LAUNCHES = 0
# libraries loaded by ``build`` (1 after the first use, whatever the
# number of threads that raced to it)
BUILDS = 0
_LOCK = threading.Lock()

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "grouped_sums.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_F64 = torch.float64
Lanes = Union[torch.Tensor, Sequence[torch.Tensor]]

_launch = None
_scratch_rows = None
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


def build():
    """Compile (once per source content) and load the kernel library;
    returns its launch function, with its argument types set. Threads
    that call it together wait for one build."""
    with _LOCK:
        if _launch is None:
            _build_locked()
        return _launch


def _build_locked() -> None:
    global _launch, _scratch_rows, BUILDS
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libgrouped_sums-{tag[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    rows = lib.grouped_sums_scratch_rows
    rows.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    rows.restype = ctypes.c_longlong
    fn = lib.grouped_sums_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _scratch_rows = rows
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=str(so),
                      compiled=bool(log), ptxas=log)
    BUILDS += 1
    _launch = fn


@functools.lru_cache(maxsize=4096)
def scratch_rows(cap: int, k: int, nseg: int) -> int:
    """Rows of nseg doubles in the one allocation a call of ``cap`` rows
    and ``k`` lanes takes, as the kernel's source lays it out: the
    [K, nseg] result first (all of it when the rows fit one block), then
    the blocks' partials, the groups' sums and the call's tickets."""
    if _scratch_rows is None:
        build()
    return _scratch_rows(cap, k, nseg)


def stack_lanes(lanes: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    """A list of [cap] lanes as the kernel's f64 [K, ld] buffer (ld = cap
    rounded up to even; the pad column is never summed)."""
    if cap % 2 == 0:
        return torch.stack(list(lanes))
    buf = torch.empty((len(lanes), cap + 1), dtype=lanes[0].dtype,
                      device=lanes[0].device)
    buf[:, :cap] = torch.stack(list(lanes))
    return buf


def grouped_sums_plain(gid: torch.Tensor, lanes: Lanes,
                       nseg: int) -> torch.Tensor:
    """Plain PyTorch version: a weighted bincount per lane into nseg + 1
    slots, the last (rows with an id outside [0, nseg)) dropped. Takes
    the [K, ld] buffer or a list of lanes; returns f64 [K, nseg]."""
    cap = int(gid.shape[0])
    g = gid.to(torch.int64)
    g = torch.where((g >= 0) & (g < nseg), g, nseg)
    sums = [torch.bincount(g, weights=lane[:cap].to(_F64),
                           minlength=nseg + 1)[:nseg] for lane in lanes]
    if not sums:
        return torch.zeros((0, nseg), dtype=_F64, device=gid.device)
    return torch.stack(sums)


def _check(gid: torch.Tensor, vals: torch.Tensor, nseg: int) -> None:
    """What the kernel takes: int32 ids, contiguous, 16-byte aligned; an
    f64 [K, ld] buffer on the same device, rows contiguous and 16-byte
    aligned (ld even, at least the rows rounded up to even)."""
    if gid.dtype != torch.int32 or gid.dim() != 1 \
            or not gid.is_contiguous() or gid.data_ptr() % 16:
        raise ValueError("grouped_sums: gid must be a contiguous, 16-byte "
                         f"aligned 1-D int32 tensor, got {gid.dtype} "
                         f"{tuple(gid.shape)}")
    if not 1 <= nseg <= MAX_GROUPS:
        raise ValueError(f"grouped_sums: nseg={nseg} outside [1, "
                         f"{MAX_GROUPS}]")
    cap = gid.shape[0]
    if vals.dim() == 2:
        k, width = vals.shape
        row, col = vals.stride()
        if vals.dtype == _F64 and vals.get_device() == gid.get_device() \
                and width >= cap + cap % 2 and (width == 1 or col == 1) \
                and (k < 2 or (row % 2 == 0 and row >= cap)) \
                and vals.data_ptr() % 16 == 0:
            return
    raise ValueError(
        "grouped_sums: the lanes must be a float64 [K, ld] buffer on "
        f"{gid.device}, ld >= {cap + cap % 2}, rows contiguous, 16-byte "
        "aligned and an even number of doubles apart; got "
        f"{vals.dtype} {tuple(vals.shape)} strides {vals.stride()} on "
        f"{vals.device}")


def grouped_sums(gid: torch.Tensor, lanes: Lanes,
                 nseg: int) -> torch.Tensor:
    """Per-group f64 sums for every lane.

    ``gid``: int32 [cap] packed group ids; rows whose id is outside
    [0, nseg) contribute to no lane (the caller gives dead rows the id
    nseg). Per-lane exclusion is the caller's job (a zero in the lane).
    ``lanes``: the f64 [K, ld] buffer (or a list of [cap] lanes).
    Returns f64 [K, nseg], a row per lane.
    """
    global LAUNCHES
    if not gid.is_cuda:
        return grouped_sums_plain(gid, lanes, nseg)
    cap = gid.shape[0]
    if isinstance(lanes, torch.Tensor):
        vals = lanes
    else:
        lanes = list(lanes)
        if not lanes:
            return torch.zeros((0, nseg), dtype=_F64, device=gid.device)
        vals = stack_lanes(lanes, cap)
    _check(gid, vals, nseg)
    k = vals.shape[0]
    if k == 0 or cap == 0:
        return torch.zeros((k, nseg), dtype=_F64, device=gid.device)
    launch = _launch or build()
    # one allocation: the result, then the kernel's scratch and tickets
    rows = scratch_rows(cap, k, nseg)
    buf = gid.new_empty((rows, nseg), dtype=_F64)
    index = gid.get_device()
    # the current stream's handle (what torch.cuda.current_stream(index)
    # .cuda_stream gives, without making a Stream object each call)
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (gid.data_ptr(), vals.data_ptr(),
            vals.stride(0) if k > 1 else cap + cap % 2, cap, k, nseg,
            buf.data_ptr(), rows, stream)
    if index == torch.cuda.current_device():
        rc = launch(*args)
    else:
        with torch.cuda.device(index):
            rc = launch(*args)
    if rc != 0:
        raise RuntimeError(f"grouped_sums kernel launch failed: CUDA error "
                           f"{rc}")
    with _LOCK:
        LAUNCHES += 1
    return buf if rows == k else buf[:k]
