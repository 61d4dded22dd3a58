"""Host helpers in C and C++: a source of ``csrc/`` (``<name>.c`` built
with the host's C compiler, ``cc`` or ``gcc``; ``<name>.cpp`` with its
C++ compiler, ``c++`` or ``g++``) compiled into the package's ``_build``
directory, once per source content and flags, and loaded through ctypes.
Used where a host loop is sequential by nature (the digests' merge loop,
a Parquet BYTE_ARRAY page's length walk, the page codec's LZ4 and
xxHash64). No compiler is an error.

Several processes may build the same library at once (a coordinator and
its worker processes on one host): each compiles into a temporary file
named by its pid and thread, and ``os.replace`` puts one whole library
in place, so a reader never loads a half-written file."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC")
CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _compiler(cxx: bool) -> Optional[str]:
    names = ("c++", "g++") if cxx else ("cc", "gcc")
    for n in names:
        path = shutil.which(n)
        if path is not None:
            return path
    return None


def load_c(name: str, cflags: Optional[Sequence[str]] = None
           ) -> ctypes.CDLL:
    """``csrc/<name>.c`` (or ``csrc/<name>.cpp``) as a loaded shared
    library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        source = CSRC / f"{name}.c"
        cxx = not source.exists()
        if cxx:
            source = CSRC / f"{name}.cpp"
        flags = tuple(cflags if cflags is not None
                      else (CXXFLAGS if cxx else CFLAGS))
        cc = _compiler(cxx)
        if cc is None:
            kind = "C++ compiler (c++ or g++)" if cxx \
                else "C compiler (cc or gcc)"
            raise RuntimeError(f"no {kind} found: {source} cannot be "
                               "built")
        src = source.read_bytes()
        tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
        so = BUILD_DIR / f"lib{name}-{tag[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                proc = subprocess.run([cc, *flags, "-o", str(tmp),
                                       str(source)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cc} failed for {source}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            finally:
                if tmp.exists():
                    tmp.unlink()
        lib = _LIBS[name] = ctypes.CDLL(str(so))
        return lib
