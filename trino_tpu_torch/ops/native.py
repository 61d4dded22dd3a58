"""Host C helpers: a C source of ``csrc/`` compiled with the host's C
compiler (``cc`` or ``gcc``) into the package's ``_build`` directory, once
per source content and flags, and loaded through ctypes. Used where a
host loop is sequential by nature (the digests' merge loop, a Parquet
BYTE_ARRAY page's length walk). No compiler is an error."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def load_c(name: str, cflags: Sequence[str] = CFLAGS) -> ctypes.CDLL:
    """``csrc/<name>.c`` as a loaded shared library."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        source = CSRC / f"{name}.c"
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("no C compiler (cc or gcc) found: "
                               f"{source} cannot be built")
        src = source.read_bytes()
        tag = hashlib.sha256(src + " ".join(cflags).encode()).hexdigest()
        so = BUILD_DIR / f"lib{name}-{tag[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cc, *cflags, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cc} failed for {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = _LIBS[name] = ctypes.CDLL(str(so))
        return lib
