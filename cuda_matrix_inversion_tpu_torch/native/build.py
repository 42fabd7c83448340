"""Build the native oracle and parser into ``libcmi_native.so``.

Usage: ``python -m cuda_matrix_inversion_tpu_torch.native.build``.

One ``g++ -O3 -shared -fopenmp`` over ``matsio.cpp`` and ``oracle.cpp``,
linked against the system LAPACK.  The library is written to a temporary
name in ``build/torch_native/`` and renamed onto
``build/torch_native/libcmi_native.so``, so processes that build at the
same time never load a half-written file: each rename is atomic, and every
build of the same sources is a complete library.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "torch_native"
LIB = BUILD_DIR / "libcmi_native.so"
SOURCES = [HERE / "matsio.cpp", HERE / "oracle.cpp"]


class NativeBuildError(RuntimeError):
    """``g++`` refused the sources; the message ends with its last line."""


def build(verbose: bool = True) -> str:
    """Compile the library (always) and return its path.  Raises
    :class:`NativeBuildError` when the compiler fails and ``OSError``
    when there is no ``g++``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
        "-fopenmp",
        "-o", str(tmp), *map(str, SOURCES),
        # Debian ships liblapack.so.3 without the dev symlink
        "-l:liblapack.so.3", "-lgomp",
    ]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            lines = proc.stderr.strip().splitlines() or ["(no output)"]
            raise NativeBuildError(
                f"g++ exited {proc.returncode}: {lines[-1]}")
        os.replace(tmp, LIB)
    finally:
        tmp.unlink(missing_ok=True)
    return str(LIB)


def lib_path() -> str | None:
    """The library's path when it exists and is no older than its
    sources, else None."""
    src_mtime = max(os.path.getmtime(s) for s in SOURCES)
    if LIB.exists() and os.path.getmtime(LIB) >= src_mtime:
        return str(LIB)
    return None


def ensure_built(quiet: bool = True) -> str | None:
    """Build if stale or missing; never raises (returns None when the
    library cannot be built here)."""
    path = lib_path()
    if path:
        return path
    try:
        return build(verbose=not quiet)
    except (OSError, NativeBuildError):
        return None


if __name__ == "__main__":
    print(build())
