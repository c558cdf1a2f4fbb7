"""Build the native loader (`loader.cpp`) into a shared library.

    python -m streammos_tpu_torch.native.build

Plain g++ (a C ABI bound with ctypes). The library goes to `build/native/`
at the repository root, never into the source tree, named by a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is reused. A failed build raises: there is no silent fall-back to numpy.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(source: Optional[Path] = None) -> Path:
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsmtloader_{digest}.so"


def build(source: Optional[Path] = None) -> Path:
    """The library built from `source` (default `loader.cpp`), compiling it
    if it is not built yet. Raises RuntimeError if g++ is missing or
    fails."""
    source = Path(source or SOURCE)
    path = library_path(source)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native loader cannot "
                           "build (pass native=False to the datasets for the "
                           "numpy path)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader from {source} failed "
                           f"(g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


if __name__ == "__main__":
    print(build())
