"""Build and load the port's CUDA kernels.

Each source under `csrc/` compiles with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. Libraries go to `build/kernels/` at the repository root, named by a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is reused. Nothing builds at import: the first call of a
kernel's wrapper builds it, as does `load_library(name)`. Beside each
library, `lib<name>_<hash>.ptxas.txt` keeps ptxas's register, shared memory
and spill lines of its build (`ptxas_lines`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# kernel name -> source, relative to the package
SOURCES: Dict[str, str] = {
    "fused_header": "csrc/fused_header.cu",
    "sorted_scatter": "csrc/sorted_scatter.cu",
    "scatter_grid": "csrc/scatter_grid.cu",
    "grid_gather_tta": "csrc/grid_gather_tta.cu",
    "scatter_tta": "csrc/scatter_tta.cu",
    "bn_act": "csrc/bn_act.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot build")
    return path


def library_path(name: str) -> Path:
    src = PACKAGE_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def ptxas_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def ptxas_lines(name: str) -> List[str]:
    """ptxas's register, shared memory and spill lines of the kernel's
    build, each after the function they belong to; builds it first if it is
    not built yet."""
    load_library(name)
    return ptxas_path(name).read_text().splitlines()


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of one kernel, compiling it first if it is not
    built yet (and then printing ptxas's register and spill counts, each
    after the kernel they belong to, and keeping them beside the library).
    Raises if nvcc fails."""
    path = library_path(name)
    if not (path.exists() and ptxas_path(name).exists()):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(PACKAGE_DIR / SOURCES[name])],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building kernel {name} failed (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        lines = [line.strip() for line in
                 (proc.stdout + proc.stderr).splitlines()
                 if any(w in line for w in ("Function properties", "registers",
                                            "spill"))]
        for line in lines:
            print(f"{name}: {line}", flush=True)
        tmp_txt = tmp.with_suffix(".ptxas.tmp")
        tmp_txt.write_text("".join(f"{line}\n" for line in lines))
        os.replace(tmp_txt, ptxas_path(name))  # before the library: a built
        os.replace(tmp, path)                  # library always has its lines
    return ctypes.CDLL(str(path))
