"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each kernel source `src/repro_torch/csrc/<name>.cu` exports a plain C
function and is compiled by `nvcc` into its own shared library, at first
use, under `build/kernels/` at the root of the checkout.  The library's
file name carries a hash of everything its build reads: its source, every
shared header `csrc/*.cuh` and the nvcc flags, so an edit to any of them
is rebuilt and a stale library is never loaded.  A missing `nvcc` or a
failed build raises: there is no fallback.

`build(*names)` starts one `nvcc` per missing library, all at once, and
waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}  # process-wide cache of loaded libs


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """`nvcc` on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file() and os.access(cand, os.X_OK):
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "are built from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """`build/kernels/<name>-<hash>.so`, the hash over `<name>.cu`, every
    `csrc/*.cuh` (by name and content) and `NVCC_FLAGS`."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, ctypes.CDLL]:
    """Build (where needed) and load the named kernels' libraries.  The
    ptxas report (registers, shared memory, spills) of each fresh build is
    kept beside its library as `<lib>.log`."""
    todo = [n for n in names if n not in _loaded]
    if not todo:
        return {n: _loaded[n] for n in names}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    for name in todo:
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return {n: _loaded[n] for n in names}
