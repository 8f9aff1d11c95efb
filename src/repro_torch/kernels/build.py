"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/repro_torch_kernels/<name>-<hash>.so`` at the repository root (the
hash covers the source and the shared ``csrc/*.cuh`` headers, so an edited
kernel is rebuilt), its compiler log beside it as ``<name>-<hash>.log``. Nothing is built when this module is imported: ``load``
builds one library at first use, ``build_all`` starts one nvcc per source at
once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    """Names of the kernel sources, without the ``.cu`` suffix."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
            exe = str(Path(CUDA_HOME) / "bin" / "nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _lib_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    tmp.replace(out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source that is not built yet, all nvcc processes in
    parallel. Returns each newly built source's compiler log (register and
    shared-memory use from ``-Xptxas -v``)."""
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        return {name: _finish(name, job) for name, job in jobs.items()
                if job is not None}


def compiler_log(name: str) -> str:
    """The compiler log (``-Xptxas -v``) of the built ``csrc/<name>.cu``."""
    return _lib_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
