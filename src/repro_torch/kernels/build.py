"""Build the port's CUDA sources (`csrc/*.cu`) into shared libraries
with a plain C interface, and load them with ctypes.

Each source is compiled by `nvcc` for `sm_90a` into `_build/` beside
this file (listed in `.gitignore`) the first time it is needed. The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. `nvcc`
failing raises with its stderr: there is no fallback. `build_all`
starts one `nvcc` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names (without `.cu`) of every CUDA source of the port."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin "
                           "directory on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[str, str, subprocess.Popen]:
    out = library_path(name)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp: str, proc: subprocess.Popen) -> str:
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{stderr}{stdout}")
    with open(out + ".log", "w") as f:       # ptxas register/spill report
        f.write(stderr + stdout)
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, str]:
    """Build every source whose library is missing, one `nvcc` process
    per source started together. Returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
        pending = [(n, *_start(n)) for n in sources()
                   if not os.path.exists(library_path(n))]
        for name, out, tmp, proc in pending:
            _finish(name, out, tmp, proc)
    return {n: library_path(n) for n in sources()}


def build_log(name: str) -> str:
    """What ptxas reported for the built library (registers, spills)."""
    path = library_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
