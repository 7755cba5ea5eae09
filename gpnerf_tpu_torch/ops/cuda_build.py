"""Build and load the package's hand-written CUDA kernels.

Each kernel source under gpnerf_tpu_torch/csrc/ has a plain C interface
(`extern "C"` launch functions that return `cudaGetLastError()`), so it is
compiled by nvcc alone into a shared library and loaded with ctypes; no
PyTorch header is involved. Libraries go to gpnerf_tpu_torch/_build/
(git-ignored) at first use; the file name carries the hash of the source
and of the macro definitions, so an edited source rebuilds.

`start_build` only starts nvcc, so a caller can start every source at once
and then `load` them one after the other. nvcc writes a file of its
process's own that is renamed into place, so ranks of a data-parallel job
that build the same library at once each load a whole one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else (shutil.which("nvcc") or cand)


def build_command(source, name, defines=()):
    """(nvcc argv, library path) for `source` (a file name under csrc/)
    compiled with the `-D` macro definitions `defines` ("KEY=VALUE"
    strings) into lib<name>_<hash>.so."""
    path = os.path.join(CSRC_DIR, source)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    h.update("\0".join(defines).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *(f"-D{d}" for d in defines), "-o", lib, path,
    ]
    return cmd, lib


def _tmp_path(lib_path):
    return f"{lib_path}.{os.getpid()}.tmp"


def start_build(source, name, defines=()):
    """Start nvcc unless the hashed library exists; returns the Popen (or
    None) to hand to `load`."""
    cmd, lib_path = build_command(source, name, defines)
    if os.path.exists(lib_path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd[cmd.index("-o") + 1] = _tmp_path(lib_path)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load(source, name, defines=(), proc=None, build_log=None, log_key=None):
    """Build (unless the hashed library exists, or `proc` is an already
    started `start_build` of the same arguments) and load the library.
    A build's seconds and compiler output go to build_log[log_key]."""
    _, lib_path = build_command(source, name, defines)
    t0 = time.perf_counter()
    if proc is None:
        proc = start_build(source, name, defines)
    if proc is not None:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {list(defines)}:\n{out}")
        os.replace(_tmp_path(lib_path), lib_path)
        if build_log is not None:
            build_log[log_key] = {"seconds": time.perf_counter() - t0, "output": out}
    return ctypes.CDLL(lib_path)
