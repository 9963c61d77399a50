"""Builds ``ip_avsr_torch/csrc/*.cu`` into shared libraries at first use.

Each source is compiled alone by ``nvcc`` for ``sm_90a`` into a library with a
plain C interface, loaded with ``ctypes``.  The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt and a
matching one is reused.  Output goes to ``ip_avsr_torch/_build/``, which git
ignores.  :func:`build` starts one ``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("adam", "delta", "lstm_bwd", "lstm_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Shared memory one block may use on Hopper (the opt-in maximum).
SMEM_LIMIT = 232448

_lock = threading.Lock()
_loaded: dict = {}
build_logs: dict = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under CUDA_HOME)")
    return path


def nvcc_version() -> str:
    return subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``; the compiler's messages (``-Xptxas -v``
    register and shared-memory counts) land in :data:`build_logs`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build((name,))[name])
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        describe = getattr(lib, f"{prefix}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        msg = describe(code).decode()
        raise RuntimeError(f"{prefix} kernel failed: CUDA error {code} ({msg})")
