"""The native ``.mat`` reader: the port's copy of ip_avsr_tpu/native.

``matread.cc`` is a strict little-endian MAT-v5 parser for the numeric
arrays that make up the whole ``.mat`` ABI (datasets, ``w1..wN``
checkpoints, LSTM bundles).  It is host code: ``g++`` builds it at first
use (``-O2 -std=c++17 -fPIC -shared``, zlib) into ``ip_avsr_torch/_build/``,
the library named by a hash of the source and the flags, written to a
temporary file and moved into place, so concurrent processes never load a
half-written library.  It is driven through ``ctypes``, which releases the
GIL for each call, so :func:`load_many` parses and inflates many files in
parallel from a thread pool.

A failed build raises ``RuntimeError`` with the compiler's output: the
reader never turns into scipy because it could not be built.  A file
outside the strict subset (cell, char, struct, sparse, complex, logical or
big-endian arrays, a corrupt file) makes :func:`load_mat_native` return
``None``, and the caller (``io/matio.load_mat_file``) reads it with
``scipy.io.loadmat``.  ``IP_AVSR_NATIVE=0`` turns the reader off: every file
is read by scipy and nothing is built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "matread.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-lz",)

_lib = None
_lib_lock = threading.Lock()

# MAT v5 storage (mi*) types -> numpy dtypes
_MITYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16, 5: np.int32,
            6: np.uint32, 7: np.float32, 9: np.float64, 12: np.int64,
            13: np.uint64}
# MATLAB array classes (mx*) -> numpy dtypes
_CLASSES = {6: np.float64, 7: np.float32, 8: np.int8, 9: np.uint8,
            10: np.int16, 11: np.uint16, 12: np.int32, 13: np.uint32,
            14: np.int64, 15: np.uint64}


def enabled() -> bool:
    """False when ``IP_AVSR_NATIVE=0`` turns the reader off."""
    return os.environ.get("IP_AVSR_NATIVE", "1") != "0"


def available() -> bool:
    """True when the reader is on; the library is built first (a failed
    build raises)."""
    if not enabled():
        return False
    _load_lib()
    return True


def _lib_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"matread-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``matread.cc`` unless its library is up to date; returns the
    library's path.  Raises ``RuntimeError`` naming the compiler's output
    when the compiler is missing or fails."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native .mat reader: cannot run {' '.join(cmd)!r}: {e} (it "
                           "needs g++ and zlib's headers; IP_AVSR_NATIVE=0 reads every "
                           "file with scipy)") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native .mat reader: {' '.join(cmd)!r} failed with exit "
                           f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.ipav_open.restype = ctypes.c_void_p
        lib.ipav_open.argtypes = [ctypes.c_char_p]
        lib.ipav_error.restype = ctypes.c_char_p
        lib.ipav_error.argtypes = [ctypes.c_void_p]
        lib.ipav_count.restype = ctypes.c_int
        lib.ipav_count.argtypes = [ctypes.c_void_p]
        lib.ipav_name.restype = ctypes.c_char_p
        lib.ipav_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_mitype.restype = ctypes.c_int
        lib.ipav_mitype.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_class.restype = ctypes.c_int
        lib.ipav_class.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_ndim.restype = ctypes.c_int
        lib.ipav_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_dims.restype = ctypes.POINTER(ctypes.c_int64)
        lib.ipav_dims.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_data.restype = ctypes.c_void_p
        lib.ipav_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_nbytes.restype = ctypes.c_int64
        lib.ipav_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ipav_close.restype = None
        lib.ipav_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_mat_native(path) -> Optional[dict]:
    """Parse one .mat file into ``scipy.io.loadmat``'s dict (storage dtypes,
    Fortran data order, arrays at least 2-D), or ``None`` when the file
    needs scipy (or the reader is off)."""
    if not enabled():
        return None
    lib = _load_lib()
    h = lib.ipav_open(os.fsencode(str(path)))
    try:
        if lib.ipav_error(h):
            return None
        out = {"__header__": b"MATLAB 5.0 MAT-file (ip_avsr_torch native reader)",
               "__version__": "1.0", "__globals__": []}
        for i in range(lib.ipav_count(h)):
            mitype = lib.ipav_mitype(h, i)
            mclass = lib.ipav_class(h, i)
            if mitype not in _MITYPES or mclass not in _CLASSES:
                return None
            nd = lib.ipav_ndim(h, i)
            dims = [lib.ipav_dims(h, i)[j] for j in range(nd)]
            nbytes = lib.ipav_nbytes(h, i)
            if nbytes:
                # one copy: view the C buffer, reshape Fortran, materialize
                buf = (ctypes.c_char * nbytes).from_address(lib.ipav_data(h, i))
                arr = (np.frombuffer(buf, dtype=_MITYPES[mitype])
                       .reshape(dims, order="F").copy(order="F"))
            else:
                arr = np.empty(dims, dtype=_MITYPES[mitype], order="F")
            # scipy's default mat_dtype=False keeps the storage dtype
            out[lib.ipav_name(h, i).decode()] = arr
        return out
    except ValueError:
        # a name that is not UTF-8 (UnicodeDecodeError) or data that does not
        # fill its dims, in a crafted or damaged file: scipy reads or rejects it
        return None
    finally:
        lib.ipav_close(h)


def load_many(paths, workers: Optional[int] = None) -> list:
    """Parse many .mat files in a thread pool of ``workers`` (default
    ``min(16, cpu_count)``; the C parse and zlib run without the GIL),
    ``scipy.io.loadmat`` reading each file the parser rejects.  Returns
    dicts in input order."""
    import scipy.io as sio

    if not enabled():
        return [sio.loadmat(p) for p in paths]
    if workers is None:
        workers = min(16, os.cpu_count() or 4)

    def one(p):
        d = load_mat_native(p)
        return d if d is not None else sio.loadmat(p)

    if workers <= 1 or len(paths) <= 1:
        return [one(p) for p in paths]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(one, paths))
