"""Host segment trees for prioritized replay (counterpart of
:mod:`rl_tpu.csrc`): :class:`SumSegmentTree` and :class:`MinSegmentTree`
over the C interface of ``segment_tree.cpp``, bound with :mod:`ctypes`.

The library is built at first use, never at import: ``g++ -O3 -shared
-fPIC -std=c++17`` into ``build/rl_tpu_torch/`` at the root of the
checkout (:data:`BUILD_DIR`), under a name hashed from the source and the
flags, so an unchanged source is loaded without running ``g++``. The
compiler writes a temporary file named by the process id, which
``os.replace`` then renames: a process that builds at the same time as
another, or loads while another builds, always loads a whole library. A
lock serialises the build within the process. A missing ``g++`` or a
failed build raises; nothing here switches to numpy.

``_NumpySumTree`` and ``_NumpyMinTree`` are the same trees in numpy (an
O(N) scan), kept beside them for the tests that hold the library to
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR

__all__ = ["BUILD_DIR", "GXX_FLAGS", "MinSegmentTree", "SumSegmentTree", "library_path"]

SOURCE = Path(__file__).resolve().parent / "segment_tree.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}  # library path -> loaded library

_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_F64 = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {  # symbol: (restype, argtypes)
    "st_new": (ctypes.c_void_p, [ctypes.c_int64, ctypes.c_int32]),
    "st_free": (None, [ctypes.c_void_p]),
    "st_capacity": (ctypes.c_int64, [ctypes.c_void_p]),
    "st_set": (None, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]),
    "st_get": (ctypes.c_double, [ctypes.c_void_p, ctypes.c_int64]),
    "st_set_batch": (None, [ctypes.c_void_p, _P_I64, _P_F64, ctypes.c_int64]),
    "st_get_batch": (None, [ctypes.c_void_p, _P_I64, _P_F64, ctypes.c_int64]),
    "st_reduce": (ctypes.c_double, [ctypes.c_void_p]),
    "st_reduce_range": (ctypes.c_double, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]),
    "st_prefix_search": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_double]),
    "st_prefix_search_batch": (None, [ctypes.c_void_p, _P_F64, _P_I64, ctypes.c_int64]),
}


def library_path(build_dir: Path | None = None) -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return Path(build_dir or BUILD_DIR) / f"libsegment_tree-{digest[:16]}.so"


def _build(target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: readers never see half a file


def load(build_dir: Path | None = None) -> ctypes.CDLL:
    """The typed library, built first if no library for this source and
    these flags exists under ``build_dir`` (default :data:`BUILD_DIR`)."""
    target = library_path(build_dir)
    with _lock:
        lib = _libs.get(target)
        if lib is None:
            if not target.exists():
                try:
                    _build(target)
                except FileNotFoundError as e:  # no g++ on PATH
                    raise RuntimeError(f"g++ not found: {SOURCE.name} cannot be built") from e
            lib = ctypes.CDLL(str(target))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _libs[target] = lib
    return lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


class _NativeTree:
    IS_NATIVE = True

    def __init__(self, capacity: int, is_min: bool):
        self._lib = load()
        self.capacity = capacity
        self._h = ctypes.c_void_p(self._lib.st_new(capacity, 1 if is_min else 0))
        if not self._h:
            raise MemoryError(f"segment tree of capacity {capacity} could not be allocated")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.st_free(self._h)
            self._h = None

    def __setitem__(self, idx, value):
        if np.ndim(idx) == 0:
            self._lib.st_set(self._h, int(idx), float(value))
            return
        idx = _i64(idx)
        vals = _f64(np.broadcast_to(value, idx.shape))
        self._lib.st_set_batch(self._h, idx.ctypes.data_as(_P_I64),
                               vals.ctypes.data_as(_P_F64), idx.size)

    def __getitem__(self, idx):
        if np.ndim(idx) == 0:
            return self._lib.st_get(self._h, int(idx))
        idx = _i64(idx)
        out = np.empty(idx.shape, np.float64)
        self._lib.st_get_batch(self._h, idx.ctypes.data_as(_P_I64),
                               out.ctypes.data_as(_P_F64), idx.size)
        return out

    def reduce(self, start: int = 0, end: int | None = None) -> float:
        """The sum (min) of ``[start, end)``; the whole tree by default."""
        if start == 0 and end is None:
            return self._lib.st_reduce(self._h)
        end = self.capacity if end is None else end
        return self._lib.st_reduce_range(self._h, start, end)


class SumSegmentTree(_NativeTree):
    """O(log N) sum tree with prefix-sum search."""

    def __init__(self, capacity: int):
        super().__init__(capacity, is_min=False)

    def scan(self, us) -> np.ndarray:
        """For each u: the smallest idx with prefix-sum(0..idx) > u
        (clipped to ``capacity - 1``)."""
        us = _f64(np.atleast_1d(us))
        out = np.empty(us.shape, np.int64)
        self._lib.st_prefix_search_batch(self._h, us.ctypes.data_as(_P_F64),
                                         out.ctypes.data_as(_P_I64), us.size)
        return out


class MinSegmentTree(_NativeTree):
    """O(log N) min tree (empty leaves hold +inf)."""

    def __init__(self, capacity: int):
        super().__init__(capacity, is_min=True)


class _NumpySumTree:
    """The sum tree in numpy (O(N) scan): what the library is tested against."""

    IS_NATIVE = False

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._v = np.zeros(capacity, np.float64)

    def __setitem__(self, idx, value):
        self._v[idx] = value

    def __getitem__(self, idx):
        return self._v[idx]

    def reduce(self, start: int = 0, end: int | None = None) -> float:
        return float(self._v[start:end].sum())

    def scan(self, us) -> np.ndarray:
        cs = np.cumsum(self._v)
        return np.clip(np.searchsorted(cs, np.atleast_1d(us), side="right"), 0,
                       self.capacity - 1)


class _NumpyMinTree:
    """The min tree in numpy."""

    IS_NATIVE = False

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._v = np.full(capacity, np.inf, np.float64)

    def __setitem__(self, idx, value):
        self._v[idx] = value

    def __getitem__(self, idx):
        return self._v[idx]

    def reduce(self, start: int = 0, end: int | None = None) -> float:
        return float(self._v[start:end].min())
