"""Build and load the port's CUDA kernels (the ctypes route).

At first use every ``csrc/*.cu`` (with the shared ``csrc/*.cuh`` headers
it includes) is compiled by ``nvcc`` into its own shared library with a plain C interface, one ``nvcc`` per source, all
started together. The libraries go to ``build/rl_tpu_torch/`` at the root
of the checkout, named by a hash of the source and the flags, so an
unchanged source is not rebuilt. They are loaded with :mod:`ctypes`.
Beside each library, ``<library>.log`` keeps what the compiler printed,
``ptxas``'s registers, shared memory and spills per kernel among it
(:func:`ptxas_usage`).

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception. A missing ``nvcc``
or a failed build raises: nothing here switches to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "check", "count_launch", "function",
           "ptxas_usage"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # source stem -> loaded library
_fns: dict[tuple, object] = {}  # (stem, symbol) -> typed function


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the "
        "rl_tpu_torch CUDA kernels cannot be built"
    )


def _target(stem: str) -> Path:
    # the digest covers the shared headers too: a header edit rebuilds
    src = (CSRC / f"{stem}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel;
    returns ``{stem: library path}``. Raises on any failure."""
    targets = {stem: _target(stem) for stem in sorted(p.stem for p in CSRC.glob("*.cu"))}
    todo = {s: t for s, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
                ),
                tmp,
            )
        errors = []
        for stem, (proc, tmp) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{stem}.cu (exit {proc.returncode}):\n{out}{err}")
                tmp.unlink(missing_ok=True)
            else:
                todo[stem].with_suffix(".so.log").write_text(out + err)
                os.replace(tmp, todo[stem])  # atomic: readers never see half a file
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return targets


def _load(stem: str) -> ctypes.CDLL:
    lib = _libs.get(stem)
    if lib is None:
        path = build_all()[stem]
        lib = _libs[stem] = ctypes.CDLL(str(path))
    return lib


def function(stem: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``symbol`` of ``csrc/<stem>.cu``, typed with
    ``argtypes`` and ``restype`` (``int``: a launcher's
    ``cudaGetLastError()``). Builds and loads the library at first use."""
    key = (stem, symbol)
    with _lock:
        fn = _fns.get(key)
        if fn is None:
            fn = getattr(_load(stem), symbol)
            fn.argtypes = argtypes
            fn.restype = restype
            _fns[key] = fn
    return fn


def check(code: int, stem: str, what: str) -> None:
    """Raise if a C entry point of ``csrc/<stem>.cu`` reported a CUDA
    error (every source exports ``rl_error_string`` for the message)."""
    if code != 0:
        msg = function(stem, "rl_error_string", [ctypes.c_int], ctypes.c_char_p)
        msg = msg(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` after the wrapper launched its
    kernel. A call made while its stream is captured into a CUDA graph
    launches nothing (each replay of the graph does, and runs no Python),
    so it counts nothing."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_USE = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_usage(stem: str) -> list[dict]:
    """Per kernel of ``csrc/<stem>.cu`` (mangled name), as ``ptxas -v``
    reported it in the last build: registers, static shared memory bytes
    and spill store/load bytes. Builds first if needed."""
    path = build_all()[stem].with_suffix(".so.log")
    if not path.exists():  # built by an older version of this module
        return []
    rows, cur = [], None
    for line in path.read_text().splitlines():
        if m := _PTXAS_FN.search(line):
            cur = {"kernel": m.group(1), "registers": None, "smem": 0,
                   "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
        elif cur is not None:
            if m := _PTXAS_SPILL.search(line):
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            if m := _PTXAS_USE.search(line):
                cur["registers"] = int(m.group(1))
                if sm := _PTXAS_SMEM.search(line):
                    cur["smem"] = int(sm.group(1))
    return rows
