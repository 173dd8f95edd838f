"""Build and load the port's hand-written CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, bound with ``ctypes``: no source includes PyTorch's headers, so
a build takes seconds.  Each source compiles in its own ``nvcc`` process,
all started together, and one more links the objects.  The library goes to ``build/piml_tpu_torch/<hash>/``
at the repository root, keyed by a hash of the sources and flags, and is
built at first use — importing this module builds nothing.

``--fmad=false`` and the absence of ``--use_fast_math`` are part of the
kernels' contract: no multiply-add contraction and correctly rounded
``sqrtf`` / division make each kernel bitwise equal to its plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "piml_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libpiml_topk.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    # rows, n, cols, m, slices, cols_per_slice, cos_thr, self_pairs, k,
    # out_d, out_i, stream
    "piml_pairwise_topk": (_P, _I, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P),
    # ws, geo, geo_cstride, rows, n_pad, channels, cols, m_band,
    # cols_cstride, offsets, offsets_cstride, window, grid_dim, cos_thr,
    # self_pairs, k, out_d, out_i, stream
    "piml_banded_topk": (_P, _P, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                         _F, _I, _I, _P, _P, _P),
    # pos, frames, n, slices, cols_per_slice, thresholds, thr0, thr1,
    # out0, out1, stream
    "piml_contact_counts": (_P, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P),
    # pos, vel, dir, goal, n, splits, cols_per_split, law, A, B, C, D,
    # coll, rot, partial, out, stream
    "piml_mlapm_force": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                         _FP, _P, _P, _P),
}


@dataclasses.dataclass
class KernelCount:
    """Launch bookkeeping of one kernel wrapper: ``launches`` grows by one
    where the wrapper launches its kernel and nowhere else; ``fallbacks``
    counts frames whose banded result was not provably exact and were
    recomputed by the dense path (banded selector only); ``wide_calls``
    counts the half-grid banded passes that replace that dense path past
    its column ceiling, and ``wide_relaxed`` those of them whose result was
    used without an exactness proof (``physics/features.py``
    ``_banded_wide_fallback``); ``sharded_calls`` counts the agent-sharded
    banded passes (``parallel/agent_shard.py``
    ``sharded_banded_features``), whose ring fallbacks count in
    ``fallbacks``."""

    launches: int = 0
    fallbacks: int = 0
    wide_calls: int = 0
    wide_relaxed: int = 0
    sharded_calls: int = 0


class _Library:
    """The loaded kernel library, built on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.path: Optional[Path] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        import time

        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(CSRC.glob("*.cu*")):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        path = out_dir / LIB_NAME
        t0 = time.perf_counter()
        out_dir.mkdir(parents=True, exist_ok=True)
        # several processes of one host (the ranks of spawn_local) may reach
        # a first build together: one builds, the others wait on the lock
        with open(out_dir / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not path.exists():
                _compile(sources, out_dir, path)
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


def _run_all(cmds) -> None:
    """Run the commands at the same time; raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed (%d):\n%s\n%s"
                          % (proc.returncode, " ".join(cmd), err))
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(sources, out_dir: Path, path: Path) -> None:
    """One ``nvcc -c`` per source in parallel, then one link; the library
    is published atomically under ``path``."""
    nvcc = _find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources, objs)])
        lib = os.path.join(tmp, LIB_NAME)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)  # atomic publish


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


LIBRARY = _Library()


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer."""
    return torch.cuda.current_stream(device).cuda_stream
