"""Build and load the port's CUDA kernels: nvcc into a shared library, ctypes in.

At first use ``library()`` compiles every ``src/repro_torch/csrc/*.cu``, one
``nvcc`` process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c <source>.cu

and links the objects with ``nvcc -shared`` into
``build/repro_torch/<content hash>/`` at the root of the checkout (the hash
covers the flags, the sources and the ``*.cuh`` headers), so a fresh
checkout builds from its own sources and a changed source never loads a
stale library. The sources expose a plain C interface; the library is loaded
with ``ctypes`` and every function gets explicit ``argtypes`` (pointers and
the stream as ``c_void_p``, counts as ``c_int64``, beta as ``c_float``, the
fused reduce's mode and leader and a tuned launch's block size as ``c_int``).

Four launches take their block size as an argument: the vec4 select at
top-1 (``chunk_argmax``), ``ef_update``, the vec4 fused reduce's clt_k
route at top-1 and ``fused_select_update`` at top-1. ``CANDIDATE_THREADS``
are the sizes the library was built for (``TunedThreads`` in
``csrc/common.cuh``), ``DEFAULT_THREADS`` the size each took when it was a
constant; ``threads_arg`` checks a size asked for.

Nothing here runs at import time, and nothing is skipped: without CUDA, an
sm_90 card or ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch.device import require_sm90

__all__ = [
    "library", "build_info", "check", "on_card", "stream_of", "require", "threads_arg",
    "CSRC", "NVCC_FLAGS", "CANDIDATE_THREADS", "DEFAULT_THREADS",
]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libscalecom_kernels.so"

# block sizes of a tuned launch: csrc/common.cuh:TunedThreads, kDefaultThreads
CANDIDATE_THREADS = (64, 128, 256, 512, 1024)
DEFAULT_THREADS = 256

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_I32 = ctypes.c_int
_SIGNATURES = {
    "scalecom_chunk_argmax": (_P, _P, _P, _I64, _I64, _P),
    "scalecom_chunk_argmax_vec4": (_P, _P, _P, _I64, _I64, _I32, _P),
    "scalecom_chunk_topm": (_P, _P, _P, _I64, _I64, _I64, _P),
    "scalecom_chunk_topm_vec4": (_P, _P, _P, _I64, _I64, _I64, _P),
    "scalecom_chunk_gather": (_P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "scalecom_ef_update": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _F32, _I32, _P),
    "scalecom_chunk_scatter": (_P, _P, _P, _I64, _I64, _I64, _P),
    "scalecom_chunk_scatter_vec4": (_P, _P, _P, _I64, _I64, _I64, _P),
    "scalecom_fused_reduce": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _F32, _P,
    ),
    "scalecom_fused_reduce_vec4": (
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _F32, _I32, _P, _P,
    ),
    "scalecom_fused_select_update": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _F32, _I32, _P),
}

# filled by library(): seconds the build took (0.0 when it was cached on
# disk), the library path, and what ptxas said about registers and spills
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the repro_torch "
        "CUDA kernels are built from src/repro_torch/csrc/ at first use"
    )


def _sources():
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def _run_nvcc(cmds) -> str:
    """Run the nvcc commands concurrently; raise naming the first that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building the repro_torch "
                f"kernels:\n{' '.join(cmd)}\n{log}"
            )
    return "".join(logs)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (raises on any failure)."""
    require_sm90()
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    t0 = time.perf_counter()
    log = ""
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        log = _run_nvcc([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources, objs)])
        tmp = out_dir / f"{_LIB_NAME}.{tag}.tmp"
        log += _run_nvcc([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib_path)
    build_info.update(
        seconds=time.perf_counter() - t0, path=str(lib_path), ptxas=log
    )
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel} failed to launch: cudaError {rc}"
        )


def on_card(kernel: str, *tensors: torch.Tensor) -> bool:
    """True if the tensors lie on the card (launch), False on the CPU (plain).

    Mixed devices, or any device but cuda and cpu, raise.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel}: tensors must lie on cuda or cpu, not {dev}")
    return dev.type == "cuda"


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, kernel: str, what: str) -> None:
    """Raise ValueError naming the kernel when an input check fails."""
    if not cond:
        raise ValueError(f"{kernel}: {what}")


def threads_arg(threads, kernel: str) -> None:
    """Raise ValueError unless ``threads`` is None (the default size)
    or one of ``CANDIDATE_THREADS``; no other size falls back to the default."""
    require(threads is None or (type(threads) is int and threads in CANDIDATE_THREADS), kernel,
            f"threads must be one of {CANDIDATE_THREADS}, got {threads!r}")
