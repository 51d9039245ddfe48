"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain ``extern "C"`` interface. At first use each is
compiled with ``nvcc`` for ``sm_90a``, all at once in parallel, and the
objects are linked into one shared library under
``build/kernels/<hash of the sources>/`` at the root of the checkout,
cached by that hash and guarded by a lock file, then loaded with
``ctypes``. Nothing here runs at import time: the build is reached only
from a wrapper called with a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_ROOT", "library", "build_dir", "check_launch",
           "require_cuda"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
_LIB_NAME = "libosltt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source besides NVCC_FLAGS: the pose LM rounds every product
# and sum apart, as its plain version's PyTorch ops do (with products
# contracted into FMAs its poses parted from the plain arithmetic's about
# eight times further, PERF.md)
SOURCE_FLAGS = {"pose_lm.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point: (argtypes, restype int = the
# cudaGetLastError() after the launch)
_SIGNATURES = {
    "osltt_fast_score": (_P, _P, _I, _I, _I, _I, _P),
    "osltt_brief_words": (_P, _I, _I, _P, _P, _P, _I, _P),
    "osltt_hamming_matrix": (_P, _P, _P, _I, _I, _P),
    "osltt_hamming_gated_min": (_P, _P, _I, _I, _I) + (_P,) * 14,
    "osltt_moments_at": (_P, _I, _I, _P, _P, _P, _P, _P, _I, _P),
    "osltt_orient_describe": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                              _I, _I, _P),
    "osltt_pose_lm": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I) + (_P,) * 7,
}


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(p.name, ())).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "CUDA kernels cannot be built")


def _build(out_dir: Path) -> Path:
    """Compile into ``out_dir`` under an exclusive lock (one nvcc per source,
    all started together, then one link); return the .so."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / _LIB_NAME
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.is_file():
            return lib_path
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = out_dir / f".{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", "-o", str(obj),
                   str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        log, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=900)
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{Path(cmd[-1]).name} ({proc.returncode}):\n{out}")
        tmp = out_dir / f".{_LIB_NAME}.{tag}"
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        (out_dir / "nvcc.log").write_text("".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    lib = ctypes.CDLL(str(_build(build_dir())))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.osltt_error_string.argtypes = [ctypes.c_int]
    lib.osltt_error_string.restype = ctypes.c_char_p
    return lib


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``ndim``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().osltt_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
