"""ctypes binding of the native prefetching frame loader
(counterpart of ``io/native_loader.py``).

``native/frameloader.cpp`` decodes PNG and JPEG frames to float32
grayscale in worker threads, ahead of the consumer. At first use it is
compiled with ``g++`` into ``build/frameloader/<hash of the source and
flags>/`` at the root of the checkout (never into ``native/``), under a
lock file, and loaded. Where it cannot be built (no compiler, no libpng or
libjpeg) the loader reads with PIL (``io.images``), as the JAX package's
does when its library is absent; ``FrameLoader.decoder`` says which ran.
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
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["native_available", "build_native", "FrameLoader", "decode_gray"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "frameloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "frameloader"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lpng16", "-ljpeg", "-lpthread")
_LIB_NAME = "libframeloader.so"
_MAX_PIXELS = 4096 * 3072


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path) -> Optional[Path]:
    """The library in ``out_dir``, compiled there first under an exclusive
    lock if it is not yet; None when it cannot be compiled (the compiler's
    output is kept in ``g++.log``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / _LIB_NAME
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.is_file():
            return lib_path
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            (out_dir / "g++.log").write_text("no C++ compiler on PATH\n")
            return None
        tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        (out_dir / "g++.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, compiled first if needed; None if it cannot be."""
    path = _compile(_build_dir())
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # built elsewhere, and this machine lacks libpng or libjpeg
        return None
    lib.frameloader_open.restype = ctypes.c_void_p
    lib.frameloader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.frameloader_next.restype = ctypes.c_int
    lib.frameloader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.frameloader_close.restype = None
    lib.frameloader_close.argtypes = [ctypes.c_void_p]
    lib.frameloader_decode.restype = ctypes.c_int
    lib.frameloader_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def build_native() -> bool:
    """Compile the library if it is not yet; whether it is available."""
    return _load() is not None


def native_available() -> bool:
    return build_native()


def decode_gray(path: str) -> Optional[np.ndarray]:
    """One synchronous native decode (16-bit PNGs are cut to 8 bits); None
    when the library is unavailable or the decode fails."""
    lib = _load()
    if lib is None:
        return None
    buf = np.empty(_MAX_PIXELS, np.float32)
    h, w = ctypes.c_int(), ctypes.c_int()
    ok = lib.frameloader_decode(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _MAX_PIXELS, ctypes.byref(h), ctypes.byref(w))
    if not ok or h.value <= 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class FrameLoader:
    """Prefetching iterator over image files, in the order given, through
    the native pipeline, or through synchronous PIL decoding where the
    library cannot be built. ``decoder`` is ``"native"`` or ``"pil"``."""

    def __init__(self, paths: List[str], n_threads: int = 2, ring_capacity: int = 8):
        self._paths = list(paths)
        self._lib = _load()
        self._handle = None
        self.decoder = "pil" if self._lib is None else "native"
        if self._lib is not None:
            self._names = (ctypes.c_char_p * len(self._paths))(
                *[p.encode() for p in self._paths])
            self._handle = self._lib.frameloader_open(
                self._names, len(self._paths), n_threads, ring_capacity)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._lib is None:
            from .images import load_gray

            for p in self._paths:
                yield load_gray(p)
            return
        if self._handle is None:
            raise RuntimeError("FrameLoader: iterated after close()")
        buf = np.empty(_MAX_PIXELS, np.float32)
        h, w = ctypes.c_int(), ctypes.c_int()
        while True:
            got = self._lib.frameloader_next(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                _MAX_PIXELS, ctypes.byref(h), ctypes.byref(w))
            if not got:
                return
            if h.value < 0:
                raise IOError("native frame decode failed")
            yield buf[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle is not None:
            self._lib.frameloader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
