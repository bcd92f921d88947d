"""ctypes bindings of the shared-memory ring (``csrc/shm_ring.cpp``).

The library is built with ``g++`` at first use into ``build/native/`` at
the repository root, under a name hashed from the source and the flags,
so a change to either rebuilds and no binary the source did not produce
is ever loaded.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "shm_ring.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libshm_ring-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile the ring unless this source's library exists; a failed
    ``g++`` raises."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC), "-lrt"],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{out.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds each write their own tmp
    return lib


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()), use_errno=True)
            lib.rb_create.restype = ctypes.c_void_p
            lib.rb_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.rb_attach.restype = ctypes.c_void_p
            lib.rb_attach.argtypes = [ctypes.c_char_p]
            lib.rb_push.restype = ctypes.c_int
            lib.rb_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_int]
            lib.rb_pop.restype = ctypes.c_int
            lib.rb_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int]
            lib.rb_size.restype = ctypes.c_uint64
            lib.rb_size.argtypes = [ctypes.c_void_p]
            lib.rb_detach.restype = None
            lib.rb_detach.argtypes = [ctypes.c_void_p]
            lib.rb_unlink.restype = None
            lib.rb_unlink.argtypes = [ctypes.c_char_p]
            _LIB = lib
        return _LIB


def _contiguous(buf, writable: bool) -> np.ndarray:
    if not isinstance(buf, np.ndarray) or not buf.flags.c_contiguous:
        raise ValueError("the ring moves C-contiguous numpy arrays")
    if writable and not buf.flags.writeable:
        raise ValueError("pop_into needs a writable array")
    return buf


class ShmRing:
    """One lock-free SPSC ring in POSIX shared memory: ``create=True`` makes
    (and backs) the segment and unlinks it on ``close``; otherwise the ring
    attaches to an existing one."""

    def __init__(self, name: str, slots: int = 0, slot_bytes: int = 0,
                 create: bool = False):
        self.lib = get_lib()
        self.name = name.encode()
        self._owner = create
        if create:
            self.ptr = self.lib.rb_create(self.name, slots, slot_bytes)
        else:
            self.ptr = self.lib.rb_attach(self.name)
        if not self.ptr:
            err = ctypes.get_errno()
            raise OSError(err, f"shm ring {'create' if create else 'attach'} failed for "
                               f"{name} ({slots} x {slot_bytes} B): {os.strerror(err)}")

    def push(self, buf: np.ndarray, timeout_ms: int = 10000) -> None:
        buf = _contiguous(buf, writable=False)
        rc = self.lib.rb_push(self.ptr, buf.ctypes.data, buf.nbytes, timeout_ms)
        if rc == -1:
            raise TimeoutError(f"rb_push timeout on {self.name!r}")
        if rc:
            raise ValueError(f"rb_push failed rc={rc}")

    def pop_into(self, out: np.ndarray, timeout_ms: int = 10000) -> None:
        out = _contiguous(out, writable=True)
        rc = self.lib.rb_pop(self.ptr, out.ctypes.data, out.nbytes, timeout_ms)
        if rc == -1:
            raise TimeoutError(f"rb_pop timeout on {self.name!r}")
        if rc:
            raise ValueError(f"rb_pop failed rc={rc}")

    def size(self) -> int:
        return int(self.lib.rb_size(self.ptr))

    def unlink(self) -> None:
        """Remove the segment's name (the owner's ring only); the mappings
        of every attached process stay valid until they detach."""
        if self._owner:
            self.lib.rb_unlink(self.name)
            self._owner = False

    def close(self) -> None:
        if self.ptr:
            self.lib.rb_detach(self.ptr)
            self.ptr = None
        self.unlink()
