"""ctypes bindings for the native (C++) vector store + chunked device ingest.

The shared library is compiled from ``vstore.cpp`` on first use (g++ is part
of the toolchain; no pip packages involved) and cached next to the source.

``NativeVectorStore`` is the out-of-core ingest path: vectors live in a
memory-mapped file on the host; ``to_device`` streams them to the device in
chunks, overlapping host reads with device transfers (JAX dispatch is
async), the replacement for the reference's 100k-row chunked HDF5 feed
(Program.cs:221-260) + mmap temp store (FileRangeStore.cs).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "vstore.cpp")
_LIB = os.path.join(_HERE, "libvstore.so")
_lock = threading.Lock()
_lib = None


def _compile() -> None:
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", _LIB, _SRC,
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def load_library() -> ctypes.CDLL:
    """Compile (once) and load the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _compile()
        lib = ctypes.CDLL(_LIB)
        u64, p = ctypes.c_uint64, ctypes.c_void_p
        fp = ctypes.POINTER(ctypes.c_float)
        lib.vs_create.restype = p
        lib.vs_create.argtypes = [ctypes.c_char_p, u64, u64]
        lib.vs_open.restype = p
        lib.vs_open.argtypes = [ctypes.c_char_p]
        lib.vs_error.restype = ctypes.c_char_p
        lib.vs_error.argtypes = [p]
        for name in ("vs_count", "vs_dims", "vs_capacity"):
            getattr(lib, name).restype = u64
            getattr(lib, name).argtypes = [p]
        lib.vs_append.restype = ctypes.c_int
        lib.vs_append.argtypes = [p, fp, u64]
        lib.vs_rows.restype = fp
        lib.vs_rows.argtypes = [p, u64]
        lib.vs_read.restype = ctypes.c_int
        lib.vs_read.argtypes = [p, u64, u64, fp]
        lib.vs_flush.restype = ctypes.c_int
        lib.vs_flush.argtypes = [p]
        lib.vs_close.restype = None
        lib.vs_close.argtypes = [p]
        lib.vs_import_fvecs.restype = ctypes.c_int64
        lib.vs_import_fvecs.argtypes = [p, ctypes.c_char_p]
        _lib = lib
        return lib


class NativeVectorStore:
    """Memory-mapped float32 row store backed by the C++ runtime."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        err = lib.vs_error(handle)
        if err:
            msg = err.decode()
            self._h = None
            lib.vs_close(handle)  # free the Store struct + any open fd
            raise OSError(msg)

    # --- constructors ------------------------------------------------------
    @classmethod
    def create(cls, path: str, dims: int, capacity_rows: int = 1024):
        lib = load_library()
        return cls(lib.vs_create(path.encode(), dims, capacity_rows), lib)

    @classmethod
    def open(cls, path: str):
        lib = load_library()
        return cls(lib.vs_open(path.encode()), lib)

    def _handle(self):
        """Live native handle, or a Python exception — every C entry
        point dereferences the struct pointer, so a closed/failed store
        must never reach the FFI (it would SIGSEGV the process)."""
        if self._h is None:
            raise ValueError("store is closed")
        return self._h

    # --- core API ----------------------------------------------------------
    def __len__(self) -> int:
        return int(self._lib.vs_count(self._handle()))

    @property
    def dims(self) -> int:
        return int(self._lib.vs_dims(self._handle()))

    def append(self, rows) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.shape[1] != self.dims:
            raise ValueError("invalid vector size")
        ptr = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.vs_append(self._handle(), ptr, rows.shape[0]) != 0:
            raise OSError(self._lib.vs_error(self._h).decode())

    def rows(self, start: int, nrows: int) -> np.ndarray:
        """Zero-copy view of stored rows (valid until the next append)."""
        if start < 0 or start + nrows > len(self):
            raise IndexError("row range out of bounds")
        ptr = self._lib.vs_rows(self._handle(), start)
        arr = np.ctypeslib.as_array(ptr, shape=(nrows, self.dims))
        return arr

    def read(self, start: int, nrows: int) -> np.ndarray:
        """Copying read."""
        out = np.empty((nrows, self.dims), dtype=np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self._lib.vs_read(self._handle(), start, nrows, ptr) != 0:
            raise IndexError("row range out of bounds")
        return out

    def flush(self) -> None:
        self._lib.vs_flush(self._handle())

    def close(self) -> None:
        if self._h:
            self._lib.vs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- ingest ------------------------------------------------------------
    def import_fvecs(self, path: str) -> int:
        """Bulk-import an fvecs file (SIFT / ann-benchmarks format)."""
        n = self._lib.vs_import_fvecs(self._handle(), path.encode())
        if n < 0:
            raise OSError(self._lib.vs_error(self._h).decode())
        return int(n)

    def chunks(self, chunk_rows: int = 100_000) -> Iterator[np.ndarray]:
        """Zero-copy chunk iterator (the reference's 100k-row feed)."""
        n = len(self)
        for start in range(0, n, chunk_rows):
            yield self.rows(start, min(chunk_rows, n - start))

    def to_device(self, chunk_rows: int = 500_000, sharding=None):
        """Stream the whole store to device memory as one [N, D] array
        (double-buffered; see :func:`stream_rows_to_device`)."""
        return stream_rows_to_device(
            self.rows, len(self), self.dims,
            chunk_rows=chunk_rows, sharding=sharding,
        )


def stream_rows_to_device(row_source, n, d, *, chunk_rows: int = 500_000,
                          sharding=None):
    """Double-buffered host->HBM assembly of an ``[n, d]`` f32 device array.

    ``row_source(start, rows)`` returns that host slice (a store's
    ``rows`` method, a numpy array's slicer, ...). The host->HBM
    ``device_put`` of chunk ``i+1`` is issued (async) before chunk ``i``
    is copied into its slice of the preallocated result (a donated
    ``dynamic_update_slice``, so XLA updates in place) — host
    page-in/transfer of the next chunk overlaps the device-side copy of
    the current one, peak HBM is ``n + chunk`` instead of the ``2n`` a
    concatenate would hold, and nothing waits for the full set of chunks
    before assembly starts. Optional ``sharding`` places the result
    across a mesh.
    """
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0,))
    def write(out, chunk, start):
        return jax.lax.dynamic_update_slice(
            out, chunk, (start, jnp.int32(0))
        )

    out = jnp.zeros((n, d), jnp.float32)
    if sharding is not None:
        out = jax.device_put(out, sharding)
    spans = [
        (s, min(chunk_rows, n - s)) for s in range(0, n, chunk_rows)
    ]
    dev = jax.device_put(row_source(*spans[0])) if spans else None
    for i, (start, rows) in enumerate(spans):
        nxt = (
            jax.device_put(row_source(*spans[i + 1]))
            if i + 1 < len(spans) else None
        )  # async H2D for the next chunk, in flight during the write
        out = write(out, dev, jnp.int32(start))
        dev = nxt
    return out
