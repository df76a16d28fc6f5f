"""ctypes bindings for the C++ native runtime components.

Role analog: the reference's Cython bridge (``python/ray/_raylet.pyx``) in
miniature — the native pieces are C++ (the package's own ``csrc/store.cc``
and ``csrc/pipe.cc``), and Python talks to them through a flat C API
(ctypes). The .so is built on first use with g++ into
``ray_tpu_torch/_build/``, named by a hash of the sources and flags so an
edited source rebuilds; every consumer must handle
``load_store_lib() is None`` and fall back to the pure-Python path.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "_native", "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_SOURCES = ("store.cc", "pipe.cc")
_CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_LDFLAGS = ("-lpthread", "-lrt")


def _default_so_path() -> str:
    h = hashlib.sha256(" ".join(_CXXFLAGS + _LDFLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f"librtpu_store-{h.hexdigest()[:16]}.so")


_SO_PATH = _default_so_path()


def _so_path() -> str:
    """The .so to load. ``RTPU_NATIVE_SO`` overrides the default build
    product (an instrumented build, say). Resolved once per process: the
    first load is cached in ``_lib``."""
    return os.environ.get("RTPU_NATIVE_SO") or _SO_PATH


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
#: the .so loaded but lacks the pipe-engine symbols even after a rebuild
#: attempt — a half-state the tier-1 conftest refuses to run in silently
_lib_stale = False


def _build() -> bool:
    """Compile the sources with g++ to a per-process temp file, then rename
    it into place: concurrent builds (several processes racing on first
    use) never let a reader load a half-written .so."""
    tmp = f"{_SO_PATH}.tmp{os.getpid()}"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS,
             *(os.path.join(_NATIVE_DIR, n) for n in _SOURCES),
             "-o", tmp, *_LDFLAGS],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_store_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native store library, or None."""
    global _lib, _lib_failed, _lib_stale
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            return None
        so = _so_path()
        if not os.path.exists(so):
            # never auto-build over an explicit RTPU_NATIVE_SO target —
            # a missing override is a configuration error, not a cache miss
            if so != _SO_PATH or not _build():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _lib_failed = True
            return None
        # the default build is named by its sources' hash, so only an
        # RTPU_NATIVE_SO override can lack the pipe symbols: consumers then
        # fall back per feature via hasattr, and native_status() says so
        _lib_stale = not hasattr(lib, "rtpu_pipe_new")
        lib.rtpu_store_open.restype = ctypes.c_void_p
        lib.rtpu_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_store_close.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_destroy.argtypes = [ctypes.c_char_p]
        lib.rtpu_create.restype = ctypes.c_uint64
        lib.rtpu_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64]
        lib.rtpu_seal.restype = ctypes.c_int
        lib.rtpu_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_get.restype = ctypes.c_uint64
        lib.rtpu_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.rtpu_contains.restype = ctypes.c_int
        lib.rtpu_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_release.restype = ctypes.c_int
        lib.rtpu_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_delete.restype = ctypes.c_int
        lib.rtpu_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_evict.restype = ctypes.c_uint64
        lib.rtpu_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_stats.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_uint64)] * 3
        if hasattr(lib, "rtpu_frag_stats"):  # absent in a pre-r11 .so
            lib.rtpu_frag_stats.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_uint64)] * 3
        lib.rtpu_base.restype = ctypes.c_void_p
        lib.rtpu_base.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "rtpu_pipe_new"):  # driver-engine symbols (r14)
            lib.rtpu_pipe_new.restype = ctypes.c_void_p
            lib.rtpu_pipe_new.argtypes = [ctypes.c_int, ctypes.c_uint64]
            lib.rtpu_pipe_send.restype = ctypes.c_int
            lib.rtpu_pipe_send.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p, ctypes.c_uint64]
            lib.rtpu_pipe_drain.restype = ctypes.c_int64
            lib.rtpu_pipe_drain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_uint64, ctypes.c_uint64]
            lib.rtpu_pipe_drain_pins.restype = ctypes.c_int64
            lib.rtpu_pipe_drain_pins.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_void_p,
                                                 ctypes.c_uint64]
            lib.rtpu_pipe_stats.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_uint64)]
            lib.rtpu_pipe_shutdown.argtypes = [ctypes.c_void_p]
            lib.rtpu_pipe_close.argtypes = [ctypes.c_void_p]
            lib.rtpu_copy_mt.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_uint64, ctypes.c_int]
            lib.rtpu_lz4_bound.restype = ctypes.c_uint64
            lib.rtpu_lz4_bound.argtypes = [ctypes.c_uint64]
            lib.rtpu_lz4_compress.restype = ctypes.c_int64
            lib.rtpu_lz4_compress.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64,
                                              ctypes.c_void_p,
                                              ctypes.c_uint64]
            lib.rtpu_lz4_decompress.restype = ctypes.c_int64
            lib.rtpu_lz4_decompress.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint64,
                                                ctypes.c_void_p,
                                                ctypes.c_uint64]
        _lib = lib
        return _lib


def native_status() -> dict:
    """Build/feature report for the tier-1 conftest contract: either the
    extension is fully loaded or the fallback is active — never a silent
    half-state (a .so that loads but lacks the pipe symbols after a
    rebuild attempt reports ``stale=True``)."""
    lib = load_store_lib()
    return {
        "loaded": lib is not None,
        "store": lib is not None,
        "pipe": lib is not None and hasattr(lib, "rtpu_pipe_new"),
        "lz4": lib is not None and hasattr(lib, "rtpu_lz4_compress"),
        "stale": _lib_stale,
        "so_path": _so_path(),
        "override": "RTPU_NATIVE_SO" in os.environ,
    }


def pipe_engine_available() -> bool:
    lib = load_store_lib()
    return lib is not None and hasattr(lib, "rtpu_pipe_new")


_pylib: Optional[ctypes.PyDLL] = None


def _load_pipe_pylib() -> Optional[ctypes.PyDLL]:
    """A PyDLL view of the same .so for the NON-blocking engine entry
    points (send/stats/pin-drain: mutex + memcpy + notify, microseconds).

    Calling those through the ordinary CDLL would release the GIL and
    then have to RE-ACQUIRE it on return — on a contended 2-vCPU box the
    reacquisition convoys behind whichever reader thread grabbed it,
    costing hundreds of µs per send (measured). Blocking entry points
    (drain, close) stay on the CDLL so they really do release the GIL.
    """
    global _pylib
    if _pylib is not None:
        return _pylib
    if not pipe_engine_available():
        return None
    with _lib_lock:
        if _pylib is not None:
            return _pylib
        try:
            plib = ctypes.PyDLL(_so_path())
        except OSError:
            return None
        plib.rtpu_pipe_send.restype = ctypes.c_int
        plib.rtpu_pipe_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64]
        plib.rtpu_pipe_stats.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint64)]
        plib.rtpu_pipe_drain_pins.restype = ctypes.c_int64
        plib.rtpu_pipe_drain_pins.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p,
                                              ctypes.c_uint64]
        _pylib = plib
        return _pylib


_ID_BYTES = 20  # kIdBytes in native/store.cc


def _pad_id(obj_id: bytes) -> bytes:
    """Normalize an id to exactly the native id width (the C side reads a
    fixed 20 bytes; shorter ids would make ctypes read past the buffer)."""
    return obj_id[:_ID_BYTES].ljust(_ID_BYTES, b"\x00")


class NativeArena:
    """Python handle over one native store arena."""

    def __init__(self, session: str, capacity: int = 1 << 30):
        lib = load_store_lib()
        if lib is None:
            raise RuntimeError("native store library unavailable")
        self._lib = lib
        self.name = f"/rtpu-arena-{session}".encode()
        self._store = lib.rtpu_store_open(self.name, capacity)
        if not self._store:
            raise RuntimeError("failed to open native arena")
        self._base = lib.rtpu_base(self._store)
        self._capacity = capacity
        # Monotonic populated high-water mark (arena offset): pages below
        # it have been committed by madvise or a first write, and nothing
        # ever decommits them (no MADV_REMOVE/hole-punch in the store),
        # so create() only needs to bulk-populate the part of an extent
        # above the mark. Process-local is fine — a stale-low mark only
        # costs a redundant (cheap) madvise walk.
        self._populated_end = 0
        self._libc_madvise = None
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_int]
            self._libc_madvise = libc.madvise
        except Exception:
            pass
        # Workers skip: the arena is one shared mapping, so the driver's
        # (or daemon's) prefault covers every attacher — a per-worker
        # re-walk would only burn CPU.
        if os.environ.get("RTPU_WORKER") != "1":
            self.prefault_async()

    def prefault_async(self) -> None:
        """Fault the head of the arena's pages in a background thread.

        First-touch page faults dominate cold writes (~10x slower than a
        warm memcpy: 4k faults per 16 MiB object). MADV_POPULATE_WRITE
        allocates the tmpfs pages WITHOUT modifying contents, so it is
        safe to run concurrently with allocations; kernels without it
        (<5.14) just skip (first writes stay slower).

        Bounded by RTPU_STORE_PREFAULT_BYTES (default 256 MiB; "0"
        disables, "all" populates the whole arena): each populated page
        COMMITS physical tmpfs memory, so faulting the full capacity up
        front would turn the arena's lazy allocation into an eager
        capacity-sized commit the OOM killer sees at init.
        """
        import threading

        from ray_tpu_torch import config

        setting = str(config.get("store_prefault_bytes"))
        if setting == "0":
            return
        limit = self._capacity if setting == "all" else min(
            int(setting), self._capacity)
        madvise = self._libc_madvise
        if madvise is None:
            return
        madv_populate_write = self._MADV_POPULATE_WRITE
        base = self._base

        def run():
            try:
                from ray_tpu_torch.util import metric_defs

                progress = metric_defs.get(
                    "rtpu_object_store_prefault_bytes")
            except Exception:
                progress = None
            page = 4096
            start = (base + page - 1) // page * page
            end = base + limit
            chunk = 64 << 20
            off = start
            while off < end:
                n = min(chunk, end - off)
                if madvise(ctypes.c_void_p(off),
                           ctypes.c_size_t(n),
                           madv_populate_write) != 0:
                    return  # EINVAL on old kernels: give up quietly
                off += n
                # let create() skip the already-populated head (GIL makes
                # the plain store safe; a racing lower max() only costs a
                # redundant madvise walk)
                self._populated_end = max(self._populated_end,
                                          off - base)
                if progress is not None:
                    try:
                        progress.set(off - base)
                    except Exception:
                        progress = None

        threading.Thread(target=run, daemon=True,
                         name="rtpu-arena-prefault").start()

    _MADV_POPULATE_WRITE = 23  # linux 5.14+

    def create(self, obj_id: bytes, size: int) -> Optional[memoryview]:
        off = self._lib.rtpu_create(self._store, _pad_id(obj_id), size)
        if off == 0:
            return None
        self._populate(off, size)
        buf = (ctypes.c_char * size).from_address(self._base + off)
        return memoryview(buf).cast("B")

    def _populate(self, off: int, size: int) -> None:
        """Bulk-commit the extent's unfaulted pages before the caller's
        memcpy: one MADV_POPULATE_WRITE walk instead of a first-touch
        fault every 4 KiB during the copy.

        Fresh tmpfs pages must be zero-filled either way, so this only
        shaves the trap overhead (measured 181 -> 146 ms for a cold
        256 MiB extent on this box; warm extents skip via the watermark
        and write at memcpy speed, ~45 ms). The full win comes from
        extent REUSE — once the arena has been written once, every put
        runs warm."""
        end = off + size
        if self._libc_madvise is None or end <= self._populated_end:
            return
        page = 4096
        start = max(off, self._populated_end) // page * page
        aend = (end + page - 1) // page * page
        if self._libc_madvise(ctypes.c_void_p(self._base + start),
                              ctypes.c_size_t(aend - start),
                              self._MADV_POPULATE_WRITE) != 0:
            # EINVAL = kernel lacks MADV_POPULATE_WRITE (<5.14): disable
            # for good. Transient failures (ENOMEM under pressure) must
            # NOT disable the fast path — the next extent may succeed.
            if ctypes.get_errno() == errno.EINVAL:
                self._libc_madvise = None
            return
        self._populated_end = max(self._populated_end, end)

    def seal(self, obj_id: bytes) -> None:
        self._lib.rtpu_seal(self._store, _pad_id(obj_id))

    def get(self, obj_id: bytes) -> Optional[memoryview]:
        size = ctypes.c_uint64()
        off = self._lib.rtpu_get(self._store, _pad_id(obj_id), ctypes.byref(size))
        if off == 0:
            return None
        buf = (ctypes.c_char * size.value).from_address(self._base + off)
        # Readonly: sealed objects are immutable shared memory; a writable
        # view would let `get` callers silently corrupt every other reader
        # (the mmap fallback maps PROT_READ for the same reason).
        return memoryview(buf).cast("B").toreadonly()

    def contains(self, obj_id: bytes) -> bool:
        return bool(self._lib.rtpu_contains(self._store, _pad_id(obj_id)))

    def release(self, obj_id: bytes) -> None:
        self._lib.rtpu_release(self._store, _pad_id(obj_id))

    def delete(self, obj_id: bytes) -> None:
        self._lib.rtpu_delete(self._store, _pad_id(obj_id))

    def evict(self, nbytes: int) -> int:
        return int(self._lib.rtpu_evict(self._store, nbytes))

    def stats(self) -> dict:
        cap = ctypes.c_uint64()
        used = ctypes.c_uint64()
        num = ctypes.c_uint64()
        self._lib.rtpu_stats(self._store, ctypes.byref(cap),
                             ctypes.byref(used), ctypes.byref(num))
        return {"capacity": cap.value, "used": used.value,
                "num_objects": num.value}

    def frag_stats(self) -> dict:
        """Free-list occupancy/fragmentation: block count, total free
        bytes, and the largest contiguous free block (the biggest object
        the arena still fits without eviction)."""
        if not hasattr(self._lib, "rtpu_frag_stats"):
            return {}
        blocks = ctypes.c_uint64()
        free_b = ctypes.c_uint64()
        largest = ctypes.c_uint64()
        self._lib.rtpu_frag_stats(self._store, ctypes.byref(blocks),
                                  ctypes.byref(free_b),
                                  ctypes.byref(largest))
        return {"free_blocks": blocks.value, "free_bytes": free_b.value,
                "largest_free_bytes": largest.value}

    def close(self) -> None:
        if self._store:
            self._lib.rtpu_store_close(self._store)
            self._store = None

    @staticmethod
    def destroy(session: str) -> None:
        lib = load_store_lib()
        if lib is not None:
            lib.rtpu_store_destroy(f"/rtpu-arena-{session}".encode())


# ---------------------------------------------------------------------------
# GIL-free control-pipe engine (driver side of every worker connection)
# ---------------------------------------------------------------------------

#: drain-record types (native/pipe.cc append_record)
REC_MSG = 0        # one assembled pickle message
REC_REFPINS = 1    # packed net borrow transitions (id[16] + i8)*


class NativePipe:
    """One native sender/receiver pair over an existing connection fd.

    The engine OWNS all reads and writes on the fd from construction on —
    the Python ``Connection`` object must keep the fd alive but never
    touch it again. ``send`` enqueues pre-pickled bytes for the sender
    thread (framing + coalescing + the write syscall happen with the GIL
    released); ``drain`` blocks GIL-free and returns every fully-assembled
    record the receiver queued, so one GIL acquisition services a whole
    burst of worker messages.
    """

    def __init__(self, fd: int, coalesce_us: int = 0):
        lib = load_store_lib()
        if lib is None or not hasattr(lib, "rtpu_pipe_new"):
            raise RuntimeError("native pipe engine unavailable")
        self._lib = lib
        # GIL-holding view for the non-blocking entry points (see
        # _load_pipe_pylib); falls back to the CDLL if PyDLL load failed
        self._qlib = _load_pipe_pylib() or lib
        self._p = lib.rtpu_pipe_new(fd, coalesce_us)
        if not self._p:
            raise RuntimeError("failed to start native pipe engine")
        self._buf = ctypes.create_string_buffer(1 << 20)
        # lifetime guard: close() must not free the native struct while
        # another thread is inside a C call on it. _mu is held only for
        # nanoseconds (counter bumps) — never across a blocking call.
        self._mu = threading.Lock()
        self._inflight = 0

    def _enter(self):
        with self._mu:
            if self._p is None:
                return None
            self._inflight += 1
            return self._p

    def _exit(self) -> None:
        with self._mu:
            self._inflight -= 1

    def send(self, buf) -> bool:
        """Enqueue one pre-pickled message. False when the engine closed."""
        if not isinstance(buf, bytes):
            buf = bytes(buf)  # ForkingPickler.dumps returns a memoryview
        p = self._enter()
        if p is None:
            return False
        try:
            return self._qlib.rtpu_pipe_send(p, buf, len(buf)) == 0
        finally:
            self._exit()

    def drain(self, timeout: float = 0.5):
        """Every queued record, or [] on timeout, or None on EOF.

        Records are ``(rec_type, payload)`` pairs; payloads are bytes
        copies so the reusable drain buffer can be recycled immediately.
        """
        p = self._enter()
        if p is None:
            return None
        try:
            n = self._lib.rtpu_pipe_drain(p, self._buf, len(self._buf),
                                          int(timeout * 1000))
            if n == -1:
                return None
            if n < -1:
                # first record alone exceeds the buffer: grow and retry
                self._buf = ctypes.create_string_buffer(
                    max(-n, 2 * len(self._buf)))
                n = self._lib.rtpu_pipe_drain(p, self._buf, len(self._buf),
                                              int(timeout * 1000))
                if n == -1:
                    return None
                if n < 0:
                    return []
        finally:
            self._exit()
        out = []
        # string_at copies ONLY the drained bytes (the .raw property would
        # copy the whole reusable buffer on every drain)
        raw = ctypes.string_at(self._buf, n)
        off = 0
        while off < n:
            typ = raw[off]
            ln = int.from_bytes(raw[off + 1:off + 5], "little")
            out.append((typ, raw[off + 5:off + 5 + ln]))
            off += 5 + ln
        return out

    def drain_pins(self):
        """Serialize-and-clear the native borrow table (worker death):
        list of (oid16, count)."""
        p = self._enter()
        if p is None:
            return []
        try:
            cap = 64 << 10
            while True:
                buf = ctypes.create_string_buffer(cap)
                n = self._qlib.rtpu_pipe_drain_pins(p, buf, cap)
                if n >= 0:
                    break
                cap = -n
        finally:
            self._exit()
        out = []
        raw = ctypes.string_at(buf, n)
        off = 0
        while off < n:
            oid = raw[off:off + 16]
            count = int.from_bytes(raw[off + 16:off + 24], "little",
                                   signed=True)
            out.append((oid, count))
            off += 24
        return out

    def stats(self) -> dict:
        p = self._enter()
        if p is None:
            return {}
        try:
            arr = (ctypes.c_uint64 * 8)()
            self._qlib.rtpu_pipe_stats(p, arr)
        finally:
            self._exit()
        keys = ("sent_frames", "sent_msgs", "sent_bytes", "recv_frames",
                "recv_msgs", "recv_bytes", "refpin_deltas",
                "refpin_transitions")
        return dict(zip(keys, (int(v) for v in arr)))

    def shutdown(self) -> None:
        """Stop the engine without joining its threads (safe from the
        drain thread itself); ``close`` later reclaims them."""
        p = self._enter()
        if p is None:
            return
        try:
            self._lib.rtpu_pipe_shutdown(p)
        finally:
            self._exit()

    def close(self) -> None:
        """Shutdown + join + free. Blocked calls (a drain waiting on its
        timeout) are woken by shutdown's EOF flag, then the free waits
        for the in-flight count to reach zero."""
        import time as _time

        self.shutdown()  # wakes any blocked drain (EOF) and the sender
        with self._mu:
            p, self._p = self._p, None
        if p is None:
            return
        while True:
            with self._mu:
                if self._inflight == 0:
                    break
            _time.sleep(0.005)
        self._lib.rtpu_pipe_close(p)

    def __del__(self):  # pragma: no cover - GC-order dependent
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# data-plane primitives: multi-threaded memcpy + LZ4 spill codec
# ---------------------------------------------------------------------------

def _buf_addr(obj, writable: bool):
    """(address, length, keepalive) for a bytes-like object. numpy
    preserves the source's writability, so a readonly view through a
    writable buffer still exposes its address without a copy."""
    import numpy as np

    arr = np.frombuffer(obj, dtype=np.uint8)
    if writable and not arr.flags.writeable:
        raise ValueError("destination buffer is read-only")
    return arr.ctypes.data, arr.nbytes, arr


def parallel_copy(dst, src, threads: int = 0) -> int:
    """Multi-threaded memcpy dst <- src (GIL released for the duration).
    Returns bytes copied. Raises when the engine is unavailable — callers
    gate on ``pipe_engine_available()`` or catch and fall back."""
    lib = load_store_lib()
    if lib is None or not hasattr(lib, "rtpu_copy_mt"):
        raise RuntimeError("native copy unavailable")
    daddr, dlen, dref = _buf_addr(dst, writable=True)
    saddr, slen, sref = _buf_addr(src, writable=False)
    n = min(dlen, slen)
    lib.rtpu_copy_mt(daddr, saddr, n, threads)
    del dref, sref
    return n


def lz4_compress(src) -> "Optional[bytes]":
    """LZ4-block compress; None when the native codec is unavailable or
    the output would not fit the bound (incompressible guard)."""
    lib = load_store_lib()
    if lib is None or not hasattr(lib, "rtpu_lz4_compress"):
        return None
    saddr, slen, sref = _buf_addr(src, writable=False)
    cap = int(lib.rtpu_lz4_bound(slen))
    out = ctypes.create_string_buffer(cap)
    n = lib.rtpu_lz4_compress(saddr, slen, out, cap)
    del sref
    if n < 0:
        return None
    return out.raw[:n]


def lz4_decompress(src, raw_size: int) -> bytes:
    """Inverse of lz4_compress; raises ValueError on malformed input."""
    lib = load_store_lib()
    if lib is None or not hasattr(lib, "rtpu_lz4_decompress"):
        raise RuntimeError("native lz4 unavailable")
    saddr, slen, sref = _buf_addr(src, writable=False)
    out = ctypes.create_string_buffer(raw_size if raw_size else 1)
    n = lib.rtpu_lz4_decompress(saddr, slen, out, raw_size)
    del sref
    if n != raw_size:
        raise ValueError(f"lz4 decompress produced {n}, wanted {raw_size}")
    return out.raw[:raw_size]


def lz4_decompress_into(src, dst) -> int:
    """Decompress directly into a writable buffer (arena view / mmap) —
    the restore path must not materialize a second copy in the heap."""
    lib = load_store_lib()
    if lib is None or not hasattr(lib, "rtpu_lz4_decompress"):
        raise RuntimeError("native lz4 unavailable")
    saddr, slen, sref = _buf_addr(src, writable=False)
    daddr, dlen, dref = _buf_addr(dst, writable=True)
    n = lib.rtpu_lz4_decompress(saddr, slen, daddr, dlen)
    del sref, dref
    if n < 0:
        raise ValueError("malformed lz4 block")
    return int(n)
