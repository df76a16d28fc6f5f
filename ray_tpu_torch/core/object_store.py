"""Shared-memory object store.

Role analog: reference plasma (``src/ray/object_manager/plasma/store.h``) +
``CoreWorkerPlasmaStoreProvider``. Implementation differs deliberately:
instead of a store daemon owning one big dlmalloc arena and serving a
unix-socket protocol, each object is one file in ``/dev/shm`` mmap'd by
writer and readers. Readiness ("sealing") is coordinated by the object
directory in the control plane, so readers never attach before the writer
finished. A C++ arena-backed store can be slotted under the same client API
later (``ray_tpu_torch/_native``).

Small objects (< INLINE_THRESHOLD) never touch the store: they live inline
in the object directory (the reference's in-process memory store analog).
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch import config
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID

INLINE_THRESHOLD = 8192

_SHM_DIR = "/dev/shm"

#: process-local store instrumentation, defined centrally in
#: ``util/metric_defs.py`` (reference ``src/ray/stats/metric_defs.cc``
#: role). Fetched lazily so importing the store never drags the metrics
#: registry into processes that don't serve /metrics; the first
#: StoreClient touches it so a scrape shows the series (at 0) before the
#: first use. metric_defs.get caches + survives clear_registry, so the
#: accessor just rebuilds the dict.

#: pre-sorted tag keys for the hot put path (merging/sorting a one-tag
#: dict per put is pure overhead there)
_PATH_KEYS = {p: (("path", p),) for p in ("inline", "arena", "file",
                                          "spill")}
_NO_TAGS = ()


def _store_metrics():
    from ray_tpu_torch.util import metric_defs as md

    return {
        "put_seconds": md.get("rtpu_object_store_put_seconds"),
        "get_seconds": md.get("rtpu_object_store_get_seconds"),
        "puts": md.get("rtpu_object_store_puts_total"),
        "put_bytes": md.get("rtpu_object_store_put_bytes_total"),
        "spilled_bytes": md.get("rtpu_object_store_spilled_bytes_total"),
        "spilled_objects": md.get(
            "rtpu_object_store_spilled_objects_total"),
        "restored_bytes": md.get(
            "rtpu_object_store_restored_bytes_total"),
        "restored_objects": md.get(
            "rtpu_object_store_restored_objects_total"),
        "spill_read_bytes": md.get(
            "rtpu_object_store_spill_read_bytes_total"),
    }


def _seg_path(session: str, obj_id: ObjectID) -> str:
    return os.path.join(_SHM_DIR, f"rtpu-{session}-{obj_id.hex()}")


def _spill_dir(session: str) -> str:
    return os.path.join("/tmp", f"rtpu-spill-{session}")


def _spill_path(session: str, obj_id: ObjectID) -> str:
    return os.path.join(_spill_dir(session), obj_id.hex())


class _Pinned:
    """A mapped segment kept alive while any deserialized view exists.

    ``fd == -2`` marks a native-arena pin; ``baseline`` is the refcount of
    the view's base exporter right after pinning — a later refcount above
    it means deserialized zero-copy views are still alive.
    """

    __slots__ = ("mm", "fd", "size", "baseline")

    def __init__(self, mm, fd: int, size: int, baseline: int = 0):
        self.mm = mm
        self.fd = fd
        self.size = size
        self.baseline = baseline


class StoreClient:
    """Per-process object-store client.

    Backend selection: the C++ arena store (``native/store.cc`` via
    ``ray_tpu_torch._native``) when the library builds/loads — one shm arena per
    session with a free-list allocator, refcounts, and LRU eviction (the
    plasma-role design) — else the file-per-object fallback above. Both
    share this client API; ``RTPU_NATIVE_STORE=0`` forces the fallback.
    """

    def __init__(self, session: str):
        self.session = session
        self._pins: Dict[ObjectID, _Pinned] = {}
        self._lock = threading.Lock()
        self._arena = None
        if config.get("native_store"):
            try:
                from ray_tpu_torch._native import NativeArena

                capacity = int(config.get("store_capacity"))
                self._arena = NativeArena(session, capacity)
            except Exception as e:
                # Loud fallback: a process silently diverging to the file
                # backend while peers use the arena cannot read their
                # arena-stored objects.
                import logging

                logging.getLogger(__name__).warning(
                    "native object store unavailable (%s); "
                    "falling back to file-per-object segments", e)
                self._arena = None
        self._spill_threshold = int(config.get("spill_threshold"))
        # Running total of THIS client's file-segment bytes: the spill
        # check must be O(1), not a /dev/shm scan per put (store_bytes()
        # stays the accurate cross-process accounting API).
        self._file_bytes = 0
        _store_metrics()  # register the series for /metrics scrapes
        self._register_gauges()

    def _register_gauges(self) -> None:
        """Sampled store gauges, refreshed by the metrics collector hook
        at every exposition/federation snapshot. Weakly bound: a client
        dropped by shutdown unregisters itself on the next run, so
        repeated init/shutdown cycles don't accumulate hooks."""
        import weakref

        from ray_tpu_torch.util import metric_defs, metrics

        used = metric_defs.get("rtpu_object_store_bytes_used")
        cap = metric_defs.get("rtpu_object_store_capacity_bytes")
        pins = metric_defs.get("rtpu_object_store_pins")
        spill_dir = metric_defs.get("rtpu_object_store_spill_dir_bytes")
        capacity = int(config.get("store_capacity"))
        wr = weakref.ref(self)
        # spill_dir_bytes is a directory scan (one stat per spilled
        # object) over a SHARED per-node dir; collectors fire on every
        # snapshot (worker delta push ~2s, heartbeat ~2s, scrapes), so
        # rate-limit the scan AND sample it only outside workers — N
        # workers rescanning the same dir would multiply identical
        # node-wide sweeps (the driver/daemon series carries the value)
        import os as _os

        sample_spill = _os.environ.get("RTPU_WORKER") != "1"
        spill_cache = [0.0, 0.0]  # [last_scan_monotonic, last_value]

        def collect():
            import time as _time

            c = wr()
            if c is None:
                metrics.unregister_collector(collect)
                return
            total = c._file_bytes
            if c._arena is not None:
                try:
                    total += c._arena.stats()["used"]
                except Exception:
                    pass
            used.set(total)
            cap.set(capacity)
            pins.set(len(c._pins))
            if sample_spill:
                now = _time.monotonic()
                if now - spill_cache[0] >= 5.0:
                    spill_cache[0] = now
                    spill_cache[1] = c.spill_dir_bytes()
                spill_dir.set(spill_cache[1])

        self._collector = collect
        metrics.register_collector(collect)

    # -- write path -------------------------------------------------------

    def put(self, obj_id: ObjectID, value: Any):
        """Serialize ``value``; returns ``(inline, size)``.

        ``inline`` is the serialized blob when small enough to live in the
        directory (caller ships it over the control channel), else None
        with the bytes written to a shm segment. ``size`` is the
        serialized size either way — callers report it to the directory so
        peers can plan chunked pulls without re-statting the segment.
        """
        data, buffers = serialization.serialize(value)
        return self.put_parts(obj_id, data, buffers)

    def put_parts(self, obj_id: ObjectID, data: bytes, buffers):
        """Like ``put`` but takes an already-serialized (data, buffers) pair
        so callers that must size-check first don't serialize twice.

        Idempotent on duplicate ids: a lineage re-execution re-writes every
        return of the producing task, and siblings that survived the loss
        keep their existing segment (deterministic tasks produce the same
        bytes)."""
        import time as _time

        from ray_tpu_torch.util import failpoints

        # chaos site: a raised seal failure surfaces as a store write
        # error (the producing task errors; retry_exceptions re-runs it)
        failpoints.hit("store.seal")
        m = _store_metrics()
        size = serialization.serialized_size(data, buffers)
        t0 = _time.perf_counter()
        if size < INLINE_THRESHOLD:
            out = bytearray(size)
            serialization.write_into(memoryview(out), data, buffers)
            self._note_put(m, "inline", size, t0)
            return bytes(out), size
        if self.contains(obj_id):
            return None, size  # already present (lineage re-run survivor)
        if self._arena is not None:
            view = self._arena.create(obj_id.binary(), size)
            if view is not None:
                serialization.write_into(view, data, buffers)
                del view
                self._arena.seal(obj_id.binary())
                # The create-ref is NOT released: it is the object
                # directory's reference, dropped only by delete(). Sealed
                # objects with it held are never evicted, so live
                # ObjectRefs can't lose data to allocation pressure.
                self._note_put(m, "arena", size, t0)
                return None, size
            # arena full: fall through to a file segment (never evict
            # referenced objects to make room)
        # Spilling (reference raylet LocalObjectManager::SpillObjects):
        # once shm usage crosses the threshold, new large objects go to
        # disk instead of RAM-backed /dev/shm; reads are transparent.
        arena_used = self._arena.stats()["used"] if self._arena else 0
        spill = (arena_used + self._file_bytes + size
                 > self._spill_threshold)
        if spill:
            # spill path: STREAM the serialized layout through the codec
            # (native lz4 / zlib) block by block — disk bandwidth is the
            # spill ceiling, so bytes saved are wall time saved on BOTH
            # the spill and the later restore, and peak extra heap stays
            # one block (spills fire exactly when memory is tight)
            from ray_tpu_torch.core import spill_codec

            os.makedirs(_spill_dir(self.session), exist_ok=True)
            path = _spill_path(self.session, obj_id)
            spill_codec.write_spill_stream(
                path, size,
                serialization.iter_serialized_blocks(
                    data, buffers, spill_codec.BLOCK_RAW))
            m["spilled_bytes"].inc(size)  # logical, as always
            m["spilled_objects"].inc()
            self._note_spill_event(obj_id, size, "put")
            self._note_put(m, "spill", size, t0)
            return None, size
        path = _seg_path(self.session, obj_id)
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
            serialization.write_into(memoryview(mm), data, buffers)
        finally:
            os.close(fd)
        mm.close()
        self._file_bytes += size
        self._note_put(m, "file", size, t0)
        return None, size

    @staticmethod
    def _note_spill_event(obj_id: ObjectID, size: int, how: str) -> None:
        """THE object_spill emit site (one call site for the event-name
        catalog): both the put-path overflow spill and the chunked-pull
        writer's spill report through here."""
        try:
            from ray_tpu_torch.util import events

            events.emit("object_spill", object_id=obj_id.hex()[:16],
                        size=size, how=how)
        except Exception:
            pass

    @staticmethod
    def _note_put(m, path: str, size: int, t0: float) -> None:
        import time as _time

        try:
            m["puts"]._inc_key(_PATH_KEYS[path])
            m["put_bytes"]._inc_key(_NO_TAGS, size)
            m["put_seconds"]._observe_key(
                _NO_TAGS, _time.perf_counter() - t0)
        except Exception:
            pass

    def put_serialized(self, obj_id: ObjectID, blob: bytes) -> None:
        """Write an already-serialized blob into a segment (spill-in path)."""
        path = _seg_path(self.session, obj_id)
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, len(blob))
            mm = mmap.mmap(fd, len(blob))
            mm[:] = blob
            mm.close()
        finally:
            os.close(fd)

    # -- read path --------------------------------------------------------

    def get(self, obj_id: ObjectID) -> Any:
        """Deserialize from shm; zero-copy views pin the mapping."""
        import time as _time

        t0 = _time.perf_counter()
        with self._lock:
            pinned = self._pins.get(obj_id)
        if pinned is None and self._arena is not None:
            view = self._arena.get(obj_id.binary())
            if view is not None:
                import numpy as _np

                # Root all exports at a numpy base array: every consumer
                # view chain holds one ref on it, so liveness is
                # observable via getrefcount (the ctypes view itself
                # doesn't expose its export count).
                base = _np.frombuffer(view, dtype=_np.uint8)
                took_pin = False
                with self._lock:
                    existing = self._pins.get(obj_id)
                    if existing is not None:
                        pinned = existing  # lost a pin race
                    else:
                        # Idle refcount as seen from release(): the pin's
                        # ref + getrefcount's argument temp. Anything above
                        # means a consumer export chain is alive.
                        pinned = _Pinned(base, -2, len(view), baseline=2)
                        self._pins[obj_id] = pinned
                        took_pin = True
                if not took_pin:
                    # drop the extra native ref our losing get() took
                    del base, view
                    self._arena.release(obj_id.binary())
        if pinned is None:
            seg = _seg_path(self.session, obj_id)
            spilled = _spill_path(self.session, obj_id)
            if not os.path.exists(seg) and os.path.exists(spilled):
                if self.restore_spilled(obj_id):
                    # restored into the arena or a fresh segment; re-enter
                    # (the spill file is gone, so this recurses only once)
                    return self.get(obj_id)
            # seg -> spill -> seg: a concurrent restorer can unlink the
            # spill file between the exists check and the open, in which
            # case the segment path exists again
            mm = None
            fd_kind = -1
            for path in (seg, spilled, seg):
                if path == spilled:
                    from ray_tpu_torch.core import spill_codec

                    if spill_codec.is_compressed(path):
                        # restore was refused (no shm headroom): inflate
                        # to a HEAP buffer and serve zero-copy views off
                        # it (fd == -3 pin; liveness via the numpy-base
                        # refcount, exactly like the arena pin)
                        blob = spill_codec.read_bytes(path)
                        if blob is None:
                            continue
                        import numpy as _np

                        mm = _np.frombuffer(blob, dtype=_np.uint8)
                        size = len(blob)
                        fd_kind = -3
                        _store_metrics()["spill_read_bytes"].inc(size)
                        break
                try:
                    fd = os.open(path, os.O_RDONLY)
                except FileNotFoundError:
                    continue
                try:
                    size = os.fstat(fd).st_size
                    mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
                finally:
                    os.close(fd)
                if path == spilled:
                    _store_metrics()["spill_read_bytes"].inc(size)
                break
            if mm is None:
                raise FileNotFoundError(seg)
            with self._lock:
                existing = self._pins.get(obj_id)
                if existing is not None:
                    pinned = existing
                    if fd_kind == -1:
                        mm.close()
                else:
                    pinned = _Pinned(mm, fd_kind, size,
                                     baseline=2 if fd_kind == -3 else 0)
                    self._pins[obj_id] = pinned
        value = serialization.read_from(memoryview(pinned.mm))
        try:
            _store_metrics()["get_seconds"]._observe_key(
                _NO_TAGS, _time.perf_counter() - t0)
        except Exception:
            pass
        return value

    def get_raw(self, obj_id: ObjectID) -> Optional[bytes]:
        """The serialized segment bytes (node-to-node transfer source).

        A copy, not a view: the bytes are shipped over a socket, so pinning
        the mapping would only delay eviction for no benefit.
        """
        if self._arena is not None:
            view = self._arena.get(obj_id.binary())
            if view is not None:
                try:
                    return bytes(view)
                finally:
                    del view
                    self._arena.release(obj_id.binary())
        seg = _seg_path(self.session, obj_id)
        spilled = _spill_path(self.session, obj_id)
        # seg -> spill -> seg: tolerate a concurrent restore unlinking the
        # spill file between candidates
        for path in (seg, spilled, seg):
            if path == spilled:
                from ray_tpu_torch.core import spill_codec

                data = spill_codec.read_bytes(path)  # codec-aware
                if data is None:
                    continue
            else:
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except FileNotFoundError:
                    continue
            if path == spilled:
                _store_metrics()["spill_read_bytes"].inc(len(data))
            return data
        return None

    def get_raw_chunk(self, obj_id: ObjectID, offset: int,
                      length: int) -> Optional[bytes]:
        """A slice of the serialized segment (chunked node-to-node pull,
        reference ObjectBufferPool chunk-read role): only ``length`` bytes
        are copied, so serving a multi-GB object never materializes it."""
        if self._arena is not None:
            view = self._arena.get(obj_id.binary())
            if view is not None:
                try:
                    return bytes(view[offset:offset + length])
                finally:
                    del view
                    self._arena.release(obj_id.binary())
        seg = _seg_path(self.session, obj_id)
        spilled = _spill_path(self.session, obj_id)
        for path in (seg, spilled, seg):
            if path == spilled:
                from ray_tpu_torch.core import spill_codec

                data = spill_codec.read_range(path, offset, length)
                if data is None:
                    continue
            else:
                try:
                    with open(path, "rb") as f:
                        f.seek(offset)
                        data = f.read(length)
                except FileNotFoundError:
                    continue
            if path == spilled:
                _store_metrics()["spill_read_bytes"].inc(len(data))
            return data
        return None

    def begin_receive(self, obj_id: ObjectID,
                      size: int) -> Optional["IncomingObject"]:
        """Allocate the full segment for an incremental cross-node receive;
        chunks are written at offsets, then sealed. Returns None when the
        object is already present."""
        if self.contains(obj_id):
            return None
        return IncomingObject(self, obj_id, size)

    def contains(self, obj_id: ObjectID) -> bool:
        if obj_id in self._pins:
            return True
        if self._arena is not None and self._arena.contains(obj_id.binary()):
            return True
        return os.path.exists(_seg_path(self.session, obj_id)) or \
            os.path.exists(_spill_path(self.session, obj_id))

    def release(self, obj_id: ObjectID) -> None:
        """Drop this process's pin (views must no longer be used).

        Runs fully under the client lock (pop + liveness check + unpin are
        one critical section): a pop-then-reinsert window would let a
        concurrent ``get`` insert a fresh pin that the reinsert clobbers,
        leaking its native ref.
        """
        import sys

        with self._lock:
            pinned = self._pins.get(obj_id)
            if pinned is None:
                return
            if pinned.fd == -2:
                # Native-pin twin of the mmap path's BufferError guard: if
                # deserialized zero-copy views still reference the arena
                # region (exporter refcount above the pin-time baseline),
                # keep the pin so the bytes can't be freed/reused under
                # them.
                if sys.getrefcount(pinned.mm) > pinned.baseline:
                    return
                del self._pins[obj_id]
                self._arena.release(obj_id.binary())
                return
            if pinned.fd == -3:
                # heap pin (decompressed spill served without restore):
                # same refcount liveness guard; nothing to unmap — the
                # buffer dies with the pin
                if sys.getrefcount(pinned.mm) > pinned.baseline:
                    return
                del self._pins[obj_id]
                return
            try:
                pinned.mm.close()
                del self._pins[obj_id]
            except BufferError:
                # Live views still reference the mapping; keep the pin.
                pass

    def delete(self, obj_id: ObjectID) -> None:
        """Remove the object (owner/driver only)."""
        self.release(obj_id)
        if self._arena is not None:
            self._arena.delete(obj_id.binary())
        seg = _seg_path(self.session, obj_id)
        try:
            self._file_bytes = max(
                0, self._file_bytes - os.stat(seg).st_size)
            os.unlink(seg)
        except FileNotFoundError:
            pass
        try:
            os.unlink(_spill_path(self.session, obj_id))
        except FileNotFoundError:
            pass

    def store_bytes(self) -> int:
        """Total bytes of this session's segments currently in shm."""
        total = 0
        if self._arena is not None:
            total += self._arena.stats()["used"]
        prefix = f"rtpu-{self.session}-"
        try:
            for name in os.listdir(_SHM_DIR):
                if name.startswith(prefix):
                    try:
                        total += os.stat(os.path.join(_SHM_DIR, name)).st_size
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    def report(self) -> dict:
        """Arena occupancy/fragmentation report for `ray_tpu_torch memory` /
        ``state.store_report()``: backend, capacity/used/object counts,
        free-list fragmentation (native arena), file-segment bytes, live
        view pins, and spill-directory bytes."""
        out: dict = {
            "backend": "arena" if self._arena is not None else "file",
            "capacity_bytes": int(config.get("store_capacity")),
            "file_segment_bytes": self._file_bytes,
            "view_pins": len(self._pins),
            "spill_dir_bytes": self.spill_dir_bytes(),
        }
        if self._arena is not None:
            try:
                st = self._arena.stats()
                out["arena_used_bytes"] = st["used"]
                out["arena_objects"] = st["num_objects"]
                frag = self._arena.frag_stats()
                if frag:
                    out.update(frag)
                    cap = st["used"] + frag["free_bytes"]
                    # fragmentation = how much of the free space is NOT
                    # reachable by the single largest allocation
                    out["fragmentation_pct"] = round(
                        100.0 * (1.0 - frag["largest_free_bytes"]
                                 / max(1, frag["free_bytes"])), 1)
                    out["occupancy_pct"] = round(
                        100.0 * st["used"] / max(1, cap), 1)
            except Exception:
                pass
        return out

    def contains_spilled(self, obj_id: ObjectID) -> bool:
        return os.path.exists(_spill_path(self.session, obj_id))

    def spill_dir_bytes(self) -> int:
        """Total bytes currently spilled to disk for this session (node-
        wide: every process of the session writes the same directory)."""
        total = 0
        try:
            with os.scandir(_spill_dir(self.session)) as it:
                for e in it:
                    try:
                        total += e.stat().st_size
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    def restore_spilled(self, obj_id: ObjectID) -> bool:
        """Promote a spilled object back into shared memory (reference
        ``LocalObjectManager`` restore, ``local_object_manager.h:110``):
        later local reads and chunked peer pulls hit shm instead of disk.
        Skipped when restoring would push shm usage back over the spill
        threshold — that pressure is why the object spilled. Concurrency-
        safe across processes: the shm copy lands under arena create/seal
        or an O_EXCL temp file renamed into place, and the spill file is
        unlinked only after the copy is readable."""
        if not config.get("spill_restore"):
            return False
        if self._arena is not None and self._arena.contains(obj_id.binary()):
            return True  # a peer already restored it
        seg = _seg_path(self.session, obj_id)
        if os.path.exists(seg):
            return True
        from ray_tpu_torch.core import spill_codec

        path = _spill_path(self.session, obj_id)
        size = spill_codec.raw_size(path)  # LOGICAL size (codec-aware)
        if size is None:
            return False  # not spilled here
        # headroom gate on the ACCURATE cross-process accounting, not this
        # client's O(1) running total: the process serving a peer pull has
        # written nothing itself, and restoring into a /dev/shm already
        # full of other processes' segments would re-create the very
        # pressure that caused the spill. Restore is rare, so the scan is
        # affordable here (unlike the per-put spill check).
        if self.store_bytes() + size > self._spill_threshold:
            return False  # no shm headroom; serve reads from disk
        restored = False
        if self._arena is not None:
            view = self._arena.create(obj_id.binary(), size)
            if view is not None:
                ok = self._copy_file_into(path, view, size)
                del view
                if not ok:
                    self._arena.delete(obj_id.binary())
                    return False
                self._arena.seal(obj_id.binary())
                # like put_parts: the create-ref IS the directory's
                # reference, dropped only by delete()
                restored = True
        if not restored:
            # arena create returning None can mean FULL or a LOST RACE to
            # a concurrent restorer (duplicate id): re-check before paying
            # for a duplicate file-segment copy of the whole object
            if self._arena is not None and \
                    self._arena.contains(obj_id.binary()):
                return True
            if os.path.exists(seg):
                return True
            part = seg + f".restore-{os.getpid()}"
            try:
                fd = os.open(part, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            except OSError:
                return False
            try:
                os.ftruncate(fd, size)
                if size:
                    mm = mmap.mmap(fd, size)
                    ok = self._copy_file_into(path, mm, size)
                    mm.close()
                    if not ok:
                        os.unlink(part)
                        return False
            finally:
                os.close(fd)
            os.rename(part, seg)
            self._file_bytes += size
        try:
            os.unlink(path)
        except OSError:
            pass
        m = _store_metrics()
        m["restored_bytes"].inc(size)
        m["restored_objects"].inc()
        try:
            from ray_tpu_torch.util import events

            events.emit("object_restore", object_id=obj_id.hex()[:16],
                        size=size, into="arena" if restored else "file")
        except Exception:
            pass
        return True

    @staticmethod
    def _copy_file_into(path: str, buf, size: int,
                        chunk: int = 8 << 20) -> bool:
        """Decompress/copy a spill file into a writable buffer in bounded
        chunks — restoring a multi-GB object (the serve path runs this
        inside a chunked peer pull) must never materialize it in this
        heap. ``size`` is the LOGICAL object size (spill_codec.raw_size)."""
        from ray_tpu_torch.core import spill_codec

        return spill_codec.read_into(path, buf, size, chunk=chunk)

    @staticmethod
    def cleanup_session(session: str) -> None:
        """Remove every shared-memory name of ``session``: its objects
        (``rtpu-<session>-*``), its arena (``rtpu-arena-<session>``) and
        its compiled-DAG channels (``rtpu-chan-<session>-*``), and its
        spill directory. The arena is unlinked by name here as well, so
        a native library that failed to load cannot leave it behind."""
        import shutil

        shutil.rmtree(_spill_dir(session), ignore_errors=True)
        try:
            names = os.listdir(_SHM_DIR)
        except OSError:
            return
        for name in names:
            if (name.startswith(f"rtpu-{session}-")
                    or name == f"rtpu-arena-{session}"
                    or name.startswith(f"rtpu-chan-{session}-")):
                try:
                    os.unlink(os.path.join(_SHM_DIR, name))
                except OSError:
                    pass


class IncomingObject:
    """Incremental cross-node receive: allocate the full segment up front,
    write chunks at offsets, then seal. Arena-backed when possible
    (create -> seal, so readers never attach early); else a ``.part`` file
    renamed into place on seal — ``contains()`` checks the final path, so a
    partial segment is never visible. Role analog: the reference
    ObjectBufferPool create-and-fill (``object_manager/object_buffer_pool.h``).
    """

    def __init__(self, store: StoreClient, obj_id: ObjectID, size: int):
        self._store = store
        self._oid = obj_id
        self._size = size
        self._view = None
        self._mm = None
        self._path = None
        self._spilled = False
        self._done = False
        if store._arena is not None:
            self._view = store._arena.create(obj_id.binary(), size)
        if self._view is None:
            # same spill decision as put_parts: past the shm threshold,
            # large incoming objects land on disk
            arena_used = (store._arena.stats()["used"]
                          if store._arena else 0)
            self._spilled = (arena_used + store._file_bytes + size
                             > store._spill_threshold)
            if self._spilled:
                os.makedirs(_spill_dir(store.session), exist_ok=True)
                self._path = _spill_path(store.session, obj_id)
            else:
                self._path = _seg_path(store.session, obj_id)
            part = self._path + ".part"
            try:
                fd = os.open(part, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            except FileExistsError:
                os.unlink(part)  # stale leftover from an aborted fetch
                fd = os.open(part, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size) if size else None
            finally:
                os.close(fd)

    def write(self, offset: int, data: bytes) -> None:
        if self._view is not None:
            self._view[offset:offset + len(data)] = data
        elif self._mm is not None:
            self._mm[offset:offset + len(data)] = data

    def seal(self) -> None:
        self._done = True
        if self._view is not None:
            self._view = None  # release the export before sealing
            self._store._arena.seal(self._oid.binary())
        else:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            os.rename(self._path + ".part", self._path)
            if self._spilled:
                m = _store_metrics()
                m["spilled_bytes"].inc(self._size)
                m["spilled_objects"].inc()
                ObjectStore._note_spill_event(self._oid, self._size,
                                              "chunked_pull")
            else:
                self._store._file_bytes += self._size

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        if self._view is not None:
            self._view = None
            self._store._arena.delete(self._oid.binary())
        else:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            try:
                os.unlink(self._path + ".part")
            except OSError:
                pass
