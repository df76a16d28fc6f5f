"""KV-block shipping between prefill and decode pools (twin of
``ray_tpu/serve/kv_transfer.py``).

The data plane of disaggregated serving: a prefill replica finishes a
prompt, gathers its KV blocks off the paged pool (:class:`~ray_tpu_torch.
serve.llm.KVExport`: host torch tensors) and ships them to the decode
replica that will own the stream. Two paths, picked per transfer by node
identity:

- **channel** (both replicas on one node): the payload rides one slot of a
  multi-slot seq-numbered :class:`~ray_tpu_torch.experimental.
  device_channel.DeviceChannel` ring as a :class:`~ray_tpu_torch.
  experimental.device_channel.TensorWithMeta` — raw tensor bytes, 64B
  aligned, no pickling; one copy into shm on the prefill side, one out on
  the decode side. One ring per (prefill replica, decode replica) pair,
  created lazily by the sender and demuxed by request id on the receiver
  (ring order is write order, not completion order). A full ring (decode
  replica wedged or dead) fails over to the store path instead of
  blocking prefill.
- **store** (another node, or no room on the ring): the payload is
  ``ray_tpu_torch.put`` as ONE block-major tensor, whose bytes the store
  carries out of band, and the decode replica reads it back from there.

The payload is **block-major** ``[n_blocks, 2, L, bs, kvh, hd]`` (k / v
stacked per block), so one block is one contiguous record, and a torn
transfer cannot be adopted: the decode engine scatters only a complete
batch delivered with a complete descriptor. The store path's chunked
cross-node pull, which the reference aligns to these records, waits for
``cluster/`` (ROADMAP.md queue 1 item 4); the descriptor carries the
stride all the same.

Failure seam: ``failpoints.hit("serve.kv_transfer", <req_id>)`` fires
before anything is shipped.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Tuple

import torch

from ray_tpu_torch.serve.llm import KVExport


class KVTransferError(RuntimeError):
    """A KV-block transfer could not be completed (payload never
    arrived, geometry mismatch, or the channel / store path failed)."""

    error_type = "kv_transfer"


_METRICS: Any = 0  # unresolved sentinel (None = resolved-unavailable)


def _metrics():
    global _METRICS
    if _METRICS == 0:  # resolve once, not per transfer (hot path)
        try:
            from ray_tpu_torch.util import metric_defs as md

            _METRICS = {
                "bytes": md.get("rtpu_serve_kv_transfer_bytes_total"),
                "transfers": md.get("rtpu_serve_kv_transfers_total"),
                "seconds": md.get("rtpu_serve_kv_transfer_seconds"),
            }
        except Exception:  # metrics plane unavailable (bare unit tests)
            _METRICS = None
    return _METRICS


def _observe(path: str, nbytes: int, seconds: float) -> None:
    m = _metrics()
    if m:
        tags = {"path": path}
        m["bytes"].inc(nbytes, tags=tags)
        m["transfers"].inc(tags=tags)
        m["seconds"].observe(seconds, tags=tags)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def channel_name(src_id: str, dst_id: str) -> str:
    """Ring name for one (prefill, decode) pair. Prefixed with the creating
    runtime's session id so that runtime's shutdown sweep
    (``rtpu-chan-<session>-*``) reclaims the shm segment even when the
    replica dies without a graceful close — replicas are killed, never
    asked to clean up."""
    try:
        from ray_tpu_torch.core.runtime_context import get_runtime_context

        session = get_runtime_context().get_session_id()
    except Exception:
        session = "nosess"
    return f"{session}-kvx-{src_id}-{dst_id}"


def pack_export(export: KVExport) -> Tuple[Dict[str, Any], torch.Tensor]:
    """(meta, block-major tensor) for one export. The tensor is
    ``[n_blocks, 2, L, bs, kvh, hd]``, contiguous per block."""
    k, v = (torch.as_tensor(export.kv[name]) for name in ("k", "v"))
    arr = torch.stack([k, v], dim=0).movedim(2, 0).contiguous()
    meta = {
        "token": int(export.token),
        "prompt_len": int(export.prompt_len),
        "block_size": int(export.block_size),
        "n_blocks": int(arr.shape[0]),
    }
    return meta, arr


def unpack_payload(meta: Dict[str, Any],
                   arr: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Invert :func:`pack_export` back to the engine's adopt layout
    ([L, n, bs, kvh, hd] per tensor; views of ``arr``)."""
    if arr.ndim != 6 or arr.shape[0] != meta["n_blocks"]:
        raise KVTransferError(
            f"KV payload shape {tuple(arr.shape)} does not match descriptor "
            f"({meta.get('n_blocks')} blocks)")
    kv = arr.movedim(0, 2)  # [2, L, n, bs, kvh, hd]
    return {"k": kv[0], "v": kv[1]}


class KVSender:
    """Prefill-side shipper: one DeviceChannel ring per decode peer on the
    same node (lazily created, cached), a store put for other peers.
    ``ship`` returns the transfer DESCRIPTOR the router forwards to the
    decode replica — the payload itself never touches the router."""

    def __init__(self, src_id: str, *, max_payload_bytes: int,
                 slots: int = 4):
        self.src_id = src_id
        self.max_payload_bytes = int(max_payload_bytes)
        self.slots = slots
        self._chans: Dict[str, Any] = {}
        # the ring is SINGLE-writer: a replica's concurrent request threads
        # serialize their writes per channel (two threads racing write()
        # would claim the same seq and clobber one payload)
        self._wlocks: Dict[str, threading.Lock] = {}
        self._lock = threading.Lock()

    def _channel(self, dst_id: str):
        from ray_tpu_torch.experimental.device_channel import DeviceChannel

        with self._lock:
            ch = self._chans.get(dst_id)
            if ch is None:
                # a slot holds the payload + the pickled meta header + pad
                ch = DeviceChannel(channel_name(self.src_id, dst_id),
                                   capacity=self.max_payload_bytes + 4096,
                                   create=True, slots=self.slots)
                self._chans[dst_id] = ch
                self._wlocks[dst_id] = threading.Lock()
            return ch, self._wlocks[dst_id]

    def _write(self, dst_id: str, meta: Dict[str, Any], arr: torch.Tensor,
               timeout: float) -> Dict[str, Any]:
        from ray_tpu_torch.experimental.device_channel import TensorWithMeta

        ch, wlock = self._channel(dst_id)
        with wlock:
            ch.write(TensorWithMeta(meta, arr), timeout=timeout)
        return {"kind": "channel", "channel": ch.name, "meta": meta}

    def ship(self, export: KVExport, *, req_id: str, dst_id: str,
             same_host: bool, timeout: float = 10.0) -> Dict[str, Any]:
        """Move one export toward ``dst_id``; returns the descriptor to
        hand to the decode replica's adopt call."""
        from ray_tpu_torch.experimental.channel import (ChannelFullError,
                                                        ChannelTimeoutError)
        from ray_tpu_torch.util import failpoints

        failpoints.hit("serve.kv_transfer", req_id)
        meta, arr = pack_export(export)
        meta["req"] = req_id
        t0 = time.perf_counter()
        if same_host:
            try:
                desc = self._write(dst_id, meta, arr, timeout)
                _observe("channel", _nbytes(arr), time.perf_counter() - t0)
                return desc
            except (ChannelFullError, ChannelTimeoutError):
                # decode side wedged or slow to drain: the store path has
                # no ring bound — degrade rather than stall prefill
                pass
        import ray_tpu_torch

        try:
            ref = ray_tpu_torch.put(arr)
        except Exception:
            if not same_host:
                raise
            # no object store (an in-process harness, no runtime): the only
            # degrade left is to BLOCK on the ring until the decode side
            # drains a slot — still bounded, and a typed error
            try:
                desc = self._write(dst_id, meta, arr, 60.0)
            except (ChannelFullError, ChannelTimeoutError) as e:
                raise KVTransferError(
                    f"KV ring to {dst_id} stayed full and no object store "
                    "is available") from e
            _observe("channel", _nbytes(arr), time.perf_counter() - t0)
            return desc
        _observe("store", _nbytes(arr), time.perf_counter() - t0)
        return {"kind": "ref", "ref": ref, "meta": meta,
                "stride": _nbytes(arr) // max(arr.shape[0], 1),
                # records start AFTER the serialized header: a puller
                # anchors chunk boundaries at size - payload_bytes
                "payload_bytes": _nbytes(arr)}

    def close(self) -> None:
        with self._lock:
            chans, self._chans = list(self._chans.values()), {}
        for ch in chans:
            try:
                ch.unlink()
            except Exception:
                pass


class KVReceiver:
    """Decode-side fetcher. Channel payloads arrive in WRITE order on a
    per-sender ring while adopt calls arrive in routing order — so reads
    demux by request id: each fetch drains the ring under the channel's
    lock, parking batches for other requests until their fetch comes.
    Parked entries expire (their request died with its prefill replica), so
    an abandoned payload never pins host memory for good."""

    _PARK_TTL_S = 60.0

    def __init__(self):
        self._chans: Dict[str, Any] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._parked: Dict[str, Tuple[float, Dict[str, Any],
                                      torch.Tensor]] = {}
        self._lock = threading.Lock()

    def _attach(self, name: str):
        from ray_tpu_torch.experimental.device_channel import DeviceChannel

        with self._lock:
            ch = self._chans.get(name)
            if ch is None:
                ch = DeviceChannel(name, create=False)
                self._chans[name] = ch
                self._locks[name] = threading.Lock()
            return ch, self._locks[name]

    def _prune_parked(self, now: float) -> None:
        with self._lock:
            dead = [k for k, (ts, _m, _a) in self._parked.items()
                    if now - ts > self._PARK_TTL_S]
            for k in dead:
                self._parked.pop(k, None)

    def fetch(self, desc: Dict[str, Any], *, timeout: float = 30.0
              ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """Block until this descriptor's payload is in hand; returns
        ``(meta, kv)`` in the engine's adopt layout."""
        t0 = time.perf_counter()
        self._prune_parked(time.monotonic())  # orphan TTL: every fetch
        meta = desc["meta"]
        req = meta.get("req")
        if desc["kind"] == "ref":
            import ray_tpu_torch

            arr = torch.as_tensor(ray_tpu_torch.get(desc["ref"],
                                                    timeout=timeout))
            kv = unpack_payload(meta, arr)
            _observe("store", _nbytes(arr), time.perf_counter() - t0)
            return meta, kv
        if desc["kind"] != "channel":
            raise KVTransferError(f"unknown transfer kind {desc['kind']!r}")
        from ray_tpu_torch.experimental.channel import ChannelTimeoutError

        ch, lock = self._attach(desc["channel"])
        deadline = time.monotonic() + timeout
        while True:
            now = time.monotonic()
            with self._lock:
                parked = self._parked.pop(req, None)
            if parked is not None:
                _ts, pmeta, arr = parked
                kv = unpack_payload(pmeta, arr)
                _observe("channel", _nbytes(arr), time.perf_counter() - t0)
                return pmeta, kv
            if now > deadline:
                raise KVTransferError(
                    f"KV payload for request {req!r} never arrived on "
                    f"{desc['channel']} within {timeout}s (prefill replica "
                    "died mid-transfer?)")
            with lock:
                try:
                    val = ch.read(timeout=min(0.5, deadline - now))
                except ChannelTimeoutError:
                    val = None
            if val is None:
                # a long wait must still expire the orphans it parked
                self._prune_parked(time.monotonic())
                continue
            got_meta = dict(val.meta)
            if got_meta.get("req") == req:
                kv = unpack_payload(got_meta, val.tensor)
                _observe("channel", _nbytes(val.tensor),
                         time.perf_counter() - t0)
                return got_meta, kv
            with self._lock:
                self._parked[got_meta.get("req")] = (
                    time.monotonic(), got_meta, val.tensor)
            self._prune_parked(time.monotonic())

    def close(self) -> None:
        with self._lock:
            chans, self._chans = list(self._chans.values()), {}
            self._locks.clear()
            self._parked.clear()
        for ch in chans:
            try:
                ch.close()
            except Exception:
                pass
