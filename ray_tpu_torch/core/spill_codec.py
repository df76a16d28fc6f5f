"""Compressed spill-file IO (the disk leg of the object store).

Role analog: the reference's spilled-object URI layer with IO workers
(``local_object_manager.h``) — here the win is bandwidth: spill files live
on slow disk, so trading CPU for bytes moves the spill/restore ceiling.
The codec is the native LZ4 block implementation (``native/pipe.cc``; no
lz4/zstd python modules exist in the image), with zlib as the pure-Python
fallback and ``RTPU_SPILL_COMPRESSION=off`` as the kill switch.

File format (self-describing; readers handle every codec + legacy raw)::

    magic  b"RTPZ1"
    u8     codec        (1 = lz4-native, 2 = zlib)
    u64le  raw_size     (logical serialized object size)
    u32le  block_raw    (raw bytes per block, last may be short)
    blocks: [ u32le comp_len  u32le raw_len  payload ]*

A block whose ``comp_len == raw_len`` is stored RAW (incompressible
guard); whole-file incompressibility falls back to a headerless raw file,
indistinguishable from the legacy format. Block framing exists so
``read_range`` (chunked peer pulls) can seek without inflating the whole
object, and bounds decompress buffers on restore.

Legacy/raw detection is unambiguous: spill files always hold
serialization-format payloads whose first byte is 0x00 (little-endian
``serialization.MAGIC``), which can never match ``RTPZ1``.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

from ray_tpu_torch import config

MAGIC = b"RTPZ1"
CODEC_LZ4 = 1
CODEC_ZLIB = 2
#: raw bytes per compressed block (seekable unit for read_range)
BLOCK_RAW = 4 << 20

_HDR = struct.Struct("<5sBQI")      # magic, codec, raw_size, block_raw
_BLK = struct.Struct("<II")         # comp_len, raw_len


def _codec_metrics():
    from ray_tpu_torch.util import metric_defs as md

    return {
        "comp_bytes": md.get(
            "rtpu_object_store_spill_compressed_bytes_total"),
        "ratio": md.get("rtpu_object_store_spill_compression_ratio"),
    }


def _pick_codec() -> int:
    """Resolve the configured codec to a concrete one, or 0 for off."""
    mode = str(config.get("spill_compression")).lower()
    if mode in ("off", "0", "false", "no", "none", ""):
        return 0
    if mode == "zlib":
        return CODEC_ZLIB
    # auto / lz4: native when the .so carries the codec, else zlib
    try:
        from ray_tpu_torch import _native

        if _native.load_store_lib() is not None and \
                _native.native_status()["lz4"]:
            return CODEC_LZ4
    except Exception:
        pass
    return 0 if mode == "lz4" else CODEC_ZLIB


def _compress_block(codec: int, block) -> Optional[bytes]:
    if codec == CODEC_LZ4:
        from ray_tpu_torch import _native

        return _native.lz4_compress(block)
    import zlib

    return zlib.compress(bytes(block), 1)


def _decompress_block(codec: int, payload: bytes, raw_len: int) -> bytes:
    if codec == CODEC_LZ4:
        from ray_tpu_torch import _native

        return _native.lz4_decompress(payload, raw_len)
    import zlib

    out = zlib.decompress(payload)
    if len(out) != raw_len:
        raise ValueError("corrupt zlib spill block")
    return out


def write_spill_stream(path: str, size: int, blocks) -> int:
    """STREAMING spill write: ``blocks`` yields the serialized object in
    ``BLOCK_RAW``-sized chunks (last short) — see
    ``serialization.iter_serialized_blocks``. Each block is compressed
    and written as it arrives, so a multi-GB spill's peak extra heap is
    one block (incompressible blocks are framed raw, bounding the
    worst-case file at size + ~8 bytes per block). O_EXCL like the
    legacy writer (concurrent spillers of one object: first wins).
    Returns the PHYSICAL byte count written."""
    codec = _pick_codec()
    cap = int(config.get("spill_compress_max_bytes"))
    if cap and size > cap:
        # huge objects stay RAW: a compressed spill served without shm
        # headroom must inflate to anonymous heap, while a raw file is
        # mmap-servable (page-cache backed, reclaimable) — the cap keeps
        # that worst case bounded on exactly the memory-tight boxes that
        # spill in the first place
        codec = 0
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_EXCL, 0o600)
    physical = 0
    try:
        if not codec or size == 0:
            for block in blocks:  # raw legacy-format file
                os.write(fd, block)
                physical += len(block)
            return physical
        hdr = _HDR.pack(MAGIC, codec, size, BLOCK_RAW)
        os.write(fd, hdr)
        physical = len(hdr)
        for block in blocks:
            comp = _compress_block(codec, block)
            if comp is None or len(comp) >= len(block):
                comp = bytes(block)  # incompressible block stays raw
            os.write(fd, _BLK.pack(len(comp), len(block)))
            os.write(fd, comp)
            physical += _BLK.size + len(comp)
    finally:
        os.close(fd)
    if physical < size:
        try:
            m = _codec_metrics()
            m["comp_bytes"].inc(physical)
            m["ratio"].observe(size / max(1, physical))
        except Exception:
            pass
    return physical


def write_spill(path: str, buf) -> int:
    """Whole-buffer convenience wrapper over ``write_spill_stream``."""
    mv = memoryview(buf).cast("B")
    size = len(mv)
    return write_spill_stream(
        path, size,
        (bytes(mv[off:off + BLOCK_RAW])
         for off in range(0, size, BLOCK_RAW)))


def _read_header(f) -> Optional[tuple]:
    head = f.read(_HDR.size)
    if len(head) < _HDR.size or not head.startswith(MAGIC):
        return None
    magic, codec, raw_size, block_raw = _HDR.unpack(head)
    return codec, raw_size, block_raw


def raw_size(path: str) -> Optional[int]:
    """Logical (decompressed) size of a spill file; None if absent."""
    try:
        with open(path, "rb") as f:
            hdr = _read_header(f)
            if hdr is None:
                return os.fstat(f.fileno()).st_size
            return hdr[1]
    except OSError:
        return None


def is_compressed(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def read_into(path: str, buf, size: int, chunk: int = 8 << 20) -> bool:
    """Decompress (or plain-copy) the spill file into a writable buffer
    of exactly ``size`` bytes — the restore path. Bounded memory: one
    block (compressed) at a time."""
    try:
        with open(path, "rb") as f:
            hdr = _read_header(f)
            if hdr is None:
                f.seek(0)
                off = 0
                while off < size:
                    data = f.read(min(chunk, size - off))
                    if not data:
                        return False  # truncated under us
                    buf[off:off + len(data)] = data
                    off += len(data)
                return off == size
            codec, raw_total, _block_raw = hdr
            if raw_total != size:
                return False
            mv = memoryview(buf)
            off = 0
            while off < size:
                bh = f.read(_BLK.size)
                if len(bh) < _BLK.size:
                    return False
                comp_len, raw_len = _BLK.unpack(bh)
                payload = f.read(comp_len)
                if len(payload) < comp_len:
                    return False
                if comp_len == raw_len:
                    mv[off:off + raw_len] = payload
                elif codec == CODEC_LZ4:
                    # inflate DIRECTLY into the destination (arena view /
                    # mmap) — no per-block heap copy on the restore path
                    from ray_tpu_torch import _native

                    if _native.lz4_decompress_into(
                            payload, mv[off:off + raw_len]) != raw_len:
                        return False
                else:
                    mv[off:off + raw_len] = _decompress_block(
                        codec, payload, raw_len)
                off += raw_len
            return off == size
    except (OSError, ValueError, RuntimeError):
        return False


def read_bytes(path: str) -> Optional[bytes]:
    """The whole logical payload (get_raw on a spilled object)."""
    size = raw_size(path)
    if size is None:
        return None
    out = bytearray(size)
    if not read_into(path, out, size):
        return None
    return bytes(out)


#: path -> (stat signature, [file offset of block i's header]) — spill
#: files are immutable once written (O_EXCL create, unlink-only), so a
#: per-process index makes chunked peer pulls O(range) instead of
#: re-walking every 8-byte block header from the file head per chunk.
#: Bounded FIFO; entries for vanished/replaced files drop on sig mismatch.
_range_index: dict = {}
_RANGE_INDEX_MAX = 32


def _block_index(path: str, f) -> Optional[list]:
    try:
        st = os.fstat(f.fileno())
        sig = (st.st_ino, st.st_size, st.st_mtime_ns)
    except OSError:
        return None
    ent = _range_index.get(path)
    if ent is not None and ent[0] == sig:
        return ent[1]
    offsets = []
    pos = _HDR.size
    end = st.st_size
    while pos < end:
        offsets.append(pos)
        f.seek(pos)
        bh = f.read(_BLK.size)
        if len(bh) < _BLK.size:
            return None
        comp_len, _raw_len = _BLK.unpack(bh)
        pos += _BLK.size + comp_len
    while len(_range_index) >= _RANGE_INDEX_MAX:
        try:  # concurrent evictors may race on the same first key
            _range_index.pop(next(iter(_range_index)), None)
        except (StopIteration, RuntimeError):
            break
    _range_index[path] = (sig, offsets)
    return offsets


def read_range(path: str, offset: int, length: int) -> Optional[bytes]:
    """A logical slice (chunked peer pull of a spilled object): jumps
    straight to the blocks overlapping the range via the per-file block
    index (every block holds exactly ``block_raw`` logical bytes except
    the last), inflating only those."""
    try:
        with open(path, "rb") as f:
            hdr = _read_header(f)
            if hdr is None:
                f.seek(offset)
                return f.read(length)
            codec, raw_total, block_raw = hdr
            end = min(offset + length, raw_total)
            if offset >= raw_total:
                return b""
            index = _block_index(path, f)
            if index is None:
                return None
            out = bytearray()
            for bi in range(offset // block_raw,
                            (end + block_raw - 1) // block_raw):
                if bi >= len(index):
                    return None
                f.seek(index[bi])
                bh = f.read(_BLK.size)
                if len(bh) < _BLK.size:
                    return None
                comp_len, raw_len = _BLK.unpack(bh)
                payload = f.read(comp_len)
                if len(payload) < comp_len:
                    return None
                block = (payload if comp_len == raw_len
                         else _decompress_block(codec, payload, raw_len))
                pos = bi * block_raw
                lo = max(0, offset - pos)
                hi = min(raw_len, end - pos)
                out += block[lo:hi]
            return bytes(out)
    except (OSError, ValueError, RuntimeError):
        return None
