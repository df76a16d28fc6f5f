"""The port's KV-transfer pieces on the CPU, against the JAX package's:

- the shm ring (``experimental/channel.py``): a round trip, the backlog and
  the writer's backpressure, the bound on a ring no reader registered yet,
  each run on both packages' channels, and one package's writer read by
  the other's reader (the segment layout is shared);
- the tensor channel (``experimental/device_channel.py``): a bare tensor
  is read as a CPU tensor that aliases the reader's mapping (bf16
  included), a ``TensorWithMeta`` as a copy, other values by pickle;
- ``serve/kv_transfer.py``: ``pack_export`` byte-equal to the reference's
  on the same seeded export (bf16 compared by its bits), ``unpack_payload``
  its inverse, and a ring demuxed by request id while 12 threads ship and
  12 fetch out of order.

No runtime: everything here is in-process. Every blocking read has a
timeout of its own.
"""

import ctypes
import threading
import time
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.experimental import channel as ref_channel
from ray_tpu.serve import kv_transfer as ref_kvx
from ray_tpu.serve.llm import KVExport as RefKVExport
from ray_tpu_torch.experimental import channel as port_channel
from ray_tpu_torch.experimental.device_channel import (DeviceChannel,
                                                       TensorWithMeta)
from ray_tpu_torch.serve import KVExport, KVTransferError
from ray_tpu_torch.serve import kv_transfer as kvx

IMPLS = {"reference": ref_channel, "port": port_channel}


def _name():
    return f"test-{uuid.uuid4().hex[:10]}"


def _inside(t, mm):
    """Whether tensor ``t``'s bytes lie inside the mapping ``mm``."""
    anchor = ctypes.c_char.from_buffer(mm)
    try:
        base = ctypes.addressof(anchor)
    finally:
        del anchor
    return base <= t.data_ptr() < base + len(mm)


@pytest.mark.parametrize("impl", IMPLS)
def test_channel_write_read_roundtrip(impl):
    mod = IMPLS[impl]
    name = _name()
    ch = mod.Channel(name, capacity=1 << 16, create=True)
    try:
        ch.write({"a": 1, "b": [1, 2, 3]})
        reader = mod.Channel(name, create=False)
        assert reader.read(timeout=5) == {"a": 1, "b": [1, 2, 3]}
        ch.write("second")
        assert reader.read(timeout=5) == "second"
        with pytest.raises(mod.ChannelTimeoutError):
            reader.read(timeout=0.1)
        reader.close()
    finally:
        ch.unlink()


@pytest.mark.parametrize("impl", IMPLS)
def test_channel_ring_backlog_and_writer_backpressure(impl):
    mod = IMPLS[impl]
    name = _name()
    ch = mod.Channel(name, capacity=1 << 12, create=True, slots=4)
    try:
        reader = mod.Channel(name, create=False)
        for i in range(3):
            ch.write(i)
        assert [reader.read(timeout=5) for _ in range(3)] == [0, 1, 2]
        for i in range(10):          # the ring wraps across many cycles
            ch.write(("wrap", i))
            assert reader.read(timeout=5) == ("wrap", i)
        for i in range(4):           # fill every slot
            ch.write(i)
        with pytest.raises(mod.ChannelFullError):
            ch.write(99, timeout=0.2)
        assert reader.read(timeout=5) == 0   # frees one slot
        ch.write(99, timeout=5)
        assert [reader.read(timeout=5) for _ in range(4)] == [1, 2, 3, 99]
        reader.close()
    finally:
        ch.unlink()


@pytest.mark.parametrize("impl", IMPLS)
def test_channel_unregistered_ring_is_bounded(impl):
    mod = IMPLS[impl]
    name = _name()
    ch = mod.Channel(name, capacity=1 << 12, create=True, slots=3)
    try:
        for i in range(3):
            ch.write(i)
        with pytest.raises(mod.ChannelFullError):
            ch.write(3, timeout=0.2)
        reader = mod.Channel(name, create=False)
        assert reader.read(timeout=5) == 0   # backlog intact from value 0
        reader.close()
    finally:
        ch.unlink()


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_channel_segments_are_shared_between_packages(writer, reader):
    name = _name()
    ch = IMPLS[writer].Channel(name, capacity=1 << 12, create=True, slots=2)
    try:
        rd = IMPLS[reader].Channel(name, create=False)
        for value in ({"k": [1, 2]}, "x", 7):
            ch.write(value, timeout=5)
            assert rd.read(timeout=5) == value
        rd.close()
    finally:
        ch.unlink()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64], ids=str)
def test_device_channel_roundtrip_aliases_the_slot(dtype):
    name = _name()
    ch = DeviceChannel(name, capacity=1 << 20, create=True)
    try:
        x = (torch.arange(1024, dtype=torch.float32) * 2.0 - 7.0).to(dtype)
        ch.write(x.view(32, 32).t())     # strided: written in one copy
        rd = DeviceChannel(name, create=False)
        out = rd.read(timeout=5)
        assert out.dtype == dtype and out.device.type == "cpu"
        assert torch.equal(out, x.view(32, 32).t())
        # zero-copy: the tensor's bytes lie inside the reader's mapping,
        # 64-byte aligned
        assert _inside(out, rd._mm) and out.data_ptr() % 64 == 0
        del out
        # control values still travel (pickle fallback)
        ch.write({"not": "a tensor"})
        assert rd.read(timeout=5) == {"not": "a tensor"}
        rd.close()
    finally:
        ch.unlink()


def test_device_channel_tensor_with_meta_is_a_copy():
    name = _name()
    ch = DeviceChannel(name, capacity=1 << 16, create=True, slots=2)
    try:
        rd = DeviceChannel(name, create=False)
        x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
        ch.write(TensorWithMeta({"req": "a", "n": 4}, x.to(torch.bfloat16)))
        got = rd.read(timeout=5)
        assert isinstance(got, TensorWithMeta)
        assert got.meta == {"req": "a", "n": 4}
        assert torch.equal(got.tensor, x.to(torch.bfloat16))
        assert not _inside(got.tensor, rd._mm)
        # the ring moves on over the same slots: the copy stays as it was
        for i in range(2):
            ch.write(TensorWithMeta({}, torch.zeros(4, 8)), timeout=5)
            rd.read(timeout=5)
        assert torch.equal(got.tensor, x.to(torch.bfloat16))
        rd.close()
    finally:
        ch.unlink()


def _np_export(seed, dtype, n_blocks=3, bs=4):
    """A reference ``KVExport`` from a numpy seed ([L=2, n, bs, kvh=2,
    hd=8] per tensor), in ``dtype`` (bf16 as ml_dtypes')."""
    rng = np.random.default_rng(seed)
    kv = {name: rng.normal(size=(2, n_blocks, bs, 2, 8)).astype(np.float32)
          .astype(dtype) for name in ("k", "v")}
    return RefKVExport(token=seed, prompt_len=n_blocks * bs - 1,
                       block_size=bs, kv=kv)


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_export(ref):
    return KVExport(token=ref.token, prompt_len=ref.prompt_len,
                    block_size=ref.block_size,
                    kv={k: _to_torch(v) for k, v in ref.kv.items()})


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_pack_export_is_byte_equal_to_reference(dtype):
    ref = _np_export(7, dtype)
    ref_meta, ref_arr = ref_kvx.pack_export(ref)
    meta, arr = kvx.pack_export(_port_export(ref))
    assert meta == ref_meta
    assert arr.is_contiguous() and tuple(arr.shape) == ref_arr.shape
    assert arr.shape[0] == 3 and meta["n_blocks"] == 3 and meta["token"] == 7
    assert _bytes(arr) == ref_arr.tobytes()
    # one block is one contiguous record: block i's bytes are the i-th slice
    rec = arr[0].numel() * arr.element_size()
    assert _bytes(arr)[rec:2 * rec] == _bytes(arr[1])
    kv = kvx.unpack_payload(meta, arr)
    ref_kv = ref_kvx.unpack_payload(ref_meta, ref_arr)
    for name in ("k", "v"):
        assert _bytes(kv[name]) == np.ascontiguousarray(ref_kv[name]).tobytes()
        assert torch.equal(kv[name], _to_torch(ref.kv[name]))


def test_unpack_rejects_a_payload_that_does_not_match_its_descriptor():
    meta, arr = kvx.pack_export(_port_export(_np_export(1, np.float32)))
    with pytest.raises(KVTransferError, match="does not match"):
        kvx.unpack_payload(dict(meta, n_blocks=4), arr)
    with pytest.raises(ref_kvx.KVTransferError, match="does not match"):
        ref_kvx.unpack_payload(dict(meta, n_blocks=4), arr.numpy())


def test_ring_demuxes_out_of_order_fetches_from_concurrent_writers():
    """12 payloads shipped from 12 threads and fetched by 12 more started
    in reverse order: every request gets ITS payload — the per-channel
    writer lock keeps the single-writer ring sound, the request-id demux
    parks strays."""
    exports = {i: _port_export(_np_export(i, np.float32)) for i in range(12)}
    snd = kvx.KVSender(f"src{uuid.uuid4().hex[:6]}",
                       max_payload_bytes=exports[0].nbytes)
    rcv = kvx.KVReceiver()
    descs, dlock = {}, threading.Lock()
    got, errs = {}, []
    try:
        def ship(i):
            d = snd.ship(exports[i], req_id=f"r{i}", dst_id="dst",
                         same_host=True, timeout=30.0)
            with dlock:
                descs[i] = d

        def fetch(i):
            deadline = time.monotonic() + 30
            d = None
            while d is None and time.monotonic() < deadline:
                with dlock:
                    d = descs.get(i)
                time.sleep(0.01)
            try:
                got[i] = rcv.fetch(d, timeout=30.0)
            except BaseException as e:  # noqa: BLE001 - asserted below
                errs.append((i, e))

        threads = ([threading.Thread(target=ship, args=(i,))
                    for i in range(12)]
                   + [threading.Thread(target=fetch, args=(i,))
                      for i in reversed(range(12))])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, errs
        assert sorted(got) == list(range(12))
        for i, (meta, kv) in got.items():
            assert meta["token"] == i and meta["req"] == f"r{i}"
            for name in ("k", "v"):
                assert torch.equal(kv[name], exports[i].kv[name])
        assert {d["kind"] for d in descs.values()} == {"channel"}
    finally:
        snd.close()
        rcv.close()
