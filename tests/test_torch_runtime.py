"""The port's actor runtime and object store (``ray_tpu_torch.core``) on the
CPU: tasks, actors, refs as arguments, ``wait``; torch tensors through
``put`` / ``get`` with their bytes out of band, coming back as views of the
store; the serialized layout of a numpy payload against the JAX package's
serializer; what a worker imports and which card it sees.

One runtime per module, with a small store (``RTPU_STORE_CAPACITY`` and
``RTPU_STORE_PREFAULT_BYTES`` at most 64 MB) and one prestarted worker."""

import glob
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.exceptions import TaskError

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
# every dtype the port's params, caches, staging and exports use
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int64,
          torch.int32, torch.int8, torch.uint8, torch.bool]


def _init():
    # num_gpus=1 on the CPU: the GPU resource exists, so the scheduling of
    # a num_gpus actor (a fresh process that opted in) can be checked here
    rt.init(num_cpus=4, num_gpus=1)
    return rt.core.runtime._get_runtime().session


@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    _init()
    yield
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _segments(session):
    return glob.glob(f"/dev/shm/rtpu-{session}-*") + glob.glob(
        f"/dev/shm/rtpu-*-{session}*")


def _bits(t):
    """A tensor's bytes as an integer tensor, for bitwise comparison."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t.reshape(-1).view(torch.uint8)


def _store_ranges():
    """Address ranges of this process's mappings of the shared store."""
    out = []
    with open("/proc/self/maps") as f:
        for line in f:
            if "/dev/shm/rtpu-" in line:
                lo, hi = line.split()[0].split("-")
                out.append((int(lo, 16), int(hi, 16)))
    return out


def _payload(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn(256, 128, generator=g),
                       "wb": torch.randn(512, 64, generator=g).to(
                           torch.bfloat16)},
            "ids": [torch.randint(0, 1 << 40, (4096,), generator=g)],
            "meta": ("llama-debug", 3)}


def test_tasks_and_refs_as_arguments(runtime):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(num_returns=2)
    def pair(x):
        return x, -x

    r1 = add.remote(1, 2)
    r2 = add.remote(r1, 10)            # a ref as an argument
    a, b = pair.remote(r2)
    assert rt.get([r1, r2, a, b]) == [3, 13, 13, -13]


def test_actors_named_and_anonymous(runtime):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    anon = Counter.remote(5)
    named = Counter.options(name="torch_rt_counter").remote(100)
    assert rt.get(anon.inc.remote()) == 6
    assert rt.get(named.inc.remote(2)) == 102
    again = rt.get_actor("torch_rt_counter")
    assert rt.get(again.inc.remote(3)) == 105
    rt.kill(anon)


def test_wait_with_a_timeout(runtime):
    @rt.remote
    def sleepy(s):
        time.sleep(s)
        return s

    fast, slow = sleepy.remote(0.0), sleepy.remote(30.0)
    ready, pending = rt.wait([fast, slow], num_returns=2, timeout=3.0)
    assert ready == [fast] and pending == [slow]
    rt.cancel(slow, force=True)


def test_put_get_tensors_out_of_band_as_views_of_the_store(runtime):
    value = _payload()
    data, buffers = serialization.serialize(value)
    # the three tensors' storage bytes, and nothing else, out of band
    assert sorted(b.raw().nbytes for b in buffers) == sorted(
        [256 * 128 * 4, 512 * 64 * 2, 4096 * 8])
    assert len(data) < 2048
    got = rt.get(rt.put(value))
    assert got["meta"] == ("llama-debug", 3)
    ranges = _store_ranges()
    assert ranges
    for want, have in ((value["layers"]["w"], got["layers"]["w"]),
                       (value["layers"]["wb"], got["layers"]["wb"]),
                       (value["ids"][0], got["ids"][0])):
        assert have.dtype == want.dtype and have.shape == want.shape
        assert torch.equal(_bits(have), _bits(want))
        ptr = have.untyped_storage().data_ptr()
        assert any(lo <= ptr < hi for lo, hi in ranges), \
            "not a view of the store"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_dtype_round_trips_bitwise_through_a_worker(runtime, dtype):
    g = torch.Generator().manual_seed(1)
    src = torch.randn(48, 40, generator=g) * 100
    t = src.to(dtype) if dtype != torch.bool else src > 0
    t = t[:, 3:35]                      # a non-contiguous view

    @rt.remote
    def echo(d):
        return {"t": d["t"], "dtype": str(d["t"].dtype),
                "on_cpu": d["t"].device.type == "cpu"}

    out = rt.get(echo.remote({"t": t}))
    assert out["dtype"] == str(dtype) and out["on_cpu"]
    assert out["t"].shape == t.shape
    assert torch.equal(_bits(out["t"]), _bits(t.contiguous()))


def test_parameter_and_requires_grad_survive(runtime):
    p = torch.nn.Parameter(torch.ones(300, 4))
    g = torch.zeros(300, 4, requires_grad=True)
    out = rt.get(rt.put({"p": p, "g": g}))
    assert isinstance(out["p"], torch.nn.Parameter) and out["p"].requires_grad
    assert out["g"].requires_grad and torch.equal(out["g"], g)


def test_numpy_payload_layout_matches_the_reference_serializer():
    from ray_tpu.core import serialization as ref

    rng = np.random.default_rng(0)
    payload = {"a": rng.standard_normal((64, 64)).astype(np.float32),
               "b": [1, "two", rng.integers(0, 9, 2000)],
               "c": np.arange(10, dtype=np.int16)}
    data, bufs = serialization.serialize(payload)
    rdata, rbufs = ref.serialize(payload)
    assert data == rdata
    assert [b.raw().nbytes for b in bufs] == [b.raw().nbytes for b in rbufs]
    assert serialization.dumps_oob(payload) == ref.dumps_oob(payload)


def test_worker_imports_no_jax_and_sees_no_card(runtime):
    @rt.remote
    def probe():
        import sys

        import torch

        return ([m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")],
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.is_available(), torch.cuda.is_initialized())

    mods, visible, available, initialized = rt.get(probe.remote())
    assert mods == []
    assert visible == "" and not available and not initialized
    # the driver made no CUDA context either
    assert not torch.cuda.is_initialized()


def test_gpu_actor_opts_in_from_a_fresh_process(runtime):
    @rt.remote
    def pid():
        return os.getpid()

    pool_pids = set(rt.get([pid.remote() for _ in range(4)]))

    @rt.remote(num_gpus=1,
               runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}})
    class OnCard:
        def where(self):
            return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    a = OnCard.remote()
    actor_pid, visible = rt.get(a.where.remote())
    assert visible == "0"
    assert actor_pid not in pool_pids
    assert rt.available_resources().get("GPU", 0) == 0
    rt.kill(a)


def test_placement_group_reserves_and_schedules(runtime):
    from ray_tpu_torch.util import placement_group, remove_placement_group

    pg = placement_group([{"CPU": 1}, {"CPU": 1}])
    assert pg.wait(10)

    @rt.remote
    def one():
        return 1

    refs = [one.options(placement_group=pg,
                        placement_group_bundle_index=i).remote()
            for i in range(2)]
    assert rt.get(refs) == [1, 1]
    remove_placement_group(pg)


def test_gpu_count_follows_visible_devices_without_cuda(monkeypatch):
    from ray_tpu_torch.accelerators import gpu

    monkeypatch.setattr(gpu, "_nvml_count", lambda: 4)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert gpu.detect_num_gpus() == 0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    assert gpu.detect_num_gpus() == 2
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert gpu.detect_num_gpus() == 4
    assert gpu.hidden_worker_env()["CUDA_VISIBLE_DEVICES"] == ""
    assert not torch.cuda.is_initialized()


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        rt.init(address="10.0.0.1:6379")


def test_task_error_carries_the_remote_exception(runtime):
    @rt.remote
    def boom():
        raise ValueError("bad input")

    with pytest.raises(TaskError, match="bad input"):
        rt.get(boom.remote())


def test_shutdown_leaves_no_segment_of_its_session(runtime):
    session = rt.core.runtime._get_runtime().session
    rt.get(rt.put(torch.zeros(1 << 16)))
    assert _segments(session)
    rt.shutdown()
    deadline = time.monotonic() + 5
    while _segments(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _segments(session) == []
    _init()                             # the module's later tests
