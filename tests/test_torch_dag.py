"""The port's DAG API (``ray_tpu_torch.dag``) on the CPU, case for case
against the runtime cases of ``tests/test_dag.py``: eager execute and the
function node; compiled pipelines and fan-in; errors propagated and
isolated under pipelining; FIFO delivery with out-of-order ``get``;
concurrent producers; backpressure; ``execute_async``; teardown that
unlinks the channels and frees the actor; a dead stage detected; tensor
edges, whose values are the JAX package's on the same numpy inputs
(tolerance 0, f32); and a future's tensor that later invocations leave
unchanged (a read of a tensor edge aliases its ring slot). ``_compile``'s
validation errors are held against the reference's without a runtime.

One runtime for the module, with a small store (``RTPU_STORE_CAPACITY`` and
``RTPU_STORE_PREFAULT_BYTES`` at most 64 MB) and one prestarted worker; the
runtime cases run in three tests. Every ``get`` / ``execute`` has a finite
timeout, and every compiled DAG is torn down in ``finally``. At teardown no channel of the session is left.
"""

import asyncio
import gc
import glob
import os
import re
import sys
import threading
import time

import cloudpickle
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import dag as ref_dag
from ray_tpu_torch import dag
from ray_tpu_torch.dag import (DAGBackpressureError, DAGExecutionError,
                               InputNode)

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
GET_S = 60.0   # every get / execute: a hang fails the test
# the stage classes below travel to the workers by value (a test module is
# not importable there)
cloudpickle.register_pickle_by_value(sys.modules[__name__])


def _channels(session):
    return glob.glob(f"/dev/shm/rtpu-chan-{session}-*")


@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    rt.init(num_cpus=4)
    session = rt.core.runtime._get_runtime().session
    yield session
    left = _channels(session)
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    assert left == [], left


class _Actors:
    """Actors a case creates, killed when it ends (the module shares one
    runtime)."""

    def __init__(self):
        self.handles = []

    def __call__(self, cls, *args, **opts):
        h = (rt.remote(cls).options(**opts) if opts
             else rt.remote(cls)).remote(*args)
        self.handles.append(h)
        return h

    def kill(self):
        for h in self.handles:
            try:
                rt.kill(h)
            except Exception:
                pass


# -- the reference's runtime cases --------------------------------------------

class Adder:
    def __init__(self, k):
        self.k = k

    def add(self, x):
        return x + self.k


class Scaler:
    def scale(self, x):
        return x * 10


class Worker:
    def double(self, x):
        return 2 * x

    def add(self, a, b):
        return a + b


class Failer:
    def boom(self, x):
        if x == 13:
            raise ValueError("unlucky")
        return x


class Slow:
    def apply(self, x):
        time.sleep(1.5)
        return x


def case_eager_execute(actors):
    a, s = actors(Adder, 5), actors(Scaler)
    with InputNode() as inp:
        node = s.scale.bind(a.add.bind(inp))
    assert isinstance(node, dag.ClassMethodNode)
    assert rt.get(node.execute(3), timeout=GET_S) == 80


def case_function_node(actors):
    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        node = inc.bind(double.bind(inp))
    assert isinstance(node, dag.FunctionNode)
    assert rt.get(node.execute(10), timeout=GET_S) == 21


def case_compiled_pipeline(actors):
    s1, s2 = actors(Adder, 1), actors(Adder, 10)
    with InputNode() as inp:
        node = s2.add.bind(s1.add.bind(inp))
    compiled = node.experimental_compile()
    try:
        # repeated invocations reuse the same channels and loops
        for i in range(5):
            assert compiled.execute(i, timeout=GET_S).get(
                timeout=GET_S) == i + 11
    finally:
        compiled.teardown()


def case_compiled_fan_in(actors):
    w1, w2, w3 = actors(Worker), actors(Worker), actors(Worker)
    with InputNode() as inp:
        node = w3.add.bind(w1.double.bind(inp), w2.double.bind(inp))
    compiled = node.experimental_compile()
    try:
        assert compiled.execute(3, timeout=GET_S).get(timeout=GET_S) == 12
        assert compiled.execute(5, timeout=GET_S).get(timeout=GET_S) == 20
    finally:
        compiled.teardown()


def case_error_propagates(actors):
    f = actors(Failer)
    with InputNode() as inp:
        node = f.boom.bind(inp)
    compiled = node.experimental_compile()
    try:
        assert compiled.execute(1, timeout=GET_S).get(timeout=GET_S) == 1
        with pytest.raises(DAGExecutionError) as err:
            compiled.execute(13, timeout=GET_S).get(timeout=GET_S)
        assert isinstance(err.value.__cause__, ValueError)
        # the pipeline survives the error
        assert compiled.execute(2, timeout=GET_S).get(timeout=GET_S) == 2
    finally:
        compiled.teardown()


def case_error_isolation_under_pipelining(actors):
    f = actors(Failer)
    with InputNode() as inp:
        node = f.boom.bind(inp)
    compiled = node.experimental_compile(max_in_flight=4)
    try:
        futs = [compiled.execute(x, timeout=GET_S) for x in (1, 13, 2)]
        assert futs[0].get(timeout=GET_S) == 1
        with pytest.raises(DAGExecutionError):
            futs[1].get(timeout=GET_S)
        assert futs[2].get(timeout=GET_S) == 2
    finally:
        compiled.teardown()


def case_pipelined_fifo_and_out_of_order_get(actors):
    s = actors(Scaler)
    with InputNode() as inp:
        node = s.scale.bind(inp)
    compiled = node.experimental_compile(max_in_flight=8)
    try:
        futs = [compiled.execute(i, timeout=GET_S) for i in range(8)]
        # awaiting the LAST future buffers results 0..6 into their own
        assert futs[7].get(timeout=GET_S) == 70
        assert [futs[i].get(timeout=GET_S) for i in range(7)] == [
            i * 10 for i in range(7)]
        # a second wave reuses the same rings
        futs = [compiled.execute(i, timeout=GET_S) for i in range(8)]
        assert [f.get(timeout=GET_S) for f in futs] == [
            i * 10 for i in range(8)]
    finally:
        compiled.teardown()


def case_pipeline_overlaps_stages(actors):
    s1, s2 = actors(Adder, 1), actors(Adder, 100)
    with InputNode() as inp:
        node = s2.add.bind(s1.add.bind(inp))
    compiled = node.experimental_compile(max_in_flight=4)
    try:
        for _ in range(3):
            futs = [compiled.execute(i, timeout=GET_S) for i in range(4)]
            assert [f.get(timeout=GET_S) for f in futs] == [
                i + 101 for i in range(4)]
    finally:
        compiled.teardown()


def case_concurrent_producers_fifo(actors):
    a = actors(Adder, 1)
    with InputNode() as inp:
        node = a.add.bind(inp)
    compiled = node.experimental_compile(max_in_flight=8)
    errors = []

    def drive(tid):
        try:
            for i in range(15):
                x = tid * 1000 + i
                got = compiled.execute(x, timeout=GET_S).get(timeout=GET_S)
                if got != x + 1:
                    errors.append((x, got))
        except BaseException as e:  # noqa: BLE001 - collected for assert
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=drive, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        compiled.teardown()


def case_backpressure_error(actors):
    s = actors(Slow)
    with InputNode() as inp:
        node = s.apply.bind(inp)
    compiled = node.experimental_compile(max_in_flight=2)
    try:
        f1 = compiled.execute(1, timeout=GET_S)
        f2 = compiled.execute(2, timeout=GET_S)
        with pytest.raises(DAGBackpressureError):
            compiled.execute(3, timeout=0.2)
        assert issubclass(DAGBackpressureError, DAGExecutionError)
        assert f1.get(timeout=GET_S) == 1
        assert f2.get(timeout=GET_S) == 2
        # slots freed: the same admission now succeeds
        assert compiled.execute(3, timeout=GET_S).get(timeout=GET_S) == 3
    finally:
        compiled.teardown()


def case_execute_async(actors):
    s = actors(Adder, 0)
    with InputNode() as inp:
        node = s.add.bind(inp)
    compiled = node.experimental_compile(max_in_flight=4)

    async def drive():
        futs = [await compiled.execute_async(i * 3, timeout=GET_S)
                for i in range(4)]
        return [await asyncio.wait_for(f.get_async(timeout=GET_S), GET_S)
                for f in futs]

    try:
        assert asyncio.run(drive()) == [0, 3, 6, 9]
    finally:
        compiled.teardown()


def case_teardown_unlinks_channels_and_frees_actor(actors):
    s = actors(Adder, 0)
    with InputNode() as inp:
        node = s.add.bind(inp)
    compiled = node.experimental_compile()
    try:
        assert compiled.execute(7, timeout=GET_S).get(timeout=GET_S) == 7
        paths = [ch.path for ch in compiled._channels]
        session = rt.core.runtime._get_runtime().session
        assert all(os.path.basename(p).startswith(f"rtpu-chan-{session}-")
                   for p in paths)
    finally:
        compiled.teardown()
    assert not any(os.path.exists(p) for p in paths)
    # after teardown the actor serves normal calls again
    assert rt.get(s.add.remote(42), timeout=GET_S) == 42
    with pytest.raises(DAGExecutionError, match="torn down"):
        compiled.execute(1, timeout=GET_S)


def case_dead_stage_detected(actors):
    s1, s2 = actors(Adder, 1), actors(Adder, 10)
    with InputNode() as inp:
        node = s2.add.bind(s1.add.bind(inp))
    compiled = node.experimental_compile()
    paths = [ch.path for ch in compiled._channels]
    try:
        assert compiled.execute(1, timeout=GET_S).get(timeout=GET_S) == 12
        rt.kill(s1)
        deadline = time.monotonic() + GET_S
        while not rt.wait(compiled._loop_refs, num_returns=1,
                          timeout=0.2)[0]:
            assert time.monotonic() < deadline, "the loop ref never ended"
        t0 = time.monotonic()
        with pytest.raises(DAGExecutionError, match="mid"):
            compiled.execute(2, timeout=GET_S).get(timeout=GET_S)
        # detected through the loop refs, not a channel timeout
        assert time.monotonic() - t0 < 10
    finally:
        compiled.teardown()
    assert not any(os.path.exists(p) for p in paths)


class ScaleTensor:
    def apply(self, x):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu", x
        return x * 2.0


class ClampTensor:
    def apply(self, x):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu", x
        return torch.clamp(x, min=0.0) + 1.0


def case_tensor_edges(actors):
    """Tensor edges between two stages and to the driver: torch tensors
    through the tensor channel, each value the JAX package's on the same
    numpy inputs, bitwise (elementwise f32 products and sums)."""
    a, b = actors(ScaleTensor), actors(ClampTensor)
    with InputNode() as inp:
        inp.with_tensor_transport()
        mid = a.apply.bind(inp).with_tensor_transport()
        out = b.apply.bind(mid).with_tensor_transport()
    compiled = out.experimental_compile(max_in_flight=2)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((16, 64)).astype(np.float32) for _ in range(3)]
    try:
        kinds = {type(ch).__name__ for ch in compiled._channels}
        assert kinds == {"DeviceChannel"}, kinds
        for x in xs:
            got = compiled.execute(torch.from_numpy(x), timeout=GET_S).get(
                timeout=GET_S)
            want = np.asarray(jnp.maximum(jnp.asarray(x) * 2.0, 0.0) + 1.0)
            assert got.dtype == torch.float32 and got.shape == (16, 64)
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        compiled.teardown()


def case_future_tensor_survives_later_invocations(actors):
    """max_in_flight=2 (3 slots): execute twice, get the second (the first
    is drained into its future), execute twice more; the fourth result
    goes to the first's slot, and the first future's tensor must not
    change."""
    a = actors(ScaleTensor)
    with InputNode() as inp:
        out = a.apply.bind(inp).with_tensor_transport()
    compiled = out.experimental_compile(max_in_flight=2)
    xs = [torch.full((256,), float(i + 1)) for i in range(4)]
    try:
        futs = [compiled.execute(x, timeout=GET_S) for x in xs[:2]]
        assert torch.equal(futs[1].get(timeout=GET_S), xs[1] * 2.0)
        first = futs[0].get(timeout=GET_S)
        futs += [compiled.execute(x, timeout=GET_S) for x in xs[2:]]
        assert torch.equal(futs[3].get(timeout=GET_S), xs[3] * 2.0)
        assert torch.equal(futs[2].get(timeout=GET_S), xs[2] * 2.0)
        assert torch.equal(first, xs[0] * 2.0), first[:4]
        assert first is futs[0].get(timeout=GET_S)
    finally:
        compiled.teardown()


# the cases in three tests: under xdist each test of this module may start
# the module's runtime in another worker, so few tests start few runtimes
GROUPS = {
    "eager_and_pipelines": [case_eager_execute, case_function_node,
                            case_compiled_pipeline, case_compiled_fan_in,
                            case_pipelined_fifo_and_out_of_order_get,
                            case_pipeline_overlaps_stages,
                            case_concurrent_producers_fifo],
    "errors_and_lifecycle": [case_error_propagates,
                             case_error_isolation_under_pipelining,
                             case_backpressure_error, case_execute_async,
                             case_teardown_unlinks_channels_and_frees_actor,
                             case_dead_stage_detected],
    "tensor_edges": [case_tensor_edges,
                     case_future_tensor_survives_later_invocations],
}


def test_groups_hold_every_case():
    cases = {fn for name, fn in globals().items() if name.startswith("case_")}
    grouped = [fn for fns in GROUPS.values() for fn in fns]
    assert sorted(grouped, key=id) == sorted(cases, key=id)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_runtime_cases(runtime, group):
    for case in GROUPS[group]:
        actors = _Actors()
        try:
            case(actors)
        except BaseException as e:
            raise AssertionError(f"{case.__name__} failed: {e!r}") from e
        finally:
            actors.kill()


# -- _compile's validation, without a runtime ---------------------------------

class _NoActor:
    """Stands in for an actor handle: compilation fails before it would
    start an exec loop."""


def _graph(mod, kind):
    a = _NoActor()
    inp = mod.InputNode()
    if kind == "two_input_nodes":
        return mod.ClassMethodNode(a, "f", (inp, mod.InputNode()), {})
    if kind == "function_node":
        return mod.ClassMethodNode(
            a, "f", (mod.FunctionNode(object(), (inp,), {}),), {})
    if kind == "kwargs_bind":
        return mod.ClassMethodNode(a, "f", (inp,), {"y": inp})
    if kind == "stage_without_upstream":
        return mod.ClassMethodNode(
            a, "g", (mod.ClassMethodNode(a, "f", (1,), {}), inp), {})
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["two_input_nodes", "function_node",
                                  "kwargs_bind", "stage_without_upstream"])
def test_compile_rejects_what_the_reference_rejects(kind):
    with pytest.raises(Exception) as want:
        ref_dag.CompiledDAG(_graph(ref_dag, kind))
    with pytest.raises(Exception) as got:
        dag.CompiledDAG(_graph(dag, kind))
    assert type(got.value) is type(want.value)
    assert _no_addresses(got.value) == _no_addresses(want.value)
    # the reference raises the kwargs error after making its channels:
    # collecting its half-built DAG unlinks them
    del want
    gc.collect()


def _no_addresses(err):
    return re.sub(r" at 0x[0-9a-f]+", "", str(err))


def test_compile_rejects_max_in_flight_below_one():
    with pytest.raises(ValueError, match="max_in_flight"):
        dag.CompiledDAG(_graph(dag, "kwargs_bind"), max_in_flight=0)


def test_default_max_in_flight_is_the_reference_knob(monkeypatch):
    from ray_tpu import config as ref_config
    from ray_tpu_torch import config

    assert config.get("dag_max_in_flight") == ref_config.get(
        "dag_max_in_flight") == 8
    monkeypatch.setenv("RTPU_DAG_MAX_IN_FLIGHT", "3")
    assert config.get("dag_max_in_flight") == ref_config.get(
        "dag_max_in_flight") == 3
