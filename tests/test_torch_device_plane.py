"""The port's device plane on the CPU (twin of the registry half of
``tests/test_device_plane.py``): program rows, abstract signatures and the
diff a new signature records, the kill switch, version-gated snapshots, the
live-tensor census and the eager dispatcher hook. Off the card a registered
program runs eagerly and keeps the same rows as a captured one. The compile
telemetry (metrics, the ``jit_recompile`` event, the ``device::compile``
span) is held against the JAX package's ``registered_jit`` on the same
sequence of signatures, by the reference's own counts."""

import os

import numpy as np
import pytest
import torch

from ray_tpu_torch import models
from ray_tpu_torch.serve import LLMEngine
from ray_tpu_torch.util import device_plane


@pytest.fixture
def plane(monkeypatch):
    """A fresh registry with the env arming restored after."""
    monkeypatch.delenv("RTPU_DEVICE_PLANE", raising=False)
    device_plane._reset_for_tests()
    yield device_plane
    monkeypatch.delenv("RTPU_DEVICE_PLANE", raising=False)
    device_plane._reset_for_tests()


def test_plane_on_by_default_and_kill_switch(plane, monkeypatch):
    assert device_plane.device_plane_enabled()  # no env -> ON
    monkeypatch.setenv("RTPU_DEVICE_PLANE", "0")
    device_plane._reset_for_tests()
    assert not device_plane.device_plane_enabled()
    f = device_plane.registered_graph(lambda x: x * 2.0, name="off::f")
    assert float(f(torch.tensor(3.0))) == 6.0  # pure passthrough
    assert device_plane.registry().rows() == []
    assert device_plane.snapshot(min_version=0) is None


def test_kill_switch_keeps_the_engine_stepping(plane, monkeypatch):
    """RTPU_DEVICE_PLANE=0 turns off the accounting only: the engine's
    programs still run (and, on the card, are still captured), the tokens
    are the same, and no row is kept."""
    cfg = models.llama_debug().replace(dtype="float32", param_dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7]]

    def run():
        eng = LLMEngine(cfg, params, max_slots=2, max_len=32, block_size=4,
                        prefill_chunk=4, device="cpu")
        sinks = [[], []]
        for p, s in zip(prompts, sinks):
            eng.submit(p, 5, s.append)
        while eng.step():
            pass
        return eng, sinks

    on, want = run()
    assert {r["program"] for r in device_plane.registry().rows()} >= {
        "serve::decode_step_paged", "serve::copy_kv_block"}
    assert on.stats["flops_per_s"] > 0
    monkeypatch.setenv("RTPU_DEVICE_PLANE", "0")
    device_plane._reset_for_tests()
    off, got = run()
    assert got == want and all(s[-1] is None and len(s) == 6 for s in got)
    assert device_plane.registry().rows() == []
    assert "flops_per_s" not in off.stats


def test_registered_graph_records_signature_flops_and_fixed_args(plane):
    f = device_plane.registered_graph(
        lambda a, b: a @ b, name="test::mm", component="test", steps=4,
        fixed_argnums=(0,))
    out = f(torch.ones(32, 32), torch.ones(32, 32))
    assert torch.equal(out, torch.full((32, 32), 32.0))
    f(torch.ones(32, 32), torch.ones(32, 32))  # a known signature: a call

    row = device_plane.registry().program("test::mm")
    assert row["compiles"] == 1 and row["retraces"] == 0
    assert row["calls"] == 2
    assert row["component"] == "test"
    assert row["donate"] == [0]
    assert row["compile_s_total"] > 0
    assert row["sigs"] == [{"args[0]": "float32[32,32]",
                            "args[1]": "float32[32,32]"}]
    assert row["diffs"] == []
    # FlopCounterMode: a 32^3 matmul is 2 * 32^3 = 65536 flops
    assert row["cost"] == {"flops": 65536.0}
    # steps=4 declares a 4-step program: per-step flops divide by 4
    assert device_plane.program_flops_per_step("test::mm") == 65536.0 / 4


def test_new_signature_records_a_retrace_with_its_exact_diff(plane):
    f = device_plane.registered_graph(lambda x: (x * 2.0).sum(),
                                      name="test::double", component="test")
    f(torch.zeros(4, 8))
    f(torch.zeros(4, 8))                      # warm call
    f(torch.zeros(8, 8))                      # planted retrace
    row = device_plane.registry().program("test::double")
    assert row["compiles"] == 2 and row["retraces"] == 1
    assert row["calls"] == 3
    assert row["diffs"] == [{"changed": {"args[0]": {
        "was": "float32[4,8]", "now": "float32[8,8]"}}}]
    # dtype and nesting are part of the signature too
    g = device_plane.registered_graph(lambda d: d["x"].sum(),
                                      name="test::tree")
    g({"x": torch.zeros(3, dtype=torch.int64)})
    g({"x": torch.zeros(3, dtype=torch.bfloat16)})
    assert device_plane.registry().program("test::tree")["diffs"] == [
        {"changed": {"args[0]['x']": {"was": "int64[3]",
                                      "now": "bfloat16[3]"}}}]


def test_python_value_retrace_diff_names_the_value(plane):
    f = device_plane.registered_graph(
        lambda x, flag: x + 1 if flag else x - 1, name="test::static",
        component="test")
    f(torch.zeros(4), flag=True)
    f(torch.zeros(4), flag=False)
    row = device_plane.registry().program("test::static")
    assert row["diffs"][0]["changed"] == {
        "kwargs['flag']": {"was": "py:bool:True", "now": "py:bool:False"}}


def test_sig_history_bounded_and_known_sig_not_a_retrace(plane):
    f = device_plane.registered_graph(lambda x: x.sum(), name="test::hist")
    for n in range(device_plane.MAX_SIGS + 4):
        f(torch.zeros(n + 1))
    row = device_plane.registry().program("test::hist")
    assert row["compiles"] == device_plane.MAX_SIGS + 4
    assert row["retraces"] == device_plane.MAX_SIGS + 3
    assert len(row["sigs"]) == device_plane.MAX_SIGS  # bounded history
    assert len(row["diffs"]) == device_plane.MAX_SIGS
    # a signature already run is a plain call, not a retrace
    f(torch.zeros(2))
    row = device_plane.registry().program("test::hist")
    assert row["retraces"] == device_plane.MAX_SIGS + 3
    assert row["calls"] == device_plane.MAX_SIGS + 5


def test_signature_diff_unit():
    old = {"a": "float32[4]", "b": "int32[2]", "gone": "float32[1]"}
    new = {"a": "float32[8]", "b": "int32[2]", "fresh": "bool[3]"}
    assert device_plane.signature_diff(old, new) == {
        "changed": {"a": {"was": "float32[4]", "now": "float32[8]"}},
        "added": {"fresh": "bool[3]"},
        "removed": {"gone": "float32[1]"},
    }
    assert device_plane.signature_diff({"a": "x"}, {"a": "x"}) == {}
    assert device_plane.abstract_signature(
        (torch.zeros(2, 3), {"k": torch.ones(1, dtype=torch.bool)}, None, 7),
        {"mode": "fast"}) == {
        "args[0]": "float32[2,3]", "args[1]['k']": "bool[1]",
        "args[3]": "py:int:7", "kwargs['mode']": "py:str:'fast'"}


def test_snapshot_version_gating(plane):
    # an empty registry never ships
    assert device_plane.snapshot(min_version=0) is None

    f = device_plane.registered_graph(lambda x: x + 1, name="test::snap")
    f(torch.zeros(4))
    snap = device_plane.snapshot(min_version=0)
    assert snap is not None and snap["version"] > 0
    assert snap["pid"] == os.getpid()
    assert [r["program"] for r in snap["programs"]] == ["test::snap"]
    assert "hbm" not in snap          # no CUDA in this process

    # nothing changed since: gated off; warm calls do not bump it either
    assert device_plane.snapshot(min_version=snap["version"]) is None
    f(torch.zeros(4))
    assert device_plane.snapshot(min_version=snap["version"]) is None
    # a new signature bumps it past the cursor again
    f(torch.zeros(8))
    assert device_plane.snapshot(min_version=snap["version"]) is not None


def test_live_buffer_census_groups_by_shape_dtype_device(plane):
    held = [torch.ones(1031, 257) for _ in range(3)]
    views = [t[:10] for t in held]            # views are not counted apart
    census = device_plane.live_buffer_census()
    assert census["buffers"] >= 3
    mine = [g for g in census["groups"]
            if g["shape"] == [1031, 257] and g["dtype"] == "float32"]
    assert mine, "held tensors missing from the census groups"
    assert mine[0]["device"] == "cpu"
    assert mine[0]["count"] >= 3
    assert mine[0]["bytes"] >= 3 * 1031 * 257 * 4
    assert not [g for g in census["groups"] if g["shape"] == [10, 257]
                and g["count"] >= 3]
    assert census["bytes"] >= mine[0]["bytes"]
    snap = device_plane.snapshot(census=True)
    assert snap["live_buffers"]["buffers"] >= 3
    del held, views


def test_tracked_call_registers_novel_signatures_only(plane):
    calls = {"n": 0}

    def run():
        calls["n"] += 1
        return calls["n"]

    args = (torch.zeros(2, 4, 8, 16),)
    assert device_plane.tracked_call("test::eager", "ops", run, args,
                                     statics={"impl": "naive"}) == 1
    assert device_plane.tracked_call("test::eager", "ops", run, args,
                                     statics={"impl": "naive"}) == 2
    row = device_plane.registry().program("test::eager")
    assert row["compiles"] == 1 and row["calls"] == 2
    # a novel STATIC counts as a fresh compile (and a retrace)
    device_plane.tracked_call("test::eager", "ops", run, args,
                              statics={"impl": "blockwise"})
    row = device_plane.registry().program("test::eager")
    assert row["compiles"] == 2 and row["retraces"] == 1


def test_engine_programs_registered_under_the_reference_names(plane):
    """The paged engine registers its programs under the reference's
    names; a second engine folds into the same rows, and a known signature
    is no retrace."""
    cfg = models.llama_debug().replace(dtype="float32", param_dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    for _ in range(2):
        eng = LLMEngine(cfg, params, max_slots=2, max_len=32, block_size=4,
                        prefill_chunk=4, device="cpu")
        eng.submit(np.arange(6), 3, lambda t: None)
        while eng.step():
            pass
    rows = {r["program"]: r for r in device_plane.registry().rows()}
    step = rows["serve::decode_step_paged"]
    assert step["component"] == "serve"
    assert step["compiles"] == 2 and step["retraces"] == 0
    assert step["calls"] == 2 * eng.stats["steps"]
    assert sorted(step["sigs"][0]) == sorted(
        [f"args[0][{k!r}]" for k in params if k != "layers"]
        + [f"args[0]['layers'][{k!r}]" for k in params["layers"]]
        + ["args[1]['k']", "args[1]['v']"]
        + [f"args[{i}]" for i in range(2, 7)])
    assert step["sigs"][0]["args[2]"] == "int64[2,4]"
    assert step["cost"]["flops"] > 0
    assert rows["serve::copy_kv_block"]["calls"] >= 2   # warmed at init


# ---------------------------------------------------------------------------
# compile telemetry: metrics, the jit_recompile event, the compile span
# ---------------------------------------------------------------------------

def _compile_metrics(md, program):
    """(compiles, retraces, compile-seconds observations) of ``program``
    in a package's metric registry."""
    key = (("program", program),)

    def counter(name):
        return dict(md.get(name)._samples()).get(key, 0.0)
    hist = dict(md.get("rtpu_jit_compile_seconds")._samples())
    return (counter("rtpu_jit_compiles_total"),
            counter("rtpu_jit_retraces_total"),
            hist[key][2] if key in hist else 0)


@pytest.fixture
def telemetry(plane):
    """Both packages' event rings drained before and after."""
    import jax  # noqa: F401 - the reference below runs on the CPU

    from ray_tpu.util import events as jax_events
    from ray_tpu_torch.util import events

    events.drain_ring()
    jax_events.drain_ring()
    yield events, jax_events
    events.drain_ring()
    jax_events.drain_ring()


def test_compile_telemetry_matches_the_reference(telemetry):
    """The same calls (a signature, its repeat, a new one) through the
    reference's ``registered_jit`` and the port's ``registered_graph``: the
    same compile, retrace and compile-seconds counts, and one
    ``jit_recompile`` event each, with the same diff."""
    import jax.numpy as jnp

    from ray_tpu.util import device_plane as jax_plane
    from ray_tpu.util import metric_defs as jax_md
    from ray_tpu_torch.util import metric_defs as md

    events, jax_events = telemetry
    name = "test::telemetry"
    jf = jax_plane.registered_jit(lambda x: (x * 2.0).sum(), name=name,
                                  component="test")
    tf = device_plane.registered_graph(lambda x: (x * 2.0).sum(), name=name,
                                       component="test")
    j0, t0 = _compile_metrics(jax_md, name), _compile_metrics(md, name)
    for shape in ((4, 8), (4, 8), (8, 8)):
        jf(jnp.zeros(shape))
        tf(torch.zeros(shape))
    j1, t1 = _compile_metrics(jax_md, name), _compile_metrics(md, name)
    jd = tuple(b - a for a, b in zip(j0, j1))
    td = tuple(b - a for a, b in zip(t0, t1))
    assert td == jd == (2, 1, 2)
    want = [e for e in jax_events.drain_ring() if e["name"] == "jit_recompile"]
    got = [e for e in events.drain_ring() if e["name"] == "jit_recompile"]
    assert len(got) == len(want) == 1
    assert got[0]["diff"] == want[0]["diff"] == {"changed": {"args[0]": {
        "was": "float32[4,8]", "now": "float32[8,8]"}}}
    assert got[0]["program"] == name and got[0]["component"] == "test"
    assert got[0]["severity"] == want[0]["severity"] == "warning"


def test_recapture_after_reset_is_a_compile_not_a_retrace(telemetry):
    """``reset()`` (a param swap on the card: a graph holds addresses) makes
    the next call of a known signature compile again; it is no retrace and
    emits no event."""
    from ray_tpu_torch.util import metric_defs as md

    events, _ = telemetry
    name = "test::reset"
    f = device_plane.registered_graph(lambda x: x + 1, name=name)
    before = _compile_metrics(md, name)
    f(torch.zeros(3))
    f.reset()
    f(torch.zeros(3))
    f(torch.zeros(3))
    after = _compile_metrics(md, name)
    assert tuple(b - a for a, b in zip(before, after)) == (2, 0, 2)
    row = device_plane.registry().program(name)
    assert row["compiles"] == 2 and row["retraces"] == 0
    assert row["calls"] == 3
    assert not [e for e in events.drain_ring()
                if e["name"] == "jit_recompile"]


def test_compile_span_when_tracing_is_on(telemetry, monkeypatch):
    from ray_tpu_torch.util import tracing

    monkeypatch.delenv("RTPU_TRACING", raising=False)
    tracing._reset_for_tests()
    f = device_plane.registered_graph(lambda a, b: a @ b, name="test::span",
                                      component="test")
    f(torch.ones(4, 4), torch.ones(4, 4))            # tracing off: no span
    assert not [r for r in tracing.drain_ring()
                if r["name"] == "device::compile"]
    tracing.enable_tracing()
    try:
        f(torch.ones(8, 4), torch.ones(4, 4))        # a retrace
        f(torch.ones(8, 4), torch.ones(4, 4))        # a call: no span
        spans = [r for r in tracing.drain_ring()
                 if r["name"] == "device::compile"]
    finally:
        tracing.disable_tracing()
        monkeypatch.delenv("RTPU_TRACING", raising=False)
        tracing._reset_for_tests()
    assert len(spans) == 1
    attrs = spans[0]["attributes"]
    assert attrs["program"] == "test::span" and attrs["component"] == "test"
    assert attrs["retrace"] is True and attrs["flops"] == 2 * 8 * 4 * 4
    assert spans[0]["end_time_unix_nano"] >= spans[0]["start_time_unix_nano"]


def test_engine_param_swap_recaptures_without_retrace(telemetry):
    """``set_params`` / ``drop_params`` drop the step's graphs: the next step
    records its signature again as a compile, never as a retrace."""
    cfg = models.llama_debug().replace(dtype="float32", param_dtype="float32")
    params = models.init_params(torch.Generator().manual_seed(2), cfg,
                                device="cpu")
    eng = LLMEngine(cfg, params, max_slots=2, max_len=32, block_size=4,
                    prefill_chunk=4, device="cpu")
    eng.params_provider = lambda: params
    for swap in (None, eng.drop_params,
                 lambda: eng.set_params(dict(params))):
        if swap is not None:
            swap()
        eng.submit([1, 2, 3], 2, lambda t: None)
        while eng.step():
            pass
    row = device_plane.registry().program("serve::decode_step_paged")
    assert row["compiles"] == 3 and row["retraces"] == 0
    events, _ = telemetry
    assert not [e for e in events.drain_ring()
                if e["name"] == "jit_recompile"]
