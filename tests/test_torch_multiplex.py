"""Multi-model serving in the port on the CPU, held against the JAX
package's ``ray_tpu/serve/multiplex.py``: the ``ModelRegistry`` (the same
register / pin / ensure / unpin sequences give equal ``snapshot()`` dicts
and the same sheds), the ``MultiplexedLLMDeployment`` (float32 llama-debug
and gemma-debug, the weights carried by ``models.params_from_jax`` and the
deltas by ``models.delta_from_jax``: per-model greedy tokens and the
lazy-paging counters equal the reference's; pins; ``load_state``'s keys),
``SpeculativeLLMDeployment`` against the plain engine, and a replica
through the runtime (the handle's ``model_id`` routing, and ``close``
mid-swap freeing every weight object in the store).

The runtime tests share one runtime (64 MB store, 16 MB prefaulted, one
prestarted worker).
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import models as JM
from ray_tpu.serve import admission as jax_admission
from ray_tpu.serve.multiplex import ModelRegistry as JaxRegistry
from ray_tpu.serve.multiplex import MultiplexedLLMDeployment as JaxMux
from ray_tpu_torch import models as TM
from ray_tpu_torch import serve
from ray_tpu_torch.serve import (LLMDeployment, ModelRegistry,
                                 MultiplexedLLMDeployment, RequestShedError,
                                 SpeculativeLLMDeployment)

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
ENGINE_KW = dict(max_slots=2, max_len=64, block_size=4, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _f32(mod, name="llama-debug"):
    # f32: greedy parity (bf16 debug models have exact top-2 logit ties)
    return mod.get_config(name).replace(dtype="float32",
                                        param_dtype="float32")


def _weights(name="llama-debug", seed=0):
    return JM.init_params(jax.random.PRNGKey(seed), _f32(JM, name))


def _delta(name="llama-debug", seed=9, scale=0.1, rank=2):
    return JM.make_delta(jax.random.PRNGKey(seed), _f32(JM, name),
                         rank=rank, scale=scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _consume(gen):
    return [t for t in gen]


# ---------------------------------------------------------------------------
# the registry: the same calls through both packages
# ---------------------------------------------------------------------------

def _run_ops(reg, ops):
    """Apply ``ops`` to a registry; after each, the snapshot, or the error
    (its type name and shed reason)."""
    seen = []
    for op, *args in ops:
        try:
            getattr(reg, op)(*args)
            seen.append((op, args, reg.snapshot()))
        except (RuntimeError, KeyError) as e:
            seen.append((op, args, type(e).__name__,
                         getattr(e, "reason", None)))
    return seen


def _registries(budget, specs):
    """A reference and a port registry with the same models: ``specs`` maps
    id to ``("full", seed)`` or ``("delta", base, seed, scale)``."""
    jreg, treg = JaxRegistry(budget_bytes=budget), \
        ModelRegistry(budget_bytes=budget, device="cpu")
    for mid, spec in specs.items():
        if spec[0] == "full":
            jp = _weights(seed=spec[1])
            jreg.register(mid, _f32(JM), params=jp)
            treg.register(mid, _f32(TM),
                          params=TM.params_from_jax(_np(jp), device="cpu"))
        else:
            _, base, seed, scale = spec
            jd = _delta(seed=seed, scale=scale)
            jreg.register(mid, base=base, delta=jd)
            treg.register(mid, base=base,
                          delta=TM.delta_from_jax(_np(jd), device="cpu"))
    return jreg, treg


def _one_model_bytes():
    return JM.params_bytes(_weights())


VARIANTS = {"m0": ("full", 0), "v1": ("delta", "m0", 1, 0.1),
            "v2": ("delta", "m0", 2, 0.1), "z": ("delta", "m0", 3, 0.0)}


def _requests(order):
    return [op for mid in order
            for op in (("pin", mid), ("ensure_resident", mid),
                       ("unpin", mid))]


SEQUENCES = {
    # tests/test_serve_multiplex.py's LRU case: one model fits; a pinned
    # model is never evicted, so the other sheds until it is unpinned
    "lru_pins": (lambda: _one_model_bytes() + 1,
                 {"m0": ("full", 0), "m1": ("full", 1)},
                 [("ensure_resident", "m0"), ("pin", "m0"),
                  ("ensure_resident", "m1"), ("unpin", "m0"),
                  ("ensure_resident", "m1"), ("ensure_resident", "m0"),
                  ("unpin", "m0"), ("ensure_resident", "m7")]),
    # the card's multiplex phase: base + one variant fit; requests m0, v1,
    # v2, v1; then z while v1 and v2 are pinned (a shed), then after
    "deltas_budget": (None, VARIANTS,
                      _requests(["m0", "v1", "v2", "v1"])
                      + [("pin", "v1"), ("pin", "v2"), ("pin", "z"),
                         ("ensure_resident", "z"), ("unpin", "z"),
                         ("unpin", "v1"), ("unpin", "v2")]
                      + _requests(["z", "m0"])),
    "unbounded": (lambda: 0, VARIANTS, _requests(["v2", "m0", "z", "v1"])),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_registry_sequences_match_reference(case):
    budget_fn, specs, ops = SEQUENCES[case]
    if budget_fn is None:
        # the base plus one variant, as the reference charges them
        probe, _ = _registries(0, {k: specs[k] for k in ("m0", "v1")})
        snap = probe.snapshot()
        budget = snap["m0"]["bytes"] + snap["v1"]["bytes"]
    else:
        budget = budget_fn()
    jreg, treg = _registries(budget, specs)
    assert treg.snapshot() == jreg.snapshot()
    want, got = _run_ops(jreg, ops), _run_ops(treg, ops)
    assert got == want
    sheds = [s for s in got if len(s) == 4 and s[2] == "RequestShedError"]
    if case != "unbounded":
        assert sheds and all(s[3] == "model_budget" for s in sheds)


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_swap_prediction_matches_the_reference_registry():
    """``chip_smoke._lru_swaps`` (the smoke's statement of the budget's
    policy, which its multiplex phase is held to) against the reference's
    ``ModelRegistry`` on the phase's own sequence: the order one at a time,
    z while v1 and v2 are pinned, then each model's workload."""
    smoke = _smoke()
    jreg, _ = _registries(0, VARIANTS)
    sizes = {m: r["bytes"] for m, r in jreg.snapshot().items()}
    budget = sizes["m0"] + sizes["v1"]
    jreg.budget_bytes = budget
    ops = [op for mid in smoke.MUX_ORDER
           for _ in range(smoke.MUX_SEQ_PROMPTS)
           for op in smoke._request_ops(mid)]
    ops += [("pin", "v1"), ("ensure", "v1"), ("pin", "v2"),
            ("ensure", "v2"), ("pin", "z"), ("ensure", "z"), ("unpin", "z"),
            ("unpin", "v1"), ("unpin", "v2")]
    for mid in ("z", "m0", "v1", "v2"):
        ops += smoke._request_ops(mid)
    sheds = []
    for op, mid in ops:
        try:
            getattr(jreg, {"ensure": "ensure_resident"}.get(op, op))(mid)
        except jax_admission.RequestShedError:
            sheds.append(mid)
    counts, want_sheds, resident = smoke._lru_swaps(
        ops, sizes, budget, {m: "m0" for m in ("v1", "v2", "z")})
    snap = jreg.snapshot()
    assert counts == {m: [r["swaps_in"], r["swaps_out"]]
                      for m, r in snap.items()}
    assert want_sheds == sheds == ["z"]
    assert resident == {m for m, r in snap.items() if r["resident"]}
    assert counts["m0"] == [4, 3]     # the base moves four times


def test_registry_shed_is_the_port_admission_error():
    treg = ModelRegistry(budget_bytes=1, device="cpu")
    treg.register("m0", _f32(TM), seed=0)
    treg.register("m1", _f32(TM), seed=1)
    with pytest.raises(RequestShedError) as e:
        treg.ensure_resident("m0")
    assert e.value.reason == "model_budget"
    # the reference's type for the same shed is its own
    jreg = JaxRegistry(budget_bytes=1)
    jreg.register("m0", _f32(JM), seed=0)
    with pytest.raises(jax_admission.RequestShedError):
        jreg.ensure_resident("m0")


def test_registry_register_validation():
    reg = ModelRegistry(budget_bytes=0, device="cpu")
    cfg = _f32(TM)
    reg.register("m0", cfg)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m0", cfg)
    with pytest.raises(ValueError, match="needs a config"):
        reg.register("m1")
    with pytest.raises(ValueError, match="not registered"):
        reg.register("v0", base="nope", delta={"targets": {}})
    with pytest.raises(ValueError, match="no delta"):
        reg.register("v0", base="m0")
    assert "m0" in reg and reg.models() == ["m0"]


def test_registry_evict_cb_reacquire_and_shared_leaves():
    """Eviction fires the bound drop hook and ``ensure_resident`` hands back
    fresh params; a variant's untouched leaves are the resident base's own
    tensors, and its rebuilt ones equal ``apply_delta``'s."""
    reg = ModelRegistry(budget_bytes=_one_model_bytes() + 1, device="cpu")
    reg.register("m0", _f32(TM), seed=0)
    reg.register("m1", _f32(TM), seed=1)
    dropped = []
    reg.bind("m0", lambda: dropped.append("m0"))
    p0 = reg.ensure_resident("m0")
    reg.ensure_resident("m1")
    assert dropped == ["m0"]
    p0b = reg.ensure_resident("m0")
    assert p0b is not p0 and p0b["embed"] is not p0["embed"]
    assert torch.equal(p0["embed"], p0b["embed"])

    reg = ModelRegistry(budget_bytes=0, device="cpu")
    base = TM.params_from_jax(_np(_weights()), device="cpu")
    delta = TM.delta_from_jax(_np(_delta()), device="cpu")
    reg.register("base", _f32(TM), params=base)
    reg.register("tuned", base="base", delta=delta)
    got = reg.ensure_resident("tuned")
    bp = reg.ensure_resident("base")
    want = TM.apply_delta(bp, delta)
    for leaf in ("wq", "wv"):
        assert torch.equal(got["layers"][leaf], want["layers"][leaf])
    assert got["layers"]["wk"] is bp["layers"]["wk"]
    assert got["embed"] is bp["embed"]
    # the registry holds its own host copy, not the caller's tensors
    assert reg._entries["base"]["host"]["embed"] is not base["embed"]


# ---------------------------------------------------------------------------
# the multiplexed deployment against the reference's
# ---------------------------------------------------------------------------

def _mux_pair(budget_fn):
    """The reference and the port's multiplexed deployments over the same
    weights: llama-debug m0 and its variant v1, gemma-debug g0."""
    jp, gp, jd = _weights(), _weights("gemma-debug", 5), _delta()
    jspec = {"m0": {"config": _f32(JM), "params": jp},
             "v1": {"base": "m0", "delta": jd},
             "g0": {"config": _f32(JM, "gemma-debug"), "params": gp}}
    tspec = {"m0": {"config": _f32(TM),
                    "params": TM.params_from_jax(_np(jp), device="cpu")},
             "v1": {"base": "m0",
                    "delta": TM.delta_from_jax(_np(jd), device="cpu")},
             "g0": {"config": _f32(TM, "gemma-debug"),
                    "params": TM.params_from_jax(_np(gp), device="cpu")}}
    budget = budget_fn(JM.params_bytes(jp), JM.params_bytes(gp))
    return (JaxMux(jspec, budget_bytes=budget, **ENGINE_KW),
            MultiplexedLLMDeployment(tspec, budget_bytes=budget,
                                     device="cpu", **ENGINE_KW))


def test_multiplexed_tokens_and_paging_match_reference():
    """Requests to m0, v1, g0, m0, v1 (one at a time) under a budget that
    holds llama-debug and its variant but not gemma-debug beside them:
    each model's tokens, the engines created, and the registry's snapshot
    after every request equal the reference's."""
    ref, dep = _mux_pair(lambda lb, gb: lb + gb // 2)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, 9).tolist()
    try:
        assert dep._deps == {}
        for mid in ("m0", "v1", "g0", "m0", "v1"):
            want = _consume(ref(prompt, 8, model_id=mid))
            got = _consume(dep(prompt, 8, model_id=mid))
            assert got == want, mid
            assert dep.registry.snapshot() == ref.registry.snapshot(), mid
            assert sorted(dep._deps) == sorted(ref._deps)
        snap = dep.registry.snapshot()
        assert snap["g0"]["swaps_in"] == 1 and snap["m0"]["swaps_out"] >= 1
        # the variant moved the tokens (else the test could not tell)
        assert _consume(dep(prompt, 8, model_id="v1")) != \
            _consume(dep(prompt, 8, model_id="m0"))
        with pytest.raises(ValueError, match="unknown model_id"):
            dep(prompt, 4, model_id="m7")
        # the default model is the first registered
        assert _consume(dep(prompt, 8)) == _consume(ref(prompt, 8))
        dep.check_health()
    finally:
        ref.close()
        dep.close()
    assert all(not rec["resident"]
               for rec in dep.registry.snapshot().values())


def test_load_state_keys_match_reference():
    ref, dep = _mux_pair(lambda lb, gb: 0)
    prompt = [7] * 12
    try:
        for d in (ref, dep):
            for _ in range(2):  # the repeat seeds the trie
                _consume(d(prompt, 4, model_id="m0"))
        want, got = ref.load_state(), dep.load_state()
        assert sorted(got) == sorted(want)
        assert got["models"] == want["models"]
        assert got["models"]["m0"]["state"] == "hbm"
        assert got["models"]["g0"]["state"] == "host"
        for key in ("inflight", "kv_free", "kv_total", "role", "queued",
                    "max_slots", "block_size"):
            assert got[key] == want[key], key
        assert [tuple(x) for x in got["prefix_digest"]] == \
            [tuple(x) for x in want["prefix_digest"]]
        assert got["prefix_digest"]
        assert sorted(dep.stats()) == sorted(ref.stats())
    finally:
        ref.close()
        dep.close()


def test_pin_survives_the_stream_and_is_released_on_error_and_close():
    dep = MultiplexedLLMDeployment({"m0": _f32(TM)}, device="cpu",
                                   **ENGINE_KW)
    try:
        gen = dep([1, 2, 3], 6, model_id="m0")
        assert isinstance(next(gen), int)
        assert dep.registry.snapshot()["m0"]["pins"] == 1
        _consume(gen)
        assert dep.registry.snapshot()["m0"]["pins"] == 0
        gen2 = dep([1, 2, 3], 6)
        next(gen2)
        gen2.close()          # an abandoned stream unpins too
        assert dep.registry.snapshot()["m0"]["pins"] == 0
        with pytest.raises(ValueError, match="max_len"):
            _consume(dep([1] * 70, 6))  # the engine refuses it
        assert dep.registry.snapshot()["m0"]["pins"] == 0
    finally:
        dep.close()


def test_close_drops_params_and_graph_programs():
    dep = MultiplexedLLMDeployment({"m0": _f32(TM)}, device="cpu",
                                   **ENGINE_KW)
    _consume(dep([1, 2, 3], 4))
    eng = dep._deps["m0"].engine
    dep.close()
    assert eng.params is None and not dep._deps
    assert not dep._deps and not dep.registry.snapshot()["m0"]["resident"]


def test_speculative_deployment_matches_the_plain_engine():
    """Held against the plain engine on the same weights (not against the
    reference's red ngram-parity test): repetitive prompts, where drafts
    land, and random ones."""
    cfg = _f32(TM)
    params = TM.params_from_jax(_np(_weights()), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2], rng.integers(0, 256, 7).tolist()]
    kw = dict(params=params, max_len=96, block_size=4, prefill_chunk=8,
              max_slots=2, device="cpu")
    plain = LLMDeployment(cfg, **kw)
    try:
        want = [_consume(plain(p, 16)) for p in prompts]
    finally:
        plain.close()
    for drafter, extra in (("ngram", {}), ("model", {"draft_seed": 5})):
        spec = SpeculativeLLMDeployment(cfg, drafter=drafter, spec_k=3,
                                        spec_accept_floor=0.0, **extra, **kw)
        try:
            assert [_consume(spec(p, 16)) for p in prompts] == want, drafter
            assert spec.engine.stats["spec_proposed"] > 0
        finally:
            spec.close()
    mux = MultiplexedLLMDeployment({"m0": {"config": cfg, "params": params}},
                                   speculative=True, spec_k=4,
                                   spec_accept_floor=0.0, device="cpu",
                                   max_slots=2, max_len=96, block_size=4,
                                   prefill_chunk=8)
    try:
        assert [_consume(mux(p, 16)) for p in prompts] == want
        assert mux._deps["m0"].engine.stats["spec_proposed"] > 0
    finally:
        mux.close()


# ---------------------------------------------------------------------------
# through the runtime
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    rt.init(num_cpus=8, runtime_env={"env_vars": {"OMP_NUM_THREADS": "1"}})
    yield
    serve.shutdown()
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_replica_routes_model_id_and_reports_residency(runtime):
    """``serve.run`` of a multiplexed replica whose weights are drawn in the
    replica from seeds; streams through ``handle.options(model_id=...)``
    equal an in-process deployment's on the same spec, and the replica's
    ``load_state()["models"]`` shows what the requests left resident."""
    spec = {"m0": {"config": _f32(TM), "seed": 0},
            "m1": {"config": _f32(TM), "seed": 1}}
    budget = TM.params_bytes(TM.init_params(
        torch.Generator().manual_seed(0), _f32(TM), device="cpu")) + 1
    kw = dict(budget_bytes=budget, device="cpu", **ENGINE_KW)
    app = serve.deployment(
        MultiplexedLLMDeployment, name="mux",
        ray_actor_options={"max_concurrency": 8, "num_cpus": 0},
    ).bind(spec, **kw)
    handle = serve.run(app, name="mux")
    local = MultiplexedLLMDeployment(spec, **kw)
    prompt = [3, 1, 4, 1, 5, 9, 2]
    try:
        for mid in ("m0", "m1", "m0"):
            got = list(handle.options(stream=True, model_id=mid).remote(
                prompt, 6))
            assert got == _consume(local(prompt, 6, model_id=mid)), mid
        ls = handle.options(method_name="load_state",
                            stream=False).remote().result()
        assert ls["models"] == local.load_state()["models"]
        assert ls["models"]["m0"]["state"] == "hbm"
        assert ls["models"]["m1"] == {"state": "host", "inflight": 0,
                                      "swaps_in": 1, "swaps_out": 1}
        assert ls["actor"] is not None
    finally:
        local.close()
        serve.delete("mux")


def test_close_mid_swap_frees_every_store_ref(runtime):
    """The reference's chaos case in process: weights in the store (real
    refs), one stream in flight on m0 pins it while a request for m1
    sheds, then ``close`` lands mid-stream. Afterwards every weight object
    has left the store and nothing stays resident."""
    from ray_tpu_torch.core.runtime import _get_runtime
    from ray_tpu_torch.util.state import object_store_tier

    cfg = _f32(TM)
    dep = MultiplexedLLMDeployment(
        {"m0": {"config": cfg, "seed": 0}, "m1": {"config": cfg, "seed": 1}},
        budget_bytes=_one_model_bytes() + 1, device="cpu", **ENGINE_KW)
    refs = [e["ref"] for e in dep.registry._entries.values()]
    assert all(r is not None for r in refs)
    assert all(object_store_tier(r) == "shm" for r in refs)
    assert all(e["host"] is None for e in dep.registry._entries.values())

    gen = dep([1, 2, 3, 4], 8, model_id="m0")
    assert isinstance(next(gen), int)
    shed = []

    def hit_m1():
        try:
            _consume(dep([5, 6, 7], 4, model_id="m1"))
        except RequestShedError as e:
            shed.append(e.reason)

    t = threading.Thread(target=hit_m1)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and shed == ["model_budget"]
    assert dep.registry.snapshot()["m0"]["resident"]
    next(gen)
    dep.close()
    assert dep.registry.snapshot()["m0"]["pins"] == 1  # the stream is open
    assert all(not rec["resident"]
               for rec in dep.registry.snapshot().values())
    store = _get_runtime().store
    if store._arena is not None:
        assert all(not store._arena.contains(r.id.binary()) for r in refs)
    gen.close()
    del gen, dep
    import gc

    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        gc.collect()
        for r in refs:
            store.release(r.id)
        if all(object_store_tier(r) == "unknown" for r in refs):
            break
        time.sleep(0.1)
    assert all(object_store_tier(r) == "unknown" for r in refs)
