"""Disaggregated prefill / decode serving in the port on the CPU, held
against the JAX package (float32 llama-debug, weights carried across with
``models.params_from_jax``):

- in process: live-session migration (``begin_migration``) on the port's
  engines against the same migration on the reference's, payload and
  tokens; a prefill and a decode ``LLMDeployment`` shipping over a ring
  in this process, token-exact, the ring unlinked at ``close``;
- the router: ``DisaggHandle``'s decode-KV shed and its decode pick make
  the reference's decisions on the same load reports;
- deployed (``serve.deploy_disagg``: one prefill and two decode replicas,
  one runtime a module with the small store): streams token-exact against
  the JAX package's in-process colocated ``LLMEngine``, no leaked block, the
  rings named for the session and swept at shutdown; a live session
  drained to the other decode replica, token-exact, with no re-prefill;
  the drain's argument errors; the prefill replica killed mid-transfer
  (``util/failpoints``), the request re-prefilled with nothing leaked; a
  payload the ring cannot take falls back to the object store.

Every blocking read, get, stream and poll has a timeout of its own.
"""

import glob
import os
import random
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from conftest import poll_until
from ray_tpu import models as JM
from ray_tpu.serve import disagg as ref_disagg
from ray_tpu.serve import handle as ref_handle
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import models as TM
from ray_tpu_torch import serve
from ray_tpu_torch.serve import disagg, kv_transfer
from ray_tpu_torch.serve.admission import RequestShedError
from ray_tpu_torch.serve.llm import LLMEngine

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
ENGINE = dict(max_slots=4, max_len=1024, block_size=8, prefill_chunk=8)
LENS = (20, 9, 31, 14)
NEW_TOKENS = 6
DRAIN_PROMPT, DRAIN_CHECKED, DRAIN_BUDGET = 20, 40, 400
STREAM_S = 60.0     # a stream's deadline: a hang fails the test


def _cfg(mod):
    return mod.get_config("llama-debug").replace(dtype="float32",
                                                 param_dtype="float32")


def _jax_tokens(eng, prompts, new_tokens):
    """Each prompt through a JAX engine, one at a time."""
    out = []
    for p in prompts:
        sink = []
        eng.submit(p, new_tokens, sink.append)
        for _ in range(5000):
            if not eng.step():
                break
        assert sink[-1] is None
        out.append(sink[:-1])
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(JM.init_params(jax.random.PRNGKey(0), _cfg(JM)))


@pytest.fixture(scope="module")
def reference(jax_params):
    """The prompts, the params as numpy, and the JAX package's colocated
    engine's tokens for each (one at a time), plus the drain's prompt and
    its first ``DRAIN_CHECKED`` tokens."""
    cfg, params = _cfg(JM), jax_params
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENS]
    drain = rng.integers(0, cfg.vocab_size, DRAIN_PROMPT).tolist()
    eng = JaxEngine(cfg, params, **ENGINE)
    want = _jax_tokens(eng, prompts, NEW_TOKENS)
    drain_want = _jax_tokens(eng, [drain], DRAIN_CHECKED)[0]
    yield dict(prompts=prompts, params=params, want=want, drain=drain,
               drain_want=drain_want, engine=eng)
    jax.clear_caches()


def _no_leak(s):
    return s["kv_free"] + s["prefix"]["nodes"] == s["kv_total"]


def _drain_engine(eng):
    for _ in range(5000):
        if not eng.step():
            return
    raise AssertionError("engine did not drain")


# -- in process ---------------------------------------------------------------

def _migrate(engines, prompt, before, total):
    """Prefill ``prompt`` on engine P, adopt it on engine D1, decode
    ``before`` tokens, migrate the live session off D1 and adopt the
    payload on D2, which decodes the rest of ``total``. Returns (tokens,
    payload)."""
    P, D1, D2 = engines
    sink = []
    P.submit(prompt, 1, sink.append, prefill_only=True)
    _drain_engine(P)
    export = sink[0]
    toks = []
    D1.adopt(prompt, export.kv, export.token, total, toks.append)
    while len(toks) < before:
        D1.step()
    (req, reply), = D1.begin_migration()
    D1.step()       # the loop services the export before it advances
    payload = reply.get(timeout=10)
    assert len(toks) == before and not D1.step()
    rest = []
    D2.adopt(payload["fed_tokens"], payload["kv"], payload["last_token"],
             payload["max_new_tokens"] - payload["generated"] + 1,
             rest.append)
    _drain_engine(D2)
    assert rest[0] == toks[-1] and rest[-1] is None
    return toks + rest[1:-1], payload


def test_engine_migration_matches_reference(reference):
    """The same live session migrated on both packages' engines: the same
    fed transcript, position, budget and cached KV (to 1e-5), and both
    continue token-exact with the colocated engine's stream."""
    prompt = reference["drain"]
    want = reference["drain_want"][:24]
    tp = TM.params_from_jax(reference["params"], device="cpu")
    engines = [LLMEngine(_cfg(TM), tp, role=role, device="cpu", **ENGINE)
               for role in ("prefill", "decode", "decode")]
    got, payload = _migrate(engines, prompt, 7, 24)
    # the reference's engine plays all three parts (each JAX engine
    # compiles its own programs); its prefix cache holds the prompt's full
    # blocks, computed in the same chunks as a fresh prefill's
    ref_got, ref_payload = _migrate([reference["engine"]] * 3, prompt, 7, 24)
    assert got == ref_got == want
    for key in ("fed_tokens", "last_token", "pos", "generated",
                "max_new_tokens", "eos", "block_size"):
        assert payload[key] == ref_payload[key], key
    assert payload["fed_tokens"] == prompt + want[:6]
    # the cached positions (a block's tail past ``pos`` is never read)
    for name in ("k", "v"):
        got_kv, ref_kv = (np.asarray(t).reshape(
            t.shape[0], -1, *t.shape[3:])[:, :payload["pos"]]
            for t in (payload["kv"][name].numpy(), ref_payload["kv"][name]))
        np.testing.assert_allclose(got_kv, ref_kv, atol=1e-5, rtol=1e-5)
    P, D1, D2 = engines
    assert (P.stats["exported"], D1.stats["adopted"],
            D1.stats["migrated_out"], D2.stats["adopted"]) == (1, 1, 1, 1)
    for eng in engines:
        assert _no_leak(eng.kv_state())


def test_migration_skips_prefilling_and_finished_sessions():
    cfg = _cfg(TM)
    eng = LLMEngine(cfg, max_slots=2, max_len=64, block_size=8,
                    prefill_chunk=4, device="cpu")
    sink = []
    eng.submit(list(range(1, 12)), 4, sink.append)
    eng.step()                       # 4 of 11 prompt tokens: prefilling
    assert eng.begin_migration() == []
    dense = LLMEngine(cfg, max_slots=2, max_len=64, paged=False,
                      device="cpu")
    with pytest.raises(ValueError, match="paged"):
        dense.begin_migration()
    while len(sink) < 2:
        eng.step()
    (req, reply), = eng.begin_migration()
    eng.cancel(req)                  # gone before the loop gets to it
    eng.step()
    assert reply.get(timeout=10) is None
    assert eng.stats["migrated_out"] == 0


def test_in_process_deployments_ship_over_a_ring(reference):
    """A prefill and a decode ``LLMDeployment`` in this process: the export
    rides a ring, the decode side streams token-exact with the JAX engine,
    and ``close`` unlinks the ring."""
    cfg = _cfg(TM)
    tp = TM.params_from_jax(reference["params"], device="cpu")
    P = serve.LLMDeployment(cfg, params=tp, role="prefill", device="cpu",
                            **ENGINE)
    D = serve.LLMDeployment(cfg, params=tp, role="decode", device="cpu",
                            **ENGINE)
    try:
        got = []
        for i, p in enumerate(reference["prompts"]):
            desc = P.prefill_export(p, {"req": f"r{i}", "dst": "d0",
                                        "dst_node": D.identity()["node"]},
                                    deadline_s=STREAM_S)
            assert desc["kind"] == "channel"
            assert desc["channel"].endswith("-kvx-" + P._kv_sender.src_id
                                            + "-d0")
            got.append(list(D.adopt_stream(p, desc, NEW_TOKENS,
                                           deadline_s=STREAM_S)))
        assert got == reference["want"]
        ring = f"/dev/shm/rtpu-chan-{desc['channel']}"
        assert os.path.exists(ring)
        assert (P.stats()["exported"], D.stats()["adopted"]) == (4, 4)
    finally:
        P.close()
        D.close()
    assert not os.path.exists(ring)


# -- the router ---------------------------------------------------------------

class _Id:
    def __init__(self, b):
        self._b = b

    def binary(self):
        return self._b


class _Rep:
    def __init__(self, b):
        self._actor_id = _Id(b)


def _no_refresh(*_a, **_k):
    raise ConnectionError("no controller in this test")


def _handles(loads, decode_ids):
    """The same pools for both packages' ``DisaggHandle``: replicas that are
    ids only, the decode pool's load reports seeded into its handle's view,
    no controller."""
    out = []
    for handle_cls, dh_cls in ((ref_handle.DeploymentHandle,
                                ref_disagg.DisaggHandle),
                               (serve.DeploymentHandle,
                                disagg.DisaggHandle)):
        pools = []
        for ids in ([b"p"], decode_ids):
            h = handle_cls("d")
            h._replicas = [_Rep(b) for b in ids]
            h._version = 0
            h._refresh = _no_refresh
            pools.append(h)
        pools[1]._route_state.update(kv_loads=loads,
                                     kv_next=time.monotonic() + 3600)
        out.append(dh_cls(*pools))
    return out


def test_router_sheds_on_decode_kv_as_the_reference():
    now = time.time()
    loads = {b"d": {"kv_free": 2, "kv_total": 32, "block_size": 16,
                    "inflight": 0, "ts": now},
             b"e": {"kv_free": 1, "kv_total": 32, "block_size": 16,
                    "inflight": 0, "ts": now},
             b"old": {"kv_free": 30, "kv_total": 32, "block_size": 16,
                      "inflight": 0, "ts": now - 60}}
    ref, port = _handles(loads, [b"d", b"e", b"old"])

    def verdict(dh, n_prompt, max_new):
        try:
            dh._budget_check(n_prompt, max_new)
            return "admit"
        except Exception as e:  # noqa: BLE001 - both packages' sheds
            return (type(e).__name__, e.reason, e.error_type)

    for n_prompt in range(0, 48, 3):
        for max_new in (1, 8, 16):
            want = verdict(ref, n_prompt, max_new)
            assert verdict(port, n_prompt, max_new) == want
    with pytest.raises(RequestShedError) as ei:
        port._budget_check(40, 8)             # 48 tokens > 2 * 16
    assert ei.value.reason == "decode_kv"
    port._budget_check(24, 8)                 # 32 tokens fit exactly


def test_router_decode_pick_matches_the_reference():
    now = time.time()
    loads = {b"a": {"kv_free": 0, "kv_total": 32, "inflight": 4,
                    "node": "n1", "ts": now},
             b"b": {"kv_free": 32, "kv_total": 32, "inflight": 0,
                    "node": "n2", "ts": now},
             b"c": {"kv_free": 16, "kv_total": 32, "inflight": 1,
                    "node": "n1", "ts": now},
             b"d": {"kv_free": 8, "kv_total": 32, "inflight": 2,
                    "node": "n2", "ts": now - 60}}
    ref, port = _handles(loads, [b"a", b"b", b"c", b"d"])
    for prefer in ("n1", "n2", None):
        for exclude in (None, b"b", b"c"):
            ref._rng, port._rng = random.Random(5), random.Random(5)
            picks = [(ref._pick_decode(prefer, exclude)._actor_id.binary(),
                      port._pick_decode(prefer, exclude)._actor_id.binary())
                     for _ in range(40)]
            assert all(a == b for a, b in picks), (prefer, exclude, picks)
            if exclude is not None:
                assert exclude not in {a for a, _ in picks}
    # free and on the prefill replica's node wins every draw it is in
    two = _handles({k: loads[k] for k in (b"a", b"b")}, [b"a", b"b"])[1]
    assert {two._pick_decode("n2")._actor_id.binary()
            for _ in range(20)} == {b"b"}
    assert two._pick_decode("n2", exclude=b"b")._actor_id.binary() == b"a"


# -- deployed -----------------------------------------------------------------

def _segments(session):
    return glob.glob(f"/dev/shm/rtpu-{session}-*") + glob.glob(
        f"/dev/shm/rtpu-*-{session}*")


@pytest.fixture(scope="module")
def runtime():
    """One runtime for the module, with the small store; at the end no
    segment of its session may be left in ``/dev/shm``."""
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    rt.init(num_cpus=8, runtime_env={"env_vars": {"OMP_NUM_THREADS": "1"}})
    session = rt.get_runtime_context().get_session_id()
    yield session
    serve.shutdown()
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    assert _segments(session) == []


@pytest.fixture(scope="module")
def deployed(runtime, jax_params):
    """One prefill and two decode replicas of llama-debug on the CPU, the
    weights the reference's through the object store. The replicas start
    in the background (the JAX reference compiles meanwhile)."""
    params = rt.put(TM.params_from_jax(jax_params, device="cpu"))
    h = serve.deploy_disagg(_cfg(TM), name="dsrv", prefill_replicas=1,
                            decode_replicas=2, params=params, device="cpu",
                            **ENGINE)
    yield h
    h.shutdown()


def _wait_for_reports(h):
    """Until the decode pool reports its node, the router cannot tell that
    a ring reaches it and ships through the store."""
    def reports():
        p, d = h._pool_loads(h.prefill), h._pool_loads(h.decode)
        return (len(p) == 1 and len(d) == 2
                and {v.get("role") for v in p.values()} == {"prefill"}
                and {v.get("role") for v in d.values()} == {"decode"})

    poll_until(reports, timeout=60, desc="both pools' load reports")


def _stats(rep):
    return rt.get(rep.handle_request.remote("stats", (), {}), timeout=60)


def _pool_stats(handle):
    handle._refresh(force=True, timeout=60)
    return {r._actor_id.binary().hex(): _stats(r) for r in handle._replicas}


def _drained(h):
    states = h.kv_states()
    return all(s["inflight"] == 0 and s["queued"] == 0 and _no_leak(s)
               for pool in states.values() for s in pool) and states


def _check_streams(h, session, reference):
    """The prompts one at a time, then all at once, token-exact with the
    JAX engine; both pools drain with no leaked block, the prefill pool
    exported and the decode pool adopted every one, over the rings."""
    prompts, want = reference["prompts"], reference["want"]
    exported0 = sum(s["exported"] for s in _pool_stats(h.prefill).values())
    adopted0 = sum(s["adopted"] for s in _pool_stats(h.decode).values())
    # one at a time, then all at once
    assert [list(h.stream(p, NEW_TOKENS, deadline_s=STREAM_S))
            for p in prompts] == want
    got = [None] * len(prompts)

    def run(i):
        got[i] = list(h.stream(prompts[i], NEW_TOKENS, deadline_s=STREAM_S))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=STREAM_S)
    assert got == want
    states = poll_until(lambda: _drained(h), timeout=30,
                        desc="both pools drained, no leaked KV block")
    assert [s["role"] for s in states["prefill"]] == ["prefill"]
    assert [s["role"] for s in states["decode"]] == ["decode", "decode"]
    n = 2 * len(prompts)
    assert sum(s["exported"] for s in _pool_stats(h.prefill).values()) \
        - exported0 == n
    assert sum(s["adopted"] for s in _pool_stats(h.decode).values()) \
        - adopted0 == n
    # every replica shares the node: the transfers rode rings named for
    # the session, which the runtime's shutdown sweeps (the fixture checks)
    rings = glob.glob(f"/dev/shm/rtpu-chan-{session}-kvx-*")
    assert len(rings) == 2, rings     # one a (prefill, decode) pair


def _check_drain(h, reference):
    """With one live stream on a decode replica, ``drain_decode_replica``
    ships the session to the other: the caller's tokens equal the JAX
    engine's, the prefill pool prefills nothing again, the victim counts
    the migration and the events reach the driver."""
    from ray_tpu_torch.util import state

    prompt, want = reference["drain"], reference["drain_want"]
    exported0 = sum(s["exported"] for s in _pool_stats(h.prefill).values())
    poll_until(lambda: _drained(h), timeout=30, desc="pools idle")
    g = h.stream(prompt, DRAIN_BUDGET, deadline_s=STREAM_S)
    got = [next(g) for _ in range(5)]

    def one_victim():
        live = [hx for hx, s in _pool_stats(h.decode).items()
                if s["inflight"] >= 1]
        return live if len(live) == 1 else None

    victim = poll_until(one_victim, timeout=30,
                        desc="exactly one live decode session")[0]
    t0 = time.perf_counter()
    report = h.drain_decode_replica(victim, timeout_s=30.0)
    assert report == {"sessions": 1, "migrated": 1, "failed": 0,
                      "finished": 0}, report
    assert time.perf_counter() - t0 < 30
    got += list(g)
    assert len(got) == DRAIN_BUDGET
    assert got[:DRAIN_CHECKED] == want
    stats = _pool_stats(h.decode)
    assert stats[victim]["migrated_out"] >= 1
    assert sum(s["exported"] for s in _pool_stats(h.prefill).values()) \
        == exported0 + 1
    poll_until(lambda: _drained(h), timeout=30, desc="pools drained")

    def events():
        evs = state.list_events(limit=100000)
        drains = [e for e in evs if e.get("name") == "serve_drain"
                  and e.get("replica") == victim]
        migs = [e for e in evs if e.get("name") == "serve_session_migrated"
                and e.get("replica") == victim]
        return (drains, migs) if drains and migs else None

    drains, migs = poll_until(events, timeout=30,
                              desc="drain events reach the driver")
    assert int(drains[-1]["sessions"]) == 1
    assert migs[-1]["dst"] != victim
    assert int(migs[-1]["kv_tokens"]) >= len(prompt)


def _check_drain_argument_errors(h):
    with pytest.raises(ValueError, match="not found"):
        h.drain_decode_replica("feedfacefeedface")
    with pytest.raises(ValueError, match="actor_id_hex or node_id"):
        h.drain_decode_replica()
    assert h.drain_decode_replica(node_id="no-such-node") == {
        "sessions": 0, "migrated": 0, "failed": 0, "finished": 0}
    # draining the node that holds both decode replicas leaves no peer
    node = rt.get_runtime_context().get_node_id()
    loads = h._fresh(h._pool_loads(h.decode))
    assert {v.get("node") for v in loads.values()} == {node}
    with pytest.raises(RuntimeError, match="no surviving decode replica"):
        h.drain_decode_replica(node_id=node)


def _check_prefill_killed(h, reference, tmp_path):
    """SIGKILL the prefill replica at the KV-transfer seam: the request is
    prefilled again on its replacement, the caller sees a whole stream,
    and no live replica leaks a block."""
    from ray_tpu_torch.util import failpoints

    prompt, want = reference["prompts"][0], reference["want"][0]
    h.prefill._refresh(force=True, timeout=60)
    before = {r._actor_id.binary() for r in h.prefill._replicas}
    failpoints.arm(f"serve.kv_transfer=kill@once={tmp_path / 'kvkill'}")
    try:
        assert list(h.stream(prompt, NEW_TOKENS, deadline_s=STREAM_S)) \
            == want
    finally:
        failpoints.disarm()
    assert (tmp_path / "kvkill").exists()
    h.prefill._refresh(force=True, timeout=60)
    after = {r._actor_id.binary() for r in h.prefill._replicas}
    assert len(after) == 1 and after.isdisjoint(before)
    assert list(h.stream(prompt, NEW_TOKENS, deadline_s=STREAM_S)) == want
    poll_until(lambda: _drained(h), timeout=30,
               desc="all pools drained, no leaked KV block")


def test_deployed_two_pools_match_jax_engine(deployed, runtime, reference,
                                             tmp_path):
    """The deployment's checks in one test: under xdist each test that
    takes the deployment would start a runtime and three replicas of its
    own. Streams, a drain, the drain's argument errors, then the prefill
    replica killed mid-transfer."""
    _wait_for_reports(deployed)
    _check_streams(deployed, runtime, reference)
    _check_drain(deployed, reference)
    _check_drain_argument_errors(deployed)
    _check_prefill_killed(deployed, reference, tmp_path)


def test_ring_overflow_falls_back_to_the_store(runtime):
    """A wedged decode side (nobody reads the ring) must not stall
    prefill: a ship that times out on the full ring goes through the object
    store, and that descriptor still fetches."""
    from ray_tpu_torch.serve import KVExport

    def export(seed):
        g = torch.Generator().manual_seed(seed)
        return KVExport(token=seed, prompt_len=11, block_size=4,
                        kv={n: torch.randn(2, 3, 4, 2, 8, generator=g)
                            for n in ("k", "v")})

    snd = kv_transfer.KVSender(f"src{uuid.uuid4().hex[:6]}",
                               max_payload_bytes=export(0).nbytes, slots=2)
    rcv = kv_transfer.KVReceiver()
    try:
        descs = [snd.ship(export(i), req_id=f"o{i}", dst_id="dst",
                          same_host=True, timeout=0.2) for i in range(4)]
        kinds = [d["kind"] for d in descs]
        assert kinds == ["channel", "channel", "ref", "ref"], kinds
        assert descs[0]["channel"].startswith(f"{runtime}-kvx-")
        for i in (3, 0):
            meta, kv = rcv.fetch(descs[i], timeout=30)
            assert meta["token"] == i
            assert torch.equal(kv["k"], export(i).kv["k"])
    finally:
        snd.close()
        rcv.close()
