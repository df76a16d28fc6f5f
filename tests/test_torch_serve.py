"""The port's serving engine on the CPU: greedy tokens token-exact against
the JAX package's ``LLMEngine`` (float32 llama-debug, same carried weights,
same prompts — shared system prompt, prefix-cache hits and a copy-on-write
exact repeat; and the dense engine, ``paged=False``, on gemma-debug), the
no-leak invariant, chunked prefill, admission and deadlines, and the
host-side block pool and prefix trie.

Greedy parity runs in float32: the bf16 debug models have exact top-2 logit
ties that a 1-ULP difference flips.
"""

import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu import models as JM
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import models as TM
from ray_tpu_torch.serve import (AdmissionController, BlockPool,
                                 DeadlineExceededError, KVCacheError,
                                 LLMEngine, PrefixCache, RequestShedError,
                                 SLOConfig)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    """These tests share worker processes with the rest of the suite: torch
    keeps to one thread while they run (the shapes are tiny), and JAX's
    caches of the many small programs they compile are dropped after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _f32(mod):
    return mod.get_config("llama-debug").replace(dtype="float32",
                                                 param_dtype="float32")


def _drain(eng, max_steps=500):
    for _ in range(max_steps):
        if not eng.step():
            return
    raise AssertionError("engine did not drain")


def _run_prompts(eng, prompts, max_new):
    outs = []
    for p in prompts:
        sink = []
        outs.append(sink)
        eng.submit(p, max_new, sink.append)
    _drain(eng)
    return [[t for t in o if t is not None] for o in outs]


def _no_leak(eng):
    s = eng.kv_state()
    return s["kv_free"] + s["prefix"]["nodes"] == s["kv_total"]


def test_engine_greedy_tokens_match_jax_engine():
    jcfg = _f32(JM)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, 12).tolist()
    prompts = [shared + rng.integers(0, 256, n).tolist()
               for n in (3, 9, 5, 17)]
    kw = dict(max_slots=4, max_len=64, block_size=4, prefill_chunk=4)
    ref = JaxEngine(jcfg, jp, **kw)
    eng = LLMEngine(_f32(TM), tp, device="cpu", **kw)
    want = _run_prompts(ref, prompts, 6)
    assert _run_prompts(eng, prompts, 6) == want
    assert _no_leak(eng)
    # the same prompts again: the trie serves the shared prefix
    assert _run_prompts(eng, prompts, 6) == want
    assert eng.prefix.stats()["hits"] >= 4
    assert eng.stats["prefix_hit_tokens"] >= 4 * 12
    # an EXACT repeat forces the capped match: copy-on-write of the tail
    before = eng.prefix.stats()["hit_tokens"]
    assert _run_prompts(eng, [prompts[1]], 6) == [want[1]]
    assert eng.prefix.stats()["hit_tokens"] - before == len(prompts[1]) - 1
    assert _run_prompts(ref, [prompts[1]], 6) == [want[1]]
    assert _no_leak(eng)
    assert eng.kv_state()["kv_claimable"] == eng.pool.num_blocks


def test_dense_engine_greedy_tokens_match_jax_dense_engine():
    """paged=False: the per-slot cache, one token a step, prompts fed one
    token at a time. Five requests over three slots (a queue, slots reused),
    gemma-debug (alternating windows, softcaps) in float32: greedy tokens
    equal the JAX dense engine's, with the same stats and kv_state keys."""
    jcfg = JM.gemma_debug().replace(dtype="float32", param_dtype="float32")
    tcfg = TM.gemma_debug().replace(dtype="float32", param_dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (7, 30, 3, 12, 26)]
    kw = dict(paged=False, max_slots=3, max_len=48)
    ref = JaxEngine(jcfg, jp, **kw)
    eng = LLMEngine(tcfg, tp, device="cpu", **kw)
    want = _run_prompts(ref, prompts, 9)
    assert _run_prompts(eng, prompts, 9) == want
    assert eng.prefill_chunk == 1 and eng.pool is None
    # "flops_per_s": the step's FLOPs from the device plane over its time
    assert sorted(eng.stats) == sorted(ref.stats)
    assert eng.stats["flops_per_s"] > 0
    for key in ("steps", "tokens_generated", "max_concurrent", "requests"):
        assert eng.stats[key] == ref.stats[key], key
    state, ref_state = eng.kv_state(), ref.kv_state()
    assert sorted(state) == sorted(ref_state)
    assert state["paged"] is False and state["inflight"] == 0
    with pytest.raises(ValueError, match="paged engine"):
        eng.submit([1, 2], 2, lambda t: None, prefill_only=True)
    with pytest.raises(ValueError, match="paged engine"):
        eng.adopt([1, 2], {}, 3, 2, lambda t: None)


def test_engine_device_rule():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(_f32(TM), max_slots=1, max_len=16)


def test_chunked_prefill_does_not_stall_decode():
    eng = LLMEngine(_f32(TM), max_slots=2, max_len=256, block_size=16,
                    prefill_chunk=16, device="cpu")
    first = []
    eng.submit([1, 2, 3], 40, first.append)
    for _ in range(10):
        eng.step()                       # first request is decoding now
    tokens_before = len(first)
    long_prompt = list(np.random.default_rng(0).integers(0, 256, 160))
    second = []
    eng.submit(long_prompt, 2, second.append)
    steps = 0
    while second.count(None) == 0:
        eng.step()
        steps += 1
        assert steps < 60, "long prompt starved the engine"
    assert steps <= 20                   # ~160/16 steps, not 160
    emitted_during = len([t for t in first if t is not None]) - tokens_before
    assert emitted_during >= steps - 2


def test_admission_controller_gates():
    ac = AdmissionController(SLOConfig(ttft_s=1.0, max_queue_s=0.5,
                                       tpot_s=0.05))
    ac.check_admit(64, 10, 640, 8, 1, 0)     # cold: everything admits
    ac.observe_step(0.2)
    for args, reason in [((8, 10, 80, 8, 1, 0), "queue"),
                         ((80, 0, 0, 8, 1, 0), "ttft"),
                         ((1, 0, 0, 8, 1, 4), "tpot")]:
        with pytest.raises(RequestShedError) as e:
            ac.check_admit(*args)
        assert e.value.reason == reason
    ac2 = AdmissionController(SLOConfig())
    ac2.observe_step(0.2)
    with pytest.raises(RequestShedError) as e:
        ac2.check_admit(80, 0, 0, 8, 1, 0, deadline_s=0.5)
    assert e.value.reason == "deadline"
    snap = ac.snapshot()
    assert snap["shed"] == 3 and snap["shed_by_reason"]["ttft"] == 1


def test_engine_sheds_and_enforces_queue_deadline():
    eng = LLMEngine(_f32(TM), max_slots=1, max_len=64,
                    slo=SLOConfig(ttft_s=1e-9), device="cpu")
    out = []
    eng.submit([1, 2, 3], 2, out.append)     # cold: admitted
    _drain(eng)                              # 2 steps: the 2nd is observed
    with pytest.raises(RequestShedError):
        eng.submit([1, 2, 3], 2, out.append)
    # a queued request behind a long one expires before it ever runs
    eng2 = LLMEngine(_f32(TM), max_slots=1, max_len=128, device="cpu")
    slow, fast = [], []
    eng2.submit([1, 2, 3], 60, slow.append)
    eng2.submit([4, 5, 6], 4, fast.append, deadline_s=0.05)
    deadline = time.monotonic() + 30
    while not fast and time.monotonic() < deadline:
        eng2.step()
    assert fast and isinstance(fast[0], DeadlineExceededError), fast[:1]
    assert eng2.stats["deadline_drops"] == 1
    _drain(eng2)
    assert _no_leak(eng2)


def test_pool_pressure_rejects_impossible_and_keeps_stats_honest():
    eng = LLMEngine(_f32(TM), max_slots=2, max_len=64, block_size=4,
                    num_blocks=8, prefill_chunk=4, device="cpu")
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(list(range(30)), 8, lambda t: None)   # 10 > 8 blocks
    done, hog, waiter = [], [], []
    prompt = list(np.random.default_rng(0).integers(0, 256, 16))
    eng.submit(prompt, 8, done.append)                   # 6 of 8 blocks
    eng.submit(list(np.random.default_rng(1).integers(0, 256, 8)), 16,
               hog.append)                               # 6 blocks: waits
    eng.submit(prompt[:12] + [9], 4, waiter.append)      # prefix of the 1st
    for _ in range(6):
        eng.step()
    s = eng.prefix.stats()
    assert s["hits"] + s["misses"] <= 2, s   # failed retries count once
    _drain(eng)
    assert _no_leak(eng)


def test_no_block_leak_under_cancel_churn_and_abort():
    eng = LLMEngine(_f32(TM), max_slots=4, max_len=64, block_size=4,
                    prefill_chunk=4, device="cpu")
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 256, 8).tolist()
    reqs = []
    for _ in range(12):
        sink = []
        p = shared + rng.integers(0, 256, int(rng.integers(1, 20))).tolist()
        reqs.append((eng.submit(p, 8, sink.append), sink))
    for step in range(8):
        eng.step()
        if step in (2, 4):               # cancel a batch mid-flight
            for r, _ in reqs[step::3]:
                eng.cancel(r)
    _drain(eng)
    assert _no_leak(eng)
    assert eng.pool.num_blocks - eng.pool.free_count == len(eng.prefix)
    # abort_all fails every outstanding request and frees their blocks
    sinks = [[], []]
    for s in sinks:
        eng.submit(shared + [1, 2, 3], 8, s.append)
    eng.step()
    boom = RuntimeError("loop died")
    eng.abort_all(boom)
    assert all(s[-1] is boom for s in sinks)
    assert _no_leak(eng)


# ---------------------------------------------------------------------------
# block pool + prefix trie (host-side)
# ---------------------------------------------------------------------------

def test_block_pool_alloc_free_refcount():
    pool = BlockPool(8, 4)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.free_count == 5
    assert all(pool.refcount(b) == 1 for b in a)
    assert pool.alloc(6) is None and pool.free_count == 5   # all-or-nothing
    pool.retain(a[0])
    assert pool.need_cow(a[0]) and not pool.need_cow(a[1])
    assert not pool.release(a[0])
    assert pool.release(a[0])
    with pytest.raises(KVCacheError):
        pool.release(a[0])
    with pytest.raises(KVCacheError):
        pool.retain(a[0])
    assert pool.release_all(a[1:]) == 2 and pool.free_count == 8
    assert [pool.blocks_for_tokens(n) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]


def test_prefix_trie_hit_miss_and_cap():
    pool = BlockPool(16, 4)
    trie = PrefixCache(pool)
    prompt = list(range(10))                 # 2 full blocks + 2 tail tokens
    blocks = pool.alloc(3)
    assert trie.match(prompt) == ([], 0, None)
    assert trie.insert(prompt, blocks) == 2  # only FULL blocks
    pool.release_all(blocks)
    assert pool.refcount(blocks[0]) == 1 and pool.refcount(blocks[2]) == 0
    got, matched, cow = trie.match(list(range(8)) + [99, 98, 97])
    assert got == blocks[:2] and matched == 8 and cow is None
    pool.release_all(got)
    got, matched, cow = trie.match(list(range(8)))   # exact: capped, COW
    assert got == blocks[:1] and matched == 7 and cow == blocks[1]
    assert pool.refcount(blocks[1]) == 2
    pool.release_all(got)
    pool.release(cow)
    got, matched, cow = trie.match(list(range(4)) + [77, 77, 77, 77, 5])
    assert got == blocks[:1] and matched == 4 and cow is None
    pool.release_all(got)
    s = trie.stats()
    assert s["hits"] == 3 and s["misses"] == 1


def test_prefix_trie_eviction_lru_and_pinning():
    pool = BlockPool(4, 2)
    trie = PrefixCache(pool)
    a = pool.alloc(1)
    trie.insert([1, 2], a)
    time.sleep(0.01)
    b = pool.alloc(1)
    trie.insert([3, 4], b)
    pool.release_all(a + b)
    assert pool.free_count == 2
    got, _, _ = trie.match([1, 2, 9])        # a live sharer pins its chain
    assert trie.evictable_count() == 1
    assert trie.evict(2) == 1
    assert pool.refcount(b[0]) == 0 and pool.refcount(a[0]) == 2
    pool.release_all(got)
    assert trie.evict(2) == 1
    assert pool.free_count == 4 and len(trie) == 0
    c = pool.alloc(2)
    trie.insert([5, 6, 7, 8], c)
    pool.release_all(c)
    assert trie.evict(4) == 2 and pool.free_count == 4
