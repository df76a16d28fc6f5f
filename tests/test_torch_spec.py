"""Speculative decoding in the port on the CPU (float32 llama-debug, the
JAX package's weights carried by ``params_from_jax``): the ngram and model
drafters emit exactly the plain greedy sequence, held against the port's
plain paged engine and against the JAX package's plain paged engine; the
engine's validation; the fallback to plain decoding when acceptance
collapses."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu import models as JM
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import models as TM
from ray_tpu_torch.serve import LLMEngine, SpeculativeLLMEngine


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _f32(mod):
    return mod.get_config("llama-debug").replace(dtype="float32",
                                                 param_dtype="float32")


def _drain(eng, max_steps=800):
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


KW = dict(max_slots=4, max_len=96, paged=True, block_size=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def plain_case():
    """The weights, prompts (repetitive ones, where drafts land, and random
    ones, where they do not) and the plain greedy tokens of both packages'
    paged engines, which must agree."""
    jp = JM.init_params(jax.random.PRNGKey(0), _f32(JM))
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2], rng.integers(0, 256, 7).tolist(),
               [5, 6, 5, 6, 5, 6, 5], rng.integers(0, 256, 19).tolist()]
    refs = _run_prompts(LLMEngine(_f32(TM), tp, device="cpu", **KW),
                        prompts, 24)
    assert _run_prompts(JaxEngine(_f32(JM), jp, **KW), prompts, 24) == refs
    return tp, prompts, refs


def _spec(plain_case, drafter, **spec_kw):
    tp, prompts, refs = plain_case
    spec = SpeculativeLLMEngine(_f32(TM), tp, drafter=drafter, device="cpu",
                                **KW, **spec_kw)
    assert _run_prompts(spec, prompts, 24) == refs, \
        "speculative output diverged from plain greedy"
    s = spec.kv_state()
    assert s["kv_free"] + s["prefix"]["nodes"] == s["kv_total"]
    return spec


@pytest.mark.parametrize("drafter,spec_kw", [
    ("ngram", dict(spec_k=4)),
    # the draft model: the same debug config from another seed — the vocab
    # matches, its proposals mostly miss; exactness must hold regardless
    ("model", dict(spec_k=3, draft_seed=5)),
], ids=["ngram", "model"])
def test_spec_drafters_exact_parity(plain_case, drafter, spec_kw):
    spec = _spec(plain_case, drafter, spec_accept_floor=0.0, **spec_kw)
    st = spec.kv_state()["spec"]
    assert st["spec_rounds"] > 0
    # with these random weights the drafts may all miss (acceptance is
    # shown by the next test); exactness must hold either way
    assert 0 <= st["spec_accepted"] <= st["spec_proposed"] > 0
    # the verify program ran every step
    from ray_tpu_torch.util import device_plane
    row = device_plane.registry().program("serve::verify_step_paged")
    assert row is not None and row["calls"] >= spec.stats["steps"]


def test_spec_model_drafter_accepts_the_target_as_its_own_draft(plain_case):
    """A draft model that IS the target proposes the target's own greedy
    tokens: every proposal is accepted, and the output is still exact."""
    tp = plain_case[0]
    spec = _spec(plain_case, "model", spec_k=3, draft_params=tp,
                 spec_accept_floor=0.0)
    st = spec.kv_state()["spec"]
    assert st["spec_accepted"] == st["spec_proposed"] > 0


def test_spec_validation():
    cfg = _f32(TM)
    with pytest.raises(ValueError, match="greedy"):
        SpeculativeLLMEngine(cfg, temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        SpeculativeLLMEngine(cfg, paged=False, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        SpeculativeLLMEngine(cfg, spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="drafter"):
        SpeculativeLLMEngine(cfg, drafter="oracle", device="cpu")
    # the verify window widens the chunk: [last, d1..dk] fits one step
    eng = SpeculativeLLMEngine(cfg, spec_k=9, prefill_chunk=4, max_slots=2,
                               max_len=64, device="cpu")
    assert eng.prefill_chunk == 10
    # a model drafter with a mismatched vocab fails at its first proposal
    small = cfg.replace(vocab_size=128)
    eng = SpeculativeLLMEngine(cfg, drafter="model", draft_model=small,
                               max_slots=2, max_len=64, device="cpu")
    eng.submit([1, 2, 3], 4, lambda t: None)
    with pytest.raises(ValueError, match="vocab"):
        _drain(eng)


def test_spec_fallback_on_collapsed_acceptance(plain_case):
    """With an impossible acceptance floor every request falls back to
    plain decoding after the warmup rounds, and stays token-exact."""
    spec = _spec(plain_case, "ngram", spec_k=4, spec_accept_floor=1.1)
    assert spec.stats["spec_fallbacks"] >= 1
    # a request that fell back proposes no more: its rounds stop at warmup
    assert spec.stats["spec_rounds"] <= spec.SPEC_WARMUP * len(plain_case[1])
    assert all(st["off"] for st in spec._spec.values()) or not spec._spec
