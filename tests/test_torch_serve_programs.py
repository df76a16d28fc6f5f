"""The serving engine's device programs on the CPU, against the JAX
package on the same inputs (weights carried by ``params_from_jax``, caches
and tokens from a numpy seed, float32):

- ``verify_step_paged``: all-position logits (softcap applied) over rows
  that decode, prefill, sit parked, and pad past their tables, on a Llama
  and a Gemma-2-style config (softcaps, alternating windows), to 1e-5;
- the paged step's static-shape write: invalid rows whose destinations
  collide with valid writes change nothing (bitwise) outside the valid
  rows, and the cache equals the reference's to 1e-5;
- the dense step's parked rows (one past its cache) write nothing;
- ``gather_kv_blocks`` / ``scatter_kv_blocks`` with padded ids;
- the engine's prefill-only export and ``adopt``: token-exact against the
  colocated engine and the JAX package's ``generate``, no leaked block,
  and adopt's geometry errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as JM
from ray_tpu_torch import models as TM
from ray_tpu_torch.serve import KVExport, LLMEngine

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _configs(name):
    kw = dict(dtype="float32", param_dtype="float32")
    return JM.get_config(name).replace(**kw), TM.get_config(name).replace(**kw)


def _params(jcfg, seed):
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


N_BLOCKS, BS, C = 12, 4, 8


def _batch(cfg, rng):
    """Four rows over a 12-block pool of 4-token blocks, C = 8:
    0 decodes (pos 5, block 3 offset 1); 1 prefills 6 of 8 (blocks 4-5,
    two padding rows); 2 is parked with a table on row 0's block 3, its
    would-be rows on row 0's destination; 3 decodes at the last position
    of its table, its padding clamped onto its own block 9 (one onto its
    own valid destination)."""
    tables = np.array([[2, 3, 0], [4, 5, 6], [3, 3, 3], [7, 8, 9]], np.int32)
    pos = np.array([5, 0, 1, 11], np.int32)
    nvalid = np.array([1, 6, 8, 1], np.int32)
    active = np.array([True, True, False, True])
    tokens = rng.integers(0, cfg.vocab_size, (4, C)).astype(np.int32)
    shape = (cfg.n_layers, N_BLOCKS, BS, cfg.kv_heads, cfg.hdim)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    return tokens, tables, pos, nvalid, active, cache


def _run_both(name, step, seed):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, seed)
    rng = np.random.default_rng(seed)
    tokens, tables, pos, nvalid, active, cache = _batch(tcfg, rng)
    jl, jc = getattr(JM, step)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(nvalid), jcfg, active=jnp.asarray(active))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tc = getattr(TM, step)(
        tp, tcache, torch.from_numpy(tokens), torch.from_numpy(tables),
        torch.from_numpy(pos), torch.from_numpy(nvalid), tcfg,
        active=torch.from_numpy(active))
    assert tc is tcache                       # updated in place
    return (tl.numpy(), np.asarray(jl), {k: tc[k].numpy() for k in tc},
            {k: np.asarray(jc[k]) for k in jc}, cache,
            (pos, nvalid, active, tables))


def _valid_rows(pos, nvalid, active, tables):
    """Flat pool rows (block * BS + offset) the valid tokens write."""
    rows = set()
    for b in np.flatnonzero(active):
        for j in range(nvalid[b]):
            p = pos[b] + j
            rows.add(int(tables[b, p // BS]) * BS + int(p % BS))
    return sorted(rows)


@pytest.mark.parametrize("name", ["llama-debug", "gemma-debug"])
def test_verify_step_paged_matches_jax(name):
    tl, jl, tc, jc, _, _ = _run_both(name, "verify_step_paged", seed=1)
    assert tl.shape == jl.shape == (4, C, TM.get_config(name).vocab_size)
    # every position of every row: the active, prefilling and parked rows
    # see the same cache in both, so even padding logits agree
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)
    if name == "gemma-debug":   # the logit softcap is applied
        assert np.abs(tl).max() <= TM.gemma_debug().logits_softcap
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key], jc[key], atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["llama-debug", "gemma-debug"])
def test_paged_step_collisions_write_nothing_outside_valid_rows(name):
    tl, jl, tc, jc, before, meta = _run_both(name, "decode_step_paged",
                                             seed=2)
    pos, nvalid, active, tables = meta
    rows = np.flatnonzero(active)
    np.testing.assert_allclose(tl[rows], jl[rows], atol=TOL, rtol=0)
    valid = _valid_rows(*meta)
    assert len(valid) == 8      # rows 0 and 3 one token each, row 1 six
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key], jc[key], atol=TOL, rtol=0)
        flat_t = tc[key].reshape(tc[key].shape[0], -1, *tc[key].shape[3:])
        flat_b = before[key].reshape(flat_t.shape)
        keep = np.setdiff1d(np.arange(flat_t.shape[1]), valid)
        np.testing.assert_array_equal(flat_t[:, keep], flat_b[:, keep])
        # and every valid row did change
        assert (flat_t[:, valid] != flat_b[:, valid]).any(axis=(0, 2, 3)).all()


def test_paged_step_with_no_valid_row_changes_nothing():
    cfg = TM.get_config("llama-debug").replace(dtype="float32",
                                               param_dtype="float32")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rng = np.random.default_rng(5)
    tokens, tables, pos, nvalid, active, cache = _batch(cfg, rng)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    TM.decode_step_paged(params, tcache, torch.from_numpy(tokens),
                         torch.from_numpy(tables), torch.from_numpy(pos),
                         torch.zeros(4, dtype=torch.int64), cfg,
                         active=torch.from_numpy(active))
    for key in ("k", "v"):
        np.testing.assert_array_equal(tcache[key].numpy(), cache[key])


def test_dense_step_parked_and_full_rows_write_nothing():
    """decode_step_multi's static write: a parked row, and an active row
    already at the end of its cache (the reference drops that write), keep
    their cache bitwise; logits match the reference."""
    jcfg, tcfg = _configs("gemma-debug")
    jp, tp = _params(jcfg, seed=3)
    rng = np.random.default_rng(3)
    n, L = 3, 16
    shape = (tcfg.n_layers, n, L, tcfg.kv_heads, tcfg.hdim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([7, 4, L], np.int32)
    active = np.array([True, False, True])
    toks = rng.integers(0, tcfg.vocab_size, (n, 1)).astype(np.int32)
    jl, jc = JM.decode_step_multi(
        jp, {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
             "pos": jnp.asarray(pos)}, jnp.asarray(toks), jcfg,
        active=jnp.asarray(active))
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
          "pos": torch.from_numpy(pos.astype(np.int64))}
    pos_t = tc["pos"]
    tl, tc = TM.decode_step_multi(tp, tc, torch.from_numpy(toks), tcfg,
                                  active=torch.from_numpy(active))
    assert tc["pos"] is pos_t                 # advanced in place
    assert tc["pos"].tolist() == [8, 4, L + 1] == np.asarray(jc["pos"]).tolist()
    # every row sees the same cache in both, so all logits agree
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for key, before in (("k", k0), ("v", v0)):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=TOL, rtol=0)
        np.testing.assert_array_equal(tc[key].numpy()[:, 1:], before[:, 1:])


def test_gather_scatter_kv_blocks_roundtrip():
    rng = np.random.default_rng(0)
    cache = {k: torch.from_numpy(rng.normal(size=(2, 8, 4, 2, 3))
                                 .astype(np.float32)) for k in ("k", "v")}
    got = TM.gather_kv_blocks(cache, [5, 1, 6])
    jgot = JM.gather_kv_blocks({k: jnp.asarray(v.numpy())
                                for k, v in cache.items()}, [5, 1, 6])
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      cache[key].numpy()[:, [5, 1, 6]])
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(jgot[key]))
    # scatter into other blocks of a zero pool; the out-of-range pad id
    # writes nothing (the bucketing contract)
    dst = {k: torch.zeros(2, 8, 4, 2, 3) for k in ("k", "v")}
    pad = {k: torch.cat([got[k], torch.ones(2, 1, 4, 2, 3)], 1)
           for k in ("k", "v")}
    out = TM.scatter_kv_blocks(dst, [2, 0, 7, 8], pad)
    jout = JM.scatter_kv_blocks(
        {k: jnp.zeros((2, 8, 4, 2, 3), jnp.float32) for k in ("k", "v")},
        [2, 0, 7, 8], {k: jnp.asarray(v.numpy()) for k, v in pad.items()})
    assert out is dst
    for key in ("k", "v"):
        np.testing.assert_array_equal(out[key].numpy()[:, [2, 0, 7]],
                                      got[key].numpy())
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jout[key]))
    untouched = [i for i in range(8) if i not in (2, 0, 7)]
    assert out["k"][:, untouched].sum() == 0
    # a batch of padding only writes nothing at all
    before = {k: v.clone() for k, v in out.items()}
    TM.scatter_kv_blocks(out, [8, 9], {k: torch.ones(2, 2, 4, 2, 3)
                                       for k in ("k", "v")})
    for key in ("k", "v"):
        assert torch.equal(out[key], before[key])


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
    return eng.pool.free_count + len(eng.prefix) == eng.pool.num_blocks


def test_engine_export_adopt_parity_and_no_leaks():
    """prefill_only on engine P + adopt on engine D == the colocated engine
    == the JAX package's generate, token-exact, with every block returned
    on both pools."""
    jcfg, tcfg = _configs("llama-debug")
    jp, tp = _params(jcfg, seed=0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).tolist() for n in (13, 5, 21)]
    refs = []
    for p in prompts:
        g = JM.generate(jp, jnp.asarray(np.asarray(p, np.int32)[None]), jcfg,
                        max_new_tokens=6)
        refs.append([int(x) for x in np.asarray(g[0, len(p):])])
    kw = dict(max_slots=4, max_len=64, block_size=4, prefill_chunk=4,
              device="cpu")
    colocated = LLMEngine(tcfg, tp, **kw)
    assert _run_prompts(colocated, prompts, 6) == refs
    P = LLMEngine(tcfg, tp, role="prefill", **kw)
    D = LLMEngine(tcfg, tp, role="decode", **kw)
    exports = []
    for p in prompts:
        sink = []
        P.submit(p, 6, sink.append, prefill_only=True)
        _drain(P)
        (e,) = [x for x in sink if isinstance(x, KVExport)]
        assert sink[-1] is None and len(sink) == 2
        assert e.kv["k"].shape == (tcfg.n_layers, -(-len(p) // 4), 4,
                                   tcfg.kv_heads, tcfg.hdim)
        assert e.nbytes == 2 * e.kv["k"].numel() * 4
        exports.append(e)
    outs = []
    for p, e in zip(prompts, exports):
        sink = []
        outs.append(sink)
        D.adopt(p, e.kv, e.token, 6, sink.append)
    _drain(D)
    got = [[t for t in o if t is not None] for o in outs]
    assert got == refs
    # the export's first token IS the stream's first token
    assert all(o[0] == e.token for o, e in zip(got, exports))
    for eng, role in ((P, "prefill"), (D, "decode")):
        assert _no_leak(eng)
        assert eng.kv_state()["role"] == role
    assert P.stats["exported"] == 3 and D.stats["adopted"] == 3


def test_adopt_rejects_bad_geometry():
    _, tcfg = _configs("llama-debug")
    eng = LLMEngine(tcfg, max_slots=2, max_len=64, block_size=4,
                    role="decode", device="cpu")
    kv = {"k": np.zeros((2, 2, 4, 2, 16), np.float32),
          "v": np.zeros((2, 2, 4, 2, 16), np.float32)}
    with pytest.raises(ValueError, match="blocks"):
        eng.adopt(list(range(13)), kv, 7, 4, lambda t: None)  # needs 4
    with pytest.raises(ValueError, match="block_size"):
        bad = {"k": np.zeros((2, 4, 8, 2, 16), np.float32),
               "v": np.zeros((2, 4, 8, 2, 16), np.float32)}
        eng.adopt(list(range(13)), bad, 7, 4, lambda t: None)
    with pytest.raises(ValueError, match="geometry"):
        wrong_heads = {"k": np.zeros((2, 4, 4, 1, 16), np.float32),
                       "v": np.zeros((2, 4, 4, 1, 16), np.float32)}
        eng.adopt(list(range(13)), wrong_heads, 7, 4, lambda t: None)
    with pytest.raises(ValueError, match="role"):
        LLMEngine(tcfg, max_slots=2, max_len=64, role="router", device="cpu")
    # nothing was claimed by the rejected adopts
    assert eng.pool.free_count == eng.pool.num_blocks
