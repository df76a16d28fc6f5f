"""The port's model against the JAX package's, on the CPU, with the same
weights carried across by ``params_from_jax``: full-sequence logits on the
five debug families, the training loss and every parameter's gradient, the
paged decode step (logits and cache) over chunked prefill and decode with a
shared block and padding rows, and the initializer's shapes, dtypes and
statistics.

Everything runs in float32; logits, caches, losses and gradients agree to
2e-5 absolute (summation order differs between the frameworks' matmuls,
over two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import models as JM
from ray_tpu_torch import models as TM

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 2e-5
FAMILIES = ["llama-debug", "gpt2-debug", "gemma-debug", "mistral-debug",
            "qwen2-debug"]


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


def _configs(name):
    kw = dict(dtype="float32", param_dtype="float32")
    return JM.get_config(name).replace(**kw), TM.get_config(name).replace(**kw)


def _params(jcfg, seed=0):
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    if "bq" in jp["layers"]:
        # init makes zero biases: give them values so the bias path counts
        rng = np.random.default_rng(seed)
        for key in ("bq", "bk", "bv"):
            shape = jp["layers"][key].shape
            jp["layers"][key] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.1)
    return jp, TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg)
    # 40 tokens: past the debug windows (24), so the band is exercised
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 40))
    want, _ = JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg)
    got, aux = TM.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 40, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert float(aux) == 0.0


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}.")
        else:
            yield prefix + key, tree[key]


# (remat, loss_chunk, z_loss, batch): the plain loss on 40 targets (naive
# attention: no tile divides 40); remat with a chunked loss whose chunk (16)
# does not divide them, plus z_loss; explicit inputs/targets/mask over 128
# positions (the blockwise attention Function in both packages)
LOSS_VARIANTS = {
    "plain": (False, 0, 0.0, "tokens"),
    "remat_chunk16_zloss": (True, 16, 1e-3, "tokens"),
    "remat_masked": (True, 0, 1e-4, "explicit"),
}


def _loss_batch(kind, vocab):
    rng = np.random.default_rng(1)
    if kind == "tokens":
        return {"tokens": rng.integers(0, vocab, (2, 41))}
    toks = rng.integers(0, vocab, (2, 129))
    mask = (rng.random((2, 128)) < 0.7).astype(np.float32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name, variant):
    """loss_and_metrics' value, metrics and every parameter's grad against
    ``jax.value_and_grad`` of the reference's, on the same weights."""
    remat, chunk, z_loss, kind = LOSS_VARIANTS[variant]
    kw = dict(remat=remat, loss_chunk=chunk, z_loss=z_loss)
    jcfg, tcfg = (c.replace(**kw) for c in _configs(name))
    jp, tp = _params(jcfg, seed=3)
    batch = _loss_batch(kind, jcfg.vocab_size)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.loss_and_metrics(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jp)
    leaves = dict(_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, met = TM.loss_and_metrics(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=0)
    assert set(met) == set(jmet)
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   atol=TOL, rtol=1e-6)
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(want) == set(leaves)
    for key, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[key], atol=TOL,
                                   rtol=0, err_msg=key)


def _save_attn_grads(tp, tcfg, batch):
    """(loss, {leaf: grad}, forward attention ops run) of the port's loss
    under ``tcfg``'s remat policy."""
    from ray_tpu_torch.ops import attention as TA

    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in _leaves(tp)}
    params = {"layers": {}}
    for key, t in leaves.items():
        head, _, rest = key.partition(".")
        if rest:
            params[head][rest] = t
        else:
            params[head] = t
    TA.fwd_calls = 0
    loss, _ = TM.loss_and_metrics(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    return loss.item(), {k: t.grad for k, t in leaves.items()}, TA.fwd_calls


@pytest.mark.parametrize("name", ["llama-debug", "gemma-debug"])
def test_remat_save_attn_matches_reference_and_full(name):
    """``remat_policy="save_attn"``: loss and every grad against the
    reference's ``save_attn`` (2e-5) and against the port's ``full`` remat
    (1e-6); the forward attention operator runs once a layer under
    ``save_attn`` (its out and lse are saved) and twice under ``full``
    (the recompute runs it again). 128 positions: the blockwise path."""
    jcfg, tcfg = (c.replace(remat=True, remat_policy="save_attn")
                  for c in _configs(name))
    jp, tp = _params(jcfg, seed=3)
    batch = _loss_batch("explicit", jcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_and_metrics(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(jp)
    loss, grads, calls = _save_attn_grads(tp, tcfg, batch)
    full_loss, full_grads, full_calls = _save_attn_grads(
        tp, tcfg.replace(remat_policy="full"), batch)
    assert calls == tcfg.n_layers and full_calls == 2 * tcfg.n_layers
    np.testing.assert_allclose(loss, float(jloss), atol=TOL, rtol=0)
    np.testing.assert_allclose(loss, full_loss, atol=1e-6, rtol=0)
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(want) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key], atol=TOL, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(g.numpy(), full_grads[key].numpy(),
                                   atol=1e-6, rtol=0, err_msg=key)
    # outside autograd the policy changes nothing: one attention a layer
    from ray_tpu_torch.ops import attention as TA

    TA.fwd_calls = 0
    with torch.no_grad():
        TM.forward(tp, torch.from_numpy(batch["inputs"]), tcfg)
    assert TA.fwd_calls == tcfg.n_layers


def test_forward_rejects_moe():
    cfg = TM.moe_debug()
    with pytest.raises(NotImplementedError, match="MoE"):
        TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def _paged_schedule():
    """Four steps over 3 slots, block size 4, chunk 4, 12 blocks:
    two chunked-prefill steps then two decode steps. Slot 2 is a padding
    row (inactive) in step 1, then joins sharing slot 0's first block
    (its logical positions 0-3 map onto block 0, which it only reads)."""
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 8, 9, 10]], np.int32)
    rng = np.random.default_rng(5)
    toks = lambda n: rng.integers(0, 256, n)  # noqa: E731
    steps = []
    # (tokens [3, 4], pos [3], nvalid [3], active [3])
    t = np.zeros((3, 4), np.int32)
    t[0], t[1, :3] = toks(4), toks(3)
    steps.append((t, [0, 0, 0], [4, 3, 0], [True, True, False]))
    t = np.zeros((3, 4), np.int32)
    t[0, :2], t[1], t[2, :2] = toks(2), toks(4), toks(2)
    steps.append((t, [4, 3, 4], [2, 4, 2], [True, True, True]))
    for _ in range(2):
        t = np.zeros((3, 4), np.int32)
        t[:, 0] = toks(3)
        last = steps[-1]
        pos = [p + n for p, n in zip(last[1], last[2])]
        steps.append((t, pos, [1, 1, 1], [True, True, True]))
    return tables, steps


@pytest.mark.parametrize("name", ["llama-debug", "gpt2-debug",
                                  "gemma-debug"])
def test_decode_step_paged_matches_jax(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, seed=2)
    tables, steps = _paged_schedule()
    jcache = JM.init_cache_paged(jcfg, 12, 4)
    tcache = TM.init_cache_paged(tcfg, 12, 4, device="cpu")
    for tokens, pos, nvalid, active in steps:
        jl, jcache = JM.decode_step_paged(
            jp, jcache, jnp.asarray(tokens), jnp.asarray(tables),
            jnp.asarray(pos, jnp.int32), jnp.asarray(nvalid, jnp.int32),
            jcfg, active=jnp.asarray(active))
        tl, tcache = TM.decode_step_paged(
            tp, tcache, torch.from_numpy(tokens), torch.from_numpy(tables),
            torch.tensor(pos), torch.tensor(nvalid), tcfg,
            active=torch.tensor(active))
        rows = np.flatnonzero(active)   # inactive rows' logits are garbage
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=TOL, rtol=0)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), atol=TOL,
                                       rtol=0)
    # block 11 was never named by a table: untouched
    assert not tcache["k"][:, 11].any()


def test_copy_kv_block_in_place():
    cfg = TM.llama_debug()
    cache = TM.init_cache_paged(cfg, 4, 2, device="cpu")
    cache["k"][:, 1] = 1.0
    cache["v"][:, 1] = 2.0
    k_before = cache["k"]
    out = TM.copy_kv_block(cache, 1, 3)
    assert out["k"] is k_before               # the pool itself, updated
    assert (out["k"][:, 3] == 1.0).all() and (out["v"][:, 3] == 2.0).all()
    assert not out["k"][:, 0].any()


@pytest.mark.parametrize("name,param_dtype", [
    ("llama-debug", "float32"), ("gpt2-debug", "float32"),
    ("qwen2-debug", "bfloat16")])
def test_init_params_match_jax_statistics(name, param_dtype):
    """Same keys, shapes and dtypes as the JAX init; constant leaves
    equal; random leaves agree in std within 10% (the generators differ,
    so only the distributions can match)."""
    jcfg = JM.get_config(name).replace(param_dtype=param_dtype)
    tcfg = TM.get_config(name).replace(param_dtype=param_dtype)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TM.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {f"layers/{k}": v for k, v in tp["layers"].items()}
    tflat.update({k: v for k, v in tp.items() if k != "layers"})
    assert sorted(jflat) == sorted(tflat)
    for key, j in jflat.items():
        t = tflat[key]
        assert tuple(t.shape) == j.shape, key
        assert str(t.dtype).replace("torch.", "") == j.dtype.name, key
        jf, tf = j.astype(np.float32), t.float().numpy()
        if jf.std() == 0:
            np.testing.assert_array_equal(tf, jf, err_msg=key)
        else:
            assert abs(tf.std() / jf.std() - 1) < 0.1, key
            assert abs(tf.mean()) < 0.1 * jf.std(), key


def test_init_params_device_rule():
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.init_params(gen, TM.llama_debug())   # cuda by default
    with pytest.raises(ValueError, match="generator"):
        TM.init_params(gen, TM.llama_debug(), device="meta")


# ---------------------------------------------------------------------------
# dense decode: init_cache, decode_step (full-length and ring), the
# multi-slot step, generate
# ---------------------------------------------------------------------------

RING_WINDOW = 16  # families without a uniform window get this one for the ring
# chunk lengths fed in turn: two prefill chunks, a full window, then single
# tokens; 41 positions in all, past every window
DECODE_CHUNKS = (10, 12, 16, 1, 1, 1)


def _ring_configs(name):
    jcfg, tcfg = _configs(name)
    if not jcfg.uniform_window:
        kw = dict(attn_windows=(RING_WINDOW,), sliding_window=0)
        jcfg, tcfg = jcfg.replace(**kw), tcfg.replace(**kw)
    return jcfg, tcfg


def _decode_both(jcfg, tcfg, jp, tp, chunks, max_len, rolling, seed=7):
    """Feed the same chunks through JAX's and the port's decode_step; check
    logits, cache and position after each, within TOL."""
    rng = np.random.default_rng(seed)
    jcache = JM.init_cache(jcfg, 2, max_len, rolling=rolling)
    tcache = TM.init_cache(tcfg, 2, max_len, rolling=rolling, device="cpu")
    assert tcache["k"].shape == jcache["k"].shape
    for t in chunks:
        toks = rng.integers(0, jcfg.vocab_size, (2, t))
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(toks, jnp.int32),
                                    jcfg)
        tl, tcache = TM.decode_step(tp, tcache, torch.from_numpy(toks), tcfg)
        assert tl.shape == (2, t, jcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), atol=TOL,
                                       rtol=0)
        assert tcache["pos"] == int(jcache["pos"])
    return tcache


@pytest.mark.parametrize("layout", ["full", "ring"])
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_matches_jax(name, layout):
    """Chunked prefill and single-token decode, 41 positions: full-length
    (each layer's own window) and ring (one window shared by every layer,
    the prompt past it, so chunks evict keys)."""
    if layout == "ring":
        jcfg, tcfg = _ring_configs(name)
        rolling, max_len = True, 64
    else:
        jcfg, tcfg = _configs(name)
        rolling, max_len = False, 48
    jp, tp = _params(jcfg, seed=3)
    cache = _decode_both(jcfg, tcfg, jp, tp, DECODE_CHUNKS, max_len, rolling)
    want_len = jcfg.uniform_window if layout == "ring" else max_len
    assert cache["k"].shape[2] == want_len


def test_ring_prefill_attends_before_it_writes():
    """A chunk that evicts keys its own early queries still see: the ring
    must attend over the old ring and the chunk's keys before writing them.
    After 24 tokens (a full 24-slot ring) a 12-token chunk overwrites
    positions 0-11, while its first query (position 24) sees 1-24. The
    ring's logits equal the full-length layout's, the exact answer."""
    jcfg, tcfg = _configs("mistral-debug")
    w = tcfg.uniform_window
    chunks = (w, 12)
    # the chunk evicts positions 0..11 and its first query needs 1..w
    assert chunks[1] > 1 and w - chunks[1] < w - 1
    _, tp = _params(jcfg, seed=4)
    rng = np.random.default_rng(8)
    toks = [torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, t)))
            for t in chunks]
    logits = {}
    for rolling in (True, False):
        cache = TM.init_cache(tcfg, 2, 64, rolling=rolling, device="cpu")
        for t in toks:
            out, cache = TM.decode_step(tp, cache, t, tcfg)
        logits[rolling] = out
    assert cache["k"].shape[2] == 64
    np.testing.assert_allclose(logits[True].numpy(), logits[False].numpy(),
                               atol=TOL, rtol=0)


def test_decode_step_multi_matches_jax_with_parked_rows():
    """Three slots at their own depths; parked rows (active False) keep
    their cache and position. Logits of the active rows, the whole cache
    and the positions agree with JAX's."""
    jcfg, tcfg = _configs("gemma-debug")   # alternating windows, softcaps
    jp, tp = _params(jcfg, seed=5)
    rng = np.random.default_rng(9)
    jcache = JM.init_cache_multi(jcfg, 3, 40)
    tcache = TM.init_cache_multi(tcfg, 3, 40, device="cpu")
    schedule = ([True, True, False],) * 10 + ([True, False, True],) * 12 + (
        [False, True, True],) * 8
    for active in schedule:
        toks = rng.integers(0, jcfg.vocab_size, (3, 1))
        jl, jcache = JM.decode_step_multi(jp, jcache,
                                          jnp.asarray(toks, jnp.int32), jcfg,
                                          active=jnp.asarray(active))
        before = {k: tcache[k][:, ~torch.tensor(active)].clone()
                  for k in ("k", "v")}
        tl, tcache = TM.decode_step_multi(tp, tcache, torch.from_numpy(toks),
                                          tcfg, active=torch.tensor(active))
        rows = np.flatnonzero(active)
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=TOL, rtol=0)
        for key in ("k", "v"):
            assert torch.equal(tcache[key][:, ~torch.tensor(active)],
                               before[key])
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), atol=TOL,
                                       rtol=0)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert tcache["pos"].tolist() == [22, 18, 20]


@pytest.mark.parametrize("name,prompt_len", [("mistral-debug", 40),
                                             ("gemma-debug", 30)])
def test_generate_greedy_matches_jax(name, prompt_len):
    """Greedy tokens equal JAX's: mistral-debug with a prompt past its
    24-token window (ring cache, prefilled in window-sized chunks), and
    gemma-debug (mixed windows: the full-length layout)."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, seed=6)
    prompt = np.random.default_rng(10).integers(0, jcfg.vocab_size,
                                                (2, prompt_len))
    want = np.asarray(JM.generate(jp, jnp.asarray(prompt, jnp.int32), jcfg,
                                  max_new_tokens=8))
    got = TM.generate(tp, torch.from_numpy(prompt), tcfg, max_new_tokens=8)
    assert got.shape == (2, prompt_len + 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_samples_from_its_generator():
    """temperature > 0 draws from the given generator only: the same seed
    gives the same tokens and the global RNG is untouched."""
    cfg = TM.get_config("llama-debug").replace(dtype="float32",
                                               param_dtype="float32")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    prompt = torch.arange(5)[None].repeat(2, 1)
    state = torch.get_rng_state()
    outs = [TM.generate(params, prompt, cfg, max_new_tokens=6,
                        temperature=1.5,
                        generator=torch.Generator().manual_seed(seed))
            for seed in (1, 1, 2)]
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert torch.equal(outs[0][:, :5], prompt)
    assert ((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all()


def test_init_cache_layouts_match_jax():
    """Ring iff one shared window below max_len (or rolling=True); mixed
    windows refuse the ring; shapes, dtypes and pos as JAX's."""
    cases = [("mistral-debug", 64, None), ("mistral-debug", 64, False),
             ("mistral-debug", 16, None), ("mistral-debug", 16, True),
             ("llama-debug", 64, None), ("gemma-debug", 64, None)]
    for name, max_len, rolling in cases:
        jcfg, tcfg = JM.get_config(name), TM.get_config(name)
        j = JM.init_cache(jcfg, 2, max_len, rolling=rolling)
        t = TM.init_cache(tcfg, 2, max_len, rolling=rolling, device="cpu")
        assert t["k"].shape == j["k"].shape == t["v"].shape, (name, max_len)
        assert str(t["k"].dtype).replace("torch.", "") == j["k"].dtype.name
        assert t["pos"] == int(j["pos"]) == 0
    assert TM.init_cache(TM.mistral_debug(), 1, 64,
                         device="cpu")["k"].shape[2] == 24
    for name in ("gemma-debug", "llama-debug"):
        with pytest.raises(ValueError, match="ONE window"):
            JM.init_cache(JM.get_config(name), 1, 64, rolling=True)
        with pytest.raises(ValueError, match="ONE window"):
            TM.init_cache(TM.get_config(name), 1, 64, rolling=True,
                          device="cpu")
    multi = TM.init_cache_multi(TM.llama_debug(), 3, 32, device="cpu")
    assert multi["k"].shape == JM.init_cache_multi(JM.llama_debug(), 3,
                                                   32)["k"].shape
    assert multi["pos"].tolist() == [0, 0, 0]


def test_dense_decode_device_rule_and_bounds():
    cfg = TM.mistral_debug()
    if not torch.cuda.is_available():
        for fn in (lambda: TM.init_cache(cfg, 1, 8),
                   lambda: TM.init_cache_multi(cfg, 1, 8)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ring = TM.init_cache(cfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="exceeds the ring"):
        TM.decode_step(params, ring, torch.zeros(1, 25, dtype=torch.long),
                       cfg)
    full = TM.init_cache(cfg, 1, 8, rolling=False, device="cpu")
    with pytest.raises(ValueError, match="exceed the cache"):
        TM.decode_step(params, full, torch.zeros(1, 9, dtype=torch.long), cfg)
