"""The port's model against the JAX package's, on the CPU, with the same
weights carried across by ``params_from_jax``: full-sequence logits on the
five debug families, the paged decode step (logits and cache) over chunked
prefill and decode with a shared block and padding rows, and the
initializer's shapes, dtypes and statistics.

Everything runs in float32; logits and caches agree to 2e-5 absolute
(summation order differs between the frameworks' matmuls, over two layers).
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
