"""The port's LoRA-style deltas (``ray_tpu_torch/models/delta.py``) held
against the JAX package's on the CPU: the same base weights and the same
delta factors (carried by ``models.params_from_jax`` and
``models.delta_from_jax``) give the same variant in float32 within 1e-6,
for every projection whose delta the reference can apply (so the port's
``[L, d, h, hd]`` leaves are shown to take the reference's factors without
a transpose; a ``wo`` delta fails alike in both packages); a
``scale=0`` variant is bitwise its base; untouched leaves are the base's
own tensors; byte counts equal the reference's; the random factors follow
the reference's initialiser in shape, dtype and statistics (the generators
differ, so their values cannot)."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu import models as JM
from ray_tpu_torch import models as TM

ALL_TARGETS = ("wq", "wk", "wv", "wo")
#: the targets the reference's apply_delta can rebuild: its ``wo`` factors
#: are drawn as [L, h * hd, r] x [L, r, d] while the leaf [L, h, hd, d] is
#: flattened to [L, h, hd * d], so a ``wo`` delta raises there (and here)
APPLIED = ("wq", "wk", "wv")


def _f32(mod, name):
    return mod.get_config(name).replace(dtype="float32",
                                        param_dtype="float32")


def _pair(name, *, rank=3, scale=0.5, targets=APPLIED, seed=0):
    """JAX base + delta, and the port's copies of both."""
    jcfg = _f32(JM, name)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    jd = JM.make_delta(jax.random.PRNGKey(seed + 7), jcfg, rank=rank,
                       scale=scale, targets=targets)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    td = TM.delta_from_jax(jax.tree.map(np.asarray, jd), device="cpu")
    return jp, jd, tp, td


@pytest.mark.parametrize("name", ["llama-debug", "gemma-debug"])
def test_apply_delta_matches_reference(name):
    jp, jd, tp, td = _pair(name)
    want = JM.apply_delta(jp, jd)
    got = TM.apply_delta(tp, td)
    for leaf in APPLIED:
        w = np.asarray(want["layers"][leaf])
        assert tuple(got["layers"][leaf].shape) == w.shape
        np.testing.assert_allclose(got["layers"][leaf].numpy(), w,
                                   rtol=0, atol=1e-6, err_msg=leaf)
        # the delta moved the leaf: a no-op would pass the check above
        # only if the reference's were a no-op too
        assert not torch.equal(got["layers"][leaf], tp["layers"][leaf])


def test_a_wo_delta_fails_in_both_packages():
    jp, jd, tp, td = _pair("llama-debug", targets=("wo",))
    with pytest.raises(TypeError, match="incompatible shapes"):
        JM.apply_delta(jp, jd)
    with pytest.raises(RuntimeError):
        TM.apply_delta(tp, td)


def test_delta_from_jax_keeps_the_layout_and_scale():
    _, jd, _, td = _pair("llama-debug", targets=("wq", "wo"), scale=0.25)
    assert td["scale"] == 0.25 and isinstance(td["scale"], float)
    assert sorted(td["targets"]) == ["wo", "wq"]
    for name, fac in td["targets"].items():
        for k in ("a", "b"):
            ref = np.asarray(jd["targets"][name][k])
            assert tuple(fac[k].shape) == ref.shape
            np.testing.assert_array_equal(fac[k].numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_zero_is_bitwise_the_base_and_leaves_are_shared(dtype):
    cfg = TM.get_config("llama-debug").replace(param_dtype=dtype)
    base = TM.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    delta = TM.make_delta(torch.Generator().manual_seed(1), cfg, rank=4,
                          scale=0.0, device="cpu")
    var = TM.apply_delta(base, delta)
    for leaf in ("wq", "wv"):
        assert var["layers"][leaf] is not base["layers"][leaf]
        assert var["layers"][leaf].dtype == base["layers"][leaf].dtype
        assert torch.equal(var["layers"][leaf].view(torch.uint8),
                           base["layers"][leaf].view(torch.uint8))
    for k, v in base["layers"].items():
        if k not in ("wq", "wv"):
            assert var["layers"][k] is v, k
    for k, v in base.items():
        if k != "layers":
            assert var[k] is v, k
    # the base dict itself is untouched
    assert base["layers"]["wq"] is not var["layers"]["wq"]


def _meta_tree(shapes):
    """The port's tensors on the meta device, in the shapes and dtypes of an
    abstract JAX tree (nothing is allocated)."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes.shape, device="meta", dtype=getattr(
        torch, str(shapes.dtype)))


@pytest.mark.parametrize("name,dtype", [("llama-debug", "float32"),
                                        ("gemma-debug", "bfloat16"),
                                        ("llama3-8b", "bfloat16")])
def test_byte_counts_equal_the_reference(name, dtype):
    """``delta_bytes`` and ``params_bytes`` on the same shapes: a rank-16
    delta drawn by both packages, and the reference's parameter shapes
    (abstract at llama3-8b: no weights are drawn)."""
    jcfg = JM.get_config(name).replace(param_dtype=dtype)
    tcfg = TM.get_config(name).replace(param_dtype=dtype)
    jd = JM.make_delta(jax.random.PRNGKey(0), jcfg, rank=16,
                       targets=ALL_TARGETS)
    td = TM.make_delta(torch.Generator().manual_seed(0), tcfg, rank=16,
                       targets=ALL_TARGETS, device="cpu")
    assert TM.delta_bytes(td) == JM.delta_bytes(jd)
    jp = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    assert TM.params_bytes(_meta_tree(jp)) == JM.params_bytes(jp)


def test_delta_byte_counts_match_on_real_factors():
    jp, jd, tp, td = _pair("llama-debug", targets=ALL_TARGETS)
    assert TM.delta_bytes(td) == JM.delta_bytes(jax.tree.map(np.asarray, jd))
    assert TM.params_bytes(tp) == JM.params_bytes(jp)


def test_factor_statistics_match_the_reference_initialiser():
    """Rank 16 over llama-debug's four projections: the same shapes and
    dtypes, zero means, and standard deviations of ``d ** -0.5`` (a) and
    ``r ** -0.5`` (b) in both packages."""
    jcfg = _f32(JM, "llama-debug")
    tcfg = _f32(TM, "llama-debug")
    jd = JM.make_delta(jax.random.PRNGKey(3), jcfg, rank=16,
                       targets=ALL_TARGETS)
    td = TM.make_delta(torch.Generator().manual_seed(3), tcfg, rank=16,
                       targets=ALL_TARGETS, device="cpu")
    assert jd["scale"] == td["scale"] == 1.0
    for name in ALL_TARGETS:
        for k in ("a", "b"):
            ref = np.asarray(jd["targets"][name][k])
            got = td["targets"][name][k].numpy()
            assert got.shape == ref.shape and str(got.dtype) == str(ref.dtype)
            # a [L, d, r], b [L, r, e]: std d ** -0.5, r ** -0.5
            want_std = ref.shape[1] ** -0.5
            for arr in (ref, got):
                n = arr.size
                assert abs(arr.mean()) < 4 * want_std / n ** 0.5
                assert abs(arr.std() / want_std - 1) < 4 / (2 * n) ** 0.5


def test_make_delta_validates_targets_and_device():
    cfg = TM.get_config("llama-debug")
    with pytest.raises(ValueError, match="unknown delta target"):
        TM.make_delta(torch.Generator(), cfg, targets=("w_up",),
                      device="cpu")
    with pytest.raises(ValueError, match="generator"):
        TM.make_delta(torch.Generator(), cfg, device="meta")
