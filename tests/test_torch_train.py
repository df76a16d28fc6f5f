"""The port's training path against the JAX package's, on the CPU: one
``adamw`` step against ``optax.adamw``, and the loop helper's 5-step loss
and grad-norm trajectory and final parameters against the JAX
``TrainLoopHelper`` on llama_debug and gemma_debug (also at Gemma-2's head
dim 256), with the same weights carried across by ``params_from_jax``
(float32 throughout).

The helper's own checkpoints and profiling run on the port alone: a
bf16 / f32 / int64 round trip through ``save_pytree`` / ``load_pytree``
bit for bit, an async snapshot that later in-place steps do not reach, a
restore that continues bit for bit, ``profile_steps`` applying exactly n
steps, and the data-parallel batch check.

Tolerances: a single optimizer step agrees to 1e-6 (the same float32
update, different operation order). Over 5 steps the losses agree to 5e-5
and the grad norms to 1e-4 relative; the parameters agree to 5e-5, 5% of
one step's size at lr 1e-3: Adam divides each grad by its running RMS, so
summation-order differences in small grads move an update by a fraction of
the learning rate.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import models as JM
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train.train_state import TrainLoopHelper as JaxHelper
from ray_tpu_torch import models as TM
from ray_tpu_torch.train import (TrainLoopHelper, adamw, create_train_state,
                                 make_train_step)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    """These tests share worker processes with the rest of the suite: torch
    keeps to one thread while they run (the shapes are tiny), and JAX's
    caches of the programs they compile are dropped after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}.")
        else:
            yield prefix + key, tree[key]


def test_adamw_step_matches_optax():
    """Two leaves with a decayed update: moments, bias correction and the
    decoupled weight decay are optax's (defaults included)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = optax.adamw(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = opt.init(jp)
    for g in grads:
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = create_train_state(tp, adamw(LR))
    for g in grads:
        for key, t in tp.items():
            t.grad = torch.from_numpy(g[key])
        state["opt_state"].step()
    for key in params:
        np.testing.assert_allclose(tp[key].detach().numpy(),
                                   np.asarray(jp[key]), atol=1e-6, rtol=0)


def test_adamw_defaults_are_optax_defaults():
    """weight_decay 1e-4 (optax), not torch.optim.AdamW's 0.01."""
    opt = adamw(LR)([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


# test id -> (preset, overrides, Adam's eps). Head dim 256 is Gemma-2's. Its
# 16x wider q/k/v projections hold weights whose first grad is ~1e-9 (one
# wk element at seed 0, against a median of 2e-4): there Adam's first step,
# g / (|g| + eps), is about sign(g) at optax's eps of 1e-8, and a 1e-9
# summation-order difference between the two frameworks moves that weight
# by 5.6% of a step for good. Adam's eps of 1e-3 (both sides), as the card
# smoke's small train step uses, keeps the parameter check a check of the
# grads.
CONFIGS = {"llama-debug": ("llama-debug", {}, 1e-8),
           "gemma-debug": ("gemma-debug", {}, 1e-8),
           "gemma-debug-hd256": ("gemma-debug", dict(head_dim=256), 1e-3)}


def _helpers(name, seed=0):
    """A JAX helper on a one-device mesh and the port's on the CPU, both
    starting from the same float32 weights."""
    preset, overrides, eps = CONFIGS[name]
    jcfg = JM.get_config(preset).replace(dtype="float32",
                                         param_dtype="float32", **overrides)
    tcfg = TM.get_config(preset).replace(dtype="float32",
                                         param_dtype="float32", **overrides)
    weights = jax.tree.map(np.asarray,
                           JM.init_params(jax.random.PRNGKey(seed), jcfg))
    mesh = make_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    jax_helper = JaxHelper.create(
        lambda: jax.tree.map(jnp.asarray, weights), JM.param_axes(jcfg),
        lambda p, b: JM.loss_and_metrics(p, b, jcfg),
        optax.adamw(LR, eps=eps), mesh=mesh)
    helper = TrainLoopHelper.create(
        lambda: TM.params_from_jax(weights, device="cpu"),
        lambda p, b: TM.loss_and_metrics(p, b, tcfg), adamw(LR, eps=eps),
        device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 41)).astype(np.int32)
    return jax_helper, helper, {"tokens": tokens}


def _check_params(helper, jax_helper):
    want = dict(_leaves(jax.tree.map(np.asarray, jax_helper.state["params"])))
    got = dict(_leaves(helper.state["params"]))
    assert set(got) == set(want)
    for key, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[key], atol=5e-5,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_trajectory_matches_jax_helper(name):
    """5 ``run_step`` calls: loss and grad norm at every step, then the
    parameters."""
    jax_helper, helper, batch = _helpers(name)
    losses = []
    for _ in range(5):
        want = jax_helper.run_step(batch)
        got = helper.run_step(batch)
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   atol=5e-5, rtol=0)
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(want["grad_norm"]), rtol=1e-4)
        losses.append(got["loss"].item())
    assert losses[-1] < losses[0]
    _check_params(helper, jax_helper)
    assert int(helper.state["step"]) == 5


@pytest.mark.parametrize("name", ["llama-debug", "gemma-debug"])
def test_run_steps_matches_jax_helper(name):
    """``run_steps(batch, 5)``: the last step's metrics and the parameters
    after it."""
    jax_helper, helper, batch = _helpers(name, seed=1)
    want = jax_helper.run_steps(batch, 5)
    got = helper.run_steps(batch, 5)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(got["grad_norm"].item(),
                               float(want["grad_norm"]), rtol=1e-4)
    _check_params(helper, jax_helper)


def test_train_step_metrics_are_detached_and_step_counts():
    cfg = TM.llama_debug().replace(dtype="float32", param_dtype="float32")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    state = create_train_state(params, adamw(LR))
    step = make_train_step(lambda p, b: TM.loss_and_metrics(p, b, cfg))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 17))}
    state, metrics = step(state, batch)
    state, metrics = step(state, batch)
    assert int(state["step"]) == 2
    assert all(not v.requires_grad and v.ndim == 0 for v in metrics.values())
    assert {"loss", "ntokens", "perplexity", "grad_norm"} <= set(metrics)


def test_helper_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    """The device rule: ``device=None`` means cuda; with no GPU the helper
    raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoopHelper.create(lambda: built.append(1), lambda p, b: None,
                               adamw(LR))
    assert not built


# ---------------------------------------------------------------------------
# checkpoints of the train state, profiling, the data-parallel batch check
# ---------------------------------------------------------------------------

def _port_helper(seed=0, eps=1e-8):
    cfg = TM.llama_debug().replace(dtype="float32", param_dtype="float32")
    helper = TrainLoopHelper.create(
        lambda: TM.init_params(torch.Generator().manual_seed(seed), cfg,
                               device="cpu"),
        lambda p, b: TM.loss_and_metrics(p, b, cfg), adamw(LR, eps=eps),
        device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(seed + 1))
    return helper, {"tokens": tokens}


def test_save_and_load_pytree_round_trip_bitwise(tmp_path):
    """bf16, f32 and int64 leaves, a 0-d one, and the structure around them
    (a list, a tuple, Python scalars) come back bit for bit; ``device=``
    places the leaves."""
    from ray_tpu_torch.train import load_pytree, save_pytree

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16),
            "b": torch.randn(7, generator=g),
            "ids": torch.randint(-(1 << 40), 1 << 40, (4,), generator=g),
            "step": torch.tensor(3),
            "groups": [{"lr": 1e-3, "params": [0, 1]}],
            "pair": (torch.ones(2, dtype=torch.float32), None, "x")}
    save_pytree(tree, str(tmp_path))
    got = load_pytree(str(tmp_path), device="cpu")
    for key in ("w", "b", "ids", "step"):
        assert got[key].dtype == tree[key].dtype
        assert got[key].shape == tree[key].shape
        assert torch.equal(got[key].view(torch.uint8)
                           if got[key].ndim else got[key],
                           tree[key].view(torch.uint8)
                           if tree[key].ndim else tree[key]), key
    assert got["groups"] == tree["groups"]
    assert torch.equal(got["pair"][0], tree["pair"][0])
    assert got["pair"][1:] == (None, "x") and isinstance(got["pair"], tuple)
    assert sorted(os.listdir(tmp_path)) == [
        ".metadata.json", "state_pytree.npz", "state_pytree_struct.pkl"]


def test_async_snapshot_is_immune_to_later_steps(tmp_path):
    """On the CPU ``.cpu()`` is the same storage AdamW updates in place: the
    snapshot taken by ``save_checkpoint_async`` must be a copy, so the
    steps run after it returns (before its write lands) change nothing."""
    from ray_tpu_torch.train import load_pytree

    helper, batch = _port_helper()
    helper.run_step(batch)
    want = {k: v.detach().clone() for k, v in _leaves(helper.state["params"])}
    pending = helper.save_checkpoint_async(str(tmp_path))
    for _ in range(2):
        helper.run_step(batch)
    pending.wait()
    got = dict(_leaves(load_pytree(str(tmp_path))["params"]))
    moved = [k for k, v in _leaves(helper.state["params"])
             if not torch.equal(v.detach(), want[k])]
    assert moved                                   # the steps did update
    for key, t in got.items():
        assert torch.equal(t, want[key]), key


def test_checkpoint_restore_continues_bitwise(tmp_path):
    """Save after 2 steps (parameters, AdamW moments and steps), restore into
    a fresh helper, run 2 more: the same losses and parameters, bit for
    bit, as 4 uninterrupted steps. Without the optimizer's state it
    differs (Adam's bias correction restarts)."""
    from ray_tpu_torch.train import load_pytree

    ref, batch = _port_helper()
    ref_losses = [ref.run_step(batch)["loss"].item() for _ in range(4)]
    first, _ = _port_helper()
    for _ in range(2):
        first.run_step(batch)
    first.save_checkpoint_async(str(tmp_path)).wait()
    tree = load_pytree(str(tmp_path))
    assert int(tree["step"]) == 2
    assert set(tree["opt_state"]["state"][0]) == {"step", "exp_avg",
                                                  "exp_avg_sq"}
    resumed, _ = _port_helper(seed=5)                 # other weights
    resumed.restore(tree)
    losses = [resumed.run_step(batch)["loss"].item() for _ in range(2)]
    assert losses == ref_losses[2:]
    for (key, a), (_, b) in zip(_leaves(resumed.state["params"]),
                                _leaves(ref.state["params"])):
        assert torch.equal(a.detach(), b.detach()), key
    bare, _ = _port_helper(seed=5)
    with torch.no_grad():
        for (_, t), (_, src) in zip(_leaves(bare.state["params"]),
                                    _leaves(tree["params"])):
            t.copy_(src)
    assert bare.run_step(batch)["loss"].item() == ref_losses[2]
    assert bare.run_step(batch)["loss"].item() != ref_losses[3]


def test_profile_steps_writes_a_trace_and_runs_n_steps(tmp_path,
                                                       monkeypatch):
    helper, batch = _port_helper()
    helper.profile_steps(batch, 2, str(tmp_path / "trace"))
    assert int(helper.state["step"]) == 2
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        assert "traceEvents" in json.load(f)
    # a capture that fails before the steps: they run once, unprofiled
    monkeypatch.setattr(torch.profiler, "profile", _failing_profile)
    with pytest.warns(UserWarning, match="ran unprofiled"):
        helper.profile_steps(batch, 3, str(tmp_path / "trace"))
    assert int(helper.state["step"]) == 5


def _failing_profile(*args, **kwargs):
    raise RuntimeError("no profiler here")


class _TwoWayMesh:
    """A mesh with dp=2, to check the batch rule without a process group."""
    mesh_dim_names = ("dcn", "dp", "fsdp")
    shape = (1, 2, 1)


def test_batch_that_dp_does_not_divide_raises():
    helper, _ = _port_helper()
    helper.mesh = _TwoWayMesh()
    with pytest.raises(ValueError, match="does not divide"):
        helper.run_step({"tokens": torch.zeros((3, 9), dtype=torch.int64)})
    assert int(helper.state["step"]) == 0
