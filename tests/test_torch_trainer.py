"""Training through the port's framework on the CPU: ``TorchTrainer`` with
its worker gang, session, checkpoints and failure restarts, held against
the JAX package.

- Data parallel: a 2-rank gloo trainer, both ranks handed the same global
  batch, against the JAX ``TrainLoopHelper`` on a ``dp=2`` mesh, 3 steps,
  on a plain batch and on a masked one whose two halves carry different
  token counts. Tolerances as in ``test_torch_train.py``: losses 5e-5,
  grad norms 1e-4 relative, parameters 5e-5.
- A 1-rank trainer against the port's in-process helper (rtol 1e-5), and
  a loop that dies after a checkpoint and resumes from it against an
  uninterrupted run (rtol 1e-6: the same float32 operations on the same
  inputs).
- The resume-point rules (``_is_torn_save_dir``, ``_latest_checkpoint``)
  and the executor's elastic and death-naming logic run in both packages
  on the same inputs, held to the reference tests' expected values.
- Datasets: a 2-rank trainer fed ``datasets={"train": ds}`` (40 rows,
  each rank counts 20 of them, the reference's
  ``test_train.py::test_jax_trainer_dataset_ingest``), whose first attempt
  dies after a checkpoint and whose resumed attempt takes the same batches
  an uninterrupted iteration of the shard gives.
- Loud errors for what is not ported: sharded mesh axes, Tune, TPU slice
  topologies; ``get_dataset_shard``'s errors are the reference's.

One runtime per module, with a small store (64 MB, 16 MB prefaulted) and
one prestarted worker.
"""

import importlib
import json
import os
import sys
import tempfile

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import models as JM
from ray_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ray_tpu.train.train_state import TrainLoopHelper as JaxHelper
from ray_tpu_torch import models as TM
from ray_tpu_torch.parallel import MeshConfig, make_mesh
from ray_tpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                 ScalingConfig, TorchTrainer,
                                 TrainLoopHelper, adamw, load_pytree)

STORE_ENV = {"RTPU_STORE_CAPACITY": str(64 << 20),
             "RTPU_STORE_PREFAULT_BYTES": str(16 << 20),
             "RTPU_POOL_PRESTART": "1"}
LR = 1e-3
STEPS = 3
PRESET = "llama-debug"


@pytest.fixture(scope="module")
def runtime():
    saved = {k: os.environ.get(k) for k in STORE_ENV}
    os.environ.update(STORE_ENV)
    # the train loops below travel by value: workers cannot import tests
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _config(framework):
    return framework.get_config(PRESET).replace(dtype="float32",
                                                param_dtype="float32")


def _weights(seed=0):
    return jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed),
                                                   _config(JM)))


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], f"{prefix}{key}.")
        else:
            yield prefix + key, tree[key]


def _batches():
    """A plain batch, and a masked one: rank 0's two rows keep every
    position, rank 1's only their first 10 (80 against 18 targets)."""
    vocab = _config(JM).vocab_size
    tokens = np.random.default_rng(2).integers(0, vocab, (4, 41)).astype(
        np.int32)
    mask = np.ones((4, 41), np.int32)
    mask[2:, 10:] = 0
    return {"plain": {"tokens": tokens},
            "masked": {"tokens": tokens, "mask": mask}}


def _progress(result):
    """Rank 0's reports, in order, from the trial's ``progress.jsonl``."""
    with open(os.path.join(result.path, "progress.jsonl")) as f:
        return [json.loads(line) for line in f]


def _fit(loop, config, storage, *, workers=1, failures=0):
    return TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers),
        run_config=RunConfig(storage_path=storage,
                             failure_config=FailureConfig(
                                 max_failures=failures))).fit()


# ---------------------------------------------------------------------------
# data parallel against the JAX helper on a dp=2 mesh
# ---------------------------------------------------------------------------

def _dp_loop(config):
    """Per case: the helper from the JAX weights on a dp=2 mesh, STEPS
    steps on the global batch, each reported; the parameters saved as a
    checkpoint with the last report."""
    import tempfile

    import torch

    from ray_tpu_torch import models as TM
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (Checkpoint, TrainLoopHelper, adamw,
                                     save_pytree)

    torch.set_num_threads(1)
    cfg = TM.get_config(config["preset"]).replace(dtype="float32",
                                                  param_dtype="float32")
    for case, batch in config["batches"].items():
        helper = TrainLoopHelper.create(
            lambda: TM.params_from_jax(config["weights"], device="cpu"),
            lambda p, b: TM.loss_and_metrics(p, b, cfg),
            adamw(config["lr"]), device="cpu", mesh_config=config["mesh"])
        for step in range(config["steps"]):
            m = helper.run_step(batch)
            ckpt = None
            if step == config["steps"] - 1:
                d = tempfile.mkdtemp(
                    dir=train.get_context().get_trial_dir())
                save_pytree(helper.state["params"], d)
                ckpt = Checkpoint(d)
            train.report({"case": case, "loss": m["loss"].item(),
                          "grad_norm": m["grad_norm"].item(),
                          "ntokens": m["ntokens"].item()}, checkpoint=ckpt)


@pytest.fixture(scope="module")
def dp_run(runtime, tmp_path_factory):
    """One 2-rank fit over both cases, and the JAX helper's trajectory on
    each: {case: (port reports, port params a rank, JAX metrics, JAX
    params)}."""
    weights = _weights()
    batches = _batches()
    result = _fit(_dp_loop, {"preset": PRESET, "weights": weights,
                             "batches": batches, "lr": LR, "steps": STEPS,
                             "mesh": MeshConfig(dp=2, fsdp=1)},
                  str(tmp_path_factory.mktemp("dp")), workers=2)
    reports = _progress(result)
    ckpts = sorted(d for d in os.listdir(result.path)
                   if d.startswith("checkpoint_"))
    jcfg = _config(JM)
    mesh = jax_make_mesh(JaxMeshConfig(dp=2, fsdp=1),
                         devices=jax.devices()[:2])
    out = {}
    for i, (case, batch) in enumerate(batches.items()):
        helper = JaxHelper.create(
            lambda: jax.tree.map(jnp.asarray, weights), JM.param_axes(jcfg),
            lambda p, b: JM.loss_and_metrics(p, b, jcfg), optax.adamw(LR),
            mesh=mesh)
        want = [jax.tree.map(float, helper.run_step(
            {k: jnp.asarray(v) for k, v in batch.items()}))
            for _ in range(STEPS)]
        ranks = [load_pytree(os.path.join(result.path, ckpts[i], f"rank_{r}"))
                 for r in range(2)]
        out[case] = ([r for r in reports if r["case"] == case], ranks, want,
                     jax.tree.map(np.asarray, helper.state["params"]))
    return out


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_dp_trainer_matches_jax_helper(dp_run, case):
    got, ranks, want, jax_params = dp_run[case]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=5e-5, rtol=0)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
        assert g["ntokens"] == w["ntokens"]
    if case == "masked":
        assert got[0]["ntokens"] == 98          # the global count, 80 + 18
    want_params = dict(_leaves(jax_params))
    for r, params in enumerate(ranks):
        got_params = dict(_leaves(params))
        assert set(got_params) == set(want_params)
        for key, t in got_params.items():
            np.testing.assert_allclose(t.numpy(), want_params[key],
                                       atol=5e-5, rtol=0,
                                       err_msg=f"rank {r} {key}")


def test_dp_ranks_hold_the_same_parameters(dp_run):
    """The replicas stay equal: the grads they apply are the same sum."""
    for case in dp_run:
        rank0, rank1 = dp_run[case][1]
        for (k0, a), (k1, b) in zip(_leaves(rank0), _leaves(rank1)):
            assert k0 == k1 and torch.equal(a, b), (case, k0)


# ---------------------------------------------------------------------------
# one rank against the in-process helper; kill and resume
# ---------------------------------------------------------------------------

def _resume_loop(config):
    """Steps over per-step batches; a checkpoint after ``ckpt_step``; on the
    first attempt the process exits after reporting ``die_after``. A
    restarted attempt loads the checkpoint it is handed and goes on. The
    final state is saved into the trial dir as ``final`` (not reported)."""
    import os
    import tempfile
    import time

    import numpy as np
    import torch

    from ray_tpu_torch import models as TM
    from ray_tpu_torch import train
    from ray_tpu_torch.train import (Checkpoint, TrainLoopHelper, adamw,
                                     load_pytree, save_pytree)

    torch.set_num_threads(1)
    cfg = TM.get_config(config["preset"]).replace(dtype="float32",
                                                  param_dtype="float32")
    helper = TrainLoopHelper.create(
        lambda: TM.params_from_jax(config["weights"], device="cpu"),
        lambda p, b: TM.loss_and_metrics(p, b, cfg), adamw(config["lr"]),
        device="cpu")
    start = 0
    resumed = train.get_checkpoint()
    if resumed is not None:
        tree = load_pytree(os.path.join(resumed.path, "rank_0"))
        helper.restore(tree)
        start = int(tree["step"])
    marker = os.path.join(train.get_context().get_trial_dir(), "died")
    for step in range(start, config["steps"]):
        rng = np.random.default_rng(100 + step)
        m = helper.run_step({"tokens": rng.integers(
            0, cfg.vocab_size, (2, 33)).astype(np.int64)})
        trial_dir = train.get_context().get_trial_dir()
        ckpt = None
        if step + 1 == config["ckpt_step"]:
            d = tempfile.mkdtemp(dir=trial_dir)
            helper.save_checkpoint_async(d).wait()
            ckpt = Checkpoint(d)
        if step + 1 == config["steps"]:
            save_pytree(helper.checkpoint_tree(),
                        os.path.join(trial_dir, "final"))
        train.report({"step": step + 1, "loss": m["loss"].item(),
                      "resumed": resumed is not None}, checkpoint=ckpt)
        if (config["die_after"] == step + 1
                and not os.path.exists(marker)):
            # report() returns once the driver took the result, while the
            # worker's reply carrying it may still be on its way
            time.sleep(1.0)
            open(marker, "w").close()
            os._exit(1)


def _in_process(weights, steps):
    cfg = _config(TM)
    helper = TrainLoopHelper.create(
        lambda: TM.params_from_jax(weights, device="cpu"),
        lambda p, b: TM.loss_and_metrics(p, b, cfg), adamw(LR),
        device="cpu")
    losses = []
    for step in range(steps):
        rng = np.random.default_rng(100 + step)
        m = helper.run_step({"tokens": rng.integers(
            0, cfg.vocab_size, (2, 33)).astype(np.int64)})
        losses.append(m["loss"].item())
    return losses, helper


def test_one_rank_trainer_matches_in_process_helper(runtime, tmp_path):
    weights = _weights(seed=3)
    result = _fit(_resume_loop, {"preset": PRESET, "weights": weights,
                                 "lr": LR, "steps": 4, "ckpt_step": 0,
                                 "die_after": 0}, str(tmp_path))
    got = [r["loss"] for r in _progress(result)]
    want, _ = _in_process(weights, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert result.error is None and result.checkpoint is None


def test_kill_and_resume_matches_uninterrupted_run(runtime, tmp_path):
    """The first attempt checkpoints after step 3 and dies after step 4; the
    restarted gang resumes from step 3's checkpoint (parameters, AdamW
    moments and steps) and ends where an uninterrupted run ends. The
    resumed attempt reported no checkpoint, so the result has none, as in
    the reference; the latest complete one is still step 3's."""
    weights = _weights(seed=4)
    result = _fit(_resume_loop, {"preset": PRESET, "weights": weights,
                                 "lr": LR, "steps": 6, "ckpt_step": 3,
                                 "die_after": 4}, str(tmp_path),
                  failures=1)
    reports = _progress(result)
    assert [r["step"] for r in reports] == [1, 2, 3, 4, 4, 5, 6]
    assert [r["resumed"] for r in reports] == [False] * 4 + [True] * 3
    want, helper = _in_process(weights, 6)
    by_step = {r["step"]: r["loss"] for r in reports}
    np.testing.assert_allclose([by_step[s] for s in range(1, 7)], want,
                               rtol=1e-6)
    from ray_tpu_torch.train.trainer import _latest_checkpoint

    assert result.checkpoint is None
    latest = _latest_checkpoint(result.path, 1)
    assert latest == os.path.join(result.path, "checkpoint_000000")
    assert int(load_pytree(os.path.join(latest, "rank_0"))["step"]) == 3
    final = load_pytree(os.path.join(result.path, "final"))
    assert int(final["step"]) == 6
    for (key, got), (_, ref) in zip(_leaves(final["params"]),
                                    _leaves(helper.state["params"])):
        np.testing.assert_allclose(got.numpy(), ref.detach().numpy(),
                                   rtol=1e-6, atol=0, err_msg=key)


# ---------------------------------------------------------------------------
# datasets: get_dataset_shard -> iter_torch_batches, killed and resumed
# ---------------------------------------------------------------------------

def _dataset_loop(config):
    """Each rank walks its shard in batches of 5, reporting each batch's
    ids and its running count; after batch 2 a checkpoint of (batches,
    count, total). On the first attempt rank 0's process exits after batch
    3; the resumed attempt skips the batches its checkpoint took. Each
    rank writes what it saw into the trial dir at the end."""
    import json
    import os
    import tempfile
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train import Checkpoint

    ctx = train.get_context()
    rank, trial_dir = ctx.get_world_rank(), ctx.get_trial_dir()
    start, count, total = 0, 0, 0.0
    resumed = train.get_checkpoint()
    if resumed is not None:
        with open(os.path.join(resumed.path, f"rank_{rank}",
                               "state.json")) as f:
            start, count, total = json.load(f)
    marker = os.path.join(trial_dir, "died")
    shard = train.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_torch_batches(
            batch_size=5, device="cpu", dtypes={"x": torch.float64})):
        if i < start:
            continue
        ids = batch["x"].tolist()
        count += len(ids)
        total += sum(ids)
        ckpt = None
        if i + 1 == config["ckpt_batch"]:
            d = tempfile.mkdtemp(dir=trial_dir)
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump([i + 1, count, total], f)
            ckpt = Checkpoint(d)
        train.report({"batch": i + 1, "ids": ids, "count": count,
                      "total": total, "resumed": resumed is not None},
                     checkpoint=ckpt)
        if (rank == 0 and i + 1 == config["die_after"]
                and not os.path.exists(marker)):
            time.sleep(1.0)
            open(marker, "w").close()
            os._exit(1)
    with open(os.path.join(trial_dir, f"seen_{rank}.json"), "w") as f:
        json.dump({"count": count, "total": total}, f)


def test_dataset_ingest_two_ranks_resumes_on_the_same_batches(runtime,
                                                              tmp_path):
    """``datasets={"train": ds}`` over 40 rows in 4 blocks: each rank's
    shard is ``streaming_split(2)`` (2 blocks, 20 rows), and each rank
    counts 20 (the reference's ``test_jax_trainer_dataset_ingest``). Rank
    0 dies after batch 3, after a checkpoint at batch 2: the restarted
    gang resumes at batch 3 and rank 0 reports, for every batch, the ids
    an uninterrupted iteration of its shard gives."""
    from ray_tpu_torch import data as tdata

    ds = tdata.from_items([{"x": float(i)} for i in range(40)],
                          parallelism=4)
    result = TorchTrainer(
        _dataset_loop, train_loop_config={"ckpt_batch": 2, "die_after": 3},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
        datasets={"train": ds}).fit()
    assert result.error is None
    reports = _progress(result)
    assert [r["batch"] for r in reports] == [1, 2, 3, 3, 4]
    assert [r["resumed"] for r in reports] == [False] * 3 + [True] * 2
    want = [b["x"].tolist() for b in ds.streaming_split(2)[0]
            .iter_torch_batches(batch_size=5, device="cpu",
                                dtypes={"x": torch.float64})]
    assert len(want) == 4
    for r in reports:
        assert r["ids"] == want[r["batch"] - 1], r
    assert result.metrics["count"] == 20
    seen = []
    for rank in range(2):
        with open(os.path.join(result.path, f"seen_{rank}.json")) as f:
            seen.append(json.load(f))
    assert [s["count"] for s in seen] == [20, 20]
    assert sum(s["total"] for s in seen) == sum(range(40))
    assert seen[0]["total"] == sum(sum(b) for b in want)


# ---------------------------------------------------------------------------
# Result.checkpoint after a resume, in both packages on the same script
# ---------------------------------------------------------------------------

class _ScriptedExecutor:
    """A ``BackendExecutor`` whose gang is a script: per attempt, the steps
    it reports (each ``(step, checkpoint?)``) and whether it then dies. A
    reported checkpoint is written complete (world size stamp, rank marker,
    rank dir) as the session's copy leaves it."""

    script = []
    started_from = []

    def __init__(self, backend_config, scaling_config):
        self._attempt = len(self.started_from)

    def start(self, num_workers=None):
        pass

    def shutdown(self):
        pass

    def start_training(self, train_fn, *, loop_config, trial_dir,
                       experiment_name, checkpoint_path, datasets):
        self.started_from.append(checkpoint_path and
                                 os.path.relpath(checkpoint_path, trial_dir))
        steps, dies = self.script[self._attempt]
        self._results = []
        for step, ckpt in steps:
            path = None
            if ckpt:
                path = os.path.join(trial_dir, f"checkpoint_{step:06d}")
                os.makedirs(os.path.join(path, "rank_0"))
                for name, text in ((".world_size", "1"), (".rank_0.ok", "")):
                    with open(os.path.join(path, name), "w") as f:
                        f.write(text)
            self._results.append([({"step": step}, path)])
        self._dies = dies

    def get_next_results(self):
        if self._results:
            return self._results.pop(0)
        if self._dies:
            raise RuntimeError("worker died")
        return None

    def finish_training(self):
        pass


RESUME_SCRIPTS = {
    # checkpoint after step 3, death after step 4, the retry reports none
    "resumed_reports_none": ([([(1, 0), (2, 0), (3, 1), (4, 0)], True),
                              ([(4, 0), (5, 0), (6, 0)], False)], False),
    # the retry reports a checkpoint of its own
    "resumed_reports_one": ([([(1, 0), (2, 1), (3, 0)], True),
                             ([(3, 0), (4, 1), (5, 0)], False)], False),
    # resume_from_checkpoint= given, and nothing reported
    "given_reports_none": ([([(1, 0), (2, 0)], False)], True),
}


@pytest.mark.parametrize("case", sorted(RESUME_SCRIPTS))
def test_resumed_result_checkpoint_matches_reference(case, tmp_path,
                                                     monkeypatch):
    """Both trainers run the same kill-and-resume script: their
    ``Result.checkpoint``, the checkpoints each attempt started from, and
    ``_latest_checkpoint`` of the trial are the same."""
    script, given = RESUME_SCRIPTS[case]
    seen = {}
    for mod in _trainers():
        pkg = mod.__name__.split(".")[0]
        train_mod = importlib.import_module(f"{pkg}.train")
        executor = type("Executor", (_ScriptedExecutor,),
                        {"script": script, "started_from": []})
        monkeypatch.setattr(mod, "BackendExecutor", executor)
        start = None
        if given:
            start = tmp_path / pkg / "given"
            start.mkdir(parents=True)
            start = train_mod.Checkpoint(str(start))
        trainer_cls = (mod.JaxTrainer if pkg == "ray_tpu"
                       else mod.TorchTrainer)
        result = trainer_cls(
            lambda config: None,
            scaling_config=train_mod.ScalingConfig(num_workers=1),
            run_config=train_mod.RunConfig(
                storage_path=str(tmp_path / pkg),
                failure_config=train_mod.FailureConfig(
                    max_failures=len(script) - 1)),
            resume_from_checkpoint=start).fit()
        rel = (None if result.checkpoint is None
               else os.path.relpath(result.checkpoint.path, result.path))
        latest = mod._latest_checkpoint(result.path, 1)
        seen[pkg] = dict(checkpoint=rel,
                         latest=latest and os.path.relpath(latest,
                                                           result.path),
                         started_from=executor.started_from)
    assert seen["ray_tpu_torch"] == seen["ray_tpu"]
    want = {"resumed_reports_none": None,
            "resumed_reports_one": "checkpoint_000004",
            "given_reports_none": None}[case]
    assert seen["ray_tpu_torch"]["checkpoint"] == want


# ---------------------------------------------------------------------------
# the resume point, in both packages on the same trees
# ---------------------------------------------------------------------------

def _trainers():
    return [importlib.import_module(f"{p}.train.trainer")
            for p in ("ray_tpu", "ray_tpu_torch")]


def _mk(root, name, ws=None, oks=(), ranks=(), torn_rank=None):
    d = root / name
    d.mkdir()
    if ws is not None:
        (d / ".world_size").write_text(str(ws))
    for r in oks:
        (d / f".rank_{r}.ok").write_text("")
    for r in ranks:
        (d / f"rank_{r}").mkdir()
    if torn_rank is not None:
        np.savez(d / f"rank_{torn_rank}" / "state_pytree.npz")
    return str(d)


def test_latest_checkpoint_agrees_with_reference(tmp_path):
    """The tree of ``tests/test_train.py``: stamps, missing rank markers,
    a torn rank dir, an unreadable stamp, pre-elastic dirs."""

    def latest():
        answers = {m.__name__: m._latest_checkpoint(str(tmp_path), 2)
                   for m in _trainers()}
        assert len(set(answers.values())) == 1, answers
        return answers.popitem()[1]

    assert latest() is None
    _mk(tmp_path, "checkpoint_000000", ws=2, oks=(0, 1), ranks=(0, 1))
    c1 = _mk(tmp_path, "checkpoint_000001", ws=1, oks=(0,), ranks=(0,))
    assert latest() == c1
    _mk(tmp_path, "checkpoint_000002", ws=2, oks=(0,), ranks=(0, 1))
    assert latest() == c1
    c3 = _mk(tmp_path, "checkpoint_000003", ws=2, oks=(0, 1), ranks=(0, 1))
    assert latest() == c3
    _mk(tmp_path, "checkpoint_000004", ws=1, oks=(0,), ranks=(0,),
        torn_rank=0)
    assert latest() == c3
    c5 = _mk(tmp_path, "checkpoint_000005", oks=(0, 1), ranks=(0, 1))
    (tmp_path / "checkpoint_000005" / ".world_size").write_text("junk")
    assert latest() == c3
    os.remove(tmp_path / "checkpoint_000005" / ".world_size")
    assert latest() == c5


def test_torn_save_dir_agrees_with_reference(tmp_path):
    """Complete saves of both packages, then each torn shape: a missing
    marker, ``.tmp-`` litter; a user-managed dir has no contract."""
    from ray_tpu.train.checkpoint import save_pytree as jax_save
    from ray_tpu_torch.train.checkpoint import save_pytree

    def torn(path):
        answers = {m._is_torn_save_dir(str(path)) for m in _trainers()}
        assert len(answers) == 1, path
        return answers.pop()

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    save_pytree({"w": torch.ones(3)}, str(ours))
    jax_save({"w": np.ones(3, np.float32)}, str(theirs))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for d in (ours, theirs):
        assert not torn(d)
        os.remove(d / ".metadata.json")
        assert torn(d)
    save_pytree({"w": torch.ones(3)}, str(ours))
    (ours / ".tmp-state_pytree.npz").write_bytes(b"partial")
    assert torn(ours)
    user = tmp_path / "user"
    user.mkdir()
    (user / "model.pkl").write_bytes(b"x")
    assert not torn(user)
    assert torn(tmp_path / "missing")


# ---------------------------------------------------------------------------
# the executor's elastic and death logic, in both packages
# ---------------------------------------------------------------------------

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _stub_executor(pkg, monkeypatch, probes, fail_first_starts=0):
    """The executor of ``pkg`` with placement and spawn stubbed, as
    ``tests/test_train.py`` stubs it."""
    be = importlib.import_module(f"{pkg}.train.backend_executor")
    config = importlib.import_module(f"{pkg}.train.config")
    backend = importlib.import_module(f"{pkg}.train.backend")
    ex = be.BackendExecutor(backend.BackendConfig(),
                            config.ScalingConfig(num_workers=4,
                                                 min_workers=1))
    ex._spec = {"train_fn": lambda: None, "loop_config": {},
                "trial_dir": "/tmp/x", "experiment_name": "x",
                "datasets": {}}
    calls = {"starts": [], "launches": [], "shutdowns": 0}
    it = iter(probes)
    monkeypatch.setattr(ex, "_placeable_world_size", lambda: next(it))
    monkeypatch.setattr(ex, "shutdown",
                        lambda: calls.__setitem__(
                            "shutdowns", calls["shutdowns"] + 1))

    def fake_start(num_workers=None):
        calls["starts"].append(num_workers)
        if len(calls["starts"]) <= fail_first_starts:
            raise ConnectionError("node lost during placement")
        ex._world_size = num_workers

    monkeypatch.setattr(ex, "start", fake_start)
    monkeypatch.setattr(ex, "_launch_sessions",
                        lambda ckpt: calls["launches"].append(ckpt))
    return be, ex, calls


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reform_double_preemption_converges(pkg, monkeypatch):
    _, ex, calls = _stub_executor(pkg, monkeypatch, probes=[3, 2],
                                  fail_first_starts=1)
    assert ex.reform("/ckpt/5", reason="shrink") == 2
    assert calls["starts"] == [3, 2]
    assert calls["launches"] == ["/ckpt/5"]
    assert ex.world_epoch == 2
    assert ex.world_size == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reform_floor_and_attempt_bound(pkg, monkeypatch):
    be, ex, _ = _stub_executor(pkg, monkeypatch, probes=[0])
    with pytest.raises(be.ElasticWorldSizeError):
        ex.reform(None)
    _, ex2, calls2 = _stub_executor(pkg, monkeypatch, probes=[3, 3, 3],
                                    fail_first_starts=3)
    with pytest.raises(be.TrainingWorkerError) as ei:
        ex2.reform(None, attempts=3)
    assert not isinstance(ei.value, be.ElasticWorldSizeError)
    assert len(calls2["starts"]) == 3
    backend = importlib.import_module(f"{pkg}.train.backend")
    config = importlib.import_module(f"{pkg}.train.config")
    with pytest.raises(be.TrainingWorkerError):
        be.BackendExecutor(backend.BackendConfig(),
                           config.ScalingConfig(num_workers=2)).reform(None)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_maybe_expand_only_when_capacity_returns(pkg, monkeypatch):
    _, ex, calls = _stub_executor(pkg, monkeypatch, probes=[2, 4])
    ex._world_size = 2
    assert ex.maybe_expand("/ckpt/1") is None
    assert calls["starts"] == []
    assert ex.maybe_expand("/ckpt/2") == 4
    assert calls["starts"] == [4]
    assert calls["launches"] == ["/ckpt/2"]
    ex._world_size = 4
    assert ex.maybe_expand("/ckpt/3") is None


class _FakeWorkers:
    """worker_group stand-in: each worker's next_result.remote() hands
    back its outcome, which the patched ``get`` resolves (or raises)."""

    class _W:
        def __init__(self, outcome):
            class _M:
                def __init__(self, outcome):
                    self._o = outcome

                def remote(self, timeout):
                    return self._o

            self.next_result = _M(outcome)

    def __init__(self, outcomes):
        self.workers = [self._W(o) for o in outcomes]


def _executor_with(pkg, monkeypatch, outcomes):
    be = importlib.import_module(f"{pkg}.train.backend_executor")
    config = importlib.import_module(f"{pkg}.train.config")
    backend = importlib.import_module(f"{pkg}.train.backend")
    ex = be.BackendExecutor(backend.BackendConfig(),
                            config.ScalingConfig(num_workers=2))
    ex.worker_group = _FakeWorkers(outcomes)

    def get(ref, **kw):
        if isinstance(ref, BaseException):
            raise ref
        return ref

    monkeypatch.setattr(importlib.import_module(pkg), "get", get)
    return be, ex


@pytest.mark.parametrize("pkg", PACKAGES)
def test_get_next_results_names_dead_ranks_and_node_events(pkg,
                                                           monkeypatch):
    exc = importlib.import_module(f"{pkg}.core.exceptions")
    be, ex = _executor_with(pkg, monkeypatch, [
        ("result", {"step": 1}, None),
        exc.ActorDiedError("actor's node died")])
    ex._node_events.append({"event": "down", "node_id": "deadbeef",
                            "cause": "heartbeat_timeout"})
    with pytest.raises(be.WorkerDeathError) as ei:
        ex.get_next_results()
    e = ei.value
    assert sorted(e.dead_ranks) == [1]
    assert isinstance(e.dead_ranks[1], exc.ActorDiedError)
    assert e.node_events and e.node_events[0]["event"] == "down"
    assert "rank(s) [1]" in str(e) and "heartbeat_timeout" in str(e)
    assert ex.drain_node_events() == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_get_next_results_lockstep_protocol_error(pkg, monkeypatch):
    be, ex = _executor_with(pkg, monkeypatch, [
        ("done", None, None), ("result", {"step": 3}, None)])
    with pytest.raises(be.TrainingProtocolError) as ei:
        ex.get_next_results()
    assert not isinstance(ei.value, be.WorkerDeathError)
    assert "rank(s) [0]" in str(ei.value)
    ex.worker_group = _FakeWorkers([ValueError("loop bug"),
                                    ("result", {}, None)])
    with pytest.raises(ValueError, match="loop bug"):
        ex.get_next_results()


# ---------------------------------------------------------------------------
# loud errors for what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,item", [("fsdp", "item 5"), ("tp", "item 5"),
                                       ("sp", "item 7"), ("ep", "item 7"),
                                       ("pp", "item 7")])
def test_sharded_mesh_axes_raise(axis, item):
    sizes = {axis: 2} if axis == "fsdp" else {axis: 2, "fsdp": 1}
    with pytest.raises(NotImplementedError, match=f"queue 1 {item}"):
        make_mesh(MeshConfig(**sizes))


def test_default_mesh_is_one_rank_with_the_reference_axes():
    from ray_tpu_torch.parallel import mesh_sizes

    sizes = mesh_sizes(make_mesh())
    assert list(sizes) == list(JaxMeshConfig().axis_order)
    assert set(sizes.values()) == {1}


def test_get_dataset_shard_errors_match_reference():
    """Outside a session, and for a name the trainer was not given, the
    port raises the reference's errors."""
    from ray_tpu.train import session as jsession
    from ray_tpu_torch.train import get_dataset_shard, session

    with pytest.raises(RuntimeError, match="outside a training session"):
        get_dataset_shard()
    errors = []
    for mod in (jsession, session):
        s = mod._Session(lambda: None, mod.TrainContext(
            trial_dir=tempfile.mkdtemp(), dataset_shards={"eval": object()}))
        mod._init_session(s)
        try:
            with pytest.raises(KeyError) as info:
                mod.get_dataset_shard("train")
            errors.append(str(info.value))
        finally:
            mod._shutdown_session()
    assert errors[0] == errors[1]
    assert "no dataset 'train'" in errors[1] and "['eval']" in errors[1]


def test_as_trainable_and_topology_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        TorchTrainer(lambda: None).as_trainable()
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        ScalingConfig(topology="v5e-16")
    assert ScalingConfig(use_gpu=True).worker_resources() == {"CPU": 1.0,
                                                              "GPU": 1.0}


# ---------------------------------------------------------------------------
# step telemetry
# ---------------------------------------------------------------------------

def _record(cls):
    st = cls("parity")
    st.peak_flops = 1e13
    st.record_step(0.5, tokens=1000, flops=2e12, loss=2.5)
    st.record_step(0.25, tokens=1000, flops=2e12, loss=2.0, steps=2)
    st.record_compile(1.5)
    st.on_report({"loss": 1.0, "tokens": 10})
    return st


def test_step_telemetry_matches_reference():
    """The same ``record_step`` / ``record_compile`` inputs give the same
    snapshot and land in metrics of the same names."""
    from ray_tpu.train.telemetry import StepTelemetry as JaxTelemetry
    from ray_tpu_torch.train import StepTelemetry

    want, got = _record(JaxTelemetry), _record(StepTelemetry)
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["mfu"] == 0.8
    assert ({k: m.name for k, m in got._metrics().items()}
            == {k: m.name for k, m in want._metrics().items()})


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.4e12),
                                       ("NVIDIA A10G", None)])
def test_mfu_is_none_on_a_card_the_table_does_not_know(name, peak,
                                                       monkeypatch):
    from ray_tpu_torch.accelerators import gpu
    from ray_tpu_torch.train import StepTelemetry, telemetry

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    monkeypatch.setattr(telemetry, "_card_in_use", lambda: True)
    assert gpu.peak_flops() == peak
    st = StepTelemetry("mfu")
    st.record_step(1.0, flops=peak or 1e12)
    assert st.snapshot().get("mfu") == (1.0 if peak else None)


def test_telemetry_reads_no_card_in_a_process_without_one():
    """Off the card MFU and the memory gauges are absent, and asking made
    no CUDA context."""
    from ray_tpu_torch.train import StepTelemetry, telemetry

    st = StepTelemetry("cpu")
    st.record_step(1.0, flops=1e12)
    assert "mfu" not in st.snapshot()
    assert telemetry.device_memory() is None and st.sample_hbm() is None
    assert not torch.cuda.is_initialized()
