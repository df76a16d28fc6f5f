"""Worker-side training session: ``report``/``get_context`` API (twin of
``ray_tpu/train/session.py``).

Role analog: ``_TrainSession`` (``python/ray/train/_internal/session.py:110``)
— the user's ``train_loop_per_worker`` runs on a daemon thread inside the
worker actor; ``ray_tpu_torch.train.report(metrics, checkpoint=)`` enqueues results
that the driver drains via actor calls. ``report`` is also a **barrier** in
spirit: training is SPMD, so every worker reports the same step
count in lockstep.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class TrainContext:
    """What the user can ask about their worker (reference
    ``ray.train.get_context()``)."""

    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = "default"
    trial_name: str = "trial"
    trial_dir: str = "."
    trial_id: str = "0"
    loop_config: Dict[str, Any] = field(default_factory=dict)
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    # elastic membership: the epoch bumps every time the gang is
    # re-formed at a new world size (preemption shrink / capacity-restore
    # expand); ``resumed_from`` names the checkpoint this session resumed
    # from, or None on a cold start. The LR/batch rescale contract: the
    # user loop reads get_world_size() EVERY session (never caches it
    # across restarts) and rescales its
    # per-host batch / learning rate from it, so global batch semantics
    # survive world-size changes.
    world_epoch: int = 0
    resumed_from: Optional[str] = None

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_epoch(self) -> int:
        return self.world_epoch

    def get_resumed_from(self) -> Optional[str]:
        return self.resumed_from

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_trial_id(self) -> str:
        return self.trial_id


class _Session:
    """Per-process singleton holding the running train thread."""

    def __init__(
        self,
        train_fn: Callable[[], Any],
        context: TrainContext,
        starting_checkpoint: Optional[Checkpoint] = None,
    ):
        self.context = context
        self.starting_checkpoint = starting_checkpoint
        self.result_queue: "queue.Queue" = queue.Queue()
        self.continue_event = threading.Event()
        self.error: Optional[BaseException] = None
        self.finished = False
        # Seed past any checkpoint_* already in the trial dir: after a group
        # restart a fresh session starting at 0 would write checkpoints that
        # name-sort BELOW the pre-crash ones, so every later resume would
        # pick the stale pre-crash checkpoint and repeat work.
        self._checkpoint_seq = self._next_checkpoint_seq(context.trial_dir)

        def runner():
            try:
                train_fn()
                self.result_queue.put(("done", None, None))
            except BaseException as e:  # noqa: BLE001 — propagated to driver
                self.error = e
                self.result_queue.put(("error", e, None))

        self.thread = threading.Thread(target=runner, daemon=True,
                                       name="train_loop")

    @staticmethod
    def _next_checkpoint_seq(trial_dir: str) -> int:
        try:
            seqs = [int(name[len("checkpoint_"):])
                    for name in os.listdir(trial_dir)
                    if name.startswith("checkpoint_")
                    and name[len("checkpoint_"):].isdigit()]
        except OSError:
            return 0
        return max(seqs, default=-1) + 1

    def start(self):
        self.thread.start()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        ckpt_path = None
        if checkpoint is not None:
            # Persist the worker's checkpoint into the trial dir so it
            # outlives the worker process (StorageContext analog,
            # reference train/_internal/storage.py:349).
            seq = self._checkpoint_seq
            self._checkpoint_seq += 1
            dest = os.path.join(
                self.context.trial_dir,
                f"checkpoint_{seq:06d}",
                f"rank_{self.context.world_rank}",
            )
            if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                checkpoint.to_directory(dest)
            ckpt_path = os.path.dirname(dest)
            # completion marker, written AFTER the rank dir landed: a gang
            # killed mid-persist leaves a torn checkpoint_N, and resume
            # (trainer._latest_checkpoint) must skip it — only checkpoints
            # marked by every rank are resumable
            marker = os.path.join(
                ckpt_path, f".rank_{self.context.world_rank}.ok")
            with open(marker, "w"):
                pass
            # world-size stamp: elastic resume must know how many rank
            # markers make this checkpoint complete — the CURRENT gang's
            # size is no longer a valid guess once world size can change
            # between checkpoints. Every rank writes the same value
            # (idempotent); written after the rank dir like the marker.
            ws_path = os.path.join(ckpt_path, ".world_size")
            if not os.path.exists(ws_path):
                tmp = ws_path + f".tmp.{self.context.world_rank}"
                with open(tmp, "w") as f:
                    f.write(str(self.context.world_size))
                os.replace(tmp, ws_path)
        # step telemetry: each report is one user-loop step — inter-report
        # wall time + well-known keys land in the metrics registry (and
        # federate to the head /metrics); never fails the report
        try:
            from ray_tpu_torch.train import telemetry

            telemetry.on_report(metrics)
        except Exception:
            pass
        self.result_queue.put(("result", dict(metrics), ckpt_path))
        # Block until the driver consumed the result — keeps workers in
        # lockstep at report granularity and bounds queue memory.
        self.continue_event.wait()
        self.continue_event.clear()

    def next_result(self, timeout: Optional[float] = None):
        try:
            kind, payload, ckpt = self.result_queue.get(timeout=timeout)
        except queue.Empty:
            return ("pending", None, None)
        if kind == "result":
            self.continue_event.set()
        return (kind, payload, ckpt)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.starting_checkpoint


_session: Optional[_Session] = None


def _init_session(session: _Session) -> None:
    global _session
    _session = session


def _shutdown_session() -> None:
    global _session
    _session = None


def get_session() -> Optional[_Session]:
    return _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) from the train loop."""
    if _session is None:
        raise RuntimeError(
            "ray_tpu_torch.train.report() called outside a training session")
    _session.report(metrics, checkpoint)


def get_context() -> TrainContext:
    if _session is None:
        return TrainContext()
    return _session.context


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, if the run was restored."""
    if _session is None:
        return None
    return _session.get_checkpoint()


def get_dataset_shard(name: str = "train"):
    """This worker's DataIterator for the named dataset (reference
    ``ray.train.get_dataset_shard``; sharding via ``streaming_split``)."""
    if _session is None:
        raise RuntimeError(
            "get_dataset_shard() called outside a training session")
    shard = _session.context.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset {name!r}; pass datasets={{{name!r}: ds}} to the "
            f"trainer (have {sorted(_session.context.dataset_shards)})")
    return shard
