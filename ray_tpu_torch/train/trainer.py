"""Trainers: BaseTrainer → DataParallelTrainer → TorchTrainer (twin of
``ray_tpu/train/trainer.py``).

Role analog: ``python/ray/train/base_trainer.py:111`` (``fit :567``) and
``data_parallel_trainer.py:25``. The training loop drives the
BackendExecutor directly. ``TorchTrainer`` stands where the JAX package's
``JaxTrainer`` stands: workers are actors (a card each with
``use_gpu``); inside the loop the user builds
``TrainLoopHelper.create(..., mesh_config=...)``, whose step all-reduces
the gradients over the ``torch.distributed`` process group that
``TorchConfig`` starts. Tune (``as_trainable``) is not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    WorkerDeathError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)


class TrainingFailedError(RuntimeError):
    pass


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Wrap as a Tune trainable class (reference
        ``base_trainer.py:693 _generate_trainable_cls``): needs the tune
        library, not ported yet."""
        raise NotImplementedError(
            "as_trainable(): the tune library is not ported yet "
            "(ROADMAP.md queue 1 item 8, tune/)")

    def _merged_loop_config(self) -> Dict[str, Any]:
        return {}


class DataParallelTrainer(BaseTrainer):
    """Runs ``train_loop_per_worker`` on every worker of the group."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        super().__init__(scaling_config=scaling_config, run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or BackendConfig()
        self.datasets = datasets or {}

    def _merged_loop_config(self) -> Dict[str, Any]:
        return dict(self.train_loop_config)

    # -- experiment dirs --------------------------------------------------

    def _trial_dir(self) -> Tuple[str, str]:
        name = self.run_config.name or f"TorchTrainer_{uuid.uuid4().hex[:8]}"
        exp_dir = os.path.join(self.run_config.resolved_storage_path(), name)
        trial_dir = os.path.join(exp_dir, f"trial_{uuid.uuid4().hex[:8]}")
        os.makedirs(trial_dir, exist_ok=True)
        return name, trial_dir

    # -- fit --------------------------------------------------------------

    def fit(self) -> Result:
        name, trial_dir = self._trial_dir()
        failure_cfg = self.run_config.failure_config
        attempts = failure_cfg.max_failures + 1
        last_error: Optional[BaseException] = None
        start_ckpt = (self.resume_from_checkpoint.path
                      if self.resume_from_checkpoint else None)

        for attempt in range(max(attempts, 1)):
            executor = BackendExecutor(self.backend_config, self.scaling_config)
            try:
                executor.start()
                result = self._training_run(executor, name, trial_dir,
                                            start_ckpt)
                executor.shutdown()
                return result
            except BaseException as e:  # noqa: BLE001
                last_error = e
                executor.shutdown()
                # resume the retry from the latest persisted checkpoint
                latest = _latest_checkpoint(
                    trial_dir, self.scaling_config.num_workers)
                if latest:
                    start_ckpt = latest
                    try:
                        from ray_tpu_torch.util import events

                        events.emit("checkpoint_resume", trial=name,
                                    checkpoint=latest, attempt=attempt + 1,
                                    error=type(e).__name__)
                    except Exception:
                        pass
        raise TrainingFailedError(
            f"training failed after {attempts} attempt(s)") from last_error

    def _training_run(self, executor: BackendExecutor, name: str,
                      trial_dir: str,
                      start_ckpt: Optional[str]) -> Result:
        executor.start_training(
            self.train_loop_per_worker,
            loop_config=self._merged_loop_config(),
            trial_dir=trial_dir,
            experiment_name=name,
            checkpoint_path=start_ckpt,
            datasets=self.datasets,
        )
        progress_path = os.path.join(trial_dir, "progress.jsonl")
        last_metrics: Dict[str, Any] = {}
        checkpoints: List[Tuple[Dict[str, Any], str]] = []
        elastic = self.scaling_config.elastic
        reform_attempts = \
            self.run_config.failure_config.elastic_reform_attempts
        with open(progress_path, "a") as progress:
            while True:
                try:
                    results = executor.get_next_results()
                except WorkerDeathError as e:
                    if not elastic:
                        raise
                    # elastic shrink: preemption is weather, not a
                    # failure — fence, re-form at the largest placeable
                    # size, resume from the last all-ranks-ok checkpoint
                    # WITHOUT burning a max_failures attempt. If the
                    # floor can't hold (ElasticWorldSizeError) this
                    # raises into fit()'s group-restart fallback.
                    latest = _latest_checkpoint(
                        trial_dir, self.scaling_config.num_workers) \
                        or start_ckpt
                    executor.reform(latest, reason="shrink",
                                    attempts=reform_attempts)
                    continue
                if results is None:
                    break
                rank0_metrics, _ = results[0]
                ckpt_dir = next((c for _, c in results if c), None)
                last_metrics = dict(rank0_metrics)
                last_metrics.setdefault("_timestamp", time.time())
                progress.write(json.dumps(last_metrics, default=str) + "\n")
                progress.flush()
                if ckpt_dir:
                    checkpoints.append((last_metrics, ckpt_dir))
                    self._prune_checkpoints(checkpoints)
                    if elastic:
                        # scale-back-up at the epoch boundary: an
                        # all-ranks-ok checkpoint just landed, so this is
                        # the exact point a bigger gang can resume from
                        executor.maybe_expand(ckpt_dir,
                                              attempts=reform_attempts)
        executor.finish_training()
        # only what this attempt reported: an attempt that resumed and
        # reported none returns no checkpoint, as the reference does
        # (``_latest_checkpoint`` still finds the one it resumed from)
        best = checkpoints[-1][1] if checkpoints else None
        return Result(
            metrics=last_metrics,
            checkpoint=Checkpoint(best) if best else None,
            path=trial_dir,
        )

    def _prune_checkpoints(
            self, checkpoints: List[Tuple[Dict[str, Any], str]]) -> None:
        cfg: CheckpointConfig = self.run_config.checkpoint_config
        if not cfg.num_to_keep or len(checkpoints) <= cfg.num_to_keep:
            return
        if cfg.checkpoint_score_attribute:
            sign = 1 if cfg.checkpoint_score_order == "max" else -1
            checkpoints.sort(
                key=lambda mc: sign * float(
                    mc[0].get(cfg.checkpoint_score_attribute, float("-inf"))))
            doomed = checkpoints[:-cfg.num_to_keep]
            keep = checkpoints[-cfg.num_to_keep:]
        else:
            doomed = checkpoints[:-cfg.num_to_keep]
            keep = checkpoints[-cfg.num_to_keep:]
        for _, path in doomed:
            shutil.rmtree(path, ignore_errors=True)
        checkpoints[:] = keep


class TorchTrainer(DataParallelTrainer):
    """The flagship trainer (the JAX package's ``JaxTrainer``)."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        scaling = kwargs.get("scaling_config") or ScalingConfig()
        backend = torch_config or TorchConfig(mesh=scaling.mesh)
        super().__init__(train_loop_per_worker,
                         backend_config=backend, **kwargs)


def _is_torn_save_dir(path: str) -> bool:
    """A rank dir holding pytree payload files without their
    ``.metadata.json`` completeness marker (or crash-atomic ``.tmp-``
    litter) was killed mid-save — resuming from it would load a torn
    state. Non-pytree checkpoints (user-managed files) carry no marker
    contract and are accepted as-is."""
    try:
        entries = os.listdir(path)
    except OSError:
        return True
    if any(e.startswith(".tmp-") for e in entries):
        return True
    has_pytree = any(e.endswith("_pytree.npz")
                     or e.endswith("_pytree_struct.pkl") for e in entries)
    return has_pytree and ".metadata.json" not in entries


def _latest_checkpoint(trial_dir: str,
                       world_size: int = 1) -> Optional[str]:
    """Newest checkpoint that every rank finished persisting. A gang that
    died mid-persist (chaos: worker SIGKILL during report) leaves a torn
    checkpoint_N — rank dirs missing, partial, or (worst) fully copied
    but unverifiable — so resume accepts ONLY checkpoints carrying every
    rank's ``.rank_R.ok`` marker (written by session.report after the
    copy). Rank-dir presence alone proves nothing: the kill can land
    after the copies and before the first marker.

    Elastic runs change world size between checkpoints, so completeness
    is judged against the ``.world_size`` stamp each checkpoint carries
    (falling back to the caller's ``world_size`` for pre-elastic dirs).
    Rank dirs that LOOK complete but were killed mid ``save_pytree``
    (payload files without the ``.metadata.json`` marker, or temp
    litter) are skipped too — see :func:`_is_torn_save_dir`."""
    if not os.path.isdir(trial_dir):
        return None
    for name in sorted((d for d in os.listdir(trial_dir)
                        if d.startswith("checkpoint_")), reverse=True):
        path = os.path.join(trial_dir, name)
        try:
            entries = os.listdir(path)
        except OSError:
            continue
        ws = max(world_size, 1)
        if ".world_size" in entries:
            try:
                with open(os.path.join(path, ".world_size")) as f:
                    ws = max(int(f.read().strip()), 1)
            except (OSError, ValueError):
                continue  # unreadable stamp: do not trust the dir
        if not all(f".rank_{r}.ok" in entries for r in range(ws)):
            continue
        if any(_is_torn_save_dir(os.path.join(path, d))
               for d in entries if d.startswith("rank_")
               and os.path.isdir(os.path.join(path, d))):
            continue
        return path
    return None
