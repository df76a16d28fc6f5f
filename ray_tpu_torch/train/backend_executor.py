"""BackendExecutor: placement, spawn, rank assignment, elastic membership
(twin of ``ray_tpu/train/backend_executor.py``).

Role analog: ``python/ray/train/_internal/backend_executor.py:66`` — create
a placement group (:206), spawn the WorkerGroup (:124), share accelerator
visibility (:286), assign ranks (:356), run training (:436), and restart the
whole group on worker failure (:708). A process group is all-or-nothing
(one dead rank breaks its collectives), so fixed-size failure handling is
always group-restart from the last checkpoint.

Elastic membership (past the reference): with
``ScalingConfig.min_workers`` set, the executor subscribes to the cluster
adapter's node-death fan-out and treats preemption as a MEMBERSHIP EPOCH
change instead of a failure — :meth:`reform` fences the survivors (kills
the old gang: a half-dead SPMD group must never keep stepping), re-probes
the largest placeable world size, re-forms the worker group there,
renumbers ranks 0..n-1, re-splits dataset shards, and resumes every rank
from the last all-ranks-ok checkpoint; :meth:`maybe_expand` runs the same
machine upward at checkpoint boundaries when capacity returns. Each
re-form bumps ``world_epoch`` (surfaced to the user loop via
``TrainContext.world_epoch``/``resumed_from`` — the LR/batch rescale
hooks). Double preemption DURING a re-form converges because every retry
re-probes capacity before placing; the attempt bound turns pathological
churn into the group-restart fallback instead of a livelock.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch import config
import ray_tpu_torch
from ray_tpu_torch.core.exceptions import (ActorDiedError, ActorUnavailableError,
                                     WorkerCrashedError)
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup
from ray_tpu_torch.util.placement_group import placement_group as create_pg, \
    remove_placement_group
from ray_tpu_torch.util.retry import retry_transient

logger = logging.getLogger(__name__)

#: exception classes that mean "the rank's PROCESS is gone" (node loss,
#: OOM-kill, preemption) — distinct from a user exception raised inside
#: the training loop, which must keep its original group-restart
#: semantics (elastically re-forming around a deterministic bug would
#: resume-crash-resume forever)
_DEATH_ERRORS = (ActorDiedError, ActorUnavailableError, WorkerCrashedError,
                 ConnectionError)


class TrainingWorkerError(RuntimeError):
    pass


class TrainingProtocolError(TrainingWorkerError):
    """Ranks desynchronized: some finished while others still report().
    This is a training-loop bug (per-rank ``report()`` counts must match
    — the lockstep contract), not a death; retrying cannot fix it."""


class WorkerDeathError(TrainingWorkerError):
    """One or more ranks' processes died mid-training.

    Carries which ranks died (``dead_ranks``: rank -> exception), any
    node up/down payloads the executor's death subscription recorded
    since the last drain (``node_events``), and the event plane's death
    postmortems (``postmortems``: worker/actor/node death events, exit
    forensics attached) so the error names the blast radius instead of
    a bare "inconsistent worker states".
    """

    def __init__(self, message: str, dead_ranks: Dict[int, BaseException],
                 node_events: Optional[List[dict]] = None,
                 postmortems: Optional[List[dict]] = None):
        super().__init__(message)
        self.dead_ranks = dict(dead_ranks)
        self.node_events = list(node_events or [])
        self.postmortems = list(postmortems or [])


class ElasticWorldSizeError(TrainingWorkerError):
    """Surviving placeable capacity fell below ``min_workers`` — the
    elastic path cannot hold the floor; the trainer falls back to a
    group restart attempt (which waits out the capacity loss through
    ``FailureConfig.max_failures``)."""


#: driver environment forwarded to every train worker
_FORWARDED_ENV_PREFIXES = ("NCCL_", "TORCH_NCCL_")
_FORWARDED_ENV = ("CUDA_LAUNCH_BLOCKING", "PYTORCH_CUDA_ALLOC_CONF",
                  "TORCH_DISTRIBUTED_DEBUG")


def _death_postmortems(limit: int = 200) -> List[dict]:
    """Recent death events (worker/actor/node) from the event plane —
    best-effort: the plane may be disabled or the GCS unreachable, and
    error enrichment must never mask the error it enriches."""
    try:
        from ray_tpu_torch.util import state

        evs = retry_transient(
            lambda: state.list_events(limit=limit),
            attempts=3, delay=0.1, desc="death postmortem fetch")
    except Exception:
        return []
    return [e for e in evs
            if e.get("name") in ("worker_death", "actor_death",
                                 "node_death")]


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
    ):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self._pg = None
        self.worker_group: Optional[WorkerGroup] = None
        # elastic membership state
        self._world_size = scaling_config.num_workers
        self._world_epoch = 0
        self._spec: Optional[Dict[str, Any]] = None   # start_training args
        self._start_ckpt: Optional[str] = None
        self._node_events: List[dict] = []
        self._node_events_lock = threading.Lock()
        self._node_sub_cb: Optional[Callable[[dict], None]] = None

    # -- elastic state -----------------------------------------------------

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def world_epoch(self) -> int:
        return self._world_epoch

    def _subscribe_node_events(self) -> None:
        if self._node_sub_cb is None:
            def _on_node_event(payload: dict) -> None:
                with self._node_events_lock:
                    self._node_events.append(dict(payload))
            self._node_sub_cb = _on_node_event
        try:
            from ray_tpu_torch.util import state

            state.subscribe_node_events(self._node_sub_cb)
        except Exception:
            pass  # single-node / uninitialized: nothing to watch

    def _unsubscribe_node_events(self) -> None:
        if self._node_sub_cb is None:
            return
        try:
            from ray_tpu_torch.util import state

            state.unsubscribe_node_events(self._node_sub_cb)
        except Exception:
            pass

    def drain_node_events(self) -> List[dict]:
        """Node up/down payloads recorded since the last drain."""
        with self._node_events_lock:
            out, self._node_events = self._node_events, []
        return out

    def _placeable_world_size(self) -> int:
        """Largest world size placeable RIGHT NOW in [0, num_workers]:
        sum over alive nodes of how many per-worker resource bundles fit
        in the node's total capacity. Capacity, not availability, is the
        right basis — reform fences (kills) the old gang before placing
        the new one, so the old workers' holdings are about to free. The
        node-view probe rides the GCS, so it absorbs the under-load
        transient-ConnectionError class via the shared retry helper."""
        res = self._scaling.worker_resources()
        requested = self._scaling.num_workers
        try:
            nodes = retry_transient(ray_tpu_torch.nodes, attempts=5,
                                    desc="elastic membership probe")
        except Exception:
            # probe dead: claim the current size so the caller's retry
            # loop (which re-probes) decides, rather than failing here
            return min(self._world_size, requested)
        total = 0
        for n in nodes:
            if not n.get("Alive", True):
                continue
            caps = n.get("Resources") or {}
            fit: Optional[int] = None
            for key, need in res.items():
                if need <= 0:
                    continue
                have = float(caps.get(key, 0.0))
                k = int(have // need)
                fit = k if fit is None else min(fit, k)
            total += fit if fit is not None else 0
        return max(0, min(total, requested))

    # -- lifecycle --------------------------------------------------------

    def start(self, num_workers: Optional[int] = None) -> None:
        n = int(num_workers if num_workers is not None
                else self._scaling.num_workers)
        res = self._scaling.worker_resources()
        strategy = self._scaling.effective_placement_strategy()
        try:
            self._pg = create_pg(
                bundles=[dict(res) for _ in range(n)],
                strategy=strategy,
            )
        except Exception:
            if strategy in ("STRICT_SPREAD", "STRICT_PACK", "SLICE_PACK"):
                # gang semantics were REQUESTED: an infeasible reservation
                # must fail loudly, not silently degrade placement
                raise
            # Resource pool too small for a PACK/SPREAD group (tests with
            # tiny clusters): fall back to unconstrained placement.
            self._pg = None
        self.worker_group = WorkerGroup(n, res, placement_group=self._pg)
        self._world_size = n
        # Readiness barrier with a deadline: an infeasible resource demand
        # (e.g. GPU bundles on a node without enough cards) must fail
        # loudly, not hang the driver forever.
        timeout = float(config.get("worker_start_timeout"))
        # the driver's CUDA / NCCL settings reach the gang before any
        # worker makes its CUDA context (each worker's card is its own
        # CUDA_VISIBLE_DEVICES, set by the worker group)
        env = {k: v for k, v in os.environ.items()
               if k.startswith(_FORWARDED_ENV_PREFIXES)
               or k in _FORWARDED_ENV}
        try:
            ray_tpu_torch.get([w.set_env_vars.remote(env)
                               for w in self.worker_group.workers],
                              timeout=timeout)
        except Exception as e:
            self.shutdown()
            raise RuntimeError(
                f"train workers failed to start within {timeout}s — the "
                f"resource demand {res} x{n} is likely infeasible on this "
                f"cluster (set RTPU_WORKER_START_TIMEOUT to adjust)") from e
        self._backend.on_start(self.worker_group, self._backend_config)
        self._subscribe_node_events()

    def shutdown(self) -> None:
        self._unsubscribe_node_events()
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    def restart(self) -> None:
        self.shutdown()
        self.start()

    # -- elastic membership epochs ----------------------------------------

    def reform(self, checkpoint_path: Optional[str] = None, *,
               reason: str = "shrink", target: Optional[int] = None,
               attempts: int = 8) -> int:
        """Fence -> re-form -> resume: the membership-epoch transition.

        Kills whatever survives of the current gang (a half-dead SPMD
        group must not keep stepping), re-forms the worker group at
        ``target`` (or the largest placeable world size), renumbers
        ranks, re-splits dataset shards, and restarts every rank's
        session from ``checkpoint_path`` with a bumped ``world_epoch``.
        Returns the new world size.

        A failure inside one attempt (double preemption: a node dies
        while the NEW group is placing or starting) falls through to the
        next attempt, which RE-PROBES capacity — the target can only
        ratchet down toward ``min_workers``, so the loop converges
        instead of livelocking; the bound converts pathological churn
        into the caller's group-restart fallback.
        """
        if self._spec is None:
            raise TrainingWorkerError(
                "reform() called before start_training()")
        min_workers = self._scaling.resolved_min_workers()
        requested = self._scaling.num_workers
        prev_size = self._world_size
        last_err: Optional[BaseException] = None
        for attempt in range(max(int(attempts), 1)):
            self.shutdown()   # the fence
            n = target if target is not None else self._placeable_world_size()
            n = max(0, min(int(n), requested))
            target = None     # later attempts re-probe (double preemption)
            if n < min_workers:
                raise ElasticWorldSizeError(
                    f"placeable world size {n} fell below min_workers="
                    f"{min_workers} (requested {requested}) — elastic "
                    f"re-form cannot hold the floor") from last_err
            self._world_epoch += 1
            try:
                self.start(num_workers=n)
                self._launch_sessions(checkpoint_path)
            except Exception as e:  # noqa: BLE001 — re-probe and retry
                last_err = e
                logger.warning(
                    "elastic re-form attempt %d at world size %d failed: "
                    "%r; re-probing", attempt + 1, n, e)
                continue
            try:
                from ray_tpu_torch.util import events

                events.emit("train_world_epoch", epoch=self._world_epoch,
                            world_size=n, prev_world_size=prev_size,
                            reason=reason,
                            checkpoint=checkpoint_path or "")
            except Exception:
                pass
            logger.info("mesh re-formed: world size %d -> %d (epoch %d, "
                        "%s)", prev_size, n, self._world_epoch, reason)
            return n
        raise TrainingWorkerError(
            f"elastic re-form failed after {attempts} attempt(s)"
        ) from last_err

    def maybe_expand(self, checkpoint_path: Optional[str], *,
                     attempts: int = 8) -> Optional[int]:
        """Scale-back-up check, run at checkpoint boundaries: if the
        cluster can place more workers than the current (shrunken) world
        size, re-form upward toward the requested size from the
        just-written all-ranks-ok checkpoint. Returns the new world size
        or None when no expansion happened."""
        requested = self._scaling.num_workers
        if self._world_size >= requested:
            return None
        n = self._placeable_world_size()
        if n <= self._world_size:
            return None
        return self.reform(checkpoint_path, reason="expand", target=n,
                           attempts=attempts)

    # -- training ---------------------------------------------------------

    def start_training(
        self,
        train_fn: Callable,
        loop_config: Dict[str, Any],
        trial_dir: str,
        experiment_name: str,
        checkpoint_path: Optional[str] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ) -> None:
        assert self.worker_group is not None
        # keep the spec: reform() re-launches these sessions at a new
        # world size without the trainer re-plumbing its arguments
        self._spec = {
            "train_fn": train_fn,
            "loop_config": loop_config,
            "trial_dir": trial_dir,
            "experiment_name": experiment_name,
            "datasets": datasets or {},
        }
        self._launch_sessions(checkpoint_path)

    def _launch_sessions(self, checkpoint_path: Optional[str]) -> None:
        assert self.worker_group is not None
        assert self._spec is not None
        spec = self._spec
        self._start_ckpt = checkpoint_path
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        n = len(self.worker_group)
        # dataset ingest (reference DataConfig): each named dataset is
        # streaming_split across ranks; workers pull their shard's blocks.
        # Re-split on every membership epoch: shard count tracks the
        # CURRENT world size, never the requested one.
        shard_lists: Dict[str, Any] = {}
        for name, ds in spec["datasets"].items():
            shard_lists[name] = ds.streaming_split(n)
        trial_dir = spec["trial_dir"]
        refs = []
        for rank, w in enumerate(self.worker_group.workers):
            ctx = TrainContext(
                world_rank=rank,
                world_size=n,
                local_rank=0,
                local_world_size=1,
                node_rank=rank,
                experiment_name=spec["experiment_name"],
                trial_name=os.path.basename(trial_dir),
                trial_dir=trial_dir,
                loop_config=dict(spec["loop_config"]),
                dataset_shards={name: shards[rank]
                                for name, shards in shard_lists.items()},
                world_epoch=self._world_epoch,
                resumed_from=checkpoint_path,
            )
            refs.append(w.start_session.remote(spec["train_fn"], ctx,
                                               checkpoint_path))
        ray_tpu_torch.get(refs)

    def get_next_results(self, timeout: float = 600.0) -> Optional[List[Any]]:
        """Drain one ``report`` from every worker (they move in lockstep).

        Returns a list of (metrics, checkpoint_dir) per rank, or None when
        all workers finished. Raises :class:`WorkerDeathError` (which
        ranks died + node events + event-plane postmortems) when rank
        processes are gone, :class:`TrainingProtocolError` when ranks
        desynchronized (a loop bug, not a death), and re-raises a user
        training exception unchanged.
        """
        assert self.worker_group is not None
        refs = [w.next_result.remote(timeout)
                for w in self.worker_group.workers]
        outs: List[Any] = []
        dead: Dict[int, BaseException] = {}
        for rank, ref in enumerate(refs):
            try:
                outs.append(ray_tpu_torch.get(ref))
            except _DEATH_ERRORS as e:
                dead[rank] = e
                outs.append(None)
            # user training errors propagate unchanged (previous
            # semantics: first raising rank wins; the trainer's restart
            # budget owns those)
        if dead:
            node_events = self.drain_node_events()
            downs = [p for p in node_events if p.get("event") == "down"]
            msg = (f"rank(s) {sorted(dead)} of {len(refs)} died: "
                   + "; ".join(f"rank {r}: {type(e).__name__}: {e}"
                               for r, e in sorted(dead.items())))
            if downs:
                msg += ("; node events: "
                        + ", ".join(
                            f"{(p.get('node_id') or b'').hex()[:8]} "
                            f"down ({p.get('cause', '?')})"
                            if isinstance(p.get("node_id"), bytes)
                            else f"{p.get('node_id', '?')} down "
                                 f"({p.get('cause', '?')})"
                            for p in downs))
            raise WorkerDeathError(msg, dead, node_events=node_events,
                                   postmortems=_death_postmortems())
        kinds = {k for k, _, _ in outs}
        if kinds == {"done"}:
            return None
        if "pending" in kinds:
            raise TimeoutError(
                f"workers did not report within {timeout}s (kinds={kinds})")
        if kinds == {"result"}:
            return [(m, c) for _, m, c in outs]
        if "done" in kinds and "result" in kinds:
            done_ranks = [r for r, (k, _, _) in enumerate(outs)
                          if k == "done"]
            raise TrainingProtocolError(
                f"ranks desynchronized: rank(s) {done_ranks} finished "
                f"while others still report() — per-rank report() counts "
                f"must match (the lockstep contract); this is a "
                f"training-loop bug, not a worker death")
        raise TrainingWorkerError(f"inconsistent worker states: {kinds}")

    def finish_training(self) -> None:
        if self.worker_group is None:
            return
        for w in self.worker_group.workers:
            try:
                ray_tpu_torch.get(w.shutdown_session.remote())
            except Exception:
                pass
