"""DeploymentHandle + Router: the request path.

Role analog: ``python/ray/serve/handle.py:711`` → ``Router``
(``router.py:312``) → ``PowerOfTwoChoicesReplicaScheduler``
(``replica_scheduler/pow_2_scheduler.py:49``). Routing load comes from the
RUNTIME's actor queue depths (queued + in-flight calls per replica actor) —
the authoritative version of the reference's replica-reported queue-length
cache (``replica_scheduler/common.py:218``), shared by every handle in the
cluster instead of per-handle local guesses; a short-TTL cache plus local
in-flight deltas keeps the hot path cheap. Streaming responses
(``handle.options(stream=True)``) ride ``num_returns="streaming"`` actor
calls and yield results as the replica produces them (reference
``handle.py`` streaming / ``proxy.py`` chunked responses).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class _AppRefSentinel:
    """Placeholder for a composed sub-application in init args."""

    name: str


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef (reference
    ``DeploymentResponse``). ``retry`` (set by the issuing handle) re-routes
    the request to another replica when this one died before replying —
    the router half of Serve's replica fault tolerance (the controller
    replaces the dead replica; see ``ServeController.report_replica_death``)."""

    def __init__(self, ref, on_done=None, retry=None):
        self._ref = ref
        self._on_done = on_done
        self._retry = retry
        self._result = None
        self._done = False

    def result(self, timeout_s: Optional[float] = None):
        import time

        import ray_tpu_torch
        from ray_tpu_torch.core.exceptions import ActorDiedError, GetTimeoutError

        if not self._done:
            # ONE deadline across every retry: a re-route must not restart
            # the caller's timeout (each attempt gets what remains)
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            while True:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                try:
                    self._result = ray_tpu_torch.get(self._ref, timeout=remaining)
                    break
                except ActorDiedError:
                    if self._retry is None:
                        raise
                    # reports the death, waits for a live replica, re-issues;
                    # raises (ending the loop) when retries are exhausted —
                    # the retry closes the in-flight accounting itself, so
                    # neutralize on_done/retry before propagating (a repeat
                    # result() call must not double-decrement)
                    try:
                        self._ref = self._retry()
                    except BaseException:
                        self._retry = None
                        self._on_done = None
                        raise
                except GetTimeoutError:
                    # NOT terminal: the replica is still executing this
                    # request — keep the routing slot held and the span
                    # open (a later result() call may still complete it)
                    raise
                except Exception:
                    # terminal failure (replica raised): the request is
                    # over — release its routing slot and finish its
                    # request span exactly once, then surface.
                    # (Exception, NOT BaseException: a KeyboardInterrupt
                    # in the waiting caller does not end the request —
                    # the replica is still executing it.)
                    cb = self._on_done
                    self._on_done = None
                    if cb:
                        cb()
                    raise
            self._done = True
            if self._on_done:
                self._on_done()
        return self._result

    @property
    def ref(self):
        return self._ref

    def __await__(self):
        return self._ref.__await__()


class DeploymentResponseGenerator:
    """Iterates a streaming deployment call, yielding RESULTS as the
    replica produces them (reference streaming DeploymentResponse)."""

    def __init__(self, ref_gen, on_done=None, retry=None):
        self._ref_gen = ref_gen
        self._on_done = on_done
        self._retry = retry
        self._finished = False
        self._yielded = False

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch
        from ray_tpu_torch.core.exceptions import ActorDiedError

        while True:
            try:
                ref = next(self._ref_gen)
                val = ray_tpu_torch.get(ref)
            except StopIteration:
                self._finish()
                raise
            except ActorDiedError:
                # replica died: re-route, but only while the stream is
                # still splice-able (nothing yielded yet) — a half-consumed
                # stream cannot be transparently resumed on a new replica
                if self._retry is None or self._yielded:
                    self._finish()
                    raise
                try:
                    self._ref_gen = self._retry()
                except BaseException:
                    # exhausted: the retry closed the accounting itself
                    self._on_done = None
                    self._finish()
                    raise
                continue
            except BaseException:
                self._finish()
                raise
            self._yielded = True
            return val

    def _finish(self):
        if not self._finished:
            self._finished = True
            if self._on_done:
                self._on_done()


class _BrokenFuture:
    """Future for a request whose pipeline was already broken/torn at
    admission: ``get()`` re-raises, so the response's broken-DAG fallback
    runs lazily at ``result()`` time — ``remote()`` stays non-blocking."""

    def __init__(self, dag, err):
        self._dag = dag
        self._err = err

    def get(self, timeout: Optional[float] = None):
        raise self._err


class CompiledDeploymentResponse:
    """``DeploymentResponse`` analog for the compiled execution plane:
    wraps a :class:`CompiledDAGFuture` (no ``.ref`` — there is no object
    store entry on this path). A BROKEN pipeline (the routed replica died
    mid-DAG) falls back to one normally-routed actor call; a plain
    timeout propagates — re-executing a possibly non-idempotent request
    on timeout is the caller's decision, not the router's."""

    def __init__(self, fut, on_done=None, fallback=None):
        self._fut = fut
        self._on_done = on_done
        self._fallback = fallback
        self._done = False
        self._result = None

    def result(self, timeout_s: Optional[float] = None):
        if self._done:
            return self._result
        from ray_tpu_torch.dag import DAGExecutionError

        try:
            val = self._fut.get(timeout=timeout_s)
        except DAGExecutionError:
            broken = getattr(self._fut._dag, "_broken", None) or \
                getattr(self._fut._dag, "_torn_down", False)
            if self._fallback is None or not broken:
                self._finish()
                raise
            try:
                val = self._fallback()
            except BaseException:
                self._finish()
                raise
        self._result = val
        self._done = True
        self._finish()
        return val

    def _finish(self):
        cb, self._on_done = self._on_done, None
        if cb:
            cb()

    def __await__(self):
        import asyncio

        return asyncio.get_running_loop().run_in_executor(
            None, self.result).__await__()


_DEPTH_TTL_S = 0.05
# replica-pushed KV/load reports (controller-mediated) are refreshed less
# often than runtime queue depths: they ride a controller round trip, and
# KV occupancy moves at decode speed, not per-request speed
_KV_TTL_S = 0.25
# a load report older than this is ignored (replica died or stopped
# pushing; depth-only routing beats steering by a ghost)
_KV_STALE_S = 5.0
# compiled fast path: routing-table staleness bound. The per-request
# controller round trip (get_version) is exactly the control-plane cost
# the compiled plane exists to remove; a stale table self-heals anyway
# (a dead replica's broken DAG triggers the fallback + forced refresh).
_COMPILED_REFRESH_TTL_S = 1.0

# Process-global compiled-pipeline cache, keyed by replica actor id: the
# method name rides the request payload, so ONE DAG per replica serves
# every method and every handle clone in this process — a second exec
# loop would burn the replica's spare concurrency slot (held for health
# checks). Compiled deployments are designed to be driven from one
# process (the steady-state server loop); handles pickled into OTHER
# processes start their own loop there and need the replica to have a
# free slot.
_dag_cache: Dict[bytes, Any] = {}
_dag_cache_lock = None  # created lazily (threading import stays local)


def _dag_lock():
    global _dag_cache_lock
    if _dag_cache_lock is None:
        import threading

        _dag_cache_lock = threading.Lock()
    return _dag_cache_lock


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller=None,
                 method_name: str = "__call__", stream: bool = False):
        self.deployment_name = deployment_name
        self._controller = controller
        self._method = method_name
        self._stream = stream
        self._replicas: List[Any] = []
        self._version = -1
        self._max_ongoing = 8
        # shared load view: runtime queue depths (TTL-cached) + local
        # in-flight deltas since the last refresh
        self._depths: List[int] = []
        self._depth_ts = 0.0
        self._delta: Dict[int, int] = {}
        self._rng = random.Random()
        # KV-aware routing (ISSUE 12): replicas whose deployment exposes
        # load_state() push {kv_free, kv_total, inflight} to the
        # controller; the handle folds KV occupancy into the pick score.
        # MUTABLE state shared BY REFERENCE with options()/__getattr__
        # clones (a fresh clone per method-style call would otherwise
        # reset the TTL — one controller RPC per request — and freeze
        # the rr cursor): kv_loads, kv_next (monotonic), rr_next
        self._route_state: Dict[str, Any] = {
            "kv_loads": {}, "kv_next": 0.0, "rr_next": 0}
        # set from routing info: whether any replica has ever pushed a
        # load report. False = never probe the controller for KV state
        # (plain deployments must not pay even a rare blocking RPC on
        # their request path); the controller bumps the version on the
        # FIRST report, so handles refetch and flip this
        self._has_loads = False
        # compiled execution plane: when the deployment opted in
        # (``compiled=True``), steady-state requests route through one
        # compiled DAG per replica (shm channels, zero per-call task
        # submission); pipelines live in the process-global _dag_cache
        # (one per replica, shared by every handle in this process),
        # lazily built, torn down when their replica leaves the table
        self._compiled = False
        self._refresh_ts = 0.0  # last successful _refresh (monotonic)
        self._dags = _dag_cache
        # multi-model routing (ISSUE 16): model_id steers toward replicas
        # advertising the model RESIDENT (a swap-in costs a weight
        # page-in) and rides the request as a kwarg; prefix_hint (the
        # request's prompt tokens, or a precomputed digest) steers
        # sessions sharing a system prompt to the replica whose prefix
        # trie already holds it
        self._model_id: Optional[str] = None
        self._prefix_hint: Optional[Any] = None

    # -- controller sync --------------------------------------------------

    def _get_controller(self):
        if self._controller is None:
            import ray_tpu_torch

            self._controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        return self._controller

    def _refresh(self, force: bool = False,
                 timeout: Optional[float] = None):
        import ray_tpu_torch

        ctrl = self._get_controller()
        version = ray_tpu_torch.get(ctrl.get_version.remote(), timeout=timeout)
        if force or version != self._version or not self._replicas:
            info = ray_tpu_torch.get(
                ctrl.get_routing_info.remote(self.deployment_name),
                timeout=timeout)
            if info is None:
                raise KeyError(
                    f"deployment {self.deployment_name!r} not found")
            self._replicas = info["replicas"]
            self._max_ongoing = info["max_ongoing_requests"]
            self._version = info["version"]
            self._compiled = bool(info.get("compiled"))
            self._has_loads = bool(info.get("has_loads"))
            self._depths = [0] * len(self._replicas)
            self._depth_ts = 0.0
            self._delta = {i: 0 for i in range(len(self._replicas))}
            self._teardown_stale_dags()
        self._refresh_ts = time.monotonic()

    def _teardown_stale_dags(self) -> None:
        """Routing table changed: drop THIS deployment's compiled DAGs
        whose replica left the table (scaled down, replaced, or dead —
        keeping the DAG would pin the departed replica's exec loop and
        shm rings). Cache entries are tagged with their deployment name,
        so other deployments' pipelines are never touched."""
        if not self._compiled or not self._dags:
            return
        live = {r._actor_id.binary() for r in self._replicas}
        with _dag_lock():
            stale = [k for k, (dep, _d) in self._dags.items()
                     if dep == self.deployment_name and k not in live]
            dags = [self._dags.pop(k)[1] for k in stale]
        for dag in dags:
            try:
                dag.teardown(timeout=2.0)
            except Exception:
                pass

    def _dag_for(self, idx: int):
        """The replica's compiled request pipeline, built on first use:
        ``InputNode -> replica.handle_request_packed``, admitting up to
        ``max_ongoing_requests`` overlapping requests. Cached process-
        globally: one pipeline per replica, shared by every handle."""
        replica = self._replicas[idx]
        key = replica._actor_id.binary()
        with _dag_lock():
            ent = self._dags.get(key)
            if ent is None:
                from ray_tpu_torch.dag import InputNode

                with InputNode() as inp:
                    node = replica.handle_request_packed.bind(inp)
                dag = node.experimental_compile(
                    max_in_flight=max(1, min(self._max_ongoing, 32)))
                ent = (self.deployment_name, dag)
                self._dags[key] = ent
        return ent[1]

    # -- routing ----------------------------------------------------------

    def _load_view(self) -> List[float]:
        now = time.monotonic()
        if now - self._depth_ts > _DEPTH_TTL_S:
            from ray_tpu_torch.util import state

            try:
                ids = [r._actor_id.binary() for r in self._replicas]
                self._depths = state.actor_queue_depths(ids)
                self._delta = {i: 0 for i in range(len(self._replicas))}
                self._depth_ts = now
            except Exception:
                pass  # stale view beats no view
        if len(self._depths) != len(self._replicas):
            # cloned handle whose first refresh failed: all-zero view
            self._depths = [0] * len(self._replicas)
        return [self._depths[i] + self._delta.get(i, 0)
                for i in range(len(self._replicas))]

    def _kv_view(self) -> Dict[bytes, Dict[str, Any]]:
        """TTL-cached replica load reports (kv_free/kv_total/inflight)
        from the controller. Empty for deployments that don't advertise
        KV state — routing degrades to pure queue depth."""
        now = time.monotonic()
        rs = self._route_state
        if now >= rs["kv_next"]:
            import ray_tpu_torch

            # claim the window BEFORE the RPC: concurrent callers that
            # race past a wedged controller must route on the stale view,
            # not pile up their own blocking probes (one probe per
            # window, ever)
            rs["kv_next"] = now + _KV_TTL_S
            try:
                ctrl = self._get_controller()
                rs["kv_loads"] = ray_tpu_torch.get(
                    ctrl.get_replica_loads.remote(self.deployment_name),
                    timeout=2) or {}
            except Exception:
                pass  # stale view beats no view
            if not rs["kv_loads"]:
                # deployment doesn't advertise KV state (no load_state):
                # exponential backoff to 30s — a plain deployment must
                # not pay a recurring controller probe on its request
                # path forever (reset to the base TTL on the first
                # non-empty view)
                backoff = min(rs.get("kv_backoff", _KV_TTL_S) * 2, 30.0)
                rs["kv_backoff"] = backoff
                rs["kv_next"] = now + backoff
            else:
                rs["kv_backoff"] = _KV_TTL_S
        return rs["kv_loads"]

    def _scores(self) -> List[float]:
        """Per-replica routing score: runtime queue depth (+ local
        in-flight deltas) plus weighted KV occupancy — a replica about to
        run out of KV blocks is as bad a pick as a deep queue, even when
        its queue is short (admission there would shed or stall)."""
        from ray_tpu_torch import config as _cfg

        load = [float(x) for x in self._load_view()]
        if not self._has_loads:
            return load
        kv = self._kv_view()
        if not kv:
            return load
        w = float(_cfg.get("serve_kv_route_weight"))
        mw = (float(_cfg.get("serve_model_route_weight"))
              if self._model_id is not None else 0.0)
        if w <= 0 and mw <= 0:
            return load
        now = time.time()
        for i, r in enumerate(self._replicas):
            rep = kv.get(r._actor_id.binary())
            if not rep or now - rep.get("ts", 0) > _KV_STALE_S:
                continue
            total = rep.get("kv_total") or 0
            if w > 0 and total > 0:
                used_frac = 1.0 - rep.get("kv_free", 0) / total
                load[i] += w * used_frac
            if mw > 0:
                models = rep.get("models")
                if models is not None:
                    # model residency folds into the p2c score: a
                    # replica that must page the weights in competes at
                    # a penalty, but can still win when the resident
                    # replicas are saturated
                    m = models.get(self._model_id)
                    if not m or m.get("state") != "hbm":
                        load[i] += mw
        return load

    def _affinity_key(self) -> Optional[str]:
        """Content digest of the request's first prompt block (the key
        replicas publish in their prefix digests), or None when no hint
        was given / the block geometry is unknown."""
        hint = self._prefix_hint
        if hint is None:
            return None
        if isinstance(hint, str):
            return hint  # precomputed digest
        bs = 0
        for rep in self._route_state["kv_loads"].values():
            bs = int(rep.get("block_size") or 0)
            if bs:
                break
        toks = list(hint)
        if not bs or len(toks) < bs:
            return None
        from ray_tpu_torch.serve.kv_cache import prefix_key_digest

        return prefix_key_digest(toks[:bs])

    def _affinity_pick(self, cand: List[int],
                       score: List[float]) -> Optional[int]:
        """Cluster-wide prefix affinity: direct-pick the replica whose
        published prefix digest carries this request's first-block key —
        unless that replica is overloaded (its score trails the best
        candidate by more than the margin), in which case load wins and
        the pick falls through to p2c. A cold prefix falls through too;
        whoever serves it becomes the affinity home via its trie."""
        from ray_tpu_torch import config as _cfg

        if not self._has_loads or self._prefix_hint is None:
            return None
        if not _cfg.get("serve_prefix_affinity"):
            return None
        kv = self._kv_view()
        if not kv:
            return None
        key = self._affinity_key()
        if key is None:
            return None
        now = time.time()
        best, best_w = None, -1
        for i in cand:
            rep = kv.get(self._replicas[i]._actor_id.binary())
            if not rep or now - rep.get("ts", 0) > _KV_STALE_S:
                continue
            for k, wgt in rep.get("prefix_digest", []):
                if k == key and wgt > best_w:
                    best, best_w = i, int(wgt)
        if best is None:
            # cold prefix: no replica has published it yet. Rendezvous-
            # hash the key over the candidates so every handle in the
            # cluster sends this tenant's opening burst to the SAME
            # replica — falling through to p2c scatters the prefix
            # across the fleet, planting one trie copy (and paying one
            # re-prefill) per replica it touches before any digest can
            # converge. Stable replica ids make independent handles
            # agree without coordination; the margin check below still
            # lets load override the hash.
            import hashlib
            best = max(cand, key=lambda i: hashlib.sha1(
                str(key).encode()
                + self._replicas[i]._actor_id.binary()).digest())
        margin = float(_cfg.get("serve_prefix_affinity_margin"))
        if score[best] > min(score[c] for c in cand) + margin:
            return None  # overloaded: affinity yields to load
        return best

    def _pick_replica(self, exclude: Optional[bytes] = None) -> int:
        """Power-of-two-choices over the combined load score;
        ``exclude`` bars a replica observed dead THIS request (the retry
        path must never re-pick its own victim while an alternative
        exists). RTPU_SERVE_ROUTING=rr forces plain round-robin (the
        bench A/B baseline)."""
        from ray_tpu_torch import config as _cfg

        n = len(self._replicas)
        cand = list(range(n))
        if exclude is not None and n > 1:
            cand = [i for i in cand
                    if self._replicas[i]._actor_id.binary() != exclude] \
                or list(range(n))
        if len(cand) == 1:
            return cand[0]
        if str(_cfg.get("serve_routing")) == "rr":
            self._route_state["rr_next"] += 1
            return cand[self._route_state["rr_next"] % len(cand)]
        score = self._scores()
        aff = self._affinity_pick(cand, score)
        if aff is not None:
            return aff
        i, j = self._rng.sample(cand, 2)
        return i if score[i] <= score[j] else j

    def options(self, *, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                model_id: Optional[str] = None,
                prefix_hint: Optional[Any] = None) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, self._controller,
                             method_name or self._method,
                             self._stream if stream is None else stream)
        h._replicas = self._replicas
        h._version = self._version
        h._max_ongoing = self._max_ongoing
        # the clone inherits a matching _version, so its _refresh() will
        # skip the info fetch — _compiled must travel with it or method
        # clones (handle.my_method) silently leave the compiled plane
        h._compiled = self._compiled
        h._has_loads = self._has_loads
        h._refresh_ts = self._refresh_ts
        # the SHARED routing-state object travels by reference:
        # __getattr__ makes a FRESH clone per method-style call, and a
        # clone-private copy would reset the KV-view TTL (one blocking
        # controller RPC per request) and freeze the rr cursor
        h._route_state = self._route_state
        h._model_id = model_id if model_id is not None else self._model_id
        h._prefix_hint = (prefix_hint if prefix_hint is not None
                          else self._prefix_hint)
        return h

    def _issue(self, args, kwargs, exclude: Optional[bytes] = None):
        """Pick a replica and dispatch one request to it."""
        self._refresh()
        if self._model_id is not None:
            # the routing hint doubles as the request's model address
            kwargs.setdefault("model_id", self._model_id)
        idx = self._pick_replica(exclude=exclude)
        replica = self._replicas[idx]
        self._delta[idx] = self._delta.get(idx, 0) + 1
        call = replica.handle_request
        if self._stream:
            call = call.options(num_returns="streaming")
        return idx, replica, call.remote(self._method, args, kwargs)

    def _replica_died(self, replica) -> None:
        """Report a dead replica to the controller (which drops it from the
        routing table and reconciles a replacement) and force-refresh this
        handle's view so the re-issue routes to a live replica."""
        import ray_tpu_torch

        try:
            ctrl = self._get_controller()
            ray_tpu_torch.get(ctrl.report_replica_death.remote(
                self.deployment_name, replica._actor_id.binary()),
                timeout=10)
        except Exception:
            pass  # controller unreachable: the forced refresh still helps
        try:
            self._refresh(force=True, timeout=10)
        except Exception:
            # dead/wedged controller must not break the retry path: the
            # cached replica list may still name a live replica, and the
            # bounded retry budget decides the outcome either way
            pass

    def remote(self, *args, **kwargs):
        if not self._stream:
            if self._version == -1:
                self._refresh()
            if self._compiled:
                # compiled execution plane: no task submission, no
                # scheduler — the request rides the replica's shm DAG
                # (None = payload can't ride the ring; fall through to
                # the ordinary actor-call path below)
                resp = self._remote_compiled(args, kwargs)
                if resp is not None:
                    return resp
        from ray_tpu_torch import config as _cfg
        from ray_tpu_torch.util import tracing

        # Trace chain (ISSUE 7): a manual request span covers the FULL
        # request lifetime (result()/stream drain happen on other threads,
        # where the thread-local span() context cannot be held open); the
        # route span below brackets replica selection + dispatch, so the
        # actor-call submit/execute spans nest under it and
        # summarize_critical_path(trace_id) reconciles route -> queue ->
        # execute -> stream against the measured latency.
        req_span = tracing.manual_span(
            "serve.handle::request", {"deployment": self.deployment_name})
        state = {}
        if req_span is None:
            state["idx"], state["replica"], ref = self._issue(args, kwargs)
        else:
            try:
                with tracing.span("serve.handle::route",
                                  {"deployment": self.deployment_name},
                                  parent=req_span.traceparent):
                    state["idx"], state["replica"], ref = self._issue(
                        args, kwargs)
            except BaseException as e:
                # a failed dispatch still records its request span (the
                # route span's parent must exist in the trace)
                req_span.finish(error=repr(e))
                raise
        retries = [int(_cfg.get("serve_request_retries"))]

        def _done():
            i = state["idx"]
            self._delta[i] = self._delta.get(i, 0) - 1
            self._report_metrics()
            if req_span is not None:
                req_span.finish({"replica_idx": state["idx"]})

        def _retry():
            # called when the routed-to replica died before replying:
            # report + re-route (bounded — a deployment whose replicas
            # keep dying must eventually surface the error). The re-issue
            # EXCLUDES the dead pick: _replica_died refreshes routing
            # state, but when the controller is unreachable the cached
            # table still lists the corpse — the retry must re-consult
            # state AND bar its own victim, never re-roll the same pick.
            retries[0] -= 1
            if retries[0] < 0:
                from ray_tpu_torch.core.exceptions import ActorDiedError

                _done()  # the request is terminal: release its slot
                raise ActorDiedError(
                    f"deployment {self.deployment_name!r}: request still "
                    "failing after replica-death retries")
            self._delta[state["idx"]] = (
                self._delta.get(state["idx"], 0) - 1)
            dead = state["replica"]._actor_id.binary()
            self._replica_died(state["replica"])
            state["idx"], state["replica"], new_ref = self._issue(
                args, kwargs, exclude=dead)
            return new_ref

        if self._stream:
            return DeploymentResponseGenerator(ref, on_done=_done,
                                               retry=_retry)
        return DeploymentResponse(ref, on_done=_done, retry=_retry)

    def _remote_compiled(self, args, kwargs):
        """Route one request through the picked replica's compiled DAG.
        ``max_in_flight`` admission doubles as the per-replica ongoing-
        request bound; a broken pipeline falls back to a normal routed
        call (and reports the death so the controller reconciles).
        Returns None when this request cannot ride the compiled plane
        (payload exceeds the ring slot) — the caller then takes the
        ordinary actor-call path."""
        from ray_tpu_torch.dag import DAGBackpressureError, DAGExecutionError
        from ray_tpu_torch.experimental.channel import ChannelFullError

        # TTL'd refresh: steady state pays ZERO controller round trips
        # per request (the whole point of the compiled plane)
        if (self._version == -1 or not self._replicas
                or time.monotonic() - self._refresh_ts
                > _COMPILED_REFRESH_TTL_S):
            self._refresh()
        idx = self._pick_replica()
        replica = self._replicas[idx]
        key = replica._actor_id.binary()
        dag = self._dag_for(idx)
        try:
            fut = dag.execute((self._method, args, kwargs), timeout=60.0)
        except DAGBackpressureError:
            # saturated-but-HEALTHY pipeline: overload must surface to
            # the caller, never read as a replica death (tearing down a
            # live pipeline would error every in-flight request)
            raise
        except ChannelFullError:
            # payload larger than the ring slot: this request rides the
            # ordinary path (object store has no such bound)
            return None
        except DAGExecutionError as e:
            # pipeline already broken/torn down at admission: hand back a
            # response whose result() runs the re-route lazily —
            # remote() itself stays non-blocking
            fut = _BrokenFuture(dag, e)
        self._delta[idx] = self._delta.get(idx, 0) + 1

        def _done():
            self._delta[idx] = self._delta.get(idx, 0) - 1
            self._report_metrics()

        def _fallback():
            return self._compiled_fallback(key, replica, args, kwargs)

        return CompiledDeploymentResponse(fut, on_done=_done,
                                          fallback=_fallback)

    def _compiled_fallback(self, key: bytes, replica, args, kwargs):
        """The routed replica's pipeline broke (replica death): drop its
        DAG, report the death, and run this request once through the
        ordinary actor-call path on a live replica."""
        import ray_tpu_torch

        with _dag_lock():
            ent = self._dags.pop(key, None)
        if ent is not None:
            try:
                ent[1].teardown(timeout=2.0)
            except Exception:
                pass
        self._replica_died(replica)
        idx, _rep, ref = self._issue(args, kwargs, exclude=key)
        try:
            return ray_tpu_torch.get(ref, timeout=60)
        finally:
            self._delta[idx] = self._delta.get(idx, 0) - 1

    def _report_metrics(self):
        try:
            ctrl = self._get_controller()
            total = float(sum(self._load_view()))
            ctrl.record_request_metrics.remote(self.deployment_name, total)
        except Exception:
            pass

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, None, self._method, self._stream))
