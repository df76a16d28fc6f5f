"""Disaggregated prefill/decode serving (twin of
``ray_tpu/serve/disagg.py``).

Splits :class:`~ray_tpu_torch.serve.llm.LLMDeployment` serving into TWO
replica pools — a **prefill pool** that runs chunked prefill into paged KV
blocks and a **decode pool** that adopts the shipped blocks and emits
tokens — so a long prompt arriving never steals step time from in-flight
decodes: TTFT becomes prefill time plus one block-batch transfer. The
shipping plane is :mod:`ray_tpu_torch.serve.kv_transfer` (DeviceChannel
rings on one node, the object store otherwise).

The router (:class:`DisaggHandle`) is transfer-aware:

- **prompts go to prefill capacity**: power-of-two-choices over the
  prefill pool's queue depths (the handle's runtime load view);
- **sessions go to decode capacity**: power-of-two-choices over the decode
  pool's controller-mediated load reports (KV-claimable blocks +
  in-flight streams), with a configurable penalty for decode replicas on
  a DIFFERENT node than the chosen prefill replica (a channel hop beats a
  store hop);
- **admission budgets across both pools**: a request whose KV table could
  not fit the best decode replica's claimable blocks is shed at the router
  (``RequestShedError`` reason ``decode_kv``) before any prefill compute is
  spent; prefill-side SLO admission still applies in the engine.

Replica death at any stage re-routes: a dead prefill replica re-prefills
on a peer (nothing was delivered, so the decode pool adopts nothing
partial); a dead decode replica re-prefills too (the shipped payload died
with it — block refcounts are per engine, so nothing leaks). A drained
decode replica's live sessions migrate to a peer and their streams splice
the continuation (:meth:`DisaggHandle.drain_decode_replica`).

On the card each replica asks for a share of it: pass ``num_gpus`` (a
fraction, so both pools fit one card) and the ``CUDA_VISIBLE_DEVICES``
opt-in in the per-role actor options.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch.serve.admission import RequestShedError
from ray_tpu_torch.serve.handle import DeploymentHandle

#: ignore a load report older than this (dead/stalled replica)
_LOAD_STALE_S = 5.0


def deploy_disagg(model: Any = "llama-debug", *, name: str = "llm",
                  prefill_replicas: int = 1, decode_replicas: int = 1,
                  max_concurrency: int = 16,
                  slo: Optional[Any] = None,
                  decode_slo: Optional[Any] = None,
                  prefill_actor_options: Optional[Dict[str, Any]] = None,
                  decode_actor_options: Optional[Dict[str, Any]] = None,
                  prefill_engine_kwargs: Optional[Dict[str, Any]] = None,
                  decode_engine_kwargs: Optional[Dict[str, Any]] = None,
                  **engine_kwargs) -> "DisaggHandle":
    """Deploy the two pools and return the routing handle. Engine
    kwargs (max_slots/max_len/block_size/prefill_chunk/...) apply to
    both pools, with the per-role engine kwargs layered on top (the
    pools genuinely want different tuning — prefill holds only the
    transient working set of in-flight prompts, decode keeps sessions +
    the prefix cache, so e.g. ``num_blocks`` splits asymmetrically);
    ``slo`` arms the prefill engines' admission gate, ``decode_slo``
    the decode engines' (defaults to ``slo``); the per-role actor
    options override the defaults (placement; on the card, the replica's
    ``num_gpus`` share and its ``CUDA_VISIBLE_DEVICES`` opt-in). ``model``
    is a preset name or a config; ``params`` / ``device`` /
    ``cuda_graphs`` pass through to each :class:`LLMDeployment`.

    The three replicas start together: ``serve.run`` hands both pools to
    the controller, which creates their actors without waiting for one
    another; the first request waits for them."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMDeployment

    base = {"max_concurrency": max_concurrency, "num_cpus": 0}
    apps = {}
    for role, n, role_slo, extra, role_kw in (
            ("prefill", prefill_replicas, slo, prefill_actor_options,
             prefill_engine_kwargs),
            ("decode", decode_replicas,
             decode_slo if decode_slo is not None else slo,
             decode_actor_options, decode_engine_kwargs)):
        dep = serve.deployment(
            LLMDeployment, name=f"{name}-{role}", num_replicas=n,
            ray_actor_options=dict(base, **(extra or {})))
        apps[role] = serve.run(
            dep.bind(model, role=role, slo=role_slo,
                     **dict(engine_kwargs, **(role_kw or {}))),
            name=f"{name}-{role}")
    return DisaggHandle(apps["prefill"], apps["decode"])


class DisaggHandle:
    """Client-side router over one prefill pool and one decode pool."""

    def __init__(self, prefill: DeploymentHandle,
                 decode: DeploymentHandle):
        self.prefill = prefill
        self.decode = decode
        import random

        self._rng = random.Random()

    # -- load views --------------------------------------------------------

    @staticmethod
    def _pool_loads(handle: DeploymentHandle) -> Dict[bytes, dict]:
        """The handle's own TTL'd controller load view (shared with its
        routing path — claim-the-window-before-RPC plus empty-view
        backoff, so a wedged controller costs one probe per TTL window
        across ALL concurrent streams, never a probe pileup)."""
        return handle._kv_view()

    @staticmethod
    def _fresh(loads: Dict[bytes, dict]) -> Dict[bytes, dict]:
        cutoff = time.time() - _LOAD_STALE_S
        return {k: v for k, v in loads.items()
                if v.get("ts", 0) >= cutoff}

    # -- picking -----------------------------------------------------------

    @staticmethod
    def _refresh_safe(handle: DeploymentHandle) -> None:
        """Refresh the replica table, but route on the existing (stale)
        table rather than fail the request when the controller RPC
        hiccups mid-flight."""
        try:
            handle._refresh()
        except Exception:
            if not handle._replicas:
                raise

    def _pick_prefill(self, exclude: Optional[bytes] = None):
        """Prompts go to prefill capacity: the handle's own p2c over
        runtime queue depths (+ the dead-pick exclusion)."""
        self._refresh_safe(self.prefill)
        if not self.prefill._replicas:
            raise RuntimeError("prefill pool has no replicas")
        idx = self.prefill._pick_replica(exclude=exclude)
        return self.prefill._replicas[idx]

    def _pick_decode(self, prefer_node: Optional[str],
                     exclude: Optional[bytes] = None):
        """Sessions go to decode capacity: p2c over (inflight + weighted
        KV occupancy) from the load reports, plus a cross-node penalty
        so same-host transfers (channel path) win ties."""
        from ray_tpu_torch import config as _cfg

        self._refresh_safe(self.decode)
        reps = self.decode._replicas
        if not reps:
            raise RuntimeError("decode pool has no replicas")
        cand = list(range(len(reps)))
        if exclude is not None and len(cand) > 1:
            cand = [i for i in cand
                    if reps[i]._actor_id.binary() != exclude] or cand
        if len(cand) == 1:
            return reps[cand[0]]
        loads = self._fresh(self._pool_loads(self.decode))
        w_kv = float(_cfg.get("serve_kv_route_weight"))
        w_x = float(_cfg.get("serve_disagg_cross_node_penalty"))

        def score(i: int) -> float:
            rep = loads.get(reps[i]._actor_id.binary())
            if not rep:
                return 0.0  # unknown: neutral (cold replica)
            s = float(rep.get("inflight", 0))
            total = rep.get("kv_total") or 0
            if total:
                s += w_kv * (1.0 - rep.get("kv_free", 0) / total)
            if prefer_node and rep.get("node") \
                    and rep["node"] != prefer_node:
                s += w_x
            return s

        i, j = self._rng.sample(cand, 2)
        return reps[i] if score(i) <= score(j) else reps[j]

    def _budget_check(self, n_prompt: int, max_new: int) -> None:
        """Cross-pool admission: shed NOW if no decode replica could
        claim this request's KV table (prefilling it would burn compute
        on a stream that can never start)."""
        loads = self._fresh(self._pool_loads(self.decode))
        sized = [l for l in loads.values()
                 if l.get("kv_total") and l.get("block_size")]
        if not sized:
            return  # no reports yet: the engines' own gates decide
        best = max(l["kv_free"] * l["block_size"] for l in sized)
        if n_prompt + max_new > best:
            raise RequestShedError(
                f"request shed (decode_kv): needs {n_prompt + max_new} "
                f"KV tokens but the best decode replica has {best} "
                "claimable", reason="decode_kv")

    # -- the request path --------------------------------------------------

    def stream(self, prompt_tokens, max_new_tokens: int = 16,
               eos: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Iterator[int]:
        """One disaggregated request: prefill -> KV ship -> decode
        stream. Yields tokens (the prefill-sampled first token
        included). Replica deaths re-route within the configured retry
        budget; SLO sheds and deadline verdicts surface as-is."""
        from ray_tpu_torch import config as _cfg
        from ray_tpu_torch.util import tracing

        self._budget_check(len(prompt_tokens), max_new_tokens)
        req_span = tracing.manual_span(
            "serve.disagg::request",
            {"prompt_tokens": len(prompt_tokens),
             "max_new_tokens": max_new_tokens})
        tokens_out = 0
        try:
            retries = int(_cfg.get("serve_request_retries"))
            bad_prefill: Optional[bytes] = None
            bad_decode: Optional[bytes] = None
            attempt = 0
            while True:
                attempt += 1
                try:
                    for tok in self._attempt(
                            prompt_tokens, max_new_tokens, eos,
                            deadline_s, req_span, bad_prefill,
                            bad_decode):
                        tokens_out += 1
                        yield tok
                    return
                except _RetryableDeath as rd:
                    if rd.tokens_yielded or attempt > retries:
                        # a half-consumed stream cannot be spliced onto a
                        # fresh prefill, and the retry budget is bounded
                        raise rd.cause
                    bad_prefill, bad_decode = rd.bad_prefill, rd.bad_decode
        except BaseException as e:
            if req_span is not None:
                req_span.finish(error=repr(e))
                req_span = None
            raise
        finally:
            if req_span is not None:
                req_span.finish({"tokens": tokens_out})

    def _attempt(self, prompt_tokens, max_new_tokens, eos, deadline_s,
                 parent_span, bad_prefill, bad_decode):
        import ray_tpu_torch
        from ray_tpu_torch.core.exceptions import ActorDiedError
        from ray_tpu_torch.util import tracing

        parent = parent_span.traceparent if parent_span else None
        prefill_rep = self._pick_prefill(exclude=bad_prefill)
        p_loads = self._fresh(self._pool_loads(self.prefill))
        p_node = (p_loads.get(prefill_rep._actor_id.binary()) or {}) \
            .get("node")
        decode_rep = self._pick_decode(p_node, exclude=bad_decode)
        req_id = uuid.uuid4().hex
        transfer = {"req": req_id,
                    "dst": decode_rep._actor_id.binary().hex(),
                    "dst_node": None}
        d_loads = self._fresh(self._pool_loads(self.decode))
        d_rec = d_loads.get(decode_rep._actor_id.binary())
        if d_rec:
            transfer["dst_node"] = d_rec.get("node")

        pre_span = tracing.manual_span(
            "serve.disagg::prefill", {"req": req_id}, parent=parent)
        try:
            desc = ray_tpu_torch.get(
                prefill_rep.handle_request.remote(
                    "prefill_export",
                    (prompt_tokens, transfer, deadline_s), {}),
                timeout=float(_timeout(deadline_s)))
        except ActorDiedError as e:
            if pre_span is not None:
                pre_span.finish(error="prefill replica died")
            self._report_death(self.prefill, prefill_rep)
            raise _RetryableDeath(e, prefill_rep._actor_id.binary(),
                                  bad_decode, 0)
        except BaseException as e:
            if pre_span is not None:
                pre_span.finish(error=repr(e))
            raise
        if pre_span is not None:
            pre_span.finish({"kind": desc.get("kind", "?")})

        dec_span = tracing.manual_span(
            "serve.disagg::decode", {"req": req_id}, parent=parent)
        n = 0
        migrate = None
        try:
            it = iter(decode_rep.handle_request.options(
                num_returns="streaming").remote(
                "adopt_stream",
                (prompt_tokens, desc, max_new_tokens, eos, deadline_s),
                {}))
            while True:
                try:
                    ref = next(it)
                    tok = ray_tpu_torch.get(ref)
                except StopIteration:
                    break
                except ActorDiedError as e:
                    self._report_death(self.decode, decode_rep)
                    raise _RetryableDeath(
                        e, bad_prefill, decode_rep._actor_id.binary(), n)
                # stream_batch > 1 replicas deliver token CHUNKS (lists)
                # — flatten so callers always consume per-token
                for t in (tok if isinstance(tok, list) else (tok,)):
                    if isinstance(t, dict) and "__migrate__" in t:
                        # replica drain: the stream ends here; the
                        # session's KV already shipped to the named
                        # destination — splice the continuation below
                        # instead of aborting a half-consumed stream
                        migrate = t["__migrate__"]
                        continue
                    n += 1
                    yield t
            # drain splice: resume on the migration destination. Each
            # continuation re-emits the handoff token (adoption re-emits
            # ``first_token``, already delivered pre-drain) — drop it.
            # A continuation can itself be drained, so chase markers
            # until a stream ends without one (double preemption).
            while migrate is not None:
                mig, migrate = migrate, None
                dup_pending = True
                for tok in self._migrated_stream(mig, deadline_s):
                    for t in (tok if isinstance(tok, list) else (tok,)):
                        if isinstance(t, dict) and "__migrate__" in t:
                            migrate = t["__migrate__"]
                            continue
                        if dup_pending:
                            dup_pending = False
                            continue
                        n += 1
                        yield t
        except _RetryableDeath:
            if dec_span is not None:
                dec_span.finish(error="decode replica died")
            raise
        except BaseException as e:
            if dec_span is not None:
                dec_span.finish(error=repr(e))
            raise
        if dec_span is not None:
            dec_span.finish({"tokens": n})

    def _migrated_stream(self, mig: Dict[str, Any],
                         deadline_s: Optional[float]):
        """Open the continuation stream on a drain's migration
        destination: the replica adopts the shipped KV (the descriptor
        in ``mig``) against the fed-token transcript and keeps decoding
        — no re-prefill. The destination is addressed by actor id (the
        drain already chose it); routing policy does not re-pick."""
        import ray_tpu_torch

        dst = mig["dst"]

        def find():
            return next((r for r in self.decode._replicas
                         if r._actor_id.binary().hex() == dst), None)

        self._refresh_safe(self.decode)
        rep = find()
        if rep is None:
            self.decode._refresh(force=True)
            rep = find()
        if rep is None:
            raise RuntimeError(
                f"session migrated to decode replica {dst[:8]} but it "
                "is not in the routing table")
        it = iter(rep.handle_request.options(
            num_returns="streaming").remote(
            "adopt_stream",
            (mig["prompt_tokens"], mig["desc"], mig["max_new_tokens"],
             mig["eos"], deadline_s), {}))
        while True:
            try:
                yield ray_tpu_torch.get(next(it))
            except StopIteration:
                return

    @staticmethod
    def _report_death(handle: DeploymentHandle, replica) -> None:
        try:
            handle._replica_died(replica)
        except Exception:
            pass

    # -- elastic drain --------------------------------------------------------

    def drain_decode_replica(self, actor_id_hex: Optional[str] = None,
                             *, node_id: Optional[str] = None,
                             timeout_s: float = 30.0) -> Dict[str, Any]:
        """Drain live sessions off a decode replica ahead of preemption:
        every in-flight decode ships its KV blocks to a surviving peer
        (round-robin over the rest of the pool) and its stream splices
        the continuation there — no re-prefill. This is the serving
        half of the elastic churn story: call it when the preemption
        notice lands, BEFORE the node-drain RPC
        (``rpc_node_drain`` → GCS "drained" death) kills the replica.

        Pick the victim by ``actor_id_hex``, or by ``node_id`` (drains
        every decode replica reported on that node — the shape a
        node-level preemption notice arrives in). Returns the merged
        drain report ``{sessions, migrated, failed, finished}``."""
        import ray_tpu_torch

        self.decode._refresh(force=True)
        reps = self.decode._replicas
        loads = self._fresh(self._pool_loads(self.decode))

        def rec(r):
            return loads.get(r._actor_id.binary()) or {}

        if actor_id_hex is not None:
            victims = [r for r in reps
                       if r._actor_id.binary().hex() == actor_id_hex]
            if not victims:
                raise ValueError(
                    f"decode replica {actor_id_hex[:8]} not found")
        elif node_id is not None:
            victims = [r for r in reps if rec(r).get("node") == node_id]
            if not victims:
                return {"sessions": 0, "migrated": 0, "failed": 0,
                        "finished": 0}
        else:
            raise ValueError("pass actor_id_hex or node_id")
        victim_ids = {v._actor_id.binary() for v in victims}
        survivors = [r for r in reps
                     if r._actor_id.binary() not in victim_ids]
        if not survivors:
            raise RuntimeError(
                "no surviving decode replica to migrate sessions to")
        dests = [{"dst": r._actor_id.binary().hex(),
                  "dst_node": rec(r).get("node")} for r in survivors]
        total = {"sessions": 0, "migrated": 0, "failed": 0,
                 "finished": 0}
        for v in victims:
            rep_out = ray_tpu_torch.get(
                v.handle_request.remote("drain_sessions",
                                        (dests, timeout_s), {}),
                timeout=timeout_s + 60.0)
            for k in total:
                total[k] += rep_out.get(k, 0)
        return total

    # -- introspection / lifecycle -----------------------------------------

    def kv_states(self) -> Dict[str, List[Dict[str, Any]]]:
        """Per-replica engine KV state for both pools (leak audits)."""
        import ray_tpu_torch

        out: Dict[str, List[Dict[str, Any]]] = {}
        for role, h in (("prefill", self.prefill),
                        ("decode", self.decode)):
            h._refresh(force=True)
            out[role] = [
                ray_tpu_torch.get(r.handle_request.remote("kv_state", (), {}),
                            timeout=60)
                for r in h._replicas]
        return out

    def shutdown(self) -> None:
        from ray_tpu_torch import serve

        for h in (self.prefill, self.decode):
            try:
                serve.delete(h.deployment_name)
            except Exception:
                pass


class _RetryableDeath(Exception):
    """Internal: a replica died during an attempt; carries which pick to
    exclude on the retry and whether tokens already reached the caller."""

    def __init__(self, cause, bad_prefill, bad_decode, tokens_yielded):
        super().__init__(str(cause))
        self.cause = cause
        self.bad_prefill = bad_prefill
        self.bad_decode = bad_decode
        self.tokens_yielded = tokens_yielded


def _timeout(deadline_s: Optional[float]) -> float:
    base = 120.0
    return base if deadline_s is None else min(base, deadline_s + 5.0)
