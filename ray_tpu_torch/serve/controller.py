"""ServeController: deployment state reconciliation + autoscaling.

Role analog: ``python/ray/serve/_private/controller.py:86`` with the
``DeploymentStateManager`` reconciler (``deployment_state.py:1226``) and
autoscaling (``autoscaling_state.py``). The controller is a named actor;
``deploy``/``delete`` reconcile replica actors synchronously (create the
missing, kill the surplus), and ``autoscale_tick`` applies the queue-based
policy from metrics the handles report. Config updates broadcast by bumping
a routing-table version handles poll (the LongPollHost analog, pull-based).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"


class ServeController:
    def __init__(self):
        # name -> {"app": Application-ish dict, "replicas": [handles], ...}
        self._deployments: Dict[str, Dict[str, Any]] = {}
        self._version = 0
        # deployment -> list of (timestamp, ongoing) samples from handles
        self._metrics: Dict[str, List[Any]] = {}

    # -- deploy / delete --------------------------------------------------

    def deploy_application(self, specs: List[Dict[str, Any]]) -> int:
        """specs: one dict per deployment: {name, cls_blob, init_args,
        init_kwargs, config(dict), composed(list of dep names)}."""
        import cloudpickle

        for spec in specs:
            name = spec["name"]
            entry = self._deployments.get(name)
            if entry is None:
                entry = {"replicas": [], "spec": spec}
                self._deployments[name] = entry
            else:
                entry["spec"] = spec
            entry["target"] = spec["config"]["num_replicas"]
        # resolve composition: build handles for dependencies first
        order = self._topo_order(specs)
        for name in order:
            self._reconcile(name)
        self._version += 1
        return self._version

    def delete_deployment(self, name: str) -> None:
        entry = self._deployments.pop(name, None)
        if entry:
            for r in entry["replicas"]:
                self._kill(r)
        self._version += 1

    def shutdown(self) -> None:
        for name in list(self._deployments):
            self.delete_deployment(name)

    def _topo_order(self, specs) -> List[str]:
        by_name = {s["name"]: s for s in specs}
        seen: List[str] = []

        def visit(n):
            if n in seen or n not in by_name:
                return
            for dep in by_name[n].get("composed", []):
                visit(dep)
            seen.append(n)

        for s in specs:
            visit(s["name"])
        return seen

    # -- reconciliation ---------------------------------------------------

    def _make_replica(self, spec: Dict[str, Any]):
        import cloudpickle

        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import ReplicaActor

        cls_or_fn = cloudpickle.loads(spec["cls_blob"])
        init_args = cloudpickle.loads(spec["init_args"])
        init_kwargs = cloudpickle.loads(spec["init_kwargs"])
        # composed deps: replace sentinels with live handles
        from ray_tpu_torch.serve.handle import DeploymentHandle, _AppRefSentinel

        def resolve(x):
            if isinstance(x, _AppRefSentinel):
                return DeploymentHandle(x.name, controller=None)
            return x

        init_args = tuple(resolve(a) for a in init_args)
        init_kwargs = {k: resolve(v) for k, v in init_kwargs.items()}
        opts = dict(spec["config"].get("ray_actor_options") or {})
        if spec["config"].get("compiled"):
            # compiled execution plane: the DAG exec loop occupies one
            # concurrency slot for the deployment's lifetime — keep a
            # second so health checks / reconfigure stay reachable
            opts.setdefault("max_concurrency", 2)
        actor_cls = ray_tpu_torch.remote(ReplicaActor)
        return actor_cls.options(**opts).remote(
            cls_or_fn, init_args, init_kwargs,
            spec["config"].get("user_config"),
            deployment_name=spec["name"])

    def _reconcile(self, name: str) -> None:
        entry = self._deployments.get(name)
        if not entry:
            return
        target = entry.get("target", 1)
        replicas = entry["replicas"]
        while len(replicas) < target:
            replicas.append(self._make_replica(entry["spec"]))
        while len(replicas) > target:
            victim = replicas.pop()
            # drop its load report with it: a scaled-down replica's last
            # (typically high-occupancy) report must not keep inflating
            # the autoscaler's average for 30 more seconds
            entry.get("loads", {}).pop(victim._actor_id.binary(), None)
            self._kill(victim)

    def report_replica_death(self, name: str, actor_id: bytes) -> int:
        """Router-reported replica death (the reference's health-check /
        unhealthy-replica path, pull-free: handles observe ActorDiedError
        on the request they routed). Drop the dead replica, reconcile a
        replacement up to the target count, and bump the version so every
        handle refreshes its routing table."""
        entry = self._deployments.get(name)
        if entry is None:
            return self._version
        before = len(entry["replicas"])
        entry["replicas"] = [r for r in entry["replicas"]
                             if r._actor_id.binary() != actor_id]
        entry.get("loads", {}).pop(actor_id, None)
        if len(entry["replicas"]) != before:
            self._reconcile(name)
            self._version += 1
            # lifecycle events (controller runs inside an actor, so
            # these ride the worker's pipe push like any other event)
            try:
                from ray_tpu_torch.util import events

                events.emit("serve_replica_death", deployment=name,
                            actor_id=actor_id.hex(),
                            replicas_left=len(entry["replicas"]))
                events.emit("serve_reroute", deployment=name,
                            version=self._version,
                            target=entry.get("target", 1))
            except Exception:
                pass
        return self._version

    def _kill(self, replica) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    # -- routing table ----------------------------------------------------

    def get_routing_info(self, name: str):
        entry = self._deployments.get(name)
        if entry is None:
            return None
        return {
            "version": self._version,
            "replicas": list(entry["replicas"]),
            "max_ongoing_requests":
                entry["spec"]["config"].get("max_ongoing_requests", 8),
            "has_loads": bool(entry.get("loads")),
            "compiled": bool(entry["spec"]["config"].get("compiled")),
        }

    def get_version(self) -> int:
        return self._version

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: {
                "num_replicas": len(e["replicas"]),
                "target": e.get("target"),
            }
            for name, e in self._deployments.items()
        }

    # -- replica load reports (KV-aware routing + autoscaling) ------------

    def report_replica_load(self, name: str, actor_id: bytes,
                            load: Dict[str, Any]) -> None:
        """Replica-pushed load state ({inflight, kv_free, kv_total} from
        the deployment's ``load_state()``): the routing signal handles
        fold into their pick score, and the KV-occupancy input to
        autoscaling. Stamped on arrival so readers can age it out."""
        entry = self._deployments.get(name)
        if entry is None:
            return
        rec = dict(load)
        rec["ts"] = time.time()
        first = not entry.get("loads")
        entry.setdefault("loads", {})[actor_id] = rec
        if first:
            # first report flips the deployment's has_loads bit in the
            # routing info — bump the version so handles refetch it and
            # start consulting the KV view (handles of deployments that
            # never report skip the controller probe entirely)
            self._version += 1

    def get_replica_loads(self, name: str) -> Dict[bytes, Dict[str, Any]]:
        entry = self._deployments.get(name)
        if entry is None:
            return {}
        return dict(entry.get("loads", {}))

    def model_report(self) -> Dict[str, Any]:
        """Cluster-wide multi-model view (``rtpu list models`` /
        ``/api/models``): per deployment, each replica's resident
        models (with residency tier + swap counters from the registry)
        and its published prefix-digest summary — assembled from the
        SAME load reports routing runs on, so what this returns is
        exactly what handles see."""
        out: Dict[str, Any] = {}
        for name, entry in self._deployments.items():
            reps = {}
            for actor_id, rec in (entry.get("loads") or {}).items():
                if "models" not in rec:
                    continue
                reps[actor_id.hex()] = {
                    "models": rec.get("models", {}),
                    "prefix_digest": rec.get("prefix_digest", []),
                    "inflight": rec.get("inflight", 0),
                    "ts": rec.get("ts", 0.0),
                }
            if reps:
                out[name] = {"replicas": reps}
        return out

    # -- autoscaling ------------------------------------------------------

    def record_request_metrics(self, name: str, ongoing: float) -> None:
        self._metrics.setdefault(name, []).append((time.time(), ongoing))
        # keep the last minute
        cutoff = time.time() - 60.0
        self._metrics[name] = [(t, o) for t, o in self._metrics[name]
                               if t >= cutoff]

    def _desired_replicas(self, name: str) -> Optional[int]:
        """Autoscaling policy (reference ``autoscaling_policy.py`` plus a
        KV-pressure input): desired = max over the ongoing/target ratio
        and the KV-occupancy/target ratio — an LLM deployment can be
        KV-bound long before its request queue looks deep (one long
        context pins blocks for its whole stream)."""
        entry = self._deployments.get(name)
        if entry is None:
            return None
        cfg = entry["spec"]["config"].get("autoscaling_config")
        if not cfg:
            return None
        cur = max(len(entry["replicas"]), 1)
        desired = None
        samples = [o for _, o in self._metrics.get(name, [])]
        if samples:
            avg_ongoing = sum(samples) / len(samples)
            desired = avg_ongoing / max(cfg["target_ongoing_requests"],
                                        1e-9)
        target_kv = cfg.get("target_kv_utilization")
        if target_kv:
            cutoff = time.time() - 30.0
            # .get defaults throughout: load reports are whatever a user
            # deployment's load_state() returned — a missing key must
            # not fail every deployment's autoscale tick
            fracs = [1.0 - l.get("kv_free", 0) / l["kv_total"]
                     for l in entry.get("loads", {}).values()
                     if l.get("ts", 0) >= cutoff and l.get("kv_total")]
            if fracs:
                kv_desired = cur * (sum(fracs) / len(fracs)) / target_kv
                desired = max(desired or 0.0, kv_desired)
        if desired is None:
            return None
        import math

        new = cur
        if desired > cur:
            new = min(int(math.ceil(desired)), cfg["max_replicas"])
        elif desired < cur * cfg["downscale_factor"]:
            new = max(int(math.ceil(desired)), cfg["min_replicas"])
        return new

    def autoscale_tick(self) -> Dict[str, int]:
        """Apply the autoscaling policy (ongoing/target ratio plus KV
        occupancy, clamped)."""
        decisions = {}
        for name, entry in self._deployments.items():
            new = self._desired_replicas(name)
            if new is None or new == len(entry["replicas"]):
                continue
            entry["target"] = new
            self._reconcile(name)
            self._version += 1
            decisions[name] = new
        return decisions

    def v2_demand(self) -> List[Dict[str, float]]:
        """Pending replica demand as resource bundles — the bridge into
        autoscaler v2: feed this as (or into) the AutoscalerV2
        ``load_source`` so serve scale-up requests become node launches
        when the cluster itself is out of capacity."""
        bundles: List[Dict[str, float]] = []
        for name, entry in self._deployments.items():
            new = self._desired_replicas(name)
            if new is None:
                continue
            short = new - len(entry["replicas"])
            if short <= 0:
                continue
            opts = entry["spec"]["config"].get("ray_actor_options") or {}
            # unset num_cpus defaults to 1; an EXPLICIT 0 (the LLM
            # deployments here) must not advertise phantom CPU demand
            cpu = opts.get("num_cpus")
            cpu = 1.0 if cpu is None else float(cpu)
            bundle = {"CPU": cpu} if cpu > 0 else {}
            for k, v in (opts.get("resources") or {}).items():
                bundle[k] = float(v)
            bundles.extend(dict(bundle) for _ in range(short))
        return bundles
