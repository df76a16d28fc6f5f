"""Deterministic failpoint framework (chaos-injection plane).

Role analog: the reference's release-gated chaos tests plus the classic
``SET_FAILPOINT`` pattern (TiKV/RocksDB ``fail::fail_point!``): named
injection *sites* threaded through the core runtime and cluster plane fire
configured *actions* when armed. Everything recovery-related in ray_tpu_torch
(task retries, actor restart, lineage reconstruction, node-death
re-placement, GCS snapshot FT) is driven through these sites by
``tests/test_chaos_matrix.py`` — each past recovery bug keeps its failpoint
armed there as its regression test.

Sites (grep ``failpoints.hit(`` for the live list)::

    worker.exec            before a task/actor call executes   (worker)
    worker.exec.before_result  after execute, before "done"    (worker)
    worker.pipe.send       worker -> driver control message    (worker)
    pipe.send              driver -> worker control message    (driver)
    store.seal             object store put/seal               (any)
    rpc.client.send        cluster RPC request/cast egress     (any)
    rpc.server.dispatch    cluster RPC handler entry           (GCS/daemon)
    gcs.heartbeat          node heartbeat egress               (adapter)
    daemon.lease_grant     peer-forwarded task acceptance      (daemon)
    adapter.pg.before_commit   between PG prepare and commit   (creator)
    data.exchange.ack      reducer-ack retirement              (driver)
    serve.kv_transfer      prefill->decode KV-block ship       (replica)

Spec grammar (one or more comma/semicolon-separated entries)::

    <site>=<action>[:<arg>][@<key>=<val>]...

    actions:  raise[:ExcName]   raise FailpointError (or OSError /
                                ConnectionError / TimeoutError / ValueError)
              delay:<seconds>   sleep, then continue
              drop              return True — the call site drops the
                                message / skips the operation
              kill              SIGKILL this process (crash, no cleanup)
              exit[:code]       os._exit (default 137)
    triggers: after=N           skip the first N hits
              times=K           fire at most K times (per process)
              p=P seed=S        fire with seeded probability P per hit
              arg=V             fire only when the site's payload == V
                                (e.g. RPC method name, task/method name)
              once=PATH         fire at most once ACROSS processes —
                                O_CREAT|O_EXCL on PATH elects the firer;
                                with times=K the budget is global: K
                                fires total, wherever the hits land

Arming:

- per-process: the ``RTPU_FAILPOINTS`` env var carries a spec string
  (inherited by spawned workers/daemons); ``RTPU_FAILPOINTS=0`` is the
  global kill switch — ``hit()`` can never fire and ``arm()`` no-ops.
- cluster-wide from tests: :func:`arm` applies locally, broadcasts to this
  driver's workers over the control pipe, and (in cluster mode) records
  the spec in the GCS KV (``__failpoints__`` namespace, durable through
  snapshots) and publishes on the ``failpoints`` pubsub channel, which
  daemons apply and relay to *their* workers. Late joiners pull the KV at
  registration.

Disabled cost: ``hit(site)`` is one dict ``get`` on a (normally empty)
module dict plus the attribute load — no locks, no allocation.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

#: KV namespace + key used for cluster-wide arming
KV_NAMESPACE = "__failpoints__"
KV_KEY = "specs"
#: pubsub channel daemons subscribe to
CHANNEL = "failpoints"


class FailpointError(RuntimeError):
    """Raised by a ``raise``-action failpoint (default exception type)."""


_EXC_TYPES = {
    "failpointerror": FailpointError,
    "oserror": OSError,
    "connectionerror": ConnectionError,
    "timeouterror": TimeoutError,
    "valueerror": ValueError,
    "runtimeerror": RuntimeError,
}

# the global kill switch: parsed once at import. "0"/"false"/... disables
# the whole plane for this process (and, via env inheritance, its children).
_raw_env = os.environ.get("RTPU_FAILPOINTS", "")
ENABLED = _raw_env.strip().lower() not in ("0", "false", "no", "off")

#: site -> _Failpoint. THE hot-path structure: empty when nothing is armed,
#: so ``hit()`` is a single failed dict lookup.
_armed: Dict[str, "_Failpoint"] = {}
_arm_lock = threading.Lock()


def _fired_metric():
    from ray_tpu_torch.util import metric_defs

    return metric_defs.get("rtpu_failpoints_fired_total")


class _Failpoint:
    __slots__ = ("site", "action", "arg", "after", "times", "prob", "rng",
                 "match", "once_path", "hits", "fired", "lock", "spec")

    def __init__(self, site: str, action: str, arg: Optional[str],
                 opts: Dict[str, str], spec: str):
        self.site = site
        self.action = action
        self.arg = arg
        self.spec = spec
        self.after = int(opts.get("after", 0))
        self.times = int(opts["times"]) if "times" in opts else None
        self.prob = float(opts["p"]) if "p" in opts else None
        if self.prob is not None:
            import random

            self.rng = random.Random(int(opts.get("seed", 0)))
        else:
            self.rng = None
        self.match = opts.get("arg")
        self.once_path = opts.get("once")
        self.hits = 0
        self.fired = 0
        self.lock = threading.Lock()

    def _should_fire(self, payload) -> bool:
        if self.match is not None and str(payload) != self.match:
            return False
        with self.lock:
            self.hits += 1
            if self.hits <= self.after:
                return False
            if self.times is not None and self.fired >= self.times:
                return False
            if self.prob is not None and self.rng.random() >= self.prob:
                return False
            if self.once_path is not None:
                # cross-process at-most-once election: O_CREAT|O_EXCL is
                # atomic on a shared filesystem — exactly one process (and
                # one hit in it) wins each slot. With times=K the budget
                # is GLOBAL (K slots: PATH.0..PATH.K-1) instead of
                # per-process — "fail the first K executions, wherever
                # they land".
                budget = self.times if self.times is not None else 1
                won = False
                for slot in range(budget):
                    path = (self.once_path if budget == 1
                            else f"{self.once_path}.{slot}")
                    try:
                        fd = os.open(path,
                                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                        os.close(fd)
                        won = True
                        break
                    except OSError:
                        continue
                if not won:
                    return False
            self.fired += 1
        return True

    def fire(self, payload) -> bool:
        if not self._should_fire(payload):
            return False
        try:
            _fired_metric().inc(tags={"site": self.site})
        except Exception:
            pass
        act = self.action
        if act == "delay":
            import time

            time.sleep(float(self.arg or 0.1))
            return False
        if act == "drop":
            return True
        if act == "raise":
            exc = _EXC_TYPES.get((self.arg or "").lower(), FailpointError)
            raise exc(f"failpoint {self.site} fired"
                      + (f" (payload={payload!r})" if payload else ""))
        if act == "kill":
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
            return True  # unreachable
        if act == "exit":
            os._exit(int(self.arg or 137))
        raise ValueError(f"unknown failpoint action {act!r}")


def hit(site: str, payload: Any = None) -> bool:
    """The injection hook. Returns True when a ``drop`` action fired (the
    call site is responsible for dropping the message / skipping the
    operation); raises / sleeps / kills for the other actions. One dict
    lookup when nothing is armed at this site."""
    fp = _armed.get(site)
    if fp is None:
        return False
    return fp.fire(payload)


def parse_specs(spec_str: str) -> List[_Failpoint]:
    out = []
    for entry in spec_str.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, rhs = entry.partition("=")
        if not rhs:
            raise ValueError(f"bad failpoint spec {entry!r} "
                             "(want site=action[:arg][@k=v...])")
        parts = rhs.split("@")
        action, _, arg = parts[0].partition(":")
        action = action.strip()
        arg = arg.strip() or None
        # validate HERE, not at the hit site: a typo'd spec must fail the
        # arm() call, never detonate cluster-wide at every injection point
        if action not in ("raise", "delay", "drop", "kill", "exit"):
            raise ValueError(f"unknown failpoint action {action!r} "
                             f"in {entry!r}")
        if action == "delay":
            float(arg or 0.1)
        if action == "exit":
            int(arg or 137)
        opts: Dict[str, str] = {}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            opts[k.strip()] = v.strip()
        out.append(_Failpoint(site.strip(), action, arg, opts, entry))
    return out


def apply_spec(spec_str: str) -> None:
    """Arm the given specs in THIS process only (no propagation).

    Re-applying a spec IDENTICAL to the one already armed at a site is a
    no-op that keeps the live trigger counters: cluster arming delivers
    the same spec more than once (pubsub echo to the arming driver, KV
    sync racing the pubsub push on daemons, ready-push racing the relay
    on workers), and a re-delivery must never reset an after=/times=
    budget mid-test. Re-arm a site with a *different* spec (or disarm
    first) to reset it."""
    if not ENABLED:
        return
    for fp in parse_specs(spec_str):
        with _arm_lock:
            cur = _armed.get(fp.site)
            if cur is not None and cur.spec == fp.spec:
                continue
            _armed[fp.site] = fp


def clear(site: Optional[str] = None) -> None:
    """Disarm one site (or all) in THIS process only."""
    with _arm_lock:
        if site is None:
            _armed.clear()
        else:
            _armed.pop(site, None)


def active_specs() -> List[str]:
    with _arm_lock:
        return [fp.spec for fp in _armed.values()]


def _runtime():
    from ray_tpu_torch.core import runtime as rt

    return rt._runtime


def arm(spec_str: str) -> None:
    """Arm failpoints from a test/driver: applies locally, pushes to this
    runtime's workers over the control pipe, and broadcasts cluster-wide
    (GCS KV + pubsub) when a cluster adapter is attached. No-op under the
    ``RTPU_FAILPOINTS=0`` kill switch."""
    if not ENABLED:
        return
    parse_specs(spec_str)  # validate before shipping anywhere
    apply_spec(spec_str)
    rt = _runtime()
    if rt is None:
        return
    _broadcast_local(rt, spec_str)
    cluster = getattr(rt, "cluster", None)
    if cluster is not None:
        try:
            prev = cluster.kv_op("get", KV_KEY, KV_NAMESPACE)
            merged = ((prev.decode() + ",") if prev else "") + spec_str
            cluster.kv_op("put", KV_KEY, merged.encode(), KV_NAMESPACE, True)
            cluster.gcs.call("fp_arm", spec_str, timeout=10)
            cluster.gcs.call("publish", CHANNEL,
                             {"op": "arm", "spec": spec_str}, timeout=10)
        except Exception:
            pass


def disarm() -> None:
    """Disarm everything, everywhere this driver can reach."""
    clear()
    rt = _runtime()
    if rt is None:
        return
    _broadcast_local(rt, None)
    cluster = getattr(rt, "cluster", None)
    if cluster is not None:
        try:
            cluster.kv_op("del", KV_KEY, KV_NAMESPACE)
            cluster.gcs.call("fp_disarm", timeout=10)
            cluster.gcs.call("publish", CHANNEL, {"op": "disarm"},
                             timeout=10)
        except Exception:
            pass


def _broadcast_local(rt, spec_str: Optional[str]) -> None:
    """Push an arm/disarm to every worker of this runtime; remember the
    armed specs so workers spawned later get them on dial-back."""
    if not getattr(rt, "is_driver", False):
        return
    if spec_str is None:
        rt._fp_specs = None
    else:
        # accumulate across arm() calls (mirrors the GCS KV merge):
        # workers spawned later must receive EVERY armed spec, not just
        # the most recent one. Entry-dedupe so re-deliveries (pubsub
        # echo) don't grow the string unboundedly.
        prev = getattr(rt, "_fp_specs", None)
        entries = prev.split(",") if prev else []
        for e in spec_str.split(","):
            if e and e not in entries:
                entries.append(e)
        rt._fp_specs = ",".join(entries) or None
    for ws in list(getattr(rt, "workers", {}).values()):
        if ws.status == "dead" or ws.conn is None:
            continue
        try:
            ws.send(("fp", spec_str))
        except Exception:
            pass


def sync_from_kv(kv_get) -> None:
    """Pull + apply the cluster-wide spec (late joiners / re-registration).
    ``kv_get(key, namespace) -> Optional[bytes]``."""
    if not ENABLED:
        return
    try:
        blob = kv_get(KV_KEY, KV_NAMESPACE)
    except Exception:
        return
    if blob:
        try:
            apply_spec(blob.decode())
        except Exception:
            pass


# arm anything the environment carries (worker/daemon processes inherit
# the driver's env; tests export RTPU_FAILPOINTS for subprocesses)
if ENABLED and _raw_env.strip().lower() not in ("", "1", "true", "yes",
                                                "on"):
    try:
        apply_spec(_raw_env)
    except ValueError:
        pass
