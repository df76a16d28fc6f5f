"""Device plane: the registry of the card's compiled programs (twin of the
registry core of ``ray_tpu/util/device_plane.py``).

The reference compiles each hot entry point once with ``jax.jit`` through
``registered_jit`` and records every compile. The port's counterpart is
:func:`registered_graph`: each program is captured once per abstract
signature as a ``torch.cuda.CUDAGraph`` and then replayed, and each capture
is recorded here.

- **Registry** (:class:`CompiledProgramRegistry`): one row per program
  name with its component, the abstract signatures it was captured for
  (and the diff of each new one against the one before: the reference's
  "retrace", kept on the row since the events plane is not ported), the
  capture seconds, the calls, the FLOPs of one call (counted once per
  signature by ``torch.utils.flop_counter.FlopCounterMode``, the
  counterpart of XLA's ``cost_analysis``) and the bytes the capture added
  to the graph's memory pool (``torch.cuda.memory_stats``).
  :func:`program_flops_per_step` feeds the serving engine's achieved
  FLOP/s.
- **Census** (:func:`live_buffer_census`): live tensors grouped by dtype,
  shape and device; :func:`snapshot` bundles it with the program table
  and the CUDA allocator's watermarks.

``RTPU_DEVICE_PLANE=0`` turns the accounting off (no rows are kept). It
never turns capture off: a registered program on the card is captured and
replayed either way, and a capture or replay that fails raises.

Not ported until the runtime is: the federation (``DeviceStore``,
``merge_report``, ``node_processes``), the metrics and the
``jit_recompile`` event.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import config as _knobs

#: bounds — the registry is a bounded table
MAX_PROGRAMS = 256
MAX_SIGS = 8          # signature history kept per program
MAX_CENSUS_GROUPS = 32  # top-N live-tensor groups by bytes

_state: Dict[str, Any] = {"enabled": None}
_lock = threading.Lock()


def _resolve() -> bool:
    with _lock:
        if _state["enabled"] is None:
            _state["enabled"] = _knobs.get("device_plane") != "0"
        return _state["enabled"]


def device_plane_enabled() -> bool:
    """Hot-path arming check: one dict get."""
    e = _state["enabled"]
    if e is None:
        return _resolve()
    return e


def _reset_for_tests() -> None:
    global _registry
    with _lock:
        _state["enabled"] = None
    _registry = CompiledProgramRegistry()


# ---------------------------------------------------------------------------
# abstract signatures + diffs
# ---------------------------------------------------------------------------

def _flatten(tree: Any, path: str, out: List[Tuple[str, Any]]) -> None:
    """Leaves of nested dicts / lists / tuples with their paths, in the
    reference's ``keystr`` form (``[0]['params']['w']``). None is an empty
    subtree, as in a JAX pytree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", out)
    elif tree is not None:
        out.append((path, tree))


def _leaves(args: tuple, kwargs: dict) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _flatten(args, "args", out)
    _flatten(kwargs, "kwargs", out)
    return out


def _rebuild(tree: Any, it) -> Any:
    """``tree`` with its leaves replaced, in :func:`_flatten` order, by
    the items of ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return None if tree is None else next(it)


def _describe_leaf(x: Any) -> str:
    """``float32[4,8]`` for a tensor (or anything with a shape and a
    dtype), a bounded repr for a Python value."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return "%s[%s]" % (str(dtype).replace("torch.", ""),
                           ",".join(str(d) for d in shape))
    r = repr(x)
    return "py:%s:%s" % (type(x).__name__,
                         r if len(r) <= 40 else r[:37] + "...")


def abstract_signature(args: tuple, kwargs: dict) -> Dict[str, str]:
    """{argument path: leaf description} for a call — the unit a program
    row stores and diffs."""
    return {p: _describe_leaf(x) for p, x in _leaves(args, kwargs)}


def signature_diff(old: Dict[str, str],
                   new: Dict[str, str]) -> Dict[str, Any]:
    """What changed between the prior signature and the one that forced a
    new capture."""
    changed = {p: {"was": old[p], "now": new[p]}
               for p in new if p in old and old[p] != new[p]}
    added = {p: new[p] for p in new if p not in old}
    removed = {p: old[p] for p in old if p not in new}
    out: Dict[str, Any] = {}
    if changed:
        out["changed"] = changed
    if added:
        out["added"] = added
    if removed:
        out["removed"] = removed
    return out


def _leaf_key(x: Any) -> Tuple:
    """What a captured graph depends on besides the tensors' contents: a
    tensor's dtype, shape, strides and device, a Python value itself
    (it is baked into the graph)."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, tuple(x.shape), x.stride(), x.device)
    try:
        hash(x)
    except TypeError:
        return ("py", type(x).__name__, id(x))
    return ("py", type(x).__name__, x)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class CompiledProgramRegistry:
    """Per-process table of captured programs (bounded, LRU on insert).

    One row per program NAME — a re-created wrapper (a second serve engine
    in the same process) folds into the same row: its fresh captures
    count, but an already-seen signature is not a retrace. "compile" in
    the row's keys is a capture on the card (or, off the card, the first
    eager call of a signature)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._version = 0

    @property
    def version(self) -> int:
        return self._version

    def _row(self, name: str, component: str) -> Dict[str, Any]:
        rec = self._programs.get(name)
        if rec is None:
            while len(self._programs) >= MAX_PROGRAMS:
                self._programs.popitem(last=False)
            rec = {"program": name, "component": component, "steps": 1,
                   "donate": [], "sigs": [], "diffs": [], "compiles": 0,
                   "retraces": 0, "compile_s_total": 0.0,
                   "compile_s_last": 0.0, "calls": 0, "cost": None,
                   "memory": None, "last_compile_ts": 0.0}
            self._programs[name] = rec
        return rec

    def record_compile(self, name: str, component: str, *,
                       sig: Optional[Dict[str, str]], seconds: float,
                       donate: Tuple[int, ...] = (), steps: int = 1,
                       cost: Optional[Dict[str, float]] = None,
                       memory: Optional[Dict[str, int]] = None,
                       ) -> Optional[Dict[str, Any]]:
        """Fold one capture into the table. Returns the signature diff
        when this signature is NOVEL past the row's first (a retrace),
        else None."""
        diff = None
        with self._lock:
            rec = self._row(name, component)
            rec["compiles"] += 1
            rec["calls"] += 1
            rec["compile_s_total"] += seconds
            rec["compile_s_last"] = seconds
            rec["last_compile_ts"] = time.time()
            rec["steps"] = max(1, int(steps))
            if donate:
                rec["donate"] = sorted(set(rec["donate"]) | set(donate))
            if cost:
                rec["cost"] = cost
            if memory:
                rec["memory"] = memory
            if sig is not None and sig not in rec["sigs"]:
                if rec["sigs"]:
                    rec["retraces"] += 1
                    diff = signature_diff(rec["sigs"][-1], sig)
                    rec["diffs"].append(diff)
                    del rec["diffs"][:-MAX_SIGS]
                rec["sigs"].append(sig)
                del rec["sigs"][:-MAX_SIGS]
            self._version += 1
        return diff

    def note_call(self, name: str, component: str = "") -> None:
        # hot path: once the row exists the increment rides the GIL (a
        # slightly racy counter beats a lock acquisition per call)
        rec = self._programs.get(name)
        if rec is None:
            with self._lock:
                rec = self._row(name, component)
        rec["calls"] += 1

    def program(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._programs.get(name)
            return None if rec is None else _copy_row(rec)

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [_copy_row(r) for r in self._programs.values()]

    def flops_per_step(self, name: str) -> Optional[float]:
        """FLOPs of ONE step of ``name`` (a multi-step program's FLOPs a
        call over its ``steps``), or None when none were counted."""
        with self._lock:
            rec = self._programs.get(name)
            if rec is None or not rec["cost"]:
                return None
            flops = rec["cost"].get("flops")
            if not flops or flops <= 0:
                return None
            return float(flops) / max(1, int(rec["steps"]))


def _copy_row(rec: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(rec)
    out["sigs"] = [dict(s) for s in rec["sigs"]]
    out["diffs"] = [dict(d) for d in rec["diffs"]]
    out["donate"] = list(rec["donate"])
    if rec.get("cost"):
        out["cost"] = dict(rec["cost"])
    if rec.get("memory"):
        out["memory"] = dict(rec["memory"])
    return out


_registry = CompiledProgramRegistry()


def registry() -> CompiledProgramRegistry:
    return _registry


def program_flops_per_step(name: str) -> Optional[float]:
    return _registry.flops_per_step(name)


# ---------------------------------------------------------------------------
# the wrapper: capture once per signature, then replay
# ---------------------------------------------------------------------------

def _counted(fn: Callable, args: tuple, kwargs: dict) -> Tuple[Any, float]:
    """(fn's result, the FLOPs it ran, as ``FlopCounterMode`` counts
    them: matmuls, convolutions, attention)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, float(counter.get_total_flops())


class _Capture:
    """One signature's graph: its static inputs and outputs, and the
    addresses of the fixed arguments it reads and writes in place."""

    def __init__(self, graph, tree, statics, outputs, fixed_ptrs):
        self.graph = graph
        self.tree = tree            # (args, kwargs) over the static leaves
        self.statics = statics      # per leaf: its static copy, or None
        self.outputs = outputs
        self.fixed_ptrs = fixed_ptrs


class RegisteredGraph:
    """A program captured as a ``torch.cuda.CUDAGraph`` per abstract
    signature, with device-plane registration: the counterpart of the
    reference's ``jax.jit`` with the cache donated (``RegisteredFunction``).

    - On the card, a call with a new signature runs ``fn`` once on a side
      stream (the call's real work: its result is returned), then captures
      it into static input buffers and records the capture. A later call
      with the same signature copies its tensor arguments into those
      buffers and replays the graph; its result is the graph's static
      output, valid until the next call of this program.
    - Arguments in ``fixed_argnums`` (parameters, a cache the program
      updates in place, a caller's own staging buffers) are read where
      they are: the graph holds their addresses, so a later call must pass
      the same tensors, or call :meth:`reset` first. Every other tensor is
      copied in; Python values are part of the signature.
    - Capture and replay run under ``torch.inference_mode()``.
    - Off the card (every tensor on the CPU), or with ``capture=False``,
      ``fn`` runs eagerly and the rows are the same, a "compile" being the
      first call of a signature.
    - A failed capture or replay raises; nothing falls back to eager.
    """

    def __init__(self, fn: Callable, *, name: str, component: str = "",
                 steps: int = 1, fixed_argnums: Tuple[int, ...] = (),
                 capture: bool = True):
        self._fn = fn
        self._name = name
        self._component = component
        self._steps = int(steps)
        self._fixed = tuple(fixed_argnums)
        self._capture = bool(capture)
        self._graphs: Dict[Tuple, _Capture] = {}
        self._seen: set = set()     # signatures run eagerly so far

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def reset(self) -> None:
        """Drop every captured graph (and its memory pool): the next call
        of each signature captures again."""
        self._graphs.clear()

    def _is_fixed(self, path: str) -> bool:
        return any(path == f"args[{i}]" or path.startswith(f"args[{i}][")
                   for i in self._fixed)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        leaves = _leaves(args, kwargs)
        on_card = any(isinstance(x, torch.Tensor) and x.is_cuda
                      for _, x in leaves)
        key = tuple((p, _leaf_key(x)) for p, x in leaves)
        if on_card and self._capture:
            cap = self._graphs.get(key)
            if cap is None:
                return self._capture_graph(key, args, kwargs, leaves)
            return self._replay(cap, leaves)
        return self._eager(key, args, kwargs)

    # -- off the card, or capture off: eager with the same rows ------------

    def _eager(self, key, args, kwargs):
        if not device_plane_enabled():
            return self._fn(*args, **kwargs)
        if key in self._seen:
            out = self._fn(*args, **kwargs)
            _registry.note_call(self._name, self._component)
            return out
        t0 = time.perf_counter()
        out, flops = _counted(self._fn, args, kwargs)
        self._seen.add(key)
        _registry.record_compile(
            self._name, self._component, sig=abstract_signature(args, kwargs),
            seconds=time.perf_counter() - t0, donate=self._fixed,
            steps=self._steps, cost={"flops": flops})
        return out

    # -- on the card ----------------------------------------------------------

    def _capture_graph(self, key, args, kwargs, leaves):
        t0 = time.perf_counter()
        dev = next(x.device for _, x in leaves
                   if isinstance(x, torch.Tensor) and x.is_cuda)
        accounting = device_plane_enabled()
        statics = []
        for path, x in leaves:
            if isinstance(x, torch.Tensor) and not self._is_fixed(path):
                s = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                        device=x.device)
                s.copy_(x, non_blocking=True)
                statics.append(s)
            else:
                statics.append(None)
        tree = _rebuild((args, kwargs), iter(
            s if s is not None else x for s, (_, x) in zip(statics, leaves)))
        s_args, s_kwargs = tree
        with torch.inference_mode(), torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                if accounting:
                    out, flops = _counted(self._fn, s_args, s_kwargs)
                else:
                    out, flops = self._fn(*s_args, **s_kwargs), None
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_stats(dev).get(
                    "reserved_bytes.all.current", 0)
                outputs = self._fn(*s_args, **s_kwargs)
            pool_bytes = torch.cuda.memory_stats(dev).get(
                "reserved_bytes.all.current", 0) - reserved
        torch.cuda.synchronize(dev)
        fixed_ptrs = [x.data_ptr() for (p, x), s in zip(leaves, statics)
                      if s is None and isinstance(x, torch.Tensor)]
        self._graphs[key] = _Capture(graph, tree, statics, outputs,
                                     fixed_ptrs)
        if accounting:
            _registry.record_compile(
                self._name, self._component,
                sig=abstract_signature(args, kwargs),
                seconds=time.perf_counter() - t0, donate=self._fixed,
                steps=self._steps, cost={"flops": flops},
                memory={"graph_pool_bytes": int(pool_bytes)})
        return out

    def _replay(self, cap: _Capture, leaves):
        ptrs = [x.data_ptr() for (p, x), s in zip(leaves, cap.statics)
                if s is None and isinstance(x, torch.Tensor)]
        if ptrs != cap.fixed_ptrs:
            raise RuntimeError(
                f"{self._name}: a fixed argument is not the tensor the graph "
                "was captured with; call reset() after replacing it")
        with torch.inference_mode():
            for s, (_, x) in zip(cap.statics, leaves):
                if s is not None and x is not s:
                    s.copy_(x, non_blocking=True)
            cap.graph.replay()
        if device_plane_enabled():
            _registry.note_call(self._name, self._component)
        return cap.outputs


def registered_graph(fn: Optional[Callable] = None, *, name: str,
                     component: str = "", steps: int = 1,
                     fixed_argnums: Tuple[int, ...] = (),
                     capture: bool = True):
    """Wrap ``fn`` as a :class:`RegisteredGraph` (decorator-friendly): the
    counterpart of the reference's ``registered_jit``, a CUDA graph
    captured per signature in place of an XLA program compiled per
    signature. ``name`` is the program's registry identity
    (``"serve::decode_step_paged"``); ``steps`` declares how many steps
    one call runs, for :func:`program_flops_per_step`."""
    def wrap(f):
        return RegisteredGraph(f, name=name, component=component,
                               steps=steps, fixed_argnums=fixed_argnums,
                               capture=capture)
    return wrap if fn is None else wrap(fn)


def tracked_call(name: str, component: str, fn: Callable[[], Any],
                 args: tuple, statics: Optional[dict] = None) -> Any:
    """Registry hook for eager dispatchers: a novel (arrays, statics)
    signature is recorded as a compile of ``name``; a known one counts a
    call."""
    if not device_plane_enabled():
        return fn()
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    sig = abstract_signature(args, {**(statics or {})})
    rec = _registry.program(name)
    if rec is None or sig not in rec["sigs"]:
        _registry.record_compile(name, component, sig=sig, seconds=dt)
    else:
        _registry.note_call(name, component)
    return out


# ---------------------------------------------------------------------------
# census + snapshots
# ---------------------------------------------------------------------------

def live_buffer_census() -> Dict[str, Any]:
    """Live tensors (views not counted apart from their base) grouped by
    (dtype, shape, device), the top groups by bytes."""
    groups: Dict[Tuple[str, Tuple[int, ...], str], List[int]] = {}
    total_bytes = 0
    n = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): some module-level proxies warn when
        # their __class__ is read
        if not issubclass(type(obj), torch.Tensor) or obj._is_view():
            continue
        try:
            key = (str(obj.dtype).replace("torch.", ""), tuple(obj.shape),
                   str(obj.device))
            nbytes = obj.numel() * obj.element_size()
        except RuntimeError:  # a tensor without storage
            continue
        ent = groups.setdefault(key, [0, 0])
        ent[0] += 1
        ent[1] += nbytes
        total_bytes += nbytes
        n += 1
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])
    return {"buffers": n, "bytes": total_bytes,
            "groups": [{"dtype": k[0], "shape": list(k[1]), "device": k[2],
                        "count": c, "bytes": b}
                       for k, (c, b) in top[:MAX_CENSUS_GROUPS]]}


def _device_memory() -> Optional[Dict[str, int]]:
    """The CUDA allocator's watermarks on the current card, or None where
    CUDA was never initialised in this process."""
    if not torch.cuda.is_initialized():
        return None
    ms = torch.cuda.memory_stats()
    return {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": int(ms.get("reserved_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory)}


def snapshot(min_version: Optional[int] = None,
             census: bool = True) -> Optional[Dict[str, Any]]:
    """This process's device-plane unit: program table + the allocator's
    watermarks + live-tensor census. ``min_version`` gates a push path:
    None when nothing changed since (an empty registry never ships)."""
    reg = _registry
    with reg._lock:
        version = reg._version
        if min_version is not None and version <= min_version:
            return None
        programs = [_copy_row(r) for r in reg._programs.values()]
    snap: Dict[str, Any] = {"pid": os.getpid(), "version": version,
                            "programs": programs}
    mem = _device_memory()
    if mem:
        snap["hbm"] = mem
    if census:
        snap["live_buffers"] = live_buffer_census()
    return snap
