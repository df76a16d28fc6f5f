"""Multi-model serving (twin of ``ray_tpu/serve/multiplex.py``): the model
registry, the multiplexed and speculative deployments, and speculative
decoding over the paged engine.

- :class:`ModelRegistry` — a replica's catalog of models: full weight sets
  and LoRA-style deltas over a shared base (``models/delta.py``). Cold
  weights live in the object store through ``ray_tpu_torch.put`` (a
  process outside a runtime keeps an in-process host copy); a model is
  moved to the device on first use and LRU-evicted under a byte budget,
  never while an in-flight request pins it. When everything resident is
  pinned, a request sheds with ``RequestShedError(reason="model_budget")``.
- :class:`MultiplexedLLMDeployment` — one replica serving many models:
  a :class:`~ray_tpu_torch.serve.llm.LLMDeployment` per model, created on
  the model's first request, whose params page in and out through the
  registry (the engine's ``params_provider`` / ``drop_params``). Its load
  report adds the resident-model digest and the merged prefix digest that
  ``serve/handle.py`` routes on. Eviction drops the engine's params and,
  with them, its captured CUDA graphs and their memory pools (a graph
  holds the params' addresses).
- :class:`SpeculativeLLMDeployment` — ``LLMDeployment`` over a
  :class:`SpeculativeLLMEngine`.
- :class:`SpeculativeLLMEngine` — greedy speculative decoding: a drafter
  proposes up to ``spec_k`` tokens a round and the target verifies them in
  ONE batched :func:`~ray_tpu_torch.models.verify_step_paged` call
  (all-position logits), registered and captured as
  ``serve::verify_step_paged``. Emitted tokens are always the target's
  exact greedy sequence: a draft token is accepted iff it equals the
  target's argmax at that position, and the first mismatch is replaced by
  that argmax, so a round advances ``accepted + 1`` tokens for one target
  step. A per-request acceptance EWMA drops a request to plain decoding
  when its drafts stop landing.
- Drafters: ``"ngram"`` (prompt lookup, no model cost) and ``"model"`` (a
  small draft model with the target's vocabulary, on its own paged cache,
  its step registered and captured as ``serve::mux_decode_step``).

Everything here stays on the public task / actor / object API: weights
travel as ordinary objects and residency is read through
``ray_tpu_torch.util.state.object_store_tier``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ray_tpu_torch import config as _knobs
from ray_tpu_torch import models
from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.delta import target_shapes
from ray_tpu_torch.models.transformer import torch_dtype
from ray_tpu_torch.serve.admission import RequestShedError
from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine, _Request, \
    _Staging


def _registry_metrics() -> Dict[str, Any]:
    from ray_tpu_torch.util import metric_defs as md

    return {"swaps": md.get("rtpu_serve_model_swaps_total"),
            "resident": md.get("rtpu_serve_model_resident"),
            "bytes": md.get("rtpu_serve_model_resident_bytes"),
            "sheds": md.get("rtpu_serve_admission_sheds_total")}


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over a nested dict's leaves (a non-dict leaf such as a
    delta's ``scale`` passes through unchanged unless it is a tensor)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy the registry owns (not a view of the caller's tensor)."""
    return t.detach().to("cpu", copy=True)


class ModelRegistry:
    """A replica's model catalog with store-paged weights.

    ``register`` parks a model's HOST weights in the object store (one
    ``ray_tpu_torch.put``, whose spill tier ages cold models to disk;
    outside a runtime an in-process host copy stands in).
    ``ensure_resident`` moves them to ``device`` on demand, LRU-evicting
    unpinned models past ``budget_bytes``; ``pin`` / ``unpin`` bracket every
    in-flight request so its model is never paged out mid-decode. A delta
    variant (``base=..., delta=...``) materialises through
    :func:`~ray_tpu_torch.models.apply_delta` over the resident base: its
    untouched leaves ARE the base's tensors, and it is charged only its
    unique bytes (its rebuilt projections and its factors).

    Thread-safe; materialisation runs under the lock, so a swap-in is
    atomic against the evictor.
    """

    def __init__(self, *, budget_bytes: Optional[int] = None,
                 device: Optional[Device] = None):
        self.budget_bytes = int(
            budget_bytes if budget_bytes is not None
            else _knobs.get("serve_model_budget_bytes"))
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._metrics = _registry_metrics()

    # -- catalog -----------------------------------------------------------

    def register(self, model_id: str, config: Any = None, *,
                 params: Any = None, base: Optional[str] = None,
                 delta: Any = None, seed: int = 0) -> None:
        """Add a model. ``config`` is a preset name or ``TransformerConfig``
        (a variant inherits its base's when omitted); ``params`` an
        optional dict of tensors (drawn from a ``torch.Generator`` seeded
        with ``seed``, on the registry's device, when absent, as
        ``LLMEngine`` draws them); ``base`` + ``delta`` registers a
        LoRA-style variant over an already-registered base."""
        import ray_tpu_torch

        with self._lock:
            if model_id in self._entries:
                raise ValueError(f"model {model_id!r} already registered")
            if base is not None:
                be = self._entries.get(base)
                if be is None:
                    raise ValueError(
                        f"base {base!r} of {model_id!r} is not registered")
                if delta is None:
                    raise ValueError(
                        f"variant {model_id!r} names base={base!r} but "
                        "carries no delta")
                cfg = be["config"] if config is None else config
            else:
                if config is None:
                    raise ValueError(
                        f"model {model_id!r} needs a config (or a base)")
                cfg = config
            if isinstance(cfg, str):
                cfg = models.get_config(cfg)

            if base is None:
                if params is None:
                    gen = torch.Generator(device=self.device).manual_seed(
                        seed)
                    params = models.init_params(gen, cfg,
                                                device=self.device)
                host = _tree_map(_to_host, params)
                nbytes = models.params_bytes(host)
            else:
                # the variant's host payload is its (small) delta; its
                # resident charge is the rebuilt projections plus the
                # factors: every other leaf is shared with the base
                host = _tree_map(_to_host, delta)
                itemsize = torch_dtype(cfg.param_dtype).itemsize
                shapes = target_shapes(cfg)
                nbytes = models.delta_bytes(host) + sum(
                    cfg.n_layers * shapes[t][0] * shapes[t][1] * itemsize
                    for t in host["targets"])

            ref = None
            if ray_tpu_torch.is_initialized():
                ref = ray_tpu_torch.put(host)
                host = None  # the store owns the cold copy
            self._entries[model_id] = {
                "config": cfg, "ref": ref, "host": host, "bytes": nbytes,
                "params": None, "pins": 0, "last_used": 0.0,
                "swaps_in": 0, "swaps_out": 0, "base": base,
                "evict_cb": None,
            }

    def __contains__(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._entries

    def models(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def config_of(self, model_id: str):
        with self._lock:
            return self._entries[model_id]["config"]

    def bind(self, model_id: str, evict_cb: Callable[[], None]) -> None:
        """Attach the engine's drop hook that eviction fires (the engine and
        the registry hold the SAME params dict)."""
        with self._lock:
            self._entries[model_id]["evict_cb"] = evict_cb

    # -- pinning (in-flight requests) --------------------------------------

    def pin(self, model_id: str) -> None:
        with self._lock:
            self._entries[model_id]["pins"] += 1

    def unpin(self, model_id: str) -> None:
        with self._lock:
            e = self._entries[model_id]
            if e["pins"] <= 0:
                raise RuntimeError(f"unpin of unpinned model {model_id!r}")
            e["pins"] -= 1

    # -- residency ---------------------------------------------------------

    def _fetch_host(self, e: Dict[str, Any]):
        if e["host"] is not None:
            return e["host"]
        import ray_tpu_torch

        return ray_tpu_torch.get(e["ref"])

    def _materialize(self, e: Dict[str, Any]):
        host = self._fetch_host(e)
        dev = self.device

        def to_device(t):
            return t.to(dev, copy=True)
        if e["base"] is None:
            return _tree_map(to_device, host)
        base_params = self._ensure_resident_locked(e["base"])
        return models.apply_delta(base_params, _tree_map(to_device, host))

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e["bytes"] for e in self._entries.values()
                       if e["params"] is not None)

    def _evict_for(self, need: int, keep: str) -> None:
        """Make room for ``need`` bytes (the caller holds the lock)."""
        if self.budget_bytes <= 0:
            return
        while True:
            resident = sum(e["bytes"] for e in self._entries.values()
                           if e["params"] is not None)
            if resident + need <= self.budget_bytes:
                return
            victims = [(mid, e) for mid, e in self._entries.items()
                       if e["params"] is not None and e["pins"] == 0
                       and mid != keep]
            if not victims:
                self._metrics["sheds"].inc(tags={"reason": "model_budget"})
                raise RequestShedError(
                    f"model {keep!r} needs {need} resident bytes but the "
                    f"budget ({self.budget_bytes}) is held by pinned "
                    "models", reason="model_budget")
            mid, e = min(victims, key=lambda kv: kv[1]["last_used"])
            e["params"] = None
            e["swaps_out"] += 1
            self._metrics["swaps"].inc(tags={"direction": "out"})
            if e["evict_cb"] is not None:
                e["evict_cb"]()

    def _ensure_resident_locked(self, model_id: str):
        e = self._entries.get(model_id)
        if e is None:
            raise KeyError(f"unknown model {model_id!r}")
        if e["params"] is None:
            self._evict_for(e["bytes"], keep=model_id)
            e["params"] = self._materialize(e)
            e["swaps_in"] += 1
            self._metrics["swaps"].inc(tags={"direction": "in"})
        e["last_used"] = time.monotonic()
        return e["params"]

    def ensure_resident(self, model_id: str):
        """The device params of ``model_id`` (swap-in on a miss, LRU
        eviction for room). Raises ``RequestShedError`` (reason
        ``model_budget``) when nothing can be evicted."""
        with self._lock:
            return self._ensure_resident_locked(model_id)

    # -- introspection -----------------------------------------------------

    def _tier(self, e: Dict[str, Any]) -> str:
        if e["params"] is not None:
            return "hbm"
        if e["ref"] is None:
            return "host"
        from ray_tpu_torch.util.state import object_store_tier

        return {"shm": "host", "spilled": "spilled"}.get(
            object_store_tier(e["ref"]), "host")

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per model: its tier (``hbm`` resident on the device, ``host`` in
        the store or the in-process copy, ``spilled`` in the store's disk
        tier), bytes, pins, swaps in and out, base, and residency."""
        with self._lock:
            out = {
                mid: {"state": self._tier(e), "bytes": e["bytes"],
                      "pins": e["pins"], "swaps_in": e["swaps_in"],
                      "swaps_out": e["swaps_out"], "base": e["base"],
                      "resident": e["params"] is not None}
                for mid, e in self._entries.items()
            }
        by_state: Dict[str, int] = {}
        for rec in out.values():
            by_state[rec["state"]] = by_state.get(rec["state"], 0) + 1
        for state, n in by_state.items():
            self._metrics["resident"].set(n, tags={"state": state})
        self._metrics["bytes"].set(
            sum(r["bytes"] for r in out.values() if r["resident"]))
        return out

    def free(self) -> None:
        """Drop every store ref and every resident model (replica
        shutdown: no weight object outlives the deployment in the
        store)."""
        with self._lock:
            refs = [e["ref"] for e in self._entries.values()
                    if e["ref"] is not None]
            for e in self._entries.values():
                e["ref"] = None
                e["params"] = None
        if refs:
            import ray_tpu_torch

            ray_tpu_torch.free(refs)


class _NgramDraft:
    """Prompt-lookup drafting: the last ``n``-gram of the request's history
    is searched backwards through the history itself, and the tokens
    FOLLOWING its most recent earlier occurrence become the draft."""

    def __init__(self, n: int = 3):
        self.n = max(1, int(n))

    def propose(self, req: _Request, k: int, engine: "SpeculativeLLMEngine",
                slot: int) -> List[int]:
        hist = engine._spec_state(req)["hist"]
        n = min(self.n, len(hist) - 1)
        while n >= 1:
            pat = hist[-n:]
            for s in range(len(hist) - n - 1, -1, -1):
                if hist[s:s + n] == pat:
                    return [int(t) for t in hist[s + n:s + n + k]]
            n -= 1
        return []

    def prune(self, live: Set[_Request]) -> None:  # stateless
        pass


class _ModelDraft:
    """Model drafting: a small draft model (the target's vocabulary) on its
    OWN paged cache, with one fixed table per target slot. Each round it
    catches up on the committed history in chunks (feeding again overwrites
    any rejected draft's KV), then rolls the draft forward a token at a
    time. ``fed`` counts COMMITTED tokens only, so a rejected draft costs
    nothing to undo."""

    def __init__(self, config: Any = None, params: Any = None, *,
                 seed: int = 1):
        self._config = config
        self._params_in = params
        self._seed = seed
        self._ready = False

    def _ensure(self, engine: "SpeculativeLLMEngine") -> None:
        if self._ready:
            return
        cfg = self._config if self._config is not None else engine.config
        if isinstance(cfg, str):
            cfg = models.get_config(cfg)
        if cfg.vocab_size != engine.config.vocab_size:
            raise ValueError(
                f"draft vocab {cfg.vocab_size} != target vocab "
                f"{engine.config.vocab_size} (tokens must be "
                "interchangeable)")
        dev = engine.device
        self.cfg = cfg
        if self._params_in is not None:
            self.params = self._params_in
        else:
            gen = torch.Generator(device=dev).manual_seed(self._seed)
            self.params = models.init_params(gen, cfg, device=dev)
        self.S = engine.max_slots
        self.W = engine._tbl_width
        self.C = engine.prefill_chunk
        nb = self.S * self.W
        self._cache = models.init_cache_paged(cfg, nb, engine.pool.block_size,
                                              device=dev)
        self._tables = torch.arange(nb, dtype=torch.int64,
                                    device=dev).reshape(self.S, self.W)
        self._in = _Staging({"tokens": (self.S, self.C), "pos": (self.S,),
                             "nvalid": (self.S,), "active": (self.S,)}, dev)
        self._out = engine._out

        def raw(params, cache, tokens, tables, pos, nvalid, active):
            return models.decode_step_paged(params, cache, tokens, tables,
                                            pos, nvalid, cfg,
                                            active=active)[0]

        self._step = engine._program(raw, "serve::mux_decode_step",
                                     fixed=range(7))
        self._bound: List[Optional[_Request]] = [None] * self.S
        self._fed = [0] * self.S
        self._ready = True

    def _advance(self, slot: int, toks: List[int], pos0: int) -> np.ndarray:
        self._in.clear()
        a = self._in.np
        a["tokens"][slot, :len(toks)] = toks
        a["nvalid"][slot] = len(toks)
        a["active"][slot] = 1
        a["pos"][slot] = pos0
        self._in.send()
        v = self._in.views
        logits = self._step(self.params, self._cache, v["tokens"],
                            self._tables, v["pos"], v["nvalid"], v["active"])
        return self._out.fetch(logits)[slot]

    def propose(self, req: _Request, k: int, engine: "SpeculativeLLMEngine",
                slot: int) -> List[int]:
        self._ensure(engine)
        if self._bound[slot] is not req:
            self._bound[slot] = req
            self._fed[slot] = 0
        hist = engine._spec_state(req)["hist"]
        fed = self._fed[slot]
        logits = None
        while fed < len(hist):
            n = min(self.C, len(hist) - fed)
            logits = self._advance(slot, hist[fed:fed + n], fed)
            fed += n
        self._fed[slot] = fed
        if logits is None:  # pragma: no cover - hist grows every round
            return []
        out = [int(np.argmax(logits))]
        while len(out) < k:
            logits = self._advance(slot, [out[-1]], fed + len(out) - 1)
            out.append(int(np.argmax(logits)))
        return out[:k]

    def prune(self, live: Set[_Request]) -> None:
        if not self._ready:
            return
        for i, r in enumerate(self._bound):
            if r is not None and r not in live:
                self._bound[i] = None
                self._fed[i] = 0


class SpeculativeLLMEngine(LLMEngine):
    """Greedy speculative decoding over the paged slot engine.

    Every step is ONE batched ``verify_step_paged`` call (all-position
    logits): prefilling slots feed prompt chunks as the base engine does,
    decoding slots feed ``[last_token, d_1..d_k']`` and accept the longest
    draft prefix that matches the target's own argmax chain, so the
    emitted tokens are the plain greedy sequence by construction. KV
    written at rejected positions is never attended (the visibility mask
    stops at the request's committed position) and is overwritten by the
    next round's feed before it could be.

    Requires ``paged=True`` and greedy sampling (``temperature <= 0``).
    """

    SPEC_WARMUP = 6  # rounds before the acceptance EWMA may trip

    def __init__(self, config, params=None, *, spec_k: Optional[int] = None,
                 drafter: str = "ngram", draft_model: Any = None,
                 draft_params: Any = None, draft_seed: int = 1,
                 spec_accept_floor: Optional[float] = None,
                 ngram: int = 3, **kw):
        self.spec_k = int(spec_k if spec_k is not None
                          else _knobs.get("spec_k"))
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        self.spec_accept_floor = float(
            spec_accept_floor if spec_accept_floor is not None
            else _knobs.get("spec_accept_floor"))
        if kw.get("temperature", 0.0) > 0.0:
            raise ValueError(
                "speculative decoding requires greedy sampling "
                "(temperature <= 0): lossless acceptance is defined "
                "against the target's deterministic argmax chain")
        if not kw.get("paged", True):
            raise ValueError("speculative decoding requires paged=True")
        if drafter not in ("ngram", "model"):
            raise ValueError(
                f"unknown drafter {drafter!r} (want 'ngram' or 'model')")
        # the slot grid's chunk width carries BOTH prefill chunks and the
        # verify window [last, d1..dk]
        pc = int(kw.get("prefill_chunk") or _knobs.get("llm_prefill_chunk"))
        kw["prefill_chunk"] = max(pc, self.spec_k + 1)
        super().__init__(config, params, **kw)
        self._verify_fn = self._program(self._raw_verify_paged,
                                        "serve::verify_step_paged",
                                        fixed=range(7))
        self._param_programs.append(self._verify_fn)
        self._draft = (_NgramDraft(n=ngram) if drafter == "ngram"
                       else _ModelDraft(draft_model, draft_params,
                                        seed=draft_seed))
        self.drafter = drafter
        # per-request speculation state, identity-keyed (_Request is
        # eq=False); pruned to the live slots every step
        self._spec: Dict[_Request, Dict[str, Any]] = {}
        self.stats.update(spec_rounds=0, spec_proposed=0, spec_accepted=0,
                          spec_fallbacks=0)

    @staticmethod
    def _init_metrics() -> Dict[str, Any]:
        from ray_tpu_torch.util import metric_defs as md

        m = LLMEngine._init_metrics()
        m.update(spec_rounds=md.get("rtpu_spec_rounds_total"),
                 spec_proposed=md.get("rtpu_spec_proposed_tokens_total"),
                 spec_accepted=md.get("rtpu_spec_accepted_tokens_total"),
                 spec_fallbacks=md.get("rtpu_spec_fallbacks_total"))
        return m

    def _raw_verify_paged(self, params, cache, tokens, tables, pos, nvalid,
                          active):
        return models.verify_step_paged(params, cache, tokens, tables, pos,
                                        nvalid, self.config,
                                        active=active)[0]

    def _spec_state(self, req: _Request) -> Dict[str, Any]:
        st = self._spec.get(req)
        if st is None:
            st = {"ewma": 1.0, "rounds": 0, "off": False, "hist": None}
            self._spec[req] = st
        return st

    @torch.inference_mode()
    def step(self) -> bool:
        """The base loop with multi-token emission: a decoding slot may
        route up to ``accepted + 1`` tokens a step."""
        active_now, have_pending = self._sweep_and_admit()
        if active_now == 0:
            if self._spec:
                self._spec.clear()
                self._draft.prune(set())
            self._sample_gauges()
            return have_pending
        self._ensure_params()

        t0 = time.perf_counter()
        emitted, nvalid = self._advance_spec()
        if self.stats["steps"] > 0:
            self.admission.observe_step(time.perf_counter() - t0)

        now = time.monotonic()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if req.consumed < len(req.prompt):
                req.consumed += int(nvalid[i])
                if req.consumed < len(req.prompt):
                    continue  # still prefilling; nothing sampled yet
            for tok in emitted[i]:
                req.last_token = tok
                req.generated += 1
                req.gen_tokens.append(tok)
                self._observe_emit(req, now)
                if req.prefill_only:
                    self._emit_prefill_export(i, req, tok)
                    break  # slot cleared by the export
                req.emit(tok)
                self.stats["tokens_generated"] += 1
                if req.generated >= req.max_new_tokens or (
                        req.eos is not None and tok == req.eos):
                    with self._lock:
                        self._release_blocks(req, insert=True)
                    req.emit(None)
                    self._slots[i] = None
                    break
        live = {r for r in self._slots if r is not None}
        if len(self._spec) > len(live):
            self._spec = {r: st for r, st in self._spec.items() if r in live}
            self._draft.prune(live)
        self.stats["steps"] += 1
        self._sample_gauges()
        return True

    def _advance_spec(self) -> Tuple[List[List[int]], np.ndarray]:
        """One verify round: build the batch (prefill chunks as usual,
        draft windows for decoders), run the all-logits step, accept.
        Returns each slot's emitted tokens and the fed counts (the step
        loop advances ``consumed`` with them for prefill rows)."""
        C = self.prefill_chunk
        a = self._fill_paged()
        drafted: List[List[int]] = [[] for _ in range(self.max_slots)]
        for i, req in enumerate(self._slots):
            if req is None or req.consumed < len(req.prompt):
                continue
            st = self._spec_state(req)
            if st["hist"] is None:
                # first decode round: committed history = prompt + the
                # token sampled when prefill finished
                st["hist"] = req.prompt.tolist() + [req.last_token]
            d: List[int] = []
            if not st["off"] and not req.prefill_only:
                # clamp so the round never writes past the claimed table:
                # accepted + 1 <= k' + 1 stays within max_new_tokens
                k = min(self.spec_k, C - 1,
                        req.max_new_tokens - req.generated - 1)
                if k > 0:
                    d = self._draft.propose(req, k, self, i)[:k]
            drafted[i] = d
            a["tokens"][i, 1:1 + len(d)] = d
            a["nvalid"][i] = 1 + len(d)
        nvalid = a["nvalid"].copy()
        self._in.send()
        logits_h = self._out.fetch(
            self._verify_fn(*self._paged_args()))          # [B, C, V]

        emitted: List[List[int]] = [[] for _ in range(self.max_slots)]
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            n = int(nvalid[i])
            if req.consumed < len(req.prompt):
                req.pos += n
                if req.consumed + n >= len(req.prompt):
                    # the prompt completes this step: its last valid
                    # position's logits seed generation
                    emitted[i] = [int(np.argmax(logits_h[i, n - 1]))]
                continue
            d = drafted[i]
            toks = [int(np.argmax(logits_h[i, 0]))]
            accepted = 0
            for j, dt in enumerate(d):
                if dt != toks[-1]:
                    break  # mismatch: toks[-1] IS the correction
                accepted += 1
                toks.append(int(np.argmax(logits_h[i, j + 1])))
            # commit the accepted prefix + the target token: pos advances
            # past what the greedy chain confirmed, never past what was fed
            req.pos += accepted + 1
            st = self._spec_state(req)
            if d:
                m = self._metrics
                self.stats["spec_rounds"] += 1
                self.stats["spec_proposed"] += len(d)
                self.stats["spec_accepted"] += accepted
                m["spec_rounds"].inc()
                m["spec_proposed"].inc(len(d))
                if accepted:
                    m["spec_accepted"].inc(accepted)
                st["rounds"] += 1
                st["ewma"] = 0.5 * st["ewma"] + 0.5 * (accepted / len(d))
                if (st["rounds"] >= self.SPEC_WARMUP
                        and st["ewma"] < self.spec_accept_floor):
                    # acceptance collapsed: plain decoding from here on
                    # (k' = 0 rides the same verify program)
                    st["off"] = True
                    self.stats["spec_fallbacks"] += 1
                    m["spec_fallbacks"].inc()
            if st["hist"] is not None:
                st["hist"].extend(toks)
            emitted[i] = toks
        return emitted, nvalid

    def kv_state(self) -> Dict[str, Any]:
        out = super().kv_state()
        out["spec"] = {k: self.stats[k] for k in
                       ("spec_rounds", "spec_proposed", "spec_accepted",
                        "spec_fallbacks")}
        return out


class SpeculativeLLMDeployment(LLMDeployment):
    """:class:`~ray_tpu_torch.serve.llm.LLMDeployment` whose engine decodes
    speculatively. Extra arguments: ``spec_k``, ``drafter`` (``"ngram"`` |
    ``"model"``), ``draft_model`` / ``draft_params`` (the model drafter's
    config and optional weights), ``draft_seed``, ``spec_accept_floor``,
    ``ngram``."""

    def __init__(self, model="llama-debug", *, spec_k: Optional[int] = None,
                 drafter: str = "ngram", draft_model: Any = None,
                 draft_params: Any = None, draft_seed: int = 1,
                 spec_accept_floor: Optional[float] = None,
                 ngram: int = 3, **kw):
        self._spec_opts = dict(spec_k=spec_k, drafter=drafter,
                               draft_model=draft_model,
                               draft_params=draft_params,
                               draft_seed=draft_seed,
                               spec_accept_floor=spec_accept_floor,
                               ngram=ngram)
        super().__init__(model, **kw)

    def _engine_factory(self, *args, **kw) -> SpeculativeLLMEngine:
        return SpeculativeLLMEngine(*args, **kw, **self._spec_opts)


class MultiplexedLLMDeployment:
    """One replica serving MANY models: a per-model engine created on the
    model's first request, its weights paged through a shared
    :class:`ModelRegistry`.

    ``models_spec`` maps ``model_id`` to a preset name, a
    ``TransformerConfig``, or a dict ``{"config": ..., "params": ...,
    "base": ..., "delta": ..., "seed": ...}`` (base + delta registers a
    LoRA-style variant). Requests name their model with ``model_id=``
    (default: the first registered)::

        dep = MultiplexedLLMDeployment(
            {"m0": "llama-debug", "m1": "gpt2-debug"}, device="cpu")
        for tok in dep([1, 2, 3], 16, model_id="m1"):
            ...

    Each model gets its own :class:`~ray_tpu_torch.serve.llm.LLMDeployment`
    (loop thread, admission, streaming, paged KV and prefix trie) the first
    time a request lands on it. A request PINS its model for its stream's
    whole life, so eviction (LRU under ``budget_bytes``) only drops idle
    engines' params, and with them the params' captured graphs; the
    engine's ``params_provider`` takes them back on its next step with
    work. ``load_state`` sums the per-model engines and adds the
    resident-model digest and the merged prefix digest that
    ``serve/handle.py`` routes on. ``device`` and ``cuda_graphs`` go to the
    registry and the engines (the port's additions, as in
    ``LLMDeployment``).
    """

    def __init__(self, models_spec, *, default_model: Optional[str] = None,
                 budget_bytes: Optional[int] = None,
                 speculative: bool = False, spec_k: Optional[int] = None,
                 drafter: str = "ngram", draft_model: Any = None,
                 draft_params: Any = None,
                 spec_accept_floor: Optional[float] = None,
                 max_slots: int = 8, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True, slo: Optional[Any] = None,
                 stream_batch: int = 1, cuda_graphs: bool = True,
                 device: Optional[Device] = None):
        if isinstance(models_spec, (list, tuple)):
            models_spec = {mid: mid for mid in models_spec}
        if not models_spec:
            raise ValueError("models_spec is empty")
        self.registry = ModelRegistry(budget_bytes=budget_bytes,
                                      device=device)
        for mid, spec in models_spec.items():
            if isinstance(spec, dict):
                self.registry.register(
                    mid, spec.get("config"), params=spec.get("params"),
                    base=spec.get("base"), delta=spec.get("delta"),
                    seed=spec.get("seed", seed))
            else:
                self.registry.register(mid, spec, seed=seed)
        self._default = default_model or next(iter(models_spec))
        if self._default not in self.registry:
            raise ValueError(
                f"default_model {self._default!r} is not registered")
        self._dep_kw = dict(max_slots=max_slots, max_len=max_len,
                            temperature=temperature, seed=seed,
                            paged=True, block_size=block_size,
                            num_blocks=num_blocks,
                            prefill_chunk=prefill_chunk,
                            prefix_cache=prefix_cache, slo=slo,
                            stream_batch=stream_batch,
                            cuda_graphs=cuda_graphs,
                            device=self.registry.device)
        self._spec_kw = (dict(spec_k=spec_k, drafter=drafter,
                              draft_model=draft_model,
                              draft_params=draft_params,
                              spec_accept_floor=spec_accept_floor)
                         if speculative else None)
        self._deps: Dict[str, LLMDeployment] = {}
        self._dep_lock = threading.Lock()
        self._ident: Optional[Dict[str, Any]] = None

    # -- engine lifecycle --------------------------------------------------

    def _get_dep(self, model_id: str) -> LLMDeployment:
        with self._dep_lock:
            dep = self._deps.get(model_id)
            if dep is None:
                cfg = self.registry.config_of(model_id)
                params = self.registry.ensure_resident(model_id)
                if self._spec_kw is not None:
                    dep = SpeculativeLLMDeployment(cfg, params=params,
                                                   **self._spec_kw,
                                                   **self._dep_kw)
                else:
                    dep = LLMDeployment(cfg, params=params, **self._dep_kw)
                dep._model_id = model_id
                dep.engine.params_provider = (
                    lambda m=model_id: self.registry.ensure_resident(m))
                self.registry.bind(model_id, dep.engine.drop_params)
                self._deps[model_id] = dep
        return dep

    # -- request path ------------------------------------------------------

    def __call__(self, prompt_tokens, max_new_tokens: int = 16,
                 model_id: Optional[str] = None, eos: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        mid = model_id or self._default
        if mid not in self.registry:
            raise ValueError(
                f"unknown model_id {mid!r}; registered: "
                f"{sorted(self.registry.models())}")
        # pin FIRST: from the residency check to the stream's end this
        # model must not be evicted (the engine reads params only while it
        # has work, and work implies this pin)
        self.registry.pin(mid)
        try:
            self.registry.ensure_resident(mid)
            dep = self._get_dep(mid)
            inner = dep(prompt_tokens, max_new_tokens, eos=eos,
                        deadline_s=deadline_s)
        except BaseException:
            self.registry.unpin(mid)
            raise

        def stream():
            try:
                yield from inner
            finally:
                self.registry.unpin(mid)

        return stream()

    # -- replica surface (serve protocol) ----------------------------------

    def identity(self) -> Dict[str, Any]:
        """This replica's actor id and node id (cached once a request has
        the actor id: it is task-context-local)."""
        if self._ident is None or self._ident.get("actor") is None:
            try:
                from ray_tpu_torch.core.runtime_context import \
                    get_runtime_context

                ctx = get_runtime_context()
                self._ident = {"actor": ctx.get_actor_id(),
                               "node": ctx.get_node_id()}
            except Exception:
                # no runtime at all (an in-process harness)
                import os

                self._ident = {
                    "actor": None,
                    "node": os.environ.get("RTPU_NODE_ID",
                                           f"proc-{os.getpid()}")}
        return self._ident

    def stats(self) -> Dict[str, Any]:
        with self._dep_lock:
            deps = dict(self._deps)
        out: Dict[str, Any] = {"models": self.registry.snapshot()}
        for mid, dep in deps.items():
            out[mid] = dep.stats()
        return out

    def load_state(self) -> Dict[str, Any]:
        with self._dep_lock:
            deps = dict(self._deps)
        states = {mid: dep.load_state() for mid, dep in deps.items()}
        ident = self.identity()
        out: Dict[str, Any] = {
            "inflight": sum(s["inflight"] for s in states.values()),
            "kv_free": sum(s["kv_free"] for s in states.values()),
            "kv_total": sum(s["kv_total"] for s in states.values()),
            "role": "colocated",
            "node": ident["node"],
            "actor": ident["actor"],
            "queued": sum(s["queued"] for s in states.values()),
            "max_slots": (sum(s["max_slots"] for s in states.values())
                          or self._dep_kw["max_slots"]),
            "block_size": next((s["block_size"] for s in states.values()
                                if s.get("block_size")), 0),
        }
        snap = self.registry.snapshot()
        out["models"] = {
            mid: {"state": rec["state"],
                  "inflight": states.get(mid, {}).get("inflight", 0),
                  "swaps_in": rec["swaps_in"],
                  "swaps_out": rec["swaps_out"]}
            for mid, rec in snap.items()
        }
        agg: Dict[str, int] = {}
        for st in states.values():
            for key, w in st.get("prefix_digest", []):
                agg[key] = agg.get(key, 0) + int(w)
        top = int(_knobs.get("serve_prefix_digest_top"))
        out["prefix_digest"] = sorted(
            agg.items(), key=lambda kv: -kv[1])[:top]
        return out

    def check_health(self) -> None:
        with self._dep_lock:
            deps = list(self._deps.values())
        for dep in deps:
            dep.check_health()

    def close(self) -> None:
        """Stop every engine's loop, drop their params (and captured
        graphs), and free every weight object in the store."""
        with self._dep_lock:
            deps, self._deps = list(self._deps.values()), {}
        for dep in deps:
            dep.close()
            dep.engine.drop_params()
        self.registry.free()
