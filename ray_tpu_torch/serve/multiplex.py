"""Speculative decoding over the paged engine (twin of the engine half of
``ray_tpu/serve/multiplex.py``).

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

The model registry, the multiplexed and speculative deployments and the
LoRA-style deltas wait for the actor runtime and the object store.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ray_tpu_torch import config as _knobs
from ray_tpu_torch import models
from ray_tpu_torch.serve.llm import LLMEngine, _Request, _Staging


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
                self.stats["spec_rounds"] += 1
                self.stats["spec_proposed"] += len(d)
                self.stats["spec_accepted"] += accepted
                st["rounds"] += 1
                st["ewma"] = 0.5 * st["ewma"] + 0.5 * (accepted / len(d))
                if (st["rounds"] >= self.SPEC_WARMUP
                        and st["ewma"] < self.spec_accept_floor):
                    # acceptance collapsed: plain decoding from here on
                    # (k' = 0 rides the same verify program)
                    st["off"] = True
                    self.stats["spec_fallbacks"] += 1
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
