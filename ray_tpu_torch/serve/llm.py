"""Continuous-batching LLM serving engine over the paged KV cache (twin of
the colocated, paged half of ``ray_tpu/serve/llm.py``'s ``LLMEngine``).

- One step (:func:`models.decode_step_paged`) over a fixed slot grid
  [max_slots, prefill_chunk]: a decoding slot advances one token while a
  prefilling slot consumes up to ``prefill_chunk`` prompt tokens, so a long
  prompt never stalls the decodes sharing its batch.
- KV lives in a block-paged pool (``serve/kv_cache.py`` +
  ``models.init_cache_paged``): admission claims BLOCKS, not slots, and a
  hash-trie prefix cache maps shared system prompts to shared immutable
  blocks — a prefix hit skips that prefill compute (``pos`` starts past the
  reused tokens). Copy-on-write covers a capped match reusing a partial
  tail block.
- An :class:`AdmissionController` sheds requests whose projected TTFT or
  decode rate would breach the declared :class:`SLOConfig`; per-request
  ``deadline_s`` is enforced across admission queueing and streaming.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import config as _knobs
from ray_tpu_torch import models
from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.serve.admission import (AdmissionController,
                                           DeadlineExceededError, SLOConfig)
from ray_tpu_torch.serve.kv_cache import BlockPool, PrefixCache


@dataclass(eq=False)   # identity semantics: a generated __eq__ would
class _Request:        # elementwise-compare the prompt arrays and raise
    prompt: np.ndarray                 # [P] int32
    max_new_tokens: int
    # token sink: int token, None = done, Exception = engine failure
    emit: Callable[[Any], None]
    consumed: int = 0                  # prompt tokens fed so far
    generated: int = 0
    last_token: int = 0
    eos: Optional[int] = None
    cancelled: bool = False
    table: List[int] = field(default_factory=list)   # physical block ids
    pos: int = 0                       # KV tokens cached (incl. shared)
    submit_ts: float = 0.0             # monotonic
    deadline: Optional[float] = None   # monotonic absolute
    last_emit_ts: Optional[float] = None
    gen_tokens: List[int] = field(default_factory=list)  # every sampled token


class LLMEngine:
    """Slot-based continuous-batching decode engine over one model.

    ``submit`` is thread-safe; ``step`` must be called from ONE driver
    thread and returns whether any work remains. Greedy sampling by
    default; ``temperature`` > 0 samples.
    """

    def __init__(self, config, params=None, *, max_slots: int = 8,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 slo: Optional[SLOConfig] = None,
                 device: Optional[Device] = None):
        if isinstance(config, str):
            config = models.get_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = models.init_params(gen, config, device=self.device)
        self.params = params
        bs = int(block_size or _knobs.get("llm_block_size"))
        self._tbl_width = -(-max_len // bs)
        nb = int(num_blocks or max_slots * self._tbl_width)
        self.pool = BlockPool(nb, bs)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        self.prefill_chunk = max(
            1, int(prefill_chunk or _knobs.get("llm_prefill_chunk")))
        self._cache = models.init_cache_paged(config, nb, bs,
                                              device=self.device)
        self.admission = AdmissionController(slo)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._pending: List[_Request] = []
        self._slots: List[Optional[_Request]] = [None] * max_slots
        self.stats = {"steps": 0, "tokens_generated": 0,
                      "max_concurrent": 0, "requests": 0,
                      "prefix_hit_tokens": 0, "deadline_drops": 0}

    # -- thread-safe intake ------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               emit: Callable[[Any], None],
               eos: Optional[int] = None,
               deadline_s: Optional[float] = None) -> _Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_len "
                f"({self.max_len})")
        width = self.pool.blocks_for_tokens(len(prompt) + max_new_tokens)
        if width > self.pool.num_blocks:
            # bigger than the WHOLE pool: it could never be admitted, and
            # queueing it would pin the strict-FIFO head forever
            raise ValueError(
                f"request needs {width} KV blocks but the pool has only "
                f"{self.pool.num_blocks} total; raise num_blocks or lower "
                f"max_new_tokens")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        # SLO gate BEFORE the request joins the queue: a doomed request
        # gets a fast RequestShedError, not a slow timeout
        with self._lock:
            queued = len(self._pending)
            queued_tokens = sum(len(r.prompt) for r in self._pending)
            free_slots = sum(r is None for r in self._slots)
        self.admission.check_admit(
            len(prompt), queued, queued_tokens, self.prefill_chunk,
            free_slots, self.max_slots - free_slots, deadline_s=deadline_s)
        now = time.monotonic()
        req = _Request(prompt, max_new_tokens, emit, eos=eos, submit_ts=now,
                       deadline=(now + deadline_s
                                 if deadline_s is not None else None))
        with self._lock:
            self._pending.append(req)
            self.stats["requests"] += 1
        return req

    def cancel(self, req: _Request) -> None:
        """Abandon a request: pending entries are dropped immediately; an
        in-slot request frees its slot (and KV blocks) at the next step
        without emitting further tokens."""
        with self._lock:
            req.cancelled = True
            if req in self._pending:
                self._pending.remove(req)

    def abort_all(self, error: BaseException) -> None:
        """Fail every outstanding request (the decode loop died)."""
        with self._lock:
            victims = [r for r in self._slots if r is not None]
            victims += self._pending
            self._pending.clear()
            self._slots = [None] * self.max_slots
            for r in victims:
                self._release_blocks(r, insert=False)
        for r in victims:
            try:
                r.emit(error)
            except Exception:  # a broken sink must not stop the others
                pass

    # -- paged block accounting -------------------------------------------

    def _claim_blocks(self, req: _Request, pending_copies: list) -> bool:
        """Admission = claiming KV blocks. Prefix-match the prompt, then
        allocate the rest of the request's table (prompt + budgeted new
        tokens, all up front — an admitted request never runs the pool out
        mid-decode). Falls back to trie eviction; False = not enough blocks,
        the request stays queued. Host-side bookkeeping under the engine
        lock: a copy-on-write device copy is queued onto
        ``pending_copies`` for :meth:`_sweep_and_admit` to run after the
        lock drops."""
        pool, trie = self.pool, self.prefix
        width = pool.blocks_for_tokens(len(req.prompt) + req.max_new_tokens)
        lookup_stats = trie.stats() if trie is not None else None
        blocks, matched, cow = (trie.match(req.prompt.tolist())
                                if trie is not None else ([], 0, None))
        fresh_needed = width - len(blocks)
        fresh = pool.alloc(fresh_needed)
        if fresh is None and trie is not None:
            trie.evict(fresh_needed - pool.free_count)
            fresh = pool.alloc(fresh_needed)
        if fresh is None:
            pool.release_all(blocks)
            if cow is not None:
                pool.release(cow)
            # roll back the lookup accounting: this request re-runs the
            # match on every step while it waits at the queue head
            if lookup_stats is not None:
                trie.hits = lookup_stats["hits"]
                trie.misses = lookup_stats["misses"]
                trie.hit_tokens = lookup_stats["hit_tokens"]
            return False
        if cow is not None:
            # capped match reused part of a shared block: queue the device
            # copy into the request's first fresh block (the cow ref stays
            # held until the copy lands)
            pending_copies.append((req, cow, fresh[0]))
        req.table = blocks + fresh
        req.pos = req.consumed = matched
        self.stats["prefix_hit_tokens"] += matched
        return True

    def _release_blocks(self, req: _Request, *, insert: bool) -> None:
        """Return a request's KV blocks. ``insert``: first offer the
        fully-written full prompt blocks to the prefix trie, so the next
        request with this system prompt hits."""
        if not req.table:
            return
        if insert and self.prefix is not None:
            n_full = min(len(req.prompt), req.pos) // self.pool.block_size
            if n_full:
                self.prefix.insert(
                    req.prompt[:n_full * self.pool.block_size].tolist(),
                    req.table[:n_full])
        self.pool.release_all(req.table)
        req.table = []

    # -- driver-thread loop body ------------------------------------------

    def _sweep_and_admit(self) -> tuple:
        """Free finished/cancelled/expired slots, then admit pending
        requests while a slot AND their KV blocks are available (strict
        FIFO, so admission order is fair)."""
        now = time.monotonic()
        expired: List[_Request] = []
        pending_copies: List[tuple] = []
        with self._lock:
            for i in range(self.max_slots):
                r = self._slots[i]
                if r is None:
                    continue
                if r.cancelled or (r.deadline is not None
                                   and now > r.deadline):
                    self._release_blocks(r, insert=False)
                    self._slots[i] = None
                    if not r.cancelled:
                        expired.append(r)
            # deadline enforcement ACROSS admission queueing
            still = []
            for r in self._pending:
                (expired if r.deadline is not None and now > r.deadline
                 else still).append(r)
            self._pending[:] = still
            for i in range(self.max_slots):
                if self._slots[i] is None and self._pending:
                    cand = self._pending[0]
                    if not self._claim_blocks(cand, pending_copies):
                        break  # pool exhausted: stay queued
                    self._pending.pop(0)
                    self._slots[i] = cand
            active_now = sum(r is not None for r in self._slots)
            self.stats["max_concurrent"] = max(
                self.stats["max_concurrent"], active_now)
            have_pending = bool(self._pending)
        for r in expired:
            self.stats["deadline_drops"] += 1
            try:
                r.emit(DeadlineExceededError(
                    f"request deadline elapsed after "
                    f"{now - r.submit_ts:.3f}s (generated "
                    f"{r.generated}/{r.max_new_tokens})"))
            except Exception:  # a broken sink must not stop the loop
                pass
        # COW copies run AFTER the lock drops (submit()/kv_state() stay
        # responsive behind a slow device op) but BEFORE the step reads
        # the tables
        for req, src, dst in pending_copies:
            try:
                models.copy_kv_block(self._cache, src, dst)
            except BaseException as e:
                # device error: un-claim THIS request and fail it, then
                # let the caller's abort path handle the rest
                with self._lock:
                    self.pool.release(src)
                    self._release_blocks(req, insert=False)
                    self._slots = [None if r is req else r
                                   for r in self._slots]
                try:
                    req.emit(e)
                except Exception:  # a broken sink must not mask e
                    pass
                raise
            with self._lock:
                self.pool.release(src)
        return active_now, have_pending

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit pending requests, advance every active slot (one decode
        token, or up to ``prefill_chunk`` prompt tokens), route new tokens
        to their requests. Returns True if any slot is active or requests
        are waiting."""
        active_now, have_pending = self._sweep_and_admit()
        if active_now == 0:
            return have_pending
        t0 = time.perf_counter()
        logits_h, nvalid = self._advance_paged()
        step_dt = time.perf_counter() - t0
        if self.stats["steps"] > 0:
            # the first step carries one-time costs (kernel builds,
            # allocator warm-up); seeding the EWMA with it would shed the
            # first burst
            self.admission.observe_step(step_dt)

        now = time.monotonic()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if req.consumed < len(req.prompt):
                req.consumed += int(nvalid[i])
                if req.consumed < len(req.prompt):
                    continue  # still prefilling; logits not sampled yet
            tok = self._sample(logits_h[i])
            req.last_token = tok
            req.generated += 1
            req.gen_tokens.append(tok)
            self._observe_emit(req, now)
            req.emit(tok)
            self.stats["tokens_generated"] += 1
            if req.generated >= req.max_new_tokens or (
                    req.eos is not None and tok == req.eos):
                # lock: the trie insert mutates children dicts that a
                # concurrent kv_state() may be iterating
                with self._lock:
                    self._release_blocks(req, insert=True)
                req.emit(None)
                self._slots[i] = None
        self.stats["steps"] += 1
        return True

    def _advance_paged(self):
        """Decoding slots feed 1 token, prefilling slots up to
        ``prefill_chunk`` prompt tokens, all in one step."""
        C = self.prefill_chunk
        tokens = np.zeros((self.max_slots, C), np.int64)
        nvalid = np.zeros(self.max_slots, np.int64)
        active = np.zeros(self.max_slots, bool)
        pos = np.zeros(self.max_slots, np.int64)
        tables = np.zeros((self.max_slots, self._tbl_width), np.int64)
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            active[i] = True
            pos[i] = req.pos
            tables[i, :len(req.table)] = req.table
            if req.consumed < len(req.prompt):
                n = min(C, len(req.prompt) - req.consumed)
                tokens[i, :n] = req.prompt[req.consumed:req.consumed + n]
                nvalid[i] = n
            else:
                tokens[i, 0] = req.last_token
                nvalid[i] = 1
        dev = self.device
        logits, self._cache = models.decode_step_paged(
            self.params, self._cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(nvalid).to(dev), self.config,
            active=torch.from_numpy(active).to(dev))
        for i, req in enumerate(self._slots):
            if req is not None:
                req.pos += int(nvalid[i])
        # ONE host transfer of all slots' logits
        return logits.cpu().numpy(), nvalid

    def _observe_emit(self, req: _Request, now: float) -> None:
        if req.last_emit_ts is None:
            self.admission.observe_ttft(now - req.submit_ts)
        else:
            self.admission.observe_tpot(now - req.last_emit_ts)
        req.last_emit_ts = now

    def _sample(self, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits / self.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    # -- introspection -----------------------------------------------------

    def kv_state(self) -> Dict[str, Any]:
        """Leak-audit snapshot: block accounting + prefix-cache + admission
        state, all host-side (no device sync)."""
        with self._lock:
            out: Dict[str, Any] = {
                "inflight": sum(r is not None for r in self._slots),
                "queued": len(self._pending),
                "max_slots": self.max_slots,
                "kv_total": self.pool.num_blocks,
                "kv_free": self.pool.free_count,
                "kv_used": self.pool.used_count,
                "block_size": self.pool.block_size,
                "kv_claimable": self.pool.free_count,
            }
            if self.prefix is not None:
                out["prefix"] = self.prefix.stats()
                # claimable = free + evictable-from-trie: the capacity
                # signal (a warm engine's raw free count trends to ~0
                # because the trie retains every finished prompt)
                out["kv_claimable"] += self.prefix.evictable_count()
        out["admission"] = self.admission.snapshot()
        return out

