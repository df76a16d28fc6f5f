"""Continuous-batching LLM serving engine (twin of the colocated half of
``ray_tpu/serve/llm.py``'s ``LLMEngine``: the paged engine, and the dense
one with ``paged=False``).

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
- ``paged=False`` keeps the dense per-slot cache
  (``models.init_cache_multi`` + ``decode_step_multi``): every active slot
  advances one token a step, a prompt one token at a time, with no block
  pool and no prefix cache.
- An :class:`AdmissionController` sheds requests whose projected TTFT or
  decode rate would breach the declared :class:`SLOConfig`; per-request
  ``deadline_s`` is enforced across admission queueing and streaming.
- The device programs (the step, the copy-on-write block copy, the KV
  gather and scatter) are registered with the device plane under the
  reference's names and, on the card, captured once per signature as CUDA
  graphs and replayed (``util.device_plane.registered_graph``; the
  reference compiles them with ``jax.jit``, the cache donated). A step
  fills one pinned host buffer with the slots' tokens, tables, positions,
  counts and flags, sends it in one copy, replays, and waits once: for the
  logits' copy to the host.
- Disaggregated serving, the engine half: ``submit(prefill_only=True)``
  emits a :class:`KVExport` (the first token and the prompt's KV blocks)
  in place of the stream, and :meth:`LLMEngine.adopt` admits such a
  request on another engine.
"""

from __future__ import annotations

import math
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
from ray_tpu_torch.util import device_plane
from ray_tpu_torch.util.device_plane import registered_graph


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class _Staging:
    """A program's integer inputs: one int64 host buffer (pinned on the
    card) filled through numpy views, and its twin on the device, sent in
    one asynchronous copy. Refilling it is safe once the step that read it
    has been waited for (every step ends in a host copy that waits). On
    the CPU the two are the same buffer."""

    def __init__(self, shapes: Dict[str, tuple], device: torch.device):
        n = sum(math.prod(shape) for shape in shapes.values())
        on_card = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.int64, pin_memory=on_card)
        self.dev = (torch.zeros(n, dtype=torch.int64, device=device)
                    if on_card else self.host)
        self.np: Dict[str, np.ndarray] = {}
        self.views: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape in shapes.items():
            k = math.prod(shape)
            self.np[name] = self.host[off:off + k].numpy().reshape(shape)
            self.views[name] = self.dev[off:off + k].view(shape)
            off += k

    def clear(self) -> None:
        self.host.zero_()

    def send(self) -> None:
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)


class _HostOut:
    """Device results to the host: ONE copy into a reused pinned buffer,
    then one wait (the reference's ``device_get``). The array returned is
    valid until the next fetch of the same shape."""

    def __init__(self):
        self._bufs: Dict[tuple, torch.Tensor] = {}

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        if t.device.type != "cuda":
            return t.numpy()
        key = (tuple(t.shape), t.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return buf.numpy()


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
    # disaggregated prefill / decode: stop after the first token and emit a
    # KVExport instead of it; or the shipped prompt KV to scatter into the
    # claimed blocks
    prefill_only: bool = False
    adopt_kv: Optional[Dict[str, torch.Tensor]] = None
    gen_tokens: List[int] = field(default_factory=list)  # every sampled token


@dataclass(eq=False)
class KVExport:
    """What a prefill-only request emits instead of its first token: the
    sampled token plus the prompt's KV blocks gathered off the paged pool
    ([L, n_blocks, bs, kvh, hd] per tensor, host tensors: numpy has no
    bfloat16) — the payload :meth:`LLMEngine.adopt` consumes."""

    token: int
    prompt_len: int
    block_size: int
    kv: Dict[str, torch.Tensor]

    @property
    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size()) for t in self.kv.values())


class LLMEngine:
    """Slot-based continuous-batching decode engine over one model.

    ``submit`` is thread-safe; ``step`` must be called from ONE driver
    thread and returns whether any work remains. Greedy sampling by
    default; ``temperature`` > 0 samples. ``cuda_graphs=False`` runs the
    programs eagerly on the card (the A/B against the captured ones).
    """

    def __init__(self, config, params=None, *, max_slots: int = 8,
                 max_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, paged: bool = True,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 slo: Optional[SLOConfig] = None,
                 role: str = "colocated",
                 cuda_graphs: bool = True,
                 device: Optional[Device] = None):
        if isinstance(config, str):
            config = models.get_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        self.paged = bool(paged)
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        self.role = role
        self.cuda_graphs = bool(cuda_graphs)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = models.init_params(gen, config, device=self.device)
        self.params = params
        # weight paging (model multiplexing): called at the top of step()
        # when the params were dropped
        self.params_provider: Optional[Callable[[], Any]] = None
        self._out = _HostOut()
        S = max_slots
        if self.paged:
            bs = int(block_size or _knobs.get("llm_block_size"))
            self._tbl_width = -(-max_len // bs)
            nb = int(num_blocks or max_slots * self._tbl_width)
            self.pool = BlockPool(nb, bs)
            self.prefix = PrefixCache(self.pool) if prefix_cache else None
            self.prefill_chunk = max(
                1, int(prefill_chunk or _knobs.get("llm_prefill_chunk")))
            self._cache = models.init_cache_paged(config, nb, bs,
                                                  device=self.device)
            self._in = _Staging({"tokens": (S, self.prefill_chunk),
                                 "tables": (S, self._tbl_width),
                                 "pos": (S,), "nvalid": (S,),
                                 "active": (S,)}, self.device)
            # every argument of the step is held where it is (params,
            # cache, the staging views): a replay copies nothing in
            self._step_fn = self._program(self._raw_step_paged,
                                          "serve::decode_step_paged",
                                          fixed=range(7))
            self._copy_fn = self._program(self._raw_copy,
                                          "serve::copy_kv_block", fixed=(0,))
            # export / adoption: distinct block buckets are distinct
            # captures, the power-of-two buckets bound them
            self._gather_fn = self._program(self._raw_gather,
                                            "serve::gather_kv_blocks",
                                            fixed=(0,))
            self._scatter_fn = self._program(self._raw_scatter,
                                             "serve::scatter_kv_blocks",
                                             fixed=(0,))
            # capture the copy-on-write copy NOW, not in the middle of the
            # first prefix-sharing request's admission (block 0 onto
            # itself: a no-op; src/dst are tensors, so one capture serves
            # every pair)
            self._copy_fn(self._cache, self._block_pair(0, 0))
        else:
            self.pool = None
            self.prefix = None
            self.prefill_chunk = 1
            self._cache = models.init_cache_multi(config, max_slots, max_len,
                                                  device=self.device)
            self._in = _Staging({"tokens": (S, 1), "active": (S,)},
                                self.device)
            self._step_fn = self._program(self._raw_step,
                                          "serve::decode_step", fixed=range(4))
        # programs that hold the params' addresses: dropped with them
        self._param_programs = [self._step_fn]
        self.admission = AdmissionController(slo)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._pending: List[_Request] = []
        self._slots: List[Optional[_Request]] = [None] * max_slots
        # the reference's keys; "migrated_out" stays 0 until session
        # migration is ported
        self.stats = {"steps": 0, "tokens_generated": 0,
                      "max_concurrent": 0, "requests": 0,
                      "prefix_hit_tokens": 0, "deadline_drops": 0,
                      "exported": 0, "adopted": 0, "migrated_out": 0}

    def _program(self, fn, name: str, fixed=()):
        return registered_graph(fn, name=name, component="serve",
                                fixed_argnums=tuple(fixed),
                                capture=self.cuda_graphs)

    def _raw_step(self, params, cache, tokens, active):
        return models.decode_step_multi(params, cache, tokens, self.config,
                                        active=active)[0]

    def _raw_step_paged(self, params, cache, tokens, tables, pos, nvalid,
                        active):
        return models.decode_step_paged(params, cache, tokens, tables, pos,
                                        nvalid, self.config,
                                        active=active)[0]

    @staticmethod
    def _raw_copy(cache, pair):
        models.copy_kv_block(cache, pair[:1], pair[1:])

    @staticmethod
    def _raw_gather(cache, ids):
        return models.gather_kv_blocks(cache, ids)

    @staticmethod
    def _raw_scatter(cache, ids, kv):
        models.scatter_kv_blocks(cache, ids, kv)

    def _block_pair(self, src: int, dst: int) -> torch.Tensor:
        """(src, dst) as a device tensor, sent without waiting: the pinned
        copy is held by the host allocator until the transfer is done."""
        pair = torch.tensor([src, dst], dtype=torch.int64)
        if self.device.type == "cuda":
            pair = pair.pin_memory().to(self.device, non_blocking=True)
        return pair

    def _ids(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int64).to(self.device)

    # -- thread-safe intake ------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               emit: Callable[[Any], None],
               eos: Optional[int] = None,
               deadline_s: Optional[float] = None,
               prefill_only: bool = False) -> _Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prefill_only:
            if not self.paged:
                raise ValueError("prefill_only requires a paged engine "
                                 "(KV export is block-granular)")
            # the export happens at the FIRST sample: exactly one token is
            # produced here; the decode engine owns the rest
            max_new_tokens = 1
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_len "
                f"({self.max_len})")
        if self.paged:
            # a prefill-only request claims PROMPT blocks only: its sampled
            # token is never fed here
            width = self.pool.blocks_for_tokens(
                len(prompt) + (0 if prefill_only else max_new_tokens))
            if width > self.pool.num_blocks:
                # bigger than the WHOLE pool: it could never be admitted,
                # and queueing it would pin the strict-FIFO head forever
                raise ValueError(
                    f"request needs {width} KV blocks but the pool has only "
                    f"{self.pool.num_blocks} total; raise num_blocks or "
                    f"lower max_new_tokens")
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
                                 if deadline_s is not None else None),
                       prefill_only=prefill_only)
        with self._lock:
            self._pending.append(req)
            self.stats["requests"] += 1
        return req

    def adopt(self, prompt, kv: Dict[str, Any], first_token: int,
              max_new_tokens: int, emit: Callable[[Any], None],
              eos: Optional[int] = None,
              deadline_s: Optional[float] = None) -> _Request:
        """Admit a request whose prompt KV was prefilled on ANOTHER engine
        (the decode half of disaggregated serving): claim a full table,
        scatter the shipped blocks into it, and start decoding from
        ``first_token`` — no prompt token runs through this engine's
        model. ``kv`` is the :class:`KVExport` payload ([L, n_blocks, bs,
        kvh, hd] per tensor, torch or numpy); the first token is emitted
        again here so the caller sees one uninterrupted stream."""
        if not self.paged:
            raise ValueError("adopt requires a paged engine")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the engine's max_len "
                f"({self.max_len})")
        need = self.pool.blocks_for_tokens(len(prompt))
        got = int(kv["k"].shape[1])
        if got != need:
            raise ValueError(
                f"KV payload carries {got} blocks but the prompt needs "
                f"{need} (block_size {self.pool.block_size})")
        if int(kv["k"].shape[2]) != self.pool.block_size:
            raise ValueError(
                f"KV payload block_size {int(kv['k'].shape[2])} != this "
                f"engine's {self.pool.block_size}")
        # FULL geometry check, both tensors, against this engine's cache
        # ([L, n, bs, kvh, hd]): a bad payload must fail THIS request here,
        # not the scatter later on the engine loop, where abort_all would
        # fail every in-flight stream
        ck = self._cache["k"]
        want = (int(ck.shape[0]), got, int(ck.shape[2]), int(ck.shape[3]),
                int(ck.shape[4]))
        for name in ("k", "v"):
            if tuple(int(d) for d in kv[name].shape) != want:
                raise ValueError(
                    f"KV payload {name} shape {tuple(kv[name].shape)} does "
                    f"not match this engine's cache geometry {want} "
                    "(mismatched pool model configs?)")
        width = self.pool.blocks_for_tokens(len(prompt) + max_new_tokens)
        if width > self.pool.num_blocks:
            raise ValueError(
                f"request needs {width} KV blocks but the pool has only "
                f"{self.pool.num_blocks} total")
        # decode-side admission: no prefill cost (the blocks arrive
        # computed), so only the queue / TPOT gates carry signal
        with self._lock:
            queued = len(self._pending)
            queued_tokens = sum(len(r.prompt) for r in self._pending)
            free_slots = sum(r is None for r in self._slots)
        self.admission.check_admit(
            1, queued, queued_tokens, self.prefill_chunk, free_slots,
            self.max_slots - free_slots, deadline_s=deadline_s)
        now = time.monotonic()
        req = _Request(prompt, max_new_tokens, emit, eos=eos, submit_ts=now,
                       deadline=(now + deadline_s
                                 if deadline_s is not None else None))
        # an owned copy: the caller's payload may be a view it reuses, and
        # the scatter runs later on the engine loop
        req.adopt_kv = {name: torch.as_tensor(kv[name]).clone()
                        for name in ("k", "v")}
        req.last_token = int(first_token)
        req.gen_tokens.append(int(first_token))
        with self._lock:
            self._pending.append(req)
            self.stats["requests"] += 1
            self.stats["adopted"] += 1
        return req

    # -- weight paging (model multiplexing) --------------------------------

    def set_params(self, params) -> None:
        """Install (swap in) a params dict, between steps. A captured step
        holds the old params' addresses, so the step's graphs are dropped
        and captured again at the next step."""
        if params is not self.params:
            self.params = params
            self._drop_param_programs()

    def drop_params(self) -> None:
        """Page this engine's weights out (only while it has no in-flight
        work); the next step with work takes them from
        ``params_provider``. The step's graphs go with them."""
        self.params = None
        self._drop_param_programs()

    def _drop_param_programs(self) -> None:
        for fn in self._param_programs:
            fn.reset()

    def _ensure_params(self) -> None:
        if self.params is None:
            if self.params_provider is None:
                raise RuntimeError(
                    "engine params paged out and no params_provider set")
            self.params = self.params_provider()

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
        total = len(req.prompt) + (0 if req.prefill_only
                                   else req.max_new_tokens)
        width = pool.blocks_for_tokens(total)
        if req.adopt_kv is not None:
            # adoption: the payload IS the prompt KV — a trie match would
            # alias blocks the scatter must not overwrite, so claim all
            # fresh (the finished request still seeds the trie on release)
            fresh = pool.alloc(width)
            if fresh is None and trie is not None:
                trie.evict(width - pool.free_count)
                fresh = pool.alloc(width)
            if fresh is None:
                return False
            req.table = fresh
            req.pos = req.consumed = len(req.prompt)
            n_kv = int(req.adopt_kv["k"].shape[1])
            pending_copies.append(("adopt", req, fresh[:n_kv], req.adopt_kv))
            req.adopt_kv = None
            return True
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
            pending_copies.append(("cow", req, cow, fresh[0]))
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
                    if self.paged and not self._claim_blocks(
                            cand, pending_copies):
                        break  # pool exhausted: stay queued
                    self._pending.pop(0)
                    self._slots[i] = cand
                    if not self.paged:  # a dense slot restarts at 0
                        self._cache["pos"][i] = 0
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
        # COW copies and adoption scatters run AFTER the lock drops
        # (submit()/kv_state() stay responsive behind a slow device op) but
        # BEFORE the step reads the tables
        adopts = []
        for kind, req, *rest in pending_copies:
            if kind == "adopt":
                adopts.append((req, rest[0], rest[1]))
                continue
            src, dst = rest
            try:
                self._copy_fn(self._cache, self._block_pair(src, dst))
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
        if adopts:
            self._apply_adoptions(adopts)
        return active_now, have_pending

    def _apply_adoptions(self, adopts: List[tuple]) -> None:
        """Scatter every pending adoption's shipped blocks in ONE device
        program (a burst of arrivals costs the in-flight decodes one
        replay, not K), then emit each request's prefill-side first token.
        Ids and payload pad to a power-of-two bucket (pad ids are out of
        range, so the scatter writes nothing for them): one capture a
        bucket, not one a batch geometry."""
        ids: List[int] = []
        for _req, table_prefix, _kv in adopts:
            ids.extend(table_prefix)
        k = torch.cat([kv["k"] for _r, _t, kv in adopts], dim=1)
        v = torch.cat([kv["v"] for _r, _t, kv in adopts], dim=1)
        pad = _next_pow2(len(ids)) - len(ids)
        if pad:
            ids = ids + [self.pool.num_blocks] * pad
            k = torch.cat([k, k.new_zeros(k.shape[:1] + (pad,) + k.shape[2:])],
                          dim=1)
            v = torch.cat([v, v.new_zeros(v.shape[:1] + (pad,) + v.shape[2:])],
                          dim=1)
        dt = self._cache["k"].dtype
        try:
            self._scatter_fn(self._cache, self._ids(ids),
                             {"k": k.to(self.device, dt),
                              "v": v.to(self.device, dt)})
        except BaseException as e:
            with self._lock:
                for req, _tp, _kv in adopts:
                    self._release_blocks(req, insert=False)
                    self._slots = [None if r is req else r
                                   for r in self._slots]
            for req, _tp, _kv in adopts:
                try:
                    req.emit(e)
                except Exception:  # a broken sink must not mask e
                    pass
            raise
        now = time.monotonic()
        for req, _tp, _kv in adopts:
            req.generated = 1
            self._observe_emit(req, now)
            req.emit(req.last_token)
            self.stats["tokens_generated"] += 1
            if req.generated >= req.max_new_tokens or (
                    req.eos is not None and req.last_token == req.eos):
                # a single-token request: done at adoption
                with self._lock:
                    self._release_blocks(req, insert=True)
                    self._slots = [None if r is req else r
                                   for r in self._slots]
                req.emit(None)

    @torch.inference_mode()
    def step(self) -> bool:
        """Admit pending requests, advance every active slot (one decode
        token, or up to ``prefill_chunk`` prompt tokens), route new tokens
        to their requests. Returns True if any slot is active or requests
        are waiting."""
        active_now, have_pending = self._sweep_and_admit()
        if active_now == 0:
            return have_pending
        self._ensure_params()
        t0 = time.perf_counter()
        logits_h, nvalid = (self._advance_paged() if self.paged
                            else self._advance_dense())
        step_dt = time.perf_counter() - t0
        if self.stats["steps"] > 0:
            # the first step carries one-time costs (the capture, allocator
            # warm-up); seeding the EWMA with it would shed the first burst
            self.admission.observe_step(step_dt)
            self._note_device_step(step_dt)

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
            if req.prefill_only:
                self._emit_prefill_export(i, req, tok)
                continue
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

    def _note_device_step(self, dt: float) -> None:
        """Achieved FLOP/s of this engine's step program: its FLOPs a call
        (device plane) over the step's wall time, which the logits' copy
        to the host bounds."""
        program = ("serve::decode_step_paged" if self.paged
                   else "serve::decode_step")
        flops = device_plane.program_flops_per_step(program)
        if flops and dt > 0:
            self.stats["flops_per_s"] = round(flops / dt, 1)

    def _emit_prefill_export(self, i: int, req: _Request, tok: int) -> None:
        """Export INSTEAD of streaming: gather the prompt's blocks off the
        pool (one program, one host copy) and hand them to the sink with
        the sampled token; the blocks then release normally (full prompt
        blocks into the trie). The id list pads to a power-of-two bucket,
        repeating the last id (reads are harmless), so the gather captures
        once a bucket, not once a block count."""
        nb = self.pool.blocks_for_tokens(len(req.prompt))
        bucket = min(_next_pow2(nb), self._tbl_width)
        ids = req.table[:nb] + [req.table[nb - 1]] * (bucket - nb)
        kv_dev = self._gather_fn(self._cache, self._ids(ids))
        self.stats["exported"] += 1
        req.emit(KVExport(
            token=tok, prompt_len=len(req.prompt),
            block_size=self.pool.block_size,
            kv={name: kv_dev[name][:, :nb].cpu() for name in ("k", "v")}))
        with self._lock:
            self._release_blocks(req, insert=True)
        req.emit(None)
        self._slots[i] = None

    def _fill_paged(self) -> Dict[str, np.ndarray]:
        """The step's inputs on the host: decoding slots feed 1 token,
        prefilling slots up to ``prefill_chunk`` prompt tokens."""
        C = self.prefill_chunk
        self._in.clear()
        a = self._in.np
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            a["active"][i] = 1
            a["pos"][i] = req.pos
            a["tables"][i, :len(req.table)] = req.table
            if req.consumed < len(req.prompt):
                n = min(C, len(req.prompt) - req.consumed)
                a["tokens"][i, :n] = req.prompt[req.consumed:req.consumed + n]
                a["nvalid"][i] = n
            else:
                a["tokens"][i, 0] = req.last_token
                a["nvalid"][i] = 1
        return a

    def _paged_args(self) -> tuple:
        v = self._in.views
        return (self.params, self._cache, v["tokens"], v["tables"], v["pos"],
                v["nvalid"], v["active"])

    def _advance_paged(self):
        nvalid = self._fill_paged()["nvalid"].copy()
        self._in.send()
        logits = self._step_fn(*self._paged_args())
        for i, req in enumerate(self._slots):
            if req is not None:
                req.pos += int(nvalid[i])
        return self._out.fetch(logits), nvalid

    def _advance_dense(self):
        """Dense per-slot cache: every active slot advances exactly one
        token, a prompt token while it prefills."""
        self._in.clear()
        a = self._in.np
        nvalid = np.zeros(self.max_slots, np.int64)
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            a["active"][i] = 1
            nvalid[i] = 1
            a["tokens"][i, 0] = (req.prompt[req.consumed]
                                 if req.consumed < len(req.prompt)
                                 else req.last_token)
        self._in.send()
        v = self._in.views
        logits = self._step_fn(self.params, self._cache, v["tokens"],
                               v["active"])
        return self._out.fetch(logits), nvalid

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
                "paged": self.paged,
                "role": self.role,
                "inflight": sum(r is not None for r in self._slots),
                "queued": len(self._pending),
                "max_slots": self.max_slots,
            }
            if self.pool is not None:
                out.update(kv_total=self.pool.num_blocks,
                           kv_free=self.pool.free_count,
                           kv_used=self.pool.used_count,
                           block_size=self.pool.block_size,
                           kv_claimable=self.pool.free_count)
            if self.prefix is not None:
                out["prefix"] = self.prefix.stats()
                # claimable = free + evictable-from-trie: the capacity
                # signal (a warm engine's raw free count trends to ~0
                # because the trie retains every finished prompt)
                out["kv_claimable"] += self.prefix.evictable_count()
        out["admission"] = self.admission.snapshot()
        return out

