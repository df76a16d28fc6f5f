"""Continuous-batching LLM serving (twin of ``ray_tpu/serve/llm.py``): the
``LLMEngine`` (the paged engine, and the dense one with ``paged=False``) and
``LLMDeployment``, the Serve deployment that runs one engine on a replica
and streams its tokens (the colocated role).

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
  request on another engine. Live-session migration:
  :meth:`LLMEngine.begin_migration` marks every decoding session, and the
  loop thread exports each one (its cached KV gathered through the same
  captured ``serve::gather_kv_blocks`` program) at the top of its next
  step. ``LLMDeployment.prefill_export`` / ``adopt_stream`` /
  ``drain_sessions`` ship those payloads over ``serve/kv_transfer.py``.
- Telemetry, the reference's names: TTFT and TPOT histograms observed at
  each emit; KV blocks free and used, the pool's in-flight, queued and
  used fraction sampled after each step; the prefix cache's hit, miss and
  hit-token counters mirrored from the trie by deltas; admission sheds by
  reason; the step program's achieved FLOP/s (its FLOPs over the step's
  wall time, which the logits' copy to the host bounds: nothing syncs to
  measure it), and a ``serve::step`` span when tracing is on.
"""

from __future__ import annotations

import math
import os
import queue
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
                                           DeadlineExceededError,
                                           RequestShedError, SLOConfig)
from ray_tpu_torch.serve.kv_cache import BlockPool, PrefixCache
from ray_tpu_torch.util import device_plane
from ray_tpu_torch.util.device_plane import registered_graph


#: a token-stream sweep that met no terminal item
_NO_ITEM = object()


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
        # live sessions marked for export (begin_migration), with the
        # queue each one's payload goes to; the loop thread services them
        self._migrations: List[tuple] = []
        self.stats = {"steps": 0, "tokens_generated": 0,
                      "max_concurrent": 0, "requests": 0,
                      "prefix_hit_tokens": 0, "deadline_drops": 0,
                      "exported": 0, "adopted": 0, "migrated_out": 0}
        self._metrics = self._init_metrics()
        self._mirror_prev: Dict[str, int] = {}

    @staticmethod
    def _init_metrics() -> Dict[str, Any]:
        """The serving tier's built-in metrics, resolved once here so the
        step loop never looks the registry up."""
        from ray_tpu_torch.util import metric_defs as md

        return {
            "kv_free": md.get("rtpu_serve_kv_blocks_free"),
            "kv_used": md.get("rtpu_serve_kv_blocks_used"),
            "hits": md.get("rtpu_serve_prefix_cache_hits_total"),
            "misses": md.get("rtpu_serve_prefix_cache_misses_total"),
            "hit_tokens": md.get("rtpu_serve_prefix_hit_tokens_total"),
            "sheds": md.get("rtpu_serve_admission_sheds_total"),
            "ttft": md.get("rtpu_serve_ttft_seconds"),
            "tpot": md.get("rtpu_serve_tpot_seconds"),
            "pool_inflight": md.get("rtpu_serve_pool_inflight"),
            "pool_queued": md.get("rtpu_serve_pool_queued"),
            "pool_kv_used_frac": md.get("rtpu_serve_pool_kv_used_fraction"),
            "achieved_flops": md.get("rtpu_device_achieved_flops_per_s"),
        }

    def _admit_or_shed(self, n_prompt: int,
                       deadline_s: Optional[float]) -> None:
        """The SLO gate, before a request joins the queue: a doomed request
        gets a fast ``RequestShedError`` (counted by reason), not a slow
        timeout."""
        with self._lock:
            queued = len(self._pending)
            queued_tokens = sum(len(r.prompt) for r in self._pending)
            free_slots = sum(r is None for r in self._slots)
        try:
            self.admission.check_admit(
                n_prompt, queued, queued_tokens, self.prefill_chunk,
                free_slots, self.max_slots - free_slots,
                deadline_s=deadline_s)
        except RequestShedError as e:
            self._metrics["sheds"].inc(tags={"reason": e.reason})
            raise

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
        self._admit_or_shed(len(prompt), deadline_s)
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
        self._admit_or_shed(1, deadline_s)
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
        self._process_migrations()
        active_now, have_pending = self._sweep_and_admit()
        if active_now == 0:
            self._sample_gauges()
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
        self._sample_gauges()
        return True

    def _note_device_step(self, dt: float) -> None:
        """Achieved FLOP/s of this engine's step program: its FLOPs a call
        (device plane) over the step's wall time, which the logits' copy
        to the host bounds. The step is also a ``serve::step`` span when
        tracing is on."""
        from ray_tpu_torch.util import tracing

        program = ("serve::decode_step_paged" if self.paged
                   else "serve::decode_step")
        flops = device_plane.program_flops_per_step(program)
        if flops and dt > 0:
            fps = flops / dt
            self.stats["flops_per_s"] = round(fps, 1)
            self._metrics["achieved_flops"].set(fps,
                                                tags={"program": program})
        if tracing.tracing_enabled():
            end = time.time_ns()
            tracing.record_span(
                "serve::step", end - int(dt * 1e9), end,
                {"program": program, **({"flops": flops} if flops else {})})

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

    # -- live-session migration --------------------------------------------

    def begin_migration(self) -> List[tuple]:
        """Mark every live DECODING session for export off this engine.
        Returns ``[(request, reply_queue)]``; the loop thread services each
        entry at the top of its next step, putting the export payload dict,
        ``None`` (the session finished on its own before the export ran),
        or the exception that killed the export. Thread-safe; called by the
        deployment's drain path, not the loop thread.

        Only sessions past prefill with at least one sampled token qualify:
        a still-prefilling request is re-prefilled elsewhere by the
        ordinary retry path at the same cost."""
        if not self.paged:
            raise ValueError("session migration requires a paged engine "
                             "(KV export is block-granular)")
        out: List[tuple] = []
        with self._lock:
            for r in self._slots:
                if (r is None or r.cancelled or r.prefill_only
                        or r.consumed < len(r.prompt) or not r.gen_tokens):
                    continue
                reply: "queue.Queue[Any]" = queue.Queue()
                self._migrations.append((r, reply))
                out.append((r, reply))
        return out

    def _process_migrations(self) -> None:
        """Service pending session exports on the loop thread (top of step,
        BEFORE the advance: the migrating slot must not decode a token its
        export would then miss)."""
        with self._lock:
            if not self._migrations:
                return
            batch, self._migrations = self._migrations, []
        for req, reply in batch:
            # finished / cancelled between the mark and this step: its
            # blocks are released and its consumer has the whole stream
            with self._lock:
                gone = req.cancelled or req not in self._slots
            if gone:
                reply.put(None)
                continue
            try:
                reply.put(self._export_session(req))
            except BaseException as e:  # noqa: BLE001 - ships to the drain
                reply.put(e)

    def _export_session(self, req: _Request) -> Dict[str, Any]:
        """Gather a live decoding session's cached KV ([L, nb, bs, kvh, hd]
        per tensor, positions 0..pos-1, to the host) and retire its slot.
        The cache covers exactly the FED tokens — the prompt and every
        sampled token but the newest (``last_token`` is sampled, not yet
        fed) — so the destination adopts with prompt = the fed transcript
        and first_token = last_token, and decoding continues token-exact.
        The ids pad to a power-of-two bucket as in
        :meth:`_emit_prefill_export` (one capture a bucket)."""
        nb = self.pool.blocks_for_tokens(req.pos)
        bucket = min(_next_pow2(nb), self._tbl_width)
        ids = req.table[:nb] + [req.table[nb - 1]] * (bucket - nb)
        kv_dev = self._gather_fn(self._cache, self._ids(ids))
        kv = {name: kv_dev[name][:, :nb].cpu() for name in ("k", "v")}
        fed = list(map(int, req.prompt)) + req.gen_tokens[:-1]
        with self._lock:
            self._release_blocks(req, insert=True)
            self._slots = [None if r is req else r for r in self._slots]
        self.stats["migrated_out"] += 1
        return {
            "kv": kv,
            "fed_tokens": fed,
            "last_token": int(req.last_token),
            "pos": int(req.pos),
            "generated": int(req.generated),
            "max_new_tokens": int(req.max_new_tokens),
            "eos": req.eos,
            "block_size": self.pool.block_size,
        }

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
        m = self._metrics
        if req.last_emit_ts is None:
            ttft = now - req.submit_ts
            self.admission.observe_ttft(ttft)
            m["ttft"].observe(ttft)
        else:
            tpot = now - req.last_emit_ts
            self.admission.observe_tpot(tpot)
            m["tpot"].observe(tpot)
        req.last_emit_ts = now

    _mirrored = ("hits", "misses", "hit_tokens")

    def _sample_gauges(self) -> None:
        """The pool's gauges, and the prefix counters moved by what the
        trie counted since the last sample."""
        m = self._metrics
        role = {"role": self.role}
        with self._lock:
            m["pool_inflight"].set(sum(r is not None for r in self._slots),
                                   tags=role)
            m["pool_queued"].set(len(self._pending), tags=role)
        if self.pool is not None:
            m["kv_free"].set(self.pool.free_count)
            m["kv_used"].set(self.pool.used_count)
            m["pool_kv_used_frac"].set(
                self.pool.used_count / max(self.pool.num_blocks, 1),
                tags=role)
        if self.prefix is not None:
            cur = self.prefix.stats()
            prev = self._mirror_prev
            for k in self._mirrored:
                d = cur[k] - prev.get(k, 0)
                if d > 0:
                    m[k].inc(d)
            self._mirror_prev = {k: cur[k] for k in self._mirrored}

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
                # prefix affinity: the hottest trie roots by reuse, which
                # a load report publishes for the handle's routing
                out["prefix_digest"] = self.prefix.digest(
                    int(_knobs.get("serve_prefix_digest_top")))
                # claimable = free + evictable-from-trie: the capacity
                # signal (a warm engine's raw free count trends to ~0
                # because the trie retains every finished prompt)
                out["kv_claimable"] += self.prefix.evictable_count()
        out["admission"] = self.admission.snapshot()
        return out


class LLMDeployment:
    """Serve deployment: continuous-batching token streaming (twin of the
    colocated role of ``ray_tpu/serve/llm.py``'s ``LLMDeployment``).

    Deploy with a concurrent replica so requests interleave; on the card the
    replica asks for a GPU and opts in to seeing it::

        app = serve.deployment(
            LLMDeployment,
            ray_actor_options={"num_gpus": 1, "max_concurrency": 16,
                               "runtime_env": {"env_vars": {
                                   "CUDA_VISIBLE_DEVICES": "0"}}},
        ).bind("llama3-8b", max_slots=8, max_len=512)
        handle = serve.run(app, name="llm")
        for tok in handle.options(stream=True).remote([1, 2, 3], 16):
            ...

    ``device`` (default ``cuda``; ``"cpu"`` runs on the CPU) and
    ``cuda_graphs`` go to the :class:`LLMEngine`; the other arguments are
    the reference's. ``params`` may be a dict of tensors bound through the
    object store (they arrive as CPU tensors and the engine's ``device``
    decides where they run). ``__call__`` also takes one dict,
    ``{"prompt_tokens": [...], "max_new_tokens": n}``: the body an HTTP
    client posts to the proxy's ``?stream=1``. Each ``__call__`` is a SYNC
    generator; the
    engine advances on a dedicated background thread
    (``llm-decode-loop``), so all concurrent callers share one captured
    decode program and one paged KV pool. ``slo`` (dict or
    :class:`SLOConfig`) arms admission shedding; per-request ``deadline_s``
    bounds queueing AND streaming.

    ``role="prefill"`` / ``"decode"`` make the replica one pool of a
    disaggregated deployment (``serve/disagg.py``): ``prefill_export``
    prefills a prompt and ships its KV blocks to a decode replica,
    ``adopt_stream`` adopts them and streams, and ``drain_sessions``
    migrates every live decode session to a peer, all over
    ``serve/kv_transfer.py``.
    """

    def __init__(self, model="llama-debug", *, max_slots: int = 8,
                 max_len: int = 256, temperature: float = 0.0,
                 params=None, seed: int = 0, paged: bool = True,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 slo: Optional[Any] = None,
                 role: str = "colocated",
                 stream_batch: int = 1,
                 cuda_graphs: bool = True,
                 device: Optional[Device] = None):
        if isinstance(slo, dict):
            slo = SLOConfig(**slo)
        # stream_batch > 1: each streamed message carries a LIST of up to
        # stream_batch tokens, whatever the engine produced since the
        # consumer last kept up (the first token still ships alone)
        self._stream_batch = max(1, int(stream_batch))
        self._model_id = model if isinstance(model, str) else "custom"
        self.engine = self._engine_factory(
            model, params, max_slots=max_slots, max_len=max_len,
            temperature=temperature, seed=seed, paged=paged,
            block_size=block_size, num_blocks=num_blocks,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            slo=slo, role=role, cuda_graphs=cuda_graphs, device=device)
        self._error: Optional[BaseException] = None
        self._wake = threading.Event()
        self._stop = False
        # the KV-transfer planes exist only on replicas that ship or adopt
        self._kv_sender = None
        self._kv_receiver = None
        self._xfer_lock = threading.Lock()
        self._ident: Optional[Dict[str, str]] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-decode-loop")
        self._thread.start()

    def _engine_factory(self, *args, **kw) -> LLMEngine:
        """Engine construction seam: subclasses swap the engine class."""
        return LLMEngine(*args, **kw)

    def _loop(self) -> None:
        while not self._stop:
            try:
                busy = self.engine.step()
            except BaseException as e:  # noqa: BLE001 - must not die silent
                # fail every outstanding request and surface via
                # check_health; the thread keeps running so a transient
                # error doesn't permanently kill the replica
                self._error = e
                self.engine.abort_all(e)
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            if not busy:
                # idle: park until the next submit
                self._wake.wait(timeout=0.2)
                self._wake.clear()

    def __call__(self, prompt_tokens, max_new_tokens: int = 16,
                 eos: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        if isinstance(prompt_tokens, dict):
            # one JSON body, as the HTTP proxy passes it:
            # {"prompt_tokens": [...], "max_new_tokens": n, ...}
            req = dict(prompt_tokens)
            prompt_tokens = req.pop("prompt_tokens")
            max_new_tokens = int(req.pop("max_new_tokens", max_new_tokens))
            eos = req.pop("eos", eos)
            deadline_s = req.pop("deadline_s", deadline_s)
            if req:
                raise TypeError(f"unknown request keys {sorted(req)}")
        q: "queue.Queue[Any]" = queue.Queue()

        def submit():
            return self.engine.submit(prompt_tokens, max_new_tokens,
                                      q.put_nowait, eos=eos,
                                      deadline_s=deadline_s)

        return self._token_stream(q, submit, len(prompt_tokens),
                                  max_new_tokens, deadline_s)

    def _token_stream(self, q: "queue.Queue[Any]", submit,
                      n_prompt: int, max_new_tokens: int,
                      deadline_s: Optional[float]):
        """Run ``submit`` (engine intake), then drain the request's token
        queue to the caller."""
        from ray_tpu_torch.util import tracing

        stall_timeout = float(_knobs.get("llm_stall_timeout_s"))
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        # manual spans (not span()): this is a generator — a thread-local
        # span context held across a yield would leak onto whatever the
        # worker thread runs next. queue = admission wait to the FIRST
        # token; stream = the whole token stream.
        stream_span = tracing.manual_span(
            "serve.llm::stream", {"prompt_tokens": n_prompt,
                                  "max_new_tokens": max_new_tokens,
                                  "role": self.engine.role})
        queue_span = tracing.manual_span(
            "serve.llm::queue", {},
            parent=stream_span.traceparent if stream_span else None)
        req = None
        produced = 0
        try:
            # submit INSIDE the try: a dead engine must still finish the
            # admission span
            req = submit()
            self._wake.set()
            while True:
                wait = stall_timeout
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise DeadlineExceededError(
                            f"request deadline ({deadline_s}s) elapsed "
                            f"after {produced} tokens")
                    wait = min(wait, remaining)
                try:
                    tok = q.get(timeout=wait)
                except queue.Empty:
                    if (deadline is not None
                            and time.monotonic() >= deadline):
                        raise DeadlineExceededError(
                            f"request deadline ({deadline_s}s) elapsed "
                            f"after {produced} tokens")
                    raise TimeoutError(
                        f"llm decode loop produced no token for "
                        f"{stall_timeout:.0f}s"
                        + (f" (loop error: {self._error!r})"
                           if self._error else ""))
                if queue_span is not None:
                    queue_span.finish()
                    queue_span = None
                if tok is None:
                    return
                if isinstance(tok, (DeadlineExceededError,
                                    RequestShedError)):
                    raise tok  # admission/deadline verdicts pass through
                if isinstance(tok, BaseException):
                    raise RuntimeError(f"llm decode loop failed: {tok!r}")
                if self._stream_batch == 1:
                    produced += 1
                    yield tok
                    continue
                # micro-batched delivery: sweep whatever else the engine
                # already produced (bounded by stream_batch); a terminal
                # item found mid-sweep is handled AFTER the tokens before it
                chunk = [tok]
                terminal = _NO_ITEM
                while len(chunk) < self._stream_batch:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None or isinstance(nxt, BaseException):
                        terminal = nxt
                        break
                    chunk.append(nxt)
                produced += len(chunk)
                yield chunk
                if terminal is _NO_ITEM:
                    continue
                if terminal is None:
                    return
                if isinstance(terminal, (DeadlineExceededError,
                                         RequestShedError)):
                    raise terminal
                raise RuntimeError(
                    f"llm decode loop failed: {terminal!r}")
        finally:
            # client stopped consuming (disconnect / GC'd generator):
            # free the slot instead of generating into an orphan queue
            if req is not None:
                self.engine.cancel(req)
            if queue_span is not None:
                queue_span.finish(error="no token produced")
            if stream_span is not None:
                stream_span.finish({"tokens": produced})

    # -- disaggregated prefill/decode ------------------------------------

    def identity(self) -> Dict[str, str]:
        """This replica's identity: actor id + node id. Cached once a
        request has captured the actor id (it is task-context-local)."""
        if self._ident is None or self._ident["actor"] is None:
            try:
                from ray_tpu_torch.core.runtime_context import \
                    get_runtime_context

                ctx = get_runtime_context()
                self._ident = {"actor": ctx.get_actor_id(),
                               "node": ctx.get_node_id(),
                               "role": self.engine.role}
            except Exception:
                # no runtime at all (an in-process harness)
                self._ident = {"actor": None,
                               "node": os.environ.get("RTPU_NODE_ID",
                                                      "local"),
                               "role": self.engine.role}
        return self._ident

    def _max_payload_bytes(self) -> int:
        c = self.engine._cache["k"]
        per_block = (c.element_size() * math.prod(c.shape[2:])
                     * int(c.shape[0]) * 2)
        return per_block * self.engine._tbl_width

    def _sender(self):
        from ray_tpu_torch.serve.kv_transfer import KVSender

        with self._xfer_lock:
            if self._kv_sender is None:
                import uuid

                # the actor id when deployed; a process-unique fallback in
                # an in-process harness — ring names must never collide
                # across senders on one node
                src = self.identity()["actor"] or uuid.uuid4().hex[:12]
                self._kv_sender = KVSender(
                    src, max_payload_bytes=self._max_payload_bytes())
            return self._kv_sender

    def _same_host(self, dst: Dict[str, Any]) -> bool:
        return bool(dst.get("dst_node")) and \
            dst["dst_node"] == self.identity()["node"]

    def prefill_export(self, prompt_tokens, transfer: Dict[str, Any],
                       deadline_s: Optional[float] = None) -> Dict[str, Any]:
        """Prefill-pool entry point: run chunked prefill, then ship the
        prompt's KV blocks toward the decode replica named by ``transfer``
        ({req, dst, dst_node}) and return the transfer descriptor (the
        first token in its meta). The payload moves over a DeviceChannel
        ring when both replicas share ``dst_node``, else through the
        object store."""
        stall_timeout = float(_knobs.get("llm_stall_timeout_s"))
        q: "queue.Queue[Any]" = queue.Queue()
        req = self.engine.submit(prompt_tokens, 1, q.put_nowait,
                                 deadline_s=deadline_s, prefill_only=True)
        self._wake.set()
        export = None
        wait = (stall_timeout if deadline_s is None
                else min(stall_timeout, deadline_s))
        try:
            while True:
                tok = q.get(timeout=wait)
                if isinstance(tok, KVExport):
                    export = tok
                    continue
                if tok is None:
                    break
                if isinstance(tok, BaseException):
                    raise tok
        except queue.Empty:
            raise TimeoutError(
                f"prefill produced no export for {wait:.0f}s"
                + (f" (loop error: {self._error!r})" if self._error else ""))
        finally:
            self.engine.cancel(req)
        if export is None:
            raise RuntimeError("prefill finished without a KV export")
        return self._sender().ship(export, req_id=transfer["req"],
                                   dst_id=transfer["dst"],
                                   same_host=self._same_host(transfer))

    def adopt_stream(self, prompt_tokens, desc: Dict[str, Any],
                     max_new_tokens: int = 16, eos: Optional[int] = None,
                     deadline_s: Optional[float] = None):
        """Decode-pool entry point: fetch the shipped KV-block batch named
        by ``desc``, adopt it into this engine's pool (the loop thread
        scatters it onto the device with one host-to-device copy), and
        stream the tokens, the first one (sampled by prefill) included."""
        from ray_tpu_torch.serve.kv_transfer import KVReceiver

        with self._xfer_lock:
            if self._kv_receiver is None:
                self._kv_receiver = KVReceiver()
        q: "queue.Queue[Any]" = queue.Queue()

        def submit():
            timeout = 30.0 if deadline_s is None else min(30.0, deadline_s)
            meta, kv = self._kv_receiver.fetch(desc, timeout=timeout)
            return self.engine.adopt(prompt_tokens, kv, meta["token"],
                                     max_new_tokens, q.put_nowait, eos=eos,
                                     deadline_s=deadline_s)

        return self._token_stream(q, submit, len(prompt_tokens),
                                  max_new_tokens, deadline_s)

    # -- drain: migrate live sessions instead of re-prefilling -------------

    def drain_sessions(self, destinations: List[Dict[str, Any]],
                       timeout_s: float = 30.0) -> Dict[str, Any]:
        """Preemption drain: ship every live decode session's KV blocks to
        a surviving replica over the transfer plane, then hand each
        session's stream a migration marker so the caller splices the
        continuation — no re-prefill, token-exact under greedy sampling.
        ``destinations`` is a round-robin candidate list of
        ``{"dst": actor_id_hex, "dst_node": node_id|None}``.

        The marker rides the ordinary token stream (a dict is not a
        token): :class:`~ray_tpu_torch.serve.disagg.DisaggHandle`
        intercepts it and calls ``adopt_stream`` on the destination with
        the fed-token transcript; the handoff token that adoption emits
        again is dropped there."""
        import uuid

        from ray_tpu_torch.util import events

        if not destinations:
            raise ValueError("drain needs at least one destination replica")
        pending = self.engine.begin_migration()
        self._wake.set()
        me = self.identity()["actor"] or ""
        events.emit("serve_drain", replica=me, role=self.engine.role,
                    sessions=len(pending), destinations=len(destinations))
        migrated, failed, finished = 0, 0, 0
        sender = self._sender() if pending else None
        for n, (req, reply) in enumerate(pending):
            dst = destinations[n % len(destinations)]
            try:
                payload = reply.get(timeout=timeout_s)
                if payload is None:
                    finished += 1   # completed on its own before export
                    continue
                if isinstance(payload, BaseException):
                    raise payload
                req_id = uuid.uuid4().hex
                desc = sender.ship(
                    KVExport(token=payload["last_token"],
                             prompt_len=payload["pos"],
                             block_size=payload["block_size"],
                             kv=payload["kv"]),
                    req_id=req_id, dst_id=dst["dst"],
                    same_host=self._same_host(dst))
                # adoption emits the handoff token again (the handle drops
                # it), so the destination owes the remaining budget + 1
                req.emit({"__migrate__": {
                    "desc": desc, "dst": dst["dst"],
                    "prompt_tokens": payload["fed_tokens"],
                    "first_token": payload["last_token"],
                    "max_new_tokens": (payload["max_new_tokens"]
                                       - payload["generated"] + 1),
                    "eos": payload["eos"],
                }})
                req.emit(None)
                migrated += 1
                events.emit("serve_session_migrated", replica=me,
                            dst=dst["dst"], req=req_id,
                            kv_tokens=payload["pos"],
                            generated=payload["generated"])
            except BaseException as e:  # noqa: BLE001 - per session
                failed += 1
                try:
                    req.emit(e)
                except Exception:  # a broken sink must not stop the drain
                    pass
        return {"sessions": len(pending), "migrated": migrated,
                "failed": failed, "finished": finished}

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = dict(self.engine.stats)
        out.update(self.engine.kv_state())
        return out

    def kv_state(self) -> Dict[str, Any]:
        return self.engine.kv_state()

    def load_state(self) -> Dict[str, Any]:
        """Load report the replica pushes to the controller (the routing +
        autoscaling signal). ``kv_free`` is the CLAIMABLE count (free list
        + trie-evictable): prefix-cache retention is cache value, not
        pressure."""
        s = self.engine.kv_state()
        ident = self.identity()
        return {"inflight": s["inflight"] + s["queued"],
                "models": {self._model_id: {
                    "state": "hbm",
                    "inflight": s["inflight"] + s["queued"]}},
                "prefix_digest": s.get("prefix_digest", []),
                "kv_free": s.get("kv_claimable", s.get("kv_free", 0)),
                "kv_total": s.get("kv_total", 0),
                "role": s.get("role", "colocated"),
                "node": ident["node"],
                "actor": ident["actor"],
                "queued": s["queued"],
                "max_slots": s["max_slots"],
                "block_size": s.get("block_size", 0)}

    def check_health(self) -> None:
        if not self._thread.is_alive():
            raise RuntimeError("llm decode loop thread died")
        if self._error is not None:
            raise RuntimeError(f"llm decode loop error: {self._error!r}")

    def _close_planes(self) -> None:
        """Unlink the rings this replica created and close the ones it
        attached to. Outside a runtime the rings carry the unswept
        ``nosess`` prefix, so an in-process harness must close."""
        with self._xfer_lock:
            planes, self._kv_sender, self._kv_receiver = (
                (self._kv_sender, self._kv_receiver), None, None)
        for plane in planes:
            if plane is not None:
                plane.close()

    def close(self) -> None:
        """Stop the step loop and wait for it to leave its step (not from
        the loop thread itself), so that the engine is idle afterwards;
        then close the KV-transfer planes."""
        self._stop = True
        self._wake.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=60.0)
        self._close_planes()

    def __del__(self):  # pragma: no cover - GC-time best effort
        self._stop = True
        try:
            self._wake.set()
            self._close_planes()
        except Exception:  # __init__ failed before it set them
            pass
