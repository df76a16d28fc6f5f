"""Drive the PyTorch + CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's CUDA sources with nvcc from this checkout;
   print ptxas's registers and spills (none allowed in a bf16 kernel), and
   the wgmma (HGMMA), TMA (UTMALDG) and mma.sync (HMMA) instructions in the
   bf16 kernels' SASS (the backward kernels must run wgmma on TMA-loaded
   tiles and no mma.sync);
3. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes the models run (head dims 64, 128 and 256), and against
   itself (a repeat call is bitwise equal); softcap cases widen q so the
   cap changes the result, and fail unless it does; time kernel, plain
   version, the PyTorch library call that computes the same function (SDPA;
   under a softcap compiled ``flex_attention`` with the cap as its
   score_mod, held against the plain version, and SDPA without the cap
   timed apart; one call between events, and calls back to back), and the
   bound;
4. backward kernels: dQ and dK/dV against their plain version on the same
   cases and at head dim 256 on the Gemma-2 training shapes, bitwise equal
   on a repeat call, timed (one call between events, and calls back to
   back) beside the library's backward (SDPA's; under a softcap compiled
   ``flex_attention``'s, and SDPA's without the cap apart) and their bound;
   softcap cases fail unless the cap moves the plain version's grads;
5. forward: a small float32 forward on the card against the CPU, then
   ``models.forward`` at Llama-3-8B width (random bf16 weights from a
   seeded generator, all 32 layers) through the flash-attention kernel;
6. serving: the paged ``LLMEngine`` answers 8 requests on the same weights
   (prefix-cache hit, no leaked blocks), twice, with its programs captured
   as CUDA graphs and again eagerly (``cuda_graphs=False``): the tokens of
   the two are equal, call for call; its greedy tokens are held against
   the kernel-backed forward, in bf16 and again in float32. For each
   engine it prints TPOT p50 of both calls and one full-batch decode
   step's wall, host and device ms (``torch.profiler``) and syncs; for the
   captured one the capture seconds, graph-pool bytes, and the step's
   FLOPs and FLOP/s from the device plane; a captured step must stage and
   replay with no sync (``set_sync_debug_mode("error")``) and make one in
   all (the logits' copy). Then, in float32, ``SpeculativeLLMEngine`` on
   the same requests with the ngram drafter and with a draft model of the
   target's first 4 layers, token-exact against the plain engine
   (acceptance, tokens a round, TPOT p50 reported); and a prefill-only
   engine's KV exports adopted by a decode engine, token-exact against
   the colocated engine with no leaked block (the gather, scatter and
   copy programs' replays timed); then the same 8 requests through the
   framework: a driver process of its own (``--serve-runtime-driver``)
   that never touches the card runs ``ray_tpu_torch.init()`` (the object
   store native), deploys ``LLMDeployment`` on a ``num_gpus=1`` replica
   that opts in to the card, sends the 8 one at a time (token-exact
   against this process's engine) and then both waves at once through the
   handle and the HTTP proxy's ``?stream=1`` (the bf16 bar; TTFT, TPOT
   and tokens/s beside this process's engine under the same requests),
   and has a worker actor repeat the Llama-3-8B forward (bitwise equal,
   through kernel 1). The compiled execution plane, from the same driver:
   a compiled DAG whose stage A is that actor (its logits as a CUDA tensor
   on a tensor edge) and stage B a second actor on the card (the logits
   and their argmax on a tensor edge back), 4 invocations at
   ``max_in_flight=2`` taken out of order, bitwise the forward's, the
   driver's CUDA never initialised and no ring left after teardown; then
   ``ScoreOnCard`` (``compiled=True``, Llama-3-8B on one replica) deployed
   by ``config_api.deploy_config`` from a dict answers the 8 prompts one at
   a time through the handle and the HTTP proxy (both on the compiled
   plane), 16 callers at once and 200 no-op calls: every answer's top-5
   ids and logits bitwise this process's forward, kernel 1 launched every
   layer of every request (round trips p50 / p90 beside the replica's
   forward ms, the tensor edge's, ``rtpu_dag_executions_total``). Telemetry: the engine's metrics account for the
   serving workload (TTFT once a request, TPOT once each later token, KV
   free + used = total, the prefix counters equal the trie's), one
   ``serve::step`` span a step with tracing on, one ``jit_recompile``
   for a second batch geometry, and the captured step's host ms and syncs
   beside PR 8's. Multiplexing: ``MultiplexedLLMDeployment`` over the
   Llama-3-8B base and three rank-16 deltas (one of scale 0) under a
   budget of the base plus one variant: the swaps the budget predicts for
   the order m0, v1, v2, v1; a shed for a third model while two are
   pinned; each variant token-exact against a plain engine on
   ``apply_delta(base, delta)``, the scale-0 one against the base; the
   card's memory after the last swap within 64 MiB of what the live
   models, KV pools and graphs hold; then the same order through a
   multiplexed replica (``handle.options(model_id=...)``), token for
   token, with the store sized for the base's host copy (or spilling).
   Disaggregated serving, once this process has let go of the weights: a
   driver process of its own (``--disagg-driver``) runs ``deploy_disagg``
   with one prefill and two decode replicas sharing the card (a fraction
   of the GPU resource each), the 8 requests one at a time through
   ``DisaggHandle.stream`` (token-exact against this process's captured
   colocated engine; each one's KV transfer bytes, seconds and path from
   ``rtpu_serve_kv_transfer_*``, which must be the ring), both waves twice
   at once (the bf16 bar; TTFT, TPOT and tokens/s beside the colocated
   replica's), and a live session drained to the other decode replica
   (its tokens equal the undisturbed stream's, no re-prefill); no pool
   leaks a block and shutdown leaves no segment of the session;
7. training: one float32 train step of a small gemma-style config on the
   card against the same step on the CPU (head dims 64 and 256; full
   remat and ``remat_policy="save_attn"``), then
   ``TrainLoopHelper`` at Llama-1B width and depth (bf16 compute, f32
   master weights, full remat, B=4, L=4096) for 10 timed steps on one
   batch, through all three kernels, and at Gemma-2-9B width cut to 8
   layers (B=1, L=8192, head dim 256: the D = 256 backward kernels);
   each with its device time by kernel group from ``torch.profiler``;
   Llama-1B again under ``save_attn`` (16 / 16 / 16 launches a step, the
   first loss bitwise full remat's, the last within 1e-3);
   then Llama-1B again through the framework: 8 steps in this process,
   then ``TorchTrainer`` on one ``use_gpu`` worker whose loop checkpoints
   after step 4 (``save_checkpoint_async``) and kills its process after
   step 6; the restarted gang resumes from step 4's checkpoint, and its
   losses must equal this process's bitwise, with 32 / 16 / 16 launches
   a step in the worker (step times, ``StepTelemetry``'s tokens/s and
   MFU, the checkpoint's bytes, snapshot, write and copy seconds, death
   to the first resumed step and ``fit()`` to the first report printed);
8. Gemma-2-9B (all 42 layers, head dim 256, bf16 weights): ``models.forward``
   at B=1, L=8192 through the kernel at D = 256; the paged (at its first 20
   layers) and the dense (``paged=False``, at its first 8 layers) engine
   each answer the 8 requests of phase 6 (eager against captured,
   profiled, as there), greedy tokens held against the kernel-backed
   forward in bf16 and, at the first 8 layers, in float32;
   ``models.generate`` at the first 20 layers (B=2, 256-token prompt, 32
   new tokens), its f32 tokens held against the f32 forward;
9. Mistral-7B (bf16 weights, its first 16 of 32 layers): ``models.generate``
   on a 4608-token prompt, past the 4096 window, so the ring cache prefills
   in 4096 + 512 chunks; 16 new tokens, the f32 ones held against the f32
   forward.

Each phase prints its seconds, and the script all of them together. It
prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import glob
import hashlib
import http.client
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from ray_tpu_torch import models
from ray_tpu_torch.accelerators import gpu
from ray_tpu_torch.ops import _build, flash_cuda
from ray_tpu_torch import serve
from ray_tpu_torch.serve import LLMEngine, SpeculativeLLMEngine
from ray_tpu_torch.train import TrainLoopHelper, adamw
from ray_tpu_torch.util import device_plane

PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# f32 forward, card kernel vs CPU blockwise: summation order over 2 layers
SMALL_FORWARD_TOL = 1e-4
NEW_TOKENS = 32
# Greedy tokens of the paged engine (plain attention) against the argmax of
# the kernel-backed forward. In bf16 at this width and depth with random
# weights the two cannot agree closely: on an H100 a forward whose attention
# was the plain version instead of the kernel agreed with the kernel-backed
# one on only 0.89 of argmaxes (mean logit difference 0.029, max 0.20), the
# 32 random layers amplifying rounding-level differences. So bf16 bounds
# gross errors only (half a median top-2 logit gap of 0.14). Parity is held
# in float32, where the same two forwards differed by at most 3.5e-5 in any
# logit and agreed on every argmax: a disagreement there may only be a tie
# within 1e-3.
BF16_AGREE_MIN, BF16_GAP_TOL = 0.8, 0.25
F32_AGREE_MIN, F32_GAP_TOL = 0.95, 1e-3


def _median_ms(fn, iters=10, warmup=3):
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _busy_ms(fn, calls=10, samples=3, warmup=3):
    """Per-call time of ``calls`` calls enqueued back to back (the card stays
    busy, so the host's launch path is hidden where it is shorter than the
    kernel), median over ``samples``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _peak_bf16():
    """The card's dense bf16 peak: the number ``StepTelemetry`` takes MFU
    against (``accelerators/gpu.py`` ``peak_flops()``)."""
    peak = gpu.peak_flops()
    if peak is None:
        raise AssertionError(f"no dense bf16 peak known for "
                             f"{torch.cuda.get_device_name(0)}")
    return peak


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    # float32 products in full float32 (no TF32), on the card as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | dense bf16 "
          f"peak {_peak_bf16():.4g} FLOP/s", flush=True)
    return card.splitlines()[0]


def _ptxas_table(log):
    """{kernel<D>: "N registers, spills ..."} from ``nvcc -Xptxas -v``."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for _Z\d+(\w+?)ILi(\d+)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            table[name] = ""
        elif name and "spill" in line:
            table[name] = line.strip()
        elif name and "registers" in line:
            used = line.split("Used", 1)[1].strip()
            table[name] = f"{used}; {table[name]}"
            name = None
    return table


def _sass_counts(so, kernel, opcodes):
    """{function: {opcode: count}} over the SASS of each instantiation of
    ``kernel`` in the library ``so``, from ``cuobjdump -sass``; None where
    cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                counts[name] = dict.fromkeys(opcodes, 0)
        elif name:
            for op in opcodes:
                counts[name][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def _spills(info):
    """Bytes of spill stores plus loads in a ptxas table entry."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill", info))


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build()
    dt = time.perf_counter() - t0
    print(f"[build] {len(_build.SOURCES)} source(s) in {dt:.1f} s", flush=True)
    spilled = []
    for source, log in _build.build_log.items():
        for kernel, info in _ptxas_table(log).items():
            print(f"[build] {source}.cu {kernel}: {info}", flush=True)
            if "bf16" in kernel and _spills(info):
                spilled.append(kernel)
        for line in log.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"[build] {source}.cu: {line.strip()}", flush=True)
    # every bf16 kernel, the forward at each head dim (D = 256 included)
    # and the backward, runs wgmma (HGMMA) on tiles that TMA (UTMALDG)
    # loads, with no mma.sync (HMMA) left
    wrong = []
    for lib, kernel in (("flash_fwd", "flash_fwd_bf16_kernel"),
                        ("flash_bwd", "flash_bwd_dq_bf16_kernel"),
                        ("flash_bwd", "flash_bwd_dkv_bf16_kernel"),
                        ("flash_bwd", "flash_bwd_dkv_sweeps_bf16_kernel")):
        counts = _sass_counts(libs[lib], kernel, ("HGMMA", "UTMALDG", "HMMA"))
        if counts is None:
            print(f"[build] SASS of {kernel}: not available (no cuobjdump)",
                  flush=True)
        for fn, ops in (counts or {}).items():
            print(f"[build] SASS of {fn}: {json.dumps(ops)}", flush=True)
            if not (ops["HGMMA"] and ops["UTMALDG"]) or ops["HMMA"]:
                wrong.append(fn)
    if spilled or wrong:
        raise AssertionError(f"bf16 kernels that spill: {spilled}; bf16 "
                             f"kernels without wgmma on TMA tiles: {wrong}")


# (name, B, Lq, Lk, H, Hk, D, dtype, causal, window, softcap)
KERNEL_CASES = [
    ("causal", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None, 0.0),
    ("train_causal", 4, 4096, 4096, 16, 8, 128, torch.bfloat16, True, None,
     0.0),
    ("full", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, False, None, 0.0),
    ("window4096_L8192", 2, 8192, 8192, 32, 8, 128, torch.bfloat16, True,
     4096, 0.0),
    ("window48_L256", 2, 256, 256, 32, 8, 128, torch.bfloat16, True, 48, 0.0),
    ("softcap50", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None, 50.0),
    ("ragged_L1000", 2, 1000, 1000, 32, 8, 128, torch.bfloat16, True, None,
     0.0),
    ("ragged_q700_k1000_d64_full", 2, 700, 1000, 16, 4, 64, torch.bfloat16,
     False, None, 0.0),
    # the edges of the 128-row tiling: one full and one ragged q tile; a
    # window that is not a multiple of the tile
    ("ragged_L200", 2, 200, 200, 32, 8, 128, torch.bfloat16, True, None, 0.0),
    ("window1000_L4096", 2, 4096, 4096, 32, 8, 128, torch.bfloat16, True,
     1000, 0.0),
    ("f32_window48_softcap", 1, 300, 300, 8, 2, 128, torch.float32, True, 48,
     50.0),
    ("f32_d64", 1, 512, 512, 8, 2, 64, torch.float32, True, None, 0.0),
    # head dim 256: the gemma2_9b forward's shape at B=2, L=2048, the main
    # path's two shapes (B=1, L=8192: the 4096-window layers and the global
    # ones), a ragged length, and the float32 path
    ("gemma2_causal_softcap50_d256", 2, 2048, 2048, 16, 8, 256, torch.bfloat16,
     True, None, 50.0),
    ("gemma2_window4096_L8192_softcap50_d256", 1, 8192, 8192, 16, 8, 256,
     torch.bfloat16, True, 4096, 50.0),
    ("gemma2_global_L8192_softcap50_d256", 1, 8192, 8192, 16, 8, 256,
     torch.bfloat16, True, None, 50.0),
    ("ragged_L1000_d256", 2, 1000, 1000, 16, 8, 256, torch.bfloat16, True,
     None, 0.0),
    ("f32_window48_softcap50_d256", 1, 300, 300, 8, 2, 256, torch.float32,
     True, 48, 50.0),
]
# bf16: the kernel rounds out to bf16 (one step is 2**-7 relative) where the
# plain version keeps f32; lse is f32 in both. f32: exact f32 FMAs summed in
# another order.
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
# A softcap of 50 on unit-scale scores (q ~ N(0, 1)) changes out by under
# 0.01, so a kernel without it would pass. In the softcap cases q is widened
# by 8, as in the backward phase: the scores reach ~30, where the cap moves
# out by ~0.3-0.6 and lse by ~4-9 (plain version, CPU, D = 128 and 256). The
# softmax is then peaked and out is about one row of v, up to ~5: the bf16
# out is held to 2e-2 of max |plain out| (as the backward's grads are), since
# its rounding (and P's) scales with |out|. The case fails unless dropping
# the cap would move out by at least CAP_MARGIN times that limit.
SOFTCAP_Q_AMP, CAP_MARGIN = 8.0, 2.0


def _visible_pairs(lq, lk, causal, window):
    rows = np.arange(lq)
    hi = np.minimum(rows + 1, lk) if causal else np.full(lq, lk)
    lo = np.maximum(rows - window + 1, 0) if window else np.zeros(lq, int)
    return int(np.maximum(hi - lo, 0).sum())


def _bound(q, k, v, causal, window):
    """(bound_ms, bound_by): the larger of bytes moved and operations done,
    over the H100's published rates."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    flops = 4 * d * b * h * _visible_pairs(lq, lk, causal, window)
    nbytes = (2 * q.numel() * q.element_size()
              + (k.numel() + v.numel()) * k.element_size() + 4 * b * h * lq)
    peak = _peak_bf16() if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sdpa_inputs(q, k, v, causal, window):
    """q/k/v in SDPA's [B, H, L, D] layout and its keyword arguments for the
    same causal / window band."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (rows >= cols) & (rows - cols < window)
    return qt, kt, vt, dict(attn_mask=mask,
                            is_causal=bool(causal and mask is None),
                            enable_gqa=True)


def _library_call(q, k, v, causal, window):
    """One SDPA call on the same inputs and band, as a yardstick only: the
    port never calls it. SDPA has no softcap: for a softcapped case this is
    another, easier function, reported apart from ``library_ms``."""
    qt, kt, vt, kw = _sdpa_inputs(q, k, v, causal, window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, **kw)


def _library_bwd(q, k, v, dout, causal, window):
    """The backward alone of one SDPA call on the same inputs, cotangent
    and band (``torch.autograd.grad`` on a retained graph), as a yardstick
    only: the port never calls it. SDPA has no softcap: for a softcapped
    case this is another, easier function, reported apart from
    ``library_ms``."""
    qt, kt, vt, kw = _sdpa_inputs(q, k, v, causal, window)
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, **kw)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _flex(q, causal, window, softcap, lk):
    """``flex_attention`` compiled for one softcapped case: the cap as its
    score_mod (on the scaled score, as the kernels apply it), the causal /
    window band as a block mask built here, outside any timed call. Its
    caches go under the build directory and it compiles in this process."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(_build.BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    import torch._inductor.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    torch._inductor.config.compile_threads = 1
    torch._dynamo.reset()  # a case compiles for its own shapes, not dynamic

    def capped(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def band(b, h, qi, ki):
        keep = qi >= ki
        return keep & (qi - ki < window) if window else keep

    mask = (create_block_mask(band, None, None, q.shape[1], lk,
                              device=q.device) if causal or window else None)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda *qkv: fn(*qkv, score_mod=capped, block_mask=mask,
                           enable_gqa=True)


def _flex_call(q, k, v, causal, window, softcap):
    """One compiled ``flex_attention`` call that computes the softcapped
    function on the same inputs, as the library yardstick: the port never
    calls it. Returns it, with out in the port's [B, L, H, D] layout."""
    flex = _flex(q, causal, window, softcap, k.shape[1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: flex(qt, kt, vt).transpose(1, 2)


def _flex_bwd(q, k, v, dout, causal, window, softcap):
    """The backward alone of one compiled ``flex_attention`` call on the same
    inputs, cap, band and cotangent (``torch.autograd.grad`` on a retained
    graph), as the library yardstick: the port never calls it. Returns the
    grads (dq, dk, dv) in the port's [B, L, H, D] layout."""
    flex = _flex(q, causal, window, softcap, k.shape[1])
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = flex(*leaves)
    g = dout.transpose(1, 2)
    return lambda: [t.transpose(1, 2) for t in torch.autograd.grad(
        out, leaves, g, retain_graph=True)]


def phase_kernels():
    """Kernel against its plain version on every case; returns the timing
    rows by case."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for (name, b, lq, lk, h, hk, d, dtype, causal, window, softcap) in KERNEL_CASES:
        def rnd(*shape, amp=1.0):
            return (torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.float32) * amp).to(dtype)

        q = rnd(b, lq, h, d, amp=SOFTCAP_Q_AMP if softcap else 1.0)
        k, v = rnd(b, lk, hk, d), rnd(b, lk, hk, d)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = flash_cuda.flash_attention_fwd(q, k, v, **kw)
        ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dtype]
        limit_out = tol_out
        cap_effect = None
        if softcap:
            if dtype == torch.bfloat16:
                limit_out = tol_out * ref_out.float().abs().max().item()
            nocap, _ = flash_cuda.flash_attention_fwd_reference(
                q, k, v, causal=causal, window=window)
            cap_effect = (nocap.float() - ref_out.float()).abs().max().item()
            del nocap
        again, _ = flash_cuda.flash_attention_fwd(q, k, v, **kw)
        bitwise = torch.equal(out, again)
        del again
        kernel = lambda: flash_cuda.flash_attention_fwd(q, k, v, **kw)
        ms, busy_ms = _median_ms(kernel), _busy_ms(kernel)
        plain_ms = _median_ms(
            lambda: flash_cuda.flash_attention_fwd_reference(q, k, v, **kw),
            iters=3, warmup=1)
        lib = _library_call(q, k, v, causal, window)
        lib_ms, lib_busy_ms = _median_ms(lib), _busy_ms(lib)
        bound_ms, bound_by = _bound(q, k, v, causal, window)
        row = dict(case=name, shape=[b, lq, lk, h, hk, d],
                   dtype=str(dtype).replace("torch.", ""), causal=causal,
                   window=window, softcap=softcap, max_abs_err=err_out,
                   max_abs_err_lse=err_lse, limit=[limit_out, tol_lse],
                   bitwise_repeat=bitwise, ms=ms, busy_ms=busy_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        lib_err = None
        if softcap:
            # the library call is flex_attention with the cap; SDPA, which
            # has none, is reported apart
            flex = _flex_call(q, k, v, causal, window, softcap)
            lib_err = (flex().float() - ref_out.float()).abs().max().item()
            row.update(q_amp=SOFTCAP_Q_AMP, cap_effect=cap_effect,
                       library="flex_attention", library_ms=_median_ms(flex),
                       library_busy_ms=_busy_ms(flex),
                       library_max_abs_err=lib_err,
                       sdpa_without_softcap_ms=lib_ms,
                       sdpa_without_softcap_busy_ms=lib_busy_ms)
            del flex
        else:
            row.update(library="sdpa", library_ms=lib_ms,
                       library_busy_ms=lib_busy_ms)
        print("[kernel] " + json.dumps(row), flush=True)
        if not (err_out <= limit_out and err_lse <= tol_lse and bitwise):
            raise AssertionError(
                f"flash_attention_fwd disagrees with its plain version on "
                f"{name}: out {err_out:.3g} (limit {limit_out:.3g}), lse "
                f"{err_lse:.3g} (tol {tol_lse}), bitwise repeat {bitwise}")
        if lib_err is not None and not lib_err <= limit_out:
            raise AssertionError(
                f"{name}: flex_attention's out is {lib_err:.3g} off the plain "
                f"version (limit {limit_out:.3g}): not the same function")
        if softcap and not cap_effect >= CAP_MARGIN * limit_out:
            raise AssertionError(
                f"{name}: the softcap moves out by {cap_effect:.3g} only, "
                f"under {CAP_MARGIN} x the limit {limit_out:.3g}: the check "
                f"could not catch a kernel without it")
        rows[name] = row
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return rows


# (name, B, Lq, Lk, H, Hk, D, dtype, causal, window, softcap); the first is
# the llama_1b training shape, the second the llama3_8b forward's; at head
# dim 256 the Gemma-2 training phase's two shapes (B=1, L=8192, the
# 4096-window layers and the global ones), a ragged length, a window that
# is no multiple of the 32-row streamed tile, and the float32 path
BWD_CASES = [
    ("train_causal", 4, 4096, 4096, 16, 8, 128, torch.bfloat16, True, None,
     0.0),
    ("causal", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None, 0.0),
    ("full", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, False, None, 0.0),
    ("softcap50", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None,
     50.0),
    ("window48_L256", 2, 256, 256, 32, 8, 128, torch.bfloat16, True, 48,
     0.0),
    ("window4096_L8192", 2, 8192, 8192, 32, 8, 128, torch.bfloat16, True,
     4096, 0.0),
    ("ragged_L1000", 2, 1000, 1000, 32, 8, 128, torch.bfloat16, True, None,
     0.0),
    ("ragged_q700_k1000_d64_full", 2, 700, 1000, 16, 4, 64, torch.bfloat16,
     False, None, 0.0),
    ("f32_window48_softcap", 1, 300, 300, 8, 2, 128, torch.float32, True,
     48, 50.0),
    ("f32_d64", 1, 512, 512, 8, 2, 64, torch.float32, True, None, 0.0),
    ("gemma2_train_window4096_L8192_softcap50_d256", 1, 8192, 8192, 16, 8,
     256, torch.bfloat16, True, 4096, 50.0),
    ("gemma2_train_global_L8192_softcap50_d256", 1, 8192, 8192, 16, 8, 256,
     torch.bfloat16, True, None, 50.0),
    ("ragged_L1000_d256", 2, 1000, 1000, 16, 8, 256, torch.bfloat16, True,
     None, 0.0),
    ("window48_L256_d256", 2, 256, 256, 16, 8, 256, torch.bfloat16, True, 48,
     0.0),
    ("f32_window48_softcap50_d256", 1, 300, 300, 8, 2, 256, torch.float32,
     True, 48, 50.0),
]
# max |kernel - plain| over max |plain|, per gradient. bf16: P and dS enter
# their products rounded to 8 significant bits and the grads are rounded
# to bf16 once (2**-9 relative); accumulation is f32 in both. f32: exact
# f32 FMAs summed in another order.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# Softcap cases widen q by SOFTCAP_Q_AMP, as the forward's do, and each
# fails unless dropping the cap (the plain version without it, forward and
# backward) moves every grad by at least CAP_MARGIN times its limit: dQ
# and dK through the cap's chain factor and P, dV through P alone.


def _bwd_bounds(q, k, causal, window):
    """(bound_ms, bound_by) of the dK/dV kernel, the dQ kernel and the pair:
    products of 2*B*H*D per visible (q, k) pair (4, 3 and 7 of them), and
    the bytes each reads and writes once, over the H100's published
    rates."""
    b, lq, h, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    flop = 2 * d * b * h * _visible_pairs(lq, lk, causal, window)
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rows = 4 * b * h * lq  # one f32 row vector: lse or D
    peak = _peak_bf16() if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS

    def bound(products, nbytes):
        t_ops, t_bytes = products * flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    # dK/dV reads q, dO, k, v, lse, D and writes dk, dv; dQ reads q, O, dO,
    # k, v, lse and writes dq, D; the pair reads q, O, dO, k, v, lse and
    # writes dq, dk, dv
    return (bound(4, 2 * qb + 4 * kb + 2 * rows),
            bound(3, 4 * qb + 2 * kb + 2 * rows),
            bound(7, 4 * qb + 4 * kb + rows))


def phase_bwd_kernels(cases=BWD_CASES):
    """The backward kernels against their plain version on every case, on
    the forward kernel's out and lse, and against themselves (a repeat
    call is bitwise equal); returns the timing rows by case."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for (name, b, lq, lk, h, hk, d, dtype, causal, window, softcap) in cases:
        def rnd(*shape, amp=1.0):
            return (torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.float32) * amp).to(dtype)

        # softcap 50 on unit-scale scores would be a no-op: widen them
        q = rnd(b, lq, h, d, amp=SOFTCAP_Q_AMP if softcap else 1.0)
        k, v, dout = rnd(b, lk, hk, d), rnd(b, lk, hk, d), rnd(b, lq, h, d)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = flash_cuda.flash_attention_fwd(q, k, v, **kw)
        got = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = flash_cuda.flash_attention_bwd_reference(q, k, v, out, lse,
                                                        dout, **kw)
        torch.cuda.synchronize()
        abs_errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)]
        limits = [BWD_TOL[dtype] * w.float().abs().max().item() for w in want]
        errs = [e / w.float().abs().max().item()
                for e, w in zip(abs_errs, want)]
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        del again, got
        cap_effect = None
        if softcap:
            # the plain version without the cap, forward and backward
            nc_out, nc_lse = flash_cuda.flash_attention_fwd_reference(
                q, k, v, causal=causal, window=window)
            nocap = flash_cuda.flash_attention_bwd_reference(
                q, k, v, nc_out, nc_lse, dout, causal=causal, window=window)
            cap_effect = [(n.float() - w.float()).abs().max().item() / lim
                          for n, w, lim in zip(nocap, want, limits)]
            del nc_out, nc_lse, nocap
        run_dq, run_dkv, _ = flash_cuda._bwd_launchers(q, k, v, out, lse,
                                                        dout, **kw)
        dq_ms, dkv_ms = _median_ms(run_dq), _median_ms(run_dkv)
        dq_busy_ms, dkv_busy_ms = _busy_ms(run_dq), _busy_ms(run_dkv)
        plain_ms = _median_ms(
            lambda: flash_cuda.flash_attention_bwd_reference(
                q, k, v, out, lse, dout, **kw), iters=3, warmup=1)
        lib = _library_bwd(q, k, v, dout, causal, window)
        lib_ms, lib_busy_ms = _median_ms(lib), _busy_ms(lib)
        del lib, run_dq, run_dkv
        (dkv_bound, dkv_by), (dq_bound, dq_by), (bound_ms, bound_by) = \
            _bwd_bounds(q, k, causal, window)
        row = dict(case=name, shape=[b, lq, lk, h, hk, d],
                   dtype=str(dtype).replace("torch.", ""), causal=causal,
                   window=window, softcap=softcap,
                   rel_err=dict(zip(("dq", "dk", "dv"), errs)),
                   max_abs_err=dict(dq=abs_errs[0],
                                    dkv=max(abs_errs[1:])),
                   tol=BWD_TOL[dtype], bitwise_repeat=bitwise,
                   dkv_ms=dkv_ms, dq_ms=dq_ms, dkv_busy_ms=dkv_busy_ms,
                   dq_busy_ms=dq_busy_ms, plain_ms=plain_ms,
                   dkv_bound_ms=dkv_bound,
                   dkv_bound_by=dkv_by, dq_bound_ms=dq_bound,
                   dq_bound_by=dq_by, bound_ms=bound_ms, bound_by=bound_by)
        lib_errs = None
        if softcap:
            # the library call is flex_attention's backward with the cap;
            # SDPA's, which has none, is reported apart
            flex = _flex_bwd(q, k, v, dout, causal, window, softcap)
            lib_errs = [(g.float() - w.float()).abs().max().item()
                        / w.float().abs().max().item()
                        for g, w in zip(flex(), want)]
            row.update(q_amp=SOFTCAP_Q_AMP,
                       cap_effect_over_limit=dict(zip(("dq", "dk", "dv"),
                                                      cap_effect)),
                       library="flex_attention", library_ms=_median_ms(flex),
                       library_busy_ms=_busy_ms(flex),
                       library_rel_err=dict(zip(("dq", "dk", "dv"), lib_errs)),
                       sdpa_bwd_without_softcap_ms=lib_ms,
                       sdpa_bwd_without_softcap_busy_ms=lib_busy_ms)
            del flex
        else:
            row.update(library="sdpa", library_ms=lib_ms,
                       library_busy_ms=lib_busy_ms)
        print("[bwd-kernel] " + json.dumps(row), flush=True)
        if not (max(errs) <= BWD_TOL[dtype] and bitwise):
            raise AssertionError(
                f"flash_attention_bwd on {name}: relative errors {errs} (tol "
                f"{BWD_TOL[dtype]}), bitwise repeat {bitwise}")
        if lib_errs is not None and not max(lib_errs) <= BWD_TOL[dtype]:
            raise AssertionError(
                f"{name}: flex_attention's grads are {lib_errs} off the plain "
                f"version (tol {BWD_TOL[dtype]}): not the same function")
        if softcap and not min(cap_effect) >= CAP_MARGIN:
            raise AssertionError(
                f"{name}: dropping the softcap moves the grads (dq, dk, dv) "
                f"by only {cap_effect} x their limits, under {CAP_MARGIN}: "
                f"the check could not catch a kernel without it")
        rows[name] = row
        del q, k, v, dout, out, lse, want
        torch.cuda.empty_cache()
    return rows


def phase_small_forward(seed=0):
    """The f32 forward of a small config on the card (f32 kernel) against
    the same forward on the CPU (the plain blockwise version)."""
    cfg = models.llama_debug().replace(
        d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512,
        dtype="float32", param_dtype="float32")
    params = models.init_params(torch.Generator(device="cuda").manual_seed(seed),
                                cfg, device="cuda")
    toks = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 100)))
    with torch.inference_mode():
        got, _ = models.forward(params, toks.cuda(), cfg)
        cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.cpu())
                      for k, v in params.items()}
        want, _ = models.forward(cpu_params, toks, cfg)
    err = (got.cpu() - want).abs().max().item()
    print(f"[forward-small] f32 {cfg.n_layers} layers, card vs CPU: max abs "
          f"logit err {err:.3g} (tol {SMALL_FORWARD_TOL})", flush=True)
    if not err <= SMALL_FORWARD_TOL:
        raise AssertionError(f"small forward: card and CPU disagree by {err}")


def _bf16_weights(name, seed):
    """A preset at full width and depth with bf16 weights drawn on the card
    from a seeded generator."""
    cfg = models.get_config(name).replace(param_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = models.init_params(gen, cfg, device="cuda")
    n = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    print(f"[weights] {name}: {n / 1e9:.3f} B params bf16, {cfg.n_layers} "
          f"layers, head dim {cfg.hdim}, windows {cfg.window_pattern}",
          flush=True)
    return cfg, params, gen


def _forward_logits(name, b, l, seed):
    """A preset's bf16 weights drawn on the card from a seeded generator,
    the tokens drawn next from the same generator, and the forward's
    logits, counting kernel launches (the forward phase, and the worker
    actor that must reproduce it bitwise)."""
    cfg, params, gen = _bf16_weights(name, seed)
    toks = torch.randint(0, cfg.vocab_size, (b, l), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        flash_cuda.launches = 0
        t0 = time.perf_counter()
        logits, _ = models.forward(params, toks, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = flash_cuda.launches
    return cfg, params, toks, logits, first_s, launches


def _sha256(t):
    """The sha256 of a tensor's bytes."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(flat.cpu().numpy()).hexdigest()


def _logits_ref(logits):
    """What a forward is held to bitwise: the sha256 of its logits' bytes
    and its last position's logits (on the host)."""
    return dict(sha256=_sha256(logits), last=logits[:, -1].cpu())


def phase_forward(card, name="llama3-8b", b=2, l=2048, seed=0):
    """A preset at full width and depth, bf16 weights from a seeded
    generator, through the flash-attention kernel: llama3_8b at B=2,
    L=2048; gemma2_9b (head dim 256, windows 4096 / global, softcaps) at
    B=1, L=8192, where layer 0's 4096 window masks. Returns the config,
    the params, the kernel launches and what a repeat of the forward in
    another process is held to (``_logits_ref``)."""
    cfg, params, toks, logits, first_s, launches = _forward_logits(
        name, b, l, seed)
    with torch.inference_mode():
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        ref = _logits_ref(logits)
        del logits
        fwd_ms = _median_ms(lambda: models.forward(params, toks, cfg),
                            iters=3, warmup=1)
    print(f"[forward] {name} B={b} L={l}: logits {shape} finite={finite}, "
          f"kernel launches {launches} (layers {cfg.n_layers}), first call "
          f"{first_s:.2f} s, {fwd_ms:.1f} ms/forward = "
          f"{b * l / fwd_ms * 1e3:.0f} tokens/s on {card}", flush=True)
    if shape != (b, l, cfg.vocab_size) or not finite:
        raise AssertionError(f"forward logits bad: shape {shape}, "
                             f"finite {finite}")
    if launches != cfg.n_layers:
        raise AssertionError(f"the forward launched the kernel {launches} "
                             f"times, expected {cfg.n_layers}")
    return cfg, params, launches, ref


def _waves(cfg, seed):
    """8 prompts of 64-384 tokens in two waves of 4; half share a 128-token
    system prompt."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, 128).tolist()

    def prompt(n, shared):
        head = system if shared else []
        return head + rng.integers(0, cfg.vocab_size, n - len(head)).tolist()

    return [[prompt(160, True), prompt(64, False), prompt(192, False),
             prompt(288, True)],
            [prompt(224, True), prompt(128, False), prompt(320, False),
             prompt(384, True)]]


def _serve(eng, waves, new_tokens):
    """The second wave joins while the first decodes, once the first
    shared-prompt request has finished (so its blocks sit in the prefix
    trie); returns [(prompt, emitted items)], the wall time, and this
    call's TTFT and TPOT p50 (seconds, host clock, from each emit's time)."""
    sinks, stamps = [], []

    def submit(wave):
        for p in wave:
            out, ts = [], []
            sinks.append((p, out))
            stamps.append((time.perf_counter(), ts))

            def emit(x, out=out, ts=ts):
                ts.append(time.perf_counter())
                out.append(x)
            eng.submit(p, new_tokens, emit)

    t0 = time.perf_counter()
    submit(waves[0])
    while None not in sinks[0][1]:
        eng.step()
    submit(waves[1])
    steps = 0
    while eng.step():
        steps += 1
        if steps > 2000:
            raise AssertionError("engine did not drain")
    wall = time.perf_counter() - t0
    for p, out in sinks:
        if out[-1] is not None or len(out) != new_tokens + 1:
            raise AssertionError(f"request of {len(p)} tokens got {out[-3:]}"
                                 f" ({len(out)} items)")
    ttft = [ts[0] - t_sub for t_sub, ts in stamps]
    tpot = [b - a for _, ts in stamps for a, b in zip(ts[:-2], ts[1:-1])]
    return sinks, wall, dict(ttft_p50_s=float(np.median(ttft)),
                             tpot_p50_s=float(np.median(tpot)))


def _greedy_vs_forward(params, cfg, sinks, device):
    """Each request's greedy tokens against the kernel-backed forward over
    its prompt + generated[:-1]: (positions where the engine's token is an
    argmax of the forward's logits, positions, worst logit gap)."""
    agree = positions = 0
    worst_gap = 0.0
    with torch.inference_mode():
        for p, out in sinks:
            gen_toks = out[:-1]
            seq = torch.tensor([p + gen_toks[:-1]], device=device)
            logits, _ = models.forward(params, seq, cfg)
            lg = logits[0, len(p) - 1:]                  # [new_tokens, V]
            chosen = lg[torch.arange(len(gen_toks), device=device),
                        torch.tensor(gen_toks, device=device)]
            gap = lg.max(dim=-1).values - chosen
            agree += int((gap == 0).sum())
            positions += len(gen_toks)
            worst_gap = max(worst_gap, gap.max().item())
    return agree, positions, worst_gap


def _check_greedy(label, agree, positions, worst_gap, agree_min, gap_tol):
    ratio = agree / positions
    print(f"[{label}] greedy vs kernel-backed forward: {agree}/{positions} = "
          f"{ratio:.4f} agree (min {agree_min}); worst logit gap "
          f"{worst_gap:.4g} (tol {gap_tol})", flush=True)
    if ratio < agree_min or worst_gap > gap_tol:
        raise AssertionError(f"{label}: engine disagrees with the forward: "
                             f"agree {ratio:.4f}, worst gap {worst_gap:.4g}")
    return ratio


def _steady_decode(eng, cfg, seed, new_tokens=12):
    """Fill every slot with a 16-token request and step until each one
    decodes: the steps after this are decode steps of a full batch."""
    rng = np.random.default_rng(seed)
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, cfg.vocab_size, 16).tolist(), new_tokens,
                   lambda t: None)
    while any(r is None or r.consumed < len(r.prompt) for r in eng._slots):
        eng.step()


class _SyncsAreErrors:
    """Within a step, everything up to the logits' copy to the host (the
    staging copy, the replay) runs under ``set_sync_debug_mode("error")``:
    a sync there raises."""

    def __init__(self, eng):
        self.eng = eng

    def __enter__(self):
        eng = self.eng
        self.saved = (eng._in.send, eng._step_fn)

        def guarded(fn):
            def call(*a, **kw):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return call
        eng._in.send, eng._step_fn = (guarded(f) for f in self.saved)

    def __exit__(self, *exc):
        self.eng._in.send, self.eng._step_fn = self.saved


# the warning each sync makes under set_sync_debug_mode("warn") (setting
# the mode warns too, in other words)
SYNC_WARNING = "called a synchronizing CUDA operation"


def _step_profile(eng, cfg, seed):
    """One full-batch decode step, four times over: its wall time, the
    host's share before the logits' copy (issuing the step), and the
    device's kernel time from ``torch.profiler``; the syncs a step makes
    (``set_sync_debug_mode("warn")``); and, for a captured engine, a step
    whose staging and replay run with syncs as errors. First, the median
    host share of 20 such steps (``host_ms_median``): before the
    profiler: once a process has run it, a captured llama3_8b step took
    1.0-1.5 ms of host time against 0.27-0.36 before (NVIDIA H100 80GB
    HBM3, 700 W)."""
    host_ms_median = _host_ms_median(eng, cfg, seed + 100)
    _steady_decode(eng, cfg, seed)
    marks = {}
    fetch = eng._out.fetch

    def marked(t):
        marks["issued"] = time.perf_counter()
        return fetch(t)
    eng._out.fetch = marked
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        host_ms = (marks["issued"] - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            eng.step()
        device_ms = kernels = 0
        top = []
        for evt in prof.key_averages():
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and not evt.is_user_annotation):
                ms = evt.self_device_time_total / 1e3
                device_ms += ms
                kernels += evt.count
                top.append((ms, evt.key[:60], evt.count))
    finally:
        eng._out.fetch = fetch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    if eng.cuda_graphs:
        with _SyncsAreErrors(eng):
            eng.step()
    while eng.step():
        pass
    return dict(wall_ms=wall_ms, host_ms=host_ms,
                host_ms_median=host_ms_median, device_ms=device_ms,
                device_events=kernels, syncs=syncs,
                top_kernels=[dict(kernel=k, ms=m, calls=n)
                             for m, k, n in sorted(top, reverse=True)[:6]])


def phase_serving(cfg, params, card, seed=0, device="cuda", paged=True):
    """The serving path, eager against captured: 8 requests through the
    engine in the model's bf16, at 8 slots and max_len 512, the paged
    engine (16-token blocks, prefix cache: a hit and no leaked block
    required) or the dense one (``paged=False``: one token a step a slot).
    Each engine, captured (the default) and eager (``cuda_graphs=False``),
    runs the workload twice; their tokens must be equal, call for call.
    The captured engine's first call is held against the kernel-backed
    forward. Then one full-batch decode step of each is profiled (wall,
    host and device ms, syncs), and a captured step must stage and replay
    with no sync."""
    label = "serve" if paged else "serve dense"
    program = "serve::decode_step_paged" if paged else "serve::decode_step"
    waves = _waves(cfg, seed)
    out = {}
    for graphs in (True, False):
        kind = "captured" if graphs else "eager"
        eng = LLMEngine(cfg, params, max_slots=8, max_len=512, block_size=16,
                        paged=paged, cuda_graphs=graphs, device=device)
        calls = [_serve(eng, waves, NEW_TOKENS) for _ in range(2)]
        row = device_plane.registry().program(program)
        prof = _step_profile(eng, cfg, seed + 1)
        state = eng.kv_state()
        total = eng.stats["tokens_generated"]
        blocks = (f"prefix {state['prefix']}; kv_free {state['kv_free']} + "
                  f"nodes {state['prefix']['nodes']} / {state['kv_total']}; "
                  if paged else "")
        rec = dict(
            tpot_p50_ms=[c[2]["tpot_p50_s"] * 1e3 for c in calls],
            ttft_p50_ms=[c[2]["ttft_p50_s"] * 1e3 for c in calls],
            tokens_per_s=[NEW_TOKENS * len(c[0]) / c[1] for c in calls],
            flops_per_step=row["cost"]["flops"],
            flops_per_s=eng.stats.get("flops_per_s"), **prof)
        on_card = graphs and torch.device(device).type == "cuda"
        if on_card:
            rec.update(capture_s=row["compile_s_last"],
                       graph_pool_bytes=row["memory"]["graph_pool_bytes"],
                       captures=eng._step_fn.captures)
        print(f"[{label} {kind}] {cfg.n_layers} layers: {total} tokens; "
              f"{json.dumps(rec)}; {blocks}on {card}", flush=True)
        if paged and state["prefix"]["hits"] < 1:
            raise AssertionError(f"no prefix-cache hit: {state['prefix']}")
        if paged and (state["kv_free"] + state["prefix"]["nodes"]
                      != state["kv_total"]):
            raise AssertionError(f"KV blocks leaked: {state}")
        if on_card and (rec["captures"] != 1 or rec["syncs"] != 1):
            raise AssertionError(f"{label} captured: {rec['captures']} "
                                 f"captures, {rec['syncs']} syncs a step")
        if graphs:
            _check_greedy(f"{label} bf16",
                          *_greedy_vs_forward(params, cfg, calls[0][0],
                                              device),
                          BF16_AGREE_MIN, BF16_GAP_TOL)
        out[kind] = (rec, [c[0] for c in calls])
        del eng
        torch.cuda.empty_cache()
    for i in range(2):
        if out["captured"][1][i] != out["eager"][1][i]:
            raise AssertionError(f"{label}: call {i}: the captured engine's "
                                 "tokens differ from the eager engine's")
    print(f"[{label}] captured tokens == eager tokens in both calls",
          flush=True)
    return {kind: rec for kind, (rec, _) in out.items()}


def phase_greedy_f32(cfg, params, card, seed=0, device="cuda", paged=True):
    """Greedy parity in float32: the same bf16 weights and requests, the
    engine and the forward computing in float32 (the kernel's f32 path).
    Returns the engine's [(prompt, emitted)]."""
    label = "serve f32" if paged else "serve dense f32"
    cfg32 = cfg.replace(dtype="float32")
    eng = LLMEngine(cfg32, params, max_slots=8, max_len=512, block_size=16,
                    paged=paged, device=device)
    sinks, wall, timing = _serve(eng, _waves(cfg32, seed), NEW_TOKENS)
    print(f"[{label}] {cfg.n_layers} layers: {eng.stats['tokens_generated']} "
          f"tokens in {wall:.2f} s (TPOT p50 "
          f"{timing['tpot_p50_s'] * 1e3:.1f} ms) on {card}", flush=True)
    _check_greedy(label, *_greedy_vs_forward(params, cfg32, sinks, device),
                  F32_AGREE_MIN, F32_GAP_TOL)
    return sinks


def _draft_of(cfg, params, n_layers):
    """A draft model cut from the target: its first ``n_layers`` layers and
    its embedding, final norm and head (views, no copy), so the vocabulary
    is the target's."""
    draft = {k: v for k, v in params.items() if k != "layers"}
    draft["layers"] = {k: v[:n_layers] for k, v in params["layers"].items()}
    return cfg.replace(n_layers=n_layers), draft


def phase_speculate(cfg, params, card, plain_sinks, seed=0, device="cuda"):
    """Speculative decoding in float32 on the 8 requests of the serving
    phase, with the ngram drafter and with a draft model of the target's
    first 4 layers: the tokens must equal the plain paged engine's
    (``plain_sinks``, from ``phase_greedy_f32``), token for token.
    Acceptance, tokens a round and TPOT p50 are reported, not gated."""
    cfg32 = cfg.replace(dtype="float32")
    draft_cfg, draft_params = _draft_of(cfg32, params, 4)
    out = {}
    for drafter, kw in (("ngram", {}),
                        ("model", dict(draft_model=draft_cfg,
                                       draft_params=draft_params))):
        eng = SpeculativeLLMEngine(cfg32, params, drafter=drafter,
                                   max_slots=8, max_len=512, block_size=16,
                                   device=device, **kw)
        sinks, wall, timing = _serve(eng, _waves(cfg32, seed), NEW_TOKENS)
        st = eng.kv_state()["spec"]
        rounds = max(st["spec_rounds"], 1)
        rec = dict(acceptance=st["spec_accepted"] / max(st["spec_proposed"],
                                                        1),
                   tokens_per_round=(st["spec_accepted"] + rounds) / rounds,
                   tpot_p50_ms=timing["tpot_p50_s"] * 1e3,
                   tokens_per_s=NEW_TOKENS * len(sinks) / wall,
                   steps=eng.stats["steps"], **st)
        print(f"[speculate {drafter}] {cfg.n_layers} layers f32 (draft: "
              f"{draft_cfg.n_layers if drafter == 'model' else 0} layers): "
              f"{json.dumps(rec)} on {card}", flush=True)
        if sinks != plain_sinks:
            bad = sum(a != b for a, b in zip(sinks, plain_sinks))
            raise AssertionError(f"speculate {drafter}: {bad} of "
                                 f"{len(sinks)} requests differ from the "
                                 "plain engine's tokens")
        out[drafter] = rec
        del eng
    print("[speculate] both drafters token-exact against the plain engine",
          flush=True)
    return out


def _pow2(n):
    return 1 << max(n - 1, 0).bit_length()


def phase_export_adopt(cfg, params, card, seed=0, device="cuda"):
    """Disaggregated serving on two engines, float32: the first wave's 4
    requests are prefilled on a prefill-only engine, their KV exported
    (``KVExport``) and adopted by a decode engine; the tokens must equal
    the colocated engine's, with no block leaked on either pool. Times the
    gather and scatter programs' replays (CUDA events)."""
    cfg32 = cfg.replace(dtype="float32")
    prompts = _waves(cfg32, seed)[0]
    kw = dict(max_slots=8, max_len=512, block_size=16, device=device)

    def drain(eng):
        while eng.step():
            pass

    colocated, exports, adopted = [], [], []
    eng = LLMEngine(cfg32, params, **kw)
    for p in prompts:
        colocated.append([])
        eng.submit(p, NEW_TOKENS, colocated[-1].append)
    drain(eng)
    del eng
    P = LLMEngine(cfg32, params, role="prefill", **kw)
    D = LLMEngine(cfg32, params, role="decode", **kw)
    t0 = time.perf_counter()
    for p in prompts:
        exports.append([])
        P.submit(p, NEW_TOKENS, exports[-1].append, prefill_only=True)
    drain(P)
    t1 = time.perf_counter()
    exports = [e[0] for e in exports]
    for p, e in zip(prompts, exports):
        adopted.append([])
        D.adopt(p, e.kv, e.token, NEW_TOKENS, adopted[-1].append)
    drain(D)
    t2 = time.perf_counter()
    for eng in (P, D):
        st = eng.kv_state()
        if st["kv_free"] + st["prefix"]["nodes"] != st["kv_total"]:
            raise AssertionError(f"{st['role']} engine leaked KV blocks: "
                                 f"{st}")
    if adopted != colocated:
        bad = sum(a != b for a, b in zip(adopted, colocated))
        raise AssertionError(f"export/adopt: {bad} of {len(prompts)} "
                             "requests differ from the colocated engine")
    # the programs' replay times at the buckets this run captured: the
    # largest export's, and the one scatter of the 4 adoptions
    captures = dict(gather=P._gather_fn.captures,
                    scatter=D._scatter_fn.captures)
    nb = [P.pool.blocks_for_tokens(len(p)) for p in prompts]
    g_ids = torch.arange(min(_pow2(max(nb)), P._tbl_width), device=device)
    s_ids = torch.arange(_pow2(sum(nb)), device=device)
    zeros = {k: torch.zeros_like(D._cache[k][:, :len(s_ids)])
             for k in ("k", "v")}
    rec = dict(
        export_s=t1 - t0, adopt_and_decode_s=t2 - t1,
        export_bytes=sum(e.nbytes for e in exports),
        gather_blocks=len(g_ids), scatter_blocks=len(s_ids),
        gather_ms=_median_ms(lambda: P._gather_fn(P._cache, g_ids)),
        scatter_ms=_median_ms(lambda: D._scatter_fn(D._cache, s_ids, zeros)),
        copy_ms=_median_ms(lambda: D._copy_fn(D._cache,
                                              D._block_pair(0, 1))),
        captures=captures,
        exported=P.stats["exported"], adopted=D.stats["adopted"])
    print(f"[export/adopt] {cfg.n_layers} layers f32, {len(prompts)} "
          f"requests: tokens == colocated, no leaked block; "
          f"{json.dumps(rec)} on {card}", flush=True)
    return rec


# The serving engine's metrics, read from the port's metric registry: a
# histogram by its observation count, a counter or gauge by its value (one
# tag set each here)
SERVE_METRICS = ("rtpu_serve_ttft_seconds", "rtpu_serve_tpot_seconds",
                 "rtpu_serve_prefix_cache_hits_total",
                 "rtpu_serve_prefix_cache_misses_total",
                 "rtpu_serve_prefix_hit_tokens_total",
                 "rtpu_serve_kv_blocks_free", "rtpu_serve_kv_blocks_used",
                 "rtpu_serve_pool_inflight", "rtpu_serve_pool_queued",
                 "rtpu_serve_pool_kv_used_fraction",
                 "rtpu_device_achieved_flops_per_s")
# the captured llama3_8b step's host time (one step) and syncs on an H100
# 80GB HBM3 at 700 W (PERF.md §5, PR 8). One step's host time spreads
# 0.27-0.99 ms between calls on that card, the median of 20 0.57-0.59: the
# median is held to twice PR 8's one step, which a sync or a registry
# lookup in the step would pass; experiments/torch_serve_step_syncs.py
# --captured compares two trees in one call for the finer question
HOST_MS_PR8, HOST_MS_NOISE, SYNCS_PR8 = 0.42, 2.0, 1


def _serve_metric_values():
    from ray_tpu_torch.util import metric_defs

    out = {}
    for name in SERVE_METRICS:
        m = metric_defs.get(name)
        out[name] = sum(v[2] if m.metric_type == "histogram" else v
                        for _, v in m._samples())
    return out


def _host_ms_median(eng, cfg, seed, steps=20):
    """Median host ms of ``steps`` full-batch decode steps: from the step's
    start to the logits' copy (issuing the step; the wait after is the
    card's)."""
    import gc

    _steady_decode(eng, cfg, seed, new_tokens=steps + 4)
    gc.collect()
    marks, times = {}, []
    fetch = eng._out.fetch

    def marked(t):
        marks["issued"] = time.perf_counter()
        return fetch(t)
    eng._out.fetch = marked
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            eng.step()
            times.append((marks["issued"] - t0) * 1e3)
    finally:
        eng._out.fetch = fetch
    while eng.step():
        pass
    return float(np.median(times))


def phase_serving_telemetry(cfg, params, card, captured, seed=0,
                            device="cuda"):
    """The serving engine's telemetry on the serving phase's workload: a
    fresh captured paged engine answers the 8 requests, and the metrics
    must account for them: TTFT observed once a request, TPOT once each
    later token, KV free + used = total, the prefix counters equal to the
    trie's. A second call with tracing on: one ``serve::step`` span a
    step. A step of another batch geometry (a 4-slot engine over the same
    pool size) must emit exactly one ``jit_recompile`` event. The
    captured step's host ms (the median of 20 steps before the profiler
    ran: the serving phase's ``captured`` row) and syncs, with the metrics
    on, beside PR 8's; the same median after the profiler; and what the
    metrics cost the host a step."""
    from ray_tpu_torch.util import events, tracing

    waves = _waves(cfg, seed)
    kw = dict(max_len=512, block_size=16, device=device)
    eng = LLMEngine(cfg, params, max_slots=8, **kw)
    before = _serve_metric_values()
    sinks, _, _ = _serve(eng, waves, NEW_TOKENS)
    after = _serve_metric_values()
    moved = {k: after[k] - before[k] for k in after}
    state = eng.kv_state()
    n_req = len(sinks)
    n_tok = sum(len(out) - 1 for _, out in sinks)
    checks = dict(
        ttft_count=(moved["rtpu_serve_ttft_seconds"], n_req),
        tpot_count=(moved["rtpu_serve_tpot_seconds"], n_tok - n_req),
        kv_free_plus_used=(after["rtpu_serve_kv_blocks_free"]
                           + after["rtpu_serve_kv_blocks_used"],
                           state["kv_total"]),
        kv_free=(after["rtpu_serve_kv_blocks_free"], state["kv_free"]),
        prefix_hits=(moved["rtpu_serve_prefix_cache_hits_total"],
                     state["prefix"]["hits"]),
        prefix_misses=(moved["rtpu_serve_prefix_cache_misses_total"],
                       state["prefix"]["misses"]),
        prefix_hit_tokens=(moved["rtpu_serve_prefix_hit_tokens_total"],
                           state["prefix"]["hit_tokens"]),
        pool_inflight=(after["rtpu_serve_pool_inflight"], 0))
    # one call with tracing on: a span a step (the engine is past its
    # first step, which the span skips)
    tracing.drain_ring()
    tracing.enable_tracing()
    try:
        steps0 = eng.stats["steps"]
        _serve(eng, waves, NEW_TOKENS)
        steps = eng.stats["steps"] - steps0
        spans = [r for r in tracing.drain_ring() if r["name"] == "serve::step"]
    finally:
        tracing.disable_tracing()
    checks["step_spans"] = (len(spans), steps)
    # a second batch geometry: the step's one retrace, one event
    events.drain_ring()
    other = LLMEngine(cfg, params, max_slots=4,
                      num_blocks=eng.pool.num_blocks, **kw)
    other.submit(waves[0][1], 2, lambda t: None)
    while other.step():
        pass
    recompiles = [e for e in events.drain_ring()
                  if e["name"] == "jit_recompile"]
    checks["jit_recompile_events"] = (len(recompiles), 1)
    del other
    # the captured step with the metrics on, as PR 8 measured it (one
    # step, before the profiler ran: the serving phase's), and the median
    # of 20 steps before and after the profiler; what the metrics cost
    after_profiler_ms = _host_ms_median(eng, cfg, seed + 2)
    prof = dict(host_ms=captured["host_ms_median"], syncs=captured["syncs"])
    t0 = time.perf_counter()
    for _ in range(100):
        eng._sample_gauges()
        eng._note_device_step(0.026)
    telemetry_us = (time.perf_counter() - t0) / 100 * 1e6
    rec = dict(metrics={k: after[k] for k in SERVE_METRICS},
               moved={k: moved[k] for k in SERVE_METRICS[:5]},
               checks={k: list(v) for k, v in checks.items()},
               recompile=dict(program=recompiles[0]["program"],
                              diff=recompiles[0]["diff"])
               if recompiles else None,
               host_ms_one_step=captured["host_ms"], host_ms_pr8=HOST_MS_PR8,
               host_ms_median=prof["host_ms"],
               host_ms_median_after_profiler=after_profiler_ms,
               syncs=prof["syncs"], syncs_pr8=SYNCS_PR8,
               telemetry_host_us_per_step=telemetry_us)
    print(f"[serve telemetry] {cfg.n_layers} layers: {json.dumps(rec)} on "
          f"{card}", flush=True)
    print(f"[serve telemetry] captured step host ms: median of 20 "
          f"{prof['host_ms']:.3f} (limit {HOST_MS_PR8 * HOST_MS_NOISE}), one "
          f"step {captured['host_ms']:.3f} (PR 8, one step: {HOST_MS_PR8}), "
          f"median after the profiler {after_profiler_ms:.3f}; syncs "
          f"{prof['syncs']} (PR 8: {SYNCS_PR8}); the metrics' host cost a "
          f"step {telemetry_us:.1f} us", flush=True)
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"serving telemetry (got, want): {bad}")
    if prof["syncs"] != SYNCS_PR8 or \
            prof["host_ms"] > HOST_MS_PR8 * HOST_MS_NOISE:
        raise AssertionError(
            f"captured step: {prof['syncs']} syncs, host {prof['host_ms']} "
            f"ms against PR 8's {SYNCS_PR8} and {HOST_MS_PR8} ms (limit "
            f"{HOST_MS_PR8 * HOST_MS_NOISE})")
    del eng
    torch.cuda.empty_cache()
    return rec


# The multiplex phase: llama3_8b's bf16 weights as the base "m0", two
# LoRA-style variants of rank 16 over wq and wv ("v1", "v2"; scale 0.5)
# and a scale-0 one ("z"), their factors drawn on the host from seeds so
# that a replica draws the same; the budget holds the base plus one
# variant. Prompts: the serving phase's 8.
MUX_RANK, MUX_SCALE, MUX_TARGETS = 16, 0.5, ("wq", "wv")
MUX_DELTAS = {"v1": (11, MUX_SCALE), "v2": (12, MUX_SCALE), "z": (13, 0.0)}
# one at a time, 2 prompts each: the order whose swaps the budget predicts
# (and which the replica repeats through the framework)
MUX_ORDER = ("m0", "v1", "v2", "v1")
MUX_SEQ_PROMPTS = 2
# the card's allocated bytes after the last swap against what the live
# models, KV pools and captured graphs hold
MUX_MEMORY_TOL = 64 << 20


def _settle_memory():
    """Collect garbage, wait for the card and drop cuBLAS's cached
    workspaces (one a stream, allocated through the caching allocator: a
    capture's side stream would otherwise show up as held bytes)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()


def _mux_deltas(cfg):
    """The variants' deltas, drawn on the host from their seeds."""
    return {mid: models.make_delta(torch.Generator().manual_seed(s), cfg,
                                   rank=MUX_RANK, scale=scale,
                                   targets=MUX_TARGETS, device="cpu")
            for mid, (s, scale) in MUX_DELTAS.items()}


def _mux_spec(cfg, deltas, params=None, seed=0):
    spec = {"m0": ({"config": cfg, "params": params} if params is not None
                   else {"config": cfg, "seed": seed})}
    spec.update({mid: {"base": "m0", "delta": d} for mid, d in deltas.items()})
    return spec


def _variant_bytes(cfg, delta):
    """A variant's resident charge, as the reference's registry counts it:
    its factors plus the rebuilt projections."""
    L, d = cfg.n_layers, cfg.d_model
    item = models.transformer.torch_dtype(cfg.param_dtype).itemsize
    size = {"wq": d * cfg.n_heads * cfg.hdim, "wv": d * cfg.kv_heads * cfg.hdim}
    return models.delta_bytes(delta) + sum(L * size[t] * item
                                           for t in delta["targets"])


def _lru_swaps(ops, sizes, budget, bases):
    """The swaps a budgeted registry makes for ``ops`` (``("pin" |
    "unpin" | "ensure", model)``), restated from the reference's policy:
    a miss evicts least-recently-used unpinned resident models (never the
    one asked for) until its bytes fit, then materialises it (a variant
    its base first, with the same rule); nothing evictable is a shed, and
    a shed leaves what it evicted out. Returns ({model: [in, out]}, the
    models each shed was for, the models resident at the end)."""
    resident, pins, used = set(), {m: 0 for m in sizes}, {}
    counts = {m: [0, 0] for m in sizes}
    sheds, clock = [], [0]

    class Shed(Exception):
        pass

    def ensure(m):
        if m not in resident:
            while sum(sizes[r] for r in resident) + sizes[m] > budget > 0:
                victims = [r for r in resident if not pins[r] and r != m]
                if not victims:
                    raise Shed(m)
                v = min(victims, key=used.get)
                resident.discard(v)
                counts[v][1] += 1
            if bases.get(m):
                ensure(bases[m])
            resident.add(m)
            counts[m][0] += 1
        clock[0] += 1
        used[m] = clock[0]

    for op, m in ops:
        if op == "pin":
            pins[m] += 1
        elif op == "unpin":
            pins[m] -= 1
        else:
            try:
                ensure(m)
            except Shed:
                sheds.append(m)
    return counts, sheds, resident


def _request_ops(m):
    return [("pin", m), ("ensure", m), ("unpin", m)]


def _cuda_storage_bytes(trees, seen):
    """Bytes of the distinct CUDA storages reachable from ``trees`` (dicts,
    lists, tuples, tensors) and not yet in ``seen`` (storage addresses,
    updated)."""
    total = 0
    stack = list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                st = x.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def _mux_held_bytes(dep, exclude):
    """What the multiplexed deployment holds on the card, by kind: the
    resident models' params (shared leaves once), each engine's KV cache
    and staging, and its captured graphs' static inputs and outputs;
    storages in ``exclude`` (already there before the phase) not
    counted."""
    seen = set(exclude)
    engines = [d.engine for d in dep._deps.values()]
    out = dict(models=_cuda_storage_bytes(
        [e["params"] for e in dep.registry._entries.values()]
        + [eng.params for eng in engines], seen))
    out["kv"] = _cuda_storage_bytes(
        [eng._cache for eng in engines] + [eng._in.dev for eng in engines],
        seen)
    progs = [fn for eng in engines for fn in (
        eng._step_fn, eng._copy_fn, eng._gather_fn, eng._scatter_fn)]
    caps = [cap for fn in progs for cap in fn._graphs.values()]
    out["graphs"] = _cuda_storage_bytes(
        [(cap.statics, cap.outputs) for cap in caps], seen)
    out["captures"] = len(caps)
    # the live graphs' private pools, reserved (their buffers above are
    # the allocated part)
    out["graph_pools"] = sum(cap.pool_bytes for cap in caps)
    return out


def _captures_so_far(program):
    """(captures, capture seconds) of a registered program so far."""
    row = device_plane.registry().program(program) or {}
    return row.get("compiles", 0), row.get("compile_s_total", 0.0)


def _mux_stream(dep, mid, prompt, stamps=None):
    """One request's tokens (and their arrival times into ``stamps``)."""
    t0 = time.perf_counter()
    toks, ts = [], []
    for tok in dep(prompt, NEW_TOKENS, model_id=mid):
        ts.append(time.perf_counter())
        toks.append(tok)
    if stamps is not None:
        stamps.append((t0, ts))
    return toks


def _mux_workload(dep, mid, prompts):
    """The 8 requests to one model at once (a thread each): their tokens,
    TTFT / TPOT p50 from each stream's submit and token times, and the
    first token's time from the start."""
    toks, stamps, errors = [None] * len(prompts), [], []

    def run(i):
        try:
            toks[i] = _mux_stream(dep, mid, prompts[i], stamps)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise AssertionError(f"multiplex {mid} streams failed: {errors[:3]}")
    stats = _stream_stats(stamps, NEW_TOKENS * len(prompts))
    stats["first_token_s"] = (min(ts[0] for _, ts in stamps)
                              - min(t0 for t0, _ in stamps))
    return toks, stats


def _plain_tokens(cfg, params, prompts, device):
    """The same requests through a plain captured ``LLMEngine``, all
    submitted at once."""
    eng = LLMEngine(cfg, params, max_slots=8, max_len=512, block_size=16,
                    device=device)
    sinks = [[] for _ in prompts]
    for p, s in zip(prompts, sinks):
        eng.submit(p, NEW_TOKENS, s.append)
    while eng.step():
        pass
    return [s[:-1] for s in sinks]


def phase_multiplex(cfg, params, card, seed=0, device="cuda"):
    """Many models from one deployment, in this process: a
    ``MultiplexedLLMDeployment`` over the base (llama3_8b's bf16 weights,
    copied to the host by the registry), two rank-16 variants and a
    scale-0 one, under a budget of the base plus one variant.

    - One at a time, 2 requests each to m0, v1, v2, v1: the registry's
      swaps in and out must be what the budget predicts
      (``_lru_swaps``). Swap-in to first token is timed for the base and
      a variant, with the registry's materialisation and the step's
      captures inside it.
    - With streams on v1 and v2 in flight (pinned), a request for z must
      shed (``model_budget``); once they end, it is answered.
    - The 8 requests at once to z, m0, v1 and v2: z's tokens equal m0's;
      v1's and v2's equal a plain captured ``LLMEngine`` on
      ``apply_delta(base, delta)``, token for token, and meet the bf16 bar
      against the kernel-backed forward of those weights.
    - After the last swap the card's allocated bytes are within
      ``MUX_MEMORY_TOL`` of what the deployment holds (models, KV pools,
      captured graphs' buffers) over what was there before: dropped
      engines' graphs released their pools. After ``close`` the card is
      back where it was.

    Returns the one-at-a-time tokens (for the replica's run of the same
    order) and the budget."""
    from ray_tpu_torch.serve import MultiplexedLLMDeployment, RequestShedError

    _settle_memory()
    base_alloc = torch.cuda.memory_allocated()
    base_ptrs = {t.untyped_storage().data_ptr() for t in
                 list(params["layers"].values())
                 + [v for k, v in params.items() if k != "layers"]}
    waves = _waves(cfg, seed)
    prompts = waves[0] + waves[1]
    deltas = _mux_deltas(cfg)
    sizes = {"m0": models.params_bytes(params)}
    sizes.update({m: _variant_bytes(cfg, d) for m, d in deltas.items()})
    budget = sizes["m0"] + sizes["v1"]
    bases = {m: "m0" for m in deltas}
    t0 = time.perf_counter()
    dep = MultiplexedLLMDeployment(
        _mux_spec(cfg, deltas, params=params), budget_bytes=budget,
        max_slots=8, max_len=512, block_size=16, seed=seed, device=device)
    register_s = time.perf_counter() - t0
    snap = dep.registry.snapshot()
    if {m: r["bytes"] for m, r in snap.items()} != sizes:
        raise AssertionError(f"registry bytes {snap} against {sizes}")
    # time each materialisation (the weights' move, apply_delta)
    reg = dep.registry
    materialize, swap_s = reg._materialize, []

    def timed(e):
        t = time.perf_counter()
        out = materialize(e)
        torch.cuda.synchronize()
        swap_s.append(("variant" if e["base"] else "base",
                       time.perf_counter() - t))
        return out
    reg._materialize = timed
    step_row = "serve::decode_step_paged"
    ops, per_swap, seq_tokens = [], {}, {}
    for n, mid in enumerate(MUX_ORDER):
        for i, p in enumerate(prompts[:MUX_SEQ_PROMPTS]):
            c0 = _captures_so_far(step_row)
            k0 = len(swap_s)
            stamps = []
            seq_tokens[(n, mid, i)] = _mux_stream(dep, mid, p, stamps)
            ops += _request_ops(mid)
            c1 = _captures_so_far(step_row)
            if len(swap_s) > k0:
                per_swap[f"{n}:{mid}"] = dict(
                    first_token_s=stamps[0][1][0] - stamps[0][0],
                    materialize_s=[s for _, s in swap_s[k0:]],
                    captures=c1[0] - c0[0], capture_s=c1[1] - c0[1])
    want, _, _ = _lru_swaps(ops, sizes, budget, bases)
    snap = reg.snapshot()
    got = {m: [r["swaps_in"], r["swaps_out"]] for m, r in snap.items()}
    print(f"[multiplex] order {list(MUX_ORDER)} ({MUX_SEQ_PROMPTS} requests "
          f"each, one at a time): swaps in/out expected {json.dumps(want)}, "
          f"observed {json.dumps(got)}", flush=True)
    if got != want:
        raise AssertionError(f"multiplex swaps {got}, budget predicts {want}")
    # v1 and v2 pinned by streams in flight: z must shed
    open_streams = {m: dep(prompts[0], NEW_TOKENS, model_id=m)
                    for m in ("v1", "v2")}
    ops += [("pin", "v1"), ("ensure", "v1"), ("pin", "v2"), ("ensure", "v2")]
    for g in open_streams.values():
        next(g)
    shed = None
    try:
        dep(prompts[1], NEW_TOKENS, model_id="z")
    except RequestShedError as e:
        shed = e.reason
    ops += [("pin", "z"), ("ensure", "z"), ("unpin", "z")]
    for g in open_streams.values():
        list(g)
    ops += [("unpin", "v1"), ("unpin", "v2")]
    _, want_sheds, _ = _lru_swaps(ops, sizes, budget, bases)
    if shed != "model_budget" or want_sheds != ["z"]:
        raise AssertionError(f"z with v1 and v2 pinned: shed {shed!r} "
                             f"(predicted sheds {want_sheds})")
    # the 8 requests at once, a model at a time
    work, timing = {}, {}
    for mid in ("z", "m0", "v1", "v2"):
        c0 = _captures_so_far(step_row)
        k0 = len(swap_s)
        work[mid], timing[mid] = _mux_workload(dep, mid, prompts)
        ops += _request_ops(mid)
        c1 = _captures_so_far(step_row)
        if len(swap_s) > k0:
            per_swap[f"work:{mid}"] = dict(
                first_token_s=timing[mid]["first_token_s"],
                materialize_s=[s for _, s in swap_s[k0:]],
                captures=c1[0] - c0[0], capture_s=c1[1] - c0[1])
    reg._materialize = materialize
    # the originals hold the registry (and through it every engine)
    del materialize, timed
    want, _, _ = _lru_swaps(ops, sizes, budget, bases)
    snap = reg.snapshot()
    got = {m: [r["swaps_in"], r["swaps_out"]] for m, r in snap.items()}
    if got != want:
        raise AssertionError(f"multiplex swaps {got}, budget predicts {want}")
    # the card after the last swap
    _settle_memory()
    held = _mux_held_bytes(dep, base_ptrs)
    alloc = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    predicted = base_alloc + held["models"] + held["kv"] + held["graphs"]
    resident = reg.resident_bytes()
    # each variant against a plain engine on its materialised weights
    exact, agree = {}, {}
    if work["z"] != work["m0"]:
        raise AssertionError("multiplex: z (scale 0) differs from m0")
    for mid in ("v1", "v2"):
        var = models.apply_delta(params, {
            "scale": deltas[mid]["scale"],
            "targets": {k: {n: t.to(device) for n, t in f.items()}
                        for k, f in deltas[mid]["targets"].items()}})
        plain = _plain_tokens(cfg, var, prompts, device)
        exact[mid] = plain == work[mid]
        agree[mid] = _check_greedy(
            f"multiplex {mid} bf16", *_greedy_vs_forward(
                var, cfg, [(p, t + [None]) for p, t in zip(prompts,
                                                           work[mid])],
                device), BF16_AGREE_MIN, BF16_GAP_TOL)
        del var
        _settle_memory()
    moved = {m: sum(a != b for a, b in zip(work[m], work["m0"]))
             for m in ("v1", "v2")}
    rec = dict(register_s=register_s, budget_bytes=budget, sizes=sizes,
               swaps=got, per_swap=per_swap,
               swap_in_to_first_token_s=dict(
                   base=per_swap.get("0:m0", {}).get("first_token_s"),
                   variant=per_swap.get("1:v1", {}).get("first_token_s")),
               materialize_s=swap_s, resident_bytes=resident,
               held=held, allocated=alloc, predicted=predicted,
               reserved=reserved,
               allocated_minus_predicted=alloc - predicted,
               timing=timing, exact_vs_plain=exact,
               requests_differing_from_m0=moved, agree=agree, shed=shed)
    print(f"[multiplex] llama3_8b {cfg.n_layers} layers bf16, 4 models "
          f"(base + 3 rank-{MUX_RANK} deltas over {list(MUX_TARGETS)}): "
          f"{json.dumps(rec, default=str)} on {card}", flush=True)
    print(f"[multiplex] swap-in to first token: base "
          f"{rec['swap_in_to_first_token_s']['base']:.2f} s, variant "
          f"{rec['swap_in_to_first_token_s']['variant']:.2f} s; "
          f"TTFT / TPOT p50 ms "
          + ", ".join(f"{m} {t['ttft_p50_ms']:.1f} / {t['tpot_p50_ms']:.2f}"
                      for m, t in timing.items())
          + f"; allocated {alloc / 2**30:.3f} GiB against predicted "
          f"{predicted / 2**30:.3f} GiB", flush=True)
    if not all(exact.values()):
        raise AssertionError(f"multiplex variants differ from a plain "
                             f"engine on their weights: {exact}")
    if not all(moved.values()):
        raise AssertionError(f"a variant's tokens equal the base's: {moved}")
    if abs(alloc - predicted) > MUX_MEMORY_TOL:
        raise AssertionError(f"multiplex: {alloc} bytes allocated after the "
                             f"last swap, {predicted} held ({held})")
    dep.close()
    del dep, reg
    _settle_memory()
    after_close = torch.cuda.memory_allocated()
    print(f"[multiplex] after close: allocated {after_close} bytes, "
          f"{after_close - base_alloc} over the phase's start", flush=True)
    if abs(after_close - base_alloc) > MUX_MEMORY_TOL:
        raise AssertionError(f"multiplex: close left {after_close - base_alloc}"
                             " bytes on the card")
    torch.cuda.empty_cache()
    return dict(tokens=seq_tokens, budget=budget, rec=rec)


# A worker sees the card only where it opts in: beside num_gpus=1 it sets
# CUDA_VISIBLE_DEVICES itself (the runtime gives every worker an empty one)
ON_CARD = {"num_gpus": 1,
           "runtime_env": {"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}}}
SERVE_DEPLOYMENT = "llama3_8b"


class ForwardOnCard:
    """A worker actor (half the GPU resource and the opt-in) that repeats
    the forward phase's llama3_8b forward in its own process, through
    kernel 1 built from this checkout: returns what the driver's forward is
    held to bitwise (the last position's logits leave the card as a CUDA
    tensor and come back through the object store on the CPU). It keeps
    the weights and tokens: ``last_logits`` is stage A of the compiled
    phase's DAG."""

    def run(self, name, b, l, seed):
        # imported here: the class travels by value, and a global ``torch``
        # with its backends modules in the code would go with it
        import torch

        before = torch.cuda.is_initialized()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg, params, toks, logits, first_s, launches = _forward_logits(
            name, b, l, seed)
        self.cfg, self.params, self.toks = cfg, params, toks
        with torch.inference_mode():
            sha, last = _sha256(logits), logits[:, -1].clone()
        return dict(sha256=sha, last=last, launches=launches,
                    n_layers=cfg.n_layers, first_s=first_s,
                    cuda_initialized_before=before,
                    device=torch.cuda.get_device_name(0),
                    pid=os.getpid())

    def last_logits(self, _invocation):
        """The same forward again; its last position's logits (f32) as a
        CUDA tensor, for a tensor edge."""
        import torch

        with torch.inference_mode():
            logits, _ = models.forward(self.params, self.toks, self.cfg)
            return logits[:, -1].clone()


class RelayOnCard:
    """Stage B of the compiled phase's DAG: an actor with a fraction of the
    GPU resource that takes stage A's logits on the card (the exec loop
    moves a tensor-edge input there) and returns them, with their argmax,
    on a tensor edge to the driver."""

    def relay(self, logits):
        from ray_tpu_torch.experimental.device_channel import TensorWithMeta

        return TensorWithMeta({"device": logits.device.type,
                               "argmax": logits.argmax(-1).tolist()}, logits)


def _score(cfg, params, prompt_tokens, device="cuda"):
    """``models.forward`` on one prompt ([1, len]): the last position's
    top-5 ids and logits as lists, the forward's ms and its kernel-1
    launches (the compiled deployment's answer, and what it is held to)."""
    toks = torch.tensor([prompt_tokens], device=device)
    with torch.inference_mode():
        before = flash_cuda.launches
        t0 = time.perf_counter()
        logits, _ = models.forward(params, toks, cfg)
        top = torch.topk(logits[0, -1].float(), 5)
        ids, vals = top.indices.tolist(), top.values.tolist()
        ms = (time.perf_counter() - t0) * 1e3
    return dict(ids=ids, logits=vals, forward_ms=ms,
                launches=flash_cuda.launches - before)


class ScoreOnCard:
    """A user deployment (``compiled=True``, one replica on the card):
    llama3_8b at full width and depth, bf16 weights drawn on the replica
    from the seed, scoring a prompt per request."""

    def __init__(self, model="llama3-8b", seed=0):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.params, _ = _bf16_weights(model, seed)

    def __call__(self, prompt_tokens):
        return _score(self.cfg, self.params, prompt_tokens)

    def describe(self):
        return None


# deployed by ``config_api.deploy_config(COMPILED_CONFIG)``, which imports
# this module by name (workers import it from the checkout too); the
# config's override raises max_ongoing_requests, and so the DAG's
# max_in_flight, from 2 to 8
COMPILED_DEPLOYMENT = "llama3_8b_compiled"
SCORE_APP = serve.deployment(
    ScoreOnCard, name=COMPILED_DEPLOYMENT, compiled=True,
    max_ongoing_requests=2,
    ray_actor_options=dict(ON_CARD, num_cpus=0)).bind(seed=0)
COMPILED_CONFIG = {"applications": [{
    "name": COMPILED_DEPLOYMENT, "import_path": "chip_smoke:SCORE_APP",
    "route_prefix": "/score",
    "deployments": [{"name": COMPILED_DEPLOYMENT,
                     "max_ongoing_requests": 8}]}]}
# stage A keeps half the GPU resource so stage B fits beside it
FORWARD_ON_CARD = dict(ON_CARD, num_gpus=0.5, max_concurrency=2)
RELAY_ON_CARD = dict(ON_CARD, num_gpus=0.25, max_concurrency=2)
NOOP_CALLS = 200


def _stream_stats(stamps, n_tokens):
    """TTFT / TPOT p50 (ms) and tokens/s from each stream's submit time and
    its tokens' arrival times."""
    ttft = [ts[0] - t0 for t0, ts in stamps]
    tpot = [b - a for _, ts in stamps for a, b in zip(ts, ts[1:])]
    wall = max(ts[-1] for _, ts in stamps) - min(t0 for t0, _ in stamps)
    return dict(ttft_p50_ms=float(np.median(ttft)) * 1e3,
                tpot_p50_ms=float(np.median(tpot)) * 1e3,
                tokens_per_s=n_tokens / wall)


def _http_stream(port, route, prompt, new_tokens):
    """One ``?stream=1`` request to the proxy: the tokens and their arrival
    times (one JSON line per token, read as it comes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", f"/{route}?stream=1", body=json.dumps(
            {"prompt_tokens": prompt, "max_new_tokens": new_tokens}))
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"proxy answered {resp.status}: "
                                 f"{resp.read()[:200]!r}")
        toks, ts = [], []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.strip():
                ts.append(time.perf_counter())
                toks.append(json.loads(line)["result"])
        return toks, ts
    finally:
        conn.close()


def _card_memory_used_mib():
    """The card's used memory as ``nvidia-smi`` reads it (no CUDA context
    in this process)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return int(out.split()[0])


def _mux_store_plan(budget):
    """Size the object store for the multiplexed replica's host weights
    (the base's 16 GB copy is ``put`` by its registry) when ``/dev/shm``
    has room for it; otherwise leave the store at its default and let the
    put spill to disk. Returns what was chosen, set before ``init()``."""
    need = budget + (2 << 30)
    free = shutil.disk_usage("/dev/shm").free
    if free >= need + (4 << 30):
        os.environ["RTPU_STORE_CAPACITY"] = str(need)
        return dict(store="sized", capacity=need, dev_shm_free=free)
    return dict(store="spill", capacity=None, dev_shm_free=free,
                spill_dir_free=shutil.disk_usage(tempfile.gettempdir()).free)


def _mux_through_framework(cfg, prompts, budget, seed, used_before_mib):
    """The multiplex phase's order through the framework: once the first
    app's replica has left the card, ``MultiplexedLLMDeployment`` on a
    ``num_gpus=1`` replica whose base weights it draws from the seed (the
    variants' factors travel from here, drawn from their seeds as this
    process's were), the requests one at a time through
    ``handle.options(model_id=...)``, then the replica's load report and
    registry snapshot."""
    from ray_tpu_torch.serve import MultiplexedLLMDeployment
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + 120
    used = _card_memory_used_mib()
    while used > used_before_mib + 512 and time.monotonic() < deadline:
        time.sleep(1.0)
        used = _card_memory_used_mib()
    if used > used_before_mib + 512:
        raise AssertionError(f"the first replica still holds the card: "
                             f"{used} MiB used, {used_before_mib} before")
    name = SERVE_DEPLOYMENT + "_mux"
    opts = dict(ON_CARD, max_concurrency=32, num_cpus=0)
    t0 = time.perf_counter()
    handle = serve.run(serve.deployment(
        MultiplexedLLMDeployment, name=name, ray_actor_options=opts).bind(
            _mux_spec(cfg, _mux_deltas(cfg), seed=seed), budget_bytes=budget,
            max_slots=8, max_len=512, block_size=16, seed=seed), name=name)
    out = dict(deploy_s=time.perf_counter() - t0, tokens={}, first_s={})
    for n, mid in enumerate(MUX_ORDER):
        for i, p in enumerate(prompts[:MUX_SEQ_PROMPTS]):
            t = time.perf_counter()
            toks = []
            for tok in handle.options(stream=True, model_id=mid).remote(
                    p, NEW_TOKENS):
                if not toks:
                    out["first_s"][f"{n}:{mid}:{i}"] = time.perf_counter() - t
                toks.append(tok)
            out["tokens"][(n, mid, i)] = toks
    out["deploy_to_first_answer_s"] = time.perf_counter() - t0
    plain = serve.get_deployment_handle(name)
    out["load_state"] = plain.options(method_name="load_state",
                                      stream=False).remote().result()
    out["registry"] = plain.options(method_name="stats",
                                    stream=False).remote().result()["models"]
    out["store_report"] = state.store_report()
    serve.shutdown()
    return out


def _pcts(xs, scale=1e3):
    """p50 / p90 of a list of seconds, in ms."""
    return dict(p50=float(np.percentile(xs, 50)) * scale,
                p90=float(np.percentile(xs, 90)) * scale, n=len(xs))


def _overhead(rtts, answers):
    """p50 / p90 ms of what a round trip adds to the replica's forward."""
    return _pcts([t - a["forward_ms"] / 1e3 for t, a in zip(rtts, answers)])


def _dag_executions():
    from ray_tpu_torch.util import metric_defs

    return sum(v for _, v in metric_defs.get(
        "rtpu_dag_executions_total")._samples())


def _post_json(port, route, body):
    """One non-stream POST to the proxy: its decoded ``result``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", f"/{route}", body=json.dumps(body))
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            raise AssertionError(f"proxy answered {resp.status}: "
                                 f"{raw[:200]!r}")
        return json.loads(raw)["result"]
    finally:
        conn.close()


def _compiled_through_framework(cfg, prompts, fwd_actor):
    """The compiled execution plane on the card, from the card-free driver.

    First a compiled DAG with tensor edges: stage A is ``fwd_actor`` (the
    ``ForwardOnCard`` actor, its weights kept from the forward check),
    returning the last position's logits as a CUDA tensor; stage B a
    ``RelayOnCard`` actor beside it, taking them on the card and returning
    them with their argmax. 4 invocations at ``max_in_flight=2``, their
    futures taken out of order; teardown, then no channel of the session
    may be left. Both actors then leave the card (the GPU resource is one
    card): ``ScoreOnCard`` deployed through ``config_api.deploy_config``
    (``compiled=True``, one replica, the config raising
    ``max_ongoing_requests`` to 8) answers the 8 prompts one at a time
    through the handle and then through the HTTP proxy's non-stream POST
    (both on the compiled plane), 16 callers at once through the handle,
    and ``NOOP_CALLS`` no-op ``describe()`` calls. Returns every answer and
    the round trips; the checking process holds the answers."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.serve import config_api
    from ray_tpu_torch.serve.handle import CompiledDeploymentResponse

    session = ray_tpu_torch.core.runtime._get_runtime().session
    out = dict(executions_before=_dag_executions())
    relay = ray_tpu_torch.remote(RelayOnCard).options(
        **RELAY_ON_CARD).remote()
    with InputNode() as inp:
        stage_a = fwd_actor.last_logits.bind(inp).with_tensor_transport()
        node = relay.relay.bind(stage_a).with_tensor_transport()
    payload = 2 * cfg.vocab_size * 4          # [2, vocab] f32 logits
    t0 = time.perf_counter()
    dag = node.experimental_compile(max_in_flight=2,
                                    buffer_size_bytes=payload + (64 << 10))
    edge, order = {}, []
    try:
        futs = [dag.execute(i, timeout=300) for i in range(2)]
        for i in (1, 0):
            edge[i] = futs[i].get(timeout=300)
            order.append(i)
        futs += [dag.execute(i, timeout=300) for i in range(2, 4)]
        for i in (3, 2):
            edge[i] = futs[i].get(timeout=300)
            order.append(i)
        out["edge_first_wave_s"] = time.perf_counter() - t0
        # steady state: one invocation at a time, each its round trip
        rtt = []
        for i in range(4, 8):
            t = time.perf_counter()
            edge[i] = dag.execute(i, timeout=300).get(timeout=300)
            rtt.append(time.perf_counter() - t)
        out["edge_rtt"] = _pcts(rtt)
    finally:
        dag.teardown()
    out["edge"] = {i: dict(tensor=r.tensor, **r.meta)
                   for i, r in edge.items()}
    out["edge_order"] = order
    out["edge_channels_left"] = glob.glob(f"/dev/shm/rtpu-chan-{session}-*")
    out["cuda_after_edge"] = torch.cuda.is_initialized()
    ray_tpu_torch.kill(relay)
    ray_tpu_torch.kill(fwd_actor)

    t0 = time.perf_counter()
    out["deployed"] = config_api.deploy_config(COMPILED_CONFIG)
    out["deploy_s"] = time.perf_counter() - t0
    handle = serve.get_deployment_handle(COMPILED_DEPLOYMENT)
    seq, rtt = [], []
    for p in prompts:
        t = time.perf_counter()
        resp = handle.remote(p)
        if not isinstance(resp, CompiledDeploymentResponse):
            raise AssertionError(f"the handle did not ride the compiled "
                                 f"plane: {type(resp).__name__}")
        seq.append(resp.result(timeout_s=600))
        rtt.append(time.perf_counter() - t)
        if len(seq) == 1:
            out["deploy_to_first_answer_s"] = time.perf_counter() - t0
    # the first answer waits for the replica's weights and starts its DAG
    out["first_answer_s"] = rtt[0]
    out["handle"], out["handle_rtt"] = seq, _pcts(rtt[1:])
    out["handle_overhead"] = _overhead(rtt[1:], seq[1:])
    out["dags"] = {dep: dict(max_in_flight=d._max_in_flight,
                             channels=len(d._channels))
                   for dep, d in handle._dags.values()}
    proxy = serve.start_http_proxy(port=0)
    before, http_res, rtt = _dag_executions(), [], []
    for p in prompts:
        t = time.perf_counter()
        http_res.append(_post_json(proxy.port, "score", p))
        rtt.append(time.perf_counter() - t)
    out["http"], out["http_rtt"] = http_res, _pcts(rtt)
    out["http_overhead"] = _overhead(rtt, http_res)
    out["http_executions"] = _dag_executions() - before
    proxy.stop()
    many, stamps, errors = [None] * (2 * len(prompts)), [None] * (
        2 * len(prompts)), []

    def call(i):
        try:
            t = time.perf_counter()
            many[i] = handle.remote(prompts[i % len(prompts)]).result(
                timeout_s=600)
            stamps[i] = time.perf_counter() - t
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(many))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    out["concurrent_wall_s"] = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent compiled calls failed: "
                             f"{errors[:3]}")
    out["concurrent"], out["concurrent_rtt"] = many, _pcts(stamps)
    rtt = []
    for _ in range(NOOP_CALLS):
        t = time.perf_counter()
        if handle.describe.remote().result(timeout_s=60) is not None:
            raise AssertionError("describe() answered something")
        rtt.append(time.perf_counter() - t)
    out["noop_rtt"] = _pcts(rtt)
    out["executions"] = _dag_executions() - out["executions_before"]
    serve.shutdown()
    # the next phase's serve.run must find no controller on its way out
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        except ValueError:
            break
        time.sleep(0.2)
    out["channels_left"] = glob.glob(f"/dev/shm/rtpu-chan-{session}-*")
    out["cuda_after"] = torch.cuda.is_initialized()
    return out


def serve_runtime_driver(out_path, seed=0, mux_budget=None):
    """The driver of the runtime phase, in a process of its own that never
    touches the card: ``ray_tpu_torch.init()``, ``LLMDeployment`` on a
    replica on the card (llama3_8b at full width and depth, bf16 weights
    drawn there from the seed, paged), the 8 requests one at a time, then
    both waves concurrently through the handle and the HTTP proxy's
    ``?stream=1``; then a ``ForwardOnCard`` actor; then, with
    ``mux_budget``, the multiplex phase's requests through a multiplexed
    replica (``_mux_through_framework``; the store sized for its host
    weights where ``/dev/shm`` can hold them). Writes what it saw to
    ``out_path`` (``torch.save``) for the checking process."""
    import ray_tpu_torch
    from ray_tpu_torch import _native
    from ray_tpu_torch.serve import LLMDeployment
    from ray_tpu_torch.util import state

    store_plan = _mux_store_plan(mux_budget) if mux_budget else None
    used_before_mib = _card_memory_used_mib()
    native = _native.native_status()
    print(f"[serve runtime] native: {json.dumps(native)}", flush=True)
    if not (native["store"] and native["pipe"]):
        raise AssertionError(f"the object store is not native: {native}")
    t0 = time.perf_counter()
    ray_tpu_torch.init()
    init_s = time.perf_counter() - t0
    res = ray_tpu_torch.available_resources()
    out = dict(init_s=init_s, resources=res,
               cuda_after_init=torch.cuda.is_initialized())
    if out["cuda_after_init"] or res.get("GPU", 0) < 1:
        raise AssertionError(f"init: CUDA initialised in the driver "
                             f"{out['cuda_after_init']}, resources {res}")

    @ray_tpu_torch.remote
    def card_seen_without_opt_in():
        return (torch.cuda.is_available(), torch.cuda.is_initialized(),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    out["plain_worker"] = ray_tpu_torch.get(card_seen_without_opt_in.remote())
    cfg = models.get_config("llama3-8b").replace(param_dtype="bfloat16")
    waves = _waves(cfg, seed)
    prompts = waves[0] + waves[1]
    opts = dict(ON_CARD, max_concurrency=32, num_cpus=0)
    t0 = time.perf_counter()
    handle = serve.run(serve.deployment(
        LLMDeployment, name=SERVE_DEPLOYMENT, ray_actor_options=opts).bind(
            cfg, max_slots=8, max_len=512, block_size=16, seed=seed),
        name=SERVE_DEPLOYMENT)
    # one at a time: the replica's engine sees the requests in the order
    # the checking process's in-process engine will
    out["sequential"] = []
    for i, p in enumerate(prompts):
        out["sequential"].append(list(handle.options(stream=True).remote(
            p, NEW_TOKENS)))
        if i == 0:
            out["first_request_s"] = time.perf_counter() - t0
    # both waves, concurrently, through the handle and through HTTP
    proxy = serve.start_http_proxy(port=0)
    results = {"handle": [None] * len(prompts), "http": [None] * len(prompts)}
    stamps = {"handle": [None] * len(prompts), "http": [None] * len(prompts)}
    errors = []

    def via_handle(i):
        try:
            t_sub, toks, ts = time.perf_counter(), [], []
            for tok in handle.options(stream=True).remote(prompts[i],
                                                          NEW_TOKENS):
                ts.append(time.perf_counter())
                toks.append(tok)
            results["handle"][i], stamps["handle"][i] = toks, (t_sub, ts)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    def via_http(i):
        try:
            t_sub = time.perf_counter()
            toks, ts = _http_stream(proxy.port, SERVE_DEPLOYMENT, prompts[i],
                                    NEW_TOKENS)
            results["http"][i], stamps["http"][i] = toks, (t_sub, ts)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=fn, args=(i,))
               for i in range(len(prompts)) for fn in (via_handle, via_http)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    out["concurrent_wall_s"] = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"concurrent streams failed: {errors[:3]}")
    out["concurrent"] = results
    for route in ("handle", "http"):
        out[f"{route}_timing"] = _stream_stats(stamps[route],
                                               NEW_TOKENS * len(prompts))
    out["all_timing"] = _stream_stats(stamps["handle"] + stamps["http"],
                                      NEW_TOKENS * 2 * len(prompts))
    out["stats"] = handle.options(method_name="stats",
                                  stream=False).remote().result()
    # the device plane's receiver side: the replica's registry snapshot,
    # pushed to this driver's DeviceStore on the worker's idle ticks
    deadline = time.monotonic() + 30
    report = state.device_report()
    while (not any(r.get("program") == "serve::decode_step_paged"
                   for r in report["programs"])
           and time.monotonic() < deadline):
        time.sleep(1.0)
        report = state.device_report()
    out["device_report"] = dict(
        totals=report["totals"],
        programs=sorted({r.get("program") for r in report["programs"]}),
        processes=[{k: p[k] for k in ("component", "pid", "programs",
                                      "hbm") if k in p}
                   for p in report["processes"]])
    proxy.stop()
    serve.shutdown()
    actor = ray_tpu_torch.remote(ForwardOnCard).options(
        **FORWARD_ON_CARD).remote()
    out["forward"] = ray_tpu_torch.get(actor.run.remote("llama3-8b", 2, 2048,
                                                        seed))
    # a view of the store, which shutdown unmaps
    out["forward"]["last"] = out["forward"]["last"].clone()
    t0 = time.perf_counter()
    out["compiled"] = _compiled_through_framework(cfg, prompts, actor)
    print(f"[phase] llama3_8b compiled (runtime): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if mux_budget:
        out["multiplex"] = _mux_through_framework(
            cfg, prompts, mux_budget, seed, used_before_mib)
        out["multiplex"]["store_plan"] = store_plan
    out["cuda_at_end"] = torch.cuda.is_initialized()
    ray_tpu_torch.shutdown()
    torch.save(out, out_path)


def phase_serve_runtime(cfg, params, card, fwd_ref, inproc, mux=None,
                        seed=0, device="cuda"):
    """Serve through the framework: a driver process that never touches
    the card (``serve_runtime_driver``) deploys ``LLMDeployment`` on a
    replica on the card and streams the 8 requests through it. Held here:
    its one-at-a-time tokens equal this process's ``LLMEngine`` on the
    same weights, prompts, order and settings, token for token; every
    concurrent stream (handle and HTTP) ends with its token count and
    meets the bf16 bar against the kernel-backed forward; the worker
    actor's forward equals this process's (``fwd_ref``) bitwise, through
    kernel 1; neither ``init()`` nor a worker that did not opt in
    initialised CUDA. Prints TTFT / TPOT p50 and tokens/s through the
    replica beside this process's engine under the same load
    (``inproc``: the serving phase's captured engine, and the same 16
    concurrent requests here). With ``mux`` (the multiplex phase's
    result), the driver also runs the multiplex phase's order through a
    multiplexed replica: its tokens must equal this process's, request for
    request, and its load report must show the residency and swaps the
    budget predicts."""
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    out_path = os.path.join(tmp, "serve_runtime.pt")
    argv = [sys.executable, os.path.abspath(__file__),
            "--serve-runtime-driver", out_path]
    if mux is not None:
        argv.append(str(mux["budget"]))
    try:
        subprocess.run(argv, check=True, timeout=900)
        got = torch.load(out_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    waves = _waves(cfg, seed)
    prompts = waves[0] + waves[1]
    kw = dict(max_slots=8, max_len=512, block_size=16, device=device)
    # this process's engine, the requests one at a time in the same order
    eng = LLMEngine(cfg, params, **kw)
    sequential = []
    for p in prompts:
        sink = []
        eng.submit(p, NEW_TOKENS, sink.append)
        while eng.step():
            pass
        sequential.append(sink[:-1])
    if got["sequential"] != sequential:
        bad = [i for i, (a, b) in enumerate(zip(got["sequential"],
                                                sequential)) if a != b]
        raise AssertionError(f"serve runtime: requests {bad} through the "
                             "replica differ from the in-process engine")
    # the same 16 concurrent requests on this engine, whose prefix cache
    # now holds what the replica's did (timing)
    stamps = []
    for p in prompts * 2:
        ts = []
        stamps.append((time.perf_counter(), ts))
        eng.submit(p, NEW_TOKENS,
                   lambda x, ts=ts: ts.append(time.perf_counter())
                   if x is not None else None)
    while eng.step():
        pass
    local = _stream_stats(stamps, NEW_TOKENS * 2 * len(prompts))
    # the engines' own TTFT / TPOT, from their emit times (admission's
    # window): the replica's minus these is what the trip to the caller adds
    local_engine = eng.kv_state()["admission"]
    del eng
    torch.cuda.empty_cache()
    agree = {}
    for route in ("handle", "http"):
        streams = got["concurrent"][route]
        if any(len(t) != NEW_TOKENS for t in streams):
            raise AssertionError(f"serve runtime {route}: stream lengths "
                                 f"{[len(t) for t in streams]}")
        agree[route] = _check_greedy(
            f"serve runtime {route} bf16",
            *_greedy_vs_forward(params, cfg, [(p, t + [None]) for p, t in
                                              zip(prompts, streams)], device),
            BF16_AGREE_MIN, BF16_GAP_TOL)
    fwd = got["forward"]
    bitwise = (fwd["sha256"] == fwd_ref["sha256"]
               and torch.equal(fwd["last"].view(torch.int16),
                               fwd_ref["last"].view(torch.int16)))
    st = got["stats"]
    rec = dict(
        init_s=got["init_s"], first_request_s=got["first_request_s"],
        concurrent_wall_s=got["concurrent_wall_s"],
        replica_all=got["all_timing"], replica_handle=got["handle_timing"],
        replica_http=got["http_timing"], in_process_same_load=local,
        in_process_serving_phase=dict(
            ttft_p50_ms=inproc["ttft_p50_ms"],
            tpot_p50_ms=inproc["tpot_p50_ms"],
            tokens_per_s=inproc["tokens_per_s"]),
        replica_stats={k: st.get(k) for k in (
            "steps", "tokens_generated", "max_concurrent", "requests",
            "prefix_hit_tokens", "flops_per_s", "kv_free", "kv_total")},
        engine_side={k: dict(ttft_p50_ms=a["ttft_p50_s"] * 1e3,
                             tpot_p50_ms=a["tpot_p50_s"] * 1e3)
                     for k, a in (("replica", st["admission"]),
                                  ("in_process", local_engine))},
        prefix=st.get("prefix"), agree=agree,
        forward=dict(bitwise=bitwise, launches=fwd["launches"],
                     first_s=fwd["first_s"], device=fwd["device"],
                     last_on=fwd["last"].device.type,
                     cuda_initialized_before=fwd["cuda_initialized_before"]),
        device_report=got["device_report"],
        cuda_in_driver=[got["cuda_after_init"], got["cuda_at_end"]],
        plain_worker=got["plain_worker"])
    # the printed record leaves the tokens out; the disaggregated phase is
    # held to them
    out_rec = dict(rec, sequential=sequential)
    print(f"[serve runtime] llama3_8b {cfg.n_layers} layers bf16 through "
          f"LLMDeployment on a replica: {len(prompts)} requests one at a "
          f"time token-exact against the in-process engine; "
          f"{json.dumps(rec, default=str)}", flush=True)
    print(f"[serve runtime] TTFT p50 / TPOT p50 / tokens/s, 16 concurrent "
          f"streams: replica {rec['replica_all']['ttft_p50_ms']:.1f} / "
          f"{rec['replica_all']['tpot_p50_ms']:.2f} / "
          f"{rec['replica_all']['tokens_per_s']:.0f} (handle "
          f"{rec['replica_handle']['ttft_p50_ms']:.1f} / "
          f"{rec['replica_handle']['tpot_p50_ms']:.2f} / "
          f"{rec['replica_handle']['tokens_per_s']:.0f}; HTTP "
          f"{rec['replica_http']['ttft_p50_ms']:.1f} / "
          f"{rec['replica_http']['tpot_p50_ms']:.2f} / "
          f"{rec['replica_http']['tokens_per_s']:.0f}); in-process "
          f"{local['ttft_p50_ms']:.1f} / {local['tpot_p50_ms']:.2f} / "
          f"{local['tokens_per_s']:.0f} (serving phase, 8 requests: "
          f"{inproc['ttft_p50_ms']:.1f} / {inproc['tpot_p50_ms']:.2f} / "
          f"{inproc['tokens_per_s']:.0f}) on {card}", flush=True)
    if any(rec["cuda_in_driver"]) or got["plain_worker"][:2] != (False,
                                                                 False):
        raise AssertionError(f"CUDA initialised where it must not be: "
                             f"driver {rec['cuda_in_driver']}, plain worker "
                             f"{got['plain_worker']}")
    if not bitwise or fwd["launches"] != fwd["n_layers"]:
        raise AssertionError(f"worker actor forward: bitwise {bitwise}, "
                             f"kernel launches {fwd['launches']} of "
                             f"{fwd['n_layers']}")
    if fwd["last"].device.type != "cpu" or fwd["cuda_initialized_before"]:
        raise AssertionError("a CUDA tensor came back off the CPU, or the "
                             "actor had CUDA before its forward")
    if st["kv_free"] + st["prefix"]["nodes"] != st["kv_total"]:
        raise AssertionError(f"replica leaked KV blocks: {st}")
    if "serve::decode_step_paged" not in rec["device_report"]["programs"]:
        raise AssertionError("the replica's device-plane snapshot never "
                             f"reached the driver: {rec['device_report']}")
    out_rec["compiled"] = _check_compiled(cfg, params, got["compiled"],
                                          fwd_ref, prompts, card)
    if mux is not None:
        out_rec["multiplex"] = _check_mux_replica(cfg, got["multiplex"], mux,
                                                  card)
    return out_rec


def _check_compiled(cfg, params, got, fwd_ref, prompts, card):
    """The compiled phase's answers against this process: every
    ``ScoreOnCard`` answer (handle, HTTP, concurrent) bitwise this
    process's ``_score`` on the same weights and prompt, through kernel 1
    in every request; every tensor-edge result bitwise ``fwd_ref["last"]``
    with the argmax taken on the card; the driver's CUDA never initialised;
    no channel of the session left."""
    want = [_score(cfg, params, p) for p in prompts]
    keys = ("ids", "logits")

    def same(a, b):
        return all(a[k] == b[k] for k in keys)

    routes = {"handle": got["handle"], "http": got["http"],
              "concurrent": got["concurrent"]}
    bad = {route: [i for i, r in enumerate(res)
                   if not same(r, want[i % len(want)])]
           for route, res in routes.items()}
    launches = sorted({r["launches"] for res in routes.values() for r in res})
    replica_ms = [r["forward_ms"] for res in routes.values() for r in res]
    argmax = fwd_ref["last"].cuda().argmax(-1).tolist()
    edge_bad = [i for i, r in got["edge"].items()
                if not (torch.equal(r["tensor"].view(torch.int16),
                                    fwd_ref["last"].view(torch.int16))
                        and r["device"] == "cuda" and r["argmax"] == argmax)]
    rec = dict(
        deploy_s=got["deploy_s"], first_answer_s=got["first_answer_s"],
        deploy_to_first_answer_s=got["deploy_to_first_answer_s"],
        dags=got["dags"],
        handle_rtt_ms=got["handle_rtt"], http_rtt_ms=got["http_rtt"],
        handle_overhead_ms=got["handle_overhead"],
        http_overhead_ms=got["http_overhead"],
        concurrent_rtt_ms=got["concurrent_rtt"],
        concurrent_wall_s=got["concurrent_wall_s"],
        replica_forward_ms=_pcts(np.asarray(replica_ms) / 1e3),
        in_process_forward_ms=_pcts(np.asarray(
            [w["forward_ms"] for w in want]) / 1e3),
        noop_rtt_ms=got["noop_rtt"], executions=got["executions"],
        http_executions=got["http_executions"],
        edge_rtt_ms=got["edge_rtt"], edge_first_wave_s=got["edge_first_wave_s"],
        edge_order=got["edge_order"], launches=launches,
        mismatched=bad, edge_mismatched=edge_bad,
        cuda_in_driver=[got["cuda_after_edge"], got["cuda_after"]],
        channels_left=got["edge_channels_left"] + got["channels_left"])
    print(f"[compiled runtime] llama3_8b {cfg.n_layers} layers bf16, "
          f"ScoreOnCard (compiled=True) and a tensor-edge DAG: "
          f"{json.dumps(rec, default=str)} on {card}", flush=True)
    print(f"[compiled runtime] round trip p50 / p90 ms: handle "
          f"{rec['handle_rtt_ms']['p50']:.2f} / "
          f"{rec['handle_rtt_ms']['p90']:.2f} (over the replica's forward "
          f"{rec['handle_overhead_ms']['p50']:.2f} / "
          f"{rec['handle_overhead_ms']['p90']:.2f}), HTTP "
          f"{rec['http_rtt_ms']['p50']:.2f} / {rec['http_rtt_ms']['p90']:.2f}"
          f" (over {rec['http_overhead_ms']['p50']:.2f} / "
          f"{rec['http_overhead_ms']['p90']:.2f}), 16 concurrent {rec['concurrent_rtt_ms']['p50']:.2f} / "
          f"{rec['concurrent_rtt_ms']['p90']:.2f}; the replica's forward "
          f"{rec['replica_forward_ms']['p50']:.2f} (in process "
          f"{rec['in_process_forward_ms']['p50']:.2f}); no-op "
          f"{rec['noop_rtt_ms']['p50']:.3f} / {rec['noop_rtt_ms']['p90']:.3f}"
          f"; tensor edge {rec['edge_rtt_ms']['p50']:.1f} / "
          f"{rec['edge_rtt_ms']['p90']:.1f}; rtpu_dag_executions_total "
          f"+{rec['executions']} on {card}", flush=True)
    n = len(prompts)
    if any(bad.values()) or edge_bad or len(got["edge"]) != 8:
        raise AssertionError(f"compiled phase: answers differ from this "
                             f"process's forward: {bad}, tensor edge "
                             f"{edge_bad} of {sorted(got['edge'])}")
    if launches != [cfg.n_layers]:
        raise AssertionError(f"compiled phase: kernel 1 launches a request "
                             f"{launches}, expected {cfg.n_layers}")
    if (got["http_executions"] != n or got["executions"] !=
            4 * n + NOOP_CALLS + 8
            or list(got["dags"].values()) != [dict(max_in_flight=8,
                                                   channels=2)]):
        raise AssertionError(f"compiled phase: not every request rode the "
                             f"compiled plane: {rec}")
    if any(rec["cuda_in_driver"]) or rec["channels_left"]:
        raise AssertionError(f"compiled phase: CUDA in the driver "
                             f"{rec['cuda_in_driver']}, channels left "
                             f"{rec['channels_left']}")
    return rec


def _check_mux_replica(cfg, got, mux, card):
    """The multiplexed replica's run against this process's: the same
    tokens for each request of the order, and the residency and swaps the
    budget predicts for it."""
    deltas = _mux_deltas(cfg)
    sizes = {"m0": mux["rec"]["sizes"]["m0"]}
    sizes.update({m: _variant_bytes(cfg, d) for m, d in deltas.items()})
    ops = [op for n, mid in enumerate(MUX_ORDER)
           for _ in range(MUX_SEQ_PROMPTS) for op in _request_ops(mid)]
    counts, _, resident = _lru_swaps(ops, sizes, mux["budget"],
                                     {m: "m0" for m in deltas})
    models_seen = got["load_state"]["models"]
    want_models = {m: {"state": "hbm" if m in resident else "host",
                       "inflight": 0, "swaps_in": c[0], "swaps_out": c[1]}
                   for m, c in counts.items()}
    plan = got["store_plan"]
    store = got["store_report"]
    rec = dict(deploy_s=got["deploy_s"],
               deploy_to_first_answer_s=got["deploy_to_first_answer_s"],
               first_token_s=got["first_s"], store_plan=plan,
               store={k: store.get(k) for k in (
                   "backend", "capacity_bytes", "arena_used_bytes",
                   "spill_dir_bytes", "file_segment_bytes")},
               models=models_seen, predicted_models=want_models,
               registry=got["registry"])
    print(f"[serve runtime multiplex] llama3_8b {cfg.n_layers} layers, "
          f"order {list(MUX_ORDER)} one at a time through "
          f"handle.options(model_id=...): {json.dumps(rec, default=str)} "
          f"on {card}", flush=True)
    how = (f"sized to {plan['capacity']} bytes" if plan["store"] == "sized"
           else "default capacity, the put spilled to disk")
    print(f"[serve runtime multiplex] the base's host copy: store "
          f"{plan['store']} ({how}; arena {store.get('arena_used_bytes')} "
          f"bytes, spill {store.get('spill_dir_bytes')} bytes)", flush=True)
    bad = [k for k in mux["tokens"] if got["tokens"].get(k) != mux["tokens"][k]]
    if bad or set(got["tokens"]) != set(mux["tokens"]):
        raise AssertionError(f"multiplexed replica: requests {bad} differ "
                             "from the in-process multiplex")
    if models_seen != want_models:
        raise AssertionError(f"multiplexed replica's models {models_seen}, "
                             f"predicted {want_models}")
    held = (store.get("arena_used_bytes") or 0) if plan["store"] == "sized" \
        else store.get("spill_dir_bytes") or 0
    if held < sizes["m0"] // 2:
        raise AssertionError(f"the base's host copy is not in the store's "
                             f"{plan['store']} tier: {store}")
    return rec


# Disaggregated serving: one prefill and two decode replicas share the card
# (a fraction of the GPU resource each, and the CUDA_VISIBLE_DEVICES opt-in)
DISAGG_DEPLOYMENT = "llama3_8b_disagg"
DISAGG_SHARE = 0.3
DISAGG_DRAIN_TOKENS = 256
KV_TRANSFER_METRICS = ("rtpu_serve_kv_transfers_total",
                       "rtpu_serve_kv_transfer_bytes_total",
                       "rtpu_serve_kv_transfer_seconds")


def _kv_transfer_totals():
    """``{origin: {path: [transfers, bytes, seconds]}}`` of the replicas'
    ``rtpu_serve_kv_transfer_*`` metrics, as their workers pushed them to
    this driver (each side of a transfer observes it: the prefill replica
    its ship, the decode replica its fetch)."""
    from ray_tpu_torch.util.metrics import federation

    out = {}
    for labels, records in federation.export():
        origin = labels.get("worker_id", "?")
        for rec in records:
            if rec["name"] not in KV_TRANSFER_METRICS:
                continue
            col = KV_TRANSFER_METRICS.index(rec["name"])
            for key, value in rec["samples"]:
                path = dict(map(tuple, key)).get("path", "?")
                row = out.setdefault(origin, {}).setdefault(path, [0, 0, 0.0])
                # a histogram's sample is (bucket counts, sum, count)
                row[col] = value[1] if col == 2 else value
    return out


def _transfer_delta(before, after):
    """What each origin's transfer metrics moved by, by path."""
    out = {}
    for origin, paths in after.items():
        for path, row in paths.items():
            prev = before.get(origin, {}).get(path, [0, 0, 0.0])
            d = [a - b for a, b in zip(row, prev)]
            if d[0]:
                out.setdefault(origin, {})[path] = d
    return out


def _replica_stats(handle):
    """Each replica's ``stats`` (engine counters and KV state), by actor id;
    each call also makes the replica's worker push its metrics."""
    import ray_tpu_torch

    handle._refresh(force=True, timeout=60)
    return {r._actor_id.binary().hex(): ray_tpu_torch.get(
        r.handle_request.remote("stats", (), {}), timeout=60)
        for r in handle._replicas}


def disagg_driver(out_path, seed=0, model="llama3-8b", device=None,
                  share=DISAGG_SHARE, new_tokens=NEW_TOKENS,
                  drain_tokens=DISAGG_DRAIN_TOKENS):
    """The driver of the disaggregated phase, in a process of its own that
    never touches the card: ``ray_tpu_torch.init()``, ``deploy_disagg`` at
    full width and depth (bf16 weights drawn on the card from the seed by
    each replica; 8 slots, max_len 512, captured steps), 1 prefill + 2
    decode replicas each with ``share`` of the card. Then the 8 requests one
    at a time through ``DisaggHandle.stream`` (each one's transfer bytes,
    seconds and path from the ``rtpu_serve_kv_transfer_*`` metrics), both
    waves twice at once (16 streams), an undisturbed long stream and the
    same stream drained off its decode replica mid-way, the pools' counts
    and KV state, shutdown, and the session's segments left in
    ``/dev/shm``. Writes what it saw to ``out_path`` (``torch.save``)."""
    import ray_tpu_torch
    from ray_tpu_torch import _native

    os.environ["RTPU_METRICS_PUSH_INTERVAL_S"] = "0.2"
    native = _native.native_status()
    if not (native["store"] and native["pipe"]):
        raise AssertionError(f"the object store is not native: {native}")
    used_before_mib = _card_memory_used_mib() if device is None else 0
    print(f"[disagg] card memory used before the replicas: {used_before_mib} "
          "MiB", flush=True)
    ray_tpu_torch.init()
    session = ray_tpu_torch.get_runtime_context().get_session_id()
    try:
        _disagg_run(out_path, session, seed, model, device, share,
                    new_tokens, drain_tokens, used_before_mib)
    except BaseException:
        _print_worker_errors()
        ray_tpu_torch.shutdown()
        raise


def _print_worker_errors():
    """The tracebacks in this runtime's worker logs (a replica that died
    while it was built reports only "actor is dead" to its caller)."""
    from ray_tpu_torch.core.runtime import _get_runtime

    logs = os.path.join(_get_runtime().session_dir, "logs")
    for name in sorted(os.listdir(logs)):
        with open(os.path.join(logs, name), errors="replace") as f:
            lines = f.read().splitlines()
        at = [i for i, line in enumerate(lines) if "Traceback" in line]
        if at:
            print(f"[disagg] {name}:\n" + "\n".join(lines[at[0]:][-60:]),
                  flush=True)


def _disagg_run(out_path, session, seed, model, device, share, new_tokens,
                drain_tokens, used_before_mib):
    """``disagg_driver``'s body, once the runtime is up."""
    import ray_tpu_torch

    out = dict(cuda_after_init=torch.cuda.is_initialized(),
               resources=ray_tpu_torch.available_resources())
    cfg = models.get_config(model).replace(param_dtype="bfloat16")
    waves = _waves(cfg, seed)
    prompts = waves[0] + waves[1]
    opts = dict(ON_CARD, num_gpus=share) if share else {}
    kw = dict(device=device) if device else {}
    t0 = time.perf_counter()
    h = serve.deploy_disagg(
        cfg, name=DISAGG_DEPLOYMENT, prefill_replicas=1, decode_replicas=2,
        max_concurrency=32, prefill_actor_options=opts,
        decode_actor_options=opts, max_slots=8, max_len=512, block_size=16,
        seed=seed, **kw)
    # the replicas are up once each answers; the router sends a transfer
    # over a ring once the decode pool's load reports name its node
    out["prefill_stats0"] = _replica_stats(h.prefill)
    out["decode_stats0"] = _replica_stats(h.decode)
    deadline = time.monotonic() + 60
    while (len(h._fresh(h._pool_loads(h.decode))) < 2
           or len(h._fresh(h._pool_loads(h.prefill))) < 1):
        if time.monotonic() > deadline:
            raise AssertionError("the pools' load reports never came")
        time.sleep(0.1)
    out["deploy_s"] = time.perf_counter() - t0
    out["card_used_mib"] = ((_card_memory_used_mib() - used_before_mib)
                            if device is None else 0)
    # one at a time: tokens, and each request's transfer from the metrics
    out["sequential"], out["transfers"] = [], []
    for p in prompts:
        before = _kv_transfer_totals()
        out["sequential"].append(list(h.stream(p, new_tokens,
                                               deadline_s=300)))
        deadline = time.monotonic() + 20
        while True:
            time.sleep(0.25)
            _replica_stats(h.prefill), _replica_stats(h.decode)
            delta = _transfer_delta(before, _kv_transfer_totals())
            if sum(row[0] for paths in delta.values()
                   for row in paths.values()) >= 2:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"request of {len(p)} tokens: the KV "
                                     f"transfer metrics moved by {delta}")
        out["transfers"].append(delta)
    # both waves twice, at once
    streams = prompts * 2
    results, stamps, errors = [None] * 16, [None] * 16, []

    def run(i):
        try:
            t_sub, toks, ts = time.perf_counter(), [], []
            for tok in h.stream(streams[i], new_tokens, deadline_s=300):
                ts.append(time.perf_counter())
                toks.append(tok)
            results[i], stamps[i] = toks, (t_sub, ts)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(streams))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    out["concurrent_wall_s"] = time.perf_counter() - t0
    if errors or any(r is None for r in results):
        raise AssertionError(f"concurrent streams failed: {errors[:3]}")
    out["concurrent"] = results
    out["concurrent_timing"] = _stream_stats(stamps,
                                             new_tokens * len(streams))
    # a long stream undisturbed, then the same one drained mid-way: its
    # decode replica migrates the live session to the other one
    drain_prompt = waves[0][1]
    t0 = time.perf_counter()
    out["undisturbed"] = list(h.stream(drain_prompt, drain_tokens,
                                       deadline_s=300))
    out["undisturbed_s"] = time.perf_counter() - t0
    exported0 = sum(s["exported"] for s in _replica_stats(h.prefill).values())
    t0 = time.perf_counter()
    g = h.stream(drain_prompt, drain_tokens, deadline_s=300)
    drained = [next(g) for _ in range(8)]
    live = [hx for hx, st in _replica_stats(h.decode).items()
            if st["inflight"] >= 1]
    if len(live) != 1:
        raise AssertionError(f"live decode sessions on {live}, expected one")
    t1 = time.perf_counter()
    out["drain_report"] = h.drain_decode_replica(live[0], timeout_s=60.0)
    out["drain_s"] = time.perf_counter() - t1
    out["drained_at"] = len(drained)
    drained += list(g)
    out["drained_stream_s"] = time.perf_counter() - t0
    out["drained"] = drained
    out["drain_victim"] = live[0]
    out["prefill_stats"] = _replica_stats(h.prefill)
    out["decode_stats"] = _replica_stats(h.decode)
    out["exported_by_drain"] = sum(
        s["exported"] for s in out["prefill_stats"].values()) - exported0
    out["kv_states"] = h.kv_states()
    time.sleep(0.5)
    out["transfer_totals"] = _kv_transfer_totals()
    h.shutdown()
    serve.shutdown()
    ray_tpu_torch.shutdown()
    out["left_in_dev_shm"] = sorted(
        glob.glob(f"/dev/shm/rtpu-chan-{session}-*")
        + glob.glob(f"/dev/shm/rtpu-arena-{session}*"))
    out["cuda_at_end"] = torch.cuda.is_initialized()
    torch.save(out, out_path)


def phase_disagg_runtime(card, colocated, seed=0, device="cuda"):
    """Disaggregated serving through the framework, after this process has
    let go of the llama3_8b weights: a driver process that never touches
    the card (``disagg_driver``) deploys one prefill and two decode
    replicas on the card and drives them. Held here: its one-at-a-time
    tokens equal this process's captured colocated engine's
    (``colocated["sequential"]``, the serve runtime phase's), token for
    token; every one of the 16 concurrent streams meets the bf16 bar
    against the kernel-backed forward (the weights drawn again from the
    seed once the replicas are gone); every transfer rode a ring; the
    prefill pool exported and the decode pool adopted every request, the
    drained session once more, with no re-prefill; the drained stream
    equals the undisturbed one; no pool leaked a block; shutdown left no
    segment of the session. Prints TTFT / TPOT p50 and tokens/s beside the
    colocated replica's under the same 16 requests, each request's
    transfer and the migration's time."""
    # engines of earlier phases may sit in reference cycles: collect them
    # before three replicas need 48 GB of the card
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[disagg] this process holds {torch.cuda.memory_allocated()} "
          f"bytes on the card ({torch.cuda.memory_reserved()} reserved)",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_disagg_")
    out_path = os.path.join(tmp, "disagg.pt")
    try:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--disagg-driver", out_path], check=True, timeout=600)
        got = torch.load(out_path, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _check_disagg(got, card, colocated, seed=seed, device=device)


def _check_disagg(got, card, colocated, seed=0, device="cuda",
                  model="llama3-8b", new_tokens=NEW_TOKENS):
    """What ``phase_disagg_runtime`` holds the driver's run to."""
    cfg = models.get_config(model).replace(param_dtype="bfloat16")
    waves = _waves(cfg, seed)
    prompts = waves[0] + waves[1]
    n = len(prompts)
    if got["sequential"] != colocated["sequential"]:
        bad = [i for i, (a, b) in enumerate(zip(got["sequential"],
                                                colocated["sequential"]))
               if a != b]
        raise AssertionError(f"disagg: requests {bad} one at a time differ "
                             "from the colocated engine")
    if got["cuda_after_init"] or got["cuda_at_end"]:
        raise AssertionError("disagg: CUDA initialised in the driver")
    # each request: one ship (the prefill replica) and one fetch (a decode
    # replica), both over the ring, the same bytes on both sides
    per_request, prefill_origins = [], None
    for i, rows in enumerate(got["transfers"]):
        if (len(rows) != 2 or any(list(paths) != ["channel"]
                                  for paths in rows.values())
                or any(r["channel"][0] != 1 for r in rows.values())):
            raise AssertionError(f"disagg request {i}: transfers {rows}")
        nbytes = {r["channel"][1] for r in rows.values()}
        if len(nbytes) != 1:
            raise AssertionError(f"disagg request {i}: bytes {rows}")
        prefill_origins = (set(rows) if prefill_origins is None
                           else prefill_origins & set(rows))
        per_request.append(dict(prompt=len(prompts[i]), bytes=nbytes.pop(),
                                seconds={o: r["channel"][2]
                                         for o, r in rows.items()}))
    if not prefill_origins or len(prefill_origins) != 1:
        raise AssertionError(f"disagg: no one replica shipped every request "
                             f"({prefill_origins})")
    ship = prefill_origins.pop()
    transfers = [dict(prompt=r["prompt"], bytes=r["bytes"],
                      ship_s=r["seconds"][ship],
                      fetch_s=next(v for o, v in r["seconds"].items()
                                   if o != ship))
                 for r in per_request]
    for t in transfers:
        t["ship_gb_s"] = t["bytes"] / t["ship_s"] / 1e9
        t["fetch_gb_s"] = t["bytes"] / t["fetch_s"] / 1e9
    paths = {path for paths in got["transfer_totals"].values()
             for path in paths}
    # the counts: every request exported once, adopted once; the drained
    # session adopted once more and exported by no prefill
    requests = n + 2 * n + 2
    pstats, dstats = got["prefill_stats"], got["decode_stats"]
    exported = sum(s["exported"] for s in pstats.values())
    adopted = sum(s["adopted"] for s in dstats.values())
    migrated = {hx: s["migrated_out"] for hx, s in dstats.items()}
    report = got["drain_report"]
    counts = dict(exported=exported, adopted=adopted, migrated_out=migrated,
                  exported_by_drain=got["exported_by_drain"],
                  drain_report=report)
    if (exported != requests or adopted != requests + 1
            or migrated.get(got["drain_victim"]) != 1
            or sum(migrated.values()) != 1
            or got["exported_by_drain"] != 1
            or report != {"sessions": 1, "migrated": 1, "failed": 0,
                          "finished": 0}):
        raise AssertionError(f"disagg counts: {counts}")
    if got["drained"] != got["undisturbed"]:
        bad = next(i for i, (a, b) in enumerate(zip(got["drained"],
                                                    got["undisturbed"]))
                   if a != b) if len(got["drained"]) == len(
                       got["undisturbed"]) else "length"
        raise AssertionError(f"disagg: the drained stream differs from the "
                             f"undisturbed one at {bad}")
    leaks = {role: [(s["kv_free"], s["prefix"]["nodes"], s["kv_total"],
                     s["inflight"], s["queued"]) for s in states]
             for role, states in got["kv_states"].items()}
    if any(f + nodes != total or inflight or queued
           for states in leaks.values()
           for f, nodes, total, inflight, queued in states):
        raise AssertionError(f"disagg: a pool leaked KV blocks: {leaks}")
    if got["left_in_dev_shm"]:
        raise AssertionError(f"disagg: shutdown left {got['left_in_dev_shm']}")
    if paths != {"channel"}:
        raise AssertionError(f"disagg: transfers took the paths {paths}")
    if any(len(t) != new_tokens for t in got["concurrent"]):
        raise AssertionError(f"disagg: concurrent stream lengths "
                             f"{[len(t) for t in got['concurrent']]}")
    # the bf16 bar on the 16 concurrent streams, against the forward on the
    # same weights, drawn again here
    cfg, params, _ = _bf16_weights(model, seed)
    agree = _check_greedy(
        "disagg bf16", *_greedy_vs_forward(
            params, cfg, [(p, t + [None]) for p, t in
                          zip(prompts * 2, got["concurrent"])], device),
        BF16_AGREE_MIN, BF16_GAP_TOL)
    del params
    if device == "cuda":
        torch.cuda.empty_cache()
    co = colocated["replica_all"]
    dis = got["concurrent_timing"]
    rec = dict(deploy_s=got["deploy_s"], card_used_mib=got["card_used_mib"],
               concurrent=dis, colocated_replica=co,
               concurrent_wall_s=got["concurrent_wall_s"], agree=agree,
               transfers=transfers, counts=counts, kv_states=leaks,
               drain=dict(tokens=len(got["drained"]),
                          drained_at=got["drained_at"],
                          drain_call_s=got["drain_s"],
                          drained_stream_s=got["drained_stream_s"],
                          undisturbed_s=got["undisturbed_s"]),
               left_in_dev_shm=got["left_in_dev_shm"])
    print(f"[disagg] {model} 1 prefill + 2 decode replicas sharing the card: "
          f"{n} requests one at a time token-exact against the colocated "
          f"engine; {json.dumps(rec, default=str)}", flush=True)
    mean = {k: float(np.mean([t[k] for t in transfers]))
            for k in ("bytes", "ship_s", "fetch_s", "ship_gb_s",
                      "fetch_gb_s")}
    print(f"[disagg] TTFT p50 / TPOT p50 / tokens/s, 16 concurrent streams: "
          f"disaggregated {dis['ttft_p50_ms']:.1f} / {dis['tpot_p50_ms']:.2f}"
          f" / {dis['tokens_per_s']:.0f}; colocated replica "
          f"{co['ttft_p50_ms']:.1f} / {co['tpot_p50_ms']:.2f} / "
          f"{co['tokens_per_s']:.0f}. KV transfer (ring, mean of {n}): "
          f"{mean['bytes'] / 2**20:.1f} MiB, ship {mean['ship_s'] * 1e3:.2f} "
          f"ms ({mean['ship_gb_s']:.2f} GB/s), fetch "
          f"{mean['fetch_s'] * 1e3:.2f} ms ({mean['fetch_gb_s']:.2f} GB/s); "
          f"drain of a live session {got['drain_s'] * 1e3:.1f} ms, the "
          f"drained stream {got['drained_stream_s']:.2f} s against "
          f"{got['undisturbed_s']:.2f} s undisturbed, on {card}", flush=True)
    return rec


def _cache_bytes(cfg, b, total, rolling):
    cache = models.init_cache(cfg, b, total, rolling=rolling, device="meta")
    return sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v"))


def phase_generate(cfg, params, card, b, prompt_len, new_tokens, seed=0,
                   device="cuda"):
    """``models.generate`` (greedy) on a seeded random prompt, in the
    model's bf16, then again in float32 on the same weights: the f32 tokens
    are held against the kernel-backed f32 forward (the bf16 ones are
    reported beside it, not gated: too few positions for PR 1's bf16
    limits). Prints the KV cache's bytes in the layout ``generate`` took
    against the other."""
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=gen,
                           device=device)
    total = prompt_len + new_tokens
    ring = bool(cfg.uniform_window) and cfg.uniform_window < total
    nbytes = {r: _cache_bytes(cfg, b, total, r) for r in (True, False)
              if cfg.uniform_window or not r}
    layout = (f"{'ring' if ring else 'full-length'} KV cache "
              f"{nbytes[ring] / 1e6:.1f} MB (" + (
                  f"the other layout {nbytes[not ring] / 1e6:.1f} MB)"
                  if cfg.uniform_window else "mixed windows: no ring)"))
    name = f"generate {cfg.n_layers}L B={b} P={prompt_len}"
    results = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.replace(dtype=dtype)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = models.generate(params, prompt, c, max_new_tokens=new_tokens)
            out = out.cpu()  # waits for the card
        dt = time.perf_counter() - t0
        if out.shape != (b, total) or not torch.equal(out[:, :prompt_len],
                                                      prompt.cpu()):
            raise AssertionError(f"{name}: output {tuple(out.shape)}")
        sinks = [(prompt[i].tolist(), out[i, prompt_len:].tolist() + [None])
                 for i in range(b)]
        results[dtype] = _greedy_vs_forward(params, c, sinks, device)
        agree, positions, gap = results[dtype]
        print(f"[{name} {dtype}] {layout}; {new_tokens} new tokens in "
              f"{dt:.2f} s; greedy vs kernel-backed forward "
              f"{agree}/{positions}, worst gap {gap:.4g} on {card}",
              flush=True)
    _check_greedy(f"{name} f32", *results["float32"], F32_AGREE_MIN,
                  F32_GAP_TOL)
    return dict(ring=ring, cache_bytes=nbytes)


# f32 train step, card kernels vs CPU plain versions, summation order only
# over 2 layers: loss and every grad to 2e-5 absolute, grad norm to 1e-5
# relative, the updated params to 1e-6 absolute. The step uses Adam's eps
# 1e-3: the first Adam step is g / (|g| + eps), which with optax's 1e-8 is
# sign(g) and would turn a 1e-9 difference in a near-zero grad into a
# 2 * lr difference in a parameter.
SMALL_TRAIN_TOL = dict(loss=2e-5, grad=2e-5, grad_norm=1e-5, params=1e-6)


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict)
                else v.detach().to(device).clone())
            for k, v in tree.items()}


def _tree_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_items(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def phase_small_train(seed=0, device="cuda", head_dim=None,
                      remat_policy="full"):
    """One float32 ``make_train_step`` step (through ``TrainLoopHelper``)
    of a gemma-style config (GQA, alternating windows 48/global, attention
    and logit softcaps, tied embeddings, remat: ``remat_policy``) on the
    card, its f32 kernels, against the same step on the CPU, the plain
    versions, from the same weights and batch. ``head_dim=256``
    (Gemma-2's) takes 2 q heads and 1 kv head in place of 4 and 2 of
    width 64."""
    heads = dict(n_heads=4, n_kv_heads=2) if head_dim is None else dict(
        n_heads=2, n_kv_heads=1, head_dim=head_dim)
    cfg = models.gemma_debug().replace(
        d_model=256, d_ff=512, vocab_size=512, attn_windows=(48, 0),
        dtype="float32", param_dtype="float32", remat=True,
        remat_policy=remat_policy, **heads)
    weights = models.init_params(torch.Generator().manual_seed(seed), cfg,
                                 device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 201))
    batch = {"tokens": toks}
    results = []
    for dev in (device, "cpu"):
        helper = TrainLoopHelper.create(
            lambda: _tree_to(weights, dev),
            lambda p, b: models.loss_and_metrics(p, b, cfg),
            adamw(1e-3, eps=1e-3), device=dev)
        before = (flash_cuda.launches, flash_cuda.launches_dq,
                  flash_cuda.launches_dkv)
        metrics = helper.run_steps(batch, 1)
        after = (flash_cuda.launches, flash_cuda.launches_dq,
                 flash_cuda.launches_dkv)
        params = dict(_tree_items(helper.state["params"]))
        results.append(dict(
            loss=metrics["loss"].item(),
            grad_norm=metrics["grad_norm"].item(),
            grads={k: t.grad.cpu() for k, t in params.items()},
            params={k: t.detach().cpu() for k, t in params.items()},
            launches=[a - b for a, b in zip(after, before)]))
    got, want = results
    err = dict(
        loss=abs(got["loss"] - want["loss"]),
        grad=max((got["grads"][k] - want["grads"][k]).abs().max().item()
                 for k in want["grads"]),
        grad_norm=abs(got["grad_norm"] / want["grad_norm"] - 1),
        params=max((got["params"][k] - want["params"][k]).abs().max().item()
                   for k in want["params"]))
    print(f"[train-small] f32 {cfg.n_layers} layers, head dim {cfg.hdim}, "
          f"remat {remat_policy}, card vs CPU: loss "
          f"{got['loss']:.6f} vs {want['loss']:.6f}; errors "
          f"{json.dumps(err)} (tol {json.dumps(SMALL_TRAIN_TOL)}); card "
          f"launches fwd/dq/dkv {got['launches']}, CPU {want['launches']}",
          flush=True)
    if any(err[k] > SMALL_TRAIN_TOL[k] for k in err):
        raise AssertionError(f"small train step: card and CPU disagree {err}")
    # two layers, the forward recomputed under full remat (4 forward
    # launches; save_attn keeps its output: 2) and 2 of each backward
    # kernel on the card, none on the CPU
    fwd = 2 if remat_policy == "save_attn" else 4
    if got["launches"] != [fwd, 2, 2] or want["launches"] != [0, 0, 0]:
        raise AssertionError(f"small train step launches: card "
                             f"{got['launches']}, CPU {want['launches']}")


TRAIN_STEPS = 10
# gemma2_9b's dense engine runs its first layers only (of 42): the smoke
# must stay within its time with the multiplexed and save_attn phases
GEMMA2_DENSE_LAYERS = 8
# and, with the compiled phase, the paged engine and generate 20 of the
# 42 (window and global layers alternate: the count must be even) and
# mistral_7b's generate half of its 32 (each layer has the 4096 window)
GEMMA2_PAGED_LAYERS = 20
MISTRAL_GENERATE_LAYERS = 16


def gemma2_train_config():
    """Gemma-2-9B at its full width, head dim, windows and softcaps, cut to
    8 layers (4 window + 4 global; 2.50 B parameters): the 42 layers'
    float32 weights, grads and AdamW moments (9.24 B x 16 bytes = 148 GB)
    are over the card's 80 GB, 8 layers' are 40 GB. The loss in chunks of
    1024 positions keeps the 256128-wide f32 logits of L=8192 at ~1 GB a
    chunk (8.4 GB whole)."""
    return models.gemma2_9b().replace(n_layers=8, loss_chunk=1024)


def _train_flops_per_token(cfg, l):
    """Training FLOPs a token as ``bench.py`` counts them (6 N, embeddings
    excluded), plus each layer's attention over the (q, k) pairs its band
    keeps: 3 x 2 products of 2 hdim n_heads FLOPs a pair, so a window
    layer is not credited with the pairs it skips."""
    attn = sum(12 * cfg.hdim * cfg.n_heads
               * _visible_pairs(l, l, True, w or None)
               for w in cfg.layer_windows) / l
    return cfg.flops_per_token() + attn


def phase_train(card, seed=0, cfg=None, b=4, l=4096, device="cuda",
                remat_policy="full", profile=True):
    """Llama-1B width and depth (16 layers) at B=4, L=4096 (16,384 tokens a
    step), or another ``cfg`` (Gemma-2-9B width at 8 layers, B=1, L=8192);
    bf16 compute on float32 master weights from a seeded generator, remat
    (``remat_policy``: ``full`` recomputes attention, ``save_attn`` keeps
    its output), AdamW 1e-4; one fixed random batch. One warm-up
    ``run_steps``, then ``run_steps(batch, 10)`` timed with the launch
    counts set to 0 just before it, then (``profile``) a profiled step. A
    NaN or inf at any step would reach the parameters through AdamW and
    every later loss, so a finite loss after the 10 steps covers each of
    them. Returns the launch counts and the phase's row."""
    cfg = (cfg or models.llama_1b()).replace(remat_policy=remat_policy)
    # earlier phases' engines sit in reference cycles: collect them, so
    # that the peak memory below is this phase's
    _settle_memory()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, l + 1),
                                     generator=gen, device=device)}
    t0 = time.perf_counter()
    helper = TrainLoopHelper.create(
        lambda: models.init_params(gen, cfg, device=device),
        lambda p, bt: models.loss_and_metrics(p, bt, cfg), adamw(1e-4),
        device=device)
    first = helper.run_steps(batch, 1)
    loss0 = first["loss"].item()
    print(f"[train] {cfg.num_params() / 1e9:.3f} B params, {cfg.n_layers} "
          f"layers, head dim {cfg.hdim}, B={b} L={l}: set-up and warm-up "
          f"step {time.perf_counter() - t0:.1f} s, loss {loss0:.4f}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    flash_cuda.launches = flash_cuda.launches_dq = flash_cuda.launches_dkv = 0
    t0 = time.perf_counter()
    metrics = helper.run_steps(batch, TRAIN_STEPS)
    dt = time.perf_counter() - t0
    counts = dict(fwd=flash_cuda.launches, dkv=flash_cuda.launches_dkv,
                  dq=flash_cuda.launches_dq)
    loss = metrics["loss"].item()
    grad_norm = metrics["grad_norm"].item()
    step_s = dt / TRAIN_STEPS
    flops_token = _train_flops_per_token(cfg, l)
    row = dict(step_ms=step_s * 1e3, tokens_per_s=b * l / step_s,
               mfu=flops_token * b * l / step_s / _peak_bf16(),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss_before=loss0, loss_after=loss, grad_norm=grad_norm,
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in counts.items()})
    row["remat_policy"] = remat_policy
    print(f"[train] {json.dumps(row)} on {card}", flush=True)
    if device == "cuda" and profile:
        _device_breakdown(lambda: helper.run_steps(batch, 1), row["step_ms"])
    fwd = cfg.n_layers if remat_policy == "save_attn" else 2 * cfg.n_layers
    want = dict(fwd=fwd, dkv=cfg.n_layers, dq=cfg.n_layers)
    if row["launches_per_step"] != want:
        raise AssertionError(f"launches per step {row['launches_per_step']},"
                             f" expected {want}")
    if not (np.isfinite(loss) and np.isfinite(grad_norm) and loss < loss0):
        raise AssertionError(f"training did not progress: loss {loss0} -> "
                             f"{loss}, grad norm {grad_norm}")
    return counts, row


# save_attn against full remat, the same weights and batch: the first
# step's loss is a forward only, which the policy leaves alone; after 10
# updates the losses may part by rounding
SAVE_ATTN_LOSS_TOL = 1e-3


def phase_train_save_attn(card, full_row, seed=0, device="cuda"):
    """``llama_1b training`` again under ``remat_policy="save_attn"``: the
    attention's out and lse are saved, so the recompute runs no forward
    kernel: 16 / 16 / 16 launches a step (full remat: 32 / 16 / 16). The
    first step's loss must equal full remat's bitwise, the last within
    ``SAVE_ATTN_LOSS_TOL``. Step ms, tokens/s, MFU and peak memory are
    printed beside full remat's (``full_row``)."""
    counts, row = phase_train(card, seed=seed, device=device,
                              remat_policy="save_attn", profile=False)
    first_gap = abs(row["loss_before"] - full_row["loss_before"])
    last_gap = abs(row["loss_after"] - full_row["loss_after"])
    cmp = {k: dict(save_attn=row[k], full=full_row[k]) for k in (
        "step_ms", "tokens_per_s", "mfu", "peak_memory_gb", "loss_before",
        "loss_after")}
    print(f"[train save_attn] llama_1b B=4 L=4096: {json.dumps(cmp)}; "
          f"first-step loss gap {first_gap}, last {last_gap} (limit "
          f"{SAVE_ATTN_LOSS_TOL}); launches a step "
          f"{json.dumps(row['launches_per_step'])} on {card}", flush=True)
    if first_gap != 0.0 or last_gap > SAVE_ATTN_LOSS_TOL:
        raise AssertionError(f"save_attn losses off full remat's: first "
                             f"{first_gap}, last {last_gap}")
    return counts, row


# The trainer phase: llama_1b at full width and depth, B=4, L=4096, as
# phase_train; its batches come from a dataset (the token corpus below).
TRAINER_STEPS, TRAINER_CKPT_STEP, TRAINER_DIE_AFTER = 8, 4, 6
# The resumed steps' losses against the in-process run's: the same weights
# and batches on the same card through the same kernels, all three
# deterministic, and the checkpoint restores parameters, AdamW moments and
# steps bit for bit, so the losses must be equal (a gap of 0).
TRAINER_LOSS_TOL = 0.0
# The token corpus: CORPUS_SHARDS .npy files of CORPUS_ROWS sequences of
# 4,097 uint16 tokens (L = 4096 plus the shifted target), drawn from the
# seed with numpy below llama_1b's vocabulary: 8,192 sequences, 33.6 M
# tokens, 67 MB.
CORPUS_SHARDS, CORPUS_ROWS, CORPUS_SEQ = 32, 256, 4097
INGEST_BATCHES = (4, 64)


def write_corpus(path, vocab, seed=0):
    """Write the token corpus under ``path``; returns the sum of its
    tokens."""
    rng = np.random.default_rng(seed)
    total = 0
    for i in range(CORPUS_SHARDS):
        shard = rng.integers(0, vocab, (CORPUS_ROWS, CORPUS_SEQ),
                             dtype=np.uint16)
        total += int(shard.sum(dtype=np.int64))
        np.save(os.path.join(path, f"shard_{i:03d}.npy"), shard)
    return total


def corpus_dataset(path, seed=0):
    """The plan a user writes: read the shards, shuffle the sequences with
    a seed, keep the ``tokens`` column."""
    from ray_tpu_torch import data

    return (data.read_numpy(path).random_shuffle(seed=seed)
            .map_batches(lambda b: {"tokens": b["data"]}))


def _token_batches(it, b, device):
    """``iter_torch_batches`` as the trainer takes it: int64 tokens on
    ``device``."""
    return it.iter_torch_batches(batch_size=b, device=device,
                                 dtypes={"tokens": torch.int64},
                                 drop_last=True)


def _trainer_loop(config):
    """The train loop of the trainer phase, run in the worker: the helper
    from ``seed`` (or the checkpoint it is handed), one ``run_step`` a step
    on the next batch of ``get_dataset_shard("train")`` (a resumed attempt
    first skips the batches its checkpoint's steps took), each step
    reported with its loss, its wait for the batch, its kernel launches in
    this process and ``StepTelemetry``'s tokens/s and MFU; after step
    ``ckpt_step`` ``save_checkpoint_async`` (waited on) and the checkpoint
    reported; on the first attempt the process exits after reporting
    ``die_after``. It travels to the worker by value (this script runs as
    ``__main__``), with :func:`_token_batches`; what else it uses it
    imports itself."""
    import os
    import shutil
    import tempfile
    import time

    import torch

    from ray_tpu_torch import models, train
    from ray_tpu_torch.ops import flash_cuda
    from ray_tpu_torch.train import (Checkpoint, TrainLoopHelper, adamw,
                                     load_pytree)

    started = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = models.get_config(config["model"])
    b, l, seed, dev = config["b"], config["l"], config["seed"], config["device"]
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    helper = TrainLoopHelper.create(
        lambda: models.init_params(gen, cfg, device=dev),
        lambda p, bt: models.loss_and_metrics(p, bt, cfg), adamw(1e-4),
        device=dev)
    resumed, start, load_s = train.get_checkpoint(), 0, None
    if resumed is not None:
        t0 = time.perf_counter()
        tree = load_pytree(os.path.join(resumed.path, "rank_0"), device=dev)
        helper.restore(tree)
        del tree
        sync()
        load_s = time.perf_counter() - t0
        start = int(helper.state["step"])
    marker = os.path.join(train.get_context().get_trial_dir(), "died")
    telemetry = train.get_step_telemetry()
    prev_report_s = None
    t0 = time.perf_counter()
    batches = _token_batches(train.get_dataset_shard("train"), b, dev)
    for _ in range(start):
        next(batches)
    skip_s = time.perf_counter() - t0
    for step in range(start, config["steps"]):
        t0 = time.perf_counter()
        batch = next(batches)
        wait_s = time.perf_counter() - t0
        sync()
        flash_cuda.launches = flash_cuda.launches_dkv = 0
        flash_cuda.launches_dq = 0
        t0 = time.perf_counter()
        loss = helper.run_step(batch)["loss"].item()
        step_s = time.perf_counter() - t0
        telemetry.record_step(step_s, tokens=b * l,
                              flops=config["flops_per_step"], loss=loss)
        snap = telemetry.snapshot()
        metrics = {"step": step + 1, "loss": loss, "step_s": step_s,
                   "batch_wait_s": wait_s, "skip_s": skip_s,
                   "launches": [flash_cuda.launches, flash_cuda.launches_dkv,
                                flash_cuda.launches_dq],
                   "telemetry_tokens_per_s": snap.get("tokens_per_s"),
                   "telemetry_mfu": snap.get("mfu"), "time": time.time(),
                   "started": started, "resumed": resumed is not None,
                   "load_s": load_s, "prev_report_s": prev_report_s,
                   "pid": os.getpid()}
        ckpt = d = None
        if step + 1 == config["ckpt_step"]:
            d = tempfile.mkdtemp(dir=config["scratch"])
            t0 = time.perf_counter()
            pending = helper.save_checkpoint_async(d)
            metrics["snapshot_s"] = time.perf_counter() - t0
            pending.wait()
            metrics["write_s"] = time.perf_counter() - t0 - metrics[
                "snapshot_s"]
            metrics["ckpt_bytes"] = sum(
                os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            ckpt = Checkpoint(d)
        t0 = time.perf_counter()
        train.report(metrics, checkpoint=ckpt)
        prev_report_s = time.perf_counter() - t0
        if d is not None:
            shutil.rmtree(d)         # the trial directory holds its copy
        if step + 1 == config["die_after"] and not os.path.exists(marker):
            # report() returns once the driver took the result, while this
            # worker's reply carrying it may still be on its way: let it
            # land, so that the death comes after this step's report
            time.sleep(1.0)
            with open(marker, "w") as f:
                f.write(repr(time.time()))
            os._exit(1)


def phase_trainer(card, corpus, seed=0, b=4, l=4096, device="cuda",
                  model="llama-1b"):
    """llama_1b through the framework, fed from a dataset: ``TorchTrainer``
    with one ``use_gpu`` worker, ``FailureConfig(max_failures=1)`` and
    ``datasets={"train": corpus_dataset(corpus)}``; its loop
    (:func:`_trainer_loop`) takes its batches from
    ``get_dataset_shard("train").iter_torch_batches(device="cuda")``,
    checkpoints after step 4 and kills its process after step 6 on the
    first attempt; the executor restarts the gang, which resumes from step
    4's checkpoint, skips the 4 batches it took and runs steps 5-8. Held
    against the same 8 steps run in this process first on the batches of
    ``ds.iterator()``. Storage in a ``tempfile.mkdtemp()``, removed at the
    end. ``device="cpu"`` and a small ``model`` (and corpus) rehearse it
    on the CPU (its launch check fails there)."""
    import ray_tpu_torch
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)
    from ray_tpu_torch.train.trainer import _latest_checkpoint

    cfg = models.get_config(model)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    storage = tempfile.mkdtemp(prefix="chip-smoke-trainer-")
    try:
        # f32 parameters and two AdamW moments, written once by the loop and
        # copied once into the trial directory
        state_bytes = 12 * cfg.num_params()
        free = shutil.disk_usage(storage).free
        if free < 2.2 * state_bytes:
            raise AssertionError(
                f"{storage}: {free / 1e9:.1f} GB free, the checkpoint needs "
                f"2 x {state_bytes / 1e9:.1f} GB (written, then copied into "
                f"the trial directory)")
        scratch = os.path.join(storage, "scratch")
        os.makedirs(scratch)
        ray_tpu_torch.init()
        try:
            ds = corpus_dataset(corpus, seed)
            # the reference: the same steps in this process, on the batches
            # of the same plan
            gen = torch.Generator(device=device).manual_seed(seed)
            helper = TrainLoopHelper.create(
                lambda: models.init_params(gen, cfg, device=device),
                lambda p, bt: models.loss_and_metrics(p, bt, cfg),
                adamw(1e-4), device=device)
            ref_losses, ref_s, ref_wait = [], [], []
            batches = _token_batches(ds.iterator(), b, device)
            for step in range(TRAINER_STEPS):
                t0 = time.perf_counter()
                batch = next(batches)
                ref_wait.append(time.perf_counter() - t0)
                if tuple(batch["tokens"].shape) != (b, l + 1):
                    raise AssertionError(f"batch {tuple(batch['tokens'].shape)}"
                                         f", expected {(b, l + 1)}")
                sync()
                t0 = time.perf_counter()
                ref_losses.append(helper.run_step(batch)["loss"].item())
                ref_s.append(time.perf_counter() - t0)
            batches.close()
            del helper, batch, batches
            if device == "cuda":
                torch.cuda.empty_cache()
            t_fit = time.time()
            result = TorchTrainer(
                _trainer_loop,
                train_loop_config=dict(
                    model=model, b=b, l=l, seed=seed, device=device,
                    steps=TRAINER_STEPS, ckpt_step=TRAINER_CKPT_STEP,
                    die_after=TRAINER_DIE_AFTER, scratch=scratch,
                    flops_per_step=_train_flops_per_token(cfg, l) * b * l),
                scaling_config=ScalingConfig(num_workers=1,
                                             use_gpu=device == "cuda"),
                run_config=RunConfig(
                    storage_path=storage,
                    failure_config=FailureConfig(max_failures=1)),
                datasets={"train": ds}).fit()
            fit_s = time.time() - t_fit
        finally:
            ray_tpu_torch.shutdown()
        with open(os.path.join(result.path, "progress.jsonl")) as f:
            reports = [json.loads(line) for line in f]
        with open(os.path.join(result.path, "died")) as f:
            died = float(f.read())
        latest = _latest_checkpoint(result.path, 1)
        ckpt_dirs = sorted(d for d in os.listdir(result.path)
                           if d.startswith("checkpoint_"))
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    steps = [r["step"] for r in reports]
    want_steps = (list(range(1, TRAINER_DIE_AFTER + 1))
                  + list(range(TRAINER_CKPT_STEP + 1, TRAINER_STEPS + 1)))
    if steps != want_steps:
        raise AssertionError(f"trainer reported steps {steps}, expected "
                             f"{want_steps}")
    first, second = (reports[:TRAINER_DIE_AFTER],
                     reports[TRAINER_DIE_AFTER:])
    ckpt_report = reports[TRAINER_CKPT_STEP - 1]
    resumed_gap = max(abs(r["loss"] - ref_losses[r["step"] - 1])
                      for r in second)
    first_gap = max(abs(r["loss"] - ref_losses[r["step"] - 1])
                    for r in first)
    trainer_s = [r["step_s"] for r in reports]
    # between two reports in the worker: the step, the report's round trip
    # to the driver and the next batch, without the checkpoint's step
    cycle = [b_["time"] - a["time"] for a, b_ in zip(first, first[1:])
             if a["step"] != TRAINER_CKPT_STEP]
    row = dict(
        model=model, layers=cfg.n_layers, b=b, l=l,
        ref_step_ms_median=float(np.median(ref_s[1:])) * 1e3,
        trainer_step_ms_median=float(np.median(
            [r["step_s"] for r in reports if r["step"] > 1])) * 1e3,
        trainer_report_cycle_ms_median=float(np.median(cycle)) * 1e3,
        telemetry_tokens_per_s=reports[-1]["telemetry_tokens_per_s"],
        telemetry_mfu=reports[-1]["telemetry_mfu"],
        checkpoint_bytes=ckpt_report["ckpt_bytes"],
        snapshot_s=ckpt_report["snapshot_s"], write_s=ckpt_report["write_s"],
        copy_into_trial_dir_s=reports[TRAINER_CKPT_STEP]["prev_report_s"],
        death_to_first_resumed_step_s=second[0]["time"] - died,
        restart_worker_start_s=second[0]["started"] - died,
        restart_checkpoint_load_s=second[0]["load_s"],
        fit_to_first_report_s=first[0]["time"] - t_fit, fit_s=fit_s,
        resumed_loss_max_gap=resumed_gap, first_attempt_loss_max_gap=first_gap,
        losses_reference=ref_losses,
        losses_trainer=[r["loss"] for r in reports],
        worker_pids=sorted({r["pid"] for r in reports}))
    # the wait for the next batch, a step: in the worker (step 1 of each
    # attempt includes the plan's first output: the shuffle) and in process
    waits = [r["batch_wait_s"] for r in reports]
    row.update(
        worker_batch_wait_ms_median=float(np.median(waits)) * 1e3,
        worker_batch_wait_ms_max=float(max(waits)) * 1e3,
        worker_batch_wait_ms_median_after_first=float(np.median(
            [r["batch_wait_s"] for r in reports
             if r["step"] not in (1, TRAINER_CKPT_STEP + 1)])) * 1e3,
        resumed_skip_s=second[0]["skip_s"],
        ref_batch_wait_ms_median=float(np.median(ref_wait)) * 1e3,
        ref_batch_wait_ms_max=float(max(ref_wait)) * 1e3,
        step_ms_over_in_process=(row["trainer_step_ms_median"]
                                 / row["ref_step_ms_median"]))
    print(f"[trainer] {json.dumps(row)} on {card}", flush=True)
    want = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]
    bad = [(r["step"], r["launches"]) for r in reports
           if r["launches"] != want]
    if bad:
        raise AssertionError(f"worker launches (fwd, dkv, dq) {bad}, "
                             f"expected {want} a step")
    if resumed_gap > TRAINER_LOSS_TOL or first_gap > TRAINER_LOSS_TOL:
        raise AssertionError(f"trainer losses off the in-process run by "
                             f"{first_gap} (first attempt) / {resumed_gap} "
                             f"(resumed), limit {TRAINER_LOSS_TOL}")
    if not all(r["resumed"] for r in second) or any(r["resumed"]
                                                    for r in first):
        raise AssertionError("the restarted attempt did not see "
                             "get_checkpoint()")
    if len(set(row["worker_pids"])) != 2:
        raise AssertionError(f"worker pids {row['worker_pids']}: the gang "
                             "was not restarted in a new process")
    # the resumed attempt reported no checkpoint: the result has none, as
    # the reference's; the latest complete one is step 4's
    want_ckpt = os.path.join(result.path, "checkpoint_000000")
    if ckpt_dirs != ["checkpoint_000000"] or result.checkpoint is not None:
        raise AssertionError(f"Result.checkpoint {result.checkpoint}, "
                             f"checkpoint dirs {ckpt_dirs}: expected None "
                             f"and step {TRAINER_CKPT_STEP}'s dir only")
    if latest != want_ckpt:
        raise AssertionError(f"_latest_checkpoint gave {latest}, expected "
                             f"the complete {want_ckpt}")
    if not all(np.isfinite(r["loss"]) for r in reports):
        raise AssertionError("a trainer loss is not finite")
    return row


def _ingest_pass(ds, b, device):
    """One pass over the plan's batches into ``device`` at batch ``b``,
    keeping every batch (no sync until the end); returns the batches and
    the seconds to the first batch and to the last (synchronised)."""
    it = ds.iterator()
    t0 = time.perf_counter()
    out, first_s = [], None
    for batch in _token_batches(it, b, device):
        if first_s is None:
            first_s = time.perf_counter() - t0
        out.append(batch["tokens"])
    if device == "cuda":
        torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    return out, first_s, total_s


def _h2d_profile(ds, b):
    """One more pass into the card at batch ``b``, under ``torch.profiler``:
    the host-to-device copies from the trace's HtoD memcpy records (their
    count and device ms), and the bytes they moved (the batches' tokens,
    uploaded as the corpus's uint16)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got, _, _ = _ingest_pass(ds, b, "cuda")
    copies, copy_ms = 0, 0.0
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy HtoD" in evt.key):
            copies += evt.count
            copy_ms += evt.self_device_time_total / 1e3
    if copies < len(got) or copy_ms <= 0:
        raise AssertionError(f"batch {b}: the trace holds {copies} HtoD "
                             f"copies ({copy_ms} ms) for {len(got)} batches")
    nbytes = sum(g.numel() for g in got) * np.dtype(np.uint16).itemsize
    return dict(h2d_copies=copies, h2d_bytes=nbytes, h2d_copy_ms=copy_ms,
                h2d_gb_per_s=nbytes / copy_ms / 1e6)


def phase_data_ingest(card, corpus, corpus_sum, seed=0, device="cuda",
                      batches=INGEST_BATCHES):
    """The trainer's plan (read the shards, seeded shuffle, ``tokens``)
    over the whole corpus into the card, once at each batch size: rows/s,
    MB/s of the corpus and the time to the first batch; then a pass under
    ``torch.profiler`` for the host-to-device copies' device time and GB/s.
    Every batch on the card must equal the same batch of a pass with
    ``device="cpu"``, and the sum of all tokens the corpus's (numpy)."""
    import ray_tpu_torch

    corpus_bytes = sum(os.path.getsize(f) for f in glob.glob(
        os.path.join(corpus, "*.npy")))
    rows_total = CORPUS_SHARDS * CORPUS_ROWS
    ray_tpu_torch.init()
    try:
        ds = corpus_dataset(corpus, seed)
        rows = []
        for b in batches:
            got, first_s, total_s = _ingest_pass(ds, b, device)
            want, cpu_first_s, cpu_s = _ingest_pass(ds, b, "cpu")
            if len(got) != len(want) or len(got) != rows_total // b:
                raise AssertionError(f"batch {b}: {len(got)} batches on "
                                     f"{device}, {len(want)} on the CPU, "
                                     f"expected {rows_total // b}")
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if g.device.type != device or g.dtype != torch.int64
                   or not torch.equal(g.cpu(), w)]
            if bad:
                raise AssertionError(f"batch {b}: batches {bad[:8]} on "
                                     f"{device} differ from the CPU pass")
            tok_sum = int(sum(int(g.sum()) for g in got))
            if tok_sum != corpus_sum:
                raise AssertionError(f"batch {b}: token sum {tok_sum}, the "
                                     f"corpus's {corpus_sum}")
            del got, want
            row = dict(batch=b, batches=rows_total // b, rows=rows_total,
                       first_batch_s=first_s, pass_s=total_s,
                       rows_per_s=rows_total / total_s,
                       corpus_mb_per_s=corpus_bytes / total_s / 1e6,
                       cpu_pass_s=cpu_s, cpu_first_batch_s=cpu_first_s)
            if device == "cuda":
                row.update(_h2d_profile(ds, b))
            rows.append(row)
        print(f"[data ingest] {json.dumps(rows)} on {card}", flush=True)
        return rows
    finally:
        ray_tpu_torch.shutdown()


def _verb_matrix(n):
    """The verb matrix of ``tests/test_collective.py:75-125`` for ``n``
    entries: (name, call on a group, inputs as a list of lists of CPU
    tensors); roots and pairs fold into ``range(n)``."""
    from ray_tpu_torch.collective.types import ReduceOp

    gen = torch.Generator().manual_seed(0)
    x = [torch.randint(-8, 9, (1 << 20,), generator=gen).float()
         for _ in range(n)]
    rs = [torch.arange(2 * n * 1024, dtype=torch.float32) + i
          for i in range(n)]
    chunks = [[torch.full((1024,), float(10 * i + j)) for j in range(n)]
              for i in range(n)]
    pairs = ([(1, 6), (0, 7)] if n >= 8
             else [(i, (i + 1) % n) for i in range(n)])
    root2, root3 = min(2, n - 1), min(3, n - 1)
    m = []
    for op in ("sum", "mean", "max", "min", "product"):
        m.append((f"allreduce_{op}",
                  lambda g, t, op=op: g.allreduce(t, op=ReduceOp(op)), x))
    m += [("allgather", lambda g, t: g.allgather(t), x),
          ("reducescatter", lambda g, t: g.reducescatter(t), rs),
          (f"reduce_sum_root{root2}",
           lambda g, t: g.reduce(t, root_rank=root2), x),
          ("reduce_max_root0",
           lambda g, t: g.reduce(t, root_rank=0, op=ReduceOp.MAX), x),
          (f"broadcast_root{root3}",
           lambda g, t: g.broadcast(t, root_rank=root3), x),
          ("permute", lambda g, t: g.permute(t, pairs), x),
          ("send", lambda g, t: g.send(t, dst_rank=n - 1, src_rank=0), x),
          ("alltoall", lambda g, t: g.alltoall(t), chunks)]
    return m


def _run_verbs(group, plain, devices, reps=5):
    """Each verb of the matrix on ``group`` with its inputs on ``devices``
    (entry i on ``devices[i]``), held against ``plain`` (the same group's
    plain path on the CPU inputs); the median ms of ``reps`` timed calls.
    Returns {verb: {"max_abs_err", "ms"}}."""
    out = {}
    for name, call, xs in _verb_matrix(len(devices)):
        def place(v, d):
            return ([t.to(d) for t in v] if isinstance(v, list)
                    else v.to(d))
        dev_in = [place(v, d) for v, d in zip(xs, devices)]
        want = call(plain, xs)
        got = call(group, dev_in)
        flat_w = [t for v in want for t in (v if isinstance(v, list)
                                            else [v])]
        flat_g = [t for v in got for t in (v if isinstance(v, list)
                                           else [v])]
        err = max(float((g.cpu() - w).abs().max()) for g, w in
                  zip(flat_g, flat_w))
        tol = 1e-6 if "mean" in name else 0.0
        if len(flat_g) != len(flat_w) or err > tol:
            raise AssertionError(f"collective {name}: max |err| {err} "
                                 f"against the plain version (limit {tol})")
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(group, dev_in)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"max_abs_err": err, "ms": float(np.median(times))}
    return out


class CollectiveOnCard:
    """An actor on the card: a one-process ``XlaDistributedGroup`` (NCCL,
    world size 1) running the verb matrix, held against the plain path."""

    def run(self, group_name):
        import torch

        from ray_tpu_torch.collective import collective as col

        g = col.init_collective_group(1, 0, "xla_distributed", group_name,
                                      device="cuda")
        try:
            import torch.distributed as dist

            backend = dist.get_backend()
            plain = col.XlaGroup(1, 0, group_name + "_plain", device="cpu")
            verbs = _run_verbs(g, plain, [torch.device("cuda", 0)])
            g.barrier()
            return {"backend": backend, "verbs": verbs}
        finally:
            col.destroy_collective_group(group_name)


def phase_collective(card):
    """``XlaGroup`` over the cards this process sees (``torch.cuda.nccl``,
    copies between cards) and a one-actor ``XlaDistributedGroup`` over NCCL
    run the verb matrix, each held against the plain version on the same
    inputs (tolerance 0; 1e-6 for the mean). NCCL refuses two ranks on one
    card, so a group across cards waits for several cards (ROADMAP.md queue
    1 item 5)."""
    import ray_tpu_torch
    from ray_tpu_torch.collective import collective as col

    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n)]
    local = _run_verbs(col.XlaGroup(n, 0, "smoke_local"),
                       col.XlaGroup(n, 0, "smoke_plain", device="cpu"),
                       devices)
    ray_tpu_torch.init()
    try:
        col.create_collective_group([], 1, [0], "xla_distributed",
                                    "smoke_dist")
        actor = ray_tpu_torch.remote(CollectiveOnCard).options(
            **ON_CARD).remote()
        try:
            dist_out = ray_tpu_torch.get(actor.run.remote("smoke_dist"),
                                         timeout=600)
        finally:
            ray_tpu_torch.kill(actor)
    finally:
        ray_tpu_torch.shutdown()
    if dist_out["backend"] != "nccl":
        raise AssertionError(f"distributed group on {dist_out['backend']}, "
                             "expected nccl")
    row = {"cards": n, "xla_group": local,
           "xla_distributed_group_nccl_world1": dist_out["verbs"]}
    print(f"[collective card] {json.dumps(row)} on {card}", flush=True)
    return row


# kernel name patterns -> the layer they belong to, first match wins
KERNEL_GROUPS = (("attention fwd (kernel 1)", ("flash_fwd",)),
                 ("attention dK/dV (kernel 2)", ("flash_bwd_dkv",)),
                 ("attention dQ (kernel 3)", ("flash_bwd_dq",)),
                 ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
                 ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass",
                                      "sm90_")))


def _device_breakdown(fn, step_ms):
    """Device time of one call of ``fn`` by kernel group, from
    ``torch.profiler``: (device ms, {group: ms}, top kernels). Only the
    device's own activity counts (kernels, copies, memsets): a user
    annotation such as ``Optimizer.step#AdamW.step`` is also a CUDA-typed
    event, spanning kernels already counted. The busy share is taken
    against ``step_ms``, the unprofiled step time; the device time cannot
    exceed the profiled call's own wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, kernels = {}, []
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.is_user_annotation):
            continue
        ms = evt.self_device_time_total / 1e3
        kernels.append((ms, evt.key, evt.count))
        group = next((g for g, pats in KERNEL_GROUPS
                      if any(pat in evt.key for pat in pats)),
                     "other (elementwise, norms, loss, copies)")
        groups[group] = groups.get(group, 0.0) + ms
    total = sum(groups.values())
    top = [dict(kernel=k[:80], ms=m, calls=n)
           for m, k, n in sorted(kernels, reverse=True)[:8]]
    print(f"[train-profile] one step: device time {total:.1f} ms of "
          f"{step_ms:.1f} ms (busy share {total / step_ms:.3f}; the profiled "
          f"step {wall_ms:.1f} ms); by group {json.dumps(groups)}; top "
          f"kernels {json.dumps(top)}", flush=True)
    if total > wall_ms:
        raise AssertionError(f"device time {total:.1f} ms over the profiled "
                             f"step's {wall_ms:.1f} ms: counted twice")
    return total, groups, top


def _kernel_row(name, source, replaces, launches, err, ms, plain_ms,
                bound, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _mix_row(name, source, replaces, launches, rows, mix):
    """The kernels-line row of a kernel whose main path runs several
    shapes: ``mix`` maps kernel cases to the main path's launches at their
    shape, and each time is the mean a launch over that mix."""
    if sum(mix.values()) != launches:
        raise AssertionError(f"{name}: the main path's {launches} launches "
                             f"are not the mix {mix}")

    def mean(key):
        if any(rows[c].get(key) is None for c in mix):
            return None
        return sum(n * rows[c][key] for c, n in mix.items()) / launches

    by = max(mix, key=lambda c: mix[c] * rows[c]["bound_ms"])
    row = _kernel_row(name, source, replaces, launches,
                      max(rows[c]["max_abs_err"] for c in mix), mean("ms"),
                      mean("plain_ms"), (mean("bound_ms"),
                                         rows[by]["bound_by"]),
                      mean("library_ms"))
    row.update(busy_ms=mean("busy_ms"),
               library_busy_ms=mean("library_busy_ms"), cases=mix)
    for key in ("sdpa_without_softcap_ms", "sdpa_bwd_without_softcap_ms"):
        if mean(key) is not None:
            row[key] = mean(key)
    return row


def _bwd_kernel_rows(rows, kernel):
    """The backward phase's rows seen as one kernel's (``dq`` or ``dkv``),
    in the keys ``_mix_row`` reads."""
    return {case: dict(max_abs_err=r["max_abs_err"][kernel],
                       ms=r[f"{kernel}_ms"], busy_ms=r[f"{kernel}_busy_ms"],
                       plain_ms=r["plain_ms"],
                       bound_ms=r[f"{kernel}_bound_ms"],
                       bound_by=r[f"{kernel}_bound_by"],
                       library_ms=r["library_ms"],
                       library_busy_ms=r["library_busy_ms"],
                       sdpa_bwd_without_softcap_ms=r.get(
                           "sdpa_bwd_without_softcap_ms"))
            for case, r in rows.items()}


def _phase(label, fn, *args, **kw):
    """Run one phase and print its seconds (a failure raises through)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"[phase] {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    card = _phase("device", phase_device)
    _phase("build", phase_build)
    fwd = _phase("kernels", phase_kernels)
    bwd = _phase("bwd kernels", phase_bwd_kernels)
    _phase("small forward", phase_small_forward)
    _phase("small train", phase_small_train)
    _phase("small train d256", phase_small_train, head_dim=256)
    _phase("small train save_attn", phase_small_train,
           remat_policy="save_attn")
    _phase("small train d256 save_attn", phase_small_train, head_dim=256,
           remat_policy="save_attn")
    cfg, params, launches, fwd_ref = _phase("llama3_8b forward",
                                            phase_forward, card)
    served = _phase("llama3_8b serving", phase_serving, cfg, params, card)
    _phase("llama3_8b serving telemetry", phase_serving_telemetry, cfg,
           params, card, served["captured"])
    plain_f32 = _phase("llama3_8b serving f32", phase_greedy_f32, cfg,
                       params, card)
    _phase("llama3_8b speculate", phase_speculate, cfg, params, card,
           plain_f32)
    _phase("llama3_8b export/adopt", phase_export_adopt, cfg, params, card)
    mux = _phase("llama3_8b multiplex", phase_multiplex, cfg, params, card)
    # the serving path through the framework: runtime, object store, Serve
    # (and the multiplexed replica)
    colocated = _phase(
        "llama3_8b serve (runtime)", phase_serve_runtime, cfg, params, card,
        fwd_ref, {k: v[1] for k, v in served["captured"].items()
                  if k in ("ttft_p50_ms", "tpot_p50_ms", "tokens_per_s")}, mux)
    del params
    torch.cuda.empty_cache()
    # disaggregated serving: three replicas of llama3_8b share the card, so
    # this process holds no weights of its own meanwhile
    _phase("llama3_8b disagg (runtime)", phase_disagg_runtime, card,
           colocated)
    counts, full_row = _phase("llama_1b training", phase_train, card)
    torch.cuda.empty_cache()
    _phase("llama_1b training save_attn", phase_train_save_attn, card,
           full_row)
    torch.cuda.empty_cache()
    # the same model and batch shape through the framework: TorchTrainer,
    # its batches from a dataset over a token corpus; then that plan alone
    # into the card, and the collectives
    corpus = tempfile.mkdtemp(prefix="chip-smoke-corpus-")
    try:
        corpus_sum = write_corpus(corpus, models.get_config(
            "llama-1b").vocab_size)
        _phase("llama_1b trainer", phase_trainer, card, corpus)
        torch.cuda.empty_cache()
        _phase("data ingest", phase_data_ingest, card, corpus, corpus_sum)
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    torch.cuda.empty_cache()
    _phase("collective (card)", phase_collective, card)
    gemma_train = gemma2_train_config()
    counts_d256, _ = _phase("gemma2_9b training (8 layers)", phase_train,
                            card, cfg=gemma_train, b=1, l=8192)
    torch.cuda.empty_cache()
    # the training step's attention shapes: 4096-window and global layers
    # at B=1, L=8192, each a backward case; launches over the timed steps
    n_window = sum(1 for w in gemma_train.layer_windows if w)
    train_mix = {
        "gemma2_train_window4096_L8192_softcap50_d256": n_window * TRAIN_STEPS,
        "gemma2_train_global_L8192_softcap50_d256":
            (gemma_train.n_layers - n_window) * TRAIN_STEPS}
    cfg, params, launches_d256, _ = _phase("gemma2_9b forward",
                                           phase_forward, card, "gemma2-9b",
                                           b=1, l=8192)
    # the forward's attention shapes: 4096-window and global layers at
    # B=1, L=8192, each a kernel case
    n_window = sum(1 for w in cfg.layer_windows if w == 4096)
    d256_mix = {"gemma2_window4096_L8192_softcap50_d256": n_window,
                "gemma2_global_L8192_softcap50_d256":
                    sum(1 for w in cfg.layer_windows if not w)}
    # the dense engine and both float32 checks at a cut depth (views of the
    # first layers): the smoke's time limit
    cut = _draft_of(cfg, params, GEMMA2_DENSE_LAYERS)
    half = _draft_of(cfg, params, GEMMA2_PAGED_LAYERS)
    for paged in (True, False):
        kind = "paged" if paged else "dense"
        c, p = half if paged else cut
        _phase(f"gemma2_9b serving {kind}", phase_serving, c, p, card,
               paged=paged)
        _phase(f"gemma2_9b serving {kind} f32", phase_greedy_f32, *cut, card,
               paged=paged)
    del cut
    _phase("gemma2_9b generate", phase_generate, *half, card, b=2,
           prompt_len=256, new_tokens=32)
    del half, params
    torch.cuda.empty_cache()
    cfg, params, _ = _bf16_weights("mistral-7b", seed=0)
    _phase("mistral_7b generate", phase_generate,
           *_draft_of(cfg, params, MISTRAL_GENERATE_LAYERS), card, b=1,
           prompt_len=4608, new_tokens=16)
    del params
    torch.cuda.empty_cache()
    print(f"[smoke] all phases: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    src = "ray_tpu_torch/ops/csrc/"
    d128 = fwd["causal"]
    bwd_main = bwd["train_causal"]
    print(json.dumps({"kernels": [
        _kernel_row("flash_attention_fwd", src + "flash_fwd.cu",
                    "ray_tpu/ops/flash_pallas.py:63", launches,
                    d128["max_abs_err"], d128["ms"], d128["plain_ms"],
                    (d128["bound_ms"], d128["bound_by"]), d128["library_ms"]),
        # head dim 256: the gemma2_9b forward's window and global layers;
        # library_ms is flex_attention's with the softcap
        _mix_row("flash_attention_fwd_d256", src + "flash_fwd.cu",
                 "ray_tpu/ops/flash_pallas.py:63", launches_d256, fwd,
                 d256_mix),
        _kernel_row("flash_attention_bwd_dkv", src + "flash_bwd.cu",
                    "ray_tpu/ops/flash_pallas.py:230", counts["dkv"],
                    bwd_main["max_abs_err"]["dkv"], bwd_main["dkv_ms"],
                    bwd_main["plain_ms"], (bwd_main["dkv_bound_ms"],
                                           bwd_main["dkv_bound_by"]),
                    bwd_main["library_ms"]),
        _kernel_row("flash_attention_bwd_dq", src + "flash_bwd.cu",
                    "ray_tpu/ops/flash_pallas.py:286", counts["dq"],
                    bwd_main["max_abs_err"]["dq"], bwd_main["dq_ms"],
                    bwd_main["plain_ms"], (bwd_main["dq_bound_ms"],
                                           bwd_main["dq_bound_by"]),
                    bwd_main["library_ms"]),
        # head dim 256: the Gemma-2 training step's window and global
        # layers; library_ms is flex_attention's softcapped backward (SDPA's
        # without the cap is sdpa_bwd_without_softcap_ms)
        _mix_row("flash_attention_bwd_dkv_d256", src + "flash_bwd.cu",
                 "ray_tpu/ops/flash_pallas.py:230", counts_d256["dkv"],
                 _bwd_kernel_rows(bwd, "dkv"), train_mix),
        _mix_row("flash_attention_bwd_dq_d256", src + "flash_bwd.cu",
                 "ray_tpu/ops/flash_pallas.py:286", counts_d256["dq"],
                 _bwd_kernel_rows(bwd, "dq"), train_mix)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-runtime-driver"]:
        serve_runtime_driver(sys.argv[2], mux_budget=(
            int(sys.argv[3]) if len(sys.argv) > 3 else None))
    elif sys.argv[1:2] == ["--disagg-driver"]:
        disagg_driver(sys.argv[2])
    else:
        main()
