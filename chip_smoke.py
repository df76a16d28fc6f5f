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
   copy programs' replays timed);
7. training: one float32 train step of a small gemma-style config on the
   card against the same step on the CPU (head dims 64 and 256), then
   ``TrainLoopHelper`` at Llama-1B width and depth (bf16 compute, f32
   master weights, full remat, B=4, L=4096) for 10 timed steps on one
   batch, through all three kernels, and at Gemma-2-9B width cut to 8
   layers (B=1, L=8192, head dim 256: the D = 256 backward kernels);
   each with its device time by kernel group from ``torch.profiler``;
8. Gemma-2-9B (all 42 layers, head dim 256, bf16 weights): ``models.forward``
   at B=1, L=8192 through the kernel at D = 256; the paged and the dense
   (``paged=False``) engine each answer the 8 requests of phase 6 (eager
   against captured, profiled, as there), greedy tokens held against the
   kernel-backed forward in bf16 and in float32;
   ``models.generate`` (B=2, 256-token prompt, 32 new tokens), its f32
   tokens held against the f32 forward;
9. Mistral-7B (all 32 layers, bf16 weights): ``models.generate`` on a
   4608-token prompt, past the 4096 window, so the ring cache prefills in
   4096 + 512 chunks; 16 new tokens, the f32 ones held against the f32
   forward.

Each phase prints its seconds. The script prints a ``{"kernels": [...]}``
line, the card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import time
import warnings

import numpy as np
import torch

from ray_tpu_torch import models
from ray_tpu_torch.ops import _build, flash_cuda
from ray_tpu_torch.serve import LLMEngine, SpeculativeLLMEngine
from ray_tpu_torch.train import TrainLoopHelper, adamw
from ray_tpu_torch.util import device_plane

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
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
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
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
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
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
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS

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


def phase_forward(card, name="llama3-8b", b=2, l=2048, seed=0):
    """A preset at full width and depth, bf16 weights from a seeded
    generator, through the flash-attention kernel: llama3_8b at B=2,
    L=2048; gemma2_9b (head dim 256, windows 4096 / global, softcaps) at
    B=1, L=8192, where layer 0's 4096 window masks."""
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
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
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
    return cfg, params, launches


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
    whose staging and replay run with syncs as errors."""
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
    return dict(wall_ms=wall_ms, host_ms=host_ms, device_ms=device_ms,
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


def phase_small_train(seed=0, device="cuda", head_dim=None):
    """One float32 ``make_train_step`` step (through ``TrainLoopHelper``)
    of a gemma-style config (GQA, alternating windows 48/global, attention
    and logit softcaps, tied embeddings, full remat) on the card, its f32
    kernels, against the same step on the CPU, the plain versions, from
    the same weights and batch. ``head_dim=256`` (Gemma-2's) takes 2 q
    heads and 1 kv head in place of 4 and 2 of width 64."""
    heads = dict(n_heads=4, n_kv_heads=2) if head_dim is None else dict(
        n_heads=2, n_kv_heads=1, head_dim=head_dim)
    cfg = models.gemma_debug().replace(
        d_model=256, d_ff=512, vocab_size=512, attn_windows=(48, 0),
        dtype="float32", param_dtype="float32", remat=True, **heads)
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
          f"card vs CPU: loss "
          f"{got['loss']:.6f} vs {want['loss']:.6f}; errors "
          f"{json.dumps(err)} (tol {json.dumps(SMALL_TRAIN_TOL)}); card "
          f"launches fwd/dq/dkv {got['launches']}, CPU {want['launches']}",
          flush=True)
    if any(err[k] > SMALL_TRAIN_TOL[k] for k in err):
        raise AssertionError(f"small train step: card and CPU disagree {err}")
    # two layers, forward recomputed under remat: 4 forward launches and
    # 2 of each backward kernel on the card, none on the CPU
    if got["launches"] != [4, 2, 2] or want["launches"] != [0, 0, 0]:
        raise AssertionError(f"small train step launches: card "
                             f"{got['launches']}, CPU {want['launches']}")


TRAIN_STEPS = 10


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


def phase_train(card, seed=0, cfg=None, b=4, l=4096, device="cuda"):
    """Llama-1B width and depth (16 layers) at B=4, L=4096 (16,384 tokens a
    step), or another ``cfg`` (Gemma-2-9B width at 8 layers, B=1, L=8192);
    bf16 compute on float32 master weights from a seeded generator, full
    remat, AdamW 1e-4; one fixed random batch. One warm-up ``run_steps``,
    then ``run_steps(batch, 10)`` timed with the launch counts set to 0
    just before it. A NaN or inf at any step would reach the parameters
    through AdamW and every later loss, so a finite loss after the 10 steps
    covers each of them."""
    cfg = cfg or models.llama_1b()
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
               mfu=flops_token * b * l / step_s / PEAK_BF16_FLOPS,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss_before=loss0, loss_after=loss, grad_norm=grad_norm,
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in counts.items()})
    print(f"[train] {json.dumps(row)} on {card}", flush=True)
    if device == "cuda":
        _device_breakdown(lambda: helper.run_steps(batch, 1), row["step_ms"])
    want = dict(fwd=2 * cfg.n_layers, dkv=cfg.n_layers, dq=cfg.n_layers)
    if row["launches_per_step"] != want:
        raise AssertionError(f"launches per step {row['launches_per_step']},"
                             f" expected {want}")
    if not (np.isfinite(loss) and np.isfinite(grad_norm) and loss < loss0):
        raise AssertionError(f"training did not progress: loss {loss0} -> "
                             f"{loss}, grad norm {grad_norm}")
    return counts


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
    card = _phase("device", phase_device)
    _phase("build", phase_build)
    fwd = _phase("kernels", phase_kernels)
    bwd = _phase("bwd kernels", phase_bwd_kernels)
    _phase("small forward", phase_small_forward)
    _phase("small train", phase_small_train)
    _phase("small train d256", phase_small_train, head_dim=256)
    cfg, params, launches = _phase("llama3_8b forward", phase_forward, card)
    _phase("llama3_8b serving", phase_serving, cfg, params, card)
    plain_f32 = _phase("llama3_8b serving f32", phase_greedy_f32, cfg,
                       params, card)
    _phase("llama3_8b speculate", phase_speculate, cfg, params, card,
           plain_f32)
    _phase("llama3_8b export/adopt", phase_export_adopt, cfg, params, card)
    del params
    torch.cuda.empty_cache()
    counts = _phase("llama_1b training", phase_train, card)
    torch.cuda.empty_cache()
    gemma_train = gemma2_train_config()
    counts_d256 = _phase("gemma2_9b training (8 layers)", phase_train, card,
                         cfg=gemma_train, b=1, l=8192)
    torch.cuda.empty_cache()
    # the training step's attention shapes: 4096-window and global layers
    # at B=1, L=8192, each a backward case; launches over the timed steps
    n_window = sum(1 for w in gemma_train.layer_windows if w)
    train_mix = {
        "gemma2_train_window4096_L8192_softcap50_d256": n_window * TRAIN_STEPS,
        "gemma2_train_global_L8192_softcap50_d256":
            (gemma_train.n_layers - n_window) * TRAIN_STEPS}
    cfg, params, launches_d256 = _phase("gemma2_9b forward", phase_forward,
                                        card, "gemma2-9b", b=1, l=8192)
    # the forward's attention shapes: 4096-window and global layers at
    # B=1, L=8192, each a kernel case
    n_window = sum(1 for w in cfg.layer_windows if w == 4096)
    d256_mix = {"gemma2_window4096_L8192_softcap50_d256": n_window,
                "gemma2_global_L8192_softcap50_d256":
                    sum(1 for w in cfg.layer_windows if not w)}
    for paged in (True, False):
        kind = "paged" if paged else "dense"
        _phase(f"gemma2_9b serving {kind}", phase_serving, cfg, params, card,
               paged=paged)
        _phase(f"gemma2_9b serving {kind} f32", phase_greedy_f32, cfg,
               params, card, paged=paged)
    _phase("gemma2_9b generate", phase_generate, cfg, params, card, b=2,
           prompt_len=256, new_tokens=32)
    del params
    torch.cuda.empty_cache()
    cfg, params, _ = _bf16_weights("mistral-7b", seed=0)
    _phase("mistral_7b generate", phase_generate, cfg, params, card, b=1,
           prompt_len=4608, new_tokens=16)
    del params
    torch.cuda.empty_cache()
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
    main()
