"""Drive the PyTorch + CUDA port on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the port's CUDA sources with nvcc from this checkout;
3. kernels: hold each kernel against its plain PyTorch version on the card,
   at the shapes the model runs, and time kernel, plain version, the
   PyTorch library call that computes the same function, and the bound;
4. forward: a small float32 forward on the card against the CPU, then
   ``models.forward`` at Llama-3-8B width (random bf16 weights from a
   seeded generator, all 32 layers) through the flash-attention kernel;
5. serving: the paged ``LLMEngine`` answers 8 requests on the same weights
   (prefix-cache hit, no leaked blocks), and its greedy tokens are held
   against the kernel-backed forward, in bf16 and again in float32.

It prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from ray_tpu_torch import models
from ray_tpu_torch.ops import _build, flash_cuda
from ray_tpu_torch.serve import LLMEngine

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


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return card.splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    _build.build()
    dt = time.perf_counter() - t0
    print(f"[build] {len(_build.SOURCES)} source(s) in {dt:.1f} s", flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)


# (name, B, Lq, Lk, H, Hk, D, dtype, causal, window, softcap)
KERNEL_CASES = [
    ("causal", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None, 0.0),
    ("full", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, False, None, 0.0),
    ("window4096_L8192", 2, 8192, 8192, 32, 8, 128, torch.bfloat16, True,
     4096, 0.0),
    ("window48_L256", 2, 256, 256, 32, 8, 128, torch.bfloat16, True, 48, 0.0),
    ("softcap50", 2, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None, 50.0),
    ("ragged_L1000", 2, 1000, 1000, 32, 8, 128, torch.bfloat16, True, None,
     0.0),
    ("ragged_q700_k1000_d64_full", 2, 700, 1000, 16, 4, 64, torch.bfloat16,
     False, None, 0.0),
    ("f32_window48_softcap", 1, 300, 300, 8, 2, 128, torch.float32, True, 48,
     50.0),
    ("f32_d64", 1, 512, 512, 8, 2, 64, torch.float32, True, None, 0.0),
]
# bf16: the kernel rounds out to bf16 (one step is 2**-7 relative) where the
# plain version keeps f32; lse is f32 in both. f32: exact f32 FMAs summed in
# another order.
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}


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


def _library_call(q, k, v, causal, window, softcap):
    """One PyTorch call computing the same attention, as a yardstick only
    (the port never calls it); None where no single call does (softcap)."""
    if softcap:
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (rows >= cols) & (rows - cols < window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=mask,
                        is_causal=bool(causal and mask is None),
                        enable_gqa=True)


def phase_kernels():
    """Kernel against its plain version on every case; returns the timing
    row of the main-path case (the first)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (name, b, lq, lk, h, hk, d, dtype, causal, window, softcap) in KERNEL_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v = rnd(b, lq, h, d), rnd(b, lk, hk, d), rnd(b, lk, hk, d)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = flash_cuda.flash_attention_fwd(q, k, v, **kw)
        ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_out, tol_lse = TOL[dtype]
        ms = _median_ms(lambda: flash_cuda.flash_attention_fwd(q, k, v, **kw))
        plain_ms = _median_ms(
            lambda: flash_cuda.flash_attention_fwd_reference(q, k, v, **kw),
            iters=3, warmup=1)
        lib = _library_call(q, k, v, causal, window, softcap)
        library_ms = _median_ms(lib) if lib is not None else None
        bound_ms, bound_by = _bound(q, k, v, causal, window)
        row = dict(case=name, shape=[b, lq, lk, h, hk, d],
                   dtype=str(dtype).replace("torch.", ""), causal=causal,
                   window=window, softcap=softcap, max_abs_err=err_out,
                   max_abs_err_lse=err_lse, tol=[tol_out, tol_lse], ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        print("[kernel] " + json.dumps(row), flush=True)
        if not (err_out <= tol_out and err_lse <= tol_lse):
            raise AssertionError(
                f"flash_attention_fwd disagrees with its plain version on "
                f"{name}: out {err_out:.3g} (tol {tol_out}), lse "
                f"{err_lse:.3g} (tol {tol_lse})")
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return rows[0]


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


def phase_forward(card, seed=0):
    """Llama-3-8B width, all 32 layers, bf16 weights from a seeded
    generator; B=2, L=2048 through the flash-attention kernel."""
    cfg = models.llama3_8b().replace(param_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = models.init_params(gen, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    print(f"[forward] llama3_8b {n_params / 1e9:.3f} B params bf16 on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    b, l = 2, 2048
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
    print(f"[forward] B={b} L={l}: logits {shape} finite={finite}, kernel "
          f"launches {launches} (layers {cfg.n_layers}), first call "
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
    trie); returns [(prompt, emitted items)] and the wall time."""
    sinks = []

    def submit(wave):
        for p in wave:
            sinks.append((p, []))
            eng.submit(p, new_tokens, sinks[-1][1].append)

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
    return sinks, wall


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


def phase_serving(cfg, params, card, seed=0, device="cuda"):
    """The main serving path: 8 requests through the paged engine in the
    model's bf16, at 8 slots, max_len 512, 16-token blocks."""
    eng = LLMEngine(cfg, params, max_slots=8, max_len=512, block_size=16,
                    device=device)
    sinks, wall = _serve(eng, _waves(cfg, seed), NEW_TOKENS)
    state = eng.kv_state()
    adm = state["admission"]
    total = eng.stats["tokens_generated"]
    print(f"[serve] {len(sinks)} requests, {total} tokens in {wall:.2f} s "
          f"({eng.stats['steps']} steps) = {total / wall:.1f} tokens/s; "
          f"TTFT p50 {adm['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{adm['tpot_p50_s'] * 1e3:.1f} ms; prefix {state['prefix']}; "
          f"kv_free {state['kv_free']} + nodes {state['prefix']['nodes']} / "
          f"{state['kv_total']} on {card}", flush=True)
    if state["prefix"]["hits"] < 1:
        raise AssertionError(f"no prefix-cache hit: {state['prefix']}")
    if state["kv_free"] + state["prefix"]["nodes"] != state["kv_total"]:
        raise AssertionError(f"KV blocks leaked: {state}")
    _check_greedy("serve bf16", *_greedy_vs_forward(params, cfg, sinks, device),
                  BF16_AGREE_MIN, BF16_GAP_TOL)
    return dict(tokens_per_s=total / wall, ttft_p50_s=adm["ttft_p50_s"],
                tpot_p50_s=adm["tpot_p50_s"])


def phase_greedy_f32(cfg, params, card, seed=0, device="cuda"):
    """Greedy parity in float32: the same bf16 weights and requests, the
    engine and the forward computing in float32 (the kernel's f32 path)."""
    cfg32 = cfg.replace(dtype="float32")
    eng = LLMEngine(cfg32, params, max_slots=8, max_len=512, block_size=16,
                    device=device)
    sinks, wall = _serve(eng, _waves(cfg32, seed), NEW_TOKENS)
    print(f"[serve f32] {eng.stats['tokens_generated']} tokens in {wall:.2f} s"
          f" on {card}", flush=True)
    _check_greedy("serve f32",
                  *_greedy_vs_forward(params, cfg32, sinks, device),
                  F32_AGREE_MIN, F32_GAP_TOL)


def main():
    card = phase_device()
    phase_build()
    main_row = phase_kernels()
    phase_small_forward()
    cfg, params, launches = phase_forward(card)
    phase_serving(cfg, params, card)
    phase_greedy_f32(cfg, params, card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_pallas.py:63", "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
