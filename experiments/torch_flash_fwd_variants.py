"""Variants of the port's bf16 flash-attention forward kernel, timed on the card.

    python3 experiments/torch_flash_fwd_variants.py [--serve] [VARIANT ...]

Each variant is ``ray_tpu_torch/ops/csrc/flash_fwd.cu`` with a few lines
changed, built into a library of its own under ``ray_tpu_torch/_build/`` and
run in a process of its own (a fault in one cannot touch the next). Each
holds the kernel against its plain version and times it at the main path's
shapes with ``chip_smoke.phase_kernels`` (one call between CUDA events, and
calls back to back). Variants, in the order run when none is named:

- ``kernel``: the source as it is;
- ``p_hilo``: P enters the PV product as a bf16 hi + lo pair (two products
  a k-step), as the forward kernel before the wgmma design did;
- ``pingpong``: the two consumer warpgroups take turns for S = Q K^T (named
  barriers 1 and 2; the turn passes once S is complete);
- ``stages3``: a three-stage K/V ring;
- ``three_consumers``: 192-row q tiles, three consumer warpgroups of 64 rows
  (512 threads; ``setmaxnreg`` asks 160 registers for the consumers);
- diagnostics, whose output is wrong by construction (their rows fail the
  check, which is reported and ignored): ``no_reload`` (the producer loads
  the first ring stages only and then re-arms the barriers), ``no_softmax``
  (P is the raw scores) and ``no_products`` (no wgmma: loads and softmax).

``--serve`` adds, for ``kernel`` and ``p_hilo``, the time of a llama3_8b
forward (B=2, L=2048) and the bf16 greedy agreement of chip_smoke's serving
phase with the kernel-backed forward. Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MAIN_CASES = ("causal", "train_causal", "ragged_L200")

_HILO_PACK = '''// P as a bf16 hi + lo pair: hi + lo holds 16 significant bits of P
__device__ __forceinline__ void pack_p_hilo(const float (&acc)[kBN / 2],
                                            uint32_t (&pa)[kBN / 16][4],
                                            uint32_t (&lo)[kBN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float x0 = acc[8 * kk + 2 * e], x1 = acc[8 * kk + 2 * e + 1];
            const float2 hf = __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
            pa[kk][e] = pack_bf16(x0, x1);
            lo[kk][e] = pack_bf16(x0 - hf.x, x1 - hf.y);
        }
    }
}

'''
_KERNEL = "template <int D>\n__global__ void __launch_bounds__(kBf16Threads, 1)"

# (old, new) replacements; each old text must occur exactly once
VARIANTS = {
    "kernel": [],
    "p_hilo": [
        ("                uint32_t pa[kBN / 16][4];\n                pack_p(acc, pa);\n",
         "                uint32_t pa[kBN / 16][4], pa_lo[kBN / 16][4];\n"
         "                pack_p_hilo(acc, pa, pa_lo);\n"),
        ("issue_pv<D>(o, pa, v_addr", "issue_pv<D>(o, pa, pa_lo, v_addr"),
        ("const uint32_t (&pa)[kBN / 16][4],\n                                         uint32_t v_tile)",
         "const uint32_t (&pa)[kBN / 16][4],\n                                         "
         "const uint32_t (&pa_lo)[kBN / 16][4], uint32_t v_tile)"),
        ("            wgmma_m64n128k16_rs_tb(o, pa[kk], vd);\n",
         "            wgmma_m64n128k16_rs_tb(o, pa[kk], vd), wgmma_m64n128k16_rs_tb(o, pa_lo[kk], vd);\n"),
        ("            wgmma_m64n64k16_rs_tb(o, pa[kk], vd);\n",
         "            wgmma_m64n64k16_rs_tb(o, pa[kk], vd), wgmma_m64n64k16_rs_tb(o, pa_lo[kk], vd);\n"),
        (_KERNEL, _HILO_PACK + _KERNEL),
    ],
    "pingpong": [
        ("            mbar_wait(q_full, 0);\n",
         "            mbar_wait(q_full, 0);\n"
         "            if (cw == 1) asm volatile(\"bar.arrive 1, 256;\" ::: \"memory\");\n"),
        ("                issue_qk<D>(acc, q_addr, k_addr + s * S::kTileBytes);\n"
         "                wgmma_wait<0>();\n                fence_regs(acc);\n",
         "                asm volatile(\"bar.sync %0, 256;\" ::\"r\"(1 + cw) : \"memory\");\n"
         "                issue_qk<D>(acc, q_addr, k_addr + s * S::kTileBytes);\n"
         "                wgmma_wait<0>();\n                fence_regs(acc);\n"
         "                if (i + 1 < n_tiles || cw == 0)\n"
         "                    asm volatile(\"bar.arrive %0, 256;\" ::\"r\"(2 - cw) : \"memory\");\n"),
    ],
    "stages3": [("constexpr int kStages = 2; ", "constexpr int kStages = 3; ")],
    "three_consumers": [
        ("constexpr int kConsumers = 2; ", "constexpr int kConsumers = 3; "),
        ("constexpr int kConsumerRegs = 240;", "constexpr int kConsumerRegs = 160;"),
    ],
    "no_reload": [
        ("                mbar_wait(k_empty + s, parity);\n",
         "                if (i >= kStages) {\n"
         "                    mbar_wait(k_empty + s, parity);\n"
         "                    mbar_arrive(k_full + s);\n"
         "                    mbar_wait(v_empty + s, parity);\n"
         "                    mbar_arrive(v_full + s);\n"
         "                    continue;\n"
         "                }\n"
         "                mbar_wait(k_empty + s, parity);\n"),
    ],
    "no_softmax": [
        ("                softmax_tile(p, acc, m2, l, alpha, (kt_begin + i) * kBN, qw, rows, cq);\n"
         "                rescale(o, alpha);\n", ""),
    ],
    "no_products": [
        ("                issue_qk<D>(acc, q_addr, k_addr + s * S::kTileBytes);\n"
         "                wgmma_wait<0>();\n", ""),
        ("                issue_pv<D>(o, pa, v_addr + s * S::kTileBytes);\n"
         "                wgmma_wait<0>();\n",
         "                for (int kk = 0; kk < kBN / 16; ++kk)\n"
         "                    for (int e = 0; e < 4; ++e) asm volatile(\"\" ::\"r\"(pa[kk][e]));\n"),
    ],
}
DIAGNOSTIC = ("no_reload", "no_softmax", "no_products")


def variant_source(name: str, csrc: Path, out: Path) -> Path:
    """A copy of ``csrc`` in ``out`` with ``flash_fwd.cu`` patched."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    text = (out / "flash_fwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the text to replace occurs "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    (out / "flash_fwd.cu").write_text(text)
    return out


def run_one(name: str, serve: bool) -> None:
    import torch

    import chip_smoke
    from ray_tpu_torch import models
    from ray_tpu_torch.ops import _build

    card = chip_smoke.phase_device()
    _build._CSRC = variant_source(name, _build._CSRC,
                                  _build.BUILD_DIR / "variants" / name)
    _build.build(["flash_fwd"])
    for kernel, info in chip_smoke._ptxas_table(
            _build.build_log.get("flash_fwd", "")).items():
        if "bf16" in kernel:
            print(f"[variant {name}] {kernel}: {info}", flush=True)
    for case in (c for c in chip_smoke.KERNEL_CASES if c[0] in MAIN_CASES):
        chip_smoke.KERNEL_CASES = [case]
        try:
            chip_smoke.phase_kernels()
        except AssertionError as err:
            if name not in DIAGNOSTIC:
                raise
            print(f"[variant {name}] output wrong by construction: "
                  f"{str(err)[:80]}", flush=True)
    if serve:
        cfg, params, _ = chip_smoke.phase_forward(card)
        gen = torch.Generator(device="cuda").manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 2048), device="cuda",
                             generator=gen)
        with torch.inference_mode():
            ms = chip_smoke._median_ms(lambda: models.forward(params, toks, cfg),
                                       iters=3, warmup=1)
        print(f"[variant {name}] llama3_8b forward B=2 L=2048: {ms:.1f} ms "
              f"on {card}", flush=True)
        chip_smoke.phase_serving(cfg, params, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.serve)
        return 0
    failed = []
    for name in args.variants:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name}; known: {list(VARIANTS)}")
        cmd = [sys.executable, __file__, "--one", name]
        if args.serve and name in ("kernel", "p_hilo"):
            cmd.append("--serve")
        print(f"=== {name}", flush=True)
        if subprocess.run(cmd, cwd=ROOT).returncode != 0:
            failed.append(name)
    if failed:
        print(f"failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
