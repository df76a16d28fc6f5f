"""Variants of the port's bf16 flash-attention backward kernels, timed on the card.

    python3 experiments/torch_flash_bwd_variants.py [VARIANT ...]

Each variant is ``ray_tpu_torch/ops/csrc/flash_bwd.cu`` with a few lines
changed, built into a library of its own under ``ray_tpu_torch/_build/`` and
run in a process of its own (a fault in one cannot touch the next). Each
holds the dQ and dK/dV kernels against their plain version and times them
at the main path's shapes with ``chip_smoke.phase_bwd_kernels`` (one call
between CUDA events, and calls back to back). Variants, in the order run
when none is named:

- ``kernel``: the source as it is;
- ``stages3``: a three-stage ring in the dK/dV kernel; the dQ kernel's
  128-row K / V tiles leave no room for a third stage;
- ``dq_tile64``, ``dq_tile64_stages3``: the dQ kernel on 64-row K / V tiles,
  with two and three stages; ``dkv_tile128``: the dK/dV kernel on 128-row
  Q / dO tiles;
- ``dq_lpt_order``, ``dkv_head_order``: each kernel in the other's launch
  order. The dQ kernel takes its heaviest causal tiles first within each
  (batch, head) (the tile on the grid's fastest axis); the dK/dV kernel
  takes them first across every (batch, head) (the slowest axis: longest
  job first);
- at head dim 256 (``--cases`` of D = 256): ``dkv_warp0_refill``, the
  two-sweep dK/dV kernel loading as the other backward kernels do (warp 0
  refills a stage once both warpgroups have released it) instead of the
  last of its 8 warps to release the stage refilling it; ``dq_stages3``, a
  third K / V stage in the dQ kernel (D = 256 only: D = 128's 128-row
  tiles leave no room for it); ``stages3`` above also gives the two-sweep
  kernel a third stage;
- diagnostics, whose output is wrong by construction (their rows fail the
  check, which is reported and ignored), on the D <= 128 kernels and the
  dQ kernel: ``no_reload`` (the first round of each ring is loaded, later
  rounds only re-arm the barriers and reuse the stages), ``no_softmax`` (no
  exponent, one MUFU op a score, on the tiles inside the band: P is the
  log2-unit score there) and ``no_products`` (no wgmma: loads and
  elementwise work only).

``--cases`` names the backward cases to time (chip_smoke's ``BWD_CASES``
and ``gemma2_train_global_L8192_d256``, the Gemma-2 training global
layers' shape without the softcap); the default is the D = 128 main-path
cases. Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MAIN_CASES = ("train_causal", "causal", "ragged_L1000")
# cases beside chip_smoke's (name, B, Lq, Lk, H, Hk, D, dtype, causal,
# window, softcap); the dtype is filled in where torch is imported
EXTRA_CASES = [("gemma2_train_global_L8192_d256", 1, 8192, 8192, 16, 8, 256,
                "bfloat16", True, None, 0.0)]

# keeps values the compiler would otherwise drop once their product is gone
_CONSUME = ("for (int kk = 0; kk < {k} / 16; ++kk)\n"
            "                    for (int e = 0; e < 4; ++e) asm volatile(\"\" ::\"r\"({a}[kk][e]));\n")

_WARP0_DKV = """        release<kDkvStages>(empty, it, lane);
        if (warp == 0 && it + kDkvStages < n_steps) {
            mbar_wait(empty + s, (it / kDkvStages) & 1);
            load_dkv_step<D>(p, smem, &tq, &tdo, full, it + kDkvStages, b, hk, group, n_live,
                             qt_begin, lane);
            __syncwarp();
        }
"""

# (old, new) replacements; each old text must occur exactly once
VARIANTS = {
    "kernel": [],
    "stages3": [("constexpr int kDkvStages = 2; ", "constexpr int kDkvStages = 3; ")],
    "dq_tile64": [("constexpr int kDqBN = 128; ", "constexpr int kDqBN = 64; ")],
    "dq_tile64_stages3": [("constexpr int kDqBN = 128; ", "constexpr int kDqBN = 64; "),
                          ("constexpr int kDqStages = 2; ", "constexpr int kDqStages = 3; ")],
    "dkv_tile128": [("constexpr int kDkvBM = 64; ", "constexpr int kDkvBM = 128; ")],
    "no_softmax": [
        ("                        sc[j] = ex2(fmaf(sc[j], scale_log2, -lse2[(j >> 1) & 1]));\n",
         "                        sc[j] = fmaf(sc[j], scale_log2, -lse2[(j >> 1) & 1]);\n"),
        ("                            const float p0 = ex2(fmaf(st[j], scale_log2, -l2.x * kLog2e));\n"
         "                            const float p1 = ex2(fmaf(st[j + 1], scale_log2, -l2.y * kLog2e));\n",
         "                            const float p0 = fmaf(st[j], scale_log2, -l2.x * kLog2e);\n"
         "                            const float p1 = fmaf(st[j + 1], scale_log2, -l2.y * kLog2e);\n"),
    ],
    "dq_lpt_order": [
        ("    const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;\n"
         "    const int h = blockIdx.y, b = blockIdx.z;\n",
         "    const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;\n"
         "    const int h = blockIdx.x, b = blockIdx.y;\n"),
        ("dim3((p.Lq + kRows - 1) / kRows, p.H, p.B)", "dim3(p.H, p.B, (p.Lq + kRows - 1) / kRows)"),
    ],
    "dkv_head_order": [
        ("    const int k0 = blockIdx.z * kRows;\n"
         "    const int hk = blockIdx.x, b = blockIdx.y;\n",
         "    const int k0 = blockIdx.x * kRows;\n"
         "    const int hk = blockIdx.y, b = blockIdx.z;\n"),
        ("    const int k0 = blockIdx.z * kRows, hk = blockIdx.x, b = blockIdx.y;\n",
         "    const int k0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;\n"),
        ("dim3(p.Hk, p.B, (p.Lk + kRows - 1) / kRows)", "dim3((p.Lk + kRows - 1) / kRows, p.Hk, p.B)"),
    ],
    "no_reload": [
        ("                if (lane == 0) load_tile(i + kDqStages);\n",
         "                if (lane == 0) mbar_arrive(full + s);\n"),
        ("                load_dkv_step<D>(p, smem, &tq, &tdo, full, it + kDkvStages, b, hk, group, n_live,\n"
         "                                 qt_begin, lane);\n",
         "                mbar_arrive(full + s);\n"
         "                if (lane == 0) mbar_arrive(full + s);\n"),
    ],
    "no_products": [
        ("                issue_ss<kBN, D>(sc, q_addr, S::kResSlab, k_tile, S::kTileSlab);  // S = Q K^T\n",
         ""),
        ("                issue_ss<kBN, D>(dp, do_addr, S::kResSlab, v_tile, S::kTileSlab);  // dP = dO V^T\n",
         ""),
        ("                issue_rs<kBN, D>(dq, da, k_tile, S::kTileSlab);\n",
         "                " + _CONSUME.format(k="kBN", a="da")),
        ("                issue_ss<kDkvBM, D>(st, k_addr, S::kResSlab, q_tile, S::kTileSlab);\n"
         "                issue_ss<kDkvBM, D>(dpt, v_addr, S::kResSlab, do_tile, S::kTileSlab);\n",
         ""),
        ("                issue_rs<kDkvBM, D>(dv, pa, do_tile, S::kTileSlab);\n"
         "                issue_rs<kDkvBM, D>(dk, da, q_tile, S::kTileSlab);\n",
         "                " + _CONSUME.format(k="kDkvBM", a="pa")
         + "                " + _CONSUME.format(k="kDkvBM", a="da")),
    ],
    "dkv_warp0_refill": [
        ("        __syncwarp();\n"
         "        uint32_t last = 0;\n"
         "        if (lane == 0) {\n"
         "            mbar_arrive(empty + s);\n"
         "            if (it + kDkvStages < n_steps)\n"
         "                last = atomicAdd(releases + s, 1u) % (4 * kWarpgroups) == 4 * kWarpgroups - 1;\n"
         "        }\n"
         "        if (__shfl_sync(0xffffffffu, last, 0)) {\n"
         "            mbar_wait(empty + s, (it / kDkvStages) & 1);  // every warp's arrival is visible\n"
         "            load_dkv_step<D>(p, smem, &tq, &tdo, full, it + kDkvStages, b, hk, group, n_live,\n"
         "                             qt_begin, lane);\n"
         "        }\n"
         "        __syncwarp();\n", _WARP0_DKV),
    ],
    "dq_stages3": [("constexpr int kDqStages = 2; ", "constexpr int kDqStages = 3; ")],
}
DIAGNOSTIC = ("no_reload", "no_softmax", "no_products")


def variant_source(name: str, csrc: Path, out: Path) -> Path:
    """A copy of ``csrc`` in ``out`` with ``flash_bwd.cu`` patched."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    text = (out / "flash_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the text to replace occurs "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    (out / "flash_bwd.cu").write_text(text)
    return out


def run_one(name: str, cases) -> None:
    import torch

    import chip_smoke
    from ray_tpu_torch.ops import _build

    chip_smoke.phase_device()
    _build._CSRC = variant_source(name, _build._CSRC,
                                  _build.BUILD_DIR / "variants" / f"bwd_{name}")
    _build.build(["flash_fwd", "flash_bwd"])
    for kernel, info in chip_smoke._ptxas_table(
            _build.build_log.get("flash_bwd", "")).items():
        if "bf16" in kernel:
            print(f"[variant {name}] {kernel}: {info}", flush=True)
    for line in _build.build_log.get("flash_bwd", "").splitlines():
        if "Performance Loss" in line:
            print(f"[variant {name}] {line.strip()}", flush=True)
    extra = [c[:7] + (getattr(torch, c[7]),) + c[8:] for c in EXTRA_CASES]
    for case in (c for c in chip_smoke.BWD_CASES + extra if c[0] in cases):
        try:
            chip_smoke.phase_bwd_kernels([case])
        except AssertionError as err:
            if name not in DIAGNOSTIC:
                raise
            print(f"[variant {name}] output wrong by construction: "
                  f"{str(err)[:80]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--cases", default=",".join(MAIN_CASES),
                    help="comma-separated backward case names")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.cases.split(","))
        return 0
    failed = []
    for name in args.variants:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name}; known: {list(VARIANTS)}")
        print(f"=== {name}", flush=True)
        cmd = [sys.executable, __file__, "--one", name, "--cases", args.cases]
        if subprocess.run(cmd, cwd=ROOT).returncode != 0:
            failed.append(name)
    if failed:
        print(f"failed: {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
