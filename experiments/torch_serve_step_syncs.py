"""Syncs and time of one eager engine step of a ``ray_tpu_torch`` tree, on the card.

    python3 experiments/torch_serve_step_syncs.py --root DIR [--model NAME]
        [--dense]

Imports ``ray_tpu_torch`` from ``DIR`` (this checkout, or another tree of
the port unpacked beside it, e.g. a parent commit's ``git archive``), fills
a paged (or, with ``--dense``, dense) ``LLMEngine`` of the model at full
width and depth (random bf16 weights from a seeded generator) with one
16-token request a slot, steps it until every slot decodes, then prints one
JSON line for a full-batch decode step run eagerly: the syncs it makes
(``torch.cuda.set_sync_debug_mode("warn")``), and the median wall time of
five steps (host clock; every step ends in a copy to the host that waits).
The engine runs its programs eagerly in either tree (a tree with the
``cuda_graphs`` option is given ``cuda_graphs=False``).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
import warnings

# the warning each sync makes under set_sync_debug_mode("warn")
SYNC_WARNING = "called a synchronizing CUDA operation"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--model", default="gemma2-9b")
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from ray_tpu_torch import models
    from ray_tpu_torch.serve import LLMEngine

    cfg = models.get_config(args.model).replace(param_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_params(gen, cfg, device="cuda")
    kw = dict(max_slots=8, max_len=512, block_size=16, paged=not args.dense,
              device="cuda")
    if "cuda_graphs" in inspect.signature(LLMEngine).parameters:
        kw["cuda_graphs"] = False
    eng = LLMEngine(cfg, params, **kw)
    rng = np.random.default_rng(1)
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, cfg.vocab_size, 16).tolist(), 16,
                   lambda t: None)
    with torch.inference_mode():
        while any(r is None or r.consumed < len(r.prompt)
                  for r in eng._slots):
            eng.step()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.step()
            times.append((time.perf_counter() - t0) * 1e3)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({
        "root": args.root, "model": args.model,
        "engine": "dense" if args.dense else "paged",
        "layers": cfg.n_layers,
        "syncs": sum(SYNC_WARNING in str(w.message) for w in caught),
        "step_ms_median": float(np.median(times)), "step_ms": times,
        "card": card}), flush=True)


if __name__ == "__main__":
    main()
