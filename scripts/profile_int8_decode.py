#!/usr/bin/env python3
"""Measure weight-only int8 decode on the accelerator.

The 1.2B ``CaptionerConfig.large()`` greedy decode at small batch streams
every weight once per step.  models/quant8.py stores the block matrices
as int8 + per-channel scales (half the bytes), in two dot modes:

  a16  (x @ q.astype(bf16)) * s   — convert next to the dot read
  a8   int8 x int8 -> int32 dot with dynamic per-row activation quant

This script times bf16 vs a16 vs a8 at the serving batch sizes and
reports tokens/s and the achieved weight-read rate (bytes resident per
step / measured step time):

  python scripts/profile_int8_decode.py            # large (1.2B)
  python scripts/profile_int8_decode.py --scale base
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from vidgraph_tpu.models.captioner import (CaptionerConfig, generate,  # noqa: E402
                                           init_params)
from vidgraph_tpu.models.quant8 import (quantize_captioner_params,  # noqa: E402
                                        tree_bytes)


def bench_one(params, cfg, batches, max_new, reps):
    rng = np.random.default_rng(0)
    pbytes = tree_bytes(params)
    rows = {}
    for b in batches:
        vis = jnp.asarray(rng.normal(
            size=(b, cfg.num_vision_tokens, cfg.vision_dim)
        ).astype(np.float32))
        np.asarray(generate(params, cfg, vis, max_new=max_new))  # compile
        t0 = time.perf_counter()
        toks = None
        for _ in range(reps):
            toks = generate(params, cfg, vis, max_new=max_new)
        np.asarray(toks)
        dt = time.perf_counter() - t0
        tps = b * max_new * reps / dt
        rows[b] = {
            "tokens_per_sec": round(tps, 1),
            "ms_per_step": round(dt / (reps * max_new) * 1e3, 3),
            "weight_gb_s": round(pbytes * (max_new * reps / dt) / 1e9, 1),
        }
    return pbytes, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="large", choices=("base", "large"))
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 32])
    args = ap.parse_args()

    cfg = getattr(CaptionerConfig, args.scale)()
    params = init_params(cfg, seed=0, param_dtype=jnp.bfloat16)
    qparams = quantize_captioner_params(params)

    report = {"scale": args.scale, "params": cfg.num_params,
              "device": jax.devices()[0].device_kind}
    for name, p, c in (
        ("bf16", params, cfg),
        ("int8_a16", qparams, dataclasses.replace(cfg, qmode="a16")),
        ("int8_a8", qparams, dataclasses.replace(cfg, qmode="a8")),
    ):
        pbytes, rows = bench_one(p, c, args.batches, args.max_new, args.reps)
        report[name] = {"weight_bytes": pbytes, "batches": rows}
        print(f"[{name}] {pbytes/1e9:.2f} GB  "
              + "  ".join(f"b{b}: {r['tokens_per_sec']:.0f} tok/s "
                          f"({r['ms_per_step']} ms/step, "
                          f"{r['weight_gb_s']} GB/s)"
                          for b, r in rows.items()), flush=True)

    # numerics cross-check at serving scale.  Greedy token match on a
    # RANDOM-init model is a pessimistic bound (near-uniform logits make
    # the greedy chain diverge on sub-1e-3 noise, then compound); the
    # robust signal is the logits cosine — trained-model token identity
    # is covered by tests/test_quant8.py.
    from vidgraph_tpu.models.captioner import forward
    rng = np.random.default_rng(1)
    vis = jnp.asarray(rng.normal(
        size=(4, cfg.num_vision_tokens, cfg.vision_dim)).astype(np.float32))
    toks = jnp.asarray(rng.integers(3, 250, (4, 32)), jnp.int32)
    ref_l = np.asarray(forward(params, cfg, vis, toks)).ravel()
    ref = np.asarray(generate(params, cfg, vis, max_new=32))
    for mode in ("a16", "a8"):
        c = dataclasses.replace(cfg, qmode=mode)
        got_l = np.asarray(forward(qparams, c, vis, toks)).ravel()
        cos = float(ref_l @ got_l
                    / (np.linalg.norm(ref_l) * np.linalg.norm(got_l)))
        got = np.asarray(generate(qparams, c, vis, max_new=32))
        match = float((ref == got).mean())
        report[f"logits_cosine_{mode}"] = round(cos, 6)
        report[f"token_match_{mode}"] = round(match, 4)
        print(f"[{mode}] logits cosine {cos:.6f}  greedy token match "
              f"{match:.4f} (random weights — pessimistic)", flush=True)

    print(json.dumps(report))


if __name__ == "__main__":
    main()
