#!/usr/bin/env python3
"""Profile the chat LM's ragged-batch decode dispatch across serving
shapes (round 5).

The full-on-device north-star scenario (bench.py::_realtime_tpu_captioner
with ``instruct_ckpt``) extracts triplets from ~64 short captions through
``TPUChatClient.complete_batch_sync``, whose round-4 shape pinning forces
every dispatch to (b_pad=32, t_pad=2048) even though caption-extraction
prompts are ~300-500 bytes.  This script isolates where a dispatch's time
goes (prefill vs scan, t_pad vs b_pad vs max_new) so the short-prompt
bucket can be sized from data instead of guesswork.

Run on the accelerator (every new shape is a compile — keep the shape
list short):

    python scripts/profile_chat_decode.py [--grammar] [--reps 3]

Prints one line per shape: compile time, steady dispatch wall, ms/step.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--grammar", action="store_true",
                    help="include the grammar mask gathers (production "
                    "extraction path always has them)")
    ap.add_argument("--shapes", default="32,2048,128;32,512,128;32,512,64;"
                    "8,512,128;32,2048,64",
                    help="semicolon-separated b,t_pad,max_new triples")
    ap.add_argument("--flash", action="store_true",
                    help="use the fused prefill attention (serving path)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from vidgraph_tpu.models.captioner import (CaptionerConfig,
                                               generate_from_tokens,
                                               init_params)

    cfg = CaptionerConfig.chat()
    params = init_params(cfg)          # random weights time identically
    gkw = {}
    if args.grammar:
        from vidgraph_tpu.models.grammar import pipeline_grammar
        g = pipeline_grammar()
        table = g.device_table()

    rng = np.random.default_rng(0)
    for spec in args.shapes.split(";"):
        b, t_pad, max_new = (int(x) for x in spec.split(","))
        toks = rng.integers(1, 250, (b, t_pad)).astype(np.int32)
        lens = np.full((b,), min(400, t_pad - 1), np.int32)
        if args.grammar:
            from vidgraph_tpu.models.grammar import FREE
            gkw = {"grammar_trans": table,
                   "grammar_start": jnp.full((b,), FREE, jnp.int32)}
        t0 = time.perf_counter()
        out = generate_from_tokens(params, cfg, jnp.asarray(toks),
                                   jnp.asarray(lens), max_new=max_new,
                                   flash=args.flash, **gkw)
        np.asarray(out)                # fetch-to-host: the honest clock
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = generate_from_tokens(params, cfg, jnp.asarray(toks),
                                       jnp.asarray(lens), max_new=max_new,
                                       flash=args.flash, **gkw)
            np.asarray(out)
        dt = (time.perf_counter() - t0) / args.reps
        print(f"b={b:3d} t_pad={t_pad:5d} max_new={max_new:4d} "
              f"compile={compile_s:6.1f}s steady={dt * 1000:7.1f} ms "
              f"({dt * 1000 / max_new:6.2f} ms/step)", flush=True)


if __name__ == "__main__":
    main()
