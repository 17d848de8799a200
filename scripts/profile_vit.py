#!/usr/bin/env python3
"""Decompose the fused preprocess+ViT frame-embed step.

The serving path runs 720p uint8 frames -> resize -> normalise ->
patchify -> ViT-B/32 -> 512-d embeddings as ONE jit at B=160.  This script
times each stage in isolation on the accelerator and prints the achieved
FLOP and byte rates of each (from analytic counts), so the time is
attributed to specific stages (resize matmuls, layout ops, attention at
N=50, LN/elementwise, dispatch) instead of guessed at.

  python scripts/profile_vit.py                      # accelerator
  JAX_PLATFORMS=cpu python scripts/profile_vit.py --smoke
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from vidgraph_tpu.models.vit import ViTConfig, init_vision_tower  # noqa: E402
from vidgraph_tpu.ops.preprocess import (patchify,  # noqa: E402
                                         preprocess_frames)


def timeit(fn, *args, reps: int = 10):
    """Pipelined per-dispatch wall time.  Only a tiny slice of the output
    is fetched, so the device-to-host copy of a full stage output does
    not swamp the device time."""
    def probe(o):
        leaf = jax.tree_util.tree_leaves(o)[0]
        return np.asarray(leaf.ravel()[:8])

    out = fn(*args)
    probe(out)   # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    probe(out)
    return (time.perf_counter() - t0) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=160)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    cfg = ViTConfig.b32()
    B = 4 if args.smoke else args.batch
    model, params = init_vision_tower(cfg, seed=0)
    rng = np.random.default_rng(0)
    frames = jnp.asarray(rng.integers(0, 256, size=(B, 720, 1280, 3),
                                      dtype=np.uint8))
    n_tok = cfg.num_patches + 1
    d = cfg.width

    # stage jits ----------------------------------------------------------
    pre = jax.jit(lambda f: preprocess_frames(f, size=cfg.image_size,
                                              fast=True))
    tower = jax.jit(lambda p, x: model.apply(p, x))
    fused = jax.jit(lambda p, f: model.apply(
        p, preprocess_frames(f, size=cfg.image_size, fast=True)))

    # pre-resized input for the tower-only time
    x224 = pre(frames)
    x224 = jnp.asarray(np.asarray(x224))          # materialise

    # patchify+embed alone (first matmul) --------------------------------
    pe_w = params["params"]["patch_embed"]["kernel"]
    pe_b = params["params"]["patch_embed"]["bias"]
    patch_embed = jax.jit(
        lambda x: patchify(x.astype(jnp.bfloat16),
                           cfg.patch_size) @ pe_w.astype(jnp.bfloat16)
        + pe_b.astype(jnp.bfloat16))

    rows = []

    def add(name, dt, flops, bytes_moved):
        rows.append({
            "stage": name,
            "ms": round(dt * 1e3, 3),
            "tflops": round(flops / dt / 1e12, 1),
            "gb_s": round(bytes_moved / dt / 1e9, 1),
        })

    reps = 3 if args.smoke else 10

    # full fused step
    dt = timeit(fused, params, frames, reps=reps)
    vit_flops = B * (2 * n_tok * 12 * d * d * cfg.layers
                     + 2 * cfg.layers * 2 * n_tok * n_tok * d
                     + 2 * n_tok * (cfg.patch_size ** 2 * 3) * d
                     + 2 * d * cfg.embed_dim)
    resize_flops = B * 2 * 3 * (224 * 1280 * 720 + 224 * 224 * 1280)
    add("fused (resize+norm+ViT)", dt, vit_flops + resize_flops,
        B * (720 * 1280 * 3 + 2 * 224 * 224 * 3 * 2))
    fused_ms = dt * 1e3

    # preprocess only (resize matmuls + normalise, bf16)
    dt = timeit(pre, frames, reps=reps)
    add("preprocess (resize+norm)", dt, resize_flops,
        B * (720 * 1280 * 3            # u8 read
             + 224 * 1280 * 3 * 2      # intermediate write+read (bf16)
             + 224 * 224 * 3 * 2))     # out write (bf16)
    pre_ms = dt * 1e3

    # tower only on pre-resized frames
    dt = timeit(tower, params, x224, reps=reps)
    add("ViT tower (224 input)", dt, vit_flops, B * 224 * 224 * 3 * 2)
    tower_ms = dt * 1e3

    # patchify+patch_embed only
    dt = timeit(patch_embed, x224, reps=reps)
    add("patchify+patch_embed", dt,
        B * 2 * cfg.num_patches * (cfg.patch_size ** 2 * 3) * d,
        B * (224 * 224 * 3 * 2 + cfg.num_patches * d * 2))

    # dispatch floor: trivial op on the same input
    tiny = jax.jit(lambda f: f[0, 0, 0, :].astype(jnp.float32) * 2.0)
    dt = timeit(tiny, frames, reps=reps)
    rows.append({"stage": "dispatch floor (trivial jit)",
                 "ms": round(dt * 1e3, 3)})

    print(json.dumps({
        "batch": B,
        "fused_ms": round(fused_ms, 2),
        "sum_parts_ms": round(pre_ms + tower_ms, 2),
        "device": jax.devices()[0].device_kind,
        "stages": rows,
    }, indent=2))


if __name__ == "__main__":
    main()
