#!/usr/bin/env python3
"""Time the candidates behind each kernel choice of the served path.

Run on the GPU (one process, one card):

    python scripts/profile_kernels.py [--out chiprun_out/kernels.jsonl]

Cases, each printed as one JSON line with the device it ran on:

* ``attention`` — chat-LM prefill attention at (8, 2048) and (32, 2048)
  with the 8-slot vision prefix: the fused ``prefix_causal_attention``
  (cuDNN flash attention + the dense nv x nv corner) against the
  materialised masked einsum; the attention op alone, the whole 8-layer
  prefill, and one serving dispatch (prefill + 128 decode steps).
* ``train_step`` — one 204M / 1024-token training step (batch 16) with
  the fused attention and no remat against einsum + remat.
* ``topk`` — masked top-k over B=16 score rows of N columns: one
  ``lax.top_k`` against the two-stage tiled form, per tile size; and the
  [16,512]x[512,N] scoring matmul at HIGHEST against DEFAULT precision.
* ``int8`` — the a16 and a8 weight matmuls against bf16 at the large
  captioner's shapes, and whether the compiled a16 program materialises
  the converted bf16 weight (it does when a bf16 [K,N] array appears in
  the entry computation).

Times are the median and minimum of repeated calls, each ended by
``block_until_ready``, after warm-up calls that compile.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

DEVICE = None
OUT = None


def emit(rec: dict) -> None:
    rec = {"device": DEVICE, **rec}
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT is not None:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def timed(fn, *args, reps: int = 20, warm: int = 2):
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"median_ms": statistics.median(ts) * 1e3,
            "min_ms": min(ts) * 1e3, "reps": reps}


def attention_cases() -> None:
    from vidgraph_tpu.models.captioner import (CaptionerConfig, _embed_inputs,
                                               _masked_attention,
                                               _prefill, _prefix_causal_mask,
                                               generate_from_tokens,
                                               init_params,
                                               prefix_causal_attention)

    cfg = CaptionerConfig.chat()
    nv, h, hd = cfg.num_vision_tokens, cfg.heads, cfg.width // cfg.heads
    params = jax.device_put(init_params(cfg, seed=0))
    rng = np.random.default_rng(0)
    for b, t_pad in ((8, 2048), (32, 2048)):
        t = nv + t_pad
        q, k, v = (jnp.asarray(rng.normal(size=(b, t, h, hd)), jnp.bfloat16)
                   for _ in range(3))
        mask = _prefix_causal_mask(t, nv)
        fused = jax.jit(lambda q, k, v: prefix_causal_attention(q, k, v, nv))
        einsum = jax.jit(lambda q, k, v: _masked_attention(
            q, k, v, mask, jnp.bfloat16))
        emit({"case": "attention_op", "b": b, "t": t,
              "fused": timed(fused, q, k, v),
              "einsum": timed(einsum, q, k, v)})

        toks = jnp.asarray(rng.integers(3, 256, (b, t_pad)), jnp.int32)
        vis = jnp.zeros((b, nv, cfg.vision_dim), jnp.float32)
        for flash in (True, False):
            pre = jax.jit(lambda p, tk, flash=flash: _prefill(
                p, cfg, _embed_inputs(p, cfg, vis, tk), t + 128,
                flash=flash)[0])
            emit({"case": "chat_prefill_8_layers", "b": b, "t": t,
                  "impl": "fused" if flash else "einsum",
                  **timed(pre, params, toks, reps=10)})
        plen = jnp.full((b,), t_pad - 100, jnp.int32)
        for flash in (True, False):
            fn = jax.jit(lambda p, tk, pl, flash=flash: generate_from_tokens(
                p, cfg, tk, pl, max_new=128, flash=flash))
            emit({"case": "chat_dispatch_prefill_plus_128_steps", "b": b,
                  "t": t, "impl": "fused" if flash else "einsum",
                  **timed(fn, params, toks, plen, reps=5)})


def train_step_case() -> None:
    import optax

    from vidgraph_tpu.models.captioner import (CaptionerConfig, forward,
                                               init_params)

    seq = 1024
    cfg = CaptionerConfig(width=1024, layers=16, heads=16, max_len=seq + 64)
    rng = np.random.default_rng(0)
    batch = jnp.asarray(rng.integers(3, 256, (16, seq + 1)), jnp.int32)
    tx = optax.adamw(1e-4)
    for flash, remat in ((True, False), (False, True)):
        params = jax.device_put(init_params(cfg, seed=0))
        opt = tx.init(params)

        def loss_fn(p, bt, flash=flash, remat=remat):
            inp, tgt = bt[:, :-1], bt[:, 1:]
            vis = jnp.zeros((inp.shape[0], cfg.num_vision_tokens,
                             cfg.vision_dim), jnp.float32)
            lg = forward(p, cfg, vis, inp, remat=remat, flash=flash)
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, tgt).mean()

        @jax.jit
        def step(p, o, bt, loss_fn=loss_fn):
            loss, g = jax.value_and_grad(loss_fn)(p, bt)
            upd, o = tx.update(g, o, p)
            return optax.apply_updates(p, upd), o, loss

        def run(p, o, bt):
            return step(p, o, bt)[2]

        emit({"case": "train_step_204M_1024", "batch": 16,
              "params": cfg.num_params,
              "impl": "fused, no remat" if flash else "einsum + remat",
              **timed(run, params, opt, batch, reps=5)})
        del params, opt


def topk_cases() -> None:
    from vidgraph_tpu.ops import topk_cosine as tc

    rng = np.random.default_rng(0)
    for n in (65_536, 200_000, 1_048_576):
        scores = jnp.asarray(rng.normal(size=(16, n)).astype(np.float32))
        one = jax.jit(lambda s: jax.lax.top_k(s, 5))
        rec = {"case": "topk", "b": 16, "n": n, "k": 5,
               "one_stage": timed(one, scores)}
        for tile in (4096, 8192, 16384, 32768):
            def two(s, tile=tile):
                b_, n_ = s.shape
                n_pad = -(-n_ // tile) * tile
                s = jnp.pad(s, ((0, 0), (0, n_pad - n_)),
                            constant_values=-1e30)
                v1, i1 = jax.lax.top_k(s.reshape(b_, -1, tile), 5)
                v2, i2 = jax.lax.top_k(v1.reshape(b_, -1), 5)
                return v2, (i2 // 5) * tile + jnp.take_along_axis(
                    i1.reshape(b_, -1), i2, axis=1)
            rec[f"two_stage_tile_{tile}"] = timed(jax.jit(two), scores)
        emit(rec)
        store = jnp.asarray(rng.normal(size=(n, 512)).astype(np.float32))
        q = jnp.asarray(rng.normal(size=(16, 512)).astype(np.float32))
        rec = {"case": "cosine_scores", "b": 16, "n": n, "d": 512,
               "highest": timed(jax.jit(tc._scores), q, store)}
        with jax.default_matmul_precision("default"):
            rec["default"] = timed(jax.jit(
                lambda q, s: jnp.dot(q, s.T)), q, store)
        rec["fused_search"] = timed(
            lambda q, s: tc.cosine_topk(q, s, k=5, valid_count=n), q, store)
        emit(rec)


def int8_cases() -> None:
    from vidgraph_tpu.models.quant8 import quantize_matrix, wdot

    rng = np.random.default_rng(0)
    for m, k, n in ((8, 2048, 6144), (32, 2048, 8192), (8, 8192, 2048),
                    (32, 8192, 2048)):
        x = jnp.asarray(rng.normal(size=(m, k)), jnp.bfloat16)
        w = quantize_matrix(jnp.asarray(
            (rng.normal(size=(k, n)) * 0.02).astype(np.float32)))
        wb = (w.q.astype(jnp.float32) * w.s).astype(jnp.bfloat16)
        rec = {"case": "int8_matmul", "m": m, "k": k, "n": n,
               "bf16": timed(jax.jit(lambda a, b: a @ b), x, wb, reps=50)}
        for mode in ("a16", "a8"):
            fn = jax.jit(lambda a, q, s, mode=mode: wdot(
                a, type(w)(q, s), jnp.bfloat16, mode))
            rec[mode] = timed(fn, x, w.q, w.s, reps=50)
        for mode in ("a16", "a8"):
            hlo = jax.jit(lambda a, q, s, mode=mode: wdot(
                a, type(w)(q, s), jnp.bfloat16, mode)).lower(
                    x, w.q, w.s).compile().as_text()
            if mode == "a16":
                entry = hlo[hlo.find("ENTRY"):]
                rec["a16_materialises_bf16_weight"] = \
                    f"bf16[{k},{n}]" in entry
            if OUT is not None:
                Path(OUT).with_name(f"hlo_{mode}_{m}x{k}x{n}.txt") \
                    .write_text(hlo)
        emit(rec)


def main() -> None:
    global DEVICE, OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*",
                    default=["attention", "train", "topk", "int8"])
    args = ap.parse_args()
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"profile_kernels.py measures a GPU; JAX found "
                         f"{d.platform}")
    DEVICE = {"kind": d.device_kind, "count": len(jax.devices())}
    if args.out:
        OUT = args.out
        Path(OUT).parent.mkdir(parents=True, exist_ok=True)
    cases = {"attention": attention_cases, "train": train_step_case,
             "topk": topk_cases, "int8": int8_cases}
    for name in args.only:
        cases[name]()


if __name__ == "__main__":
    main()
