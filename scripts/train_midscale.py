#!/usr/bin/env python3
"""Mid-scale (100-300M) LM training run on one GPU.

Proves the training stack scales past the 26M toy models: a few hundred
steps at a ~200M decoder config with finite decreasing loss, measured
train-step throughput (model FLOPs / step time, in TFLOP/s), and a
bf16 checkpoint save/load round-trip.  Matches the reference's training
story at the scale its served models actually ran (the reference paid an
HTTP service per call; here the stack trains and serves in-process —
reference: src/pipeline/vlm_extractor.py:130-192 for the serving
counterpart).

Data is the byte-level caption corpus (real VidGraph captions + synthetic
scene sentences) packed into fixed windows — the point of this run is the
systems measurement (throughput/checkpoint at scale), not a new
capability model.

  python scripts/train_midscale.py \
      --corpus /root/reference/data/outputs/vlm_output.json \
      --steps 300 --out checkpoints/midscale_lm.npz

Emits one JSON line: params, tokens/s, step_ms, TFLOP/s, first/last loss,
checkpoint round-trip status.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vidgraph_tpu.models import instruct_data, tokenizer  # noqa: E402
from vidgraph_tpu.models.captioner import (CaptionerConfig,  # noqa: E402
                                           forward,
                                           generate_from_tokens,
                                           init_params, quantize_params)
from vidgraph_tpu.models.checkpoint import (load_params,  # noqa: E402
                                            save_params)

def mid_config(seq_len: int) -> CaptionerConfig:
    """~204M params: 16 x 1024 decoder (GPT-2-medium-class shapes)."""
    return CaptionerConfig(width=1024, layers=16, heads=16,
                           max_len=seq_len + 64)


def pack_corpus(captions, seq_len: int, rng: random.Random) -> np.ndarray:
    """Byte-tokenize the corpus into packed [N, seq_len+1] windows."""
    sents = instruct_data.sentences_of(captions) + [
        instruct_data.synth_sentence(rng) for _ in range(4000)]
    rng.shuffle(sents)
    stream: list = []
    for s in sents:
        stream.extend(tokenizer.encode(s, add_bos=True, add_eos=True))
    n = len(stream) // (seq_len + 1)
    arr = np.asarray(stream[:n * (seq_len + 1)],
                     np.int32).reshape(n, seq_len + 1)
    return arr


def train_flops_per_token(cfg: CaptionerConfig, seq: int) -> float:
    """6N per token for fwd+bwd on the dense params, plus the attention
    score/value matmuls 12*L*s*d (fwd 4*s*d per layer-token, x3 for bwd)."""
    return 6.0 * cfg.num_params + 12.0 * cfg.layers * seq * cfg.width


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/midscale_lm.npz")
    ap.add_argument("--flash", action="store_true",
                    help="fused attention (cuDNN flash attention on the "
                         "GPU): O(T) "
                         "attention residuals, so remat defaults OFF — "
                         "the [B,h,T,T] probabilities that forced remat "
                         "at this scale are never materialised")
    ap.add_argument("--remat", action="store_true",
                    help="force block rematerialisation (always on for "
                         "the non-flash path at this scale)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config on CPU (wiring check)")
    args = ap.parse_args()
    rng = random.Random(args.seed)

    data = json.loads(Path(args.corpus).read_text())
    captions = [r.get("content", "") for r in data["results"]
                if r.get("content")]
    if args.smoke:
        args.steps, args.batch, args.seq_len = 6, 2, 128
        captions = captions[:20]

    cfg = (CaptionerConfig(width=64, layers=2, heads=2,
                           max_len=args.seq_len + 64)
           if args.smoke else mid_config(args.seq_len))
    print(f"config: {cfg.layers}x{cfg.width}, "
          f"{cfg.num_params / 1e6:.1f}M params")

    toks = pack_corpus(captions, args.seq_len, rng)
    print(f"corpus: {toks.shape[0]} windows of {args.seq_len + 1}")

    params = init_params(cfg, seed=args.seed)
    nv = cfg.num_vision_tokens
    sched = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=max(1, args.steps // 10),
        decay_steps=args.steps, end_value=args.lr * 0.1)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    opt_state = tx.init(params)

    flash = args.flash
    # the einsum path materialises [B,h,T,T] f32 probabilities per layer,
    # so it trains with remat; flash stores O(T) residuals and makes
    # remat opt-in
    remat = args.remat or not flash
    print(f"attention: {'flash' if flash else 'einsum'}, remat={remat}")

    def loss_fn(p, batch):
        inputs, targets = batch[:, :-1], batch[:, 1:]
        vis = jnp.zeros((inputs.shape[0], nv, cfg.vision_dim), jnp.float32)
        logits = forward(p, cfg, vis, inputs, remat=remat, flash=flash)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        mask = (targets != tokenizer.PAD_ID).astype(jnp.float32)
        return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    @jax.jit
    def train_step(p, o, batch):
        loss, grads = jax.value_and_grad(loss_fn)(p, batch)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    nrng = np.random.default_rng(args.seed)
    first_loss = last_loss = None
    t_timed = 0.0
    timed_steps = 0
    t0 = time.time()
    for step in range(args.steps):
        idx = nrng.integers(0, toks.shape[0], size=args.batch)
        batch = jnp.asarray(toks[idx])
        ts = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, batch)
        loss = float(loss)    # fetch -> blocks until the step is done
        dt = time.perf_counter() - ts
        if step == 0:
            first_loss = loss
            print(f"step 0  loss {loss:.4f}  (compile {dt:.1f}s)")
        else:
            t_timed += dt
            timed_steps += 1
        last_loss = loss
        if step % 50 == 0 and step:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({timed_steps / t_timed:.2f} it/s)")
    wall = time.time() - t0

    step_s = t_timed / max(1, timed_steps)
    tokens_per_step = args.batch * args.seq_len
    tok_s = tokens_per_step / step_s
    train_tflops = train_flops_per_token(cfg, args.seq_len) * tok_s / 1e12

    # ---- bf16 checkpoint round-trip -------------------------------------
    bf16 = quantize_params(params, jnp.bfloat16)
    save_params(bf16, args.out)
    reloaded = load_params(bf16, args.out)
    flat_a = jax.tree_util.tree_leaves(bf16)
    flat_b = jax.tree_util.tree_leaves(reloaded)
    roundtrip = all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(flat_a, flat_b))
    # and the reloaded bf16 weights must decode
    prompt = tokenizer.encode("The scene shows", add_bos=True, add_eos=False)
    arr = np.full((1, 64), tokenizer.PAD_ID, np.int32)
    arr[0, :len(prompt)] = prompt
    sample = tokenizer.decode(np.asarray(generate_from_tokens(
        reloaded, cfg, jnp.asarray(arr), jnp.int32(len(prompt)),
        max_new=32))[0])
    meta = {"config": f"{cfg.layers}x{cfg.width}",
            "params_m": round(cfg.num_params / 1e6, 1),
            "steps": args.steps, "batch": args.batch,
            "seq_len": args.seq_len,
            "attention": "flash" if flash else "einsum",
            "remat": remat,
            "first_loss": round(first_loss, 4),
            "last_loss": round(last_loss, 4),
            "step_ms": round(step_s * 1e3, 1),
            "tokens_per_sec": int(tok_s),
            "train_tflops_per_s": round(train_tflops, 2),
            "wall_s": round(wall, 1),
            "bf16_roundtrip_exact": bool(roundtrip),
            "decode_sample": sample[:80]}
    Path(args.out).with_suffix(".json").write_text(json.dumps(meta))
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
