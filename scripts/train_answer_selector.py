#!/usr/bin/env python3
"""Train the answer-selection cross-encoder (round 4, VERDICT r3 next #2).

The fully-on-device pipeline's answer role lost to the deterministic
extractive answerer when framed as byte GENERATION (held F1 0.52, 1/30
e2e).  This script reframes it as SELECTION: a byte-level cross-encoder
(models/reranker.py trunk) learns to score candidate context sentences
given the question, distilling the IDF+MMR teacher's per-sentence score
DISTRIBUTION (services.llm_client.teacher_answer_scores) listwise over
synthetic + real hybrid-retrieval contexts.  Serving assembles answers
extractively from the model's scores (models/answer_selector.py).

Usage (on the accelerator):
  python scripts/train_answer_selector.py \
      --corpus /root/reference/data/outputs/vlm_output.json \
      --out checkpoints/answer_selector.npz
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time
from pathlib import Path

import numpy as np

import jax

import sys

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vidgraph_tpu.models import instruct_data, tokenizer  # noqa: E402
from vidgraph_tpu.models.answer_selector import AnswerSelector  # noqa: E402
from vidgraph_tpu.models.checkpoint import save_params  # noqa: E402
from vidgraph_tpu.models.reranker import (RerankerConfig,  # noqa: E402
                                          batch_encode_pairs,
                                          init_reranker_params,
                                          reranker_scores)
from vidgraph_tpu.services.llm_client import (  # noqa: E402
    extractive_answer, teacher_answer_scores)


def load_captions(path: str) -> list:
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict) and "results" in data:
        return [r.get("content", "") for r in data["results"]
                if r.get("content")]
    raise ValueError("corpus must be a vlm_output.json")


def truncated_candidates(q: str, ctx: str, k_cand: int,
                         rng: random.Random = None):
    """Teacher-scored candidates -> (cand, scores) or None.  Contexts
    over ``k_cand`` keep the top-(k/2) teacher-scored PLUS a random
    sample of the rest (original order).  Keeping only the top-k (round-4
    first attempt) biased training toward already-plausible sentences —
    the served model then scored never-seen junk sentences at random and
    e2e accuracy collapsed to 1/30.  The model must see the junk it is
    expected to suppress."""
    scored = teacher_answer_scores(q, ctx)
    if scored is None:
        return None
    cand, _toks, _idf, scores = scored
    if len(cand) > k_cand:
        order = sorted(range(len(cand)), key=lambda i: -scores[i])
        top = order[:k_cand // 2]
        rest = order[k_cand // 2:]
        r = rng or random
        keep = sorted(top + r.sample(rest, k_cand - len(top)))
        cand = [cand[i] for i in keep]
        scores = [scores[i] for i in keep]
    return (cand, scores) if cand else None


def build_examples(pairs, cfg: RerankerConfig, k_cand: int,
                   rng: random.Random = None):
    """(q, ctx) -> (toks [K,T] uint16, target [K] f32, valid [K] bool,
    q, ctx, teacher_answer)."""
    examples = []
    for q, ctx in pairs:
        t = truncated_candidates(q, ctx, k_cand, rng)
        if t is None:
            continue
        cand, scores = t
        toks = batch_encode_pairs(q, cand, cfg).astype(np.uint16)
        pad = np.full((k_cand - toks.shape[0], cfg.max_len),
                      tokenizer.PAD_ID, np.uint16)
        toks = np.concatenate([toks, pad]) if pad.shape[0] else toks
        target = np.full((k_cand,), -1e30, np.float32)
        target[:len(scores)] = np.asarray(scores, np.float32)
        valid = np.zeros((k_cand,), bool)
        valid[:len(scores)] = True
        examples.append((toks, target, valid, q, ctx,
                         extractive_answer(q, ctx)))
    return examples


def token_f1(a: str, b: str) -> float:
    import collections

    ta, tb = a.split(), b.split()
    common = sum((collections.Counter(ta) & collections.Counter(tb)).values())
    return 2 * common / (len(ta) + len(tb)) if ta and tb and common else 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--k-cand", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temp", type=float, default=1.0,
                    help="softmax temperature on the teacher scores")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-synth", type=int, default=6000)
    ap.add_argument("--n-questions", type=int, default=1200)
    ap.add_argument("--eval-count", type=int, default=150)
    ap.add_argument("--out", default="checkpoints/answer_selector.npz")
    ap.add_argument("--data-cache", default="",
                    help="npz path: build examples once (CPU-friendly) "
                         "and train from the cache (chip-friendly) — "
                         "pass the same path to both invocations")
    ap.add_argument("--build-only", action="store_true",
                    help="with --data-cache: build + save, skip training")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    rng = random.Random(args.seed)

    captions = load_captions(args.corpus)
    cfg = (RerankerConfig.tiny() if args.smoke
           else RerankerConfig(max_len=args.max_len))
    if args.smoke:
        captions = captions[:10]
        args.n_synth, args.n_questions = 12, 4
        args.steps, args.eval_count, args.k_cand = 8, 4, 8

    if args.data_cache and os.path.exists(args.data_cache):
        z = np.load(args.data_cache, allow_pickle=True)
        examples = [tuple(e) for e in z["examples"]]
        print(f"loaded {len(examples)} examples from {args.data_cache}")
    else:
        t0 = time.time()
        sents = instruct_data.sentences_of(captions) + [
            instruct_data.synth_sentence(rng) for _ in range(1500)]
        pairs = instruct_data.synthetic_answer_pairs(sents, rng,
                                                     args.n_synth)
        pairs += instruct_data.real_retrieval_pairs(captions, rng,
                                                    args.n_questions)
        rng.shuffle(pairs)
        print(f"pairs: {len(pairs)} in {time.time() - t0:.1f}s")
        examples = build_examples(pairs, cfg, args.k_cand, rng)
        if args.data_cache:
            np.savez_compressed(
                args.data_cache,
                examples=np.asarray(examples, dtype=object))
            print(f"cached {len(examples)} examples -> {args.data_cache}")
            if args.build_only:
                return
    held = examples[:args.eval_count]
    train = examples[args.eval_count:]
    print(f"examples: {len(train)} train / {len(held)} held "
          f"(K={args.k_cand}, T={cfg.max_len})")

    # device-resident dataset (uint16): no per-step host-to-device upload
    toks_all = jnp.asarray(np.stack([e[0] for e in train]))    # [N,K,T] u16
    tgt_all = jnp.asarray(np.stack([e[1] for e in train]))     # [N,K] f32
    val_all = jnp.asarray(np.stack([e[2] for e in train]))     # [N,K] bool

    params = init_reranker_params(cfg, args.seed)
    warmup = min(200, max(1, args.steps // 10))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1), end_value=args.lr * 0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    opt_state = tx.init(params)
    temp = args.temp

    def loss_fn(p, toks, tgt, valid):
        b, k, t = toks.shape
        logits = reranker_scores(p, cfg, toks.astype(jnp.int32)
                                 .reshape(b * k, t)).reshape(b, k)
        logits = jnp.where(valid, logits, -1e30)
        # standardize the teacher scores per list: raw IDF-overlap scores
        # have list-dependent scale, so a fixed temperature would make
        # some targets near-one-hot and others near-uniform
        nv = jnp.maximum(valid.sum(-1, keepdims=True), 1)
        vt = jnp.where(valid, tgt, 0.0)
        mean = vt.sum(-1, keepdims=True) / nv
        var = (jnp.where(valid, (vt - mean) ** 2, 0.0).sum(-1, keepdims=True)
               / nv)
        z = (tgt - mean) * jax.lax.rsqrt(var + 1e-6)
        target = jax.nn.softmax(jnp.where(valid, z / temp, -1e30), axis=-1)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -(target * jnp.where(valid, logp, 0.0)).sum(-1).mean()

    @jax.jit
    def train_step(p, o, ds_toks, ds_tgt, ds_val, idx):
        # the dataset rides as jit ARGUMENTS: closure-capturing a ~300 MB
        # device array would embed it in the compiled program as a
        # constant
        loss, grads = jax.value_and_grad(loss_fn)(
            p, ds_toks[idx], ds_tgt[idx], ds_val[idx])
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    # held-out LOSS batches for early stopping (generalization signal)
    htoks = jnp.asarray(np.stack([e[0] for e in held]))
    htgt = jnp.asarray(np.stack([e[1] for e in held]))
    hval = jnp.asarray(np.stack([e[2] for e in held]))
    eval_loss = jax.jit(loss_fn)

    def held_loss() -> float:
        tot = 0.0
        m = 16
        for i in range(0, htoks.shape[0], m):
            bsz = min(m, htoks.shape[0] - i)
            tot += float(eval_loss(params, htoks[i:i + m], htgt[i:i + m],
                                   hval[i:i + m])) * bsz
        return tot / max(1, htoks.shape[0])

    nrng = np.random.default_rng(args.seed)
    best = {"loss": float("inf"), "step": -1, "params": None}
    t0 = time.time()
    for step in range(args.steps):
        idx = jnp.asarray(nrng.integers(0, len(train), size=args.batch))
        params, opt_state, loss = train_step(params, opt_state, toks_all,
                                             tgt_all, val_all, idx)
        if step % 200 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            rate = f"  ({step / dt:.1f} it/s)" if step else ""
            print(f"step {step:5d}  loss {float(loss):.4f}{rate}")
        if (step % 1000 == 0 and step) or step == args.steps - 1:
            hl = held_loss()
            print(f"step {step:5d}  HELD loss {hl:.4f}")
            if hl < best["loss"]:
                best = {"loss": hl, "step": step,
                        "params": jax.tree_util.tree_map(
                            lambda x: np.asarray(x), params)}
                # persist the running best so a machine reset (or a
                # deadline-bounded run killed by PID) leaves a servable
                # checkpoint behind — same contract as
                # train_instruct_lm.py
                save_params(best["params"], args.out)
                Path(args.out).with_suffix(".json").write_text(json.dumps(
                    {"selector_cfg": {
                        "width": cfg.width, "layers": cfg.layers,
                        "heads": cfg.heads, "max_len": cfg.max_len,
                        "query_budget": cfg.query_budget},
                     "steps": args.steps, "held_loss": hl,
                     "held_best_step": step, "partial": True}))

    if best["params"] is not None and best["step"] < args.steps - 1:
        print(f"early-stop pick: step {best['step']} "
              f"(held {best['loss']:.4f})")
        params = best["params"]
    save_params(params, args.out)
    meta = {"selector_cfg": {
        "width": cfg.width, "layers": cfg.layers, "heads": cfg.heads,
        "max_len": cfg.max_len, "query_budget": cfg.query_budget},
        "steps": args.steps, "train_examples": len(train)}
    Path(args.out).with_suffix(".json").write_text(json.dumps(meta))
    print(f"saved {args.out}")

    # ---- held-out eval: does the model reproduce the teacher's answers? --
    sel = AnswerSelector(checkpoint_path=args.out)
    top1 = em = 0
    f1 = 0.0
    for _toks_e, _tgt_e, _valid_e, q, ctx, teacher_ans in held:
        t = truncated_candidates(q, ctx, args.k_cand, rng)
        if t is None:
            continue
        cand, tscores = t
        s = sel.score(q, cand)
        top1 += int(np.argmax(s) == int(np.argmax(tscores)))
        model_ans = sel.answer(q, ctx)
        em += model_ans == teacher_ans
        f1 += token_f1(model_ans, teacher_ans)
    n = max(1, len(held))
    print(f"eval: top1-agreement {top1}/{n} = {top1 / n:.3f}  "
          f"answer-exact {em}/{n} = {em / n:.3f}  "
          f"answer-F1 {f1 / n:.3f}")


if __name__ == "__main__":
    main()
