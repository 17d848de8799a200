#!/usr/bin/env python3
"""Contrastive training of the byte-level TransformerTextEmbedder.

Self-supervised domain adaptation on caption text (VERDICT r1 item 7):

* two augmented views per sentence (contiguous word crop + word dropout)
  pulled together with InfoNCE against in-batch negatives — the crop view
  behaves like a short query matching its full chunk;
* a hash-teacher distillation term (MSE between the student's cosine
  matrix and the HashedNGramEmbedder's) anchors the lexical-matching
  behaviour the retrieval stack already relies on, so the trained encoder
  starts from hash parity and adds contextual signal on top.

Corpus: any text file (one passage per line) or a vlm_output.json whose
caption contents are split into sentences.  The benchmark queries are
NEVER seen during training.

Usage:
  python scripts/train_text_embedder.py --corpus <vlm_output.json|txt> \
      --steps 600 --out checkpoints/text_embedder.npz
"""
from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import numpy as np


import jax

import jax.numpy as jnp
import optax

import sys

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidgraph_tpu.models import tokenizer  # noqa: E402
from vidgraph_tpu.models.captioner import CaptionerConfig  # noqa: E402
from vidgraph_tpu.models.checkpoint import save_params  # noqa: E402
from vidgraph_tpu.models.text_embedder import (HashedNGramEmbedder,  # noqa: E402
                                               encoder_forward,
                                               init_encoder_params)


_STOP = frozenset("""
a an the and or of to in on at is are was were be been being this that
these those with for from by as it its his her their our your we you they
he she i then than there here what which who when where why how not no
""".split())


def load_sentences(path: str, min_chars: int = 24) -> list:
    """Positive *documents*: whole captions (json) or lines (txt), plus
    their sentences — the retrieval task matches short queries against
    multi-sentence chunk documents, so both granularities train."""
    text = Path(path).read_text()
    if path.endswith(".json"):
        data = json.loads(text)
        bodies = [r.get("content", "") for r in data.get("results", [])]
    else:
        bodies = text.splitlines()
    docs, seen = [], set()
    for body in bodies:
        body = body.strip()
        if len(body) >= min_chars and body.lower()[:256] not in seen:
            seen.add(body.lower()[:256])
            docs.append(body)
        for s in re.split(r"(?<=[.!?])\s+|\n+", body):
            s = s.strip(" -*#")
            if len(s) >= min_chars and s.lower()[:256] not in seen:
                seen.add(s.lower()[:256])
                docs.append(s)
    return docs


def augment(sent: str, rng: np.random.Generator) -> str:
    """Query-shaped view: a small sample of informative (non-stopword)
    words in document order — benchmark queries mention a handful of
    content words scattered across the chunk, not a contiguous span."""
    words = sent.split()
    content_idx = [i for i, w in enumerate(words)
                   if w.lower().strip(".,!?:;()\"'") not in _STOP]
    if len(content_idx) >= 4:
        n = int(rng.integers(3, min(9, len(content_idx))))
        pick = sorted(rng.choice(len(content_idx), size=n, replace=False))
        words = [words[content_idx[i]] for i in pick]
    elif len(words) > 4:
        keep = rng.random(len(words)) > 0.1
        keep[0] = True
        words = [w for w, k in zip(words, keep) if k]
    return " ".join(words)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=384,
                    help="document-tower byte length (queries use 96)")
    ap.add_argument("--query-len", type=int, default=96)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--distill", type=float, default=4.0,
                    help="weight of the hash-teacher similarity MSE")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/text_embedder.npz")
    args = ap.parse_args()

    sents = load_sentences(args.corpus)
    rng = np.random.default_rng(args.seed)
    rng.shuffle(sents)
    n_eval = max(16, len(sents) // 10)
    eval_sents, train_sents = sents[:n_eval], sents[n_eval:]
    print(f"corpus: {len(train_sents)} train / {len(eval_sents)} eval "
          f"sentences")

    cfg = CaptionerConfig(width=args.width, layers=args.layers,
                          heads=args.heads, vision_dim=args.width,
                          num_vision_tokens=1, max_len=args.max_len + 1,
                          dtype=jnp.bfloat16)
    params = init_encoder_params(cfg, args.dim, args.seed)
    teacher = HashedNGramEmbedder(dim=args.dim)

    sched = optax.cosine_decay_schedule(args.lr, args.steps, 0.1)
    opt = optax.adamw(sched, weight_decay=1e-4)
    opt_state = opt.init(params)

    def loss_fn(p, tok_q, tok_d, t_sim):
        zq = encoder_forward(p, cfg, tok_q)      # query views [B, dim]
        zd = encoder_forward(p, cfg, tok_d)      # documents   [B, dim]
        sim = (zq @ zd.T) / args.tau
        targets = jnp.arange(zq.shape[0])
        nce = (optax.softmax_cross_entropy_with_integer_labels(
                   sim, targets).mean()
               + optax.softmax_cross_entropy_with_integer_labels(
                   sim.T, targets).mean()) / 2.0
        distill = jnp.mean((zd @ zd.T - t_sim) ** 2)
        return nce + args.distill * distill, (nce, distill)

    @jax.jit
    def step(p, s, tok_a, tok_b, t_sim):
        (loss, (nce, dist)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, tok_a, tok_b, t_sim)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, nce, dist

    @jax.jit
    def encode(p, toks):
        return encoder_forward(p, cfg, toks)

    def eval_recall(p) -> float:
        """query-view -> full-document retrieval recall@1 (held-out)."""
        erng = np.random.default_rng(123)
        queries = [augment(s, erng) for s in eval_sents]
        tq = jnp.asarray(tokenizer.batch_encode(queries, args.query_len))
        td = jnp.asarray(tokenizer.batch_encode(eval_sents, args.max_len))
        zq, zd = np.asarray(encode(p, tq)), np.asarray(encode(p, td))
        pred = (zq @ zd.T).argmax(axis=1)
        return float((pred == np.arange(len(eval_sents))).mean())

    # hash-teacher baseline on the same protocol
    erng = np.random.default_rng(123)
    hq = teacher.embed([augment(s, erng) for s in eval_sents])
    hd = teacher.embed(eval_sents)
    hash_recall = float(((hq @ hd.T).argmax(1)
                         == np.arange(len(eval_sents))).mean())
    print(f"hash-teacher eval recall@1: {hash_recall:.3f}")

    t0 = time.time()
    for it in range(args.steps):
        batch = [train_sents[i] for i in
                 rng.integers(0, len(train_sents), args.batch)]
        queries = [augment(s, rng) for s in batch]
        tok_q = jnp.asarray(tokenizer.batch_encode(queries, args.query_len))
        tok_d = jnp.asarray(tokenizer.batch_encode(batch, args.max_len))
        t_emb = teacher.embed(batch)
        t_sim = jnp.asarray(t_emb @ t_emb.T)
        params, opt_state, loss, nce, dist = step(
            params, opt_state, tok_q, tok_d, t_sim)
        if it % 50 == 0 or it == args.steps - 1:
            r = eval_recall(params)
            print(f"step {it:4d} loss={float(loss):.4f} "
                  f"nce={float(nce):.4f} distill={float(dist):.5f} "
                  f"eval recall@1={r:.3f} ({time.time()-t0:.0f}s)")

    final = eval_recall(params)
    out = save_params(params, args.out)
    meta = {"width": args.width, "layers": args.layers, "heads": args.heads,
            "dim": args.dim, "max_len": args.max_len,
            "eval_recall_at_1": final, "hash_recall_at_1": hash_recall,
            "steps": args.steps, "corpus": args.corpus}
    Path(out).with_suffix(".json").write_text(json.dumps(meta, indent=2))
    print(f"saved {out}; eval recall@1 {final:.3f} (hash {hash_recall:.3f})")


if __name__ == "__main__":
    main()
