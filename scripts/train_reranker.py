#!/usr/bin/env python3
"""Train the cross-encoder reranker (``backend.reranker: trained``).

Self-labeled from the caption corpus (VERDICT r2 missing #4): for each
chunk, template questions grounded in THAT chunk's content make it the
positive; hard negatives are the hashed-embedder's nearest other chunks
(exactly the near-misses the dual encoder cannot separate) plus random
chunks.  Listwise softmax over each (1 positive + K negatives) group.
Held-out eval reports top-1 accuracy and MRR against the embedding-cosine
baseline — the signal the trained model must beat to justify existing.

Usage (on the accelerator):
  python scripts/train_reranker.py \
      --corpus /root/reference/data/outputs/vlm_output.json \
      --steps 2000 --out checkpoints/reranker.npz
"""
from __future__ import annotations

import argparse
import json
import random
import re
import time
from pathlib import Path

import numpy as np

import jax

import sys

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vidgraph_tpu.models.checkpoint import save_params  # noqa: E402
from vidgraph_tpu.models.reranker import (RerankerConfig,  # noqa: E402
                                          batch_encode_pairs,
                                          init_reranker_params,
                                          reranker_scores)

_COLOR = re.compile(
    r"\b(red|blue|green|yellow|white|black|gray|grey|orange|purple|brown|"
    r"transparent|silver)\s+([a-z]{3,})", re.IGNORECASE)
_VERB = re.compile(
    r"\b(?:person|scientist|researcher|hand|he|she|they)\b[^.]*?\b"
    r"(holds?|pours?|adjusts?|uses?|opens?|places?|measures?|picks?|"
    r"touches?|carries?|examines?|wears?)\b\s+(?:the|a|an)?\s*"
    r"([a-z]{3,})", re.IGNORECASE)
_NUMBER = re.compile(r"-?\d+\.\d+\s*(g|ml|kg|cm|mm|°c)?", re.IGNORECASE)


def queries_for(chunk: str, rng: random.Random) -> list:
    qs = []
    m = _COLOR.search(chunk)
    if m:
        qs.append(rng.choice([
            f"What color is the {m.group(2).lower()}?",
            f"Where is the {m.group(1).lower()} {m.group(2).lower()}?",
        ]))
    m = _VERB.search(chunk)
    if m:
        verb = m.group(1).lower().rstrip("s")
        obj = m.group(2).lower()
        qs.append(rng.choice([
            f"What does the person {verb}?",
            f"What does the person do with the {obj}?",
            f"When does the person {verb} the {obj}?",
        ]))
    if _NUMBER.search(chunk):
        qs.append(rng.choice([
            "What is the reading on the balance?",
            "What value is displayed?",
            "What is the measurement shown?",
        ]))
    words = [w.lower() for w in re.findall(r"[A-Za-z]{5,}", chunk)]
    if words:
        w = rng.choice(words)
        qs.append(rng.choice([
            f"When does the {w} appear?",
            f"What is near the {w}?",
        ]))
    return qs


def _dropout_words(q: str, rng: random.Random, p: float = 0.15) -> str:
    words = q.split()
    if len(words) < 4:
        return q
    kept = [w for w in words if rng.random() > p]
    return " ".join(kept) if len(kept) >= 3 else q


def build_groups(chunks, rng: random.Random, n_negs: int = 11,
                 samplings_per_query: int = 2):
    """-> list of (query, docs[1+K], pos_idx) with hard+random negatives.

    Each query gets ``samplings_per_query`` independent negative draws
    (the fixed-group memorization failure mode showed up as held-out
    top-1 BELOW the cosine baseline) and 15% query word-dropout."""
    from vidgraph_tpu.services.embed_client import make_embed_client

    embed = make_embed_client("tpu", dim=512)
    vecs = embed.embed(list(chunks))
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, -1.0)
    hard = np.argsort(-sims, axis=1)[:, :10]

    groups = []
    for i, chunk in enumerate(chunks):
        for q in queries_for(chunk, rng):
            for _ in range(samplings_per_query):
                n_hard = rng.randint(3, n_negs // 2 + 1)
                negs = list(rng.sample(list(hard[i]), n_hard))
                while len(negs) < n_negs:
                    j = rng.randrange(len(chunks))
                    if j != i and j not in negs:
                        negs.append(j)
                docs = [chunk] + [chunks[j] for j in negs]
                order = list(range(len(docs)))
                rng.shuffle(order)
                docs = [docs[k] for k in order]
                pos = order.index(0)
                groups.append((_dropout_words(q, rng), docs, pos))
    rng.shuffle(groups)
    return groups


_SYN_COLORS = ["red", "blue", "green", "yellow", "white", "black", "gray",
               "orange", "purple", "brown", "transparent", "silver"]
_SYN_OBJECTS = ["beaker", "flask", "balance", "smartphone", "glove",
                "pipette", "notebook", "monitor", "bottle", "stirrer",
                "scale", "tray", "goggles", "cylinder", "funnel", "burner",
                "thermometer", "syringe", "clamp", "rack"]
_SYN_VERBS = ["holds", "pours", "adjusts", "uses", "opens", "places",
              "measures", "picks up", "touches", "carries", "examines"]


def synthetic_groups(rng: random.Random, n_groups: int, n_negs: int = 11):
    """Compositional groups: the positive is the ONLY doc matching the
    queried (color, object) or (verb, object) combination, negatives
    reuse the same vocabulary — teaches term matching, not memory."""
    groups = []
    for _ in range(n_groups):
        color = rng.choice(_SYN_COLORS)
        obj = rng.choice(_SYN_OBJECTS)
        verb = rng.choice(_SYN_VERBS)
        pos_doc = (f"The person {verb} the {color} {obj} on the bench "
                   f"near a {rng.choice(_SYN_COLORS)} "
                   f"{rng.choice(_SYN_OBJECTS)}.")
        q = rng.choice([
            f"What color is the {obj}?",
            f"What does the person do with the {obj}?",
            f"Where is the {color} {obj}?",
            f"What does the person {verb.split()[0]}?",
        ])
        docs = [pos_doc]
        while len(docs) < 1 + n_negs:
            c2 = rng.choice(_SYN_COLORS)
            o2 = rng.choice(_SYN_OBJECTS)
            v2 = rng.choice(_SYN_VERBS)
            if o2 == obj and (c2 == color or v2 == verb):
                continue                      # would be a second positive
            docs.append(f"The person {v2} the {c2} {o2} on the bench "
                        f"near a {rng.choice(_SYN_COLORS)} "
                        f"{rng.choice(_SYN_OBJECTS)}.")
        order = list(range(len(docs)))
        rng.shuffle(order)
        docs = [docs[k] for k in order]
        groups.append((q, docs, order.index(0)))
    return groups


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--groups-per-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heldout", type=int, default=120)
    ap.add_argument("--lam", type=float, default=8.0,
                    help="cosine-prior weight in the residual objective")
    ap.add_argument("--score-reg", type=float, default=0.02,
                    help="L2 penalty on cross-encoder scores: the residual "
                         "stays near zero unless it genuinely pays")
    ap.add_argument("--synth-groups", type=int, default=3000)
    ap.add_argument("--out", default="checkpoints/reranker.npz")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    rng = random.Random(args.seed)

    data = json.loads(Path(args.corpus).read_text())
    captions = [r["content"] for r in data["results"] if r.get("content")]
    # doc unit = the stored chunk contents the serve-time reranker sees
    chunks = list(dict.fromkeys(captions))
    print(f"{len(chunks)} corpus chunks")

    corpus_groups = build_groups(chunks, rng)
    rng.shuffle(corpus_groups)
    held = corpus_groups[:args.heldout]       # held-out = corpus style
    groups = (corpus_groups[args.heldout:]
              + synthetic_groups(rng, args.synth_groups))
    rng.shuffle(groups)
    print(f"{len(groups)} train groups ({args.synth_groups} synthetic) / "
          f"{len(held)} held-out")

    cfg = RerankerConfig.tiny() if args.tiny else RerankerConfig()
    params = init_reranker_params(cfg, seed=args.seed)

    # pre-tokenize all groups: [G, n_docs, T]
    toks = np.stack([batch_encode_pairs(q, docs, cfg)
                     for q, docs, _ in groups])
    pos = np.array([p for _, _, p in groups], np.int32)
    # residual objective: training logits = cross + lambda * cosine prior,
    # so a zero-signal model reproduces the cosine baseline exactly
    from vidgraph_tpu.services.embed_client import make_embed_client

    embed = make_embed_client("tpu", dim=512)
    sims = np.zeros((len(groups), len(groups[0][1])), np.float32)
    for g, (q, docs, _) in enumerate(groups):
        vecs = embed.embed([q] + list(docs))
        sims[g] = vecs[1:] @ vecs[0]
    print(f"tokenized {toks.shape} (cosine prior lambda={args.lam})")

    warmup = min(100, max(1, args.steps // 10))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1), end_value=args.lr * 0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    opt_state = tx.init(params)

    def loss_fn(p, batch_toks, batch_pos, batch_sims):
        g, d, t = batch_toks.shape
        scores = reranker_scores(p, cfg,
                                 batch_toks.reshape(g * d, t)).reshape(g, d)
        logits = scores + args.lam * batch_sims
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch_pos).mean()
        return ce + args.score_reg * jnp.mean(jnp.square(scores))

    @jax.jit
    def train_step(p, o, batch_toks, batch_pos, batch_sims):
        loss, grads = jax.value_and_grad(loss_fn)(p, batch_toks, batch_pos,
                                                  batch_sims)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    nrng = np.random.default_rng(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        idx = nrng.integers(0, toks.shape[0], size=args.groups_per_batch)
        params, opt_state, loss = train_step(
            params, opt_state, jnp.asarray(toks[idx]),
            jnp.asarray(pos[idx]), jnp.asarray(sims[idx]))
        if step % 200 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            rate = f"  ({step / dt:.1f} it/s)" if step else ""
            print(f"step {step:5d}  loss {float(loss):.4f}{rate}")

    save_params(params, args.out)
    Path(args.out).with_suffix(".json").write_text(json.dumps(
        {"config": "tiny" if args.tiny else "default",
         "steps": args.steps, "final_loss": float(loss),
         "cosine_lambda": args.lam}))
    print(f"saved {args.out}")

    # ---- held-out eval vs the cosine baseline ---------------------------
    fwd = jax.jit(lambda p, t: reranker_scores(p, cfg, t))
    top1 = mrr = 0.0
    base_top1 = base_mrr = 0.0
    for q, docs, p_idx in held:
        vq = embed.embed([q] + list(docs))
        s = np.asarray(fwd(params, jnp.asarray(
            batch_encode_pairs(q, docs, cfg))))
        s = s + args.lam * (vq[1:] @ vq[0])
        rank = int(np.where(np.argsort(-s) == p_idx)[0][0]) + 1
        top1 += rank == 1
        mrr += 1.0 / rank
        vecs = embed.embed([q] + list(docs))
        bs = vecs[1:] @ vecs[0]
        brank = int(np.where(np.argsort(-bs) == p_idx)[0][0]) + 1
        base_top1 += brank == 1
        base_mrr += 1.0 / brank
    n = len(held)
    print(f"held-out: trained top1 {top1 / n:.3f} mrr {mrr / n:.3f} | "
          f"cosine baseline top1 {base_top1 / n:.3f} "
          f"mrr {base_mrr / n:.3f}")


if __name__ == "__main__":
    main()
