#!/usr/bin/env python3
"""On-card smoke test of vidgraph's main path.

    python chip_smoke.py          # one GPU: device, parity, e2e
    python chip_smoke.py --four   # four GPUs: the mesh paths only

Phases, in order, in one process; any failure exits non-zero:

* ``device`` — JAX must see a GPU (never falls back to the CPU); prints the
  card, its power limit, the JAX version, XLA flags and compile cache.
* ``parity`` — each op of the served path, compiled for the card, against
  a plain reference at real widths: (a) cosine top-k over a 200k x 512
  store vs float64 numpy, (b) the bf16 ViT-B/32 tower vs the same tower in
  f32 at highest precision, (c) the 1.2B captioner's prefill logits and
  greedy decode vs f32, (d) the int8 ``wdot`` modes vs the dequantised
  f32 matmul, (e) the chat LM's fused prefill attention (cuDNN) vs the
  masked einsum, (f) the fused ACS graph metrics vs networkx (or, without
  networkx, the same program on the host CPU).
* ``e2e`` — the served path through the library entry points the CLI
  uses: (i) ``vidgraph stream --live-kg`` over 8 synthetic cameras with
  the 1.2B captioner and the chat LM extracting triplets, (ii) ``vidgraph
  kg`` then ``vidgraph retrieve``, (iii) ``vidgraph serve`` answering HTTP
  requests.

``--four`` runs only the device check (four cards) and the mesh paths: a
row-sharded memory search and a tensor-parallel 1.2B decode, each against
the same work on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Weights and data are random, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel_l2(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------- device
def device_phase(count: int) -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"device: JAX found no GPU (platform {d.platform!r}, "
            f"{d.device_kind!r}); chip_smoke.py runs on the card only")
    if len(devs) < count:
        raise SystemExit(f"device: {count} GPUs needed, JAX sees "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    say(f"device: {d.device_kind} x{len(devs)} (platform {d.platform})")
    for line in smi.stdout.strip().splitlines():
        say(f"nvidia-smi: {line.strip()}")
    say(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache {jax.config.jax_compilation_cache_dir}")
    return {"platform": d.platform, "kind": d.device_kind, "count": count}


# ---------------------------------------------------------------- parity
def parity_topk(seed: int, rows: int = 200_000, dim: int = 512,
                queries: int = 16, k: int = 5, tol: float = 1e-4) -> None:
    """(a) cosine top-k through EmbeddingStore.search vs float64 numpy."""
    from vidgraph_tpu.memory.embedding_store import EmbeddingStore

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(rows, dim)).astype(np.float32)
    q = rng.normal(size=(queries, dim)).astype(np.float32)
    store = EmbeddingStore(dim=dim, capacity=rows)
    store.add([f"r{i}" for i in range(rows)], vecs)
    check(len(store) >= store.device_min_rows, "store below device rows")
    hits = store.search(q, k=k)
    s64 = vecs.astype(np.float64)
    s64 /= np.linalg.norm(s64, axis=1, keepdims=True)
    q64 = q.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    ref = q64 @ s64.T
    err, agree, compared = 0.0, 0, 0
    for r in range(queries):
        order = np.argsort(-ref[r])[:k + 1]
        top = ref[r][order]
        got_idx = [int(i[1:]) for i, _ in hits[r]]
        got_val = np.asarray([v for _, v in hits[r]])
        check(len(got_idx) == k, f"query {r}: {len(got_idx)} hits")
        err = max(err, float(np.abs(got_val - ref[r][got_idx]).max()))
        check(got_val.min() >= top[k - 1] - tol,
              f"query {r}: a better row was missed")
        for j in range(k):
            gaps = [abs(top[j] - top[j + 1])] + (
                [abs(top[j] - top[j - 1])] if j else [])
            if min(gaps) > tol:          # outside a near-tie
                compared += 1
                agree += got_idx[j] == int(order[j])
    say(f"parity (a) cosine_topk {rows}x{dim} f32, {queries} queries, "
        f"k={k}: precision=HIGHEST tol={tol:g} max_score_err={err:.3g} "
        f"index_agree={agree}/{compared} (outside near-ties)")
    check(err <= tol, f"cosine_topk score error {err} > {tol}")
    check(agree == compared, "cosine_topk index disagreement off a tie")


def parity_vit(seed: int, frames: int = 160, height: int = 240,
               width: int = 320, vit_cfg=None, min_cos: float = 0.999
               ) -> None:
    """(b) bf16 ViT tower vs the same tower in f32 at highest precision."""
    import jax
    import jax.numpy as jnp

    from vidgraph_tpu.models.vit import ViTConfig, VisionTower, \
        init_vision_tower
    from vidgraph_tpu.ops.preprocess import preprocess_frames

    cfg = vit_cfg or ViTConfig.b32()
    model, params = init_vision_tower(cfg, seed)
    rng = np.random.default_rng(seed)
    u8 = jnp.asarray(rng.integers(0, 256, (frames, height, width, 3),
                                  dtype=np.uint8))
    x = preprocess_frames(u8, size=cfg.image_size, fast=True)
    got = np.asarray(jax.jit(model.apply)(params, x))
    ref_model = VisionTower(dataclasses.replace(cfg, dtype=jnp.float32))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(ref_model.apply)(params,
                                                  x.astype(jnp.float32)))
    check(got.shape == (frames, cfg.embed_dim) and np.isfinite(got).all(),
          f"ViT output {got.shape} not finite")
    cos = np.sum(got * ref, 1) / (np.linalg.norm(got, axis=1)
                                  * np.linalg.norm(ref, axis=1))
    say(f"parity (b) ViT {cfg.layers}x{cfg.width} on {frames} frames "
        f"{height}x{width} (fast preprocess): bf16 vs f32 precision=highest,"
        f" tol min cosine>={min_cos} observed min={cos.min():.6f}")
    check(cos.min() >= min_cos, f"ViT cosine {cos.min()} < {min_cos}")


def parity_captioner(seed: int, cap_cfg=None, rows: int = 8,
                     tokens: int = 56, steps: int = 16,
                     tol: float = 3e-2) -> None:
    """(c) bf16 1.2B captioner prefill logits and greedy decode vs f32."""
    import jax
    import jax.numpy as jnp

    from vidgraph_tpu.models.captioner import (CaptionerConfig, forward,
                                               generate, init_params)

    cfg = cap_cfg or CaptionerConfig.large()
    params = init_params(cfg, seed, param_dtype=jnp.bfloat16)
    rng = np.random.default_rng(seed)
    vis = jnp.asarray(rng.normal(size=(rows, cfg.num_vision_tokens,
                                       cfg.vision_dim)).astype(np.float32))
    toks = jnp.asarray(rng.integers(3, 256, (rows, tokens)), jnp.int32)
    got = np.asarray(forward(params, cfg, vis, toks))
    dec = np.asarray(generate(params, cfg, vis, max_new=steps))
    ref_p = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    ref_cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(forward(ref_p, ref_cfg, vis, toks))
        ref_dec = np.asarray(generate(ref_p, ref_cfg, vis, max_new=steps))
    del ref_p
    check(np.isfinite(got).all(), "captioner logits not finite")
    err = max(rel_l2(got[r], ref[r]) for r in range(rows))
    agree = float((dec == ref_dec).mean())
    say(f"parity (c) captioner {cfg.layers}x{cfg.width} "
        f"({cfg.num_params / 1e9:.2f}B, bf16 storage) prefill {rows}x"
        f"{tokens + cfg.num_vision_tokens}: vs f32 precision=highest, tol "
        f"row rel-L2<={tol:g} observed max={err:.3g}; {steps}-step greedy "
        f"token agreement {agree:.3f} (random weights: near-ties diverge)")
    check(err <= tol, f"captioner logits rel error {err} > {tol}")


def _int8_dot_kept(hlo: str) -> bool:
    """Whether a compiled program multiplies int8 by int8 into int32: a
    dot, a GEMM fusion (its computation header lists the s8 parameters
    and the s32 result) or a cuBLAS GEMM with both operands s8."""
    for line in hlo.splitlines():
        if (line.count("s8[") >= 2 and "s32[" in line
                and ("gemm" in line or "dot(" in line)):
            return True
    return False


def parity_wdot(seed: int, shapes=None, tol_a16: float = 1e-2,
                tol_a8: float = 2.5e-2) -> None:
    """(d) int8 weight matmuls vs the dequantised f32 matmul, and whether
    XLA keeps the a8 dot in int8."""
    import jax
    import jax.numpy as jnp

    from vidgraph_tpu.models.quant8 import quantize_matrix, wdot

    shapes = shapes or [(m, 2048, n) for m in (8, 32) for n in (6144, 8192)
                        ] + [(m, 8192, 2048) for m in (8, 32)]
    rng = np.random.default_rng(seed)
    kept = 0
    for m, k, n in shapes:
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = quantize_matrix(jnp.asarray(
            (rng.normal(size=(k, n)) * 0.02).astype(np.float32)))
        ref = x.astype(np.float64) @ (np.asarray(w.q, np.float64)
                                      * np.asarray(w.s, np.float64))
        xb = jnp.asarray(x, jnp.bfloat16)
        errs = {}
        for mode in ("a16", "a8"):
            fn = jax.jit(lambda a, q, s, mode=mode: wdot(
                a, type(w)(q, s), jnp.bfloat16, mode))
            errs[mode] = rel_l2(fn(xb, w.q, w.s), ref)
        hlo = jax.jit(lambda a, q, s: wdot(a, type(w)(q, s), jnp.bfloat16,
                                           "a8")).lower(xb, w.q, w.s) \
            .compile().as_text()
        int8_gemm = _int8_dot_kept(hlo)
        kept += int8_gemm
        say(f"parity (d) wdot M={m} K={k} N={n}: vs dequantised f32 "
            f"(float64 host); a16 rel-L2 {errs['a16']:.3g} (tol "
            f"{tol_a16:g}), a8 rel-L2 {errs['a8']:.3g} (tol {tol_a8:g}); "
            f"a8 compiled as an int8 x int8 dot: {int8_gemm}")
        check(errs["a16"] <= tol_a16, f"a16 error {errs['a16']}")
        check(errs["a8"] <= tol_a8, f"a8 error {errs['a8']}")
    check(kept, "no a8 dot was compiled as an int8 x int8 dot")


def parity_attention(seed: int, cases=((8, 2048), (32, 2048)), cfg=None,
                     tol: float = 1e-2, grad_case=(4, 1024),
                     grad_tol: float = 2e-2) -> None:
    """(e) fused prefill attention (cuDNN on the card) vs masked einsum,
    and its gradient (the training path)."""
    import jax
    import jax.numpy as jnp

    from vidgraph_tpu.models.captioner import (CaptionerConfig,
                                               _masked_attention,
                                               _prefix_causal_mask,
                                               attention_implementation,
                                               prefix_causal_attention)

    cfg = cfg or CaptionerConfig.chat()
    nv, h = cfg.num_vision_tokens, cfg.heads
    hd = cfg.width // h
    impl = attention_implementation()
    rng = np.random.default_rng(seed)
    for b, t_pad in cases:
        t = nv + t_pad
        q, k, v = (jnp.asarray(rng.normal(size=(b, t, h, hd)),
                               jnp.bfloat16) for _ in range(3))
        got = jax.jit(lambda q, k, v: prefix_causal_attention(
            q, k, v, nv))(q, k, v)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda q, k, v: _masked_attention(
                q, k, v, _prefix_causal_mask(t, nv), jnp.float32))(
                    *(a.astype(jnp.float32) for a in (q, k, v)))
        err = rel_l2(got, ref)
        say(f"parity (e) chat prefill attention B={b} T={t} h={h} hd={hd} "
            f"nv={nv}: {impl} bf16 vs masked einsum f32 precision=highest,"
            f" tol rel-L2<={tol:g} observed {err:.3g}")
        check(err <= tol, f"attention error {err} > {tol}")
    # the training path differentiates through the fused kernel
    b, t = grad_case[0], nv + grad_case[1]
    q, k, v = (jnp.asarray(rng.normal(size=(b, t, h, hd)), jnp.bfloat16)
               for _ in range(3))
    w = jnp.asarray(rng.normal(size=(b, t, h, hd)), jnp.float32)
    got = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        w * prefix_causal_attention(q, k, v, nv).astype(jnp.float32)),
        argnums=(0, 1, 2)))(q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
            w * _masked_attention(q, k, v, _prefix_causal_mask(t, nv),
                                  jnp.float32)), argnums=(0, 1, 2)))(
            *(a.astype(jnp.float32) for a in (q, k, v)))
    errs = [rel_l2(g, r) for g, r in zip(got, ref)]
    say(f"parity (e) attention gradient B={b} T={t}: {impl} bf16 vs masked "
        f"einsum f32 precision=highest, tol rel-L2<={grad_tol:g} observed "
        f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}")
    check(max(errs) <= grad_tol, f"attention gradient error {errs}")


def _seeded_graph(n: int, m: int, seed: int) -> np.ndarray:
    """Preferential-attachment graph with each edge given a random
    direction."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), np.float32)
    targets = list(range(m))
    pool: list = []
    for v in range(m, n):
        for t in set(targets):
            if rng.random() < 0.5:
                adj[v, t] = 1.0
            else:
                adj[t, v] = 1.0
        pool.extend(targets)
        pool.extend([v] * m)
        targets = [pool[i] for i in rng.integers(0, len(pool), m)]
    return adj


def parity_acs(seed: int, nodes: int = 926) -> None:
    """(f) the fused ACS dispatch vs networkx, or vs the same program on
    the host CPU when networkx is not installed."""
    import jax

    from vidgraph_tpu.core.config import ACSConfig
    from vidgraph_tpu.pipeline.acs import ACSAutomata

    adj = _seeded_graph(nodes, 2, seed)
    names = [f"n{i}" for i in range(nodes)]
    acs = ACSAutomata.__new__(ACSAutomata)
    # exact networkx reference (no sampling) for the parity check
    acs.config = ACSConfig(backend="xla", exact_efficiency_max_nodes=nodes,
                           betweenness_k=nodes)
    acs.store = type("S", (), {"entities": {x: {} for x in names},
                               "chunks": {}})()
    got = acs._compute(names, adj, "xla")
    try:
        import networkx  # noqa: F401
        ref_name = "networkx (exact)"
        ref = acs._compute(names, adj, "networkx")
        tols = {"global_efficiency": 1e-3, "avg_path_length": 1e-3,
                "diameter_estimate": 0, "weakly_connected_components": 0,
                "largest_wcc_size": 0, "avg_betweenness_centrality": 1e-3,
                "max_betweenness_centrality": 1e-3,
                "clustering_coefficient": 1e-3,
                "degree_assortativity": 1e-3,
                "pagerank_top10_percent": 0.5, "graph_robustness": 1e-3}
    except ImportError:
        ref_name = "same jitted program on the host CPU"
        with jax.default_device(jax.devices("cpu")[0]):
            ref = acs._compute(names, adj, "xla")
        tols = {k: 1e-3 for k in (
            "global_efficiency", "avg_path_length", "diameter_estimate",
            "weakly_connected_components", "largest_wcc_size",
            "avg_betweenness_centrality", "max_betweenness_centrality",
            "clustering_coefficient", "degree_assortativity",
            "pagerank_top10_percent", "graph_robustness")}
    worst = {k: abs(float(got[k]) - float(ref[k])) for k in tols}
    say(f"parity (f) ACS fused dispatch, {nodes} nodes "
        f"{int(adj.sum())} edges: reference {ref_name}; f32, tolerances "
        f"{tols}; observed {worst}")
    for k, tol in tols.items():
        check(worst[k] <= tol, f"ACS {k}: {got[k]} vs {ref[k]}")


# ------------------------------------------------------------------- e2e
@dataclasses.dataclass(frozen=True)
class Sizes:
    """Widths and scale of the e2e phases (the full run uses the repo's
    served configurations; tests use tiny ones)."""
    vit: object
    captioner: object
    chat: object
    caption_max_new: int = 48
    chat_max_new: int = 128       # live-KG decode budget per completion
    kg_chat_max_new: int = 768    # the CLI's chat-LM default
    streams: int = 8
    height: int = 240
    width: int = 320
    fps: float = 30.0
    frames_per_chunk: int = 5
    warm_seconds: float = 2.0
    video_seconds: float = 8.0
    live_queries: int = 10
    history_rows: int = 9000      # > memory/embedding_store._DEVICE_MIN_ROWS
    kg_captions: int = 18
    retrieval_queries: int = 5
    http_ingests: int = 20
    http_queries: int = 5


def full_sizes() -> Sizes:
    from vidgraph_tpu.models.captioner import CaptionerConfig
    from vidgraph_tpu.models.vit import ViTConfig

    return Sizes(vit=ViTConfig.b32(), captioner=CaptionerConfig.large(),
                 chat=CaptionerConfig.chat())


_OBJECTS = ["beaker", "flask", "balance", "glove", "pipette", "notebook",
            "monitor", "bottle", "tray", "goggles", "cabinet", "scale"]
_COLORS = ["red", "blue", "green", "yellow", "white", "black", "orange"]
_VERBS = ["holds", "pours", "weighs", "opens", "moves", "inspects",
          "places", "cleans"]


def _sentence(rng) -> str:
    return (f"The person {rng.choice(_VERBS)} a {rng.choice(_COLORS)} "
            f"{rng.choice(_OBJECTS)} next to the {rng.choice(_COLORS)} "
            f"{rng.choice(_OBJECTS)} on the lab bench.")


def _caption(rng, n: int = 4) -> str:
    return " ".join(_sentence(rng) for _ in range(n))


def camera(seed: int, height: int, width: int):
    """Seeded frames of coloured blocks moving over a per-camera
    background: every camera and every frame differ."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 96, 3).astype(np.uint8)
    blocks = [(rng.integers(0, 256, 3).astype(np.uint8),
               rng.uniform(0.1, 0.3) * height, rng.uniform(0.1, 0.3) * width,
               rng.uniform(0, height), rng.uniform(0, width),
               rng.uniform(-4, 4), rng.uniform(-6, 6)) for _ in range(3)]
    t = 0
    while True:
        frame = np.empty((height, width, 3), np.uint8)
        frame[:] = bg
        for color, bh, bw, y0, x0, vy, vx in blocks:
            y = int(y0 + vy * t) % height
            x = int(x0 + vx * t) % width
            frame[y:y + int(bh), x:x + int(bw)] = color
        frame ^= rng.integers(0, 8, frame.shape, dtype=np.uint8)
        t += 1
        yield frame


def _config(workdir: str, llm: str = "tpu"):
    from vidgraph_tpu.core.config import PipelineConfig

    return PipelineConfig.from_dict({
        "backend": {"vlm": "tpu", "llm": llm, "embedder": "tpu",
                    "reranker": "tpu"},
        "acs": {"backend": "xla"},
        "graph_store": {"persist_dir": os.path.join(workdir, "graph_store")},
        "saving_batch_metrics": False,
    })


def e2e_stream(sizes: Sizes, seed: int, workdir: str) -> dict:
    """(i) ``vidgraph stream --live-kg``: cameras -> in-process captioner ->
    memory + live KG extraction by the chat LM, with live queries."""
    import jax.numpy as jnp

    from vidgraph_tpu.services.embed_client import make_embed_client
    from vidgraph_tpu.services.llm_client import TPUChatClient
    from vidgraph_tpu.services.vlm_client import TPUVLMClient
    from vidgraph_tpu.streams import (LiveKGIngestor, RealtimeEngine,
                                      StreamSpec, simulate)

    config = _config(workdir)
    embed = make_embed_client(config.backend.embedder,
                              dim=config.embedding_memory.dim)
    vlm = TPUVLMClient(vit_cfg=sizes.vit, cap_cfg=sizes.captioner, seed=seed,
                       max_new=sizes.caption_max_new,
                       param_dtype=jnp.bfloat16)
    chat = TPUChatClient(cfg=sizes.chat, max_new=sizes.chat_max_new)
    check(chat._grammar is not None, "chat LM grammar is off")
    errors: list = []
    specs = [StreamSpec(f"cam{i}", fps=sizes.fps, chunk_size_seconds=1.0,
                        frames_per_chunk=sizes.frames_per_chunk,
                        height=sizes.height, width=sizes.width)
             for i in range(sizes.streams)]

    def run(video_seconds: float, queries, history: int):
        ingestor = LiveKGIngestor(config, chat, embed)

        async def kg_extract(sid, cid, caption, label):
            try:
                await ingestor(sid, cid, caption, label)
            except Exception as e:       # recorded, then re-raised
                errors.append(f"{sid}/{cid}: {e!r}")
                raise

        engine = RealtimeEngine(specs, embed_client=embed, vlm_client=vlm,
                                kg_extractor=kg_extract)
        if history:   # an hours-long memory on cam0: the device search
            rng = np.random.default_rng(seed + 1)
            texts = [f"[{i}] {_caption(rng, 2)}" for i in range(history)]
            vecs = embed.embed(texts)
            engine.memories["cam0"].add([f"hist_{i}" for i in
                                         range(history)], vecs)
        sources = {s.stream_id: camera(seed + i, sizes.height, sizes.width)
                   for i, s in enumerate(specs)}

        async def go():
            out = await simulate(engine, sources,
                                 video_seconds=video_seconds,
                                 queries=queries)
            await ingestor.flush()
            return out

        out = asyncio.run(go())
        ingestor.close()
        return engine, out

    run(sizes.warm_seconds, [(0.5, "cam0", "what is on the bench?")], 0)
    rng = np.random.default_rng(seed + 2)
    queries = [(0.5 + j * (sizes.video_seconds - 1.0) / sizes.live_queries,
                f"cam{j % sizes.streams}",
                f"where is the {rng.choice(_COLORS)} "
                f"{rng.choice(_OBJECTS)}?")
               for j in range(sizes.live_queries)]
    engine, out = run(sizes.video_seconds, queries, sizes.history_rows)
    done = sum(s["chunks_done"] for s in out["streams"].values())
    expected = int(sizes.video_seconds) * sizes.streams
    mem = engine.memories["cam0"]
    batch_min = embed._impl.device_min_batch
    say(f"e2e (i) stream --live-kg: chunks captioned {done}/{expected}, "
        f"queries answered {out['queries_served']}/{sizes.live_queries}, "
        f"kg task errors {len(errors)}, realtime factor "
        f"{out['realtime_factor']}, coverage {done / expected:.3f}, query "
        f"p50 {out['query_p50_ms']} ms (information only); cam0 memory "
        f"{len(mem)} rows (device search from {mem.device_min_rows}), "
        f"history embed batch {sizes.history_rows} (device from "
        f"{batch_min})")
    check(done == expected, f"captioned {done}/{expected} chunks")
    check(out["queries_served"] == sizes.live_queries,
          f"answered {out['queries_served']}/{sizes.live_queries} queries")
    check(not errors, f"kg task exceptions: {errors[:3]}")
    check(len(mem) >= mem.device_min_rows, "cam0 memory off the device")
    check(sizes.history_rows >= batch_min, "history embed off the device")
    return {"chunks": done, "expected": expected,
            "queries": out["queries_served"]}


def _vlm_output(path: str, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    results = [{"time": f"00:{5 * i // 60:02d}:{5 * i % 60:02d}-"
                        f"00:{(5 * i + 4) // 60:02d}:{(5 * i + 4) % 60:02d}",
                "content": _caption(rng, 5), "chunk_idx": i,
                "processing_time": 0.0} for i in range(n)]
    Path(path).write_text(json.dumps({
        "metadata": {"run_id": f"smoke-{seed}", "video_path": "synthetic",
                     "total_chunks": n},
        "results": results}))


def e2e_kg_retrieve(sizes: Sizes, seed: int, workdir: str) -> dict:
    """(ii) ``vidgraph kg`` then ``vidgraph retrieve`` on a seeded
    vlm_output.json."""
    from vidgraph_tpu.graph import open_graph_store
    from vidgraph_tpu.pipeline.kg_builder import KGBuilder
    from vidgraph_tpu.pipeline.retriever import OfflineRetriever
    from vidgraph_tpu.services.llm_client import TPUChatClient

    config = _config(workdir)
    vlm_json = os.path.join(workdir, "vlm_output.json")
    _vlm_output(vlm_json, sizes.kg_captions, seed)
    # the chat LM make_chat_client("tpu") builds, at these sizes
    chat = TPUChatClient(cfg=sizes.chat, max_new=sizes.kg_chat_max_new)
    builder = KGBuilder(config, chat_client=chat)
    uuid = asyncio.run(builder.build_knowledge_graph(vlm_json))
    acs_errors = [m["acs_metrics"]["error"]
                  for m in builder.metrics.batch_metrics
                  if "error" in m["acs_metrics"]]
    store = open_graph_store(config, uuid)
    counts = store.get_chunk_counts()
    store.close()
    retriever = OfflineRetriever(config, uuid)
    rng = np.random.default_rng(seed + 3)
    texts = []
    try:
        for _ in range(sizes.retrieval_queries):
            rec = asyncio.run(retriever.retrieve(
                f"What does the person do with the {rng.choice(_OBJECTS)}?"))
            texts.append(rec["retrieval"])
    finally:
        retriever.close()
    answered = sum(1 for t in texts if t and t.strip())
    say(f"e2e (ii) kg + retrieve: {len(builder.metrics.batch_metrics)} "
        f"batches, chunks stored {counts['total_chunks']} with embeddings "
        f"{counts['with_embedding']}, ACS (xla) errors {len(acs_errors)}, "
        f"retrievals with text {answered}/{sizes.retrieval_queries}")
    check(counts["total_chunks"] > 0, "no chunk stored")
    check(counts["with_embedding"] == counts["total_chunks"],
          "chunk stored without an embedding")
    check(not acs_errors, f"ACS errors: {acs_errors[:2]}")
    check(answered == sizes.retrieval_queries, "a retrieval had no text")
    return {"chunks": counts["total_chunks"], "retrievals": answered}


async def _http(port: int, method: str, path: str, body=None) -> dict:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Type: application/json\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    check(status == 200, f"{method} {path} -> HTTP {status}: {data[:200]!r}")
    return json.loads(data)


def e2e_server(sizes: Sizes, seed: int, workdir: str) -> dict:
    """(iii) ``vidgraph serve``: ingest and query over HTTP."""
    from vidgraph_tpu.services.server import VideoMemoryServer

    server = VideoMemoryServer(_config(workdir), host="127.0.0.1", port=0)
    rng = np.random.default_rng(seed + 4)

    async def go():
        await server.start()
        try:
            for i in range(sizes.http_ingests):
                r = await _http(server.port, "POST", "/v1/ingest", {
                    "stream": f"cam{i % 2}", "chunk_id": f"c{i}",
                    "content": _caption(rng, 2),
                    "time": f"00:{i:02d}-00:{i + 1:02d}"})
                check(r["ok"], f"ingest {i}: {r}")
            hits = 0
            for j in range(sizes.http_queries):
                r = await _http(server.port, "POST", "/v1/query", {
                    "stream": f"cam{j % 2}", "k": 3,
                    "query": f"the {rng.choice(_OBJECTS)} on the bench"})
                check(r["ok"], f"query {j}: {r}")
                hits += bool(r["chunks"])
            stats = await _http(server.port, "GET", "/v1/stats")
            return hits, stats
        finally:
            await server.stop()

    hits, stats = asyncio.run(go())
    total = sizes.http_ingests + sizes.http_queries + 1
    say(f"e2e (iii) serve: HTTP requests served {stats['requests_served']}"
        f"/{total}, queries with hits {hits}/{sizes.http_queries}, "
        f"memories {stats['streams']}")
    check(stats["requests_served"] == total, "requests lost")
    check(hits == sizes.http_queries, "a query found no chunk")
    return {"requests": stats["requests_served"]}


def e2e_phase(sizes: Sizes, seed: int) -> None:
    with tempfile.TemporaryDirectory(prefix="vidgraph_smoke_") as workdir:
        cwd = os.getcwd()
        os.chdir(workdir)      # the pipeline writes logs/ metrics/ here
        try:
            e2e_stream(sizes, seed, workdir)
            e2e_kg_retrieve(sizes, seed, workdir)
            e2e_server(sizes, seed, workdir)
        finally:
            os.chdir(cwd)


# ------------------------------------------------------------- four cards
def four_phase(seed: int, rows: int = 200_000, dim: int = 512,
               cap_cfg=None, steps: int = 16, tol: float = 3e-2) -> None:
    """Row-sharded search and tensor-parallel 1.2B decode over a 4-device
    mesh, each against the same work on one device."""
    import jax
    import jax.numpy as jnp

    from vidgraph_tpu.memory.embedding_store import EmbeddingStore
    from vidgraph_tpu.models.captioner import (CaptionerConfig, forward,
                                               generate, init_params)
    from vidgraph_tpu.parallel.mesh import build_mesh
    from vidgraph_tpu.parallel.serving import shard_captioner_params
    from vidgraph_tpu.parallel.sharded_search import ShardedEmbeddingStore

    devs = jax.devices()[:4]
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(rows, dim)).astype(np.float32)
    q = rng.normal(size=(16, dim)).astype(np.float32)
    ids = [f"r{i}" for i in range(rows)]
    one = EmbeddingStore(dim=dim, capacity=rows, device=devs[0])
    one.add(ids, vecs)
    sharded = ShardedEmbeddingStore(build_mesh(devs, model_axis=1), dim=dim,
                                    capacity=rows)
    sharded.add(ids, vecs)
    h1, h4 = one.search(q, k=5), sharded.search(q, k=5)
    err = max(abs(a[1] - b[1]) for r1, r4 in zip(h1, h4)
              for a, b in zip(r1, r4))
    same = sum(a[0] == b[0] for r1, r4 in zip(h1, h4)
               for a, b in zip(r1, r4))
    say(f"four: row-sharded search {rows}x{dim} over 4 devices vs one: max "
        f"score diff {err:.3g} (tol 1e-4), ids equal {same}/{16 * 5}")
    check(err <= 1e-4, f"sharded search score diff {err}")

    cfg = cap_cfg or CaptionerConfig.large()
    params = init_params(cfg, seed, param_dtype=jnp.bfloat16)
    vis = jnp.asarray(rng.normal(size=(8, cfg.num_vision_tokens,
                                       cfg.vision_dim)).astype(np.float32))
    toks = jnp.asarray(rng.integers(3, 256, (8, 56)), jnp.int32)
    p1 = jax.device_put(params, devs[0])
    ref = np.asarray(forward(p1, cfg, vis, toks))
    ref_dec = np.asarray(generate(p1, cfg, vis, max_new=steps))
    del p1
    mesh = build_mesh(devs, model_axis=4)
    tp = shard_captioner_params(params, mesh)
    with mesh:
        got = np.asarray(forward(tp, cfg, vis, toks))
        dec = np.asarray(generate(tp, cfg, vis, max_new=steps))
    lerr = max(rel_l2(got[r], ref[r]) for r in range(8))
    first = float((dec[:, 0] == ref_dec[:, 0]).mean())
    say(f"four: tensor-parallel {cfg.num_params / 1e9:.2f}B captioner over "
        f"model=4 vs one device: prefill logits row rel-L2 {lerr:.3g} (tol "
        f"{tol:g}); decode first-token agreement {first:.3f}, {steps}-step "
        f"agreement {float((dec == ref_dec).mean()):.3f}")
    check(lerr <= tol, f"tensor-parallel logits error {lerr}")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (REPO / "vidgraph_tpu").is_dir():
        raise SystemExit("chip_smoke.py needs the repository around it "
                         "(vidgraph_tpu/ not found)")
    t0 = time.perf_counter()
    say("== device")
    device = device_phase(4 if args.four else 1)
    if args.four:
        say("== four")
        four_phase(args.seed)
    else:
        say("== parity")
        parity_topk(args.seed)
        parity_vit(args.seed)
        parity_captioner(args.seed)
        parity_wdot(args.seed)
        parity_attention(args.seed)
        parity_acs(args.seed)
        say("== e2e")
        e2e_phase(full_sizes(), args.seed)
    say(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
