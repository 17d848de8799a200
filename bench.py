"""Benchmark: online hybrid-retrieval latency on a reference-scale graph.

Builds a graph of the same scale as the reference's committed MVP run
(~600 entities, 326 chunks, ~1.6k relationships — BASELINE.md) with
device-resident chunk embeddings, then measures end-to-end hybrid
retrieval latency (query embedding -> fused cosine top-k vector search ->
fulltext entity search -> 2-hop traversal -> post-compression -> rerank ->
formatting) at the shipped retrieval settings.

Baseline: the reference measured 2.392 s/query average offline retrieval
(BASELINE.md, data/metrics/mvp_retrieval_times_*.json).  vs_baseline is the
speedup factor (baseline_ms / p50_ms).

Prints ONE JSON line:
{"metric": "online_retrieval_p50_ms", "value": N, "unit": "ms",
 "vs_baseline": N, "device": {...}, ...extras}

It measures the GPU it runs on and fails when JAX finds none.
"""
from __future__ import annotations

import asyncio
import json
import random
import statistics
import tempfile
import time

BASELINE_RETRIEVAL_MS = 2392.2  # reference avg offline retrieval (MVP run)

N_ENTITIES = 600
N_CHUNKS = 326
N_RELS = 1600
N_QUERIES = 30
WARMUP = 5

_OBJECTS = ["beaker", "flask", "balance", "smartphone", "glove", "pipette",
            "table", "cabinet", "bottle", "notebook", "monitor", "wire",
            "foil", "extinguisher", "door", "scale", "tray", "goggles"]
_COLORS = ["red", "blue", "green", "yellow", "white", "black", "gray",
           "cyan", "magenta", "orange"]
_VERBS = ["holds", "contains", "displays", "is on", "is near", "uses",
          "wears", "touches", "observes", "supports"]


def _build_graph(store, embedder, rng: random.Random) -> None:
    entities = [f"{rng.choice(_COLORS).title()} "
                f"{rng.choice(_OBJECTS).title()} {i}"
                for i in range(N_ENTITIES)]
    texts, chunk_specs = [], []
    for i in range(N_CHUNKS):
        color = rng.choice(_COLORS)
        obj = rng.choice(_OBJECTS)
        verb = rng.choice(_VERBS)
        text = (f"Time: {i // 12:02d}:{(i * 5) % 60:02d} Content: the person "
                f"{verb} a {color} {obj} on the laboratory bench while a "
                f"{rng.choice(_COLORS)} {rng.choice(_OBJECTS)} sits nearby.")
        texts.append(text)
        chunk_specs.append((f"bench_{i // 3}_{i % 3}", text, i))
    embs = embedder.embed(texts)

    batch = [{"time": "00:00-00:04", "content": "bench"}]
    triplets, chunks = [], []
    for i, (cid, text, idx) in enumerate(chunk_specs):
        chunks.append({"id": cid, "content": text, "index": idx % 3,
                       "embedding": [float(x) for x in embs[i]],
                       "time": f"{(idx*5)//60:02d}:{(idx*5)%60:02d}-"
                               f"{(idx*5+4)//60:02d}:{(idx*5+4)%60:02d}"})
    for j in range(N_RELS):
        h = entities[rng.randrange(N_ENTITIES)]
        t = entities[rng.randrange(N_ENTITIES)]
        if h == t:
            continue
        src = chunk_specs[rng.randrange(N_CHUNKS)][0]
        triplets.append({"head": h, "relation": rng.choice(_VERBS),
                         "tail": t, "source_chunks": [src]})
    # inject in reference-sized batches
    bs_t, bs_c = 25, 6
    n_batches = max(len(triplets) // bs_t, len(chunks) // bs_c) + 1
    for b in range(n_batches):
        store.add_batch_to_graph(
            triplets[b * bs_t:(b + 1) * bs_t], batch, b,
            text_chunks=chunks[b * bs_c:(b + 1) * bs_c])


def _device() -> dict:
    """The accelerator every number below was measured on; no GPU is an
    error, never a silent CPU measurement."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> None:
    device = _device()
    from vidgraph_tpu.core.config import PipelineConfig
    from vidgraph_tpu.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu.pipeline.retriever_hybrid import HybridRetriever
    from vidgraph_tpu.services.embed_client import make_embed_client
    from vidgraph_tpu.services.rerank_client import make_rerank_client

    rng = random.Random(42)
    cfg = PipelineConfig()
    cfg.retrieval.entity_first = False      # exercise the vector path
    cfg.retrieval.post_compression = True
    cfg.retrieval.rerank_after_traversal = True

    embedder = make_embed_client("tpu", dim=cfg.embedding_memory.dim)
    reranker = make_rerank_client("tpu", embed_client=embedder)

    with tempfile.TemporaryDirectory() as tmp:
        store = EmbeddedGraphStore("bench", persist_dir=tmp, persist=False)
        t0 = time.perf_counter()
        _build_graph(store, embedder, rng)
        build_s = time.perf_counter() - t0

        retriever = HybridRetriever(cfg.retrieval, store, embedder,
                                    reranker, output_file=None)
        queries = [
            f"What color is the {rng.choice(_OBJECTS)} "
            f"{rng.choice(['on the bench', 'in the lab', 'nearby'])}?"
            for _ in range(N_QUERIES)]

        async def run_all():
            for q in queries[:WARMUP]:
                await retriever.perform_hybrid_retrieval(q)
            times = []
            for q in queries:
                t = time.perf_counter()
                text, _ = await retriever.perform_hybrid_retrieval(q)
                times.append((time.perf_counter() - t) * 1e3)
                assert text
            return times

        times = asyncio.run(run_all())

    times.sort()
    p50 = statistics.median(times)
    p95 = times[int(0.95 * (len(times) - 1))]

    # realtime first: the stream engine is a latency-sensitive systems
    # benchmark and reads low when queued work from other stages is live
    rt = _realtime_factor()
    # the stream scenario as ONE system: in-process captioner in the loop
    ns = _realtime_captioner()
    # int8 captioner variant, and the full in-process stack (int8 1.2B
    # captioner + trained instruct LM doing the KG extraction + live
    # retrieval, all on one device) when its checkpoint exists
    import os as _os
    _ckpt = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                          "checkpoints", "instruct_lm.npz")
    ns_int8 = _realtime_captioner(quantize="int8")
    if _os.path.exists(_ckpt):
        ns_full = _realtime_captioner(quantize="int8",
                                          instruct_ckpt=_ckpt)
    else:
        ns_full = {"factor": None, "query_p50_ms": None, "coverage": None,
                   "extracted_triplets": None}
    # secondary: frames/sec through preprocess + ViT-B/32 embed
    fps = _frames_per_second()
    cap = _captioner_decode()
    big = _large_store_topk_ms()
    acs_ms = _acs_metrics_ms()
    kg_llm = _kg_chat_lm_s_per_batch()

    print(json.dumps({
        "metric": "online_retrieval_p50_ms",
        "value": round(p50, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_RETRIEVAL_MS / p50, 1),
        "device": device,
        "p95_ms": round(p95, 3),
        "mean_ms": round(statistics.mean(times), 3),
        "graph": {"entities": N_ENTITIES, "chunks": N_CHUNKS,
                  "rels": N_RELS, "build_s": round(build_s, 2)},
        "frames_per_sec_chip": round(fps, 1),
        "captioner_params": cap["params"],
        "captioner_tokens_per_sec": cap["tokens_per_sec"],
        "captioner_tokens_per_sec_8streams": cap["tokens_per_sec_8"],
        "captioner_large_params": cap["large_params"],
        "captioner_large_tokens_per_sec": cap["large_tokens_per_sec"],
        "captioner_large_tokens_per_sec_8streams":
            cap["large_tokens_per_sec_8"],
        "realtime_8x30fps_factor": round(rt, 2),
        "realtime_8x30fps_captioner_factor": ns["factor"],
        "query_p50_under_load_ms": ns["query_p50_ms"],
        "captioner_coverage": ns["coverage"],
        "realtime_8x30fps_captioner_int8_factor": ns_int8["factor"],
        "captioner_int8_coverage": ns_int8["coverage"],
        # full in-process stack: int8 1.2B captioner + 26M instruct LM
        # (grammar-constrained extraction) + live retrieval on one device
        "realtime_8x30fps_full_stack_factor": ns_full["factor"],
        "full_stack_query_p50_ms": ns_full["query_p50_ms"],
        "full_stack_coverage": ns_full["coverage"],
        "full_stack_extracted_triplets": ns_full["extracted_triplets"],
        # 200k-row store top-k: pipelined = 16-query batches with
        # overlapping dispatches (the serving number), blocking = one
        # batch fetched to host per call
        "large_store_rows": 200_000,
        "large_store_topk_pipelined_ms": big["pipelined_ms"],
        "large_store_topk_blocking_ms": big["blocking_ms"],
        "acs_full_metrics_ms_926n": round(acs_ms, 1),
        "kg_chat_lm_s_per_batch": kg_llm,
        "baseline_retrieval_ms": BASELINE_RETRIEVAL_MS,
        "baseline_kg_s_per_batch": 21.3,
    }))


def _frames_per_second() -> float:
    """Device throughput: fast preprocess (bf16 separable-matmul resize)
    + ViT-B/32 embed of 160 frames/dispatch (32 chunks x 5 frames).
    Returns frames/s."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vidgraph_tpu.models.vit import ViTConfig, init_vision_tower
    from vidgraph_tpu.ops.preprocess import preprocess_frames

    cfg = ViTConfig.b32()
    model, params = init_vision_tower(cfg, seed=0)
    apply = jax.jit(lambda p, f: model.apply(
        p, preprocess_frames(f, size=cfg.image_size, fast=True)))
    B = 160
    frames = jnp.asarray(np.random.default_rng(0).integers(
        0, 256, size=(B, 720, 1280, 3), dtype=np.uint8))
    np.asarray(apply(params, frames))  # compile + warmup
    reps = 10
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = apply(params, frames)
    np.asarray(out)
    dt = time.perf_counter() - t0
    return B * reps / dt


def _captioner_decode() -> dict:
    """Captioner LM greedy-decode throughput (KV-cached lax.scan) at two
    scales: the 25M ``base`` model and the ~1.2B ``large`` serving-scale
    model (VERDICT r2 #2 — Qwen2-VL-2B-class shapes, bf16 weights).
    tokens/s/chip at the max-throughput batch and at the 8-stream
    realtime scenario.  Param counts are emitted so the numbers can't be
    misread across scales."""
    import jax.numpy as jnp
    import numpy as np

    from vidgraph_tpu.models.captioner import (CaptionerConfig, generate,
                                               init_params)

    rng = np.random.default_rng(0)
    max_new = 64
    out = {}
    scales = (
        ("", CaptionerConfig.base(),
         (("tokens_per_sec_8", 8), ("tokens_per_sec", 128))),
        ("large_", CaptionerConfig.large(),
         (("tokens_per_sec_8", 8), ("tokens_per_sec", 32))),
    )
    for prefix, cfg, batches in scales:
        params = init_params(cfg, seed=0, param_dtype=jnp.bfloat16)
        out[prefix + "params"] = cfg.num_params
        for key, b in batches:
            vis = jnp.asarray(rng.normal(
                size=(b, cfg.num_vision_tokens, cfg.vision_dim)
            ).astype(np.float32))
            np.asarray(generate(params, cfg, vis, max_new=max_new))
            reps = 5
            t0 = time.perf_counter()
            toks = None
            for _ in range(reps):
                toks = generate(params, cfg, vis, max_new=max_new)
            np.asarray(toks)
            dt = time.perf_counter() - t0
            out[prefix + key] = round(b * max_new * reps / dt, 1)
        del params  # free device memory before the next scale / stage
    return out


def _large_store_topk_ms() -> dict:
    """Scale path: fused cosine top-k over a 200k x 512 device store (a
    ~9-hour continuous video memory), per-query.  Two numbers with pinned
    meanings: ``pipelined`` amortises 16-query batches over back-to-back
    dispatches (the steady-state serving figure); ``blocking`` fetches
    every batch to host (the cold single-request figure)."""
    import numpy as np

    from vidgraph_tpu.memory.embedding_store import EmbeddingStore

    rng = np.random.default_rng(0)
    store = EmbeddingStore(dim=512, capacity=200_000)
    n = 200_000
    step = 20_000
    for i in range(0, n, step):
        store.add([f"c{j}" for j in range(i, i + step)],
                  rng.normal(size=(step, 512)).astype(np.float32))
    q = rng.normal(size=(16, 512)).astype(np.float32)
    store.search(q, k=5)      # compile + warm (batch shape)
    store.search(q[:1], k=5)  # compile + warm (single-query shape)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        hits = store.search(q, k=5)
    pipelined = (time.perf_counter() - t0) / reps / 16 * 1e3
    assert hits[0]
    t0 = time.perf_counter()
    for _ in range(reps):
        hits = store.search(q[:1], k=5)
    blocking = (time.perf_counter() - t0) / reps * 1e3
    return {"pipelined_ms": round(pipelined, 3),
            "blocking_ms": round(blocking, 3)}


def _acs_metrics_ms() -> float:
    """Full ACS network-metric pass (one fused device dispatch: distance
    family, exact Brandes betweenness, clustering, PageRank, assortativity,
    robustness, device Louvain) on a 926-node graph — the reference runs
    this per KG batch via NetworkX (~0.8-1.5 s at this size)."""
    import networkx as nx
    import numpy as np

    from vidgraph_tpu.core.config import ACSConfig
    from vidgraph_tpu.pipeline.acs import ACSAutomata

    G = nx.barabasi_albert_graph(926, 2, seed=0)
    adj = nx.to_numpy_array(G).astype(np.float32)
    names = [f"n{i}" for i in range(926)]
    acs = ACSAutomata.__new__(ACSAutomata)
    acs.config = ACSConfig()
    acs.store = type("S", (), {"entities": {n: {} for n in names},
                               "chunks": {}})()
    acs._compute(names, adj, "xla")   # compile/warm
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        m = acs._compute(names, adj, "xla")
    dt = time.perf_counter() - t0
    assert m["node_count"] == 926
    return dt / reps * 1e3


def _realtime_factor() -> float:
    """8 concurrent 30 fps streams (north-star scenario): video-seconds
    processed per wall-second; >= 1.0 sustains all 8 streams live."""
    import asyncio

    import numpy as np

    from vidgraph_tpu.services.embed_client import make_embed_client
    from vidgraph_tpu.services.vlm_client import LocalVLMClient
    from vidgraph_tpu.streams import RealtimeEngine, StreamSpec, simulate

    specs = [StreamSpec(f"cam{i}", fps=30.0, chunk_size_seconds=1.0,
                        frames_per_chunk=5, height=240, width=320)
             for i in range(8)]
    engine = RealtimeEngine(specs,
                            embed_client=make_embed_client("tpu", dim=512),
                            vlm_client=LocalVLMClient())
    frame = np.zeros((240, 320, 3), np.uint8)
    frame[40:200, 60:260] = (200, 30, 30)

    def src():
        while True:
            yield frame

    # warmup on a THROWAWAY engine: fresh jit shapes compile here, and the
    # timed engine starts with empty buffers
    warm_engine = RealtimeEngine(
        specs, embed_client=make_embed_client("tpu", dim=512),
        vlm_client=LocalVLMClient())
    asyncio.run(simulate(warm_engine, {f"cam{i}": src() for i in range(8)},
                         video_seconds=1.0))
    out = asyncio.run(simulate(engine, {f"cam{i}": src()
                                        for i in range(8)},
                               video_seconds=8.0))
    return float(out["realtime_factor"] or 0.0)


def _realtime_captioner(quantize=None,
                            instruct_ckpt: str = "") -> dict:
    """The stream scenario as ONE system: 8 concurrent 30 fps streams
    where the 1.2B in-process captioner produces
    every caption (batched decode), KG extraction runs in the background
    on each caption, and online queries are served concurrently under
    load.  Emits the realtime factor, query p50 under load, and chunk
    coverage.

    Variants: ``quantize='int8'`` serves the captioner via the
    weight-only int8 path; ``instruct_ckpt`` puts the trained instruct
    LM in the KG-extraction role (TPUChatClient with grammar-constrained
    decode) so one device runs captioning (1.2B) + extraction (26M) +
    retrieval concurrently."""
    import asyncio

    import jax.numpy as jnp
    import numpy as np

    from vidgraph_tpu.models.captioner import CaptionerConfig
    from vidgraph_tpu.pipeline.pre_injector import PreLLMInjector
    from vidgraph_tpu.pipeline.prompts import build_pre_llm_prompt
    from vidgraph_tpu.services.embed_client import make_embed_client
    from vidgraph_tpu.services.llm_client import (LocalChatClient,
                                                  TPUChatClient)
    from vidgraph_tpu.services.vlm_client import TPUVLMClient
    from vidgraph_tpu.streams import RealtimeEngine, StreamSpec, simulate

    vlm = TPUVLMClient(cap_cfg=CaptionerConfig.large(), max_new=48,
                       param_dtype=jnp.bfloat16, quantize=quantize)
    if instruct_ckpt:
        chat = TPUChatClient(checkpoint_path=instruct_ckpt,
                             batch_wait_ms=40.0)
    else:
        chat = LocalChatClient()
    kg_triplets = []

    async def kg_extract(sid, cid, caption, label):
        # short pipe-line outputs: a 128-byte budget keeps the chat LM's
        # decode scan off the captioner's critical path (grammar repair
        # closes any truncation)
        raw = await chat.complete(build_pre_llm_prompt(caption, 6),
                                  max_tokens=128)
        kg_triplets.extend(PreLLMInjector.parse_pipe_delimited(raw, cid))

    def make_engine():
        specs = [StreamSpec(f"cam{i}", fps=30.0, chunk_size_seconds=1.0,
                            frames_per_chunk=5, height=240, width=320)
                 for i in range(8)]
        return RealtimeEngine(specs,
                              embed_client=make_embed_client("tpu", dim=512),
                              vlm_client=vlm, kg_extractor=kg_extract)

    frame = np.zeros((240, 320, 3), np.uint8)
    frame[40:200, 60:260] = (30, 30, 200)

    def src():
        while True:
            yield frame

    # warmup engine: compile the serving-batch decode shapes AND the
    # query/retrieval path off the clock
    asyncio.run(simulate(make_engine(),
                         {f"cam{i}": src() for i in range(8)},
                         video_seconds=2.0,
                         queries=[(1.0, "cam0",
                                   "what color is the object?")]))
    kg_triplets.clear()
    engine = make_engine()
    video_s = 8.0
    queries = [(0.5 + 0.75 * j, f"cam{j % 8}",
                "what color is the object in the scene?")
               for j in range(10)]
    out = asyncio.run(simulate(engine, {f"cam{i}": src() for i in range(8)},
                               video_seconds=video_s, queries=queries))
    total_chunks = sum(s["chunks_done"]
                       for s in out["streams"].values())
    expected = int(video_s) * 8
    del vlm  # free the captioner weights before later stages
    return {
        "factor": round(float(out["realtime_factor"] or 0.0), 2),
        "query_p50_ms": (round(float(out["query_p50_ms"]), 2)
                         if out["query_p50_ms"] is not None else None),
        "coverage": round(total_chunks / expected, 3),
        "extracted_triplets": len(kg_triplets),
    }


def _kg_chat_lm_s_per_batch() -> float:
    """KG construction with the in-process instruction-tuned LLM doing the
    per-chunk extraction + refinement (``backend.llm: tpu``), measured on
    the first 6 batches of the real 215-chunk reference workload, against
    the reference's 21.3 s/batch (BASELINE.md).  None when the workload
    or the checkpoint is absent."""
    import os
    import tempfile

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "checkpoints", "instruct_lm.npz")
    ref = "/root/reference/data/outputs/vlm_output.json"
    if not (os.path.exists(ckpt) and os.path.exists(ref)):
        return None

    import asyncio

    from vidgraph_tpu.core.config import PipelineConfig
    from vidgraph_tpu.pipeline.kg_builder import KGBuilder

    cfg_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "config", "tpu_llm_config.yaml")
    cfg = PipelineConfig.from_yaml(cfg_path)
    cfg.llm_injector.checkpoint_path = ckpt
    cfg.graph_store.persist = False
    n_batches = 6

    # Pre-warm the pinned decode executables (extraction batches +
    # single-prompt refinement) so the 6-batch sample is the steady rate,
    # not compile time.
    from vidgraph_tpu.services.llm_client import TPUChatClient
    warm = TPUChatClient(checkpoint_path=ckpt)
    # both serving batch buckets (b_pad 8 and max_batch) — round 5's
    # small-batch bucket means 2 prompts no longer warms the 32-row
    # extraction executable
    warm.complete_batch_sync(["warm up the extraction shape"] * 2,
                             max_tokens=512)
    warm.complete_batch_sync(["warm up the extraction shape"] * 9,
                             max_tokens=512)
    warm.complete_batch_sync(["warm up the refinement shape"],
                             max_tokens=1024)
    del warm
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)   # KGBuilder writes logs/ metrics/ relative dirs
        try:
            builder = KGBuilder(cfg)
            t0 = time.perf_counter()
            asyncio.run(builder.build_knowledge_graph(
                ref, max_batches=n_batches))
            dt = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    return round(dt / n_batches, 2)


if __name__ == "__main__":
    main()
