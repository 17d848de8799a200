"""Serving-path mesh wiring (VERDICT r2 item 1): the product modules —
graph store vector search, hybrid retrieval, realtime engine memories,
in-process model clients — must route through the mesh when one is
active, and produce results identical to single-device serving.

Runs on the 8-virtual-CPU-device mesh (conftest).
"""
import asyncio

import numpy as np
import pytest

from vidgraph_tpu.core.config import PipelineConfig, RetrievalConfig
from vidgraph_tpu.parallel import serving


@pytest.fixture(autouse=True)
def _restore_serving_policy():
    yield
    serving.configure(enabled="auto", model_axis=1)


def test_policy_off_and_on():
    serving.configure(enabled=False)
    assert serving.serving_mesh() is None
    serving.configure(enabled=True, model_axis=2)
    mesh = serving.serving_mesh()
    assert mesh is not None
    assert mesh.shape["model"] == 2
    from vidgraph_tpu.parallel.sharded_search import ShardedEmbeddingStore

    store = serving.make_embedding_store(dim=16)
    assert isinstance(store, ShardedEmbeddingStore)
    serving.configure(enabled=False)
    from vidgraph_tpu.memory.embedding_store import EmbeddingStore

    store = serving.make_embedding_store(dim=16)
    assert type(store) is EmbeddingStore


def test_auto_enables_on_multidevice():
    # conftest gives this process 8 virtual CPU devices -> auto means ON
    serving.configure(enabled="auto", model_axis=1)
    assert serving.serving_mesh() is not None


def test_config_load_configures_serving():
    PipelineConfig.from_dict({"mesh": {"enabled": False}})
    assert serving.serving_mesh() is None
    PipelineConfig.from_dict({"mesh": {"enabled": True, "model_axis": 2}})
    assert serving.serving_mesh().shape["model"] == 2


def _build_graph_and_retrieve(query: str):
    from vidgraph_tpu.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu.pipeline.retriever_hybrid import HybridRetriever
    from vidgraph_tpu.services.embed_client import make_embed_client

    embed = make_embed_client("hash", dim=64)
    store = EmbeddedGraphStore("mesh-serve-test", persist_dir=None,
                               persist=False, dim=64)
    colors = ["red", "green", "blue", "white", "gray", "cyan", "magenta"]
    texts = [f"the {c} flask rests on shelf {i} of the cabinet"
             for i, c in enumerate(colors)]
    embs = embed.embed(texts)
    trips = [{"head": f"{c} flask", "relation": "rests on",
              "tail": f"shelf {i}", "source_chunks": [f"m_{i}_0"]}
             for i, c in enumerate(colors)]
    chunks = [{"id": f"m_{i}_0", "content": t, "index": 0,
               "embedding": [float(x) for x in embs[i]]}
              for i, t in enumerate(texts)]
    store.add_batch_to_graph(trips, [{"time": "00:00-00:05"}],
                             batch_idx=0, text_chunks=chunks)
    store._chunk_emb.device_min_rows = 0  # force the device search path
    rcfg = RetrievalConfig(use_reranker=False, post_compression=False)
    retr = HybridRetriever(rcfg, store, embed, None, output_file=None)
    result, _ = asyncio.run(retr.perform_hybrid_retrieval(query))
    return result, type(store._chunk_emb).__name__


def test_hybrid_retrieval_identical_mesh_vs_single():
    q = "Where is the blue flask?"
    serving.configure(enabled=True, model_axis=2)
    mesh_result, mesh_cls = _build_graph_and_retrieve(q)
    assert mesh_cls == "ShardedEmbeddingStore"
    serving.configure(enabled=False)
    single_result, single_cls = _build_graph_and_retrieve(q)
    assert single_cls == "EmbeddingStore"
    assert mesh_result == single_result


def test_tpu_vlm_caption_identical_mesh_vs_single():
    """Tensor-parallel captioner/ViT inference must caption identically."""
    from vidgraph_tpu.services.vlm_client import TPUVLMClient

    frames = [np.full((48, 48, 3), v, np.uint8) for v in (40, 200)]

    serving.configure(enabled=True, model_axis=2)
    tp_client = TPUVLMClient(preset="tiny64", max_new=16)
    assert tp_client._mesh is not None
    tp_caps = tp_client.caption_batch_sync([frames])

    serving.configure(enabled=False)
    sd_client = TPUVLMClient(preset="tiny64", max_new=16)
    assert sd_client._mesh is None
    sd_caps = sd_client.caption_batch_sync([frames])
    assert tp_caps == sd_caps


def test_tpu_chat_prompt_decode_identical_mesh_vs_single():
    """The round-3 prompt-token chat path (generate_from_tokens) must
    produce identical completions tensor-sharded vs single-device."""
    import jax.numpy as jnp

    from vidgraph_tpu.models.captioner import CaptionerConfig
    from vidgraph_tpu.services.llm_client import TPUChatClient

    cfg = CaptionerConfig(width=128, layers=2, heads=4, vision_dim=64,
                          num_vision_tokens=2, max_len=640,
                          dtype=jnp.float32)
    prompt = "Extract triplets: the person holds a red beaker."

    serving.configure(enabled=True, model_axis=2)
    tp = TPUChatClient(cfg=cfg, max_new=16)
    assert tp._mesh is not None
    tp_out = tp.complete_sync(prompt)

    serving.configure(enabled=False)
    sd = TPUChatClient(cfg=cfg, max_new=16)
    assert sd._mesh is None
    assert tp_out == sd.complete_sync(prompt)


def test_realtime_engine_memories_sharded_when_enabled():
    from vidgraph_tpu.services.embed_client import make_embed_client
    from vidgraph_tpu.streams.realtime import RealtimeEngine, StreamSpec

    serving.configure(enabled=True, model_axis=1)
    embed = make_embed_client("hash", dim=32)
    eng = RealtimeEngine([StreamSpec("s0", fps=2.0, frames_per_chunk=2,
                                     height=24, width=32)], embed)
    assert type(eng.memories["s0"]).__name__ == "ShardedEmbeddingStore"
