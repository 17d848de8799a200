"""Coverage for small remaining surfaces: platform utils, time labels,
legacy online retriever, tokenizer edges, network info."""
import asyncio
import json

import numpy as np
import pytest

from vidgraph_tpu.core.config import PipelineConfig
from vidgraph_tpu.core.platform import PlatformUtils
from vidgraph_tpu.graph.embedded import EmbeddedGraphStore
from vidgraph_tpu.io.video import format_chunk_time
from vidgraph_tpu.models.tokenizer import EOS_ID, PAD_ID, decode, encode
from vidgraph_tpu.pipeline.network_info import NetworkInfoProvider
from vidgraph_tpu.pipeline.retriever import OnlineRetriever


def test_platform_utils():
    assert PlatformUtils.get_worker_count() >= 1
    assert PlatformUtils.get_video_backend() in ("opencv", "avfoundation")
    assert PlatformUtils.get_accelerator() in ("cpu", "gpu")
    assert PlatformUtils.device_count() >= 1


def test_format_chunk_time():
    assert format_chunk_time(0, 5.0) == "00:00-00:04"
    assert format_chunk_time(1, 5.0) == "00:05-00:09"
    assert format_chunk_time(12, 5.0) == "01:00-01:04"
    assert format_chunk_time(0, 1.0) == "00:00-00:00"


def test_tokenizer_edges():
    assert decode([EOS_ID]) == ""
    assert decode([PAD_ID, 65]) == "A"     # pad ids are skipped
    ids = encode("hi", max_len=2)
    assert len(ids) == 2                   # truncation applies


def test_network_info_string():
    s = EmbeddedGraphStore("netinfo", persist_dir=None, persist=False)
    info = NetworkInfoProvider(s).get_info()
    assert "netinfo" in info and "0 nodes" in info


def test_online_retriever_legacy(tmp_path):
    s = EmbeddedGraphStore("legacy", persist_dir=None, persist=False)
    s.add_batch_to_graph(
        [{"head": "Blue Glove", "relation": "worn by", "tail": "Person",
          "source_chunks": ["legacy_0_0"]}],
        [{"time": "00:00-00:04", "content": "x"}], 0,
        text_chunks=[{"id": "legacy_0_0", "content": "x", "index": 0}])
    sched = tmp_path / "sched.json"
    sched.write_text(json.dumps([
        {"time": "00:02", "query": "blue glove", "groundtruth": "blue"}]))
    cfg = PipelineConfig()
    r = OnlineRetriever(cfg, s, schedule_path=str(sched))
    out = asyncio.run(r.check_and_run_queries("00:00-00:04"))
    assert len(out) == 1
    assert "Blue Glove" in out[0]["retrieval"]
    # dedupe on second pass
    assert asyncio.run(r.check_and_run_queries("00:05-00:09")) == []
    r.save_results(str(tmp_path / "res.json"))
    assert json.loads((tmp_path / "res.json").read_text())


def test_prune_module_main(tmp_path):
    from vidgraph_tpu.pipeline.prune import main
    src = tmp_path / "in.json"
    src.write_text(json.dumps({"graph_uuid": "x", "nodes": [],
                               "relationships": [],
                               "export_format_version": "1.0"}))
    out = tmp_path / "out.json"
    assert main(["--input", str(src), "--output", str(out)]) == 0
    assert out.exists()


def test_chunk_timeout_widened_for_coalescing_clients():
    """An in-process device client cannot be cancelled mid-dispatch, so
    the per-chunk wall timeout must widen past a cold compile
    for ``coalesces_batches`` clients (and stay strict for HTTP ones)."""
    from vidgraph_tpu.pipeline.pre_injector import PreLLMInjector

    cfg = PipelineConfig()
    cfg.chunking.chunk_timeout_seconds = 0.05
    cfg.chunking.chunk_timeout_retries = 1

    class SlowChat:
        coalesces_batches = False

        async def complete(self, prompt, temperature=0.0, max_tokens=2048):
            await asyncio.sleep(0.2)
            return "a | near | b"

    inj = PreLLMInjector(cfg.chunking, cfg.llm_injector, cfg.embedder,
                         SlowChat(), None)
    trip, err = asyncio.run(inj._extract_chunk_triplets("text", "c0"))
    assert trip == [] and "timeout" in err

    class SlowCoalescingChat(SlowChat):
        coalesces_batches = True

    inj = PreLLMInjector(cfg.chunking, cfg.llm_injector, cfg.embedder,
                         SlowCoalescingChat(), None)
    trip, err = asyncio.run(inj._extract_chunk_triplets("text", "c0"))
    assert err is None and len(trip) == 1
