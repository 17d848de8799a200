import json

import pytest

from vidgraph_tpu.core import MetricsTracker, PipelineConfig, get_logger


def test_config_defaults():
    cfg = PipelineConfig()
    assert cfg.video.chunk_size_seconds == 5.0
    assert cfg.kg.batch_size == 3
    assert cfg.retrieval.graph_hops == 2
    assert cfg.backend.embedder == "tpu"


def test_config_loads_reference_yaml(tmp_path):
    # The shipped config (the reference's tree plus this framework's own
    # sections) must load with the reference's values.
    cfg = PipelineConfig.from_yaml("config/base_config.yaml")
    assert cfg.chunking.chunk_size == 296
    assert cfg.chunking.max_triplets_per_chunk == 6
    assert cfg.llm_injector.subgraph_extraction_injection is True
    assert cfg.retrieval.entity_first is True
    assert cfg.retrieval.compression_threshold == 0.15
    assert cfg.chunking.max_connection_subgraph == 2
    assert cfg.saving_batch_metrics is True


def test_config_tolerates_unknown_keys(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("video:\n  chunk_size_seconds: 2.0\n  brand_new_key: 7\n")
    cfg = PipelineConfig.from_yaml(str(p))
    assert cfg.video.chunk_size_seconds == 2.0


def test_metrics_tracker(tmp_path):
    m = MetricsTracker()
    m.record_timing("stage", 1.0)
    m.record_timing("stage", 3.0)
    m.record_count("items", 5)
    m.add_batch_metrics({"batch_id": 0, "nodes": 10})
    s = m.get_summary()
    assert s["timings"]["stage"]["average"] == 2.0
    assert s["counts"]["items"] == 5
    out = tmp_path / "m.json"
    m.save_metrics(str(out))
    saved = json.loads(out.read_text())
    assert saved["batch_metrics"][0]["nodes"] == 10


def test_logger_is_idempotent(tmp_path):
    lg1 = get_logger("t_core_x", log_dir=str(tmp_path))
    lg2 = get_logger("t_core_x", log_dir=str(tmp_path))
    assert lg1 is lg2
    assert len(lg1.handlers) == 2


def test_shipped_configs_parse():
    cfg = PipelineConfig.from_yaml("config/base_config.yaml")
    assert cfg.backend.vlm == "tpu"
    assert cfg.graph_store.backend == "embedded"
    hr = PipelineConfig.from_yaml("config/high_recall_config.yaml")
    assert hr.retrieval.post_compression is False
    assert hr.retrieval.top_k_chunks == 5
    tl = PipelineConfig.from_yaml("config/tpu_llm_config.yaml")
    assert tl.backend.llm == "tpu"
    assert tl.benchmark_llm.judge_backend == "local"
    assert tl.chunking.chunk_timeout_seconds >= 60
    assert tl.llm_injector.checkpoint_path.endswith("instruct_lm.npz")


def test_benchmark_judge_backend_override():
    """benchmark_llm.judge_backend pins the judge client separately from
    answer generation (PARITY.md deliberate deviation)."""
    from vidgraph_tpu.pipeline.benchmark import BenchmarkEvaluator
    from vidgraph_tpu.services.llm_client import (HttpChatClient,
                                                  LocalChatClient)

    cfg = PipelineConfig()
    cfg.backend.llm = "http"
    cfg.benchmark_llm.judge_backend = "local"
    ev = BenchmarkEvaluator(cfg)
    assert isinstance(ev.chat, HttpChatClient)
    assert isinstance(ev.judge, LocalChatClient)

    cfg2 = PipelineConfig()
    cfg2.backend.llm = "local"
    ev2 = BenchmarkEvaluator(cfg2)      # default: one client, both roles
    assert ev2.judge is ev2.chat
