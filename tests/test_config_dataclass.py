"""The dataclass config tree: reference leniency (unknown keys kept at any
level), dict round trips, light coercion, independent defaults."""
import pytest

from vidgraph_tpu.core.config import (ACSConfig, MeshConfig, PipelineConfig,
                                      RetrievalConfig)


def test_unknown_keys_kept_at_every_level():
    cfg = PipelineConfig.from_dict({
        "brand_new_section": {"a": 1}, "top_level_flag": True,
        "chunking": {"max_connection_subgraph": 3, "mystery": "x"}})
    assert cfg.brand_new_section == {"a": 1}
    assert cfg.top_level_flag is True
    assert cfg.chunking.max_connection_subgraph == 3
    assert cfg.chunking.mystery == "x"
    assert cfg.to_dict()["chunking"]["mystery"] == "x"


def test_round_trip_through_dict():
    cfg = PipelineConfig.from_dict({"retrieval": {"top_k": 9},
                                    "mesh": {"axis_names": ["a", "b"]},
                                    "extra": [1, 2]})
    d = cfg.to_dict()
    again = PipelineConfig.from_dict(d)
    assert again.to_dict() == d
    assert again.retrieval.top_k == 9 and again.mesh.axis_names == ["a", "b"]


def test_ints_coerce_into_float_fields_only():
    cfg = PipelineConfig.from_dict({"video": {"chunk_size_seconds": 2},
                                    "kg": {"batch_size": 4}})
    assert cfg.video.chunk_size_seconds == 2.0
    assert isinstance(cfg.video.chunk_size_seconds, float)
    assert isinstance(cfg.kg.batch_size, int)


def test_defaults_are_independent_per_instance():
    a, b = PipelineConfig(), PipelineConfig()
    a.mesh.axis_names.append("x")
    a.retrieval.top_k = 99
    assert b.mesh.axis_names == ["data", "model"]
    assert PipelineConfig().retrieval.top_k == 5
    assert MeshConfig().axis_names == ["data", "model"]


def test_sections_take_keyword_arguments():
    assert RetrievalConfig(use_reranker=False).use_reranker is False
    assert ACSConfig(backend="networkx").backend == "networkx"
    with pytest.raises(TypeError):
        PipelineConfig.from_dict({"video": [1, 2]})
