"""Process-seed determinism of everything that feeds an LLM prompt.

Round-5 regression: builtin ``hash()`` / raw ``set`` iteration order are
PYTHONHASHSEED-randomised per process, and three spots leaked that order
into the deterministic build (the refiner's subgraph context sampler seed,
``source_chunk_ids`` append order whose ``ids[0]`` becomes the context
``ID:`` shown to the LLM, and graph-traversal context lists).  The same
`kg` command then produced 14/30 or 13/30 depending on the interpreter's
hash seed.  These tests re-run a miniature build in subprocesses with
different PYTHONHASHSEED values and require byte-identical prompts/state.
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json
from vidgraph_tpu.graph.embedded import EmbeddedGraphStore
from vidgraph_tpu.pipeline.pre_injector import PreLLMInjector
from vidgraph_tpu.core.config import PipelineConfig

store = EmbeddedGraphStore("detseed", persist=False, load_existing=False)
uuid = "abcd1234-0000-0000-0000-00000000ffff"
names = ["Beaker", "Blue Liquid", "Stirrer", "Glove", "Balance",
         "Spatula", "Vial", "Pipette", "Flask", "Funnel"]
for b in range(3):
    trips = []
    for i, n in enumerate(names):
        trips.append({"head": n, "relation": f"NEAR_{i % 3}",
                      "tail": names[(i + b + 1) % len(names)],
                      "source_chunks": [f"{b}_{i % 4}"]})
    chunks = [{"id": f"{uuid}_{b}_{i}", "content": f"text {b} {i}",
               "index": i, "embedding": None} for i in range(4)]
    store.add_batch_to_graph(trips, [{"time": f"00:0{b}", "content": "x"}],
                             b, text_chunks=chunks)

cfg = PipelineConfig()
inj = PreLLMInjector(cfg.chunking, cfg.llm_injector, cfg.embedder,
                     chat_client=None, embed_client=None)
subs = [inj._extract_subgraph_for_chunk_id(f"{uuid}_{b}_{i}", store)
        for b in range(3) for i in range(4)]
ents, chks, rels = store.expand_entity_graph_with_chunks(["Beaker"], 3)
state = {
    "subgraphs": subs,
    "src": {n: store.entities[n].get("source_chunk_ids", [])
            for n in store.entities},
    "expand": [ents, chks, rels],
}
print(json.dumps(state, sort_keys=True))
"""


def _run(seed: str) -> str:
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONHASHSEED": seed, "PATH": os.environ.get("PATH", ""),
             "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
             "HOME": os.environ.get("HOME", str(REPO))},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


def test_build_state_invariant_to_hash_seed():
    out1 = _run("1")
    out2 = _run("31337")
    assert out1 == out2


def test_subgraph_sampler_seed_ignores_run_uuid():
    """The sampled-connection RNG must key on the uuid-free short id so
    two runs of the same build (fresh uuids) sample identically."""
    from vidgraph_tpu.pipeline.pre_injector import get_short_chunk_id
    import zlib
    a = zlib.crc32(get_short_chunk_id("uuid-aaaa_3_1").encode())
    b = zlib.crc32(get_short_chunk_id("uuid-bbbb_3_1").encode())
    assert a == b
