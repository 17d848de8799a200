"""The main path imports nothing outside jax, numpy and the standard
library: each module imports (and a tiny slice of it runs) in a child
process whose import system refuses flax, pydantic, yaml, cv2, networkx,
tiktoken and httpx."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_BLOCKER = r"""
import sys
BLOCKED = {"flax", "pydantic", "yaml", "cv2", "networkx", "tiktoken",
           "httpx"}

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Block())
"""

MODULES = [
    "vidgraph_tpu.cli.main",
    "vidgraph_tpu.core.config",
    "vidgraph_tpu.models.vit",
    "vidgraph_tpu.models.captioner",
    "vidgraph_tpu.services.vlm_client",
    "vidgraph_tpu.services.llm_client",
    "vidgraph_tpu.services.server",
    "vidgraph_tpu.pipeline.kg_builder",
    "vidgraph_tpu.pipeline.retriever",
    "vidgraph_tpu.pipeline.acs",
    "vidgraph_tpu.streams",
    "chip_smoke",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", _BLOCKER + code], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_optional_packages(module):
    proc = _run(f"import {module}\nprint('OK')")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_main_path_runs_without_optional_packages():
    code = r"""
import numpy as np
from vidgraph_tpu.core.config import ACSConfig, PipelineConfig
from vidgraph_tpu.pipeline.acs import ACSAutomata
from vidgraph_tpu.pipeline.text_splitter import TokenTextSplitter
import chip_smoke

cfg = PipelineConfig.from_dict({"acs": {"backend": "xla"}})
assert cfg.acs.backend == "xla"
assert len(TokenTextSplitter(40, 8).split_text("word " * 200)) > 1
adj = chip_smoke._seeded_graph(60, 2, 0)
names = [f"n{i}" for i in range(60)]
acs = ACSAutomata.__new__(ACSAutomata)
acs.config = ACSConfig(backend="xla")
acs.store = type("S", (), {"entities": {n: {} for n in names},
                           "chunks": {}})()
m = acs._compute(names, adj, "xla")
assert m["node_count"] == 60 and m["relationship_count"] > 0
print("OK")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_blocker_really_blocks():
    proc = _run("import yaml")
    assert proc.returncode != 0 and "blocked" in proc.stderr
