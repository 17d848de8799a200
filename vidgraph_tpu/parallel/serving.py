"""Serving-path mesh plumbing: one switch that turns multi-chip on.

The reference scaled by HTTP fan-out to external model servers
(reference: src/pipeline/retriever_hybrid.py:166-169); the in-process
equivalent is a process-wide ``jax.sharding.Mesh`` that the *product*
code paths consult:

* ``make_embedding_store(dim, ...)`` — every embedding memory in the
  serving path (graph-store chunk vectors, realtime stream memories, the
  HTTP memory server) calls this instead of constructing
  ``EmbeddingStore`` directly; with an active mesh it returns a
  row-sharded ``ShardedEmbeddingStore`` (global top-k over the mesh).
* ``shard_captioner_params`` / ``shard_vit_params`` — in-process model
  clients pass their weights through these so captioner/ViT *inference*
  runs tensor-parallel over the mesh "model" axis (same shardings the trainer
  uses, models/train.py).
* ``serving_mesh()`` — the active mesh or None.

Policy (``mesh.enabled`` in the YAML config tree):

* ``"auto"`` (default) — a mesh is built iff the process sees more than
  one JAX device (one GPU serves single-device; a 4-GPU host
  shards automatically).
* ``true`` / ``false`` — force on (even on one device) / off.

``configure()`` is called from ``PipelineConfig`` loading, so every CLI
entry point and engine picks the policy up without explicit wiring; the
mesh itself is built lazily on first use (importing a config must not
initialise a JAX backend).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..core.logger import get_logger

logger = get_logger("serving")

_lock = threading.Lock()
_policy: Dict[str, Any] = {"enabled": "auto", "model_axis": 1}
_mesh: Any = None
_mesh_built = False


def configure(mesh_config: Any = None, *, enabled: Any = None,
              model_axis: Optional[int] = None) -> None:
    """Record the serving-mesh policy (lazy; builds nothing)."""
    global _mesh_built, _mesh
    with _lock:
        if mesh_config is not None:
            _policy["enabled"] = getattr(mesh_config, "enabled", "auto")
            _policy["model_axis"] = getattr(mesh_config, "model_axis", 1)
        if enabled is not None:
            _policy["enabled"] = enabled
        if model_axis is not None:
            _policy["model_axis"] = model_axis
        _mesh_built = False  # policy change invalidates the cached mesh
        _mesh = None


def serving_mesh():
    """The process-wide serving mesh, or None (single-device serving)."""
    global _mesh, _mesh_built
    with _lock:
        if _mesh_built:
            return _mesh
        enabled = _policy["enabled"]
        if enabled in (False, "false", "off", 0):
            _mesh, _mesh_built = None, True
            return None
        import jax

        n = len(jax.devices())
        if n < 2 and enabled in ("auto", None):
            _mesh, _mesh_built = None, True
            return None
        from .mesh import build_mesh

        _mesh = build_mesh(model_axis=int(_policy["model_axis"]))
        _mesh_built = True
        logger.info(
            "serving mesh active: %d devices, axes %s (embedding search "
            "row-sharded over 'data'; captioner/ViT inference tensor-"
            "sharded over 'model')", n, dict(_mesh.shape))
        return _mesh


def make_embedding_store(dim: int, capacity: int = 1024, **kw):
    """EmbeddingStore on one device; ShardedEmbeddingStore on a mesh."""
    mesh = serving_mesh()
    if mesh is None:
        from ..memory.embedding_store import EmbeddingStore

        return EmbeddingStore(dim=dim, capacity=capacity, **kw)
    from .sharded_search import ShardedEmbeddingStore

    return ShardedEmbeddingStore(mesh, dim=dim, capacity=capacity, **kw)


def shard_captioner_params(params: Dict, mesh=None) -> Dict:
    """Place a captioner param tree with the trainer's tensor-parallel
    specs (models/train.py::captioner_shardings): qkv/fc1 column-split,
    attn_o/fc2 row-split over "model"; embeddings/head replicated."""
    import jax

    mesh = mesh or serving_mesh()
    if mesh is None:
        return params
    from ..models.train import captioner_shardings

    return jax.device_put(params, captioner_shardings(params, mesh))


def shard_vit_params(params: Dict, mesh=None) -> Dict:
    """Place a ViT param tree with the trainer's tensor-parallel specs."""
    import jax

    mesh = mesh or serving_mesh()
    if mesh is None:
        return params
    from ..models.vit import param_shardings

    return jax.device_put(params, param_shardings(params, mesh))


class maybe_mesh:
    """``with maybe_mesh():`` — enters the serving mesh when active."""

    def __init__(self, mesh=None):
        self._mesh = mesh if mesh is not None else serving_mesh()

    def __enter__(self):
        if self._mesh is not None:
            self._ctx = self._mesh.__enter__()
            return self._ctx
        return None

    def __exit__(self, *exc):
        if self._mesh is not None:
            return self._mesh.__exit__(*exc)
        return False
