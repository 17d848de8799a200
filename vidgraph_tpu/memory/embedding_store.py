"""Device-resident embedding memory with fused cosine top-k search.

This is the device-side replacement for three reference mechanisms:
Neo4j ``vector.similarity.cosine`` chunk search (reference:
src/pipeline/retriever_hybrid.py:284-323), the Python cosine loop over up to
5000 chunk embeddings (reference: src/components/pre_llm_injector.py:346-412)
and per-segment compression scoring (reference: src/pipeline/
retriever_hybrid.py:465-514).

Write path: rows are L2-normalised into a host-side staging buffer (writes
are frequent, small, and latency-sensitive on the ingest path — staging
costs no device compiles).  Read path: the buffer is mirrored to the device
once per generation as a capacity-padded ``[capacity, dim]`` array (capacity
doubles, so XLA sees a handful of static shapes) and every search is one
fused cosine matmul + masked top-k through ops.topk_cosine.

Multi-chip: rows can be sharded along the mesh "data" axis; each chip scores
its shard and top-k is taken after an all-gather of per-shard partials —
see parallel/mesh.py.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.topk_cosine import cosine_topk, cosine_scores

_MIN_CAPACITY = 1024

# Below this many rows a search runs as a host BLAS matmul: one device
# dispatch costs a fixed round trip that only amortises once the store is
# large (the crossover is not yet measured on the GPU).
_DEVICE_MIN_ROWS = 8192


class EmbeddingStore:
    """Append-mostly id -> embedding memory with device-mirrored search."""

    def __init__(self, dim: int, capacity: int = _MIN_CAPACITY,
                 dtype=jnp.float32, device: Optional[jax.Device] = None,
                 device_min_rows: int = _DEVICE_MIN_ROWS):
        self.dim = int(dim)
        self.dtype = dtype
        self._device = device
        self.device_min_rows = device_min_rows
        cap = _MIN_CAPACITY
        while cap < capacity:
            cap *= 2
        self._host = np.zeros((cap, self.dim), np.float32)
        self._count = 0
        self._ids: List[str] = []
        self._id_to_idx: Dict[str, int] = {}
        self._mirror: Optional[jax.Array] = None
        self._mirror_dirty = True
        self._lock = threading.RLock()

    # -- internals ----------------------------------------------------------
    def _grow(self, needed: int) -> None:
        cap = self._host.shape[0]
        if needed <= cap:
            return
        new_cap = cap
        while new_cap < needed:
            new_cap *= 2
        grown = np.zeros((new_cap, self.dim), np.float32)
        grown[:self._count] = self._host[:self._count]
        self._host = grown
        self._mirror_dirty = True

    def _device_store(self) -> jax.Array:
        if self._mirror_dirty or self._mirror is None:
            arr = jnp.asarray(self._host, self.dtype)
            if self._device is not None:
                arr = jax.device_put(arr, self._device)
            self._mirror = arr
            self._mirror_dirty = False
        return self._mirror

    # -- public -------------------------------------------------------------
    def __len__(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return int(self._host.shape[0])

    def add(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        """Insert/overwrite rows. ``vectors [n, dim]`` need not be
        normalised."""
        if len(ids) == 0:
            return
        vecs = np.asarray(vectors, np.float32)
        if vecs.shape != (len(ids), self.dim):
            raise ValueError(f"vectors shape {vecs.shape} != "
                             f"({len(ids)}, {self.dim})")
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        normed = vecs / np.maximum(norms, 1e-12)
        with self._lock:
            new = sum(1 for i in ids if i not in self._id_to_idx)
            self._grow(self._count + new)
            for rid, v in zip(ids, normed):
                idx = self._id_to_idx.get(rid)
                if idx is None:
                    idx = self._count
                    self._id_to_idx[rid] = idx
                    self._ids.append(rid)
                    self._count += 1
                self._host[idx] = v
            self._mirror_dirty = True

    def get(self, rid: str) -> Optional[np.ndarray]:
        idx = self._id_to_idx.get(rid)
        if idx is None:
            return None
        return self._host[idx].copy()

    def ids(self) -> List[str]:
        return list(self._ids)

    def vectors(self) -> np.ndarray:
        """[count, dim] host view (normalised rows)."""
        return self._host[:self._count].copy()

    def search(self, queries: np.ndarray, k: int,
               threshold: Optional[float] = None,
               ) -> List[List[Tuple[str, float]]]:
        """Top-k cosine matches per query row -> [(id, score), ...] lists."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self._count == 0:
            return [[] for _ in range(q.shape[0])]
        kk = min(k, self._count)
        if self._count < self.device_min_rows:
            scores = self._host_scores(q)
            idx = np.argsort(-scores, axis=1)[:, :kk]
            vals = np.take_along_axis(scores, idx, axis=1)
        else:
            vals, idx = self._device_topk(q, kk)
        out: List[List[Tuple[str, float]]] = []
        for r in range(q.shape[0]):
            row = []
            for c in range(kk):
                s = float(vals[r, c])
                if s <= -1e29:
                    continue
                if threshold is not None and s <= threshold:
                    continue
                row.append((self._ids[int(idx[r, c])], s))
            out.append(row)
        return out

    def _device_topk(self, q: np.ndarray, kk: int):
        """Fused device top-k over the mirrored store (single chip path;
        the sharded multi-chip store overrides this)."""
        with self._lock:
            store = self._device_store()
            count = self._count
        vals, idx = cosine_topk(jnp.asarray(q), store, k=kk,
                                valid_count=count)
        return np.asarray(vals), np.asarray(idx)

    def _host_scores(self, q: np.ndarray) -> np.ndarray:
        qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        with self._lock:
            return qn @ self._host[:self._count].T

    def similarity_matrix(self, queries: np.ndarray) -> np.ndarray:
        """Dense [nq, count] cosine scores (one matmul; host below the
        device-rows threshold)."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self._count == 0:
            return np.zeros((q.shape[0], 0), np.float32)
        if self._count < self.device_min_rows:
            return self._host_scores(q)
        return self._device_scores(q)

    def _device_scores(self, q: np.ndarray) -> np.ndarray:
        with self._lock:
            store = self._device_store()
            count = self._count
        # no validity mask needed: the slice below drops unwritten rows,
        # and building the mask was an extra device dispatch
        s = cosine_scores(jnp.asarray(q), store)
        return np.asarray(s[:, :count])

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"ids": list(self._ids), "vectors": self.vectors()}

    @classmethod
    def from_state(cls, state: Dict, dim: Optional[int] = None,
                   **kw) -> "EmbeddingStore":
        vecs = np.asarray(state["vectors"], np.float32)
        dim = dim or (vecs.shape[1] if vecs.size else 512)
        store = cls(dim=dim, capacity=max(_MIN_CAPACITY, len(state["ids"])),
                    **kw)
        if state["ids"]:
            store.add(state["ids"], vecs)
        return store
