"""Multi-device embedding-memory search: store rows sharded over the mesh
"data" axis, each device scores its shard, global top-k via collectives.

This is the scale-out path for the embedding memory once a single card's
memory (or its bandwidth) is the bottleneck — e.g. hours-long video
memories across four GPUs.  ``ShardedEmbeddingStore`` is a drop-in subclass
of ``memory.embedding_store.EmbeddingStore`` (same host-side bookkeeping,
id semantics, persistence and host-BLAS routing below the device
threshold); only the device mirror placement and the jitted search differ.
It is what ``parallel.serving.make_embedding_store`` hands the serving
path (graph store vector search, realtime stream memories, the HTTP
memory server) whenever a multi-device mesh is active.

XLA inserts the collectives: the row-sharded score matrix feeds
``lax.top_k`` over the full row axis, which lowers to per-shard top-k +
all-gather + final reduction (NCCL over NVLink on GPUs).  The
reference's equivalent concurrency surface was an asyncio gather of HTTP searches
(reference: src/pipeline/retriever_hybrid.py:166-169).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..memory.embedding_store import EmbeddingStore
from ..ops.topk_cosine import l2_normalize
from .mesh import DATA_AXIS


@functools.partial(jax.jit, static_argnames=("k",))
def _search_jit(q: jax.Array, store: jax.Array, count: jax.Array, k: int):
    """Per-shard cosine scoring + global top-k (XLA inserts the gather)."""
    qn = l2_normalize(q)
    scores = jax.lax.dot_general(
        qn, store, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    valid = jnp.arange(store.shape[0]) < count
    scores = jnp.where(valid[None, :], scores, -1e30)
    return jax.lax.top_k(scores, k)


@jax.jit
def _scores_jit(q: jax.Array, store: jax.Array) -> jax.Array:
    qn = l2_normalize(q)
    return jax.lax.dot_general(
        qn, store, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)


class ShardedEmbeddingStore(EmbeddingStore):
    """Drop-in ``EmbeddingStore`` whose device mirror is row-sharded over
    the mesh "data" axis.  Host-side semantics (id overwrite, growth,
    persistence, small-store host-BLAS routing) are inherited unchanged."""

    def __init__(self, mesh: Mesh, dim: int, capacity: int = 8192,
                 **kw) -> None:
        self.mesh = mesh
        self._data_size = mesh.shape[DATA_AXIS]
        self._row_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
        self._rep = NamedSharding(mesh, P())
        super().__init__(dim=dim, capacity=capacity, **kw)

    # -- device paths ---------------------------------------------------------
    def _padded_host(self) -> np.ndarray:
        """Host buffer padded to a row count divisible by the data axis
        (capacity is a power of two, so this is a no-op for power-of-two
        meshes; odd device counts pad a few zero rows)."""
        cap = self._host.shape[0]
        rem = cap % self._data_size
        if rem == 0:
            return self._host
        pad = self._data_size - rem
        return np.concatenate(
            [self._host, np.zeros((pad, self.dim), np.float32)])

    def _device_store(self) -> jax.Array:
        if self._mirror_dirty or self._mirror is None:
            self._mirror = jax.device_put(self._padded_host(),
                                          self._row_sharding)
            self._mirror_dirty = False
        return self._mirror

    def _device_topk(self, q: np.ndarray, kk: int):
        with self._lock:
            store = self._device_store()
            count = self._count
        qd = jax.device_put(jnp.asarray(q, jnp.float32), self._rep)
        with self.mesh:
            vals, idx = _search_jit(qd, store, jnp.int32(count), kk)
        return np.asarray(vals), np.asarray(idx)

    def _device_scores(self, q: np.ndarray) -> np.ndarray:
        with self._lock:
            store = self._device_store()
            count = self._count
        qd = jax.device_put(jnp.asarray(q, jnp.float32), self._rep)
        with self.mesh:
            s = _scores_jit(qd, store)
        return np.asarray(s[:, :count])
