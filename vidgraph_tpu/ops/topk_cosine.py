"""Fused cosine-similarity scoring + top-k over a device-resident store.

This single op replaces three hot paths of the reference:
  * the pure-Python O(new x existing) cosine loop in subgraph injection
    (reference: src/components/pre_llm_injector.py:346-388),
  * Neo4j ``vector.similarity.cosine`` chunk search
    (reference: src/pipeline/retriever_hybrid.py:284-323),
  * per-segment post-compression scoring
    (reference: src/pipeline/retriever_hybrid.py:465-514).

Design: store rows are L2-normalised at insert time, so cosine similarity is
one matmul of the normalised query block against the store, followed by a
masked ``jax.lax.top_k`` — all inside ONE jit, so a search is one device
dispatch.  At a few query rows the matmul reads the whole store once and is
bound by memory bandwidth; XLA hands it to cuBLAS on the GPU.  Scores are
computed at ``Precision.HIGHEST``: the default float32 dot may run in TF32
(about three decimal digits), and at this arithmetic intensity the exact
product costs next to nothing.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_NEG = -1e30


def _scores(query: jax.Array, store: jax.Array) -> jax.Array:
    q = query.astype(jnp.float32)
    qn = q * jax.lax.rsqrt(jnp.sum(q * q, axis=-1, keepdims=True) + 1e-12)
    return jax.lax.dot_general(
        qn, store.astype(jnp.float32), (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)


def _bucket_rows(n: int) -> int:
    """Next power of two >= max(8, n): bounds the number of distinct jit
    shapes (each one is a compile)."""
    b = 8
    while b < n:
        b *= 2
    return b


def cosine_scores(query: jax.Array, store: jax.Array,
                  valid: Optional[jax.Array] = None) -> jax.Array:
    """Cosine scores of ``query [B,d]`` against pre-normalised ``store [N,d]``.

    ``valid [N]`` bool masks unwritten store rows to -1e30.  The query batch
    is padded to a power-of-two row bucket to bound compile count.
    """
    if store.shape[0] == 0:
        return jnp.zeros((query.shape[0], 0), jnp.float32)
    b = query.shape[0]
    bb = _bucket_rows(b)
    if bb != b:
        query = jnp.concatenate(
            [query, jnp.zeros((bb - b, query.shape[1]), query.dtype)])
    scores = _scores(query, store)[:b]
    if valid is not None:
        scores = jnp.where(valid[None, :], scores, _NEG)
    return scores


_TOPK_TILE = 32768
_TWO_STAGE_MIN = 65536


@functools.partial(jax.jit, static_argnames=("k",))
def _masked_topk(scores: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """Top-k over the row axis; two-stage (per-tile then across tile
    winners) from ``_TWO_STAGE_MIN`` rows.  On an H100, k=5 over 16 rows:
    one ``lax.top_k`` takes 0.43 ms at 200k columns and 1.30 ms at 1M,
    the two-stage form with 32768-wide tiles 0.27 and 0.50 ms (medians;
    PERF.md, Findings)."""
    b, n = scores.shape
    if n < _TWO_STAGE_MIN or k > _TOPK_TILE:
        return jax.lax.top_k(scores, k)
    n_pad = -(-n // _TOPK_TILE) * _TOPK_TILE
    if n_pad != n:   # padded rows carry the mask sentinel, never win
        scores = jnp.concatenate(
            [scores, jnp.full((b, n_pad - n), _NEG, scores.dtype)], axis=1)
    t = n_pad // _TOPK_TILE
    tiled = scores.reshape(b, t, _TOPK_TILE)
    v1, i1 = jax.lax.top_k(tiled, k)              # [b, t, k]
    v2, i2 = jax.lax.top_k(v1.reshape(b, t * k), k)   # [b, k]
    tile_idx = i2 // k
    within = jnp.take_along_axis(
        i1.reshape(b, t * k), i2, axis=1)
    return v2, (tile_idx * _TOPK_TILE + within).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def _fused_cosine_topk(query: jax.Array, store: jax.Array,
                       valid: jax.Array, k: int):
    """Score + mask + top-k in ONE jit: one device dispatch per search."""
    scores = jnp.where(valid[None, :], _scores(query, store), _NEG)
    return _masked_topk(scores, k)


@functools.partial(jax.jit, static_argnames=("k",))
def _fused_cosine_topk_count(query: jax.Array, store: jax.Array,
                             count: jax.Array, k: int):
    """As ``_fused_cosine_topk`` but the validity mask is derived from a
    scalar row count INSIDE the jit — building the [N]-bool mask outside
    would be a device dispatch of its own."""
    valid = jnp.arange(store.shape[0]) < count
    return _fused_cosine_topk(query, store, valid, k)


def cosine_topk(query: jax.Array, store: jax.Array, k: int,
                valid: Optional[jax.Array] = None,
                valid_count: Optional[int] = None,
                ) -> Tuple[jax.Array, jax.Array]:
    """Top-k cosine matches: returns (scores [B,k], indices [B,k]).

    Rows masked invalid come back with score <= -1e30; callers filter on a
    score threshold (the reference used >0.3 for chunk vector search).
    Prefer ``valid_count`` (first-N-rows-valid) over a ``valid`` mask
    array on hot paths — the mask is then built inside the fused jit.
    """
    n = store.shape[0]
    b = query.shape[0]
    if n == 0:
        return (jnp.full((b, k), _NEG, jnp.float32),
                jnp.zeros((b, k), jnp.int32))
    kk = min(k, n)
    bb = _bucket_rows(b)
    if bb != b:   # power-of-two query bucket: bounded compile count
        query = jnp.concatenate(
            [query, jnp.zeros((bb - b, query.shape[1]), query.dtype)])
    if valid_count is not None:
        vals, idx = _fused_cosine_topk_count(
            query, store, jnp.int32(valid_count), kk)
    else:
        if valid is None:
            valid = jnp.ones((n,), bool)
        vals, idx = _fused_cosine_topk(query, store, valid, kk)
    vals, idx = vals[:b], idx[:b]
    if kk < k:
        vals = jnp.concatenate(
            [vals, jnp.full((b, k - kk), _NEG, jnp.float32)], axis=1)
        idx = jnp.concatenate(
            [idx, jnp.zeros((b, k - kk), idx.dtype)], axis=1)
    return vals, idx


def l2_normalize(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    x = x.astype(jnp.float32)
    return x * jax.lax.rsqrt(jnp.sum(x * x, axis=axis, keepdims=True) + eps)
