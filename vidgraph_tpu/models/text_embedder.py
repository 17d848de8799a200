"""Text embedders serving every place the reference called an external
OpenAI-compatible embeddings endpoint (reference: src/components/
neo4j_handler.py:27-31, src/components/pre_llm_injector.py:207-211,
src/pipeline/retriever_hybrid.py:41-47).

Two device-side embedders:

* ``HashedNGramEmbedder`` — deterministic character n-gram hashing into a
  bucket vector (host-side, vectorised numpy), followed by a fixed random
  projection matmul + L2 norm on the device.  No trained weights, zero egress,
  and lexically similar texts land close in cosine space — this is the
  default offline embedder and makes retrieval genuinely functional
  (a hashing vectorizer with a Johnson–Lindenstrauss projection).

* ``TransformerTextEmbedder`` — byte-level transformer encoder (mean-pooled),
  the slot where trained weights plug in for production quality.

Both are batched: N texts -> one [N, dim] device matmul.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.topk_cosine import l2_normalize
from . import tokenizer

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def _ngram_hashes(text: str, n_buckets: int, ns=(2, 3, 4)) -> np.ndarray:
    """Bucket-count vector for character n-grams (lowercased)."""
    counts = np.zeros(n_buckets, np.float32)
    b = text.lower().encode("utf-8", errors="replace")
    if not b:
        return counts
    arr = np.frombuffer(b, np.uint8).astype(np.uint64)
    for n in ns:
        if len(arr) < n:
            continue
        # rolling FNV-1a over n-byte windows, vectorised
        h = np.full(len(arr) - n + 1, _FNV_OFFSET, np.uint64)
        with np.errstate(over="ignore"):
            for j in range(n):
                h = (h ^ arr[j:len(arr) - n + 1 + j]) * _FNV_PRIME
        idx = (h % np.uint64(n_buckets)).astype(np.int64)
        np.add.at(counts, idx, 1.0)
    # sublinear tf
    np.log1p(counts, out=counts)
    return counts


@dataclasses.dataclass
class HashedNGramEmbedder:
    dim: int = 512
    n_buckets: int = 4096
    seed: int = 42
    # Below this many uncached texts the projection runs as a host BLAS
    # matmul: a device dispatch costs a fixed round trip that only
    # amortises on large batches (the crossover is not yet measured on
    # the GPU).  Recurring texts (entity names, relationship descriptions on
    # the rerank path) are served from the cache with no compute at all.
    device_min_batch: int = 1024
    cache_max: int = 200_000

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        proj = rng.normal(0.0, 1.0 / np.sqrt(self.dim),
                          size=(self.n_buckets, self.dim)).astype(np.float32)
        self._proj_host = proj
        self._proj = jnp.asarray(proj)
        self._embed_jit = jax.jit(self._device_embed)
        self._cache: dict = {}

    def _device_embed(self, counts: jax.Array) -> jax.Array:
        return l2_normalize(counts @ self._proj)

    def _batch_counts(self, texts: List[str]) -> np.ndarray:
        """n-gram bucket counts via the native C++ hasher when available
        (identical semantics), else the vectorised numpy path."""
        from .. import native

        counts = native.ngram_counts_batch(texts, self.n_buckets)
        if counts is not None:
            return counts
        return np.stack([_ngram_hashes(t, self.n_buckets) for t in texts])

    def _project(self, counts: np.ndarray) -> np.ndarray:
        n = counts.shape[0]
        if n >= self.device_min_batch:
            padded = 8
            while padded < n:
                padded *= 2
            if padded != n:
                counts = np.concatenate(
                    [counts,
                     np.zeros((padded - n, self.n_buckets), np.float32)])
            return np.asarray(self._embed_jit(jnp.asarray(counts)))[:n]
        out = counts @ self._proj_host
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """[N] texts -> [N, dim] float32 L2-normalised embeddings (cached)."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = np.empty((len(texts), self.dim), np.float32)
        missing_idx = []
        missing_texts = []
        for i, t in enumerate(texts):
            hit = self._cache.get(t)
            if hit is not None:
                out[i] = hit
            else:
                missing_idx.append(i)
                missing_texts.append(t)
        if missing_texts:
            counts = self._batch_counts(missing_texts)
            vecs = self._project(counts)
            if len(self._cache) + len(missing_texts) > self.cache_max:
                self._cache.clear()
            for i, t, v in zip(missing_idx, missing_texts, vecs):
                out[i] = v
                self._cache[t] = v
        return out

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed([text])[0]


def encoder_forward(params, cfg, tokens: jax.Array) -> jax.Array:
    """Bidirectional byte-level encoder: tokens [B,T] -> [B, dim] L2-normed.

    Reuses the captioner's transformer blocks with a per-example padding
    mask instead of the causal mask (``_block`` accepts 4-D masks);
    mean-pools the final hidden states over non-pad positions and projects
    through a trained output matrix.  ``params`` = {"enc": captioner-style
    param dict, "out_w": [width, dim]}.
    """
    from .captioner import _block, _ln

    enc = params["enc"]
    b, t = tokens.shape
    x = enc["tok_emb"][tokens] + enc["pos_emb"][:t][None]
    pad = tokens == tokenizer.PAD_ID
    mask = jnp.where(pad[:, None, None, :], jnp.float32(-1e30), 0.0)
    for bp in enc["blocks"]:
        x = _block(bp, cfg, x, mask)
    x = _ln(x, enc["ln_f_scale"], enc["ln_f_bias"])
    keep = (~pad).astype(jnp.float32)[..., None]
    pooled = (x * keep).sum(1) / jnp.maximum(keep.sum(1), 1.0)
    return l2_normalize(pooled @ params["out_w"])


class TransformerTextEmbedder:
    """Byte-level bidirectional transformer encoder, mean-pooled to [dim].

    Interface-complete with random weights; load a contrastively trained
    checkpoint (scripts/train_text_embedder.py) via ``checkpoint_path``.
    """

    def __init__(self, dim: int = 512, width: int = 256, layers: int = 4,
                 heads: int = 4, max_len: int = 128, seed: int = 0,
                 dtype: Any = jnp.bfloat16,
                 checkpoint_path: str = "") -> None:
        from .captioner import CaptionerConfig
        self.dim = dim
        self.max_len = max_len
        self._cfg = CaptionerConfig(
            width=width, layers=layers, heads=heads,
            vision_dim=width, num_vision_tokens=1, max_len=max_len + 1,
            dtype=dtype)
        self._params = init_encoder_params(self._cfg, dim, seed)
        if checkpoint_path:
            from .checkpoint import load_params
            self._params = load_params(self._params, checkpoint_path)
        self._fwd = jax.jit(
            lambda p, t: encoder_forward(p, self._cfg, t))
        self._cache: dict = {}

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        out = np.empty((len(texts), self.dim), np.float32)
        miss_i, miss_t = [], []
        for i, t in enumerate(texts):
            hit = self._cache.get(t)
            if hit is not None:
                out[i] = hit
            else:
                miss_i.append(i)
                miss_t.append(t)
        if miss_t:
            toks = tokenizer.batch_encode(miss_t, self.max_len)
            # power-of-two batch bucket: bounded compile count
            n = toks.shape[0]
            nb = 8
            while nb < n:
                nb *= 2
            if nb != n:
                toks = np.concatenate(
                    [toks, np.full((nb - n, toks.shape[1]),
                                   tokenizer.PAD_ID, toks.dtype)])
            vecs = np.asarray(self._fwd(self._params,
                                        jnp.asarray(toks)))[:n]
            if len(self._cache) > 200_000:
                self._cache.clear()
            for i, t, v in zip(miss_i, miss_t, vecs):
                out[i] = v
                self._cache[t] = v
        return out

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed([text])[0]


def init_encoder_params(cfg, dim: int, seed: int = 0):
    from .captioner import init_params
    enc = init_params(cfg, seed=seed)
    enc.pop("head_w", None)       # decoder head unused by the encoder
    enc.pop("vis_proj_w", None)
    enc.pop("vis_proj_b", None)
    rng = np.random.default_rng(seed + 1)
    out_w = jnp.asarray(rng.normal(
        0, 1 / np.sqrt(cfg.width), size=(cfg.width, dim)).astype(np.float32))
    return {"enc": enc, "out_w": out_w}


class HybridEmbedder:
    """Lexical ⊕ semantic: concatenates a weighted HashedNGramEmbedder
    vector with a trained TransformerTextEmbedder vector, so cosine
    similarity decomposes as (1-w)·cos_hash + w·cos_ctx.

    Measured on the reference 30-question workload (earlier evaluation
    notes, in git history): ties the pure hash embedder's full-recall at w=0.15 — the benchmark's
    all-token-recall criterion is intrinsically lexical, so the semantic
    channel is kept as a low-weight tiebreaker rather than a replacement.
    """

    def __init__(self, dim: int = 512, ctx_weight: float = 0.15,
                 checkpoint_path: str = "", **tr_kw) -> None:
        self._hash = HashedNGramEmbedder(dim=dim)
        self._ctx = TransformerTextEmbedder(
            dim=dim, checkpoint_path=checkpoint_path, **tr_kw)
        self.dim = 2 * dim   # concatenated channels
        self._wh = float(np.sqrt(1.0 - ctx_weight))
        self._wc = float(np.sqrt(ctx_weight))

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        h = self._hash.embed(texts) * self._wh
        c = self._ctx.embed(texts) * self._wc
        return np.concatenate([h, c], axis=1)

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed([text])[0]


def make_embedder(kind: str = "hash", dim: int = 512, **kw):
    if kind in ("hash", "tpu"):
        return HashedNGramEmbedder(dim=dim, **kw)
    if kind == "transformer":
        return TransformerTextEmbedder(dim=dim, **kw)
    if kind == "hybrid":
        return HybridEmbedder(dim=dim, **kw)
    raise ValueError(f"unknown embedder kind: {kind}")
