"""Vision tower: CLIP-style ViT in plain JAX.

Replaces the reference's HTTP round-trip to an external VLM server for frame
understanding (reference: src/pipeline/vlm_extractor.py:130-192).  Frames are
preprocessed by ops.preprocess, patchified into a matmul-ready matrix, and
run batched per chunk; matmuls run in the compute dtype (bf16 by default).

The parameter tree keeps the layout of the earlier flax.linen module
(``{"params": {"patch_embed": {"kernel", "bias"}, "cls", "pos",
"block_{i}": {"ln1", "attn": {"qkv", "proj"}, "ln2", "fc1", "fc2"},
"ln_post", "proj"}}``) and its numerics (Dense: operands and bias cast to
the compute dtype; LayerNorm: float32 statistics, epsilon 1e-6), so saved
``.npz`` checkpoints, ``models/vit_quant.py`` and the trainer keep working.

Tensor-parallel sharding: attention heads and MLP hidden are split along the
mesh "model" axis (see param_shardings()), batch along "data".
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops.preprocess import patchify

_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512          # output projection dim
    mlp_ratio: int = 4
    dtype: Any = jnp.bfloat16     # compute dtype

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def b32(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        """Small config for CPU tests."""
        return cls(image_size=64, patch_size=32, width=64, layers=2,
                   heads=2, embed_dim=32, dtype=jnp.float32)


def _dense(p, x, dtype):
    return (jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
            + p["bias"].astype(dtype))


def _layer_norm(p, x, dtype):
    xf = x.astype(jnp.float32)
    m = jnp.mean(xf, axis=-1, keepdims=True)
    v = jnp.mean(jnp.square(xf - m), axis=-1, keepdims=True)
    y = (xf - m) * jax.lax.rsqrt(v + _LN_EPS) * p["scale"] + p["bias"]
    return y.astype(dtype)


def _attention(p, cfg: ViTConfig, x):
    d = cfg.width
    hd = d // cfg.heads
    b, n, _ = x.shape
    qkv = _dense(p["qkv"], x, cfg.dtype)
    q, k, v = (a.reshape(b, n, cfg.heads, hd)
               for a in jnp.split(qkv, 3, axis=-1))
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                     preferred_element_type=jnp.float32)
    att = att / jnp.sqrt(hd).astype(att.dtype)
    att = jax.nn.softmax(att, axis=-1).astype(cfg.dtype)
    out = jnp.einsum("bhqk,bkhd->bqhd", att, v,
                     preferred_element_type=jnp.float32)
    return _dense(p["proj"], out.reshape(b, n, d).astype(cfg.dtype),
                  cfg.dtype)


def _block(p, cfg: ViTConfig, x):
    x = x + _attention(p["attn"], cfg, _layer_norm(p["ln1"], x, cfg.dtype))
    h = jax.nn.gelu(_dense(p["fc1"], _layer_norm(p["ln2"], x, cfg.dtype),
                           cfg.dtype))
    return x + _dense(p["fc2"], h, cfg.dtype)


class VisionTower:
    """images [B,H,W,3] f32 (already normalised) -> embeddings [B, embed_dim]
    (L2-normalised f32), or per-token projections [B, N+1, embed_dim] with
    ``return_tokens=True``."""

    def __init__(self, cfg: ViTConfig):
        self.cfg = cfg

    def apply(self, params: Dict, images: jax.Array,
              return_tokens: bool = False) -> jax.Array:
        c = self.cfg
        p = params["params"]
        patches = patchify(images, c.patch_size).astype(c.dtype)
        x = _dense(p["patch_embed"], patches, c.dtype)
        b = x.shape[0]
        cls = jnp.tile(p["cls"].astype(c.dtype), (b, 1, 1))
        x = jnp.concatenate([cls, x], axis=1) + p["pos"].astype(c.dtype)
        for i in range(c.layers):
            x = _block(p[f"block_{i}"], c, x)
        x = _layer_norm(p["ln_post"], x, c.dtype)
        if return_tokens:
            return _dense(p["proj"], x, c.dtype)
        out = _dense(p["proj"], x[:, 0], c.dtype).astype(jnp.float32)
        return out * jax.lax.rsqrt(
            jnp.sum(out * out, axis=-1, keepdims=True) + 1e-12)


def init_params(cfg: ViTConfig, seed: int = 0) -> Dict:
    """Random f32 parameters: LeCun-normal kernels, zero biases, unit
    LayerNorm scales, N(0, 0.02) class token and positions."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4 + 4 * cfg.layers))
    lecun = jax.nn.initializers.lecun_normal()
    d, hidden = cfg.width, cfg.width * cfg.mlp_ratio

    def dense(n_in, n_out):
        return {"kernel": lecun(next(keys), (n_in, n_out), jnp.float32),
                "bias": jnp.zeros((n_out,), jnp.float32)}

    def ln():
        return {"scale": jnp.ones((d,), jnp.float32),
                "bias": jnp.zeros((d,), jnp.float32)}

    p: Dict[str, Any] = {
        "patch_embed": dense(cfg.patch_size ** 2 * 3, d),
        "cls": 0.02 * jax.random.normal(next(keys), (1, 1, d)),
        "pos": 0.02 * jax.random.normal(next(keys),
                                        (1, cfg.num_patches + 1, d)),
    }
    for i in range(cfg.layers):
        p[f"block_{i}"] = {
            "ln1": ln(),
            "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "ln2": ln(),
            "fc1": dense(d, hidden),
            "fc2": dense(hidden, d),
        }
    p["ln_post"] = ln()
    p["proj"] = dense(d, cfg.embed_dim)
    return {"params": p}


def init_vision_tower(cfg: ViTConfig, seed: int = 0):
    return VisionTower(cfg), init_params(cfg, seed)


def param_shardings(params: Dict, mesh) -> Dict:
    """Tensor-parallel specs: split attention qkv/MLP hidden on 'model'."""
    from jax.sharding import NamedSharding

    def spec_for(path: str, leaf) -> P:
        if leaf.ndim != 2:
            return P()
        if any(k in path for k in ("qkv", "fc1")):
            return P(None, "model")      # column parallel
        if any(k in path for k in ("proj", "fc2")):
            return P("model", None)      # row parallel
        return P()

    def assign(path, leaf):
        name = "/".join(str(p.key) for p in path if hasattr(p, "key"))
        return NamedSharding(mesh, spec_for(name, leaf))

    return jax.tree_util.tree_map_with_path(assign, params)
