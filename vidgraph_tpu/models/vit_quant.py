"""int8-quantized ViT inference path (not wired into any backend).

int8 tensor cores run at twice the bf16 rate.  This module
consumes the SAME parameter pytree as ``models/vit.py`` — weights
quantized once (symmetric per-output-channel int8), activations
dynamically per row, int32 accumulation, f32 rescale; attention
score/softmax/context matmuls stay bf16.  Numerics are fine (cosine
>= 0.9996 vs the f32 tower, tests/test_models.py).

Whether it pays end to end against the bf16 tower on the GPU is not
measured: the dynamic abs-max/round/clip activation quantization and the
extra f32 rescales are elementwise work that the int8 matmuls must win
back.
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from .vit import ViTConfig, patchify


def _quant_weight(w: jnp.ndarray):
    """[in, out] f32 -> (int8 [in, out], scale [out] f32)."""
    scale = jnp.max(jnp.abs(w), axis=0) / 127.0
    scale = jnp.maximum(scale, 1e-8)
    q = jnp.clip(jnp.round(w / scale[None, :]), -127, 127).astype(jnp.int8)
    return q, scale


def quantize_vit_params(params: Dict[str, Any], cfg: ViTConfig) -> Dict:
    """Quantize every Dense kernel of the flax ViT params once."""
    p = params["params"]
    out: Dict[str, Any] = {"_f32": {}, "_q": {}}

    def add_dense(name, node):
        q, s = _quant_weight(jnp.asarray(node["kernel"], jnp.float32))
        out["_q"][name] = (q, s, jnp.asarray(node["bias"], jnp.float32))

    add_dense("patch_embed", p["patch_embed"])
    add_dense("proj", p["proj"])
    for i in range(cfg.layers):
        blk = p[f"block_{i}"]
        add_dense(f"b{i}/qkv", blk["attn"]["qkv"])
        add_dense(f"b{i}/proj", blk["attn"]["proj"])
        add_dense(f"b{i}/fc1", blk["fc1"])
        add_dense(f"b{i}/fc2", blk["fc2"])
        for ln in ("ln1", "ln2"):
            out["_f32"][f"b{i}/{ln}"] = (
                jnp.asarray(blk[ln]["scale"], jnp.float32),
                jnp.asarray(blk[ln]["bias"], jnp.float32))
    out["_f32"]["ln_post"] = (jnp.asarray(p["ln_post"]["scale"], jnp.float32),
                              jnp.asarray(p["ln_post"]["bias"], jnp.float32))
    out["_f32"]["cls"] = jnp.asarray(p["cls"], jnp.float32)
    out["_f32"]["pos"] = jnp.asarray(p["pos"], jnp.float32)
    return out


def _qdense(qp, name: str, x: jnp.ndarray) -> jnp.ndarray:
    """Dynamic per-row int8 activation quant -> int8 matmul -> rescale."""
    wq, ws, b = qp["_q"][name]
    xs = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0
    xs = jnp.maximum(xs, 1e-8)
    xq = jnp.clip(jnp.round(x / xs), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    return acc.astype(jnp.float32) * xs * ws + b


def _ln(x, scale, bias, eps=1e-6):
    m = x.mean(-1, keepdims=True)
    v = jnp.square(x - m).mean(-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + eps) * scale + bias


def vit_forward_int8(qp: Dict, cfg: ViTConfig, images: jnp.ndarray,
                     ) -> jnp.ndarray:
    """images [B,H,W,3] (pre-processed floats) -> [B, embed_dim]."""
    b = images.shape[0]
    x = patchify(images.astype(jnp.float32), cfg.patch_size)
    x = _qdense(qp, "patch_embed", x)
    cls = jnp.tile(qp["_f32"]["cls"], (b, 1, 1))
    x = jnp.concatenate([cls, x], axis=1) + qp["_f32"]["pos"]
    h, hd = cfg.heads, cfg.width // cfg.heads
    n = x.shape[1]
    for i in range(cfg.layers):
        s1, b1 = qp["_f32"][f"b{i}/ln1"]
        y = _ln(x, s1, b1)
        qkv = _qdense(qp, f"b{i}/qkv", y)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        q = q.reshape(b, n, h, hd).astype(jnp.bfloat16)
        k = k.reshape(b, n, h, hd).astype(jnp.bfloat16)
        v = v.reshape(b, n, h, hd).astype(jnp.bfloat16)
        att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                         preferred_element_type=jnp.float32)
        att = jax.nn.softmax(att / np.sqrt(hd), axis=-1).astype(jnp.bfloat16)
        o = jnp.einsum("bhqk,bkhd->bqhd", att, v,
                       preferred_element_type=jnp.float32)
        x = x + _qdense(qp, f"b{i}/proj", o.reshape(b, n, cfg.width))
        s2, b2 = qp["_f32"][f"b{i}/ln2"]
        y = _ln(x, s2, b2)
        x = x + _qdense(qp, f"b{i}/fc2", jax.nn.gelu(
            _qdense(qp, f"b{i}/fc1", y)))
    s, bi = qp["_f32"]["ln_post"]
    cls_out = _ln(x[:, 0], s, bi)
    out = _qdense(qp, "proj", cls_out)
    return out / jnp.maximum(
        jnp.linalg.norm(out, axis=-1, keepdims=True), 1e-8)
