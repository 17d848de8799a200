"""Plain-JAX ViT (models/vit.py): numerics against a float64 numpy
reference, and checkpoints written by the earlier flax.linen module (same
parameter tree) load and reproduce their embeddings."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vidgraph_tpu.models.checkpoint import load_params
from vidgraph_tpu.models.vit import ViTConfig, init_vision_tower

GOLDEN = Path(__file__).parent / "golden"


def _np_dense(p, x):
    return x @ np.asarray(p["kernel"], np.float64) + np.asarray(
        p["bias"], np.float64)


def _np_ln(p, x):
    m = x.mean(-1, keepdims=True)
    v = ((x - m) ** 2).mean(-1, keepdims=True)
    return (x - m) / np.sqrt(v + 1e-6) * np.asarray(p["scale"]) + \
        np.asarray(p["bias"])


def _np_gelu(x):   # jax.nn.gelu's default tanh approximation
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                  * (x + 0.044715 * x ** 3)))


def _np_tower(params, cfg, images, return_tokens):
    p = params["params"]
    b, s = images.shape[0], cfg.patch_size
    n = cfg.image_size // s
    x = images.astype(np.float64).reshape(b, n, s, n, s, 3)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(b, n * n, s * s * 3)
    x = _np_dense(p["patch_embed"], x)
    cls = np.broadcast_to(np.asarray(p["cls"], np.float64),
                          (b, 1, cfg.width))
    x = np.concatenate([cls, x], 1) + np.asarray(p["pos"], np.float64)
    hd = cfg.width // cfg.heads
    for i in range(cfg.layers):
        blk = p[f"block_{i}"]
        y = _np_ln(blk["ln1"], x)
        q, k, v = np.split(_np_dense(blk["attn"]["qkv"], y), 3, -1)
        t = x.shape[1]
        q, k, v = (a.reshape(b, t, cfg.heads, hd) for a in (q, k, v))
        att = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        att = np.exp(att - att.max(-1, keepdims=True))
        att /= att.sum(-1, keepdims=True)
        o = np.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, t, cfg.width)
        x = x + _np_dense(blk["attn"]["proj"], o)
        y = _np_ln(blk["ln2"], x)
        x = x + _np_dense(blk["fc2"], _np_gelu(_np_dense(blk["fc1"], y)))
    x = _np_ln(p["ln_post"], x)
    if return_tokens:
        return _np_dense(p["proj"], x)
    out = _np_dense(p["proj"], x[:, 0])
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


@pytest.mark.parametrize("return_tokens", [False, True])
def test_tower_matches_float64_reference(return_tokens):
    cfg = ViTConfig.tiny()
    model, params = init_vision_tower(cfg, seed=1)
    imgs = np.random.default_rng(0).normal(size=(3, 64, 64, 3)) \
        .astype(np.float32)
    got = np.asarray(model.apply(params, jnp.asarray(imgs),
                                 return_tokens=return_tokens))
    ref = _np_tower(jax.tree_util.tree_map(np.asarray, params), cfg, imgs,
                    return_tokens)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("output", ["embeddings", "tokens"])
def test_flax_layout_checkpoint_reproduces_golden(output):
    cfg = ViTConfig.tiny()
    model, template = init_vision_tower(cfg, seed=0)
    params = load_params(template, str(GOLDEN / "vit_tiny_flax.npz"))
    io = np.load(GOLDEN / "vit_tiny_flax_io.npz")
    got = np.asarray(model.apply(params, jnp.asarray(io["images"]),
                                 return_tokens=output == "tokens"))
    np.testing.assert_allclose(got, io[output], rtol=1e-4, atol=1e-5)


def test_param_tree_matches_flax_layout():
    _, params = init_vision_tower(ViTConfig.tiny(), seed=0)
    keys = {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    with np.load(GOLDEN / "vit_tiny_flax.npz") as data:
        assert keys == set(data.files)


def test_bf16_tower_tracks_f32():
    cfg = ViTConfig(image_size=64, patch_size=32, width=64, layers=2,
                    heads=2, embed_dim=32)
    model, params = init_vision_tower(cfg, seed=2)
    imgs = jnp.asarray(np.random.default_rng(1).normal(
        size=(4, 64, 64, 3)).astype(np.float32))
    got = np.asarray(model.apply(params, imgs))
    ref_model, _ = init_vision_tower(
        ViTConfig(**{**cfg.__dict__, "dtype": jnp.float32}), seed=2)
    ref = np.asarray(ref_model.apply(params, imgs))
    assert got.dtype == np.float32
    assert (np.sum(got * ref, 1) > 0.99).all()
