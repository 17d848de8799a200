"""Weight-only int8 serving quantization (models/quant8.py).

The quantized tree must (1) keep the captioner's parameter layout,
(2) produce near-identical logits in both dot modes, (3) decode
token-identically on a trained model, and (4) actually halve the
serving bytes — on CPU; speed is measured on the GPU
(scripts/profile_int8_decode.py, PERF.md)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from vidgraph_tpu.models.captioner import (CaptionerConfig, forward,
                                           generate, generate_from_tokens,
                                           init_params)
from vidgraph_tpu.models.quant8 import (Q8, is_q8,
                                        quantize_captioner_params,
                                        quantize_matrix, tree_bytes, wdot)


@pytest.fixture(scope="module")
def setup():
    cfg = CaptionerConfig.tiny()
    params = init_params(cfg, seed=3)
    qparams = quantize_captioner_params(params)
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(3, 250, (2, 16)), jnp.int32)
    vis = jnp.zeros((2, cfg.num_vision_tokens, cfg.vision_dim), jnp.float32)
    return cfg, params, qparams, toks, vis


def test_wdot_matches_float_matmul():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(64, 32)) * 0.05, jnp.float32)
    ref = x @ w
    for mode in ("a16", "a8"):
        got = wdot(x, quantize_matrix(w), jnp.float32, mode)
        err = float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))
        assert err < 0.03, (mode, err)
    # float weights pass straight through
    assert np.allclose(wdot(x, w, jnp.float32), ref, atol=1e-5)


def test_quantized_tree_keeps_layout(setup):
    cfg, params, qparams, _, _ = setup
    assert set(qparams) == set(params)
    for bp, qbp in zip(params["blocks"], qparams["blocks"]):
        assert set(qbp) == set(bp)
        for k in ("qkv_w", "attn_o_w", "fc1_w", "fc2_w"):
            assert is_q8(qbp[k]) and qbp[k].q.dtype == jnp.int8
            assert qbp[k].shape == bp[k].shape
        assert not is_q8(qbp["ln1_scale"])
    assert is_q8(qparams["head_w"])
    # >=1.9x smaller than the f32 tree (embeddings stay float)
    assert tree_bytes(params) / tree_bytes(qparams) > 1.9


def test_forward_logits_close(setup):
    cfg, params, qparams, toks, vis = setup
    ref = np.asarray(forward(params, cfg, vis, toks)).ravel()
    for mode in ("a16", "a8"):
        got = np.asarray(forward(qparams, dataclasses.replace(
            cfg, qmode=mode), vis, toks)).ravel()
        cos = float(ref @ got / (np.linalg.norm(ref) * np.linalg.norm(got)))
        assert cos > 0.999, (mode, cos)


def test_greedy_decode_token_identical(setup):
    """Random-init tiny model: greedy tokens must match the float path in
    both modes (vision-conditioned and ragged text-conditioned)."""
    cfg, params, qparams, toks, vis = setup
    plen = jnp.asarray([10, 16], jnp.int32)
    ref_v = np.asarray(generate(params, cfg, vis, max_new=8))
    ref_t = np.asarray(generate_from_tokens(params, cfg, toks, plen,
                                            max_new=8))
    for mode in ("a16", "a8"):
        c = dataclasses.replace(cfg, qmode=mode)
        assert np.array_equal(
            np.asarray(generate(qparams, c, vis, max_new=8)), ref_v), mode
        assert np.array_equal(
            np.asarray(generate_from_tokens(qparams, c, toks, plen,
                                            max_new=8)), ref_t), mode


def test_q8_is_a_pytree_node():
    import jax
    q = quantize_matrix(jnp.ones((8, 4)))
    leaves = jax.tree_util.tree_leaves({"w": q})
    assert len(leaves) == 2
    doubled = jax.tree_util.tree_map(lambda a: a, {"w": q})
    assert isinstance(doubled["w"], Q8)
