"""Fused prefix-causal attention (models/captioner.py::
prefix_causal_attention).

On the GPU the wrapper calls cuDNN's flash attention, which has no CPU
path; the same wrapper runs XLA's formulation here, so the
CPU suite checks everything around the kernel: that the plain-causal +
dense-corner decomposition equals the masked-einsum semantics, across
sequence lengths, vision-prefix sizes and right padding; that its
gradient matches; and that ``flash=True`` through ``forward`` and the
serving prefill agrees with the einsum path.  The cuDNN kernel itself is
checked on the card by ``chip_smoke.py`` (parity phase (e)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vidgraph_tpu.models.captioner import (CaptionerConfig,
                                           _masked_attention,
                                           _prefix_causal_mask,
                                           attention_implementation,
                                           forward, generate_from_tokens,
                                           init_params,
                                           prefix_causal_attention)


def _qkv(seed, b, t, h, hd):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=(b, t, h, hd)).astype(np.float32))
            for _ in range(3)]


def test_prefix_fixup_decomposition_matches_masked_softmax():
    """Causal softmax for rows >= nv, dense nv x nv for rows < nv, written
    out with plain jnp — the identity the wrapper relies on."""
    b, t, h, hd, nv = 2, 24, 2, 8, 4
    q, k, v = _qkv(1, b, t, h, hd)

    def masked(mask):
        att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(hd)
        att = jax.nn.softmax(att + mask[None, None], axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", att, v)

    ref = masked(_prefix_causal_mask(t, nv))
    o = masked(_prefix_causal_mask(t, 0))
    att = jnp.einsum("bqhd,bkhd->bhqk", q[:, :nv], k[:, :nv]) / jnp.sqrt(hd)
    op = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(att, axis=-1),
                    v[:, :nv])
    got = jnp.concatenate([op, o[:, nv:]], axis=1)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nv", [0, 8])
@pytest.mark.parametrize("t_extra", [1, 122, 249])
def test_wrapper_matches_masked_einsum(nv, t_extra):
    """T in {nv+1, 130, 257} for nv=8 (and the same extras for nv=0)."""
    t = nv + t_extra
    q, k, v = _qkv(t, 2, t, 2, 16)
    got = prefix_causal_attention(q, k, v, nv)
    ref = _masked_attention(q, k, v, _prefix_causal_mask(t, nv),
                            jnp.float32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_wrapper_right_padding_leaves_real_rows_unchanged():
    """Rows padded on the right (ragged prompts in one batch) must not
    change any real row's output: causality hides the pad columns."""
    nv, t_real, t_pad = 8, 40, 64
    q, k, v = _qkv(5, 2, t_pad, 2, 16)
    full = prefix_causal_attention(q, k, v, nv)
    short = prefix_causal_attention(q[:, :t_real], k[:, :t_real],
                                    v[:, :t_real], nv)
    np.testing.assert_allclose(np.asarray(full[:, :t_real]),
                               np.asarray(short), rtol=1e-6, atol=1e-6)


def test_wrapper_gradient_matches_masked_einsum():
    nv, t = 8, 40
    q, k, v = _qkv(9, 2, t, 2, 16)
    w = jnp.asarray(np.random.default_rng(3).normal(size=(2, t, 2, 16))
                    .astype(np.float32))
    mask = _prefix_causal_mask(t, nv)

    def loss_wrapped(q, k, v):
        return jnp.sum(w * prefix_causal_attention(q, k, v, nv))

    def loss_ref(q, k, v):
        return jnp.sum(w * _masked_attention(q, k, v, mask, jnp.float32))

    g_got = jax.grad(loss_wrapped, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_implementation_is_xla_off_the_gpu():
    assert attention_implementation() == "xla"


def test_forward_flash_matches_einsum_and_gradient():
    cfg = CaptionerConfig.tiny()
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    vis = jnp.asarray(rng.normal(size=(2, cfg.num_vision_tokens,
                                       cfg.vision_dim)).astype(np.float32))
    toks = jnp.asarray(rng.integers(3, 250, (2, 17)), jnp.int32)
    ref = np.asarray(forward(params, cfg, vis, toks))
    got = np.asarray(forward(params, cfg, vis, toks, flash=True))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def loss(p, flash):
        lg = forward(p, cfg, vis, toks, flash=flash)
        return jnp.mean(jax.nn.log_softmax(lg)[..., 7])

    g_ref = jax.grad(lambda p: loss(p, False))(params)
    g_got = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-3, atol=1e-5)


def test_serving_prefill_flash_is_token_identical():
    cfg = CaptionerConfig.tiny()
    params = init_params(cfg, seed=2)
    rng = np.random.default_rng(1)
    toks = jnp.asarray(rng.integers(3, 250, (2, 24)), jnp.int32)
    plen = jnp.asarray([9, 24], jnp.int32)
    ref = generate_from_tokens(params, cfg, toks, plen, max_new=8)
    got = generate_from_tokens(params, cfg, toks, plen, max_new=8,
                               flash=True)
    assert np.array_equal(np.asarray(ref), np.asarray(got))
