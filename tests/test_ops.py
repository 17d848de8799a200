import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vidgraph_tpu.ops import (cosine_scores, cosine_topk, l2_normalize,
                              patchify, preprocess_frames)


def _ref_cosine(q, s):
    qn = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    return qn @ s.T


def test_cosine_scores_matches_numpy():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    s = rng.normal(size=(50, 64)).astype(np.float32)
    s = s / np.linalg.norm(s, axis=-1, keepdims=True)
    got = np.asarray(cosine_scores(jnp.asarray(q), jnp.asarray(s)))
    np.testing.assert_allclose(got, _ref_cosine(q, s), rtol=1e-5, atol=1e-5)


def test_cosine_topk_masks_invalid():
    q = jnp.ones((1, 8), jnp.float32)
    s = l2_normalize(jnp.eye(8, dtype=jnp.float32)[:4])
    store = jnp.zeros((8, 8), jnp.float32).at[:4].set(s)
    valid = jnp.arange(8) < 4
    vals, idx = cosine_topk(q, store, k=6, valid=valid)
    vals, idx = np.asarray(vals), np.asarray(idx)
    assert (idx[0, :4] < 4).all()
    assert (vals[0, 4:] <= -1e29).all()


def test_cosine_topk_empty_store():
    q = jnp.ones((2, 8), jnp.float32)
    s = jnp.zeros((0, 8), jnp.float32)
    vals, idx = cosine_topk(q, s, k=3)
    assert vals.shape == (2, 3) and idx.shape == (2, 3)
    assert (np.asarray(vals) <= -1e29).all()


def test_preprocess_frames_shapes_and_range():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, size=(4, 360, 640, 3), dtype=np.uint8)
    out = preprocess_frames(jnp.asarray(frames), size=224)
    assert out.shape == (4, 224, 224, 3)
    arr = np.asarray(out)
    assert np.isfinite(arr).all()
    # CLIP-normalised pixel range
    assert arr.min() > -3.0 and arr.max() < 3.0


def test_preprocess_identity_size_matches_affine():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    from vidgraph_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD
    ref = (frames.astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN)) \
        / np.asarray(CLIP_STD)
    got = np.asarray(preprocess_frames(jnp.asarray(frames), size=224))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_patchify():
    x = jnp.arange(2 * 64 * 64 * 3, dtype=jnp.float32).reshape(2, 64, 64, 3)
    p = patchify(x, patch=32)
    assert p.shape == (2, 4, 32 * 32 * 3)
    # First patch equals the top-left 32x32 block, row-major.
    ref = np.asarray(x[0, :32, :32, :]).reshape(-1)
    np.testing.assert_array_equal(np.asarray(p[0, 0]), ref)


def test_mesh_build(cpu_mesh):
    assert cpu_mesh.devices.size == 8
    assert cpu_mesh.axis_names == ("data", "model")


def test_preprocess_fast_matches_exact_within_tolerance():
    # the fast path (bf16 separable-matmul resize) must track the exact
    # f32 gather resize closely enough that ViT embeddings are unaffected
    # in practice
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(2, 96, 128, 3), dtype=np.uint8)
    exact = np.asarray(preprocess_frames(jnp.asarray(frames), size=64))
    fast = np.asarray(preprocess_frames(jnp.asarray(frames), size=64,
                                        fast=True)).astype(np.float32)
    # normalised pixels span ~[-2, 2.6]; bf16 + kernel-shape differences
    # stay within a few percent of that range
    assert np.abs(exact - fast).mean() < 0.1
    assert np.abs(exact - fast).max() < 0.6


@pytest.mark.parametrize("n", [1000, 65535, 65536, 70000])
@pytest.mark.parametrize("b", [1, 5])
def test_cosine_topk_matches_numpy_across_two_stage(n, b):
    """One-stage and two-stage top-k agree with numpy around
    ``_TWO_STAGE_MIN``, with a first-N-rows-valid count."""
    from vidgraph_tpu.ops import topk_cosine

    assert topk_cosine._TWO_STAGE_MIN == 65536
    rng = np.random.default_rng(n + b)
    s = rng.normal(size=(n, 16)).astype(np.float32)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    q = rng.normal(size=(b, 16)).astype(np.float32)
    count = n - 37
    vals, idx = cosine_topk(jnp.asarray(q), jnp.asarray(s), k=7,
                            valid_count=count)
    ref = _ref_cosine(q.astype(np.float64), s[:count].astype(np.float64))
    want = np.argsort(-ref, axis=1)[:, :7]
    np.testing.assert_allclose(np.asarray(vals),
                               np.take_along_axis(ref, want, 1), atol=1e-5)
    assert (np.asarray(idx) < count).all()
    np.testing.assert_array_equal(np.asarray(idx), want)
