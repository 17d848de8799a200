"""Fused frame preprocessing: uint8 -> resized, normalised, patchified.

The reference decodes frames with OpenCV, downscales to <=720p and JPEG/base64
encodes them for an HTTP VLM (reference: src/pipeline/vlm_extractor.py:98-128).
Here frames stay raw on the host and are shipped to the device once per
chunk; the uint8->float convert, resize and CLIP normalisation are plain
XLA ops that fuse (or, on the ``fast`` path, ride inside two matmuls), and
patch extraction is a reshape/transpose that XLA folds into the vision
tower's first matmul.

Everything is batched per chunk (frames_per_chunk at once) instead of the
reference's frame-serial loop.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# CLIP pixel statistics (public constants).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.lru_cache(maxsize=32)
def _interp_matrix(dst: int, src: int) -> np.ndarray:
    """1-D antialiased bilinear (triangle-kernel) interpolation matrix
    [dst, src].  Separable 2-D resize then becomes two matmuls on the
    tensor cores instead of gather-based ``jax.image.resize``, with the
    same antialias quality."""
    scale = src / dst
    support = max(1.0, scale)
    out = np.zeros((dst, src), np.float32)
    centers = (np.arange(dst) + 0.5) * scale - 0.5
    for i, center in enumerate(centers):
        lo = max(0, int(np.floor(center - support)))
        hi = min(src - 1, int(np.ceil(center + support)))
        j = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(j - center) / support)
        s = w.sum()
        if s > 0:
            out[i, lo:hi + 1] = w / s
    return out


@functools.lru_cache(maxsize=32)
def _norm_block_matrix(dst: int, src: int, c: int) -> np.ndarray:
    """Width-resize + CLIP normalisation as ONE matmul operand.

    ``[src*c, dst*c]`` block matrix: ``R[(s,ch), (w,ch)] =
    interp[w,s] / (255*std_ch)``.  Contracting the flattened ``(w,c)``
    axis of a ``[B,H,src*c]`` image against it performs the width resize
    for all channels in a single well-shaped matmul (M=B*H, K=src*c,
    N=dst*c) — the naive einsum form degenerates to batched matmuls with
    a 3-wide channel axis, which no matrix unit fills.  The per-channel
    normalisation scale rides along for free; only the additive bias
    remains outside.
    """
    base = _interp_matrix(dst, src)                      # [dst, src]
    blocks = np.kron(base.T, np.eye(c, dtype=np.float32))  # [src*c, dst*c]
    inv_std = np.tile(1.0 / (255.0 * np.asarray(CLIP_STD, np.float32)), dst)
    return blocks * inv_std[None, :]


@functools.partial(jax.jit, static_argnames=("size", "fast"))
def preprocess_frames(frames_u8: jax.Array, size: int = 224,
                      fast: bool = False) -> jax.Array:
    """[B,H,W,3] uint8 -> [B,size,size,3], CLIP-normalised.

    ``fast=True`` (the serving path) resizes via two bf16 matmuls on the
    tensor cores (separable antialiased bilinear) with the CLIP
    normalisation scale folded into the width-resize matrix, and returns
    bf16.  Default is the exact f32 path.
    """
    x = frames_u8
    b, h, w, c = x.shape
    if (h, w) != (size, size):
        if fast:
            rh = jnp.asarray(_interp_matrix(size, h), jnp.bfloat16)
            r2 = jnp.asarray(_norm_block_matrix(size, w, c), jnp.bfloat16)
            xf = x.astype(jnp.bfloat16)
            # height contraction: per-frame [size,h] @ [h, w*c]
            y = jnp.einsum("hs,bswc->bhwc", rh, xf)
            # width contraction + channel normalisation scale, one matmul
            y2 = jax.lax.dot_general(
                y.reshape(b, size, w * c), r2,
                (((2,), (0,)), ((), ())),
                preferred_element_type=jnp.float32).astype(jnp.bfloat16)
            mean = np.asarray(CLIP_MEAN, np.float32)
            std = np.asarray(CLIP_STD, np.float32)
            bias = jnp.asarray(np.tile(-mean / std, size), jnp.bfloat16)
            return (y2 + bias).reshape(b, size, size, c)
        # Resize in integer space is lossy; convert to f32 first, resize,
        # then apply the affine normalisation (still fused by XLA).
        xf = x.astype(jnp.float32)
        xf = jax.image.resize(xf, (b, size, size, c), method="bilinear")
        mean = jnp.asarray(CLIP_MEAN, jnp.float32) * 255.0
        std = jnp.asarray(CLIP_STD, jnp.float32) * 255.0
        return (xf - mean) / std
    mean = jnp.asarray(CLIP_MEAN, jnp.float32) * 255.0
    std = jnp.asarray(CLIP_STD, jnp.float32) * 255.0
    return (x.astype(jnp.float32) - mean) / std


def patchify(images: jax.Array, patch: int = 32) -> jax.Array:
    """[B,H,W,C] -> [B, (H/p)*(W/p), p*p*C] — matmul-ready patch matrix."""
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images.reshape(b, nh, patch, nw, patch, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)
