"""Weight-only int8 serving quantization for the decoder stack.

Greedy decode of ``CaptionerConfig.large()`` at small batch reads every
weight once per step, so it is bound by device-memory bandwidth: storing
the block matrices as int8 with per-output-channel f32 scales halves the
bytes per step relative to bf16.  (Contrast with ``models/vit_quant.py``:
the ViT tower runs at B=160, where the matmuls are larger.)

Two dot modes, both numerically verified against the f32/bf16 path
(tests/test_quant8.py; timed by scripts/profile_int8_decode.py):

* ``a16`` — keep activations bf16, convert the int8 weight inside the
  matmul: ``(x @ q.astype(bf16)) * s``; the GEMM reads int8.
  Per-OUTPUT-channel scales commute through the contraction, so the rescale is a cheap [N]-vector
  epilogue instead of a dequantized [K,N] matrix in device memory.
* ``a8`` — dynamically quantize the (tiny, [B,K]) activation per row and
  run a native int8 x int8 dot with int32 accumulation (int8 tensor
  cores): ``(x_i8 @ q) * (sx[:,None] * sw[None,:])``.

A quantized weight is a :class:`Q8` pytree node (children ``q`` int8
[..., out] and ``s`` f32 [out]; no static aux), so a quantized parameter
tree keeps the SHAPE of ``models/captioner.py::init_params`` and flows
through jit/scan unchanged — the forward/decode code routes every weight
matmul through :func:`wdot`, which works identically for f32, bf16, and
Q8 leaves.

No reference counterpart (the reference served its models over HTTP,
reference: src/pipeline/vlm_extractor.py:130-192).
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class Q8:
    """int8 weight + per-output-channel f32 scale, as a pytree node."""

    def __init__(self, q: jnp.ndarray, s: jnp.ndarray):
        self.q = q
        self.s = s

    def tree_flatten(self):
        return (self.q, self.s), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.q.shape

    def __repr__(self):  # keeps param-tree dumps readable
        return f"Q8(q={self.q.shape}, s={self.s.shape})"


def is_q8(w: Any) -> bool:
    return isinstance(w, Q8)


def quantize_matrix(w: jnp.ndarray) -> Q8:
    """[..., out] float -> int8 symmetric per-output-channel."""
    w = jnp.asarray(w, jnp.float32)
    s = jnp.max(jnp.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
    s = jnp.maximum(s, 1e-8)
    q = jnp.clip(jnp.round(w / s), -127, 127).astype(jnp.int8)
    return Q8(q, s)


# the decoder-block matrices carry ~99.6% of CaptionerConfig.large()'s
# bytes; embeddings/layernorms stay in their stored dtype
BLOCK_KEYS = ("qkv_w", "attn_o_w", "fc1_w", "fc2_w")


def quantize_captioner_params(params: Dict, head: bool = True) -> Dict:
    """Quantize a captioner param tree (models/captioner.py layout) for
    serving.  Block matmul weights always; ``head_w`` optionally (it is
    [d, vocab~260] — small, but read every step)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    if head:
        out["head_w"] = quantize_matrix(params["head_w"])
    out["blocks"] = [
        {k: (quantize_matrix(v) if k in BLOCK_KEYS else v)
         for k, v in bp.items()}
        for bp in params["blocks"]
    ]
    return out


def wdot(x: jnp.ndarray, w: Any, dtype: Any, mode: str = "a16") -> jnp.ndarray:
    """``x @ w`` where ``w`` is a float matrix OR a :class:`Q8`.  Output
    dtype follows the float path (``dtype``).
    ``mode`` must be trace-static — the captioner carries it in its
    (static) config so switching modes retraces."""
    if not is_q8(w):
        return x @ w.astype(dtype)
    if mode == "a8":
        # dynamic per-row activation quant; int8 x int8 -> int32 dot
        xf = x.astype(jnp.float32)
        sx = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
        sx = jnp.maximum(sx, 1e-8)
        xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
        acc = jax.lax.dot_general(
            xq, w.q, (((xq.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        return (acc.astype(jnp.float32) * sx * w.s).astype(dtype)
    # a16: XLA:GPU fuses the int8 -> bf16 convert into the GEMM's operand
    # read (the compiled GEMM fusion takes the s8 weight itself; checked
    # on an H100); the per-output-channel rescale commutes out as a
    # vector epilogue
    y = x @ w.q.astype(dtype)
    return (y.astype(jnp.float32) * w.s).astype(dtype)


def tree_bytes(params: Dict) -> int:
    """Actual device bytes of the (possibly mixed) serving tree."""
    return sum(leaf.size * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(params)
               if hasattr(leaf, "dtype"))
