"""Training: caption-LM fine-tuning of the flagship stack (ViT vision
tower -> byte-level captioner) over a device mesh.

The reference had no trainable models (all inference over HTTP); this
module makes the in-process models trainable on the device:
data-parallel batches over the mesh "data" axis, tensor-parallel weights over "model"
(column-split qkv/fc1, row-split proj/fc2), optional gradient
rematerialisation, adamw.

Used by ``__graft_entry__.dryrun_multichip`` and directly:

    state = TrainState.create(vit_cfg, cap_cfg, mesh)
    state, loss = state.step(images, tokens)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .captioner import CaptionerConfig, forward, init_params
from .tokenizer import PAD_ID
from .vit import ViTConfig, init_vision_tower, param_shardings


def captioner_shardings(params: Dict, mesh: Mesh) -> Dict:
    """Tensor-parallel specs for the captioner param tree (embeddings and
    LM head replicated: vocab 259 is indivisible by usual axis sizes)."""

    def blk(bp):
        return {
            **{k: NamedSharding(mesh, P()) for k in bp},
            "qkv_w": NamedSharding(mesh, P(None, "model")),
            "qkv_b": NamedSharding(mesh, P("model")),
            "fc1_w": NamedSharding(mesh, P(None, "model")),
            "fc1_b": NamedSharding(mesh, P("model")),
            "attn_o_w": NamedSharding(mesh, P("model", None)),
            "fc2_w": NamedSharding(mesh, P("model", None)),
        }

    out = {k: NamedSharding(mesh, P()) for k in params if k != "blocks"}
    out["blocks"] = [blk(bp) for bp in params["blocks"]]
    return out


def caption_loss(vit, vit_params, cap_params, cap_cfg: CaptionerConfig,
                 images: jax.Array, tokens: jax.Array) -> jax.Array:
    """Masked next-byte cross entropy of captions given frames."""
    emb = vit.apply(vit_params, images)
    vis = jnp.tile(emb[:, None, :], (1, cap_cfg.num_vision_tokens, 1))
    logits = forward(cap_params, cap_cfg, vis, tokens[:, :-1])
    targets = tokens[:, 1:]
    mask = (targets != PAD_ID).astype(jnp.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
    return (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)


@dataclasses.dataclass
class TrainState:
    mesh: Mesh
    vit: Any
    vit_cfg: ViTConfig
    cap_cfg: CaptionerConfig
    params: Dict
    opt_state: Any
    tx: Any
    _step_fn: Any

    @classmethod
    def create(cls, vit_cfg: ViTConfig, cap_cfg: CaptionerConfig,
               mesh: Mesh, learning_rate: float = 1e-4,
               weight_decay: float = 0.01, seed: int = 0) -> "TrainState":
        vit, vit_params = init_vision_tower(vit_cfg, seed)
        cap_params = init_params(cap_cfg, seed)
        vit_params = jax.device_put(vit_params,
                                    param_shardings(vit_params, mesh))
        cap_params = jax.device_put(cap_params,
                                    captioner_shardings(cap_params, mesh))
        params = {"vit": vit_params, "cap": cap_params}
        tx = optax.adamw(learning_rate, weight_decay=weight_decay)
        opt_state = jax.jit(tx.init)(params)

        def loss_fn(p, images, tokens):
            return caption_loss(vit, p["vit"], p["cap"], cap_cfg,
                                images, tokens)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def step_fn(p, o, images, tokens):
            loss, grads = jax.value_and_grad(loss_fn)(p, images, tokens)
            updates, o = tx.update(grads, o, p)
            p = optax.apply_updates(p, updates)
            return p, o, loss

        return cls(mesh=mesh, vit=vit, vit_cfg=vit_cfg, cap_cfg=cap_cfg,
                   params=params, opt_state=opt_state, tx=tx,
                   _step_fn=step_fn)

    def shard_batch(self, images: np.ndarray, tokens: np.ndarray,
                    sequence_parallel: bool = False
                    ) -> Tuple[jax.Array, jax.Array]:
        """Place a batch on the mesh: batch dim over "data"; with
        ``sequence_parallel`` the token sequence dim is additionally split
        over "model" (XLA all-gathers inside attention and keeps the
        elementwise/embedding work sequence-sharded)."""
        img_s = NamedSharding(self.mesh, P("data", None, None, None))
        seq = "model" if sequence_parallel else None
        tok_s = NamedSharding(self.mesh, P("data", seq))
        return (jax.device_put(jnp.asarray(images, jnp.float32), img_s),
                jax.device_put(jnp.asarray(tokens, jnp.int32), tok_s))

    def step(self, images, tokens) -> Tuple["TrainState", float]:
        with self.mesh:
            params, opt_state, loss = self._step_fn(
                self.params, self.opt_state, images, tokens)
        return dataclasses.replace(self, params=params,
                                   opt_state=opt_state), float(loss)
