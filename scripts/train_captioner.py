#!/usr/bin/env python3
"""Train the on-device captioner on synthetic scenes.

Bootstraps real weights for the in-process captioning path with zero external
data: synthetic colored-shape clips are captioned by the deterministic
LocalVLM (frame statistics -> text), and the ViT+captioner stack learns to
reproduce those captions from pixels.  Produces an .npz checkpoint loadable
by TPUVLMClient / models.checkpoint.

    python scripts/train_captioner.py --steps 300 --batch 16 \
        --out checkpoints/captioner_tiny.npz
"""
from __future__ import annotations

import argparse
import asyncio
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def make_dataset(n: int, image_size: int, seed: int = 0):
    """(frames [n,S,S,3] u8, captions [n] str) of single-color scenes."""
    from vidgraph_tpu.services.vlm_client import LocalVLMClient

    rng = np.random.default_rng(seed)
    colors = {"red": (220, 40, 40), "green": (40, 200, 60),
              "blue": (40, 80, 220), "yellow": (230, 220, 40),
              "magenta": (210, 40, 200), "cyan": (40, 210, 210)}
    vlm = LocalVLMClient()
    frames = np.zeros((n, image_size, image_size, 3), np.uint8)
    captions = []
    names = list(colors)
    for i in range(n):
        color = names[i % len(names)]
        s = image_size // 2
        x0 = rng.integers(0, image_size - s)
        y0 = rng.integers(0, image_size - s)
        frames[i, y0:y0 + s, x0:x0 + s] = colors[color]
        captions.append(asyncio.run(vlm.caption([frames[i]])))
    return frames, captions


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dataset", type=int, default=96)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--out", default="checkpoints/captioner_tiny.npz")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from vidgraph_tpu.models.captioner import CaptionerConfig, generate
    from vidgraph_tpu.models.checkpoint import save_params
    from vidgraph_tpu.models.tokenizer import batch_encode, decode
    from vidgraph_tpu.models.train import TrainState
    from vidgraph_tpu.models.vit import ViTConfig
    from vidgraph_tpu.ops.preprocess import preprocess_frames
    from vidgraph_tpu.parallel.mesh import build_mesh

    image_size = 64
    vit_cfg = ViTConfig(image_size=image_size, patch_size=32, width=128,
                        layers=4, heads=4, embed_dim=64, dtype=jnp.float32)
    cap_cfg = CaptionerConfig(width=128, layers=4, heads=4, vision_dim=64,
                              num_vision_tokens=4,
                              max_len=args.max_len + 8, dtype=jnp.float32)
    mesh = build_mesh(jax.devices()[:1], model_axis=1)
    state = TrainState.create(vit_cfg, cap_cfg, mesh,
                              learning_rate=args.lr)

    frames, captions = make_dataset(args.dataset, image_size)
    pixels = np.asarray(preprocess_frames(jnp.asarray(frames),
                                          size=image_size))
    tokens = batch_encode(captions, args.max_len)

    rng = np.random.default_rng(0)
    first = last = None
    for step in range(args.steps):
        idx = rng.integers(0, len(captions), size=args.batch)
        imgs, toks = state.shard_batch(pixels[idx], tokens[idx])
        state, loss = state.step(imgs, toks)
        if first is None:
            first = loss
        last = loss
        if step % 50 == 0:
            print(f"step {step:4d}  loss {loss:.4f}")
    print(f"trained {args.steps} steps: loss {first:.4f} -> {last:.4f}")

    save_params({"vit": state.params["vit"], "cap": state.params["cap"],
                 }, args.out)
    print(f"checkpoint saved to {args.out}")

    # sample generation from a training image
    emb = state.vit.apply(state.params["vit"],
                          jnp.asarray(pixels[:1]))
    vis = jnp.tile(emb[:, None, :], (1, cap_cfg.num_vision_tokens, 1))
    toks_out = np.asarray(generate(state.params["cap"], cap_cfg, vis,
                                   max_new=64))
    print("target :", captions[0][:70])
    print("sample :", decode(toks_out[0])[:70])


if __name__ == "__main__":
    main()
