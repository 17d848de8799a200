"""VLM captioning clients — the stage that turns a chunk of frames into text.

* ``TPUVLMClient`` — frames -> fused preprocessing -> ViT vision tower ->
  captioner greedy decode, all on device, batched per chunk.  Replaces the
  reference's per-chunk HTTP round trip (reference:
  src/pipeline/vlm_extractor.py:121-192).
* ``HttpVLMClient`` — the reference-compatible OpenAI multi-image
  chat-completions call (JPEG-85 base64 frames, 3 retries, linear backoff).
* ``LocalVLMClient`` — deterministic caption synthesised from frame
  statistics (dominant hue, brightness, motion) so the full pipeline runs
  and is assertable offline.
"""
from __future__ import annotations

import asyncio
import base64
from typing import List, Optional, Sequence

import numpy as np

from ..core.config import IN_PROCESS
from ..core.logger import get_logger

logger = get_logger("vlm_client")


class VLMClient:
    async def caption(self, frames: Sequence[np.ndarray],
                      system_prompt: str = "",
                      user_prompt: str = "") -> str:
        raise NotImplementedError

    async def caption_batch(self, chunks: Sequence[Sequence[np.ndarray]],
                            system_prompt: str = "",
                            user_prompt: str = "") -> List[str]:
        """Caption many chunks; backends override with true batching."""
        return list(await asyncio.gather(*[
            self.caption(frames, system_prompt, user_prompt)
            for frames in chunks]))


_TPU_VLM_PRESETS = {
    # name -> (ViTConfig kwargs, CaptionerConfig kwargs)
    "b32": ({}, {}),
    "tiny64": (dict(image_size=64, patch_size=32, width=128, layers=4,
                    heads=4, embed_dim=64),
               dict(width=128, layers=4, heads=4, vision_dim=64,
                    num_vision_tokens=4, max_len=104)),
}


class TPUVLMClient(VLMClient):
    def __init__(self, vit_cfg=None, cap_cfg=None, seed: int = 0,
                 max_new: int = 256,
                 checkpoint: Optional[str] = None,
                 preset: Optional[str] = None,
                 preprocess: str = "auto",
                 fast_resize: bool = True,
                 param_dtype=None,
                 quantize: Optional[str] = None) -> None:
        import jax
        import jax.numpy as jnp

        from ..models.captioner import CaptionerConfig, init_params
        from ..models.vit import ViTConfig, init_vision_tower

        if preset:
            vkw, ckw = _TPU_VLM_PRESETS[preset]
            vit_cfg = vit_cfg or ViTConfig(dtype=jnp.float32, **vkw)
            cap_cfg = cap_cfg or CaptionerConfig(dtype=jnp.float32, **ckw)
        self.vit_cfg = vit_cfg or ViTConfig.b32()
        self.cap_cfg = cap_cfg or CaptionerConfig.base()
        self.vit, self.vit_params = init_vision_tower(self.vit_cfg, seed)
        # param_dtype=bf16 halves captioner memory + per-step weight reads —
        # required to serve CaptionerConfig.large() (1.2B) in-process
        self.cap_params = init_params(
            self.cap_cfg, seed,
            param_dtype=param_dtype or jnp.float32)
        if checkpoint:
            from ..models.checkpoint import load_params

            loaded = load_params({"vit": self.vit_params,
                                  "cap": self.cap_params}, checkpoint)
            self.vit_params = loaded["vit"]
            self.cap_params = loaded["cap"]
            logger.info("Loaded VLM weights from %s", checkpoint)
        # Tensor-parallel serving: when a multi-device serving mesh is
        # active, weights are placed with the trainer's shardings (qkv/fc1
        # column-split, attn_o/fc2 row-split over "model") and every
        # vision-tower / generate dispatch below runs inside the mesh.
        from ..parallel.serving import (serving_mesh, shard_captioner_params,
                                        shard_vit_params)

        self._mesh = serving_mesh()
        if self._mesh is not None:
            self.vit_params = shard_vit_params(self.vit_params, self._mesh)
            self.cap_params = shard_captioner_params(self.cap_params,
                                                     self._mesh)
        # Weight-only int8 serving (models/quant8.py): halves the
        # per-decode-step weight reads of the bandwidth-bound large
        # captioner.  Applied AFTER checkpoint load; mutually exclusive
        # with the tensor-parallel mesh (its shardings are declared for
        # float trees — quantized multi-chip serving is future work).
        if quantize:
            if quantize not in ("int8", "int8_a8"):
                raise ValueError(f"quantize must be int8|int8_a8, "
                                 f"got {quantize!r}")
            if self._mesh is not None:
                logger.warning("quantize=%s ignored: a tensor-parallel "
                               "serving mesh is active", quantize)
                quantize = None
            else:
                from ..models.quant8 import quantize_captioner_params
                import dataclasses

                self.cap_params = quantize_captioner_params(self.cap_params)
                self.cap_cfg = dataclasses.replace(
                    self.cap_cfg,
                    qmode="a8" if quantize == "int8_a8" else "a16")
        self.quantize = quantize
        self.max_new = max_new
        # Reproducibility knobs: "auto" and "device" resize on the
        # device, "host" with cv2; the choice never depends on what the
        # deployment has installed.
        if preprocess not in ("auto", "host", "device"):
            raise ValueError(f"preprocess must be auto|host|device, "
                             f"got {preprocess!r}")
        self.preprocess = preprocess
        self.fast_resize = fast_resize
        self._preproc_logged = False
        self._vit_apply = jax.jit(self.vit.apply)

    async def caption(self, frames, system_prompt="", user_prompt="") -> str:
        return (await asyncio.to_thread(self.caption_batch_sync,
                                        [list(frames)]))[0]

    async def caption_batch(self, chunks, system_prompt="",
                            user_prompt="") -> List[str]:
        return await asyncio.to_thread(
            self.caption_batch_sync, [list(c) for c in chunks])

    def _chunk_prefix(self, emb):
        """[n_frames, d] frame embeddings -> [nv, d] vision prefix."""
        import jax.numpy as jnp

        nv = self.cap_cfg.num_vision_tokens
        n = emb.shape[0]
        if n >= nv:
            return emb[:nv]
        reps = -(-nv // n)
        return jnp.tile(emb, (reps, 1))[:nv]

    def caption_batch_sync(self, chunks: List[List[np.ndarray]]
                           ) -> List[str]:
        """Continuous-batched serving: every chunk's frames run through the
        vision tower in ONE dispatch, and every caption decodes in ONE
        batched ``generate`` call (the KV-cache scan runs all sequences in
        lockstep)."""
        import jax.numpy as jnp

        from ..models import tokenizer
        from ..models.captioner import generate
        from ..ops.preprocess import preprocess_frames
        from ..parallel.serving import maybe_mesh

        stack = np.concatenate([np.stack(c).astype(np.uint8)
                                for c in chunks], axis=0)
        # The device resize is the default ("auto" == "device", whatever
        # is installed); "host" resizes with cv2 INTER_AREA first and
        # fails without cv2.  The mode pins the numerics.
        size = self.vit_cfg.image_size
        use_host = self.preprocess == "host"
        if use_host:
            try:
                import cv2
            except ImportError as e:
                raise RuntimeError(
                    "vlm.preprocess='host' requires cv2 (opencv)") from e
            stack = np.stack([
                cv2.resize(f, (size, size), interpolation=cv2.INTER_AREA)
                for f in stack]).astype(np.uint8)
        if not self._preproc_logged:
            logger.info(
                "VLM preprocess path: %s resize, device %s "
                "(vlm.preprocess=%s, vlm.fast_resize=%s)",
                "host cv2 INTER_AREA" if use_host else "device",
                "bf16 separable" if self.fast_resize else "exact f32",
                self.preprocess, self.fast_resize)
            self._preproc_logged = True
        total = stack.shape[0]
        fbucket = 8
        while fbucket < total:
            fbucket *= 2
        if fbucket != total:
            stack = np.concatenate(
                [stack, np.zeros((fbucket - total,) + stack.shape[1:],
                                 np.uint8)])
        with maybe_mesh(self._mesh):
            x = preprocess_frames(jnp.asarray(stack),
                                  size=self.vit_cfg.image_size,
                                  fast=self.fast_resize)
            emb = self._vit_apply(self.vit_params, x)[:total]
        prefixes = []
        off = 0
        for c in chunks:
            prefixes.append(self._chunk_prefix(emb[off:off + len(c)]))
            off += len(c)
        vis = jnp.stack(prefixes)                 # [n_chunks, nv, d]
        n = vis.shape[0]
        bucket = 1
        while bucket < n:
            bucket *= 2
        if bucket != n:   # pad to a power-of-two batch: bounded compiles
            vis = jnp.concatenate(
                [vis, jnp.zeros((bucket - n,) + vis.shape[1:], vis.dtype)])
        with maybe_mesh(self._mesh):
            toks = np.asarray(generate(self.cap_params, self.cap_cfg, vis,
                                       max_new=self.max_new))
        return [tokenizer.decode(toks[i]) for i in range(len(chunks))]


class HttpVLMClient(VLMClient):
    def __init__(self, endpoint: str, model: str, api_key: str = "",
                 temperature: float = 0.2, top_p: float = 0.9,
                 max_tokens: int = 2048, timeout: float = 180.0,
                 retries: int = 3, jpeg_quality: int = 85) -> None:
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/chat/completions"):
            self.endpoint += "/chat/completions"
        self.model = model
        self.api_key = api_key
        self.temperature = temperature
        self.top_p = top_p
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.retries = retries
        self.jpeg_quality = jpeg_quality

    @staticmethod
    def _to_b64_jpeg(frame: np.ndarray, quality: int) -> str:
        import cv2

        ok, buf = cv2.imencode(".jpg", frame,
                               [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        if not ok:
            raise ValueError("JPEG encoding failed")
        return base64.b64encode(buf.tobytes()).decode("ascii")

    async def caption(self, frames, system_prompt="", user_prompt="") -> str:
        import httpx

        content = [{"type": "text", "text": user_prompt or
                    "Describe what's happening in these frames from a video."}]
        for f in frames:
            b64 = self._to_b64_jpeg(np.asarray(f), self.jpeg_quality)
            content.append({
                "type": "image_url",
                "image_url": {"url": f"data:image/jpeg;base64,{b64}"},
            })
        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": content})
        payload = {"model": self.model, "messages": messages,
                   "temperature": self.temperature, "top_p": self.top_p,
                   "max_tokens": self.max_tokens}
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        last: Optional[Exception] = None
        async with httpx.AsyncClient(timeout=self.timeout) as client:
            for attempt in range(self.retries):
                try:
                    r = await client.post(self.endpoint, json=payload,
                                          headers=headers)
                    r.raise_for_status()
                    return r.json()["choices"][0]["message"]["content"]
                except Exception as e:
                    last = e
                    logger.warning("VLM attempt %d failed: %s",
                                   attempt + 1, e)
                    await asyncio.sleep(1.0 * (attempt + 1))
        raise RuntimeError(f"VLM captioning failed: {last}")


_HUES = [(0, "red"), (30, "orange"), (60, "yellow"), (120, "green"),
         (180, "cyan"), (240, "blue"), (300, "magenta"), (360, "red")]


def _dominant_color(frame: np.ndarray) -> str:
    f = frame.astype(np.float32) / 255.0
    r, g, b = f[..., 0].mean(), f[..., 1].mean(), f[..., 2].mean()
    mx, mn = max(r, g, b), min(r, g, b)
    if mx - mn < 0.08:
        v = (r + g + b) / 3
        return "white" if v > 0.7 else ("black" if v < 0.2 else "gray")
    if mx == r:
        h = 60 * (((g - b) / (mx - mn)) % 6)
    elif mx == g:
        h = 60 * ((b - r) / (mx - mn) + 2)
    else:
        h = 60 * ((r - g) / (mx - mn) + 4)
    return min(_HUES, key=lambda hv: abs(hv[0] - h))[1]


class LocalVLMClient(VLMClient):
    """Deterministic frame-statistics captioner for offline runs/tests."""

    async def caption(self, frames, system_prompt="", user_prompt="") -> str:
        frames = [np.asarray(f) for f in frames]
        color = _dominant_color(frames[0])
        brightness = float(np.mean([f.mean() for f in frames]) / 255.0)
        motion = 0.0
        if len(frames) > 1:
            diffs = [np.abs(frames[i + 1].astype(np.int16)
                            - frames[i].astype(np.int16)).mean()
                     for i in range(len(frames) - 1)]
            motion = float(np.mean(diffs) / 255.0)
        level = "bright" if brightness > 0.6 else (
            "dark" if brightness < 0.25 else "evenly lit")
        activity = "rapid movement" if motion > 0.08 else (
            "slight movement" if motion > 0.01 else "a static scene")
        return (f"The scene shows a {color} object on a {level} background. "
                f"The frames contain {activity}. A {color} shape dominates "
                f"the view across {len(frames)} frames.")


def make_vlm_client(kind: str, vlm_config=None) -> VLMClient:
    if kind == IN_PROCESS:
        ckpt = getattr(vlm_config, "checkpoint_path", None) \
            if vlm_config is not None else None
        preset = getattr(vlm_config, "tpu_preset", None) \
            if vlm_config is not None else None
        pre = getattr(vlm_config, "preprocess", "auto") \
            if vlm_config is not None else "auto"
        fast = getattr(vlm_config, "fast_resize", True) \
            if vlm_config is not None else True
        quant = getattr(vlm_config, "quantize", None) \
            if vlm_config is not None else None
        return TPUVLMClient(checkpoint=ckpt, preset=preset,
                            preprocess=pre, fast_resize=fast,
                            quantize=quant)
    if kind == "local":
        return LocalVLMClient()
    if kind == "http":
        c = vlm_config
        return HttpVLMClient(c.endpoint, c.model_name, c.api_key,
                             temperature=c.temperature, top_p=c.top_p,
                             max_tokens=c.max_tokens)
    raise ValueError(f"unknown vlm backend: {kind}")
