"""Real-time multi-stream video-memory runtime.

This is the capability the reference lacked entirely (its extractor was a
strictly serial offline loop — reference: src/pipeline/vlm_extractor.py:44)
and the north-star target: sustain 8 concurrent 30 fps streams on one host
with online retrieval p50 < 100 ms.

Architecture:

* per-stream ``FrameRing`` — a fixed-capacity uint8 ring buffer on the
  host; decode threads push frames, the engine pops completed chunks
  (``frames_per_chunk`` evenly spaced frames out of each
  ``chunk_size_seconds`` window);
* ``ChunkProcessor`` — completed chunks from ALL streams are coalesced
  into one device batch (preprocess kernel -> ViT embed in a single
  dispatch), captioned by the configured VLM backend, and appended to the
  stream's chunk memory (device-searchable immediately);
* KG triplet extraction runs as a background task per chunk so it never
  blocks ingest;
* ``query()`` serves online retrieval against the live memory with
  priority over captioning (the engine drains pending queries before
  starting the next caption batch);
* per-stream stats: achieved fps, chunk latency, query latencies.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.logger import get_logger
from ..io.video import format_chunk_time

logger = get_logger("realtime")


@dataclasses.dataclass
class StreamSpec:
    stream_id: str
    fps: float = 30.0
    chunk_size_seconds: float = 5.0
    frames_per_chunk: int = 5
    height: int = 240
    width: int = 320

    @property
    def frames_per_window(self) -> int:
        return max(1, int(self.fps * self.chunk_size_seconds))


class FrameRing:
    """Fixed-capacity frame ring; pops evenly-spaced chunk frames."""

    def __init__(self, spec: StreamSpec, windows: int = 4) -> None:
        self.spec = spec
        self.capacity = spec.frames_per_window * windows
        self._buf = np.zeros((self.capacity, spec.height, spec.width, 3),
                             np.uint8)
        self._write = 0          # total frames ever written
        self._chunk_idx = 0      # next chunk to emit
        self.dropped = 0

    def push(self, frame: np.ndarray) -> None:
        window = self.spec.frames_per_window
        # drop-oldest policy: if the consumer is more than the ring behind,
        # skip whole windows (a real-time system can't block the camera)
        consumed = self._chunk_idx * window
        if self._write - consumed >= self.capacity:
            self._chunk_idx += 1
            self.dropped += window
        self._buf[self._write % self.capacity] = frame
        self._write += 1

    def pop_chunk(self) -> Optional[Tuple[int, str, np.ndarray]]:
        """Returns (chunk_idx, time_label, frames [frames_per_chunk,H,W,3])
        when a full window is buffered."""
        window = self.spec.frames_per_window
        start = self._chunk_idx * window
        if self._write - start < window:
            return None
        offsets = np.linspace(0, window - 1,
                              self.spec.frames_per_chunk).astype(int)
        rows = (start + offsets) % self.capacity
        frames = self._buf[rows].copy()
        idx = self._chunk_idx
        self._chunk_idx += 1
        return idx, format_chunk_time(idx, self.spec.chunk_size_seconds), \
            frames


@dataclasses.dataclass
class StreamStats:
    frames_in: int = 0
    chunks_done: int = 0
    dropped: int = 0          # frames dropped at the ring (camera overrun)
    shed_chunks: int = 0      # whole chunks shed by the engine lag policy
    chunk_latencies_ms: List[float] = dataclasses.field(default_factory=list)


class RealtimeEngine:
    """N concurrent streams -> batched device embedding + captioning ->
    live searchable memory, with priority online retrieval."""

    def __init__(self, specs: List[StreamSpec], embed_client,
                 vlm_client=None, vision_embedder: Optional[Callable] = None,
                 graph_stores: Optional[Dict[str, Any]] = None,
                 retrieval_config=None, rerank_client=None,
                 kg_extractor: Optional[Callable] = None,
                 max_lag_windows: Optional[int] = 2) -> None:
        from ..memory.embedding_store import EmbeddingStore
        from ..parallel.serving import make_embedding_store

        self.specs = {s.stream_id: s for s in specs}
        self.rings = {s.stream_id: FrameRing(s) for s in specs}
        self.embed = embed_client
        self.vlm = vlm_client
        self.vision_embedder = vision_embedder
        self.stores = graph_stores or {}
        self.retrieval_config = retrieval_config
        self.rerank = rerank_client
        self.kg_extractor = kg_extractor
        # Load-shedding policy: when a stream has more than this many
        # completed-but-unprocessed chunk windows at collect time, the
        # OLDEST are dropped (counted in StreamStats.shed_chunks) so a
        # real-time engine degrades by losing coverage, never by queueing
        # unboundedly and falling behind wall time.  None disables.
        self.max_lag_windows = max_lag_windows
        # per-stream chunk memory; row-sharded over the serving mesh when
        # one is active (parallel/serving.py)
        self.memories: Dict[str, EmbeddingStore] = {
            s.stream_id: make_embedding_store(dim=embed_client.dim)
            for s in specs}
        self.captions: Dict[str, Dict[str, Dict[str, Any]]] = \
            defaultdict(dict)
        self.stats: Dict[str, StreamStats] = {
            s.stream_id: StreamStats() for s in specs}
        self.query_latencies_ms: List[float] = []
        self._pending_queries: asyncio.Queue = asyncio.Queue()
        self._bg_tasks: List[asyncio.Task] = []

    # --------------------------------------------------------------- ingest
    def push_frame(self, stream_id: str, frame: np.ndarray) -> None:
        self.rings[stream_id].push(frame)
        self.stats[stream_id].frames_in += 1

    def _collect_ready_chunks(self) -> List[Tuple[str, int, str, np.ndarray]]:
        ready = []
        for sid, ring in self.rings.items():
            items = []
            while True:
                item = ring.pop_chunk()
                if item is None:
                    break
                items.append(item)
            if (self.max_lag_windows is not None
                    and len(items) > self.max_lag_windows):
                shed = len(items) - self.max_lag_windows
                items = items[shed:]       # keep the NEWEST windows
                self.stats[sid].shed_chunks += shed
                logger.warning("Stream %s lagging: shed %d oldest chunk(s) "
                               "(keeping %d newest)", sid, shed, len(items))
            ready.extend((sid, *item) for item in items)
            self.stats[sid].dropped = ring.dropped
        return ready

    # ------------------------------------------------------------- processing
    async def _caption_chunks(self, ready) -> List[str]:
        if self.vlm is None:
            return [f"Stream {sid} chunk {idx}"
                    for sid, idx, _label, _f in ready]
        return await self.vlm.caption_batch(
            [list(frames) for _sid, _idx, _label, frames in ready])

    async def process_ready(self) -> int:
        """Process every completed chunk across all streams: one batched
        vision-embedding dispatch, then captions, memory insert, and
        background KG extraction.  Pending queries are served FIRST."""
        await self._drain_queries()
        ready = self._collect_ready_chunks()
        if not ready:
            return 0
        t0 = time.perf_counter()

        # one cross-stream device batch for frame embeddings
        if self.vision_embedder is not None:
            all_frames = np.concatenate([r[3] for r in ready], axis=0)
            self.vision_embedder(all_frames)  # warm path; used by captioner

        # all ready chunks captioned in one batched serving call
        captions = await self._caption_chunks(ready)

        # text-embed all captions in one batched call, insert per stream
        vecs = await self.embed.aembed(list(captions))
        for (sid, idx, label, _f), caption, vec in zip(ready, captions,
                                                       vecs):
            cid = f"{sid}_{idx}"
            self.memories[sid].add([cid], np.asarray(vec)[None])
            self.captions[sid][cid] = {"id": cid, "content": caption,
                                       "time": label, "chunk_idx": idx}
            st = self.stats[sid]
            st.chunks_done += 1
            st.chunk_latencies_ms.append((time.perf_counter() - t0) * 1e3)
            if self.kg_extractor is not None:
                task = asyncio.ensure_future(
                    self.kg_extractor(sid, cid, caption, label))
                self._bg_tasks.append(task)
        await self._drain_queries()
        return len(ready)

    # --------------------------------------------------------------- queries
    def attach_graph_store(self, stream_id: str, store) -> None:
        """Attach a live knowledge graph (e.g. from LiveKGIngestor): queries
        for this stream upgrade from pure vector matching to full hybrid
        retrieval (vector + fulltext + traversal) when retrieval_config is
        set."""
        self.stores[stream_id] = store

    async def query(self, stream_id: str, text: str, k: int = 3,
                    threshold: float = 0.1) -> Dict[str, Any]:
        """Online retrieval against the live stream memory; full hybrid
        retrieval when a live graph store is attached."""
        t0 = time.perf_counter()
        store = self.stores.get(stream_id)
        if store is not None and self.retrieval_config is not None:
            from ..pipeline.retriever_hybrid import HybridRetriever

            retriever = HybridRetriever(self.retrieval_config, store,
                                        self.embed, self.rerank,
                                        output_file=None)
            retrieval, _ = await retriever.perform_hybrid_retrieval(text)
            dt = (time.perf_counter() - t0) * 1e3
            self.query_latencies_ms.append(dt)
            return {"query": text, "stream": stream_id,
                    "retrieval": retrieval, "latency_ms": dt}
        qvec = await self.embed.aembed_query(text)
        hits = self.memories[stream_id].search(qvec[None], k=k,
                                               threshold=threshold)[0]
        chunks = [{**self.captions[stream_id][cid], "score": score}
                  for cid, score in hits
                  if cid in self.captions[stream_id]]
        dt = (time.perf_counter() - t0) * 1e3
        self.query_latencies_ms.append(dt)
        return {"query": text, "stream": stream_id, "chunks": chunks,
                "latency_ms": dt}

    def submit_query(self, stream_id: str, text: str) -> "asyncio.Future":
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending_queries.put_nowait((stream_id, text, fut))
        return fut

    async def _drain_queries(self) -> None:
        while not self._pending_queries.empty():
            sid, text, fut = self._pending_queries.get_nowait()
            try:
                fut.set_result(await self.query(sid, text))
            except Exception as e:  # pragma: no cover
                fut.set_exception(e)

    async def drain_background(self) -> None:
        if self._bg_tasks:
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
            self._bg_tasks.clear()

    # ----------------------------------------------------------------- stats
    def summary(self) -> Dict[str, Any]:
        per_stream = {}
        for sid, st in self.stats.items():
            lat = st.chunk_latencies_ms
            per_stream[sid] = {
                "frames_in": st.frames_in,
                "chunks_done": st.chunks_done,
                "dropped_frames": st.dropped,
                "shed_chunks": st.shed_chunks,
                "chunk_latency_p50_ms": (float(np.median(lat))
                                         if lat else None),
            }
        q = sorted(self.query_latencies_ms)
        return {
            "streams": per_stream,
            "total_dropped_frames": sum(s.dropped
                                        for s in self.stats.values()),
            "total_shed_chunks": sum(s.shed_chunks
                                     for s in self.stats.values()),
            "query_p50_ms": float(np.median(q)) if q else None,
            "query_p95_ms": (q[int(0.95 * (len(q) - 1))] if q else None),
            "queries_served": len(q),
        }


async def simulate(engine: RealtimeEngine,
                   sources: Dict[str, Iterator[np.ndarray]],
                   video_seconds: float,
                   queries: Optional[List[Tuple[float, str, str]]] = None,
                   realtime: bool = False) -> Dict[str, Any]:
    """Drive the engine from frame iterators for ``video_seconds`` of video
    time.  ``queries`` are (video_time_s, stream_id, text) triples.
    ``realtime=False`` runs as fast as the device allows (throughput
    measurement).  ``realtime=True`` is wall-clock-driven: frames arrive
    at camera rate regardless of how slow processing is, so an overloaded
    engine degrades by shedding chunks / dropping ring frames (visible in
    the summary) while the realtime factor stays pinned near 1.0 — never
    by queueing unboundedly and falling behind wall time.
    """
    queries = sorted(queries or [])
    qpos = 0
    t_wall = time.perf_counter()
    step = 1.0 / max(s.fps for s in engine.specs.values())
    t_video = 0.0
    next_frame_at = {sid: 0.0 for sid in engine.specs}
    while t_video < video_seconds:
        for sid, spec in engine.specs.items():
            while next_frame_at[sid] <= t_video:
                frame = next(sources[sid], None)
                if frame is not None:
                    engine.push_frame(sid, frame)
                next_frame_at[sid] += 1.0 / spec.fps
        while qpos < len(queries) and queries[qpos][0] <= t_video:
            _, sid, text = queries[qpos]
            engine.submit_query(sid, text)
            qpos += 1
        await engine.process_ready()
        if realtime:
            elapsed = time.perf_counter() - t_wall
            if elapsed < t_video + step:
                await asyncio.sleep(t_video + step - elapsed)
                t_video += step
            else:
                # Overloaded: the camera kept producing while we were
                # busy.  Jump video time forward to wall time so the
                # backlog arrives as a burst next iteration and the rings
                # + lag shedder absorb it (instead of slowing the camera
                # down, which no real-time source would do).
                t_video = min(video_seconds,
                              max(t_video + step, elapsed))
        else:
            t_video += step
    # Final push pass (ADVICE r3): an overloaded last iteration can jump
    # t_video to video_seconds with camera frames still due in the skipped
    # window — push them so frames_in (the coverage denominator) counts
    # every frame the camera produced during the run.
    for sid, spec in engine.specs.items():
        while next_frame_at[sid] < video_seconds:
            frame = next(sources[sid], None)
            if frame is not None:
                engine.push_frame(sid, frame)
            next_frame_at[sid] += 1.0 / spec.fps
    await engine.process_ready()
    await engine.drain_background()
    wall = time.perf_counter() - t_wall
    out = engine.summary()
    total_frames = sum(s["frames_in"] for s in out["streams"].values())
    out["wall_seconds"] = wall
    out["video_seconds"] = video_seconds
    out["aggregate_fps"] = total_frames / wall if wall > 0 else None
    out["realtime_factor"] = video_seconds / wall if wall > 0 else None
    return out
