"""Continuous batching for in-process model serving.

The reference's model calls were one HTTP round trip per request; here the
models live in-process on the device, so concurrent callers (8 live streams,
scheduled retrievals, the KG pipeline) should share device dispatches.
``ContinuousBatcher`` coalesces concurrent requests into single batched
calls: a request waits at most ``max_wait_ms`` for co-riders, batches are
capped at ``max_batch``, and higher-priority requests (online retrieval)
jump the queue — the simple scheduler SURVEY §7 called for ("retrieval
preempts captioning").
"""
from __future__ import annotations

import asyncio
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ..core.logger import get_logger

logger = get_logger("scheduler")


class ContinuousBatcher:
    """Coalesces concurrent ``submit`` calls into batched ``batch_fn``
    invocations.  ``batch_fn(items) -> list`` must return one result per
    item, in order."""

    def __init__(self, batch_fn: Callable[[List[Any]], Awaitable[List[Any]]],
                 max_batch: int = 16, max_wait_ms: float = 5.0) -> None:
        self._batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: List[Tuple[int, Any, asyncio.Future]] = []
        self._wakeup: Optional[asyncio.Event] = None
        self._runner: Optional[asyncio.Task] = None
        self.batch_sizes: List[int] = []
        self.wait_ms: List[float] = []

    def _ensure_runner(self) -> None:
        if self._wakeup is None:
            self._wakeup = asyncio.Event()
        if self._runner is None or self._runner.done():
            self._runner = asyncio.ensure_future(self._run())

    async def submit(self, item: Any, priority: int = 1) -> Any:
        """priority 0 = urgent (front of queue), 1 = normal."""
        self._ensure_runner()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        entry = (priority, item, fut)
        if priority == 0:
            self._queue.insert(0, entry)
        else:
            self._queue.append(entry)
        self._wakeup.set()
        return await fut

    async def _run(self) -> None:
        while True:
            if not self._queue:
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    return  # idle: let the runner die; submit() restarts it
            t0 = time.perf_counter()
            # linger briefly so concurrent submitters can join the batch
            while (len(self._queue) < self.max_batch and
                   (time.perf_counter() - t0) * 1e3 < self.max_wait_ms):
                await asyncio.sleep(0)
            batch = self._queue[:self.max_batch]
            del self._queue[:len(batch)]
            if not batch:
                continue
            self.batch_sizes.append(len(batch))
            self.wait_ms.append((time.perf_counter() - t0) * 1e3)
            items = [item for _p, item, _f in batch]
            try:
                results = await self._batch_fn(items)
                if len(results) != len(items):
                    raise ValueError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(items)} items")
                for (_p, _i, fut), res in zip(batch, results):
                    if not fut.done():
                        fut.set_result(res)
            except Exception as e:
                for _p, _i, fut in batch:
                    if not fut.done():
                        fut.set_exception(
                            e if isinstance(e, Exception) else
                            RuntimeError(str(e)))

    def stats(self) -> Dict[str, Any]:
        return {
            "batches": len(self.batch_sizes),
            "avg_batch_size": (sum(self.batch_sizes) / len(self.batch_sizes)
                               if self.batch_sizes else 0.0),
            "max_batch_size": max(self.batch_sizes, default=0),
        }


class BatchedVLMClient:
    """Wraps a VLM client so individual ``caption`` calls ride the
    continuous batcher (and therefore one device dispatch)."""

    def __init__(self, inner, max_batch: int = 16,
                 max_wait_ms: float = 5.0) -> None:
        self.inner = inner
        self._batcher = ContinuousBatcher(self._run_batch,
                                          max_batch=max_batch,
                                          max_wait_ms=max_wait_ms)

    async def _run_batch(self, chunks: List[List]) -> List[str]:
        return await self.inner.caption_batch(chunks)

    async def caption(self, frames, system_prompt: str = "",
                      user_prompt: str = "") -> str:
        return await self._batcher.submit(list(frames))

    async def caption_batch(self, chunks, system_prompt: str = "",
                            user_prompt: str = "") -> List[str]:
        return list(await asyncio.gather(*[
            self._batcher.submit(list(c)) for c in chunks]))

    def stats(self) -> Dict[str, Any]:
        return self._batcher.stats()
