"""Measure realtime stream-count scaling on the accelerator.

For each stream count, drives the realtime engine wall-clock-paced
(``simulate(..., realtime=True)``) so overload shows up as shed chunks /
dropped frames with the realtime factor pinned near 1.0 — and also in
max-throughput mode (realtime=False) for the raw capacity number.

Prints one JSON line per stream count:
  {"streams": N, "realtime_factor": ..., "throughput_factor": ...,
   "shed_chunks": ..., "dropped_frames": ..., "coverage": ...}

Run from the repo root: python scripts/measure_stream_scaling.py
"""
import asyncio
import json
import sys

import numpy as np

sys.path.insert(0, ".")

from vidgraph_tpu.services.embed_client import make_embed_client
from vidgraph_tpu.services.vlm_client import LocalVLMClient
from vidgraph_tpu.streams import RealtimeEngine, StreamSpec, simulate

VIDEO_SECONDS = 12.0


def make_engine(n):
    specs = [StreamSpec(f"cam{i}", fps=30.0, chunk_size_seconds=1.0,
                        frames_per_chunk=5, height=240, width=320)
             for i in range(n)]
    return RealtimeEngine(specs,
                          embed_client=make_embed_client("tpu", dim=512),
                          vlm_client=LocalVLMClient())


def run(n, realtime, seconds=VIDEO_SECONDS):
    frame = np.zeros((240, 320, 3), np.uint8)
    frame[40:200, 60:260] = (200, 30, 30)

    def src():
        while True:
            yield frame

    engine = make_engine(n)
    return asyncio.run(simulate(
        engine, {f"cam{i}": src() for i in range(n)},
        video_seconds=seconds, realtime=realtime))


def main():
    for n in (8, 16, 32, 64):
        run(n, realtime=False, seconds=2.0)   # warm jit shapes
        thr = run(n, realtime=False)
        rt = run(n, realtime=True)
        done = sum(s["chunks_done"] for s in rt["streams"].values())
        shed = rt["total_shed_chunks"]
        # frames dropped at rings, in whole-window units for coverage
        win_frames = 30  # fps * chunk_size_seconds
        ring_windows = rt["total_dropped_frames"] // win_frames
        total = done + shed + ring_windows
        print(json.dumps({
            "streams": n,
            "throughput_factor": round(thr["realtime_factor"], 2),
            "realtime_factor": round(rt["realtime_factor"], 3),
            "chunks_done": done,
            "shed_chunks": shed,
            "dropped_frames": rt["total_dropped_frames"],
            "coverage": round(done / total, 3) if total else None,
            "query_na": True,
        }), flush=True)


if __name__ == "__main__":
    main()
