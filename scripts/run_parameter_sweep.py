#!/usr/bin/env python3
"""Automated parameter sweep: sample chunking parameters, run the full
kg -> batch-retrieve -> benchmark pipeline per epoch, track the best
configuration.

Behaviour parity with reference scripts/run_parameter_sweep.py:53-841:
* five chunking parameters sampled per epoch within ranges;
* per-epoch config YAML written with ``subgraph_extraction_injection``
  forced on;
* each stage runs as a CLI subprocess with a timeout; the graph UUID is
  parsed from the kg stage's output;
* per-stage failure statuses (kg_build_failed / retrieval_failed /
  benchmark_failed) continue to the next epoch;
* ``epoch_summary.json`` per epoch and an incrementally-updated
  ``sweep_summary.json`` with best-result tracking; ``--dry-run`` skips the
  subprocess stages; ``--start-epoch`` resumes a sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

PARAM_RANGES = {
    "chunk_size": (128, 512),
    "chunk_overlap": (8, 64),
    "max_triplets_per_chunk": (3, 10),
    "global_triplet_limit": (8, 30),
    "max_new_triplets": (5, 20),
}

UUID_RE = re.compile(
    r"UUID:\s*([0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
    r"[0-9a-f]{12})")


def sample_params(rng: random.Random) -> Dict[str, int]:
    return {name: rng.randint(lo, hi)
            for name, (lo, hi) in PARAM_RANGES.items()}


class EpochRunner:
    def __init__(self, epoch: int, base_config: Dict[str, Any],
                 params: Dict[str, int], out_dir: Path, args) -> None:
        self.epoch = epoch
        self.params = params
        self.out_dir = out_dir.resolve()
        self.args = args
        self.config = json.loads(json.dumps(base_config))  # deep copy
        self.config.setdefault("chunking", {}).update(params)
        self.config.setdefault("llm_injector", {})[
            "subgraph_extraction_injection"] = True
        # subprocess stages run with cwd=out_dir (so logs/metrics/graph_store
        # land per-sweep); every path handed to them must be absolute —
        # including model checkpoint paths the base config wrote relative
        # to the launcher's cwd (config/tpu_llm_config.yaml points at
        # checkpoints/instruct_lm.npz)
        for section, key in (("llm_injector", "checkpoint_path"),
                             ("llm_injector", "answer_selector_path"),
                             ("vlm", "checkpoint_path")):
            v = self.config.get(section, {}).get(key)
            if v and not Path(v).is_absolute():
                self.config[section][key] = str((Path.cwd() / v).resolve())
        self.config_path = self.out_dir / f"epoch_{epoch:03d}_config.yaml"

    def _cli(self, *cli_args: str, timeout: float) -> tuple[int, str]:
        cmd = [sys.executable, "-m", "vidgraph_tpu.cli.main", *cli_args]
        # child stages must see the repo even when the launcher relied on
        # this script's own sys.path bootstrap; append to any existing
        # PYTHONPATH.  Stages run one at a time and this parent never
        # imports jax, so only one process ever holds the accelerator.
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO_ROOT)] + ([env["PYTHONPATH"]]
                                if env.get("PYTHONPATH") else []))
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout, cwd=str(self.out_dir),
                                  env=env)
            return proc.returncode, proc.stdout + proc.stderr
        except subprocess.TimeoutExpired:
            return -1, "TIMEOUT"

    def run(self) -> Dict[str, Any]:
        t0 = time.time()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        with open(self.config_path, "w") as f:
            yaml.safe_dump(self.config, f)
        summary: Dict[str, Any] = {
            "epoch": self.epoch, "params": self.params,
            "config_path": str(self.config_path), "status": "ok",
            "graph_uuid": None, "accuracy": None,
            "avg_retrieval_time": None,
        }
        if self.args.dry_run:
            summary["status"] = "dry_run"
            return summary

        # 1) kg
        rc, out = self._cli("kg", "--config", str(self.config_path),
                            "--vlm-output",
                            str(Path(self.args.vlm_output).resolve()),
                            timeout=self.args.kg_timeout)
        m = UUID_RE.search(out)
        if rc != 0 or not m:
            summary["status"] = "kg_build_failed"
            summary["log_tail"] = out[-2000:]
            return summary
        graph_uuid = m.group(1)
        summary["graph_uuid"] = graph_uuid

        # 2) batch-retrieve
        results_path = self.out_dir / f"epoch_{self.epoch:03d}_retrieval.json"
        rc, out = self._cli("batch-retrieve", "--config",
                            str(self.config_path), "--graph-uuid",
                            graph_uuid, "--input",
                            str(Path(self.args.queries).resolve()),
                            "--output", str(results_path),
                            timeout=self.args.retrieve_timeout)
        if rc != 0 or not results_path.exists():
            summary["status"] = "retrieval_failed"
            summary["log_tail"] = out[-2000:]
            return summary
        try:
            recs = json.loads(results_path.read_text())
            times = [r["retrieval_time"] for r in recs]
            summary["avg_retrieval_time"] = (sum(times) / len(times)
                                             if times else None)
        except (json.JSONDecodeError, KeyError):
            pass

        # 3) benchmark
        bench_path = self.out_dir / f"epoch_{self.epoch:03d}_benchmark.json"
        rc, out = self._cli("benchmark", "--config", str(self.config_path),
                            "--input", str(results_path), "--output",
                            str(bench_path),
                            timeout=self.args.bench_timeout)
        if rc != 0 or not bench_path.exists():
            summary["status"] = "benchmark_failed"
            summary["log_tail"] = out[-2000:]
            return summary
        stats = json.loads(bench_path.read_text())["statistics"]
        summary["accuracy"] = stats.get("accuracy")
        summary["benchmark_stats"] = stats

        # copy per-batch network metrics next to the epoch artifacts
        metrics_src = (self.out_dir / "metrics" /
                       f"{graph_uuid}_batch_metrics_kg.json")
        if metrics_src.exists():
            shutil.copy(metrics_src,
                        self.out_dir /
                        f"epoch_{self.epoch:03d}_batch_metrics.json")
        summary["elapsed_s"] = time.time() - t0
        return summary


class SweepRunner:
    def __init__(self, args) -> None:
        self.args = args
        self.out_dir = Path(args.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        with open(args.base_config) as f:
            self.base_config = yaml.safe_load(f) or {}
        self.rng = random.Random(args.seed)
        self.summary_path = self.out_dir / "sweep_summary.json"
        self.summary: Dict[str, Any] = {"epochs": [], "best": None}
        if self.summary_path.exists() and args.start_epoch > 0:
            self.summary = json.loads(self.summary_path.read_text())

    def run(self) -> None:
        for epoch in range(self.args.epochs):
            params = sample_params(self.rng)
            if epoch < self.args.start_epoch:
                continue
            print(f"=== epoch {epoch}: {params}")
            runner = EpochRunner(epoch, self.base_config, params,
                                 self.out_dir, self.args)
            result = runner.run()
            (self.out_dir / f"epoch_{epoch:03d}_summary.json").write_text(
                json.dumps(result, indent=2))
            self.summary["epochs"].append(result)
            best = self.summary.get("best")
            if result.get("accuracy") is not None and (
                    best is None or
                    result["accuracy"] > best.get("accuracy", -1)):
                self.summary["best"] = result
            self.summary_path.write_text(
                json.dumps(self.summary, indent=2))
            print(f"    status={result['status']} "
                  f"accuracy={result.get('accuracy')}")
        print(f"Sweep complete. Best: "
              f"{json.dumps(self.summary.get('best'), indent=2)}")


def main() -> None:
    p = argparse.ArgumentParser(description="vidgraph-tpu parameter sweep")
    p.add_argument("--base-config", default=str(REPO_ROOT / "config" /
                                                "base_config.yaml"))
    p.add_argument("--vlm-output", required=True,
                   help="Path to a vlm_output.json to build graphs from")
    p.add_argument("--queries", required=True,
                   help="Groundtruth queries JSON for batch-retrieve")
    p.add_argument("--output-dir", default="sweep_results")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--kg-timeout", type=float, default=3600)
    p.add_argument("--retrieve-timeout", type=float, default=1800)
    p.add_argument("--bench-timeout", type=float, default=1800)
    SweepRunner(p.parse_args()).run()


if __name__ == "__main__":
    main()
