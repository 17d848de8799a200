#!/usr/bin/env bash
# Fully-on-device eval matrix (earlier evaluation notes (git history) `backend.llm: tpu` table).
#
# Builds the knowledge graph with the on-device instruct LM (batched
# decode), then scores the 30-question benchmark at the two retrieval
# profiles with (a) the deterministic extractive answerer and (b) the
# trained answer-selection model — the four accuracy cells of the matrix,
# plus the KG s/batch timing.
#
#   bash scripts/run_tpu_llm_eval.sh [workdir]
#
# Runs on the accelerator, one CLI stage at a time.  Requires
# checkpoints/instruct_lm.npz (+ answer_selector.npz for the (b) rows).
set -euo pipefail
REPO="$(cd "$(dirname "$0")/.." && pwd)"
WORK="${1:-$(mktemp -d)}"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
cd "$WORK"
echo "workdir: $WORK"

python - <<EOF
import yaml
repo = "$REPO"
tpu = yaml.safe_load(open(f"{repo}/config/tpu_llm_config.yaml"))
tpu["llm_injector"]["checkpoint_path"] = f"{repo}/checkpoints/instruct_lm.npz"
tpu["llm_injector"]["answer_selector_path"] = \
    f"{repo}/checkpoints/answer_selector.npz"
yaml.safe_dump(tpu, open("cfg_kg.yaml", "w"))

# retrieval profiles on the SAME graph: parity (base_config flow:
# top3 + compression + entity_first) and recall-tuned (high_recall)
for name, src in (("parity", "base_config"), ("recall", "high_recall_config")):
    prof = yaml.safe_load(open(f"{repo}/config/{src}.yaml"))
    cfg = dict(tpu)
    cfg["retrieval"] = prof["retrieval"]
    # cosine reranker on-device (no http service)
    cfg["retrieval"].pop("reranker_endpoint", None)
    yaml.safe_dump(cfg, open(f"cfg_{name}.yaml", "w"))

# deterministic-answerer benchmark config (the (a) rows): local llm
det = dict(tpu)
det["backend"] = dict(tpu["backend"], llm="local")
yaml.safe_dump(det, open("cfg_det.yaml", "w"))
EOF

echo "=== KG build (on-device LLM, batched decode)"
T0=$(date +%s)
python -m vidgraph_tpu.cli.main kg --config cfg_kg.yaml \
    --vlm-output /root/reference/data/outputs/vlm_output.json \
    2>&1 | tee kg.log | grep -E "Batch .* completed|UUID" | tail -3
T1=$(date +%s)
UUID=$(grep -o "UUID: .*" kg.log | tail -1 | cut -d' ' -f2)
NBATCH=$(grep -c "completed in" kg.log)
echo "kg: $NBATCH batches in $((T1-T0)) s = $(python -c "print(round(($T1-$T0)/$NBATCH,2))") s/batch (UUID $UUID)"

for PROF in parity recall; do
  echo "=== retrieve [$PROF]"
  python -m vidgraph_tpu.cli.main batch-retrieve --config cfg_$PROF.yaml \
      --graph-uuid "$UUID" \
      --input /root/reference/data/groundtruth/retrieval_offline.json \
      --output r_$PROF.json > br_$PROF.log 2>&1
  echo "=== benchmark [$PROF x deterministic answers]"
  python -m vidgraph_tpu.cli.main benchmark --config cfg_det.yaml \
      --input r_$PROF.json --output b_${PROF}_det.json > bm_${PROF}_det.log 2>&1
  python -c "import json; s=json.load(open('b_${PROF}_det.json'))['statistics']; print(f\"  {s['correct_answers']}/{s['total_queries']} = {s['accuracy']:.4f}\")"
  echo "=== benchmark [$PROF x tpu answers (selector)]"
  python -m vidgraph_tpu.cli.main benchmark --config cfg_kg.yaml \
      --input r_$PROF.json --output b_${PROF}_tpu.json > bm_${PROF}_tpu.log 2>&1
  python -c "import json; s=json.load(open('b_${PROF}_tpu.json'))['statistics']; print(f\"  {s['correct_answers']}/{s['total_queries']} = {s['accuracy']:.4f}\")"
done
echo "done: $WORK"
