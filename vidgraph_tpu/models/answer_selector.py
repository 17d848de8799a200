"""Trained answer-selection model for the fully-on-device pipeline.

Round 3's fully-on-device configuration (``backend.llm: tpu`` for the
benchmark answer stage too) scored 3.3%: free byte GENERATION could not
match the deterministic extractive answerer (held answer F1 0.52).
Round 4 reframes answering as SELECTION (VERDICT r3 missing #1 / next
#2): a byte-level cross-encoder (the reranker trunk, models/reranker.py)
scores every candidate context sentence against the question in one
batched device dispatch, and the answer is assembled EXTRACTIVELY from
the top-scored sentences with the same MMR + neighbor-completion
decoding the teacher uses (``services.llm_client.assemble_answer``) —
distilling the IDF+MMR teacher's *decisions* instead of its bytes.

Reference counterpart: the served Qwen LLM generating benchmark answers
over HTTP (reference: src/pipeline/benchmark.py:171-198).

Train with scripts/train_answer_selector.py (listwise KL to the
teacher's per-sentence score distribution over synthetic + real
retrieval contexts).
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.logger import get_logger
from . import tokenizer
from .reranker import (RerankerConfig, batch_encode_pairs,
                       init_reranker_params, reranker_scores)

logger = get_logger("answer_selector")


class AnswerSelector:
    """(question, candidate sentences) -> relevance scores + extractive
    answer assembly.  One batched device call per question (power-of-two
    padding bounds compiles)."""

    def __init__(self, cfg: Optional[RerankerConfig] = None, seed: int = 0,
                 checkpoint_path: str = "", mode: str = "blend") -> None:
        #: "blend" (default): model scores ride as the semantic channel on
        #: top of the deterministic lexical prior (the same z-scored slot
        #: the trained text encoder uses) — strictly a re-ranker of
        #: near-ties, so it can only perturb, never overrule, exact term
        #: matches.  "pure": the model's scores drive selection alone.
        #: Round-4 measurement: pure selection picks generic summary
        #: sentences over content-bearing ones on 2/30 parity questions
        #: (earlier evaluation notes, in git history); blending recovers them.
        self.mode = mode
        self.cfg = cfg or RerankerConfig()
        if checkpoint_path:
            # the sidecar records the trained architecture — restore it
            # so callers never have to thread the config around
            import json
            from pathlib import Path
            meta = Path(checkpoint_path).with_suffix(".json")
            if cfg is None and meta.exists():
                try:
                    sc = json.loads(meta.read_text()).get("selector_cfg")
                    if sc:
                        self.cfg = RerankerConfig(**sc)
                except (ValueError, OSError, TypeError):
                    pass
        self.params = init_reranker_params(self.cfg, seed)
        if checkpoint_path:
            from .checkpoint import load_params
            self.params = load_params(self.params, checkpoint_path)
            logger.info("Loaded answer-selector weights from %s",
                        checkpoint_path)
        self._fwd = jax.jit(lambda p, t: reranker_scores(p, self.cfg, t))

    def score(self, question: str, cands: List[str]) -> np.ndarray:
        if not cands:
            return np.zeros((0,), np.float32)
        toks = batch_encode_pairs(question, cands, self.cfg)
        n = toks.shape[0]
        nb = 8
        while nb < n:
            nb *= 2
        if nb != n:
            toks = np.concatenate(
                [toks, np.full((nb - n, toks.shape[1]), tokenizer.PAD_ID,
                               toks.dtype)])
        return np.asarray(self._fwd(self.params, jnp.asarray(toks)))[:n]

    def answer(self, question: str, context: str,
               max_sentences: int = 4, max_chars: int = 600) -> str:
        """Model-scored extractive answer (``self.mode``):

        * ``blend`` — the model is the semantic channel of the teacher's
          scorer (``teacher_answer_scores(sem_fn=...)``): lexical prior
          decides, model z-scores break near-ties.
        * ``pure`` — the model's scores drive selection alone; the
          teacher's MMR/neighbor assembly decodes the sentence set.
        """
        from ..services.llm_client import (_idf_weights, _stem, _words,
                                           answer_candidates,
                                           assemble_answer,
                                           teacher_answer_scores)

        if self.mode == "blend":
            scored = teacher_answer_scores(
                question, context, sem_fn=lambda q, c: self.score(q, c))
            if scored is None:
                return "I don't know."
            cand, toks, idf, scores = scored
            return assemble_answer(cand, toks, idf, scores,
                                   max_sentences=max_sentences,
                                   max_chars=max_chars)

        cand = answer_candidates(context)
        if not cand:
            return "I don't know."
        toks = [[_stem(w.lower()) for w in _words(s)] for s in cand]
        idf = _idf_weights(toks)
        s = self.score(question, cand).astype(np.float64)
        # model logits are scale-free: shift to a positive range so the
        # assembly's relative floor (0.35 x top) applies and the
        # "no answer" zero-check never false-fires on a negative logit
        s = s - s.min() + 1e-3
        return assemble_answer(cand, toks, idf, [float(x) for x in s],
                               max_sentences=max_sentences,
                               max_chars=max_chars, abs_floor=0.0)
