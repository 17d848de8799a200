"""Grammar-constrained byte decoding for the instruct chat LM.

Round 5 (VERDICT r4 next #1): the pipeline's machine-parsed LM output
contracts — pre-extraction pipe lines, ``{"triplets": …}``, the 4-op
refinement JSON and the ``{"is_correct": …}`` judge — are compiled to
ONE byte-level DFA.  ``generate_from_tokens`` gathers the current row's
allowed-next-byte mask each scan step and adds it to the logits before
the argmax, so emitting an unparseable byte is structurally impossible
(reference contracts: src/components/prompts.py:46-88 pre/4-op,
src/pipeline/benchmark.py:200-248 judge).

Design notes:

* All contracts live in ONE transition table with different start
  states.  The table's shape is part of the jit key, so a single table
  means a single compiled decode executable no matter which contracts a
  ragged batch mixes — separate per-contract tables would each pay a
  compile of their own.
* The per-step work is two gathers (``trans[state]`` for the mask,
  ``trans[state, tok]`` for the next state) plus an elementwise
  ``where`` on [B, 259] logits — noise next to the per-step matmuls.
* State 0 is DEAD (nothing allowed — unreachable when masking is on),
  state 1 is FREE (everything allowed, self-loop: unconstrained rows
  and batch-dim filler), state 2 is SINK (only EOS, self-loop: entered
  after a contract completes, so post-completion steps can only emit
  EOS, matching the decode loop's done-row forcing).
* Budget truncation cannot be masked away (the scan length is static),
  so :meth:`Grammar.repair` walks the emitted bytes through the same
  table host-side and appends the precomputed shortest completion —
  output stays parseable even when the budget cuts a string mid-way.

The compiler is a small Thompson-NFA -> subset-construction pipeline
over the 259-symbol alphabet (bytes + PAD/BOS/EOS), with alphabet
partition refinement so the build stays well under a second.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import EOS_ID, VOCAB_SIZE

NSYM = VOCAB_SIZE          # 256 bytes + PAD + BOS + EOS
DEAD, FREE, SINK = 0, 1, 2

# --------------------------------------------------------------------------
# regex AST


class _Node:
    pass


class Lit(_Node):
    def __init__(self, text: str):
        self.data = text.encode("ascii")


class Cls(_Node):
    """Character class over SYMBOL ids (0..NSYM-1)."""

    def __init__(self, mask: np.ndarray):
        assert mask.shape == (NSYM,)
        self.mask = mask.astype(bool)


class Seq(_Node):
    def __init__(self, *parts: _Node):
        self.parts = parts


class Alt(_Node):
    def __init__(self, *parts: _Node):
        self.parts = parts


class Star(_Node):
    def __init__(self, inner: _Node):
        self.inner = inner


def Opt(inner: _Node) -> _Node:
    return Alt(inner, Seq())


def Plus(inner: _Node) -> _Node:
    return Seq(inner, Star(inner))


def chars(spec: str, negate_from: Optional[str] = None) -> Cls:
    """``chars("abc")`` — exactly those bytes; ``chars("", "ab")`` —
    printable ASCII (0x20-0x7E) minus the given bytes."""
    m = np.zeros((NSYM,), bool)
    if negate_from is not None:
        m[0x20:0x7F] = True
        for c in negate_from:
            m[ord(c)] = False
    for c in spec:
        m[ord(c)] = True
    return Cls(m)


# --------------------------------------------------------------------------
# Thompson NFA


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[int, int]]] = []   # (mask_id, target)
        self.masks: List[np.ndarray] = []
        self._mask_ids: Dict[bytes, int] = {}

    def new(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def mask_id(self, mask: np.ndarray) -> int:
        key = np.packbits(mask).tobytes()
        if key not in self._mask_ids:
            self._mask_ids[key] = len(self.masks)
            self.masks.append(mask)
        return self._mask_ids[key]

    def add(self, node: _Node) -> Tuple[int, int]:
        """Compile ``node`` to a fragment, return (start, end) states."""
        if isinstance(node, Lit):
            s = self.new()
            cur = s
            for b in node.data:
                nxt = self.new()
                m = np.zeros((NSYM,), bool)
                m[b] = True
                self.trans[cur].append((self.mask_id(m), nxt))
                cur = nxt
            return s, cur
        if isinstance(node, Cls):
            s, e = self.new(), self.new()
            self.trans[s].append((self.mask_id(node.mask), e))
            return s, e
        if isinstance(node, Seq):
            s = self.new()
            cur = s
            for p in node.parts:
                ps, pe = self.add(p)
                self.eps[cur].append(ps)
                cur = pe
            return s, cur
        if isinstance(node, Alt):
            s, e = self.new(), self.new()
            for p in node.parts:
                ps, pe = self.add(p)
                self.eps[s].append(ps)
                self.eps[pe].append(e)
            return s, e
        if isinstance(node, Star):
            s, e = self.new(), self.new()
            ps, pe = self.add(node.inner)
            self.eps[s] += [ps, e]
            self.eps[pe] += [ps, e]
            return s, e
        raise TypeError(node)


def _eps_closure(nfa: _NFA, states: frozenset) -> frozenset:
    stack = list(states)
    out = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _compile_dfa(node: _Node) -> Tuple[np.ndarray, np.ndarray]:
    """-> (trans [S, NSYM] int32 with -1 = dead, accept [S] bool).
    State 0 is the start state."""
    nfa = _NFA()
    start, end = nfa.add(node)

    # alphabet partition: two symbols transition identically iff they
    # agree on every mask used anywhere in the NFA
    mask_mat = (np.stack(nfa.masks, axis=0) if nfa.masks
                else np.zeros((1, NSYM), bool))
    _, class_of = np.unique(mask_mat.T, axis=0, return_inverse=True)
    n_classes = int(class_of.max()) + 1
    rep = np.zeros((n_classes,), np.int64)        # one symbol per class
    for sym in range(NSYM - 1, -1, -1):
        rep[class_of[sym]] = sym

    d0 = _eps_closure(nfa, frozenset([start]))
    ids: Dict[frozenset, int] = {d0: 0}
    order = [d0]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.full((n_classes,), -1, np.int64)
        for c in range(n_classes):
            sym = rep[c]
            tgt = set()
            for s in cur:
                for mid, t in nfa.trans[s]:
                    if nfa.masks[mid][sym]:
                        tgt.add(t)
            if tgt:
                clo = _eps_closure(nfa, frozenset(tgt))
                if clo not in ids:
                    ids[clo] = len(order)
                    order.append(clo)
                row[c] = ids.get(clo, -1)
        rows.append(row)
        i += 1
    trans = np.stack(rows, axis=0)[:, class_of].astype(np.int32)
    accept = np.array([end in st for st in order], bool)
    return trans, accept


# --------------------------------------------------------------------------
# the pipeline's contracts

def _jstr() -> _Node:
    """A json.dumps string (ensure_ascii=True => pure printable ASCII):
    ``"`` body ``"`` where body chars exclude ``"``/``\\`` and escapes
    are ``\\"  \\\\  \\/  \\b \\f \\n \\r \\t \\uXXXX``."""
    hexd = chars("0123456789abcdefABCDEF")
    esc = Seq(Lit("\\"),
              Alt(chars('"\\/bfnrt'), Seq(Lit("u"), hexd, hexd, hexd, hexd)))
    body = Alt(chars("", '"\\'), esc)
    return Seq(Lit('"'), Star(body), Lit('"'))


def _jlist(item: _Node) -> _Node:
    return Seq(Lit("["), Opt(Seq(item, Star(Seq(Lit(", "), item)))),
               Lit("]"))


def _triplet() -> _Node:
    s = _jstr()
    return Seq(Lit("["), s, Lit(", "), s, Lit(", "), s, Lit(", "),
               _jlist(_jstr()), Lit("]"))


def _grammar_consolidate() -> _Node:
    return Seq(Lit('{"triplets": '), _jlist(_triplet()), Lit("}"))


def _grammar_instruction() -> _Node:
    s = _jstr
    merge = Seq(Lit('{"local": '), s(), Lit(', "existing": '), s(),
                Opt(Seq(Lit(', "existing_id": '), s())), Lit("}"))
    prune = Alt(
        Seq(Lit('{"head": '), s(), Lit(', "relation": '), s(),
            Lit(', "tail": '), s(), Lit("}")),
        Seq(Lit('{"entity": '), s(), Lit("}")))
    return Seq(Lit('{"new_triplets": '), _jlist(_triplet()),
               Lit(', "inter_chunk_relations": '), _jlist(_triplet()),
               Lit(', "merge_instructions": '), _jlist(merge),
               Lit(', "prune_instructions": '), _jlist(prune),
               Lit("}"))


def _grammar_judge() -> _Node:
    return Seq(Lit('{"is_correct": '), Alt(Lit("true"), Lit("false")),
               Lit("}"))


def _grammar_pre() -> _Node:
    """Pipe-delimited triplet lines ``Head | relation | Tail`` (the
    pre-extraction contract pre_injector splits on '|'), zero or more,
    newline-separated.  Segments exclude '|' and newline."""
    seg = Plus(chars("", "|"))
    line = Seq(seg, Lit("| "), seg, Lit("| "), seg)
    return Opt(Seq(line, Star(Seq(Lit("\n"), line))))


#: contract name -> builder; order fixes the start-state layout
_CONTRACTS = (
    ("pre", _grammar_pre),
    ("consolidate", _grammar_consolidate),
    ("instruction", _grammar_instruction),
    ("judge", _grammar_judge),
)


class Grammar:
    """The combined automaton: one [S, NSYM] int32 transition table
    (DEAD=0 / FREE=1 / SINK=2 / contract states from 3), per-contract
    start states, and host-side shortest completions for budget repair."""

    def __init__(self):
        tables, accepts = [], []
        for _name, build in _CONTRACTS:
            t, a = _compile_dfa(build())
            tables.append(t)
            accepts.append(a)

        total = 3 + sum(t.shape[0] for t in tables)
        trans = np.zeros((total, NSYM), np.int32)          # DEAD row = 0
        trans[FREE, :] = FREE
        trans[SINK, :] = DEAD
        trans[SINK, EOS_ID] = SINK
        self.starts: Dict[str, int] = {"free": FREE}
        off = 3
        for (name, _b), t, a in zip(_CONTRACTS, tables, accepts):
            shifted = np.where(t >= 0, t + off, DEAD).astype(np.int32)
            shifted[a, EOS_ID] = SINK          # done => only EOS forever
            trans[off:off + t.shape[0]] = shifted
            self.starts[name] = off
            off += t.shape[0]
        self.trans = trans
        self.allowed = trans != DEAD
        self._completions = self._shortest_completions()
        self._device_trans = None

    # -- serve-side ---------------------------------------------------------
    def device_table(self):
        """The transition table as a device array (cached — its identity
        keeps every decode call on one compiled executable)."""
        if self._device_trans is None:
            import jax.numpy as jnp
            self._device_trans = jnp.asarray(self.trans)
        return self._device_trans

    def start_for_prompt(self, prompt: str) -> int:
        """Contract dispatch by the same marker strings the teacher /
        pipeline parsers key on (LocalChatClient.complete_sync)."""
        if "TRIPLET LINES:" in prompt:
            return self.starts["pre"]
        if '"is_correct"' in prompt:
            return self.starts["judge"]
        if '"new_triplets"' in prompt:
            return self.starts["instruction"]
        if '"triplets"' in prompt:
            return self.starts["consolidate"]
        return FREE

    # -- host-side repair ---------------------------------------------------
    def _shortest_completions(self) -> List[Optional[bytes]]:
        """BFS (reverse) from EOS-ready states: for every state, the
        shortest byte string that reaches a state where EOS is allowed."""
        S = self.trans.shape[0]
        eos_ok = self.allowed[:, EOS_ID]
        comp: List[Optional[bytes]] = [None] * S
        dist = np.full((S,), -1, np.int64)
        frontier = [s for s in range(S) if eos_ok[s]]
        for s in frontier:
            dist[s] = 0
            comp[s] = b""
        # reverse adjacency over byte symbols only (EOS ends, not extends)
        radj: List[List[Tuple[int, int]]] = [[] for _ in range(S)]
        for s in range(S):
            row = self.trans[s]
            for sym in range(256):
                t = row[sym]
                if t != DEAD:
                    radj[t].append((s, sym))
        while frontier:
            nxt = []
            for t in frontier:
                for s, sym in radj[t]:
                    if dist[s] < 0:
                        dist[s] = dist[t] + 1
                        comp[s] = bytes([sym]) + comp[t]
                        nxt.append(s)
            frontier = nxt
        return comp

    def repair(self, text: str, start: int) -> str:
        """Walk ``text``'s bytes through the table from ``start``; if the
        walk ends in a non-EOS-ready state (budget truncation), append
        the precomputed shortest completion.  FREE rows pass through."""
        if start == FREE:
            return text
        state = start
        data = text.encode("utf-8", errors="replace")
        for i, b in enumerate(data):
            nxt = self.trans[state, b]
            if nxt == DEAD:          # foreign text (e.g. unconstrained
                return text          # checkpoints) — leave it alone
            state = nxt
        if self.allowed[state, EOS_ID]:
            return text
        tail = self._completions[state]
        return text if tail is None else text + tail.decode("ascii")


@functools.lru_cache(maxsize=1)
def pipeline_grammar() -> Grammar:
    """The process-wide contract automaton (built once, ~a few hundred
    states / <1 MB table)."""
    return Grammar()
