"""Logit-processor pipeline — a host-only copy of
deeplearning4j_tpu/inference/logitproc.py (stop sequences, repetition
penalties, grammar-constrained decoding compiled to token masks, the
device mask table's bookkeeping and the SSE token streams).

The decode scheduler (`inference/engine.py`) samples every output token
on the host from a next-token probability row; this module shapes that
row first:

  - :class:`StopMatcher`: multi-token stop sequences matched across
    token boundaries (an Aho-Corasick automaton over token ids); it also
    reports how many trailing tokens are a live partial match, which the
    streaming layer withholds, so an SSE client never sees half a stop
    sequence;
  - :class:`LogitState.adjust`: repetition / presence / frequency
    penalties over the generated-token counts, multiplicative on the
    probability row (`models/sampling.sample_logits` renormalizes); with
    no penalty the row passes through as the same object;
  - :class:`CompiledGrammar`: a DFA over token ids compiled ahead of
    admission: per-state ``allow`` rows and a transition table. Builders:
    :func:`admit_all` (one state, everything allowed), :func:`compile_trie`
    (exactly one of a set of token sequences) and
    :func:`compile_json_schema` (a JSON-schema subset through a
    character-level Thompson NFA, subset construction, then composed
    with the token -> text alphabet);
  - :class:`MaskPool`: host bookkeeping of the engine's device mask table
    ``[mask_rows, vocab]`` (additive: 0 allowed, ``-inf`` forbidden; row
    0 reserved all-zeros), allocated in pow2-bucket chunks, refcounted
    and cached across requests by grammar content, zero-ref entries
    LRU-evicted. A grammar that cannot fit is masked on the host only,
    which is always exact (the host applies ``allow`` at sampling);
  - :class:`TokenStream`: the per-request event queue an SSE response
    drains, deduplicated by token index across crash-recovery re-decodes.

Invariants (held against the JAX copy in tests/test_torch_logitproc.py):
an admit-all grammar is token-identical to unconstrained decode (the
device mask adds 0.0, the host ``allow`` row is all True); grammar state,
penalty counts and stop matching advance only on emitted tokens.
"""
from __future__ import annotations

import hashlib
import json
import queue
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["CompiledGrammar", "GrammarError", "LogitState", "MaskPool",
           "StopMatcher", "TokenStream", "admit_all", "compile_json_schema",
           "compile_trie"]

# transition-table sentinel: no edge (the token is forbidden here)
_DEAD = -1

# subset-construction safety valve: a schema whose automaton explodes
# past this many DFA states is refused at COMPILE time (ahead of
# admission), never discovered as an OOM mid-decode
_MAX_DFA_STATES = 4096


class GrammarError(ValueError):
    """The grammar/schema cannot be compiled (unsupported construct, a
    literal character no token can produce, or a state-count blowup).
    Raised at compile time — ahead of admission — so the serving layer
    answers HTTP 400 instead of a request dying mid-decode."""


class CompiledGrammar:
    """A deterministic finite automaton over TOKEN ids.

    ``allow``: bool ``[n_states, vocab]`` — token t may be emitted from
    state s. ``next_state``: int32 ``[n_states, vocab]`` — the state
    after emitting t (``-1`` where forbidden). ``accepting``: bool
    ``[n_states]`` — the output so far is complete here (builders bake
    ``eos_id`` into accepting states' allow rows; a state whose allow
    row is all-False ends the request: the engine finishes it with
    ``finish_reason="grammar"``).

    ``key`` is a stable content hash — the engine's device-mask cache
    key, so two requests carrying equal grammars share one resident
    mask-row range.
    """

    def __init__(self, vocab_size: int, allow: np.ndarray,
                 next_state: np.ndarray, accepting: np.ndarray):
        self.vocab_size = int(vocab_size)
        self.allow = np.ascontiguousarray(allow, dtype=bool)
        self.next_state = np.ascontiguousarray(next_state, dtype=np.int32)
        self.accepting = np.ascontiguousarray(accepting, dtype=bool)
        if self.allow.shape != (self.n_states, self.vocab_size):
            raise ValueError(
                f"allow shape {self.allow.shape} != "
                f"({self.n_states}, {self.vocab_size})")
        if self.next_state.shape != self.allow.shape:
            raise ValueError("next_state/allow shape mismatch")
        self.key = hashlib.sha1(
            self.allow.tobytes() + self.next_state.tobytes()
            + self.accepting.tobytes()).hexdigest()

    @property
    def n_states(self) -> int:
        return self.next_state.shape[0]

    def step(self, state: int, tok: int) -> int:
        """The state after emitting ``tok`` (stays put on a forbidden
        token — the engine never emits one, but a caller replaying a
        foreign token stream must not index row ``-1``)."""
        ns = int(self.next_state[state, tok])
        return ns if ns >= 0 else int(state)

    def allow_row(self, state: int) -> np.ndarray:
        return self.allow[state]

    def live(self, state: int) -> bool:
        """False when no token is admissible from ``state`` — the
        grammar is complete and the request should finish."""
        return bool(self.allow[state].any())

    def mask_table(self, dtype=np.float32) -> np.ndarray:
        """The ADDITIVE device mask: ``0.0`` where allowed, ``-inf``
        where forbidden — added to the model's probability row inside
        the masked decode program. An all-allowed state's row is all
        zeros, so ``p + row == p`` bitwise: the admit-all grammar is
        token-identical to unconstrained decode by construction."""
        table = np.where(self.allow, 0.0, -np.inf)
        return np.ascontiguousarray(table, dtype=dtype)


def admit_all(vocab_size: int) -> CompiledGrammar:
    """The identity grammar: one state, every token allowed, self-loop.
    Its mask row is all zeros — the token-identity reference the bench
    and the constrained-decode tests pin."""
    v = int(vocab_size)
    return CompiledGrammar(
        v, np.ones((1, v), bool), np.zeros((1, v), np.int32),
        np.ones((1,), bool))


def compile_trie(sequences: Sequence[Sequence[int]], vocab_size: int,
                 eos_id: Optional[int] = None) -> CompiledGrammar:
    """Admit exactly one of ``sequences`` (a trie/DFA over the
    vocab). After a full sequence the state
    is accepting: ``eos_id`` (when given) becomes the only admissible
    token there; without one the allow row goes empty and the engine
    finishes the request."""
    v = int(vocab_size)
    if not sequences:
        raise GrammarError("compile_trie needs at least one sequence")
    if eos_id is not None and not 0 <= int(eos_id) < v:
        # same guard as compile_json_schema: a negative eos_id would
        # silently index from the END of the vocab row
        raise GrammarError(f"eos_id {eos_id} out of range [0, {v})")
    children: List[Dict[int, int]] = [{}]
    terminal = [False]
    for seq in sequences:
        if not len(seq):
            raise GrammarError("empty stop/trie sequence")
        s = 0
        for t in seq:
            t = int(t)
            if not 0 <= t < v:
                raise GrammarError(f"token {t} out of range [0, {v})")
            if t not in children[s]:
                children.append({})
                terminal.append(False)
                children[s][t] = len(children) - 1
            s = children[s][t]
        terminal[s] = True
    n = len(children)
    allow = np.zeros((n, v), bool)
    nxt = np.full((n, v), _DEAD, np.int32)
    for s, kids in enumerate(children):
        for t, ns in kids.items():
            allow[s, t] = True
            nxt[s, t] = ns
        if terminal[s] and eos_id is not None:
            allow[s, eos_id] = True
            nxt[s, eos_id] = s  # engine finishes at EOS before stepping on
    return CompiledGrammar(v, allow, nxt, np.asarray(terminal, bool))


# ---------------------------------------------------------------------------
# JSON-schema → character NFA → DFA → token DFA
# ---------------------------------------------------------------------------

class _Nfa:
    """Thompson-construction scratchpad: integer states, char-labelled
    and epsilon edges. Fragments are (start, end) pairs; combinators
    take FACTORIES where a sub-automaton must be duplicated (bounded
    repetition), because fragments share the one state arena."""

    def __init__(self):
        self.edges: List[List[Tuple[str, int]]] = []
        self.eps: List[List[int]] = []

    def state(self) -> int:
        self.edges.append([])
        self.eps.append([])
        return len(self.edges) - 1

    def lit(self, text: str) -> Tuple[int, int]:
        s = cur = self.state()
        for ch in text:
            nxt = self.state()
            self.edges[cur].append((ch, nxt))
            cur = nxt
        return s, cur

    def charclass(self, chars: str) -> Tuple[int, int]:
        s, e = self.state(), self.state()
        for ch in sorted(set(chars)):
            self.edges[s].append((ch, e))
        return s, e

    def seq(self, frags: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
        if not frags:
            s = self.state()
            return s, s
        for (_, e1), (s2, _) in zip(frags, frags[1:]):
            self.eps[e1].append(s2)
        return frags[0][0], frags[-1][1]

    def alt(self, frags: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
        s, e = self.state(), self.state()
        for fs, fe in frags:
            self.eps[s].append(fs)
            self.eps[fe].append(e)
        return s, e

    def repeat(self, factory: Callable[[], Tuple[int, int]],
               lo: int, hi: int) -> Tuple[int, int]:
        """``factory()`` between ``lo`` and ``hi`` times (bounded — the
        DFA must stay finite, and JSON consumers want bounded outputs
        anyway)."""
        frags = [factory() for _ in range(lo)]
        opt_starts: List[Tuple[int, int]] = []
        for _ in range(max(0, hi - lo)):
            opt_starts.append(factory())
        frag = self.seq(frags) if frags else None
        end = self.state()
        if frag is None:
            start = self.state()
            self.eps[start].append(end)
            cur = start
        else:
            start, cur = frag
            cur_end = frag[1]
            self.eps[cur_end].append(end)
            cur = cur_end
        for fs, fe in opt_starts:
            self.eps[cur].append(fs)
            self.eps[fe].append(end)
            cur = fe
        return start, end


def _eps_closure(nfa: _Nfa, states: frozenset) -> frozenset:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


def _nfa_to_dfa(nfa: _Nfa, start: int, accept: int):
    """Subset construction: (transitions: List[Dict[char, int]],
    accepting: List[bool], start_id)."""
    d0 = _eps_closure(nfa, frozenset([start]))
    ids: Dict[frozenset, int] = {d0: 0}
    trans: List[Dict[str, int]] = [{}]
    acc: List[bool] = [accept in d0]
    work = [d0]
    while work:
        cur = work.pop()
        cid = ids[cur]
        by_char: Dict[str, set] = {}
        for s in cur:
            for ch, t in nfa.edges[s]:
                by_char.setdefault(ch, set()).add(t)
        for ch, targets in by_char.items():
            dst = _eps_closure(nfa, frozenset(targets))
            if dst not in ids:
                if len(ids) >= _MAX_DFA_STATES:
                    raise GrammarError(
                        f"schema automaton exceeds {_MAX_DFA_STATES} "
                        "states; simplify the schema (shorter strings, "
                        "fewer alternatives)")
                ids[dst] = len(ids)
                trans.append({})
                acc.append(accept in dst)
                work.append(dst)
            trans[cid][ch] = ids[dst]
    return trans, acc, 0


_JSON_STRING_DEFAULT_LEN = 8
_JSON_INT_DEFAULT_DIGITS = 3


def _schema_fragment(nfa: _Nfa, schema: dict, charset: str,
                     depth: int = 0) -> Tuple[int, int]:
    """One schema node as an NFA fragment. Supported subset (documented
    in docs/serving.md): const/enum, boolean, null, integer (bounded
    digits), string (bounded length, restricted charset), array
    (bounded items), object (properties emitted in declaration order —
    canonical-form JSON, which is what a constrained DECODER produces;
    a validator accepts any order, so parse-compatibility holds)."""
    if depth > 16:
        raise GrammarError("schema nesting deeper than 16 levels")
    if not isinstance(schema, dict):
        raise GrammarError(f"schema node must be an object, got "
                           f"{type(schema).__name__}")
    if "const" in schema:
        return nfa.lit(json.dumps(schema["const"]))
    if "enum" in schema:
        opts = schema["enum"]
        if not opts:
            raise GrammarError("empty enum")
        return nfa.alt([nfa.lit(json.dumps(v)) for v in opts])
    t = schema.get("type")
    if t == "boolean":
        return nfa.alt([nfa.lit("true"), nfa.lit("false")])
    if t == "null":
        return nfa.lit("null")
    if t == "integer":
        digits = int(schema.get("maxDigits", _JSON_INT_DEFAULT_DIGITS))
        if digits < 1:
            raise GrammarError("integer maxDigits must be >= 1")
        lead = nfa.alt([nfa.lit("0"),
                        nfa.seq([nfa.charclass("123456789"),
                                 nfa.repeat(
                                     lambda: nfa.charclass("0123456789"),
                                     0, digits - 1)])])
        if schema.get("minimum", -1) >= 0:
            return lead
        return nfa.seq([nfa.repeat(lambda: nfa.lit("-"), 0, 1), lead])
    if t == "string":
        chars = schema.get("charset")
        if chars is None:
            chars = "".join(c for c in charset
                            if c not in '"\\' and c >= " ")
        else:
            missing = [c for c in chars if c not in charset]
            if missing:
                raise GrammarError(
                    f"string charset chars {missing!r} not producible "
                    "by any token")
            if any(c in '"\\' for c in chars):
                raise GrammarError(
                    'string charset must not contain \'"\' or backslash '
                    "(no escape support in the compiled automaton)")
        if not chars:
            raise GrammarError(
                "no token can produce a JSON string character")
        lo = int(schema.get("minLength", 0))
        hi = int(schema.get("maxLength", _JSON_STRING_DEFAULT_LEN))
        if not 0 <= lo <= hi:
            raise GrammarError(f"bad string length bounds [{lo}, {hi}]")
        body = nfa.repeat(lambda: nfa.charclass(chars), lo, hi)
        return nfa.seq([nfa.lit('"'), body, nfa.lit('"')])
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarError("array schema needs items")
        lo = int(schema.get("minItems", 1))
        hi = int(schema.get("maxItems", 3))
        if not 0 <= lo <= hi:
            raise GrammarError(f"bad array item bounds [{lo}, {hi}]")
        counts = []
        for k in range(lo, hi + 1):
            if k == 0:
                counts.append(nfa.lit(""))
                continue
            parts = []
            for i in range(k):
                if i:
                    parts.append(nfa.lit(","))
                parts.append(_schema_fragment(nfa, items, charset,
                                              depth + 1))
            counts.append(nfa.seq(parts))
        return nfa.seq([nfa.lit("["), nfa.alt(counts), nfa.lit("]")])
    if t == "object":
        props = schema.get("properties")
        if not props:
            raise GrammarError("object schema needs properties")
        parts: List[Tuple[int, int]] = [nfa.lit("{")]
        for i, (name, sub) in enumerate(props.items()):
            if i:
                parts.append(nfa.lit(","))
            parts.append(nfa.lit(json.dumps(name) + ":"))
            parts.append(_schema_fragment(nfa, sub, charset, depth + 1))
        parts.append(nfa.lit("}"))
        return nfa.seq(parts)
    raise GrammarError(f"unsupported schema node: {schema!r} (supported: "
                       "const/enum/boolean/null/integer/string/array/"
                       "object)")


def compile_json_schema(schema: dict,
                        token_strs: Union[str, Sequence[str]],
                        eos_id: Optional[int] = None) -> CompiledGrammar:
    """Compile a (restricted) JSON schema into a token-level
    :class:`CompiledGrammar`.

    ``token_strs`` maps token id → the text that token decodes to: a
    string treats each character as one token (the char-LM case), a
    list supports multi-character tokens — a token's transition is the
    composition of its characters' transitions through the char DFA, so
    a token whose text crosses a structural boundary (``":``) is
    admitted exactly when every character in it is.

    Every literal character the schema requires must be producible by
    some token (checked here, at compile time — a gap would otherwise
    dead-end the automaton mid-decode and surface as a confusing
    ``finish_reason="grammar"`` half-way through an object).
    """
    if isinstance(token_strs, str):
        strs = list(token_strs)
    else:
        strs = [str(s) for s in token_strs]
    v = len(strs)
    if eos_id is not None and not 0 <= int(eos_id) < v:
        raise GrammarError(f"eos_id {eos_id} out of range [0, {v})")
    charset = "".join(sorted({c for s in strs for c in s}))
    nfa = _Nfa()
    frag = _schema_fragment(nfa, schema, charset)
    # compile-time coverage check: every literal char the automaton can
    # demand must exist in some token (charclasses were intersected
    # above; literals were not)
    need = {ch for edges in nfa.edges for ch, _ in edges}
    missing = sorted(need - set(charset))
    if missing:
        raise GrammarError(
            f"schema requires characters {missing!r} no token produces")
    trans, acc, dstart = _nfa_to_dfa(nfa, frag[0], frag[1])

    def tok_step(ds: int, tok: int) -> int:
        for ch in strs[tok]:
            nxt = trans[ds].get(ch)
            if nxt is None:
                return _DEAD
            ds = nxt
        return ds

    # BFS over token-level reachability: only char states reachable by
    # WHOLE tokens become grammar states (multi-char tokens skip the
    # intermediate char states entirely)
    ids: Dict[int, int] = {dstart: 0}
    order = [dstart]
    rows: List[np.ndarray] = []
    nxts: List[np.ndarray] = []
    accs: List[bool] = []
    i = 0
    while i < len(order):
        ds = order[i]
        i += 1
        allow = np.zeros((v,), bool)
        nxt = np.full((v,), _DEAD, np.int32)
        for tok in range(v):
            if not strs[tok]:
                continue  # an empty-text token can never advance JSON
            t2 = tok_step(ds, tok)
            if t2 == _DEAD:
                continue
            if t2 not in ids:
                ids[t2] = len(order)
                order.append(t2)
            allow[tok] = True
            nxt[tok] = ids[t2]
        if acc[ds] and eos_id is not None and 0 <= eos_id < v:
            allow[eos_id] = True
            nxt[eos_id] = ids[ds]
        rows.append(allow)
        nxts.append(nxt)
        accs.append(bool(acc[ds]))
    return CompiledGrammar(v, np.stack(rows), np.stack(nxts),
                           np.asarray(accs, bool))


# ---------------------------------------------------------------------------
# stop sequences
# ---------------------------------------------------------------------------

class StopMatcher:
    """Aho-Corasick matcher over token ids for MULTI-token stop
    sequences, matched across token boundaries (a stop sequence split
    over two decode steps still matches).

    ``feed(tok)`` returns the length of the stop sequence that COMPLETED
    at this token (0 otherwise — the longest, when several end here).
    ``pending`` is the number of trailing emitted tokens that form a
    live partial match: the streaming layer withholds exactly those, so
    a client never receives the head of a stop sequence the next token
    would complete (and the withheld tokens flush the moment the match
    dies)."""

    def __init__(self, sequences: Sequence[Sequence[int]]):
        seqs = [[int(t) for t in s] for s in sequences]
        if not seqs or any(not s for s in seqs):
            raise ValueError("stop sequences must be non-empty")
        goto: List[Dict[int, int]] = [{}]
        depth = [0]
        out_len = [0]
        for s in seqs:
            node = 0
            for t in s:
                if t not in goto[node]:
                    goto.append({})
                    depth.append(depth[node] + 1)
                    out_len.append(0)
                    goto[node][t] = len(goto) - 1
                node = goto[node][t]
            out_len[node] = max(out_len[node], len(s))
        # BFS fail links; out_len inherits through the suffix chain so a
        # shorter stop ending inside a longer partial match still fires
        fail = [0] * len(goto)
        work = list(goto[0].values())
        while work:
            node = work.pop(0)
            for t, child in goto[node].items():
                work.append(child)
                f = fail[node]
                while f and t not in goto[f]:
                    f = fail[f]
                fail[child] = goto[f].get(t, 0) if goto[f].get(t, 0) != child \
                    else 0
                out_len[child] = max(out_len[child], out_len[fail[child]])
        self._goto = goto
        self._fail = fail
        self._depth = depth
        self._out = out_len
        self._state = 0

    def feed(self, tok: int) -> int:
        s = self._state
        while s and tok not in self._goto[s]:
            s = self._fail[s]
        s = self._goto[s].get(tok, 0)
        self._state = s
        return self._out[s]

    @property
    def pending(self) -> int:
        """Trailing tokens currently withheld as a live partial match."""
        return self._depth[self._state]


# ---------------------------------------------------------------------------
# the per-request pipeline
# ---------------------------------------------------------------------------

class LogitState:
    """Per-request logit-processor state: penalty counts, grammar DFA
    position, stop matcher, and the device-mask residency handle.

    Owned by the scheduler thread (it lives on the `_ActiveSeq`); built
    fresh by every `engine.submit` — including the supervisor's crash-
    recovery resubmission, so a token-identical re-decode re-observes
    from a clean state. Grammar state and penalty counts advance only on
    EMITTED tokens (prompt tokens are conditioning, not output)."""

    __slots__ = ("vocab", "grammar", "gstate", "stop",
                 "rep", "presence", "freq", "_counts", "mask_base")

    def __init__(self, vocab_size: int, *,
                 grammar: Optional[CompiledGrammar] = None,
                 stop: Optional[Sequence[Sequence[int]]] = None,
                 repetition_penalty: Optional[float] = None,
                 presence_penalty: Optional[float] = None,
                 frequency_penalty: Optional[float] = None):
        self.vocab = int(vocab_size)
        if grammar is not None and grammar.vocab_size != self.vocab:
            raise ValueError(
                f"grammar vocab {grammar.vocab_size} != engine vocab "
                f"{self.vocab}")
        self.grammar = grammar
        self.gstate = 0
        self.stop = StopMatcher(stop) if stop else None
        self.rep = float(repetition_penalty) if repetition_penalty else None
        self.presence = float(presence_penalty) if presence_penalty else 0.0
        self.freq = float(frequency_penalty) if frequency_penalty else 0.0
        penal = (self.rep is not None or self.presence or self.freq)
        self._counts = np.zeros((self.vocab,), np.int64) if penal else None
        # first device row of this grammar's resident mask range (set by
        # the engine at admission; None = host-only masking fallback)
        self.mask_base: Optional[int] = None

    @property
    def active(self) -> bool:
        return (self.grammar is not None or self.stop is not None
                or self._counts is not None)

    def adjust(self, row: np.ndarray) -> np.ndarray:
        """Penalty-adjusted probability row (the SAME object when no
        penalty applies — the bitwise-identity fast path). Multiplicative
        in probability space == additive in log space, and
        `sample_logits` renormalizes, so no softmax is needed here:
        repetition penalty r scales seen tokens' (negative) log-probs by
        r (``p^r``), presence/frequency subtract ``α·seen + β·count``
        from the logit (``·e^-…``)."""
        counts = self._counts
        if counts is None:
            return row
        seen = counts > 0
        if not seen.any():
            return row
        out = np.array(row, np.float64)
        if self.rep is not None and self.rep != 1.0:
            out[seen] = out[seen] ** self.rep
        if self.presence or self.freq:
            out *= np.exp(-(self.presence * seen + self.freq * counts))
        return out

    def allow_row(self) -> Optional[np.ndarray]:
        """The EXACT host-side mask for the next sampled token (None =
        unconstrained). Applied by `sample_logits` as ``-inf`` logits —
        forbidden tokens get probability exactly 0, whatever the device
        mask did (the device's additive row is the perf assist; this is
        the correctness guarantee)."""
        if self.grammar is None:
            return None
        return self.grammar.allow[self.gstate]

    def advance(self, tok: int) -> None:
        if self._counts is not None:
            self._counts[tok] += 1
        if self.grammar is not None:
            ns = int(self.grammar.next_state[self.gstate, tok])
            if ns >= 0:
                self.gstate = ns

    def exhausted(self) -> bool:
        """True when the grammar admits nothing from the current state:
        the structured output is complete — the engine finishes the
        request with ``finish_reason="grammar"``."""
        return self.grammar is not None and not self.grammar.live(self.gstate)

    def stop_feed(self, tok: int) -> int:
        return self.stop.feed(tok) if self.stop is not None else 0

    @property
    def stop_pending(self) -> int:
        return self.stop.pending if self.stop is not None else 0


# ---------------------------------------------------------------------------
# device mask-row bookkeeping
# ---------------------------------------------------------------------------

class _MaskEntry:
    __slots__ = ("start", "rows", "n_states", "refs", "last_used")

    def __init__(self, start: int, rows: int, n_states: int):
        self.start = start
        self.rows = rows
        self.n_states = n_states
        self.refs = 0
        self.last_used = 0


class MaskPool:
    """Host bookkeeping for the engine's device mask table rows.

    Row 0 is RESERVED all-zeros (the admit-all row every unconstrained
    slot's state index points at). Grammars allocate ``bucket_for(S)``
    rows (pow2 buckets — the upload program family stays fixed, and a
    bucket's zero-padded tail rows are admit-all rows inside the
    grammar's own allocation, never another grammar's). Entries are
    refcounted and cached across requests by grammar content hash;
    zero-ref entries LRU-evict under pressure. ``acquire`` returning
    None means the grammar cannot fit even after eviction — the caller
    falls back to host-only masking (correct, slower).

    Scheduler-thread-only past engine start (attach at admission,
    release on slot free) — the same single-writer protocol as the KV
    pool's metadata."""

    def __init__(self, rows: int, buckets: Sequence[int]):
        self.rows = int(rows)
        self.buckets = list(buckets)
        self._free: List[Tuple[int, int]] = [(1, self.rows - 1)] \
            if self.rows > 1 else []
        self._resident: Dict[str, _MaskEntry] = {}
        self._tick = 0

    def _alloc(self, n: int) -> Optional[int]:
        for i, (start, size) in enumerate(self._free):
            if size >= n:
                if size == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (start + n, size - n)
                return start
        return None

    def _free_extent(self, start: int, n: int) -> None:
        self._free.append((start, n))
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for s, sz in self._free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((s, sz))
        self._free = merged

    def lookup(self, key: str) -> Optional[int]:
        e = self._resident.get(key)
        return e.start if e is not None else None

    def acquire(self, grammar: CompiledGrammar) -> Tuple[Optional[int], bool]:
        """(first device row, needs_upload) — or (None, False) when the
        grammar cannot fit. ``needs_upload=True`` means the caller must
        upload the mask table into rows [start, start + n_states)."""
        self._tick += 1
        e = self._resident.get(grammar.key)
        if e is not None:
            e.refs += 1
            e.last_used = self._tick
            return e.start, False
        n = grammar.n_states
        if not self.buckets or n > self.buckets[-1]:
            return None, False
        need = next(b for b in self.buckets if b >= n)
        start = self._alloc(need)
        while start is None:
            victims = [k for k, v in self._resident.items() if v.refs == 0]
            if not victims:
                return None, False
            k = min(victims, key=lambda k: self._resident[k].last_used)
            v = self._resident.pop(k)
            self._free_extent(v.start, v.rows)
            start = self._alloc(need)
        e = _MaskEntry(start, need, n)
        e.refs = 1
        e.last_used = self._tick
        self._resident[grammar.key] = e
        return start, True

    def release(self, key: str) -> None:
        e = self._resident.get(key)
        if e is not None and e.refs > 0:
            e.refs -= 1

    def resident_rows(self) -> int:
        return sum(e.rows for e in self._resident.values())

    def stats(self) -> dict:
        return {"rows": self.rows,
                "resident": len(self._resident),
                "resident_rows": self.resident_rows(),
                "free_rows": sum(sz for _s, sz in self._free)}


# ---------------------------------------------------------------------------
# token streaming
# ---------------------------------------------------------------------------

class TokenStream:
    """Thread-safe per-request token event queue — the backing store of
    one SSE response.

    Producer side (the scheduler thread, via `DecodeHandle`): ``push``
    one event per RELEASED token (stop-sequence hold-back happens before
    the push — a live partial match is withheld until it dies or
    completes), ``close`` once with the terminal event. Pushes are
    deduplicated by token INDEX: a supervisor crash-recovery re-decode
    (token-identical by construction) re-emits from index 0, and the
    already-streamed prefix is silently skipped — the client sees each
    token exactly once, across engine restarts.

    Consumer side (the HTTP handler thread): iterate :meth:`events`
    until the terminal event (``{"done": true, ...}`` carrying the final
    token list, ``finish_reason``, ``request_id``, and the per-phase
    ``timings`` breakdown)."""

    def __init__(self):
        self._q: "queue.SimpleQueue[dict]" = queue.SimpleQueue()
        self._sent = 0      # next unstreamed token index (producer only)
        self._closed = False

    @property
    def sent(self) -> int:
        return self._sent

    def push(self, index: int, tok: int) -> None:
        if index < self._sent or self._closed:
            return  # crash-recovery re-emission of an already-sent token
        self._sent = index + 1
        self._q.put({"token": int(tok), "index": int(index)})

    def close(self, handle, error: Optional[BaseException] = None) -> None:
        """Terminal event (exactly once): flush any tokens the hold-back
        withheld (truncation already happened — `handle.tokens` is
        final), then the done record."""
        if self._closed:
            return
        tokens = list(handle.tokens)
        for i in range(self._sent, len(tokens)):
            self._sent = i + 1
            self._q.put({"token": int(tokens[i]), "index": i})
        evt = {"done": True, "request_id": handle.request_id,
               "tokens": tokens,
               "finish_reason": getattr(handle, "finish_reason", None),
               "timings": handle.timings()}
        if error is not None:
            evt["error"] = str(error)
        self._closed = True
        self._q.put(evt)

    def events(self, deadline: Optional[float] = None):
        """Yield events until the terminal one. ``deadline``: absolute
        `time.monotonic` cutoff — expiry raises TimeoutError (the SSE
        writer cancels the request and answers in-band)."""
        while True:
            if deadline is None:
                evt = self._q.get()
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("stream deadline exceeded")
                try:
                    evt = self._q.get(timeout=remaining)
                except queue.Empty:
                    raise TimeoutError("stream deadline exceeded")
            yield evt
            if evt.get("done"):
                return
