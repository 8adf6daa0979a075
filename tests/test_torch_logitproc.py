"""Port parity: the logit processors (stop sequences, penalties, grammar
masks) — the port's host-only copy of `inference/logitproc.py`, the
``allow`` mask of `sample_logits`, and the decode engine and server that
run them.

  - Host cases: every pure case of tests/test_logitproc.py (:89-210,
    :240-300: the stop matcher, the grammar compilers, the exact allow
    mask, the penalties, the mask pool, the token stream) as one
    parametrised test over both copies, the JAX package's and the port's;
    the two copies' compiled grammars are compared table for table.
  - Engine cases (:315, :327, :364, :377, :384, :405, :426): the port's
    `DecodeScheduler(device="cpu")` against the JAX `DecodeScheduler` on
    the same params (`params_from_jax`), the same prompt and the same
    requests: tokens and finish reasons identical. An admit-all grammar
    must be token-identical to unconstrained decode, contiguous and
    paged, greedy and seeded.
  - HTTP cases (:522-595) on a port server.
"""
import http.client
import json
import socket
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import logitproc as jlp
from deeplearning4j_tpu.models import sampling as jsampling
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.inference import logitproc as tlp
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.models import sampling as tsampling
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 29
# token id -> decoded char for the JSON-schema cases (8 structural chars
# + digits + letters = exactly V single-char tokens)
ALPHABET = ('"{}:,[]-' + "0123456789" + "abcdefghijk")[:V]
SCHEMA = {"type": "object", "properties": {
    "a": {"type": "integer", "maxDigits": 2},
    "b": {"type": "string", "maxLength": 3, "charset": "abc"}}}
SAMPLED = {"temperature": 0.9, "seed": 5, "top_k": 8}

COPIES = {
    "jax": types.SimpleNamespace(lp=jlp, sample=jsampling.sample_logits),
    "torch": types.SimpleNamespace(lp=tlp, sample=tsampling.sample_logits)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- host cases, over both copies --------------------------------------------
def _stop_across_boundaries(ns):
    sm = ns.lp.StopMatcher([[5, 6, 7]])
    assert sm.feed(5) == 0 and sm.pending == 1
    assert sm.feed(6) == 0 and sm.pending == 2
    assert sm.feed(7) == 3


def _stop_partial_dies(ns):
    sm = ns.lp.StopMatcher([[5, 6, 7]])
    sm.feed(5)
    sm.feed(6)
    assert sm.pending == 2
    assert sm.feed(9) == 0
    assert sm.pending == 0


def _stop_overlapping_restart(ns):
    sm = ns.lp.StopMatcher([[5, 6]])
    assert sm.feed(5) == 0
    assert sm.feed(5) == 0 and sm.pending == 1
    assert sm.feed(6) == 2


def _stop_longest_wins(ns):
    sm = ns.lp.StopMatcher([[6, 7], [5, 6, 7]])
    sm.feed(5)
    sm.feed(6)
    assert sm.feed(7) == 3


def _stop_rejects_empty(ns):
    with pytest.raises(ValueError):
        ns.lp.StopMatcher([[]])


def _admit_all_zeros(ns):
    g = ns.lp.admit_all(V)
    assert g.n_states == 1 and g.allow.all()
    assert (g.mask_table() == 0.0).all()


def _trie_walk(ns):
    g = ns.lp.compile_trie([[1, 2], [1, 3, 4]], V)
    assert set(np.nonzero(g.allow[0])[0]) == {1}
    s = g.step(0, 1)
    assert set(np.nonzero(g.allow[s])[0]) == {2, 3}
    s2 = g.step(s, 2)
    assert not g.live(s2) and g.accepting[s2]


def _trie_eos(ns):
    g = ns.lp.compile_trie([[1, 2]], V, eos_id=9)
    s = g.step(g.step(0, 1), 2)
    assert g.accepting[s]
    assert set(np.nonzero(g.allow[s])[0]) == {9}


def _json_uncoverable(ns):
    with pytest.raises(ns.lp.GrammarError):
        ns.lp.compile_json_schema({"type": "boolean"}, ALPHABET)


def _json_enum_integer(ns):
    g = ns.lp.compile_json_schema({"enum": [1, 23, 456]}, ALPHABET)
    s = 0
    for ch in "456":
        t = ALPHABET.index(ch)
        assert g.allow[s, t]
        s = g.step(s, t)
    assert not g.live(s)


def _json_unsupported(ns):
    with pytest.raises(ns.lp.GrammarError):
        ns.lp.compile_json_schema({"type": "number"}, ALPHABET)
    with pytest.raises(ns.lp.GrammarError):
        ns.lp.compile_json_schema({"type": "object"}, ALPHABET)


def _allow_exact_and_identity(ns):
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(V)).astype(np.float64)
    allow = np.zeros(V, bool)
    allow[[3, 7, 11]] = True
    for seed in range(50):
        tok = ns.sample(probs, 2.0, None, np.random.default_rng(seed), None,
                        allow=allow)
        assert tok in (3, 7, 11)
    t1 = ns.sample(probs, 0.9, 5, np.random.default_rng(4), 0.9)
    t2 = ns.sample(probs, 0.9, 5, np.random.default_rng(4), 0.9,
                   allow=np.ones(V, bool))
    assert t1 == t2
    # greedy under a mask takes the best allowed token
    assert ns.sample(probs, 0.0, None, None, None, allow=allow) == \
        int(np.where(allow, probs, -1.0).argmax())


def _penalties_suppress(ns):
    st = ns.lp.LogitState(V, repetition_penalty=2.0, frequency_penalty=0.5)
    row = np.full(V, 1e-3)
    row[4] = 0.9
    assert int(st.adjust(row).argmax()) == 4
    for _ in range(6):
        st.advance(4)
    out = st.adjust(row)
    assert out[4] < row[4]
    assert out[5] == row[5]


def _no_penalty_same_object(ns):
    st = ns.lp.LogitState(V, stop=[[1, 2]])
    row = np.full(V, 1.0 / V)
    assert st.adjust(row) is row


def _mask_pool(ns):
    pool = ns.lp.MaskPool(32, [8, 16, 31])
    g1, g2 = ns.lp.compile_trie([[1]], V), ns.lp.compile_trie([[2, 3]], V)
    s1, up1 = pool.acquire(g1)
    assert s1 == 1 and up1
    s1b, up1b = pool.acquire(g1)
    assert s1b == s1 and not up1b
    s2, _ = pool.acquire(g2)
    assert s2 == 9
    pool.release(g1.key)
    pool.release(g1.key)
    pool.release(g2.key)
    big = ns.lp.CompiledGrammar(V, np.ones((40, V), bool),
                                np.zeros((40, V), np.int32),
                                np.ones((40,), bool))
    start, _ = pool.acquire(big)
    assert start is None
    g3 = ns.lp.compile_trie([[4, 5, 6, 7, 8, 9, 10, 11, 12]], V)
    s3, up3 = pool.acquire(g3)
    assert s3 is not None and up3
    g4 = ns.lp.compile_trie([[10, 11, 12, 13, 14, 15, 16, 17, 18]], V)
    s4, _ = pool.acquire(g4)
    assert s4 is None
    pool.release(g3.key)
    s4, up4 = pool.acquire(g4)
    assert s4 is not None and up4


class _H:
    def __init__(self, rid, tokens, finish_reason):
        self.request_id = rid
        self.tokens = tokens
        self.finish_reason = finish_reason

    def timings(self):
        return {"total_ms": 1.0}


def _stream_dedupes(ns):
    ts = ns.lp.TokenStream()
    ts.push(0, 7)
    ts.push(1, 8)
    ts.push(0, 7)
    ts.push(1, 8)
    ts.push(2, 9)
    ts.close(_H("r1", [7, 8, 9], "length"))
    evts = list(ts.events())
    assert [e["token"] for e in evts if not e.get("done")] == [7, 8, 9]
    assert evts[-1]["tokens"] == [7, 8, 9]
    assert evts[-1]["finish_reason"] == "length"


def _stream_close_flushes(ns):
    ts = ns.lp.TokenStream()
    ts.push(0, 1)
    ts.close(_H("r2", [1, 2, 3, 4], None))
    assert [e["token"] for e in ts.events() if not e.get("done")] == \
        [1, 2, 3, 4]


HOST_CASES = {f.__name__.lstrip("_"): f for f in (
    _stop_across_boundaries, _stop_partial_dies, _stop_overlapping_restart,
    _stop_longest_wins, _stop_rejects_empty, _admit_all_zeros, _trie_walk,
    _trie_eos, _json_uncoverable, _json_enum_integer, _json_unsupported,
    _allow_exact_and_identity, _penalties_suppress, _no_penalty_same_object,
    _mask_pool, _stream_dedupes, _stream_close_flushes)}


@pytest.mark.parametrize("copy", sorted(COPIES))
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_case(case, copy):
    HOST_CASES[case](COPIES[copy])


@pytest.mark.parametrize("which", ["admit_all", "trie", "trie_eos",
                                   "json_schema", "json_enum"])
def test_compiled_grammars_equal_across_copies(which):
    """The two copies compile a spec to the same DFA: the same allow rows,
    transitions, accepting states, content key and mask table."""
    def build(lp):
        return {"admit_all": lambda: lp.admit_all(V),
                "trie": lambda: lp.compile_trie([[1, 2], [1, 3, 4]], V),
                "trie_eos": lambda: lp.compile_trie([[3, 1, 4]], V, eos_id=9),
                "json_schema": lambda: lp.compile_json_schema(SCHEMA,
                                                              ALPHABET),
                "json_enum": lambda: lp.compile_json_schema(
                    {"enum": [1, 23, 456]}, ALPHABET)}[which]()
    j, t = build(jlp), build(tlp)
    assert j.n_states == t.n_states and j.key == t.key
    np.testing.assert_array_equal(j.allow, t.allow)
    np.testing.assert_array_equal(j.next_state, t.next_state)
    np.testing.assert_array_equal(j.accepting, t.accepting)
    np.testing.assert_array_equal(j.mask_table(), t.mask_table())


def test_penalised_rows_equal_across_copies():
    rng = np.random.default_rng(1)
    row = rng.dirichlet(np.ones(V))
    toks = rng.integers(0, V, 20)
    states = [lp.LogitState(V, repetition_penalty=1.3, presence_penalty=0.4,
                            frequency_penalty=0.2) for lp in (jlp, tlp)]
    for tok in toks:
        for st in states:
            st.advance(int(tok))
        a, b = (st.adjust(row) for st in states)
        np.testing.assert_array_equal(a, b)


# -- engine cases against the JAX engine -------------------------------------
_NETS = []


def _nets():
    """(JAX LM, port LM) on the JAX params: V 29, d 32, 4 heads, 2 blocks,
    RoPE, max_cache_len 128 (the JAX suite's `_lm`)."""
    if not _NETS:
        conf = jlm(vocab_size=V, d_model=32, n_heads=4, n_blocks=2,
                   rope=True, seed=7)
        for vert in conf.vertices.values():
            layer = getattr(vert, "layer", None)
            if layer is not None and hasattr(layer, "max_cache_len"):
                layer.max_cache_len = 128
        jnet = JGraph(conf).init()
        tnet = TGraph(TConf.from_json(jnet.conf.to_json()),
                      device="cpu").init()
        tnet.set_params(params_from_jax(
            {k: {n: np.asarray(a) for n, a in lp.items()}
             for k, lp in jnet.params.items()}))
        _NETS.append((jnet, tnet))
    return _NETS[0]


@pytest.fixture(scope="module")
def prompt():
    return [int(t) for t in np.random.default_rng(3).integers(0, V, 24)]


# the requests the JAX engine serves once for the whole module: name ->
# (max_new_tokens, submit kwargs)
def _requests():
    trie = jlp.compile_trie([[3, 1, 4]], V)
    schema = jlp.compile_json_schema(SCHEMA, ALPHABET)
    out = {"base": (12, {}), "sampled": (12, SAMPLED),
           "trie": (12, {"grammar": trie}),
           "penalty": (12, {"repetition_penalty": 1.3,
                            "frequency_penalty": 0.2}),
           "penalty_sampled": (12, {"presence_penalty": 0.5, **SAMPLED})}
    for seed in range(3):
        out[f"json{seed}"] = (40, {"grammar": schema, "temperature": 1.0,
                                   "seed": seed})
    return out


@pytest.fixture(scope="module")
def jax_ref(prompt):
    """name -> (tokens, finish_reason) from one JAX engine; the stop case
    is built from the base tokens."""
    jnet, _ = _nets()
    eng = JEngine(jnet, V, n_slots=2, prefill_chunk=16).start()
    out = {}
    try:
        for name, (n, kw) in _requests().items():
            h = eng.generate_handle(prompt, n, timeout=600, **kw)
            out[name] = (h.tokens, h.finish_reason)
        base = out["base"][0]
        h = eng.generate_handle(prompt, 12, timeout=600,
                                stop=[base[3:5]])
        out["stop"] = (h.tokens, h.finish_reason)
    finally:
        eng.stop()
    return out


def _port_kw(kw):
    """A request's kwargs with its grammar recompiled by the port's copy
    (the same DFA, test_compiled_grammars_equal_across_copies)."""
    kw = dict(kw)
    g = kw.get("grammar")
    if g is not None:
        kw["grammar"] = tlp.CompiledGrammar(V, g.allow, g.next_state,
                                            g.accepting)
    return kw


def _run(prompt, new_tokens=12, engine_kw=None, gen_kw=None, warm=False):
    _, tnet = _nets()
    m = MetricsRegistry()
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, metrics=m,
                          device="cpu", **(engine_kw or {}))
    if warm:
        eng.warmup(masks=True)
    eng.start()
    try:
        h = eng.generate_handle(prompt, new_tokens, timeout=600,
                                **_port_kw(gen_kw or {}))
    finally:
        eng.stop()
    return h, m, eng


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_admit_all_identical_greedy_and_sampled(prompt, jax_ref, kv):
    ekw = {"kv_pool_mb": 0.5} if kv == "paged" else {}
    base, _, _ = _run(prompt, engine_kw=ekw)
    assert base.tokens == jax_ref["base"][0]
    masked, m, eng = _run(prompt, engine_kw=ekw,
                          gen_kw={"grammar": tlp.admit_all(V)})
    assert masked.tokens == base.tokens
    assert m.counter("constrained_requests_total").value == 1
    # the masked step ran, within one masked capture per table bucket
    assert eng.masked_steps > 0
    assert 1 <= eng.masked_captures <= (len(eng.table_buckets) or 1)
    s_mask, _, _ = _run(prompt, engine_kw=ekw,
                        gen_kw={"grammar": tlp.admit_all(V), **SAMPLED})
    assert s_mask.tokens == jax_ref["sampled"][0]


def test_admit_all_warmed_masked_family_captures_nothing_new(prompt,
                                                             jax_ref):
    masked, _, eng = _run(prompt, engine_kw={"kv_pool_mb": 0.5},
                          gen_kw={"grammar": tlp.admit_all(V)}, warm=True)
    assert masked.tokens == jax_ref["base"][0]
    assert eng.masked_captures == len(eng.table_buckets)
    assert eng.decode_captures == len(eng.table_buckets)


@pytest.mark.parametrize("rows", [0, 4])
def test_host_only_mask_fallback_is_still_exact(prompt, jax_ref, rows):
    """mask_rows=0: no device table; mask_rows=4: the table exists but a
    trie of more than 3 states does not fit it (a spill, counted). The
    host's exact allow row applies either way."""
    masked, _, eng = _run(prompt, engine_kw={"mask_rows": rows},
                          gen_kw={"grammar": tlp.admit_all(V)})
    assert masked.tokens == jax_ref["base"][0]
    forced, m, eng = _run(prompt, engine_kw={"mask_rows": rows},
                          gen_kw={"grammar": tlp.compile_trie(
                              [[1, 2, 3, 4, 5, 6]], V)})
    assert forced.tokens == [1, 2, 3, 4, 5, 6]
    assert forced.finish_reason == "grammar"
    if rows:
        assert m.counter("grammar_mask_spills_total").value == 1
        assert eng.masked_steps == 0
    else:
        assert eng.maskpool is None


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_trie_grammar_forces_sequence_and_finishes(prompt, jax_ref, kv):
    ekw = {"kv_pool_mb": 0.5} if kv == "paged" else {}
    h, _, eng = _run(prompt, engine_kw=ekw,
                     gen_kw={"grammar": jlp.compile_trie([[3, 1, 4]], V)})
    assert (h.tokens, h.finish_reason) == jax_ref["trie"] \
        == ([3, 1, 4], "grammar")
    assert eng.maskpool.resident_rows() > 0  # cached for the next one
    assert eng.maskpool.stats()["resident"] == 1


def test_stop_sequence_truncates_and_finishes(prompt, jax_ref):
    base = jax_ref["base"][0]
    stop = base[3:5]
    first = next(i for i in range(len(base) - 1) if base[i:i + 2] == stop)
    h, _, _ = _run(prompt, gen_kw={"stop": [stop]})
    assert (h.tokens, h.finish_reason) == jax_ref["stop"] \
        == (base[:first], "stop")


@pytest.mark.parametrize("which", ["penalty", "penalty_sampled"])
def test_penalties_match_jax(prompt, jax_ref, which):
    n, kw = _requests()[which]
    h, _, _ = _run(prompt, n, gen_kw=kw)
    assert (h.tokens, h.finish_reason) == jax_ref[which]


def test_neutral_penalties_change_no_token(prompt, jax_ref):
    h, _, _ = _run(prompt, gen_kw={"repetition_penalty": 1.0,
                                   "presence_penalty": 0.0,
                                   "frequency_penalty": 0.0})
    assert h.tokens == jax_ref["base"][0]


def test_json_schema_completions_parse_and_match_jax(prompt, jax_ref):
    g = tlp.compile_json_schema(SCHEMA, ALPHABET)
    _, tnet = _nets()
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16,
                          metrics=MetricsRegistry(), device="cpu").start()
    try:
        for seed in range(3):
            h = eng.generate_handle(prompt, 40, timeout=600, grammar=g,
                                    temperature=1.0, seed=seed)
            text = "".join(ALPHABET[t] for t in h.tokens)
            obj = json.loads(text)
            assert isinstance(obj["a"], int)
            assert set(obj["b"]) <= set("abc")
            assert h.finish_reason == "grammar"
            assert (h.tokens, h.finish_reason) == jax_ref[f"json{seed}"]
    finally:
        eng.stop()
    # every request released its mask rows; the grammar stays cached
    assert eng.maskpool.stats()["resident"] == 1


def test_streamed_equals_buffered_with_stop_hold_back(prompt, jax_ref):
    base = jax_ref["base"][0]
    _, tnet = _nets()
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16,
                          metrics=MetricsRegistry(), device="cpu").start()
    try:
        ts = tlp.TokenStream()
        eng.submit(prompt, 12, stream=ts)
        evts = list(ts.events(deadline=time.monotonic() + 600))
        toks = [e["token"] for e in evts if not e.get("done")]
        assert toks == evts[-1]["tokens"] == base
        assert evts[-1]["finish_reason"] == "length"
        # a stop sequence: the stream never shows a token of the match
        ts = tlp.TokenStream()
        eng.submit(prompt, 12, stream=ts, stop=[base[3:5]])
        evts = list(ts.events(deadline=time.monotonic() + 600))
        toks = [e["token"] for e in evts if not e.get("done")]
        assert toks == evts[-1]["tokens"] == jax_ref["stop"][0]
        assert evts[-1]["finish_reason"] == "stop"
    finally:
        eng.stop()


def test_grammar_request_preempted_resumes_identically(prompt, jax_ref):
    """A pool too small for two requests preempts one; its grammar rows
    are released and re-acquired on resume, and both finish with the
    tokens of an unpreempted run."""
    _, tnet = _nets()
    bpb = DecodeScheduler(tnet, V, kv_pool_mb=1.0, kv_block=4,
                          device="cpu").pool.bytes_per_block
    # 13 usable blocks of 4: each request needs 9 (24 + 12 positions),
    # both are admitted on their 6 prompt blocks, and decode runs dry
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16,
                          kv_pool_mb=14 * bpb / (1 << 20), kv_block=4,
                          metrics=MetricsRegistry(), device="cpu").start()
    try:
        g = tlp.admit_all(V)
        hs = [eng.submit(prompt, 12, grammar=g) for _ in range(2)]
        toks = [h.result(600) for h in hs]
    finally:
        eng.stop()
    assert toks == [jax_ref["base"][0]] * 2
    assert eng.preemptions > 0
    assert eng.maskpool.stats()["resident_rows"] > 0
    assert eng.pool.outstanding_refs() == 0


# -- HTTP -----------------------------------------------------------------------
def _read_sse(resp):
    buf, events = b"", []
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            line, buf = buf.split(b"\n\n", 1)
            assert line.startswith(b"data: ")
            events.append(json.loads(line[len(b"data: "):]))
    return events


@pytest.fixture(scope="module")
def server():
    _, tnet = _nets()
    srv = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                          prefill_chunk=16, kv_pool_mb=0.5,
                          hang_timeout_s=600, device="cpu").start()
    yield srv
    srv.stop()


def _post_json(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _sse(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/generate",
                 json.dumps({**payload, "stream": True}).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    rid = resp.getheader("X-Request-Id")
    events = _read_sse(resp)
    conn.close()
    return rid, events


def test_http_stream_token_identical_to_buffered(server, prompt, jax_ref):
    base = _post_json(server.port, {"prompt": prompt, "max_new_tokens": 8})
    assert base["tokens"] == jax_ref["base"][0][:8]
    rid, events = _sse(server.port, {"prompt": prompt, "max_new_tokens": 8})
    toks = [e["token"] for e in events if not e.get("done")]
    done = events[-1]
    assert toks == done["tokens"] == base["tokens"]
    assert done["request_id"] == rid
    assert done["finish_reason"] == "length"
    assert set(done["timings"]) >= {"queue_ms", "prefill_ms", "decode_ms",
                                    "total_ms"}
    assert server.metrics.counter("stream_requests_total").value >= 1


def test_http_stream_with_grammar_payload(server, prompt, jax_ref):
    _, events = _sse(server.port, {"prompt": prompt, "max_new_tokens": 8,
                                   "grammar": {"type": "admit_all"}})
    assert events[-1]["tokens"] == jax_ref["base"][0][:8]
    before = server.metrics.counter("grammar_compiles_total").value
    out = _post_json(server.port, {"prompt": prompt, "max_new_tokens": 4,
                                   "grammar": {"type": "admit_all"}})
    assert out["tokens"] == jax_ref["base"][0][:4]
    assert server.metrics.counter("grammar_compiles_total").value == before
    # warmup() built no masked step (no grammar was resident: JAX's
    # rule); each is captured on first use, once per table bucket at most
    eng = server.decoder
    assert eng.decode_captures == len(eng.table_buckets)
    assert 0 < eng.masked_captures <= len(eng.table_buckets)
    assert eng.masked_steps > 0


def test_http_trie_stop_and_penalty_fields(server, prompt, jax_ref):
    out = _post_json(server.port, {
        "prompt": prompt, "max_new_tokens": 12,
        "grammar": {"type": "trie", "sequences": [[3, 1, 4]]}})
    assert (out["tokens"], out["finish_reason"]) == jax_ref["trie"]
    base = jax_ref["base"][0]
    out = _post_json(server.port, {"prompt": prompt, "max_new_tokens": 12,
                                   "stop": base[3:5]})  # one bare sequence
    assert (out["tokens"], out["finish_reason"]) == jax_ref["stop"]
    out = _post_json(server.port, {"prompt": prompt, "max_new_tokens": 12,
                                   "repetition_penalty": 1.3,
                                   "frequency_penalty": 0.2})
    assert out["tokens"] == jax_ref["penalty"][0]


def test_http_bad_grammar_is_400_not_500(server, prompt):
    for spec in ({"type": "nope"},
                 {"type": "json_schema", "schema": {"type": "boolean"},
                  "alphabet": ALPHABET},
                 {"type": "json_schema", "schema": {}},
                 "not an object"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_json(server.port, {"prompt": prompt, "max_new_tokens": 4,
                                     "grammar": spec})
        assert ei.value.code == 400
        ei.value.read()


def test_http_stream_rejects_best_of_n(server, prompt):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(server.port, {"prompt": prompt, "max_new_tokens": 4,
                                 "stream": True, "n": 2})
    assert ei.value.code == 400
    assert "n=1" in json.loads(ei.value.read())["error"]


def test_http_grammar_stream_disconnect_releases_rows(server, prompt):
    """A client hanging up mid-stream under a grammar frees the slot, its
    pins and its mask-row reference."""
    eng = server.decoder
    d0 = server.metrics.counter("stream_disconnects_total").value
    s = socket.create_connection(("127.0.0.1", server.port))
    body = json.dumps({"prompt": prompt, "max_new_tokens": 100,
                       "stream": True,
                       "grammar": {"type": "trie",
                                   "sequences": [[5] * 90]}}).encode()
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              b"Content-Length: " + str(len(body)).encode()
              + b"\r\n\r\n" + body)
    assert b"200" in s.recv(256)
    s.close()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if (server.metrics.counter("stream_disconnects_total").value > d0
                and eng.inflight() == 0):
            break
        time.sleep(0.05)
    assert eng.inflight() == 0
    assert eng.pool.outstanding_refs() == 0
    assert all(e.refs == 0 for e in eng.maskpool._resident.values())
