"""Port parity: the host and disk KV tiers and the /prefix/* directory.

The cases of tests/test_kvtier.py, run on the port's
`inference/kvtier.py` and its tiered `DecodeScheduler(device="cpu")`, and
held against the JAX package where both can run the same thing: chain
hashes, block payload bytes (each package decodes the other's), the
CRC-framed block files, and the tokens of a tiered engine through spill
and promotion — greedy and seeded, fp32 and int8 pages, a host tier and a
host tier over a disk tier — against the JAX `DecodeScheduler` with the
same tiers on the same net (the JAX params carried over by
`params_from_jax`). Faults, the resource ledger, a crash mid-tiering and
the HTTP directory and peer fetch run on the port alone, held against
its solo `generate_transformer`.

Left out, with the ROADMAP items that bring them: the tp2 round trip
(A7), the router routing a repeat to the holder of its prefix (A8), and
the lifecycle registry's tier kinds (A9's `analysis/`).
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.inference import DecodeScheduler as JEngine
from deeplearning4j_tpu.inference import MetricsRegistry as JMetrics
from deeplearning4j_tpu.inference import kvtier as jkv
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.serving import durable as jdurable
from deeplearning4j_tpu_torch.analysis.runtime import resource_ledger
from deeplearning4j_tpu_torch.inference import failpoints
from deeplearning4j_tpu_torch.inference import kvtier as tkv
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.inference.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.serving import durable as tdurable
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

V = 13
B = 8  # kv_block everywhere in this file
SEEDED = dict(temperature=0.8, top_k=5, top_p=0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.disarm()


@pytest.fixture(scope="module")
def nets():
    jnet = JGraph(jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2,
                      rope=True)).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


def _block_bytes(kv=None):
    """One block's bytes: 2 layers x (K, V) x B positions x Hkv=2 x Dh=8
    (int8: plus one f32 scale per position and head)."""
    row = 2 * 8 + 2 * 4 if kv == "int8" else 4 * 2 * 8
    return 2 * 2 * B * row


def _pool_mb(blocks, kv=None):
    return (blocks + 1) * _block_bytes(kv) / float(1 << 20)


def _prompts(seed, n=3, length=41):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, V, length)] for _ in range(n)]


def _settle(eng, timeout=20.0):
    """Wait for the tier worker and the scheduler's tick to drain."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = eng.tier.stats()
        if not any(st["queues"].values()):
            return st
        time.sleep(0.01)
    raise AssertionError(f"tier never drained: {eng.tier.stats()}")


def _tier_waves(eng, prompts, kws):
    """The JAX suite's round trip: all prompts at once (the pool of 12
    blocks evicts), then each again alone, the tier settled between."""
    cold = [eng.submit(p, 6, **kw) for p, kw in zip(prompts, kws)]
    out = [h.result(120) for h in cold]
    _settle(eng)
    for p, kw in zip(prompts, kws):
        out.append(eng.submit(p, 6, **kw).result(120))
        _settle(eng)
    return out


def _fake_pages(seed):
    g = torch.Generator().manual_seed(seed)
    return {"layer0": {"k_pages": torch.randn((2, B, 4), generator=g),
                       "v_pages": torch.randn((2, B, 4), generator=g)}}


def _counter(eng, name):
    return eng.metrics.counter(name).value


# --------------------------------------------- hashes, payloads, files --
def test_chain_hashes_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        toks = [int(t) for t in rng.integers(0, 1 << 20, 4 * B + 3)]
        assert tkv.prompt_chain(toks, B) == jkv.prompt_chain(toks, B)
        assert tkv.prompt_chain(toks, B, 2) == jkv.prompt_chain(toks, B, 2)
    k1, k2 = (1, 2, 3), (4, 5, 6)
    h1 = tkv.chain_hash("", k1)
    assert h1 == jkv.chain_hash("", k1) != tkv.chain_hash("", k2)
    assert tkv.chain_hash(h1, k2) != tkv.chain_hash("", k2)
    # only full blocks hash
    assert tkv.prompt_chain([1, 2, 3, 4], 3) == [h1]


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_block_payload_bytes_equal_jax_and_decode_both_ways(kind):
    """`encode_block` gives the JAX package's bytes for the same rows, and
    each package decodes the other's payload to the same rows."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal((B, 2, 8)).astype(np.float32)
    if kind == "int8":
        jrows = {"k_pages": rng.integers(-127, 128, (B, 2, 8)).astype(
                     np.int8),
                 "k_scales": rng.random((B, 2)).astype(np.float32)}
        trows = {k: torch.from_numpy(a.copy()) for k, a in jrows.items()}
    elif kind == "bfloat16":
        import ml_dtypes
        jrows = {"k_pages": f.astype(ml_dtypes.bfloat16)}
        trows = {"k_pages": torch.from_numpy(f).to(torch.bfloat16)}
    else:
        jrows = {"k_pages": f}
        trows = {"k_pages": torch.from_numpy(f.copy())}
    key = tuple(range(B))
    h = tkv.chain_hash("", key)
    je = jkv.TierEntry(h, "", key, 1, key, "host")
    te = tkv.TierEntry(h, "", key, 1, key, "host")
    jpay = jkv.encode_block(je, {"attn0": jrows})
    tpay = tkv.encode_block(te, {"attn0": trows})
    assert tpay == jpay
    meta, pages = tkv.decode_block(jpay)
    assert meta == {"hash": h, "parent": "", "depth": 1,
                    "prefix": list(key)}
    jmeta, jpages = jkv.decode_block(tpay)
    assert jmeta == meta
    for pk, a in trows.items():
        got = pages["attn0"][pk]
        assert got.dtype == a.dtype and torch.equal(got, a)
        back = jpages["attn0"][pk]
        assert back.tobytes() == np.asarray(jrows[pk]).tobytes()


def test_block_payload_corruption_is_a_miss():
    e = tkv.TierEntry(tkv.chain_hash("", (1, 2)), "", (1, 2), 1, (1, 2),
                      "host")
    payload = tkv.encode_block(e, _fake_pages(3))
    meta, out = tkv.decode_block(payload)
    assert meta["hash"] == e.hash and meta["prefix"] == [1, 2]
    assert torch.equal(out["layer0"]["k_pages"],
                       _fake_pages(3)["layer0"]["k_pages"])
    assert tkv.decode_block(payload[:-3]) is None          # truncated
    assert tkv.decode_block(b"garbage" + payload) is None  # bad frame
    doc = json.loads(payload)
    doc["pages"]["layer0"]["k_pages"]["shape"] = [3, B, 4]  # wrong size
    assert tkv.decode_block(json.dumps(doc).encode()) is None
    doc["pages"]["layer0"]["k_pages"]["dtype"] = "complex64"
    assert tkv.decode_block(json.dumps(doc).encode()) is None


def test_block_files_read_both_ways_and_torn_file_is_a_miss(tmp_path):
    payload = b"x" * 1000 + bytes(range(256))
    tdurable.write_block_file(str(tmp_path / "t.kvb"), payload)
    jdurable.write_block_file(str(tmp_path / "j.kvb"), payload)
    assert (tmp_path / "t.kvb").read_bytes() == \
        (tmp_path / "j.kvb").read_bytes()
    assert jdurable.read_block_file(str(tmp_path / "t.kvb")) == payload
    assert tdurable.read_block_file(str(tmp_path / "j.kvb")) == payload
    raw = (tmp_path / "t.kvb").read_bytes()
    (tmp_path / "t.kvb").write_bytes(raw[:-5])
    assert tdurable.read_block_file(str(tmp_path / "t.kvb")) is None
    flipped = bytearray(raw)
    flipped[-1] ^= 1
    (tmp_path / "t.kvb").write_bytes(bytes(flipped))
    assert tdurable.read_block_file(str(tmp_path / "t.kvb")) is None
    assert tdurable.read_block_file(str(tmp_path / "none.kvb")) is None


# ------------------------------------------- TierManager standalone -----
def test_tier_manager_spill_lookup_restore_cycle():
    tm = tkv.TierManager(host_bytes=1 << 20, metrics=MetricsRegistry())
    try:
        toks = list(range(2 * B))
        chain = tkv.prompt_chain(toks, B)
        tm.attach_engine(lambda bid: _fake_pages(bid), 2 * B * 4 * 4, B)
        tm.note_resident(chain[0], "", tuple(toks[:B]))
        tm.note_resident(chain[1], chain[0], tuple(toks[B:]))
        tm.offer_spill(chain[0], 1)
        tm.offer_spill(chain[1], 2)
        tm.pace(1 << 20)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if tm.stats()["host"]["blocks"] == 2:
                break
            time.sleep(0.01)
        assert tm.stats()["host"]["blocks"] == 2
        # the spilled chain is visible to admission-time lookups
        assert tm.lookup_extension("", toks, 0, 8) == chain
        assert tm.request_restore(chain) == 2
        tm.pace(1 << 20)
        got = []
        deadline = time.monotonic() + 5
        while len(got) < 2 and time.monotonic() < deadline:
            got.extend(tm.drain_ready(1 << 20))
            time.sleep(0.01)
        # chain order: the parent integrates before the child
        assert [e.hash for e, _ in got] == chain
        assert torch.equal(got[0][1]["layer0"]["k_pages"],
                           _fake_pages(1)["layer0"]["k_pages"])
        for h in chain:
            tm.promotion_done(h, True)
    finally:
        tm.stop()  # the ledger check inside


def test_host_ring_lru_demotes_to_disk_and_torn_file_is_a_miss(tmp_path):
    """Host overflow demotes the LRU block to a CRC-framed file; a torn
    file is a miss (the entry dropped, restore_failed counted), never bad
    rows."""
    m = MetricsRegistry()
    nbytes = sum(a.nbytes for lk in _fake_pages(0).values()
                 for a in lk.values())
    tm = tkv.TierManager(host_bytes=nbytes + 16, disk_bytes=1 << 20,
                         disk_dir=str(tmp_path), metrics=m)
    try:
        toks = list(range(2 * B))
        chain = tkv.prompt_chain(toks, B)
        tm.attach_engine(lambda bid: _fake_pages(bid), nbytes, B)
        tm.note_resident(chain[0], "", tuple(toks[:B]))
        tm.note_resident(chain[1], chain[0], tuple(toks[B:]))
        tm.pace(1 << 20)
        tm.offer_spill(chain[0], 1)
        tm.offer_spill(chain[1], 2)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            st = tm.stats()
            if st["disk"]["blocks"] == 1 and st["host"]["blocks"] == 1:
                break
            time.sleep(0.01)
        st = tm.stats()
        assert (st["host"]["blocks"], st["disk"]["blocks"]) == (1, 1)
        assert m.counter("kv_tier_demoted_disk_blocks_total").value == 1
        files = list(tmp_path.glob("*.kvb"))
        assert len(files) == 1
        # the file decodes in the JAX package too
        meta, _ = jkv.decode_block(jdurable.read_block_file(str(files[0])))
        assert meta["hash"] in chain
        files[0].write_bytes(files[0].read_bytes()[:-5])
        tm.request_restore(chain)
        tm.pace(1 << 20)
        deadline = time.monotonic() + 5
        got = []
        while time.monotonic() < deadline:
            got.extend(tm.drain_ready(1 << 20))
            if m.counter("kv_tier_restore_failed_total").value:
                break
            time.sleep(0.01)
        assert m.counter("kv_tier_restore_failed_total").value >= 1
        assert all(e.hash in chain for e, _ in got)
        for e, _ in got:
            tm.promotion_done(e.hash, True)
    finally:
        tm.stop(check=False)  # the torn file's drop released its ledger


def test_publish_fault_drops_the_event_not_the_state():
    m = MetricsRegistry()
    tm = tkv.TierManager(host_bytes=1 << 20, metrics=m)
    failpoints.arm("directory.publish", "crash@always")
    try:
        h = tkv.chain_hash("", tuple(range(B)))
        tm.note_resident(h, "", tuple(range(B)))
        assert m.counter("kv_tier_publish_dropped_total").value >= 1
        assert tm.directory_feed(0)["events"] == [] or all(
            ev["hash"] == h for ev in tm.directory_feed(0)["events"])
        assert tm.holds(h)  # the entry survived its lost event
    finally:
        failpoints.disarm()
        tm.stop(check=False)


# ------------------------------------- engine round trip against JAX ----
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("disk", [False, True], ids=["host", "host+disk"])
def test_tiered_engine_tokens_equal_jax(nets, kv, disk, tmp_path):
    """Prompts evicted under pool pressure come back through the tiers:
    every token, greedy and seeded, equals the JAX `DecodeScheduler`'s
    with the same tiers (fp32: and the port's solo decode), and the
    repeats are served by promotions — from the host ring, or (host ring
    of two blocks) from the disk tier."""
    jnet, tnet = nets
    prompts = _prompts(5)
    kws = [{}, dict(SEEDED, seed=11), dict(SEEDED, seed=12)]
    host_mb = (2 * _block_bytes(kv) + 16) / float(1 << 20) if disk else 4.0
    tiers = dict(host_cache_mb=host_mb,
                 disk_cache_mb=1.0 if disk else 0.0)
    jeng = JEngine(jnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                   kv_pool_mb=_pool_mb(12, kv), kv_dtype=kv,
                   paged_kernel="off", metrics=JMetrics(),
                   tier_dir=str(tmp_path / "jax") if disk else None,
                   **tiers).start()
    try:
        want = _tier_waves(jeng, prompts, kws)
    finally:
        jeng.stop()
    teng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                           kv_pool_mb=_pool_mb(12, kv), kv_dtype=kv,
                           metrics=MetricsRegistry(), device="cpu",
                           tier_dir=str(tmp_path / "port") if disk else None,
                           **tiers).start()
    assert teng.pool.capacity_blocks == jeng.pool.capacity_blocks == 12
    try:
        got = _tier_waves(teng, prompts, kws)
        c = teng.metrics.snapshot()["counters"]
    finally:
        teng.stop()
    assert got == want
    if kv is None:
        solo = [generate_transformer(tnet, p, 6, V, use_cache=True, **kw)
                for p, kw in zip(prompts, kws)]
        assert got == solo + solo
    assert c["kv_tier_spilled_blocks_total"] > 0
    assert c["kv_tier_promoted_blocks_total"] > 0
    assert c["kv_tier_restore_failed_total"] == 0
    assert c["kv_tier_hits_disk_total" if disk
             else "kv_tier_hits_host_total"] > 0
    if disk:
        assert c["kv_tier_demoted_disk_blocks_total"] > 0
    assert teng.pool.outstanding_refs() == 0


def test_promoted_rows_equal_the_spilled_rows(nets):
    """Bit for bit: a promoted page holds exactly the rows its block
    spilled (read from the host ring after the promotion)."""
    _, tnet = nets
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                          kv_pool_mb=_pool_mb(12), host_cache_mb=4.0,
                          metrics=MetricsRegistry(), device="cpu").start()
    try:
        prompts = _prompts(7)
        _tier_waves(eng, prompts, [{}] * 3)
        assert eng.promoted_blocks > 0
        checked = 0
        for node in list(eng.pool._walk()):
            rows = eng.tier.host_rows(node.hash)
            if rows is None:
                continue
            for lk, pks in rows.items():
                for pk, a in pks.items():
                    assert torch.equal(eng._states[lk][pk][node.block_id], a)
            checked += 1
        assert checked > 0
    finally:
        eng.stop()


def test_promotion_into_a_full_pool_keeps_its_parents_page(nets):
    """The promoted block's parent is the full pool's only unpinned leaf:
    the promotion finds no page (the parent keeps its page and rows, no
    page is held twice), and the chain, promoted once pages are free,
    gives the solo tokens."""
    _, tnet = nets
    prompt = _prompts(11, n=1)[0]
    solo = generate_transformer(tnet, prompt, 6, V, use_cache=True)
    src = _engine(tnet)
    try:
        assert src.submit(prompt, 6).result(120) == solo
        _settle(src)
        _, ids = src.pool._walk_prefix(prompt, len(prompt) // B)
        assert len(ids) >= 2
        chain = [{lk: {pk: pages[bid].clone() for pk, pages in st.items()}
                  for lk, st in src._states.items()} for bid in ids]
    finally:
        src.stop()
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                          kv_pool_mb=_pool_mb(8), host_cache_mb=4.0,
                          metrics=MetricsRegistry(), device="cpu")
    pool = eng.pool
    held = [pool.alloc() for _ in range(pool.capacity_blocks)]
    assert None not in held and pool.free_blocks == 0
    parent_page = held.pop(0)
    for lk, pks in chain[0].items():
        for pk, a in pks.items():
            eng._states[lk][pk][parent_page].copy_(a)
    pool.adopt(prompt[:B], [parent_page])

    def entry(depth):
        hashes = tkv.prompt_chain(prompt, B, depth)
        return tkv.TierEntry(
            hash=hashes[-1], parent=hashes[-2] if depth > 1 else "",
            key=tuple(prompt[(depth - 1) * B:depth * B]), depth=depth,
            prefix=tuple(prompt[:depth * B]), tier="host")

    def pages_owned_once():
        nodes = [n.block_id for n in pool._walk()]
        owned = nodes + pool._free + held
        assert len(owned) == len(set(owned)) == pool.capacity_blocks
        return nodes

    try:
        assert not eng._integrate_promotion(entry(2), chain[1])
        assert pages_owned_once() == [parent_page]
        for lk, pks in chain[0].items():
            for pk, a in pks.items():
                assert torch.equal(eng._states[lk][pk][parent_page], a)
        assert _counter(eng, "kv_tier_restore_failed_total") == 1
        for bid in held:
            pool.free_block(bid)
        held.clear()
        for depth in range(2, len(chain) + 1):
            assert eng._integrate_promotion(entry(depth), chain[depth - 1])
        assert len(pages_owned_once()) == len(chain)
        eng.start()
        assert eng.submit(prompt, 6).result(120) == solo
        assert pool.hit_blocks >= len(chain)
    finally:
        eng.stop()


def test_promotion_whose_copy_raises_frees_its_page(nets, monkeypatch):
    """A promotion whose row copy raises returns its page to the free
    list, counts a failed restore, and re-raises."""
    _, tnet = nets
    prompt = _prompts(11, n=1)[0]
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                          kv_pool_mb=_pool_mb(8), host_cache_mb=4.0,
                          metrics=MetricsRegistry(), device="cpu")
    try:
        rows = {lk: {pk: pages[1].clone() for pk, pages in st.items()}
                for lk, st in eng._states.items()}
        h = tkv.prompt_chain(prompt, B, 1)[0]
        entry = tkv.TierEntry(hash=h, parent="", key=tuple(prompt[:B]),
                              depth=1, prefix=tuple(prompt[:B]),
                              tier="host")
        free = eng.pool.free_blocks

        def fail(*a, **k):
            raise RuntimeError("copy failed")

        monkeypatch.setattr(torch, "_foreach_copy_", fail)
        with pytest.raises(RuntimeError, match="copy failed"):
            eng._integrate_promotion(entry, rows)
        assert eng.pool.free_blocks == free
        assert not list(eng.pool._walk())
        assert _counter(eng, "kv_tier_restore_failed_total") == 1
    finally:
        eng.tier.stop()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_spill_batch_moves_each_blocks_rows(nets, kv):
    """The worker moves a batch of staged blocks as one stack per dtype
    and shape; each block comes back with its own rows."""
    _, tnet = nets
    eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                          kv_pool_mb=_pool_mb(12, kv), kv_dtype=kv,
                          host_cache_mb=4.0, metrics=MetricsRegistry(),
                          device="cpu")
    try:
        g = torch.Generator().manual_seed(0)
        for st in eng._states.values():
            for pages in st.values():
                pages.copy_((torch.randn(pages.shape, generator=g) * 50)
                            .to(pages.dtype))
        staged = [eng._tier_capture(bid) for bid in (3, 1, 7)]
        assert len(staged[0].groups) == (2 if kv else 1)
        moved = eng.tier._to_host(staged)
        for bid, rows in zip((3, 1, 7), moved):
            assert set(rows) == set(eng._states)
            for lk, st in eng._states.items():
                assert set(rows[lk]) == set(st)
                for pk, pages in st.items():
                    assert torch.equal(rows[lk][pk], pages[bid])
    finally:
        eng.tier.stop()


def test_contiguous_engine_warns_and_stays_tierless(nets):
    _, tnet = nets
    with pytest.warns(RuntimeWarning, match="KV tiering needs the paged"):
        eng = DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16,
                              host_cache_mb=4.0, metrics=MetricsRegistry(),
                              device="cpu")
    assert eng.tier is None and not eng.paged


# ------------------------------------------------- failure injection ----
def _engine(tnet, **kw):
    return DecodeScheduler(tnet, V, n_slots=2, prefill_chunk=16, kv_block=B,
                           kv_pool_mb=_pool_mb(12), host_cache_mb=4.0,
                           metrics=MetricsRegistry(), device="cpu",
                           **kw).start()


def test_spill_fault_degrades_to_cold_prefill_token_identical(nets):
    """tier.spill crash@always loses the spill, never a token."""
    _, tnet = nets
    prompts = _prompts(9)
    solo = [generate_transformer(tnet, p, 6, V, use_cache=True)
            for p in prompts]
    eng = _engine(tnet)
    failpoints.arm("tier.spill", "crash@always")
    try:
        outs = [eng.submit(p, 6).result(120) for p in prompts + prompts]
        assert outs == solo + solo
        assert _counter(eng, "kv_tier_spill_dropped_total") > 0
        assert _counter(eng, "kv_tier_spilled_blocks_total") == 0
    finally:
        failpoints.disarm()
        eng.stop()


def test_restore_fault_degrades_to_cold_prefill_token_identical(nets):
    """tier.restore crash@always (the worker's seam) counts a failed
    restore and the request prefills cold: the same tokens."""
    _, tnet = nets
    prompts = _prompts(9)
    solo = [generate_transformer(tnet, p, 6, V, use_cache=True)
            for p in prompts]
    eng = _engine(tnet)
    try:
        assert [eng.submit(p, 6).result(120) for p in prompts] == solo
        _settle(eng)
        failpoints.arm("tier.restore", "crash@always")
        try:
            outs = [eng.submit(p, 6).result(120) for p in prompts]
        finally:
            failpoints.disarm()
        assert outs == solo
        assert _counter(eng, "kv_tier_restore_failed_total") > 0
        assert _counter(eng, "kv_tier_promoted_blocks_total") == 0
    finally:
        eng.stop()


def test_tier_ledger_balances_spill_restore_free(nets):
    """Every host_page / directory_entry acquired through spill, promote
    and stop is released."""
    _, tnet = nets
    prompts = _prompts(5)
    with resource_ledger() as led:
        eng = _engine(tnet)
        try:
            for p in prompts + prompts:
                eng.submit(p, 6).result(120)
                _settle(eng)
            assert _counter(eng, "kv_tier_promoted_blocks_total") > 0
        finally:
            eng.stop()
        kinds = led.observed_kinds()
    led.assert_clean()
    assert {"host_page", "directory_entry"} <= kinds


# ------------------------------------------------------ HTTP surfaces ---
def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read()


def _post(port, path, obj, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _server(tnet, **kw):
    return InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                           prefill_chunk=16, kv_block=B,
                           kv_pool_mb=_pool_mb(12), host_cache_mb=4.0,
                           device="cpu", **kw).start()


def test_engine_crash_mid_tiering_recovers_token_identical(nets):
    """A supervised, tiered server crashed by the decode seam is fenced
    (its tier stopped unchecked), rebuilt tiered, and every request
    replays token-identically."""
    _, tnet = nets
    prompts = _prompts(13)
    expected = [generate_transformer(tnet, p, 6, V, use_cache=True)
                for p in prompts]
    srv = _server(tnet, hang_timeout_s=10.0, retry_budget=6)
    srv.supervisor.poll_interval_s = 0.02
    srv.supervisor.backoff_base_s = 0.01
    srv.supervisor.backoff_max_s = 0.1
    try:
        first = srv.decoder
        assert first.tier is not None
        assert [_post(srv.port, "/generate", {"prompt": p,
                                              "max_new_tokens": 6})["tokens"]
                for p in prompts] == expected
        failpoints.arm("dispatch.decode", "crash@once")
        try:
            got = [_post(srv.port, "/generate",
                         {"prompt": p, "max_new_tokens": 6})["tokens"]
                   for p in prompts]
        finally:
            failpoints.disarm()
        assert got == expected
        assert srv.supervisor.restarts >= 1
        assert srv.decoder is not first and srv.decoder.tier is not None
        assert first.tier._stopped
    finally:
        srv.stop()


def test_cross_replica_fetch_restores_with_zero_recompute(nets):
    """A prefix computed on server A is pulled by server B through
    POST /prefix/fetch -> GET /prefix/block: B prefills only the tail
    past the last full block, and emits A's tokens."""
    _, tnet = nets
    prompt = _prompts(3, n=1)[0]
    a, b = _server(tnet, supervise=False), _server(tnet, supervise=False)
    try:
        ra = _post(a.port, "/generate", {"prompt": prompt,
                                         "max_new_tokens": 6})
        feed = json.loads(_get(a.port, "/prefix/directory?since=0"))
        assert feed["reset"] and feed["events"]
        hashes = [e["hash"] for e in sorted(feed["events"],
                                            key=lambda e: e["depth"])]
        assert hashes == tkv.prompt_chain(prompt, B)  # 5 full blocks
        meta, _ = tkv.decode_block(
            _get(a.port, f"/prefix/block?hash={hashes[0]}"))
        assert meta["hash"] == hashes[0]
        res = _post(b.port, "/prefix/fetch",
                    {"peer": f"http://127.0.0.1:{a.port}",
                     "hashes": hashes})
        assert res["fetched"] == len(hashes) and res["failed"] == 0
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            snap = json.loads(_get(b.port, "/debug/engine"))
            mets = json.loads(_get(b.port, "/metrics"))
            promoted = mets["counters"].get(
                "kv_tier_promoted_blocks_total", 0)
            if promoted >= len(hashes) and not any(
                    snap["tier"]["queues"].values()):
                break
            time.sleep(0.05)
        assert promoted == len(hashes), (promoted, snap["tier"])
        pre0 = mets["counters"]["prefill_tokens_total"]
        rb = _post(b.port, "/generate", {"prompt": prompt,
                                         "max_new_tokens": 6})
        assert rb["tokens"] == ra["tokens"]
        mets = json.loads(_get(b.port, "/metrics"))
        prefilled = mets["counters"]["prefill_tokens_total"] - pre0
        assert prefilled <= len(prompt) - len(hashes) * B + 1, prefilled
    finally:
        a.stop()
        b.stop()


def test_fetch_endpoint_validates_and_skips_held_blocks(nets):
    _, tnet = nets
    prompt = _prompts(3, n=1)[0]
    a, b = _server(tnet, supervise=False), _server(tnet, supervise=False)
    try:
        _post(a.port, "/generate", {"prompt": prompt, "max_new_tokens": 4})
        feed = json.loads(_get(a.port, "/prefix/directory?since=0"))
        hashes = [e["hash"] for e in sorted(feed["events"],
                                            key=lambda e: e["depth"])]
        peer = f"http://127.0.0.1:{a.port}"
        first = _post(b.port, "/prefix/fetch", {"peer": peer,
                                                "hashes": hashes})
        assert first["fetched"] == len(hashes)
        again = _post(b.port, "/prefix/fetch", {"peer": peer,
                                                "hashes": hashes})
        assert again["skipped"] == len(hashes) and again["fetched"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(b.port, "/prefix/fetch", {"hashes": hashes})
        assert ei.value.code == 400
        bad = _post(b.port, "/prefix/fetch", {"peer": peer,
                                              "hashes": ["deadbeef"]})
        assert bad["failed"] == 1 and bad["fetched"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(a.port, "/prefix/block?hash=deadbeef", timeout=30)
        assert ei.value.code == 404
    finally:
        a.stop()
        b.stop()


def test_directory_feed_cursor_tailing_and_404_without_tiers(nets):
    _, tnet = nets
    a = _server(tnet, supervise=False)
    plain = InferenceServer(net=tnet, decode_vocab=V, decode_slots=2,
                            prefill_chunk=16, kv_block=B,
                            kv_pool_mb=_pool_mb(12), supervise=False,
                            device="cpu").start()
    try:
        for path in ("/prefix/directory", "/prefix/block?hash=x"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(plain.port, path)
            assert ei.value.code == 404
        p1 = _prompts(1, n=1, length=17)[0]
        _post(a.port, "/generate", {"prompt": p1, "max_new_tokens": 4})
        feed = json.loads(_get(a.port, "/prefix/directory?since=0"))
        assert feed["reset"]
        cur = feed["next"]
        feed2 = json.loads(_get(a.port, f"/prefix/directory?since={cur}"))
        assert not feed2["reset"] and feed2["events"] == []
        p2 = _prompts(2, n=1, length=17)[0]
        _post(a.port, "/generate", {"prompt": p2, "max_new_tokens": 4})
        feed3 = json.loads(_get(a.port, f"/prefix/directory?since={cur}"))
        assert feed3["events"] and not feed3["reset"]
        assert all(ev["seq"] > cur for ev in feed3["events"])
        assert feed3["epoch"] == feed["epoch"]
    finally:
        a.stop()
        plain.stop()
