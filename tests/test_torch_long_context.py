"""Port parity: the long-context mechanisms — remat, the contiguous KV
cache, `rnn_time_step`, cached generation and the ported example.

Inputs and params are made with numpy (or by the JAX package) from a seed
and carried to the port (`params_from_jax` for graphs). The JAX side runs
its dense default attention, the port its attention seam's plain versions
(CPU tensors).

Tolerances (f32):
  - remat on against remat off in the port: the same bits (the same ops
    on the same inputs, recomputed), dropout masks included; AlexNet,
    whose remat run leaves its BN+pool pairs unfused as JAX does, within
    1e-5 x max |gradient| of each layer against the fused run;
  - remat on against JAX remat on: test_torch_graph_train.py's, loss
    rtol 1e-6, every gradient within 1e-4 x max |JAX gradient|;
  - the KV step, `rnn_time_step` and the full forward against JAX:
    max |diff| <= 2e-5 (tests/test_kv_cache.py's atol 2e-6 scaled to
    outputs of up to ~10), caches and positions exact where only copies
    happen;
  - tokens: identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.sampling import generate_transformer as jgen
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf.layers import \
    SelfAttentionLayer as JAttnConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers.attention import \
    SelfAttentionLayerImpl as JAttn
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
from deeplearning4j_tpu_torch.models.zoo import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, OutputLayer,
                                                      SelfAttentionLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.layers.attention import \
    SelfAttentionLayerImpl
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as tms

V, T, B = 11, 9, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm_kw(n_blocks=1):
    return dict(vocab_size=V, d_model=32, n_heads=4, n_blocks=n_blocks,
                rope=True, n_kv_heads=2)


def _set_cache(conf, cache):
    for vert in conf.vertices.values():
        layer = getattr(vert, "layer", None)
        if layer is not None and hasattr(layer, "max_cache_len"):
            layer.max_cache_len = cache
    return conf


def _pair(remat=False, cache=1024):
    """(JAX graph, port graph on the CPU with the JAX graph's params): a
    tiny transformer_lm with RoPE and GQA (4 heads over 2 KV heads)."""
    jconf = _set_cache(jlm(**_lm_kw()), cache)
    jconf.conf.remat = remat
    jnet = JGraph(jconf).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


def _batch(seed, n=B, t=T):
    ids = np.random.default_rng(seed).integers(0, V, (n, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _grads_equal(a, b):
    for name in a:
        for p in a[name]:
            assert torch.equal(a[name][p], b[name][p]), f"{name}.{p}"


# -- remat ---------------------------------------------------------------------

def test_graph_remat_gives_the_same_bits():
    x, y = _batch(1)
    runs = []
    for remat in (False, True):
        conf = tlm(**_lm_kw(n_blocks=2))
        conf.conf.remat = remat
        net = TGraph(conf, device="cpu").init()
        loss, grads = net.compute_gradient_and_score([x], [y])
        net.fit([x], [y])
        runs.append((loss, grads, net.params_flat()))
    (l0, g0, p0), (l1, g1, p1) = runs
    assert torch.equal(l0, l1)
    _grads_equal(g0, g1)
    np.testing.assert_array_equal(p0, p1)


def test_graph_remat_recomputes_each_layer_in_the_backward():
    """Under remat the backward runs each checkpointed layer's forward
    again: the attention seam is entered twice per attention layer."""
    x, y = _batch(2)
    from deeplearning4j_tpu_torch.ops import helpers
    for remat, want in ((False, 2), (True, 4)):
        conf = tlm(**_lm_kw(n_blocks=2))
        conf.conf.remat = remat
        net = TGraph(conf, device="cpu").init()
        calls = []

        def spy(q, k, v, *, causal, scale):
            calls.append(q.shape)
            return helpers.attention_plain(q, k, v, causal=causal,
                                           scale=scale)
        helpers.register_helper("attention", spy)
        try:
            net.compute_gradient_and_score([x], [y])
        finally:
            helpers.register_helper("attention", None)
        assert len(calls) == want


def _mlp_with_dropout(remat):
    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(0.05)
            .remat(remat).list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="relu"))
            .layer(DenseLayer(n_in=16, n_out=16, activation="tanh",
                              dropout=0.5))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_multilayer_remat_replays_dropout_and_gives_the_same_bits():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    runs = []
    for remat in (False, True):
        net = _mlp_with_dropout(remat)
        loss, grads, _ = net.compute_gradient_and_score(x, y)
        for _ in range(2):
            net.fit_batch(x, y)
        runs.append((loss, grads, net.params_flat(), net._gen.get_state()))
    (l0, g0, p0, s0), (l1, g1, p1, s1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(p0, p1)
    # the replay rewinds and restores the generator: it ends where the
    # run without remat leaves it
    assert torch.equal(s0, s1)


def test_alexnet_remat_replays_its_dropout_mask():
    """AlexNet's Dense 512 with dropout 0.5 under remat: the recomputed
    forward draws the forward's mask, so the gradients agree with the run
    without remat (whose BN+pool pairs are fused, hence a tolerance), and
    the generator ends where that run leaves it."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 2)]
    runs = []
    for remat in (False, True):
        conf = alexnet_cifar10()
        conf.conf.remat = remat
        net = MultiLayerNetwork(conf, device="cpu").init()
        loss, grads, _ = net.compute_gradient_and_score(x, y)
        runs.append((loss, grads, net._gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(s0, s1)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for i, (a, b) in enumerate(zip(g0, g1)):
        # per layer: a conv bias that feeds a BatchNorm has an exact zero
        # gradient, so both runs hold only rounding there
        scale = max([float(t.abs().max()) for t in a.values()] + [1e-30])
        for k in a:
            assert float((a[k] - b[k]).abs().max()) <= 1e-5 * scale, (i, k)


def test_graph_remat_matches_jax_remat():
    jnet, tnet = _pair(remat=True)
    assert tnet.conf.conf.remat
    x, y = _batch(6)
    loss_fn = jnet._build_loss_fn()
    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jnet.params, jnet.variables, [jnp.asarray(x)], [jnp.asarray(y)],
        None, None, jax.random.PRNGKey(0))
    tl, tg = tnet.compute_gradient_and_score([x], [y])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for name in jg:
        for p in jg[name]:
            want = np.asarray(jg[name][p])
            got = tg[name][p].numpy()
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
                f"{name}.{p}"


# -- the contiguous KV step ----------------------------------------------------

def _attn_pair(cap=12, n_kv_heads=2):
    kw = dict(n_in=8, n_out=8, n_heads=4, causal=True, rope=True,
              n_kv_heads=n_kv_heads, activation="identity",
              max_cache_len=cap)
    jimpl = JAttn(JAttnConf(**kw))
    jp = jimpl.init_params(jax.random.PRNGKey(0))
    timpl = SelfAttentionLayerImpl(SelfAttentionLayer(**kw))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jimpl, jp, timpl, tp


def _x(seed, b, t):
    return np.random.default_rng(seed).normal(size=(b, t, 8)).astype(
        np.float32)


def _close_state(tstate, jstate):
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("chunks", [(1, 1, 1), (4, 1, 3)],
                         ids=["decode", "prefill_chunk"])
def test_kv_step_scalar_position_matches_jax(chunks):
    jimpl, jp, timpl, tp = _attn_pair()
    js, ts = jimpl.init_state(2), timpl.init_state(2)
    assert ts["k"].shape == (2, 12, 2, 2) and ts["pos"].dim() == 0
    for i, t in enumerate(chunks):
        x = _x(10 + i, 2, t)
        jy, js = jimpl.forward_with_state(jp, jnp.asarray(x), js)
        ty, ts = timpl.forward_with_state(tp, torch.from_numpy(x), ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=2e-5)
        _close_state(ts, js)
    assert int(ts["pos"]) == sum(chunks)


@pytest.mark.parametrize("t", [1, 3])
def test_kv_step_per_row_positions_match_jax(t):
    """Slot-style [B] positions: rows at depths 0, 4 and 7 over a cache
    holding earlier rows."""
    jimpl, jp, timpl, tp = _attn_pair()
    rng = np.random.default_rng(20)
    k = rng.normal(size=(3, 12, 2, 2)).astype(np.float32)
    v = rng.normal(size=(3, 12, 2, 2)).astype(np.float32)
    pos = np.array([0, 4, 7], np.int32)
    js = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    ts = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos)}
    x = _x(21, 3, t)
    jy, js = jimpl.forward_with_state(jp, jnp.asarray(x), js)
    ty, ts = timpl.forward_with_state(tp, torch.from_numpy(x), ts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=2e-5)
    _close_state(ts, js)
    assert ts["pos"].tolist() == (pos + t).tolist()


def test_kv_overflow_raises_where_the_position_is_read():
    jimpl, jp, timpl, tp = _attn_pair(cap=8)
    ts = timpl.init_state(1)
    _, ts = timpl.forward_with_state(tp, torch.from_numpy(_x(30, 1, 6)), ts)
    with pytest.raises(ValueError, match="overflow"):
        timpl.forward_with_state(tp, torch.from_numpy(_x(31, 1, 6)), ts)
    js = jimpl.init_state(1)
    _, js = jimpl.forward_with_state(jp, jnp.asarray(_x(30, 1, 6)), js)
    with pytest.raises(ValueError, match="overflow"):
        jimpl.forward_with_state(jp, jnp.asarray(_x(31, 1, 6)), js)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_kv_overflow_sentinel_matches_jax_traced(per_row):
    """The step's own guard, as the JAX step runs under a trace: NaN
    output for a row whose write passes the cache, its position frozen at
    L_cap + 1, and every later step poisoned too."""
    jimpl, jp, timpl, tp = _attn_pair(cap=8)
    step = jax.jit(lambda s, x: jimpl.forward_with_state(jp, x, s))
    pos = np.array([5, 2], np.int32) if per_row else np.int32(5)
    rng = np.random.default_rng(40)
    k = rng.normal(size=(2, 8, 2, 2)).astype(np.float32)
    js = {"k": jnp.asarray(k), "v": jnp.asarray(k), "pos": jnp.asarray(pos)}
    ts = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(k.copy()),
          "pos": torch.as_tensor(pos)}
    for i in range(2):
        x = _x(41 + i, 2, 4)
        jy, js = step(js, jnp.asarray(x))
        ty, ts = timpl._contiguous_step(tp, torch.from_numpy(x), ts)
        jy, ty = np.asarray(jy), ty.numpy()
        np.testing.assert_array_equal(np.isnan(ty), np.isnan(jy))
        live = ~np.isnan(jy)
        np.testing.assert_allclose(ty[live], jy[live], rtol=0, atol=2e-5)
        _close_state(ts, js)
    if per_row:  # row 0 overflowed (5 + 4 > 8), row 1 ran 2 -> 6 -> 10 > 8
        assert ts["pos"].tolist() == [9, 9]
        assert np.isnan(ty).all()
    else:
        assert int(ts["pos"]) == 9 and np.isnan(ty).all()


# -- rnn_time_step and cached generation ----------------------------------------

def test_rnn_time_step_matches_jax_and_the_full_forward():
    jnet, tnet = _pair(cache=16)
    x, _ = _batch(50, n=2, t=10)
    full = tnet.output(x)[0].numpy()
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    outs = []
    for sl in (slice(0, 6), slice(6, 7), slice(7, 10)):
        jo = np.asarray(jnet.rnn_time_step(x[:, sl])[0])
        to = tnet.rnn_time_step(x[:, sl])[0].numpy()
        np.testing.assert_allclose(to, jo, rtol=0, atol=2e-5)
        outs.append(to)
    np.testing.assert_allclose(np.concatenate(outs, 1), full, rtol=0,
                               atol=2e-5)
    # [B, F] inputs are one step; clearing restarts at position 0
    tnet.rnn_clear_previous_state()
    first = tnet.rnn_time_step(x[:, 0])[0].numpy()
    np.testing.assert_allclose(first[:, 0], full[:, 0], rtol=0, atol=2e-5)
    assert tnet._rnn_state["attn0"]["pos"].item() == 1
    tnet.rnn_clear_previous_state()
    assert tnet._rnn_state == {}


def test_rnn_time_step_overflow_raises_and_clearing_recovers():
    _, tnet = _pair(cache=8)
    x, _ = _batch(51, n=1, t=6)
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(x)
    with pytest.raises(ValueError, match="overflow"):
        tnet.rnn_time_step(x)
    tnet.rnn_clear_previous_state()
    assert np.isfinite(tnet.rnn_time_step(x)[0].numpy()).all()


@pytest.mark.parametrize("sampling", [dict(), dict(temperature=0.9, seed=11)],
                         ids=["greedy", "seeded"])
def test_cached_generation_matches_jax_and_the_uncached_path(sampling):
    jnet, tnet = _pair(cache=16)
    prompt = [3, 4, 5, 1, 7]
    want = jgen(jnet, prompt, 6, V, use_cache=True, **sampling)
    cached = generate_transformer(tnet, prompt, 6, V, use_cache=True,
                                  **sampling)
    assert cached == want
    assert generate_transformer(tnet, prompt, 6, V, **sampling) == want
    assert tnet._rnn_state == {}  # the cached path clears what it made


def test_generation_window_and_cache_refusals():
    jnet, tnet = _pair(cache=8)
    prompt = [1, 2, 3, 4, 5, 6]
    for kw in (dict(max_context=3), dict(max_context=3, temperature=0.7,
                                         seed=2)):
        assert generate_transformer(tnet, prompt, 4, V, **kw) == \
            jgen(jnet, prompt, 4, V, **kw)
    with pytest.raises(ValueError, match="max_context"):
        generate_transformer(tnet, prompt, 2, V, max_context=4,
                             use_cache=True)
    # prompt 6 + 3 tokens - 1 = 8 fits exactly; 4 tokens do not
    assert len(generate_transformer(tnet, prompt, 3, V, use_cache=True)) == 3
    with pytest.raises(ValueError, match="max_cache_len=8"):
        generate_transformer(tnet, prompt, 4, V, use_cache=True)


def test_long_context_example_learns_the_copy_task():
    """The ported example at the JAX example test's settings
    (tests/test_examples.py :49-52): RoPE, GQA, remat, cached decode."""
    from deeplearning4j_tpu_torch.examples import long_context_lm
    acc = long_context_lm.main(steps=250, vocab=9, half=6, batch=32,
                               device="cpu")
    assert acc > 0.8
