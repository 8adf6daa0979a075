"""Port parity: the layers of ROADMAP A3 against the JAX impls on the same
params and inputs — LSTM, GravesLSTM, the bidirectional GravesLSTM and
GRU (with and without a mask, from zeros and from a given state),
Embedding (indices, one-hot, out-of-range indices), GlobalPooling (max,
avg, sum, pnorm; time series masked and unmasked, and NHWC), LRN,
Activation, Dropout and Loss, then the `lstm_cell` / `lstm_sequence` /
`lrn` seams themselves and the layer configs over JSON.

Configs are built in the JAX package and carried to the port through the
shared config JSON; params and inputs are numpy arrays from a seed (the
peepholes non-zero, so they are exercised). Gradients are those of
sum(y * R) for a fixed random R, with respect to every param and, for
float inputs, the input.

Tolerances (f32): forward rtol 1e-5 / atol 1e-6 (the recurrent state
carries rounding across the steps); gradients max |diff| <= 1e-4 x max
|JAX gradient| of the leaf (autograd and `jax.grad` sum the batch and
the time steps in other orders). Out-of-range embedding rows are NaN on
both sides, compared with equal_nan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as _JNet  # noqa: F401 (registers impls)
from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.layers.base import impl_for as timpl_for
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as _TNet  # noqa: F401 (registers impls)
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import helpers as thelpers

RTOL, ATOL, GRAD_REL = 1e-5, 1e-6, 1e-4
B, T, F, H = 3, 7, 5, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jconf):
    """(JAX impl, port impl) of one layer config, carried over JSON."""
    tconf = tserde.from_json(jserde.to_json(jconf))
    assert type(tconf).__name__ == type(jconf).__name__
    assert tserde.to_json(tconf) == jserde.to_json(jconf)
    return jimpl_for(jconf), timpl_for(tconf)


def _params(jimpl, seed=0, scale=0.4):
    """Random numpy values in the shapes of the JAX impl's params."""
    shapes = {k: v.shape for k, v in
              jimpl.init_params(jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(seed=2, b=B, t=T):
    """[B, T] 0/1 masks of several lengths, one row with a hole."""
    m = np.ones((b, t), np.float32)
    m[0, t - 2:] = 0.0
    m[1, 3] = 0.0
    return m


def _check(jf, tf, p, x, *, grad_x=True, seed=9):
    """Forward and the gradients of sum(y * R) of JAX's ``jf(params, x)``
    and the port's ``tf(params, x)``."""
    want = np.asarray(jf({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=grad_x)
    got = tf(tp, tx)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    R = np.random.default_rng(seed).normal(size=want.shape).astype(
        np.float32)
    argnums = (0, 1) if grad_x else (0,)
    jg = jax.grad(lambda pp, xx: jnp.sum(jf(pp, xx) * R), argnums)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    leaves = list(tp.values()) + ([tx] if grad_x else [])
    tg = torch.autograd.grad((got * torch.tensor(R)).sum(), leaves,
                             allow_unused=True)
    want_g = [np.asarray(jg[0][k]) for k in tp] + (
        [np.asarray(jg[1])] if grad_x else [])
    for name, w, g in zip(list(tp) + ["x"], want_g, tg):
        g = np.zeros_like(w) if g is None else g.numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * max(np.abs(w).max(), 1e-30), (name, err)
    return got


# -- recurrent layers --------------------------------------------------------

RECURRENT = {
    "lstm": lambda: jl.LSTM(n_in=F, n_out=H, activation="tanh"),
    "graves": lambda: jl.GravesLSTM(n_in=F, n_out=H, activation="tanh"),
    "graves_softsign": lambda: jl.GravesLSTM(n_in=F, n_out=H,
                                             activation="softsign",
                                             forget_gate_bias_init=0.5),
    "bidirectional": lambda: jl.GravesBidirectionalLSTM(
        n_in=F, n_out=H, activation="tanh"),
    "gru": lambda: jl.GRU(n_in=F, n_out=H, activation="tanh"),
}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", list(RECURRENT))
def test_recurrent_forward_and_gradients_match_jax(kind, masked):
    jimpl, timpl = _pair(RECURRENT[kind]())
    p = _params(jimpl, seed=3)
    x = _x((B, T, F))
    m = _mask() if masked else None

    def jf(pp, xx):
        return jimpl.forward_with_state(
            pp, xx, None, mask=None if m is None else jnp.asarray(m))[0]

    def tf(pp, xx):
        return timpl.forward_with_state(
            pp, xx, None, mask=None if m is None else torch.tensor(m))[0]

    y = _check(jf, tf, p, x)
    if masked:  # masked steps output zeros
        assert np.all(y.detach().numpy()[m == 0] == 0.0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", ["lstm", "graves", "gru"])
def test_recurrent_state_in_and_out_match_jax(kind, masked):
    """From a given state: the output, the final state, and the gradient
    with respect to the incoming state (what TBPTT carries)."""
    jimpl, timpl = _pair(RECURRENT[kind]())
    p = _params(jimpl, seed=4)
    x = _x((B, T, F), seed=5)
    m = _mask() if masked else None
    keys = ["h", "c"] if kind != "gru" else ["h"]
    s0 = {k: _x((B, H), seed=10 + i) for i, k in enumerate(keys)}
    R = {k: _x((B, H), seed=20 + i) for i, k in enumerate(keys)}
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.tensor(m)

    def jloss(pp, ss):
        y, st = jimpl.forward_with_state(pp, jnp.asarray(x), ss, mask=jm)
        return jnp.sum(y) + sum(jnp.sum(st[k] * R[k]) for k in keys), (y, st)

    (_, (jy, jst)), (jgp, jgs) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in s0.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in s0.items()}
    ty, tst = timpl.forward_with_state(tp, torch.tensor(x), ts, mask=tm)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    for k in keys:
        np.testing.assert_allclose(tst[k].detach().numpy(),
                                   np.asarray(jst[k]), rtol=RTOL, atol=ATOL)
    loss = ty.sum() + sum((tst[k] * torch.tensor(R[k])).sum() for k in keys)
    grads = torch.autograd.grad(loss, list(tp.values()) + list(ts.values()))
    want = [np.asarray(jgp[k]) for k in tp] + [np.asarray(jgs[k])
                                                for k in ts]
    for w, g in zip(want, grads):
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max()


@pytest.mark.parametrize("kind", ["lstm", "graves", "gru"])
def test_recurrent_step_matches_jax(kind):
    jimpl, timpl = _pair(RECURRENT[kind]())
    p = _params(jimpl, seed=6)
    x_t = _x((B, F), seed=7)
    keys = ["h", "c"] if kind != "gru" else ["h"]
    s0 = {k: _x((B, H), seed=30 + i) for i, k in enumerate(keys)}
    jy, jst = jimpl.step({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x_t),
                         {k: jnp.asarray(v) for k, v in s0.items()})
    ty, tst = timpl.step({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x_t),
                         {k: torch.tensor(v) for k, v in s0.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    for k in keys:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=RTOL, atol=ATOL)


def test_bidirectional_refuses_stepping_and_returns_the_forward_state():
    jimpl, timpl = _pair(RECURRENT["bidirectional"]())
    p = _params(jimpl, seed=8)
    x = _x((B, T, F), seed=9)
    _, jst = jimpl.forward_with_state({k: jnp.asarray(v)
                                       for k, v in p.items()},
                                      jnp.asarray(x), None)
    _, tst = timpl.forward_with_state({k: torch.tensor(v)
                                       for k, v in p.items()},
                                      torch.tensor(x), None)
    for k in ("h", "c"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="bidirectional"):
        timpl.step({}, torch.zeros(B, F), {})


def test_recurrent_init_params_layout_matches_jax():
    """Names, shapes, the forget-gate bias slice and zero peepholes."""
    for kind, make in RECURRENT.items():
        jimpl, timpl = _pair(make())
        jp = jimpl.init_params(jax.random.PRNGKey(0))
        tp = timpl.init_params(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}, kind
        for k in tp:
            if k.endswith("b") or k[-2:] in ("pI", "pF", "pO"):
                np.testing.assert_array_equal(tp[k].numpy(),
                                              np.asarray(jp[k]))
        assert timpl.WEIGHT_KEYS == jimpl.WEIGHT_KEYS


# -- the seams ---------------------------------------------------------------

@pytest.mark.parametrize("activation", ["tanh", "softsign"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_lstm_sequence_seam_matches_jax(reverse, activation):
    rng = np.random.default_rng(11)
    xp = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    rw = (rng.normal(size=(H, 4 * H)) * 0.4).astype(np.float32)
    peep = (rng.normal(size=(3, H)) * 0.4).astype(np.float32)
    h0, c0 = _x((B, H), 12), _x((B, H), 13)
    jys, jh, jc = jhelpers.lstm_sequence(
        *map(jnp.asarray, (xp, rw, peep, h0, c0)), activation=activation,
        reverse=reverse)
    tys, th, tc = thelpers.lstm_sequence(
        *map(torch.tensor, (xp, rw, peep, h0, c0)), activation=activation,
        reverse=reverse)
    for t, j in ((tys, jys), (th, jh), (tc, jc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)


def test_lstm_cell_is_the_one_definition():
    """`lstm_cell` against JAX's, and the seam's plain default against a
    loop over it (the layers' per-step path uses the same cell)."""
    z, c = _x((B, 4 * H), 14), _x((B, H), 15)
    peep = tuple(_x((H,), 16 + i) for i in range(3))
    jh, jc = jhelpers.lstm_cell(jnp.asarray(z), jnp.asarray(c),
                                tuple(map(jnp.asarray, peep)), jnp.tanh)
    th, tc = thelpers.lstm_cell(torch.tensor(z), torch.tensor(c),
                                tuple(map(torch.tensor, peep)), torch.tanh)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)
    assert thelpers.get_helper("lstm_sequence") is None
    assert thelpers.get_helper("lrn") is None


@pytest.mark.parametrize("n", [5.0, 3.0, 4.0, 1.0])
def test_lrn_seam_matches_jax(n):
    x = _x((2, 3, 4, 9), 17) * 3
    want = jhelpers.lrn(jnp.asarray(x), k=1.5, n=n, alpha=0.02, beta=0.6)
    got = thelpers.lrn(torch.tensor(x), k=1.5, n=n, alpha=0.02, beta=0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- feed-forward layers -----------------------------------------------------

def _ff_check(jconf, x, *, mask=None, train=False, grad_x=True,
              params=True):
    jimpl, timpl = _pair(jconf)
    p = _params(jimpl, seed=21) if params else {}
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)

    def jf(pp, xx):
        return jimpl.forward(pp, xx, train=train, mask=jm,
                             rng=jax.random.PRNGKey(0) if train else None)[0]

    def tf(pp, xx):
        return timpl.forward(pp, xx, train=train, mask=tm,
                             gen=torch.Generator().manual_seed(0)
                             if train else None)

    return _check(jf, tf, p, x, grad_x=grad_x)


POOLS = ["max", "avg", "sum", "pnorm"]


@pytest.mark.parametrize("shape", ["time", "time_masked", "nhwc"])
@pytest.mark.parametrize("pool", POOLS)
def test_global_pooling_matches_jax(pool, shape):
    x = _x((B, T, F), 22) if shape != "nhwc" else _x((B, 4, 3, F), 22)
    _ff_check(jl.GlobalPoolingLayer(pooling_type=pool), x,
              mask=_mask() if shape == "time_masked" else None,
              params=False)


@pytest.mark.parametrize("kind", ["onehot", "index_1d", "index_2d",
                                  "index_float", "no_bias"])
def test_embedding_matches_jax(kind):
    V, D = 9, 4
    conf = jl.EmbeddingLayer(n_in=V, n_out=D, activation="tanh",
                             has_bias=kind != "no_bias")
    rng = np.random.default_rng(23)
    idx = rng.integers(0, V, (B + 3,))
    if kind == "onehot":
        _ff_check(conf, np.eye(V, dtype=np.float32)[idx])
        return
    x = {"index_1d": idx.astype(np.int32),
         "index_2d": idx.astype(np.int32)[:, None],
         "index_float": idx.astype(np.float32)[:, None],
         "no_bias": idx.astype(np.int64)}[kind]
    _ff_check(conf, x, grad_x=False)


def test_embedding_out_of_range_indices_follow_jnp_take():
    """`jnp.take`'s answer, established here: -1 .. -n_in count from the
    end, and any index outside [-n_in, n_in) gives a NaN row with no
    gradient (the port clamps the gather and writes the NaN with
    torch.where, so the card never gathers out of range)."""
    V, D = 6, 3
    jimpl, timpl = _pair(jl.EmbeddingLayer(n_in=V, n_out=D,
                                           activation="identity"))
    p = _params(jimpl, seed=24)
    idx = np.array([0, V - 1, V, -1, -V, -V - 1, 2 * V, 3], np.int32)
    want = np.asarray(jimpl.forward({k: jnp.asarray(v)
                                     for k, v in p.items()},
                                    jnp.asarray(idx))[0])
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    got = timpl.forward(tp, torch.tensor(idx))
    np.testing.assert_array_equal(np.isnan(want), np.isnan(
        got.detach().numpy()))
    assert np.isnan(want[[2, 5, 6]]).all() and not np.isnan(
        want[[0, 1, 3, 4, 7]]).any()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL, equal_nan=True)
    ok = ~np.isnan(want).any(axis=1)
    R = _x(want.shape, 25) * ok[:, None]
    jg = jax.grad(lambda pp: jnp.sum(jnp.where(
        ok[:, None], jimpl.forward(pp, jnp.asarray(idx))[0], 0.0) * R))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tg = torch.autograd.grad(
        (torch.where(torch.tensor(ok)[:, None], got, 0.0)
         * torch.tensor(R)).sum(), tp["W"])[0]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg["W"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n", [5.0, 3.0])
def test_lrn_layer_matches_jax(n):
    _ff_check(jl.LocalResponseNormalization(n=n), _x((2, 4, 3, 8), 26) * 2,
              params=False)


@pytest.mark.parametrize("activation", ["relu", "tanh", "softmax",
                                        "leakyrelu"])
def test_activation_layer_matches_jax(activation):
    _ff_check(jl.ActivationLayer(activation=activation, dropout=0.0),
              _x((B, T, F), 27), train=True, params=False)


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_dropout_layer_p0_matches_jax(train):
    _ff_check(jl.DropoutLayer(dropout=0.0), _x((B, F), 28), train=train,
              params=False)


def test_dropout_layer_drops_at_train_time_only():
    _, timpl = _pair(jl.DropoutLayer(dropout=0.5))
    x = torch.ones(64, 32)
    np.testing.assert_array_equal(timpl.forward({}, x).numpy(), x.numpy())
    y = timpl.forward({}, x, train=True,
                      gen=torch.Generator().manual_seed(1))
    assert set(np.unique(y.numpy())) <= {0.0, 2.0}
    assert 0.3 < float((y == 0).float().mean()) < 0.7


@pytest.mark.parametrize("activation", ["softmax", "identity", "sigmoid"])
def test_loss_layer_matches_jax(activation):
    jconf = jl.LossLayer(activation=activation, loss="mcxent")
    y = _ff_check(jconf, _x((B, F), 29), params=False)
    _, timpl = _pair(jconf)
    x = torch.tensor(_x((B, F), 29))
    out, pre = timpl.forward_with_preout({}, x)
    np.testing.assert_array_equal(pre.numpy(), x.numpy())
    np.testing.assert_array_equal(out.numpy(), y.detach().numpy())
    assert tact.get(activation) is not None


# -- configs -----------------------------------------------------------------

A3_CONFIGS = [
    jl.LossLayer(loss="mcxent", activation="softmax"),
    jl.LocalResponseNormalization(k=1.0, n=3.0, alpha=0.01, beta=0.5),
    jl.GravesLSTM(n_in=3, n_out=4, forget_gate_bias_init=0.3),
    jl.LSTM(n_in=3, n_out=4), jl.GravesBidirectionalLSTM(n_in=3, n_out=4),
    jl.GRU(n_in=3, n_out=4),
    jl.EmbeddingLayer(n_in=10, n_out=4, has_bias=False),
    jl.ActivationLayer(activation="relu"), jl.DropoutLayer(dropout=0.2),
    jl.GlobalPoolingLayer(pooling_type="pnorm"),
]


@pytest.mark.parametrize("jconf", A3_CONFIGS,
                         ids=[type(c).__name__ for c in A3_CONFIGS])
def test_layer_configs_round_trip_both_ways(jconf):
    tconf = tserde.from_json(jserde.to_json(jconf))
    assert tserde.to_json(tconf) == jserde.to_json(jconf)
    back = jserde.from_json(tserde.to_json(tconf))
    assert jserde.to_json(back) == jserde.to_json(jconf)


# -- shape inference over the new layers -------------------------------------

def _inferred_nets(ns):
    """A recurrent net and a CNN with LRN, their n_in and preprocessors
    left to `set_input_type` (JAX config.py :306-320, :376)."""
    rnn = (ns.config.NeuralNetConfiguration.builder().list()
           .layer(ns.layers.GravesLSTM(n_out=6, activation="tanh"))
           .layer(ns.layers.DropoutLayer(dropout=0.0))
           .layer(ns.layers.GlobalPoolingLayer(pooling_type="max"))
           .layer(ns.layers.DenseLayer(n_out=5, activation="relu"))
           .layer(ns.layers.OutputLayer(n_out=3, activation="softmax"))
           .set_input_type(ns.inputs.InputType.recurrent(4)).build())
    cnn = (ns.config.NeuralNetConfiguration.builder().list()
           .layer(ns.layers.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
           .layer(ns.layers.LocalResponseNormalization())
           .layer(ns.layers.ActivationLayer(activation="relu"))
           .layer(ns.layers.GlobalPoolingLayer(pooling_type="avg"))
           .layer(ns.layers.OutputLayer(n_out=2, activation="softmax"))
           .set_input_type(ns.inputs.InputType.convolutional(6, 6, 2))
           .build())
    return {"rnn": rnn, "cnn": cnn}


@pytest.mark.parametrize("kind", ["rnn", "cnn"])
def test_shape_inference_matches_jax(kind):
    from types import SimpleNamespace
    from deeplearning4j_tpu.nn.conf import config as jconfig
    from deeplearning4j_tpu.nn.conf import inputs as jinputs
    from deeplearning4j_tpu_torch.nn.conf import config as tconfig
    from deeplearning4j_tpu_torch.nn.conf import inputs as tinputs
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    want = _inferred_nets(SimpleNamespace(config=jconfig, layers=jl,
                                          inputs=jinputs))[kind]
    got = _inferred_nets(SimpleNamespace(config=tconfig, layers=tl,
                                         inputs=tinputs))[kind]
    assert got.to_json() == want.to_json()
    assert got.layers[-1].n_in == (5 if kind == "rnn" else 4)


def test_attention_regularizes_its_weights_as_jax():
    """The recurrent base's WEIGHT_KEYS are ("W", "RW"); the attention
    layer, which derives from it, names its own four projections as the
    JAX impl does, so l1/l2 reach them (they reached none before)."""
    conf = jl.SelfAttentionLayer(n_in=8, n_out=8, n_heads=2, l1=0.01,
                                 l2=0.03)
    jimpl, timpl = _pair(conf)
    assert timpl.WEIGHT_KEYS == jimpl.WEIGHT_KEYS == ("Wq", "Wk", "Wv", "Wo")
    assert timpl.TBPTT_STATE is jimpl.TBPTT_STATE is False
    p = _params(jimpl, seed=31)
    want = float(jimpl.reg_loss({k: jnp.asarray(v) for k, v in p.items()}))
    got = float(timpl.reg_loss({k: torch.tensor(v) for k, v in p.items()}))
    assert want > 0 and got == pytest.approx(want, rel=1e-6)
