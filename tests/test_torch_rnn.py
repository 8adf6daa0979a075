"""Port parity: recurrent training and streaming — the GravesLSTM char-RNN
(`char_rnn_lstm`, cut to a vocabulary of 7 and 12 units), truncated BPTT,
`rnn_time_step`, `generate_rnn`, char-RNN zips and config JSON, recurrent
vertices in a ComputationGraph, and the cases of the JAX package's
tests/test_rnn.py run on the port.

Both packages build the same config (the port reads the JAX config's
JSON), the port takes the JAX params with `params_from_jax`, and both
see the same one-hot sequences made with numpy from a seed. T = 10 with
TBPTT windows of 4 gives windows of 4, 4 and 2 steps.

Tolerances (f32): every window's score within 1e-5 relative, and every
param and updater-state value after the fit within 1e-5 (Nesterovs at lr
0.1 moves a param by lr times a gradient summed in another order);
`rnn_time_step` and the outputs within 1e-5; zips and JSON exact where
they are copies, outputs of restored nets within 1e-6; `generate_rnn`
tokens identical. bf16: the tolerances of test_torch_mixed_precision.py
— each window's score within 2e-3 relative, the bf16 params after the
fit within 2^-8 (one bf16 ulp at 1: rounding the same update either way
moves a param by one ulp of its magnitude; measured 2^-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import sampling as jsampling
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import sampling as tsampling
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.util import model_serializer as tms

V, H, B, T, L = 7, 12, 3, 10, 4
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model.score_))


def _host(lp):
    return {k: np.asarray(v) for k, v in lp.items()}


def _pair(jconf):
    """(JAX net, port net on the CPU) on the JAX net's params."""
    jnet = JNet(jconf).init()
    tnet = TNet(MultiLayerConfiguration.from_json(jconf.to_json()),
                device="cpu").init()
    tnet.set_params(tms.params_from_jax([_host(lp) for lp in jnet.params]))
    return jnet, tnet


def _char_conf(dtype="float32", iterations=1):
    conf = jzoo.char_rnn_lstm(vocab_size=V, hidden=H, tbptt=L, dtype=dtype)
    conf.conf.iterations = iterations
    return conf


def _seq_classifier_conf(iterations=1):
    """Two GravesLSTMs -> mean over time -> softmax output: a net whose
    labels are 2-d, so each TBPTT window gets them whole."""
    b = (jconfig.NeuralNetConfiguration.builder()
         .seed(5).learning_rate(0.1).updater(jupd.Nesterovs(momentum=0.9))
         .iterations(iterations)
         .list()
         .layer(jl.GravesLSTM(n_in=V, n_out=H, activation="tanh"))
         .layer(jl.GravesLSTM(n_in=H, n_out=H, activation="tanh"))
         .layer(jl.GlobalPoolingLayer(pooling_type="avg"))
         .layer(jl.OutputLayer(n_in=H, n_out=3, activation="softmax",
                               loss="mcxent"))
         .backprop_type(jconfig.BACKPROP_TBPTT)
         .t_bptt_forward_length(L).t_bptt_backward_length(L))
    return b.build()


def _tokens(seed, b=B, t=T):
    tok = np.random.default_rng(seed).integers(0, V, (b, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[tok[:, :-1]], eye[tok[:, 1:]]


def _close_params(jnet, tnet, atol=REL):
    np.testing.assert_allclose(tnet.params_flat(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()),
                               rtol=0, atol=atol)


# -- truncated BPTT -----------------------------------------------------------

TBPTT_CASES = {
    "labels_3d": dict(conf=_char_conf, masked=False, iterations=1),
    "labels_3d_masked": dict(conf=_char_conf, masked=True, iterations=1),
    "labels_3d_iterations_2": dict(conf=_char_conf, masked=False,
                                   iterations=2),
    "labels_2d": dict(conf=_seq_classifier_conf, masked=False, iterations=1),
    "labels_2d_iterations_2": dict(conf=_seq_classifier_conf, masked=False,
                                   iterations=2),
}


@pytest.mark.parametrize("case", list(TBPTT_CASES))
def test_tbptt_fit_matches_jax(case):
    c = TBPTT_CASES[case]
    jnet, tnet = _pair(c["conf"](iterations=c["iterations"]))
    x, y = _tokens(1)
    if c["conf"] is _seq_classifier_conf:
        y = np.eye(3, dtype=np.float32)[np.arange(B) % 3]
    m = None
    if c["masked"]:
        m = np.ones((B, T), np.float32)
        m[0, 7:] = 0.0
        m[2, 3:] = 0.0
    js, ts = _Scores(), _Scores()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    for _ in range(2):  # two fits: the updater state carries between them
        jnet.fit(JDataSet(x, y, m, m))
        tnet.fit(DataSet(x, y, m, m))
    # 3 windows (4 + 4 + 2 steps) x iterations x 2 fits
    assert len(ts.scores) == len(js.scores) == 3 * c["iterations"] * 2
    np.testing.assert_allclose(ts.scores, js.scores, rtol=REL)
    assert tnet.step == jnet.step
    _close_params(jnet, tnet)


def test_tbptt_windows_carry_detached_state():
    """The windows' scores are those of fit_batch calls that carry the
    state by hand (each window starting where the last ended, with no
    gradient into the previous window), and differ from restarting each
    window at zeros."""
    conf = _char_conf()
    x, y = _tokens(2)
    a = TNet(MultiLayerConfiguration.from_json(conf.to_json()),
             device="cpu").init()
    b = TNet(MultiLayerConfiguration.from_json(conf.to_json()),
             device="cpu").init()
    c = TNet(MultiLayerConfiguration.from_json(conf.to_json()),
             device="cpu").init()
    sa, sb, sc = _Scores(), _Scores(), _Scores()
    a.set_listeners(sa)
    b.set_listeners(sb)
    c.set_listeners(sc)
    a.fit(x, y)
    states = None
    for s in range(0, T, L):
        states = b.fit_batch(x[:, s:s + L], y[:, s:s + L], states=states,
                             carry_state=states is not None)
        states = {k: {n: t.detach() for n, t in v.items()}
                  for k, v in states.items()}
        c.fit_batch(x[:, s:s + L], y[:, s:s + L])
    assert sa.scores == sb.scores
    assert sa.scores[0] == sc.scores[0] and sa.scores[1] != sc.scores[1]
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())


# -- streaming -----------------------------------------------------------------

def test_rnn_time_step_chunked_matches_jax():
    jnet, tnet = _pair(_char_conf())
    x, _ = _tokens(3, t=6)
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    outs = []
    for a, b in ((0, 1), (1, 4), (4, 6)):
        want = np.asarray(jnet.rnn_time_step(x[:, a:b]))
        got = tnet.rnn_time_step(x[:, a:b]).numpy()
        np.testing.assert_allclose(got, want, rtol=REL, atol=1e-7)
        outs.append(got)
    full = tnet.output(x).numpy()
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full,
                               rtol=REL, atol=1e-7)
    for i in (0, 1):
        for k in ("h", "c"):
            np.testing.assert_allclose(
                tnet.rnn_get_previous_state(i)[k].numpy(),
                np.asarray(jnet.rnn_get_previous_state(i)[k]), rtol=REL,
                atol=1e-7)
    # a 2-d input is one step; set/clear work as in JAX
    saved = {i: tnet.rnn_get_previous_state(i) for i in (0, 1)}
    step = tnet.rnn_time_step(x[:, 0]).numpy()
    tnet.rnn_clear_previous_state()
    for i, st in saved.items():
        tnet.rnn_set_previous_state(i, st)
    np.testing.assert_array_equal(tnet.rnn_time_step(x[:, 0]).numpy(), step)


@pytest.mark.parametrize("mode", ["greedy", "temperature_1_top_k_5"])
def test_generate_rnn_matches_jax(mode):
    jnet, tnet = _pair(_char_conf())
    x, y = _tokens(4, b=4, t=12)
    for _ in range(3):  # train a little so the rows are not flat
        jnet.fit(x, y)
        tnet.fit(x, y)
    kw = dict(temperature=0.0) if mode == "greedy" else dict(
        temperature=1.0, top_k=5, seed=3)
    prompt = [1, 4, 2, 6, 0]
    want = jsampling.generate_rnn(jnet, prompt, 12, V, **kw)
    got = tsampling.generate_rnn(tnet, prompt, 12, V, **kw)
    assert got == want
    with pytest.raises(ValueError, match="non-empty"):
        tsampling.generate_rnn(tnet, [], 3, V)


# -- bf16 ------------------------------------------------------------------------

def test_char_rnn_bf16_fit_matches_jax():
    jnet, tnet = _pair(_char_conf(dtype="bfloat16"))
    assert {p.dtype for lp in tnet.params for p in lp.values()} == \
        {torch.bfloat16}
    x, y = _tokens(5)
    js, ts = _Scores(), _Scores()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert len(ts.scores) == 3
    np.testing.assert_allclose(ts.scores, js.scores, rtol=2e-3)
    want = np.asarray(jnet.params_flat()).astype(np.float32)
    assert np.abs(tnet.params_flat() - want).max() <= 2.0 ** -8
    assert tnet.rnn_time_step(x[:, :2]).dtype == torch.bfloat16


# -- config JSON and zips ------------------------------------------------------

def test_char_rnn_config_json_round_trips_both_ways():
    jconf = jzoo.char_rnn_lstm()
    tconf = tzoo.char_rnn_lstm()
    assert tconf.to_json() == jconf.to_json()
    assert MultiLayerConfiguration.from_json(jconf.to_json()).to_json() \
        == jconf.to_json()
    assert jconfig.MultiLayerConfiguration.from_json(
        tconf.to_json()).to_json() == tconf.to_json()
    assert tconf.backprop_type == tconfig.BACKPROP_TBPTT
    assert tconf.tbptt_fwd_length == 50


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_char_rnn_zip_loads_in_the_other_package(tmp_path, direction):
    x, y = _tokens(6)
    path = tmp_path / "char_rnn.zip"
    if direction == "jax_to_torch":
        src = JNet(_char_conf()).init()
        src.fit(x, y)
        jms.write_model(src, path)
        dst = tms.restore_model(path, device="cpu")
        want, got = np.asarray(src.output(x)), dst.output(x).numpy()
    else:
        src = TNet(MultiLayerConfiguration.from_json(
            _char_conf().to_json()), device="cpu").init()
        src.fit(x, y)
        tms.write_model(src, path)
        dst = jms.restore_model(path)
        want, got = src.output(x).numpy(), np.asarray(dst.output(x))
    assert dst.step == src.step == 3
    np.testing.assert_array_equal(np.asarray(dst.params_flat()),
                                  np.asarray(src.params_flat()))
    np.testing.assert_array_equal(np.asarray(dst.updater_state_flat()),
                                  np.asarray(src.updater_state_flat()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- ComputationGraph ------------------------------------------------------------

def _graph_conf(cell):
    """in -> cell -> RnnOutput, truncated BPTT; plus a second input that
    skips the cell (a 2-d static input, given whole to every window)."""
    gb = (jconfig.NeuralNetConfiguration.builder()
          .seed(9).learning_rate(0.05).updater(jupd.Nesterovs(momentum=0.9))
          .graph_builder()
          .add_inputs("in")
          .add_layer("rnn", cell(n_in=V, n_out=H, activation="tanh"), "in")
          .add_layer("rnn2", jl.GRU(n_in=H, n_out=H, activation="tanh"),
                     "rnn")
          .add_layer("out", jl.RnnOutputLayer(n_in=H, n_out=V,
                                              activation="softmax",
                                              loss="mcxent"), "rnn2")
          .set_outputs("out")
          .backprop_type(jconfig.BACKPROP_TBPTT)
          .t_bptt_forward_length(L).t_bptt_backward_length(L))
    return gb.build()


@pytest.mark.parametrize("cell", ["LSTM", "GravesLSTM", "GRU"])
def test_graph_recurrent_vertices_tbptt_and_streaming_match_jax(cell):
    jconf = _graph_conf(getattr(jl, cell))
    jnet = JGraph(jconf).init()
    tconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert tconf.backprop_type == tconfig.BACKPROP_TBPTT
    assert tconf.to_json() == jconf.to_json()
    tnet = TGraph(tconf, device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        {k: _host(lp) for k, lp in jnet.params.items()}))
    x, y = _tokens(7)
    np.testing.assert_allclose(tnet.output(x)[0].numpy(),
                               np.asarray(jnet.output(x)[0]), rtol=REL,
                               atol=1e-7)
    js, ts = _Scores(), _Scores()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert len(ts.scores) == len(js.scores) == 3
    np.testing.assert_allclose(ts.scores, js.scores, rtol=REL)
    _close_params(jnet, tnet)
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    for a, b in ((0, 1), (1, 4)):
        np.testing.assert_allclose(
            tnet.rnn_time_step(x[:, a:b])[0].numpy(),
            np.asarray(jnet.rnn_time_step(x[:, a:b])[0]), rtol=REL,
            atol=1e-7)


def test_graph_tbptt_builder_and_refusal_lifted():
    conf = (tconfig.NeuralNetConfiguration.builder().graph_builder()
            .add_inputs("in")
            .add_layer("rnn", tl.GravesLSTM(n_in=V, n_out=H), "in")
            .add_layer("out", tl.RnnOutputLayer(n_in=H, n_out=V,
                                                activation="softmax"), "rnn")
            .set_outputs("out").backprop_type(tconfig.BACKPROP_TBPTT)
            .t_bptt_forward_length(3).t_bptt_backward_length(2).build())
    assert (conf.backprop_type, conf.tbptt_fwd_length,
            conf.tbptt_back_length) == (tconfig.BACKPROP_TBPTT, 3, 2)
    net = TGraph(conf, device="cpu").init()
    s = _Scores()
    net.set_listeners(s)
    x, y = _tokens(8)
    net.fit(x, y)
    assert len(s.scores) == 4 and np.isfinite(s.scores).all()


# -- the cases of the JAX package's tests/test_rnn.py, on the port ----------------

def _rnn_net(n_in=4, hidden=8, n_out=3, tbptt=None, cell=tl.GravesLSTM,
             seed=12):
    b = (tconfig.NeuralNetConfiguration.builder()
         .seed(seed).learning_rate(0.02).updater(tupd.Adam())
         .list()
         .layer(cell(n_in=n_in, n_out=hidden, activation="tanh"))
         .layer(tl.RnnOutputLayer(n_in=hidden, n_out=n_out,
                                  activation="softmax", loss="mcxent")))
    if tbptt:
        b.backprop_type(tconfig.BACKPROP_TBPTT)
        b.t_bptt_forward_length(tbptt).t_bptt_backward_length(tbptt)
    return TNet(b.build(), device="cpu").init()


def _case_output_shape():
    net = _rnn_net()
    x = np.random.default_rng(0).normal(size=(2, 6, 4)).astype(np.float32)
    out = net.output(x).numpy()
    assert out.shape == (2, 6, 3)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def _case_time_step_matches_full_forward():
    net = _rnn_net()
    x = np.random.default_rng(1).normal(size=(3, 7, 4)).astype(np.float32)
    full = net.output(x).numpy()
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(x[:, t:t + 1, :]).numpy() for t in range(7)]
    np.testing.assert_allclose(np.concatenate(steps, axis=1), full,
                               rtol=1e-4, atol=1e-5)
    net.rnn_clear_previous_state()
    again = net.rnn_time_step(x[:, 0:1, :]).numpy()
    np.testing.assert_allclose(again, full[:, 0:1, :], rtol=1e-4, atol=1e-5)


def _case_time_step_chunks():
    net = _rnn_net(cell=tl.GRU)
    x = np.random.default_rng(2).normal(size=(2, 8, 4)).astype(np.float32)
    full = net.output(x).numpy()
    net.rnn_clear_previous_state()
    a = net.rnn_time_step(x[:, :3, :]).numpy()
    b = net.rnn_time_step(x[:, 3:, :]).numpy()
    np.testing.assert_allclose(np.concatenate([a, b], axis=1), full,
                               rtol=1e-4, atol=1e-5)


def _case_tbptt_training_learns_sequence():
    rng = np.random.default_rng(4)
    b, t, v = 8, 24, 3
    tokens = rng.integers(0, v, (b, t + 1))
    x = np.eye(v, dtype=np.float32)[tokens[:, :-1]]
    y = np.eye(v, dtype=np.float32)[tokens[:, 1:]]
    net = _rnn_net(n_in=v, hidden=16, n_out=v, tbptt=8)
    ds = DataSet(x, y)
    net.fit(ds)
    s0 = net.score_
    for _ in range(30):
        net.fit(ds)
    assert net.score_ < s0


def _case_masked_loss_ignores_padding():
    net = _rnn_net()
    rng = np.random.default_rng(5)
    x_short = rng.normal(size=(2, 4, 4)).astype(np.float32)
    y_short = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 4))]
    x_pad = np.concatenate(
        [x_short, rng.normal(size=(2, 3, 4)).astype(np.float32)], 1)
    y_pad = np.concatenate(
        [y_short, np.eye(3, dtype=np.float32)[np.zeros((2, 3), int)]], 1)
    mask = np.concatenate([np.ones((2, 4)), np.zeros((2, 3))], 1)
    s_short = net.score(x=x_short, y=y_short)
    s_pad = net.score(DataSet(x_pad, y_pad, features_mask=mask,
                              labels_mask=mask))
    assert s_short == pytest.approx(s_pad, rel=1e-4)


JAX_RNN_CASES = {
    "output_shape": _case_output_shape,
    "rnn_time_step_matches_full_forward":
        _case_time_step_matches_full_forward,
    "rnn_time_step_chunks": _case_time_step_chunks,
    "tbptt_training_learns_sequence": _case_tbptt_training_learns_sequence,
    "masked_loss_ignores_padding": _case_masked_loss_ignores_padding,
}


@pytest.mark.parametrize("case", list(JAX_RNN_CASES))
def test_jax_rnn_suite_case_on_the_port(case):
    JAX_RNN_CASES[case]()


def test_jax_output_of_a_masked_sequence_matches():
    """A masked GravesLSTM + RnnOutput forward in both packages (the
    masked path through `_gates` with `_mask_carry`)."""
    jnet, tnet = _pair(_char_conf())
    x, _ = _tokens(9)
    m = np.ones((B, T), np.float32)
    m[1, 6:] = 0.0
    np.testing.assert_allclose(tnet.output(x, fmask=m).numpy(),
                               np.asarray(jnet.output(x, fmask=jnp.asarray(
                                   m))), rtol=REL, atol=1e-7)


def test_refusals_name_roadmap_a5():
    # ROADMAP A5 ported pretraining and the solvers: both configs build;
    # what stays is JAX's refusal of a solver under truncated BPTT
    pretrain = MultiLayerConfiguration.from_json(_char_conf().to_json())
    pretrain.pretrain = True
    TNet(pretrain, device="cpu").init()
    lbfgs = MultiLayerConfiguration.from_json(_char_conf().to_json())
    lbfgs.conf.optimization_algo = "lbfgs"
    x = np.eye(V, dtype=np.float32)[
        np.random.default_rng(0).integers(0, V, (2, 2 * L))]
    jnet = JNet(jconfig.MultiLayerConfiguration.from_json(
        lbfgs.to_json())).init()
    for net in (jnet, TNet(lbfgs, device="cpu").init()):
        with pytest.raises(NotImplementedError, match="truncated BPTT"):
            net.fit(x, x)
