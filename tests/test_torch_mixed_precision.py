"""Port parity: bf16 and mixed-precision training, ComputationGraph and
MultiLayerNetwork.

The graph cases of the JAX package's tests/test_mixed_precision.py, on
the port: with ``compute_dtype="bfloat16"`` the masters and the updater
state stay f32 and the output is bf16; ``compute_dtype`` survives a serde
round trip; "float16" raises ValueError. Then a tiny transformer_lm
(vocab 11, d_model 32, 2 heads, 2 blocks, T 128, B 2; MHA, and RoPE with
n_kv_heads=1) at ``dtype="bfloat16"`` and at ``compute_dtype="bfloat16"``
against the JAX graph on the same params (`params_from_jax`) and the same
one-hot batch made with numpy from a seed. The JAX side binds its
attention seam to the interpreted splash kernel (`_splash_call` under
`helpers.register_helper`; the package itself is unchanged), the port
takes its splash route (`SPLASH_MIN_LEN` lowered to 128), whose CPU path
is the splash kernels' plain versions at bf16. Then bf16 model zips
across the two packages, and the decode paths that now run at bf16.

Tolerances (bf16 compute; measured on this comparison: loss within 1.6e-4
relative, gradients within 1.8e-2 of each leaf's max, bf16 params after
three Adam steps within 2^-9, f32 masters within 1.0e-3, the scores of
those steps within 5.6e-4):
  - train-mode loss: 1e-3 relative;
  - every gradient: max |diff| <= 5e-2 x max |JAX gradient| of the leaf
    (bf16 activations round at other places in the two frameworks, and
    a rounding flipped in one layer moves the gradients below it);
  - three Adam steps (lr 3e-4): bf16 params within 2^-8 (one bf16 ulp at
    1, the params' largest magnitude: LayerNorm gains), f32 masters within
    6 lr (two Adam moves a step apart at most), each step's score within
    2e-3 relative; Adam's f32 moments within 5e-2 of their max.

The CNN cases of the JAX suite (tests/test_mixed_precision.py :17-104)
then run on the port's MultiLayerNetwork: a conv 8 -> BN relu -> 2x2 max
pool -> Dense -> softmax net on 8x8x1 input (whose conv, at kw*c = 3,
takes the plain default on both sides), and the same with a second conv
8 -> 16 after the first, which takes the conv seam's bf16 path. Both at
``dtype="bfloat16"`` and at ``compute_dtype="bfloat16"``, against the JAX
net on the same params (loaded with ``set_params_flat`` from the JAX
net's ``params_flat``, bf16 for a bf16 net) and its Pallas conv and
BN+act+pool kernels interpreted: the forward within 2^-7 of max |JAX|
(one bf16 ulp of the largest output), three SGD steps' scores within
2e-2 relative (bf16 activations round at other places in the two
frameworks, and SGD carries the differences from step to step), and
zips across the two packages with params, updater state and BatchNorm
variables at their dtypes.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.models.sampling import generate_transformer
from deeplearning4j_tpu_torch.models.zoo import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf.config import (MultiLayerConfiguration,
                                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import inputs as tinputs
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                      DenseLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.util import model_serializer as tms

V, T, B, LR = 11, 128, 2, 3e-4
KINDS = {"mha": dict(rope=False, n_kv_heads=None),
         "rope_gqa": dict(rope=True, n_kv_heads=1)}
PRECISIONS = {"bf16": dict(dtype="bfloat16"),
              "mixed": dict(compute_dtype="bfloat16")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n=B, t=T, v=V):
    ids = np.random.default_rng(seed).integers(0, v, (n, t + 1))
    eye = np.eye(v, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _tiny_conf(precision, **kw):
    conf = tlm(vocab_size=13, d_model=16, n_heads=2, n_blocks=1,
               dtype=PRECISIONS[precision].get("dtype", "float32"), **kw)
    conf.conf.compute_dtype = PRECISIONS[precision].get("compute_dtype")
    return conf


# -- the JAX suite's graph cases ---------------------------------------------

@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_graph_trains_with_f32_state_and_bf16_output(precision):
    net = TGraph(_tiny_conf(precision, lr=1e-2), device="cpu").init()
    x, y = _batch(2, n=4, t=9, v=13)
    losses = []
    for _ in range(5):
        net.fit([x], [y])
        losses.append(net.score_)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    pdt = torch.bfloat16 if precision == "bf16" else torch.float32
    assert {p.dtype for lp in net.params.values() for p in lp.values()} \
        == {pdt}
    assert {t.dtype for lu in net.updater_state.values()
            for st in lu.values() for t in st.values()} == {torch.float32}
    assert net.output(x[:2])[0].dtype == torch.bfloat16
    assert net.compute_dtype == torch.bfloat16


def test_mixed_precision_tracks_f32_training():
    x, y = _batch(1, n=4, t=9, v=13)
    scores = {}
    for cd in (None, "bfloat16"):
        conf = tlm(vocab_size=13, d_model=16, n_heads=2, n_blocks=1, lr=1e-2)
        conf.conf.compute_dtype = cd
        net = TGraph(conf, device="cpu").init()
        for _ in range(10):
            net.fit([x], [y])
        scores[cd] = net.score_
    assert abs(scores[None] - scores["bfloat16"]) < 0.1 * max(
        1.0, abs(scores[None]))


def test_compute_dtype_serde_roundtrip():
    conf = _tiny_conf("mixed")
    assert TConf.from_json(conf.to_json()).conf.compute_dtype == "bfloat16"
    mconf = (NeuralNetConfiguration.builder().compute_dtype("bfloat16")
             .list().layer(DenseLayer(n_out=4)).layer(OutputLayer(n_out=2))
             .set_input_type(InputType.feed_forward(3)).build())
    assert MultiLayerConfiguration.from_json(
        mconf.to_json()).conf.compute_dtype == "bfloat16"


def test_unsupported_compute_dtype_raises():
    conf = _tiny_conf("mixed")
    conf.conf.compute_dtype = "float16"
    x, y = _batch(3, n=2, t=9, v=13)
    with pytest.raises(ValueError, match="compute_dtype"):
        TGraph(conf, device="cpu").init().fit([x], [y])


# -- against the JAX graph, on the interpreted splash kernel -----------------

@pytest.fixture
def splash_seams(monkeypatch):
    """Both packages' attention on the splash kernel at T = 128: JAX's seam
    bound to the interpreted library call, the port's route lowered."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    monkeypatch.setattr(helpers, "SPLASH_MIN_LEN", 128)
    jhelpers.register_helper(
        "attention", lambda q, k, v, *, causal=False, scale=None:
        pk._splash_call(q, k, v, causal, scale))
    yield
    jhelpers.register_helper("attention", None)


def _pair(kind, precision):
    jconf = jlm(vocab_size=V, d_model=32, n_heads=2, n_blocks=2, lr=LR,
                dtype=PRECISIONS[precision].get("dtype", "float32"),
                **KINDS[kind])
    jconf.conf.compute_dtype = PRECISIONS[precision].get("compute_dtype")
    jnet = JGraph(jconf).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_gradients_and_three_adam_steps_match_jax(splash_seams, kind,
                                                       precision):
    jnet, tnet = _pair(kind, precision)
    pdt = torch.bfloat16 if precision == "bf16" else torch.float32
    x, y = _batch(1)
    (jl, _), jg = jax.value_and_grad(jnet._build_loss_fn(), has_aux=True)(
        jnet.params, jnet.variables, [jnp.asarray(x)], [jnp.asarray(y)],
        None, None, jax.random.PRNGKey(0))
    tl, tg = tnet.compute_gradient_and_score([x], [y])
    assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl))
    assert set(tg) == set(jg)
    for name in jg:
        for p in jg[name]:
            want = np.asarray(jg[name][p]).astype(np.float32)
            got = tg[name][p]
            assert got.dtype == pdt
            err = np.abs(got.float().numpy() - want).max()
            assert err <= 5e-2 * np.abs(want).max(), f"{name}.{p}: {err}"
    for step in range(3):
        jnet.fit([x], [y])
        tnet.fit([x], [y])
        assert abs(tnet.score_ - float(jnet.score_)) <= 2e-3 * abs(
            float(jnet.score_)), step
    want = np.asarray(jnet.params_flat()).astype(np.float32)
    atol = 2.0 ** -8 if precision == "bf16" else 6 * LR
    assert np.abs(tnet.params_flat() - want).max() <= atol
    # Adam's moments: sums of the gradients' (gated above) and of their
    # squares, f32 on both sides
    ws = np.asarray(jnet.updater_state_flat())
    assert tnet.updater_state_flat().dtype == ws.dtype == np.float32
    assert np.abs(tnet.updater_state_flat() - ws).max() <= 5e-2 * np.abs(
        ws).max()


# -- bf16 zips across the two packages ----------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_bf16_zip_loads_in_the_other_package(tmp_path, direction):
    x, y = _batch(4, n=2, t=9, v=13)
    path = tmp_path / "lm.zip"
    if direction == "jax_to_torch":
        src = JGraph(jlm(vocab_size=13, d_model=16, n_heads=2, n_blocks=1,
                         dtype="bfloat16")).init()
        src.fit([x], [y])
        jms.write_model(src, path)
        dst = tms.restore_model(path, device="cpu")
        assert {p.dtype for lp in dst.params.values()
                for p in lp.values()} == {torch.bfloat16}
    else:
        src = TGraph(_tiny_conf("bf16"), device="cpu").init()
        src.fit([x], [y])
        tms.write_model(src, path)
        dst = jms.restore_model(path)
        assert {a.dtype for lp in dst.params.values()
                for a in lp.values()} == {jnp.dtype(jnp.bfloat16)}
    assert dst.step == src.step == 1
    np.testing.assert_array_equal(
        np.asarray(dst.params_flat()).astype(np.float32),
        np.asarray(src.params_flat()).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(dst.updater_state_flat()),
                                  np.asarray(src.updater_state_flat()))


# -- what stays refused ----------------------------------------------------------

def test_refusals_name_their_roadmap_items():
    # bf16 and mixed MultiLayerNetworks are no longer refused: the bf16
    # conv and BN+act+pool kernels have landed (ROADMAP B2, B3)
    mconf = (NeuralNetConfiguration.builder().dtype("bfloat16").list()
             .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
             .layer(OutputLayer(n_out=2, activation="softmax",
                                loss="negativeloglikelihood"))
             .set_input_type(InputType.convolutional(8, 8, 1)).build())
    assert MultiLayerNetwork(mconf, device="cpu").compute_dtype \
        == torch.bfloat16
    mconf.conf.dtype, mconf.conf.compute_dtype = "float32", "bfloat16"
    assert MultiLayerNetwork(mconf, device="cpu").dtype == torch.float32
    # bf16 decode is no longer refused (ROADMAP A4's first item): the
    # engine, rnn_time_step and the cached generate run a bf16 or mixed
    # net (tests/test_torch_bf16_decode.py holds them against JAX)
    for precision in PRECISIONS:
        net = TGraph(_tiny_conf(precision), device="cpu").init()
        out = net.rnn_time_step(np.eye(13, dtype=np.float32)[[1, 2]][None])
        assert out[0].dtype == torch.bfloat16 and out[0].shape == (1, 2, 13)
        cached = generate_transformer(net, [1, 2, 3], 2, 13, use_cache=True)
        assert len(cached) == 2
        eng = DecodeScheduler(net, 13, n_slots=2, device="cpu").start()
        try:
            assert eng.generate([1, 2, 3], 2, timeout=120) == cached
        finally:
            eng.stop()
        # the uncached path runs at bf16
        assert len(generate_transformer(net, [1, 2, 3], 2, 13)) == 2


# -- MultiLayerNetwork: the CNN cases of the JAX suite -------------------------

JAX_NS = types.SimpleNamespace(conf=jconfig, layers=jlayers, inputs=jinputs,
                               upd=jupd)
TORCH_NS = types.SimpleNamespace(conf=tconfig, layers=tlayers,
                                 inputs=tinputs, upd=tupd)
CNN_KINDS = ("cnn", "cnn_two_convs")


def _cnn_conf(ns, kind="cnn", dtype="float32", compute_dtype=None,
              adam=False):
    """The JAX suite's `_cnn_conf` (:17); "cnn_two_convs" adds a conv 8 ->
    16 after the first, whose kw*c = 24 takes the conv seam's kernel path
    (the first conv's kw*c = 3 declines, as in the JAX package). ``adam``
    trains with Adam at 1e-2 instead of SGD at 0.05, so there is updater
    state to hold."""
    L = ns.layers
    b = (ns.conf.NeuralNetConfiguration.builder()
         .seed(7).learning_rate(1e-2 if adam else 0.05)
         .updater(ns.upd.Adam() if adam else ns.upd.Sgd())
         .dtype(dtype).compute_dtype(compute_dtype).list()
         .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                   padding=(1, 1), activation="identity")))
    if kind == "cnn_two_convs":
        b = b.layer(L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                       padding=(1, 1), activation="identity"))
    return (b.layer(L.BatchNormalization(activation="relu"))
            .layer(L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                      stride=(2, 2)))
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="negativeloglikelihood"))
            .set_input_type(ns.inputs.InputType.convolutional(8, 8, 1))
            .build())


def _img_data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _tnet(kind, precision, adam=False):
    return MultiLayerNetwork(_cnn_conf(TORCH_NS, kind, adam=adam,
                                       **PRECISIONS[precision]),
                             device="cpu").init()


@pytest.mark.parametrize("kind", CNN_KINDS)
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_cnn_trains_with_its_state_at_its_dtype(kind, precision):
    """JAX :42: under mixed precision the masters, the updater state and
    the BN running stats stay f32; at bf16 params and BN variables are
    bf16 and the updater state f32; the output is bf16 either way (with
    Adam, so there is updater state)."""
    x, y = _img_data()
    net = _tnet(kind, precision, adam=True)
    losses = []
    for _ in range(20):
        net.fit(x, y)
        losses.append(net.score_)
    pdt = torch.bfloat16 if precision == "bf16" else torch.float32
    assert {a.dtype for lp in net.params for a in lp.values()} == {pdt}
    assert {a.dtype for lv in net.variables for a in lv.values()} == {pdt}
    assert {a.dtype for lu in net.updater_state for st in lu.values()
            for a in st.values()} == {torch.float32}
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert net.output(x[:4]).dtype == torch.bfloat16


def test_cnn_mixed_precision_tracks_f32_training():
    """JAX :65: bf16 compute follows the f32 trajectory within bf16
    noise."""
    x, y = _img_data(seed=1)
    scores = {}
    for cd in (None, "bfloat16"):
        net = MultiLayerNetwork(_cnn_conf(TORCH_NS, compute_dtype=cd),
                                device="cpu").init()
        for _ in range(10):
            net.fit(x, y)
        scores[cd] = net.score_
    assert abs(scores[None] - scores["bfloat16"]) < 0.1 * max(
        1.0, abs(scores[None]))


def test_cnn_compute_dtype_serde_roundtrip_and_refusal():
    """JAX :87 and :93: compute_dtype survives the JSON round trip, and an
    unsupported one raises ValueError."""
    conf = _cnn_conf(TORCH_NS, compute_dtype="bfloat16")
    assert tconfig.MultiLayerConfiguration.from_json(
        conf.to_json()).conf.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        MultiLayerNetwork(_cnn_conf(TORCH_NS, compute_dtype="float16"),
                          device="cpu").init().fit(*_img_data(n=8))


@pytest.fixture
def pallas_cnn():
    """The JAX conv and BN+act+pool Pallas kernels, interpreted."""
    pk.enable(interpret=True, use_conv=True, use_bn_act_pool=True)
    pk.clear_autotune_cache()
    yield
    pk.clear_autotune_cache()
    pk.disable()


def _cnn_pair(kind, precision):
    jnet = JNet(_cnn_conf(JAX_NS, kind, **PRECISIONS[precision])).init()
    tnet = MultiLayerNetwork(tconfig.MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").init()
    flat = np.asarray(jnet.params_flat())
    if precision == "bf16":
        assert flat.dtype.name == "bfloat16"  # ml_dtypes', not torch's
    tnet.set_params_flat(flat)
    return jnet, tnet


@pytest.mark.parametrize("kind", CNN_KINDS)
@pytest.mark.parametrize("precision", list(PRECISIONS))
def test_cnn_forward_and_three_steps_match_jax(pallas_cnn, kind, precision):
    jnet, tnet = _cnn_pair(kind, precision)
    x, y = _img_data(n=16, seed=3)
    ck.reset_launches()
    want = np.asarray(jnet.output(jnp.asarray(x))).astype(np.float32)
    got = tnet.output(x)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(
        want).max()
    for step in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        assert abs(tnet.score_ - float(jnet.score_)) <= 2e-2 * abs(
            float(jnet.score_)), step
    # on the CPU the wrappers ran their plain versions: no launch
    assert not any(ck.LAUNCHES.values())


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cnn_zip_loads_in_the_other_package(tmp_path, direction, precision):
    """Params, updater state, BN variables and the step cross at their
    dtypes (bf16 BN variables travel as f32 from the port, as ml_dtypes
    bf16 records from JAX)."""
    x, y = _img_data(n=8, seed=4)
    path = tmp_path / "cnn.zip"
    kw = PRECISIONS[precision]
    if direction == "jax_to_torch":
        src = JNet(_cnn_conf(JAX_NS, "cnn_two_convs", adam=True,
                             **kw)).init()
        src.fit(x, y)
        jms.write_model(src, path)
        dst = tms.restore_model(path, device="cpu")
    else:
        src = _tnet("cnn_two_convs", precision, adam=True)
        src.fit(x, y)
        tms.write_model(src, path)
        dst = jms.restore_model(path)
    vdt = "bfloat16" if precision == "bf16" else "float32"
    for net in (src, dst):
        assert {str(a.dtype).replace("torch.", "") for lv in net.variables
                for a in lv.values()} == {vdt}
        assert {str(a.dtype).replace("torch.", "") for lp in net.params
                for a in lp.values()} == {vdt}
    assert dst.step == src.step == 1
    np.testing.assert_array_equal(
        np.asarray(dst.params_flat()).astype(np.float32),
        np.asarray(src.params_flat()).astype(np.float32))
    ws = np.asarray(src.updater_state_flat())
    assert ws.dtype == np.float32 and ws.size > 0
    np.testing.assert_array_equal(np.asarray(dst.updater_state_flat()), ws)
    for a, b in zip(src.variables, dst.variables):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(
                np.asarray(jnp.asarray(a[k], jnp.float32)) if direction ==
                "jax_to_torch" else a[k].float().numpy(),
                np.asarray(jnp.asarray(b[k], jnp.float32)) if direction ==
                "torch_to_jax" else b[k].float().numpy())
