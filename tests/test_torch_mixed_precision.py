"""Port parity: bf16 and mixed-precision ComputationGraph training.

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
across the two packages, and the paths that stay refused.

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
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
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
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ConvolutionLayer,
                                                      DenseLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
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
    mconf = (NeuralNetConfiguration.builder().dtype("bfloat16").list()
             .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
             .layer(OutputLayer(n_out=2, activation="softmax",
                                loss="negativeloglikelihood"))
             .set_input_type(InputType.convolutional(8, 8, 1)).build())
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        MultiLayerNetwork(mconf, device="cpu")
    mconf.conf.dtype, mconf.conf.compute_dtype = "float32", "bfloat16"
    with pytest.raises(NotImplementedError, match="ROADMAP B2"):
        MultiLayerNetwork(mconf, device="cpu")
    for precision in PRECISIONS:
        net = TGraph(_tiny_conf(precision), device="cpu").init()
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            DecodeScheduler(net, 13, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            net.rnn_time_step(np.eye(13, dtype=np.float32)[[1, 2]][None])
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            generate_transformer(net, [1, 2, 3], 2, 13, use_cache=True)
        # the uncached path runs at bf16
        assert len(generate_transformer(net, [1, 2, 3], 2, 13)) == 2
