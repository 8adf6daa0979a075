"""Port parity: the gradient at an activation's kink, and at a zero logit
of the fused sigmoid + XENT loss (ROADMAP C1).

The port's activations take JAX's subgradients where the function has a
kink: `leakyrelu` slope 1 at 0 (`jax.nn.leaky_relu`'s ``x >= 0``), and
half the slope at each bound of the clips `hardtanh`, `hardsigmoid` and
`rectifiedtanh` (`jnp.clip`/`jnp.maximum` split a tie 0.5/0.5, as torch's
binary `maximum`/`minimum` do). Each is held against `jax.grad` of the
JAX function at its kinks and beside them, exactly.

The fused sigmoid + XENT loss gives the analytic delta sigmoid(z) - y
everywhere. JAX's ``max(z, 0) - z y + log1p(exp(-|z|))`` gives -y at
z = 0 exactly (the kinks of its max and abs), a JAX fault that stays
(ROADMAP C, deliberate differences); away from 0 the two agree within f32
rounding (1e-6 relative here), and at 0 the port's is 0.5 - y.

The training cases: a ComputationGraph whose relu layer is dead (negative
weights, positive inputs, bias 0), so the next layer sees rows of zeros
and, with its bias still 0, a pre-activation of exactly 0. One SGD step
in both packages on the same weights (`params_from_jax`) and data; every
parameter within 1e-5 of that parameter's largest |value|. The
`leakyrelu` graph is held against the JAX graph as it is; the sigmoid +
XENT graph against the JAX graph with its fused loss taken, in this test
process only, to the analytic ``softplus(z) - z y`` (the JAX package's
files are not touched).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.config import \
    NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

KINKS = {
    "leakyrelu": [0.0],
    "hardtanh": [-1.0, 1.0],
    "hardsigmoid": [-2.5, 2.5],
    "rectifiedtanh": [0.0],
}
BESIDE = 1e-3


def _jgrad(name, x):
    return float(jax.grad(lambda v: getattr(jact, name)(v))(jnp.float32(x)))


def _tgrad(name, x):
    t = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    getattr(tact, name)(t).backward()
    return float(t.grad)


@pytest.mark.parametrize("name", sorted(KINKS))
def test_kink_gradient_equals_jax(name):
    pts = []
    for k in KINKS[name]:
        pts += [k, k - BESIDE, k + BESIDE]
    for x in pts:
        assert _tgrad(name, x) == _jgrad(name, x), (name, x)
    expect = {"leakyrelu": 1.0, "hardtanh": 0.5, "hardsigmoid": 0.1,
              "rectifiedtanh": 0.5}[name]
    for k in KINKS[name]:
        assert _tgrad(name, k) == pytest.approx(expect, rel=1e-6)


@pytest.mark.parametrize("name", sorted(KINKS))
def test_kink_values_and_batched_gradient(name):
    """Values and the batched gradient of a tensor holding the kinks among
    random points agree with JAX's elementwise, within f32 rounding (the
    two packages round tanh's derivative, 1 - tanh^2, differently: 1e-6
    absolute on a derivative of at most 1); bf16 keeps the
    dtype."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(scale=3.0, size=61).astype(np.float32),
                        np.asarray(KINKS[name], np.float32)])
    jv = np.asarray(getattr(jact, name)(jnp.asarray(x)))
    jg = np.asarray(jax.grad(
        lambda v: jnp.sum(getattr(jact, name)(v)))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    tv = getattr(tact, name)(t)
    tv.sum().backward()
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-6, atol=1e-6)
    b = getattr(tact, name)(torch.tensor(x).to(torch.bfloat16))
    assert b.dtype == torch.bfloat16


def test_sigmoid_xent_delta():
    """JAX's gradient away from z = 0, and the analytic 0.5 - y at
    z = 0 (JAX's -y there is its fault)."""
    rng = np.random.default_rng(5)
    y = rng.uniform(size=(4, 5)).astype(np.float32)
    z = rng.normal(scale=2.0, size=(4, 5)).astype(np.float32)
    z[z == 0] = 0.5
    jg = np.asarray(jax.grad(lambda l: jloss.sigmoid_xent_from_logits(
        jnp.asarray(y), l))(jnp.asarray(z)))
    zt = torch.tensor(z, requires_grad=True)
    loss = tloss.sigmoid_xent_from_logits(torch.tensor(y), zt)
    loss.backward()
    np.testing.assert_allclose(zt.grad.numpy(), jg, rtol=1e-5, atol=1e-7)
    jl = float(jloss.sigmoid_xent_from_logits(jnp.asarray(y),
                                              jnp.asarray(z)))
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-6)
    z0 = torch.zeros((4, 5), requires_grad=True)
    tloss.sigmoid_xent_from_logits(torch.tensor(y), z0).backward()
    # the mean over the 4 rows: (sigmoid(0) - y) / 4
    np.testing.assert_allclose(z0.grad.numpy(), (0.5 - y) / 4, rtol=1e-6)
    jg0 = np.asarray(jax.grad(lambda l: jloss.sigmoid_xent_from_logits(
        jnp.asarray(y), l))(jnp.zeros((4, 5), jnp.float32)))
    np.testing.assert_allclose(jg0, -y / 4, rtol=1e-6)


def _dead_relu_graph(mid, out_act, loss):
    """in (4) -> h (relu, dead) [-> mid (6)] -> out (3)."""
    g = (JNNC.builder().seed(7).learning_rate(0.1).graph_builder()
         .add_inputs("in")
         .add_layer("h", JDense(n_in=4, n_out=6, activation="relu"), "in"))
    src = "h"
    if mid is not None:
        g = g.add_layer("m", JDense(n_in=6, n_out=6, activation=mid), "h")
        src = "m"
    conf = (g.add_layer("out", JOut(n_in=6, n_out=3, activation=out_act,
                                    loss=loss), src)
            .set_outputs("out").build())
    jnet = JGraph(conf).init()
    params = {k: {n: np.asarray(a) for n, a in lp.items()}
              for k, lp in jnet.params.items()}
    # negative weights on positive inputs: every relu unit dead
    params["h"]["W"] = -np.abs(params["h"]["W"])
    params["h"]["b"] = np.zeros_like(params["h"]["b"])
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TGraph(TConf.from_json(conf.to_json()), device="cpu").init()
    tnet.set_params(params_from_jax(params))
    return jnet, tnet


def _data(out_act):
    rng = np.random.default_rng(11)
    x = rng.uniform(0.1, 1.0, size=(8, 4)).astype(np.float32)
    if out_act == "sigmoid":
        y = rng.integers(0, 2, size=(8, 3)).astype(np.float32)
    else:
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    return x, y


def _analytic_xent(labels, logits, mask=None):
    z = logits.astype(jnp.float32)
    per = jax.nn.softplus(z) - z * labels.astype(jnp.float32)
    return jloss._reduce(jnp.sum(per, axis=-1), mask)


@pytest.mark.parametrize("case", ["sigmoid_xent", "leakyrelu"])
def test_one_step_through_a_dead_relu_layer(case, monkeypatch):
    if case == "sigmoid_xent":
        monkeypatch.setitem(jloss._FUSED_FROM_LOGITS, ("sigmoid", "xent"),
                            _analytic_xent)
        jnet, tnet = _dead_relu_graph(None, "sigmoid", "xent")
        out_act = "sigmoid"
    else:
        jnet, tnet = _dead_relu_graph("leakyrelu", "softmax", "mcxent")
        out_act = "softmax"
    x, y = _data(out_act)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    moved = False
    for name, lp in jnet.params.items():
        for pname, a in lp.items():
            ref = np.asarray(a, np.float64)
            got = tnet.params[name][pname].detach().numpy().astype(np.float64)
            size = max(float(np.abs(ref).max()), 1e-30)
            assert np.abs(got - ref).max() <= 1e-5 * size, (name, pname)
            if pname == "b" and name != "h":
                moved = moved or float(np.abs(ref).max()) > 0
    assert moved  # the step reached the biases behind the kink


@pytest.mark.parametrize("name", sorted(KINKS))
def test_conv_seam_gradient_at_the_kinks(name):
    """The fused conv seam (`ops/helpers.conv2d_bias_act`, the kernel's
    wrapper under an autograd Function) takes the activation's derivative
    from the same module: on zero inputs every pre-activation sits on a
    kink (the bias), and the gradients of x, w and b equal JAX's seam's
    (its XLA default on the CPU)."""
    from deeplearning4j_tpu.ops import helpers as jhelpers
    from deeplearning4j_tpu_torch.ops import helpers as thelpers
    rng = np.random.default_rng(13)
    x = np.zeros((2, 5, 5, 3), np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    b = np.full((4,), KINKS[name][-1], np.float32)
    if name == "hardsigmoid":  # 0.2 z + 0.5 = 1 at the upper bound
        b[:] = 2.5
    g = rng.normal(size=(2, 5, 5, 4)).astype(np.float32)

    def jloss_fn(x_, w_, b_):
        y = jhelpers.conv2d_bias_act(x_, w_, b_, stride=(1, 1),
                                     padding="SAME", activation=name)
        return jnp.sum(y * jnp.asarray(g))
    jgx, jgw, jgb = jax.grad(jloss_fn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = thelpers.conv2d_bias_act(tx, tw, tb, stride=(1, 1), padding="SAME",
                                 activation=name)
    (y * torch.tensor(g)).sum().backward()
    for got, want in ((tx.grad, jgx), (tw.grad, jgw), (tb.grad, jgb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
