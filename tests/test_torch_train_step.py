"""Port parity: the one train-step body (forward, backward, the update in
place, every step-dependent scalar read from the device row that
nn/step_graph.py fills before each step) against the JAX package's
jitted train step.

The same MLP (tanh, l2, a bias lr of its own) on the same params and
the same numpy batch, made from a seed, takes 5 steps on both sides, for
each updater (Sgd, Nesterovs with a momentum schedule, AdamW, AdaGrad,
RmsProp, AdaDelta) and for each lr policy. A scalar frozen at step 0 (a
captured step replays what it recorded) would part from JAX at step 2
at the latest: every case's schedule moves by then.

Tolerances: f32 losses and every param and updater-state value within
1e-6 of the largest |value| of its kind (the two sum the products in
other orders); bf16 within 2^-7 of it (one rounding of the largest value
in another place, a few of them compounding over 5 steps).
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.nn.updater.apply import layer_scalars
from deeplearning4j_tpu_torch.util import model_serializer as tms

JAX_NS = types.SimpleNamespace(conf=jconfig, layers=jlayers, upd=jupd)
TORCH_NS = types.SimpleNamespace(conf=tconfig, layers=tlayers, upd=tupd)
STEPS = 5
F32_REL = 1e-6
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UPDATERS = {
    "sgd": lambda u: u.Sgd(),
    "nesterovs_schedule": lambda u: u.Nesterovs(
        momentum=0.9, momentum_schedule={"2": 0.5, "4": 0.95}),
    "adamw": lambda u: u.Adam(weight_decay=1e-2),
    "adagrad": lambda u: u.AdaGrad(),
    # RMSProp's first steps scale a gradient's absolute error by lr /
    # sqrt(epsilon) where |g| is small (1000x at the default 1e-8): a
    # larger epsilon keeps the comparison on the port, not on that
    "rmsprop": lambda u: u.RmsProp(epsilon=1e-4),
    "adadelta": lambda u: u.AdaDelta(),
}

POLICIES = {
    "none": {},
    "exponential": {"lr_policy_decay_rate": 0.7},
    "inverse": {"lr_policy_decay_rate": 0.3, "lr_policy_power": 0.75},
    "poly": {"lr_policy_power": 2.0, "max_num_iterations": 6},
    "sigmoid": {"lr_policy_decay_rate": 0.8, "lr_policy_steps": 2.0},
    "step": {"lr_policy_decay_rate": 0.5, "lr_policy_steps": 2.0},
    "schedule": {"lr_schedule": {"1": 0.05, "3": 0.02}},
    "warmup_cosine": {"lr_policy_steps": 2.0, "max_num_iterations": 6,
                      "lr_policy_decay_rate": 0.1},
}


def _conf(ns, updater, policy, dtype="float32"):
    b = (ns.conf.NeuralNetConfiguration.builder()
         .seed(11).learning_rate(0.1).bias_learning_rate(0.05)
         .updater(UPDATERS[updater](ns.upd)).regularization(True).l2(1e-3)
         .lr_policy(policy).dtype(dtype))
    for k, v in POLICIES[policy].items():
        b = getattr(b, k)(v)
    L = ns.layers
    return (b.list()
            .layer(L.DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(L.DenseLayer(n_in=16, n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_in=16, n_out=4, activation="softmax",
                                 loss="negativeloglikelihood"))
            .build())


def _pair(updater, policy, dtype="float32"):
    jnet = JNet(_conf(JAX_NS, updater, policy, dtype)).init()
    tnet = TNet(_conf(TORCH_NS, updater, policy, dtype), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    return jnet, tnet


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    gap = float(np.abs(a - b).max(initial=0.0))
    assert gap <= rel * scale, f"{what}: max |diff| {gap} > {rel} x {scale}"


def _train_both(jnet, tnet, x, y, steps, rel):
    for s in range(steps):
        jnet.fit_batch(x, y)
        tnet.fit_batch(x, y)
        _close([tnet.score_], [float(jnet.score_)], rel, f"loss {s}")
    _close(tnet.params_flat(), jnet.params_flat(), rel, "params")
    _close(tnet.updater_state_flat(), jnet.updater_state_flat(), rel,
           "updater state")


@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_each_updater_matches_jax_over_5_steps(updater):
    jnet, tnet = _pair(updater, "exponential")
    x, y = _batch()
    _train_both(jnet, tnet, x, y, STEPS, F32_REL)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_each_lr_policy_matches_jax_over_5_steps(policy):
    jnet, tnet = _pair("adamw", policy)
    x, y = _batch(1)
    _train_both(jnet, tnet, x, y, STEPS, F32_REL)


def test_adam_exponential_reads_every_step_from_the_row():
    """The scalars the body read at each step are the host's values for
    that step: an exponential lr and Adam's corrections move every step,
    and the device row holds this step's, not step 0's."""
    jnet, tnet = _pair("adamw", "exponential")
    x, y = _batch(2)
    rows = []
    for _ in range(STEPS):
        jnet.fit_batch(x, y)
        tnet.fit_batch(x, y)
        rows.append(tnet._graphs.row.numpy().copy())
        _close([tnet.score_], [float(jnet.score_)], F32_REL, "loss")
    for s, row in enumerate(rows):
        want = np.concatenate([np.asarray(layer_scalars(
            lc, tnet.conf.conf, tnet._impls[i].WEIGHT_KEYS, tnet.params[i],
            s), np.float32) for i, lc in enumerate(tnet.conf.layers)])
        np.testing.assert_array_equal(row, want)
    assert not np.array_equal(rows[0], rows[1])
    _close(tnet.params_flat(), jnet.params_flat(), F32_REL, "params")


@pytest.mark.parametrize("updater", ["adamw", "nesterovs_schedule"])
def test_bf16_step_matches_jax(updater):
    jnet, tnet = _pair(updater, "exponential", dtype="bfloat16")
    x, y = _batch(3)
    _train_both(jnet, tnet, x, y, STEPS, BF16_REL)


def test_set_params_flat_between_steps():
    """set_params_flat copies into the params in place (a captured step
    holds their addresses) and the next steps train from the new values,
    as JAX's do."""
    jnet, tnet = _pair("adamw", "step")
    x, y = _batch(4)
    for _ in range(2):
        jnet.fit_batch(x, y)
        tnet.fit_batch(x, y)
    held = [t for lp in tnet.params for t in lp.values()]
    flat = jnet.params_flat() * np.float32(0.5)
    jnet.set_params_flat(flat)
    tnet.set_params_flat(flat)
    assert all(a is b for a, b in zip(
        held, [t for lp in tnet.params for t in lp.values()]))
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    for _ in range(3):
        jnet.fit_batch(x, y)
        tnet.fit_batch(x, y)
        _close([tnet.score_], [float(jnet.score_)], F32_REL, "loss")
    _close(tnet.params_flat(), jnet.params_flat(), F32_REL, "params")
    state = jnet.updater_state_flat()
    tnet.set_updater_state_flat(state)
    np.testing.assert_array_equal(tnet.updater_state_flat(), state)


def test_train_graphs_switch():
    """"on" is the default (the card captures); "off" is the caller's
    choice; anything else is refused. On the CPU both run the body
    eagerly and give the same bits."""
    conf = _conf(TORCH_NS, "adamw", "exponential")
    assert TNet(conf, device="cpu").train_graphs == "on"
    with pytest.raises(ValueError, match="train_graphs"):
        TNet(conf, device="cpu", train_graphs="auto")
    x, y = _batch(5)
    a = TNet(conf, device="cpu").init()
    b = TNet(conf, device="cpu", train_graphs="off").init()
    for _ in range(3):
        a.fit_batch(x, y)
        b.fit_batch(x, y)
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    assert a._graphs.captures == 0 and not a._graphs.capturing
