"""Port parity: MultiLayerNetwork training of the CNN zoo configurations.

The JAX package's MultiLayerNetwork and the port's run the same configs on
the same parameters and the same numpy inputs, made from a seed. The JAX
side runs its conv and BN+act+pool Pallas kernels in the Pallas
interpreter, so the fused BN+pool pair is engaged on both sides. Dropout
is 0 in the parity copies (the two RNG streams differ); Adam is held
through each updater's `apply` on identical gradients, not a whole-net
step, because its first step is +-lr wherever |g| >> eps and a gradient
near 0 may take either sign on the two sides.

Tolerances (f32):
  - forward outputs: max |diff| < 1e-5 (softmax outputs; sums of at most
    5*5*20 = 500 products per conv output);
  - loss: rtol 1e-6; gradients: rtol 1e-4 with atol 1e-6 (sums over the
    batch and the window positions, taken in another order);
  - BN running stats after one step: rtol 1e-5, atol 1e-7;
  - updater deltas over 5 steps: rtol 1e-5, atol 1e-8;
  - params after one Nesterovs step, and after a two-epoch fit(iterator):
    atol 1e-6 (an lr of 0.01 times the gradient's error);
  - JSON and zip round trips: exact.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JListIt, MultipleEpochsIterator as JEpochs)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    ListDataSetIterator, MultipleEpochsIterator)
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import inputs as tinputs
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresIterationListener
from deeplearning4j_tpu_torch.util import model_serializer as tms

JAX_NS = types.SimpleNamespace(conf=jconfig, layers=jlayers, inputs=jinputs,
                               upd=jupd, zoo=jzoo)
TORCH_NS = types.SimpleNamespace(conf=tconfig, layers=tlayers,
                                 inputs=tinputs, upd=tupd, zoo=tzoo)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_train():
    """The JAX conv and BN+act+pool Pallas kernels, interpreted."""
    pk.enable(interpret=True, use_conv=True, use_bn_act_pool=True)
    pk.clear_autotune_cache()
    yield
    pk.clear_autotune_cache()
    pk.disable()


def _alexnet_narrow(ns):
    """AlexNet-CIFAR10's layer stack at 16x16x3, channels 8/16/16, Dense
    32 without dropout (the zoo config otherwise)."""
    L = ns.layers
    b = (ns.conf.NeuralNetConfiguration.builder()
         .seed(42).learning_rate(1e-3).updater(ns.upd.Adam())
         .regularization(True).l2(1e-4).list())
    for c in (8, 16, 16):
        b = (b.layer(L.ConvolutionLayer(n_out=c, kernel_size=(3, 3),
                                        stride=(1, 1), padding=(1, 1),
                                        activation="identity"))
             .layer(L.BatchNormalization(activation="relu"))
             .layer(L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                       stride=(2, 2))))
    return (b.layer(L.DenseLayer(n_out=32, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax",
                                 loss="negativeloglikelihood"))
            .set_input_type(ns.inputs.InputType.convolutional(16, 16, 3))
            .build())


def _conf(ns, kind):
    if kind == "lenet":  # the zoo config at 16x16: 20/50 conv, Dense 500
        return ns.zoo.lenet_mnist(height=16, width=16)
    return _alexnet_narrow(ns)


def _pair(kind):
    jnet = JNet(_conf(JAX_NS, kind)).init()
    tnet = TNet(_conf(TORCH_NS, kind), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    return jnet, tnet


def _batch(kind, B=4, seed=0):
    rng = np.random.default_rng(seed)
    c = 1 if kind == "lenet" else 3
    x = rng.normal(size=(B, 16, 16, c)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]
    return x, y


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet_mnist", "alexnet_cifar10"])
@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_zoo_json_round_trip(name, direction):
    tconf, jconf = getattr(tzoo, name)(), getattr(jzoo, name)()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    if direction == "torch_to_jax":
        back = jconfig.MultiLayerConfiguration.from_json(tconf.to_json())
    else:
        back = tconfig.MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(tconf.to_json())


def test_set_input_type_infers_n_in_and_preprocessors():
    for name in ("lenet_mnist", "alexnet_cifar10"):
        tc, jc = getattr(tzoo, name)(), getattr(jzoo, name)()
        assert [getattr(l, "n_in", None) for l in tc.layers] == \
            [getattr(l, "n_in", None) for l in jc.layers]
        assert {int(k): type(v).__name__
                for k, v in tc.input_preprocessors.items()} == \
            {int(k): type(v).__name__
             for k, v in jc.input_preprocessors.items()}


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet_mnist", "alexnet_cifar10"])
@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_zoo_model_zip_round_trip(tmp_path, name, direction):
    """Config, params, updater state, BN variables and the step carry
    across bit for bit."""
    path = tmp_path / "net.zip"
    rng = np.random.default_rng(1)
    if direction == "torch_to_jax":
        src = TNet(getattr(tzoo, name)(), device="cpu").init()
        src.set_updater_state_flat(rng.normal(
            size=src.updater_state_flat().size).astype(np.float32))
        for lv in src.variables:
            for k in lv:
                lv[k] = torch.from_numpy(rng.uniform(
                    0.5, 1.5, size=tuple(lv[k].shape)).astype(np.float32))
        src.step = 7
        tms.write_model(src, path)
        dst = jms.restore_multi_layer_network(path)
    else:
        src = JNet(getattr(jzoo, name)()).init()
        src.set_updater_state_flat(rng.normal(
            size=src.updater_state_flat().size).astype(np.float32))
        src.variables = [{k: jnp.asarray(rng.uniform(
            0.5, 1.5, size=v.shape).astype(np.float32))
            for k, v in lv.items()} for lv in src.variables]
        src.step = 7
        jms.write_model(src, path)
        dst = tms.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_array_equal(dst.params_flat(), src.params_flat())
    np.testing.assert_array_equal(dst.updater_state_flat(),
                                  src.updater_state_flat())
    for a, b in zip(src.variables, dst.variables):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert dst.step == 7
    assert json.loads(dst.conf.to_json()) == json.loads(src.conf.to_json())


# -- forward and one train step -----------------------------------------------

@pytest.mark.parametrize("kind", ["lenet", "alexnet"])
def test_forward_matches_jax(kind):
    jnet, tnet = _pair(kind)
    x, _ = _batch(kind, seed=2)
    got = tnet.output(x).numpy()
    want = np.asarray(jnet.output(x))
    assert got.shape == (4, 10)
    assert np.abs(got - want).max() < 1e-5
    # flat NHWC rows are reshaped to the declared input type on both sides
    flat = x.reshape(4, -1)
    assert np.abs(tnet.output(flat).numpy() - want).max() < 1e-5


@pytest.mark.parametrize("kind", ["lenet", "alexnet"])
def test_train_step_loss_grads_and_bn_stats_match_jax(pallas_train, kind):
    jnet, tnet = _pair(kind)
    x, y = _batch(kind, seed=3)
    loss_fn = jnet._build_loss_fn(False, False)
    (jl, (jvars, _)), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jnet.params, jnet.variables, jnp.asarray(x), jnp.asarray(y), None,
        None, jax.random.PRNGKey(0), None)
    tl, tg, tvars = tnet.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for i, (a, b) in enumerate(zip(jg, tg)):
        assert set(a) == set(b), i
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"layer {i} {k}")
    n_bn = 0
    for a, b in zip(jvars, tvars):
        for k in a:
            n_bn += 1
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=1e-5, atol=1e-7)
    assert n_bn == (6 if kind == "alexnet" else 0)


def test_train_step_fuses_each_bn_pool_pair():
    """AlexNet's three BN+pool pairs each run the composite once per
    train step, and never in inference."""
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    _, tnet = _pair("alexnet")
    x, y = _batch("alexnet", seed=4)
    seen = []
    orig = ck.bnap_sums, ck.bnap_dx, ck.conv2d_bias_act
    ck.bnap_sums = lambda *a, **k: seen.append("sums") or orig[0](*a, **k)
    ck.bnap_dx = lambda *a, **k: seen.append("dx") or orig[1](*a, **k)
    ck.conv2d_bias_act = lambda *a, **k: seen.append("conv") or orig[2](*a,
                                                                          **k)
    try:
        tnet.fit_batch(x, y)
        assert sorted(seen) == ["conv"] * 3 + ["dx"] * 3 + ["sums"] * 3
        seen.clear()
        tnet.output(x)
        assert seen == ["conv"] * 3
    finally:
        ck.bnap_sums, ck.bnap_dx, ck.conv2d_bias_act = orig


def test_lenet_nesterovs_step_matches_jax(pallas_train):
    jnet, tnet = _pair("lenet")
    x, y = _batch("lenet", seed=5)
    jnet.fit_batch(x, y)
    tnet.fit_batch(x, y)
    assert tnet.step == jnet.step == 1
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=1e-6)
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnet.updater_state_flat(),
                               jnet.updater_state_flat(), rtol=0, atol=1e-6)


def test_fit_iterator_two_epochs_matches_jax():
    """fit(MultipleEpochsIterator(2, ListDataSetIterator)) takes the same
    4 steps on both sides (the JAX side scans them in one program)."""
    jnet, tnet = _pair("lenet")
    x, y = _batch("lenet", B=8, seed=6)
    jnet.fit(JEpochs(2, JListIt(JDataSet(x, y), batch=4)))
    scores = CollectScoresIterationListener()
    tnet.set_listeners(scores)
    tnet.fit(MultipleEpochsIterator(2, ListDataSetIterator(DataSet(x, y),
                                                           batch=4)))
    assert tnet.step == jnet.step == 4
    assert [i for i, _ in scores.scores] == [1, 2, 3, 4]
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["lenet", "alexnet"])
def test_score_matches_jax(kind):
    jnet, tnet = _pair(kind)
    x, y = _batch(kind, seed=7)
    np.testing.assert_allclose(tnet.score(x=x, y=y), jnet.score(x=x, y=y),
                               rtol=1e-6)
    ds = DataSet(x, y)
    assert tnet.score(ds) == tnet.score(x=x, y=y)


def test_params_flat_round_trip_and_order():
    jnet, tnet = _pair("alexnet")
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())
    flat = np.random.default_rng(8).normal(
        size=tnet.num_params()).astype(np.float32)
    tnet.set_params_flat(flat)
    np.testing.assert_array_equal(tnet.params_flat(), flat)
    with pytest.raises(ValueError):
        tnet.set_params_flat(flat[:-1])


# -- updaters ------------------------------------------------------------------

UPDATERS = [("Sgd", {}), ("NoOp", {}), ("Nesterovs", {"momentum": 0.9}),
            ("Adam", {}), ("AdaGrad", {}), ("AdaDelta", {}),
            ("RmsProp", {}), ("AdaMax", {})]


@pytest.mark.parametrize("name,kw", UPDATERS, ids=[u[0] for u in UPDATERS])
def test_updater_apply_matches_jax(name, kw):
    rng = np.random.default_rng(9)
    p = rng.normal(size=(5, 7)).astype(np.float32)
    ju, tu = getattr(jupd, name)(**kw), getattr(tupd, name)(**kw)
    js, ts = ju.init_state(jnp.asarray(p)), tu.init_state(torch.from_numpy(p))
    assert set(js) == set(ts)
    for step in range(5):
        g = rng.normal(size=p.shape).astype(np.float32)
        jd, js = ju.apply(js, jnp.asarray(g), jnp.float32(0.01),
                          jnp.asarray(step))
        td, ts = tu.apply(ts, torch.from_numpy(g), 0.01, step)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-8, err_msg=f"step {step}")
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, atol=1e-8)


# -- dropout -------------------------------------------------------------------

def test_dense_dropout_is_inverted_and_seeded():
    from deeplearning4j_tpu_torch.nn.layers.base import impl_for
    impl = impl_for(tlayers.DenseLayer(n_in=400, n_out=400,
                                       activation="identity", dropout=0.25))
    x = torch.ones(50, 400)
    a = impl._dropout(x, True, torch.Generator().manual_seed(3))
    b = impl._dropout(x, True, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert impl._dropout(x, False, None) is x


# -- the CLI -------------------------------------------------------------------

def test_cli_train_on_cpu_writes_a_zip_the_jax_package_restores(tmp_path,
                                                                 capsys):
    from deeplearning4j_tpu_torch.cli.main import main
    L = tlayers
    conf = (tconfig.NeuralNetConfiguration.builder()
            .seed(5).learning_rate(0.01).updater(tupd.Nesterovs())
            .list()
            .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                      padding=(1, 1), activation="identity"))
            .layer(L.BatchNormalization(activation="relu"))
            .layer(L.SubsamplingLayer(pooling_type="max"))
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(tinputs.InputType.convolutional(8, 8, 1))
            .build())
    (tmp_path / "net.json").write_text(conf.to_json())
    rng = np.random.default_rng(10)
    rows = np.concatenate([rng.normal(size=(10, 64)).round(3),
                           rng.integers(0, 10, (10, 1))], axis=1)
    np.savetxt(tmp_path / "d.csv", rows, delimiter=",", fmt="%g")
    out = tmp_path / "m.zip"
    rc = main(["train", "--conf", str(tmp_path / "net.json"), "--input",
               str(tmp_path / "d.csv"), "--output", str(out), "--batch", "4",
               "--epochs", "2", "--num-classes", "10", "--print-every", "1",
               "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "Score at iteration 6 is" in printed and "Model saved" in printed
    jnet = jms.restore_multi_layer_network(out)
    assert jnet.step == 6
    tnet = tms.restore_multi_layer_network(out, device="cpu")
    np.testing.assert_array_equal(jnet.params_flat(), tnet.params_flat())


# -- weight init ---------------------------------------------------------------

SCHEMES = ["zero", "ones", "size", "uniform", "normalized", "vi", "xavier",
           "xavier_uniform", "relu", "relu_uniform", "lecun",
           "distribution"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_weight_scheme_matches_jax_by_distribution(scheme):
    """The two RNGs cannot match bit for bit: the mean and std of a
    [3, 3, 64, 128] conv kernel drawn by each side agree to 3% of the
    JAX std (the sampling error of 73,728 draws is about 0.5%)."""
    from deeplearning4j_tpu.nn import weights as jw
    from deeplearning4j_tpu_torch.nn import weights as tw
    dist = {"type": "normal", "mean": 0.5, "std": 2.0}
    shape = (3, 3, 64, 128)
    jv = np.asarray(jw.init_weights(jax.random.PRNGKey(0), shape, scheme,
                                    distribution=dist))
    tv = tw.init_weights(torch.Generator().manual_seed(0), shape, scheme,
                         distribution=dist).numpy()
    assert tv.shape == shape and tv.dtype == np.float32
    tol = 0.03 * max(float(jv.std()), 1e-12)
    assert abs(float(tv.std()) - float(jv.std())) <= tol
    assert abs(float(tv.mean()) - float(jv.mean())) <= tol
