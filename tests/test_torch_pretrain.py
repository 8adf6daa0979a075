"""Port parity: layerwise pretraining (nn/layers/pretrain.py,
MultiLayerNetwork.pretrain/finetune) and the zoo's dbn_mnist and
deep_autoencoder_mnist against the JAX package.

JAX draws a Bernoulli as ``uniform(key) < p`` from the i-th of its split
keys; the port's CD-k and corruption take their uniforms through a
``draws`` seam, which these tests feed with JAX's own uniforms from the
same keys, so the gradients compare exactly but for the order of sums.

Tolerances (f32): CD-k gradients and reconstruction errors, the
AutoEncoder loss and its gradients, and one whole pretrain step within
1e-6 of the largest |value| of their kind; the zoo's pretrain-then-
finetune cases are JAX's own (tests/test_zoo_pretrain.py), on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import config as jconfig
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf import config as tconfig
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.nn.layers.base import impl_for as timpl_for
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.util import model_serializer as tms

REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """The uniforms JAX's CD-k (or corruption) draws from ``rng``: draw i
    from the i-th of ``n`` split keys."""

    def __init__(self, rng, n):
        self.keys = jax.random.split(rng, n)

    def uniform(self, i, shape, device):
        return torch.from_numpy(np.asarray(jax.random.uniform(
            self.keys[i], tuple(shape), jnp.float32)))


def _close(a, b, what, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    gap = float(np.abs(a - b).max(initial=0.0))
    assert gap <= rel * scale, f"{what}: max |diff| {gap} > {rel} x {scale}"


def _impls(kind, **kw):
    jconf = getattr(jlayers, kind)(n_in=12, n_out=8, activation="sigmoid",
                                   learning_rate=0.1, **kw)
    tconf = getattr(tlayers, kind)(n_in=12, n_out=8, activation="sigmoid",
                                   learning_rate=0.1, **kw)
    ji, ti = jimpl_for(jconf), timpl_for(tconf)
    jp = ji.init_params(jax.random.PRNGKey(3))
    jp["vb"] = jnp.asarray(np.random.default_rng(4).normal(
        size=(12,)).astype(np.float32) * 0.1)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return ji, ti, jp, tp


def _visible(seed=0, n=16):
    return (np.random.default_rng(seed).uniform(size=(n, 12)) < 0.4).astype(
        np.float32)


@pytest.mark.parametrize("k,hidden,visible", [
    (1, "binary", "binary"), (2, "binary", "binary"),
    (1, "binary", "gaussian"), (1, "rectified", "binary")])
def test_cd_gradient_matches_jax_with_its_draws(k, hidden, visible):
    ji, ti, jp, tp = _impls("RBM", k=k, hidden_unit=hidden,
                            visible_unit=visible)
    v0 = _visible()
    rng = jax.random.PRNGKey(11)
    jg, jrecon = ji.cd_gradient(jp, jnp.asarray(v0), rng)
    tg, trecon = ti.cd_gradient(tp, torch.from_numpy(v0),
                                JaxDraws(rng, 2 * k + 1))
    assert set(tg) == set(jg) == {"W", "b", "vb"}
    for name in jg:
        _close(tg[name].numpy(), jg[name], f"d{name}")
    _close([float(trecon)], [float(jrecon)], "reconstruction error")


@pytest.mark.parametrize("loss", ["reconstruction_crossentropy", "mse"])
def test_autoencoder_loss_at_corruption_0_matches_jax(loss):
    ji, ti, jp, tp = _impls("AutoEncoder", corruption_level=0.0, loss=loss)
    x = np.random.default_rng(1).uniform(size=(16, 12)).astype(np.float32)
    jl, jg = jax.value_and_grad(ji.pretrain_loss)(jp, jnp.asarray(x),
                                                   jax.random.PRNGKey(0))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = ti.pretrain_loss(leaves, torch.from_numpy(x), None)
    tg = torch.autograd.grad(tl, list(leaves.values()))
    _close([float(tl.detach())], [float(jl)], "loss")
    for name, g in zip(leaves, tg):
        _close(g.numpy(), jg[name], f"d{name}")


def test_autoencoder_corruption_takes_jax_draws():
    ji, ti, jp, tp = _impls("AutoEncoder", corruption_level=0.3)
    x = np.random.default_rng(2).uniform(size=(16, 12)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    jl = ji.pretrain_loss(jp, jnp.asarray(x), rng)

    class OneKey:  # JAX corrupts from the key itself, unsplit
        def uniform(self, i, shape, device):
            return torch.from_numpy(np.asarray(jax.random.uniform(
                rng, tuple(shape), jnp.float32)))
    tl = ti.pretrain_loss(tp, torch.from_numpy(x), OneKey())
    _close([float(tl)], [float(jl)], "corrupted loss")


def test_pretrain_step_matches_jax_with_its_draws():
    """One RBM pretrain step of each layer (CD-1, AdamW with the base lr
    for the biases too, the decoupled weight decay) from the same params
    and draws."""
    conf_j = jzoo.dbn_mnist(n_in=12, n_classes=3, hidden=(10, 6), lr=0.3)
    conf_t = tzoo.dbn_mnist(n_in=12, n_classes=3, hidden=(10, 6), lr=0.3)
    for c, upd in ((conf_j, jupd), (conf_t, tupd)):
        for lc in c.layers:
            lc.updater = upd.Adam(weight_decay=1e-2)
            lc.bias_learning_rate = 0.05
    jnet = JNet(conf_j).init()
    tnet = TNet(conf_t, device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        [{k: np.asarray(v) for k, v in lp.items()} for lp in jnet.params]))
    x = _visible(3)[:, :12]
    for i in (0, 1):
        rng = jax.random.PRNGKey(20 + i)
        xi = x
        if i:
            xi = np.asarray(jnet._forward_impl(jnet.params, jnet.variables,
                                               jnp.asarray(x), train=False,
                                               rng=None, upto=1)[0][-1])
        step = jnet._make_pretrain_step(i)
        jnet.params[i], jnet.updater_state[i], jrecon = step(
            jnet.params[i], jnet.updater_state[i], jnp.asarray(0), rng,
            jnp.asarray(xi))
        trecon = tnet._make_pretrain_step(i, draws=JaxDraws(rng, 3))(
            torch.from_numpy(xi))
        _close([float(trecon)], [float(jrecon)], f"layer {i} recon")
        for name in jnet.params[i]:
            _close(tnet.params[i][name].numpy(), jnet.params[i][name],
                   f"layer {i}.{name}")


def test_pretrain_configs_round_trip_json():
    for name in ("dbn_mnist", "deep_autoencoder_mnist"):
        tconf, jconf = getattr(tzoo, name)(), getattr(jzoo, name)()
        assert tconf.to_json() == jconf.to_json()
        back = tconfig.MultiLayerConfiguration.from_json(jconf.to_json())
        assert back.to_json() == tconf.to_json()
        assert jconfig.MultiLayerConfiguration.from_json(
            tconf.to_json()).to_json() == jconf.to_json()


# -- JAX tests/test_zoo_pretrain.py, on the port ------------------------------

def _digits(n=96, d=36, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, (classes, d)) > 0.5
    y = rng.integers(0, classes, n)
    x = (protos[y] ^ (rng.uniform(size=(n, d)) < 0.08)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[y]


def test_dbn_pretrain_finetune():
    x, y = _digits()
    conf = tzoo.dbn_mnist(n_in=36, n_classes=4, hidden=(24, 16), lr=0.3)
    net = TNet(conf, device="cpu").init()
    it = ListDataSetIterator(DataSet(x, y), batch=32)
    net.pretrain(it)
    assert np.isfinite(net.score_)
    assert net.step == 0  # pretraining leaves the step, as in JAX
    losses = []
    for _ in range(60):
        it.reset()
        net.finetune(it)
        losses.append(net.score_)
    assert losses[-1] < losses[0]
    it.reset()
    assert net.evaluate(it).accuracy() > 0.8


def test_deep_autoencoder_reconstruction():
    x, _ = _digits(n=64, d=36)
    conf = tzoo.deep_autoencoder_mnist(n_in=36, bottleneck=8)
    it = ListDataSetIterator(DataSet(x, x), batch=32)
    net = TNet(conf, device="cpu").init()
    net.pretrain(it)
    assert np.isfinite(net.score_)
    losses = []
    for _ in range(40):
        it.reset()
        net.finetune(it)
        losses.append(net.score_)
    assert losses[-1] < losses[0]
    recon = net.output(x[:8]).numpy()
    assert recon.shape == (8, 36)
    assert np.all((recon >= 0) & (recon <= 1))


def test_deep_autoencoder_layer_stack_shapes():
    conf = tzoo.deep_autoencoder_mnist(n_in=36, bottleneck=8)
    dims = [(lc.n_in, lc.n_out) for lc in conf.layers]
    assert dims == [(lc.n_in, lc.n_out) for lc in
                    jzoo.deep_autoencoder_mnist(n_in=36, bottleneck=8).layers]
    assert dims[0][0] == 36 and dims[-1][1] == 36
    widths = [d[1] for d in dims[:3]]
    assert widths == sorted(widths, reverse=True)
    mid = len(dims) // 2
    assert dims[mid - 1][1] == 8 or dims[mid][0] == 8


def test_fit_iterator_pretrains_then_finetunes():
    """fit(iterator) on a pretrain config runs the layerwise pass first
    (JAX multilayer.py :603), then one supervised step a minibatch."""
    x, y = _digits(n=64, d=36)
    conf = tzoo.dbn_mnist(n_in=36, n_classes=4, hidden=(16,), lr=0.3)
    net = TNet(conf, device="cpu").init()
    before = net.params_flat().copy()
    it = ListDataSetIterator(DataSet(x, y), batch=32)
    net.fit(it)
    assert net.step == 2
    assert not np.array_equal(net.params_flat(), before)
