"""Port parity: tensor-parallel training (ROADMAP A7.2.4).

The cases of JAX tests/test_tensor_parallel.py and test_gqa.py:85 on the
port's `shard_transformer_tp`, on gloo CPU ranks (``devices=["cpu"] *
n``, one torch thread a rank) from module-scoped meshes: {"model": 2},
{"model": 4} and the 2 x 2 {"data", "model"} mesh. Each run is held
against the JAX package's unsharded ComputationGraph on the same params
(`params_from_jax`) and the same one-hot batches, made with numpy from a
seed:

  - 3 `fit_batch` steps at tp = 2 and tp = 4, plain, with l2 and with
    ``clipl2perlayer``: each step's loss within 1e-5 of JAX's, the params
    at rtol 2e-5 / atol 2e-6 (JAX's test's tolerance), the updater state
    within 1e-4 of its largest element;
  - the replicated params (LayerNorms, embedding, output, the row
    layers' biases) hold the same bits on every rank after 3 steps;
  - the collective budget: 4 all-reduces a block on the model axis (2
    forward, 2 backward), one more a step for l2 and one a split layer for
    the clipping's norms, one command a step, no gather;
  - a model zip written after tp training loads in JAX's
    `ModelSerializer` with the params equal;
  - dp x tp on 2 x 2 under the ICI master against JAX's single fit;
  - the GQA fallback, a missing axis, and a captured step.

Every collective carries a 60 s timeout and the fixtures close the
followers.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf.graph import \
    ComputationGraphConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel.tensor_parallel import \
    _tp_specs_for_graph as jspecs
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.zoo import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    _tp_specs_for_graph, param_spec, shard_transformer_tp)
from deeplearning4j_tpu_torch.parallel.trainer import \
    IciDataParallelTrainingMaster
from deeplearning4j_tpu_torch.util import model_serializer as tms

V, T, B = 17, 8, 4
TIMEOUT = 60.0
LOSS_TOL = 1e-5
RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    m = tmesh.make_mesh(shape, ["cpu"] * n, timeout=TIMEOUT)
    yield m.start()
    m.close()


@pytest.fixture(scope="module")
def mesh2():
    yield from _mesh({"model": 2})


@pytest.fixture(scope="module")
def mesh4():
    yield from _mesh({"model": 4})


@pytest.fixture(scope="module")
def mesh22():
    yield from _mesh({"data": 2, "model": 2})


def _data(b=B, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _conf_json(reg="none", **kw):
    """transformer_lm (d 16, 4 heads, 2 blocks) as JSON, with every
    layer's l2 or gradient normalization set."""
    conf = json.loads(jlm(vocab_size=kw.pop("vocab", V), d_model=16,
                          n_heads=4, n_blocks=2, **kw).to_json())
    for v in conf["vertices"].values():
        layer = v.get("layer")
        if layer is None:
            continue
        if reg == "l2":
            layer["l2"] = 1e-2
        elif reg == "clipl2perlayer":
            layer["gradient_normalization"] = "clipl2perlayer"
            layer["gradient_normalization_threshold"] = 0.05
    return json.dumps(conf)


def _pair(text):
    """(JAX graph, port CPU graph with the JAX graph's params)."""
    jnet = JGraph(JConf.from_json(text)).init()
    tnet = TGraph(TConf.from_json(text), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


def _jflat(jnet):
    return np.concatenate([np.asarray(jnet.params[n][p]).reshape(-1)
                           for n in sorted(jnet.params)
                           for p in sorted(jnet.params[n])])


def test_tp_specs_follow_megatron_pairing():
    """JAX :35: the same pairing, entry for entry."""
    jconf = jlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2)
    tconf = tlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=2)
    js, ts = jspecs(jconf, "model"), _tp_specs_for_graph(tconf, "model")
    assert ts["attn0"]["Wq"] == (None, "model")
    assert ts["attn0"]["Wo"] == ("model", None)
    assert ts["ff0"]["W"] == (None, "model")
    assert ts["ff0o"]["W"] == ("model", None)
    assert ts["embed"] == {} and ts.get("out", {}) == {}
    assert {n: {p: tuple(s) for p, s in v.items()} for n, v in js.items()} \
        == ts


@pytest.mark.parametrize("reg", ["none", "l2", "clipl2perlayer"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_training_matches_jax(tp, reg, mesh2, mesh4):
    """JAX :47 over 3 steps: the tp net against JAX's unsharded step, with
    l2 and with per-layer clipping (the split params' norms and l2 terms
    summed over the axis); the replicated params bitwise equal on every
    rank; the collective budget of each step."""
    mesh = mesh2 if tp == 2 else mesh4
    jnet, tnet = _pair(_conf_json(reg))
    shard_transformer_tp(tnet, mesh)
    assert param_spec(tnet, "attn0", "Wq") == (None, "model")
    mesh.reset_counts()
    for step in range(3):
        x, y = _data(seed=step)
        jnet.fit([x], [y])
        tnet.fit_batch([x], [y])
        assert abs(float(jnet.score_) - tnet.score_) <= LOSS_TOL, step
    counts = mesh.query_counts(by_axis=True)
    # 2 forward and 2 backward a block; l2: one sum of the split weights'
    # terms a step; clipping: one squared norm a split layer (6)
    extra = {"none": 0, "l2": 1, "clipl2perlayer": 6}[reg]
    for c in counts:
        assert c["all_reduce@model"] == 3 * (4 * 2 + extra), c
        assert c["broadcast_command"] == 3 and c["all_gather"] == 0, c
    reps = tnet._tp.replicas()
    assert reps.shape[0] == tp
    for r in range(1, tp):
        assert torch.equal(reps[0], reps[r]), r
    np.testing.assert_allclose(tnet.params_flat(), _jflat(jnet),
                               rtol=RTOL, atol=ATOL)
    ju = np.asarray(jnet.updater_state_flat())
    assert np.abs(tnet.updater_state_flat() - ju).max() \
        <= 1e-4 * np.abs(ju).max()
    assert tnet.step == 3


def test_tp_model_zip_loads_in_jax(mesh2, tmp_path):
    """A zip written after tp training: JAX's ModelSerializer reads the
    whole params and updater state; the port reads it back as well."""
    jnet, tnet = _pair(_conf_json())
    shard_transformer_tp(tnet, mesh2)
    for step in range(2):
        x, y = _data(seed=10 + step)
        tnet.fit_batch([x], [y])
        jnet.fit([x], [y])
    path = tmp_path / "tp.zip"
    tms.write_model(tnet, path)
    back = jms.restore_computation_graph(str(path))
    np.testing.assert_allclose(_jflat(back), tnet.params_flat(), rtol=0,
                               atol=0)
    np.testing.assert_allclose(np.asarray(back.updater_state_flat()),
                               tnet.updater_state_flat(), rtol=0, atol=0)
    np.testing.assert_allclose(_jflat(back), _jflat(jnet), rtol=RTOL,
                               atol=ATOL)
    # a whole state set on the driver reaches every rank's slices
    fresh = TGraph(TConf.from_json(_conf_json()), device="cpu").init()
    shard_transformer_tp(fresh, mesh2)
    fresh.set_params_flat(tnet.params_flat())
    fresh.set_updater_state_flat(tnet.updater_state_flat())
    fresh.step = tnet.step
    x, y = _data(seed=12)
    fresh.fit_batch([x], [y])
    tnet.fit_batch([x], [y])
    np.testing.assert_array_equal(fresh.params_flat(), tnet.params_flat())


def _adam_noise_floor(text, x, y):
    """A mask over the flat params: the elements whose first-step
    gradient lies within 100 epsilon of 0, where Adam's step lr g / (|g|
    + eps) is a fraction of lr that the gradient's rounding sets (one
    element of this batch: |g| 2.3e-8 against a largest 2.6e-2)."""
    _, ref = _pair(text)
    _, g = ref.compute_gradient_and_score([x], [y])
    flat = np.concatenate([g[n][p].reshape(-1).numpy() for n in sorted(g)
                           for p in sorted(g[n])])
    return np.abs(flat) < 100 * 1e-8


def test_tp_dp_x_tp_matches_jax_single_fit(mesh22):
    """JAX :74: shard_transformer_tp + the ICI master on a 2 x 2 {data,
    model} mesh equals JAX's single-device fit; the tp split survives the
    master and the gradient all-reduce runs on the data axis. The
    elements on Adam's noise floor (`_adam_noise_floor`) are held to lr;
    the port's own unsharded fit parts from JAX there as well."""
    x, y = _data(b=8, seed=3)
    jnet, tnet = _pair(_conf_json())
    jnet.fit([x], [y])
    noisy = _adam_noise_floor(_conf_json(), x, y)
    assert noisy.sum() <= 4
    shard_transformer_tp(tnet, mesh22)
    master = IciDataParallelTrainingMaster(mesh=mesh22)
    mesh22.reset_counts()
    master.execute_training(tnet, [DataSet(x, y)])
    counts = mesh22.query_counts(by_axis=True)
    assert param_spec(tnet, "attn0", "Wq") == (None, "model")
    for c in counts:
        assert c["all_reduce@data"] == 1, c
        assert c["all_reduce@model"] == 8, c
    got, want = tnet.params_flat(), _jflat(jnet)
    np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[noisy], want[noisy], rtol=0, atol=3e-4)
    assert abs(float(jnet.score_) - tnet.score_) <= LOSS_TOL


def test_gqa_composes_with_tensor_parallel(mesh4):
    """JAX test_gqa.py:85 at tp = 4 (d 8, 4 heads, one KV head of width
    2): Wk/Wv do not divide and stay replicated with JAX's warning, Wq is
    split, and 3 steps match JAX's unsharded step."""
    text = json.dumps(json.loads(JGraph(jlm(
        vocab_size=11, d_model=8, n_heads=4, n_blocks=1, n_kv_heads=1,
        rope=True)).conf.to_json()))
    jnet, tnet = _pair(text)
    with pytest.warns(UserWarning, match="not divisible"):
        shard_transformer_tp(tnet, mesh4)
    assert param_spec(tnet, "attn0", "Wk") == ()
    assert param_spec(tnet, "attn0", "Wq") == (None, "model")
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (2, 5))]
        jnet.fit([x], [x])
        tnet.fit_batch([x], [x])
    assert np.isfinite(tnet.score_)
    assert abs(float(jnet.score_) - tnet.score_) <= LOSS_TOL
    np.testing.assert_allclose(tnet.params_flat(), _jflat(jnet), rtol=RTOL,
                               atol=ATOL)
    reps = tnet._tp.replicas()
    for r in range(1, 4):
        assert torch.equal(reps[0], reps[r]), r


def test_tp_rejects_missing_axis_and_a_captured_step(mesh2):
    """JAX :108: a mesh without the axis raises, before any rank starts;
    a net that captures its step raises naming ROADMAP A7.2.6."""
    net = TGraph(tlm(vocab_size=9, d_model=8, n_heads=2, n_blocks=1),
                 device="cpu").init()
    data_mesh = tmesh.make_mesh({"data": 2}, ["cpu"] * 2)
    with pytest.raises(ValueError, match="no axis"):
        shard_transformer_tp(net, data_mesh)
    assert not data_mesh.alive()
    net._graphs.capturing = True
    with pytest.raises(ValueError, match="A7.2.6"):
        shard_transformer_tp(net, mesh2)
    net._graphs.capturing = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        shard_transformer_tp(net, mesh2)
    with pytest.raises(ValueError, match="already"):
        shard_transformer_tp(net, mesh2)


def test_tp_fit_iterator_and_accumulation_run_on_every_rank(mesh2):
    """fit(iterator) (fused into fit_scan) and fit_batch_accumulated under
    tp equal the same calls on an unsharded port net."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    text = _conf_json()
    _, ref = _pair(text)
    _, tnet = _pair(text)
    shard_transformer_tp(tnet, mesh2)
    x, y = _data(b=8, seed=5)
    for net in (ref, tnet):
        net.scan_batches = 2
        net.fit(ListDataSetIterator(DataSet(x, y), 4))
        net.fit_batch_accumulated([x], [y], 2)
    assert tnet.step == ref.step == 3
    np.testing.assert_allclose(tnet.params_flat(), ref.params_flat(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tnet.output(x)[0].numpy(),
                               ref.output(x)[0].numpy(), rtol=1e-5,
                               atol=1e-6)
