"""Port parity: ComputationGraph training of transformer_lm.

A tiny transformer_lm (vocab 11, d_model 32, 2 heads, 2 blocks, T 9, B 3;
MHA, and RoPE with n_kv_heads=1) runs in the JAX package and in the port
on the same params, carried with `params_from_jax`, and the same one-hot
next-token batches, made with numpy from a seed. The JAX side runs its
dense default attention (no helper registered; grouped K/V for GQA); the
port runs its attention seam, whose CPU route is the flash kernels' plain
versions under the seam's autograd Function.

Tolerances (f32):
  - train-mode loss: rtol 1e-6;
  - every parameter gradient: max |diff| <= 1e-4 x max |JAX gradient| of
    that parameter (sums over the batch, time and heads in another order);
  - params after one Adam step, after three fit steps and after fit over
    an iterator or a MultiDataSet: atol 1e-6 (lr 3e-4 times a move of at
    most about 2 per step, Adam's first steps being about +-lr);
  - zip round trips: exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.datasets.iterators import \
    ListDataSetIterator as JListIt
from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models.zoo import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf.config import (BACKPROP_TBPTT,
                                                      NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.optimize.listeners import \
    CollectScoresIterationListener
from deeplearning4j_tpu_torch.util import model_serializer as tms

V, T, B = 11, 9, 3
KINDS = {"mha": dict(rope=False, n_kv_heads=None),
         "rope_gqa": dict(rope=True, n_kv_heads=1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(kind):
    return dict(vocab_size=V, d_model=32, n_heads=2, n_blocks=2,
                **KINDS[kind])


def _pair(kind):
    """(JAX graph, port graph on the CPU with the JAX graph's params)."""
    jnet = JGraph(jlm(**_kw(kind))).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


def _batch(seed, n=B):
    """One-hot next-token inputs and labels [n, T, V] of seeded ids."""
    ids = np.random.default_rng(seed).integers(0, V, (n, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _close_params(tnet, jnet, atol=1e-6):
    np.testing.assert_allclose(tnet.params_flat(), jnet.params_flat(),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_loss_and_every_gradient_match_jax(kind):
    jnet, tnet = _pair(kind)
    x, y = _batch(1)
    loss_fn = jnet._build_loss_fn()
    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(
        jnet.params, jnet.variables, [jnp.asarray(x)], [jnp.asarray(y)],
        None, None, jax.random.PRNGKey(0))
    tl, tg = tnet.compute_gradient_and_score([x], [y])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tg) == set(jg)
    for name in jg:
        assert set(tg[name]) == set(jg[name]), name
        for p in jg[name]:
            want = np.asarray(jg[name][p])
            got = tg[name][p].numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
                f"{name}.{p}"


@pytest.mark.parametrize("kind", list(KINDS))
def test_adam_step_and_three_fit_steps_match_jax(kind):
    jnet, tnet = _pair(kind)
    x, y = _batch(2)
    jnet.fit([x], [y])
    tnet.fit([x], [y])
    assert tnet.step == jnet.step == 1
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=1e-6)
    _close_params(tnet, jnet)
    np.testing.assert_allclose(tnet.updater_state_flat(),
                               jnet.updater_state_flat(), rtol=0, atol=1e-6)
    for s in (3, 4):
        x, y = _batch(s)
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert tnet.step == jnet.step == 3
    _close_params(tnet, jnet)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fit_iterator_and_multidataset_match_jax(kind):
    """fit over a ListDataSetIterator (two minibatches of 3), then one
    MultiDataSet step, on both sides."""
    jnet, tnet = _pair(kind)
    x, y = _batch(5, n=2 * B)
    scores = CollectScoresIterationListener()
    tnet.set_listeners(scores)
    jnet.fit(JListIt(JDataSet(x, y), batch=B))
    tnet.fit(ListDataSetIterator(DataSet(x, y), batch=B))
    assert tnet.step == jnet.step == 2
    assert [i for i, _ in scores.scores] == [1, 2]
    _close_params(tnet, jnet)
    x, y = _batch(6)
    jnet.fit(JMultiDataSet([x], [y]))
    tnet.fit(MultiDataSet([x], [y]))
    assert tnet.step == jnet.step == 3
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=1e-5)
    _close_params(tnet, jnet)


def test_score_matches_jax():
    jnet, tnet = _pair("rope_gqa")
    x, y = _batch(7)
    want = jnet.score(inputs=[x], labels=[y])
    np.testing.assert_allclose(tnet.score(inputs=[x], labels=[y]), want,
                               rtol=1e-6)
    assert tnet.score(DataSet(x, y)) == tnet.score(inputs=[x], labels=[y])


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_graph_zip_with_updater_state_round_trips(tmp_path, direction):
    """Params, Adam state and step carry across bit for bit, and the next
    step taken on each side agrees."""
    jnet, tnet = _pair("rope_gqa")
    x, y = _batch(8)
    path = tmp_path / "lm.zip"
    if direction == "jax_to_torch":
        jnet.fit([x], [y])
        jms.write_model(jnet, path)
        src, dst = jnet, tms.restore_model(path, device="cpu")
        jnext, tnext = jnet, dst
    else:
        tnet.fit([x], [y])
        tms.write_model(tnet, path)
        src, dst = tnet, jms.restore_model(path)
        jnext, tnext = dst, tnet
    assert type(dst).__name__ == "ComputationGraph"
    assert dst.step == src.step == 1
    np.testing.assert_array_equal(dst.params_flat(), src.params_flat())
    np.testing.assert_array_equal(dst.updater_state_flat(),
                                  src.updater_state_flat())
    assert np.abs(src.updater_state_flat()).max() > 0
    x, y = _batch(9)
    jnext.fit([x], [y])
    tnext.fit([x], [y])
    _close_params(tnext, jnext)


def test_fit_on_cpu_lowers_the_loss_and_is_seeded():
    """The README's CPU example: the same seed gives the same losses."""
    x, y = _batch(10, n=4)
    runs = []
    for _ in range(2):
        net = TGraph(tlm(vocab_size=V, d_model=16, n_heads=2, n_blocks=1,
                         lr=1e-2), device="cpu").init()
        losses = []
        for _ in range(4):
            net.fit(x, y)
            losses.append(net.score_)
        runs.append(losses)
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_what_the_slice_leaves_out_raises():
    # truncated BPTT: the builder keeps it, and a TBPTT transformer
    # trains one step per window with its attention layers stateless in
    # every window, as the JAX graph does
    assert NeuralNetConfiguration.builder().graph_builder().backprop_type(
        BACKPROP_TBPTT)._backprop_type == BACKPROP_TBPTT
    x, y = _batch(11)
    jnet, tnet = _pair("mha")
    for net in (jnet, tnet):
        net.conf.backprop_type = BACKPROP_TBPTT
        net.conf.tbptt_fwd_length = 4
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert tnet.step == jnet.step == 3  # windows of 4, 4 and 1 steps
    assert tnet.score_ == pytest.approx(float(jnet.score_), rel=1e-5)
    # the line-search solvers train the graph (ROADMAP A5), eagerly; a
    # solver under truncated BPTT stays refused, as in JAX
    conf = tlm(**_kw("mha"))
    conf.conf.optimization_algo = "lbfgs"
    solved = TGraph(conf, device="cpu").init()
    solved.fit(x, y)
    assert solved.step == 1 and np.isfinite(solved.score_)
    conf.backprop_type = BACKPROP_TBPTT
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        TGraph(conf, device="cpu").fit(x, y)
    conf = tlm(**_kw("mha"))
    conf.conf.compute_dtype = "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        TGraph(conf, device="cpu").init().fit(x, y)
    # gradient accumulation is ported (ROADMAP A5): an indivisible batch
    # is refused as JAX refuses it
    with pytest.raises(ValueError, match="not divisible"):
        TGraph(tlm(**_kw("mha")), device="cpu").fit_batch_accumulated(
            x, y, 2)
