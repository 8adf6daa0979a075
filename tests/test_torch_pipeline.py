"""Port parity: GPipe pipeline parallelism (ROADMAP A7.2.5).

The six cases of JAX tests/test_pipeline.py on the port's
`GPipeExecutor` over a module-scoped {"pipe": 4} mesh of gloo CPU ranks
(one torch thread a rank), each held against JAX's `GPipeExecutor` on
its virtual CPU mesh (tests/conftest.py) and against the sequential
stack, on numpy params and inputs from a seed. The blocks reach the
follower ranks by reference (tests/torch_parallel_fns.py); a lambda
raises. The port computes nothing in the bubble; the degenerate
microbatch still gives finite gradients equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from deeplearning4j_tpu.parallel.pipeline import GPipeExecutor as JGPipe
from deeplearning4j_tpu.parallel.pipeline import \
    stack_block_params as jstack
from deeplearning4j_tpu.parallel.ring import full_attention as jfull
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.pipeline import (GPipeExecutor,
                                                        stack_block_params)

import torch_parallel_fns as fns

S, M, B, D = 4, 4, 16, 8
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipe():
    m = tmesh.make_mesh({"pipe": S}, ["cpu"] * S, timeout=TIMEOUT)
    yield m.start()
    m.close()


def _jblock(params, x):
    return jnp.tanh(x @ params["W"] + params["b"])


def _jmesh():
    return Mesh(np.array(jax.devices()[:S]), ("pipe",))


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    blocks = [{"W": rng.normal(0, 0.5, (D, D)).astype(np.float32),
               "b": rng.normal(0, 0.1, (D,)).astype(np.float32)}
              for _ in range(S)]
    x = rng.normal(size=(B, D)).astype(np.float32)
    return blocks, x


def _t(blocks):
    return stack_block_params([{k: torch.from_numpy(v) for k, v in b.items()}
                               for b in blocks])


def _j(blocks):
    return jstack([{k: jnp.asarray(v) for k, v in b.items()} for b in blocks])


def _mse(y, t):
    return ((y - t) ** 2).mean()


def _jmse(y, t):
    return jnp.mean((y - t) ** 2)


def _seq_grads(fn, blocks, x, target):
    """The sequential stack's loss and stacked gradients, by autograd."""
    ps = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in b.items()}
          for b in blocks]
    y = torch.from_numpy(x)
    for p in ps:
        y = fn(p, y)
    loss = _mse(y, torch.from_numpy(target))
    loss.backward()
    return float(loss.detach()), {
        k: torch.stack([p[k].grad for p in ps]).numpy() for k in ps[0]}


def test_pipeline_forward_matches_sequential(pipe):
    blocks, x = _setup()
    ex = GPipeExecutor(fns.block, S, M, pipe)
    y = ex.apply(ex.shard_params(_t(blocks)), x).numpy()
    seq = torch.from_numpy(x)
    for b in blocks:
        seq = fns.block({k: torch.from_numpy(v) for k, v in b.items()}, seq)
    np.testing.assert_allclose(y, seq.numpy(), atol=1e-5)
    jex = JGPipe(_jblock, S, M, _jmesh())
    np.testing.assert_allclose(
        y, np.asarray(jex.apply(jex.shard_params(_j(blocks)), x)), atol=1e-5)


def test_pipeline_gradients_match_sequential(pipe):
    """The explicit reverse-order backward equals the sequential stack's
    autograd and JAX's pipelined value_and_grad."""
    blocks, x = _setup(1)
    target = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)
    ex = GPipeExecutor(fns.block, S, M, pipe)
    pipe.reset_counts()
    loss, grads = ex.grad_fn(_mse)(ex.shard_params(_t(blocks)), x, target)
    counts = pipe.query_counts(by_axis=True)
    loss_s, grads_s = _seq_grads(fns.block, blocks, x, target)
    assert abs(float(loss) - loss_s) <= 1e-5 * abs(loss_s)
    for k in grads_s:
        np.testing.assert_allclose(grads[k].numpy(), grads_s[k], atol=1e-4)
    jex = JGPipe(_jblock, S, M, _jmesh())
    jl, jg = jex.grad_fn(_jmse)(jex.shard_params(_j(blocks)), x, target)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in grads_s:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-4)
    # stage 1: M activations in, M out, M gradients in, M out
    assert counts[1]["send@pipe"] == 2 * M and counts[1]["recv@pipe"] \
        == 2 * M + 1, counts[1]


def test_pipeline_training_converges(pipe):
    """30 pipelined SGD steps halve the loss, along JAX's curve."""
    blocks, x = _setup(3)
    target = (np.random.default_rng(4).normal(0, 0.3, (B, D))
              .astype(np.float32))
    ex = GPipeExecutor(fns.block, S, M, pipe)
    vg = ex.grad_fn(_mse)
    params = ex.shard_params(_t(blocks))
    jex = JGPipe(_jblock, S, M, _jmesh())
    jvg = jex.grad_fn(_jmse)
    jparams = jex.shard_params(_j(blocks))
    losses, jlosses = [], []
    for _ in range(30):
        loss, grads = vg(params, x, target)
        params = {k: params[k] - 0.5 * grads[k] for k in params}
        losses.append(float(loss))
        jl, jg = jvg(jparams, x, target)
        jparams = jax.tree_util.tree_map(lambda p, g: p - 0.5 * g,
                                         jparams, jg)
        jlosses.append(float(jl))
    assert losses[-1] < losses[0] * 0.5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_pipeline_validates_shapes(pipe):
    """JAX :106-108, :131-141: a batch that does not split, a pre-split
    input of the wrong count, a mesh of another size; and the port's
    rule: a block that cannot reach the followers by reference."""
    blocks, x = _setup()
    ex = GPipeExecutor(fns.block, S, M, pipe)
    with pytest.raises(ValueError, match="not divisible"):
        ex.apply(ex.shard_params(_t(blocks)), x[:6])
    with pytest.raises(ValueError, match="microbatches"):
        ex.apply(ex.shard_params(_t(blocks)), x.reshape(8, 2, D),
                 microbatch=False)
    with pytest.raises(ValueError, match="n_stages"):
        GPipeExecutor(fns.block, S + 1, M, pipe)
    with pytest.raises(ValueError, match="module-level"):
        GPipeExecutor(lambda p, x: x, S, M, pipe)

    def local(p, x):
        return x
    with pytest.raises(ValueError, match="module-level"):
        GPipeExecutor(local, S, M, pipe)


def _jtblock(p, x):
    d, heads = fns.D_T, fns.HEADS_T
    dh = d // heads
    h = (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True) + 1e-5)
    b, t, _ = h.shape
    q = (h @ p["Wq"]).reshape(b, t, heads, dh)
    k = (h @ p["Wk"]).reshape(b, t, heads, dh)
    v = (h @ p["Wv"]).reshape(b, t, heads, dh)
    a = jfull(q, k, v, causal=True).reshape(b, t, d)
    x = x + a @ p["Wo"]
    h2 = (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True) + 1e-5)
    return x + jnp.tanh(h2 @ p["Wf1"]) @ p["Wf2"]


def test_pipeline_transformer_blocks(pipe):
    """JAX :116: GPipe over pre-LN attention + FFN residual blocks
    matches the sequential stack and JAX's pipeline, forward and
    gradients."""
    d, T_, B_ = fns.D_T, 12, 8
    rng = np.random.default_rng(7)

    def g(*s):
        return rng.normal(0, 0.2, s).astype(np.float32)
    blocks = [{"Wq": g(d, d), "Wk": g(d, d), "Wv": g(d, d), "Wo": g(d, d),
               "Wf1": g(d, 4 * d), "Wf2": g(4 * d, d)} for _ in range(S)]
    x = rng.normal(size=(B_, T_, d)).astype(np.float32)
    target = rng.normal(size=(B_, T_, d)).astype(np.float32)
    ex = GPipeExecutor(fns.tblock, S, M, pipe)
    sp = ex.shard_params(_t(blocks))
    y = ex.apply(sp, x).numpy()
    jex = JGPipe(_jtblock, S, M, _jmesh())
    jsp = jex.shard_params(_j(blocks))
    np.testing.assert_allclose(y, np.asarray(jex.apply(jsp, x)), atol=1e-4)
    loss, grads = ex.grad_fn(_mse)(sp, x, target)
    loss_s, grads_s = _seq_grads(fns.tblock, blocks, x, target)
    jl, jg = jex.grad_fn(_jmse)(jsp, x, target)
    assert abs(float(loss) - loss_s) <= 1e-5 * abs(loss_s)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in grads_s:
        np.testing.assert_allclose(grads[k].numpy(), grads_s[k], atol=1e-4)
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-4)


def test_pipeline_degenerate_microbatch_gradients_finite(pipe):
    """JAX :151: an all-zero microbatch through a zero-safe normalized
    block: finite loss and gradients, equal to JAX's (which computes its
    bubbles on a safe input; the port computes nothing there)."""
    d = D
    rng = np.random.default_rng(0)
    blocks = [{"W": rng.normal(0, 0.3, (d, d)).astype(np.float32)}
              for _ in range(S)]
    x = rng.normal(size=(B, d)).astype(np.float32)
    x[:B // M] = 0.0
    target = rng.normal(size=(B, d)).astype(np.float32)
    ex = GPipeExecutor(fns.norm_block, S, M, pipe)
    loss, grads = ex.grad_fn(_mse)(ex.shard_params(_t(blocks)), x, target)
    assert np.isfinite(float(loss))
    for g in grads.values():
        assert torch.isfinite(g).all()

    def jnorm(p, x):
        var = x.var(-1, keepdims=True)
        h = (x - x.mean(-1, keepdims=True)) * jax.lax.rsqrt(var + 1e-5)
        return x + jnp.tanh(h @ p["W"])
    jex = JGPipe(jnorm, S, M, _jmesh())
    jl, jg = jex.grad_fn(_jmse)(jex.shard_params(_j(blocks)), x, target)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_allclose(grads["W"].numpy(), np.asarray(jg["W"]),
                               atol=1e-4)
