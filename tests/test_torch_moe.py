"""Port parity: expert-parallel MoE (ROADMAP A7.2.5).

The three cases of JAX tests/test_moe.py on the port's `MoEExecutor`
over a module-scoped {"expert": 4} mesh of gloo CPU ranks (one torch
thread a rank), each held against JAX's `MoEExecutor` on its virtual CPU
mesh and against the one-process routing (top-1 gating, JAX's capacity
rule with its dropped tokens), on numpy params and inputs from a seed.
The experts reach the followers by reference
(tests/torch_parallel_fns.py); two all-to-alls a forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from deeplearning4j_tpu.parallel.moe import MoEExecutor as JMoE
from deeplearning4j_tpu.parallel.pipeline import \
    stack_block_params as jstack
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel.moe import MoEExecutor
from deeplearning4j_tpu_torch.parallel.pipeline import stack_block_params

import torch_parallel_fns as fns

E, B, D, H = 4, 32, 8, 16
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_mesh({"expert": E}, ["cpu"] * E, timeout=TIMEOUT)
    yield m.start()
    m.close()


def _jexpert(params, x):
    return jnp.tanh(x @ params["W1"]) @ params["W2"]


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    experts = [{"W1": rng.normal(0, 0.4, (D, H)).astype(np.float32),
                "W2": rng.normal(0, 0.4, (H, D)).astype(np.float32)}
               for _ in range(E)]
    gate_w = rng.normal(0, 0.5, (D, E)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    return experts, gate_w, x


def _t(experts):
    return stack_block_params([{k: torch.from_numpy(v) for k, v in e.items()}
                               for e in experts])


def _jax(experts, gate_w, x, cf):
    jm = JMoE(_jexpert, E, Mesh(np.array(jax.devices()[:E]), ("expert",)),
              capacity_factor=cf)
    js = jm.shard_params(jstack([{k: jnp.asarray(v) for k, v in e.items()}
                                 for e in experts]))
    return jm, js


def _reference(experts, gate_w, x, capacity):
    """The one-process routing, per local shard (JAX's `_reference_moe`)."""
    outs = []
    n_local = x.shape[0] // E
    for dev in range(E):
        xs = torch.from_numpy(x[dev * n_local:(dev + 1) * n_local])
        probs = torch.softmax(xs @ torch.from_numpy(gate_w), -1)
        eidx, gate = probs.argmax(-1), probs.max(-1).values
        counts = [0] * E
        for i in range(n_local):
            e = int(eidx[i])
            if counts[e] < capacity:
                counts[e] += 1
                p = {k: torch.from_numpy(v) for k, v in experts[e].items()}
                outs.append(gate[i] * fns.expert(p, xs[i:i + 1])[0])
            else:
                outs.append(torch.zeros(D))
    return torch.stack(outs).numpy()


def test_moe_matches_reference_routing(mesh):
    experts, gate_w, x = _setup()
    ex = MoEExecutor(fns.expert, E, mesh, capacity_factor=1.0)
    mesh.reset_counts()
    y = ex.apply(ex.shard_params(_t(experts)), gate_w, x).numpy()
    counts = mesh.query_counts(by_axis=True)
    capacity = max(1, int(np.ceil((B // E) / E)))
    assert ex.capacity(B // E) == capacity
    np.testing.assert_allclose(y, _reference(experts, gate_w, x, capacity),
                               atol=1e-5)
    jm, js = _jax(experts, gate_w, x, 1.0)
    np.testing.assert_allclose(y, np.asarray(jm.apply(js, gate_w, x)),
                               atol=1e-5)
    assert (np.abs(y).sum(-1) == 0).any()  # some tokens were dropped
    for c in counts:
        assert c["all_to_all@expert"] == 2, c


def test_moe_generous_capacity_routes_all_tokens(mesh):
    experts, gate_w, x = _setup(1)
    ex = MoEExecutor(fns.expert, E, mesh, capacity_factor=float(E))
    y = ex.apply(ex.shard_params(_t(experts)), gate_w, x).numpy()
    probs = torch.softmax(torch.from_numpy(x @ gate_w), -1).numpy()
    for i in range(B):
        e = int(probs[i].argmax())
        p = {k: torch.from_numpy(v) for k, v in experts[e].items()}
        want = probs[i].max() * fns.expert(
            p, torch.from_numpy(x[i:i + 1]))[0].numpy()
        np.testing.assert_allclose(y[i], want, atol=1e-5)
    jm, js = _jax(experts, gate_w, x, float(E))
    np.testing.assert_allclose(y, np.asarray(jm.apply(js, gate_w, x)),
                               atol=1e-5)


def test_moe_trains_router_and_experts(mesh):
    """Gradients reach every expert and the router through both
    all-to-alls, equal to JAX's; 40 SGD steps along JAX's loss curve."""
    experts, gate_w, x = _setup(2)
    target = (np.random.default_rng(3).normal(0, 0.3, (B, D))
              .astype(np.float32))
    ex = MoEExecutor(fns.expert, E, mesh, capacity_factor=float(E))
    vg = ex.grad_fn(lambda y, t: ((y - t) ** 2).mean())
    params, gw = ex.shard_params(_t(experts)), torch.from_numpy(gate_w)
    jm, jparams = _jax(experts, gate_w, x, float(E))
    jvg = jm.grad_fn(lambda y, t: jnp.mean((y - t) ** 2))
    jgw = jnp.asarray(gate_w)
    losses, jlosses = [], []
    for i in range(40):
        loss, (ge, gg) = vg(params, gw, x, target)
        jl, (jge, jgg) = jvg(jparams, jgw, x, target)
        if i == 0:
            assert all(float(g.abs().sum()) > 0 for g in ge.values())
            for k in ge:
                np.testing.assert_allclose(ge[k].numpy(),
                                           np.asarray(jge[k]), atol=1e-5)
            np.testing.assert_allclose(gg.numpy(), np.asarray(jgg),
                                       atol=1e-5)
        params = {k: params[k] - 0.5 * ge[k] for k in params}
        gw = gw - 0.5 * gg
        jparams = jax.tree_util.tree_map(lambda p, g: p - 0.5 * g, jparams,
                                         jge)
        jgw = jgw - 0.5 * jgg
        losses.append(float(loss))
        jlosses.append(float(jl))
    assert losses[-1] < losses[0] * 0.7
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_moe_validates(mesh):
    experts, gate_w, x = _setup()
    with pytest.raises(ValueError, match="n_experts"):
        MoEExecutor(fns.expert, E + 1, mesh)
    ex = MoEExecutor(fns.expert, E, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        ex.apply(ex.shard_params(_t(experts)), gate_w, x[:30])
    with pytest.raises(ValueError, match="module-level"):
        MoEExecutor(lambda p, x: x, E, mesh)
