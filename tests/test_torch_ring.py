"""Port parity: ring and Ulysses attention (ROADMAP A7.2.5).

The cases of JAX tests/test_long_context.py:22-50 on the port's
`ring_attention` and `ulysses_attention` over gloo CPU ranks (one torch
thread a rank) from module-scoped {"seq": 2} and {"seq": 4} meshes,
causal and not, each held against JAX's `full_attention` and JAX's own
`ring_attention` / `ulysses_attention` on its virtual CPU mesh, on
numpy inputs from a seed, at JAX's tolerance (rtol 3e-4, atol 3e-5).
The port's `full_attention` matches JAX's too; the local attention of
Ulysses runs through `ops.helpers.attention` (its plain version on the
CPU); the exchanges are counted; bad shapes raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import ring as jring
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import ring as tring

TIMEOUT = 60.0
RTOL, ATOL = 3e-4, 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    m = tmesh.make_mesh({"seq": n}, ["cpu"] * n, timeout=TIMEOUT)
    yield m.start()
    m.close()


@pytest.fixture(scope="module")
def seq2():
    yield from _mesh(2)


@pytest.fixture(scope="module")
def seq4():
    yield from _mesh(4)


def _qkv(B=2, L=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, L, H, D)).astype(np.float32)
                 for _ in range(3))


def _jfull(q, k, v, causal):
    return np.asarray(jring.full_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    q, k, v = _qkv(seed=1)
    got = tring.full_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal).numpy()
    np.testing.assert_allclose(got, _jfull(q, k, v, causal), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense(causal, n, seq2, seq4):
    """JAX :22 (L 32 over n ranks): against JAX's dense attention and JAX's
    ring on n of its devices; 2 (n - 1) exchanges on each rank."""
    mesh = seq2 if n == 2 else seq4
    q, k, v = _qkv()
    mesh.reset_counts()
    out = tring.ring_attention(q, k, v, mesh, causal=causal)
    counts = mesh.query_counts(by_axis=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), _jfull(q, k, v, causal),
                               rtol=RTOL, atol=ATOL)
    jout = jring.ring_attention(q, k, v, jmesh.make_mesh({"seq": n}),
                                causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    for c in counts[1:]:
        assert c["send@seq"] == 2 * (n - 1) and c["recv@seq"] == 2 * (n - 1) \
            + 3, c


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_dense(causal, seq4):
    """JAX :32 (H 8 over 4 ranks): two all-to-alls around the seam's
    attention at H/4 heads; against JAX's dense and JAX's Ulysses."""
    q, k, v = _qkv(H=8)
    seq4.reset_counts()
    out = tring.ulysses_attention(q, k, v, seq4, causal=causal)
    counts = seq4.query_counts(by_axis=True)
    np.testing.assert_allclose(out.numpy(), _jfull(q, k, v, causal),
                               rtol=RTOL, atol=ATOL)
    jout = jring.ulysses_attention(q, k, v, jmesh.make_mesh({"seq": 4}),
                                   causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    for c in counts:
        assert c["all_to_all@seq"] == 4, c


def test_ring_attention_long_sequence(seq4):
    """JAX :42: L = 512 over the ranks, each holding L/4 keys at a time."""
    q, k, v = _qkv(B=1, L=512, H=2, D=4, seed=3)
    out = tring.ring_attention(q, k, v, seq4, causal=True)
    np.testing.assert_allclose(out.numpy(), _jfull(q, k, v, True),
                               rtol=RTOL, atol=ATOL)


def test_shapes_that_do_not_divide_raise(seq4):
    q, k, v = _qkv(L=30)
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_attention(q, k, v, seq4)
    q, k, v = _qkv(H=6)
    with pytest.raises(ValueError, match="must divide"):
        tring.ulysses_attention(q, k, v, seq4)
