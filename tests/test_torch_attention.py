"""Port parity: the full-sequence attention seam and its flash kernels'
plain versions.

On CPU tensors the seam (`ops.helpers.attention`) runs the autograd
Function of the three flash kernels over their plain versions; on the card
the same Function runs the kernels (chip_smoke.py holds those against the
plain versions). Inputs are made with numpy from a seed.

Tolerances (f32): forward max |diff| <= 1e-6 and gradients <= 1e-5 against
the JAX dense default (sums of at most 33 products of O(1) values, taken
in another order); the splash kernel in the Pallas interpreter at the JAX
test's own gate (rtol 2e-4, atol 2e-5); `gradcheck` in f64 at its default
tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.attention import \
    SelfAttentionLayerImpl
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkvw(B, L, H, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(dtype) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L", [1, 7, 33])
@pytest.mark.parametrize("D", [4, 16])
def test_seam_forward_and_grads_match_jax_default(causal, L, D):
    q, k, v, w = _qkvw(2, L, 3, D, seed=L * 100 + D)

    def jloss(q, k, v):
        o = jhelpers._attention_default(q, k, v, causal=causal)
        return jnp.sum(o * w), o
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    n0 = dict(ck.LAUNCHES)
    to = helpers.attention(tq, tk, tv, causal=causal)
    (to * torch.from_numpy(w)).sum().backward()
    assert ck.LAUNCHES == n0  # CPU tensors run the plain versions
    assert np.abs(to.detach().numpy() - np.asarray(jo)).max() <= 1e-6
    for t, g in zip((tq, tk, tv), jg):
        assert np.abs(t.grad.numpy() - np.asarray(g)).max() <= 1e-5


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_seam_forward_matches_jax_splash_kernel_interpreted(causal):
    """The JAX package's splash kernel in the Pallas interpreter, at its own
    test's shape (tests/test_pallas_kernels.py)."""
    q, k, v, _ = _qkvw(1, 256, 2, 128, seed=0)
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        want = np.asarray(pk._splash_call(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal, None))
    finally:
        pk._INTERPRET = old
    got = helpers.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_kernels_gradcheck_f64(causal):
    q, k, v, _ = _qkvw(2, 5, 2, 3, seed=7, dtype=np.float64)
    ins = tuple(torch.tensor(a, requires_grad=True) for a in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: helpers.attention_plain(q, k, v, causal=causal,
                                                scale=0.7), ins)


def test_plain_forward_is_the_dense_default_and_lse_its_logsumexp():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvw(2, 9, 2, 8, seed=3))
    for causal in (True, False):
        o, lse = ck.flash_attention_fwd(q, k, v, causal=causal, scale=0.25)
        torch.testing.assert_close(
            o, helpers._attention_default(q, k, v, causal=causal, scale=0.25),
            rtol=0, atol=0)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
        if causal:
            s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(),
                              float("-inf"))
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                                   atol=1e-6)
        assert lse.shape == (2, 2, 9)


def test_kernel_checks_raise_for_what_the_kernels_do_not_take():
    ok = torch.zeros(1, 3, 2, 64)
    assert ck._flash_checks("t", ok, ok, ok) == (1, 3, 2, 64)
    bad_dim = torch.zeros(1, 3, 2, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        ck._flash_checks("t", bad_dim, bad_dim, bad_dim)
    f64 = ok.double()
    with pytest.raises(TypeError, match="dtype"):
        ck._flash_checks("t", f64, f64, f64)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 2, 3, 64).transpose(1, 2)
        ck._flash_checks("t", t, t, t)
    with pytest.raises(ValueError, match="one device"):
        ck.flash_attention_fwd(ok, ok, ok.to("meta"), causal=False, scale=1.0)


@pytest.mark.parametrize("n_kv_heads", [None, 1])
def test_layer_forward_goes_through_the_seam_with_repeated_kv(n_kv_heads):
    """GQA's K/V reach the seam repeated to the query heads (head h reads
    kv-head h // G), as the JAX forward passes them to a registered
    attention helper."""
    conf = SelfAttentionLayer(n_in=8, n_out=8, n_heads=4, causal=True,
                              n_kv_heads=n_kv_heads, activation="identity")
    impl = SelfAttentionLayerImpl(conf)
    params = impl.init_params(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 5, 8)).astype(np.float32))
    seen = []

    def spy(q, k, v, *, causal, scale):
        seen.append((q.shape, k.shape, v.shape, causal, scale))
        return helpers.attention_plain(q, k, v, causal=causal, scale=scale)
    helpers.register_helper("attention", spy)
    try:
        y = impl.forward(params, x)
    finally:
        helpers.register_helper("attention", None)
    assert seen == [((2, 5, 4, 2),) * 3 + (True, None)]
    torch.testing.assert_close(y, impl.forward(params, x), rtol=0, atol=0)
    _, k, _ = impl._qkv(params, x)
    kx = impl._expand_kv(k)
    G = 4 // k.shape[2]
    for h in range(4):
        torch.testing.assert_close(kx[:, :, h], k[:, :, h // G])
