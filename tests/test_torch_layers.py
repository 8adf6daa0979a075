"""Port parity: layers (LayerNorm, gelu Dense, RoPE self-attention, the
paged attention step) against the JAX impls on the same params.

Configs are built in the JAX package and carried to the port through
the shared config JSON; params and inputs are numpy arrays from a seed.
Tolerance: atol 1e-5 (f32, different summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu.nn.conf.layers import (DenseLayer, LayerNormalization,
                                               SelfAttentionLayer)
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu.ops import kvquant as jkv
from deeplearning4j_tpu_torch.nn.conf import serde as tserde
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401 (registers impls)
from deeplearning4j_tpu_torch.nn.layers.base import impl_for as timpl_for

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jconf):
    """(JAX impl, port impl) of one layer config, carried over JSON."""
    tconf = tserde.from_json(jserde.to_json(jconf))
    assert type(tconf).__name__ == type(jconf).__name__
    return jimpl_for(jconf), timpl_for(tconf)


def _params(shapes, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_layernorm_matches_jax():
    jl, tl = _pair(LayerNormalization(n_in=24, n_out=24, eps=1e-3))
    p = _params({"gain": (24,), "beta": (24,)})
    x = _x((2, 5, 24)) * 4 + 1
    want, _ = jl.forward(_j(p), jnp.asarray(x))
    got = tl.forward(_t(p), torch.tensor(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL


def test_gelu_dense_matches_jax():
    jl, tl = _pair(DenseLayer(n_in=16, n_out=64, activation="gelu"))
    p = _params({"W": (16, 64), "b": (64,)})
    x = _x((2, 5, 16))
    want, _ = jl.forward(_j(p), jnp.asarray(x))
    got = tl.forward(_t(p), torch.tensor(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL


def _attn(n_kv_heads, rope=True, d=16, heads=4):
    conf = SelfAttentionLayer(n_in=d, n_out=d, n_heads=heads, causal=True,
                              rope=rope, n_kv_heads=n_kv_heads,
                              activation="identity")
    jl, tl = _pair(conf)
    kv = (n_kv_heads or heads) * (d // heads)
    p = _params({"Wq": (d, d), "Wk": (d, kv), "Wv": (d, kv), "Wo": (d, d),
                 "b": (d,)}, seed=3)
    return jl, tl, p


@pytest.mark.parametrize("n_kv_heads,rope", [(None, True), (2, True),
                                             (None, False)])
def test_attention_forward_matches_jax(n_kv_heads, rope):
    jl, tl, p = _attn(n_kv_heads, rope)
    x = _x((2, 9, 16))
    want, _ = jl.forward(_j(p), jnp.asarray(x))
    got = tl.forward(_t(p), torch.tensor(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL


def _pages(quantized, P, block, Hkv, Dh, seed=5):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(P, block, Hkv, Dh)).astype(np.float32)
    vp = rng.normal(size=(P, block, Hkv, Dh)).astype(np.float32)
    if not quantized:
        return {"k_pages": kp, "v_pages": vp}
    kq, ks = jkv.quantize_kv_rows(jnp.asarray(kp))
    vq, vs = jkv.quantize_kv_rows(jnp.asarray(vp))
    return {"k_pages": np.asarray(kq), "v_pages": np.asarray(vq),
            "k_scales": np.asarray(ks), "v_scales": np.asarray(vs)}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("T", [1, 5])
def test_paged_step_matches_jax(quantized, n_kv_heads, T):
    """T=1 decode (the seam: kernel wrapper on the port, forced XLA gather
    on JAX) and a T=5 prefill chunk, both under a write mask. Rows: a
    masked row, a row at depth 0, a row crossing a page boundary."""
    jl, tl, p = _attn(n_kv_heads)
    block, nb = 8, 4
    heads, d = 4, 16
    Hkv, Dh = (n_kv_heads or heads), d // heads
    B = 3
    P = B * nb + 1
    pages = _pages(quantized, P, block, Hkv, Dh)
    table = (1 + np.random.default_rng(7).permutation(B * nb)).reshape(
        B, nb).astype(np.int32)
    pos = np.array([13, 0, 6], np.int32)
    wmask = np.ones((B, T), bool)
    wmask[0] = False          # an idle slot: its write goes to scratch
    if T > 1:
        wmask[2, T - 1:] = False  # a padded chunk lane
    x = _x((B, T, d), seed=9)
    jst = {**_j(pages), "pos": jnp.asarray(pos), "table": jnp.asarray(table),
           "wmask": jnp.asarray(wmask), "paged_kernel": "off"}
    tst = {**_t(pages), "pos": torch.tensor(pos), "table": torch.tensor(table),
           "wmask": torch.tensor(wmask), "paged_kernel": "on"}
    jy, jout = jl._paged_step(_j(p), jnp.asarray(x), jst)
    ty, tout = tl._paged_step(_t(p), torch.tensor(x), tst)
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < ATOL
    np.testing.assert_array_equal(tout["pos"].numpy(), np.asarray(jout["pos"]))
    for key in pages:
        want = np.asarray(jout[key])
        got = tout[key].numpy()
        if key.endswith("pages") and quantized:
            # int8 codes: a value within 1e-5 of a rounding midpoint may
            # round either way
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            assert (got != want).mean() < 1e-3
        else:
            assert np.abs(got - want).max() < ATOL, key


def test_paged_step_overflow_sentinel():
    """A row whose write passes the table gets NaN output and the absolute
    sentinel position, like the JAX step."""
    jl, tl, p = _attn(None)
    block, nb, B = 8, 2, 2
    pages = _pages(False, B * nb + 1, block, 4, 4)
    table = np.arange(1, B * nb + 1, dtype=np.int32).reshape(B, nb)
    pos = np.array([3, nb * block], np.int32)
    x = _x((B, 1, 16))
    jy, jout = jl._paged_step(_j(p), jnp.asarray(x), {
        **_j(pages), "pos": jnp.asarray(pos), "table": jnp.asarray(table),
        "paged_kernel": "off"})
    ty, tout = tl._paged_step(_t(p), torch.tensor(x), {
        **_t(pages), "pos": torch.tensor(pos), "table": torch.tensor(table)})
    assert np.isnan(ty.numpy()[1]).all() and np.isnan(np.asarray(jy)[1]).all()
    assert np.abs(ty.numpy()[0] - np.asarray(jy)[0]).max() < ATOL
    assert tout["pos"].tolist() == np.asarray(jout["pos"]).tolist() \
        == [4, 1 << 30]
