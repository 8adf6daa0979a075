"""Port parity: ops (activations, kvquant, the paged-decode kernel module).

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in deeplearning4j_tpu_torch. The paged-decode plain
version is held against both `pallas_kernels._xla_paged_reference` and
the Pallas kernel `_paged_decode_call` run by the Pallas interpreter.
Tolerance for the paged decode: max |diff| < 1e-5 (f32, a different
summation order — the JAX suite's own bound, test_paged_kernel.py).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import kvquant as jkv
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers as thelpers
from deeplearning4j_tpu_torch.ops import kvquant as tkv

OVERFLOW = 1 << 30
REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret():
    """The JAX Pallas kernels through the interpreter, registrations and
    autotune caches cleaned up after (tier-1 shares xdist workers)."""
    pk.enable(interpret=True)
    pk.clear_autotune_cache()
    yield
    pk.clear_autotune_cache()
    pk.disable()


@pytest.mark.parametrize("name", sorted(tact.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(size=(4, 33)).astype(np.float32) * 3
    want = np.asarray(jact.get(name)(jnp.asarray(x)))
    got = tact.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    assert not torch.allclose(tact.gelu(x), torch.nn.functional.gelu(x),
                              atol=1e-5)


@pytest.mark.parametrize("shape", [(5, 2, 8), (3, 7, 4, 16)])
def test_kvquant_bit_exact(shape):
    rng = np.random.default_rng(1)
    a = rng.normal(size=shape).astype(np.float32) * 2
    a[0] = 0.0  # all-zero rows: the scale floor
    jq, js = jkv.quantize_kv_rows(jnp.asarray(a))
    tq, ts = tkv.quantize_kv_rows(torch.from_numpy(a))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.numpy().min() >= -127
    jd = jkv.dequantize_kv_rows(jq, js, jnp.float32)
    td = tkv.dequantize_kv_rows(tq, ts, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def _paged_case(G, quantized, seed=0):
    """B=5 rows, Hkv=2, Dh=16, block=8, nb=4 over a permuted table.
    Depths: 0, a page boundary (7 and 8), full depth (31), and one row at
    the overflow sentinel, which must not fault."""
    rng = np.random.default_rng(seed)
    B, Hkv, Dh, block, nb = 5, 2, 16, 8, 4
    H = Hkv * G
    P = B * nb + 1
    kp = rng.normal(size=(P, block, Hkv, Dh)).astype(np.float32)
    vp = rng.normal(size=(P, block, Hkv, Dh)).astype(np.float32)
    table = (1 + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    pos = np.array([0, 7, 8, nb * block - 1, OVERFLOW], np.int32)
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    ks = vs = None
    if quantized:
        kq, ks = jkv.quantize_kv_rows(jnp.asarray(kp))
        vq, vs = jkv.quantize_kv_rows(jnp.asarray(vp))
        kp, vp, ks, vs = (np.asarray(a) for a in (kq, vq, ks, vs))
    return q, kp, vp, table, pos, ks, vs


def _torch_args(q, kp, vp, table, pos, ks, vs):
    t = [torch.tensor(a) for a in (q, kp, vp, table, pos)]
    kw = {}
    if ks is not None:
        kw = dict(k_scales=torch.tensor(ks), v_scales=torch.tensor(vs))
    return t, kw


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_plain_matches_jax(pallas_interpret, G, quantized):
    q, kp, vp, table, pos, ks, vs = _paged_case(G, quantized)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    jsc = [jnp.asarray(ks), jnp.asarray(vs)] if quantized else [None, None]
    want_ref = np.asarray(pk._xla_paged_reference(*jargs, *jsc))
    want_kernel = np.asarray(pk._paged_decode_call(*jargs, *jsc))
    t, kw = _torch_args(q, kp, vp, table, pos, ks, vs)
    got = ck.paged_decode_attention(*t, **kw).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    assert np.isfinite(got[-1]).all()  # the sentinel row walks nb pages
    live = slice(0, -1)  # the sentinel row is excluded from the comparison
    assert np.abs(got[live] - want_ref[live]).max() < 1e-5
    assert np.abs(got[live] - want_kernel[live]).max() < 1e-5
    ref = ck.paged_decode_attention_ref(*t, **kw).numpy()
    np.testing.assert_array_equal(got, ref)  # CPU tensors: the plain version


def test_wrapper_counts_only_kernel_launches():
    q, kp, vp, table, pos, _, _ = _paged_case(1, False)
    t, _ = _torch_args(q, kp, vp, table, pos, None, None)
    ck.reset_launches()
    ck.paged_decode_attention(*t)
    assert ck.LAUNCHES["paged_decode_attention"] == 0


def test_wrapper_never_falls_back_off_the_cpu():
    q, kp, vp, table, pos, _, _ = _paged_case(1, False)
    t, _ = _torch_args(q, kp, vp, table, pos, None, None)
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="unsupported device"):
        ck.paged_decode_attention(*meta)
    with pytest.raises(ValueError, match="one device"):
        ck.paged_decode_attention(meta[0], *t[1:])


def test_seam_none_arm_matches_jax_semantics():
    q, kp, vp, table, pos, _, _ = _paged_case(2, False)
    t, _ = _torch_args(q, kp, vp, table, pos, None, None)
    assert thelpers.paged_decode_attention(*t, mode="off") is None
    q2 = torch.cat([t[0], t[0]], dim=1)  # T=2: a prefill chunk
    assert thelpers.paged_decode_attention(q2, *t[1:]) is None
    assert thelpers.paged_decode_attention(t[0].double(), *t[1:]) is None
    q3 = t[0][:, :, :3]  # H=3 is not a multiple of Hkv=2
    assert thelpers.paged_decode_attention(q3, *t[1:]) is None
    out = thelpers.paged_decode_attention(*t)
    np.testing.assert_array_equal(
        out.numpy(), ck.paged_decode_attention_ref(*t).numpy())
    seen = []
    thelpers.register_helper("paged_decode_attention",
                             lambda *a, **k: seen.append(1) or a[0])
    try:
        thelpers.paged_decode_attention(*t)
    finally:
        thelpers.register_helper("paged_decode_attention", None)
    assert seen == [1]
    assert thelpers.get_helper("paged_decode_attention") is None


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    code = ("import os, deeplearning4j_tpu_torch.ops.cuda_kernels as ck, "
            "deeplearning4j_tpu_torch.ops._build as b; "
            "assert not b._LIBS; print('ok')")
    env = {"PATH": "/nonexistent"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
