"""Port parity: the splash-attention mask tables, the splash Function over
its kernels' plain versions, and the attention seam's route.

The port's tables (`ops/splash_mask.py`) are held exactly against the JAX
library's `make_splash_mha(...).{fwd,dq,dkv}_mask_info`; the splash
Function over the plain versions (what the CUDA kernels compute, one
chunk of query rows at a time) against the JAX package's `_splash_call`
in the Pallas interpreter, forward and `jax.grad` VJP. Inputs are made
with numpy from a seed. No kernel runs here: on CPU tensors every wrapper
runs its plain version (chip_smoke.py holds the kernels on the card).

Tolerances (f32): the forward at the JAX splash test's own gate (rtol
2e-4, atol 2e-5); gradients within 1e-5 x max |JAX gradient| (sums over
up to 384 keys in another order); the plain splash against the flash
plain version within 1e-6 x max |o| at a head dim whose scale, 1/8, is a
power of two, so folding it into q rounds nothing; `gradcheck` in f64 at
its default tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.splash_attention import \
    splash_attention_kernel as sak
from jax.experimental.pallas.ops.tpu.splash_attention import \
    splash_attention_mask as sam

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers, splash_mask


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


INFOS = ("fwd_mask_info", "dq_mask_info", "dkv_mask_info")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("L", [128, 256, 512, 1024])
def test_tables_equal_the_librarys(L, H, causal):
    head = sam.CausalMask((L, L)) if causal else sam.FullMask((L, L))
    kernel = sak.make_splash_mha(mask=sam.MultiHeadMask([head] * H),
                                 head_shards=1, q_seq_shards=1)
    tables = splash_mask.SplashTables(L, H, causal)
    for name, mine in zip(INFOS, (tables.fwd_info, tables.dq_info,
                                  tables.dkv_info)):
        want = getattr(kernel, name)
        for field in ("block_mask", "data_next"):
            got, ref = getattr(mine, field), np.asarray(getattr(want, field))
            assert got.shape == ref.shape, (name, field)
            np.testing.assert_array_equal(got, ref, err_msg=f"{name}.{field}")
        assert (mine.q_sequence is None) == (want.q_sequence is None)
    assert tables.rows == 1  # one mask shared by every head: one row


def test_causal_tables_at_512_as_the_library_builds_them():
    t = splash_mask.SplashTables(512, 4, True)
    tri = [[1, 0, 0, 0], [2, 1, 0, 0], [2, 2, 1, 0], [2, 2, 2, 1]]
    assert t.fwd_info.block_mask[0].tolist() == tri
    assert t.dkv_info.block_mask[0].tolist() == tri
    assert t.fwd_info.data_next[0].tolist() == [
        [0, 0, 0, 0], [0, 1, 0, 0], [0, 1, 2, 0], [0, 1, 2, 3]]
    # dK/dV: q-block indices, each kv column shrunk to its live q steps
    assert t.dkv_info.data_next[0].tolist() == [
        [0, 0, 0, 0], [1, 1, 0, 0], [2, 2, 2, 0], [3, 3, 3, 3]]
    fwd, dkv = t.lists["fwd"], t.lists["dkv"]
    assert fwd.counts[0].tolist() == [1, 2, 3, 4]  # q block i: kv 0..i
    assert dkv.counts[0].tolist() == [4, 3, 2, 1]  # kv block j: q j..3
    assert fwd.blocks[0, 3].tolist() == [0, 1, 2, 3]
    assert fwd.kinds[0, 3].tolist() == [2, 2, 2, 1]
    assert dkv.blocks[0, 1, :3].tolist() == [1, 2, 3]
    assert dkv.kinds[0, 1, :3].tolist() == [1, 2, 2]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("L", [256, 1024])
def test_block_lists_encode_the_tables(L, causal):
    """The compact lists the kernels walk hold exactly the non-empty blocks
    of the unshrunk table, and each listed block is its data_next."""
    t = splash_mask.SplashTables(L, 2, causal)
    head = splash_mask.CausalMask((L, L)) if causal else \
        splash_mask.FullMask((L, L))
    kinds = head.block_kinds(128, 128)[None]
    for which in ("fwd", "dq", "dkv"):
        np.testing.assert_array_equal(t.block_grid(which), kinds)
    for info, bl, dkv in ((t.fwd_info, t.lists["fwd"], False),
                          (t.dkv_info, t.lists["dkv"], True)):
        bm, dn = info.block_mask[0], info.data_next[0]
        if dkv:
            bm, dn = bm.T, dn.T
        for i in range(bl.counts.shape[1]):
            live = bm[i] != 0
            c = bl.counts[0, i]
            assert c == live.sum()
            np.testing.assert_array_equal(bl.blocks[0, i, :c], dn[i][live])
            np.testing.assert_array_equal(bl.kinds[0, i, :c], bm[i][live])


def test_generic_block_kinds_match_the_closed_forms():
    for mask in (splash_mask.CausalMask((384, 512)),
                 splash_mask.CausalMask((256, 256), offset=64),
                 splash_mask.FullMask((256, 384))):
        np.testing.assert_array_equal(
            mask.block_kinds(128, 128),
            splash_mask.Mask.block_kinds(mask, 128, 128))


def test_per_head_masks_keep_one_row_per_head():
    from jax.experimental.pallas.ops.tpu.splash_attention import \
        splash_attention_mask_info as smi
    L = 512
    jm = sam.MultiHeadMask([sam.CausalMask((L, L)), sam.FullMask((L, L))])
    tm = splash_mask.MultiHeadMask([splash_mask.CausalMask((L, L)),
                                    splash_mask.FullMask((L, L))])
    for dkv in (False, True):
        want, _ = smi._process_mask(jm, (128, 128), dkv)
        got = splash_mask.process_mask(tm, (128, 128), dkv)
        np.testing.assert_array_equal(got.block_mask,
                                      np.asarray(want.block_mask))
        np.testing.assert_array_equal(got.data_next,
                                      np.asarray(want.data_next))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(1, 256, 2, 128), (2, 384, 2, 64)],
                         ids=["1x256x2x128", "2x384x2x64"])
def test_plain_function_matches_jax_splash_kernel_interpreted(shape, causal):
    q, k, v, w = _qkvw(*shape, seed=sum(shape))
    old = pk._INTERPRET
    pk._INTERPRET = True
    try:
        def jloss(q, k, v):
            o = pk._splash_call(q, k, v, causal, None)
            return jnp.sum(o * w), o
        (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        pk._INTERPRET = old
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    n0 = dict(ck.LAUNCHES)
    to = helpers.splash_attention(tq, tk, tv, causal=causal)
    (to * torch.from_numpy(w)).sum().backward()
    assert ck.LAUNCHES == n0  # CPU tensors run the plain versions
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=2e-4, atol=2e-5)
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def _chunked_plain(q_chunk):
    """The splash Function over plain versions that take ``q_chunk`` query
    rows at a time."""
    def apply(q, k, v, *, causal, scale=None):
        return helpers._splash(
            q, k, v, causal, scale,
            functools.partial(ck.splash_attention_fwd_ref, q_chunk=q_chunk),
            functools.partial(ck.splash_attention_bwd_dkv_ref,
                              q_chunk=q_chunk),
            functools.partial(ck.splash_attention_bwd_dq_ref,
                              q_chunk=q_chunk))
    return apply


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_chunked_plain_splash_matches_plain_flash(causal):
    """Four chunks of 128 query rows against the flash Function's plain
    versions (one dense pass): the same function."""
    q, k, v, w = (torch.from_numpy(a) for a in _qkvw(2, 512, 3, 64, seed=5))
    outs = []
    for fn in (_chunked_plain(128), helpers.attention_plain):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*ins, causal=causal)
        (o * w).sum().backward()
        outs.append([o.detach()] + [t.grad for t in ins])
    assert ck._splash_q_chunk(2, 512, 3, 128) == 128
    (o, *grads), (fo, *fgrads) = outs
    assert (o - fo).abs().max() <= 1e-6 * fo.abs().max()
    gmax = max(float(g.abs().max()) for g in fgrads)
    for g, fg in zip(grads, fgrads):
        assert (g - fg).abs().max() <= 1e-6 * gmax
    # one chunk or four: the plain versions sum the same products per row
    one = _chunked_plain(512)(q, k, v, causal=causal)
    torch.testing.assert_close(one, o, rtol=0, atol=1e-6 * float(o.abs().max()))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_function_gradcheck_f64(causal):
    q, k, v, _ = _qkvw(1, 128, 1, 4, seed=7, dtype=np.float64)
    ins = tuple(torch.tensor(a, requires_grad=True) for a in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: helpers.splash_attention_plain(
            q, k, v, causal=causal, scale=0.7), ins)


def test_route_is_splash_from_the_threshold_on():
    assert helpers.SPLASH_MIN_LEN == 32768
    route = helpers.attention_route
    assert route(32768) == route(65536) == "splash"
    assert route(32767) == route(256) == route(1) == "flash"
    assert route(32768 + 64) == "flash"  # L % 128 != 0: the table's block
    assert route(32768 + 128) == "splash"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_seam_takes_the_splash_route_by_shape(monkeypatch, causal):
    """With the threshold lowered to 256, the seam and its plain override
    run the splash Function at L = 256 and flash at 255."""
    monkeypatch.setattr(helpers, "SPLASH_MIN_LEN", 256)
    seen = []
    real = ck.splash_attention_fwd_ref

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(ck, "splash_attention_fwd_ref", spy)
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvw(1, 256, 2, 16, seed=9))
    want = helpers._splash(q, k, v, causal, None, real,
                           ck.splash_attention_bwd_dkv_ref,
                           ck.splash_attention_bwd_dq_ref)
    for fn in (helpers.attention, helpers.attention_plain):
        torch.testing.assert_close(fn(q, k, v, causal=causal), want,
                                   rtol=0, atol=0)
    assert len(seen) == 2
    helpers.attention(q[:, :255], k[:, :255], v[:, :255], causal=causal)
    assert len(seen) == 2


def test_kernel_checks_raise_for_what_the_kernels_do_not_take():
    t = splash_mask.splash_tables(256, 2, True)
    ok = torch.zeros(1, 256, 2, 64)
    assert ck._splash_checks("t", ok, ok, ok, tables=t) == (1, 256, 2, 64)
    ragged = torch.zeros(1, 200, 2, 64)
    with pytest.raises(ValueError, match="multiple of 128"):
        ck._splash_checks("t", ragged, ragged, ragged, tables=t)
    with pytest.raises(ValueError, match="L % 128"):
        helpers.splash_attention(ragged, ragged, ragged, causal=True)
    bad_dim = torch.zeros(1, 256, 2, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        ck._splash_checks("t", bad_dim, bad_dim, bad_dim, tables=t)
    f64 = ok.double()
    with pytest.raises(TypeError, match="dtype"):
        ck._splash_checks("t", f64, f64, f64, tables=t)
    other = torch.zeros(1, 512, 2, 64)
    with pytest.raises(ValueError, match="tables for L=256"):
        ck._splash_checks("t", other, other, other, tables=t)
    with pytest.raises(ValueError, match="one device"):
        ck.splash_attention_fwd(ok, ok, ok.to("meta"), t)
