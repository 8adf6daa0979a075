"""Port parity: the CNN training kernels' seams at bf16 (conv2d_bias_act and
bn_act_pool) against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed and rounded to bf16, go through
the JAX seam with its Pallas kernels run by the Pallas interpreter
(`pallas_kernels.enable(interpret=True, ...)`) and through the port's
seam, whose kernel wrappers run their plain PyTorch versions on CPU
tensors: what the bf16 CUDA kernels compute on the card.

The JAX BN+act+pool kernel path computes the batch stats in f32 (one pass
for a bf16 x), z in f32, and rounds act(z) to bf16 only before the 2x2
max; its backward compares the window's ties after the same rounding. Its
unregistered default computes z in bf16 and routes ties through
select-and-scatter, so it is not the reference here.

Tolerances, over each output's max |JAX value| (M):
  - bf16 outputs (pooled, conv output, dx): max |diff| <= 2^-7 M (one bf16
    ulp of the largest element: the two sides sum in f32 in other orders,
    so a rounding may flip) and mean |diff| <= 1e-3 M;
  - the f32 batch stats: 1e-5 absolute (f32 sums of 512 terms);
  - d gamma, d beta (bf16 parameters): one bf16 ulp of M;
  - the conv's dx, dw, db: mean |diff| <= 1e-2 M against JAX, and max
    |diff| <= 2^-6 of the max of the f64 gradient of the same bf16 inputs
    (the port's is within 2e-3 of it). JAX is not held to the f64 bound:
    its gradient is the VJP of its XLA default, which rounds conv(x, w) to
    bf16 before the bias, so where z rounds to exactly 0 there its relu
    derivative differs from the port's, which takes it at the kernel's
    pre-activation, rounded once (on these inputs JAX's relu dx at stride
    2 is 0.25 of its max from f64; ROADMAP C, deliberate differences).
The plain versions at bf16 are also held against f64 computations with the
JAX kernels' rounding rule (one rounding to bf16 at the end), and the tie
rule on windows whose f32 activations differ but tie once rounded.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import activations
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers as thelpers

BF = torch.bfloat16
ULP7, MEAN, GRAD_MEAN, STATS = 2.0 ** -7, 1e-3, 1e-2, 1e-5
GRAD_F64 = 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_bnap():
    """The JAX bn_act_pool seam through its Pallas kernels, interpreted."""
    pk.enable(interpret=True, use_bn_act_pool=True)
    yield
    pk.disable()


@pytest.fixture
def pallas_conv():
    """The JAX conv seam through its Pallas kernel, interpreted."""
    pk.enable(interpret=True, use_conv=True)
    yield
    pk.disable()


def _np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(
        a, jax.Array) else a.detach().float().numpy()


def _close_bf16(got, want, what, max_rel=ULP7, mean_rel=MEAN):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    diff = np.abs(got - want)
    assert diff.max() <= max_rel * scale, (what, diff.max(), scale)
    assert diff.mean() <= mean_rel * scale, (what, diff.mean(), scale)


def _ulp(v):
    """One bf16 ulp at magnitude v: 2^(floor(log2 v) - 7)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


# -- BN + activation + 2x2/s2 max-pool ---------------------------------------

def _bnap_inputs(seed, shape=(8, 8, 8, 16)):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    gamma = (rng.normal(size=(C,)) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    return x, gamma, beta


def _pool_weights(shape):
    """The loss sum(pooled * w), w = (flat index mod 7): a cotangent whose
    routing through the pool, BN and the activation is easy to get wrong."""
    B, H, W, C = shape
    n = B * (H // 2) * (W // 2) * C
    return (np.arange(n) % 7).reshape(B, H // 2, W // 2, C).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_bn_act_pool_bf16_matches_the_jax_kernel(pallas_bnap, activation,
                                                 seed):
    """The composite at bf16: the pooled output, the f32 batch stats, and
    dx, d gamma, d beta under the loss sum(pooled * (i mod 7))."""
    x, gamma, beta = _bnap_inputs(seed)
    w = _pool_weights(x.shape)
    jx, jg, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, gamma, beta))

    def jloss(x, g, b):
        p, _, _ = jhelpers.bn_act_pool(x, g, b, eps=1e-5,
                                       activation=activation)
        return jnp.sum(p.astype(jnp.float32) * w)
    jp, jm, jv = jhelpers.bn_act_pool(jx, jg, jb, eps=1e-5,
                                      activation=activation)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jx, jg, jb)

    tx, tg, tb = (torch.from_numpy(a).to(BF).requires_grad_(True)
                  for a in (x, gamma, beta))
    assert thelpers.bnap_kernel_applies(tx, activation)
    tp, tm, tv = thelpers.bn_act_pool(tx, tg, tb, eps=1e-5,
                                      activation=activation)
    (tp.float() * torch.from_numpy(w)).sum().backward()

    assert tp.dtype == BF and tx.grad.dtype == BF
    assert tm.dtype == tv.dtype == torch.float32
    assert jm.dtype == jv.dtype == jnp.float32
    _close_bf16(tp, jp, "pooled")
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=STATS)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=STATS)
    _close_bf16(tx.grad, jgrads[0], "dx")
    for t, j, what in ((tg.grad, jgrads[1], "dgamma"),
                       (tb.grad, jgrads[2], "dbeta")):
        assert t.dtype == BF
        jw = _np32(j)
        assert np.abs(_np32(t) - jw).max() <= _ulp(np.abs(jw).max()), what


def test_bnap_forward_ref_keeps_its_f32_bits():
    """At f32 the repaired forward is the formula it had before: torch's
    two-pass stats, z in f32, no rounding before the max."""
    x, gamma, beta = (torch.from_numpy(a) for a in _bnap_inputs(5))
    pooled, mean, var, inv = ck.bnap_forward_ref(x, gamma, beta, eps=1e-5,
                                                 activation="tanh")
    m = torch.mean(x, dim=(0, 1, 2))
    v = torch.var(x, dim=(0, 1, 2), unbiased=False)
    i = torch.rsqrt(v + 1e-5)
    a = torch.tanh((x - m) * i * gamma + beta)
    want = a.reshape(8, 4, 2, 4, 2, 16).amax(dim=(2, 4))
    for got, ref in ((pooled, want), (mean, m), (var, v), (inv, i)):
        assert torch.equal(got, ref)


# -- the conv seam ----------------------------------------------------------------

def _conv_inputs(seed, B=4, hw=8, C=16, OC=32, K=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, hw, hw, C)).astype(np.float32)
    w = (rng.normal(size=(K, K, C, OC)) / np.sqrt(K * K * C)).astype(
        np.float32)
    b = (rng.normal(size=(OC,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("stride", [(1, 1), (2, 2)])
@pytest.mark.parametrize("activation", ["identity", "relu", "tanh"])
def test_conv_bf16_matches_the_jax_kernel(pallas_conv, activation, stride):
    """[4, 8, 8, 16] -> 32, 3x3 SAME: the output and dx, dw, db."""
    x, w, b = _conv_inputs(10 + stride[0])
    kw = dict(stride=stride, padding="SAME", activation=activation)
    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    jy = jhelpers.conv2d_bias_act(jx, jw, jb, **kw)
    gy = np.random.default_rng(20).normal(size=jy.shape).astype(np.float32)
    gy = np.asarray(jnp.asarray(gy, jnp.bfloat16), np.float32)
    jgrads = jax.vjp(lambda x, w, b: jhelpers.conv2d_bias_act(
        x, w, b, **kw), jx, jw, jb)[1](jnp.asarray(gy, jnp.bfloat16))

    tx, tw, tb = (torch.from_numpy(a).to(BF).requires_grad_(True)
                  for a in (x, w, b))
    assert thelpers.conv_kernel_applies(tw, (1, 1))
    ty = thelpers.conv2d_bias_act(tx, tw, tb, **kw)
    ty.backward(torch.from_numpy(gy).to(BF))
    assert ty.dtype == BF and jy.dtype == jnp.bfloat16
    _close_bf16(ty, jy, "y")
    # the exact gradient of the same bf16 inputs and cotangent
    ins64 = [torch.from_numpy(a).to(BF).double().requires_grad_(True)
             for a in (x, w, b)]
    z64 = ck.conv2d_ref(ins64[0], ins64[1], stride=stride,
                        padding="SAME") + ins64[2]
    activations.get(activation)(z64).backward(torch.from_numpy(gy).double())
    for t, j, g64, what in zip((tx.grad, tw.grad, tb.grad), jgrads, ins64,
                               ("dx", "dw", "db")):
        assert t.dtype == BF
        jw, ref = _np32(j), g64.grad.numpy()
        assert np.abs(_np32(t) - jw).mean() <= GRAD_MEAN * np.abs(jw).max()
        port_err = np.abs(_np32(t) - ref).max()
        assert port_err <= GRAD_F64 * np.abs(ref).max(), (
            what, port_err, np.abs(ref).max())


@pytest.mark.parametrize("activation", ["identity", "relu", "softmax"])
def test_conv_plain_override_is_the_plain_default_at_f32(activation):
    """The override that stands in for the conv kernel is differentiated
    by autograd, not by the kernel seam's own backward: at f32 it gives the
    plain default's output and gradients bit for bit."""
    x, w, b = _conv_inputs(6, C=8)
    kw = dict(stride=(2, 2), padding="SAME", dilation=(1, 1),
              activation=activation)
    gy = torch.from_numpy(np.random.default_rng(7).normal(
        size=(4, 4, 4, 32)).astype(np.float32))
    outs = []
    for fn in (thelpers.conv2d_bias_act_plain,
               thelpers._conv2d_bias_act_default):
        ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
        y = fn(*ins, **kw)
        y.backward(gy)
        outs.append([y.detach()] + [t.grad for t in ins])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_conv_seam_bf16_reaches_the_kernel_wrapper():
    """A bf16 conv the kernel applies to goes through the wrapper, which
    on the CPU runs the plain version and counts no launch."""
    x, w, b = (torch.from_numpy(a).to(BF) for a in _conv_inputs(3))
    seen = []
    orig = ck.conv2d_bias_act
    ck.conv2d_bias_act = lambda *a, **k: seen.append(a[0].dtype) or orig(
        *a, **k)
    ck.reset_launches()
    try:
        y = thelpers.conv2d_bias_act(x, w, b, activation="relu")
    finally:
        ck.conv2d_bias_act = orig
    assert seen == [BF] and y.dtype == BF
    assert ck.LAUNCHES["conv2d_bias_act_bf16"] == ck.LAUNCHES[
        "conv2d_bias_act"] == 0


# -- the plain versions against f64 with the kernels' rounding rule ------------

def _conv_f64(x, w, b, stride, padding, activation):
    z = ck.conv2d_ref(x.double(), w.double(), stride=stride,
                      padding=padding) + b.double()
    return activations.get(activation)(z), z


@pytest.mark.parametrize("activation", ["identity", "relu", "sigmoid",
                                        "swish"])
def test_conv_plain_bf16_rounds_once_at_the_end(activation):
    """conv2d_bias_act_ref at bf16 against the f64 conv, bias and
    activation of the same bf16 inputs, rounded to bf16 once: the two
    differ only where the f32 sums cross a rounding boundary, by one ulp of
    the element; an extra rounding before the bias or the activation (the
    JAX seam's XLA default) would move many elements."""
    x, w, b = (torch.from_numpy(a).to(BF) for a in _conv_inputs(4, C=8))
    kw = dict(stride=(2, 1), padding="SAME")
    y, z = ck.conv2d_bias_act_ref(x, w, b, activation=activation,
                                  want_pre=True, **kw)
    y64, z64 = _conv_f64(x, w, b, kw["stride"], kw["padding"], activation)
    for got, ref in ((y, y64), (z, z64)):
        assert got.dtype == BF
        want = ref.to(BF)
        near = (got.double() - want.double()).abs() <= (
            ref.abs() * 2.0 ** -7 + 1e-30)
        assert bool(near.all())
        assert float((got == want).double().mean()) >= 0.99


def _bnap_f64(x, g, p, s, activation):
    """The backward passes in f64 from the same inputs, with the ties of
    the activation rounded to bf16 (the tie decisions of the f32
    recompute, taken in f64 they agree on these inputs)."""
    B, H, W, C = x.shape
    xv = x.double().reshape(B, H // 2, 2, W // 2, 2, C)
    pd = p.double()
    xh = (xv - pd[0]) * pd[1]
    z = xh * pd[2] + pd[3]
    a = activations.get(activation)(z).to(BF).double()
    m = a.amax(dim=(2, 4), keepdim=True)
    eq = (a == m).double()
    ga = eq * (g.double().reshape(B, H // 2, 1, W // 2, 1, C)
               / eq.sum(dim=(2, 4), keepdim=True))
    gz = ga * ck._bnap_dact(z, activation)
    dims = (0, 1, 2, 3, 4)
    n = B * H * W
    sd = s.double()
    dx = pd[1] * pd[2] * (gz - sd[0] / n - xh * (sd[1] / n))
    return (gz * xh).sum(dim=dims), gz.sum(dim=dims), dx.reshape(B, H, W, C)


@pytest.mark.parametrize("activation", ["relu", "sigmoid"])
def test_bnap_plain_bf16_against_f64(activation):
    """The sums (f32) within 1e-5 of max |f64 sums|; dx rounded once to
    bf16: within one ulp of each element of the f64 dx."""
    x, gamma, beta = _bnap_inputs(6)
    xt = torch.from_numpy(x).to(BF)
    gt = torch.from_numpy(np.random.default_rng(7).normal(
        size=(8, 4, 4, 16)).astype(np.float32)).to(BF)
    _, mean, _, inv = ck.bnap_forward_ref(xt, torch.from_numpy(gamma).to(BF),
                                          torch.from_numpy(beta).to(BF),
                                          eps=1e-5, activation=activation)
    p = torch.stack([mean, inv, torch.from_numpy(gamma).to(BF).float(),
                     torch.from_numpy(beta).to(BF).float()])
    dg, db = ck.bnap_sums_ref(xt, gt, p, activation=activation)
    assert dg.dtype == db.dtype == torch.float32
    s = torch.stack([db, dg])
    dx = ck.bnap_dx_ref(xt, gt, p, s, activation=activation)
    assert dx.dtype == BF
    dg64, db64, dx64 = _bnap_f64(xt, gt, p, s, activation)
    for got, want in ((dg, dg64), (db, db64)):
        assert float((got.double() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    near = (dx.double() - dx64).abs() <= dx64.abs() * 2.0 ** -7 + 1e-12
    assert bool(near.all())


# -- the tie rule ------------------------------------------------------------------

def _tie_windows(B=2, H=4, W=6, C=8, seed=0):
    """bf16 x whose 2x2 windows hold {0, 2^-12, 2^-11, 3 * 2^-12} in a
    random order: with p = (mean 0, inv 1, gamma 1, beta 1) the f32
    activations 1, 1 + 2^-12, ... differ, and all round to 1.0 in bf16."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, 2.0 ** -12, 2.0 ** -11, 3 * 2.0 ** -12])
    x = np.empty((B, H // 2, 2, W // 2, 2, C))
    for idx in np.ndindex(B, H // 2, W // 2, C):
        b, i, j, c = idx
        x[b, i, :, j, :, c] = rng.permutation(vals).reshape(2, 2)
    p = torch.stack([torch.zeros(C), torch.ones(C), torch.ones(C),
                     torch.ones(C)])
    g = rng.normal(size=(B, H // 2, W // 2, C)).astype(np.float32)
    return (torch.from_numpy(x.reshape(B, H, W, C).astype(np.float32)),
            torch.from_numpy(g), p)


@pytest.mark.parametrize("activation", ["identity", "relu"])
def test_ties_after_the_bf16_rounding_split_the_gradient(activation):
    x, g, p = _tie_windows()
    B, H, W, C = x.shape
    even = np.broadcast_to(g.numpy().reshape(B, H // 2, 1, W // 2, 1, C) / 4,
                           (B, H // 2, 2, W // 2, 2, C))
    # bf16: a 4-way tie in every window, each input takes a quarter
    xb, gb = x.to(BF), g.to(BF)
    assert torch.equal(xb.float(), x)  # the inputs are bf16-exact
    _, gz = ck._bnap_recompute_ref(xb, gb, p, activation)
    np.testing.assert_array_equal(
        gz.numpy(), np.broadcast_to(
            gb.float().numpy().reshape(B, H // 2, 1, W // 2, 1, C) / 4,
            gz.shape))
    # f32: the same values differ, and the window's maximum takes it all
    _, gz32 = ck._bnap_recompute_ref(x, g, p, activation)
    top = (x.reshape(B, H // 2, 2, W // 2, 2, C) == 3 * 2.0 ** -12).numpy()
    np.testing.assert_array_equal(
        gz32.numpy(), np.where(top, 4 * even, 0.0).astype(np.float32))
    # the dx pass routes by the same ties (with zero sums, dx = g_z)
    dx = ck.bnap_dx_ref(xb, gb, p, torch.zeros(2, C), activation=activation)
    assert dx.dtype == BF
    np.testing.assert_array_equal(dx.float().numpy(),
                                  gz.numpy().reshape(B, H, W, C))


def test_cnn_wrappers_take_one_dtype_of_two():
    """The conv and BN+act+pool kernels take f32 or bf16, one dtype for
    x, w, b (and for x, g); anything else is refused before a launch."""
    f, b = torch.zeros(2, dtype=torch.float32), torch.zeros(2, dtype=BF)
    assert ck._kernel_dtype("k", b, b) == BF
    assert ck._kernel_dtype("k", f, f) == torch.float32
    for bad in ((f, b), (b.double(), b.double())):
        with pytest.raises(TypeError, match="one of"):
            ck._kernel_dtype("k", *bad)
    for name in ("conv2d_bias_act", "bnap_sums", "bnap_dx"):
        assert f"{name}_bf16" in ck.LAUNCHES
