"""Port parity: the CNN training kernels' seams (conv2d_bias_act and
bn_act_pool) against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through the JAX seam with its
Pallas kernels run by the Pallas interpreter and through the port's seam,
whose kernel wrappers run their plain PyTorch versions on CPU tensors.

Tolerances (f32, sums taken in another order on the two sides):
  - losses: rtol 1e-6; from-logits gradients: rtol 1e-5, atol 1e-7;
  - conv forward and gradients: rtol 1e-5, atol 1e-5 (at most 5*5*3 = 75
    products per output; the JAX suite's own bound,
    test_pallas_kernels.py);
  - bn_act_pool pooled output: rtol 1e-5, atol 1e-5; dx, d gamma, d beta:
    rtol 1e-4, atol 1e-5 (sums over B*H*W = 192 to 256 terms; the JAX
    suite's own bound, test_bn_act_pool.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import helpers as jhelpers
from deeplearning4j_tpu.ops import losses as jl
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import helpers as thelpers
from deeplearning4j_tpu_torch.ops import losses as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_conv():
    """The JAX conv seam through its Pallas kernel, interpreted."""
    pk.enable(interpret=True, use_conv=True)
    yield
    pk.disable()


@pytest.fixture
def bnap_interpret():
    pk._INTERPRET = True
    yield
    pk._INTERPRET = False


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# the four stride/padding/activation cases of the JAX suite
# (test_pallas_kernels.py), then softmax (the kernel's identity epilogue and
# a channel softmax) and swish (whose gradient needs the pre-activation)
CONV_CASES = [((1, 1), "SAME", "relu"),
              ((2, 2), "SAME", "identity"),
              ((1, 1), ((0, 0), (0, 0)), "tanh"),
              ((2, 2), ((2, 2), (2, 2)), "relu"),
              ((1, 1), "SAME", "softmax"),
              ((2, 2), "SAME", "swish")]


def _conv_inputs(seed, C=3, OC=8, K=5, hw=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, hw, hw, C)).astype(np.float32)
    w = (rng.normal(size=(K, K, C, OC)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(OC,)) * 0.1).astype(np.float32)
    return x, w, b


def _jax_conv_grads(x, w, b, gy, **kw):
    def f(x, w, b):
        return jnp.sum(jhelpers.conv2d_bias_act(x, w, b, **kw) * gy)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b))


def _torch_conv_grads(x, w, b, gy, **kw):
    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    y = thelpers.conv2d_bias_act(tx, tw, tb, **kw)
    (y * _t(gy)).sum().backward()
    return y.detach(), (tx.grad, tw.grad, tb.grad)


@pytest.mark.parametrize("stride,padding,activation", CONV_CASES)
def test_conv_matches_pallas_kernel(pallas_conv, stride, padding,
                                    activation):
    x, w, b = _conv_inputs(0)
    kw = dict(stride=stride, padding=padding, activation=activation)
    want = jhelpers.conv2d_bias_act(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), **kw)
    assert thelpers.conv_kernel_applies(_t(w), (1, 1))
    got = thelpers.conv2d_bias_act(_t(x), _t(w), _t(b), **kw)
    assert got.shape == want.shape
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("stride,padding,activation", CONV_CASES)
def test_conv_gradients_match_jax(pallas_conv, stride, padding, activation):
    x, w, b = _conv_inputs(1)
    kw = dict(stride=stride, padding=padding, activation=activation)
    shape = thelpers.conv2d_bias_act(_t(x), _t(w), _t(b), **kw).shape
    gy = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    _, got = _torch_conv_grads(x, w, b, gy, **kw)
    want = _jax_conv_grads(x, w, b, gy, **kw)
    for g, jg in zip(got, want):
        _close(g, jg, 1e-5, 1e-5)


@pytest.mark.parametrize("case", ["kw_c_below_8", "dilation"])
def test_conv_declines_as_the_jax_kernel_does(pallas_conv, case):
    """kw*c < 8 (LeNet's conv1: 5*1) and a dilated conv run the plain
    default on both sides: the kernel is never reached."""
    if case == "kw_c_below_8":
        x, w, b = _conv_inputs(3, C=1, OC=20)
        kw = dict(stride=(1, 1), padding="VALID", dilation=(1, 1),
                  activation="identity")
    else:
        x, w, b = _conv_inputs(3, K=3)
        kw = dict(stride=(1, 1), padding="SAME", dilation=(2, 2),
                  activation="relu")
    assert not thelpers.conv_kernel_applies(_t(w), kw["dilation"])
    calls = []
    orig = ck.conv2d_bias_act
    ck.conv2d_bias_act = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        gy = np.random.default_rng(4).normal(
            size=jhelpers.conv2d_bias_act(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), **kw).shape
        ).astype(np.float32)
        y, got = _torch_conv_grads(x, w, b, gy, **kw)
    finally:
        ck.conv2d_bias_act = orig
    assert calls == []
    want_y = jhelpers.conv2d_bias_act(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), **kw)
    _close(y, want_y, 1e-5, 1e-5)
    for g, jg in zip(got, _jax_conv_grads(x, w, b, gy, **kw)):
        _close(g, jg, 1e-5, 1e-5)


def test_conv_reaches_the_kernel_wrapper():
    """An applicable conv goes through the kernel's wrapper (on a CPU
    tensor its plain version), which counts no launch on the CPU."""
    x, w, b = _conv_inputs(5)
    calls = []
    orig = ck.conv2d_bias_act
    ck.conv2d_bias_act = lambda *a, **k: calls.append(1) or orig(*a, **k)
    ck.reset_launches()
    try:
        thelpers.conv2d_bias_act(_t(x), _t(w), _t(b), activation="relu")
    finally:
        ck.conv2d_bias_act = orig
    assert calls == [1]
    assert ck.LAUNCHES["conv2d_bias_act"] == 0


def test_softmax_conv_reaches_the_kernel_wrapper():
    """softmax is not declined: the wrapper runs with the identity
    epilogue and the channel softmax follows it, as the JAX kernel applies
    softmax to its whole-OC output block."""
    x, w, b = _conv_inputs(6)
    calls = []
    orig = ck.conv2d_bias_act
    ck.conv2d_bias_act = (lambda *a, **k: calls.append(k["activation"])
                          or orig(*a, **k))
    try:
        y = thelpers.conv2d_bias_act(_t(x), _t(w), _t(b),
                                     activation="softmax")
    finally:
        ck.conv2d_bias_act = orig
    assert calls == ["identity"]
    _close(y, ck.conv2d_bias_act_ref(_t(x), _t(w), _t(b),
                                     activation="softmax"), 1e-6, 1e-7)


@pytest.mark.parametrize("activation", ["identity", "swish"])
def test_conv_backward_does_not_rerun_the_forward(activation):
    """The backward reads what the forward saved (x, w, and the
    pre-activation where the activation needs it); it runs no conv
    forward of its own."""
    x, w, b = _conv_inputs(7)
    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    calls = []
    orig = ck.conv2d_ref
    ck.conv2d_ref = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        y = thelpers.conv2d_bias_act(tx, tw, tb, activation=activation)
        assert calls == [1]
        y.sum().backward()
    finally:
        ck.conv2d_ref = orig
    assert calls == [1]
    assert tx.grad is not None and tw.grad is not None and tb.grad is not None


@pytest.mark.parametrize("stride,padding", [((1, 1), "SAME"),
                                            ((2, 2), "SAME"),
                                            ((2, 1), ((1, 0), (2, 1))),
                                            ((1, 1), "VALID")])
def test_conv_geometry_matches_jax(stride, padding):
    for h, w, k in ((32, 32, 3), (12, 11, 5), (7, 9, 2)):
        assert ck.conv_geometry(h, w, k, k, stride, padding) == \
            pk._conv_geometry(h, w, k, k, stride, padding)


def _bnap_inputs(seed, B=4, H=8, W=6, C=16, tied=False):
    rng = np.random.default_rng(seed)
    if tied:  # every 2x2 window holds four equal values: a 4-way tie
        x = np.repeat(np.repeat(rng.normal(size=(B, H // 2, W // 2, C)),
                                2, axis=1), 2, axis=2)
    else:
        x = rng.normal(size=(B, H, W, C))
    gamma = rng.normal(size=(C,)) * 0.5 + 1.0
    beta = rng.normal(size=(C,)) * 0.1
    gp = rng.normal(size=(B, H // 2, W // 2, C))
    return [a.astype(np.float32) for a in (x, gamma, beta, gp)]


def _jax_bnap(fn, x, gamma, beta, gp):
    def loss(x, g, b):
        return jnp.sum(fn(x, g, b)[0] * gp)
    pooled = fn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))[0]
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return pooled, grads


def _torch_bnap(x, gamma, beta, gp, activation, eps=1e-5):
    tx, tg, tb = _t(x, True), _t(gamma, True), _t(beta, True)
    pooled, mean, var = thelpers.bn_act_pool(tx, tg, tb, eps=eps,
                                             activation=activation)
    assert not mean.requires_grad and not var.requires_grad
    (pooled * _t(gp)).sum().backward()
    return pooled.detach(), (tx.grad, tg.grad, tb.grad), (mean, var)


@pytest.mark.parametrize("act,tied", [("relu", False), ("tanh", False),
                                      ("identity", False),
                                      ("sigmoid", False), ("relu", True)])
def test_bn_act_pool_matches_pallas_kernel(bnap_interpret, act, tied):
    x, gamma, beta, gp = _bnap_inputs(6, tied=tied)
    assert thelpers.bnap_kernel_applies(_t(x), act)
    fn = pk._get_bnap_fn(1e-5, act, "hwbc")
    want_p, want_g = _jax_bnap(fn, x, gamma, beta, gp)
    got_p, got_g, (mean, var) = _torch_bnap(x, gamma, beta, gp, act)
    _close(got_p, want_p, 1e-5, 1e-5)
    for g, jg in zip(got_g, want_g):
        _close(g, jg, 1e-4, 1e-5)
    jm, jv = jhelpers.bn_batch_stats(jnp.asarray(x))
    _close(mean, jm, 1e-5, 1e-6)
    _close(var, jv, 1e-5, 1e-6)


def test_tied_window_splits_the_gradient_evenly():
    """A constant window sends a quarter of its pooled gradient to each
    input (the JAX kernel's eq / cnt rule): g_z sums back to g."""
    x, gamma, beta, gp = _bnap_inputs(7, tied=True)
    C = x.shape[-1]
    p = torch.stack([torch.zeros(C), torch.ones(C), torch.ones(C),
                     torch.zeros(C)])
    _, gz = ck._bnap_recompute_ref(_t(x), _t(gp), p, "identity")
    B, H, W, _ = x.shape
    np.testing.assert_array_equal(
        gz.numpy(), np.broadcast_to(
            gp.reshape(B, H // 2, 1, W // 2, 1, C) / 4, gz.shape))


def test_bn_act_pool_backward_runs_both_kernel_wrappers():
    x, gamma, beta, gp = _bnap_inputs(8)
    seen = []
    orig = ck.bnap_sums, ck.bnap_dx
    ck.bnap_sums = lambda *a, **k: seen.append("sums") or orig[0](*a, **k)
    ck.bnap_dx = lambda *a, **k: seen.append("dx") or orig[1](*a, **k)
    ck.reset_launches()
    try:
        _torch_bnap(x, gamma, beta, gp, "relu")
    finally:
        ck.bnap_sums, ck.bnap_dx = orig
    assert seen == ["sums", "dx"]
    assert ck.LAUNCHES["bnap_sums"] == ck.LAUNCHES["bnap_dx"] == 0


@pytest.mark.parametrize("shape,act", [
    ((4, 8, 6, 16), "elu"),     # activation outside _BNAP_ACTS
    ((4, 7, 6, 16), "relu"),    # odd H
    ((4, 8, 5, 16), "relu"),    # odd W
    ((4, 8, 6, 12), "relu"),    # C % 8 != 0
    ((4, 8, 2, 16), "relu"),    # W < 4
])
def test_bn_act_pool_declines_as_the_jax_seam_does(bnap_interpret, shape,
                                                   act):
    B, H, W, C = shape
    rng = np.random.default_rng(9)
    x = rng.normal(size=shape).astype(np.float32)
    gamma = (rng.normal(size=(C,)) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    gp = rng.normal(size=(B, -(-H // 2), -(-W // 2), C)).astype(np.float32)
    assert not thelpers.bnap_kernel_applies(_t(x), act)
    seen = []
    orig = ck.bnap_sums
    ck.bnap_sums = lambda *a, **k: seen.append(1) or orig(*a, **k)
    try:
        got_p, got_g, _ = _torch_bnap(x, gamma, beta, gp, act)
    finally:
        ck.bnap_sums = orig
    assert seen == []

    def fn(x, g, b):
        return pk.bn_act_pool_pallas(x, g, b, eps=1e-5, activation=act)
    want_p, want_g = _jax_bnap(fn, x, gamma, beta, gp)
    _close(got_p, want_p, 1e-5, 1e-5)
    for g, jg in zip(got_g, want_g):
        _close(g, jg, 1e-4, 1e-5)


def test_plain_overrides_route_around_the_kernels():
    """The caller's explicit override: PLAIN_OVERRIDES registered, the
    seams never reach a kernel wrapper, and the values are unchanged."""
    x, w, b = _conv_inputs(10)
    bx, gamma, beta, gp = _bnap_inputs(11)
    want_y = thelpers.conv2d_bias_act(_t(x), _t(w), _t(b), activation="relu")
    want_p, want_g, _ = _torch_bnap(bx, gamma, beta, gp, "relu")
    seen = []
    orig = ck.conv2d_bias_act, ck.bnap_sums
    ck.conv2d_bias_act = lambda *a, **k: seen.append(1) or orig[0](*a, **k)
    ck.bnap_sums = lambda *a, **k: seen.append(1) or orig[1](*a, **k)
    for name, fn in thelpers.PLAIN_OVERRIDES.items():
        thelpers.register_helper(name, fn)
    try:
        got_y = thelpers.conv2d_bias_act(_t(x), _t(w), _t(b),
                                         activation="relu")
        got_p, got_g, _ = _torch_bnap(bx, gamma, beta, gp, "relu")
    finally:
        for name in thelpers.PLAIN_OVERRIDES:
            thelpers.register_helper(name, None)
        ck.conv2d_bias_act, ck.bnap_sums = orig
    assert seen == []
    np.testing.assert_array_equal(got_y.numpy(), want_y.numpy())
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())
    for g, wg in zip(got_g, want_g):
        np.testing.assert_array_equal(g.numpy(), wg.numpy())


@pytest.mark.parametrize("kind,padding", [("max", "SAME"),
                                          ("avg", ((1, 0), (0, 1))),
                                          ("sum", "SAME"),
                                          ("pnorm", ((0, 0), (0, 0)))])
def test_pool2d_matches_jax(kind, padding):
    x = np.random.default_rng(12).normal(size=(2, 7, 6, 3)).astype(
        np.float32)
    kw = dict(kind=kind, kernel=(3, 2), stride=(2, 2), padding=padding)
    want = jhelpers.pool2d(jnp.asarray(x), **kw)
    got = thelpers.pool2d(_t(x), **kw)
    _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("name", sorted(tl.LOSSES))
@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_jax(name, masked):
    rng = np.random.default_rng(13)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    preds = rng.uniform(0.05, 0.95, size=(6, 5)).astype(np.float32)
    mask = (rng.uniform(size=6) > 0.3).astype(np.float32) if masked else None
    want = jl.get(name)(jnp.asarray(labels), jnp.asarray(preds),
                        None if mask is None else jnp.asarray(mask))
    got = tl.get(name)(_t(labels), _t(preds),
                       None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("act,loss", [("softmax", "negativeloglikelihood"),
                                      ("softmax", "mcxent"),
                                      ("sigmoid", "xent")])
def test_fused_from_logits_loss_and_gradient_match_jax(act, loss):
    """The stable from-logits losses; softmax + mcxent's gradient in the
    logits is p - y over the batch size."""
    rng = np.random.default_rng(14)
    labels = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    z = (rng.normal(size=(6, 5)) * 3).astype(np.float32)
    jf, tf = jl.fused_from_logits(act, loss), tl.fused_from_logits(act, loss)
    want, jg = jax.value_and_grad(lambda z: jf(jnp.asarray(labels), z))(
        jnp.asarray(z))
    tz = _t(z, True)
    got = tf(_t(labels), tz)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    _close(tz.grad, jg, 1e-5, 1e-7)
    if act == "softmax":
        p = torch.softmax(_t(z), -1)
        _close(tz.grad, (p - _t(labels)) / 6, 1e-5, 1e-7)
