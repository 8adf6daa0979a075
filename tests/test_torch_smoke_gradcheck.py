"""chip_smoke.py phase 6's gradient-check pieces on the CPU: the conv seam
pinned to a kernel's forward value with the plain conv's gradient, and
the count of 2x2 max-pool windows whose choice moved between two runs."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.ops import helpers  # noqa: E402


def _conv_inputs(seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(2, 6, 6, 8)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(3, 3, 8, 16)) * 0.2,
                     dtype=torch.float32, requires_grad=True)
    b = torch.tensor(rng.normal(size=(16,)), dtype=torch.float32,
                     requires_grad=True)
    return x, w, b


def test_pinned_conv_takes_the_kernels_value_and_the_plain_gradient(
        monkeypatch):
    kw = dict(stride=(1, 1), padding="SAME", activation="identity")
    x, w, b = _conv_inputs(0)
    plain = helpers.conv2d_bias_act_plain(x, w, b, **kw)
    g = torch.tensor(np.random.default_rng(1).normal(size=plain.shape),
                     dtype=torch.float32)
    want = torch.autograd.grad(plain, (x, w, b), g)
    shifted = plain.detach() + 1e-3
    # a stand-in "kernel" whose output is off by 1e-3 everywhere
    monkeypatch.setattr(helpers, "conv2d_bias_act",
                        lambda *a, **k: shifted.clone())
    errs = []
    conv = cs.pinned_conv_plain(torch, helpers, errs)
    helpers.register_helper("conv2d_bias_act", conv)
    try:
        got = conv(x, w, b, **kw)
    finally:
        helpers.register_helper("conv2d_bias_act", None)
    assert torch.equal(got.detach(), shifted)
    for a, e in zip(torch.autograd.grad(got, (x, w, b), g), want):
        assert torch.equal(a, e)
    assert len(errs) == 1
    np.testing.assert_allclose(
        errs[0], 1e-3 / float(plain.detach().abs().max()), rtol=1e-3)


def test_pool_flips_counts_moved_maxima_and_signs():
    gamma, beta = torch.ones(1), torch.zeros(1)
    kw = {"eps": 1e-5, "activation": "relu"}
    base = torch.tensor([[1.0, 2.0, 0.5, -1.0],
                         [3.0, 2.9, -0.5, -0.2],
                         [0.1, 0.2, 4.0, 1.0],
                         [0.3, 0.0, 1.0, 1.5]]).reshape(1, 4, 4, 1)
    moved = base.clone()
    moved[0, 1, 1, 0] = 3.1     # the top-left window's max moves
    same = [([base, gamma, beta], kw)]
    assert cs.pool_flips(torch, same, same) == [0]
    assert cs.pool_flips(torch, same, [([moved, gamma, beta], kw)]) == [1]


def test_recording_seam_records_and_steps_aside():
    seen = []
    calls = []

    def fn(x, gamma, beta, *, eps, activation):
        calls.append(activation)
        return x

    rec = cs.recording_seam(torch, helpers, "bn_act_pool", fn, seen)
    x = torch.ones(1, 2, 2, 1, requires_grad=True)
    assert rec(x, torch.ones(1), torch.zeros(1), eps=1e-5,
               activation="relu") is x
    assert calls == ["relu"] and len(seen) == 1
    assert not seen[0][0][0].requires_grad
    assert seen[0][1] == {"eps": 1e-5, "activation": "relu"}
