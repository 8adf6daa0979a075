"""Port parity: the transformer_lm graph, its config JSON and the model zip,
plus the port's import isolation and its device defaults.

Params are carried from the JAX net with `params_from_jax`; zips go both
ways (JAX `write_model` -> port `restore_model`, and back). Tolerance on
forward outputs (softmax probabilities): atol 1e-5.
"""
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import transformer_lm as jlm
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers.base import impl_for as jimpl_for
from deeplearning4j_tpu.util import model_serializer as jms
import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.inference.engine import DecodeScheduler
from deeplearning4j_tpu_torch.models.zoo import transformer_lm as tlm
from deeplearning4j_tpu_torch.nn.conf.graph import \
    ComputationGraphConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer as TDense
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.layers.base import impl_for as timpl_for
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.util import model_serializer as tms

V = 13
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(n_kv_heads=None):
    return dict(vocab_size=V, d_model=16, n_heads=2, n_blocks=2, rope=True,
                n_kv_heads=n_kv_heads)


def _onehot(seed=0, B=2, T=11):
    ids = np.random.default_rng(seed).integers(0, V, (B, T))
    return np.eye(V, dtype=np.float32)[ids]


@pytest.fixture(scope="module", params=[None, 1], ids=["mha", "gqa"])
def pair(request):
    """(JAX net, port net with the JAX net's params)."""
    jnet = JGraph(jlm(**_kw(request.param))).init()
    tnet = TGraph(TConf.from_json(jnet.conf.to_json()), device="cpu").init()
    tnet.set_params(tms.params_from_jax(
        {k: {n: np.asarray(a) for n, a in lp.items()}
         for k, lp in jnet.params.items()}))
    return jnet, tnet


@pytest.mark.parametrize("n_kv_heads", [None, 1])
def test_zoo_config_json_is_the_jax_one(n_kv_heads):
    assert tlm(**_kw(n_kv_heads)).to_json() == jlm(**_kw(n_kv_heads)).to_json()


def test_forward_matches_jax(pair):
    jnet, tnet = pair
    x = _onehot()
    want = np.asarray(jnet.output(x)[0])
    got = tnet.output(x)[0].numpy()
    assert got.shape == want.shape == (2, 11, V)
    assert np.abs(got - want).max() < 1e-5
    np.testing.assert_array_equal(tnet.params_flat(), jnet.params_flat())


def test_jax_written_zip_restores_in_port(pair, tmp_path):
    jnet, _ = pair
    path = tmp_path / "jax_lm.zip"
    jms.write_model(jnet, path)
    tnet = tms.restore_model(path, device="cpu")
    x = _onehot(seed=3)
    assert np.abs(tnet.output(x)[0].numpy()
                  - np.asarray(jnet.output(x)[0])).max() < 1e-5


def test_port_written_zip_restores_in_jax(tmp_path):
    tnet = TGraph(tlm(**_kw()), device="cpu").init()
    path = tmp_path / "port_lm.zip"
    tms.write_model(tnet, path)
    jnet = jms.restore_model(path)
    assert type(jnet).__name__ == "ComputationGraph"
    np.testing.assert_array_equal(jnet.params_flat(), tnet.params_flat())
    x = _onehot(seed=4)
    assert np.abs(tnet.output(x)[0].numpy()
                  - np.asarray(jnet.output(x)[0])).max() < 1e-5
    # and back into the port, bit for bit
    again = tms.restore_model(path, device="cpu")
    np.testing.assert_array_equal(again.params_flat(), tnet.params_flat())


def test_init_is_seeded_and_xavier_distributed():
    a = TGraph(tlm(**_kw()), device="cpu").init()
    b = TGraph(tlm(**_kw()), device="cpu").init()
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    gen = torch.Generator().manual_seed(0)
    jconf = JDense(n_in=256, n_out=512, weight_init="xavier")
    tW = timpl_for(TDense(n_in=256, n_out=512, weight_init="xavier")
                   ).init_params(gen)["W"]
    import jax
    jW = np.asarray(jimpl_for(jconf).init_params(jax.random.PRNGKey(0))["W"])
    want = np.sqrt(2.0 / (256 + 512))
    assert abs(float(tW.std()) / want - 1) < 0.02
    assert abs(float(jW.std()) / want - 1) < 0.02
    assert abs(float(tW.mean())) < 0.1 * want


def test_port_imports_neither_jax_nor_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(
        deeplearning4j_tpu_torch.__path__, "deeplearning4j_tpu_torch.")]
    assert "deeplearning4j_tpu_torch.ops.cuda_kernels" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deeplearning4j_tpu' or m.startswith('deeplearning4j_tpu.')]\n"
        "print(len(bad), bad[:5])\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("0 []"), r.stdout


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    conf = tlm(**_kw())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TGraph(conf)
    net = TGraph(conf, device="cpu").init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeScheduler(net, V, kv_pool_mb=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(net=net, kv_pool_mb=1)
    from deeplearning4j_tpu_torch.cli.main import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--model", "unused.zip", "--generate",
              "--kv-pool-mb", "1"])
    from deeplearning4j_tpu_torch.models.zoo import alexnet_cifar10
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(alexnet_cifar10())
    path = tmp_path / "alexnet.zip"
    tms.write_model(MultiLayerNetwork(alexnet_cifar10(), device="cpu"), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.restore_model(path)
    conf_path = tmp_path / "alexnet.json"
    conf_path.write_text(alexnet_cifar10().to_json())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--conf", str(conf_path), "--input", "unused.csv",
              "--output", str(tmp_path / "unused.zip")])
