"""Functions the port's parallel tests hand to mesh followers by
reference (a module-level function importable by its qualified name):
the blocks of tests/test_torch_pipeline.py, the experts of
tests/test_torch_moe.py, and a probe service for
tests/test_torch_mesh_nd.py. Imports torch only, so a follower loads it
quickly."""
import pickle

import torch

from deeplearning4j_tpu_torch.parallel.ring import full_attention

D_T, HEADS_T = 16, 4


def block(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def norm_block(p, x):
    var = x.var(-1, keepdim=True, unbiased=False)
    h = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(var + 1e-5)
    return x + torch.tanh(h @ p["W"])


def tblock(p, x):
    """The pre-LN attention + FFN residual block of JAX
    tests/test_pipeline.py (d 16, 4 heads)."""
    dh = D_T // HEADS_T

    def ln(a):
        return (a - a.mean(-1, keepdim=True)) / (
            a.std(-1, keepdim=True, unbiased=False) + 1e-5)
    h = ln(x)
    b, t, _ = h.shape
    q = (h @ p["Wq"]).reshape(b, t, HEADS_T, dh)
    k = (h @ p["Wk"]).reshape(b, t, HEADS_T, dh)
    v = (h @ p["Wv"]).reshape(b, t, HEADS_T, dh)
    a = full_attention(q, k, v, causal=True).reshape(b, t, D_T)
    x = x + a @ p["Wo"]
    return x + torch.tanh(ln(x) @ p["Wf1"]) @ p["Wf2"]


def expert(p, x):
    return torch.tanh(x @ p["W1"]) @ p["W2"]


class Probe:
    """A follower service: runs the collective named by each command on
    its data and takes part in the driver's gather of the results."""

    def __init__(self, comm, payload):
        self.comm = comm

    def handle(self, cmd):
        data = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        run_probe(self.comm, data)


def probe(comm, payload):
    return Probe(comm, payload)


def run_probe(comm, data):
    """Every rank's part of one probe; the driver's return value is the
    gathered result (rank order)."""
    kind, axis = data["kind"], data["axis"]
    ac = comm.axis_comm(axis)
    x = data["inputs"][comm.rank]
    if kind == "all_reduce":
        out = ac.all_reduce(x.clone())
    elif kind == "all_gather":
        out = ac.all_gather(x, data["dim"])
    elif kind == "all_to_all":
        out = ac.all_to_all(x, data["split"], data["concat"])
    elif kind == "exchange":
        out = ac.exchange(x, (ac.rank + 1) % ac.size,
                          (ac.rank - 1) % ac.size)
    elif kind == "send_recv":
        if ac.rank == 0:
            ac.send(x, ac.size - 1)
            out = x
        elif ac.rank == ac.size - 1:
            out = ac.recv(x.shape, x.dtype, 0)
        else:
            out = x
    else:
        raise ValueError(kind)
    return comm.all_gather(out.unsqueeze(0).contiguous(), 0)
