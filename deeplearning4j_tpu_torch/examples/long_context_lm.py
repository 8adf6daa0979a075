"""Long-context transformer LM: RoPE + GQA + remat + KV-cache generation.

Port of examples/long_context_lm.py. Trains a small decoder-only LM on a
synthetic copy task (repeat the prompt after a separator: position-
sensitive, so RoPE matters), then streams a completion through the
contiguous KV cache. On the card, sequences of 32768 tokens and more take
the splash kernels (ops/helpers.attention_route); this toy's take flash.
``--dtype bfloat16`` trains bf16 parameters, ``--compute-dtype bfloat16``
f32 master weights with bf16 compute; either runs the bf16 attention
kernels, and the completion streams through a bf16 KV cache.

Run: python -m deeplearning4j_tpu_torch.examples.long_context_lm \\
         [--steps N] [--device cuda|cpu] [--dtype float32|bfloat16] \\
         [--compute-dtype bfloat16]
"""
import argparse

import numpy as np

from ..models.sampling import generate_transformer
from ..models.zoo import transformer_lm
from ..nn.graph import ComputationGraph


def make_batch(rng, vocab, half, batch):
    """[prompt | SEP | prompt] sequences; SEP is token 0, prompt in 1..V-1."""
    prompt = rng.integers(1, vocab, (batch, half))
    seq = np.concatenate([prompt, np.zeros((batch, 1), int), prompt], axis=1)
    eye = np.eye(vocab, dtype=np.float32)
    return seq, eye[seq[:, :-1]], eye[seq[:, 1:]]


def main(steps: int = 300, vocab: int = 12, half: int = 8, batch: int = 32,
         device: str = "cuda", dtype: str = "float32",
         compute_dtype=None) -> float:
    """Train, report and return the copy accuracy on a fresh batch."""
    conf = transformer_lm(vocab_size=vocab, d_model=64, n_heads=4,
                          n_blocks=2, lr=3e-3, rope=True, dtype=dtype,
                          n_kv_heads=2)  # grouped-query attention
    conf.conf.compute_dtype = compute_dtype
    conf.conf.remat = True  # rematerialize layer internals
    net = ComputationGraph(conf, device=device).init()
    rng = np.random.default_rng(0)
    for step in range(steps):
        _, x, y = make_batch(rng, vocab, half, batch)
        net.fit([x], [y])
        if (step + 1) % 100 == 0:
            print(f"step {step + 1}: loss={net.score_:.4f}")

    # accuracy on the copied half (positions after SEP)
    seq, x, _ = make_batch(rng, vocab, half, batch)
    pred = net.output(x)[0].argmax(-1).cpu().numpy()
    acc = float((pred[:, half:] == seq[:, half + 1:]).mean())
    print(f"copy accuracy: {acc:.4f}")

    # stream a completion through the KV cache
    prompt = [int(t) for t in seq[0, :half + 1]]  # prompt + SEP
    completion = generate_transformer(net, prompt, half, vocab,
                                      use_cache=True)
    print("prompt:", prompt[:-1], "-> completion:", completion)
    return acc


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--compute-dtype", default=None, choices=("bfloat16",))
    a = p.parse_args()
    main(a.steps, device=a.device, dtype=a.dtype,
         compute_dtype=a.compute_dtype)
