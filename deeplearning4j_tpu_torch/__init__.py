"""deeplearning4j_tpu_torch: the PyTorch + CUDA port of deeplearning4j_tpu.

The JAX package (`deeplearning4j_tpu/`) is the reference; this package
keeps its module names, its config JSON and its model zip format, so a
model written by either package loads in the other. It imports `torch`
and never `jax`, and nothing of the JAX package.

Entry points (`ComputationGraph`, `DecodeScheduler`, `InferenceServer`,
the CLI) default to ``device="cuda"`` and raise when no CUDA device is
present; pass ``device="cpu"`` to run on the CPU, where every hand-written
kernel's wrapper runs its plain PyTorch version instead.

Importing the package starts nothing and builds nothing: kernels compile
with nvcc at their first launch on a CUDA tensor (`ops/_build.py`).
"""

__version__ = "0.1.0"
