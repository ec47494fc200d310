"""alicevision_tpu_torch — the PyTorch/CUDA port of alicevision_tpu.

The JAX package `alicevision_tpu` stays the reference. This package mirrors
its module paths (`mvs/plane_sweep.py`, `pipeline/stages.py`, ...) so that
each function names its counterpart by path, and it imports nothing of it
(nor of JAX). Plain tensor code is PyTorch; every Pallas kernel of the
reference on a ported path becomes a kernel written by hand for Hopper
(`csrc/`, built at first use by `ops/build.py`).

Entry points take `device="cuda"` by default and raise when no CUDA device
exists; pass `device="cpu"` to run the plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
