"""PyTorch/CUDA port of `crowded_scenes_ensemble_classification_tpu`.

The JAX package beside this one is the reference.  Module names mirror it
(`models/i3d.py` here is the counterpart of `models/i3d.py` there), and
public functions keep its NTHWC layout.  This package imports `torch` and
never `jax`, `flax` or the JAX package; constants it shares with the
reference are restated with a citation to their source line.

Every Pallas kernel on the ported path is a hand-written CUDA kernel under
`csrc/`, built at first use by `ops/kernels/_build.py`.  Each kernel's
wrapper runs the kernel for CUDA tensors and its plain PyTorch version for
CPU tensors only.
"""
