"""Float32 arithmetic that matches the JAX reference bit for bit.

Two rules, the port's counterpart of gem_tpu/utils/precision.py:

* No TF32: `gem_tpu_torch/__init__.py` turns it off for matmuls and cuDNN,
  and the small contractions of the step are written out elementwise.
* Division by a constant: XLA rewrites `x / c` for a constant `c` (scalar or
  array) into `x * (1/c)`, with the reciprocal rounded to float32, while
  PyTorch divides (on the CPU exactly; on CUDA by a reciprocal of its own).
  Where the JAX code divides by a constant, the port multiplies by
  `f32_recip(c)`, so both devices reproduce the reference's rounding — it
  decides cell indices at bin boundaries.
"""

from __future__ import annotations

import numpy as np


def f32_recip(c):
    """1/c rounded to float32, as XLA folds it (a Python float, or a float32
    array for an array `c`)."""
    r = np.float32(1.0) / np.asarray(c, np.float32)
    return float(r) if r.ndim == 0 else r


# The control of the benchmark's comparison: the same reference with every
# contraction that carries coordinates or covariance computed in TF32, the
# tensor cores' format (operands rounded to a 10-bit mantissa, sums in
# float32).  Off (exact float32) unless `control.py` turns it on.
TF32 = False


def operand(x):
    """`x` as a contraction operand: itself, or rounded to TF32 (to
    nearest, ties away from zero) when `TF32` is on."""
    if not TF32 or not x.is_floating_point():
        return x
    import torch

    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
