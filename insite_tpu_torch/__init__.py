"""PyTorch + CUDA port of `insite_tpu` for one NVIDIA H100.

The layout mirrors the JAX package module by module, and each subpackage
exports the names its JAX counterpart exports (``harness`` gives
`rows_from_log` in place of the pandas `df_from_log`; ``ops`` gives
`batched_rollout` and `rollout_with_sens` in place of the two Pallas
wrappers). This package imports torch, numpy, scipy and the standard
library only; the JAX package is the reference its tests hold it against.
"""

__version__ = "0.1.0"
