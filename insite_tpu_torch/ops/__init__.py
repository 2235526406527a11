"""Rollout kernels (CUDA) with their plain PyTorch versions.

`batched_rollout` and `rollout_with_sens` take the place of the JAX
package's `pallas_batched_rollout` and `pallas_rollout_with_sens`. The
kernels are built at their first launch, not on import.
"""

from insite_tpu_torch.ops.rollout import batched_rollout, rollout_with_sens

__all__ = ['batched_rollout', 'rollout_with_sens']
