"""Rollout kernels (CUDA) with their plain PyTorch versions.

`batched_rollout` and `rollout_with_sens` take the place of the JAX
package's `pallas_batched_rollout` and `pallas_rollout_with_sens`. The
kernels are built at their first launch, not on import.
`reset_launch_counts` zeroes the launch counters of every kernel module.
"""

from insite_tpu_torch.ops import qr_reduce, rollout, tumor_sim
from insite_tpu_torch.ops.rollout import batched_rollout, rollout_with_sens

__all__ = ['batched_rollout', 'rollout_with_sens']


def reset_launch_counts() -> None:
    """Zero the launch counters of the port's kernels:
    `rollout.ROLLOUT_LAUNCHES`, `rollout.SENS_LAUNCHES`,
    `qr_reduce.QR_LAUNCHES` and `tumor_sim.SIM_LAUNCHES`."""
    rollout.ROLLOUT_LAUNCHES = 0
    rollout.SENS_LAUNCHES = 0
    qr_reduce.QR_LAUNCHES = 0
    tumor_sim.SIM_LAUNCHES = 0
