"""Constants, dtype policy, Euler integration and sequence masks."""

from insite_tpu_torch.core.constants import (HMAX, MAX_SEQUENCE_LENGTH,
                                             MAX_TIME_HORIZON, MAX_VALUE,
                                             SMOOTHER_POLYORDER,
                                             SMOOTHER_WINDOW, STANDARD_DT,
                                             STEPS_FOR_DT)
from insite_tpu_torch.core.integrate import (controlled_rollout, euler_odeint,
                                             euler_rollout, euler_step)
from insite_tpu_torch.core.masking import length_mask, prefix_mask
