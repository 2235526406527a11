"""Shared numeric constants of the benchmark family.

The same values as `insite_tpu/core/constants.py`, which mirrors the
reference PKPD simulator's constants (its `pkpd/utils.py` and
`pkpd/pkpd_simulation.py`).
"""

MAX_VALUE = 50.0                      # death threshold of the EQ_4 outcome
STEPS_FOR_DT = 5                      # Euler sub-steps per observation interval
MAX_TIME_HORIZON = 10.0
MAX_SEQUENCE_LENGTH = 60
STANDARD_DT = MAX_TIME_HORIZON / MAX_SEQUENCE_LENGTH
HMAX = STANDARD_DT / STEPS_FOR_DT

OBSERVATION_NOISE = 0.01
RECOVERY_MULTIPLIER = 5.8e11          # cells per cm^3 (5.8e8 * 1e3)

# Savitzky-Golay smoothing used by the smoothed finite differences
SMOOTHER_WINDOW = 5
SMOOTHER_POLYORDER = 3
