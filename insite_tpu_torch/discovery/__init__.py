"""Candidate library, derivative estimates and STLSQ."""

from insite_tpu_torch.discovery.differentiate import (finite_difference,
                                                      savgol_coeffs_matrix,
                                                      savgol_smooth,
                                                      windowed_filter)
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import (masked_ridge, stlsq,
                                              stlsq_hostsolve)

__all__ = ['PolynomialLibrary', 'savgol_coeffs_matrix', 'windowed_filter',
           'savgol_smooth', 'finite_difference', 'stlsq', 'stlsq_hostsolve',
           'masked_ridge']
