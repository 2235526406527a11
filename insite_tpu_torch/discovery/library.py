"""Candidate-function libraries for sparse ODE discovery.

Feature ordering matches sklearn/pysindy ``PolynomialLibrary``: bias, then
degree-1 terms in input order, then higher degrees by
``itertools.combinations`` (interaction_only) or
``combinations_with_replacement``. The exponent table, the feature names
and the equation string are numpy/Python and identical to
`insite_tpu.discovery.library`; the rollout kernels specialise on the
exponent table.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from insite_tpu_torch.utils.profiling import to_device


def integer_powers(X: torch.Tensor, exps: np.ndarray) -> torch.Tensor:
    """X [..., n] and a non-negative integer table exps [F, n] ->
    [..., F, n] with entry X_i ** exps[k, i], computed by repeated
    multiplication."""
    E = to_device(exps, X.device)
    Xb = X[..., None, :]
    P = torch.ones_like(Xb).expand(*X.shape[:-1], *E.shape)
    for p in range(1, int(exps.max(initial=0)) + 1):
        P = P * torch.where(E >= p, Xb, 1.0)
    return P


@dataclass(frozen=True)
class PolynomialLibrary:
    """Polynomial candidate library (reference default: degree=2,
    interaction_only=True; ablation: degree=4 full)."""

    n_inputs: int
    degree: int = 2
    interaction_only: bool = True
    include_bias: bool = True
    input_names: tuple = None

    def exponents(self) -> np.ndarray:
        """[n_features, n_inputs] integer exponent matrix."""
        rows = []
        if self.include_bias:
            rows.append(np.zeros(self.n_inputs, dtype=np.int32))
        comb = (itertools.combinations if self.interaction_only
                else itertools.combinations_with_replacement)
        for deg in range(1, self.degree + 1):
            for idxs in comb(range(self.n_inputs), deg):
                e = np.zeros(self.n_inputs, dtype=np.int32)
                for i in idxs:
                    e[i] += 1
                rows.append(e)
        return np.stack(rows)

    @property
    def n_features(self) -> int:
        return self.exponents().shape[0]

    def feature_names(self, input_names: Sequence[str] = None) -> list:
        names = (list(input_names) if input_names is not None
                 else (list(self.input_names) if self.input_names
                       else [f'x{i}' for i in range(self.n_inputs)]))
        out = []
        for e in self.exponents():
            if e.sum() == 0:
                out.append('1')
                continue
            parts = []
            for i, p in enumerate(e):
                if p == 1:
                    parts.append(names[i])
                elif p > 1:
                    parts.append(f'{names[i]}^{p}')
            out.append(' '.join(parts))
        return out

    def powers(self, X: torch.Tensor) -> torch.Tensor:
        """X [..., n_inputs] -> [..., n_features, n_inputs] with entry
        X_i ** e[k, i], each power a chain of multiplications as in the
        JAX package (no pow(), whose result may differ in the last ulp)."""
        return integer_powers(X, self.exponents())

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        """Evaluate the feature matrix: X [..., n_inputs] ->
        [..., n_features]."""
        return self.powers(X).prod(-1)

    def pretty_equation(self, coefs, input_names=None, min_coef=1e-3,
                        quantize_round_to=None) -> str:
        """Equation string like the reference's
        ``convert_sindy_model_to_sympyjax_model_core`` output."""
        names = self.feature_names(input_names)
        parts = []
        for c, n in zip(np.asarray(coefs).ravel(), names):
            if abs(c) > min_coef:
                if quantize_round_to is not None:
                    c = round(float(c), quantize_round_to)
                term = f'+{c}*{n.replace(" ", "*")}'
                parts.append(term)
        return ''.join(parts) if parts else '0.0'
