"""MSM: marginal structural models, the classical baseline.

Two logistic propensity models (numerator and denominator of the stabilized
weights) and one weighted linear regressor per prediction horizon, fitted on
one row per (patient, prefix end). Everything here is numpy and scipy in
float64 on the host, as in `insite_tpu.models.msm`: the models are tiny and
the unregularized propensity fit is numerically touchy (see `logistic_fit`),
so there is no device code and ``device`` plays no part.
"""

from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass

import numpy as np

from insite_tpu_torch.models.base import CausalEstimator


@dataclass
class MSMConfig:
    dim_treatments: int = 1
    dim_static_features: int = 2
    dim_outcome: int = 1
    lag_features: int = 1
    projection_horizon: int = 5
    max_epochs: int = 100


def logistic_fit(X, Y, max_iter=100):
    """Unregularized multi-output logistic regression by L-BFGS-B from
    zeros, in float64 on the host. X: [N, D]; Y: [N, K] binary.
    Returns (W [K, D], b [K]).

    A host solve on purpose: in float32 an unregularized NLL on a
    quasi-separable treatment column overflows the logits, and the model is
    a handful of parameters."""
    from scipy.optimize import minimize as sp_minimize
    Xh = np.asarray(X, np.float64)
    Yh = np.asarray(Y, np.float64)
    N, D = Xh.shape

    def fit_one(y):
        def nll_grad(wb):
            logits = Xh @ wb[:D] + wb[D]
            p = 1.0 / (1.0 + np.exp(-logits))
            nll = np.mean(np.logaddexp(0.0, logits) - y * logits)
            g_logits = (p - y) / N
            return nll, np.concatenate([Xh.T @ g_logits,
                                        [g_logits.sum()]])
        res = sp_minimize(nll_grad, np.zeros(D + 1), jac=True,
                          method='L-BFGS-B',
                          options={'maxiter': max_iter})
        return res.x

    wb = np.stack([fit_one(Yh[:, k]) for k in range(Yh.shape[1])])
    return wb[:, :D], wb[:, D]


def logistic_proba(W, b, X):
    return 1.0 / (1.0 + np.exp(-(X @ W.T + b)))


def linreg_fit(X, Y, sample_weight=None):
    """Weighted multi-output linear regression with an intercept (the
    last row of the result), by least squares on sqrt(w)-scaled rows in
    float64."""
    X1 = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
    if sample_weight is not None:
        sw = np.sqrt(np.asarray(sample_weight, np.float64))[:, None]
        coef, *_ = np.linalg.lstsq(X1 * sw, np.asarray(Y) * sw, rcond=None)
    else:
        coef, *_ = np.linalg.lstsq(X1, np.asarray(Y), rcond=None)
    return coef                                   # [(D+1), K]


class MSM(CausalEstimator):
    model_type = 'msm_regressor'

    def __init__(self, cfg: MSMConfig, dataset_collection):
        self.cfg = cfg
        self.collection = dataset_collection
        self.lag_features = cfg.lag_features
        if not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi()
        self.prop_treat = None    # (W, b)
        self.prop_hist = None
        self.regressors = []      # per-tau linreg coefs

    # ------------------------------------------------------------------
    # exploded-row feature functions: the specification the dense ones
    # below are tested against (`get_autoregressive_predictions` uses
    # `_inputs_regressor` on the unexploded test rows)

    def _exploded(self, dataset, min_length, only_active_entries=True,
                  max_length=None):
        ds = deepcopy(dataset)
        if max_length is None:
            max_length = int(max(ds.data['sequence_lengths']))
        if not only_active_entries:
            ds.data['active_entries'][:, :, :] = 1.0
            ds.data['sequence_lengths'][:] = max_length
        ds.explode_trajectories(min_length)
        return ds

    @staticmethod
    def _last_entries(active):
        return active - np.concatenate(
            [active[:, 1:, :], np.zeros((active.shape[0], 1, 1))], axis=1)

    def _lagged_entries(self, active, projection_horizon=0):
        lag = self.lag_features
        lagged = active - np.concatenate(
            [active[:, lag + 1:, :],
             np.zeros((active.shape[0], lag + 1, 1))], axis=1)
        if projection_horizon > 0:
            lagged = np.concatenate(
                [lagged[:, projection_horizon:, :],
                 np.zeros((active.shape[0], projection_horizon, 1))], axis=1)
        return lagged

    def _inputs_treat(self, data):
        return (data['prev_treatments'] * data['active_entries']).sum(1)

    def _inputs_hist(self, data, projection_horizon=0):
        active = data['active_entries']
        lagged = self._lagged_entries(active, projection_horizon)
        before = np.concatenate(
            [active[:, projection_horizon:, :],
             np.zeros((active.shape[0], projection_horizon, 1))], axis=1)
        dim_out = self.cfg.dim_outcome
        lag = self.lag_features
        inputs = [(data['prev_treatments'] * before).sum(1)]
        prev_outputs = data['prev_outputs']
        inputs.append(prev_outputs[
            np.repeat(lagged, dim_out, 2) == 1.0].reshape(
                prev_outputs.shape[0], (lag + 1) * dim_out))
        inputs.append(data['static_features'])
        return np.concatenate(inputs, axis=1)

    def _inputs_regressor(self, data, projection_horizon=0, tau=0):
        active = data['active_entries']
        inputs = [self._inputs_hist(data, projection_horizon)]
        current_treatments = data['current_treatments']
        pred_entries = active - np.concatenate(
            [active[:, tau + 1:, :],
             np.zeros((active.shape[0], tau + 1, 1))], axis=1)
        pred_entries = np.concatenate(
            [pred_entries[:, projection_horizon - tau:, :],
             np.zeros((pred_entries.shape[0],
                       projection_horizon - tau, 1))], axis=1)
        inputs.append((current_treatments * pred_entries).sum(1))
        return np.concatenate(inputs, axis=1)

    # ------------------------------------------------------------------
    # dense all-prefix feature functions: the exploded-row features above
    # are, per (patient, prefix-end t), just prefix cumsums and lag
    # windows of the ORIGINAL [n, T] arrays — computing them densely
    # avoids materialising the ~60x exploded [rows, T, k] arrays (the
    # one-step test set alone explodes to ~600k rows). Equivalence with the
    # exploded path is asserted in tests/test_torch_msm.py.

    def _dense_hist(self, data, shift=0):
        """_inputs_hist of EVERY prefix end t at once: [n, T-lag, D_hist]
        where row (i, j) is the exploded-row feature at prefix end
        t = j + lag, evaluated `shift` steps back (projection_horizon)."""
        lag = self.lag_features
        do = self.cfg.dim_outcome
        pt = np.asarray(data['prev_treatments'], np.float64)
        po = np.asarray(data['prev_outputs'], np.float64)
        st = np.asarray(data['static_features'], np.float64)
        n, T = pt.shape[:2]
        cum = np.cumsum(pt, axis=1)                       # [n, T, k]
        # windows of prev_outputs covering [s-lag, s], s = prefix end
        win = np.lib.stride_tricks.sliding_window_view(
            po, lag + 1, axis=1)                          # [n, T-lag, do, lag+1]
        win = win.transpose(0, 1, 3, 2).reshape(n, T - lag, (lag + 1) * do)
        # prefix end t runs over [lag, T); with shift, features are read
        # at s = t - shift (valid only for t >= lag + shift)
        s = np.arange(lag, T) - shift                     # [T-lag]
        s = np.clip(s, lag, T - 1)
        feats = [cum[:, s], win[:, s - lag],
                 np.broadcast_to(st[:, None], (n, T - lag, st.shape[-1]))]
        return np.concatenate(feats, axis=-1)

    def _dense_regressor(self, data, tau=0, shift=None):
        """_inputs_regressor of every prefix end t: [n, T-lag, D]."""
        shift = tau if shift is None else shift
        lag = self.lag_features
        ct = np.asarray(data['current_treatments'], np.float64)
        n, T = ct.shape[:2]
        hist = self._dense_hist(data, shift=shift)
        # current-treatment window sum over [t-tau, t] (cumsum difference)
        cum = np.cumsum(ct, axis=1)
        t = np.arange(lag, T)
        low = t - tau - 1
        wsum = cum[:, t] - np.where(low[None, :, None] >= 0,
                                    np.take(cum, np.clip(low, 0, T - 1),
                                            axis=1), 0.0)
        return np.concatenate([hist, wsum], axis=-1)

    @staticmethod
    def _valid_rows(data, min_length):
        """Mask [n, T-min_length... ] of exploded-row existence: prefix
        end t in [min_length, L_i)."""
        lengths = np.asarray(data['sequence_lengths']).astype(np.int64)
        n = lengths.shape[0]
        T = data['active_entries'].shape[1]
        t = np.arange(min_length, T)
        return t[None, :] < lengths[:, None]              # [n, T-min_length]

    def get_propensity_scores(self, dataset, which='treat') -> np.ndarray:
        lag = self.lag_features
        d = dataset.data
        if which == 'treat':
            cum = np.cumsum(np.asarray(d['prev_treatments'], np.float64),
                            axis=1)
            inputs = cum[:, lag:]                         # [n, T-lag, k]
            W, b = self.prop_treat
        else:
            inputs = self._dense_hist(d)
            W, b = self.prop_hist
        n, T = d['active_entries'].shape[:2]
        probs = logistic_proba(W, b, inputs.reshape(n * (T - lag), -1))
        probs = probs.reshape(n, T - lag, self.cfg.dim_treatments)
        return np.concatenate(
            [0.5 * np.ones((n, lag, self.cfg.dim_treatments)), probs],
            axis=1)

    def _propensity_design(self, which):
        """Valid exploded-row (inputs, targets) for one propensity model:
        the design half of `_fit_propensity`, kept apart so that a
        seed-batched solve can build the identical system."""
        lag = self.lag_features
        d = self.collection.train_f.data
        valid = self._valid_rows(d, lag).reshape(-1)
        if which == 'treat':
            cum = np.cumsum(np.asarray(d['prev_treatments'], np.float64),
                            axis=1)
            inputs = cum[:, lag:]
        else:
            inputs = self._dense_hist(d)
        inputs = inputs.reshape(-1, inputs.shape[-1])[valid]
        ct = np.asarray(d['current_treatments'], np.float64)
        outputs = ct[:, lag:].reshape(-1, ct.shape[-1])[valid]
        return inputs, outputs

    def _fit_propensity(self, which):
        inputs, outputs = self._propensity_design(which)
        return logistic_fit(inputs, outputs, self.cfg.max_epochs)

    def compute_stabilized_weights(self):
        """SW = prod_k p_treat / p_hist on the training set; needs the
        fitted propensity models."""
        coll = self.collection
        pt = self.get_propensity_scores(coll.train_f, 'treat')
        ph_ = self.get_propensity_scores(coll.train_f, 'hist')
        coll.train_f.data['stabilized_weights'] = np.prod(pt / ph_, axis=2)

    def _regressor_design(self, tau):
        """Valid exploded-row (inputs, targets, sample weights) for the
        horizon-tau regressor; needs ``stabilized_weights`` set."""
        d = self.collection.train_f.data
        lag = self.lag_features
        outs = np.asarray(d['outputs'], np.float64)
        valid = self._valid_rows(d, lag + tau)            # [n, T-lag-tau]
        inputs = self._dense_regressor(d, tau=tau)[:, tau:]
        flat = inputs.reshape(-1, inputs.shape[-1])[valid.reshape(-1)]
        outputs = outs[:, lag + tau:].reshape(
            -1, outs.shape[-1])[valid.reshape(-1)]
        sw = self._dense_sample_weights(d, tau)[valid]
        return flat, outputs, sw

    def fit(self, train_f=None, val_f=None):
        cfg = self.cfg
        self.prop_treat = self._fit_propensity('treat')
        self.prop_hist = self._fit_propensity('hist')
        self.compute_stabilized_weights()
        self.regressors = []
        for tau in range(cfg.projection_horizon + 1):
            flat, outputs, sw = self._regressor_design(tau)
            self.regressors.append(linreg_fit(flat, outputs, sw))
        return self

    def _dense_sample_weights(self, data, tau):
        """Windowed SW products of every valid prefix end: the product of
        stabilized_weights over [t-tau, t], t in [lag+tau, T), clipped to
        its 1 % and 99 % quantiles over the valid rows."""
        lag = self.lag_features
        sw_full = np.asarray(data['stabilized_weights'], np.float64)
        n, T = sw_full.shape
        t = np.arange(lag + tau, T)
        sw = np.ones((n, T - lag - tau), np.float64)
        for j in range(tau + 1):
            sw = sw * sw_full[:, t - j]
        flat = sw[self._valid_rows(data, lag + tau)]
        lo, hi = np.nanquantile(flat, 0.01), np.nanquantile(flat, 0.99)
        return np.clip(sw, lo, hi)

    def _sample_weights(self, data, tau):
        """The exploded-row form of `_dense_sample_weights` (the
        specification of the dense-equivalence test)."""
        active = data['active_entries']
        sw_full = data['stabilized_weights']
        pred_entries = active - np.concatenate(
            [active[:, tau + 1:, :],
             np.zeros((active.shape[0], tau + 1, 1))], axis=1)
        sw = sw_full[np.squeeze(pred_entries, -1) == 1.0].reshape(
            sw_full.shape[0], tau + 1)
        sw = np.prod(sw, axis=1)
        return np.clip(sw, np.nanquantile(sw, 0.01),
                       np.nanquantile(sw, 0.99))

    # ------------------------------------------------------------------
    def get_predictions(self, dataset) -> np.ndarray:
        cfg = self.cfg
        lag = self.lag_features
        inputs = self._dense_regressor(dataset.data, tau=0)
        n, Tl = inputs.shape[:2]
        coef = self.regressors[0]
        flat = inputs.reshape(n * Tl, -1)
        pred = np.concatenate([flat, np.ones((flat.shape[0], 1))],
                              axis=1) @ coef
        pred = pred.reshape(n, Tl, cfg.dim_outcome)
        # the first `lag` steps lack enough history -> duplicate the first
        # available prediction
        pad = np.repeat(pred[:, :1, :], lag, axis=1)
        return np.concatenate([pad, pred], axis=1)

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        cfg = self.cfg
        ph = cfg.projection_horizon
        n = len(dataset.data['sequence_lengths'])
        predicted = np.zeros((n, ph, cfg.dim_outcome))
        for t in range(1, ph + 1):
            inputs = self._inputs_regressor(dataset.data,
                                            projection_horizon=ph - 1,
                                            tau=t - 1)
            coef = self.regressors[t]
            pred = np.concatenate([inputs, np.ones((inputs.shape[0], 1))],
                                  axis=1) @ coef
            predicted[:, t - 1] = pred
        return predicted
