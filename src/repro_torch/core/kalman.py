"""Kalman-filter short-term request-rate predictor (paper §3.3).

A copy of the JAX package's ``core/kalman.py``, imports rewritten;
``tests/test_torch_control_plane.py`` holds the code after this
docstring equal to it.

Scalar filter with state R (requests/s):
    R'_t = A R_{t-1},   P'_t = A P_{t-1} A + Q
    K    = P'_t H / (H P'_t H + D)
    R    = R'_t + K (z_t - H R'_t),   P = (1 - K H) P'_t

The predictor is decoupled from the auto-scaling algorithm (paper: "the
HAS autoscaler decouples the request prediction model"), so any object
with ``update(observed) -> predicted`` plugs in.

``BatchedKalman`` is the struct-of-arrays form of the same filter: one
lane per function slot, one numpy ``update`` for the whole fleet. Each
lane's arithmetic keeps the scalar filter's exact expression order, so
per-slot results are byte-identical to running ``KalmanPredictor``
slot by slot (IEEE-754 float64 elementwise ops match Python floats).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KalmanPredictor:
    A: float = 1.0      # state transition
    H: float = 1.0      # observation model
    Q: float = 8.0      # process noise (workload drift)
    D: float = 8.0      # measurement noise
    R: float = 0.0      # state estimate (RPS)
    P: float = 1.0      # estimate covariance

    def update(self, observed_rps: float) -> float:
        r_pred = self.A * self.R
        p_pred = self.A * self.P * self.A + self.Q
        s = self.H * p_pred * self.H + self.D
        if s <= 0.0:
            # Degenerate innovation covariance (Q = D = 0 with a
            # collapsed P): the gain is 0/0, so the measurement carries
            # no usable information — coast on the prediction instead
            # of dividing by zero.
            self.R, self.P = r_pred, p_pred
            return max(self.R, 0.0)
        k = p_pred * self.H / s
        self.R = r_pred + k * (observed_rps - self.H * r_pred)
        self.P = (1.0 - k * self.H) * p_pred
        return max(self.R, 0.0)

    def predict(self) -> float:
        return max(self.A * self.R, 0.0)


@dataclasses.dataclass
class LastValuePredictor:
    """Naive baseline: predict the current observation (ablation)."""
    R: float = 0.0

    def update(self, observed_rps: float) -> float:
        self.R = observed_rps
        return self.R

    def predict(self) -> float:
        return self.R


class BatchedKalman:
    """Struct-of-arrays Kalman bank: N filter lanes updated in one
    vectorized pass.

    Lanes are *adopted* from live ``KalmanPredictor`` instances with
    :meth:`bind` (copying their current A/H/Q/D/R/P into the arrays);
    from then on the arrays are authoritative. :meth:`sync_back`
    scatters lane state back into the adopted scalar predictors so
    post-run introspection (tests, ablations) sees the same filter
    state a scalar run would leave behind.
    """

    def __init__(self, n_slots: int):
        self.n = n_slots
        self.A = np.ones(n_slots)
        self.H = np.ones(n_slots)
        self.Q = np.zeros(n_slots)
        self.D = np.zeros(n_slots)
        self.R = np.zeros(n_slots)
        self.P = np.ones(n_slots)
        self.bound = np.zeros(n_slots, dtype=bool)
        self._refs: list = [None] * n_slots

    def bind(self, slot: int, predictor: KalmanPredictor) -> None:
        """Adopt ``predictor``'s scalar state into lane ``slot``."""
        for name in ("A", "H", "Q", "D", "R", "P"):
            getattr(self, name)[slot] = getattr(predictor, name)
        self._refs[slot] = predictor
        self.bound[slot] = True

    def update(self, z: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One fleet-wide filter step. Lanes where ``mask`` is False are
        left untouched (their returned prediction is stale state).

        Per masked lane this is byte-identical to
        ``KalmanPredictor.update(z[slot])``, including the degenerate-
        covariance coast (s <= 0 → keep the a-priori state).
        """
        A, H, Q, D = self.A, self.H, self.Q, self.D
        r_pred = A * self.R
        p_pred = A * self.P * A + Q
        s = H * p_pred * H + D
        deg = s <= 0.0
        k = p_pred * H / np.where(deg, 1.0, s)
        new_r = np.where(deg, r_pred, r_pred + k * (z - H * r_pred))
        new_p = np.where(deg, p_pred, (1.0 - k * H) * p_pred)
        self.R = np.where(mask, new_r, self.R)
        self.P = np.where(mask, new_p, self.P)
        # Python's max(R, 0.0) returns R when R >= 0.0 (so -0.0 stays
        # -0.0) and 0.0 otherwise (including NaN) — mirror that exactly.
        return np.where(self.R >= 0.0, self.R, 0.0)

    def sync_back(self) -> None:
        """Scatter lane state back into the adopted scalar predictors."""
        for slot, ref in enumerate(self._refs):
            if ref is not None:
                ref.R = float(self.R[slot])
                ref.P = float(self.P[slot])
