"""Post-hoc confidence calibration: a copy of ``rag_uq_tpu/uq/scaling.py``.

Platt scaling, isotonic regression and a multi-feature logistic, in numpy.

The raw UQ confidences (MC disagreement, conformal estimates) are
*rankings* of reliability, not calibrated probabilities — a small
near-deterministic extractor emits ~0.97 confidence whether or not it is
right, so ECE against empirical accuracy is large even when coverage
holds. Platt scaling (Platt 1999) fits a 2-parameter logistic
p(correct | s) = sigmoid(A*s + B) on a labeled calibration split and maps
test-time confidences through it. This is a capability the reference does
not have (its eval protocol reports ECE on raw confidences and leaves the
<0.05 target aspirational, wiki/Evaluation-Protocol.md:59-63); the raw
metrics remain reported alongside.

Implementation notes: Newton's method on the 2-d problem with Platt's
prior-smoothed targets t+ = (N+ + 1)/(N+ + 2), t- = 1/(N- + 2), which keep
the fit finite when the calibration split is small or one-sided (all
correct / all wrong) — exactly the regimes a 100-example split hits.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _sigmoid(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def fit_platt(
    scores: Sequence[float],
    correct: Sequence[bool],
    max_iter: int = 100,
    tol: float = 1e-9,
) -> Tuple[float, float]:
    """Fit (A, B) of p = sigmoid(A*s + B) by Newton's method.

    `scores` are raw confidences (any monotone reliability score),
    `correct` the boolean outcomes on the calibration split.
    """
    s = np.asarray(scores, dtype=np.float64)
    y = np.asarray(correct, dtype=np.float64)
    if s.size == 0:
        return 1.0, 0.0
    n_pos = float(y.sum())
    n_neg = float(y.size - n_pos)
    # Platt's smoothed targets: never exactly 0/1, so the loss has a
    # finite minimum even for a one-sided split.
    t = np.where(y > 0.5, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))

    a, b = 0.0, float(np.log((n_pos + 1.0) / (n_neg + 1.0)))
    for _ in range(max_iter):
        p = _sigmoid(a * s + b)
        w = np.maximum(p * (1.0 - p), 1e-12)
        g = p - t  # dLoss/dz per example
        grad = np.array([np.sum(g * s), np.sum(g)])
        h11 = np.sum(w * s * s)
        h12 = np.sum(w * s)
        h22 = np.sum(w)
        hess = np.array([[h11, h12], [h12, h22]])
        hess += 1e-9 * np.eye(2)
        try:
            step = np.linalg.solve(hess, grad)
        except np.linalg.LinAlgError:  # pragma: no cover - ridge prevents it
            break
        a -= float(step[0])
        b -= float(step[1])
        if float(np.abs(step).max()) < tol:
            break
    return float(a), float(b)


def apply_platt(
    scores: Sequence[float], a: float, b: float
) -> np.ndarray:
    """Map raw confidences through the fitted logistic."""
    s = np.asarray(scores, dtype=np.float64)
    return _sigmoid(a * s + b)


def fit_logistic(
    features: np.ndarray,
    correct: Sequence[bool],
    max_iter: int = 200,
    ridge: float = 1e-3,
) -> np.ndarray:
    """Multi-feature Platt: fit w of p = sigmoid(features @ w[:-1] + w[-1]).

    The single-score Platt fit caps how much calibration can help when one
    score (MC embedding variance) is nearly binary; a handful of cheap side signals (consensus agreement rate,
    answer length spread, lexical diversity, retrieval margin) carry the
    rest of p(correct). Newton's method with the same prior-smoothed
    targets as `fit_platt`; features are z-scored internally and the
    normalization folded into the returned weights, so `apply_logistic`
    takes RAW features.
    """
    x = np.asarray(features, dtype=np.float64)
    y = np.asarray(correct, dtype=np.float64)
    if x.ndim != 2 or x.shape[0] == 0:
        return np.zeros(x.shape[1] + 1 if x.ndim == 2 else 1)
    mu = x.mean(axis=0)
    sd = np.maximum(x.std(axis=0), 1e-9)
    xz = (x - mu) / sd
    n_pos = float(y.sum())
    n_neg = float(y.size - n_pos)
    t = np.where(y > 0.5, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))

    f = x.shape[1]
    xa = np.concatenate([xz, np.ones((x.shape[0], 1))], axis=1)
    w = np.zeros(f + 1)
    w[-1] = float(np.log((n_pos + 1.0) / (n_neg + 1.0)))
    for _ in range(max_iter):
        p = _sigmoid(xa @ w)
        wt = np.maximum(p * (1.0 - p), 1e-12)
        grad = xa.T @ (p - t) + ridge * w
        hess = (xa * wt[:, None]).T @ xa + ridge * np.eye(f + 1)
        try:
            step = np.linalg.solve(hess, grad)
        except np.linalg.LinAlgError:  # pragma: no cover
            break
        w -= step
        if float(np.abs(step).max()) < 1e-9:
            break
    # Fold the z-scoring into the weights: z = (x - mu) / sd.
    out = np.empty(f + 1)
    out[:f] = w[:f] / sd
    out[-1] = w[-1] - float(np.sum(w[:f] * mu / sd))
    return out


def apply_logistic(features: np.ndarray, w: np.ndarray) -> np.ndarray:
    """p(correct) from raw features and `fit_logistic` weights."""
    x = np.asarray(features, dtype=np.float64)
    return _sigmoid(x @ w[:-1] + w[-1])


def fit_isotonic(
    scores: Sequence[float], correct: Sequence[bool]
) -> Tuple[np.ndarray, np.ndarray]:
    """Isotonic regression (pool-adjacent-violators) of correctness on score.

    Returns (xs, gs): the sorted score knots and the fitted monotone
    p(correct) at each; `apply_isotonic` interpolates between knots
    (clamped at the ends). Non-parametric alternative to Platt when the
    score-accuracy relation is monotone but not logistic-shaped.
    """
    s = np.asarray(scores, dtype=np.float64)
    y = np.asarray(correct, dtype=np.float64)
    if s.size == 0:
        return np.array([0.0, 1.0]), np.array([0.5, 0.5])
    order = np.argsort(s, kind="stable")
    xs, ys = s[order], y[order]
    # PAV with blocks of (weight, mean).
    vals: list = []  # [sum, weight, start_idx]
    for i in range(xs.size):
        vals.append([ys[i], 1.0])
        while len(vals) > 1 and (
            vals[-2][0] / vals[-2][1] >= vals[-1][0] / vals[-1][1]
        ):
            s2, w2 = vals.pop()
            vals[-1][0] += s2
            vals[-1][1] += w2
    gs = np.concatenate([
        np.full(int(w_), v_ / w_) for v_, w_ in vals
    ])
    # Collapse duplicate score knots: np.interp over repeated x
    # values returns an arbitrary-sided value, so tied input scores that
    # straddle a PAV block boundary could map through a discontinuity. Keep
    # one knot per unique score with the weight-averaged fitted value (which
    # preserves monotonicity: the average of a nondecreasing run lies
    # between its neighbors' averages).
    if xs.size > 1:
        uniq, inv, counts = np.unique(xs, return_inverse=True,
                                      return_counts=True)
        if uniq.size < xs.size:
            sums = np.zeros(uniq.size)
            np.add.at(sums, inv, gs)
            xs, gs = uniq, sums / counts
    return xs, gs


def apply_isotonic(
    scores: Sequence[float], xs: np.ndarray, gs: np.ndarray
) -> np.ndarray:
    """Interpolate fitted isotonic values at new scores."""
    return np.interp(np.asarray(scores, dtype=np.float64), xs, gs)
