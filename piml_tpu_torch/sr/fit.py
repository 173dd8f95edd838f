"""Force-law fitting: free-form SR + closed-form family fit.

A copy of ``piml_tpu/sr/fit.py`` (numpy + scipy, on the host).

Reference: src/symbolic_regression.py:38-52 fits the extracted (features,
messages) pairs with PySR (Julia, ops ``+ * exp cos``).  Here
:func:`symbolic_regression` runs PySR when installed, and otherwise the
native GP engine (:mod:`piml_tpu_torch.sr.gp`) — same operator set and search
shape, no Julia/network dependency.  :func:`fit_force_law` additionally
fits the known discovered family
``F(r, cosθ) = A · exp(B·r + C·cosθ + D·r·cosθ)`` in closed form —
log-linear least squares — which is exactly the family the reference's SR
runs converged to (src/models/mlapm.py, src/utils/utils.py:47-93).  The
fitted constants feed :class:`piml_tpu_torch.models.MLAPMParams` and the
``pinnsf_interaction='loss'`` supervision for the next PIML iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

try:  # optional PySR bridge (PySR and Julia are not dependencies)
    from pysr import PySRRegressor  # type: ignore

    HAVE_PYSR = True
except Exception:  # pragma: no cover
    HAVE_PYSR = False


@dataclasses.dataclass
class ForceLawFit:
    A: float
    B: float
    C: float
    D: float
    r2: float  # coefficient of determination in log space

    def magnitude(self, r: np.ndarray, cos: np.ndarray) -> np.ndarray:
        return self.A * np.exp(self.B * r + self.C * cos + self.D * r * cos)


def fit_force_law(
    r: np.ndarray, cos: np.ndarray, magnitude: np.ndarray,
    include_cos: bool = True, eps: float = 1e-8,
) -> ForceLawFit:
    """Log-linear least squares for ``A·exp(B·r + C·cosθ + D·r·cosθ)``.

    ``include_cos=False`` restricts to the v0 family ``A·exp(B·r)``.
    """
    keep = magnitude > eps
    r, cos, mag = r[keep], cos[keep], magnitude[keep]
    if mag.size == 0:  # nothing informative extracted (e.g. toy scenes)
        return ForceLawFit(A=0.0, B=0.0, C=0.0, D=0.0, r2=0.0)
    y = np.log(mag)
    cols = [np.ones_like(r), r]
    if include_cos:
        cols += [cos, r * cos]
    X = np.stack(cols, axis=1)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    pred = X @ coef
    ss_res = np.sum((y - pred) ** 2)
    ss_tot = np.sum((y - y.mean()) ** 2) + 1e-12
    A = float(np.exp(coef[0]))
    B = float(coef[1])
    C = float(coef[2]) if include_cos else 0.0
    D = float(coef[3]) if include_cos else 0.0
    return ForceLawFit(A=A, B=B, C=C, D=D, r2=float(1 - ss_res / ss_tot))


def fit_force_law_mse(
    r: np.ndarray, cos: np.ndarray, magnitude: np.ndarray,
    include_cos: bool = True, init: Optional[ForceLawFit] = None,
) -> ForceLawFit:
    """Nonlinear least squares on the magnitudes themselves.

    The log-linear fit (:func:`fit_force_law`) is pathologically sensitive
    to additive noise: the magnitude distribution is dominated by far pairs
    with |F| ~ 1e-4-1e-3 whose logs are pure noise floor — measured, 1.3%
    additive noise drags the fitted A from 9.55 to 0.94.  Direct MSE (the
    objective PySR minimizes, reference symbolic_regression.py:38-52)
    weights the informative large-|F| region instead; this is the fit the
    paper's constants come from.  The reported ``r2`` is linear-space.
    """
    try:
        from scipy.optimize import least_squares
    except Exception:  # pragma: no cover - scipy is a dependency
        least_squares = None
    mag = np.asarray(magnitude, np.float64)
    r = np.asarray(r, np.float64)
    cos = np.asarray(cos, np.float64)
    if mag.size == 0:
        return init or ForceLawFit(A=0.0, B=0.0, C=0.0, D=0.0, r2=0.0)

    def predict(p):
        logA, B, C, D = p
        return np.exp(np.clip(logA + B * r + C * cos + D * r * cos, -60, 60))

    if init is None:
        p0 = np.array([np.log(max(mag.max(), 1e-6)), -1.0, 0.0, 0.0])
    else:
        p0 = np.array([np.log(max(init.A, 1e-6)), init.B, init.C, init.D])
    if not include_cos:
        p0[2:] = 0.0

    def resid(p):
        if not include_cos:
            p = np.array([p[0], p[1], 0.0, 0.0])
        return predict(p) - mag

    if least_squares is not None:
        sol = least_squares(resid, p0 if include_cos else p0[:2],
                            method="lm", max_nfev=2000)
        p = sol.x if include_cos else np.array([*sol.x, 0.0, 0.0])
    else:  # crude fallback: keep the init
        p = p0
    pred = predict(p)
    ss_res = float(np.sum((mag - pred) ** 2))
    ss_tot = float(np.sum((mag - mag.mean()) ** 2)) + 1e-12
    return ForceLawFit(A=float(np.exp(p[0])), B=float(p[1]), C=float(p[2]),
                       D=float(p[3]), r2=1.0 - ss_res / ss_tot)


@dataclasses.dataclass
class VectorForceLawFit:
    A: float
    B: float
    C: float
    D: float
    theta_deg: float
    r2: float  # linear-space, on the force components

    def force(self, dr: np.ndarray, dv: np.ndarray,
              eps: float = 1e-6) -> np.ndarray:
        r = np.linalg.norm(dr, axis=-1, keepdims=True) + eps
        e = dr / r
        v = np.linalg.norm(dv, axis=-1, keepdims=True) + eps
        cos = np.sum(dr * dv, axis=-1, keepdims=True) / r / v
        mag = self.A * np.exp(self.B * r + self.C * cos + self.D * r * cos)
        th = np.deg2rad(self.theta_deg)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        return -mag * (e @ rot.T)


def fit_vector_force_law(
    dr: np.ndarray, dv: np.ndarray, force: np.ndarray,
    init: Optional[VectorForceLawFit] = None, eps: float = 1e-6,
) -> VectorForceLawFit:
    """Joint nonlinear least squares of the full VECTOR law
    ``F⃗ = −A·exp(B·r + C·cosθ + D·r·cosθ) · R(θ_bias) · ê_r``
    on per-edge (relative position, relative velocity, 2-D force) triples
    (VERDICT r2 item 10).

    The magnitude-only fit cannot see C/D when the supervision's cos is
    degenerate (the reference's dv-from-dr quirk, utils.py:67,84 — cos ≡ 1
    folds them into A·e^C and B+D); this fit recovers all five constants
    whenever cos actually varies (quirk-free supervision,
    ``pairwise_acceleration(dv_from_velocity=True)``).
    """
    dr = np.asarray(dr, np.float64)
    dv = np.asarray(dv, np.float64)
    force = np.asarray(force, np.float64)
    if dr.size == 0:
        return init or VectorForceLawFit(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    r = np.linalg.norm(dr, axis=-1, keepdims=True) + eps
    e = dr / r
    v = np.linalg.norm(dv, axis=-1, keepdims=True) + eps
    cos = np.sum(dr * dv, axis=-1, keepdims=True) / r / v

    def predict(p):
        logA, B, C, D, th = p
        mag = np.exp(np.clip(logA + B * r + C * cos + D * r * cos, -60, 60))
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        return -mag * (e @ rot.T)

    def resid(p):
        return (predict(p) - force).ravel()

    if init is None:
        mag0 = np.linalg.norm(force, axis=-1)
        p0 = np.array([np.log(max(mag0.max(), 1e-6)), -1.0, 0.0, 0.0, 0.0])
    else:
        p0 = np.array([np.log(max(init.A, 1e-6)), init.B, init.C, init.D,
                       np.deg2rad(init.theta_deg)])

    from scipy.optimize import least_squares

    sol = least_squares(resid, p0, method="lm", max_nfev=5000)
    p = sol.x
    pred = predict(p)
    ss_res = float(np.sum((force - pred) ** 2))
    ss_tot = float(np.sum((force - force.mean(axis=0)) ** 2)) + 1e-12
    return VectorForceLawFit(
        A=float(np.exp(p[0])), B=float(p[1]), C=float(p[2]), D=float(p[3]),
        theta_deg=float(np.rad2deg(p[4])), r2=1.0 - ss_res / ss_tot,
    )


def fit_direction_bias(direction: np.ndarray, sign_feature: np.ndarray) -> float:
    """Fit the angular bias theta (degrees): the discovered direction law is
    ``θ_force ≈ θ_r + sign · theta`` (reference MLAPM rotation,
    mlapm.py:33-38).  Estimates theta as the mean |direction| residual."""
    keep = np.abs(sign_feature) > 0
    if keep.sum() == 0:
        return 0.0
    return float(np.rad2deg(np.mean(np.abs(direction[keep]))))


class _PySRAdapter:  # pragma: no cover - PySR is optional
    """Expose the GP engine's interface (``best()`` → .expression/.loss/
    .complexity, ``equations_``, ``predict``) over a fitted PySRRegressor,
    whose own API is ``get_best()`` with 'equation'/'loss' row fields."""

    def __init__(self, model):
        self._model = model
        from piml_tpu_torch.sr.gp import Equation

        self.equations_ = [
            Equation(int(row["complexity"]), float(row["loss"]),
                     float(row.get("score", 0.0)), str(row["equation"]), None)
            for _, row in model.equations_.iterrows()
        ]

    def best(self):
        row = self._model.get_best()
        from piml_tpu_torch.sr.gp import Equation

        return Equation(int(row["complexity"]), float(row["loss"]),
                        float(row.get("score", 0.0)), str(row["equation"]),
                        None)

    def predict(self, X):
        return self._model.predict(X)


def symbolic_regression(X: np.ndarray, y: np.ndarray,
                        unary_ops=("exp", "cos"), niterations: int = 10,
                        populations: int = 8, seed: int = 0):
    """Full symbolic-regression search (reference:
    symbolic_regression.py:38-52).  Uses PySR when installed; otherwise the
    native GP engine (:class:`piml_tpu_torch.sr.gp.GPSymbolicRegressor`)
    runs the same search — identical operator set, populations and
    iteration budget — with no Julia/network dependency.  Either way the returned model exposes
    ``equations_`` (pareto table), ``best()`` and ``predict(X)``."""
    if HAVE_PYSR:  # pragma: no cover - PySR is optional
        model = PySRRegressor(
            niterations=niterations,
            populations=populations,
            binary_operators=["+", "*"],
            unary_operators=list(unary_ops),
        )
        model.fit(X, y)
        return _PySRAdapter(model)
    from piml_tpu_torch.sr.gp import GPSymbolicRegressor

    model = GPSymbolicRegressor(
        binary_operators=("+", "*"), unary_operators=tuple(unary_ops),
        populations=populations, niterations=niterations, seed=seed,
    )
    model.fit(X, y)
    return model
