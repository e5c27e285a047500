"""Theorem 1 bound evaluator (port of the JAX package's `core/convergence.py`,
pure Python and numpy as there).

    E[F(w^K)] - F*  <=  (2*kappa / (gamma + K)) * ((B + C)/mu + 2L ||w0 - w*||^2)

with
    kappa = L/mu,  gamma = max{8 kappa, T},  eta_t = 2/(mu (gamma + t)),
    B = sigma^2 + 6 L Gamma + 8 (T-1)^2 G^2,
    C = 4 E_max^2 T^2 eta_t^2 G^2.

Note: the paper's statement prints ``B = sigma^2 6L Gamma + ...`` — a typeset
artifact of the standard FedAvg bound (Li et al. 2020, Thm. 1), where the term
is ``sigma^2 + 6 L Gamma``; we implement the standard form.  ``C`` depends on
``eta_t``; evaluated at a step ``t`` (default 0 → the loosest constant), which
upper-bounds the decreasing schedule.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Theorem1Constants:
    mu: float          # strong convexity
    L: float           # smoothness
    T: int             # local steps per round
    G2: float          # bounded second moment G^2
    sigma2: float      # gradient variance sigma^2
    gamma_het: float   # heterogeneity Gamma = F* - sum_i p_i F_i*
    E_max: int         # max energy renewal cycle
    w0_dist2: float    # ||w0 - w*||^2

    @property
    def kappa(self) -> float:
        return self.L / self.mu

    @property
    def gamma(self) -> float:
        return max(8.0 * self.kappa, float(self.T))

    def eta(self, t: float) -> float:
        return 2.0 / (self.mu * (self.gamma + t))

    def B(self) -> float:
        return self.sigma2 + 6.0 * self.L * self.gamma_het \
            + 8.0 * (self.T - 1) ** 2 * self.G2

    def C(self, t: float = 0.0) -> float:
        # Lemma 2: 4 E_max^2 T^2 eta_t^2 G^2
        return 4.0 * self.E_max ** 2 * self.T ** 2 * self.eta(t) ** 2 * self.G2

    def bound(self, K: int, t_for_C: float = 0.0) -> float:
        """Right-hand side of eq. (53) after K iterations."""
        lead = 2.0 * self.kappa / (self.gamma + K)
        return lead * ((self.B() + self.C(t_for_C)) / self.mu
                       + 2.0 * self.L * self.w0_dist2)


def quadratic_problem_constants(A_list, b_list, p, E, w0, w_star) -> Theorem1Constants:
    """Derive the theorem's constants exactly for client losses
    F_i(w) = 0.5 ||A_i w - b_i||^2 (used by tests/benchmarks on synthetic
    strongly-convex problems where every assumption holds by construction).
    """
    import numpy as np

    mus, Ls, stars = [], [], []
    for A, b in zip(A_list, b_list):
        H = A.T @ A
        ev = np.linalg.eigvalsh(H)
        mus.append(float(ev.min()))
        Ls.append(float(ev.max()))
        w_i = np.linalg.lstsq(A, b, rcond=None)[0]
        stars.append(0.5 * float(np.sum((A @ w_i - b) ** 2)))
    p = np.asarray(p, dtype=np.float64)
    F_star = 0.0
    # global optimum value
    H = sum(pi * A.T @ A for pi, A in zip(p, A_list))
    g = sum(pi * A.T @ b for pi, A, b in zip(p, A_list, b_list))
    F_star = float(sum(pi * 0.5 * np.sum((A @ w_star - b) ** 2)
                       for pi, A, b in zip(p, A_list, b_list)))
    gamma_het = F_star - float(np.dot(p, stars))
    # G^2: bound grad norm over the trajectory region; use a loose ball estimate.
    R = 2.0 * float(np.linalg.norm(np.asarray(w0) - np.asarray(w_star))) + 1.0
    G2 = max(
        float((L * R + np.linalg.norm(A.T @ b - A.T @ A @ w_star)) ** 2)
        for L, A, b in zip(Ls, A_list, b_list)
    )
    return Theorem1Constants(
        mu=min(mus), L=max(Ls), T=1, G2=G2, sigma2=0.0,
        gamma_het=gamma_het, E_max=int(max(np.asarray(E))),
        w0_dist2=float(np.sum((np.asarray(w0) - np.asarray(w_star)) ** 2)),
    )
