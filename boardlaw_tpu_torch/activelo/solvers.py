"""Variational-Bayes Elo: a full-covariance Gaussian posterior over ratings.
Counterpart of boardlaw_tpu/activelo/solvers.py, with its model and settings.

The prior is N(0, 10^2) per rating and the likelihood Bradley-Terry; the
ELBO is maximised over a full-covariance Gaussian q(ratings), Sigma = L L^T
with a softplus-positive diagonal Cholesky factor packed as the JAX package
packs it (mu, then the lower triangle row by row). E[-log(1 + e^-d)] under
N(mu_d, sigma_d^2) is Gauss-Hermite quadrature at the JAX package's 50
nodes, differentiated by torch autograd in float32 (the JAX package's
jax.value_and_grad runs in float32 too) on `device`, the card unless the
caller asks for another. scipy's L-BFGS drives it with the JAX settings;
the host syncs once per evaluation, for the value and gradient together.

Games and wins come as numpy matrices (optionally with `names`) or as
pandas DataFrames; a `Solution` holds numpy fields and the names, or frames
when given frames (pandas is imported only then).
"""
from __future__ import annotations

from dataclasses import dataclass
from logging import getLogger

import numpy as np
import scipy.optimize
import torch

from ..elos import _is_frame, _value_and_grad
from ..utils import resolve_device

log = getLogger(__name__)

MU_0 = 0.0
SIGMA_0 = 10.0

_HERM_POINTS = 50
_herm_z, _herm_w = np.polynomial.hermite_e.hermegauss(_HERM_POINTS)
_HERM_W = _herm_w / np.sqrt(2 * np.pi)


def _quadrature(device):
    f32 = torch.float32
    return (torch.tensor(_herm_z, dtype=f32, device=device),
            torch.tensor(_HERM_W, dtype=f32, device=device))


def expected_log_sigmoid(mu, sigma2):
    """E[-log(1 + e^-d)] for d ~ N(mu, sigma2), by Gauss-Hermite quadrature.
    Differentiable in both arguments."""
    z, w = _quadrature(mu.device)
    d = mu[..., None] + z * torch.sqrt(torch.clamp_min(sigma2, 1e-12))[..., None]
    return (-torch.logaddexp(torch.zeros_like(d), -d) * w).sum(-1)


def _unpack(theta, N):
    mu = theta[:N]
    rows, cols = torch.tril_indices(N, N, device=theta.device)
    tril = torch.zeros((N, N), dtype=theta.dtype, device=theta.device).index_put(
        (rows, cols), theta[N:])
    diag = torch.logaddexp(torch.diagonal(tril), torch.zeros((), device=theta.device)) + 1e-6
    L = tril - torch.diag(torch.diagonal(tril)) + torch.diag(diag)
    return mu, L


def _pack_init(mu, Sigma, N):
    L = np.linalg.cholesky(Sigma)
    d = np.diagonal(L).copy()
    # invert softplus for the diagonal
    raw = np.log(np.expm1(np.maximum(d - 1e-6, 1e-8)))
    L = L.copy()
    L[np.diag_indices(N)] = raw
    return np.concatenate([np.asarray(mu), L[np.tril_indices(N)]])


def _elbo(theta, n, w, N):
    mu, L = _unpack(theta, N)
    Sigma = L @ L.T

    # entropy of q
    logdet = 2 * torch.log(torch.diagonal(L)).sum()
    entropy = 0.5 * (N * np.log(2 * np.pi * np.e) + logdet)

    # E_q[log prior]
    prior = (-0.5 * np.log(2 * np.pi) - np.log(SIGMA_0)
             - 1 / (2 * SIGMA_0 ** 2) * ((mu - MU_0).square() + torch.diagonal(Sigma))).sum()

    # E_q[log likelihood] over all ordered pairs
    mud = mu[:, None] - mu[None, :]
    diag = torch.diagonal(Sigma)
    s2d = diag[:, None] + diag[None, :] - 2 * Sigma
    p = expected_log_sigmoid(mud, s2d)
    q = expected_log_sigmoid(-mud, s2d)
    offdiag = 1.0 - torch.eye(N, device=theta.device)
    ll = ((w * p + (n - w) * q) * offdiag).sum()
    return entropy + prior + ll


@dataclass
class Solution:
    n: object
    w: object
    mu: object
    Sigma: object
    mud: object
    sigmad: object
    names: list | None = None

    # Greek-letter aliases matching the reference's field names
    @property
    def μ(self):
        return self.mu

    @property
    def Σ(self):
        return self.Sigma

    @property
    def μd(self):
        return self.mud

    @property
    def σd(self):
        return self.sigmad


def _solve(n, w, soln=None, max_iter=200, names=None, device=None):
    dev = resolve_device(device)
    # C order whatever the frame's layout (the float32 sums depend on it)
    n = np.ascontiguousarray(n, float)
    w = np.ascontiguousarray(w, float)
    N = n.shape[0]
    if soln is not None:
        theta0 = _pack_init(np.asarray(soln.mu), np.asarray(soln.Sigma), N)
    else:
        theta0 = _pack_init(np.zeros(N), np.eye(N), N)

    nt = torch.tensor(n, dtype=torch.float32, device=dev)
    wt = torch.tensor(w, dtype=torch.float32, device=dev)
    res = scipy.optimize.minimize(_value_and_grad(lambda t: -_elbo(t, nt, wt, N), dev), theta0,
                                  jac=True, method="L-BFGS-B", options={"maxiter": max_iter})
    if not np.isfinite(res.fun):
        log.warning(f"activelo did not converge: {res.message}")

    with torch.no_grad():
        mu, L = _unpack(torch.tensor(res.x, dtype=torch.float32, device=dev), N)
        Sigma = (L @ L.T).cpu().numpy()
    mu = mu.cpu().numpy()
    diag = np.diagonal(Sigma)
    s2d = diag[:, None] + diag[None, :] - 2 * Sigma
    return Solution(n=n, w=w, mu=mu, Sigma=Sigma, mud=mu[:, None] - mu[None, :],
                    sigmad=np.sqrt(np.maximum(s2d, 0)), names=names)


def solve(n, w, soln=None, names=None, device=None, **kwargs):
    """Posterior over ratings from games/wins matrices, numpy (with
    optional `names`) or pandas DataFrames; DataFrames in give pandas
    fields out."""
    if not _is_frame(n):
        return _solve(n, w, soln=soln, names=None if names is None else list(names),
                      device=device, **kwargs)
    import pandas as pd

    s = _solve(n.values, w.values, soln=soln, names=list(n.index), device=device, **kwargs)
    idx = n.index
    return Solution(n=n, w=w, mu=pd.Series(s.mu, idx), Sigma=pd.DataFrame(s.Sigma, idx, idx),
                    mud=pd.DataFrame(s.mud, idx, idx), sigmad=pd.DataFrame(s.sigmad, idx, idx),
                    names=s.names)
