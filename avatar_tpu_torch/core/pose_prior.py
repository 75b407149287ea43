"""SMPLify-style Gaussian-mixture pose prior (counterpart of
``avatar_tpu/core/pose_prior.py``).

The Cholesky factors are precomputed on the host in float64 numpy exactly
as the reference does; the tensors live on ``device`` in ``dtype``.
Residual convention (reference GaussianMixture.cpp:95-114): for the
min-energy component c, [ L_c^T (x - mu_c) sqrt(0.5) ; sqrt(-consts_log[c]) ].
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class GaussianMixture:
    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 covs: np.ndarray, dtype=torch.float32,
                 device: str | torch.device = "cpu"):
        """weights [C], means [C, D], covs [C, D, D] (numpy, float64)."""
        self.n_comps = int(weights.shape[0])
        self.n_dims = int(means.shape[1])
        weights = np.asarray(weights, np.float64)
        means = np.asarray(means, np.float64)
        covs = np.asarray(covs, np.float64)

        log_sqrt_2pi_n = self.n_dims * 0.5 * np.log(2 * np.pi)
        consts_log = np.log(weights) - log_sqrt_2pi_n
        cov_cho = np.linalg.cholesky(covs)
        prec = np.linalg.inv(covs)
        prec = 0.5 * (prec + np.swapaxes(prec, -1, -2))
        prec_cho = np.linalg.cholesky(prec)
        dets = np.array([np.prod(np.diag(cov_cho[i]))
                         for i in range(self.n_comps)])
        consts_log -= np.log(dets)
        consts_log += np.log(dets.min())        # normalize (ref :72-76)

        self._np = dict(weights=weights, means=means, covs=covs,
                        cov_cho=cov_cho, prec_cho=prec_cho,
                        consts_log=consts_log)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.weights = t(weights)
        self.means = t(means)
        self.prec_cho = t(prec_cho)
        self.consts_log = t(consts_log)

    @classmethod
    def load(cls, path: str, dtype=torch.float32,
             device: str | torch.device = "cpu"
             ) -> Optional["GaussianMixture"]:
        """Load ``pose_prior.txt``; None if the file is missing (the
        reference silently disables the prior)."""
        try:
            with open(path, "r") as f:
                vals = [float(t) for t in f.read().split()]
        except OSError:
            return None
        C, D = int(vals[0]), int(vals[1])
        a = np.asarray(vals[2:])
        weights = a[:C]
        means = a[C:C + C * D].reshape(C, D)
        covs = a[C + C * D:C + C * D + C * D * D].reshape(C, D, D)
        return cls(weights, means, covs, dtype, device)

    def residual(self, x: torch.Tensor):
        """Whitened min-component residual: [..., D] -> ([..., D+1], comp)."""
        diff = x[..., None, :] - self.means                      # [..., C, D]
        wh = torch.einsum("cdk,...cd->...ck", self.prec_cho, diff) * \
            math.sqrt(0.5)
        energies = torch.sum(wh * wh, dim=-1) - self.consts_log
        comp = torch.argmin(energies, dim=-1)
        idx = comp[..., None, None].expand(*comp.shape, 1, wh.shape[-1])
        best = torch.gather(wh, -2, idx)[..., 0, :]
        const_term = torch.sqrt(-self.consts_log[comp])
        return torch.cat([best, const_term[..., None]], dim=-1), comp
