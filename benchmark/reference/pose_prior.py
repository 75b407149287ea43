"""SMPLify-style Gaussian-mixture pose prior (frozen copy of the port's ``core/pose_prior.py``).

The Cholesky factors are precomputed on the host in float64 numpy exactly
as the reference does; the tensors live on ``device`` in ``dtype``.
Residual convention (reference GaussianMixture.cpp:95-114): for the
min-energy component c, [ L_c^T (x - mu_c) sqrt(0.5) ; sqrt(-consts_log[c]) ].
"""

from __future__ import annotations


import numpy as np
import torch

from torch import device as get_device


class GaussianMixture:
    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 covs: np.ndarray, dtype=torch.float32,
                 device: str | torch.device = "cuda"):
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
        device = get_device(device)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.weights = t(weights)
        self.means = t(means)
        self.cov_cho = t(cov_cho)
        self.prec_cho = t(prec_cho)
        self.consts_log = t(consts_log)
        self.consts = torch.exp(self.consts_log)
