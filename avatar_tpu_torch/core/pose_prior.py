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

from avatar_tpu_torch.device import get_device


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

    @classmethod
    def load(cls, path: str, dtype=torch.float32,
             device: str | torch.device = "cuda"
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

    def save(self, path: str) -> None:
        """Write ``pose_prior.txt`` from the float64 masters, which ``load``
        of either package reads back exactly."""
        d = self._np
        with open(path, "w") as f:
            f.write(f"{self.n_comps} {self.n_dims}\n")
            f.write(" ".join(repr(float(x)) for x in d["weights"]) + "\n")
            for row in d["means"]:
                f.write(" ".join(repr(float(x)) for x in row) + "\n")
            for c in d["covs"]:
                for row in c:
                    f.write(" ".join(repr(float(x)) for x in row) + "\n")

    def _whiten(self, x: torch.Tensor) -> torch.Tensor:
        """[..., D] -> [..., C, D]: L_c^T (x - mu_c) for every component."""
        return torch.einsum("cdk,...cd->...ck", self.prec_cho,
                            x[..., None, :] - self.means)

    def component_energies(self, x: torch.Tensor) -> torch.Tensor:
        """[..., D] -> [..., C]: |L_c^T (x - mu_c)|^2 * 0.5 - consts_log[c],
        the quantity minimized to choose the residual component."""
        wh = self._whiten(x)
        return 0.5 * torch.sum(wh * wh, dim=-1) - self.consts_log

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        """Mixture density at x, with the reference's minDet normalization
        (GaussianMixture.cpp:84-93)."""
        wh = self._whiten(x)
        quad = torch.sum(wh * wh, dim=-1)
        return torch.sum(self.consts * torch.exp(-0.5 * quad), dim=-1)

    def residual(self, x: torch.Tensor):
        """Whitened min-component residual: [..., D] -> ([..., D+1], comp)."""
        wh = self._whiten(x) * math.sqrt(0.5)                    # [..., C, D]
        energies = torch.sum(wh * wh, dim=-1) - self.consts_log
        comp = torch.argmin(energies, dim=-1)
        idx = comp[..., None, None].expand(*comp.shape, 1, wh.shape[-1])
        best = torch.gather(wh, -2, idx)[..., 0, :]
        const_term = torch.sqrt(-self.consts_log[comp])
        return torch.cat([best, const_term[..., None]], dim=-1), comp

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """Draw from the mixture: [..., D].  A component by weight, then
        ``means[c] + cov_cho[c] @ z`` with z ~ N(0, I).  ``generator``
        lives on the mixture's device."""
        shape = tuple(shape)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        comp = torch.multinomial(self.weights / self.weights.sum(), n,
                                 replacement=True, generator=generator)
        z = torch.randn((n, self.n_dims), dtype=self.means.dtype,
                        device=self.means.device, generator=generator)
        x = self.means[comp] + torch.einsum("ndk,nk->nd", self.cov_cho[comp],
                                            z)
        return x.reshape(shape + (self.n_dims,))
