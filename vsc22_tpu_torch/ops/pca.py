"""PCA, the ensemble-fusion dimensionality reduction.

Counterpart of `vsc22_tpu/ops/pca.py`: exact PCA from the eigendecomposition
of the D x D covariance, with sklearn's `svd_flip` sign rule (the
largest-|loading| entry of each component made positive). The fit runs in
float64 on the given device; `PCAModel` and its transform are numpy, as in
the JAX package, so a JAX-fitted model's arrays carry over unchanged; its
npz file (`save`, `load`) has the JAX package's keys, so a PCA written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vsc22_tpu_torch.core.device import resolve


@dataclasses.dataclass
class PCAModel:
    mean: np.ndarray  # [D]
    components: np.ndarray  # [k, D] rows = principal axes
    explained_variance: np.ndarray  # [k]

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mean) @ self.components.T

    def save(self, path: str) -> None:
        np.savez(
            path,
            mean=self.mean,
            components=self.components,
            explained_variance=self.explained_variance,
        )

    @classmethod
    def load(cls, path: str) -> "PCAModel":
        with np.load(path) as data:
            return cls(
                mean=data["mean"],
                components=data["components"],
                explained_variance=data["explained_variance"],
            )


def pca_fit(x: np.ndarray, n_components: int, device="cuda") -> PCAModel:
    """Fit exact PCA on rows `x`, on the card unless `device` says otherwise;
    returns the top `n_components` axes."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=resolve(device)).double()
    mean = xt.mean(dim=0)
    xc = xt - mean
    cov = xc.t() @ xc / (xt.shape[0] - 1)
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    eigvals = eigvals.flip(0)
    components = eigvecs.flip(1).t()  # rows = axes, descending variance
    max_idx = components.abs().argmax(dim=1)
    signs = torch.sign(components[torch.arange(components.shape[0]), max_idx])
    components = components * signs[:, None]
    k = n_components
    return PCAModel(
        mean=mean.float().cpu().numpy(),
        components=components[:k].float().cpu().numpy(),
        explained_variance=eigvals[:k].clamp(min=0.0).float().cpu().numpy(),
    )
