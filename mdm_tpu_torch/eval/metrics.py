"""Evaluation metrics (host numpy/scipy): the port's own copy of
mdm_tpu/eval/metrics.py, identical math to the reference
(data_loaders/humanml/utils/metrics.py, eval/unconstrained/metrics/*):
R-precision / matching score, FID (Frechet, scipy sqrtm), diversity,
multimodality, KID (polynomial MMD), and k-NN precision/recall.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import linalg


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """Pairwise euclidean distances [N1, N2]."""
    d1 = -2 * matrix1 @ matrix2.T
    sq1 = (matrix1**2).sum(axis=1, keepdims=True)
    sq2 = (matrix2**2).sum(axis=1)
    return np.sqrt(np.maximum(sq1 + d1 + sq2, 0.0))


def calculate_top_k(mat: np.ndarray, top_k: int) -> np.ndarray:
    """mat: argsort indices of distances; entry (i, k) True if ground-truth
    index i is within top-(k+1)."""
    size = mat.shape[0]
    gt = np.expand_dims(np.arange(size), 1).repeat(top_k, 1)
    bool_mat = mat[:, :top_k] == gt
    correct = np.zeros_like(bool_mat)
    acc = np.zeros(size, dtype=bool)
    for k in range(top_k):
        acc = acc | bool_mat[:, k]
        correct[:, k] = acc
    return correct


def calculate_matching_score(
    embedding1: np.ndarray, embedding2: np.ndarray, sum_all: bool = False
):
    """Distance between paired rows (reference metrics.py:47-56)."""
    dist = np.linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_R_precision(
    embedding1: np.ndarray, embedding2: np.ndarray, top_k: int = 3, sum_all: bool = False
):
    """Top-k retrieval correctness over the pairwise-distance argsort."""
    dist_mat = euclidean_distance_matrix(embedding1, embedding2)
    argsm = np.argsort(dist_mat, axis=1)
    top_k_mat = calculate_top_k(argsm, top_k=top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_activation_statistics(activations: np.ndarray):
    mu = np.mean(activations, axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Frechet distance between two Gaussians (scipy sqrtm, standard FID)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # (sqrtm's `disp` flag, which mdm_tpu passes, is gone from newer scipy;
    # the square root is the same without it)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def calculate_diversity(
    activation: np.ndarray,
    diversity_times: int,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """Same sampling logic as the reference (metrics.py:73-82) but with an
    explicit Generator (repo convention) so eval numbers are reproducible."""
    rng = rng if rng is not None else np.random.default_rng()
    num_samples = activation.shape[0]
    first = rng.choice(num_samples, diversity_times, replace=False)
    second = rng.choice(num_samples, diversity_times, replace=False)
    return float(np.linalg.norm(activation[first] - activation[second], axis=1).mean())


def calculate_multimodality(
    activation: np.ndarray,
    multimodality_times: int,
    rng: Optional[np.random.Generator] = None,
) -> float:
    """activation: [N, n_per_condition, D]."""
    rng = rng if rng is not None else np.random.default_rng()
    num_per_sent = activation.shape[1]
    first = rng.choice(num_per_sent, multimodality_times, replace=False)
    second = rng.choice(num_per_sent, multimodality_times, replace=False)
    return float(
        np.linalg.norm(activation[:, first] - activation[:, second], axis=2).mean()
    )


# ------------------------------------------------------------------- KID
def polynomial_mmd(codes_g: np.ndarray, codes_r: np.ndarray, degree=3, gamma=None,
                   coef0=1) -> float:
    """Unbiased polynomial-kernel MMD^2 (reference unconstrained KID)."""
    X, Y = codes_g, codes_r
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    K_XX = (gamma * (X @ X.T) + coef0) ** degree
    K_YY = (gamma * (Y @ Y.T) + coef0) ** degree
    K_XY = (gamma * (X @ Y.T) + coef0) ** degree

    m = K_XX.shape[0]
    n = K_YY.shape[0]
    mmd = (
        (K_XX.sum() - np.trace(K_XX)) / (m * (m - 1))
        + (K_YY.sum() - np.trace(K_YY)) / (n * (n - 1))
        - 2 * K_XY.mean()
    )
    return float(mmd)


def calculate_kid(real: np.ndarray, gen: np.ndarray, n_subsets=100, subset_size=1000,
                  rng=None) -> Tuple[float, float]:
    """KID mean +- std over random subsets."""
    rng = rng or np.random.RandomState(0)
    subset_size = min(subset_size, len(real), len(gen))
    vals = []
    for _ in range(n_subsets):
        g = gen[rng.choice(len(gen), subset_size, replace=False)]
        r = real[rng.choice(len(real), subset_size, replace=False)]
        vals.append(polynomial_mmd(g, r))
    return float(np.mean(vals)), float(np.std(vals))


# ------------------------------------------------- k-NN precision / recall
def precision_and_recall(
    generated: np.ndarray, real: np.ndarray, neighborhood_size: int = 3
) -> Tuple[float, float]:
    """Manifold-estimate precision/recall (Kynkaanniemi et al.; reference
    eval/unconstrained/metrics/precision_recall.py)."""

    def manifold_radii(feats):
        d = euclidean_distance_matrix(feats, feats)
        # k-th nearest (excluding self at distance 0)
        return np.sort(d, axis=1)[:, neighborhood_size]

    radii_real = manifold_radii(real)
    radii_gen = manifold_radii(generated)

    d_gr = euclidean_distance_matrix(generated, real)
    precision = float(((d_gr <= radii_real[None, :]).any(axis=1)).mean())
    d_rg = d_gr.T
    recall = float(((d_rg <= radii_gen[None, :]).any(axis=1)).mean())
    return precision, recall
