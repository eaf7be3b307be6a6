"""Action-to-motion evaluation (HumanAct12 GRU / UESTC STGCN protocols).

Counterpart of mdm_tpu/eval/harness_a2m.py (reference
eval/eval_humanact12_uestc.py + eval/a2m/*): per-seed passes over {gen,
gt, gt2} loaders computing classifier accuracy, FID (every loader vs gt,
gt itself as the sanity row), diversity and multimodality on classifier
features, summarized mean +- CI across seeds; and the unconstrained
protocol's metrics (STGCN features -> FID / KID / precision-recall /
diversity, reference eval/unconstrained/evaluate.py).

The classifier is a module on its device (``MotionDiscriminator``, or an
``a2m_setup.StgcnAdapter``), run under ``networks.f32_math``: its outputs
stay on the device until one copy per pass. The metrics are the host numpy
of ``eval/metrics.py``, with mdm_tpu's random draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from . import metrics as M
from .networks import f32_math


def classifier_accuracy(feats_yhat: np.ndarray, labels: np.ndarray) -> float:
    return float((feats_yhat.argmax(axis=1) == labels).mean())


def diversity_and_multimodality(
    activations: np.ndarray, labels: Optional[np.ndarray], num_labels: int,
    diversity_times: int = 200, multimodality_times: int = 20,
    rng: Optional[np.random.Generator] = None, unconstrained: bool = False,
) -> Dict[str, float]:
    """The reference algorithm (eval/a2m/action2motion/diversity.py:21-66)
    with mdm_tpu's draws: diversity = mean distance over ``diversity_times``
    with-replacement pairs; multimodality = quota-based rejection sampling
    of same-label pairs, normalized by multimodality_times * num_labels
    (labels absent from the batch keep quota 0 but count in the
    denominator)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    n = len(activations)
    first = rng.integers(0, n, diversity_times)
    second = rng.integers(0, n, diversity_times)
    diversity = float(np.linalg.norm(activations[first] - activations[second], axis=1).mean())

    if unconstrained or labels is None:
        return {"diversity": diversity, "multimodality": float("nan")}

    labels = np.asarray(labels)
    multimodality = 0.0
    label_quotas = np.zeros(num_labels)
    label_quotas[np.unique(labels)] = multimodality_times
    while np.any(label_quotas > 0):
        first_idx = int(rng.integers(0, n))
        first_label = labels[first_idx]
        if not label_quotas[first_label]:
            continue
        second_idx = int(rng.integers(0, n))
        while labels[second_idx] != first_label:
            second_idx = int(rng.integers(0, n))
        label_quotas[first_label] -= 1
        multimodality += float(
            np.linalg.norm(activations[first_idx] - activations[second_idx])
        )
    multimodality /= multimodality_times * num_labels
    return {"diversity": diversity, "multimodality": float(multimodality)}


@dataclass
class A2MEvalConfig:
    num_classes: int = 12
    diversity_times: int = 200
    multimodality_times: int = 20


class A2MEvaluation:
    """Computes per-seed metrics over {gen, gt, gt2} motion loaders.

    Each loader yields dicts with ``output_xyz`` [B, T, ...] (the
    classifier's input: flattened smpl joints, or rot6d for the STGCN),
    ``lengths`` [B], and ``y`` [B] labels. The classifier's features give
    FID, diversity and multimodality."""

    def __init__(self, classifier: nn.Module, config: A2MEvalConfig = A2MEvalConfig()):
        self.config = config
        self.classifier = classifier.eval()

    @torch.no_grad()
    @f32_math()
    def _collect(self, loader: Iterable) -> Dict[str, np.ndarray]:
        classifier = self.classifier
        device = next(classifier.parameters()).device
        feats, yhat, labels = [], [], []
        for batch in loader:
            out = classifier(torch.as_tensor(batch["output_xyz"]).to(device), batch["lengths"])
            feats.append(out["features"])
            yhat.append(out["yhat"])
            if "y" in batch:
                labels.append(np.asarray(batch["y"]))
        return {
            "features": torch.cat(feats).cpu().numpy(),
            "yhat": torch.cat(yhat).cpu().numpy(),
            "labels": np.concatenate(labels) if labels else None,
        }

    def evaluate(self, loaders: Dict[str, Iterable], seed: int = 0, rng=None
                 ) -> Dict[str, float]:
        cfg = self.config
        rng = rng if rng is not None else np.random.default_rng(seed)
        metrics: Dict[str, float] = {}
        stats = {}
        for key, loader in loaders.items():
            data = self._collect(loader)
            if data["labels"] is not None:
                metrics[f"accuracy_{key}"] = classifier_accuracy(data["yhat"], data["labels"])
            else:
                metrics[f"accuracy_{key}"] = float("nan")
            stats[key] = M.calculate_activation_statistics(data["features"])
            dm = diversity_and_multimodality(
                data["features"], data["labels"],
                cfg.num_classes, cfg.diversity_times, cfg.multimodality_times, rng,
                unconstrained=data["labels"] is None,
            )
            metrics[f"diversity_{key}"] = dm["diversity"]
            metrics[f"multimodality_{key}"] = dm["multimodality"]

        # FID for every loader vs gt, gt itself included (~0, the
        # reference's sanity row, evaluate.py:75-83).
        for key in loaders:
            metrics[f"fid_{key}"] = M.calculate_frechet_distance(*stats["gt"], *stats[key])
        return metrics


def evaluate_multi_seed(
    make_loaders: Callable[[int], Dict[str, Iterable]],
    evaluation: A2MEvaluation,
    num_seeds: int = 20,
) -> Dict[str, Dict[str, float]]:
    """Seed loop + mean/CI summary (reference eval_humanact12_uestc.py:18-48)."""
    per_seed: Dict[str, List[float]] = {}
    for seed in range(num_seeds):
        metrics = evaluation.evaluate(make_loaders(seed), seed=seed)
        for k, v in metrics.items():
            per_seed.setdefault(k, []).append(v)
    summary = {}
    for k, vals in per_seed.items():
        arr = np.asarray(vals, dtype=np.float64)
        summary[k] = {
            "mean": float(np.nanmean(arr)),
            "ci": float(1.96 * np.nanstd(arr) / np.sqrt(len(arr))),
        }
    return summary


# ---------------------------------------------------------------- unconstrained
UNCONSTRAINED_JOINT_SUBSET = [15, 12, 16, 18, 20, 17, 19, 21, 0, 1, 4, 7, 2, 5, 8]


def evaluate_unconstrained_metrics(
    generated_features: np.ndarray,
    gt_features: np.ndarray,
    fast: bool = True,
) -> Dict[str, float]:
    """FID / KID / precision-recall / diversity on STGCN features
    (reference eval/unconstrained/evaluate.py:57-110)."""
    gt_stats = M.calculate_activation_statistics(gt_features)
    gen_stats = M.calculate_activation_statistics(generated_features)
    fid = M.calculate_frechet_distance(*gt_stats, *gen_stats)
    kid_mean, kid_std = M.calculate_kid(
        gt_features, generated_features,
        n_subsets=10 if fast else 100,
        subset_size=min(1000, len(gt_features), len(generated_features)),
    )
    precision, recall = M.precision_and_recall(generated_features, gt_features)
    diversity = M.calculate_diversity(
        generated_features, min(10000, len(generated_features) - 1)
    )
    return {
        "fid": fid, "kid": kid_mean, "kid_std": kid_std,
        "precision": precision, "recall": recall, "diversity": diversity,
    }
