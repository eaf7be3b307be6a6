"""Text-to-motion evaluation harness (the reference eval/eval_humanml.py).

Counterpart of mdm_tpu/eval/harness.py. Protocol parity: batch-32-locked
loaders, per-replication metric passes (matching score / R-precision, FID
vs ground truth, diversity, multimodality), mean +- 1.96*std/sqrt(reps)
summaries, append-only log file, ``comparable`` / ``degraded_reasons``
stamps. Generation runs through ``MotionGenerator`` on its device (the
card's kernels there), the model-to-evaluator renormalization too; the
evaluator embeds a whole loader pass on the device and the harness pulls
the embeddings to the host once. Metrics are host numpy; the numpy draws
(diversity, the multimodality pick) sit where mdm_tpu's do, so they agree
with it bit for bit on the same embeddings.

Randomness: each loader pass draws its noise from a ``torch.Generator`` on
the generator's device seeded with the replication (``seed + 7919`` for
the multimodality loader), where mdm_tpu splits ``PRNGKey(seed)``.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from . import metrics as M
from ..data.loader import put_one
from .evaluator import EvaluatorWrapper

EVAL_BATCH_SIZE = 32  # protocol-locked (reference eval_humanml.py:245)


def _text_features(batch):
    """(word_embeddings, pos_one_hots, sent_lens, degraded) with a zero
    fallback when no GloVe vectorizer was attached (smoke runs; matching
    metrics are then structurally valid but not comparable — the caller
    stamps the output as such)."""
    if "word_embeddings" in batch:
        return batch["word_embeddings"], batch["pos_one_hots"], batch["sent_lens"], False
    B = len(batch["sent_lens"]) if "sent_lens" in batch else batch["x"].shape[0]
    L = 22
    sent_lens = batch.get("sent_lens", np.full((B,), 4, np.int32))
    return (
        np.zeros((B, L, 300), np.float32),
        np.zeros((B, L, 15), np.float32),
        np.asarray(sent_lens),
        True,
    )


def evaluate_matching_score(eval_wrapper: EvaluatorWrapper, motion_loaders: Dict[str, Iterable], log=print):
    match_score_dict = OrderedDict()
    R_precision_dict = OrderedDict()
    activation_dict = OrderedDict()
    any_degraded = False
    for name, loader in motion_loaders.items():
        # Embed the WHOLE loader pass on the device first, pull once: a
        # per-batch copy to the host would wait for each batch and
        # serialize generation against embedding.
        text_embs, motion_embs = [], []
        for batch in loader:
            w, p, sl, degraded = _text_features(batch)
            any_degraded = any_degraded or degraded
            t, m = eval_wrapper.get_co_embeddings_device(w, p, sl, batch["x"], batch["lengths"])
            text_embs.append(t)
            motion_embs.append(m)
        sizes = [len(t) for t in text_embs]
        splits = np.cumsum(sizes)[:-1]
        host = [np.split(torch.cat(e).cpu().numpy(), splits) for e in (text_embs, motion_embs)]
        all_motion_embeddings = []
        all_size = 0
        matching_score_sum = 0
        top_k_count = np.zeros(3)
        for text_emb, motion_emb in zip(*host):
            dist_mat = M.euclidean_distance_matrix(text_emb, motion_emb)
            matching_score_sum += dist_mat.trace()
            argsm = np.argsort(dist_mat, axis=1)
            top_k_count = top_k_count + M.calculate_top_k(argsm, top_k=3).sum(axis=0)
            all_size += text_emb.shape[0]
            all_motion_embeddings.append(motion_emb)

        matching_score = matching_score_sum / all_size
        R_precision = top_k_count / all_size
        match_score_dict[name] = matching_score
        R_precision_dict[name] = R_precision
        activation_dict[name] = np.concatenate(all_motion_embeddings, axis=0)
        log(f"---> [{name}] Matching Score: {matching_score:.4f}  "
            f"R_precision: {R_precision}")
    return match_score_dict, R_precision_dict, activation_dict, any_degraded


def evaluate_fid(gt_activations: np.ndarray, activation_dict: Dict[str, np.ndarray], log=print):
    fid_dict = OrderedDict()
    gt_mu, gt_cov = M.calculate_activation_statistics(gt_activations)
    for name, acts in activation_dict.items():
        mu, cov = M.calculate_activation_statistics(acts)
        fid = M.calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
        fid_dict[name] = fid
        log(f"---> [{name}] FID: {fid:.4f}")
    return fid_dict


def evaluate_diversity(
    activation_dict: Dict[str, np.ndarray], diversity_times=300, log=print,
    rng: Optional[np.random.Generator] = None,
):
    div_dict = OrderedDict()
    for name, acts in activation_dict.items():
        dt = min(diversity_times, len(acts) - 1)
        div_dict[name] = M.calculate_diversity(acts, dt, rng=rng)
        log(f"---> [{name}] Diversity: {div_dict[name]:.4f}")
    return div_dict


def evaluate_multimodality(
    eval_wrapper: EvaluatorWrapper, mm_loaders: Dict[str, Iterable], mm_num_times=10, log=print,
    rng: Optional[np.random.Generator] = None,
):
    mm_dict = OrderedDict()
    for name, loader in mm_loaders.items():
        embs = []
        for batch in loader:  # batch: [n_repeats, T, D] per prompt
            motion_emb = eval_wrapper.get_motion_embeddings(batch["x"], batch["lengths"])
            embs.append(motion_emb[None])
        if not embs:
            continue
        acts = np.concatenate(embs, axis=0)
        mmt = min(mm_num_times, acts.shape[1])
        mm_dict[name] = M.calculate_multimodality(acts, mmt, rng=rng)
        log(f"---> [{name}] Multimodality: {mm_dict[name]:.4f}")
    return mm_dict


def get_metric_statistics(values: np.ndarray, replication_times: int):
    mean = np.mean(values, axis=0)
    std = np.std(values, axis=0)
    conf_interval = 1.96 * std / np.sqrt(replication_times)
    return mean, conf_interval


@dataclass
class EvalConfig:
    replication_times: int = 20
    diversity_times: int = 300
    mm_num_times: int = 10
    run_mm: bool = False
    log_file: Optional[str] = None
    seed: int = 0  # seeds the per-replication diversity/MM subsampling RNG


def evaluation(
    eval_wrapper: EvaluatorWrapper,
    gt_loader_fn: Callable[[], Iterable],
    eval_motion_loader_fns: Dict[str, Callable[[int], Iterable]],
    config: EvalConfig = EvalConfig(),
    mm_loader_fns: Optional[Dict[str, Callable[[int], Iterable]]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Replication loop -> {metric: {loader: mean/CI}} (+ log file)."""
    lines: List[str] = []

    def log(msg):
        print(msg)
        lines.append(str(msg))

    all_metrics = {
        "Matching Score": OrderedDict(),
        "R_precision": OrderedDict(),
        "FID": OrderedDict(),
        "Diversity": OrderedDict(),
        "MultiModality": OrderedDict(),
    }
    degraded_reasons: List[str] = []
    if getattr(eval_wrapper, "degraded", None):
        degraded_reasons.append(str(eval_wrapper.degraded))
    for rep in range(config.replication_times):
        log(f"==================== Replication {rep} ====================")
        t0 = time.time()
        rep_rng = np.random.default_rng(config.seed + rep)
        motion_loaders = {"ground truth": gt_loader_fn()}
        for name, fn in eval_motion_loader_fns.items():
            motion_loaders[name] = fn(rep)

        mat_dict, R_dict, act_dict, text_degraded = evaluate_matching_score(
            eval_wrapper, motion_loaders, log
        )
        if text_degraded and "zero-glove-text-features" not in degraded_reasons:
            degraded_reasons.append("zero-glove-text-features")
        fid_dict = evaluate_fid(act_dict["ground truth"],
                                {k: v for k, v in act_dict.items()}, log)
        div_dict = evaluate_diversity(act_dict, config.diversity_times, log, rng=rep_rng)
        mm_dict = {}
        if config.run_mm and mm_loader_fns:
            mm_dict = evaluate_multimodality(
                eval_wrapper, {k: fn(rep) for k, fn in mm_loader_fns.items()},
                config.mm_num_times, log, rng=rep_rng,
            )
        log(f"replication {rep} took {time.time() - t0:.1f}s")

        for store, d in [
            ("Matching Score", mat_dict), ("R_precision", R_dict),
            ("FID", fid_dict), ("Diversity", div_dict), ("MultiModality", mm_dict),
        ]:
            for name, value in d.items():
                all_metrics[store].setdefault(name, []).append(value)

    summary: Dict[str, Dict[str, np.ndarray]] = {}
    log("========== Summary (mean +- 95% CI) ==========")
    for metric, d in all_metrics.items():
        summary[metric] = {}
        for name, values in d.items():
            mean, ci = get_metric_statistics(np.asarray(values), config.replication_times)
            summary[metric][name] = {"mean": mean, "ci": ci}
            log(f"---> [{metric}] [{name}]: {mean} +- {ci}")

    # Stamp degraded runs so a zero-GloVe / random-evaluator fallback can
    # never be mistaken for publishable numbers.
    summary["comparable"] = not degraded_reasons
    if degraded_reasons:
        summary["degraded_reasons"] = list(degraded_reasons)
        log(f'"comparable": false  # degraded: {", ".join(degraded_reasons)}')

    if config.log_file:
        os.makedirs(os.path.dirname(config.log_file) or ".", exist_ok=True)
        with open(config.log_file, "a") as f:
            f.write("\n".join(lines) + "\n")
    return summary


class _Renorm:
    """Model-normalized features -> evaluator-normalized (denorm with the
    model's train stats, renorm with the evaluator's; reference
    CompMDMGeneratedDataset), in float32 on ``device``; identity when
    either pair of stats is missing."""

    def __init__(self, device, model_mean, model_std, eval_mean, eval_std):
        self.stats = None
        if model_mean is not None and eval_mean is not None:
            self.stats = [put_one(np.asarray(s, np.float32), device)
                          for s in (model_mean, model_std, eval_mean, eval_std)]

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        feats = feats.float()
        if self.stats is None:
            return feats
        model_mean, model_std, eval_mean, eval_std = self.stats
        return (feats * model_std + model_mean - eval_mean) / eval_std

    def to_model(self, feats: torch.Tensor) -> torch.Tensor:
        """The inverse: evaluator-normalized ground truth (a DiP prefix) ->
        the model's normalization, which it was trained on."""
        if self.stats is None:
            return feats
        model_mean, model_std, eval_mean, eval_std = self.stats
        return (feats.float() * eval_std + eval_mean - model_mean) / model_std


def _cond_tensors(embeds: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: put_one(torch.as_tensor(v), device) for k, v in embeds.items()}


class MMGeneratedLoader:
    """Multimodality loader: N repeats of the SAME prompt per item
    (reference MMGeneratedDataset, model_motion_loaders.py:14-46).

    Yields one batch per selected prompt with x [n_repeats, T, D].
    """

    def __init__(
        self,
        generator,
        gt_batches: List[Dict],
        text_embedder: Callable[[List[str]], Dict],
        mm_num_samples: int = 10,
        mm_num_repeats: int = 10,
        seed: int = 0,
        model_mean: Optional[np.ndarray] = None,
        model_std: Optional[np.ndarray] = None,
        eval_mean: Optional[np.ndarray] = None,
        eval_std: Optional[np.ndarray] = None,
    ):
        self.generator = generator
        self.gt_batches = gt_batches
        self.text_embedder = text_embedder
        self.mm_num_samples = mm_num_samples
        self.mm_num_repeats = mm_num_repeats
        self.seed = seed
        self.renorm = _Renorm(generator.device, model_mean, model_std, eval_mean, eval_std)

    def __iter__(self):
        from ..models.mdm import Conditioning

        device = self.generator.device
        gen = torch.Generator(device).manual_seed(self.seed + 7919)
        count = 0
        rng = np.random.default_rng(self.seed)
        for batch in self.gt_batches:
            if count >= self.mm_num_samples:
                return
            idx = int(rng.integers(batch["x"].shape[0]))
            text = batch["text"][idx]
            T = batch["x"].shape[1]
            R = self.mm_num_repeats
            mask = np.broadcast_to(batch["mask"][idx: idx + 1], (R, T)).copy()
            cond = Conditioning(frames_mask=put_one(mask, device),
                                **_cond_tensors(self.text_embedder([text] * R), device))
            feats = self.renorm(self.generator.sample_features(cond, R, T, gen))
            count += 1
            yield {
                "x": feats,
                "lengths": np.full((R,), batch["lengths"][idx], np.int32),
            }


class GeneratedMotionLoader:
    """Runs the generator over a ground-truth loader's prompts and yields
    eval-ready batches (reference CompMDMGeneratedDataset,
    data_loaders/humanml/motion_loaders/comp_v6_model_dataset.py:148-285).

    The generator produces model-normalized features; when the model's
    (train) stats and the evaluator's stats are given, they are converted
    via (denorm model stats) -> (renorm eval stats) on the generator's
    device — the reference's renormalization in CompMDMGeneratedDataset.
    The features stay there for the evaluator. A DiP prefix, cut from the
    evaluator-normalized ground truth, is converted the other way first.
    """

    def __init__(
        self,
        generator,  # mdm_tpu_torch.sampling.MotionGenerator
        gt_batches: List[Dict],
        text_embedder: Callable[[List[str]], Dict],
        seed: int = 0,
        model_mean: Optional[np.ndarray] = None,
        model_std: Optional[np.ndarray] = None,
        eval_mean: Optional[np.ndarray] = None,
        eval_std: Optional[np.ndarray] = None,
    ):
        self.generator = generator
        self.gt_batches = gt_batches
        self.text_embedder = text_embedder
        self.seed = seed
        self.renorm = _Renorm(generator.device, model_mean, model_std, eval_mean, eval_std)

    def __iter__(self):
        from ..models.mdm import Conditioning

        device = self.generator.device
        gen = torch.Generator(device).manual_seed(self.seed)
        for batch in self.gt_batches:
            B, T = batch["x"].shape[:2]
            # The ground truth is in the evaluator's normalization; a DiP
            # prefix goes back to the model's, as the reference's source
            # loader ('eval' mode, the model's Mean/Std) gives it. mdm_tpu
            # passes it as it is.
            prefix = (self.renorm.to_model(put_one(np.asarray(batch["prefix"]), device))
                      if "prefix" in batch else None)
            cond = Conditioning(
                frames_mask=put_one(np.asarray(batch["mask"]), device), prefix=prefix,
                **_cond_tensors(self.text_embedder(batch["text"]), device),
            )
            if self.generator.config.autoregressive:
                # DiP eval: generate to the clip's original length.
                T_out = int(np.max(batch.get("orig_lengths", [T])))
                feats = self.generator.sample_autoregressive(cond, B, gen, required_frames=T_out)
            else:
                feats = self.generator.sample_features(cond, B, T, gen)
            out = dict(batch)
            out["x"] = self.renorm(feats)
            # Autoregressive (DiP) eval scores against the clip's original
            # length, not the fixed prediction window (reference
            # comp_v6_model_dataset.py:220-221).
            if "orig_lengths" in batch:
                out["lengths"] = np.asarray(batch["orig_lengths"])
            yield out
