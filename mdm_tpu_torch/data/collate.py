"""Fixed-shape batch assembly (a copy of mdm_tpu/data/collate.py, pure numpy).

Replaces the reference collates (data_loaders/tensors.py:22-93): every batch
has the same static shapes ([B, T_max, D] + [B, T_max] mask), so the train
step compiles once. The three collate modes of the reference are covered:

- `collate_batch`     : generic (t2m_collate semantics incl. repeat-to-fill)
- `collate_prefix`    : DiP prefix/pred split (t2m_prefix_collate)
- action datasets pass `action` instead of text.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]


def collate_batch(
    samples: List[Dict], target_batch_size: Optional[int] = None
) -> Dict:
    """Samples (from HumanMLDataset.sample / a2m) -> model batch dict.

    With `target_batch_size`, the sample list is cyclically repeated to fill
    the batch (reference t2m_collate, tensors.py:67-79) so eval batches are
    always full.
    """
    if target_batch_size is not None and len(samples) < target_batch_size:
        reps = -(-target_batch_size // len(samples))
        samples = (samples * reps)[:target_batch_size]

    # copy=False: samples already produce f32, so this is stack-only (the
    # default astype re-copied the whole [B, 196, 263] batch).
    x = np.stack([s["motion"] for s in samples]).astype(np.float32, copy=False)
    lengths = np.asarray([s["length"] for s in samples], np.int32)
    batch = {
        "x": x,
        "mask": lengths_to_mask(lengths, x.shape[1]),
        "lengths": lengths,
    }
    for key, out in [
        ("caption", "text"), ("tokens", "tokens"), ("key", "keys"),
        ("sent_len", "sent_lens"), ("original_length", "orig_lengths"),
        ("action", "action"), ("action_text", "action_text"),
    ]:
        if key in samples[0]:
            vals = [s[key] for s in samples]
            if key in ("sent_len", "original_length", "action"):
                vals = np.asarray(vals, np.int32)
            batch[out] = vals
    if "word_embeddings" in samples[0]:
        batch["word_embeddings"] = np.stack([s["word_embeddings"] for s in samples])
        batch["pos_one_hots"] = np.stack([s["pos_one_hots"] for s in samples])
    return batch


def collate_prefix(samples: List[Dict], pred_len: int) -> Dict:
    """DiP: split each motion into prefix (context) and prediction window
    (reference t2m_prefix_collate, tensors.py:82-93)."""
    full = np.stack([s["motion"] for s in samples]).astype(np.float32)
    batch = {
        "x": full[:, -pred_len:],
        "prefix": full[:, :-pred_len],
        "mask": np.ones((full.shape[0], pred_len), bool),
        "lengths": np.full((full.shape[0],), pred_len, np.int32),
        "orig_lengths": np.asarray([s["original_length"] for s in samples], np.int32),
        "text": [s["caption"] for s in samples],
        "tokens": [s["tokens"] for s in samples],
        "keys": [s["key"] for s in samples],
    }
    # Evaluator text features ride along exactly as in collate_batch: the
    # AR protocol's matching/R-precision metrics consume them, and dropping
    # them here silently degraded the whole DiP eval to zero text features.
    if "sent_len" in samples[0]:
        batch["sent_lens"] = np.asarray([s["sent_len"] for s in samples], np.int32)
    if "word_embeddings" in samples[0]:
        batch["word_embeddings"] = np.stack([s["word_embeddings"] for s in samples])
        batch["pos_one_hots"] = np.stack([s["pos_one_hots"] for s in samples])
    return batch
