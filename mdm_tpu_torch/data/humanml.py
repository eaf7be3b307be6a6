"""HumanML3D / KIT-ML text-to-motion dataset (host-side pipeline).

Behavioral mirror of the reference Text2MotionDatasetV2 / TextOnlyDataset
stack (reference data_loaders/humanml/data/dataset.py:208-822) with an
explicit-RNG, fixed-shape design; a copy of mdm_tpu/data/humanml.py (pure
numpy), so that both packages draw the same batches:

- Disk format is identical (new_joint_vecs/*.npy + texts/*.txt with
  `caption#tok/pos ...#f_tag#to_tag` lines, split files, Mean/Std npy).
- Whole-dataset parse is cached to one .npz.
- Samples are z-normalized and padded to the static `max_motion_length`
  (196) — never to batch max — so every batch has one shape.
- Augmentations (random caption, unit_length crop, offset crop) take a
  `numpy.random.Generator`; no global seeding.

Modes: 'train', 'eval' (t2m evaluator norm stats), 'gt', 'text_only',
'prefix' (DiP fixed_len crops).
"""
from __future__ import annotations

import hashlib
import os
import random
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MIN_MOTION_LEN = {"t2m": 40, "kit": 24}
MAX_RAW_LEN = 200
FPS = 20.0


@dataclass(frozen=True)
class HumanMLOptions:
    """Typed replacement for the reference's *_opt.txt Namespace configs
    (data_loaders/humanml/utils/get_opt.py:29-80)."""

    dataset_name: str = "t2m"  # t2m | kit
    data_root: str = "./dataset/HumanML3D"
    max_motion_length: int = 196
    max_text_len: int = 20
    unit_length: int = 4
    fixed_len: int = 0  # DiP: context_len + pred_len
    pred_len: int = 0
    context_len: int = 0
    disable_offset_aug: bool = False
    use_cache: bool = True
    cache_dir: str = "./save/cache"
    joints_num: int = 22
    dim_pose: int = 263

    @property
    def motion_dir(self) -> str:
        return os.path.join(self.data_root, "new_joint_vecs")

    @property
    def text_dir(self) -> str:
        return os.path.join(self.data_root, "texts")

    @classmethod
    def for_dataset(cls, name: str, data_root: Optional[str] = None, **kw):
        if name in ("humanml", "t2m"):
            return cls(dataset_name="t2m", data_root=data_root or "./dataset/HumanML3D",
                       joints_num=22, dim_pose=263, **kw)
        if name == "kit":
            kw.setdefault("max_motion_length", 196)
            return cls(dataset_name="kit", data_root=data_root or "./dataset/KIT-ML",
                       joints_num=21, dim_pose=251, **kw)
        raise ValueError(name)


@dataclass
class TextEntry:
    caption: str
    tokens: List[str]  # "word/POS" strings


@dataclass
class MotionClip:
    name: str
    motion: np.ndarray  # [L, D] raw (un-normalized) features
    length: int
    texts: List[TextEntry]


def parse_text_file(path: str) -> List[Tuple[TextEntry, float, float]]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("#")
            caption = parts[0]
            tokens = parts[1].split(" ") if len(parts) > 1 else []
            f_tag = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
            to_tag = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
            f_tag = 0.0 if np.isnan(f_tag) else f_tag
            to_tag = 0.0 if np.isnan(to_tag) else to_tag
            out.append((TextEntry(caption, tokens), f_tag, to_tag))
    return out


_CACHE_VERSION = 2


def _cache_key(opt: HumanMLOptions, split_file: str) -> str:
    """Content hash so a cache can never shadow a different dataset.

    Keyed by the resolved data_root, the split file's bytes, and every
    option that affects parsing — a stale or foreign cache (e.g. test
    fixtures) misses instead of silently loading (round-1 advisor finding).
    """
    h = hashlib.sha256()
    h.update(os.path.abspath(opt.data_root).encode())
    h.update(f"|{opt.dataset_name}|{MIN_MOTION_LEN[opt.dataset_name]}|"
             f"{MAX_RAW_LEN}|v{_CACHE_VERSION}".encode())
    try:
        with open(split_file, "rb") as f:
            h.update(f.read())
    except OSError:
        h.update(b"<missing-split>")
    return h.hexdigest()[:16]


def _clips_to_arrays(clips: List[MotionClip], dim_pose: int) -> Dict[str, np.ndarray]:
    """Flatten clips into plain arrays (loadable with allow_pickle=False)."""
    motions = (
        np.concatenate([c.motion for c in clips], axis=0)
        if clips
        else np.zeros((0, dim_pose), np.float32)
    )
    text_caps, text_toks = [], []
    for c in clips:
        for t in c.texts:
            text_caps.append(t.caption)
            text_toks.append(" ".join(t.tokens))
    return {
        "version": np.int64(_CACHE_VERSION),
        "motions": motions.astype(np.float32),
        "lengths": np.asarray([len(c.motion) for c in clips], np.int64),
        "names": np.asarray([c.name for c in clips], np.str_),
        "text_counts": np.asarray([len(c.texts) for c in clips], np.int64),
        "captions": np.asarray(text_caps, np.str_),
        "tokens": np.asarray(text_toks, np.str_),
    }


def _clips_from_arrays(blob) -> List[MotionClip]:
    if int(blob["version"]) != _CACHE_VERSION:
        raise ValueError("cache version mismatch")
    lengths = blob["lengths"]
    splits = np.cumsum(lengths)[:-1]
    motions = np.split(np.asarray(blob["motions"], np.float32), splits, axis=0)
    names = [str(n) for n in blob["names"]]
    counts = blob["text_counts"]
    captions = [str(c) for c in blob["captions"]]
    tokens = [str(t) for t in blob["tokens"]]
    clips, ti = [], 0
    for name, motion, n_texts in zip(names, motions, counts):
        texts = [
            TextEntry(captions[ti + k], tokens[ti + k].split(" ") if tokens[ti + k] else [])
            for k in range(int(n_texts))
        ]
        ti += int(n_texts)
        clips.append(MotionClip(name, motion, len(motion), texts))
    return clips


def load_clips(
    opt: HumanMLOptions, split_file: str, rng: Optional[np.random.Generator] = None
) -> List[MotionClip]:
    """Parse the split: length filters + per-caption sub-clips (f_tag/to_tag)."""
    rng = rng or np.random.default_rng(0)
    min_len = MIN_MOTION_LEN[opt.dataset_name]

    cache_path = None
    if opt.use_cache:
        split = os.path.basename(split_file).replace(".txt", "")
        cache_path = os.path.join(
            opt.cache_dir,
            "dataset",
            f"{opt.dataset_name}_{split}_{_cache_key(opt, split_file)}.npz",
        )
        if os.path.exists(cache_path):
            try:
                with np.load(cache_path, allow_pickle=False) as blob:
                    return _clips_from_arrays(blob)
            except (ValueError, KeyError, OSError):
                pass  # unreadable/stale cache: fall through and re-parse

    with open(split_file) as f:
        id_list = [line.strip() for line in f if line.strip()]

    clips: List[MotionClip] = []
    seen = set()
    for name in id_list:
        mpath = os.path.join(opt.motion_dir, name + ".npy")
        tpath = os.path.join(opt.text_dir, name + ".txt")
        if not (os.path.exists(mpath) and os.path.exists(tpath)):
            continue
        try:
            motion = np.load(mpath).astype(np.float32)
        except Exception:
            continue
        if len(motion) < min_len or len(motion) >= MAX_RAW_LEN:
            continue
        whole_texts: List[TextEntry] = []
        for entry, f_tag, to_tag in parse_text_file(tpath):
            if f_tag == 0.0 and to_tag == 0.0:
                whole_texts.append(entry)
            else:
                sub = motion[int(f_tag * FPS) : int(to_tag * FPS)]
                if len(sub) < min_len or len(sub) >= MAX_RAW_LEN:
                    continue
                sub_name = f"{chr(65 + int(rng.integers(23)))}_{name}"
                while sub_name in seen:
                    sub_name = f"{chr(65 + int(rng.integers(23)))}_{name}"
                seen.add(sub_name)
                clips.append(MotionClip(sub_name, sub, len(sub), [entry]))
        if whole_texts:
            clips.append(MotionClip(name, motion, len(motion), whole_texts))
            seen.add(name)

    clips.sort(key=lambda c: c.length)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez(cache_path, **_clips_to_arrays(clips, opt.dim_pose))
    return clips


class HumanMLDataset:
    """Sampling-ready dataset over parsed clips.

    mode: 'train' (data-dir Mean/Std), 'eval'/'gt' (t2m evaluator stats),
    'text_only' (no motion needed at sample time), 'prefix' (fixed_len).
    """

    def __init__(
        self,
        opt: HumanMLOptions,
        split: str = "train",
        mode: str = "train",
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        clips: Optional[List[MotionClip]] = None,
        w_vectorizer=None,
    ):
        self.w_vectorizer = w_vectorizer
        self.opt = opt
        self.mode = mode
        split_file = os.path.join(opt.data_root, f"{split}.txt")
        self.clips = clips if clips is not None else load_clips(opt, split_file)
        if not self.clips:
            raise ValueError(f"no clips loaded for split {split}")

        if mean is None:
            mean_path = os.path.join(opt.data_root, "Mean.npy")
            if mode in ("eval", "gt"):
                from ..sampling.pipeline import load_norm_stats

                mean, std = load_norm_stats(
                    "humanml" if opt.dataset_name == "t2m" else "kit"
                )
            elif os.path.exists(mean_path):
                mean = np.load(mean_path)
                std = np.load(os.path.join(opt.data_root, "Std.npy"))
            else:
                mean = np.zeros(opt.dim_pose, np.float32)
                std = np.ones(opt.dim_pose, np.float32)
        self.mean = mean.astype(np.float32)
        self.std = std.astype(np.float32)

    def __len__(self) -> int:
        return len(self.clips)

    def inv_transform(self, data: np.ndarray) -> np.ndarray:
        return data * self.std + self.mean

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        """One training example with the reference's augmentations."""
        opt = self.opt
        clip = self.clips[idx]
        entry = clip.texts[int(rng.integers(len(clip.texts)))]
        m_length = clip.length

        if self.mode == "text_only":
            # Prompt-only access (reference TextOnlyDataset, dataset.py:673):
            # no motion decode/normalize cost.
            return {
                "motion": np.zeros((1, opt.dim_pose), np.float32),
                "length": m_length,
                "original_length": m_length,
                "caption": entry.caption,
                "tokens": entry.tokens,
                "sent_len": len(entry.tokens),
                "key": clip.name,
            }

        # unit_length crop augmentation (dataset.py:343-352)
        if opt.unit_length < 10:
            coin2 = ["single", "single", "double"][int(rng.integers(3))]
        else:
            coin2 = "single"
        if coin2 == "double":
            m_length = (m_length // opt.unit_length - 1) * opt.unit_length
        else:
            m_length = (m_length // opt.unit_length) * opt.unit_length

        original_length = None
        if opt.fixed_len > 0:
            original_length = m_length
            m_length = opt.fixed_len

        hi = max(len(clip.motion) - m_length, 0)
        start = int(rng.integers(hi + 1))
        if opt.disable_offset_aug:
            start = int(rng.integers(opt.unit_length + 1))
        motion = clip.motion[start : start + m_length]

        T = opt.max_motion_length
        if opt.fixed_len > 0:
            T = opt.fixed_len
        # Normalize in-place into the padded buffer: one allocation, no
        # (motion - mean)/std temporaries.
        padded = np.empty((T, opt.dim_pose), np.float32)
        L = len(motion)
        padded[:L] = motion
        padded[L:] = 0.0
        padded[:L] -= self.mean
        padded[:L] /= self.std

        tokens = entry.tokens
        if len(tokens) < opt.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens = tokens + ["unk/OTHER"] * (opt.max_text_len + 2 - sent_len)
        else:
            tokens = ["sos/OTHER"] + tokens[: opt.max_text_len] + ["eos/OTHER"]
            sent_len = len(tokens)

        out = {
            "motion": padded,
            "length": m_length,
            "original_length": original_length or m_length,
            "caption": entry.caption,
            "tokens": tokens,
            "sent_len": sent_len,
            "key": clip.name,
        }
        if self.w_vectorizer is not None:
            embs, pos = zip(*(self.w_vectorizer[t] for t in tokens))
            out["word_embeddings"] = np.stack(embs)
            out["pos_one_hots"] = np.stack(pos)
        return out
