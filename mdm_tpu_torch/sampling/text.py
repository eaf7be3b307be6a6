"""Text -> conditioning embeddings.

Counterpart of mdm_tpu/sampling/text.py for the asset-free embedder. The
CLIP and DistilBERT towers need converted weights under ``assets/text``
(the JAX package's asset paths), which the repository does not hold:
``make_text_embedder`` then returns None, as mdm_tpu's does, and the CLIs
fall back to the hash embedder. Porting the towers is ROADMAP Queue 1
item 8.
"""
from __future__ import annotations

import os
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np

DEFAULT_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "text")
# The converted-weight assets each tower needs (mdm_tpu/sampling/text.py:112-126).
ASSETS = {"clip": ("bpe_simple_vocab_16e6.txt.gz", "clip_text_flax"),
          "bert": ("bert_vocab.txt", "distilbert_flax")}


class HashTextEmbedder:
    """Deterministic, asset-free text embedding (mdm_tpu/sampling/text.py:66-102).

    Each lowercase word maps to a fixed pseudo-random vector seeded by
    zlib.crc32 of the word (stable across processes); a caption embeds as
    the L2-normalised mean. Not semantically meaningful: distinct captions
    get distinct, reproducible embeddings. Pure numpy, so its output equals
    the JAX package's byte for byte.
    """

    def __init__(self, dim: int = 512):
        self.dim = dim
        self._cache: Dict[str, np.ndarray] = {}

    def _word_vec(self, word: str) -> np.ndarray:
        v = self._cache.get(word)
        if v is None:
            rng = np.random.default_rng(zlib.crc32(word.encode()))
            v = rng.normal(size=self.dim).astype(np.float32)
            self._cache[word] = v
        return v

    def __call__(self, texts: List[str]) -> Dict[str, np.ndarray]:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            words = [w for w in "".join(
                c if c.isalnum() else " " for c in text.lower()).split() if w]
            if not words:
                continue
            emb = np.mean([self._word_vec(w) for w in words], axis=0)
            out[i] = emb / max(float(np.linalg.norm(emb)), 1e-8)
        return {"text_embed": out}


def make_text_embedder(encoder_type: str = "clip", assets_dir: Optional[str] = None
                       ) -> Optional[Callable[[List[str]], Dict[str, np.ndarray]]]:
    """The embedder for ``encoder_type``: the hash embedder for "hash";
    for "clip" and "bert", None when their converted weights are absent
    (as in mdm_tpu), and NotImplementedError when they are present, since
    the towers are not ported yet."""
    if encoder_type == "hash":
        return HashTextEmbedder()
    if encoder_type not in ASSETS:
        raise ValueError(encoder_type)
    assets_dir = assets_dir or DEFAULT_ASSETS
    if not all(os.path.exists(os.path.join(assets_dir, a)) for a in ASSETS[encoder_type]):
        return None
    raise NotImplementedError(
        f"text encoder {encoder_type!r} is not ported yet: ROADMAP Queue 1 item 8")
