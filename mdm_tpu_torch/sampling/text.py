"""Text -> conditioning embeddings.

Counterpart of mdm_tpu/sampling/text.py. The towers run once per prompt
batch, under ``torch.no_grad()`` on the embedder's device, and return host
numpy arrays; the embedding is reused by every diffusion step and CFG
branch (the reference's one-time-CLIP trick, its only mode here).

Assets under ``assets/text`` (``make_text_embedder``): the tokenizers' files,
as mdm_tpu reads them, and the port's own converted weights, a state dict
saved with ``torch.save`` and read with ``weights_only=True``:

- CLIP: ``bpe_simple_vocab_16e6.txt.gz`` and ``clip_text_torch.pt``;
- DistilBERT: ``bert_vocab.txt`` and ``distilbert_torch.pt``.

``python -m mdm_tpu_torch.cli.convert_text_encoders`` writes the weights
from the published torch checkpoints. Where they are absent
``make_text_embedder`` returns None, as mdm_tpu's does, and the CLIs fall
back to the hash embedder; where only mdm_tpu's orbax weights are there it
raises, naming the converter.
"""
from __future__ import annotations

import os
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

DEFAULT_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "text")
MAX_TEXT_LEN = 20  # humanml/kit hardcoded cap (reference mdm.py:166)
# encoder type -> (tokenizer file, the port's weights, mdm_tpu's orbax weights)
ASSETS = {"clip": ("bpe_simple_vocab_16e6.txt.gz", "clip_text_torch.pt", "clip_text_flax"),
          "bert": ("bert_vocab.txt", "distilbert_torch.pt", "distilbert_flax")}


def _tower(cls, config_cls, state_dict, config, device):
    config = config or config_cls.from_state_dict(state_dict)
    tower = cls(config)
    tower.load_state_dict(state_dict, strict=True)
    return tower.to(device).eval()


class ClipTextEmbedder:
    """texts -> {"text_embed": [B, embed_dim]}: CLIP BPE tokens, context
    MAX_TEXT_LEN + 2 zero-padded to 77 (mdm_tpu/sampling/text.py:38-42),
    through the CLIP text tower."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], bpe_path: str, config=None,
                 device="cuda"):
        from ..data.tokenizers import ClipTokenizer
        from ..models.text_encoders import ClipTextConfig, ClipTextEncoder

        self.tokenizer = ClipTokenizer(bpe_path)
        self.encoder = _tower(ClipTextEncoder, ClipTextConfig, state_dict, config, device)
        self.device = torch.device(device)

    def __call__(self, texts: List[str]) -> Dict[str, np.ndarray]:
        tokens = self.tokenizer.tokenize(texts, context_length=MAX_TEXT_LEN + 2,
                                         pad_to=self.encoder.config.context_length)
        with torch.no_grad():
            out = self.encoder(torch.from_numpy(tokens).to(self.device))
        return {"text_embed": out.float().cpu().numpy()}


class BertTextEmbedder:
    """texts -> {"text_embed": [B, max_len, dim], "text_tokens_mask": [B,
    max_len] bool}: WordPiece tokens through DistilBERT."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], vocab_path: str, config=None,
                 max_len: int = 64, device="cuda"):
        from ..data.tokenizers import WordPieceTokenizer
        from ..models.text_encoders import DistilBertConfig, DistilBertEncoder

        self.tokenizer = WordPieceTokenizer(vocab_path)
        self.encoder = _tower(DistilBertEncoder, DistilBertConfig, state_dict, config, device)
        self.max_len = max_len
        self.device = torch.device(device)

    def __call__(self, texts: List[str]) -> Dict[str, np.ndarray]:
        tokens, mask = self.tokenizer.tokenize(texts, self.max_len)
        with torch.no_grad():
            hidden = self.encoder(torch.from_numpy(tokens).to(self.device),
                                  torch.from_numpy(mask).to(self.device))
        return {"text_embed": hidden.float().cpu().numpy(), "text_tokens_mask": mask}


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


def make_text_embedder(encoder_type: str = "clip", assets_dir: Optional[str] = None,
                       device="cuda") -> Optional[Callable[[List[str]], Dict[str, np.ndarray]]]:
    """The embedder for ``encoder_type``: the hash embedder for "hash"; for
    "clip" and "bert" the tower on ``device`` from the port's assets, None
    when they are absent (as in mdm_tpu), and FileNotFoundError when only
    mdm_tpu's orbax weights are there."""
    if encoder_type == "hash":
        return HashTextEmbedder()
    if encoder_type not in ASSETS:
        raise ValueError(encoder_type)
    assets_dir = assets_dir or DEFAULT_ASSETS
    vocab, weights, orbax = (os.path.join(assets_dir, a) for a in ASSETS[encoder_type])
    if not (os.path.exists(vocab) and os.path.exists(weights)):
        if os.path.exists(orbax):
            raise FileNotFoundError(
                f"{orbax} holds mdm_tpu's orbax weights, which the port does not read; write "
                f"{weights} from the published torch checkpoint with "
                f"`python -m mdm_tpu_torch.cli.convert_text_encoders --out_dir {assets_dir}`")
        return None
    state_dict = torch.load(weights, map_location="cpu", weights_only=True)
    cls = ClipTextEmbedder if encoder_type == "clip" else BertTextEmbedder
    return cls(state_dict, vocab, device=device)
