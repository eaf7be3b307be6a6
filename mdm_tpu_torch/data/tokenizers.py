"""Self-contained tokenizers for the frozen text encoders (a copy of
mdm_tpu/data/tokenizers.py, pure numpy).

- :class:`ClipTokenizer`: byte-pair encoding identical to OpenAI CLIP's
  `SimpleTokenizer` (loads the public `bpe_simple_vocab_16e6.txt.gz` merges
  file — a downloaded asset, same contract as the reference's `clip` pip
  package data file). Supports the MDM trick of tokenizing to
  `max_text_len+2` and zero-padding to 77 (reference model/mdm.py:166-175).
- :class:`WordPieceTokenizer`: uncased BERT wordpiece over a `vocab.txt`
  (for DistilBERT conditioning).

Both are host-side; encoders consume fixed-shape int32 token arrays.
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """OpenAI CLIP BPE tokenizer (byte-level BPE, 49408 vocab)."""

    CONTEXT_LENGTH = 77

    def __init__(self, bpe_path: str):
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if False
            else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def tokenize(
        self,
        texts: List[str],
        context_length: Optional[int] = None,
        truncate: bool = True,
        pad_to: Optional[int] = None,
    ) -> np.ndarray:
        """Texts -> int32 [B, pad_to or context_length].

        MDM path: context_length = max_text_len + 2 = 22, pad_to = 77
        (zero padding after EOT, reference mdm.py:166-175).
        """
        context_length = context_length or self.CONTEXT_LENGTH
        pad_to = pad_to or context_length
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), pad_to), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            if len(toks) > context_length:
                if not truncate:
                    raise RuntimeError(f"text too long: {text!r}")
                toks = toks[: context_length - 1] + [eot]
            out[i, : len(toks)] = toks
        return out


class WordPieceTokenizer:
    """Uncased BERT wordpiece tokenizer over a vocab.txt file."""

    def __init__(self, vocab_path: str, max_len: int = 512):
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.unk = self.vocab.get("[UNK]", 100)
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.pad = self.vocab.get("[PAD]", 0)
        self.max_len = max_len

    def _basic(self, text: str) -> List[str]:
        text = text.lower().strip()
        text = re.sub(r"([\.\,\!\?\;\:\(\)\[\]\"\'])", r" \1 ", text)
        return [t for t in text.split() if t]

    def _wordpiece(self, word: str) -> List[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, texts: List[str], max_len: int = 64):
        """-> (tokens int32 [B, max_len], attention_mask bool [B, max_len])."""
        ids = np.full((len(texts), max_len), self.pad, dtype=np.int32)
        mask = np.zeros((len(texts), max_len), dtype=bool)
        for i, text in enumerate(texts):
            toks = [self.cls]
            for w in self._basic(text):
                toks.extend(self._wordpiece(w))
            toks = toks[: max_len - 1] + [self.sep]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = True
        return ids, mask
