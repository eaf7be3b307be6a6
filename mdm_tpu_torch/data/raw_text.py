"""Raw-text prompt tokenization for the T2M evaluator stack (a copy of
mdm_tpu/data/raw_text.py).

The reference's RawTextDataset (data_loaders/humanml/data/dataset.py) POS-
tags arbitrary prompts with spacy before GloVe lookup. spacy is not in this
image, so we use spacy when importable and otherwise a lexicon heuristic —
the VIP word classes (which dominate the evaluator's POS signal) are exact
either way because WordVectorizer overrides POS for VIP words.
"""
from __future__ import annotations

import re
from typing import List, Tuple

from .word_vectorizer import VIP_DICT

_PRONOUNS = {"i", "you", "he", "she", "it", "we", "they", "someone", "somebody",
             "person", "his", "her", "their", "them", "him", "me", "us"}
_DETERMINERS = {"a", "an", "the", "this", "that", "these", "those"}
_ADPOSITIONS = {"in", "on", "at", "to", "from", "with", "of", "over", "under",
                "into", "onto", "through", "around", "across", "along", "by",
                "near", "behind", "between", "up", "down", "off", "out"}
_AUX = {"is", "are", "was", "were", "be", "been", "being", "do", "does", "did",
        "has", "have", "had", "will", "would", "can", "could", "then", "and",
        "while", "before", "after"}
_VERB_SUFFIX = re.compile(r".*(ing|ed|es)$")


def _heuristic_pos(word: str) -> str:
    for cls, words in VIP_DICT.items():
        if word in words:
            # WordVectorizer re-derives the VIP class; base POS is enough
            return "VERB" if cls == "Act_VIP" else "OTHER"
    if word in _DETERMINERS:
        return "DET"
    if word in _PRONOUNS:
        return "PRON"
    if word in _ADPOSITIONS:
        return "ADP"
    if word in _AUX:
        return "AUX"
    if word.isdigit():
        return "NUM"
    if _VERB_SUFFIX.match(word):
        return "VERB"
    return "NOUN"


def process_raw_text(text: str, max_text_len: int = 20) -> Tuple[List[str], int]:
    """Prompt -> ('word/POS' tokens padded like the dataset path, sent_len)."""
    try:
        import spacy

        nlp = spacy.load("en_core_web_sm")
        doc = nlp(text)
        pairs = []
        for tok in doc:
            word = tok.text.lower()
            if not word.isalpha() and word not in ("left", "right"):
                continue
            pos = tok.pos_
            if pos in ("NOUN", "VERB") and tok.lemma_ not in ("left", "right"):
                pairs.append(f"{tok.lemma_}/{pos}")
            else:
                pairs.append(f"{word}/{pos}")
    except Exception:
        words = [w for w in re.findall(r"[a-zA-Z]+", text.lower())]
        pairs = [f"{w}/{_heuristic_pos(w)}" for w in words]

    tokens = pairs[:max_text_len]
    tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
    sent_len = len(tokens)
    tokens = tokens + ["unk/OTHER"] * (max_text_len + 2 - sent_len)
    return tokens, sent_len
