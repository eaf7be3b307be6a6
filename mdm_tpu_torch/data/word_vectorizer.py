"""GloVe + POS word vectorizer for the T2M evaluator stack (a copy of
mdm_tpu/data/word_vectorizer.py, pure numpy).

Same on-disk contract as the reference (data_loaders/humanml/utils/
word_vectorizer.py): a `glove/` dir holding `{prefix}_data.npy`,
`{prefix}_words.pkl`, `{prefix}_idx.pkl`. Tokens are "word/POS" strings;
VIP word classes upgrade the POS one-hot.
"""
from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

VIP_DICT = {
    "Loc_VIP": (
        "left", "right", "clockwise", "counterclockwise", "anticlockwise",
        "forward", "back", "backward", "up", "down", "straight", "curve",
    ),
    "Body_VIP": (
        "arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
        "waist", "eye", "knee", "shoulder", "thigh",
    ),
    "Obj_VIP": (
        "stair", "dumbbell", "chair", "window", "floor", "car", "ball",
        "handrail", "baseball", "basketball",
    ),
    "Act_VIP": (
        "walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
        "throw", "hop", "dance", "jump", "turn", "stumble", "stop", "sit",
        "lift", "lower", "raise", "wash", "stand", "kneel", "stroll", "rub",
        "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
        "spin", "spread", "climb",
    ),
    "Desc_VIP": (
        "slowly", "carefully", "fast", "careful", "slow", "quickly",
        "happy", "angry", "sad", "happily", "angrily", "sadly",
    ),
}


class WordVectorizer:
    def __init__(self, meta_root: str, prefix: str = "our_vab"):
        vectors = np.load(os.path.join(meta_root, f"{prefix}_data.npy"))
        with open(os.path.join(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(os.path.join(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            word2idx = pickle.load(f)
        self.word2vec = {w: vectors[word2idx[w]] for w in words}
        self.dim = vectors.shape[1]

    def _pos_onehot(self, pos: str) -> np.ndarray:
        vec = np.zeros(len(POS_ENUMERATOR), np.float32)
        vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
        return vec

    def __getitem__(self, item: str) -> Tuple[np.ndarray, np.ndarray]:
        word, pos = item.split("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            vip_pos = None
            for cls, words in VIP_DICT.items():
                if word in words:
                    vip_pos = cls
                    break
            pos_vec = self._pos_onehot(vip_pos or pos)
        else:
            word_vec = self.word2vec.get("unk", np.zeros(self.dim, np.float32))
            pos_vec = self._pos_onehot("OTHER")
        return word_vec.astype(np.float32), pos_vec
