"""Feature-space masks over the 263-d hml_vec (reference data_loaders/
humanml_utils.py:3-60): per-body-region boolean masks used by editing
(upper_body inpainting) and root-control applications.

A copy of mdm_tpu/core/hml_masks.py, kept by the port so that it imports
nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

from .hml_codec import HML_JOINT_NAMES

NUM_HML_JOINTS = len(HML_JOINT_NAMES)  # 22

HML_EE_JOINT_NAMES = ["left_foot", "right_foot", "left_wrist", "right_wrist", "head"]
HML_LOWER_BODY_JOINTS = [
    HML_JOINT_NAMES.index(n)
    for n in [
        "pelvis", "left_hip", "right_hip", "left_knee", "right_knee",
        "left_ankle", "right_ankle", "left_foot", "right_foot",
    ]
]
SMPL_UPPER_BODY_JOINTS = [
    i for i in range(NUM_HML_JOINTS) if i not in HML_LOWER_BODY_JOINTS
]

_root_binary = np.array([True] + [False] * (NUM_HML_JOINTS - 1))
HML_ROOT_MASK = np.concatenate(
    [
        [True] * (1 + 2 + 1),
        _root_binary[1:].repeat(3),
        _root_binary[1:].repeat(6),
        _root_binary.repeat(3),
        [False] * 4,
    ]
)
HML_ROOT_HORIZONTAL_MASK = np.concatenate(
    [
        [True] * (1 + 2) + [False],
        np.zeros((NUM_HML_JOINTS - 1) * 3, dtype=bool),
        np.zeros((NUM_HML_JOINTS - 1) * 6, dtype=bool),
        np.zeros(NUM_HML_JOINTS * 3, dtype=bool),
        [False] * 4,
    ]
)
_lower_binary = np.array([i in HML_LOWER_BODY_JOINTS for i in range(NUM_HML_JOINTS)])
HML_LOWER_BODY_MASK = np.concatenate(
    [
        [True] * (1 + 2 + 1),
        _lower_binary[1:].repeat(3),
        _lower_binary[1:].repeat(6),
        _lower_binary.repeat(3),
        [True] * 4,
    ]
)
HML_UPPER_BODY_MASK = ~HML_LOWER_BODY_MASK
