"""Legacy key:value opt-file reader (reference data_loaders/humanml/utils/
get_opt.py:29-80) for drop-in compatibility with the T2M config files
(`humanml_opt.txt`, `kit_opt.txt`) shipped in assets/.

A copy of mdm_tpu/data/get_opt.py. New code should use
:class:`mdm_tpu_torch.data.HumanMLOptions`; this exists so
users migrating from the reference can keep their opt files and checkpoint
directory conventions.
"""
from __future__ import annotations

import os
from argparse import Namespace
from os.path import join as pjoin


def _parse_value(value: str):
    if value in ("True", "False"):
        return value == "True"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


def get_opt(opt_path: str, **overrides) -> Namespace:
    opt = Namespace()
    skip = ("-------------- End ----------------",
            "------------ Options -------------",
            "\n")
    with open(opt_path) as f:
        for line in f:
            if line.strip() in [s.strip() for s in skip] or not line.strip():
                continue
            key, _, value = line.strip().partition(": ")
            setattr(opt, key, _parse_value(value))

    opt.which_epoch = "finest"
    data_root = getattr(opt, "data_root", "./dataset/HumanML3D")
    name = getattr(opt, "dataset_name", "t2m")
    if name == "t2m":
        opt.data_root = overrides.get("data_root", "./dataset/HumanML3D")
        opt.joints_num = 22
        opt.dim_pose = 263
        opt.max_motion_length = 196
        opt.max_motion_frame = 196
    elif name == "kit":
        opt.data_root = overrides.get("data_root", "./dataset/KIT-ML")
        opt.joints_num = 21
        opt.dim_pose = 251
        opt.max_motion_length = 196
        opt.max_motion_frame = 196
    opt.motion_dir = pjoin(opt.data_root, "new_joint_vecs")
    opt.text_dir = pjoin(opt.data_root, "texts")
    opt.unit_length = getattr(opt, "unit_length", 4)
    opt.max_text_len = getattr(opt, "max_text_len", 20)
    opt.is_train = False
    for k, v in overrides.items():
        setattr(opt, k, v)
    return opt


def options_from_opt_file(opt_path: str, **overrides):
    """opt file -> HumanMLOptions (the typed config)."""
    from .humanml import HumanMLOptions

    opt = get_opt(opt_path, **overrides)
    return HumanMLOptions(
        dataset_name=opt.dataset_name,
        data_root=opt.data_root,
        max_motion_length=opt.max_motion_length,
        max_text_len=opt.max_text_len,
        unit_length=opt.unit_length,
        joints_num=opt.joints_num,
        dim_pose=opt.dim_pose,
    )
