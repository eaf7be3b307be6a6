"""Experiment-tracking platforms (reference train/train_platforms.py).

Counterpart of mdm_tpu/train/platforms.py. Only ``NoPlatform`` is ported;
the other adapters need a package the port does not depend on
(tensorboard, wandb, clearml), and asking for one raises.
"""
from __future__ import annotations

import importlib.util
from typing import Dict


class TrainPlatform:
    def __init__(self, save_dir: str, **kwargs):
        self.save_dir = save_dir

    def report_scalar(self, name: str, value: float, iteration: int, group_name: str = ""):
        pass

    def report_media(self, title: str, series: str, iteration: int, local_path: str):
        pass

    def report_args(self, args: Dict, name: str):
        pass

    def close(self):
        pass


class NoPlatform(TrainPlatform):
    pass


# Platform names of the JAX package -> the package their adapter needs.
_UNPORTED = {"Tensorboard": "tensorboard", "TensorboardPlatform": "tensorboard",
             "WandB": "wandb", "WandBPlatform": "wandb",
             "ClearML": "clearml", "ClearmlPlatform": "clearml"}


def get_platform(name: str, save_dir: str, **kwargs) -> TrainPlatform:
    if name in ("NoPlatform", "", None):
        return NoPlatform(save_dir, **kwargs)
    if name not in _UNPORTED:
        raise ValueError(f"unknown train platform {name!r}")
    package = _UNPORTED[name]
    if importlib.util.find_spec(package) is None:
        raise ImportError(f"train platform {name!r} needs the {package!r} package, "
                          f"which is not installed")
    raise NotImplementedError(f"train platform {name!r} is not ported yet: "
                              f"ROADMAP Queue 1 item 5 (train/platforms.py)")
