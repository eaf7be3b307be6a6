"""Experiment-tracking platforms (reference train/train_platforms.py).

Counterpart of mdm_tpu/train/platforms.py: ``NoPlatform`` and the
TensorBoard, WandB and ClearML adapters. Each adapter imports its package
only when it is built, and raises ImportError when the package is absent
(the port depends on none of them).
"""
from __future__ import annotations

import importlib
import importlib.util
from typing import Dict, Optional, Type


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


def _require(module: str, package: str):
    """``module`` imported, or ImportError naming the package it needs."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"this train platform needs the {package!r} package, which is not "
                          f"installed") from e


class TensorboardPlatform(TrainPlatform):
    """Scalars to a TensorBoard event file under ``save_dir``, through
    tensorboardX's SummaryWriter, else torch.utils.tensorboard's (which
    needs the ``tensorboard`` package)."""

    def __init__(self, save_dir: str, **kwargs):
        super().__init__(save_dir)
        if importlib.util.find_spec("tensorboardX") is not None:
            writer = _require("tensorboardX", "tensorboardX").SummaryWriter
        else:
            _require("tensorboard", "tensorboard")
            writer = _require("torch.utils.tensorboard", "tensorboard").SummaryWriter
        self.writer = writer(log_dir=save_dir)

    def report_scalar(self, name, value, iteration, group_name=""):
        self.writer.add_scalar(f"{group_name}/{name}", value, iteration)

    def close(self):
        self.writer.close()


class WandBPlatform(TrainPlatform):
    def __init__(self, save_dir: str, project: str = "mdm_tpu", resume_id: Optional[str] = None,
                 config: Optional[dict] = None, **kwargs):
        super().__init__(save_dir)
        self.wandb = _require("wandb", "wandb")
        self.run = self.wandb.init(project=project, dir=save_dir, resume="allow", id=resume_id,
                                   config=config)

    def report_scalar(self, name, value, iteration, group_name=""):
        self.wandb.log({f"{group_name}/{name}": value}, step=iteration)

    def report_media(self, title, series, iteration, local_path):
        if local_path.endswith(".mp4"):
            self.wandb.log({title: self.wandb.Video(local_path)}, step=iteration)

    def report_args(self, args, name):
        self.wandb.config.update(args, allow_val_change=True)

    def close(self):
        self.wandb.finish()


class ClearmlPlatform(TrainPlatform):
    def __init__(self, save_dir: str, task_name: str = "mdm_tpu", **kwargs):
        super().__init__(save_dir)
        Task = _require("clearml", "clearml").Task
        self.task = Task.init(project_name="motion_diffusion", task_name=task_name)
        self.logger = self.task.get_logger()

    def report_scalar(self, name, value, iteration, group_name=""):
        self.logger.report_scalar(group_name, name, value, iteration)

    def report_media(self, title, series, iteration, local_path):
        self.logger.report_media(title=title, series=series, iteration=iteration,
                                 local_path=local_path)

    def close(self):
        self.task.close()


PLATFORM_REGISTRY: Dict[str, Type[TrainPlatform]] = {
    "NoPlatform": NoPlatform,
    "Tensorboard": TensorboardPlatform,
    "TensorboardPlatform": TensorboardPlatform,
    "WandB": WandBPlatform,
    "WandBPlatform": WandBPlatform,
    "ClearML": ClearmlPlatform,
    "ClearmlPlatform": ClearmlPlatform,
}


def get_platform(name: str, save_dir: str, **kwargs) -> TrainPlatform:
    """The platform ``name`` of ``PLATFORM_REGISTRY`` ("" or None: none).
    Unlike mdm_tpu's adapters, which turn into no-ops when their package is
    absent, building one raises ImportError then."""
    if name in ("", None):
        name = "NoPlatform"
    if name not in PLATFORM_REGISTRY:
        raise ValueError(f"unknown train platform {name!r}")
    return PLATFORM_REGISTRY[name](save_dir, **kwargs)
