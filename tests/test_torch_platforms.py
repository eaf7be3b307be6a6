"""The experiment-tracking platforms of mdm_tpu_torch.train.platforms, with
stand-in modules for wandb, clearml and tensorboardX in ``sys.modules`` (no
package can be installed for the tests): each adapter imports its package
when it is built, makes the calls mdm_tpu's adapter makes
(mdm_tpu/train/platforms.py) and raises ImportError when the package is
absent; the registry has mdm_tpu's names."""
import sys
import types

import pytest

pytest.importorskip("torch")

from mdm_tpu.train import platforms as jplatforms  # noqa: E402
from mdm_tpu_torch.train import platforms  # noqa: E402


class _Recorder:
    """Records every call made on it and on what it returns."""

    def __init__(self, log, name):
        self._log, self._name = log, name

    def __getattr__(self, attr):
        return _Recorder(self._log, f"{self._name}.{attr}")

    def __call__(self, *args, **kwargs):
        self._log.append((self._name, args, kwargs))
        return _Recorder(self._log, f"{self._name}()")


def _stand_in(monkeypatch, name, *attrs):
    log = []
    module = types.ModuleType(name)
    for attr in attrs:
        setattr(module, attr, _Recorder(log, f"{name}.{attr}"))
    monkeypatch.setitem(sys.modules, name, module)
    return log


def test_registry_names_match_jax():
    assert set(platforms.PLATFORM_REGISTRY) == set(jplatforms.PLATFORM_REGISTRY)
    assert isinstance(platforms.get_platform("NoPlatform", "x"), platforms.NoPlatform)
    assert isinstance(platforms.get_platform("", "x"), platforms.NoPlatform)
    with pytest.raises(ValueError, match="unknown train platform"):
        platforms.get_platform("Neptune", "x")


def test_wandb_platform_calls(monkeypatch, tmp_path):
    log = _stand_in(monkeypatch, "wandb", "init", "log", "Video", "config", "finish")
    p = platforms.get_platform("WandB", str(tmp_path), project="mdm", resume_id="r1",
                               config={"lr": 1})
    p.report_scalar("loss", 0.5, 3, group_name="train")
    p.report_media("anim", "s", 3, str(tmp_path / "a.mp4"))
    p.report_media("anim", "s", 3, str(tmp_path / "a.gif"))  # only videos go up
    p.report_args({"a": 1}, "args")
    p.close()
    names = [n for n, _, _ in log]
    assert names == ["wandb.init", "wandb.log", "wandb.Video", "wandb.log",
                     "wandb.config.update", "wandb.finish"]
    assert log[0][2] == dict(project="mdm", dir=str(tmp_path), resume="allow", id="r1",
                             config={"lr": 1})
    assert log[1][1] == ({"train/loss": 0.5},) and log[1][2] == {"step": 3}


def test_clearml_platform_calls(monkeypatch, tmp_path):
    log = _stand_in(monkeypatch, "clearml", "Task")
    p = platforms.get_platform("ClearML", str(tmp_path), task_name="run1")
    p.report_scalar("loss", 0.25, 7, group_name="train")
    p.report_media("anim", "s", 7, "x.mp4")
    p.close()
    assert log[0] == ("clearml.Task.init", (), dict(project_name="motion_diffusion",
                                                    task_name="run1"))
    assert ("clearml.Task.init().get_logger().report_scalar", ("train", "loss", 0.25, 7), {}) in log
    assert log[-1][0] == "clearml.Task.init().close"


def test_tensorboard_platform_calls(monkeypatch, tmp_path):
    log = _stand_in(monkeypatch, "tensorboardX", "SummaryWriter")
    monkeypatch.setattr(platforms.importlib.util, "find_spec",
                        lambda name: object() if name == "tensorboardX" else None)
    p = platforms.get_platform("Tensorboard", str(tmp_path))
    p.report_scalar("loss", 1.5, 2, group_name="train")
    p.close()
    assert log == [("tensorboardX.SummaryWriter", (), {"log_dir": str(tmp_path)}),
                   ("tensorboardX.SummaryWriter().add_scalar", ("train/loss", 1.5, 2), {}),
                   ("tensorboardX.SummaryWriter().close", (), {})]


@pytest.mark.parametrize("name,package", [("WandB", "wandb"), ("ClearML", "clearml"),
                                          ("Tensorboard", "tensorboard")])
def test_absent_package_raises_import_error(monkeypatch, tmp_path, name, package):
    for module in ("wandb", "clearml", "tensorboardX", "tensorboard", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, module, None)  # import raises ImportError
    monkeypatch.setattr(platforms.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(ImportError, match=repr(package)):
        platforms.get_platform(name, str(tmp_path))
