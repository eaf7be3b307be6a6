"""mdm_tpu_torch.utils.compile_cache: MDM_TPU_COMPILE_CACHE chooses the
directory the CUDA kernels' library is built into and loaded from, read
whenever ops/_build.py looks for it. No nvcc is needed: a library already
in place under its hashed name is found, not built."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from mdm_tpu_torch.ops import _build  # noqa: E402
from mdm_tpu_torch.utils import compile_cache as cc  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("value", [None, "1"])
def test_default_is_the_checkouts_build_dir(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(cc.ENV, raising=False)
    else:
        monkeypatch.setenv(cc.ENV, value)
    assert (cc.kernel_cache_dir() == cc.DEFAULT_DIR == _build.BUILD_DIR
            == REPO / "mdm_tpu_torch" / "_build")
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path().name.startswith("mdm_kernels_")
    assert cc.enable_compile_cache() == str(cc.DEFAULT_DIR) and cc.DEFAULT_DIR.is_dir()


def test_a_named_directory_is_shared(monkeypatch, tmp_path):
    """<dir>: the library's directory, made on demand; a library already
    there under the sources' hash is found by build() without nvcc."""
    shared = tmp_path / "kernels"
    monkeypatch.setenv(cc.ENV, str(shared))
    name = _build.library_path().name
    assert _build.library_path() == shared / name and not shared.exists()
    assert cc.enable_compile_cache() == str(shared) and shared.is_dir()
    (shared / name).write_bytes(b"")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("a found library was rebuilt"))
    assert _build.build() == shared / name
    monkeypatch.setenv(cc.ENV, "~")
    assert cc.kernel_cache_dir() == Path.home().resolve()


_PROBE = r"""
from mdm_tpu_torch.ops import _build
from mdm_tpu_torch.utils import compile_cache as cc
print(cc.enable_compile_cache(), _build.library_path().parent, cc.kernel_cache_dir())
"""


def test_zero_is_a_fresh_directory_per_process(monkeypatch):
    """0: a temporary directory of the process's own, the same for each
    call, removed at exit; enable_compile_cache() says None."""
    monkeypatch.setattr(cc, "_process_dir", None)
    monkeypatch.setenv(cc.ENV, "0")
    here = cc.kernel_cache_dir()
    assert here.is_dir() and here == cc.kernel_cache_dir() != cc.DEFAULT_DIR
    assert _build.library_path().parent == here and cc.enable_compile_cache() is None
    seen = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                             text=True, timeout=120, env=dict(os.environ, **{cc.ENV: "0"}))
        assert out.returncode == 0, out.stderr[-2000:]
        none, parent, again = out.stdout.split()
        assert none == "None" and parent == again and not os.path.exists(parent)
        seen.append(parent)
    assert seen[0] != seen[1] and str(here) not in seen


def test_every_cli_turns_the_cache_on(monkeypatch, tmp_path):
    """utils/parser.py::_build makes the directory before it parses, as
    mdm_tpu's parser enables its cache."""
    from mdm_tpu_torch.utils.parser import train_args

    monkeypatch.setenv(cc.ENV, str(tmp_path / "cli"))
    train_args(["--save_dir", str(tmp_path / "run")])
    assert (tmp_path / "cli").is_dir()
