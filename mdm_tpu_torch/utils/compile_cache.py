"""Where the hand-written CUDA kernels' library is built and found.

Counterpart of mdm_tpu/utils/compile_cache.py, which turns on JAX's
persistent compilation cache. The port's compiled artefact is one shared
library, ``mdm_kernels_<hash>.so`` (ops/_build.py: the hash covers the
sources, headers and flags, so a changed source builds anew and an
unchanged one loads). ``MDM_TPU_COMPILE_CACHE``, the same variable,
chooses its directory, read whenever the library is looked for:

- unset or ``1``: ``mdm_tpu_torch/_build/`` in the checkout (gitignored).
  This default differs from mdm_tpu's ``~/.cache`` on purpose: the kernels
  build from the checkout's sources into a directory of the checkout, so
  ``python3 chip_smoke.py`` in a fresh checkout builds them itself and
  reads and writes nothing outside it.
- ``<dir>``: that directory (created on demand), so checkouts and
  ``git archive``s of one tree share one built library.
- ``0``: a fresh temporary directory for each process, removed when it
  exits: no persistent cache.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR as DEFAULT_DIR

ENV = "MDM_TPU_COMPILE_CACHE"
_process_dir: Optional[Path] = None


def _fresh_dir() -> Path:
    """This process's own temporary build directory (``MDM_TPU_COMPILE_CACHE=0``)."""
    global _process_dir
    if _process_dir is None:
        _process_dir = Path(tempfile.mkdtemp(prefix="mdm_kernels_"))
        atexit.register(shutil.rmtree, _process_dir, True)
    return _process_dir


def kernel_cache_dir() -> Path:
    """The directory the kernel library is built into and loaded from,
    under the current value of ``MDM_TPU_COMPILE_CACHE``."""
    env = os.environ.get(ENV, "")
    if env == "0":
        return _fresh_dir()
    return DEFAULT_DIR if env in ("", "1") else Path(env).expanduser().resolve()


def enable_compile_cache() -> Optional[str]:
    """Create the kernel library's directory and return it; None when the
    cache is opted out (``MDM_TPU_COMPILE_CACHE=0``: each process then
    builds into a temporary directory of its own). Every CLI calls this
    first, as mdm_tpu's do; safe to call more than once."""
    path = kernel_cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    return None if os.environ.get(ENV, "") == "0" else str(path)
