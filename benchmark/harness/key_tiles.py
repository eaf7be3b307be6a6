"""The attention core's engagement in a traced window: of the (query tile,
key tile) score tiles a full walk over every key would compute, the share
its blocks computed. The program counts both while the profiler records
(``mdm_tpu_torch.ops.attention_key_tiles``, which reads and resets them);
a program without that counter gives nothing to read."""
from __future__ import annotations

from typing import Optional, Tuple

from benchmark.harness import readers


def program_counts() -> Tuple[int, int]:
    """(walked, full) since the last read, or (0, 0) where the program has
    no counter."""
    try:
        from mdm_tpu_torch.ops import attention_key_tiles
    except ImportError:
        return 0, 0
    return attention_key_tiles()


def walked_share(obs, phase: str) -> Optional[float]:
    """100 x walked / full over the window, None where the window is of the
    other phase or nothing was counted."""
    if not readers._of(obs, phase):
        return None
    walked, full = program_counts()
    return 100.0 * walked / full if full > 0 else None
