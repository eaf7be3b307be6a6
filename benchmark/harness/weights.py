"""Seeded weights, made on the device in a few large calls.

One draw of N(0, 1) for every parameter of a list (``reference/models.py``'s
``(name, shape, kind)``), from a generator on the device seeded from the
run's seed, then one scale and one shift over the whole buffer. The same
seed gives the same weights on the same device, so the program and the
reference each make their own copy.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

# kind -> (scale, shift); "w" and "proj" scale by 1 / sqrt(fan_in)
_KINDS = {"b": (0.02, 0.0), "ln_w": (0.1, 1.0), "ln_b": (0.1, 0.0), "emb": (0.02, 0.0),
          "pos": (0.01, 0.0)}


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of its own for each tag path under the run's seed."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0] >> 1)


def make(specs: Sequence, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``specs``, views of one buffer."""
    numels = [int(np.prod(shape)) for _, shape, _ in specs]
    scales, shifts = [], []
    for (_, shape, kind), n in zip(specs, numels):
        if kind in ("w", "proj"):
            fan_in = shape[1] if kind == "w" else shape[0]
            scales.append(1.0 / math.sqrt(fan_in))
            shifts.append(0.0)
        else:
            scales.append(_KINDS[kind][0])
            shifts.append(_KINDS[kind][1])
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(numels), generator=gen, device=device)
    counts = torch.tensor(numels, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(scales, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(shifts, device=device), counts))
    out, offset = {}, 0
    for (name, shape, _), n in zip(specs, numels):
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    return out


_MDM_KEYS = ("njoints", "nfeats", "latent_dim", "ff_size", "num_layers", "num_heads", "arch",
             "cond_mode", "text_dim", "text_tokens", "emb_policy", "mask_frames", "context_len",
             "pred_len", "dropout")


def program_mdm(den: dict, dtype: str, seed: int, device):
    """The program's denoiser for the configuration's ``denoiser`` group,
    built on ``device`` with the weights ``make`` draws for it from ``seed``."""
    from mdm_tpu_torch.models.mdm import MDM, MDMConfig

    from benchmark.reference.models import mdm_params

    with torch.device(device):
        mdm = MDM(MDMConfig(**{k: den[k] for k in _MDM_KEYS if k in den}, compute_dtype=dtype))
    mdm.to(device).load_state_dict(make(mdm_params(den), seed, device), strict=True)
    return mdm
