"""Diffusion noise schedules and timestep respacing.

Counterpart of mdm_tpu/diffusion/schedule.py. Every per-timestep table is
computed once in float64 numpy (the reference's precision discipline,
gaussian_diffusion.py:165-202) and then moved to the device as float32
tensors. ``Schedule.respaced`` recomputes betas over the retained subset and
keeps the original-timestep map, so a 50-step schedule behaves like the
1000-step one; the model always sees original timesteps via
``timestep_map``.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Iterable, Sequence, Set, Union

import numpy as np
import torch

__all__ = ["MeanType", "VarType", "named_beta_schedule", "space_timesteps", "Schedule"]


class MeanType(enum.Enum):
    """What the denoiser predicts."""

    PREVIOUS_X = "previous_x"
    START_X = "start_x"  # MDM's choice
    EPSILON = "epsilon"


class VarType(enum.Enum):
    """Reverse-process variance handling."""

    FIXED_SMALL = "fixed_small"  # MDM's choice (posterior variance)
    FIXED_LARGE = "fixed_large"
    LEARNED = "learned"  # the model emits the log variance
    LEARNED_RANGE = "learned_range"  # ... an interpolation between the two fixed ones


def _cosine_alpha_bar(t: float) -> float:
    return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2


def named_beta_schedule(name: str, num_timesteps: int, scale_betas: float = 1.0) -> np.ndarray:
    """Linear (Ho et al.) or cosine (Nichol & Dhariwal) beta schedule, f64."""
    if name == "linear":
        scale = scale_betas * 1000 / num_timesteps
        return np.linspace(scale * 1e-4, scale * 0.02, num_timesteps, dtype=np.float64)
    if name == "cosine":
        ts = np.arange(num_timesteps, dtype=np.float64)
        a1 = np.array([_cosine_alpha_bar(t / num_timesteps) for t in ts])
        a2 = np.array([_cosine_alpha_bar((t + 1) / num_timesteps) for t in ts])
        return np.minimum(1.0 - a2 / a1, 0.999)
    raise ValueError(f"unknown beta schedule {name!r}")


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """Subset of original timesteps for a respaced process (reference
    respace.py:9-62): per-section counts, a comma string, or "ddimN"."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return set(all_steps)


@dataclass(frozen=True)
class Schedule:
    """Per-timestep diffusion coefficients as float32 ``[T]`` tensors on one
    device. ``timestep_map`` (int64) maps a respaced index to the original
    timestep fed to the model (identity when not respaced)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    log_fixed_large_variance: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor
    num_timesteps: int
    original_num_timesteps: int

    @classmethod
    def from_betas(cls, betas: np.ndarray, timestep_map: Iterable[int] | None = None,
                   original_num_timesteps: int | None = None, device=None) -> "Schedule":
        betas = np.asarray(betas, dtype=np.float64)
        if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-d array in (0, 1]")
        T = len(betas)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)

        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        if T > 1:
            post_logvar_clipped = np.log(np.append(post_var[1], post_var[1:]))
            fixed_large = np.append(post_var[1], betas[1:])
        else:
            # Single-step schedule: the t=0 variance is never used; keep it finite.
            post_logvar_clipped = np.log(np.maximum(post_var, 1e-20))
            fixed_large = betas.copy()

        if timestep_map is None:
            timestep_map = np.arange(T)
        tmap = np.asarray(list(timestep_map), dtype=np.int64)

        dev = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(
            betas=dev(betas),
            alphas_cumprod=dev(acp),
            alphas_cumprod_prev=dev(acp_prev),
            alphas_cumprod_next=dev(acp_next),
            sqrt_alphas_cumprod=dev(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=dev(np.sqrt(1.0 - acp)),
            log_one_minus_alphas_cumprod=dev(np.log(1.0 - acp)),
            sqrt_recip_alphas_cumprod=dev(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=dev(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=dev(post_var),
            posterior_log_variance_clipped=dev(post_logvar_clipped),
            posterior_mean_coef1=dev(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=dev((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            fixed_large_variance=dev(fixed_large),
            log_fixed_large_variance=dev(np.log(fixed_large)),
            log_betas=dev(np.log(betas)),
            timestep_map=torch.tensor(tmap, device=device),
            num_timesteps=T,
            original_num_timesteps=int(original_num_timesteps or T),
        )

    @classmethod
    def create(cls, noise_schedule: str = "cosine", diffusion_steps: int = 1000,
               timestep_respacing: Union[str, Sequence[int], None] = None,
               scale_betas: float = 1.0, device=None) -> "Schedule":
        """A (possibly respaced) schedule, as the reference's model factory
        builds it (utils/model_util.py:75-116)."""
        betas = named_beta_schedule(noise_schedule, diffusion_steps, scale_betas)
        if not timestep_respacing:
            return cls.from_betas(betas, device=device)
        use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
        return cls.respaced(betas, use_timesteps, device=device)

    @classmethod
    def respaced(cls, base_betas: np.ndarray, use_timesteps: Iterable[int],
                 device=None) -> "Schedule":
        """Betas recomputed over a retained subset so T'-step sampling
        matches the T-step process (reference respace.py:65-115)."""
        base_betas = np.asarray(base_betas, dtype=np.float64)
        acp = np.cumprod(1.0 - base_betas)
        last_alpha_cumprod = 1.0
        new_betas, tmap = [], []
        use = set(use_timesteps)
        for i in range(len(base_betas)):
            if i in use:
                new_betas.append(1.0 - acp[i] / last_alpha_cumprod)
                last_alpha_cumprod = acp[i]
                tmap.append(i)
        return cls.from_betas(np.asarray(new_betas), timestep_map=tmap,
                              original_num_timesteps=len(base_betas), device=device)

    def to(self, device) -> "Schedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        """Respaced step index -> original timestep fed to the model."""
        return self.timestep_map[t]
