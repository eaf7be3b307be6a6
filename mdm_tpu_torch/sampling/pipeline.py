"""End-to-end generation: conditioning -> features -> joints.

Counterpart of mdm_tpu/sampling/pipeline.py (GenerationConfig,
load_norm_stats, dataset_norm_stats, auto_mesh, MotionGenerator :81-515,
the edit masks :522-546): the four samplers of diffusion/samplers.py with
exact classifier-free guidance (one double-batched forward) or its cached
form, and DiP's autoregressive prefix completion as a host loop over
chunks with the prefix kept on the card. The denoise loop runs eagerly;
on a CUDA device every encoder layer of every step goes through the
hand-written layer kernel chain, and every decoder layer through the
rate-0 attention block and the rate-0 fused tail.

Over a mesh of several ranks (parallel/mesh.py), the counterpart of the
JAX package's shard_map sampling (:141-157, :225-229, :288-364):

- data parallel: each rank samples its rows of the batch through the
  kernels and the features are gathered (an all-reduce of zeroed global
  rows, exact). The initial noise is the global draw (or the one given),
  sliced; each rank's later draws (step noise, DiP's chunk noise) come
  from its own generator, seeded from one draw of the caller's generator
  and the rank's batch index (JAX's ``fold_in(key, shard index)``). A
  batch the data axis does not divide runs whole on every rank;
- tensor parallel (a model axis above 1): each rank holds its Megatron
  part of the denoiser (parallel/tp_rules.py) and runs the whole batch on
  the einsum attention and the plain tail; AUTO turns the kernels off.

Spans (utils/tracing.py): ``generate`` is one ``sample.request``, each of
DiP's chunks a ``sample.chunk``, the decoding to joints ``sample.decode``.
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core import hml_codec
from ..diffusion.samplers import SAMPLERS, SamplerConfig
from ..diffusion.schedule import Schedule
from ..models.mdm import MDM, Conditioning, cfg_denoiser, cfg_denoiser_cached
from ..utils.tracing import span, traced

STATS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "stats")


def auto_mesh(device=None):
    """The world's data-parallel mesh for the sampling and eval CLIs when a
    torch.distributed world of more than one rank is up, else None."""
    from ..parallel.multihost import world_size

    if world_size() <= 1:
        return None
    from ..parallel.mesh import make_mesh

    return make_mesh(device=device)


def load_norm_stats(dataset: str = "humanml"):
    """Bundled evaluator-family feature stats (assets/stats/{t2m,kit}_*.npy)."""
    prefix = "t2m" if dataset == "humanml" else "kit"
    mean = np.load(os.path.join(STATS_DIR, f"{prefix}_mean.npy"))
    std = np.load(os.path.join(STATS_DIR, f"{prefix}_std.npy"))
    return mean.astype(np.float32), std.astype(np.float32)


def dataset_norm_stats(data_root: Optional[str]):
    """The dataset's own train stats (Mean/Std.npy under ``data_root``) if
    present, else None."""
    if not data_root:
        return None
    mp, sp = os.path.join(data_root, "Mean.npy"), os.path.join(data_root, "Std.npy")
    if os.path.exists(mp) and os.path.exists(sp):
        return np.load(mp).astype(np.float32), np.load(sp).astype(np.float32)
    return None


@dataclass(frozen=True)
class GenerationConfig:
    guidance_scale: float = 2.5
    sampler: str = "ddpm"  # ddpm | ddim | plms | dpmpp_2m
    clip_denoised: bool = False
    # DiP autoregressive generation; the prefix and chunk lengths are the
    # model's own (MDMConfig.context_len, MDMConfig.pred_len)
    autoregressive: bool = False
    autoregressive_include_prefix: bool = False
    # >1 enables cached CFG: recompute the uncond branch every k steps and
    # reuse it otherwise (1 + 1/k forwards per step instead of 2). 0/1 = exact.
    cfg_cache_interval: int = 0


class MotionGenerator:
    """Holds a model and its schedule; samples on the model's device."""

    def __init__(self, model: MDM, sched: Schedule,
                 config: GenerationConfig = GenerationConfig(), dataset: str = "humanml",
                 norm_stats=None, mesh=None):
        """``norm_stats``: the (mean, std) the model was trained with (the
        dataset's Mean/Std.npy, ``dataset_norm_stats``), which decode its
        features; without them an hml_vec model decodes with the bundled
        t2m/kit stats (close but not identical).

        ``mesh``: a parallel.mesh.Mesh. Without a model axis above 1 the
        generator samples data-parallel over its batch axes (a mesh of one
        rank too, whose gather is the identity); with one, it samples a
        tensor-parallel copy of ``model`` (the model passed is left
        whole)."""
        if config.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {config.sampler!r}; known: {sorted(SAMPLERS)}")
        if config.cfg_cache_interval > 1 and config.sampler not in ("ddpm", "ddim"):
            raise ValueError(
                f"cfg_cache_interval={config.cfg_cache_interval} is only supported for the "
                f"ddpm/ddim samplers (the plms/dpmpp_2m multistep solvers thread their own "
                f"per-step model state); got sampler={config.sampler!r}. Drop "
                f"--cfg_cache_interval or switch samplers.")
        if config.autoregressive and not (model.config.context_len > 0
                                          and model.config.pred_len > 0):
            raise ValueError(
                "autoregressive generation needs a prefix-completion model: "
                f"MDMConfig.context_len={model.config.context_len} and "
                f"pred_len={model.config.pred_len} must both be > 0")
        self.mesh = mesh
        self.tensor_parallel = self.mesh is not None and self.mesh.model_parallel > 1
        if self.tensor_parallel:
            from ..parallel.tp_rules import shard_model_

            model = shard_model_(copy.deepcopy(model), self.mesh)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.sched = sched.to(self.device)
        self.config = config
        self.joints_num = 22 if dataset == "humanml" else 21
        self.mean = self.std = None
        if norm_stats is None and model.config.data_rep == "hml_vec":
            norm_stats = load_norm_stats(dataset)
        if norm_stats is not None:
            self.mean, self.std = (torch.from_numpy(np.asarray(s, np.float32)).to(self.device)
                                   for s in norm_stats)

    def _kernels(self):
        """AUTO for this generator's calls (``ops.mesh_kernels``): the
        kernels on, except under tensor parallelism, where a pinned kernel
        flag raises."""
        from .. import ops

        return ops.mesh_kernels(self.tensor_parallel)

    def _dp_rows(self, batch_size: int) -> Optional[slice]:
        """This rank's rows when the data axis divides the batch, else None
        (the batch runs whole on every rank)."""
        if self.mesh is None or self.tensor_parallel:
            return None
        if batch_size % self.mesh.data_parallel:
            return None
        return self.mesh.rows(batch_size)

    def _rank_generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        """This rank's stream for the draws after the initial noise: one
        draw of ``generator`` (the same on every rank) folded with the
        rank's batch index; with one rank, ``generator`` itself."""
        if self.mesh.data_parallel == 1:
            return generator
        dev = generator.device if generator is not None else self.device
        base = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=dev).item())
        seed = np.random.SeedSequence([base, self.mesh.batch_index]).generate_state(1, np.uint64)
        return torch.Generator(self.device).manual_seed(int(seed[0] >> 1))

    def _gather(self, local: torch.Tensor, rows: slice, batch_size: int) -> torch.Tensor:
        """The global [B, ...] from each rank's rows: an all-reduce of zeroed
        global rows over the batch group (exact)."""
        out = torch.zeros((batch_size,) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        out[rows] = local
        return self.mesh.sum_over_batch(out)

    def _sample(self, cond: Conditioning, noise: torch.Tensor,
                generator: Optional[torch.Generator], **kwargs) -> torch.Tensor:
        """One run of the configured sampler from ``noise`` under ``cond``
        (on the model's device), exact or cached CFG around the model."""
        ccfg = self.config
        if ccfg.guidance_scale == 1.0:
            model_fn = lambda x, t: self.model(x, t, cond)
        elif ccfg.cfg_cache_interval > 1:
            cached, kwargs["model_state"] = cfg_denoiser_cached(
                self.model, ccfg.guidance_scale, ccfg.cfg_cache_interval)
            model_fn = lambda x, t, state: cached(x, t, cond, state)
        else:
            guided = cfg_denoiser(self.model, ccfg.guidance_scale)
            model_fn = lambda x, t: guided(x, t, cond)
        return SAMPLERS[ccfg.sampler](model_fn, self.sched, noise, generator,
                                      SamplerConfig(clip_denoised=ccfg.clip_denoised), **kwargs)

    @torch.inference_mode()
    def sample_features(
        self,
        cond: Conditioning,
        batch_size: int,
        num_frames: int,
        generator: Optional[torch.Generator] = None,
        inpainting_mask: Optional[torch.Tensor] = None,
        inpainted_motion: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        step_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One diffusion sample: normalized features [B, T, D].

        ``generator`` (on the model's device) draws the initial and per-step
        noise; ``noise`` [B, T, D] and, for ``ddpm``, ``step_noise``
        [steps, B, T, D] replace those draws (parity tests feed both
        packages the same)."""
        D = self.model.config.input_feats
        if noise is None:
            noise = torch.randn((batch_size, num_frames, D), generator=generator,
                                device=self.device)
        kwargs = {}
        if step_noise is not None:  # only the ancestral sampler takes it
            kwargs["step_noise"] = step_noise.to(self.device)
        cond, noise = cond.to(self.device), noise.to(self.device)
        rows = self._dp_rows(batch_size)
        with self._kernels():
            if rows is None:
                return self._sample(cond, noise, generator, inpainting_mask=inpainting_mask,
                                    inpainted_motion=inpainted_motion, **kwargs)
            local = _rows_of(dict(cond=cond, noise=noise, inpainting_mask=inpainting_mask,
                                  inpainted_motion=inpainted_motion), batch_size, rows)
            if "step_noise" in kwargs:  # [steps, B, T, D]
                kwargs["step_noise"] = kwargs["step_noise"][:, rows]
            sample = self._sample(local["cond"], local["noise"], self._rank_generator(generator),
                                  inpainting_mask=local["inpainting_mask"],
                                  inpainted_motion=local["inpainted_motion"], **kwargs)
            return self._gather(sample, rows, batch_size)

    @torch.inference_mode()
    def sample_autoregressive(
        self,
        cond: Conditioning,
        batch_size: int,
        generator: Optional[torch.Generator] = None,
        required_frames: int = 196,
        per_chunk_cond: Optional[Callable[[int, Conditioning], Conditioning]] = None,
        chunk_noise: Optional[torch.Tensor] = None,
        chunk_step_noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """DiP: chunked prefix-completion generation of any length
        (mdm_tpu/sampling/pipeline.py:413-485; reference
        utils/sampler_util.py:41-81). Keeps the last ``context_len``
        generated frames as the next chunk's prefix, on the card, and
        denoises ``pred_len`` new frames per chunk (both the model's
        ``MDMConfig``'s); ``per_chunk_cond(i,
        cond)`` may give each chunk its own conditioning (dynamic text).

        ``chunk_noise`` [n_chunks, B, pred_len, D] and, for ``ddpm``,
        ``chunk_step_noise`` [n_chunks, steps, B, pred_len, D] replace the
        draws from ``generator`` (parity tests feed both packages the same).
        Returns [B, required_frames, D], after the initial prefix when
        ``autoregressive_include_prefix``."""
        if cond.prefix is None:
            raise ValueError("autoregressive sampling requires an initial Conditioning.prefix")
        rows = self._dp_rows(batch_size)
        with self._kernels():
            if rows is None:
                return self._autoregressive(cond, batch_size, generator, required_frames,
                                            per_chunk_cond, chunk_noise, chunk_step_noise)
            # Per rank, as JAX's _sm_ar: its rows of the condition and of any
            # given noise ([n_chunks, B, ...]); its own stream for the rest.
            local = _rows_of(dict(cond=cond.to(self.device)), batch_size, rows)["cond"]
            per_chunk = None
            if per_chunk_cond is not None:
                per_chunk = lambda i, c: _rows_of(dict(c=per_chunk_cond(i, c).to(self.device)),
                                                   batch_size, rows)["c"]
            sample = self._autoregressive(
                local, rows.stop - rows.start, self._rank_generator(generator),
                required_frames, per_chunk,
                None if chunk_noise is None else chunk_noise[:, rows],
                None if chunk_step_noise is None else chunk_step_noise[:, :, rows])
            return self._gather(sample, rows, batch_size)

    def _autoregressive(self, cond, batch_size, generator, required_frames, per_chunk_cond,
                        chunk_noise, chunk_step_noise):
        mcfg = self.model.config
        n_chunks = -(-required_frames // mcfg.pred_len)
        cond = cond.to(self.device)
        prefix = init_prefix = cond.prefix
        base = cond.replace(prefix=None)
        shape = (batch_size, mcfg.pred_len, mcfg.input_feats)
        chunks = []
        for i in range(n_chunks):
            with span("sample.chunk"):
                chunk_cond = per_chunk_cond(i, base).to(self.device) if per_chunk_cond else base
                noise = (torch.randn(shape, generator=generator, device=self.device)
                         if chunk_noise is None else chunk_noise[i].to(self.device))
                kwargs = {}
                if chunk_step_noise is not None:
                    kwargs["step_noise"] = chunk_step_noise[i].to(self.device)
                sample = self._sample(chunk_cond.replace(prefix=prefix), noise, generator,
                                      **kwargs)
                chunks.append(sample)
                prefix = torch.cat([prefix, sample], dim=1)[:, -mcfg.context_len:]
        gen = torch.cat(chunks, dim=1)
        if self.config.autoregressive_include_prefix:
            gen = torch.cat([init_prefix, gen], dim=1)
        return gen[:, :required_frames]

    @torch.inference_mode()
    @traced("sample.decode")
    def features_to_joints(self, feats: torch.Tensor) -> torch.Tensor:
        """Denormalize + decode hml_vec features to joints [B, T, J, 3]."""
        if self.mean is None:
            raise ValueError("features_to_joints needs hml_vec norm stats")
        return hml_codec.recover_from_ric(feats * self.std + self.mean, self.joints_num)

    @traced("sample.request")
    def generate(self, cond: Conditioning, batch_size: int, num_frames: int,
                 generator: Optional[torch.Generator] = None, **kwargs):
        """Full pipeline -> dict(features, joints). With ``autoregressive``
        the features come from ``sample_autoregressive`` (``num_frames``
        required frames; ``kwargs`` its own), else from ``sample_features``."""
        if self.config.autoregressive:
            feats = self.sample_autoregressive(cond, batch_size, generator,
                                               required_frames=num_frames, **kwargs)
        else:
            feats = self.sample_features(cond, batch_size, num_frames, generator, **kwargs)
        out = {"features": feats}
        if self.mean is not None:
            out["joints"] = self.features_to_joints(feats)
        return out


def _rows_of(tree: dict, batch_size: int, rows: slice) -> dict:
    """Each tensor of ``tree`` (a Conditioning's too) whose first axis is
    the batch, cut to ``rows``; everything else as it is."""
    from ..parallel.mesh import _map

    return _map(tree, lambda t: t[rows] if t.dim() and t.shape[0] == batch_size else t)


# ---------------------------------------------------------------------------
# Editing masks (sample/edit.py equivalents)
# ---------------------------------------------------------------------------

def in_between_mask(lengths: np.ndarray, num_frames: int, feat_dim: int,
                    prefix_end: float = 0.25, suffix_start: float = 0.75) -> np.ndarray:
    """Temporal inpainting mask [B, T, D]: True = keep ground truth.

    Reference edit.py:79-85 starts from an all-True mask and clears only
    [prefix_end*len, suffix_start*len): the prefix, the suffix and the
    padding frames past each sample's length keep ground truth."""
    mask = np.ones((len(lengths), num_frames, feat_dim), dtype=bool)
    for i, length in enumerate(lengths):
        mask[i, int(length * prefix_end): int(length * suffix_start)] = False
    return mask


def upper_body_mask(num_frames: int, batch_size: int) -> np.ndarray:
    """Feature-space mask [B, T, 263]: True = keep ground truth (lower body
    and root)."""
    from ..core.hml_masks import HML_LOWER_BODY_MASK

    return np.broadcast_to(HML_LOWER_BODY_MASK[None, None, :],
                           (batch_size, num_frames, len(HML_LOWER_BODY_MASK))).copy()
