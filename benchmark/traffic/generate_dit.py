"""Text-to-motion generation on DiT's denoiser (``arch="dit"``), closed loop,
one client: ``generate.py``'s traffic (the inputs drawn from the seed, the
window of whole requests, the joints to the host, every denoiser input of
the checked requests recorded), with its own set-up, counts, reference and
check.

A request is ``batch`` prompts through CLIP, then ``MotionGenerator.generate``
(DDPM over the configuration's steps, exact classifier-free guidance as one
double batch), then the joints to the host. DiT's rows are independent of
each other (a LayerNorm per row, the modulation per sample, attention
within a sequence), so the check follows a sample of ``check_motions``
motions of each checked request, motion 0 and others drawn from the seed,
through every step: the float32 reference on those rows reproduces those
rows of the guided batch, at a sixteenth of the whole batch's cost.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.counts import dit as dit_counts
from benchmark.counts import flops
from benchmark.harness import checks as C
from benchmark.harness.weights import make, sub_seed
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference import dit as ref_dit
from benchmark.reference import models as ref_models
from benchmark.reference.precision import Precision
from benchmark.traffic.generate import (  # noqa: F401  (the shared traffic)
    PHASE, State, _SAMPLE, _W_DEN, _W_TOWER, _failed, _joints, _request_generator, _slots, _tower,
    draw_inputs, end_to_end, release, request, window)

_MOTIONS = 6  # seed tag: the checked motions of a request
_DIT_KEYS = ("arch", "njoints", "nfeats", "latent_dim", "ff_size", "num_layers", "num_heads",
             "cond_mode", "text_dim", "mask_frames", "pos_embed_max_len")


def program_dit(den: dict, dtype: str, seed: int, device):
    """The program's DiT for the configuration's ``denoiser`` group, with the
    weights ``make`` draws for it from ``seed``."""
    from mdm_tpu_torch.models.mdm import MDM, MDMConfig

    with torch.device(device):
        mdm = MDM(MDMConfig(**{k: den[k] for k in _DIT_KEYS}, compute_dtype=dtype))
    mdm.to(device).load_state_dict(make(ref_dit.dit_params(den), seed, device), strict=True)
    return mdm.eval()


def setup(cell: dict, seed: int, device: str, mark=lambda name: None) -> State:
    from mdm_tpu_torch.diffusion.schedule import Schedule
    from mdm_tpu_torch.models import text_encoders as T
    from mdm_tpu_torch.ops import _build
    from mdm_tpu_torch.sampling.pipeline import GenerationConfig, MotionGenerator

    mark("imports")
    p, model = cell["params"], cell["model"]
    den, tw, dif = model["denoiser"], model["text_encoder"], model["diffusion"]
    # the model first: a program without arch="dit" refuses it before the kernels build
    mdm = program_dit(den, cell["dtype"], sub_seed(seed, _W_DEN), device)
    mark("denoiser")
    if torch.device(device).type == "cuda":
        _build.load_library()
    mark("kernel library")
    with torch.device(device):
        tower = T.ClipTextEncoder(T.ClipTextConfig(**{k: tw[k] for k in (
            "vocab_size", "width", "layers", "heads", "context_length", "embed_dim")}))
    mark("modules")
    tower.load_state_dict(make(ref_models.tower_params(tw), sub_seed(seed, _W_TOWER), device),
                          strict=True)
    tower.eval()
    gen = MotionGenerator(mdm, Schedule.create(dif["noise_schedule"], dif["diffusion_steps"]),
                          GenerationConfig(guidance_scale=dif["guidance_param"],
                                           sampler=dif["sampler"]))
    mark("weights")
    rng = np.random.default_rng(sub_seed(seed, _SAMPLE))
    keep = {0} | set(rng.choice(p["check_among"], size=p["check_requests"] - 1,
                                replace=False).tolist())
    st = State(cell, seed, device, gen, tower, draw_inputs(cell, seed, device), keep)
    st.slots = _slots(st)
    st.spans = [(mdm, "mdm.forward"), (tower, "text_tower.forward")] + [
        (block, "mdm.layer") for block in mdm.blocks]
    mark("inputs")
    # warm-up: one request of the cell's own shapes, outside the window
    _failed([~request(st, -1)["finite"]])
    mark("warm-up request")
    return st


def request_work(st: State, j: int) -> flops.Work:
    """The operations and bytes of one request on pool entry j."""
    den, tw = st.cell["model"]["denoiser"], st.cell["model"]["text_encoder"]
    work = flops.Work()
    flops.clip_forward(work, tw, st.inputs["token_lengths"][j].tolist())
    lengths = st.inputs["lengths"][j].tolist() * 2  # the guidance's double batch
    return dit_counts.dit_forward(work, den, st.cell["dtype"], lengths,
                                  times=st.cell["model"]["diffusion"]["diffusion_steps"])


def counts(st: State, rec) -> Dict:
    P = st.cell["params"]["pool"]
    work = flops.Work()
    for i in range(rec.n):
        work.merge(request_work(st, i % P))
    return {"phase": PHASE, "units": rec.n, "work": work, "dtype": st.cell["dtype"]}


def reference_params(st: State):
    den, tw = st.cell["model"]["denoiser"], st.cell["model"]["text_encoder"]
    return (make(ref_dit.dit_params(den), sub_seed(st.seed, _W_DEN), st.device),
            make(ref_models.tower_params(tw), sub_seed(st.seed, _W_TOWER), st.device))


def motions(st: State, i: int) -> torch.Tensor:
    """Request i's checked motions: 0 and ``check_motions`` - 1 others drawn
    from the seed, in order."""
    B, n = st.cell["params"]["batch"], st.cell["params"]["check_motions"]
    rng = np.random.default_rng(sub_seed(st.seed, _MOTIONS, i + 1))
    rows = [0] + sorted(rng.choice(np.arange(1, B), size=n - 1, replace=False).tolist())
    return torch.tensor(rows, device=st.device)


def _guided(st: State, j: int, rows, P_den, text, prec: Precision):
    """The reference's guided denoiser (x, step) -> x0_hat on pool entry j's
    ``rows``."""
    den = st.cell["model"]["denoiser"]
    mask = st.inputs["frames_mask"][j][rows]

    def fn(xt, t, drop):
        return ref_dit.dit_forward(P_den, den, xt, t, text[rows], prec=prec, frames_mask=mask,
                                   cond_drop=torch.full((xt.shape[0],), drop, device=st.device))

    return ref_diffusion.guided(fn, st.cell["model"]["diffusion"]["guidance_param"])


def _draws(st: State, i: int):
    """Request i's generator and its schedule: the initial noise and one
    draw a step, of the whole batch, in the program's order."""
    p, den = st.cell["params"], st.cell["model"]["denoiser"]
    g = _request_generator(st, i)
    shape = (p["batch"], p["frames"], den["njoints"] * den["nfeats"])
    return g, shape, ref_diffusion.Schedule(st.cell["model"]["diffusion"]["diffusion_steps"],
                                            st.device)


def reference_request(st: State, i: int, prec: Precision, params,
                      tower_prec: Optional[Precision] = None) -> dict:
    """The plain reference in the program's place for request i's checked
    motions: its own chain, the denoiser at ``prec`` and the tower at
    ``tower_prec``, recorded as ``request`` records the program's but with
    only those motions (``rows``: where they are in its features)."""
    P_den, P_tw = params
    j = i % st.cell["params"]["pool"]
    rows = motions(st, i)
    g, shape, sched = _draws(st, i)
    text = _tower(st, j, P_tw, tower_prec or prec)
    xs = []
    with torch.no_grad(), prec.scope():
        x = torch.randn(shape, generator=g, device=st.device)[rows]
        model = _guided(st, j, rows, P_den, text, prec)
        for step in range(sched.T - 1, -1, -1):
            xs.append(x)
            t = torch.full((x.shape[0],), step, dtype=torch.long, device=st.device)
            z = torch.randn(shape, generator=g, device=st.device)[rows]
            x = (sched.coef1[step] * model(x, t) + sched.coef2[step] * x
                 + float(step != 0) * torch.exp(0.5 * sched.log_var[step]) * z)
    return {"xs": xs, "text": text, "features": x, "joints": _joints(st, x),
            "rows": torch.arange(len(rows), device=st.device)}


def check_request(st: State, checks: C.Checks, i: int, got: dict, params) -> None:
    """Request i's three numbers against the float32 reference, on its
    checked motions (``motions``), following ``got``'s chain step by step
    from its own recorded state, as ``generate.check_request`` does:

    - ``text_rel``: the tower's output, every prompt;
    - ``step_rel``: the start (the first input against the request's noise)
      and every transition (the reference's guided denoiser, posterior mean
      and noise on the recorded input, against the next recorded input, or
      at the last step the features returned), by the worst motion;
    - ``joints_rel``: the joints returned, by the worst motion, against the
      decoding of the reference's last steps."""
    P_den, P_tw = params
    j = i % st.cell["params"]["pool"]
    rows = motions(st, i)
    at = got.get("rows", rows)  # where the checked motions are in got's features
    g, shape, sched = _draws(st, i)
    text = _tower(st, j, P_tw, Precision("f32"))
    checks.add("text_rel", C.max_rel(got["text"], text))
    recorded = lambda k: got["xs"][k] if "rows" in got else got["xs"][k][rows]
    prec = Precision("f32")
    with torch.no_grad(), prec.scope():
        model = _guided(st, j, rows, P_den, text, prec)
        worst = C.worst_rel(recorded(0), torch.randn(shape, generator=g, device=st.device)[rows])
        for k, step in enumerate(range(sched.T - 1, -1, -1)):
            x = recorded(k).float()
            t = torch.full((x.shape[0],), step, dtype=torch.long, device=st.device)
            z = torch.randn(shape, generator=g, device=st.device)[rows]
            nxt = (sched.coef1[step] * model(x, t) + sched.coef2[step] * x
                   + float(step != 0) * torch.exp(0.5 * sched.log_var[step]) * z)
            want = recorded(k + 1) if k + 1 < sched.T else got["features"][at].float()
            worst = max(worst, C.worst_rel(want, nxt))
        checks.add("step_rel", worst)
        joints = _joints(st, nxt)
    checks.add("joints_rel", C.worst_rel(got["joints"][at.cpu()].to(st.device), joints))


def check(st: State, rec, limits: Dict[str, float]) -> C.Checks:
    checks = C.Checks(limits)
    params = reference_params(st)
    for i, got in rec.kept:
        check_request(st, checks, i, got, params)
    return checks
