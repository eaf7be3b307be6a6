"""Text-to-motion generation, closed loop, one client.

A request is ``batch`` prompts: token ids drawn from the seed (``tokens``
long, start and end tokens included), through the configuration's text
tower, then ``MotionGenerator.generate`` (DDPM over the configuration's
steps, exact classifier-free guidance), then the joints to the host. The
next request starts when the joints of the one before are on the host.

Without ``autoregressive`` each prompt asks for a motion of a length drawn
from ``lengths`` (valid frames, True in ``frames_mask``), padded to
``frames``; with it (DiP) every prompt continues a prefix of
``context_len`` frames, drawn from the seed, by chunks of ``pred_len``
frames up to ``frames``. The work of a request is the same for every seed:
the sizes are fixed, only the token ids, lengths and noise move. Requests
cycle through a pool of ``pool`` inputs made in set-up; each request draws
its noise from a generator of its own, seeded from the run's seed and its
index, so the reference can draw it again.

``check(...)`` runs the plain reference once the window has closed, on a
sample of the finished requests drawn from the seed: the text tower's
output, the features and the joints of every motion of each.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.counts import flops
from benchmark.harness import checks as C
from benchmark.harness.registry import ROOT
from benchmark.harness.weights import make, program_mdm, sub_seed
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference import hml as ref_hml
from benchmark.reference import models as ref_models
from benchmark.reference.precision import Precision

PHASE = "generate"
# seed tags: denoiser weights, tower weights, inputs, request generators, checked requests
_W_DEN, _W_TOWER, _INPUTS, _REQUEST, _SAMPLE = 1, 2, 3, 4, 5
_CLIP_SOT, _CLIP_EOT = 49406, 49407
_BERT_CLS, _BERT_SEP, _BERT_FIRST_WORD = 101, 102, 1000
# the feature statistics that the program decodes with: a raw file both sides read
STATS_DIR = os.path.join(ROOT, "assets", "stats")


@dataclass
class State:
    cell: dict
    seed: int
    device: str
    gen: object
    tower: torch.nn.Module
    inputs: Dict[str, torch.Tensor]
    keep: set
    spans: list = field(default_factory=list)
    slots: list = field(default_factory=list)


@dataclass
class Records:
    n: int = 0
    latencies: List[float] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    failed: int = 0
    kept: list = field(default_factory=list)  # (index, ``request``'s output, recorded)


def draw_inputs(cell: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The pool's inputs on the device: token ids and their mask, motion
    lengths as a frames mask, DiP's prefixes."""
    p, model = cell["params"], cell["model"]
    rng = np.random.default_rng(sub_seed(seed, _INPUTS))
    P, B, tw = p["pool"], p["batch"], model["text_encoder"]
    L = tw["context_length"] if tw["type"] == "clip" else p["text_len"]
    lo, hi = p["tokens"]
    n = rng.integers(lo, hi + 1, size=(P, B))
    if tw["type"] == "clip":
        words = rng.integers(1, _CLIP_SOT, size=(P, B, L))
        first, last = _CLIP_SOT, _CLIP_EOT
    else:
        words = rng.integers(_BERT_FIRST_WORD, tw["vocab_size"], size=(P, B, L))
        first, last = _BERT_CLS, _BERT_SEP
    pos = np.arange(L)
    real = pos[None, None, :] < n[..., None]
    tokens = np.where(real, words, 0)
    tokens[..., 0] = first
    np.put_along_axis(tokens, (n - 1)[..., None], last, axis=-1)
    out = {"tokens": torch.from_numpy(tokens).to(device),
           "token_mask": torch.from_numpy(real).to(device),
           "token_lengths": torch.from_numpy(n)}
    frames = p["frames"]
    feats = model["denoiser"]["njoints"] * model["denoiser"]["nfeats"]
    if _ar(cell):
        out["prefix"] = torch.from_numpy(rng.standard_normal(
            (P, B, model["denoiser"]["context_len"], feats)).astype(np.float32)).to(device)
    else:
        lengths = rng.integers(p["lengths"][0], p["lengths"][1] + 1, size=(P, B))
        out["lengths"] = torch.from_numpy(lengths)
        out["frames_mask"] = torch.from_numpy(np.arange(frames)[None, None, :]
                                              < lengths[..., None]).to(device)
    return out


def _ar(cell: dict) -> bool:
    """DiP's chunked generation: the ``generate_ar`` kind."""
    return cell["kind"] == "generate_ar"


def _request_generator(st, i: int) -> torch.Generator:
    """Request i's generator (i = -1: the warm-up's)."""
    return torch.Generator(st.device).manual_seed(sub_seed(st.seed, _REQUEST, i + 1))


def _conditioning(st, j: int, text):
    from mdm_tpu_torch.models.mdm import Conditioning

    x = st.inputs
    if _ar(st.cell):
        return Conditioning(text_embed=text, text_tokens_mask=x["token_mask"][j],
                            prefix=x["prefix"][j])
    return Conditioning(text_embed=text, frames_mask=x["frames_mask"][j])


def _tower_call(st, j: int):
    x = st.inputs
    if st.cell["model"]["text_encoder"]["type"] == "clip":
        return st.tower(x["tokens"][j])
    return st.tower(x["tokens"][j], x["token_mask"][j])


def _recorder(st: State, slot: dict):
    """A forward hook on the denoiser that copies, for the check, the input
    of every forward (the first half of the guidance's double batch) and,
    for DiP, each chunk's prefix into ``slot``'s buffers, made in set-up so
    that the window allocates nothing for them."""
    B, steps = st.cell["params"]["batch"], st.cell["model"]["diffusion"]["diffusion_steps"]
    count = [0]

    def hook(module, args, out):
        k = count[0]
        slot["xs"][k].copy_(args[0][:B])
        if args[2].prefix is not None and k % steps == 0:
            slot["prefixes"][k // steps].copy_(args[2].prefix[:B])
        count[0] += 1

    return st.gen.model.register_forward_hook(hook)


def _slots(st: State) -> list:
    """Buffers for the checked requests' denoiser inputs, one a request."""
    p, den = st.cell["params"], st.cell["model"]["denoiser"]
    steps = st.cell["model"]["diffusion"]["diffusion_steps"]
    feats = den["njoints"] * den["nfeats"]
    chunk = den["pred_len"] if _ar(st.cell) else p["frames"]
    chunks = math.ceil(p["frames"] / chunk)
    empty = lambda *shape: torch.empty(shape, device=st.device)
    return [{"xs": empty(chunks * steps, p["batch"], chunk, feats),
             "prefixes": empty(chunks, p["batch"], den.get("context_len", 0), feats)}
            for _ in range(p["check_requests"])]


def request(st: State, i: int, slot: Optional[dict] = None) -> dict:
    """One request of the window: the features on the device, the joints on
    the host, the tower's output, whether every joint is finite (on the
    device); with a ``slot``, every denoiser input in it."""
    p = st.cell["params"]
    j = i % p["pool"]
    handle = _recorder(st, slot) if slot is not None else None
    try:
        with torch.inference_mode():
            text = _tower_call(st, j)
            res = st.gen.generate(_conditioning(st, j, text), p["batch"], p["frames"],
                                  generator=_request_generator(st, i))
            finite = torch.isfinite(res["joints"]).all()
    finally:
        if handle is not None:
            handle.remove()
    return {**(slot or {}), "features": res["features"], "joints": res["joints"].cpu(),
            "text": text, "finite": finite}


def setup(cell: dict, seed: int, device: str, mark=lambda name: None) -> State:
    from mdm_tpu_torch.diffusion.schedule import Schedule
    from mdm_tpu_torch.models import text_encoders as T
    from mdm_tpu_torch.ops import _build
    from mdm_tpu_torch.sampling.pipeline import GenerationConfig, MotionGenerator

    mark("imports")
    if torch.device(device).type == "cuda":
        _build.load_library()
    mark("kernel library")
    p, model = cell["params"], cell["model"]
    den, tw, dif = model["denoiser"], model["text_encoder"], model["diffusion"]
    mdm = program_mdm(den, cell["dtype"], sub_seed(seed, _W_DEN), device)
    with torch.device(device):
        if tw["type"] == "clip":
            tower = T.ClipTextEncoder(T.ClipTextConfig(**{k: tw[k] for k in (
                "vocab_size", "width", "layers", "heads", "context_length", "embed_dim")}))
        else:
            tower = T.DistilBertEncoder(T.DistilBertConfig(**{k: tw[k] for k in (
                "vocab_size", "dim", "n_layers", "n_heads", "hidden_dim",
                "max_position_embeddings")}))
    mark("modules")
    tower.load_state_dict(make(ref_models.tower_params(tw), sub_seed(seed, _W_TOWER), device),
                          strict=True)
    tower.eval()
    gen = MotionGenerator(mdm, Schedule.create(dif["noise_schedule"], dif["diffusion_steps"]),
                          GenerationConfig(guidance_scale=dif["guidance_param"],
                                           sampler=dif["sampler"],
                                           autoregressive=_ar(cell)))
    mark("weights")
    rng = np.random.default_rng(sub_seed(seed, _SAMPLE))
    keep = {0} | set(rng.choice(p["check_among"], size=p["check_requests"] - 1,
                                replace=False).tolist())
    st = State(cell, seed, device, gen, tower, draw_inputs(cell, seed, device), keep)
    st.slots = _slots(st)
    stack = "seqTransEncoder" if den["arch"] == "trans_enc" else "seqTransDecoder"
    st.spans = [(mdm, "mdm.forward"), (tower, "text_tower.forward")] + [
        (layer, "mdm.layer") for layer in getattr(mdm, stack).layers]
    mark("inputs")
    # warm-up: one request of the cell's own shapes and the window's own
    # count of failures, outside the window
    _failed([~request(st, -1)["finite"]])
    mark("warm-up request")
    return st


def window(st: State, seconds: float, units: Optional[int] = None) -> Records:
    rec = Records(t0=time.perf_counter())
    failed = []
    while True:
        ts = time.perf_counter()
        kept = rec.n in st.keep and len(rec.kept) < len(st.slots)
        out = request(st, rec.n, st.slots[len(rec.kept)] if kept else None)
        te = time.perf_counter()
        rec.latencies.append(te - ts)
        failed.append(~out["finite"])  # read once the window has closed
        if kept:
            rec.kept.append((rec.n, out))
        rec.n += 1
        rec.t1 = te
        if (units is not None and rec.n >= units) or (units is None and te - rec.t0 >= seconds):
            rec.failed = _failed(failed)
            return rec


def _failed(flags: List[torch.Tensor]) -> int:
    """Requests whose joints held a value that is not finite."""
    return int(torch.stack(flags).sum())


def end_to_end(st: State, rec: Records) -> Dict[str, float]:
    return {"motions_per_s": rec.n * st.cell["params"]["batch"] / (rec.t1 - rec.t0)}


def request_work(st: State, j: int) -> flops.Work:
    """The operations and bytes of one request on pool entry j."""
    p, model = st.cell["params"], st.cell["model"]
    den, tw, dif = model["denoiser"], model["text_encoder"], model["diffusion"]
    work = flops.Work()
    ntok = st.inputs["token_lengths"][j].tolist()
    if tw["type"] == "clip":
        flops.clip_forward(work, tw, ntok)
    else:
        flops.distilbert_forward(work, tw, ntok)
    steps = dif["diffusion_steps"]
    if _ar(st.cell):
        chunks = math.ceil(p["frames"] / den["pred_len"])
        rows = [den["context_len"] + den["pred_len"]] * (2 * p["batch"])
        flops.mdm_forward(work, den, st.cell["dtype"], rows, memory_lengths=ntok * 2,
                          times=chunks * steps)
    else:
        rows = [n + 1 for n in st.inputs["lengths"][j].tolist()] * 2  # the condition token
        flops.mdm_forward(work, den, st.cell["dtype"], rows, times=steps)
    return work


def counts(st: State, rec: Records) -> Dict:
    P = st.cell["params"]["pool"]
    work = flops.Work()
    for i in range(rec.n):
        work.merge(request_work(st, i % P))
    return {"phase": PHASE, "units": rec.n, "work": work, "dtype": st.cell["dtype"]}


def release(st: State) -> None:
    st.gen = st.tower = None
    st.spans = []


def reference_params(st: State):
    den, tw = st.cell["model"]["denoiser"], st.cell["model"]["text_encoder"]
    return (make(ref_models.mdm_params(den), sub_seed(st.seed, _W_DEN), st.device),
            make(ref_models.tower_params(tw), sub_seed(st.seed, _W_TOWER), st.device))


def _guided(st: State, j: int, P_den, text, prec: Precision, prefix=None):
    """The reference's guided denoiser (x, step) -> x0_hat for pool entry j."""
    den, x = st.cell["model"]["denoiser"], st.inputs

    def fn(xt, t, drop):
        return ref_models.mdm_forward(
            P_den, den, xt, t, text, prec=prec,
            text_mask=x["token_mask"][j] if den.get("text_tokens") else None,
            frames_mask=None if _ar(st.cell) else x["frames_mask"][j], prefix=prefix,
            cond_drop=torch.full((xt.shape[0],), drop, device=st.device))

    return ref_diffusion.guided(fn, st.cell["model"]["diffusion"]["guidance_param"])


def _joints(st: State, feats):
    mean, std = (torch.from_numpy(np.load(os.path.join(STATS_DIR, f"t2m_{s}.npy"))
                                  .astype(np.float32)).to(st.device) for s in ("mean", "std"))
    return ref_hml.recover_from_ric(feats * std + mean, st.cell["model"]["dataset"]["joints"])


def _tower(st: State, j: int, P_tw, prec: Precision):
    x = st.inputs
    with torch.no_grad(), prec.scope():
        return ref_models.tower_forward(P_tw, st.cell["model"]["text_encoder"], x["tokens"][j],
                                        x["token_mask"][j], prec=prec)


def reference_request(st: State, i: int, prec: Precision, params,
                      tower_prec: Optional[Precision] = None) -> dict:
    """The plain reference put in the program's place for request i: its own
    chain, the denoiser at ``prec`` and the tower at ``tower_prec``, recorded
    as ``request`` records the program's."""
    p, den = st.cell["params"], st.cell["model"]["denoiser"]
    dif = st.cell["model"]["diffusion"]
    P_den, P_tw = params
    j = i % p["pool"]
    g = _request_generator(st, i)
    sched = ref_diffusion.Schedule(dif["diffusion_steps"], st.device)
    text = _tower(st, j, P_tw, tower_prec or prec)
    out = {"xs": [], "prefixes": [], "text": text}
    feats_n = den["njoints"] * den["nfeats"]
    with torch.no_grad(), prec.scope():
        if _ar(st.cell):
            def chunk(noise, prefix):
                out["prefixes"].append(prefix)
                return ref_diffusion.ddpm_sample(_guided(st, j, P_den, text, prec, prefix),
                                                 sched, noise, g, out["xs"])
            feats = ref_diffusion.autoregressive(
                chunk, st.inputs["prefix"][j], math.ceil(p["frames"] / den["pred_len"]),
                den["pred_len"], p["frames"], feats_n, g)
        else:
            noise = torch.randn((p["batch"], p["frames"], feats_n), generator=g, device=st.device)
            feats = ref_diffusion.ddpm_sample(_guided(st, j, P_den, text, prec), sched, noise, g,
                                              out["xs"])
        out.update(features=feats, joints=_joints(st, feats))
    return out


def check_request(st: State, checks: C.Checks, i: int, got: dict, params) -> None:
    """Request i's three numbers, against the float32 reference following
    ``got``'s chain step by step from its own recorded state:

    - ``text_rel``: the tower's output (at the real tokens of a token tower);
    - ``step_rel``: every step of the chain, by the worst motion: the start
      (the first input against the request's noise; for DiP each chunk's
      prefix against the frames before it), and each transition, the
      reference's guided denoiser, posterior mean and noise applied to the
      recorded input, against the next recorded input, or at the last step
      against the features the request returned;
    - ``joints_rel``: the joints returned, by the worst motion, against the
      decoding of the reference's last steps.

    A chain of 50 guided steps amplifies rounding unevenly from prompt to
    prompt, so two whole chains are not compared end to end."""
    p, den = st.cell["params"], st.cell["model"]["denoiser"]
    dif = st.cell["model"]["diffusion"]
    P_den, P_tw = params
    j, dev = i % p["pool"], st.device
    g = _request_generator(st, i)
    sched = ref_diffusion.Schedule(dif["diffusion_steps"], dev)
    text = _tower(st, j, P_tw, Precision("f32"))
    got_text, ref_text = got["text"], text
    if st.cell["model"]["text_encoder"]["type"] != "clip":
        m = st.inputs["token_mask"][j]
        got_text, ref_text = got_text[m], ref_text[m]
    checks.add("text_rel", C.max_rel(got_text, ref_text))
    T, feats_n, F = sched.T, den["njoints"] * den["nfeats"], p["frames"]
    chunk_len = den["pred_len"] if _ar(st.cell) else F
    chunks = math.ceil(F / chunk_len)
    feats = got["features"].float()
    prec = Precision("f32")
    worst, last = 0.0, []
    with torch.no_grad(), prec.scope():
        for c in range(chunks):
            xs = got["xs"][c * T:(c + 1) * T]
            prefix = None
            if _ar(st.cell):
                prefix = got["prefixes"][c]
                want = st.inputs["prefix"][j] if c == 0 else torch.cat(
                    [got["prefixes"][c - 1], feats[:, (c - 1) * chunk_len:c * chunk_len]],
                    dim=1)[:, -den["context_len"]:]
                worst = max(worst, C.worst_rel(prefix, want))
            noise = torch.randn((p["batch"], chunk_len, feats_n), generator=g, device=dev)
            worst = max(worst, C.worst_rel(xs[0], noise))
            model = _guided(st, j, P_den, text, prec, prefix)
            for k, step in enumerate(range(T - 1, -1, -1)):
                x = xs[k].float()
                t = torch.full((x.shape[0],), step, dtype=torch.long, device=dev)
                z = torch.randn(x.shape, generator=g, device=dev)
                nxt = (sched.coef1[step] * model(x, t) + sched.coef2[step] * x
                       + float(step != 0) * torch.exp(0.5 * sched.log_var[step]) * z)
                if k + 1 < T:
                    worst = max(worst, C.worst_rel(xs[k + 1], nxt))
                else:
                    out = feats[:, c * chunk_len:(c + 1) * chunk_len]
                    worst = max(worst, C.worst_rel(out, nxt[:, :out.shape[1]]))
                    last.append(nxt)
        checks.add("step_rel", worst)
        joints = _joints(st, torch.cat(last, dim=1)[:, :F])
    checks.add("joints_rel", C.worst_rel(got["joints"].to(dev), joints))


def check(st: State, rec: Records, limits: Dict[str, float]) -> C.Checks:
    checks = C.Checks(limits)
    params = reference_params(st)
    for i, got in rec.kept:
        check_request(st, checks, i, got, params)
    return checks
