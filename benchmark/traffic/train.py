"""MDM training steps, back to back, as ``cli.train`` runs them.

A step is the program's ``make_train_step`` on one batch of ``batch``
HumanML3D-shaped examples: normalized features drawn from N(0, 1) over a
motion length drawn from ``lengths`` and zero past it (the loader's
padding), the frames mask, and a pooled text embedding drawn from the
seed (the frozen tower runs in the loader, outside the step). Batches come
from a pool of ``pool`` made on the device in set-up; step i takes
``pool[i % pool]`` and the integer key ``step_key(seed, i)``, from which
the program draws t, the noise, the condition dropout and every dropout
mask. AdamW and the EMA update the state in place.

Set-up warms up every shape on a train state of its own, built from the
seed and driven through the first ``checked_steps`` steps, and throws it
away. It then builds the one train state that the window drives, again
from the seed, and buffers for what the check reads. The window's own
first ``checked_steps`` steps are the ones checked: after the first, AdamW's
first moment is copied into the buffers, after the last the parameters
and the EMA, before the next step moves them. ``check(...)`` follows
those steps with the plain reference: each step's loss, the first
gradient as AdamW holds it after one step (its first moment over
1 - beta1) by its norm and by its difference, and the parameters' change
after the last of them, by the worst leaf, and the EMA's, by the median
leaf.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from benchmark.counts import flops
from benchmark.harness import checks as C
from benchmark.harness.weights import make, program_mdm, sub_seed
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference import models as ref_models
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision

PHASE = "train"
_W_DEN, _INPUTS, _STEPS = 1, 3, 6
BETA1 = 0.9


@dataclass
class State:
    cell: dict
    seed: int
    device: str
    state: object
    step: object
    pool: Dict[str, torch.Tensor]
    names: Dict[str, torch.Tensor] = field(default_factory=dict)  # name -> parameter
    record: Dict[str, Dict[str, torch.Tensor]] = field(default_factory=dict)
    next_step: int = 0
    losses: List[torch.Tensor] = field(default_factory=list)
    spans: list = field(default_factory=list)


@dataclass
class Records:
    n: int = 0
    t0: float = 0.0
    t1: float = 0.0
    failed: int = 0


def draw_pool(cell: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    p, den = cell["params"], cell["model"]["denoiser"]
    gen = torch.Generator(device).manual_seed(sub_seed(seed, _INPUTS))
    P, B, T = p["pool"], p["batch"], p["frames"]
    feats = den["njoints"] * den["nfeats"]
    lo, hi = p["lengths"]
    lengths = torch.randint(lo, hi + 1, (P, B), generator=gen, device=device)
    mask = torch.arange(T, device=device)[None, None, :] < lengths[..., None]
    x = torch.randn((P, B, T, feats), generator=gen, device=device) * mask[..., None]
    text = torch.randn((P, B, den["text_dim"]), generator=gen, device=device)
    return {"x": x, "mask": mask, "text": text, "lengths": lengths.cpu()}


def _key(st: State, i: int) -> int:
    return ref_train.step_key(sub_seed(st.seed, _STEPS), i)


def batch(st: State, i: int) -> dict:
    from mdm_tpu_torch.models.mdm import Conditioning

    j = i % st.cell["params"]["pool"]
    return {"x": st.pool["x"][j], "mask": st.pool["mask"][j],
            "cond": Conditioning(text_embed=st.pool["text"][j])}


def train_step(st: State) -> None:
    """One step of the window's own call and feed; the checked steps also
    copy what the check reads into the buffers made in set-up."""
    i = st.next_step
    _, metrics = st.step(st.state, batch(st, i), _key(st, i))
    st.losses.append(metrics["loss"])
    st.next_step += 1
    if i == 0:
        opt, rec = st.state.optimizer.state, st.record["moment"]
        moments = [(rec[n], opt.get(p, {}).get("exp_avg")) for n, p in st.names.items()]
        _copy([(d, m) for d, m in moments if m is not None])
        # no moment: the optimizer got no gradient, as a step that leaves
        # the state unchanged gives it none
        unmoved = [d for d, m in moments if m is None]
        if unmoved:
            torch._foreach_zero_(unmoved)
    if i == st.cell["params"]["checked_steps"] - 1:
        _copy([(st.record["params"][n], p.detach()) for n, p in st.names.items()])
        _copy([(st.record["ema"][n], st.state.ema_params[n]) for n in st.names])


def _copy(pairs) -> None:
    """(destination, source) pairs in one foreach copy: few launches in the
    window."""
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _optim(cell: dict):
    from mdm_tpu_torch.train.state import OptimConfig

    p = cell["params"]
    return OptimConfig(lr=p["lr"], weight_decay=p["weight_decay"], ema_decay=p["ema_decay"],
                       use_ema=True)


def _train_state(cell: dict, seed: int, device: str, pool) -> State:
    """A train state built from the seed, with its step and the buffers
    for the checked steps."""
    from mdm_tpu_torch.diffusion.schedule import Schedule
    from mdm_tpu_torch.train.state import create_train_state
    from mdm_tpu_torch.train.train_step import TrainStepConfig, make_train_step

    den, dif = cell["model"]["denoiser"], cell["model"]["diffusion"]
    mdm = program_mdm(den, cell["dtype"], sub_seed(seed, _W_DEN), device).train()
    state = create_train_state(mdm, _optim(cell))
    step = make_train_step(Schedule.create(dif["noise_schedule"], dif["diffusion_steps"],
                                           device=device),
                           TrainStepConfig(cond_mask_prob=dif["cond_mask_prob"]))
    st = State(cell, seed, device, state, step, pool, names=dict(mdm.named_parameters()))
    st.record = {k: {n: torch.empty_like(p) for n, p in st.names.items()}
                 for k in ("moment", "params", "ema")}
    stack = "seqTransEncoder" if den["arch"] == "trans_enc" else "seqTransDecoder"
    st.spans = [(mdm, "mdm.forward")] + [(layer, "mdm.layer")
                                         for layer in getattr(mdm, stack).layers]
    return st


def setup(cell: dict, seed: int, device: str, mark=lambda name: None) -> State:
    from mdm_tpu_torch.ops import _build

    mark("imports")
    if torch.device(device).type == "cuda":
        _build.load_library()
    mark("kernel library")
    pool = draw_pool(cell, seed, device)
    warm = _train_state(cell, seed, device, pool)
    mark("warm-up state")
    # every shape of the window, its records and its count of failures,
    # on a state that is then thrown away
    for _ in range(cell["params"]["checked_steps"]):
        train_step(warm)
    _failed(warm.losses)
    del warm
    mark("warm-up steps")
    st = _train_state(cell, seed, device, pool)
    mark("train state")
    return st


def window(st: State, seconds: float, units: Optional[int] = None) -> Records:
    rec = Records()
    sync = torch.device(st.device).type == "cuda"
    start = len(st.losses)
    rec.t0 = time.perf_counter()
    checked = st.cell["params"]["checked_steps"]
    while True:
        train_step(st)
        rec.n += 1
        done = rec.n >= units if units is not None else time.perf_counter() - rec.t0 >= seconds
        if done and st.next_step >= checked:  # the window holds every checked step
            break
    if sync:
        torch.cuda.synchronize()
    rec.t1 = time.perf_counter()
    rec.failed = _failed(st.losses[start:])
    return rec


def _failed(losses: List[torch.Tensor]) -> int:
    """Steps whose loss is not finite."""
    return int((~torch.isfinite(torch.stack(losses))).sum())


def end_to_end(st: State, rec: Records) -> Dict[str, float]:
    return {"train_samples_per_s": rec.n * st.cell["params"]["batch"] / (rec.t1 - rec.t0)}


def step_work(st: State, j: int) -> flops.Work:
    den = st.cell["model"]["denoiser"]
    rows = [n + 1 for n in st.pool["lengths"][j].tolist()]  # the condition token
    return flops.mdm_forward(flops.Work(), den, st.cell["dtype"], rows, train=True)


def counts(st: State, rec: Records) -> Dict:
    P = st.cell["params"]["pool"]
    first = st.next_step - rec.n
    work = flops.Work()
    for i in range(first, st.next_step):
        work.merge(step_work(st, i % P))
    return {"phase": PHASE, "units": rec.n, "work": work, "dtype": st.cell["dtype"]}


def release(st: State) -> None:
    st.state = st.step = None
    st.names, st.spans = {}, []


def recorded(st: State) -> dict:
    """What the program's checked steps produced, as ``compare`` reads it."""
    checked = st.cell["params"]["checked_steps"]
    return {"loss": st.losses[:checked],
            "grad": {n: m / (1.0 - BETA1) for n, m in st.record["moment"].items()},
            "params": st.record["params"], "ema": st.record["ema"]}


def reference_steps(st: State, prec: Precision, loss_rows: Optional[slice] = None):
    """The plain reference's first steps from the seed's weights: (losses,
    the first step's gradients, the parameters and the EMA after the last
    step, the starting parameters). ``loss_rows``: the examples the loss
    averages over (all of them, but for a planted fault)."""
    p, den, dif = st.cell["params"], st.cell["model"]["denoiser"], st.cell["model"]["diffusion"]
    P0 = make(ref_models.mdm_params(den), sub_seed(st.seed, _W_DEN), st.device)
    opt = ref_train.AdamW(P0, p["lr"], p["weight_decay"], ema_decay=p["ema_decay"])
    sched = ref_diffusion.Schedule(dif["diffusion_steps"], st.device)
    losses, first_grads = [], None
    for k in range(p["checked_steps"]):
        b = batch(st, k)
        loss, grads = ref_train.loss_and_grads(
            opt.P, den, sched, {"x": b["x"], "mask": b["mask"], "text": b["cond"].text_embed},
            _key(st, k), dif["cond_mask_prob"], prec, loss_rows)
        losses.append(float(loss))
        if k == 0:
            first_grads = grads
        opt.update(grads)
    return losses, first_grads, opt.P, opt.ema, P0


def compare(st: State, checks: C.Checks, got: dict, want) -> None:
    losses, grads, params, ema, P0 = want
    checks.add("loss_gap", max(abs(float(a) - b) / abs(b) for a, b in zip(got["loss"], losses)))
    ref_g = C.norms(grads)
    keep = C.moving_leaves(ref_g)
    checks.add("grad_gap", C.leaf_gap(C.norms(got["grad"]), ref_g))
    checks.add("grad_diff", C.leaf_diff(got["grad"], grads))
    delta = lambda d: {n: d[n] - P0[n] for n in P0}
    checks.add("change_gap", C.leaf_gap(C.norms(delta(got["params"])), C.norms(delta(params)),
                                        keep))
    checks.add("ema_gap", C.median_leaf_gap(C.norms(delta(got["ema"])), C.norms(delta(ema)),
                                            keep))


def check(st: State, rec: Records, limits: Dict[str, float]) -> C.Checks:
    checks = C.Checks(limits)
    compare(st, checks, recorded(st), reference_steps(st, Precision("f32")))
    return checks
