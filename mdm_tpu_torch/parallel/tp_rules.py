"""Tensor-parallel partition rules for MDM parameters, and the sharded model.

Counterpart of mdm_tpu/parallel/tp_rules.py (:27-69) on the port's names
and layouts: Megatron column/row splits over the mesh's 'model' axis.
``nn.Linear.weight`` is [out, in], the transpose of flax's kernel, so a
column-parallel kernel (flax ``P(None, 'model')``) splits the weight's
dim 0 and a row-parallel one (``P('model', None)``) its dim 1.

- attention q/k/v: column-parallel by heads. They live packed in
  ``in_proj_weight`` [3D, D] / ``in_proj_bias`` [3D], so each of the three
  D-row blocks splits into the model axis's parts (``Split(0, packs=3)``);
- attention ``out_proj.weight``: row-parallel (dim 1); its bias replicated;
- FFN ``linear1``: column-parallel (weight and bias, dim 0); ``linear2``
  row-parallel (dim 1); CLIP's ``c_fc`` / ``c_proj`` alike;
- everything else (embeddings, norms, small heads, the GRU): replicated.

``shard_model_`` keeps each rank's part of every split leaf, gives each
attention its local heads and each layer its FFN columns, with their
global offsets (the dropout sites' Philox words) and the mesh's model
group. The layers then run Megatron's conjugate collectives over it
(models/layers.py: *f* before a column-parallel product, *g* summing a
row-parallel one) and take the attention's einsum route and the plain
tail on the rank's heads and FFN columns: mdm_tpu's XLA path on a TP
mesh. The hand kernels that fuse a whole attention or tail do not run
under TP (``ops.mesh_kernels``); the dropout dumps #6 and #9 do, at the
rank's offsets.

Training (mdm_tpu's ``state_shardings`` / ``shard_state``, :71-103):
``shard_state_`` splits a one-process train state in place, AdamW's
moments and the EMA exactly like their parameters (``state_splits``), and
records the layout on the state (``TPLayout``), which the step's norms
read; ``gather_state`` is its inverse, the one-process state dict, and
``local_state_dict`` takes this rank's part of one.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn


class Split(NamedTuple):
    """Split ``dim`` into the model axis's parts; with ``packs`` > 1 the
    dim holds that many equal blocks (q, k, v), each split the same way."""

    dim: int
    packs: int = 1


_ATTN = r".*(self_attn|multihead_attn|attn)"
# (name regex, split) in mdm_tpu's rule order
TP_RULES = [
    (_ATTN + r"\.in_proj_weight$", Split(0, 3)),
    (_ATTN + r"\.in_proj_bias$", Split(0, 3)),
    (_ATTN + r"\.out_proj\.weight$", Split(1)),
    (r".*\.linear1\.weight$", Split(0)),
    (r".*\.linear1\.bias$", Split(0)),
    (r".*\.linear2\.weight$", Split(1)),
    (r".*\.c_fc\.weight$", Split(0)),
    (r".*\.c_fc\.bias$", Split(0)),
    (r".*\.c_proj\.weight$", Split(1)),
]


def spec_for_param(name: str, ndim: int) -> Optional[Split]:
    """The split of the parameter ``name`` (a state_dict key), or None for
    a replicated one; a leaf with too few dims for its rule stays
    replicated."""
    for pattern, split in TP_RULES:
        if re.match(pattern, name):
            if split.dim < ndim:
                return split
    return None


def shard_tensor(t: torch.Tensor, split: Optional[Split], parts: int, index: int
                 ) -> torch.Tensor:
    """Part ``index`` of ``parts`` of t under ``split`` (t itself when None)."""
    if split is None:
        return t
    if t.shape[split.dim] % (split.packs * parts):
        raise ValueError(f"dim {split.dim} of {tuple(t.shape)} does not split into "
                         f"{split.packs} x {parts} parts")
    blocks = t.chunk(split.packs, dim=split.dim)
    return torch.cat([b.chunk(parts, dim=split.dim)[index] for b in blocks], dim=split.dim)


@torch.no_grad()
def shard_model_(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's part of every split parameter of ``model`` (in
    place: each parameter stays the same object, so an optimizer built on
    it keeps it), give each attention its local heads and the global index
    of its first (``head_offset``), each encoder and decoder layer the
    global index of its first FFN column (``ffn_offset``), and both the
    mesh's model group (``tp_group``). A mesh whose model axis is 1 leaves
    the model as it is."""
    from ..models.layers import (MultiHeadAttention, TransformerDecoderLayer,
                                 TransformerEncoderLayer)

    parts, index = mesh.model_parallel, mesh.model_index
    if parts == 1:
        return model
    attentions = [(n, m) for n, m in model.named_modules() if isinstance(m, MultiHeadAttention)]
    for name, m in attentions:
        if m.num_heads % parts:
            raise ValueError(f"{name}: {m.num_heads} heads do not split over "
                             f"{parts} model-parallel ranks")
    for name, p in model.named_parameters():
        split = spec_for_param(name, p.dim())
        if split is not None:
            p.data = shard_tensor(p.data, split, parts, index).contiguous()
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape
        if isinstance(m, MultiHeadAttention):
            m.num_heads //= parts
            m.head_offset = index * m.num_heads
            m.tp_group = mesh.model_group
        if isinstance(m, (TransformerEncoderLayer, TransformerDecoderLayer)):
            m.ffn_offset = index * m.linear1.weight.shape[0]  # its local FFN width
            m.tp_group = mesh.model_group
        if hasattr(m, "_cast"):
            m._cast = None  # a cached cast of the whole weights
    return model


@dataclass(frozen=True)
class TPLayout:
    """How a train state is split over a mesh's model axis
    (``shard_state_``): each parameter's split by name, None where every
    rank holds it whole; its AdamW moments and its EMA share it."""

    mesh: object
    splits: Dict[str, Optional[Split]]

    def is_split(self, names) -> List[bool]:
        return [self.splits[n] is not None for n in names]


def state_splits(state) -> Dict[str, Optional[Split]]:
    """Parameter name -> its split (None: replicated) for the parameters
    of a one-process train state, and with them AdamW's ``exp_avg`` /
    ``exp_avg_sq`` and the EMA of each: mdm_tpu's ``state_shardings``,
    whose moments and EMA mirror the parameter rules."""
    return {n: spec_for_param(n, p.dim()) for n, p in state.model.named_parameters()}


@torch.no_grad()
def shard_state_(state, mesh):
    """Split a one-process train state over ``mesh``'s model axis in place
    (mdm_tpu's ``shard_state``): the model as ``shard_model_`` splits it,
    then each parameter's AdamW moments and EMA exactly like the parameter,
    the packed q/k/v blocks too; the layout goes to ``state.tp``. Every rank
    of a model group calls it on the same whole state (``multihost.replicate``
    first). A mesh whose model axis is 1 leaves the state as it is. Returns
    the state."""
    if mesh.model_parallel == 1:
        return state
    if state.tp is not None:
        raise ValueError("shard_state_: the state is split already")
    splits = state_splits(state)
    part = lambda t, name: shard_tensor(t, splits[name], mesh.model_parallel,
                                        mesh.model_index).contiguous()
    shard_model_(state.model, mesh)
    if state.ema_params is not None:
        state.ema_params = {n: part(t, n) for n, t in state.ema_params.items()}
    for name, p in state.model.named_parameters():
        moments = state.optimizer.state.get(p, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in moments:
                moments[k] = part(moments[k], name)
    state.tp = TPLayout(mesh, splits)
    return state


def _place(part: torch.Tensor, split: Split, parts: int, index: int) -> torch.Tensor:
    """A whole tensor of -0.0 holding ``part`` at rank ``index``'s place."""
    shape = list(part.shape)
    shape[split.dim] *= parts
    whole = torch.full(shape, -0.0, dtype=torch.float32, device=part.device)
    for block, mine in zip(whole.chunk(split.packs, dim=split.dim),
                           part.chunk(split.packs, dim=split.dim)):
        block.chunk(parts, dim=split.dim)[index].copy_(mine)
    return whole


def gather_tensors(parts: List[torch.Tensor], splits: List[Optional[Split]], mesh
                   ) -> List[torch.Tensor]:
    """The whole tensors of this rank's ``parts`` of leaves split over the
    mesh's model axis, the packed blocks back in q, k, v order; a part
    whose split is None is returned as it is. One all-reduce over the model
    group of every split part written into its place in a tensor of -0.0:
    an exact gather (x + -0.0 is x, signed zeros included) that gloo's CUDA
    tensors also take. Every rank of the group calls it with the same
    leaves; each gets the whole tensors."""
    import torch.distributed as dist

    out = list(parts)
    todo = [i for i, s in enumerate(splits) if s is not None]
    if not todo:
        return out
    for i in todo:
        if parts[i].dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"gather_tensors takes f32, bf16 and f16 leaves, not {parts[i].dtype}")
    wholes = [_place(parts[i], splits[i], mesh.model_parallel, mesh.model_index) for i in todo]
    flat = torch.cat([w.reshape(-1) for w in wholes])
    dist.all_reduce(flat, group=mesh.model_group)
    offset = 0
    for i, w in zip(todo, wholes):
        out[i] = flat[offset:offset + w.numel()].view(w.shape).to(parts[i].dtype)
        offset += w.numel()
    return out


def _map_split_leaves(sd: dict, state, fn) -> dict:
    """``sd`` (a state dict of ``state``'s layout) with ``fn(tensors,
    splits)`` applied to every parameter, EMA and AdamW moment in one call,
    and the rest as it is. AdamW's state dict indexes its moments by the
    parameters' order."""
    splits, names = state.tp.splits, [n for n, _ in state.model.named_parameters()]
    slots = [("model", n) for n in names]
    if sd.get("ema_params") is not None:
        slots += [("ema_params", n) for n in names]
    moments = sd["optimizer"]["state"]
    slots += [("optimizer", i, k) for i in sorted(moments) for k in ("exp_avg", "exp_avg_sq")
              if k in moments[i]]

    def leaf_of(slot):
        if slot[0] == "optimizer":
            return moments[slot[1]][slot[2]], splits[names[slot[1]]]
        return sd[slot[0]][slot[1]], splits[slot[1]]

    leaves = [leaf_of(s) for s in slots]
    mapped = fn([t for t, _ in leaves], [sp for _, sp in leaves])
    out = dict(sd, model=dict(sd["model"]),
               optimizer=dict(sd["optimizer"], state={i: dict(v) for i, v in moments.items()}))
    if sd.get("ema_params") is not None:
        out["ema_params"] = dict(sd["ema_params"])
    for slot, t in zip(slots, mapped):
        if slot[0] == "optimizer":
            out["optimizer"]["state"][slot[1]][slot[2]] = t
        else:
            out[slot[0]][slot[1]] = t
    return out


def gather_state(state) -> dict:
    """The state dict a one-process run of a tensor-parallel ``state``
    would hold (``TrainState.state_dict``'s layout): its parameters, EMA
    and AdamW moments gathered over the model group. A collective every
    rank of the group calls; a state that is not split gives its own."""
    sd = state.state_dict()
    if state.tp is None:
        return sd
    return _map_split_leaves(sd, state, lambda ts, sp: gather_tensors(ts, sp, state.tp.mesh))


def local_state_dict(sd: dict, state) -> dict:
    """This rank's part of a one-process state dict ``sd`` (a checkpoint)
    for the tensor-parallel ``state``: ``gather_state``'s inverse."""
    mesh = state.tp.mesh
    return _map_split_leaves(sd, state, lambda ts, sp: [
        shard_tensor(t, s, mesh.model_parallel, mesh.model_index).contiguous()
        for t, s in zip(ts, sp)])
