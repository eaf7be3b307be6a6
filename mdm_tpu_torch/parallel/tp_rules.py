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

``shard_model_`` keeps each rank's part of every split leaf and gives
each attention its local heads. A row-parallel product sums the ranks'
partial products over the model group before its bias, which is added
once (layers.py's ``_dense``); sampling has no backward, so the
collectives are forward-only. The layers then take the attention's einsum
route and the plain tail on the rank's heads and FFN columns: exactly
mdm_tpu's XLA path on a TP mesh; no hand kernel runs under TP.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

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
ROW_PARALLEL = (r".*\.out_proj$", r".*\.linear2$", r".*\.c_proj$")  # modules whose sum is reduced


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
    place), give each attention its local heads, and mark the row-parallel
    modules with the mesh's model group. A mesh whose model axis is 1
    leaves the model as it is."""
    from ..models.layers import MultiHeadAttention

    parts = mesh.model_parallel
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
            p.data = shard_tensor(p.data, split, parts, mesh.model_index).contiguous()
    for _, m in attentions:
        m.num_heads //= parts
    for name, m in model.named_modules():
        if any(re.match(pattern, name) for pattern in ROW_PARALLEL):
            m.tp_group = mesh.model_group
        if hasattr(m, "_cast"):
            m._cast = None  # a cached cast of the whole weights
    return model
