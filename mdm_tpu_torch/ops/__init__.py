"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, and the flags that choose the model's kernel routes.

The kernel choice follows the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises. The flags are the
JAX package's (mdm_tpu/ops/__init__.py:118-248), under the same names: two
opt-in routes, off by default, and four tri-state ones where None is AUTO.
AUTO is on by default: the train block, the sample block and the encoder
tail on, and the whole-layer kernel on whenever the sample block and the
tail are. ``auto_kernels`` binds AUTO for a body, as the JAX package's
``_with_auto_train_block`` / ``_with_auto_sample_block`` do per call: on
for a single device and for data parallelism (each rank runs the kernels
on its rows, as JAX's shard_map does), off for a train step or a
generator on a mesh with a model axis above 1, where the layers take the
einsum attention and the plain tail on the rank's heads and FFN columns
(``mesh_kernels``, which refuses a kernel flag pinned on there). The JAX package's interpret mode has no
counterpart: the CPU runs the plain versions, so no route needs the card
to be taken.

``sharded_rows(b0)`` declares, for its body, that this process holds the
global batch rows from b0: every dropout site then passes b0 as its
``batch_offset``, so a data-parallel rank draws exactly its rows of the
one-process masks (the counterpart of ``shard_seed_offset``).

Beside the modules' launch counts, ``attention_key_tiles()`` reads and
resets the attention core's engagement, counted while a ``torch.profiler``
records: the score tiles its blocks computed, and those a walk over every
key would have (each walk stops at its batch element's last live key).
"""
import contextlib

from ._chain import attention_key_tiles  # noqa: F401  (the attention core's counter)
from ._mask import row_bias_contrib  # noqa: F401
from .attention import fused_attention, xla_attention  # noqa: F401
from .attention_block import attention_block_reference, fused_attention_block  # noqa: F401
from .attention_dropout import (  # noqa: F401
    dropout_attention_bwd_reference,
    dropout_attention_reference,
    fused_dropout_attention,
)
from .attention_train_block import (  # noqa: F401
    fused_block_attention_inference,
    fused_train_attention_block,
    train_attention_block_bwd_reference,
    train_attention_block_reference,
)
from .attention_v2 import attention_v2_reference, fused_attention_v2  # noqa: F401
from .encoder_tail import (  # noqa: F401
    encoder_tail_bwd_reference,
    encoder_tail_reference,
    fused_encoder_tail,
    fused_encoder_tail_inference,
)
from .layer_inference import (  # noqa: F401
    fused_layer_inference,
    layer_inference_reference,
)

# name -> pinned value; None is AUTO for the four tri-state flags.
_FLAGS = {"attention": False, "train_attention": False, "train_block": None,
          "sample_block": None, "encoder_tail": None, "layer_inference": None}
_AUTO = {"kernels": True}  # what AUTO resolves to, set for a body by auto_kernels
_SHARD = {"first_row": 0}  # the global batch row of local row 0, set by sharded_rows


def _auto(name: str) -> bool:
    pinned = _FLAGS[name]
    return _AUTO["kernels"] if pinned is None else pinned


@contextlib.contextmanager
def auto_kernels(enabled: bool):
    """AUTO resolves to ``enabled`` for the body, then to what it was, also
    when the body raises (ADVICE r4: AUTO must not leak past its call)."""
    saved = _AUTO["kernels"]
    _AUTO["kernels"] = bool(enabled)
    try:
        yield
    finally:
        _AUTO["kernels"] = saved


def mesh_kernels(tensor_parallel: bool):
    """AUTO for one call of a train step or a generator on its mesh, as
    the JAX package's ``_with_auto_train_block(..., use_sm)`` binds it: the
    kernels on for one device and data parallelism, off under tensor
    parallelism, where a kernel flag pinned on raises. A fused kernel would
    run one rank's heads or FFN columns as if they were the layer's: it
    draws its dropout from head and column 0 and sums no partial product
    over the model group."""
    if tensor_parallel:
        pinned = sorted(k for k, v in _FLAGS.items() if v)
        if pinned:
            raise ValueError(f"kernel flags {pinned} are pinned on, but a tensor-parallel "
                             "step or sample runs the einsum attention and the plain tail")
    return auto_kernels(not tensor_parallel)


@contextlib.contextmanager
def sharded_rows(first_row: int):
    """For the body, this process holds the global batch rows from
    ``first_row``: every dropout site adds it to its Philox counter's batch
    word (``shard_seed_offset``). Restored on exit, also when the body
    raises; the autograd Functions keep the offset their forward drew
    under, and a rematerialised layer runs inside the body."""
    saved = _SHARD["first_row"]
    _SHARD["first_row"] = int(first_row)
    try:
        yield
    finally:
        _SHARD["first_row"] = saved


def shard_seed_offset() -> int:
    """The batch offset every dropout site passes: the first global row of
    this rank's rows inside ``sharded_rows``, else 0."""
    return _SHARD["first_row"]


def enable_pallas_attention(enabled: bool = True) -> None:
    """Deterministic self-attention through ``fused_attention_v2`` (#11)."""
    _FLAGS["attention"] = enabled


def pallas_attention_enabled() -> bool:
    return _FLAGS["attention"]


def enable_pallas_train_attention(enabled: bool = True) -> None:
    """Training self-attention through ``fused_dropout_attention`` (#7/#8),
    the projections outside the kernel."""
    _FLAGS["train_attention"] = enabled


def pallas_train_attention_enabled() -> bool:
    return _FLAGS["train_attention"]


def enable_pallas_train_block(enabled=True) -> None:
    """Training self-attention as the whole train block (#2/#3); it comes
    before the dropout kernel when both are on. None restores AUTO (on)."""
    _FLAGS["train_block"] = enabled


def pallas_train_block_enabled() -> bool:
    return _auto("train_block")


def enable_pallas_sample_block(enabled=True) -> None:
    """Deterministic self-attention as the rate-0 block (#2's
    ``fused_block_attention_inference``). None restores AUTO (on)."""
    _FLAGS["sample_block"] = enabled


def pallas_sample_block_enabled() -> bool:
    return _auto("sample_block")


def enable_pallas_encoder_tail(enabled=True) -> None:
    """The layer tail through ``fused_encoder_tail`` (#4/#5) when training,
    ``fused_encoder_tail_inference`` when deterministic. None restores AUTO
    (on)."""
    _FLAGS["encoder_tail"] = enabled


def pallas_encoder_tail_enabled(deterministic: bool) -> bool:
    """Whether the layer tail runs the fused tail. ``deterministic`` is not
    read: it keeps the JAX signature, whose AUTO tells sampling from
    training. The port's AUTO is one decision for both, bound by
    ``auto_kernels``: on for one device and data parallelism, off under
    tensor parallelism."""
    return _auto("encoder_tail")


def enable_pallas_layer_inference(enabled=True) -> None:
    """Deterministic encoder layers through ``fused_layer_inference`` (#1).
    None restores AUTO: on whenever the sample block and the tail are."""
    _FLAGS["layer_inference"] = enabled


def pallas_layer_inference_enabled() -> bool:
    if _FLAGS["layer_inference"] is None:
        return pallas_sample_block_enabled() and pallas_encoder_tail_enabled(True)
    return _FLAGS["layer_inference"]


@contextlib.contextmanager
def pinned(**flags):
    """Pin flags by name (``attention``, ``train_attention``, ``train_block``,
    ``sample_block``, ``encoder_tail``, ``layer_inference``) for the body,
    then restore every flag as it was, also when the body raises."""
    unknown = set(flags) - set(_FLAGS)
    if unknown:
        raise ValueError(f"unknown kernel flags {sorted(unknown)}; known: {sorted(_FLAGS)}")
    saved = dict(_FLAGS)
    _FLAGS.update(flags)
    try:
        yield
    finally:
        _FLAGS.clear()
        _FLAGS.update(saved)
