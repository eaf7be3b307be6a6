"""Launch helpers shared by the kernel chains (layer_inference, the
attention modules, encoder_tail): operand preparation, the products of
``csrc/gemm_sm90.cu`` (bf16) and ``csrc/gemm.cu`` (f32) and the column sums
of the latter, the attention core of ``csrc/attention.cu`` and the dropout
arguments of ``csrc/philox.cuh``.

Every helper launches asynchronously on the tensor's current stream,
allocates its outputs with ``torch.empty`` and raises on a nonzero
``cudaError_t`` from the launch. None of them runs on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from . import _build
from .dropout_bits import keep_threshold

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 192, 256)  # the attention tile kernels' instances (padded head dims)
_SMS = 132  # H100 SXM streaming multiprocessors: the split-K target
WGMMA_TILE = (128, 128, 64)  # csrc/gemm_sm90.cu's block tile (rows, columns, K depth)
GEMM_LAUNCHES = {"wgmma": 0, "tf32x3": 0}  # launches per product kernel (see gemm_kernel)
GELU_FORMS = {False: 0, True: 1, "tanh": 2}  # gemm's gelu: none, exact (erf), DiT's tanh form
# The f32 attention tile kernels (csrc/attention_f32.cu): a block of 128
# threads owns 64 rows and streams 32-row tiles; rows of Dh + 4 floats and
# score tiles of 32 + 8. attention_f32_plan models their plan on the CPU;
# on the card attention_f32_plan_on_card reads the kernels' own.
F32_ATTN_TILE = dict(rows=64, cols=32, threads=128, pad=4, score_pad=8)
MAX_SMEM = 232448  # bytes of shared memory an H100 block may take (csrc/attention.cuh)
SM_SMEM = 233472  # an H100 SM's shared memory, 1 KB of it reserved a block


def dev(t: torch.Tensor, dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """Contiguous, 16-byte aligned tensor in dt (t itself when it already
    is: the chains call this on every operand of every launch, so the
    common case costs no torch op)."""
    if (dt is None or t.dtype == dt) and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    t = (t if dt is None else t.to(dt)).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t):
    """The address of a tensor; an int is an address already."""
    return t if t is None or isinstance(t, int) else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of t's card (the accessor
    PyTorch's own generated kernels use: no Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_dtype(x: torch.Tensor, what: str) -> int:
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: kernel dtype must be float32 or bfloat16, got {x.dtype}")
    return DTYPES[x.dtype]


def check_shapes(x: torch.Tensor, operands, what: str) -> None:
    """Raise ValueError unless every (tensor, shape) pair has that shape and
    lies on x's device."""
    for i, (t, shape) in enumerate(operands):
        if t is not None and (tuple(t.shape) != tuple(shape) or t.device != x.device):
            raise ValueError(f"{what} operand {i + 1}: {tuple(t.shape)} on {t.device}, "
                             f"expected {tuple(shape)} on {x.device}")


def dropout_args(bits: Optional[torch.Tensor], seed: int, rate: float, batch_offset: int = 0):
    """(bits, seed, batch offset, threshold, 1/(1-rate), mode) of
    philox.cuh::Dropout: mode 0 draws nothing (rate 0), 1 reads the injected
    uint32 bits, 2 draws in-kernel Philox from the int32 seed, the counter's
    batch word moved by ``batch_offset`` (the global index of row 0)."""
    if rate <= 0.0:
        return None, 0, 0, 0, 1.0, 0
    inv_keep = float(np.float32(1.0 / (1.0 - rate)))
    mode = 2 if bits is None else 1
    seed = (int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31  # the int32 the kernel takes
    return ptr(bits), seed, int(batch_offset), keep_threshold(rate), inv_keep, mode


def split_rows(k: int, splits: int) -> int:
    """K rows per split of a split-K product: ceil(k / splits) in whole
    64-deep K tiles (``gemm`` passes it to csrc/gemm_sm90.cu, which checks it
    and walks the splits by it)."""
    rows, bk = -(-k // splits), WGMMA_TILE[2]
    return -(-rows // bk) * bk


def splits_for(m: int, n: int, k: int) -> int:
    """Fixed split-K count for a weight gradient [m, n] reduced over k rows:
    the fewest splits whose (128x128 tile, split) items fill the persistent
    grid's SMs within 5% of the best count up to 32, each split at least
    512 rows (8 K tiles) deep and none empty. A function of the shape alone,
    so every run sums in the same order."""
    tiles = -(-m // WGMMA_TILE[0]) * -(-n // WGMMA_TILE[1])
    ok = [s for s in range(1, max(1, min(32, k // 512)) + 1)
          if (s - 1) * split_rows(k, s) < k]
    cost = {s: -(-tiles * s // _SMS) / s for s in ok}  # waves per split: K rows per SM / k
    best = min(cost.values())
    return next(s for s in ok if cost[s] <= 1.05 * best)


def gemm_kernel(a: torch.Tensor, b: torch.Tensor, *, a_km: bool = False, b_kn: bool = False,
                bias: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
                out_f32: bool = False, gelu: bool = False, splits: int = 1) -> str:
    """The kernel that runs ``gemm``'s product, by a fixed rule: "wgmma"
    (``csrc/gemm_sm90.cu``) for every bf16 product, "tf32x3"
    (``csrc/gemm.cu``: 3xTF32 on the tensor cores) for every float32 one.

    Raises ValueError on an operand the kernel cannot take, never routing it
    elsewhere: for either kernel split-K into anything but f32 without bias,
    GELU or residual; for "wgmma" a split count that leaves a split empty,
    an N or a stored row of A or B (K, or M and N where stored [K, .]) that
    is not a multiple of 8 (the TMA's 16-byte row strides), an operand that
    is not contiguous or whose base is not 16-byte aligned, A stored [K, M]
    with B a torch weight [N, K], GELU off the x . W^T form and a residual
    off the dY . W form (no instance of those: no caller has them)."""
    M, K = (a.shape[1], a.shape[0]) if a_km else a.shape
    N = b.shape[1] if b_kn else b.shape[0]
    dt = a.dtype
    if dt not in DTYPES or b.dtype != dt or (bias is not None and bias.dtype != dt):
        raise ValueError(f"gemm: operands must share float32 or bfloat16, got {dt}, "
                         f"{b.dtype} and bias {None if bias is None else bias.dtype}")
    if splits != 1:
        if (splits < 1 or not (out_f32 or dt == torch.float32) or bias is not None
                or r is not None or gelu):
            raise ValueError(f"gemm: split-K (splits={splits}) stores f32 partials: f32 out, "
                             f"no bias, GELU or residual")
        if dt != torch.float32 and (splits - 1) * split_rows(K, splits) >= K:
            raise ValueError(f"gemm: {splits} splits of K={K} leave one empty")
    if dt == torch.float32:
        return "tf32x3"
    if a_km and not b_kn:
        raise ValueError("gemm: the wgmma kernel has no A^T . B^T form")
    if gelu and (a_km or b_kn):
        raise ValueError("gemm: the wgmma kernel applies GELU on the x . W^T form only")
    if r is not None and (a_km or not b_kn):
        raise ValueError("gemm: the wgmma kernel adds a residual on the dY . W form only")
    if N % 8 or (M if a_km else K) % 8 or (N if b_kn else K) % 8:
        raise ValueError(f"gemm: the wgmma kernel needs N and the stored rows of A and B "
                         f"multiples of 8, got M={M} N={N} K={K} a_km={a_km} b_kn={b_kn}")
    for name, t in (("a", a), ("b", b), ("bias", bias), ("r", r)):
        if t is not None and (t.data_ptr() % 16 or not t.is_contiguous()):
            raise ValueError(f"gemm: the wgmma kernel needs {name} contiguous and 16-byte "
                             f"aligned (see dev())")
    return "wgmma"


def wgmma_plan(M: int, N: int, K: int, sms: int = _SMS, splits: int = 1) -> dict:
    """csrc/gemm_sm90.cu's schedule of a product: 128x128 output tiles times
    the splits make the items, walked by min(items, sms) persistent blocks,
    each item split_rows / 64 stages deep; waves is items / sms (a whole
    number when the items quantise onto the SMs)."""
    bm, bn, bk = WGMMA_TILE
    row_tiles, col_tiles = -(-M // bm), -(-N // bn)
    tiles = row_tiles * col_tiles
    return dict(row_tiles=row_tiles, col_tiles=col_tiles, tiles=tiles, splits=splits,
                waves=tiles * splits / sms, k_steps=-(-split_rows(K, splits) // bk),
                grid=_wgmma_grid(M, N, sms, splits))


def _wgmma_grid(M: int, N: int, sms: int, splits: int = 1) -> int:
    return min(-(-M // WGMMA_TILE[0]) * -(-N // WGMMA_TILE[1]) * splits, sms)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm(a: torch.Tensor, b: torch.Tensor, *, a_km: bool = False, b_kn: bool = False,
         bias: Optional[torch.Tensor] = None, r: Optional[torch.Tensor] = None,
         out_f32: bool = False, gelu=False, splits: int = 1) -> torch.Tensor:
    """C = act(op(A) . op(B) (+ bias)) (+ r), f32 accumulation, on the
    kernel ``gemm_kernel`` names (one more in its ``GEMM_LAUNCHES``); act is
    the exact GELU when gelu is True, its tanh form when gelu is "tanh"
    (``GELU_FORMS``), else the identity.

    op(A) is A [M, K], or A^T when a_km (A stored [K, M]); op(B) is B^T for
    a torch weight B [N, K], or B itself when b_kn (B stored [K, N]). C is
    f32 when out_f32, else A's dtype. splits > 1 reduces K in that many
    fixed chunks summed in order (no atomics): C must be f32, no bias or r."""
    M, K = (a.shape[1], a.shape[0]) if a_km else (a.shape[0], a.shape[1])
    N = b.shape[1] if b_kn else b.shape[0]
    if (b.shape[0] if b_kn else b.shape[1]) != K:
        raise ValueError(f"gemm: inner dimensions differ, {tuple(a.shape)} and {tuple(b.shape)}")
    act = GELU_FORMS[gelu]
    kernel = gemm_kernel(a, b, a_km=a_km, b_kn=b_kn, bias=bias, r=r, out_f32=out_f32, gelu=gelu,
                         splits=splits)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype, device=a.device)
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    lib = _build.load_library()
    if kernel == "wgmma":
        grid = _wgmma_grid(M, N, _sm_count(a.get_device()), splits)
        _build.check(lib.mdm_gemm_wgmma(ptr(a), ptr(b), ptr(bias), ptr(r), ptr(out), ptr(work),
                                        M, N, K, int(a_km), int(b_kn), int(out_f32), act,
                                        splits, split_rows(K, splits), grid, stream(a)), "gemm")
    else:
        _build.check(lib.mdm_gemm_f32(ptr(a), ptr(b), ptr(bias), ptr(r), ptr(out), ptr(work), M,
                                      N, K, int(a_km), int(b_kn), splits, act, stream(a)),
                     "gemm")
    GEMM_LAUNCHES[kernel] += 1
    return out


def wgmma_occupancy(out_f32: bool, gelu, a_km: bool = False, b_kn: bool = False) -> int:
    """Resident blocks per SM of the wgmma product kernel's instance of the
    form (a_km, b_kn) storing f32 or bf16, with or without GELU (a key of
    ``GELU_FORMS``): cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_gemm_wgmma_occupancy(
        int(a_km), int(b_kn), int(out_f32), GELU_FORMS[gelu], ctypes.addressof(blocks)),
        "gemm occupancy")
    return blocks.value


def bsd_view(S: int, D: int, head_dim: int, ld: Optional[int] = None):
    """(batch, head, row) strides of [B, S, H*Dh] rows of ld elements (D
    unless packed), head h at columns h*Dh (csrc/attention.cu::View)."""
    ld = D if ld is None else ld
    return S * ld, head_dim, ld


def bhsd_view(H: int, S: int, head_dim: int):
    """(batch, head, row) strides of a contiguous [B, H, S, Dh] tensor."""
    return H * S * head_dim, S * head_dim, head_dim


def row_bias_strides(S: int):
    """(batch, head, query row) strides of a key-padding row bias [B, S]."""
    return S, 0, 0


def check_head_dim(D: int, num_heads: int, what: str) -> int:
    """D // num_heads, or ValueError where D does not split into num_heads
    heads. Every head dim runs, at every S: up to 256 in the least of
    HEAD_DIMS that holds it (16-byte row copies where the rows allow them,
    2- or 4-byte ones otherwise), in bf16 (csrc/attention_fwd.cu,
    attention_bwd.cu) and f32 (csrc/attention_f32.cu); above 256 in the wide
    kernels (bf16: csrc/attention_wide.cu; f32: the row kernels of
    csrc/attention.cu). ``attention_f32_plan`` gives the f32 instances."""
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"{what}: d_model {D} is not divisible by {num_heads} heads")
    return D // num_heads


def padded_head_dim(head_dim: int) -> int:
    """The tile instance a head dim runs in: the least of HEAD_DIMS that
    holds it, 0 above 256 (csrc/attention.cuh::padded_head_dim)."""
    return next((d for d in HEAD_DIMS if head_dim <= d), 0)


def f32_blocks_per_sm(nbytes: int) -> int:
    """csrc/attention_f32.cu::blocks_per_sm: blocks of 128 threads taking
    nbytes of shared memory that an SM holds, at most two (the register
    file's room at up to 255 registers a thread), 0 past MAX_SMEM."""
    return 0 if nbytes > MAX_SMEM else min(2, SM_SMEM // (nbytes + 1024))


def attention_f32_plan(head_dim: int) -> dict:
    """csrc/attention_f32.cu's plan for f32 inputs of a head dim: the
    instance ("tiled" up to 256, "wide" above: the row kernels of
    csrc/attention.cu, one block per row, static shared memory), its padded
    head dim, tile sizes, and per kernel (forward, dq, dk/dv) the ring's
    stages (two, unless one stage puts more blocks on an SM by
    f32_blocks_per_sm, or two do not fit) and its shared bytes; dk/dv's
    output column chunks (two above 128, each block recomputing the
    scores)."""
    dh = padded_head_dim(head_dim)
    t = F32_ATTN_TILE
    if not dh:  # AF_CHUNK floats of probabilities (and of dlog), and the reduction's 33
        return dict(instance="wide", padded_head_dim=None, rows=1, threads=128,
                    bytes=dict(fwd=4 * (1024 + 33), dq=4 * (2 * 1024 + 33), dkv=4 * 2 * 1024),
                    stages=None, kv_chunks=1)
    ld = dh + t["pad"]
    own, tile = 4 * t["rows"] * ld, 4 * t["cols"] * ld
    score, stats = 4 * t["rows"] * (t["cols"] + t["score_pad"]), 4 * 3 * t["cols"]
    need = dict(fwd=lambda st: own + st * 2 * tile + score,
                dq=lambda st: 2 * own + st * 2 * tile + score,
                dkv=lambda st: 2 * own + st * (2 * tile + stats) + 2 * score)
    blocks = lambda f, st: f32_blocks_per_sm(f(st))
    stages = {k: 2 if 0 < blocks(f, 2) >= blocks(f, 1) else 1 for k, f in need.items()}
    return dict(instance="tiled", padded_head_dim=dh, rows=t["rows"], cols=t["cols"],
                threads=t["threads"], bytes={k: f(stages[k]) for k, f in need.items()},
                stages=stages, kv_chunks=1 if dh <= 128 else 2)


def attention_f32_plan_on_card(head_dim: int) -> dict:
    """The f32 core's plan as its kernels hold it (mdm_attention_f32_plan):
    ``attention_f32_plan``'s padded head dim, stages, bytes and column
    chunks, and each kernel's resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); above 256 only the
    instance."""
    plan = (ctypes.c_int * 11)()
    _build.check(_build.load_library().mdm_attention_f32_plan(head_dim, ctypes.addressof(plan)),
                 "attention f32 plan")
    if not plan[0]:
        return dict(instance="wide")
    kernels = ("fwd", "dq", "dkv")
    return dict(instance="tiled", padded_head_dim=plan[0],
                stages={k: plan[1 + i] for i, k in enumerate(kernels)},
                bytes={k: plan[4 + i] for i, k in enumerate(kernels)}, kv_chunks=plan[7],
                blocks_per_sm={k: plan[8 + i] for i, k in enumerate(kernels)})


# Per card, the attention core's engagement while a profiler records: an
# int64 [2] of the (query tile, key tile) score tiles its blocks walked and
# of those a full walk would have (csrc/attention.cuh::count_tiles).
_KEY_TILES: dict = {}


def key_tile_counter(x: torch.Tensor):
    """The address of x's card's counter while a torch.profiler records
    (the test of ``utils/tracing.span``), else None: the kernels then
    execute no atomic. A new counter is copied from pinned host memory, so
    making it inside a traced window launches no kernel."""
    if not _profiler._is_profiler_enabled:
        return None
    buf = _KEY_TILES.get(x.device)
    if buf is None:
        zeros = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        buf = _KEY_TILES[x.device] = zeros.to(x.device, non_blocking=True)
    return buf.data_ptr()


def attention_key_tiles():
    """(walked, full): the score tiles the attention core's blocks computed,
    and those a full walk over every key would have, in the launches made
    while a profiler recorded since the last call, summed over the cards;
    then forgets them. Synchronises with each counted card."""
    walked = full = 0
    for buf in _KEY_TILES.values():
        w, f = buf.tolist()
        walked, full = walked + w, full + f
    _KEY_TILES.clear()
    return walked, full


def attention_fwd(q, k, v, view, out, out_view, B: int, S: int, H: int, head_dim: int,
                  bias=None, bias_strides=(0, 0, 0), drop=(None, 0, 0, 0, 1.0, 0)) -> None:
    """out = dropout(softmax(q k^T / sqrt(Dh) + bias)) v per (batch, head)
    (csrc/attention.cu). q, k, v share ``view``, out (f32 or q's dtype) has
    ``out_view``; bias is additive f32 with ``bias_strides`` or None; drop is
    ``dropout_args``'s tuple. k and v may be given as addresses (their
    column blocks in a packed tensor that starts with q)."""
    lib = _build.load_library()
    _build.check(lib.mdm_attention_fwd(ptr(q), ptr(k), ptr(v), *view, ptr(bias), *bias_strides,
                                       *drop, ptr(out), *out_view, DTYPES[out.dtype],
                                       key_tile_counter(q), B, S, H, head_dim,
                                       check_dtype(q, "attention"), stream(q)),
                 "attention forward")


def attention_fwd_occupancy(head_dim: int, out_dtype: torch.dtype, bias_form: int,
                            resident: bool = True) -> int:
    """Resident blocks per SM of ``attention_fwd``'s bf16 kernel storing
    out_dtype, for bias_form 0 (none), 1 (a key-padding row) or 2 (a full
    [S, S] tile), in its resident-row instance (S <= 256) or its two-pass
    one (the only one above head dim 128):
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_attention_fwd_occupancy(
        head_dim, DTYPES[out_dtype], bias_form, int(resident), ctypes.addressof(blocks)),
        "attention occupancy")
    return blocks.value


BWD_KERNELS = ("dq", "dkv")  # the bf16 backward's two kernels, in launch order


def attention_bwd_occupancy(head_dim: int, bias_form: int, kernel: str) -> int:
    """Resident blocks per SM (of 4 warps) of the bf16 backward's ``kernel``
    (one of BWD_KERNELS) for bias_form 0, 1 or 2:
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load_library().mdm_attention_bwd_occupancy(
        head_dim, bias_form, BWD_KERNELS.index(kernel), ctypes.addressof(blocks)),
        "attention backward occupancy")
    return blocks.value


def attention_bwd(q, k, v, view, dout, out_view, dq, dk, dv, B: int, S: int, H: int,
                  head_dim: int, bias=None, bias_strides=(0, 0, 0), drop=(None, 0, 0, 0, 1.0, 0),
                  ctx=None) -> None:
    """dq, dk, dv (q's view and dtype) of ``attention_fwd`` given dout (q's
    dtype, out_view): p recomputed, the bits replayed; the forward's out
    recomputed into ctx when it is given."""
    if not dq.dtype == dk.dtype == dv.dtype == q.dtype:
        raise ValueError(f"attention gradients must be in q's dtype {q.dtype}")
    stats = torch.empty((3, B * H * S), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    _build.check(lib.mdm_attention_bwd(ptr(q), ptr(k), ptr(v), *view, ptr(bias), *bias_strides,
                                       *drop, ptr(dout), ptr(ctx), *out_view, ptr(dq), ptr(dk),
                                       ptr(dv), ptr(stats), key_tile_counter(q), B, S, H,
                                       head_dim, check_dtype(q, "attention"), stream(q)),
                 "attention backward")


def colsum(t: torch.Tensor, chunks: int = 64) -> torch.Tensor:
    """f32 [N] sum over the rows of t [M, N] in a fixed order: row chunks,
    then the chunks' sums in chunk order."""
    M, N = t.shape
    chunks = max(1, min(chunks, M))
    out = torch.empty((N,), dtype=torch.float32, device=t.device)
    work = torch.empty((chunks, N), dtype=torch.float32, device=t.device)
    lib = _build.load_library()
    _build.check(lib.mdm_colsum(ptr(t), ptr(out), ptr(work), M, N, chunks, DTYPES[t.dtype],
                                stream(t)), "colsum")
    return out
