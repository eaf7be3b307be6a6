"""Dataset dispatch + batching iterator (reference data_loaders/get_data.py).

Counterpart of mdm_tpu/data/loader.py. ``get_dataset_loader(name,
batch_size, num_frames, ...)`` returns a ``BatchIterator`` that yields
fixed-shape numpy batches, each a pure function of (seed, epoch,
position), so both packages draw the same batches bit for bit. A
background thread builds the next batch while the device runs the step
(the reference's 8 torch DataLoader workers); ``cache_device_batches``
keeps the first batches on the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .a2m import A2MConfig, HumanAct12, UESTC
from .collate import collate_batch, collate_prefix
from .humanml import HumanMLDataset, HumanMLOptions


def get_dataset(
    name: str,
    num_frames: int = 196,
    split: str = "train",
    hml_mode: str = "train",
    data_root: Optional[str] = None,
    fixed_len: int = 0,
    **kwargs,
):
    if name in ("humanml", "kit"):
        opt = HumanMLOptions.for_dataset(
            name, data_root,
            max_motion_length=num_frames, fixed_len=fixed_len,
            **{k: v for k, v in kwargs.items() if k in HumanMLOptions.__dataclass_fields__},
        )
        return HumanMLDataset(opt, split=split, mode=hml_mode)
    cfg = A2MConfig(num_frames=num_frames, pose_rep=kwargs.get("pose_rep", "rot6d"))
    if name == "humanact12":
        return HumanAct12(cfg, datapath=data_root or "dataset/HumanAct12Poses", split=split)
    if name == "uestc":
        return UESTC(cfg, datapath=data_root or "dataset/uestc", split=split)
    raise ValueError(f"unknown dataset {name!r}")


class BatchIterator:
    """Infinite (train) or epoch (eval) iterator of collated batches.

    Every batch is a PURE FUNCTION of (seed, epoch, position): epoch shuffles
    and per-batch augmentation rngs are derived from SeedSequence tuples, not
    a shared mutable stream. That makes `iter_from(step)` an O(1)
    fast-forward, which is what gives training bit-deterministic resume
    (train N steps == train k, checkpoint, resume, train N-k). The reference
    has no such property — its DataLoader workers and global torch seed make
    resumed runs drift (training_loop.py:385-397 restores only weights).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        infinite: bool = True,
        pred_len: int = 0,
        prefetch: int = 2,
        workers: int = 0,
        text_embedder: Optional[Callable] = None,
        shard: Optional[tuple] = None,
        host_transform: Optional[Callable] = None,
    ):
        """shard=(rank, world): multi-process input sharding — this iterator
        yields only rows [rank*B/world, (rank+1)*B/world) of each GLOBAL
        batch. All processes derive the identical global order (batches are
        pure functions of (seed, epoch, position)), so the ranks' local
        batches are the global batch's rows with no coordination.

        host_transform: applied to each finished batch in the thread that
        built it (the prefetch thread), e.g. ``pin_batch`` so that the
        copy to the card can be non-blocking."""
        if shard is not None:
            rank, world = shard
            if batch_size % world != 0:
                raise ValueError(
                    f"global batch {batch_size} not divisible by world {world}"
                )
            if not 0 <= rank < world:
                raise ValueError(f"shard rank {rank} outside world {world}")
            if not drop_last:
                # A short final chunk cannot be row-sliced into equal
                # per-process shards (and _batch_at would index past it).
                raise ValueError("shard requires drop_last=True")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.infinite = infinite
        self.pred_len = pred_len
        self.seed = seed
        self.prefetch = prefetch
        # workers > 0: batches are built by a thread pool (numpy releases the
        # GIL on the memcpy/normalize hot path). Safe and ORDER-PRESERVING
        # precisely because each batch is a pure function of its position —
        # the reference's worker processes have no such guarantee.
        self.workers = workers
        self.text_embedder = text_embedder
        self.host_transform = host_transform
        self._embed_lock = threading.Lock()

    def _epoch_chunks(self, epoch: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, 0, epoch)).shuffle(idx)
        chunks = []
        for start in range(0, len(idx), self.batch_size):
            chunk = idx[start : start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                # A dataset smaller than one batch would otherwise yield
                # nothing forever; repeat-fill instead (t2m_collate
                # semantics) so tiny datasets still train.
                if len(idx) >= self.batch_size:
                    continue
                reps = -(-self.batch_size // len(chunk))
                chunk = np.tile(chunk, reps)[: self.batch_size]
            chunks.append(chunk)
        return chunks

    def _make_batch(self, indices, rng, rows=None, target_batch_size=None):
        # Per-sample augmentation substreams (spawned, so row r's draws are
        # independent of rows 0..r-1): this is what makes multi-host shards
        # bit-equal to the corresponding rows of the unsharded batch
        # (child i of rng.spawn(n) is the same regardless of n, so spawning
        # over the GLOBAL row count and slicing `rows` matches exactly).
        subs = rng.spawn(len(indices))
        if rows is None:
            rows = range(len(indices))
        samples = [self.dataset.sample(int(indices[r]), subs[r]) for r in rows]
        if self.pred_len > 0:
            batch = collate_prefix(samples, self.pred_len)
        else:
            batch = collate_batch(
                samples,
                target_batch_size=target_batch_size or self.batch_size,
            )
        if self.text_embedder is not None and "text" in batch:
            # Embedders may dispatch device work; keep those calls serial
            # even when worker threads build batches.
            with self._embed_lock:
                batch.update(self.text_embedder(batch["text"]))
        if self.host_transform is not None:
            batch = self.host_transform(batch)
        return batch

    def _batch_at(self, epoch: int, pos: int, chunk) -> Dict:
        rng = np.random.default_rng((self.seed, 1, epoch, pos))
        if self.shard is None:
            return self._make_batch(chunk, rng)
        # Multi-host: build the FULL global batch's sample list only for the
        # local row range (same spawn order as unsharded).
        rank, world = self.shard
        local = self.batch_size // world
        return self._make_batch(
            chunk, rng,
            rows=range(rank * local, (rank + 1) * local),
            target_batch_size=local,
        )

    def batches_per_epoch(self) -> int:
        return len(self._epoch_chunks(0))

    def _positions(self, start_step: int):
        """(epoch, pos, chunk) schedule starting at `start_step`."""
        per_epoch = self.batches_per_epoch()
        epoch, pos = divmod(start_step, max(per_epoch, 1))
        while True:
            chunks = self._epoch_chunks(epoch)
            for i in range(pos, len(chunks)):
                yield epoch, i, chunks[i]
            pos = 0
            epoch += 1
            if not self.infinite:
                return

    def _gen(self, start_step: int = 0) -> Iterator[Dict]:
        for epoch, i, chunk in self._positions(start_step):
            yield self._batch_at(epoch, i, chunk)

    def _gen_parallel(self, start_step: int = 0) -> Iterator[Dict]:
        """Thread-pool batch construction, yielded strictly in order —
        bit-identical to the serial stream (batches are pure functions of
        their position, so parallelism can't change anything)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        schedule = self._positions(start_step)
        depth = self.workers + max(self.prefetch, 1)
        ex = ThreadPoolExecutor(max_workers=self.workers)
        pending: "deque" = deque()

        def top_up():
            while len(pending) < depth:
                try:
                    pending.append(ex.submit(self._batch_at, *next(schedule)))
                except StopIteration:
                    return

        try:
            top_up()
            while pending:
                batch = pending.popleft().result()
                top_up()
                yield batch
        finally:
            # Abandoned iterators must not block on in-flight batches (a
            # joining shutdown also races interpreter teardown).
            ex.shutdown(wait=False, cancel_futures=True)

    def _prefetched(self, gen) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from gen
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def producer():
            try:
                for b in gen:
                    q.put(b)
                q.put(DONE)
            except BaseException as e:  # re-raised in the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is DONE:
                return
            if isinstance(b, BaseException):
                raise b
            yield b

    def iter_from(self, start_step: int) -> Iterator[Dict]:
        """Resume iteration as if `start_step` batches were already drawn."""
        if self.workers > 0:
            return self._gen_parallel(start_step)
        return self._prefetched(self._gen(start_step))

    def __iter__(self) -> Iterator[Dict]:
        return self.iter_from(0)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n


def pin_batch(batch: Dict) -> Dict:
    """The batch with each numeric numpy array as a tensor in pinned host
    memory (lists of strings stay as they are)."""
    import torch

    return {k: torch.from_numpy(v).pin_memory()
            if isinstance(v, np.ndarray) and v.dtype.kind in "biuf" else v
            for k, v in batch.items()}


def pinned_put(device) -> Callable:
    """Every tensor or numeric numpy array of a batch (a dict of them, or of
    a Conditioning) copied to ``device``: to the card from pinned memory,
    non-blocking."""
    import dataclasses

    import torch

    def put_one(v):
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor):
            if (torch.device(device).type == "cuda" and v.device.type == "cpu"
                    and not v.is_pinned()):
                v = v.pin_memory()
            return v.to(device, non_blocking=True)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return type(v)(**{f.name: None if getattr(v, f.name) is None
                              else put_one(getattr(v, f.name))
                              for f in dataclasses.fields(v)})
        return v

    return lambda batch: {k: put_one(v) for k, v in batch.items()}


def cache_device_batches(batches, n: int, put: Optional[Callable] = None, device="cuda"):
    """Materialize the first `n` batches on ``device`` and cycle them forever.

    Removes the per-step host->device copy for small datasets or slow host
    links (the --cache_batches CLI flag). `put` defaults to a pinned,
    non-blocking copy of each tensor (and numpy array) to ``device``.
    Deviates from the per-epoch reshuffled stream by design.
    """
    import itertools

    put = put or pinned_put(device)
    it = iter(batches)
    return itertools.cycle([put(next(it)) for _ in range(n)])


def get_dataset_loader(
    name: str,
    batch_size: int,
    num_frames: int = 196,
    split: str = "train",
    hml_mode: str = "train",
    fixed_len: int = 0,
    pred_len: int = 0,
    shard: Optional[tuple] = None,
    **kwargs,
) -> BatchIterator:
    dataset = get_dataset(
        name, num_frames=num_frames, split=split, hml_mode=hml_mode,
        fixed_len=fixed_len, **kwargs,
    )
    return BatchIterator(
        dataset,
        batch_size,
        shuffle=(split == "train" or hml_mode == "train"),
        infinite=(hml_mode == "train"),
        pred_len=pred_len if fixed_len > 0 else 0,
        shard=shard,
    )
