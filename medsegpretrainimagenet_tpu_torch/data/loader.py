"""Batched data loading with device prefetch.

The port of ``medsegpretrainimagenet_tpu/data/loader.py``.
:class:`BalancedDataLoader` is the JAX package's (reference
``data/dataset.py:268-372``): sampling-method resolution ({over,under}
sampling / positives-only / uniform), virtual vs loaded (fragment) batch
sizes for gradient accumulation, min pos/neg ratios per batch, sort_by and
pad_with; its numpy draws are the JAX package's, so the same seed gives
the same batches, bit for bit.

:func:`prefetch_to_device` keeps ``size`` batches in flight to the card:
each host batch is copied into pinned memory and from there with a
``non_blocking`` copy, so the copy overlaps the running step and never
blocks the host.  A pinned buffer stays referenced until a CUDA event
recorded after its copy has completed.
"""
from __future__ import annotations

import collections
import math
import os
import warnings
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..config import ConfigDict
from .sampling import BalancedSource, assemble_batch, batch_index_plan

__all__ = ["BalancedDataLoader", "prefetch_to_device", "PinnedCopier"]


class BalancedDataLoader:
    """Iterable of numpy batch dicts built from raw column data."""

    #: reserved batch key marking a per-process input slice (popped by the
    #: training loop before the batch reaches the step)
    LOCAL_SLICE_KEY = "_mst_local_slice"

    PARAMS = {
        "epoch": {"argument name": "epoch_samling_method",
                  "default": "uniform"},
        "batch": {"argument name": "batch_sampling_method",
                  "default": "uniform"},
        "sort_by": None,
        "pad_with": None,
        "relative_size": 1.0,
    }
    BATCH_SIZE = 8
    SAMPLING_METHODS = {
        "oversampling": "over",
        "undersampling": "under",
        "positives only": "pos_only",
        "uniform": 1,
    }
    SAMPLING_PARAMS = {"ratio of positives": 0.5}

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        config_dict.get_or_update("batch size", BalancedDataLoader.BATCH_SIZE)
        for ds_type in ("train", "val"):
            curr = config_dict.get_or_update(
                ds_type, {ds_type: {"default": {}}}, final=False)
            if not isinstance(curr, ConfigDict):
                curr = ConfigDict()
                config_dict[ds_type] = curr
            curr.fill_with_defaults(BalancedDataLoader.PARAMS)
            epoch_sampling = curr["epoch"]
            if isinstance(epoch_sampling, str):
                curr["epoch"] = ConfigDict({epoch_sampling: {}})
                epoch_sampling = curr["epoch"]
            if epoch_sampling.key() in ("oversampling", "undersampling"):
                epoch_sampling.value().get_or_update(
                    "ratio of positives",
                    BalancedDataLoader.SAMPLING_PARAMS["ratio of positives"])

    def __init__(self, data: Dict[str, Any], config_dict: ConfigDict,
                 bs: int = 1, actual_bs: int = 1,
                 transforms: Optional[Callable] = None,
                 datapoints_per_sample: Optional[int] = 1,
                 shuffle: bool = True, seed: Optional[int] = None,
                 drop_last: bool = False,
                 process_shard: Optional[tuple] = None,
                 num_workers: int = 0, **kwargs):
        """``num_workers`` (config ``meta/technical/
        number_of_data_loader_workers``) parallelizes the rng-free lazy-load
        stage of batch assembly over a thread pool; batches stay
        bit-identical to ``num_workers=0``.

        ``process_shard=(rank, count)`` turns on per-host input slicing
        under data parallelism: every process computes the same seeded
        index plan but assembles only its ``1/count`` slice of each full
        batch, marked with :attr:`LOCAL_SLICE_KEY`, so
        ``parallel.shard_batch(..., already_local=True)`` takes it as it is.
        A short tail is assembled whole on every process and replicates.
        A fragment size that *count* does not divide turns the slicing off
        with a warning."""
        self.process_shard = tuple(process_shard) if process_shard else None
        if self.process_shard is not None:
            rank, count = self.process_shard
            if not 0 <= rank < count:
                raise ValueError(f"bad process_shard {process_shard}")
            if count > 1 and actual_bs % count != 0:
                warnings.warn(
                    f"actual batch size {actual_bs} not divisible by "
                    f"process count {count}: per-host input slicing "
                    "disabled (every batch would replicate)", stacklevel=2)
                self.process_shard = None
        self.empty = not data or any(len(v) == 0 for v in data.values())
        self.num_workers = max(0, int(num_workers or 0))
        self._executor = None
        self.bs = bs
        self.actual_bs = actual_bs
        self._plan_len: Optional[int] = None
        self.rng = np.random.default_rng(seed)
        if self.empty:
            self.source = None
            self._mode = "empty"
            return

        epoch_cfg = config_dict.get("epoch", ConfigDict({"uniform": {}}))
        if isinstance(epoch_cfg, str):
            epoch_cfg = ConfigDict({epoch_cfg: {}})
        epoch_method = epoch_cfg.key()
        datapoints_per_sample = datapoints_per_sample or 1
        balanced = self.SAMPLING_METHODS.get(
            epoch_method.replace("_", " "), epoch_method)
        self.source = BalancedSource(
            data,
            balanced=balanced,
            pos_ratio_in_ds=epoch_cfg.get(
                f"{epoch_method}/ratio of positives", 1),
            transforms=transforms,
            extra_datapoints=datapoints_per_sample - 1,
            sample_with_replacement=config_dict.get(
                "extra_datapoints_with_replacement", True),
            relative_size=config_dict.get("relative_size", 1.0),
            seed=seed,
            **kwargs)

        batch_cfg = config_dict.get("batch", ConfigDict({"uniform": {}}))
        if isinstance(batch_cfg, str):
            batch_cfg = ConfigDict({batch_cfg: {}})
        self.sort_by = config_dict.get("sort_by")
        if isinstance(self.sort_by, ConfigDict):
            self.sort_by = self.sort_by.key()
        self.pad_with = config_dict.get("pad_with")
        uniform_batches = "uniform" in batch_cfg
        if uniform_batches and self.sort_by is None and self.pad_with is None:
            self._mode = "uniform"
            self.shuffle = shuffle
            self.drop_last = drop_last
        else:
            self._mode = "planned"
            self.min_pos = batch_cfg.get("min ratio of positives", 0.0) or 0.0
            self.min_neg = batch_cfg.get("min ratio of negatives", 0.0) or 0.0

    # ------------------------------------------------------------------

    def _uniform_indices(self):
        n = len(self.source)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        if self.drop_last:
            order = order[:(n // self.actual_bs) * self.actual_bs]
        return order

    def _build_plan(self, rng):
        """One shared construction for iteration and length (the plan's
        length is rng-independent; only its ordering varies)."""
        _, plan = batch_index_plan(
            len(self.source), self.source.pos_len
            * math.ceil(self.source.balance_factor),
            int(self.min_pos * self.bs), int(self.min_neg * self.bs),
            self.bs, self.source.cut, rng)
        return plan

    def _planned_indices(self):
        plan = self._build_plan(self.rng)
        if self.sort_by is not None:
            # sort by the key of the row each balanced index resolves to
            keys = [float(k) for k in self.source.data[self.sort_by]]
            plan = sorted(
                plan, key=lambda i: keys[self.source.resolve_row(i)])
        return np.asarray(plan, dtype=np.int64)

    def __len__(self) -> int:
        if self.empty:
            return 0
        if self._mode == "uniform":
            n = len(self.source)
            if self.drop_last:
                return n // self.actual_bs
            return math.ceil(n / self.actual_bs)
        # the plan's length is deterministic (only its ordering depends on
        # the rng): build it once and cache it
        if self._plan_len is None:
            self._plan_len = len(self._build_plan(np.random.default_rng(0)))
        # __iter__ stops before a ragged tail in planned mode (reference
        # DataIterator semantics), so floor, not ceil
        return self._plan_len // self.actual_bs

    def _load_executor(self):
        """Shared worker pool for the parallel lazy-load stage (created on
        first use, reused across epochs; None when workers are off or the
        source has no parallelizable load work)."""
        if self.num_workers <= 0 or self.source is None \
                or not self.source.parallel_load_ok():
            return None
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="mst-loader")
        return self._executor

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.empty:
            return
        executor = self._load_executor()
        indices = self._uniform_indices() if self._mode == "uniform" \
            else self._planned_indices()
        for start in range(0, len(indices), self.actual_bs):
            chunk = indices[start:start + self.actual_bs]
            if self._mode == "planned" and len(chunk) < self.actual_bs:
                break  # reference DataIterator stops before a ragged tail
            if self.process_shard is not None \
                    and len(chunk) == self.actual_bs:
                rank, count = self.process_shard
                per = len(chunk) // count
                batch = assemble_batch(
                    self.source, chunk[rank * per:(rank + 1) * per],
                    pad_with=self.pad_with, executor=executor)
                batch[self.LOCAL_SLICE_KEY] = np.ones((), bool)
                yield batch
                continue
            yield assemble_batch(self.source, chunk, pad_with=self.pad_with,
                                 executor=executor)


class PinnedCopier:
    """Host numpy batches -> device tensors through pinned memory.

    ``__call__`` copies each array of a batch into a pinned host tensor and
    queues a ``non_blocking`` copy of it to *device*; it returns the device
    batch at once.  The pinned tensors are held, with a CUDA event recorded
    after their copies, until the event has completed, so no buffer is
    freed or reused under a copy in flight.  On the CPU the arrays are
    wrapped as tensors, with no copy."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        self._in_flight: collections.deque = collections.deque()
        #: the pinned tensors of the last batch (tests read it)
        self.last_host: Dict[str, torch.Tensor] = {}

    def _release_finished(self) -> None:
        while self._in_flight and self._in_flight[0][0].query():
            self._in_flight.popleft()

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        if not self.on_cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    if isinstance(v, np.ndarray) else v
                    for k, v in batch.items()}
        self._release_finished()
        host, out = {}, {}
        for key, value in batch.items():
            if not isinstance(value, np.ndarray):
                out[key] = value
                continue
            pinned = torch.empty(value.shape,
                                 dtype=torch.from_numpy(value[:0]).dtype,
                                 pin_memory=True)
            pinned.numpy()[...] = value
            host[key] = pinned
            out[key] = pinned.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._in_flight.append((event, host))
        self.last_host = host
        return out


def prefetch_to_device(iterator, size: int = 2, device=None,
                       put: Optional[Callable] = None, on_error=None,
                       threaded=None):
    """Keep *size* batches of *iterator* in flight to *device*.

    Each batch goes through *put* (default: a :class:`PinnedCopier` for
    *device*) when it is pulled, *size* batches ahead of the consumer, so
    its host-to-device copy overlaps the running step.  With ``on_error``,
    a batch whose transfer fails is reported and skipped instead of
    aborting the stream (the per-batch error envelope).

    With ``threaded=True`` (or env ``MST_PREFETCH_THREAD=1``; config
    ``meta/technical/threaded prefetch``) the pull and the copy move to a
    background worker thread, so host batch assembly (transforms, stacking)
    also overlaps the device step.  Batch order is identical either way
    (one worker, FIFO).  Threading is off by default, as in the JAX
    package.
    """
    if put is None:
        put = PinnedCopier(device)
    if threaded is None:
        threaded = os.environ.get("MST_PREFETCH_THREAD", "0") == "1"
    if threaded:
        return _threaded_prefetch(iterator, size, put, on_error)
    return _sync_prefetch(iterator, size, put, on_error)


def _sync_prefetch(iterator, size, put, on_error):
    queue = collections.deque()
    it = iter(iterator)

    def fill_one() -> bool:
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return False
            except Exception as exc:  # noqa: BLE001 - generator is dead
                if on_error is None:
                    raise
                on_error(exc)
                return False
            try:
                queue.append(put(batch))
                return True
            except Exception as exc:  # noqa: BLE001
                if on_error is None:
                    raise
                on_error(exc)

    for _ in range(size):
        if not fill_one():
            break
    while queue:
        yield queue.popleft()
        fill_one()


def _threaded_prefetch(iterator, size, put, on_error):
    """One daemon worker pulls batches and puts them into a bounded FIFO
    queue; the consumer generator pops ready device batches.

    Error semantics match ``_sync_prefetch``: with ``on_error`` an
    iterator exception ends the stream and a ``put`` exception skips that
    batch; without it the exception re-raises in the consumer.  The worker
    exits promptly when the consumer abandons the generator (``stop`` event
    and a bounded-put timeout), so a crashed epoch does not leak a blocked
    thread.
    """
    import queue as queue_mod
    import threading

    q = queue_mod.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        it = iter(iterator)
        while not stop.is_set():
            try:
                batch = next(it)
            except StopIteration:
                break
            except Exception as exc:  # noqa: BLE001 - generator is dead
                if on_error is None:
                    offer(("raise", exc))
                    return
                on_error(exc)
                break
            try:
                item = ("batch", put(batch))
            except Exception as exc:  # noqa: BLE001
                if on_error is None:
                    offer(("raise", exc))
                    return
                on_error(exc)
                continue
            if not offer(item):
                return
        offer(("end", None))

    thread = threading.Thread(target=worker, daemon=True,
                              name="mst-prefetch")

    def gen():
        # start the worker on the first iteration, not at construction: a
        # stream that is created but never iterated must not leave a worker
        # pulling batches forever (closing a never-started generator skips
        # its finally)
        thread.start()
        try:
            while True:
                kind, value = q.get()
                if kind == "end":
                    return
                if kind == "raise":
                    raise value
                yield value
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue_mod.Empty:
                pass
            thread.join(timeout=5)

    return gen()
