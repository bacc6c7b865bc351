"""Balanced sampling: index plans + item assembly (host side).

The port's own copy of ``medsegpretrainimagenet_tpu/data/sampling.py``
(the reference's ``data/utils.py``: ``BalancedDataset``,
``create_index_list``, ``DataIterator``), pure numpy, so the same seed
gives the same index plans and batches, bit for bit: positive /
negative splits from a ``positives`` or binary ``label`` column,
over/under/pos-only/integer balance factors with fractional "cut"
bookkeeping, ``relative_size`` subsampling, per-column lazy load functions,
``partition_count`` index expansion (one image -> N crops per epoch),
``extra_datapoints`` pair sampling for Mixup/CutMix, minimum
positives/negatives per batch, sort-by-key batching and last-axis padding.

This module produces *plans* (index arrays) and numpy batches; the
loader (``loader.py``) stacks them and copies them to the card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from ..config import ConfigDict

__all__ = ["BalancedSource", "StatefulLoadFunctions", "batch_index_plan",
           "assemble_batch"]


class StatefulLoadFunctions(dict):
    """Marker for per-column load functions whose calls are ORDER-DEPENDENT
    (MixedDataset's lazy-reload counter columns drive a stateful record
    pointer, ``mixed.py``).  Sources carrying one never run ``_load`` on
    the loader's worker pool — items must load one at a time, in index
    order, counter columns first."""


def balance_factor(pos_len: int, neg_len: int, pos_ratio: float) -> float:
    return pos_ratio * neg_len / ((1 - pos_ratio) * pos_len)


class BalancedSource:
    """Item source with balancing semantics (reference ``BalancedDataset``).

    Index space layout matches the reference: indices below ``neg_len``
    address negatives; the rest cycle through positives (each positive
    appears ``ceil(balance_factor)`` times, with the fractional excess
    recorded in ``self.cut`` for the batch planner to trim).
    ``partition_count`` multiplies the index space so deterministic grid
    crops (Partition transform) see a distinct ``_index`` per crop.
    """

    def __init__(self, data: Dict[str, Any],
                 balanced: Union[int, str] = "over",
                 relative_size: float = 1.0,
                 transforms: Optional[Callable] = None,
                 load_function: Optional[Any] = None,
                 pos_ratio_in_ds: float = 1.0,
                 partition_count: Optional[int] = None,
                 extra_datapoints: int = 0,
                 seed: Optional[int] = None,
                 sample_with_replacement: bool = True,
                 *args, **kwargs):
        self.rng = np.random.default_rng(seed)

        full_len = len(next(iter(data.values())))
        self.len_data = int(full_len * relative_size)
        keep = self.rng.permutation(full_len) < self.len_data
        idcs = np.arange(full_len)[keep]

        def subset(value):
            # ndarray columns stay ndarrays: with relative_size 1.0 the
            # reader's stack is reused untouched (zero copy — list-ifying
            # image stacks and re-stacking later doubled host memory);
            # a true subset fancy-indexes once
            if isinstance(value, np.ndarray):
                return value if self.len_data == full_len else value[idcs]
            return [value[i] for i in idcs]

        self.data = {key: subset(value) for key, value in data.items()}

        self.pos_only = balanced == "pos_only"
        self.k = extra_datapoints
        self.replacement = sample_with_replacement
        self.load_function = load_function
        self.transforms = transforms
        self.partition_count = partition_count or 1

        if "positives" in self.data:
            positives = np.asarray(self.data.pop("positives")).astype(bool)
        elif "label" in self.data and all(
                label in (0, 1) for label in self.data["label"]):
            positives = np.asarray(self.data["label"]).astype(bool)
        else:
            positives = np.ones(self.len_data, dtype=bool)

        all_idcs = np.arange(self.len_data)
        self.positive_idcs = all_idcs[positives]
        self.negative_idcs = all_idcs[~positives]
        self.pos_len = int(positives.sum())
        self.neg_len = int((~positives).sum())

        if balanced == "pos_only":
            self.data = {key: [v for v, p in zip(values, positives) if p]
                         for key, values in self.data.items()}
            self.balance_factor = 1
            self.cut = {"amount": 0}
        elif balanced == "over":
            self.balance_factor = balance_factor(
                self.pos_len, self.neg_len, pos_ratio_in_ds)
            self.cut = {"class": "pos",
                        "amount": (math.ceil(self.balance_factor)
                                   - self.balance_factor) * self.pos_len}
        elif balanced == "under":
            cut_factor = 1 / balance_factor(self.pos_len, self.neg_len,
                                            pos_ratio_in_ds)
            self.balance_factor = 1
            # clamp: a dataset already ABOVE the target positive ratio
            # gives cut_factor > 1 -> a negative amount, which the batch
            # planner's rest[:-cut] slicing silently turns into a
            # few-item epoch (the reference's make_cut has the same hole)
            self.cut = {"class": "neg",
                        "amount": max(self.neg_len * (1 - cut_factor),
                                      0.0)}
        else:
            self.cut = {"amount": 0}
            self.balance_factor = balanced

    # -- vectorized fast path -------------------------------------------
    # when nothing in the pipeline is per-item (no lazy loads, no k-extra
    # sampling, no partitions, transforms at most dtype casts) a whole
    # batch is one fancy-index per column — the hot configuration under
    # on-device augmentation, where the host's only job is slicing.

    def supports_vectorized(self) -> bool:
        cached = getattr(self, "_vectorizable", None)
        if cached is not None:
            return cached
        ok = (self.k == 0 and self.partition_count == 1
              and self.load_function is None)
        if ok and self.transforms is not None:
            from .transforms.core import Compose, ConvertToType
            stages = self.transforms.transforms \
                if isinstance(self.transforms, Compose) \
                else (self.transforms,)
            ok = all(isinstance(t, ConvertToType) for t in stages)
        if ok:
            try:
                arrays = {
                    key: values if isinstance(values, np.ndarray)
                    else np.asarray(values)
                    for key, values in self.data.items()}
                # replace (don't duplicate) the per-item columns: array
                # columns index identically in __getitem__, and keeping
                # both doubles host memory on image-stack datasets
                self.data = arrays
                self._column_arrays = arrays
            except (ValueError, TypeError):   # ragged / non-numeric
                ok = False
        self._vectorizable = ok
        return ok

    def get_batch_vectorized(self, indices) -> Dict[str, np.ndarray]:
        """Batch fetch with the same index remap as ``__getitem__``."""
        idx = np.asarray(list(indices), np.int64)
        if not self.pos_only:
            neg = idx < self.neg_len
            remapped = np.empty_like(idx)
            remapped[neg] = self.negative_idcs[idx[neg]]
            remapped[~neg] = self.positive_idcs[
                (idx[~neg] - self.neg_len) % max(self.pos_len, 1)]
            idx = remapped
        batch = {key: values[idx]
                 for key, values in self._column_arrays.items()}
        if self.transforms is not None:
            batch = self.transforms(**batch)
            batch.pop("k", None)        # transform bookkeeping keys, same
            batch.pop("_index", None)   # as the per-item path
        return batch

    def __len__(self) -> int:
        if self.pos_only:
            real_length = self.pos_len
        else:
            real_length = self.neg_len + \
                math.ceil(self.balance_factor) * self.pos_len
        return self.partition_count * real_length

    def _load(self, data: Dict[str, Any]) -> Dict[str, Any]:
        lf = self.load_function
        if lf is None:
            return data
        if isinstance(lf, (dict, ConfigDict)):
            for name in list(data):
                if name in lf:
                    if self.k > 0:
                        data[name] = [lf[name](p) for p in data[name]]
                    else:
                        data[name] = lf[name](data[name])
            return data
        for name in list(data):
            if self.k > 0:
                if data[name] and isinstance(data[name][0], str):
                    data[name] = [lf(p) for p in data[name]]
            elif isinstance(data[name], str):
                data[name] = lf(data[name])
        return data

    def resolve_row(self, index: int) -> int:
        """Data row a balanced index resolves to (the negative/positive
        remap ``__getitem__`` applies) — used by sort_by so batches sort
        on the keys of the rows they actually contain."""
        idx = int(index / self.partition_count)
        if self.pos_only:
            return idx
        if index < self.neg_len:
            return int(self.negative_idcs[idx])
        return int(self.positive_idcs[(idx - self.neg_len) % self.pos_len])

    def fetch_raw(self, index: int):
        """Stage 1 of ``__getitem__``: index resolution + the k-extra rng
        draws — everything that consumes the sequential sampler rng, so it
        must run on ONE thread in index order.  Returns the *unloaded*
        ``(index_out, data)`` pair; feed ``data`` through :meth:`_load`
        (stage 2, rng-free — parallelizable) and the pair through
        :meth:`finish_item` (stage 3, sequential transform rng)."""
        idx = self.resolve_row(index)

        if self.k > 0:
            pool = np.arange(self.pos_len)
            if not self.replacement:
                pool = pool[pool != idx]
            extra = self.rng.choice(pool, self.k, replace=self.replacement)
            index_out: Any = [index, *extra]
            data = {name: [values[i] for i in [idx, *extra]]
                    for name, values in self.data.items()}
        else:
            index_out = index
            data = {name: values[idx] for name, values in self.data.items()}
        return index_out, data

    def finish_item(self, index_out, data: Dict[str, Any]) -> Dict[str, Any]:
        """Stage 3 of ``__getitem__``: transforms (shared sequential rng
        stream — single-threaded, index order) + k-extra collapse."""
        if self.transforms is not None:
            data = self.transforms(**data, _index=index_out, k=self.k + 1)
            data.pop("_index", None)
            data.pop("k", None)

        if self.k > 0:
            for name, values in data.items():
                if isinstance(values, list):
                    data[name] = values[0]
        return data

    def parallel_load_ok(self) -> bool:
        """True when ``_load`` may run concurrently across items: there is
        per-item load work, and it is not order-dependent (MixedDataset's
        lazy-reload counters are stateful — marked with
        :class:`StatefulLoadFunctions`)."""
        return (self.load_function is not None
                and not isinstance(self.load_function,
                                   StatefulLoadFunctions))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        index_out, data = self.fetch_raw(index)
        return self.finish_item(index_out, self._load(data))


def batch_index_plan(ds_len: int, nr_pos: int, p: int, n: int, bs: int,
                     cut: Dict[str, Any], rng: np.random.Generator,
                     reuse: str = "no"):
    """Per-epoch index list with fixed minimum positives/negatives per
    virtual batch (reference ``create_index_list``).

    Index space convention: [0, ds_len - nr_pos) are negatives, the rest
    positives (matching :class:`BalancedSource`).
    """
    batch_nr = int((ds_len - cut["amount"]) / bs)
    filler = bs - p - n
    nr_neg = ds_len - nr_pos

    shuf_pos = list(rng.permutation(np.arange(nr_neg, ds_len)))
    shuf_neg = list(rng.permutation(np.arange(nr_neg)))

    rest_pos = shuf_pos[p * batch_nr:]
    rest_neg = shuf_neg[n * batch_nr:]
    cut_size = int(cut["amount"])
    if cut_size == 0:
        rest = rest_pos + rest_neg
    elif cut.get("class") == "pos":
        rest = rest_pos[:-cut_size] + rest_neg
    else:
        rest = rest_pos + rest_neg[:-cut_size]
    rest = list(rng.permutation(np.asarray(rest, dtype=np.int64))) \
        if rest else []

    plan: List[int] = []
    for i in range(batch_nr):
        batch = (shuf_pos[i * p:(i + 1) * p]
                 + shuf_neg[i * n:(i + 1) * n]
                 + rest[i * filler:(i + 1) * filler])
        batch = [int(x) for x in batch]
        rng.shuffle(batch)
        plan.extend(batch)
    return batch_nr, plan


def assemble_batch(source, indices: Iterable[int],
                   pad_with: Optional[float] = None,
                   executor=None) -> Dict[str, np.ndarray]:
    """Stack items into a numpy batch, right-padding the last axis when
    lengths differ (reference ``get_batch``).

    With *executor* (a ``ThreadPoolExecutor``) the rng-free lazy-load
    stage (``BalancedSource._load`` — per-item ``np.load``/decode, the
    disk-I/O hot spot of ImageNet-style pretraining, reference
    ``data/utils.py:148-149``) runs concurrently across the batch's items;
    the sampler's k-extra draws and the transforms keep their sequential
    shared-rng order, so batches are BIT-IDENTICAL to the serial path.
    Sources whose loads are order-dependent (``StatefulLoadFunctions``)
    fall back to serial assembly."""
    if pad_with is None and hasattr(source, "supports_vectorized") \
            and source.supports_vectorized():
        return source.get_batch_vectorized(indices)
    if executor is not None and hasattr(source, "parallel_load_ok") \
            and source.parallel_load_ok():
        raws = [source.fetch_raw(int(idx)) for idx in indices]
        loaded = list(executor.map(source._load, (d for _, d in raws)))
        items = [source.finish_item(index_out, data)
                 for (index_out, _), data in zip(raws, loaded)]
    else:
        items = [source[int(idx)] for idx in indices]
    columns: Dict[str, list] = {}
    for item in items:
        for key, value in item.items():
            columns.setdefault(key, []).append(np.asarray(value))
    batch = {}
    for key, values in columns.items():
        if pad_with is not None and values[0].ndim > 0:
            max_len = max(v.shape[-1] for v in values)
            values = [np.concatenate(
                [v, np.full((*v.shape[:-1], max_len - v.shape[-1]), pad_with,
                            dtype=v.dtype)], axis=-1)
                if v.shape[-1] != max_len else v for v in values]
        batch[key] = np.stack(values)
    return batch
