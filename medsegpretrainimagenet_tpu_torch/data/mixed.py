"""Union of several datasets with switching + balancing.

The port of ``data/mixed.py`` (the reference's ``MixedDataset``,
``data/dataset.py:15-266``): samples alternate between sub-datasets every
``switch_frequency`` records (cyclic when
``preserve_order``, shuffled otherwise), per-split size balancing
(``none`` / ``under`` / ``over``), lazy ``preload_data=False`` reloading,
and three virtual columns — ``train_counter`` / ``val_counter`` (booleans
driving the stateful record pointer) and ``ds_idx`` (active sub-dataset).

The virtual columns work through the loader's per-column ``load_function``
protocol: the counter columns are listed FIRST in the ``train``/``val``
dicts, so their load functions run first on every ``__getitem__`` and
advance the (dataset, record) pointer that the other columns then read.
Missing keys in a sub-dataset are filled with NaN rows.  The load
functions are a :class:`StatefulLoadFunctions`, so the loader never runs
them on its worker pool: items load one at a time, in index order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..config import ConfigDict, register
from .dataset import Dataset
from .sampling import StatefulLoadFunctions

__all__ = ["MixedDataset"]


@register("data.MixedDataset", "mixed_dataset")
class MixedDataset(Dataset):
    PARAMS = {
        "datasets": tuple(),
        "switch_frequency": 1,
        "preserve_order": False,
        "balancing_strategy": {"train": "none", "val": "under"},
        "preload_data": True,
    }

    @staticmethod
    def fill_kwargs(config_dict: ConfigDict):
        from ..config.registry import fill_spec
        for ds_dict in config_dict.elements_of("datasets"):
            fill_spec(ds_dict)
        bal = config_dict.get("balancing_strategy")
        if isinstance(bal, ConfigDict):
            bal.fill_with_defaults(
                MixedDataset.PARAMS["balancing_strategy"])

    def __init__(self, config_dict: ConfigDict,
                 seed: Optional[int] = None, *args, **kwargs):
        from ..config import registry

        self.dataset_configs = tuple(config_dict.elements_of("datasets"))
        self.rng = np.random.default_rng(seed)
        if seed is None:
            seed = int(self.rng.integers(0, 10 ** 12))
        self.seed = seed
        self.args, self.kwargs = args, kwargs
        self.preload_data = config_dict.get("preload_data", True)

        keys: set = set()
        self.train_ds_sizes: List[int] = []
        self.val_ds_sizes: List[int] = []
        self.dss: List[Any] = []
        self.load_functions: List[Dict[str, Callable]] = []

        for ds_idx, ds_dict in enumerate(self.dataset_configs):
            ds = registry.build(ds_dict if isinstance(ds_dict, ConfigDict)
                                else ConfigDict({ds_dict: {}}),
                                wrapper=Dataset, seed=seed,
                                *args, **kwargs)
            train_ds = ds.train
            val_ds = getattr(ds, "val", {}) or {}
            ds.val = val_ds
            keys.update(train_ds.keys())

            train_len = len(next(iter(train_ds.values())))
            val_len = len(next(iter(val_ds.values()))) if val_ds else 0

            # lazy mode drops the payloads of the *inactive* datasets;
            # both split pointers start at dataset 0, which stays loaded
            if not self.preload_data and ds_idx != 0:
                ds.train = {kw: [np.nan] * train_len for kw in train_ds}
                ds.val = {kw: [np.nan] * val_len for kw in val_ds}

            ds.train["ds_idx"] = [ds_idx] * train_len
            ds.val["ds_idx"] = [ds_idx] * val_len

            self.dss.append(ds)
            lf = getattr(ds, "load_function", None)
            if not isinstance(lf, (dict, ConfigDict)):
                base_lf = lf

                def column_load(value, _lf=base_lf):
                    if _lf is not None and isinstance(value, str):
                        return _lf(value)
                    return value

                lf = {kw: column_load for kw in train_ds}
            self.load_functions.append(dict(lf))
            self.train_ds_sizes.append(train_len)
            self.val_ds_sizes.append(val_len)

        identity = lambda value: value  # noqa: E731
        for key in keys:
            for lf, ds, train_len, val_len in zip(
                    self.load_functions, self.dss,
                    self.train_ds_sizes, self.val_ds_sizes):
                lf.setdefault(key, identity)
                for kw, length in (("train", train_len), ("val", val_len)):
                    data_dict = getattr(ds, kw)
                    if key not in data_dict:
                        data_dict[key] = [np.nan] * length

        self.switch_frequency = config_dict.get("switch_frequency", 1)
        self.preserve_order = config_dict.get("preserve_order", False)
        bal = config_dict.get("balancing_strategy",
                              self.PARAMS["balancing_strategy"])
        get_bal = (bal.get if isinstance(bal, (dict, ConfigDict))
                   else (lambda *_: bal))
        self.train_balancing_strategy = self._strategy(get_bal("train"))
        self.val_balancing_strategy = self._strategy(get_bal("val", "under"))

        self.num_datasets = len(self.dataset_configs)
        freq = self.switch_frequency
        for kw, strategy, sizes in (
                ("train", self.train_balancing_strategy,
                 self.train_ds_sizes),
                ("val", self.val_balancing_strategy, self.val_ds_sizes)):
            if strategy == "none":
                full_len = sum(s - (s % freq) for s in sizes)
            elif strategy == "over":
                m = max(sizes)
                full_len = (m - m % freq) * self.num_datasets
            elif strategy == "under":
                m = min(sizes)
                full_len = (m - m % freq) * self.num_datasets
            else:
                raise ValueError(
                    f"balancing_strategy must be none/under/over, "
                    f"got {strategy!r}")
            setattr(self, f"full_{kw}_len", full_len)

        keys.add("ds_idx")
        self._union_keys = set(keys)
        self.train = {"train_counter": [True] * self.full_train_len,
                      "val_counter": [False] * self.full_train_len,
                      **{kw: [True] * self.full_train_len for kw in keys}}
        self.val = {"train_counter": [False] * self.full_val_len,
                    "val_counter": [True] * self.full_val_len,
                    **{kw: [False] * self.full_val_len for kw in keys}}

        def make_load_fn(keyword):
            return lambda is_train: self._load_column(keyword, is_train)

        # StatefulLoadFunctions: the counter columns advance a shared
        # record pointer, so items must load serially in index order —
        # the loader's worker pool must never parallelize these
        self.load_function = StatefulLoadFunctions({
            **{kw: make_load_fn(kw) for kw in keys},
            "train_counter": self._count_train,
            "val_counter": self._count_val,
            "ds_idx": self._load_ds_idx,
        })

        self._reinit_ds_idcs("train")
        self._reinit_ds_idcs("val")
        self.curr_train_ds, self.curr_val_ds = 0, 0
        self._train_record_iters = [
            iter(self.rng.permutation(s)) for s in self.train_ds_sizes]
        self._val_record_iters = [
            iter(range(s)) for s in self.val_ds_sizes]

    @staticmethod
    def _strategy(value) -> str:
        if isinstance(value, ConfigDict):
            return value.key()
        return value or "none"

    # ------------------------------------------------------------------
    # stateful pointers
    # ------------------------------------------------------------------

    def _reinit_ds_idcs(self, ds_type: str):
        preserve = self.preserve_order if ds_type == "train" else True
        full_len = getattr(self, f"full_{ds_type}_len")
        strategy = getattr(self, f"{ds_type}_balancing_strategy")
        sizes = getattr(self, f"{ds_type}_ds_sizes")
        freq = self.switch_frequency
        if strategy in ("under", "over"):
            n_bundles = full_len // freq   # divisible by num_datasets
            base = np.tile(np.arange(self.num_datasets),
                           n_bundles // max(1, self.num_datasets))
            if not preserve:
                base = self.rng.permutation(base)
            idcs = np.repeat(base, freq)
        else:  # none
            if preserve:
                idcs_list: List[int] = []
                curr = 0
                left = list(sizes)
                while len(idcs_list) < full_len:
                    bundle = min(freq, left[curr])
                    if bundle == freq:
                        idcs_list += [curr] * bundle
                    left[curr] -= bundle
                    curr = (curr + 1) % self.num_datasets
                idcs = np.array(idcs_list, int)
            else:
                pools = sum([[i] * (s // freq)
                             for i, s in enumerate(sizes)], [])
                idcs = np.repeat(self.rng.permutation(pools), freq)
        setattr(self, f"_{ds_type}_ds_iter", iter(idcs))

    def _next_record(self, ds_type: str, ds_idx: int) -> int:
        iters = getattr(self, f"_{ds_type}_record_iters")
        sizes = getattr(self, f"{ds_type}_ds_sizes")
        if sizes[ds_idx] == 0:
            # 'over' balancing keeps an empty sub-dataset in the rotation;
            # re-seeding iter(range(0)) would raise StopIteration out of
            # the load function (latent crash in reference
            # ``data/dataset.py:180-184``) — fail with a real message
            raise ValueError(
                f"MixedDataset sub-dataset {ds_idx} has no {ds_type} "
                f"records; 'over' balancing cannot sample from it")
        try:
            return int(next(iters[ds_idx]))
        except StopIteration:
            iters[ds_idx] = iter(self.rng.permutation(sizes[ds_idx])) \
                if ds_type == "train" else iter(range(sizes[ds_idx]))
            return int(next(iters[ds_idx]))

    def _count(self, ds_type: str, counter: bool) -> bool:
        if not counter:
            return False
        try:
            new_idx = int(next(getattr(self, f"_{ds_type}_ds_iter")))
        except StopIteration:
            self._reinit_ds_idcs(ds_type)
            new_idx = int(next(getattr(self, f"_{ds_type}_ds_iter")))
        if new_idx != getattr(self, f"curr_{ds_type}_ds"):
            if not self.preload_data:
                self._reload_ds(getattr(self, f"curr_{ds_type}_ds"),
                                new_idx, ds_type)
            setattr(self, f"curr_{ds_type}_ds", new_idx)
        setattr(self, f"curr_{ds_type}_record",
                self._next_record(ds_type, new_idx))
        return counter

    def _count_train(self, train_counter):
        return self._count("train", train_counter)

    def _count_val(self, val_counter):
        return self._count("val", val_counter)

    def _load_ds_idx(self, is_train: bool) -> int:
        return self.curr_train_ds if is_train else self.curr_val_ds

    def _load_column(self, keyword: str, is_train: bool):
        ds_type = "train" if is_train else "val"
        ds_idx = getattr(self, f"curr_{ds_type}_ds")
        record = getattr(self, f"curr_{ds_type}_record")
        raw = getattr(self.dss[ds_idx], ds_type)[keyword][record]
        return self.load_functions[ds_idx][keyword](raw)

    def _reload_ds(self, old_idx: int, new_idx: int, ds_type: str):
        from ..config import registry
        # drop only the split being switched away from — the other split's
        # pointer may still sit on old_idx (reference dataset.py:228-230)
        sizes = getattr(self, f"{ds_type}_ds_sizes")
        old = getattr(self.dss[old_idx], ds_type)
        setattr(self.dss[old_idx], ds_type,
                {kw: [np.nan] * sizes[old_idx] for kw in old})
        fresh = registry.build(
            self.dataset_configs[new_idx], wrapper=Dataset,
            seed=self.seed, *self.args, **self.kwargs)
        fresh.val = getattr(fresh, "val", {}) or {}
        for kw, length in (("train", self.train_ds_sizes[new_idx]),
                           ("val", self.val_ds_sizes[new_idx])):
            data_dict = getattr(fresh, kw)
            data_dict["ds_idx"] = [new_idx] * length
            for key in self._union_keys:
                data_dict.setdefault(key, [np.nan] * length)
        self.dss[new_idx] = fresh
