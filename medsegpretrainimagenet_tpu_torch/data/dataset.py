"""Dataset wrapper base.

The port's own copy of ``medsegpretrainimagenet_tpu/data/dataset.py``: a
dataset is anything exposing ``.train`` / ``.val`` dicts of equal-length
columns (``{'x': ..., 'mask': ...}``), optionally with a ``load_function``
for lazy per-item loading.  Reader classes subclass :class:`Dataset` so the
registry's wrapper logic leaves them unwrapped.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..config import ConfigDict
from ..config.registry import get_kwargs

__all__ = ["Dataset"]


class Dataset:
    """Wraps a callable returning ``(train, val)`` column dicts."""

    def __init__(self, ds_constr: Callable, ds_dict: Optional[ConfigDict]
                 = None, *args, **kwargs):
        ds_kwargs = get_kwargs(ds_constr, ds_dict or ConfigDict())
        self.train, self.val = ds_constr(*args, **kwargs, **ds_kwargs)
