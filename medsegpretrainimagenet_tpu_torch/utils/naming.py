"""Shared naming helpers: the port of ``utils/naming.py``."""
from __future__ import annotations

import re

__all__ = ["snake_name"]


def snake_name(name: str) -> str:
    """CamelCase -> snake_case, the convention both losses and metrics use
    for their CSV column names.  One shared helper so the loss and metric
    naming cannot silently diverge."""
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z0-9])([A-Z])", r"\1_\2", name).lower()
