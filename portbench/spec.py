"""Where the benchmark finds a cell, a configuration, a traffic mix, an
entry and a per-layer metric: each by its name, in a file of its own.

    BENCHMARK.json                    the cells, metrics and bounds
    portbench/workloads/<cell>.json   configuration, traffic, entry, ...
    portbench/configs/<config>.json   the port's config tree and its source
    portbench/archs/<arch>.py         the plain reference of the model that
                                      a configuration names (``reference``)
    portbench/traffic/<traffic>.json  the generator's parameters
    portbench/entries/<entry>.py      ``run(ctx) -> Outcome``
    portbench/metrics/<metric>.py     ``read(record) -> float | None``
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = ["ROOT", "BENCH", "Cell", "load_benchmark", "load_cell",
           "load_module", "load_arch", "cell_metrics"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float] = field(default_factory=dict)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} not found")
    return json.loads(path.read_text())


def load_benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> Cell:
    workload = _json(BENCH / "workloads" / f"{name}.json")
    config = _json(BENCH / "configs" / f"{workload['config']}.json")
    traffic = _json(BENCH / "traffic" / f"{workload['traffic']}.json")
    return Cell(name=name, workload=workload, config=config,
                traffic=traffic, chips=int(workload["chips"]),
                limits=dict(workload.get("limits", {})))


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots),
    loaded once a process."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} not found")
    qualified = f"portbench.{kind}.{name.replace('.', '_')}"
    if qualified in sys.modules:
        return sys.modules[qualified]
    spec = importlib.util.spec_from_file_location(qualified, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[qualified] = module     # a dataclass looks its module up
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[qualified]
        raise
    return module


def load_arch(config: dict) -> ModuleType:
    """The architecture module a configuration names under
    ``reference``: ``shape_of(tree)``, ``forward(ops, params, x, shape,
    train, keeps=None, running=None, ckpt=False)``, ``drop_rates(shape)``,
    ``attention_calls(shape, batch)`` and ``small(tree)``."""
    return load_module("archs", config["reference"])


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of *section* ("end_to_end" or "per_layer") that *cell*
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]
