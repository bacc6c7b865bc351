"""Command-line entry: the port of ``cli/experiment.py``.

    python -m medsegpretrainimagenet_tpu_torch.cli config.yaml [-modifiers]
        [--device cpu]

Iterates the config paths of the command line with their ``-``-prefixed
modifiers (``--continued``), expands each YAML or JSON file into its
experiment grid, gives the grid a series id, runs every experiment, and
writes cross-experiment comparison plots and best/last value CSVs.  A
failing experiment is reported and the grid goes on with the next one.

``--device NAME`` (anywhere on the line) picks the device for every
experiment; without it the port runs on the card, and raises when there
is none.  Under a launcher, data-parallel over one device per process
(rank 0 writes the files)::

    torchrun --nproc_per_node 2 -m medsegpretrainimagenet_tpu_torch.cli \
        config.yaml [--device cpu]
"""
from __future__ import annotations

import csv
import math
import os
import random
import string
import sys
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from ..config import ConfigDict, parse
from ..models.blocks import set_remat
from ..parallel import initialize_distributed, is_main_process
from ..plotting import GeneralPlotter, export_plot
from ..utils import handle_exception
from .run_experiment import (_read_csv_columns, experiment,
                             get_logs_from_path)

__all__ = ["main", "run_experiment_from_dict", "compare_experiments",
           "get_comparisons", "base64_str"]

_ALPHABET = "".join(str(i) for i in range(10)) + string.ascii_letters + "!?"


def base64_str(num: int, num_digits=None) -> str:
    """Base-64 run-id encoding (reference ``utils/_utils.py:186-199``)."""
    output = ""
    output_len = num and math.floor(math.log(num, 64))
    magnitude = 64 ** output_len
    current = int(num)
    while magnitude >= 1:
        output += _ALPHABET[current // magnitude]
        current %= magnitude
        magnitude //= 64
    if num_digits is not None:
        if num_digits <= output_len:
            raise ValueError(f"{output} has more than {num_digits} digits.")
        output = "0" * (num_digits - output_len - 1) + output
    return output


def _pop_device(args: List[str]):
    """Remove ``--device NAME`` / ``--device=NAME`` from *args*; return the
    name (None when absent)."""
    device = None
    rest = []
    it = iter(args)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value, e.g. --device cpu")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def main(argv: Optional[List[str]] = None) -> None:
    device, args = _pop_device(list(argv if argv is not None
                                     else sys.argv[1:]))
    # outside every error envelope: no card and no --device ends the run;
    # under a launcher this process joins the group on its own device
    joined = not dist.is_initialized()
    device = initialize_distributed(device)
    joined = joined and dist.is_initialized()
    try:
        args_iter = iter(args)
        arg = next(args_iter, "")
        while arg:
            modifiers = []
            next_arg = next(args_iter, "")
            while next_arg.startswith("-"):
                modifiers.append(next_arg)
                next_arg = next(args_iter, "")
            run_experiment_from_dict(arg, modifiers, device=device)
            arg = next_arg
    finally:
        # a later in-process caller builds and steps without remat
        set_remat(False)
        if joined:
            dist.destroy_process_group()


def run_experiment_from_dict(file_path: str, modifiers=(), device=None):
    config_dicts, original = parse(file_path)
    logs = get_comparisons(ConfigDict(original))
    series_id = base64_str(int(time.time() * 1e8)) + \
        base64_str(random.randint(0, 64 ** 7 - 1), num_digits=8)
    for i, cd in enumerate(config_dicts):
        try:
            logs.append(experiment(ConfigDict(cd), original=original,
                                   series_id=series_id,
                                   modifiers=list(modifiers), device=device))
        except Exception as exc:  # noqa: BLE001
            handle_exception(exc, f"Exception occured while trying to run "
                                  f"experiment {i + 1} of {file_path}.")
        try:
            compare_experiments(logs)
        except Exception as exc:  # noqa: BLE001
            handle_exception(exc, "Exception occured while plotting "
                                  "cross-experiment comparisons.")


def compare_experiments(logs: List[Dict], extensions=("html", "json")):
    """Cross-experiment overlay plots and best/last value tables, written
    by the main process."""
    logs = [log for log in logs if log]
    num_exps = len(logs)
    if num_exps < 2 or not is_main_process():
        return
    logs_dict: Dict[str, list] = {}
    for log in logs:
        for key, value in log.items():
            logs_dict.setdefault(key, []).append(value)

    num_trials = min(logs_dict.get("num_trials", [1]))
    for k in range(1, num_trials + 1):
        for save_path in logs_dict["save_path"]:
            os.makedirs(os.path.join(save_path, f"run_{k}", "comparisons"),
                        exist_ok=True)
        metric_logs = [_read_csv_columns(os.path.join(
            logs_dict["save_path"][i], f"run_{k}", "epoch_logs.csv"))
            for i in range(num_exps)]
        val_columns = [c for c in metric_logs[0]
                       if "val" in c
                       and all(c in logs_ for logs_ in metric_logs)]
        labels = ["; ".join(tags) for tags in logs_dict["tags"]]

        best_values: Dict[str, Dict[str, float]] = {}
        last_values: Dict[str, Dict[str, float]] = {}
        for metric_name in val_columns:
            values = [logs_.get(metric_name, []) for logs_ in metric_logs]
            axis_name = metric_name.split("/")[-1]
            if axis_name.startswith("val_"):
                axis_name = axis_name[4:]
            last_values[axis_name] = {
                label: (vals[-1] if vals else float("nan"))
                for label, vals in zip(labels, values)}
            mixes = [vals[0] <= vals[-1] if vals else float("nan")
                     for vals in values]
            is_max = np.nanmean(mixes) >= 0.5
            mix = max if is_max else min
            best_values[("max_" if is_max else "min_") + axis_name] = {
                label: (mix(vals) if vals else float("nan"))
                for label, vals in zip(labels, values)}

            for i in range(num_exps):
                plotter = GeneralPlotter(dict(
                    Ys=values, xlabel="epoch", ylabel=axis_name,
                    legend={"labels": labels},
                    dirname=os.path.join(logs_dict["save_path"][i],
                                         f"run_{k}", "comparisons"),
                    fname=f"{axis_name}_comparison"))
                export_plot(plotter, extensions)

        for i in range(num_exps):
            if not logs_dict["current_experiment"][i]:
                continue
            base = os.path.join(logs_dict["save_path"][i], f"run_{k}",
                                "comparisons")
            for fname, table in (("best_values_comparison.csv", best_values),
                                 ("last_values_comparison.csv", last_values)):
                with open(os.path.join(base, fname), "w", newline="") as fh:
                    writer = csv.writer(fh)
                    columns = sorted(table)
                    writer.writerow(["", *columns])
                    for label in labels:
                        writer.writerow([label, *(table[c].get(label, "")
                                                  for c in columns)])


def get_comparisons(cd: ConfigDict) -> List[Dict]:
    name_fields = cd.get("meta/technical/name_fields", [])
    comparisons = []
    for path in cd.elements_of("meta/technical/compare_to"):
        try:
            comparisons.append(get_logs_from_path(path, name_fields))
        except Exception as exc:  # noqa: BLE001
            if isinstance(path, ConfigDict):
                path = path.key()
            msg = (f"Exception loading logs from experiment {path}; "
                   f"comparisons to it will not be logged.")
            if isinstance(exc, FileNotFoundError):
                warnings.warn(msg + f"\n{exc}")
            else:
                handle_exception(exc, msg)
    return comparisons
