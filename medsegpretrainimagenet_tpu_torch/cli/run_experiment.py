"""Experiment orchestration: the port of ``cli/run_experiment.py``.

Per-trial setup (seeding, save directories, ``--continued`` resume),
transform construction with partition and datapoint counting, default
filling for every component, the effective batch size (the largest divisor
of the virtual batch size within ``maximum_actual_batch_size``),
experiment-name tagging from ``name_fields``, the ``config.yaml`` and
``source_config.yaml`` dumps, multi-trial variance statistics, history
plots and an ``environment.txt`` module-version dump.  The host switches of
``meta/technical`` act as the reference's do (``run_experiment.py:53-65``):
a memory limit, deterministic algorithms, cuDNN autotuning, the number of
CPU threads; ``debug_nans`` makes the epoch loop check every step's scalars
(``train/loop.py``).

The port trains on one device (the card unless the caller names another)
or, under a launcher (``torchrun``), on one device per process
(``parallel``): rank 0 writes every file, the resume counters and the
directory suffix are rank 0's.  ``meta/technical/tensor_parallel`` (with
``tensor_parallel_min_channels``, default 256) or ``spatial_sharding``
lays the processes out as data x model or data x spatial, as the JAX CLI
lays out its mesh; the data processes must divide the fragment batch, the
factor the processes.
"""
from __future__ import annotations

import csv
import json
import math
import os
import random
import shutil
import socket
import sys
import warnings
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import (ConfigDict, default_experiment_config,
                      default_model_eval, dump_yaml, registry)
from ..config.config_dict import unescape
from ..data import BalancedDataLoader, Dataset
from ..data.transforms import Compose, ConvertToType, build_transform
from ..losses import Loss
from ..metrics import MetricsCalculator, build_host_loggers
from ..models import Model
from ..models.blocks import set_compute_dtype, set_remat
from ..optim import Optimizer
from ..parallel import (broadcast_from_main, create_grid, data_parallel,
                        device_count, is_main_process, launched,
                        put_replicated, rank, shard_train_state)
from ..parallel.spatial import check_supported
from ..plotting import GeneralPlotter, export_plot
from ..train import TrainState, checkpoint as ckpt
from ..train.loop import train_model
from ..utils import handle_exception, swallow
from ..utils.device import resolve_device

__all__ = ["experiment", "run_exp", "check_for_continued",
           "plot_and_save_history", "compare_experiments",
           "get_logs_from_path", "fill_dict_with_name_fields",
           "effective_batch_size", "build_transform_pipelines",
           "apply_host_switches"]

#: cuBLAS's workspace setting for deterministic results
_CUBLAS_DETERMINISTIC = ":4096:8"


def _divisors(n: int) -> List[int]:
    out = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    return sorted(set(out + [n // d for d in out]))


def effective_batch_size(batch_size: int, max_bs: int, device_count: int,
                         model_factor: int = 1) -> int:
    """Largest divisor of the virtual batch whose *per-device* share stays
    within ``maximum_actual_batch_size``: the fragment size of the gradient
    accumulation (reference ``run_experiment.py:68-75`` is the one-device
    case).  Spatial sharding and tensor parallelism take *model_factor* of
    the devices, leaving ``device_count // model_factor`` on the data axis,
    and the fragment is shared by the largest of its divisors within that
    count, as the JAX CLI sizes it."""
    data_devices = max(device_count // max(int(model_factor), 1), 1)

    def per_device(d: int) -> int:
        return d // max(n for n in _divisors(d) if n <= data_devices)

    return max(d for d in _divisors(batch_size) if per_device(d) <= max_bs)


def _model_factor(tech: ConfigDict) -> Tuple[Optional[str], int]:
    """(the grid's inner axis, its size) from ``meta/technical``:
    ("model", tensor_parallel), ("spatial", spatial_sharding) or
    (None, 1)."""
    sp = int(tech.get("spatial_sharding", 1) or 1)
    tp = int(tech.get("tensor_parallel", 1) or 1)
    if sp > 1 and tp > 1:
        raise ValueError(
            "meta/technical/spatial_sharding and tensor_parallel are both "
            "above 1: the reference CLI does not offer both at once; use "
            "one of them with data parallelism")
    if tp > 1:
        return "model", tp
    if sp > 1:
        return "spatial", sp
    return None, 1


def _count_csv_rows(path: str) -> int:
    with open(path) as fh:
        return sum(1 for _ in csv.DictReader(fh))


def check_for_continued(modifiers: Optional[List[str]],
                        config_dict: ConfigDict):
    """Resume detection (reference ``run_experiment.py:584-596``): the last
    run directory under ``meta/technical/absolute_path``, and the epoch to
    resume from, min(rows of its epoch_logs.csv, the durable-epoch stamp
    ``checkpoint_epoch.pt``)."""
    continued = bool(modifiers) and "--continued" in modifiers
    run_start, epoch_start = 1, 0
    if continued:
        absolute_path = config_dict.get_str("meta/technical/absolute_path")
        num_epochs = config_dict["experiment/number_of_epochs"]
        while os.path.isdir(os.path.join(absolute_path,
                                         f"run_{run_start + 1}")):
            run_start += 1
        run_dir = os.path.join(absolute_path, f"run_{run_start}")
        epoch_start = _count_csv_rows(
            os.path.join(run_dir, "epoch_logs.csv"))
        # under async checkpointing a crash can leave epoch_logs.csv ahead
        # of the files on disk; the stamp is written after them, so resume
        # from the older of the two (re-run epochs append duplicate rows,
        # the honest record of what happened)
        stamp_path = os.path.join(run_dir, "checkpoint_epoch.pt")
        if os.path.exists(stamp_path):
            try:
                stamped = int(ckpt.load_params_file(stamp_path)["epoch"])
            except Exception:  # noqa: BLE001 - unreadable stamp: the CSV
                stamped = epoch_start
            if stamped < epoch_start:
                print(f"--continued: epoch_logs.csv has {epoch_start} "
                      f"rows but the last durable checkpoint is epoch "
                      f"{stamped}; resuming from {stamped}.", flush=True)
                epoch_start = stamped
        if num_epochs == epoch_start:
            run_start += 1
            epoch_start = 0
        # the counts were read off the filesystem, which rank 0 writes:
        # every process resumes from rank 0's position
        run_start, epoch_start = broadcast_from_main((run_start,
                                                      epoch_start))
    return continued, run_start, epoch_start


def fill_dict_with_name_fields(config_dict: ConfigDict, name_fields=None):
    """Append ``key_value`` tags from name_fields to the experiment name."""
    values: Dict[str, Any] = {}
    # falsy `or` (reference run_experiment.py:441): an empty name_fields
    # list also falls back to the config's own name_fields
    fields = name_fields or config_dict.get("meta/technical/name_fields", ())
    if not isinstance(fields, (list, tuple)):
        fields = [fields]

    for field in fields:
        has_default, default = False, None
        if isinstance(field, (ConfigDict, dict)):
            if not isinstance(field, ConfigDict):
                field = ConfigDict(field)
            path = field.key()
            spec = field.value()
            key = spec.get("keyword", path.split("/")[-1]) \
                if isinstance(spec, ConfigDict) else path.split("/")[-1]
            if isinstance(spec, ConfigDict) and "default" in spec:
                has_default, default = True, spec["default"]
        else:
            path = unescape(str(field))
            key = path.split("/")[-1]

        if path in config_dict:
            value = config_dict[path]
            if isinstance(value, (list, tuple)) and len(value) == 1:
                value = value[0]
            if isinstance(value, ConfigDict):
                try:
                    value = value.key()
                except ValueError:
                    continue
            if isinstance(value, str):
                value = value.split(".")[-1]
            values[key] = value
        elif has_default:
            values[key] = default

    tags = [f"{k}: {v}" for k, v in values.items()]
    if config_dict.get("meta/technical/log_to_device", True):
        name = str(config_dict.get("meta/technical/experiment name",
                                   "Experiment")).rstrip("_")
        for key, value in values.items():
            suffix = f"{key}_{value}"
            if suffix not in name:
                name = f"{name}_{suffix}"
        config_dict["meta/technical/experiment name"] = name
    return tags


_DEVICE_ABLE = {
    "segmentation.transforms.wrapped_transforms.RandomRotation",
    "segmentation.transforms.wrapped_transforms.RandomFlip",
    "transform.RepeatChannels",
}


def _split_device_augment(train_cfgs: List[ConfigDict]):
    """Split the train transform list into a device-side prefix (the
    standard rotation/flip/repeat chain, run in the train step on the card)
    and the host remainder.  Only a leading run of device-able transforms
    is lifted: the first host-only transform ends the prefix, so the
    configured order (and the augmentation distribution) is kept."""
    from ..ops.augment import make_device_augment

    kwargs: Dict[str, Any] = {}
    host: List[ConfigDict] = []
    prefix_open = True
    for cfg in train_cfgs:
        name = cfg if isinstance(cfg, str) else cfg.key()
        params = ConfigDict() if isinstance(cfg, str) else \
            (cfg.value() if isinstance(cfg.value(), ConfigDict)
             else ConfigDict())
        border = params.get("border_mode", "BORDER_CONSTANT")
        if isinstance(border, ConfigDict):
            border = border.key()
        family = ("rotation" if name.endswith("RandomRotation") else
                  "flip" if name.endswith("RandomFlip") else "repeat")
        lifted = {"rotation": "rotation_limit", "flip": "flip_probability",
                  "repeat": "channel_repeats"}[family] in kwargs
        if not prefix_open or name not in _DEVICE_ABLE or lifted or (
                family == "rotation" and border != "BORDER_CONSTANT"):
            # a second transform of an already-lifted family must not be
            # collapsed into the first (two rotations != one rotation)
            prefix_open = False
            host.append(cfg)
        elif family == "rotation":
            # the host transform's defaults, including the reference's
            # falsy-p coercion (``p or 1``)
            kwargs.update(
                rotation_limit=params.get("limit", 180),
                rotation_probability=params.get("p", None) or 1,
                fill=float(params.get("value", 0) or 0),
                mask_fill=float(params.get("mask_value", 0) or 0))
        elif family == "flip":
            kwargs.update(
                flip_vertical=bool(params.get("vertical", True)),
                flip_horizontal=bool(params.get("horizontal", False)),
                flip_probability=params.get(
                    "probability", params.get("p", None)) or 1)
        else:  # transform.RepeatChannels
            kwargs["channel_repeats"] = params.get("repeats", 3) or 3
    if not kwargs:
        return None, train_cfgs
    return make_device_augment(**kwargs), host


def build_transform_pipelines(config_dict: ConfigDict, seed: int,
                              device_augmentation: bool = False):
    """Train/val transform composition with partition and datapoint
    counting (reference ``run_experiment.py:80-107``).  With
    *device_augmentation* the standard train chain moves into the train
    step and out of the host pipeline."""
    transforms = {"train": [], "val": []}
    partition_count = {"train": None, "val": None}
    datapoint_count = {"train": 1, "val": 1}
    trsfs = config_dict.get_or_update(
        "data/transforms", ConfigDict({"train": [], "val": []}))
    device_augment = None
    cfg_lists = {ds_type: list(trsfs.elements_of(ds_type))
                 for ds_type in ("train", "val")}
    if device_augmentation:
        device_augment, cfg_lists["train"] = _split_device_augment(
            cfg_lists["train"])
    transform_idx = 0
    for ds_type in ("train", "val"):
        for tr_cfg in cfg_lists[ds_type]:
            # a distinct stream per transform: equal seeds would correlate
            # their gate decisions and draws
            transform_idx += 1
            transf = build_transform(
                tr_cfg, seed=None if seed is None
                else seed + 7919 * transform_idx)
            transforms[ds_type].append(transf)
            params = tr_cfg.value() if not isinstance(tr_cfg, str) else None
            if isinstance(params, ConfigDict) \
                    and "number of partitions" in params:
                partition_count[ds_type] = int(np.prod(
                    params.get_tuple("number_of_partitions")))
            datapoint_count[ds_type] = max(
                datapoint_count[ds_type],
                getattr(transf, "num_datapoints", 1))
    caster = ConvertToType(config_dict.get("data/transforms/casting",
                                           ConfigDict()))
    # uint8_transfer: images travel as uint8 and are divided by 255 on the
    # card (train/step._dequantize_inputs); the caster's float32 default
    # would widen x to 0-255 floats that the card does not scale, so 'x'
    # stays uint8 unless the config casts it
    ds_cfg = config_dict.get("data/data")
    ds_body = ds_cfg.value() if hasattr(ds_cfg, "value") else None
    if ds_body is not None and ds_body.get("uint8_transfer", False) \
            and "x" not in caster.types:
        caster.types["x"] = np.uint8
    train_pipeline = Compose(*transforms["train"], caster)
    val_pipeline = Compose(*transforms["val"], caster)
    return (train_pipeline, val_pipeline, partition_count, datapoint_count,
            device_augment)


def _refuse_parallelism(tech: ConfigDict, fragment_bs: int) -> None:
    """The layouts the processes cannot take.  One process runs per device
    under a launcher; several visible cards without one are refused rather
    than left idle.  Tensor parallelism and spatial sharding are not taken
    together (the reference CLI does not offer both at once), and their
    factor must not exceed the processes (the JAX CLI's "exceeds the
    available devices") and must divide them: a process cannot sit idle, so
    the count to run is named, as it is for a data axis that does not
    divide the fragment batch."""
    inner, factor = _model_factor(tech)
    knob = {"model": "tensor_parallel", "spatial": "spatial_sharding"}.get(
        inner)
    processes = device_count()
    if factor > processes:
        raise ValueError(
            f"meta/technical/{knob}: {factor} exceeds the {processes} "
            f"available devices (one process each); start {factor} or a "
            f"multiple of {factor} processes with torchrun")
    if processes % factor:
        raise ValueError(
            f"meta/technical/{knob}: {factor} must divide the {processes} "
            f"processes; run {processes - processes % factor}")
    if not launched() and torch.cuda.is_available() \
            and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} CUDA devices are visible to one "
            f"process: start one process per device with torchrun "
            f"(`torchrun --nproc_per_node {torch.cuda.device_count()} -m "
            f"medsegpretrainimagenet_tpu_torch.cli config.yaml`), or make "
            f"one visible with CUDA_VISIBLE_DEVICES")
    data = processes // factor
    if fragment_bs % data:
        divisors = [d for d in _divisors(fragment_bs) if d <= data]
        raise ValueError(
            f"{data} data-parallel processes must divide the fragment "
            f"batch size {fragment_bs} (data/sampling/batch_size within "
            f"meta/technical/maximum_actual_batch_size); run "
            f"{divisors[-1] * factor} processes, or a fragment batch that "
            f"{data} divides")


def apply_host_switches(tech: ConfigDict, device: torch.device) -> None:
    """The process-wide switches of ``meta/technical``, as the reference
    applies them (``run_experiment.py:53-65``): an RLIMIT memory cap
    (``memory_usage_limit``, a scalar or a (soft, hard) pair in GiB, -1
    off), ``use_deterministic_algorithms`` (torch's deterministic mode and
    cuDNN's deterministic algorithms; an operation without a deterministic
    CUDA kernel then raises), ``use_cudnn_benchmarking`` and
    ``number_of_cpu_threads``.  Deterministic cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` before its first call: it is set when
    unset, with a warning if CUDA is already initialised in this
    process."""
    mem_limit = tech.get("memory_usage_limit", -1)
    if isinstance(mem_limit, (int, float)):
        mem_limit = (mem_limit, mem_limit)
    mem_limit = [float(limit) for limit in mem_limit]
    if any(limit > 0 for limit in mem_limit):
        with swallow("Could not set the memory limit."):
            import resource
            resource.setrlimit(resource.RLIMIT_DATA, tuple(
                int(limit * 2 ** 30) if limit > 0 else resource.RLIM_INFINITY
                for limit in mem_limit))
    deterministic = bool(tech.get("use_deterministic_algorithms", False))
    if deterministic and "CUBLAS_WORKSPACE_CONFIG" not in os.environ:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = _CUBLAS_DETERMINISTIC
        if torch.cuda.is_initialized():
            warnings.warn("use_deterministic_algorithms: CUDA was initialised "
                          "before CUBLAS_WORKSPACE_CONFIG was set; cuBLAS "
                          "may not be deterministic in this process. Set "
                          f"CUBLAS_WORKSPACE_CONFIG={_CUBLAS_DETERMINISTIC} "
                          "before starting it.")
    torch.use_deterministic_algorithms(deterministic)
    torch.backends.cudnn.deterministic = deterministic
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = bool(
            tech.get("use_cudnn_benchmarking", True))
    threads = int(tech.get("number_of_cpu_threads", 0) or 0)
    if threads > 0:
        torch.set_num_threads(threads)


def experiment(config_dict: ConfigDict, original: Optional[dict] = None,
               series_id: Optional[str] = None,
               modifiers: Optional[List[str]] = None, device=None,
               *args, **kwargs):
    """Run all trials of one concrete experiment config on *device* (the
    card unless named)."""
    device = resolve_device(device)
    series_id = series_id or str(random.randint(0, int(1e16)))
    continued, run_start, epoch_start = check_for_continued(
        modifiers, config_dict)

    config_dict.expand()
    config_dict.fill_with_defaults(default_experiment_config())
    tech = config_dict["meta/technical"].trim()
    config_dict["meta/technical"] = tech

    BalancedDataLoader.fill_kwargs(
        config_dict.get_or_update("data/sampling", ConfigDict()))
    max_bs = tech["maximum actual batch size"]
    batch_size = config_dict["data/sampling/batch size"]
    inner, factor = _model_factor(tech)
    bs = effective_batch_size(batch_size, max_bs, device_count(), factor)
    _refuse_parallelism(tech, bs)
    if data_parallel():
        # data x model or data x spatial, as the JAX CLI lays out its mesh
        create_grid(("data", inner) if inner else ("data",),
                    (device_count() // factor, factor) if inner else None)
    apply_host_switches(tech, device)
    main_proc = is_main_process()

    seed = tech["seed"] + epoch_start

    (train_transforms, val_transforms, partition_count, datapoint_count,
     device_augment) = build_transform_pipelines(
        config_dict, seed,
        device_augmentation=tech.get("device_augmentation", False))

    for key in ("model", "training/loss", "data/data"):
        registry.fill_spec(config_dict, key)
    Model.fill_weight_init_kwargs(config_dict["model"].value())
    Optimizer.fill_kwargs(config_dict["training/optimizer"])
    MetricsCalculator.fill_kwargs(config_dict)

    try:
        added_tags = fill_dict_with_name_fields(config_dict)
    except Exception as exc:  # noqa: BLE001
        handle_exception(exc, "Exception while filling out name fields.")
        added_tags = []

    if not continued:
        save_destination = os.path.abspath(
            tech.get_or_update("save destination", "../logs/")) + "/"
        save_destination += str(datetime.now()).split(" ")[0] + "/"
        if main_proc:
            os.makedirs(save_destination, exist_ok=True)
        if tech["log to device"]:
            save_destination += str(tech["experiment_name"])
            i = 1
            if main_proc:
                while os.path.isdir(save_destination if i == 1
                                    else f"{save_destination}_{i}"):
                    i += 1
            # every process carries rank 0's suffix (it lands in the dumped
            # config, which a later --continued reads)
            (i,) = broadcast_from_main((i,))
            candidate = save_destination if i == 1 \
                else f"{save_destination}_{i}"
            save_destination = os.path.abspath(candidate) + "/"
            if main_proc:
                os.makedirs(save_destination)
            tech["server"] = socket.gethostname()
            tech["absolute path"] = save_destination
            tech["series_id"] = series_id
    else:
        save_destination = tech["absolute_path"]

    if tech["log_best_model"]:
        tech.get_or_update("model_evaluation", ConfigDict()) \
            .fill_with_defaults(default_model_eval)

    if not continued and tech["log to device"] and main_proc:
        config_dict["meta/technical/start time"] = \
            "".join(str(datetime.now()).split(".")[:-1])
        with open(save_destination + "config.yaml", "w") as fh:
            fh.write(dump_yaml(config_dict.trim().to_dict(
                lists_to_tuples=True)))
        if original is not None:
            with open(save_destination + "source_config.yaml", "w") as fh:
                fh.write(dump_yaml(original))

    num_trials = config_dict["experiment/number of trials"]
    for i in range(run_start, num_trials + 1):
        try:
            curr_seed = seed + i - 1
            curr_destination = save_destination + f"run_{i}/"

            ds_object = registry.build(config_dict["data/data"].trim(),
                                       wrapper=Dataset, seed=curr_seed)
            train_data = ds_object.train
            val_data = getattr(ds_object, "val", {})
            test_data = getattr(ds_object, "test", {})
            load_function = getattr(ds_object, "load_function", None)
            class_names = getattr(
                ds_object, "CLASSES",
                config_dict.get_str_tuple(
                    "metrics/calculation/class_names",
                    tuple(f"class_{j}" for j in range(config_dict.get(
                        "metrics/calculation/number_of_classes", 0) or 0))))

            # reference number_of_data_loader_workers: the loader's
            # parallel lazy-load pool; batches stay bit-identical
            num_workers = int(config_dict.get(
                "meta/technical/number_of_data_loader_workers", 0) or 0)
            # per-host input slicing: each process assembles only its
            # slice of every full batch
            proc_shard = None
            if config_dict.get("meta/technical/per_host_input_slicing",
                               False) and device_count() > 1:
                proc_shard = (rank(), device_count())

            def make_loader(data, split_cfg, pipeline, ds_type):
                return BalancedDataLoader(
                    data, split_cfg, bs=batch_size, actual_bs=bs,
                    transforms=pipeline,
                    partition_count=partition_count[ds_type],
                    load_function=load_function, seed=curr_seed,
                    datapoints_per_sample=datapoint_count[ds_type],
                    process_shard=proc_shard, num_workers=num_workers)

            train_ds = make_loader(train_data,
                                   config_dict["data/sampling/train"],
                                   train_transforms, "train")
            val_ds = make_loader(val_data, config_dict["data/sampling/val"],
                                 val_transforms, "val")
            test_ds = make_loader(test_data,
                                  config_dict["data/sampling/val"],
                                  val_transforms, "val") if test_data \
                else None

            run_exp(train_ds, val_ds, test_ds, curr_destination,
                    curr_seed + epoch_start * (run_start != i),
                    config_dict.trim(), batch_size, bs, idx=i,
                    class_names=class_names,
                    epoch_start=epoch_start * (i == run_start),
                    continued=continued and i == run_start,
                    device_augment=device_augment, device=device)

            extensions = tech.get_str_tuple("export_plots_as")
            compare_experiments(i, save_destination, extensions)
        except Exception as exc:  # noqa: BLE001
            handle_exception(
                exc, f"Exception occured in run {i} of experiment "
                     f"'{tech.get('experiment name')}'.")

    if tech["log to device"] and main_proc:
        modules = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for mod_name, mod in sys.modules.copy().items():
                try:
                    version = getattr(mod, "__version__", None)
                except Exception:  # noqa: BLE001 - lazy module attrs
                    continue
                if isinstance(version, str):
                    modules[mod_name] = version
        with open(save_destination + "environment.txt", "w") as fh:
            fh.writelines(f"{name}=={version}\n"
                          for name, version in sorted(modules.items()))

    if tech["log_to_device"]:
        return {"current_experiment": True,
                "exp_name": tech["experiment_name"],
                "save_path": save_destination,
                "num_trials": num_trials,
                "tags": added_tags}
    return {}


def run_exp(train_data, val_data, test_data, destination: str,
            curr_seed: int, config_dict: ConfigDict, batch_size: int,
            bs: int, idx: Optional[int] = None,
            class_names: Tuple[str, ...] = (), continued: bool = False,
            epoch_start: int = 0, device_augment=None, device=None,
            **kwargs):
    """One trial: build model, optimizer, loss and metrics, train, plot the
    history.  The model is initialised and its weights loaded on the host,
    then moved to *device* once."""
    device = resolve_device(device)
    tech = config_dict["meta/technical"]
    name = f"run_{idx}"
    log_to_device = tech.get("log to device", True)
    main_proc = is_main_process()
    if log_to_device and not continued and main_proc:
        os.makedirs(destination, exist_ok=True)

    np.random.seed(curr_seed)
    random.seed(curr_seed)
    torch.manual_seed(curr_seed)

    # bf16 activations and compute (parameters, loss and metric reductions
    # stay float32); off by default, as in the JAX package
    set_compute_dtype(
        torch.bfloat16 if tech.get("mixed_precision", False) else None)
    # remat: recompute the basic blocks' activations in the backward
    # (device memory for operations); set on every run, as the dtype
    set_remat(tech.get("remat", False))

    model = registry.build(config_dict, key="model", wrapper=Model)
    model_dict = config_dict["model"].value()
    inner, factor = _model_factor(tech)
    # the JAX package draws one batch here to initialise its parameters
    # from the batch's shapes; the draw advances the loader's and the
    # transforms' generators, so the port draws it as well and both
    # packages' epochs see the same batches
    first = next(iter(train_data))
    if inner == "spatial":
        check_supported(model.module, np.shape(first["x"])[1], factor)
    model.init(curr_seed)

    if continued:
        weights_path = os.path.join(destination, "last_model_state_dict.pt")
        model.module.load_state_dict(ckpt.load_params_file(weights_path))
        if main_proc:
            shutil.copy(weights_path, os.path.join(
                destination, "last_model_state_dict_checkpoint.pt"))
    else:
        model.init_weight(model_dict,
                          torch.Generator().manual_seed(curr_seed + 1))
    model.freeze_and_unfreeze(model_dict)
    trainable_mask = model.trainable_mask() if model.frozen_paths else None
    model.module.to(device)
    # data parallelism: every process starts from rank 0's weights
    put_replicated(model.module)

    batches_per_epoch = math.ceil(len(train_data) / batch_size * bs)
    optimizer = Optimizer(
        config_dict["training/optimizer"],
        num_epochs=config_dict["experiment/number_of_epochs"],
        batches_per_epoch=batches_per_epoch,
        trainable_mask=trainable_mask)
    state = TrainState.create(model.module, optimizer.init(model.module),
                              curr_seed + 2)
    if continued:
        opt_path = os.path.join(destination, "optimizer_state_dict.pt")
        if os.path.isfile(opt_path):
            restored = ckpt.load_state_file(opt_path)
            state.optimizer.load_state_dict(restored["optimizer"])
            state.step = int(restored["step"])
            state.micro_step = int(restored.get("micro_step",
                                                restored["step"]))
            if main_proc:
                shutil.copy(opt_path, os.path.join(
                    destination, "optimizer_state_dict_checkpoint.pt"))
    if inner == "model":
        # each model rank keeps its slice of the wide parameters and of
        # their moments (restored whole above); the files stay whole
        shard_train_state(model.module, state.optimizer,
                          min_channels=int(tech.get(
                              "tensor_parallel_min_channels", 256) or 256))

    prediction_index = int(config_dict.get("training/prediction_index", 0)
                           or 0)
    loss_fn = registry.build(config_dict, key="training/loss", wrapper=Loss,
                             default_prediction_index=prediction_index)
    to_validate = len(val_data) > 0
    calculator = MetricsCalculator(config_dict, loss=loss_fn,
                                   class_names=class_names,
                                   validate=to_validate)
    host_loggers = []
    if log_to_device:
        with swallow("Exception while building host loggers."):
            host_loggers = build_host_loggers(config_dict, destination,
                                              class_names=class_names)

    train_model(model, train_data, val_data if to_validate else None,
                test_data, config_dict, optimizer, state, loss=loss_fn,
                metrics_and_loss=calculator, name=name,
                virtual_batch_size=batch_size, true_batch_size=bs,
                verbose=config_dict.get("meta/technical/verbose", False),
                epoch_start=epoch_start,
                grad_clip_value=config_dict.get(
                    "training/gradient_clipping/max_value"),
                grad_clip_norm_type=config_dict.get(
                    "training/gradient_clipping/norm", 2.0) or 2.0,
                device=device, device_augment=device_augment,
                prediction_index=prediction_index, host_loggers=host_loggers)

    if log_to_device and tech.get("log metric and loss plots", False) \
            and main_proc:
        plot_destination = destination + "plots/"
        os.makedirs(plot_destination, exist_ok=True)
        extensions = tech.get_str_tuple("export_plots_as")
        plot_and_save_history(
            logs_path=destination + "epoch_logs.csv",
            destination=destination, plot_destination=plot_destination,
            baselines=config_dict.get("metrics/baselines", {}),
            name=name, extensions=extensions)


def _read_csv_columns(path: str) -> Dict[str, List[float]]:
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        return {}
    out: Dict[str, List[float]] = {k: [] for k in rows[0]}
    for row in rows:
        for key, value in row.items():
            try:
                out[key].append(float(value))
            except (TypeError, ValueError):
                out[key].append(float("nan"))
    return out


def get_argmixes(scores: List[float]) -> Dict[str, int]:
    """Best and soft-best epoch indices for best_scores.csv: both
    directions use "the first epoch at least as good as the final one" (a
    deliberate deviation from the reference, as in the JAX package)."""
    if len(scores) == 0:
        return {}
    mix = "max" if scores[0] <= scores[-1] else "min"
    argmix = getattr(np, f"arg{mix}")
    output = {"best_index": int(argmix(scores)) + 1}
    arr = (-1) ** (mix == "min") * np.array(scores)
    output["soft_best_index"] = int(np.argmax(arr >= arr[-1])) + 1
    return output


def plot_and_save_history(logs_path: str, destination: str,
                          plot_destination: str, name: str = "",
                          baselines=None, extensions=(), **kwargs):
    """Per-metric train/val history plots and best_scores.csv."""
    logs = _read_csv_columns(logs_path)
    # "epoch" is the resume key column, not a metric
    metric_names = [c for c in logs
                    if not c.startswith("val_") and c != "epoch"]
    argmixes: Dict[str, Dict[str, int]] = {}
    for metric in metric_names:
        metric_name = metric.split("/")[-1]
        ys = [logs[metric]]
        labels: List[str] = []
        if "val_" + metric in logs:
            scores = logs["val_" + metric]
            ys.append(scores)
            argmixes[metric] = get_argmixes(scores)
            labels = ["train", "validation"]
        plotter = GeneralPlotter(dict(
            Ys=ys, xlabel="epoch", ylabel=metric_name,
            legend={"labels": labels}, dirname=plot_destination,
            fname=metric_name + "_plot",
            baselines=_baselines_for_metric(metric_name, baselines or {})))
        export_plot(plotter, extensions)
        if metric == "learning_rate" or metric.startswith("lr_param_group"):
            plotter.yscale = "log"
            plotter.fname = metric_name + "_log_plot"
            export_plot(plotter, [e for e in extensions
                                  if e.lower().strip(".") != "json"])
    with open(destination + "best_scores.csv", "w", newline="") as fh:
        writer = csv.writer(fh)
        keys = sorted(argmixes)
        writer.writerow(["", *keys])
        for field in ("best_index", "soft_best_index"):
            writer.writerow([field, *(argmixes[k].get(field, "")
                                      for k in keys)])


def _baselines_for_metric(metric: str, all_baselines) -> Dict[str, list]:
    try:
        baselines = all_baselines.get(metric, {}) \
            if hasattr(all_baselines, "get") else {}
        if isinstance(baselines, ConfigDict):
            baselines = baselines.trim().to_dict()
        if isinstance(baselines, dict):
            pass
        elif isinstance(baselines, (list, tuple)):
            baselines = {f"baseline {i + 1}": b
                         for i, b in enumerate(baselines)}
        else:
            baselines = {"baseline": baselines}
        return {"labels": list(baselines.keys()),
                "values": list(baselines.values())}
    except Exception as exc:  # noqa: BLE001
        handle_exception(exc, f"Exception computing baselines for {metric}.")
        return {"labels": [], "values": []}


def compare_experiments(num_trials: int, save_path: str, extensions=()):
    """Multi-trial variance statistics and comparison plots (reference
    ``run_experiment.py:518-582``), written by the main process."""
    if num_trials < 2 or not is_main_process():
        return
    os.makedirs(save_path + "variance_comparisons", exist_ok=True)
    labels = [f"run {k}" for k in range(1, num_trials + 1)]
    metric_logs = [_read_csv_columns(save_path + f"run_{i + 1}/"
                                     "epoch_logs.csv")
                   for i in range(num_trials)]
    val_columns = [c for c in metric_logs[0]
                   if c.startswith("val_")
                   and all(c in logs for logs in metric_logs)]

    statistics: Dict[str, Dict[str, float]] = {}
    for metric_name in val_columns:
        values = [logs.get(metric_name, []) for logs in metric_logs]
        axis_name = metric_name.split("/")[-1]
        if axis_name.startswith("val_"):
            axis_name = axis_name[4:]
        ex_logs = max(values, key=len)
        if len(ex_logs) == 0:
            warnings.warn(f"None of the runs had logs for {axis_name}.")
            continue
        try:
            mix = "max" if ex_logs[0] <= ex_logs[-1] else "min"
            last_logs = [v[-1] for v in values if v]
            best_logs = [getattr(np, mix)(v) for v in values if v]
            statistics[axis_name] = {
                "mean_last_epoch": float(np.mean(last_logs)),
                "median_last_epoch": float(np.median(last_logs)),
                "std_last_epoch": float(np.std(last_logs)),
                f"mean_{mix}_values": float(np.mean(best_logs)),
                f"median_{mix}_values": float(np.median(best_logs)),
                f"std_{mix}_values": float(np.std(best_logs)),
            }
        except Exception as exc:  # noqa: BLE001
            handle_exception(exc, f"Exception computing variance statistics "
                                  f"for {axis_name}.")
        try:
            plotter = GeneralPlotter(dict(
                Ys=values, xlabel="epoch", ylabel=axis_name,
                legend={"labels": labels},
                dirname=save_path + "variance_comparisons/",
                fname=f"{axis_name}_comparison"))
            export_plot(plotter, extensions=extensions)
        except Exception as exc:  # noqa: BLE001
            handle_exception(exc, f"Exception plotting comparisons for "
                                  f"{axis_name}.")

    with open(save_path + "variance_comparisons/statistics.json", "w") as fh:
        json.dump(statistics, fh, indent=3, sort_keys=True)


def get_logs_from_path(experiment_path, name_fields=None):
    """Load a past experiment's log metadata for cross-run comparisons
    (its ``config.yaml`` is read with PyYAML)."""
    if isinstance(experiment_path, ConfigDict):
        experiment_path = experiment_path.key()
    # compare_to paths arrive with their '/'s escaped by config ingestion
    experiment_path = unescape(str(experiment_path))
    if not os.path.isdir(experiment_path):
        raise FileNotFoundError(
            f"Couldn't open logs from '{experiment_path}': no such dir.")
    cd_path = experiment_path.rstrip("/") + "/config.yaml"
    if not os.path.isfile(cd_path):
        raise FileNotFoundError(
            f"Couldn't open logs from '{cd_path}': no such file.")
    config_dict = ConfigDict.from_yaml(cd_path).trim()
    tech = config_dict["meta/technical"]
    if not tech.get("log_to_device", True):
        return {}
    return {"current_experiment": False,
            "exp_name": tech["experiment_name"],
            "save_path": tech["absolute_path"],
            "num_trials": config_dict["experiment/number_of_trials"],
            "tags": fill_dict_with_name_fields(config_dict, name_fields)}
