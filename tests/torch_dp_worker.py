"""One rank of a data-parallel run of the port on the CPU, started as a
process of its own by ``tests/test_torch_parallel.py``:

    python tests/torch_dp_worker.py step|cli RANK WORLD INIT_FILE OUT ARGS...

The ranks meet through ``file://INIT_FILE`` (no port to collide with other
test workers) on the gloo backend, with one CPU thread each.  ``step``
loads a U-Net state dict and a batch stack from ``ARGS[0]`` (a ``.pt``
file), takes the train step on this rank's slice and writes the step's
scalars, the state dict and the gathered eval values to ``OUT``.  ``cli``
runs the experiment CLI on ``ARGS`` (the config path) with ``--device
cpu``.  Imports nothing of JAX."""
import os
import sys

import torch


def _join(rank: int, world: int, init_file: str) -> None:
    from medsegpretrainimagenet_tpu_torch.parallel import \
        initialize_distributed
    initialize_distributed("cpu", init_method=f"file://{init_file}",
                           rank=rank, world_size=world)


def _step(payload_path: str, out: str) -> None:
    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.optim import Optimizer
    from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                        make_eval_step,
                                                        make_train_step)

    payload = torch.load(payload_path, weights_only=False)
    cd = ConfigDict(payload["model_config"])
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.module.load_state_dict(payload["state_dict"])
    parallel.put_replicated(model.module)
    optimizer = Optimizer(ConfigDict(payload["optimizer"]), num_epochs=1,
                          batches_per_epoch=len(payload["batches"]))
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=1)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict(payload["metrics"]), loss=loss)
    step = make_train_step(model, loss, calculator, optimizer,
                           grad_clip_value=payload["clip"])
    metrics_state, logs = calculator.init_state("cpu"), []
    for batch in payload["batches"]:
        state, metrics_state, per_batch = step(
            state, metrics_state,
            parallel.shard_batch({k: torch.from_numpy(v)
                                  for k, v in batch.items()}))
        logs.append({k: v.item() if isinstance(v, torch.Tensor) else v
                     for k, v in per_batch.items()})
    evaluate = make_eval_step(model, loss, calculator)
    held = {k: torch.from_numpy(v) for k, v in payload["held"].items()}
    eval_state, eval_batch = evaluate(
        state, calculator.init_state("cpu"), parallel.shard_batch(held))
    torch.save({"logs": logs,
                "epoch": calculator.finalize_epoch(metrics_state),
                "state_dict": model.module.state_dict(),
                "eval_loss": eval_batch["dice_loss"].item(),
                "eval_epoch": calculator.finalize_epoch(eval_state)}, out)


_SAVED = {}


def _watch_writes(root: str) -> list:
    """Record every file or directory that this process creates or writes
    under *root* (opens for writing, makedirs, replace, copy)."""
    import builtins
    import shutil
    root = os.path.abspath(root)
    writes: list = []
    _SAVED.update(open=builtins.open, makedirs=os.makedirs,
                  replace=os.replace, copy=shutil.copy)

    def under(path) -> bool:
        try:
            return os.path.abspath(os.fspath(path)).startswith(root)
        except TypeError:
            return False

    def watched_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+") and under(file):
            writes.append(f"open {file}")
        return _SAVED["open"](file, mode, *a, **k)

    def watched_makedirs(name, *a, **k):
        if under(name):
            writes.append(f"makedirs {name}")
        return _SAVED["makedirs"](name, *a, **k)

    def watched_replace(src, dst, *a, **k):
        if under(dst):
            writes.append(f"replace {dst}")
        return _SAVED["replace"](src, dst, *a, **k)

    def watched_copy(src, dst, *a, **k):
        if under(dst):
            writes.append(f"copy {dst}")
        return _SAVED["copy"](src, dst, *a, **k)

    builtins.open, os.makedirs = watched_open, watched_makedirs
    os.replace, shutil.copy = watched_replace, watched_copy
    return writes


def _unwatch() -> None:
    import builtins
    import shutil
    if _SAVED:
        builtins.open, os.makedirs = _SAVED["open"], _SAVED["makedirs"]
        os.replace, shutil.copy = _SAVED["replace"], _SAVED["copy"]


def main(argv) -> None:
    mode, rank, world, init_file, out, *args = argv
    torch.set_num_threads(1)
    _join(int(rank), int(world), init_file)
    try:
        if mode == "step":
            _step(args[0], out)
        elif mode == "cli":
            from medsegpretrainimagenet_tpu_torch.cli.experiment import \
                main as cli_main
            config, logs = args
            writes = _watch_writes(logs) if int(rank) else []
            cli_main([config, "--device", "cpu"])
            _unwatch()
            with open(out, "w") as fh:
                fh.write("".join(f"{w}\n" for w in writes) if writes
                         else ("no writes\n" if int(rank) else "done\n"))
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1:])
