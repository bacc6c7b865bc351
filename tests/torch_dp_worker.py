"""One rank of a multi-process run of the port on the CPU, started as a
process of its own by ``tests/test_torch_parallel.py``,
``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_spatial.py``
and ``tests/test_torch_pipeline.py``:

    python tests/torch_dp_worker.py MODE RANK WORLD INIT_FILE OUT ARGS...

The ranks meet through ``file://INIT_FILE`` (no port to collide with other
test workers) on the gloo backend, with one CPU thread each.  ``step``
loads a model config, its state dict and batch stacks from ``ARGS[0]`` (a
``.pt`` file), lays the ranks out on the payload's ``grid`` (data x model
with ``tp_min_channels``, data x spatial), takes the train steps on this
rank's slice and writes the step's scalars, the whole state dict and the
gathered eval values to ``OUT`` (for each of the payload's ``runs``, if it
has them); a run may name its ``loss`` (Dice on masks by default), its
device augmentation's kind (``augment_kind``: the segmentation chain, or
``classification``), the Swin blocks' ``fused_image`` mode and ``remat``.
``forward`` runs the eval forward of a model on this rank's slice and
rows (in the payload's ``fused_image`` mode) and writes the gathered
output.  ``roll`` holds ``spatial.roll_rows`` against ``torch.roll`` of
the whole image, forward and backward.
``pipeline`` runs ``parallel.pipeline_apply`` on the payload's cases.
``shared_card`` (``tests/test_torch_parallel_gpu.py``) runs the column-
parallel layers, the halo exchanges and the pipeline hand-off with the
ranks sharing the card.
``cli`` runs the experiment CLI on ``ARGS`` (the config path) with
``--device cpu``.  Imports nothing of JAX."""
import os
import sys

import torch


def _join(rank: int, world: int, init_file: str, card: bool) -> None:
    """Join the gloo group: on the CPU, or on the card that the ranks
    share (gloo named, as NCCL refuses two ranks on one device)."""
    from medsegpretrainimagenet_tpu_torch.parallel import \
        initialize_distributed
    initialize_distributed("cuda:0" if card else "cpu",
                           init_method=f"file://{init_file}", rank=rank,
                           world_size=world, backend="gloo")


def _step(payload_path: str, out: str) -> None:
    """The payload's steps (or each of its ``runs``, in turn) on this
    rank."""
    payload = torch.load(payload_path, weights_only=False)
    results = [_train(run) for run in payload.get("runs", [payload])]
    torch.save(results if "runs" in payload else results[0], out)


def _train(payload) -> dict:
    from medsegpretrainimagenet_tpu_torch import losses, parallel
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.models.blocks import set_remat
    from medsegpretrainimagenet_tpu_torch.ops import augment as augments
    from medsegpretrainimagenet_tpu_torch.ops import set_fused_image_mode
    from medsegpretrainimagenet_tpu_torch.optim import Optimizer
    from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                        make_eval_step,
                                                        make_train_step)

    layout = _grid(payload)
    model = _model(payload)
    parallel.put_replicated(model.module)
    optimizer = Optimizer(ConfigDict(payload["optimizer"]), num_epochs=1,
                          batches_per_epoch=len(payload["batches"]))
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=1)
    plan = {}
    if payload.get("tp_min_channels"):
        plan = parallel.shard_train_state(
            model.module, state.optimizer,
            min_channels=payload["tp_min_channels"])
    set_fused_image_mode(payload.get("fused_image", "off"))
    set_remat(payload.get("remat", False))
    loss_name, loss_params = payload.get("loss",
                                         ("DiceLoss", {"label type": "mask"}))
    loss = losses.Loss(getattr(losses, loss_name), ConfigDict(loss_params))
    calculator = MetricsCalculator(ConfigDict(payload["metrics"]), loss=loss)
    augment = payload.get("augment")
    make_augment = augments.make_classification_device_augment \
        if payload.get("augment_kind") == "classification" \
        else augments.make_device_augment
    step = make_train_step(model, loss, calculator, optimizer,
                           grad_clip_value=payload["clip"],
                           device_augment=make_augment(**augment)
                           if augment else None)
    # the loop cuts the rows unless the step augments the whole image
    spatial = "spatial" if layout.size("spatial") > 1 and not augment \
        else None
    metrics_state, logs = calculator.init_state("cpu"), []
    for batch in payload["batches"]:
        state, metrics_state, per_batch = step(
            state, metrics_state,
            parallel.shard_batch({k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                                 spatial_axis=spatial))
        logs.append({k: v.item() if isinstance(v, torch.Tensor) else v
                     for k, v in per_batch.items()})
    evaluate = make_eval_step(model, loss, calculator)
    held = {k: torch.from_numpy(v) for k, v in payload["held"].items()}
    eval_state, eval_batch = evaluate(
        state, calculator.init_state("cpu"),
        parallel.shard_batch(held, spatial_axis=spatial))
    return {"logs": logs,
                "epoch": calculator.finalize_epoch(metrics_state),
                "state_dict": parallel.full_state_dict(model.module),
                "optimizer": parallel.full_optimizer_state_dict(
                    state.optimizer),
                "plan": plan,
                "local_shapes": {name: tuple(p.shape) for name, p in
                                 model.module.named_parameters()},
                "eval_loss": eval_batch[loss.name].item(),
                "eval_epoch": calculator.finalize_epoch(eval_state)}


def _grid(payload):
    """The payload's grid, ``(axis names, shape)``, or every rank on the
    data axis."""
    from medsegpretrainimagenet_tpu_torch import parallel
    names, shape = payload.get("grid", (("data",), None))
    return parallel.create_grid(names, shape)


def _model(payload):
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model
    cd = ConfigDict(payload["model_config"])
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.module.to(payload.get("dtype", torch.float32))
    model.module.load_state_dict(payload["state_dict"])
    return model


def _forward(payload_path: str, out: str) -> None:
    """The eval forward of the payload's model on this rank's samples and
    rows (the payload's ``x``, NHWC), gathered back (for each of the
    payload's ``runs``, if it has them)."""
    payload = torch.load(payload_path, weights_only=False)
    results = [_forward_one(run) for run in payload.get("runs", [payload])]
    torch.save(results if "runs" in payload else results[0], out)


def _forward_one(payload) -> dict:
    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.ops import set_fused_image_mode
    from medsegpretrainimagenet_tpu_torch.parallel.spatial import row_shards

    layout = _grid(payload)
    set_fused_image_mode(payload.get("fused_image", "off"))
    module = _model(payload).module.eval()
    batch = parallel.shard_batch({"x": torch.from_numpy(payload["x"])},
                                 batch_dim=0, spatial_axis="spatial")
    with torch.no_grad(), row_shards(layout.inner):
        local = module(batch["x"])
    labels = payload.get("labels", {})
    return {"out": parallel.gather_shards(local, rows=True),
            "local_shape": tuple(local.shape),
            "batch_shapes": {k: tuple(v.shape) for k, v in
                             parallel.shard_batch(
                                 {k: torch.from_numpy(v) for k, v in
                                  labels.items()},
                                 spatial_axis="spatial").items()
                             if isinstance(v, torch.Tensor)}}


def _roll(payload_path: str, out: str) -> None:
    """``spatial.roll_rows`` by each of the payload's shifts on this rank's
    band of the payload's ``x`` (data x spatial 1 x world), and the
    gradient of the gathered sum with the payload's ``cotangent``: writes
    the gathered rolls and this band's gradients."""
    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.parallel import spatial

    payload = torch.load(payload_path, weights_only=False)
    axis = parallel.create_grid(("data", "spatial"),
                                (1, parallel.device_count())).inner
    result = {}
    for shift in payload["shifts"]:
        band = parallel.split_rows({"x": payload["x"]}, axis)["x"] \
            .clone().requires_grad_()
        with spatial.row_shards(axis):
            rolled = spatial.roll_rows(band, shift)
        whole = parallel.gather_axis(rolled, 1, axis)
        (whole * payload["cotangent"]).sum().backward()
        result[shift] = (whole.detach(), band.grad)
    torch.save(result, out)


def _shared_card(payload_path: str, out: str) -> None:
    """Two ranks sharing the card over gloo (joined by :func:`main` on
    ``cuda:0``): a column-parallel conv and dense layer (data x model
    1 x 2), a conv and a max pool on bands of rows with their halos (data x
    spatial 1 x 2) and a pipeline of two stages (data x pipe 1 x 2), each
    forward and backward; rank 0 writes the max |parallel - one process|
    of each, over the largest value, taken on the card without a
    collective."""
    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.models.blocks import (Conv, Dense,
                                                                MaxPool2d)
    from medsegpretrainimagenet_tpu_torch.parallel.spatial import row_shards

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    main = parallel.rank() == 0
    generator = torch.Generator().manual_seed(0)
    errors = {}

    def rel(got, want):
        return ((got - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    def run(module, x, sharded=None, rows=None):
        """Output and gradients of *module* on *x* with a fixed
        cotangent: whole on one process, or on this rank's shard."""
        module = module.to(device)
        module.zero_grad(set_to_none=True)
        leaf = x.to(device).requires_grad_()
        inp = leaf
        if rows is not None:
            inp = parallel.split_rows({"x": leaf}, rows)["x"]
        with row_shards(rows):
            y = module(inp)
        if rows is not None:
            y = parallel.gather_shards(y, rows=True)
        # of one sign: the bias gradients' sums do not cancel
        cotangent = torch.linspace(0.1, 1, y.numel(),
                                   device=device).reshape(y.shape)
        (y * cotangent).sum().backward()
        if rows is not None:  # each band holds its share
            for grad in [leaf.grad] + [p.grad for p in module.parameters()]:
                torch.distributed.all_reduce(grad, group=rows.group)
        params = parallel.full_state_dict(module) if sharded else {}
        grads = {name: (parallel.gather_axis(p.grad, 0, sharded)
                        if getattr(p, "_tp_shard", None) else p.grad)
                 for name, p in module.named_parameters()}
        return y.detach(), leaf.grad, grads, params

    for name, make, shape in (
            ("column-parallel conv", lambda: Conv(32, 256, 3,
                                                  padding="SAME"),
             (2, 16, 16, 32)),
            ("column-parallel dense", lambda: Dense(64, 512), (2, 49, 64))):
        torch.manual_seed(1)
        whole = make()
        x = torch.randn(shape, generator=generator)
        want = run(whole, x) if main else None
        layout = parallel.create_grid(("data", "model"), (1, 2))
        torch.manual_seed(1)
        module = make().to(device)
        optimizer = torch.optim.SGD(module.parameters(), lr=0.1)
        parallel.shard_train_state(module, optimizer, min_channels=256)
        got = run(module, x, sharded=layout.inner)
        if main:
            errors[name] = max(
                rel(got[0], want[0]), rel(got[1], want[1]),
                *(rel(got[2][k], want[2][k]) for k in want[2]))
    layout = parallel.create_grid(("data", "spatial"), (1, 2))
    for name, make in (("halo conv 3 x 3", lambda: Conv(8, 8, 3,
                                                        padding="SAME")),
                       ("halo conv 7 x 7 / 2", lambda: Conv(
                           8, 8, 7, stride=2, padding=((3, 3), (3, 3)))),
                       ("halo max pool 3 x 3 / 2", lambda: MaxPool2d(
                           3, 2, padding=1))):
        torch.manual_seed(2)
        whole = make()
        x = torch.randn((2, 32, 24, 8), generator=generator)
        want = run(whole, x) if main else None
        got = run(whole, x, rows=layout.inner)
        if main:
            errors[name] = max(rel(got[0], want[0]), rel(got[1], want[1]),
                               *(rel(got[2][k], want[2][k])
                                 for k in want[2]))
    parallel.create_grid(("data", "pipe"), (1, 2))
    stages = [{"w": torch.randn((16, 16), generator=generator) * 0.4,
               "b": torch.randn((16,), generator=generator) * 0.1}
              for _ in range(2)]
    stacked = {k: v.to(device).requires_grad_() for k, v in
               parallel.stack_stage_params(stages).items()}
    x = torch.randn((8, 16), generator=generator).to(device)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    y = parallel.pipeline_apply(stage_fn, stacked, x, num_microbatches=4)
    (y ** 2).mean().backward()
    grads = {k: v.grad.clone() for k, v in stacked.items()}
    for grad in grads.values():
        torch.distributed.all_reduce(grad, group=parallel.grid().inner.group)
    if main:
        seq = {k: v.detach().clone().requires_grad_()
               for k, v in stacked.items()}
        h = x
        for i in range(2):
            h = stage_fn({k: v[i] for k, v in seq.items()}, h)
        (h ** 2).mean().backward()
        errors["pipeline hand-off"] = max(
            rel(y.detach(), h.detach()),
            *(rel(grads[k], seq[k].grad) for k in grads))
        torch.save(errors, out)


def _pipeline(payload_path: str, out: str) -> None:
    """``pipeline_apply`` on each of the payload's cases: the outputs, and
    with a ``target`` the loss and the stacked gradients summed over the
    pipe group (each stage holds its own row's)."""
    from torch.func import functional_call

    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.models import swin  # noqa: F401
    from medsegpretrainimagenet_tpu_torch.config import registry

    payload = torch.load(payload_path, weights_only=False)
    results = {}
    for case in payload["cases"]:
        layout = parallel.create_grid(*case["grid"])
        if case.get("block"):
            block = registry.resolve(case["block"][0])(**case["block"][1])
            block.eval()

            def stage_fn(params, x, block=block):
                return functional_call(block, params, (x,))
        else:
            def stage_fn(params, x):
                return torch.tanh(x @ params["w"] + params["b"])
        stacked = {k: torch.from_numpy(v).requires_grad_()
                   for k, v in case["stacked"].items()}
        x = torch.from_numpy(case["x"])
        if case.get("data_axis"):
            x = x.chunk(layout.data.size)[layout.data.index]
        if case.get("shard_io"):
            x = x.chunk(layout.inner.size)[layout.inner.index]
        y = parallel.pipeline_apply(
            stage_fn, stacked, x, num_microbatches=case["m"],
            data_axis=case.get("data_axis"), shard_io=case.get("shard_io",
                                                               False))
        result = {"y": y.detach()}
        if "target" in case:
            target = torch.from_numpy(case["target"])
            if case.get("shard_io"):
                # each stage's share of the mean over the whole batch
                target = target.chunk(layout.inner.size)[layout.inner.index]
                loss = ((y - target) ** 2).sum() / case["target"].size
            else:
                loss = ((y - target) ** 2).mean()
            loss.backward()
            grads = {k: v.grad.clone() for k, v in stacked.items()}
            for grad in grads.values():
                torch.distributed.all_reduce(grad,
                                             group=layout.inner.group)
            result.update(loss=loss.detach(), grads=grads)
        results[case["name"]] = result
    torch.save(results, out)


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
    _join(int(rank), int(world), init_file, mode == "shared_card")
    try:
        if mode == "step":
            _step(args[0], out)
        elif mode == "forward":
            _forward(args[0], out)
        elif mode == "pipeline":
            _pipeline(args[0], out)
        elif mode == "roll":
            _roll(args[0], out)
        elif mode == "shared_card":
            _shared_card(None, out)
        elif mode == "cli":
            from medsegpretrainimagenet_tpu_torch.cli.experiment import \
                main as cli_main
            config, logs, *modifiers = args
            writes = _watch_writes(logs) if int(rank) else []
            cli_main([config, *modifiers, "--device", "cpu"])
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
