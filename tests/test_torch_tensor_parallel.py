"""Tensor parallelism (``medsegpretrainimagenet_tpu_torch.parallel.tp``) on
the CPU against the JAX package's (``parallel/tp.py``) on the 8-device CPU
mesh: gloo ranks, each a process of its own (``tests/torch_dp_worker.py``),
meeting through a ``file://`` rendezvous.

* The U-Net train step of ``tests/test_parallel.py``'s
  ``test_tensor_parallel_2d_mesh_step`` (the same module, batch and
  optimizer, ``min_channels=8``, here with a gradient clip, so the norm of
  the sharded gradients counts) on data x model 1 x 2 and 2 x 2: the
  JAX step on its 4 x 2 mesh and the port's ranks take the same loss
  (1e-5) and gradient norm, and end with the same parameters (the JAX
  test's bars, 1e-4 relative and 1e-6 absolute) and optimizer moments; the
  port shards exactly the parameters that the JAX rule shards.
* Optimizer moments follow their parameter, never a same-shaped other one
  (``test_tp_optimizer_state_follows_param_paths``); wide biases and
  scales are sharded (``test_tp_shards_wide_biases_and_scales``).
* The experiment CLI with ``tensor_parallel: 2`` under two ranks writes the
  JAX CLI's ``epoch_logs.csv`` (1e-4), then a second epoch under
  ``--continued`` (the whole files sliced again) the JAX CLI's second row;
  its checkpoint files are whole and load into a one-process run."""
import jax
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as P

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.parallel import (create_mesh, shard_batch,
                                                 shard_train_state,
                                                 tensor_parallel_shardings)
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch import transfer
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models.blocks import Dense
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.parallel import tp
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

from torch_port_helpers import (assert_same_logs, build_model, cli_run_dir,
                                csv_rows, parallel_cli_config, run_jax_cli,
                                spawn_cli, spawn_ranks, transplant,
                                unet_config, write_cli_tree)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8-device CPU mesh")

LOSS_TOL, RTOL, ATOL, CLI_TOL = 1e-5, 1e-4, 1e-6, 1e-4
MIN_CHANNELS, CLIP, STEPS = 8, 0.05, 2
OPTIMIZER = {"sgd": {"momentum": 0.9,
                     "learning_rate": {"constant": {"base": 0.05}}}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex",),
                       "calculation": {"thresholds": 0.5,
                                       "label_type": "mask"}}}
MODEL = unet_config(channels=(4, 8), in_channels=1)
CLI_ARCH = {"in_channel_size": 3, "out_channel_size": 1, "channels": (4, 8),
            "depth": 1}


def _batch(seed, n=16, frag=2):
    """``tests/test_parallel.py``'s ``_batch``: float images and the mask
    of their bright pixels."""
    rng = np.random.default_rng(seed)
    x = rng.random((frag, n, 16, 16, 1)).astype(np.float32)
    return {"x": x, "mask": (x[..., 0] > 0.6).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_tp_run():
    """The JAX step on the 4 x 2 data x model mesh, STEPS steps from the
    same variables: (variables, per-step logs, final params and batch
    statistics, the shardings of the parameters)."""
    model = build_model(JaxConfigDict, jax_registry, JaxModel, MODEL)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), {"x": np.zeros((1, 16, 16, 1), np.float32)}))
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=STEPS)
    state = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]),
        jax.random.key(1))
    loss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    calculator = JaxCalculator(JaxConfigDict(METRICS), loss=loss)
    step = jax_train_step(model, loss, calculator, optimizer,
                          grad_clip_value=CLIP, donate=False)
    mesh = create_mesh(("data", "model"), shape=(4, 2))
    shardings = tensor_parallel_shardings(state.params, mesh,
                                          min_channels=MIN_CHANNELS)
    state = shard_train_state(state, mesh, min_channels=MIN_CHANNELS)
    metrics_state, logs = calculator.init_state(), []
    with mesh:
        for seed in range(STEPS):
            state, metrics_state, per_batch = step(
                state, metrics_state,
                shard_batch(_batch(seed), mesh, batch_dim=1))
            logs.append({k: float(v) for k, v in
                         jax.device_get(per_batch).items()})
    final = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    return variables, logs, final, shardings


def _port_module():
    return build_model(ConfigDict, registry, Model, MODEL).module


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tensor_parallel_step_equals_jax(jax_tp_run, tmp_path, grid):
    variables, jlogs, final, shardings = jax_tp_run
    state_dict = transplant(variables, _port_module()).state_dict()
    world = grid[0] * grid[1]
    payload = tmp_path / "payload.pt"
    torch.save({"grid": (("data", "model"), grid), "model_config": MODEL,
                "state_dict": state_dict, "optimizer": OPTIMIZER,
                "metrics": METRICS, "clip": CLIP,
                "tp_min_channels": MIN_CHANNELS,
                "batches": [_batch(seed) for seed in range(STEPS)],
                "held": _batch(9, n=4, frag=1)}, payload)
    spawn_ranks("step", world, tmp_path, [f"r{r}.pt" for r in range(world)],
                payload)
    want = transplant(final, _port_module()).state_dict()
    # the parameters that the JAX rule shards, by their port names
    jax_sharded = {
        transfer._torch_name(tuple(str(getattr(k, "key", k)) for k in path))
        for path, sharding in jax.tree_util.tree_flatten_with_path(
            shardings)[0] if sharding.spec != P()}
    assert len(jax_sharded) >= 4
    for r in range(world):
        got = torch.load(tmp_path / f"r{r}.pt", weights_only=False)
        assert {name for name, dim in got["plan"].items()
                if dim is not None} == jax_sharded
        for name in jax_sharded:
            assert got["local_shapes"][name][0] * 2 \
                == tuple(want[name].shape)[0], name
        for k, (row, jrow) in enumerate(zip(got["logs"], jlogs)):
            for key in ("dice_loss", "gradient_magnitude"):
                np.testing.assert_allclose(row[key], jrow[key],
                                           rtol=LOSS_TOL, atol=LOSS_TOL,
                                           err_msg=f"rank {r} step {k} {key}")
            assert row["gradient_magnitude"] > CLIP  # the clip applied
        for name, value in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got["state_dict"][name].numpy(),
                                       value.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {name}")
        # the whole moments: one per trainable parameter, of its shape
        moments = got["optimizer"]["state"]
        params = [p for p in _port_module().parameters()]
        assert len(moments) == len(params)
        for index, param in enumerate(params):
            assert moments[index]["momentum_buffer"].shape == param.shape


class _SameShapes(torch.nn.Module):
    """``test_tp_optimizer_state_follows_param_paths``'s tree: a dense
    kernel (in 4, out 8) and a same-shaped ``table`` leaf."""

    def __init__(self):
        super().__init__()
        self.a = Dense(4, 8, use_bias=False)
        self.table = torch.nn.Parameter(torch.ones(8, 4))


def test_moments_follow_their_parameter(monkeypatch):
    """The same tree in JAX shards the kernel and its momentum, and leaves
    the table and its momentum whole; the port slices the moments of the
    sharded parameter only, here on model rank 1 of 2."""
    module = _SameShapes()
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=1).init(module)
    (module.a.weight.sum() * 2 + module.table.sum()).backward()
    optimizer.step()
    axis = tp.Axis.__new__(tp.Axis)
    axis.name, axis.size, axis.index, axis.group = "model", 2, 1, object()
    monkeypatch.setattr(tp, "grid", lambda: type(
        "G", (), {"axis": staticmethod(lambda name: axis)})())
    momentum = optimizer.state[module.a.weight]["momentum_buffer"].clone()
    plan = tp.shard_train_state(module, optimizer, min_channels=8)
    assert plan == {"a.weight": 0, "table": None}
    assert tuple(module.a.weight.shape) == (4, 4)
    assert tuple(module.table.shape) == (8, 4)
    torch.testing.assert_close(
        optimizer.state[module.a.weight]["momentum_buffer"], momentum[4:])
    assert tuple(optimizer.state[module.table]["momentum_buffer"].shape) \
        == (8, 4)
    # the JAX rule on the same tree
    mesh = create_mesh(("data", "model"), shape=(4, 2))
    specs = tensor_parallel_shardings(
        {"a": {"kernel": np.ones((4, 8))}, "b": {"table": np.ones((4, 8))}},
        mesh, min_channels=8)
    assert specs["a"]["kernel"].spec == P(None, "model")
    assert specs["b"]["table"].spec == P()


def test_wide_biases_and_scales_are_sharded():
    """``test_tp_shards_wide_biases_and_scales``'s tree: the dense kernel
    and bias and the norm's 512-wide scale shard, its 8-wide bias does
    not, in both packages."""
    module = torch.nn.Module()
    module.dense = Dense(128, 512)
    module.norm = torch.nn.Module()
    module.norm.weight = torch.nn.Parameter(torch.ones(512))
    module.norm.bias = torch.nn.Parameter(torch.ones(8))
    plan = tp.tensor_parallel_shardings(module, 2, min_channels=256)
    assert plan == {"dense.weight": 0, "dense.bias": 0, "norm.weight": 0,
                    "norm.bias": None}
    mesh = create_mesh(("data", "model"), shape=(4, 2))
    specs = tensor_parallel_shardings(
        {"dense": {"kernel": np.ones((128, 512)), "bias": np.ones((512,))},
         "norm": {"scale": np.ones((512,)), "bias": np.ones((8,))}},
        mesh, min_channels=256)
    assert [specs["dense"]["kernel"].spec, specs["dense"]["bias"].spec,
            specs["norm"]["scale"].spec, specs["norm"]["bias"].spec] \
        == [P(None, "model"), P("model"), P("model"), P()]


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_cli"), write_cli_tree(
        tmp_path_factory.getbasetemp() / "tp_tree", CLI_ARCH)


def test_cli_under_tensor_parallelism_writes_the_jax_logs(cli_tree,
                                                          tmp_path):
    """An epoch with ``tensor_parallel: 2`` (min channels 8) under two
    ranks, then a second under ``--continued``, against the JAX CLI's same
    two runs on its data x model mesh."""
    _, (data, jax_weights, port_weights) = cli_tree
    runs = {}
    for kind, weights in (("jax", jax_weights), ("port", port_weights)):
        logs = tmp_path / f"{kind}_logs"
        for epochs in (1, 2):
            cfg = parallel_cli_config(
                logs, weights, CLI_ARCH, epochs=epochs, tensor_parallel=2,
                tensor_parallel_min_channels=MIN_CHANNELS)
            modifiers = ()
            if epochs == 2:
                cfg["meta"]["technical"]["absolute_path"] = \
                    str(cli_run_dir(logs).parent) + "/"
                modifiers = ("--continued",)
            path = tmp_path / f"{kind}_{epochs}.yaml"
            path.write_text(yaml.dump(cfg))
            if kind == "jax":
                run_jax_cli(path, data, *modifiers)
            else:
                spawn_cli(2, tmp_path, path, logs, data, *modifiers)
        runs[kind] = cli_run_dir(logs)
    assert len(csv_rows(runs["port"] / "epoch_logs.csv")) == 2
    assert_same_logs(runs["port"], runs["jax"], CLI_TOL)
    # whole files: they load into a one-process model and optimizer
    model = build_model(ConfigDict, registry, Model,
                        {"model": {"segmentation.models.UNet": {
                            "architecture": CLI_ARCH}}})
    model.module.load_state_dict(ckpt.load_params_file(
        str(runs["port"] / "last_model_state_dict.pt")))
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=2,
                          batches_per_epoch=4).init(model.module)
    restored = ckpt.load_state_file(
        str(runs["port"] / "optimizer_state_dict.pt"))["optimizer"]
    optimizer.load_state_dict(restored)
    for index, param in enumerate(model.module.parameters()):
        assert restored["state"][index]["momentum_buffer"].shape \
            == param.shape
