"""Block rematerialisation in the port (``blocks.set_remat``,
``maybe_remat``, ``meta/technical/remat``) on the CPU.

* Against the JAX package: a two-level conv U-Net (channels 8, 16) and a
  small ``DeepResNet`` attention U-Net, one float32 SGD step with remat on
  in both packages from the same weights, agree at the step tests' 1e-4
  (loss, updated parameters, running statistics); the parameter trees
  with remat on and off are the same in both packages.
* Against remat off, in the port: with Dropout2d and stochastic depth
  inside and around the blocks (the ResNet and Swin blocks' drop path),
  two steps
  from the same weights and state seed, in one fragment and in two, give
  the same loss, gradients, parameters, running statistics,
  ``num_batches_tracked`` and generator state bit for bit: the recompute
  replays the forward's draws and leaves the statistics as the forward
  left them.
* The bytes that autograd saves during a training forward of the conv
  U-Net fall with remat on (counted with ``saved_tensors_hooks``).
* Under the process grid (gloo ranks, ``tests/torch_dp_worker.py``): two
  spatial bands (halo exchanges again in the recompute) and two data ranks
  (the global BatchNorm's all-reduces again in the recompute) with remat
  on equal one process with remat on in float64 within 1e-12, the running
  statistics moved once a fragment.
* Through the CLI: ``meta/technical/remat: true`` warns no more, and its
  logs equal the JAX CLI's of the same config within 1e-4; a grid of
  remat true then false runs its second experiment without remat, and the
  switch is off when the CLI returns.
* Off the training path: with remat on, an eval forward and the exported
  artifact's output equal the remat-off ones bit for bit."""
import re
import warnings

import jax
import numpy as np
import pytest
import torch
import yaml

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.losses import DiceLoss as JaxDiceLoss
from medsegpretrainimagenet_tpu.losses import Loss as JaxLoss
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.models import blocks as jax_blocks
from medsegpretrainimagenet_tpu.optim import Optimizer as JaxOptimizer
from medsegpretrainimagenet_tpu.train import TrainState as JaxTrainState
from medsegpretrainimagenet_tpu.train import \
    make_train_step as jax_train_step
from medsegpretrainimagenet_tpu_torch import export
from medsegpretrainimagenet_tpu_torch.cli.experiment import main as cli_main
from medsegpretrainimagenet_tpu_torch.cli import run_experiment
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models import blocks as B
from medsegpretrainimagenet_tpu_torch.optim import Optimizer
from medsegpretrainimagenet_tpu_torch.train import TrainState, make_train_step

from torch_port_helpers import (assert_same_logs, attention_unet_config,
                                build_model, cli_run_dir, model_config,
                                parallel_cli_config, run_jax_cli,
                                spawn_ranks, torch_switches_kept, transplant,
                                unet_config, write_cli_tree)

#: the step tests' bar (``tests/test_torch_train_step.py``) and the
#: float64 bar of the process grid against one process
#: (``tests/test_torch_spatial.py``)
TOL, F64_TOL = 1e-4, 1e-12
BLOCKS = "segmentation.models.blocks."
#: the models held against JAX: (config, image side)
MODELS = {"unet": (unet_config((8, 16)), 16),
          "resnet_attention": (attention_unet_config(), 32)}
OPTIMIZER = {"sgd": {"momentum": 0.9,
                     "learning_rate": {"constant": {"base": 0.05}}}}
METRICS = {"metrics": {"metrics": ("metrics.DiceIndex",),
                       "calculation": {"thresholds": 0.5,
                                       "label_type": "mask"}}}
CLI_ARCH = {"in_channel_size": 3, "out_channel_size": 1, "channels": (4, 8),
            "depth": 1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for these small tensors (several threads spin far
    longer than the work takes on a shared host); the next file gets the
    thread count back."""
    with torch_switches_kept():
        torch.set_num_threads(1)
        yield


@pytest.fixture(autouse=True)
def switches_off():
    """Every module-level switch that a test here sets, off afterwards in
    both packages: the next test file in this worker starts from the
    defaults."""
    try:
        yield
    finally:
        B.set_remat(False)
        B.set_ln_half_out(False)
        B.set_compute_dtype(None)
        jax_blocks.set_remat(False)


@pytest.fixture
def checkpoints(monkeypatch):
    """Count the blocks that run under ``torch.utils.checkpoint``."""
    calls = []
    real = B.checkpoint

    def counted(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(B, "checkpoint", counted)
    return calls


def _batch(seed, n=4, frag=1, side=16, channels=3):
    """Float images and the mask of their bright pixels, (frag, n, side,
    side, channels)."""
    rng = np.random.default_rng(seed)
    x = rng.random((frag, n, side, side, channels)).astype(np.float32)
    return {"x": x, "mask": (x[..., 0] > 0.6).astype(np.int32)}


def _jax_step(cfg, variables, batch):
    """One JAX SGD step under the JAX package's current remat switch: (loss,
    updated variables)."""
    model = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    optimizer = JaxOptimizer(JaxConfigDict(OPTIMIZER), num_epochs=1,
                             batches_per_epoch=1)
    state = JaxTrainState.create(
        variables, optimizer.tx.init(variables["params"]), jax.random.key(1))
    loss = JaxLoss(JaxDiceLoss, JaxConfigDict({"label type": "mask"}))
    calculator = JaxCalculator(JaxConfigDict(METRICS), loss=loss)
    step = jax_train_step(model, loss, calculator, optimizer, donate=False)
    state, _, per_batch = step(state, calculator.init_state(), batch)
    return float(per_batch["dice_loss"]), jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})


def _port_steps(cfg, state_dict, batches, seed=1, dtype=torch.float32):
    """The port's SGD steps from *state_dict* under the current remat
    switch, in *dtype*: (the last step's loss, the model)."""
    model = build_model(ConfigDict, registry, Model, cfg)
    model.module.to(dtype).load_state_dict(state_dict)
    optimizer = Optimizer(ConfigDict(OPTIMIZER), num_epochs=1,
                          batches_per_epoch=len(batches))
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed=seed)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    calculator = MetricsCalculator(ConfigDict(METRICS), loss=loss)
    step = make_train_step(model, loss, calculator, optimizer)
    metrics_state = calculator.init_state("cpu")
    for batch in batches:
        state, metrics_state, per_batch = step(
            state, metrics_state,
            {k: torch.from_numpy(v) for k, v in batch.items()})
    return per_batch["dice_loss"], model


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_remat_step_matches_jax(name, checkpoints):
    """One step with remat on in both packages; every basic block of the
    port's forward ran under checkpoint."""
    cfg, side = MODELS[name]
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    sample = {"x": np.zeros((1, side, side, 3), np.float32)}
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(0), sample))
    jax_blocks.set_remat(True)
    remat_tree = jax.tree_util.tree_structure(
        jmodel.init(jax.random.key(0), sample))
    assert remat_tree == jax.tree_util.tree_structure(variables)
    batch = _batch(0, side=side)
    want_loss, want = _jax_step(cfg, variables, batch)

    B.set_remat(True)
    port = transplant(variables, build_model(ConfigDict, registry, Model,
                                             cfg).module)
    # the same state dict keys with remat on as off: nothing wraps a block
    B.set_remat(False)
    assert list(port.state_dict()) == list(build_model(
        ConfigDict, registry, Model, cfg).module.state_dict())
    B.set_remat(True)
    loss, model = _port_steps(cfg, port.state_dict(), [batch])
    blocks = [m for key, m in model.module.named_modules() if re.fullmatch(
        r"(enc|dec)\.(level_convs\.\d+\.\d+|bottom_convs\.\d+"
        r"|levels\.\d+\.\d+)", key)]
    assert len(blocks) == len(checkpoints) > 0
    assert {id(m) for m in blocks} == {id(m) for m in checkpoints}
    np.testing.assert_allclose(loss.item(), want_loss, rtol=TOL, atol=TOL)
    want_dict = transplant(want, build_model(
        ConfigDict, registry, Model, cfg).module).state_dict()
    compared = 0
    for key, value in model.module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert value.item() == 1, key
            continue
        np.testing.assert_allclose(value.numpy(), want_dict[key].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=key)
        compared += 1
    assert compared > 20


# ---------------------------------------------------------------------------
# against remat off, with draws
# ---------------------------------------------------------------------------

def _drawing_config(name):
    """*name*'s model with draws: the conv U-Net with Dropout2d in its
    blocks and stochastic depth on its residual branches (drawn outside the
    blocks, between their draws); the attention U-Net with the ResNet
    blocks' drop path inside the blocks; the Swin U-Net with its blocks'
    stochastic depth."""
    if name == "swin":
        cfg = model_config(img=32, embed=8, channels=(8, 16), heads=(2, 4),
                           window=4)
        cfg["model"]["segmentation.models.UNet"]["architecture"][
            "stochastic depth rate"] = 0.3
        return cfg
    if name == "unet":
        return unet_config(
            (8, 16, 32), basic_block={BLOCKS + "ConvBlock": {
                "dropout": {"rate": 0.5}}},
            residual_connections={"convolution": {}},
            **{"stochastic depth rate": 0.2})
    cfg = attention_unet_config()
    cfg["model"]["segmentation.models.UNet"]["architecture"]["encoder"][
        "classification.models.DeepResNet"]["stochastic_depth_rate"] = 0.3
    return cfg


def _generator_states(module):
    return [g.get_state() for g in {
        id(m.generator): m.generator for m in module.modules()
        if isinstance(m, B.Stochastic) and m.generator is not None}.values()]


@pytest.mark.parametrize("n_frag", [1, 2], ids=["whole", "two_fragments"])
@pytest.mark.parametrize("name", [*MODELS, "swin"])
def test_remat_step_equals_remat_off_with_draws(name, n_frag, checkpoints):
    cfg = _drawing_config(name)
    side = MODELS[name][1] if name in MODELS else 32
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(0)
    assert B.draws(model.module)
    start = model.module.state_dict()
    batches = [_batch(seed, n=4 // n_frag, frag=n_frag, side=side)
               for seed in range(2)]
    runs = []
    for remat in (False, True):
        B.set_remat(remat)
        loss, trained = _port_steps(cfg, start, batches)
        runs.append((loss, trained.module))
    assert checkpoints, "no block ran under checkpoint"
    (loss_off, off), (loss_on, on) = runs
    assert torch.equal(loss_on, loss_off)
    grads_off = dict(off.named_parameters())
    for key, p in on.named_parameters():
        assert torch.equal(p.grad, grads_off[key].grad), key
    state_off = off.state_dict()
    for key, value in on.state_dict().items():
        assert torch.equal(value, state_off[key]), key
    assert any(not torch.equal(value, start[key])
               for key, value in state_off.items())
    generators_off, generators_on = (_generator_states(m) for m in (off, on))
    assert len(generators_on) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(generators_on, generators_off))


# ---------------------------------------------------------------------------
# the memory it saves
# ---------------------------------------------------------------------------

def _saved_bytes(module, x, monkeypatch) -> int:
    """The bytes of the distinct storages that one training forward of
    *module* keeps for the backward: those autograd saves, and the block
    inputs that a checkpoint holds."""
    storages = {}

    def keep(t):
        storage = t.untyped_storage()
        storages[storage.data_ptr()] = storage.nbytes()
        return t

    real = B.checkpoint

    def holding(function, block_input, **kwargs):
        keep(block_input)
        return real(function, block_input, **kwargs)
    monkeypatch.setattr(B, "checkpoint", holding)
    with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
        module(x)
    return sum(storages.values())


def test_remat_cuts_the_bytes_autograd_saves(monkeypatch):
    """A depth-2 conv U-Net at 32 x 32: with remat on, a block keeps only
    its input, and the layers between the blocks (pooling, the upsampling
    blocks, concatenation, the head) keep what they kept: 0.53 of the
    remat-off bytes here, held under 0.6."""
    cfg = unet_config((8, 16, 32))
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(0)
    module = model.module.train()
    x = torch.from_numpy(_batch(0, side=32)["x"][0])
    saved = {}
    for remat in (False, True):
        B.set_remat(remat)
        saved[remat] = _saved_bytes(module, x, monkeypatch)
    print(f"saved bytes: remat off {saved[False]}, on {saved[True]}")
    assert saved[True] < 0.6 * saved[False], saved


# ---------------------------------------------------------------------------
# under the process grid
# ---------------------------------------------------------------------------

def _float64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """A U-Net's two float64 steps with remat on at 1 x 2 data x spatial
    and on two data ranks (one spawn for both), and in one process."""
    tmp = tmp_path_factory.mktemp("remat_grid")
    cfg = unet_config((4, 8), in_channels=1)
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(0)
    generator = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.module.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=generator))
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in model.module.state_dict().items()}
    batches = [_float64(_batch(seed, n=4, side=16, channels=1))
               for seed in range(2)]
    run = {"model_config": cfg, "state_dict": wide, "dtype": torch.float64,
           "optimizer": OPTIMIZER, "metrics": METRICS, "clip": None,
           "batches": batches, "remat": True,
           "held": _float64(_batch(9, n=2, side=16, channels=1))}
    grids = {"spatial": (("data", "spatial"), (1, 2)),
             "data": (("data",), (2,))}
    torch.save({"runs": [dict(run, grid=grid) for grid in grids.values()]},
               tmp / "payload.pt")
    spawn_ranks("step", 2, tmp, ["r0.pt", "r1.pt"], tmp / "payload.pt")
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(2)]

    B.set_remat(True)
    _, trained = _port_steps(cfg, wide, batches, dtype=torch.float64)
    B.set_remat(False)
    return ({name: [rank[i] for rank in ranks]
             for i, name in enumerate(grids)}, trained.module.state_dict())


@pytest.mark.parametrize("layout", ["spatial", "data"])
def test_remat_under_the_grid_equals_one_process(grid_runs, layout):
    ranks, want = grid_runs
    for r, got in enumerate(ranks[layout]):
        state = got["state_dict"]
        for key, value in want.items():
            if key.endswith("num_batches_tracked"):
                # one forward a step moved the statistics, not two
                assert state[key].item() == value.item() == 2, (r, key)
                continue
            assert value.dtype == torch.float64
            np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                       rtol=F64_TOL, atol=F64_TOL,
                                       err_msg=f"{layout} rank {r} {key}")


# ---------------------------------------------------------------------------
# through the CLI
# ---------------------------------------------------------------------------

def _port_cli(path, data, monkeypatch):
    monkeypatch.setenv("MST_DATA_DIR", str(data))
    with torch_switches_kept(), warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        cli_main([str(path), "--device", "cpu"])
    return [str(w.message) for w in seen]


def test_cli_remat_writes_the_jax_logs(tmp_path, monkeypatch, checkpoints):
    data, jax_weights, port_weights = write_cli_tree(tmp_path / "tree",
                                                     CLI_ARCH)
    runs = {}
    for kind, weights in (("jax", jax_weights), ("port", port_weights)):
        logs = tmp_path / f"{kind}_logs"
        path = tmp_path / f"{kind}.yaml"
        path.write_text(yaml.dump(parallel_cli_config(
            logs, weights, CLI_ARCH, epochs=2, remat=True)))
        if kind == "jax":
            run_jax_cli(path, data)
        else:
            messages = _port_cli(path, data, monkeypatch)
            assert not [m for m in messages if "remat" in m], messages
        runs[kind] = cli_run_dir(logs)
    assert checkpoints, "the CLI run trained without remat"
    assert not B.remat_enabled()
    for name in ("epoch_logs.csv", "batch_logs.csv"):
        assert_same_logs(runs["port"], runs["jax"], TOL, name)


def test_cli_grid_sets_remat_for_each_experiment(tmp_path, monkeypatch,
                                                 checkpoints):
    """``remat: [true, false]`` is a grid of two experiments: the first
    trains its blocks under checkpoint, the second does not."""
    data, _, port_weights = write_cli_tree(tmp_path / "tree", CLI_ARCH)
    seen = []
    real = run_experiment.run_exp

    def recorded(*args, **kwargs):
        before = len(checkpoints)
        out = real(*args, **kwargs)
        seen.append((B.remat_enabled(), len(checkpoints) - before))
        return out
    monkeypatch.setattr(run_experiment, "run_exp", recorded)
    path = tmp_path / "grid.yaml"
    path.write_text(yaml.dump(parallel_cli_config(
        tmp_path / "logs", port_weights, CLI_ARCH, epochs=1,
        remat=[True, False])))
    _port_cli(path, data, monkeypatch)
    assert [on for on, _ in seen] == [True, False]
    assert seen[0][1] > 0 and seen[1][1] == 0, seen
    assert not B.remat_enabled()


# ---------------------------------------------------------------------------
# off the training path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_remat_leaves_eval_and_export_unchanged(name, checkpoints):
    cfg, side = MODELS[name]
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(0)
    module = model.module.eval()
    start = {k: v.clone() for k, v in module.state_dict().items()}
    x = torch.from_numpy(_batch(3, n=2, side=side)["x"][0])
    outputs = {}
    for remat in (False, True):
        B.set_remat(remat)
        # the train-mode forward below moves the running statistics
        module.load_state_dict(start)
        eager = module(x)
        with torch.no_grad():
            module.train()
            no_grad_train = module(x)
            module.eval()
        artifact = export.export_forward(module, (side, side, 3)).module()
        outputs[remat] = (eager, no_grad_train, artifact(x))
    assert not checkpoints
    for off, on in zip(outputs[False], outputs[True]):
        assert torch.equal(off, on)
