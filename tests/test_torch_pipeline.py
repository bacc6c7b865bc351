"""Pipeline parallelism (``medsegpretrainimagenet_tpu_torch.parallel.pp``)
on the CPU against the JAX package's (``parallel/pp.py``), on
``tests/test_pipeline_parallel.py``'s cases with the same stages and
inputs fed to both: four gloo ranks, each a process of its own
(``tests/torch_dp_worker.py``, one spawn for every case), meeting through a
``file://`` rendezvous.

* The stacked parameters' shapes; the forward of four ``tanh`` stages at
  M = 4 against the JAX ``pipeline_apply`` on its pipe mesh and at M = 8
  against the JAX stack that the JAX test holds its schedule against
  (1e-6); the loss and the stacked gradients at M = 8 against the JAX
  gradients through its schedule (1e-6, and 1e-5 relative / 1e-6
  absolute); four real DoubleSwin stages (LayerNorms, the window attention
  with its relative-position bias) at M = 2 against the JAX stack (2e-5).
* data x pipe 2 x 2 (two stages, each data rank its half of the samples)
  against the JAX stack (1e-6).
* ``shard_io``: each stage holds its quarter of the microbatches in and
  out, forward and gradients against the JAX sequential stack, which the
  JAX test holds its own ``shard_io`` schedule against; and composed with
  data parallelism.
* The three refusals: a stage count other than the pipe group's, a batch
  that M does not divide, M that the stages do not divide under
  ``shard_io``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.models.swin import \
    DoubleSwinTransformerBlock as JaxDoubleSwin
from medsegpretrainimagenet_tpu.parallel import create_mesh
from medsegpretrainimagenet_tpu.parallel import \
    pipeline_apply as jax_pipeline_apply
from medsegpretrainimagenet_tpu.parallel import \
    stack_stage_params as jax_stack
from medsegpretrainimagenet_tpu_torch import parallel
from medsegpretrainimagenet_tpu_torch.config import registry
from medsegpretrainimagenet_tpu_torch.models import swin  # noqa: F401
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import spawn_ranks

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs the 8-device CPU mesh")

FEAT = 16
FORWARD_TOL, GRAD_RTOL, GRAD_ATOL, SWIN_TOL = 1e-6, 1e-5, 1e-6, 2e-5
SWIN = ("segmentation.models.blocks.DoubleSwinTransformerBlock", dict(
    in_channels=8, embed_dim=8, img_size=28, patch_size=4, depth=2,
    num_heads_layers=(2, 2, 2, 2), window_size=7))


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stages(num_stages, seed):
    """``tests/test_pipeline_parallel.py``'s ``_make_stages``."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, 0.4, (FEAT, FEAT)).astype(np.float32),
             "b": rng.normal(0, 0.1, (FEAT,)).astype(np.float32)}
            for _ in range(num_stages)]


def _stacked(stages):
    return {k: np.asarray(v) for k, v in jax_stack(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages]).items()}


def _sequential(stacked, x):
    for i in range(stacked["w"].shape[0]):
        x = _stage_fn({k: v[i] for k, v in stacked.items()}, x)
    return x


def _pipe_mesh():
    return create_mesh(("pipe",), shape=(4,), devices=jax.devices()[:4])


def _cases():
    """Every case: the port's payload and the JAX reference."""
    cases, want = [], {}
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (16, FEAT)).astype(np.float32)
    stacked = _stacked(_stages(4, 0))
    for m in (4, 8):
        cases.append({"name": f"forward_m{m}", "m": m, "x": x,
                      "grid": (("data", "pipe"), (1, 4)),
                      "stacked": stacked})
    want["forward_m4"] = {"y": jax_pipeline_apply(
        _stage_fn, stacked, jnp.asarray(x), mesh=_pipe_mesh(),
        num_microbatches=4)}
    # the stack that the JAX test holds its M = 8 schedule against
    want["forward_m8"] = {"y": _sequential(stacked, jnp.asarray(x))}

    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (8, FEAT)).astype(np.float32)
    target = rng.normal(0, 1, (8, FEAT)).astype(np.float32)
    stacked = _stacked(_stages(4, 2))

    def pipe_loss(params):
        y = jax_pipeline_apply(_stage_fn, params, jnp.asarray(x),
                               mesh=_pipe_mesh(), num_microbatches=8)
        return jnp.mean((y - target) ** 2)

    cases.append({"name": "gradients", "m": 8, "x": x, "target": target,
                  "grid": (("data", "pipe"), (1, 4)), "stacked": stacked})
    loss, grads = jax.value_and_grad(pipe_loss)(
        {k: jnp.asarray(v) for k, v in stacked.items()})
    want["gradients"] = {"loss": loss, "grads": grads,
                         "y": _sequential(stacked, jnp.asarray(x))}

    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (16, FEAT)).astype(np.float32)
    stacked = _stacked(_stages(2, 4))
    cases.append({"name": "data_x_pipe", "m": 4, "x": x,
                  "data_axis": "data", "grid": (("data", "pipe"), (2, 2)),
                  "stacked": stacked})
    want["data_x_pipe"] = {"y": _sequential(stacked, jnp.asarray(x))}

    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (16, FEAT)).astype(np.float32)
    target = rng.normal(0, 1, (16, FEAT)).astype(np.float32)
    stacked = _stacked(_stages(4, 8))
    cases.append({"name": "shard_io", "m": 8, "x": x, "target": target,
                  "shard_io": True, "grid": (("data", "pipe"), (1, 4)),
                  "stacked": stacked})
    loss, grads = jax.value_and_grad(
        lambda p: jnp.mean((_sequential(p, jnp.asarray(x)) - target) ** 2))(
            {k: jnp.asarray(v) for k, v in stacked.items()})
    want["shard_io"] = {"y": _sequential(stacked, jnp.asarray(x)),
                        "loss": loss, "grads": grads}

    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (16, FEAT)).astype(np.float32)
    stacked = _stacked(_stages(2, 10))
    cases.append({"name": "shard_io_data", "m": 4, "x": x,
                  "shard_io": True, "data_axis": "data",
                  "grid": (("data", "pipe"), (2, 2)), "stacked": stacked})
    want["shard_io_data"] = {"y": _sequential(stacked, jnp.asarray(x))}

    block = JaxDoubleSwin(**SWIN[1])
    x = np.random.default_rng(7).normal(0, 1, (2, 49, 8)).astype(np.float32)
    params = [block.init(jax.random.key(i), jnp.asarray(x))["params"]
              for i in range(4)]
    ref = jnp.asarray(x)
    for p in params:
        ref = block.apply({"params": p}, ref, train=False)
    module = registry.resolve(SWIN[0])(**SWIN[1])
    ported = [state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                  module) for p in params]
    cases.append({"name": "double_swin", "m": 2, "x": x,
                  "grid": (("data", "pipe"), (1, 4)), "block": SWIN,
                  "stacked": {k: v.numpy() for k, v in
                              parallel.stack_stage_params(ported).items()}})
    want["double_swin"] = {"y": ref}
    return cases, jax.tree_util.tree_map(np.asarray, want)


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cases, want = _cases()
    torch.save({"cases": cases}, tmp / "payload.pt")
    spawn_ranks("pipeline", 4, tmp, [f"r{r}.pt" for r in range(4)],
                tmp / "payload.pt")
    ranks = [torch.load(tmp / f"r{r}.pt", weights_only=False)
             for r in range(4)]
    return {case["name"]: case for case in cases}, want, ranks


def _local(case, rank, y):
    """This rank's part of the whole output *y*: its samples on the data
    axis, its microbatches under shard_io."""
    data, pipe = case["grid"][1]
    if case.get("data_axis"):
        y = np.split(y, data)[rank // pipe]
    if case.get("shard_io"):
        y = np.split(y, pipe)[rank % pipe]
    return y


def test_stack_stage_params_shapes():
    stages = [{k: torch.from_numpy(v) for k, v in s.items()}
              for s in _stages(4, 0)]
    stacked = parallel.stack_stage_params(stages)
    assert stacked["w"].shape == (4, FEAT, FEAT)
    assert stacked["b"].shape == (4, FEAT)
    torch.testing.assert_close(stacked["w"][2], stages[2]["w"], rtol=0,
                               atol=0)
    np.testing.assert_array_equal(stacked["w"].numpy(),
                                  _stacked(_stages(4, 0))["w"])


@pytest.mark.parametrize("name", ["forward_m4", "forward_m8", "gradients",
                                  "data_x_pipe", "shard_io", "shard_io_data",
                                  "double_swin"])
def test_pipeline_equals_jax(pipeline_runs, name):
    cases, want, ranks = pipeline_runs
    case, ref = cases[name], want[name]
    tol = SWIN_TOL if name == "double_swin" else FORWARD_TOL
    for r, got in enumerate(ranks):
        result = got[name]
        np.testing.assert_allclose(result["y"].numpy(),
                                   _local(case, r, ref["y"]), rtol=tol,
                                   atol=tol, err_msg=f"rank {r}")
        if "grads" not in ref:
            continue
        for key, grad in ref["grads"].items():
            np.testing.assert_allclose(result["grads"][key].numpy(), grad,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"rank {r} {key}")
    if "loss" in ref:
        # under shard_io each stage holds its share of the loss
        losses = [float(got[name]["loss"]) for got in ranks]
        loss = sum(losses) if case.get("shard_io") else losses[0]
        np.testing.assert_allclose(loss, float(ref["loss"]),
                                   rtol=FORWARD_TOL)


class _Pipe:
    """A pipe axis of four stages, as its first stage sees it, for the
    refusals (they come before any collective)."""
    name, size, index, group, ranks, pairs = "pipe", 4, 0, None, \
        [0, 1, 2, 3], {}


@pytest.mark.parametrize("stages,batch,m,shard_io,match", [
    (8, 8, 4, False, "leading dim 8, expected"),
    (4, 10, 4, False, "not divisible"),
    (4, 12, 6, True, "divisible by num_stages")],
    ids=["stage_count", "ragged_microbatches", "shard_io_microbatches"])
def test_pipeline_refusals(stages, batch, m, shard_io, match):
    stacked = {k: torch.from_numpy(v)
               for k, v in _stacked(_stages(stages, 0)).items()}
    with pytest.raises(ValueError, match=match):
        parallel.pipeline_apply(
            lambda p, x: x, stacked,
            torch.zeros(batch // (4 if shard_io else 1), FEAT),
            group=_Pipe(), num_microbatches=m, shard_io=shard_io)
