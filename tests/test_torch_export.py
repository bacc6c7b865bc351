"""The port's model export (``medsegpretrainimagenet_tpu_torch.export``)
against the JAX package's on the CPU in float32: a small U-Net and a small
Swin U-Net (window partition, shifted windows and the mask's broadcast over
the batch), exported with a symbolic batch, called at b = 1, 3 and 5, give
the JAX artifact's outputs (``export_forward(...).call``) within 1e-5, with
the weights carried across by ``transfer.state_dict_from_jax`` into the
``.pt`` checkpoint that ``python -m ...export --device cpu`` reads.  A static
batch refuses another size.  The CLI writes, from a config and a ``.pt``
checkpoint, an artifact that a fresh process which cannot import JAX loads
and runs.  On the CPU the artifact holds the plain attention, in either
attention layout."""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medsegpretrainimagenet_tpu import export as jax_export
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu_torch import export, ops
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model
from medsegpretrainimagenet_tpu_torch.models.blocks import compute_dtype
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

from torch_port_helpers import build_model, model_config, transplant, \
    unet_config

TOL = 1e-5
FAMILIES = {"unet": (unet_config(), (16, 16, 3)),
            "swin": (model_config(), (64, 64, 3))}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    """(family, JAX model, its variables, the port module with them)."""
    cfg, shape = FAMILIES[request.param]
    jmodel = build_model(JaxConfigDict, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), {"x": np.zeros((1, *shape), np.float32)}))
    module = transplant(variables, build_model(ConfigDict, registry, Model,
                                               cfg).module)
    return request.param, jmodel, variables, module


def _images(n, shape, seed=0):
    return np.random.default_rng(seed).random((n, *shape)) \
        .astype(np.float32)


def test_symbolic_batch_artifact_equals_the_jax_artifact(pair, tmp_path):
    """The CLI on the CPU, from a config and the transplanted weights as a
    ``.pt`` checkpoint, against the JAX artifact of the same weights."""
    family, jmodel, variables, module = pair
    cfg, shape = FAMILIES[family]
    jax_artifact = jax_export.export_forward(jmodel, variables, shape)
    (tmp_path / "cfg.yaml").write_text(yaml.dump(cfg))
    ckpt.save_params_file(str(tmp_path / "w.pt"), module.state_dict())
    path = str(tmp_path / "model.pt2")
    assert export.main([str(tmp_path / "cfg.yaml"), "--checkpoint",
                        str(tmp_path / "w.pt"), "--output", path, "--size",
                        str(shape[0]), "--channels", str(shape[2]),
                        "--device", "cpu"]) == 0
    assert (tmp_path / "model.pt2").stat().st_size > 0
    assert not (tmp_path / "model.pt2.tmp").exists()
    served = export.load_exported(path)
    for b in (1, 3, 5):
        x = _images(b, shape, seed=b)
        got = served(torch.from_numpy(x))
        want = np.asarray(jax_artifact.call(jnp.asarray(x)))
        assert got.shape == want.shape == (b, *shape[:2], 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=f"{family} b={b}")


def test_only_eager_no_grad_calls_skip_the_operator():
    """The wrappers call the kernel straight only in eager mode with no
    gradient to record; under ``torch.export`` and under autograd they take
    the registered operator, which export keeps as a node and whose
    autograd is the registered backward operator."""
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(wa._straight(x, None))
            return x * 2

    x = torch.zeros(2, 3)
    with torch.no_grad():
        torch.export.export(Probe(), (x,))
        Probe()(x)
    Probe()(x)
    Probe()(x.requires_grad_())
    with torch.inference_mode():
        Probe()(torch.zeros(2, 3))
    assert seen == [False, True, True, False, True]


def test_cpu_artifact_holds_the_plain_attention(tmp_path):
    """Traced on the CPU, neither attention path leaves an operator of the
    port in the graph, and the image-layout path's artifact gives the
    windows path's outputs."""
    cfg, shape = FAMILIES["swin"]
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(1)
    x = torch.from_numpy(_images(3, shape))
    outs = []
    for mode in ("off", "on"):
        ops.set_fused_image_mode(mode)
        try:
            exported = export.export_forward(model.module, shape)
        finally:
            ops.set_fused_image_mode("off")
        targets = {str(n.target) for n in exported.graph.nodes
                   if n.op == "call_function"}
        assert not any("medseg_torch" in t for t in targets), targets
        outs.append(exported.module()(x))
    np.testing.assert_allclose(outs[1].detach().numpy(),
                               outs[0].detach().numpy(), rtol=TOL, atol=TOL)


def test_static_batch_refuses_other_sizes():
    cfg, shape = FAMILIES["unet"]
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(2)
    served = export.export_forward(model.module, shape, batch=2).module()
    assert served(torch.zeros(2, *shape)).shape == (2, *shape[:2], 1)
    with pytest.raises((AssertionError, RuntimeError)):
        served(torch.zeros(3, *shape))


_FRESH_PROCESS = """
import sys
for name in ("jax", "flax", "optax", "medsegpretrainimagenet_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np, torch
from medsegpretrainimagenet_tpu_torch.export import load_exported
served = load_exported(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], served(x).float().numpy())
assert "medsegpretrainimagenet_tpu_torch.models" not in sys.modules
print("OK")
"""


@pytest.mark.parametrize("mixed_precision", [False, True],
                         ids=["float32", "bfloat16"])
def test_cli_artifact_serves_in_a_process_without_jax(tmp_path, capsys,
                                                      mixed_precision):
    """Config + ``.pt`` checkpoint -> artifact -> a fresh process that
    cannot import JAX (nor the model code) gives the module's outputs;
    ``--mixed-precision`` traces the bf16 path and restores the compute
    dtype afterwards."""
    from medsegpretrainimagenet_tpu_torch.models.blocks import \
        set_compute_dtype
    cfg = {"model": {"segmentation.models.UNet": {
        "architecture": {"in_channel_size": 1, "out_channel_size": 1,
                         "channels": (4, 8), "depth": 1},
        "final_activation": "sigmoid"}}}
    (tmp_path / "cfg.yaml").write_text(yaml.dump(cfg))
    model = build_model(ConfigDict, registry, Model, cfg)
    model.init(7)
    ckpt.save_params_file(str(tmp_path / "state.pt"),
                          model.module.state_dict())
    out = tmp_path / "model.pt2"
    argv = [str(tmp_path / "cfg.yaml"), "--checkpoint",
            str(tmp_path / "state.pt"), "--output", str(out), "--size", "16",
            "--channels", "1", "--device", "cpu"]
    assert export.main(argv + (["--mixed-precision"] if mixed_precision
                               else [])) == 0
    assert compute_dtype() is None
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    dtype = "bfloat16" if mixed_precision else "float32"
    assert stats["out_avals"] == [f"{dtype}[b,16,16,1]"]
    assert stats["batch"] == "symbolic" and stats["platforms"] == ["cpu"]
    assert stats["bytes"] == out.stat().st_size
    assert stats["in_shape"] == [16, 16, 1] and stats["output"] == str(out)
    assert stats["export_seconds"] >= 0

    x = _images(3, (16, 16, 1), seed=4)
    np.save(tmp_path / "x.npy", x)
    result = subprocess.run(
        [sys.executable, "-c", _FRESH_PROCESS, str(out),
         str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
        capture_output=True, text=True, timeout=120,
        cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert result.returncode == 0, result.stderr
    set_compute_dtype(torch.bfloat16 if mixed_precision else None)
    try:
        with torch.no_grad():
            want = model.module.eval()(torch.from_numpy(x))
    finally:
        set_compute_dtype(None)
    # the same CPU operations in the same order: equal
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                  want.float().numpy())
