"""The port's serving entry point (``medsegpretrainimagenet_tpu_torch.predict``)
against the JAX package's: the JAX ``predict_from_config`` on a msgpack
checkpoint and the port's on the same weights converted to ``.pt``, with
the same uint8 stack, on the CPU."""
import json

import jax
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu import predict as jax_predict
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.train import checkpoint as jax_ckpt
from medsegpretrainimagenet_tpu_torch import predict
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model, blocks
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax

from torch_port_helpers import build_model, model_config


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX msgpack checkpoint, the same weights as a port .pt, and a
    (5, 1, 64, 64) uint8 stack in the reference npy layout."""
    root = tmp_path_factory.mktemp("serve")
    jax_model = build_model(JaxConfigDict, jax_registry, JaxModel,
                            model_config())
    variables = jax_model.init(jax.random.key(0),
                               {"x": np.zeros((1, 64, 64, 3), np.float32)})
    jax_ckpt.save_params_file(str(root / "w.msgpack"), variables)
    port = build_model(ConfigDict, registry, Model, model_config())
    host = jax.tree_util.tree_map(np.asarray, variables)
    ckpt.save_params_file(str(root / "w.pt"),
                          state_dict_from_jax(host, port.module))
    imgs = (np.random.default_rng(0).random((5, 1, 64, 64)) * 255) \
        .astype(np.uint8)
    np.save(root / "imgs.npy", imgs)
    return root


def test_predict_matches_jax_predict(served):
    jax_stats = jax_predict.predict_from_config(
        JaxConfigDict(model_config()), str(served / "w.msgpack"),
        str(served / "imgs.npy"), str(served / "jax.npy"), batch_size=2)
    wa.window_attention_cuda.launches = 0
    stats = predict.predict_from_config(
        ConfigDict(model_config()), str(served / "w.pt"),
        str(served / "imgs.npy"), str(served / "port.npy"), batch_size=2,
        device="cpu")
    ref, out = np.load(served / "jax.npy"), np.load(served / "port.npy")
    assert out.shape == ref.shape == (5, 64, 64, 1)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert stats["images"] == jax_stats["images"] == 5
    assert stats["device"] == "cpu" and stats["images_per_sec"] > 0
    assert wa.window_attention_cuda.launches == 0  # CPU: plain version


def test_predict_cli_mixed_precision_threshold(served, capsys):
    blocks.set_compute_dtype(None)
    rc = predict.main([
        str(_yaml(served)),
        "--checkpoint", str(served / "w.pt"),
        "--input", str(served / "imgs.npy"),
        "--output", str(served / "masks.npy"), "--batch", "4",
        "--threshold", "0.5", "--mixed-precision", "--device", "cpu"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["mixed_precision"] is True
    masks = np.load(served / "masks.npy")
    assert masks.shape == (5, 64, 64) and masks.dtype == np.uint8
    assert set(np.unique(masks)) <= {0, 1}
    assert blocks.compute_dtype() is None  # restored on exit


def _yaml(root):
    import yaml

    path = root / "cfg.yaml"
    cfg = model_config()
    # through JSON: tuples become the plain lists a user's YAML holds
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return path


def test_predict_without_card_needs_device_named(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.predict_from_config(
            ConfigDict(model_config()), str(served / "w.pt"),
            str(served / "imgs.npy"), str(served / "x.npy"))


def test_checkpoint_round_trip_and_suffix(tmp_path):
    state = {"a": torch.arange(4.0), "b": torch.ones(2, 2)}
    ckpt.save_params_file(str(tmp_path / "s.pt"), state)
    back = ckpt.load_params_file(str(tmp_path / "s.pt"))
    assert all(torch.equal(state[k], back[k]) for k in state)
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        ckpt.load_params_file(str(tmp_path / "s.msgpack"))


def test_predict_resizes_like_jax(served):
    """Serving a 48 x 48 stack at the model's 64 x 64: the port resizes
    with its own bilinear map (no OpenCV), so its output equals the output
    for the stack resized beforehand by ``data.warp.resize``; against the
    JAX package, which resizes with OpenCV, within 5e-3 (on uint8
    upscaling OpenCV's fixed-point rounding moves about 0.6 % of the
    pixels by one gray level)."""
    from medsegpretrainimagenet_tpu_torch.data.warp import resize

    imgs = (np.random.default_rng(1).random((3, 1, 48, 48)) * 255) \
        .astype(np.uint8)
    np.save(served / "small.npy", imgs)
    np.save(served / "resized.npy",
            np.stack([resize(img[0], (64, 64))[None] for img in imgs]))
    jax_predict.predict_from_config(
        JaxConfigDict(model_config()), str(served / "w.msgpack"),
        str(served / "small.npy"), str(served / "jax_small.npy"),
        batch_size=2, image_size=64)
    for name in ("small", "resized"):
        predict.predict_from_config(
            ConfigDict(model_config()), str(served / "w.pt"),
            str(served / f"{name}.npy"), str(served / f"port_{name}.npy"),
            batch_size=2, image_size=64, device="cpu")
    out = np.load(served / "port_small.npy")
    np.testing.assert_array_equal(out, np.load(served / "port_resized.npy"))
    ref = np.load(served / "jax_small.npy")
    assert out.shape == ref.shape == (3, 64, 64, 1)
    np.testing.assert_allclose(out, ref, atol=5e-3)
