"""The port's NIfTI codec and ACDC reader against the JAX package's, on
the CPU: volumes written by either package read back bit-equal through
either; ACDC on a tree the test writes, both splits, a random and the
official validation split, square and non-square sizes, gives the same
slices: labels bit-equal, images within IMAGE_TOL relative (the port
resizes the float64 volumes in double as OpenCV does, within 6e-14; a
pixel then differs at most by the float32 rounding of the result, on
these trees 0.06 % of them by one step).  The ImageNet reader gives the
JAX reader's paths, labels and splits, and loads bit-equal images.  IDRiD
and ``MixedDataset``, refused until their slice, build from their names.
The float resize of 2 to 4 channels follows OpenCV."""
import numpy as np
import pytest

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.data import Dataset as JaxDataset
from medsegpretrainimagenet_tpu.data.readers import ACDC as JaxACDC
from medsegpretrainimagenet_tpu.data.readers import load_nii as jax_load
from medsegpretrainimagenet_tpu.data.readers import save_nii as jax_save
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.data import Dataset
from medsegpretrainimagenet_tpu_torch.data.readers import (ACDC, load_nii,
                                                           save_nii)

from torch_port_helpers import write_idrid_tree

#: relative tolerance of the resized ACDC images against OpenCV's
IMAGE_TOL = 1e-6


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32,
                                   np.float64])
def test_nifti_round_trips_between_the_packages(tmp_path, suffix, dtype):
    vol = (np.random.default_rng(0).random((7, 5, 3)) * 100).astype(dtype)
    affine = np.diag([1.5, 0.75, 2.0, 1.0])
    for name, save, load in (("p2j", save_nii, jax_load),
                             ("j2p", jax_save, load_nii),
                             ("p2p", save_nii, load_nii)):
        path = str(tmp_path / f"{name}{suffix}")
        save(path, vol, affine)
        data, got_affine, header = load(path)
        want = jax_load(path) if load is load_nii else load_nii(path)
        np.testing.assert_array_equal(data, vol.astype(np.float64))
        np.testing.assert_array_equal(data, want[0])
        np.testing.assert_array_equal(got_affine, want[1])
        assert header == want[2] and header["dim"][:4] == (3, 7, 5, 3)


def _acdc_tree(root, hw=(12, 14), zs=(3, 6)):
    rng = np.random.default_rng(0)
    for part, n in (("training", 4), ("testing", 2)):
        for p in range(n):
            d = root / "ACDC" / part / f"patient{p:03d}"
            d.mkdir(parents=True)
            for frame in (1, 12):
                z = zs[frame % 2]
                stem = str(d / f"patient{p:03d}_frame{frame:02d}")
                save_nii(stem + ".nii.gz",
                         (rng.random((*hw, z)) * 300).astype(np.float32))
                jax_save(stem + "_gt.nii.gz",
                         rng.integers(0, 4, (*hw, z)).astype(np.uint8))


@pytest.mark.parametrize("cfg", [
    {"image_sizes": 16, "validate_on_test": True},
    {"image_sizes": 8, "val_split_percentage": 0.25},
    {"image_sizes": (10, 13), "validate_on_test": True}],
    ids=["official_split", "random_split", "non_square"])
def test_acdc_matches_jax(tmp_path, monkeypatch, cfg):
    _acdc_tree(tmp_path)
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    port = ACDC(ConfigDict(cfg), seed=3)
    ref = JaxACDC(JaxConfigDict(cfg), seed=3)
    size = cfg["image_sizes"]
    rows, cols = (size, size) if isinstance(size, int) else size[::-1]
    for split in ("train", "val"):
        got, want = getattr(port, split), getattr(ref, split)
        assert got.keys() == want.keys() == {"x", "mask"}
        assert got["x"].shape == want["x"].shape
        assert got["x"].shape[1:] == (rows, cols, 1)
        assert got["x"].dtype == np.float32 and got["mask"].dtype == np.int32
        np.testing.assert_array_equal(got["mask"], want["mask"])
        np.testing.assert_allclose(got["x"], want["x"], rtol=IMAGE_TOL)
    assert ACDC.CLASSES == JaxACDC.CLASSES


def test_acdc_builds_from_its_registry_names(tmp_path, monkeypatch):
    _acdc_tree(tmp_path)
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    for name in ("segmentation.datasets.ACDC", "acdc"):
        cd = ConfigDict({"data": {name: {"image_sizes": 8,
                                         "validate_on_test": True}}})
        cd.expand()
        registry.fill_spec(cd, "data")
        ds = registry.build(cd["data"].trim(), wrapper=Dataset, seed=0)
        assert len(ds.train["x"]) == 4 * 9 and len(ds.val["x"]) == 2 * 9


@pytest.mark.parametrize("name, item", [
    ("segmentation.datasets.IDRiD", "M5"),
    ("idrid", "M5"),
    ("data.MixedDataset", "M5"),
    ("mixed_dataset", "M5")])
def test_unported_components_still_raise(name, item, tmp_path, monkeypatch):
    """The components that raised NotImplementedError naming ROADMAP item
    *item* until its slice ported them now build from the same names: the
    port's IDRiD reader (on an IDRiD tree, the JAX reader's images) and
    its ``MixedDataset`` (of two ACDC readers, the JAX one's rows)."""
    write_idrid_tree(tmp_path)
    _acdc_tree(tmp_path)
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    acdc = {"segmentation.datasets.ACDC": {"image_sizes": 8,
                                           "validate_on_test": True}}
    params = {"base_image_sizes": 16, "cropped_image_sizes": None,
              "train_set_size": 4} if "idrid" in name.lower() else {
        "datasets": (acdc, acdc), "switch_frequency": 3}
    cd = ConfigDict({"data": {name: params}})
    cd.expand()
    registry.fill_spec(cd, "data")
    ds = registry.build(cd["data"].trim(), wrapper=Dataset, seed=0)
    jax_name = "segmentation.datasets.IDRiD" if "idrid" in name.lower() \
        else "data.MixedDataset"
    jcd = JaxConfigDict({"data": {jax_name: params}})
    jcd.expand()
    jax_registry.fill_spec(jcd, "data")
    want = jax_registry.build(jcd["data"].trim(), wrapper=JaxDataset, seed=0)
    assert type(ds).__name__ == type(want).__name__
    assert type(ds).__module__.startswith("medsegpretrainimagenet_tpu_torch")
    if "idrid" in name.lower():
        np.testing.assert_array_equal(ds.train["x"], want.train["x"])
        return
    for k in range(len(want.train["x"])):
        got_row = {kw: ds.load_function[kw](ds.train[kw][k])
                   for kw in ds.train}
        want_row = {kw: want.load_function[kw](want.train[kw][k])
                    for kw in want.train}
        np.testing.assert_array_equal(got_row["x"], want_row["x"])
        assert got_row["ds_idx"] == want_row["ds_idx"]


def _imagenet_tree(root, n=24, seed=0):
    """A synthetic store in the reader's layout: channels-first uint8
    ``.npy`` files (RGB and one gray image) and ``labels.json`` with
    classes 1..7; the official-val files carry ``val`` in their names."""
    import json
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    labels = {}
    for i in range(n):
        name = f"{'val' if i % 4 == 3 else 'train'}_{i:03d}.npy"
        channels = 1 if i == 5 else 3
        np.save(root / name, rng.integers(0, 256, (channels, 12, 10),
                                          dtype=np.uint8))
        labels[name] = int(rng.integers(1, 8))
    (root / "labels.json").write_text(json.dumps(labels))
    return root


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("split", [
    {"use_official_validation": True},
    {"use_official_validation": False, "split": 0.25, "seed": 3},
    {"use_official_validation": False, "split": 0.4}])
def test_imagenet_reader_matches_jax(tmp_path, monkeypatch, split, uint8):
    from medsegpretrainimagenet_tpu.data.readers.imagenet import \
        ImageNet as JaxImageNet
    from medsegpretrainimagenet_tpu_torch.data.readers import ImageNet
    _imagenet_tree(tmp_path / "imagenet")
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    params = {**split, "uint8_transfer": uint8}
    want = JaxImageNet(JaxConfigDict(params), seed=11)
    got = ImageNet(ConfigDict(params), seed=11)
    for part in ("train", "val"):
        assert getattr(got, part)["x"] == getattr(want, part)["x"]
        np.testing.assert_array_equal(getattr(got, part)["label"],
                                      getattr(want, part)["label"])
        assert getattr(got, part)["label"].dtype == np.int32
    assert len(got.val["x"]) == (6 if split["use_official_validation"]
                                 else int(split["split"] * 24))
    assert got.train["label"].min() >= 0 and got.train["label"].max() <= 6
    for path in got.train["x"] + got.val["x"]:
        a, b = got.load_function["x"](path), want.load_function["x"](path)
        assert a.dtype == b.dtype == (np.uint8 if uint8 else np.float32)
        assert a.shape == b.shape and a.shape[-1] in (1, 3)
        np.testing.assert_array_equal(a, b)


def test_imagenet_reader_is_registered_under_both_names(tmp_path,
                                                        monkeypatch):
    _imagenet_tree(tmp_path / "imagenet", n=8)
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    for name in ("classification.datasets.ImageNet", "imagenet"):
        cd = ConfigDict({"data": {name: {}}})
        cd.expand()
        registry.fill_spec(cd, "data")
        ds = registry.build(cd["data"].trim(), wrapper=Dataset, seed=0)
        assert len(ds.train["x"]) == 6 and len(ds.val["x"]) == 2


def test_imagenet_scaling_is_the_native_product():
    """The JAX load multiplies by the float32 1/255 (its native library),
    which differs from a division for 126 of the 256 values; the port
    follows the product."""
    from medsegpretrainimagenet_tpu_torch.data.readers.imagenet import \
        _INV_255
    values = np.arange(256, dtype=np.uint8)
    product = values.astype(np.float32) * _INV_255
    assert (product != values.astype(np.float32) / 255.0).sum() == 126
    from medsegpretrainimagenet_tpu import native
    if native.available():
        np.testing.assert_array_equal(native.u8_to_f32_scale(values),
                                      product)


#: relative tolerance of the port's float resize against OpenCV's
RESIZE_TOL = 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape, size, scale", [
    ((232, 256), (200, 180), 250.0),   # the probe of the fault
    ((256, 256), (224, 224), 1.0),     # ImageNet RGB shrunk 256 -> 224
    ((100, 120), (150, 170), 1.0)])    # enlarging
def test_float_resize_matches_opencv(shape, size, scale, channels, dtype):
    import cv2
    from medsegpretrainimagenet_tpu_torch.data import warp
    full = shape if channels is None else shape + (channels,)
    img = (np.random.default_rng(channels or 0).random(full)
           * scale).astype(dtype)
    want = cv2.resize(img, (size[1], size[0]),
                      interpolation=cv2.INTER_LINEAR).reshape(
                          size + full[2:])
    got = warp.resize(img, size)
    assert got.dtype == img.dtype
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=RESIZE_TOL * (1e-8 if dtype == np.float64
                                                  else 1))
