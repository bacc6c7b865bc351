"""The port's data path against the JAX package's, on the CPU: the grid
parser (YAML and JSON) and the port's YAML writer, the COVID-QU reader on a
synthetic tree, the balanced sampler and loader (bit-equal batches from the
same seed), and the segmentation transforms (the same numpy draws, outputs
equal or within the stated tolerances of the JAX module's OpenCV maps)."""
import json

import cv2

import numpy as np
import pytest
import yaml

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import parse as jax_parse
from medsegpretrainimagenet_tpu.data import BalancedDataLoader as JaxLoader
from medsegpretrainimagenet_tpu.data.readers.covidqu import \
    COVIDQUDataset as JaxCOVIDQU
from medsegpretrainimagenet_tpu.data.sampling import \
    batch_index_plan as jax_plan
from medsegpretrainimagenet_tpu.data.transforms import \
    segmentation as jax_seg
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, dump_yaml
from medsegpretrainimagenet_tpu_torch.config import parse
from medsegpretrainimagenet_tpu_torch.data import BalancedDataLoader
from medsegpretrainimagenet_tpu_torch.data.readers.covidqu import \
    COVIDQUDataset
from medsegpretrainimagenet_tpu_torch.data.sampling import batch_index_plan
from medsegpretrainimagenet_tpu_torch.data import warp
from medsegpretrainimagenet_tpu_torch.data.transforms import segmentation

#: float images resized by the port against OpenCV
RESIZE_TOL = 1e-5
#: rotated images against OpenCV's warp (OpenCV 5 warps in float)
ROTATE_TOL = 1e-4

GRID = {"experiment": {"number_of_epochs": [1, 2]},
        "model": {"channels": (4, 8), "depth": 1},
        "training": {"lr": [0.1, 0.01], "name": "sgd"},
        "metrics": {"metrics": ("metrics.DiceIndex",)}}


def test_grid_parse_yaml_and_json_match_jax(tmp_path):
    yaml_path = tmp_path / "grid.yaml"
    yaml_path.write_text(yaml.dump(GRID))
    json_path = tmp_path / "grid.json"
    json_path.write_text(json.dumps(GRID))
    for path in (yaml_path, json_path):
        configs, original = parse(str(path))
        jconfigs, joriginal = jax_parse(str(path))
        assert configs == jconfigs and original == joriginal
    # YAML keeps tuples literal (4 experiments); in JSON every array is an
    # axis, the channel pair and the metrics list too
    assert len(parse(str(yaml_path))[0]) == 4
    assert len(parse(str(json_path))[0]) == 8


@pytest.mark.parametrize("tree", [
    GRID,
    {"a b/c": "x: 'y\"", "t": (1, (2, 3), [4, {"k": ()}]), "e": {},
     "n": None, "f": [1e-5, float("inf"), -2.5, 3.0], "s": ["12", "true",
                                                             ""],
     "nested": [[1, 2], ({"u": [1]},)], "b": True, "l": []},
], ids=["grid", "edge_cases"])
def test_dump_yaml_reads_back_to_the_same_tree(tree):
    assert yaml.full_load(dump_yaml(tree)) == tree


def _covidqu_tree(root, dtype_images=np.uint8, size=20, seed=0):
    rng = np.random.default_rng(seed)
    base = root / "COVID_QU" / "Inf_segm" / "data arrays" / "COVID-19"
    for part, n in (("train and val", 10), ("test", 4)):
        d = base / part
        d.mkdir(parents=True)
        imgs = rng.random((n, 1, size, size)) * 255
        np.save(d / "imgs.npy", imgs.astype(dtype_images))
        masks = np.zeros((n, 1, size, size), np.uint8)
        for m in masks:
            r, c = rng.integers(0, size - 8, 2)
            m[:, r:r + 8, c:c + 8] = 2
        np.save(d / "inf_masks.npy", masks)


@pytest.mark.parametrize("validate_on_test", [True, False])
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_covidqu_reader_matches_jax(tmp_path, monkeypatch, uint8,
                                    validate_on_test):
    """20 -> 16: float images within RESIZE_TOL of OpenCV, uint8 within one
    gray level on at least 99 % equal pixels (the port follows OpenCV's
    fixed-point rounding, so it reads all equal), masks and splits equal."""
    _covidqu_tree(tmp_path)
    monkeypatch.setenv("MST_DATA_DIR", str(tmp_path))
    cfg = {"lung_or_infection": "inf", "image_sizes": 16,
           "validate_on_test": validate_on_test, "seed": 7,
           "uint8_transfer": uint8}
    port = COVIDQUDataset(ConfigDict(cfg))
    ref = JaxCOVIDQU(JaxConfigDict(cfg))
    for split in ("train", "val"):
        got, want = getattr(port, split), getattr(ref, split)
        assert set(got) == set(want) == {"x", "mask"}
        assert got["x"].dtype == want["x"].dtype
        assert got["x"].shape == want["x"].shape
        assert got["x"].shape[1:] == (16, 16, 1)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        if uint8:
            diff = np.abs(got["x"].astype(int) - want["x"].astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        else:
            np.testing.assert_allclose(got["x"], want["x"], atol=RESIZE_TOL)
    assert len(port.val["x"]) == (4 if validate_on_test else 2)


def _balanced_columns(n=37, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 255, (n, 6, 6, 1)).astype(np.uint8)
    positives = (rng.random(n) < 0.35).astype(np.int32)
    return {"x": x, "mask": (x[..., 0] > 128).astype(np.int32),
            "positives": positives}


def _loaders(method, num_workers, lazy):
    """The two packages' loaders over the same columns and config."""
    out = []
    for cd_cls, loader_cls in ((JaxConfigDict, JaxLoader),
                               (ConfigDict, BalancedDataLoader)):
        data = _balanced_columns()
        load_function = None
        if lazy:
            # per-item lazy loads: the part the worker pool runs
            table = data["x"]
            data["x"] = [str(i) for i in range(len(table))]
            load_function = {"x": lambda key, t=table: t[int(key)]}
        sampling = cd_cls({"sampling": {"batch size": 4}})
        loader_cls.fill_kwargs(sampling["sampling"])
        cfg = sampling["sampling/train"]
        if method != "uniform":
            cfg["epoch"] = cd_cls({method: {"ratio of positives": 0.5}})
            cfg["batch"] = cd_cls({"min ratio of positives": 0.25,
                                   "min ratio of negatives": 0.25})
        out.append(loader_cls(data, cfg, bs=4, actual_bs=2, seed=11,
                              load_function=load_function,
                              num_workers=num_workers))
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("method", ["oversampling", "undersampling",
                                    "positives only", "uniform"])
def test_loader_batches_bit_equal_to_jax(method, num_workers):
    for lazy in (False, True):
        jax_loader, port_loader = _loaders(method, num_workers, lazy)
        assert len(port_loader) == len(jax_loader) > 0
        for _epoch in range(2):
            got, want = list(port_loader), list(jax_loader)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for key in a:
                    assert a[key].dtype == b[key].dtype
                    np.testing.assert_array_equal(a[key], b[key])


def test_batch_index_plan_bit_equal_to_jax():
    for cut in ({"amount": 0}, {"class": "pos", "amount": 2.5},
                {"class": "neg", "amount": 3.0}):
        got = batch_index_plan(40, 12, 1, 2, 6, cut,
                               np.random.default_rng(3))
        want = jax_plan(40, 12, 1, 2, 6, cut, np.random.default_rng(3))
        assert got == want


def _sample(seed=0, size=21, channels=3):
    rng = np.random.default_rng(seed)
    x = rng.random((size, size + 4, channels)).astype(np.float32)
    mask = rng.integers(0, 3, (size, size + 4)).astype(np.int32)
    return {"x": x, "mask": mask}


def test_random_rotation_matches_jax():
    """The same angles from the same seed; images within ROTATE_TOL of the
    JAX module's OpenCV warp; masks at least 99.9 % equal (nearest rounding
    at exact halves may differ), as tests/test_native.py holds OpenCV."""
    cfg = {"limit": 90, "p": 0.8}
    port = segmentation.RandomRotation(ConfigDict(cfg), seed=5)
    ref = jax_seg.RandomRotation(JaxConfigDict(cfg), seed=5)
    for k in range(6):
        got = port(**_sample(k))
        want = ref(**_sample(k))
        np.testing.assert_allclose(got["x"], want["x"], atol=ROTATE_TOL)
        assert (got["mask"] == want["mask"]).mean() >= 0.999
        assert got["mask"].dtype == want["mask"].dtype
    assert port.rng.random() == ref.rng.random()


@pytest.mark.parametrize("border", ["BORDER_REPLICATE", "BORDER_REFLECT",
                                    "BORDER_REFLECT_101", "BORDER_WRAP"])
@pytest.mark.parametrize("name, cfg", [
    ("RandomRotation", {"limit": 90, "p": 0.8}),
    ("DiscreteOrRandomRot", {"rotation_limit": 20})])
def test_rotation_on_other_borders_matches_jax(name, cfg, border):
    """The non-constant borders: OpenCV 5 warps float images in float on
    these too (no 1/32-pixel coordinate table), so images hold within
    ROTATE_TOL (they read 2.6e-6 at most) and masks equal on at least
    99.9 % of the pixels, the bar of the constant border (nearest rounding
    at exact halves may differ; on these samples every pixel is equal)."""
    cfg = dict(cfg, border_mode=border)
    port = getattr(segmentation, name)(ConfigDict(cfg), seed=5)
    ref = getattr(jax_seg, name)(JaxConfigDict(cfg), seed=5)
    for k in range(12):
        got, want = port(**_sample(k)), ref(**_sample(k))
        np.testing.assert_allclose(got["x"], want["x"], atol=ROTATE_TOL)
        assert (got["mask"] == want["mask"]).mean() >= 0.999


@pytest.mark.parametrize("channels", [1, 3, 4, 5])
def test_nearest_warp_picks_the_jax_modules_taps(channels):
    """Nearest warps (masks) tap the pixels the JAX module's OpenCV warp
    taps, every one, on every border: integer angles put source
    coordinates on exact half pixels, where OpenCV's float32 arithmetic
    (fused in its vectorised columns, not in its scalar tail) decides the
    side; 5 channels go through the JAX module's groups of four."""
    rng = np.random.default_rng(channels)
    for k in range(40):
        h, w = (int(v) for v in rng.integers(8, 60, 2))
        mask = rng.integers(0, 3, (h, w, channels)).astype(np.float32)
        angle = float(rng.integers(-180, 180))
        rad = np.deg2rad(angle)
        size = (int(abs(w * np.cos(rad)) + abs(h * np.sin(rad)) + 0.5),
                int(abs(w * np.sin(rad)) + abs(h * np.cos(rad)) + 0.5))
        matrix = warp.rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle)
        matrix[:, 2] += ((size[0] - w) / 2, (size[1] - h) / 2)
        border = warp.BORDER_MODES[k % 5]
        got = segmentation._warp_affine(mask, matrix, size, True, border, 2)
        want = jax_seg._warp_affine(mask, matrix, size, cv2.INTER_NEAREST,
                                    getattr(cv2, border), 2)
        np.testing.assert_array_equal(got, want.reshape(got.shape),
                                      err_msg=f"{angle} {border}")


@pytest.mark.parametrize("nearest", [False, True])
def test_warp_window_equals_the_full_warps_slice(nearest):
    """``warp_affine(..., window=...)`` (RandomPick's crop, computed alone)
    is the full warp's slice, bit for bit, also for windows that start
    before the output (numpy's negative starts) or end after it."""
    rng = np.random.default_rng(7)
    img = rng.random((21, 25, 3)).astype(np.float32)
    matrix = warp.rotation_matrix((12.0, 10.0), 37.0)
    matrix[:, 2] += (4.5, 3.0)
    full = warp.warp_affine(img, matrix, (34, 30), nearest=nearest)
    for rows, cols in ((slice(3, 19), slice(5, 21)), (slice(20, 40),
                       slice(-6, 40)), (slice(0, 30), slice(17, 18))):
        got = warp.warp_affine(img, matrix, (34, 30), nearest=nearest,
                               window=(rows, cols))
        np.testing.assert_array_equal(got, full[rows, cols])


@pytest.mark.parametrize("name, cfg", [
    ("RandomFlip", {"horizontal": True, "vertical": True,
                    "probability": 0.7}),
    ("RandomHorizontalFlip", {}),
    ("CenterCrop", {"size": 12}),
    ("RandomPick", {"crop size": 12, "rotation limit": 40}),
    ("DiscreteOrRandomRot", {"rotation_limit": 20}),
])
def test_segmentation_transforms_equal_jax(name, cfg):
    port = getattr(segmentation, name)(ConfigDict(cfg), seed=9)
    ref = getattr(jax_seg, name)(JaxConfigDict(cfg), seed=9)
    for k in range(8):
        got, want = port(**_sample(k)), ref(**_sample(k))
        for key in ("x", "mask"):
            assert got[key].shape == want[key].shape
            if name in ("RandomPick", "DiscreteOrRandomRot") and key == "x":
                # the continuous rotations inside: OpenCV's warp, to float
                # rounding
                np.testing.assert_allclose(got[key], want[key],
                                           atol=ROTATE_TOL)
            else:
                np.testing.assert_array_equal(got[key], want[key])


def test_partition_equals_jax():
    port = segmentation.Partition(ConfigDict({"number of partitions": 4}))
    ref = jax_seg.Partition(JaxConfigDict({"number of partitions": 4}))
    for index in range(6):
        got = port(_index=index, **_sample(index))
        want = ref(_index=index, **_sample(index))
        for key in ("x", "mask"):
            np.testing.assert_array_equal(got[key], want[key])
