"""The port's classification transforms against the JAX package's, on the
CPU: the same seed and the same numpy images (RGB float32 in [0, 1], one
image and ``k = 2`` lists) give the same outputs.  OneHotEncoding, CutMix,
MixupOrCutMix, the horizontal flip, the center crop and RandomErasing are
bit-equal; the transforms that resample (Resize, RandomResizedCrop) or
convert colours (ColorJitter) agree within TOL relative.  Each of
RandAugment's 14 ops, forced through both packages' ``_randaugment_ops``
with equal-seeded generators, agrees within OP_TOL on the 0-255 scale, and
so does the whole RandAugment over several seeds; the geometric ops under
bilinear interpolation agree within WARP_TOL on float32 images (OpenCV 5
sums a float32 bilinear warp in float32, the port in double: about 3e-6
relative), and so does a whole bilinear RandAugment.  Every op is
bit-equal on float64 images, which OpenCV still warps in fixed point (an
image turns float64 after a blend op's float64 factor).  The numpy maps
that stand in for OpenCV (3 x 3 Gaussian blur, histogram equalisation, the
float RGB/HSV conversions) are held against ``cv2`` itself."""
import cv2
import numpy as np
import pytest

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.data.transforms import classification as jc
from medsegpretrainimagenet_tpu.data.transforms.core import \
    build_transform as jax_build_transform
from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.data.transforms import \
    build_transform
from medsegpretrainimagenet_tpu_torch.data.transforms import \
    classification as pc

#: relative tolerance of the resampling and colour transforms
TOL = 1e-5
#: absolute tolerance of a RandAugment op on the 0-255 scale
OP_TOL = 1e-4
#: the same for the affine ops under bilinear interpolation
WARP_TOL = 2e-3


def _images(seed=0, shape=(40, 48, 3), n=2):
    rng = np.random.default_rng(seed)
    return [rng.random(shape).astype(np.float32) for _ in range(n)]


def _labels(n=2, classes=7, seed=1):
    return [int(c) for c in np.random.default_rng(seed).integers(0, classes,
                                                                 n)]


def _pair(name, *args, seed=5, **kwargs):
    return (getattr(jc, name)(*args, seed=seed, **kwargs),
            getattr(pc, name)(*args, seed=seed, **kwargs))


def _assert_same(got, want, tol=0.0):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, tol)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)


def _run_both(jax_t, port_t, k, n_calls=4, seed=0):
    for call in range(n_calls):
        images = _images(seed + call)
        data = {"x": images if k > 1 else images[0],
                "label": _labels(seed=call) if k > 1 else _labels(seed=call)[0]}
        yield (jax_t(k=k, **{key: (list(v) if isinstance(v, list) else v)
                            for key, v in data.items()}),
               port_t(k=k, **{key: (list(v) if isinstance(v, list) else v)
                             for key, v in data.items()}))


IMAGE_TRANSFORMS = [
    ("TVResize", dict(size=20), TOL),
    ("TVResize", dict(size=(33, 21)), TOL),
    ("TVCenterCrop", dict(size=24), 0.0),
    ("TVCenterCrop", dict(size=(50, 30)), 0.0),
    ("TVRandomHorizontalFlip", dict(p=0.5), 0.0),
    ("RandomResizedCrop", dict(size=24, scale=(0.08, 1.0)), TOL),
    ("RandomResizedCrop", dict(size=(16, 20), scale=(0.8, 1.0),
                               ratio=(0.2, 0.3)), TOL),
    ("ColorJitter", dict(brightness=0.4, contrast=0.4, saturation=0.4,
                         hue=0.2), TOL),
    ("RandomErasing", dict(p=0.7), 0.0),
    ("RandAugment", dict(num_ops=3, magnitude=9), OP_TOL / 255),
]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name, kwargs, tol", IMAGE_TRANSFORMS)
def test_image_transforms_match_jax(name, kwargs, tol, k):
    jax_t, port_t = _pair(name, **kwargs)
    for want, got in _run_both(jax_t, port_t, k):
        assert got["k"] == want["k"] == k
        _assert_same(got["x"], want["x"], tol)
        assert got["label"] == want["label"]


@pytest.mark.parametrize("k", [1, 2])
def test_one_hot_encoding_matches_jax(k):
    jax_t = jc.OneHotEncoding(JaxConfigDict({"num_classes": 7}))
    port_t = pc.OneHotEncoding(ConfigDict({"num_classes": 7}))
    assert port_t._eye is port_t._eye  # made once, not per item
    for want, got in _run_both(jax_t, port_t, k):
        _assert_same(got["label"], want["label"])
        _assert_same(got["x"], want["x"])


def _mixing_pair(name, params):
    """Both built as the CLIs build them, defaults filled in."""
    return (jax_build_transform(JaxConfigDict({
                f"classification.transforms.{name}": params}), seed=11),
            build_transform(ConfigDict({
                f"classification.transforms.{name}": params}), seed=11))


@pytest.mark.parametrize("name, params", [
    ("CutMix", {"probability": 0.7, "alpha": 1.0}),
    ("MixupOrCutMix", {}),
    ("MixupOrCutMix", {"mixup_params": {"distribution": "uniform",
                                        "probability": 0.8},
                       "switch_probability": 0.3}),
])
def test_pair_mixing_matches_jax(name, params):
    jax_t, port_t = _mixing_pair(name, params)
    one_hot = np.eye(7, dtype=np.float32)
    for call in range(8):
        images = _images(call)
        labels = [one_hot[c] for c in _labels(seed=call)]
        want = jax_t(k=2, x=list(images), label=list(labels))
        got = port_t(k=2, x=list(images), label=list(labels))
        assert got["k"] == want["k"]
        _assert_same(got["x"], want["x"])
        _assert_same(got["label"], want["label"])
        np.testing.assert_allclose(np.sum(got["label"]), 1.0, rtol=1e-6)


RANDAUGMENT_OPS = list(pc._randaugment_ops(None, 9, 31))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nearest", [True, False])
@pytest.mark.parametrize("op", RANDAUGMENT_OPS)
def test_each_randaugment_op_matches_jax(op, nearest, dtype):
    assert len(RANDAUGMENT_OPS) == 14
    for seed in range(3):
        img = (_images(seed, shape=(37, 45, 3), n=1)[0] * 255).astype(dtype)
        jrng, prng = (np.random.default_rng(seed) for _ in range(2))
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        want = jc._randaugment_ops(jrng, 13, 31, interp=interp,
                                   fill=0.0)[op](img.copy())
        got = pc._randaugment_ops(prng, 13, 31, nearest=nearest,
                                  fill=0.0)[op](img.copy())
        assert got.shape == want.shape and got.dtype == want.dtype
        affine = op in ("ShearX", "ShearY", "TranslateX", "TranslateY",
                        "Rotate")
        bilinear32 = affine and not nearest and dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=WARP_TOL if bilinear32 else OP_TOL)
        # the same draws were made
        assert jrng.random() == prng.random()


def test_randaugment_fill_is_first_channel_only():
    """A scalar border value is OpenCV's Scalar(fill, 0, 0, 0)."""
    img = np.full((20, 24, 3), 100.0, np.float32)
    for op in ("TranslateX", "Rotate"):
        want = jc._randaugment_ops(np.random.default_rng(0), 20, 31,
                                   interp=cv2.INTER_NEAREST,
                                   fill=7.0)[op](img)
        got = pc._randaugment_ops(np.random.default_rng(0), 20, 31,
                                  fill=7.0)[op](img)
        np.testing.assert_array_equal(got, want)
        assert (got[..., 0] == 7).any() and not (got[..., 1] == 7).any()


@pytest.mark.parametrize("seed", range(6))
def test_whole_randaugment_matches_jax_over_seeds(seed):
    jax_t = jc.RandAugment(num_ops=2, magnitude=9, seed=seed)
    port_t = pc.RandAugment(num_ops=2, magnitude=9, seed=seed)
    for call in range(6):
        img = _images(seed * 10 + call, shape=(32, 32, 3), n=1)[0]
        if call % 2:
            img = img * 255  # the uint8-transfer scale
        want = jax_t(x=img.copy())["x"]
        got = port_t(x=img.copy())["x"]
        scale = 255.0 if call % 2 else 1.0
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=OP_TOL / 255)
    assert jax_t.rng.random() == port_t.rng.random()


@pytest.mark.parametrize("seed", range(4))
def test_bilinear_randaugment_matches_jax(seed):
    jax_t = jc.RandAugment(num_ops=3, magnitude=15, seed=seed,
                           interpolation="BILINEAR")
    port_t = pc.RandAugment(num_ops=3, magnitude=15, seed=seed,
                            interpolation="BILINEAR")
    for call in range(8):
        img = _images(seed * 10 + call, shape=(32, 32, 3), n=1)[0]
        np.testing.assert_allclose(port_t(x=img.copy())["x"],
                                   jax_t(x=img.copy())["x"], rtol=0,
                                   atol=WARP_TOL / 255)
    assert jax_t.rng.random() == port_t.rng.random()


@pytest.mark.parametrize("shape", [(8, 9, 3), (64, 64, 3), (5, 7, 1),
                                   (3, 3), (224, 224, 3)])
def test_gaussian_blur_matches_cv2(shape):
    img = (np.random.default_rng(0).random(shape) * 255).astype(np.float32)
    want = cv2.GaussianBlur(img, (3, 3), 0).reshape(img.shape)
    np.testing.assert_array_equal(pc.gaussian_blur3(img), want)


def test_equalize_hist_matches_cv2():
    rng = np.random.default_rng(0)
    for trial in range(200):
        h, w = rng.integers(1, 40, 2)
        ch = ((rng.random((h, w)) * rng.integers(1, 256))
              + rng.integers(0, 100)).astype(np.uint8)
        if trial % 7 == 0:
            ch[:] = ch[0, 0]  # one value: OpenCV keeps it
        np.testing.assert_array_equal(pc.equalize_hist(ch),
                                      cv2.equalizeHist(ch))


def test_hsv_conversions_match_cv2():
    img = _images(3, shape=(64, 64, 3), n=1)[0]
    img[0, :4] = [[0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 1], [0.2, 0.7, 0.7]]
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got = pc.rgb_to_hsv(img)
    # hue in degrees: float32 rounding of a value below 360
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=4e-5)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    hsv = want.copy()
    hsv[..., 0] = (hsv[..., 0] + 77.7) % 360.0
    np.testing.assert_allclose(pc.hsv_to_rgb(hsv),
                               cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               rtol=0, atol=1e-7)
