"""The port's data path on the card: the loader's prefetch stages batches
in pinned memory and copies them with no host sync, a pinned buffer lives
until its copy has completed, and ``device_augment`` on the card equals its
CPU version within 1e-5 on injected angles.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cli_gpu.py -q
"""
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.data.loader import (PinnedCopier,
                                                          prefetch_to_device)
from medsegpretrainimagenet_tpu_torch.ops import augment

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test copies to and computes on "
                    "the card")
    return torch.device("cuda")


def _batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.random((1, 4, 64, 64, 3)).astype(np.float32),
             "mask": rng.integers(0, 2, (1, 4, 64, 64)).astype(np.int32)}
            for _ in range(n)]


def test_prefetch_copies_are_pinned_and_async(cuda_device):
    batches = _batches()
    copier = PinnedCopier(cuda_device)
    torch.cuda.set_sync_debug_mode("error")  # a synchronous copy raises
    try:
        out = list(prefetch_to_device(iter(batches), size=2, put=copier))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(t.is_pinned() for t in copier.last_host.values())
    for got, want in zip(out, batches):
        for key, value in want.items():
            assert got[key].is_cuda
            assert np.array_equal(got[key].cpu().numpy(), value)


def test_pinned_buffers_live_until_their_copy_completes(cuda_device):
    """The copier keeps each batch's pinned tensors with the event recorded
    after their copy, and lets them go once the event has completed."""
    copier = PinnedCopier(cuda_device)
    # a long kernel ahead of the copies keeps them queued
    big = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(20):
        big = big @ big / 4096
    for batch in _batches(3):
        copier(batch)
    assert len(copier._in_flight) == 3
    torch.cuda.synchronize()
    copier(_batches(1, seed=5)[0])
    assert len(copier._in_flight) == 1


def test_device_augment_on_the_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((6, 33, 47, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.integers(0, 3, (6, 33, 47, 1)).astype(
        np.int32))
    angles = torch.tensor([0.0, 12.5, -77.0, 90.0, 179.0, -180.0])
    for images, nearest in ((x, False), (mask, True),
                            ((x * 255).to(torch.uint8), False)):
        cpu = augment.rotate_batch(images, angles, fill=0.5,
                                   nearest=nearest)
        card = augment.rotate_batch(images.to(cuda_device),
                                    angles.to(cuda_device), fill=0.5,
                                    nearest=nearest).cpu()
        if nearest:
            # a coordinate at an exact half may round either way on the
            # two devices' sin and cos
            assert (card == cpu).float().mean() >= 0.999
        elif images.dtype == torch.uint8:
            assert (card.int() - cpu.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(card, cpu, atol=TOL, rtol=0)
    fv = torch.tensor([True, False, True, False, True, False])
    fh = torch.tensor([False, True, True, False, False, True])
    torch.testing.assert_close(
        augment.flip_batch(x.to(cuda_device), fv.to(cuda_device),
                           fh.to(cuda_device)).cpu(),
        augment.flip_batch(x, fv, fh), atol=0, rtol=0)
    chain = augment.make_device_augment(rotation_limit=30,
                                        flip_vertical=True,
                                        channel_repeats=3)
    generator = torch.Generator(device=cuda_device).manual_seed(0)
    batch = {"x": x[..., :1].to(cuda_device),
             "mask": mask[..., 0].to(cuda_device)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the chain queues no sync
    try:
        out = chain(generator, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out["x"].shape == (6, 33, 47, 3) and out["mask"].dtype \
        == torch.int32
