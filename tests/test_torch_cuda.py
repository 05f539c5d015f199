"""The port's CUDA kernels and its frame build on an NVIDIA GPU.

These tests need the card and `nvcc`: a CUDA kernel has no CPU mode, so
without a card each test skips with the reason. They import no JAX, so they
run on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same device tensors
(exact: K1 gathers integer intensities, K2 computes integer distances under
one tie contract), and the frame build on the card to the frame build on the
CPU (integer pipeline exact; descriptors and stereo through the same
tolerances as the JAX parity tests, since sin/cos/atan2 may differ by an ulp
between the card's and the CPU's math libraries).
"""
import numpy as np
import pytest
import torch

from lldslam_tpu_torch.config import CameraConfig
from lldslam_tpu_torch.frontend import frame
from lldslam_tpu_torch.io.synthetic import make_sequence
from lldslam_tpu_torch.ops import match_best2, patch_sample
from lldslam_tpu_torch.ops.orb import OrbConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels of "
                    "lldslam_tpu_torch have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,S", [(torch.uint8, 512), (torch.float32, 121),
                                     (torch.float32, 749)])
def test_k1_equals_plain(dev, dtype, S):
    rng = np.random.default_rng(0)
    V, H, W, n = 16, 376, 1241, 1000
    img = torch.from_numpy(rng.integers(0, 256, (V, H, W)).astype(np.uint8)) \
        .to(dev).to(dtype)
    meta = np.stack([rng.integers(0, V, n), rng.integers(0, H, n),
                     rng.integers(0, W, n), np.zeros(n, int)], -1)
    iy = rng.integers(-20, 21, (n, S))
    ix = rng.integers(-20, 21, (n, S))
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    before = patch_sample.launches
    got = patch_sample.sample_patches(img, t(meta), t(iy), t(ix))
    want = patch_sample.sample_patches_plain(img, t(meta), t(iy), t(ix))
    torch.cuda.synchronize()
    assert patch_sample.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,N", [(4096, 2048), (2048, 2048), (300, 77)])
def test_k2_equals_plain(dev, M, N):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b[N // 2:N // 2 + 8] = b[:8]
    mask = rng.uniform(size=(M, N)) < 0.02
    mask[:32, :8] = True
    mask[:32, N // 2:N // 2 + 8] = True
    mask[40] = False
    mask[41] = False
    mask[41, 3] = True
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    args = (t(a.view(np.int32)), t(b.view(np.int32)), t(mask))
    before = match_best2.launches
    got = match_best2.masked_best2(*args)
    want = match_best2.masked_best2_plain(*args)
    torch.cuda.synchronize()
    assert match_best2.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int64), w.to(torch.int64))
    assert int(got[1][40]) == 10000 and int(got[0][41]) == 3


def test_k2_rejects_bad_inputs(dev):
    a = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        match_best2.masked_best2(a, a, torch.zeros((4, 5), dtype=torch.bool,
                                                   device=dev))
    with pytest.raises(ValueError):
        match_best2.masked_best2(a.float(), a, torch.zeros((4, 4),
                                                           dtype=torch.bool,
                                                           device=dev))


def test_frame_build_on_card_matches_cpu(dev):
    cam = CameraConfig().stereo_camera()
    frames = make_sequence(cam, 1, seed=3)
    pair = np.stack(frames[0])
    cfg = OrbConfig(n_features=2000)
    k1 = patch_sample.launches
    g = frame.build_frame_pair(torch.from_numpy(pair).to(dev), cam, cfg)
    torch.cuda.synchronize()
    assert patch_sample.launches - k1 == 4   # orientation, BRIEF, 2 SAD
    c = frame.build_frame_pair(torch.from_numpy(pair), cam, cfg)
    gf, cf = g.feats, c.feats
    assert torch.equal(gf.xy.cpu(), cf.xy)
    assert torch.equal(gf.octave.cpu(), cf.octave)
    assert torch.equal(gf.valid.cpu(), cf.valid)
    v = cf.valid
    assert (gf.angle.cpu() - cf.angle)[v].abs().max() <= 1e-5
    same = (gf.desc.cpu() == cf.desc).all(-1)[v]
    assert same.float().mean() >= 0.995
    gu, cu = gf.ur.cpu(), cf.ur
    assert ((gu >= 0) == (cu >= 0)).float().mean() >= 0.99
    both = (gu >= 0) & (cu >= 0)
    assert ((gu - cu)[both].abs() <= 1e-3).float().mean() >= 0.99
