"""CPU parity of the PyTorch port's kernel modules with the JAX package.

The port's three kernels (K1a ORB describe, K1b stereo SAD, K2g gated
Hamming best-2) run as CUDA only on the card; on the CPU their wrappers take
the plain PyTorch versions. Their building blocks are held here against the
JAX package: the gather against the Pallas kernel in interpret mode, the
masked best-2 against the XLA best-2 sequence (exact) and the Pallas kernel
in interpret mode (exact distances, indices up to ties). Inputs are made
with numpy from a seed and handed to both sides. The fused plain versions
are held to the JAX functions in tests/test_torch_fused.py.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lldslam_tpu.ops import hamming as jham  # noqa: E402
from lldslam_tpu.ops import pallas_match  # noqa: E402
from lldslam_tpu.ops import patch_sample as jps  # noqa: E402
from lldslam_tpu_torch.ops import hamming, match_best2  # noqa: E402
from lldslam_tpu_torch.ops import orb_describe, stereo_sad  # noqa: E402
from lldslam_tpu_torch.ops import patch_sample as tps  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _aligned_k1_inputs(seed):
    """Inputs satisfying the Pallas kernel's Mosaic preconditions
    (tests/test_patch_sample.py)."""
    rng = np.random.default_rng(seed)
    V, H, Wp = 2, 64, 384
    img = np.round(rng.uniform(0, 255, (V, H, Wp))).astype(np.float32)
    n, S = 16, 512
    meta = np.stack([
        rng.integers(0, V, n),
        rng.integers(0, H - jps.ROWS + 1, n),
        rng.integers(0, (Wp - jps.COLS) // 128 + 1, n) * 128,
        np.zeros(n, np.int64)], -1).astype(np.int32)
    iy = rng.integers(0, jps.ROWS, (n, S)).astype(np.int32)
    ix = rng.integers(0, jps.COLS, (n, S)).astype(np.int32)
    return img, meta, iy, ix


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_k1_plain_equals_pallas_interpret(dtype):
    """Exact (integer intensities): the plain gather against the Pallas
    kernel run in interpret mode, for float32 and uint8 images."""
    img, meta, iy, ix = _aligned_k1_inputs(0)
    want = np.asarray(jps.sample_patches(
        jnp.asarray(img), jnp.asarray(meta), jnp.asarray(iy),
        jnp.asarray(ix), interpret=True))
    got = tps.sample_patches_plain(_t(img.astype(dtype)), _t(meta), _t(iy),
                                   _t(ix)).numpy()
    np.testing.assert_array_equal(got, want)


def _wrapper_case(name):
    """(wrapper, plain version, CPU arguments, launch counter module) of one
    fused kernel, at a small size with out-of-image taps."""
    rng = np.random.default_rng(1)
    hw = [(50, 70), (42, 58)]
    stack = _t(np.round(rng.uniform(0, 255, (4, 50, 70))).astype(np.float32))
    if name == "orb_describe":
        n = 13
        xy = np.stack([rng.integers(0, 58, n), rng.integers(0, 42, n)], -1)
        args = (stack, stack.flip(-1).contiguous(), _t(xy.astype(np.int32)),
                _t(rng.integers(0, 4, n).astype(np.int32)),
                [hw[0], hw[0], hw[1], hw[1]])
        return orb_describe.describe, orb_describe.describe_plain, args, \
            orb_describe
    if name == "stereo_sad":
        n = 17
        lvl = rng.integers(0, 2, n).astype(np.int32)
        cols = [_t(rng.integers(-3, 60, n).astype(np.int32)) for _ in "uvr"]
        return stereo_sad.sad_refine, stereo_sad.sad_refine_plain, \
            (stack, hw, _t(lvl), *cols), stereo_sad
    M, N = 40, 30
    a, b = _desc(rng, M), _desc(rng, N)
    b[10:14] = b[:4]
    xy = rng.uniform(0, 40, (N, 2)).astype(np.float32)
    xy[10:14] = xy[:4]
    f32 = lambda *s: _t(rng.uniform(0, 40, s).astype(np.float32))
    args = (_t(a.view(np.int32)), f32(M), f32(M), f32(M),
            _t(np.full(M, 12.0, np.float32)),
            _t(rng.integers(0, 3, M).astype(np.int32)),
            _t(rng.uniform(size=M) < 0.9), _t(b.view(np.int32)), _t(xy),
            _t(np.where(rng.uniform(size=N) < 0.5, -1.0, 20.0).astype(np.float32)),
            _t(rng.integers(0, 3, N).astype(np.int32)),
            _t(rng.uniform(size=N) < 0.9))
    return match_best2.gated_best2, match_best2.gated_best2_plain, args, \
        match_best2


@pytest.mark.parametrize("name", ["orb_describe", "stereo_sad",
                                  "gated_best2"])
def test_wrapper_takes_plain_version_on_cpu(name):
    """A CPU tensor goes to the plain version; the kernel counter only counts
    CUDA launches. Taps outside the image are clamped."""
    wrapper, plain, args, mod = _wrapper_case(name)
    before = mod.launches
    got = wrapper(*args)
    assert mod.launches == before
    for g, w in zip(got, plain(*args)):
        assert g.device.type == "cpu"
        assert torch.equal(g, w)


def _k2_fixture(seed, M, N, density):
    rng = np.random.default_rng(seed)
    a, b = _desc(rng, M), _desc(rng, N)
    mask = rng.uniform(size=(M, N)) < density
    b[N // 2:N // 2 + 8] = b[:8]           # duplicate columns: exact ties
    mask[:16, :8] = True
    mask[:16, N // 2:N // 2 + 8] = True
    mask[20] = False                       # empty row
    mask[21] = False
    mask[21, 5] = True                     # one-candidate row
    return a, b, mask


def _xla_best2(a, b, mask):
    """The XLA sequence of lldslam_tpu/frontend/matching.py:160-166."""
    dmat = jham.distance_matrix(jnp.asarray(a), jnp.asarray(b))
    d = jnp.where(jnp.asarray(mask), dmat, jham.INF_DIST)
    best_kp = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_kp[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_kp].set(jham.INF_DIST)
    second_kp = jnp.argmin(d2, axis=1)
    second = jnp.take_along_axis(d2, second_kp[:, None], axis=1)[:, 0]
    return [np.asarray(x) for x in (best_kp, best, second, second_kp)]


@pytest.mark.parametrize("shape,density", [((256, 512), 0.02),
                                           ((300, 200), 0.3)])
def test_k2_plain_equals_xla_sequence(shape, density):
    """Exact: distances and all four indices, including tied columns, an
    empty row (INF_DIST, column 0) and a one-candidate row."""
    a, b, mask = _k2_fixture(2, *shape, density)
    want = _xla_best2(a, b, mask)
    got = [x.numpy() for x in match_best2.masked_best2_plain(
        _t(a.view(np.int32)), _t(b.view(np.int32)), _t(mask))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))
    assert got[1][20] == jham.INF_DIST and got[0][20] == 0 and got[3][20] == 0
    assert got[0][21] == 5 and got[2][21] == jham.INF_DIST and got[3][21] == 0


def test_k2_plain_vs_pallas_interpret():
    """Distances equal; indices equal up to ties (the Pallas fold visits
    columns tile by tile, so a tied runner-up may be another column)."""
    a, b, mask = _k2_fixture(3, 256, 512, 0.05)
    pk = [np.asarray(x) for x in pallas_match.masked_best2(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), interpret=True)]
    got = [x.numpy() for x in match_best2.masked_best2_plain(
        _t(a.view(np.int32)), _t(b.view(np.int32)), _t(mask))]
    np.testing.assert_array_equal(got[1], pk[1])
    np.testing.assert_array_equal(got[2], pk[2])
    dist = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    rows = np.nonzero(got[1] < jham.INF_DIST)[0]
    assert (dist[rows, pk[0][rows]] == got[1][rows]).all()
    assert (got[0][rows] == pk[0][rows]).mean() > 0.9
    rows2 = np.nonzero(got[2] < jham.INF_DIST)[0]
    assert (dist[rows2, pk[3][rows2]] == got[2][rows2]).all()


def test_hamming_distance_and_bit_packing():
    """distance_matrix exact against the JAX bit-matmul; pack_bits wraps bit
    31 into the int32 sign and round-trips through unpack_bits."""
    rng = np.random.default_rng(4)
    a, b = _desc(rng, 40), _desc(rng, 50)
    want = np.asarray(jham.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = hamming.distance_matrix(_t(a.view(np.int32)), _t(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    bits = hamming.unpack_bits(_t(a.view(np.int32)))
    np.testing.assert_array_equal(hamming.pack_bits(bits).numpy(), a.view(np.int32))
    pairs = hamming.distance_pairs(_t(a[:40].view(np.int32)),
                                   _t(b[:40].view(np.int32))).numpy()
    np.testing.assert_array_equal(pairs, np.asarray(jham.distance_pairs(
        jnp.asarray(a[:40]), jnp.asarray(b[:40]))))


@pytest.mark.parametrize("mutual,ratio", [(True, 1.0), (False, 0.7)])
def test_match_descriptors_and_rotation_mask(mutual, ratio):
    """match_descriptors and rotation_consistency_mask give the JAX indices
    and masks exactly (integer distances; top-3 bins with lax.top_k ties)."""
    rng = np.random.default_rng(5)
    a, b = _desc(rng, 120), _desc(rng, 100)
    b[:60] = a[:60] ^ (rng.uniform(size=(60, 8)) < 0.05).astype(np.uint32)
    va = rng.uniform(size=120) < 0.95
    vb = rng.uniform(size=100) < 0.95
    ang_a = rng.uniform(-np.pi, np.pi, 120).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 100).astype(np.float32)
    ji, jok, jd = jham.match_descriptors(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb),
        max_dist=jham.TH_HIGH, ratio=ratio, mutual=mutual)
    ti, tok, td = hamming.match_descriptors(
        _t(a.view(np.int32)), _t(va), _t(b.view(np.int32)), _t(vb),
        max_dist=hamming.TH_HIGH, ratio=ratio, mutual=mutual)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jm = jham.rotation_consistency_mask(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                        ji, jok)
    tm = hamming.rotation_consistency_mask(_t(ang_a), _t(ang_b), ti, tok)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
