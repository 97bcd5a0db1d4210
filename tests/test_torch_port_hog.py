"""The port's HOG+LAB features (ops/hog.py) held to the JAX package's on the
CPU, function by function.

Tolerances: rgb2lab rtol 1e-5 of the value plus atol 1e-4 (Lab values up to
100; torch's cube root is a power, JAX's a cbrt, an ulp apart); the
gradients exactly; the LAB patch features and every HOG/feature map 1e-5
(float32 sums in another order). The orientation bin is a truncation of
atan2 in degrees, and the frameworks' atan2 may differ by an ulp, so a pixel
on a bin edge may vote into the neighbouring bin on one side: the bin maps
of both sides are compared, and every pixel whose bin differs must lie
within 1e-3 degrees of an edge, or be a near tie: two channels whose
gradient magnitudes agree within 2^-20 (XLA may contract g_row² + g_col²
into one FMA under jit, so a tie within rounding may pick the other
channel; on 8-bit images swapped gradients such as (0.2, 0.51) and (0.51,
0.2) make such ties). The feature maps are compared at 1e-5 on images with
no such pixel (axis-aligned gradients, whose angles of 0 and 90 degrees
both compute exactly, excepted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmining_tpu.ops import hog as jhog

from diffmining_tpu_torch.ops import hog as phog

torch.set_num_threads(1)
EDGE = 180.0 / 31
TOL = dict(rtol=1e-5, atol=1e-5)


def _image(seed, h=80, w=72):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


@jax.jit
def _jax_bins(img):
    """The JAX hog_features' orientation step, written out with its ops and
    jitted as hog_features is."""
    g_row, g_col = jhog._channel_gradients(jnp.asarray(img))
    mag = jnp.sqrt(g_row**2 + g_col**2)
    idx = jnp.argmax(mag, axis=-1, keepdims=True)
    gr = jnp.take_along_axis(g_row, idx, axis=-1)[..., 0]
    gc = jnp.take_along_axis(g_col, idx, axis=-1)[..., 0]
    deg = jnp.rad2deg(jnp.arctan2(gr, gc)) % 180.0
    return deg, jnp.clip((deg / (180.0 / 31)).astype(jnp.int32), 0, 30)


def _edge_distance(deg):
    return np.abs(deg / EDGE - np.round(deg / EDGE)) * EDGE


def _ambiguous_pixels(img):
    """Pixels whose angle lies within 1e-3 degrees of a bin edge (the
    gradient not axis-aligned), or whose two largest channel magnitudes
    agree within 2^-20."""
    t = torch.from_numpy(img)
    gr, gc, _ = phog.dominant_gradients(t)
    deg, _ = phog.orientation_bins(gr, gc)
    axis = (gr == 0) | (gc == 0)
    g_row, g_col = phog._channel_gradients(t)
    top2 = torch.sqrt(g_row**2 + g_col**2).topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2.0**-20 * top2[..., 0]
    return ((_edge_distance(deg.numpy()) < 1e-3) & ~axis.numpy()) | (tie & (top2[..., 0] > 0)).numpy()


def test_rgb2lab_matches_jax():
    rgb = np.concatenate([_image(0, 16, 16).reshape(-1, 3), np.eye(3, dtype=np.float32),
                          np.array([[1, 1, 1], [0, 0, 0], [0.04045, 0.5, 0.001]], np.float32)])[None]
    got = phog.rgb2lab(torch.from_numpy(rgb)).numpy()
    want = np.asarray(jhog.rgb2lab(jnp.asarray(rgb)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[0, -3], [100, 0, 0], atol=0.2)


def test_channel_gradients_equal_jax():
    img = _image(1)
    got = phog._channel_gradients(torch.from_numpy(img))
    want = jhog._channel_gradients(jnp.asarray(img))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,quantised", [(0, False), (4, False), (1, True)])
def test_orientation_bins_differ_only_where_ambiguous(seed, quantised):
    """Images with ambiguous pixels (near bin edges; seed 1's 8-bit image
    has a near tie that XLA breaks the other way): the bin maps agree at
    every other pixel."""
    img = _image(seed)
    if quantised:
        img = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
    deg_j, bins_j = (np.asarray(a) for a in _jax_bins(jnp.asarray(img)))
    gr, gc, _ = phog.dominant_gradients(torch.from_numpy(img))
    deg_p, bins_p = phog.orientation_bins(gr, gc)
    differ = bins_p.numpy() != bins_j
    ambiguous = _ambiguous_pixels(img)
    assert ambiguous.sum() > 0
    assert np.all(ambiguous[differ]), np.argwhere(differ & ~ambiguous)
    np.testing.assert_allclose(deg_p.numpy()[~ambiguous], deg_j[~ambiguous], rtol=0, atol=1e-4)


def test_hog_features_match_jax_clear_of_bin_edges():
    img = _image(9)
    assert not _ambiguous_pixels(img).any()
    got = phog.hog_features(torch.from_numpy(img)).numpy()
    want = np.asarray(jhog.hog_features(jnp.asarray(img)))
    assert got.shape == want.shape == (3, 2, 8 * 8 * 31)
    np.testing.assert_allclose(got, want, **TOL)


def test_lab_patch_features_match_jax():
    img = _image(2, 96, 80)
    got = phog.lab_patch_features(torch.from_numpy(img)).numpy()
    want = np.asarray(jhog.lab_patch_features(jnp.asarray(img)))
    assert got.shape == want.shape == (5, 3, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_hoglab_features_match_jax_in_its_layout():
    """[nx, ny, 2112] after the transpose, then L2-normalised; 8-bit input
    is scaled to [0, 1] first, as in JAX."""
    img = _image(9)
    assert not _ambiguous_pixels(img).any()
    got = phog.hoglab_features(img, device="cpu")
    want = np.asarray(jhog.hoglab_features(img))
    assert got.shape == want.shape == (2, 3, 2112) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(phog.normalize_features(got), jhog.normalize_features(want), **TOL)
    np.testing.assert_array_equal(phog.normalize_features(want), jhog.normalize_features(want))
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(phog.hoglab_features(u8, device="cpu"),
                                  phog.hoglab_features(u8.astype(np.float32) / 255.0, device="cpu"))


def test_hoglab_features_defaults_to_the_card(monkeypatch):
    """No device given: the card, and without one it raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phog.hoglab_features(np.zeros((64, 64, 3), np.uint8))
