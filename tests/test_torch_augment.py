"""The port's class-balanced augmentation (unet_implementations_tpu_torch/
data/augment.py) against the JAX package's ``data/augment.py``, on the CPU.

- Each piece on the same inputs, at the tolerance named in its test: the
  homography builders, REFLECT_101, HSV, the equalization LUTs, the blurs,
  the noise-grid upsample (JAX's ``jax.image.resize``), the three
  displacement fields and ``warp_pair``.
- The whole augmenter on JAX's own draws: ``jax_draws`` repeats
  ``augment_one``'s key splits and returns every value it draws, and the
  port's ``apply_params`` on them is held to jitted ``augment_one`` at 64²,
  for both classes, the default policy and one with every probability 1, on
  keys that take every branch of the five OneOf groups (``KEY_BRANCHES``).
- The port's own sampler (a torch generator, so other draws than JAX's),
  held to the policy as ``tests/test_augment.py`` holds JAX's.
- ``load_policy_yaml``, ``class_index_for`` and ``is_cat_image`` against
  JAX's; the online wrappers; the offline expansion and ``cli augment``
  against JAX's on one dataset.
"""

import shutil
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_implementations_tpu.data import augment as A
from unet_implementations_tpu.data import pipeline as jax_pipeline
from unet_implementations_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from unet_implementations_tpu_torch import cli
from unet_implementations_tpu_torch.data import augment as T
from unet_implementations_tpu_torch.data import pipeline
from unet_implementations_tpu_torch.models.clip import ClipFeatureExtractor
from unet_implementations_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from unet_implementations_tpu_torch.recipes import common

H = W = 64
# The stages after the colour OneOf: with these probabilities at 0, JAX's
# augment_one returns the image its histogram stage would have received.
LATE_GATES = ("hist_prob", "noise_prob", "saltpepper_prob", "iso_prob", "lighting_prob")
ONES = {k: ((1.0, 1.0) if k.endswith("_prob") else v) for k, v in A.POLICY.items()}
ZEROS = {k: ((0.0, 0.0) if k.endswith("_prob") else v) for k, v in A.POLICY.items()}
POLICIES = {"default": A.POLICY, "ones": ONES}
# jax.random.key(k) -> the branch each OneOf group picks (every branch of
# every group is taken by one of these keys; with ONES every gate is on).
KEY_BRANCHES = {
    0: {"distort_pick": 0, "color_pick": 1, "hist_pick": 1, "noise_pick": 2,
        "lighting_pick": 1},
    4: {"distort_pick": 1, "color_pick": 2, "hist_pick": 2, "noise_pick": 1,
        "lighting_pick": 2},
    24: {"distort_pick": 2, "color_pick": 0, "hist_pick": 0, "noise_pick": 0,
         "lighting_pick": 0},
}
# The whole augmenter's tolerances against augment_one (each piece states its own).
IMAGE_REL_L2 = 1e-5
MASK_AGREEMENT = 0.999

augment_one = jax.jit(A.augment_one)


def _pair(seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.int32)
    mask[16:48, 16:48] = 1
    mask[14:16, 14:50] = 255
    return img, mask


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def jax_draws(key, class_idx, policy, h, w):
    """Every value ``augment_one(key, ...)`` draws, by its own key splits
    (``data/augment.py:468, 211, 248, 269, 547-567``), with the policy's
    limits applied as it applies them: the keys of ``sample_params``."""
    p = {k: v[class_idx] for k, v in policy.items()}
    U = jax.random.uniform
    keys = jax.random.split(key, 24)
    k1, k2, k3, k4, k5, k6, k7, k8 = jax.random.split(keys[0], 8)
    d = {"flip": U(k1) < p["hflip_prob"],
         "ssr": U(k2) < p["ssr_prob"],
         "shift": U(k3, (2,), minval=-1.0, maxval=1.0) * p["shift_limit"],
         "scale": 1.0 + U(k4, minval=-1.0, maxval=1.0) * p["scale_limit"],
         "angle": U(k5, minval=-1.0, maxval=1.0) * p["rotate_limit"],
         "rrc": U(k6) < p["rrc_prob"],
         "area": U(k7, minval=p["rrc_scale_min"], maxval=1.0)}
    d["off"] = U(k8, (2,), minval=0.0, maxval=1.0) * (1.0 - jnp.sqrt(d["area"]))
    pk1, pk2 = jax.random.split(keys[1])
    d["perspective"] = U(pk1) < p["perspective_prob"]
    d["jitter"] = U(pk2, (8,), minval=-1.0, maxval=1.0) * p["perspective_scale"]
    kg, kp, dk1, dk2, dk3 = jax.random.split(keys[2], 5)
    d["distort"] = U(kg) < p["distort_prob"]
    d["distort_pick"] = jax.random.randint(kp, (), 0, 3)
    d["elastic"] = jax.random.normal(dk1, (2, 16, 16)) * p["elastic_alpha"] / 8.0
    cell = U(dk2, (2, 5, 5), minval=-1.0, maxval=1.0)
    d["grid"] = cell * p["grid_distort_limit"] * (
        jnp.array([h, w], jnp.float32).reshape(2, 1, 1) / 5) * 0.5
    d["optical"] = U(dk3, minval=-1.0, maxval=1.0) * p["optical_distort_limit"]
    d["dropout"] = U(keys[3]) < p["dropout_prob"]
    d["hole_h"] = U(keys[4]) * p["dropout_max"]
    d["hole_w"] = U(keys[5]) * p["dropout_max"]
    d["hole_cy"] = U(keys[6]) * h
    d["hole_cx"] = U(keys[7]) * w
    d["color"] = U(keys[8]) < p["color_prob"]
    d["color_pick"] = jax.random.randint(keys[9], (), 0, 3)
    d["brightness"] = U(keys[10], minval=-1.0, maxval=1.0) * p["brightness_limit"]
    d["contrast"] = 1.0 + U(keys[11], minval=p["contrast_lo"], maxval=p["contrast_hi"])
    s = U(keys[12], (3,), minval=-1.0, maxval=1.0)
    d["hsv_shift"] = jnp.stack([s[0] * p["hue_shift"] / 360.0, s[1] * p["sat_shift"] / 255.0,
                                s[2] * p["val_shift"] / 255.0])
    d["rgb_shift"] = U(keys[13], (3,), minval=-1.0, maxval=1.0) * (p["rgb_shift"] / 255.0)
    d["hist"] = U(keys[14]) < p["hist_prob"]
    d["hist_pick"] = jax.random.randint(keys[15], (), 0, 3)
    d["noise"] = U(keys[16]) < p["noise_prob"]
    d["noise_pick"] = jax.random.randint(keys[17], (), 0, 3)
    d["noise_std"] = jnp.sqrt(U(keys[18]) * p["gauss_var_max"]) / 255.0
    d["gauss"] = jax.random.normal(keys[19], (h, w, 3))
    d["blur_sigma"] = U(keys[20]) * p["blur_sigma_max"]
    d["motion_dir"] = jax.random.randint(keys[21], (), 0, 4)
    k_sp, k_iso, k_light = (jax.random.fold_in(keys[22], i) for i in range(3))
    sp1, sp2, sp3, _ = jax.random.split(k_sp, 4)
    d["saltpepper"] = U(sp1) < p["saltpepper_prob"]
    d["sp_amount"] = U(sp2) * p["sp_amount_max"] * 0.5
    d["sp_u"] = U(sp3, (h, w))
    i1, i2, i3 = jax.random.split(k_iso, 3)
    d["iso"] = U(i1) < p["iso_prob"]
    d["iso_intensity"] = U(i2) * p["iso_intensity_max"]
    d["iso_noise"] = jax.random.normal(i3, (h, w, 3))
    l1, l2, l3, l4 = jax.random.split(k_light, 4)
    d["lighting"] = U(l1) < p["lighting_prob"]
    d["lighting_pick"] = jax.random.randint(l2, (), 0, 3)
    d["light_field"] = U(l3, (8, 8))
    d["fog"] = U(l4) * p["fog_coef_max"]
    return {k: np.asarray(v) for k, v in d.items()}


def as_params(draws):
    """A list of per-image draws -> ``apply_params``'s batched tensors."""
    out = {}
    for k in draws[0]:
        a = np.stack([d[k] for d in draws])
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
    return out


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


class TestGeometryPieces:
    def test_translate_and_scale_rotate(self):
        """1e-6 of each matrix's largest entry (translations of tens of
        pixels sit beside cosines)."""
        rng = np.random.default_rng(1)
        tx, ty = rng.normal(0, 10, (2, 6)).astype(np.float32)
        scale = rng.uniform(0.85, 1.15, 6).astype(np.float32)
        angle = rng.uniform(-15, 15, 6).astype(np.float32)
        ours_t = T._translate(t(tx), t(ty)).numpy()
        ours_sr = T._scale_rotate(t(scale), t(angle), 31.5, 20.5).numpy()
        for i in range(6):
            np.testing.assert_allclose(ours_t[i], np.asarray(A._translate(tx[i], ty[i])),
                                       rtol=0, atol=1e-6)
            want = np.asarray(A._scale_rotate(scale[i], angle[i], 31.5, 20.5))
            np.testing.assert_allclose(ours_sr[i], want, rtol=0, atol=1e-6 * np.abs(want).max())

    def test_reflect101_exact(self):
        coords = np.array([-70.5, -64.0, -2.0, -1.0, -0.25, 0.0, 5.0, 6.0, 7.0, 10.5, 63.0,
                           64.0, 126.75, 1e3], np.float32)
        for size in (6, 64):
            np.testing.assert_array_equal(T._reflect101(t(coords), size).numpy(),
                                          np.asarray(A._reflect101(jnp.asarray(coords), size)))

    def test_noise_grid_upsample_equals_jax_resize(self):
        """jax.image.resize(method="linear") renormalizes its triangle kernel
        at the edges; the port's resize clamps the source coordinate. Both
        give edge weight 1 when upsampling: 16→64, 5→64 and 8→64 agree to 1e-6
        of the largest value."""
        rng = np.random.default_rng(2)
        for g in (16, 5, 8):
            x = rng.normal(0, 5, (2, g, g)).astype(np.float32)
            want = np.asarray(jax.image.resize(jnp.asarray(x), (2, H, W), method="linear"))
            got = T._upsample_grid(t(x)[None], H, W)[0].numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(x).max())

    @pytest.mark.parametrize("key,pick", [(0, 0), (4, 1), (24, 2)])
    def test_displacement_fields(self, key, pick):
        """Each field (elastic, grid, optical) from the same noise arrays:
        1e-5 absolute (fields of a few pixels)."""
        policy = A.policy_arrays({**A.POLICY, "distort_prob": (1.0, 1.0)})
        k = jax.random.key(key)
        draws = jax_draws(k, 0, policy, H, W)
        p = {name: v[0] for name, v in policy.items()}
        dy, dx = A._displacement_field(jax.random.split(k, 24)[2], H, W, p)
        P = as_params([draws])
        assert int(P["distort_pick"][0]) == pick and bool(P["distort"][0])
        ody, odx = T._displacement_field(P["distort"], P["distort_pick"], P["elastic"],
                                         P["grid"], P["optical"], H, W)
        np.testing.assert_allclose(ody[0].numpy(), np.asarray(dy), rtol=0, atol=1e-5)
        np.testing.assert_allclose(odx[0].numpy(), np.asarray(dx), rtol=0, atol=1e-5)
        assert np.abs(np.asarray(dx)).max() > 0.1

    def _warp_cases(self):
        eye = np.eye(3, dtype=np.float32)
        flip = np.array([[-1, 0, W - 1], [0, 1, 0], [0, 0, 1]], np.float32)
        rot = np.asarray(A._scale_rotate(1.12, 13.0, (W - 1) / 2, (H - 1) / 2)
                         @ A._translate(-3.2, 1.7))
        persp = np.array([[1.02, -0.008, 0.3], [0.006, 0.98, -0.2], [6e-4, -4e-4, 1.0]],
                         np.float32)
        zero = np.zeros((H, W), np.float32)
        policy = {name: v[0] for name, v in A.policy_arrays(
            {**A.POLICY, "distort_prob": (1.0, 1.0)}).items()}
        # Key 0's field is the elastic one (KEY_BRANCHES).
        ey, ex = (np.asarray(v) for v in A._displacement_field(
            jax.random.split(jax.random.key(0), 24)[2], H, W, policy))
        return {"identity": (eye, zero, zero), "flip": (flip, zero, zero),
                "rotation_scale": (rot, zero, zero), "perspective": (persp, zero, zero),
                "elastic": (rot, ey, ex)}

    @pytest.mark.parametrize("case", ["identity", "flip", "rotation_scale", "perspective",
                                      "elastic"])
    def test_warp_pair(self, case):
        """Image: max |error| 1e-5. Mask: equal except where a source
        coordinate sits within float32 rounding of a .5 tie, which nearest
        rounding may break either way: fewer than 0.1% of the pixels, counted
        in the message."""
        Hm, dy, dx = self._warp_cases()[case]
        img, mask = _pair(3)
        mask[40:44, 8:20] = 2
        ji, jm = (np.asarray(v) for v in A.warp_pair(jnp.asarray(img), jnp.asarray(mask),
                                                      jnp.asarray(Hm), jnp.asarray(dy),
                                                      jnp.asarray(dx)))
        oi, om = T.warp_pair(t(img)[None], t(mask)[None], t(Hm)[None], t(dy)[None], t(dx)[None])
        np.testing.assert_allclose(oi[0].numpy(), ji, rtol=0, atol=1e-5)
        ties = int(np.sum(om[0].numpy() != jm))
        assert ties < 1e-3 * jm.size, f"{case}: {ties} of {jm.size} mask pixels differ"
        if case == "identity":
            np.testing.assert_array_equal(oi[0].numpy(), img)
            np.testing.assert_array_equal(om[0].numpy(), mask)


class TestPixelPieces:
    def test_hsv_round_trip_and_each_direction(self):
        """1e-6 absolute on [0, 1] values."""
        rng = np.random.default_rng(4)
        img = rng.random((16, 16, 3)).astype(np.float32)
        img[0, :4] = [0.5, 0.5, 0.5]  # grey: no hue
        img[1, :4] = [0.2, 0.7, 0.7]  # a tie of two channels at the max
        hsv = np.asarray(A._rgb_to_hsv(jnp.asarray(img)))
        ours_hsv = T._rgb_to_hsv(t(img)).numpy()
        np.testing.assert_allclose(ours_hsv, hsv, rtol=0, atol=1e-6)
        np.testing.assert_allclose(T._hsv_to_rgb(t(hsv)).numpy(),
                                   np.asarray(A._hsv_to_rgb(jnp.asarray(hsv))), rtol=0, atol=1e-6)
        np.testing.assert_allclose(T._hsv_to_rgb(T._rgb_to_hsv(t(img))).numpy(), img,
                                   rtol=0, atol=1e-6)
        # A negative hue shift wraps by floor-mod (torch.remainder, as jnp %).
        shifted = np.asarray(jnp.asarray(hsv[..., 0]) - 0.3) % 1.0
        np.testing.assert_allclose(torch.remainder(t(hsv[..., 0]) - 0.3, 1.0).numpy(),
                                   shifted, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("clip_limit", [0.0, 4.0])
    def test_lut_from_hist(self, clip_limit):
        """1e-6 absolute on the [0, 1] LUT."""
        rng = np.random.default_rng(5)
        hist = rng.integers(0, 400, 256).astype(np.float32)
        hist[:10] = 0
        hist[100] = 5000
        np.testing.assert_allclose(T._lut_from_hist(t(hist), clip_limit).numpy(),
                                   np.asarray(A._lut_from_hist(jnp.asarray(hist), clip_limit)),
                                   rtol=0, atol=1e-6)

    @pytest.mark.parametrize("clip_limit", [0.0, 4.0])
    def test_equalize_lut(self, clip_limit):
        """1e-6 absolute; the port counts with one index_add_."""
        rng = np.random.default_rng(6)
        channel = np.clip(rng.normal(90, 30, (32, 32)), 0, 255).astype(np.int32)
        np.testing.assert_allclose(
            T._equalize_lut(t(channel), clip_limit).numpy(),
            np.asarray(A._equalize_lut(jnp.asarray(channel), clip_limit)), rtol=0, atol=1e-6)

    def test_batched_histograms_equal_per_channel_bincount(self):
        rng = np.random.default_rng(7)
        u8 = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.int32)
        hist = T._histograms(t(u8)).numpy()
        for b in range(3):
            for c in range(3):
                np.testing.assert_array_equal(hist[b, c], np.bincount(u8[b, ..., c].ravel(),
                                                                      minlength=256))

    @pytest.mark.parametrize("sigma", [0.0, 0.5, 2.0])
    def test_gaussian_blur(self, sigma):
        """1e-6 absolute (9 taps of [0, 1] values, sigma clamped at 1e-3)."""
        img, _ = _pair(8, 24, 20)
        want = np.asarray(A._gaussian_blur(jnp.asarray(img), sigma))
        got = T._gaussian_blur(t(img)[None], torch.tensor([sigma]))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("key,direction", [(1, 0), (0, 1), (4, 2), (2, 3)])
    def test_motion_blur(self, key, direction):
        """JAX draws the direction from its key; the port takes it. 1e-6."""
        k = jax.random.key(key)
        assert int(jax.random.randint(k, (), 0, 4)) == direction
        img, _ = _pair(9, 20, 24)
        want = np.asarray(A._motion_blur(jnp.asarray(img), k))
        got = T._motion_blur(t(img)[None], torch.tensor([direction]))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The whole augmenter on JAX's draws
# ---------------------------------------------------------------------------


def test_key_branches_are_as_listed():
    policy = A.policy_arrays(ONES)
    for key, branches in KEY_BRANCHES.items():
        draws = jax_draws(jax.random.key(key), 0, policy, H, W)
        assert {g: int(draws[g]) for g in branches} == branches
    covered = {(g, v) for b in KEY_BRANCHES.values() for g, v in b.items()}
    assert len(covered) == 5 * 3


@pytest.mark.parametrize("policy_name", list(POLICIES))
@pytest.mark.parametrize("class_idx", [0, 1])
@pytest.mark.parametrize("key", list(KEY_BRANCHES))
def test_apply_params_equals_augment_one(policy_name, class_idx, key):
    """``apply_params`` on JAX's draws against jitted ``augment_one``: image
    rel-L2 ≤ 1e-5, masks equal on ≥ 99.9% of the pixels.

    The histogram stage truncates to uint8, and XLA on the CPU fuses
    multiply-adds that the port rounds twice: where a pixel sits within
    float32 rounding of a bin edge, the two truncate to neighbouring bins and
    the CLAHE or equalize LUT shifts (about 1e-4 rel-L2 for one such pixel
    at 64²). So each case is held in two halves that meet at JAX's own
    pre-histogram image (``augment_one`` with the later probabilities at 0:
    the same program and draws, so the same bits): the port's warp, dropout
    and colour stages against it, and the port's later stages on it against
    the full ``augment_one``. End to end the port is held to 1e-5 wherever
    no bin differs or the histogram stage takes no LUT; the bins that differ
    are counted in the message."""
    img, mask = _pair()
    policy = POLICIES[policy_name]
    pj = A.policy_arrays(policy)
    early = A.policy_arrays({k: ((0.0, 0.0) if k in LATE_GATES else v)
                             for k, v in policy.items()})
    k = jax.random.key(key)
    args = (jnp.asarray(img), jnp.asarray(mask), jnp.int32(class_idx))
    want, want_mask = (np.asarray(v) for v in augment_one(k, *args, pj))
    want_pre = np.asarray(augment_one(k, *args, early)[0])
    P = as_params([jax_draws(k, class_idx, pj, H, W)])

    pre, got_mask = T._warp_and_colour(P, t(img)[None], t(mask)[None])
    post = T._histogram_noise_light(P, t(want_pre)[None])
    full, full_mask = T.apply_params(P, t(img)[None], t(mask)[None])
    pre, post, full = pre[0].numpy(), post[0].numpy(), full[0].numpy()

    def u8(x):
        return np.clip(x * 255.0, 0, 255).astype(np.int32)

    bins = int(np.sum(u8(pre) != u8(want_pre)))
    lut = bool(P["hist"][0]) and int(P["hist_pick"][0]) in (0, 1)
    msg = (f"key {key} class {class_idx} {policy_name}: {bins} pre-histogram values in "
           f"another uint8 bin, histogram LUT {'taken' if lut else 'not taken'}")
    assert rel_l2(pre, want_pre) <= IMAGE_REL_L2, msg
    assert rel_l2(post, want) <= IMAGE_REL_L2, msg
    agreement = float(np.mean(got_mask[0].numpy() == want_mask))
    assert agreement >= MASK_AGREEMENT, f"{msg}; mask agreement {agreement}"
    np.testing.assert_array_equal(full_mask.numpy(), got_mask.numpy())
    if bins == 0 or not lut:
        assert rel_l2(full, want) <= IMAGE_REL_L2, f"{msg}; end to end {rel_l2(full, want)}"


# ---------------------------------------------------------------------------
# The port's own sampler
# ---------------------------------------------------------------------------


def _batch(n, seed=0, h=H, w=W):
    img, mask = _pair(seed, h, w)
    return t(np.stack([img] * n)), t(np.stack([mask] * n))


class TestSampler:
    def test_shapes_and_ranges(self):
        images, masks = _batch(4)
        out_i, out_m = T.augment_batch(torch.Generator().manual_seed(0), images, masks,
                                       torch.tensor([0, 1, 0, 1]))
        assert out_i.shape == images.shape and out_i.dtype == torch.float32
        assert out_m.shape == masks.shape and out_m.dtype == masks.dtype
        assert torch.isfinite(out_i).all() and out_i.min() >= 0 and out_i.max() <= 1
        P = T.sample_params(torch.Generator().manual_seed(0), torch.tensor([0, 1]), None, H, W)
        assert P["gauss"].shape == (2, H, W, 3) and P["sp_u"].shape == (2, H, W)
        assert P["elastic"].shape == (2, 2, 16, 16) and P["grid"].shape == (2, 2, 5, 5)
        assert set(P) == set(jax_draws(jax.random.key(0), 0, A.policy_arrays(), 8, 8))

    def test_zero_policy_is_identity_after_default(self):
        """With every probability 0 the output is the input (1e-5; mask
        exact), also after the default table has been used."""
        images, masks = _batch(3)
        gen = torch.Generator().manual_seed(1)
        default_i, _ = T.augment_batch(gen, images, masks, torch.tensor([0, 1, 0]))
        assert not torch.allclose(default_i, images, atol=1e-3)
        out_i, out_m = T.augment_batch(gen, images, masks, torch.tensor([0, 1, 0]),
                                       policy=ZEROS)
        np.testing.assert_allclose(out_i.numpy(), images.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(out_m.numpy(), masks.numpy())

    def test_mask_values_stay_in_the_label_set(self):
        images, masks = _batch(8, seed=1)
        masks[:, 50:60, 4:30] = 2
        for seed in range(3):
            _, out_m = T.augment_batch(torch.Generator().manual_seed(seed), images, masks,
                                       torch.zeros(8, dtype=torch.int64), policy=ONES)
            assert set(out_m.unique().tolist()) <= {0, 1, 2, 255}

    def test_same_generator_seed_repeats_and_another_differs(self):
        images, masks = _batch(2, seed=2)
        uint8 = (images * 255).to(torch.uint8)

        def run(seed, epoch, i):
            return T.augment_and_normalize(common.augment_generator(seed, epoch, i, "cpu"),
                                           uint8, masks)

        a_i, a_m = run(0, 1, 2)
        b_i, b_m = run(0, 1, 2)
        assert torch.equal(a_i, b_i) and torch.equal(a_m, b_m)
        for other in ((0, 1, 3), (0, 2, 2), (1, 1, 2)):
            assert not torch.equal(run(*other)[0], a_i)

    def test_flip_rate_near_hflip_prob(self):
        """hflip is 0.5 for both classes: the drawn flags over 256 images, and
        the realized flips on an asymmetric image (as tests/test_augment.py)."""
        h = w = 32
        img = np.zeros((h, w, 3), np.float32)
        img[:, : w // 2] = 1.0
        mask = np.zeros((h, w), np.int32)
        mask[:, : w // 2] = 1
        n = 64
        gen = torch.Generator().manual_seed(123)
        flags = T.sample_params(gen, torch.zeros(256, dtype=torch.int64), None, h, w)["flip"]
        assert abs(flags.float().mean().item() - 0.5) < 0.1
        _, out_m = T.augment_batch(gen, t(np.stack([img] * n)), t(np.stack([mask] * n)),
                                   torch.zeros(n, dtype=torch.int64))
        left = (out_m[:, :, : w // 2] == 1).sum(dim=(1, 2))
        right = (out_m[:, :, w // 2:] == 1).sum(dim=(1, 2))
        assert 0.25 < (right > left).float().mean().item() < 0.75

    def test_cats_change_more_than_dogs(self):
        rng = np.random.default_rng(11)
        img = rng.random((32, 32, 3)).astype(np.float32)
        n = 128
        images = t(np.stack([img] * n))
        masks = torch.zeros(n, 32, 32, dtype=torch.int32)

        def change_rate(cls):
            out, _ = T.augment_batch(torch.Generator().manual_seed(5), images, masks,
                                     torch.full((n,), cls))
            return float(((out - images).abs().mean(dim=(1, 2, 3)) > 0.02).float().mean())

        cat, dog = change_rate(0), change_rate(1)
        assert cat > dog, (cat, dog)

    def test_mask_classes(self):
        masks = torch.zeros(3, 4, 4, dtype=torch.uint8)
        masks[0, 1, 1] = 1
        masks[1, 1, 1] = 2
        masks[2, 0, 0] = 255
        assert T.mask_classes(masks).tolist() == [0, 1, 1]


# ---------------------------------------------------------------------------
# Policy files, routing
# ---------------------------------------------------------------------------

GOOD_YAML = """
cat:
  horizontal_flip_prob: 0.9
  rotate_limit: 20
  random_resized_crop:
    scale: [0.7, 1.0]
    prob: 0.5
dog:
  horizontal_flip_prob: 0.1
"""
BAD_YAML = """
cat:
  horizontal_flip_prob: high
  random_resized_crop:
    scale: 0.7
  gauss_noise:
    var_limit: [10.0]
dog:
  coarse_dropout: 5
  perspective:
    scale: [0.05, 0.08]
"""


@pytest.mark.parametrize("text", [GOOD_YAML, BAD_YAML, ""], ids=["good", "malformed", "empty"])
def test_load_policy_yaml_equals_jax(tmp_path, text):
    path = tmp_path / "aug.yaml"
    path.write_text(text)
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = T.load_policy_yaml(path)
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref = A.load_policy_yaml(path)
    assert ours == ref
    assert [str(w.message) for w in ours_w] == [str(w.message) for w in ref_w]
    if text is GOOD_YAML:
        assert ours["hflip_prob"] == (0.9, 0.1) and ours["rrc_scale_min"][0] == 0.7
    if text is BAD_YAML:
        assert len(ours_w) == 4 and ours["perspective_scale"] == (0.1, 0.08)
    assert T._YAML_KEYMAP == A._YAML_KEYMAP and T.POLICY == A.POLICY


def test_class_index_for_and_is_cat_image_equal_jax():
    names = ["Abyssinian_12", "BENGAL_3", "beagle_3", "yorkshire_terrier_1", "maine_coon_7",
             "Sphynx_1", "pug_9", "persian", "x"]
    for name in names:
        assert pipeline.is_cat_image(name) == jax_pipeline.is_cat_image(name)
    assert pipeline.CAT_BREEDS == jax_pipeline.CAT_BREEDS
    masks = {"cat": np.array([[0, 1], [2, 255]]), "dog": np.array([[0, 2], [255, 0]]),
             "none": np.array([[0, 255], [0, 0]])}
    for mask in masks.values():
        for name in names:
            assert T.class_index_for(mask, name) == A.class_index_for(mask, name)
    assert T.class_index_for(masks["none"], "Abyssinian_12") == 0
    assert T.class_index_for(masks["none"], "beagle_3") == 1


# ---------------------------------------------------------------------------
# The online wrappers
# ---------------------------------------------------------------------------


class RecordingExtractor:
    """A stand-in tower: per-image channel means; records its inputs."""

    output_dim = 8

    def __init__(self):
        self.seen = []

    def __call__(self, clip_images):
        self.seen.append(clip_images.clone())
        return clip_images.mean(dim=(1, 2)).repeat(1, 3)[:, :self.output_dim]


def _host_batches(n=2, b=2):
    rng = np.random.default_rng(12)
    out = []
    for i in range(n):
        masks = np.zeros((b, H, W), np.int32)
        masks[:, 10:40, 10:40] = 1 + i % 2
        out.append({"image": rng.integers(0, 256, (b, H, W, 3)).astype(np.uint8),
                    "mask": masks, "clip_image": np.zeros((b, 224, 224, 3), np.uint8),
                    "index": np.arange(i * b, (i + 1) * b)})
    return out


class TestWrappers:
    def test_plain_and_clip_wrappers_augment_alike(self):
        ex = RecordingExtractor()
        plain = list(common.wrap_online_augment(_host_batches(), 0, 3, "cpu"))
        clip = list(common.wrap_online_augment_clip(_host_batches(), 0, 3, "cpu", ex))
        assert len(plain) == len(clip) == 2
        for p, c, host in zip(plain, clip, _host_batches()):
            assert torch.equal(p["image"], c["image"]) and torch.equal(p["mask"], c["mask"])
            assert p["image"].dtype == torch.float32 and p["mask"].dtype == torch.int32
            assert "clip_image" not in c and "clip_image" in p
            assert c["clip_features"].shape == (2, ex.output_dim)
            np.testing.assert_array_equal(c["index"], host["index"])
            # ImageNet-normalized pixels, roughly centred; labels stay labels.
            assert p["image"].min() < -0.5 and p["image"].max() > 0.5
            assert set(p["mask"].unique().tolist()) <= {0, 1, 2, 255}

    def test_features_come_from_the_augmented_pixels(self):
        """The extractor sees the augmented 224² view, which changes with the
        epoch, so the features do too."""
        ex = RecordingExtractor()
        e0 = list(common.wrap_online_augment_clip(_host_batches(1), 0, 0, "cpu", ex))
        e1 = list(common.wrap_online_augment_clip(_host_batches(1), 1, 0, "cpu", ex))
        assert ex.seen[0].shape == (2, 224, 224, 3)
        assert not torch.equal(ex.seen[0], ex.seen[1])
        assert not torch.allclose(e0[0]["clip_features"], e1[0]["clip_features"])

    def test_clip_view_equals_jax_resize_of_the_augmented_pixels(self):
        """Given the port's augmented [0, 1] pixels, its normalized 224² view
        equals JAX's ``resize_bilinear`` of them, normalized: 1e-6."""
        host = _host_batches(1)[0]
        images, masks = t(host["image"]), t(host["mask"])
        gen = common.augment_generator(0, 0, 0, "cpu")
        _, _, view = T.augment_and_normalize_with_clip(gen, images, masks)
        pixels, _ = T.augment_batch(common.augment_generator(0, 0, 0, "cpu"),
                                    images.float() / 255.0, masks, T.mask_classes(masks))
        want = np.asarray(jax_resize_bilinear(jnp.asarray(pixels.numpy()), (224, 224),
                                              spatial_axes=(1, 2)))
        want = (want - IMAGENET_MEAN) / IMAGENET_STD
        np.testing.assert_allclose(view.numpy(), want, rtol=0, atol=1e-6)

    def test_live_features_train(self):
        """The real tower's features leave inference mode: a training
        forward can save them for its backward."""
        ex = ClipFeatureExtractor("ViT-B/32", dtype=torch.float32, device="cpu")
        batch = next(common.wrap_online_augment_clip(_host_batches(1), 0, 0, "cpu", ex))
        assert not batch["clip_features"].is_inference()
        head = torch.nn.Linear(ex.output_dim, 1)
        head(batch["clip_features"]).sum().backward()
        assert head.weight.grad is not None


# ---------------------------------------------------------------------------
# Offline expansion
# ---------------------------------------------------------------------------


def write_train(root):
    """Train/resized + resized_label: two cats (one by its mask, one by its
    breed name) and two dogs (likewise), 64²."""
    rng = np.random.default_rng(13)
    images, masks = root / "Train" / "resized", root / "Train" / "resized_label"
    images.mkdir(parents=True)
    masks.mkdir(parents=True)
    for name, value in (("Abyssinian_1", 1), ("Bengal_2", 0), ("beagle_3", 2),
                        ("pug_4", 0)):
        cv2.imwrite(str(images / f"{name}.jpg"), rng.integers(0, 256, (H, W, 3), np.uint8))
        mask = np.zeros((H, W), np.uint8)
        mask[16:48, 16:48] = value
        mask[8:10, :] = 255
        cv2.imwrite(str(masks / f"{name}.png"), mask)


def _listing(root):
    aug = root / "Train" / "augmented"
    return {d: sorted(p.name for p in (aug / d).iterdir()) for d in ("images", "masks")}


def test_offline_expansion_equals_jax(tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    write_train(ours)
    shutil.copytree(ours, ref)
    stats = T.augment_dataset_offline(ours, cat_augmentations=2, dog_augmentations=1,
                                      device="cpu", verbose=False)
    ref_stats = A.augment_dataset_offline(ref, cat_augmentations=2, dog_augmentations=1,
                                          verbose=False)
    assert stats == ref_stats == {"cat": 2, "dog": 2, "errors": 0, "outputs": 6}
    assert _listing(ours) == _listing(ref)
    assert _listing(ours)["images"] == [f"{n}_aug{i}.jpg" for n, k in (
        ("Abyssinian_1", 2), ("Bengal_2", 2), ("beagle_3", 1), ("pug_4", 1)) for i in range(k)]
    report = (ours / "Train" / "augmented" / "augmentation_report.txt").read_text()
    ref_report = (ref / "Train" / "augmented" / "augmentation_report.txt").read_text()
    # The first line names the engine; every count line is JAX's.
    assert report.splitlines()[0] == "Augmentation report (on-device PyTorch pipeline)"
    assert report.splitlines()[1:] == ref_report.splitlines()[1:]
    for p in sorted((ours / "Train" / "augmented" / "masks").iterdir()):
        m = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        assert m.shape == (H, W) and set(np.unique(m)) <= {0, 1, 2, 255}


def test_cli_augment(tmp_path, capsys):
    write_train(tmp_path)
    config = tmp_path / "aug.yaml"
    config.write_text(GOOD_YAML)
    stats = cli.main(["augment", "--data_dir", str(tmp_path), "--cat_augmentations", "1",
                      "--dog_augmentations", "1", "--seed", "3", "--config", str(config),
                      "--device", "cpu"])
    assert stats == {"cat": 2, "dog": 2, "errors": 0, "outputs": 4}
    assert "outputs written: 4" in capsys.readouterr().out
    assert len(_listing(tmp_path)["masks"]) == 4
    args = cli.build_parser().parse_args(["augment", "--data_dir", "d"])
    assert (args.cat_augmentations, args.dog_augmentations, args.seed, args.config,
            args.device) == (5, 2, 42, None, None)
