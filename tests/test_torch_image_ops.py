"""``rvc_tpu_torch.ops.image`` against OpenCV: resizing (nearest, linear,
Lanczos-4) and the Gaussian blur at sigma 0, on random uint8 and float32
images at the lip-sync pipeline's sizes and kernel-size formulas, scaling
up and down. The port never imports cv2; these tests hold its counterpart
to cv2 where cv2 is installed."""
import numpy as np
import pytest
import torch

from _torch_port import one_thread  # noqa: F401
from rvc_tpu_torch.ops import image

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_thread")

# (source (h, w), target (w, h)): the pipeline's crops to 256 (VAE) and 512
# (parser) and back, FAN's 256, exact halving (OpenCV's area route), odd sides
SIZES = [((37, 53), (256, 256)), ((300, 260), (256, 256)), ((512, 512), (256, 256)),
         ((100, 90), (512, 512)), ((700, 640), (512, 512)), ((512, 512), (141, 163)),
         ((64, 64), (37, 41)), ((256, 256), (203, 187)), ((20, 30), (61, 47)),
         ((130, 128), (65, 64)), ((1, 37), (256, 1))]
INTERP = {"nearest": image.INTER_NEAREST, "linear": image.INTER_LINEAR,
          "lanczos4": image.INTER_LANCZOS4}
SEED = {"nearest": 1, "linear": 2, "lanczos4": 3}


def images(rng, shape, dtype):
    if dtype == np.uint8:
        return (rng.random(shape) * 256).astype(np.uint8)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(INTERP))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_resize_against_cv2(name, dtype):
    """uint8: nearest and linear bit-equal, Lanczos-4 within 1 LSB (the share
    off printed). float32: nearest bit-equal; linear and Lanczos-4 within
    1e-6 (OpenCV 5's float linear route for images of more than one row
    rounds its weights from a double position: 2 ulp at most)."""
    rng = np.random.default_rng(SEED[name])
    off, worst = [], 0.0
    for (h, w), size in SIZES:
        for shape in ((h, w), (h, w, 3)):
            img = images(rng, shape, dtype)
            want = cv2.resize(img, size, interpolation=INTERP[name])
            got = image.resize(img, size, INTERP[name])
            assert got.shape == want.shape and got.dtype == want.dtype
            d = np.abs(got.astype(np.float64) - want.astype(np.float64))
            worst = max(worst, float(d.max()))
            off.append(float(np.mean(d > 0)))
    print(f"{name} {np.dtype(dtype).name}: max |diff| {worst:g}, share off {max(off):.4%}")
    if dtype == np.uint8:
        assert worst <= (1 if name == "lanczos4" else 0)
    else:
        assert worst <= (0 if name == "nearest" else 1e-6)


def test_resize_keeps_tensors_on_their_device_and_shape():
    img = torch.from_numpy(images(np.random.default_rng(1), (40, 30, 3), np.uint8))
    out = image.resize(img, (20, 25))
    assert isinstance(out, torch.Tensor) and out.shape == (25, 20, 3) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), cv2.resize(img.numpy(), (20, 25)))
    same = image.resize(img.numpy(), (30, 40))
    np.testing.assert_array_equal(same, img.numpy())


# the pipeline's blur sizes: max((x2 - x1) // 10 * 2 + 1, 3) for a face box and
# int(0.1 * cw // 2 * 2) + 1 for the parsed crop, at box widths 16-300
KSIZES = sorted({max(w // 10 * 2 + 1, 3) for w in (16, 40, 64, 128, 256, 300)}
                | {int(0.1 * int(w * 1.2) // 2 * 2) + 1 for w in (16, 64, 128, 300)})


@pytest.mark.parametrize("k", KSIZES)
def test_gaussian_blur_against_cv2(k):
    """uint8 bit-equal (OpenCV's fixed-point route, BORDER_REFLECT_101), also
    on masks of 0 and 255 as the paste-back blurs them and on images
    narrower than the kernel; float32 within 1e-6."""
    rng = np.random.default_rng(k)
    for shape in ((64, 80), (307, 261), (20, 30), (40, 50, 3)):
        img = images(rng, shape, np.uint8)
        mask = np.where(rng.random(shape) < 0.5, 255, 0).astype(np.uint8)
        for x in (img, mask):
            np.testing.assert_array_equal(image.gaussian_blur(x, (k, k)),
                                          cv2.GaussianBlur(x, (k, k), 0))
        f = images(rng, shape, np.float32)
        err = np.abs(image.gaussian_blur(f, (k, k)) - cv2.GaussianBlur(f, (k, k), 0)).max()
        assert err <= 1e-6, err
    ones = np.ones((50, 60), np.float32)
    assert np.abs(image.gaussian_blur(ones, (k, k)) - cv2.GaussianBlur(ones, (k, k), 0)).max() <= 1e-6


def test_fixed_point_kernels_sum_to_one():
    for k in (3, 5, 7, 9, 11, 25, 51, 61, 101):
        fk = image.fixed_gaussian_kernel(k)
        assert fk.sum() == 256 and np.array_equal(fk, fk[::-1]) and fk.min() >= 0
    assert list(image.reflect101(np.arange(-3, 8), 5)) == [3, 2, 1, 0, 1, 2, 3, 4, 3, 2, 1]
