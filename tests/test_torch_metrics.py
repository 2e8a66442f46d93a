"""The port's image metrics against the JAX package's (fp32 both sides; the
SSIM convolutions sum in different orders: rtol 1e-5)."""

import numpy as np
import pytest

from reflecting_reality_tpu.metrics import functional as jf
from reflecting_reality_tpu_torch.metrics import functional as tf


@pytest.mark.parametrize("shape,scale", [((32, 40, 3), 255.0), ((2, 24, 24, 3), 1.0),
                                         ((16, 16, 1), 4.0)])
def test_psnr_ssim_match_jax(shape, scale):
    r = np.random.RandomState(len(shape))
    target = (r.rand(*shape) * scale).astype(np.float32)
    pred = np.clip(target + r.randn(*shape).astype(np.float32) * 0.1 * scale, 0, scale)
    np.testing.assert_allclose(float(tf.psnr(pred, target)), float(jf.psnr(pred, target)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tf.ssim(pred, target)), float(jf.ssim(pred, target)),
                               rtol=1e-5)
    np.testing.assert_allclose(tf.psnr_ssim(pred, target, device="cpu"),
                               jf.psnr_ssim(pred, target), rtol=1e-5)
    np.testing.assert_allclose(float(tf.psnr(pred, target, data_range=255.0)),
                               float(jf.psnr(pred, target, data_range=255.0)), rtol=1e-5)


def test_iou_matches_jax():
    r = np.random.RandomState(0)
    a, b = r.rand(16, 16) > 0.5, r.rand(16, 16) > 0.3
    assert tf.iou(a, b) == jf.iou(a, b)
    assert np.isnan(tf.iou(np.zeros(4), np.zeros(4)))
