"""The port's losses (SSIM, the L1 + SSIM training loss, PSNR) against the
JAX package's, values and gradients, on seeded float32 images.

Both sides filter with the same 11 float32 taps in the same order, so the
values agree to float32 rounding of the final means (measured below 1e-6
relative).  Gradients are compared relative to their largest magnitude.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussian_splatting_tpu import losses as jl
from gaussian_splatting_torch import losses as tl

# values: float32 sums over ~1e4 terms in other orders
VALUE_RTOL = 1e-5
# gradients: per pixel the same float32 expressions; differences come from
# the order XLA and PyTorch sum the transposed filters' taps (measured
# below 1e-6 of the largest entry)
GRAD_REL_TOL = 1e-5
SSIM_FRAC = 0.2


def _images(seed, h=37, w=45):
    """A target in [0, 1] and a render around it that leaves [0, 1] in
    places and equals the target exactly on a block of pixels (where the
    L1 term's derivative convention matters)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img = (gt + rng.normal(0, 0.2, gt.shape)).astype(np.float32)
    img[:5, :7] = gt[:5, :7]
    return img, gt


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_value_and_grad(seed):
    img, gt = _images(seed)
    jv, jg = jax.value_and_grad(jl.ssim)(jnp.asarray(img), jnp.asarray(gt))
    t = torch.tensor(img, requires_grad=True)
    tv = tl.ssim(t, torch.tensor(gt))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=VALUE_RTOL)
    assert _rel(t.grad.numpy(), jg) < GRAD_REL_TOL


def test_ssim_reflect_padding_at_borders():
    """An image that differs from the target only in its first row and
    column: only the reflect padding reaches those pixels from outside."""
    img, gt = _images(2, h=24, w=20)
    img[1:, 1:] = gt[1:, 1:]
    jv = float(jl.ssim(jnp.asarray(img), jnp.asarray(gt)))
    tv = float(tl.ssim(torch.tensor(img), torch.tensor(gt)))
    assert jv < 1.0
    np.testing.assert_allclose(tv, jv, rtol=VALUE_RTOL)


def test_train_loss_value_and_grad():
    img, gt = _images(3)

    def jloss(x):
        return jl.train_loss(x, jnp.asarray(gt), SSIM_FRAC)

    (jv, jpsnr), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(img))
    t = torch.tensor(img, requires_grad=True)
    tv, tpsnr = tl.train_loss(t, torch.tensor(gt), SSIM_FRAC)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=VALUE_RTOL)
    np.testing.assert_allclose(float(tpsnr.detach()), float(jpsnr), rtol=VALUE_RTOL)
    assert _rel(t.grad.numpy(), jg) < GRAD_REL_TOL
    # where render and target are equal, |x|' is +1 in both packages
    l1_part = (1.0 - SSIM_FRAC) / img.size
    same = np.asarray(jg)[:5, :7]
    np.testing.assert_allclose(t.grad.numpy()[:5, :7], same, rtol=0, atol=1e-3 * l1_part)


def test_eval_psnr_ssim_clips_the_render():
    img, gt = _images(4)
    jp, js = jl.eval_psnr_ssim(jnp.asarray(img), jnp.asarray(gt))
    tp, ts = tl.eval_psnr_ssim(torch.tensor(img), torch.tensor(gt))
    np.testing.assert_allclose([float(tp), float(ts)], [float(jp), float(js)],
                               rtol=VALUE_RTOL)
    # the clip matters on these inputs
    unclipped = float(tl.train_loss(torch.tensor(img), torch.tensor(gt), 0.0)[1])
    assert abs(unclipped - float(tp)) > 0.1


def test_ssim_uses_no_convolution(monkeypatch):
    """The filter is shifted float32 adds: no conv2d (which would run in
    TF32 on the card) is called."""
    def refuse(*a, **k):
        raise AssertionError("conv2d called")

    monkeypatch.setattr(torch.nn.functional, "conv2d", refuse)
    monkeypatch.setattr(torch, "conv2d", refuse)
    img, gt = _images(5, h=16, w=16)
    assert float(tl.ssim(torch.tensor(img), torch.tensor(gt))) < 1.0
