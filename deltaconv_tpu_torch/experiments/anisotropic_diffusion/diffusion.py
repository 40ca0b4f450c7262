"""Perona-Malik anisotropic diffusion and image filter primitives
(counterpart of ``experiments/anisotropic_diffusion/diffusion.py``).

The kornia filters of the reference study: ``spatial_gradient``
(normalized Sobel), ``laplacian`` (3x3, L1-normalized), and the explicit
Perona-Malik diffusion step (their eq. 3, both conductances). Images are
``[B, H, W, C]``, as in the JAX study; the filters are depthwise 3x3
cross-correlations with zero padding, as JAX's ``conv_general_dilated``
with ``padding="SAME"``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["anisotropic_diffusion", "anisotropic_diffusion_nsteps",
           "laplacian", "make_test_image", "spatial_gradient"]

# kornia's normalized Sobel kernels.
_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
_SOBEL_Y = _SOBEL_X.T
# kornia.filters.laplacian defaults to normalized=True: the kernel is
# divided by its L1 norm (16 for the 3x3 case).
_LAPLACIAN = np.array([[1, 1, 1], [1, -8, 1], [1, 1, 1]], np.float32) / 16.0


def _conv2d_same(x, kernel):
    """Depthwise 3x3 cross-correlation of ``[B, H, W, C]`` with zero
    padding."""
    c = x.shape[-1]
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    k = k[None, None].expand(c, 1, 3, 3)
    out = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, padding=1,
                                     groups=c)
    return out.permute(0, 2, 3, 1)


def spatial_gradient(x):
    """Normalized-Sobel gradients: ``[B, H, W, C] -> (gx, gy)``."""
    return _conv2d_same(x, _SOBEL_X), _conv2d_same(x, _SOBEL_Y)


def laplacian(x):
    """3x3 Laplacian: ``[B, H, W, C] -> [B, H, W, C]``."""
    return _conv2d_same(x, _LAPLACIAN)


def anisotropic_diffusion(image, kappa: float = 0.05, c_func: str = "exp"):
    """One explicit Perona-Malik step: scale the gradient by the
    conductance of its norm, then take the divergence."""
    gx, gy = spatial_gradient(image)
    norm = torch.sqrt(gx ** 2 + gy ** 2)
    if c_func == "exp":
        c = torch.exp(-((norm / kappa) ** 2))
    else:
        c = 1.0 / (1.0 + norm / kappa) ** 2
    gx, gy = c * gx, c * gy
    div = spatial_gradient(gx)[0] + spatial_gradient(gy)[1]
    return image + div


def anisotropic_diffusion_nsteps(image, n: int, kappa: float = 0.05,
                                 c_func: str = "exp"):
    """``n`` Perona-Malik steps."""
    for _ in range(n):
        image = anisotropic_diffusion(image, kappa, c_func)
    return image


def make_test_image(size: int = 128, seed: int = 0) -> np.ndarray:
    """A synthetic grayscale test image with edges, gradients and
    texture: ``[1, size, size, 1]`` float32 in [0, 1] (the JAX study's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = 0.35 + 0.3 * np.sin(6.28 * 3 * xx) * (yy < 0.5)
    img += 0.4 * ((xx - 0.3) ** 2 + (yy - 0.7) ** 2 < 0.04)
    img += 0.25 * (xx + yy > 1.3)
    img += 0.1 * rng.standard_normal((size, size)) * (xx > 0.6) * (yy < 0.4)
    img = np.clip(img, 0, 1).astype(np.float32)
    return img[None, :, :, None]
