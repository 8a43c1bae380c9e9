"""Dense image ops (port of ``ops/image.py``): separable Gaussian blur,
image pyramids, gradients, box filter, bilinear sampling.

The flat (full, /mid, /coarse) box pyramid feeds the Pallas-style KLT
chain; the Gaussian pyramid and central gradients feed the gather tracker
(``ops/klt.py``).  Filter taps and window grids live on the image's device,
made there once (``core.linalg.constant`` / ``kept``), so a captured graph
(``pipeline/vo.py``) copies nothing from the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.linalg import constant, kept


def gaussian_kernel_1d(sigma: float,
                       radius: int | None = None) -> torch.Tensor:
    """Normalized 1-D Gaussian taps (static length)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device="cpu")
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _conv_sep(img: torch.Tensor, kx: torch.Tensor,
              ky: torch.Tensor) -> torch.Tensor:
    """Separable 2-D correlation with SAME (edge-replicate) padding: a
    column pass with ``ky``, then a row pass with ``kx``."""
    rx = kx.shape[0] // 2
    ry = ky.shape[0] // 2
    kx = kx.to(img.device, img.dtype)
    ky = ky.to(img.device, img.dtype)
    x = F.pad(img[None, None], (rx, rx, ry, ry), mode="replicate")
    x = F.conv2d(x, ky.reshape(1, 1, -1, 1))
    x = F.conv2d(x, kx.reshape(1, 1, 1, -1))
    return x[0, 0]


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: int | None = None) -> torch.Tensor:
    k = kept(("gaussian", sigma, radius), img.device,
             lambda: gaussian_kernel_1d(sigma, radius))
    return _conv_sep(img, k, k)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Half-resolution downsample with the cv2.pyrDown 5-tap binomial
    filter."""
    # Kept on the image's device: the step that builds the pyramid is
    # captured (pipeline/vo.py).
    k = constant([1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16], img.device)
    return _conv_sep(img, k, k)[::2, ::2]


def build_pyramid(img: torch.Tensor, num_levels: int):
    """Gaussian pyramid: level 0 = input, level l = pyr_down^l."""
    levels = [img.to(torch.float32)]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]).contiguous())
    return tuple(levels)


def scharr_gradients(img: torch.Tensor):
    """Scharr 3x3 gradients (what cv2.calcOpticalFlowPyrLK uses internally,
    scaled by 1/32)."""
    smooth = constant([3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0], img.device)
    diff = constant([-1.0, 0.0, 1.0], img.device)
    return _conv_sep(img, diff, smooth), _conv_sep(img, smooth, diff)


def central_gradients(img: torch.Tensor):
    """Central-difference gradients (the gather tracker's)."""
    gx = 0.5 * (_shift(img, 0, 1) - _shift(img, 0, -1))
    gy = 0.5 * (_shift(img, 1, 0) - _shift(img, -1, 0))
    return gx, gy


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of an (H, W) image at (..., 2) [x, y] pixel
    coordinates, clamped to the border."""
    H, W = img.shape
    x = uv[..., 0].clamp(0.0, W - 1.000001)
    y = uv[..., 1].clamp(0.0, H - 1.000001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # A NaN coordinate reads pixel 0 (the reference's NaN -> int is 0) and
    # comes back NaN through its weights.
    x0i = torch.nan_to_num(x0).to(torch.int64)
    y0i = torch.nan_to_num(y0).to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    return (img[y0i, x0i] * (1 - fx) * (1 - fy)
            + img[y0i, x1i] * fx * (1 - fy)
            + img[y1i, x0i] * (1 - fx) * fy
            + img[y1i, x1i] * fx * fy)


def window_coords(window: int, device=None) -> torch.Tensor:
    """(window*window, 2) relative (dx, dy) offsets centered on 0, on
    ``device`` (made there once)."""
    if device is not None:
        return kept(("window", window), device, lambda: window_coords(window))
    r = (window - 1) / 2.0
    ax = torch.arange(window, dtype=torch.float32, device="cpu") - r
    dy, dx = torch.meshgrid(ax, ax, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicated shift: out[y, x] = img[y+dy, x+dx] (clamped)."""
    if dy > 0:
        img = torch.cat([img[dy:], img[-1:].expand(dy, -1)], 0)
    elif dy < 0:
        img = torch.cat([img[:1].expand(-dy, -1), img[:dy]], 0)
    if dx > 0:
        img = torch.cat([img[:, dx:], img[:, -1:].expand(-1, dx)], 1)
    elif dx < 0:
        img = torch.cat([img[:, :1].expand(-1, -dx), img[:, :dx]], 1)
    return img


def sobel_gradients(img: torch.Tensor):
    """Sobel x/y gradients with OpenCV's 3x3 kernels, as shift-adds."""
    up, down = _shift(img, -1, 0), _shift(img, 1, 0)
    sy = up + 2.0 * img + down
    gx = _shift(sy, 0, 1) - _shift(sy, 0, -1)
    left, right = _shift(img, 0, -1), _shift(img, 0, 1)
    sx = left + 2.0 * img + right
    gy = _shift(sx, 1, 0) - _shift(sx, -1, 0)
    return gx, gy


def box_filter(img: torch.Tensor, size: int,
               normalize: bool = False) -> torch.Tensor:
    """size x size box sum (or mean) with edge-replicate SAME padding.

    Shift-adds for sizes up to 7 (the reference's own summation order), a
    separable convolution above."""
    if size <= 7:
        r = size // 2
        acc_y = img
        for d in range(1, r + 1):
            acc_y = acc_y + _shift(img, d, 0) + _shift(img, -d, 0)
        acc = acc_y
        for d in range(1, r + 1):
            acc = acc + _shift(acc_y, 0, d) + _shift(acc_y, 0, -d)
        if normalize:
            acc = acc / (size * size)
        return acc
    r = size // 2
    k = torch.ones(size, dtype=img.dtype, device=img.device)
    if normalize:
        k = k / size
    x = F.pad(img[None, None], (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x[0, 0]


def _box_down(x: torch.Tensor, f: int) -> torch.Tensor:
    """Mean over f x f blocks, cropping to a multiple of f."""
    h = x.shape[0] - x.shape[0] % f
    w = x.shape[1] - x.shape[1] % f
    return x[:h, :w].reshape(h // f, f, w // f, f).mean(dim=(1, 3))


def build_flat_pyramid(img: torch.Tensor, factor: int = 16,
                       mid_factor: int = 4):
    """(full res, 1/mid_factor, 1/factor) box-averaged planes."""
    img = img.to(torch.float32)
    mid = _box_down(img, mid_factor)
    coarse = (_box_down(mid, factor // mid_factor)
              if factor % mid_factor == 0 else _box_down(img, factor))
    return (img, mid, coarse)
