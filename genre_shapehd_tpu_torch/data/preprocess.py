"""Host-side image reading, writing and preprocessing without cv2
(counterpart of ``genre_shapehd_tpu/data/preprocess.py``): the test-time
crop and resize, and the train-time photometric augmentation, whose
randomness comes from an explicit ``numpy.random.Generator``.

Resizing runs ``torch.nn.functional.interpolate`` in float64 on the CPU
with ``align_corners=False`` and no antialiasing: bicubic (A = -0.75) for
:func:`resize`, bilinear for :func:`crop` -- the kernels, border handling
and output-size rounding of ``cv2.resize`` with ``INTER_CUBIC`` /
``INTER_LINEAR``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .png import read_png, write_png

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# AlexNet PCA lighting
_LIGHT_EIGVALS = np.array([0.2175, 0.0188, 0.0045])
_LIGHT_EIGVECS = np.array([
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
])


def imread_rgb(path: str) -> np.ndarray:
    """RGB in [0, 1] (float64), divided by the dtype's maximum (255 or
    65535); an alpha channel is dropped, a grayscale file stays (H, W)."""
    im = read_png(path)
    if im.ndim == 3:
        im = im[..., :3]
    return im.astype(np.float64) / np.iinfo(im.dtype).max


def imread_gray(path: str) -> np.ndarray:
    """Grayscale in [0, 1] (float64, divided by the dtype's maximum);
    colour files are converted with the ITU-R 601 weights 0.299, 0.587,
    0.114."""
    im = read_png(path)
    maxv = np.iinfo(im.dtype).max
    if im.ndim == 3:
        rgb = im[..., :3].astype(np.float64)
        im = np.round(rgb @ np.array([0.299, 0.587, 0.114]))
    return im.astype(np.float64) / maxv


def imwrite_rgb(path: str, im01: np.ndarray) -> None:
    """Write an image in [0, 1], (H, W) or (H, W, 3), as an 8-bit PNG
    (values truncated, as ``astype(uint8)`` does)."""
    im = np.clip(im01, 0.0, 1.0)
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]
    write_png(path, (im * 255).astype(np.uint8))


def _interpolate(im: np.ndarray, size: Tuple[int, int],
                 mode: str) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(im, np.float64))
    t = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=size, mode=mode, align_corners=False)[0]
    out = out[0] if im.ndim == 2 else out.permute(1, 2, 0)
    return out.numpy()


def resize_linear(im: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize to (h, w) (``cv2.resize`` with ``INTER_LINEAR``),
    float64."""
    return _interpolate(im, (h, w), "bilinear")


def resize(im: np.ndarray, target_size: int,
           clamp: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Aspect-preserving bicubic resize to width ``target_size``; the
    height is rounded to nearest."""
    h, w = im.shape[:2]
    scale = target_size / w
    out = _interpolate(im, (int(round(h * scale)), int(round(w * scale))),
                       "bicubic")
    if clamp is not None:
        out = np.clip(out, clamp[0], clamp[1])
    return out


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    ch = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return np.stack([ch, ch, ch], axis=-1)


def jitter_colors(rgb: np.ndarray, d_brightness: float,
                  d_contrast: float, d_saturation: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Brightness, contrast and saturation jitter in random order:
    out = alpha*im + (1-alpha)*base with alpha ~ U[1-d, 1+d]; base = 0 /
    mean gray / gray image."""
    out = rgb.astype(np.float64, copy=True)
    attrs = ["brightness", "contrast", "saturation"]
    ds = [d_brightness, d_contrast, d_saturation]
    for i in rng.permutation(3):
        alpha = 1.0 + rng.uniform(-ds[i], ds[i]) if ds[i] > 0 else 1.0
        if attrs[i] == "brightness":
            base = 0.0
        elif attrs[i] == "contrast":
            base = float(np.mean(rgb2gray(out)[..., 0]))
        else:
            base = rgb2gray(out)
        out = alpha * out + (1.0 - alpha) * base
    return out


def add_lighting_noise(rgb01: np.ndarray, alpha_std: float,
                       rng: np.random.Generator) -> np.ndarray:
    """AlexNet PCA lighting noise."""
    alpha = rng.normal(0.0, alpha_std, size=3)
    noise = (_LIGHT_EIGVECS * alpha[None, :] * _LIGHT_EIGVALS[None, :]).sum(1)
    return rgb01.astype(np.float64) + noise[None, None, :]


def normalize_colors(rgb01: np.ndarray) -> np.ndarray:
    return (rgb01 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)


def denormalize_colors(rgb_norm: np.ndarray) -> np.ndarray:
    return rgb_norm * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)


def binarize(im: np.ndarray, thres: float) -> np.ndarray:
    return (im > thres).astype(im.dtype if im.dtype.kind == "f"
                               else np.float64)


def depth_to_mesh_df(depth_hw: np.ndarray, minmax, vox_res: int = 128,
                     cam_dist: float = 2.2) -> np.ndarray:
    """Host-side depth -> truncated distance field, (vox_res,)*3 float32:
    ``depth_hw`` relative depth in [0, 1] with background 0, ``minmax``
    the absolute (min, max) bounds; camera backprojection of the GenRe
    camera on the CPU."""
    from ..ops import FL_GENRE, camera_backproject, coords

    depth = np.asarray(depth_hw, np.float32)
    dmin, dmax = float(minmax[0]), float(minmax[1])
    abs_depth = np.where(depth > 0,
                         (1.0 - depth) * (dmax - dmin + 1e-4) + dmin,
                         0.0).astype(np.float32)
    d = coords.depth_image_to_cambp_frame(torch.from_numpy(abs_depth)[None])
    tdf = camera_backproject(d, FL_GENRE, cam_dist, vox_res)
    return tdf[0].numpy()


def get_bbox(mask01: np.ndarray, th: float = 0.95):
    """[tl_w, tl_h, br_w, br_h] of mask > th."""
    m = mask01[..., 0] if mask01.ndim == 3 else mask01
    indh, indw = np.where(m > th)
    if indh.size == 0:
        raise ValueError("empty mask -- no pixels above threshold")
    return [int(indw.min()), int(indh.min()), int(indw.max()), int(indh.max())]


def crop(img: np.ndarray, bbox, out_size: int, pad: int,
         pad_zero: bool = True) -> np.ndarray:
    """Square crop centred on the bbox, scaled so the object spans
    (out_size - 2*pad) pixels, padded at the borders, bilinear-resized to
    out_size x out_size."""
    y1, x1, y2, x2 = bbox
    h, w = img.shape[0], img.shape[1]
    x_mid, y_mid = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    side = max(x2 - x1, y2 - y1) * out_size / (out_size - 2.0 * pad)
    x1 = int(np.round(x_mid - side / 2.0))
    x2 = int(np.round(x_mid + side / 2.0))
    y1 = int(np.round(y_mid - side / 2.0))
    y2 = int(np.round(y_mid + side / 2.0))
    b_x = max(0, -x1); x1 = max(0, x1)
    b_y = max(0, -y1); y1 = max(0, y1)
    a_x = max(0, x2 - (h - 1)); x2 = min(x2, h - 1)
    a_y = max(0, y2 - (w - 1)); y2 = min(y2, w - 1)
    style = ({"mode": "constant", "constant_values": 0} if pad_zero
             else {"mode": "edge"})
    pads = ((b_x, a_x), (b_y, a_y)) + (((0, 0),) if img.ndim == 3 else ())
    img_crop = np.pad(img[x1:x2 + 1, y1:y2 + 1], pads, **style)
    return _interpolate(img_crop, (out_size, out_size), "bilinear")
