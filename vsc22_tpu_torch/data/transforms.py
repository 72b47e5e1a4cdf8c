"""Per-backbone frame transforms as batched device ops.

Counterpart of `vsc22_tpu/data/transforms.py`. A crop + resize is linear,
so it is a pair of dense cubic weight matrices over the ORIGINAL frame axes
(zero outside the crop box), built on the host with numpy exactly as the
JAX package builds them (`jax.image.resize` "cubic" semantics: Keys a=-0.5,
antialias stretch on downscale, per-output renormalisation). Frames are
NHWC uint8 tensors on any device.

Precision as in `transforms.py:188`: a bf16 consumer gets bf16 operands
with f32 accumulation (the row pass is rounded to bf16 before the column
pass); an f32 consumer stays f32 throughout.

The per-video path resizes as the JAX package's host twins do
(`resize_normalize_host`, `clip_preprocess_host`: `cv2.resize` with
INTER_CUBIC on uint8 frames), but with OpenCV's generic arithmetic
computed here, in torch on the frames' device, so that no OpenCV is
needed: `resize_cubic_u8` gives `cv2.resize`'s bits with OpenCV's IPP
route off (the IPP route rounds ~4% of the values one level otherwise).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vsc22_tpu_torch.core.device import upload
from vsc22_tpu_torch.data.presets import PRESETS


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x <= 1.0,
        1.5 * x3 - 2.5 * x2 + 1.0,
        np.where(x < 2.0, -0.5 * x3 + 2.5 * x2 - 4.0 * x + 2.0, 0.0),
    )


def cubic_resize_weights(
    in_size: int, out_size: int, start: int = 0, stop: int | None = None
) -> np.ndarray:
    """[in_size, out_size] f32 matrix resizing the slice [start, stop) to
    out_size with jax.image.resize "cubic" semantics; rows outside the slice
    are zero. x[..., start:stop] resized == x @ W along that axis."""
    stop = in_size if stop is None else stop
    length = stop - start
    scale = out_size / length
    kernel_scale = max(1.0 / scale, 1.0)  # antialias stretch when downscaling
    sample_f = (np.arange(out_size) + 0.5) / scale - 0.5  # in crop coords
    x = np.abs(sample_f[None, :] - np.arange(length)[:, None]) / kernel_scale
    weights = _keys_cubic(x) / kernel_scale
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1e-6, weights / total, 0.0)
    full = np.zeros((in_size, out_size), np.float32)
    full[start:stop] = weights.astype(np.float32)
    return full


@functools.lru_cache(maxsize=64)
def _clip_resize_weights(h: int, w: int, size: int, device: torch.device):
    """(row, col) weights on `device` of a shortest-side resize to `size`
    followed by a center crop: a column subset of the full resize
    matrices, uploaded once per (h, w, size, device)."""
    new_h, new_w, top, left = clip_crop_shape(h, w, size)
    row_w = cubic_resize_weights(h, new_h)[:, top : top + size]
    col_w = cubic_resize_weights(w, new_w)[:, left : left + size]
    return upload(row_w, device), upload(col_w, device)


@functools.lru_cache(maxsize=64)
def _square_resize_weights(h: int, w: int, size: int, device: torch.device):
    """(row, col) weights on `device` of the square resize to `size`."""
    return (upload(cubic_resize_weights(h, size), device),
            upload(cubic_resize_weights(w, size), device))


@functools.lru_cache(maxsize=64)
def _constants(preset: str, dtype: torch.dtype, device: torch.device):
    """(255 in `dtype`, mean, std) of `preset` on `device`, uploaded once:
    a per-call upload from pageable memory would make the host wait. The
    divisor stays a device tensor: CUDA divides by a host scalar as a
    product with its reciprocal, which can round otherwise."""
    mean, std = PRESETS[preset]
    return (upload(np.array(255.0, np.float32), device).to(dtype),  # exact in bf16
            upload(np.array(mean, np.float32), device),
            upload(np.array(std, np.float32), device))


def crop_resize_normalize(frames_u8, row_w, col_w, preset: str = "vit",
                          out_dtype=torch.float32):
    """[N, H, W, 3] uint8 -> [N, S, T, 3] normalized `out_dtype`, with the
    crop and resize carried by row_w [H, S] and col_w [W, T] (tensors on
    the frames' device, or host arrays, which are uploaded). With every
    operand on the card, nothing here makes the host wait."""
    ct = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    device = frames_u8.device
    c255, mean_t, std_t = _constants(preset, ct, device)
    x = frames_u8.to(ct) / c255
    rw = _on(row_w, device).to(ct).float()
    cw = _on(col_w, device).to(ct).float()
    y = torch.einsum("nhwc,hs->nswc", x.float(), rw).to(ct)
    y = torch.einsum("nswc,wt->nstc", y.float(), cw)
    return ((y - mean_t) / std_t).to(out_dtype)


def _on(w, device: torch.device) -> torch.Tensor:
    return w.to(device) if isinstance(w, torch.Tensor) else upload(w, device)


def clip_preprocess(frames_u8, size: int = 224, out_dtype=torch.float32):
    """CLIP preset: shortest-side cubic resize to `size` + center crop."""
    _, h, w, _ = frames_u8.shape
    row_w, col_w = _clip_resize_weights(int(h), int(w), size, frames_u8.device)
    return crop_resize_normalize(frames_u8, row_w, col_w, preset="clip", out_dtype=out_dtype)


def resize_normalize(frames_u8, size: int, preset: str = "vit", out_dtype=torch.float32):
    """[N, H, W, 3] uint8 -> [N, size, size, 3] normalized: the square
    `jax.image.resize` cubic resize (no crop) of `transforms.resize_normalize`,
    as full-frame weight matrices."""
    _, h, w, _ = frames_u8.shape
    row_w, col_w = _square_resize_weights(int(h), int(w), size, frames_u8.device)
    return crop_resize_normalize(frames_u8, row_w, col_w, preset=preset, out_dtype=out_dtype)


def batch_frames(frames: list, chunk: int = 48) -> list:
    """Split a stack of frames into <=chunk sub-batches (the reference's
    LEN_THRESHOLD=48 inference micro-batching)."""
    arr = np.stack([np.asarray(f) for f in frames])
    return [arr[i : i + chunk] for i in range(0, len(arr), chunk)]


# ---------------------------------------------------------------------------
# OpenCV's INTER_CUBIC resize of uint8 frames (its generic, non-IPP route)
# ---------------------------------------------------------------------------
#
# OpenCV resizes an 8-bit image in two passes (imgproc/src/resize.cpp):
# - per output index d: fx = float32((d + 0.5) * scale - 0.5) with
#   scale = 1 / (out / in) in double, sx = floor(fx), and the Keys
#   coefficients (A = -0.75) of fx - sx in float32, each scaled by 2^11 and
#   rounded to a short; taps sx-1 .. sx+2 clamped at the border, with no
#   antialias stretch when downscaling;
# - a horizontal pass in integers (exact);
# - a vertical pass that, for each group of 8 consecutive values of an
#   output row (128-bit SIMD lanes of int16), sums in float32
#   S0*b0 + (S1*b1 + (S2*b2 + S3*b3)) with b = beta * 2^-22, each product
#   and sum rounded, then rounds half to even and saturates; the values
#   after the last full group of 8 take the scalar integer route,
#   (sum S*beta + 2^21) >> 22, saturated.
# Both passes are exact or float32 elementwise, so any device gives the
# same bits; the taps and coefficients are cached per (in, out).

_CV2_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE
_CV2_SIMD_LANES = 8  # int16 lanes of a 128-bit vector


def _cv2_cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """`interpolateCubic` of OpenCV in float32: [n] -> [n, 4]."""
    f = np.float32
    a = f(-0.75)
    x = x.astype(np.float32)
    x1 = x + f(1)
    c0 = ((a * x1 - f(5) * a) * x1 + f(8) * a) * x1 - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + f(1)
    omx = f(1) - x
    c2 = ((a + f(2)) * omx - (a + f(3))) * omx * omx + f(1)
    c3 = f(1) - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1)


@functools.lru_cache(maxsize=128)
def _cv2_taps(n_in: int, n_out: int):
    """(source index [n_out, 4] int64, fixed-point coefficient [n_out, 4]
    int64) of OpenCV's cubic resize along one axis."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    start = np.floor(f).astype(np.int64)
    frac = (f - start.astype(np.float32)).astype(np.float32)
    coef = np.rint(_cv2_cubic_coeffs(frac) * np.float32(_CV2_COEF_SCALE)).astype(np.int64)
    index = np.clip(start[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return index, coef


def resize_cubic_u8(frames_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] uint8 -> [..., out_h, out_w, C] uint8, bit for bit
    `cv2.resize(frame, (out_w, out_h), interpolation=cv2.INTER_CUBIC)` on
    OpenCV's generic route, on the frames' device."""
    *lead, h, w, c = frames_u8.shape
    x = frames_u8.reshape(-1, h, w, c).to(torch.int32)
    dev = x.device
    xi, xa = _cv2_taps(int(w), out_w)
    yi, ya = _cv2_taps(int(h), out_h)
    xa_t = torch.from_numpy(xa.astype(np.int32)).to(dev)
    hor = sum(
        x.index_select(2, torch.from_numpy(xi[:, k]).to(dev)) * xa_t[:, k].view(1, 1, out_w, 1)
        for k in range(4)
    )  # [B, h, out_w, C] int32, exact
    rows = [hor.index_select(1, torch.from_numpy(yi[:, k]).to(dev)) for k in range(4)]
    beta = torch.from_numpy(ya.astype(np.float32) * np.float32(2.0**-22)).to(dev)
    acc = rows[3].float() * beta[:, 3].view(1, out_h, 1, 1)
    for k in (2, 1, 0):
        acc = rows[k].float() * beta[:, k].view(1, out_h, 1, 1) + acc
    out = acc.round().clamp(0, 255).to(torch.uint8).reshape(-1, out_h, out_w * c)
    width = out_w * c
    vec = width // _CV2_SIMD_LANES * _CV2_SIMD_LANES
    if vec < width:  # the scalar tail of each row: integer arithmetic
        ib = torch.from_numpy(ya).to(dev)
        tail = sum(
            rows[k].reshape(-1, out_h, width)[..., vec:].long() * ib[:, k].view(1, out_h, 1)
            for k in range(4)
        )
        out[..., vec:] = ((tail + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
    return out.reshape(*lead, out_h, out_w, c)


def _normalize(x_u8: torch.Tensor, preset: str) -> torch.Tensor:
    """uint8 -> (x / 255 - mean) / std in float32, as the host twins compute it."""
    mean, std = PRESETS[preset]
    # A device tensor as the divisor: CUDA divides by a host scalar as a
    # product with its reciprocal, which can round otherwise.
    x = x_u8.float() / torch.tensor(255.0, device=x_u8.device)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) / std_t


def clip_crop_shape(h: int, w: int, size: int):
    """(resized h, resized w, top, left) of the shortest-side resize to `size`
    and its center crop."""
    if h <= w:
        nh, nw = size, max(int(round(w * size / h)), size)
    else:
        nh, nw = max(int(round(h * size / w)), size), size
    return nh, nw, (nh - size) // 2, (nw - size) // 2


def resize_normalize_frames(frames_u8: torch.Tensor, size: int, preset: str = "vit"):
    """[N, H, W, 3] uint8 -> [N, size, size, 3] float32: OpenCV's cubic
    resize to size x size, then the preset's normalization, on the frames'
    device (`resize_normalize_host` for a batch of one shape)."""
    return _normalize(resize_cubic_u8(frames_u8, size, size), preset)


def clip_preprocess_frames(frames_u8: torch.Tensor, size: int = 224):
    """[N, H, W, 3] uint8 -> [N, size, size, 3] float32: OpenCV's cubic
    shortest-side resize to `size`, the center crop, CLIP's normalization
    (`clip_preprocess_host` for a batch of one shape)."""
    _, h, w, _ = frames_u8.shape
    nh, nw, top, left = clip_crop_shape(int(h), int(w), size)
    x = resize_cubic_u8(frames_u8, nh, nw)[:, top : top + size, left : left + size]
    return _normalize(x, "clip")


def _as_frames(img) -> torch.Tensor:
    return img if isinstance(img, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(img))


def resize_normalize_host(img, size: int, preset: str = "vit") -> torch.Tensor:
    """One [H, W, 3] uint8 frame (numpy, or a tensor on any device) ->
    [size, size, 3] float32 on its device: the counterpart of the JAX
    package's cv2 twin of `resize_normalize`."""
    return resize_normalize_frames(_as_frames(img)[None], size, preset)[0]


def clip_preprocess_host(img, size: int = 224) -> torch.Tensor:
    """One frame -> [size, size, 3] float32: the counterpart of the JAX
    package's cv2 twin of `clip_preprocess`."""
    return clip_preprocess_frames(_as_frames(img)[None], size)[0]
