"""Training augmentation suite (albumentations/AugLy replacement).

Counterpart of `vsc22_tpu/data/augment.py`, op for op: host ops over uint8
HWC RGB images in numpy and OpenCV, each drawing from a
`np.random.Generator` in the JAX module's order, so that one seed gives
the same image bit for bit in both packages (on one OpenCV build). The
`build_*` functions compose the reference's four pipelines: two "hard" query-view
pipelines (overlays, stacking, corner thumbnails, aspect distortion -- the
copy-detection robustness), one "easy" key-view pipeline and one light
"native" pipeline for annotated and query frames. Emoji overlays are drawn
procedurally (coloured glyph shapes), so no asset pack is needed: what
matters for training is the occlusion statistics, not the artwork.
"""

from __future__ import annotations

import string
from typing import Callable, Optional, Sequence

import cv2
import numpy as np

Image = np.ndarray  # uint8 [H, W, 3]


class Augmentation:
    """Base: applies `op` with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: Image, rng: np.random.Generator) -> Image:
        if rng.uniform() < self.p:
            return self.apply(img, rng)
        return img

    def apply(self, img: Image, rng: np.random.Generator) -> Image:
        raise NotImplementedError


class Compose(Augmentation):
    def __init__(self, ops: Sequence[Augmentation], p: float = 1.0):
        super().__init__(p)
        self.ops = list(ops)

    def apply(self, img, rng):
        for op in self.ops:
            img = op(img, rng)
        return img


class RandomCompose(Compose):
    """Compose with per-call random op order (reference RandomCompose)."""

    def __init__(self, ops, shuffle: bool = True, p: float = 1.0):
        super().__init__(ops, p)
        self.shuffle = shuffle

    def apply(self, img, rng):
        order = rng.permutation(len(self.ops)) if self.shuffle else range(len(self.ops))
        for i in order:
            img = self.ops[i](img, rng)
        return img


class OneOf(Augmentation):
    def __init__(self, ops: Sequence[Augmentation], p: float = 0.5):
        super().__init__(p)
        self.ops = list(ops)

    def apply(self, img, rng):
        op = self.ops[rng.integers(len(self.ops))]
        return op.apply(img, rng)


# ---------------------------------------------------------------------------
# Geometric
# ---------------------------------------------------------------------------


class HorizontalFlip(Augmentation):
    def apply(self, img, rng):
        return img[:, ::-1].copy()


class VerticalFlip(Augmentation):
    def apply(self, img, rng):
        return img[::-1].copy()


class RandomRotate90(Augmentation):
    def apply(self, img, rng):
        return np.rot90(img, k=int(rng.integers(1, 4))).copy()


class RandomResizedCrop(Augmentation):
    def __init__(self, height: int, width: int, scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3), p=1.0):
        super().__init__(p)
        self.height, self.width = height, width
        self.scale, self.ratio = scale, ratio

    def apply(self, img, rng):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            ar = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if cw <= w and ch <= h:
                y = int(rng.integers(0, h - ch + 1))
                x = int(rng.integers(0, w - cw + 1))
                crop = img[y : y + ch, x : x + cw]
                return cv2.resize(crop, (self.width, self.height), interpolation=cv2.INTER_LINEAR)
        return cv2.resize(img, (self.width, self.height), interpolation=cv2.INTER_LINEAR)


class RandomScale(Augmentation):
    def __init__(self, limit: float = 0.1, p: float = 0.1):
        super().__init__(p)
        self.limit = limit

    def apply(self, img, rng):
        s = 1.0 + rng.uniform(-self.limit, self.limit)
        h, w = img.shape[:2]
        return cv2.resize(img, (max(int(w * s), 1), max(int(h * s), 1)))


class Rotate(Augmentation):
    def __init__(self, limit: float = 45.0, p: float = 0.1):
        super().__init__(p)
        self.limit = limit

    def apply(self, img, rng):
        angle = rng.uniform(-self.limit, self.limit)
        h, w = img.shape[:2]
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        return cv2.warpAffine(img, m, (w, h), borderValue=(0, 0, 0))


class Perspective(Augmentation):
    def __init__(self, scale: float = 0.05, p: float = 0.1):
        super().__init__(p)
        self.scale = scale

    def apply(self, img, rng):
        h, w = img.shape[:2]
        src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        jitter = rng.uniform(-self.scale, self.scale, (4, 2)).astype(np.float32)
        dst = src + jitter * np.float32([w, h])
        m = cv2.getPerspectiveTransform(src, dst)
        return cv2.warpPerspective(img, m, (w, h), borderValue=(0, 0, 0))


class AspectRatio(Augmentation):
    """Stretch to a random aspect ratio (reference AspectRatio)."""

    def __init__(self, ratio_range=(0.5, 2.0), p: float = 0.5):
        super().__init__(p)
        self.ratio_range = ratio_range

    def apply(self, img, rng):
        h, w = img.shape[:2]
        ratio = rng.uniform(*self.ratio_range)
        area = h * w
        nw = max(int(round(np.sqrt(area * ratio))), 1)
        nh = max(int(round(np.sqrt(area / ratio))), 1)
        return cv2.resize(img, (nw, nh))


class CropAndPad(Augmentation):
    """Random-margin pad with a random solid color (reference CropAndPad),
    or negative-percent crop (albumentations CropAndPad behavior)."""

    def __init__(self, percent=(-0.4, 0.4), p: float = 0.5):
        super().__init__(p)
        self.percent = percent

    def apply(self, img, rng):
        h, w = img.shape[:2]
        pct = rng.uniform(*self.percent)
        if pct >= 0:
            color = rng.integers(0, 256, 3, dtype=np.uint8)
            top, bottom = (int(h * rng.uniform(0, pct)) for _ in range(2))
            left, right = (int(w * rng.uniform(0, pct)) for _ in range(2))
            out = np.empty((h + top + bottom, w + left + right, 3), np.uint8)
            out[...] = color
            out[top : top + h, left : left + w] = img
            return out
        cut_h = int(h * min(-pct, 0.45))
        cut_w = int(w * min(-pct, 0.45))
        t = int(rng.integers(0, cut_h + 1))
        l = int(rng.integers(0, cut_w + 1))
        return img[t : h - (cut_h - t) or h, l : w - (cut_w - l) or w].copy()


# ---------------------------------------------------------------------------
# Photometric
# ---------------------------------------------------------------------------


class GaussNoise(Augmentation):
    def __init__(self, var_limit=(10.0, 50.0), p: float = 0.1):
        super().__init__(p)
        self.var_limit = var_limit

    def apply(self, img, rng):
        sigma = np.sqrt(rng.uniform(*self.var_limit))
        noise = rng.normal(0, sigma, img.shape)
        return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


class GaussianBlur(Augmentation):
    def __init__(self, kernel_choices=(3, 5, 7), p: float = 0.5):
        super().__init__(p)
        self.kernel_choices = kernel_choices

    def apply(self, img, rng):
        k = int(rng.choice(self.kernel_choices))
        return cv2.GaussianBlur(img, (k, k), 0)


class ImageCompression(Augmentation):
    def __init__(self, quality_lower: int = 20, quality_upper: int = 100, p: float = 0.1):
        super().__init__(p)
        self.lo, self.hi = quality_lower, quality_upper

    def apply(self, img, rng):
        q = int(rng.integers(self.lo, self.hi + 1))
        ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])
        return cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1].copy()


class ColorJitter(Augmentation):
    def __init__(self, brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2, p=1.0):
        super().__init__(p)
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    def apply(self, img, rng):
        x = img.astype(np.float32)
        x = x * rng.uniform(max(0, 1 - self.b), 1 + self.b)  # brightness
        mean = x.mean()
        x = (x - mean) * rng.uniform(max(0, 1 - self.c), 1 + self.c) + mean  # contrast
        gray = x.mean(axis=2, keepdims=True)
        x = gray + (x - gray) * rng.uniform(max(0, 1 - self.s), 1 + self.s)  # saturation
        x = np.clip(x, 0, 255).astype(np.uint8)
        if self.h > 0:
            hsv = cv2.cvtColor(x, cv2.COLOR_RGB2HSV).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-self.h, self.h) * 180)) % 180
            x = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
        return x


class RandomBrightness(Augmentation):
    def __init__(self, limit=(-0.2, 0.1), p: float = 1.0):
        super().__init__(p)
        self.limit = limit

    def apply(self, img, rng):
        delta = rng.uniform(*self.limit) * 255
        return np.clip(img.astype(np.float32) + delta, 0, 255).astype(np.uint8)


class ToGray(Augmentation):
    def apply(self, img, rng):
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return np.stack([gray] * 3, axis=-1)


class HueSaturationValue(Augmentation):
    def __init__(self, hue=20, sat=30, val=20, p: float = 1.0):
        super().__init__(p)
        self.hue, self.sat, self.val = hue, sat, val

    def apply(self, img, rng):
        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(rng.integers(-self.hue, self.hue + 1))) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + rng.integers(-self.sat, self.sat + 1), 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] + rng.integers(-self.val, self.val + 1), 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


class RandomBrightnessContrast(Augmentation):
    def apply(self, img, rng):
        alpha = 1.0 + rng.uniform(-0.2, 0.2)
        beta = rng.uniform(-0.2, 0.2) * 255
        return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)


class RandomSnow(Augmentation):
    """Whiten random bright regions (albumentations RandomSnow effect)."""

    def __init__(self, p: float = 0.1):
        super().__init__(p)

    def apply(self, img, rng):
        hls = cv2.cvtColor(img, cv2.COLOR_RGB2HLS).astype(np.float32)
        point = rng.uniform(100, 150)
        boost = rng.uniform(1.5, 2.5)
        light = hls[..., 1]
        hls[..., 1] = np.where(light < point, np.clip(light * boost, 0, 255), light)
        return cv2.cvtColor(hls.astype(np.uint8), cv2.COLOR_HLS2RGB)


class Opacity(Augmentation):
    """Blend toward white (AugLy opacity, reference Opacity)."""

    def __init__(self, level_range=(0.5, 1.0), p: float = 0.5):
        super().__init__(p)
        self.level_range = level_range

    def apply(self, img, rng):
        level = rng.uniform(*self.level_range)
        white = np.full_like(img, 255)
        return (img.astype(np.float32) * level + white * (1 - level)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Overlays (the copy-detection-specific hard augs)
# ---------------------------------------------------------------------------


def _draw_glyph(canvas: Image, rng: np.random.Generator, x: int, y: int, size: int):
    """Procedural 'emoji': a colored filled shape with a face-like accent."""
    color = tuple(int(c) for c in rng.integers(60, 256, 3))
    kind = rng.integers(3)
    if kind == 0:
        cv2.circle(canvas, (x, y), size // 2, color, -1)
    elif kind == 1:
        cv2.rectangle(canvas, (x - size // 2, y - size // 2), (x + size // 2, y + size // 2), color, -1)
    else:
        pts = np.array(
            [[x, y - size // 2], [x - size // 2, y + size // 2], [x + size // 2, y + size // 2]]
        )
        cv2.fillPoly(canvas, [pts], color)
    cv2.circle(canvas, (x - size // 6, y - size // 8), max(size // 10, 1), (0, 0, 0), -1)
    cv2.circle(canvas, (x + size // 6, y - size // 8), max(size // 10, 1), (0, 0, 0), -1)


class OverlayEmoji(Augmentation):
    def __init__(self, p: float = 0.1, max_count: int = 3):
        super().__init__(p)
        self.max_count = max_count

    def apply(self, img, rng):
        out = img.copy()
        h, w = out.shape[:2]
        for _ in range(int(rng.integers(1, self.max_count + 1))):
            size = int(min(h, w) * rng.uniform(0.1, 0.3))
            x = int(rng.integers(size, max(w - size, size + 1)))
            y = int(rng.integers(size, max(h - size, size + 1)))
            _draw_glyph(out, rng, x, y, size)
        return out


class SquareEmoji(Augmentation):
    """Pad to square, then overlay a glyph (reference SquareEmoji)."""

    def __init__(self, p: float = 0.1):
        super().__init__(p)

    def apply(self, img, rng):
        h, w = img.shape[:2]
        side = max(h, w)
        canvas = np.zeros((side, side, 3), np.uint8)
        y0, x0 = (side - h) // 2, (side - w) // 2
        canvas[y0 : y0 + h, x0 : x0 + w] = img
        return OverlayEmoji(p=1.0).apply(canvas, rng)


class OverlayText(Augmentation):
    def __init__(self, p: float = 0.1, max_lines: int = 3):
        super().__init__(p)
        self.max_lines = max_lines

    def apply(self, img, rng):
        out = img.copy()
        h, w = out.shape[:2]
        for _ in range(int(rng.integers(1, self.max_lines + 1))):
            n = int(rng.integers(5, 20))
            text = "".join(rng.choice(list(string.ascii_letters + string.digits + " ")) for _ in range(n))
            scale = rng.uniform(0.5, 1.6) * min(h, w) / 256
            color = tuple(int(c) for c in rng.integers(0, 256, 3))
            x = int(rng.integers(0, max(w // 2, 1)))
            y = int(rng.integers(int(20 * scale) + 1, max(h, int(20 * scale) + 2)))
            cv2.putText(out, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX, scale, color, 2, cv2.LINE_AA)
        return out


class RandomOverlayImages(Augmentation):
    """Alpha-blend a random distractor frame over the image."""

    def __init__(self, frame_source: Optional[Callable] = None, alpha_range=(0.2, 0.5), p: float = 0.1):
        super().__init__(p)
        self.frame_source = frame_source
        self.alpha_range = alpha_range

    def apply(self, img, rng):
        if self.frame_source is None:
            return img
        other = self.frame_source(rng)
        if other is None:
            return img
        other = cv2.resize(other, (img.shape[1], img.shape[0]))
        alpha = rng.uniform(*self.alpha_range)
        return (img.astype(np.float32) * (1 - alpha) + other.astype(np.float32) * alpha).astype(
            np.uint8
        )


class RandomOverlayCorners(Augmentation):
    """Paste small thumbnails into the 4 corners (reference: background
    images from data/meta/bg_img; here any frame source or solid blocks)."""

    def __init__(self, frame_source: Optional[Callable] = None, p: float = 0.1):
        super().__init__(p)
        self.frame_source = frame_source

    def apply(self, img, rng):
        out = img.copy()
        h, w = out.shape[:2]
        th, tw = max(h // 4, 1), max(w // 4, 1)
        corners = [(0, 0), (0, w - tw), (h - th, 0), (h - th, w - tw)]
        for y, x in corners:
            if self.frame_source is not None:
                thumb = self.frame_source(rng)
                thumb = cv2.resize(thumb, (tw, th)) if thumb is not None else None
            else:
                thumb = None
            if thumb is None:
                thumb = np.empty((th, tw, 3), np.uint8)
                thumb[...] = rng.integers(0, 256, 3, dtype=np.uint8)
            out[y : y + th, x : x + tw] = thumb
        return out


class RandomStackImages(Augmentation):
    """Concatenate 2-4 frames (h / v / 2x2 grid) including the input —
    trains robustness to stacked-frame edits (reference RandomStackImages)."""

    def __init__(self, frame_source: Optional[Callable] = None, width: int = 256, p: float = 0.1):
        super().__init__(p)
        self.frame_source = frame_source
        self.width = width

    def apply(self, img, rng):
        if self.frame_source is None:
            return img
        count = int(rng.integers(2, 5))
        tiles = [img]
        for _ in range(count - 1):
            other = self.frame_source(rng)
            tiles.append(other if other is not None else img)
        order = rng.permutation(len(tiles))
        tiles = [cv2.resize(tiles[i], (self.width, self.width)) for i in order]
        if len(tiles) == 4:
            top = np.concatenate(tiles[:2], axis=1)
            bottom = np.concatenate(tiles[2:], axis=1)
            return np.concatenate([top, bottom], axis=0)
        axis = int(rng.integers(2))
        return np.concatenate(tiles, axis=axis)


# ---------------------------------------------------------------------------
# Reference training pipelines
# ---------------------------------------------------------------------------


def build_hard_pipelines(width: int, crop: float = 0.8, mixup: float = 0.1, frame_source=None):
    """The two 'hard' query-view pipelines (videolmdb_dataset.py:47-104)."""
    pipe1 = Compose(
        [
            OneOf([HorizontalFlip(p=1), VerticalFlip(p=1), RandomRotate90(p=1)], p=0.2),
            RandomResizedCrop(width, width, scale=(crop, 1), p=1),
            GaussNoise(p=0.1),
            GaussianBlur(p=0.5),
            RandomScale(p=0.1),
            Perspective(p=0.1),
            ImageCompression(20, 100, p=0.1),
            RandomSnow(p=0.1),
            OverlayText(p=0.1),
            OverlayEmoji(p=0.1),
            RandomCompose(
                [
                    OneOf([CropAndPad(p=1), CropAndPad(percent=(-0.4, 0.4), p=1)], p=0.1),
                    OneOf(
                        [
                            ColorJitter(p=1),
                            RandomBrightness(p=1),
                            ToGray(p=1),
                            HueSaturationValue(p=1),
                            RandomBrightnessContrast(p=1),
                        ],
                        p=0.8,
                    ),
                    RandomOverlayImages(frame_source, p=mixup),
                    RandomOverlayCorners(frame_source, p=0.1),
                    Rotate(45, p=0.1),
                ],
                shuffle=True,
            ),
        ]
    )
    pipe2 = Compose(
        [
            RandomResizedCrop(width, width, scale=(crop, 1), p=1),
            RandomOverlayImages(frame_source, p=mixup),
            RandomOverlayCorners(frame_source, p=0.1),
            OverlayText(p=0.1),
            OverlayEmoji(p=0.1),
            RandomCompose(
                [
                    OneOf([CropAndPad(p=1), CropAndPad(percent=(-0.4, 0.4), p=1)], p=0.2),
                    OneOf(
                        [
                            ColorJitter(p=1),
                            RandomBrightness(p=1),
                            ToGray(p=1),
                            HueSaturationValue(p=1),
                            RandomBrightnessContrast(p=1),
                        ],
                        p=0.8,
                    ),
                    RandomStackImages(frame_source, width, p=0.1),
                    Rotate(45, p=0.1),
                ],
                shuffle=True,
            ),
        ]
    )
    return [pipe1, pipe2]


def build_easy_pipeline(width: int, crop: float = 0.8):
    """The key-view pipeline (videolmdb_dataset.py:106-124)."""
    return Compose(
        [
            HorizontalFlip(p=0.2),
            RandomResizedCrop(width, width, scale=(crop, 1), p=1),
            OneOf(
                [ColorJitter(p=1), RandomBrightness(p=1), ToGray(p=1), HueSaturationValue(p=1)],
                p=0.5,
            ),
            Rotate(45, p=0.1),
            GaussNoise(p=0.1),
            GaussianBlur(p=0.5),
            RandomScale(p=0.1),
            Perspective(p=0.1),
            OneOf([CropAndPad(p=1), CropAndPad(percent=(-0.4, 0.4), p=1)], p=0.2),
        ]
    )


def build_native_pipeline(width: int, crop: float = 0.8):
    """Light pipeline for annotated/query frames (videolmdb_dataset.py:126-131)."""
    return Compose(
        [
            HorizontalFlip(p=0.2),
            RandomResizedCrop(width, width, scale=(crop, 1), p=1),
            GaussNoise(p=0.1),
            ImageCompression(50, 100, p=0.1),
        ]
    )
