"""Frame scenes detection (FSD) of the reference: letterbox removal and
the split of stacked frames, in the submission's arithmetic.

The maps are the submission's: the per-pixel temporal variance of the
frames in float64, summed over RGB, and the mean of cv2.Canny(50, 400)
over at most 20 sampled frames (computed here from OpenCV's definition:
3x3 Sobel per channel with replicated borders, the channel of the largest
|dx| + |dy|, non-maximum suppression in 15-bit fixed point, hysteresis to
convergence; all integer). The cut decisions are 1-D threshold scans of
the maps' profiles (the submission's `remove_edges`, `split_imgs` and
their recursion), copied as they are, quirks included.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Box = Tuple[int, int, int, int]  # (top, bottom, left, right)
_TG22 = 13573  # tan(22.5 deg) in 15-bit fixed point, as OpenCV's Canny


def sample_edge_frames(num_frames: int, cap: int = 20) -> List[int]:
    if num_frames <= cap:
        return list(range(num_frames))
    return [int(np.round(i)) for i in np.arange(0, num_frames, num_frames / cap)]


def _sobel(ch_u8):
    p = F.pad(ch_u8.float()[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    top, mid, bot = p[:, :-2], p[:, 1:-1], p[:, 2:]
    gx = ((top[:, :, 2:] - top[:, :, :-2]) + 2.0 * (mid[:, :, 2:] - mid[:, :, :-2])
          + (bot[:, :, 2:] - bot[:, :, :-2]))
    gy = ((bot[:, :, :-2] + 2.0 * bot[:, :, 1:-1] + bot[:, :, 2:])
          - (top[:, :, :-2] + 2.0 * top[:, :, 1:-1] + top[:, :, 2:]))
    return gx.to(torch.int32), gy.to(torch.int32)


def _dilate(m):
    return F.max_pool2d(m.float()[:, None], 3, stride=1, padding=1)[:, 0] > 0


def _run_flood(s, w, dim: int):
    """Every pixel of each run of `w` along `dim` that holds a mark of `s`."""
    w_t = w.movedim(dim, -1).contiguous()
    starts = w_t.clone()
    starts[..., 1:] &= ~w_t[..., :-1]
    ids = torch.cumsum(starts.reshape(-1), 0)
    hits = torch.zeros(ids.numel() + 1, dtype=torch.int32, device=w.device)
    hits.scatter_add_(0, ids, s.movedim(dim, -1).reshape(-1).to(torch.int32))
    return (w_t & (hits[ids] > 0).reshape(w_t.shape)).movedim(-1, dim)


def canny(frames_u8: torch.Tensor, low: int = 50, high: int = 400) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, H, W] bool, cv2.Canny(frame, low, high) > 0."""
    dx, dy = _sobel(frames_u8[..., 0])
    mag = dx.abs() + dy.abs()
    for c in range(1, frames_u8.shape[-1]):
        dx_c, dy_c = _sobel(frames_u8[..., c])
        mag_c = dx_c.abs() + dy_c.abs()
        better = mag_c > mag
        dx, dy = torch.where(better, dx_c, dx), torch.where(better, dy_c, dy)
        mag = torch.where(better, mag_c, mag)
    h, w = mag.shape[1:]
    padded = F.pad(mag, (1, 1, 1, 1))

    def at(oy, ox):
        return padded[:, 1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

    ax, ay = dx.abs(), dy.abs() << 15
    tg22x = ax * _TG22
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << 16))
    same_sign = (dx < 0) == (dy < 0)
    keep_h = (mag > at(0, -1)) & (mag >= at(0, 1))
    keep_v = (mag > at(-1, 0)) & (mag >= at(1, 0))
    keep_d = torch.where(same_sign, (mag > at(-1, -1)) & (mag > at(1, 1)),
                         (mag > at(-1, 1)) & (mag > at(1, -1)))
    keep = torch.where(horizontal, keep_h, torch.where(vertical, keep_v, keep_d))
    weak = keep & (mag > low)
    strong = weak & (mag > high)
    while True:
        grown = _run_flood(strong, weak, dim=2)
        grown = _run_flood(grown, weak, dim=1)
        grown = grown | (weak & _dilate(grown))
        if torch.equal(grown, strong):
            return strong
        strong = grown


def maps(frames_u8: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(variance [H, W], mean Canny map [H, W]) of one video, float64."""
    x = frames_u8.double()
    n = x.shape[0]
    var = ((x - x.mean(dim=0)) ** 2).mean(dim=0).sum(dim=-1)
    idx = torch.tensor(sample_edge_frames(n), device=frames_u8.device)
    edges = canny(frames_u8.index_select(0, idx)).double().mean(dim=0)
    return var.cpu().numpy(), edges.cpu().numpy()


def _remove_edges_core(sum_h, sum_w, canny_h, canny_w, h: int, w: int) -> Box:
    start_h, start_w, end_h, end_w = 0, 0, h, w
    mean_c_max, extra_share, high_canny = 0.0225, 0.3, 0.65

    def is_static(profile, canny_slice, line):
        if profile.size == 0:
            return False
        sum_v = np.median(profile) + profile.mean()
        mean_c = canny_slice.mean() if canny_slice.size else 0.0
        if sum_v < 75 and mean_c < mean_c_max:
            return True
        return sum_v < 250 and mean_c < mean_c_max and line > high_canny

    rows = [i for i in np.where(canny_w > 0.125 + canny_w.mean())[0] if i not in (0, h - 1)]
    for idx in rows:
        if idx - start_h < 5:
            continue
        extra = round((idx - start_h) * extra_share)
        if is_static(sum_w[start_h:idx - extra], canny_w[start_h:idx - extra], canny_w[idx]):
            start_h = idx + 1
    for idx in reversed(rows):
        if end_h - idx < 5:
            continue
        extra = round((end_h - idx) * extra_share)
        if is_static(sum_w[idx + extra:end_h], canny_w[idx + extra:end_h], canny_w[idx]):
            end_h = idx
    cols = [i for i in np.where(canny_h > 0.125 + canny_h.mean())[0] if i not in (0, w - 1)]
    for idx in cols:
        if idx - start_w < 5:
            continue
        extra = round((idx - start_w) * extra_share)
        if is_static(sum_h[start_w:idx - extra], canny_h[start_w:idx - extra], canny_h[idx]):
            start_w = idx + 1
    for idx in reversed(cols):
        if end_w - idx < 5:
            continue
        extra = round((end_w - idx) * extra_share)
        if is_static(sum_h[idx + extra:end_w], canny_h[idx + extra:end_w], canny_h[idx]):
            end_w = idx
    return start_h, end_h, start_w, end_w


def remove_edges_box(img_var, avg_canny) -> Box:
    h, w = img_var.shape
    thr = min(max(np.quantile(avg_canny, 0.95), 0.2), avg_canny.mean() + 0.35)
    fea = (avg_canny > thr).astype(np.float32)
    return _remove_edges_core(img_var.mean(0), img_var.mean(1), fea.mean(0), fea.mean(1), h, w)


def _split_core(sum_h, sum_w, canny_h, canny_w, fea_mean, h, w, gap=5, min_size=120):
    half_gap = gap // 2
    res: List[Box] = []
    is_middle, start = False, 0
    for i in range(h - gap):
        if not is_middle and (sum_w[i:i + gap].mean() > 0.1 or i - start > 50):
            is_middle = True
        elif is_middle and sum_w[i:i + gap].mean() < 0.1:
            if i + half_gap - start > min_size:
                res.append((start, i + half_gap, 0, w))
            is_middle, start = False, i + half_gap
    if res or start != 0:
        if h - start > min_size:
            res.append((start, h, 0, w))
        if res:
            return res
    is_middle = False  # `start` is not reset: the submission's quirk
    for i in range(w - gap):
        if not is_middle and (sum_h[i:i + gap].mean() > 0.1 or i - start > 50):
            is_middle = True
        elif is_middle and sum_h[i:i + gap].mean() < 0.1:
            if i + half_gap - start > min_size:
                res.append((0, h, start, i + half_gap))
            is_middle, start = False, i + half_gap
    if res or start != 0:
        if w - start > min_size:
            res.append((0, h, start, w))
        if res:
            return res
    rows = list(np.where(canny_w > 0.45 + fea_mean)[0])[::-1]
    cols = list(np.where(canny_h > 0.45 + fea_mean)[0])[::-1]

    def cut_rows(end=h):
        for idx in rows:
            if end - idx > min_size:
                res.append((idx, end, 0, w))
                end = idx
        if res and end > min_size:
            res.append((0, end, 0, w))

    def cut_cols(end=w):
        for idx in cols:
            if end - idx > min_size:
                res.append((0, h, idx, end))
                end = idx
        if res and end > min_size:
            res.append((0, h, 0, end))

    for cut in ((cut_cols, cut_rows) if w > h else (cut_rows, cut_cols)):
        cut()
        if res:
            return res
    return [(0, h, 0, w)]


def split_boxes(img_var, avg_canny, min_size: int) -> List[Box]:
    h, w = img_var.shape
    thr = min(max(np.quantile(avg_canny, 0.95), 0.2), avg_canny.mean() + 0.3)
    fea = (avg_canny > thr).astype(np.float32)
    return _split_core(img_var.mean(0), img_var.mean(1), fea.mean(0), fea.mean(1),
                       float(fea.mean()), h, w, 5, min_size)


def clean_boxes(img_var, avg_canny, num_frames: int, origin: Box) -> List[Box]:
    o_sh, _, o_sw, _ = origin
    if num_frames < 5:
        return [origin]
    sh, eh, sw, ew = remove_edges_box(img_var, avg_canny)
    if min(eh - sh, ew - sw) < 20:
        return [origin]
    cut_var, cut_canny = img_var[sh:eh, sw:ew], avg_canny[sh:eh, sw:ew]
    subs = split_boxes(cut_var, cut_canny, min_size=80)
    if len(subs) == 1 and subs[0] == (0, eh - sh, 0, ew - sw):
        return [(o_sh + sh, o_sh + eh, o_sw + sw, o_sw + ew)]
    out: List[Box] = []
    for b_sh, b_eh, b_sw, b_ew in subs:
        child = (o_sh + sh + b_sh, o_sh + sh + b_eh, o_sw + sw + b_sw, o_sw + sw + b_ew)
        out.extend(clean_boxes(cut_var[b_sh:b_eh, b_sw:b_ew], cut_canny[b_sh:b_eh, b_sw:b_ew],
                               num_frames, child))
    return out


def video_boxes(frames_u8: torch.Tensor) -> List[Box]:
    """The crop boxes of one video: the cuts where FSD finds any, else the
    whole frame (a failure of the cut logic keeps the whole frame too)."""
    n, h, w, _ = frames_u8.shape
    whole = [(0, int(h), 0, int(w))]
    img_var, avg_canny = maps(frames_u8)
    try:
        boxes = clean_boxes(img_var, avg_canny, int(n), whole[0])
    except Exception:  # the submission's robustness contract: keep the raw frame
        return whole
    return [tuple(int(v) for v in b) for b in boxes]
