"""Frame Scenes Detection (FSD): letterbox removal + stacked-frame splitting.

Counterpart of `vsc22_tpu/data/fsd.py`. The dense per-pixel maps run on
the device in torch: temporal variance (summed over RGB) and the average
edge map of <= 20 sampled frames, an approximation of cv2.Canny(50, 400)
on colour frames (per-channel Sobel, channel-max, NMS, 8 rounds of
line-flood hysteresis). The maps are rounded to f16 and the level-0
decision profiles are computed from the rounded maps, as the JAX package
does (`fsd.py:248`, `:263-266`). The cut decisions are tiny 1-D threshold
scans on the host; they are numpy and are copied from the JAX module,
which cannot be imported without JAX.

The exact path of the per-video pipeline (`variance_and_edges_host`,
`image_process`) computes the reference's own arithmetic without OpenCV:
the variance in float64 and `canny_edges`, cv2.Canny(50, 400) on colour
frames bit for bit, both in torch on the frames' device. The 8-round
`edge_map` stays as the twin of the JAX device path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vsc22_tpu_torch.core.device import resolve, upload

Array = np.ndarray
Box = Tuple[int, int, int, int]  # (start_h, end_h, start_w, end_w)

# Hysteresis flood rounds of the edge map (`fsd.py:54`).
_FLOOD_ROUNDS = 8


def sample_edge_frames(num_frames: int, cap: int = 20) -> List[int]:
    """Indices of <=cap frames used for the average edge map."""
    if num_frames <= cap:
        return list(range(num_frames))
    idxs = np.arange(0, num_frames, num_frames / cap)
    return [int(np.round(i)) for i in idxs]


# ---------------------------------------------------------------------------
# Device maps (torch)
# ---------------------------------------------------------------------------


def _sobel(ch_u8):
    """[N, H, W] uint8 -> (gx, gy) f32 with edge-replicated borders."""
    p = F.pad(ch_u8.float()[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    top, mid, bot = p[:, :-2], p[:, 1:-1], p[:, 2:]
    gx = (
        (top[:, :, 2:] - top[:, :, :-2])
        + 2.0 * (mid[:, :, 2:] - mid[:, :, :-2])
        + (bot[:, :, 2:] - bot[:, :, :-2])
    )
    gy = (
        (bot[:, :, :-2] + 2.0 * bot[:, :, 1:-1] + bot[:, :, 2:])
        - (top[:, :, :-2] + 2.0 * top[:, :, 1:-1] + top[:, :, 2:])
    )
    return gx, gy


def _dilate(m):
    """3x3 max over a zero-padded boolean map (values >= 0, so max_pool2d's
    -inf padding gives the same result)."""
    return F.max_pool2d(m.float()[:, None], 3, stride=1, padding=1)[:, 0] > 0


def edge_map(frames_u8):
    """[N, H, W, 3] uint8 -> [H, W] f32 average binarized edge map
    (`fsd._edges_kernel`)."""
    gx, gy = _sobel(frames_u8[..., 0])
    mag = gx.abs() + gy.abs()
    for c in (1, 2):
        gx_c, gy_c = _sobel(frames_u8[..., c])
        mag_c = gx_c.abs() + gy_c.abs()
        better = mag_c > mag  # ties keep the earliest channel
        gx = torch.where(better, gx_c, gx)
        gy = torch.where(better, gy_c, gy)
        mag = torch.maximum(mag_c, mag)

    def shift(a, dy, dx):
        return torch.roll(a, shifts=(dy, dx), dims=(1, 2))

    horiz = gx.abs() >= gy.abs()
    diag = (gx * gy) > 0
    n1 = torch.where(horiz, shift(mag, 0, 1), shift(mag, 1, 0))
    n2 = torch.where(horiz, shift(mag, 0, -1), shift(mag, -1, 0))
    d1 = torch.where(diag, shift(mag, 1, 1), shift(mag, 1, -1))
    d2 = torch.where(diag, shift(mag, -1, -1), shift(mag, -1, 1))
    use_diag = torch.minimum(gx.abs(), gy.abs()) > 0.41 * torch.maximum(gx.abs(), gy.abs())
    prev = torch.where(use_diag, d1, n1)
    nxt = torch.where(use_diag, d2, n2)
    keep = (mag >= prev) & (mag >= nxt)

    strong = keep & (mag > 400.0)  # Canny high threshold
    weak = keep & (mag > 50.0)  # Canny low threshold
    for _ in range(_FLOOD_ROUNDS):
        strong = _run_flood(strong, weak, dim=2)
        strong = _run_flood(strong, weak, dim=1)
        for _ in range(2):
            strong = strong | (weak & _dilate(strong))
    return strong.float().mean(dim=0)


# ---------------------------------------------------------------------------
# The exact host path: cv2.Canny(50, 400) and the float64 variance
# ---------------------------------------------------------------------------
#
# OpenCV's Canny (imgproc/src/canny.cpp, aperture 3, L1 norm) on a colour
# frame: 3x3 Sobel per channel with replicated borders (int16, exact); per
# pixel the channel of the largest |dx| + |dy| (the first on ties); the
# magnitude is zero outside the frame; non-maximum suppression in 15-bit
# fixed point (tan 22.5 deg = 13573 / 2^15) with strict and non-strict
# comparisons as below; candidates above floor(low), seeds above
# floor(high); hysteresis floods the candidates 8-connected to a seed, to
# convergence. All integer or boolean, so any device gives the same bits.

_CANNY_TG22 = 13573


def canny_edges(frames_u8: torch.Tensor, low: float = 50, high: float = 400) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, H, W] bool: `cv2.Canny(frame, low, high) > 0`
    for each frame, bit for bit, on the frames' device."""
    def sobel(c):  # integer-valued f32, exact
        return (g.to(torch.int32) for g in _sobel(frames_u8[..., c]))

    dx, dy = sobel(0)
    mag = dx.abs() + dy.abs()
    for c in range(1, frames_u8.shape[-1]):
        dx_c, dy_c = sobel(c)
        mag_c = dx_c.abs() + dy_c.abs()
        better = mag_c > mag  # ties keep the earliest channel
        dx = torch.where(better, dx_c, dx)
        dy = torch.where(better, dy_c, dy)
        mag = torch.where(better, mag_c, mag)
    h, w = mag.shape[1:]
    padded = F.pad(mag, (1, 1, 1, 1))  # the magnitude is zero outside the frame

    def at(oy, ox):
        return padded[:, 1 + oy : 1 + oy + h, 1 + ox : 1 + ox + w]

    ax = dx.abs()
    ay = dy.abs() << 15
    tg22x = ax * _CANNY_TG22
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg22x + (ax << 16))
    same_sign = (dx < 0) == (dy < 0)
    keep_h = (mag > at(0, -1)) & (mag >= at(0, 1))
    keep_v = (mag > at(-1, 0)) & (mag >= at(1, 0))
    keep_d = torch.where(
        same_sign, (mag > at(-1, -1)) & (mag > at(1, 1)), (mag > at(-1, 1)) & (mag > at(1, -1))
    )
    keep = torch.where(horizontal, keep_h, torch.where(vertical, keep_v, keep_d))
    weak = keep & (mag > int(np.floor(low)))
    strong = weak & (mag > int(np.floor(high)))
    while True:  # each round: whole runs along rows, then columns, then one 3x3 step
        grown = _run_flood(strong, weak, dim=2)
        grown = _run_flood(grown, weak, dim=1)
        grown = grown | (weak & _dilate(grown))
        if torch.equal(grown, strong):
            return strong
        strong = grown


def _run_flood(s, w, dim: int):
    """Every pixel of each contiguous run of `w` along `dim` that holds a
    mark of `s` (s within w): the runs numbered by a running sum of their
    starts, a scatter-add of the marks per run, a gather back: a fixed
    dozen launches whatever the run lengths."""
    w_t = w.movedim(dim, -1).contiguous()
    starts = w_t.clone()
    starts[..., 1:] &= ~w_t[..., :-1]
    ids = torch.cumsum(starts.reshape(-1), 0)
    hits = torch.zeros(ids.numel() + 1, dtype=torch.int32, device=w.device)
    hits.scatter_add_(0, ids, s.movedim(dim, -1).reshape(-1).to(torch.int32))
    return (w_t & (hits[ids] > 0).reshape(w_t.shape)).movedim(-1, dim)


def _frames_on(frames, device) -> torch.Tensor:
    """A frame sequence (or an [N, H, W, 3] tensor) as one uint8 tensor on
    `device`."""
    if isinstance(frames, torch.Tensor):
        return frames.to(device)
    if isinstance(frames, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(frames)).to(device)
    if frames and isinstance(frames[0], torch.Tensor):
        return torch.stack(list(frames)).to(device)
    return torch.from_numpy(np.stack([np.asarray(f) for f in frames])).to(device)


def _over(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n, correctly rounded on every device (CUDA divides by a host
    scalar as a product with its reciprocal, which can round otherwise)."""
    return x / torch.tensor(float(n), dtype=x.dtype, device=x.device)


def edge_map_cv2(frames, device="cuda") -> Array:
    """Average binarized cv2.Canny(50, 400) edge map of `frames`, float64
    [H, W] (`fsd.edge_map_cv2`), computed by `canny_edges` on `device`."""
    stack = _frames_on(frames, resolve(device))
    return _over(canny_edges(stack).sum(dim=0).double(), stack.shape[0]).cpu().numpy()


def variance_and_edges_host(frames, device="cuda") -> Tuple[Array, Array]:
    """The reference's map arithmetic (`fsd.variance_and_edges_host`): the
    per-pixel temporal variance in float64 summed over RGB, in numpy's
    order of summation, and the average Canny map of the sampled frames;
    on `device`, returned as host float64 arrays."""
    stack = _frames_on(frames, resolve(device))
    x = stack.double()
    n = x.shape[0]
    mean = _over(x.sum(dim=0), n)  # integer sums: exact in any order
    sq = (x[0] - mean) ** 2
    for i in range(1, n):  # frame by frame, as numpy reduces axis 0
        d = x[i] - mean
        sq = sq + d * d
    var = _over(sq, n)
    var = (var[..., 0] + var[..., 1] + var[..., 2]).cpu().numpy()
    idx = torch.tensor(sample_edge_frames(n), device=stack.device)
    return var, edge_map_cv2(stack.index_select(0, idx), stack.device)


def variance_and_edges_device(frames, device="cuda") -> Tuple[Array, Array]:
    """The device maps of one video (`fsd.variance_and_edges_device`): the
    per-pixel temporal variance in float32 summed over RGB and the 8-round
    `edge_map` of the sampled frames, on `device`, returned as host float32
    arrays (not rounded to f16, unlike `batch_maps_profiles_dispatch`)."""
    stack = _frames_on(frames, resolve(device))
    xf = stack.float()
    var = ((xf - xf.mean(dim=0, keepdim=True)) ** 2).mean(dim=0).sum(dim=-1)
    idx = torch.tensor(sample_edge_frames(int(stack.shape[0])), device=stack.device)
    return var.cpu().numpy(), edge_map(stack.index_select(0, idx)).cpu().numpy()


def variance_and_edges_device_batch(stack5d) -> Tuple[Array, Array]:
    """The device maps of a batch of same-shape videos with one fetch
    (`fsd.variance_and_edges_device_batch`): `stack5d` [V, N, H, W, 3]
    uint8 on the card or the CPU -> host float32 var [V, H, W] and edges
    [V, H, W], each video's `variance_and_edges_device` maps rounded to f16
    (the fetch ships f16, as the JAX package's does)."""
    v = int(stack5d.shape[0])
    flat = _batch_maps(stack5d).float().cpu().numpy()
    return flat[:v], flat[v:]


def _batch_maps(stack5d):
    """[V, N, H, W, 3] uint8 -> [2V, H, W] f16 (`fsd._batch_maps`): the
    variance maps, then the edge maps of the sampled frames."""
    idx = upload(np.asarray(sample_edge_frames(int(stack5d.shape[1]))), stack5d.device)
    var, edges = [], []
    for video in stack5d:  # one video at a time bounds the temporaries
        xf = video.float()
        mean = xf.mean(dim=0, keepdim=True)
        var.append(((xf - mean) ** 2).mean(dim=0).sum(dim=-1))
        edges.append(edge_map(video.index_select(0, idx)))
    return torch.stack(var + edges).to(torch.float16)


def _quantile_linear(a, q: float):
    """Row-wise linear-interpolation quantile of [V, n] f32, in f32 as
    `jnp.quantile` computes it (no input-size limit, unlike
    torch.quantile). The interpolation weights stay 0-dim CPU tensors,
    which a CUDA op takes as scalars without a copy."""
    s = a.sort(dim=1).values
    n = s.shape[1]
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
    low = torch.floor(pos)
    high_w = pos - low
    lo = int(min(max(low.item(), 0), n - 1))
    hi = int(min(max(torch.ceil(pos).item(), 0), n - 1))
    return s[:, lo] * (1.0 - high_w) + s[:, hi] * high_w


def batch_maps_profiles_dispatch(stack5d):
    """Maps and level-0 decision profiles for a batch of same-shape videos,
    with no host sync (`fsd.batch_maps_profiles_dispatch`).

    `stack5d`: [V, N, H, W, 3] uint8. Returns (maps16 [2V, H, W] f16 --
    variance maps then edge maps --, pack [V, 3W + 3H + 1] f32 laid out as
    [sum_h(W) | canny_h_re(W) | canny_h_sp(W) | sum_w(H) | canny_w_re(H) |
     canny_w_sp(H) | sp_fea_mean], (V, H, W)), both left on the device.
    The profiles come from the f16-rounded maps, as the host would compute
    them from a fetched map."""
    v, h, w = int(stack5d.shape[0]), int(stack5d.shape[2]), int(stack5d.shape[3])
    maps16 = _batch_maps(stack5d)
    var32 = maps16[:v].float()
    edge32 = maps16[v:].float()
    sum_h = var32.mean(dim=1)  # [V, W] per-column variance profile
    sum_w = var32.mean(dim=2)  # [V, H] per-row variance profile
    q95 = _quantile_linear(edge32.reshape(v, -1), 0.95)
    emean = edge32.mean(dim=(1, 2))
    thr_re = torch.minimum(q95.clamp(min=0.2), emean + 0.35)[:, None, None]
    thr_sp = torch.minimum(q95.clamp(min=0.2), emean + 0.3)[:, None, None]
    fea_re = (edge32 > thr_re).float()
    fea_sp = (edge32 > thr_sp).float()
    pack = torch.cat(
        [
            sum_h, fea_re.mean(dim=1), fea_sp.mean(dim=1),
            sum_w, fea_re.mean(dim=2), fea_sp.mean(dim=2),
            fea_sp.mean(dim=(1, 2))[:, None],
        ],
        dim=1,
    )
    return maps16, pack, (v, h, w)


def batch_maps_profiles_device(stack5d):
    """(maps16 on the device, a profile dict per video): the dispatch
    above plus one fetch of the small profile pack
    (`fsd.batch_maps_profiles_device`); the full maps stay on the device."""
    maps16, pack, dims = batch_maps_profiles_dispatch(stack5d)
    return maps16, unpack_profiles(pack.cpu().numpy(), *dims)


# ---------------------------------------------------------------------------
# Cut decisions (host numpy, copied from vsc22_tpu/data/fsd.py:313-686)
# ---------------------------------------------------------------------------


def unpack_profiles(pack: np.ndarray, v: int, h: int, w: int) -> List[dict]:
    profs = []
    for i in range(v):
        row = pack[i]
        profs.append(
            dict(
                sum_h=row[:w],
                canny_h_re=row[w : 2 * w],
                canny_h_sp=row[2 * w : 3 * w],
                sum_w=row[3 * w : 3 * w + h],
                canny_w_re=row[3 * w + h : 3 * w + 2 * h],
                canny_w_sp=row[3 * w + 2 * h : 3 * w + 3 * h],
                sp_mean=float(row[3 * w + 3 * h]),
            )
        )
    return profs


def level0_boxes_from_profiles(
    prof: dict, h: int, w: int, num_frames: int
) -> Optional[List[Box]]:
    """Replay `clean_boxes`' level-0 decisions from profiles alone: the box
    list when decidable without the 2-D maps (the no-edit case), else None
    (the caller then fetches the maps and runs `clean_boxes`)."""
    origin = (0, h, 0, w)
    if num_frames < 5:
        return [origin]
    sh, eh, sw, ew = _remove_edges_core(
        prof["sum_h"], prof["sum_w"], prof["canny_h_re"], prof["canny_w_re"], h, w
    )
    if min(eh - sh, ew - sw) < 20:
        return [origin]
    if (sh, eh, sw, ew) != origin:
        return None
    sub = _split_core(
        prof["sum_h"], prof["sum_w"], prof["canny_h_sp"], prof["canny_w_sp"],
        prof["sp_mean"], h, w, min_size=80,
    )
    if sub == [origin]:
        return [origin]
    return None


def remove_edges_box(img_var: Array, avg_canny: Array) -> Box:
    """Crop box stripping static letterbox/pillarbox borders, from the maps."""
    sum_h = img_var.mean(0)  # per-column variance profile
    sum_w = img_var.mean(1)  # per-row variance profile
    h, w = img_var.shape
    threshold = min(max(np.quantile(avg_canny, 0.95), 0.2), avg_canny.mean() + 0.35)
    canny_fea = (avg_canny > threshold).astype(np.float32)
    return _remove_edges_core(sum_h, sum_w, canny_fea.mean(0), canny_fea.mean(1), h, w)


def _remove_edges_core(
    sum_h: Array, sum_w: Array, canny_h: Array, canny_w: Array, h: int, w: int
) -> Box:
    """remove_edges decision from the 1-D profiles alone."""
    start_h, start_w = 0, 0
    end_h, end_w = h, w

    MEAN_C = 0.0225
    EXTRA = 0.3
    HIGH_CANNY = 0.65

    def is_static(profile_slice, canny_slice, line_canny):
        if profile_slice.size == 0:
            return False
        sum_v = np.median(profile_slice) + profile_slice.mean()
        mean_c = canny_slice.mean() if canny_slice.size else 0.0
        if sum_v < 75 and mean_c < MEAN_C:
            return True
        return sum_v < 250 and mean_c < MEAN_C and line_canny > HIGH_CANNY

    rows = [i for i in np.where(canny_w > 0.125 + canny_w.mean())[0] if i not in (0, h - 1)]
    for idx in rows:
        if idx - start_h < 5:
            continue
        extra = round((idx - start_h) * EXTRA)
        if is_static(sum_w[start_h : idx - extra], canny_w[start_h : idx - extra], canny_w[idx]):
            start_h = idx + 1
    for idx in reversed(rows):
        if end_h - idx < 5:
            continue
        extra = round((end_h - idx) * EXTRA)
        if is_static(sum_w[idx + extra : end_h], canny_w[idx + extra : end_h], canny_w[idx]):
            end_h = idx

    cols = [i for i in np.where(canny_h > 0.125 + canny_h.mean())[0] if i not in (0, w - 1)]
    for idx in cols:
        if idx - start_w < 5:
            continue
        extra = round((idx - start_w) * EXTRA)
        if is_static(sum_h[start_w : idx - extra], canny_h[start_w : idx - extra], canny_h[idx]):
            start_w = idx + 1
    for idx in reversed(cols):
        if end_w - idx < 5:
            continue
        extra = round((end_w - idx) * EXTRA)
        if is_static(sum_h[idx + extra : end_w], canny_h[idx + extra : end_w], canny_h[idx]):
            end_w = idx

    return start_h, end_h, start_w, end_w


def split_boxes(
    img_var: Array, avg_canny: Array, gap: int = 5, min_size: int = 120
) -> List[Box]:
    """Cut stacked-frame composites at low-variance gaps or edge lines."""
    h, w = img_var.shape
    threshold = min(max(np.quantile(avg_canny, 0.95), 0.2), avg_canny.mean() + 0.3)
    canny_fea = (avg_canny > threshold).astype(np.float32)
    return _split_core(
        img_var.mean(0), img_var.mean(1),
        canny_fea.mean(0), canny_fea.mean(1), float(canny_fea.mean()),
        h, w, gap, min_size,
    )


def _split_core(
    sum_h: Array, sum_w: Array, canny_h: Array, canny_w: Array,
    fea_mean: float, h: int, w: int, gap: int = 5, min_size: int = 120
) -> List[Box]:
    """split_boxes decision from 1-D profiles + the binarized-map mean."""
    half_gap = gap // 2
    res: List[Box] = []

    is_middle = False
    start = 0
    for i in range(h - gap):
        if not is_middle and (sum_w[i : i + gap].mean() > 0.1 or i - start > 50):
            is_middle = True
        elif is_middle and sum_w[i : i + gap].mean() < 0.1:
            if i + half_gap - start > min_size:
                res.append((start, i + half_gap, 0, w))
            is_middle = False
            start = i + half_gap
    if res or start != 0:
        if h - start > min_size:
            res.append((start, h, 0, w))
        if res:
            return res

    is_middle = False  # `start` deliberately not reset (reference quirk)
    for i in range(w - gap):
        if not is_middle and (sum_h[i : i + gap].mean() > 0.1 or i - start > 50):
            is_middle = True
        elif is_middle and sum_h[i : i + gap].mean() < 0.1:
            if i + half_gap - start > min_size:
                res.append((0, h, start, i + half_gap))
            is_middle = False
            start = i + half_gap
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

    order = (cut_cols, cut_rows) if w > h else (cut_rows, cut_cols)
    for cut in order:
        cut()
        if res:
            return res
    return [(0, h, 0, w)]


def clean_boxes(
    img_var: Array, avg_canny: Array, num_frames: int, origin: Box
) -> List[Box]:
    """remove_edges + split recursion producing ABSOLUTE frame boxes."""
    o_sh, _, o_sw, _ = origin
    if num_frames < 5:
        return [origin]
    sh, eh, sw, ew = remove_edges_box(img_var, avg_canny)
    if min(eh - sh, ew - sw) < 20:
        return [origin]
    cut_var = img_var[sh:eh, sw:ew]
    cut_canny = avg_canny[sh:eh, sw:ew]
    sub_boxes = split_boxes(cut_var, cut_canny, min_size=80)
    full = (0, eh - sh, 0, ew - sw)
    if len(sub_boxes) == 1 and sub_boxes[0] == full:
        return [(o_sh + sh, o_sh + eh, o_sw + sw, o_sw + ew)]
    res: List[Box] = []
    for b_sh, b_eh, b_sw, b_ew in sub_boxes:
        child_origin = (
            o_sh + sh + b_sh,
            o_sh + sh + b_eh,
            o_sw + sw + b_sw,
            o_sw + sw + b_ew,
        )
        res.extend(
            clean_boxes(
                cut_var[b_sh:b_eh, b_sw:b_ew],
                cut_canny[b_sh:b_eh, b_sw:b_ew],
                num_frames,
                child_origin,
            )
        )
    return res


def video_maps(img_list: Sequence, device="cuda", precomputed_maps=None,
               use_device_maps: bool = False, device_frames=None) -> Tuple[Array, Array]:
    """One video's (variance, edge) maps as the JAX entry points pick them:
    `precomputed_maps` as given; else the device maps of `device_frames`
    (a [N, H, W, 3] uint8 copy of the frames already on the device); else
    the device maps of the frames with `use_device_maps`; else the exact
    host maps (`variance_and_edges_host`)."""
    if precomputed_maps is not None:
        return precomputed_maps
    if device_frames is not None:
        return variance_and_edges_device(device_frames, device_frames.device)
    maps_fn = variance_and_edges_device if use_device_maps else variance_and_edges_host
    return maps_fn(img_list, device)


def image_process_boxes(
    img_list: Sequence, precomputed_maps: Optional[Tuple[Array, Array]] = None,
    use_device_maps: bool = False, device_frames=None, device="cuda",
) -> Tuple[bool, List[Box]]:
    """(changed?, crop boxes in original coordinates) from the maps of the
    video (`fsd.image_process_boxes`; the maps as `video_maps` picks them).
    Callers with a fallback handler compute the maps beforehand, outside
    it, so a device error propagates instead of being read as "no edit"."""
    n = len(img_list)
    h, w = (int(d) for d in img_list[0].shape[:2])
    img_var, avg_canny = video_maps(img_list, device, precomputed_maps, use_device_maps,
                                    device_frames)
    boxes = clean_boxes(img_var, avg_canny, n, (0, h, 0, w))
    changed = len(boxes) > 1 or boxes[0] != (0, h, 0, w)
    return changed, boxes


def remove_edges(
    imgs: List, img_var: Array, avg_canny: Array
) -> Tuple[List, Array, Array]:
    """Strip static letterbox/pillarbox borders (array-returning wrapper)."""
    sh, eh, sw, ew = remove_edges_box(img_var, avg_canny)
    return (
        [x[sh:eh, sw:ew, :] for x in imgs],
        img_var[sh:eh, sw:ew],
        avg_canny[sh:eh, sw:ew],
    )


def split_imgs(
    imgs: List, img_var: Array, avg_canny: Array, gap: int = 5, min_size: int = 120
) -> List[Tuple[List, Array, Array]]:
    """Array-returning wrapper over `split_boxes`."""
    return [
        (
            [img[sh:eh, sw:ew, :] for img in imgs],
            img_var[sh:eh, sw:ew],
            avg_canny[sh:eh, sw:ew],
        )
        for sh, eh, sw, ew in split_boxes(img_var, avg_canny, gap, min_size)
    ]


def clean_imgs(imgs: List, img_var: Array, avg_canny: Array) -> List[List]:
    """Box recursion applied to the frames."""
    h, w = imgs[0].shape[:2]
    boxes = clean_boxes(img_var, avg_canny, len(imgs), (0, h, 0, w))
    return [[img[sh:eh, sw:ew, :] for img in imgs] for sh, eh, sw, ew in boxes]


def image_process(
    img_list: Sequence, device="cuda", precomputed_maps: Optional[Tuple[Array, Array]] = None,
    use_device_maps: bool = False, device_frames=None,
) -> Tuple[bool, List]:
    """FSD over one video's frames (`fsd.image_process`): (processed?,
    frames), where `frames` is the concatenation of every scene crop's
    frame stream when borders or splits were found, and the input frames
    otherwise. The frames may be numpy arrays or tensors (crops are views
    of them). The maps (`video_maps`: the exact host path, or with
    `use_device_maps` or `device_frames` `variance_and_edges_device`) are
    computed first, outside the fallback, so a device error propagates; a
    failure in the cut decisions keeps the raw frames (the reference
    robustness contract)."""
    maps = video_maps(img_list, device, precomputed_maps, use_device_maps, device_frames)
    try:
        changed, boxes = image_process_boxes(img_list, maps)
        if changed:
            out = []
            for sh, eh, sw, ew in boxes:
                out.extend([img[sh:eh, sw:ew, :] for img in img_list])
            return True, out
    except Exception:
        pass
    return False, list(img_list)
