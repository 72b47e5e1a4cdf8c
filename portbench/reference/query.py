"""The query pipeline of the reference, video by video.

For each query video: the VED gate's probability (CLIP CLS features of up
to `max_frames` frames, zero-padded into the video-score model), the FSD
crop boxes, each ensemble member's raw descriptor of every frame of every
crop, and the row every frame would give after the pipeline's tail: each
member's descriptor L2-normalised, the members concatenated, PCA, the
first PCA dimension deleted (score-norm's low-variance dimension, 0 here),
L2, and the score-norm column -beta * the largest inner product with the
noise corpus (or -100 for a gated video). Near-duplicate removal drops
rows and changes none, so `Expected.rows` holds every frame's row and the
judge matches the program's rows to them by timestamp.

`assemble` turns member outputs into the pipeline's output the way the
pipeline does (near-duplicate removal first); the control uses it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import fsd, models
from portbench.reference.nn import Numerics, exact_f32, l2n
from portbench.reference.preprocess import clip_resize, crop_resize

Key = Tuple[int, Tuple[int, int, int, int]]  # (video index, crop box)


@dataclasses.dataclass
class Expected:
    logits: np.ndarray  # [V] float64 gate logits
    boxes: List[list]  # per video: its crop boxes
    members: Dict[Key, List[np.ndarray]]  # per stream: each member's [n, d] raw rows
    concat: Dict[Key, np.ndarray]  # per stream: [n, sum d] L2'd members, concatenated
    rows: Dict[Key, np.ndarray]  # per stream: [n, k] the final row of every frame
    kept: Dict[int, int]  # per ungated video: rows left after near-duplicate removal


def near_duplicate_keep(features: np.ndarray, threshold: float) -> List[int]:
    """The submission's greedy near-duplicate removal: anchors in
    descending order of mean similarity drop every frame more similar than
    `threshold`."""
    feat = features / np.maximum(np.linalg.norm(features, axis=1, keepdims=True), 1e-12)
    sim = feat @ feat.T - np.eye(len(feat))
    removed = np.zeros(len(feat), bool)
    for i in sim.mean(0).argsort()[::-1]:
        if not removed[i]:
            removed |= sim[i] > threshold
    return [int(i) for i in np.flatnonzero(~removed)]


def prepare_noise(noise: np.ndarray, device) -> torch.Tensor:
    """The noise corpus as score-norm reads it: dimension 0 deleted, rows L2'd."""
    return l2n(torch.from_numpy(noise[:, 1:]).to(device).float())


def tail_rows(nx: Numerics, concat: torch.Tensor, pca, noise_t: torch.Tensor, beta: float):
    """[n, D] concatenated member rows of a video the gate keeps -> [n, k]
    final rows (PCA, delete dimension 0, L2, the score-norm column)."""
    mean, comp = (torch.from_numpy(a).to(concat.device).float() for a in pca)
    x = l2n(nx.linear(concat - mean, comp)[:, 1:])
    best = torch.full((x.shape[0],), -float("inf"), device=x.device)
    for s in range(0, noise_t.shape[0], 32768):
        best = torch.maximum(best, nx.linear(x, noise_t[s:s + 32768]).amax(dim=1))
    return torch.cat([x, -beta * best[:, None]], dim=1)


def clip_features(nx: Numerics, p_clip, dims_clip, videos: List[torch.Tensor], max_frames: int,
                  chunk: int) -> torch.Tensor:
    """[V, max_frames, width] CLIP CLS features of each video's first
    `max_frames` frames, zero rows where a video has no frame."""
    feats = torch.zeros((len(videos), max_frames, dims_clip["width"]), device=videos[0].device)
    for i, v in enumerate(videos):
        frames = v[:max_frames]
        for s in range(0, frames.shape[0], chunk):
            img = clip_resize(frames[s:s + chunk], dims_clip["img_size"])
            feats[i, s:s + img.shape[0]] = models.clip_cls(nx, p_clip, dims_clip, img)
    return feats


@dataclasses.dataclass
class Calibration:
    """What set-up takes from the reference (float32) to set the heads."""

    clip: torch.Tensor  # [V, max_frames, width] CLIP features (the VSM's input)
    pooled: torch.Tensor  # [V, 2 hidden] the VSM head's input of each video
    boxes: List[list]  # per video: its FSD crop boxes
    head_means: Dict[str, torch.Tensor]  # per member: the mean of its head's input, float64


@torch.no_grad()
def calibrate(cfg: dict, weights: dict, videos: List[np.ndarray], device) -> Calibration:
    """The reference's inputs of the heads that set-up sets: the VSM head's
    input of every video, and, per member, the mean of its head's input over
    `query.centre_frames` evenly spaced frames of every stream (each video's
    FSD crops). `weights` as `expected` takes them; the heads are not read."""
    nx = Numerics("f32")
    q = cfg["query"]
    chunk = q["reference_chunk"]
    with exact_f32():
        dev_videos = [torch.from_numpy(v).to(device) for v in videos]
        clip = clip_features(nx, weights["clip"], cfg["models"]["clip"]["dims"], dev_videos,
                             q["max_frames"], chunk)
        pooled = models.vsm_pooled(nx, weights["vsm"], cfg["models"]["vsm"]["dims"], clip)
        boxes = [fsd.video_boxes(v) for v in dev_videos]
        head_means = {}
        for m in cfg["members"]:
            spec = cfg["models"][m["model"]]
            fn = models.DESCRIPTORS[spec["arch"]]
            total, rows = 0.0, 0
            for v, bs in zip(dev_videos, boxes):
                pick = torch.linspace(0, v.shape[0] - 1, min(q["centre_frames"], v.shape[0]),
                                      device=device).round().long()
                for box in bs:
                    x = fn(nx, weights[m["name"]], spec["dims"],
                           crop_resize(v[pick], box, m["size"], m["preset"]), head=False)
                    total = total + x.double().sum(dim=0)
                    rows += x.shape[0]
            head_means[m["name"]] = total / rows
        del dev_videos
    return Calibration(clip.cpu(), pooled, boxes, head_means)


@torch.no_grad()
def expected(nx: Numerics, cfg: dict, weights: dict, videos: List[np.ndarray], pca,
             noise: np.ndarray, device, cal: Calibration = None) -> Expected:
    """The reference's answers for `videos`. `weights` maps "clip", "vsm"
    and each member's name to its float32 weight dict. The members run on
    the videos the reference's own gate keeps. `cal`, where given, is the
    float32 reference's own calibration of the same videos: its CLIP
    features and boxes are used rather than computed again."""
    q = cfg["query"]
    chunk = q["reference_chunk"]
    with exact_f32():
        dev_videos = [torch.from_numpy(v).to(device) for v in videos]
        if cal is None:
            clip = clip_features(nx, weights["clip"], cfg["models"]["clip"]["dims"], dev_videos,
                                 q["max_frames"], chunk)
            boxes = [fsd.video_boxes(v) for v in dev_videos]
        else:
            clip, boxes = cal.clip.to(device), cal.boxes
        logits = models.vsm_logits(nx, weights["vsm"], cfg["models"]["vsm"]["dims"], clip)
        logits = logits.double().cpu().numpy()
        del clip
        thr_logit = float(np.log(q["score_threshold"]) - np.log1p(-q["score_threshold"]))
        keep = [i for i in range(len(videos)) if logits[i] >= thr_logit]
        noise_t = prepare_noise(noise, device)
        members, concat, rows, kept = {}, {}, {}, {}
        for i in keep:
            per_video = []
            for box in boxes[i]:
                outs = []
                for m in cfg["members"]:
                    spec = cfg["models"][m["model"]]
                    fn = models.DESCRIPTORS[spec["arch"]]
                    parts = [fn(nx, weights[m["name"]], spec["dims"],
                                crop_resize(dev_videos[i][s:s + chunk], box, m["size"],
                                            m["preset"]))
                             for s in range(0, dev_videos[i].shape[0], chunk)]
                    outs.append(torch.cat(parts))
                key = (i, tuple(box))
                members[key] = [o.cpu().numpy() for o in outs]
                cat = torch.cat([l2n(o) for o in outs], dim=1)
                concat[key] = cat.cpu().numpy()
                rows[key] = tail_rows(nx, cat, pca, noise_t, q["beta"]).cpu().numpy()
                per_video.append(concat[key])
            if per_video:
                kept[i] = len(near_duplicate_keep(np.concatenate(per_video),
                                                  q["frame_threshold"]))
        del dev_videos
    return Expected(logits, boxes, members, concat, rows, kept)


def assemble(exp: Expected, names: List[str], cfg: dict):
    """The pipeline's output from `exp` as if it were the program's: the
    video scores, the per-batch member records and the final rows after
    near-duplicate removal (a gated video keeps one row whose score-norm
    column is -100)."""
    q = cfg["query"]
    thr = q["score_threshold"]
    scores = {n: float(1.0 / (1.0 + np.exp(-exp.logits[i]))) for i, n in enumerate(names)}
    outputs, streams = {}, []
    for i, name in enumerate(names):
        if scores[name] < thr:
            k = len(next(iter(exp.rows.values()))[0])
            row = np.zeros((1, k), np.float32)
            row[0, 0], row[0, -1] = 1.0, -100.0
            outputs[name] = (np.array([[0, 1]]), row)
            continue
        keys = [(i, tuple(b)) for b in exp.boxes[i]]
        cat = np.concatenate([exp.concat[k] for k in keys])
        rows = np.concatenate([exp.rows[k] for k in keys])
        n = len(exp.concat[keys[0]])
        keep = near_duplicate_keep(cat, q["frame_threshold"])
        outputs[name] = (np.array(keep) % n, rows[keep])
        streams += [(k, exp.members[k]) for k in keys]
    return scores, streams, outputs
