"""The batched query pass of a descriptor ensemble with its VED gate.

One unit of work is one pass over the traffic's videos: the program's
`BatchedQueryPipeline.process_many` (host frames uploaded inside the pass)
and `query_score_normalize` against the noise corpus, results on the host.

Set-up draws every model's weights on the device, the videos, a PCA
projection (a seeded orthonormal 2048 -> 512 map, loaded as a deployment
loads its PCA file) and the noise corpus, all from the seed. Before the
program is built it sets two heads from the seed's own videos, as a
trained model would have them, by the plain float32 reference alone
(`reference/query.calibrate`): the video-score head places every video's
gate logit 8 or more above the threshold's, and each member's head bias
centres its descriptors of this traffic (with random weights every
descriptor is dominated by one shared direction, and near-duplicate
removal would merge distinct scenes). Both sides are then given those
heads; the seconds the reference takes here are not set-up's.

The judge compares, for every pass of the window, the program's gate
probabilities, the FSD boxes and each member's raw descriptors (both read
where the pipeline finalises a batch), and every output row, with the
plain reference's (`reference/query.py`).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import models as ref_models
from portbench.reference import query as ref_query
from portbench.reference.nn import Numerics
from portbench.tasks import common
from portbench.traffic import generate
from portbench.yardstick.roofline import FORWARD_FLOPS

LIBRARIES = ("attn_proj", "ln_mlp", "row_max", "swin_block")
GATE_MARGIN = 8.0  # the lowest gate logit above the threshold's


class QueryEnsemble:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.q = cfg["query"]
        self.passes: List[dict] = []
        self._records: List[tuple] = []
        self.libraries = LIBRARIES
        self.reference_s = 0.0

    # --- set-up ---------------------------------------------------------------

    def keys(self) -> List[str]:
        return ["clip", "vsm"] + [m["name"] for m in self.cfg["members"]]

    def setup(self) -> None:
        from vsc22_tpu_torch.core.types import VideoFeature
        from vsc22_tpu_torch.ops.pca import PCAModel
        from vsc22_tpu_torch.pipelines.batch_query import (
            BatchedExtractor,
            BatchedQueryPipeline,
            BatchedVED,
        )

        cfg, q, dev = self.cfg, self.q, self.device
        dtype = common.DTYPES[cfg["dtype"]]
        self.names = [f"Q{i:05d}" for i in range(self.traffic["videos"])]
        self.videos = generate.videos(self.traffic, self.seed, dev)
        self.models, self.specs = {}, {}
        for key in self.keys():
            model_name = key if key in ("clip", "vsm") else self._member(key)["model"]
            self.models[key] = common.build_model(cfg["models"][model_name], dtype, dev).eval()
            self.specs[key] = common.param_spec(self.models[key])
        self.calibrate()
        for k, key in enumerate(self.keys()):
            weights = common.draw(self.specs[key], self._seed(10 + k), dev)
            weights.update(self.overrides.get(key, {}))
            common.load(self.models[key], weights)
        gen = torch.Generator(dev).manual_seed(self._seed(3))
        d_in = sum(cfg["models"][m["model"]]["dims"].get("out_dim") or
                   cfg["models"][m["model"]]["dims"]["output_dim"] for m in cfg["members"])
        comp = torch.linalg.qr(torch.randn((d_in, q["pca_dim"]), generator=gen, device=dev))[0]
        self.pca = (np.zeros(d_in, np.float32), comp.t().contiguous().cpu().numpy())
        noise = torch.randn((q["noise_videos"] * q["noise_frames"], q["pca_dim"]), generator=gen,
                            device=dev).cpu().numpy()
        self.noise_rows = noise
        ts = np.arange(q["noise_frames"], dtype=np.float32)
        self.noise = [VideoFeature(video_id=f"N{i:06d}", timestamps=ts,
                                   feature=noise[i * q["noise_frames"]:(i + 1) * q["noise_frames"]])
                      for i in range(q["noise_videos"])]
        self.extractors = [BatchedExtractor(self.models[m["name"]], m["size"], m["preset"],
                                            q["chunk"]) for m in cfg["members"]]
        self.ved = BatchedVED(self.models["clip"], self.models["vsm"], q["max_frames"], q["chunk"])
        self.pipe = BatchedQueryPipeline(
            self.extractors, pca=PCAModel(self.pca[0], self.pca[1], np.ones(q["pca_dim"],
                                                                            np.float32)),
            ved=self.ved, use_fsd=True, score_threshold=q["score_threshold"],
            frame_threshold=q["frame_threshold"], out_dim=q["pca_dim"], device=dev)
        finalize = self.pipe._finalize

        def record(ctx, pending, fetched):
            self._records.append((list(ctx["names"]),
                                  [None if p is None else [b for _, b in p] for p in ctx["proc"]],
                                  list(ctx["frame_counts"]),
                                  [int(out.shape[-1]) for _, out in pending], fetched))
            return finalize(ctx, pending, fetched)

        self.pipe._finalize = record
        self.unit()  # warm-up: every shape of the pass
        self.passes.clear()
        self._records.clear()

    def _member(self, name: str) -> dict:
        return next(m for m in self.cfg["members"] if m["name"] == name)

    def _seed(self, stream: int) -> int:
        return generate.sub_seed(self.seed, stream)

    @torch.no_grad()
    def calibrate(self) -> None:
        """`overrides`: the heads set from the float32 reference's readings
        of this seed's videos (see the module docstring), in the program's
        dtype, which both sides are given. Its seconds go to `reference_s`;
        the device's peak is reset after it."""
        t0 = time.perf_counter()
        dtype = common.DTYPES[self.cfg["dtype"]]
        weights = self.reference_weights(heads=False)
        self.cal = ref_query.calibrate(self.cfg, weights, self.videos, self.device)
        q = self.q
        thr = float(np.log(q["score_threshold"]) - np.log1p(-q["score_threshold"]))
        pooled = self.cal.pooled.double()
        w = weights["vsm"]["output_proj.weight"].double()[0]
        w = (w / (pooled @ w).std().clamp(min=1e-3)).to(dtype)
        b = thr + GATE_MARGIN - float((pooled @ w.double()).min())
        self.overrides = {"vsm": {"output_proj.weight": w.reshape(1, -1),
                                  "output_proj.bias": torch.full((1,), b, device=self.device,
                                                                 dtype=dtype)}}
        for m in self.cfg["members"]:
            prefix = ref_models.HEADS[self.cfg["models"][m["model"]]["arch"]]
            head_w = weights[m["name"]][prefix + ".weight"].double()
            head_b = weights[m["name"]][prefix + ".bias"].double()
            bias = head_b - head_w @ self.cal.head_means[m["name"]]
            self.overrides[m["name"]] = {prefix + ".bias": bias.to(dtype)}
        del weights
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.reference_s += time.perf_counter() - t0

    # --- the window -----------------------------------------------------------

    def unit(self) -> int:
        from vsc22_tpu_torch.retrieval.score_norm import query_score_normalize

        start = len(self._records)
        feats = self.pipe.process_many(self.names, self.videos, batch=self.traffic["batch"])
        normed = query_score_normalize(
            feats, self.noise, video_scores=self.pipe.video_scores,
            score_threshold=self.q["score_threshold"], beta=self.q["beta"], nk=self.q["nk"],
            device=self.device)
        self.passes.append(dict(scores=dict(self.pipe.video_scores),
                                outputs={f.video_id: (f.timestamps, f.feature) for f in normed},
                                records=self._records[start:]))
        return len(self.names)

    def finish_window(self) -> None:
        pass

    def window_metrics(self, work: int, seconds: float) -> Dict[str, float]:
        return {"query_videos_per_s": work / seconds}

    def trace_modules(self) -> Dict[str, list]:
        mods = {f"extract/{m['name']}": [self.models[m["name"]]] for m in self.cfg["members"]}
        mods["ved/clip"] = [self.models["clip"]]
        mods["ved/vsm"] = [self.models["vsm"]]
        return mods

    def flops_per_row(self) -> Dict[str, float]:
        out = {}
        for label in self.trace_modules():
            key = label.split("/")[1]
            model = key if key in ("clip", "vsm") else self._member(key)["model"]
            spec = self.cfg["models"][model]
            out[label] = float(FORWARD_FLOPS[spec["arch"]](spec["dims"]))
        return out

    def set_timer(self, timer) -> None:
        self.pipe.timer = timer
        for ext in self.pipe.extractors:
            ext.timer = timer

    # --- the judge ------------------------------------------------------------

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        for attr in ("pipe", "ved", "extractors", "models"):
            setattr(self, attr, None)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def reference_weights(self, heads: bool = True) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each model's weights redrawn from the seed, in float32; with
        `heads`, the heads that `calibrate` set."""
        out = {}
        for k, key in enumerate(self.keys()):
            w = common.draw(self.specs[key], self._seed(10 + k), self.device)
            if heads:
                w.update(self.overrides.get(key, {}))
            out[key] = common.as_f32(w)
        return out

    def expected(self, numerics: str = "f32") -> ref_query.Expected:
        cal = self.cal if numerics == "f32" else None
        return ref_query.expected(Numerics(numerics), self.cfg, self.reference_weights(),
                                  self.videos, self.pca, self.noise_rows, self.device, cal)

    def judge(self, exp: ref_query.Expected, passes=None) -> dict:
        head = float(self.overrides["vsm"]["output_proj.weight"].float().norm())
        return judge(self.cfg, exp, self.names, self.passes if passes is None else passes, head)

    def control_answers(self, exp: ref_query.Expected) -> List[dict]:
        """The control's answers (the reference in fp8) in the shape of a pass."""
        scores, streams, outputs = ref_query.assemble(exp, self.names, self.cfg)
        return [dict(scores=scores, outputs=outputs, streams=streams)]


# --- the comparison -------------------------------------------------------------


LOGIT_RANGE = (-30.0, 12.0)  # where a float32 probability still resolves its logit


def _logit(p: float) -> float:
    p = min(max(float(p), 1e-38), 1.0 - 1e-7)
    return float(np.clip(np.log(p) - np.log1p(-p), *LOGIT_RANGE))


def pass_streams(record_list):
    """((video name, box), [member arrays]) of every stream in a pass's
    batch records (names, boxes, frame counts, member widths, the fetched
    flat: each member's [rows, width] block in turn, rows in stream order)."""
    out = []
    for names, boxes, counts, widths, flat in record_list:
        streams = [(n, b, c // len(bs)) for n, bs, c in zip(names, boxes, counts)
                   if bs is not None for b in bs]
        if not streams:
            continue
        rows = flat.size // sum(widths)
        cursor, blocks = 0, []
        for w in widths:
            blocks.append(flat[cursor:cursor + rows * w].reshape(rows, w))
            cursor += rows * w
        at = 0
        for name, box, n in streams:
            out.append(((name, tuple(box)), [b[at:at + n] for b in blocks]))
            at += n
    return out


def judge(cfg: dict, exp: ref_query.Expected, names: List[str], passes: List[dict],
          head_norm: float) -> dict:
    """Readings over every pass: the numbers compared, the answers
    attempted and the answers that fail a limit. The gate's logit gaps are
    divided by `head_norm`, the norm of the video-score head's weight,
    which set-up scales to place the logits: the quotient is the gap of the
    VSM's pooled output along the head's direction, whatever the scale."""
    q = cfg["query"]
    lim = cfg["limits"]
    thr = q["score_threshold"]
    index = {n: i for i, n in enumerate(names)}
    member_names = [m["name"] for m in cfg["members"]]
    read = dict(ved_mean_gap=0.0, gate_flips=0, box_mismatch=0, dedup_mismatch=0,
                descriptor_gap=0.0)
    read.update({f"member_gap.{m}": 0.0 for m in member_names})
    attempted = failed = 0
    for p in passes:
        bad = set()
        flips = boxes_off = dedup_off = 0
        gated_ref = {n: exp.logits[index[n]] < _logit(thr) for n in names}
        gaps = [abs(_logit(p["scores"][n]) - float(np.clip(exp.logits[index[n]], *LOGIT_RANGE)))
                for n in names]
        mean_gap = float(np.mean(gaps)) / head_norm
        read["ved_mean_gap"] = max(read["ved_mean_gap"], mean_gap)
        if mean_gap > lim["ved_mean_gap"]:
            bad.update(names)
        for n in names:
            if (p["scores"][n] < thr) != gated_ref[n]:
                flips += 1
                bad.add(n)
        streams = p["streams"] if "streams" in p else [
            ((index[n], b), arrs) for (n, b), arrs in pass_streams(p["records"])]
        prog_boxes: Dict[int, list] = {}
        for (i, box), arrs in streams:
            prog_boxes.setdefault(i, []).append(tuple(box))
            key = (i, tuple(box))
            if key not in exp.members:
                continue
            for m, got, want in zip(member_names, arrs, exp.members[key]):
                rel = np.linalg.norm(got - want, axis=1) / np.maximum(
                    np.linalg.norm(want, axis=1), 1e-30)
                gap = float(rel.max()) if rel.size else 0.0
                read[f"member_gap.{m}"] = max(read[f"member_gap.{m}"], gap)
                if gap > lim[f"member_gap.{m}"]:
                    bad.add(names[i])
        for i, bs in prog_boxes.items():
            if not gated_ref[names[i]] and sorted(bs) != sorted(tuple(b) for b in exp.boxes[i]):
                boxes_off += 1
                bad.add(names[i])
        for n in names:
            i = index[n]
            ts, feats = p["outputs"][n]
            if gated_ref[n]:
                if p["scores"][n] < thr:
                    gap = float(np.abs(feats[:, -1] + 100.0).max())
                    read["descriptor_gap"] = max(read["descriptor_gap"], gap)
                    if len(feats) != 1 or gap > lim["descriptor_gap"]:
                        dedup_off += len(feats) != 1
                        bad.add(n)
                continue
            keys = [(i, tuple(b)) for b in exp.boxes[i]]
            ts = np.asarray(ts).reshape(-1)
            matched = []
            worst = 0.0
            for t, row in zip(ts, feats):
                cands = [(float(np.linalg.norm(row - exp.rows[k][int(t)])), k) for k in keys]
                gap, k = min(cands)
                worst = max(worst, gap)
                matched.append(exp.concat[k][int(t)])
            read["descriptor_gap"] = max(read["descriptor_gap"], worst)
            valid = len(feats) == exp.kept[i]
            if valid and len(matched) > 1:
                m = np.stack(matched)
                m = m / np.linalg.norm(m, axis=1, keepdims=True)
                sim = m @ m.T - 2.0 * np.eye(len(m))
                valid = float(sim.max()) <= q["frame_threshold"]
            if not valid:
                dedup_off += 1
                bad.add(n)
            if worst > lim["descriptor_gap"]:
                bad.add(n)
        read["gate_flips"] = max(read["gate_flips"], flips)
        read["box_mismatch"] = max(read["box_mismatch"], boxes_off)
        read["dedup_mismatch"] = max(read["dedup_mismatch"], dedup_off)
        attempted += len(names)
        failed += len(bad)
    return dict(readings=read, attempted=attempted, failed=failed)


TASK = QueryEnsemble
