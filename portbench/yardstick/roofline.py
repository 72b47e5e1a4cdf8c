"""The least time the card could take, and the models' operation counts.

Peaks are one NVIDIA H100 SXM's published dense rates at its full 700 W.
A kernel call's bound is max(operations / peak of the operands' type,
bytes / HBM bandwidth), each input read once and each output written once
(`work_*`, from the call's shapes). The forward FLOP counters give a
model's multiply-add work per image or per video (2 per MAC).
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bf16": 2, "f16": 2, "f32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds the card needs at least for `flops` operations of `dtype`
    operands and `nbytes` moved."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def work_mlp(m: int, c: int, hidden: int, isz: int, ln: bool = True):
    """K2 (LN + fc1 + act + fc2 + residual) / B7: two products; x, W1, W2
    in, out; biases and LN params f32."""
    return 4 * m * c * hidden, (2 * m * c + 2 * c * hidden) * isz + 4 * (hidden + c * (3 if ln else 1))


def work_swin_block(w: int, n: int, c: int, h: int, f: int, nw: int, isz: int):
    """B1: QKV, proj, fc1, fc2 and the window attention core; x in, out;
    the weights; the f32 vectors, the bias table and (shifted) the mask."""
    m = w * n
    weights = 4 * c * c + 2 * c * f
    flops = 2 * m * weights + 4 * w * h * n * n * (c // h)
    mask = nw * n * n if nw > 1 else 0
    return flops, (2 * m * c + weights) * isz + 4 * (9 * c + f + h * n * n + h + mask)


def _block_flops(l: int, c: int, hidden: int, attn_tokens: int) -> int:
    """One transformer block over l tokens: QKV, q k^T and P v over
    `attn_tokens` keys, proj, the two MLP products."""
    return 2 * l * c * 3 * c + 4 * l * attn_tokens * c + 2 * l * c * c + 4 * l * c * hidden


def vit_forward_flops(d: dict) -> int:
    """One ViT descriptor image: patch embedding, the blocks, the 1x1
    projection of every token and the head."""
    c, p = d["embed_dim"], (d["img_size"] // d["patch_size"]) ** 2
    l = p + 1
    hidden = int(c * d["mlp_ratio"])
    return (2 * p * 3 * d["patch_size"] ** 2 * c + d["depth"] * _block_flops(l, c, hidden, l)
            + 2 * l * c * d["head_dim"] + 2 * d["head_dim"] * d["out_dim"])


def swin_forward_flops(d: dict) -> int:
    """One SwinV2 image: patch embedding, the blocks (attention within each
    window of N tokens), the patch merges and the head (the CPB MLPs,
    ~0.1%, left out)."""
    res = d["img_size"] // d["patch_size"]
    total = 2 * res * res * 3 * d["patch_size"] ** 2 * d["embed_dim"]
    depths = d["depths"]
    for s, depth in enumerate(depths):
        c, r = d["embed_dim"] * 2 ** s, res // 2 ** s
        n = min(d["window_size"], r) ** 2
        total += depth * _block_flops(r * r, c, int(c * d["mlp_ratio"]), n)
        if s < len(depths) - 1:
            total += 2 * (r * r // 4) * 4 * c * 2 * c
    return total + 2 * d["embed_dim"] * 2 ** (len(depths) - 1) * d["output_dim"]


def clip_forward_flops(d: dict) -> int:
    """One CLIP visual-tower image (patch conv, the blocks)."""
    c, p = d["width"], (d["img_size"] // d["patch_size"]) ** 2
    l = p + 1
    return 2 * p * 3 * d["patch_size"] ** 2 * c + d["layers"] * _block_flops(l, c, 4 * c, l)


def vsm_forward_flops(d: dict) -> int:
    """One video through the video-score model at its padded length
    (max_frames + 2 tokens): the frame projection, the blocks, the head."""
    h, l = d["hidden"], d["max_frames"] + 2
    return (2 * d["max_frames"] * d["feat_dim"] * h + d["layers"] * _block_flops(l, h, 4 * h, l)
            + 2 * 2 * h)


FORWARD_FLOPS = {"vit": vit_forward_flops, "swinv2": swin_forward_flops,
                 "clip": clip_forward_flops, "vsm": vsm_forward_flops}
