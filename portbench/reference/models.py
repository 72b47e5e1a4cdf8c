"""The configurations' models as plain PyTorch functions of a weight dict.

Each function takes `P`, a dict of float32 tensors keyed by parameter name
(the names under which the benchmark draws the weights), the architecture's
sizes from the configuration file, NHWC float32 images and a `Numerics`.
Written from the published descriptions:

- ViT-B/32 descriptor (v68): pre-LN ViT (LN eps 1e-6, exact GELU), all
  tokens through a 1x1 projection to 2048, GeM (p 3) over the tokens, a
  Linear head;
- CLIP ViT-L/14 visual tower: patch conv without bias, class embedding,
  learned positions, ln_pre, pre-LN blocks with QuickGELU (LN eps 1e-5),
  ln_post of the CLS token;
- the VSC22 video-score model (VSM): CLIP CLS frame features -> Linear +
  LN -> [CLS] frames [SEP] + positions -> LN -> post-LN BERT layers (LN eps
  1e-12, exact GELU, -1e4 on masked keys) -> concat(CLS state, masked mean)
  -> Linear -> one logit. The mask is [1, 1, frame_mask], laid over the
  tokens [CLS, frames, SEP] as the submission lays it;
- SwinV2 descriptor (v106/v107/v115): res-post-norm blocks with cosine
  window attention, the log-spaced CPB MLP (16 sigmoid), the exp-clamped
  logit scale, q/v biases only, shifted windows (-100 across seams),
  v2 patch merging, final LN, GeM (p 3), a Linear head.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.nn import (
    Numerics,
    attention,
    gelu,
    gem,
    layer_norm,
    patch_embed,
    quick_gelu,
)


def _ln(P, name, x, eps):
    return layer_norm(x, P[name + ".weight"], P[name + ".bias"], eps)


def _lin(nx, P, name, x, bias=True):
    return nx.linear(x, P[name + ".weight"], P[name + ".bias"] if bias else None)


# --- ViT descriptor -----------------------------------------------------------


def vit_block(nx: Numerics, P, pre: str, x, heads: int):
    y = _ln(P, pre + "norm1", x, 1e-6)
    x = x + attention(nx, y, P[pre + "attn.qkv.weight"], P[pre + "attn.qkv.bias"],
                      P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"], heads)
    y = _ln(P, pre + "norm2", x, 1e-6)
    return x + _lin(nx, P, pre + "mlp.fc2", gelu(_lin(nx, P, pre + "mlp.fc1", y)))


def vit_descriptor(nx: Numerics, P, dims: dict, images, block_fn=None, head: bool = True):
    """[B, S, S, 3] -> [B, out_dim] (`head=False`: the head's input). `block_fn(fn, x)`, where
    given, runs each block (the trainer's reference checkpoints them)."""
    n = images.shape[0]
    c = dims["embed_dim"]
    x = patch_embed(nx, images, P["backbone.patch_embed.weight"],
                    P["backbone.patch_embed.bias"], dims["patch_size"])
    x = torch.cat([P["backbone.cls_token"].expand(n, 1, c), x], dim=1) + P["backbone.pos_embed"]
    for i in range(dims["depth"]):
        fn = lambda t, i=i: vit_block(nx, P, f"backbone.blocks.{i}.", t, dims["num_heads"])
        x = fn(x) if block_fn is None else block_fn(fn, x)
    x = gem(_lin(nx, P, "gem.proj", _ln(P, "backbone.norm", x, 1e-6)), dims["pool_param"])
    return _lin(nx, P, "head", x) if head else x


# --- CLIP visual tower --------------------------------------------------------


def clip_cls(nx: Numerics, P, dims: dict, images):
    """[B, S, S, 3] -> [B, width] CLS features after ln_post."""
    n = images.shape[0]
    w = dims["width"]
    x = patch_embed(nx, images, P["conv1.weight"], None, dims["patch_size"])
    x = torch.cat([P["class_embedding"].expand(n, 1, w), x], dim=1) + P["positional_embedding"]
    x = _ln(P, "ln_pre", x, 1e-5)
    for i in range(dims["layers"]):
        pre = f"blocks.{i}."
        y = _ln(P, pre + "ln_1", x, 1e-5)
        x = x + attention(nx, y, P[pre + "attn.qkv.weight"], P[pre + "attn.qkv.bias"],
                          P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"], dims["heads"])
        y = _ln(P, pre + "ln_2", x, 1e-5)
        x = x + _lin(nx, P, pre + "c_proj", quick_gelu(_lin(nx, P, pre + "c_fc", y)))
    return _ln(P, "ln_post", x[:, 0], 1e-5)


# --- video-score model --------------------------------------------------------


def vsm_pooled(nx: Numerics, P, dims: dict, feats):
    """[V, max_frames, feat_dim] CLS features (zero rows: no frame) ->
    [V, 2 hidden], the input of the output projection."""
    v, n, _ = feats.shape
    hid = dims["hidden"]
    vision = _ln(P, "frame_norm", _lin(nx, P, "frame_proj", feats), 1e-5)
    frame_mask = (feats.abs().sum(dim=2) > 0).float()
    tokens = torch.cat([P["cls_emb"].expand(v, 1, hid), vision, P["sep_emb"].expand(v, 1, hid)],
                       dim=1)
    mask = torch.cat([torch.ones(v, 2, device=feats.device), frame_mask], dim=1)
    x = _ln(P, "emb_norm", tokens + P["pos_embed"][: n + 2], 1e-12)
    bias = (1.0 - mask)[:, None, None, :] * -10000.0
    for i in range(dims["layers"]):
        pre = f"layers.{i}."
        a = attention(nx, x, P[pre + "attn.qkv.weight"], P[pre + "attn.qkv.bias"],
                      P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"], dims["heads"], bias)
        x = _ln(P, pre + "ln_attn", x + a, 1e-12)
        y = _lin(nx, P, pre + "fc2", gelu(_lin(nx, P, pre + "fc1", x)))
        x = _ln(P, pre + "ln_mlp", x + y, 1e-12)
    weights = mask[..., None]
    avg = (x * weights).sum(dim=1) / (weights.sum(dim=1) + 1e-5)
    return torch.cat([x[:, 0], avg], dim=1)


def vsm_logits(nx: Numerics, P, dims: dict, feats):
    return _lin(nx, P, "output_proj", vsm_pooled(nx, P, dims, feats)).squeeze(-1)


# --- SwinV2 descriptor --------------------------------------------------------


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def relative_coords_table(wh: int, ww: int, pretrained: int) -> np.ndarray:
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1)[None]
    table[..., 0] /= max((pretrained - 1) if pretrained > 0 else (wh - 1), 1)
    table[..., 1] /= max((pretrained - 1) if pretrained > 0 else (ww - 1), 1)
    table *= 8.0
    return (np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)).astype(np.float32)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, window * window)
    return np.where(mw[:, None, :] - mw[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def _partition(x, window: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _reverse(win, window: int, h: int, w: int):
    c = win.shape[-1]
    b = win.shape[0] // ((h // window) * (w // window))
    x = win.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def swin_block(nx: Numerics, P, pre: str, x, res: int, heads: int, window: int, shift: int,
               pretrained: int):
    b, l, c = x.shape
    dev = x.device
    if res <= window:
        window, shift = res, 0
    n = window * window
    hd = c // heads
    xs = x.reshape(b, res, res, c)
    if shift:
        xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
    win = _partition(xs, window)
    zeros = torch.zeros_like(P[pre + "attn.q_bias"])
    qkv_b = torch.cat([P[pre + "attn.q_bias"], zeros, P[pre + "attn.v_bias"]])
    qkv = nx.linear(win, P[pre + "attn.qkv_weight"], qkv_b)
    q, k, v = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [W, H, N, hd]
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    table = torch.from_numpy(relative_coords_table(window, window, pretrained)).to(dev)
    hidden = torch.relu(table @ P[pre + "attn.cpb_fc1.weight"].t() + P[pre + "attn.cpb_fc1.bias"])
    cpb = (hidden @ P[pre + "attn.cpb_fc2.weight"].t()).reshape(-1, heads)
    index = torch.from_numpy(relative_position_index(window, window).reshape(-1)).to(dev)
    rpb = 16.0 * torch.sigmoid(cpb[index].reshape(n, n, heads).permute(2, 0, 1))
    scale = torch.exp(torch.clamp(P[pre + "attn.logit_scale"], max=math.log(100.0))).reshape(-1)
    mask = (shift_attn_mask(res, res, window, shift) if shift
            else np.zeros((1, n, n), np.float32))
    mask = torch.from_numpy(mask).to(dev)
    logits = nx.einsum("whnd,whmd->whnm", q, k) * scale.reshape(1, -1, 1, 1) + rpb[None]
    logits = logits + mask[torch.arange(win.shape[0], device=dev) % mask.shape[0]][:, None]
    out = nx.einsum("whnm,whmd->whnd", torch.softmax(logits, dim=-1), v)
    out = _lin(nx, P, pre + "attn.proj", out.permute(0, 2, 1, 3).reshape(-1, n, c))
    xs = _reverse(out, window, res, res)
    if shift:
        xs = torch.roll(xs, shifts=(shift, shift), dims=(1, 2))
    x = x + _ln(P, pre + "norm1", xs.reshape(b, l, c), 1e-6)
    y = _lin(nx, P, pre + "mlp.fc2", gelu(_lin(nx, P, pre + "mlp.fc1", x)))
    return x + _ln(P, pre + "norm2", y, 1e-6)


def swinv2_descriptor(nx: Numerics, P, dims: dict, images, head: bool = True):
    """[B, S, S, 3] -> [B, output_dim] (`head=False`: the head's input)."""
    x = patch_embed(nx, images, P["patch_embed.weight"], P["patch_embed.bias"], dims["patch_size"])
    x = _ln(P, "patch_norm", x, 1e-6)
    res = dims["img_size"] // dims["patch_size"]
    depths = dims["depths"]
    for s, depth in enumerate(depths):
        r = res // 2 ** s
        for i in range(depth):
            shift = 0 if i % 2 == 0 else dims["window_size"] // 2
            x = swin_block(nx, P, f"stages.{s}.{i}.", x, r, dims["num_heads"][s],
                           dims["window_size"], shift, dims["pretrained_window_sizes"][s])
        if s < len(depths) - 1:
            b, _, c = x.shape
            xs = x.reshape(b, r, r, c)
            parts = [xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]]
            x = torch.cat(parts, dim=-1).reshape(b, (r // 2) ** 2, 4 * c)
            x = _ln(P, f"merges.{s}.norm", _lin(nx, P, f"merges.{s}.reduction", x, bias=False),
                    1e-6)
    x = gem(_ln(P, "norm", x, 1e-6), dims["pool_param"])
    return _lin(nx, P, "output_proj", x) if head else x


DESCRIPTORS = {"vit": vit_descriptor, "swinv2": swinv2_descriptor}
HEADS = {"vit": "head", "swinv2": "output_proj"}  # each descriptor's head, by parameter prefix
