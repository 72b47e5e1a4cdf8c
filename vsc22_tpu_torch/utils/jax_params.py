"""Carry JAX param trees into the port's modules.

The JAX package's variables (`model.init(...)`, or
`flax.serialization.to_state_dict`, fetched to the host as numpy) map onto
`VitDescriptor`, `SwinTransformerV2`, `CLIPVisual`, `VideoScoreModel` and
a lone `MultiHeadAttention`: Dense kernels
[in, out] are transposed to Linear [out, in], HWIO patch convs become
OIHW, and every array is copied into the existing parameter (which casts
it to that parameter's dtype and device). Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from vsc22_tpu_torch.models.clip import CLIPVisual
from vsc22_tpu_torch.models.layers import LayerNorm, Linear, MultiHeadAttention, PatchEmbed
from vsc22_tpu_torch.models.swinv2 import SwinTransformerV2
from vsc22_tpu_torch.models.vit import VitDescriptor
from vsc22_tpu_torch.models.vsm import VideoScoreModel


def _copy(dst: torch.Tensor, src) -> None:
    arr = torch.from_numpy(np.array(src, np.float32))
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(arr.shape)} does not fit parameter {tuple(dst.shape)}")
    dst.copy_(arr)


def _dense(mod: Linear, kernel, bias=None) -> None:
    _copy(mod.weight, np.asarray(kernel).T)
    if mod.bias is not None:
        _copy(mod.bias, bias)


def _dense_tree(mod: Linear, tree) -> None:
    if (mod.bias is None) != ("bias" not in tree):
        raise ValueError("a Dense bias on one side only")
    _dense(mod, tree["kernel"], tree.get("bias"))


def _ln(mod: LayerNorm, tree) -> None:
    _copy(mod.weight, tree["scale"])
    _copy(mod.bias, tree["bias"])


def _conv(mod: PatchEmbed, tree) -> None:
    _copy(mod.weight, np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    if mod.bias is not None:
        _copy(mod.bias, tree["bias"])


def _attention(mod, tree) -> None:
    """The {qkv, proj} Dense trees of a JAX `MultiHeadAttention` or
    `AttentionParams` (qkv without a bias where `qkv_bias=False`)."""
    _dense_tree(mod.qkv, tree["qkv"])
    _dense_tree(mod.proj, tree["proj"])


def _params(variables) -> dict:
    return variables["params"] if "params" in variables else variables


@torch.no_grad()
def load_vit_descriptor(model: VitDescriptor, variables) -> VitDescriptor:
    p = _params(variables)
    bb = p["backbone"]
    vit = model.backbone
    _conv(vit.patch_embed, bb["patch_embed"])
    _copy(vit.cls_token, bb["cls_token"])
    _copy(vit.pos_embed, bb["pos_embed"])
    for i, block in enumerate(vit.blocks):
        t = bb[f"block{i}"]
        _ln(block.norm1, t["norm1"])
        _attention(block.attn, t["attn"])
        _ln(block.norm2, t["norm2"])
        _dense(block.mlp.fc1, t["mlp"]["fc1_kernel"], t["mlp"]["fc1_bias"])
        _dense(block.mlp.fc2, t["mlp"]["fc2_kernel"], t["mlp"]["fc2_bias"])
    _ln(vit.norm, bb["norm"])
    _dense(model.gem.proj, p["gem"]["proj"]["kernel"], p["gem"]["proj"]["bias"])
    _dense(model.head, p["head"]["kernel"], p["head"]["bias"])
    return model


@torch.no_grad()
def load_swinv2_descriptor(model: SwinTransformerV2, variables) -> SwinTransformerV2:
    """The JAX `SwinTransformerV2` tree (either block path: both declare
    it) into the port's model."""
    p = _params(variables)
    _conv(model.patch_embed, p["patch_embed"])
    _ln(model.patch_norm, p["patch_norm"])
    for s, blocks in enumerate(model.stages):
        for i, block in enumerate(blocks):
            t = p[f"stage{s}_block{i}"]
            a, ta = block.attn, t["attn"]
            _copy(a.logit_scale, ta["logit_scale"])
            _copy(a.qkv_weight, np.asarray(ta["qkv_kernel"]).T)
            _copy(a.q_bias, ta["q_bias"])
            _copy(a.v_bias, ta["v_bias"])
            _dense_tree(a.cpb_fc1, ta["cpb_fc1"])
            _dense_tree(a.cpb_fc2, ta["cpb_fc2"])
            _dense_tree(a.proj, ta["proj"])
            _ln(block.norm1, t["norm1"])
            _dense(block.mlp.fc1, t["mlp"]["fc1_kernel"], t["mlp"]["fc1_bias"])
            _dense(block.mlp.fc2, t["mlp"]["fc2_kernel"], t["mlp"]["fc2_bias"])
            _ln(block.norm2, t["norm2"])
    for s, merge in enumerate(model.merges):
        _dense_tree(merge.reduction, p[f"merge{s}"]["reduction"])
        _ln(merge.norm, p[f"merge{s}"]["norm"])
    _ln(model.norm, p["norm"])
    _dense_tree(model.output_proj, p["output_proj"])
    return model


@torch.no_grad()
def load_clip_visual(model: CLIPVisual, variables) -> CLIPVisual:
    p = _params(variables)
    _conv(model.conv1, p["conv1"])
    _copy(model.class_embedding, p["class_embedding"])
    _copy(model.positional_embedding, p["positional_embedding"])
    _ln(model.ln_pre, p["ln_pre"])
    for i, block in enumerate(model.blocks):
        t = p[f"block{i}"]
        _ln(block.ln_1, t["ln_1"])
        _attention(block.attn, t["attn"])
        _ln(block.ln_2, t["ln_2"])
        _dense(block.c_fc, t["c_fc"]["kernel"], t["c_fc"]["bias"])
        _dense(block.c_proj, t["c_proj"]["kernel"], t["c_proj"]["bias"])
    _ln(model.ln_post, p["ln_post"])
    return model


@torch.no_grad()
def load_video_score_model(model: VideoScoreModel, variables) -> VideoScoreModel:
    p = _params(variables)
    _dense(model.frame_proj, p["frame_proj"]["kernel"], p["frame_proj"]["bias"])
    _ln(model.frame_norm, p["frame_norm"])
    _copy(model.cls_emb, p["cls_emb"])
    _copy(model.sep_emb, p["sep_emb"])
    _copy(model.pos_embed, p["pos_embed"])
    _ln(model.emb_norm, p["emb_norm"])
    for i, layer in enumerate(model.layers):
        t = p[f"layer{i}"]
        _attention(layer.attn, t["attn"])
        _ln(layer.ln_attn, t["ln_attn"])
        _dense(layer.fc1, t["fc1"]["kernel"], t["fc1"]["bias"])
        _dense(layer.fc2, t["fc2"]["kernel"], t["fc2"]["bias"])
        _ln(layer.ln_mlp, t["ln_mlp"])
    _dense(model.output_proj, p["output_proj"]["kernel"], p["output_proj"]["bias"])
    return model


@torch.no_grad()
def load_multi_head_attention(model: MultiHeadAttention, variables) -> MultiHeadAttention:
    """A JAX `MultiHeadAttention` tree, with or without its qkv bias."""
    _attention(model, _params(variables))
    return model
