"""Reference checkpoints into the port's modules, without JAX.

Counterpart of `vsc22_tpu/utils/port_weights.py`, function for function:
the same key remaps of the reference's layouts (timm's AugReg npz, timm
and SSCD ViT state dicts, the official SwinV2, OpenAI CLIP, the BERT video
score model, timm MobileNetV3 and HRNet, and `torch.jit` archives of any
of them), the same prefixes stripped, the same `KeyError` and
`ValueError`. Where a JAX `port_*` fills a copy of a Flax template, its
twin here takes a port module and fills it in place (and returns it).

The JAX functions write each value under its Flax key and in the Flax
layout (Dense kernels [in, out], HWIO convolutions). So do these: each
port module's key table in `utils/jax_params.py` (the one name map that
the snapshots use too) names the JAX leaf of every tensor and the layout
between them. `put` checks a value against the leaf's JAX shape, as JAX
checks it against the template's, and the values are copied into the
module only once every one has been checked, each cast to its tensor's
dtype (as JAX casts to the template's). A leaf that the checkpoint does
not hold keeps its value (the descriptor's GeM and head under an AugReg
npz, HRNet's fuse head under timm's keys).

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from vsc22_tpu_torch.models.clip import CLIPVisual
from vsc22_tpu_torch.models.hrnet import SAMHRNet
from vsc22_tpu_torch.models.mobilenetv3 import MNV3_SMALL_SPEC, MobileNetV3Small
from vsc22_tpu_torch.models.swinv2 import SwinTransformerV2
from vsc22_tpu_torch.models.vit import VisionTransformer, VitDescriptor
from vsc22_tpu_torch.models.vsm import VideoScoreModel
from vsc22_tpu_torch.utils import jax_params


def _interp_pos_embed(pos: np.ndarray, target_tokens: int) -> np.ndarray:
    """Bilinear-resize the patch grid of a [1, 1+P, C] positional embedding.

    `jax.image.resize(..., "bilinear")` antialiases when it shrinks (its
    triangle kernel widens by the scale); `F.interpolate` with
    `antialias=True` does the same, and agrees with it to f32 rounding
    both ways (`tests/test_torch_port_weights.py`)."""
    if pos.shape[1] == target_tokens:
        return pos
    cls_tok, grid = pos[:, :1], pos[:, 1:]
    src = int(np.sqrt(grid.shape[1]))
    dst = int(np.sqrt(target_tokens - 1))
    g = torch.from_numpy(np.ascontiguousarray(grid, np.float32)).reshape(1, src, src, -1)
    g = F.interpolate(g.permute(0, 3, 1, 2), size=(dst, dst), mode="bilinear",
                      align_corners=False, antialias=True)
    return np.concatenate([cls_tok, g.permute(0, 2, 3, 1).reshape(1, dst * dst, -1).numpy()],
                          axis=1)


def _numpy(v) -> np.ndarray:
    """A state-dict value as numpy: a torch tensor detached and on the
    host (bfloat16, which numpy lacks, widened to float32, exactly), or an
    array as it is."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _strip(state_dict: Mapping, prefixes: tuple) -> Dict[str, np.ndarray]:
    """The state dict as numpy, each key without the first of `prefixes`
    that it starts with."""
    sd = {}
    for k, v in state_dict.items():
        for prefix in prefixes:
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        sd[k] = _numpy(v)
    return sd


class _Leaves:
    """The JAX leaves of a port module, from its `jax_params` key table:
    `put` checks a value in the JAX layout and holds it, `write` copies
    every held value into its tensor."""

    def __init__(self, entries, source: str = "torch"):
        self.leaves = {key: (t, layout) for key, t, layout in entries}
        self.source = source
        self.held: dict = {}

    def shape(self, key) -> tuple:
        """The shape of the leaf `key` in the JAX layout."""
        t, layout = self.leaves[key]
        return jax_params._TO_JAX[layout](np.broadcast_to(np.float32(0), tuple(t.shape))).shape

    def put(self, key, value) -> None:
        if key not in self.leaves:
            raise KeyError(f"template missing {key}")
        value = np.asarray(value)
        if self.shape(key) != value.shape:
            raise ValueError(f"{key}: {self.source} {value.shape} != template {self.shape(key)}")
        self.held[key] = value

    @torch.no_grad()
    def write(self) -> None:
        for key, value in self.held.items():
            t, layout = self.leaves[key]
            port = np.ascontiguousarray(jax_params._TO_PORT[layout](value))
            t.copy_(torch.from_numpy(port).to(t.dtype))


def port_vit_augreg_npz(npz: Mapping[str, np.ndarray], model):
    """Fill a `VitDescriptor`'s backbone, or a bare `VisionTransformer`,
    from an AugReg npz (fused QKV assembled, the position embedding
    resized where the grids differ). A descriptor's GeM and head, absent
    from the npz, keep their values."""
    if isinstance(model, VitDescriptor):
        leaves, prefix = _Leaves(jax_params.vit_entries(model), "npz"), ("params", "backbone")
    elif isinstance(model, VisionTransformer):
        leaves, prefix = _Leaves(jax_params.vit_backbone_entries(model), "npz"), ("params",)
    else:
        raise TypeError(f"an AugReg npz fills a ViT, not a {type(model).__name__}")

    def get(name):
        return np.asarray(npz[name])

    def put(key, value):
        leaves.put(prefix + key, value)

    put(("patch_embed", "kernel"), get("embedding/kernel"))
    put(("patch_embed", "bias"), get("embedding/bias"))
    put(("cls_token",), get("cls").reshape(leaves.shape(prefix + ("cls_token",))))
    pos = get("Transformer/posembed_input/pos_embedding")
    target = leaves.shape(prefix + ("pos_embed",))[1]
    put(("pos_embed",), _interp_pos_embed(pos, target))

    depth = 0
    while f"Transformer/encoderblock_{depth}/LayerNorm_0/scale" in npz:
        depth += 1
    for i in range(depth):
        b = f"Transformer/encoderblock_{i}"
        blk = (f"block{i}",)
        put(blk + ("norm1", "scale"), get(f"{b}/LayerNorm_0/scale"))
        put(blk + ("norm1", "bias"), get(f"{b}/LayerNorm_0/bias"))
        put(blk + ("norm2", "scale"), get(f"{b}/LayerNorm_2/scale"))
        put(blk + ("norm2", "bias"), get(f"{b}/LayerNorm_2/bias"))
        att = f"{b}/MultiHeadDotProductAttention_1"
        c = leaves.shape(prefix + blk + ("attn", "qkv", "kernel"))[0]
        qkv_k = np.concatenate(
            [get(f"{att}/{n}/kernel").reshape(c, c) for n in ("query", "key", "value")],
            axis=1,
        )
        qkv_b = np.concatenate(
            [get(f"{att}/{n}/bias").reshape(c) for n in ("query", "key", "value")]
        )
        put(blk + ("attn", "qkv", "kernel"), qkv_k)
        put(blk + ("attn", "qkv", "bias"), qkv_b)
        put(blk + ("attn", "proj", "kernel"), get(f"{att}/out/kernel").reshape(c, c))
        put(blk + ("attn", "proj", "bias"), get(f"{att}/out/bias"))
        mlp = f"{b}/MlpBlock_3"
        put(blk + ("mlp", "fc1_kernel"), get(f"{mlp}/Dense_0/kernel"))
        put(blk + ("mlp", "fc1_bias"), get(f"{mlp}/Dense_0/bias"))
        put(blk + ("mlp", "fc2_kernel"), get(f"{mlp}/Dense_1/kernel"))
        put(blk + ("mlp", "fc2_bias"), get(f"{mlp}/Dense_1/bias"))

    put(("norm", "scale"), get("Transformer/encoder_norm/scale"))
    put(("norm", "bias"), get("Transformer/encoder_norm/bias"))
    leaves.write()
    return model


def load_torchscript_state_dict(path) -> Dict[str, np.ndarray]:
    """A `torch.jit` archive's parameters and buffers as a numpy state dict.

    The reference ships its trained members as `torch.jit.trace` archives
    of the bare (DDP-prefix-stripped) model (D1/train/train_v106/
    torch2scripts.py:672-699). Tracing keeps the modules' attribute paths,
    so the archive's `state_dict()` has the eager model's keys and feeds
    every `port_*` here unchanged:

        sd = load_torchscript_state_dict("swinv2_v106.torchscript.pt")
        port_swinv2_torch_state_dict(sd, model)
    """
    mod = torch.jit.load(str(path), map_location="cpu")
    return {k: _numpy(v) for k, v in mod.state_dict().items()}


def _dense_writers(leaves: _Leaves, sd: dict, root=("params",)):
    """`linear(dst, src)` (a torch Linear's weight transposed, and its
    bias where the state dict has one) and `norm(dst, src)` (a LayerNorm's
    weight and bias as scale and bias), both under `root`."""

    def linear(dst, src):
        leaves.put(root + dst + ("kernel",), sd[f"{src}.weight"].T)
        if f"{src}.bias" in sd:
            leaves.put(root + dst + ("bias",), sd[f"{src}.bias"])

    def norm(dst, src):
        leaves.put(root + dst + ("scale",), sd[f"{src}.weight"])
        leaves.put(root + dst + ("bias",), sd[f"{src}.bias"])

    return linear, norm


def port_vit_torch_state_dict(state_dict: Mapping, model: VitDescriptor) -> VitDescriptor:
    """Fill a `VitDescriptor` from a torch SSCD/v68 state dict: timm ViT
    keys under `backbone.` and the SSCD head (`embeddings.0.conv`, the
    GeM's 1x1 projection; `embeddings.1`, the output Linear). A leading
    `module.backbone.model.`, `module.backbone.` or `model.` is stripped
    (the first that fits), as the reference strips its DDP prefix before
    tracing (torch2scripts.py:672-699)."""
    sd = _strip(state_dict, ("module.backbone.model.", "module.backbone.", "model."))
    leaves = _Leaves(jax_params.vit_entries(model))
    linear, norm = _dense_writers(leaves, sd)

    def put(key, value):
        leaves.put(("params",) + key, value)

    bb = ("backbone",)
    put(bb + ("patch_embed", "kernel"), sd["backbone.patch_embed.proj.weight"].transpose(2, 3, 1, 0))
    put(bb + ("patch_embed", "bias"), sd["backbone.patch_embed.proj.bias"])
    put(bb + ("cls_token",), sd["backbone.cls_token"])
    pos = sd["backbone.pos_embed"]
    target = leaves.shape(("params",) + bb + ("pos_embed",))[1]
    put(bb + ("pos_embed",), _interp_pos_embed(pos, target))

    i = 0
    while f"backbone.blocks.{i}.norm1.weight" in sd:
        t = f"backbone.blocks.{i}"
        blk = bb + (f"block{i}",)
        norm(blk + ("norm1",), f"{t}.norm1")
        norm(blk + ("norm2",), f"{t}.norm2")
        linear(blk + ("attn", "qkv"), f"{t}.attn.qkv")
        linear(blk + ("attn", "proj"), f"{t}.attn.proj")
        put(blk + ("mlp", "fc1_kernel"), sd[f"{t}.mlp.fc1.weight"].T)
        put(blk + ("mlp", "fc1_bias"), sd[f"{t}.mlp.fc1.bias"])
        put(blk + ("mlp", "fc2_kernel"), sd[f"{t}.mlp.fc2.weight"].T)
        put(blk + ("mlp", "fc2_bias"), sd[f"{t}.mlp.fc2.bias"])
        i += 1

    norm(bb + ("norm",), "backbone.norm")
    # SSCD head: Conv1d(k=1) == Dense over tokens; then the output Linear.
    put(("gem", "proj", "kernel"), sd["embeddings.0.conv.weight"][:, :, 0].T)
    put(("gem", "proj", "bias"), sd["embeddings.0.conv.bias"])
    linear(("head",), "embeddings.1")
    leaves.write()
    return model


def port_clip_torch_state_dict(state_dict: Mapping, model: CLIPVisual) -> CLIPVisual:
    """Fill a `CLIPVisual` from an OpenAI-CLIP visual-tower state dict
    (the reference's vendored tower, D1/train/train_vid_score/video/
    clip.py:85-163): `conv1.weight` (no bias), `class_embedding`,
    `positional_embedding`, `ln_pre`/`ln_post`, and per block
    `transformer.resblocks.{i}.{ln_1,ln_2,attn.in_proj_*,attn.out_proj,
    mlp.c_fc,mlp.c_proj}`. A leading `visual.` (a whole CLIP checkpoint)
    is stripped, as the reference's `revise_keys` does (clip.py:135); the
    projection, text tower and logit scale are not read. `in_proj_weight`
    [3C, C], rows q|k|v, transposed is the fused qkv kernel."""
    sd = _strip(state_dict, ("visual.",))
    leaves = _Leaves(jax_params.clip_entries(model))
    linear, norm = _dense_writers(leaves, sd)

    def put(key, value):
        leaves.put(("params",) + key, value)

    put(("conv1", "kernel"), sd["conv1.weight"].transpose(2, 3, 1, 0))
    put(("class_embedding",), sd["class_embedding"])
    put(("positional_embedding",), sd["positional_embedding"])
    norm(("ln_pre",), "ln_pre")

    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        t = f"transformer.resblocks.{i}"
        blk = (f"block{i}",)
        norm(blk + ("ln_1",), f"{t}.ln_1")
        norm(blk + ("ln_2",), f"{t}.ln_2")
        put(blk + ("attn", "qkv", "kernel"), sd[f"{t}.attn.in_proj_weight"].T)
        put(blk + ("attn", "qkv", "bias"), sd[f"{t}.attn.in_proj_bias"])
        linear(blk + ("attn", "proj"), f"{t}.attn.out_proj")
        linear(blk + ("c_fc",), f"{t}.mlp.c_fc")
        linear(blk + ("c_proj",), f"{t}.mlp.c_proj")
        i += 1

    norm(("ln_post",), "ln_post")
    leaves.write()
    return model


def port_vsm_torch_state_dict(state_dict: Mapping, model: VideoScoreModel) -> VideoScoreModel:
    """Fill a `VideoScoreModel` from the reference MS state dict (a HF BERT
    encoder, chinese-roberta-wwm-ext, with a frame projection and an
    output head; D1/train/train_vid_score/video/model.py:63-103):

      - `frame_proj.0` / `frame_proj.1` -> frame_proj and frame_norm;
      - `bert.embeddings.word_embeddings` rows 101/102 -> the [CLS]/[SEP]
        vectors (model.py:29 hardcodes token ids [101, 102]);
      - `bert.embeddings.position_embeddings` rows [0, max_frames + 2)
        plus `token_type_embeddings` row 0 (every token is type 0, so the
        fold is exact) -> pos_embed;
      - `bert.encoder.layer.{i}.attention.self.{query,key,value}`
        concatenated -> the fused qkv;
      - the pooler is not read (the reference uses last_hidden_state).

    A leading `module.` (DDP) is stripped."""
    sd = _strip(state_dict, ("module.",))
    leaves = _Leaves(jax_params.vsm_entries(model))
    linear, norm = _dense_writers(leaves, sd)

    def put(key, value):
        leaves.put(("params",) + key, value)

    linear(("frame_proj",), "frame_proj.0")
    norm(("frame_norm",), "frame_proj.1")

    word = sd["bert.embeddings.word_embeddings.weight"]
    put(("cls_emb",), word[101])
    put(("sep_emb",), word[102])
    n_pos = leaves.shape(("params", "pos_embed"))[0]
    pos = sd["bert.embeddings.position_embeddings.weight"][:n_pos]
    tok0 = sd["bert.embeddings.token_type_embeddings.weight"][0]
    put(("pos_embed",), pos + tok0[None, :])
    norm(("emb_norm",), "bert.embeddings.LayerNorm")

    i = 0
    while f"bert.encoder.layer.{i}.attention.self.query.weight" in sd:
        t = f"bert.encoder.layer.{i}"
        blk = (f"layer{i}",)
        qkv_k = np.concatenate(
            [sd[f"{t}.attention.self.{n}.weight"].T for n in ("query", "key", "value")],
            axis=1,
        )
        qkv_b = np.concatenate(
            [sd[f"{t}.attention.self.{n}.bias"] for n in ("query", "key", "value")]
        )
        put(blk + ("attn", "qkv", "kernel"), qkv_k)
        put(blk + ("attn", "qkv", "bias"), qkv_b)
        linear(blk + ("attn", "proj"), f"{t}.attention.output.dense")
        norm(blk + ("ln_attn",), f"{t}.attention.output.LayerNorm")
        linear(blk + ("fc1",), f"{t}.intermediate.dense")
        linear(blk + ("fc2",), f"{t}.output.dense")
        norm(blk + ("ln_mlp",), f"{t}.output.LayerNorm")
        i += 1

    linear(("output_proj",), "output_proj")
    leaves.write()
    return model


def _bn_port_helpers(state_dict, entries):
    """What the BatchNorm CNN ports (MobileNetV3, HRNet) share: (sd,
    leaves, put, conv, bn, finish): the state dict as numpy without a
    leading `module.`, the model's leaves, `put(collection, key, value)`,
    writers of a conv kernel (OIHW -> HWIO, or a 1x1 conv as a Dense
    kernel) and of a BN (weight and bias into `params`, the running
    statistics into `batch_stats`), and `finish`, which writes the leaves
    into the model."""
    sd = _strip(state_dict, ("module.",))
    leaves = _Leaves(entries)

    def put(coll, key, value):
        leaves.put((coll,) + key, value)

    def conv(dst, src, dense=False):
        w = sd[f"{src}.weight"]
        if dense:  # 1x1 conv consumed as a Dense layer
            put("params", dst + ("kernel",), w[:, :, 0, 0].T)
        else:
            put("params", dst + ("kernel",), w.transpose(2, 3, 1, 0))
        if f"{src}.bias" in sd:
            put("params", dst + ("bias",), sd[f"{src}.bias"])

    def bn(dst, src):
        put("params", dst + ("scale",), sd[f"{src}.weight"])
        put("params", dst + ("bias",), sd[f"{src}.bias"])
        put("batch_stats", dst + ("mean",), sd[f"{src}.running_mean"])
        put("batch_stats", dst + ("var",), sd[f"{src}.running_var"])

    return sd, leaves, put, conv, bn, leaves.write


def port_hrnet_torch_state_dict(state_dict: Mapping, model: SAMHRNet) -> SAMHRNet:
    """Fill a `SAMHRNet` from a timm `hrnet_w18` state dict or the M1 SAM
    wrapper checkpoint (M1/train/models.py:20-48):
      - raw timm keys (conv1/bn1, conv2/bn2, layer1.{b}.*,
        transition{1,2,3}.*, stage{2,3,4}.{m}.{branches,fuse_layers}.*)
        fill the backbone; the fuse head keeps its values (the reference
        fine-tunes a fresh head on ImageNet weights);
      - the wrapper's keys, a `model.` backbone prefix plus the
        `fuse.0`/`fuse.2` head convs, fill everything.

    Stages, modules and branches are found by probing the keys, so a tiny
    config ports through the same code as W18."""
    sd, leaves, put, conv, bn, finish = _bn_port_helpers(
        state_dict, jax_params.sam_hrnet_entries(model))

    for k in list(sd):
        if k.startswith("model."):
            sd[k[len("model."):]] = sd.pop(k)

    def cbn(dst, conv_src, bn_src):
        conv(dst + ("Conv_0",), conv_src)
        bn(dst + ("BatchNorm_0",), bn_src)

    B = ("backbone",)
    cbn(B + ("stem1",), "conv1", "bn1")
    cbn(B + ("stem2",), "conv2", "bn2")

    b = 0
    while f"layer1.{b}.conv1.weight" in sd:
        t, blk = f"layer1.{b}", B + (f"layer1_{b}",)
        for n in (1, 2, 3):
            cbn(blk + (f"conv{n}",), f"{t}.conv{n}", f"{t}.bn{n}")
        if f"{t}.downsample.0.weight" in sd:
            cbn(blk + ("downsample",), f"{t}.downsample.0", f"{t}.downsample.1")
        b += 1

    cbn(B + ("trans1_0",), "transition1.0.0", "transition1.0.1")
    cbn(B + ("trans1_1",), "transition1.1.0.0", "transition1.1.0.1")
    cbn(B + ("trans2",), "transition2.2.0.0", "transition2.2.0.1")
    cbn(B + ("trans3",), "transition3.3.0.0", "transition3.3.0.1")

    for s in (2, 3, 4):
        m = 0
        while f"stage{s}.{m}.branches.0.0.conv1.weight" in sd:
            t, mod = f"stage{s}.{m}", B + (f"stage{s}_m{m}",)
            i = 0
            while f"{t}.branches.{i}.0.conv1.weight" in sd:
                j = 0
                while f"{t}.branches.{i}.{j}.conv1.weight" in sd:
                    dst = mod + (f"branch{i}_block{j}",)
                    src = f"{t}.branches.{i}.{j}"
                    cbn(dst + ("conv1",), f"{src}.conv1", f"{src}.bn1")
                    cbn(dst + ("conv2",), f"{src}.conv2", f"{src}.bn2")
                    j += 1
                i += 1
            for fi in range(i):
                for fj in range(i):
                    if fj == fi:
                        continue
                    f = f"{t}.fuse_layers.{fi}.{fj}"
                    if fj > fi:
                        cbn(mod + (f"fuse{fi}_{fj}",), f"{f}.0", f"{f}.1")
                    else:
                        for k in range(fi - fj):
                            cbn(mod + (f"fuse{fi}_{fj}_step{k}",), f"{f}.{k}.0", f"{f}.{k}.1")
            m += 1

    if "fuse.0.weight" in sd:
        conv(("fuse1",), "fuse.0")
        conv(("fuse2",), "fuse.2")
    finish()
    return model


def port_mnv3_torch_state_dict(state_dict: Mapping,
                               model: MobileNetV3Small) -> MobileNetV3Small:
    """Fill a `MobileNetV3Small` from a timm `mobilenetv3_small_100` state
    dict (the matching track's ClassifyModel backbone, M1/train/
    models.py:6-16). timm's flat block indices map onto stages
    [1, 2, 3, 2, 3] and the 576-channel ConvBnAct stage; blocks.0.0 is a
    DepthwiseSeparableConv (conv_dw/bn1, se, conv_pw/bn2), the later
    blocks InvertedResiduals (conv_pw/bn1, conv_dw/bn2, [se],
    conv_pwl/bn3). conv_head, applied after the pool, is the pre_logits
    Linear."""
    sd, leaves, put, conv, bn, finish = _bn_port_helpers(
        state_dict, jax_params.mobilenetv3_entries(model))

    def se(dst, src):
        put("params", dst + ("fc1", "kernel"), sd[f"{src}.conv_reduce.weight"][:, :, 0, 0].T)
        put("params", dst + ("fc1", "bias"), sd[f"{src}.conv_reduce.bias"])
        put("params", dst + ("fc2", "kernel"), sd[f"{src}.conv_expand.weight"][:, :, 0, 0].T)
        put("params", dst + ("fc2", "bias"), sd[f"{src}.conv_expand.bias"])

    conv(("stem", "Conv_0"), "conv_stem")
    bn(("stem", "BatchNorm_0"), "bn1")

    stages = (1, 2, 3, 2, 3)
    flat_idx = [(s, j) for s, n in enumerate(stages) for j in range(n)]
    for i, ((s, j), row) in enumerate(zip(flat_idx, MNV3_SMALL_SPEC)):
        t = f"blocks.{s}.{j}"
        blk = (f"block{i}",)
        _, _exp, _, se_rd, _, _ = row
        if i == 0:  # DepthwiseSeparableConv
            conv(blk + ("dw", "Conv_0"), f"{t}.conv_dw")
            bn(blk + ("dw", "BatchNorm_0"), f"{t}.bn1")
            se(blk + ("se",), f"{t}.se")
            conv(blk + ("project", "Conv_0"), f"{t}.conv_pw")
            bn(blk + ("project", "BatchNorm_0"), f"{t}.bn2")
        else:
            conv(blk + ("expand", "Conv_0"), f"{t}.conv_pw")
            bn(blk + ("expand", "BatchNorm_0"), f"{t}.bn1")
            conv(blk + ("dw", "Conv_0"), f"{t}.conv_dw")
            bn(blk + ("dw", "BatchNorm_0"), f"{t}.bn2")
            if se_rd:
                se(blk + ("se",), f"{t}.se")
            conv(blk + ("project", "Conv_0"), f"{t}.conv_pwl")
            bn(blk + ("project", "BatchNorm_0"), f"{t}.bn3")

    conv(("head_conv", "Conv_0"), "blocks.5.0.conv")
    bn(("head_conv", "BatchNorm_0"), "blocks.5.0.bn1")
    conv(("pre_logits",), "conv_head", dense=True)
    put("params", ("classifier", "kernel"), sd["classifier.weight"].T)
    put("params", ("classifier", "bias"), sd["classifier.bias"])
    finish()
    return model


def port_swinv2_torch_state_dict(state_dict: Mapping,
                                 model: SwinTransformerV2) -> SwinTransformerV2:
    """Fill a `SwinTransformerV2` from a torch SwinV2 state dict (the
    official Microsoft keys, which the reference vendors; no prefix is
    stripped):
      patch_embed.proj.{weight,bias}       -> patch_embed (OIHW)
      patch_embed.norm                     -> patch_norm
      layers.{s}.blocks.{i}.*              -> stage{s}_block{i}.*
        norm1/norm2, attn.logit_scale, attn.qkv.weight,
        attn.{q,v}_bias, attn.cpb_mlp.{0,2} -> cpb_fc1/cpb_fc2,
        attn.proj, mlp.fc1/fc2
      layers.{s}.downsample.{reduction,norm} -> merge{s}
      norm                                 -> norm
      output_proj                          -> output_proj
    The torch buffers (relative_position_index, relative_coords_table,
    attn_mask) are not read: the model computes them."""
    sd = {k: _numpy(v) for k, v in state_dict.items()}
    leaves = _Leaves(jax_params.swinv2_entries(model))
    linear, norm = _dense_writers(leaves, sd)

    def put(key, value):
        leaves.put(("params",) + key, value)

    put(("patch_embed", "kernel"), sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0))
    put(("patch_embed", "bias"), sd["patch_embed.proj.bias"])
    norm(("patch_norm",), "patch_embed.norm")

    stage = 0
    while f"layers.{stage}.blocks.0.norm1.weight" in sd:
        i = 0
        while f"layers.{stage}.blocks.{i}.norm1.weight" in sd:
            t = f"layers.{stage}.blocks.{i}"
            f = (f"stage{stage}_block{i}",)
            norm(f + ("norm1",), f"{t}.norm1")
            norm(f + ("norm2",), f"{t}.norm2")
            put(f + ("attn", "logit_scale"), sd[f"{t}.attn.logit_scale"])
            put(f + ("attn", "qkv_kernel"), sd[f"{t}.attn.qkv.weight"].T)
            put(f + ("attn", "q_bias"), sd[f"{t}.attn.q_bias"])
            put(f + ("attn", "v_bias"), sd[f"{t}.attn.v_bias"])
            linear(f + ("attn", "cpb_fc1"), f"{t}.attn.cpb_mlp.0")
            put(f + ("attn", "cpb_fc2", "kernel"), sd[f"{t}.attn.cpb_mlp.2.weight"].T)
            linear(f + ("attn", "proj"), f"{t}.attn.proj")
            put(f + ("mlp", "fc1_kernel"), sd[f"{t}.mlp.fc1.weight"].T)
            put(f + ("mlp", "fc1_bias"), sd[f"{t}.mlp.fc1.bias"])
            put(f + ("mlp", "fc2_kernel"), sd[f"{t}.mlp.fc2.weight"].T)
            put(f + ("mlp", "fc2_bias"), sd[f"{t}.mlp.fc2.bias"])
            i += 1
        if f"layers.{stage}.downsample.reduction.weight" in sd:
            put((f"merge{stage}", "reduction", "kernel"),
                sd[f"layers.{stage}.downsample.reduction.weight"].T)
            norm((f"merge{stage}", "norm"), f"layers.{stage}.downsample.norm")
        stage += 1

    norm(("norm",), "norm")
    linear(("output_proj",), "output_proj")
    leaves.write()
    return model
