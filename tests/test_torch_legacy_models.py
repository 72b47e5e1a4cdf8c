"""The port's legacy model zoo against the JAX package on the CPU: Swin v1,
EfficientNet (inference, and train mode with its updated `batch_stats`),
the MAE descriptor, the text encoder (ids with a mask and token types,
embeddings with the pooler), the DeConv decoder, the VSM's `MD` head
(`vsm_embed`), `random_masking` on JAX's noise, the layers they need
(`Mlp`, flax-`SAME` and biased `Conv`, `ConvTranspose`, `Embed`, nearest
2x upsampling), and the registry: every JAX name builds in the port, and
each full-width member's key table fits the JAX model's variables.

The variables are JAX's `model.init` trees made lively (random LN and BN
scales, nonzero biases and running statistics: `randomized_params`), so
that no block is an identity, carried across by `utils/jax_params`.
Tolerances: f32 outputs within 1e-4 absolute, BatchNorm running
statistics within 1e-6.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_swinv2 import randomized_params
from vsc22_tpu.models import deconv as jdeconv
from vsc22_tpu.models import efficientnet as jeff
from vsc22_tpu.models import layers as jlayers
from vsc22_tpu.models import mae as jmae
from vsc22_tpu.models import swin_v1 as jswin
from vsc22_tpu.models import text_encoder as jtext
from vsc22_tpu.models import vsm as jvsm
from vsc22_tpu.models.registry import BACKBONES as JAX_BACKBONES
from vsc22_tpu_torch.models import deconv, efficientnet, layers, mae, swin_v1, text_encoder, vsm
from vsc22_tpu_torch.models.registry import BACKBONES, build_backbone
from vsc22_tpu_torch.utils import jax_params

F32_TOL = 1e-4
BN_STATS_TOL = 1e-6


def lively(variables, seed: int) -> dict:
    """`randomized_params` of the params; running means N(0, 0.1^2) and
    variances in [0.5, 1.5] for any batch_stats."""
    variables = jax.device_get(variables)
    out = {"params": randomized_params(variables["params"], seed)}
    if "batch_stats" in variables:
        rng = np.random.default_rng(seed + 1)
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                             else 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
            variables["batch_stats"])
    return out


def init(jm, *args, **kwargs):
    """`jm.init` under jit (flax's eager init of a Swin dispatches
    thousands of small ops)."""
    return jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, **kwargs))(*args)


def apply(jm, variables, *args, **kwargs):
    return jax.jit(lambda v, *a: jm.apply(v, *a, **kwargs))(variables, *args)


def inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, tol=F32_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# --- layers ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,k,stride,groups", [(8, 3, 2, 1), (7, 3, 2, 1), (8, 3, 1, 1),
                                                   (9, 5, 2, 1), (8, 3, 2, 4), (6, 1, 1, 1)])
def test_conv_same_and_bias_match_flax(size, k, stride, groups):
    """flax `SAME` pads (0, 1) at k 3 / stride 2 on an even input; the
    port's pad "same" does the same, and adds the bias as flax does."""
    x = inputs((2, size, size, 8))
    jc = fnn.Conv(12, (k, k), strides=(stride, stride), padding="SAME",
                  feature_group_count=groups)
    v = lively(jc.init(jax.random.PRNGKey(0), x), 1)
    conv = layers.Conv(8, 12, k, stride, "same", groups, bias=True)
    jax_params.load_entries(jax_params._e_conv(("params",), conv), v)
    close(conv(torch.from_numpy(x)), jc.apply(v, x))
    assert layers.same_pads(8, 3, 2) == (0, 1) and layers.same_pads(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("size", [1, 4, 5])
def test_conv_transpose_matches_flax(size):
    """flax `nn.ConvTranspose(k 4, s 2, SAME)` (unflipped kernel) equals
    `conv_transpose2d(padding=1)` on the kernel flipped in space."""
    x = inputs((2, size, size, 6))
    jc = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME")
    v = lively(jc.init(jax.random.PRNGKey(0), x), 2)
    conv = layers.ConvTranspose(6, 5)
    jax_params.load_entries(jax_params._e_conv_t(("params",), conv), v)
    got = conv(torch.from_numpy(x))
    assert got.shape == (2, 2 * size, 2 * size, 5)
    close(got, jc.apply(v, x))


def test_upsample_and_embed_match_jax():
    x = inputs((2, 3, 5, 4))
    want = jax.image.resize(x, (2, 6, 10, 4), method="nearest")
    np.testing.assert_array_equal(layers.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))
    je = fnn.Embed(11, 6)
    ids = np.random.default_rng(0).integers(0, 11, (3, 7))
    v = jax.device_get(je.init(jax.random.PRNGKey(0), ids))
    emb = layers.Embed(11, 6)
    jax_params.load_entries([(("params", "embedding"), emb.weight, "id")], v)
    np.testing.assert_array_equal(emb(torch.from_numpy(ids)).detach().numpy(),
                                  np.asarray(je.apply(v, ids)))


@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_mlp_matches_jax(path):
    """`layers.Mlp` against the JAX `layers.Mlp`: B7's plain version (no
    dropout acting) and the plain path (a DropRng at rate 1e-9: every mask
    keeps, x / keep rounds to x)."""
    x = inputs((3, 5, 16))
    jm = jlayers.Mlp(48, 16)
    v = lively(init(jm, x), 3)
    mlp = layers.Mlp(16, 48, dropout=1e-9 if path == "plain" else 0.0)
    jax_params.load_entries(jax_params._e_mlp(("params",), mlp), v)
    rng = layers.DropRng(torch.Generator().manual_seed(0)) if path == "plain" else None
    close(mlp(torch.from_numpy(x), rng), jm.apply(v, x))


# --- models -----------------------------------------------------------------------------

SWIN_CASES = {
    "tiny_test": jswin.SWIN_V1_TINY_TEST,
    # stage 0 at 16^2 and stage 1 at 8^2, both with shifted, masked
    # windows, and the absolute position embedding
    "shifted_ape": dataclasses.replace(jswin.SWIN_V1_TINY_TEST, img_size=64, depths=(2, 2),
                                       ape=True),
}


@pytest.mark.parametrize("case", list(SWIN_CASES))
def test_swin_v1_matches_jax(case):
    cfg = SWIN_CASES[case]
    x = inputs((2, cfg.img_size, cfg.img_size, 3))
    jm = jswin.SwinTransformerV1(cfg=cfg)
    v = lively(init(jm, x), 4)
    port_cfg = swin_v1.SwinV1Config(**dataclasses.asdict(cfg))
    model = jax_params.load_swin_v1(swin_v1.SwinTransformerV1(port_cfg), v)
    blocks = [b for s in model.stages for b in s]
    assert [b.shift for b in blocks] == ([0, 0, 0] if case == "tiny_test" else [0, 2, 0, 2])
    with torch.no_grad():
        close(model(torch.from_numpy(x)), apply(jm, v, x))


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_efficientnet_tiny_matches_jax(train):
    x = inputs((4, 32, 32, 3))
    jm = jeff.efficientnet_tiny_test()
    v = lively(init(jm, x), 5)
    model = jax_params.load_efficientnet(efficientnet.efficientnet_tiny_test(), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    if not train:
        close(got, apply(jm, v, x))
        return
    want, mutated = apply(jm, v, x, train=True, mutable=["batch_stats"])
    close(got, want)
    stats = [(k, t) for k, t, _ in jax_params.efficientnet_entries(model)
             if k[0] == "batch_stats"]
    assert len(stats) == 2 * 7  # mean and var: the stem's BN, the blocks' five, the head's
    mutated = jax.device_get(mutated)
    for key, tensor in stats:
        close(tensor, jax_params._leaf(mutated, key), BN_STATS_TOL)
    assert not np.allclose(model.stem_bn.mean.numpy(), v["batch_stats"]["stem_bn"]["mean"])


def test_mae_tiny_matches_jax():
    x = inputs((2, 32, 32, 3))
    jm = jmae.mae_tiny_test()
    v = lively(init(jm, x), 6)
    model = jax_params.load_mae(mae.mae_tiny_test(), v)
    with torch.no_grad():
        close(model(torch.from_numpy(x)), apply(jm, v, x))


def test_mae_tiny_bf16_matches_jax():
    """MAE in bfloat16 (its published dtype), stage by stage on the JAX
    side's own inputs (a one-ulp flip in the patch embedding, whose conv
    XLA sums in another order than the port's matmul, would spread through
    every token of its image): the patch embedding, each block, the final
    LN and the `fc` Dense (a flax Dense in bf16 rounds its product, then
    adds its bias rounded to bf16), each under the CPU's bf16 rule
    (`chip_smoke.agreement`: <= 2^-7 + 2 ulps, <= 2% differing). The JAX
    side runs eagerly, op by op, as the flax modules round."""
    x = inputs((2, 32, 32, 3), 14)
    jm = jmae.mae_tiny_test(jnp.bfloat16)
    v = lively(init(jm, x), 15)
    _, state = jm.apply(v, x, capture_intermediates=True, mutable=["intermediates"])
    bb = state["intermediates"]["backbone"]
    out = lambda tree: torch.from_numpy(np.array(tree["__call__"][0].astype(jnp.float32))).to(
        torch.bfloat16)
    model = jax_params.load_mae(mae.mae_tiny_test(torch.bfloat16), v)
    vit = model.backbone
    patches = out(bb["patch_embed"]).reshape(2, 4, 32)
    h = torch.cat([vit.cls_token.to(torch.bfloat16).expand(2, 1, 32), patches], 1)
    h = h + vit.pos_embed.to(torch.bfloat16)
    with torch.no_grad():
        stages = [(vit.patch_embed(torch.from_numpy(x)), patches)]
        for i, block in enumerate(vit.blocks):
            stages.append((block(h), out(bb[f"block{i}"])))
            h = stages[-1][1]
        tokens = out(bb)
        stages.append((layers.layer_norm(h, vit.norm, 1e-6, torch.bfloat16), tokens))
        stages.append((model.fc(tokens[:, 1:]), out(state["intermediates"]["fc"])))
    for got, want in stages:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        ok, err, share, words = chip_smoke.agreement(got, want, None)
        assert ok, (err, words)


def test_random_masking_on_jax_noise():
    """The port's `random_masking` driven with the noise JAX draws inside
    its own: the same kept tokens, mask and restore indices."""
    tokens = inputs((3, 10, 4))
    key = jax.random.PRNGKey(7)
    kept, mask, restore = jmae.random_masking(key, jnp.asarray(tokens), 0.75)
    noise = np.array(jax.random.uniform(key, (3, 10)))
    got = mae.random_masking(torch.from_numpy(tokens), 0.75, torch.from_numpy(noise))
    for g, w in zip(got, (kept, mask, restore)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (3, 2, 4)
    noise = mae.masking_noise(torch.Generator().manual_seed(0), 3, 10)
    assert noise.shape == (3, 10) and 0 <= float(noise.min()) and float(noise.max()) < 1


TEXT_CASES = ("ids_mask", "ids_mask_types", "embeds_pooler")


@pytest.mark.parametrize("case", TEXT_CASES)
def test_text_encoder_matches_jax(case):
    rng = np.random.default_rng(8)
    pool = case == "embeds_pooler"
    jm = jtext.text_tiny_test(output_pool=pool)
    if case == "embeds_pooler":
        args = (inputs((2, 10, 32), 9),)
    else:
        ids = rng.integers(0, 64, (2, 10))
        mask = np.concatenate([np.ones((2, 7)), np.zeros((2, 3))], axis=1).astype(np.float32)
        args = (ids, mask) + ((rng.integers(0, 2, (2, 10)),) if case == "ids_mask_types" else ())
    v = lively(init(jm, *args), 10)
    assert ("word_embeddings" in v["params"]) == (case != "embeds_pooler")
    model = jax_params.load_text_encoder(text_encoder.text_tiny_test(output_pool=pool), v)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    assert got.shape == ((2, 32) if pool else (2, 10, 32))
    close(got, apply(jm, v, *args))


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_deconv_matches_jax(train):
    x = inputs((2, 4, 4, 16))
    jm = jdeconv.DeConvModel(dim=16)
    v = lively(init(jm, x), 11)
    model = jax_params.load_deconv(deconv.DeConvModel(dim=16, device="cpu"), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    assert got.shape == (2, 128, 128, 3)
    if not train:
        close(got, apply(jm, v, x))
        return
    want, mutated = apply(jm, v, x, train=True, mutable=["batch_stats"])
    close(got, want)
    mutated = jax.device_get(mutated)
    for key, tensor, _ in jax_params.deconv_entries(model):
        if key[0] == "batch_stats":
            close(tensor, jax_params._leaf(mutated, key), BN_STATS_TOL)


def test_vsm_embed_matches_jax():
    """The `MD` head at the tiny VSM's widths (output_dim 8); zero rows
    are padding."""
    feats = inputs((2, 8, 16), 12)
    feats[1, 5:] = 0.0
    jm = jvsm.VideoScoreModel(cfg=dataclasses.replace(jvsm.VSM_TINY_TEST, output_dim=8))
    v = lively(init(jm, feats), 13)
    cfg = dataclasses.replace(vsm.VSM_TINY_TEST, output_dim=8)
    model = jax_params.load_video_score_model(vsm.VideoScoreModel(cfg), v)
    with torch.no_grad():
        got = model(torch.from_numpy(feats))
    assert got.shape == (2, 8)
    close(got, apply(jm, v, feats))
    assert vsm.vsm_embed(device="meta").output_proj.weight.shape == (256, 1536)


# --- the registry ------------------------------------------------------------------------


def test_registry_builds_every_jax_name():
    """Every name of the JAX registry builds in the port's (on `meta`: no
    memory), and the port has no name JAX lacks."""
    assert set(BACKBONES._entries) == set(JAX_BACKBONES._entries)
    for name in sorted(JAX_BACKBONES._entries):
        model = build_backbone({"type": name}, device="meta")
        assert next(model.parameters()).device.type == "meta", name


# The full-width zoo members: (registry key, the JAX init's arguments).
FULL_WIDTH = {
    "swin_v1_tiny_224": lambda: (np.zeros((1, 224, 224, 3), np.float32),),
    "efficientnet_v2_s": lambda: (np.zeros((1, 256, 256, 3), np.float32),),
    "mae_base_patch16_224": lambda: (np.zeros((1, 224, 224, 3), np.float32),),
    "roberta_base": lambda: (np.zeros((1, 8), np.int32), np.ones((1, 8), np.float32),
                             np.zeros((1, 8), np.int32)),
    "deconv_model": lambda: (np.zeros((1, 2, 2, 2048), np.float32),),
    "video_score_md": lambda: (np.zeros((1, 8, 1024), np.float32),),
}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_full_width_key_tables_fit_jax(name):
    """At the published widths, the port model's key table names every
    leaf of the JAX model's variables (`jax.eval_shape`: nothing is
    computed) with the shape its layout gives, and its default dtype is
    JAX's."""
    jm = JAX_BACKBONES.get(name)()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *FULL_WIDTH[name]()))
    model = build_backbone({"type": name}, device="meta")
    entries = jax_params.model_entries(model)
    leaves = {tuple(p.key for p in path): s
              for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k for k, _, _ in entries} == set(leaves)
    for key, tensor, layout in entries:
        want = jax_params._TO_PORT[layout](np.empty(leaves[key].shape, np.float32)).shape
        assert tuple(tensor.shape) == want, key
    assert str(model.dtype) == f"torch.{jnp.dtype(jm.dtype)}"


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_full_width_members_default_to_the_card(name):
    """Without a card, a full-width member built with no device named
    raises rather than landing on the CPU; a tiny one lands on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_backbone({"type": name})
    tiny = {"swin_v1_tiny_224": "swin_v1_tiny_test", "efficientnet_v2_s":
            "efficientnet_tiny_test", "mae_base_patch16_224": "mae_tiny_test",
            "roberta_base": "roberta_tiny_test"}.get(name)
    if tiny:
        assert next(build_backbone({"type": tiny}).parameters()).device.type == "cpu"
