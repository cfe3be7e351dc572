"""The CLIP ViT-B/32 and ViT-L/14 presets of the port against the JAX package,
on the CPU.

Each preset at its published widths and patch (B/32: 768 wide, patch 32, 50
tokens at 224 px; L/14: 1,024 wide, 16 heads, MLP 4,096, patch 14, 257
tokens; the text tower and the fusion at the preset's widths), cut in depth
as JAX's ``tests/test_presets.py`` cuts it (2 vision layers, 1 text layer,
vocab 64, context 8), f32.  JAX's model gives the parameter tree (its keys
and shapes, by ``jax.eval_shape`` of its init, which the port's numpy
``init_params`` must reproduce); the leaves are the port's seeded draws with
nonzero lora_B, biases and BN statistics (JAX's zeros would hide folding,
bias and BN bugs), and JAX's ``params_to_npz`` writes the tree that the port
loads.  ``encode_subset`` is compared on one seeded uint8 sample under the
plain path, ``use_pallas_attention`` (JAX's ``pallas_mha`` in interpret
mode, which pads 257 tokens to 384 under a key mask) and the fused-stream
trunk (JAX resolves its flags to its plain path on the CPU; the port runs
every block in full with the residual adds fused into the LayerNorms, the
same math); the port runs the plain versions its wrappers take for CPU
tensors.  The converter from HF's CLIP layout is held to JAX's bit for bit
on a seeded checkpoint in the layout ``hf_clip_shapes`` describes, which
must be every key JAX's converter reads, at the shapes it checks.  Neither
package trains the L/14 preset as it stands (the SDM module's 512 against
the fusion's 768); both do at 768.
"""
import dataclasses
import functools

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prcv2025reid_tpu.ops.attention as jax_attention
import prcv2025reid_tpu.ops.pallas_attention as jax_pallas_attention
from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig
from prcv2025reid_tpu.configs import apply_model_preset as jax_apply_model_preset
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel
from prcv2025reid_tpu.tools import convert_clip as jax_convert
from prcv2025reid_tpu.tools.export_params import params_to_npz
from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_train_step
from prcv2025reid_tpu_torch.configs import apply_model_preset
from prcv2025reid_tpu_torch.params import init_params
from prcv2025reid_tpu_torch.tools import convert_clip

PRESETS = ("clip-vit-base-patch32", "clip-vit-large-patch14")
TOKENS = {"clip-vit-base-patch32": 50, "clip-vit-large-patch14": 257}
NUM_CLASSES = 7
B, VOCAB, CTX = 1, 64, 8
TOL = 2e-4  # abs, on the bn_features (f32; summation order only)
CUT = dict(vision_layers=2, text_layers=1, text_vocab_size=VOCAB, text_context_length=CTX,
           compute_dtype="float32", use_pallas_attention=False, drop_path=0.0,
           gradient_accumulation_steps=1)
FUSED_TRUNK = {"use_fused_resln": True, "use_fused_mlp": True, "use_pallas_attention": True}
PATHS = {"xla": {}, "pallas_attention": {"use_pallas_attention": True},
         "fused_trunk": FUSED_TRUNK}
# what HF's checkpoints hold and neither converter reads
UNREAD = ("logit_scale", "position_ids", "pre_layrnorm.weight", "pre_layrnorm.bias")


def jax_config(preset: str, **over) -> JaxConfig:
    return jax_apply_model_preset(JaxConfig(), preset).replace(**{**CUT, **over})


def port_config(jcfg: JaxConfig) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{n: getattr(jcfg, n) for n in names})


@pytest.fixture
def pallas_attention(monkeypatch):
    """JAX's "auto" attention takes its Pallas kernel, in interpret mode
    (the only mode a CPU runs it in).  Its MLP and residual+LN "auto"
    choices read the same flag, so the fixture serves the attention path
    only."""
    mha = jax_pallas_attention.pallas_mha
    monkeypatch.setattr(jax_attention, "_pallas_available", lambda: True)
    monkeypatch.setattr(jax_pallas_attention, "pallas_mha",
                        lambda q, k, v, causal=False: mha(q, k, v, causal, True))


def token_rows(n, lengths, seed):
    """[n, CTX] caption rows in CLIP's layout: BOS, words, EOT (the highest
    id), zero padding; ``lengths`` counts BOS and EOT."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, CTX), np.int32)
    for i, length in enumerate(lengths):
        rows[i, 0] = VOCAB - 2
        rows[i, 1:length - 1] = rng.integers(1, VOCAB - 2, length - 2)
        rows[i, length - 1] = VOCAB - 1
    return rows


@pytest.fixture(scope="module", params=PRESETS)
def preset(request, tmp_path_factory):
    """(name, JAX config, JAX variables, their npz file, the batch)."""
    name = request.param
    jcfg = jax_config(name)
    S = jcfg.image_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, 4, S, S, 3), dtype=np.uint8)
    batch = (images, np.ones((B, 4), np.float32), token_rows(B, [5, CTX][:B], seed=1),
             np.ones((B,), np.float32))
    shapes = jax.eval_shape(functools.partial(
        JaxModel(config=jcfg, num_classes=NUM_CLASSES).init, train=False),
        {"params": jax.random.PRNGKey(0)}, *(jnp.asarray(a) for a in batch))
    flat = init_params(port_config(jcfg), NUM_CLASSES, seed=0)
    want = {k: tuple(v.shape) for k, v in tu.flatten_dict(shapes, sep="/").items()}
    assert {k: v.shape for k, v in flat.items()} == want
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    path = params_to_npz(str(tmp_path_factory.mktemp(name) / "params"), variables)
    return name, jcfg, variables, path, batch


def test_presets_match_jax():
    for name in PRESETS:
        assert dataclasses.asdict(port_config(jax_config(name))) == dataclasses.asdict(
            apply_model_preset(TrainingConfig(), name).replace(**CUT))


_JAX_PLAIN = {}  # (preset, active) -> JAX's plain-path encode_subset


def jax_encode(jcfg, variables, batch, active, over):
    jmodel = JaxModel(config=jcfg.replace(**over), num_classes=NUM_CLASSES)
    encode = jax.jit(lambda v, *b: jmodel.apply(v, *b, active, method=jmodel.encode_subset))
    return np.asarray(encode(variables, *(jnp.asarray(a) for a in batch)))


@pytest.mark.parametrize("active", [("vis",), ("nir", "text")])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_encode_subset_matches_jax(path, active, preset, request):
    name, jcfg, variables, npz, batch = preset
    over = PATHS[path]
    if path == "pallas_attention":
        request.getfixturevalue("pallas_attention")
        want = jax_encode(jcfg, variables, batch, active, over)
    else:
        # JAX resolves the fused-stream trunk's flags to its plain path on
        # the CPU: one result serves both
        if (name, active) not in _JAX_PLAIN:
            _JAX_PLAIN[name, active] = jax_encode(jcfg, variables, batch, active, {})
        want = _JAX_PLAIN[name, active]
    model = build_model(port_config(jcfg).replace(**over), npz, device="cpu")
    assert model.encoder.vision.pos_embed.shape[0] == TOKENS[name]
    with torch.inference_mode():
        got = model.encode_subset(*(torch.from_numpy(a) for a in batch), active)
    assert got.dtype == torch.float32 and got.shape == (B, jcfg.fusion_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def l14_336(tmp_path_factory):
    """The L/14 preset at 336 px (577 tokens), cut as ``preset`` cuts it:
    (JAX config, JAX variables, their npz file, a one-image batch)."""
    jcfg = jax_config("clip-vit-large-patch14", image_size=336)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (B, 4, 336, 336, 3), dtype=np.uint8)
    batch = (images, np.ones((B, 4), np.float32), token_rows(B, [5], seed=3),
             np.ones((B,), np.float32))
    flat = init_params(port_config(jcfg), NUM_CLASSES, seed=0)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    path = params_to_npz(str(tmp_path_factory.mktemp("l14_336") / "params"), variables)
    return jcfg, variables, path, batch


@pytest.mark.parametrize("path", sorted(PATHS))
def test_l14_at_336_px_matches_jax(path, l14_336, request):
    """L/14 at 336 px, where #1 runs 577 tokens (on the card its
    register-held kernel): the vis embedding against JAX's, whose
    ``use_pallas_attention`` path runs ``pallas_mha`` at 577 tokens in
    interpret mode."""
    jcfg, variables, npz, batch = l14_336
    over = PATHS[path]
    if path == "pallas_attention":
        request.getfixturevalue("pallas_attention")
        want = jax_encode(jcfg, variables, batch, ("vis",), over)
    else:
        if ("l14_336", "vis") not in _JAX_PLAIN:
            _JAX_PLAIN["l14_336", "vis"] = jax_encode(jcfg, variables, batch, ("vis",), {})
        want = _JAX_PLAIN["l14_336", "vis"]
    model = build_model(port_config(jcfg).replace(**over), npz, device="cpu")
    assert model.encoder.vision.pos_embed.shape[0] == 577
    with torch.inference_mode():
        got = model.encode_subset(*(torch.from_numpy(a) for a in batch), ("vis",))
    assert got.dtype == torch.float32 and got.shape == (B, jcfg.fusion_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# OpenCLIP ViT-H/14's widths (model_configs/ViT-H-14.json: vision 1,280 wide,
# 32 layers, heads of 80, MLP 5,120, patch 14 at 224 px; text 1,024 x 24, 16
# heads; embed 1,024) as the TrainingConfig overrides a user passes as flags
# (no preset), the SDM module at the fusion width so that it trains
VIT_H = dict(vision_hidden_dim=1280, vision_layers=32, vision_heads=16, vision_mlp_dim=5120,
             patch_size=14, image_size=224, text_hidden_dim=1024, text_layers=24,
             text_heads=16, text_mlp_dim=4096, fusion_dim=1024, sdm_semantic_dim=1024)


def vit_h_config(**over) -> JaxConfig:
    """ViT-H/14's widths cut as the presets are (2 vision layers, 1 text)."""
    return JaxConfig().replace(**{**VIT_H, **CUT, **over})


@pytest.fixture(scope="module")
def vit_h(tmp_path_factory):
    """(JAX config, JAX variables, their npz file, a one-sample batch) at
    ViT-H/14's widths; JAX's tree by ``jax.eval_shape``, as ``preset``."""
    jcfg = vit_h_config()
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (B, 4, 224, 224, 3), dtype=np.uint8)
    batch = (images, np.ones((B, 4), np.float32), token_rows(B, [6], seed=6),
             np.ones((B,), np.float32))
    shapes = jax.eval_shape(functools.partial(
        JaxModel(config=jcfg, num_classes=NUM_CLASSES).init, train=False),
        {"params": jax.random.PRNGKey(0)}, *(jnp.asarray(a) for a in batch))
    flat = init_params(port_config(jcfg), NUM_CLASSES, seed=0)
    assert {k: v.shape for k, v in flat.items()} == {
        k: tuple(v.shape) for k, v in tu.flatten_dict(shapes, sep="/").items()}
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    path = params_to_npz(str(tmp_path_factory.mktemp("vit_h") / "params"), variables)
    return jcfg, variables, path, batch


@pytest.mark.parametrize("active", [("vis",), ("nir", "text")])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_vit_h_widths_match_jax(path, active, vit_h, request):
    """ViT-H/14's widths (heads of 80: #1 at a padded width of 128 on the
    card, 257 tokens; rows of 1,280 in the row passes): encode_subset against
    JAX's, whose use_pallas_attention path runs ``pallas_mha`` at Dh = 80 in
    interpret mode."""
    jcfg, variables, npz, batch = vit_h
    over = PATHS[path]
    if path == "pallas_attention":
        request.getfixturevalue("pallas_attention")
        want = jax_encode(jcfg, variables, batch, active, over)
    else:
        if ("vit_h", active) not in _JAX_PLAIN:
            _JAX_PLAIN["vit_h", active] = jax_encode(jcfg, variables, batch, active, {})
        want = _JAX_PLAIN["vit_h", active]
    model = build_model(port_config(jcfg).replace(**over), npz, device="cpu")
    blk = model.encoder.vision.blocks[0]
    assert model.encoder.vision.pos_embed.shape == (257, 1280)
    assert blk.num_heads == 16 and 1280 // blk.num_heads == 80
    with torch.inference_mode():
        got = model.encode_subset(*(torch.from_numpy(a) for a in batch), active)
    assert got.dtype == torch.float32 and got.shape == (B, 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_vit_h_widths_train_step_matches_jax():
    """One train step at ViT-H/14's widths (SDM at the fusion width, 1,024)
    against JAX's make_train_step + build_optimizer from the same
    parameters, cut to 2 vision layers, 1 text layer and 64 px images (17
    tokens) for the CPU's time, f32, no randomness: every metric within
    1e-5 (the file's train-step tolerance, tests/test_torch_train.py)."""
    from prcv2025reid_tpu.training import param_groups as jpg
    from prcv2025reid_tpu.training.train_step import TrainState as JaxTrainState
    from prcv2025reid_tpu.training.train_step import make_train_step as jax_make_train_step
    from prcv2025reid_tpu_torch import init_train_state

    no_rand = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                   modality_dropout=0.0)
    jcfg = vit_h_config(image_size=56, num_ids_per_batch=2, instances_per_id=2, **no_rand)
    rng = np.random.default_rng(7)
    n = 4
    batch = dict(images=rng.integers(0, 256, (n, 4, 56, 56, 3), dtype=np.uint8),
                 image_mask=np.ones((n, 4), np.float32), text_tokens=token_rows(n, [5, 8, 6, 7],
                                                                                seed=8),
                 text_mask=np.ones((n,), np.float32), labels=np.array([0, 0, 1, 1], np.int32))
    flat = init_params(port_config(jcfg), NUM_CLASSES, seed=1)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    tx = jpg.build_optimizer(jcfg, variables["params"], 1)
    jstep = jax_make_train_step(JaxModel(config=jcfg, num_classes=NUM_CLASSES), tx, jcfg)
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                  jax.random.PRNGKey(1), ring_size=1,
                                  clip_window=jcfg.adaptive_clip_window)
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0.1),
                  jnp.float32(0.18))
    pcfg = port_config(jcfg)
    model = build_model(pcfg, flat, device="cpu")
    _, pm = make_train_step(model, pcfg, 1)(init_train_state(model, pcfg, 1), batch, 0.1, 0.18)
    assert sorted(pm) == sorted(jm) and float(pm["skipped"]) == 0.0
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)


class _Reads(dict):
    """A checkpoint that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.fixture(scope="module")
def hf_sd(preset):
    """A seeded checkpoint in HF's CLIP layout at the preset's cut widths,
    from ``hf_clip_shapes``."""
    rng = np.random.default_rng(4)
    out = {}
    for k, (shape, dtype) in convert_clip.hf_clip_shapes(port_config(preset[1])).items():
        if k.endswith("position_ids"):
            out[k] = np.arange(shape[1], dtype=dtype)[None]
        else:
            out[k] = rng.normal(0.0, 0.02, shape).astype(dtype)
    return out


def test_convert_clip_equals_jax_bit_for_bit(preset, hf_sd):
    """The model's encoder leaves through both converters: every leaf the
    same bits and dtype, every key present; JAX's converter reads every key
    of ``hf_clip_shapes`` but the unread ones and checks each shape against
    its template."""
    template = {"params": preset[2]["params"]["encoder"]}
    hf = _Reads(hf_sd)
    want = {k: np.asarray(v) for k, v in tu.flatten_dict(
        jax_convert.convert_clip_params(hf, template, seed=3), sep="/").items()}
    assert hf.read == {k for k in hf_sd if not k.endswith(UNREAD)}
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(template, sep="/").items()}
    got = convert_clip.convert_clip_params(hf_sd, flat, seed=3, prefix="params/")
    assert set(got) == set(want)
    diff = [k for k in want if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])]
    assert not diff, diff[:5]
    np.testing.assert_array_equal(got["params/vision/block_1/mlp/fc1/shared/kernel"],
                                  hf_sd["vision_model.encoder.layers.1.mlp.fc1.weight"].T)


@pytest.mark.parametrize("sdm", [512, 768])
def test_l14_trains_with_the_sdm_module_at_the_fusion_width(sdm):
    """In training the SDM module's features feed the fusion, whose
    projections take the fusion width: the L/14 preset's default
    sdm_semantic_dim (512, fusion 768) makes JAX's train forward raise
    (flax's shape error at fusion/q_proj) and the port's make_train_step
    refuse it; at 768 both build the step."""
    jcfg = jax_config("clip-vit-large-patch14", vision_layers=1, sdm_semantic_dim=sdm)
    S = jcfg.image_size
    args = (jnp.zeros((2, 4, S, S, 3)), jnp.ones((2, 4)), jnp.zeros((2, CTX), jnp.int32),
            jnp.ones((2,)))
    jmodel = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            {"params": jax.random.PRNGKey(0)}, *args)
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(("dropout", "drop_path", "moddrop"))}

    def train_forward():
        return jax.eval_shape(lambda v, *a: jmodel.apply(v, *a, train=True, rngs=rngs,
                                                         mutable=["batch_stats"]), shapes, *args)

    model = build_model(port_config(jcfg), num_classes=NUM_CLASSES, device="cpu")
    if sdm == jcfg.fusion_dim:
        train_forward()
        assert callable(make_train_step(model, port_config(jcfg), 1))
    else:
        with pytest.raises(Exception, match="fusion/q_proj"):
            train_forward()
        with pytest.raises(ValueError, match=f"sdm_semantic_dim={sdm} must equal fusion_dim=768"):
            make_train_step(model, port_config(jcfg), 1)
