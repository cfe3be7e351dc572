"""The port's text tower and text combos against the JAX model, on the CPU.

One JAX ``MultiModalReIDModel`` at the tiny f32 widths of ``TINY_BASE`` (2
text layers, width 32, vocab 100, context 16), its lora_B, biases and BN
statistics perturbed, exported flat as ``params_to_npz`` writes it and
loaded into the port.  The captions are token rows in the layout of CLIP's
tokenizer (``data/tokenizer.py``): BOS, words, EOT (the highest id), zero
padding; some rows short, one at the full context length.
"""
import dataclasses
import hashlib
import sys
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step  # noqa: E402
from prcv2025reid_tpu_torch.params import NOT_YET_PORTED, init_params, load_params  # noqa: E402

NUM_CLASSES = 7
B, MV, S = 4, 4, 32
CTX, VOCAB = TINY_BASE["text_context_length"], TINY_BASE["text_vocab_size"]
TOWER_TOL = 1e-5  # abs, the pooled tower and encode_text output (f32)
TOL = 2e-4  # abs, on the x8-scaled bn_features, as tests/test_torch_slice.py


def port_config(**over) -> TrainingConfig:
    jcfg = JaxConfig(**TINY_BASE)
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


def token_rows(n, lengths, seed=0):
    """[n, CTX] int32 caption rows: BOS (VOCAB - 2), words, EOT (VOCAB - 1,
    the highest id), zeros; ``lengths`` counts BOS and EOT."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, CTX), np.int32)
    for i, length in enumerate(lengths):
        rows[i, 0] = VOCAB - 2
        rows[i, 1:length - 1] = rng.integers(1, VOCAB - 2, length - 2)
        rows[i, length - 1] = VOCAB - 1
    return rows


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, MV, S, S, 3), dtype=np.uint8)
    image_mask = np.ones((B, MV), np.float32)
    image_mask[2, 1] = 0.0  # sample 2: nir missing
    tokens = token_rows(B, [5, CTX, 3, 9])  # row 1 at the full context length
    text_mask = np.ones((B,), np.float32)
    text_mask[3] = 0.0  # sample 3: no caption -> the text null token
    return images, image_mask, tokens, text_mask


@pytest.fixture(scope="module")
def flat_params(batch):
    images, image_mask, tokens, text_mask = batch
    variables = JaxModel(config=JaxConfig(**TINY_BASE), num_classes=NUM_CLASSES).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(images, jnp.float32),
        jnp.asarray(image_mask), jnp.asarray(tokens), jnp.asarray(text_mask), train=False,
    )
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        if k.endswith("lora_B"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/bias") or k.endswith("bn/mean"):
            flat[k] = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
        elif k.endswith("bn/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def jax_model_and_variables(flat_params):
    variables = tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat_params.items()})
    return JaxModel(config=JaxConfig(**TINY_BASE), num_classes=NUM_CLASSES), variables


@pytest.fixture(scope="module")
def port_model(flat_params):
    return build_model(port_config(), flat_params, device="cpu")


@pytest.mark.parametrize("part", ["tower", "encode_text"])
def test_text_tower_matches_jax(part, batch, jax_model_and_variables, port_model):
    tokens = np.concatenate([batch[2], token_rows(3, [2, 7, CTX], seed=5)])
    jmodel, variables = jax_model_and_variables
    if part == "tower":
        want = jmodel.apply(variables, jnp.asarray(tokens),
                            method=lambda m, t: m.encoder.text(t))
    else:
        want = jmodel.apply(variables, jnp.asarray(tokens),
                            method=lambda m, t: m.encoder.encode_text(t))
    enc = port_model.encoder
    with torch.inference_mode():
        t = torch.from_numpy(tokens)
        got = enc.text(t) if part == "tower" else enc.encode_text(t)
    width = TINY_BASE["text_hidden_dim"] if part == "tower" else TINY_BASE["fusion_dim"]
    assert got.dtype == torch.float32 and got.shape == (len(tokens), width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOWER_TOL)


def test_pooling_reads_the_eot_position_and_ignores_padding(port_model):
    """The pooled row is the EOT token's: the padding after it (any ids below
    the EOT's) does not move it, and int64 rows equal int32 rows."""
    tokens = token_rows(2, [6, 6], seed=7)
    other = tokens.copy()
    other[:, 6:] = np.random.default_rng(8).integers(0, VOCAB - 2, (2, CTX - 6))
    tower = port_model.encoder.text
    with torch.inference_mode():
        a = tower(torch.from_numpy(tokens))
        b = tower(torch.from_numpy(other))
        c = tower(torch.from_numpy(tokens.astype(np.int64)))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert torch.equal(a, c)


@pytest.mark.parametrize("active", [("text",), ("nir", "text"), ("nir", "sk", "cp", "text"),
                                    ("vis", "text")])
def test_encode_subset_with_text_matches_jax(active, batch, jax_model_and_variables,
                                             port_model):
    images, image_mask, tokens, text_mask = batch
    jmodel, variables = jax_model_and_variables
    want = np.asarray(jmodel.apply(
        variables, jnp.asarray(images), jnp.asarray(image_mask), jnp.asarray(tokens),
        jnp.asarray(text_mask), active, method=jmodel.encode_subset))
    with torch.inference_mode():
        got = port_model.encode_subset(torch.from_numpy(images), torch.from_numpy(image_mask),
                                       torch.from_numpy(tokens), torch.from_numpy(text_mask),
                                       active)
    assert got.dtype == torch.float32 and got.shape == (B, TINY_BASE["fusion_dim"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("active", [("text",), ("sk", "text")])
def test_combo_step_with_text_is_normalized_encode_subset(active, batch, port_model):
    images, image_mask, tokens, text_mask = batch
    emb = make_combo_embed_step(port_model, active)(images, image_mask, tokens, text_mask)
    with torch.inference_mode():
        raw = port_model.encode_subset(torch.from_numpy(images), torch.from_numpy(image_mask),
                                       torch.from_numpy(tokens), torch.from_numpy(text_mask),
                                       active)
    torch.testing.assert_close(emb, raw / raw.norm(dim=1, keepdim=True))


def test_combo_step_without_text_ignores_the_captions(batch, port_model):
    images, image_mask, tokens, text_mask = batch
    step = make_combo_embed_step(port_model, ("nir", "sk"))
    assert torch.equal(step(images, image_mask), step(images, image_mask, tokens, text_mask))


def test_full_jax_export_loads_skipping_only_the_sdm_module(flat_params):
    """Since the SDM module was ported with the training step, nothing is
    skipped: every key of the export, the SDM module's included, loads."""
    from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel

    assert NOT_YET_PORTED == ()
    model = MultiModalReIDModel(port_config(), NUM_CLASSES)
    assert any(k.startswith("params/sdm_module/") for k in flat_params)
    assert load_params(model, flat_params) == []
    torch.testing.assert_close(model.sdm_module.proj1.kernel, torch.from_numpy(
        np.array(flat_params["params/sdm_module/proj1/kernel"])), rtol=0, atol=0)
    torch.testing.assert_close(
        model.encoder.text.token_embedding.embedding,
        torch.from_numpy(np.array(flat_params["params/encoder/text/token_embedding/embedding"])))


# sha256 over (key, float32 bytes) of every key of init_params(TINY_BASE, 7
# classes, seed=3) that the port had before the text tower: those values must
# not move when keys are added
VISION_KEYS_SHA256 = "41fa3c05832f5ed85f5c773788fb220944456adb872546b838ebab6299b14329"
VISION_KEY_COUNT = 92


def test_init_params_keeps_the_earlier_keys_values():
    ours = init_params(port_config(), NUM_CLASSES, seed=3)
    earlier = [k for k in sorted(ours) if not k.startswith(("params/encoder/text/",
                                                            "params/encoder/text_proj/",
                                                            "params/sdm_module/"))]
    h = hashlib.sha256()
    for k in earlier:
        h.update(k.encode())
        h.update(ours[k].tobytes())
    assert len(earlier) == VISION_KEY_COUNT and h.hexdigest() == VISION_KEYS_SHA256
    emb = ours["params/encoder/text/token_embedding/embedding"]
    assert emb.shape == (VOCAB, TINY_BASE["text_hidden_dim"]) and emb.std() > 0

