"""Weighted query fusion in the port against the JAX package's, on the CPU
in f32: ``MultiModalReIDModel.encode_weighted`` and
``engine.make_weighted_embed_step`` against JAX's ``encode_weighted`` and
``make_weighted_embed_step`` on one JAX init (lora_B, biases and BN
statistics perturbed) and one seeded batch with missing modalities, to
2e-4 (unit features; an f32 forward summed in another order).  The port's
result is also the weighted sum of its own per-modality ``encode_subset``
embeddings, renormalised."""
import dataclasses
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
from prcv2025reid_tpu.training import train_step as jax_train_step  # noqa: E402
from prcv2025reid_tpu_torch import (  # noqa: E402
    TrainingConfig,
    build_model,
    make_weighted_embed_step,
)

NUM_CLASSES = 6
B, MV, S = 4, 4, 32
CTX, VOCAB = TINY_BASE["text_context_length"], TINY_BASE["text_vocab_size"]
TOL = 2e-4
COMBOS = [("nir", "sk"), ("vis", "cp"), ("sk", "text"), ("nir", "sk", "cp", "text"), ("text",),
          ("cp",)]


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (B, MV, S, S, 3), dtype=np.uint8)
    image_mask = np.ones((B, MV), np.float32)
    image_mask[1, 1] = image_mask[2, 2] = image_mask[3, 3] = 0.0
    tokens = np.zeros((B, CTX), np.int32)
    for i in range(B):
        n = 3 + 2 * i
        tokens[i, 0], tokens[i, n - 1] = VOCAB - 2, VOCAB - 1
        tokens[i, 1:n - 1] = rng.integers(1, VOCAB - 2, n - 2)
    text_mask = np.array([1, 1, 0, 1], np.float32)
    return images, image_mask, tokens, text_mask


@pytest.fixture(scope="module")
def setup(batch):
    jcfg = JaxConfig(**TINY_BASE)
    jmodel = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
    variables = jax.jit(lambda *a: jmodel.init({"params": jax.random.PRNGKey(0)}, *a,
                                               train=False))(
        *(jnp.asarray(a) for a in batch))
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        if k.endswith("lora_B"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/bias") or k.endswith("bn/mean") or k.endswith("null_tokens"):
            flat[k] = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
        elif k.endswith("bn/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return jmodel, variables, build_model(port_config(jcfg), flat, device="cpu")


def _jax_batch(batch):
    images, image_mask, tokens, text_mask = batch
    return {"images": jnp.asarray(images), "image_mask": jnp.asarray(image_mask),
            "text_tokens": jnp.asarray(tokens), "text_mask": jnp.asarray(text_mask)}


@pytest.mark.parametrize("active", COMBOS)
def test_make_weighted_embed_step_matches_jax(active, batch, setup):
    jmodel, variables, model = setup
    want = np.asarray(jax_train_step.make_weighted_embed_step(jmodel, active)(
        variables, _jax_batch(batch)))
    got = make_weighted_embed_step(model, active)(*batch)
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, TINY_BASE["fusion_dim"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_encode_weighted_matches_jax_with_given_weights(batch, setup):
    jmodel, variables, model = setup
    active, weights = ("nir", "cp", "text"), (0.5, 2.0, 1.5)
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, active, weights,
                                              method=jmodel.encode_weighted))(
        variables, *(jnp.asarray(a) for a in batch))
    with torch.no_grad():
        got = model.encode_weighted(*(torch.from_numpy(a) for a in batch), active, weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    step = make_weighted_embed_step(model, active, dict(zip(active, weights)))
    torch.testing.assert_close(step(*batch), got, rtol=0, atol=0)


@pytest.mark.parametrize("active", [("nir", "sk", "cp"), ("vis", "sk", "text")])
def test_encode_weighted_is_the_weighted_sum_of_single_modality_embeddings(active, batch, setup):
    """One stacked trunk pass gives what each modality's own encode_subset
    gives: the weighted sum of the unit features, renormalised (text 1.2)."""
    _, _, model = setup
    args = [torch.from_numpy(a) for a in batch]
    with torch.no_grad():
        acc = 0
        for m in active:
            f = model.encode_subset(*args, (m,)).float()
            acc = acc + f / f.norm(dim=1, keepdim=True) * (1.2 if m == "text" else 1.0)
        want = acc / acc.norm(dim=1, keepdim=True)
    torch.testing.assert_close(make_weighted_embed_step(model, active)(*batch), want,
                               rtol=0, atol=1e-5)


def test_text_without_tokens_raises(batch, setup):
    _, _, model = setup
    images, image_mask = batch[:2]
    with pytest.raises(ValueError, match="text_tokens and text_mask"):
        make_weighted_embed_step(model, ("nir", "text"))(images, image_mask)
    with pytest.raises(ValueError, match="not in"):
        make_weighted_embed_step(model, ("nir", "txt"))(images, image_mask)
