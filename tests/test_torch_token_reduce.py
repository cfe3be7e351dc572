"""Token reduction in the port's vision trunk against the JAX package's, on
the CPU in f32.

``MERVisionTransformer._reduce_tokens`` (merge and prune) is held against
JAX's on the same hidden states to 1e-6, on random states and on states
whose scores all tie (JAX's ``lax.top_k`` keeps the lower position; the port
must keep the same set in the same order).  ``encode_subset`` with
``token_keep`` is held against JAX's to 2e-4 (the x8-scaled bn_features of
an f32 forward summed in another order, as ``tests/test_torch_slice.py``),
for both modes, both reduction layers, the block kernels' plan, a
``token_keep`` at or past S - 1 (no reduction at all) and a batch whose
tokens all tie.  One train step with ``token_reduce_train`` is held against
JAX's ``make_train_step`` with and without ``remat_blocks`` (losses and
metrics 1e-5, as ``tests/test_torch_train.py``), and the config's messages
against JAX's.
"""
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
from prcv2025reid_tpu.training import param_groups as jpg  # noqa: E402
from prcv2025reid_tpu.training.train_step import TrainState as JaxTrainState  # noqa: E402
from prcv2025reid_tpu.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from prcv2025reid_tpu_torch import (  # noqa: E402
    TrainingConfig,
    build_model,
    init_train_state,
    make_combo_embed_step,
    make_train_step,
)
from prcv2025reid_tpu_torch.models.vit import MERVisionTransformer  # noqa: E402

NUM_CLASSES = 5
MV = 4
# the embedding: 64 px, 16 patches (S = 17 with CLS), three blocks
EMBED = {**TINY_BASE, "image_size": 64, "vision_layers": 3}
EB, ES = 3, 64
FEAT_TOL = 2e-4
# the train step: TINY_BASE's 32 px (S = 5), two blocks, no randomness
NO_RANDOMNESS = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                     modality_dropout=0.0)
TRAIN = {**TINY_BASE, "num_epochs": 4, "warmup_epochs": 1, **NO_RANDOMNESS,
         "token_keep": 2, "token_reduce_layer": 1, "token_reduce_train": True}
TB, TS = 8, 32
CTX, VOCAB = TINY_BASE["text_context_length"], TINY_BASE["text_vocab_size"]
STEPS_PER_EPOCH = 10
SDM_WEIGHT, SDM_TAU = 0.1, 0.18


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


def jax_variables(flat):
    return tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def perturbed_export(jcfg, batch_size, size):
    """JAX's init at ``jcfg``, flattened as ``params_to_npz`` writes it, with
    lora_B, biases and BN statistics perturbed."""
    variables = jax.jit(lambda *a: JaxModel(config=jcfg, num_classes=NUM_CLASSES).init(
        {"params": jax.random.PRNGKey(0)}, *a, train=False))(
        jnp.zeros((batch_size, MV, size, size, 3)), jnp.ones((batch_size, MV)),
        jnp.zeros((batch_size, CTX), jnp.int32), jnp.ones((batch_size,)))
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
def embed_params():
    return perturbed_export(JaxConfig(**EMBED), EB, ES)


# ---- _reduce_tokens


def _hidden_states(kind, seed=0):
    """[G, B, S, D] = [2, 3, 17, 64] f32: random, or all patch tokens equal
    (every score ties), or two duplicated tokens among random ones."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, 17, EMBED["vision_hidden_dim"])).astype(np.float32)
    if kind == "all_tied":
        x[:, :, 1:] = x[:, :, 1:2]
    elif kind == "pair_tied":
        x[:, :, 9] = x[:, :, 4]
        x[:, :, 12] = x[:, :, 4]
    return x


@pytest.mark.parametrize("kind", ["random", "all_tied", "pair_tied"])
@pytest.mark.parametrize("mode,keep", [("merge", 6), ("prune", 6), ("merge", 15), ("prune", 1)])
def test_reduce_tokens_matches_jax(kind, mode, keep, embed_params):
    jcfg = JaxConfig(**{**EMBED, "token_keep": keep, "token_reduce_layer": 1,
                        "token_reduce_mode": mode})
    x = _hidden_states(kind)
    want = JaxModel(config=jcfg, num_classes=NUM_CLASSES).apply(
        jax_variables(embed_params), jnp.asarray(x),
        method=lambda m, h: m.encoder.vision._reduce_tokens(h))
    vit = build_model(port_config(jcfg), embed_params, device="cpu").encoder.vision
    got = vit._reduce_tokens(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3, keep + (2 if mode == "merge" else 1), x.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if kind == "all_tied":  # the first K positions, in order
        assert vit.keep_indices(torch.from_numpy(x)).tolist() == [[list(range(keep))] * 3] * 2


def test_reduce_tokens_gradients_flow_through_the_gather_and_the_merge():
    vit = MERVisionTransformer(embed_dim=8, num_layers=2, num_heads=2, mlp_dim=16,
                               image_size=32, fusion_dim=8, token_keep=2, token_reduce_layer=1)
    x = torch.randn(1, 2, 5, 8, generator=torch.Generator().manual_seed(0), requires_grad=True)
    out = vit._reduce_tokens(x)
    (out * torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)).sum().backward()
    idx = vit.keep_indices(x).tolist()
    for b in range(2):
        kept = [1 + i for i in idx[0][b]]
        dropped = [s for s in range(1, 5) if s not in kept]
        w = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)[0, b]
        for j, s in enumerate(kept):  # d out[1 + j] / d x[s] = 1
            torch.testing.assert_close(x.grad[0, b, s], w[1 + j] + 0.0)
        for s in dropped:  # the merged token: the mean of the dropped ones
            torch.testing.assert_close(x.grad[0, b, s], w[-1] / len(dropped))
        torch.testing.assert_close(x.grad[0, b, 0], w[0])


# ---- encode_subset with token_keep


def _embed_batch(tied=False):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (EB, MV, ES, ES, 3), dtype=np.uint8)
    if tied:
        images[:] = 128
    image_mask = np.ones((EB, MV), np.float32)
    image_mask[2, 1] = 0.0
    tokens = np.zeros((EB, CTX), np.int32)
    tokens[:, 0], tokens[:, 1:4], tokens[:, 4] = VOCAB - 2, 7, VOCAB - 1
    return images, image_mask, tokens, np.ones(EB, np.float32)


ENCODE_CASES = {  # (JAX overrides, port overrides)
    "merge_l2": ({"token_keep": 6, "token_reduce_layer": 2}, {}),
    "prune_l1": ({"token_keep": 6, "token_reduce_layer": 1, "token_reduce_mode": "prune"}, {}),
    "merge_s_minus_2": ({"token_keep": 15, "token_reduce_layer": 1}, {}),
    "keep_s_minus_1": ({"token_keep": 16, "token_reduce_layer": 1}, {}),  # no reduction
    "keep_past_s": ({"token_keep": 40, "token_reduce_layer": 2}, {}),  # no reduction
    "fused_blocks": ({"token_keep": 6, "token_reduce_layer": 1, "block_impl": "fused_interpret"},
                     {"block_impl": "fused"}),
    "kernels": ({"token_keep": 6, "token_reduce_layer": 2, "use_pallas_attention": True,
                 "use_fused_mlp": True}, {}),
    "tied": ({"token_keep": 6, "token_reduce_layer": 1}, {}),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_subset_with_token_keep_matches_jax(case, embed_params):
    jover, pover = ENCODE_CASES[case]
    flat = dict(embed_params)
    if case == "tied":  # no positional embedding + constant images: every score ties
        flat["params/encoder/vision/pos_embed"] = np.zeros_like(
            flat["params/encoder/vision/pos_embed"])
    jcfg = JaxConfig(**{**EMBED, **jover})
    images, image_mask, tokens, text_mask = _embed_batch(tied=case == "tied")
    jmodel = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
    model = build_model(port_config(jcfg, **pover), flat, device="cpu")
    # three vision groups and the text slot; the gallery combo where the
    # embedding must equal the full-token one
    for combo in ((("vis",),) if case.startswith("keep") else (("nir", "sk", "text"),)):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, combo, method=jmodel.encode_subset))(
            jax_variables(flat), jnp.asarray(images), jnp.asarray(image_mask),
            jnp.asarray(tokens), jnp.asarray(text_mask))
        with torch.no_grad():
            got = model.encode_subset(torch.from_numpy(images), torch.from_numpy(image_mask),
                                      torch.from_numpy(tokens), torch.from_numpy(text_mask),
                                      combo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FEAT_TOL,
                                   err_msg=f"{case} {combo}")
    if case in ("keep_s_minus_1", "keep_past_s"):  # exactly the full-token embedding
        full = build_model(port_config(jcfg, token_keep=0), flat, device="cpu")
        step = make_combo_embed_step(model, ("vis",))
        assert torch.equal(step(images, image_mask), make_combo_embed_step(full, ("vis",))(
            images, image_mask))


# ---- one train step with token_reduce_train


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((TB, CTX), np.int32)
    for i in range(TB):
        n = int(rng.integers(3, CTX + 1))
        tokens[i, 0], tokens[i, n - 1] = VOCAB - 2, VOCAB - 1
        tokens[i, 1:n - 1] = rng.integers(1, VOCAB - 2, n - 2)
    image_mask = np.ones((TB, MV), np.float32)
    image_mask[2, 1] = image_mask[5, 3] = 0.0
    return dict(images=rng.integers(0, 256, (TB, MV, TS, TS, 3), dtype=np.uint8),
                image_mask=image_mask, text_tokens=tokens, text_mask=np.ones(TB, np.float32),
                labels=np.repeat(np.arange(TB // 2), 2).astype(np.int32))


@pytest.fixture(scope="module")
def train_params():
    return perturbed_export(JaxConfig(**TRAIN), TB, TS)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_with_token_reduce_train_matches_jax(remat, train_params):
    jcfg = JaxConfig(**{**TRAIN, "remat_blocks": remat})
    variables = jax_variables(train_params)
    tx = jpg.build_optimizer(jcfg, variables["params"], STEPS_PER_EPOCH)
    jstep = jax_make_train_step(JaxModel(config=jcfg, num_classes=NUM_CLASSES), tx, jcfg)
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                  jax.random.PRNGKey(1), ring_size=STEPS_PER_EPOCH,
                                  clip_window=jcfg.adaptive_clip_window)
    pcfg = port_config(jcfg)
    model = build_model(pcfg, train_params, device="cpu")
    vit = model.encoder.vision
    assert vit.token_reduce_train and vit.remat_blocks == remat
    calls = []
    reduce = vit._reduce_tokens
    vit._reduce_tokens = lambda x: calls.append(tuple(x.shape)) or reduce(x)
    pstep = make_train_step(model, pcfg, STEPS_PER_EPOCH)
    pstate = init_train_state(model, pcfg, STEPS_PER_EPOCH)
    b = _train_batch(21)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.float32(SDM_WEIGHT), jnp.float32(SDM_TAU))
    pstate, pm = pstep(pstate, b, SDM_WEIGHT, SDM_TAU)
    # one reduction a forward, stored between the checkpointed blocks (not
    # recomputed in the backward): 4 patch tokens + CLS -> CLS + 2 + merged
    assert calls == [(MV, TB, 5, TINY_BASE["vision_hidden_dim"])]
    assert sorted(pm) == sorted(jm)
    for k in ("total_loss", "ce_loss", "sdm_loss"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(pm["skipped"]) == 0.0


def test_token_reduce_train_changes_the_training_forward(train_params):
    """With token_reduce_train the training trunk reduces; without it the
    same token_keep reduces only in eval (JAX vit.py:226-231)."""
    images = torch.from_numpy(_train_batch(3)["images"])
    feats = {}
    for train_flag in (True, False):
        cfg = port_config(JaxConfig(**{**TRAIN, "token_reduce_train": train_flag}))
        vit = build_model(cfg, train_params, device="cpu").encoder.vision
        with torch.no_grad():
            feats[train_flag] = vit.encode_stacked(images, deterministic=False)
    full = build_model(port_config(JaxConfig(**{**TRAIN, "token_keep": 0,
                                                "token_reduce_train": False})),
                       train_params, device="cpu").encoder.vision
    with torch.no_grad():
        plain = full.encode_stacked(images, deterministic=False)
    assert torch.equal(feats[False], plain)
    assert not torch.allclose(feats[True], plain, atol=1e-4)


# ---- the config


@pytest.mark.parametrize("override", [
    {"token_keep": -1},
    {"token_keep": 4, "token_reduce_layer": 0},
    {"token_keep": 4, "token_reduce_layer": 2},  # vision_layers = 2
    {"token_reduce_train": True},
    {"token_reduce_mode": "mean"},
])
def test_config_messages_match_jax(override):
    with pytest.raises(ValueError) as want:
        JaxConfig(**{**TINY_BASE, **override})
    with pytest.raises(ValueError) as got:
        TrainingConfig(**{**TINY_BASE, **override})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override", [
    {"token_keep": 4, "token_reduce_layer": 1},
    {"token_keep": 4, "token_reduce_layer": 1, "token_reduce_train": True},
    {"token_keep": 4, "token_reduce_layer": 1, "token_reduce_mode": "prune"},
])
def test_token_reduction_builds_and_fused_resln_still_refuses_it(override):
    cfg = TrainingConfig(**{**TINY_BASE, **override})
    vit = build_model(cfg, num_classes=3, device="cpu").encoder.vision
    assert (vit.token_keep, vit.token_reduce_layer, vit.token_reduce_mode,
            vit.token_reduce_train) == (cfg.token_keep, cfg.token_reduce_layer,
                                        cfg.token_reduce_mode, cfg.token_reduce_train)
    JaxConfig(**{**TINY_BASE, **override, "use_fused_resln": True})  # JAX accepts, then bypasses
    with pytest.raises(ValueError, match="use_fused_resln=True conflicts with token_keep"):
        TrainingConfig(**{**TINY_BASE, **override, "use_fused_resln": True})
    with pytest.raises(ValueError, match="runs every token"):
        MERVisionTransformer(embed_dim=8, num_layers=2, num_heads=2, mlp_dim=16, image_size=32,
                             resln_impl="auto", token_keep=cfg.token_keep)
