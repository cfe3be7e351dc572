"""The port's gallery-embed slice against the JAX model, end to end.

One JAX ``MultiModalReIDModel`` is initialised at tiny f32 widths; its
lora_B, biases and BN running statistics are perturbed (JAX initialises
them to zero / one, which would hide folding, bias and BN bugs), the tree is
flattened the way ``params_to_npz`` writes it and loaded into the port
through ``params.py``.  ``encode_subset`` is compared on one seeded uint8
batch in which one sample has every image masked (the all-masked rescue),
under the plain block path, the fused block plans (JAX: ``fused_interpret``,
``fused_qkv_interpret``, ``fused_int8_interpret``,
``fused_int8_mlp_interpret``), ``use_pallas_attention=True``,
``use_fused_mlp=True``, the fused-stream trunk (``use_fused_resln=True``
with both), the serving formulations ``attn_backend="onesaug"`` and
``gelu_impl="poly"``/``"tanh"`` (also onesaug with ``fused_qkv``), and
``attn_backend="splash"`` (held against JAX's plain path:
Mosaic splash cannot run on a CPU, and it computes the einsum core's exact
softmax).  JAX resolves the flags to its plain path on the CPU; the port's
wrappers run their plain versions for CPU tensors, and its fused-stream trunk
keeps its own structure (every block in full, the residual adds fused into
the LayerNorms), the same math.

The int8 plans quantize, so their distance from the plain path is
quantization noise, not summation order: the port must sit within a tenth of
that distance (JAX-int8 against JAX-xla on the same batch) of JAX-int8, which
tells a port bug (an error of the noise's own size) from f32 ulps that flip
an int8 rounding.
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
from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step  # noqa: E402
from prcv2025reid_tpu_torch.params import init_params, load_params  # noqa: E402

NUM_CLASSES = 7
B, MV, S = 3, 4, 32
TOL = 2e-4  # abs, on the x8-scaled bn_features (f32; summation order only)

FUSED_TRUNK = {"use_fused_resln": True, "use_fused_mlp": True, "use_pallas_attention": True}
CONFIGS = {
    "xla": ({}, {}),
    "fused": ({"block_impl": "fused_interpret"}, {"block_impl": "fused"}),
    "pallas_attention": ({"use_pallas_attention": True}, {"use_pallas_attention": True}),
    "fused_mlp": ({"use_fused_mlp": True}, {"use_fused_mlp": True}),
    "fused_trunk": (FUSED_TRUNK, FUSED_TRUNK),
    "fused_qkv": ({"block_impl": "fused_qkv_interpret"}, {"block_impl": "fused_qkv"}),
    "splash": ({}, {"attn_backend": "splash"}),
    "fused_int8": ({"block_impl": "fused_int8_interpret"}, {"block_impl": "fused_int8"}),
    "fused_int8_mlp": ({"block_impl": "fused_int8_mlp_interpret"},
                       {"block_impl": "fused_int8_mlp"}),
    # the serving formulations: plain PyTorch on every device, run by JAX on the CPU
    "onesaug": ({"attn_backend": "onesaug"}, {"attn_backend": "onesaug"}),
    "gelu_poly": ({"gelu_impl": "poly"}, {"gelu_impl": "poly"}),
    "gelu_tanh": ({"gelu_impl": "tanh"}, {"gelu_impl": "tanh"}),
    # the onesaug core between the kernels (_fused_call) and in the CLS-only
    # block, and a serving GELU in the plain folded_block_tail of fused_qkv
    "onesaug_fused_qkv": (
        {"attn_backend": "onesaug", "block_impl": "fused_qkv_interpret", "gelu_impl": "tanh"},
        {"attn_backend": "onesaug", "block_impl": "fused_qkv", "gelu_impl": "tanh"}),
}
INT8 = ("fused_int8", "fused_int8_mlp")
SERVING_GELU = ("gelu_poly", "gelu_tanh", "onesaug_fused_qkv")
INT8_SHARE = 0.1  # of JAX-int8's own distance from JAX-xla


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    kw = {n: getattr(jcfg, n) for n in names}
    kw.update(over)
    return TrainingConfig(**kw)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, MV, S, S, 3), dtype=np.uint8)
    image_mask = np.ones((B, MV), np.float32)
    image_mask[1] = 0.0  # sample 1: every modality missing -> rescue path
    image_mask[2, 2] = 0.0  # sample 2: sk missing
    tokens = np.zeros((B, TINY_BASE["text_context_length"]), np.int32)
    return images, image_mask, tokens, np.zeros((B,), np.float32)


@pytest.fixture(scope="module")
def flat_params(batch):
    cfg = JaxConfig(**TINY_BASE)
    images, image_mask, tokens, text_mask = batch
    variables = JaxModel(config=cfg, num_classes=NUM_CLASSES).init(
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
def jax_variables(flat_params):
    return tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat_params.items()})


@pytest.mark.parametrize("active", [("vis",), ("nir", "sk")])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_subset_matches_jax(name, active, batch, flat_params, jax_variables):
    jax_over, port_over = CONFIGS[name]
    images, image_mask, tokens, text_mask = batch

    def jax_encode(over):
        jmodel = JaxModel(config=JaxConfig(**{**TINY_BASE, **over}), num_classes=NUM_CLASSES)
        return np.asarray(jmodel.apply(
            jax_variables, jnp.asarray(images), jnp.asarray(image_mask), jnp.asarray(tokens),
            jnp.asarray(text_mask), active, method=jmodel.encode_subset,
        ))

    want = jax_encode(jax_over)
    model = build_model(port_config(JaxConfig(**TINY_BASE), **port_over),
                        flat_params, device="cpu")
    with torch.inference_mode():
        got = model.encode_subset(torch.from_numpy(images), torch.from_numpy(image_mask),
                                  None, None, active)
    assert got.dtype == torch.float32 and got.shape == (B, TINY_BASE["fusion_dim"])
    tol = TOL
    if name in SERVING_GELU:  # the formulation moves JAX's embedding by more than TOL
        assert np.abs(want - jax_encode({})).max() > 2 * TOL
    if name in INT8:
        noise = np.abs(want - jax_encode({})).max()
        assert noise > 10 * TOL, noise  # the int8 plan really quantized
        tol = INT8_SHARE * noise
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_embed_step_is_normalized_encode_subset(batch, flat_params):
    images, image_mask, _, _ = batch
    model = build_model(port_config(JaxConfig(**TINY_BASE)), flat_params, device="cpu")
    emb = make_combo_embed_step(model, ("vis",))(images, image_mask)
    with torch.inference_mode():
        raw = model.encode_subset(torch.from_numpy(images), torch.from_numpy(image_mask),
                                  None, None, ("vis",))
    torch.testing.assert_close(emb, raw / raw.norm(dim=1, keepdim=True))
    assert emb.device.type == "cpu"


@pytest.mark.parametrize("name", ["fused_mlp", "fused_trunk", "fused_qkv", "splash",
                                  "fused_int8", "fused_int8_mlp"])
def test_loader_takes_the_same_npz_under_the_fused_flags(name, flat_params, tmp_path):
    """The fused paths add no parameter: one params_to_npz file loads into
    every configuration, tensor for tensor."""
    path = tmp_path / "params.npz"
    np.savez(path, **flat_params)
    plain = build_model(port_config(JaxConfig(**TINY_BASE)), str(path), device="cpu")
    fused = build_model(port_config(JaxConfig(**TINY_BASE), **CONFIGS[name][1]), str(path),
                        device="cpu")
    want, got = plain.state_dict(), fused.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_loader_rejects_unknown_and_missing_keys(flat_params):
    cfg = port_config(JaxConfig(**TINY_BASE))
    with pytest.raises(ValueError, match="do(es)? not know"):
        build_model(cfg, {**flat_params, "params/encoder/vision/extra": np.zeros(1)},
                    device="cpu")
    partial = {k: v for k, v in flat_params.items() if not k.endswith("ln_final/scale")}
    with pytest.raises(ValueError, match="missing"):
        build_model(cfg, partial, device="cpu")
    bad = dict(flat_params)
    bad["params/null_tokens"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        build_model(cfg, bad, device="cpu")


def test_loader_skips_only_unported_modules(flat_params):
    from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel

    model = MultiModalReIDModel(port_config(JaxConfig(**TINY_BASE)), NUM_CLASSES)
    skipped = load_params(model, flat_params)
    assert skipped == []  # every module is ported since the SDM module came
    torch.testing.assert_close(model.bn_neck.bn.var,
                               torch.from_numpy(flat_params["batch_stats/bn_neck/bn/var"]))


def test_init_params_matches_jax_tree(flat_params):
    ours = init_params(port_config(JaxConfig(**TINY_BASE)), NUM_CLASSES, seed=3)
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in flat_params.items()}
    assert all(v.dtype == np.float32 for v in ours.values())
    assert all(np.abs(v).max() > 0 for k, v in ours.items() if k.endswith(("lora_B", "bn/mean")))
    assert any(np.abs(ours[k] - 1).max() > 0 for k in ours if k.endswith("bn/var"))
    again = init_params(port_config(JaxConfig(**TINY_BASE)), NUM_CLASSES, seed=3)
    assert all(np.array_equal(ours[k], again[k]) for k in ours)
    plain = init_params(port_config(JaxConfig(**TINY_BASE)), NUM_CLASSES, perturb=False)
    assert all(not plain[k].any() for k in plain if k.endswith("lora_B"))
