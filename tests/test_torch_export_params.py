"""The port's npz exporter (``tools/export_params.py``) against the JAX
package's, on the CPU in f32, at ``TINY_BASE`` widths.

A port model goes out through ``params_to_npz`` and into JAX's
``npz_to_params`` and JAX's eval forward; a JAX model goes out through
JAX's ``params_to_npz`` and into the port's ``npz_to_params``.  Each
forward's ``bn_features`` (L2-normalised x 8) must equal the other
package's to 2e-4 (the bar of ``tests/test_torch_slice.py``).  Then the
command line on a checkpoint the port's ``save_checkpoint`` wrote, and the
mismatch errors.
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
from prcv2025reid_tpu.tools import export_params as jax_export  # noqa: E402
from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.params import init_params  # noqa: E402
from prcv2025reid_tpu_torch.tools import export_params  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

NUM_CLASSES = 7
B = 3
TOL = 2e-4


def port_config() -> TrainingConfig:
    jcfg = JaxConfig(**TINY_BASE)
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{n: getattr(jcfg, n) for n in names})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8)
    mask = np.ones((B, 4), np.float32)
    mask[1, 2] = 0.0
    tokens = rng.integers(1, 98, (B, 16)).astype(np.int32)
    tokens[:, 0], tokens[:, 7], tokens[:, 8:] = 98, 99, 0
    return images, mask, tokens, np.ones((B,), np.float32)


@pytest.fixture(scope="module")
def jax_side(batch):
    """The JAX model, its init (jitted) and its jitted eval forward."""
    model = JaxModel(config=JaxConfig(**TINY_BASE), num_classes=NUM_CLASSES)
    images, mask, tokens, text_mask = batch
    args = (jnp.asarray(images), jnp.asarray(mask), jnp.asarray(tokens),
            jnp.asarray(text_mask))
    variables = jax.jit(lambda r: model.init({"params": r}, *args, train=False))(
        jax.random.PRNGKey(0))
    forward = jax.jit(lambda v: model.apply(v, *args, train=False)["bn_features"])
    return model, variables, forward


def port_features(model, batch):
    with torch.inference_mode():
        out, _ = model(*(torch.from_numpy(a) for a in batch), train=False)
    return out["bn_features"].numpy()


def test_port_export_loads_into_jax(batch, jax_side, tmp_path):
    _, template, forward = jax_side
    model = build_model(port_config(), init_params(port_config(), NUM_CLASSES, seed=4),
                        device="cpu")
    path = export_params.params_to_npz(str(tmp_path / "port"), model)
    assert path.endswith("port.npz")
    variables = jax_export.npz_to_params(path, template)
    got = np.asarray(forward(variables))
    np.testing.assert_allclose(got, port_features(model, batch), rtol=0, atol=TOL)
    # every leaf went over as it is
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    mine = export_params.flat_params(model)
    assert set(flat) == set(mine)
    for k in mine:
        np.testing.assert_array_equal(flat[k], mine[k], err_msg=k)


def test_jax_export_loads_into_the_port(batch, jax_side, tmp_path):
    _, variables, forward = jax_side
    flat = {k: np.array(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(1)
    for k in flat:  # JAX's zero lora_B and biases would hide a LoRA or bias bug
        if k.endswith("lora_B") or k.endswith("/bias"):
            flat[k] = rng.normal(0.0, 0.05, flat[k].shape).astype(np.float32)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    path = jax_export.params_to_npz(str(tmp_path / "jax.npz"), variables)
    model = build_model(port_config(), num_classes=NUM_CLASSES, device="cpu")
    loaded = export_params.npz_to_params(path, model)
    assert set(loaded) == set(flat)
    np.testing.assert_allclose(port_features(model, batch), np.asarray(forward(variables)),
                               rtol=0, atol=TOL)


def test_cli_exports_a_port_checkpoint(tmp_path):
    cfg = port_config()
    model = build_model(cfg, init_params(cfg, NUM_CLASSES, seed=2), device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), model, init_train_state(model, cfg, 1),
                    {"epoch": 1, "num_classes": NUM_CLASSES, "config": cfg.to_json()},
                    name="best")
    out = str(tmp_path / "model")
    written = export_params.main(["--model_path", str(tmp_path / "ckpt" / "best"),
                                  "--out", out, "--cpu"])
    assert written == out + ".npz"
    with np.load(written) as z:
        got = {k: z[k] for k in z.files}
    want = export_params.flat_params(model)
    assert set(got) == set(want) and any(k.startswith("batch_stats/") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # build_model reads the file back (the npz path form)
    again = build_model(cfg, written, device="cpu")
    for k, v in export_params.flat_params(again).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_mismatch_errors(fault, tmp_path):
    cfg = port_config()
    model = build_model(cfg, init_params(cfg, NUM_CLASSES), device="cpu")
    flat = export_params.flat_params(model)
    key = "params/encoder/vision/block_0/mlp/fc1/shared/kernel"
    if fault == "missing":
        del flat[key]
        match = f"missing=\\['{key}'\\]"
    elif fault == "extra":
        flat["params/encoder/vision/block_9/ln1/scale"] = np.ones(64, np.float32)
        match = "extra=\\['params/encoder/vision/block_9/ln1/scale'\\]"
    else:
        flat[key] = flat[key][:, :5]
        match = f"shape mismatch at {key}"
    path = str(tmp_path / "bad.npz")
    np.savez(path, **flat)
    with pytest.raises(ValueError, match=match):
        export_params.npz_to_params(path, model)
