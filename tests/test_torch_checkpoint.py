"""The port's checkpoints: the cases of the JAX package's
``tests/test_training.py::TestCheckpoint`` (a round trip, an async save
whose sidecar lands on finalize, an atomic overwrite with recovery from a
crash between the renames), a restore onto a given device through
``map_location``, the strict shapes, and an exception in a background
write that surfaces at finalize.  The tiny f32 model of ``TINY_BASE`` on
the CPU, one train step taken so that every tensor of the state holds
values of its own."""
import dataclasses
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu_torch import TrainingConfig, build_model, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch import make_train_step  # noqa: E402
from prcv2025reid_tpu_torch.params import init_params  # noqa: E402
from prcv2025reid_tpu_torch.training import checkpoint  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import (  # noqa: E402
    finalize_pending_saves,
    latest_checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
)

NUM_CLASSES = 5
B, MV, S = 8, 4, TINY_BASE["image_size"]
STEPS_PER_EPOCH = 4
CFG = TrainingConfig(**{**TINY_BASE, "gradient_accumulation_steps": 2, "opt_nu_dtype": "bfloat16"})


def make_batch(seed):
    rng = np.random.default_rng(seed)
    ctx, vocab = CFG.text_context_length, CFG.text_vocab_size
    tokens = np.zeros((B, ctx), np.int32)
    tokens[:, 0], tokens[:, 5] = vocab - 2, vocab - 1
    tokens[:, 1:5] = rng.integers(1, vocab - 2, (B, 4))
    return dict(images=rng.integers(0, 256, (B, MV, S, S, 3), dtype=np.uint8),
                image_mask=np.ones((B, MV), np.float32), text_tokens=tokens,
                text_mask=np.ones(B, np.float32),
                labels=np.repeat(np.arange(B // 2), 2).astype(np.int32))


def fresh(seed=0, steps_per_epoch=STEPS_PER_EPOCH, cfg=CFG, num_classes=NUM_CLASSES):
    model = build_model(cfg, init_params(cfg, num_classes, seed), device="cpu")
    return model, init_train_state(model, cfg, steps_per_epoch, seed=seed)


@pytest.fixture(scope="module")
def trained():
    """(model, state) after three steps: mu, nu, the accumulation buffer,
    the norm history, the ring and the BN statistics all moved."""
    model, state = fresh(0)
    step = make_train_step(model, CFG, STEPS_PER_EPOCH)
    for i in range(3):
        state, _ = step(state, make_batch(i), 0.1, 0.18)
    return model, state


def state_tensors(model, state):
    """Every tensor of the training state by name, and the host ints."""
    out = {f"model/{k}": v for k, v in model.state_dict().items()}
    opt = state.opt_state
    for name in ("count", "plateau_scale", "mini_step"):
        out[f"opt/{name}"] = getattr(opt, name)
    for name in ("mu", "nu", "acc"):
        out.update({f"opt/{name}/{i}": t for i, t in enumerate(getattr(opt, name))})
    for name in ("grad_norm_hist", "grad_norm_count", "skipped_total", "metric_ring"):
        out[name] = getattr(state, name)
    return out, (state.step, state.seed)


def assert_same_state(got, want):
    (g, g_ints), (w, w_ints) = state_tensors(*got), state_tensors(*want)
    assert g_ints == w_ints
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def test_roundtrip(trained, tmp_path):
    model, state = trained
    host = {"epoch": 3, "best_map": 0.42, "sampler": {"a": 1, "rng": np.int64(7)}}
    save_checkpoint(str(tmp_path), model, state, host)
    assert latest_checkpoint_exists(str(tmp_path))
    assert sorted(os.listdir(tmp_path / "latest")) == ["host_state.json", "state.pt"]
    # plain dicts of tensors: the weights-only loader reads the file
    raw = torch.load(tmp_path / "latest" / "state.pt", weights_only=True)
    assert set(raw) == {"model", "step", "seed", "opt_state", "grad_norm_hist",
                        "grad_norm_count", "skipped_total", "metric_ring"}
    model2, template = fresh(seed=1)
    restored, host2 = restore_checkpoint(str(tmp_path), model2, template)
    assert_same_state((model2, restored), (model, state))
    assert host2 == {"epoch": 3, "best_map": 0.42, "sampler": {"a": 1, "rng": 7},
                     "ring_shapes": {"metric_ring": [STEPS_PER_EPOCH, 6],
                                     "grad_norm_hist": [CFG.adaptive_clip_window]}}
    assert restored.opt_state.nu[0].dtype == torch.bfloat16


def test_async_save_commits_sidecar_on_finalize(trained, tmp_path):
    model, state = trained
    host = {"epoch": 5, "best_map": 0.1}
    save_checkpoint(str(tmp_path), model, state, host, name="async", block=False)
    assert not latest_checkpoint_exists(str(tmp_path), name="async")
    finalize_pending_saves()
    assert latest_checkpoint_exists(str(tmp_path), name="async")
    model2, template = fresh(seed=1)
    restored, host2 = restore_checkpoint(str(tmp_path), model2, template, name="async")
    assert host2["epoch"] == 5
    assert_same_state((model2, restored), (model, state))

    # a subsequent save finalizes the previous in-flight one implicitly
    save_checkpoint(str(tmp_path), model, state, host, name="a2", block=False)
    save_checkpoint(str(tmp_path), model, state, host, name="a3", block=False)
    assert latest_checkpoint_exists(str(tmp_path), name="a2")
    assert not latest_checkpoint_exists(str(tmp_path), name="a3")
    finalize_pending_saves()
    assert latest_checkpoint_exists(str(tmp_path), name="a3")

    # restore also drains the pipeline: save async then restore directly
    save_checkpoint(str(tmp_path), model, state, host, name="a4", block=False)
    restored, _ = restore_checkpoint(str(tmp_path), model2, template, name="a4")
    assert restored.step == state.step

    # the host copy is taken at the call: the live tensors may change at once
    m3, s3 = fresh(seed=2)
    before = {k: v.clone() for k, v in m3.state_dict().items()}
    save_checkpoint(str(tmp_path), m3, s3, host, name="a5", block=False)
    with torch.no_grad():
        for p in m3.parameters():
            p.add_(1.0)
    finalize_pending_saves()
    restore_checkpoint(str(tmp_path), model2, template, name="a5")
    assert all(torch.equal(model2.state_dict()[k], v) for k, v in before.items())


def test_overwrite_is_atomic(trained, tmp_path):
    """Re-saving a name never destroys the previous checkpoint: the write
    stages in <name>.tmp and swaps in only when complete, and interrupted
    swaps are recovered on read."""
    model, state = trained
    model2, template = fresh(seed=1)
    save_checkpoint(str(tmp_path), model, state, {"epoch": 1})
    save_checkpoint(str(tmp_path), model, state, {"epoch": 2})
    _, host = restore_checkpoint(str(tmp_path), model2, template)
    assert host["epoch"] == 2
    path = str(tmp_path / "latest")
    assert not os.path.exists(path + ".tmp")
    assert not os.path.exists(path + ".old")

    # crash before the swap (a state file but no sidecar in the staging
    # dir): the old checkpoint keeps serving and the garbage is not promoted
    os.makedirs(path + ".tmp")
    shutil.copy(os.path.join(path, "state.pt"), path + ".tmp/state.pt")
    assert latest_checkpoint_exists(str(tmp_path))
    _, host = restore_checkpoint(str(tmp_path), model2, template)
    assert host["epoch"] == 2
    shutil.rmtree(path + ".tmp")

    # crash between the two renames: path gone, complete staging + old —
    # recovery promotes the NEWER staging dir
    save_checkpoint(str(tmp_path), model, state, {"epoch": 3})  # -> the new 'old'
    os.rename(path, path + ".bak")
    save_checkpoint(str(tmp_path), model, state, {"epoch": 4})
    os.rename(path, path + ".tmp")  # a complete checkpoint as staging
    os.rename(path + ".bak", path + ".old")
    _, host = restore_checkpoint(str(tmp_path), model2, template)
    assert host["epoch"] == 4
    assert not os.path.exists(path + ".old")

    # crash after rename(path -> old) with staging not yet complete:
    # recovery rolls the old checkpoint back into place
    os.rename(path, path + ".old")
    assert latest_checkpoint_exists(str(tmp_path))
    _, host = restore_checkpoint(str(tmp_path), model2, template)
    assert host["epoch"] == 4


def test_restore_onto_the_given_device(trained, tmp_path, monkeypatch):
    """The file is read with map_location = the device asked for (here the
    CPU to the CPU; a card's checkpoint reads on the CPU the same way), and
    the returned state lives there."""
    model, state = trained
    save_checkpoint(str(tmp_path), model, state, {"epoch": 1})
    seen = []
    load = torch.load

    def spy(*args, **kw):
        seen.append(kw.get("map_location"))
        return load(*args, **kw)

    monkeypatch.setattr(torch, "load", spy)
    model2, template = fresh(seed=1)
    restored, _ = restore_checkpoint(str(tmp_path), model2, template,
                                     device=torch.device("cpu"))
    assert seen == [torch.device("cpu")]
    tensors, _ = state_tensors(model2, restored)
    assert {t.device.type for t in tensors.values()} == {"cpu"}
    assert_same_state((model2, restored), (model, state))


def test_rings_take_the_writers_shapes_and_model_shapes_are_strict(trained, tmp_path):
    model, state = trained
    save_checkpoint(str(tmp_path), model, state, {"epoch": 1})
    # a reader with another steps_per_epoch and clip window
    cfg = dataclasses.replace(CFG, adaptive_clip_window=3)
    model2, template = fresh(seed=1, steps_per_epoch=9, cfg=cfg)
    restored, _ = restore_checkpoint(str(tmp_path), model2, template)
    assert torch.equal(restored.metric_ring, state.metric_ring)
    assert torch.equal(restored.grad_norm_hist, state.grad_norm_hist)
    # another classifier width is a model mismatch: it raises
    model3, template3 = fresh(seed=1, num_classes=NUM_CLASSES + 1)
    with pytest.raises(ValueError, match="bn_neck.classifier"):
        restore_checkpoint(str(tmp_path), model3, template3)
    # without the recorded ring shapes a ring mismatch is not guessed at
    sidecar = tmp_path / "latest" / "host_state.json"
    host = json.loads(sidecar.read_text())
    del host["ring_shapes"]
    sidecar.write_text(json.dumps(host))
    with pytest.raises(ValueError, match="metric_ring"):
        restore_checkpoint(str(tmp_path), model2, template)


def test_background_write_error_surfaces_at_finalize(trained, tmp_path, monkeypatch):
    model, state = trained
    save_checkpoint(str(tmp_path), model, state, {"epoch": 1})

    def disk_full(*args, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(torch, "save", disk_full)
    save_checkpoint(str(tmp_path), model, state, {"epoch": 2}, block=False)  # returns
    with pytest.raises(OSError, match="No space left"):
        finalize_pending_saves()
    finalize_pending_saves()  # raised once, then nothing is pending
    assert not checkpoint._PENDING
    # the incomplete write never replaced the previous checkpoint
    model2, template = fresh(seed=1)
    _, host = restore_checkpoint(str(tmp_path), model2, template)
    assert host["epoch"] == 1
    # a blocking save raises at once
    with pytest.raises(OSError, match="No space left"):
        save_checkpoint(str(tmp_path), model, state, {"epoch": 3})
