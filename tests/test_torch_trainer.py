"""The port's Trainer and its command line on the CPU, on the synthetic
ORBench tree of ``tests/conftest.py``, at the tiny f32 widths of
``TINY_BASE`` and the schedule of JAX's ``tests/test_trainer_e2e.py``
(2 epochs x 3 steps, in-process decode, eval batch 4).

The four cases of JAX's e2e file other than the eval CLI (fit then resume,
the smoke test keeps the sampler's stream, the crop relaxation round-trips,
the loss metrics are sane), exact resume (an interrupted-then-resumed run
equals an uninterrupted one bit for bit), ``tools_torch/train.py`` end to
end, and the entry points' refusal to run without a card."""
import csv
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu_torch import Trainer, TrainingConfig  # noqa: E402
from prcv2025reid_tpu_torch.utils import distributed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = {
    **TINY_BASE,
    "num_epochs": 2,
    "warmup_epochs": 1,
    "num_ids_per_batch": 2,
    "instances_per_id": 2,
    "steps_per_epoch": 3,
    "num_workers": 0,
    "eval_sample_ratio": 1.0,
    "eval_batch_size": 4,
    "save_freq": 50,
}
# the two columns an interrupted run may not reproduce: wall time, and the
# pair-coverage window, which JAX's host state does not checkpoint either
RESUME_FREE_COLUMNS = {"steps_per_sec", "pair_coverage_mavg"}


def make_config(root, work, **over):
    return TrainingConfig(**{**TINY, **over}, data_root=root,
                          json_file=os.path.join(root, "text_annos.json"),
                          save_dir=str(work / "ckpt"), log_dir=str(work / "logs"),
                          eval_cache_dir=str(work / "cache"))


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def training_state(trainer):
    """Every tensor the next step reads, by name, plus the host values."""
    out = {f"model/{k}": v for k, v in trainer.model.state_dict().items()}
    opt = trainer.state.opt_state
    for name in ("count", "plateau_scale", "mini_step"):
        out[f"opt/{name}"] = getattr(opt, name)
    for name in ("mu", "nu", "acc"):
        out.update({f"opt/{name}/{i}": t for i, t in enumerate(getattr(opt, name))})
    for name in ("grad_norm_hist", "grad_norm_count", "skipped_total", "metric_ring"):
        out[name] = getattr(trainer.state, name)
    return out, {"step": trainer.state.step, "seed": trainer.state.seed,
                 "sampler": trainer.sampler.state_dict(),
                 "sdm_scheduler": trainer.sdm_scheduler.state_dict(),
                 "spike_detector": trainer.spike_detector.state_dict(),
                 "best_map": trainer.best_map}


@pytest.fixture(scope="module")
def uninterrupted(orbench_root, tmp_path_factory):
    """One 2-epoch fit: (config, trainer, result)."""
    cfg = make_config(orbench_root, tmp_path_factory.mktemp("uninterrupted"))
    trainer = Trainer(cfg, device="cpu")
    return cfg, trainer, trainer.fit()


@pytest.fixture()
def trainer_config(orbench_root, tmp_path):
    return make_config(orbench_root, tmp_path)


def test_fit_and_resume(uninterrupted):
    cfg, trainer, result = uninterrupted
    assert 0.0 <= result["best_map"] <= 1.0
    assert result["final"]["map_avg2"] >= 0.0
    for name in ("train_history.csv", "eval_history.csv"):
        assert os.path.exists(os.path.join(cfg.log_dir, name))
    assert len(read_csv(os.path.join(cfg.log_dir, "train_history.csv"))) == 2
    assert os.path.isdir(os.path.join(cfg.save_dir, "latest"))
    assert os.path.isdir(os.path.join(cfg.save_dir, "best"))
    step_after = trainer.state.step
    assert step_after == 2 * cfg.steps_per_epoch

    # resume: a fresh trainer picks up after the last epoch
    trainer2 = Trainer(cfg, device="cpu")
    assert trainer2.maybe_resume()
    assert trainer2.start_epoch == 3
    assert trainer2.state.step == step_after
    assert trainer2.best_map == trainer.best_map
    # the histories reload: a resumed run appends to the earlier epochs
    assert [r["epoch"] for r in trainer2.train_history.rows] == [1, 2]
    assert len(trainer2.eval_history.rows) >= 1
    trainer2.pipeline.close()


def test_smoke_test_preserves_sampler_stream(trainer_config):
    trainer = Trainer(trainer_config, device="cpu")
    before = trainer.sampler.state_dict()
    trainer.smoke_test()
    assert trainer.sampler.state_dict() == before


def test_crop_relaxation_state_roundtrips(trainer_config):
    trainer = Trainer(trainer_config, device="cpu")
    assert trainer._host_state(1)["crop_relaxed"] is False
    trainer._relax_augmentation()
    assert trainer.train_ds.transform.crop_scale_min == pytest.approx(0.6)
    assert trainer._host_state(5)["crop_relaxed"] is True
    # a resumed trainer re-applies it from the sidecar
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    save_checkpoint(trainer_config.save_dir, trainer.model, trainer.state, trainer._host_state(5))
    trainer2 = Trainer(trainer_config, device="cpu")
    assert trainer2.maybe_resume() and trainer2._crop_relaxed
    assert trainer2.train_ds.transform.crop_scale_min == pytest.approx(0.6)


def test_train_loss_metrics_sane(trainer_config):
    trainer = Trainer(trainer_config, device="cpu")
    m = trainer.train_epoch(1)
    assert m["steps"] == trainer_config.steps_per_epoch
    assert np.isfinite(m["total_loss"])
    assert m["sdm_weight"] == 0.0  # epoch 1 = SDM warmup
    m2 = trainer.train_epoch(2, m)
    assert m2["sdm_weight"] == pytest.approx(0.1)  # the schedule starts
    assert 0.0 <= m2["stability_score"] <= 1.0
    assert 0.0 <= m2["pair_coverage_mavg"] <= 1.0
    assert m2["skipped_steps"] == 0 and m2["sdm_loss"] > 0.0


def test_resume_equals_uninterrupted(uninterrupted, orbench_root, tmp_path):
    """(a) fit over 2 epochs; (b) fit over 1 epoch, then a new Trainer with
    num_epochs=2 resumes and fits: the same parameters, BN statistics,
    optimizer state, norm history, skip counter, metric ring and sampler
    state bit for bit, and the same history but for RESUME_FREE_COLUMNS."""
    cfg_a, trainer_a, _ = uninterrupted
    cfg_b = make_config(orbench_root, tmp_path, num_epochs=1)
    Trainer(cfg_b, device="cpu").fit()
    trainer_b = Trainer(dataclasses.replace(cfg_b, num_epochs=2), device="cpu")
    trainer_b.fit()
    assert trainer_b.start_epoch == 2
    (ta, ha), (tb, hb) = training_state(trainer_a), training_state(trainer_b)
    assert hb == ha
    assert sorted(tb) == sorted(ta)
    for k in ta:
        assert tb[k].dtype == ta[k].dtype and torch.equal(tb[k], ta[k]), k
    rows_a = read_csv(os.path.join(cfg_a.log_dir, "train_history.csv"))
    rows_b = read_csv(os.path.join(cfg_b.log_dir, "train_history.csv"))
    assert len(rows_a) == len(rows_b) == 2
    for ra, rb in zip(rows_a, rows_b):
        assert ra.keys() == rb.keys()
        assert {k: v for k, v in rb.items() if k not in RESUME_FREE_COLUMNS} == \
            {k: v for k, v in ra.items() if k not in RESUME_FREE_COLUMNS}
    assert read_csv(os.path.join(cfg_a.log_dir, "eval_history.csv")) == \
        read_csv(os.path.join(cfg_b.log_dir, "eval_history.csv"))


def load_train_cli():
    spec = importlib.util.spec_from_file_location("train_cli", ROOT / "tools_torch" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cli_argv(root, work, **over):
    def flag(k, v):
        return f"--{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"

    return [flag(k, v) for k, v in {**TINY, **over}.items()] + [
        f"--data_root={root}", f"--json_file={root}/text_annos.json",
        f"--save_dir={work}/ckpt", f"--log_dir={work}/logs", f"--eval_cache_dir={work}/cache"]


def test_train_cli(orbench_root, tmp_path):
    """tools_torch/train.py end to end: a preset first, then the overrides
    (which bring the widths back down), on the CPU."""
    cli = load_train_cli()
    argv = ["--model_preset=clip-vit-base-patch32"] + cli_argv(orbench_root, tmp_path,
                                                               async_checkpoint=False)
    result = cli.main(argv, device="cpu")
    assert 0.0 <= result["best_map"] <= 1.0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["best", "latest"]
    assert sorted(os.listdir(tmp_path / "ckpt" / "latest")) == ["host_state.json", "state.pt"]
    logs = tmp_path / "logs"
    assert {"train_history.csv", "eval_history.csv", "training.log"} <= set(os.listdir(logs))
    assert "training done" in (logs / "training.log").read_text()
    assert len(read_csv(logs / "train_history.csv")) == 2
    import json

    host = json.loads((tmp_path / "ckpt" / "latest" / "host_state.json").read_text())
    cfg = TrainingConfig.from_json(host["config"])
    # the preset's values where no override follows, the overrides' elsewhere
    assert cfg.clip_model_name == "openai/clip-vit-base-patch32" and cfg.patch_size == 32
    assert cfg.vision_hidden_dim == TINY_BASE["vision_hidden_dim"]
    assert host["epoch"] == 2
    # the same command again resumes after epoch 2 and trains nothing
    again = cli.main(argv, device="cpu")
    assert again["best_map"] == result["best_map"]
    assert len(read_csv(logs / "train_history.csv")) == 2


def test_entry_points_raise_without_cuda(trainer_config, monkeypatch, tmp_path, orbench_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(trainer_config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_train_cli().main(cli_argv(orbench_root, tmp_path))


def test_multi_process_raises(monkeypatch):
    """One process: the main process, no barrier to wait for.  In a group of
    two (faked here; tests/test_torch_distributed.py runs real ones) the
    second process is not the main one and a barrier is the group's."""
    assert distributed.is_main_process() is True
    distributed.barrier("x")
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    waited = []
    monkeypatch.setattr(torch.distributed, "barrier", lambda: waited.append(1))
    assert distributed.is_main_process() is False
    assert (distributed.process_index(), distributed.process_count()) == (1, 2)
    distributed.barrier("x")
    assert waited == [1]


def test_trainer_modules_import_no_jax():
    code = (
        "import sys, runpy\n"
        "import prcv2025reid_tpu_torch.training.trainer\n"
        "import prcv2025reid_tpu_torch.training.checkpoint\n"
        "import prcv2025reid_tpu_torch.training.monitors\n"
        "import prcv2025reid_tpu_torch.utils.distributed\n"
        "from prcv2025reid_tpu_torch import Trainer, engine\n"
        "assert engine.Trainer is Trainer\n"
        "runpy.run_path('tools_torch/train.py', run_name='train_cli')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'optax', 'prcv2025reid_tpu')]\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
