"""The port's training monitors against the JAX package's, on seeded numpy
streams: every return value, property and ``state_dict`` bit for bit, and
``MetricsHistory``'s CSV files read across the two packages."""
import logging
import sys

import numpy as np
import pytest

from prcv2025reid_tpu.training import monitors as jax_monitors
from prcv2025reid_tpu_torch.training import monitors

SEEDS = (0, 1, 2)


def loss_stream(seed, n=400):
    """Losses drifting down with noise, spikes, NaN and inf entries."""
    rng = np.random.default_rng(seed)
    losses = 3.0 * np.exp(-np.arange(n) / 150.0) + rng.normal(0.0, 0.05, n)
    spikes = rng.choice(n, n // 20, replace=False)
    losses[spikes] *= rng.uniform(1.1, 4.0, len(spikes))
    losses[rng.choice(n, 3, replace=False)] = np.nan
    losses[rng.choice(n, 2, replace=False)] = np.inf
    return [float(v) for v in losses]


def random_batch(rng, B=12, Mv=4):
    pids = rng.integers(0, 5, B)
    pids[rng.random(B) < 0.1] = -1  # padding rows
    image_mask = (rng.random((B, Mv)) < 0.7).astype(np.float32)
    text_mask = (rng.random(B) < 0.6).astype(np.float32)
    image_mask[pids < 0] = 0.0
    text_mask[pids < 0] = 0.0
    return pids, image_mask, text_mask


@pytest.mark.parametrize("seed", SEEDS)
def test_spike_detector(seed):
    want, got = jax_monitors.SpikeDetector(), monitors.SpikeDetector()
    for i, loss in enumerate(loss_stream(seed)):
        assert got.update(loss) == want.update(loss)
        assert got.stability_score == want.stability_score
        if i % 50 == 0:
            assert got.state_dict() == want.state_dict()
    assert got.state_dict() == want.state_dict()
    # each package's state loads into the other and carries on the same
    a, b = monitors.SpikeDetector(), jax_monitors.SpikeDetector()
    a.load_state_dict(want.state_dict())
    b.load_state_dict(got.state_dict())
    for loss in loss_stream(seed + 10, 60):
        assert a.update(loss) == b.update(loss) == want.update(loss)
    assert a.state_dict() == b.state_dict() == want.state_dict()


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_coverage_monitor(seed):
    rng = np.random.default_rng(seed)
    want = jax_monitors.PairCoverageMonitor(window=20, target=0.6)
    got = monitors.PairCoverageMonitor(window=20, target=0.6)
    assert got.moving_average == want.moving_average == 0.0
    for i in range(60):
        if i % 3:
            batch = random_batch(rng)
            assert got.update(*batch) == want.update(*batch)
        else:
            v = float(rng.random())
            assert got.update_value(v) == want.update_value(v)
        assert got.moving_average == want.moving_average
        assert got.healthy == want.healthy
        assert list(got.values) == list(want.values)


@pytest.mark.parametrize("seed", SEEDS)
def test_feature_norm_monitor(seed):
    rng = np.random.default_rng(seed)
    want, got = jax_monitors.FeatureNormMonitor(), monitors.FeatureNormMonitor()
    for _ in range(200):
        sample = float(rng.choice([rng.uniform(0.7, 1.3), rng.uniform(5.0, 10.0)]))
        mean = float(rng.choice([rng.uniform(0.5, 3.0), rng.uniform(5.0, 20.0), np.nan]))
        epoch = int(rng.integers(1, 12))
        assert got.check(sample, mean, epoch) == want.check(sample, mean, epoch)
    assert got.warnings == want.warnings > 0


@pytest.mark.parametrize("num_classes", [1, 2, 7, 400])
def test_ce_diagnostics(num_classes):
    want, got = jax_monitors.CEDiagnostics(num_classes), monitors.CEDiagnostics(num_classes)
    assert got.random_baseline == want.random_baseline
    for ce in np.linspace(0.0, 8.0, 161):
        assert got.is_random(float(ce)) == want.is_random(float(ce))


@pytest.mark.parametrize("seed", SEEDS)
def test_batch_composition_and_count_report(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        batch = random_batch(rng)
        assert monitors.batch_composition(*batch) == jax_monitors.batch_composition(*batch)
    want, got = jax_monitors.BatchCountReport(12), monitors.BatchCountReport(12)
    assert got.summary() == want.summary() == {}
    for n in rng.integers(8, 16, 9):
        want.record_epoch(int(n))
        got.record_epoch(int(n))
        assert got.summary() == want.summary()


def history_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for epoch in range(1, 5):
        row = {"epoch": epoch, "steps": int(rng.integers(1, 9)), "total_loss": float(rng.normal()),
               "sdm_weight": 0.1 * epoch, "note": f"run-{seed}", "skipped_steps": 0}
        if epoch % 2:
            row["map_avg2"] = float(rng.random())  # a column some rows lack
        rows.append(row)
    return rows


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metrics_history_csv_reads_across_packages(writer, tmp_path):
    rows = history_rows(3)
    src = (jax_monitors if writer == "jax" else monitors).MetricsHistory()
    for r in rows:
        src.append(r)
    path = str(tmp_path / "history.csv")
    src.to_csv(path)
    readers = [jax_monitors.MetricsHistory(), monitors.MetricsHistory()]
    for h in readers:
        h.load_csv(path)
        assert h.rows == rows
    # each reader writes back the same bytes
    for i, h in enumerate(readers):
        h.to_csv(str(tmp_path / f"back{i}.csv"))
    texts = {open(p).read() for p in (path, tmp_path / "back0.csv", tmp_path / "back1.csv")}
    assert len(texts) == 1
    # a missing file is no rows, and no file is written for no rows
    empty = monitors.MetricsHistory()
    empty.load_csv(str(tmp_path / "absent.csv"))
    empty.to_csv(str(tmp_path / "none.csv"))
    assert empty.rows == [] and not (tmp_path / "none.csv").exists()


def test_metrics_history_without_tensorboardx_warns(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the import fails
    with caplog.at_level(logging.WARNING):
        want = jax_monitors.MetricsHistory(str(tmp_path / "jax"), tag_prefix="train/")
        got = monitors.MetricsHistory(str(tmp_path / "port"), tag_prefix="train/")
    assert want._tb is None and got._tb is None
    warned = [r.getMessage() for r in caplog.records if "TensorBoard export disabled" in r.getMessage()]
    assert len(warned) == 2 and warned[0] == warned[1]
    got.append({"epoch": 1, "loss": 0.5})  # the CSV rows still accumulate
    assert got.rows == [{"epoch": 1, "loss": 0.5}]


def test_metrics_history_writes_tensorboard_events(tmp_path):
    pytest.importorskip("tensorboardX")
    h = monitors.MetricsHistory(str(tmp_path / "tb"), tag_prefix="eval/")
    h.append({"epoch": 2, "map_avg2": 0.25, "note": "x"})
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "tb").iterdir())
