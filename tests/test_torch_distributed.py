"""The port's multi-process runtime glue (``utils/distributed.py``) against
the JAX package's contract (``tests/test_distributed.py``).

One process behaves as without the module (no-op barrier, identity fetch,
main process); ``initialize_from_config`` keeps JAX's off / auto / on modes
and flags, with ``torch.distributed.init_process_group`` in place of
``jax.distributed.initialize``; and a real two-process gloo group on the
CPU (``tools_torch/dp_dryrun.py``, a ``file://`` rendezvous under the test's
own directory, so parallel test workers race on no port) runs the barrier,
``fetch_global``, ``broadcast_one_to_all``, the gallery cache's authority
and the checkpoint verdict.
"""
import importlib.util
import os
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed

from prcv2025reid_tpu_torch.configs import TrainingConfig, apply_cli_overrides
from prcv2025reid_tpu_torch.utils import distributed as dist

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _reset_initialized(monkeypatch):
    monkeypatch.setattr(dist, "_INITIALIZED", False)
    for v in dist._AUTO_ENV_VARS:
        monkeypatch.delenv(v, raising=False)


@pytest.fixture
def joined(monkeypatch):
    """init_process_group's keywords, call by call (no group is made)."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: calls.append(kw))
    return calls


class TestConfigFields:
    def test_invalid_mode_rejected(self):
        with pytest.raises(ValueError, match="distributed"):
            TrainingConfig(distributed="yes")

    def test_valid_modes(self):
        for mode in ("off", "auto", "on"):
            assert TrainingConfig(distributed=mode).distributed == mode

    def test_cli_overrides_parse(self):
        c = apply_cli_overrides(TrainingConfig(), [
            "--distributed=auto", "--coordinator_address=10.0.0.1:1234", "--num_processes=4",
            "--process_id=2"])
        assert c.distributed == "auto" and c.coordinator_address == "10.0.0.1:1234"
        assert c.num_processes == 4 and c.process_id == 2


class TestInitializeFromConfig:
    def test_off_is_noop(self, joined):
        assert dist.initialize_from_config(TrainingConfig(num_processes=2, process_id=1)) is False
        assert joined == []

    def test_auto_without_coordinator_is_noop(self, joined):
        assert dist.initialize_from_config(TrainingConfig(distributed="auto")) is False
        assert joined == []

    def test_on_passes_flags_through(self, joined, monkeypatch):
        cfg = TrainingConfig(distributed="on", coordinator_address="h:1", num_processes=2,
                             process_id=1)
        assert dist.initialize_from_config(cfg, backend="gloo") is True
        assert joined == [{"backend": "gloo", "init_method": "tcp://h:1", "world_size": 2,
                           "rank": 1}]
        # a second call never initializes again
        assert dist.initialize_from_config(cfg, backend="gloo") is False
        assert len(joined) == 1

    def test_auto_with_env_coordinator_initializes(self, joined, monkeypatch):
        monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.2:99")
        assert dist.initialize_from_config(TrainingConfig(distributed="auto"),
                                           backend="gloo") is True
        # JAX's trigger name is forwarded: torch's env:// does not read it
        assert joined == [{"backend": "gloo", "init_method": "tcp://10.0.0.2:99"}]

    def test_auto_with_torch_env_uses_env_discovery(self, joined, monkeypatch):
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.3")
        assert dist.initialize_from_config(TrainingConfig(distributed="auto"),
                                           backend="gloo") is True
        assert joined == [{"backend": "gloo", "init_method": "env://"}]

    def test_a_url_and_the_default_backend(self, joined, monkeypatch):
        """An init-method URL passes as it is; without CUDA the backend is
        gloo (NCCL wants a card a process)."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ns = Namespace(distributed="on", coordinator_address="file:///shared/rdv",
                       num_processes=3, process_id=0)
        assert dist.initialize_from_config(ns) is True
        assert joined == [{"backend": "gloo", "init_method": "file:///shared/rdv",
                           "world_size": 3, "rank": 0}]


class TestSingleProcessDegenerates:
    def test_is_main_process(self):
        assert dist.is_main_process() is True
        assert (dist.process_index(), dist.process_count()) == (0, 1)

    def test_barrier_noop(self):
        dist.barrier("test-point")  # must not raise or block

    def test_fetch_global_numpy_passthrough(self):
        x = np.arange(6).reshape(2, 3)
        np.testing.assert_array_equal(dist.fetch_global(x), x)

    def test_fetch_global_and_broadcast_of_a_tensor(self):
        x = torch.arange(16.0).reshape(8, 2)
        np.testing.assert_array_equal(dist.fetch_global(x), x.numpy())
        np.testing.assert_array_equal(dist.broadcast_one_to_all(x.numpy()), x.numpy())


def _dryrun():
    spec = importlib.util.spec_from_file_location("port_dp_dryrun",
                                                  ROOT / "tools_torch" / "dp_dryrun.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runtime_run(tmp_path_factory):
    """The dry run's runtime leg in a real gloo group of two (once)."""
    out = tmp_path_factory.mktemp("dp_runtime")
    return out, _dryrun().launch(["--cpu", "--legs", "runtime", "--out", str(out)])


class TestTwoProcessIntegration:
    def test_two_process_cpu(self, runtime_run):
        """Barrier, main-process gating, fetch_global of each process's
        rows, broadcast, the cache authority, the checkpoint verdict and
        restore."""
        out, summary = runtime_run
        assert summary["ok"], summary["failures"]
        want = {"is_main", "fetch_global", "broadcast", "cache_hit", "cache_miss",
                "cache_one_writer", "ckpt_absent", "ckpt_exists", "ckpt_missing_name",
                "ckpt_restored", "ckpt_one_writer"}
        for checks in summary["runtime"]:
            assert set(checks) == want and all(checks.values()), checks
        # one writer: the cache dir holds process 0's file, the checkpoint one dir
        assert len(os.listdir(out / "cache")) == 1
        assert sorted(os.listdir(out / "ckpt")) == ["latest"]

    def test_children_import_the_port_only(self, runtime_run):
        """The dry run's processes load no JAX and nothing of the JAX package."""
        _, summary = runtime_run
        assert summary["foreign_modules"] == []
