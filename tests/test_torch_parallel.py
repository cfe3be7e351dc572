"""Data parallelism over a process group (``parallel/``, the data-parallel
train step, the sharded evaluation), on the CPU at the tiny widths, against
JAX's 8-device virtual CPU mesh (``tests/test_parallel.py``) and against the
port's one process.

One group of ``NPROC`` gloo processes (``group``, module scope: a child
script that imports the port only, a ``file://`` rendezvous under the
module's own directory, its own timeout) computes everything that needs
the group, from inputs this process writes, and writes its results; the
tests hold them here:

- the global-batch step (``tools_torch/dp_dryrun.py::run_steps``, its 3
  steps of a seeded 4 x 2 batch split over the processes): with every rate of
  randomness 0 its metrics against JAX's step on the 8-device mesh (rtol
  1e-4, atol 1e-5, JAX's own bound for mesh against one device); at
  drop-path 0 and 0.1 (with the default dropouts) against the port's one
  process on the whole batch (the same bounds; every leaf of the state after
  step 1 within 1e-5; the processes' state the same bits after step 3);
- ``sharded_topk`` against ``topk_reference`` (indices exactly: a gallery
  the process count divides, one it does not, all ties);
- the query-sharded ``compute_retrieval_metrics`` against one process (rel
  1e-6, JAX's bound), the sharded ``evaluate_protocol`` (with re-ranking)
  against one process, and the mesh's submission CSV against one process's,
  byte for byte.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel
from prcv2025reid_tpu.parallel import mesh as jax_mesh
from prcv2025reid_tpu.training import param_groups as jpg
from prcv2025reid_tpu.training.train_step import TrainState as JaxTrainState
from prcv2025reid_tpu.training.train_step import make_train_step as jax_make_train_step
from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
from prcv2025reid_tpu_torch.evaluation import protocol
from prcv2025reid_tpu_torch.params import init_params
from prcv2025reid_tpu_torch.parallel import mesh
from prcv2025reid_tpu_torch.parallel.ranking import topk_reference

ROOT = Path(__file__).resolve().parent.parent
NPROC = 2
GROUP_TIMEOUT = 420  # seconds, as JAX's two-process test
NO_RANDOMNESS = ["--set", "drop_path=0", "--set", "dropout_rate=0", "--set", "fusion_dropout=0",
                 "--set", "sdm_dropout=0", "--set", "modality_dropout=0"]
STEP_CASES = {"jax": NO_RANDOMNESS, "drop_path_0.1": []}  # the tool's drop-path: 0.1
EVAL_BATCH = 8  # 12 records: a full batch and a tail of 4 (process 1 holds only padding)
RERANK = {"top_n": 5, "k1": 3, "k2": 2, "lam": 0.3}


def _tool():
    spec = importlib.util.spec_from_file_location("port_dp_dryrun",
                                                  ROOT / "tools_torch" / "dp_dryrun.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_args(case):
    return ["--cpu", *STEP_CASES[case]]


def ranking_cases(rng):
    """name -> (queries, gallery, k), as JAX's tests/test_parallel.py."""
    return {"divisible": (rng.normal(size=(5, 16)), rng.normal(size=(100, 16)), 10),
            "indivisible": (rng.normal(size=(3, 8)), rng.normal(size=(37, 8)), 5),
            "ties": (np.asarray([[1.0, 0.0]]), np.tile(np.asarray([[1.0, 0.0]]), (16, 1)), 4)}


def metric_cases(rng):
    """name -> compute_retrieval_metrics' arguments, as JAX's tests."""
    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return {
        "padded": dict(q=unit(rng.normal(size=(21, 16))), q_pids=rng.integers(0, 7, 21),
                       g=unit(rng.normal(size=(50, 16))), g_pids=rng.integers(0, 7, 50)),
        "exclusion": dict(q=rng.normal(size=(10, 8)), q_pids=rng.integers(0, 4, 10),
                          g=rng.normal(size=(30, 8)), g_pids=rng.integers(0, 4, 30),
                          exclude=rng.random((10, 30)) < 0.1),
        "small_chunks": dict(q=rng.normal(size=(13, 8)), q_pids=rng.integers(0, 3, 13),
                             g=rng.normal(size=(20, 8)), g_pids=rng.integers(0, 3, 20),
                             query_chunk=5),
    }


def _metric_kwargs(case):
    kw = {k: v for k, v in case.items() if k not in ("q", "q_pids", "g", "g_pids")}
    return (np.asarray(case["q"], np.float32), case["q_pids"],
            np.asarray(case["g"], np.float32), case["g_pids"]), kw


_CHILD = r"""
import importlib.util, os, pickle, sys
from argparse import Namespace
root, out, rank, nproc = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, root)
from prcv2025reid_tpu_torch.utils import distributed
distributed.initialize_from_config(Namespace(
    distributed="on", num_processes=nproc, process_id=rank,
    coordinator_address=f"file://{out}/rdv"), backend="gloo")
import torch
torch.set_num_threads(1)  # tiny shapes: threads would only contend with the other process
from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
from prcv2025reid_tpu_torch.evaluation import protocol
from prcv2025reid_tpu_torch.params import init_params
from prcv2025reid_tpu_torch.parallel.mesh import create_mesh
from prcv2025reid_tpu_torch.parallel.ranking import sharded_topk

with open(f"{out}/inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
mesh = create_mesh()
assert (mesh.size, mesh.rank) == (nproc, rank)
res = {"topk": {}, "metrics": {}, "steps": {}}
for name, (q, g, k) in inputs["ranking"].items():
    s, i = sharded_topk(q, g, k, mesh, device="cpu")
    res["topk"][name] = (s.numpy(), i.numpy())
for name, (args, kw) in inputs["metrics"].items():
    res["metrics"][name] = protocol.compute_retrieval_metrics(*args, mesh=mesh, device="cpu",
                                                              **kw)

spec = importlib.util.spec_from_file_location("dp", os.path.join(root, "tools_torch",
                                                                  "dp_dryrun.py"))
dp = importlib.util.module_from_spec(spec)
spec.loader.exec_module(dp)
for case, argv in inputs["steps"].items():
    args = dp.build_parser().parse_args(argv)
    records, model, state = dp.run_steps(args, dp.build_config(args), torch.device("cpu"), mesh,
                                         save=f"{out}/{case}_rank{rank}")
    res["steps"][case] = {"metrics": [r["metrics"] for r in records],
                          "digest": dp._digest(model, state)}

cfg = TrainingConfig.from_json(inputs["eval_config"])
model = build_model(cfg, init_params(cfg, 6, 0, perturb=True), device="cpu")
steps = {}


def factory(m):
    if tuple(m) not in steps:
        steps[tuple(m)] = make_combo_embed_step(model, tuple(m))
    return steps[tuple(m)]


ds = MultiModalDataset(cfg, "val")
tok = build_tokenizer(None, cfg.text_vocab_size, cfg.text_context_length)
res["csv_rows"] = protocol.export_submission_csv(
    None, ds, tok, f"{out}/mesh.csv", batch_size=inputs["batch"], k_values=(1, 2), top_k=3,
    embed_factory=factory, mesh=mesh, sharding=mesh, device="cpu")
res["evaluate"] = protocol.evaluate_protocol(
    None, ds, tok, batch_size=inputs["batch"], exclude_same_image=True, embed_factory=factory,
    sharding=mesh, mesh=mesh, rerank=inputs["rerank"], device="cpu")
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
torch.distributed.destroy_process_group()
print(f"CHILD-OK {rank}")
"""


@pytest.fixture(scope="module")
def eval_config(orbench_root):
    return TrainingConfig(**{k: v for k, v in _tool().TINY.items()},
                          data_root=orbench_root,
                          json_file=os.path.join(orbench_root, "text_annos.json"))


@pytest.fixture(scope="module")
def group(tmp_path_factory, eval_config):
    """Run the group once: -> (its directory, the inputs, each process's
    results)."""
    import pickle

    out = tmp_path_factory.mktemp("dp_group")
    rng = np.random.default_rng(0)
    inputs = {
        "ranking": {n: (np.asarray(q, np.float32), np.asarray(g, np.float32), k)
                    for n, (q, g, k) in ranking_cases(rng).items()},
        "metrics": {n: _metric_kwargs(c) for n, c in metric_cases(rng).items()},
        "steps": {case: _step_args(case) for case in STEP_CASES},
        "eval_config": eval_config.to_json(), "batch": EVAL_BATCH, "rerank": RERANK,
    }
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (out / "child.py").write_text(_CHILD)
    procs = [subprocess.Popen([sys.executable, str(out / "child.py"), str(ROOT), str(out), str(r),
                               str(NPROC)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(NPROC)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the {NPROC}-process group timed out (deadlock?)")
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"CHILD-OK {r}" in text, f"process {r}:\n{text[-4000:]}"
    results = []
    for r in range(NPROC):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return out, inputs, results


# ---- the mesh, one process


class TestMesh:
    def test_create_mesh_is_the_process_group(self):
        m = mesh.create_mesh()
        assert (m.size, m.rank, m.axis_names) == (1, 0, ("data",))
        assert mesh.data_axis_size(m) == 1
        assert mesh.create_mesh(TrainingConfig(mesh_shape=(1,))) == m
        with pytest.raises(ValueError, match="process group"):
            mesh.create_mesh(n_devices=8)

    def test_model_axis_names_item_8b(self):
        """A model axis is accepted (tensor parallelism, item 8b): with its
        size from mesh_shape, as JAX's; without one it raises, as JAX's."""
        with pytest.raises(ValueError, match="mesh_shape=\\(d, m\\)"):
            mesh.create_mesh(TrainingConfig(mesh_axis_names=("data", "model")))
        m = mesh.create_mesh(TrainingConfig(mesh_shape=(1, 1), mesh_axis_names=("data", "model")))
        assert (m.size, m.rank, m.model_size, m.model_rank, m.axis_names) == (
            1, 0, 1, 0, ("data", "model"))
        with pytest.raises(ValueError, match="must start with|supported meshes"):
            mesh.create_mesh(TrainingConfig(mesh_axis_names=("batch",)))

    def test_pad_batch_and_local_slices_match_jax(self):
        b = {"images": np.ones((6, 2)), "labels": np.zeros(6, np.int32),
             "pids": np.arange(6, dtype=np.int32)}
        got, want = mesh.pad_batch_to(b, 8), jax_mesh.pad_batch_to(b, 8)
        for k in b:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["labels"][-1] == -1 and got["pids"][-1] == -1 and got["images"][-1].sum() == 0
        for pi in range(4):
            assert mesh.process_local_indices(16, pi, 4) == jax_mesh.process_local_indices(
                16, pi, 4)

    def test_shard_batch_and_make_global_batch_invert(self):
        b = {"x": np.arange(24).reshape(8, 3), "labels": np.arange(8)}
        halves = [mesh.shard_batch(b, mesh.Mesh(size=2, rank=r)) for r in (0, 1)]
        np.testing.assert_array_equal(np.concatenate([h["x"] for h in halves]), b["x"])
        one = mesh.make_global_batch(mesh.shard_batch(b, mesh.Mesh()), mesh.Mesh())
        np.testing.assert_array_equal(one["x"], b["x"])


# ---- the global-batch step


def _jax_mesh_metrics(cfg, tool):
    """JAX's train step on its 8-device mesh, from init_params' state, over
    the tool's global batches."""
    P, K = tool.SIZES["pk"][1]
    jcfg = JaxConfig.from_json(cfg.to_json())
    flat = init_params(cfg, P, tool.SEED, perturb=True)
    variables = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    tx = jpg.build_optimizer(jcfg, variables["params"], 10)
    jmodel = JaxModel(config=jcfg, num_classes=P)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                 jax.random.PRNGKey(1), ring_size=10,
                                 clip_window=jcfg.adaptive_clip_window)
    m8 = jax_mesh.create_mesh()
    assert m8.devices.size == 8
    state = jax_mesh.replicate_state(state, m8)
    step = jax_make_train_step(jmodel, tx, jcfg)
    out = []
    for s in range(tool.STEPS):
        b = jax_mesh.shard_batch(tool.global_batch(cfg, P, K, seed=100 + s), m8)
        state, m = step(state, b, jnp.float32(0.1), jnp.float32(0.18), True)
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_step_matches_jax_on_its_8_device_mesh(group):
    tool = _tool()
    _, inputs, results = group
    args = tool.build_parser().parse_args(inputs["steps"]["jax"])
    assert tool.build_config(args).drop_path == 0.0
    want = _jax_mesh_metrics(tool.build_config(args), tool)
    for r in results:
        got = r["steps"]["jax"]["metrics"]
        for s, (g, w) in enumerate(zip(got, want)):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {s + 1} {k}")


def _state(path):
    return torch.load(path, weights_only=True)


def _leaves(st):
    return [*(("model/" + k, v) for k, v in st["model"].items()),
            *((f"mu/{i}", v) for i, v in enumerate(st["mu"])),
            *((f"nu/{i}", v) for i, v in enumerate(st["nu"]))]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_equals_one_process_on_the_global_batch(case, group, tmp_path):
    tool = _tool()
    out, inputs, results = group
    args = tool.build_parser().parse_args(inputs["steps"][case])
    single, model, state = tool.run_steps(args, tool.build_config(args), torch.device("cpu"),
                                          None, save=str(tmp_path / "single"))
    for r in results:
        for s, (g, w) in enumerate(zip(r["steps"][case]["metrics"], single)):
            for k, v in w["metrics"].items():
                np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {s + 1} {k}")
    # every leaf of the state after step 1, against one process's
    want = dict(_leaves(_state(tmp_path / "single_step1.pt")))
    for rank in range(NPROC):
        got = _leaves(_state(out / f"{case}_rank{rank}_step1.pt"))
        assert [k for k, _ in got] == list(want)
        for k, v in got:
            err = (v.double() - want[k].double()).abs().max().item() if v.numel() else 0.0
            assert err <= 1e-5, f"{k}: {err}"
    # the processes' state after the last step: the same bits
    assert len({r["steps"][case]["digest"] for r in results}) == 1
    a, b = (_state(out / f"{case}_rank{rank}.pt") for rank in (0, 1))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


# ---- sharded ranking and evaluation


@pytest.mark.parametrize("name", ["divisible", "indivisible", "ties"])
def test_sharded_topk_matches_reference(name, group):
    _, inputs, results = group
    q, g, k = inputs["ranking"][name]
    ref_scores, ref_idx = topk_reference(q, g, k)
    for r in results:
        scores, idx = r["topk"][name]
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)
    if name == "ties":
        np.testing.assert_array_equal(results[0]["topk"][name][1][0], [0, 1, 2, 3])


@pytest.mark.parametrize("name", ["padded", "exclusion", "small_chunks"])
def test_mesh_metrics_equal_single(name, group):
    _, inputs, results = group
    args, kw = inputs["metrics"][name]
    single = protocol.compute_retrieval_metrics(*args, device="cpu", **kw)
    for r in results:
        meshed = r["metrics"][name]
        assert sorted(meshed) == sorted(single)
        for k in single:
            assert meshed[k] == pytest.approx(single[k], rel=1e-6), k


@pytest.fixture(scope="module")
def one_process_eval(eval_config):
    cfg = eval_config
    model = build_model(cfg, init_params(cfg, 6, 0, perturb=True), device="cpu")
    steps = {}

    def factory(m):
        if tuple(m) not in steps:
            steps[tuple(m)] = make_combo_embed_step(model, tuple(m))
        return steps[tuple(m)]

    ds = MultiModalDataset(cfg, "val")
    tok = build_tokenizer(None, cfg.text_vocab_size, cfg.text_context_length)
    return ds, tok, factory


def test_mesh_submission_csv_byte_identical(group, one_process_eval, tmp_path):
    out, _, results = group
    ds, tok, factory = one_process_eval
    n = protocol.export_submission_csv(None, ds, tok, str(tmp_path / "single.csv"),
                                       batch_size=EVAL_BATCH, k_values=(1, 2), top_k=3,
                                       embed_factory=factory, device="cpu")
    assert n > 0 and all(r["csv_rows"] == n for r in results)
    assert (out / "mesh.csv").read_bytes() == (tmp_path / "single.csv").read_bytes()


def test_sharded_evaluate_protocol_equals_single(group, one_process_eval):
    """The sharded embed (each process decodes and embeds its rows of a
    batch) and the query-sharded ranking and re-ranking give one process's
    numbers (rel 1e-6)."""
    _, _, results = group
    ds, tok, factory = one_process_eval
    single = protocol.evaluate_protocol(None, ds, tok, batch_size=EVAL_BATCH,
                                        exclude_same_image=True, embed_factory=factory,
                                        rerank=RERANK, device="cpu")
    for r in results:
        meshed = r["evaluate"]
        assert sorted(meshed["detail"]) == sorted(single["detail"])
        for plan, d in single["detail"].items():
            for k, v in d.items():
                assert meshed["detail"][plan][k] == pytest.approx(v, rel=1e-6), (plan, k)
        for k, v in single.items():
            if k != "detail":
                assert meshed[k] == pytest.approx(v, rel=1e-6), k


# ---- the evaluation command line as a group

_EVAL_CLI = r"""
import runpy, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
torch.set_num_threads(1)  # tiny shapes: threads would only contend with the other process
runpy.run_path(root + "/tools_torch/eval_mm_protocol.py", run_name="eval_cli")["main"](
    sys.argv[2:], device="cpu")
"""


def test_eval_cli_as_two_processes_gives_one_process_results(eval_config, tmp_path):
    """tools_torch/eval_mm_protocol.py launched as a gloo group of two
    (--distributed=on, a file:// rendezvous): both exit 0 (the group is torn
    down at exit), both print one process's JSON (rel 1e-6; re-ranked), and
    process 0's submission CSV is one process's byte for byte."""
    import json

    from prcv2025reid_tpu_torch import init_train_state
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    cfg = eval_config
    model = build_model(cfg, init_params(cfg, 6, 0, perturb=True), device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), model, init_train_state(model, cfg, 1),
                    {"epoch": 1, "config": cfg.to_json(), "num_classes": 6})

    def argv(run):
        return [f"--dataset_root={cfg.data_root}", f"--model_path={tmp_path / 'ckpt' / 'latest'}",
                f"--cache_dir={tmp_path / run / 'cache'}", f"--batch_size={EVAL_BATCH}",
                "--rerank", "--rerank_top_n=5", "--rerank_k1=3", "--rerank_k2=2",
                f"--submission={tmp_path / run / 'sub.csv'}", "--topk=3"]

    spec = importlib.util.spec_from_file_location("port_eval_cli",
                                                  ROOT / "tools_torch" / "eval_mm_protocol.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    single = json.loads(json.dumps(cli.main(argv("one"), device="cpu"), default=float))
    group = [f"--distributed=on", f"--num_processes={NPROC}", "--dist_backend=gloo",
             f"--coordinator_address=file://{tmp_path / 'rdv'}"]
    procs = [subprocess.Popen([sys.executable, "-c", _EVAL_CLI, str(ROOT), *argv("two"), *group,
                               f"--process_id={r}"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(NPROC)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two eval processes timed out (deadlock?)")
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{err[-4000:]}"
        got = json.loads(out)
        assert sorted(got["detail"]) == sorted(single["detail"])
        for plan, d in single["detail"].items():
            for k, v in d.items():
                assert got["detail"][plan][k] == pytest.approx(v, rel=1e-6), (plan, k)
    assert (tmp_path / "two" / "sub.csv").read_bytes() == (tmp_path / "one" / "sub.csv").read_bytes()
