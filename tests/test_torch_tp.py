"""Tensor parallelism (``parallel/tp.py``: Megatron column and row shards
over the model axis of a 2-D ``('data', 'model')`` mesh), on the CPU at the
tiny widths in f32: the counterparts of JAX's ``tests/test_tensor_parallel.py``
against JAX's rules and its ``(4, 2)`` step on the 8-device virtual CPU mesh,
and against the port's one process.

Two gloo groups (``groups``, module scope), of 2 processes on the ``(1, 2)``
mesh and of 4 on the ``(2, 2)`` mesh, each process a child script that
imports the port only, compute everything that needs a group from inputs
this process writes, and write their results; the tests hold them here:

- the global-batch step (``tools_torch/dp_dryrun.py``'s 3 steps of a seeded
  4 x 2 batch, the model sharded by ``shard_state``): with no randomness its
  metrics against JAX's TP step on its ``(4, 2)`` mesh (rtol 1e-4, atol
  1e-5, JAX's bound); with and without drop-path against the port's one
  process (the same bound; every gathered leaf and moment within rtol 2e-4,
  atol 2e-5, JAX's bound for its parameters); the ``lora_A`` and ``lora_B``
  gradients of step 1 against one process's (the same bound: a gradient
  summed over the model group twice, or not at all, is off by a factor);
- parameters and AdamW moments really sharded;
- the eval embed against one process under ``xla`` (a vision combo and a
  text combo), the fused-stream trunk and ``block_impl="fused"``, and an
  attention layer whose heads the model size does not divide;
- ``sharded_topk`` on the 2-D mesh, exact;
- the ``(1, 2)`` checkpoint against one process's, loading in one process,
  and a one-process checkpoint resumed under tensor parallelism;
- the mesh from the config and its indivisible model axis.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel
from prcv2025reid_tpu.parallel import mesh as jax_mesh
from prcv2025reid_tpu.parallel import tp as jax_tp
from prcv2025reid_tpu.training import param_groups as jpg
from prcv2025reid_tpu.training.train_step import TrainState as JaxTrainState
from prcv2025reid_tpu.training.train_step import make_train_step as jax_make_train_step
from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
from prcv2025reid_tpu_torch.configs import apply_cli_overrides
from prcv2025reid_tpu_torch.params import init_params
from prcv2025reid_tpu_torch.parallel import mesh, tp
from prcv2025reid_tpu_torch.parallel.ranking import topk_reference

ROOT = Path(__file__).resolve().parent.parent
GROUPS = {"1x2": (1, 2), "2x2": (2, 2)}
GROUP_TIMEOUT = 420  # seconds, as the data-parallel groups'
NO_RANDOMNESS = ["--set", "drop_path=0", "--set", "dropout_rate=0", "--set", "fusion_dropout=0",
                 "--set", "sdm_dropout=0", "--set", "modality_dropout=0"]
STEP_CASES = {"jax": NO_RANDOMNESS, "drop_path_0.1": []}  # the tool's drop-path: 0.1
EMBED_PATHS = {"xla": ({}, ("vis",)), "xla_text": ({}, ("nir", "text")),
               "fused_trunk": ({"use_pallas_attention": True, "use_fused_mlp": True,
                                "use_fused_resln": True}, ("vis",)),
               "fused": ({"block_impl": "fused"}, ("vis",)),
               # 3 heads of 22: the model size 2 divides the width, not the heads
               "heads_fallback": ({"vision_hidden_dim": 66, "vision_heads": 3}, ("vis",))}
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)  # JAX's bounds: metrics, then parameters
LEAF_TOL = dict(rtol=2e-4, atol=2e-5)


def _tool():
    spec = importlib.util.spec_from_file_location("port_dp_dryrun",
                                                  ROOT / "tools_torch" / "dp_dryrun.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _args(tool, case):
    return tool.build_parser().parse_args(["--cpu", *STEP_CASES[case]])


def _embed_inputs(cfg, mods):
    rng = np.random.default_rng(5)
    B, Mv = 6, len(cfg.vision_modalities)
    images = rng.integers(0, 256, (B, Mv, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    tokens = np.zeros((B, cfg.text_context_length), np.int32)
    tokens[:, 0], tokens[:, 1:5] = cfg.text_vocab_size - 2, rng.integers(1, 90, (B, 4))
    tokens[:, 5] = cfg.text_vocab_size - 1
    return (images, np.ones((B, Mv), np.float32), tokens, np.ones(B, np.float32))


_CHILD = r"""
import importlib.util, os, pickle, sys
from argparse import Namespace
root, out = sys.argv[1], sys.argv[2]
rank, nproc, m = (int(v) for v in sys.argv[3:6])
sys.path.insert(0, root)
from prcv2025reid_tpu_torch.utils import distributed
distributed.initialize_from_config(Namespace(
    distributed="on", num_processes=nproc, process_id=rank,
    coordinator_address=f"file://{out}/rdv"), backend="gloo")
import torch
torch.set_num_threads(1)  # tiny shapes: threads would only contend with the other processes
from prcv2025reid_tpu_torch import (TrainingConfig, build_model, init_train_state,
                                    make_combo_embed_step, make_train_step)
from prcv2025reid_tpu_torch.params import init_params
from prcv2025reid_tpu_torch.parallel import tp
from prcv2025reid_tpu_torch.parallel.mesh import create_mesh, shard_batch
from prcv2025reid_tpu_torch.parallel.ranking import sharded_topk
from prcv2025reid_tpu_torch.training import checkpoint

with open(f"{out}/../inputs.pkl", "rb") as f:
    inputs = pickle.load(f)
mesh = create_mesh(model_axis_size=m)
d = nproc // m
res = {"mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank, mesh.axis_names),
       "steps": {}, "embed": {}}
cfg2d = TrainingConfig(mesh_shape=(d, m), mesh_axis_names=("data", "model"))
res["mesh_from_config"] = create_mesh(cfg2d) == mesh
try:
    create_mesh(model_axis_size=3)
    res["indivisible_raises"] = False
except ValueError:
    res["indivisible_raises"] = True

spec = importlib.util.spec_from_file_location("dp", os.path.join(root, "tools_torch",
                                                                  "dp_dryrun.py"))
dp = importlib.util.module_from_spec(spec)
spec.loader.exec_module(dp)
for case, argv in inputs["steps"].items():
    args = dp.build_parser().parse_args(argv)
    cfg = dp.build_config(args)
    P, K = dp.size(args, "pk")
    model = dp._model(args, cfg, torch.device("cpu"))
    state = tp.shard_state(
        model, init_train_state(model, cfg, dp.STEPS_PER_EPOCH, seed=dp.SEED + 1), mesh)
    step = make_train_step(model, cfg, dp.STEPS_PER_EPOCH, mesh=mesh)
    names = tp.trainable_names(model)
    metrics = []
    for s in range(dp.STEPS):
        b = shard_batch(dp.global_batch(cfg, P, K, seed=100 + s), mesh)
        if s == 0:
            grads = step.grads(state, b, dp.SDM_WEIGHT, dp.SDM_TAU, True)[-1]
            grads = dict(zip(names, (g.clone() for g in tp.full_list(model, grads))))
        state, mm = step(state, b, dp.SDM_WEIGHT, dp.SDM_TAU, enable_modality_dropout=True)
        metrics.append({k: float(v) for k, v in mm.items()})
    opt = state.opt_state
    whole = {"model": tp.full_state_dict(model),
             "mu": dict(zip(names, tp.full_list(model, opt.mu))),
             "nu": dict(zip(names, tp.full_list(model, opt.nu)))}
    res["steps"][case] = {
        "metrics": metrics, "lora_grads": {n: g for n, g in grads.items() if "lora_" in n},
        "whole": whole if rank == 0 else None,
        "plan": dict(model.tp_plan), "partial": sorted(model.tp_partial),
        "local_shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()},
        "mu_shapes": {n: tuple(t.shape) for n, t in zip(names, opt.mu)},
        "replicated": {k: v.clone() for k, v in model.state_dict().items()
                       if k not in model.tp_plan}}

for name, (over, mods) in inputs["embed"].items():
    cfg = TrainingConfig.from_json(inputs["tiny"]).replace(**over)
    model = build_model(cfg, init_params(cfg, 4, 0, perturb=True), device="cpu")
    tp.shard_variables(model, mesh)
    args = inputs["embed_inputs"][name]
    res["embed"][name] = {"feats": make_combo_embed_step(model, mods)(*args).numpy(),
                          "plan": sorted(model.tp_plan)}

q, g, k = inputs["ranking"]
s, i = sharded_topk(q, g, k, mesh, device="cpu")
res["topk"] = (s.numpy(), i.numpy())

if nproc == 2:  # the checkpoints, on the (1, 2) mesh
    cfg = TrainingConfig.from_json(inputs["tiny"])
    model = build_model(cfg, init_params(cfg, 4, 0, perturb=True), device="cpu")
    state = tp.shard_state(model, init_train_state(model, cfg, 10, seed=1), mesh)
    checkpoint.save_checkpoint(f"{out}/ckpt_tp", model, state, {"epoch": 1,
                               "config": cfg.to_json(), "num_classes": 4})
    # a one-process checkpoint (written by the test) resumed under the model axis
    restored, _ = checkpoint.restore_checkpoint(inputs["one_ckpt"], model, state)
    opt = restored.opt_state
    res["resumed"] = {"model": tp.full_state_dict(model), "mu": tp.full_list(model, opt.mu),
                      "nu": tp.full_list(model, opt.nu), "step": restored.step,
                      "local_fc1": tuple(model.encoder.vision.block_0.mlp.fc1.shared.kernel.shape)}
with open(f"{out}/rank{rank}.pkl", "wb") as f:
    pickle.dump(res, f)
torch.distributed.destroy_process_group()
print(f"CHILD-OK {rank}")
"""


def _tiny():
    tool = _tool()
    return TrainingConfig(**tool.TINY)


def _one_process_checkpoint(directory):
    """A one-process checkpoint of the tiny model after one step, so its
    moments are not zero: -> its state.pt."""
    from prcv2025reid_tpu_torch import init_train_state, make_train_step
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    tool = _tool()
    cfg = _tiny()
    model = build_model(cfg, init_params(cfg, 4, 0, perturb=True), device="cpu")
    state = init_train_state(model, cfg, 10, seed=1)
    state, _ = make_train_step(model, cfg, 10)(state, tool.global_batch(cfg, 4, 2, seed=3),
                                               0.1, 0.18)
    save_checkpoint(str(directory), model, state, {"epoch": 1, "config": cfg.to_json(),
                                                   "num_classes": 4})
    return torch.load(os.path.join(directory, "latest", "state.pt"), weights_only=True)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Run both groups at once: -> {group: (its directory, each process's
    results)}, the inputs, the one-process checkpoint's state."""
    base = tmp_path_factory.mktemp("tp_groups")
    tiny = _tiny()
    rng = np.random.default_rng(0)
    one_state = _one_process_checkpoint(base / "one")
    inputs = {
        "steps": {case: ["--cpu", *argv] for case, argv in STEP_CASES.items()},
        "tiny": tiny.to_json(),
        "embed": EMBED_PATHS,
        "embed_inputs": {n: _embed_inputs(tiny.replace(**o), mods)
                         for n, (o, mods) in EMBED_PATHS.items()},
        "ranking": (rng.normal(size=(6, 16)).astype(np.float32),
                    rng.normal(size=(40, 16)).astype(np.float32), 10),
        "one_ckpt": str(base / "one"),
    }
    with open(base / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    (base / "child.py").write_text(_CHILD)
    procs = {}
    for name, (d, m) in GROUPS.items():
        out = base / name
        out.mkdir()
        procs[name] = [subprocess.Popen(
            [sys.executable, str(base / "child.py"), str(ROOT), str(out), str(r), str(d * m),
             str(m)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(d * m)]
    results = {}
    for name, ps in procs.items():
        outs = []
        for p in ps:
            try:
                outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                pytest.fail(f"the {name} group timed out (deadlock?)")
        for r, (p, text) in enumerate(zip(ps, outs)):
            assert p.returncode == 0 and f"CHILD-OK {r}" in text, f"{name} {r}:\n{text[-4000:]}"
        res = []
        for r in range(len(ps)):
            with open(base / name / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
        results[name] = (base / name, res)
    return results, inputs, one_state


# ---- the partition rules, one process


def _jax_variables(cfg):
    flat = init_params(cfg, 4, 0, perturb=True)
    return tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


class TestPartitionSpecRules:
    def test_vision_mer_projections(self):
        cfg = _tiny()
        variables = _jax_variables(cfg)
        want = {"params/" + "/".join(str(k.key) for k in path): tuple(spec)
                for path, spec in jax.tree_util.tree_flatten_with_path(
                    jax_tp.tree_partition_specs(variables["params"], model_size=2),
                    is_leaf=lambda x: isinstance(x, P))[0]}
        flat = {k: v for k, v in init_params(cfg, 4, 0).items() if k.startswith("params/")}
        got = tp.tree_partition_specs(flat, model_size=2)
        assert got == want  # leaf for leaf
        # and the port's state-dict names give the same specs
        model = build_model(cfg, init_params(cfg, 4, 0), device="cpu")
        named = tp.tree_partition_specs(dict(model.named_parameters()), model_size=2)
        assert {f"params/{k.replace('.', '/')}": s for k, s in named.items()} == want
        for k, s in got.items():
            if k.endswith("attn/q_proj/shared/kernel") or k.endswith("mlp/fc1/shared/kernel"):
                assert s == (None, "model"), k
            if k.endswith("attn/out_proj/shared/kernel") or k.endswith("mlp/fc2/shared/kernel"):
                assert s == ("model", None), k
            if "fc1" in k and k.endswith("lora_B"):
                assert s == (None, None, "model"), k
            if "fc2" in k and k.endswith("lora_A"):
                assert s == (None, "model", None), k
            if ("fc1" in k and k.endswith("lora_A")) or "ln1" in k or "patch_embed" in k:
                assert s == (), k
        assert sum(1 for s in got.values() if s) >= 8

    def test_indivisible_dims_fall_back_to_replicated(self):
        cfg = _tiny()
        flat = {k: v for k, v in init_params(cfg, 4, 0).items() if k.startswith("params/")}
        # 7 divides none of the tiny dims -> all replicated, as JAX's
        assert set(tp.tree_partition_specs(flat, model_size=7).values()) == {()}
        specs = jax_tp.tree_partition_specs(_jax_variables(cfg)["params"], model_size=7)
        assert all(s == P() for s in jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, P)))


# ---- the mesh, one process


class TestMeshCreation:
    def test_one_process_2d_mesh_and_indivisible_model_axis(self):
        m = mesh.create_mesh(TrainingConfig(mesh_shape=(1, 1), mesh_axis_names=("data", "model")))
        assert (m.size, m.model_size, m.axis_names) == (1, 1, ("data", "model"))
        with pytest.raises(ValueError, match="does not divide"):
            mesh.create_mesh(model_axis_size=3)  # one process, as JAX's 8 % 3
        with pytest.raises(ValueError, match="mesh_shape=\\(d, m\\)"):
            mesh.create_mesh(TrainingConfig(mesh_axis_names=("data", "model")))

    def test_padding_over_the_data_axis_only(self):
        """JAX shrinks the data axis to divide a batch of 6 on a (4, 2) mesh;
        the port pads over the data axis alone: the two processes of a model
        group take the same rows, and only the data size pads."""
        from prcv2025reid_tpu_torch.data.pipeline import HostPipeline

        def local(r, j, d, m):
            pipe = HostPipeline.__new__(HostPipeline)
            grid = mesh.Mesh(size=d, rank=r, axis_names=("data", "model"), model_size=m,
                             model_rank=j)
            pipe.process_index, pipe.process_count = grid.rank, grid.size
            return pipe._local_slice(list(range(6)))

        for j in range(2):  # the model index changes nothing
            assert [local(r, j, 2, 2) for r in range(2)] == [([0, 1, 2], 3, 3), ([3, 4, 5], 3, 3)]
        # 4 data indices: per 2, the last holds only padding (n_real 0)
        assert [local(r, 0, 4, 2)[1:] for r in range(4)] == [(2, 2), (2, 2), (2, 2), (2, 0)]
        assert mesh.process_local_indices(6, 1, 2) == slice(3, 6)

    def test_cli_mesh_shape_parses_ints(self):
        cfg = apply_cli_overrides(_tiny(), ["--mesh_shape=4,2", "--mesh_axis_names=data,model"])
        assert cfg.mesh_shape == (4, 2) and all(isinstance(v, int) for v in cfg.mesh_shape)
        assert cfg.mesh_axis_names == ("data", "model")


# ---- the groups


@pytest.mark.parametrize("name", list(GROUPS))
def test_2d_mesh_from_config(name, groups):
    results, _, _ = groups
    d, m = GROUPS[name]
    for r, res in enumerate(results[name][1]):
        assert res["mesh"] == (d, r // m, m, r % m, ("data", "model"))
        assert res["mesh_from_config"] and res["indivisible_raises"]


@pytest.fixture(scope="module")
def jax_tp_metrics():
    """JAX's train step on its (4, 2) tensor-parallel mesh, from
    init_params' state, over the tool's global batches (no randomness)."""
    tool = _tool()
    args = _args(tool, "jax")
    cfg = tool.build_config(args)
    P_, K = tool.size(args, "pk")
    jcfg = JaxConfig.from_json(cfg.to_json())
    variables = _jax_variables(cfg)
    tx = jpg.build_optimizer(jcfg, variables["params"], 10)
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                 jax.random.PRNGKey(1), ring_size=10,
                                 clip_window=jcfg.adaptive_clip_window)
    m42 = jax_mesh.create_mesh(model_axis_size=2)
    assert m42.devices.shape == (4, 2)
    state = jax_tp.shard_state(state, m42)
    step = jax_make_train_step(JaxModel(config=jcfg, num_classes=P_), tx, jcfg)
    out = []
    for s in range(tool.STEPS):
        b = jax_mesh.shard_batch(tool.global_batch(cfg, P_, K, seed=100 + s), m42)
        state, mm = step(state, b, jnp.float32(0.1), jnp.float32(0.18), True)
        out.append({k: float(v) for k, v in mm.items()})
    return out


@pytest.fixture(scope="module")
def one_process():
    """The port's one process on each step case: -> {case: (metrics, state
    dict, moments by name, step-1 gradients by name)}."""
    from prcv2025reid_tpu_torch import init_train_state, make_train_step

    tool = _tool()
    out = {}
    for case in STEP_CASES:
        args = _args(tool, case)
        cfg = tool.build_config(args)
        P_, K = tool.size(args, "pk")
        model = tool._model(args, cfg, torch.device("cpu"))
        state = init_train_state(model, cfg, tool.STEPS_PER_EPOCH, seed=tool.SEED + 1)
        step = make_train_step(model, cfg, tool.STEPS_PER_EPOCH)
        names = tp.trainable_names(model)
        metrics = []
        for s in range(tool.STEPS):
            b = tool.global_batch(cfg, P_, K, seed=100 + s)
            if s == 0:
                grads = dict(zip(names, step.grads(state, b, tool.SDM_WEIGHT, tool.SDM_TAU,
                                                   True)[-1]))
            state, mm = step(state, b, tool.SDM_WEIGHT, tool.SDM_TAU, enable_modality_dropout=True)
            metrics.append({k: float(v) for k, v in mm.items()})
        opt = state.opt_state
        out[case] = (metrics, model.state_dict(), {"mu": dict(zip(names, opt.mu)),
                                                   "nu": dict(zip(names, opt.nu))}, grads)
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=what, **tol)


@pytest.mark.parametrize("name", list(GROUPS))
def test_step_matches_jax_tp_step(name, groups, jax_tp_metrics):
    results, _, _ = groups
    want = jax_tp_metrics
    for res in results[name][1]:
        for s, (g, w) in enumerate(zip(res["steps"]["jax"]["metrics"], want)):
            assert sorted(g) == sorted(w)
            for k in w:
                _close(g[k], w[k], METRIC_TOL, f"step {s + 1} {k}")


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("name", list(GROUPS))
def test_step_equals_one_process(name, case, groups, one_process):
    """Metrics, every gathered leaf and AdamW moment after 3 steps, against
    one process; the replicated leaves the same bits on every process."""
    results, _, _ = groups
    metrics, sd, moments, _ = one_process[case]
    res = results[name][1]
    for r in res:
        for s, (g, w) in enumerate(zip(r["steps"][case]["metrics"], metrics)):
            for k, v in w.items():
                _close(g[k], v, METRIC_TOL, f"step {s + 1} {k}")
    whole = res[0]["steps"][case]["whole"]
    assert set(whole["model"]) == set(sd)
    for k, v in sd.items():
        _close(whole["model"][k], v, LEAF_TOL, k)
    for part in ("mu", "nu"):
        for n, v in moments[part].items():
            _close(whole[part][n], v, LEAF_TOL, f"{part} {n}")
    first = res[0]["steps"][case]["replicated"]
    for r in res[1:]:
        assert all(torch.equal(v, first[k]) for k, v in r["steps"][case]["replicated"].items())


@pytest.mark.parametrize("name", list(GROUPS))
def test_lora_grads_match_one_process(name, groups, one_process):
    """Step 1's LoRA gradients: the replicated legs whose gradients are
    partial sums (column lora_A, row lora_B) are summed over the model
    group once, and the others not at all."""
    results, _, _ = groups
    _, _, _, grads = one_process["jax"]
    lora = {n: g for n, g in grads.items() if "lora_" in n}
    assert len(lora) >= 16
    for r in results[name][1]:
        got = r["steps"]["jax"]["lora_grads"]
        assert set(got) == set(lora)
        for n, g in lora.items():
            _close(got[n], g, LEAF_TOL, n)
    partial = results[name][1][0]["steps"]["jax"]["partial"]
    assert partial and all(n.endswith((".lora_A", ".lora_B")) for n in partial)
    assert all(("fc1" in n or "q_proj" in n or "k_proj" in n or "v_proj" in n)
               == n.endswith("lora_A") for n in partial)


@pytest.mark.parametrize("name", list(GROUPS))
def test_params_and_moments_actually_sharded(name, groups):
    results, _, _ = groups
    one = _tiny()
    D, F = one.vision_hidden_dim, one.vision_mlp_dim
    for r in results[name][1]:
        st = r["steps"]["jax"]
        shapes, plan = st["local_shapes"], st["plan"]
        assert shapes["encoder.vision.block_0.mlp.fc1.shared.kernel"] == (D, F // 2)
        assert shapes["encoder.vision.block_0.mlp.fc2.shared.kernel"] == (F // 2, D)
        assert shapes["encoder.vision.block_0.attn.q_proj.shared.kernel"] == (D, D // 2)
        assert shapes["encoder.text.block_0.fc1.kernel"][1] == one.text_mlp_dim // 2
        assert len(plan) >= 8
        sharded_mu = [n for n, s in st["mu_shapes"].items() if n in plan]
        assert len(sharded_mu) >= 8
        for n in sharded_mu:
            assert st["mu_shapes"][n] == shapes[n]


@pytest.fixture(scope="module")
def one_process_embeds(groups):
    _, inputs, _ = groups
    out = {}
    tiny = _tiny()
    for name, (over, mods) in EMBED_PATHS.items():
        cfg = tiny.replace(**over)
        model = build_model(cfg, init_params(cfg, 4, 0, perturb=True), device="cpu")
        out[name] = make_combo_embed_step(model, mods)(*inputs["embed_inputs"][name]).numpy()
    return out


@pytest.mark.parametrize("path", [p for p in EMBED_PATHS if p != "heads_fallback"])
@pytest.mark.parametrize("name", list(GROUPS))
def test_eval_embed_matches_one_process(name, path, groups, one_process_embeds):
    results, _, _ = groups
    for r in results[name][1]:
        got = r["embed"][path]
        _close(got["feats"], one_process_embeds[path], METRIC_TOL, path)
        assert any("attn.q_proj" in k for k in got["plan"])


def test_heads_the_model_size_does_not_divide_stay_replicated(groups, one_process_embeds):
    """3 heads over 2 processes: JAX may split a head, the port's local-heads
    core cannot, so that attention's projections stay whole (its MLP is
    sharded) and the embed is one process's."""
    results, _, _ = groups
    for r in results["1x2"][1]:
        got = r["embed"]["heads_fallback"]
        assert not any(".attn." in k for k in got["plan"])
        assert any(".mlp.fc1." in k for k in got["plan"])
        _close(got["feats"], one_process_embeds["heads_fallback"], METRIC_TOL, "heads_fallback")
    cfg = _tiny().replace(**EMBED_PATHS["heads_fallback"][0])
    flat = {k: v for k, v in init_params(cfg, 4, 0).items() if k.startswith("params/")}
    specs = tp.tree_partition_specs(flat, model_size=2)
    assert specs["params/encoder/vision/block_0/attn/q_proj/shared/kernel"] == (None, "model")


@pytest.mark.parametrize("name", list(GROUPS))
def test_sharded_topk_on_the_2d_mesh(name, groups):
    results, inputs, _ = groups
    q, g, k = inputs["ranking"]
    ref_scores, ref_idx = topk_reference(q, g, k)
    for r in results[name][1]:
        scores, idx = r["topk"]
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_allclose(scores, ref_scores, rtol=1e-5)


def test_tp_checkpoint_equals_one_process_and_loads_in_one_process(groups, tmp_path):
    """Process 0 writes the one-process layout: the (1, 2) checkpoint of a
    sharded init state equals a one-process save of it tensor for tensor,
    and the eval model loads from it in one process."""
    from prcv2025reid_tpu_torch import engine, init_train_state
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    results, _, _ = groups
    out = results["1x2"][0]
    cfg = _tiny()
    model = build_model(cfg, init_params(cfg, 4, 0, perturb=True), device="cpu")
    save_checkpoint(str(tmp_path), model, init_train_state(model, cfg, 10, seed=1),
                    {"epoch": 1, "config": cfg.to_json(), "num_classes": 4})
    want = torch.load(tmp_path / "latest" / "state.pt", weights_only=True)
    got = torch.load(out / "ckpt_tp" / "latest" / "state.pt", weights_only=True)
    assert set(got["model"]) == set(want["model"])
    assert all(torch.equal(got["model"][k], v) for k, v in want["model"].items())
    for part in ("mu", "nu"):
        assert len(got["opt_state"][part]) == len(want["opt_state"][part])
        assert all(torch.equal(a, b) for a, b in zip(got["opt_state"][part],
                                                     want["opt_state"][part]))
    _, loaded, _, _ = engine.load_checkpoint_model(str(out / "ckpt_tp" / "latest"), "cpu")
    assert all(torch.equal(v, want["model"][k]) for k, v in loaded.state_dict().items())


def test_one_process_checkpoint_resumes_under_tp(groups):
    results, _, one_state = groups
    for r in results["1x2"][1]:
        got = r["resumed"]
        assert got["local_fc1"][1] * 2 == one_state["model"][
            "encoder.vision.block_0.mlp.fc1.shared.kernel"].shape[1]
        assert got["step"] == one_state["step"]
        assert all(torch.equal(got["model"][k], v) for k, v in one_state["model"].items())
        for part in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(got[part], one_state["opt_state"][part]))


# ---- the training command line as a (1, 2) group

_TRAIN_CLI = r"""
import runpy, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
torch.set_num_threads(1)  # tiny shapes: threads would only contend with the other process
runpy.run_path(root + "/tools_torch/train.py", run_name="train_cli")["main"](
    sys.argv[2:], device="cpu")
"""


def test_train_cli_as_two_processes_on_the_model_axis(orbench_root, tmp_path):
    """tools_torch/train.py as a gloo group of two with --mesh_shape=1,2
    --mesh_axis_names=data,model: both exit 0, process 0 alone writes the
    log, the histories and latest/, whose state loads in one process, and
    the epoch's losses are one process's (rel 1e-4)."""
    import csv

    from prcv2025reid_tpu_torch import engine

    tool = _tool()
    widths = [f"--{k}={v}" for k, v in tool.TINY.items() if k not in ("num_epochs",)]

    def argv(run):
        return [f"--data_root={orbench_root}", f"--json_file={orbench_root}/text_annos.json",
                *widths, "--num_workers=0", "--num_epochs=1", "--steps_per_epoch=2",
                "--num_ids_per_batch=2", "--instances_per_id=2", "--eval_batch_size=4",
                "--do_eval=false", f"--save_dir={tmp_path / run / 'ckpt'}",
                f"--log_dir={tmp_path / run / 'logs'}", f"--eval_cache_dir={tmp_path / run / 'c'}"]

    spec = importlib.util.spec_from_file_location("port_train_cli",
                                                  ROOT / "tools_torch" / "train.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cli.main(argv("one"), device="cpu")
    group = ["--distributed=on", "--num_processes=2", "--dist_backend=gloo",
             f"--coordinator_address=file://{tmp_path / 'rdv'}", "--mesh_shape=1,2",
             "--mesh_axis_names=data,model"]
    procs = [subprocess.Popen([sys.executable, "-c", _TRAIN_CLI, str(ROOT), *argv("two"),
                               *group, f"--process_id={r}"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two train processes timed out (deadlock?)")
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r}:\n{text[-4000:]}"
    log = (tmp_path / "two" / "logs" / "training.log").read_text()
    assert "process 0 of 2" in log and "process 1 of 2" not in log
    assert sorted(os.listdir(tmp_path / "two" / "ckpt")) == ["latest"]

    def rows(run):
        with open(tmp_path / run / "logs" / "train_history.csv") as f:
            return list(csv.DictReader(f))

    one, two = rows("one"), rows("two")
    assert len(one) == len(two) == 1
    for k in ("total_loss", "ce_loss", "sdm_loss"):
        _close(float(two[0][k]), float(one[0][k]), METRIC_TOL, k)
    _, loaded, _, host = engine.load_checkpoint_model(str(tmp_path / "two" / "ckpt" / "latest"),
                                                      "cpu")
    _, ref, _, _ = engine.load_checkpoint_model(str(tmp_path / "one" / "ckpt" / "latest"), "cpu")
    cfg = json.loads(host["config"])
    assert cfg["mesh_shape"] == [1, 2] and cfg["mesh_axis_names"] == ["data", "model"]
    ref_sd = ref.state_dict()
    for k, v in loaded.state_dict().items():
        _close(v, ref_sd[k], LEAF_TOL, k)


_EVAL_CLI = r"""
import runpy, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
torch.set_num_threads(1)  # tiny shapes: threads would only contend with the other process
runpy.run_path(root + "/tools_torch/eval_mm_protocol.py", run_name="eval_cli")["main"](
    sys.argv[2:], device="cpu")
"""


def test_eval_cli_as_two_processes_on_the_model_axis(orbench_root, tmp_path):
    """tools_torch/eval_mm_protocol.py as a gloo group of two with
    --mesh_shape=1,2 --mesh_axis_names=data,model: both print one process's
    JSON (rel 1e-6) and process 0's submission CSV is one process's, byte
    for byte."""
    from prcv2025reid_tpu_torch import init_train_state
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    cfg = _tiny().replace(data_root=orbench_root,
                          json_file=os.path.join(orbench_root, "text_annos.json"))
    model = build_model(cfg, init_params(cfg, 6, 0, perturb=True), device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), model, init_train_state(model, cfg, 1),
                    {"epoch": 1, "config": cfg.to_json(), "num_classes": 6})

    def argv(run):
        return [f"--dataset_root={orbench_root}", f"--model_path={tmp_path / 'ckpt' / 'latest'}",
                f"--cache_dir={tmp_path / run / 'cache'}", "--batch_size=8", "--topk=3",
                f"--submission={tmp_path / run / 'sub.csv'}"]

    spec = importlib.util.spec_from_file_location("port_eval_cli",
                                                  ROOT / "tools_torch" / "eval_mm_protocol.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    single = json.loads(json.dumps(cli.main(argv("one"), device="cpu"), default=float))
    group = ["--distributed=on", "--num_processes=2", "--dist_backend=gloo",
             f"--coordinator_address=file://{tmp_path / 'rdv'}", "--mesh_shape=1,2",
             "--mesh_axis_names=data,model"]
    procs = [subprocess.Popen([sys.executable, "-c", _EVAL_CLI, str(ROOT), *argv("two"), *group,
                               f"--process_id={r}"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
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
        for k, v in single.items():
            if k != "detail":
                assert got[k] == pytest.approx(v, rel=1e-6), k
    assert (tmp_path / "two" / "sub.csv").read_bytes() == (
        tmp_path / "one" / "sub.csv").read_bytes()
