"""The port's Trainer against the JAX package's Trainer on the CPU in f32:
the same synthetic ORBench tree, the same config (``TINY_BASE`` widths,
JAX's e2e schedule of 2 epochs x 3 steps, in-process decode), the same
initial weights (the JAX Trainer's parameters and BN statistics, exported
flat and loaded into the port, whose TrainState is then made anew), both
fit for 2 epochs with an eval after each epoch and the final one.

Every rate of randomness is 0 (drop-path, both dropouts, modality dropout,
whose 3-epoch warmup keeps it off anyway): JAX's PRNG streams cannot be
reproduced in PyTorch.  The host pipelines are bit for bit the same
(``tests/test_torch_data.py``), so both steps see the same batches.

Bars: each epoch's ``total_loss``, ``ce_loss`` and ``sdm_loss`` 1e-4
relative; ``sdm_weight``, ``sdm_tau`` and ``skipped_steps`` equal; each
eval's ``map_avg2``, ``map_single`` and ``map_quad`` 1e-3; the sidecars'
``sampler``, ``sdm_scheduler`` and ``crop_relaxed`` equal, their key sets
equal, and the ``spike_detector``'s counts equal and its loss history at
the losses' bar.

An epoch's losses are held from the same state at the epoch's start: epoch
1 of the two fits starts from the same weights; epoch 2 is held on a port
trainer loaded with the JAX trainer's state after epoch 1 (parameters, BN
statistics, AdamW's moments and count, the norm history, the ring, the
sampler, the schedulers).  The two fits' own epoch 2 starts from states
that differ where AdamW took its step on a gradient within f32 rounding of
zero: such an entry moves by up to lr either way in either package
(``tests/test_torch_train.py::_step_bound``), here by 2 x 0.9 x the head's
3e-3 on one of 192 classifier entries, which moves epoch 2's mean CE by
3.6e-4.  That reading is printed with its cause, never held to a looser
bar, and a miss without such an entry fails.

For speed only, the JAX side runs on a one-device mesh, jits its model's
init, and skips its smoke test (an eager forward that changes no state);
its fit runs once for the module.  Two eval plans (single/nir and the
quad) keep JAX's per-combo compiles few.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import flax.traverse_util as tu
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from prcv2025reid_tpu_torch import Trainer, TrainingConfig, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.params import check_skipped, load_params  # noqa: E402
from prcv2025reid_tpu_torch.training.param_groups import group_learning_rates  # noqa: E402
from prcv2025reid_tpu_torch.training.param_groups import label_params, param_key  # noqa: E402

LOSS_REL = 1e-4
MAP_TOL = 1e-3
NO_RANDOMNESS = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                     modality_dropout=0.0)
TINY = {
    **TINY_BASE, **NO_RANDOMNESS,
    "num_epochs": 2, "warmup_epochs": 1, "num_ids_per_batch": 2, "instances_per_id": 2,
    "steps_per_epoch": 3, "num_workers": 0, "eval_sample_ratio": 1.0, "eval_batch_size": 4,
    "save_freq": 50, "eval_include_patterns": ("single/nir", "quad/nir+sk+cp+text"),
}


def _jitted_init(init):
    def jinit(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, **kw))(rngs, *args)
    return jinit


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


def jax_flat(state):
    return {k: np.array(v) for k, v in tu.flatten_dict(
        {"params": state.params, "batch_stats": state.batch_stats}, sep="/").items()}


def jax_opt_leaves(opt_state):
    """{(kind, param path): array} for mu and nu, and the update count,
    from JAX's optax state tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", None) or getattr(p, "key", None) for p in path]
        for kind in ("mu", "nu"):
            if kind in names:
                out[kind, "/".join(str(n) for n in names[names.index(kind) + 1:])] = \
                    np.array(leaf, np.float32)
        if names[-1] == "count":
            out["count"] = int(leaf)
    return out


def load_jax_state(trainer, snap):
    """Put the JAX trainer's state (a host copy taken before an epoch) into
    a port trainer."""
    jstate = snap["state"]
    check_skipped(load_params(trainer.model, jax_flat(jstate)))
    leaves = jax_opt_leaves(jstate.opt_state)
    names = [param_key(n) for n, p in trainer.model.named_parameters() if p.requires_grad]
    opt = trainer.state.opt_state
    trainer.state = trainer.state.replace(
        step=int(jstate.step),
        opt_state=opt.replace(
            count=torch.tensor(leaves["count"], dtype=torch.int32),
            mu=[torch.from_numpy(leaves["mu", n]) for n in names],
            nu=[torch.from_numpy(leaves["nu", n]) for n in names]),
        **{k: torch.from_numpy(np.array(getattr(jstate, k)))
           for k in ("grad_norm_hist", "grad_norm_count", "skipped_total", "metric_ring")})
    trainer.sampler.load_state_dict(snap["sampler"])
    trainer.sdm_scheduler.load_state_dict(snap["sdm_scheduler"])
    trainer.spike_detector.load_state_dict(snap["spike_detector"])


@pytest.fixture(scope="module")
def fits(orbench_root, tmp_path_factory):
    """Both trainers after fit, and epoch 2 of a port trainer started from
    the JAX trainer's state after epoch 1: (jax trainer, port trainer, jax
    result, port result, forced epoch-2 row, the port's parameters after
    epoch 1, the JAX trainer's)."""
    work = tmp_path_factory.mktemp("trainer_vs_jax")

    def dirs(side):
        return dict(save_dir=str(work / side / "ckpt"), log_dir=str(work / side / "logs"),
                    eval_cache_dir=str(work / side / "cache"))

    data = dict(data_root=orbench_root, json_file=os.path.join(orbench_root, "text_annos.json"))
    jcfg = JaxConfig(**TINY, **data, **dirs("jax"), mesh_shape=(1,))
    pcfg = port_config(jcfg, mesh_shape=(), **dirs("port"))
    jsnaps, psnaps = {}, {}
    jax_train_epoch, port_train_epoch = JaxTrainer.train_epoch, Trainer.train_epoch

    def jax_spy(self, epoch, prev=None):
        # a host copy: the jitted step donates the state's buffers
        jsnaps[epoch] = dict(state=jax.tree.map(np.array, self.state), prev=prev,
                             sampler=self.sampler.state_dict(),
                             sdm_scheduler=self.sdm_scheduler.state_dict(),
                             spike_detector=self.spike_detector.state_dict())
        return jax_train_epoch(self, epoch, prev)

    def port_spy(self, epoch, prev=None):
        psnaps[epoch] = {k: v.clone() for k, v in self.model.state_dict().items()}
        return port_train_epoch(self, epoch, prev)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", _jitted_init(JaxModel.init))
        mp.setattr(JaxTrainer, "smoke_test", lambda self: None)
        mp.setattr(JaxTrainer, "train_epoch", jax_spy)
        mp.setattr(Trainer, "train_epoch", port_spy)
        jtrainer = JaxTrainer(jcfg)
        ptrainer = Trainer(pcfg, device="cpu")
        check_skipped(load_params(ptrainer.model, jax_flat(jtrainer.state)))
        ptrainer.state = init_train_state(ptrainer.model, pcfg, len(ptrainer.sampler),
                                          seed=pcfg.seed + 1)
        jresult = jtrainer.fit()
        presult = ptrainer.fit()
    forced = Trainer(port_config(jcfg, mesh_shape=(), **dirs("forced")), device="cpu")
    load_jax_state(forced, jsnaps[2])
    forced_row = forced.train_epoch(2, jsnaps[2]["prev"])
    return (jtrainer, ptrainer, jresult, presult, forced_row, psnaps[2],
            jax_flat(jsnaps[2]["state"]))


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def assert_losses(got, want, what):
    for k in ("total_loss", "ce_loss", "sdm_loss"):
        assert rel(got[k], want[k]) <= LOSS_REL or got[k] == want[k] == 0.0, (
            what, k, got[k], want[k])


def test_epoch_losses_and_schedules_match_jax(fits):
    jtrainer, ptrainer, _, _, forced_row, port_after_1, jax_after_1 = fits
    jrows, prows = jtrainer.train_history.rows, ptrainer.train_history.rows
    assert [r["epoch"] for r in prows] == [r["epoch"] for r in jrows] == [1, 2]
    for jr, pr in zip(jrows, prows):
        assert sorted(pr) == sorted(jr)
        for k in ("sdm_weight", "sdm_tau", "skipped_steps", "steps"):
            assert pr[k] == jr[k], (k, pr[k], jr[k])
    # epoch 1 from the same weights; epoch 2 from JAX's state after epoch 1
    assert_losses(prows[0], jrows[0], "epoch 1")
    assert_losses(forced_row, jrows[1], "epoch 2 from JAX's state")
    for k in ("sdm_weight", "sdm_tau", "skipped_steps", "steps", "stability_score"):
        assert forced_row[k] == jrows[1][k], k
    assert prows[1]["sdm_loss"] > 0.0  # the SDM term is on in epoch 2

    # the fits' own epoch 2: printed; a miss must have its cause, entries
    # where the packages' AdamW steps went opposite ways (off by more than
    # the group's lr after epoch 1), and none off by more than AdamW can
    # move an entry in an epoch's steps (1.05 lr a step, _step_bound)
    readings = {k: rel(prows[1][k], jrows[1][k]) for k in ("total_loss", "ce_loss", "sdm_loss")}
    off, worst = opposite_steps(ptrainer, port_after_1, jax_after_1)
    print(f"the fits' epoch 2 against JAX's, relative: {readings}; entries whose AdamW step "
          f"went the other way in epoch 1 (count by leaf): {off}; the largest difference "
          f"in lr: {worst:.3f}")
    if max(readings.values()) > LOSS_REL:
        assert off, "epoch 2 misses the bar with no opposite AdamW step to explain it"
    assert worst <= 2 * 1.05 * ptrainer.config.steps_per_epoch


def opposite_steps(ptrainer, port_params, jax_flat_params):
    """({leaf: entries off JAX's by more than the group's lr}, the largest
    difference of any entry in units of its group's lr)."""
    lrs = group_learning_rates(ptrainer.config)
    off, worst = {}, 0.0
    for name, group in label_params(ptrainer.model, ptrainer.config).items():
        if group == "frozen":
            continue
        err = np.abs(port_params[name].numpy() - jax_flat_params["params/" + param_key(name)])
        worst = max(worst, float(err.max()) / lrs[group])
        if (err > lrs[group]).any():
            off[name] = int((err > lrs[group]).sum())
    return off, worst


def test_evals_match_jax(fits):
    jtrainer, ptrainer, jresult, presult = fits[:4]
    jevals = jtrainer.eval_history.rows + [jresult["final"]]
    pevals = ptrainer.eval_history.rows + [presult["final"]]
    assert len(pevals) == len(jevals) == 3
    for je, pe in zip(jevals, pevals):
        for k in ("map_avg2", "map_single", "map_quad"):
            # on a miss, say whether the ranking sat on a near-tie
            assert abs(pe[k] - je[k]) <= MAP_TOL, (
                f"{k}: port {pe[k]} vs JAX {je[k]}; cmc1 {pe.get('cmc1')} vs {je.get('cmc1')}")
    assert presult["best_map"] == pytest.approx(jresult["best_map"], abs=MAP_TOL)


def test_sidecars_match_jax(fits):
    jtrainer, ptrainer = fits[:2]

    def sidecar(trainer):
        path = os.path.join(trainer.config.save_dir, "latest", "host_state.json")
        with open(path) as f:
            return json.load(f)

    jhost, phost = sidecar(jtrainer), sidecar(ptrainer)
    assert sorted(phost) == sorted(jhost)
    for k in ("epoch", "sampler", "sdm_scheduler", "crop_relaxed", "num_classes", "ring_shapes"):
        assert phost[k] == jhost[k], k
    js, ps = jhost["spike_detector"], phost["spike_detector"]
    assert (ps["spikes"], ps["batches"]) == (js["spikes"], js["batches"])
    # one loss a step: epoch 1's at the losses' bar; epoch 2's are the fits'
    # own epoch 2 (see test_epoch_losses_and_schedules_match_jax)
    n = ptrainer.config.steps_per_epoch
    np.testing.assert_allclose(ps["history"][:n], js["history"][:n], rtol=LOSS_REL)
    print("spike history, the fits' epoch 2, relative:",
          np.abs(np.subtract(ps["history"][n:], js["history"][n:])) / np.abs(js["history"][n:]))
    # the recorded configs agree but for the directories and the mesh
    want = {k: v for k, v in json.loads(jhost["config"]).items()
            if k not in ("save_dir", "log_dir", "eval_cache_dir", "mesh_shape")}
    got = {k: v for k, v in json.loads(phost["config"]).items() if k in want}
    assert got == want
