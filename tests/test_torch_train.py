"""The port's training step against the JAX package's, on the CPU in f32.

One JAX ``MultiModalReIDModel`` at the tiny widths of ``TINY_BASE``, its
lora_B, biases and BN statistics perturbed, exported flat and loaded into
the port.  Every rate of randomness is 0 here (drop-path, both dropouts,
modality dropout): JAX's PRNG streams cannot be reproduced in PyTorch, so
the random parts are held by their statistics instead.  The JAX side runs
the plain attention core (``use_pallas_attention=False``); the port runs
both settings, and on the CPU ``fused_mha`` is its plain version.

Tolerances (f32): the training forward's outputs 2e-4 abs, its BN
statistics 1e-5; ``compute_loss`` 1e-6; per train step the losses 1e-5
relative; AdamW's moments 1e-5 of each leaf's largest entry (plus a floor
for leaves whose gradient is zero in exact arithmetic and rounding noise in
both packages); the parameters 1e-3 x the group's LR plus 4 ulps of the
parameter, where the update is well conditioned (see
``_hold_params``); the count, the BN statistics, the clip's norm history,
the skip counter and the metric-ring row 1e-5.
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
from prcv2025reid_tpu.models.reid_model import compute_loss as jax_compute_loss  # noqa: E402
from prcv2025reid_tpu.training import param_groups as jpg  # noqa: E402
from prcv2025reid_tpu.training import schedulers as jsch  # noqa: E402
from prcv2025reid_tpu.training.train_step import TrainState as JaxTrainState  # noqa: E402
from prcv2025reid_tpu.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from prcv2025reid_tpu_torch import (  # noqa: E402
    TrainingConfig,
    build_model,
    init_train_state,
    make_train_step,
)
from prcv2025reid_tpu_torch.models.reid_model import compute_loss  # noqa: E402
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha  # noqa: E402
from prcv2025reid_tpu_torch.training import param_groups as ppg  # noqa: E402
from prcv2025reid_tpu_torch.training import schedulers as psch  # noqa: E402
from prcv2025reid_tpu_torch.training.train_step import RING_CHANNELS  # noqa: E402

NUM_CLASSES = 5
B, MV, S = 8, 4, 32
CTX, VOCAB = TINY_BASE["text_context_length"], TINY_BASE["text_vocab_size"]
STEPS_PER_EPOCH = 10
NO_RANDOMNESS = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                     modality_dropout=0.0)
TINY = {**TINY_BASE, "num_epochs": 4, "warmup_epochs": 1, **NO_RANDOMNESS}
SDM_WEIGHT, SDM_TAU = 0.1, 0.18


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


def make_batch(seed, uint8=False):
    """B samples of 4 ids x 2; sample 2 lacks nir, sample 5 cp, sample 3 its
    caption; captions BOS, words, EOT (the highest id), zero padding."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, CTX), np.int32)
    for i in range(B):
        n = int(rng.integers(3, CTX + 1))
        tokens[i, 0], tokens[i, n - 1] = VOCAB - 2, VOCAB - 1
        tokens[i, 1:n - 1] = rng.integers(1, VOCAB - 2, n - 2)
    image_mask = np.ones((B, MV), np.float32)
    image_mask[2, 1] = image_mask[5, 3] = 0.0
    text_mask = np.ones(B, np.float32)
    text_mask[3] = 0.0
    if uint8:
        images = rng.integers(0, 256, (B, MV, S, S, 3), dtype=np.uint8)
    else:  # already normalized: the float path, as the poisoned step feeds it
        images = rng.normal(size=(B, MV, S, S, 3)).astype(np.float32)
    return dict(images=images, image_mask=image_mask, text_tokens=tokens, text_mask=text_mask,
                labels=np.repeat(np.arange(B // 2), 2).astype(np.int32))


@pytest.fixture(scope="module")
def flat_params():
    b = make_batch(0)
    jmodel = JaxModel(config=JaxConfig(**TINY), num_classes=NUM_CLASSES)
    variables = jax.jit(lambda *a: jmodel.init({"params": jax.random.PRNGKey(0)}, *a))(
        *(jnp.asarray(b[k]) for k in ("images", "image_mask", "text_tokens", "text_mask")))
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


def jax_variables(flat):
    return tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def jax_flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in tu.flatten_dict(tree, sep="/").items()}


# ---- the training forward and the loss


@pytest.fixture(scope="module")
def jax_training_forward(flat_params):
    """JAX's training forward of the uint8 batch make_batch(11): (batch,
    outputs, new batch_stats)."""
    b = make_batch(11, uint8=True)
    jmodel = JaxModel(config=JaxConfig(**TINY), num_classes=NUM_CLASSES)
    fwd = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=True, mutable=["batch_stats"]))
    out, updates = fwd(jax_variables(flat_params), *(jnp.asarray(b[k]) for k in (
        "images", "image_mask", "text_tokens", "text_mask")))
    return b, out, updates["batch_stats"]


@pytest.mark.parametrize("pallas", [False, True])
def test_training_forward_matches_jax(pallas, flat_params, jax_training_forward):
    b, want, jax_stats = jax_training_forward
    jcfg = JaxConfig(**TINY)
    model = build_model(port_config(jcfg, use_pallas_attention=pallas), flat_params,
                        device="cpu")
    fused_mha.launches = 0
    with torch.no_grad():
        got, stats = model(*(torch.from_numpy(b[k]) for k in
                             ("images", "image_mask", "text_tokens", "text_mask")), train=True)
    assert fused_mha.launches == 0  # the CPU runs the plain version
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-4,
                                   err_msg=k)
    new = jax_flat(jax_stats, "batch_stats")
    for name, t in stats.items():
        np.testing.assert_allclose(t.numpy(), new["batch_stats/" + name.replace(".", "/")],
                                   rtol=0, atol=1e-5)
    # the buffers are the caller's to write
    torch.testing.assert_close(model.bn_neck.bn.mean,
                               torch.from_numpy(flat_params["batch_stats/bn_neck/bn/mean"]))


def test_bf16_training_forward_casts_where_jax_does(flat_params, jax_training_forward):
    """compute_dtype="bfloat16": every output of the training forward has
    JAX's dtype (the trunk, SDM and fusion in bf16; BNNeck, the logits and
    the masks in f32), and the port drifts from its own f32 forward as far
    as JAX's bf16 forward drifts from JAX's f32 one (relative Frobenius,
    within a quarter of JAX's drift; measured within 6%): the bf16
    roundings sit at the same places."""
    b, want32, _ = jax_training_forward
    jcfg = JaxConfig(**{**TINY, "compute_dtype": "bfloat16"})
    jmodel = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
    want16, _ = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=True, mutable=["batch_stats"]))(
        jax_variables(flat_params), *(jnp.asarray(b[k]) for k in (
            "images", "image_mask", "text_tokens", "text_mask")))
    got = {}
    for dt in ("bfloat16", "float32"):
        model = build_model(port_config(jcfg, compute_dtype=dt), flat_params, device="cpu")
        with torch.no_grad():
            got[dt], _ = model(*(torch.from_numpy(b[k]) for k in
                                 ("images", "image_mask", "text_tokens", "text_mask")),
                               train=True)

    def drift(a, ref):
        ref = np.asarray(ref, np.float64)
        return np.linalg.norm(np.asarray(a, np.float64) - ref) / max(np.linalg.norm(ref), 1e-30)

    for k in want16:
        assert str(got["bfloat16"][k].dtype).removeprefix("torch.") == str(want16[k].dtype), k
        ours = drift(got["bfloat16"][k].double().numpy(), got["float32"][k].double().numpy())
        theirs = drift(np.asarray(want16[k], np.float64), want32[k])
        assert abs(ours - theirs) <= 0.25 * theirs + 1e-4, (k, ours, theirs)


@pytest.mark.parametrize("sdm_impl", ["unrolled", "batched"])
@pytest.mark.parametrize("sdm_weight", [0.0, 0.3])
def test_compute_loss_matches_jax(sdm_impl, sdm_weight, jax_training_forward):
    b, out, _ = jax_training_forward
    labels = b["labels"].copy()
    labels[6] = NUM_CLASSES  # out of range: not a valid CE row
    want = jax_compute_loss(out, jnp.asarray(labels), sdm_weight=sdm_weight, sdm_tau=SDM_TAU,
                            sdm_impl=sdm_impl)
    got = compute_loss({k: torch.from_numpy(np.array(v)) for k, v in out.items()},
                       torch.from_numpy(labels), sdm_weight=torch.tensor(sdm_weight),
                       sdm_tau=SDM_TAU, sdm_impl=sdm_impl)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=1e-6, err_msg=k)


# ---- three train steps against JAX's make_train_step + build_optimizer


def jax_opt_leaves(opt_state):
    """{(kind, param path): array} for kind in mu, nu, acc_grads, and the
    inner count, from JAX's optax state tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", None) or getattr(p, "key", None) for p in path]
        for kind in ("mu", "nu", "acc_grads"):
            if kind in names:
                i = names.index(kind)
                out[kind, "/".join(str(n) for n in names[i + 1:])] = np.asarray(leaf, np.float32)
        if names[-1] == "count":
            out["count"] = int(leaf)
        if names[-1] == "mini_step":
            out["mini_step"] = int(leaf)
    return out


def _hold_moment(kind, got, want, floor):
    """|got - want| <= 1e-5 x the leaf's largest |want| + floor."""
    bound = 1e-5 * np.abs(want).max() + floor
    err = np.abs(got.astype(np.float32) - want).max()
    assert err <= bound, f"{kind}: {err} > {bound}"


def _step_bound(lr, nu_hat, nu_dtype):
    """What one AdamW step may add to an entry's difference from JAX.  A
    step moves an entry by lr * mhat / (sqrt(nhat) + 1e-8): where sqrt(nhat)
    is within a few hundred eps, the f32 rounding of a near-zero gradient
    (1e-9 of a summation order) is scaled up to a visible share of lr
    (measured: a -5.2e-10 gradient in JAX, -5.9e-10 in the port, moved one
    entry by 0.050 and 0.056 lr).  Such a step is bounded by what AdamW can
    move an entry at all (lr); a well-conditioned one by 1e-3 lr, and with
    nu stored in bf16 also by the one-ulp rounding flip of nu that f32
    values a rounding apart may take (2^-7 of nu, 2^-8 of its root)."""
    tight = 1e-3 * lr + (2.0 ** -8 * lr if nu_dtype == torch.bfloat16 else 0.0)
    return np.where(np.sqrt(nu_hat) >= 1e-5, tight, 1.05 * lr)


def _hold_params(name, got, want, bound):
    """The parameters against JAX's: the summed step bounds plus 4 ulps of
    the parameter (the rounding of p + u)."""
    err = np.abs(got - want)
    bound = bound + 4 * np.spacing(np.abs(want).astype(np.float32))
    bad = err > bound
    assert not bad.any(), (f"{name}: {int(bad.sum())} entries, worst {err.max()} "
                           f"(bound there {bound.flat[err.argmax()]})")


STEP_CASES = {  # freeze_backbone, accumulation, nu dtype (a covering of all pairs)
    "frozen-accum1-f32": dict(freeze_backbone=True, gradient_accumulation_steps=1,
                              opt_nu_dtype="float32"),
    "trainable-accum2-f32": dict(freeze_backbone=False, gradient_accumulation_steps=2,
                                 opt_nu_dtype="float32"),
    "frozen-accum2-bf16": dict(freeze_backbone=True, gradient_accumulation_steps=2,
                               opt_nu_dtype="bfloat16"),
    "trainable-accum1-bf16": dict(freeze_backbone=False, gradient_accumulation_steps=1,
                                  opt_nu_dtype="bfloat16"),
}


_JAX_STEPS = {}  # case -> (config, optimizer, jitted step): one compile per case


def _setup(flat_params, case, **port_over):
    variables = jax_variables(flat_params)
    if case not in _JAX_STEPS:
        jcfg = JaxConfig(**{**TINY, **STEP_CASES[case]})
        tx = jpg.build_optimizer(jcfg, variables["params"], STEPS_PER_EPOCH)
        jmodel = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
        _JAX_STEPS[case] = jcfg, tx, jax_make_train_step(jmodel, tx, jcfg)
    jcfg, tx, jstep = _JAX_STEPS[case]
    jstate = JaxTrainState.create(variables["params"], variables["batch_stats"], tx,
                                  jax.random.PRNGKey(1), ring_size=STEPS_PER_EPOCH,
                                  clip_window=jcfg.adaptive_clip_window)
    pcfg = port_config(jcfg, **port_over)
    model = build_model(pcfg, flat_params, device="cpu")
    return (jcfg, jstep, jstate, pcfg, model, make_train_step(model, pcfg, STEPS_PER_EPOCH),
            init_train_state(model, pcfg, STEPS_PER_EPOCH))


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_train_steps_match_jax(case, flat_params):
    jcfg, jstep, jstate, pcfg, model, pstep, pstate = _setup(
        flat_params, case, use_pallas_attention=case == "frozen-accum1-f32")
    labels = ppg.label_params(model, pcfg)
    lrs = ppg.group_learning_rates(pcfg)
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {labels[n] for n, _ in trainable} == set(lrs) - {"frozen"} - (
        {"clip_backbone", "tokenizers", "projections"} if pcfg.freeze_backbone else set())
    nu_dt = ppg.NU_DTYPES[pcfg.opt_nu_dtype]
    bounds = {n: np.zeros(p.shape, np.float32) for n, p in trainable}
    for step in range(3):
        b = make_batch(20 + step)
        jstate, jm = jstep(jstate, _jax_batch(b), jnp.float32(SDM_WEIGHT), jnp.float32(SDM_TAU))
        pstate, pm = pstep(pstate, b, SDM_WEIGHT, SDM_TAU)
        assert sorted(pm) == sorted(jm)
        for k in ("total_loss", "ce_loss", "sdm_loss"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        assert float(pm["skipped"]) == 0.0
        jopt = jax_opt_leaves(jstate.opt_state)
        assert int(pstate.opt_state.count) == jopt["count"]
        if pcfg.accum_steps > 1:
            assert int(pstate.opt_state.mini_step) == jopt["mini_step"]
        count = jopt["count"]
        jparams = jax_flat(jstate.params, "params")
        # floors: rounding noise in leaves whose gradient is zero in exact
        # arithmetic (the fusion key bias: a softmax is shift-invariant; the
        # fusion's last LayerNorm: BNNeck removes each feature's batch mean
        # and scale) scales with the gradients of the whole model
        top = {}
        for k, v in jopt.items():
            if isinstance(k, tuple):
                top[k[0]] = max(top.get(k[0], 0.0), float(np.abs(v).max()))
        floor = {"mu": 1e-6 * top["mu"], "nu": 1e-9 * top["nu"],
                 "acc_grads": 1e-6 * top.get("acc_grads", 0.0)}
        for i, (name, p) in enumerate(trainable):
            path = name.replace(".", "/")
            mu, nu = jopt["mu", path], jopt["nu", path]
            _hold_moment(f"mu {name}", pstate.opt_state.mu[i].numpy(), mu, floor["mu"])
            assert pstate.opt_state.nu[i].dtype == nu_dt
            if nu_dt == torch.bfloat16:  # one bf16 ulp
                got = pstate.opt_state.nu[i].float().numpy()
                assert (np.abs(got - nu) <= np.spacing(np.abs(nu).astype(np.float32)) * 2**16
                        + 1e-18).all(), name
            else:
                _hold_moment(f"nu {name}", pstate.opt_state.nu[i].numpy(), nu, floor["nu"])
            if pcfg.accum_steps > 1:
                _hold_moment(f"acc {name}", pstate.opt_state.acc[i].numpy(),
                             jopt["acc_grads", path], floor["acc_grads"])
            if count and (pcfg.accum_steps == 1 or step % pcfg.accum_steps):
                # an update landed this step (with accumulation: every
                # accum-th step)
                bounds[name] += _step_bound(lrs[labels[name]], nu / (1.0 - 0.999 ** count),
                                            nu_dt)
            _hold_params(name, p.detach().numpy(), jparams["params/" + path], bounds[name])
        for name, p in model.named_parameters():  # frozen: bit for bit
            if not p.requires_grad:
                np.testing.assert_array_equal(p.numpy(), flat_params["params/" + name.replace(
                    ".", "/")])
        jstats = jax_flat(jstate.batch_stats, "batch_stats")
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(model.bn_neck.bn, name).numpy(),
                                       jstats[f"batch_stats/bn_neck/bn/{name}"], rtol=0,
                                       atol=1e-5)
        np.testing.assert_allclose(pstate.grad_norm_hist.numpy(),
                                   np.asarray(jstate.grad_norm_hist), rtol=1e-5, atol=1e-5)
        assert int(pstate.grad_norm_count) == int(jstate.grad_norm_count) == step + 1
        assert int(pstate.skipped_total) == int(jstate.skipped_total) == 0
        np.testing.assert_allclose(pstate.metric_ring.numpy(), np.asarray(jstate.metric_ring),
                                   rtol=1e-5, atol=1e-5)
    assert pstate.step == int(jstate.step) == 3
    assert pstate.metric_ring.shape == (STEPS_PER_EPOCH, len(RING_CHANNELS))


def test_poisoned_step_moves_nothing_in_either_package(flat_params):
    """A NaN pixel: both packages skip, keep params, optimizer state and BN
    statistics, count the skip and record NaN losses in the ring row."""
    jcfg, jstep, jstate, pcfg, model, pstep, pstate = _setup(flat_params, "frozen-accum1-f32")
    b = make_batch(30)
    jstate, _ = jstep(jstate, _jax_batch(b), jnp.float32(SDM_WEIGHT), jnp.float32(SDM_TAU))
    pstate, _ = pstep(pstate, b, SDM_WEIGHT, SDM_TAU)
    bad = make_batch(31)
    bad["images"][0, 0, 0, 0, 0] = np.nan
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = [t.clone() for t in pstate.opt_state.tensors()]
    hist_before = pstate.grad_norm_hist.clone()
    j_before = jstate
    jstate, jm = jstep(jstate, _jax_batch(bad), jnp.float32(SDM_WEIGHT), jnp.float32(SDM_TAU))
    pstate, pm = pstep(pstate, bad, SDM_WEIGHT, SDM_TAU)
    assert float(jm["skipped"]) == float(pm["skipped"]) == 1.0
    assert int(jstate.skipped_total) == int(pstate.skipped_total) == 1
    jax.tree.map(lambda a, c: np.testing.assert_array_equal(np.asarray(a), np.asarray(c)),
                 (jstate.params, jstate.batch_stats, jstate.opt_state),
                 (j_before.params, j_before.batch_stats, j_before.opt_state))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, c in zip(pstate.opt_state.tensors(), opt_before):
        assert torch.equal(a, c)
    assert torch.equal(pstate.grad_norm_hist, hist_before)
    assert not np.isfinite(pstate.metric_ring[1, :3].numpy()).any()
    assert not np.isfinite(np.asarray(jstate.metric_ring)[1, :3]).any()


# ---- groups, schedules, schedulers


@pytest.mark.parametrize("freeze_backbone,freeze_text", [(True, False), (False, False),
                                                         (False, True)])
def test_labels_and_counts_match_jax(freeze_backbone, freeze_text, flat_params):
    from prcv2025reid_tpu_torch.models.reid_model import MultiModalReIDModel

    jparams = jax_variables(flat_params)["params"]
    want = {"/".join(k): v for k, v in tu.flatten_dict(
        jpg.build_label_tree(jparams, freeze_backbone, freeze_text)).items()}
    got = {k.removeprefix("params/"): ppg.label_for_path(k.removeprefix("params/"),
                                                         freeze_backbone, freeze_text)
           for k in flat_params if k.startswith("params/")}
    assert got == want
    model = MultiModalReIDModel(port_config(JaxConfig(**TINY)), NUM_CLASSES, device="meta")
    assert ppg.count_trainable(model, freeze_backbone, freeze_text) == jpg.count_trainable(
        jparams, freeze_backbone, freeze_text)


@pytest.mark.parametrize("scheduler", ["cosine", "step", "multistep", "plateau"])
@pytest.mark.parametrize("accum", [1, 3])
def test_group_schedules_match_jax(scheduler, accum):
    over = dict(scheduler=scheduler, num_epochs=60, warmup_epochs=5, step_lr_every=4,
                multistep_milestones=(6, 9), gradient_accumulation_steps=accum)
    jcfg = JaxConfig(**{**TINY, **over})
    want = jpg.group_schedules(jcfg, 7)
    got = ppg.group_schedules(port_config(jcfg), 7)
    assert sorted(got) == sorted(want)
    for g in want:
        for count in (0, 1, 5, 40):
            np.testing.assert_allclose(float(got[g](torch.tensor(count, dtype=torch.int32))),
                                       float(want[g](jnp.int32(count))), rtol=1e-6, err_msg=g)


def test_host_schedulers_match_jax_and_round_trip():
    jcfg = JaxConfig(**TINY)
    pcfg = port_config(jcfg)
    for cls in ("SDMWeightScheduler", "SDMTemperatureScheduler", "SDMScheduler",
                "PlateauScheduler"):
        assert dataclasses.asdict(getattr(psch, cls).from_config(pcfg)) == \
            dataclasses.asdict(getattr(jsch, cls).from_config(jcfg))
    pairs = []
    for mod, cfg in ((jsch, jcfg), (psch, pcfg)):
        s = mod.SDMScheduler.from_config(cfg)
        p = mod.PlateauScheduler.from_config(cfg)
        trace = []
        for epoch, (loss, stab, m) in enumerate([(1.0, 0.9, 0.2), (6.0, 0.9, 0.2),
                                                 (1.0, 0.3, 0.1), (1.0, 0.9, 0.1)] * 4, 1):
            trace.append(s.get_parameters(epoch, {"sdm_loss": loss, "stability_score": stab}))
            if epoch == 12 and s.can_increase_weight(epoch, {"stability_score": 0.9}):
                s.increase_weight()
            trace.append(p.step(m))
            trace.append(mod.warmup_cosine_multiplier(epoch, 20, 3, 0.01))
        pairs.append((trace, s.state_dict(), p.state_dict()))
        s2, p2 = mod.SDMScheduler.from_config(cfg), mod.PlateauScheduler.from_config(cfg)
        s2.load_state_dict(s.state_dict())
        p2.load_state_dict(p.state_dict())
        assert s2 == s and p2 == p
    assert pairs[0] == pairs[1]


def test_plateau_scale_multiplies_the_update(flat_params):
    """scheduler="plateau": the scale the host writes multiplies every
    update (lr * s), as JAX's plateau_scale_transform."""
    pcfg = port_config(JaxConfig(**{**TINY, "scheduler": "plateau"}))
    model = build_model(pcfg, flat_params, device="cpu")
    opt, trainable = ppg.build_optimizer(pcfg, model, STEPS_PER_EPOCH)
    params = [p for _, p in trainable]
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, p in enumerate(params)]
    state = opt.init(params)
    full, _ = opt.update(grads, state, params)
    ppg.set_plateau_scale(state, 0.25)
    scaled, new = opt.update(grads, state, params)
    for a, b in zip(scaled, full):
        torch.testing.assert_close(a, b * 0.25, rtol=1e-6, atol=0)
    assert float(new.plateau_scale) == 0.25


# ---- backward schedules: the same gradients


def _grads(flat_params, **over):
    pcfg = port_config(JaxConfig(**{**TINY, "freeze_backbone": False}), **over)
    model = build_model(pcfg, flat_params, device="cpu")
    trainable = ppg.freeze(model, pcfg)
    b = {k: torch.from_numpy(v) for k, v in make_batch(40).items()}
    out, _ = model(b["images"], b["image_mask"], b["text_tokens"], b["text_mask"], train=True)
    loss = compute_loss(out, b["labels"], sdm_weight=SDM_WEIGHT, sdm_tau=SDM_TAU)["total_loss"]
    grads = torch.autograd.grad(loss, [p for _, p in trainable], allow_unused=True)
    return {n: g for (n, _), g in zip(trainable, grads) if g is not None}


@pytest.mark.parametrize("over", [dict(remat_blocks=True), dict(attn_bwd="remat"),
                                  dict(gelu_bwd="remat"),
                                  dict(remat_blocks=True, use_pallas_attention=True)])
def test_backward_schedules_give_the_same_gradients(over, flat_params):
    """remat_blocks recomputes every block (and runs the last one in full
    rather than CLS-only: the same math, summed in another order);
    attn_bwd / gelu_bwd recompute the softmax or the erf (F.gelu rather
    than the stored erf: an ulp apart).  Every gradient within 1e-5 of its
    leaf's largest entry (f32 order of summation: the classifier's reads
    1.8e-6 of 0.44 under remat_blocks; JAX's own test holds remat_blocks at
    5e-4), plus 1e-8 for the leaves whose gradient is zero in exact
    arithmetic (the key biases: a softmax is shift-invariant)."""
    base = _grads(flat_params, use_pallas_attention=over.get("use_pallas_attention", False))
    got = _grads(flat_params, **over)
    assert sorted(got) == sorted(base)
    for n in base:
        bound = 1e-5 * base[n].abs().max().item() + 1e-8
        assert (got[n] - base[n]).abs().max().item() <= bound, n


# ---- the random parts, by their statistics


def test_drop_path_keeps_one_minus_rate_and_rescales():
    from prcv2025reid_tpu_torch.models.mer import drop_path

    x = torch.ones(4, 2500, 3, 5)
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.3, False, g)
    per_sample = y[:, :, 0, 0]
    scaled = torch.tensor(1.0 / 0.7).item()  # 1 / keep in f32
    assert set(torch.unique(per_sample).tolist()) <= {0.0, scaled}
    kept = (per_sample > 0).float().mean().item()
    assert abs(kept - 0.7) < 0.015  # 10,000 samples: 3 sigma is 0.014
    assert torch.equal(drop_path(x, 0.3, True, g), x)
    assert torch.equal(drop_path(x, 0.0, False, g), x)
    # one mask per sample, shared by its tokens and channels
    assert torch.equal(y, y[:, :, :1, :1].expand_as(y))


def test_training_with_drop_path_and_dropout_runs_and_differs(flat_params):
    pcfg = port_config(JaxConfig(**{**TINY, "drop_path": 0.3, "dropout_rate": 0.5,
                                    "fusion_dropout": 0.1, "sdm_dropout": 0.1}))
    model = build_model(pcfg, flat_params, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in make_batch(41).items()}
    args = (b["images"], b["image_mask"], b["text_tokens"], b["text_mask"])
    from prcv2025reid_tpu_torch.training.train_step import step_generators

    with torch.no_grad():
        a, _ = model(*args, train=True, generators=step_generators(0, 0, torch.device("cpu")))
        c, _ = model(*args, train=True, generators=step_generators(0, 0, torch.device("cpu")))
        d, _ = model(*args, train=True, generators=step_generators(0, 1, torch.device("cpu")))
    for k in a:
        assert torch.equal(a[k], c[k]), k
    assert not torch.equal(a["logits"], d["logits"])
    assert all(torch.isfinite(v).all() for v in d.values())


def test_modality_dropout_never_drops_vis_and_falls_back(flat_params):
    rate = 0.5
    model = build_model(port_config(JaxConfig(**{**TINY, "modality_dropout": rate})),
                        flat_params, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in make_batch(42).items()}
    # sample 1 holds nir alone: dropping nir would leave it nothing
    lone = b["image_mask"].clone()
    lone[1] = torch.tensor([0.0, 1.0, 0.0, 0.0])
    text_mask = b["text_mask"].clone()
    text_mask[1] = 0.0
    dropped = fell_back = 0
    with torch.no_grad():
        for seed in range(24):
            for image_mask in (b["image_mask"], lone):
                out, _ = model(b["images"], image_mask, b["text_tokens"], text_mask, train=True,
                               enable_modality_dropout=True,
                               generators={"moddrop": torch.Generator().manual_seed(seed)})
                eff, masks = out["effective_masks"], out["feature_masks"]
                assert torch.equal(eff[0], masks[0])  # vis is never dropped
                assert ((eff.sum(dim=0) > 0) | (masks.sum(dim=0) == 0)).all()
                coin = torch.rand(MV + 1, generator=torch.Generator().manual_seed(seed))
                keep = (coin > rate).float()
                keep[0] = 1.0
                if image_mask is lone and keep[1] == 0:  # the fallback: nothing drops
                    assert torch.equal(eff, masks)
                    fell_back += 1
                elif image_mask is not lone:
                    torch.testing.assert_close(eff, masks * keep[:, None], rtol=0, atol=0)
                    dropped += int(keep.sum() < MV + 1)
    assert dropped > 5 and fell_back > 5


def test_the_same_seed_and_step_give_the_same_step(flat_params):
    over = dict(drop_path=0.2, dropout_rate=0.3, fusion_dropout=0.1, sdm_dropout=0.1,
                modality_dropout=0.3)
    pcfg = port_config(JaxConfig(**{**TINY, **over}))
    results = []
    for _ in range(2):
        model = build_model(pcfg, flat_params, device="cpu")
        state = init_train_state(model, pcfg, STEPS_PER_EPOCH, seed=5)
        step = make_train_step(model, pcfg, STEPS_PER_EPOCH)
        for s in range(2):
            state, m = step(state, make_batch(50 + s), SDM_WEIGHT, SDM_TAU,
                            enable_modality_dropout=True)
        results.append((m, {k: v.clone() for k, v in model.state_dict().items()}))
    (m1, p1), (m2, p2) = results
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
