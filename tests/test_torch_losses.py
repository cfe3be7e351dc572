"""The port's losses (``ops/losses.py``) against the JAX package's, on the
CPU in f32: seeded features, masks and labels go through both; every value
within 1e-6 (abs, on losses of order 1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.ops import losses as jl
from prcv2025reid_tpu_torch.ops import losses as pl

TOL = 1e-6


def _feats(seed, M=5, B=8, D=16):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(M, B, D)).astype(np.float32)
    masks = (rng.random((M, B)) > 0.3).astype(np.float32)
    labels = np.repeat(np.arange(B // 2), 2).astype(np.int32)
    return feats, masks, labels


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_one_side_ce(seed):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(6, 7)).astype(np.float32) * 5
    y = (rng.random((6, 7)) > 0.6).astype(np.float32)
    rv = (rng.random(6) > 0.3).astype(np.float32)
    cv = (rng.random(7) > 0.3).astype(np.float32)
    want = jl._masked_one_side_ce(*(jnp.asarray(a) for a in (S, y, rv, cv)))
    got = pl._masked_one_side_ce(*(torch.from_numpy(a) for a in (S, y, rv, cv)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", ["masks", "no_positive_pair", "all_valid", "tau_clamped"])
def test_sdm_loss(case):
    feats, masks, labels = _feats(3)
    qry, gal = feats[1], feats[0]
    qv, gv = masks[1], masks[0]
    y = (labels[:, None] == labels[None, :]).astype(np.float32)
    tau = 0.18
    if case == "no_positive_pair":
        y = np.zeros_like(y)
    elif case == "all_valid":
        qv, gv = np.ones_like(qv), np.ones_like(gv)
    elif case == "tau_clamped":
        tau = 0.05  # clamped to 0.15
    want = jl.sdm_loss(*(jnp.asarray(a) for a in (qry, gal, y, qv, gv)), tau)
    got = pl.sdm_loss(*(torch.from_numpy(a) for a in (qry, gal, y, qv, gv)), tau)
    for g, w in zip(got, want):
        _close(g, w)
    if case == "no_positive_pair":
        assert float(got[0]) == 0.0 and float(got[1]) == 0.0


def test_sdm_loss_non_finite_input_gives_zero():
    feats, masks, labels = _feats(4)
    qry = feats[1].copy()
    qry[2, 3] = np.nan
    y = (labels[:, None] == labels[None, :]).astype(np.float32)
    args = (qry, feats[0], y, np.ones(8, np.float32), np.ones(8, np.float32))
    want = jl.sdm_loss(*(jnp.asarray(a) for a in args), 0.2)
    got = pl.sdm_loss(*(torch.from_numpy(a) for a in args), torch.tensor(0.2))
    assert float(want[0]) == 0.0 and float(got[0]) == 0.0
    assert float(got[1]) == float(want[1]) == 1.0


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_masked_cross_entropy(smoothing):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(8, 6)).astype(np.float32) * 3
    labels = np.array([0, 5, 2, -1, 6, 3, 3, 1], np.int32)  # two out of range
    valid = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    want = jl.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid),
                                   smoothing)
    got = pl.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                  torch.from_numpy(valid), smoothing)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[1]) == 5.0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("case", ["masks", "modality_without_pairs", "non_finite", "tau_tensor"])
def test_multimodal_sdm_loss(batched, case):
    feats, masks, labels = _feats(6)
    tau = 0.18
    if case == "modality_without_pairs":
        masks[2] = 0.0  # sk: no valid row, so no pair: skipped from the mean
    elif case == "non_finite":
        feats[3, 1, 0] = np.inf  # cp: its loss is zeroed and still counted
    jfn = jl.multimodal_sdm_loss_batched if batched else jl.multimodal_sdm_loss
    pfn = pl.multimodal_sdm_loss_batched if batched else pl.multimodal_sdm_loss
    want = jfn(jnp.asarray(feats), jnp.asarray(masks), jnp.asarray(labels), tau)
    ptau = torch.tensor(tau) if case == "tau_tensor" else tau
    got = pfn(torch.from_numpy(feats), torch.from_numpy(masks), torch.from_numpy(labels), ptau)
    _close(got, want)
    assert np.isfinite(float(got)) and float(got) > 0


def test_batched_equals_unrolled():
    feats, masks, labels = _feats(7, M=5, B=12)
    args = (torch.from_numpy(feats), torch.from_numpy(masks), torch.from_numpy(labels), 0.2)
    torch.testing.assert_close(pl.multimodal_sdm_loss_batched(*args),
                               pl.multimodal_sdm_loss(*args), rtol=0, atol=TOL)


def test_sdm_similarities_are_full_f32_whatever_the_tf32_setting():
    """The products run with TF32 off inside the function and the setting
    is restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        feats, masks, labels = _feats(8)
        pl.multimodal_sdm_loss(torch.from_numpy(feats), torch.from_numpy(masks),
                               torch.from_numpy(labels), 0.2)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pl.full_f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
