"""The port's kernel modules against the JAX package's Pallas kernels.

Same numpy inputs (seeded) into both; JAX runs its Pallas kernels in
interpret mode on the CPU, the port runs the plain versions its wrappers
take for CPU tensors.  f32 throughout, so the tolerances are the JAX
package's own kernel-vs-oracle ones (tests/test_pallas_attention.py,
tests/test_fused_block.py): only summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.ops import fused_block as jfb
from prcv2025reid_tpu.ops.attention import xla_attention as jax_xla_attention
from prcv2025reid_tpu.ops.attention import xla_attention_bshd_onesaug as jax_onesaug
from prcv2025reid_tpu.ops.kernel_math import gelu_exact as jax_gelu_exact
from prcv2025reid_tpu.ops.kernel_math import gelu_poly_bf16 as jax_gelu_poly
from prcv2025reid_tpu.ops.kernel_math import gelu_stored as jax_gelu_stored
from prcv2025reid_tpu.ops.pallas_attention import pallas_mha
from prcv2025reid_tpu_torch.ops import attention as tatt
from prcv2025reid_tpu_torch.ops import fused_block as tfb
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha
from prcv2025reid_tpu_torch.models.mer import apply_gelu
from prcv2025reid_tpu_torch.ops.kernel_math import gelu_exact, gelu_poly_bf16, gelu_stored, ln_f32

G, T, D, F = 2, 70, 64, 128


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("version", [1, 2])
# the vision shape, a small causal one, and the text tower's causal shape (S = 77, H = 8)
@pytest.mark.parametrize("shape,causal", [((2, 4, 197, 64), False), ((1, 2, 33, 16), True),
                                          ((2, 8, 77, 64), True)])
def test_fused_mha_matches_pallas(shape, causal, version):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = pallas_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, True, version)
    got = fused_mha(_t(q), _t(k), _t(v), causal=causal, kernel_version=version)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_attention_cores_match_jax(causal):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 3, 21, 16)).astype(np.float32) for _ in range(3))
    want = jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tatt.xla_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # the bshd core is the same function on the [B, S, H, Dh] layout
    bshd = tatt.xla_attention_bshd(*(_t(a).permute(0, 2, 1, 3) for a in (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(bshd.permute(0, 2, 1, 3).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_dispatch_auto_takes_plain_core_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.normal(size=(1, 2, 9, 16))) for _ in range(3))
    before = fused_mha.launches
    out = tatt.dot_product_attention(q, k, v, impl="auto")
    torch.testing.assert_close(out, tatt.xla_attention(q, k, v))
    assert fused_mha.launches == before  # the kernel counts CUDA launches only


@pytest.fixture(scope="module")
def block_data():
    rng = np.random.default_rng(0)

    def r(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        x=r((G, T, D)), attn=r((G, T, D)),
        lns=1.0 + 0.1 * r((D,)), lnb=0.1 * r((D,)),
        wqkv=r((G, D, 3 * D), 0.1), bqkv=0.1 * r((G, 3 * D)),
        wo=r((G, D, D), 0.1), bo=0.1 * r((G, D)),
        w1=r((G, D, F), 0.1), b1=0.1 * r((G, F)),
        w2=r((G, F, D), 0.1), b2=0.1 * r((G, D)),
    )


def test_fused_ln_qkv_matches_pallas(block_data):
    d = block_data
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = jfb.fused_ln_qkv(j["x"], j["lns"], j["lnb"], j["wqkv"], j["bqkv"], "bf16", 32, True)
    got = tfb.fused_ln_qkv(*(_t(d[k]) for k in ("x", "lns", "lnb", "wqkv", "bqkv")))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# bf16 tolerance where the two frameworks take the same bf16 inputs: both
# sides may round at other points (see the serving formulations below) or
# flip a bf16 rounding of an intermediate; one bf16 ulp at |y| in [2, 4) is
# 0.0156.
BF16_TOL = 2e-2


def _qkv_data(g, t, seed):
    rng = np.random.default_rng(seed)

    def r(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(x=r((g, t, D)), lns=1.0 + 0.1 * r((D,)), lnb=0.1 * r((D,)),
                wqkv=r((g, D, 3 * D), 0.1), bqkv=0.1 * r((g, 3 * D)))


# the MM-3 query's three groups, and one group, of a row count that is a
# multiple of neither the JAX kernel's 32-row block nor the card kernels'
# 128-row tile
@pytest.mark.parametrize("g,t", [(3, 37), (1, 5)])
def test_fused_ln_qkv_matches_pallas_groups(g, t):
    d = _qkv_data(g, t, seed=g * 100 + t)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = jfb.fused_ln_qkv(j["x"], j["lns"], j["lnb"], j["wqkv"], j["bqkv"], "bf16", 32, True)
    got = tfb.fused_ln_qkv(*(_t(d[k]) for k in ("x", "lns", "lnb", "wqkv", "bqkv")))
    assert got.shape == (g, t, 3 * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("g,t", [(2, 70), (3, 37)])
def test_fused_ln_qkv_matches_pallas_bf16(g, t):
    """At the card's working type: bf16 x and w (f32 LN parameters and
    bias, as the model passes them), where the cast of the LN1 rows to bf16
    before the product is the TPU kernel's."""
    d = _qkv_data(g, t, seed=g * 100 + t + 1)
    cast = {"x", "wqkv"}
    names = ("x", "lns", "lnb", "wqkv", "bqkv")
    want = jfb.fused_ln_qkv(*(jnp.asarray(d[k], jnp.bfloat16 if k in cast else jnp.float32)
                              for k in names), "bf16", 32, True)
    got = tfb.fused_ln_qkv(*(_t(d[k]).bfloat16() if k in cast else _t(d[k]) for k in names))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", np.float32])
def test_ln_rows_plain_matches_jax(dtype):
    """The LN row passes' plain version, y = bf16(LN(x)) (LN1 on bf16 x,
    LN2 on the f32 x2), against JAX ``_ln_f32(x).astype(bf16)``, which is
    what the TPU kernels feed their products.  Both take f32 statistics in
    another summation order, so an element may round to the neighbouring
    bf16 value: equal in all but a few, one bf16 ulp apart at most."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(3, 37, D)) * 2 + 0.5).astype(np.float32)
    lns, lnb = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32), (
        0.1 * rng.normal(size=D)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    want = np.asarray(jfb._ln_f32(jnp.asarray(x, jdt), jnp.asarray(lns), jnp.asarray(lnb))
                      .astype(jnp.bfloat16), np.float32)
    got = tfb.ln_rows_plain(_t(x).to(tdt), _t(lns), _t(lnb), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float().numpy()
    assert (got != want).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=0)


def _check_fused_out_mlp(d, cast, tol):
    """The port's fused_out_mlp against JAX's Pallas kernel, with the operands
    named in ``cast`` in bf16 on both sides."""
    names = ("attn", "x", "wo", "bo", "lns", "lnb", "w1", "b1", "w2", "b2")
    want = jfb.fused_out_mlp(*(jnp.asarray(d[k], jnp.bfloat16 if k in cast else jnp.float32)
                               for k in names), "bf16", 32, True)
    got = tfb.fused_out_mlp(*(_t(d[k]).bfloat16() if k in cast else _t(d[k]) for k in names))
    assert got.dtype == (torch.bfloat16 if cast else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_fused_out_mlp_matches_pallas(block_data):
    _check_fused_out_mlp(block_data, set(), 3e-5)


def test_fused_out_mlp_matches_pallas_bf16(block_data):
    """At the card's working type: bf16 activations and weights (f32 biases
    and LN parameters, as the model passes them), where the kernel's casts of
    y and h to bf16 before fc1 and fc2 are the TPU kernel's."""
    _check_fused_out_mlp(block_data, {"attn", "x", "wo", "w1", "w2"}, BF16_TOL)


def test_gelu_exact_matches_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(gelu_exact(_t(x)).numpy(), np.asarray(jax_gelu_exact(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_bf16_plain_versions_round_like_the_kernels(block_data):
    """In bf16 the plain versions cast the LN output and GELU output to bf16
    before each product, as the TPU kernels do: compare with an f32 pass
    over the same bf16-rounded operands."""
    d = {k: _t(v).bfloat16() for k, v in block_data.items()}
    got = tfb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])
    assert got.dtype == torch.bfloat16
    y = ln_f32(d["x"], d["lns"], d["lnb"]).bfloat16().float()
    ref = (y @ d["wqkv"].float() + d["bqkv"].float()[:, None]).bfloat16()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# The serving formulations at BF16_TOL: both sides take the same bf16
# inputs, but round at other points: JAX evaluates the tanh GELU op by op in
# bf16 where PyTorch rounds once from f32, and the poly GELU's bf16 x / sqrt 2
# may round on either side of a half step.  Measured: at most 0.0156 apart
# (one bf16 ulp at |y| in [2, 4)) over x in [-6, 6], the onesaug core equal.


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5), ("bfloat16", BF16_TOL)])
def test_onesaug_core_matches_jax(dtype, tol):
    """The ones-augmented core on [B, S, H, Dh], also with one query row (the
    CLS-only block's q)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 21, 3, 16)).astype(np.float32) for _ in range(3))
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else (jnp.bfloat16,
                                                                         torch.bfloat16)
    for qq in (q, q[:, :1]):
        want = jax_onesaug(*(jnp.asarray(a, jdt) for a in (qq, k, v)))
        got = tatt.xla_attention_bshd_onesaug(*(_t(a).to(tdt) for a in (qq, k, v)))
        assert got.dtype == tdt and got.shape == qq.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    # the same attention as the exact core, up to bf16 score storage in f32
    exact = tatt.xla_attention_bshd(*(_t(a) for a in (q, k, v)))
    torch.testing.assert_close(tatt.xla_attention_bshd_onesaug(*(_t(a) for a in (q, k, v))),
                               exact, rtol=1e-5, atol=1e-5)
    assert tatt.bshd_core("onesaug") is tatt.xla_attention_bshd_onesaug


@pytest.mark.parametrize("impl", ["poly", "tanh"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), ("bfloat16", BF16_TOL)])
def test_serving_gelus_match_jax(impl, dtype, tol):
    """gelu_poly_bf16 and the tanh GELU (``apply_gelu``) against JAX's
    ``gelu_poly_bf16`` and ``jax.nn.gelu(approximate=True)``."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jf = jax_gelu_poly if impl == "poly" else (lambda h: jax.nn.gelu(h, approximate=True))
    want = np.asarray(jf(jnp.asarray(x, jdt)), np.float32)
    got = apply_gelu(_t(x).to(tdt), impl)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    if impl == "poly":
        torch.testing.assert_close(gelu_poly_bf16(_t(x).to(tdt)), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), ("bfloat16", BF16_TOL)])
def test_gelu_stored_forward_and_gradient_match_jax(dtype, tol):
    """Forward and VJP against ``jax.vjp(gelu_stored)`` on the same
    cotangent; in f32 the forward also equals the exact GELU."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 33)).astype(np.float32) * 3
    g = rng.normal(size=(7, 33)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else (jnp.bfloat16,
                                                                         torch.bfloat16)
    y_j, vjp = jax.vjp(jax_gelu_stored, jnp.asarray(x, jdt))
    (dx_j,) = vjp(jnp.asarray(g, jdt))
    xt = _t(x).to(tdt).requires_grad_()
    y = gelu_stored(xt)
    (dx,) = torch.autograd.grad(y, xt, _t(g).to(tdt))
    assert y.dtype == tdt and dx.dtype == tdt
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(y_j, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_j, np.float32),
                               rtol=tol, atol=tol)
    if dtype is np.float32:
        torch.testing.assert_close(y.detach(), torch.nn.functional.gelu(_t(x)))
