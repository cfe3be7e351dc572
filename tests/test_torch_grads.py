"""Gradients of the port's bf16 kernel wrappers against the JAX ops' VJPs.

Each wrapper runs inside a ``torch.autograd.Function`` whose backward is the
JAX op's ``custom_vjp`` backward (an XLA recompute in f32) written in plain
PyTorch, the same on the CPU and on the card.  Here, on the CPU, every
input's gradient is held against ``jax.vjp`` of the JAX op, whose forward
runs its Pallas kernel in interpret mode, on the same seeded numpy inputs
and cotangent.  f32 throughout: both sides compute the same f32 formulas and
differ only in summation order, so 1e-4 relative and absolute holds (measured:
at most 2.4e-6 of 1 + |gradient|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.ops import fused_block as jfb
from prcv2025reid_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from prcv2025reid_tpu.ops.fused_resln import fused_residual_ln as jax_fused_residual_ln
from prcv2025reid_tpu.ops.pallas_attention import pallas_mha
from prcv2025reid_tpu_torch.ops import attention as tatt
from prcv2025reid_tpu_torch.ops import fused_attention as tfa
from prcv2025reid_tpu_torch.ops import fused_block as tfb
from prcv2025reid_tpu_torch.ops import fused_mlp as tfm
from prcv2025reid_tpu_torch.ops import fused_resln as tfr
from prcv2025reid_tpu_torch.ops.matmul import tiled_matmul

TOL = 1e-4


def _inputs(seed, **shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * sc).astype(np.float32) for k, (s, sc) in shapes.items()}


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _check(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g is not None, f"{name}: no gradient"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


def _torch_grads(fn, arrays, cot):
    leaves = _leaves(arrays)
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return out, [t.grad for t in leaves]


def _jax_grads(fn, arrays, cot):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    cots = tuple(jnp.asarray(c) for c in cot) if isinstance(cot, tuple) else jnp.asarray(cot)
    return out, vjp(cots)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_fused_mha_grads_match_jax(causal, version):
    d = _inputs(10, q=((2, 3, 19, 16), 1.0), k=((2, 3, 19, 16), 1.0), v=((2, 3, 19, 16), 1.0),
                g=((2, 3, 19, 16), 1.0))
    arrays = (d["q"], d["k"], d["v"])
    _, want = _jax_grads(lambda q, k, v: pallas_mha(q, k, v, causal, True, version), arrays, d["g"])
    out, got = _torch_grads(
        lambda q, k, v: tfa.fused_mha(q, k, v, causal=causal, kernel_version=version), arrays,
        d["g"])
    assert out.grad_fn._forward_cls is tfa.FusedMhaFn
    _check(got, want, ("dq", "dk", "dv"))


def test_attention_entry_points_grads_match_jax():
    """dot_product_attention(impl="pallas") goes through fused_mha's Function;
    the splash core ([B, S, H, Dh]) through its plain version here and
    through fused_mha on the card: both against pallas_mha's VJP."""
    d = _inputs(11, q=((2, 3, 19, 16), 1.0), k=((2, 3, 19, 16), 1.0), v=((2, 3, 19, 16), 1.0),
                g=((2, 3, 19, 16), 1.0))
    arrays = (d["q"], d["k"], d["v"])
    _, want = _jax_grads(lambda q, k, v: pallas_mha(q, k, v, False, True, 2), arrays, d["g"])
    out, got = _torch_grads(lambda q, k, v: tatt.dot_product_attention(q, k, v, impl="pallas"),
                            arrays, d["g"])
    assert out.grad_fn._forward_cls is tfa.FusedMhaFn
    _check(got, want, ("dq", "dk", "dv"))
    bshd = tuple(np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (*arrays, d["g"]))
    _, got = _torch_grads(tatt.splash_attention_bshd, bshd[:3], bshd[3])
    _check([g.permute(0, 2, 1, 3) for g in got], want, ("dq", "dk", "dv"))


def test_fused_ln_qkv_grads_match_jax():
    G, T, D, O = 2, 13, 32, 48
    d = _inputs(12, x=((G, T, D), 1.0), s=((D,), 0.1), b=((D,), 0.1), w=((G, D, O), 0.2),
                bias=((G, O), 0.1), g=((G, T, O), 1.0))
    d["s"] += 1.0
    arrays = (d["x"], d["s"], d["b"], d["w"], d["bias"])
    _, want = _jax_grads(lambda *a: jfb.fused_ln_qkv(*a, "bf16", 8, True), arrays, d["g"])
    out, got = _torch_grads(tfb.fused_ln_qkv, arrays, d["g"])
    assert out.grad_fn._forward_cls is tfb.FusedLnQkvFn
    _check(got, want, ("dx", "d_ln_scale", "d_ln_bias", "dw", "db"))


def test_fused_out_mlp_grads_match_jax():
    G, T, D, F = 2, 13, 32, 64
    d = _inputs(13, attn=((G, T, D), 1.0), x=((G, T, D), 1.0), wo=((G, D, D), 0.2),
                bo=((G, D), 0.1), s=((D,), 0.1), b=((D,), 0.1), w1=((G, D, F), 0.2),
                b1=((G, F), 0.1), w2=((G, F, D), 0.2), b2=((G, D), 0.1), g=((G, T, D), 1.0))
    d["s"] += 1.0
    names = ("attn", "x", "wo", "bo", "s", "b", "w1", "b1", "w2", "b2")
    arrays = tuple(d[n] for n in names)
    _, want = _jax_grads(lambda *a: jfb.fused_out_mlp(*a, "bf16", 8, True), arrays, d["g"])
    out, got = _torch_grads(tfb.fused_out_mlp, arrays, d["g"])
    assert out.grad_fn._forward_cls is tfb.FusedOutMlpFn
    _check(got, want, ["d" + n for n in names])


@pytest.mark.parametrize("G", [1, 3])
def test_fused_mlp_grads_match_jax(G):
    N, D, F = 13, 32, 64
    d = _inputs(14, x=((G, N, D), 1.0), w1=((G, D, F), 0.2), b1=((G, F), 0.1),
                w2=((G, F, D), 0.2), b2=((G, D), 0.1), g=((G, N, D), 1.0))
    arrays = (d["x"], d["w1"], d["b1"], d["w2"], d["b2"])
    _, want = _jax_grads(lambda *a: jax_fused_mlp(*a, 8, True), arrays, d["g"])
    out, got = _torch_grads(tfm.fused_mlp, arrays, d["g"])
    assert out.grad_fn._forward_cls is tfm.FusedMlpFn
    _check(got, want, ("dx", "dw1", "db1", "dw2", "db2"))


def test_fused_residual_ln_grads_match_jax():
    """Both outputs carry a cotangent; x and branch get the same dx."""
    N, D = 21, 32
    d = _inputs(15, x=((N, D), 1.0), br=((N, D), 1.0), s=((D,), 0.1), b=((D,), 0.1),
                gxn=((N, D), 1.0), gy=((N, D), 1.0))
    d["s"] += 1.0
    arrays = (d["x"], d["br"], d["s"], d["b"])
    cot = (d["gxn"], d["gy"])
    _, want = _jax_grads(lambda *a: jax_fused_residual_ln(*a, 1e-5, 8, True), arrays, cot)
    (xn, _), got = _torch_grads(tfr.fused_residual_ln, arrays, cot)
    assert xn.grad_fn._forward_cls is tfr.FusedResLnFn
    _check(got, want, ("dx", "dbranch", "d_scale", "d_bias"))
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)


def test_backwards_are_the_jax_formulas_not_autograd_of_the_plain_versions():
    """The Function's backward is the same function on every device: the
    gradients equal the module's backward called directly, bit for bit.  In
    bf16 that differs from autograd through the plain version, which rounds h
    to bf16 and uses the A-S erf where the JAX backward keeps h in f32 with
    the exact erf; the gradients come back in the primal dtypes."""
    G, N, D, F = 1, 9, 32, 64
    d = _inputs(16, x=((G, N, D), 1.0), w1=((G, D, F), 0.2), b1=((G, F), 0.1),
                w2=((G, F, D), 0.2), b2=((G, D), 0.1), g=((G, N, D), 1.0))
    names = ("x", "w1", "b1", "w2", "b2")
    leaves = [torch.from_numpy(d[n]).bfloat16().requires_grad_() for n in names]
    g = torch.from_numpy(d["g"]).bfloat16()
    got = torch.autograd.grad(tfm.fused_mlp(*leaves), leaves, g)
    direct = tfm.mlp_backward(*(t.detach() for t in leaves), g)
    plain = torch.autograd.grad(tfm.mlp_plain(*leaves), leaves, g)
    for name, a, b, p in zip(names, got, direct, plain):
        assert a.dtype == torch.bfloat16, name
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(not torch.equal(a, p) for a, p in zip(got, plain))
    # mixed primal dtypes: each gradient in its own input's dtype
    x = torch.from_numpy(d["x"][0]).bfloat16().requires_grad_()
    s = torch.ones(D, requires_grad=True)
    b = torch.zeros(D, dtype=torch.bfloat16, requires_grad=True)
    xn, y = tfr.fused_residual_ln(x, x.detach().clone().requires_grad_(), s, b)
    dx, ds, db = torch.autograd.grad(xn.float().sum() + y.float().sum(), (x, s, b))
    assert (dx.dtype, ds.dtype, db.dtype) == (torch.bfloat16, torch.float32, torch.bfloat16)


def test_forward_without_autograd_records_nothing():
    d = _inputs(17, q=((1, 2, 9, 16), 1.0))
    q = torch.from_numpy(d["q"]).requires_grad_()
    with torch.inference_mode():
        assert tfa.fused_mha(q, q, q).grad_fn is None
    with torch.no_grad():
        assert tfa.fused_mha(q, q, q).grad_fn is None


def test_tiled_matmul_raises_under_autograd():
    x = torch.zeros(64, 96, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros(96, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no backward"):
        tiled_matmul(x, w)
    with pytest.raises(NotImplementedError, match="no backward"):
        tiled_matmul(x.detach(), w.requires_grad_())
    with torch.no_grad():  # no graph is asked for: the forward runs
        assert tiled_matmul(x, w).shape == (64, 128)
