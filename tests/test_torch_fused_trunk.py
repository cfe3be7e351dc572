"""The fused-stream eval trunk of the port against the JAX package.

Same seeded numpy inputs into both; JAX runs its Pallas kernels
(``fused_mlp``, ``fused_residual_ln``) in interpret mode on the CPU, the port
the plain versions its wrappers take for CPU tensors.  f32 throughout, so the
tolerances are the JAX package's own kernel-vs-oracle ones
(tests/test_fused_mlp.py, tests/test_fused_resln.py): only summation order
and the erf formula (the kernels' Abramowitz-Stegun erf, |err| <= 1.5e-7)
differ.  The bf16 test pins the kernels' rounding points.
"""
import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.models.encoder import UnifiedEncoder as JaxEncoder
from prcv2025reid_tpu.models.mer import MERMlp as JaxMERMlp
from prcv2025reid_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from prcv2025reid_tpu.ops.fused_resln import fused_residual_ln as jax_fused_residual_ln
from prcv2025reid_tpu_torch.models.encoder import UnifiedEncoder
from prcv2025reid_tpu_torch.models.mer import MERMlp
from prcv2025reid_tpu_torch.models.vit import MERVisionTransformer
from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp, mlp_plain
from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln, resln_plain
from prcv2025reid_tpu_torch.ops.kernel_math import gelu_exact, ln_f32
from prcv2025reid_tpu_torch.params import load_params


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _perturbed(variables, seed: int):
    """The flat '/'-keyed tree with lora_B and biases made nonzero (JAX
    initialises them to zero, which would hide folding and bias bugs)."""
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("lora_B"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/bias"):
            flat[k] = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
    return flat


def _unflatten(flat):
    return tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _mlp_operands(rng, G, N, D, F):
    return dict(
        x=rng.normal(size=(G, N, D)).astype(np.float32),
        w1=(rng.normal(size=(G, D, F)) * 0.1).astype(np.float32),
        b1=(rng.normal(size=(G, F)) * 0.1).astype(np.float32),
        w2=(rng.normal(size=(G, F, D)) * 0.1).astype(np.float32),
        b2=(rng.normal(size=(G, D)) * 0.1).astype(np.float32),
    )


def _resln_operands(rng, N, D):
    return dict(
        x=rng.normal(size=(N, D)).astype(np.float32),
        branch=rng.normal(size=(N, D)).astype(np.float32),
        scale=(rng.normal(size=(D,)) + 1.0).astype(np.float32),
        bias=rng.normal(size=(D,)).astype(np.float32),
    )


def test_fused_mlp_matches_pallas():
    d = _mlp_operands(np.random.default_rng(4), G=2, N=37, D=64, F=128)
    names = ("x", "w1", "b1", "w2", "b2")
    want = jax_fused_mlp(*(jnp.asarray(d[k]) for k in names), 16, True)
    got = fused_mlp(*(_t(d[k]) for k in names))
    assert got.shape == (2, 37, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_fused_residual_ln_matches_pallas():
    d = _resln_operands(np.random.default_rng(5), N=37, D=64)
    names = ("x", "branch", "scale", "bias")
    want_xn, want_y = jax_fused_residual_ln(*(jnp.asarray(d[k]) for k in names), 1e-5, 16, True)
    xn, y = fused_residual_ln(*(_t(d[k]) for k in names))
    np.testing.assert_allclose(xn.numpy(), np.asarray(want_xn), rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_residual_ln"])
def test_bf16_plain_versions_round_like_the_kernels(kernel):
    """In bf16 the plain versions round where the TPU kernels do: the GELU
    output before fc2; the residual sum before the LayerNorm statistics.
    Compare with an f32 pass over the same bf16 operands that rounds there,
    and check that the rounding point matters for these inputs."""
    rng = np.random.default_rng(6)
    if kernel == "fused_mlp":
        d = {k: _t(v).bfloat16() for k, v in _mlp_operands(rng, 2, 37, 64, 128).items()}
        got = fused_mlp(d["x"], d["w1"], d["b1"], d["w2"], d["b2"])
        assert got.dtype == torch.bfloat16
        h = gelu_exact(d["x"].float() @ d["w1"].float() + d["b1"].float()[:, None])

        def fc2(hidden):
            return (hidden @ d["w2"].float() + d["b2"].float()[:, None]).bfloat16()

        torch.testing.assert_close(got, fc2(h.bfloat16().float()), rtol=0, atol=0)
        assert not torch.equal(got, fc2(h))
    else:
        d = {k: _t(v).bfloat16() for k, v in _resln_operands(rng, 37, 64).items()}
        xn, y = fused_residual_ln(d["x"], d["branch"], d["scale"], d["bias"])
        assert xn.dtype == y.dtype == torch.bfloat16
        exact = d["x"].float() + d["branch"].float()
        torch.testing.assert_close(xn, exact.bfloat16(), rtol=0, atol=0)
        torch.testing.assert_close(y, ln_f32(exact.bfloat16(), d["scale"], d["bias"]).bfloat16(),
                                   rtol=0, atol=0)
        assert not torch.equal(y, ln_f32(exact, d["scale"], d["bias"]).bfloat16())


def test_wrappers_count_cuda_launches_only():
    rng = np.random.default_rng(7)
    m = {k: _t(v) for k, v in _mlp_operands(rng, 1, 5, 16, 32).items()}
    r = {k: _t(v) for k, v in _resln_operands(rng, 5, 16).items()}
    before = (fused_mlp.launches, fused_residual_ln.launches)
    torch.testing.assert_close(fused_mlp(*m.values()), mlp_plain(*m.values()))
    for a, b in zip(fused_residual_ln(*r.values()), resln_plain(*r.values())):
        torch.testing.assert_close(a, b)
    assert (fused_mlp.launches, fused_residual_ln.launches) == before


def test_mer_mlp_auto_matches_pallas_interpret():
    G, B, S, D, F = 2, 3, 5, 16, 32
    x = np.random.default_rng(8).normal(size=(G, B, S, D)).astype(np.float32)
    jmlp = JaxMERMlp(mlp_dim=F, num_experts=4, dtype=jnp.float32, impl="pallas_interpret")
    flat = _perturbed(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x), (0, 2)), seed=9)
    want = jmlp.apply(_unflatten(flat), jnp.asarray(x), (0, 2))
    mlp = MERMlp(D, F, num_experts=4, impl="auto", device="cpu")
    assert load_params(mlp, flat) == []
    with torch.inference_mode():
        got = mlp(_t(x), (0, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_vision_trunk_fused_stream_matches_pallas_interpret():
    """All four vision groups through the fused-stream trunk (JAX: its
    Pallas fused MLP and residual+LN in interpret mode, einsum attention)."""
    kw = dict(embed_dim=64, num_layers=3, num_heads=4, mlp_dim=128, image_size=32,
              patch_size=16, fusion_dim=32)
    jenc = JaxEncoder(text_width=32, text_layers=1, text_heads=4, text_mlp_dim=64,
                      text_vocab=100, context_length=8, dtype=jnp.float32, attn_impl="xla",
                      mlp_impl="pallas_interpret", resln_impl="pallas_interpret", **kw)
    rng = np.random.default_rng(10)
    imgs = rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    toks = jnp.zeros((2, 8), jnp.int32)
    flat = _perturbed(jenc.init(jax.random.PRNGKey(0), jnp.asarray(imgs), toks), seed=11)
    want, _ = jenc.apply(_unflatten(flat), jnp.asarray(imgs), toks)

    vit = MERVisionTransformer(mlp_impl="auto", resln_impl="auto", device="cpu", **kw)
    enc = UnifiedEncoder(vit)
    skipped = load_params(enc, flat)
    assert skipped and all(k.startswith(("params/text/", "params/text_proj/")) for k in skipped)
    with torch.inference_mode():
        tokens = torch.stack([vit.patch_embed(m)(_t(imgs[:, i]))
                              for i, m in enumerate(vit.modalities)])
        got = vit.trunk(tokens, tuple(range(4))).permute(1, 0, 2)
    assert got.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
