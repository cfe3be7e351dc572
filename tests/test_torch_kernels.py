"""The port's kernel modules against the JAX package's Pallas kernels.

Same numpy inputs (seeded) into both; JAX runs its Pallas kernels in
interpret mode on the CPU, the port runs the plain versions its wrappers
take for CPU tensors.  f32 throughout, so the tolerances are the JAX
package's own kernel-vs-oracle ones (tests/test_pallas_attention.py,
tests/test_fused_block.py): only summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.ops import fused_block as jfb
from prcv2025reid_tpu.ops.attention import xla_attention as jax_xla_attention
from prcv2025reid_tpu.ops.kernel_math import gelu_exact as jax_gelu_exact
from prcv2025reid_tpu.ops.pallas_attention import pallas_mha
from prcv2025reid_tpu_torch.ops import attention as tatt
from prcv2025reid_tpu_torch.ops import fused_block as tfb
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha
from prcv2025reid_tpu_torch.ops.kernel_math import gelu_exact, ln_f32

G, T, D, F = 2, 70, 64, 128


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("shape,causal", [((2, 4, 197, 64), False), ((1, 2, 33, 16), True)])
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


def test_fused_out_mlp_matches_pallas(block_data):
    d = block_data
    names = ("attn", "x", "wo", "bo", "lns", "lnb", "w1", "b1", "w2", "b2")
    want = jfb.fused_out_mlp(*(jnp.asarray(d[k]) for k in names), "bf16", 32, True)
    got = tfb.fused_out_mlp(*(_t(d[k]) for k in names))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


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
