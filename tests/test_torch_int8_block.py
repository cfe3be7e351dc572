"""The port's int8 block plans and splash core against the JAX package.

Same seeded numpy inputs into both; JAX runs its Pallas int8 kernels in
interpret mode on the CPU (as tests/test_fused_block.py does), the port the
plain versions its wrappers take for CPU tensors, fed the same quantized
weights.  The quantizers must agree bit for bit.  The int8 kernels then
compute the same math in f32 with exact int32 products, so outputs agree to
f32 summation order (2e-5), except where an f32 ulp of difference in an LN
statistic or a GELU moves a value across a half step of its int8 rounding:
such a flip moves the outputs that depend on it by one quantization step of
one input, so a few elements may differ by up to FLIP_ATOL, no more than
FLIP_FRACTION of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prcv2025reid_tpu.ops import fused_block as jfb
from prcv2025reid_tpu.ops.attention import xla_attention_bshd as jax_xla_attention_bshd
from prcv2025reid_tpu_torch.ops import attention as tatt
from prcv2025reid_tpu_torch.ops import fused_block as tfb
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha
from prcv2025reid_tpu_torch.ops.kernel_math import gelu_exact, ln_f32

G, T, D, F = 2, 70, 64, 128
TOL = 2e-5
FLIP_ATOL = 5e-2  # one int8 step of an input to a product, at these operand scales
FLIP_FRACTION = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_int8_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    off = np.abs(got - want) > TOL + TOL * np.abs(want)
    assert off.mean() <= FLIP_FRACTION, f"{off.sum()} of {off.size} elements beyond {TOL}"
    np.testing.assert_allclose(got, want, rtol=0, atol=FLIP_ATOL)


def _make_data(g, t, seed=0):
    rng = np.random.default_rng(seed)

    def r(shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        x=r((g, t, D)), attn=r((g, t, D)),
        lns=1.0 + 0.1 * r((D,)), lnb=0.1 * r((D,)),
        wqkv=r((g, D, 3 * D), 0.1), bqkv=0.1 * r((g, 3 * D)),
        wo=r((g, D, D), 0.1), bo=0.1 * r((g, D)),
        w1=r((g, D, F), 0.1), b1=0.1 * r((g, F)),
        w2=r((g, F, D), 0.1), b2=0.1 * r((g, D)),
    )


def _quantize(data):
    """JAX's quantize_weight of each weight, as (JAX pair, port pair)."""
    out = {}
    for k in ("wqkv", "wo", "w1", "w2"):
        q, s = jfb.quantize_weight(jnp.asarray(data[k]))
        out[k] = ((q, s), (torch.from_numpy(np.array(q)), _t(s)))
    return out


@pytest.fixture(scope="module")
def data():
    return _make_data(G, T)


@pytest.fixture(scope="module")
def quantized(data):
    return _quantize(data)


@pytest.mark.parametrize("shape", [(64, 192), (3, 128, 64), (2, 768, 40)])
def test_quantize_weight_is_bit_exact(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    w[..., 0, 0] = 0.0  # a column max need not sit in the first row
    w[..., :, 1] = 0.0  # an all-zero column: scale clamped to 1e-8
    jq, js = jfb.quantize_weight(jnp.asarray(w))
    tq, ts = tfb.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # stored K-major: each output column's weights are one contiguous row
    assert tq.transpose(-1, -2).is_contiguous()


def test_quantize_weight_takes_bf16_weights():
    w = (np.random.default_rng(1).normal(size=(32, 48)) * 0.05).astype(np.float32)
    wb = torch.from_numpy(w).bfloat16()
    jq, js = jfb.quantize_weight(jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16))
    tq, ts = tfb.quantize_weight(wb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_rows_is_bit_exact():
    rng = np.random.default_rng(2)
    y = (rng.normal(size=(6, 300)) * 3.0).astype(np.float32)
    y[1] = 0.0  # scale clamped to 1e-8
    y[2] = 0.0  # max 127: scale 1, so these are half steps, rounded half to even
    y[2, :5] = [127.0, 62.5, -1.5, 1.5, 2.5]
    jq, js = jfb._quant_rows(jnp.asarray(y))
    tq, ts = tfb.quant_rows(torch.from_numpy(y))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[2].item() == 1.0 and tq[2, :5].tolist() == [127, 62, -2, 2, 2]


def test_ln_qkv_int8_plain_matches_pallas(data, quantized):
    d = {k: jnp.asarray(v) for k, v in data.items()}
    jw, tw = quantized["wqkv"]
    want = jfb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], jw, d["bqkv"], "int8", 32, True)
    got = tfb.ln_qkv_int8_plain(_t(data["x"]), _t(data["lns"]), _t(data["lnb"]), *tw,
                                _t(data["bqkv"]))
    assert_int8_close(got.numpy(), want)
    # the public wrapper takes the plain version for CPU tensors
    via = tfb.fused_ln_qkv(_t(data["x"]), _t(data["lns"]), _t(data["lnb"]), tw,
                           _t(data["bqkv"]), quant="int8")
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_ln_qkv_int8_plain_matches_pallas_groups():
    """Three groups (the MM-3 query combo) of 37 rows: a multiple of neither
    the JAX kernel's 32-row block nor the card kernels' 128-row tile."""
    data = _make_data(3, 37, seed=8)
    jw, tw = _quantize(data)["wqkv"]
    d = {k: jnp.asarray(v) for k, v in data.items()}
    want = jfb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], jw, d["bqkv"], "int8", 32, True)
    got = tfb.fused_ln_qkv(_t(data["x"]), _t(data["lns"]), _t(data["lnb"]), tw,
                           _t(data["bqkv"]), quant="int8")
    assert got.shape == (3, 37, 3 * D)
    assert_int8_close(got.numpy(), want)


@pytest.mark.parametrize("quant,groups", [
    pytest.param("int8", None, id="int8"),
    pytest.param("int8_mlp", None, id="int8_mlp"),
    # three groups (the MM-3 query combo) of 37 rows: a multiple of neither
    # the JAX kernel's 32-row block nor the card kernels' tiles
    pytest.param("int8_mlp", (3, 37), id="int8_mlp-G3-T37"),
])
def test_out_mlp_int8_plain_matches_pallas(quant, groups, data, quantized):
    if groups is not None:
        data = _make_data(*groups, seed=7)
        quantized = _quantize(data)
    d = {k: jnp.asarray(v) for k, v in data.items()}
    wo_j = quantized["wo"][0] if quant == "int8" else d["wo"]
    want = jfb.fused_out_mlp(d["attn"], d["x"], wo_j, d["bo"], d["lns"], d["lnb"],
                             quantized["w1"][0], d["b1"], quantized["w2"][0], d["b2"],
                             quant, 32, True)
    common = (_t(data["bo"]), _t(data["lns"]), _t(data["lnb"]), *quantized["w1"][1],
              _t(data["b1"]), *quantized["w2"][1], _t(data["b2"]))
    attn, x = _t(data["attn"]), _t(data["x"])
    if quant == "int8":
        got = tfb.out_mlp_int8_plain(attn, x, *quantized["wo"][1], *common)
        wo_t = quantized["wo"][1]
    else:
        got = tfb.out_mlp_int8mlp_plain(attn, x, _t(data["wo"]), *common)
        wo_t = _t(data["wo"])
    assert_int8_close(got.numpy(), want)
    via = tfb.fused_out_mlp(attn, x, wo_t, _t(data["bo"]), _t(data["lns"]), _t(data["lnb"]),
                            quantized["w1"][1], _t(data["b1"]), quantized["w2"][1],
                            _t(data["b2"]), quant=quant)
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def test_int8_plain_versions_take_the_port_quantizer(data):
    """The port's own quantize_weight (K-major storage) gives the same
    result as JAX's row-major int8 weights fed to the same plain version."""
    d = {k: _t(v) for k, v in data.items()}
    mine = tfb.quantize_weight(d["wqkv"])
    theirs = tuple(_t(a) if i else torch.from_numpy(np.array(a)) for i, a in
                   enumerate(jfb.quantize_weight(jnp.asarray(data["wqkv"]))))
    a = tfb.ln_qkv_int8_plain(d["x"], d["lns"], d["lnb"], *mine, d["bqkv"])
    b = tfb.ln_qkv_int8_plain(d["x"], d["lns"], d["lnb"], *theirs, d["bqkv"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_int8_h_is_quantized_from_f32(data):
    """The int8 MLP quantizes h straight from f32 (no bf16 rounding between
    the GELU and fc2, unlike the bf16 kernels): in bf16 the plain version
    differs from one that rounds h first."""
    d = {k: _t(v).bfloat16() for k, v in data.items()}
    w1, w2 = tfb.quantize_weight(d["w1"]), tfb.quantize_weight(d["w2"])
    x2 = d["x"].float()
    got = tfb._mlp_int8_tail(x2, d["lns"], d["lnb"], *w1, d["b1"], *w2, d["b2"], torch.bfloat16)
    yq, ys = tfb.quant_rows(ln_f32(x2, d["lns"], d["lnb"]))
    h = gelu_exact(tfb._int8_dot(yq, w1[0]) * ys * w1[1] + d["b1"].float()[:, None])
    for hh, same in ((h, True), (h.bfloat16().float(), False)):
        hq, hs = tfb.quant_rows(hh)
        o = tfb._int8_dot(hq, w2[0]) * hs * w2[1]
        ref = (x2 + o + d["b2"].float()[:, None]).bfloat16()
        assert torch.equal(got, ref) == same


@pytest.mark.parametrize("which", ["ln_qkv", "out_mlp_int8", "out_mlp_int8mlp"])
def test_int8_wrappers_raise_under_autograd(which, data):
    d = {k: _t(v) for k, v in data.items()}
    q = {k: tfb.quantize_weight(d[k]) for k in ("wqkv", "wo", "w1", "w2")}
    x = d["x"].requires_grad_()
    with pytest.raises(NotImplementedError, match="serve only"):
        if which == "ln_qkv":
            tfb.fused_ln_qkv(x, d["lns"], d["lnb"], q["wqkv"], d["bqkv"], quant="int8")
        elif which == "out_mlp_int8":
            tfb.fused_out_mlp(d["attn"], x, q["wo"], d["bo"], d["lns"], d["lnb"], q["w1"],
                              d["b1"], q["w2"], d["b2"], quant="int8")
        else:
            tfb.fused_out_mlp(d["attn"], x, d["wo"], d["bo"], d["lns"], d["lnb"], q["w1"],
                              d["b1"], q["w2"], d["b2"], quant="int8_mlp")
    with torch.no_grad():  # no graph is built: allowed
        tfb.fused_ln_qkv(x, d["lns"], d["lnb"], q["wqkv"], d["bqkv"], quant="int8")


def test_quant_values_are_checked(data):
    d = {k: _t(v) for k, v in data.items()}
    with pytest.raises(ValueError, match="quant='fp8'"):
        tfb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"], quant="fp8")
    with pytest.raises(ValueError, match="plan of fused_out_mlp"):
        tfb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"], quant="int8_mlp")
    with pytest.raises(ValueError, match="quant='fp8'"):
        tfb.fused_out_mlp(d["attn"], d["x"], d["wo"], d["bo"], d["lns"], d["lnb"], d["w1"],
                          d["b1"], d["w2"], d["b2"], quant="fp8")


@pytest.mark.parametrize("S,Dh", [(21, 16), (197, 64)])
def test_splash_plain_matches_jax_core(S, Dh):
    """Mosaic splash cannot run on a CPU; it computes the exact softmax
    attention of JAX's einsum core on the pre-scaled q, which at these
    power-of-two scales (0.25, 0.125) is the same arithmetic."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(2, S, 3, Dh)).astype(np.float32) for _ in range(3))
    want = jax_xla_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tatt.bshd_core("splash")(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_splash_plain_prescales_q_in_its_dtype():
    """In bf16 the pre-scale of q is rounded before the product, as splash
    does; with a scale that is not a power of two (Dh = 24) that rounding
    shows in the result."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 9, 2, 24)).astype(np.float32)).bfloat16()
               for _ in range(3))
    got = tatt.splash_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    qs = (q * 24**-0.5).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    w = torch.softmax(logits, dim=-1).bfloat16().float()
    ref = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).bfloat16()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    unrounded = torch.einsum("bqhd,bkhd->bhqk", q.float() * 24**-0.5, k.float())
    assert not torch.equal(logits, unrounded)


def test_splash_core_counts_cuda_launches_only():
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.normal(size=(1, 9, 2, 64))) for _ in range(3))
    before = (tatt.splash_attention_bshd.launches, fused_mha.launches)
    tatt.splash_attention_bshd(q, k, v)
    assert (tatt.splash_attention_bshd.launches, fused_mha.launches) == before
