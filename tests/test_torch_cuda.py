"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present (the kernels have no
CPU mode; the CPU tests hold the plain versions against JAX).  On a machine
with an H100 and no JAX (tests/conftest.py imports jax) run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
Tolerances: bf16 outputs of the same f32-accumulated arithmetic summed in
another order, so a few bf16 ulps of the output scale; the int8 kernels'
products are exact, and an f32 ulp of difference in an LN statistic or the
GELU can flip one int8 rounding, which moves an output by one quantization
step of one input (well inside the same bound).
"""
import numpy as np
import pytest
import torch

from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
from prcv2025reid_tpu_torch.ops import attention as att
from prcv2025reid_tpu_torch.ops import fused_block as fb
from prcv2025reid_tpu_torch.ops import _kernels
from prcv2025reid_tpu_torch.ops.fused_attention import (
    MAX_HEAD_DIM,
    REG_MAX_SEQ,
    attention_route,
    fused_mha,
    mha_plain,
)
from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp, mlp_plain
from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln, resln_plain
from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS, matmul_plain, tiled_matmul

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# the last case is the text tower's causal attention: S = 77, H = 8
@pytest.mark.parametrize("S,H,causal", [(197, 3, False), (33, 3, True), (256, 3, False),
                                        (77, 8, True)])
def test_attention_kernel(cuda, S, H, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, H, S, 64, generator=g, device=cuda).bfloat16() for _ in range(3))
    out = fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _rel(out, mha_plain(q, k, v, causal)) < 1e-2


# past 256 tokens: ViT-L/14 at 224 px (257) and 336 px (577), B/16 at 256 px
# (257), a length no 64-key block divides, the longest the kernel takes; the
# register-held kernel's edges: 264 and 265 (a multiple of its 8-key padding
# and one past it), its longest, REG_MAX_SEQ, and the two-pass kernel's
# shortest, REG_MAX_SEQ + 1
LONG_SEQ = [257, 264, 265, 300, 577, REG_MAX_SEQ, REG_MAX_SEQ + 1, 1024, 1025, 4096]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [50] + LONG_SEQ)
def test_attention_kernel_long_and_short_sequences(cuda, S, causal):
    """#1 against its plain version as the model hands it its operands
    (views of one [B, S, 3, H, Dh] projection), at phase 3's tolerances of
    chip_smoke.py: past 256 tokens both the register-held kernel and the
    two-pass one normalise P before its bf16 cast, as the short path and
    the plain version do."""
    B, H = (2, 3) if S <= 1025 else (1, 2)
    g = torch.Generator(device=cuda).manual_seed(S)
    qkv = torch.randn(B, S, 3, H, 64, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    before = fused_mha.launches
    out = fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = mha_plain(q, k, v, causal)
    assert fused_mha.launches == before + 1 and out.shape == (B, H, S, 64)
    assert _rel(out, want) < 2e-3
    assert (out.float() - want.float()).abs().max().item() < 5e-2


def test_attention_kernel_long_sequence_gradient(cuda):
    """At S = 257 every input gets a finite gradient through FusedMhaFn
    within bf16 rounding of autograd through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = [torch.randn(2, 4, 257, 64, generator=g, device=cuda).bfloat16() for _ in range(3)]
    cot = torch.randn(2, 4, 257, 64, generator=g, device=cuda).bfloat16()
    _, got = _grads(fused_mha, qkv, cot)
    _, want = _grads(mha_plain, qkv, cot)
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all() and _rel(a, b) < 1e-2


def test_attention_kernel_refuses_past_its_longest_sequence(cuda):
    """The lengths end only where the tiles' int32 coordinates do; what the
    kernel refuses now is a head wider than MAX_HEAD_DIM, through fused_mha
    and the splash core alike, with no launch."""
    z = torch.zeros(1, 1, 8, MAX_HEAD_DIM + 8, device=cuda, dtype=torch.bfloat16)
    before = fused_mha.launches
    with pytest.raises(ValueError, match=f"Dh <= {MAX_HEAD_DIM}"):
        fused_mha(z, z, z)
    with pytest.raises(ValueError, match=f"Dh <= {MAX_HEAD_DIM}"):
        zs = z.permute(0, 2, 1, 3)  # [B, S, H, Dh]
        att.splash_attention_bshd(zs, zs, zs)
    with pytest.raises(ValueError, match="S <= 2147483584"):
        attention_route(64, 2**31)
    assert fused_mha.launches == before


# phase 3 of chip_smoke.py: every padded head width (64, 128, 192, 256), the
# zero-padded widths (20: not a multiple of 8), ViT-H/14's 80, ViT-bigG's
# 104; the lengths at each route's edges, causal at the text tower's 77
HEAD_WIDTHS = [8, 16, 20, 40, 72, 80, 96, 104, 128, 200, 256]
ROUTE_EDGES = [(1, False), (77, True), (197, False), (256, False), (257, False), (577, False),
               (REG_MAX_SEQ, False), (REG_MAX_SEQ + 1, False)]


def test_attention_route_is_the_kernels(cuda):
    """ops/fused_attention.py's route table is the one csrc/attention.cu
    dispatches by (its attn_route), at every width and the lengths' edges."""
    fn = _kernels.lib("attention").attn_route
    code = {"attn_fwd_kernel": 1, "attn_reg_kernel": 2, "attn_long_kernel": 3}
    for dh in range(1, MAX_HEAD_DIM + 1):
        for S in (1, 255, 256, 257, REG_MAX_SEQ, REG_MAX_SEQ + 1, 4097, 2**31 - 64):
            kernel, dhp = attention_route(dh, S)
            assert fn(dh, S) == 1000 * code[kernel] + dhp, (dh, S)
    assert fn(MAX_HEAD_DIM + 1, 1) == 0 and fn(64, 2**31 - 63) == 0 and fn(64, 0) == 0


@pytest.mark.parametrize("S,causal", ROUTE_EDGES)
@pytest.mark.parametrize("Dh", HEAD_WIDTHS)
def test_attention_kernel_head_widths(cuda, Dh, S, causal):
    """#1 at every route of the (Dh, S) table against its plain version, on
    views of one [B, S, 3, H, Dh] projection, at phase 3's tolerances."""
    g = torch.Generator(device=cuda).manual_seed(Dh * 1000 + S)
    qkv = torch.randn(2, S, 3, 3, Dh, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    before = fused_mha.launches
    out = fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = mha_plain(q, k, v, causal)
    assert fused_mha.launches == before + 1 and out.shape == (2, 3, S, Dh)
    assert _rel(out, want) < 2e-3
    assert (out.float() - want.float()).abs().max().item() < 5e-2


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [4097, 16385])
@pytest.mark.parametrize("Dh", [64, 128])
def test_attention_kernel_past_4096_tokens(cuda, Dh, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S + Dh)
    q, k, v = (torch.randn(1, 2, S, Dh, generator=g, device=cuda).bfloat16() for _ in range(3))
    out = fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = mha_plain(q, k, v, causal)
    assert _rel(out, want) < 2e-3
    assert (out.float() - want.float()).abs().max().item() < 5e-2


@pytest.mark.parametrize("S", [197, 64, 577])
def test_attention_kernel_strided_views_wrap(cuda, S):
    """q/k/v as views of one [B, S, 3, H, Dh] projection (rows 4,608 bytes
    apart), with 40 x 12 = 480 (batch, head) pairs: more than the resident
    blocks, so each block's walk over the pairs wraps both stages."""
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(40, S, 3, 12, 64, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert _rel(out, mha_plain(q, k, v)) < 1e-2


def _block_operands(cuda, G, T, D, F):
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * s

    return dict(
        x=r(G, T, D).bfloat16(), attn=r(G, T, D).bfloat16(),
        lns=1 + 0.1 * r(D), lnb=0.1 * r(D),
        wqkv=r(G, D, 3 * D, s=D**-0.5).bfloat16(), bqkv=0.1 * r(G, 3 * D),
        wo=r(G, D, D, s=D**-0.5).bfloat16(), bo=0.1 * r(G, D),
        w1=r(G, D, F, s=D**-0.5).bfloat16(), b1=0.1 * r(G, F),
        w2=r(G, F, D, s=F**-0.5).bfloat16(), b2=0.1 * r(G, D),
    )


# G in {1, 3} (the MM-3 query's groups); T = 1, 77, 300 and 6,304 rows (a
# multiple of no tile); D = 96 and F = 208 are multiples of none of the 192-
# and 256-column tiles or the 64-value (bf16) and 128-value (int8) k-tiles
# the last: ViT-L/14's widths (D = 1,024, F = 4,096; the 192-column tiles end
# in a ragged 64 at N = 1,024) on 16 images of 257 tokens
BLOCK_SHAPES = [(300, 128, 512), (1, 128, 512), (77, 96, 208), (6304, 768, 3072),
                (4112, 1024, 4096)]
# the row passes past 1,024 columns (G = 1, a few hundred rows): a warp's row
# of 8 chunks a lane (1,040 .. 2,048; ViT-H/14's 1,280 with F = 5,120) and a
# block's (2,056, 8,192)
WIDE_ROWS = [(1, 300, 1040, 1024), (1, 300, 1280, 5120), (1, 300, 1664, 4096),
             (1, 300, 2048, 1024), (1, 300, 2056, 1024), (1, 300, 8192, 2048)]
# the int8 plans take multiples of 16: a block's row at 2,064
INT8_WIDE_ROWS = [(G, T, 2064 if D == 2056 else D, F) for G, T, D, F in WIDE_ROWS]


@pytest.mark.parametrize("G,T,D,F", WIDE_ROWS)
def test_block_kernels_past_1024_columns(cuda, G, T, D, F):
    """#3 and #5 (bf16) with rows past a warp's four chunks a lane."""
    d = _block_operands(cuda, G, T, D, F)
    qkv = fb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])
    args = (d["attn"], d["x"], d["wo"], d["bo"], d["lns"], d["lnb"], d["w1"], d["b1"], d["w2"],
            d["b2"])
    out = fb.fused_out_mlp(*args)
    torch.cuda.synchronize()
    assert _rel(qkv, fb.ln_qkv_plain(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])) < 2e-3
    assert _rel(out, fb.out_mlp_plain(*args)) < 2e-3


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("T,D,F", BLOCK_SHAPES)
def test_block_kernels(cuda, G, T, D, F):
    """The bf16 kernels #3 (fused_ln_qkv) and #5 (fused_out_mlp)."""
    d = _block_operands(cuda, G, T, D, F)
    qkv = fb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])
    args = (d["attn"], d["x"], d["wo"], d["bo"], d["lns"], d["lnb"], d["w1"], d["b1"], d["w2"],
            d["b2"])
    out = fb.fused_out_mlp(*args)
    torch.cuda.synchronize()
    assert qkv.shape == (G, T, 3 * D) and out.shape == (G, T, D) and out.dtype == torch.bfloat16
    assert _rel(qkv, fb.ln_qkv_plain(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])) < 1e-2
    assert _rel(out, fb.out_mlp_plain(*args)) < 1e-2


@pytest.mark.parametrize("G,T,D,F", [(2, 77, 128, 256), (2, 1000, 768, 3072), (1, 300, 96, 208),
                                     (3, 1, 96, 208), (3, 77, 96, 208), (1, 6304, 768, 3072),
                                     (3, 6304, 768, 3072), (1, 4112, 1024, 4096),
                                     (3, 4112, 1024, 4096)] + INT8_WIDE_ROWS)
def test_int8_block_kernels(cuda, G, T, D, F):
    """#4, #6 and #7.  T not a multiple of the 128-row tile; D = 96 and F =
    208 not multiples of the column tiles or the k-tiles."""
    d = _block_operands(cuda, G, T, D, F)
    q = {k: fb.quantize_weight(d[k]) for k in ("wqkv", "wo", "w1", "w2")}
    common = (d["lns"], d["lnb"], *q["w1"], d["b1"], *q["w2"], d["b2"])
    runs = {
        "ln_qkv": (fb.fused_ln_qkv_int8(d["x"], d["lns"], d["lnb"], *q["wqkv"], d["bqkv"]),
                   fb.ln_qkv_int8_plain(d["x"], d["lns"], d["lnb"], *q["wqkv"], d["bqkv"])),
        "int8": (fb.fused_out_mlp_int8(d["attn"], d["x"], *q["wo"], d["bo"], *common),
                 fb.out_mlp_int8_plain(d["attn"], d["x"], *q["wo"], d["bo"], *common)),
        "int8mlp": (fb.fused_out_mlp_int8mlp(d["attn"], d["x"], d["wo"], d["bo"], *common),
                    fb.out_mlp_int8mlp_plain(d["attn"], d["x"], d["wo"], d["bo"], *common)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in runs.items():
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        assert _rel(got, want) < 1e-2, name
        assert (got.float() - want.float()).abs().max().item() < 0.1, name


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _injection(rows, cols, seed):
    """rows distinct columns out of cols (rows <= cols), one per row."""
    return torch.randperm(cols, generator=torch.Generator().manual_seed(seed))[:rows]


@pytest.mark.parametrize("G,T,D", [(1, 300, 256), (3, 77, 96)])
def test_out_proj_known_values(cuda, G, T, D):
    """The f32 residual epilogue's layout with an exact answer: wo is a
    permutation matrix, so attn @ wo moves each value to one column and
    x2 = x + (attn[..., inv] + bo) in f32 bit for bit; a wrongly swizzled
    sub-tile or residual read moves values."""
    import ctypes

    from prcv2025reid_tpu_torch.ops import _kernels

    g = torch.Generator(device=cuda).manual_seed(8)
    attn = (torch.randn(G, T, D, generator=g, device=cuda) * 4).bfloat16()
    x = torch.randn(G, T, D, generator=g, device=cuda).bfloat16()
    bo = torch.randn(G, D, generator=g, device=cuda)
    perm = _injection(D, D, 9).to(cuda)
    wo = torch.zeros(G, D, D, device=cuda, dtype=torch.bfloat16)
    wo[:, torch.arange(D, device=cuda), perm] = 1
    x2 = torch.full((G, T, D), float("nan"), device=cuda)
    c = _kernels.lib("fused_block").out_proj
    c.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    c.restype = ctypes.c_int
    _kernels.check(c(*_ptrs(attn, x, wo, bo, x2), G, T, D, _kernels.stream_ptr(x)), "out_proj")
    torch.cuda.synchronize()
    moved = torch.empty_like(attn)
    moved[..., perm] = attn
    assert torch.equal(x2, x.float() + (moved.float() + bo[:, None]))


def _ln_qkv_c(cuda, lib, entry, n_ptr):
    import ctypes

    from prcv2025reid_tpu_torch.ops import _kernels

    c = getattr(_kernels.lib(lib), entry)
    c.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
    c.restype = ctypes.c_int
    return c, _kernels.stream_ptr(torch.empty(0, device=cuda))


# G in {1, 3}; T = 300 and 77 rows (a multiple of no 128-row tile); O = 3D =
# 768 and 288, a multiple of neither the 192-column tile nor, at 288, 256
QKV_KNOWN = [(1, 300, 256), (3, 77, 96)]


@pytest.mark.parametrize("G,T,D", QKV_KNOWN)
def test_ln_qkv_known_values(cuda, G, T, D):
    """#3's row pass and GEMM with an exact answer: w maps each input column
    to one output column (weight 1), so every accumulator is one value of
    the row pass's y: out = bf16(y[k] + b) at column sel[k], bf16(b)
    elsewhere, bit for bit; a wrongly swizzled tile, a ragged group's rows
    read or stored across groups, or a bias read off its column moves
    values.  y is bf16(LN(x)), the plain row pass's within one bf16 rounding
    (f32 statistics summed in another order)."""
    O = 3 * D
    g = torch.Generator(device=cuda).manual_seed(14)
    x = (torch.randn(G, T, D, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    lns, lnb = 1 + 0.1 * torch.randn(D, generator=g, device=cuda), 0.1 * torch.randn(
        D, generator=g, device=cuda)
    b = torch.randn(G, O, generator=g, device=cuda)
    sel = _injection(D, O, 15).to(cuda)
    w = torch.zeros(G, D, O, device=cuda, dtype=torch.bfloat16)
    w[:, torch.arange(D, device=cuda), sel] = 1
    y = torch.full((G, T, D), float("nan"), device=cuda).bfloat16()
    out = torch.full((G, T, O), float("nan"), device=cuda).bfloat16()
    c, stream = _ln_qkv_c(cuda, "fused_block", "ln_qkv", 7)
    assert c(*_ptrs(x, lns, lnb, w, b, y, out), G, T, D, O, fb.LN_EPS, stream) == 0
    torch.cuda.synchronize()
    want = b[:, None, :].expand(G, T, O).clone()
    want[..., sel] = y.float() + b[:, None, sel]
    assert torch.equal(out, want.bfloat16())
    want_y = fb.ln_rows_plain(x, lns, lnb, torch.bfloat16)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=2**-7, atol=1e-6)
    assert (y == want_y).float().mean().item() > 0.99


@pytest.mark.parametrize("G,T,D", QKV_KNOWN)
def test_ln_qkv_int8_known_values(cuda, G, T, D):
    """#4's s8 GEMM and dequantizing epilogue with an exact answer: wq maps
    each input column to one output column (weight 1), so out =
    bf16(((yq[k] * ys) * ws) + b) at column sel[k] from the row pass's own
    yq and ys, bf16(b) elsewhere, bit for bit (a row scale that read 0 would
    leave the bias alone); the row pass quantizes the plain LN1 rows, each
    value within one int8 step (an f32 ulp of LN statistic can flip a
    rounding)."""
    O = 3 * D
    g = torch.Generator(device=cuda).manual_seed(16)
    x = (torch.randn(G, T, D, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    lns, lnb = 1 + 0.1 * torch.randn(D, generator=g, device=cuda), 0.1 * torch.randn(
        D, generator=g, device=cuda)
    ws, b = 0.5 + torch.rand(G, O, generator=g, device=cuda), torch.randn(G, O, generator=g,
                                                                          device=cuda)
    sel = _injection(D, O, 17).to(cuda)
    wq = torch.zeros(G, O, D, device=cuda, dtype=torch.int8)  # [N, K] storage
    wq[:, sel, torch.arange(D, device=cuda)] = 1
    yq = torch.empty(G, T, D, dtype=torch.int8, device=cuda)
    ys = torch.empty(G, T, device=cuda)
    out = torch.full((G, T, O), float("nan"), device=cuda).bfloat16()
    c, stream = _ln_qkv_c(cuda, "fused_block_int8", "ln_qkv_int8", 9)
    assert c(*_ptrs(x, lns, lnb, wq, ws, b, yq, ys, out), G, T, D, O, fb.LN_EPS, stream) == 0
    torch.cuda.synchronize()
    acc = torch.zeros(G, T, O, dtype=torch.int32, device=cuda)
    acc[..., sel] = yq.int()
    assert torch.equal(out, ((acc.float() * ys[..., None]) * ws[:, None] + b[:, None]).bfloat16())
    from prcv2025reid_tpu_torch.ops.kernel_math import ln_f32

    want_q, want_s = fb.quant_rows(ln_f32(x.cpu(), lns.cpu(), lnb.cpu()))
    assert (yq.cpu().int() - want_q.int()).abs().max().item() <= 1
    torch.testing.assert_close(ys.cpu(), want_s[..., 0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("G,T,D", [(1, 300, 256), (3, 77, 96), (3, 6304, 768)])
def test_ln_qkv_int8_gives_the_plain_versions_bits(cuda, G, T, D):
    """#4 through its wrapper against ln_qkv_int8_plain on the CPU, bit for
    bit, on rows where no rounding can flip: each row of x is a shuffle of
    +-8 and +-24 (5 : 3), so its mean (0) and variance (256, which the
    epsilon does not move) are exact in f32 in any summation order and
    rsqrt(256) = 1/16 exactly; from there both sides round the same f32
    operations in the same order, and the int8 products are exact.  The
    weights are random, quantized as the model does."""
    O = 3 * D
    g = torch.Generator(device=cuda).manual_seed(18)
    vals = torch.tensor([8.0] * (5 * D // 16) + [24.0] * (3 * D // 16), device=cuda)
    vals = torch.cat([vals, -vals])
    order = torch.rand(G, T, D, generator=g, device=cuda).argsort(dim=-1)
    x = vals[order].bfloat16()
    lns, lnb = 1 + 0.1 * torch.randn(D, generator=g, device=cuda), 0.1 * torch.randn(
        D, generator=g, device=cuda)
    w = (torch.randn(G, D, O, generator=g, device=cuda) * D**-0.5).bfloat16()
    wq, ws = fb.quantize_weight(w)
    b = 0.1 * torch.randn(G, O, generator=g, device=cuda)
    got = fb.fused_ln_qkv_int8(x, lns, lnb, wq, ws, b)
    torch.cuda.synchronize()
    want = fb.ln_qkv_int8_plain(*(t.cpu() for t in (x, lns, lnb, wq, ws, b)))
    assert torch.equal(got.cpu(), want)


def test_qkv_entries_refuse_what_the_gemm_cannot_map(cuda):
    """O % 8 != 0 (a 16-byte TMA stride for the bf16 output and weight) and
    D % 16 != 0 for int8 (the int8 rows' TMA stride) return an error code
    from the C entries, before any launch."""
    z = torch.zeros(4096, device=cuda)
    for lib, entry, n_ptr, D, O in (("fused_block", "ln_qkv", 7, 64, 36),
                                    ("fused_block_int8", "ln_qkv_int8", 9, 64, 36),
                                    ("fused_block_int8", "ln_qkv_int8", 9, 40, 120)):
        c, stream = _ln_qkv_c(cuda, lib, entry, n_ptr)
        assert c(*[z.data_ptr()] * n_ptr, 1, 8, D, O, fb.LN_EPS, stream) != 0, (entry, D, O)
    torch.cuda.synchronize()


@pytest.mark.parametrize("G,T,D,F", [(1, 300, 128, 512), (3, 77, 96, 208)])
def test_fused_out_mlp_known_values(cuda, G, T, D, F):
    """#5 with wo a permutation and w1 = b1 = 0 (so h = GELU(0) = 0 and the
    MLP adds b2): out = bf16(x2 + b2) with x2 = x + (attn P + bo), exactly
    the plain version's bits; checks x2's sub-tiles and fc2's residual read."""
    d = _block_operands(cuda, G, T, D, F)
    perm = _injection(D, D, 10).to(cuda)
    wo = torch.zeros(G, D, D, device=cuda, dtype=torch.bfloat16)
    wo[:, torch.arange(D, device=cuda), perm] = 1
    args = (d["attn"], d["x"], wo, d["bo"], d["lns"], d["lnb"], torch.zeros_like(d["w1"]),
            torch.zeros_like(d["b1"]), d["w2"], d["b2"])
    out = fb.fused_out_mlp(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, fb.out_mlp_plain(*args))


@pytest.mark.parametrize("G,T,D,F", [(1, 300, 128, 512), (3, 77, 96, 208)])
def test_int8_mlp_tail_known_values(cuda, G, T, D, F):
    """The int8 tail's two epilogues with exact answers.  w1q and w2q map
    each input column to one output column (weight 1), so every int32
    accumulator is one int8 value: from the kernel's own yq, ys, hq and hs,
    h = GELU(dq + b1) (the GELU's approximate units aside), each row's max
    |h| bit for bit, hq / hs = quant_rows(h) and out = bf16((x2 + dq) + b2)
    bit for bit.  A wrongly swizzled f32 sub-tile, bf16 tile or residual
    read moves values."""
    import ctypes

    from prcv2025reid_tpu_torch.ops import _kernels
    from prcv2025reid_tpu_torch.ops.kernel_math import gelu_exact

    g = torch.Generator(device=cuda).manual_seed(11)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    x2 = r(G, T, D) * 2
    lns, lnb = 1 + 0.1 * r(D), 0.1 * r(D)
    sel1, sel2 = _injection(D, F, 12).to(cuda), _injection(D, F, 13).to(cuda)
    w1q = torch.zeros(G, F, D, device=cuda, dtype=torch.int8)  # [N, K] storage
    w1q[:, sel1, torch.arange(D, device=cuda)] = 1
    w2q = torch.zeros(G, D, F, device=cuda, dtype=torch.int8)
    w2q[:, torch.arange(D, device=cuda), sel2] = 1
    w1s, w2s = 0.5 + torch.rand(G, F, generator=g, device=cuda), 0.5 + torch.rand(
        G, D, generator=g, device=cuda)
    b1, b2 = 0.1 * r(G, F), 0.1 * r(G, D)
    yq = torch.empty(G, T, D, dtype=torch.int8, device=cuda)
    ys = torch.empty(G, T, device=cuda)
    h = torch.full((G, T, F), float("nan"), device=cuda)
    hmax = torch.empty(G, T, dtype=torch.int32, device=cuda)
    hq = torch.empty(G, T, F, dtype=torch.int8, device=cuda)
    hs = torch.empty(G, T, device=cuda)
    out = torch.empty(G, T, D, dtype=torch.bfloat16, device=cuda)
    c = _kernels.lib("fused_block_int8").mlp_int8
    c.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(*_ptrs(x2, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, yq, ys, h, hmax, hq, hs, out),
           G, T, D, F, fb.LN_EPS, _kernels.stream_ptr(x2))
    _kernels.check(rc, "mlp_int8")
    torch.cuda.synchronize()
    acc1 = torch.zeros(G, T, F, dtype=torch.int32, device=cuda)
    acc1[..., sel1] = yq.int()
    want_h = gelu_exact((acc1.float() * ys[..., None]) * w1s[:, None] + b1[:, None])
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-6)
    assert torch.equal(hmax.view(torch.float32), h.abs().amax(dim=-1))
    # on the CPU: PyTorch's CUDA division by a scalar multiplies by its
    # reciprocal, one ulp off the kernel's (and JAX's) IEEE division
    want_hq, want_hs = fb.quant_rows(h.cpu())
    assert torch.equal(hq.cpu(), want_hq) and torch.equal(hs.cpu(), want_hs[..., 0])
    o = (hq[..., sel2].float() * hs[..., None]) * w2s[:, None]
    assert torch.equal(out, ((x2 + o) + b2[:, None]).bfloat16())


@pytest.mark.parametrize("G", [1, 3])
def test_out_mlp_int8_on_the_gemm_core(cuda, G):
    """#6 with its out-projection on the s8 core, at the MM-3 query's 6,304
    rows a group, against out_mlp_int8_plain at the int8 tolerances."""
    d = _block_operands(cuda, G, 6304, 768, 3072)
    q = {k: fb.quantize_weight(d[k]) for k in ("wo", "w1", "w2")}
    args = (d["attn"], d["x"], *q["wo"], d["bo"], d["lns"], d["lnb"], *q["w1"], d["b1"],
            *q["w2"], d["b2"])
    got = fb.fused_out_mlp_int8(*args)
    torch.cuda.synchronize()
    want = fb.out_mlp_int8_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) < 1e-2
    assert (got.float() - want.float()).abs().max().item() < 0.1


@pytest.mark.parametrize("G,T,D,F", [(1, 300, 256, 512), (3, 77, 96, 208)])
def test_out_mlp_int8_out_projection_known_values(cuda, G, T, D, F):
    """#6's out-projection epilogue (DQ_RES_X) with an exact answer: woq maps
    each input column to one output column (weight 1), so every int32
    accumulator is one int8 value of the kernel's own aq and x2 = (x +
    ((aq[k] * as) * wos)) + bo in f32 bit for bit; a wrongly swizzled f32
    sub-tile, a residual read off its row or a row scale that read 0 moves
    values.  The attention rows quantize as quant_rows does on the CPU."""
    import ctypes

    from prcv2025reid_tpu_torch.ops import _kernels

    g = torch.Generator(device=cuda).manual_seed(19)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda)

    attn, x = (r(G, T, D) * 3).bfloat16(), r(G, T, D).bfloat16()
    perm = _injection(D, D, 20).to(cuda)
    woq = torch.zeros(G, D, D, device=cuda, dtype=torch.int8)  # [N, K] storage
    woq[:, perm, torch.arange(D, device=cuda)] = 1
    wos, bo = 0.5 + torch.rand(G, D, generator=g, device=cuda), r(G, D)
    lns, lnb = torch.ones(D, device=cuda), torch.zeros(D, device=cuda)
    w1q, w2q = (torch.zeros(G, n, k, device=cuda, dtype=torch.int8) for n, k in ((F, D), (D, F)))
    w1s, b1, w2s, b2 = torch.ones(G, F, device=cuda), r(G, F), torch.ones(G, D, device=cuda), r(G, D)
    aq = torch.empty(G, T, D, dtype=torch.int8, device=cuda)
    as_ = torch.empty(G, T, device=cuda)
    x2 = torch.full((G, T, D), float("nan"), device=cuda)
    tail = [torch.empty(G, T, D, dtype=torch.int8, device=cuda), torch.empty(G, T, device=cuda),
            torch.empty(G, T, F, device=cuda), torch.empty(G, T, dtype=torch.int32, device=cuda),
            torch.empty(G, T, F, dtype=torch.int8, device=cuda), torch.empty(G, T, device=cuda)]
    out = torch.empty(G, T, D, dtype=torch.bfloat16, device=cuda)
    c = _kernels.lib("fused_block_int8").out_mlp_int8
    c.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(*_ptrs(attn, x, woq, wos, bo, aq, as_, x2, lns, lnb, w1q, w1s, b1, w2q, w2s, b2,
                  *tail, out), G, T, D, F, fb.LN_EPS, _kernels.stream_ptr(x))
    _kernels.check(rc, "out_mlp_int8")
    torch.cuda.synchronize()
    want_q, want_s = fb.quant_rows(attn.cpu().float())
    assert torch.equal(aq.cpu(), want_q) and torch.equal(as_.cpu(), want_s[..., 0])
    acc = torch.zeros(G, T, D, dtype=torch.int32, device=cuda)
    acc[..., perm] = aq.int()
    dq = (acc.float() * as_[..., None]) * wos[:, None]
    assert torch.equal(x2, (x.float() + dq) + bo[:, None])


def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda):
    d = _block_operands(cuda, 1, 40, 64, 128)
    wq, ws = fb.quantize_weight(d["wqkv"])
    args = (d["x"], d["lns"], d["lnb"])
    with pytest.raises(ValueError, match="K-major"):  # row-major int8 weights
        fb.fused_ln_qkv_int8(*args, wq.contiguous(), ws, d["bqkv"])
    with pytest.raises(ValueError, match="int8"):
        fb.fused_ln_qkv_int8(*args, d["wqkv"], ws, d["bqkv"])
    with pytest.raises(ValueError, match="bfloat16"):
        fb.fused_ln_qkv_int8(d["x"].float(), d["lns"], d["lnb"], wq, ws, d["bqkv"])
    with pytest.raises(ValueError, match="shape"):
        fb.fused_ln_qkv_int8(*args, wq, ws[..., :8], d["bqkv"])
    q1, q2 = fb.quantize_weight(d["w1"]), fb.quantize_weight(d["w2"])
    with pytest.raises(ValueError, match="K-major"):
        fb.fused_out_mlp_int8mlp(d["attn"], d["x"], d["wo"], d["bo"], d["lns"], d["lnb"],
                                 q1[0].contiguous(), q1[1], d["b1"], *q2, d["b2"])
    with pytest.raises(ValueError, match="multiple of 16"):
        z = torch.zeros(1, 8, 40, device=cuda, dtype=torch.bfloat16)
        zq = fb.quantize_weight(torch.zeros(1, 40, 40, device=cuda))
        fb.fused_ln_qkv_int8(z, torch.ones(40, device=cuda), torch.zeros(40, device=cuda),
                             *zq, torch.zeros(1, 40, device=cuda))
    with pytest.raises(ValueError, match="O=36 a multiple of 8"):  # the output's TMA stride
        zq = fb.quantize_weight(torch.zeros(1, 64, 36, device=cuda))
        fb.fused_ln_qkv_int8(d["x"], d["lns"], d["lnb"], *zq, torch.zeros(1, 36, device=cuda))
    with pytest.raises(ValueError, match=f"<= {fb.MAX_LN_WIDTH}"):  # a block's row
        wide = fb.MAX_LN_WIDTH + 16
        z = torch.zeros(1, 8, wide, device=cuda, dtype=torch.bfloat16)
        zq = fb.quantize_weight(torch.zeros(1, wide, 64, device=cuda))
        fb.fused_ln_qkv_int8(z, torch.ones(wide, device=cuda), torch.zeros(wide, device=cuda),
                             *zq, torch.zeros(1, 64, device=cuda))
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off 16
        off = torch.zeros(40 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 40, 64)
        fb.fused_ln_qkv_int8(off, d["lns"], d["lnb"], wq, ws, d["bqkv"])
    with pytest.raises(NotImplementedError, match="serve only"):
        fb.fused_ln_qkv_int8(d["x"], d["lns"].requires_grad_(), d["lnb"], wq, ws, d["bqkv"])


@pytest.mark.parametrize("S", [197, 50])
def test_splash_core(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(3, S, 3, 4, 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = att.splash_attention_bshd.launches
    out = att.splash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and att.splash_attention_bshd.launches == before + 1
    assert _rel(out, att.splash_plain(q, k, v)) < 1e-2
    with pytest.raises(ValueError, match=f"Dh <= {MAX_HEAD_DIM}"):
        z = torch.zeros(1, 8, 2, MAX_HEAD_DIM + 8, device=cuda, dtype=torch.bfloat16)
        att.splash_attention_bshd(z, z, z)


@pytest.mark.parametrize("Dh", [32, 80, 256])
def test_splash_core_head_widths(cuda, Dh):
    """At widths whose scale is no power of two (32, 80) the core pre-scales
    q in its dtype as splash does; at 256 the kernel scales after the product."""
    g = torch.Generator(device=cuda).manual_seed(Dh)
    qkv = torch.randn(3, 257, 3, 4, Dh, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = att.splash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    want = att.splash_plain(q, k, v)
    assert out.shape == q.shape and _rel(out, want) < 2e-3
    assert (out.float() - want.float()).abs().max().item() < 5e-2


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("N,D,F", [(77, 128, 200), (131, 256, 64), (300, 768, 3072),
                                   (6304, 768, 3072), (1, 96, 40), (4112, 1024, 4096)])
def test_fused_mlp_kernel(cuda, G, N, D, F):
    """N a multiple of no 128-row tile (so each group's last tile is ragged
    and must not touch the next group's rows), F a multiple of 8 but not of
    the 256-column fc1 tile or the 64-value k-tile of fc2, D below or not a
    multiple of the 192-column fc2 tile."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * s

    x = r(G, N, D).bfloat16()
    w1, b1 = r(G, D, F, s=D**-0.5).bfloat16(), (0.1 * r(G, F)).bfloat16()
    w2, b2 = r(G, F, D, s=F**-0.5).bfloat16(), (0.1 * r(G, D)).bfloat16()
    out = fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert out.shape == (G, N, D) and out.dtype == torch.bfloat16
    assert _rel(out, mlp_plain(x, w1, b1, w2, b2)) < 1e-2


# past 1,024 columns: a lane's 8 chunks (1,040 .. 2,048), a block's row (2,056
# .. ROW_MAX = 32,768)
@pytest.mark.parametrize("N,D", [(77, 200), (1000, 768), (4112, 1024), (300, 1040),
                                 (300, 1280), (300, 1664), (300, 2048), (300, 2056),
                                 (300, 8192), (40, 32768)])
def test_fused_resln_kernel(cuda, N, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    x, branch = (torch.randn(N, D, generator=g, device=cuda).bfloat16() for _ in range(2))
    scale = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    bias = 0.1 * torch.randn(D, generator=g, device=cuda)
    xn, y = fused_residual_ln(x, branch, scale, bias)
    torch.cuda.synchronize()
    want_xn, want_y = resln_plain(x, branch, scale, bias)
    assert torch.equal(xn, want_xn)
    assert _rel(y, want_y) < 1e-2


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    def z(*shape, dt=torch.bfloat16):
        return torch.zeros(*shape, device=cuda, dtype=dt)

    w1, b1, w2, b2 = z(2, 128, 64), z(2, 64), z(2, 64, 128), z(2, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mlp(z(2, 8, 128, dt=torch.float32), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off 16
        fused_mlp(z(2 * 8 * 128 + 1)[1:].view(2, 8, 128), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_mlp(z(2, 8, 36), z(2, 36, 64), b1, z(2, 64, 36), z(2, 36))
    s = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_residual_ln(z(8, 64, dt=torch.float32), z(8, 64, dt=torch.float32), s, s)
    with pytest.raises(ValueError, match="aligned"):  # not contiguous
        fused_residual_ln(z(8, 64), z(64, 8).t(), s, s)
    with pytest.raises(ValueError, match="aligned"):
        off = z(8 * 64 + 1)[1:].view(8, 64)
        fused_residual_ln(off, off, s, s)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)  # f32
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mha(q, q, q)
    with pytest.raises(ValueError, match=f"Dh <= {MAX_HEAD_DIM}"):
        z = torch.zeros(1, 2, 16, MAX_HEAD_DIM + 8, device=cuda, dtype=torch.bfloat16)
        fused_mha(z, z, z)
    # the bf16 LN1 + QKV kernel: 16-byte TMA strides (D, O multiples of 8), a
    # row in a block's registers (D <= MAX_LN_WIDTH), 16-byte aligned operands
    d = _block_operands(cuda, 1, 40, 64, 128)
    ln = (d["lns"], d["lnb"])
    with pytest.raises(ValueError, match="multiples of 8"):
        fb.fused_ln_qkv(d["x"], *ln, d["wqkv"][..., :36].contiguous(), d["bqkv"][:, :36])
    with pytest.raises(ValueError, match="multiples of 8"):
        z = torch.zeros(1, 8, 36, device=cuda, dtype=torch.bfloat16)
        fb.fused_ln_qkv(z, torch.ones(36, device=cuda), torch.zeros(36, device=cuda),
                        torch.zeros(1, 36, 64, device=cuda, dtype=torch.bfloat16),
                        torch.zeros(1, 64, device=cuda))
    with pytest.raises(ValueError, match=f"D <= {fb.MAX_LN_WIDTH}"):
        wide = fb.MAX_LN_WIDTH + 8
        z = torch.zeros(1, 8, wide, device=cuda, dtype=torch.bfloat16)
        fb.fused_ln_qkv(z, torch.ones(wide, device=cuda), torch.zeros(wide, device=cuda),
                        torch.zeros(1, wide, 64, device=cuda, dtype=torch.bfloat16),
                        torch.zeros(1, 64, device=cuda))
    with pytest.raises(ValueError, match="aligned"):  # contiguous, 2 bytes off 16
        off = torch.zeros(40 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 40, 64)
        fb.fused_ln_qkv(off, *ln, d["wqkv"], d["bqkv"])
    with pytest.raises(ValueError, match="aligned"):  # not contiguous
        fb.fused_ln_qkv(d["x"], *ln, d["wqkv"].transpose(1, 2).contiguous().transpose(1, 2),
                        d["bqkv"])
    with pytest.raises(ValueError, match="bfloat16"):
        fb.fused_ln_qkv(d["x"], *ln, d["wqkv"].float(), d["bqkv"])


@pytest.mark.parametrize("M", [25344, 6304, 77, 1])
@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_tiled_matmul(cuda, M, block_rows):
    """Both modes at the probe's K = 768, N = 3072, M a multiple of every row
    tile (25,344) and of none (6,304, 77, 1): int8 bit-exact (exact s32
    sums), bf16 within the f32 summation order's bf16 roundings."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(M, 768, generator=g, device=cuda).bfloat16()
    w = torch.randn(768, 3072, generator=g, device=cuda).bfloat16()
    xq = torch.randint(-127, 127, (M, 768), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 127, (3072, 768), generator=g, device=cuda, dtype=torch.int8).t()
    before = tiled_matmul.launches
    got, got8 = tiled_matmul(x, w, block_rows), tiled_matmul(xq, wq, block_rows)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 2
    assert got.dtype == torch.bfloat16 and got8.dtype == torch.int32
    assert got.shape == got8.shape == (M, 3072)
    assert _rel(got, matmul_plain(x, w)) < 2e-3
    assert torch.equal(got8, matmul_plain(xq, wq))


@pytest.mark.parametrize("M", [1, 77, 6304, 25344])
@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_tiled_matmul_bf16_edges(cuda, M, block_rows):
    """bf16 at N = 128 (one column tile, half of the 256-wide wgmma tiles)
    and K = 96 (not a multiple of the 64-value k-tile: TMA zero-fills the
    tail), for M from one row to the probe's 25,344."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(M, 96, generator=g, device=cuda).bfloat16()
    w = torch.randn(96, 128, generator=g, device=cuda).bfloat16()
    got = tiled_matmul(x, w, block_rows)
    torch.cuda.synchronize()
    assert got.shape == (M, 128) and got.dtype == torch.bfloat16
    assert _rel(got, matmul_plain(x, w)) < 2e-3


@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_tiled_matmul_bf16_known_values(cuda, block_rows):
    """A layout check with an exact answer: w is a permutation matrix, so
    out[:, perm[k]] = x[:, k] bit for bit (one nonzero product per output);
    a transposed or wrongly swizzled tile of either operand moves values."""
    M, K, N = 300, 256, 256
    x = (torch.arange(M * K, device=cuda) % 251).float().div(8).view(M, K).bfloat16()
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(4)).to(cuda)
    w = torch.zeros(K, N, device=cuda, dtype=torch.bfloat16)
    w[torch.arange(K, device=cuda), perm] = 1
    got = tiled_matmul(x, w, block_rows)
    torch.cuda.synchronize()
    want = torch.empty_like(x)
    want[:, perm] = x
    assert torch.equal(got, want)


@pytest.mark.parametrize("M", [1, 77, 6304, 25344])
@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_tiled_matmul_int8_edges(cuda, M, block_rows):
    """int8 bit for bit at K = 832 (a 64-value tail past the 128-value
    k-tile: TMA zero-fills it) and N = 128 (half of the 256-wide tiles: the
    store clips it), with the full int8 range, -128 included."""
    g = torch.Generator(device=cuda).manual_seed(5)
    xq = torch.randint(-128, 128, (M, 832), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-128, 128, (128, 832), generator=g, device=cuda, dtype=torch.int8).t()
    got = tiled_matmul(xq, wq, block_rows)
    torch.cuda.synchronize()
    assert got.shape == (M, 128) and got.dtype == torch.int32
    assert torch.equal(got, matmul_plain(xq, wq))


@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_tiled_matmul_int8_known_values(cuda, block_rows):
    """The int8 layout check with an exact answer: w (stored K-major) is a
    permutation matrix, so out[:, perm[k]] = x[:, k]; a transposed or wrongly
    swizzled tile of either operand, or of the int32 store, moves values."""
    M, K, N = 300, 256, 256
    x = ((torch.arange(M * K, device=cuda) % 255) - 127).to(torch.int8).view(M, K)
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(4)).to(cuda)
    w = torch.zeros(N, K, device=cuda, dtype=torch.int8)
    w[perm, torch.arange(K, device=cuda)] = 1
    got = tiled_matmul(x, w.t(), block_rows)
    torch.cuda.synchronize()
    want = torch.empty(M, N, device=cuda, dtype=torch.int32)
    want[:, perm] = x.int()
    assert torch.equal(got, want)


def test_tiled_matmul_rejects_what_the_kernel_does_not_take(cuda):
    xq = torch.zeros(64, 768, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"K-major.*w\.t\(\)\.contiguous\(\)\.t\(\)"):
        tiled_matmul(xq, torch.zeros(768, 256, device=cuda, dtype=torch.int8))
    x = torch.zeros(64, 768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N=200 of 128"):
        tiled_matmul(x, torch.zeros(768, 200, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="K=40 a multiple of 32"):
        tiled_matmul(x[:, :40], torch.zeros(40, 256, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="block_rows"):
        tiled_matmul(x, torch.zeros(768, 256, device=cuda, dtype=torch.bfloat16), 32)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_matmul(x.t().contiguous().t(), torch.zeros(768, 256, device=cuda,
                                                       dtype=torch.bfloat16))


def _grads(fn, inputs, cot):
    """fn's output and every input's gradient for cotangent ``cot``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, list(cots))
    return outs, [t.grad for t in leaves]


def _grad_cases(cuda):
    """(name, wrapper, Function, inputs, cotangent) for each bf16 wrapper at
    small widths; bf16 activations and weights, f32 LayerNorm parameters."""
    g = torch.Generator(device=cuda).manual_seed(6)
    G, T, D, F = 2, 150, 128, 512

    def r(*shape, s=1.0, dt=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dt)

    qkv = r(3, 2, 3, 197, 64)
    lns, lnb = 1 + r(D, s=0.1, dt=torch.float32), r(D, s=0.1, dt=torch.float32)
    x, attn = r(G, T, D), r(G, T, D)
    w1, b1, w2, b2 = r(G, D, F, s=D**-0.5), r(G, F, s=0.1), r(G, F, D, s=F**-0.5), r(G, D, s=0.1)
    return [
        ("fused_mha", fused_mha, (*qkv,), r(2, 3, 197, 64)),
        ("fused_mha causal", lambda q, k, v: fused_mha(q, k, v, causal=True), (*qkv,),
         r(2, 3, 197, 64)),
        ("splash_attention_bshd", att.splash_attention_bshd,
         tuple(t.permute(0, 2, 1, 3).contiguous() for t in qkv), r(2, 197, 3, 64)),
        ("fused_ln_qkv", fb.fused_ln_qkv,
         (x, lns, lnb, r(G, D, 3 * D, s=D**-0.5), r(G, 3 * D, s=0.1)), r(G, T, 3 * D)),
        ("fused_out_mlp", fb.fused_out_mlp,
         (attn, x, r(G, D, D, s=D**-0.5), r(G, D, s=0.1), lns, lnb, w1, b1, w2, b2),
         r(G, T, D)),
        ("fused_mlp", fused_mlp, (x, w1, b1, w2, b2), r(G, T, D)),
        ("fused_residual_ln", fused_residual_ln, (x[0], attn[0], lns, lnb),
         (r(T, D), r(T, D))),
    ]


def test_bf16_wrappers_differentiate_on_the_card(cuda):
    """Every input of each bf16 wrapper gets a gradient on the card (the
    kernel's forward, the Function's plain backward), equal within bf16
    rounding to the same Function's backward run on the CPU on the same
    values (its CPU forward is the plain version; the backward is f32 on
    both, so only summation order and the final bf16 rounding differ)."""
    for name, fn, inputs, cot in _grad_cases(cuda):
        outs, got = _grads(fn, inputs, cot)
        assert all(o.grad_fn is not None for o in outs), name
        cpu = tuple(c.cpu() for c in cot) if isinstance(cot, tuple) else cot.cpu()
        _, want = _grads(fn, [t.cpu() for t in inputs], cpu)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a is not None and a.is_cuda and a.dtype == inputs[i].dtype, (name, i)
            assert torch.isfinite(a.float()).all(), (name, i)
            assert _rel(a.cpu(), b) < 1e-2, (name, i, _rel(a.cpu(), b))


COUNTERS = {"fused_mha": fused_mha, "fused_ln_qkv": fb.fused_ln_qkv,
            "fused_out_mlp": fb.fused_out_mlp, "fused_mlp": fused_mlp,
            "fused_residual_ln": fused_residual_ln,
            "fused_ln_qkv_int8": fb.fused_ln_qkv_int8,
            "fused_out_mlp_int8": fb.fused_out_mlp_int8,
            "fused_out_mlp_int8mlp": fb.fused_out_mlp_int8mlp,
            "splash_attention_bshd": att.splash_attention_bshd,
            "tiled_matmul": tiled_matmul}
L = 3  # vision_layers: blocks 0..L-2 in full, then the CLS-only block (plain)


@pytest.mark.parametrize("over,expected", [
    ({"block_impl": "fused"}, {"fused_ln_qkv": L - 1, "fused_out_mlp": L - 1}),
    ({"use_pallas_attention": True}, {"fused_mha": L - 1}),
    ({"use_fused_mlp": True}, {"fused_mlp": L - 1}),
    # the fused-stream trunk runs every block in full
    ({"use_fused_resln": True, "use_fused_mlp": True, "use_pallas_attention": True},
     {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L}),
    ({"block_impl": "fused_qkv"}, {"fused_ln_qkv": L - 1}),
    ({"attn_backend": "splash"}, {"splash_attention_bshd": L - 1, "fused_mha": L - 1}),
    ({"block_impl": "fused_int8"}, {"fused_ln_qkv_int8": L - 1, "fused_out_mlp_int8": L - 1}),
    ({"block_impl": "fused_int8_mlp"},
     {"fused_ln_qkv": L - 1, "fused_out_mlp_int8mlp": L - 1}),
    # the serving formulations are plain PyTorch: no kernel
    ({"attn_backend": "onesaug"}, {}),
    ({"gelu_impl": "tanh"}, {}),
    ({"gelu_impl": "poly"}, {}),
])
def test_model_paths_launch_kernels(cuda, over, expected):
    base = dict(vision_hidden_dim=128, vision_layers=L, vision_heads=2, vision_mlp_dim=256,
                image_size=64, fusion_dim=32, fusion_num_heads=4)
    cfg = TrainingConfig(**base)
    plain = build_model(cfg, num_classes=5, device=cuda)
    fast = build_model(cfg.replace(**over), num_classes=5, device=cuda)
    imgs = np.random.default_rng(0).integers(0, 256, (4, 4, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((4, 4), np.float32)
    for counter in COUNTERS.values():
        counter.launches = 0
    got = make_combo_embed_step(fast, ("vis",))(imgs, mask)
    counts = {n: c.launches for n, c in COUNTERS.items()}
    want = make_combo_embed_step(plain, ("vis",))(imgs, mask)
    assert counts == {n: expected.get(n, 0) for n in COUNTERS}, counts
    # the int8 plans quantize and the serving formulations approximate: 0.99
    # (JAX's own bar for the int8 plans through the trunk)
    inexact = over.get("block_impl", "").startswith("fused_int8") or not expected
    bar = 0.99 if inexact else 0.999
    assert (got * want).sum(dim=1).min().item() > bar


def test_retrieval_metrics_on_the_card_equal_the_cpu(cuda):
    """compute_retrieval_metrics and ranking_equivalence on the card against
    the same calls on the CPU: the same f32 similarities up to summation
    order (TF32 off inside the call, whatever the process default), so the
    same stable orders and the same metrics within float32 sums."""
    from prcv2025reid_tpu_torch.evaluation.protocol import (
        compute_retrieval_metrics,
        ranking_equivalence,
    )

    rng = np.random.default_rng(0)
    base = rng.normal(size=(40, 512))
    g_pids = np.repeat(np.arange(40), 10)
    g = base[g_pids] + rng.normal(size=(400, 512))
    q_pids = rng.integers(0, 42, 300)
    q = np.concatenate([base, rng.normal(size=(2, 512))])[q_pids] + rng.normal(size=(300, 512))
    g, q = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (g, q))
    g, q = g.astype(np.float32), q.astype(np.float32)
    idx = rng.integers(-1, 400, 300).astype(np.int32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # the call must switch it off itself
    try:
        for kw in ({}, {"exclude": idx, "query_chunk": 128}):
            got = compute_retrieval_metrics(q, q_pids, g, g_pids, device=cuda, **kw)
            want = compute_retrieval_metrics(q, q_pids, g, g_pids, device="cpu", **kw)
            assert set(got) == set(want)
            assert all(abs(got[k] - want[k]) <= 1e-6 for k in want), (got, want)
        qt = q + 0.02 * rng.normal(size=q.shape).astype(np.float32)
        got = ranking_equivalence(q, g, qt, g, q_pids, g_pids, device=cuda)
        want = ranking_equivalence(q, g, qt, g, q_pids, g_pids, device="cpu")
        assert got["top_overlap"] == want["top_overlap"]
        assert abs(got["map_delta"] - want["map_delta"]) <= 1e-6
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("active", [("text",), ("nir", "text"), ("nir", "sk", "cp", "text")])
def test_text_combo_step_on_the_card_matches_the_cpu(cuda, active):
    """A text combo through make_combo_embed_step on the card against the
    CPU port on the same f32 weights and inputs: min-cosine >= 0.999."""
    cfg = TrainingConfig(vision_hidden_dim=128, vision_layers=3, vision_heads=2,
                         vision_mlp_dim=256, image_size=64, fusion_dim=32, fusion_num_heads=4,
                         text_hidden_dim=64, text_layers=2, text_heads=4, text_mlp_dim=128,
                         compute_dtype="float32")
    from prcv2025reid_tpu_torch.params import init_params

    params = init_params(cfg, 5, seed=1)
    rng = np.random.default_rng(3)
    B, ctx = 6, cfg.text_context_length
    imgs = rng.integers(0, 256, (B, 4, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((B, 4), np.float32)
    tokens = np.zeros((B, ctx), np.int64)
    for i, length in enumerate([5, ctx, 12, 3, 40, 77]):
        tokens[i, 0], tokens[i, length - 1] = 49406, 49407
        tokens[i, 1:length - 1] = rng.integers(1, 49406, length - 2)
    text_mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    got = make_combo_embed_step(build_model(cfg, params, device=cuda), active)(
        imgs, mask, tokens, text_mask)
    want = make_combo_embed_step(build_model(cfg, params, device="cpu"), active)(
        imgs, mask, tokens, text_mask)
    assert got.is_cuda and got.shape == (B, 32)
    assert (got.cpu() * want).sum(dim=1).min().item() >= 0.999


# the training step at tiny widths; Dh = 64, as the attention kernel takes it
TRAIN_TINY = dict(vision_hidden_dim=128, vision_layers=3, vision_heads=2, vision_mlp_dim=256,
                  image_size=32, fusion_dim=32, sdm_semantic_dim=32, sdm_num_heads=4,
                  fusion_num_heads=4, text_hidden_dim=64, text_layers=2, text_heads=4,
                  text_mlp_dim=128, text_vocab_size=100, text_context_length=16,
                  num_ids_per_batch=4, instances_per_id=2, gradient_accumulation_steps=1,
                  num_epochs=4, warmup_epochs=1)
NO_RANDOMNESS = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                     modality_dropout=0.0)


def _train_batch(seed, B=8):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((B, 16), np.int64)
    for i in range(B):
        n = int(rng.integers(3, 17))
        tokens[i, 0], tokens[i, n - 1] = 98, 99
        tokens[i, 1:n - 1] = rng.integers(1, 98, n - 2)
    return dict(images=rng.integers(0, 256, (B, 4, 32, 32, 3), dtype=np.uint8),
                image_mask=np.ones((B, 4), np.float32), text_tokens=tokens,
                text_mask=np.ones(B, np.float32), labels=np.repeat(np.arange(B // 2), 2))


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Three f32 steps (no dropout) on the card against the same steps on
    the CPU, same weights and batches: every metric within 1e-4 relative
    (f32 products summed in another order), the first moments after step 1
    within 1e-4 of each leaf's largest entry plus 1e-6 of the largest."""
    from prcv2025reid_tpu_torch import init_train_state, make_train_step
    from prcv2025reid_tpu_torch.params import init_params

    cfg = TrainingConfig(**TRAIN_TINY, **NO_RANDOMNESS, compute_dtype="float32")
    params = init_params(cfg, 5, seed=2)
    runs = {}
    for dev in (cuda, "cpu"):
        model = build_model(cfg, params, device=dev)
        state = init_train_state(model, cfg, 10)
        step = make_train_step(model, cfg, 10)
        metrics = []
        for s in range(3):
            state, m = step(state, _train_batch(s), 0.1, 0.18)
            metrics.append({k: float(v) for k, v in m.items()})
            if s == 0:
                mu = [t.cpu() for t in state.opt_state.mu]
        runs[str(dev)] = metrics, mu
    (got, mu_got), (want, mu_want) = runs["cuda"], runs["cpu"]
    for g, w in zip(got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1e-3), (k, g[k], w[k])
    top = max(t.abs().max().item() for t in mu_want)
    for a, b in zip(mu_got, mu_want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item() + 1e-6 * top


@pytest.mark.parametrize("remat", [False, True])
def test_fused_mha_launches_in_the_train_step(cuda, remat):
    """use_pallas_attention: the attention kernel runs in the forward of
    every block but the CLS-only last one (L - 1 a step), or of every block
    twice under remat_blocks (the recompute: 2L); its backward is plain
    PyTorch and launches nothing.  The step makes no host synchronisation."""
    from prcv2025reid_tpu_torch import init_train_state, make_train_step

    cfg = TrainingConfig(**TRAIN_TINY, use_pallas_attention=True, remat_blocks=remat)
    model = build_model(cfg, num_classes=5, device=cuda)
    state = init_train_state(model, cfg, 10)
    step = make_train_step(model, cfg, 10)
    state, _ = step(state, _train_batch(0), 0.1, 0.18)  # warm-up
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in _train_batch(1).items()}
    torch.cuda.synchronize()
    fused_mha.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch, 0.1, 0.18)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    L = cfg.vision_layers
    assert fused_mha.launches == (2 * L if remat else L - 1)
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["total_loss"]))


def test_fused_mha_backward_launches_no_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, 2, 17, 64, generator=g, device=cuda).bfloat16().requires_grad_()
               for _ in range(3))
    fused_mha.launches = 0
    out = fused_mha(q, k, v)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fused_mha.launches == 1
    assert all(t.grad is not None and torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.integers(0, 256, (6, 4, 32, 32, 3), dtype=np.uint8),
             "image_mask": rng.random((6, 4)).astype(np.float32),
             "text_tokens": rng.integers(0, 100, (6, 16)).astype(np.int32),
             "labels": np.arange(6, dtype=np.int32) + i} for i in range(n)]


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_to_device_on_the_card(cuda, size):
    """Every batch arrives on the card equal to its host copy, each pinned
    buffer reused only after its copy completed (7 batches through size + 1
    slots), and neither the feed nor a consumer on another stream makes a
    host synchronisation (sync debug mode 'error')."""
    from prcv2025reid_tpu_torch.data.device_feed import prefetch_to_device

    batches = _host_batches(7)
    consumer = torch.cuda.Stream(cuda)
    sums = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(consumer):
            got = []
            for b in prefetch_to_device(iter(batches), size=size, device=cuda):
                sums.append(b["images"].float().sum())  # read on the consumer's stream
                got.append(b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for g, w, s in zip(got, batches, sums):
        assert set(g) == set(w)
        for k in w:
            assert g[k].device.type == "cuda" and g[k].dtype == torch.from_numpy(w[k]).dtype
            np.testing.assert_array_equal(g[k].cpu().numpy(), w[k])
        assert s.item() == float(w["images"].astype(np.float64).sum())


# ---- token reduction's shapes (blocks after the reduction: S = 96, or 95
# with 'prune'; 128 images of 96 tokens = 12,288 rows) and re-ranking


@pytest.mark.parametrize("S", [96, 95])
def test_attention_kernel_at_the_token_reduced_length(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(128, S, 3, 12, 64, generator=g, device=cuda).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    out = fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert _rel(out, mha_plain(q, k, v)) < 1e-2


def test_block_and_mlp_kernels_at_the_token_reduced_rows(cuda):
    d = _block_operands(cuda, 1, 128 * 96, 768, 3072)
    qkv = fb.fused_ln_qkv(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])
    args = (d["attn"], d["x"], d["wo"], d["bo"], d["lns"], d["lnb"], d["w1"], d["b1"], d["w2"],
            d["b2"])
    out = fb.fused_out_mlp(*args)
    mlp = fused_mlp(d["x"], d["w1"], d["b1"].bfloat16(), d["w2"], d["b2"].bfloat16())
    torch.cuda.synchronize()
    assert _rel(qkv, fb.ln_qkv_plain(d["x"], d["lns"], d["lnb"], d["wqkv"], d["bqkv"])) < 1e-2
    assert _rel(out, fb.out_mlp_plain(*args)) < 1e-2
    assert _rel(mlp, mlp_plain(d["x"], d["w1"], d["b1"].bfloat16(), d["w2"],
                               d["b2"].bfloat16())) < 1e-2


def test_token_reduction_on_the_card_keeps_what_the_cpu_keeps(cuda):
    """keep_indices on the card: among tied scores the lower positions, in
    order (the stable sort; JAX's lax.top_k), and on random states the CPU's
    set; the f32 plain trunk with token_keep embeds as on the CPU."""
    from prcv2025reid_tpu_torch.models.vit import MERVisionTransformer
    from prcv2025reid_tpu_torch.params import init_params

    vit = MERVisionTransformer(embed_dim=64, num_layers=2, num_heads=2, mlp_dim=128,
                               image_size=64, token_keep=6, token_reduce_layer=1, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 3, 17, 64, generator=g, device=cuda)
    assert torch.equal(vit.keep_indices(x).cpu(), vit.keep_indices(x.cpu()))
    x[:, :, 1:] = x[:, :, 1:2]
    assert vit.keep_indices(x).tolist() == [[list(range(6))] * 3] * 2
    cfg = TrainingConfig(vision_hidden_dim=128, vision_layers=3, vision_heads=2,
                         vision_mlp_dim=256, image_size=64, fusion_dim=64,
                         fusion_num_heads=4, compute_dtype="float32", token_keep=6,
                         token_reduce_layer=1)
    params = init_params(cfg, 5, seed=0, perturb=True)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (6, 4, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((6, 4), np.float32)
    got, want = (make_combo_embed_step(build_model(cfg, params, device=d), ("nir", "sk"))(
        images, mask).cpu() for d in (cuda, "cpu"))
    assert (got * want).sum(dim=1).min().item() > 0.99999


@pytest.mark.parametrize("excl", [False, True])
def test_rerank_orders_on_the_card_against_the_cpu(cuda, excl):
    from prcv2025reid_tpu_torch.evaluation.rerank import rerank_orders

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(60, 64))
    g_pids = np.repeat(np.arange(60), 20)
    g = centers[g_pids] + 0.9 * rng.normal(size=(1200, 64))
    q = centers[rng.integers(0, 60, 300)] + 0.9 * rng.normal(size=(300, 64))
    g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    kw = dict(excl_idx=rng.integers(-1, 1200, 300).astype(np.int32)) if excl else {}
    got = rerank_orders(q, g, device=cuda, query_chunk=128, **kw)
    want = rerank_orders(q, g, device="cpu", query_chunk=128, **kw)
    assert got.shape == want.shape == (300, 100)
    assert (got == want).all(axis=1).mean() >= 0.99
    if not excl:  # lam = 1: the card's plain cosine order, exactly
        from prcv2025reid_tpu_torch.evaluation.protocol import similarity

        sims = similarity(torch.from_numpy(q).to(cuda), torch.from_numpy(g).to(cuda))
        plain = torch.argsort(-sims, dim=1, stable=True)[:, :100].cpu().numpy()
        np.testing.assert_array_equal(rerank_orders(q, g, device=cuda, lam=1.0), plain)


def test_serving_engine_on_the_card_matches_the_cpu(cuda, tmp_path):
    """tools_torch/serve_embed.py's engine and gallery over one checkpoint,
    on the card against the CPU (f32, the same uint8 pixels and captions):
    embed_pils, embed_texts and embed_queries at min-cosine >= 0.999; the
    store's search on those features with the same ids, plain and
    re-ranked."""
    import importlib.util
    from pathlib import Path

    from PIL import Image

    from prcv2025reid_tpu_torch import init_train_state
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    spec = importlib.util.spec_from_file_location(
        "port_serve_embed_cuda", Path(__file__).resolve().parents[1] / "tools_torch" /
        "serve_embed.py")
    serve_embed = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve_embed)
    cfg = TrainingConfig(**{**TRAIN_TINY, "inference_batch_size": 4, "compute_dtype": "float32"})
    model = build_model(cfg, device="cpu", num_classes=5, seed=2)
    save_checkpoint(str(tmp_path), model, init_train_state(model, cfg, 3, seed=1),
                    {"epoch": 1, "num_classes": 5, "config": cfg.to_json()}, name="best")
    rng = np.random.default_rng(5)
    imgs = [Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)) for _ in range(6)]
    queries = [{"nir": imgs[0], "text": "a red coat"}, {"sk": imgs[1], "cp": imgs[2]},
               {"nir": imgs[3], "sk": imgs[4], "cp": imgs[5], "text": "a hat"}]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        config, m = serve_embed._load_model(str(tmp_path / "best"), device=dev)
        engine = serve_embed.make_engine(config, m, 4)
        feats = (engine.embed_pils(imgs, "vis"), engine.embed_texts(["a person", "grey shoes"]),
                 engine.embed_queries(queries))
        store = serve_embed.GalleryStore(config.fusion_dim, feats[0], [str(i) for i in range(6)],
                                         min_capacity=4, device=dev)
        rr = {"top_n": 4, "k1": 2, "k2": 2, "lam": 0.3}
        out[dev.type] = feats, [store.search(np.concatenate(feats), 3, rerank=r)
                                for r in (None, rr)]
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert (got * want).sum(axis=1).min() >= 0.999
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert [[e["id"] for e in r] for r in got] == [[e["id"] for e in r] for r in want]


def test_clip_weights_on_the_card_match_the_cpu(cuda, tmp_path):
    """A checkpoint in HF's layout (seeded values) converted and loaded on
    the card, then a vis embed on the fused-stream trunk (the kernels)
    against the same conversion in f32 on the CPU: min-cosine >= 0.999."""
    from prcv2025reid_tpu_torch.params import init_params
    from prcv2025reid_tpu_torch.tools import convert_clip

    cfg = TrainingConfig(**TRAIN_TINY)
    rng = np.random.default_rng(0)
    hf = {k: (rng.normal(0.0, 0.05, shape) + (1.0 if k.endswith("norm1.weight") else 0.0)
              ).astype(dtype) for k, (shape, dtype) in convert_clip.hf_clip_shapes(cfg).items()}
    convert_clip.write_safetensors(str(tmp_path / "model.safetensors"), hf)
    flat = convert_clip.convert_clip_params(convert_clip.load_hf_state_dict(str(tmp_path)),
                                            init_params(cfg, 5, perturb=False), seed=1)
    images = rng.integers(0, 256, (4, 4, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    mask = np.ones((4, 4), np.float32)
    card = build_model(cfg.replace(use_pallas_attention=True, use_fused_mlp=True,
                                   use_fused_resln=True), flat, device=cuda)
    fused_mha.launches = 0
    got = make_combo_embed_step(card, ("vis",))(images, mask).cpu()
    assert fused_mha.launches == cfg.vision_layers
    cpu = build_model(cfg.replace(compute_dtype="float32"), flat, device="cpu")
    want = make_combo_embed_step(cpu, ("vis",))(images, mask)
    assert (got * want).sum(dim=1).min().item() >= 0.999


def test_serving_bundle_on_the_card_matches_the_live_engine(cuda, tmp_path):
    """tools_torch/export_serving.py on the card (a fused-stream checkpoint:
    the graph holds the prcv_reid ops of #1, #8 and #9), loaded by
    tools_torch/serve_artifact.py: a vis embed equals the live engine's on
    the same images, and one batch launches the kernels as the live trunk."""
    import importlib.util
    from pathlib import Path

    from PIL import Image

    from prcv2025reid_tpu_torch import init_train_state
    from prcv2025reid_tpu_torch.ops import library
    from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"port_{name}_cuda", Path(__file__).resolve().parents[1] / "tools_torch" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    export_serving, serve_artifact, serve_embed = (
        load(n) for n in ("export_serving", "serve_artifact", "serve_embed"))
    cfg = TrainingConfig(**{**TRAIN_TINY, "inference_batch_size": 4, "use_pallas_attention": True,
                            "use_fused_mlp": True, "use_fused_resln": True})
    model = build_model(cfg, device="cpu", num_classes=5, seed=2)
    save_checkpoint(str(tmp_path), model, init_train_state(model, cfg, 3, seed=1),
                    {"epoch": 1, "num_classes": 5, "config": cfg.to_json()}, name="best")
    manifest = export_serving.main([f"--model_path={tmp_path / 'best'}",
                                    f"--out_dir={tmp_path / 'bundle'}", "--graphs=gallery_vis"],
                                   device="cuda")
    assert manifest["graphs"]["gallery_vis"]["device"] == "cuda"
    L = cfg.vision_layers
    ep = torch.export.load(str(tmp_path / "bundle" / "gallery_vis.pt2"))
    assert export_serving.graph_ops(ep) == {"fused_mha": L, "fused_mlp": L,
                                            "fused_residual_ln": 2 * L}
    rng = np.random.default_rng(5)
    imgs = [Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)) for _ in range(6)]
    shim, graphs = serve_artifact.load_bundle(str(tmp_path / "bundle"))
    bundle = serve_artifact.make_artifact_engine(shim, graphs)
    before = library.launch_counts()
    got = bundle.embed_pils(imgs[:4], "vis")
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in library.launch_counts().items() if v != before[k]}
    assert launched == {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L}
    config, live_model = serve_embed._load_model(str(tmp_path / "best"), device=cuda)
    live = serve_embed.make_engine(config, live_model, 4)
    got, want = bundle.embed_pils(imgs, "vis"), live.embed_pils(imgs, "vis")
    assert got.shape == want.shape == (6, cfg.fusion_dim)
    assert (got * want).sum(axis=1).min() >= 0.99999
