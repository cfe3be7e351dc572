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
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha, mha_plain
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


@pytest.mark.parametrize("S", [197, 64])
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


def test_block_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    G, T, D, F = 2, 300, 128, 512

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * s

    x, attn = r(G, T, D).bfloat16(), r(G, T, D).bfloat16()
    lns, lnb = 1 + 0.1 * r(D), 0.1 * r(D)
    wqkv, bqkv = r(G, D, 3 * D, s=0.1).bfloat16(), 0.1 * r(G, 3 * D)
    wo, bo = r(G, D, D, s=0.1).bfloat16(), 0.1 * r(G, D)
    w1, b1 = r(G, D, F, s=0.1).bfloat16(), 0.1 * r(G, F)
    w2, b2 = r(G, F, D, s=0.1).bfloat16(), 0.1 * r(G, D)
    qkv = fb.fused_ln_qkv(x, lns, lnb, wqkv, bqkv)
    out = fb.fused_out_mlp(attn, x, wo, bo, lns, lnb, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert _rel(qkv, fb.ln_qkv_plain(x, lns, lnb, wqkv, bqkv)) < 1e-2
    assert _rel(out, fb.out_mlp_plain(attn, x, wo, bo, lns, lnb, w1, b1, w2, b2)) < 1e-2


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


@pytest.mark.parametrize("G,T,D,F", [(2, 77, 128, 256), (2, 1000, 768, 3072), (1, 300, 96, 208)])
def test_int8_block_kernels(cuda, G, T, D, F):
    """T not a multiple of the 128-row tile; D = 96 and F = 208 not multiples
    of the 128-column tile or the 64-byte k-tile."""
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
    with pytest.raises(ValueError, match="Dh=64"):
        z = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.bfloat16)
        att.splash_attention_bshd(z, z, z)


@pytest.mark.parametrize("N,D,F", [(77, 128, 200), (131, 256, 64), (300, 768, 3072)])
def test_fused_mlp_kernel(cuda, N, D, F):
    """G = 2; N not a multiple of the 64-row tile, F not one of the 64-unit
    hidden chunk, D below the 384-column block."""
    g = torch.Generator(device=cuda).manual_seed(0)
    G = 2

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * s

    x = r(G, N, D).bfloat16()
    w1, b1 = r(G, D, F, s=D**-0.5).bfloat16(), (0.1 * r(G, F)).bfloat16()
    w2, b2 = r(G, F, D, s=F**-0.5).bfloat16(), (0.1 * r(G, D)).bfloat16()
    out = fused_mlp(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert out.shape == (G, N, D) and out.dtype == torch.bfloat16
    assert _rel(out, mlp_plain(x, w1, b1, w2, b2)) < 1e-2


@pytest.mark.parametrize("N,D", [(77, 200), (1000, 768)])
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
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_mlp(z(2, 8, 40), z(2, 40, 64), b1, z(2, 64, 40), z(2, 40))
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
    with pytest.raises(ValueError, match="Dh=64"):
        z = torch.zeros(1, 2, 16, 32, device=cuda, dtype=torch.bfloat16)
        fused_mha(z, z, z)


@pytest.mark.parametrize("M", [25344, 6304, 77])
@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
def test_tiled_matmul(cuda, M, block_rows):
    """Both modes at the probe's K = 768, N = 3072, M a multiple of every row
    tile (25,344) and of none (6,304, 77): int8 bit-exact (exact s32 sums),
    bf16 within the f32 summation order's bf16 roundings."""
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
