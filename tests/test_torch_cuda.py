"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present (the kernels have no
CPU mode; the CPU tests hold the plain versions against JAX).  On a machine
with an H100 and no JAX (tests/conftest.py imports jax) run
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
Tolerances: bf16 outputs of the same f32-accumulated arithmetic summed in
another order, so a few bf16 ulps of the output scale.
"""
import numpy as np
import pytest
import torch

from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
from prcv2025reid_tpu_torch.ops import fused_block as fb
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha, mha_plain

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


@pytest.mark.parametrize("S,causal", [(197, False), (33, True), (256, False)])
def test_attention_kernel(cuda, S, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 3, S, 64, generator=g, device=cuda).bfloat16() for _ in range(3))
    out = fused_mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _rel(out, mha_plain(q, k, v, causal)) < 1e-2


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 64, device=cuda)  # f32
    with pytest.raises(ValueError, match="bfloat16"):
        fused_mha(q, q, q)
    with pytest.raises(ValueError, match="Dh=64"):
        z = torch.zeros(1, 2, 16, 32, device=cuda, dtype=torch.bfloat16)
        fused_mha(z, z, z)


@pytest.mark.parametrize("over,counter", [
    ({"block_impl": "fused"}, "block"),
    ({"use_pallas_attention": True}, "attention"),
])
def test_model_paths_launch_kernels(cuda, over, counter):
    base = dict(vision_hidden_dim=128, vision_layers=3, vision_heads=2, vision_mlp_dim=256,
                image_size=64, fusion_dim=32, fusion_num_heads=4)
    cfg = TrainingConfig(**base)
    plain = build_model(cfg, num_classes=5, device=cuda)
    fast = build_model(cfg.replace(**over), num_classes=5, device=cuda)
    imgs = np.random.default_rng(0).integers(0, 256, (4, 4, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((4, 4), np.float32)
    fused_mha.launches = fb.fused_ln_qkv.launches = fb.fused_out_mlp.launches = 0
    got = make_combo_embed_step(fast, ("vis",))(imgs, mask)
    want = make_combo_embed_step(plain, ("vis",))(imgs, mask)
    counts = (fused_mha.launches,) if counter == "attention" else (
        fb.fused_ln_qkv.launches, fb.fused_out_mlp.launches)
    assert all(c == cfg.vision_layers - 1 for c in counts), counts
    assert (got * want).sum(dim=1).min().item() > 0.999
