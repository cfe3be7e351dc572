#!/usr/bin/env python3
"""Roofline microbenchmarks of the ViT-B/16 embed path on one NVIDIA GPU: the
H100 counterpart of tools/perf_microbench.py, with the same probe names and
the same output line.

    python3 tools_torch/perf_microbench.py [probe ...]              # the card
    python3 tools_torch/perf_microbench.py --device cpu [probe ...]

Probes (default ``all``): xla_bf16 xla_int8 pallas_bf16 pallas_int8
pallas_sweep attn attn2 attn3 attn4 attn5 attn6 ln_quant ln_variants bw floor
miniblock fc2_fusion fc2b fc2c gelu_bwd.  Each prints one line per variant,

    "{label:>28s}: {rate:8.2f} {unit}  ({iters} iters, {gflop:.1f} GFLOP/iter)"

with the JAX tool's conventions (2 M K N operations per matmul; the byte
probes print bytes / 1e12 as the rate and bytes / 1e9 as "GFLOP").  Labels say
what runs on the card: ``cuBLAS`` is ``torch.matmul``, ``_int_mm`` is
``torch._int_mm`` (both yardsticks the port never calls), ``port tiled`` is
``ops/matmul.py::tiled_matmul`` (csrc/matmul.cu), the counterpart of the JAX
tool's Pallas matmul; the rest are the port's own modules or plain PyTorch.

Timing: one round is ``ITERS`` calls between two CUDA events, queued behind a
spin kernel so that the host's dispatch is not timed; the best of 3 rounds
after one warm-up call.  Each call is the bare call: the JAX tool adds
``i * 1e-3`` to its input in every iteration only so that XLA cannot hoist
the body out of its ``fori_loop``, and eager PyTorch runs every call it is
given.  Products of bf16 operands come out in bf16 (cuBLAS rounds the f32
accumulators to the output type); where the JAX probe asks XLA for f32
scores, the port casts the bf16 product to f32, as the model's einsum core
does.

``--device cpu`` runs small shapes (M = 512 rows, 2 calls a round, the
batch-4 attention shapes: what the JAX tool's ``PRCV_CPU=1`` runs) through
the plain versions of the port's kernels, timed on the host clock: a check
that every probe runs, never a device number.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from prcv2025reid_tpu_torch.ops import attention as att  # noqa: E402
from prcv2025reid_tpu_torch.ops.fused_block import quant_rows, quantize_weight  # noqa: E402
from prcv2025reid_tpu_torch.ops.kernel_math import (  # noqa: E402
    gelu_poly_bf16,
    gelu_stored,
    ln_f32,
)
from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS, tiled_matmul  # noqa: E402

ROUNDS = 3
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clock: the host enqueues a round meanwhile
BF16 = torch.bfloat16


class Bench:
    """Where and at what size the probes run: on the card at the model's
    shapes (the MLP's [25,344, 768] @ [768, 3072], 30 calls a round), or on
    the CPU at M = 512 rows with 2 calls a round."""

    def __init__(self, device: str = "cuda"):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card and not torch.cuda.is_available():
            raise RuntimeError("perf_microbench: no CUDA device (use --device cpu for a "
                               "functional run on the host)")
        self.M, self.K, self.N = (25344, 768, 3072) if self.on_card else (512, 768, 3072)
        self.iters = 30 if self.on_card else 2

    def pick(self, card, cpu):
        return card if self.on_card else cpu

    def randn(self, *shape, seed: int, scale: float = 1.0, dtype=BF16) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return (torch.randn(*shape, generator=g, device=self.device) * scale).to(dtype)

    def randint8(self, *shape, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randint(-127, 127, shape, generator=g, device=self.device,
                             dtype=torch.int8)


def timed(b: Bench, fn, *, flops_per_iter: float, label: str, unit: str = "TFLOP/s") -> float:
    """Best rate of ``fn()`` over ROUNDS rounds of ``b.iters`` calls; prints
    the JAX tool's line and returns the rate (per second, unscaled)."""
    out = fn()  # warm-up: builds the kernels, fills the allocator's cache
    first = out[0] if isinstance(out, tuple) else out
    checksum = float(first.reshape(-1)[0].float())
    if not math.isfinite(checksum):
        raise RuntimeError(f"{label}: non-finite checksum")
    del out, first
    best = 0.0
    for _ in range(ROUNDS):
        if b.on_card:
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(b.iters):
                fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(b.iters):
                fn()
            dt = time.perf_counter() - t0
        best = max(best, flops_per_iter * b.iters / dt)
    print(f"{label:>28s}: {best / 1e12:8.2f} {unit}  "
          f"({b.iters} iters, {flops_per_iter / 1e9:.1f} GFLOP/iter)", flush=True)
    return best


def _ln(xf: torch.Tensor) -> torch.Tensor:
    """The probes' LayerNorm: f32, two passes, unit scale and zero bias."""
    D = xf.shape[-1]
    return ln_f32(xf, torch.ones(D, device=xf.device), torch.zeros(D, device=xf.device))


# ---- the matmul probes: the library GEMMs beside the port's tiled kernel

def _bf16_operands(b: Bench):
    return b.randn(b.M, b.K, seed=0), b.randn(b.K, b.N, seed=1)


def _int8_operands(b: Bench):
    """x int8 [M, K]; w int8 [K, N] stored K-major (the layout both
    ``torch._int_mm`` and the port's kernel take), built once."""
    return b.randint8(b.M, b.K, seed=0), b.randint8(b.N, b.K, seed=1).t()


def probe_xla_bf16(b: Bench) -> dict:
    """cuBLAS bf16 GEMM (``torch.matmul``) at the model's biggest matmul."""
    x, w = _bf16_operands(b)
    label = "cuBLAS bf16 matmul"
    return {label: timed(b, lambda: torch.matmul(x, w), flops_per_iter=2.0 * b.M * b.K * b.N,
                         label=label)}


def probe_xla_int8(b: Bench) -> dict:
    """``torch._int_mm``: int8 x int8 -> int32 (cuBLASLt) at the same shape."""
    xq, wq = _int8_operands(b)
    label = "_int_mm int8 matmul"
    return {label: timed(b, lambda: torch._int_mm(xq, wq), flops_per_iter=2.0 * b.M * b.K * b.N,
                         label=label, unit="TOP/s")}


def probe_pallas_bf16(b: Bench) -> dict:
    """The port's tiled bf16 matmul (csrc/matmul.cu), default row tile."""
    x, w = _bf16_operands(b)
    label = "port tiled bf16 matmul"
    return {label: timed(b, lambda: tiled_matmul(x, w), flops_per_iter=2.0 * b.M * b.K * b.N,
                         label=label)}


def probe_pallas_int8(b: Bench) -> dict:
    """The port's tiled int8 matmul, default row tile, int32 out."""
    xq, wq = _int8_operands(b)
    label = "port tiled int8 matmul"
    return {label: timed(b, lambda: tiled_matmul(xq, wq), flops_per_iter=2.0 * b.M * b.K * b.N,
                         label=label, unit="TOP/s")}


def probe_pallas_sweep(b: Bench) -> dict:
    """The port's tiled matmul rate against its row tile (block_rows 64, 128,
    256; the JAX sweep's 512-2112-row Mosaic blocks do not fit a Hopper
    block's shared memory) for bf16 and int8.  Every row is computed at every
    setting (25,344 is a multiple of each)."""
    (x, w), (xq, wq) = _bf16_operands(b), _int8_operands(b)
    flops = 2.0 * b.M * b.K * b.N
    rates = {}
    for R in BLOCK_ROWS:
        label = f"port tiled bf16 R={R}"
        rates[label] = timed(b, lambda R=R: tiled_matmul(x, w, R), flops_per_iter=flops,
                             label=label)
        label = f"port tiled int8 R={R}"
        rates[label] = timed(b, lambda R=R: tiled_matmul(xq, wq, R), flops_per_iter=flops,
                             label=label, unit="TOP/s")
    return rates


# ---- attention

def _attn_operands(b: Bench, B, S, H, Dh):
    return tuple(b.randn(B, S, H, Dh, seed=s) for s in range(3))


def probe_attn(b: Bench) -> dict:
    """Full-model-shaped einsum attention [B=128, S=197, H=12, Dh=64], f32
    against bf16 softmax.  Operations = 2 B H S^2 Dh x 2 (QK^T and PV)."""
    B, S, H, Dh = b.pick((128, 197, 12, 64), (4, 197, 12, 64))
    q, k, v = _attn_operands(b, B, S, H, Dh)
    flops = 2.0 * B * H * S * S * Dh * 2

    def make(dt):
        def fn():
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(dt) * (1.0 / math.sqrt(Dh))
            p = torch.softmax(s, dim=-1).to(BF16)
            return torch.einsum("bhqk,bkhd->bqhd", p, v)
        return fn

    return {label: timed(b, make(dt), flops_per_iter=flops, label=label) for label, dt in (
        ("einsum attn f32 softmax", torch.float32), ("einsum attn bf16 softmax", BF16))}


def probe_attn2(b: Bench) -> dict:
    """Attention implementations at model shapes: PyTorch's SDPA (a yardstick
    the port never calls), the model's einsum core, explicit [B, H, S, Dh]
    copies, and the splash core (the port's attention kernel)."""
    B, S, H, Dh = b.pick((128, 197, 12, 64), (4, 197, 12, 64))
    q, k, v = _attn_operands(b, B, S, H, Dh)
    flops = 2.0 * B * H * S * S * Dh * 2

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)

    def bhsd(q, k, v):
        qt, kt, vt = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * Dh**-0.5
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", p, vt).permute(0, 2, 1, 3)

    ref = att.xla_attention_bshd(q, k, v).float()
    err = (att.splash_attention_bshd(q, k, v).float() - ref).abs().max().item()
    print(f"splash parity max|err| vs xla: {err:.5f}")
    return {label: timed(b, lambda f=f: f(q, k, v), flops_per_iter=flops, label=label)
            for label, f in (("SDPA (PyTorch yardstick)", sdpa),
                             ("model xla_attention_bshd", att.xla_attention_bshd),
                             ("explicit BHSD transposes", bhsd),
                             ("splash core (port kernel)", att.splash_attention_bshd))}


def probe_attn3(b: Bench) -> dict:
    """Attention formulations: bf16 score storage, fewer softmax passes (the
    ones-augmented V folds the normalizer into the PV product, with and
    without the max subtraction) and keys padded to 256."""
    B, S, H, Dh = b.pick((128, 197, 12, 64), (4, 197, 12, 64))
    q, k, v = _attn_operands(b, B, S, H, Dh)
    flops = 2.0 * B * H * S * S * Dh * 2
    scale = Dh**-0.5
    Sp = 256
    neg = torch.zeros(Sp, device=b.device)
    neg[S:] = -1e9

    def ones_col(t):
        return torch.cat([t, torch.ones(*t.shape[:-1], 1, dtype=t.dtype, device=t.device)], -1)

    def v_bf16_store(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        m = s.float().amax(dim=-1, keepdim=True)
        p = torch.exp(s.float() * scale - m * scale)
        return torch.einsum("bhqk,bkhd->bqhd", (p / p.sum(dim=-1, keepdim=True)).to(BF16), v)

    def v_bf16_all(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s * scale, dim=-1), v)

    def v_ones_aug(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        m = s.float().amax(dim=-1, keepdim=True)
        p = torch.exp((s.float() - m) * scale).to(BF16)
        o = torch.einsum("bhqk,bkhe->bqhe", p, ones_col(v))
        return o[..., :Dh] / torch.clamp(o[..., Dh:], min=1e-9)

    def v_padded(q, k, v, bf16_scores):
        kp, vp = (F.pad(t, (0, 0, 0, 0, 0, Sp - S)) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, kp)
        if bf16_scores:
            m = s.float().amax(dim=-1, keepdim=True)
            p = torch.exp((s.float() - m) * scale + neg)
            p = (p / p.sum(dim=-1, keepdim=True)).to(BF16)
        else:
            p = torch.softmax(s.float() * scale + neg, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vp)

    ref = att.xla_attention_bshd(q, k, v).float()
    rates = {}
    for name, f in {
        "baseline bshd f32 (model)": att.xla_attention_bshd,
        "bf16 scores, f32 stats": v_bf16_store,
        "bf16 everything": v_bf16_all,
        "ones-aug denom (1 reduce)": v_ones_aug,
        "ones-aug nomax (0 reduce)": att.xla_attention_bshd_onesaug,
        "padded-256 keys f32": lambda q, k, v: v_padded(q, k, v, False),
        "padded-256 bf16 scores": lambda q, k, v: v_padded(q, k, v, True),
    }.items():
        err = (f(q, k, v).float() - ref).abs().max().item()
        label = f"attn3 {name} |err|{err:.4f}"
        rates[label] = timed(b, lambda f=f: f(q, k, v), flops_per_iter=flops, label=label)
    return rates


def probe_attn4(b: Bench) -> dict:
    """QKV projection + unstack + the ones-augmented core: a packed
    projection split three ways, a free [B, S, 3, H, Dh] reshape, a
    leading-3 projection and three separate projections."""
    B, S, H, Dh = b.pick((160, 197, 12, 64), (4, 197, 4, 16))
    D = H * Dh
    x = b.randn(B, S, D, seed=0)
    w = b.randn(D, 3 * D, seed=1, scale=0.03)
    bias = torch.zeros(3 * D, dtype=BF16, device=b.device)
    flops = 2.0 * B * S * D * 3 * D + 2.0 * B * H * S * S * Dh * 2
    core = att.xla_attention_bshd_onesaug

    def heads(t):
        return t.reshape(B, S, H, Dh)

    def v_split(x):
        q, k, v = (torch.einsum("bsi,io->bso", x, w) + bias).split(D, dim=-1)
        return core(heads(q), heads(k), heads(v))

    def v_reshape5(x):
        qkv = (torch.einsum("bsi,io->bso", x, w) + bias).reshape(B, S, 3, H, Dh)
        return core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])

    w3, b3 = w.reshape(D, 3, D), bias.reshape(3, 1, 1, D)

    def v_lead3(x):
        qkv = torch.einsum("bsi,iko->kbso", x, w3) + b3
        return core(heads(qkv[0]), heads(qkv[1]), heads(qkv[2]))

    wq, wk, wv = (t.contiguous() for t in w.split(D, dim=1))
    bq = torch.zeros(D, dtype=BF16, device=b.device)

    def v_three(x):
        return core(*(heads(torch.einsum("bsi,io->bso", x, wp) + bq) for wp in (wq, wk, wv)))

    ref = v_split(x).float()
    rates = {}
    for name, f in {"packed + split (model)": v_split, "reshape5 strided unstack": v_reshape5,
                    "leading-3 einsum views": v_lead3, "three separate projs": v_three}.items():
        err = (f(x).float() - ref).abs().max().item()
        label = f"attn4 {name} |err|{err:.4f}"
        rates[label] = timed(b, lambda f=f: f(x), flops_per_iter=flops, label=label)
    return rates


def probe_attn5(b: Bench) -> dict:
    """The ones-augmented core + out-projection: the model's division,
    slice and reshape before the out-proj matmul, against folding the per-head
    normalization into the out-proj contraction."""
    B, S, H, Dh = b.pick((160, 197, 12, 64), (4, 197, 4, 16))
    D = H * Dh
    q, k, v = _attn_operands(b, B, S, H, Dh)
    wo = b.randn(D, D, seed=3, scale=0.03)
    bo = torch.zeros(D, dtype=BF16, device=b.device)
    scale = Dh**-0.5
    flops = 2.0 * B * H * S * S * Dh * 2 + 2.0 * B * S * D * D
    ones = torch.ones(B, S, H, 1, dtype=BF16, device=b.device)

    def pv65(q, k, v):  # the core up to (unnormalized out, denominator column)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        p = torch.exp(s.float() * scale).to(q.dtype)
        return torch.einsum("bhqk,bkhe->bqhe", p, torch.cat([v, ones], dim=-1))

    def v_model(q, k, v):
        o = pv65(q, k, v)
        a = (o[..., :Dh] / torch.clamp(o[..., Dh:], min=1e-8)).reshape(B, S, D)
        return torch.einsum("bsi,io->bso", a, wo) + bo

    wo_h = wo.reshape(H, Dh, D)
    wo65 = torch.cat([wo_h, torch.zeros(H, 1, D, dtype=BF16, device=b.device)], dim=1)

    def v_fold(q, k, v):
        o = pv65(q, k, v)
        r = torch.clamp(o[..., Dh], min=1e-8)
        return torch.einsum("bqhe,bqh,heD->bqD", o, 1.0 / r, wo65) + bo

    def v_fold_slice(q, k, v):
        o = pv65(q, k, v)
        r = torch.clamp(o[..., Dh], min=1e-8)
        return torch.einsum("bqhd,bqh,hdD->bqD", o[..., :Dh], 1.0 / r, wo_h) + bo

    def v_einsum4(q, k, v):
        o = pv65(q, k, v)
        a = o[..., :Dh] / torch.clamp(o[..., Dh:], min=1e-8)
        return torch.einsum("bqhd,hdD->bqD", a, wo_h) + bo

    ref = v_model(q, k, v).float()
    rates = {}
    for name, f in {"div+reshape+matmul (model)": v_model,
                    "fold-norm [H,65,D] weight": v_fold,
                    "fold-norm sliced [H,Dh,D]": v_fold_slice,
                    "div + 4d einsum": v_einsum4}.items():
        err = (f(q, k, v).float() - ref).abs().max().item()
        label = f"attn5 {name} |err|{err:.4f}"
        rates[label] = timed(b, lambda f=f: f(q, k, v), flops_per_iter=flops, label=label)
    return rates


def probe_attn6(b: Bench) -> dict:
    """The ones-augmented core in other layouts: heads folded into a
    [B*H, S, Dh] batch, explicit [B, H, S, Dh] transposes; the transposes
    needed to reach a layout are timed as part of it."""
    B, S, H, Dh = b.pick((160, 197, 12, 64), (4, 197, 4, 16))
    q, k, v = _attn_operands(b, B, S, H, Dh)
    flops = 2.0 * B * H * S * S * Dh * 2
    scale = Dh**-0.5

    def finish(o):
        return o[..., :Dh] / torch.clamp(o[..., Dh:], min=1e-8)

    def ones_col(t):
        return torch.cat([t, torch.ones(*t.shape[:-1], 1, dtype=t.dtype, device=t.device)], -1)

    def v_headfold(q, k, v):
        qf, kf, vf = (t.permute(0, 2, 1, 3).reshape(B * H, S, Dh) for t in (q, k, v))
        p = torch.exp(torch.bmm(qf, kf.transpose(1, 2)).float() * scale).to(q.dtype)
        o = torch.bmm(p, ones_col(vf))
        return finish(o).reshape(B, H, S, Dh).permute(0, 2, 1, 3)

    def v_bhsd(q, k, v):
        qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qt, kt).float() * scale).to(q.dtype)
        return finish(torch.einsum("bhqk,bhke->bhqe", p, ones_col(vt))).permute(0, 2, 1, 3)

    def v_control(q, k, v):
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale).to(q.dtype)
        return finish(torch.einsum("bhqk,bkhe->bqhe", p, ones_col(v)))

    ref = att.xla_attention_bshd_onesaug(q, k, v).float()
    rates = {}
    for name, f in {"model bshd 4-D einsums": att.xla_attention_bshd_onesaug,
                    "head-folded [B*H,S,Dh] 3-D": v_headfold,
                    "bhsd transposed 4-D": v_bhsd,
                    "model-form control": v_control}.items():
        err = (f(q, k, v).float() - ref).abs().max().item()
        label = f"attn6 {name} |err|{err:.4f}"
        rates[label] = timed(b, lambda f=f: f(q, k, v), flops_per_iter=flops, label=label)
    return rates


# ---- LayerNorm, quantization, bandwidth, launch floor

def probe_ln_quant(b: Bench) -> dict:
    """LN -> per-row int8 quantization (the port's ``quant_rows``) ->
    ``torch._int_mm`` -> dequantization: the whole quantized linear in plain
    PyTorch, weights quantized per column once (``quantize_weight``)."""
    x, w = _bf16_operands(b)
    wq, ws = quantize_weight(w)

    def fn():
        yq, ys = quant_rows(_ln(x.float()))
        return torch._int_mm(yq, wq).float() * ys * ws

    label = "LN+quant+_int_mm matmul"
    return {label: timed(b, fn, flops_per_iter=2.0 * b.M * b.K * b.N, label=label,
                         unit="TOP/s(effective)")}


def probe_ln_variants(b: Bench) -> dict:
    """Residual + LayerNorm at the model's [1, 128, 197, 768]: which plain
    formulation runs fastest.  Traffic: read x and the branch, write the sum
    and the normalized output."""
    shape = b.pick((1, 128, 197, 768), (1, 4, 197, 768))
    x, br = b.randn(*shape, seed=0), b.randn(*shape, seed=1)
    nbytes = 4.0 * x.numel() * 2
    ones = torch.ones(768, 128, device=b.device) / 768.0

    def stats_two_pass(xf):
        mu = xf.mean(dim=-1, keepdim=True)
        return mu, (xf - mu).square().mean(dim=-1, keepdim=True)

    def stats_fast(xf):
        mu = xf.mean(dim=-1, keepdim=True)
        return mu, xf.square().mean(dim=-1, keepdim=True) - mu.square()

    def stats_matmul(xf):
        mu = (xf @ ones)[..., :1]
        return mu, (xf.square() @ ones)[..., :1] - mu.square()

    def make(stats, flat=False):
        def fn():
            x2 = x + br
            xf = (x2.reshape(-1, 768) if flat else x2).float()
            mu, var = stats(xf)
            y = ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
            return x2, y.reshape(x.shape)
        return fn

    def bf16_sum():
        x2 = x + br
        mu = x2.mean(dim=-1, keepdim=True, dtype=torch.float32)
        xf = x2.float()
        var = (xf * xf).mean(dim=-1, keepdim=True) - mu.square()
        return x2, ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)

    rates = {}
    for name, fn in {"current (2-pass var)": make(stats_two_pass),
                     "fast var (E[x2]-mu2)": make(stats_fast),
                     "flattened 2D": make(stats_two_pass, flat=True),
                     "bf16-in f32-acc sums": bf16_sum,
                     "ones-matmul stats (f32)": make(stats_matmul)}.items():
        label = f"res+LN {name}"
        rates[label] = timed(b, fn, flops_per_iter=nbytes, label=label, unit="TB/s(traffic)")
    return rates


def _copy(b: Bench, rows: int, label: str) -> dict:
    x = b.randn(rows, 768, seed=0)
    return {label: timed(b, lambda: x + 1e-3, flops_per_iter=2.0 * x.numel() * 2, label=label,
                         unit="TB/s")}


def probe_bw(b: Bench) -> dict:
    """Achievable device-memory bandwidth of an elementwise pass (read +
    write of a [25,344, 768] bf16 tensor)."""
    return _copy(b, 25344, "copy r+w bandwidth")


def probe_floor(b: Bench) -> dict:
    """The per-launch floor: the same elementwise pass at four sizes; a rate
    that scales with size is bandwidth-bound, a flat time launch-bound."""
    rates = {}
    for rows in (1584, 6336, 25344, 101376):
        rates.update(_copy(b, rows, f"copy r+w rows={rows}"))
    return rates


# ---- block fragments

def probe_miniblock(b: Bench) -> dict:
    """The model's residual + LN + QKV-matmul pattern against a flattened 2-D
    form (the JAX probe's two optimization_barrier variants are left out:
    eager PyTorch materializes x + branch either way)."""
    shape = b.pick((1, 128, 197, 768), (1, 4, 197, 768))
    G, B, S, D = shape
    x, br = b.randn(*shape, seed=0), b.randn(*shape, seed=1)
    w = b.randn(1, D, 3 * D, seed=2)
    flops = 2.0 * G * B * S * D * 3 * D

    def v_model():
        x2 = x + br
        return x2, torch.einsum("gbsi,gio->gbso", _ln(x2.float()).to(x.dtype), w)

    def v_flat():
        x2 = (x + br).reshape(-1, D)
        qkv = (_ln(x2.float()).to(x.dtype) @ w[0]).reshape(G, B, S, 3 * D)
        return x2.reshape(shape), qkv

    return {f"miniblock {name}": timed(b, f, flops_per_iter=flops, label=f"miniblock {name}")
            for name, f in (("model pattern", v_model), ("flat 2D", v_flat))}


def _mlp_dims(b: Bench):
    B, S, D, F_ = b.pick((128, 197, 768, 3072), (4, 197, 768, 3072))
    return B, S, D, F_


def probe_fc2_fusion(b: Bench) -> dict:
    """fc2 matmul + residual + the next LN's statistics as the model runs it
    (the JAX probe's two optimization_barrier placements are left out: eager
    PyTorch already runs the matmul standalone)."""
    B, S, D, F_ = _mlp_dims(b)
    h, x = b.randn(1, B, S, F_, seed=0), b.randn(1, B, S, D, seed=1)
    w2 = b.randn(1, F_, D, seed=2, scale=0.02)

    def fn():
        x2 = x + torch.einsum("gbsf,gfd->gbsd", h, w2)
        return x2, _ln(x2.float()).to(x2.dtype)

    label = "fc2+res+LN natural (model)"
    return {label: timed(b, fn, flops_per_iter=2.0 * B * S * F_ * D, label=label)}


def probe_fc2b(b: Bench) -> dict:
    """fc2 + residual + LN fed a precomputed h against one fed GELU(pre)
    (the JAX probe's barrier variant is left out: eager PyTorch materializes
    the GELU output anyway)."""
    B, S, D, F_ = _mlp_dims(b)
    pre, x = b.randn(1, B, S, F_, seed=0), b.randn(1, B, S, D, seed=1)
    w2 = b.randn(1, F_, D, seed=2, scale=0.02)

    def tail(h):
        x2 = x + torch.einsum("gbsf,gfd->gbsd", h, w2)
        return x2, _ln(x2.float()).to(x2.dtype)

    return {f"fc2b {name}": timed(b, f, flops_per_iter=2.0 * B * S * F_ * D,
                                  label=f"fc2b {name}")
            for name, f in (("fc2(h) precomputed", lambda: tail(pre)),
                            ("fc2(gelu(pre))", lambda: tail(F.gelu(pre))))}


def probe_fc2c(b: Bench) -> dict:
    """The MLP chain fc1 -> GELU -> fc2 (+ residual + LN) under each GELU
    formulation: exact erf, the bf16 polynomial (``gelu_impl="poly"``), tanh
    (``"tanh"``) and x sigmoid(1.702 x)."""
    B, S, D, F_ = _mlp_dims(b)
    y, x = b.randn(1, B, S, D, seed=0), b.randn(1, B, S, D, seed=1)
    w1 = b.randn(1, D, F_, seed=2, scale=0.05)
    w2 = b.randn(1, F_, D, seed=3, scale=0.02)
    gelus = {"erf": F.gelu, "poly9": gelu_poly_bf16,
             "tanh": lambda h: F.gelu(h, approximate="tanh"),
             "sigmoid": lambda h: h * torch.sigmoid(1.702 * h.float()).to(h.dtype)}
    rates = {}
    for name, g in gelus.items():
        def fn(g=g):
            h = g(torch.einsum("gbsi,gif->gbsf", y, w1))
            x2 = x + torch.einsum("gbsf,gfd->gbsd", h, w2)
            return x2, _ln(x2.float()).to(x2.dtype)

        label = f"fc1+gelu({name})+fc2+res+LN"
        rates[label] = timed(b, fn, flops_per_iter=2.0 * B * S * F_ * D * 2, label=label)
    return rates


def probe_gelu_bwd(b: Bench) -> dict:
    """The MLP chain forward + backward at training shapes (4 x 32 x 197
    rows): autograd's erf GELU (its backward evaluates erf again) against
    ``gelu_stored`` (the forward's erf kept for the backward) and tanh."""
    R, D, F_ = b.pick((25216, 768, 3072), (512, 768, 3072))
    x = b.randn(R, D, seed=0).requires_grad_()
    w1 = b.randn(D, F_, seed=1, scale=0.05).requires_grad_()
    w2 = b.randn(F_, D, seed=2, scale=0.02).requires_grad_()
    flops = 2.0 * R * D * F_ * 2 * 3  # forward 2 matmuls, backward 4

    def make(g):
        def fn():
            out = g(x @ w1) @ w2
            return torch.autograd.grad((out.float() * out.float()).sum(), (x, w1, w2))
        return fn

    return {label: timed(b, make(g), flops_per_iter=flops, label=label) for label, g in (
        ("mlp fwd+bwd erf (autograd)", F.gelu),
        ("mlp fwd+bwd gelu_stored", gelu_stored),
        ("mlp fwd+bwd tanh (ref: not exact)", lambda h: F.gelu(h, approximate="tanh")))}


PROBES = {
    "attn6": probe_attn6,
    "fc2_fusion": probe_fc2_fusion,
    "attn5": probe_attn5,
    "attn3": probe_attn3,
    "fc2b": probe_fc2b,
    "fc2c": probe_fc2c,
    "gelu_bwd": probe_gelu_bwd,
    "attn4": probe_attn4,
    "xla_bf16": probe_xla_bf16,
    "xla_int8": probe_xla_int8,
    "pallas_bf16": probe_pallas_bf16,
    "pallas_int8": probe_pallas_int8,
    "attn": probe_attn,
    "ln_quant": probe_ln_quant,
    "ln_variants": probe_ln_variants,
    "bw": probe_bw,
    "miniblock": probe_miniblock,
    "floor": probe_floor,
    "attn2": probe_attn2,
    "pallas_sweep": probe_pallas_sweep,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", default=["all"],
                    help=f"probe names or 'all' ({' '.join(PROBES)})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    names = list(PROBES) if args.probes == ["all"] else args.probes
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        ap.error(f"unknown probes {unknown}; valid: {list(PROBES)}")
    b = Bench(args.device)
    if b.on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(f"card: {smi.stdout.strip() if smi.returncode == 0 else 'nvidia-smi failed'}")
        print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
              f"torch {torch.__version__} cuda {torch.version.cuda}")
    else:
        print("device: cpu (the kernels' plain versions, host clock: not a device number)")
    failed = []
    for name in names:
        try:
            PROBES[name](b)
        except Exception as e:  # report and go on; the exit code says it
            print(f"probe {name} FAILED: {type(e).__name__}: {str(e)[:200]}", flush=True)
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
