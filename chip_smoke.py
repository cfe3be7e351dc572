#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from prcv2025reid_tpu_torch/csrc
     (one nvcc per source, in parallel), print ptxas' resource report and
     count the Hopper instructions in the tiled matmul's SASS (cuobjdump:
     HGMMA, wgmma; UTMALDG, TMA loads), failing if either is missing;
  3. hold each kernel against its plain PyTorch version at the gallery-embed
     shapes (B=128 images of 197 tokens, ViT-B/16 widths) on the same bf16
     inputs: relative Frobenius error <= REL_TOL and max-abs error <= ABS_TOL
     (the int8 kernels: INT8_REL_TOL, INT8_ABS_TOL, for rounding flips);
     attention also with causal=True, with kernel_version=1 and at the text
     tower's causal shape (128 captions, S = 77, H = 8), the fused MLP also
     with G=3 groups of 32 images (6,304 rows, not a multiple of its tile);
     the three int8 block kernels on weights quantized as the model does
     (quantize_weight) and the splash core on [B, S, H, Dh] views of one QKV
     projection; the microbenchmark's tiled matmul in both modes at its
     M = 25,344 rows and at a ragged 6,304, for every row tile (block_rows),
     bf16 within REL_TOL / ABS_TOL and int8 bit for bit;
  4. build the full-width ViT-B/16 model (fusion_dim 512, 400 classes, bf16
     compute) from init_params(seed=0, perturb=True) and embed one seeded
     uint8 batch through the entry points (build_model,
     make_combo_embed_step) under thirteen paths: block_impl="xla" (plain),
     block_impl="fused", use_pallas_attention=True, use_fused_mlp=True, the
     fused-stream trunk (use_fused_resln=True with use_fused_mlp and
     use_pallas_attention), the same trunk with the plain MLP
     (use_fused_resln and use_pallas_attention), block_impl="fused_qkv",
     attn_backend="splash", block_impl="fused_int8",
     block_impl="fused_int8_mlp", and the serving formulations
     attn_backend="onesaug", gelu_impl="tanh" and gelu_impl="poly" (plain
     PyTorch: no kernel launch).  Each exact kernel path must reach
     min-cosine >= 0.999 against the plain path, each int8 plan and serving
     formulation >= 0.99 (JAX's own bar for the int8 plans through the trunk;
     the reading against the 0.999 promotion gate is printed, not required),
     and the launch counters,
     zeroed just before each run, must read exactly EXPECTED (one launch per
     block 0..L-2 where the
     last block is CLS-only; the fused-stream trunk runs all L blocks with two
     residual+LN launches each).  The fused-stream trunk is also held against
     the plain path on the MM-3 query combo (nir, sk, cp: three groups).
     Every path must also agree with an f32 embedding of the same images
     computed by the port on the CPU;
  5. time every kernel, its plain version and (where one PyTorch call
     computes the same function) that call with CUDA events, median of
     TIMED_RUNS after warm-up queued behind a spin kernel (device time
     only), beside the least time the card could take;
     time end-to-end embeds/s per configuration (in turns, median of
     E2E_ROUNDS rounds) and print torch.profiler's device time per kernel
     for one embed step of each;
  6. run the roofline probes of tools_torch/perf_microbench.py that measure
     the card's own rates at the model's matmul shape: xla_bf16 (cuBLAS),
     xla_int8 (torch._int_mm), pallas_bf16, pallas_int8 and pallas_sweep (the
     port's tiled matmul), bw (copy bandwidth) and floor (the per-launch
     floor); a probe that raises fails the run.

Results go to standard output; the line before the last is the JSON
``{"kernels": [...]}``, the last line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REL_TOL = 2e-3  # measured <= 3.5e-4 on an H100 (PERF.md)
ABS_TOL = 5e-2
# the int8 kernels against their plain versions: an f32 ulp of difference in an
# LN statistic flips one int8 rounding of a row's LN2 output, which moves h by a
# fraction of its quantization step in every column, re-rounds a share of that
# row's int8 h and moves its outputs by ~0.01-0.02 before the bf16 rounding
# (measured max-abs 0.047, rel <= 9.6e-4 on an H100, PERF.md)
INT8_REL_TOL = 5e-3
INT8_ABS_TOL = 0.125  # two bf16 ulps at |out| in [4, 8)
MIN_COSINE = 0.999
F32_MIN_COSINE = 0.99
TIMED_RUNS = 25
WARMUP_RUNS = 3
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: the host enqueues the runs meanwhile
E2E_ITERS = 10
E2E_ROUNDS = 3
TOP_KERNELS = 8
BATCH = 128
NUM_CLASSES = 400
APPROX_MIN_COSINE = 0.99  # int8 plans, serving formulations: JAX's int8 bar through the trunk
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MM3_QUERY = ("nir", "sk", "cp")
MATMUL_ROWS = (25344, 6304)  # the microbenchmark's M, and a multiple of no row tile
MICROBENCH = ("xla_bf16", "xla_int8", "pallas_bf16", "pallas_int8", "pallas_sweep", "bw",
              "floor")


def fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(work, nbytes: float):
    """The least time for ``work``, [(operations, peak rate of their type),
    ...], and ``nbytes`` of traffic: the larger of the two times."""
    t_ops, t_bytes = sum(n / peak for n, peak in work), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, runs=TIMED_RUNS):
    """Median device time of ``fn()`` over ``runs`` launches (CUDA events
    around each).  A spin kernel queued first keeps the card busy while the
    host enqueues the runs, so the host's time between launches (longer
    than a 60 us kernel) is not timed."""
    for _ in range(WARMUP_RUNS):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    pairs = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_time(event) -> float:
    """Device (CUDA) self time of a profiler row in microseconds."""
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def errors(torch, got, want, rel_tol=REL_TOL, abs_tol=ABS_TOL):
    d = got.float() - want.float()
    rel = (d.norm() / want.float().norm()).item()
    mx = d.abs().max().item()
    if not (torch.isfinite(got.float()).all() and rel <= rel_tol and mx <= abs_tol):
        return mx, rel, False
    return mx, rel, True


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    if not (root / "prcv2025reid_tpu_torch" / "csrc").is_dir():
        fail(f"{root} is not a checkout of the repository (no prcv2025reid_tpu_torch/csrc)")
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
    from prcv2025reid_tpu_torch.ops import _kernels
    from prcv2025reid_tpu_torch.ops import attention as att
    from prcv2025reid_tpu_torch.ops import fused_block as fb
    from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha, mha_plain
    from prcv2025reid_tpu_torch.ops.fused_mlp import fused_mlp, mlp_plain
    from prcv2025reid_tpu_torch.ops.fused_resln import fused_residual_ln, resln_plain
    from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS, matmul_plain, tiled_matmul
    from prcv2025reid_tpu_torch.params import init_params

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, {len(_kernels.SOURCES)} sources in parallel)")
    for name, log in _kernels.build_logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")
    # the bf16 tiled matmul is wgmma fed by TMA: both must be in its SASS
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(cuobjdump).exists():
        so = _kernels.lib("matmul")._name
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              timeout=120).stdout
        counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
        print(f"sass {Path(so).name}: {counts}")
        if not all(counts.values()):
            fail(f"the tiled matmul's SASS lacks wgmma or TMA loads: {counts}")
    else:
        print("sass: cuobjdump not found; the HGMMA / UTMALDG check is skipped")

    # ---- 3. kernels against their plain versions at the slice's shapes
    cfg = TrainingConfig()
    D, H, F = cfg.vision_hidden_dim, cfg.vision_heads, cfg.vision_mlp_dim
    S = cfg.num_patches + 1
    Dh, T = D // H, BATCH * S
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    failures = []
    # attention operands as the model hands them over: views of one QKV projection
    qkv = randn(BATCH, S, 3, H, Dh).bfloat16()
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    att_checks = {}
    for causal, version in ((False, 2), (True, 2), (False, 1)):
        got = fused_mha(q, k, v, causal=causal, kernel_version=version)
        torch.cuda.synchronize()
        mx, rel, ok = errors(torch, got, mha_plain(q, k, v, causal))
        att_checks[(causal, version)] = (mx, rel)
        print(f"check fused_mha causal={causal} v{version}: max_abs {mx:.3e} rel {rel:.3e}"
              f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fused_mha causal={causal} v{version}")

    x = randn(1, T, D).bfloat16()
    attn = randn(1, T, D).bfloat16()
    lns, lnb = 1 + 0.1 * randn(D), 0.1 * randn(D)
    wqkv, bqkv = randn(1, D, 3 * D, scale=D**-0.5).bfloat16(), 0.1 * randn(1, 3 * D)
    wo, bo = randn(1, D, D, scale=D**-0.5).bfloat16(), 0.1 * randn(1, D)
    w1, b1 = randn(1, D, F, scale=D**-0.5).bfloat16(), 0.1 * randn(1, F)
    w2, b2 = randn(1, F, D, scale=F**-0.5).bfloat16(), 0.1 * randn(1, D)
    qkv_args = (x, lns, lnb, wqkv, bqkv)
    mlp_args = (attn, x, wo, bo, lns, lnb, w1, b1, w2, b2)
    # the fused MLP takes bf16 biases (the model casts them to the compute dtype)
    fmlp_args = (x, w1, b1.bfloat16(), w2, b2.bfloat16())
    G3, N3 = len(MM3_QUERY), 32 * S  # the MM-3 query batch: 6,304 rows per group
    fmlp3_args = (randn(G3, N3, D).bfloat16(), randn(G3, D, F, scale=D**-0.5).bfloat16(),
                  (0.1 * randn(G3, F)).bfloat16(), randn(G3, F, D, scale=F**-0.5).bfloat16(),
                  (0.1 * randn(G3, D)).bfloat16())
    resln_args = (x[0], attn[0], lns, lnb)
    # the int8 plans: the weights quantized as MERBlock does, on the card
    q_wqkv, q_wo, q_w1, q_w2 = (fb.quantize_weight(w) for w in (wqkv, wo, w1, w2))
    qkv8_args = (x, lns, lnb, *q_wqkv, bqkv)
    mlp8_args = (attn, x, *q_wo, bo, lns, lnb, *q_w1, b1, *q_w2, b2)
    mlp8m_args = (attn, x, wo, bo, lns, lnb, *q_w1, b1, *q_w2, b2)
    splash_args = tuple(qkv[:, :, i] for i in range(3))  # [B, S, H, Dh] views
    block_checks = {}
    for name, kern, plain, args in (
        ("fused_ln_qkv", fb.fused_ln_qkv, fb.ln_qkv_plain, qkv_args),
        ("fused_out_mlp", fb.fused_out_mlp, fb.out_mlp_plain, mlp_args),
        ("fused_mlp", fused_mlp, mlp_plain, fmlp_args),
        ("fused_mlp G=3", fused_mlp, mlp_plain, fmlp3_args),
        ("fused_residual_ln xn", lambda *a: fused_residual_ln(*a)[0],
         lambda *a: resln_plain(*a)[0], resln_args),
        ("fused_residual_ln y", lambda *a: fused_residual_ln(*a)[1],
         lambda *a: resln_plain(*a)[1], resln_args),
        ("fused_ln_qkv_int8", fb.fused_ln_qkv_int8, fb.ln_qkv_int8_plain, qkv8_args),
        ("fused_out_mlp_int8", fb.fused_out_mlp_int8, fb.out_mlp_int8_plain, mlp8_args),
        ("fused_out_mlp_int8mlp", fb.fused_out_mlp_int8mlp, fb.out_mlp_int8mlp_plain,
         mlp8m_args),
        ("splash_attention_bshd", att.splash_attention_bshd, att.splash_plain, splash_args),
    ):
        got = kern(*args)
        torch.cuda.synchronize()
        tols = (INT8_REL_TOL, INT8_ABS_TOL) if "int8" in name else (REL_TOL, ABS_TOL)
        mx, rel, ok = errors(torch, got, plain(*args), *tols)
        block_checks[name] = (mx, rel)
        print(f"check {name}: max_abs {mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    # the microbenchmark's tiled matmul: x [M, 768] @ w [768, 3072]; the bf16
    # weight scaled as the model's (outputs of order 1, where ABS_TOL is a few
    # bf16 ulps), the int8 weight K-major, as the kernel takes it
    mm_args, mm_err = {}, {"bf16": 0.0, "int8": 0}
    for rows in MATMUL_ROWS:
        wq = torch.randint(-127, 127, (F, D), generator=gen, device=dev, dtype=torch.int8).t()
        xq = torch.randint(-127, 127, (rows, D), generator=gen, device=dev, dtype=torch.int8)
        bf16_args = (randn(rows, D).bfloat16(), randn(D, F, scale=D**-0.5).bfloat16())
        for mode, args in (("bf16", bf16_args), ("int8", (xq, wq))):
            want = matmul_plain(*args)
            for block_rows in BLOCK_ROWS:
                got = tiled_matmul(*args, block_rows)
                torch.cuda.synchronize()
                if mode == "int8":  # exact s32 sums: bit for bit
                    ok = got.dtype == torch.int32 and torch.equal(got, want)
                    mx, rel = (got.double() - want.double()).abs().max().item(), 0.0
                else:
                    mx, rel, ok = errors(torch, got, want)
                mm_err[mode] = max(mm_err[mode], mx)
                name = f"tiled_matmul {mode} M={rows} block_rows={block_rows}"
                print(f"check {name}: max_abs {mx:.3e} rel {rel:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(name)
            if rows == MATMUL_ROWS[0]:
                mm_args[mode] = args
    # the text tower's causal attention: 128 captions of 77 tokens, 8 heads
    tqkv = randn(BATCH, 77, 3, 8, Dh).bfloat16()
    tq, tk, tv = (tqkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    got = fused_mha(tq, tk, tv, causal=True)
    torch.cuda.synchronize()
    mx, rel, ok = errors(torch, got, mha_plain(tq, tk, tv, True))
    att_checks["text"] = (mx, rel)
    print(f"check fused_mha causal=True text S=77 H=8: max_abs {mx:.3e} rel {rel:.3e}"
          f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fused_mha text S=77 H=8 causal")
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")

    # ---- 4. the main path at full ViT-B/16 width
    t0 = time.perf_counter()
    params = init_params(cfg, NUM_CLASSES, seed=0, perturb=True)
    print(f"init_params: {time.perf_counter() - t0:.1f} s, {sum(a.size for a in params.values())} values")
    L = cfg.vision_layers
    configs = {
        "xla": cfg,
        "fused": cfg.replace(block_impl="fused"),
        "pallas_attention": cfg.replace(use_pallas_attention=True),
        "fused_mlp": cfg.replace(use_fused_mlp=True),
        "fused_trunk": cfg.replace(use_fused_resln=True, use_fused_mlp=True,
                                   use_pallas_attention=True),
        # the fused-stream trunk with the plain MLP: what the MLP kernel costs it
        "fused_resln": cfg.replace(use_fused_resln=True, use_pallas_attention=True),
        "fused_qkv": cfg.replace(block_impl="fused_qkv"),
        "splash": cfg.replace(attn_backend="splash"),
        "fused_int8": cfg.replace(block_impl="fused_int8"),
        "fused_int8_mlp": cfg.replace(block_impl="fused_int8_mlp"),
        "onesaug": cfg.replace(attn_backend="onesaug"),
        "gelu_tanh": cfg.replace(gelu_impl="tanh"),
        "gelu_poly": cfg.replace(gelu_impl="poly"),
    }
    # held at APPROX_MIN_COSINE, their 0.999 reading printed
    approx_paths = ("fused_int8", "fused_int8_mlp", "onesaug", "gelu_tanh", "gelu_poly")
    counters = {"fused_mha": fused_mha, "fused_ln_qkv": fb.fused_ln_qkv,
                "fused_out_mlp": fb.fused_out_mlp, "fused_mlp": fused_mlp,
                "fused_residual_ln": fused_residual_ln,
                "fused_ln_qkv_int8": fb.fused_ln_qkv_int8,
                "fused_out_mlp_int8": fb.fused_out_mlp_int8,
                "fused_out_mlp_int8mlp": fb.fused_out_mlp_int8mlp,
                "splash_attention_bshd": att.splash_attention_bshd,
                "tiled_matmul": tiled_matmul}
    expected = {  # launches per forward
        "xla": {},
        "fused": {"fused_ln_qkv": L - 1, "fused_out_mlp": L - 1},
        "pallas_attention": {"fused_mha": L - 1},
        "fused_mlp": {"fused_mlp": L - 1},
        "fused_trunk": {"fused_mha": L, "fused_mlp": L, "fused_residual_ln": 2 * L},
        "fused_resln": {"fused_mha": L, "fused_residual_ln": 2 * L},
        "fused_qkv": {"fused_ln_qkv": L - 1},
        # the splash core launches the attention kernel once per call
        "splash": {"splash_attention_bshd": L - 1, "fused_mha": L - 1},
        "fused_int8": {"fused_ln_qkv_int8": L - 1, "fused_out_mlp_int8": L - 1},
        "fused_int8_mlp": {"fused_ln_qkv": L - 1, "fused_out_mlp_int8mlp": L - 1},
        # the serving formulations are plain PyTorch
        "onesaug": {},
        "gelu_tanh": {},
        "gelu_poly": {},
    }
    Mv = len(cfg.vision_modalities)
    images = torch.randint(0, 256, (BATCH, Mv, cfg.image_size, cfg.image_size, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    image_mask = torch.ones(BATCH, Mv, device=dev)
    models, steps, embeds, launches = {}, {}, {}, {}

    def run_counted(name, step, active):
        """One embed with every counter zeroed just before it; fails unless
        the counts read EXPECTED and the embedding is finite and unit-norm."""
        for counter in counters.values():
            counter.launches = 0
        e = step(images, image_mask)
        torch.cuda.synchronize()
        got = {n: f.launches for n, f in counters.items()}
        norms = e.norm(dim=1)
        if e.shape != (BATCH, cfg.fusion_dim) or not torch.isfinite(e).all() or \
                (norms - 1).abs().max().item() > 1e-3:
            fail(f"{name} {active}: embedding not finite/unit-norm of shape "
                 f"{(BATCH, cfg.fusion_dim)}")
        want = {n: expected[name].get(n, 0) for n in counters}
        print(f"main path {name} {active}: launches {got} (expected {want})")
        if got != want:
            fail(f"{name} {active}: launch counts {got} != {want}")
        return e, got

    for name, c in configs.items():
        models[name] = build_model(c, params, device="cuda")
        steps[name] = make_combo_embed_step(models[name], ("vis",))
        embeds[name], launches[name] = run_counted(name, steps[name], ("vis",))
    gate = {}
    for name in configs:
        if name == "xla":
            continue
        gate[name] = (embeds[name] * embeds["xla"]).sum(dim=1).min().item()
        bar = APPROX_MIN_COSINE if name in approx_paths else MIN_COSINE
        promo = (f"; promotion gate {MIN_COSINE}: "
                 f"{'met' if gate[name] >= MIN_COSINE else 'missed'}") if name in approx_paths else ""
        print(f"gate {name} vs xla: min-cosine {gate[name]:.6f} (>= {bar}){promo}")
        if gate[name] < bar:
            fail(f"{name}: min-cosine {gate[name]} < {bar}")
    print(f"gate fused_int8_mlp >= fused_int8 (JAX tests/test_fused_block.py:273): "
          f"{gate['fused_int8_mlp'] >= gate['fused_int8']} "
          f"({gate['fused_int8_mlp']:.6f} vs {gate['fused_int8']:.6f})")
    # the MM-3 query combo: three vision groups in one trunk call
    mm3 = {name: run_counted(name, make_combo_embed_step(models[name], MM3_QUERY), MM3_QUERY)[0]
           for name in ("xla", "fused_trunk")}
    gate["fused_trunk " + "+".join(MM3_QUERY)] = g3 = \
        (mm3["fused_trunk"] * mm3["xla"]).sum(dim=1).min().item()
    print(f"gate fused_trunk {MM3_QUERY} vs xla: min-cosine {g3:.6f} (>= {MIN_COSINE})")
    if g3 < MIN_COSINE:
        fail(f"fused_trunk {MM3_QUERY}: min-cosine {g3} < {MIN_COSINE}")
    del models, mm3

    # reference on a small input: the port in f32 on the CPU, same images
    n_ref = 4
    ref_model = build_model(cfg.replace(compute_dtype="float32"), params, device="cpu")
    ref = make_combo_embed_step(ref_model, ("vis",))(images[:n_ref].cpu(), image_mask[:n_ref].cpu())
    for name, e in embeds.items():
        cos = (e[:n_ref].cpu() * ref).sum(dim=1).min().item()
        print(f"reference {name} (bf16, card) vs f32 CPU: min-cosine {cos:.6f} (>= {F32_MIN_COSINE})")
        if cos < F32_MIN_COSINE:
            fail(f"{name}: min-cosine {cos} against the f32 CPU reference < {F32_MIN_COSINE}")
    del ref_model

    # ---- 5. timing
    import torch.nn.functional as Fn

    rows = []
    att_bytes = 4 * BATCH * H * S * Dh * 2
    att_flops = 4 * BATCH * H * S * S * Dh
    b_ms, b_by = bound_ms([(att_flops, PEAK_BF16_FLOPS)], att_bytes)
    sdpa_ms = time_ms(torch, lambda: Fn.scaled_dot_product_attention(q, k, v))
    rows.append(dict(
        name="fused_mha", route="cuda", source="prcv2025reid_tpu_torch/csrc/attention.cu",
        replaces="prcv2025reid_tpu/ops/pallas_attention.py:115",
        launches=launches["pallas_attention"]["fused_mha"],
        max_abs_err=max(mx for mx, _ in att_checks.values()),
        ms=time_ms(torch, lambda: fused_mha(q, k, v)),
        plain_ms=time_ms(torch, lambda: mha_plain(q, k, v)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=sdpa_ms,
    ))
    O = 3 * D
    qkv_bytes = T * D * 2 + D * O * 2 + O * 4 + 2 * D * 4 + T * O * 2
    b_ms, b_by = bound_ms([(2 * T * D * O, PEAK_BF16_FLOPS)], qkv_bytes)
    rows.append(dict(
        name="fused_ln_qkv", route="cuda", source="prcv2025reid_tpu_torch/csrc/fused_block.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:97",
        launches=launches["fused"]["fused_ln_qkv"],
        max_abs_err=block_checks["fused_ln_qkv"][0],
        ms=time_ms(torch, lambda: fb.fused_ln_qkv(*qkv_args)),
        plain_ms=time_ms(torch, lambda: fb.ln_qkv_plain(*qkv_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    mlp_bytes = 3 * T * D * 2 + (D * D + 2 * D * F) * 2 + (2 * D + F) * 4 + 2 * D * 4
    b_ms, b_by = bound_ms([(2 * T * D * (D + 2 * F), PEAK_BF16_FLOPS)], mlp_bytes)
    rows.append(dict(
        name="fused_out_mlp", route="cuda", source="prcv2025reid_tpu_torch/csrc/fused_block.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:233",
        launches=launches["fused"]["fused_out_mlp"],
        max_abs_err=block_checks["fused_out_mlp"][0],
        ms=time_ms(torch, lambda: fb.fused_out_mlp(*mlp_args)),
        plain_ms=time_ms(torch, lambda: fb.out_mlp_plain(*mlp_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    fmlp_bytes = 2 * T * D * 2 + 2 * D * F * 2 + (F + D) * 2
    b_ms, b_by = bound_ms([(4 * T * D * F, PEAK_BF16_FLOPS)], fmlp_bytes)
    rows.append(dict(
        name="fused_mlp", route="cuda", source="prcv2025reid_tpu_torch/csrc/fused_mlp.cu",
        replaces="prcv2025reid_tpu/ops/fused_mlp.py:43",
        launches=launches["fused_trunk"]["fused_mlp"],
        max_abs_err=block_checks["fused_mlp"][0],
        ms=time_ms(torch, lambda: fused_mlp(*fmlp_args)),
        plain_ms=time_ms(torch, lambda: mlp_plain(*fmlp_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    b_ms, b_by = bound_ms([(8 * T * D, PEAK_F32_FLOPS)], 4 * T * D * 2 + 2 * D * 4)
    rows.append(dict(
        name="fused_residual_ln", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_resln.cu",
        replaces="prcv2025reid_tpu/ops/fused_resln.py:33",
        launches=launches["fused_trunk"]["fused_residual_ln"],
        max_abs_err=max(block_checks["fused_residual_ln xn"][0],
                        block_checks["fused_residual_ln y"][0]),
        ms=time_ms(torch, lambda: fused_residual_ln(*resln_args)),
        plain_ms=time_ms(torch, lambda: resln_plain(*resln_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    # the int8 block kernels: int8 operations at the int8 rate, the bf16
    # out-projection of the mixed plan at the bf16 rate; each input read once
    # (int8 weights and their f32 column scales), each output written once
    i8_qkv_bytes = T * D * 2 + D * O + O * 4 * 2 + 2 * D * 4 + T * O * 2
    b_ms, b_by = bound_ms([(2 * T * D * O, PEAK_INT8_OPS)], i8_qkv_bytes)
    rows.append(dict(
        name="fused_ln_qkv_int8", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_block_int8.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:103",
        launches=launches["fused_int8"]["fused_ln_qkv_int8"],
        max_abs_err=block_checks["fused_ln_qkv_int8"][0],
        ms=time_ms(torch, lambda: fb.fused_ln_qkv_int8(*qkv8_args)),
        plain_ms=time_ms(torch, lambda: fb.ln_qkv_int8_plain(*qkv8_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    i8_mlp_bytes = 3 * T * D * 2 + (2 * D + F) * 4 * 2 + 2 * D * 4
    b_ms, b_by = bound_ms([(2 * T * D * (D + 2 * F), PEAK_INT8_OPS)],
                          i8_mlp_bytes + D * D + 2 * D * F)
    rows.append(dict(
        name="fused_out_mlp_int8", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_block_int8.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:247",
        launches=launches["fused_int8"]["fused_out_mlp_int8"],
        max_abs_err=block_checks["fused_out_mlp_int8"][0],
        ms=time_ms(torch, lambda: fb.fused_out_mlp_int8(*mlp8_args)),
        plain_ms=time_ms(torch, lambda: fb.out_mlp_int8_plain(*mlp8_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    b_ms, b_by = bound_ms([(2 * T * D * D, PEAK_BF16_FLOPS), (4 * T * D * F, PEAK_INT8_OPS)],
                          i8_mlp_bytes + D * D * 2 + 2 * D * F - D * 4)
    rows.append(dict(
        name="fused_out_mlp_int8mlp", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/fused_block_int8.cu",
        replaces="prcv2025reid_tpu/ops/fused_block.py:263",
        launches=launches["fused_int8_mlp"]["fused_out_mlp_int8mlp"],
        max_abs_err=block_checks["fused_out_mlp_int8mlp"][0],
        ms=time_ms(torch, lambda: fb.fused_out_mlp_int8mlp(*mlp8m_args)),
        plain_ms=time_ms(torch, lambda: fb.out_mlp_int8mlp_plain(*mlp8m_args), runs=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    b_ms, b_by = bound_ms([(att_flops, PEAK_BF16_FLOPS)], att_bytes)
    rows.append(dict(
        name="splash_attention_bshd", route="cuda",
        source="prcv2025reid_tpu_torch/csrc/attention.cu",
        replaces="prcv2025reid_tpu/ops/attention.py:119",
        launches=launches["splash"]["splash_attention_bshd"],
        max_abs_err=block_checks["splash_attention_bshd"][0],
        ms=time_ms(torch, lambda: att.splash_attention_bshd(*splash_args)),
        plain_ms=time_ms(torch, lambda: att.splash_plain(*splash_args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=sdpa_ms,
    ))
    # the microbenchmark's tiled matmul at M = 25,344, K = 768, N = 3072: each
    # input read once, the output written once; no model path launches it
    Mm = MATMUL_ROWS[0]
    mm_launches = sum(n["tiled_matmul"] for n in launches.values())
    for mode, peak, out_bytes, library in (
            ("bf16", PEAK_BF16_FLOPS, 2, torch.matmul), ("int8", PEAK_INT8_OPS, 4, torch._int_mm)):
        a, w = mm_args[mode]
        b_ms, b_by = bound_ms([(2 * Mm * D * F, peak)],
                              (Mm * D + D * F) * a.element_size() + Mm * F * out_bytes)
        rows.append(dict(
            name=f"tiled_matmul_{mode}", route="cuda",
            source="prcv2025reid_tpu_torch/csrc/matmul.cu",
            replaces="tools/perf_microbench.py:98",
            launches=mm_launches, max_abs_err=mm_err[mode],
            ms=time_ms(torch, lambda a=a, w=w: tiled_matmul(a, w)),
            plain_ms=time_ms(torch, lambda a=a, w=w: matmul_plain(a, w), runs=20),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda a=a, w=w, f=library: f(a, w)),
        ))
    # yardsticks outside the contract: cuBLAS on the bare products of the MLP and
    # block kernels (torch._int_mm on the int8 ones), PyTorch's add + layer_norm
    # beside the residual+LN pass
    x2d, a2d = x[0], attn[0]
    h2d = torch.empty(T, F, device=dev, dtype=torch.bfloat16).normal_(generator=gen)
    fc1_ms, fc2_ms = time_ms(torch, lambda: x2d @ w1[0]), time_ms(torch, lambda: h2d @ w2[0])
    xq, hq = fb.quant_rows(x2d.float())[0], fb.quant_rows(h2d.float())[0]
    i8 = {n: time_ms(torch, lambda w=w, a=a: torch._int_mm(a, w[0][0]))
          for n, a, w in (("qkv", xq, q_wqkv), ("out", xq, q_wo), ("fc1", xq, q_w1),
                          ("fc2", hq, q_w2))}
    out_ms = time_ms(torch, lambda: a2d @ wo[0])
    yard = {
        "cublas_qkv_gemm_ms": time_ms(torch, lambda: x2d @ wqkv[0]),
        "cublas_out_mlp_gemms_ms": out_ms + fc1_ms + fc2_ms,
        "int_mm_qkv_gemm_ms": i8["qkv"],
        "int_mm_out_mlp_gemms_ms": i8["out"] + i8["fc1"] + i8["fc2"],
        "cublas_out_plus_int_mm_mlp_gemms_ms": out_ms + i8["fc1"] + i8["fc2"],
        "cublas_mlp_gemms_ms": fc1_ms + fc2_ms,
        "torch_add_layer_norm_ms": time_ms(torch, lambda: Fn.layer_norm(
            x2d + a2d, (D,), lns.bfloat16(), lnb.bfloat16(), 1e-5)),
        "fused_mlp_g3_rel_err": block_checks["fused_mlp G=3"][1],
        "attention_causal_v2_rel_err": att_checks[(True, 2)][1],
        "attention_v1_rel_err": att_checks[(False, 1)][1],
        "attention_text_causal_rel_err": att_checks["text"][1],
        "rel_err": {"fused_mha": att_checks[(False, 2)][1],
                    **{n: v[1] for n, v in block_checks.items()}},
        "launches_by_path": launches,
    }
    print("yardsticks: " + json.dumps(yard))

    # end to end: the configurations in turns, E2E_ROUNDS rounds, median rate
    rates = {name: [] for name in steps}
    for name, step in steps.items():
        step(images, image_mask)
    for rnd in range(E2E_ROUNDS):
        for name in (list(steps) if rnd % 2 == 0 else list(steps)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(E2E_ITERS):
                steps[name](images, image_mask)
            torch.cuda.synchronize()
            rates[name].append(BATCH * E2E_ITERS / (time.perf_counter() - t0))
    e2e = {name: statistics.median(r) for name, r in rates.items()}
    print("end_to_end_rounds: " + json.dumps(rates))

    # where one embed step's device time goes, per configuration
    from torch.profiler import ProfilerActivity, profile

    device_ms = {}
    for name, step in steps.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(images, image_mask)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and device_time(e) > 0]
        total = sum(device_time(e) for e in events)
        top = sorted(events, key=device_time, reverse=True)[:TOP_KERNELS]
        wall_ms = BATCH / e2e[name] * 1e3
        device_ms[name] = total / 1e3
        print(f"profile {name}: device {total / 1e3:.3f} ms of {wall_ms:.3f} ms per step "
              f"(idle share {1 - total / 1e3 / wall_ms:.3f}) in {len(events)} kernels; top: "
              + json.dumps([[e.key[:60], e.count, round(device_time(e) / 1e3, 4)] for e in top]))

    # ---- 6. the microbenchmark's entry point: the card's own rates
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "perf_microbench", root / "tools_torch" / "perf_microbench.py")
    pmb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pmb)
    bench = pmb.Bench("cuda")
    probe_rates = {}
    t0 = time.perf_counter()
    for name in MICROBENCH:
        probe_rates.update(pmb.PROBES[name](bench))
    print(f"microbench ({time.perf_counter() - t0:.1f} s, rates / 1e12): " + json.dumps(
        {label: rate / 1e12 for label, rate in probe_rates.items()}))

    print("end_to_end: " + json.dumps({
        "card": card, "batch": BATCH, "embeds_per_sec": e2e, "device_ms_per_step": device_ms,
        "min_cosine_vs_xla": gate,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {r['library_ms']})")
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
