#!/usr/bin/env python3
"""Time two versions of the port's attention and bf16 matmul kernels on one
card, in turns, on the same inputs; and diagnostic variants of the attention
kernel.

    python3 tools_torch/kernel_ab.py --other DIR [--runs 25]
    python3 tools_torch/kernel_ab.py --diagnostics [--runs 25]

DIR is another checkout of the repository, e.g. a parent commit unpacked
into the git-ignored ``_cmp/`` (``git archive REV | tar -x -C _cmp/parent``).
Its ``csrc/attention.cu`` and ``csrc/matmul.cu`` are built with this tree's
nvcc flags into ``DIR/prcv2025reid_tpu_torch/_build/`` and called through
their C entry points ``attn_fwd`` and ``matmul_bf16`` (the same signatures
in both trees) beside this tree's kernels:

  - attention (``fused_mha``) at the gallery embed's shape, B = 128 images,
    H = 12, S = 197, Dh = 64, on views of one [B, S, 3, H, Dh] projection,
    and at the text tower's causal shape, B = 128, H = 8, S = 77;
  - the microbenchmark's tiled matmul in bf16, x [25,344, 768] @ w [768,
    3072], for every block_rows.

Each kernel runs in the order other, this, this, other; each reading is the
median device time of --runs launches (CUDA events, queued behind a spin
kernel so that the host's dispatch is not timed).  SDPA and cuBLAS are timed
beside them as yardsticks.  Prints one JSON line per kernel (both versions'
two readings, the max-abs difference of their outputs) and the card's name
and power limit.  Exits 1 without a CUDA device.

--diagnostics builds variants of this tree's csrc/attention.cu, each with
one part taken out by a text substitution (edit them with the kernel; a
substitution that no longer matches raises), and times each against the
kernel at the gallery shape, in the same order: ``loads_only`` (the TMA
staging alone: no products, softmax or output), ``compute_only`` (no loads
after a block's first two pairs: it computes on stale stages), ``no_softmax``
(P = the raw scores: no max, exponential, sum or normalisation) and
``no_store`` (no output written).  Their outputs are not the kernel's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from prcv2025reid_tpu_torch.ops import _kernels  # noqa: E402
from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS  # noqa: E402

SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: the host enqueues the runs meanwhile
WARMUP_RUNS = 3


def build_other(other: Path) -> dict:
    """Build DIR's attention and matmul sources with this tree's flags."""
    csrc = other / "prcv2025reid_tpu_torch" / "csrc"
    out_dir = other / "prcv2025reid_tpu_torch" / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("attention", "matmul"):
        target = out_dir / f"ab_{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(target), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), target)
    libs = {}
    for name, (proc, target) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(str(target))
    return libs


# name -> [(text in csrc/attention.cu, replacement)]; "<cut>" removes
# everything from the first text up to (not including) the second
DIAGNOSTICS = {
    "loads_only": [("    uint32_t qf[DH / 16][4];",
                    "<cut>    fence_proxy_async();  // these reads")],
    "compute_only": [("          fill_stage<KCH>(sQ, &full[st], &map_q, &map_k, &map_v, slots, pn, H);",
                      "          mbar_arrive(&full[st]);")],
    "no_softmax": [("    float m0 = -3.0e38f, m1 = -3.0e38f;",
                    "<cut>    // PV: the normalised scores"),
                   ("    // PV: the normalised scores",
                    "    const float inv0 = 1.f, inv1 = 1.f;\n    // PV: the normalised scores")],
    "no_store": [("      if (r < S)\n        *reinterpret_cast<uint4*>",
                  "      if (r < 0)\n        *reinterpret_cast<uint4*>")],
}


def build_diagnostics() -> dict:
    """This tree's attention kernel with one part taken out per variant."""
    src = (_kernels.CSRC / "attention.cu").read_text()
    out_dir = _kernels.BUILD_DIR / "diagnostics"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in DIAGNOSTICS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"diagnostic {name}: {old!r} is not in csrc/attention.cu")
            if new.startswith("<cut>"):
                a, b = text.index(old), text.index(new[len("<cut>"):])
                text = text[:a] + text[b:]
            else:
                text = text.replace(old, new, 1)
        cu = out_dir / f"attention_{name}.cu"
        cu.write_text(text)
        target = out_dir / f"attention_{name}.so"
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-o", str(target),
               str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), target)
    libs = {}
    for name, (proc, target) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} diagnostic:\n{err}")
        libs[name] = ctypes.CDLL(str(target))
    return libs


def attn_call(lib, q, k, v, causal=False):
    """fused_mha's launch through ``lib.attn_fwd``: [B, H, S, 64] views in,
    a [B, H, S, 64] view of a [B, S, H, 64] buffer out."""
    B, H, S, Dh = q.shape
    out = torch.empty(B, S, H, Dh, dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    fn = lib.attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S, *strides,
            int(causal), _kernels.stream_ptr(q))
    _kernels.check(rc, "attn_fwd")
    return out


def matmul_call(lib, x, w, block_rows):
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    fn = lib.matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, block_rows,
            _kernels.stream_ptr(x))
    _kernels.check(rc, "matmul_bf16")
    return out


def time_ms(fn, runs):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout of the repo")
    ap.add_argument("--diagnostics", action="store_true",
                    help="time the attention kernel's diagnostic variants")
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    if args.other is None and not args.diagnostics:
        ap.error("give --other DIR, --diagnostics or both")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    this = {"attention": _kernels.lib("attention"), "matmul": _kernels.lib("matmul")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).bfloat16()

    cases = []
    for label, (B, S, H, causal) in (("fused_mha B=128 H=12 S=197", (128, 197, 12, False)),
                                      ("fused_mha causal B=128 H=8 S=77", (128, 77, 8, True))):
        qkv = randn(B, S, 3, H, 64)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        cases.append((label, lambda lib, q=q, k=k, v=v, c=causal: attn_call(
            lib["attention"], q, k, v, c),
            lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(q, k, v, is_causal=c),
            "SDPA"))
    if args.diagnostics:
        run_vision = cases[0][1]
        for name, lib in build_diagnostics().items():
            ms = {"kernel": [], name: []}
            for who in ("kernel", name, name, "kernel"):
                libs = this if who == "kernel" else {"attention": lib}
                ms[who].append(time_ms(lambda libs=libs: run_vision(libs), args.runs))
            print(json.dumps({"kernel": "fused_mha B=128 H=12 S=197", "variant": name,
                              "kernel_ms": ms["kernel"], "variant_ms": ms[name], "card": card}))
    if args.other is None:
        print(f"card: {card}")
        return 0
    other = build_other(args.other.resolve())
    x, w = randn(25344, 768), randn(768, 3072, scale=768**-0.5)
    for br in BLOCK_ROWS:
        cases.append((f"tiled_matmul bf16 M=25344 K=768 N=3072 block_rows={br}",
                      lambda lib, br=br: matmul_call(lib["matmul"], x, w, br),
                      lambda: x @ w, "cuBLAS"))
    for label, run, library, library_name in cases:
        diff = (run(other).float() - run(this).float()).abs().max().item()
        ms = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            ms[who].append(time_ms(lambda who=who: run(other if who == "other" else this),
                                   args.runs))
        print(json.dumps({"kernel": label, "other_ms": ms["other"], "this_ms": ms["this"],
                          library_name + "_ms": time_ms(library, args.runs),
                          "max_abs_diff": diff, "card": card}))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
