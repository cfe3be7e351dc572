#!/usr/bin/env python3
"""Time variants of the fused MLP kernel (prcv2025reid_tpu_torch/csrc/fused_mlp.cu)
on one NVIDIA GPU, to find where its time goes.

    python3 tools_torch/fused_mlp_probe.py [--source NAME=PATH ...] [--rounds N]

The variants are the committed source, each --source file (an older version
of the kernel: ``git show REV:prcv2025reid_tpu_torch/csrc/fused_mlp.cu`` into a
directory that also holds that revision's ``common.cuh``, which it includes),
and diagnostics: the committed source with one part of the work removed by a
text substitution.  A diagnostic's output is wrong; only its time is read:

  no_weights   the W1 and W2 copies are zero-filled: no weight traffic from L2
  no_gelu      the GELU of the hidden activation is the identity
  no_fc1_mma   fc1's mma.sync replaced by a cheap use of the same fragments
  no_fc2_mma   fc2's mma.sync likewise

Every variant is compiled with the port's nvcc flags (one nvcc each, in
parallel) and run at the ViT-B/16 gallery shape (G=1, N=128*197, D=768,
F=3072).  The variants that are not diagnostics are held against
``mlp_plain`` (relative Frobenius error).  Times are medians of CUDA-event
timings over 20 launches; the variants run in turns, round after round.
The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "prcv2025reid_tpu_torch" / "csrc" / "fused_mlp.cu"
BUILD = ROOT / "prcv2025reid_tpu_torch" / "_build" / "probe"
DIAGNOSTICS = {
    "no_weights": [
        ("const bool in = f0 + col + 8 <= F;", "const bool in = false;"),
        ("const bool in = f0 + r < F && c0 + col + 8 <= D;", "const bool in = false;"),
    ],
    "no_gelu": [
        ("in ? pack_bf16(gelu_as(v0 + other.x + bias1[n].x),\n"
         "                           gelu_as(v1 + other.y + bias1[n].y))",
         "in ? pack_bf16(v0 + other.x + bias1[n].x,\n"
         "                           v1 + other.y + bias1[n].y)"),
    ],
    "no_fc1_mma": [
        ("            mma_bf16(hacc[i][n], af[s % 2][i], bfr[s % 2][n / 2][(n % 2) * 2],\n"
         "                     bfr[s % 2][n / 2][(n % 2) * 2 + 1]);",
         "            hacc[i][n][0] += __uint_as_float(af[s % 2][i][n] ^ "
         "bfr[s % 2][n / 2][(n % 2) * 2]);"),
    ],
    "no_fc2_mma": [
        ("          mma_bf16(acc[i][2 * jp], af[i], bfr[0], bfr[1]);\n"
         "          mma_bf16(acc[i][2 * jp + 1], af[i], bfr[2], bfr[3]);",
         "          acc[i][2 * jp][0] += __uint_as_float(bfr[0] ^ af[i][0]);\n"
         "          acc[i][2 * jp + 1][0] += __uint_as_float(bfr[2]);"),
    ],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fused_mlp_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from prcv2025reid_tpu_torch.ops import _kernels
    from prcv2025reid_tpu_torch.ops.fused_mlp import mlp_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")

    # name -> (source text, directory of its common.cuh, is a diagnostic)
    committed = SOURCE.read_text()
    sources = {"committed": (committed, SOURCE.parent, False)}
    for spec in args.source:
        name, path = spec.split("=", 1)
        sources[name] = (Path(path).read_text(), Path(path).resolve().parent, False)
    for name, subs in DIAGNOSTICS.items():
        text = committed
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"diagnostic {name}: the committed source no longer has {old!r}")
            text = text.replace(old, new)
        sources[name] = (text, SOURCE.parent, True)

    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include, _) in sources.items():
        cu, so = BUILD / f"{name}.cu", BUILD / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(include), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        regs = [ln.split("info    : ")[-1] for ln in (out + err).splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"build {name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        lib.mlp.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.mlp.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G, N, D, F = 1, 128 * 197, 768, 3072
    x = torch.randn(G, N, D, generator=gen, device=dev).bfloat16()
    w1 = (torch.randn(G, D, F, generator=gen, device=dev) * D**-0.5).bfloat16()
    w2 = (torch.randn(G, F, D, generator=gen, device=dev) * F**-0.5).bfloat16()
    b1 = (0.1 * torch.randn(G, F, generator=gen, device=dev)).bfloat16().float()
    b2 = (0.1 * torch.randn(G, D, generator=gen, device=dev)).bfloat16().float()
    want = mlp_plain(x, w1, b1, w2, b2).float()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        rc = lib.mlp(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                     out.data_ptr(), G, N, D, F, stream)
        if rc != 0:
            raise SystemExit(f"launch failed: CUDA error {rc}")

    def time_ms(lib, runs=20):
        for _ in range(3):
            launch(lib)
        pairs = []
        for _ in range(runs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            launch(lib)
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    for rnd in range(args.rounds):
        names = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for name in names:
            launch(libs[name])
            torch.cuda.synchronize()
            diag = sources[name][2]
            rel = ((out.float() - want).norm() / want.norm()).item()
            note = "diagnostic" if diag else f"rel {rel:.3e}"
            print(f"round {rnd} {name}: {time_ms(libs[name]):.4f} ms ({note})")
            if not diag and not rel <= 2e-3:
                raise SystemExit(f"{name} disagrees with mlp_plain: rel {rel}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
