#!/usr/bin/env python3
"""Time two versions of the port's attention, tiled matmul (bf16 and int8),
fused MLP, LN1 + QKV and out-projection + MLP block kernels on one card, in
turns, on the same inputs; and diagnostic variants of the attention kernel.

    python3 tools_torch/kernel_ab.py --other DIR [--runs 25] [--only TEXT ...]
    python3 tools_torch/kernel_ab.py --diagnostics [--runs 25]

DIR is another checkout of the repository, e.g. a parent commit unpacked
into the git-ignored ``_cmp/`` (``git archive REV | tar -x -C _cmp/parent``).
Its ``csrc/{attention,matmul,fused_mlp,fused_block,fused_block_int8}.cu``
are built with this tree's nvcc flags into
``DIR/prcv2025reid_tpu_torch/_build/`` and called through their C entry
points beside this tree's kernels (``mlp`` takes the hidden buffer h where
the source's entry names it, as this tree's does; ``ln_qkv`` takes the
normalised rows y [G, T, D] bf16 where its entry names y, else the row
statistics [G * T] float2 of the older kernel; ``out_mlp``'s LN scratch,
row statistics or the normalised rows, gets a buffer large enough for
either):

  - attention (``fused_mha``) at the gallery embed's shape, B = 128 images,
    H = 12, S = 197, Dh = 64, on views of one [B, S, 3, H, Dh] projection,
    and at the text tower's causal shape, B = 128, H = 8, S = 77;
  - the microbenchmark's tiled matmul, x [25,344, 768] @ w [768, 3072], in
    bf16 and in int8 (w stored K-major), for every block_rows;
  - the fused MLP (``fused_mlp``) at the gallery embed's G = 1, N = 25,216
    and the MM-3 query's G = 3, N = 6,304 (D = 768, F = 3072);
  - at the same two shapes, the LN1 + QKV block kernels (O = 2304): #3
    ``ln_qkv`` (bf16) and #4 ``ln_qkv_int8`` (weights quantized as the model
    does), with cuBLAS on the bare QKV product and ``torch._int_mm`` on the
    bare int8 one beside them;
  - at the same two shapes, the out-projection + MLP block kernels: #5
    ``out_mlp`` (bf16), #7 ``out_proj`` + ``mlp_int8`` (bf16 out-projection,
    int8 MLP) and #6 ``out_mlp_int8`` (all int8, weights quantized as the
    model does), and ``mlp_int8`` alone on one x2 computed by this tree (its
    max-abs difference says whether the int8 tail gives the other tree's
    bits on the same x2).

Each kernel runs in the order other, this, this, other; each reading is the
median device time of --runs launches (CUDA events, queued behind a spin
kernel so that the host's dispatch is not timed).  SDPA, cuBLAS (for the
MLP: its two bare products; for the block kernels their three) and
``torch._int_mm`` are timed beside them as yardsticks.  Prints one JSON line
per kernel (both versions' two readings, the max-abs difference of their
outputs), then for each block kernel both trees' launches from
torch.profiler (device time per launch, by kernel name), and the card's name
and power limit.  ``--only`` keeps the kernels whose label contains one of
the given texts (e.g. ``--only '#6'``).  Exits 1 without a CUDA device.

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
from prcv2025reid_tpu_torch.ops import fused_block as fb  # noqa: E402
from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS  # noqa: E402

SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: the host enqueues the runs meanwhile
WARMUP_RUNS = 3


AB_SOURCES = ("attention", "matmul", "fused_mlp", "fused_block", "fused_block_int8")


def takes_h(csrc: Path) -> bool:
    """Whether the tree's ``mlp`` C entry takes the hidden buffer h."""
    src = (csrc / "fused_mlp.cu").read_text()
    return "void* h" in src[src.index('extern "C" int mlp('):]


def ln_qkv_takes_y(csrc: Path) -> bool:
    """Whether the tree's ``ln_qkv`` C entry takes the normalised rows y
    (the row pass + GEMM-core kernel) or the row statistics (the LN-prologue
    ``mma.sync`` kernel)."""
    src = (csrc / "fused_block.cu").read_text()
    return "void* y" in src[src.index('extern "C" int ln_qkv('):].split(")", 1)[0]


def build_other(other: Path) -> dict:
    """Build DIR's sources in AB_SOURCES with this tree's flags."""
    csrc = other / "prcv2025reid_tpu_torch" / "csrc"
    out_dir = other / "prcv2025reid_tpu_torch" / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in AB_SOURCES:
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
    libs["mlp_takes_h"] = takes_h(csrc)
    libs["ln_qkv_takes_y"] = ln_qkv_takes_y(csrc)
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
    int8 = x.dtype == torch.int8
    out = torch.empty(M, N, dtype=torch.int32 if int8 else torch.bfloat16, device=x.device)
    fn = lib.matmul_int8 if int8 else lib.matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, block_rows,
            _kernels.stream_ptr(x))
    _kernels.check(rc, "matmul_int8" if int8 else "matmul_bf16")
    return out


def mlp_call(libs, x, w1, b1, w2, b2):
    """fused_mlp's launch through ``libs["fused_mlp"].mlp``: b1, b2 f32."""
    G, N, D = x.shape
    F = w1.shape[-1]
    out = torch.empty_like(x)
    bufs = [torch.empty(G, N, F, dtype=x.dtype, device=x.device)] if libs["mlp_takes_h"] else []
    fn = libs["fused_mlp"].mlp
    fn.argtypes = [ctypes.c_void_p] * (6 + len(bufs)) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            *(t.data_ptr() for t in bufs), out.data_ptr(), G, N, D, F, _kernels.stream_ptr(x))
    _kernels.check(rc, "mlp")
    return out


def _c(fn, n_ptr, n_int):
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float,
                                                                         ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


class Qkv:
    """Operands of the LN1 + QKV block kernels at G groups of T rows (D =
    768, O = 2304), with each C entry's call."""

    D, O = 768, 2304

    def __init__(self, G, T, randn):
        D, O, dev = self.D, self.O, torch.device("cuda")
        self.dims = (G, T, D, O)
        self.x = randn(G, T, D)
        self.w, self.b = randn(G, D, O, scale=D**-0.5), randn(G, O, scale=0.1).float()
        self.lns, self.lnb = 1 + randn(D, scale=0.1).float(), randn(D, scale=0.1).float()
        self.wq, self.ws = fb.quantize_weight(self.w)
        self.y = torch.empty(G, T, D, dtype=torch.bfloat16, device=dev)
        self.stats = torch.empty(G * T, 2, dtype=torch.float32, device=dev)
        self.yq = torch.empty(G, T, D, dtype=torch.int8, device=dev)
        self.ys = torch.empty(G, T, dtype=torch.float32, device=dev)

    def ln_qkv(self, libs):
        """#3: bf16 through ``ln_qkv``, with the scratch its entry takes."""
        out = torch.empty(*self.dims[:2], self.O, dtype=torch.bfloat16, device=self.x.device)
        scratch = self.y if libs["ln_qkv_takes_y"] else self.stats
        rc = _c(libs["fused_block"].ln_qkv, 7, 4)(
            *_ptrs(self.x, self.lns, self.lnb, self.w, self.b, scratch, out), *self.dims,
            fb.LN_EPS, _kernels.stream_ptr(self.x))
        _kernels.check(rc, "ln_qkv")
        return out

    def ln_qkv_int8(self, libs):
        """#4: int8 through ``ln_qkv_int8``."""
        out = torch.empty(*self.dims[:2], self.O, dtype=torch.bfloat16, device=self.x.device)
        rc = _c(libs["fused_block_int8"].ln_qkv_int8, 9, 4)(
            *_ptrs(self.x, self.lns, self.lnb, self.wq, self.ws, self.b, self.yq, self.ys, out),
            *self.dims, fb.LN_EPS, _kernels.stream_ptr(self.x))
        _kernels.check(rc, "ln_qkv_int8")
        return out

    def cublas(self):
        """The bare bf16 QKV product."""
        return torch.bmm(self.x, self.w)

    def int_mm(self):
        """The bare int8 QKV product, per group."""
        for g in range(self.dims[0]):
            torch._int_mm(self.yq[g], self.wq[g])


class Block:
    """Operands and scratch of the out-projection + MLP block kernels at
    G groups of T rows (D = 768, F = 3072), with each C entry's call."""

    D, F = 768, 3072

    def __init__(self, G, T, randn):
        D, F, dev = self.D, self.F, torch.device("cuda")
        self.dims = (G, T, D, F)
        self.attn, self.x = randn(G, T, D), randn(G, T, D)
        self.wo, self.w1 = randn(G, D, D, scale=D**-0.5), randn(G, D, F, scale=D**-0.5)
        self.w2 = randn(G, F, D, scale=F**-0.5)
        self.bo, self.b1, self.b2 = (randn(G, n, scale=0.1).float() for n in (D, F, D))
        self.lns, self.lnb = 1 + randn(D, scale=0.1).float(), randn(D, scale=0.1).float()
        self.woq, self.w1q, self.w2q = (fb.quantize_weight(w) for w in (self.wo, self.w1, self.w2))

        def empty(*shape, dt=torch.float32):
            return torch.empty(*shape, dtype=dt, device=dev)

        self.x2, self.ln_scratch, self.h16 = empty(G, T, D), empty(G, T, D, dt=torch.bfloat16), \
            empty(G, T, F, dt=torch.bfloat16)
        self.aq, self.as_ = empty(G, T, D, dt=torch.int8), empty(G, T)
        self.tail = [empty(G, T, D, dt=torch.int8), empty(G, T), empty(G, T, F),
                     empty(G, T, dt=torch.int32), empty(G, T, F, dt=torch.int8), empty(G, T)]

    def stream(self):
        return _kernels.stream_ptr(self.x)

    def out_mlp(self, libs):
        """#5: attn, x -> bf16 out through ``out_mlp``."""
        out = torch.empty_like(self.x)
        rc = _c(libs["fused_block"].out_mlp, 14, 4)(
            *_ptrs(self.attn, self.x, self.wo, self.bo, self.lns, self.lnb, self.w1, self.b1,
                   self.w2, self.b2, self.x2, self.ln_scratch, self.h16, out), *self.dims,
            fb.LN_EPS, self.stream())
        _kernels.check(rc, "out_mlp")
        return out

    def out_proj(self, libs, x2):
        G, T, D, _ = self.dims
        fn = libs["fused_block"].out_proj
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernels.check(fn(*_ptrs(self.attn, self.x, self.wo, self.bo, x2), G, T, D,
                          self.stream()), "out_proj")

    def mlp_int8(self, libs, x2):
        """The int8 tail on a given x2."""
        out = torch.empty_like(self.x)
        rc = _c(libs["fused_block_int8"].mlp_int8, 16, 4)(
            *_ptrs(x2, self.lns, self.lnb, *self.w1q, self.b1, *self.w2q, self.b2, *self.tail,
                   out), *self.dims, fb.LN_EPS, self.stream())
        _kernels.check(rc, "mlp_int8")
        return out

    def out_mlp_int8mlp(self, libs):
        """#7: the bf16 out-projection, then the int8 tail."""
        self.out_proj(libs, self.x2)
        return self.mlp_int8(libs, self.x2)

    def out_mlp_int8(self, libs):
        """#6: all three products int8 through ``out_mlp_int8``."""
        out = torch.empty_like(self.x)
        rc = _c(libs["fused_block_int8"].out_mlp_int8, 23, 4)(
            *_ptrs(self.attn, self.x, *self.woq, self.bo, self.aq, self.as_, self.x2, self.lns,
                   self.lnb, *self.w1q, self.b1, *self.w2q, self.b2, *self.tail, out),
            *self.dims, fb.LN_EPS, self.stream())
        _kernels.check(rc, "out_mlp_int8")
        return out

    def cublas(self):
        """The three bare bf16 products."""
        torch.bmm(self.attn, self.wo, out=self.ln_scratch)
        torch.bmm(self.ln_scratch, self.w1, out=self.h16)
        return torch.bmm(self.h16, self.w2)

    def int_mm(self, bf16_out_proj):
        """The bare int8 products (per group), after cuBLAS's bf16
        out-projection where ``bf16_out_proj``."""
        if bf16_out_proj:
            torch.bmm(self.attn, self.wo, out=self.ln_scratch)
        yq, hq = self.aq, self.tail[4]
        for g in range(self.dims[0]):
            if not bf16_out_proj:
                torch._int_mm(yq[g], self.woq[0][g])
            torch._int_mm(yq[g], self.w1q[0][g])
            torch._int_mm(hq[g], self.w2q[0][g])


def profile_launches(fn, calls=5):
    """The kernel launches of ``fn`` by name: [name, launches per call,
    device microseconds per launch]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            rows.append([e.key[:120], e.count / calls, round(t / e.count, 2)])
    return rows


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
    ap.add_argument("--only", nargs="+", metavar="TEXT",
                    help="time only the kernels whose label contains one of these")
    args = ap.parse_args()
    if args.other is None and not args.diagnostics:
        ap.error("give --other DIR, --diagnostics or both")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    this = {name: _kernels.lib(name) for name in AB_SOURCES}
    this["mlp_takes_h"] = takes_h(_kernels.CSRC)
    this["ln_qkv_takes_y"] = ln_qkv_takes_y(_kernels.CSRC)
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
    xq = torch.randint(-128, 128, (25344, 768), generator=gen, device=dev, dtype=torch.int8)
    wq = torch.randint(-128, 128, (3072, 768), generator=gen, device=dev, dtype=torch.int8).t()
    for br in BLOCK_ROWS:
        cases.append((f"tiled_matmul bf16 M=25344 K=768 N=3072 block_rows={br}",
                      lambda lib, br=br: matmul_call(lib["matmul"], x, w, br),
                      lambda: x @ w, "cuBLAS"))
    for br in BLOCK_ROWS:
        cases.append((f"tiled_matmul int8 M=25344 K=768 N=3072 block_rows={br}",
                      lambda lib, br=br: matmul_call(lib["matmul"], xq, wq, br),
                      lambda: torch._int_mm(xq, wq), "int_mm"))
    for G, N in ((1, 128 * 197), (3, 32 * 197)):
        mx = randn(G, N, 768)
        w1, w2 = randn(G, 768, 3072, scale=768**-0.5), randn(G, 3072, 768, scale=3072**-0.5)
        b1, b2 = randn(G, 3072, scale=0.1).float(), randn(G, 768, scale=0.1).float()
        h = torch.empty(G, N, 3072, dtype=torch.bfloat16, device=dev)

        def cublas(mx=mx, w1=w1, w2=w2, h=h):
            torch.bmm(mx, w1, out=h)
            return torch.bmm(h, w2)

        cases.append((f"fused_mlp G={G} N={N} D=768 F=3072",
                      lambda lib, a=(mx, w1, b1, w2, b2): mlp_call(lib, *a), cublas,
                      "cuBLAS_fc1_fc2"))
    profiled = []
    for G, N in ((1, 128 * 197), (3, 32 * 197)):
        qkv = Qkv(G, N, randn)
        for label, run, library, library_name in (
                (f"#3 ln_qkv G={G} T={N} D=768 O=2304", qkv.ln_qkv, qkv.cublas, "cuBLAS_qkv"),
                (f"#4 ln_qkv_int8 G={G} T={N} D=768 O=2304", qkv.ln_qkv_int8, qkv.int_mm,
                 "int_mm_qkv")):
            cases.append((label, run, library, library_name))
            profiled.append((label, run))
    for G, N in ((1, 128 * 197), (3, 32 * 197)):
        blk = Block(G, N, randn)
        blk.out_proj(this, blk.x2)
        x2 = blk.x2.clone()  # one x2 for both trees' int8 tail
        shape = f"G={G} T={N} D=768 F=3072"
        for label, run, library, library_name in (
                (f"#5 out_mlp {shape}", blk.out_mlp, blk.cublas, "cuBLAS_3_products"),
                (f"#7 out_proj+mlp_int8 {shape}", blk.out_mlp_int8mlp,
                 lambda b=blk: b.int_mm(True), "cuBLAS_out_int_mm_fc1_fc2"),
                (f"#6 out_mlp_int8 {shape}", blk.out_mlp_int8, lambda b=blk: b.int_mm(False),
                 "int_mm_3_products"),
                (f"mlp_int8 (#7's tail, one x2) {shape}",
                 lambda lib, b=blk, x2=x2: b.mlp_int8(lib, x2), None, None)):
            cases.append((label, run, library, library_name))
            profiled.append((label, run))
    if args.only:
        cases = [c for c in cases if any(t in c[0] for t in args.only)]
        profiled = [c for c in profiled if any(t in c[0] for t in args.only)]
    for label, run, library, library_name in cases:
        diff = (run(other).float() - run(this).float()).abs().max().item()
        ms = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            ms[who].append(time_ms(lambda who=who: run(other if who == "other" else this),
                                   args.runs))
        line = {"kernel": label, "other_ms": ms["other"], "this_ms": ms["this"],
                "max_abs_diff": diff, "card": card}
        if library is not None:
            line[library_name + "_ms"] = time_ms(library, args.runs)
        print(json.dumps(line))
    for label, run in profiled:
        print(json.dumps({"kernel": label,
                          "this_launches": profile_launches(lambda run=run: run(this)),
                          "other_launches": profile_launches(lambda run=run: run(other)),
                          "card": card}))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
