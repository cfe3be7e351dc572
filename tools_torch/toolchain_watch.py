#!/usr/bin/env python3
"""One-command toolchain watch (the PyTorch port's counterpart of
``tools/toolchain_watch.py``, with its tolerances, reproduction rule,
report and exit codes).

The card's recorded rates decide which of the port's kernels and paths win;
a new CUDA toolkit, GPU software stack or PyTorch can move them.  This script makes the
check trivial to re-run:

  python3 tools_torch/toolchain_watch.py          # probes + train probe, report
  python3 tools_torch/toolchain_watch.py --fast   # the same; no bench leg

It re-measures the roofline probes (``tools_torch/perf_microbench.py``:
cuBLAS bf16, ``torch._int_mm`` int8 and the port's tiled matmul, #10, in
bf16 and int8 at the model's [25344, 768] x [768, 3072]) and the default
8x4 train step (``tools_torch/trace_train.py --no-trace``), each in a
subprocess, and diffs them against the records below, taken on an NVIDIA
H100 80GB HBM3 at a 700.00 W power limit (PERF.md: the rates from
``chip_smoke.py`` phase 6; the step from phase 4b).  A reading
outside the 15% tolerance is re-measured once; CHANGED needs both runs to
deviate.

The JAX tool's third leg, the gated benchmark sweep, waits for the port's
benchmark entry point (ROADMAP.md, item 4): without ``--fast`` the tool says
that the leg is not available yet and the exit code reflects the other two
legs only; it never reports the missing leg as a pass.

Exit code: 0 = all within tolerance (PASS), 2 = something CHANGED (a probe
moved >15%): investigate + update PERF.md.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# the card's recorded rates, FLOP/s or OP/s (PERF.md, chip_smoke.py phase 6)
RECORDED = {
    "xla_bf16": 687.2e12,  # cuBLAS bf16 (torch.matmul) at the MLP's shape
    "pallas_bf16": 704.6e12,  # the port's tiled matmul (#10) in bf16
    "xla_int8": 562.5e12,  # torch._int_mm
    "pallas_int8": 837.3e12,  # #10 in int8
}
RECORDED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
TOLERANCE = 0.15

# the default-config 8x4 train step (xla path, attn_bwd / gelu_bwd stored),
# it/s from chip_smoke.py phase 4b on the card above (PERF.md); the
# same reproduce-before-report rule as the matmul probes
RECORDED_TRAIN_ITS = 4.522
TRAIN_TOLERANCE = 0.15

# probe stdout label (tools_torch/perf_microbench.py timed()) -> RECORDED key
_PROBE_LABELS = {
    "cuBLAS bf16 matmul": "xla_bf16",
    "port tiled bf16 matmul": "pallas_bf16",
    "_int_mm int8 matmul": "xla_int8",
    "port tiled int8 matmul": "pallas_int8",
}


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"


def parse_probe_stdout(text: str) -> dict:
    """perf_microbench stdout -> {probe: value or None} (values in FLOP/s;
    timed() prints best/1e12, hence the 1e12 rescale)."""
    results = {name: None for name in RECORDED}
    for line in text.splitlines():
        if ":" not in line:
            continue
        label, _, rest = line.partition(":")
        key = _PROBE_LABELS.get(label.strip())
        if key is None:
            continue
        try:
            results[key] = float(rest.split()[0]) * 1e12
        except (ValueError, IndexError):
            pass
    return results


def run_probes(cpu: bool = False):
    """Run the roofline probes in a SUBPROCESS and parse their stdout (one
    process on the card at a time: the train probe is a subprocess too)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "perf_microbench.py"), *RECORDED.keys(),
         *(["--device", "cpu"] if cpu else [])],
        capture_output=True, text=True, timeout=3600,
    )
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
    return parse_probe_stdout(proc.stdout)


def confirm_probes(probes, run_again):
    """Require a deviation to reproduce before it can be reported CHANGED.

    Any probe outside TOLERANCE (or missing) triggers ONE fresh run of all
    probes; for each deviating probe the reading closer to the record is
    kept, so CHANGED requires BOTH runs to deviate.  Returns ``(probes,
    evidence)`` where ``evidence[name]`` says how a still-deviating reading
    was obtained ("reproduced on 2 runs" vs a single measurement whose rerun
    produced no reading): the report must not claim reproduction it does not
    have."""
    deviating = [
        n for n, rec in RECORDED.items()
        if probes.get(n) is None or abs((probes[n] - rec) / rec) > TOLERANCE
    ]
    evidence = {}
    if not deviating:
        return probes, evidence
    print(f"\n== {len(deviating)} probe(s) deviated: confirming with a "
          "second run ==", flush=True)
    second = run_again()
    for n in deviating:
        a, b = probes.get(n), second.get(n)
        if a is not None and b is not None:
            # keep the reading closer to the record; a persisting deviation
            # was genuinely measured twice
            probes[n] = min(a, b, key=lambda v: abs(v - RECORDED[n]))
            evidence[n] = "reproduced on 2 runs"
        elif a is None and b is None:
            evidence[n] = "no reading on either run"
        else:
            probes[n] = a if a is not None else b
            evidence[n] = "SINGLE measurement (the other run produced no reading)"
    return probes, evidence


def run_train_probe(trace_flags=()):
    """Time the default-config full-size train step at 8x4 in a SUBPROCESS
    (tools_torch/trace_train.py --no-trace); returns it/s or None."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "trace_train.py"),
         "--pk", "8x4", "--steps", "20", "--no-trace", *trace_flags],
        capture_output=True, text=True, timeout=3600,
    )
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith("steady state:"):
            try:
                return float(line.split(":")[1].split()[0])
            except (ValueError, IndexError):
                pass
    return None


def check_train_probe(changed, trace_flags=()):
    """Train-step probe with the reproduce-before-report rule."""
    its = run_train_probe(trace_flags)
    print("\n== train-step probe (8x4, default config) ==")
    if RECORDED_TRAIN_ITS is None:
        print(f"  train_8x4: {its} it/s: NO RECORD on this toolchain; "
              "donate it to RECORDED_TRAIN_ITS")
        return
    if its is not None and abs(its - RECORDED_TRAIN_ITS) / RECORDED_TRAIN_ITS \
            <= TRAIN_TOLERANCE:
        print(f"  train_8x4: {its:.2f} vs recorded {RECORDED_TRAIN_ITS:.2f} "
              f"it/s ({(its - RECORDED_TRAIN_ITS) / RECORDED_TRAIN_ITS:+.1%}) "
              "PASS")
        return
    # deviation (or no reading): one confirming re-run, keep the closer one
    second = run_train_probe(trace_flags)
    readings = [v for v in (its, second) if v is not None]
    if not readings:
        changed.append("probe train_8x4: FAILED (no reading on either run)")
        print(f"  train_8x4: FAILED (recorded {RECORDED_TRAIN_ITS:.2f} it/s)")
        return
    best = min(readings, key=lambda v: abs(v - RECORDED_TRAIN_ITS))
    delta = (best - RECORDED_TRAIN_ITS) / RECORDED_TRAIN_ITS
    if abs(delta) <= TRAIN_TOLERANCE:
        print(f"  train_8x4: {best:.2f} vs recorded {RECORDED_TRAIN_ITS:.2f} "
              f"it/s ({delta:+.1%}) PASS (first reading was noise)")
        return
    how = ("reproduced on 2 runs" if len(readings) == 2
           else "SINGLE measurement (the other run produced no reading)")
    changed.append(
        f"probe train_8x4: {best:.2f} vs {RECORDED_TRAIN_ITS:.2f} it/s ({how})"
    )
    print(f"  train_8x4: {best:.2f} vs recorded {RECORDED_TRAIN_ITS:.2f} "
          f"it/s ({delta:+.1%}) CHANGED")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fast", action="store_true",
                    help="probes only, skip the full bench sweep")
    ap.add_argument("--no-train", action="store_true",
                    help="skip the train-step probe")
    ap.add_argument("--cpu", action="store_true",
                    help="run both legs on the CPU (the probes at small shapes): a check "
                         "that they run, never a reading of the card")
    ap.add_argument("--trace-flag", action="append", default=[],
                    help="a flag passed through to the train probe's trace_train.py "
                         "(repeatable)")
    args = ap.parse_args(argv)
    trace_flags = list(args.trace_flag) + (["--cpu"] if args.cpu else [])

    print(f"card: {card_name()}; records taken on: {RECORDED_ON}")
    changed = []
    probes, evidence = confirm_probes(run_probes(args.cpu), lambda: run_probes(args.cpu))
    if not args.no_train:
        check_train_probe(changed, trace_flags)
    print(f"\n== probe diff vs PERF.md ({RECORDED_ON}) ==")
    for name, rec in RECORDED.items():
        got = probes.get(name)
        if got is None:
            changed.append(
                f"probe {name}: FAILED ({evidence.get(name, 'no reading')})"
            )
            print(f"  {name:>12s}: FAILED (recorded {rec / 1e12:.0f}T)")
            continue
        delta = (got - rec) / rec
        flag = "PASS" if abs(delta) <= TOLERANCE else "CHANGED"
        if flag == "CHANGED":
            changed.append(
                f"probe {name}: {got / 1e12:.1f}T vs {rec / 1e12:.0f}T "
                f"({evidence.get(name, 'single run')})"
            )
        print(f"  {name:>12s}: {got / 1e12:6.1f}T vs recorded "
              f"{rec / 1e12:.0f}T ({delta:+.1%}) {flag}")

    if not args.fast:
        print("\n== gated bench across every compute path ==")
        print("  not yet available: the port has no benchmark entry point (ROADMAP.md, "
              "item 4); this leg is not run and the exit code reflects the probes only")

    print("\n== report ==")
    if changed:
        for c in changed:
            print(f"  CHANGED: {c}")
        print("toolchain moved: re-evaluate the port's kernels against cuBLAS and "
              "update PERF.md")
        return 2
    print("  PASS: toolchain unchanged; recorded recommendations stand")
    return 0


if __name__ == "__main__":
    sys.exit(main())
