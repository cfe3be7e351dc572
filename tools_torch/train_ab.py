#!/usr/bin/env python3
"""Same-day A/B matrix for train-step candidates (the PyTorch port's
counterpart of ``tools/train_ab.py``, with its rows, flags, table and JSON).

Runs ``tools_torch/trace_train.py --no-trace`` once per configuration,
SEQUENTIALLY, each in its own subprocess (one process on the card at a
time), and prints a same-day table.  Candidates are only promoted against a
baseline measured in the SAME run: a card's readings move between runs
(power limit, clocks, a shared host), so two rows compare only within one
run of this tool.

Matrix (each row one process):
  8x4:  stored baseline | remat | remat+sdm_batched | remat+nu_bf16 | remat+both
  32x4: stored baseline | stored+sdm_batched | stored+nu_bf16
("remat" is ``--attn-bwd remat``, JAX's row names.)

Usage:
    python3 tools_torch/train_ab.py [--steps 30] [--out <tmp>/train_ab.json]
    python3 tools_torch/train_ab.py --rows 8x4:stored 8x4:remat   # subset
    python3 tools_torch/train_ab.py --trace-flag=--cpu ...  # flags for every row
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

ROWS = {
    "8x4:stored": ["--pk", "8x4", "--attn-bwd", "stored"],
    "8x4:remat": ["--pk", "8x4", "--attn-bwd", "remat"],
    "8x4:remat+sdm_batched": ["--pk", "8x4", "--attn-bwd", "remat",
                              "--sdm-impl", "batched"],
    "8x4:remat+nu_bf16": ["--pk", "8x4", "--attn-bwd", "remat",
                          "--nu-dtype", "bfloat16"],
    "8x4:remat+both": ["--pk", "8x4", "--attn-bwd", "remat",
                       "--sdm-impl", "batched", "--nu-dtype", "bfloat16"],
    "32x4:stored": ["--pk", "32x4", "--attn-bwd", "stored"],
    "32x4:sdm_batched": ["--pk", "32x4", "--attn-bwd", "stored",
                         "--sdm-impl", "batched"],
    "32x4:nu_bf16": ["--pk", "32x4", "--attn-bwd", "stored",
                     "--nu-dtype", "bfloat16"],
}


def parse_its(stdout: str):
    """The it/s of trace_train.py's ``steady state:`` line, or None."""
    for line in stdout.splitlines():
        if line.startswith("steady state:"):
            try:
                return float(line.split(":")[1].split()[0])
            except (ValueError, IndexError):
                pass
    return None


def run_row(name: str, extra, steps: int, trace_flags=()):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "trace_train.py"),
         "--no-trace", "--steps", str(steps), *extra, *trace_flags],
        capture_output=True, text=True, timeout=3600,
    )
    wall = time.perf_counter() - t0
    its = parse_its(proc.stdout)
    status = "ok" if proc.returncode == 0 and its is not None else "FAIL"
    print(f"[ab +{wall:6.0f}s] {name}: {its} it/s ({status})", flush=True)
    if status == "FAIL":
        tail = "\n".join(proc.stdout.splitlines()[-5:]
                         + proc.stderr.splitlines()[-5:])
        print(tail, flush=True)
    return its


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "train_ab.json"))
    ap.add_argument("--rows", nargs="*", default=list(ROWS),
                    help=f"subset of {list(ROWS)}")
    ap.add_argument("--trace-flag", action="append", default=[],
                    help="a flag passed through to every row's trace_train.py "
                         "(repeatable), e.g. --trace-flag=--cpu")
    args = ap.parse_args(argv)

    results = {}
    for name in args.rows:
        results[name] = run_row(name, ROWS[name], args.steps, args.trace_flag)
        with open(args.out, "w") as f:  # checkpoint after every row
            json.dump(results, f, indent=1)

    print("\n== same-day table ==")
    for scale in ("8x4", "32x4"):
        base = results.get(f"{scale}:stored")
        for name, its in results.items():
            if not name.startswith(scale) or its is None:
                continue
            rel = f" ({(its - base) / base:+.1%} vs stored)" if base else ""
            print(f"  {name:>24s}: {its:6.2f} it/s{rel}")
    print(f"[ab] results -> {args.out}")
    return results


if __name__ == "__main__":
    main()
