#!/usr/bin/env python3
"""Submission CSV of a saved checkpoint (the PyTorch port's counterpart of
``tools/generate_submission.py``): ``eval_mm_protocol.py`` with the
submission forced on, ``--out`` standing for its ``--submission``.

    python3 tools_torch/generate_submission.py --dataset_root /data/orbench \\
        --model_path ./checkpoints/best --out submission.csv

Every other flag goes to ``eval_mm_protocol.py``; ``main(argv,
device="cpu")`` runs on the CPU.
"""
import argparse
import importlib.util
import os
import sys


def _eval_cli():
    # by path, under a name of its own: the JAX package's tools/ holds a
    # module of the same name
    spec = importlib.util.spec_from_file_location(
        "tools_torch_eval_mm_protocol",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "eval_mm_protocol.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else list(argv)
    # --out becomes --submission (argparse handles --out=..., repeats and a
    # missing value)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    ap.add_argument("--submission", default=None)
    ns, rest = ap.parse_known_args(argv)
    out = ns.submission or ns.out or "submission.csv"
    return _eval_cli().main(rest + ["--submission", out], device=device)


if __name__ == "__main__":
    main()
