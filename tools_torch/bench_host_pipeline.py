#!/usr/bin/env python3
"""Host-pipeline capacity benchmark: per-core sample rate + overlap check
(the PyTorch port's counterpart of ``tools/bench_host_pipeline.py``, with
its flags and lines).

Measures, on THIS host, the decode+augment rate of the training sample path
(``MultiModalDataset.get_sample``: up to 4 JPEG decodes + crop/flip/jitter/
erase per sample) with the PIL and the native (C++ libjpeg) decoder, then
prints the cores-needed-per-card budget against the card's measured rates:
by default the 8x4 train step at 4.522 it/s = 144.7 samples/s and the
fused-stream gallery embed at 3,632.7 embeds/s (an H100 80GB HBM3 at
700 W, ``chip_smoke.py``; PERF.md section 5).  Where the native decoder
cannot be built (no ``jpeglib.h``), its leg prints that it is unavailable,
with the compiler's error, and the tool goes on with PIL.

Also demonstrates pipeline OVERLAP: with worker processes, the wall time of
(decode while the main process sleeps a simulated device step) approaches
max(host, device) rather than their sum: the property that decides whether
the card starves.  No device work runs: the tool needs no card.

Usage: python3 tools_torch/bench_host_pipeline.py [--samples 200] [--img_size 256]
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TRAIN_SAMPLES_PER_S = 4.522 * 32  # the 8x4 step, PERF.md section 5
GALLERY_EMBEDS_PER_S = 3632.7  # fused_trunk at batch 128, PERF.md section 5
RATES_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"  # where those two were measured


def measure_get_sample(ds, n: int) -> float:
    """In-process samples/s of the full per-sample load+augment path."""
    import numpy as np

    rng = np.random.default_rng(0)
    # warm the page cache so we measure decode, not first-touch disk I/O
    for i in range(min(8, len(ds))):
        ds.get_sample(i % len(ds), rng)
    t0 = time.perf_counter()
    for i in range(n):
        ds.get_sample(i % len(ds), rng)
    return n / (time.perf_counter() - t0)


def measure_overlap(ds, tokenizer, n_batches: int, batch_size: int,
                    device_s: float, num_workers: int):
    """(pipeline wall s, serial-host-only s) consuming n_batches with a
    simulated device step of device_s each."""
    from prcv2025reid_tpu_torch.data.pipeline import HostPipeline
    from prcv2025reid_tpu_torch.data.sampler import PKBatchSampler

    sampler = PKBatchSampler(
        ds, batch_size // 2, 2, allow_id_reuse=True,
        steps_per_epoch=n_batches, seed=0,
    )
    # serial reference: host work alone, in-process
    serial = HostPipeline(ds, sampler, tokenizer, num_workers=0, seed=0)
    t0 = time.perf_counter()
    for _ in serial:
        pass
    host_s = time.perf_counter() - t0

    piped = HostPipeline(ds, sampler, tokenizer, num_workers=num_workers, seed=0)
    for _ in piped:  # warm pass: spawn + import cost of the worker pool
        pass
    t0 = time.perf_counter()
    for _ in piped:
        time.sleep(device_s)  # the simulated device step
    wall_s = time.perf_counter() - t0
    piped.close()
    return wall_s, host_s


def native_unavailable():
    """None where the native decoder builds and loads, else why not (the
    first line of g++'s error)."""
    from prcv2025reid_tpu_torch.data import native_build, native_image

    if native_image.available():
        return None
    err = native_build.build_errors.get("libimage_decode.so", "").strip()
    line = next((ln for ln in err.splitlines() if "error" in ln), err.splitlines()[0]
                if err else "the library did not load")
    return line.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--img_size", type=int, default=256,
                    help="synthetic source image side (person crops are ~256x128)")
    ap.add_argument("--device_rate", type=float, default=TRAIN_SAMPLES_PER_S,
                    help="device train samples/s to budget against")
    ap.add_argument("--eval_rate", type=float, default=GALLERY_EMBEDS_PER_S,
                    help="device gallery embeds/s to budget against")
    args = ap.parse_args(argv)

    import numpy as np

    from prcv2025reid_tpu_torch.configs import TrainingConfig
    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.pipeline import resolve_num_workers
    from prcv2025reid_tpu_torch.data.tokenizer import HashTokenizer
    from prcv2025reid_tpu_torch.utils.synthetic import make_synthetic_orbench

    cores = os.cpu_count() or 1
    print(f"host: {cores} cores; auto num_workers -> {resolve_num_workers(-1)}")
    readings = {}
    with tempfile.TemporaryDirectory() as td:
        root = make_synthetic_orbench(
            os.path.join(td, "orbench"), num_ids=8, anchors_per_id=3,
            img_size=args.img_size,
        )
        rates = {}
        for native in (False, True):
            if native:
                why = native_unavailable()
                if why is not None:
                    print(f"native={native} failed: unavailable: {why}")
                    readings["native_unavailable"] = why
                    continue
            cfg = TrainingConfig(
                data_root=root,
                json_file=os.path.join(root, "text_annos.json"),
                use_native_decode=native,
                num_workers=0,
            )
            ds = MultiModalDataset(cfg, "train")
            try:
                rates[native] = measure_get_sample(ds, args.samples)
            except Exception as e:  # report, keep going
                print(f"native={native} failed: {type(e).__name__}: {e}")
                continue
            print(f"get_sample rate (native_decode={native}): "
                  f"{rates[native]:.1f} samples/s/core")

        # gallery eval decodes ONE image/sample (vis only, resize-only
        # transform): measure it directly through get_query_sample
        best_native = max(rates, key=rates.get)
        vcfg = TrainingConfig(
            data_root=root, json_file=os.path.join(root, "text_annos.json"),
            use_native_decode=best_native, num_workers=0,
        )
        vds = MultiModalDataset(vcfg, "val")
        vrng = np.random.default_rng(0)
        for i in range(min(8, len(vds))):
            vds.get_query_sample(i % len(vds), ("vis",), vrng)
        t0 = time.perf_counter()
        for i in range(args.samples):
            vds.get_query_sample(i % len(vds), ("vis",), vrng)
        gallery_rate = args.samples / (time.perf_counter() - t0)
        print(f"gallery get_query_sample('vis') rate: "
              f"{gallery_rate:.1f} samples/s/core")

        best = max(rates.values())
        train_cores = math.ceil(args.device_rate / best)
        eval_cores = math.ceil(args.eval_rate / gallery_rate)
        print(
            f"budget: train {args.device_rate:.0f} samples/s/chip needs "
            f"~{train_cores} cores/chip; gallery eval {args.eval_rate:.0f}/s "
            f"needs ~{eval_cores} cores/chip"
        )
        if (args.device_rate, args.eval_rate) == (TRAIN_SAMPLES_PER_S, GALLERY_EMBEDS_PER_S):
            print(f"budget rates: the card's, measured on {RATES_CARD} (PERF.md section 5)")

        cfg = TrainingConfig(
            data_root=root, json_file=os.path.join(root, "text_annos.json"),
            use_native_decode=best_native, num_workers=0,
        )
        ds = MultiModalDataset(cfg, "train")
        tok = HashTokenizer(49408, 77)
        wall, host = measure_overlap(
            ds, tok, n_batches=8, batch_size=8, device_s=0.05,
            num_workers=resolve_num_workers(-1),
        )
        dev = 8 * 0.05
        print(
            f"overlap: host-only {host:.2f}s + device {dev:.2f}s serial; "
            f"pipelined wall {wall:.2f}s "
            f"(ideal max(host, device) = {max(host, dev):.2f}s)"
        )
    readings.update(cores=cores, rates={str(k): v for k, v in rates.items()},
                    gallery_rate=gallery_rate, train_cores=train_cores, eval_cores=eval_cores,
                    overlap_wall_s=wall, overlap_host_s=host, overlap_device_s=dev)
    return readings


if __name__ == "__main__":
    main()
