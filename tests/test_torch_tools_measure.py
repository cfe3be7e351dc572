"""The port's measuring tools on the CPU (``tools_torch/{trace_embed,
trace_train,train_ab,bench_host_pipeline,flagship_train_probe,
toolchain_watch}.py``): each keeps its JAX counterpart's flags, defaults
(the card's figures where JAX's are a TPU's), printed lines and keys, on a
tiny run with ``--cpu``; ``train_ab``'s rows and ``toolchain_watch``'s
parser and reproduction rule are JAX's on the port's labels and figures."""
import argparse
import importlib.util
import json
import math
import os
import re
import sys
import tempfile
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("trace_embed", "trace_train", "train_ab", "bench_host_pipeline", "flagship_train_probe",
         "toolchain_watch")
# the flags each port tool adds to JAX's: the device (JAX picks its backend
# itself), config overrides for a tiny run, flags passed through to a
# subprocess
EXTRA = {"trace_embed": {"--cpu", "--set"}, "trace_train": {"--cpu", "--set"},
         "train_ab": {"--trace-flag"}, "bench_host_pipeline": set(),
         "flagship_train_probe": set(), "toolchain_watch": {"--cpu", "--trace-flag"}}
TINY_SETS = [f"--set={k}={v}" for k, v in TINY_BASE.items()]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port():
    return {n: _load(f"port_{n}", f"tools_torch/{n}.py") for n in TOOLS}


@pytest.fixture(scope="module")
def jax_tools():
    return {n: _load(f"jax_{n}", f"tools/{n}.py") for n in TOOLS}


class _Parsed(Exception):
    pass


def _options(main, monkeypatch):
    """{option string: (dest, default, choices, nargs, action)} of the parser
    a tool's main builds (parse_args raises before the tool does anything)."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        main()
    monkeypatch.undo()
    return {opt: (a.dest, a.default, a.choices, a.nargs, type(a).__name__)
            for opt, a in e.value.args[0]._option_string_actions.items()
            if opt not in ("-h", "--help")}


@pytest.mark.parametrize("name", TOOLS)
def test_flags_are_jaxs(name, port, jax_tools, monkeypatch):
    ours = _options(port[name].main, monkeypatch)
    theirs = _options(jax_tools[name].main, monkeypatch)
    assert set(ours) - set(theirs) == EXTRA[name]
    assert set(theirs) <= set(ours)
    tmp = tempfile.gettempdir()
    for opt, (dest, default, choices, nargs, action) in theirs.items():
        got = ours[opt]
        assert got[0] == dest and got[2:] == (choices, nargs, action), opt
        if isinstance(default, str) and default.startswith("/tmp/"):
            # JAX's /tmp paths, in the temporary directory of the process
            assert got[1] == os.path.join(tmp, default[len("/tmp/"):]), opt
        elif name == "bench_host_pipeline" and opt in ("--device_rate", "--eval_rate"):
            # the card's rates (PERF.md section 5), not the TPU's 229 and 3,618
            assert got[1] == {"--device_rate": 4.522 * 32, "--eval_rate": 3632.7}[opt]
        elif name == "train_ab" and opt == "--rows":
            assert got[1] == list(port["train_ab"].ROWS) == default
        else:
            assert got[1] == default, opt


def test_train_ab_rows_are_jaxs(port, jax_tools):
    assert port["train_ab"].ROWS == jax_tools["train_ab"].ROWS


def test_trace_embed_tiny_cpu_run(port, tmp_path, capsys):
    port["trace_embed"].main(["--cpu", "--batch", "2", "--iters", "2", "--out",
                              str(tmp_path), *TINY_SETS])
    out = capsys.readouterr().out.splitlines()
    i = out.index("=== per-step op table (batch=2, block_impl=xla) ===")
    assert re.fullmatch(r"total device op time: \d+\.\d\d ms over \d+ ops", out[i + 1])
    j = out.index("=== rollup ===")
    rollup = [re.fullmatch(r" +\d+\.\d{3} ms +\d+\.\d%  (.+)", ln) for ln in out[j + 1:j + 7]]
    assert sorted(m[1] for m in rollup) == sorted(
        ["matmul", "ln/reduce", "softmax/exp", "transpose/copy", "pallas", "other"])
    assert "no device kernels found in the trace (CPU run?)" in out[j + 7]
    summary = json.loads(out[-1])["trace_embed"]
    assert summary["device"] == "cpu" and summary["device_ms"] is None
    assert set(summary["rollup"]) == {"matmul", "ln/reduce", "softmax/exp", "transpose/copy",
                                      "pallas", "other"}
    assert list(tmp_path.glob("*.pt.trace.json"))


STEADY = re.compile(r"steady state: (\d+\.\d\d) it/s \((\d+\.\d) samples/s\) at P=2 K=2 "
                    r"\(batch 4, 4 vision modalities \+ text, remat=(True|False)/(full|dots), "
                    r"donate=(True|False)\)")


def test_trace_train_tiny_cpu_run(port, tmp_path, capsys):
    port["trace_train"].main(["--cpu", "--pk", "2x2", "--steps", "2", "--trace-steps", "1",
                              "--out", str(tmp_path), "--remat", "--remat-policy", "dots",
                              "--no-donate", *TINY_SETS])
    out = capsys.readouterr().out.splitlines()
    m = next(STEADY.fullmatch(ln) for ln in out if ln.startswith("steady state:"))
    assert m and float(m[1]) > 0 and m.group(3, 4, 5) == ("True", "dots", "False")
    assert any(re.fullmatch(r"=== per-step op table \(P=2 K=2\) — \d+\.\d ms device time/step ===",
                            ln) for ln in out)
    assert "=== rollup by kernel kind ===" in out and "=== rollup ===" in out
    summary = json.loads(out[-1])["trace_train"]
    assert summary["device"] == "cpu" and math.isfinite(summary["loss"])


def test_train_ab_tiny_cpu_rows(port, tmp_path, capsys):
    out_json = tmp_path / "ab.json"
    rows = ["8x4:stored", "8x4:remat+nu_bf16"]
    results = port["train_ab"].main([
        "--steps", "1", "--out", str(out_json), "--rows", *rows,
        "--trace-flag=--cpu", "--trace-flag=--pk=2x2",
        *[f"--trace-flag={s}" for s in TINY_SETS]])
    out = capsys.readouterr().out
    with open(out_json) as f:
        saved = json.load(f)
    assert saved == results and list(saved) == rows
    assert all(v is not None and math.isfinite(v) and v > 0 for v in saved.values())
    assert "== same-day table ==" in out and f"[ab] results -> {out_json}" in out
    assert re.search(r"8x4:remat\+nu_bf16: +\d+\.\d\d it/s \([+-]\d+\.\d% vs stored\)", out)
    assert re.search(r"\[ab \+ +\d+s\] 8x4:stored: \d+\.\d+ it/s \(ok\)", out)


def test_bench_host_pipeline_lines(port, capsys):
    readings = port["bench_host_pipeline"].main(["--samples", "5", "--img_size", "64"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"host: \d+ cores; auto num_workers -> \d+", out[0])
    assert any(re.fullmatch(r"get_sample rate \(native_decode=False\): \d+\.\d samples/s/core",
                            ln) for ln in out)
    # the native leg: a rate where the decoder builds, else why not
    assert any(ln.startswith(("get_sample rate (native_decode=True): ",
                              "native=True failed: unavailable: ")) for ln in out)
    assert any(re.fullmatch(r"gallery get_query_sample\('vis'\) rate: \d+\.\d samples/s/core",
                            ln) for ln in out)
    assert any(re.fullmatch(r"budget: train 145 samples/s/chip needs ~\d+ cores/chip; gallery "
                            r"eval 3633/s needs ~\d+ cores/chip", ln) for ln in out)
    assert any(re.fullmatch(r"overlap: host-only \d+\.\d\ds \+ device 0\.40s serial; pipelined "
                            r"wall \d+\.\d\ds \(ideal max\(host, device\) = \d+\.\d\ds\)", ln)
               for ln in out)
    assert "budget rates: the card's, measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md " \
        "section 5)" in out
    assert readings["train_cores"] >= 1 and readings["eval_cores"] >= 1


def test_bench_host_pipeline_reports_a_missing_native_decoder(port, capsys, monkeypatch):
    from prcv2025reid_tpu_torch.data import native_build, native_image

    monkeypatch.setattr(native_image, "available", lambda: False)
    monkeypatch.setitem(native_build.build_errors, "libimage_decode.so",
                        "image_decode.cpp:4:10: fatal error: jpeglib.h: No such file")
    readings = port["bench_host_pipeline"].main(["--samples", "3", "--img_size", "64"])
    out = capsys.readouterr().out
    assert ("native=True failed: unavailable: image_decode.cpp:4:10: fatal error: jpeglib.h: "
            "No such file") in out
    assert "native_decode=True" not in out and "budget: train" in out
    assert readings["native_unavailable"].endswith("jpeglib.h: No such file")


SUMMARY_KEYS = ["epochs", "ce_first", "ce_last", "total_loss", "sdm_weight", "eval_mAP",
                "random_map_baseline", "steps_per_sec", "wall_s_phase1",
                "wall_s_phase2_resumed", "resume_verified"]
# a tiny run on the CPU at which the probe's own assertions pass: the whole
# trunk trains (a random trunk, as JAX's help says), one warm-up epoch
TINY_TRAIN = ["--train-flag=--num_workers=0", "--train-flag=--warmup_epochs=1",
              "--train-flag=--freeze_backbone=false",
              *[f"--train-flag=--{k}_learning_rate=3e-3"
                for k in ("base", "mer", "fusion", "tokenizer")]]


def test_flagship_probe_tiny_cpu_resume_and_assertions(port, tmp_path, capsys):
    work, art = tmp_path / "work", tmp_path / "art"
    summary = port["flagship_train_probe"].main([
        "--tiny", "--work", str(work), "--epochs1", "1", "--epochs", "2", "--steps", "20",
        "--artifacts", str(art), "--artifact-prefix", "t_", *TINY_TRAIN])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[probe] PASS "))
    assert list(json.loads(line[len("[probe] PASS "):])) == SUMMARY_KEYS
    assert summary["epochs"] == [1, 2] and summary["resume_verified"]
    assert summary["ce_last"] < summary["ce_first"]
    assert max(summary["eval_mAP"]) > summary["random_map_baseline"] + 0.08
    assert re.search(r"\[probe\] train\.py \(1 epochs\) rc=0 in \d+s", out)
    assert sorted(p.name for p in art.iterdir()) == [
        "t_eval_history.csv", "t_summary.json", "t_train_history.csv"]
    # --assert-only re-reads the CSVs; the assertions are JAX's, not loosened
    again = port["flagship_train_probe"].main(["--work", str(work), "--epochs", "2",
                                               "--assert-only"])
    assert again["eval_mAP"] == summary["eval_mAP"]
    with pytest.raises(AssertionError, match="resume broke the epoch stream"):
        port["flagship_train_probe"].main(["--work", str(work), "--epochs", "3",
                                           "--assert-only"])
    with pytest.raises(AssertionError, match="does not beat the random-ranking baseline"):
        port["flagship_train_probe"].main(["--work", str(work), "--epochs", "2", "--ids", "4",
                                           "--anchors", "40", "--assert-only"])


def test_toolchain_watch_tiny_cpu_run(port, capsys):
    """The probe leg on the CPU (perf_microbench.py --device cpu in a
    subprocess, twice: its readings are not the card's); the train leg's
    subprocess is trace_train.py, run above."""
    rc = port["toolchain_watch"].main(["--cpu", "--no-train"])
    out = capsys.readouterr().out
    assert rc == 2  # the CPU's readings are not the card's
    assert out.startswith("card: ") and "records taken on: NVIDIA H100 80GB HBM3, 700.00 W" in out
    assert "== 4 probe(s) deviated: confirming with a second run ==" in out
    for key in ("xla_bf16", "pallas_bf16", "xla_int8", "pallas_int8"):
        assert re.search(rf" +{key}: +\d+\.\dT vs recorded \d+T \([+-]\d+\.\d%\) CHANGED", out)
        assert re.search(rf"CHANGED: probe {key}: .*\(reproduced on 2 runs\)", out)
    # no --fast: the bench leg says it is not there, and nothing passes for it
    assert "not yet available" in out and "bench winner" not in out


def test_toolchain_watch_train_leg_and_exit_codes(port, capsys, monkeypatch):
    tw = port["toolchain_watch"]
    monkeypatch.setattr(tw, "run_probes", lambda cpu=False: dict(tw.RECORDED))
    readings = iter([tw.RECORDED_TRAIN_ITS * 1.1])
    monkeypatch.setattr(tw, "run_train_probe", lambda flags=(): next(readings))
    assert tw.main(["--fast"]) == 0
    out = capsys.readouterr().out
    assert "== train-step probe (8x4, default config) ==" in out
    assert "train_8x4: 4.97 vs recorded 4.52 it/s (+10.0%) PASS" in out
    assert "PASS: toolchain unchanged" in out and "not yet available" not in out
    # a deviation is re-measured; the closer reading is kept
    readings = iter([2.0 * tw.RECORDED_TRAIN_ITS, 1.05 * tw.RECORDED_TRAIN_ITS])
    assert tw.main(["--fast"]) == 0
    assert "PASS (first reading was noise)" in capsys.readouterr().out
    readings = iter([2.0 * tw.RECORDED_TRAIN_ITS, 1.9 * tw.RECORDED_TRAIN_ITS])
    assert tw.main(["--fast"]) == 2
    assert "CHANGED: probe train_8x4: 8.59 vs 4.52 it/s (reproduced on 2 runs)" in \
        capsys.readouterr().out
    monkeypatch.setattr(tw, "run_train_probe", lambda flags=(): None)
    assert tw.main(["--fast"]) == 2
    assert "CHANGED: probe train_8x4: FAILED (no reading on either run)" in capsys.readouterr().out


def test_toolchain_watch_probe_output_parsing(port):
    """JAX's parsing case on the port's labels (perf_microbench's timed()
    lines)."""
    tw = port["toolchain_watch"]
    text = (
        "some unrelated: line\n"
        "         _int_mm int8 matmul:   562.50 TOP/s  (30 iters, 119.6 GFLOP/iter)\n"
        "      port tiled bf16 matmul:   704.60 TFLOP/s  (30 iters)\n"
        "          cuBLAS bf16 matmul: not-a-number\n"
    )
    out = tw.parse_probe_stdout(text)
    assert out["xla_int8"] == pytest.approx(562.5e12)
    assert out["pallas_bf16"] == pytest.approx(704.6e12)
    assert out["xla_bf16"] is None  # malformed reading -> miss, not crash
    assert out["pallas_int8"] is None  # absent probe
    assert tw.RECORDED == {"xla_bf16": 687.2e12, "pallas_bf16": 704.6e12,
                           "xla_int8": 562.5e12, "pallas_int8": 837.3e12}
    assert tw.RECORDED_TRAIN_ITS == 4.522 and tw.TOLERANCE == tw.TRAIN_TOLERANCE == 0.15


def test_toolchain_watch_changed_probe_requires_reproduction(port, jax_tools):
    """JAX's reproduction cases, on the card's records; the port's rule
    gives JAX's answers on the same deviations (scaled to each record)."""
    tw = port["toolchain_watch"]
    good = dict(tw.RECORDED)

    # noisy excursion on one probe; second run back at the record
    noisy = dict(good, xla_int8=0.8 * good["xla_int8"])
    calls = []

    def rerun():
        calls.append(1)
        return dict(good)

    out, evidence = tw.confirm_probes(dict(noisy), rerun)
    assert calls, "deviation must trigger a confirm run"
    assert out["xla_int8"] == good["xla_int8"]  # excursion discarded

    # real move: both runs deviate -> the deviating reading survives
    moved = dict(good, pallas_bf16=1.3 * good["pallas_bf16"])
    out, evidence = tw.confirm_probes(dict(moved), lambda: dict(moved))
    assert out["pallas_bf16"] == moved["pallas_bf16"]
    assert evidence["pallas_bf16"] == "reproduced on 2 runs"

    # the rerun produced NO reading: kept, but not labeled as reproduced
    out, evidence = tw.confirm_probes(dict(moved), lambda: dict(good, pallas_bf16=None))
    assert out["pallas_bf16"] == moved["pallas_bf16"]
    assert "SINGLE" in evidence["pallas_bf16"]

    # missing on BOTH runs: stays None with honest evidence
    gone = dict(good, pallas_bf16=None)
    out, evidence = tw.confirm_probes(dict(gone), lambda: dict(gone))
    assert out["pallas_bf16"] is None
    assert "either run" in evidence["pallas_bf16"]

    # all probes at the record: no confirm run at all
    calls.clear()
    out, evidence = tw.confirm_probes(dict(good), rerun)
    assert not calls and out == good and evidence == {}

    # the same cases through JAX's rule on JAX's records give the same evidence
    jtw = jax_tools["toolchain_watch"]
    jmoved = dict(jtw.RECORDED, pallas_bf16=1.3 * jtw.RECORDED["pallas_bf16"])
    assert jtw.confirm_probes(dict(jmoved), lambda: dict(jmoved))[1] == \
        tw.confirm_probes(dict(moved), lambda: dict(moved))[1]
