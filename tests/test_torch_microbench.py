"""The port's microbenchmark matmul and tool against the JAX tool.

``tiled_matmul`` (a CPU tensor runs its plain version) is held against the
JAX tool's Pallas kernel, ``tools/perf_microbench.py::_pallas_matmul``, run
under ``force_tpu_interpret_mode`` on the CPU (the only way it runs there),
on the same numpy inputs.  M is a multiple of ``block_rows`` in those cases:
the JAX kernel's grid has ``M // block_rows`` steps and leaves a ragged tail
unwritten, which the port does not copy (a port-only case shows it computes
every row).  The tool itself runs under ``--device cpu`` and its lines are
read with the JAX tool's format and ``tools/toolchain_watch.py``'s parser.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from prcv2025reid_tpu_torch.ops.matmul import BLOCK_ROWS, matmul_plain, tiled_matmul

ROOT = Path(__file__).resolve().parents[1]
M, K, N = 512, 768, 256


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return _load("jax_perf_microbench", "tools/perf_microbench.py")


@pytest.fixture(scope="module")
def port_tool():
    return _load("port_perf_microbench", "tools_torch/perf_microbench.py")


def _operands(mode, rows=M, seed=0):
    rng = np.random.default_rng(seed)
    if mode == "bf16":
        x = rng.normal(size=(rows, K)).astype(np.float32)
        w = rng.normal(size=(K, N)).astype(np.float32)
        # round to bf16 once; both sides take the same values
        x, w = (torch.from_numpy(a).bfloat16() for a in (x, w))
        return x, w, jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(
            w.float().numpy(), jnp.bfloat16)
    x = rng.integers(-127, 127, (rows, K), dtype=np.int8)
    w = rng.integers(-127, 127, (K, N), dtype=np.int8)
    return torch.from_numpy(x), torch.from_numpy(w), jnp.asarray(x), jnp.asarray(w)


def _jax_matmul(jax_tool, mode, jx, jw, block_rows):
    acc, out = (jnp.float32, jnp.bfloat16) if mode == "bf16" else (jnp.int32, jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        y = jax_tool._pallas_matmul(jx, jw, acc, out, block_rows=block_rows)
    return np.asarray(y.astype(jnp.float32)) if mode == "bf16" else np.asarray(y)


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits), floored at the ulp of 2^-10:
    below that the f32 sums of the two sides, taken in other orders, differ by
    more than a bf16 ulp of the value."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0**-10)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("block_rows", BLOCK_ROWS)
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_tiled_matmul_matches_pallas(jax_tool, mode, block_rows):
    """bf16 within one bf16 ulp of the output (both accumulate in f32 and
    round once; only the summation order differs); int8 bit-exact."""
    x, w, jx, jw = _operands(mode)
    want = _jax_matmul(jax_tool, mode, jx, jw, block_rows)
    got = tiled_matmul(x, w, block_rows)
    if mode == "bf16":
        assert got.dtype == torch.bfloat16 and got.shape == (M, N)
        d = np.abs(got.float().numpy() - want)
        assert (d <= _bf16_ulp(want)).all(), d.max()
    else:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_ragged_rows_are_computed_and_block_rows_does_not_change_the_result(jax_tool, mode):
    """M = 300 is a multiple of no row tile: the port computes all 300 rows,
    each equal to the JAX kernel's row on the same inputs padded to 512 rows,
    and every block_rows gives the same result."""
    x, w, jx, jw = _operands(mode, rows=300)
    pad = jnp.zeros((M - 300, K), jx.dtype)
    want = _jax_matmul(jax_tool, mode, jnp.concatenate([jx, pad]), jw, 256)[:300]
    outs = [tiled_matmul(x, w, r) for r in BLOCK_ROWS]
    assert all(o.shape == (300, N) for o in outs)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    got = outs[0].float().numpy() if mode == "bf16" else outs[0].numpy()
    if mode == "bf16":
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    else:
        np.testing.assert_array_equal(got, want)


def test_matmul_plain_is_exact_for_int8():
    """The float64 product of the plain version is the exact int32 sum, at
    the largest |acc| the probe's shape allows (127^2 * 768)."""
    x = torch.full((4, K), -127, dtype=torch.int8)
    w = torch.full((K, 128), -127, dtype=torch.int8)
    out = matmul_plain(x, w)
    assert out.dtype == torch.int32 and (out == 127 * 127 * K).all()


@pytest.mark.parametrize("x_dt,w_dt", [
    (torch.bfloat16, torch.int8), (torch.float32, torch.float32), (torch.int8, torch.bfloat16),
    (torch.float16, torch.float16)])
def test_tiled_matmul_rejects_other_dtype_pairs(x_dt, w_dt):
    x, w = torch.zeros(4, 64, dtype=x_dt), torch.zeros(64, 128, dtype=w_dt)
    with pytest.raises(ValueError, match="bfloat16 x bfloat16 or int8 x int8"):
        tiled_matmul(x, w)
    with pytest.raises(ValueError, match="bfloat16 x bfloat16 or int8 x int8"):
        matmul_plain(x, w)


@pytest.mark.parametrize("block_rows", [0, 32, 100, 512])
def test_tiled_matmul_rejects_unknown_block_rows(block_rows):
    x, w = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_rows"):
        tiled_matmul(x, w, block_rows)


LINE = re.compile(r"^ *(?P<label>.+): +(?P<rate>\d+\.\d\d) (?P<unit>\S+)  "
                  r"\((?P<iters>\d+) iters, (?P<gflop>\d+\.\d) GFLOP/iter\)$")


def test_tool_on_cpu_prints_the_jax_line_format(port_tool, capsys):
    """``--device cpu`` for xla_bf16 pallas_bf16 pallas_int8: one line each in
    the JAX ``timed()`` format (M = 512 rows, 2 iterations: 2.4 GFLOP), which
    toolchain_watch's parser reads once the port's labels are mapped to the
    JAX tool's."""
    rc = port_tool.main(["--device", "cpu", "xla_bf16", "pallas_bf16", "pallas_int8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = [ln for ln in out.splitlines() if LINE.match(ln)]
    labels = [LINE.match(ln)["label"].strip() for ln in lines]
    assert labels == ["cuBLAS bf16 matmul", "port tiled bf16 matmul", "port tiled int8 matmul"]
    for ln in lines:
        m = LINE.match(ln)
        assert (m["iters"], m["gflop"]) == ("2", f"{2 * M * K * 3072 / 1e9:.1f}")
        assert float(m["rate"]) > 0 and m["unit"] in ("TFLOP/s", "TOP/s")
        assert ln.index(":") >= 28  # right-aligned to 28 characters, as timed()
    watch = _load("toolchain_watch", "tools/toolchain_watch.py")
    as_jax = {"cuBLAS bf16 matmul": "XLA bf16 matmul", "port tiled bf16 matmul":
              "Pallas bf16 matmul", "port tiled int8 matmul": "Pallas int8 matmul"}
    text = "\n".join(ln.replace(label, as_jax[label]) for ln, label in zip(lines, labels))
    parsed = watch.parse_probe_stdout(text)
    for key, ln in zip(("xla_bf16", "pallas_bf16", "pallas_int8"), lines):
        assert parsed[key] == pytest.approx(float(LINE.match(ln)["rate"]) * 1e12)


def test_tool_rejects_unknown_probes_and_a_missing_card(port_tool, monkeypatch):
    with pytest.raises(SystemExit):
        port_tool.main(["--device", "cpu", "no_such_probe"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tool.Bench("cuda")
