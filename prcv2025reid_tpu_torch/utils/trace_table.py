"""Per-kernel device time from a ``torch.profiler`` trace (the port's
counterpart of the JAX package's ``utils/xplane.py``).

JAX's module decodes the XPlane protobuf that ``jax.profiler`` writes; the
port reads the Chrome trace JSON that ``utils/profiling.trace`` writes
(``torch.profiler``'s own export), so no parser of a binary format is needed.

- ``op_time_breakdown(trace_dir)`` replaces ``xplane.op_time_breakdown``:
  ``{kernel name: total ms}`` over the device events (``"cat"`` ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset``) of the newest trace in the directory.
- ``print_top(table, n)`` replaces ``xplane.print_top``, in its format.
- ``rollup(table)`` is the category rollup of the JAX trace tools
  (``tools/trace_embed.py``) with their bucket keys; ``kernel_kind(name)``
  the key of ``tools/trace_train.py``'s "rollup by fusion kind".
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BUCKETS = ("matmul", "ln/reduce", "softmax/exp", "transpose/copy", "pallas", "other")
# the port's hand-written kernels (``prcv2025reid_tpu_torch/csrc``), the
# counterparts of the Pallas kernels JAX's "pallas" bucket holds.  They are
# matched before the matmul patterns: the GEMM core's kernel
# (hgemm::gemm_kernel) has "gemm" in its name, as cuBLAS's have.
PORT_KERNELS = ("attn_fwd_kernel", "attn_reg_kernel", "attn_long_kernel", "ln_rows_kernel",
                "row_quant_kernel", "quant_h_kernel", "resln_kernel", "hgemm::gemm_kernel")
_PATTERNS = (
    ("matmul", ("gemm", "matmul", "nvjet", "cutlass", "xmma", "conv", "dot", "splitkreduce")),
    ("ln/reduce", ("reduce", "norm")),
    ("softmax/exp", ("softmax", "exp", "div")),
    ("transpose/copy", ("transpose", "copy", "memcpy", "memset", "bitcast")),
)


def _newest_trace(trace_dir: str) -> str:
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not files:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    return max(files, key=os.path.getmtime)


def op_time_breakdown(trace_dir: str, device_only: bool = True) -> Dict[str, float]:
    """{event name: total ms} over the newest trace in ``trace_dir``: the
    device events by default; ``device_only=False`` adds every host event
    with a duration (CPU ops, runtime calls; they nest, so their sum is not
    a time)."""
    path = _newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    out: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if device_only and e.get("cat") not in DEVICE_CATS:
            continue
        out[e.get("name", "")] += float(e["dur"]) / 1e3  # us -> ms
    return dict(out)


def print_top(table: Dict[str, float], n: int = 25):
    # JAX's format; spans whose category starts with "async" overlap compute
    # and are left out of the total (a CUDA trace's device events have none)
    is_async = lambda op: op.split("::", 1)[0].lower().startswith("async")  # noqa: E731
    total = sum(ms for op, ms in table.items() if not is_async(op))
    async_total = sum(ms for op, ms in table.items() if is_async(op))
    print(f"total device op time: {total:.2f} ms over {len(table)} ops"
          + (f" (+{async_total:.2f} ms async overlap, not summed)"
             if async_total else ""))
    for op, ms in sorted(table.items(), key=lambda kv: -kv[1])[:n]:
        pct = ("async" if is_async(op)
               else f"{100 * ms / max(total, 1e-9):5.1f}%")
        print(f"  {ms:9.3f} ms  {pct:>5s}  {op[:100]}")


def bucket(name: str) -> str:
    """The rollup bucket of one device event (JAX's keys): the port's own
    kernels are "pallas"; cuBLAS / cutlass products "matmul"; reductions and
    LayerNorm "ln/reduce"; softmax, exp and division "softmax/exp"; copies,
    casts, concatenations (CatArrayBatchedCopy), memcpy and memset
    "transpose/copy"; the rest (the other elementwise kernels) "other"."""
    if any(k in name for k in PORT_KERNELS):
        return "pallas"
    low = name.lower()
    for key, patterns in _PATTERNS:
        if any(p in low for p in patterns):
            return key
    return "other"


def rollup(table: Dict[str, float]) -> Dict[str, float]:
    """{bucket: ms} over every bucket (zeros included); it sums to the
    table's total."""
    cats = {k: 0.0 for k in BUCKETS}
    for name, ms in table.items():
        cats[bucket(name)] += ms
    return cats


def kernel_kind(name: str) -> str:
    """A kernel's name without its template and call arguments, with the
    functor of PyTorch's elementwise and reduction kernels kept
    (``vectorized_elementwise_kernel[MulFunctor]``, the innermost one): the
    key of the train tool's rollup by kind."""
    base = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    qualified = re.split(r"[<(]", base, maxsplit=1)[0]
    head = qualified.split("::")[-1].strip() or base
    functors = re.findall(r"(\w*(?:Functor|_kernel_cuda|Ops))\b", base[len(qualified):])
    return f"{head}[{functors[-1]}]" if functors else head
