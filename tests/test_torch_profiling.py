"""The port's profiling utilities (``utils/profiling.py``) and its trace
table (``utils/trace_table.py``, the counterpart of JAX's
``utils/xplane.py``) on the CPU: ``StepTimer`` against JAX's on one
``perf_counter`` sequence, ``cost_summary``'s exact FLOP count, the device
table of a hand-written Chrome trace and of a real CPU trace, ``print_top``
in JAX's format, and the rollup classifier on a fixed list of kernel names."""
import json
import re
import time
from pathlib import Path

import pytest
import torch

from prcv2025reid_tpu.utils import profiling as jax_profiling
from prcv2025reid_tpu.utils import xplane as jax_xplane
from prcv2025reid_tpu_torch.utils import profiling, trace_table

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("warmup", [0, 2, 5])
def test_step_timer_matches_jax(monkeypatch, warmup):
    ticks = [0.0, 0.5, 0.75, 1.25, 1.5, 2.5, 2.625, 3.0]
    for timer_cls in (profiling.StepTimer, jax_profiling.StepTimer):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = timer_cls(warmup=warmup)
        for _ in ticks:
            timer.tick()
        if timer_cls is profiling.StepTimer:
            port = (list(timer.times), timer.mean_step_time, timer.steps_per_sec())
        else:
            jax = (list(timer.times), timer.mean_step_time, timer.steps_per_sec())
    assert port == jax
    assert len(port[0]) == max(0, len(ticks) - 1 - warmup)


def test_cost_summary_counts_the_product_exactly():
    x = torch.randn(64, 64)
    assert profiling.cost_summary(lambda a: a @ a, x) == {"flops": 2.0 * 64**3}
    # JAX's keys only where the backend gives them: no bytes_accessed here
    assert set(profiling.cost_summary(torch.matmul, x, x)) == {"flops"}


def _event(name, cat, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "dur": dur, "ts": 0, "pid": 0, "tid": 0}


def test_op_time_breakdown_sums_only_device_events(tmp_path, capsys):
    events = [
        _event("void hgemm::gemm_kernel<hgemm::Bf16Op>(CUtensorMap)", "kernel", 1500.0),
        _event("void hgemm::gemm_kernel<hgemm::Bf16Op>(CUtensorMap)", "kernel", 500.0),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 250.0),
        _event("Memset (Device)", "gpu_memset", 5.0),
        _event("aten::mm", "cpu_op", 9000.0),
        _event("cudaLaunchKernel", "cuda_runtime", 30.0),
        _event("ProfilerStep#1", "user_annotation", 20000.0),
        _event("gemm flow", "ac2g", 0.0, ph="s"),
    ]
    old = tmp_path / "old.pt.trace.json"
    old.write_text(json.dumps({"traceEvents": [_event("stale", "kernel", 1.0)]}))
    new = tmp_path / "sub" / "new.pt.trace.json"
    new.parent.mkdir()
    new.write_text(json.dumps({"traceEvents": events}))
    import os

    os.utime(old, (1, 1))  # the newest trace is read
    table = trace_table.op_time_breakdown(str(tmp_path))
    assert table == pytest.approx({
        "void hgemm::gemm_kernel<hgemm::Bf16Op>(CUtensorMap)": 2.0,
        "Memcpy HtoD (Pageable -> Device)": 0.25, "Memset (Device)": 0.005})
    every = trace_table.op_time_breakdown(str(tmp_path), device_only=False)
    assert every["aten::mm"] == pytest.approx(9.0) and "gemm flow" not in every

    # print_top prints JAX's lines for the same table
    trace_table.print_top(table, n=2)
    port = capsys.readouterr().out
    jax_xplane.print_top(table, n=2)
    assert port == capsys.readouterr().out
    assert port.startswith("total device op time: 2.25 ms over 3 ops\n")
    with pytest.raises(FileNotFoundError):
        trace_table.op_time_breakdown(str(tmp_path / "sub" / "none"))


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path)):
        (x @ x).relu().sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert trace_table.op_time_breakdown(str(tmp_path)) == {}  # no device on the CPU
    every = trace_table.op_time_breakdown(str(tmp_path), device_only=False)
    assert "aten::mm" in every and every["aten::mm"] > 0


BUCKET_CASES = [
    # the port's csrc kernels: "pallas", the GEMM core's before any matmul pattern
    ("void hgemm::gemm_kernel<hgemm::Bf16Op, hgemm::Bf16Out<2>, hgemm::Cfg<128, 256, 2, 4> >"
     "(CUtensorMap, CUtensorMap, CUtensorMap, hgemm::Params)", "pallas"),
    ("void hgemm::gemm_kernel<hgemm::S8Op, hgemm::F32Out<5>, hgemm::Cfg<128, 192, 2, 4> >"
     "(CUtensorMap, CUtensorMap, CUtensorMap, hgemm::Params)", "pallas"),
    ("(anonymous namespace)::attn_fwd_kernel(CUtensorMap, CUtensorMap, CUtensorMap, int, "
     "__nv_bfloat16*, int, int, int, long long, long long, long long, int)", "pallas"),
    ("void (anonymous namespace)::ln_rows_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float "
     "const*, float const*, __nv_bfloat16*, int, int, float)", "pallas"),
    ("void (anonymous namespace)::row_quant_kernel<float>(float const*, float const*, float "
     "const*, signed char*, float*, int, int, float)", "pallas"),
    ("void (anonymous namespace)::quant_h_kernel(float const*, unsigned int const*, signed "
     "char*, float*, long long, int)", "pallas"),
    ("void (anonymous namespace)::resln_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, float)", "pallas"),
    # cuBLAS and cutlass
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_relu_bf16_64x64_64x4_tn_align8>"
     "(cutlass_80_tensorop_s16816gemm_relu_bf16_64x64_64x4_tn_align8::Params)", "matmul"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float>()", "matmul"),
    # PyTorch's own kernels
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, "
     "false>(int, float, float const*, float const*, float const*, float*, float*, float*)",
     "ln/reduce"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<"
     "float, float, float, float>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, 4, 4>)",
     "ln/reduce"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float, "
     "at::native::(anonymous namespace)::SoftMaxForwardEpilogue>(float*, float const*, int)",
     "softmax/exp"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::exp_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda()#2}::operator()() const::{lambda(float)#1}, "
     "std::array<char*, 2ul> >(int, at::native::exp_kernel_cuda(at::TensorIteratorBase&)::"
     "{lambda()#2}::operator()() const::{lambda(float)#1}, std::array<char*, 2ul>)",
     "softmax/exp"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, "
     "float, at::native::binary_internal::DivFunctor<float> >, std::array<char*, 3ul> >(int, "
     "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::DivFunctor<"
     "float> >, std::array<char*, 3ul>)", "softmax/exp"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
     "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}, std::array<char*, 2ul>, 4>()", "transpose/copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<2u>, unsigned int, 4, 64, 64>()", "transpose/copy"),
    ("Memcpy DtoD (Device -> Device)", "transpose/copy"),
    ("Memset (Device)", "transpose/copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, "
     "float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> >(int, "
     "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor<"
     "float> >, std::array<char*, 3ul>)", "other"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluBackwardCUDAKernelImpl("
     "at::TensorIteratorBase&, at::native::GeluType)::{lambda()#2}::operator()() const::"
     "{lambda()#2}::operator()() const::{lambda(float, float)#1}, std::array<char*, 3ul> >()",
     "other"),
]


@pytest.mark.parametrize("name,want", BUCKET_CASES, ids=[f"{w}-{i}" for i, (_, w) in
                                                         enumerate(BUCKET_CASES)])
def test_rollup_bucket_of_a_kernel_name(name, want):
    assert trace_table.bucket(name) == want


def test_rollup_sums_to_the_table_with_jaxs_keys():
    table = {name: float(i + 1) for i, (name, _) in enumerate(BUCKET_CASES)}
    cats = trace_table.rollup(table)
    assert list(cats) == ["matmul", "ln/reduce", "softmax/exp", "transpose/copy", "pallas",
                          "other"]
    assert sum(cats.values()) == pytest.approx(sum(table.values()))
    assert cats["pallas"] == pytest.approx(sum(range(1, 8)))


def test_every_csrc_kernel_is_a_port_kernel():
    """Each ``__global__`` function of csrc/ is matched by PORT_KERNELS, so
    a new kernel cannot land in another bucket unnoticed."""
    names = set()
    for path in (ROOT / "prcv2025reid_tpu_torch" / "csrc").glob("*.cu*"):
        text = path.read_text()
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                text))
    assert names, "no kernels found"
    for name in names:
        full = f"hgemm::{name}" if name == "gemm_kernel" else name
        assert any(k in f"void {full}<x>(int)" for k in trace_table.PORT_KERNELS), name


@pytest.mark.parametrize("name,kind", [
    (BUCKET_CASES[0][0], "gemm_kernel"),
    (BUCKET_CASES[2][0], "attn_fwd_kernel"),
    (BUCKET_CASES[12][0], "reduce_kernel[MeanOps]"),
    (BUCKET_CASES[14][0], "vectorized_elementwise_kernel[exp_kernel_cuda]"),
    (BUCKET_CASES[-2][0], "vectorized_elementwise_kernel[MulFunctor]"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT"),
    ("Memset (Device)", "Memset"),
])
def test_kernel_kind(name, kind):
    assert trace_table.kernel_kind(name) == kind
