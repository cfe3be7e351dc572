"""Fused transformer-block kernels for the folded (eval/serving) path: the
counterparts of the JAX package's ``ops/fused_block.py::fused_ln_qkv`` and
``::fused_out_mlp`` with their ``quant`` plans.

  fused_ln_qkv:   qkv = LN1(x) @ W_qkv + b
  fused_out_mlp:  x2  = x + attn @ W_out + b_out        (f32)
                  out = x2 + GELU(LN2(x2) @ W1 + b1) @ W2 + b2

``quant="bf16"`` multiplies in bf16 (csrc/fused_block.cu).  ``"int8"``
quantizes every product's activations per row (:func:`quant_rows`, right
after the LN, the GELU or on the attention output) and takes weights
quantized per output column (:func:`quantize_weight`) as ``(wq, ws)`` pairs;
the products are int8 x int8 -> int32 (csrc/fused_block_int8.cu).
``"int8_mlp"`` (``fused_out_mlp`` only) keeps the out-projection in bf16 and
quantizes fc1 and fc2.  The int8 plans serve only: they raise under
autograd, as the JAX backward does.  The bf16 plans differentiate: each runs
inside a ``torch.autograd.Function`` whose backward is the JAX op's f32
recompute (the vjp of its f32 reference) in plain PyTorch on every device.

For CUDA tensors the wrappers launch the hand-written Hopper kernels; for
CPU tensors they run the plain versions below, which compute in f32 with the
kernels' casts (the int8 products exactly, in float64).  A CUDA tensor the
kernel does not take raises; it never falls back.  Each plan has its own
wrapper and launch count: ``fused_ln_qkv`` / ``fused_out_mlp`` (bf16),
``fused_ln_qkv_int8``, ``fused_out_mlp_int8``, ``fused_out_mlp_int8mlp``.
"""
from __future__ import annotations

import ctypes

import torch

from prcv2025reid_tpu_torch.ops import _kernels
from prcv2025reid_tpu_torch.ops.kernel_math import LN_EPS, SQRT_HALF, gelu_exact, ln_f32

# the row passes hold a row in registers: a warp's to 2,048 columns, a block's
# past that, to csrc/common.cuh ROW_MAX
MAX_LN_WIDTH = 32768


def quant_rows(y: torch.Tensor):
    """Symmetric per-row int8 quantization of f32 ``y`` [..., K] ->
    (q int8 [..., K], s f32 [..., 1]): s = max(max|y| / 127, 1e-8),
    q = round(y / s), half to even (JAX ``_quant_rows``)."""
    s = torch.clamp(y.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.round(y / s).to(torch.int8), s


def quantize_weight(w: torch.Tensor):
    """Per-output-column symmetric int8 quantization (JAX ``quantize_weight``).
    w [..., in, out] -> (wq int8 [..., in, out], ws f32 [..., 1, out]).  wq
    is stored K-major, as a transposed view of an [..., out, in] buffer: the
    int8 kernels read each output column's weights as one contiguous row."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.round(wf / s).to(torch.int8)
    return q.transpose(-1, -2).contiguous().transpose(-1, -2), s


def _int8_dot(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [G,T,K] @ int8 [G,K,N] -> the int32 accumulator as f32.  The
    product runs in float64, exact here (|acc| <= 127^2 K < 2^53) and on
    every device; the cast to f32 rounds as JAX's int32 -> f32 does."""
    return torch.matmul(q.double(), wq.double()).float()


def _no_autograd(fn: str, *tensors) -> None:
    _kernels.no_autograd(
        fn, "gradients through int8-quantized weights are unsupported: the int8 block "
        "plans serve only; use block_impl='xla' or 'fused' for any differentiated forward",
        *tensors)


def ln_rows_plain(x, ln_scale, ln_bias, dtype):
    """The LN row passes' plain version: y = LN(x) in f32, cast to ``dtype``
    (the GEMMs' operand type; the TPU kernels' ``y.astype(dt)``)."""
    return ln_f32(x, ln_scale, ln_bias).to(dtype)


def ln_qkv_plain(x, ln_scale, ln_bias, w, b):
    """x [G,T,D]; w [G,D,O]; b [G,O] -> [G,T,O] in x.dtype."""
    y = ln_rows_plain(x, ln_scale, ln_bias, x.dtype).float()
    o = torch.matmul(y, w.float()) + b.float()[:, None, :]
    return o.to(x.dtype)


def out_mlp_plain(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2):
    """attn, x [G,T,D]; wo [G,D,D]; w1 [G,D,F]; w2 [G,F,D]; biases [G,*]."""
    dt = x.dtype
    proj = torch.matmul(attn.float(), wo.float()) + bo.float()[:, None, :]
    x2 = x.float() + proj
    y = ln_rows_plain(x2, ln_scale, ln_bias, dt)
    h = torch.matmul(y.float(), w1.float()) + b1.float()[:, None, :]
    h = gelu_exact(h)
    o = torch.matmul(h.to(dt).float(), w2.float()) + b2.float()[:, None, :]
    return (x2 + o).to(dt)


def ln_qkv_int8_plain(x, ln_scale, ln_bias, wq, ws, b):
    """x [G,T,D]; wq int8 [G,D,O], ws [G,1,O]; b [G,O] -> [G,T,O] in x.dtype."""
    q, s = quant_rows(ln_f32(x, ln_scale, ln_bias))
    o = _int8_dot(q, wq) * s * ws.float() + b.float()[:, None, :]
    return o.to(x.dtype)


def _mlp_int8_tail(x2, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, dt):
    """LN2 -> quant -> fc1 -> +b1 -> GELU -> quant (from f32) -> fc2 ->
    (x2 + o) + b2, as the int8 TPU kernels compute it."""
    yq, ys = quant_rows(ln_f32(x2, ln_scale, ln_bias))
    h = _int8_dot(yq, w1q) * ys * w1s.float()
    h = gelu_exact(h + b1.float()[:, None, :])
    hq, hs = quant_rows(h)
    o = _int8_dot(hq, w2q) * hs * w2s.float()
    return (x2 + o + b2.float()[:, None, :]).to(dt)


def out_mlp_int8_plain(attn, x, woq, wos, bo, ln_scale, ln_bias, w1q, w1s, b1,
                       w2q, w2s, b2):
    """All three products int8; x2 = (x + proj) + bo."""
    aq, as_ = quant_rows(attn.float())
    proj = _int8_dot(aq, woq) * as_ * wos.float()
    x2 = x.float() + proj + bo.float()[:, None, :]
    return _mlp_int8_tail(x2, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, x.dtype)


def out_mlp_int8mlp_plain(attn, x, wo, bo, ln_scale, ln_bias, w1q, w1s, b1,
                          w2q, w2s, b2):
    """The out-projection in bf16, x2 = x + (proj + bo); fc1 and fc2 int8."""
    proj = torch.matmul(attn.float(), wo.float()) + bo.float()[:, None, :]
    x2 = x.float() + proj
    return _mlp_int8_tail(x2, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, x.dtype)


def _ln_qkv_ref_f32(x, ln_scale, ln_bias, w, b):
    """The f32 reference of the JAX backward (``fused_block.py::_ln_qkv_bwd``)."""
    return torch.matmul(ln_f32(x, ln_scale, ln_bias), w.float()) + b.float()[:, None, :]


def _out_mlp_ref_f32(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2):
    """JAX ``_out_mlp_ref_f32``: the exact erf, no bf16 rounding of y or h."""
    x2 = x + (torch.matmul(attn, wo) + bo[:, None, :])
    h = torch.matmul(ln_f32(x2, ln_scale, ln_bias), w1) + b1[:, None, :]
    h = 0.5 * h * (1.0 + torch.erf(h * SQRT_HALF))
    return x2 + torch.matmul(h, w2) + b2[:, None, :]


def _ref_vjp(ref, primals, leaves, g):
    """Gradients of ``ref(*leaves)`` against cotangent ``g`` (as f32), each
    cast to its primal's dtype: what ``jax.vjp`` of the reference returns in
    the JAX backwards.  ``leaves`` are detached copies of the primals (some
    cast to f32, as the JAX backward passes them)."""
    leaves = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        out = ref(*leaves)
    grads = torch.autograd.grad(out, leaves, g.float())
    return tuple(d.to(p.dtype) for d, p in zip(grads, primals))


def ln_qkv_backward(x, ln_scale, ln_bias, w, b, g):
    """The vjp of the f32 reference LN(x) @ w + b at (f32 x, ln_scale,
    ln_bias, w, b): (dx, d_ln_scale, d_ln_bias, dw, db)."""
    primals = (x, ln_scale, ln_bias, w, b)
    return _ref_vjp(_ln_qkv_ref_f32, primals, (x.float(), ln_scale, ln_bias, w, b), g)


def out_mlp_backward(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, g):
    """The vjp of :func:`_out_mlp_ref_f32` at the f32 operands (ln_scale and
    ln_bias as given), one gradient per operand."""
    primals = (attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)
    leaves = tuple(t if i in (4, 5) else t.float() for i, t in enumerate(primals))
    return _ref_vjp(_out_mlp_ref_f32, primals, leaves, g)


def _ln_qkv_forward(x, ln_scale, ln_bias, w, b):
    op = _kernels.export_op("fused_ln_qkv")
    if op is not None:
        return op(x, ln_scale, ln_bias, w, b)
    if not x.is_cuda:
        return ln_qkv_plain(x, ln_scale, ln_bias, w, b)
    return ln_qkv_launch(x, ln_scale, ln_bias, w, b)


def ln_qkv_launch(x, ln_scale, ln_bias, w, b):
    """#3's launches on CUDA tensors (``ops/library.py``'s op runs them)."""
    fn = "fused_ln_qkv"
    G, T, D = x.shape
    O = w.shape[-1]
    _kernels.require(D % 8 == 0 and O % 8 == 0 and D <= MAX_LN_WIDTH,
                     f"{fn}: D={D} and O={O} must be multiples of 8, D <= {MAX_LN_WIDTH}")
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    _kernels.bf16_operand(fn, "w", w, (G, D, O))
    lns = _kernels.f32_vector(fn, "ln_scale", ln_scale, (D,), x.device)
    lnb = _kernels.f32_vector(fn, "ln_bias", ln_bias, (D,), x.device)
    bf = _kernels.f32_vector(fn, "b", b, (G, O), x.device)
    y = torch.empty(G, T, D, dtype=x.dtype, device=x.device)  # bf16(LN1(x)), the GEMM's operand
    out = torch.empty(G, T, O, dtype=x.dtype, device=x.device)
    c = _kernels.lib("fused_block").ln_qkv
    c.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(), bf.data_ptr(),
           y.data_ptr(), out.data_ptr(), G, T, D, O, LN_EPS, _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_ln_qkv.launches += 1
    return out


def _out_mlp_forward(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2):
    op = _kernels.export_op("fused_out_mlp")
    if op is not None:
        return op(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)
    if not x.is_cuda:
        return out_mlp_plain(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)
    return out_mlp_launch(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)


def out_mlp_launch(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2):
    """#5's launches on CUDA tensors (``ops/library.py``'s op runs them)."""
    fn = "fused_out_mlp"
    G, T, D = x.shape
    F = w1.shape[-1]
    _kernels.require(D % 8 == 0 and F % 8 == 0 and D <= MAX_LN_WIDTH,
                     f"{fn}: D={D} and F={F} must be multiples of 8, D <= {MAX_LN_WIDTH}")
    _kernels.bf16_operand(fn, "attn", attn, (G, T, D))
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    _kernels.bf16_operand(fn, "wo", wo, (G, D, D))
    _kernels.bf16_operand(fn, "w1", w1, (G, D, F))
    _kernels.bf16_operand(fn, "w2", w2, (G, F, D))
    bof = _kernels.f32_vector(fn, "bo", bo, (G, D), x.device)
    b1f = _kernels.f32_vector(fn, "b1", b1, (G, F), x.device)
    b2f = _kernels.f32_vector(fn, "b2", b2, (G, D), x.device)
    lns = _kernels.f32_vector(fn, "ln_scale", ln_scale, (D,), x.device)
    lnb = _kernels.f32_vector(fn, "ln_bias", ln_bias, (D,), x.device)
    x2 = torch.empty(G, T, D, dtype=torch.float32, device=x.device)
    y = torch.empty(G, T, D, dtype=x.dtype, device=x.device)  # bf16(LN2(x2)), fc1's operand
    h = torch.empty(G, T, F, dtype=x.dtype, device=x.device)
    out = torch.empty(G, T, D, dtype=x.dtype, device=x.device)
    c = _kernels.lib("fused_block").out_mlp
    c.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    c.restype = ctypes.c_int
    rc = c(attn.data_ptr(), x.data_ptr(), wo.data_ptr(), bof.data_ptr(), lns.data_ptr(),
           lnb.data_ptr(), w1.data_ptr(), b1f.data_ptr(), w2.data_ptr(), b2f.data_ptr(),
           x2.data_ptr(), y.data_ptr(), h.data_ptr(), out.data_ptr(), G, T, D, F, LN_EPS,
           _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_out_mlp.launches += 1
    return out


class FusedLnQkvFn(torch.autograd.Function):
    """The bf16 kernel (CUDA) or :func:`ln_qkv_plain` (CPU) forward, the JAX
    backward (:func:`ln_qkv_backward`)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, b):
        ctx.save_for_backward(x, ln_scale, ln_bias, w, b)
        return _ln_qkv_forward(x, ln_scale, ln_bias, w, b)

    @staticmethod
    def backward(ctx, g):
        return ln_qkv_backward(*ctx.saved_tensors, g)


class FusedOutMlpFn(torch.autograd.Function):
    """The bf16 kernels (CUDA) or :func:`out_mlp_plain` (CPU) forward, the
    JAX backward (:func:`out_mlp_backward`)."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _out_mlp_forward(*args)

    @staticmethod
    def backward(ctx, g):
        return out_mlp_backward(*ctx.saved_tensors, g)


def fused_ln_qkv(x, ln_scale, ln_bias, w, b, quant: str = "bf16"):
    """LN(x) @ w + b.  x [G,T,D] bf16; ln_* [D]; w [G,D,O] bf16; b [G,O]
    -> [G,T,O] bf16.  LN statistics, the GEMM accumulation and the bias add
    are f32; the normalised rows are cast to bf16 before the GEMM.  On the
    card: the LN1 row pass (y = bf16(LN(x)) into a [G,T,D] buffer), then the
    GEMM with the bias in its epilogue; one launch of the fused kernel.
    Differentiable through :class:`FusedLnQkvFn`.  ``quant="int8"``: w is
    ``(wq, ws)`` from :func:`quantize_weight`, see :func:`fused_ln_qkv_int8`."""
    if quant == "int8":
        return fused_ln_qkv_int8(x, ln_scale, ln_bias, *w, b)
    if quant != "bf16":
        raise ValueError(f"fused_ln_qkv: quant={quant!r}; valid: ['bf16', 'int8'] "
                         "('int8_mlp' is a plan of fused_out_mlp)")
    return FusedLnQkvFn.apply(x, ln_scale, ln_bias, w, b)


def fused_out_mlp(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2,
                  quant: str = "bf16"):
    """x + attn@wo + bo, then + MLP(LN2(.)) with exact (A-S erf) GELU.
    attn, x [G,T,D] bf16; wo [G,D,D], w1 [G,D,F], w2 [G,F,D] bf16; biases
    [G,*]; ln_* [D] -> [G,T,D] bf16.  On the card this is four launches
    (out-proj GEMM with the f32 residual, the LN2 row pass, fc1+GELU GEMM,
    fc2+residual GEMM); it counts as one launch of the fused kernel.  Differentiable
    through :class:`FusedOutMlpFn`.  ``quant="int8"``: wo, w1 and w2 are
    ``(wq, ws)`` pairs (:func:`fused_out_mlp_int8`); ``"int8_mlp"``: w1 and
    w2 are (:func:`fused_out_mlp_int8mlp`)."""
    if quant == "int8":
        return fused_out_mlp_int8(attn, x, *wo, bo, ln_scale, ln_bias, *w1, b1, *w2, b2)
    if quant == "int8_mlp":
        return fused_out_mlp_int8mlp(attn, x, wo, bo, ln_scale, ln_bias, *w1, b1, *w2, b2)
    if quant != "bf16":
        raise ValueError(f"fused_out_mlp: quant={quant!r}; valid: ['bf16', 'int8', 'int8_mlp']")
    return FusedOutMlpFn.apply(attn, x, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)


def _int8_weight(fn, name, wq, ws, shape, device):
    """Check a (wq, ws) pair for the int8 kernels: wq int8 of ``shape``
    [G, K, N] stored K-major (as :func:`quantize_weight` writes it), 16-byte
    aligned; returns ws as a contiguous f32 [G, N] tensor."""
    G, K, N = shape
    _kernels.require(wq.is_cuda, f"{fn}: {name} is on {wq.device}, x is on CUDA")
    _kernels.require(wq.dtype == torch.int8, f"{fn}: {name} must be int8, got {wq.dtype}")
    _kernels.require(tuple(wq.shape) == tuple(shape),
                     f"{fn}: {name} shape {tuple(wq.shape)} != {tuple(shape)}")
    _kernels.require(wq.transpose(-1, -2).is_contiguous() and wq.data_ptr() % 16 == 0,
                     f"{fn}: {name} must be stored K-major ([G, N, K] contiguous, as "
                     "quantize_weight writes it) and 16-byte aligned")
    return _kernels.f32_vector(fn, f"{name} scales", ws, (G, 1, N), device).reshape(G, N)


def _int8_lib():
    c = _kernels.lib("fused_block_int8")
    c.ln_qkv_int8.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    c.out_mlp_int8.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    c.mlp_int8.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    for f in (c.ln_qkv_int8, c.out_mlp_int8, c.mlp_int8):
        f.restype = ctypes.c_int
    return c


def fused_ln_qkv_int8(x, ln_scale, ln_bias, wq, ws, b):
    """((acc * s_row) * ws_col) + b with acc = quant(LN(x)) @ wq in int32.
    x [G,T,D] bf16; wq int8 [G,D,O] (K-major), ws [G,1,O]; b [G,O] ->
    [G,T,O] bf16.  On the card: one row pass (LN1 in f32, per-row int8
    quantization), then the int8 GEMM; one launch of the fused kernel."""
    _no_autograd("fused_ln_qkv_int8", x, ln_scale, ln_bias, ws, b)
    op = _kernels.export_op("fused_ln_qkv_int8")
    if op is not None:
        return op(x, ln_scale, ln_bias, wq, ws, b)
    if not x.is_cuda:
        return ln_qkv_int8_plain(x, ln_scale, ln_bias, wq, ws, b)
    return ln_qkv_int8_launch(x, ln_scale, ln_bias, wq, ws, b)


def ln_qkv_int8_launch(x, ln_scale, ln_bias, wq, ws, b):
    """#4's launches on CUDA tensors (``ops/library.py``'s op runs them)."""
    fn = "fused_ln_qkv_int8"
    G, T, D = x.shape
    O = wq.shape[-1]
    _kernels.require(D % 16 == 0 and O % 8 == 0 and D <= MAX_LN_WIDTH,
                     f"{fn}: D={D} must be a multiple of 16 and <= {MAX_LN_WIDTH}, "
                     f"O={O} a multiple of 8")
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    wsf = _int8_weight(fn, "wq", wq, ws, (G, D, O), x.device)
    lns = _kernels.f32_vector(fn, "ln_scale", ln_scale, (D,), x.device)
    lnb = _kernels.f32_vector(fn, "ln_bias", ln_bias, (D,), x.device)
    bf = _kernels.f32_vector(fn, "b", b, (G, O), x.device)
    yq = torch.empty(G, T, D, dtype=torch.int8, device=x.device)
    ys = torch.empty(G, T, dtype=torch.float32, device=x.device)
    out = torch.empty(G, T, O, dtype=x.dtype, device=x.device)
    rc = _int8_lib().ln_qkv_int8(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), wq.data_ptr(), wsf.data_ptr(),
        bf.data_ptr(), yq.data_ptr(), ys.data_ptr(), out.data_ptr(), G, T, D, O, LN_EPS,
        _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_ln_qkv_int8.launches += 1
    return out


def _mlp_int8_operands(fn, x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2):
    """Checked operands and scratch of the int8 LN2 + MLP half, in the C
    entries' order (x2 first, filled by the caller's out-projection)."""
    G, T, D = x.shape
    F = w1q.shape[-1]
    _kernels.require(D % 16 == 0 and F % 16 == 0 and D <= MAX_LN_WIDTH,
                     f"{fn}: D={D} and F={F} must be multiples of 16, D <= {MAX_LN_WIDTH}")
    dev = x.device
    w1sf = _int8_weight(fn, "w1q", w1q, w1s, (G, D, F), dev)
    w2sf = _int8_weight(fn, "w2q", w2q, w2s, (G, F, D), dev)
    t = dict(
        x2=torch.empty(G, T, D, dtype=torch.float32, device=dev),
        lns=_kernels.f32_vector(fn, "ln_scale", ln_scale, (D,), dev),
        lnb=_kernels.f32_vector(fn, "ln_bias", ln_bias, (D,), dev),
        w1q=w1q, w1s=w1sf, b1=_kernels.f32_vector(fn, "b1", b1, (G, F), dev),
        w2q=w2q, w2s=w2sf, b2=_kernels.f32_vector(fn, "b2", b2, (G, D), dev),
        yq=torch.empty(G, T, D, dtype=torch.int8, device=dev),
        ys=torch.empty(G, T, dtype=torch.float32, device=dev),
        h=torch.empty(G, T, F, dtype=torch.float32, device=dev),
        hmax=torch.empty(G, T, dtype=torch.int32, device=dev),
        hq=torch.empty(G, T, F, dtype=torch.int8, device=dev),
        hs=torch.empty(G, T, dtype=torch.float32, device=dev),
        out=torch.empty(G, T, D, dtype=x.dtype, device=dev),
    )
    return t, (G, T, D, F)


def fused_out_mlp_int8(attn, x, woq, wos, bo, ln_scale, ln_bias, w1q, w1s, b1,
                       w2q, w2s, b2):
    """All three products int8.  attn, x [G,T,D] bf16; woq [G,D,D], w1q
    [G,D,F], w2q [G,F,D] int8 (K-major) with f32 column scales [G,1,*];
    biases [G,*]; ln_* [D] -> [G,T,D] bf16.  On the card: quantize attn
    rows, out-proj GEMM (x2 = (x + proj) + bo in f32), LN2 + quantize, fc1
    GEMM (f32 GELU and the row max of |h|), quantize h, fc2 GEMM
    ((x2 + o) + b2); one launch of the fused kernel."""
    args = (attn, x, woq, wos, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2)
    _no_autograd("fused_out_mlp_int8", attn, x, wos, bo, ln_scale, ln_bias, w1s, b1, w2s, b2)
    op = _kernels.export_op("fused_out_mlp_int8")
    if op is not None:
        return op(*args)
    if not x.is_cuda:
        return out_mlp_int8_plain(*args)
    return out_mlp_int8_launch(*args)


def out_mlp_int8_launch(attn, x, woq, wos, bo, ln_scale, ln_bias, w1q, w1s, b1,
                        w2q, w2s, b2):
    """#6's launches on CUDA tensors (``ops/library.py``'s op runs them)."""
    fn = "fused_out_mlp_int8"
    G, T, D = x.shape
    _kernels.bf16_operand(fn, "attn", attn, (G, T, D))
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    t, dims = _mlp_int8_operands(fn, x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2)
    wosf = _int8_weight(fn, "woq", woq, wos, (G, D, D), x.device)
    bof = _kernels.f32_vector(fn, "bo", bo, (G, D), x.device)
    aq = torch.empty(G, T, D, dtype=torch.int8, device=x.device)
    as_ = torch.empty(G, T, dtype=torch.float32, device=x.device)
    rc = _int8_lib().out_mlp_int8(
        attn.data_ptr(), x.data_ptr(), woq.data_ptr(), wosf.data_ptr(), bof.data_ptr(),
        aq.data_ptr(), as_.data_ptr(), *(v.data_ptr() for v in t.values()), *dims, LN_EPS,
        _kernels.stream_ptr(x))
    _kernels.check(rc, fn)
    fused_out_mlp_int8.launches += 1
    return t["out"]


def fused_out_mlp_int8mlp(attn, x, wo, bo, ln_scale, ln_bias, w1q, w1s, b1,
                          w2q, w2s, b2):
    """The mixed plan: the out-projection in bf16 (x2 = x + (acc + bo),
    csrc/fused_block.cu::out_proj), fc1 and fc2 int8 as in
    :func:`fused_out_mlp_int8`.  wo [G,D,D] bf16; w1q/w2q int8 pairs; one
    launch of the fused kernel."""
    args = (attn, x, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2)
    _no_autograd("fused_out_mlp_int8mlp", attn, x, wo, bo, ln_scale, ln_bias, w1s, b1, w2s, b2)
    op = _kernels.export_op("fused_out_mlp_int8mlp")
    if op is not None:
        return op(*args)
    if not x.is_cuda:
        return out_mlp_int8mlp_plain(*args)
    return out_mlp_int8mlp_launch(*args)


def out_mlp_int8mlp_launch(attn, x, wo, bo, ln_scale, ln_bias, w1q, w1s, b1,
                           w2q, w2s, b2):
    """#7's launches on CUDA tensors (``ops/library.py``'s op runs them)."""
    fn = "fused_out_mlp_int8mlp"
    G, T, D = x.shape
    _kernels.bf16_operand(fn, "attn", attn, (G, T, D))
    _kernels.bf16_operand(fn, "x", x, (G, T, D))
    _kernels.bf16_operand(fn, "wo", wo, (G, D, D))
    t, dims = _mlp_int8_operands(fn, x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2)
    bof = _kernels.f32_vector(fn, "bo", bo, (G, D), x.device)
    proj = _kernels.lib("fused_block").out_proj
    proj.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    proj.restype = ctypes.c_int
    stream = _kernels.stream_ptr(x)
    rc = proj(attn.data_ptr(), x.data_ptr(), wo.data_ptr(), bof.data_ptr(),
              t["x2"].data_ptr(), G, T, D, stream)
    _kernels.check(rc, fn)
    rc = _int8_lib().mlp_int8(*(v.data_ptr() for v in t.values()), *dims, LN_EPS, stream)
    _kernels.check(rc, fn)
    fused_out_mlp_int8mlp.launches += 1
    return t["out"]


fused_ln_qkv.launches = 0
fused_out_mlp.launches = 0
fused_ln_qkv_int8.launches = 0
fused_out_mlp_int8.launches = 0
fused_out_mlp_int8mlp.launches = 0
