"""The port's kernels as ``torch.library`` ops in the namespace ``prcv_reid``,
so that ``torch.export`` can see them (``tools_torch/export_serving.py``).

One op for every kernel wrapper that an eval path reaches:

=========================  ==========================================  =====
op                         wrapper (``ops/``)                          kernel
=========================  ==========================================  =====
``fused_mha``              ``fused_attention.fused_mha`` (and splash)  #1, #11
``fused_ln_qkv``           ``fused_block.fused_ln_qkv``                #3
``fused_out_mlp``          ``fused_block.fused_out_mlp``               #5
``fused_ln_qkv_int8``      ``fused_block.fused_ln_qkv_int8``           #4
``fused_out_mlp_int8``     ``fused_block.fused_out_mlp_int8``          #6
``fused_out_mlp_int8mlp``  ``fused_block.fused_out_mlp_int8mlp``       #7
``fused_mlp``              ``fused_mlp.fused_mlp``                     #8
``fused_residual_ln``      ``fused_resln.fused_residual_ln``           #9
=========================  ==========================================  =====

Each op's CUDA implementation is the wrapper's launch function (which counts
the launch on the wrapper, as an eager call does), its CPU implementation
the wrapper's plain version, and its fake gives the shape, dtype and strides
of the real output: ``fused_mha`` returns on the card a [B, H, S, Dh] view
of a [B, S, H, Dh] buffer, and its fake does too.

The eager paths do not call the ops: a wrapper routes through
``torch.ops.prcv_reid.*`` only while ``torch.compiler.is_exporting()`` is
true (``_kernels.export_op``), because the dispatcher adds host time to every
call on paths that are already host-bound.  ``tiled_matmul`` (#10,
``ops/matmul.py``) lies on no export path and is no op.

Importing this module registers the ops; it imports none of ``models``,
``engine`` or ``training`` (a bundle's consumer, ``tools_torch/
serve_artifact.py``, runs without the model code).
"""
from __future__ import annotations

import torch

from prcv2025reid_tpu_torch.ops import fused_attention as fa
from prcv2025reid_tpu_torch.ops import fused_block as fb
from prcv2025reid_tpu_torch.ops import fused_mlp as fm
from prcv2025reid_tpu_torch.ops import fused_resln as fr

NAMESPACE = "prcv_reid"
_LN = "Tensor ln_scale, Tensor ln_bias"


def _op(name: str, args: str, launch, plain, fake, out: str = "Tensor"):
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", launch, mutates_args=(),
                                 device_types="cuda", schema=f"({args}) -> {out}")
    op.register_kernel("cpu")(plain)
    op.register_fake(fake)
    return op


def _rows(x, width):
    """A contiguous [..., width] output in x's dtype and device."""
    return x.new_empty(*x.shape[:-1], width)


def _like(x, *_):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _mha_fake(q, k, v, causal, scale=None):
    B, H, S, Dh = q.shape
    if q.device.type == "cuda":  # the kernel writes [B, S, H, Dh rounded up to 8]
        width = -(-Dh // 8) * 8
        out = q.new_empty(B, S, H, width).permute(0, 2, 1, 3)
        return out if width == Dh else out.narrow(-1, 0, Dh)
    return q.new_empty(B, H, S, Dh)


fused_mha = _op("fused_mha", "Tensor q, Tensor k, Tensor v, bool causal, float? scale=None",
                fa.mha_launch, fa.mha_plain, _mha_fake)
fused_ln_qkv = _op("fused_ln_qkv", f"Tensor x, {_LN}, Tensor w, Tensor b",
                   fb.ln_qkv_launch, fb.ln_qkv_plain, lambda x, s, b, w, bias: _rows(x, w.shape[-1]))
fused_out_mlp = _op(
    "fused_out_mlp", f"Tensor attn, Tensor x, Tensor wo, Tensor bo, {_LN}, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor b2", fb.out_mlp_launch, fb.out_mlp_plain, lambda attn, x, *_: _like(x))
fused_ln_qkv_int8 = _op(
    "fused_ln_qkv_int8", f"Tensor x, {_LN}, Tensor wq, Tensor ws, Tensor b",
    fb.ln_qkv_int8_launch, fb.ln_qkv_int8_plain, lambda x, s, b, wq, *_: _rows(x, wq.shape[-1]))
fused_out_mlp_int8 = _op(
    "fused_out_mlp_int8", f"Tensor attn, Tensor x, Tensor woq, Tensor wos, Tensor bo, {_LN}, "
    "Tensor w1q, Tensor w1s, Tensor b1, Tensor w2q, Tensor w2s, Tensor b2",
    fb.out_mlp_int8_launch, fb.out_mlp_int8_plain, lambda attn, x, *_: _like(x))
fused_out_mlp_int8mlp = _op(
    "fused_out_mlp_int8mlp", f"Tensor attn, Tensor x, Tensor wo, Tensor bo, {_LN}, "
    "Tensor w1q, Tensor w1s, Tensor b1, Tensor w2q, Tensor w2s, Tensor b2",
    fb.out_mlp_int8mlp_launch, fb.out_mlp_int8mlp_plain, lambda attn, x, *_: _like(x))
fused_mlp = _op("fused_mlp", "Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2",
                fm.mlp_launch, fm.mlp_plain, _like)
fused_residual_ln = _op(
    "fused_residual_ln", "Tensor x, Tensor branch, Tensor scale, Tensor bias, float eps",
    fr.resln_launch, fr.resln_plain, lambda x, *_: (_like(x), _like(x)), out="(Tensor, Tensor)")
OPS = ("fused_mha", "fused_ln_qkv", "fused_out_mlp", "fused_ln_qkv_int8", "fused_out_mlp_int8",
       "fused_out_mlp_int8mlp", "fused_mlp", "fused_residual_ln")


def launch_counts():
    """{wrapper name: its launch count so far}: the op wrappers', and the
    splash core's (an eager splash call counts on both it and ``fused_mha``)."""
    from prcv2025reid_tpu_torch.ops.attention import splash_attention_bshd

    wrappers = {"fused_mha": fa.fused_mha, "fused_ln_qkv": fb.fused_ln_qkv,
                "fused_out_mlp": fb.fused_out_mlp, "fused_ln_qkv_int8": fb.fused_ln_qkv_int8,
                "fused_out_mlp_int8": fb.fused_out_mlp_int8,
                "fused_out_mlp_int8mlp": fb.fused_out_mlp_int8mlp, "fused_mlp": fm.fused_mlp,
                "fused_residual_ln": fr.fused_residual_ln,
                "splash_attention_bshd": splash_attention_bshd}
    return {name: fn.launches for name, fn in wrappers.items()}
