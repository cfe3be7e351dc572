"""``remat_policy="dots"`` in the port (``models/vit.py::dots_policy``)
against ``full``, no remat and the JAX package's ``dots``
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``), on the CPU
in f32.

The trunk is JAX's ``tests/test_remat.py`` one (64 wide, 2 layers, 4 heads,
vis + nir), its lora_B perturbed so the LoRA side paths carry gradient, its
parameters loaded into the port through the flax names.  Bars: JAX's own
(``tests/test_remat.py``: rtol and atol 5e-4) for dots against no remat and
against JAX's dots; dots against full is the same arithmetic in the same
order, so the same bits.  What dots saves is held to what JAX saves: the
unbatched products the backward reads, nothing batched.
"""
import contextlib
import io
import re

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from prcv2025reid_tpu.models.vit import MERVisionTransformer as JaxTrunk
from prcv2025reid_tpu_torch.models import vit
from prcv2025reid_tpu_torch.ops import fused_attention

TOL = 5e-4  # JAX's tests/test_remat.py bar
WIDTHS = dict(embed_dim=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=16,
              image_size=32, fusion_dim=32, modalities=("vis", "nir"))


def jax_trunk(remat, policy="full"):
    return JaxTrunk(**WIDTHS, remat_blocks=remat, remat_policy=policy)


@pytest.fixture(scope="module")
def setup():
    imgs = jax.random.normal(jax.random.PRNGKey(0), (3, 2, 32, 32, 3))
    imgs = np.array(imgs)  # writable, for torch.from_numpy
    params = jax.jit(jax_trunk(False).init)(jax.random.PRNGKey(1), imgs)["params"]
    flat = {k: np.array(v) for k, v in tu.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(0)
    for k in flat:
        if k.endswith("lora_B") or k.endswith("bias"):
            flat[k] = rng.normal(0.0, 0.05, flat[k].shape).astype(np.float32)
    params = tu.unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return imgs, params, flat


def jax_loss(model, imgs):
    def f(params):
        y = model.apply({"params": params}, imgs, deterministic=False)
        return jnp.sum(y.astype(jnp.float32) ** 2)
    return f


def port_trunk(flat, remat, policy="full", attn_impl="xla"):
    model = vit.MERVisionTransformer(**WIDTHS, remat_blocks=remat, remat_policy=policy,
                                     attn_impl=attn_impl, device="cpu")
    model.load_state_dict({k.replace("/", "."): torch.from_numpy(v) for k, v in flat.items()})
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def port_grads(flat, imgs, remat, policy="full", attn_impl="xla"):
    model = port_trunk(flat, remat, policy, attn_impl)
    y = model.encode_stacked(torch.from_numpy(imgs), deterministic=False)
    (y.float() ** 2).sum().backward()
    return {n.replace(".", "/"): p.grad.numpy() for n, p in model.named_parameters()}


def test_dots_matches_full_and_no_remat(setup):
    imgs, _, flat = setup
    dots = port_grads(flat, imgs, True, "dots")
    full = port_grads(flat, imgs, True, "full")
    plain = port_grads(flat, imgs, False)
    assert set(dots) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(dots[k], full[k], err_msg=k)
        np.testing.assert_allclose(dots[k], plain[k], rtol=TOL, atol=TOL, err_msg=k)
    assert any(np.abs(dots[k]).max() > 0 for k in flat if k.endswith("lora_A"))


def test_dots_matches_jax_dots(setup):
    imgs, params, flat = setup
    want = {k: np.asarray(v) for k, v in tu.flatten_dict(
        jax.jit(jax.grad(jax_loss(jax_trunk(True, "dots"), imgs)))(params), sep="/").items()}
    got = port_grads(flat, imgs, True, "dots")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def _residuals(f, *args):
    """[(rows, cols)] of what ``jax.ad_checkpoint.print_saved_residuals``
    lists for ``f``, each shape [..., cols] read as rows x cols."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(f, *args)
    shapes = [[int(d) for d in m.split(",") if d] for m in
              re.findall(r"^\w+\[([\d,]*)\]", out.getvalue(), re.M)]
    return sorted((int(np.prod(s[:-1])), s[-1]) for s in shapes if s)


def test_dots_saves_what_jax_saves(setup, monkeypatch):
    """JAX's dots residuals beyond full's (the products its backward reads:
    the packed QKV, the out-projection and fc1 of each block; not fc2, whose
    output only feeds the residual add) against what the port's policy
    saves: the same (rows, cols) list, every entry an unbatched product."""
    imgs, params, flat = setup
    extra = _residuals(jax_loss(jax_trunk(True, "dots"), imgs), params)
    for r in _residuals(jax_loss(jax_trunk(True, "full"), imgs), params):
        extra.remove(r)
    saved = []
    policy = vit.dots_policy

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out.name == "MUST_SAVE" and not ctx.is_recompute:
            saved.append((op, args[0].shape[0], args[1].shape[-1]))
        return out

    monkeypatch.setattr(vit, "dots_policy", recording)
    port_grads(flat, imgs, True, "dots")
    assert {op for op, _, _ in saved} <= set(vit.DOTS_SAVED)
    assert sorted((r, c) for _, r, c in saved) == extra
    rows, L = 3 * 2 * 5, WIDTHS["num_layers"]  # B x G x S
    D, F = WIDTHS["embed_dim"], WIDTHS["mlp_dim"]
    assert extra == sorted([(rows, 3 * D), (rows, D), (rows, F)] * L)


def test_dots_recomputes_the_attention_wrapper(setup, monkeypatch):
    """Under use_pallas_attention the training core is ``fused_mha``, a
    custom Function (on the card a kernel no dispatch mode sees): dots runs
    its forward twice a block, in the forward and in the recompute, as full
    does, and the gradients match full's."""
    imgs, _, flat = setup
    calls = []
    forward = fused_attention._mha_forward

    def counted(*args):
        calls.append(1)
        return forward(*args)

    monkeypatch.setattr(fused_attention, "_mha_forward", counted)
    got = {}
    for policy in ("full", "dots"):
        calls.clear()
        got[policy] = port_grads(flat, imgs, True, policy, attn_impl="auto")
        assert len(calls) == 2 * WIDTHS["num_layers"], policy
    for k in got["full"]:
        np.testing.assert_array_equal(got["dots"][k], got["full"][k], err_msg=k)
