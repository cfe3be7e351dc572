"""Package hygiene of the PyTorch port: it imports nothing of JAX or of the
JAX package, its entry points refuse to fall back to the CPU silently, and
every compute-path value it does not implement yet raises."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from prcv2025reid_tpu_torch import TrainingConfig, build_model, make_combo_embed_step
from prcv2025reid_tpu_torch.ops.fused_attention import fused_mha

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "prcv2025reid_tpu_torch"
# the JAX package's name is a prefix of the port's: match it only as a whole name
JAX_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|flax|optax|prcv2025reid_tpu|transformers|safetensors)(?![_\w])",
    re.MULTILINE)

TINY = dict(vision_hidden_dim=64, vision_layers=2, vision_heads=4, vision_mlp_dim=128,
            image_size=32, fusion_dim=32, fusion_num_heads=4, compute_dtype="float32")


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import prcv2025reid_tpu_torch, prcv2025reid_tpu_torch.engine\n"
        "import prcv2025reid_tpu_torch.models.reid_model, prcv2025reid_tpu_torch.models.mer\n"
        "import prcv2025reid_tpu_torch.ops.fused_block, prcv2025reid_tpu_torch.ops.attention\n"
        "import prcv2025reid_tpu_torch.ops.fused_attention, prcv2025reid_tpu_torch.params\n"
        "import prcv2025reid_tpu_torch.ops.fused_mlp, prcv2025reid_tpu_torch.ops.fused_resln\n"
        "import prcv2025reid_tpu_torch.models.vit, prcv2025reid_tpu_torch.ops.matmul\n"
        "import prcv2025reid_tpu_torch.models.text, prcv2025reid_tpu_torch.models.encoder\n"
        "import prcv2025reid_tpu_torch.evaluation.protocol, prcv2025reid_tpu_torch.ops.losses\n"
        "import prcv2025reid_tpu_torch.training.train_step\n"
        "import prcv2025reid_tpu_torch.training.param_groups\n"
        "import prcv2025reid_tpu_torch.training.schedulers\n"
        "import prcv2025reid_tpu_torch.evaluation.rerank, prcv2025reid_tpu_torch.utils.timing\n"
        "import prcv2025reid_tpu_torch.training.trainer\n"
        "import importlib, importlib.util, pathlib\n"
        "for path in sorted(pathlib.Path('prcv2025reid_tpu_torch/tools').glob('*.py')):\n"
        "    importlib.import_module('prcv2025reid_tpu_torch.tools.' + path.stem)\n"
        "for path in sorted(pathlib.Path('tools_torch').glob('*.py')):\n"
        "    spec = importlib.util.spec_from_file_location('t_' + path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "    print(path.stem)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'prcv2025reid_tpu', 'transformers', 'safetensors')]\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.splitlines()
    # every tool of tools_torch/ was imported, the serving path's among them
    assert out[:-1] == sorted(p.stem for p in (ROOT / "tools_torch").glob("*.py"))
    assert {"serve_embed", "bench_query", "bench_search", "train", "kernel_ab", "step_ab",
            "perf_microbench", "eval_noise", "diagnose_alignment", "probe_sdm_breaking",
            "dryrun_real_data"} <= set(out[:-1])
    # the port's own tools package: the CLIP converter, the exporter, diagnose
    assert {p.stem for p in (PORT / "tools").glob("*.py")} >= {
        "__init__", "convert_clip", "export_params", "diagnose"}
    assert out[-1] == "[]", out


def test_no_port_source_imports_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + sorted((ROOT / "tools_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files if JAX_IMPORT.search(f.read_text())]
    assert not offenders, offenders
    # the regex itself: the port's own name must not match, the JAX package's must
    assert not JAX_IMPORT.search("from prcv2025reid_tpu_torch.ops import x")
    assert JAX_IMPORT.search("from prcv2025reid_tpu.ops import x")
    assert JAX_IMPORT.search("import prcv2025reid_tpu")
    assert JAX_IMPORT.search("import optax") and JAX_IMPORT.search("from flax import linen")
    assert JAX_IMPORT.search("from safetensors.numpy import load_file")
    assert JAX_IMPORT.search("    import transformers")
    # the training modules and the losses are among the files scanned
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"prcv2025reid_tpu_torch/tools/convert_clip.py", "tools_torch/dryrun_real_data.py",
            "prcv2025reid_tpu_torch/ops/losses.py", "prcv2025reid_tpu_torch/training/train_step.py",
            "prcv2025reid_tpu_torch/training/param_groups.py",
            "prcv2025reid_tpu_torch/training/schedulers.py"} <= names


def test_build_model_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(TrainingConfig(**TINY), num_classes=3)
    model = build_model(TrainingConfig(**TINY), num_classes=3, device="cpu")
    assert model.null_tokens.device.type == "cpu"


@pytest.mark.parametrize("override", [
    {"block_impl": "fused_interpret"},
    {"block_impl": "fused_int8_interpret"},
    # token reduction (tests/test_torch_token_reduce.py), data parallelism
    # (tests/test_torch_config.py::test_lifted_multi_process_values_reach_the_runtime)
    # and tensor parallelism (below; tests/test_torch_tp.py) are ported
])
def test_unported_values_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP.md|interpret"):
        TrainingConfig(**{**TINY, **override})


@pytest.mark.parametrize("override", [
    {"remat_blocks": True, "remat_policy": "dots"},
    {"clip_weights_path": "/weights/clip.npz"},
    {"mesh_shape": (2, 2), "mesh_axis_names": ("data", "model")},
])
def test_lifted_values_reach_the_model_and_the_trainer(override):
    """Values the port refused until it had them: remat_policy="dots" reaches
    the trunk (tests/test_torch_remat.py holds its gradients),
    clip_weights_path reaches the trainer's loader, which names the file it
    did not find (tests/test_torch_clip.py loads real ones), and a 2-D mesh
    reaches create_mesh, which wants its 4 processes (tests/test_torch_tp.py
    runs them)."""
    from prcv2025reid_tpu_torch.parallel.mesh import create_mesh
    from prcv2025reid_tpu_torch.tools import convert_clip

    cfg = TrainingConfig(**{**TINY, **override})
    if "mesh_shape" in override:
        with pytest.raises(ValueError, match="4 devices over 1 process"):
            create_mesh(cfg)
    elif "remat_policy" in override:
        vit = build_model(cfg, num_classes=3, device="cpu").encoder.vision
        assert vit.remat_blocks and vit.remat_policy == "dots"
    else:
        assert convert_clip.clip_source(cfg) == "/weights/clip.npz"
        with pytest.raises(FileNotFoundError, match="/weights/clip.npz"):
            convert_clip.load_hf_state_dict(convert_clip.clip_source(cfg))


@pytest.mark.parametrize("override", [
    {"block_impl": "fused_int8"},
    {"block_impl": "fused_int8_mlp"},
    {"block_impl": "fused_qkv"},
    {"attn_backend": "splash"},
    # valid in JAX too (tests/test_fused_block.py::test_config_rejects_typoed_paths)
    {"block_impl": "fused_int8", "attn_backend": "splash"},
    {"attn_backend": "onesaug"},
    {"gelu_impl": "tanh"},
    {"gelu_impl": "poly"},
])
def test_ported_block_plans_and_splash_build(override):
    model = build_model(TrainingConfig(**{**TINY, **override}), num_classes=3, device="cpu")
    blocks = model.encoder.vision.blocks
    assert {b.block_impl for b in blocks} == {override.get("block_impl", "xla")}
    assert {b.attn.attn_impl for b in blocks} == {override.get("attn_backend", "xla")}
    assert {b.mlp.gelu_impl for b in blocks} == {override.get("gelu_impl", "erf")}


@pytest.mark.parametrize("override", [
    {"block_impl": "fused"},
    {"block_impl": "fused_int8"},
    {"token_keep": 4, "token_reduce_layer": 1},
])
def test_fused_resln_rejects_what_the_jax_trunk_bypasses(override):
    """The JAX fused-stream trunk accepts these and silently skips the block
    kernels or the token reduction; the port refuses them."""
    with pytest.raises(ValueError, match="use_fused_resln=True conflicts"):
        TrainingConfig(**{**TINY, "use_fused_resln": True, **override})


@pytest.mark.parametrize("override", [
    {"use_fused_mlp": True},
    {"use_fused_resln": True},
    {"use_fused_resln": True, "use_fused_mlp": True, "use_pallas_attention": True},
    {"use_fused_mlp": True, "block_impl": "fused"},
])
def test_fused_stream_flags_build(override):
    model = build_model(TrainingConfig(**{**TINY, **override}), num_classes=3, device="cpu")
    vit = model.encoder.vision
    assert vit.resln_impl == ("auto" if override.get("use_fused_resln") else "xla")
    assert {b.mlp.impl for b in vit.blocks} == {
        "auto" if override.get("use_fused_mlp") else "xla"}


@pytest.mark.parametrize("override", [
    {"block_impl": "fusd"},
    {"attn_backend": "flash"},
    {"gelu_impl": "relu"},
    {"modalities": ("nir", "vis")},
    {"modalities": ("vis", "text", "nir")},
    {"token_keep": -1},
    {"use_pallas_attention": True, "attn_backend": "splash"},
    {"gelu_bwd": "stash"},
    {"attn_bwd": "flash"},
    {"remat_policy": "some"},
    {"opt_nu_dtype": "float16"},
    {"sdm_impl": "vmap"},
    {"token_reduce_train": True},  # needs token_keep > 0
])
def test_invalid_values_raise_like_jax(override):
    with pytest.raises(ValueError):
        TrainingConfig(**{**TINY, **override})


def test_text_in_active_set_raises():
    """A combo with text needs the token rows and their mask."""
    model = build_model(TrainingConfig(**TINY), num_classes=3, device="cpu")
    images = torch.zeros(1, 4, 32, 32, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="text_tokens and text_mask"):
        make_combo_embed_step(model, ("vis", "text"))(images, torch.ones(1, 4))
    with pytest.raises(ValueError, match="text_tokens and text_mask"):
        model.encode_subset(images, torch.ones(1, 4), None, None, ("text",))
    with pytest.raises(ValueError, match="not in"):
        model.encode_subset(images, torch.ones(1, 4), None, None, ("txt",))


def test_params_not_yet_ported_is_empty():
    from prcv2025reid_tpu_torch.params import NOT_YET_PORTED

    assert NOT_YET_PORTED == ()


def test_defaults_are_vit_b16():
    cfg = TrainingConfig()
    assert (cfg.vision_hidden_dim, cfg.vision_layers, cfg.vision_heads,
            cfg.vision_mlp_dim, cfg.patch_size, cfg.image_size, cfg.fusion_dim) == (
        768, 12, 12, 3072, 16, 224, 512)
    assert cfg.compute_dtype == "bfloat16" and cfg.block_impl == "xla"


def test_fused_mha_rejects_unknown_kernel_version():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="kernel_version"):
        fused_mha(q, q, q, kernel_version=3)


def test_kernel_vectors_are_16_byte_aligned():
    """The kernels read f32 vectors (LN parameters, biases, scales) 8 or 16
    bytes at a time: a view at an offset that is not a multiple of 16 bytes
    is copied, an aligned contiguous f32 tensor is passed as it is, and a
    wrong shape or device raises."""
    from prcv2025reid_tpu_torch.ops import _kernels

    base = torch.arange(40, dtype=torch.float32)
    for off in (1, 2, 3):
        view = base[off:off + 32]
        got = _kernels.f32_vector("f", "b", view, (32,), base.device)
        assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    assert _kernels.f32_vector("f", "b", base, (40,), base.device).data_ptr() == base.data_ptr()
    halves = _kernels.f32_vector("f", "b", base.bfloat16()[1:33], (32,), base.device)
    assert halves.dtype == torch.float32 and halves.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="shape"):
        _kernels.f32_vector("f", "b", base, (32,), base.device)
    with pytest.raises(ValueError, match="is on"):
        _kernels.f32_vector("f", "b", base, (40,), torch.device("meta"))
