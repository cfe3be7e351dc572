"""CLIP weights into the port (``tools/convert_clip.py``) against the JAX
package's converter, HF's own text tower and the reference's vision
composition, on the CPU in f32.

The checkpoint is the tiny random HF ``CLIPModel`` of JAX's
``tests/test_encoder.py`` (vision 64 x 2 layers, text 32 x 2, image 32,
patch 16, projection 32, vocab 100, context 16), built here the same way.
Bars: the converted leaves equal JAX's bit for bit (the noise drawn in
float64 from the same generator, cast at the end); the port's text feature
against HF's ``pooler_output`` -> ``text_projection`` at rtol 1e-4 / atol
1e-5 and its vis feature against the erf vision oracle at 1e-4 / 1e-4, as
JAX's own test holds JAX's encoder.
"""
import os
import sys
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402
from test_encoder import CTX, D_T, D_V, H_T, H_V, IMG, L_T, L_V, MLP_T, MLP_V, PATCH, PROJ  # noqa: E402
from test_encoder import VOCAB, _torch_vision_oracle  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.models.encoder import UnifiedEncoder as JaxEncoder  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu.tools import convert_clip as jax_convert  # noqa: E402
from prcv2025reid_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from prcv2025reid_tpu_torch import Trainer, TrainingConfig, build_model  # noqa: E402
from prcv2025reid_tpu_torch.params import init_params  # noqa: E402
from prcv2025reid_tpu_torch.tools import convert_clip  # noqa: E402

TEXT_RTOL, TEXT_ATOL = 1e-4, 1e-5
VIS_TOL = 1e-4
REPO_ID = "openai/clip-vit-base-patch16"
PORT_WIDTHS = dict(
    vision_hidden_dim=D_V, vision_layers=L_V, vision_heads=H_V, vision_mlp_dim=MLP_V,
    patch_size=PATCH, image_size=IMG, fusion_dim=PROJ, text_hidden_dim=D_T,
    text_layers=L_T, text_heads=H_T, text_mlp_dim=MLP_T, text_vocab_size=VOCAB,
    text_context_length=CTX, sdm_semantic_dim=PROJ, sdm_num_heads=4, fusion_num_heads=4,
    compute_dtype="float32", drop_path=0.0)


@pytest.fixture(scope="module")
def hf_model():
    # transformers' TensorFlow and flax back ends are not needed here and
    # take seconds to import
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    torch.manual_seed(0)
    vision_cfg = CLIPVisionConfig(hidden_size=D_V, intermediate_size=MLP_V,
                                  num_hidden_layers=L_V, num_attention_heads=H_V,
                                  image_size=IMG, patch_size=PATCH, projection_dim=PROJ)
    text_cfg = CLIPTextConfig(hidden_size=D_T, intermediate_size=MLP_T, num_hidden_layers=L_T,
                              num_attention_heads=H_T, vocab_size=VOCAB,
                              max_position_embeddings=CTX, projection_dim=PROJ,
                              eos_token_id=VOCAB - 1, bos_token_id=VOCAB - 2)
    cfg = CLIPConfig(text_config=text_cfg.to_dict(), vision_config=vision_cfg.to_dict(),
                     projection_dim=PROJ)
    return CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_sd(hf_model):
    return jax_convert.state_dict_from_torch_model(hf_model)


@pytest.fixture(scope="module")
def jax_encoder_params():
    enc = JaxEncoder(embed_dim=D_V, num_layers=L_V, num_heads=H_V, mlp_dim=MLP_V,
                     patch_size=PATCH, image_size=IMG, fusion_dim=PROJ, text_width=D_T,
                     text_layers=L_T, text_heads=H_T, text_mlp_dim=MLP_T, text_vocab=VOCAB,
                     context_length=CTX, dtype=jnp.float32, attn_impl="xla")
    return jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, IMG, IMG, 3)),
                             jnp.zeros((1, CTX), jnp.int32))


@pytest.fixture(scope="module")
def port_model(hf_sd):
    cfg = TrainingConfig(**PORT_WIDTHS)
    flat = convert_clip.convert_clip_params(hf_sd, init_params(cfg, 7, perturb=False), seed=0)
    return build_model(cfg, flat, device="cpu")


def flat_np(tree):
    return {k: np.asarray(v) for k, v in tu.flatten_dict(tree, sep="/").items()}


@pytest.mark.parametrize("seed", [0, 5])
def test_convert_equals_jax_bit_for_bit(hf_sd, jax_encoder_params, seed):
    """JAX's own flattened encoder tree through both converters: every leaf
    the same bits and dtype, every key present."""
    template = flat_np(jax_encoder_params)
    want = flat_np(jax_convert.convert_clip_params(hf_sd, jax_encoder_params, seed=seed))
    got = convert_clip.convert_clip_params(hf_sd, template, seed=seed, prefix="params/")
    assert set(got) == set(want)
    diff = [k for k in want if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])]
    assert not diff, diff[:5]
    # the template is not written to, and the conversion wrote the CLIP leaves
    assert not np.array_equal(template["params/vision/pos_embed"], got["params/vision/pos_embed"])
    np.testing.assert_array_equal(
        got["params/vision/block_1/mlp/fc2/shared/kernel"],
        hf_sd["vision_model.encoder.layers.1.mlp.fc2.weight"].T)


def test_hf_clip_shapes_are_hf_layout(hf_sd):
    """The layout ``chip_smoke.py`` writes its synthetic checkpoint in: HF's
    keys and shapes (the published files also hold the position_ids)."""
    shapes = convert_clip.hf_clip_shapes(TrainingConfig(**PORT_WIDTHS))
    assert set(hf_sd) <= set(shapes)
    assert {k.rsplit(".", 1)[1] for k in set(shapes) - set(hf_sd)} <= {"position_ids"}
    for k, v in hf_sd.items():
        assert (v.shape, v.dtype) == shapes[k], k


def test_text_matches_hf(hf_model, port_model):
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, VOCAB - 2, (3, CTX))
    tokens[:, 0] = VOCAB - 2  # BOS
    tokens[:, 10] = VOCAB - 1  # EOT (max id -> argmax pooling)
    with torch.no_grad():
        pooled = hf_model.text_model(input_ids=torch.tensor(tokens)).pooler_output
        want = hf_model.text_projection(pooled).numpy()
        got = port_model.encoder.encode_text(torch.tensor(tokens, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=TEXT_RTOL, atol=TEXT_ATOL)


def test_vis_matches_reference_composition(hf_model, port_model):
    """The erf-GELU vision oracle of JAX's test (not HF's quick_gelu tower)."""
    imgs = np.random.default_rng(2).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    want = _torch_vision_oracle(hf_model, torch.tensor(imgs.transpose(0, 3, 1, 2))).numpy()
    with torch.no_grad():
        got = port_model.encoder.encode_vision(torch.from_numpy(imgs), 0).numpy()
    np.testing.assert_allclose(got, want, rtol=VIS_TOL, atol=VIS_TOL)


def test_nir_grayscale_invariance_and_equal_trunks(port_model):
    """nir patchifies the channel mean with the gray kernel: an RGB
    permutation leaves it fixed; at zero lora_B every expert routes the same
    tokens to the same trunk output."""
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32))
    vision = port_model.encoder.vision
    with torch.no_grad():
        feats = port_model.encoder.encode_vision(imgs, 1)
        perm = port_model.encoder.encode_vision(imgs[..., [2, 0, 1]], 1)
        tokens = torch.from_numpy(rng.normal(size=(1, 2, 4, D_V)).astype(np.float32))
        outs = [vision.trunk(tokens, (i,)) for i in range(4)]
    assert torch.isfinite(feats).all()
    np.testing.assert_allclose(feats.numpy(), perm.numpy(), rtol=1e-4, atol=1e-5)
    for i in range(1, 4):
        np.testing.assert_allclose(outs[i].numpy(), outs[0].numpy(), rtol=1e-5, atol=1e-6)


def _hub(tmp_path, hf_sd, rev="0123abcd"):
    """A fake HF hub cache holding REPO_ID's snapshot (model.safetensors)."""
    repo = tmp_path / "hub" / ("models--" + REPO_ID.replace("/", "--"))
    snap = repo / "snapshots" / rev
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(rev)
    convert_clip.write_safetensors(str(snap / "model.safetensors"), hf_sd)
    return tmp_path / "hub"


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["safetensors", "safetensors_written", "bf16_safetensors",
                                  "bin", "npz", "snapshot_dir", "snapshot_dir_bin", "hub", "hf"])
def test_load_hf_state_dict(kind, hf_model, hf_sd, tmp_path, monkeypatch):
    from safetensors.numpy import load_file, save_file

    want = hf_sd
    if kind == "safetensors":  # the port's reader on the library's file
        path = str(tmp_path / "m.safetensors")
        save_file({k: np.ascontiguousarray(v) for k, v in hf_sd.items()}, path)
    elif kind == "safetensors_written":  # the port's writer, read by the library
        path = str(tmp_path / "m.safetensors")
        convert_clip.write_safetensors(path, hf_sd)
        assert_same(load_file(path), hf_sd)
    elif kind == "bf16_safetensors":
        from safetensors.torch import save_file as save_torch

        sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in hf_model.state_dict().items()}
        path = str(tmp_path / "m.safetensors")
        save_torch({k: v.contiguous() for k, v in sd.items()}, path)
        want = {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in sd.items()}
    elif kind == "bin":
        path = str(tmp_path / "m.bin")
        torch.save(hf_model.state_dict(), path)
    elif kind == "npz":
        path = str(tmp_path / "m.npz")
        np.savez(path, **hf_sd)
    elif kind == "snapshot_dir":
        path = str(tmp_path)
        convert_clip.write_safetensors(str(tmp_path / "model.safetensors"), hf_sd)
        torch.save({}, str(tmp_path / "pytorch_model.bin"))  # safetensors first
    elif kind == "snapshot_dir_bin":
        path = str(tmp_path)
        torch.save(hf_model.state_dict(), str(tmp_path / "pytorch_model.bin"))
    else:
        monkeypatch.setenv("HF_HUB_CACHE", str(_hub(tmp_path, hf_sd)))
        path = REPO_ID
        if kind == "hf":
            cfg = TrainingConfig(clip_weights_path="hf")
            assert cfg.clip_model_name == REPO_ID
            path = convert_clip.clip_source(cfg)
    assert_same(convert_clip.load_hf_state_dict(path), want)


def test_hub_cache_resolution_and_misses(tmp_path, hf_sd, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    assert convert_clip.hub_cache_dir() == str(tmp_path / "home" / "hub")
    with pytest.raises(FileNotFoundError, match="models--openai--clip-vit-base-patch16"):
        convert_clip.load_hf_state_dict(REPO_ID)
    hub = _hub(tmp_path, hf_sd)
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    (hub / ("models--" + REPO_ID.replace("/", "--")) / "refs" / "main").write_text("gone")
    with pytest.raises(FileNotFoundError, match="snapshots/gone"):
        convert_clip.load_hf_state_dict(REPO_ID)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint file"):
        convert_clip.load_hf_state_dict(str(tmp_path / "empty"))


def test_shape_mismatch_names_the_path(hf_sd):
    cfg = TrainingConfig(**PORT_WIDTHS)
    flat = init_params(cfg, 7, perturb=False)
    bad = dict(hf_sd)
    bad["vision_model.encoder.layers.1.self_attn.k_proj.weight"] = np.zeros((D_V, D_V + 1),
                                                                           np.float32)
    with pytest.raises(ValueError, match="shape mismatch at params/encoder/vision/block_1/"
                                         "attn/k_proj/shared/kernel"):
        convert_clip.convert_clip_params(bad, flat)
    # a wider template (another preset) fails on the first leaf it reaches
    wide = init_params(cfg.replace(vision_hidden_dim=2 * D_V, vision_heads=8), 7, perturb=False)
    with pytest.raises(ValueError, match="shape mismatch at params/encoder/vision/patch_embed_vis"):
        convert_clip.convert_clip_params(hf_sd, wide)
    # an f16 checkpoint cannot lower the f32 template
    half = {k: v.astype(np.float16) for k, v in hf_sd.items()}
    out = convert_clip.convert_clip_params(half, flat)
    assert {v.dtype for v in out.values()} == {np.dtype(np.float32)}


def test_cli_writes_jax_keys(tmp_path, hf_sd, jax_encoder_params, monkeypatch):
    """The command line converts into a default-config encoder template and
    writes JAX's keys; here with the tiny widths patched in."""
    monkeypatch.setattr(convert_clip, "encoder_template",
                        lambda config, seed=0: {
                            "params/" + k[len("params/encoder/"):]: v
                            for k, v in init_params(TrainingConfig(**PORT_WIDTHS), 1, seed,
                                                    perturb=False).items()
                            if k.startswith("params/encoder/")})
    src = str(tmp_path / "clip.safetensors")
    convert_clip.write_safetensors(src, hf_sd)
    out = str(tmp_path / "clip.npz")
    convert_clip.main(["--clip_path", src, "--out", out, "--seed", "2"])
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    want = flat_np(jax_convert.convert_clip_params(hf_sd, jax_encoder_params, seed=2))
    assert set(got) == set(want)
    for k in want:
        if "lora_A" not in k:  # drawn by each package's own initialiser
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jitted_init(init):
    def jinit(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: init(self, r, *a, **kw))(rngs, *args)
    return jinit


def test_trainer_starts_from_jax_trainers_leaves(orbench_root, hf_sd, tmp_path):
    """Both trainers on one tiny config with clip_weights_path: every leaf the
    conversion writes is the same bits; the LoRA B's are zero in both (each
    package draws its lora_A, fusion and head from its own initialiser)."""
    snap = tmp_path / "clip"
    snap.mkdir()
    convert_clip.write_safetensors(str(snap / "model.safetensors"), hf_sd)
    common = dict(TINY_BASE, **PORT_WIDTHS, data_root=orbench_root,
                  json_file=os.path.join(orbench_root, "text_annos.json"),
                  clip_weights_path=str(snap), num_workers=0, num_ids_per_batch=2,
                  instances_per_id=2, seed=3)

    def dirs(side):
        return dict(save_dir=str(tmp_path / side / "ckpt"), log_dir=str(tmp_path / side / "logs"),
                    eval_cache_dir=str(tmp_path / side / "cache"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "init", _jitted_init(JaxModel.init))
        mp.setattr(JaxTrainer, "smoke_test", lambda self: None)
        jtrainer = JaxTrainer(JaxConfig(**common, **dirs("jax"), mesh_shape=(1,)))
    ptrainer = Trainer(TrainingConfig(**common, **dirs("port")), device="cpu")
    want = {k: v for k, v in flat_np({"params": jtrainer.state.params}).items()
            if k.startswith("params/encoder/")}
    got = {("params/" + n.replace(".", "/")): p.detach().numpy()
           for n, p in ptrainer.model.named_parameters()}
    converted = [k for k in want if "lora_" not in k]
    assert len(converted) > 50
    diff = [k for k in converted if not np.array_equal(got[k], want[k])]
    assert not diff, diff[:5]
    for k in want:
        if k.endswith("lora_B"):
            assert not got[k].any() and not want[k].any(), k
    # the noisy copies came from the config's seed
    assert not np.array_equal(got["params/encoder/vision/patch_embed_cp/kernel"],
                              got["params/encoder/vision/patch_embed_vis/kernel"])
