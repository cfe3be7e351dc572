"""The port's TrainingConfig against the JAX package's: the same 136 fields
and defaults, ``to_json`` / ``from_json`` in both directions,
``apply_model_preset`` and ``apply_cli_overrides`` on the same argv, the
values the port refuses with the ROADMAP.md item they wait for, and
``clip_weights_path``, accepted and resolved as the trainer loads it."""
import dataclasses
import json

import pytest

from prcv2025reid_tpu import configs as jax_configs
from prcv2025reid_tpu_torch import configs

# non-defaults of every kind that both packages accept
NON_DEFAULT = dict(
    num_epochs=7, steps_per_epoch=11, gradient_accumulation_steps=2, val_ratio=0.25,
    sdm_weight_schedule=(0.2, 0.4), multistep_milestones=(3, 5),
    eval_include_patterns=("single/nir", "quad/*"), best_model_path="/x/best",
    tokenizer_vocab_path="/x/vocab", donate_train_state=False, tensorboard=False,
    async_checkpoint=False, mesh_axis_names=("data", "model"), save_dir="/x/ckpt",
    log_dir="/x/logs", scheduler="plateau", rank_topk=50, num_classes=9,
    clip_model_name="openai/clip-vit-base-patch32", pair_coverage_window=7, do_eval=False,
)

ARGVS = {
    "bool": ["--do_eval=false", "--tensorboard", "--use_native_decode=yes",
             "--async_checkpoint=0"],
    "int": ["--num_epochs=7", "--save_freq=3", "--eval-every-n-epoch=2"],
    "float": ["--val_ratio=0.25", "--head_learning_rate=1e-2"],
    "float_tuple": ["--sdm_weight_schedule=0.2,0.4"],
    "int_tuple": ["--multistep_milestones=3,5"],
    "empty_tuple": ["--mesh_shape="],
    "str_tuple": ["--eval_include_patterns=single/nir,quad/*", "--mesh_axis_names=data,model"],
    "none": ["--best_model_path=none", "--steps_per_epoch=12", "--gradient_accumulation_steps=2",
             "--tokenizer_vocab_path=/v", "--num_classes=null"],
    "str": ["--scheduler=plateau", "--save_dir=/x/ckpt"],
}

UNPORTED = [
    ({"distributed": "auto"}, "Parallel and multi-process"),
    ({"distributed": "on"}, "Parallel and multi-process"),
    ({"mesh_shape": (1,)}, "Parallel and multi-process"),
    ({"mesh_shape": (4, 2), "mesh_axis_names": ("data", "model")}, "Parallel and multi-process"),
    ({"num_processes": 2}, "Parallel and multi-process"),
    ({"process_id": 0}, "Parallel and multi-process"),
    ({"coordinator_address": "localhost:1234"}, "Parallel and multi-process"),
]
# accepted since the CLIP loader came (tools/convert_clip.py): each value and
# the checkpoint source the trainer resolves it to
CLIP_PATHS = [("/ckpt/clip", "/ckpt/clip"), ("hf", "openai/clip-vit-base-patch16")]


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_same_fields_and_defaults():
    want, got = fields(jax_configs.TrainingConfig()), fields(configs.TrainingConfig())
    assert len(want) == 136
    assert got == want


@pytest.mark.parametrize("over", [{}, NON_DEFAULT], ids=["defaults", "non_defaults"])
def test_to_json_gives_jax_dict(over):
    want = json.loads(jax_configs.TrainingConfig(**over).to_json())
    assert json.loads(configs.TrainingConfig(**over).to_json()) == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_from_json_gives_every_field(direction):
    jcfg, pcfg = jax_configs.TrainingConfig(**NON_DEFAULT), configs.TrainingConfig(**NON_DEFAULT)
    if direction == "jax_to_port":
        got = configs.TrainingConfig.from_json(jcfg.to_json())
    else:
        got = jax_configs.TrainingConfig.from_json(pcfg.to_json())
    assert fields(got) == fields(jcfg)
    assert fields(got) == fields(pcfg)
    # a key that is not a field (a newer writer's) is ignored by both
    extra = json.dumps({**json.loads(jcfg.to_json()), "not_a_field": 1})
    assert fields(configs.TrainingConfig.from_json(extra)) == fields(jcfg)


@pytest.mark.parametrize("kind", sorted(ARGVS))
def test_cli_overrides_match_jax(kind):
    argv = ARGVS[kind]
    want = jax_configs.apply_cli_overrides(jax_configs.TrainingConfig(), argv)
    got = configs.apply_cli_overrides(configs.TrainingConfig(), argv)
    assert fields(got) == fields(want)
    for name, value in fields(got).items():
        assert type(value) is type(fields(want)[name]), name
    if kind == "empty_tuple":
        assert got.mesh_shape == ()
    if kind == "none":
        assert got.best_model_path is None and got.steps_per_epoch == 12
        assert got.num_classes is None and got.tokenizer_vocab_path == "/v"


@pytest.mark.parametrize("argv", [["--no_such_field=1"], ["num_epochs=3"]])
def test_cli_overrides_reject_what_jax_rejects(argv):
    with pytest.raises(ValueError):
        jax_configs.apply_cli_overrides(jax_configs.TrainingConfig(), argv)
    with pytest.raises(ValueError):
        configs.apply_cli_overrides(configs.TrainingConfig(), argv)


@pytest.mark.parametrize("preset", sorted(jax_configs.MODEL_PRESETS))
def test_model_presets_match_jax(preset):
    assert configs.MODEL_PRESETS[preset] == jax_configs.MODEL_PRESETS[preset]
    want = jax_configs.apply_model_preset(jax_configs.TrainingConfig(), preset)
    assert fields(configs.apply_model_preset(configs.TrainingConfig(), preset)) == fields(want)


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown model preset"):
        configs.apply_model_preset(configs.TrainingConfig(), "clip-vit-huge")


@pytest.mark.parametrize("override,item", UNPORTED, ids=[str(o) for o, _ in UNPORTED])
def test_unported_values_name_their_roadmap_item(override, item):
    jax_configs.TrainingConfig(**override)  # the JAX package runs it
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1, the item '{item}'"):
        configs.TrainingConfig(**override)
    # a JAX run's config with it reads back into the port only to raise
    with pytest.raises(NotImplementedError, match=item):
        configs.TrainingConfig.from_json(jax_configs.TrainingConfig(**override).to_json())


def test_distributed_typo_raises_in_both():
    with pytest.raises(ValueError, match="distributed="):
        jax_configs.TrainingConfig(distributed="yes")
    with pytest.raises(ValueError, match="distributed="):
        configs.TrainingConfig(distributed="yes")


def test_donate_train_state_is_accepted_and_changes_nothing():
    cfg = configs.TrainingConfig(donate_train_state=False)
    assert fields(cfg) == {**fields(configs.TrainingConfig()), "donate_train_state": False}


@pytest.mark.parametrize("value,source", CLIP_PATHS, ids=[v for v, _ in CLIP_PATHS])
def test_clip_weights_path_reaches_the_loader(value, source, tmp_path, monkeypatch):
    """Both packages accept it and read it back from JSON; the trainer's
    loader resolves "hf" to the preset's model name, looks a repo id up in
    the local hub cache, and names what it did not find."""
    from prcv2025reid_tpu_torch.tools import convert_clip

    jax_configs.TrainingConfig(clip_weights_path=value)
    cfg = configs.TrainingConfig(clip_weights_path=value)
    assert configs.TrainingConfig.from_json(cfg.to_json()).clip_weights_path == value
    assert configs.apply_cli_overrides(
        configs.TrainingConfig(), [f"--clip_weights_path={value}"]).clip_weights_path == value
    assert convert_clip.clip_source(cfg) == source
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    missing = "models--openai--clip-vit-base-patch16" if value == "hf" else source
    with pytest.raises(FileNotFoundError, match=missing):
        convert_clip.load_hf_state_dict(source)
