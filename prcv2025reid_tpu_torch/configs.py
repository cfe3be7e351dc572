"""Typed configuration for the PyTorch port: own copy of the JAX
package's ``TrainingConfig`` with all of its fields (the towers, fusion,
the training step, the host data path, the evaluation, the trainer's
checkpoints and logs, the mesh and process settings), the same names,
defaults (full-width ViT-B/16) and validation, and its JSON form, model
presets and ``--key=value`` overrides, so a JAX run's ``host_state.json``
config reads back into the port and the reverse.

A value that the JAX package accepts but this port does not implement yet
raises ``NotImplementedError`` naming the ROADMAP.md item it waits for; it
is never silently ignored.  A combination that the JAX package accepts and
then silently bypasses raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import List, Optional, Tuple

from prcv2025reid_tpu_torch.utils.modalities import MODALITIES

_JAX_BLOCK_IMPLS = {
    "xla", "fused", "fused_int8", "fused_int8_mlp", "fused_qkv",
    "fused_interpret", "fused_int8_interpret", "fused_int8_mlp_interpret",
    "fused_qkv_interpret",
}


@dataclass
class TrainingConfig:
    # ----- data: the ORBench tree and its id-disjoint split -----
    data_root: str = "./data/train"
    json_file: str = "./data/train/text_annos.json"
    val_ratio: float = 0.2
    seed: int = 42

    # ----- model widths (defaults: ViT-B/16) -----
    clip_model_name: str = "openai/clip-vit-base-patch16"
    # CLIP weights to start from (tools/convert_clip.py): a local HF snapshot
    # directory, a .safetensors / .bin / .npz file with HF's keys, an HF repo
    # id in the local hub cache, or "hf" (= clip_model_name); None = random init
    clip_weights_path: Optional[str] = None
    fusion_dim: int = 512
    vision_hidden_dim: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 224
    # the CLIP text tower (JAX: no validation of these six beyond their types)
    text_hidden_dim: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp_dim: int = 2048
    text_vocab_size: int = 49408
    text_context_length: int = 77

    # MER LoRA routing
    enable_mer: bool = True
    mer_lora_rank: int = 4
    mer_lora_alpha: float = 1.0

    modalities: Tuple[str, ...] = ("vis", "nir", "sk", "cp", "text")
    freeze_text_backbone: bool = False
    drop_path: float = 0.15
    dropout_rate: float = 0.5

    # ----- batching: P ids x K instances, gradient accumulation -----
    num_ids_per_batch: int = 3
    instances_per_id: int = 2
    allow_id_reuse: bool = True
    sampling_fallback: bool = True  # soft-id fill + bucket swap when the strong pool is short
    min_modal_coverage: float = 0.8  # warn when the strong-id share drops below
    force_modal_pairs: bool = True  # per id K//2 vis + K-K//2 non-vis records
    # None = auto-size to target_effective_batch; an explicit int overrides
    gradient_accumulation_steps: Optional[int] = None
    target_effective_batch: int = 16
    freeze_backbone: bool = True
    num_epochs: int = 60
    steps_per_epoch: Optional[int] = None  # None = the sampler's estimate

    # ----- layered learning rates and their schedule -----
    base_learning_rate: float = 5e-6  # CLIP shared trunk
    mer_learning_rate: float = 2e-5  # LoRA experts
    tokenizer_learning_rate: float = 2e-5  # non-shared patch embeds
    fusion_learning_rate: float = 2e-5  # projections / fusion / other
    head_learning_rate: float = 3e-3  # classifier head
    head_lr_warmup_epochs: int = 2  # the head LR is flat from this 1-based epoch
    weight_decay: float = 1e-4
    warmup_epochs: int = 5
    scheduler: str = "cosine"  # cosine | step | multistep | plateau
    lr_floor_ratio: float = 0.01
    step_lr_every: int = 20
    step_lr_gamma: float = 0.1
    multistep_milestones: Tuple[int, ...] = (30, 50)
    plateau_factor: float = 0.5
    plateau_patience: int = 8
    plateau_threshold: float = 0.001
    plateau_min_scale: float = 0.001

    # ----- gradient clipping: p70 of the last 10 norms x 1.15 in [0.5, 3] -----
    adaptive_gradient_clip: bool = True
    max_grad_norm: float = 0.5
    adaptive_clip_min: float = 0.5
    adaptive_clip_max: float = 3.0
    adaptive_clip_pct: float = 0.70
    adaptive_clip_margin: float = 1.15
    adaptive_clip_window: int = 10
    # AdamW's second moment (nu) is STORED in this dtype; its arithmetic is f32
    opt_nu_dtype: str = "float32"

    # ----- losses -----
    ce_weight: float = 1.0
    label_smoothing: float = 0.1
    sdm_weight_warmup_epochs: int = 1
    sdm_weight_schedule: Tuple[float, ...] = (0.1, 0.3, 0.5)
    sdm_weight_initial: float = 0.1
    sdm_weight_final: float = 0.5
    sdm_weight_max: float = 0.5
    sdm_impl: str = "unrolled"  # "unrolled" (one pass per modality) | "batched"
    contrastive_weight: float = 0.0  # the live SDM weight before the first epoch
    sdm_dropout: float = 0.1  # both SDM-module dropout sites
    sdm_semantic_dim: int = 512
    sdm_num_heads: int = 8
    sdm_temperature: float = 0.2
    sdm_init_temperature: float = 0.18
    sdm_final_temperature: float = 0.16
    sdm_fallback_temperature: float = 0.20
    sdm_temp_warmup_epochs: int = 3

    # fusion module
    fusion_num_heads: int = 8
    fusion_mlp_ratio: float = 2.0
    fusion_dropout: float = 0.1

    # ----- augmentation (host side, uint8) -----
    random_flip: bool = True
    random_crop: bool = True
    crop_scale_min: float = 0.8
    color_jitter: bool = True
    color_jitter_strength: float = 0.2
    random_erase: float = 0.3

    # modality dropout (a whole modality for the whole batch; never 'vis')
    modality_dropout: float = 0.15
    modality_dropout_warmup_epochs: int = 3
    min_modalities: int = 1

    # the vis <-> non-vis pair-coverage health line (training/monitors.py)
    pair_coverage_target: float = 0.85
    pair_coverage_window: int = 100

    # ----- host pipeline -----
    # -1 = auto: the available cores - 1 decode workers, clamped to [1, 32];
    # 0 = in-process
    num_workers: int = -1
    prefetch_batches: int = 2
    tokenizer_vocab_path: Optional[str] = None  # CLIP vocab.json/merges.txt dir; None = hashed
    # JPEG decode + crop + resize in one pass through data/native/image_decode.cpp
    # (libjpeg, PIL-matching resampler); falls back to PIL per image
    use_native_decode: bool = False

    # ----- checkpoints and logs (training/trainer.py) -----
    save_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    save_freq: int = 20  # an epoch_{n} checkpoint every save_freq epochs
    # write each checkpoint in a background thread after a synchronous copy
    # to the host (training/checkpoint.py)
    async_checkpoint: bool = True
    best_model_path: Optional[str] = None  # None = "<save_dir>/best"
    tensorboard: bool = True  # scalar export to <log_dir>/tb (tensorboardX, optional)

    # ----- evaluation over a dataset -----
    eval_sample_ratio: float = 0.3
    eval_include_patterns: Tuple[str, ...] = (
        "single/nir",
        "single/sk",
        "single/cp",
        "single/text",
        "quad/nir+sk+cp+text",
    )
    eval_cache_dir: str = "./.eval_cache"
    eval_cache_tag: str = "val_v1"
    eval_batch_size: int = 64
    inference_batch_size: int = 8  # serving-mode embed batch
    eval_every_n_epoch: int = 1
    do_eval: bool = True
    rank_topk: int = 100  # submission export depth

    # numerics and compute-path selectors
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_pallas_attention: bool = False
    attn_backend: str = "xla"
    gelu_impl: str = "erf"
    use_fused_mlp: bool = False
    use_fused_resln: bool = False
    block_impl: str = "xla"
    token_keep: int = 0
    token_reduce_layer: int = 6
    token_reduce_mode: str = "merge"  # 'merge' | 'prune'
    token_reduce_train: bool = False
    # training-path backward schedules: "stored" keeps the residual (the
    # erf of the GELU, the [N, H, S, S] softmax); "remat" recomputes it
    gelu_bwd: str = "stored"
    attn_bwd: str = "stored"
    # torch.utils.checkpoint around every training block; remat_policy
    # "full" keeps each block's input, "dots" also the unbatched products
    # (models/vit.py::DOTS_SAVED)
    remat_blocks: bool = False
    remat_policy: str = "full"
    # JAX donates its train state into the jitted step; the port's step
    # updates the model and the optimizer state in place already, so this
    # setting changes nothing here (kept so that a JAX config reads back)
    donate_train_state: bool = True

    # ----- mesh and processes (JAX: parallel/mesh.py, utils/distributed.py) -----
    mesh_shape: Tuple[int, ...] = ()  # empty = one device
    mesh_axis_names: Tuple[str, ...] = ("data",)
    distributed: str = "off"  # "off" | "auto" | "on"
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    # populated at runtime
    num_classes: Optional[int] = None

    @property
    def batch_size(self) -> int:
        """P * K."""
        return self.num_ids_per_batch * self.instances_per_id

    @property
    def accum_steps(self) -> int:
        """Gradient-accumulation steps: an explicit value, else enough that
        batch_size * accum >= target_effective_batch."""
        if self.gradient_accumulation_steps is not None:
            return max(1, int(self.gradient_accumulation_steps))
        return max(1, self.target_effective_batch // max(1, self.batch_size))

    @property
    def vision_modalities(self) -> Tuple[str, ...]:
        return tuple(m for m in self.modalities if m != "text")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, s: str) -> "TrainingConfig":
        """The inverse of ``to_json`` (JSON lists become tuples); keys that
        are not fields are ignored, as JAX's ``from_json`` does."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in json.loads(s).items() if k in fields}
        return cls(**kw)

    def __post_init__(self):
        self.modalities = tuple(self.modalities)
        unknown_mods = [m for m in self.modalities if m not in MODALITIES]
        if unknown_mods:
            raise ValueError(
                f"unknown modalities {unknown_mods}; valid: {list(MODALITIES)}"
            )
        if len(set(self.modalities)) != len(self.modalities):
            raise ValueError(f"duplicate modalities: {self.modalities}")
        if not self.modalities or self.modalities[0] != "vis":
            raise ValueError(
                f"modalities must start with 'vis', got {self.modalities}"
            )
        if "text" in self.modalities and self.modalities[-1] != "text":
            raise ValueError(
                f"'text' must be the last modality, got {self.modalities}"
            )
        if self.block_impl not in _JAX_BLOCK_IMPLS:
            raise ValueError(
                f"block_impl={self.block_impl!r}; valid: {sorted(_JAX_BLOCK_IMPLS)}"
            )
        if self.attn_backend not in ("xla", "splash", "onesaug"):
            raise ValueError(
                f"attn_backend={self.attn_backend!r}; valid: "
                "['onesaug', 'splash', 'xla']"
            )
        if self.use_pallas_attention and self.attn_backend != "xla":
            raise ValueError(
                "use_pallas_attention=True conflicts with "
                f"attn_backend={self.attn_backend!r} — pick one attention core"
            )
        if self.gelu_impl not in ("erf", "tanh", "poly"):
            raise ValueError(
                f"gelu_impl={self.gelu_impl!r}; valid: ['erf', 'poly', 'tanh']"
            )
        if self.token_reduce_mode not in ("merge", "prune"):
            raise ValueError(
                f"token_reduce_mode={self.token_reduce_mode!r}; valid: ['merge', 'prune']"
            )
        if self.token_keep < 0:
            raise ValueError(f"token_keep={self.token_keep} must be >= 0")
        if self.token_keep and not (0 < self.token_reduce_layer < self.vision_layers):
            raise ValueError(
                f"token_reduce_layer={self.token_reduce_layer} must be in "
                f"[1, vision_layers-1={self.vision_layers - 1}]"
            )
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r}; valid: ['bfloat16', 'float32']"
            )
        if self.param_dtype != "float32":
            raise ValueError(f"param_dtype={self.param_dtype!r}; valid: ['float32']")
        for name, valid in (("gelu_bwd", ("remat", "stored")), ("attn_bwd", ("remat", "stored")),
                            ("remat_policy", ("dots", "full")),
                            ("opt_nu_dtype", ("bfloat16", "float32")),
                            ("sdm_impl", ("batched", "unrolled")),
                            ("scheduler", ("cosine", "multistep", "plateau", "step"))):
            if getattr(self, name) not in valid:
                raise ValueError(f"{name}={getattr(self, name)!r}; valid: {list(valid)}")
        if self.distributed not in ("off", "auto", "on"):
            raise ValueError(
                f"distributed={self.distributed!r}; valid: ['auto', 'off', 'on']"
            )
        if self.token_reduce_train and self.token_keep == 0:
            raise ValueError("token_reduce_train=True requires token_keep > 0")
        if self.num_workers < -1:
            raise ValueError(
                f"num_workers={self.num_workers} (use -1 for auto, 0 for "
                "in-process, or a positive worker count)"
            )
        self._reject_bypasses()
        self._reject_unported()

    def _reject_bypasses(self):
        """Combinations the JAX package accepts but then silently bypasses:
        its fused-stream trunk (``vit.py::_trunk_fused``) calls ``block.attn``
        and ``block.mlp`` directly, so it never reaches the block kernels,
        and it ignores the token reduction."""
        if self.use_fused_resln and self.block_impl != "xla":
            raise ValueError(
                f"use_fused_resln=True conflicts with block_impl={self.block_impl!r}: "
                "the fused-stream trunk never runs the block kernels — pick one"
            )
        if self.use_fused_resln and self.token_keep > 0:
            raise ValueError(
                f"use_fused_resln=True conflicts with token_keep={self.token_keep}: "
                "the fused-stream trunk runs every token through every block"
            )

    def _reject_unported(self):
        """Values the JAX package runs that have no counterpart in the port."""
        impl = self.block_impl.removesuffix("_interpret")
        if impl != self.block_impl:
            raise NotImplementedError(
                f"block_impl={self.block_impl!r}: interpret mode is a Pallas "
                "test device; the port runs the plain version for CPU tensors "
                f"— use block_impl={impl!r}"
            )


# ----- model presets (the CLIP families the encoder supports) -----
MODEL_PRESETS = {
    "clip-vit-base-patch16": dict(
        clip_model_name="openai/clip-vit-base-patch16",
        vision_hidden_dim=768, vision_layers=12, vision_heads=12,
        vision_mlp_dim=3072, patch_size=16,
        text_hidden_dim=512, text_layers=12, text_heads=8, text_mlp_dim=2048,
        fusion_dim=512,
    ),
    "clip-vit-base-patch32": dict(
        clip_model_name="openai/clip-vit-base-patch32",
        vision_hidden_dim=768, vision_layers=12, vision_heads=12,
        vision_mlp_dim=3072, patch_size=32,
        text_hidden_dim=512, text_layers=12, text_heads=8, text_mlp_dim=2048,
        fusion_dim=512,
    ),
    "clip-vit-large-patch14": dict(
        clip_model_name="openai/clip-vit-large-patch14",
        vision_hidden_dim=1024, vision_layers=24, vision_heads=16,
        vision_mlp_dim=4096, patch_size=14,
        text_hidden_dim=768, text_layers=12, text_heads=12, text_mlp_dim=3072,
        fusion_dim=768,
    ),
}


def apply_model_preset(config: TrainingConfig, preset: str) -> TrainingConfig:
    if preset not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset {preset!r}; have {sorted(MODEL_PRESETS)}")
    return config.replace(**MODEL_PRESETS[preset])


def apply_cli_overrides(config: TrainingConfig, argv: List[str]) -> TrainingConfig:
    """Apply ``--key=value`` overrides (a bare ``--key`` is ``true``), each
    value parsed by the type of the field's current value."""
    fields = {f.name for f in dataclasses.fields(TrainingConfig)}
    updates = {}
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"unrecognized argument: {arg!r} (expected --key=value)")
        key, raw = arg[2:].split("=", 1) if "=" in arg else (arg[2:], "true")
        key = key.replace("-", "_")
        if key not in fields:
            raise ValueError(f"unknown config field: {key!r}")
        updates[key] = _parse_value(raw, config, key)
    return config.replace(**updates)


def _parse_value(raw: str, config: TrainingConfig, key: str):
    current = getattr(config, key)
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        items = [x for x in raw.split(",") if x]
        if current and isinstance(current[0], float):
            return tuple(float(x) for x in items)
        if current and isinstance(current[0], int):
            return tuple(int(x) for x in items)
        if not current:
            # an empty default (mesh_shape=()) carries no element type:
            # each item becomes an int, else a float, else stays a string
            return tuple(_coerce(x) for x in items)
        return tuple(items)
    if current is None:
        if raw.lower() in ("none", "null", ""):
            return None
        try:
            return int(raw)
        except ValueError:
            return raw
    return raw


def _coerce(x: str):
    for kind in (int, float):
        try:
            return kind(x)
        except ValueError:
            pass
    return x
