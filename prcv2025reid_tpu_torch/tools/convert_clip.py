"""HF CLIP -> the port's flat parameter dict (counterpart of the JAX
package's ``tools/convert_clip.py``, leaf for leaf and bit for bit).

Reproduces the reference's weight surgery:

- 4 per-modality patch-embed copies from CLIP's patch conv; 1-channel
  modalities (nir/sk) take the channel-mean of the RGB kernel; every non-vis
  copy gets sigma=0.02 kernel noise (and sigma=0.01 bias noise) to break
  symmetry, drawn from ``np.random.default_rng(seed)`` once per modality in
  order, kernel first, in float64 (cast to the template's dtype at the end).
- CLS token + positional embedding cloned from the vision embeddings.
- All vision blocks: LN1/LN2, Q/K/V/out projections and MLP fc1/fc2 into the
  MER *shared* trunks; the LoRA leaves keep their initial values (A random,
  B zero => delta-W = 0).
- Vision final LN from ``post_layernorm``; the vision projection from
  ``visual_projection``; the text tower copied wholesale; ``text_proj`` from
  ``text_projection``.

The input is a flat ``{hf_key: np.ndarray}`` state dict (a snapshot
directory, a ``.safetensors`` / ``.bin`` / ``.npz`` file, or an HF repo id
resolved in the local hub cache: nothing is downloaded).  The template is
the port's flat ``/``-keyed dict (``params.init_params``), the encoder under
``prefix`` (``params/encoder/`` in the model's dict, ``params/`` in the
encoder-only dict the command line writes).  Torch Linear weights
``[out, in]`` are transposed to ``[in, out]``; conv kernels ``[D, C, P, P]``
are laid out as the patchify order ``[P, P, C, D]``.

CLI (JAX's flags and keys):
    python3 -m prcv2025reid_tpu_torch.tools.convert_clip \\
        --clip_path /ckpts/clip-vit-base-patch16 --out clip.npz [--seed 0]
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import numpy as np

from prcv2025reid_tpu_torch.utils.modalities import SINGLE_CHANNEL, VISION_MODALITIES

NOISE_KERNEL_STD = 0.02
NOISE_BIAS_STD = 0.01
SNAPSHOT_FILES = ("model.safetensors", "pytorch_model.bin")
# safetensors dtype names -> numpy; BF16 is widened to float32 (exactly)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear [out, in] -> kernel [in, out]."""
    return np.ascontiguousarray(w.T)


def _assign(flat: Dict[str, np.ndarray], key: str, value) -> None:
    """Overwrite a template leaf: the template's dtype wins (an fp16 file
    cannot lower the f32 parameters) and a shape mismatch raises naming the
    path (e.g. patch32 weights into a patch16 template)."""
    cur = flat[key]
    value = np.asarray(value)
    if value.shape != cur.shape:
        raise ValueError(
            f"shape mismatch at {key}: template {cur.shape} vs checkpoint {value.shape} "
            "— wrong model preset for this CLIP checkpoint?")
    flat[key] = value.astype(cur.dtype)


# ----- reading a checkpoint -----

def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}}, then the raw little-endian
    data (offsets relative to the end of the header)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dtype, shape = info["dtype"], tuple(info["shape"])
        if dtype == "BF16":
            bits = np.frombuffer(data, "<u2", (end - start) // 2, start).astype(np.uint32)
            out[name] = (bits << 16).view(np.float32).reshape(shape)
        elif dtype in _ST_DTYPES:
            le = np.dtype(_ST_DTYPES[dtype]).newbyteorder("<")
            out[name] = np.frombuffer(data, le, (end - start) // le.itemsize, start
                                      ).reshape(shape).astype(_ST_DTYPES[dtype])
        else:
            raise ValueError(f"{path}: tensor {name} has dtype {dtype}, which this reader "
                             f"does not know ({sorted(_ST_DTYPES) + ['BF16']})")
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Write ``tensors`` in the ``.safetensors`` layout (the header padded
    with spaces to a multiple of 8 bytes, the tensors in name order)."""
    arrays = {name: np.asarray(tensors[name]) for name in sorted(tensors)}
    header, offset = {}, 0
    for name, a in arrays.items():
        header[name] = {"dtype": _ST_NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in arrays.values():
            f.write(np.asarray(a, a.dtype.newbyteorder("<")).tobytes())


def hub_cache_dir() -> str:
    """The local HF hub cache: ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``~/.cache/huggingface/hub``."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def resolve_repo_id(repo_id: str) -> str:
    """An HF repo id (``org/name``) -> its snapshot directory in the local
    hub cache (``models--org--name/refs/main`` names the revision)."""
    repo = os.path.join(hub_cache_dir(), "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        raise FileNotFoundError(f"{repo_id!r} is not in the local HF hub cache: no {ref}")
    with open(ref) as f:
        snapshot = os.path.join(repo, "snapshots", f.read().strip())
    if not os.path.isdir(snapshot):
        raise FileNotFoundError(f"{repo_id!r}: no snapshot directory {snapshot}")
    return snapshot


def load_hf_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A CLIP checkpoint as ``{hf_key: np.ndarray}``: a snapshot directory
    (``model.safetensors``, then ``pytorch_model.bin``), a ``.safetensors``,
    ``.bin`` or ``.npz`` file, or an HF repo id such as
    ``openai/clip-vit-base-patch16`` found in the local hub cache."""
    if not os.path.exists(path) and "/" in path and not os.path.isabs(path) and \
            not path.endswith((".safetensors", ".bin", ".npz")):
        path = resolve_repo_id(path)
    if os.path.isdir(path):
        for name in SNAPSHOT_FILES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            raise FileNotFoundError(f"no checkpoint file ({', '.join(SNAPSHOT_FILES)}) "
                                    f"under {path}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no CLIP checkpoint at {path}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in sd.items()}


def clip_source(config) -> str:
    """What ``config.clip_weights_path`` names: ``"hf"`` is the preset's
    ``clip_model_name``."""
    path = config.clip_weights_path
    return config.clip_model_name if path == "hf" else path


def hf_clip_shapes(config) -> Dict[str, tuple]:
    """The keys of an HF ``CLIPModel`` state dict at ``config``'s widths,
    each with (shape, numpy dtype); ``position_ids`` and ``logit_scale`` and
    the vision tower's ``pre_layrnorm`` are there too, as in the published
    checkpoints, and the conversion ignores them."""
    D, F, Dt, Ft = (config.vision_hidden_dim, config.vision_mlp_dim, config.text_hidden_dim,
                    config.text_mlp_dim)
    P, n_pos, ctx = config.patch_size, config.num_patches + 1, config.text_context_length
    f32, i64 = np.float32, np.int64
    out = {
        "logit_scale": ((), f32),
        "vision_model.embeddings.class_embedding": ((D,), f32),
        "vision_model.embeddings.patch_embedding.weight": ((D, 3, P, P), f32),
        "vision_model.embeddings.position_embedding.weight": ((n_pos, D), f32),
        "vision_model.embeddings.position_ids": ((1, n_pos), i64),
        "vision_model.pre_layrnorm.weight": ((D,), f32),
        "vision_model.pre_layrnorm.bias": ((D,), f32),
        "vision_model.post_layernorm.weight": ((D,), f32),
        "vision_model.post_layernorm.bias": ((D,), f32),
        "visual_projection.weight": ((config.fusion_dim, D), f32),
        "text_model.embeddings.token_embedding.weight": ((config.text_vocab_size, Dt), f32),
        "text_model.embeddings.position_embedding.weight": ((ctx, Dt), f32),
        "text_model.embeddings.position_ids": ((1, ctx), i64),
        "text_model.final_layer_norm.weight": ((Dt,), f32),
        "text_model.final_layer_norm.bias": ((Dt,), f32),
        "text_projection.weight": ((config.fusion_dim, Dt), f32),
    }
    for tower, width, mlp, layers in (("vision_model", D, F, config.vision_layers),
                                      ("text_model", Dt, Ft, config.text_layers)):
        for i in range(layers):
            p = f"{tower}.encoder.layers.{i}."
            for name in ("layer_norm1", "layer_norm2"):
                out[f"{p}{name}.weight"] = out[f"{p}{name}.bias"] = ((width,), f32)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{p}self_attn.{proj}.weight"] = ((width, width), f32)
                out[f"{p}self_attn.{proj}.bias"] = ((width,), f32)
            out[f"{p}mlp.fc1.weight"], out[f"{p}mlp.fc1.bias"] = ((mlp, width), f32), ((mlp,), f32)
            out[f"{p}mlp.fc2.weight"], out[f"{p}mlp.fc2.bias"] = ((width, mlp), f32), ((width,), f32)
    return out


# ----- the conversion -----

def convert_clip_params(hf: Mapping[str, np.ndarray], flat: Mapping[str, np.ndarray],
                        seed: int = 0, modalities=VISION_MODALITIES,
                        prefix: str = "params/encoder/") -> Dict[str, np.ndarray]:
    """Write CLIP weights into a copy of the flat dict ``flat`` whose encoder
    leaves sit under ``prefix``; returns the copy (every other leaf as it
    was)."""
    out = dict(flat)
    rng = np.random.default_rng(seed)
    vis, txt = prefix + "vision/", prefix + "text/"

    # the patch embeds
    conv = hf["vision_model.embeddings.patch_embedding.weight"]  # [D, C, P, P]
    kernel_rgb = conv.transpose(2, 3, 1, 0)  # [P, P, C, D]
    kernel_gray = conv.mean(axis=1, keepdims=True).transpose(2, 3, 1, 0)  # [P, P, 1, D]
    for mod in modalities:
        k = (kernel_gray if mod in SINGLE_CHANNEL else kernel_rgb).copy()
        pe = f"{vis}patch_embed_{mod}/"
        bias = np.zeros_like(out[pe + "bias"])
        if mod != "vis":
            k = k + rng.normal(0, NOISE_KERNEL_STD, k.shape)
            bias = bias + rng.normal(0, NOISE_BIAS_STD, bias.shape)
        _assign(out, pe + "kernel", k)
        _assign(out, pe + "bias", bias)

    # CLS and positions
    _assign(out, vis + "cls_token",
            hf["vision_model.embeddings.class_embedding"].reshape(1, 1, -1))
    _assign(out, vis + "pos_embed", hf["vision_model.embeddings.position_embedding.weight"])

    # the vision blocks into the MER shared trunks
    n_layers = sum(1 for k in out if k.startswith(vis + "block_") and k.endswith("/ln1/scale"))
    for i in range(n_layers):
        p, at = f"vision_model.encoder.layers.{i}.", f"{vis}block_{i}/"
        for ln in ("1", "2"):
            _assign(out, f"{at}ln{ln}/scale", hf[f"{p}layer_norm{ln}.weight"])
            _assign(out, f"{at}ln{ln}/bias", hf[f"{p}layer_norm{ln}.bias"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _assign(out, f"{at}attn/{proj}/shared/kernel", _t(hf[f"{p}self_attn.{proj}.weight"]))
            _assign(out, f"{at}attn/{proj}/shared/bias", hf[f"{p}self_attn.{proj}.bias"])
        for fc in ("fc1", "fc2"):
            _assign(out, f"{at}mlp/{fc}/shared/kernel", _t(hf[f"{p}mlp.{fc}.weight"]))
            _assign(out, f"{at}mlp/{fc}/shared/bias", hf[f"{p}mlp.{fc}.bias"])

    # the vision final LN and projection
    _assign(out, vis + "ln_final/scale", hf["vision_model.post_layernorm.weight"])
    _assign(out, vis + "ln_final/bias", hf["vision_model.post_layernorm.bias"])
    _assign(out, vis + "proj/kernel", _t(hf["visual_projection.weight"]))

    # the text tower, wholesale
    _assign(out, txt + "token_embedding/embedding",
            hf["text_model.embeddings.token_embedding.weight"])
    _assign(out, txt + "pos_embed", hf["text_model.embeddings.position_embedding.weight"])
    n_text = sum(1 for k in out if k.startswith(txt + "block_") and k.endswith("/ln1/scale"))
    for i in range(n_text):
        p, at = f"text_model.encoder.layers.{i}.", f"{txt}block_{i}/"
        for ln in ("1", "2"):
            _assign(out, f"{at}ln{ln}/scale", hf[f"{p}layer_norm{ln}.weight"])
            _assign(out, f"{at}ln{ln}/bias", hf[f"{p}layer_norm{ln}.bias"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _assign(out, f"{at}{proj}/kernel", _t(hf[f"{p}self_attn.{proj}.weight"]))
            _assign(out, f"{at}{proj}/bias", hf[f"{p}self_attn.{proj}.bias"])
        for fc in ("fc1", "fc2"):
            _assign(out, f"{at}{fc}/kernel", _t(hf[f"{p}mlp.{fc}.weight"]))
            _assign(out, f"{at}{fc}/bias", hf[f"{p}mlp.{fc}.bias"])
    _assign(out, txt + "ln_final/scale", hf["text_model.final_layer_norm.weight"])
    _assign(out, txt + "ln_final/bias", hf["text_model.final_layer_norm.bias"])
    _assign(out, prefix + "text_proj/kernel", _t(hf["text_projection.weight"]))
    return out


def encoder_template(config, seed: int = 0) -> Dict[str, np.ndarray]:
    """The encoder's leaves of ``init_params(config, perturb=False)`` keyed
    as JAX's ``UnifiedEncoder.init`` tree flattens (``params/vision/...``)."""
    from prcv2025reid_tpu_torch.params import init_params

    flat = init_params(config, num_classes=1, seed=seed, perturb=False)
    return {"params/" + k[len("params/encoder/"):]: v for k, v in flat.items()
            if k.startswith("params/encoder/")}


def main(argv=None):
    """CLI: a local HF CLIP snapshot -> an encoder-only ``.npz`` with JAX's
    keys (``params/vision/...``, ``params/text/...``, ``params/text_proj/...``)."""
    import argparse

    from prcv2025reid_tpu_torch.configs import TrainingConfig

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clip_path", required=True, help="local HF snapshot dir or file")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    template = encoder_template(TrainingConfig(), args.seed)
    converted = convert_clip_params(load_hf_state_dict(args.clip_path), template,
                                    seed=args.seed, prefix="params/")
    np.savez(args.out, **converted)
    print(f"wrote {len(converted)} arrays to {args.out}")


if __name__ == "__main__":
    main()
