"""Model diagnostics: activation-norm probes and zero-feature detection
(counterpart of the JAX package's ``tools/diagnose.py``).

Forward hooks stand where flax's ``capture_intermediates`` does: one eval
forward records the output of every module call, keyed by the flax path the
JAX report uses (``encoder/vision/block_3/attn/__call__/0``: the module's
path, ``__call__``, the call's index, then the index or key inside a tuple
or dict output), so the two reports can be compared entry by entry.  A
``LNParams`` call (``.params()``) records its (scale, bias), as the JAX
module's call returns them.

Usage (library):
    from prcv2025reid_tpu_torch.tools.diagnose import activation_report
    report = activation_report(model, batch)

CLI:
    python3 -m prcv2025reid_tpu_torch.tools.diagnose --model_path ./checkpoints/best \\
        --dataset_root /data/orbench [--cpu]
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from prcv2025reid_tpu_torch.models.mer import LNParams


def _record(store: Dict[str, np.ndarray], path: str, out) -> None:
    """Flatten one call's output under ``path`` as flax's walk does."""
    if isinstance(out, dict):
        for k, v in out.items():
            _record(store, f"{path}/{k}", v)
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            _record(store, f"{path}/{i}", v)
    elif isinstance(out, torch.Tensor):
        store[path] = out.detach().float().cpu().numpy()


def capture(model: torch.nn.Module, batch: Dict) -> Dict[str, np.ndarray]:
    """One eval forward of ``model`` on ``batch`` (numpy or tensors: images,
    image_mask, text_tokens, text_mask) -> {flax path: output}."""
    store: Dict[str, np.ndarray] = {}
    calls: Dict[str, int] = {}

    def key(name: str) -> str:
        n = calls.get(name, 0)
        calls[name] = n + 1
        return "/".join(p for p in (name.replace(".", "/"), "__call__", str(n)) if p)

    def hook(name):
        def fn(module, args, out):
            # the root's output is (outputs, new BN statistics): JAX's model
            # returns the outputs dict
            _record(store, key(name), out[0] if name == "" else out)
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]
    ln_names = {id(m): n for n, m in model.named_modules() if isinstance(m, LNParams)}
    params = LNParams.params

    def ln_params(self):
        out = params(self)
        if id(self) in ln_names:
            _record(store, key(ln_names[id(self)]), out)
        return out

    device = next(model.parameters()).device
    args = [torch.as_tensor(np.asarray(batch[k]), device=device)
            for k in ("images", "image_mask", "text_tokens", "text_mask")]
    LNParams.params = ln_params
    try:
        with torch.inference_mode():
            model(*args, train=False)
    finally:
        LNParams.params = params
        for h in handles:
            h.remove()
    return store


def activation_report(model: torch.nn.Module, batch: Dict, *,
                      zero_threshold: float = 1e-6,
                      explode_threshold: float = 1e3) -> Dict[str, Dict]:
    """Run one eval forward capturing every module output; return per-path
    {shape, mean_norm, max_abs, zero_fraction, nonfinite, flagged}."""
    report = {}
    for path, a in capture(model, batch).items():
        if a.size == 0:
            continue
        row_norms = np.linalg.norm(a.reshape(a.shape[0], -1), axis=1) if a.ndim > 1 else np.abs(a)
        entry = {
            "shape": tuple(a.shape),
            "mean_norm": float(row_norms.mean()),
            "max_abs": float(np.abs(a).max()),
            "zero_fraction": float((np.abs(a) < zero_threshold).mean()),
            "nonfinite": int((~np.isfinite(a)).sum()),
        }
        entry["flagged"] = bool(
            entry["nonfinite"] > 0
            or entry["zero_fraction"] > 0.99
            or entry["max_abs"] > explode_threshold
        )
        report[path] = entry
    return report


def summarize(report: Dict[str, Dict], only_flagged: bool = False) -> List[str]:
    lines = []
    for path, e in sorted(report.items()):
        if only_flagged and not e["flagged"]:
            continue
        flag = " <-- FLAGGED" if e["flagged"] else ""
        lines.append(
            f"{path}: shape={e['shape']} norm={e['mean_norm']:.3g} "
            f"max|x|={e['max_abs']:.3g} zeros={e['zero_fraction']:.1%} "
            f"nonfinite={e['nonfinite']}{flag}"
        )
    return lines


def main(argv=None, device="cuda"):
    import argparse
    import os

    from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset
    from prcv2025reid_tpu_torch.data.pipeline import collate
    from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer
    from prcv2025reid_tpu_torch.engine import load_checkpoint_model

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--json_file", default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--only_flagged", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    config, model, _, _ = load_checkpoint_model(os.path.abspath(args.model_path),
                                                "cpu" if args.cpu else device)
    config = config.replace(
        data_root=args.dataset_root,
        json_file=args.json_file or os.path.join(args.dataset_root, "text_annos.json"))
    ds = MultiModalDataset(config, "val")
    tok = build_tokenizer(config.tokenizer_vocab_path, config.text_vocab_size,
                          config.text_context_length)
    rng = np.random.default_rng(0)
    samples = [ds.get_sample(i, rng) for i in range(min(args.batch_size, len(ds)))]
    report = activation_report(model, collate(samples, tok))
    print("\n".join(summarize(report, only_flagged=args.only_flagged)))
    return report


if __name__ == "__main__":
    main()
