"""The JAX and port trainers from the same initial weights, at the flagship
probe's tiny configuration (``tools_torch/flagship_train_probe.py --tiny``:
the 8 x 4 batch, 60 steps an epoch, the eval of ``single/nir`` at batch 8,
``--freeze_backbone=false``), with the config's randomness on (``rand``)
or off (``norand``).  A diagnostic, not a test: the two packages draw their
initial weights and their dropout masks from different generators, so two
probe runs at one seed differ by the draws; started from the same weights,
what is left is the masks.  ``init`` compares the draws' distributions
instead: each leaf's mean and std, JAX's flax init against the port's
``init_params(perturb=False)`` at the probe's widths.

    JAX_PLATFORMS=cpu python tests/jax_port_same_init.py rand|norand|init <work>
        [--epochs 2] [--seed 42]

``<work>/orbench`` is written (``make_synthetic_orbench``, 48 ids x 6
anchors, the probe's tree) unless it exists.  Prints each package's val
mAP (single/nir) and CE loss by epoch.
"""
import argparse
import dataclasses
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.traverse_util as tu  # noqa: E402
import numpy as np  # noqa: E402
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from prcv2025reid_tpu_torch import Trainer, TrainingConfig, init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.params import check_skipped, load_params  # noqa: E402
from prcv2025reid_tpu_torch.utils.synthetic import make_synthetic_orbench  # noqa: E402

NO_RANDOMNESS = dict(drop_path=0.0, dropout_rate=0.0, fusion_dropout=0.0, sdm_dropout=0.0,
                     modality_dropout=0.0)


def init_stats(jcfg, pcfg, classes=38):
    """Each leaf's mean and std in JAX's init and the port's: the leaves
    whose std differs by more than a factor 1.25 or whose means differ by
    more than 0.05 + 0.2 std."""
    import jax.numpy as jnp

    from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel
    from prcv2025reid_tpu_torch.params import init_params

    S, B = jcfg.image_size, 2
    variables = JaxModel(config=jcfg, num_classes=classes).init(
        {"params": jax.random.PRNGKey(jcfg.seed)}, jnp.zeros((B, 4, S, S, 3)),
        jnp.ones((B, 4)), jnp.zeros((B, jcfg.text_context_length), jnp.int32), jnp.ones(B),
        train=False)
    want = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    got = init_params(pcfg, classes, pcfg.seed, perturb=False)
    assert set(want) == set(got)
    differ = []
    for k in sorted(want):
        a, b = want[k], got[k]
        sa, sb = float(a.std()), float(b.std())
        ratio = 1.0 if sa == sb == 0 else sb / sa if sa else np.inf
        if not 0.8 < ratio < 1.25 or abs(float(a.mean()) - float(b.mean())) > 0.05 + 0.2 * max(
                sa, sb):
            differ.append((k, sa, sb))
    print(f"init: {len(want)} leaves, {len(differ)} differ in scale or mean: {differ}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("rand", "norand", "init"))
    ap.add_argument("work")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    root = os.path.join(args.work, "orbench")
    if not os.path.isdir(root):
        make_synthetic_orbench(root, num_ids=48, anchors_per_id=6, img_size=64)
    base = {**TINY_BASE, "num_epochs": args.epochs, "steps_per_epoch": 60,
            "num_ids_per_batch": 8, "instances_per_id": 4, "num_workers": 0,
            "eval_sample_ratio": 1.0, "eval_batch_size": 8,
            "eval_include_patterns": ("single/nir",), "save_freq": 100,
            "freeze_backbone": False, "data_root": root, "seed": args.seed,
            "json_file": os.path.join(root, "text_annos.json")}
    if args.mode == "norand":
        base.update(NO_RANDOMNESS)

    def dirs(side):
        work = os.path.join(args.work, args.mode, side)
        return dict(save_dir=f"{work}/ckpt", log_dir=f"{work}/logs",
                    eval_cache_dir=f"{work}/cache")

    jcfg = JaxConfig(**base, **dirs("jax"), mesh_shape=(1,))
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    pcfg = TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, "mesh_shape": (),
                             **dirs("port")})
    if args.mode == "init":
        return init_stats(jcfg, pcfg)
    jt = JaxTrainer(jcfg)
    pt = Trainer(pcfg, device="cpu")
    # the JAX trainer's initial parameters and BN statistics into the port
    flat = {k: np.array(v) for k, v in tu.flatten_dict(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}, sep="/").items()}
    check_skipped(load_params(pt.model, flat))
    pt.state = init_train_state(pt.model, pcfg, len(pt.sampler), seed=pcfg.seed + 1)
    jt.fit()
    pt.fit()
    for side, t in (("jax", jt), ("port", pt)):
        print(args.mode, side, "map_single",
              [round(r["map_single"], 4) for r in t.eval_history.rows],
              "ce", [round(r["ce_loss"], 4) for r in t.train_history.rows])


if __name__ == "__main__":
    main()
