"""The port's dataset evaluation against the JAX package's, on the CPU.

One JAX ``MultiModalReIDModel`` at the tiny f32 widths of ``TINY_BASE``, its
lora_B, biases and BN statistics perturbed, exported flat and loaded into
the port; both read the synthetic ORBench tree of ``tests/conftest.py`` (12
records, 6 ids) with the hash tokenizer.  The features are held to 2e-4
(the x8-scaled bn_features of an f32 forward summed in another order, as
``tests/test_torch_slice.py``), the metrics to 1e-5, and the cache tag, the
cache files and the submission CSV must be identical.  JAX compiles one
graph a combo, so the JAX side runs the trainer's default plans (the four
singles and the quad) and is cached per combo; the port alone runs all 15.
"""
import dataclasses
import math
import os
import sys
import time
from pathlib import Path

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from conftest import TINY_BASE  # noqa: E402

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig  # noqa: E402
from prcv2025reid_tpu.data.dataset import MultiModalDataset as JaxDataset  # noqa: E402
from prcv2025reid_tpu.data.pipeline import collate as jax_collate  # noqa: E402
from prcv2025reid_tpu.data.tokenizer import build_tokenizer as jax_build_tokenizer  # noqa: E402
from prcv2025reid_tpu.evaluation import protocol as jax_protocol  # noqa: E402
from prcv2025reid_tpu.models.reid_model import MultiModalReIDModel as JaxModel  # noqa: E402
from prcv2025reid_tpu.training import train_step as jax_train_step  # noqa: E402
from prcv2025reid_tpu_torch import (  # noqa: E402
    TrainingConfig,
    build_model,
    make_combo_embed_step,
    make_embed_step,
)
from prcv2025reid_tpu_torch.data.dataset import MultiModalDataset  # noqa: E402
from prcv2025reid_tpu_torch.data.pipeline import collate  # noqa: E402
from prcv2025reid_tpu_torch.data.tokenizer import build_tokenizer  # noqa: E402
from prcv2025reid_tpu_torch.evaluation import protocol  # noqa: E402

NUM_CLASSES = 7
FEAT_TOL = 2e-4
METRIC_TOL = 1e-5
BATCH = 5  # 12 records: two full batches and a padded tail of 2
PLANS = JaxConfig().eval_include_patterns  # the four singles and the quad


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


@pytest.fixture(scope="module")
def jcfg(orbench_root):
    return JaxConfig(**TINY_BASE, data_root=orbench_root,
                     json_file=os.path.join(orbench_root, "text_annos.json"))


@pytest.fixture(scope="module")
def datasets(jcfg):
    return MultiModalDataset(port_config(jcfg), "val"), JaxDataset(jcfg, "val")


@pytest.fixture(scope="module")
def tokenizers(jcfg):
    return (build_tokenizer(None, jcfg.text_vocab_size, jcfg.text_context_length),
            jax_build_tokenizer(None, jcfg.text_vocab_size, jcfg.text_context_length))


@pytest.fixture(scope="module")
def flat_params(jcfg):
    S, ctx = jcfg.image_size, jcfg.text_context_length
    variables = jax.jit(lambda *a: JaxModel(config=jcfg, num_classes=NUM_CLASSES).init(
        {"params": jax.random.PRNGKey(0)}, *a, train=False))(
        jnp.zeros((2, 4, S, S, 3), jnp.float32), jnp.ones((2, 4)),
        jnp.zeros((2, ctx), jnp.int32), jnp.ones((2,)))
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(variables, sep="/").items()}
    rng = np.random.default_rng(1)
    for k, v in flat.items():
        if k.endswith("lora_B"):
            flat[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/bias") or k.endswith("bn/mean"):
            flat[k] = rng.normal(0.0, 0.05, v.shape).astype(np.float32)
        elif k.endswith("bn/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def jax_side(jcfg, flat_params):
    """(model, variables, embed factory): one jitted step per combo, kept."""
    variables = tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat_params.items()})
    model = JaxModel(config=jcfg, num_classes=NUM_CLASSES)
    steps = {}

    def factory(mods):
        if mods not in steps:
            steps[mods] = jax_train_step.make_combo_embed_step(model, mods)
        return steps[mods]

    return model, variables, factory


@pytest.fixture(scope="module")
def port_model(jcfg, flat_params):
    return build_model(port_config(jcfg), flat_params, device="cpu")


def port_factory(model, log=None):
    def factory(mods):
        if log is not None:
            log.append(mods)
        return make_combo_embed_step(model, mods)

    return factory


def test_make_embed_step_matches_jax(datasets, tokenizers, jax_side, port_model):
    ds, jds = datasets
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    mods = [("vis", "nir", "sk", "cp", "text"), ("nir", "text"), ("vis",), ("sk", "cp")]
    batch = collate([ds.get_query_sample(i, mods[i % 4], rng_p) for i in range(8)], tokenizers[0])
    jbatch = jax_collate([jds.get_query_sample(i, mods[i % 4], rng_j) for i in range(8)],
                         tokenizers[1])
    jmodel, variables, _ = jax_side
    want = np.asarray(jax_train_step.make_embed_step(jmodel)(variables, jbatch))
    got = make_embed_step(port_model)(batch["images"], batch["image_mask"],
                                      batch["text_tokens"], batch["text_mask"])
    assert got.dtype == torch.float32 and got.shape == want.shape == (8, TINY_BASE["fusion_dim"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEAT_TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mods", [("vis",)] + [tuple(p.split("/")[1].split("+")) for p in PLANS])
def test_embed_samples_matches_jax(mods, datasets, tokenizers, jax_side, port_model):
    ds, jds = datasets
    jmodel, variables, factory = jax_side
    idx = list(range(len(ds)))
    kw = {} if mods == ("vis",) else {"modalities": mods, "seed": 4}
    got, got_pids = protocol.embed_samples(make_combo_embed_step(port_model, mods), ds, idx,
                                           tokenizers[0], BATCH, **kw)
    want, want_pids = jax_protocol.embed_samples(factory(mods), variables, jds, idx,
                                                 tokenizers[1], BATCH, **kw)
    assert got.shape == want.shape == (len(idx), TINY_BASE["fusion_dim"])
    np.testing.assert_array_equal(got_pids, want_pids)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL)


def _assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_metrics_close(got[k], w)
        else:
            assert math.isclose(got[k], w, rel_tol=0, abs_tol=METRIC_TOL), (k, got[k], w)


@pytest.mark.parametrize("case", ["plain", "exclude_same_image", "sample_ratio"])
def test_evaluate_protocol_matches_jax(case, datasets, tokenizers, jax_side, port_model):
    ds, jds = datasets
    _, variables, factory = jax_side
    kw = dict(batch_size=BATCH, include_patterns=PLANS, seed=2,
              exclude_same_image=case == "exclude_same_image",
              sample_ratio=0.5 if case == "sample_ratio" else 1.0)
    got = protocol.evaluate_protocol(None, ds, tokenizers[0], embed_factory=port_factory(port_model),
                                     device="cpu", **kw)
    want = jax_protocol.evaluate_protocol(None, variables, jds, tokenizers[1],
                                          embed_factory=factory, **kw)
    assert sorted(got["detail"]) == sorted(PLANS)
    n_q = {d["num_queries"] for d in got["detail"].values()}
    assert n_q == ({6} if case == "sample_ratio" else {12})
    _assert_metrics_close(got, want)


def test_evaluate_protocol_runs_all_15_plans(datasets, tokenizers, port_model):
    ds, _ = datasets
    got = protocol.evaluate_protocol(None, ds, tokenizers[0], batch_size=BATCH,
                                     embed_factory=port_factory(port_model), device="cpu")
    assert sorted(got["detail"]) == sorted(n for n, _ in protocol.build_query_plans())
    assert len(got["detail"]) == 15
    for d in got["detail"].values():
        assert d["num_queries"] == len(ds)
        assert all(0.0 <= d[k] <= 1.0 for k in ("mAP", "top1", "cmc1", "cmc5", "cmc10"))
    assert {f"mm{k}_map" for k in (1, 2, 3, 4)} <= set(got)


# ----- the gallery cache and its tag -----


@pytest.mark.parametrize("over", [{}, {"use_pallas_attention": True, "compute_dtype": "float32"},
                                  {"block_impl": "fused", "token_reduce_mode": "prune"}])
def test_checkpoint_cache_tag_matches_jax(over, jax_side, port_model):
    _, variables, _ = jax_side
    for weighted in (False, True):
        want = jax_protocol.checkpoint_cache_tag(variables["params"], "val_v1", step=7,
                                                 config=JaxConfig(**over), weighted=weighted)
        got = protocol.checkpoint_cache_tag(port_model, "val_v1", step=7,
                                            config=TrainingConfig(**over), weighted=weighted)
        assert got == want
    assert ("=" in got) == bool(over)  # a non-default numerics field enters the tag


def test_gallery_cache_files_load_in_either_package(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(9, 4)).astype(np.float32)
    pids = rng.integers(0, 5, 9)
    idx = list(range(3, 12))
    protocol.GalleryCache(str(tmp_path), "t1").save(idx, feats, pids)
    f, p = jax_protocol.GalleryCache(str(tmp_path), "t1").load(idx)
    np.testing.assert_array_equal(f, feats)
    np.testing.assert_array_equal(p, pids)
    jax_protocol.GalleryCache(str(tmp_path), "t2").save(idx, feats * 2, pids + 1)
    f, p = protocol.GalleryCache(str(tmp_path), "t2").load(idx)
    np.testing.assert_array_equal(f, feats * 2)
    np.testing.assert_array_equal(p, pids + 1)
    assert protocol.GalleryCache(str(tmp_path), "t2").load(idx[:-1]) is None
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(c._path(idx)) for c in (protocol.GalleryCache(str(tmp_path), "t1"),
                                                 jax_protocol.GalleryCache(str(tmp_path), "t2")))


def test_gallery_cache_evicts_all_but_the_newest(tmp_path):
    cache = protocol.GalleryCache(str(tmp_path), "ev", keep_newest=2)
    t0 = time.time() - 100
    for i in range(5):
        idx = list(range(i + 1))
        cache.save(idx, np.zeros((i + 1, 2), np.float32), np.arange(i + 1))
        os.utime(cache._path(idx), (t0 + i, t0 + i))  # distinct, increasing mtimes
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(cache._path(list(range(n)))) for n in (4, 5))


def test_gallery_cache_hit_skips_the_gallery_embed(tmp_path, datasets, tokenizers, port_model):
    ds, _ = datasets
    log = []
    kw = dict(batch_size=BATCH, include_patterns=["single/nir"], device="cpu",
              embed_factory=port_factory(port_model, log))
    cache = protocol.GalleryCache(str(tmp_path), protocol.checkpoint_cache_tag(
        port_model, "val_v1", step=0, config=port_model.config))
    first = protocol.evaluate_protocol(None, ds, tokenizers[0], cache=cache, **kw)
    assert log == [("vis",), ("nir",)]
    gallery = [i for i, r in enumerate(ds.records) if r.vis]
    feats, _ = cache.load(gallery)
    log.clear()
    second = protocol.evaluate_protocol(None, ds, tokenizers[0], cache=cache, **kw)
    assert log == [("nir",)]  # the gallery came from the cache
    assert first == second
    np.testing.assert_array_equal(cache.load(gallery)[0], feats)


def test_export_submission_csv_matches_jax(tmp_path, datasets, tokenizers, jax_side, port_model):
    ds, jds = datasets
    _, variables, factory = jax_side
    n = protocol.export_submission_csv(None, ds, tokenizers[0], str(tmp_path / "port.csv"),
                                       batch_size=BATCH, k_values=(1, 4), seed=1, device="cpu",
                                       embed_factory=port_factory(port_model))
    jn = jax_protocol.export_submission_csv(None, variables, jds, tokenizers[1],
                                            str(tmp_path / "jax.csv"), batch_size=BATCH,
                                            k_values=(1, 4), seed=1, embed_factory=factory)
    port = (tmp_path / "port.csv").read_bytes()
    assert n == jn == 5 * len(ds) and port == (tmp_path / "jax.csv").read_bytes()
    rows = port.decode().splitlines()[1:]
    assert len(rows) == n
    for row in rows:
        ranked = row.split(",")[1].split()
        assert len(ranked) == len(set(ranked)) == len(ds)


def test_single_device_and_unported_options_raise(tmp_path, datasets, tokenizers, port_model):
    """Data parallelism is ported (tests/test_torch_parallel.py runs it in
    process groups): a one-process mesh or sharding gives the unsharded
    results, a mesh of two processes outside a group raises, and the
    multi-process gallery cache degenerates to the files in one process."""
    from prcv2025reid_tpu_torch.parallel.mesh import Mesh

    ds, _ = datasets
    kw = dict(embed_factory=port_factory(port_model), device="cpu")
    plain = protocol.evaluate_protocol(None, ds, tokenizers[0], **kw)
    for one in ({"mesh": Mesh()}, {"sharding": Mesh()}, {"mesh": Mesh(), "sharding": Mesh()}):
        assert protocol.evaluate_protocol(None, ds, tokenizers[0], **kw, **one) == plain
    for two in ({"mesh": Mesh(size=2)}, {"sharding": Mesh(size=2)}):
        with pytest.raises(ValueError, match="join the group"):
            protocol.evaluate_protocol(None, ds, tokenizers[0], **kw, **two)
    with pytest.raises(ValueError, match="join the group"):
        protocol.export_submission_csv(None, ds, tokenizers[0], str(tmp_path / "x.csv"),
                                       rerank={"top_n": 5}, mesh=Mesh(size=2), **kw)
    cache = protocol.GalleryCache(str(tmp_path), "mp", process_count=2)
    feats = np.arange(4, dtype=np.float32).reshape(2, 2)
    cache.save([0, 1], feats, np.arange(2))
    got = cache.load([0, 1])
    np.testing.assert_array_equal(got[0], feats)
    assert got[1].dtype == np.int64 and cache.load([1, 0]) is None
