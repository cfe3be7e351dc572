"""The port's host data path against the JAX package's, on the CPU.

Both packages read the synthetic ORBench tree of ``tests/conftest.py`` (6
ids, 2 anchors an id, 32 px images) through their own dataset, sampler,
tokenizer, collate and pipeline, with the same seeds.  Everything here is
host-side numpy, so every comparison is exact: the sampler's index stream,
the decoded and augmented uint8 images and their masks, the token ids, the
splits and the collated batches must be equal bit for bit.  The native
(g++ / libjpeg) cases skip with a reason where those are missing.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from prcv2025reid_tpu.configs import TrainingConfig as JaxConfig
from prcv2025reid_tpu.data import dataset as jax_dataset
from prcv2025reid_tpu.data import native_image as jax_native_image
from prcv2025reid_tpu.data import pipeline as jax_pipeline
from prcv2025reid_tpu.data import sampler as jax_sampler
from prcv2025reid_tpu.data import split as jax_split
from prcv2025reid_tpu.data import tokenizer as jax_tokenizer
from prcv2025reid_tpu.utils.synthetic import make_synthetic_orbench as jax_make_synthetic
from prcv2025reid_tpu_torch.configs import TrainingConfig
from prcv2025reid_tpu_torch.data import dataset, native_build, native_image, pipeline
from prcv2025reid_tpu_torch.data import sampler, split, tokenizer
from prcv2025reid_tpu_torch.data.device_feed import prefetch_to_device
from prcv2025reid_tpu_torch.utils.synthetic import make_synthetic_orbench

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 2)


def port_config(jcfg: JaxConfig, **over) -> TrainingConfig:
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    return TrainingConfig(**{**{n: getattr(jcfg, n) for n in names}, **over})


def both_configs(tiny_data_config, **over):
    jcfg = dataclasses.replace(tiny_data_config, **over)
    return jcfg, port_config(jcfg)


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture
def native_decode():
    """Both packages' native image libraries, or a skip with the reason."""
    if not (jax_native_image.available() and native_image.available()):
        pytest.skip("g++ or libjpeg unavailable: the native decode cannot build")


# ----- the synthetic tree -----


def _tree_digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(Path(p).read_bytes()).hexdigest()
    return out


@pytest.mark.parametrize("kw", [{}, {"num_ids": 3, "anchors_per_id": 3, "img_size": 40}])
def test_synthetic_tree_is_byte_identical(tmp_path, kw):
    make_synthetic_orbench(str(tmp_path / "port"), **kw)
    jax_make_synthetic(str(tmp_path / "jax"), **kw)
    port, ref = _tree_digest(tmp_path / "port"), _tree_digest(tmp_path / "jax")
    assert port == ref and "text_annos.json" in port and len(port) > 10


# ----- the sampler -----

SAMPLER_CASES = {
    "default": {},
    "no_modal_pairs": {"force_modal_pairs": False},
    "no_id_reuse": {"allow_id_reuse": False},
    "odd_k": {"instances_per_id": 3},
    "steps_per_epoch": {"steps_per_epoch": 5},
}


def _samplers(tiny_data_config, case, seed):
    kw = dict(SAMPLER_CASES[case])
    K = kw.pop("instances_per_id", tiny_data_config.instances_per_id)
    jcfg, cfg = both_configs(tiny_data_config)
    args = dict(num_ids_per_batch=2, instances_per_id=K, seed=seed, **kw)
    return (sampler.PKBatchSampler(dataset.MultiModalDataset(cfg, "train"), **args),
            jax_sampler.PKBatchSampler(jax_dataset.MultiModalDataset(jcfg, "train"), **args))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_stream_matches_jax(tiny_data_config, case, seed):
    port, ref = _samplers(tiny_data_config, case, seed)
    assert len(port) == len(ref) and port.nominal_steps == ref.nominal_steps
    for _ in range(2):  # two epochs of one stream
        got, want = list(port), list(ref)
        assert got == want and len(got) > 0
        assert all(len(b) == port.batch_size for b in got)


def test_sampler_state_dict_round_trips_mid_epoch(tiny_data_config):
    port, ref = _samplers(tiny_data_config, "steps_per_epoch", 3)
    it, jit = iter(port), iter(ref)
    for _ in range(2):
        assert next(it) == next(jit)
    state = port.state_dict()
    assert json.dumps(state, sort_keys=True) == json.dumps(ref.state_dict(), sort_keys=True)
    rest = [next(it) for _ in range(3)]
    resumed, _ = _samplers(tiny_data_config, "steps_per_epoch", 99)
    resumed.load_state_dict(json.loads(json.dumps(state)))
    assert list(resumed)[:3] == rest


# ----- samples -----


@pytest.mark.parametrize("decode", ["pil", "native"])
@pytest.mark.parametrize("split_name,dropout", [("train", None), ("train", 0.5), ("val", None)])
def test_get_sample_matches_jax(tiny_data_config, request, decode, split_name, dropout):
    if decode == "native":
        request.getfixturevalue("native_decode")
    jcfg, cfg = both_configs(tiny_data_config, use_native_decode=decode == "native")
    port = dataset.MultiModalDataset(cfg, split_name)
    ref = jax_dataset.MultiModalDataset(jcfg, split_name)
    assert [r.anchor_vis for r in port.records] == [r.anchor_vis for r in ref.records]
    masks = []
    for seed in SEEDS:
        rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        for idx in (0, 5, len(ref) - 1, 3, 8):
            got = port.get_sample(idx, rng_p, modality_dropout=dropout)
            want = ref.get_sample(idx, rng_j, modality_dropout=dropout)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} seed {seed} idx {idx}")
            masks.append(got["image_mask"])
    masks = np.stack(masks)
    if split_name == "val":
        assert masks.all()  # every modality decoded, none dropped
    if dropout:
        assert not masks.all()  # the dropout ran


@pytest.mark.parametrize("decode", ["pil", "native"])
@pytest.mark.parametrize("mods", [("vis",), ("nir",), ("sk", "cp"), ("nir", "sk", "cp", "text")])
def test_get_query_sample_matches_jax(tiny_data_config, request, decode, mods):
    if decode == "native":
        request.getfixturevalue("native_decode")
    jcfg, cfg = both_configs(tiny_data_config, use_native_decode=decode == "native")
    port, ref = dataset.MultiModalDataset(cfg, "val"), jax_dataset.MultiModalDataset(jcfg, "val")
    for seed in SEEDS:
        rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        for idx in range(len(ref)):
            got, want = port.get_query_sample(idx, mods, rng_p), ref.get_query_sample(idx, mods, rng_j)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {mods} {idx}")


def test_scans_match_jax(tiny_data_config):
    jcfg, cfg = both_configs(tiny_data_config)
    port, ref = dataset.MultiModalDataset(cfg), jax_dataset.MultiModalDataset(jcfg)
    assert dataset.quick_scan(port) == jax_dataset.quick_scan(ref)
    got = dataset.analyze_sampling_capability(port)
    assert got == jax_dataset.analyze_sampling_capability(ref) and got["pairable"]


# ----- the split -----


@pytest.mark.parametrize("val_ratio,seed", [(0.2, 42), (0.5, 0), (0.34, 7)])
def test_create_split_datasets_matches_jax(tiny_data_config, val_ratio, seed):
    jcfg, cfg = both_configs(tiny_data_config, val_ratio=val_ratio, seed=seed)
    tr, va, p2l = split.create_split_datasets(cfg)
    jtr, jva, jp2l = jax_split.create_split_datasets(jcfg)
    assert p2l == jp2l
    for got, want in ((tr, jtr), (va, jva)):
        assert got.split == want.split and got.person_ids == want.person_ids
        assert [r.anchor_vis for r in got.records] == [r.anchor_vis for r in want.records]
        assert got.pid2label == want.pid2label
    assert split.verify_split_integrity(tr, va)
    assert split.split_ids(range(1, 30), val_ratio, seed) == jax_split.split_ids(
        range(1, 30), val_ratio, seed)


# ----- tokenizers -----

TEXTS = ["hello world", "the runner ering", "Hello,   WORLD!!", "it's working 4 u",
         "a-b c_d 1 2 3", "", "hellohello worldworld thething", "person 3 wearing outfit 1"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A small CLIP-layout vocab, written as tests/test_native_tokenizer.py does."""
    tmp_path = tmp_path_factory.mktemp("vocab")
    base = list(jax_tokenizer._bytes_to_unicode().values())
    vocab = {tok: i for i, tok in enumerate(base + [t + "</w>" for t in base])}
    merges = ["h e", "he l", "hel l", "hell o</w>", "w o", "wo r", "wor l", "worl d</w>",
              "t h", "th e</w>", "i n", "in g</w>", "e r</w>"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version\n" + "\n".join(merges) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("kind", ["hash", "python_bpe", "native_bpe", "built_cached"])
def test_tokenizers_match_jax(vocab_dir, kind):
    if kind == "hash":
        port, ref = tokenizer.HashTokenizer(100, 16), jax_tokenizer.HashTokenizer(100, 16)
    elif kind == "python_bpe":
        port = tokenizer.ClipBPETokenizer(vocab_dir, 16)
        ref = jax_tokenizer.ClipBPETokenizer(vocab_dir, 16)
    elif kind == "native_bpe":
        from prcv2025reid_tpu_torch.data.native_tokenizer import NativeClipBPETokenizer

        try:
            port = NativeClipBPETokenizer(vocab_dir, 16)
        except RuntimeError as e:
            pytest.skip(f"g++ unavailable: {e}")
        ref = jax_tokenizer.ClipBPETokenizer(vocab_dir, 16)
    else:
        port = tokenizer.build_tokenizer(vocab_dir, 100, 16)
        ref = jax_tokenizer.build_tokenizer(vocab_dir, 100, 16)
        assert isinstance(port, tokenizer.CachedTokenizer)
    for texts in (TEXTS, TEXTS[::-1] + TEXTS[:3]):  # the second pass hits the cache
        got, want = port(texts), ref(texts)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_build_tokenizer_refuses_a_missing_vocab(tmp_path):
    with pytest.raises(FileNotFoundError, match="refusing"):
        tokenizer.build_tokenizer(str(tmp_path / "absent"))
    assert isinstance(tokenizer.build_tokenizer(None, 100, 16).inner, tokenizer.HashTokenizer)


# ----- collate and the pipeline -----


def _pipelines(tiny_data_config, workers, **kw):
    jcfg, cfg = both_configs(tiny_data_config)
    port_ds, ref_ds = dataset.MultiModalDataset(cfg, "train"), jax_dataset.MultiModalDataset(jcfg)
    args = dict(num_ids_per_batch=2, instances_per_id=3, seed=5, steps_per_epoch=3)
    port = pipeline.HostPipeline(
        port_ds, sampler.PKBatchSampler(port_ds, **args), tokenizer.build_tokenizer(None, 100, 16),
        num_workers=workers, seed=11, modality_dropout=0.3, **kw)
    ref = jax_pipeline.HostPipeline(
        ref_ds, jax_sampler.PKBatchSampler(ref_ds, **args),
        jax_tokenizer.build_tokenizer(None, 100, 16), num_workers=0, seed=11,
        modality_dropout=0.3, **{"process_index": 0, "process_count": 1, **kw})
    return port, ref


def test_collate_matches_jax(tiny_data_config):
    jcfg, cfg = both_configs(tiny_data_config)
    port_ds, ref_ds = dataset.MultiModalDataset(cfg), jax_dataset.MultiModalDataset(jcfg)
    rng_p, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    got = pipeline.collate([port_ds.get_sample(i, rng_p) for i in (0, 3, 7, 11)],
                           tokenizer.build_tokenizer(None, 100, 16))
    want = jax_pipeline.collate([ref_ds.get_sample(i, rng_j) for i in (0, 3, 7, 11)],
                                jax_tokenizer.build_tokenizer(None, 100, 16))
    assert_batches_equal(got, want)
    assert got["images"].dtype == np.uint8 and got["images"].shape == (4, 4, 32, 32, 3)


@pytest.mark.parametrize("workers", [0, 2])
def test_host_pipeline_matches_jax_across_epochs(tiny_data_config, workers):
    port, ref = _pipelines(tiny_data_config, workers)
    try:
        assert len(port) == len(ref) == 3
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert_batches_equal(g, w)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("process_index", [0, 1])
def test_host_pipeline_process_slice_matches_jax(tiny_data_config, process_index):
    """2 processes share a global batch of 2 x 3 = 6: 3 rows each; with a
    global batch of 5 (P 5, K 1 in plain P x K mode), process 1's slice of
    3 holds 2 real rows and one padding row (zero masks, label and pid -1)."""
    kw = dict(process_index=process_index, process_count=2)
    port, ref = _pipelines(tiny_data_config, 0, **kw)
    for g, w in zip(list(port), list(ref)):
        assert_batches_equal(g, w)
        assert g["labels"].shape == (3,)
    jcfg, cfg = both_configs(tiny_data_config)
    args = dict(num_ids_per_batch=5, instances_per_id=1, seed=2, steps_per_epoch=2,
                force_modal_pairs=False)
    port_ds, ref_ds = dataset.MultiModalDataset(cfg), jax_dataset.MultiModalDataset(jcfg)
    port = pipeline.HostPipeline(port_ds, sampler.PKBatchSampler(port_ds, **args),
                                 tokenizer.build_tokenizer(None, 100, 16), num_workers=0, **kw)
    ref = jax_pipeline.HostPipeline(ref_ds, jax_sampler.PKBatchSampler(ref_ds, **args),
                                    jax_tokenizer.build_tokenizer(None, 100, 16),
                                    num_workers=0, **kw)
    for g, w in zip(list(port), list(ref)):
        assert_batches_equal(g, w)
        assert g["labels"].shape == (3,)
        if process_index == 1:
            assert g["labels"][-1] == -1 and g["pids"][-1] == -1
            assert g["image_mask"][-1].sum() == 0 and g["text_mask"][-1] == 0


def test_pad_batch_to_matches_jax():
    from prcv2025reid_tpu.parallel.mesh import pad_batch_to as jax_pad

    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 255, (3, 4, 2, 2, 3), dtype=np.uint8),
             "labels": np.arange(3, dtype=np.int32), "pids": np.arange(3, dtype=np.int32) + 7,
             "text_mask": np.ones(3, np.float32)}
    assert_batches_equal(pipeline.pad_batch_to(batch, 5), jax_pad(batch, 5))
    assert pipeline.pad_batch_to(batch, 3) is batch


def test_resolve_num_workers():
    assert pipeline.resolve_num_workers(0) == 0 and pipeline.resolve_num_workers(3) == 3
    assert pipeline.resolve_num_workers(-1) == jax_pipeline.resolve_num_workers(-1) >= 1
    with pytest.raises(ValueError, match="num_workers"):
        TrainingConfig(num_workers=-2)


def test_data_modules_import_no_torch():
    """What a spawn worker imports to unpickle a dataset and run the sampler
    and pipeline: no torch, no JAX."""
    code = (
        "import sys\n"
        "import prcv2025reid_tpu_torch.data.dataset, prcv2025reid_tpu_torch.data.sampler\n"
        "import prcv2025reid_tpu_torch.data.pipeline, prcv2025reid_tpu_torch.data.split\n"
        "import prcv2025reid_tpu_torch.data.augment, prcv2025reid_tpu_torch.data.tokenizer\n"
        "import prcv2025reid_tpu_torch.data.native_image\n"
        "import prcv2025reid_tpu_torch.data.native_tokenizer\n"
        "import prcv2025reid_tpu_torch.utils.synthetic, prcv2025reid_tpu_torch.configs\n"
        "from prcv2025reid_tpu_torch import TrainingConfig\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('torch', 'jax', 'flax', 'prcv2025reid_tpu')]\n"
        "print(repr(bad))\n"
        "from prcv2025reid_tpu_torch import build_model\n"
        "print('torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.split() == ["[]", "True"], out.stdout


def test_native_libraries_build_into_the_port_build_dir(tmp_path):
    """Both libraries land in prcv2025reid_tpu_torch/_build/, never in the
    JAX package's cache (PRCV_NATIVE_CACHE), whatever it is set to."""
    code = (
        "import os\n"
        "from prcv2025reid_tpu_torch.data import native_image, native_tokenizer, native_build\n"
        "print(native_build.cache_dir())\n"
        "print(native_image.build_library())\n"
        "print(native_tokenizer.build_library())\n"
        "print(native_build.build_errors)\n"
    )
    env = {**os.environ, "PRCV_NATIVE_CACHE": str(tmp_path / "jax_cache")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True, env=env)
    build_dir, *libs, errors = out.stdout.splitlines()
    assert Path(build_dir) == ROOT / "prcv2025reid_tpu_torch" / "_build"
    assert not (tmp_path / "jax_cache").exists()
    built = [lib for lib in libs if lib != "None"]
    if len(built) < 2:
        pytest.skip(f"g++ or libjpeg unavailable: {errors}")
    for lib, name in zip(built, ("libimage_decode.so", "libclip_bpe.so")):
        assert Path(lib) == Path(build_dir) / name and Path(lib).is_file()
    assert errors == "{}"


# ----- the device feed, on the CPU -----


def test_prefetch_to_device_on_cpu_yields_the_batches(tiny_data_config, monkeypatch):
    port, _ = _pipelines(tiny_data_config, 0)
    batches = list(port)
    for size in (1, 2, 5):
        got = list(prefetch_to_device(iter(batches), size=size, device="cpu"))
        assert len(got) == len(batches)
        for g, w in zip(got, batches):
            assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in g.values())
            assert_batches_equal({k: t.numpy() for k, t in g.items()}, w)
    with pytest.raises(NotImplementedError, match="Parallel and multi-process"):
        prefetch_to_device(iter(batches), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="Parallel and multi-process"):
        prefetch_to_device(iter(batches), device="cpu", sharding=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(iter(batches))


def test_build_dir_is_the_kernels_build_dir():
    from prcv2025reid_tpu_torch.ops import _kernels

    assert Path(native_build.BUILD_DIR) == _kernels.BUILD_DIR
