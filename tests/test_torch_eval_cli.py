"""The port's evaluation command lines on the CPU: ``tools_torch/
eval_mm_protocol.py`` on a checkpoint written by the port's
``save_checkpoint`` that holds the flat parameters the JAX side loads
(``tests/test_torch_dataset_eval.py``'s fixtures, the conftest tree): its
JSON equals JAX's ``evaluate_protocol`` on the same parameters key for key
to 1e-5; ``--rerank`` adds ``mAP_plain``; ``--submission`` and
``generate_submission.py --out`` write the same CSV; the multi-process
flags and an override the checkpoint's config cannot run raise; and
``tools_torch/split.py`` prints and writes what ``tools/split.py`` does."""
import importlib.util
import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_dataset_eval import (  # noqa: E402,F401 (fixtures)
    NUM_CLASSES,
    _assert_metrics_close,
    datasets,
    flat_params,
    jax_side,
    jcfg,
    port_config,
    port_model,
    tokenizers,
)

from prcv2025reid_tpu.evaluation import protocol as jax_protocol  # noqa: E402
from prcv2025reid_tpu_torch import init_train_state  # noqa: E402
from prcv2025reid_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BATCH = 5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def cli():
    return _load("port_eval_mm_protocol", "tools_torch/eval_mm_protocol.py")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, jcfg, port_model):
    """<dir>/best: the port's checkpoint of the fixture's parameters."""
    directory = tmp_path_factory.mktemp("ckpt")
    config = port_model.config
    state = init_train_state(port_model, config, steps_per_epoch=3, seed=1).replace(step=6)
    save_checkpoint(str(directory), port_model, state,
                    {"epoch": 2, "best_map": 0.0, "num_classes": NUM_CLASSES,
                     "config": config.to_json()}, name="best")
    return str(directory / "best")


def run(cli, argv):
    """(the returned result, the JSON it printed)."""
    out = io.StringIO()
    with redirect_stdout(out):
        result = cli.main(argv, device="cpu")
    return result, json.loads(out.getvalue())


def _argv(jcfg, checkpoint, tmp_path, *extra):
    return [f"--dataset_root={jcfg.data_root}", f"--model_path={checkpoint}/",
            f"--cache_dir={tmp_path / 'cache'}", f"--batch_size={BATCH}", *extra]


@pytest.mark.parametrize("exclude", [True, False])
def test_json_equals_jax_evaluate_protocol(exclude, cli, checkpoint, jcfg, datasets, tokenizers,
                                           jax_side, tmp_path):
    _, jds = datasets
    _, variables, factory = jax_side
    extra = [] if exclude else ["--no-exclude_same_image"]
    result, printed = run(cli, _argv(jcfg, checkpoint, tmp_path, "--sample_ratio=0.5", *extra))
    want = jax_protocol.evaluate_protocol(
        None, variables, jds, tokenizers[1], batch_size=BATCH, exclude_same_image=exclude,
        sample_ratio=0.5, seed=jcfg.seed, embed_factory=factory)
    assert printed.keys() == want.keys() and len(printed["detail"]) == 15
    _assert_metrics_close(printed, want)
    _assert_metrics_close(result, want)
    # the cache tag names the epoch, the step and the weights: a second run hits
    files = os.listdir(tmp_path / "cache")
    assert len(files) == 1 and files[0].startswith("gallery_standalone_ep2_st6_")
    assert run(cli, _argv(jcfg, checkpoint, tmp_path, "--sample_ratio=0.5", *extra))[1] == printed


def test_rerank_adds_map_plain_and_weighted_tags_the_cache(cli, checkpoint, jcfg, tmp_path):
    _, plain = run(cli, _argv(jcfg, checkpoint, tmp_path))
    _, rr = run(cli, _argv(jcfg, checkpoint, tmp_path, "--rerank", "--rerank_top_n=8",
                           "--rerank_k1=4", "--rerank_k2=2"))
    for name, d in rr["detail"].items():
        assert d["mAP_plain"] == plain["detail"][name]["mAP"]
        assert 0.0 <= d["mAP"] <= 1.0
    _, weighted = run(cli, _argv(jcfg, checkpoint, tmp_path, "--fusion_mode=weighted"))
    tags = sorted(os.listdir(tmp_path / "cache"))
    assert len(tags) == 2 and sum("_w_" in t for t in tags) == 1
    # the singles go through the model's fusion in both modes, the others not
    singles = [n for n in plain["detail"] if n.startswith("single/")]
    assert all(weighted["detail"][n] == plain["detail"][n] for n in singles)
    assert any(weighted["detail"][n] != plain["detail"][n] for n in plain["detail"]
               if n not in singles)


def test_submission_and_generate_submission_write_the_same_csv(cli, checkpoint, jcfg, tmp_path,
                                                              datasets):
    ds, _ = datasets
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    run(cli, _argv(jcfg, checkpoint, tmp_path, f"--submission={a}", "--topk=5"))
    gen = _load("port_generate_submission", "tools_torch/generate_submission.py")
    with redirect_stdout(io.StringIO()):
        gen.main(_argv(jcfg, checkpoint, tmp_path, "--out", str(b), "--topk=5"), device="cpu")
    assert a.read_bytes() == b.read_bytes()
    rows = a.read_text().splitlines()
    assert rows[0] == "query_key,ranked_gallery_ids" and len(rows) == 1 + 15 * len(ds)
    assert all(len(set(r.split(",")[1].split())) == 5 for r in rows[1:])


@pytest.mark.parametrize("flag", ["--distributed=on", "--distributed=auto", "--num_processes=2",
                                  "--process_id=0", "--coordinator_address=localhost:1234"])
def test_multi_process_flags_raise(flag, cli, checkpoint, jcfg, tmp_path):
    with pytest.raises(NotImplementedError, match="Parallel and multi-process"):
        cli.main(_argv(jcfg, checkpoint, tmp_path, flag), device="cpu")


@pytest.mark.parametrize("override", ["--block_impl=fused", "--token_keep=2"])
def test_override_the_fused_stream_trunk_cannot_run_raises(override, cli, checkpoint, jcfg,
                                                           tmp_path):
    """JAX runs a use_fused_resln checkpoint without these overrides while
    its cache tag names them; the port refuses."""
    fused = tmp_path / "fused"
    shutil.copytree(checkpoint, fused)
    with open(fused / "host_state.json") as f:
        host = json.load(f)
    config = json.loads(host["config"])
    config["use_fused_resln"] = True
    config["token_reduce_layer"] = 1  # inside the two blocks: only the trunk conflicts
    host["config"] = json.dumps(config)
    with open(fused / "host_state.json", "w") as f:
        json.dump(host, f)
    with pytest.raises(ValueError, match="use_fused_resln=True conflicts"):
        cli.main(_argv(jcfg, str(fused), tmp_path, override), device="cpu")


def test_token_keep_override_on_a_token_reduce_trained_checkpoint(cli, jcfg, port_model,
                                                                  tmp_path):
    """--token_keep=0 on a checkpoint trained with token reduction clears
    token_reduce_train; each path gets its own cache tag."""
    config = port_config(jcfg, token_keep=2, token_reduce_layer=1, token_reduce_train=True)
    state = init_train_state(port_model, config, steps_per_epoch=3)
    save_checkpoint(str(tmp_path), port_model, state,
                    {"epoch": 1, "best_map": 0.0, "num_classes": NUM_CLASSES,
                     "config": config.to_json()}, name="tr")
    argv = _argv(jcfg, str(tmp_path / "tr"), tmp_path, "--sample_ratio=0.3")
    _, reduced = run(cli, argv)
    _, full = run(cli, argv + ["--token_keep=0"])
    tags = sorted(os.listdir(tmp_path / "cache"))
    assert len(tags) == 2 and sum("token_keep=2" in t for t in tags) == 1
    assert reduced["detail"].keys() == full["detail"].keys()


def test_split_cli_matches_jax(jcfg, tmp_path):
    port = _load("port_split", "tools_torch/split.py")
    jax_tool = _load("jax_split", "tools/split.py")
    outs = []
    for tool, name in ((port, "port.json"), (jax_tool, "jax.json")):
        buf = io.StringIO()
        argv = [f"--data_root={jcfg.data_root}", "--val_ratio=0.34", "--seed=5",
                f"--out={tmp_path / name}"]
        with redirect_stdout(buf):
            result = tool.main(argv)
        outs.append((result, buf.getvalue(), (tmp_path / name).read_text()))
    assert outs[0] == outs[1]
    assert json.loads(outs[0][1]) == {"num_ids": 6, "train_ids": 4, "val_ids": 2, "seed": 5,
                                      "val_ratio": 0.34}
