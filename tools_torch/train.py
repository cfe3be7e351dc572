#!/usr/bin/env python3
"""Training entry point of the PyTorch port (the counterpart of the root
``train.py``, which stays the JAX package's entry point).

    python3 tools_torch/train.py [--model_preset=NAME] [--key=value ...]

Every ``TrainingConfig`` field is overridable, e.g.:

    python3 tools_torch/train.py --data_root=/data/orbench \\
        --json_file=/data/orbench/text_annos.json --num_epochs=60 \\
        --use_pallas_attention=true --use_fused_mlp=true --use_fused_resln=true

It trains on the CUDA card (there is no CPU fallback; ``main(argv,
device="cpu")`` runs the plain versions on the CPU) and leaves what the
JAX entry point leaves: ``<save_dir>/latest/``, ``<save_dir>/best/`` (or
``best_model_path``) and ``<save_dir>/epoch_{n}/`` checkpoints (``state.pt``
+ ``host_state.json``), ``<log_dir>/train_history.csv``,
``eval_history.csv``, ``training.log`` and ``tb/`` (with tensorboardX), and
gallery features under ``eval_cache_dir``.  A run whose ``save_dir`` holds
a ``latest/`` checkpoint resumes after its epoch.

Data parallel over N processes, one device each: launch N copies with
``--distributed=on --num_processes=N --process_id=R
--coordinator_address=host:port`` (R = 0 .. N-1; process 0 serves the
rendezvous at host:port), or under ``torchrun`` with ``--distributed=auto``.
The backend is NCCL on CUDA (one card a process) and gloo on the CPU;
``--dist_backend=gloo`` runs processes that share one card.  Every process
trains the global batch's step on its slice; only process 0 writes
``training.log``, the histories and the checkpoints.
"""
from __future__ import annotations

import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, device="cuda"):
    from prcv2025reid_tpu_torch.configs import (
        TrainingConfig,
        apply_cli_overrides,
        apply_model_preset,
    )
    from prcv2025reid_tpu_torch.training import trainer as trainer_module
    from prcv2025reid_tpu_torch.utils.distributed import (
        initialize_from_config,
        is_main_process,
        process_count,
        process_index,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    config = TrainingConfig()
    backend = None
    for arg in list(argv):
        if arg.startswith("--model_preset="):
            config = apply_model_preset(config, arg.split("=", 1)[1])
            argv.remove(arg)
        elif arg.startswith("--dist_backend="):
            backend = arg.split("=", 1)[1]
            argv.remove(arg)
    config = apply_cli_overrides(config, argv)
    # the process group before any device use (NCCL pins this process's card)
    initialize_from_config(config, backend=backend)

    os.makedirs(config.log_dir, exist_ok=True)
    # the console as configured, or a stream handler; training.log for this
    # run's log_dir (process 0's only: log_dir may be shared storage),
    # detached again at the end (a second run in the same process writes
    # its own)
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.INFO)
    log_file = None
    if is_main_process():
        log_file = logging.FileHandler(os.path.join(config.log_dir, "training.log"))
        log_file.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(log_file)
    logging.info("process %d of %d", process_index(), process_count())
    try:
        result = trainer_module.Trainer(config, device=device).fit()
        logging.info("training done: %s", json.dumps(result, default=float))
        return result
    finally:
        if log_file is not None:
            root.removeHandler(log_file)
            log_file.close()
        root.setLevel(level)


if __name__ == "__main__":
    main()
