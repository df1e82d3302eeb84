"""Train a model: ``python -m generative_turbulence_tpu_torch.train [--device cpu] key=value ...``

The port's counterpart of ``scripts/train.py``: hydra-style overrides over
the typed config (``training/config.py``), then ``instantiate_data_and_task``
and ``Trainer.fit``.  It writes ``<out_dir>/metrics.jsonl``,
``<out_dir>/summary.json`` and ``<out_dir>/checkpoints/`` (``last.pt``,
``best.pt``, ``config.json``) and prints ``final <monitor>: <score>``.
Examples:

    python -m generative_turbulence_tpu_torch.train model=diffusion \\
        data.root=data/shapes trainer.out_dir=runs/diff model.compute_dtype=bfloat16
    python -m generative_turbulence_tpu_torch.train model=dilresnet \\
        data.root=data/shapes data.discard_first_seconds=-1
    python -m generative_turbulence_tpu_torch.train --device cpu model=tfnet data.root=...

The run is on the GPU (``cuda``) unless ``--device`` names another device;
without a GPU it stops rather than train on the CPU.  ``config=<file>.yaml``
needs PyYAML; overrides need nothing beyond the package.

Multi-process runs, one process per rank (``parallel/distributed.py``):

    GT_DISTRIBUTED=1 python -m torch.distributed.run --nproc-per-node 4 \
        -m generative_turbulence_tpu_torch.train model=diffusion data.root=...
    GT_DIST_NUM_PROCESSES=2 GT_DIST_PROCESS_ID=<r> GT_DIST_COORDINATOR=host:port \
        python -m generative_turbulence_tpu_torch.train ...

``--device cuda`` is then each rank's own card (NCCL), or the card the
host's ranks share (gloo); ``--device cpu`` runs the ranks over gloo.  The
ranks are data parallel unless ``trainer.mesh_shape=[dp,sp]`` (dp x sp =
the world size) shards each grid's x over groups of sp ranks
(``parallel/mesh.py``, ``parallel/spatial.py``).

``trainer.matmul_precision`` maps onto TF32:
``default`` leaves torch's settings as they are, ``high`` allows TF32 in
matmuls and cuDNN convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` true), ``highest`` forbids it (both
false).
"""

from __future__ import annotations

import argparse
import faulthandler
import sys

from .utils.exceptions import print_exceptions

_TF32 = {"high": True, "highest": False}


def set_matmul_precision(precision: str) -> None:
    """``trainer.matmul_precision`` as torch's TF32 switches."""
    import torch

    if precision == "default":
        return
    if precision not in _TF32:
        raise ValueError(f"Unknown matmul precision {precision!r}; options: default, high, highest")
    torch.backends.cuda.matmul.allow_tf32 = _TF32[precision]
    torch.backends.cudnn.allow_tf32 = _TF32[precision]


def resolve_device(name: str):
    """The torch device of a run (``cuda``: the current card, the rank's in
    a distributed run); a CUDA device where there is none stops the run
    rather than let it fall back to the CPU."""
    import torch

    from .data.dataset import pinned_device

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False (pass --device cpu to run on the CPU)")
    return pinned_device(device)


@print_exceptions
def main(argv=None):
    import torch

    from .parallel.distributed import initialize_distributed
    from .parallel.mesh import init_mesh
    from .training.config import parse_cli_overrides
    from .training.factory import instantiate_data_and_task
    from .training.loop import Trainer

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device of the run (default: cuda)")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = parser.parse_intermixed_args(argv)
    # The process group (a no-op in a single-process run) comes first: it
    # picks the rank's card.
    initialize_distributed(args.device)
    device = resolve_device(args.device)

    try:
        config = parse_cli_overrides(args.overrides).resolved()
    except ModuleNotFoundError as e:
        raise RuntimeError(f"config files need the {e.name!r} module, which is not installed; "
                           "give the settings as key=value overrides") from e
    set_matmul_precision(config.trainer.matmul_precision)
    # The mesh's groups come before the data: its dp index keys the shards.
    init_mesh(config.trainer.mesh_shape)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    print(f"device: {name}", file=sys.stderr)
    dm, task = instantiate_data_and_task(config, device)
    trainer = Trainer(config, task, dm)
    metrics = trainer.fit()
    trainer.logger.close()

    monitor = task.monitor
    score = metrics.get(monitor)
    print(f"final {monitor}: {score}", file=sys.stderr)
    return score


if __name__ == "__main__":
    faulthandler.enable()
    try:  # SIGUSR1 dumps every thread's stack without ending the run
        import signal

        faulthandler.register(signal.SIGUSR1)
    except (AttributeError, ValueError):
        pass
    main()
