"""Run one of the paper's shapes recipes through the training entry point.

    python -m generative_turbulence_tpu_torch.scripts.run_shapes \\
        {diffusion-r4,diffusion-r5,tfnet,dilresnet,diffusion} [--device cuda] [key=value ...]

Port of ``scripts/run-shapes-{diffusion-r4,diffusion-r5,tfnet,dilresnet}.sh``.
Each recipe is the argument list its JAX script hands ``scripts/train.py``,
here handed to the port's ``train.main``, with the caller's overrides after
it, as the scripts' ``"$@"``:

- ``diffusion-r4`` and ``diffusion-r5``: the two scripts' overrides.  The
  45-shape mock dataset (``data/shapes-mock``), bf16 + remat training at an
  effective batch of 6 in micro-batches of 3 (``model.accumulate_steps=2``;
  ``model.batch_size`` is the effective batch), training frames rounded to
  bf16 (``data.device_cache_gb=2``: on the card nothing is kept resident,
  the key gives the frames the dtype and order JAX's device cache gives
  them), EMA 0.999 with warm-up, and an in-run monitor of DDIM-50 in f32
  with the samples' x0 clipped to the training envelope; r4 runs 40 epochs
  under 210 minutes with a validation and a checkpoint every 4 epochs, r5
  60 epochs under 220 minutes, every 5.  ``trainer.max_steps`` counts
  micro-steps (Trainer steps), so 2 optimizer updates are 4 of them.
- ``tfnet`` and ``dilresnet``: ``config=`` the package's
  ``configs/shapes_{tfnet,dilresnet}.json``, the mapping that ``load_config``
  makes of the JAX package's ``config/shapes_*.yaml`` (PyYAML is not needed:
  the card has none).
- ``diffusion``: ``config=configs/shapes_diffusion.json``, the paper's
  diffusion config, which has no script in the JAX package.

The YAML files' comments, as they stand for the port: the epochs, the eval
batch of 1 and the validation every 5 (TF-Net) or 2 (DilResNet) epochs are
the mock-scale adaptations of the reference's protocol (48 frames per case
against ~4,750); TF-Net's ``batch_size: 2`` with ``accumulate_steps: 3``
trains micro-batches of 1, an effective batch of 3, not the 6 its comment
names (the factory divides, as JAX's does); ``device_cache_gb: 3`` rounds
the training windows to bf16 and ``eval_device_cache_gb`` changes nothing.
Their notes on the v5e's 16 GB of HBM are no guide to the H100.

Relative paths (``data.root``, ``trainer.out_dir``) stay relative to the
working directory: the scripts' ``cd`` to the repository is not copied, nor
their ``mkdir`` (the Trainer makes its directory).  The run is on the GPU
unless ``--device`` says otherwise.  ``main(argv)`` returns the final
monitor score, as ``train.main`` does.
"""

from __future__ import annotations

import argparse
from pathlib import Path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _diffusion_round(max_epochs: int, every: int, out_dir: str, train_limit: str) -> list:
    """``scripts/run-shapes-diffusion-r{4,5}.sh``'s overrides."""
    return [
        "model=diffusion", "data.root=data/shapes-mock", "data.device_cache_gb=2", "model.batch_size=6",
        "model.accumulate_steps=2", "model.eval_batch_size=6", "data.eval_batch_size=6",
        "model.compute_dtype=bfloat16", "model.eval_compute_dtype=float32", "model.ema_decay=0.999",
        "model.sampler=ddim", "model.ddim_steps=50", "model.clip_denoised=true", "model.clip_mode=envelope",
        f"trainer.max_epochs={max_epochs}", f"trainer.check_val_every_n_epoch={every}",
        f"trainer.checkpoint_every_n_epochs={every}", f"trainer.out_dir={out_dir}",
        f"trainer.train_limit={train_limit}",
    ]


RECIPES = {
    "diffusion-r4": _diffusion_round(40, 4, "runs/shapes-diffusion-r4", "210m"),
    "diffusion-r5": _diffusion_round(60, 5, "runs/shapes-diffusion-r5", "220m"),
    "tfnet": [f"config={CONFIGS / 'shapes_tfnet.json'}"],
    "dilresnet": [f"config={CONFIGS / 'shapes_dilresnet.json'}"],
    "diffusion": [f"config={CONFIGS / 'shapes_diffusion.json'}"],
}


def recipe_argv(name: str, overrides=()) -> list:
    """The training entry point's overrides for recipe ``name``, the
    caller's last."""
    return [*RECIPES[name], *overrides]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("recipe", choices=sorted(RECIPES))
    ap.add_argument("--device", default="cuda", help="torch device of the run (default: cuda)")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides, applied after the recipe's")
    args = ap.parse_intermixed_args(argv)

    from .. import train

    return train.main(["--device", args.device, *recipe_argv(args.recipe, args.overrides)])


if __name__ == "__main__":
    main()
