"""The port's command line: fit / validate / predict from a run config
(``deco_tpu/cli.py``).

    python -m deco_tpu_torch.cli fit -c configs_c2i/DeCo_XL_freq.yaml \\
        [--device cuda|cpu] [--max_steps N] [--workdir D] [--resume] \\
        [--ckpt_path D/checkpoints] [--a.b.c=value ...]
    python -m deco_tpu_torch.cli predict -c configs_c2i/DeCo_XL.yaml \\
        --ckpt_path D/checkpoints [--max_batches N]

The reference configs under ``configs_c2i/`` and ``configs_t2i/`` drive it
unchanged (``predict -c configs_t2i/sft_res512.yaml`` writes the DPG-Bench
images, ``validate`` the GenEval ones); their
class paths resolve through ``config.registry``. ``--key=value`` overrides a
config entry by its dotted path. ``--device`` defaults to ``cuda`` and
raises where there is no card; ``--device cpu`` runs the plain PyTorch
versions of the kernels. The VAE-GAN configs (``configs/vae_*.yaml``) and
the DC-AE decoder eval (``configs_flow/dcae_decoder_eval.yaml``) route to
``train/workloads.py``: ``fit`` trains, ``validate`` and ``predict``
score reconstructions; so do the UniFlow configs
(``configs_flow/uniflow_*.yaml``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional

from deco_tpu_torch.config import registry


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v.lower() in ("null", "none"):
        return None
    return v


def parse_overrides(tokens) -> Dict[str, Any]:
    """``--a.b.c=value`` tokens as {dotted path: value}; others raise."""
    overrides = {}
    for tok in tokens:
        if not (tok.startswith("--") and "=" in tok):
            raise SystemExit(f"unrecognized argument: {tok}")
        k, v = tok[2:].split("=", 1)
        overrides[k] = _parse_value(v)
    return overrides


def build_parser():
    p = argparse.ArgumentParser(prog="deco_tpu_torch")
    p.add_argument("subcommand", choices=["fit", "validate", "predict"])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def detect_workload(config: Dict[str, Any]) -> str:
    """The workload a config selects (``deco_tpu/train/workloads.py``)."""
    m = config.get("model", {}) or {}
    if "config_path" in m or "vit_hidden_size" in m:
        return "uniflow"
    if ("vae_model" in m and "loss_module" in m) or ("discriminator" in config and "loss" in config):
        return "vae_gan"
    if "vae_weight_path" in m or "decoder_checkpoint_path" in m:
        return "dcae_eval"
    return "diffusion"


def main(argv: Optional[list] = None):
    argv = argv if argv is not None else sys.argv[1:]
    known, unknown = build_parser().parse_known_args(argv)
    config = registry.load_yaml(known.config)
    registry.apply_overrides(config, parse_overrides(unknown))
    kind = detect_workload(config)
    if kind in ("uniflow", "vae_gan", "dcae_eval"):
        from deco_tpu_torch.train import workloads

        if kind == "uniflow":
            return workloads.run_uniflow(
                config, max_steps=known.max_steps, workdir=known.workdir,
                ckpt_path=known.ckpt_path, max_batches=known.max_batches, device=known.device,
                subcommand="fit" if known.subcommand == "fit" else "validate")
        if kind == "dcae_eval":
            return workloads.run_dcae_eval(config, max_batches=known.max_batches,
                                           device=known.device)
        return workloads.run_vae_gan(
            config, max_steps=known.max_steps, workdir=known.workdir,
            ckpt_path=known.ckpt_path, max_batches=known.max_batches, device=known.device,
            subcommand="fit" if known.subcommand == "fit" else "validate")

    from deco_tpu_torch.train.loop import Experiment

    resume = known.resume or known.ckpt_path is not None
    exp = Experiment(config, workdir=known.workdir, resume=resume, device=known.device)
    if known.subcommand == "fit":
        return exp.fit(ckpt_path=known.ckpt_path, max_steps=known.max_steps)
    dataset_key = "eval_dataset" if known.subcommand == "validate" else "pred_dataset"
    return exp.predict(ckpt_path=known.ckpt_path, max_batches=known.max_batches,
                       dataset_key=dataset_key)


if __name__ == "__main__":
    main()
