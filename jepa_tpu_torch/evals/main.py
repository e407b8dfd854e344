"""Eval launcher (counterpart of evals/main.py):

    python -m jepa_tpu_torch.evals.main --fname configs/evals/vitl16_k400_16x8x3.yaml
    python -m jepa_tpu_torch.evals.main --fname <tiny eval yaml> --devices cpu

The YAML's ``eval_name`` picks video_classification_frozen or
image_classification_frozen. One process drives one device: the card by
default (a missing GPU raises), the CPU when ``--devices cpu`` asks for it;
under ``torchrun --nproc_per_node N`` it runs as N ranks.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fname", type=str, required=True, help="eval yaml")
    p.add_argument("--devices", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="the device to evaluate on (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from jepa_tpu_torch.configs import load_config
    from jepa_tpu_torch.evals.scaffold import main as eval_main
    from jepa_tpu_torch.utils.logging import get_logger

    cfg = load_config(args.fname)
    get_logger(rank=0).info("loaded eval config %s", args.fname)
    return eval_main(cfg.get("eval_name"), args_eval=cfg, device=args.devices)


if __name__ == "__main__":
    main()
