"""Pretrain launcher (counterpart of app/main.py):

    python -m jepa_tpu_torch.apps.main --fname configs/pretrain/vitl16.yaml
    python -m jepa_tpu_torch.apps.main --fname tests/fixtures/pretrain_smoke.yaml --devices cpu

One process drives one device: the card by default (a missing GPU raises),
the CPU when ``--devices cpu`` asks for it. Under ``torchrun
--nproc_per_node N`` the app runs as N ranks (``parallel.dist``: torchrun's
environment), each on ``cuda:<local rank>``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fname", type=str, required=True, help="experiment yaml")
    p.add_argument("--devices", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="the device to train on (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from jepa_tpu_torch.apps.scaffold import main as app_main
    from jepa_tpu_torch.configs import load_config
    from jepa_tpu_torch.utils.logging import get_logger

    cfg = load_config(args.fname)
    logger = get_logger(rank=0)
    logger.info("loaded config %s", args.fname)
    return app_main(cfg.get("app", "vjepa"), args=cfg, device=args.devices)


if __name__ == "__main__":
    main()
