"""Eval dispatch: config key ``eval_name: <name>`` ->
jepa_tpu_torch.evals.<name>.main (counterpart of jepa_tpu/evals/scaffold.py;
reference evals/scaffold.py:16-24)."""

from __future__ import annotations

import importlib
import logging

logger = logging.getLogger(__name__)


def main(eval_name: str, args_eval: dict, resume_preempt: bool = False, device="cuda"):
    logger.info("running evaluation: %s", eval_name)
    mod = importlib.import_module(f"jepa_tpu_torch.evals.{eval_name}")
    return mod.main(args_eval=args_eval, resume_preempt=resume_preempt, device=device)
