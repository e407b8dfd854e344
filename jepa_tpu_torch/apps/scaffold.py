"""App dispatch: config key ``app: <name>`` ->
jepa_tpu_torch.apps.<name>.train.main (counterpart of
jepa_tpu/apps/scaffold.py; reference app/scaffold.py:16-21)."""

from __future__ import annotations

import importlib
import logging

logger = logging.getLogger(__name__)


def main(app: str, args: dict, resume_preempt: bool = False, device="cuda"):
    logger.info("running pretraining of app: %s", app)
    mod = importlib.import_module(f"jepa_tpu_torch.apps.{app}.train")
    return mod.main(args=args, resume_preempt=resume_preempt, device=device)
