"""Cluster eval launcher (counterpart of evals/main_distributed.py;
reference evals/main_distributed.py), the pretrain launcher's rules with
the eval's entry:

    python -m jepa_tpu_torch.evals.main_distributed --fname cfg.yaml --partition <p>
    srun python -m jepa_tpu_torch.evals.main_distributed --fname cfg.yaml

The sbatch script runs one task per GPU (``nodes`` x ``tasks_per_node``
from the config, ``MASTER_PORT`` 37124); in-cluster, each rank joins the
process group from the environment and runs the YAML's ``eval_name``.
"""

from __future__ import annotations

from jepa_tpu_torch.apps import main_distributed as launcher


def _eval(cfg, resume_preempt, device):
    from jepa_tpu_torch.evals.scaffold import main as eval_main

    return eval_main(cfg.get("eval_name"), args_eval=cfg, resume_preempt=resume_preempt,
                     device=device)


def main(argv=None):
    return launcher.main(argv, module="jepa_tpu_torch.evals.main_distributed",
                         job="jepa_torch_eval", port=37124, entry=_eval)


if __name__ == "__main__":
    main()
