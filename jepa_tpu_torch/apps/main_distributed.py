"""Cluster pretrain launcher (counterpart of app/main_distributed.py;
reference app/main_distributed.py):

    python -m jepa_tpu_torch.apps.main_distributed --fname cfg.yaml --partition <p>
    srun python -m jepa_tpu_torch.apps.main_distributed --fname cfg.yaml

One process per GPU, as the reference launches:

  * SLURM (``--partition``): writes an sbatch script with ``--nodes``
    ``nodes``, ``--ntasks-per-node`` and ``--gpus-per-node``
    ``tasks_per_node`` from the config, ``--requeue``, ``MASTER_ADDR`` /
    ``MASTER_PORT``, and an ``srun`` of this module, and submits it;
  * in-cluster (no ``--partition``): joins the process group from the
    environment (``parallel.dist.initialize``: torchrun's, or SLURM's
    ``SLURM_NTASKS`` / ``SLURM_PROCID`` / ``SLURM_LOCALID``) and runs the
    app on ``cuda:<local rank>``; a requeued job (``SLURM_RESTART_COUNT``
    > 0) resumes (``resume_preempt``);
  * batch launch: ``--fname`` may name a YAML list of config paths, each
    submitted as its own job (reference :116-131).

``python -m jepa_tpu_torch.apps.main`` under ``torchrun --nproc_per_node
N`` runs N ranks as well, through torchrun's environment.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import yaml

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={tasks}
#SBATCH --gpus-per-node={tasks}
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={time}
#SBATCH --requeue
{account_line}{partition_line}
export MASTER_ADDR=$(scontrol show hostnames $SLURM_JOB_NODELIST | head -n1)
export MASTER_PORT={port}
srun python -m {module} --fname {config}
"""


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fname", type=str, required=True,
                   help="experiment yaml, or a yaml list of them (batch launch)")
    p.add_argument("--partition", type=str, default=None, help="SLURM partition to submit to")
    p.add_argument("--time", type=int, default=4300, help="time limit (minutes)")
    p.add_argument("--account", type=str, default=None)
    p.add_argument("--devices", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="each rank's device (default: its card)")
    p.add_argument("--backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="process group backend (default: nccl on the card, gloo on the CPU)")
    return p.parse_args(argv)


def expand_configs(fname: str):
    """A config path, or the paths a YAML list names (batch launch)."""
    with open(fname) as f:
        cfg = yaml.safe_load(f)
    return list(cfg) if isinstance(cfg, list) else [fname]


def submit(config: str, args, module: str, job: str, port: int) -> str:
    """Write ``config``'s sbatch script (one task per GPU) and submit it;
    returns the script's path."""
    with open(config) as f:
        cfg = yaml.safe_load(f)
    nodes, tasks = int(cfg.get("nodes", 1)), int(cfg.get("tasks_per_node", 1))
    script = SBATCH_TEMPLATE.format(
        job=job, nodes=nodes, tasks=tasks,
        cpus=int(cfg.get("data", {}).get("num_workers", 12)), time=args.time,
        account_line=f"#SBATCH --account={args.account}\n" if args.account else "",
        partition_line=f"#SBATCH --partition={args.partition}\n" if args.partition else "",
        port=port, module=module, config=config)
    fd, path = tempfile.mkstemp(prefix=f"{job}_", suffix=".sbatch")
    with os.fdopen(fd, "w") as f:
        f.write(script)
    print(f"submitting {config} ({nodes} nodes x {tasks} GPUs)")
    subprocess.run(["sbatch", path], check=True)
    return path


def run_in_cluster(config: str, devices: str = "cuda", backend=None, entry=None):
    """Join the process group, then run ``entry(cfg, resume_preempt,
    device)`` (default: the pretrain app); the group is destroyed after."""
    import torch.distributed as dist

    from jepa_tpu_torch.configs import load_config
    from jepa_tpu_torch.parallel import dist as pdist

    pdist.initialize(backend=backend or (None if devices == "cuda" else "gloo"))
    try:
        cfg = load_config(config)
        resume_preempt = os.environ.get("SLURM_RESTART_COUNT", "0") != "0"
        return (entry or _pretrain)(cfg, resume_preempt, devices)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _pretrain(cfg, resume_preempt, device):
    from jepa_tpu_torch.apps.scaffold import main as app_main

    return app_main(cfg.get("app", "vjepa"), args=cfg, resume_preempt=resume_preempt,
                    device=device)


def main(argv=None, module="jepa_tpu_torch.apps.main_distributed", job="jepa_torch",
         port=37123, entry=None):
    args = parse_args(argv)
    configs = expand_configs(args.fname)
    if args.partition:
        for c in configs:
            submit(c, args, module, job, port)
        return None
    if len(configs) != 1:
        print("batch launch requires --partition", file=sys.stderr)
        sys.exit(1)
    return run_in_cluster(configs[0], args.devices, args.backend, entry)


if __name__ == "__main__":
    main()
