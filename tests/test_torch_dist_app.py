"""The port's entry points as 2 gloo ranks on the CPU: the pretrain app
through jepa_tpu_torch.apps.main_distributed's in-cluster mode (the
SLURM environment of two one-GPU nodes; fixed mode, then a resume), the
padded mode through jepa_tpu_torch.apps.main under torchrun's
environment, and the video eval through jepa_tpu_torch.evals.main_distributed;
and the sbatch scripts both launchers submit, with ``subprocess.run``
replaced. Ranks are processes spawned by ``parallel.dist.run_local_ranks``
(tests/torch_dist_ranks.py), each joining the group from the environment
it is given over 127.0.0.1; tests/fixtures/pretrain_smoke.yaml (vit_tiny,
synthetic video) at batch 1 per rank.
"""

import os
import socket
import subprocess
import tempfile

import numpy as np
import pytest
import torch
import yaml

from jepa_tpu_torch.apps import main_distributed as app_launcher
from jepa_tpu_torch.evals import main_distributed as eval_launcher
from jepa_tpu_torch.models.factory import vit_cfg
from jepa_tpu_torch.models.vit import init_vit
from jepa_tpu_torch.parallel import dist as pdist
from tests import torch_dist_ranks as ranks

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_REPO, "tests", "fixtures", "pretrain_smoke.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _slurm_env(world, restart=0):
    port = _free_port()
    return [dict(SLURM_NTASKS=world, SLURM_PROCID=r, SLURM_LOCALID=0, MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port, SLURM_RESTART_COUNT=restart) for r in range(world)]


def _torchrun_env(world):
    port = _free_port()
    return [dict(RANK=r, WORLD_SIZE=world, LOCAL_RANK=r, MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port) for r in range(world)]


def _run(fn, world, args, env):
    out = pdist.run_local_ranks(fn, world, args, init_group=False, env=env, timeout=240)
    assert not any(r["jax_imported"] for r in out), "a spawned rank imported jax"
    return [r["result"] for r in out]


def _losses(path):
    rows = open(path).read().strip().splitlines()
    return [r.split(",")[2] for r in rows if r[0].isdigit()]


@pytest.fixture()
def smoke_cfg(tmp_path):
    with open(_FIXTURE) as f:
        cfg = yaml.safe_load(f)
    cfg["logging"]["folder"] = str(tmp_path / "run")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, path


def test_two_rank_app_in_cluster_mode_and_resume(smoke_cfg):
    """2 epochs x ipe 3 on 2 ranks: rank 0 alone writes the checkpoint
    (once an epoch), each rank its CSV with the same (global) losses, and
    both end with the same parameters; a requeued run (SLURM_RESTART_COUNT
    1) to 3 epochs resumes from that checkpoint at step 6."""
    cfg, path = smoke_cfg
    argv = ["--fname", str(path), "--devices", "cpu"]
    out = _run(ranks.app_rank, 2, (argv,), _slurm_env(2))
    folder = cfg["logging"]["folder"]
    assert [r["step"] for r in out] == [6, 6]
    assert len(out[0]["writes"]) == 2 and out[1]["writes"] == []
    assert torch.equal(out[0]["qkv"], out[1]["qkv"])
    losses = [_losses(os.path.join(folder, f"smoke_r{r}.csv")) for r in range(2)]
    assert len(losses[0]) == 6 and losses[0] == losses[1]
    saved = torch.load(os.path.join(folder, "smoke-latest.pth.tar"), weights_only=True)
    assert saved["world_size"] == 2 and saved["opt"]["step"] == 6
    assert torch.equal(saved["encoder"]["blocks.0.attn.qkv.weight"], out[0]["qkv"])

    cfg["optimization"]["epochs"] = 3
    path.write_text(yaml.safe_dump(cfg))
    out = _run(ranks.app_rank, 2, (argv,), _slurm_env(2, restart=1))
    assert [r["step"] for r in out] == [9, 9]
    assert len(out[0]["writes"]) == 1 and out[1]["writes"] == []
    losses = [_losses(os.path.join(folder, f"smoke_r{r}.csv")) for r in range(2)]
    assert len(losses[0]) == 9 and losses[0] == losses[1]


def test_two_rank_padded_app_under_torchrun_env(smoke_cfg):
    """The padded mode through apps.main with torchrun's variables: every
    rank collates both chunks and keeps its own; the ranks log one loss."""
    cfg, path = smoke_cfg
    cfg["meta"]["mask_mode"] = "padded"
    cfg["optimization"]["epochs"] = 1
    path.write_text(yaml.safe_dump(cfg))
    out = _run(ranks.cli_rank, 2, (["--fname", str(path), "--devices", "cpu"],),
               _torchrun_env(2))
    assert [r["step"] for r in out] == [3, 3]
    assert torch.equal(out[0]["qkv"], out[1]["qkv"])
    losses = [_losses(os.path.join(cfg["logging"]["folder"], f"smoke_r{r}.csv"))
              for r in range(2)]
    assert len(losses[0]) == 3 and losses[0] == losses[1]
    assert all(np.isfinite(float(x)) for x in losses[0])


def test_two_rank_video_eval_in_cluster_mode(tmp_path):
    """The video eval on 2 ranks: 3 val videos at batch 2 per rank (the
    sampler's wrap-around repeat weighted 0); rank 0 alone writes
    the probe checkpoint, each rank its CSV, and both report the same val
    accuracy."""
    enc = tmp_path / "enc.pth.tar"
    geo = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, uniform_power=True)
    torch.save({"target_encoder": init_vit(vit_cfg("vit_tiny", **geo),
                                           torch.Generator().manual_seed(0)).state_dict()}, enc)
    for split, n in (("train", 4), ("val", 3)):
        (tmp_path / f"{split}.csv").write_text(
            "".join(f"synthetic://{split}{i} {i % 3}\n" for i in range(n)))
    cfg = {"eval_name": "video_classification_frozen", "tag": "dp",
           "pretrain": {"model_name": "vit_tiny", "checkpoint_key": "target_encoder",
                        "folder": str(tmp_path), "checkpoint": str(enc), "write_tag": "probe",
                        "patch_size": 16, "tubelet_size": 2, "frames_per_clip": 4,
                        "frame_step": 2, "uniform_power": True},
           "data": {"dataset_train": str(tmp_path / "train.csv"),
                    "dataset_val": str(tmp_path / "val.csv"), "num_classes": 3,
                    "frames_per_clip": 4, "num_segments": 2, "num_views_per_segment": 1,
                    "decode_backend": "synthetic", "num_workers": 1},
           "optimization": {"batch_size": 2, "num_epochs": 1, "weight_decay": 0.01,
                            "lr": 0.005, "start_lr": 0.001, "final_lr": 0.0005,
                            "warmup": 0.5, "use_bfloat16": False, "resolution": 32,
                            "attend_across_segments": True}}
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = _run(ranks.eval_rank, 2, (["--fname", str(path), "--devices", "cpu"],),
               _slurm_env(2))
    assert out[0]["accs"] == out[1]["accs"] and len(out[0]["accs"]) == 1
    assert len(out[0]["writes"]) == 1 and out[1]["writes"] == []
    folder = tmp_path / "video_classification_frozen" / "dp"
    saved = torch.load(folder / "probe-latest.pth.tar", weights_only=True)
    assert saved["opt"]["step"] == 1  # 4 train videos = 2 ranks x 1 batch of 2
    for r in range(2):
        assert (folder / f"probe_r{r}.csv").exists()


@pytest.mark.parametrize("which", ["app", "eval"])
def test_launchers_write_one_task_per_gpu(tmp_path, monkeypatch, which):
    """--partition writes an sbatch script with the config's nodes and
    tasks_per_node as tasks and GPUs per node, --requeue, the master
    address and port and an srun of the launcher, and submits it; a YAML
    list submits each config (batch launch), which without --partition
    exits non-zero."""
    submitted = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, check: submitted.append(open(cmd[1]).read()))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfgs = []
    for i, (nodes, tasks) in enumerate(((16, 8), (2, 4))):
        p = tmp_path / f"c{i}.yaml"
        p.write_text(yaml.safe_dump({"nodes": nodes, "tasks_per_node": tasks,
                                     "data": {"num_workers": 6}}))
        cfgs.append(str(p))
    batch = tmp_path / "batch.yaml"
    batch.write_text(yaml.safe_dump(cfgs))
    launcher = app_launcher if which == "app" else eval_launcher
    module = f"jepa_tpu_torch.{'apps' if which == 'app' else 'evals'}.main_distributed"
    launcher.main(["--fname", cfgs[0], "--partition", "gpu", "--account", "acct",
                   "--time", "60"])
    launcher.main(["--fname", str(batch), "--partition", "gpu"])
    assert len(submitted) == 3
    script = submitted[0]
    for line in ("#SBATCH --nodes=16", "#SBATCH --ntasks-per-node=8",
                 "#SBATCH --gpus-per-node=8", "#SBATCH --cpus-per-task=6",
                 "#SBATCH --time=60", "#SBATCH --requeue", "#SBATCH --account=acct",
                 "#SBATCH --partition=gpu",
                 "export MASTER_ADDR=$(scontrol show hostnames $SLURM_JOB_NODELIST | head -n1)",
                 f"export MASTER_PORT={37123 if which == 'app' else 37124}",
                 f"srun python -m {module} --fname {cfgs[0]}"):
        assert line in script.splitlines(), line
    assert "--ntasks-per-node=4" in submitted[2] and cfgs[1] in submitted[2]
    with pytest.raises(SystemExit):
        launcher.main(["--fname", str(batch)])
