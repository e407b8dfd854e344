"""The port's pretrain app end to end on the CPU with
tests/fixtures/pretrain_smoke.yaml (vit_tiny, synthetic video): fixed mode
for 2 epochs x ipe 3, a resume to 3 epochs from the app's own
.pth.tar, padded mode for 1 epoch, the CSV with the JAX app's columns, and
jepa_tpu_torch.api.load_encoder reading the checkpoint's target encoder.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from jepa_tpu_torch import api
from jepa_tpu_torch.apps.main import main as cli_main
from jepa_tpu_torch.apps.vjepa.train import main as train_main
from jepa_tpu_torch.models.vit import vit_forward

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "pretrain_smoke.yaml")
# the JAX app's CSV columns (jepa_tpu/apps/vjepa/train.py:335-341)
HEADER = "epoch,itr,loss,loss-jepa,reg-loss,enc-grad-norm,pred-grad-norm,step-time(ms),wall-time(ms)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads only contend with the other
    test workers (under pytest-xdist they multiplied this module's time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def smoke_cfg(tmp_path):
    with open(_FIXTURE) as f:
        cfg = yaml.safe_load(f)
    cfg["logging"]["folder"] = str(tmp_path)
    return cfg


def test_app_fixed_mode_resume_and_checkpoint(smoke_cfg, tmp_path):
    state = train_main(smoke_cfg, device="cpu")
    assert state.step == 6  # 2 epochs x ipe 3
    rows = (tmp_path / "smoke_r0.csv").read_text().strip().splitlines()
    assert rows[0] == HEADER and len(rows) == 1 + 6
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows[1:])
    assert (tmp_path / "params-pretrain.yaml").exists()
    ckpt = tmp_path / "smoke-latest.pth.tar"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert {"encoder", "predictor", "target_encoder", "opt", "epoch", "batch_size",
            "world_size", "lr"} <= set(saved)
    assert saved["epoch"] == 2 and saved["opt"]["step"] == 6

    # the app's checkpoint serves through the port's API: the EMA target's features
    d = smoke_cfg["data"]
    enc = api.load_encoder(str(ckpt), "vit_tiny", img_size=d["crop_size"],
                           patch_size=d["patch_size"], num_frames=d["num_frames"],
                           tubelet_size=d["tubelet_size"], uniform_power=True,
                           compute_dtype=torch.float32, device="cpu")
    clips = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, d["num_frames"], d["crop_size"], d["crop_size"], 3)).astype(np.float32))
    with torch.no_grad():
        want = vit_forward(state.target, clips)
    np.testing.assert_allclose(enc.encode(clips).numpy(), want.numpy(), atol=1e-5, rtol=0)

    # resume: 3 epochs from the latest checkpoint ends at step 9
    target_before = state.target.blocks[0].attn.qkv.weight.detach().clone()
    smoke_cfg["optimization"]["epochs"] = 3
    state2 = train_main(smoke_cfg, device="cpu")
    assert state2.step == 9
    rows2 = (tmp_path / "smoke_r0.csv").read_text().strip().splitlines()
    assert sum(r.startswith("3,") for r in rows2) == 3 and len(rows2) == 1 + 6 + 1 + 3
    assert not torch.equal(state2.target.blocks[0].attn.qkv.weight, target_before)


def test_app_padded_mode(smoke_cfg, tmp_path):
    smoke_cfg["meta"]["mask_mode"] = "padded"
    smoke_cfg["optimization"]["epochs"] = 1
    state = train_main(smoke_cfg, device="cpu")
    assert state.step == 3
    rows = (tmp_path / "smoke_r0.csv").read_text().strip().splitlines()
    assert rows[0] == HEADER and len(rows) == 1 + 3


def test_app_cli_and_unported_options(smoke_cfg, tmp_path):
    smoke_cfg["optimization"]["epochs"] = 1
    smoke_cfg["optimization"]["ipe"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(smoke_cfg))
    state = cli_main(["--fname", str(path), "--devices", "cpu"])
    assert state.step == 1
    # RandAugment (data_aug.auto_augment, ported with the frozen evals) runs
    smoke_cfg["data_aug"]["auto_augment"] = True
    smoke_cfg["logging"]["folder"] = str(tmp_path / "randaugment")  # no checkpoint to resume
    assert train_main(smoke_cfg, device="cpu").step == 1
    smoke_cfg["data_aug"]["auto_augment"] = False
    # the tube masks run (tests/test_torch_tube.py: the update vs the JAX
    # package; test_app_tube_modes: both mask modes); an unknown type raises
    smoke_cfg["data"]["mask_type"] = "random_tube"
    smoke_cfg["mask"] = [{"ratio": 0.5}]
    smoke_cfg["logging"]["folder"] = str(tmp_path / "tube")
    assert train_main(smoke_cfg, device="cpu").step == 1
    smoke_cfg["data"]["mask_type"] = "blocks"
    with pytest.raises(ValueError, match="mask_type"):
        train_main(smoke_cfg, device="cpu")


@pytest.mark.parametrize("mode", ["fixed", "padded"])
def test_app_tube_modes(smoke_cfg, tmp_path, mode):
    """data.mask_type random_tube: the fixed mode runs the step's 'tube'
    sampler (K_enc 4 of 8 tokens), the padded mode TubeMaskCollator's masks
    padded to one tier of static caps (here the whole grid, 8), with the
    key mask at w > 0.5. The app's default remat ('attn') is on."""
    smoke_cfg["data"]["mask_type"] = "random_tube"
    smoke_cfg["mask"] = [{"ratio": 0.5}, {"ratio": 0.75}]
    smoke_cfg["meta"]["mask_mode"] = mode
    smoke_cfg["optimization"]["epochs"] = 1
    state = train_main(smoke_cfg, device="cpu")
    assert state.step == 3
    rows = (tmp_path / "smoke_r0.csv").read_text().strip().splitlines()
    assert rows[0] == HEADER and len(rows) == 1 + 3
    assert all(np.isfinite(float(r.split(",")[2])) for r in rows[1:])
