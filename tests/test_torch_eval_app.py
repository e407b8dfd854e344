"""The port's frozen evals end to end on the CPU through the CLI
(python -m jepa_tpu_torch.evals.main --fname <yaml> --devices cpu): the
video eval on synthetic videos listed in CSV manifests (RandAugment on,
attend_across_segments, a padded last val batch), 1 epoch then a resume to
2, and the image eval on a PIL ImageFolder written here (AutoAugment
'original' on); both in fp32 and bf16. Checks the CSV rows, the probe
.pth.tar (which api.load_classifier reads) and the resumed step.
"""

import numpy as np
import pytest
import torch
import yaml

from jepa_tpu_torch import api
from jepa_tpu_torch.evals.main import main as cli_main
from jepa_tpu_torch.models.factory import vit_cfg
from jepa_tpu_torch.models.vit import init_vit

GEO = dict(img_size=32, patch_size=16, num_frames=4, tubelet_size=2, uniform_power=True)
HEADER = "epoch,loss,acc"  # the JAX evals' CSV columns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: torch's intra-op threads only contend with the other
    test workers (under pytest-xdist they multiplied this module's time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoder_ckpt(tmp_path_factory):
    """A seeded vit_tiny (head dim 64) in the zoo's .pth.tar layout."""
    path = tmp_path_factory.mktemp("enc") / "vit_tiny.pth.tar"
    model = init_vit(vit_cfg("vit_tiny", **GEO), torch.Generator().manual_seed(0))
    torch.save({"target_encoder": model.state_dict()}, path)
    return str(path)


def _pretrain(folder, ckpt):
    return {"model_name": "vit_tiny", "checkpoint_key": "target_encoder", "folder": folder,
            "checkpoint": ckpt, "write_tag": "probe", "patch_size": 16, "tubelet_size": 2,
            "frames_per_clip": 4, "frame_step": 2, "uniform_power": True}


def _opt(bf16, **kw):
    return {"batch_size": 2, "num_epochs": 1, "weight_decay": 0.01, "lr": 0.005,
            "start_lr": 0.001, "final_lr": 0.0005, "warmup": 0.5, "use_bfloat16": bf16, **kw}


def _run(tmp_path, cfg):
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cli_main(["--fname", str(path), "--devices", "cpu"])


def _check_outputs(folder, epochs, steps, num_classes, ckpt, bf16):
    rows = (folder / "probe_r0.csv").read_text().strip().splitlines()
    data = [r for r in rows if r != HEADER]
    assert rows[0] == HEADER and [int(r.split(",")[0]) for r in data] == list(range(1, epochs + 1))
    saved = torch.load(folder / "probe-latest.pth.tar", map_location="cpu", weights_only=True)
    assert saved["epoch"] == epochs and saved["opt"]["step"] == steps
    assert set(saved["opt"]["mu"]) == set(saved["classifier"])
    enc = api.load_encoder(ckpt, "vit_tiny", **GEO, device="cpu",
                           compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    clf = api.load_classifier(str(folder / "probe-latest.pth.tar"), enc, num_classes)
    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    probs = clf.classify(clips)
    assert probs.shape == (2, num_classes) and torch.allclose(probs.sum(-1), torch.ones(2))


@pytest.mark.parametrize("bf16", [False, True])
def test_video_eval_cli_resume(tmp_path, encoder_ckpt, bf16):
    for split, n in (("train", 4), ("val", 3)):  # 3 val videos at batch 2: a padded batch
        (tmp_path / f"{split}.csv").write_text(
            "".join(f"synthetic://{split}{i} {i % 3}\n" for i in range(n)))
    cfg = {"eval_name": "video_classification_frozen", "resume_checkpoint": True,
           "tag": "k400-tiny", "pretrain": _pretrain(str(tmp_path), encoder_ckpt),
           "data": {"dataset_train": str(tmp_path / "train.csv"),
                    "dataset_val": str(tmp_path / "val.csv"), "num_classes": 3,
                    "frames_per_clip": 4, "num_segments": 2, "num_views_per_segment": 2,
                    "decode_backend": "synthetic", "num_workers": 2},
           "optimization": _opt(bf16, resolution=32, attend_across_segments=True)}
    accs = _run(tmp_path, cfg)
    assert len(accs) == 1 and 0.0 <= accs[0] <= 100.0
    folder = tmp_path / "video_classification_frozen" / "k400-tiny"
    saved = torch.load(folder / "probe-latest.pth.tar", map_location="cpu", weights_only=True)
    assert saved["opt"]["step"] == 2  # ipe 2
    cfg["optimization"]["num_epochs"] = 2
    accs = _run(tmp_path, cfg)
    assert len(accs) == 1  # only epoch 2 ran
    _check_outputs(folder, 2, 4, 3, encoder_ckpt, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_image_eval_cli(tmp_path, encoder_ckpt, bf16):
    from PIL import Image

    rng = np.random.default_rng(1)
    for split, n in (("train", 4), ("val", 3)):
        for cls, base in (("a", 40), ("b", 200)):
            d = tmp_path / "imgs" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = np.clip(rng.normal(base, 30, (30, 44, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.png")
    cfg = {"eval_name": "image_classification_frozen",
           "pretrain": _pretrain(str(tmp_path), encoder_ckpt),
           "data": {"root_path": str(tmp_path), "image_folder": "imgs", "num_classes": 2,
                    "resolution": 32, "num_workers": 2},
           "optimization": _opt(bf16)}
    accs = _run(tmp_path, cfg)
    assert len(accs) == 1 and 0.0 <= accs[0] <= 100.0
    _check_outputs(tmp_path / "image_classification_frozen", 1, 4, 2, encoder_ckpt, bf16)


def test_eval_refuses_an_orbax_encoder_and_a_missing_gpu(tmp_path, monkeypatch):
    from jepa_tpu_torch.evals import video_classification_frozen as vcf

    (tmp_path / "run-dir").mkdir()  # a directory without an orbax checkpoint's _METADATA
    cfg = {"pretrain": _pretrain(str(tmp_path), "run-dir"),
           "data": {"num_classes": 2}, "optimization": _opt(False, resolution=32)}
    with pytest.raises(ValueError, match="nor an orbax checkpoint directory"):
        vcf.main(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vcf.main(cfg)
