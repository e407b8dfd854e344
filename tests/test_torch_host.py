"""The port's host path on the CPU: the loader's process pool against its
threads and the JAX package's ``DataLoader(use_processes=True)``, the
image loader's default, resource monitoring against the JAX package's, and
the app's ``logging.profile_steps`` / ``log_resources``. JAX runs first in
each test, torch after.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from jepa_tpu.data.loader import DataLoader as JaxDataLoader
from jepa_tpu.data.loader import ShardedSampler as JaxShardedSampler
from jepa_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from jepa_tpu.utils import monitoring as jax_monitoring
from jepa_tpu_torch.apps.vjepa.train import main as train_main
from jepa_tpu_torch.data.image_dataset import make_image_loader
from jepa_tpu_torch.data.loader import DataLoader, ShardedSampler
from jepa_tpu_torch.data.video_dataset import VideoDataset
from jepa_tpu_torch.utils import monitoring

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_REPO, "tests", "fixtures", "pretrain_smoke.yaml")


@pytest.fixture()
def manifest(tmp_path):
    csv = tmp_path / "train.csv"
    csv.write_text("".join(f"synthetic://v{i} {i % 3}\n" for i in range(12)))
    return str(csv)


def _video_kw(manifest):
    return dict(data_paths=[manifest], frames_per_clip=4, frame_step=3, num_clips=2,
                decode_backend="synthetic", decode_size=(24, 32), seed=5)


def _epochs(loader_cls, sampler_cls, ds, **kw):
    """Two epochs of batches (the epoch reaches the forked workers)."""
    sampler = sampler_cls(num_samples=len(ds), seed=3)
    out = []
    for epoch in (0, 1):
        sampler.set_epoch(epoch)
        out.append(list(loader_cls(ds, sampler, batch_size=4, num_workers=3, **kw)))
    return out


def _assert_same(got, want):
    assert [len(e) for e in got] == [len(e) for e in want] == [3, 3]
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(g["clips"], w["clips"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_array_equal(g["valid_hw"], w["valid_hw"])
            for a, b in zip(g["clip_indices"], w["clip_indices"]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_process_pool_batches_equal_threads_and_jax(manifest):
    want = _epochs(JaxDataLoader, JaxShardedSampler, JaxVideoDataset(**_video_kw(manifest)),
                   use_processes=True)
    ds = VideoDataset(**_video_kw(manifest))
    procs = _epochs(DataLoader, ShardedSampler, ds, use_processes=True)
    threads = _epochs(DataLoader, ShardedSampler, ds)
    _assert_same(procs, want)
    _assert_same(threads, want)
    assert not np.array_equal(procs[0][0]["clips"], procs[1][0]["clips"])  # epochs differ


_ABANDON = """
import multiprocessing, os, sys, threading, time
import numpy as np
from jepa_tpu_torch.data.loader import DataLoader, ShardedSampler


class SlowDs:
    def __len__(self):
        return 64

    def __getitem__(self, i):
        time.sleep(0.005)
        return np.full((1, 2, 4, 4, 3), i % 256, np.uint8), i, None, None


use_processes = sys.argv[1] == "processes"
before = threading.active_count()
for _ in range(12):
    it = iter(DataLoader(SlowDs(), ShardedSampler(num_samples=64), batch_size=4, num_workers=2,
                         prefetch=1, use_processes=use_processes))
    assert next(it)["labels"].shape == (4,)
    it.close()  # abandon mid-epoch -> GeneratorExit -> stop.set()
deadline = time.time() + 20
while ((threading.active_count() > before or multiprocessing.active_children())
       and time.time() < deadline):
    time.sleep(0.05)
released = threading.active_count() <= before and not multiprocessing.active_children()
print("released" if released else f"left {threading.enumerate()}", flush=True)
os._exit(0 if released else 1)  # a hung worker would also hang the interpreter's exit
"""


@pytest.mark.parametrize("use_processes", [False, True])
def test_abandoned_consumer_does_not_wedge_the_pool(use_processes):
    """Breaking out of an epoch releases the producer thread and shuts the
    pool down before the next epoch forks: no thread or worker process is
    left behind, and no worker hangs at exit on a wakeup lock copied from
    a pool still shutting down (1 in ~6 runs of 3 epochs hung before the
    loader joined its producer). Run in a process that imports the port
    and not JAX, as the program does: JAX warns that a fork among its
    threads will likely deadlock."""
    mode = "processes" if use_processes else "threads"
    res = subprocess.run([sys.executable, "-c", _ABANDON, mode], capture_output=True,
                         text=True, timeout=60, cwd=_REPO)
    assert res.returncode == 0 and res.stdout.strip() == "released", res.stdout + res.stderr


def _image_folder(root, n=10):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in ("a", "b"):
            d = root / "imgs" / split / c
            d.mkdir(parents=True)
            for i in range(n // 2):
                Image.fromarray(rng.integers(0, 255, size=(30, 40, 3), dtype=np.uint8)).save(
                    d / f"{i}.jpg")


def test_image_loader_defaults_to_processes(tmp_path):
    pytest.importorskip("PIL")
    from jepa_tpu.data.image_dataset import make_image_loader as jax_make_image_loader

    _image_folder(tmp_path)
    kw = dict(root_path=str(tmp_path), image_folder="imgs", batch_size=4, training=True,
              output_size=16, seed=2)
    _, jloader, jsampler = jax_make_image_loader(**kw, num_workers=2)
    assert jloader.use_processes
    jsampler.set_epoch(1)
    want = list(jloader)

    batches = {}
    for workers, procs in ((2, None), (2, False), (1, None)):
        _, loader, sampler = make_image_loader(**kw, num_workers=workers, use_processes=procs)
        assert loader.use_processes == (procs is None and workers > 1)
        sampler.set_epoch(1)
        batches[workers, procs] = list(loader)
    for got in batches.values():
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["images"], w["images"])
            np.testing.assert_array_equal(g["labels"], w["labels"])


def test_monitor_csv_and_samples_match_jax(tmp_path):
    jax_monitoring.ResourceMonitoringThread(log_dir=str(tmp_path / "jax"), rank=3)
    want = (tmp_path / "jax" / "resources_r3.csv").read_text()

    mon = monitoring.ResourceMonitoringThread(interval_s=0.05, log_dir=str(tmp_path / "port"),
                                              rank=3)
    assert os.path.basename(mon.csv_path) == "resources_r3.csv"
    assert open(mon.csv_path).read() == want == monitoring.CSV_HEADER
    assert monitoring.ResourceMonitoringThread().interval_s == 30.0
    seen = []
    mon.callback = seen.append
    mon.start()
    deadline = time.time() + 10
    while len(seen) < 2 and time.time() < deadline:
        time.sleep(0.02)
    mon.stop()
    mon.join(timeout=5)
    assert not mon.is_alive() and len(seen) >= 2
    rows = open(mon.csv_path).read().splitlines()
    assert rows[0] == want.strip() and len(rows) >= 3
    assert [len(r.split(",")) for r in rows] == [7] * len(rows)
    s = monitoring.sample_counters()
    want_fields = [f.name for f in jax_monitoring.ResourceSample.__dataclass_fields__.values()]
    assert list(monitoring.ResourceSample.__dataclass_fields__) == want_fields
    assert s.rss_mb > 0 and s.num_threads >= 1


def test_app_profile_steps_and_log_resources(tmp_path):
    with open(_FIXTURE) as f:
        cfg = yaml.safe_load(f)
    cfg["logging"].update(folder=str(tmp_path), profile_steps=[1, 2], log_resources=True)
    cfg["optimization"].update(epochs=1, ipe=4)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = train_main(cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert state.step == 4
    assert open(tmp_path / "resources_r0.csv").read().startswith(monitoring.CSV_HEADER)
    trace = tmp_path / "trace_r0.json"
    assert trace.stat().st_size > 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # a window still open when the loop ends is closed and written then
    os.remove(trace)
    cfg["logging"].update(folder=str(tmp_path / "open"), profile_steps=[3, 10])
    cfg["data"]["log_resource_utilization"] = False
    cfg["logging"]["log_resources"] = False
    torch.set_num_threads(1)
    try:
        train_main(cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert (tmp_path / "open" / "trace_r0.json").exists()
    assert not (tmp_path / "open" / "resources_r0.csv").exists()
