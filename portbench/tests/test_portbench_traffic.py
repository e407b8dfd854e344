"""The traffic generators: the same seed gives the same inputs, another seed
other inputs of the same sizes; the masks keep the sampler's invariants and
the keep counts equal the port's calibration."""

import json
import types

import numpy as np
import pytest
import torch

from portbench import masks as M
from portbench.kinds import pretrain, serve_video
from portbench.tests.conftest import HERE, REPO

SEEDS = (3, 2**31 + 11)


def _ctx(name, traffic, seed):
    cfg = json.loads((HERE / f"{name}.json").read_text())
    tr = json.loads((REPO / "portbench" / "traffic" / f"{traffic}.json").read_text())
    return types.SimpleNamespace(cfg=cfg, traffic=tr, seed=seed, device=torch.device("cpu"),
                                 sync=lambda: None)


def _pretrain_inputs(seed):
    return pretrain.Cell(_ctx("tiny", "pretrain_fixed", seed)).make_inputs(torch.bfloat16)


def _serve_pool(seed):
    cell = serve_video.Cell(_ctx("tiny", "serve_video", seed))
    return cell.order, cell.make_pool()


def test_pretrain_inputs_repeat_per_seed_and_differ_across_seeds():
    (c1, m1), (c2, m2), (c3, m3) = (_pretrain_inputs(s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert torch.equal(c1, c2) and not torch.equal(c1, c3)
    for a, b, c in zip(m1, m2, m3):
        for x, y, z in zip(a[0] + a[1], b[0] + b[1], c[0] + c[1]):
            assert torch.equal(x, y) and x.shape == z.shape
    assert any(not torch.equal(x, z) for a, c in zip(m1, m3) for x, z in zip(a[0], c[0]))
    # every batch of the pool is its own: the followed updates see rows that all differ
    assert all(not torch.equal(c1[i], c1[j]) for i in range(len(c1)) for j in range(i))


def test_serve_pool_same_work_for_every_seed():
    (o1, p1), (o2, p2), (o3, p3) = (_serve_pool(s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert o1 == o2 and all(np.array_equal(a, b) for a, b in zip(p1, p2))
    assert sorted(o1) == sorted(o3) and o1 != o3  # the same sizes, in another order
    assert not all(np.array_equal(a, b) for a, b in zip(p1, p3) if a.shape == b.shape)
    tr = json.loads((REPO / "portbench" / "traffic" / "serve_video.json").read_text())
    assert [a.shape[0] for a in p1] == [tr["views"] * s for s in o1]
    assert all(a.dtype == np.uint8 for a in p1)


@pytest.mark.parametrize("crop,batch", [(224, 24), (384, 10)])
def test_keep_counts_equal_the_ports(crop, batch):
    from jepa_tpu_torch.masks import multiblock3d as mb

    cfg = json.loads((REPO / "portbench" / "configs" / "vitl16.json").read_text())
    grid = M.Grid(8, crop // 16, crop // 16)
    for m in cfg["masks"]:
        ours = M.keep_counts(M.Spec.from_dict(m), grid, batch)
        theirs = mb.calibrate_keep_counts(mb.MaskSpec.from_cfg(m), mb.MaskGrid(8, crop // 16,
                                                                              crop // 16), batch)
        assert ours == theirs


def test_vitl16_keep_counts():
    grid = M.Grid(8, 14, 14)
    cfg = json.loads((REPO / "portbench" / "configs" / "vitl16.json").read_text())
    keep = [M.keep_counts(M.Spec.from_dict(m), grid, 24) for m in cfg["masks"]]
    assert keep == [(376, 733), (96, 1095)]


@pytest.mark.parametrize("seed", [0, 1, 2**33 + 5])
def test_fixed_masks_invariants(seed):
    grid = M.Grid(8, 14, 14)
    cfg = json.loads((REPO / "portbench" / "configs" / "vitl16.json").read_text())
    specs = [M.Spec.from_dict(m) for m in cfg["masks"]]
    keep = [(376, 733), (96, 1095)]
    enc, pred = M.sample_step(np.random.default_rng(seed), 24, specs, grid, keep)
    for e, p, (ke, kp) in zip(enc, pred, keep):
        assert e.shape == (24, ke) and p.shape == (24, kp)
        assert (np.diff(e, axis=1) > 0).all() and (np.diff(p, axis=1) > 0).all()
        assert all(not set(a) & set(b) for a, b in zip(e, p))
        assert e.min() >= 0 and max(e.max(), p.max()) < grid.n
    assert not np.array_equal(enc[0][0], enc[0][1])  # placements per sample
