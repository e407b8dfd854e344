"""Data parallelism of the port (jepa_tpu_torch.parallel, the train step's
and the evals' global-batch semantics, ZeRO-1) vs the JAX package on the
CPU.

Ranks are processes spawned by ``parallel.dist.run_local_ranks`` with a
gloo group over a ``file://`` rendezvous (no port), running the functions
of tests/torch_dist_ranks.py, which import no JAX (each rank reports
whether it did). The JAX side runs in this process at the global batch:
``jepa_tpu.train.step.build_train_step`` for the fixed and the padded
update, the JAX eval's probe update and val reduction for the probe. The
tiny fixture geometry of tests/test_torch_train.py, fp32; tolerances: the
one-update tolerance of PARITY.md (parameters <= 5e-5, loss and grad norms
rtol 2e-4) against JAX; against the port's own 1-rank update, where only
the order of the batch sums differs, the same parameter bound and rtol
1e-5; fsdp=2 against fsdp=1 bit-equal; val (correct, total) exact.
"""

import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.masks import multiblock3d as jax_masks
from jepa_tpu.masks import padding as jax_padding
from jepa_tpu.models.attentive import AttentiveCfg as JaxAttentiveCfg
from jepa_tpu.models.attentive import classifier_forward as jax_classifier_forward
from jepa_tpu.models.attentive import init_attentive_classifier as jax_init_classifier
from jepa_tpu.models.factory import predictor_cfg_for as jax_predictor_cfg_for
from jepa_tpu.models.vit import ViTCfg as JaxViTCfg
from jepa_tpu.models.vit import init_vit as jax_init_vit
from jepa_tpu.parallel import mesh as jax_mesh
from jepa_tpu.train import optimizer as jax_opt
from jepa_tpu.train import step as jax_step
from jepa_tpu.utils import schedulers as jax_sched
from jepa_tpu.evals import aggregation as jax_agg
from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.masks.random_tube import TubeSpec
from jepa_tpu_torch.masks.random_tube import keep_counts as tube_keep_counts
from jepa_tpu_torch.models.attentive import AttentiveCfg
from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.parallel import dist as pdist
from jepa_tpu_torch.parallel import mesh
from jepa_tpu_torch.utils.checkpoint_port import (
    classifier_state_from_jax,
    encoder_state_from_jax,
    predictor_state_from_jax,
)
from tests import torch_dist_ranks as ranks

PARAM_TOL = 5e-5
LOSS_RTOL = 2e-4
SAME_RTOL = 1e-5  # 2 ranks vs 1: only the order of the batch sums differs
GRAD_REL = 2e-4  # a gradient vs JAX's, relative to the tensor's largest entry
GB = 4  # the global batch: 2 ranks x 2
GEO = dict(img_size=32, patch_size=8, num_frames=4, tubelet_size=2)
ENC = dict(**GEO, embed_dim=64, depth=2, num_heads=4, uniform_power=True)
PRED = dict(predictor_embed_dim=32, depth=2)
GRID = dict(t=2, h=4, w=4)
MASKS = [dict(num_blocks=4, spatial_scale=[0.15, 0.15], aspect_ratio=[0.75, 1.5]),
         dict(num_blocks=2, spatial_scale=[0.5, 0.5], aspect_ratio=[0.75, 1.5])]
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1, start_lr=2e-4, ref_lr=1e-3,
             final_lr=1e-6, wd=0.04, final_wd=0.4, ema=(0.99, 1.0))
TRAIN = dict(loss_exp=1.0, reg_coeff=0.0, clip_grad=0.05, clip_after_step=0, seed=7)
PADDED_TRAIN = dict(TRAIN, reg_coeff=0.1, mask_mode="padded")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(fn, world, *args, **kw):
    out = pdist.run_local_ranks(fn, world, args, timeout=240, **kw)
    assert not any(r["jax_imported"] for r in out), "a spawned rank imported jax"
    return [r["result"] for r in out]


def _assert_state(got, want, atol, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, rtol=0,
                                   err_msg=f"{what}: {k}")


def _assert_bits(got, want, what):
    assert set(got) == set(want), what
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, f"{what}: {bad}"


def _spec(**kw):
    return dict(enc=ENC, pred=PRED, sched=SCHED, masks=MASKS, grid=GRID, **kw)


def _rows(batch, world):
    """A global batch dict of numpy arrays -> one dict per rank."""
    return [{k: mesh.rank_rows(v, r, world) for k, v in batch.items()} for r in range(world)]


# ---- parallel.dist / parallel.mesh ------------------------------------------------


_DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
             "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "HOSTNAME")


@pytest.mark.parametrize("case", ["explicit", "torchrun", "slurm", "slurm_one_task", "none"])
def test_initialize_resolution_order(monkeypatch, case):
    """Explicit arguments, then torchrun's env, then SLURM's (the JAX
    module's variables, default port 37123), then one process, no group."""
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append(dict(backend=backend, **kw)))
    slurm = dict(SLURM_NTASKS="8", SLURM_PROCID="5", SLURM_LOCALID="1", MASTER_ADDR="node0")
    torchrun = dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="3", MASTER_ADDR="h",
                    MASTER_PORT="29500")
    env, want = {
        "explicit": ({**slurm, **torchrun}, (2, 1, "file:///x/rdv", 3)),
        "torchrun": ({**slurm, **torchrun}, (4, 3, "env://", 3)),
        "slurm": (slurm, (8, 5, "tcp://node0:37123", 1)),
        "slurm_one_task": (dict(slurm, SLURM_NTASKS="1"), (1, 0, None, 1)),
        "none": ({}, (1, 0, None, 0)),
    }[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(init_method="file:///x/rdv", world_size=2, rank=1) if case == "explicit" else {}
    assert pdist.initialize(backend="gloo", **kw) == want[:2]
    assert pdist.local_rank() == want[3]
    if want[2] is None:
        assert calls == []
    else:
        assert calls == [dict(backend="gloo", init_method=want[2], world_size=want[0],
                              rank=want[1])]


def test_initialize_failure_raises_and_no_gpu_falls_back(monkeypatch):
    """A world > 1 environment whose init fails raises (no silent world
    1), and a rank asked for the card on a host without one raises."""
    monkeypatch.setenv("SLURM_NTASKS", "2")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)

    def refuse(*a, **kw):
        raise RuntimeError("rendezvous refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="rendezvous refused"):
        pdist.initialize(backend="gloo")
    with pytest.raises(ValueError, match="outside world size"):
        pdist.initialize(backend="gloo", init_method="file:///x", world_size=2, rank=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdist.rank_device("cuda")
    assert pdist.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("world", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("fsdp", [1, 2, 3, 4, 8])
def test_make_layout_matches_make_mesh(world, fsdp):
    """fsdp reduced as make_mesh reduces it (with its warning), and each
    rank's (data, fsdp) coordinates those of its device in the JAX mesh."""
    devices = jax.devices()[:world]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        m = jax_mesh.make_mesh(fsdp=fsdp, devices=devices)
    for r in range(world):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            layout = mesh.make_layout(fsdp, world=world, rank=r)
        assert len(tw) == len(jw)
        assert (layout.data, layout.fsdp) == (m.shape["data"], m.shape["fsdp"])
        d, f = map(int, np.argwhere(np.vectorize(lambda x: x.id)(m.devices) == devices[r].id)[0])
        assert (r // layout.fsdp, layout.fsdp_rank) == (d, f)


def _jax_leaf_shapes(model):
    """{name: shape} of the JAX factory model's encoder and a 12 x 384
    predictor (stacked layout), from jax.eval_shape."""
    from jepa_tpu.models.factory import vit_cfg as jax_vit_cfg
    from jepa_tpu.models.predictor import init_predictor as jax_init_predictor

    cfg = jax_vit_cfg(model, img_size=224, patch_size=16, num_frames=16, tubelet_size=2)
    enc = jax.eval_shape(lambda: jax_init_vit(jax.random.PRNGKey(0), cfg)[0])
    pcfg = jax_predictor_cfg_for(cfg, predictor_embed_dim=384, depth=12, num_mask_tokens=2)
    pred = jax.eval_shape(lambda: jax_init_predictor(jax.random.PRNGKey(0), pcfg)[0])
    leaves = jax.tree_util.tree_flatten_with_path({"encoder": enc, "predictor": pred})[0]
    return {jax.tree_util.keystr(p): tuple(x.shape) for p, x in leaves}


@pytest.mark.parametrize("model", ["vit_tiny", "vit_small", "vit_base", "vit_large",
                                   "vit_huge", "vit_giant"])
def test_zero1_plan_matches_param_sharding(model):
    """zero1_plan's integer rule gives param_sharding's spec, leaf by leaf,
    at fsdp 2, 4 and 8, on the JAX factory model's (stacked) leaves and on
    the port's (per layer) parameters."""
    from jepa_tpu_torch.models.predictor import Predictor
    from jepa_tpu_torch.models.vit import VisionTransformer

    cfg = vit_cfg(model, img_size=224, patch_size=16, num_frames=16, tubelet_size=2)
    with torch.device("meta"):
        port = {f"encoder.{n}": tuple(p.shape)
                for n, p in VisionTransformer(cfg).named_parameters()}
        pcfg = predictor_cfg_for(cfg, predictor_embed_dim=384, depth=12, num_mask_tokens=2)
        port.update({f"predictor.{n}": tuple(p.shape)
                     for n, p in Predictor(pcfg).named_parameters()})
    n_sharded = 0
    for fsdp in (2, 4, 8):
        m = jax_mesh.make_mesh(data=8 // fsdp, fsdp=fsdp)
        for shapes in (_jax_leaf_shapes(model), port):
            fake = {n: np.broadcast_to(np.float32(0), s) for n, s in shapes.items()}
            specs = jax_mesh.param_sharding(m, fake)
            want = {n: (list(s.spec).index("fsdp") if "fsdp" in s.spec else None)
                    for n, s in specs.items()}
            got = mesh.zero1_plan(shapes, fsdp)
            assert got == want
            n_sharded += sum(ax is not None for ax in got.values())
    assert n_sharded > 0


def test_shard_and_rank_rows():
    t = torch.arange(24.0).reshape(4, 6)
    lay = mesh.Layout(world=4, rank=3, fsdp=2)
    assert torch.equal(mesh.shard(t, 1, lay), t[:, 3:])
    assert mesh.shard(t, None, lay) is t
    assert np.array_equal(mesh.rank_rows(np.arange(8), 1, 4), [2, 3])
    with pytest.raises(ValueError):
        mesh.rank_rows(np.arange(7), 0, 2)
    assert mesh.eval_batch_geometry(4, 8) == (4, 32)


# ---- the update -------------------------------------------------------------------


def _jax_state(seed):
    jenc = JaxViTCfg(**ENC, compute_dtype=jnp.float32, attn_impl="xla")
    jpred = jax_predictor_cfg_for(jenc, **PRED)
    state, consts = jax_step.init_train_state(jax.random.PRNGKey(seed), jenc, jpred)
    return jenc, jpred, state, consts


def _want_modules(new, consts):
    enc = ViTCfg(**ENC, compute_dtype=torch.float32)
    pred = predictor_cfg_for(enc, **PRED)
    return {"encoder": encoder_state_from_jax(new["params"]["encoder"], consts["encoder"], enc),
            "predictor": predictor_state_from_jax(new["params"]["predictor"],
                                                  consts["predictor"], pred),
            "target": encoder_state_from_jax(new["target"], consts["encoder"], enc)}


@pytest.fixture(scope="module")
def fixed_jax():
    """The JAX update at the global batch (4 clips), with the masks its
    step draws, as numpy."""
    jenc, jpred, state, consts = _jax_state(11)
    specs = [jax_masks.MaskSpec.from_cfg(m) for m in MASKS]
    grid = jax_masks.MaskGrid(**GRID)
    keep = [jax_masks.calibrate_keep_counts(s, grid, GB // 2) for s in specs]
    tc = jax_step.TrainCfg(**TRAIN, batch_size=GB)
    step_fn = jax_step.build_train_step(jenc, jpred, consts, tc,
                                        *jax_sched.build_schedules(**SCHED), specs, grid, keep)
    clips = np.random.default_rng(12).normal(size=(GB, 4, 32, 32, 3)).astype(np.float32)
    me, mp = jax_masks.sample_masks_for_specs(
        jax.random.fold_in(jax.random.PRNGKey(tc.seed), 1), state["step"], GB, specs,
        grid, keep)
    new, metrics = jax.jit(step_fn)(state, {"clips": jnp.asarray(clips)})
    return dict(state=_np(state), consts=_np(consts), new=_np(new), keep=keep, clips=clips,
                metrics={k: float(v) for k, v in metrics.items()},
                masks=([np.asarray(m) for m in me], [np.asarray(m) for m in mp]))


def test_two_rank_fixed_update_matches_jax_and_one_rank(fixed_jax):
    """2 ranks x 2 clips, the JAX step's global masks sliced by rank,
    against the JAX update at the global batch and the port's 1-rank
    update of all 4 clips; both ranks end with the same bits."""
    ju = fixed_jax
    spec = _spec(train=TRAIN, keep=ju["keep"], init=("jax", ju["state"], ju["consts"]),
                 global_masks=[ju["masks"]])
    two = _run(ranks.update_rank, 2, dict(spec, batches=[_rows({"clips": ju["clips"]}, 2)]))
    one = ranks.update_rank(0, 1, dict(spec, batches=[[{"clips": ju["clips"]}]]))
    want = _want_modules(ju["new"], ju["consts"])
    for m in ("encoder", "predictor", "target"):
        _assert_state(two[0][m], want[m], PARAM_TOL, f"2 ranks vs JAX, {m}")
        _assert_state(two[0][m], one[m], PARAM_TOL, f"2 ranks vs 1 rank, {m}")
        _assert_bits(two[1][m], two[0][m], f"rank 1 vs rank 0, {m}")
    got, one_m = two[0]["metrics"][0], one["metrics"][0]
    assert got == two[1]["metrics"][0]
    for k in ("loss", "enc_grad_norm", "pred_grad_norm", "enc_qkv_first", "pred_qkv_max"):
        np.testing.assert_allclose(got[k], ju["metrics"][k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(got[k], one_m[k], rtol=SAME_RTOL, err_msg=k)
    for k in ("input_var", "input_var_min", "exp_avg_abs_mean", "exp_avg_sq_mean"):
        np.testing.assert_allclose(got[k], ju["metrics"][k], rtol=LOSS_RTOL, err_msg=k)


@pytest.fixture(scope="module")
def padded_jax():
    """The JAX padded update at the global batch: the collator's two chunks
    (one per rank, each with its own batch-min K), padded to one cap, so
    their weight sums differ."""
    jenc, jpred, state, consts = _jax_state(13)
    specs = [jax_masks.MaskSpec.from_cfg(m) for m in MASKS]
    grid = jax_masks.MaskGrid(**GRID)
    keep = [jax_masks.calibrate_keep_counts(s, grid, GB // 2) for s in specs]
    me_list, mp_list = jax_masks.MaskCollator(specs, grid, seed=3).collate_chunks(GB // 2, 2)
    chunks = [{k: [] for k in ("masks_enc", "enc_weights", "masks_pred", "pred_weights")}
              for _ in range(2)]
    for mes, mps in zip(me_list, mp_list):
        for ms, keys in ((mes, ("masks_enc", "enc_weights")),
                         (mps, ("masks_pred", "pred_weights"))):
            cap = max(m.shape[1] for m in ms) + 3
            for c, m in zip(chunks, ms):
                idx, w = jax_padding.pad_masks(m, cap)
                c[keys[0]].append(idx)
                c[keys[1]].append(w)
    clips = np.random.default_rng(14).normal(size=(GB, 4, 32, 32, 3)).astype(np.float32)
    tc = jax_step.TrainCfg(**PADDED_TRAIN, batch_size=GB)
    step_fn = jax_step.build_train_step(jenc, jpred, consts, tc,
                                        *jax_sched.build_schedules(**SCHED), specs, grid, keep)
    batch = {k: [jnp.concatenate([jnp.asarray(c[k][i]) for c in chunks])
                 for i in range(len(MASKS))] for k in chunks[0]}
    new, metrics = jax.jit(step_fn)(state, {"clips": jnp.asarray(clips), **batch})
    return dict(state=_np(state), consts=_np(consts), new=_np(new), keep=keep, clips=clips,
                chunks=chunks, metrics={k: float(v) for k, v in metrics.items()})


def test_two_rank_padded_update_matches_jax(padded_jax):
    """Each rank holds one collate chunk; the loss divides by the global
    weight sum (all-reduced), so it matches the JAX padded update over the
    concatenated batch although the chunks' weight sums differ."""
    ju = padded_jax
    sums = [[float(w.sum()) for w in c["pred_weights"]] for c in ju["chunks"]]
    assert sums[0] != sums[1]  # a local denominator would weight the ranks wrongly
    per_rank = [dict(ch, clips=mesh.rank_rows(ju["clips"], r, 2))
                for r, ch in enumerate(ju["chunks"])]
    spec = _spec(train=PADDED_TRAIN, keep=ju["keep"], init=("jax", ju["state"], ju["consts"]),
                 batches=[per_rank])
    two = _run(ranks.update_rank, 2, spec)
    want = _want_modules(ju["new"], ju["consts"])
    for m in ("encoder", "predictor", "target"):
        _assert_state(two[0][m], want[m], PARAM_TOL, f"padded, {m}")
        _assert_bits(two[1][m], two[0][m], f"rank 1 vs rank 0, {m}")
    got = two[0]["metrics"][0]
    for k in ("loss", "loss_jepa", "loss_reg", "enc_grad_norm", "pred_grad_norm"):
        np.testing.assert_allclose(got[k], ju["metrics"][k], rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("mode", ["tube", "fixed"])
def test_two_rank_default_sampler_matches_one_rank(mode):
    """The step's own sampler (tube or fixed masks) draws the global
    batch's masks and each rank keeps its rows: 2 ranks x 2 clips equal
    1 rank x 4 clips, two updates from one seeded state."""
    if mode == "tube":
        mcfg = [{"ratio": 0.5}]
        keep = [tube_keep_counts(TubeSpec.from_cfg(m), masks.MaskGrid(**GRID)) for m in mcfg]
    else:
        mcfg = MASKS
        keep = [masks.calibrate_keep_counts(masks.MaskSpec.from_cfg(m), masks.MaskGrid(**GRID),
                                            GB // 2) for m in mcfg]
    rng = np.random.default_rng(21)
    clips = [rng.normal(size=(GB, 4, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    spec = dict(_spec(train=dict(TRAIN, mask_mode=mode), keep=keep, init=("seed", 3)),
                masks=mcfg)
    two = _run(ranks.update_rank, 2, dict(spec, batches=[_rows({"clips": c}, 2) for c in clips]))
    one = ranks.update_rank(0, 1, dict(spec, batches=[[{"clips": c}] for c in clips]))
    for m in ("encoder", "predictor", "target"):
        _assert_state(two[0][m], one[m], PARAM_TOL, f"{mode}: 2 ranks vs 1, {m}")
    for got, want in zip(two[0]["metrics"], one["metrics"]):
        for k in ("loss", "enc_grad_norm", "pred_grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=SAME_RTOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_bit_equal_checkpoint_and_cross_resume(tmp_path, world):
    """ZeRO-1: fsdp=2 gives fsdp=1's bits after 2 updates (parameters,
    target, the gathered moments); the checkpoint it writes holds the whole
    moments; resuming the fsdp=2 checkpoint at fsdp=1 and the fsdp=1 one at
    fsdp=2 gives one more update with equal bits. At 4 ranks the fsdp
    groups are {0, 1} and {2, 3}."""
    rng = np.random.default_rng(5)
    clips = [rng.normal(size=(GB, 4, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    keep = [masks.calibrate_keep_counts(masks.MaskSpec.from_cfg(m), masks.MaskGrid(**GRID),
                                        GB // world) for m in MASKS]
    base = _spec(train=TRAIN, keep=keep, init=("seed", 4), min_shard=1000)
    first = [_rows({"clips": c}, world) for c in clips[:2]]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(a)
    os.makedirs(b)
    runs = [dict(base, fsdp=2, batches=first, save=a), dict(base, fsdp=1, batches=first, save=b),
            dict(base, fsdp=1, batches=[_rows({"clips": clips[2]}, world)], resume=a),
            dict(base, fsdp=2, batches=[_rows({"clips": clips[2]}, world)], resume=b)]
    out = _run(ranks.run_specs, world, runs)
    sharded, full = out[0][0], out[0][1]
    assert sharded["local_mu_shapes"] != full["local_mu_shapes"]  # something was sharded
    for key in ("encoder", "predictor", "target", "mu", "nu"):
        _assert_bits(sharded[key], full[key], f"fsdp 2 vs 1 after 2 updates: {key}")
        _assert_bits(out[-1][0][key], out[0][0][key], f"rank {world - 1} vs 0: {key}")
    for folder, res in ((a, sharded), (b, full)):
        saved = torch.load(os.path.join(folder, "dp-latest.pth.tar"), weights_only=True)
        assert saved["opt"]["step"] == 2 and saved["world_size"] == world
        _assert_bits(saved["opt"]["mu"], res["mu"], f"{folder} mu")
        _assert_bits(saved["opt"]["nu"], res["nu"], f"{folder} nu")
    x, y = out[0][2], out[0][3]
    assert x["step"] == y["step"] == 3
    for key in ("encoder", "predictor", "target", "mu", "nu"):
        _assert_bits(x[key], y[key], f"cross-fsdp resume: {key}")


# ---- the probe ---------------------------------------------------------------------


_TINY = dict(img_size=32, patch_size=16, tubelet_size=2, embed_dim=128, depth=2, num_heads=2,
             uniform_power=True, num_frames=4)
NUM_CLASSES = 5
LR = dict(warmup_steps=1, start_lr=1e-3, ref_lr=5e-3, final_lr=1e-4, t_max=6)
WD = dict(ref_wd=0.01, final_wd=1e-6, t_max=6)


def _probe_loss(c, jacfg, feats, labels):
    logits = [jax_classifier_forward(c, o, jacfg) for o in feats]
    onehot = jax.nn.one_hot(labels, NUM_CLASSES)
    return sum(-jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(lg), axis=-1))
               for lg in logits) / len(logits)


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_probe_update(clf, opt, mask, jacfg, feats, labels, sched_step):
    """The JAX eval's probe update (video_classification_frozen.py:262-285)
    at the global batch; also returns the gradients the clip receives."""
    loss, grads = jax.value_and_grad(_probe_loss)(clf, jacfg, feats, labels)
    clipped, _ = jax_opt.clip_by_global_norm(grads, 1.0, jnp.asarray(True))
    clf, opt, _ = jax_opt.adamw_update(
        clf, clipped, opt, lr=jax_sched.WarmupCosine(**LR)(sched_step),
        wd=jax_sched.CosineWD(**WD)(sched_step), mask=mask, step=sched_step)
    return clf, opt, loss, grads


def test_two_rank_probe_steps_and_uneven_val_match_jax():
    """Two probe updates of 2 ranks x 2 clips against the JAX eval's
    update at the global batch of 4: the losses, and the gradients the clip
    receives (averaged over the ranks: the global batch's), each tensor to
    GRAD_REL of its largest entry; the updated probe and its moments
    against the port's 1-rank update of the 4 clips. Then a val pass over 7
    clips at batch 2 per rank (the sampler's wrap-around repeat and a
    padded last batch carry zero weight) against the JAX val reduction over
    the 7 with JAX's twice-updated probe: (correct, total) exactly.

    The updated parameters are not held against JAX: AdamW's first steps
    divide by sqrt(v) + eps, so a gradient entry near eps (1e-8) turns an
    fp32 rounding of it into up to lr of movement. Measured at this
    geometry, even the port's 1-rank update differs from JAX's by more than
    5e-5 on 1 or 2 entries for 5 of 10 data seeds (40-49)."""
    jcfg = JaxViTCfg(**_TINY, compute_dtype=jnp.float32)
    params, consts = jax_init_vit(jax.random.PRNGKey(0), jcfg)
    jacfg = JaxAttentiveCfg(embed_dim=128, num_heads=2, depth=1, num_classes=NUM_CLASSES,
                            compute_dtype=jnp.float32)
    clf = jax_init_classifier(jax.random.PRNGKey(3), jacfg)
    opt, mask = jax_opt.init_adamw_state(clf), jax_opt.decay_mask(clf)
    cfg = ViTCfg(**_TINY, compute_dtype=torch.float32, fused_mlp=True)
    acfg = AttentiveCfg(embed_dim=128, num_heads=2, depth=1, num_classes=NUM_CLASSES,
                        compute_dtype=torch.float32)
    spec = dict(enc=_TINY, acfg=dict(embed_dim=128, num_heads=2, depth=1,
                                     num_classes=NUM_CLASSES),
                encoder_sd=encoder_state_from_jax(_np(params), _np(consts), cfg),
                classifier_sd=classifier_state_from_jax(_np(clf), acfg), lr=LR, wd=WD,
                val_batch=2)
    rng = np.random.default_rng(40)
    spec["train"] = [(rng.normal(size=(GB, 2, 1, 4, 32, 32, 3)).astype(np.float32),
                      rng.integers(0, NUM_CLASSES, GB)) for _ in range(2)]
    spec["val_clips"] = rng.normal(size=(7, 2, 1, 4, 32, 32, 3)).astype(np.float32)
    spec["val_labels"] = rng.integers(0, NUM_CLASSES, 7)

    feats = lambda x: jax_agg.clip_aggregation(params, consts, jnp.asarray(x), jcfg,
                                               attend_across_segments=True)
    losses, grads = [], []
    for step, (clips, labels) in enumerate(spec["train"]):
        clf, opt, loss, g = _jax_probe_update(clf, opt, mask, jacfg, feats(clips),
                                              jnp.asarray(labels), jnp.float32(step + 1))
        losses.append(float(loss))
        grads.append(classifier_state_from_jax(_np(g), acfg))
    vf = feats(spec["val_clips"])
    logits = [jax_classifier_forward(clf, o, jacfg) for o in vf]
    probs = sum(jax.nn.softmax(lg) for lg in logits) / len(logits)
    hits = (jnp.argmax(probs, -1) == jnp.asarray(spec["val_labels"])).astype(jnp.float32)
    want_counts = (float(jnp.sum(hits)), 7.0)

    two = _run(ranks.probe_rank, 2, spec)
    one = ranks.probe_rank(0, 1, spec)
    assert two[0]["n_local"] == two[1]["n_local"] == 4  # 7 clips: one wrap-around repeat
    for r in two:
        np.testing.assert_allclose([l for l, _ in r["losses"]], losses, rtol=LOSS_RTOL)
        assert r["counts"] == want_counts and r["step"] == 2
    assert one["counts"] == want_counts
    for step, want in enumerate(grads):
        got = two[0]["grads"][step]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=GRAD_REL * float(v.abs().max()),
                                       err_msg=f"update {step + 1} grad {k}")
        _assert_bits(two[1]["grads"][step], got, f"update {step + 1} grads, rank 1 vs 0")
        _assert_state(two[0]["classifiers"][step], one["classifiers"][step], PARAM_TOL,
                      f"probe after update {step + 1} vs 1 rank")
    _assert_state(two[0]["mu"], one["mu"], PARAM_TOL, "probe moments vs 1 rank")
    _assert_bits(two[1]["classifiers"][1], two[0]["classifiers"][1], "probe, rank 1 vs 0")
