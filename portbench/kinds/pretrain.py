"""Pretraining traffic: back-to-back updates of the port's
``train.step.build_train_step`` on one card.

Set-up builds one training state from the seed's weights, a pool of
``pool_batches`` batches of normalized clips and, matched with them, the
benchmark's fixed-K multiblock masks (handed in through ``mask_sampler``,
so the port's own on-device sampler is not timed), and drives the state
through its first ``checked_updates`` updates, which compile and warm every
shape and are the ones the reference follows. The window continues the same
state. After it, the program is freed and the fp32 reference follows the
first updates from the same weights, clips and masks.

The state's step counter starts at the first update with gradient clipping
on (the warm-up epochs plus one, as the app derives it), so that the
followed and timed updates are the steady phase's, clip included. The
moments start at zero, as a fresh state's do.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import compare, flops, masks as M, weights as W
from portbench.program import check_dims, load_leaves, port
from portbench.reference import train as ref_train
from portbench.reference.numerics import Numerics, fp32_exact

B1 = 0.9  # the AdamW betas of the shipped configs (the port's default)


def to_host(tensors: dict) -> dict:
    """The tensors on the host, moved in one copy (one flat buffer, then
    views): far faster than a copy a leaf."""
    flat = torch.cat([t.reshape(-1) for t in tensors.values()]).cpu()
    out, at = {}, 0
    for k, t in tensors.items():
        out[k] = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
    return out


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.cfg, ctx.traffic
        self.m, self.pr, self.t = cfg["model"], cfg["predictor"], cfg["train"]
        self.batch = int(self.t["batch_size"])
        self.pool_n = int(tr["pool_batches"])
        self.checked = int(tr["checked_updates"])
        self.grid = M.Grid(self.m["num_frames"] // self.m["tubelet_size"],
                           self.m["img_size"] // self.m["patch_size"],
                           self.m["img_size"] // self.m["patch_size"])
        self.specs = [M.Spec.from_dict(s) for s in cfg["masks"]]
        self.keep = [M.keep_counts(s, self.grid, self.batch) for s in self.specs]
        m, pr = self.m, self.pr
        self.flops_per_update = flops.train_step_flops(
            enc_dim=m["embed_dim"], enc_depth=m["depth"], enc_mlp=m["mlp_ratio"],
            pred_dim=pr["embed_dim"], pred_depth=pr["depth"], n_full=self.grid.n,
            ctx_lens=[k[0] for k in self.keep], tgt_lens=[k[1] for k in self.keep],
            batch=self.batch, patch_dim=3 * m["tubelet_size"] * m["patch_size"] ** 2)
        calls = flops.update_attention_calls(
            n_full=self.grid.n, heads=m["num_heads"], head_dim=m["embed_dim"] // m["num_heads"],
            depth=m["depth"], pred_heads=m["num_heads"],
            pred_head_dim=pr["embed_dim"] // m["num_heads"], pred_depth=pr["depth"],
            keep=self.keep)
        self.attn_bound_per_update = flops.attention_bound_ms(calls, self.batch)
        opt = self.t["optimization"]
        self.clip_after = int((float(opt["warmup"]) + 1) * int(opt["ipe"]))

    # ---- set-up -------------------------------------------------------------
    def setup(self, parts: dict) -> None:
        ctx, m, pr, t = self.ctx, self.m, self.pr, self.t
        dev = ctx.device
        t0 = time.perf_counter()
        factory, step_mod = port("models.factory"), port("train.step")
        vit, pred_mod = port("models.vit"), port("models.predictor")
        mb, sched = port("masks.multiblock3d"), port("utils.schedulers")
        parts["import_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if dev.type == "cuda":
            port("ops._build").load_library()
        parts["library_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[t["dtype"]]
        enc_cfg = factory.vit_cfg(m["name"], img_size=m["img_size"], patch_size=m["patch_size"],
                                  num_frames=m["num_frames"], tubelet_size=m["tubelet_size"],
                                  uniform_power=m["uniform_power"], compute_dtype=dtype,
                                  remat=t["remat"])
        check_dims(enc_cfg, m, ctx.cfg["name"])
        pred_cfg = factory.predictor_cfg_for(
            enc_cfg, predictor_embed_dim=pr["embed_dim"], depth=pr["depth"],
            use_mask_tokens=True, num_mask_tokens=len(self.specs),
            zero_init_mask_tokens=True, remat=t["pred_remat"])
        opt = t["optimization"]
        ipe = int(opt["ipe"])
        scheds = sched.build_schedules(
            ipe=ipe, num_epochs=int(opt["epochs"]), warmup_epochs=float(opt["warmup"]),
            start_lr=opt["start_lr"], ref_lr=opt["lr"], final_lr=opt["final_lr"],
            wd=opt["weight_decay"], final_wd=opt["final_weight_decay"], ema=tuple(opt["ema"]),
            ipe_scale=opt["ipe_scale"])
        train_cfg = step_mod.TrainCfg(
            loss_exp=t["loss_exp"], reg_coeff=t["reg_coeff"], clip_grad=opt["clip_grad"],
            clip_after_step=self.clip_after, num_clips=1,
            mask_mode="fixed", seed=int(t["seed"]))
        port_specs = [mb.MaskSpec.from_cfg(s) for s in ctx.cfg["masks"]]
        port_grid = mb.MaskGrid(self.grid.t, self.grid.h, self.grid.w)

        enc_w, pred_w = self.make_weights()
        encoder = vit.VisionTransformer(enc_cfg, device=dev)
        predictor = pred_mod.Predictor(pred_cfg, device=dev)
        load_leaves(encoder, enc_w, "encoder")
        load_leaves(predictor, pred_w, "predictor")
        del enc_w, pred_w
        self.state = step_mod.state_from_modules(encoder, predictor, step=self.clip_after)

        self.clips, self.masks = self.make_inputs(dtype)
        pool = self.masks
        self.step_fn = step_mod.build_train_step(
            enc_cfg, pred_cfg, train_cfg, *scheds, port_specs, port_grid, self.keep,
            mask_sampler=lambda step, b, d: pool[step % len(pool)])
        ctx.sync()
        parts["weights_inputs_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.followed = self.follow()
        parts["warmup_s"] = time.perf_counter() - t0

    def make_inputs(self, dtype):
        """The pool: ``pool_batches`` batches of normalized clips [B, T, H, W, 3]
        drawn on the device, and each batch's masks (every mask config's
        context and target indices) from the benchmark's sampler."""
        ctx, m = self.ctx, self.m
        gen = torch.Generator(device=ctx.device).manual_seed(W.derive_seed(ctx.seed, "clips"))
        shape = (self.pool_n, self.batch, m["num_frames"], m["img_size"], m["img_size"], 3)
        clips = torch.randn(shape, generator=gen, device=ctx.device, dtype=dtype)
        rng = np.random.default_rng(W.derive_seed(ctx.seed, "masks"))
        masks = []
        for _ in range(self.pool_n):
            me, mp = M.sample_step(rng, self.batch, self.specs, self.grid, self.keep)
            masks.append(([torch.from_numpy(x).to(ctx.device) for x in me],
                          [torch.from_numpy(x).to(ctx.device) for x in mp]))
        return clips, masks

    def make_weights(self):
        ctx = self.ctx
        enc = W.make(W.encoder_leaves(self.m), W.derive_seed(ctx.seed, "encoder"), ctx.device)
        pred = W.make(W.predictor_leaves(self.m, self.pr, len(self.specs)),
                      W.derive_seed(ctx.seed, "predictor"), ctx.device)
        return enc, pred

    def _update(self):
        state = self.state
        self.state, self.metrics = self.step_fn(state,
                                                {"clips": self.clips[state.step % self.pool_n]})
        return float(self.metrics["loss"])

    def follow(self) -> dict:
        """The first updates, which the reference follows: each loss, the
        first gradient's per-leaf norms (from the moments after one update)
        and every leaf's change, kept on the host."""
        state = self.state
        p0 = {k: v.detach().clone() for k, v in state.named_params().items()}
        losses, grad_norms, grads, module_norms = [], {}, {}, []
        for i in range(self.checked):
            losses.append(self._update())
            module_norms.append((float(self.metrics["enc_grad_norm"]),
                                 float(self.metrics["pred_grad_norm"])))
            if i == 0:
                mu = self.state.mu
                grads = to_host({k: v / (1.0 - B1) for k, v in mu.items()})
                norms = torch._foreach_norm(list(mu.values()))
                grad_norms = {k: float(n) / (1.0 - B1) for k, n in zip(mu, norms)}
        deltas = {k: v.detach() - p0[k] for k, v in self.state.named_params().items()}
        for k, v in self.state.target.named_parameters():
            deltas[f"target.{k}"] = v.detach() - p0[f"encoder.{k}"]
        del p0
        deltas = to_host(deltas)
        return {"losses": losses, "grad_norms": grad_norms, "grads": grads, "deltas": deltas,
                "module_norms": module_norms}

    # ---- measured work ------------------------------------------------------
    def window(self, seconds: float) -> dict:
        self.ctx.sync()
        t0 = time.perf_counter()
        n = failed = 0
        while True:
            loss = self._update()
            n += 1
            failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"kind": "pretrain", "units": n, "failed": failed, "items": n * self.batch,
                "window_s": elapsed, "flops": n * self.flops_per_update}

    def run_units(self, n: int) -> dict:
        for _ in range(n):
            self._update()
        return {"units": n, "items": n * self.batch, "attn_bound_ms": n * self.attn_bound_per_update,
                "fc1_bound_ms": None}

    def release(self) -> None:
        self.state = self.step_fn = self.metrics = None

    # ---- correctness --------------------------------------------------------
    def reference_numbers(self, num: Numerics) -> dict:
        """The followed updates through the reference with ``num``'s
        products: losses, first-gradient norms, changes, exclusion masks."""
        ref = self.ctx.cfg["reference"]
        enc, pred = self.make_weights()
        batches = [(self.clips[i % self.pool_n], *self.masks[i % self.pool_n])
                   for i in range(self.clip_after, self.clip_after + self.checked)]
        seen = {}

        def first(tr):
            grads = {k: p.grad.detach().clone() for k, p in tr.params.items()}
            seen["grads"] = grads
            seen["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
            seen["keep"] = compare.exclusion_masks(grads)

        with fp32_exact():
            out = ref_train.run(self.ctx.cfg, enc, pred, batches, num, rows=ref["train_rows"],
                                start_step=self.clip_after, on_first_grads=first)
        st = out["trainer"].state()
        origin = {**{f"encoder.{k}": v for k, v in enc.items()},
                  **{f"predictor.{k}": v for k, v in pred.items()},
                  **{f"target.{k}": v for k, v in enc.items()}}
        deltas = {k: st[k] - origin[k] for k in st}
        return {"losses": out["losses"], "grad_norms": seen["grad_norms"], "grads": seen["grads"],
                "deltas": deltas, "keep": seen["keep"], "module_norms": out["module_norms"]}

    def numbers(self, got: dict, ref: dict) -> dict:
        dev = self.ctx.device
        prog_change = compare.change_norms(got["deltas"], ref["keep"], dev)
        ref_change = compare.change_norms(ref["deltas"], ref["keep"], dev)
        grad, grad_leaf = compare.relative_leaf_gap(got["grad_norms"], ref["grad_norms"])
        change, change_leaf = compare.relative_leaf_gap(prog_change, ref_change)
        diff, diff_leaf = compare.diff_leaf_gap(got["grads"], ref["grads"], ref["keep"], dev)
        return {"loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
                "grad_gap": grad, "change_gap": change, "grad_diff": diff,
                "_where": f"grad {grad_leaf}, change {change_leaf}, diff {diff_leaf}; losses {got['losses']} vs "
                          f"reference {ref['losses']}; from step {self.clip_after}, the program's "
                          f"pre-clip gradient norms (encoder, predictor) "
                          f"{got.get('module_norms')} vs the reference's {ref['module_norms']}"}

    def check(self) -> dict:
        ref = self.reference_numbers(Numerics("fp32"))
        return self.numbers(self.followed, ref)
