"""Video-classification serving traffic: a closed loop with one client. Each
request is one video under the multi-view protocol: ``views`` views of each
of S segments, S from ``segments``, so B = views * S uint8 clips
[B, T, H, W, 3] as numpy on the host; the client hands them to the port's
``api.VideoClassifier.classify`` (a frozen encoder and an attentive probe,
built as ``api.load_encoder`` / ``load_classifier`` build them, from the
seed's weights in memory), takes the probabilities to the host and averages
the views. A request's latency runs from handing in the clips to that
average.

The pool holds ``per_size`` requests of each S in an order drawn from the
seed, so every seed gives the same work; the window cycles through it.
Set-up warms each B once. After the window the program is freed and the
fp32 reference classifies one pool entry of each S, drawn from the seed;
every answer the program gave for those entries is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, flops, weights as W
from portbench.program import check_dims, load_leaves, port
from portbench.reference import vjepa
from portbench.reference.numerics import Numerics, fp32_exact


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.cfg, ctx.traffic
        self.m, self.pb = cfg["model"], cfg["probe"]
        self.views = int(tr["views"])
        sizes = [s for s in tr["segments"] for _ in range(int(tr["per_size"]))]
        rng = np.random.default_rng(W.derive_seed(ctx.seed, "order"))
        self.order = [sizes[i] for i in rng.permutation(len(sizes))]
        m = self.m
        self.n = (m["num_frames"] // m["tubelet_size"]) * (m["img_size"] // m["patch_size"]) ** 2
        self.flops_per_clip = flops.serve_flops_per_clip(
            dim=m["embed_dim"], depth=m["depth"], mlp_ratio=m["mlp_ratio"], n=self.n,
            patch_dim=3 * m["tubelet_size"] * m["patch_size"] ** 2,
            num_classes=self.pb["num_classes"], probe_mlp_ratio=self.pb["mlp_ratio"])
        self.answers = {}  # pool index -> [probabilities of each time it was served]
        self.next = 0

    def attn_bound_ms(self, b: int) -> float:
        m = self.m
        return m["depth"] * flops.attn_fwd_bound_ms(b, self.n, m["num_heads"],
                                                    m["embed_dim"] // m["num_heads"])

    def fc1_bound_ms(self, b: int) -> float:
        m = self.m
        d = m["embed_dim"]
        return m["depth"] * flops.fc1_bound_ms(b * self.n, d, int(d * m["mlp_ratio"]))

    # ---- set-up -------------------------------------------------------------
    def setup(self, parts: dict) -> None:
        ctx, m, pb = self.ctx, self.m, self.pb
        dev = ctx.device
        t0 = time.perf_counter()
        api, factory = port("api"), port("models.factory")
        vit, attentive, transformer = (port("models.vit"), port("models.attentive"),
                                       port("models.transformer"))
        parts["import_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if dev.type == "cuda":
            port("ops._build").load_library()
        parts["library_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cd = {"bfloat16": torch.bfloat16, "float32": torch.float32}[ctx.cfg["serve"]["dtype"]]
        cfg = factory.vit_cfg(m["name"], img_size=m["img_size"], patch_size=m["patch_size"],
                              num_frames=m["num_frames"], tubelet_size=m["tubelet_size"],
                              uniform_power=m["uniform_power"], compute_dtype=cd)
        check_dims(cfg, m, ctx.cfg["name"])
        enc_w, probe_w = self.make_weights(cd)
        model = vit.VisionTransformer(cfg, device=dev)
        load_leaves(model, enc_w, "encoder")
        acfg = attentive.AttentiveCfg(embed_dim=m["embed_dim"], num_heads=m["num_heads"],
                                      depth=pb["depth"], num_classes=pb["num_classes"],
                                      compute_dtype=cd)
        clf = attentive.AttentiveClassifier(acfg, device=dev)
        load_leaves(clf, probe_w, "probe")
        del enc_w, probe_w
        enc = api.Encoder(model=transformer.cast_matmul_weights_(model, cd), cfg=cfg)
        self.clf = api.VideoClassifier(encoder=enc,
                                       classifier=transformer.cast_matmul_weights_(clf, cd),
                                       acfg=acfg)
        self.pool = self.make_pool()
        ctx.sync()
        parts["weights_inputs_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for s in sorted(set(self.order)):
            self._classify(self.pool[self.order.index(s)])
        parts["warmup_s"] = time.perf_counter() - t0

    def make_pool(self):
        """Every request's uint8 clips, drawn on the device, as host numpy."""
        ctx, m = self.ctx, self.m
        gen = torch.Generator(device=ctx.device).manual_seed(W.derive_seed(ctx.seed, "clips"))
        shape = (m["num_frames"], m["img_size"], m["img_size"], 3)
        return [torch.randint(0, 256, (self.views * s, *shape), generator=gen,
                              device=ctx.device, dtype=torch.uint8).cpu().numpy()
                for s in self.order]

    def make_weights(self, matrix_dtype):
        ctx = self.ctx
        enc = W.make(W.encoder_leaves(self.m), W.derive_seed(ctx.seed, "encoder"), ctx.device,
                     matrix_dtype)
        probe = W.make(W.probe_leaves(self.m, self.pb), W.derive_seed(ctx.seed, "probe"),
                       ctx.device, matrix_dtype)
        return enc, probe

    def _classify(self, clips: np.ndarray):
        probs = self.clf.classify(clips).cpu().numpy()
        return probs, probs.mean(axis=0)  # the client averages the views and segments

    def _request(self):
        i = self.next % len(self.pool)
        self.next += 1
        t0 = time.perf_counter()
        probs, _ = self._classify(self.pool[i])
        lat = time.perf_counter() - t0
        self.answers.setdefault(i, []).append(probs)
        ok = probs.shape == (self.pool[i].shape[0], self.pb["num_classes"]) and \
            bool(np.isfinite(probs).all())
        return i, lat, ok

    # ---- measured work ------------------------------------------------------
    def window(self, seconds: float) -> dict:
        self.ctx.sync()
        t0 = time.perf_counter()
        lats, items, failed, n = [], 0, 0, 0
        while True:
            i, lat, ok = self._request()
            n += 1
            lats.append(lat)
            items += self.pool[i].shape[0]
            failed += not ok
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"kind": "serve_video", "units": n, "failed": failed, "items": items,
                "window_s": elapsed, "latencies_s": lats, "flops": items * self.flops_per_clip}

    def run_units(self, n: int) -> dict:
        items = attn = fc1 = 0
        for _ in range(n):
            i, _, _ = self._request()
            b = self.pool[i].shape[0]
            items += b
            attn += self.attn_bound_ms(b)
            fc1 += self.fc1_bound_ms(b)
        return {"units": n, "items": items, "attn_bound_ms": attn, "fc1_bound_ms": fc1}

    def release(self) -> None:
        self.clf = None

    # ---- correctness --------------------------------------------------------
    def checked_entries(self):
        """One served pool entry of each segment count (the longest among
        them), drawn from the seed."""
        rng = np.random.default_rng(W.derive_seed(self.ctx.seed, "check"))
        out = []
        for s in sorted(set(self.order)):
            idx = [i for i, x in enumerate(self.order) if x == s and self.answers.get(i)]
            if idx:
                out.append(idx[int(rng.integers(len(idx)))])
        return out

    def reference_probs(self, num: Numerics, entries):
        enc, probe = self.make_weights(torch.float32)
        rows = self.ctx.cfg["reference"]["serve_rows"]
        with fp32_exact():
            return {i: vjepa.classify(num, enc, probe, self.m, self.pb,
                                      torch.from_numpy(self.pool[i]).to(self.ctx.device), rows)
                    for i in entries}

    def check(self) -> dict:
        entries = self.checked_entries()
        ref = self.reference_probs(Numerics("fp32"), entries)
        gap = max(compare.serve_gap(self.answers[i], ref[i]) for i in entries)
        served = {self.pool[i].shape[0]: len(self.answers[i]) for i in entries}
        return {"logp_gap": gap, "_where": f"clips per request: times served {served}"}
