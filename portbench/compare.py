"""The numbers that decide `correct`, each a gap between the program (or the
control in its place) and the fp32 reference on the same inputs.

Pretraining (worst leaf, per the benchmark's contract):
  * ``loss_gap``: max over the followed updates of |L - L_ref| / |L_ref|;
  * ``grad_gap``: the first update's gradient as the optimizer gets it, per
    leaf |‖g‖ - ‖g_ref‖| / max(‖g_ref‖, the median leaf's ‖g_ref‖);
  * ``change_gap``: the parameters' change over the followed updates, per
    leaf of the encoder, the predictor and the target, the same measure.
    Elements whose first reference gradient is under a thousandth of the
    median leaf's RMS gradient (a key's bias under softmax: zero but for
    rounding, moved by Adam on noise alone) are left out of both sides.
Serving:
  * ``logp_gap``: max over the checked answers, clips and classes of
    |log p - log p_ref|.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's RMS first gradient


def relative_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]):
    """(worst gap, its leaf) of per-leaf norms."""
    med = statistics.median(ref.values())
    worst, leaf = 0.0, None
    for k, r in ref.items():
        g = abs(prog[k] - r) / max(r, med, 1e-30)
        if g > worst or leaf is None:
            worst, leaf = g, k
    return worst, leaf


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def exclusion_masks(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{leaf: bool mask of the kept elements} for leaves with elements under
    the threshold (``EXCLUDE_BELOW`` of the median leaf's RMS gradient)."""
    rms = {k: float(g.norm()) / g.numel() ** 0.5 for k, g in grads.items()}
    thr = EXCLUDE_BELOW * statistics.median(rms.values())
    out = {}
    for k, g in grads.items():
        keep = g.abs() >= thr
        if not bool(keep.all()):
            out[k] = keep
    return out


def change_norms(deltas: Dict[str, torch.Tensor], keep: Dict[str, torch.Tensor],
                 device) -> Dict[str, float]:
    """Per-leaf norms of the parameters' change; ``keep`` names masks by
    "encoder.*" / "predictor.*" leaves (a target leaf takes its encoder
    leaf's)."""
    out = {}
    for k, d in deltas.items():
        src = "encoder." + k[len("target."):] if k.startswith("target.") else k
        d = d.to(device, torch.float32)
        if src in keep:
            d = d[keep[src]]
        out[k] = float(d.norm())
    return out


def diff_leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  keep: Dict[str, torch.Tensor], device):
    """(worst, its leaf) of ‖g - g_ref‖ / max(‖g_ref‖, the median leaf's
    ‖g_ref‖) over the leaves of the first gradient, the excluded elements
    left out."""
    norms, diffs = {}, {}
    for k, r in ref.items():
        g = got[k].to(device, torch.float32)
        r = r.to(device, torch.float32)
        if k in keep:
            g, r = g[keep[k]], r[keep[k]]
        norms[k], diffs[k] = float(r.norm()), float((g - r).norm())
    med = statistics.median(norms.values())
    leaf = max(norms, key=lambda k: diffs[k] / max(norms[k], med, 1e-30))
    return diffs[leaf] / max(norms[leaf], med, 1e-30), leaf


def serve_gap(answers: List[torch.Tensor], ref: torch.Tensor) -> float:
    """Max |log p - log p_ref| over the answers given for one input."""
    lr = ref.double().clamp(min=1e-300).log()
    worst = 0.0
    for a in answers:
        a = torch.as_tensor(a).to(ref.device).double()
        if a.shape != ref.shape or not bool(torch.isfinite(a).all()):
            return float("inf")
        worst = max(worst, float((a.clamp(min=1e-300).log() - lr).abs().max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """([[name, value, limit], ...] in the limits' order, whether all hold)."""
    rows = [[k, numbers.get(k, float("inf")), float(v)] for k, v in limits.items()]
    ok = all(r[1] == r[1] and r[1] <= r[2] for r in rows)
    return rows, ok
