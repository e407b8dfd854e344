"""V-JEPA predictor: a narrow ViT that predicts target latents at masked
positions from context tokens (counterpart of jepa_tpu/models/predictor.py).

  * linear embed, encoder dim -> predictor dim;
  * per-mask-config learnable mask tokens, picked by
    ``mask_index % num_mask_tokens``, or, with ``use_mask_tokens=False``
    (diffusion mode, reference predictor.py:154-172), the embedded target
    features noised by one forward-diffusion step (``_diffusion_noise``);
  * the frozen sincos pos-embed gathered at the context and target
    indices;
  * ``depth`` pre-LN blocks over [context || mask tokens or noised targets];
  * final LayerNorm and projection back to the encoder dim, returned at
    the target positions, fp32.

One call handles one (mask_enc, mask_pred) pair; the multimask loop
composes calls. The module carries the reference zoo's state_dict names
(``predictor_embed``, ``mask_tokens.{k}`` of shape [1, 1, Dp],
``predictor_blocks.{i}``, ``predictor_norm``, ``predictor_proj``, the
``predictor_pos_embed`` buffer), so a zoo predictor can load; in diffusion
mode it has no ``mask_tokens``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from jepa_tpu_torch.models.initializers import init_layernorm_, init_linear_, trunc_normal
from jepa_tpu_torch.models.pos_embed import (
    get_2d_sincos_pos_embed,
    get_3d_sincos_pos_embed,
)
from jepa_tpu_torch.models.transformer import Block, BlockCfg, layer_norm, linear, run_blocks
from jepa_tpu_torch.ops.masking import gather_tokens


@dataclasses.dataclass(frozen=True)
class PredictorCfg:
    img_size: int = 224
    patch_size: int = 16
    num_frames: int = 16
    tubelet_size: int = 2
    embed_dim: int = 768            # encoder dim (input and output)
    predictor_embed_dim: int = 384
    depth: int = 6
    num_heads: int = 12             # the encoder's head count
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    init_std: float = 0.02
    uniform_power: bool = False
    use_mask_tokens: bool = True
    num_mask_tokens: int = 2
    zero_init_mask_tokens: bool = True
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    remat: object = False  # False | True/'full' | 'attn' (``transformer.run_blocks``)

    @property
    def is_video(self) -> bool:
        return self.num_frames > 1

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def grid_depth(self) -> int:
        return self.num_frames // self.tubelet_size if self.is_video else 1

    @property
    def num_patches(self) -> int:
        n = self.grid_size * self.grid_size
        return n * self.grid_depth if self.is_video else n

    def block_cfg(self) -> BlockCfg:
        return BlockCfg(
            dim=self.predictor_embed_dim,
            num_heads=self.num_heads,
            mlp_hidden=int(self.predictor_embed_dim * self.mlp_ratio),
            ln_eps=self.ln_eps,
            compute_dtype=self.compute_dtype,
            attn_impl=self.attn_impl,
        )


def predictor_sincos_table(cfg: PredictorCfg) -> torch.Tensor:
    """The predictor's frozen pos-embed, [1, N, Dp] fp32."""
    dp = cfg.predictor_embed_dim
    if cfg.is_video:
        pe = get_3d_sincos_pos_embed(dp, cfg.grid_size, cfg.grid_depth,
                                     uniform_power=cfg.uniform_power)
    else:
        pe = get_2d_sincos_pos_embed(dp, cfg.grid_size)
    return torch.from_numpy(pe.astype("float32"))[None]


DIFFUSION_STEPS = 1000
DIFFUSION_BETA = (0.5, 1.0)


def diffusion_draws(generator: torch.Generator, shape, device,
                    steps: int = DIFFUSION_STEPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """One diffusion step's random draws for features of ``shape`` [B, K,
    Dp]: a step t per sample, uniform in [0, steps), and standard normal
    noise n of ``shape``, fp32."""
    t = torch.randint(0, steps, (shape[0],), generator=generator, device=device)
    n = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return t, n


def _diffusion_noise(x: torch.Tensor, t: torch.Tensor, n: torch.Tensor,
                    noise_beta=DIFFUSION_BETA, steps: int = DIFFUSION_STEPS) -> torch.Tensor:
    """Forward-diffusion target noising (jepa_tpu/models/predictor.py::
    _diffusion_noise; reference predictor.py:154-172), in fp32: LayerNorm
    without affine (eps 1e-5), then sqrt(alpha_t) x + sqrt(1 - alpha_t) n,
    alpha the cumulative product of 1 - beta_i, beta_i = b1 + i (b2 - b1) /
    steps. Returns ``x``'s dtype."""
    b1, b2 = noise_beta
    betas = b1 + torch.arange(steps, dtype=torch.float32, device=x.device) * ((b2 - b1) / steps)
    alpha = torch.cumprod(1.0 - betas, dim=0)[t][:, None, None]
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + 1e-5)
    return (alpha.sqrt() * xf + (1.0 - alpha).sqrt() * n).to(x.dtype)


class Predictor(nn.Module):
    def __init__(self, cfg: PredictorCfg, device=None):
        super().__init__()
        self.cfg = cfg
        dp = cfg.predictor_embed_dim
        self.predictor_embed = nn.Linear(cfg.embed_dim, dp, device=device)
        self.mask_tokens = nn.ParameterList(
            nn.Parameter(torch.zeros(1, 1, dp, device=device))
            for _ in range(cfg.num_mask_tokens if cfg.use_mask_tokens else 0))
        self.register_buffer("predictor_pos_embed",
                             predictor_sincos_table(cfg).to(device))
        bc = cfg.block_cfg()
        self.predictor_blocks = nn.ModuleList(
            Block(bc, device=device) for _ in range(cfg.depth))
        self.predictor_norm = nn.LayerNorm(dp, eps=cfg.ln_eps, device=device)
        self.predictor_proj = nn.Linear(dp, cfg.embed_dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "Predictor":
        """Reference init (jepa_tpu/models/predictor.py::init_predictor)."""
        cfg = self.cfg
        init_linear_(self.predictor_embed, generator, cfg.init_std)
        for i, blk in enumerate(self.predictor_blocks):
            blk.init_weights(generator, i + 1, cfg.init_std)
        init_layernorm_(self.predictor_norm)
        init_linear_(self.predictor_proj, generator, cfg.init_std)
        for mt in self.mask_tokens:
            if cfg.zero_init_mask_tokens:
                mt.zero_()
            else:
                mt.copy_(trunc_normal(mt.shape, generator, std=cfg.init_std))
        return self

    def forward(self, ctxt, masks_ctxt, masks_tgt, mask_index: int = 0,
                kv_mask_ctxt=None, kv_mask_tgt=None, tgt=None, noise=None):
        return predictor_forward(self, ctxt, masks_ctxt, masks_tgt, mask_index=mask_index,
                                 kv_mask_ctxt=kv_mask_ctxt, kv_mask_tgt=kv_mask_tgt,
                                 tgt=tgt, noise=noise)


def init_predictor(cfg: PredictorCfg, generator: Optional[torch.Generator] = None,
                   device=None) -> Predictor:
    """A predictor with the reference init drawn from ``generator``."""
    return Predictor(cfg, device=device).init_weights(generator)


def predictor_forward(
    model: Predictor,
    ctxt: torch.Tensor,
    masks_ctxt: torch.Tensor,
    masks_tgt: torch.Tensor,
    mask_index: int = 0,
    cfg: Optional[PredictorCfg] = None,
    kv_mask_ctxt: Optional[torch.Tensor] = None,
    kv_mask_tgt: Optional[torch.Tensor] = None,
    tgt: Optional[torch.Tensor] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Predict target latents.

    ctxt: [B, K_c, D_enc] encoder outputs at the context positions;
    masks_ctxt / masks_tgt: [B, K_c] / [B, K_t] token indices into the full
    grid. kv_mask_ctxt / kv_mask_tgt ([B, K_c] / [B, K_t] bool, padded mask
    mode): the blocks' key mask is their concatenation, so the pads of the
    context sit in the middle of the sequence (jepa_tpu/models/predictor.py:180-191).
    Diffusion mode (``use_mask_tokens=False``) needs ``tgt`` [B, K_t, D_enc],
    the target features, and ``noise`` (t [B], n [B, K_t, Dp] fp32), the
    draws of ``diffusion_draws``. Returns [B, K_t, D_enc] fp32.
    """
    cfg = cfg or model.cfg
    cd = cfg.compute_dtype
    b = ctxt.shape[0]
    pe = model.predictor_pos_embed.float().expand(b, -1, -1)  # [B, N, Dp]

    x = linear(ctxt, model.predictor_embed, cd)
    x = (x.float() + gather_tokens(pe, masks_ctxt)).to(cd)
    n_ctxt = x.shape[1]
    if cfg.use_mask_tokens:
        pred = model.mask_tokens[mask_index % cfg.num_mask_tokens].float()  # [1, 1, Dp]
    else:
        if tgt is None or noise is None:
            raise ValueError("the diffusion-mode predictor needs tgt and noise")
        pred = _diffusion_noise(linear(tgt, model.predictor_embed, cd), *noise).float()
    pred = (pred + gather_tokens(pe, masks_tgt)).to(cd)
    seq = torch.cat([x, pred], dim=1)

    kv_mask = None
    if kv_mask_ctxt is not None or kv_mask_tgt is not None:
        ones = lambda k: torch.ones((b, k), dtype=torch.bool, device=seq.device)
        kv_mask = torch.cat([
            kv_mask_ctxt.bool() if kv_mask_ctxt is not None else ones(n_ctxt),
            kv_mask_tgt.bool() if kv_mask_tgt is not None else ones(masks_tgt.shape[1]),
        ], dim=1)

    out, _ = run_blocks(seq, model.predictor_blocks, cfg.block_cfg(), kv_mask=kv_mask,
                        remat=cfg.remat)
    out = layer_norm(out, model.predictor_norm, cfg.ln_eps)
    out = linear(out[:, n_ctxt:], model.predictor_proj, cd)
    return out.float()
