"""Offline zoo-checkpoint conversion: reference ``.pth.tar`` -> orbax
(counterpart of jepa_tpu/utils/port_cli.py), with no JAX, orbax or
tensorstore.

Convert once and point an eval's ``pretrain.checkpoint`` (the port's or
the JAX package's) at the resulting ``<tag>-latest`` directory:

    python -m jepa_tpu_torch.utils.port_cli zoo/vitl16.pth.tar out/ \
        --model vit_large --patch-size 16 --num-frames 16 --uniform-power

The encoder is read strictly (``checkpoint_port.load_pretrained_encoder``),
turned into the JAX package's stacked layout (``encoder_state_to_jax``)
and written by ``utils.orbax.save_tree`` under BOTH ``target`` and
``params/encoder``, with an int32 ``epoch`` of 0: the tree
jepa_tpu/utils/checkpoint.py's ``save_checkpoint`` writes, so eval configs
with either ``checkpoint_key: target_encoder`` or ``encoder`` restore it.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def convert(src: str, dst_folder: str, model: str, patch_size: int,
            num_frames: int, tubelet_size: int, img_size: int,
            uniform_power: bool, checkpoint_key: str, tag: str) -> str:
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.utils import orbax
    from jepa_tpu_torch.utils.checkpoint_port import encoder_state_to_jax, load_pretrained_encoder

    cfg = vit_cfg(model, img_size=img_size, patch_size=patch_size, num_frames=num_frames,
                  tubelet_size=tubelet_size, uniform_power=uniform_power)
    params = encoder_state_to_jax(load_pretrained_encoder(src, cfg, checkpoint_key).state_dict())
    path = os.path.join(os.path.abspath(dst_folder), f"{tag}-latest")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    orbax.save_tree(path, {"target": params, "params": {"encoder": params},
                           "epoch": np.int32(0)})
    logger.info("wrote %s", path)
    return path


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="reference .pth.tar checkpoint")
    ap.add_argument("dst", help="output folder for the orbax checkpoint")
    ap.add_argument("--model", required=True,
                    help="factory name, e.g. vit_large / vit_huge")
    ap.add_argument("--patch-size", type=int, default=16)
    ap.add_argument("--num-frames", type=int, default=16)
    ap.add_argument("--tubelet-size", type=int, default=2)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--uniform-power", action="store_true")
    ap.add_argument("--checkpoint-key", default="target_encoder")
    ap.add_argument("--tag", default="ported")
    a = ap.parse_args(argv)
    path = convert(a.src, a.dst, a.model, a.patch_size, a.num_frames,
                   a.tubelet_size, a.img_size, a.uniform_power,
                   a.checkpoint_key, a.tag)
    print(path)


if __name__ == "__main__":
    main()
