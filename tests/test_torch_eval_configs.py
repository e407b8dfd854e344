"""The shipped eval configs that chip_smoke.py drives on the card stand for
the ones it does not.

ViT-H's image evals: the card runs ``chip_smoke.VITH_IMAGE_EVALS``, one
config per resolution (vith16_in1k.yaml at 224 px, vith16_384_inat.yaml at
384 px). Each of the other four ``vith16{,_384}_{in1k,places,inat}.yaml``
may differ from the driven config of its resolution only in ``tag``,
``data.num_classes``, ``data.image_folder`` and ``data.dataset_name``, so a
config that differs in geometry, batch, model or optimization cannot hide
behind them. The SSv2 evals: the card runs every ``*_ssv2_16x2x3.yaml``;
each differs from the K400 16x8x3 config of its model, which the card
also runs, only in its tag, manifests, classes and segments.
"""

import pathlib

import pytest
import yaml

import chip_smoke

_EVALS = pathlib.Path(__file__).resolve().parent.parent / "configs" / "evals"
_IMAGE_KEYS = {"tag", "data.num_classes", "data.image_folder", "data.dataset_name"}
_SSV2_KEYS = {"tag", "data.dataset_train", "data.dataset_val", "data.num_classes",
              "data.num_segments"}


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _load(name):
    return _flat(yaml.safe_load((_EVALS / name).read_text()))


def _differ(a, b):
    return {k for k in set(a) | set(b) if a.get(k, KeyError) != b.get(k, KeyError)}


def _resolution(name):
    return _load(name)["data.resolution"]


_DRIVEN = {_resolution(c): c for c in chip_smoke.VITH_IMAGE_EVALS}
_IMAGE = sorted(f"vith16{r}_{d}.yaml" for r in ("", "_384") for d in ("in1k", "places", "inat"))


def test_driven_image_evals_cover_both_resolutions():
    assert sorted(_DRIVEN) == [224, 384]
    assert set(chip_smoke.VITH_IMAGE_EVALS) <= set(_IMAGE)
    assert sorted(p.name for p in _EVALS.glob("vith16*.yaml")
                  if "k400" not in p.name and "ssv2" not in p.name) == _IMAGE


@pytest.mark.parametrize("name", _IMAGE)
def test_vith_image_eval_differs_from_the_driven_one_only_in_data(name):
    driven = _DRIVEN[_resolution(name)]
    got = _differ(_load(name), _load(driven))
    if name == driven:
        assert not got
    else:
        assert got <= _IMAGE_KEYS, (name, driven, got - _IMAGE_KEYS)
        assert "data.num_classes" in got or "data.image_folder" in got


@pytest.mark.parametrize("name", sorted(p.name for p in _EVALS.glob("*_ssv2_16x2x3.yaml")))
def test_ssv2_eval_differs_from_k400_only_in_data(name):
    assert name in (chip_smoke.SSV2_EVAL_L, *chip_smoke.SSV2_EVALS_H)
    k400 = name.replace("_ssv2_16x2x3", "_k400_16x8x3")
    assert k400 in (chip_smoke.VITH_EVALS + ("vitl16_k400_16x8x3.yaml",))
    ssv2 = _load(name)
    assert _differ(ssv2, _load(k400)) <= _SSV2_KEYS
    assert (ssv2["data.num_classes"], ssv2["data.num_segments"]) == (174, 2)
