"""core/config.py: overrides on the port's PipelineConfig against the JAX
package's on its own, nested, from a TOML file, from a JSON file and from
dotted strings; an unknown key raises in both."""
import json

import pytest

from hamer_yolo_tpu.core import config as jconfig
from hamer_yolo_tpu.pipeline.frame import PipelineConfig as JP
from hamer_yolo_tpu_torch.core import config as tconfig
from hamer_yolo_tpu_torch.pipeline.frame import PipelineConfig as TP

# Fields one package has and the other has not: JAX's HamerConfig has the
# image normalisation (a constant of the port's crop), the port's ViTConfig
# the K2-or-plain switch. (Both ViTs have the drop-path rate of training's
# stochastic depth.)
ONLY_JAX = {("hamer", "image_mean"), ("hamer", "image_std")}
ONLY_PORT = {("hamer", "vit", "fused_attn")}

NESTED = {"conf_thres": 0.3, "tta": True, "hamer": {"tome_r": 4, "vit": {"depth": 2}},
          "yolo": {"nc": 1, "nkpt": 5}, "sar": {"input_size": 128}}
DOTTED = ["hamer.tome_r=4", "conf_thres=0.3", "tta=true", "yolo.compute_dtype=float32",
          "hamer.vit.num_heads=8", "max_nms_static=1024"]
TOML = """conf_thres = 0.3
tta = true

[hamer]
tome_r = 4

[hamer.vit]
depth = 2

[yolo]
bin_count = 11
"""


def _flat(d, path=()):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): v})
    return out


def _same(tcfg, jcfg):
    t, j = _flat(tconfig.config_to_dict(tcfg)), _flat(jconfig.config_to_dict(jcfg))
    assert set(j) - set(t) == ONLY_JAX and set(t) - set(j) == ONLY_PORT
    assert {k: t[k] for k in j if k in t} == {k: j[k] for k in j if k in t}


def test_defaults_agree():
    _same(TP(), JP())


@pytest.mark.parametrize("source", ["nested", "toml", "json", "dotted"])
def test_overrides_match_jax(source, tmp_path):
    if source == "nested":
        ov_t = ov_j = NESTED
    elif source == "dotted":
        ov_t, ov_j = tconfig.overrides_from_dotted(DOTTED), jconfig.overrides_from_dotted(DOTTED)
        assert ov_t == ov_j
    else:
        path = tmp_path / f"cfg.{source}"
        path.write_text(TOML if source == "toml" else json.dumps(NESTED))
        ov_t, ov_j = tconfig.load_config_file(str(path)), jconfig.load_config_file(str(path))
        assert ov_t == ov_j
    tcfg, jcfg = tconfig.apply_overrides(TP(), ov_t), jconfig.apply_overrides(JP(), ov_j)
    _same(tcfg, jcfg)
    assert tcfg.conf_thres == 0.3 and tcfg.hamer.tome_r == 4 and tcfg != TP()
    assert "conf_thres" in tconfig.describe(tcfg)


@pytest.mark.parametrize("bad", [{"conf_thresh": 0.3}, {"hamer": {"vit": {"dept": 2}}}],
                         ids=["top", "nested"])
def test_unknown_key_raises(bad):
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.apply_overrides(TP(), bad)
    with pytest.raises(KeyError, match="unknown config key"):
        jconfig.apply_overrides(JP(), bad)
