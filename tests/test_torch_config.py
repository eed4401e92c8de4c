"""The port's YAML configs (utils/config: load_config, flatten_config on
the port's own YAML reader) against ssak_tpu's (PyYAML): the same trees
from files, overrides and ${...} interpolation, with PyYAML's scalar types
(1e-4 without a dot stays a string; 1.0e-4 is a float; yes/on are true;
0x10 is 16; ~ is None)."""

import pytest

pytest.importorskip("yaml")

from ssak_tpu.utils.config import flatten_config as j_flatten, load_config as j_load  # noqa: E402
from ssak_tpu_torch.utils.config import flatten_config, load_config  # noqa: E402

CONFIG = """# trainer config
model:
  name: wav2vec2
  hidden: 768
  dropout: 0.1
  layers: [12, 24]
optim:
  lr: 1.0e-4
  lr_nodot: 1e-4
  warmup: ${train.steps}
  total: ${train.steps} * 2
  betas: {b1: 0.9, b2: 0.98}
train:
  steps: 1000
  name: run_${model.name}_${model.hidden}
  flags: [yes, off, ~, 0x10, 017, "quoted: ${model.name}", '1e3']
  out: ${nowhere.key}
  loop_a: ${train.loop_b}
  loop_b: ${train.loop_a}
  empty:
"""

OVERRIDES = [
    [],
    ["optim.lr=3e-4", "model.hidden=1024", "train.new.deep=true"],
    ["model.layers=[1, 2, 3]", "optim.betas={b1: 0.5}", "train.name=plain", "x='${model.name}'", "y=\"a: b\""],
    ["train.steps=20", "optim.warmup=${train.steps}", "z=", "w=null", "v=1:30", "u=.5", "t=-.inf"],
]


@pytest.mark.parametrize("i", range(len(OVERRIDES)))
def test_load_config_matches_jax(tmp_path, i):
    p = tmp_path / "c.yaml"
    p.write_text(CONFIG, encoding="utf-8")
    ref = j_load(str(p), overrides=OVERRIDES[i])
    got = load_config(str(p), overrides=OVERRIDES[i])
    assert got == ref
    assert repr(got) == repr(ref)  # the same types: 1e-4 a str, 1.0e-4 a float, 0x10 an int
    assert flatten_config(got) == j_flatten(ref)


def test_config_without_file_and_with_base():
    base = {"a": {"b": 1}, "c": "${a.b}"}
    for ov in ([], ["a.b=2", "d.e=${c}"]):
        assert load_config(None, overrides=ov, base=base) == j_load(None, overrides=ov, base=base)
    assert load_config(None) == j_load(None) == {}
    with pytest.raises(ValueError):
        load_config(None, overrides=["no_equals_sign"])
    with pytest.raises(ValueError):
        j_load(None, overrides=["no_equals_sign"])
