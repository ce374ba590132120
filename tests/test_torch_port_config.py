"""The port's YAML reader (``neuray_tpu_torch/utils/config.py``) against
PyYAML's ``FullLoader`` (``neuray_tpu/utils/config.py: load_cfg``): equal
on every file under ``configs/``, recursively, and on scalars and
structures of the subset; constructs outside the subset raise."""
import math
from pathlib import Path

import pytest
import yaml

from neuray_tpu.utils.config import load_cfg as jax_load_cfg
from neuray_tpu_torch.utils.config import load_cfg, loads, merge_cfg

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "configs").rglob("*") if p.is_file())


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_equals_pyyaml(path):
    ours = load_cfg(str(ROOT / path))
    assert ours == jax_load_cfg(str(ROOT / path))
    assert type(ours) is type(jax_load_cfg(str(ROOT / path)))


def test_configs_cover_both_kinds_of_file():
    assert any(p.startswith("configs/inter_trajectory") for p in CONFIGS)
    assert any(p.startswith("configs/train/gen") for p in CONFIGS)


SUBSET = [
    "a: 1e-4", "a: 4.0e-4", "a: 4.0e4", "a: 1.5", "a: .5", "a: -3",
    "a: 0x1f", "a: 017", "a: 0b11", "a: 1_000", "a: 1:30", "a: 1:30.5",
    "a: yes", "a: Off", "a: ~", "a:", "a: null", "a: 'it''s'",
    'a: "x\\ty"', "a: [1, 'b', [c, {d: 2.0}], ]",
    "a: {x: [1,2], y: {z: true}}", "a:\n- 1\n- 2",
    "a:\n  - b: 1\n    c: 2\n  - d", "- a\n- b: 1\n  c:\n    - x",
    "x: http://a.b/c", "x: a#b", "x: a # c", "'q k': 1", "1: a",
    "x: .inf", "x: -.Inf", "x: +1", "l:\n  -\n    name: s\n    cfg:\n"
    "      r: 4", "x: [a b, c]", "x: 0", "x: -0", "x: 00", "x: 08",
    "x: 1.", "x: 2e5", "x: True", "k: v  ", "x: a:b",
    "x: {a: 1, b: [x, y]}  # c", "# only a comment\n", "12\n45\n59",
    "scan24\nscan40", "x: .nan"]


@pytest.mark.parametrize("text", SUBSET)
def test_subset_equals_pyyaml(text):
    ours, theirs = loads(text), yaml.load(text, Loader=yaml.FullLoader)
    if isinstance(theirs, dict) and any(
            isinstance(v, float) and math.isnan(v) for v in theirs.values()):
        assert math.isnan(ours["x"])
        return
    assert ours == theirs
    assert type(ours) is type(theirs)


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
    "a: 2001-01-01", "---\na: 1", "a: [1,\n 2]", "? a\n: b", "a: {b}",
    "a: 1\n  b: 2", "a:\n\tb: 1", "x: -", "a: 'open", "a: [1, 2"])
def test_outside_the_subset_raises(text):
    with pytest.raises((NotImplementedError, ValueError)):
        loads(text)


def test_merge_cfg():
    assert merge_cfg({"a": 1, "b": 2}, {"b": 3}) == {"a": 1, "b": 3}
