"""Nothing the harness loads has the top-level name jax, jaxlib, flax or
neuray_tpu (compared whole: the port's name begins with the JAX
package's)."""
import subprocess
import sys

from pb import core

PROBE = r"""
import sys
sys.path[:0] = [{here!r}, {root!r}]
from pb import core, counts, frames, program, readers, scene, trace
from reference import model, train
for d in ("traffic", "metrics"):
    for f in sorted((core.HERE / d).glob("*.py")):
        core.load_module(f, d + "_" + f.stem.replace(".", "_"))
import neuray_tpu_torch.models.renderer, neuray_tpu_torch.train.trainer
import neuray_tpu_torch.utils.params, neuray_tpu_torch.utils.device
print(",".join(core.forbidden_modules()) or "clean")
"""


def test_no_jax_module_is_loaded():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(here=str(core.HERE),
                                            root=str(core.ROOT))],
        capture_output=True, text=True, timeout=300, cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"


def test_the_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "neuray_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    found = core.forbidden_modules()
    assert "jaxlib.xla" in found and "neuray_tpu_torch_x" not in found
