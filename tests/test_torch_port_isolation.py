"""The port imports nothing of JAX: in a fresh interpreter, import every
module of ``neuray_tpu_torch`` and ``chip_smoke``, then neither ``jax``
nor any module of the JAX package may be loaded. The card's machine has
no JAX, so a stray import would otherwise show only there, at run
time."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, json, pkgutil, sys
import neuray_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    neuray_tpu_torch.__path__, "neuray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax"))
    or m == "neuray_tpu" or m.startswith("neuray_tpu."))}))
"""


def test_the_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                              "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    record = json.loads(out.stdout.strip().splitlines()[-1])
    assert "chip_smoke" in record["imported"]
    for name in ("neuray_tpu_torch.check_skip_quality",
                 "neuray_tpu_torch.check_bf16_quality",
                 "neuray_tpu_torch.check_trajectory_escalation",
                 "neuray_tpu_torch.make_bench_weights",
                 "neuray_tpu_torch.render", "neuray_tpu_torch.parallel.spawn",
                 "neuray_tpu_torch.utils.profiling",
                 "neuray_tpu_torch.diag_probe_score",
                 "neuray_tpu_torch.profile_encode",
                 "neuray_tpu_torch.profile_skip_phases",
                 "neuray_tpu_torch.profile_stages",
                 "neuray_tpu_torch.bench_input_pipeline"):
        assert name in record["imported"]
    assert record["loaded"] == [], record["loaded"]


def test_the_tools_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a CUDA device and without ``--device cpu``, each of the
    quality, diagnostic and profiling tools and the trainer raises before
    it builds a model."""
    import pytest
    import torch

    from neuray_tpu_torch import (
        check_bf16_quality, check_skip_quality, check_trajectory_escalation,
        diag_probe_score, make_bench_weights, profile_encode,
        profile_skip_phases, profile_stages)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (check_skip_quality, check_bf16_quality,
                 check_trajectory_escalation, make_bench_weights,
                 diag_probe_score, profile_encode, profile_skip_phases,
                 profile_stages):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main([])
