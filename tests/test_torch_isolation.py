"""repro_torch stands alone: importing every one of its modules pulls in
neither jax nor the JAX reference package ``repro``."""
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    # every module and subpackage: each .py file but the top __init__
    expected = len(list((SRC / "repro_torch").rglob("*.py"))) - 1
    assert n_modules == expected >= 20


_RUN_PROBE = """
import sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline, sns_dryrun
cfg = get_config("tinyllama-1.1b", smoke=True)
rec = dryrun.record(cfg, "decode", 4, 32, (2, 2), ("data", "model"))
rec.update(arch="tinyllama-1.1b", shape="decode", mesh="(2,2)")
assert roofline.roofline_terms(rec)["status"] == "ok"
assert sns_dryrun.cost(per_device=1024, rows=4, log2_cols=8,
                       top_k=16)["counts"]["collective_ops"] > 0
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(leaked)
assert not leaked, leaked
"""


def test_dry_run_tooling_runs_without_jax_or_repro():
    """The dry run, its roofline and the SnS dry run import what they
    need (the fake process group, the FLOP counter) when they run: a
    run of each pulls in neither jax nor ``repro``."""
    out = subprocess.run([sys.executable, "-c", _RUN_PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=240,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
