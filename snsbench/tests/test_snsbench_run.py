"""Whole runs of the cells at small sizes on the CPU: the result line, the
control and the faults the check has to catch.  A run on the CPU passes
``device="cpu"`` to the harness, past run.py's look for a card."""
import json
import subprocess
import sys

import pytest
import torch

from _small import run_small, run_tsne_small
from snsbench import harness, spec

CELLS = [w["name"] for w in spec.bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(cell, traced):
    out = run_small(cell, traced=traced)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in spec.metrics_of(cell, kind)}
    assert set(line["metrics"]) <= names
    if not traced:
        assert set(line["metrics"]) == names
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(cell):
    out = run_small(cell, control="bf16")
    assert out["correct"] is False
    over = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert "hh_mismatch" in over and len(over) >= 4


# the module attributes faults.plant replaces, restored after each test
PLANTED = [("repro_torch.core.tsne", "_momentum_update"),
           ("repro_torch.core.umap", "epoch_delta"),
           ("repro_torch.core.pipeline", "_points_tensor"),
           ("repro_torch.core.heavy_hitters", "from_candidates")]


@pytest.fixture
def restore():
    import importlib
    saved = [(importlib.import_module(m), a) for m, a in PLANTED]
    saved = [(mod, a, getattr(mod, a)) for mod, a in saved]
    yield
    for mod, a, v in saved:
        setattr(mod, a, v)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(restore, cell, fault):
    out = run_small(cell, fault=fault)
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("control,fault,correct", [
    (None, None, True), ("bf16", None, False),
    (None, "unchanged_state", False), (None, "half_batch", False)])
def test_the_sparse_tsne_stages(restore, control, fault, correct):
    out = run_tsne_small(control=control, fault=fault)
    assert out["correct"] is correct
    assert {"p_gap", "grad_gap", "update_gap"} <= set(out["checks"])
    if control:
        over = [k for k, c in out["checks"].items()
                if c["value"] > c["limit"]]
        assert "hh_mismatch" in over and len(over) >= 4


def _host_reads(monkeypatch, call) -> int:
    """How often ``call()`` reads a tensor's value back to the host."""
    reads = []
    with monkeypatch.context() as m:
        for attr in ("item", "tolist", "__int__", "__float__", "__bool__",
                     "__index__"):
            orig = getattr(torch.Tensor, attr)

            def spy(self, *a, _orig=orig, **k):
                reads.append(1)
                return _orig(self, *a, **k)
            m.setattr(torch.Tensor, attr, spy)
        call()
    return len(reads)


@pytest.mark.parametrize("stage", ["umap", "tsne_sparse"])
def test_the_capture_reads_nothing_back_inside_a_map(monkeypatch, stage):
    """The wrappers keep references: a wrapped stage reads back to the
    host exactly as often as the program's own, so the window carries no
    added synchronization."""
    from repro_torch.core import coo, tsne, umap
    from snsbench import capture
    g = torch.Generator().manual_seed(3)
    y = torch.rand((50, 2), generator=g)
    src = torch.arange(50).repeat_interleave(3)
    lay, _ = coo.edge_layout(src, torch.randint(0, 50, (150,), generator=g),
                             50)
    memb = torch.rand(150, generator=g)
    neg = torch.randint(0, 50, (150, 5), generator=g)
    st = tsne.TsneState(y, torch.zeros_like(y), torch.ones_like(y))

    def calls():
        umap.epoch_delta(y, lay, memb, neg, 1.6, 0.9)
        tsne._momentum_update(st, torch.ones_like(y), 0.5, tsne.TsneConfig())
    plain = _host_reads(monkeypatch, calls)
    cap = capture.Capture().install(spec.stages(stage))
    try:
        wrapped = _host_reads(monkeypatch, calls)
        assert cap.got, "the stage's wrappers recorded nothing"
    finally:
        cap.uninstall()
    assert wrapped == plain


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in harness.banned_modules()


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import snsbench.harness, snsbench.check, snsbench.capture\n"
            "import snsbench.drivers.resident, snsbench.stages.umap\n"
            "import snsbench.stages.tsne_sparse\n"
            "from snsbench import harness\n"
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without")
    out = subprocess.run([sys.executable, "snsbench/run.py", "--workload",
                          "cancer.resident", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
