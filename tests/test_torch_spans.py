"""The port's span recorder (repro_torch.core.spans) and the spans a map
opens: dotted paths, repeats, scopes and threads; every step of a map in
``SnsResult.stage_seconds`` and on the profiler's timeline; the ANN's
``stats`` from its spans; the benchmark's readers of the embed's steps."""
import dataclasses
import threading

import pytest
import torch

from repro_torch.core import ann, pipeline, spans, tsne, umap
from repro_torch.data.synthetic import MixtureSpec, gaussian_mixture
from snsbench import datagen, program, spec, trace
from snsbench.tests._small import SEED, SMALL

SKETCH = {"sketch", "sketch.grid", "sketch.keys", "sketch.sort",
          "sketch.update", "sketch.candidates", "sketch.estimate"}
UMAP = {"replicas", "embed", "embed.knn", "embed.affinity", "embed.layout",
        "embed.optimize"}
ANN = {"embed.knn.probes", "embed.knn.descent"}
READERS = {"knn_s": "embed.knn@device",
           "affinity_s": "embed.affinity@device",
           "layout_s": "embed.layout@device",
           "optimize_s": "embed.optimize@device",
           "optimize_host_s": "embed.optimize"}


@pytest.fixture
def ticks(monkeypatch):
    """A host clock that moves 1 ms a reading."""
    now = [0]

    def tick():
        now[0] += 1_000_000
        return now[0]
    monkeypatch.setattr(spans.time, "perf_counter_ns", tick)


def test_nesting_dotted_paths_and_repeats(ticks):
    with spans.scope("cpu") as sc:
        with spans.span("a"):
            for _ in range(3):
                with spans.span("b"):
                    with spans.span("c"):
                        pass
        with spans.span("d"):
            pass
    got = sc.seconds()
    assert list(got) == ["a", "a.b", "a.b.c", "d"]
    # one reading at entry, one at exit: a leaf spans 1 ms, a.b 3 ms each
    assert got == pytest.approx({"a": 0.013, "a.b": 0.009, "a.b.c": 0.003,
                                 "d": 0.001})
    assert sc.seconds() == {}


def test_a_span_raising_still_closes(ticks):
    with spans.scope("cpu") as sc:
        with pytest.raises(RuntimeError):
            with spans.span("a"):
                raise RuntimeError("boom")
        with spans.span("b"):
            pass
    assert list(sc.seconds()) == ["a", "b"]


@pytest.mark.parametrize("where", ["outside", "thread", "after"])
def test_a_span_outside_the_scope_records_nothing(where):
    @spans.spanned("f")
    def f():
        with spans.span("g"), spans.span("h", sync=torch.device("cpu")):
            return 7
    if where == "outside":
        assert f() == 7
        return
    with spans.scope("cpu") as sc:
        if where == "thread":
            out = []
            t = threading.Thread(target=lambda: out.append(f()))
            t.start()
            t.join()
            assert out == [7]
    if where == "after":
        assert f() == 7
    assert sc.seconds() == {}


def test_an_inner_scope_stands_alone():
    with spans.scope("cpu") as outer:
        with spans.span("a"):
            with spans.scope("cpu") as inner:
                with spans.span("b"):
                    pass
            with spans.span("c"):
                pass
    assert set(inner.seconds()) == {"b"}
    assert set(outer.seconds()) == {"a", "a.c"}


def _cell_args(cell):
    cfg = program.merge(spec.config(spec.cell(cell)["config"]), SMALL[cell])
    dev = torch.device("cpu")
    pts = datagen.mixture(cfg["data"], SEED, 0, dev)
    _, _, draws = program.draws(cfg, SEED, dev)
    return dict(points=pts, device=dev, draws=draws,
                **program.args(cfg, SEED))


@pytest.mark.parametrize("cell", ["cancer.resident", "sdss.resident"])
def test_a_cpu_map_writes_every_host_key(cell):
    """Every span of the table, host seconds only, each stage's steps
    inside the stage."""
    res = pipeline.run(**_cell_args(cell))
    st = res.stage_seconds
    assert set(st) == SKETCH | UMAP
    assert all(isinstance(v, float) and v > 0 for v in st.values())
    steps = sum(v for k, v in st.items() if k.startswith("sketch."))
    assert steps <= st["sketch"]
    embed = sum(v for k, v in st.items() if k.startswith("embed."))
    assert embed <= st["embed"]


def _small_pts():
    pts, _ = gaussian_mixture(3000, MixtureSpec(dims=3), seed=2)
    return pts


SMALL_CFG = pipeline.SnsConfig(bins=8, rows=4, log2_cols=10, top_k=120)


@pytest.mark.parametrize("embedder,method,keys", [
    ("umap", "ann", SKETCH | UMAP | ANN),
    ("tsne", "ann", SKETCH | {"replicas", "embed", "embed.knn",
                              "embed.affinity", "embed.optimize"} | ANN),
    ("tsne", "exact", SKETCH | {"replicas", "embed", "embed.affinity",
                                "embed.optimize"})])
def test_each_embedder_writes_its_spans(embedder, method, keys):
    """UMAP and sparse tSNE over either kNN build; exact tSNE, whose P
    needs no graph."""
    cfg = dataclasses.replace(SMALL_CFG, embedder=embedder,
                              embed_knn_method=method,
                              embed_backend="sparse" if method == "ann"
                              else "dense", embed_grid=16)
    res = pipeline.run(cfg, _small_pts(), device="cpu",
                       tsne_cfg=tsne.TsneConfig(n_iter=4, perplexity=3.0),
                       umap_cfg=umap.UmapConfig(n_neighbors=4, n_epochs=2))
    assert set(res.stage_seconds) == keys


@pytest.mark.parametrize("n_epochs", [1, 9])
def test_a_map_opens_the_same_spans_whatever_its_length(monkeypatch,
                                                        n_epochs):
    """No span an epoch, a kNN row block or a descent round: an ANN UMAP
    map opens 15."""
    counts = []
    orig = spans.Scope.seconds

    def seconds(self):
        counts.append(len(self.records))
        return orig(self)
    monkeypatch.setattr(spans.Scope, "seconds", seconds)
    cfg = dataclasses.replace(SMALL_CFG, embed_knn_method="ann",
                              embed_block=64)
    pipeline.run(cfg, _small_pts(), device="cpu",
                 umap_cfg=umap.UmapConfig(n_neighbors=4, n_epochs=n_epochs))
    assert counts == [15]


@pytest.mark.parametrize("stage", ["streaming", "resilient", "given_grid"])
def test_the_other_entry_points_keep_their_stage_keys(stage):
    pts = _small_pts()
    small = dict(umap_cfg=umap.UmapConfig(n_neighbors=4, n_epochs=1))
    chunks = [pts[:1000], pts[1000:]]
    if stage == "streaming":
        res = pipeline.run_streaming(SMALL_CFG, chunks, device="cpu",
                                     **small)
        want = {"grid", "ingest", "extract"}
    elif stage == "resilient":
        grid = pipeline.sketch_stage(SMALL_CFG, pts, device="cpu")[0]
        res = pipeline.run_resilient(SMALL_CFG, {0: chunks[:1],
                                                 1: chunks[1:]},
                                     grid, device="cpu", **small)
        want = {"ingest"}
    else:
        grid = pipeline.sketch_stage(SMALL_CFG, pts, device="cpu")[0]
        res = pipeline.run(SMALL_CFG, pts, grid, device="cpu", **small)
        want = SKETCH - {"sketch.grid"}
    assert set(res.stage_seconds) == want | UMAP


def _host_ranges(prof):
    from torch.autograd import DeviceType
    return [(ev.start_ns() / 1e3, ev.end_ns() / 1e3, ev.name(),
             ev.start_thread_id())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() != DeviceType.CUDA]


def test_a_profiled_map_holds_every_span_and_labels_its_gaps():
    """Each span is a ``sns:<path>`` range on the profile's timeline, and
    the benchmark labels an idle gap in the epoch loop by it."""
    cfg = dataclasses.replace(SMALL_CFG, embed_knn_method="ann")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipeline.run(cfg, _small_pts(), device="cpu",
                     umap_cfg=umap.UmapConfig(n_neighbors=4, n_epochs=3))
    host = _host_ranges(prof)
    names = {h[2] for h in host}
    assert {"sns:" + p for p in SKETCH | UMAP | ANN} <= names
    s, e = next((h[0], h[1]) for h in host if h[2] == "sns:embed.optimize")
    mid = 0.5 * (s + e)
    label, = trace.label_gaps([(mid - 1e-3, mid + 1e-3)], host)
    assert label.startswith("sns:embed.optimize / ")


def test_ann_stats_come_from_its_spans():
    """``stats`` keeps its keys; a build outside a map opens a scope of
    its own, and the stages' seconds are its spans'."""
    x = torch.from_numpy(_small_pts()[:600])
    st = {}
    got = ann.ann_knn_graph(x, 8, ann.AnnConfig(probes=2, bucket=32),
                            stats=st)
    want = ann.ann_knn_graph(x, 8, ann.AnnConfig(probes=2, bucket=32))
    assert set(st) == {"stage1_s", "descent_s", "descent_iters",
                       "descent_changed"}
    assert st["stage1_s"] > 0 and st["descent_s"] > 0
    assert st["descent_iters"] == len(st["descent_changed"]) >= 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_embed_readers(name):
    """Each reads its key's mean over the window's maps (the profiled map
    left out) and None where no map holds it."""
    read = spec.reader(name)
    key = READERS[name]
    maps = [{"stages": {"embed": 1.0, key: v}} for v in (0.2, 0.4, 9.0)]
    assert read({"maps": maps, "profiled": 2}) == pytest.approx(0.3)
    bare = [{"stages": {"embed": 1.0}} for _ in range(3)]
    assert read({"maps": bare, "profiled": None}) is None


@pytest.mark.cuda
def test_a_cuda_map_adds_device_seconds_and_no_synchronize(monkeypatch):
    """On the card every span has its device seconds too, and a map
    synchronizes once a stage, as before the spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device seconds come from CUDA "
                    "events")
    dev = torch.device("cuda")
    pts = torch.from_numpy(_small_pts()).to(dev)
    small = dict(umap_cfg=umap.UmapConfig(n_neighbors=4, n_epochs=3))
    pipeline.run(SMALL_CFG, pts, device=dev, **small)       # warm
    calls = []
    orig = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (calls.append(1), orig(*a)))
    res = pipeline.run(SMALL_CFG, pts, device=dev, **small)
    assert len(calls) == 3
    host = SKETCH | UMAP
    assert set(res.stage_seconds) == host | {k + "@device" for k in host}
    assert all(v > 0 for v in res.stage_seconds.values())
