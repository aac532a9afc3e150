"""The port's recorder (``repro_torch.tracing``): off (one shared no-op
span, nothing recorded, counters still counting) without a profiler; under
one, the spans of a served request (``serve.request`` › ``serve.chunk`` ›
``cnn.forward`` › ``cnn.conv``) and of an SGD step (``sgd.step`` and its five
parts), ``host.sync`` once a chunk, a bind under a missed lookup, and every
span a host event of the profiler that is no user annotation, named unlike
the benchmark's own spans. The ``gpu`` test shows on the card that the
spans add no device event and that the kernels' launch counters, which live
in the recorder, equal the profiler's records."""
import re
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels, tracing
from repro_torch.core import full_masks
from repro_torch.launch.serve_cnn import CnnServer
from repro_torch.models import cnn
from repro_torch.train import cnn_training
from repro_torch.train.optimizer import sgd

ROOT = Path(__file__).resolve().parent.parent
CFG = cnn.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)
N_CONVS = len(cnn.conv_layer_order(CFG))            # 6
N_BLOCKS = sum(CFG.stages)
# the benchmark's serving contract: every conv on the int8 kernel
SPEC = cnn.ExecSpec(packed=True, quantized=True, folded=True, streamed=True,
                    dense_fallback=2.0, n_cu=4)
STEP_PARTS = ["sgd.mask", "grad.forward", "grad.backward", "sgd.update", "sgd.remask"]
PROGRAM_SPANS = {"serve.request", "serve.ingest", "serve.chunk", "serve.lookup",
                 "cnn.forward", "cnn.conv", "cnn.residual", "cnn.head", "cnn.bind",
                 "host.sync", "sgd.step", *STEP_PARTS}


def _bench_span_names() -> set:
    """The benchmark's own span names: its window and each ``tracer.span``
    of its runners."""
    names = {re.search(r'WINDOW_SPAN = "([^"]+)"',
                       (ROOT / "hapm_bench" / "trace.py").read_text()).group(1)}
    for f in (ROOT / "hapm_bench" / "runners").glob("*.py"):
        names |= set(re.findall(r'tracer\.span\("([^"]+)"\)', f.read_text()))
    return names


def _server(buckets=(4,), device="cpu", cfg=CFG):
    params, state = cnn.init(0, cfg, device=device)
    return CnnServer(params, state, cfg, spec=SPEC, buckets=buckets, device=device)


def _frames(n, device="cpu", size=16):
    gen = torch.Generator().manual_seed(n)
    return torch.rand((n, size, size, 3), generator=gen).to(device)


def _new_spans(before: int):
    return [s for s in tracing.spans() if s.id > before]


def _last_id() -> int:
    spans = tracing.spans()
    return max((s.id for s in spans), default=0)


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.t_start_ns)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_without_a_profiler_records_nothing_and_counts():
    server = _server()
    server.warmup()
    before, n = len(tracing.spans()), tracing.counter("serve.requests")
    assert tracing.span("serve.request") is tracing.OFF
    with tracing.span("x", a=1) as s:
        s.set(b=2)
    server.infer(_frames(6))
    assert len(tracing.spans()) == before
    assert tracing.counter("serve.requests") == n + 1


def test_counters_count_read_and_reset():
    assert tracing.count("test.a") == tracing.counter("test.a")
    v = tracing.counter("test.a")
    assert tracing.count("test.a", 5) == v + 5
    assert tracing.counters()["test.a"] == v + 5
    tracing.reset("test.a")
    assert tracing.counter("test.a") == 0 and "test.a" not in tracing.counters()


def test_served_request_spans():
    server = _server()
    server.warmup()
    binds = tracing.counter("cnn.binds")
    before = _last_id()
    with _cpu_profile():
        for _ in range(2):
            server.infer(_frames(6)).cpu()          # two chunks: 4 and 2 padded to 4
    spans = _new_spans(before)
    roots = [s for s in spans if s.id == s.root]
    assert [r.name for r in roots] == ["serve.request"] * 2
    assert all(s.root in {r.id for r in roots} for s in spans)
    for root in roots:
        assert root.attrs["frames"] == 6
        kids = _children(spans, root)
        assert [k.name for k in kids] == ["serve.ingest", "serve.chunk", "serve.chunk"]
        assert [k.attrs["frames"] for k in kids[1:]] == [4, 2]
        for chunk in kids[1:]:
            assert chunk.attrs["bucket"] == 4
            assert [k.name for k in _children(spans, chunk)] == [
                "serve.lookup", "cnn.forward", "host.sync"]
            sync = _children(spans, chunk)[2]
            assert sync.attrs["what"] == "finite_guard"
            fwd = _children(spans, chunk)[1]
            parts = [k.name for k in _children(spans, fwd)]
            assert parts.count("cnn.conv") == N_CONVS
            assert parts.count("cnn.residual") == N_BLOCKS and parts[-1] == "cnn.head"
            assert all(k.attrs["kernel"] for k in _children(spans, fwd)
                       if k.name == "cnn.conv")
        assert sum(s.name == "host.sync" for s in spans if s.root == root.id) == 2
        for s in spans:
            if s.root == root.id and s.id != root.id:
                assert root.t_start_ns <= s.t_start_ns <= s.t_end_ns <= root.t_end_ns
    assert tracing.counter("cnn.binds") == binds          # every lookup hit


def test_a_missed_lookup_binds_under_it():
    server = _server()
    binds, bind_ns = tracing.counter("cnn.binds"), tracing.counter("cnn.bind_ns")
    before = _last_id()
    with _cpu_profile():
        server.infer(_frames(3))
    spans = _new_spans(before)
    (bind,) = [s for s in spans if s.name == "cnn.bind"]
    lookup = next(s for s in spans if s.id == bind.parent)
    assert lookup.name == "serve.lookup"
    assert tracing.counter("cnn.binds") == binds + 1
    assert tracing.counter("cnn.bind_ns") > bind_ns


def test_binds_count_one_each():
    params, _ = cnn.init(1, CFG, device="cpu")
    spec = cnn.ExecSpec(n_cu=4)
    for _ in range(2):
        binds, bind_ns = tracing.counter("cnn.binds"), tracing.counter("cnn.bind_ns")
        cnn.bind_execution(params, CFG, spec=spec, device="cpu")
        assert tracing.counter("cnn.binds") == binds + 1
        assert tracing.counter("cnn.bind_ns") > bind_ns


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "trainable_bind"])
def test_sgd_step_spans(sparse):
    cfg = cnn.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16, quantized=True)
    params, state = cnn.init(2, cfg, device="cpu")
    masks = full_masks(params, cnn.is_conv_weight)
    opt = sgd(momentum=0.9, weight_decay=1e-4)[0](params)
    gen = torch.Generator().manual_seed(3)
    batch = {"x": torch.rand((4, 16, 16, 3), generator=gen),
             "y": torch.randint(10, (4,), generator=gen)}
    exec_ = (cnn.bind_execution(params, cfg, spec=cnn.ExecSpec(n_cu=4, trainable=True,
                                                              dense_fallback=2.0),
                                device="cpu") if sparse else None)
    n = tracing.counter("sgd.steps")
    before = _last_id()
    with _cpu_profile():
        cnn_training._sgd_step(params, state, opt, masks, batch, 0.05, cfg, exec_)
    spans = _new_spans(before)
    (root,) = [s for s in spans if s.id == s.root]
    assert root.name == "sgd.step" and root.attrs["n"] == n + 1
    kids = _children(spans, root)
    assert [k.name for k in kids] == STEP_PARTS
    (fwd,) = _children(spans, kids[1])
    assert fwd.name == "cnn.forward" and fwd.attrs["train"] is True
    convs = [k for k in _children(spans, fwd) if k.name == "cnn.conv"]
    assert len(convs) == N_CONVS and all(k.attrs["kernel"] is sparse for k in convs)


def test_spans_are_host_events_and_no_user_annotation():
    server = _server()
    server.warmup()
    with _cpu_profile() as prof:
        server.infer(_frames(6)).cpu()
        cfg = cnn.ResNetConfig(stages=(1, 1), widths=(8, 16), image_size=16)
        params, state = cnn.init(0, cfg, device="cpu")
        cnn.bind_execution(params, cfg, spec=cnn.ExecSpec(n_cu=4), device="cpu")
        cnn_training._sgd_step(params, state, sgd()[0](params),
                               full_masks(params, cnn.is_conv_weight),
                               {"x": _frames(2), "y": torch.zeros(2, dtype=torch.long)},
                               0.05, cfg)
    events = [e for e in prof.events() if e.name in PROGRAM_SPANS]
    assert {e.name for e in events} == PROGRAM_SPANS
    from torch.autograd import DeviceType
    for e in events:
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation, e.name
    bench = _bench_span_names()
    assert {"bench.window", "server.infer", "train.step"} <= bench
    assert not PROGRAM_SPANS & bench


def _other_thread_span():
    with tracing.span("other"):
        pass


def test_threads_keep_their_own_roots():
    before = _last_id()
    with _cpu_profile():
        with tracing.span("outer"):
            t = threading.Thread(target=_other_thread_span)
            t.start()
            t.join()
            with tracing.span("inner"):
                pass
    spans = {s.name: s for s in _new_spans(before)}
    assert spans["other"].id == spans["other"].root
    assert spans["inner"].parent == spans["outer"].id == spans["inner"].root


def test_the_ring_drops_the_oldest_and_counts_them(monkeypatch):
    import collections
    monkeypatch.setattr(tracing, "_spans", collections.deque(maxlen=3))
    dropped = tracing.counter(tracing.DROPPED)
    with _cpu_profile():
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]
    assert tracing.counter(tracing.DROPPED) == dropped + 2


@pytest.mark.gpu
def test_spans_add_no_device_event_and_launches_match_records():
    """On the card: a traced request through K2 int8 at the benchmark's
    contract puts no device event under a program span's name in the trace,
    and the wrappers' launch counters (in the recorder) equal the profiler's
    records of their kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    cfg = cnn.ResNetConfig()
    server = _server(buckets=(64,), device=dev, cfg=cfg)
    server.warmup()
    x = _frames(64, dev, size=cfg.image_size)
    roots = sum(s.name == "serve.request" for s in tracing.spans())
    prof = kernels.profile_device_records(lambda: server.infer(x).cpu(), 8, dev)
    assert prof.launched["implicit_block_sparse_conv"] == 8 * len(cnn.conv_layer_order(cfg))
    assert kernels.record_mismatch(prof.launched, prof.records) == {}
    assert not {key for key in prof.records if key in PROGRAM_SPANS}
    assert sum(s.name == "serve.request" for s in tracing.spans()) >= roots + 8
