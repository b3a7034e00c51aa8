"""The round step's spans as the benchmark reads them (``spans.py`` and the
nine readers built on it): synthetic rounds of timed spans and a synthetic
device trace, then a small traced run on the CPU with the recording
tracer installed."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import harness, program, smoke, spans
from bench.trace import Trace

spans.uninstall()     # the import installs a tracer where a card is visible

program.path()
from repro_torch.obs.tracer import TimedSpan  # noqa: E402

torch.set_num_threads(1)

W = "pod_topk_int8.qwen3-1.7b"
BOTH = ["forward_ms", "backward_ms", "update_ms", "idle_train_ms",
        "idle_exchange_ms"]
SCORED = ["q8_ms", "score_ms", "merge_ms", "q8_roofline"]
HBM = 3.35e12
ELEMENTS = 1_000_000

# kind, parent (index), start, end (µs from the round's start), attrs
LAYOUT = [
    ("round", None, 0, 200, {}),
    ("train", 0, 2, 60, {"pod": 0}),
    ("train.forward", 1, 4, 20, {}),
    ("train.backward", 1, 20, 50, {}),
    ("train.update", 1, 50, 58, {}),
    ("train", 0, 62, 120, {"pod": 1}),
    ("train.forward", 5, 64, 80, {}),
    ("train.backward", 5, 80, 110, {}),
    ("train.update", 5, 110, 118, {}),
    ("exchange", 0, 122, 199, {}),
    ("exchange.q8", 9, 124, 140, {"elements": ELEMENTS}),
    ("exchange.score", 9, 140, 180, {}),
    ("exchange.merge", 9, 180, 198, {}),
]
MEAN = LAYOUT[:10]                       # 'all': the exchange has no children
LEAVES = {2, 3, 4, 6, 7, 8, 10, 11, 12}
OFF = 5_000_000.0                        # the profiler's clock, µs
C, N, K = 2, 3, 1                        # checked, window and profiled steps


def _round(rid, layout, timed=True):
    base, first = 1000.0 * rid, 100 * rid
    out = []
    for i, (kind, up, a, b, attrs) in enumerate(layout):
        out.append(TimedSpan(
            kind, "pods", first + i, None if up is None else first + up, rid,
            int(a), int(b), 1e3 * (base + a) if timed else None,
            1e3 * (base + b) if timed else None, dict(attrs)))
    return out


def _kernels(layout, at=OFF):
    """A kernel a leaf span, from a microsecond after its start to one
    before its end, and one in the round's own time ending with it."""
    dev = [(at + a + 1, at + b - 1, f"void k_{kind}<float>(float*)")
           for i, (kind, _, a, b, _) in enumerate(layout) if i in LEAVES]
    dev.append((at + 199, at + 200, "Memset (Device)"))
    return sorted(dev)


def _ctx(layout=LAYOUT, device=None, n_rounds=None, timed=True, peaks=True):
    rounds = [_round(i, layout, timed)
              for i in range(n_rounds or C + N + K + 2)]
    tr = Trace(K, 0.001, device if device is not None else _kernels(layout))
    ctx = SimpleNamespace(cfg={}, mix={"checked_steps": C,
                                       "profiled_steps": K},
                          spans={}, window_steps=N, window_s=N * 250e-6,
                          trace=tr, calls={},
                          peaks={"hbm_bytes_per_s": HBM} if peaks else None,
                          flops_a_step=0.0)
    return ctx, rounds


@pytest.fixture
def stub(monkeypatch):
    """Hands ``rounds`` to the readers as the installed tracer's."""
    def use(rounds):
        tracer = SimpleNamespace(rounds=lambda: rounds)
        monkeypatch.setattr(spans, "installed", lambda: tracer)
    return use


def _read(ctx, names):
    return {n: harness.reader(n).read(ctx) for n in names}


def test_the_anchor_places_the_spans_and_charges_the_innermost():
    ctx, rounds = _ctx()
    got = spans.place(rounds, ctx)
    assert got["window_rounds"] == N
    p = got["profiled"]
    assert p["anchor_error_us"] == 0.0
    assert p["outside_pct"] == 0.0
    assert p["charged_pct"] == pytest.approx(100.0)
    kinds = p["kinds"]
    # each leaf busy its length less 2 µs, in both pods; µs -> ms
    assert kinds["train.forward"]["busy"] == pytest.approx(2 * 14e-3)
    assert kinds["train.backward"]["self_busy"] == pytest.approx(2 * 28e-3)
    assert kinds["train"]["busy"] == pytest.approx(2 * (14 + 28 + 6) * 1e-3)
    assert kinds["train"]["self_busy"] == 0.0
    assert kinds["train"]["self_idle"] == pytest.approx(2 * 4e-3)
    assert kinds["exchange"]["busy"] == pytest.approx((14 + 38 + 16) * 1e-3)
    assert kinds["round"]["self_busy"] == pytest.approx(1e-3)
    assert kinds["train"]["lead"] == pytest.approx(2 * 3e-3)
    assert kinds["train.forward"]["kernels"] == 2
    assert kinds["round"]["kernels"] == 0            # a set, not a kernel
    assert kinds["exchange.score"]["top"] == [["k_exchange.score",
                                               pytest.approx(38e-3)]]
    total = sum(v["self_busy"] for v in kinds.values())
    assert total == pytest.approx(ctx.trace.busy_s() * 1e3)


def test_a_boundary_inside_a_kernel_reads_as_the_anchors_error():
    dev = _kernels(LAYOUT)
    dev.append((OFF + 18, OFF + 22.5, "void k_across<float>(float*)"))
    ctx, rounds = _ctx(device=sorted(dev))
    p = spans.place(rounds, ctx)["profiled"]
    assert p["anchor_error_us"] == pytest.approx(2.0)   # 20 lies 2 inside
    assert p["charged_pct"] == pytest.approx(100.0)


def test_device_time_outside_every_round_is_counted():
    dev = _kernels(LAYOUT) + [(OFF - 10, OFF - 5, "void early(float*)")]
    ctx, rounds = _ctx(device=sorted(dev))
    p = spans.place(rounds, ctx)["profiled"]
    total = sum(e - s for s, e, _ in ctx.trace.device)
    assert p["outside_pct"] == pytest.approx(100.0 * 5 / total)
    assert p["charged_pct"] < 100.0


def test_the_readers_read_the_spans(stub):
    ctx, rounds = _ctx()
    stub(rounds)
    got = _read(ctx, BOTH + SCORED)
    assert got["forward_ms"] == pytest.approx(2 * 16e-3)
    assert got["backward_ms"] == pytest.approx(2 * 30e-3)
    assert got["update_ms"] == pytest.approx(2 * 8e-3)
    assert got["q8_ms"] == pytest.approx(16e-3)
    assert got["score_ms"] == pytest.approx(40e-3)
    assert got["merge_ms"] == pytest.approx(18e-3)
    assert got["q8_roofline"] == pytest.approx(
        100.0 * ELEMENTS * 6 / HBM / 16e-6)
    assert got["idle_train_ms"] == pytest.approx((2 * 58 - 2 * 48) * 1e-3)
    assert got["idle_exchange_ms"] == pytest.approx((77 - 68) * 1e-3)
    rep = spans.report(ctx)
    assert rep["idle_outside_round_ms"] == pytest.approx((250 - 200) * 1e-3)
    assert rep["idle_ms"]["train"] == got["idle_train_ms"]
    json.dumps(rep)


def test_the_idle_pair_reads_the_profiled_steps_alone(stub):
    """Window walls stretched (as the harness's synchronizes stretch them)
    move the wall readers and leave the idle pair, which takes wall and
    busy time from the profiled steps."""
    ctx, rounds = _ctx()
    for r in rounds[C + 1:C + 1 + N]:
        for sp in r:
            if sp.kind in ("train", "train.forward", "exchange",
                           "exchange.q8"):
                sp.dev1_ns += 7e3
    stub(rounds)
    got = _read(ctx, BOTH + SCORED)
    assert got["forward_ms"] == pytest.approx(2 * 23e-3)
    assert got["q8_ms"] == pytest.approx(23e-3)
    assert got["idle_train_ms"] == pytest.approx((2 * 58 - 2 * 48) * 1e-3)
    assert got["idle_exchange_ms"] == pytest.approx((77 - 68) * 1e-3)


def test_a_mean_exchange_has_no_scored_metrics(stub):
    ctx, rounds = _ctx(layout=MEAN)
    stub(rounds)
    got = _read(ctx, BOTH + SCORED)
    assert all(got[n] is not None for n in BOTH)
    assert all(got[n] is None for n in SCORED)


@pytest.mark.parametrize("case", ["no tracer", "no trace", "no device times",
                                  "another run's rounds", "no peaks"])
def test_each_reader_returns_none_where_it_finds_nothing(stub, monkeypatch,
                                                         case):
    ctx, rounds = _ctx(timed=case != "no device times",
                       n_rounds=C + N + K + 1 if case == "another run's rounds"
                       else None, peaks=case != "no peaks")
    if case == "no trace":
        ctx.trace = Trace(K, 0.0)
    stub(rounds)
    if case == "no tracer":
        monkeypatch.setattr(spans, "installed", lambda: None)
    got = _read(ctx, BOTH + SCORED)
    if case == "no peaks":
        assert got.pop("q8_roofline") is None
        assert all(v is not None for v in got.values())
    else:
        assert got == {n: None for n in BOTH + SCORED}


def test_the_nine_metrics_are_entries_of_the_benchmark():
    entries = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name in BOTH + SCORED:
        m = entries[name]
        assert (m["source"], m["moves"]) == ("program_span",
                                             "train_tokens_per_s")
        assert m.get("workloads") == ([W] if name in SCORED else None)
        assert callable(harness.reader(name).read)


def test_install_leaves_a_program_without_timed_spans_alone(monkeypatch):
    from repro_torch.core import exchange
    monkeypatch.delattr(exchange, "tracer")
    assert spans.install() is None
    assert not hasattr(exchange, "tracer")
    assert spans.installed() is None


def test_a_cpu_traced_run_with_the_tracer_reports_what_it_did_before():
    """The recording tracer installed (on the CPU: host clock only), a small
    traced run reports the metrics it reports without it and is correct;
    the tracer holds one round a step, in the harness's order."""
    tracer = spans.install()
    try:
        res = smoke.run(W, trace=True)
        rounds = tracer.rounds()
    finally:
        spans.uninstall()
    assert set(res["metrics"]) == {"train_ms", "exchange_ms"}
    assert res["correct"], res["checks"]
    _, _, mix = smoke.cell(W)
    n = res["attempted"]
    assert [r[0].round for r in rounds] == list(
        range(mix["checked_steps"] + 1 + n + mix["profiled_steps"]))
    assert all(r[0].kind == "round" and (r[0].dev0_ns is None) != tracer.cuda
               for r in rounds)

