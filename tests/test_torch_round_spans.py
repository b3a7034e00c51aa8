"""The round step's timed spans (``core/exchange.py`` on ``obs.tracer``):
the stacked round step gives the same bits with a recording tracer as
with the no-op one; its spans nest as the module says, one round id a
step; the tracer keeps only its last rounds; device times resolve from
CUDA events (a stand-in clock here) without a synchronize; and the spans
export as a well-formed Chrome trace."""
import json
import time

import pytest
import torch

from repro_torch import tree
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.core import exchange as ex
from repro_torch.models import build_model
from repro_torch.obs import tracer as obs_tracer
from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                                   write_chrome_trace)
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Tracer

torch.set_num_threads(1)

P = 2
CONFIGS = {
    "top_k-int8": dict(policy="top_k", k=1, compression="int8"),
    "all": dict(policy="all"),
    "above_average-multikrum": dict(policy="above_average",
                                    scorer="multikrum"),
}
TRAIN = ("train.forward", "train.backward", "train.update")


@pytest.fixture(scope="module")
def pods():
    """A float32 smoke ``qwen3-1.7b``, two pods of different inits stacked,
    and two batches of 4 x 32 tokens a pod."""
    model = build_model(replace(get_smoke_config("qwen3-1.7b"),
                                param_dtype="float32",
                                compute_dtype="float32"))
    inits = [model.init(torch.Generator().manual_seed(i), "cpu")
             for i in range(P)]
    stack = tree.tree_map(lambda *x: torch.stack(x), *inits)
    g = torch.Generator().manual_seed(5)
    batches = []
    for _ in range(2):
        x = torch.randint(0, model.cfg.vocab_size, (P, 4, 33), generator=g)
        batches.append({"tokens": x[..., :-1], "targets": x[..., 1:]})
    return model, stack, batches


@pytest.fixture
def traced():
    """Installs a tracer in the round step for one test (``traced(t)``),
    and the no-op one again after it."""
    def install(t):
        ex.tracer = t
        return t
    yield install
    ex.tracer = NULL_TRACER


def _rounds(pods, name, n=2):
    model, stack, batches = pods
    step = ex.make_unifyfl_round_step(model, None,
                                      ex.ExchangeConfig(**CONFIGS[name]), 0.1)
    outs = []
    for i in range(n):
        info = {}
        stack, losses = step(stack, batches[i % 2], info)
        outs.append((stack, losses, info))
    return outs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_round_step_gives_the_same_bits_traced(pods, traced, name):
    """Stack, losses and every tensor of ``info`` (trained, gathered,
    weights, scores, sketches) are bit-identical with a recording tracer
    installed and with ``NULL_TRACER``, over two steps."""
    plain = _rounds(pods, name)
    traced(Tracer())
    timed = _rounds(pods, name)
    for (s0, l0, i0), (s1, l1, i1) in zip(plain, timed):
        assert torch.equal(l0, l1)
        for a, b in zip(tree.leaves(s0), tree.leaves(s1)):
            assert torch.equal(a, b)
        assert set(i0) == set(i1)
        for key in i0:
            if i0[key] is None:
                assert i1[key] is None
                continue
            for a, b in zip(tree.leaves(i0[key]), tree.leaves(i1[key])):
                assert torch.equal(a, b), key


def _check_nesting(rounds, name, stack):
    for rid, spans in enumerate(rounds):
        byid = {sp.id: sp for sp in spans}
        assert {sp.round for sp in spans} == {rid}
        root = spans[0]
        assert (root.kind, root.parent, root.track) == ("round", None, "pods")
        for sp in spans:
            assert sp.host0_ns <= sp.host1_ns
            if sp.parent is not None:
                up = byid[sp.parent]
                assert up.host0_ns <= sp.host0_ns <= sp.host1_ns \
                    <= up.host1_ns
        trains = [sp for sp in spans if sp.kind == "train"]
        assert [(sp.attrs["pod"], sp.track, sp.parent) for sp in trains] \
            == [(i, f"pod{i}", root.id) for i in range(P)]
        for t in trains:
            kids = [sp for sp in spans if sp.parent == t.id]
            assert [sp.kind for sp in kids] == list(TRAIN)
            assert {sp.track for sp in kids} == {t.track}
        xs = [sp for sp in spans if sp.kind == "exchange"]
        assert len(xs) == 1 and xs[0].parent == root.id
        kids = [sp.kind for sp in spans if sp.parent == xs[0].id]
        if name == "all":
            assert kids == []
        elif "int8" in name:
            assert kids == ["exchange.q8", "exchange.score", "exchange.merge"]
            q8 = next(sp for sp in spans if sp.kind == "exchange.q8")
            per_pod = sum(x[0].numel() for x in tree.leaves(stack))
            assert q8.attrs["elements"] == per_pod * P
        else:
            assert kids == ["exchange.score", "exchange.merge"]
        assert len(spans) == 1 + P * 4 + 1 + len(kids)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_spans_nest_one_round_a_step(pods, traced, name):
    """Each ``train.*`` inside its pod's ``train`` (on the pod's track),
    each ``exchange.*`` inside ``exchange``, all inside ``round``, every
    span of a step under its round id; ``elements`` the parameters of a
    pod times the pods."""
    t = traced(Tracer())
    _rounds(pods, name)
    rounds = t.rounds()
    assert len(rounds) == 2
    _check_nesting(rounds, name, pods[1])
    assert t.spans == [] and t.events == []      # the simulated clock's


def test_the_tracer_keeps_its_last_rounds(pods, traced, monkeypatch):
    monkeypatch.setattr(obs_tracer, "KEEP_ROUNDS", 2)
    t = traced(Tracer())
    _rounds(pods, "all", n=5)
    assert [r[0].round for r in t.rounds()] == [3, 4]
    assert len({sp.id for r in t.rounds() for sp in r}) == \
        sum(len(r) for r in t.rounds())


def test_the_null_tracer_hands_out_one_shared_no_op():
    a = NULL_TRACER.timed("round", "pods")
    b = NullTracer().timed("train", "pod0", pod=0)
    assert a is b
    with a as sp:
        assert sp is a
    assert ex.tracer is NULL_TRACER


class FakeEvent:
    """``torch.cuda.Event`` on a stand-in device clock: ``record`` reads
    ``now`` (ms), ``query`` is true once ``done`` has passed it."""
    now = 0.0
    done = float("inf")
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.now += 0.25                  # each record a later instant
        self.t = FakeEvent.now

    def query(self):
        return self.t <= FakeEvent.done

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.now, FakeEvent.done, FakeEvent.made = 0.0, float("inf"), 0
    return FakeEvent


def _fake_round(t, work_ms=1.0):
    with t.timed("round", "pods"):
        for i in range(P):
            with t.timed("train", f"pod{i}", pod=i):
                for kind in TRAIN:
                    with t.timed(kind):
                        FakeEvent.now += work_ms
        with t.timed("exchange"):
            FakeEvent.now += work_ms


def test_device_times_resolve_lazily_and_in_place(fake_cuda, monkeypatch):
    """Device times stay unresolved while the device has not passed a
    round's events and resolve once it has; they nest as on the host, lie
    on one clock across rounds and evictions, and the events are reused."""
    monkeypatch.setattr(obs_tracer, "KEEP_ROUNDS", 3)
    t = Tracer()
    FakeEvent.done = -1.0                      # the device is behind
    _fake_round(t)
    assert all(sp.dev0_ns is None for sp in t.rounds()[0])
    FakeEvent.done = float("inf")
    first = t.rounds()[0]
    assert first[0].dev0_ns == 0.0
    for _ in range(9):
        _fake_round(t)
    rounds = t.rounds()
    assert [r[0].round for r in rounds] == [7, 8, 9]
    for r in rounds:
        byid = {sp.id: sp for sp in r}
        for sp in r:
            assert sp.dev0_ns < sp.dev1_ns
            if sp.parent is not None:
                up = byid[sp.parent]
                assert up.dev0_ns < sp.dev0_ns < sp.dev1_ns < up.dev1_ns
        fwd = [sp for sp in r if sp.kind == "train.forward"]
        assert [sp.dev1_ns - sp.dev0_ns for sp in fwd] == [1.25e6] * P
    # the stand-in clock's instant of each round's start, from round 0's
    per_round = (rounds[1][0].dev0_ns - rounds[0][0].dev0_ns)
    assert rounds[0][0].dev0_ns == 7 * per_round
    assert rounds[2][0].dev0_ns - rounds[1][0].dev0_ns == per_round
    events_a_round = 2 * len(rounds[0])
    assert FakeEvent.made <= (3 + 2) * events_a_round


@pytest.mark.parametrize("keep,behind", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_every_kept_round_keeps_its_place_on_the_device(fake_cuda,
                                                        monkeypatch, keep,
                                                        behind):
    """The device ``behind`` rounds behind when each round opens (0: caught
    up, as after a caller's synchronize every step, the caller reading
    ``rounds`` each time): the last round resolved may leave the ring, and
    the next round still takes its place from it, so every kept round has
    device times on the one clock of round 0's start."""
    monkeypatch.setattr(obs_tracer, "KEEP_ROUNDS", keep)
    t = Tracer()
    ends = []
    for _ in range(7):
        FakeEvent.done = ends[-1 - behind] if len(ends) > behind else -1.0
        _fake_round(t)
        ends.append(FakeEvent.now)
        if behind == 0:
            FakeEvent.done = FakeEvent.now
            assert all(sp.dev0_ns is not None for sp in t.rounds()[-1])
    FakeEvent.done = float("inf")
    rounds = t.rounds()
    assert [r[0].round for r in rounds] == list(range(7 - keep, 7))
    for r in rounds:
        assert all(sp.dev0_ns is not None and sp.dev0_ns < sp.dev1_ns
                   for sp in r)
        # a round takes ends[0] ms of the stand-in clock, from its start
        assert r[0].dev0_ns == pytest.approx(r[0].round * ends[0] * 1e6)
        assert r[0].dev1_ns == pytest.approx(
            (r[0].round + 1) * ends[0] * 1e6 - 0.25e6)
    assert FakeEvent.made <= (keep + behind + 2) * 2 * len(rounds[0])


def test_the_spans_export_as_a_chrome_trace(fake_cuda, tmp_path):
    """Host intervals on ``<track>/host``, device intervals on
    ``<track>/device``, beside a simulated span; the document well
    formed, on disk too."""
    t = Tracer()
    for _ in range(2):
        _fake_round(t)
    t.span_at("phase.train", "silo0/phases", 0.0, 1.0)  # a simulated span
    doc = chrome_trace(t)
    assert validate_chrome_trace(doc) == []
    names = {(e["pid"], e["tid"]): e["args"]["name"]
             for e in doc["traceEvents"] if e["name"] == "thread_name"}
    procs = {e["pid"]: e["args"]["name"]
             for e in doc["traceEvents"] if e["name"] == "process_name"}
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            lane = f"{procs[e['pid']]}/{names[(e['pid'], e['tid'])]}"
            lanes.setdefault(lane, []).append(e["name"])
    assert lanes["pods/host"].count("round") == 2
    assert lanes["pods/device"].count("exchange") == 2
    for i in range(P):
        for lane in ("host", "device"):
            got = lanes[f"pod{i}/{lane}"]
            assert got.count("train") == 2
            assert sorted(set(got)) == sorted({"train", *TRAIN})
    assert lanes["silo0/phases"] == ["phase.train"]
    rounds = [e for e in doc["traceEvents"]
              if e["name"] == "round" and e["ph"] == "X"]
    assert {e["args"]["round"] for e in rounds} == {0, 1}
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), t)
    assert validate_chrome_trace(json.loads(path.read_text())) == []


def test_a_span_costs_little_when_off():
    """Off, a span boundary is a method call handing back one shared
    object: a thousand spans take well under a millisecond each."""
    tr = NULL_TRACER
    t0 = time.perf_counter()
    for i in range(1000):
        with tr.timed("train", "pod0", pod=i):
            pass
    assert (time.perf_counter() - t0) / 1000 < 1e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pods_on(pods, device):
    model, stack, batches = pods
    return (model, tree.tree_map(lambda x: x.to(device), stack),
            [{k: v.to(device) for k, v in b.items()} for b in batches])


@pytest.mark.gpu
def test_gpu_device_times_nest_and_resolve_after_the_callers_sync(
        pods, traced, monkeypatch):
    """On the card: the same bits with the recording tracer, and after
    the caller's synchronize every kept span has device times that nest
    as the host's do, on one clock across rounds."""
    on = _pods_on(pods, _cuda())
    plain = _rounds(on, "top_k-int8", n=3)
    monkeypatch.setattr(obs_tracer, "KEEP_ROUNDS", 2)
    t = traced(Tracer())
    timed = _rounds(on, "top_k-int8", n=3)
    torch.cuda.synchronize()
    for (s0, l0, _), (s1, l1, _) in zip(plain, timed):
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(s0),
                                                     tree.leaves(s1)))
    rounds = t.rounds()
    assert [r[0].round for r in rounds] == [1, 2]
    for r in rounds:
        byid = {sp.id: sp for sp in r}
        for sp in r:
            assert sp.dev0_ns is not None and sp.dev0_ns <= sp.dev1_ns
            if sp.parent is not None:
                up = byid[sp.parent]
                assert up.dev0_ns <= sp.dev0_ns <= sp.dev1_ns <= up.dev1_ns
    assert rounds[0][0].dev1_ns <= rounds[1][0].dev0_ns


@pytest.mark.gpu
def test_gpu_the_spans_add_nothing_to_the_device_trace(pods, traced):
    """A device-only profiler session over a round step sees the same
    device events, by name and count, with the recording tracer as
    without it."""
    from torch.profiler import ProfilerActivity, profile
    on = _pods_on(pods, _cuda())
    model, stack, batches = on
    step = ex.make_unifyfl_round_step(
        model, None, ex.ExchangeConfig(**CONFIGS["top_k-int8"]), 0.1)
    step(stack, batches[0])
    seen = []
    for tracer in (NULL_TRACER, Tracer(), NULL_TRACER):
        traced(tracer)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)       # no device event near the session's edges
            step(stack, batches[0])
            torch.cuda.synchronize()
            time.sleep(0.02)
        names = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        seen.append(names)
    assert seen[0] == seen[2]
    assert seen[1] == seen[0]
