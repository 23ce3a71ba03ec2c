"""repro_torch.store against repro.store: the same documents through
both packages' on-disk logs and both ReplayEngines give the same fired
alerts, key for key; the log formats are byte-compatible (a log written
by either package replays in the other); the journal routes agree.

Counts, keys, windows and max are compared exactly; sums at rtol 1e-5
(f32 sums in another order)."""
import os

import jax  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.alerts as ja
import repro.store as js
import repro_torch.alerts as ta
import repro_torch.store as ts


def _stage(pkg, size_s=60.0):
    return pkg.AnalyticsStage(
        pkg.WindowSpec(kind="tumbling", size_s=size_s),
        [pkg.ThresholdRule("vol", metric="count", op=">=", threshold=5.0),
         pkg.RateOfChangeRule("surge", metric="count", factor=2.0),
         pkg.ZScoreRule("anom", metric="count", z=3.0)],
        value_fn=lambda doc: float(doc.get("value", 1.0)))


def _engine(pkg, **kw):
    if pkg is js:
        return js.ReplayEngine(interpret=True, **kw)
    return ts.ReplayEngine(device="cpu", **kw)


def _alert_key(a):
    return (a.rule, a.key, a.window_start, a.window_end, a.metric, a.value,
            a.severity, a.fired_at_watermark)


def _collect(stage):
    got = []
    stage.add_export(lambda closed, wm: got.extend(closed))
    return got


def _same_aggs(got, exp):
    assert [(a.key, a.window_start, a.window_end, a.count, a.max)
            for a in got] == [(a.key, a.window_start, a.window_end, a.count,
                               a.max) for a in exp]
    np.testing.assert_allclose([a.sum for a in got], [a.sum for a in exp],
                               rtol=1e-5, atol=1e-5)


def _docs(seed=7, with_value=False):
    rng = np.random.default_rng(seed)
    docs = [{"channel": str(k), "published_at": float(rng.uniform(0, 900)),
             "title": f"doc {i}"}
            for i, k in enumerate(np.repeat(["news", "twitter"], 300))]
    if with_value:
        for d in docs:
            d["value"] = float(np.round(rng.lognormal(), 3))
    return docs


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as fh:
            out[name] = fh.read()
    return out


def test_replay_through_both_on_disk_logs(tmp_path):
    """The shape of tests/test_store.py's batch/live parity: documents
    persisted by each package's EventLog, reopened, and replayed by each
    package's ReplayEngine fire the live path's alerts, key for key."""
    docs = _docs()
    live = _stage(ta)
    for doc in docs:
        live.observe(doc)
    live_alerts = live.advance(1e9)
    assert len(live_alerts) > 0
    wm = live.operator.watermark

    results = {}
    for pkg in (js, ts):
        d = str(tmp_path / pkg.__name__)
        with pkg.EventLog(d, segment_bytes=4096) as log:
            log.append([{"id": f"d{i}", "doc": doc}
                        for i, doc in enumerate(docs)])
        stage = (_stage(ja) if pkg is js else _stage(ta))
        aggs = _collect(stage)
        eng = _engine(pkg, log=pkg.EventLog(d, segment_bytes=4096),
                      analytics=stage)
        res = eng.replay_log(0, watermark=wm)
        assert res["events"] == len(docs) and res["columnar"] is False
        results[pkg] = (stage.alerts, aggs)
    assert _files(str(tmp_path / js.__name__)) == \
        _files(str(tmp_path / ts.__name__))          # byte-identical logs
    j_alerts, j_aggs = results[js]
    t_alerts, t_aggs = results[ts]
    assert [_alert_key(a) for a in t_alerts] == \
        [_alert_key(a) for a in j_alerts] == \
        [_alert_key(a) for a in live_alerts]
    _same_aggs(t_aggs, j_aggs)


def _write_columnar(pkg, d, docs):
    log = pkg.ColumnarEventLog(d, segment_bytes=4096, block_rows=16)
    for i in range(0, len(docs), 50):
        log.append([{"id": f"d{i + j}", "doc": doc}
                    for j, doc in enumerate(docs[i:i + 50])])
    log.close()          # sealed segments + a JSON tail, as a crash leaves


def test_columnar_logs_are_byte_identical(tmp_path):
    docs = _docs(11, with_value=True)
    for pkg in (js, ts):
        _write_columnar(pkg, str(tmp_path / pkg.__name__), docs)
    a, b = _files(str(tmp_path / js.__name__)), \
        _files(str(tmp_path / ts.__name__))
    assert any(n.endswith(".colb") for n in a)
    assert a == b


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_columnar_log_replays_in_either_package(tmp_path, writer):
    docs = _docs(12, with_value=True)
    d = str(tmp_path / "log")
    _write_columnar(js if writer == "repro" else ts, d, docs)
    results = {}
    for pkg, apkg in ((js, ja), (ts, ta)):
        stage = _stage(apkg)
        aggs = _collect(stage)
        log = pkg.ColumnarEventLog(d, segment_bytes=4096, block_rows=16)
        res = _engine(pkg, log=log, analytics=stage).replay_log(
            0, watermark=1e9)
        log.close()
        assert res["columnar"] is True and res["events"] == len(docs)
        results[pkg] = (stage.alerts, aggs)
    assert [_alert_key(a) for a in results[ts][0]] == \
        [_alert_key(a) for a in results[js][0]]
    assert len(results[ts][0]) > 0
    _same_aggs(results[ts][1], results[js][1])


def test_replay_late_events_matches_jax(tmp_path):
    """The journal route: late events recorded in each package's
    DeadLetterJournal replay through the batch path into the same
    windows and alerts, and advance the durable cursor."""
    rng = np.random.default_rng(5)
    recs = [{"key": str(k), "event_time": float(t), "value": 1.0}
            for k, t in zip(rng.choice(["news", "twitter"], 200),
                            rng.uniform(0, 600, 200))]
    out = {}
    for pkg, apkg in ((js, ja), (ts, ta)):
        j = pkg.DeadLetterJournal(str(tmp_path / pkg.__name__))
        for r in recs:
            j.record("late_event", r)
        stage = _stage(apkg)
        aggs = _collect(stage)
        res = _engine(pkg, journal=j, analytics=stage).replay_late_events(
            watermark=1e6)
        assert res["events"] == len(recs)
        assert j.pending() == {}
        out[pkg] = (res, stage.alerts, aggs)
        j.close()
    assert out[ts][0] == out[js][0]
    assert [_alert_key(a) for a in out[ts][1]] == \
        [_alert_key(a) for a in out[js][1]]
    _same_aggs(out[ts][2], out[js][2])


class _Counters:
    def __init__(self):
        self.emitted = 0


class _Terminal:
    """A backend that accepts the first ``accept`` records, then fails."""

    def __init__(self, accept):
        self.accept = accept
        self.counters = _Counters()
        self.got = []

    def emit(self, batch):
        if self.counters.emitted + len(batch) > self.accept:
            raise IOError("backend down")
        self.got.extend(batch)
        self.counters.emitted += len(batch)


class _Sink:
    def __init__(self, accept):
        self.terminal = _Terminal(accept)


def test_replay_dead_letters_matches_jax(tmp_path):
    """The redelivery route: a partial outage stops the pass at the
    failed batch, a second pass delivers the rest exactly once."""
    out = {}
    for pkg in (js, ts):
        j = pkg.DeadLetterJournal(str(tmp_path / pkg.__name__))
        for i in range(40):
            j.record("delivery_failed:es", (f"d{i}", {"n": i}))
        eng = _engine(pkg, journal=j)
        sink = _Sink(accept=16)
        first = eng.replay_dead_letters("delivery_failed:es", sink, batch=8)
        sink.terminal.accept = 1000
        second = eng.replay_dead_letters("delivery_failed:es", sink, batch=8)
        out[pkg] = (first, second, sink.terminal.got, j.pending())
        j.close()
    assert out[ts] == out[js]
    first, second, got, pending = out[ts]
    assert first["stopped_early"] and not second["stopped_early"]
    assert [d for d, _ in got] == [f"d{i}" for i in range(40)]
    assert pending == {}
