"""repro_torch.query against repro.query: cold-range parity (the shape
of tests/test_query.py's cold-range tests, built without the pipeline).

Windows close into each package's MaterializedStore with a small
retention, so the floor rises; ranges below it are recomputed from the
event log through the batch path (the kernel path's plain version here,
Pallas interpret mode in the JAX package).  Points must agree: counts
and the min / max lanes exactly, sums at rtol 1e-5; counts also equal a
pure-Python fold of the documents."""
import math

import jax  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.alerts as ja
import repro.query as jq
import repro.store as js
import repro_torch.alerts as ta
import repro_torch.query as tq
import repro_torch.store as ts

SIZE_S = 60.0
END = 2400.0


def _docs():
    rng = np.random.default_rng(21)
    n = 3000
    t = np.sort(rng.uniform(0, END, size=n))
    ch = rng.choice(["news", "twitter"], size=n, p=[0.7, 0.3])
    v = np.round(rng.normal(size=n) * 4, 3)
    return [{"channel": str(c), "published_at": float(x), "value": float(y)}
            for c, x, y in zip(ch, t, v)]


def _plane(apkg, qpkg, spkg, log, columnar):
    stage = apkg.AnalyticsStage(
        apkg.WindowSpec(size_s=SIZE_S), [],
        value_fn=lambda doc: float(doc.get("value", 1.0)))
    kw = dict(interpret=True) if qpkg is jq else dict(device="cpu")
    plane = qpkg.QueryPlane(stage, log=log, max_windows_per_key=5,
                            columnar_lanes=columnar, **kw)
    return stage, plane


def _build(tmp_path, columnar):
    docs = _docs()
    out = {}
    for apkg, qpkg, spkg in ((ja, jq, js), (ta, tq, ts)):
        d = str(tmp_path / f"{spkg.__name__}-{columnar}")
        if columnar:
            log = spkg.ColumnarEventLog(d, segment_bytes=1 << 14,
                                        block_rows=64)
        else:
            log = spkg.EventLog(d, segment_bytes=1 << 14)
        for i in range(0, len(docs), 100):
            log.append([{"id": f"d{i + j}", "doc": doc}
                        for j, doc in enumerate(docs[i:i + 100])])
        if columnar:
            log.roll()
        stage, plane = _plane(apkg, qpkg, spkg, log, columnar)
        for doc in docs:
            stage.observe(doc, now=doc["published_at"])
        stage.advance(END + 10 * SIZE_S)
        st = plane.status()
        assert st["evicted_windows"] > 0 and st["floor"] > 0.0
        out[qpkg] = (plane, log)
    return docs, out


def _reference_counts(docs, start, end):
    got = {}
    for d in docs:
        if d["channel"] != "news":
            continue
        s = math.floor(d["published_at"] / SIZE_S) * SIZE_S
        if s + SIZE_S > start and s < end:
            got[(s, s + SIZE_S)] = got.get((s, s + SIZE_S), 0) + 1
    return got


@pytest.mark.parametrize("columnar", [False, True])
def test_cold_range_query_parity_with_jax(tmp_path, columnar):
    docs, planes = _build(tmp_path, columnar)
    jplane, _ = planes[jq]
    tplane, tlog = planes[tq]
    floor = tplane.status()["floor"]
    assert floor == jplane.status()["floor"]
    for start, end, source in ((0.0, END, "mixed"),
                               (0.0, min(floor, 300.0), "cold")):
        for agg in ("count", "min", "max", "sum"):
            q_t = tq.AggQuery(channel="news", start=start, end=end, agg=agg)
            q_j = jq.AggQuery(channel="news", start=start, end=end, agg=agg)
            got, exp = tplane.query(q_t), jplane.query(q_j)
            assert got.source == exp.source == source
            assert [(p["start"], p["end"], p["count"]) for p in got.points] \
                == [(p["start"], p["end"], p["count"]) for p in exp.points]
            if agg == "sum":
                np.testing.assert_allclose(got.values(), exp.values(),
                                           rtol=1e-5, atol=1e-5)
            else:
                assert got.values() == exp.values()
        counts = {(p["start"], p["end"]): p["count"] for p in got.points}
        assert counts == _reference_counts(docs, start, end)
    st = tplane.status()
    assert st["cold_scans"] == 8
    assert st["cold_columnar"] == (8 if columnar else 0)
    tlog.close()
    planes[jq][1].close()


def test_cold_query_without_log_stays_hot_only():
    stage = ta.AnalyticsStage(ta.WindowSpec(size_s=SIZE_S), [])
    plane = tq.QueryPlane(stage, max_windows_per_key=3, device="cpu")
    for doc in _docs()[:500]:
        stage.observe(doc, now=doc["published_at"])
    stage.advance(END + 10 * SIZE_S)
    assert plane.status()["floor"] > 0.0
    res = plane.query(tq.AggQuery(channel="news", start=0.0, end=END))
    assert res.source == "hot" and plane.status()["cold_scans"] == 0


def test_slice_end_to_end_matches_jax(tmp_path):
    """The whole slice as chip_smoke.py drives it, in miniature: documents
    into a columnar StorePlane, sealed, replayed into the rules and the
    materialized store, then a mixed and a cold query — the same alerts
    and points from both packages."""
    docs = _docs()
    out = {}
    for apkg, qpkg, spkg in ((ja, jq, js), (ta, tq, ts)):
        stage = apkg.AnalyticsStage(
            apkg.WindowSpec(size_s=SIZE_S),
            [apkg.ThresholdRule("volume", metric="count", threshold=1.0),
             apkg.ZScoreRule("anomaly", metric="count", z=2.5)])
        kw = dict(interpret=True) if qpkg is jq else dict(device="cpu")
        store = spkg.StorePlane(str(tmp_path / spkg.__name__),
                                columnar=True, segment_bytes=1 << 14,
                                block_rows=64, analytics=stage, **kw)
        plane = qpkg.QueryPlane(stage, log=store.log, staleness_s=None,
                                max_windows_per_key=8, columnar_lanes=True,
                                **kw)
        store.append_documents([(f"d{i}", d) for i, d in enumerate(docs)])
        store.log.roll()
        res = store.replay.replay_log(0, watermark=END)
        assert res["columnar"] and res["events"] == len(docs)
        floor = plane.store.floor
        answers = []
        for start, end in ((0.0, END), (0.0, floor / 2)):
            for agg in ("count", "max", "min"):
                r = plane.query(qpkg.AggQuery(channel="news", start=start,
                                              end=end, agg=agg))
                answers.append((r.source, [(p["start"], p["count"],
                                            p["value"]) for p in r.points]))
        out[qpkg] = (res, [(a.rule, a.key, a.window_end, a.value)
                           for a in stage.alerts], floor, answers)
        store.close()
    assert out[tq] == out[jq]
    assert [src for src, _ in out[tq][3]] == ["mixed"] * 3 + ["cold"] * 3
