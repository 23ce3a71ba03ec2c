"""repro_torch.alerts.batch against repro.alerts.batch: the packers give
identical slots and seg_ids (the hot/cold dedup in the query plane keys
on exact slot floats), and the reducers give the same aggregates —
counts, keys, windows, max and min exactly, sum and sumsq at rtol 1e-5
(f32 sums in another order)."""
import jax  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.alerts import batch as jbatch
from repro.alerts.windows import WindowSpec as JSpec
from repro_torch.alerts import batch as tbatch
from repro_torch.alerts.windows import WindowSpec as TSpec

SPECS = [dict(kind="tumbling", size_s=60.0),
         dict(kind="sliding", size_s=60.0, slide_s=20.0),
         dict(kind="tumbling", size_s=300.0)]


def _events(seed, n=1500):
    rng = np.random.default_rng(seed)
    keys = rng.choice(["news", "twitter", "facebook", "custom_rss"], size=n)
    ts = rng.uniform(0, 3600, size=n)
    vals = rng.normal(size=n) * 5
    return [(str(k), float(t), float(v)) for k, t, v in zip(keys, ts, vals)]


def _columns(events):
    vocab = sorted({k for k, _, _ in events})
    code = {k: i for i, k in enumerate(vocab)}
    ts = np.array([t for _, t, _ in events])
    codes = np.array([code[k] for k, _, _ in events], np.int64)
    vals = np.array([v for _, _, v in events])
    return ts, codes, vals, vocab


@pytest.mark.parametrize("spec", SPECS)
def test_pack_events_identical(spec):
    ev = _events(1)
    jv, js, jslots = jbatch.pack_events(ev, JSpec(**spec))
    tv, ts_, tslots = tbatch.pack_events(ev, TSpec(**spec))
    assert tslots == jslots
    np.testing.assert_array_equal(ts_, js)
    np.testing.assert_array_equal(tv, jv)
    assert ts_.dtype == np.int32 and tv.dtype == np.float32


@pytest.mark.parametrize("spec", SPECS)
def test_pack_columns_identical(spec):
    ts, codes, vals, _ = _columns(_events(2))
    jv, js, jslots = jbatch.pack_columns(ts, codes, vals, JSpec(**spec))
    tv, ts_, tslots = tbatch.pack_columns(ts, codes, vals, TSpec(**spec))
    assert tslots == jslots
    np.testing.assert_array_equal(ts_, js)
    np.testing.assert_array_equal(tv, jv)


def test_pack_rejects_session_windows_in_both():
    for batch, spec in ((jbatch, JSpec(kind="session")),
                        (tbatch, TSpec(kind="session"))):
        with pytest.raises(ValueError):
            batch.pack_events([("k", 1.0, 1.0)], spec)
        with pytest.raises(ValueError):
            batch.pack_columns(np.ones(1), np.zeros(1), np.ones(1), spec)


def _assert_same_aggs(got, exp, with_min):
    assert [(a.key, a.window_start, a.window_end, a.count) for a in got] == \
        [(a.key, a.window_start, a.window_end, a.count) for a in exp]
    assert [a.max for a in got] == [a.max for a in exp]
    if with_min:
        assert [a.min for a in got] == [a.min for a in exp]
    np.testing.assert_allclose([a.sum for a in got], [a.sum for a in exp],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([a.sumsq for a in got],
                               [a.sumsq for a in exp], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("with_min", [False, True])
def test_reduce_events_matches_jax(spec, with_min):
    ev = _events(3)
    exp = jbatch.reduce_events(ev, JSpec(**spec), interpret=True,
                               with_min=with_min)
    got = tbatch.reduce_events(ev, TSpec(**spec), device="cpu",
                               with_min=with_min)
    _assert_same_aggs(got, exp, with_min)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("with_min", [False, True])
def test_reduce_columns_matches_jax(spec, with_min):
    ts, codes, vals, vocab = _columns(_events(4))
    exp = jbatch.reduce_columns(ts, codes, vals, vocab, JSpec(**spec),
                                interpret=True, with_min=with_min)
    got = tbatch.reduce_columns(ts, codes, vals, vocab, TSpec(**spec),
                                device="cpu", with_min=with_min)
    _assert_same_aggs(got, exp, with_min)


def test_reduce_profiler_stage_names():
    from repro_torch.obs import StageProfiler
    prof = StageProfiler("replay")
    ts, codes, vals, vocab = _columns(_events(5, n=50))
    tbatch.reduce_columns(ts, codes, vals, vocab, TSpec(size_s=60.0),
                          device="cpu", profiler=prof)
    assert set(prof.snapshot()) == {"pack_events", "kernel", "unpack"}
    assert tbatch.reduce_events([], TSpec(size_s=60.0), device="cpu") == []
