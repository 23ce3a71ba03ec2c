"""repro_torch's ServeEngine: the cases of tests/test_serve.py on the port
with device="cpu", and the port's engine against the JAX engine on shared
weights.

The weights are the JAX package's qwen2.5 smoke model (``PRNGKey(0)``)
carried over by the weight bridge.  Greedy streams must be equal; where
one parts from the reference, the reference's top-2 logit margin at that
step (recomputed by a JAX prefill over the prompt and the tokens both
streams share) must be within the bf16 tolerance of tests/
test_torch_model.py, 8e-2 of the step's largest |logit|: the two
libraries round bf16 at other places, and the random model's sharp
attention turns one rounding into a few percent of a logit.  In f32 the
streams must be equal outright.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.configs import get_arch as jax_arch
from repro.models.model import build_model as jax_build
from repro.models.param import init_params as jax_init
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.config import ServeConfig
from repro_torch.configs import get_arch
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import build_model
from repro_torch.models.param import params_from_numpy
from repro_torch.serve.engine import Request, ServeEngine

NEAR_TIE = 8e-2


@pytest.fixture(scope="module")
def setup():
    cfg = get_arch("qwen2_5_3b").smoke
    model = build_model(cfg)
    jax_params = jax_init(jax_build(jax_arch("qwen2_5_3b").smoke)
                          .param_defs(), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jax_params),
                               "cpu")
    tok = HashTokenizer(cfg.vocab)
    return cfg, model, params, tok, jax_params


def _engine(model, params, **kw):
    base = dict(max_batch=4, max_seq_len=96, replenish_after=2,
                replenish_timeout_s=0.01)
    base.update(kw)
    return ServeEngine(model, params, ServeConfig(**base), eos_id=-1,
                       device="cpu")


def test_continuous_batching_matches_solo(setup):
    cfg, model, params, tok, _ = setup
    eng = _engine(model, params)
    reqs = [Request(rid=i, prompt_tokens=tok.encode(f"hello news {i} " + "x " * i,
                                                    add_eos=False),
                    max_new_tokens=6) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    done = {r.rid: r for r in eng.run_until_drained()}
    assert len(done) == 6
    # fewer steps than sequential decoding proves batching happened
    assert eng.steps < 6 * 6

    for i in (0, 3, 5):
        solo = _engine(model, params, max_batch=1)
        r = Request(rid=100 + i, prompt_tokens=list(reqs[i].prompt_tokens),
                    max_new_tokens=6)
        solo.submit(r)
        solo.run_until_drained()
        assert r.output_tokens == done[i].output_tokens, i


def test_priority_requests_admitted_first(setup):
    cfg, model, params, tok, _ = setup
    eng = _engine(model, params, max_batch=1, replenish_after=1)
    normal = [Request(rid=i, prompt_tokens=tok.encode("aa bb", add_eos=False),
                      max_new_tokens=2, priority=1) for i in range(3)]
    vip = Request(rid=99, prompt_tokens=tok.encode("cc dd", add_eos=False),
                  max_new_tokens=2, priority=0)
    for r in normal:
        eng.submit(r)
    eng.submit(vip)
    done = eng.run_until_drained()
    assert done[0].rid == 99                      # priority served first


def test_queue_overflow_dead_letters(setup):
    cfg, model, params, tok, _ = setup
    eng = _engine(model, params, queue_capacity=2)
    ok = [eng.submit(Request(rid=i, prompt_tokens=[1, 2], max_new_tokens=1))
          for i in range(4)]
    assert ok == [True, True, False, False]
    assert eng.dead_letters.total == 2


def _latency_stage():
    from repro_torch.alerts import AnalyticsStage, ThresholdRule, WindowSpec
    return AnalyticsStage(
        WindowSpec(size_s=1.0, allowed_lateness_s=0.0),
        [ThresholdRule("slow_requests", metric="max", op=">=", threshold=0.0)],
        key_fn=lambda d: "serve",
        value_fn=lambda d: d["latency"],
        time_fn=lambda d: d["published_at"])


def _drive_with_fake_clock(eng, tok, fake_now):
    for i in range(3):
        eng.submit(Request(rid=i, prompt_tokens=tok.encode("aa bb",
                                                           add_eos=False),
                           max_new_tokens=2, arrived_at=fake_now[0]))
    for _ in range(40):
        fake_now[0] += 0.3                        # latency accrues per step
        eng.step()
        if not any(eng.active) and not len(eng.main_q) + len(eng.prio_q):
            break
    fake_now[0] += 5.0
    eng.step()                                    # close the latency windows


def test_subscriber_receives_every_alert_with_no_polling(setup):
    """ServeEngine push surface: a subscriber registered up front gets
    every rule alert AND dead-letter threshold alert as they fire —
    fired_alerts() is only used at the end to prove parity."""
    cfg, model, params, tok, _ = setup
    fake_now = [0.0]
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=2, max_seq_len=96, replenish_after=1,
        replenish_timeout_s=0.01), eos_id=-1,
        clock=lambda: fake_now[0], analytics=_latency_stage(), device="cpu")
    pushed = []
    sub = eng.subscribe_alerts(callback=pushed.append)
    it = eng.subscribe_alerts(capacity=1024)
    _drive_with_fake_clock(eng, tok, fake_now)
    assert pushed and all(a.rule == "slow_requests" for a in pushed)
    # dead-letter threshold alerts arrive through the SAME hub, pushed
    for _ in range(eng.dead_letters.alert_threshold):
        eng.dead_letters.publish("x", reason="mailbox_overflow")
    assert any(a.rule == "dead_letters" for a in pushed)
    # the push stream saw exactly what the poll view reports
    polled = eng.fired_alerts()
    assert len(pushed) == len(polled)
    assert {(a.rule, a.message) for a in pushed} == \
        {(a.rule, a.message) for a in polled}
    # the bounded iterator subscription saw the same stream
    assert [a.rule for a in it] == [a.rule for a in pushed]
    sub.close()


def test_engine_exposes_fired_alerts(setup):
    """ServeEngine + AnalyticsStage: per-request latency metrics windowed
    on the request clock; a latency-threshold rule surfaces through
    fired_alerts()."""
    cfg, model, params, tok, _ = setup
    fake_now = [0.0]
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=2, max_seq_len=96, replenish_after=1,
        replenish_timeout_s=0.01), eos_id=-1,
        clock=lambda: fake_now[0], analytics=_latency_stage(), device="cpu")
    assert eng.fired_alerts() == []
    _drive_with_fake_clock(eng, tok, fake_now)
    fired = eng.fired_alerts()
    assert fired and all(a.rule == "slow_requests" for a in fired)
    assert all(a.key == "serve" and a.value >= 0.0 for a in fired)
    # dead-letter threshold alerts surface as the SAME Alert type
    for _ in range(eng.dead_letters.alert_threshold):
        eng.dead_letters.publish("x", reason="mailbox_overflow")
    mixed = eng.fired_alerts()
    assert any(a.rule == "dead_letters" for a in mixed)
    assert all(hasattr(a, "rule") and hasattr(a, "severity") for a in mixed)


def test_replay_status_and_store_mounted_journal(setup, tmp_path):
    from repro_torch.store import StorePlane

    cfg, model, params, tok, _ = setup
    # without a store plane the surface reports disabled, nothing more
    bare = _engine(model, params)
    assert bare.replay_status() == {"enabled": False}

    # with a store plane, the engine's dead letters are journaled
    # durably and replay_status() exposes journal + replay state
    store = StorePlane(str(tmp_path / "serve_store"), device="cpu")
    eng = ServeEngine(model, params,
                      ServeConfig(max_batch=4, max_seq_len=96,
                                  replenish_after=2,
                                  replenish_timeout_s=0.01,
                                  queue_capacity=2),
                      eos_id=-1, store=store, device="cpu")
    for i in range(4):                            # 2 overflow -> dead letters
        eng.submit(Request(rid=i, prompt_tokens=[1, 2], max_new_tokens=1))
    assert eng.dead_letters.total == 2
    st = eng.replay_status()
    assert st["enabled"]
    assert st["journal"]["reasons"] == {"mailbox_overflow": 2}
    assert st["pending"] == {"mailbox_overflow": 2}
    store.close()


def test_unattached_planes_report_disabled(setup):
    cfg, model, params, tok, _ = setup
    eng = _engine(model, params)
    for status in (eng.query_status, eng.ingest_status, eng.delivery_status,
                   eng.obs_status, eng.slo_status):
        assert status() == {"enabled": False}
    with pytest.raises(RuntimeError, match="no query plane"):
        eng.query(None)
    with pytest.raises(RuntimeError, match="no ingestion plane"):
        eng.add_source("news")


def test_params_on_another_device_are_refused(setup):
    cfg, model, params, tok, _ = setup

    class Elsewhere(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1, device="meta"))

    with pytest.raises(ValueError, match="params on meta"):
        ServeEngine(model, Elsewhere(), ServeConfig(max_batch=1,
                                                    max_seq_len=8),
                    device="cpu")


def _requests(tok, n=6):
    rng = np.random.default_rng(7)
    words = "market news alert storm earnings court vote data".split()
    out = []
    for i in range(n):
        text = " ".join(rng.choice(words, size=3 + 9 * i))
        out.append((i, tok.encode(text, add_eos=False), i % 3 == 0))
    return out


def _jax_margin(jm, jp, prompt, shared):
    """The reference's top-2 margin and largest |logit| at the step after
    ``shared`` tokens: a JAX prefill over the prompt and those tokens."""
    ids = jnp.asarray([list(prompt) + list(shared)], jnp.int32)
    last, _ = jm.prefill(jp, {"tokens": ids})
    row = np.asarray(last[0], np.float32)
    top = np.sort(row)[-2:]
    return float(top[1] - top[0]), float(np.abs(row).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_engine_matches_jax_engine(setup, dtype):
    """The same requests through both engines, same batch and admission
    settings, on the same weights."""
    cfg, model, _, tok, jax_params = setup
    jp = jax.tree.map(lambda a: a.astype(dtype), jax_params)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    jm = jax_build(jax_arch("qwen2_5_3b").smoke)
    settings = dict(max_batch=3, max_seq_len=128, replenish_after=1,
                    replenish_timeout_s=0.0)
    port = ServeEngine(model, params, ServeConfig(**settings), eos_id=-1,
                       clock=lambda: 0.0, device="cpu")
    ref = JaxServeEngine(jm, jp, JaxServeConfig(**settings), eos_id=-1,
                         clock=lambda: 0.0)
    for rid, ids, vip in _requests(tok):
        prio = 0 if vip else 1
        port.submit(Request(rid=rid, prompt_tokens=ids, max_new_tokens=10,
                            priority=prio))
        ref.submit(JaxRequest(rid=rid, prompt_tokens=ids, max_new_tokens=10,
                              priority=prio))
    got = {r.rid: r for r in port.run_until_drained()}
    exp = {r.rid: r for r in ref.run_until_drained()}
    assert sorted(got) == sorted(exp)
    assert [r.rid for r in port.completed] == [r.rid for r in ref.completed]
    assert port.steps == ref.steps
    for rid, e in exp.items():
        a, b = got[rid].output_tokens, e.output_tokens
        assert len(a) == len(b) == 10
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        if first is None:
            continue
        assert dtype == "bfloat16", (rid, a, b)
        margin, scale = _jax_margin(jm, jp, e.prompt_tokens, b[:first])
        assert margin <= NEAR_TIE * scale, (rid, first, margin, scale)
