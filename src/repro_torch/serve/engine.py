"""Continuous-batching serving engine — the FeedRouter pull logic applied
to inference requests.

Requests arrive in a main + a priority bounded queue (AlertMix Fig. 3).
The decode loop keeps `max_batch` slots; the router's replenishment rules
govern admission:
  (a) aim for a full slot set (optimal = max_batch)
  (b) after `replenish_after` sequences FINISH, admit waiting requests
  (c) a timeout admits them anyway (bounds time-to-first-token)
  (d) admission fills back to optimal
New requests are prefilled individually, at their exact length, and
their KV rows scattered into the shared batched cache; every decode step
advances ALL active slots in one call.

The port's counterpart of ``repro/serve/engine.py``: the same admission
rules, cache scatter, done test and status surfaces, on an explicit
``device`` (default ``"cuda"``, which raises without a card).  The JAX
package's ``jax.jit`` caches become plain calls and its functional cache
updates become in-place writes into the engine's tensors.  Prefill runs
the hand-written flash-attention kernel once per layer on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.config import ServeConfig
from repro_torch.core.dead_letters import DeadLettersListener
from repro_torch.core.queues import BoundedPriorityQueue, Message
from repro_torch.delivery import Subscription, SubscriptionHub
from repro_torch.kernels import resolve_device
from repro_torch.models.model import BaseModel


@dataclass
class Request:
    rid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 32
    priority: int = 1
    arrived_at: float = 0.0
    # filled by the engine
    output_tokens: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ServeEngine:
    def __init__(self, model: BaseModel, params, cfg: ServeConfig,
                 *, eos_id: int = 2, clock: Callable[[], float] = time.monotonic,
                 analytics=None, store=None, ingest=None, query=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if isinstance(params, torch.nn.Module):
            on = next(params.parameters()).device
            if on.type != self.device.type:
                raise ValueError(f"params on {on}, engine on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.clock = clock
        # optional ingestion plane (an AlertMixPipeline or anything with
        # its control API): the serving tier re-exposes the runtime
        # control surface so operators manage sources/channels through
        # the same front door that serves inference
        self.ingest = ingest
        # optional repro_torch.store.StorePlane: journals this engine's
        # dead letters durably and exposes replay_status()
        self.store = store
        # optional repro_torch.query.QueryPlane (explicit, or inherited
        # from the attached pipeline): the serving tier's aggregate-read
        # surface
        self._query = query
        self.dead_letters = DeadLettersListener(
            alert_hook=self._on_dead_letter_alert,
            journal=None if store is None else store.journal)
        # optional repro_torch.alerts.AnalyticsStage: per-request latency
        # metrics windowed on the request clock; alerts stream to
        # subscribers via subscribe_alerts() (fired_alerts() remains as a
        # poll-compat view)
        self.analytics = analytics
        if store is not None and store.replay.analytics is None:
            store.replay.analytics = analytics    # batch/live unification
        # one homogeneous push surface: rule alerts land here through the
        # stage's AlertSink hub; dead-letter threshold alerts are emitted
        # into the SAME hub by the hook above
        stage_hub = getattr(getattr(analytics, "sink", None), "hub", None)
        self.alert_hub: SubscriptionHub = (
            stage_hub if stage_hub is not None
            else SubscriptionHub(name="serve-alerts"))
        self.main_q = BoundedPriorityQueue(cfg.queue_capacity,
                                           dead_letters=self.dead_letters)
        self.prio_q = BoundedPriorityQueue(cfg.queue_capacity,
                                           dead_letters=self.dead_letters)

        b, s = cfg.max_batch, cfg.max_seq_len
        self.cache = model.init_cache(b, s, device=self.device)
        self.tokens = torch.zeros((b, 1), dtype=torch.int32,
                                  device=self.device)
        self.active = np.zeros(b, dtype=bool)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.finished_since_admit = 0
        self.last_admit_at = 0.0
        self.completed: List[Request] = []
        self.steps = 0
        self.tokens_generated = 0

    # ---- request admission (FeedRouter rules) -------------------------------
    def submit(self, req: Request) -> bool:
        q = self.prio_q if req.priority == 0 else self.main_q
        return q.offer(Message(priority=req.priority, payload=req,
                               enqueued_at=self.clock()))

    def _free_slots(self) -> List[int]:
        return [i for i, a in enumerate(self.active) if not a]

    def _should_admit(self, now: float) -> bool:
        if not any(self.active):
            return True                                   # cold start
        count_hit = self.finished_since_admit >= self.cfg.replenish_after
        timeout_hit = (now - self.last_admit_at) >= self.cfg.replenish_timeout_s
        return count_hit or timeout_hit

    def _admit(self, now: float) -> int:
        free = self._free_slots()
        admitted = 0
        for slot in free:
            msg = self.prio_q.poll() or self.main_q.poll()
            if msg is None:
                break
            req: Request = msg.payload
            self._prefill_into_slot(req, slot, now)
            admitted += 1
        if admitted or self.finished_since_admit:
            self.finished_since_admit = 0
            self.last_admit_at = now
        return admitted

    def _prefill_into_slot(self, req: Request, slot: int, now: float) -> None:
        # prefill at the EXACT prompt length: padding would corrupt SSM
        # states (sequential) and pollute attention; the kernel takes
        # any length
        max_prompt = self.cfg.max_seq_len - req.max_new_tokens
        ids = req.prompt_tokens[-max_prompt:]
        bl = len(ids)
        batch = {"tokens": torch.tensor([ids], dtype=torch.int32,
                                        device=self.device)}
        with torch.no_grad():
            last_logits, pcache = self.model.prefill(self.params, batch)

        # scatter the prefilled KV rows into the shared cache at `slot`;
        # the slot's positions past the prompt are zeroed, as the
        # reference pads the rows before writing them.  (The SSM / conv
        # state scatter arrives with the Mamba2 serve path, ROADMAP A9.)
        for key in ("k", "v"):
            if key in self.cache:
                big = self.cache[key]
                big[:, slot, :bl] = pcache[key][:, 0].to(big.dtype)
                big[:, slot, bl:] = 0
        self.cache["pos"][slot] = bl

        first = int(torch.argmax(last_logits[0]))
        req.output_tokens.append(first)
        req.first_token_at = now
        self.tokens[slot, 0] = first
        self.active[slot] = True
        self.slot_req[slot] = req

    # ---- decode loop ---------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit if due, then one batched decode."""
        now = self.clock()
        if self._should_admit(now):
            self._admit(now)
        if not any(self.active):
            if self.analytics is not None:      # idle ticks still advance
                self.analytics.advance(now)     # the latency watermark
            return 0
        with torch.no_grad():
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self.tokens)
            nxt_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = nxt_dev.cpu().numpy()          # waits for the step's work
        pos = self.cache["pos"].tolist()
        self.steps += 1
        produced = 0
        for slot, req in enumerate(self.slot_req):
            if req is None or not self.active[slot]:
                continue
            tok = int(nxt[slot])
            req.output_tokens.append(tok)
            produced += 1
            done = (tok == self.eos_id
                    or len(req.output_tokens) >= req.max_new_tokens
                    or pos[slot] >= self.cfg.max_seq_len - 1)
            if done:
                req.finished_at = now
                self.completed.append(req)
                self.slot_req[slot] = None
                self.active[slot] = False
                self.finished_since_admit += 1
                if self.analytics is not None:
                    self.analytics.observe(
                        {"channel": "serve", "published_at": now,
                         "latency": now - req.arrived_at}, now=now)
        self.tokens = nxt_dev[:, None]
        self.tokens_generated += produced
        if self.analytics is not None:
            self.analytics.advance(now)
        return produced

    # ---- alert delivery ------------------------------------------------------
    def _wrap_dead_letter_alert(self, message: str):
        from repro_torch.alerts import Alert

        return Alert(
            rule="dead_letters", key="serve", window_start=0.0,
            window_end=0.0, metric="count",
            value=float(self.dead_letters.alert_threshold),
            message=message, severity="critical")

    def _on_dead_letter_alert(self, reason: str, threshold: int) -> None:
        # push into the shared hub so subscribers see dead-letter alerts
        # interleaved with rule alerts, as one homogeneous Alert type
        self.alert_hub.emit([self._wrap_dead_letter_alert(
            f"dead-letter threshold reached: {reason} x {threshold}")])

    def subscribe_alerts(self, callback=None, *, capacity: int = 256,
                         key_fn=None) -> Subscription:
        """Stream every alert this engine raises — analytics-rule alerts
        AND dead-letter threshold alerts — with no polling: a callback
        fires at emit time, or iterate the returned bounded-buffer
        Subscription (per-rule backpressure; see repro_torch.delivery)."""
        return self.alert_hub.subscribe(callback, capacity=capacity,
                                        key_fn=key_fn)

    def iter_alerts(self, *, rule=None, capacity: int = 256):
        """``async for alert in engine.iter_alerts()`` — the asyncio form
        of ``subscribe_alerts``: event-driven, one coroutine (never a
        thread) per consumer, optionally filtered to one rule name."""
        return self.alert_hub.async_iter(rule, capacity=capacity)

    def fired_alerts(self) -> List:
        """POLL-COMPAT view (prefer ``subscribe_alerts``): every alert
        this engine has raised, as ``repro_torch.alerts.Alert`` records:
        analytics-stage rule alerts (when an AnalyticsStage is mounted)
        + dead-letter threshold alerts (wrapped so consumers see one
        homogeneous type)."""
        out: List = []
        if self.analytics is not None:
            out.extend(self.analytics.alerts)
        for msg in self.dead_letters.alerts:
            out.append(self._wrap_dead_letter_alert(msg))
        return out

    def replay_status(self) -> dict:
        """Status of the durability/replay plane (repro_torch.store)
        mounted on this engine — replay-engine stats, journal
        reasons/cursors, and pending-per-reason counts — or
        ``{"enabled": False}`` when the engine runs without a store."""
        if self.store is None:
            return {"enabled": False}
        return {"enabled": True, **self.store.replay.status()}

    # ---- query/serving plane (repro_torch.query) -----------------------------------
    def _query_plane(self):
        if self._query is not None:
            return self._query
        return getattr(self.ingest, "query", None)

    def _require_query(self):
        plane = self._query_plane()
        if plane is None:
            raise RuntimeError(
                "no query plane attached: construct with "
                "ServeEngine(..., query=<QueryPlane>) or attach a "
                "pipeline built with PipelineConfig(query=True)")
        return plane

    def query(self, q, **kw):
        """Answer an ``AggQuery`` against the attached query plane —
        materialized hot segments, cold EventLog replay, result cache,
        staleness gate (see repro_torch.query)."""
        return self._require_query().query(q, **kw)

    def watch_query(self, q, **kw):
        """``async for result in engine.watch_query(q)`` — re-evaluated
        exactly when the materialized store changes; no polling."""
        return self._require_query().watch(q, **kw)

    def query_status(self) -> dict:
        """Query-plane counters (queries, cache hits/misses, stale
        rejections, cold scans, segment/watermark state), or
        ``{"enabled": False}`` when no plane is attached."""
        plane = self._query_plane()
        if plane is None:
            return {"enabled": False}
        return {"enabled": True, **plane.status()}

    # ---- ingestion control surface (repro.ingest) ---------------------------
    # The serving tier is the operator's front door: when an ingestion
    # plane is attached (``ingest=``), the pipeline's runtime control API
    # is re-exposed here verbatim.

    def _require_ingest(self):
        if self.ingest is None:
            raise RuntimeError(
                "no ingestion plane attached: construct with "
                "ServeEngine(..., ingest=<AlertMixPipeline>)")
        return self.ingest

    def add_source(self, channel: str, **kwargs) -> int:
        return self._require_ingest().add_source(channel, **kwargs)

    def remove_source(self, sid: int) -> bool:
        return self._require_ingest().remove_source(sid)

    def pause(self, sid: int) -> bool:
        return self._require_ingest().pause(sid)

    def resume(self, sid: int) -> bool:
        return self._require_ingest().resume(sid)

    def register_channel(self, name: str) -> bool:
        return self._require_ingest().register_channel(name)

    def register_connector(self, connector, name=None) -> str:
        return self._require_ingest().register_connector(connector, name)

    def list_sources(self, *, channel=None) -> List[dict]:
        return self._require_ingest().list_sources(channel=channel)

    def push(self, sid: int, docs: list) -> int:
        return self._require_ingest().push(sid, docs)

    def ingest_status(self) -> dict:
        """One operator view of the attached ingestion plane: channels,
        connectors, source count, scheduler counters, and per-connector
        fetch-rate/back-pressure counters (fetches, items, errors,
        backoffs applied, total deferred seconds)."""
        if self.ingest is None:
            return {"enabled": False}
        p = self.ingest
        return {
            "enabled": True,
            "channels": list(p.channels()),
            "connectors": list(p.connectors.names()),
            "sources": len(p.registry),
            "registry_shards": getattr(p.registry, "num_shards", 1),
            "picked_total": p.scheduler.picked_total,
            "requeued_total": p.scheduler.requeued_total,
            "unroutable": p.distributor.unroutable,
            "connector_stats": p.connector_stats(),
        }

    def delivery_status(self) -> dict:
        """The attached pipeline's live delivery counters — per-backend
        emitted/retried/dead_lettered/lag/health, plus queue depth and
        hand-off p99 when the flow-controlled dispatch plane
        (``delivery_dispatch``) is on."""
        if self.ingest is None:
            return {"enabled": False}
        return {"enabled": True, **self.ingest.delivery_stats()}

    def metrics_text(self) -> str:
        """Prometheus text exposition of the attached pipeline's metrics
        registry (the operator scrape endpoint's payload)."""
        return self._require_ingest().metrics_text()

    def obs_status(self) -> dict:
        """Observability-plane status of the attached pipeline (tracer
        counters, registered metric names, self-monitoring state), or
        ``{"enabled": False}`` without an ingestion plane."""
        if self.ingest is None:
            return {"enabled": False}
        return {"enabled": True, **self.ingest.obs_status()}

    def slo_status(self) -> dict:
        """SLO error budgets + burn rates of the attached pipeline
        (``repro.obs.slo``), or ``{"enabled": False}`` without an
        ingestion plane / without configured SLOs."""
        if self.ingest is None:
            return {"enabled": False}
        return self.ingest.slo_status()

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            pending = len(self.main_q) + len(self.prio_q)
            if not pending and not any(self.active):
                break
            self.step()
        return self.completed
