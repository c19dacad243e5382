"""The continuous-batching inference engine (DESIGN.md §3).

One *batched prefill* runs each admission group's full prompts through
causal attention and writes their K/V into the paged pool; one *fused
decode step* advances every slot at its own position and samples the next
token on the device. The sampled token tensor is fed straight back into
the next decode call, so the host never reads a token mid-flight. Because
stopping is purely budget-based, the loop dispatches a whole decode
*segment* (until the earliest active request exhausts its budget) and
syncs only at segment boundaries, two deep: each boundary waits for the
PREVIOUS segment's completion event while the one just dispatched runs.

With ``spec_k > 0`` a segment interleaves draft/verify *rounds* instead
of single-token steps (self-speculative decoding, DESIGN.md §4): K greedy
draft steps with the draft parameter set, then one multi-token verify
that emits 1..K+1 tokens per slot. Budgets are clamped on the device, so
the rounds of a segment read nothing on the host; the boundary reads
every round's token counts at once. ``spec_fanout`` turns a round into a
token TREE (DESIGN.md §8): top-k branches per draft depth, one T = N+1
tree-attention verify and an accepted-path KV compaction, optionally
retuned per segment from the observed acceptance (``spec_adaptive``).

With ``prefix_cache=True`` admission maps a prompt's cached full-page
prefix onto pages other requests already wrote (DESIGN.md §13,
``engine/prefix_cache.py``), and the slot prefills only its unshared
tail: one ragged multi-token decode dispatch (``tail_fn``) for all such
slots of an admission group, beside the batched prefill of the others.

With ``prefill_chunk_tokens > 0`` prefill stops being atomic (chunked
prefill, DESIGN.md §14): a prompt whose unshared tail needs more than one
chunk enters ``PREFILLING`` and feeds one chunk of at most that many
tokens per scheduling boundary through the same ragged ``tail_fn`` (a
chunk is a tail whose shared boundary is the previous chunk's end), while
the other slots decode in one-step segments between the chunks.

Steps are plain eager PyTorch functions (no ``torch.compile``, no CUDA
graphs). Timed admission and the resilience features of the reference
engine (with them preemption, the spec ladder's pressure degrade and
fault injection; ROADMAP A.5) are a later slice: ``run`` raises when
asked for them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.engine.kv_cache import PagedKVCache
from repro_torch.engine.metrics import EngineMetrics
from repro_torch.engine.resilience import ResilienceConfig
from repro_torch.engine.sampling import SamplingParams, sample
from repro_torch.engine.scheduler import DECODE, PREFILLING, Request, Scheduler
from repro_torch.engine.spec import TreeTemplate, spec_step_fns, tree_step_fns
from repro_torch.engine.spec.drafter import draft_config
from repro_torch.engine.telemetry import Telemetry
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import split_layers


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 4
    max_seq: int = 64                 # per-request prompt + budget cap
    page_size: int = 16
    num_pages: Optional[int] = None   # None: num_slots * max_seq / page_size
    prompt_bucket_min: int = 8        # prefill pad bucket floor (pow2 above)
    seed: int = 0
    device: Optional[str] = None      # None: the card; "cpu" explicitly
    # speculative decoding: draft K tokens per round with the draft
    # parameter set (``draft_params``), verify them in one multi-token
    # target step; 0 disables. spec_draft_layers: the drafter's depth for
    # depth-pruned profiles (None = full depth; must match
    # core.model_compress.draft_layers of the profile).
    spec_k: int = 0
    spec_draft_layers: Optional[int] = None
    # token-TREE drafting: fanout per draft depth, e.g. (4, 2, 2) = 28
    # nodes, depth 3; overrides spec_k (which stays the chain path)
    spec_fanout: Optional[Tuple[int, ...]] = None
    # retune the tree per segment from the per-slot acceptance EWMA:
    # thrash shrinks it to a chain K=1, sustained acceptance widens it
    # back to the full spec_fanout
    spec_adaptive: bool = False
    # shared-prefix KV reuse (engine/prefix_cache.py, DESIGN.md §13):
    # admission maps cached full-page prompt blocks to existing pages
    # (refcounted, copy-on-write) and prefills only the unshared tail
    prefix_cache: bool = False
    # the reference engine's resilience options, a later slice (ROADMAP
    # A.5); any value but the default makes run() raise
    resilience: Optional[ResilienceConfig] = None
    # chunked prefill (DESIGN.md §14): split each admitted prompt into
    # chunks of at most this many tokens, fed between decode steps instead
    # of one monolithic prefill; 0 = monolithic
    prefill_chunk_tokens: int = 0


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def plan_chunks(start: int, prompt_len: int,
                budget: int) -> List[Tuple[int, int]]:
    """Chunk planner (DESIGN.md §14): split prompt positions
    [start, prompt_len) into ``(chunk_start, chunk_len)`` pieces of at
    most ``budget`` tokens, covering every position once. The last chunk
    ends exactly at ``prompt_len`` (its sample is the request's first
    token), so it is never empty. ``budget <= 0`` means one chunk."""
    if budget <= 0:
        return [(start, prompt_len - start)]
    out = []
    p = start
    while p < prompt_len:
        n = min(budget, prompt_len - p)
        out.append((p, n))
        p += n
    return out


def _step_fns(cfg, sampling: SamplingParams):
    """The prefill, decode and tail-prefill steps (eager, on the params'
    device)."""
    api = get_model(cfg)

    def prefill_fn(params, cache, tokens, lengths, block_tables, gen):
        logits, _ = api.prefill(params, cache, tokens, lengths,
                                block_tables, cfg)
        return sample(logits[:, -1, :], gen, sampling)

    def decode_fn(params, cache, tokens, positions, block_tables, active,
                  gen, max_live):
        logits, _ = api.decode_step(params, cache, tokens[:, None],
                                    positions, cfg, block_tables,
                                    max_live_pages=max_live)
        return sample(logits[:, -1, :], gen, sampling), positions + active

    def tail_fn(params, cache, tokens, positions, feed_len, block_tables,
                gen, max_live):
        # prefix-cache tail prefill (DESIGN.md §13): slots whose prompt
        # prefix lies on cached pages feed only the unshared tail, a
        # ragged multi-token decode block (token t writes and attends at
        # positions + t; rows padded to one T, their writes dropped past
        # feed_len). The first token comes from each row's LAST real
        # token; assign's clamp guarantees feed_len >= 1 in every row
        # that is fed.
        logits, _ = api.decode_step(params, cache, tokens, positions, cfg,
                                    block_tables, max_live_pages=max_live,
                                    feed_len=feed_len)
        last = (feed_len.long() - 1).clamp_min(0)
        rows = logits[torch.arange(logits.shape[0], device=last.device),
                      last]
        return sample(rows, gen, sampling)

    return prefill_fn, decode_fn, tail_fn


class InferenceEngine:
    # adaptive tree control (spec_adaptive): per-slot EWMA of the round
    # acceptance fraction; below LOW the segment falls back to a chain
    # K=1, at/above HIGH it runs the full spec_fanout, between them a
    # depth-equal chain
    SPEC_EWMA_INIT = 0.5
    SPEC_EWMA_BETA = 0.7
    SPEC_EWMA_LOW = 0.35
    SPEC_EWMA_HIGH = 0.65

    def __init__(self, cfg, params, engine_cfg: EngineConfig = EngineConfig(),
                 sampling: SamplingParams = SamplingParams(),
                 draft_params=None, telemetry: Optional[Telemetry] = None):
        api = get_model(cfg)
        if not api.supports_paged_cache:
            raise NotImplementedError(
                f"family {cfg.family!r} lacks prefill/paged-cache support")
        self._spec_tree = engine_cfg.spec_fanout is not None
        self.spec = engine_cfg.spec_k > 0 or self._spec_tree
        if self.spec and draft_params is None:
            raise ValueError("speculative decoding requires draft_params "
                             "(the same weights under a draft profile: "
                             "models.transformer.init_params_and_draft or "
                             "core.model_compress.compress_draft)")
        self.cfg = cfg
        # per-layer views sliced once for the whole run
        self.params = split_layers(params, cfg)
        self.draft_params = None
        if self.spec:
            self.draft_params = split_layers(draft_params, draft_config(
                cfg, engine_cfg.spec_draft_layers))
        self.ecfg = engine_cfg
        self.sampling = sampling
        self.device = resolve_device(engine_cfg.device)
        lookahead = 0
        if self._spec_tree:
            fan = tuple(int(f) for f in engine_cfg.spec_fanout)
            full = TreeTemplate(fan)
            # adaptive ladder: chain K=1 <- depth-equal chain <- full tree
            # (rungs may coincide; kept positional so LOW/HIGH map to the
            # right rung)
            self._fanout_ladder = [(1,), (1,) * full.depth, fan] \
                if engine_cfg.spec_adaptive else [fan]
            lookahead = full.n_nodes        # verify writes all N tree slots
            self._spec_width = full.depth + 1
        elif self.spec:
            lookahead = engine_cfg.spec_k
            self._spec_width = engine_cfg.spec_k + 1
        self._accept_ewma = np.full((engine_cfg.num_slots,),
                                    self.SPEC_EWMA_INIT)
        self.tel = telemetry if telemetry is not None else Telemetry()
        reg = self.tel.registry
        self._c_ladder_flips = reg.counter("spec.ladder_transitions")
        self._g_ladder = reg.gauge("spec.ladder_rung")
        # chunked prefill: slots fed a chunk, summed over dispatches, and
        # the prompt tokens those chunks carried
        self._c_chunks = reg.counter("engine.prefill_chunks")
        self._c_chunk_tokens = reg.counter("engine.prefill_chunk_tokens")
        self._ladder_rung: Optional[int] = None
        self.kv = PagedKVCache(cfg, api, engine_cfg.num_slots,
                               engine_cfg.max_seq, engine_cfg.page_size,
                               engine_cfg.num_pages, lookahead=lookahead,
                               registry=reg,
                               prefix_cache=engine_cfg.prefix_cache,
                               device=self.device)
        self.scheduler = Scheduler(engine_cfg.num_slots, self.kv,
                                   engine_cfg.max_seq, registry=reg)
        self.metrics = EngineMetrics(registry=reg, tracer=self.tel.tracer)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(engine_cfg.seed)
        b = engine_cfg.num_slots
        zeros = dict(dtype=torch.int32, device=self.device)
        self._tokens = torch.zeros((b,), **zeros)      # device-side feedback
        self._positions = torch.zeros((b,), **zeros)
        self._active = torch.zeros((b,), **zeros)
        self._remaining = torch.zeros((b,), **zeros)   # per-slot budget
        self._block_tables = self.kv.device_block_tables()
        self._max_live = self.kv.max_pages_per_slot
        # two-deep dispatch: completion events of decode segments
        # dispatched but not yet waited for (at most one stays in flight)
        self._inflight: Deque = deque()
        self._token_log: List[torch.Tensor] = []       # [B] tensors, lazy
        # spec mode log: (tokens [B, W], counts [B]) per prefill/round
        self._spec_log: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._prefill_fn, self._decode_fn, self._tail_fn = _step_fns(
            cfg, sampling)

    # -- device helpers -----------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device COPY of a host array (never a view: the host tables
        are mutated in place by assign/release while steps may still be in
        flight). On the card the copy is asynchronous from pinned memory,
        so it does not wait for the in-flight segment."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _wait_all(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _mark(self):
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # -- API ----------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               arrival_t: Optional[float] = None) -> int:
        """Enqueue a request (``arrival_t``: a ``metrics.now()``-clock
        timestamp that backdates the enqueue). Malformed requests raise
        :class:`~repro_torch.engine.resilience.RejectedRequest`."""
        rid = self.scheduler.submit(prompt, max_new_tokens,
                                    arrival_t=arrival_t)
        self.metrics.record_enqueue(rid, t=arrival_t)
        return rid

    def _check_ported(self, source) -> None:
        e = self.ecfg
        later = []
        if source is not None:
            later.append("timed admission (source; ROADMAP A.5)")
        if e.resilience is not None and e.resilience != ResilienceConfig():
            later.append("resilience/chaos config (ROADMAP A.5)")
        if later:
            raise NotImplementedError(
                f"not yet ported: {', '.join(later)}")

    def run(self, source=None) -> Dict:
        """Serve until the queue and all slots drain. Returns
        {"results": [...], "metrics": {...}} (results in completion order)."""
        self._check_ported(source)
        sch = self.scheduler
        tracer = self.tel.tracer
        self.metrics.run_started()
        while sch.has_work():
            sch.tick_quarantine()
            with tracer.span("admit") as sp:
                admitted = sch.admit()
                sp.set(admitted=len(admitted), queue_depth=len(sch.waiting))
            if admitted:
                self._do_prefill(admitted)
            # chunked prefill: every PREFILLING slot advances one chunk a
            # boundary; a final chunk flips its slot to DECODE in time for
            # this boundary's segment
            self._feed_prefill_chunks()
            prefilling = any(r.state == PREFILLING for r in sch.active())
            actives = [r for r in sch.active() if r.state == DECODE]
            if not actives:
                if sch.waiting and not sch.active():
                    head = sch.waiting[0]
                    need = self.kv.pages_needed(head.total_tokens,
                                                lookahead=0)
                    if need > self.kv.num_pages:
                        raise RuntimeError(
                            f"request {head.rid} needs {need} pages but "
                            f"the pool only has {self.kv.num_pages}")
                    time.sleep(0.0005)
                continue
            # no draft/verify while a slot is mid-prompt: one-step plain
            # segments keep the chunks interleaved token by token
            if self.spec and not prefilling:
                finished = self._spec_segment(actives)
            else:
                finished = self._decode_segment(
                    actives, max_steps=1 if prefilling else None)
            t = self.metrics.now()
            with tracer.span("evict") as sp:
                for r in finished:
                    self.metrics.record_finish(r.rid, t, r.produced)
                    sch.finish(r)
                if finished:
                    self._sync_slot_state()
                sp.set(evicted=len(finished))
            self.tel.maybe_stats(self.metrics)
        self.metrics.run_finished()
        return {"results": self._materialize(),
                "metrics": self.metrics.summary()}

    def _decode_segment(self, actives: List[Request],
                        max_steps: Optional[int] = None) -> List[Request]:
        """Plain decode segment: no slot can exceed its budget before the
        earliest one finishes, so no host sync inside the segment. The
        boundary waits for the PREVIOUS segment's completion event (two-
        deep dispatch) and leaves this one in flight: host accounting
        needs no token values, which are read only at materialization.

        ``max_steps`` clamps the segment (one step while a prompt is
        chunking). A speculative engine runs this segment then, and logs
        its tokens into the spec log at width 1."""
        sch = self.scheduler
        tracer = self.tel.tracer
        t0 = self.metrics.now()
        seg = max(1, min(r.remaining for r in actives))
        if max_steps is not None:
            seg = min(seg, max_steps)
        finished: List[Request] = []
        with tracer.span("decode_segment") as seg_sp:
            with tracer.annotate("decode_segment"):
                for _ in range(seg):
                    self._tokens, self._positions = self._decode_fn(
                        self.params, self.kv.data, self._tokens,
                        self._positions, self._block_tables, self._active,
                        self._gen, self._max_live)
                    if self.spec:
                        idx = self._log_spec(self._tokens[:, None],
                                             self._active)
                    else:
                        idx = len(self._token_log)
                        self._token_log.append(self._tokens)
                    for r in sch.active():
                        if r.state == DECODE:
                            r.log_entries.append(idx)
                    finished.extend(sch.step_decoded())
            self._inflight.append(self._mark())
            if len(self._inflight) > 1:
                with tracer.span("sync", cat="sync"):
                    while len(self._inflight) > 1:
                        ev = self._inflight.popleft()
                        if ev is not None:
                            ev.synchronize()
            seg_sp.set(steps=seg, slots=len(actives),
                       tokens=seg * len(actives))
            if tracer.enabled:
                for r in actives:
                    tracer.flow_point(r.rid, "decode_segment", t=seg_sp.t0)
        self.metrics.decode_steps += seg
        self.metrics.record_decode_segment(self.metrics.now() - t0,
                                           seg * len(actives))
        return finished

    def _spec_segment(self, actives: List[Request]) -> List[Request]:
        """Speculative segment: rounds of draft calls and one multi-token
        verify. Every round emits 1..K+1 tokens per active slot (K = the
        chain length or the tree depth, clamped to the slot's budget on
        the device), so ceil(min_remaining / (K+1)) rounds never overshoot
        the earliest budget: the rounds read nothing on the host, and the
        boundary reads every round's counts in one transfer. A tree
        segment takes its fanout from the adaptive ladder."""
        sch = self.scheduler
        tracer = self.tel.tracer
        t0 = self.metrics.now()
        if self._spec_tree:
            draft_fn, verify_fn, tpl = tree_step_fns(
                self.cfg, self.sampling, self._segment_fanout(),
                self.ecfg.spec_draft_layers)
            k, width = tpl.depth, tpl.n_nodes + 1
            draft_dispatches = tpl.depth          # root + level calls
        else:
            k = self.ecfg.spec_k
            draft_fn, verify_fn = spec_step_fns(
                self.cfg, self.sampling, k, self.ecfg.spec_draft_layers)
            width = k + 1
            draft_dispatches = k                  # one call per draft step
        rounds = max(1, -(-min(r.remaining for r in actives) // (k + 1)))
        round_idxs: List[int] = []
        with tracer.span("spec_segment") as seg_sp:
            for _ in range(rounds):
                # per-round spans time the host's enqueue, not device work
                with tracer.span("draft", cat="dispatch"), \
                        tracer.annotate("draft"):
                    draft = draft_fn(self.draft_params, self.kv.data,
                                     self._tokens, self._positions,
                                     self._block_tables, self._max_live)
                with tracer.span("verify", cat="dispatch"), \
                        tracer.annotate("verify"):
                    (out, n_new, self._tokens, self._positions,
                     self._remaining) = verify_fn(
                        self.params, self.kv.data, self._tokens, draft,
                        self._positions, self._block_tables, self._active,
                        self._remaining, self._gen, self._max_live)
                idx = self._log_spec(out, n_new)
                round_idxs.append(idx)
                for r in sch.active():
                    if r.state == DECODE:
                        r.log_entries.append(idx)
            # the round replay reads n_new on the host: one transfer, which
            # waits for this segment (and anything still in flight)
            with tracer.span("sync", cat="sync"):
                n_new_h = torch.stack([self._spec_log[i][1]
                                       for i in round_idxs]).cpu().numpy()
            self._inflight.clear()
            seg_tokens = 0
            for n_round in n_new_h:                    # replay the rounds
                proposed, accepted = sch.step_spec_round(n_round, k)
                slot_rounds = int((n_round > 0).sum())
                self.metrics.record_spec_round(
                    proposed, accepted, slot_rounds=slot_rounds,
                    verify_tokens=width * slot_rounds)
                if self.ecfg.spec_adaptive:
                    self._update_accept_ewma(n_round, k)
                seg_tokens += int(n_round.sum())
            seg_sp.set(rounds=rounds, k=k, slots=len(actives),
                       tokens=seg_tokens)
            if tracer.enabled:
                for r in actives:
                    tracer.flow_point(r.rid, "spec_segment", t=seg_sp.t0)
        # draft + verify calls (dispatch accounting; spec_rounds counts
        # rounds)
        self.metrics.decode_steps += (draft_dispatches + 1) * rounds
        self.metrics.record_decode_segment(self.metrics.now() - t0,
                                           seg_tokens)
        return sch.collect_finished()

    def _segment_fanout(self) -> Tuple[int, ...]:
        """Adaptive tree budget: the MIN of the active slots' acceptance
        EWMAs picks the ladder rung (one tree shape per segment, so
        thrash anywhere shrinks the whole batch's tree)."""
        if len(self._fanout_ladder) == 1:
            return self._pick_rung(0)
        act = [i for i, s in enumerate(self.scheduler.slots)
               if s.request is not None and s.request.state == DECODE]
        a = min(self._accept_ewma[i] for i in act) if act else 1.0
        if a < self.SPEC_EWMA_LOW:
            return self._pick_rung(0)
        if a >= self.SPEC_EWMA_HIGH:
            return self._pick_rung(2)
        return self._pick_rung(1)

    def _pick_rung(self, idx: int) -> Tuple[int, ...]:
        """Publish the chosen ladder rung: transition counter, gauge and a
        trace instant where the tree reshaped."""
        if idx != self._ladder_rung:
            if self._ladder_rung is not None:
                self._c_ladder_flips.inc()
            self._ladder_rung = idx
            self.tel.tracer.instant(
                "spec_ladder", rung=idx,
                fanout=str(self._fanout_ladder[idx]))
        self._g_ladder.set(idx)
        return self._fanout_ladder[idx]

    def _update_accept_ewma(self, n_new: np.ndarray, k: int) -> None:
        """Fold one round's per-slot acceptance fraction ((n_new - 1)/K;
        a budget clamp reads as rejection, acceptable noise for a control
        signal) into the per-slot EWMAs."""
        reg = self.tel.registry
        for i in range(self.ecfg.num_slots):
            if n_new[i] > 0:
                rate = min(max((float(n_new[i]) - 1.0) / max(k, 1), 0.0),
                           1.0)
                self._accept_ewma[i] = (self.SPEC_EWMA_BETA
                                        * self._accept_ewma[i]
                                        + (1 - self.SPEC_EWMA_BETA) * rate)
                reg.gauge(f"spec.accept_ewma.slot{i}").set(
                    float(self._accept_ewma[i]))

    def _log_spec(self, toks: torch.Tensor, counts: torch.Tensor) -> int:
        """Append a (tokens [B, W], counts [B]) pair to the spec log,
        padded to the widest round (chain K+1, tree depth+1), so
        materialization stacks each array once."""
        w = self._spec_width
        if toks.shape[1] < w:
            toks = torch.nn.functional.pad(toks, (0, w - toks.shape[1]))
        self._spec_log.append((toks, counts))
        return len(self._spec_log) - 1

    def _log_first(self, first: torch.Tensor, mask: np.ndarray) -> int:
        """Log a prefill's first tokens [B]; returns the log index."""
        if self.spec:
            return self._log_spec(first[:, None],
                                  self._to_device(mask.astype(np.int32)))
        self._token_log.append(first)
        return len(self._token_log) - 1

    def _do_prefill(self, admitted: List[Request]) -> None:
        """Prefill one admission group, split as the reference splits it
        (DESIGN.md §13-14): with chunking on, a prompt whose unshared tail
        needs more than one chunk enters ``PREFILLING`` at its shared
        boundary and is fed by :meth:`_feed_prefill_chunks`; of the rest,
        slots with no shared prefix take the batched full-prompt prefill,
        the others one ragged tail dispatch together.
        ``metrics.prefills`` counts the batched prefill calls only;
        ``metrics.prefill_tails`` counts the tail dispatches (the tail
        attends through the paged kernel, the batched prefill does not,
        so launch accounting needs the two apart); neither counts chunk
        dispatches."""
        b = self.ecfg.num_slots
        tracer = self.tel.tracer
        budget = self.ecfg.prefill_chunk_tokens
        if budget > 0:
            rest = []
            for r in admitted:
                sh = self.kv.slot_shared_tokens(r.slot)
                if len(plan_chunks(sh, r.prompt_len, budget)) > 1:
                    r.state = PREFILLING
                    r.prefill_pos = sh
                    self.metrics.record_admit(r.rid)
                else:
                    rest.append(r)
            admitted = rest
            if not admitted:
                # the PREFILLING rows must leave the decode-side tables
                self._sync_slot_state()
                return
        shared = [r for r in admitted
                  if self.kv.slot_shared_tokens(r.slot) > 0]
        full = [r for r in admitted
                if self.kv.slot_shared_tokens(r.slot) == 0]
        merged = self._tokens
        lengths_all = np.zeros((b,), np.int32)
        mask_all = np.zeros((b,), bool)
        idx_of: Dict[int, int] = {}       # rid -> token-log index
        for r in admitted:
            self.metrics.record_admit(r.rid)
            lengths_all[r.slot] = r.prompt_len
            mask_all[r.slot] = True
        if full:
            # cap the pow2 bucket at max_seq: prompt_len <= max_seq is
            # enforced at submit, wider buckets are pure waste
            s = min(_bucket(max(r.prompt_len for r in full),
                            self.ecfg.prompt_bucket_min), self.ecfg.max_seq)
            tokens = np.zeros((b, s), np.int32)
            lengths = np.zeros((b,), np.int32)
            # non-group slots must be invisible to the prefill writes:
            # their rows get length 0 + all-sentinel block tables
            bt = np.full_like(self.kv.block_tables, self.kv.sentinel)
            mask = np.zeros((b,), bool)
            for r in full:
                tokens[r.slot, :r.prompt_len] = r.prompt
                lengths[r.slot] = r.prompt_len
                bt[r.slot] = self.kv.block_tables[r.slot]
                mask[r.slot] = True
            self.metrics.prefills += 1
            with tracer.span("prefill") as sp, tracer.annotate("prefill"):
                first = self._prefill_fn(self.params, self.kv.data,
                                         self._to_device(tokens),
                                         self._to_device(lengths),
                                         self._to_device(bt), self._gen)
                # TTFT is stamped below, so the first token must exist
                self._wait_all()
                sp.set(admitted=len(full), bucket=s, tokens=len(full),
                       prompt_tokens=int(lengths.sum()))
                if tracer.enabled:
                    for r in full:
                        tracer.flow_point(r.rid, "prefill", t=sp.t0)
            idx = self._log_first(first, mask)
            for r in full:
                idx_of[r.rid] = idx
            merged = torch.where(self._to_device(mask), first, merged)
        if shared:
            mask = np.zeros((b,), bool)
            rows = []
            for r in shared:
                sh = self.kv.slot_shared_tokens(r.slot)
                rows.append((r.slot, r.prompt[sh:], sh,
                             self.kv.block_tables[r.slot]))
                mask[r.slot] = True
            self.metrics.prefill_tails += 1
            with tracer.span("prefill_tail") as sp, \
                    tracer.annotate("prefill_tail"):
                first, t_pad, fed = self._ragged_dispatch(rows)
                self._wait_all()
                sp.set(admitted=len(shared), bucket=t_pad, tail_tokens=fed,
                       shared_tokens=sum(start for _, _, start, _ in rows))
                if tracer.enabled:
                    for r in shared:
                        tracer.flow_point(r.rid, "prefill_tail", t=sp.t0)
            idx = self._log_first(first, mask)
            for r in shared:
                idx_of[r.rid] = idx
            merged = torch.where(self._to_device(mask), first, merged)
        # every prompt's full-page K/V blocks are now written (cached
        # prefix + freshly prefilled remainder): cache them BEFORE any
        # budget-exhausted request below releases its pages
        if self.kv.prefix is not None:
            for r in admitted:
                self.kv.prefix_insert(r.slot, r.prompt)
        self._begin_decode(admitted, idx_of)
        # merge the admitted slots into the device-side decode state
        self._tokens = merged
        self._positions = torch.where(self._to_device(mask_all),
                                      self._to_device(lengths_all),
                                      self._positions)
        self._sync_slot_state()

    def _feed_prefill_chunks(self) -> None:
        """Advance every PREFILLING slot by one prompt chunk (DESIGN.md
        §14) in ONE ragged ``tail_fn`` dispatch: slot rows padded to the
        pow2 bucket of the longest chunk, each slot's table exposed only
        up to the end of its chunk, the other slots' rows all-sentinel.
        An intermediate chunk's sample is discarded and the dispatch adds
        no host sync; a dispatch holding a final chunk (which ends at the
        prompt length) waits for its first tokens, as the TTFT stamp
        needs, and completes those requests as a prefill does. Chunk
        dispatches count in neither ``metrics.prefills`` nor
        ``metrics.prefill_tails``: ``engine.prefill_chunks`` counts the
        slots fed, ``engine.prefill_chunk_tokens`` the tokens."""
        sch = self.scheduler
        chunking = [r for r in sch.active() if r.state == PREFILLING]
        if not chunking:
            return
        budget = self.ecfg.prefill_chunk_tokens
        b = self.ecfg.num_slots
        tracer = self.tel.tracer
        rows, finals = [], []
        for r in chunking:
            n = plan_chunks(r.prefill_pos, r.prompt_len, budget)[0][1]
            end = r.prefill_pos + n
            # only the pages this chunk can touch: the prefix, the chunks
            # fed so far and this one
            rows.append((r.slot, r.prompt[r.prefill_pos:end], r.prefill_pos,
                         self.kv.slot_block_table(r.slot, end)))
            r.prefill_pos = end
            if end >= r.prompt_len:
                finals.append(r)
        with tracer.span("prefill_chunk") as sp, \
                tracer.annotate("prefill_chunk"):
            first, t_pad, fed = self._ragged_dispatch(rows)
            if finals:
                # the completed prompts' TTFT is stamped below, so their
                # first tokens must exist
                self._wait_all()
            sp.set(slots=len(chunking), bucket=t_pad, chunk_tokens=fed,
                   completed=len(finals))
            if tracer.enabled:
                for r in chunking:
                    tracer.flow_point(r.rid, "prefill_chunk", t=sp.t0)
        self._c_chunks.inc(len(chunking))
        self._c_chunk_tokens.inc(fed)
        if not finals:
            return
        fmask = np.zeros((b,), bool)
        lengths = np.zeros((b,), np.int32)
        for r in finals:
            fmask[r.slot] = True
            lengths[r.slot] = r.prompt_len
        idx = self._log_first(first, fmask)
        # a prompt's full-page blocks are all written only at its last
        # chunk: cached any earlier, another request could map pages no
        # chunk has written yet
        if self.kv.prefix is not None:
            for r in finals:
                self.kv.prefix_insert(r.slot, r.prompt)
        self._begin_decode(finals, {r.rid: idx for r in finals})
        dmask = self._to_device(fmask)
        self._tokens = torch.where(dmask, first, self._tokens)
        self._positions = torch.where(dmask, self._to_device(lengths),
                                      self._positions)
        self._sync_slot_state()

    def _ragged_dispatch(self, rows) -> Tuple[torch.Tensor, int, int]:
        """One ``tail_fn`` dispatch of ragged multi-token rows: ``rows``
        holds (slot, tokens, start position, table row) for every slot
        fed; the rows are padded to one pow2 T (at least
        ``prompt_bucket_min``, at most ``max_seq``), ``feed_len`` drops
        the padding's K/V writes, and slots not fed get length 0 and an
        all-sentinel table. Returns (first tokens [B], T, tokens fed)."""
        b = self.ecfg.num_slots
        t_pad = min(_bucket(max(len(tk) for _, tk, _, _ in rows),
                            self.ecfg.prompt_bucket_min), self.ecfg.max_seq)
        toks = np.zeros((b, t_pad), np.int32)
        starts = np.zeros((b,), np.int32)
        feed = np.zeros((b,), np.int32)
        bt = np.full_like(self.kv.block_tables, self.kv.sentinel)
        for slot, tk, start, row in rows:
            toks[slot, :len(tk)] = tk
            starts[slot] = start
            feed[slot] = len(tk)
            bt[slot] = row
        occ = int((bt != self.kv.sentinel).sum(1).max())
        max_live = min(_bucket(max(occ, 1), 1), self.kv.max_pages_per_slot)
        first = self._tail_fn(self.params, self.kv.data,
                              self._to_device(toks), self._to_device(starts),
                              self._to_device(feed), self._to_device(bt),
                              self._gen, max_live)
        return first, t_pad, int(feed.sum())

    def _begin_decode(self, reqs: List[Request],
                      idx_of: Dict[int, int]) -> None:
        """Prefill (or a final chunk) produced each request's first token,
        logged at ``idx_of[rid]``: stamp TTFT, move it to DECODE, and
        finish it at once if that token spent its budget."""
        t = self.metrics.now()
        done_now = []
        for r in reqs:
            r.state = DECODE
            r.produced += 1
            r.log_entries = [idx_of[r.rid]]
            self.metrics.record_first_token(r.rid, t)
            if r.produced >= r.max_new_tokens:   # budget exhausted already
                self.metrics.record_finish(r.rid, t, r.produced)
                done_now.append(r)
        for r in done_now:
            self.scheduler.finish(r)

    def _sync_slot_state(self) -> None:
        """Refresh the device copies of the block tables and the active
        mask after a scheduling event (admission/eviction).

        PREFILLING slots get all-sentinel rows in the decode-side tables:
        a decode, draft or verify dispatch feeds every row, and its write
        at such a slot's stale position would land in the pages the chunks
        are writing. Chunk dispatches build their own tables."""
        bts = self.kv.block_tables.copy()
        mid = [i for i, s in enumerate(self.scheduler.slots)
               if s.request is not None and s.request.state == PREFILLING]
        if mid:
            bts[mid, :] = self.kv.sentinel
        self._block_tables = self._to_device(bts)
        # clamp for the decode-side page walk: the batch's max occupied
        # page count, pow2-bucketed as in the reference
        occ = int((self.kv.block_tables != self.kv.sentinel).sum(1).max())
        self._max_live = min(_bucket(max(occ, 1), 1),
                             self.kv.max_pages_per_slot)
        act = np.zeros((self.ecfg.num_slots,), np.int32)
        rem = np.zeros((self.ecfg.num_slots,), np.int32)
        for i, slot in enumerate(self.scheduler.slots):
            if slot.request is not None and slot.request.state == DECODE:
                act[i] = 1
                rem[i] = slot.request.remaining
        self._active = self._to_device(act)
        self._remaining = self._to_device(rem)

    def _materialize(self) -> List[Dict]:
        """One host sync: stack the token log and slice every request's
        generated tokens out of it (completion order)."""
        if self.spec:
            return self._materialize_spec()
        if self._token_log:
            mat = torch.stack(self._token_log).cpu().numpy()
        else:
            mat = np.zeros((0, self.ecfg.num_slots), np.int32)
        self._inflight.clear()
        out = []
        for r in self.scheduler.finished:
            toks = mat[np.asarray(r.log_entries, np.int64), r.slot] \
                if r.log_entries else np.zeros((0,), np.int32)
            r.output = toks[:r.produced].astype(np.int32)
            out.append({"rid": r.rid, "prompt_len": r.orig_prompt_len,
                        "tokens": r.output, "n_generated": r.produced})
        return out

    def _materialize_spec(self) -> List[Dict]:
        """Spec-mode materialization: entries are (tokens [B, W], counts
        [B]); a request's generation is the concatenation of its rounds'
        accepted slices (two host transfers in all)."""
        if self._spec_log:
            mat = torch.stack([a for a, _ in self._spec_log]).cpu().numpy()
            cnt = torch.stack([c for _, c in self._spec_log]).cpu().numpy()
        else:
            mat = np.zeros((0, self.ecfg.num_slots, 1), np.int32)
            cnt = np.zeros((0, self.ecfg.num_slots), np.int32)
        self._inflight.clear()
        out = []
        for r in self.scheduler.finished:
            toks = np.concatenate(
                [mat[i, r.slot, :cnt[i, r.slot]] for i in r.log_entries]) \
                if r.log_entries else np.zeros((0,), np.int32)
            r.output = toks[:r.produced].astype(np.int32)
            out.append({"rid": r.rid, "prompt_len": r.orig_prompt_len,
                        "tokens": r.output, "n_generated": r.produced})
        return out
