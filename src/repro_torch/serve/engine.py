"""Batched serving engine: prefill/decode steps + continuous batching.

The PyTorch port of ``repro.serve.engine``.  Slot-based continuous
batching (vLLM-style scheduling):
  * a fixed pool of ``max_batch`` slots shares one padded KV cache of
    ``max_len`` positions, allocated once on the weights' device;
  * arriving requests prefill into a free slot, one row at a time,
    right-padded to the smallest prompt bucket that holds them, so the
    decode batch keeps running between admissions;
  * every decode step advances ALL live slots one token
    (:func:`repro_torch.models.transformer.decode_step_ragged`); finished
    slots (EOS, ``max_tokens`` or a full cache) free immediately and are
    refilled from the queue — no head-of-line blocking on long
    generations;
  * per-slot position counters mask attention to each slot's own history.

Slots are contiguous per-slot cache regions of static shape, not paged
KV blocks, as in the reference.  The engine runs under
``torch.inference_mode()``; its caches are written in place.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.measure import cuda_devices
from repro_torch.models import tracing, tree
from repro_torch.models.api import ModelApi


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    prompt_len: int = 0
    # generation stopped because the slot's cache filled (max_len), not
    # because of EOS/max_tokens — the output is complete but shorter
    # than requested
    truncated: bool = False


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    prompt_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    cache_dtype: Any = torch.bfloat16
    greedy: bool = True
    # fence (wait for the logits on their device) before stamping
    # first_token_at/done_at, so TTFT/latency measure *delivery*.
    # False stamps when the launches return — enqueue time on a card,
    # whose launches are asynchronous — and exists so a test can
    # measure the gap.
    fence_timestamps: bool = True


def fence(t: torch.Tensor) -> None:
    """Wait until ``t`` is computed: synchronize the CUDA device it lies
    on (a CPU tensor is computed when its op returns)."""
    for device in cuda_devices(t):
        torch.cuda.synchronize(device)


class ServeEngine:
    """Single-host engine driving a ModelApi over weights on one
    device; the cache goes on the device of the embedding table."""

    def __init__(self, api: ModelApi, params, cfg: ServeConfig):
        from repro_torch.models import transformer
        from repro_torch.models.api import family_module
        if family_module(api.cfg) is not transformer:
            raise ValueError(
                f"ServeEngine drives decoder-only families (dense/moe/vlm), "
                f"not {api.cfg.family!r}")
        self.api = api
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.queue: "collections.deque[Request]" = collections.deque()
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch
        self._uid = 0

        # single shared cache for the whole slot pool, with PER-SLOT
        # position clocks (ragged decode)
        with torch.inference_mode():
            self.cache = api.init_cache(cfg.max_batch, cfg.max_len,
                                        cfg.cache_dtype, device=self.device)
            self.cache["pos"] = torch.zeros((cfg.max_batch,),
                                            dtype=torch.int32,
                                            device=self.device)
        self._decode = lambda p, t, c: transformer.decode_step_ragged(
            api.cfg, p, t, c)
        # host-side per-slot position clocks (prefix + decoded tokens):
        # max_len exhaustion is a host decision, it must not read the
        # device cache
        self._slot_pos = [0] * cfg.max_batch
        self._pending_tok = np.zeros(cfg.max_batch, np.int64)
        #: queued + in-flight request count sampled once per step() —
        #: the queue-depth series latency meters average (the latest
        #: 4,096 steps: a long-running server keeps no more)
        self.queue_depth_log: "collections.deque[int]" = \
            collections.deque(maxlen=4096)

    # -- public API -------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_tokens: int = 32,
               eos_id: Optional[int] = None,
               submitted_at: Optional[float] = None) -> Request:
        """Queue one request.  ``submitted_at`` lets open-loop drivers
        stamp the *scheduled arrival* instant so latency includes the
        queueing the arrival process created (default: now)."""
        prompt = np.asarray(prompt, np.int32)
        biggest = max(self.cfg.prompt_buckets)
        if len(prompt) > biggest:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"prefill bucket ({biggest}); raise ServeConfig."
                f"prompt_buckets (currently {self.cfg.prompt_buckets}) "
                f"or chunk the prompt")
        if len(prompt) >= self.cfg.max_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit a "
                f"max_len={self.cfg.max_len} cache with room to decode; "
                f"raise ServeConfig.max_len")
        self._uid += 1
        req = Request(self._uid, prompt, max_tokens, eos_id,
                      submitted_at=(time.perf_counter()
                                    if submitted_at is None
                                    else submitted_at),
                      prompt_len=len(prompt))
        self.queue.append(req)
        return req

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One engine step: admit from the queue, decode every live slot
        one token.  Returns the requests that finished this step (empty
        when the pool is idle).  ``run`` is a loop over this; open-loop
        drivers interleave it with scheduled ``submit`` calls."""
        with tracing.span("engine.step"):
            self._admit()
            depth = len(self.queue) + sum(1 for s in self.slots
                                          if s is not None)
            self.queue_depth_log.append(depth)
            if not any(s is not None for s in self.slots):
                return []
            return self._decode_step()

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain.  Returns finished requests."""
        finished: List[Request] = []
        for _ in range(max_steps):
            if not self.queue and not any(s is not None for s in self.slots):
                break
            finished.extend(self.step())
        return finished

    # -- internals ------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.cfg.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(                      # unreachable via submit()
            f"no prompt bucket fits {n} tokens "
            f"(buckets: {self.cfg.prompt_buckets})")

    def _admit(self) -> None:
        for i in range(self.cfg.max_batch):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            tracing.record("engine.queue", req.submitted_at, req.uid)
            with tracing.span("engine.admit", req.uid):
                self._prefill_into_slot(i, req)
            self.slots[i] = req

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Per-slot prefill: bucket-padded single-row prefill into a
        fresh one-row cache, then splice the row into the pool cache at
        ``slot``."""
        bucket = self._bucket(len(req.prompt))
        toks = np.zeros((1, bucket), np.int32)
        n = min(len(req.prompt), bucket)
        toks[0, :n] = req.prompt[:n]
        with tracing.span("engine.row_cache", req.uid):
            cache = self.api.init_cache(1, self.cfg.max_len,
                                        self.cfg.cache_dtype,
                                        device=self.device)
        with tracing.span("engine.prefill", req.uid):
            logits_row, row_cache = self.api.prefill(
                self.params,
                {"tokens": torch.from_numpy(toks).to(self.device)},
                cache, logit_pos=n - 1)
            # right-padded prompt: this slot's clock is n, so padded
            # keys beyond position n are masked by the per-slot prefix
            # length
            row_cache = dict(row_cache, pos=torch.full(
                (1,), n, dtype=torch.int32, device=self.device))
            if self.cfg.fence_timestamps:
                fence(logits_row)
        # fenced: the logits are computed — TTFT measures delivery;
        # unfenced on a card: the launches just returned — enqueue
        req.first_token_at = time.perf_counter()
        tok = int(logits_row[0, -1].argmax())
        req.output.append(tok)
        with tracing.span("engine.splice", req.uid):
            self.cache = _splice_row(self.cache, row_cache, slot)
        self._slot_pos[slot] = n
        self._pending_tok[slot] = tok

    def _decode_step(self) -> List[Request]:
        if tracing.enabled():
            # the positions decode attention keeps (each live slot's
            # prefix and the token this step writes) and those it reads
            # (the whole padded pool)
            tracing.count("engine.kv_live", sum(
                p + 1 for p, r in zip(self._slot_pos, self.slots)
                if r is not None))
            tracing.count("engine.kv_read",
                          self.cfg.max_batch * self.cfg.max_len)
        with tracing.span("engine.decode"):
            toks = torch.from_numpy(self._pending_tok).to(
                self.device)[:, None]
            logits, self.cache = self._decode(self.params, toks, self.cache)
            if self.cfg.fence_timestamps:
                fence(logits)
        stamp = time.perf_counter()
        with tracing.span("engine.sample"):
            return self._sample(logits, stamp)

    def _sample(self, logits, stamp: float) -> List[Request]:
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        done: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.output.append(tok)
            self._pending_tok[i] = tok
            self._slot_pos[i] += 1
            # the slot's cache is full when the *next* decode would
            # write at max_len: terminate rather than overrun the
            # static cache (the request is truncated, not failed)
            exhausted = self._slot_pos[i] + 1 >= self.cfg.max_len
            if (len(req.output) >= req.max_tokens or
                    (req.eos_id is not None and tok == req.eos_id) or
                    exhausted):
                if exhausted and len(req.output) < req.max_tokens and \
                        not (req.eos_id is not None and tok == req.eos_id):
                    req.truncated = True
                req.done_at = stamp
                done.append(req)
                self.slots[i] = None
        return done

    # -- metrics ----------------------------------------------------------
    @staticmethod
    def summarize(reqs: List[Request]) -> Dict[str, float]:
        """Batch-level summary stats; robust to empty and all-failed
        batches (no request ever reached ``done_at``) — means and
        throughput report 0.0 rather than crashing mid-postmortem."""
        if not reqs:
            return {}
        ttft = [r.first_token_at - r.submitted_at for r in reqs
                if r.first_token_at is not None]
        lat = [r.done_at - r.submitted_at for r in reqs
               if r.done_at is not None]
        toks = sum(len(r.output) for r in reqs)
        finished = [r.done_at for r in reqs if r.done_at is not None]
        span = (max(finished) - min(r.submitted_at for r in reqs)
                if finished else 0.0)
        return {"requests": len(reqs), "tokens": toks,
                "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
                "latency_mean_s": float(np.mean(lat)) if lat else 0.0,
                "throughput_tok_s": toks / span if span > 0 else 0.0}


def _splice_row(pool_cache, row_cache, slot: int):
    """Copy a 1-row cache into slot ``slot`` of the pool cache.

    The batch axis is found by shape, as in the reference: the first
    axis after the leading one where the row has size 1 and the pool
    more (axis 1 of the [L,B,...] k/v); a per-slot ``pos`` vector takes
    the row's clock at ``slot``; a scalar clock takes the max.  Tensors
    are written in place; the returned tree holds the pool's tensors,
    or the row's where the pool has a single slot.
    """
    def splice(pool, row):
        if pool.ndim == 0:                     # scalar pos (unused here)
            return torch.maximum(pool, row)
        if pool.ndim == 1 and row.ndim == 1 and row.shape[0] == 1:
            pool[slot] = row[0]                # per-slot pos vector
            return pool
        if pool.ndim == 1 and row.ndim == 0:
            pool[slot] = row
            return pool
        if pool.shape == row.shape:
            # max_batch == 1: the pool IS one row, there is no axis to
            # search for (the size-1 batch dim matches everywhere) —
            # without this case a single-slot engine silently drops the
            # prefilled cache and decodes over zeros
            return row
        if pool.shape[0] != row.shape[0]:      # stacked-first? not expected
            return pool
        # find the batch axis: first axis where sizes differ
        for ax in range(1, pool.ndim):
            if row.shape[ax] == 1 and pool.shape[ax] > 1:
                pool.narrow(ax, slot, 1).copy_(row)
                return pool
        return pool
    return tree.map(splice, pool_cache, row_cache)
