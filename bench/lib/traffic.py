"""The one general generator of the benchmark's traffic.

A traffic file (``bench/traffic/<mix>.json``) holds only parameters;
its ``kind`` says which of the two generators here reads them.

``train``: packed documents for a language-model step, as the port's
``data.pipeline.SyntheticLM`` makes them (documents of exponential
length + 8 separated by an end token, each token drawn half from a Zipf
unigram distribution and half from a small Markov "topic" table), made
on the device from ``(seed, step)`` in a few calls.  Every step's rows
differ; a seed changes the tokens, never the shapes.

``serve``: an open-loop schedule of requests for one window, and the
requests already in flight when it opens.  The number of requests is
the rate times the window.  Their arrival gaps, prompt lengths and
output lengths, in order, are drawn from the file's own ``shape_seed``,
so every run seed gets the same schedule of sizes; the run seed draws
only the prompts' tokens, which do not change the work.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from . import arrivals


# ---------------------------------------------------------------------------
# training batches
# ---------------------------------------------------------------------------


def train_feed(tr: Dict[str, Any], vocab: int, seed: int, device
               ) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``feed(step)``: ``{"tokens", "labels"}`` [B, S] int32 on ``device``
    for the step, from ``(seed, step)``."""
    B, S = tr["batch"], tr["seq_len"]
    mean_doc, eos = tr["mean_doc_len"], tr["eos_id"]
    states, zipf_a = tr["markov_states"], tr["zipf_a"]
    base = torch.Generator(device=device).manual_seed(_mix(seed, 0))
    trans = torch.randint(1, vocab, (states, 8), generator=base,
                          device=device)
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -zipf_a, 0)
    cdf = (cdf / cdf[-1]).float()
    n = S + 1
    max_docs = n // 8 + 1

    def feed(step: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=device).manual_seed(_mix(seed, step + 1))
        lens = (torch.empty((B, max_docs), device=device).exponential_(
            1.0 / mean_doc, generator=g).floor().long() + 8)
        ends = lens.cumsum(1)                               # exclusive ends
        pos = torch.arange(n, device=device).repeat(B, 1)
        doc = torch.searchsorted(ends, pos, right=True)     # [B, n]
        topic = torch.randint(0, states, (B, max_docs), generator=g,
                              device=device).gather(1, doc)
        mark = trans[topic, torch.randint(0, 8, (B, n), generator=g,
                                          device=device)]
        uni = torch.searchsorted(cdf, torch.rand((B, n), generator=g,
                                                 device=device))
        uni = uni.clamp(max=vocab - 1)
        pick = torch.rand((B, n), generator=g, device=device) < 0.5
        tok = torch.where(pick, uni, mark)
        last = pos == ends.gather(1, doc) - 1               # a doc's last
        tok = torch.where(last, torch.full_like(tok, eos), tok).int()
        return {"tokens": tok[:, :-1].contiguous(),
                "labels": tok[:, 1:].contiguous()}
    return feed


def _mix(seed: int, k: int) -> int:
    return (int(seed) * 2_654_435_761 + 40_503 * k) % (2 ** 63)


# ---------------------------------------------------------------------------
# serving schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Planned:
    """One request of the schedule: when it is due (seconds from the
    window's start), its prompt and how many tokens it asks for."""
    due: float
    prompt: np.ndarray
    max_tokens: int


def _lengths(rng: random.Random, spec: Dict[str, Any], n: int) -> List[int]:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    mu = math.log(spec["median"])
    return [min(max(int(round(rng.lognormvariate(mu, spec["sigma"]))),
                    spec["min"]), spec["max"]) for _ in range(n)]


def serve_schedule(tr: Dict[str, Any], seed: int, seconds: float,
                   vocab: int, rate: float = None) -> List[Planned]:
    """The requests due in a window of ``seconds`` at ``rate`` (default:
    the file's), sorted by when they are due."""
    rate = tr["rate"] if rate is None else rate
    n = max(int(round(rate * seconds)), 1)
    shapes = random.Random(tr["shape_seed"])
    times = arrivals.generate(tr["arrivals"], rate, n + 1, tr["shape_seed"])
    gaps = np.diff(np.asarray([0.0] + times))
    gaps *= seconds / gaps.sum()                 # n + 1 gaps fill the window
    prompts = _lengths(shapes, tr["prompt"], n)
    outputs = _lengths(shapes, tr["output"], n)
    rs = np.random.default_rng(int(seed))
    due = np.cumsum(gaps)[:n]
    return [Planned(float(due[i]),
                    rs.integers(1, vocab, size=prompts[i], dtype=np.int32),
                    outputs[i]) for i in range(n)]


def in_flight(tr: Dict[str, Any], plan: List[Planned], k: int, seed: int,
              vocab: int, longest_prompt: int) -> List[Planned]:
    """``k`` requests caught part-way, as the stream that ``plan`` is a
    window of leaves them in flight at a random instant: each takes the
    sizes of one of ``plan``'s requests, drawn in proportion to the
    steps it stays in its slot (its output less the token its prefill
    makes), with a share of its output already served drawn evenly.  A
    request that has served ``d`` tokens is given as its prompt
    followed by ``d - 1`` tokens (cut so that the whole fits
    ``longest_prompt``), asking for the ``out - d + 1`` tokens still
    due, the first of which its prefill makes.  The picks come from
    ``shape_seed``, the tokens from ``seed``."""
    if k == 0:
        return []
    w = np.asarray([p.max_tokens for p in plan], np.float64) - 1.0
    pick = np.random.default_rng(tr["shape_seed"])
    idx = pick.choice(len(plan), size=k, p=w / w.sum())
    served = [int(pick.integers(1, plan[i].max_tokens)) for i in idx]
    rs = np.random.default_rng(int(seed) + 1)
    out = []
    for i, d in zip(idx, served):
        n = min(len(plan[i].prompt) + d - 1, longest_prompt)
        out.append(Planned(0.0, rs.integers(1, vocab, size=n,
                                            dtype=np.int32),
                           plan[i].max_tokens - d + 1))
    return out
