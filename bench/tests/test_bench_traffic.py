"""The traffic generator: one seed gives one schedule; seeds change the
tokens, never the sizes, their order or the arrivals."""
import numpy as np
import torch

from conftest import SERVE, TRAIN
from bench.lib import arrivals, traffic


def _key(plan):
    return [(p.due, p.prompt.tolist(), p.max_tokens) for p in plan]


def test_a_seed_gives_one_schedule():
    a = traffic.serve_schedule(SERVE, 2 ** 31 + 5, 10.0, 256)
    b = traffic.serve_schedule(SERVE, 2 ** 31 + 5, 10.0, 256)
    assert _key(a) == _key(b)


def test_seeds_change_only_the_tokens():
    a = traffic.serve_schedule(SERVE, 1, 10.0, 256)
    b = traffic.serve_schedule(SERVE, 2, 10.0, 256)
    assert _key(a) != _key(b)
    assert len(a) == len(b) == round(SERVE["rate"] * 10.0)
    assert [(p.due, len(p.prompt), p.max_tokens) for p in a] == \
        [(p.due, len(p.prompt), p.max_tokens) for p in b]
    due = [p.due for p in a]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 10.0


def test_requests_in_flight_are_caught_part_way():
    plan = traffic.serve_schedule(SERVE, 1, 10.0, 256)
    a = traffic.in_flight(SERVE, plan, 50, 1, 256, 64)
    b = traffic.in_flight(SERVE, plan, 50, 2 ** 31 + 3, 256, 64)
    assert len(a) == 50
    assert [(len(p.prompt), p.max_tokens) for p in a] == \
        [(len(p.prompt), p.max_tokens) for p in b]
    assert [p.prompt.tolist() for p in a] != [p.prompt.tolist() for p in b]
    outputs = [p.max_tokens for p in plan]
    assert all(2 <= p.max_tokens <= max(outputs) for p in a)
    shortest = min(len(p.prompt) for p in plan)
    assert all(shortest <= len(p.prompt) <= 64 for p in a)
    # a request's prompt and output together are never more than the
    # longest of the plan's requests it was drawn from
    longest = max(len(p.prompt) + p.max_tokens for p in plan)
    assert all(len(p.prompt) + p.max_tokens - 1 <= longest for p in a)
    assert traffic.in_flight(SERVE, plan, 0, 1, 256, 64) == []


def test_lengths_keep_to_their_bounds():
    plan = traffic.serve_schedule(SERVE, 7, 30.0, 256)
    lo, hi = SERVE["prompt"]["min"], SERVE["prompt"]["max"]
    assert all(lo <= len(p.prompt) <= hi for p in plan)
    assert all(1 <= int(p.prompt.min()) and int(p.prompt.max()) < 256
               for p in plan)


def test_arrival_copy_is_deterministic():
    assert arrivals.poisson(3.0, 20, 9) == arrivals.poisson(3.0, 20, 9)
    assert arrivals.bursty(3.0, 20, 9) != arrivals.poisson(3.0, 20, 9)


def test_train_feed_repeats_and_differs_by_step_and_seed():
    f = traffic.train_feed(TRAIN, 256, 2 ** 32 + 3, "cpu")
    g = traffic.train_feed(TRAIN, 256, 2 ** 32 + 3, "cpu")
    h = traffic.train_feed(TRAIN, 256, 2 ** 32 + 4, "cpu")
    b0, b1 = f(0), f(1)
    assert b0["tokens"].shape == (TRAIN["batch"], TRAIN["seq_len"])
    assert b0["tokens"].dtype == torch.int32
    assert torch.equal(b0["tokens"], g(0)["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert not torch.equal(b0["tokens"], h(0)["tokens"])
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    assert int(b0["tokens"].min()) >= 0 and int(b0["tokens"].max()) < 256
    # packed documents: end tokens, at least 8 tokens apart
    ends = (b0["tokens"] == TRAIN["eos_id"]).nonzero()
    assert len(ends) > 0


def test_the_steady_count_follows_littles_law():
    from types import SimpleNamespace
    from bench.kinds import serve
    engine = SimpleNamespace(cfg=SimpleNamespace(max_batch=64),
                             _bucket=lambda n: 64)
    timing = {"prefill_s": {64: 0.1}, "step_s": 0.05}
    plan = traffic.serve_schedule(SERVE, 1, 10.0, 256)
    stays = np.mean([p.max_tokens for p in plan]) - 1
    # 2 req/s: prefills take a fifth of the time; a token 0.0625 s
    assert serve.steady_count(engine, plan, timing, 2.0) == \
        round(2.0 * stays * 0.0625)
    # prefills alone fill the time: the pool is full
    assert serve.steady_count(engine, plan, timing, 10.0) == 64
