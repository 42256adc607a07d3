"""``repro_torch.core.search``: the reference's search tests
(``tests/test_search.py``) run through the port's copy on the same
deterministic quadratic bowl, and the port held to the JAX package's
``repro.core.search.run_search``: the same space, seed, budget and
objective give the same trial sequence and the same best."""
import pytest

from repro.core import ParamSpace as RefParamSpace
from repro.core.search import run_search as ref_run_search
from repro_torch.core import ParamSpace, Params
from repro_torch.core.search import (STRATEGIES, Trial, TrialError,
                                     lower_is_better, oriented,
                                     pareto_front, run_search,
                                     screening_plan)

# ---------------------------------------------------------------------------
# a deterministic 3-axis quadratic bowl: axis `a` dominates the
# objective, `b` matters less, `c` barely — minimum at (4, 8, 2)
# ---------------------------------------------------------------------------

AXES = dict(a=[1, 2, 3, 4, 5], b=[2, 4, 8, 16], c=[1, 2, 3])
BOWL = ParamSpace.product(**AXES)


def bowl_eval(p):
    return {"real_time_s": (100.0 * (p.a - 4) ** 2
                            + 1.0 * (p.b - 8) ** 2
                            + 0.01 * (p.c - 2) ** 2
                            + 0.5)}


BOWL_MIN = {"a": 4, "b": 8, "c": 2}


def trial_keys(result):
    return [t.params.canonical() for t in result.trials]


# ---------------------------------------------------------------------------
# screening
# ---------------------------------------------------------------------------

def test_screening_plan_is_center_plus_axis_extremes():
    plan = screening_plan(BOWL)
    labels = [label for label, _ in plan]
    assert labels[0] == "center"
    # center = per-axis median value
    assert dict(plan[0][1]) == {"a": 3, "b": 4, "c": 2}
    # two extreme variants per axis (none collide with the center here)
    assert labels[1:] == ["a", "a", "b", "b", "c", "c"]
    for label, params in plan[1:]:
        assert params[label] in (min(BOWL.points(), key=lambda p: p[label])[label],
                                 max(BOWL.points(), key=lambda p: p[label])[label])


def test_screening_plan_respects_constraints():
    # prune exactly the geometric-center point (axis values unchanged)
    space = BOWL.where(lambda p: dict(p) != {"a": 3, "b": 4, "c": 2})
    plan = screening_plan(space)
    # falls back to the first in-space point, deterministically
    assert plan[0][1] == space.points()[0]
    members = {p.canonical() for p in space.points()}
    assert all(p.canonical() in members for _, p in plan)


def test_screening_ranks_most_sensitive_axis_first():
    result = run_search(BOWL, bowl_eval, strategy="screening", budget=7)
    axes = [axis for axis, _ in result.sensitivity]
    spans = [span for _, span in result.sensitivity]
    assert axes == ["a", "b", "c"]
    assert spans == sorted(spans, reverse=True)
    assert spans[0] > 100 * spans[2]


# ---------------------------------------------------------------------------
# hill-climb / auto
# ---------------------------------------------------------------------------

def test_auto_converges_to_the_bowl_minimum_within_budget():
    result = run_search(BOWL, bowl_eval, strategy="auto", budget=20, seed=0)
    assert result.best is not None
    assert dict(result.best.params) == BOWL_MIN
    assert result.best.metrics["real_time_s"] == pytest.approx(0.5)
    assert len(result.trials) <= 20


def test_hillclimb_only_converges_from_the_center():
    result = run_search(BOWL, bowl_eval, strategy="hillclimb", budget=30,
                        seed=1)
    assert dict(result.best.params) == BOWL_MIN


def test_budget_is_a_hard_ceiling_and_exhaustion_is_reported():
    result = run_search(BOWL, bowl_eval, strategy="auto", budget=3)
    assert len(result.trials) == 3
    assert result.exhausted
    full = run_search(BOWL, bowl_eval, strategy="screening", budget=50)
    assert not full.exhausted
    assert len(full.trials) == len(screening_plan(BOWL))


def test_cached_configs_do_not_consume_budget():
    calls = []

    def counting_eval(p):
        calls.append(p.canonical())
        return bowl_eval(p)

    result = run_search(BOWL, counting_eval, strategy="auto", budget=25)
    assert len(calls) == len(set(calls))          # never re-evaluated
    assert len(result.trials) == len(calls) <= 25


def test_same_seed_same_trial_sequence_different_seed_may_differ():
    a = run_search(BOWL, bowl_eval, strategy="auto", budget=12, seed=7)
    b = run_search(BOWL, bowl_eval, strategy="auto", budget=12, seed=7)
    assert trial_keys(a) == trial_keys(b)
    assert a.to_json() == b.to_json()


def test_rate_objectives_are_maximized():
    assert lower_is_better("real_time_s")
    assert not lower_is_better("flops_per_second")

    def rate_eval(p):
        return {"flops_per_second": float(p.a)}

    result = run_search(BOWL, rate_eval, objective="flops_per_second",
                        strategy="auto", budget=15, seed=0)
    assert result.best.params["a"] == 5


def test_trial_errors_consume_budget_and_are_recorded():
    def flaky(p):
        if p.a == 3:
            raise TrialError("boom")
        return bowl_eval(p)

    result = run_search(BOWL, flaky, strategy="screening", budget=7)
    errored = [t for t in result.trials if not t.ok]
    assert errored and all(t.error == "boom" for t in errored)
    assert result.best is not None
    assert result.best.params["a"] != 3


def test_everything_fails_yields_no_best():
    def always(p):
        raise TrialError("nope")

    result = run_search(BOWL, always, strategy="auto", budget=5)
    assert result.best is None
    assert all(not t.ok for t in result.trials)


def test_baseline_runs_first_when_in_space():
    base = Params({"a": 1, "b": 2, "c": 1})
    result = run_search(BOWL, bowl_eval, strategy="auto", budget=10,
                        baseline=base)
    assert result.baseline is not None
    assert result.baseline.index == 0
    assert result.trials[0].params.canonical() == base.canonical()


def test_cost_hints_steer_evaluation_order():
    plan = screening_plan(BOWL)
    expensive = plan[1][1].canonical()  # first a-extreme variant

    def hint(p):
        return 9.9 if p.canonical() == expensive else 0.1

    result = run_search(BOWL, bowl_eval, strategy="screening", budget=7,
                        cost_hint=hint)
    # the hinted-expensive variant is evaluated last of the variants
    assert trial_keys(result)[-1] == expensive


def test_invalid_strategy_and_budget_raise():
    with pytest.raises(ValueError):
        run_search(BOWL, bowl_eval, strategy="exhaustive")
    with pytest.raises(ValueError):
        run_search(BOWL, bowl_eval, budget=0)
    with pytest.raises(ValueError):
        run_search(ParamSpace.product(a=[1]).where(lambda p: False),
                   bowl_eval)
    assert set(STRATEGIES) == {"auto", "screening", "hillclimb"}


# ---------------------------------------------------------------------------
# pareto frontier
# ---------------------------------------------------------------------------

def _trial(i, time_s, rate=None, error=None):
    metrics = {} if error else {"real_time_s": time_s}
    if rate is not None and not error:
        metrics["flops_per_second"] = rate
    return Trial(index=i, phase="screen", params=Params({"a": i}),
                 metrics=metrics, error=error)


def test_pareto_front_is_orientation_aware():
    trials = [
        _trial(0, 1.0, rate=10.0),   # fast, slow rate — on the front
        _trial(1, 2.0, rate=20.0),   # slower but higher rate — on front
        _trial(2, 2.0, rate=5.0),    # dominated by 0 (and 1)
        _trial(3, 3.0, rate=20.0),   # dominated by 1
        _trial(4, 9.9, error="x"),   # failed — excluded
        _trial(5, 4.0),              # missing the rate — excluded
    ]
    front = pareto_front(trials, ["real_time_s", "flops_per_second"])
    assert [t.index for t in front] == [0, 1]


def test_pareto_front_single_objective_is_the_argmin():
    trials = [_trial(0, 3.0), _trial(1, 1.0), _trial(2, 2.0)]
    front = pareto_front(trials, ["real_time_s"])
    assert [t.index for t in front] == [1]


def test_oriented_scores():
    t = _trial(0, 2.0, rate=8.0)
    assert oriented("real_time_s", t) == 2.0
    assert oriented("flops_per_second", t) == -8.0
    assert oriented("missing_metric", t) == float("inf")
    assert oriented("real_time_s", _trial(1, 0, error="x")) == float("inf")


# ---------------------------------------------------------------------------
# parity with the JAX package's search
# ---------------------------------------------------------------------------

def _ref_space(constrained):
    space = RefParamSpace.product(**AXES)
    return space.where(lambda p: (p["a"] + p["b"]) % 3 != 0) \
        if constrained else space


def _port_space(constrained):
    space = ParamSpace.product(**AXES)
    return space.where(lambda p: (p["a"] + p["b"]) % 3 != 0) \
        if constrained else space


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed,budget", [(0, 5), (3, 12), (7, 40)])
@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("objective", ["real_time_s", "flops_per_second"])
def test_search_matches_reference(strategy, seed, budget, constrained,
                                  objective):
    """Same space, seed, budget and deterministic objective: identical
    trial sequences (order, phase, params, metrics), best, baseline,
    sensitivity, frontier and exhaustion in both packages."""
    def evaluate(p):
        metrics = bowl_eval(p)
        if objective == "flops_per_second":
            metrics = {"flops_per_second": 1.0 / metrics["real_time_s"],
                       "real_time_s": metrics["real_time_s"]}
        if p["a"] == 2 and p["c"] == 3:
            raise TrialError("a failing config")
        return metrics

    base = {"a": 1, "b": 2, "c": 1}
    ref = ref_run_search(_ref_space(constrained), evaluate,
                         objective=objective, strategy=strategy,
                         budget=budget, seed=seed,
                         baseline=RefParamSpace.product(
                             **{k: [v] for k, v in base.items()}).points()[0])
    port = run_search(_port_space(constrained), evaluate,
                      objective=objective, strategy=strategy,
                      budget=budget, seed=seed, baseline=Params(base))
    assert port.to_json() == ref.to_json()
    assert [dict(t.params) for t in port.trials] == \
        [dict(t.params) for t in ref.trials]
    assert port.best is not None and ref.best is not None
    assert dict(port.best.params) == dict(ref.best.params)
