"""The port's spec reader and writer (``repro_torch.scopeplot.specyaml``)
against PyYAML: ``load`` gives what ``yaml.safe_load`` gives on every
spec the reference's ScopePlot and report tests write, on every YAML
block of ``docs/scopeplot.md``, on every spec the reference's report
emits on its golden fixture, and on a table of scalars that covers the
YAML 1.1 resolvers; its key lines are what ``yaml.compose`` reports;
``dump`` reads back through ``yaml.safe_load`` to the same object; and
what lies outside the subset raises ``SpecError`` at its line."""
import datetime
import json
import math
import os
import pathlib
import random
import re

import pytest
import yaml

import test_report
import test_scopeplot
from repro.scopeplot.report import generate_run_report as ref_run_report
from repro_torch.scopeplot import specyaml
from repro_torch.scopeplot.specyaml import SpecError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b):
    """Equal values of equal types, NaN equal to NaN, keys in order."""
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return len(a) == len(b) and all(
            same(ka, kb) and same(a[ka], b[kb]) for ka, kb in zip(a, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def compose_lines(text):
    node = yaml.compose(text)
    if not isinstance(node, yaml.MappingNode):
        return {}
    return {str(k.value): k.start_mark.line + 1 for k, _ in node.value}


def assert_reads_as_pyyaml(text):
    """The port reads ``text`` as PyYAML does, or both refuse it."""
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(SpecError):
            specyaml.load(text)
        return
    got, lines = specyaml.load(text)
    assert same(got, want), text
    assert lines == compose_lines(text), text


# ---------------------------------------------------------------------------
# every spec the reference's tests write
# ---------------------------------------------------------------------------

@pytest.fixture
def written_specs(monkeypatch):
    """Records the text of every ``*.yaml`` a test writes."""
    texts = []
    real = pathlib.Path.write_text

    def write_text(self, data, *args, **kwargs):
        if str(self).endswith((".yaml", ".yml")):
            texts.append(data)
        return real(self, data, *args, **kwargs)
    monkeypatch.setattr(pathlib.Path, "write_text", write_text)
    return texts


REFERENCE_SPEC_TESTS = [
    (test_scopeplot, "test_spec_render_and_deps", {}),
    (test_scopeplot, "test_latency_cdf_renders_one_line_per_record", {}),
    (test_scopeplot, "test_latency_cdf_is_a_known_spec_type", {}),
    (test_report, "test_load_spec_unknown_type_line_numbered", {}),
    (test_report, "test_load_spec_output_and_series_validation", {}),
    (test_report, "test_load_spec_invalid_yaml", {}),
    (test_report, "test_batch_renders_only_stale", {}),
    *[(test_report, "test_spec_roundtrip_each_plot_type", {"ptype": p})
      for p in ("line", "bar", "grouped_bar", "regression", "speedup",
                "timeseries", "latency_cdf")],
]


@pytest.mark.parametrize("module,name,kwargs", REFERENCE_SPEC_TESTS,
                         ids=[f"{n}{'-' + k['ptype'] if k else ''}"
                              for _, n, k in REFERENCE_SPEC_TESTS])
def test_reads_every_spec_the_reference_tests_write(module, name, kwargs,
                                                    tmp_path,
                                                    written_specs):
    import matplotlib.pyplot as plt
    try:
        getattr(module, name)(tmp_path=tmp_path, **kwargs)
    finally:
        plt.close("all")
    assert written_specs
    for text in written_specs:
        assert_reads_as_pyyaml(text)


def test_reads_every_spec_the_reference_report_emits(tmp_path):
    """The golden fixture's specs and the latency fixture's, as the
    reference's report writes them with ``yaml.safe_dump``."""
    import matplotlib.pyplot as plt
    seen = 0
    for fixture, name in ((test_report.fixture_run_dir, "golden"),
                          (test_report.latency_run_dir, "latency")):
        run_dir = fixture(tmp_path / name)
        ref_run_report(str(run_dir))
        plt.close("all")
        specs = run_dir / "report" / "specs"
        for spec in sorted(os.listdir(specs)):
            assert_reads_as_pyyaml((specs / spec).read_text())
            seen += 1
    assert seen == 7          # times, trend, speedup; and latency's four


def _doc_blocks():
    text = open(os.path.join(ROOT, "docs", "scopeplot.md")).read()
    blocks = re.findall(r"^( *)```yaml\n(.*?)^\1```", text, re.S | re.M)
    return ["".join(line[len(indent):] + "\n"
                    for line in body.splitlines())
            for indent, body in blocks]


def test_reads_every_yaml_block_of_the_docs():
    blocks = _doc_blocks()
    assert len(blocks) >= 2
    for text in blocks:
        assert_reads_as_pyyaml(text)
        assert isinstance(specyaml.load(text)[0], dict)


# ---------------------------------------------------------------------------
# the YAML 1.1 resolvers, and the subset's syntax
# ---------------------------------------------------------------------------

SCALARS = [
    # floats: a sign in the exponent and a dot are both needed
    "1.0e-9", "1e-9", "1.5e9", "1.0e+9", "1.", ".5", "-.5", "+1.25",
    "1_000.5", "190:20:30.15", ".inf", "-.Inf", "+.INF", ".nan", ".NaN",
    "1.0E-3", "6.8523015e+5",
    # ints: octal, hex, binary, sexagesimal, underscores; 08 is a string
    "0", "-0", "17", "+17", "017", "08", "0x1f", "-0x1F", "0b101",
    "1_000", "1:30", "-1:30:00", "00",
    # booleans and nulls
    "yes", "Yes", "YES", "no", "No", "on", "On", "ON", "off", "Off",
    "true", "True", "TRUE", "false", "False", "y", "n", "~", "null",
    "Null", "NULL", "",
    # timestamps
    "2026-07-31", "2026-7-31", "2026-07-31T00:00:00",
    "2026-07-31 10:00:00.5 +02:00", "2026-07-31t10:00:00Z",
    "2026-07-31 10:00:00.123456789 -05",
    # strings
    "line", "log", "s/a/n:1", "^s/", "example/saxpy.*", "../s_times.png",
    "run r2", "mean time (us)", "a,b", "a[0]", "x:y", "-x", "?x", "a#b",
    "it's", "1.2.3", "0o17", "1e5", "inf", "nan", "NaN", "nulls",
]


@pytest.mark.parametrize("text", SCALARS)
def test_plain_scalars_resolve_as_pyyaml(text):
    assert_reads_as_pyyaml(f"k: {text}\n")
    assert_reads_as_pyyaml(f"- {text}\n")
    assert_reads_as_pyyaml(f"k: [{text}]\n" if text and text[0] not in
                           "?-" else f"k: '{text}'\n")
    if text:
        assert_reads_as_pyyaml(f"{text}: v\n" if text[0] not in "?-"
                               else f"'{text}': v\n")
    assert_reads_as_pyyaml(f"k: '{text}'\n".replace("'it's'",
                                                    "'it''s'"))
    assert_reads_as_pyyaml(f'k: "{text}"\n')


SYNTAX = [
    "a: 1\nb: [7, 4.5]\nc: {label: n, scale: log}\n",
    "series:\n  - input_file: r.json   # a comment\n    params: {backend: "
    "xla}\n    group_by: dtype\n",
    "series:\n- label: a\n  params:\n  - x\n  - y\nz: 1\n",
    "- - 1\n  - - 2\n    - 3\n- {}\n- []\n- [[], {}]\n",
    "---\na: 1\n",
    "", "# only a comment\n", "\n\n  \n",
    "a:\nb: ~\nc:\n  # nothing\nd: 1\n",
    "a: {x: [1, 2, {y: z}], w: , v}\n",
    "a: [a b, 'c d', \"e\", ]\n",
    "a: [\n  1,  # one\n  2\n]\nb: {\n  k: v,\n  l: [1,\n    2]}\n",
    "k: a\n  b\n\n  c\nz: 1\n",
    "k: 'multi\n  line''s\n\n  end'\n",
    "k: \"multi \\\n  line\\tx\\u2014\\x41\\U0001F600\\N\\_\"\n",
    "'quoted key': 1\n\"dq\": 2\n",
    "title: x\ntype: line\nseries:\n- label: a\n  input_file: r.json\n"
    "  regex: \"s/a\"\n  yscale: 1.0e-9\n",
    "a: b # c\nd: e#f\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n",
    "a: x\na: y\n",
    "[1, 2]\n", "plain\n", "- a\n- b:\n    c\n",
    "k: {a: 1, b: {c: [d, e]}}\n",
    "k: - x\n", "a: 1\n b: 2\n", "a:\n  - 1\n  b: 2\n", "a: [1, 2\n",
    "a: 'x\n", "k: \"\\q\"\n", "a: b: c\n", "\ta: 1\n",
]


@pytest.mark.parametrize("text", SYNTAX)
def test_syntax_reads_as_pyyaml(text):
    assert_reads_as_pyyaml(text)


def test_dates_and_special_floats():
    got, _ = specyaml.load("d: 2026-07-31\nt: 2026-07-31 10:00:00 +02:00\n"
                           "n: .nan\ni: -.inf\n")
    assert got["d"] == datetime.date(2026, 7, 31)
    assert got["t"].utcoffset() == datetime.timedelta(hours=2)
    assert math.isnan(got["n"]) and got["i"] == -math.inf


# ---------------------------------------------------------------------------
# refusals carry their line
# ---------------------------------------------------------------------------

REFUSED = [
    ("title: x\nseries:\n  - input_file: &f r.json\n", 3, "anchors"),
    ("a: 1\nb: *f\n", 2, "aliases"),
    ("a: 1\n\nb: !!str 1\n", 3, "tags"),
    ("a: |\n  x\n", 1, "block scalars"),
    ("a: 1\nb: >\n  folded\n", 2, "block scalars"),
    ("a: 1\n---\nb: 2\n", 2, "several documents"),
    ("a: 1\n...\n", 2, "several documents"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
    ("a: 1\n? b\n: c\n", 2, "complex keys"),
    ("a: 1\n<<: {b: 2}\n", 2, "'<<'"),
    ("a: [x, &y z]\n", 1, "anchors"),
    ("a:\n  - {[1]: 2}\n", 2, "complex keys"),
    ("type: line\n  bad: [\n", 2, ""),
]


@pytest.mark.parametrize("text,line,what", REFUSED)
def test_outside_the_subset_is_refused_at_its_line(text, line, what):
    with pytest.raises(SpecError) as e:
        specyaml.load(text, "spec.yaml")
    assert e.value.line == line
    assert str(e.value).startswith(f"spec.yaml:{line}: ")
    assert what in e.value.message
    assert isinstance(e.value, ValueError)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

TRICKY = ["", " lead", "trail ", "yes", "No", "null", "~", "1.0", "1e-9",
          "017", "0x1f", "2026-07-31", "a: b", "a #b", "#c", "-", "- x",
          "-x", "?", "? x", ":x", "x:", "[a]", "{a}", "a,b", "it's",
          "'q'", '"dq"', "tab\there", "line\nbreak", "s \u2014 x",
          "\u00e9t\u00e9", "\U0001F600", "\x85\xa0\u2028", "---", "...x",
          "<<", "=", "&a", "*a", "!t", "|", ">", "%x", "@x", "`x", "a\\b",
          "^s/", "../s_times.svg", "x" * 100 + " " + "y" * 100]


def test_dump_round_trips_through_pyyaml():
    obj = {
        "title": "s \u2014 mean time per instance", "type": "grouped_bar",
        "output": "../s_times.svg", "x_axis": {"label": "instance"},
        "y_axis": {"label": "mean time (us)", "scale": "log"},
        "figsize": [7, 4.5], "dpi": 120,
        "series": [{"label": "run r2", "input_file": "../../merged.json",
                    "regex": "^s/", "xfield": "name",
                    "yfield": "real_time_s", "yscale": 1e6,
                    "params": {"dtype": ["f32", "bf16"], "n": 1024}},
                   {"label": None, "flag": True, "off": False,
                    "tiny": 1e-9, "big": 1e20, "inf": math.inf,
                    "neg": -math.inf, "zero": 0.0, "empty_l": [],
                    "empty_d": {}, "nested": [[1, [2, []]], {"a": {}}]}],
        "strings": TRICKY, **{s: i for i, s in enumerate(TRICKY) if s},
    }
    text = specyaml.dump(obj)
    assert same(yaml.safe_load(text), obj)
    assert same(specyaml.load(text)[0], obj)
    assert text.startswith("title: ") and "\n- label: run r2\n" in text


def test_dump_writes_what_safe_dump_writes_for_report_specs(tmp_path):
    """Block style, insertion order, PyYAML's quoting and float text:
    the specs a report emits come out byte for byte as
    ``yaml.safe_dump(spec, sort_keys=False)`` writes them."""
    spec = {"title": "s \u2014 speedup vs previous run", "type": "speedup",
            "output": "../s_speedup.svg",
            "x_axis": {"label": "speedup (previous / this run)"},
            "baseline": {"input_file": "../data/prev.json", "regex": "^s/"},
            "series": [{"label": "this run",
                        "input_file": "../../merged.json", "regex": "^s/",
                        "yscale": 1e6, "xscale": 1e3, "tiny": 1e-9}]}
    assert specyaml.dump(spec) == yaml.safe_dump(spec, sort_keys=False)


#: Characters the random strings draw from: letters and digits, YAML's
#: indicators, quotes, whitespace and line breaks, control and non-ASCII
#: characters.
_CHARS = ("abcXYZ019 _-.:#&*!|>'\"%@`,[]{}?=~\t\n\r\x00\x07\x85"
          "\u00e9\u2014\u2028\ufeff\U0001f600")
_FLOATS = (0.0, -0.0, 1.0, -1.5, 1e-9, 1e20, 1e300, -1e-300, 5e-324,
           math.inf, -math.inf, 0.1, 1e16, 12345.678)


def _text(rng, min_size=0, max_size=12):
    return "".join(rng.choice(_CHARS)
                   for _ in range(rng.randint(min_size, max_size)))


def _scalar(rng):
    kind = rng.randrange(6)
    if kind == 0:
        return None
    if kind == 1:
        return rng.random() < 0.5
    if kind == 2:
        return rng.randint(-10**12, 10**12)
    if kind == 3:
        return rng.choice(_FLOATS)
    if kind == 4:
        return rng.uniform(-1, 1) * 10.0 ** rng.randint(-30, 30)
    return _text(rng)


def _tree(rng, leaves):
    """A scalar, or a list or dict of up to four subtrees; ``leaves`` is
    the budget of scalars left in the whole tree (12 at most)."""
    if leaves[0] <= 1 or rng.random() < 0.5:
        leaves[0] -= 1
        return _scalar(rng)
    n = rng.randint(0, 4)
    if rng.random() < 0.5:
        return [_tree(rng, leaves) for _ in range(n) if leaves[0] > 0]
    return {_text(rng, 1, 8): _tree(rng, leaves)
            for _ in range(n) if leaves[0] > 0}


def _random_spec(rng):
    """Dicts of 1-5 string keys over trees of scalars, lists and dicts
    (at most 12 leaves a tree): the space the round trip is held on."""
    return {_text(rng, 1, 8): _tree(rng, [12])
            for _ in range(rng.randint(1, 5))}


def test_dump_round_trips_any_tree():
    rng = random.Random(0)
    for _ in range(150):
        obj = _random_spec(rng)
        text = specyaml.dump(obj)
        assert same(yaml.safe_load(text), obj), text
        assert same(specyaml.load(text)[0], obj), text


def test_dump_refuses_what_a_spec_cannot_hold():
    with pytest.raises(TypeError):
        specyaml.dump({"a": object()})
    with pytest.raises(TypeError):
        specyaml.dump({"a": datetime.date(2026, 7, 31)})
    assert json.loads(json.dumps(specyaml.load(specyaml.dump(
        {"a": [1, "2"]}))[0])) == {"a": [1, "2"]}
