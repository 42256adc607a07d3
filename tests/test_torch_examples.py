"""The torch port's four examples (``python -m
repro_torch.examples.<name>``), each in a child process with ``--device
cpu`` from a scratch directory: each exits 0 and writes what the
reference's example writes (plots as SVG); ``train_lm`` runs the
reference's configuration for two steps.  The children start together
and run side by side."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name → (extra arguments, files written under results/).
EXAMPLES = {
    "quickstart": ((), ("quickstart.json", "quickstart.svg")),
    "characterize": ((), ("characterize.json", "characterize.svg",
                          "characterize_dtypes.svg")),
    "serve_lm": ((), ()),
    "train_lm": (("--steps", "2"), ()),
}


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every example started at once, each in its own directory."""
    # four children side by side on a shared host: the trainer, the
    # heaviest, gets four threads, the others one
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for name, (extra, _) in EXAMPLES.items():
        cwd = tmp_path_factory.mktemp(name)
        env_one = dict(env, TMPDIR=str(cwd), OMP_NUM_THREADS=(
            "4" if name == "train_lm" else "1"))
        procs[name] = (cwd, subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}",
             "--device", "cpu", *extra], cwd=cwd, env=env_one,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    yield procs
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(children, name):
    cwd, proc = children[name]
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    for f in EXAMPLES[name][1]:
        path = cwd / "results" / f
        assert path.exists() and path.stat().st_size > 0, f
        if f.endswith(".svg"):
            assert path.read_text().lstrip().startswith(("<?xml", "<svg"))
    if name == "quickstart":
        assert "quickstart/layer_norm/rows:4096," in out
    elif name == "serve_lm":
        assert "'requests': 12" in out and "'tokens': 288" in out
    elif name == "train_lm":
        assert "trained 2 steps" in out


def test_examples_need_a_card_unless_told_cpu(monkeypatch, capsys):
    from repro_torch.examples import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        quickstart.main([])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
