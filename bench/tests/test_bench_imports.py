"""No module the benchmark loads is JAX or the JAX package; the check
compares whole top-level names, so the port (``repro_torch``) passes and
a planted ``import repro`` does not."""
import subprocess
import sys
import textwrap

from conftest import ROOT

PROBE = textwrap.dedent("""
    import sys
    sys.path[:0] = {extra!r} + [{root!r}, {src!r}]
    import importlib, pkgutil
    import bench
    for m in pkgutil.walk_packages(bench.__path__, "bench."):
        if ".tests" not in m.name:
            importlib.import_module(m.name)
    from bench.lib import harness, spec
    for name in ("train_tokens_per_s", "mfu.train", "idle_share.serve"):
        spec.reader(name)
    import repro_torch.train, repro_torch.serve, repro_torch.models
    {plant}
    print(",".join(harness.forbidden_modules()))
""")


def _probe(tmp_path, plant=""):
    extra = [str(tmp_path)] if plant else []
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), extra=extra,
                        plant=plant)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""


def test_the_benchmark_loads_no_jax(tmp_path):
    assert _probe(tmp_path) == ""


def test_a_planted_import_of_the_jax_package_is_caught(tmp_path):
    (tmp_path / "repro").mkdir()
    (tmp_path / "repro" / "__init__.py").write_text("")
    (tmp_path / "repro" / "core.py").write_text("")
    assert _probe(tmp_path, "import repro.core") == "repro,repro.core"
