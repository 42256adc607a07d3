"""Instance fingerprints — the identity key of incremental benchmarking.

The port of ``repro.core.fingerprint``.  A benchmark collection at scale
re-measures an instance only when something that could change its
number changed.  This module computes that "something" as a
deterministic, environment-insensitive digest per benchmark instance:

  * the family **body** and **fixture** source (captured at registration,
    :mod:`repro_torch.core.registry`), plus the ``set_sync`` fence source
    and the canonical forms of the ``set_meters`` / ``set_tunable``
    declarations;
  * the instance's **canonical params JSON** (:meth:`Params.canonical`);
  * the transitive ``repro_torch.kernels.*`` **sources** the family
    reaches: its Python modules and, for each kernel package reached,
    the CUDA sources it is built from (``csrc/*``, the shared
    ``_hopper/*.cuh`` helpers and ``_build.py``, whose flags are part of
    the build), so a kernel edit re-measures every family driving it;
  * the **active tuned artifact** for the family's tunable kernel on the
    run's card (:mod:`repro_torch.kernels.tuning`: the configs of each
    variant under the card's name — shipping new tiles changes what
    runs);
  * the **torch, CUDA and nvcc versions** (a stack upgrade re-measures
    everything).

Two differences from the reference, both by design:

  * **Discovery seeds.**  The reference seeds kernel discovery from the
    imports inside a family's body and fixture, where its scopes import
    their Pallas kernels.  The port's mxu, histo and linalg scopes
    import their kernels at module top, so discovery is seeded from the
    defining module's imports as well (every import in its source).
  * **Native sources.**  A kernel here is CUDA C++ built at first use, so
    the kernel closure hashes the non-Python files it is built from, not
    only Python modules.

Nothing host-specific enters the digest — no paths, hostnames, env vars
or timestamps — so the same checkout produces the same fingerprint on
every machine with the same stack and artifact; *machine* identity is
the separate sysinfo digest (:func:`repro_torch.core.sysinfo.
context_digest`).  The pair (fingerprint, sysinfo) decides freshness:
``run --since`` and ``ci`` skip an instance when its current
fingerprint already has a history record on this machine and device.
"""
from __future__ import annotations

import ast
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .benchmark import Benchmark, Params
from .flags import FLAGS
from .logging import get_logger

log = get_logger("fingerprint")

#: Bump when the digest recipe changes — old fingerprints then never
#: match, so every instance re-measures once (safe, conservative).
FINGERPRINT_VERSION = 1

#: Package whose modules are treated as measured-code dependencies.
KERNEL_PACKAGE = "repro_torch.kernels"

#: Hex digest length kept on history records (64 bits of sha256).
DIGEST_LEN = 16

# freshness classifications (coverage table, delta planning)
FRESH = "fresh"      # latest record carries the current fingerprint
STALE = "stale"      # recorded before, but under a different fingerprint
NEVER = "never"      # no record for this instance on this machine

#: ``nvcc --version``'s release, read once a process ("" when absent).
_NVCC_RELEASE: List[str] = []


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


# ---------------------------------------------------------------------------
# transitive repro_torch.kernels.* source discovery
# ---------------------------------------------------------------------------

def _kernels_root() -> str:
    """Filesystem root of the kernels package (no kernel import needed)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "kernels")


def _module_file(module: str) -> Optional[str]:
    """Source file of a ``repro_torch.kernels.*`` module, resolved on
    disk (pure path resolution: nothing is imported)."""
    if module == KERNEL_PACKAGE:
        rel: List[str] = []
    elif module.startswith(KERNEL_PACKAGE + "."):
        rel = module[len(KERNEL_PACKAGE) + 1:].split(".")
    else:
        return None
    base = os.path.join(_kernels_root(), *rel)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _read(path: str) -> Optional[str]:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _module_source(module: str) -> Optional[str]:
    path = _module_file(module)
    return None if path is None else _read(path)


def _imports_of(source: str, package: str = "") -> List[str]:
    """Absolute module names imported by ``source``.

    ``package`` resolves relative imports (``from .ops import matmul``
    inside ``repro_torch.kernels.matmul`` →
    ``repro_torch.kernels.matmul.ops``).  ``from X import Y`` contributes
    both ``X`` and ``X.Y`` — Y may be a submodule (``from .. import
    _build``) or a function; the non-module candidate simply resolves to
    no file later.
    """
    try:
        # function sources captured off a registry arrive indented
        tree = ast.parse(textwrap.dedent(source))
    except SyntaxError:
        return []
    out: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".") if package else []
                if node.level <= len(parts):
                    base = ".".join(parts[:len(parts) - node.level + 1])
                else:
                    continue
            else:
                base = node.module or ""
            if node.module and node.level:
                base = f"{base}.{node.module}" if base else node.module
            if base:
                out.append(base)
                out.extend(f"{base}.{alias.name}" for alias in node.names)
    return out


def kernel_dependencies(sources: Iterable[Optional[str]]) -> List[str]:
    """Transitive ``repro_torch.kernels.*`` modules reachable from
    ``sources``.

    Seeds are import statements found in the given source texts; the
    closure follows imports *inside* the kernels package (``__init__``
    → ``ops.py`` → ``_build``, ``tuning``, ``ref.py``).  Returns sorted
    module names.
    """
    seen: Dict[str, Optional[str]] = {}
    frontier: List[str] = []
    for src in sources:
        if not src:
            continue
        frontier.extend(mod for mod in _imports_of(src)
                        if mod.startswith(KERNEL_PACKAGE))
    while frontier:
        module = frontier.pop()
        if not module.startswith(KERNEL_PACKAGE) or module in seen:
            continue
        src = _module_source(module)
        seen[module] = src
        if src is None:
            continue
        path = _module_file(module) or ""
        package = module if path.endswith("__init__.py") \
            else module.rsplit(".", 1)[0]
        frontier.extend(mod for mod in _imports_of(src, package=package)
                        if mod.startswith(KERNEL_PACKAGE)
                        and mod not in seen)
    return sorted(m for m, src in seen.items() if src is not None)


def native_sources(modules: Iterable[str]) -> List[str]:
    """The non-Python files the kernels of ``modules`` are built from,
    as paths relative to the kernels root: every file under a reached
    kernel package's ``csrc/``, and — when any is reached — the shared
    ``_hopper/*.cuh`` helpers and ``_build.py`` (its compiler flags)."""
    root = _kernels_root()
    packages = {m[len(KERNEL_PACKAGE) + 1:].split(".")[0]
                for m in modules if m.startswith(KERNEL_PACKAGE + ".")}
    files: List[str] = []
    for pkg in sorted(packages):
        csrc = os.path.join(root, pkg, "csrc")
        if os.path.isdir(csrc):
            files.extend(f"{pkg}/csrc/{name}"
                         for name in sorted(os.listdir(csrc))
                         if os.path.isfile(os.path.join(csrc, name)))
    if files:
        hopper = os.path.join(root, "_hopper")
        if os.path.isdir(hopper):
            files.extend(f"_hopper/{name}"
                         for name in sorted(os.listdir(hopper))
                         if name.endswith(".cuh"))
        files.append("_build.py")
    return files


def _kernel_sources_digest(sources: Iterable[Optional[str]]) -> str:
    modules = kernel_dependencies(sources)
    parts = [f"{module}\n{_module_source(module) or ''}"
             for module in modules]
    root = _kernels_root()
    parts.extend(f"{rel}\n{_read(os.path.join(root, *rel.split('/'))) or ''}"
                 for rel in native_sources(modules))
    return _sha("\n\x00".join(parts)) if parts else ""


# ---------------------------------------------------------------------------
# per-family inputs
# ---------------------------------------------------------------------------

def _defining_module_source(bench: Benchmark) -> Optional[str]:
    """Source of the module that defines the family's body, where the
    port's scopes import their kernels (only its imports seed kernel
    discovery; the text itself enters no digest)."""
    module = sys.modules.get(getattr(bench.fn, "__module__", "") or "")
    if module is None:
        return None
    try:
        return inspect.getsource(module)
    except (OSError, TypeError):
        return None


def _sync_source(bench: Benchmark) -> str:
    """Source of the family's sync fence (``set_sync`` stores only the
    callable, so derive the text here; a builtin/dynamic fence degrades
    to its qualified name — still deterministic)."""
    fn = bench.sync_fn
    if fn is None:
        return ""
    try:
        return inspect.getsource(fn)
    except (OSError, TypeError):
        return getattr(fn, "__qualname__", repr(type(fn).__name__))


def _meters_canonical(bench: Benchmark) -> str:
    if not bench.meters:
        return ""
    return json.dumps([m if isinstance(m, str) else type(m).__name__
                       for m in bench.meters])


def _tunable_canonical(bench: Benchmark) -> str:
    t = bench.tunable
    if t is None:
        return ""
    return json.dumps({
        "kernel": t.kernel,
        "space": sorted(p.canonical() for p in t.space.points()),
        "instance": list(t.instance),
    }, sort_keys=True)


def _run_device(device: Optional[str]) -> str:
    return device or FLAGS.get("device") or "cuda"


def artifact_device(device: str) -> str:
    """The tuned artifact's device key for a run on ``device``: the
    card's name on ``cuda`` (``"cuda"`` when this host has no card, which
    no artifact names), ``"cpu"`` on the CPU."""
    if device != "cuda":
        return device
    import torch
    if not torch.cuda.is_available():
        return "cuda"
    from ..kernels import tuning
    return tuning.device_key(torch.device("cuda"))


def _tuned_artifact(bench: Benchmark, device: Optional[str] = None) -> str:
    """Canonical JSON of the *active* tuned configs for the family's
    kernel on the run's card, by variant ('' when untunable or nothing
    is active).  Content-based: neither where the artifact lives
    (``REPRO_TUNED_DIR``) nor the card's name enters the digest, what
    the card's entry says does."""
    if bench.tunable is None:
        return ""
    from ..kernels import tuning
    kernel = bench.tunable.kernel
    try:
        key = artifact_device(_run_device(device))
        payload = {variant: config
                   for variant in tuning.BUILTIN_DEFAULTS[kernel]
                   if (config := tuning.load_tuned(kernel, key, variant))}
    except Exception:  # noqa: BLE001 - unreadable artifact == no artifact
        payload = None
    if not payload:
        return ""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _nvcc_release() -> str:
    """``nvcc``'s release (``"12.8, V12.8.93"``), asked once a process;
    "" when there is no ``nvcc``."""
    if not _NVCC_RELEASE:
        from ..kernels import _build
        release = ""
        try:
            out = subprocess.run([_build.nvcc(), "--version"],
                                 capture_output=True, text=True, timeout=60,
                                 check=True).stdout
            found = re.search(r"release (.+)$", out, re.MULTILINE)
            release = found.group(1).strip() if found else ""
        except (RuntimeError, OSError, subprocess.SubprocessError):
            release = ""
        _NVCC_RELEASE.append(release)
    return _NVCC_RELEASE[0]


def _stack_versions() -> Dict[str, str]:
    import torch
    return {"torch": torch.__version__,
            "cuda": torch.version.cuda or "",
            "nvcc": _nvcc_release()}


def family_inputs(bench: Benchmark, device: Optional[str] = None
                  ) -> Dict[str, str]:
    """The labeled digest inputs of one family on ``device`` (default:
    the ``--device`` flag); tests introspect this to see *which*
    component moved a fingerprint."""
    versions = _stack_versions()
    return {
        "version": str(FINGERPRINT_VERSION),
        "body": bench.source or f"<uncapturable:{bench.name}>",
        "fixture": bench.fixture_source or "",
        "sync": _sync_source(bench),
        "meters": _meters_canonical(bench),
        "tunable": _tunable_canonical(bench),
        "kernels": _kernel_sources_digest([bench.source,
                                           bench.fixture_source,
                                           _defining_module_source(bench)]),
        "tuned": _tuned_artifact(bench, device),
        "torch": versions["torch"],
        "cuda": versions["cuda"],
        "nvcc": versions["nvcc"],
    }


def family_digest(bench: Benchmark, device: Optional[str] = None) -> str:
    return _sha(json.dumps(family_inputs(bench, device), sort_keys=True))


def instance_fingerprint(bench: Benchmark, params: Params,
                         family_dig: Optional[str] = None,
                         device: Optional[str] = None) -> str:
    """The fingerprint of one (family, parameter point) instance."""
    family_dig = family_dig or family_digest(bench, device)
    return _sha(f"{family_dig}:{params.canonical()}")[:DIGEST_LEN]


def registry_fingerprints(benches: Sequence[Benchmark],
                          device: Optional[str] = None) -> Dict[str, str]:
    """Instance name → fingerprint for every instance of ``benches``.

    This is the map a run carries in its document context
    (``context["fingerprints"]``) so history records stay reproducible
    from the run artifacts alone.
    """
    out: Dict[str, str] = {}
    for bench in benches:
        fam = family_digest(bench, device)
        for name, params in bench.instances():
            out[name] = instance_fingerprint(bench, params, fam)
    return out


# ---------------------------------------------------------------------------
# freshness: fingerprints × history
# ---------------------------------------------------------------------------

def latest_measurements(records: Sequence[Dict[str, Any]],
                        sysinfo: Optional[str] = None
                        ) -> Dict[str, Dict[str, Any]]:
    """Newest *measured* history record per instance name.

    Replayed (``cached``) records and autotuning trials (``tag:
    "tune"``) are not measurements of the current code — they never
    refresh an instance.  ``sysinfo`` restricts to one machine/stack
    digest (records from other machines can't vouch for this one).
    """
    out: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("cached") or rec.get("tag") == "tune":
            continue
        if sysinfo is not None and rec.get("sysinfo") != sysinfo:
            continue
        name = rec.get("name")
        if name:
            out[name] = rec
    return out


def classify(fingerprint: str, rec: Optional[Dict[str, Any]],
             since: str = "") -> str:
    """FRESH / STALE / NEVER for one instance vs its latest record.

    A record only counts as fresh when it actually measured something
    (``mean_s`` present, no errors), its fingerprint matches, and — when
    ``since`` is a non-empty ISO prefix — it is recent enough.
    """
    if rec is None:
        return NEVER
    if rec.get("fingerprint") != fingerprint:
        return STALE
    if rec.get("mean_s") is None or rec.get("errors"):
        return STALE
    if since and str(rec.get("ts", "")) < since:
        return STALE
    return FRESH


def delta_split(plan_items: Sequence[Any], fingerprints: Dict[str, str],
                records: Sequence[Dict[str, Any]], sysinfo: str,
                since: str = ""
                ) -> Tuple[List[Any], Dict[str, Dict[str, Any]]]:
    """Split plan items into (to-run, cached) for a ``--since`` delta run.

    ``cached`` maps instance_id → the latest history record vouching for
    the skipped instance; the orchestrator materializes those into the
    merged document as ``cached: true`` records so reports stay complete.
    """
    latest = latest_measurements(records, sysinfo=sysinfo)
    pending: List[Any] = []
    cached: Dict[str, Dict[str, Any]] = {}
    for item in plan_items:
        fp = fingerprints.get(item.name, "")
        rec = latest.get(item.name)
        if fp and classify(fp, rec, since=since) == FRESH:
            cached[item.instance_id] = rec
        else:
            pending.append(item)
    return pending, cached


def registered_benches(scope_modules: Optional[List[str]] = None,
                       device: Optional[str] = None) -> List[Benchmark]:
    """Load + register the benchmark scopes; return every family.

    The coverage consumer (``repro_torch store status --coverage``) runs
    outside the normal run startup sequence, so this replays its
    registration steps against the process-global registry with default
    flag values — and ``device``, when given, as the ``--device`` flag
    (the scopes register their kernel rows only on the card).  Heavy
    (imports torch via the scope modules) — call lazily.
    """
    from .hooks import HOOKS
    from .registry import REGISTRY
    from .scope import ScopeManager

    REGISTRY.reset()
    mgr = ScopeManager()
    mgr.load(scope_modules)
    if device is not None:
        FLAGS.set("device", device)
    rc = HOOKS.run_pre_parse()
    if rc is None:
        rc = HOOKS.run_post_parse()
    if rc is not None:
        raise RuntimeError(f"scope init hook requested exit ({rc})")
    mgr.register_all()
    return REGISTRY.all()


def coverage(benches: Sequence[Benchmark],
             records: Sequence[Dict[str, Any]],
             sysinfo: Optional[str] = None,
             device: Optional[str] = None) -> Dict[str, Any]:
    """Per-scope freshness coverage — the ``repro_torch store status
    --coverage`` table.

    ``sysinfo`` defaults to the newest record's digest (the machine the
    history was last written from); with no records at all, everything
    is ``never``.
    """
    if sysinfo is None:
        for rec in reversed(records):
            if rec.get("sysinfo"):
                sysinfo = rec["sysinfo"]
                break
    latest = latest_measurements(records, sysinfo=sysinfo)
    scopes: Dict[str, Dict[str, int]] = {}
    stale_names: List[str] = []
    for bench in benches:
        fam = family_digest(bench, device)
        row = scopes.setdefault(bench.scope,
                                {FRESH: 0, STALE: 0, NEVER: 0})
        for name, params in bench.instances():
            fp = instance_fingerprint(bench, params, fam)
            state = classify(fp, latest.get(name))
            row[state] += 1
            if state != FRESH:
                stale_names.append(name)
    totals = {k: sum(row[k] for row in scopes.values())
              for k in (FRESH, STALE, NEVER)}
    return {"sysinfo": sysinfo or "", "scopes": scopes, "totals": totals,
            "instances": totals[FRESH] + totals[STALE] + totals[NEVER],
            "pending": sorted(stale_names)}
