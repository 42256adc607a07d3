"""Tuned-default registry for the hand-written kernels' tile knobs.

The port of ``repro.kernels.tuning``.  ``python -m repro_torch tune``
searches a kernel variant's tiles and writes the winner to the kernel's
artifact (``src/repro_torch/kernels/<name>/tuned.json``); this module is
how the wrappers read it back.  Every public wrapper in
``kernels/*/ops.py`` resolves its knobs through :func:`resolve` at call
time, never once a process, so a tune trial's override reaches the next
call.

Precedence, highest first (the reference's):

  1. explicit kwarg at the call site (``matmul(x, y, bm=64)``)
  2. an active :func:`override` context (how tune trials inject configs)
  3. environment: ``REPRO_TUNED_<KERNEL>_<KNOB>=<int>``
  4. the ``tuned.json`` artifact (skipped entirely when ``REPRO_TUNED``
     is ``off``/``0``/``false``)
  5. the builtin default below: the tile each variant took before
     tuning existed, so that with nothing tuned nothing moves

:func:`resolve` reads all five on every call, as the reference does.
A wrapper keeps its calls' whole resolutions (a :class:`Memo`) until
the registry's generation moves: an override or a :func:`builtins`
block opening or closing, or :func:`invalidate_cache` (which
:func:`write_tuned` calls).  So a tune trial's override reaches the
next call, and a changed ``REPRO_TUNED*`` variable reaches the wrappers
after :func:`invalidate_cache`: a wrapper call's host time is what the
main path pays (PERF.md §5), and reading the environment costs
microseconds.

What differs from the reference, for kernels written in CUDA C++:

  * **Knobs per variant.**  One kernel has variants with different
    legal tiles (matmul's ``wgmma`` takes bk = 64, its ``simt`` bk =
    16), and the variant is what gets tuned: :func:`resolve` takes it.
  * **Legal tiles, not divisibility.**  A tile is a template
    instantiation, so :func:`validate_blocks` checks membership in the
    variant's instantiated set (a constant in its ``ops.py``, mirrored
    from the ``.cu``) and the tile's shared memory against the device's
    per-block opt-in limit.  The kernels mask ragged edges, so there is
    no divisibility rule, and no VMEM budget.
  * **Artifacts keyed by device, then variant.**  An H100 SXM and an
    H100 PCIe must not share a tile: the artifact holds
    ``{"kernel": ..., "devices": {<device name>: {<variant>: {"config":
    {...}, ...}}}}``, the device name being ``torch.cuda.get_device_name``
    (``"cpu"`` for CPU tensors, whose plain version ignores the tile).
"""
from __future__ import annotations

import json
import logging
import os
from contextlib import contextmanager
from typing import (Any, Dict, Iterator, Mapping, Optional, Sequence,
                    Tuple)

import torch

log = logging.getLogger("repro_torch.kernels.tuning")

#: Every tunable kernel and the knobs ``repro_torch tune`` may set (the
#: reference's names).
KERNEL_KNOBS: Dict[str, Tuple[str, ...]] = {
    "matmul": ("bm", "bn", "bk"),
    "flash_attention": ("bq", "bk"),
    "rmsnorm": ("br",),
    "ssd_scan": ("chunk",),
}

#: Each tunable variant's builtin tile: the one it took before tuning.
#: ``None`` is a rule of the shape, filled in by the wrapper (matmul
#: ``simt``'s bn: ``matmul.ops.tile``'s wave rule).  Flash attention's
#: ``wgmma`` variant is not here: no family runs it, so it keeps its
#: fixed 128 x 128 tile.
BUILTIN_DEFAULTS: Dict[str, Dict[str, Dict[str, Optional[int]]]] = {
    "matmul": {"wgmma": {"bm": 128, "bn": 128, "bk": 64},
               "simt": {"bm": 128, "bn": None, "bk": 16}},
    "flash_attention": {"ffma": {"bq": 64, "bk": 64}},
    "rmsnorm": {"rows": {"br": 1}},
    "ssd_scan": {"tiled_n64": {"chunk": 128}, "tiled_n128": {"chunk": 128}},
}

#: ``REPRO_TUNED=off|0|false`` disables tuned.json artifacts entirely
#: (env/kwarg/override still apply) — the escape hatch for A/B runs.
DISABLE_ENV = "REPRO_TUNED"

#: Point artifact lookup at ``<dir>/<kernel>/tuned.json`` instead of the
#: installed package tree (tests, ``chip_smoke.py``'s tune phase).
DIR_ENV = "REPRO_TUNED_DIR"

#: ``REPRO_TUNED_<KERNEL>_<KNOB>`` by kernel and knob, built once.
_ENV_NAMES: Dict[str, Dict[str, str]] = {
    kernel: {knob: f"REPRO_TUNED_{kernel.upper()}_{knob.upper()}"
             for knob in knobs}
    for kernel, knobs in KERNEL_KNOBS.items()}

_TUNED_CACHE: Dict[str, Optional[Dict[str, Any]]] = {}
#: (kernel, variant or None for every variant) -> forced knobs
_OVERRIDES: Dict[Tuple[str, Optional[str]], Dict[str, int]] = {}
_BUILTINS_ONLY = [0]
#: Device index -> ``torch.cuda.get_device_name``: asked once a device.
_DEVICE_NAMES: Dict[int, str] = {}

#: Moves whenever a resolution may change: the wrappers' memos hold for
#: one value.
_GENERATION = [0]

#: The last knobs each kernel's wrapper resolved, as (device name,
#: variant, config): how ``tune`` learns which variant an instance runs
#: and what its builtin tile is there.
last_resolved: Dict[str, Tuple[str, str, Dict[str, int]]] = {}


def kernels() -> Tuple[str, ...]:
    """The tunable kernel names, stable order."""
    return tuple(KERNEL_KNOBS)


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNEL_KNOBS:
        raise ValueError(f"unknown tunable kernel {kernel!r} "
                         f"(known: {', '.join(KERNEL_KNOBS)})")


def _check_variant(kernel: str, variant: str) -> None:
    _check_kernel(kernel)
    if variant not in BUILTIN_DEFAULTS[kernel]:
        raise ValueError(f"{kernel} has no tunable variant {variant!r} "
                         f"(tunable: {', '.join(BUILTIN_DEFAULTS[kernel])})")


def _check_knobs(kernel: str, config: Mapping[str, Any]) -> None:
    bad = [k for k in config if k not in KERNEL_KNOBS[kernel]]
    if bad:
        raise ValueError(f"{kernel} has no knob(s) {', '.join(sorted(bad))} "
                         f"(knobs: {', '.join(KERNEL_KNOBS[kernel])})")


def device_key(device: torch.device) -> str:
    """The artifact's device key for tensors on ``device``: the card's
    name (asked once per device index), or the device type (``"cpu"``)."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    name = _DEVICE_NAMES.get(index)
    if name is None:
        name = _DEVICE_NAMES[index] = torch.cuda.get_device_name(index)
    return name


def tuned_path(kernel: str) -> str:
    """Where ``<kernel>``'s artifact lives (honouring ``REPRO_TUNED_DIR``)."""
    _check_kernel(kernel)
    root = os.environ.get(DIR_ENV) or os.path.dirname(__file__)
    return os.path.join(root, kernel, "tuned.json")


def _artifacts_disabled() -> bool:
    return os.environ.get(DISABLE_ENV, "").lower() in ("off", "0", "false")


def _load_doc(kernel: str) -> Optional[Dict[str, Any]]:
    """The artifact's parsed document, or None.  Cached per path; an
    unreadable one logs a warning and acts as absent."""
    path = tuned_path(kernel)
    if path in _TUNED_CACHE:
        return _TUNED_CACHE[path]
    doc: Optional[Dict[str, Any]] = None
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict) or \
                not isinstance(doc.get("devices", {}), dict):
            raise ValueError("not a {'devices': {...}} document")
    except FileNotFoundError:
        doc = None
    except (OSError, ValueError) as e:
        log.warning("tuned artifact %s unreadable (%s); using defaults",
                    path, e)
        doc = None
    _TUNED_CACHE[path] = doc
    return doc


def load_tuned(kernel: str, device: str, variant: str
               ) -> Optional[Dict[str, int]]:
    """The artifact's knob config for ``variant`` on ``device``, or
    None.  A corrupt or knob-less entry logs a warning and acts as
    absent."""
    doc = _load_doc(kernel)
    if doc is None:
        return None
    entry = doc.get("devices", {}).get(device, {})
    entry = entry.get(variant) if isinstance(entry, dict) else None
    if entry is None:
        return None
    try:
        raw = entry["config"]
        config = {k: int(raw[k]) for k in KERNEL_KNOBS[kernel] if k in raw}
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        log.warning("tuned artifact %s: entry %s/%s unreadable (%s)",
                    tuned_path(kernel), device, variant, e)
        return None
    if not config:
        log.warning("%s carries no known %s knobs for %s/%s; ignoring",
                    tuned_path(kernel), kernel, device, variant)
        return None
    return config


def invalidate_cache() -> None:
    """Forget loaded artifacts and the wrappers' memos (call after
    writing an artifact or changing a ``REPRO_TUNED*`` variable)."""
    _TUNED_CACHE.clear()
    _GENERATION[0] += 1


@contextmanager
def override(kernel: str, config: Mapping[str, int],
             variant: Optional[str] = None) -> Iterator[None]:
    """Force ``kernel``'s knobs (of one ``variant``, or of every
    variant when None) for the dynamic extent of the block — how
    ``repro_torch tune`` injects each trial's candidate config without
    touching artifacts or call sites.  Explicit kwargs still win."""
    _check_kernel(kernel)
    if variant is not None:
        _check_variant(kernel, variant)
    _check_knobs(kernel, config)
    key = (kernel, variant)
    prev = _OVERRIDES.get(key)
    _OVERRIDES[key] = {k: int(v) for k, v in config.items()}
    _GENERATION[0] += 1
    try:
        yield
    finally:
        if prev is None:
            _OVERRIDES.pop(key, None)
        else:
            _OVERRIDES[key] = prev
        _GENERATION[0] += 1


@contextmanager
def builtins() -> Iterator[None]:
    """Resolve without the environment and the artifacts (overrides and
    kwargs still apply): how ``tune`` measures the builtin tile."""
    _BUILTINS_ONLY[0] += 1
    _GENERATION[0] += 1
    try:
        yield
    finally:
        _BUILTINS_ONLY[0] -= 1
        _GENERATION[0] += 1


def resolve(kernel: str, variant: str, *, device: str = "cpu",
            **explicit: Optional[int]) -> Dict[str, Optional[int]]:
    """Final knob values of ``variant`` for one call on ``device`` (an
    artifact key, :func:`device_key`): kwarg > override > env >
    tuned.json > builtin.  ``None`` explicit values mean "not given"; a
    ``None`` result is the variant's shape rule (the wrapper's)."""
    _check_variant(kernel, variant)
    active = _OVERRIDES.get((kernel, variant)) or \
        _OVERRIDES.get((kernel, None)) or {}
    plain = _BUILTINS_ONLY[0] > 0
    tuned = None if plain or _artifacts_disabled() \
        else load_tuned(kernel, device, variant)
    builtin = BUILTIN_DEFAULTS[kernel][variant]
    out: Dict[str, Optional[int]] = {}
    for knob in KERNEL_KNOBS[kernel]:
        value = explicit.get(knob)
        if value is None:
            value = active.get(knob)
        if value is None and not plain:
            name = _ENV_NAMES[kernel][knob]
            env = os.environ.get(name)
            if env is not None:
                try:
                    value = int(env)
                except ValueError:
                    raise ValueError(f"{name}={env!r} is not an integer"
                                     ) from None
        if value is None and tuned is not None:
            value = tuned.get(knob)
        if value is None:
            value = builtin[knob]
        out[knob] = value
    return out


def note(kernel: str, device: str, variant: str,
         config: Mapping[str, int]) -> None:
    """Record the knobs a wrapper is about to launch with
    (:data:`last_resolved`)."""
    last_resolved[kernel] = (device, variant, dict(config))


def write_tuned(kernel: str, payload: Mapping[str, Any], *, device: str,
                variant: str, path: Optional[str] = None) -> str:
    """Write ``payload`` (must carry a ``config`` mapping of known knobs)
    as ``variant``'s entry for ``device`` in the kernel's artifact,
    keeping every other entry — canonical JSON, byte-deterministic for
    identical contents — and invalidate the loader cache."""
    _check_variant(kernel, variant)
    config = payload.get("config")
    if not isinstance(config, Mapping) or not config:
        raise ValueError("tuned payload needs a non-empty 'config' mapping")
    _check_knobs(kernel, config)
    out = path or tuned_path(kernel)
    doc: Dict[str, Any] = {}
    try:
        with open(out, encoding="utf-8") as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict) or \
                not isinstance(doc.get("devices", {}), dict):
            raise ValueError("not a {'devices': {...}} document")
    except FileNotFoundError:
        doc = {}
    except (OSError, ValueError) as e:
        log.warning("tuned artifact %s unreadable (%s); writing it anew",
                    out, e)
        doc = {}
    doc["kernel"] = kernel
    doc.setdefault("devices", {}).setdefault(device, {})[variant] = \
        dict(payload)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    invalidate_cache()
    return out


def validate_blocks(kernel: str, variant: str, blocks: Mapping[str, Any],
                    legal: Mapping[str, Sequence[int]],
                    smem_bytes: Optional[int] = None,
                    smem_limit: Optional[int] = None) -> None:
    """Fail fast on a tile the variant was not built for.

    ``blocks`` are the resolved knob values, ``legal`` each knob's
    instantiated values (the variant's constant in its ``ops.py``),
    ``smem_bytes`` the tile's shared memory a block and ``smem_limit``
    the device's per-block opt-in limit (both given only on the card).
    Raises a ``ValueError`` naming every offending knob instead of
    letting the C entry refuse the launch."""
    _check_variant(kernel, variant)
    problems = []
    for knob, value in blocks.items():
        allowed = tuple(legal[knob])
        if isinstance(value, bool) or not isinstance(value, int) \
                or value not in allowed:
            problems.append(f"{knob}={value!r} is not a tile the {variant} "
                            f"variant is built for ("
                            + ", ".join(map(str, allowed)) + ")")
    if smem_bytes is not None and smem_limit is not None \
            and smem_bytes > smem_limit:
        cfg = ", ".join(f"{k}={v}" for k, v in sorted(blocks.items()))
        problems.append(f"blocks ({cfg}) need {smem_bytes} bytes of shared "
                        f"memory a block; the device allows {smem_limit}")
    if problems:
        raise ValueError(
            f"invalid block config for kernel {kernel!r} ({variant}): "
            + "; ".join(problems)
            + ".  Pass explicit kwargs, set REPRO_TUNED_" + kernel.upper()
            + "_<KNOB>, or re-run `python -m repro_torch tune` "
            "(REPRO_TUNED=off ignores tuned.json)")


class Memo:
    """A wrapper's resolved and validated knobs for calls that name no
    knob, keyed by what the resolution depends on (variant, device
    index, shape), for one generation of the registry."""

    def __init__(self) -> None:
        self._generation = -1
        self._entries: Dict[Any, Any] = {}

    def get(self, key: Any) -> Any:
        if self._generation != _GENERATION[0]:
            self._entries.clear()
            self._generation = _GENERATION[0]
        return self._entries.get(key)

    def put(self, key: Any, value: Any) -> Any:
        self._entries[key] = value
        return value
