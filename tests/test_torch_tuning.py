"""``repro_torch.kernels.tuning``, the tuned-default registry, and the
wrappers' run-time tiles, on the CPU.

The reference's registry tests (``tests/test_search.py``: precedence,
``REPRO_TUNED=off``, corrupt artifacts, byte-determinism) run against
the port's registry, which keys knobs by kernel variant and artifacts by
device name, then by variant.  The wrappers resolve and validate their
tiles on CPU tensors exactly as on the card (the plain version ignores
the tile), so a bad tile raises here too, and with nothing tuned each
variant resolves the tile it took before tiles became knobs."""
import json
import os

import pytest
import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops

H100_SXM = "NVIDIA H100 80GB HBM3"
H100_PCIE = "NVIDIA H100 PCIe"


@pytest.fixture
def tuned_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.DIR_ENV, str(tmp_path))
    monkeypatch.delenv(tuning.DISABLE_ENV, raising=False)
    for kernel in tuning.kernels():
        for knob in tuning.KERNEL_KNOBS[kernel]:
            monkeypatch.delenv(
                f"REPRO_TUNED_{kernel.upper()}_{knob.upper()}",
                raising=False)
    tuning.invalidate_cache()
    yield tmp_path
    tuning.invalidate_cache()


# ---------------------------------------------------------------------------
# the registry (the reference's contract, per variant and device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k in tuning.kernels() for v in tuning.BUILTIN_DEFAULTS[k]])
def test_resolve_builtin_when_nothing_tuned(tuned_dir, kernel, variant):
    assert tuning.resolve(kernel, variant, device=H100_SXM) == \
        tuning.BUILTIN_DEFAULTS[kernel][variant]


def test_resolve_precedence_chain(tuned_dir, monkeypatch):
    # 4. artifact beats builtin
    tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 64, "bk": 64}},
                       device=H100_SXM, variant="wgmma")
    assert tuning.resolve("matmul", "wgmma", device=H100_SXM) == \
        {"bm": 64, "bn": 64, "bk": 64}
    # 3. env beats artifact (per knob)
    monkeypatch.setenv("REPRO_TUNED_MATMUL_BM", "128")
    tuning.invalidate_cache()
    assert tuning.resolve("matmul", "wgmma", device=H100_SXM)["bm"] == 128
    assert tuning.resolve("matmul", "wgmma", device=H100_SXM)["bn"] == 64
    # 2. override beats env
    with tuning.override("matmul", {"bm": 64}):
        assert tuning.resolve("matmul", "wgmma", device=H100_SXM)["bm"] == 64
        # 1. explicit kwarg beats override
        assert tuning.resolve("matmul", "wgmma", device=H100_SXM,
                              bm=32)["bm"] == 32
    # override is restored on exit
    assert tuning.resolve("matmul", "wgmma", device=H100_SXM)["bm"] == 128


def test_override_of_one_variant_leaves_the_others(tuned_dir):
    with tuning.override("matmul", {"bk": 64}, variant="wgmma"):
        assert tuning.resolve("matmul", "wgmma")["bk"] == 64
        assert tuning.resolve("matmul", "simt")["bk"] == 16
        with tuning.override("matmul", {"bm": 64}):
            # a variant's own override wins over one for every variant
            assert tuning.resolve("matmul", "wgmma")["bm"] == 128
            assert tuning.resolve("matmul", "simt")["bm"] == 64
    assert tuning.resolve("matmul", "wgmma") == \
        tuning.BUILTIN_DEFAULTS["matmul"]["wgmma"]


def test_builtins_context_ignores_env_and_artifacts(tuned_dir, monkeypatch):
    tuning.write_tuned("rmsnorm", {"config": {"br": 8}}, device="cpu",
                       variant="rows")
    monkeypatch.setenv("REPRO_TUNED_RMSNORM_BR", "4")
    tuning.invalidate_cache()
    assert tuning.resolve("rmsnorm", "rows") == {"br": 4}
    with tuning.builtins():
        assert tuning.resolve("rmsnorm", "rows") == {"br": 1}
        with tuning.override("rmsnorm", {"br": 2}):
            assert tuning.resolve("rmsnorm", "rows") == {"br": 2}
    assert tuning.resolve("rmsnorm", "rows") == {"br": 4}


def test_repro_tuned_off_disables_artifacts_only(tuned_dir, monkeypatch):
    tuning.write_tuned("rmsnorm", {"config": {"br": 8}}, device="cpu",
                       variant="rows")
    assert tuning.resolve("rmsnorm", "rows") == {"br": 8}
    monkeypatch.setenv(tuning.DISABLE_ENV, "off")
    tuning.invalidate_cache()
    assert tuning.resolve("rmsnorm", "rows") == \
        tuning.BUILTIN_DEFAULTS["rmsnorm"]["rows"]
    monkeypatch.setenv("REPRO_TUNED_RMSNORM_BR", "2")
    tuning.invalidate_cache()
    assert tuning.resolve("rmsnorm", "rows") == {"br": 2}  # env applies


def test_wrappers_keep_their_resolution_until_it_may_change(tuned_dir,
                                                           monkeypatch):
    """A wrapper's memo holds until an override, a builtins block or
    invalidate_cache() moves the registry's generation; the registry
    itself reads the environment on every call."""
    x = torch.ones(4, 8)
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 1}
    monkeypatch.setenv("REPRO_TUNED_RMSNORM_BR", "4")
    assert tuning.resolve("rmsnorm", "rows") == {"br": 4}
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 1}
    with tuning.override("rmsnorm", {"br": 2}):
        assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 2}
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 4}
    with tuning.builtins():
        assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 1}
    monkeypatch.setenv("REPRO_TUNED_RMSNORM_BR", "8")
    tuning.invalidate_cache()
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 8}


def test_non_integer_env_raises(tuned_dir, monkeypatch):
    monkeypatch.setenv("REPRO_TUNED_MATMUL_BM", "huge")
    tuning.invalidate_cache()
    with pytest.raises(ValueError, match="not an integer"):
        tuning.resolve("matmul", "simt")


@pytest.mark.parametrize("text", [
    "{not json", "[1, 2]", '{"devices": 7}',
    '{"devices": {"cpu": {"tiled_n64": {"config": 5}}}}',
    '{"devices": {"cpu": {"tiled_n64": {"config": {"chunk": "big"}}}}}',
    '{"devices": {"cpu": {"tiled_n64": {"config": {"tile": 8}}}}}'])
def test_corrupt_artifact_degrades_to_builtin(tuned_dir, text):
    path = tuning.tuned_path("ssd_scan")
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as fh:
        fh.write(text)
    assert tuning.resolve("ssd_scan", "tiled_n64") == \
        tuning.BUILTIN_DEFAULTS["ssd_scan"]["tiled_n64"]


def test_write_tuned_is_byte_deterministic(tuned_dir, tmp_path):
    payload = {"config": {"bq": 128, "bk": 32}, "kernel": "flash_attention",
               "objective": "real_time_s", "seed": 0}
    paths = []
    for name, p in (("one", payload), ("two",
                                      dict(reversed(payload.items())))):
        paths.append(tuning.write_tuned(
            "flash_attention", p, device=H100_SXM, variant="ffma",
            path=str(tmp_path / f"{name}.json")))
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_write_tuned_validates_payload(tuned_dir):
    with pytest.raises(ValueError, match="config"):
        tuning.write_tuned("matmul", {"kernel": "matmul"}, device="cpu",
                           variant="simt")
    with pytest.raises(ValueError, match="no knob"):
        tuning.write_tuned("matmul", {"config": {"tile": 8}}, device="cpu",
                           variant="simt")
    with pytest.raises(ValueError, match="unknown tunable kernel"):
        tuning.write_tuned("conv", {"config": {"bm": 8}}, device="cpu",
                           variant="simt")
    with pytest.raises(ValueError, match="no tunable variant"):
        tuning.write_tuned("flash_attention", {"config": {"bq": 64}},
                           device="cpu", variant="wgmma")


def test_override_rejects_unknown_knobs_and_variants():
    with pytest.raises(ValueError, match="no knob"):
        with tuning.override("rmsnorm", {"bm": 8}):
            pass
    with pytest.raises(ValueError, match="no tunable variant"):
        with tuning.override("matmul", {"bm": 64}, variant="tensor"):
            pass


def test_artifacts_are_keyed_by_device_then_variant(tuned_dir):
    """An H100 SXM and an H100 PCIe do not share a tile, a variant's
    entry never reaches another variant, and writing one entry keeps
    every other."""
    tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 64, "bk": 16}},
                       device=H100_SXM, variant="simt")
    tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 128,
                                             "bk": 16}},
                       device=H100_PCIE, variant="simt")
    tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 64, "bk": 64}},
                       device=H100_SXM, variant="wgmma")
    assert tuning.resolve("matmul", "simt", device=H100_SXM) == \
        {"bm": 64, "bn": 64, "bk": 16}
    assert tuning.resolve("matmul", "simt", device=H100_PCIE) == \
        {"bm": 64, "bn": 128, "bk": 16}
    assert tuning.resolve("matmul", "wgmma", device=H100_SXM) == \
        {"bm": 64, "bn": 64, "bk": 64}
    assert tuning.resolve("matmul", "wgmma", device=H100_PCIE) == \
        tuning.BUILTIN_DEFAULTS["matmul"]["wgmma"]
    assert tuning.resolve("matmul", "simt", device="cpu") == \
        tuning.BUILTIN_DEFAULTS["matmul"]["simt"]
    with open(tuning.tuned_path("matmul")) as fh:
        doc = json.load(fh)
    assert doc["kernel"] == "matmul"
    assert {d: sorted(v) for d, v in doc["devices"].items()} == \
        {H100_SXM: ["simt", "wgmma"], H100_PCIE: ["simt"]}


def test_device_key_asks_each_card_once(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: calls.append(i) or f"card {i}")
    monkeypatch.setattr(tuning, "_DEVICE_NAMES", {})
    for _ in range(3):
        assert tuning.device_key(torch.device("cuda", 1)) == "card 1"
    assert tuning.device_key(torch.device("cpu")) == "cpu"
    assert calls == [1]


def test_validate_blocks_names_every_problem():
    legal = matmul_ops.TILES["wgmma"]
    with pytest.raises(ValueError) as exc:
        tuning.validate_blocks("matmul", "wgmma",
                               {"bm": 96, "bn": 128, "bk": 16}, legal)
    msg = str(exc.value)
    assert "bm=96" in msg and "(64, 128)" in msg
    assert "bk=16" in msg and "(64)" in msg
    assert "bn=128" not in msg
    assert "repro_torch tune" in msg        # remediation, not a traceback
    with pytest.raises(ValueError, match="shared memory"):
        tuning.validate_blocks("matmul", "wgmma",
                               {"bm": 128, "bn": 128, "bk": 64}, legal,
                               smem_bytes=140000, smem_limit=100000)
    tuning.validate_blocks("matmul", "wgmma",
                           {"bm": 128, "bn": 128, "bk": 64}, legal,
                           smem_bytes=140000, smem_limit=232448)
    with pytest.raises(ValueError, match="br=True"):
        tuning.validate_blocks("rmsnorm", "rows", {"br": True},
                               rmsnorm_ops.TILES["rows"])


# ---------------------------------------------------------------------------
# the wrappers' tiles on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,N,sms,want", [
    (512, 256, 132, 64),      # linalg's matmul_rect: 8 tiles, 16 blocks
    (1024, 1024, 132, 64),    # 64 tiles of 128 x 128: 128 x 64
    (1024, 2048, 132, 64), (1024, 2048, 114, 128),
    (1408, 1408, 132, 64), (1408, 1408, 114, 128),
    (4096, 4096, 132, 128), (1, 1, 1, 128)])
def test_wave_rule_follows_the_sm_count(M, N, sms, want):
    """simt's builtin bn: 128 x 128 where that grid fills one wave of
    the card's SMs, else 128 x 64 (an H100 SXM has 132, a PCIe 114)."""
    assert matmul_ops.tile(M, N, sms) == want


def _mm(M, K, N, dtype=torch.float32):
    return torch.ones(M, K, dtype=dtype), torch.ones(K, N, dtype=dtype)


@pytest.mark.parametrize("operands,variant,want", [
    (_mm(512, 256, 256), "simt", {"bm": 128, "bn": 64, "bk": 16}),
    (_mm(4096, 64, 4096), "simt", {"bm": 128, "bn": 128, "bk": 16}),
    (_mm(1024, 1024, 1024, torch.bfloat16), "wgmma",
     {"bm": 128, "bn": 128, "bk": 64}),
    (_mm(64, 24, 33, torch.bfloat16), "simt",
     {"bm": 128, "bn": 64, "bk": 16})])
def test_matmul_builtin_tile_is_todays(tuned_dir, operands, variant, want):
    x, y = operands
    assert matmul_ops.resolve_tile(x, y) == ("cpu", variant, want)
    assert matmul_ops.CPU_SMS == 132


def test_nn_builtin_tiles_are_todays(tuned_dir):
    q = torch.ones(1, 8, 4, 16)
    assert flash_ops.resolve_tile(q) == ("cpu", "ffma",
                                         {"bq": 64, "bk": 64})
    assert flash_ops.resolve_tile(q.bfloat16()) == (
        "cpu", "wgmma", flash_ops.WGMMA_TILE)
    assert rmsnorm_ops.resolve_tile(torch.ones(4, 8)) == ("cpu", {"br": 1})
    assert ssd_ops.resolve_chunk(q, 64) == ("cpu", "tiled_n64",
                                            {"chunk": 128})
    assert ssd_ops.resolve_chunk(q, 128)[1] == "tiled_n128"
    assert ssd_ops.resolve_chunk(q, 300)[1] == "tiled_n128"


def test_wrappers_record_the_tile_they_launch_with(tuned_dir):
    tuning.last_resolved.clear()
    x, y = _mm(33, 17, 9)
    matmul(x, y, bm=64)
    rmsnorm(torch.ones(3, 8), torch.ones(8), br=4)
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    flash_attention(q, kv, kv, bq=128, bk=32)
    assert tuning.last_resolved["matmul"] == (
        "cpu", "simt", {"bm": 64, "bn": 64, "bk": 16})
    assert tuning.last_resolved["rmsnorm"] == ("cpu", "rows", {"br": 4})
    assert tuning.last_resolved["flash_attention"] == (
        "cpu", "ffma", {"bq": 128, "bk": 32})


@pytest.mark.parametrize("call,match", [
    (lambda: matmul(*_mm(8, 4, 6), bm=96), "bm=96"),
    (lambda: matmul(*_mm(8, 4, 6), bk=64), "bk=64"),          # simt's is 16
    (lambda: matmul(*_mm(64, 64, 64, torch.bfloat16), bk=16), "bk=16"),
    (lambda: matmul(*_mm(8, 4, 6), bn=0), "bn=0"),
    (lambda: flash_attention(torch.ones(1, 8, 4, 16), torch.ones(1, 8, 2, 16),
                             torch.ones(1, 8, 2, 16), bq=32), "bq=32"),
    (lambda: flash_attention(torch.ones(1, 8, 4, 16), torch.ones(1, 8, 2, 16),
                             torch.ones(1, 8, 2, 16), bk=128), "bk=128"),
    (lambda: flash_attention(*(torch.ones(1, 8, 2, 16, dtype=torch.bfloat16),)
                             * 3, bq=64), "fixed"),
    (lambda: rmsnorm(torch.ones(4, 8), torch.ones(8), br=3), "br=3"),
    (lambda: rmsnorm(torch.ones(4, 8), torch.ones(8), br=16), "br=16")])
def test_bad_explicit_tile_raises_on_cpu(tuned_dir, call, match):
    """The same readable ValueError as on the card, before any launch."""
    with pytest.raises(ValueError, match=match):
        call()


def test_bad_tuned_tile_raises_and_explicit_chunk_keeps_its_contract(
        tuned_dir, monkeypatch):
    """A tile from the env (or an artifact) outside the set raises; the
    SSD chunk is part of the function, so an explicit one keeps the
    plain version's contract (any chunk)."""
    monkeypatch.setenv("REPRO_TUNED_RMSNORM_BR", "3")
    tuning.invalidate_cache()
    with pytest.raises(ValueError, match="br=3"):
        rmsnorm(torch.ones(4, 8), torch.ones(8))
    rng = torch.Generator().manual_seed(0)
    b, l, h, p, n = 1, 64, 2, 8, 16
    x = torch.randn(b, l, h, p, generator=rng)
    dt = torch.rand(b, l, h, generator=rng)
    A = -torch.rand(h, generator=rng)
    B0, C0 = (torch.randn(b, l, n, generator=rng) for _ in range(2))
    monkeypatch.setenv("REPRO_TUNED_SSD_SCAN_CHUNK", "16")
    tuning.invalidate_cache()
    with pytest.raises(ValueError, match="chunk=16"):
        ssd_chunk(x, dt, A, B0, C0)
    got = ssd_chunk(x, dt, A, B0, C0, chunk=16)
    for g, w in zip(got, ssd_chunk_ref(x, dt, A, B0, C0, chunk=16)):
        assert torch.equal(g, w)
    monkeypatch.setenv("REPRO_TUNED_SSD_SCAN_CHUNK", "32")
    tuning.invalidate_cache()
    got = ssd_chunk(x, dt, A, B0, C0)
    assert got[1].shape[1] == l // 32
    for g, w in zip(got, ssd_chunk_ref(x, dt, A, B0, C0, chunk=32)):
        assert torch.equal(g, w)


def test_an_override_reaches_the_next_call(tuned_dir):
    """Knobs are resolved on every call, never once a process: a tune
    trial's override takes effect at the next call and ends with it."""
    x = torch.ones(4, 8)
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 1}
    with tuning.override("rmsnorm", {"br": 4}, variant="rows"):
        assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 4}
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 1}
    tuning.write_tuned("rmsnorm", {"config": {"br": 8}}, device="cpu",
                       variant="rows")
    assert rmsnorm_ops.resolve_tile(x)[1] == {"br": 8}


@pytest.mark.parametrize("tile", [{"bm": 64}, {"bn": 128}, {"bm": 64,
                                                            "bn": 64}])
def test_the_plain_version_ignores_the_tile(tuned_dir, tile):
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(65, 33, generator=g), torch.randn(33, 17, generator=g)
    assert torch.equal(matmul(x, y, **tile), matmul_ref(x, y))
    s = torch.randn(33, generator=g)
    assert torch.equal(rmsnorm(x, s, br=8), rmsnorm_ref(x, s))


def test_tile_sets_mirror_the_sources():
    """Each ops.py set names the cases of its C entry's switch."""
    import re
    from repro_torch.kernels import _build
    mm = _build.source("matmul").read_text()
    for bm in matmul_ops.TILES["wgmma"]["bm"]:
        for bn in matmul_ops.TILES["wgmma"]["bn"]:
            assert f"launch_wgmma_tile<{bm}, {bn}>" in mm
            assert f"launch_simt_tile<T, {bm}, {bn}>" in mm
    assert "constexpr int W_BK = 64;" in mm and "constexpr int S_BK = 16;" \
        in mm
    fa = _build.source("flash_attention").read_text()
    for bq in flash_ops.TILES["ffma"]["bq"]:
        for bk in flash_ops.TILES["ffma"]["bk"]:
            assert f"launch_ffma<D, {bq}, {bk}>" in fa
    rn = _build.source("rmsnorm").read_text()
    assert sorted(int(b) for b in re.findall(
        r"launch_rows<T, (\d+)>", rn)) == \
        sorted(rmsnorm_ops.TILES["rows"]["br"])
    assert max(ssd_ops.TILES["tiled_n64"]["chunk"]) == ssd_ops.MAX_CHUNK
