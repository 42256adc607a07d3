"""``repro_torch.launch.serve`` against the reference's
``repro.launch.serve``: ``serve_demo`` on the CPU returns the same
stats keys, every request finishes with its tokens, and ``main`` takes
``--device`` (exit 2 without a card unless told ``cpu``)."""
import pytest
import torch

from repro.launch.serve import serve_demo as ref_serve_demo
from repro_torch.launch import serve


def test_serve_demo_stats_match_the_reference_s():
    ours = serve.serve_demo("llama3.2-1b", n_requests=6, max_tokens=5,
                            max_batch=4, device="cpu")
    want = ref_serve_demo("llama3.2-1b", n_requests=6, max_tokens=5,
                          max_batch=4)
    assert set(ours) == set(want)
    assert ours["requests"] == want["requests"] == 6
    assert ours["tokens"] == want["tokens"] == 6 * 5
    assert ours["ttft_mean_s"] > 0 and ours["latency_mean_s"] > 0
    assert ours["throughput_tok_s"] > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_serve_demo_serves_other_decoder_families(arch):
    stats = serve.serve_demo(arch, n_requests=3, max_tokens=3, max_batch=2,
                             device="cpu")
    assert stats["requests"] == 3 and stats["tokens"] == 9


def test_main_takes_device(monkeypatch, caplog):
    assert serve.main(["--requests", "2", "--max-tokens", "2",
                       "--device", "cpu"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main(["--requests", "2"]) == 2
