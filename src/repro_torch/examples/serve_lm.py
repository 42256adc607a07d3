"""Serve a small LM with batched requests through the continuous-batching
engine: submit a mixed-length workload, report TTFT/latency/throughput.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.examples import parse_args
from repro_torch.models import build, get_config
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None):
    device = parse_args(argparse.ArgumentParser(), argv).device
    cfg = get_config("llama3.2-1b").reduced().override(num_layers=4)
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(api, params, ServeConfig(
        max_batch=4, max_len=256, prompt_buckets=(16, 32, 64)))

    rng = np.random.default_rng(0)
    for _ in range(12):
        plen = int(rng.integers(4, 48))
        engine.submit(rng.integers(1, cfg.vocab_size, size=plen),
                      max_tokens=24)
    done = engine.run()
    stats = ServeEngine.summarize(done)
    print("served:", stats)
    sample = done[0]
    print(f"request {sample.uid}: prompt[{len(sample.prompt)}] -> "
          f"{sample.output[:12]}...")


if __name__ == "__main__":
    main()
