"""The paper's benchmark harness on the torch port
(``python -m repro_torch.benchmarks.run``)."""
