"""The torch port's synthetic-LM pipeline (``repro_torch.data``) against
the JAX package's: the same config and step give the reference's
arrays, bit for bit."""
import numpy as np
import pytest

from repro.data import DataConfig as RefConfig
from repro.data import SyntheticLM as RefLM
from repro.data import make_pipeline as ref_pipeline
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline

STEPS = (0, 1, 5, 17)


def _cfgs(seed, **kw):
    base = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=seed)
    base.update(kw)
    return DataConfig(**base), RefConfig(**base)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_batches_equal_reference(seed):
    port_cfg, ref_cfg = _cfgs(seed)
    port, ref = SyntheticLM(port_cfg), RefLM(ref_cfg)
    for step in STEPS:
        _equal(port.batch(step), ref.batch(step))


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_host_shards_equal_reference(seed):
    for host in (0, 1):
        port_cfg, ref_cfg = _cfgs(seed, host_count=2, host_index=host,
                                  seq_len=33, mean_doc_len=16)
        for step in STEPS:
            _equal(SyntheticLM(port_cfg).batch(step),
                   RefLM(ref_cfg).batch(step))


@pytest.mark.parametrize("prefetch", [False, True])
def test_pipeline_equals_reference(prefetch):
    port_cfg, ref_cfg = _cfgs(3)
    port = make_pipeline(port_cfg, start_step=2, prefetch=prefetch)
    ref = ref_pipeline(ref_cfg, start_step=2, prefetch=prefetch)
    try:
        for _ in range(3):
            (pstep, pbatch), (rstep, rbatch) = next(port), next(ref)
            assert pstep == rstep
            _equal(pbatch, rbatch)
    finally:
        for pipe in (port, ref):
            if prefetch:
                pipe.close()
