"""The models' sharded forms against the plain forward, on four ranks.

Under bound logical rules the layers run their sharded forms on each
rank's shards (``repro_torch.distributed.logical.local``): the
vocabulary-parallel embedding and cross-entropy (``embed``,
``_VocabParallelNLL``, its forward and backward), the attention on a
rank's q heads and the GQA kv heads they read (``heads_local``), the
row-parallel output projection (``out_proj``), the decode attention's
flash-decoding combine over a position-split cache
(``_decode_attention_sharded``) and the cache writes
(``_write_at_sharded``).  Each test spawns four processes joined in a
gloo group (a ``FileStore`` under ``tmp_path``), lays a reduced llama's
float32 weights, batch and cache out by the dry-run's specs
(``param_specs``, ``input_specs_tree``, ``cache_specs``) on a (1, 4) or
(2, 2) mesh, and holds the loss, every gradient, the prefill and two
decode steps (logits and caches) to the plain forward on the same
inputs within 1e-5.

On (1, 4) the 2 kv heads do not divide the 4-wide 'model' axis: each
rank's one q head reads one of the kv heads, and the cache is split by
position, 16 positions a rank; the two decode steps write positions 15
and 16, the last of rank 0's and the first of rank 1's.  On (2, 2) the
batch is split over 'data' and the cache by kv heads.
"""
import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed import logical, partition as part
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build, get_config, tree

WORLD = 4
TOL = 1e-5
PROMPT, MAX_LEN = 15, 64


def _place(mesh, tensors, specs):
    """Real tensors → DTensors laid out by a matching tree of specs
    (every rank holds the same full tensors)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tensors, dict):
        return {k: _place(mesh, v, specs[k]) for k, v in tensors.items()}
    return distribute_tensor(tensors, mesh, part.placements(specs, mesh))


def _close(what, got, want):
    err = (got.full_tensor() - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    assert err <= TOL * scale, f"{what}: max abs error {err:.3g}"


def _worker(rank, store_path, mesh_shape, loss_chunk):
    torch.set_num_threads(1)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        cfg = get_config("llama3.2-1b").reduced().override(
            dtype="float32", logits_dtype="float32", loss_chunk=loss_chunk,
            attn_chunk_q=16, attn_chunk_k=16)
        api = build(cfg)
        params = api.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                         generator=gen, dtype=torch.int32)}
        prompt = {"tokens": batch["tokens"][:, :PROMPT]}
        steps = [torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                               dtype=torch.int32) for _ in range(2)]

        # the plain forward
        leaves = [p.detach().requires_grad_() for p in tree.flatten(params)]
        loss, _ = api.loss(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            cache = api.init_cache(4, MAX_LEN, dtype=torch.float32)
            logits, cache = api.prefill(params, prompt, cache)
            prefilled = {k: cache[k].clone() for k in ("k", "v")}
            decoded = []
            for tok in steps:
                out, cache = api.decode_step(params, tok, cache)
                decoded.append(out)

        with make_host_mesh(mesh_shape[1]) as mesh:
            assert tuple(mesh.shape) == mesh_shape
            rules = logical.default_rules(cfg, mesh)
            dparams = _place(mesh, params,
                             part.param_specs(cfg, params, mesh))

            def dbatch(b):
                return _place(mesh, b, part.input_specs_tree(cfg, b, mesh))
            dcache = api.init_cache(4, MAX_LEN, dtype=torch.float32)
            dcache = _place(mesh, dcache, part.cache_specs(cfg, dcache,
                                                           mesh))
            if mesh_shape == (1, 4):     # the position-split cache
                assert dcache["k"].placements[1].is_shard(2)

            dleaves = [p.detach().requires_grad_()
                       for p in tree.flatten(dparams)]
            with logical.logical_rules(rules):
                dloss, _ = api.loss(tree.unflatten(dparams, dleaves),
                                    dbatch(batch))
                dgrads = torch.autograd.grad(dloss, dleaves)
            _close("loss", dloss, loss)
            names = tree.flatten(part.map_with_path(
                lambda path, _: part._path_str(path), params))
            for name, g, dg in zip(names, grads, dgrads):
                _close(f"gradient {name}", dg, g)

            with torch.no_grad(), logical.logical_rules(rules):
                dlogits, dcache = api.prefill(dparams, dbatch(prompt),
                                              dcache)
                _close("prefill logits", dlogits, logits)
                for k in ("k", "v"):
                    _close(f"prefilled cache {k}", dcache[k], prefilled[k])
                for i, tok in enumerate(steps):
                    out, dcache = api.decode_step(
                        dparams, dbatch({"tokens": tok})["tokens"], dcache)
                    _close(f"decode step {i} logits", out, decoded[i])
            for k in ("k", "v"):
                _close(f"cache {k}", dcache[k], cache[k])
            pos = dcache["pos"]
            pos = pos.full_tensor() if logical.is_dtensor(pos) else pos
            assert int(pos) == int(cache["pos"]) == PROMPT + len(steps)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape,loss_chunk", [((1, 4), 16),
                                                    ((2, 2), 0)])
def test_sharded_forms_equal_the_plain_forward(tmp_path, mesh_shape,
                                               loss_chunk):
    mp.spawn(_worker, args=(str(tmp_path / "store"), mesh_shape, loss_chunk),
             nprocs=WORLD, join=True)
