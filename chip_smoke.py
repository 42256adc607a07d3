#!/usr/bin/env python3
"""Smoke test of the torch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, traceback, no
``ok`` line) when it fails:

  1. device — CUDA must be available; prints the card's name and power
     limit as ``nvidia-smi`` reports them;
  2. build — compiles every hand-written kernel from ``csrc/`` with
     ``nvcc`` (one process per source, all started together) into
     ``build/`` and prints the build seconds and ``ptxas`` resources;
     then counts the tensor-core instructions (``HGMMA``, ``HMMA``) in
     each library's ``cuobjdump -sass`` and fails if matmul or flash
     attention has no HGMMA (their bf16 ``wgmma`` variants); flash's
     HMMA count is logged (its float32 body runs on the CUDA cores);
  3. matmul kernel against its plain version on the card, f32 and bf16,
     with the reference's tolerances, plus times and the variant and tile
     each shape took (``wgmma`` or ``simt``; the tile the tuning
     registry resolves, the builtin one when nothing is tuned).  bf16 is
     also held to within ``BF16_MAX_ULPS`` of the float32 product
     rounded once to bf16, which a kernel that accumulates in bf16
     fails.  Then every instantiated tile of each variant once, at
     ``MATMUL_TILE_SHAPES``, with the same tolerances (phases 5–7 do the
     same for their knobs: flash attention's ``ffma`` tiles, RMSNorm's
     rows a block, the SSD chunks a tune may choose);
  4. histogram kernel against its plain version, exact, plus times, at
     the histo scope's shapes, a ragged and a large n, values out of
     range, every value in one bin and a view one element into its
     storage; each shape's cluster size and grid, and the global merges
     that a model of the kernel's partition gives (logged only);
  5. flash-attention kernel against its plain version (``naive_attention``)
     at the nn scope's shapes, ragged ones (f32 full, bf16 causal), f32
     at head size 128 and 4096 tokens, and the attention of llama3.2-1b
     and internlm2-1.8b at 4096 tokens in bf16, with the reference's
     tolerances, plus times (``torch.nn.functional.
     scaled_dot_product_attention`` is the library yardstick).  Each
     float32 shape is also held to 2e-5 with inputs x4 (scores of tens),
     and carries the 3xTF32 tensor-core bound beside its CUDA-core one;
 5b. the models' attention on the card (``phase_flash_train``): the bf16
     forward with its log-sum-exp and its backward (delta, dK/dV, dQ
     kernels) at internlm2-1.8b's and granite-4.0-h-small's train
     layers, held to the plain scans within ``flash_ref.TOL`` (each
     output's gap row by row, lse's absolute gap; each side's backward
     on its own forward's out and lse), a rerun bit for bit, launch
     counts, call and device ms beside the bound of the function's five
     products and of the design's seven, the scans' ms and SDPA's
     forward and backward as the yardstick; the
     build phase also fails where the forward's or the backward's
     product kernels hold no HGMMA (``HGMMA_FUNCTIONS``);
  6. rmsnorm kernel against its plain version at the nn scope's shapes, a
     ragged one and llama3.2-1b's width (and 8192) in bf16, plus times
     (``torch.nn.functional.rms_norm`` is the yardstick);
  7. SSD chunk kernel against its plain version, and ``ssd`` (kernel plus
     the inter-chunk recurrence in torch) against the sequential
     ``ssd_reference`` for ``y`` and the final state, at the nn scope's
     shapes, a ragged one, mamba2-780m's SSD layer, its widths at batch 8
     (several heads a block), 5 heads (a ragged head group) and dt x8
     (in-chunk cumsums of hundreds; there ``ssd`` is held to the plain
     chunked ``ssd_chunked``, and its distance from the sequential
     recurrence, which both chunked forms miss, is logged); each shape's variant and
     heads a block are logged, and the whole ``ssd`` call is split into
     the kernel and its torch remainder.  No single torch call computes
     it, so its library time is null;
 7b. decode-attention kernel against its plain version (its
     split-and-combine algorithm, ``ref.py``) at ``DECODE_SHAPES``: the
     chat cell's pool (64 slots x 2,560, internlm2-1.8b's heads, bf16)
     with lengths drawn from the chat mix and full, other head groups
     and sizes, float16 and float32, lengths from 0 to past the cache;
     at the chat pool also a scalar length and a cache cut in two whose
     partials merge to the whole; two launches a call, and the positions
     each call reports it read are each row's live splits.  The kernel's
     tolerance is ``ref.TOL`` (atol, rtol); each row logs its largest
     error beside its outputs' typical size.  Times beside
     the bound (the live k and v once), the port's plain form
     (``layers._decode_attention_plain``) and masked SDPA, which the port
     never calls;
  8. models: llama3.2-1b and mamba2-780m at their published widths and
     depths through the port's model API (``repro_torch.models.build``;
     weights from its ``init``, seeded), a batch of 2 x 4096 random
     tokens in bfloat16 under ``torch.inference_mode()``: the loss, the
     median ms of ``MODEL_STEPS`` steps after a warm one (each fenced
     with ``torch.cuda.synchronize``), tokens/s, the forward's model
     FLOPs (2·params·tokens plus causal attention), ``mfu`` against the
     card's bf16 peak (port ``core/sysinfo.py``) and
     ``max_memory_allocated``.  The bf16 loss must be finite and within
     ``MODEL_BF16_TOL`` of the float32 loss of the same weights (the bf16
     loss with cuBLAS's reduced-precision reduction off is logged), and
     a float32 run at B 1 x S 256 must match the port's CPU run on the
     same weights (loss ``MODEL_CPU_LOSS_TOL``, logits
     ``MODEL_CPU_LOGITS_TOL``).  No hand-written kernel lies on this
     path: the models use the plain formulations, as the reference's do;
  9. host path: each step of a histogram and a float32 flash wrapper
     call (argument checks, custom_op dispatch, output allocation, device
     and stream lookup, library lookup, the ctypes call, ``_build.check``,
     and for flash the tile's resolution through the tuning registry,
     ``tuning_resolve``) timed alone over ``HOST_CALLS`` calls on the
     host clock;
 10. the main path: ``repro_torch.core.main.main(["run", ...])`` over
     all ten scopes of the port (example, mxu, comm, nn, instr, histo,
     linalg, io, model, serve; one process, nothing persisted:
     ``--results-dir ''``),
     with the kernels' launch counts set to 0 just before and read just
     after.  Every scope must load and be enabled, every instance must
     have a record without error and with ``compile_time_s``, all six
     kernels must have launched (decode attention in the serve scope's
     engine),
     the mxu scope's bf16 ``cuda`` rows must have gone through matmul's
     ``wgmma`` variant, the nn scope's float32 flash rows through flash
     attention's ``ffma`` variant and its ``ssd_scan_cuda`` rows
     through the SSD kernel's ``tiled_n64``, and the linalg scope (whose
     only kernel row is ``matmul_rect``) must have raised matmul's
     ``simt`` count while it ran (read at the orchestrator's per-scope
     log line); ``comm/all_reduce_measured`` must report ``devices`` 1
     on an NCCL process group (the backend is logged), the 24
     ``collective_modeled_v5e`` rows must equal the reference's analytic
     model, computed here from its formula, and the instr scope's
     ``gelu`` op is held once to the tanh formula on the card; the
     model scope's five ``loss_step_reduced`` rows must have records, and
     ``dryrun_rooflines`` may skip only with the reference's message,
     when ``results/dryrun/`` holds no cell; the serve scope's six
     ``under_load`` rows replay their open-loop traces through the
     engine on the card;
 11. the same main path again in a child process under
     ``torch.profiler``: the device's idle share over its activity
     window;
 12. the run pipeline, through ``python -m repro_torch`` in child
     processes over the linalg and mxu scopes at
     ``--benchmark_min_time 0.02``: ``plan`` lists the instances
     ``--benchmark_list_tests`` lists; a ``--jobs 2 --shard-grain
     benchmark --isolate pool`` run writes a ``merged.json`` with the
     inline run's record names in order, no error, a context naming the
     card with ``run_id`` and ``shards``, and one history line an
     instance; after one instance shard is deleted, ``--resume`` re-runs
     exactly that instance; ``compare`` of the inline document and
     ``merged.json`` exits 0 or 1 and pairs every row; ``--meters
     costmodel`` over linalg and mxu gives every matmul row (both
     backends, both dtypes, batched and rectangular) ``flops`` =
     2·m·n·k exactly and ``bytes_accessed`` > 0.  One ``{"pipeline":
     ...}`` line holds these facts and the inline and ``--jobs 2``
     walls;
 13. the tune phase: ``python -m repro_torch tune <family> --budget 8
     --benchmark_min_time 0.02 --no-report`` in a child process for each
     of ``TUNE_FAMILIES`` (mxu's matmul with ``--param n=1024``, and
     flash attention's ``ffma`` tiles; phase 18 tunes RMSNorm), with
     ``REPRO_TUNED_DIR`` under ``build/`` so that no ``tuned.json`` lands
     in the source tree (checked); each must exit 0 with no failed trial
     and write its winner under the card's name and the variant it ran.
     One line a family: the instance, the builtin tile and its
     ``real_time``, the winner and its ``real_time``, the speedup and the
     trials used; then one ``{"tune": [...]}`` line;
 14. the incremental loop, through ``python -m repro_torch`` in child
     processes over the example and mxu scopes, with ``REPRO_TUNED_DIR``
     under ``build/``: a run writes history records that each carry a
     ``fingerprint`` and a context with ``fingerprints``; a ``--since``
     run plans 0 instances and its merged document replays every record
     as ``cached``; after a ``matmul`` artifact for this card is written
     through the tuning API, a ``--since`` run re-measures exactly the
     instances of the families tunable on matmul; ``ci --no-report``
     exits 0; ``store index`` builds ``history.db``; ``query --scope
     mxu`` lists the mxu records; ``store status --coverage`` counts
     every instance of the two scopes fresh.  One ``{"incremental":
     ...}`` line holds the counts, the exit codes and the run walls;
 15. serve: llama3.2-1b at its published width and depth through the
     port's engine (``repro_torch.serve.ServeEngine``; weights from its
     ``init``, seeded), bf16 with a bf16 cache of 8 slots x 4096
     positions (1 GiB), prompt buckets 128, 512 and 2048.  Checks, each
     failing the script: (a) in float32 with a float32 cache (512
     positions, 2 slots) three requests of mixed length x 16 tokens give
     the same greedy tokens through the engine as each alone through
     prefill and uniform ``decode_step``; (b) the float32 prefill and
     first decode step match the float32 teacher-forced logits within
     ``MODEL_CPU_LOGITS_TOL``; (c) logged only: the bf16 engine path's
     first decode logits against the bf16 teacher-forced ones, beside
     the reference test's atol 5e-2, rtol 1e-2.  Then prefill ms per
     bucket; 32 open-loop Poisson arrivals at 4/s (the port's
     ``arrivals``, seed 0), prompts of 64–2000 tokens, 128 tokens each:
     TTFT and latency p50/p99, output tokens/s, queue depth; a closed
     batch of 8 requests submitted at once: the decode step's median ms
     with every slot live against its bound (bf16 weight bytes plus one
     full cache read over the card's memory rate), one profiled step's
     idle share and top aten ops, the cache's bytes and
     ``max_memory_allocated``.  Its decode attention runs the
     decode-attention kernel (phase 7b; the reference's serving path
     calls no Pallas kernel);
 16. the serve scope in a child process: ``python -m repro_torch run
     --enable-scope serve --meters wall,cpu,latency --slo-ms 200``; every
     record must carry ``latency_p99_s``, ``ttft_p99_s``,
     ``queue_depth_mean`` and ``slo_attainment``;
 17. train: llama3.2-1b at its published width and depth through the
     port's one-card trainer (``repro_torch.launch.train.train``,
     weights from its ``init``, seed 0), ``TRAIN_STEPS`` steps of B2 x
     S4096 tokens from the port's data pipeline, bf16 compute over
     float32 parameters, gradients and AdamW moments, the reference's
     training policy (remat ``full``, loss chunk 1024), lr 3e-4: the
     step's median ms from the third step, tokens/s, ``mfu`` (three
     forwards' model FLOPs: remat's recompute is not counted),
     ``max_memory_allocated``, each step's loss, grad_norm and lr, and
     one profiled step's idle share and top aten ops.  Checks, each
     failing the script: (a) every loss and grad_norm finite, and the
     first step's loss within ``TRAIN_FIRST_LOSS_TOL`` of ``api.loss``
     under inference_mode on the same weights and batch; at reduced
     size, (b) three float32 train steps on the card against the CPU
     from one state (llama3.2-1b with 2 layers, mamba2-780m,
     deepseek-moe-16b; loss ``TRAIN_CPU_LOSS_TOL``, grad_norm relative
     ``TRAIN_CPU_NORM_RTOL``), (c) gradients under remat none, full
     and dots within ``TRAIN_REMAT_TOL``, (d) a run halted at step 7
     of 14 and resumed through the checkpoint manager ends within
     ``TRAIN_RESUME_TOL`` of the uninterrupted run, (e) bf16 steps'
     loss within ``TRAIN_BF16_TOL`` of float32's.  No hand-written
     kernel lies on this path (the reference's train step calls no
     Pallas kernel);
 18. report: two runs, ``a`` then ``b``, of the ``REPORT_SCOPES``
     (mxu, serve) in one results directory under a temporary
     directory (``run --meters wall,cpu,latency --slo-ms 200``), then the
     port's ScopePlot over them, every CLI step in a child that cannot
     import matplotlib or yaml (``sys.modules[name] = None``): ``report
     b`` writes ``report.md`` and ``index.html``; every image it names
     exists, parses as XML and holds a mark per series of its spec;
     mxu and serve each have times, trend and speedup plots and
     serve its latency CDF; the System table shows the card's
     ``device_kind`` and ``cuda_version``; the verdict table lists every
     instance of ``b``.  ``report history`` renders; ``python -m
     repro_torch.scopeplot batch`` finds every spec fresh and, after
     ``b/merged.json`` is touched, renders exactly the specs that read
     it; ``ci`` without ``--no-report`` exits as with it and leaves its
     run's report; ``REPORT_TUNE`` tuned once with its report leaves
     ``tune_speedup.svg``; the dashboard (``create_server`` on port 0 in
     a thread) answers 200 to ``/``, ``/api/runs`` and ``/api/status``.
     No kernel is launched by the report itself: the mxu rows it
     reports ran the matmul kernel;
 19. lint: ``python -m repro_torch lint --strict --format json --device
     cuda`` over the ten scopes in a child must exit 0 with no error or
     warning, its only findings the SCOPE203 infos of the two families
     whose fixtures do not follow ``(callable, *operands)``; every
     family's first fixture is then built on the card and traced by the
     trace tier in this process, with the kernels' launch counts held at
     0 (the trace runs on fake tensors), counting the ``repro_torch``
     kernel nodes; ``run --lint --strict`` over ``LINT_RUN_SCOPES`` (mxu,
     histo, nn, linalg) in this process, with the counts set to 0 just
     before and read just after, must exit 0 with every record free of
     error and the five scope kernels launched; a planted scope whose one
     family traces to no compute on its operand (SCOPE201) makes ``run
     --lint`` exit 1 and write nothing; ``serve_demo`` of llama3.2-1b
     at its published width and depth (``reduced=False``) must finish
     its 16 requests of 16 tokens; then, side by side in children, the
     paper's harness (``python -m repro_torch.benchmarks.run``) over the
     ten scopes must exit 0 with no failed scope and the Fig. 3 SVG,
     and each of the four examples (``python -m
     repro_torch.examples.<name> --device cuda``, their defaults but
     train_lm's 300 steps, cut to 30) must exit 0.  One
     ``{"lint": ...}`` line holds each step's exit code and wall, the
     findings by severity, the families traced and kernel nodes seen,
     the launches, the harness's lines and ``serve_demo``'s stats;
 20. dry-run: ``python -m repro_torch.launch.dryrun --arch llama3.2-1b
     --shape all --device cuda`` into a temporary directory, once on the
     16×16 mesh and once with ``--multi-pod`` on 2×16×16 (two children
     at once; each traces every cell for one rank over a fake group of
     256 or 512 ranks, on fake tensors: nothing launches): both exit 0,
     train_4k, prefill_32k and decode_32k are ``ok`` on both meshes and
     long_500k is the reference's skip; per cell its trace seconds,
     per-rank FLOPs, HBM bytes, collective bytes by kind, the three
     terms in H100 terms, the dominant one and the static peak.  (b)
     in a third child at the same time, one card: a cell on
     ``make_host_mesh(1)`` at phase 17's shape (B2 x S4096, the
     train_4k policy) through the dry-run's Python API, its FLOPs held
     to ``FlopCounterMode`` over one real step on the card within
     ``DRYRUN_FLOP_RTOL``; its static peak and bound are printed beside
     phase 17's ``max_memory_allocated`` and measured step.  (c) ``python
     -m repro_torch run --enable-scope model --model.dryrun_dir <dir>``:
     ``dryrun_rooflines`` is a record with ``cells`` ≥ 6 (phase 10 ran
     before any cell existed and checked the skip).  (d) ``python -m
     repro_torch.roofline.report --dir <dir>`` exits 0 and prints the
     roofline table.  The three children start before phase 18 and run
     beside phases 18 and 19 (the traces use the CPU alone).  One
     ``{"dryrun": ...}`` line;
 21. multi-rank runtime on one card: (a) the gradient codecs (bf16,
     and int8 with error feedback) over llama3.2-1b's full-width
     parameter tree as a gradient's stand-in on the card, their bytes
     and ms, the embedding and layer 0's ``w_up`` bit-equal to the CPU
     codec; then, in a child with a launcher's environment for one rank
     (``WORLD_SIZE`` 1, as ``torchrun --standalone --nproc-per-node 1``
     sets it), which joins a one-rank NCCL group
     (``launch.mesh.launcher_group``): (b) deepseek-moe-16b at its
     published width, ``num_layers`` cut to ``MOE_LAYERS``: the
     expert-parallel ``moe_layer`` on the (1, 1) mesh within
     ``MOE_TOL`` of ``moe_scatter`` in float32 at ``MOE_CHECK``, both
     timed in bf16 at ``MOE_TIME``, and one meshed train step whose
     loss is within ``TRAIN_FIRST_LOSS_TOL`` of ``api.loss`` on its
     weights and batch; (c) phase 17's run on the meshed trainer
     (DTensor state), ``MULTIRANK_STEPS`` steps with a sharded save at
     the last: the first loss within ``TRAIN_FIRST_LOSS_TOL`` of phase
     17's, every loss and grad_norm finite, the checkpoint read back by
     ``load_checkpoint`` with every crc verified; the step's median ms,
     ``max_memory_allocated`` and one profiled step beside phase 17's;
     (d) phase 17's resume check (halted at step 7 of 14, resumed
     through ``restore_resharded``) within ``TRAIN_RESUME_TOL``.  One
     ``{"multirank": ...}`` line;
 22. a ``{"host_path_us": ..., "main_path_idle": ...}`` line, a
     ``{"models": [...]}`` line (phase 8's rows), a ``{"serve": ...}``
     line (phases 15 and 16), a ``{"train": ...}`` line (phase 17), a
     ``{"report": ...}`` line (phase 18: each step's wall, the plots
     and SVG bytes written, whether the host can import matplotlib and
     yaml), the ``{"lint": ...}`` line (phase 19), the ``{"dryrun":
     ...}`` line (phase 20), the ``{"multirank": ...}`` line (phase
     21), then one
     ``{"kernels": [...]}`` line: per kernel its launches on the main
     path (with each variant's, for matmul, flash attention and SSD), its
     largest error against the plain version, and its time,
     the plain version's, the library call's and the card's bound, at
     the main path's largest shape (every shape under ``shapes``, every
     instantiated tile under ``tiles``).
     ``ms`` is the time per call of back-to-back calls through the
     wrapper (CUDA events), ``device_ms`` the kernels alone (profiler);
 23. last line: ``{"ok": true, "device": {...}}``.

Every comparison holds the kernel to its plain version on the same
inputs with ``atol = rtol = tol``, ``tol`` being the reference's own
(tests/test_kernels.py): a relative term is needed where a bf16 output
of magnitude above 4 rounds one ulp (over 2e-2) away when the float32
sums differ in their last bit.
"""
import contextlib
import glob
import itertools
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.sysinfo import target_hardware  # noqa: E402
from repro_torch.kernels import _build, tuning  # noqa: E402
from repro_torch.kernels.histogram import histogram, histogram_ref  # noqa: E402
from repro_torch.kernels.histogram import ops as histogram_ops  # noqa: E402
from repro_torch.kernels.matmul import (bf16_ulp_error, matmul,  # noqa: E402
                                        matmul_ref)
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk,  # noqa: E402
                                          ssd_chunk_ref, ssd_chunked,
                                          ssd_reference)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_partials, decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as decode_ref  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402

#: The reference's tolerances (tests/test_kernels.py): atol = rtol.
MATMUL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-1}
#: bf16 output against the float32 product rounded once to bf16, in ulps
#: (see ``bf16_ulp_error``): summation order moves a value by at most one.
BF16_MAX_ULPS = 2.0
#: (M, K, N) per dtype: the mxu scope's sizes, the linalg scope's
#: ``matmul_rect`` (f32 512×256×256), a ragged shape each way (bf16:
#: ``simt``, as N or K is odd), a ragged bf16 shape that TMA can load
#: (``wgmma`` with ragged M and N tiles), llama3.2-1b's MLP
#: up-projection at 4096 tokens, and one large square bf16 product.
MATMUL_SHAPES = (
    [(torch.float32, s) for s in ((256, 256, 256), (512, 512, 512),
                                  (1024, 1024, 1024), (512, 256, 256),
                                  (1000, 1536, 777), (1000, 777, 1536))]
    + [(torch.bfloat16, s) for s in ((256, 256, 256), (512, 512, 512),
                                     (1024, 1024, 1024), (1000, 1536, 777),
                                     (1000, 777, 1536), (1000, 1536, 776),
                                     (4096, 2048, 8192), (4096, 4096, 4096))])
#: (n, bins, case): the histo scope's grid, a ragged n and a large n of
#: uniform values; values outside [0, bins); every value in one bin (the
#: shared atomics' worst contention); and a view one element into its
#: storage (a scalar head before the 16-byte loads).
HISTOGRAM_SHAPES = [(n, b, "uniform") for n in (1 << 16, 1 << 20,
                                                (1 << 20) + 3, 1 << 28)
                    for b in (256, 4096)] + [
    ((1 << 20) + 3, 4096, "out_of_range"), (1 << 20, 4096, "one_hot_bin"),
    (1 << 20, 4096, "misaligned")]
#: Where each matmul variant's every instantiated tile is held once: bf16
#: with K = 4096 (each tile's per-stage float32 fold) for ``wgmma``, and a
#: ragged float32 shape for ``simt``.
MATMUL_TILE_SHAPES = {"wgmma": (torch.bfloat16, (256, 4096, 256)),
                      "simt": (torch.float32, (1000, 1536, 777))}
#: The main path's largest shape of each kernel: the one the kernels line
#: reports at its top level.
MATMUL_HEADLINE = (torch.bfloat16, (1024, 1024, 1024))
HISTOGRAM_HEADLINE = (1 << 20, 4096, "uniform")

#: The reference's tolerances for the nn kernels (tests/test_kernels.py).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}
RMSNORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = 3e-5
#: (dtype, B, S, H, K, D, causal): the nn scope's flash_attention_cuda
#: rows, a ragged length without the causal mask, float32 at head size
#: 128 and 4096 tokens, the same causal in bf16 at llama3.2-1b's heads
#: (TMA fills the sequence's edge with zeros), llama3.2-1b (32 heads, 8
#: kv heads, head size 64) and internlm2-1.8b (16, 8, 128) at 4096.
FLASH_SHAPES = (
    [(torch.float32, 2, S, 4, 2, 64, True) for S in (256, 512, 1024)]
    + [(torch.float32, 2, 1000, 4, 2, 64, False),
       (torch.float32, 1, 4096, 4, 2, 128, True),
       (torch.bfloat16, 1, 1000, 32, 8, 64, True),
       (torch.bfloat16, 1, 4096, 32, 8, 64, True),
       (torch.bfloat16, 1, 4096, 16, 8, 128, True)])
FLASH_HEADLINE = FLASH_SHAPES[2]
#: Where every ``ffma`` tile is held once: the nn scope's largest shape
#: (also with inputs x4) and head size 128 at 4096 tokens.
FLASH_TILE_SHAPES = [FLASH_HEADLINE, FLASH_SHAPES[4]]
#: (dtype, rows, d): the nn scope's rmsnorm rows, a ragged shape,
#: llama3.2-1b's d_model and the widest d the Pallas kernel took.
RMSNORM_SHAPES = [(torch.float32, 4096, 1024), (torch.float32, 4096, 4096),
                  (torch.bfloat16, 1000, 1000),
                  (torch.bfloat16, 4096, 2048), (torch.bfloat16, 4096, 8192)]
RMSNORM_HEADLINE = RMSNORM_SHAPES[1]
#: Where every rows-a-block count is held once: the headline and a row
#: count none but 1 divides.
RMSNORM_TILE_SHAPES = [RMSNORM_HEADLINE, RMSNORM_SHAPES[2]]
#: (b, l, h, p, n, chunk, dt scale): the nn scope's ssd_scan_cuda rows,
#: ragged widths, mamba2-780m's SSD layer (48 heads of 64, state 128),
#: its widths at batch 8 (4 heads a block on an H100), 5 heads (groups
#: of 2 and a last of one) and the nn scope's shape with dt x8.
SSD_SHAPES = [(2, 1024, 4, 64, 64, 128, 1.0), (2, 4096, 4, 64, 64, 128, 1.0),
              (1, 384, 3, 24, 40, 128, 1.0), (1, 4096, 48, 64, 128, 128, 1.0),
              (8, 512, 48, 64, 128, 128, 1.0), (4, 4096, 5, 64, 64, 128, 1.0),
              (2, 1024, 4, 64, 64, 128, 8.0)]
SSD_HEADLINE = SSD_SHAPES[1]
#: Where every chunk a tune may choose is held (the kernel to its plain
#: version, ``ssd`` to the sequential recurrence): the nn scope's rows
#: and mamba2-780m's SSD layer.
SSD_TILE_SHAPES = [SSD_SHAPES[0], SSD_SHAPES[1], SSD_SHAPES[3]]
#: (B, S, H, K, D), causal bf16: the train cells' attention layers,
#: internlm2-1.8b (B4, 16 heads over 8 kv heads of 128) and
#: granite-4.0-h-small (B8, 32 over 8 of 128).
FLASH_TRAIN_SHAPES = [(4, 4096, 16, 8, 128), (8, 4096, 32, 8, 128)]
#: (dtype, B, Smax, H, K, D, lengths): the chat cell's pool
#: (internlm2-1.8b's attention, 64 slots x 2,560 in bf16) with live
#: lengths drawn from the chat mix (``chat``) and with every slot full;
#: llama3.2-1b's heads (32 / 8 of 64), a group of 6 (qwen2-vl-2b), head
#: size 160 (stablelm-12b), float16 and float32 caches, lengths from 0 to
#: past the cache (``ragged``), and one long row.
DECODE_SHAPES = [
    (torch.bfloat16, 64, 2560, 16, 8, 128, "chat"),
    (torch.bfloat16, 64, 2560, 16, 8, 128, "full"),
    (torch.bfloat16, 8, 4096, 32, 8, 64, "ragged"),
    (torch.bfloat16, 8, 2048, 12, 2, 128, "ragged"),
    (torch.bfloat16, 4, 2048, 32, 8, 160, "ragged"),
    (torch.float16, 64, 2560, 16, 8, 128, "chat"),
    (torch.float32, 16, 2048, 16, 8, 128, "ragged"),
    (torch.bfloat16, 1, 32768, 16, 8, 128, "full"),
]
DECODE_HEADLINE = DECODE_SHAPES[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, target_s: float = 0.05, max_reps: int = 2000) -> float:
    """Time per call of back-to-back calls, from CUDA events around a
    run long enough to span ``target_s``, after a warm-up call.  Where
    the host cannot launch as fast as the device runs, this holds the
    host's share too (``device_ms`` is the kernel alone)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(max_reps, max(3, target_s * 1e3 / max(
        start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernels, calls: int = 20):
    """Device time per call of the CUDA kernels whose names hold one of
    ``kernels`` (a kernel's variants and passes), from a
    ``torch.profiler`` trace of ``calls`` calls: the kernels alone,
    without the host's launch path.  None when the trace shows no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if any(k in e.key for k in kernels)]
        if found:
            return sum(e.device_time_total for e in found) / calls / 1e3
    return None


#: Profiler names of each kernel's ``__global__`` functions (each
#: variant's, and the ffma variant's combine pass): ``device_ms`` sums
#: the kernels a call launches.
MATMUL_KERNELS = ("matmul_simt_kernel", "matmul_wgmma_kernel")
FLASH_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_ffma_kernel",
                 "flash_attention_ffma_combine_kernel",
                 "flash_attention_bwd_delta_kernel",
                 "flash_attention_bwd_dkdv_kernel",
                 "flash_attention_bwd_dq_kernel")
#: The bf16 backward's three kernels (a subset of ``FLASH_KERNELS``).
FLASH_BWD_KERNELS = ("flash_attention_bwd_delta_kernel",
                     "flash_attention_bwd_dkdv_kernel",
                     "flash_attention_bwd_dq_kernel")
HISTOGRAM_KERNELS = ("histogram_kernel",)
RMSNORM_KERNELS = ("rmsnorm_kernel",)
SSD_KERNELS = ("ssd_chunk_tiled_kernel",)
DECODE_KERNELS = ("decode_attention_split_kernel",
                  "decode_attention_combine_kernel")


def variant_of(ops, before: dict) -> str:
    """The variant that the one call since ``before`` launched."""
    ran = [v for v, n in ops.launches_by_variant.items() if n != before[v]]
    if len(ran) != 1:
        raise AssertionError(f"one launch expected, variants {ran}")
    return ran[0]


def tiles_of(table: dict) -> list:
    """Every tile of a variant's instantiated set (``ops.TILES[v]``)."""
    return [dict(zip(table, values))
            for values in itertools.product(*table.values())]


def tile_str(tile: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in tile.items())


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return dict(target_hardware(name), card=card)


#: Tensor-core instructions each library must hold: the bf16 ``wgmma``
#: variants' HGMMA.
TENSOR_CORE_OPS = {"matmul": ("HGMMA",), "flash_attention": ("HGMMA",)}
#: ``__global__`` functions whose every instantiation must hold HGMMA:
#: the bf16 flash forward and its backward's two product kernels.
HGMMA_FUNCTIONS = {"flash_attention": ("flash_attention_wgmma_kernel",
                                       "flash_attention_bwd_dkdv_kernel",
                                       "flash_attention_bwd_dq_kernel")}


def phase_build() -> dict:
    names = _build.kernel_names()
    t0 = time.perf_counter()
    logs = _build.build(names)
    log(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line or "warning" in line):
                log(f"  {name}: {line.strip()}")
    return phase_sass(names)


def phase_sass(names) -> dict:
    """Tensor-core instructions in each library's SASS: ``HGMMA`` (the
    warpgroup ``wgmma``) and ``HMMA`` (warp ``mma.sync``)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    counts = {}
    per_function = {}
    for name in names:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {op: sum(1 for line in sass.splitlines()
                                if f" {op}." in line or f" {op} " in line)
                        for op in ("HGMMA", "HMMA")}
        # HGMMA by function: a "Function : <mangled name>" line opens each
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                per_function.setdefault((name, fn), 0)
            elif fn is not None and (" HGMMA." in line or " HGMMA " in line):
                per_function[name, fn] += 1
    log(f"sass tensor-core instructions: {counts}; flash_attention HMMA "
        f"{counts['flash_attention']['HMMA']} (float32 runs on the CUDA "
        f"cores: ffma)")
    for name, ops in TENSOR_CORE_OPS.items():
        for op in ops:
            if counts[name][op] == 0:
                raise AssertionError(f"{name}: no {op} in its library")
    for name, fns in HGMMA_FUNCTIONS.items():
        for want in fns:
            found = {f: n for (lib, f), n in per_function.items()
                     if lib == name and want in f}
            log(f"sass HGMMA in {want}: {sorted(found.values())}")
            if not found or min(found.values()) == 0:
                raise AssertionError(f"{name}: {want} has an instantiation "
                                     f"without HGMMA: {found}")
    return counts


def check_close(what, got, want, tol, rtol=None) -> float:
    """Largest absolute difference; raises past ``atol = tol`` and
    ``rtol`` (``tol`` too unless given)."""
    err = (got.float() - want.float()).abs().max().item() \
        if got.numel() else 0.0
    try:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol if rtol is None else rtol)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None
    return err


def tol_units(got, want, tol) -> float:
    """Largest |got - want| in units of ``tol + tol |want|`` (1 is the
    edge of ``check_close``)."""
    return ((got.float() - want.float()).abs()
            / (tol + tol * want.float().abs())).max().item()


def bound(hw, nbytes, ops, dtype) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` done at the
    card's peak for ``dtype``: ``bound_ms`` and what bounds it."""
    peak = hw["peak_bf16_flops"] if dtype == torch.bfloat16 \
        else hw["peak_fp32_flops"]
    t_ops, t_bytes = ops / peak, nbytes / hw["hbm_bandwidth"]
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def phase_matmul(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = []
    for dtype, (M, K, N) in MATMUL_SHAPES:
        x = (torch.randn((M, K), generator=gen, device="cuda")
             / math.sqrt(K)).to(dtype)
        y = torch.randn((K, N), generator=gen, device="cuda").to(dtype)
        before = dict(matmul_ops.launches_by_variant)
        out = matmul(x, y)
        variant = variant_of(matmul_ops, before)
        tile = matmul_ops.resolve_tile(x, y)[2]
        tol = MATMUL_TOL[dtype]
        err = check_close(f"matmul {dtype} {M}x{K}x{N}", out,
                          matmul_ref(x, y), tol)
        ulps = None
        if dtype == torch.bfloat16:
            ulps = bf16_ulp_error(out, x, y)
            if ulps > BF16_MAX_ULPS:
                raise AssertionError(
                    f"matmul bf16 {M}x{K}x{N}: {ulps} ulps from the "
                    f"float32 product rounded once (limit {BF16_MAX_ULPS})")
        row = {
            "dtype": dname(dtype), "M": M, "K": K, "N": N,
            "variant": variant, "tile": tile,
            "max_abs_err": err, "tol": tol, "max_ulp_err": ulps,
            "ms": time_ms(lambda: matmul(x, y)),
            "device_ms": device_ms(lambda: matmul(x, y), MATMUL_KERNELS),
            "plain_ms": time_ms(lambda: matmul_ref(x, y)),
            "library_ms": time_ms(lambda: torch.matmul(x, y)),
            **bound(hw, (M * K + K * N + M * N) * x.element_size(),
                    2.0 * M * N * K, dtype),
        }
        ulp_note = "" if ulps is None else f" ulps {ulps:.3g}"
        log(f"matmul {row['dtype']} {M}x{K}x{N} ({variant}, "
            f"{tile_str(tile)}): max_abs_err "
            f"{err:.3g} "
            f"(tol {tol}){ulp_note} kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms torch.matmul {row['library_ms']:.4f} "
            f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        shapes.append(((dtype, (M, K, N)), row))
    tiles = []
    for which, (dtype, (M, K, N)) in MATMUL_TILE_SHAPES.items():
        x = (torch.randn((M, K), generator=gen, device="cuda")
             / math.sqrt(K)).to(dtype)
        y = torch.randn((K, N), generator=gen, device="cuda").to(dtype)
        want, tol = matmul_ref(x, y), MATMUL_TOL[dtype]
        for tile in tiles_of(matmul_ops.TILES[which]):
            what = f"matmul {dname(dtype)} {M}x{K}x{N} {which} {tile_str(tile)}"
            before = dict(matmul_ops.launches_by_variant)
            out = matmul(x, y, **tile)
            if variant_of(matmul_ops, before) != which:
                raise AssertionError(f"{what}: another variant")
            err = check_close(what, out, want, tol)
            ulps = bf16_ulp_error(out, x, y) \
                if dtype == torch.bfloat16 else None
            if ulps is not None and ulps > BF16_MAX_ULPS:
                raise AssertionError(f"{what}: {ulps} ulps")
            row = {"variant": which, "tile": tile, "dtype": dname(dtype),
                   "M": M, "K": K, "N": N, "max_abs_err": err, "tol": tol,
                   "max_ulp_err": ulps,
                   "ms": time_ms(lambda: matmul(x, y, **tile))}
            log(f"{what}: max_abs_err {err:.3g} (tol {tol})"
                + ("" if ulps is None else f" ulps {ulps:.3g}")
                + f" kernel {row['ms']:.4f} ms")
            tiles.append(row)
    return summarize("matmul", "src/repro_torch/kernels/matmul/csrc/matmul.cu",
                     "src/repro/kernels/matmul/kernel.py:38",
                     "src/repro/kernels/matmul/kernel.py::matmul_pallas",
                     shapes, MATMUL_HEADLINE, tiles)


def histogram_input(n, bins, case, gen):
    if case == "one_hot_bin":
        return torch.full((n,), bins // 3, dtype=torch.int32, device="cuda")
    lo, hi = (-(bins // 4), bins + bins // 4) if case == "out_of_range" \
        else (0, bins)
    extra = 1 if case == "misaligned" else 0
    x = torch.randint(lo, hi, (n + extra,), generator=gen, device="cuda",
                      dtype=torch.int32)
    return x[extra:]


def histogram_merges(x, bins, blocks, cluster) -> dict:
    """A model, not a count on the device: the global atomics one call
    would make (the non-zero (cluster, bin) sums), and what one merge per
    block would make on the same grid, from a copy of the kernel's
    partition: block 0 takes the scalar head and tail, and int4 j of the
    aligned body goes to thread j mod (blocks * THREADS)."""
    n, threads = x.numel(), histogram_ops.THREADS
    head = min(n, (16 - x.data_ptr() % 16) % 16 // 4)
    nvec = (n - head) // 4
    i = torch.arange(n, device=x.device)
    block = torch.where((i >= head) & (i < head + 4 * nvec),
                        (i - head) // 4 % (blocks * threads) // threads, 0)
    keep = (x >= 0) & (x < bins)
    v, block = x[keep].long(), block[keep]
    return {"merges": torch.unique(block // cluster * bins + v).numel(),
            "merges_one_per_block": torch.unique(block * bins + v).numel()}


def phase_histogram(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    lib = _build.load("histogram", histogram_ops._SIGNATURES)
    shapes = []
    for n, bins, case in HISTOGRAM_SHAPES:
        x = histogram_input(n, bins, case, gen)
        out = histogram(x, bins)
        ref = histogram_ref(x, bins)
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"histogram n={n} bins={bins} {case}: "
                                 f"kernel differs from plain (max {err})")
        cluster = histogram_ops.CLUSTER
        blocks = histogram_ops.grid_size(
            n, histogram_ops.max_clusters(lib, x.device.index, bins))
        model = histogram_merges(x, bins, blocks, cluster)
        row = {
            "n": n, "bins": bins, "case": case,
            "out_of_range": case == "out_of_range",
            "cluster": cluster, "blocks": blocks,
            "max_abs_err": err, "tol": 0,
            "ms": time_ms(lambda: histogram(x, bins)),
            "device_ms": device_ms(lambda: histogram(x, bins),
                                   HISTOGRAM_KERNELS),
            "plain_ms": time_ms(lambda: histogram_ref(x, bins)),
            "library_ms": (None if case == "out_of_range" else time_ms(
                lambda: torch.bincount(x, minlength=bins))),
            **bound(hw, (n + bins) * 4, 0.0, torch.int32),
        }
        lib_ms = "n/a" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        log(f"histogram n={n} bins={bins} {case}: exact; {blocks} blocks in "
            f"clusters of {cluster}, {model['merges']} global merges by the "
            f"model (one a block: {model['merges_one_per_block']}); kernel "
            f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms torch.bincount {lib_ms} bound "
            f"{row['bound_ms']:.5f} ms")
        shapes.append(((n, bins, case), row))
    return summarize("histogram",
                     "src/repro_torch/kernels/histogram/csrc/histogram.cu",
                     "src/repro/kernels/histogram/kernel.py:29",
                     "src/repro/kernels/histogram/kernel.py::histogram_pallas",
                     shapes, HISTOGRAM_HEADLINE)


def flash_f32_x4(key, q, k, v, variant) -> float:
    """A float32 shape again with inputs x4 (scores of tens), through the
    same variant and held to 2e-5 of the plain version like the rest."""
    tol = FLASH_TOL[torch.float32]
    causal = key[-1]
    q4, k4, v4 = (t * 4 for t in (q, k, v))
    before = dict(flash_ops.launches_by_variant)
    out4 = flash_attention(q4, k4, v4, causal=causal)
    if variant_of(flash_ops, before) != variant:
        raise AssertionError(f"flash_attention {key} x4: another variant")
    err = check_close(f"flash_attention {key} x4", out4,
                      flash_attention_ref(q4, k4, v4, causal=causal), tol)
    log(f"  x4: max_abs_err {err:.3g} (tol {tol})")
    return err


def phase_flash(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    for key in FLASH_SHAPES:
        dtype, B, S, H, K, D, causal = key
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
        tol = FLASH_TOL[dtype]
        before = dict(flash_ops.launches_by_variant)
        out = flash_attention(q, k, v, causal=causal)
        variant = variant_of(flash_ops, before)
        tile = flash_ops.resolve_tile(q)[2]
        err = check_close(f"flash_attention {key}", out,
                          flash_attention_ref(q, k, v, causal=causal), tol)
        # (query, key) pairs the mask keeps: what the work depends on
        pairs = S * (S + 1) // 2 if causal else S * S
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "dtype": dname(dtype), "B": B, "S": S, "H": H, "K": K, "D": D,
            "causal": causal, "variant": variant, "tile": tile,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "device_ms": device_ms(
                lambda: flash_attention(q, k, v, causal=causal),
                FLASH_KERNELS),
            "plain_ms": time_ms(
                lambda: flash_attention_ref(q, k, v, causal=causal)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != K)),
            **bound(hw, 2 * (q.numel() + k.numel()) * q.element_size(),
                    4.0 * B * H * D * pairs, dtype),
        }
        log(f"flash_attention {row['dtype']} B={B} S={S} H={H} K={K} D={D}"
            f" causal={causal} ({variant}, {tile_str(tile)}): max_abs_err "
            f"{err:.3g} (tol {tol}) kernel "
            f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms sdpa {row['library_ms']:.4f} ms "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if dtype == torch.float32:
            row["x4_max_abs_err"] = flash_f32_x4(key, q, k, v, variant)
            # three TF32 products a product on the tensor cores
            row["bound_3xtf32_ms"] = 3 * 4.0 * B * H * D * pairs \
                / hw["peak_tf32_flops"] * 1e3
        shapes.append((key, row))
    tiles = []
    for key in FLASH_TILE_SHAPES:
        dtype, B, S, H, K, D, causal = key
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
        tol = FLASH_TOL[dtype]
        want = flash_attention_ref(q, k, v, causal=causal)
        for tile in tiles_of(flash_ops.TILES["ffma"]):
            what = f"flash_attention {key} ffma {tile_str(tile)}"
            before = dict(flash_ops.launches_by_variant)
            out = flash_attention(q, k, v, causal=causal, **tile)
            if variant_of(flash_ops, before) != "ffma":
                raise AssertionError(f"{what}: another variant")
            row = {"variant": "ffma", "tile": tile, "B": B, "S": S, "H": H,
                   "K": K, "D": D, "causal": causal,
                   "max_abs_err": check_close(what, out, want, tol),
                   "tol": tol,
                   "ms": time_ms(lambda: flash_attention(
                       q, k, v, causal=causal, **tile))}
            note = ""
            if key == FLASH_HEADLINE:
                q4, k4, v4 = (t * 4 for t in (q, k, v))
                row["x4_max_abs_err"] = check_close(
                    f"{what} x4",
                    flash_attention(q4, k4, v4, causal=causal, **tile),
                    flash_attention_ref(q4, k4, v4, causal=causal), tol)
                note = f", x4 {row['x4_max_abs_err']:.3g}"
            log(f"{what}: max_abs_err {row['max_abs_err']:.3g}{note} (tol "
                f"{tol}) kernel {row['ms']:.4f} ms")
            tiles.append(row)
    return summarize(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:70",
        "src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas",
        shapes, FLASH_HEADLINE, tiles)


def phase_flash_train(hw: dict) -> dict:
    """The models' attention on the card (``flash_ops.attention_fwd`` with
    its log-sum-exp and ``attention_bwd``) at :data:`FLASH_TRAIN_SHAPES`:
    held to the plain scans (``layers._flash_fwd_plain``,
    ``_flash_bwd_plain``, chunks 512, what the models ran before the
    kernels), each backward on its own side's forward, within
    ``flash_ref.TOL`` (out, lse, dq, dk, dv); a rerun bit for bit, one
    and three launches; call and device ms beside two bounds: the
    function's (two products a kept (query, key) pair forward, five
    backward) and the design's backward, seven (the dQ kernel's second S
    and dP, the price of summing with no atomics); the scans' ms and
    SDPA's forward and backward, which the port never calls."""
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for B, S, H, K, D in FLASH_TRAIN_SHAPES:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, K, D), generator=gen,
                            device="cuda").bfloat16() for _ in range(2))
        dout = torch.randn((B, S, H, D), generator=gen,
                           device="cuda").bfloat16()
        what = f"flash train bf16 B={B} S={S} H={H} K={K} D={D} causal"
        sched = (True, 512, 512, True)
        before = dict(flash_ops.launches_by_variant)
        out, lse = flash_ops.attention_fwd(q, k, v, True, True)
        grads = flash_ops.attention_bwd(q, k, v, out, lse, dout, True)
        ran = {n: flash_ops.launches_by_variant[n] - before[n]
               for n in before}
        if ran != {"wgmma": 1, "ffma": 0, "bwd_delta": 1, "bwd_dkdv": 1,
                   "bwd_dq": 1}:
            raise AssertionError(f"{what}: launches {ran}")
        again = flash_ops.attention_bwd(q, k, v, out, lse, dout, True)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"{what}: a rerun is not bit for bit")
        del again
        p_out, p_lse = model_layers._flash_fwd_plain(q, k, v, *sched)
        want = {"out": p_out.to(q.dtype), "lse": p_lse}
        del p_out
        want.update(zip(("dq", "dk", "dv"), model_layers._flash_bwd_plain(
            q, k, v, want["out"], p_lse, dout, *sched)))
        got = {"out": out, "lse": lse, "dq": grads[0], "dk": grads[1],
               "dv": grads[2]}
        gaps = flash_ref.gaps(got, want)
        del want, got
        if flash_ref.over(gaps):
            raise AssertionError(f"{what}: gaps to the scans {gaps} (tol "
                                 f"{flash_ref.TOL})")
        pairs = flash_ops.kept_pairs(S, S, True)
        fwd = lambda: flash_ops.attention_fwd(q, k, v, True, True)
        bwd = lambda: flash_ops.attention_bwd(q, k, v, out, lse, dout, True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dt = dout.transpose(1, 2)

        def sdpa():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
            return torch.autograd.grad(o, (qt, kt, vt), dt)
        row = {
            "B": B, "S": S, "H": H, "K": K, "D": D, "causal": True,
            "gaps": gaps, "tol": flash_ref.TOL,
            "fwd_ms": time_ms(fwd),
            "fwd_device_ms": device_ms(fwd, FLASH_KERNELS[:1]),
            "bwd_ms": time_ms(bwd),
            "bwd_device_ms": device_ms(bwd, FLASH_BWD_KERNELS),
            "bwd_device_ms_by_kernel": {
                n: device_ms(bwd, (n,)) for n in FLASH_BWD_KERNELS},
            "plain_fwd_ms": time_ms(lambda: model_layers._flash_fwd_plain(
                q, k, v, *sched), target_s=0.2),
            "plain_bwd_ms": time_ms(lambda: model_layers._flash_bwd_plain(
                q, k, v, out, lse, dout, *sched), target_s=0.2),
            "library_fwd_bwd_ms": time_ms(sdpa),
            "fwd_bound_ms": bound(hw, 0, 4.0 * B * H * D * pairs,
                                  torch.bfloat16)["bound_ms"],
            "bwd_bound_ms": bound(hw, 0, 10.0 * B * H * D * pairs,
                                  torch.bfloat16)["bound_ms"],
            "bwd_design_bound_ms": bound(hw, 0, 14.0 * B * H * D * pairs,
                                         torch.bfloat16)["bound_ms"],
        }
        shown = ", ".join(f"{n} {g:.3g}" for n, g in gaps.items())
        log(f"{what}: gaps to the scans {shown} "
            f"(tol {flash_ref.TOL}); forward with lse {row['fwd_ms']:.4f} "
            f"ms (device {fmt_ms(row['fwd_device_ms'])}, bound "
            f"{row['fwd_bound_ms']:.4f}); backward {row['bwd_ms']:.4f} ms "
            f"(device {fmt_ms(row['bwd_device_ms'])}: "
            + ", ".join(f"{n} {fmt_ms(t)}" for n, t in
                        row["bwd_device_ms_by_kernel"].items())
            + f"; bound {row['bwd_bound_ms']:.4f}, the design's "
            f"{row['bwd_design_bound_ms']:.4f}); plain scans "
            f"{row['plain_fwd_ms']:.3f} + {row['plain_bwd_ms']:.3f} ms; "
            f"sdpa forward and backward {row['library_fwd_bwd_ms']:.4f} ms")
        rows.append(row)
    return {"name": "flash_attention train", "shapes": rows}


def phase_rmsnorm(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    for key in RMSNORM_SHAPES:
        dtype, rows, d = key
        x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
        s = torch.randn((d,), generator=gen, device="cuda") + 1.0
        tol = RMSNORM_TOL[dtype]
        err = check_close(f"rmsnorm {key}", rmsnorm(x, s), rmsnorm_ref(x, s),
                          tol)
        tile = rmsnorm_ops.resolve_tile(x)[1]
        # the library call takes its weight in x's type (a mixed pair is
        # not fused); the cast is made once, outside the timing
        s_lib = s.to(dtype)
        row = {
            "dtype": dname(dtype), "rows": rows, "d": d, "tile": tile,
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: rmsnorm(x, s)),
            "device_ms": device_ms(lambda: rmsnorm(x, s),
                                   RMSNORM_KERNELS),
            "plain_ms": time_ms(lambda: rmsnorm_ref(x, s)),
            "library_ms": time_ms(
                lambda: F.rms_norm(x, (d,), s_lib, 1e-6)),
            **bound(hw, 2 * x.numel() * x.element_size() + 4 * d,
                    4.0 * rows * d, dtype),
        }
        log(f"rmsnorm {row['dtype']} {rows}x{d} ({tile_str(tile)}): "
            f"max_abs_err {err:.3g} "
            f"(tol {tol}) kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain {row['plain_ms']:.4f} ms "
            f"F.rms_norm {row['library_ms']:.4f} ms bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
        shapes.append((key, row))
    tiles = []
    for key in RMSNORM_TILE_SHAPES:
        dtype, rows, d = key
        x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
        s = torch.randn((d,), generator=gen, device="cuda") + 1.0
        tol, want = RMSNORM_TOL[dtype], rmsnorm_ref(x, s)
        for tile in tiles_of(rmsnorm_ops.TILES[rmsnorm_ops.VARIANT]):
            what = f"rmsnorm {dname(dtype)} {rows}x{d} {tile_str(tile)}"
            before = rmsnorm_ops.launches
            err = check_close(what, rmsnorm(x, s, **tile), want, tol)
            if rmsnorm_ops.launches != before + 1:
                raise AssertionError(f"{what}: no launch")
            row = {"variant": rmsnorm_ops.VARIANT, "tile": tile,
                   "dtype": dname(dtype), "rows": rows, "d": d,
                   "max_abs_err": err, "tol": tol,
                   "ms": time_ms(lambda: rmsnorm(x, s, **tile))}
            log(f"{what}: max_abs_err {err:.3g} (tol {tol}) kernel "
                f"{row['ms']:.4f} ms")
            tiles.append(row)
    return summarize("rmsnorm",
                     "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm/kernel.py:24",
                     "src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas",
                     shapes, RMSNORM_HEADLINE, tiles)


def phase_ssd(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key in SSD_SHAPES:
        b, l, h, p, n, Q, scale = key

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = randn(b, l, h, p) * 0.4
        dt = F.softplus(randn(b, l, h)) * scale
        A = -torch.exp(randn(h) * 0.3)
        Bm, Cm = randn(b, l, 1, n) * 0.3, randn(b, l, 1, n) * 0.3
        D = torch.ones(h, device="cuda")
        B0, C0 = Bm[:, :, 0], Cm[:, :, 0]
        before = dict(ssd_ops.launches_by_variant)
        got = ssd_chunk(x, dt, A, B0, C0, chunk=Q)
        variant = variant_of(ssd_ops, before)
        group = ssd_ops.head_group(b, l // Q, h, sms)
        want = ssd_chunk_ref(x, dt, A, B0, C0, chunk=Q)
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"ssd_chunk {key}: non-finite output")
        err = max(check_close(f"ssd_chunk {key} {part}", g, w, SSD_TOL)
                  for part, g, w in zip(("y", "states", "ecs"), got, want))
        y, state = ssd(x, dt, A, Bm, Cm, D, chunk=Q)
        # with dt x8 the chunked form itself sits off the recurrence
        if scale == 1.0:
            oracle = ssd_reference
            y_ref, state_ref = ssd_reference(x, dt, A, Bm, Cm, D)
        else:
            oracle = ssd_chunked
            y_ref, state_ref = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q)
            y_seq, state_seq = ssd_reference(x, dt, A, Bm, Cm, D)
            log(f"  dt x{scale}: ssd from the sequential recurrence, in "
                f"units of atol + rtol |ref| (logged, not held): y "
                f"{tol_units(y, y_seq, SSD_TOL):.3f}, state "
                f"{tol_units(state, state_seq, SSD_TOL):.3f}; ssd_chunked:"
                f" y {tol_units(y_ref, y_seq, SSD_TOL):.3f}")
        err = max(err, check_close(f"ssd {key} y", y, y_ref, SSD_TOL),
                  check_close(f"ssd {key} state", state, state_ref, SSD_TOL))
        nc = l // Q
        tri = Q * (Q + 1) // 2
        # C.B once per (batch, chunk), shared by the heads; y and the
        # chunk state per head
        ops = 2.0 * (b * nc * tri * n + b * nc * h * (tri * p + Q * p * n))
        nbytes = 4 * (2 * x.numel() + 2 * dt.numel() + A.numel()
                      + 2 * B0.numel() + got[1].numel())
        row = {
            "b": b, "l": l, "h": h, "p": p, "n": n, "chunk": Q,
            "tile": {"chunk": Q}, "dt_scale": scale, "variant": variant, "heads_a_block": group,
            "ssd_oracle": oracle.__name__,
            "max_abs_err": err, "tol": SSD_TOL,
            "ms": time_ms(lambda: ssd_chunk(x, dt, A, B0, C0, chunk=Q)),
            "device_ms": device_ms(
                lambda: ssd_chunk(x, dt, A, B0, C0, chunk=Q),
                SSD_KERNELS),
            "plain_ms": time_ms(
                lambda: ssd_chunk_ref(x, dt, A, B0, C0, chunk=Q)),
            "library_ms": None,
            "ssd_ms": time_ms(lambda: ssd(x, dt, A, Bm, Cm, D, chunk=Q)),
            "ssd_chunked_ms": time_ms(
                lambda: ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q)),
            **bound(hw, nbytes, ops, torch.float32),
        }
        # the whole call less the kernel's: ssd's torch part
        row["ssd_torch_ms"] = row["ssd_ms"] - row["ms"]
        log(f"ssd_chunk b={b} l={l} h={h} p={p} n={n} chunk={Q} dt x{scale}"
            f" ({variant}, heads a block {group}): "
            f"max_abs_err {err:.3g} (tol {SSD_TOL}; ssd against "
            f"{oracle.__name__}) kernel {row['ms']:.4f}"
            f" ms (device {fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms library none bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); whole ssd "
            f"{row['ssd_ms']:.4f} ms (kernel {row['ms']:.4f}, torch "
            f"{row['ssd_torch_ms']:.4f}), ssd_chunked "
            f"{row['ssd_chunked_ms']:.4f} ms")
        shapes.append((key, row))
    tiles = []
    for key in SSD_TILE_SHAPES:
        b, l, h, p, n, _, scale = key

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = randn(b, l, h, p) * 0.4
        dt = F.softplus(randn(b, l, h)) * scale
        A = -torch.exp(randn(h) * 0.3)
        Bm, Cm = randn(b, l, 1, n) * 0.3, randn(b, l, 1, n) * 0.3
        D = torch.ones(h, device="cuda")
        B0, C0 = Bm[:, :, 0], Cm[:, :, 0]
        y_ref, state_ref = ssd_reference(x, dt, A, Bm, Cm, D)
        which = ssd_ops.state_variant(n)
        for tile in tiles_of(ssd_ops.TILES[which]):
            Q = tile["chunk"]
            what = f"ssd b={b} l={l} h={h} p={p} n={n} chunk={Q}"
            before = dict(ssd_ops.launches_by_variant)
            got = ssd_chunk(x, dt, A, B0, C0, chunk=Q)
            if variant_of(ssd_ops, before) != which:
                raise AssertionError(f"{what}: another variant")
            want = ssd_chunk_ref(x, dt, A, B0, C0, chunk=Q)
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"{what}: non-finite output")
            kernel_err = max(check_close(f"{what} {part}", g, w, SSD_TOL)
                             for part, g, w in zip(("y", "states", "ecs"),
                                                   got, want))
            y, state = ssd(x, dt, A, Bm, Cm, D, chunk=Q)
            ssd_err = max(check_close(f"{what} ssd y", y, y_ref, SSD_TOL),
                          check_close(f"{what} ssd state", state, state_ref,
                                      SSD_TOL))
            row = {"variant": which, "tile": tile, "b": b, "l": l, "h": h,
                   "p": p, "n": n, "max_abs_err": max(kernel_err, ssd_err),
                   "kernel_max_abs_err": kernel_err,
                   "ssd_max_abs_err": ssd_err, "tol": SSD_TOL,
                   "ms": time_ms(lambda: ssd_chunk(x, dt, A, B0, C0,
                                                   chunk=Q)),
                   "ssd_ms": time_ms(lambda: ssd(x, dt, A, Bm, Cm, D,
                                                 chunk=Q))}
            log(f"{what} ({which}): kernel max_abs_err {kernel_err:.3g}, "
                f"ssd against ssd_reference {ssd_err:.3g} (tol {SSD_TOL}); "
                f"kernel {row['ms']:.4f} ms, whole ssd {row['ssd_ms']:.4f} "
                f"ms")
            tiles.append(row)
    return summarize("ssd_scan",
                     "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:50",
                     "src/repro/kernels/ssd_scan/kernel.py::ssd_chunk_pallas",
                     shapes, SSD_HEADLINE, tiles)


def decode_lengths(case: str, B: int, smax: int, gen) -> torch.Tensor:
    """Each row's cache length: ``chat`` draws a live slot of the chat
    mix (``bench/traffic/chat.json``: prompt lognormal, median 1,020,
    sigma 0.8, 16-2,000; output lognormal, median 129, sigma 1.0,
    8-512; a point part-way through the output), ``full`` every slot
    full, ``ragged`` uniform over [0, Smax + 64] with an empty row and
    one past the cache (a free slot's clock)."""
    if case == "full":
        n = torch.full((B,), smax)
    elif case == "chat":
        def lognormal(median, sigma, lo, hi):
            x = torch.exp(math.log(median) + sigma * torch.randn(
                B, generator=gen))
            return x.round().clamp(lo, hi)
        out = lognormal(129, 1.0, 8, 512)
        n = lognormal(1020, 0.8, 16, 2000) + (
            torch.rand(B, generator=gen) * out).ceil().clamp(min=1)
    else:
        n = torch.randint(0, smax + 65, (B,), generator=gen)
        n[0] = 0
        n[-1] = smax + 40
    return n.to(torch.int32).cuda()


def phase_decode_attention(hw: dict) -> dict:
    """The decode-attention kernel against its plain version at
    :data:`DECODE_SHAPES`, with its split, its time beside its bound
    (the live k and v once, q and out), the port's plain form
    (``layers._decode_attention_plain``, what the decode path ran before
    the kernel) and SDPA (``F.scaled_dot_product_attention``, masked to
    each row's prefix), which the port never calls.  Also held: a scalar
    length, the partials of a cache cut in two merged to the whole, and
    two launches a call."""
    gen = torch.Generator().manual_seed(0)
    shapes = []
    for key in DECODE_SHAPES:
        dtype, B, S, H, K, D, case = key
        q = torch.randn((B, 1, H, D), generator=gen).to("cuda", dtype)
        k, v = (torch.randn((B, S, K, D), generator=gen).to("cuda", dtype)
                for _ in range(2))
        lens = decode_lengths(case, B, S, gen)
        split = decode_ops.device_split_len(q.device, B, K, H // K, S)
        # the kernel's own tolerance, (atol, rtol), with its reason
        atol, rtol = decode_ref.TOL[dtype]
        before = decode_ops.launches
        with decode_ops.logging_reads() as reads:
            out = decode_attention(q, k, v, lens)
        if decode_ops.launches != before + 2:
            raise AssertionError(f"decode_attention {key}: "
                                 f"{decode_ops.launches - before} launches")
        if not torch.equal(reads[0].cpu(), decode_ref.positions_read(
                lens.cpu(), B, 0, S, split)):
            raise AssertionError(f"decode_attention {key}: the positions "
                                 f"it read are not each row's live splits")
        what = (f"decode_attention {dname(dtype)} B={B} S={S} H={H} K={K} "
                f"D={D} {case}")
        want = decode_attention_ref(q, k, v, lens, split_len=split)
        err = check_close(what, out, want, atol, rtol)
        # the outputs' own scale: the median |out| of the rows with a
        # live position, and the largest error in units of the tolerance
        typical = want[lens > 0].float().abs().median().item()
        used = ((out.float() - want.float()).abs()
                / (atol + rtol * want.float().abs())).max().item()
        if key == DECODE_HEADLINE:
            err = max(err, check_close(
                f"{what} scalar length", decode_attention(q, k, v, 1500),
                decode_attention_ref(q, k, v, 1500, split_len=split), atol,
                rtol))
            cut = S // 2 + 40
            parts = [decode_attention_partials(q, k[:, a:b], v[:, a:b], lens,
                                               first=a)
                     for a, b in ((0, cut), (cut, S))]
            m, l, acc = (torch.stack(x) for x in zip(*parts))
            merged = decode_ref.normalise(
                *decode_ref.merge(m, l, acc)[1:]).to(dtype)
            err = max(err, check_close(f"{what} partials", merged, want,
                                       atol, rtol))
        live = int(lens.clamp(0, S).sum())
        item = k.element_size()
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = None if case == "full" else (
            torch.arange(S, device="cuda")[None] < lens[:, None].long()
        )[:, None, None, :]
        row = {
            "dtype": dname(dtype), "B": B, "Smax": S, "H": H, "K": K, "D": D,
            "lengths": case, "live_positions": live, "split": split,
            "max_abs_err": err, "typical_abs_out": typical,
            "tol_used": used, "atol": atol, "rtol": rtol,
            "ms": time_ms(lambda: decode_attention(q, k, v, lens)),
            "device_ms": device_ms(lambda: decode_attention(q, k, v, lens),
                                   DECODE_KERNELS),
            "plain_ms": time_ms(lambda: model_layers._decode_attention_plain(
                q, k, v, lens)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=H != K)),
            **bound(hw, (2 * live * K * D + 2 * B * H * D) * item,
                    4.0 * live * H * D, dtype),
        }
        log(f"{what} (split {split}, {live} live of {B * S}): max_abs_err "
            f"{err:.3g} against a typical |out| {typical:.3g} ({used:.3g} of "
            f"atol {atol} + rtol {rtol}) kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain {row['plain_ms']:.4f} ms "
            f"sdpa {row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        shapes.append((key, row))
    return summarize(
        "decode_attention",
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "none: src/repro/models/layers.py::decode_attention is plain jnp",
        "src/repro/models/layers.py::decode_attention", shapes,
        DECODE_HEADLINE)


def summarize(name, source, replaces, function, shapes, headline,
              tiles=()) -> dict:
    top = dict(shapes)[headline]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "replaces_function": function,
        "launches": None,
        "max_abs_err": max(row["max_abs_err"]
                           for row in [r for _, r in shapes] + list(tiles)),
        "ms": top["ms"], "device_ms": top["device_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shapes": [row for _, row in shapes],
        "tiles": list(tiles),
    }


#: Each kernel's wrapper module, whose ``launches`` the main path reads.
KERNEL_OPS = {"matmul": matmul_ops, "histogram": histogram_ops,
              "flash_attention": flash_ops, "rmsnorm": rmsnorm_ops,
              "ssd_scan": ssd_ops, "decode_attention": decode_ops}
#: The kernels the scopes' own families launch (the rest run under the
#: models: decode attention in the serve scope's engine).
SCOPE_KERNELS = ("matmul", "histogram", "flash_attention", "rmsnorm",
                 "ssd_scan")
#: Wrappers with variants of their own (``launches_by_variant``).
VARIANT_OPS = {"matmul": matmul_ops, "flash_attention": flash_ops,
               "ssd_scan": ssd_ops}


def expected_instances() -> list:
    """Every instance the three scopes register, from a fresh registry."""
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.scope import ScopeManager
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load()
    mgr.register_all()
    return [name for b in mgr.registry.all() for name, _ in b.instances()]


MAIN_SCOPES = ["example", "mxu", "comm", "nn", "instr", "histo", "linalg",
               "io", "model", "serve"]


#: The model scope's default ``model/dryrun_dir``, relative to the run's
#: working directory.
DRYRUN_DIR = "results/dryrun"


def main_argv(out: str) -> list:
    """The main path's command line; its last two items name the output
    (the idle-share child drops them)."""
    return ["run"] + [a for s in MAIN_SCOPES for a in ("--enable-scope", s)] \
        + ["--benchmark_min_time", "0.05", "--results-dir", "",
           "--benchmark_out", out]


class ScopeLaunches(logging.Handler):
    """Matmul's ``simt`` launch count at each of the orchestrator's
    per-scope lines ("scope <name>: ..."), which it logs as each scope
    of an inline run ends: the difference from the line before is the
    count that scope launched.  The line's seconds are the scope's
    wall (``walls``)."""

    def __init__(self):
        super().__init__()
        self.marks = []
        self.walls = {}

    def emit(self, record):
        if record.msg.startswith("scope %s:"):
            self.marks.append((record.args[0],
                               matmul_ops.launches_by_variant["simt"]))
            self.walls[record.args[0]] = record.args[-1]

    def launched(self, scope: str) -> int:
        prev = 0
        for name, count in self.marks:
            if name == scope:
                return count - prev
            prev = count
        raise AssertionError(f"no per-scope log line for {scope}: "
                             f"{self.marks}")


#: The reference's analytic collective model (its comm scope): the link
#: bandwidth it takes for one ICI link of its TPU v5e mesh, in B/s.  The
#: port's ``collective_modeled_v5e`` rows must reproduce the model
#: exactly; the number says nothing about this machine.
V5E_ICI_LINK_BANDWIDTH = 50e9


def modeled_collective_seconds(kind: str, nbytes: int, n: int) -> float:
    """The reference's ring-collective time on one ICI axis of n chips."""
    if n <= 1:
        return 0.0
    factor = {"all_reduce": 2.0 * (n - 1) / n,
              "all_gather": (n - 1) / n,
              "reduce_scatter": (n - 1) / n,
              "all_to_all": (n - 1) / (n * n),
              "ppermute": 1.0}[kind]
    return factor * nbytes / (2 * V5E_ICI_LINK_BANDWIDTH)


def check_model_free(records: dict) -> dict:
    """The main path's comm and instr rows: the measured all-reduce on a
    one-rank NCCL group, the modeled rows against the reference's model,
    and the ``gelu`` op against the tanh formula on the card."""
    import torch.distributed as dist
    from repro_torch.scopes.instr_scope import _OPS
    backend = dist.get_backend() if dist.is_initialized() else None
    world = dist.get_world_size() if dist.is_initialized() else None
    log(f"comm: process group backend {backend}, world size {world}")
    measured = {n: r.get("devices") for n, r in records.items()
                if n.startswith("comm/all_reduce_measured/")}
    if backend != "nccl" or len(measured) != 3 or \
            set(measured.values()) != {1}:
        raise AssertionError(f"all_reduce_measured on {backend}: devices "
                             f"{measured}")
    modeled, wrong = 0, {}
    for name, r in records.items():
        if not name.startswith("comm/collective_modeled_v5e/"):
            continue
        modeled += 1
        axes = dict(part.split(":", 1) for part in name.split("/")[2:])
        want = modeled_collective_seconds(axes["kind"], int(axes["bytes"]),
                                          int(axes["axis"]))
        if r.get("modeled_s") != want or \
                r.get("axis_size") != int(axes["axis"]):
            wrong[name] = (r.get("modeled_s"), want, r.get("axis_size"))
    if modeled != 24 or wrong:
        raise AssertionError(f"{modeled} modeled rows; off the model: "
                             f"{wrong}")
    x = torch.linspace(0.1, 1.0, 1 << 20, device="cuda")
    got = _OPS["gelu"](x).double()
    xd = x.double()
    want = 0.5 * xd * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                        * (xd + 0.044715 * xd ** 3)))
    gelu_err = (got - want).abs().max().item()
    exact_gap = (F.gelu(xd) - got).abs().max().item()
    if not gelu_err <= 1e-6 or not exact_gap > 1e-5:
        raise AssertionError(f"instr gelu: {gelu_err:.3e} from the tanh "
                             f"formula, {exact_gap:.3e} from exact GELU")
    log(f"comm/instr: all_reduce_measured devices 1 on {backend}; "
        f"{modeled} modeled rows equal the reference's model; instr gelu "
        f"{gelu_err:.3e} from the tanh formula (exact GELU "
        f"{exact_gap:.3e} away)")
    return {"comm_backend": backend, "comm_world_size": world,
            "modeled_rows": modeled, "gelu_max_abs_err": gelu_err,
            "gelu_exact_gap": exact_gap}


def phase_main_path() -> dict:
    from repro_torch.core.main import main
    scopes = MAIN_SCOPES
    # nothing tuned: every launch takes its variant's builtin tile
    tuned = sorted([*source_artifacts(),
                    *(k for k in os.environ if k.startswith("REPRO_TUNED"))])
    if tuned:
        raise AssertionError(f"the main path must run the builtin tiles: "
                             f"{tuned}")
    tuning.last_resolved.clear()
    per_scope = ScopeLaunches()
    logging.getLogger("scope.orchestrate").addHandler(per_scope)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run.json")
        argv = main_argv(out)
        for ops in KERNEL_OPS.values():
            ops.launches = 0
        for ops in VARIANT_OPS.values():
            ops.launches_by_variant = dict.fromkeys(
                ops.launches_by_variant, 0)
        t0 = time.perf_counter()
        try:
            rc = main(argv)
        finally:
            logging.getLogger("scope.orchestrate").removeHandler(per_scope)
        torch.cuda.synchronize()
        launches = {name: ops.launches for name, ops in KERNEL_OPS.items()}
        by_variant = {name: dict(ops.launches_by_variant)
                      for name, ops in VARIANT_OPS.items()}
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"main path exited {rc}")
        with open(out) as f:
            doc = json.load(f)
    ctx = doc["context"]
    if ctx["scopes"] != {s: "enabled" for s in scopes}:
        raise AssertionError(f"scope status {ctx['scopes']}")
    if ctx["backend"] != "cuda" or ctx["device_kind"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"document not from the card: {ctx}")
    records = {r["name"]: r for r in doc["benchmarks"]}
    missing = [n for n in expected_instances() if n not in records]
    if missing:
        raise AssertionError(f"instances without a record: {missing}")
    dryrun = records["model/dryrun_rooflines"]
    if dryrun.get("skipped"):
        # as in the reference: no dry-run cells in the checkout, no row
        if glob.glob(os.path.join(DRYRUN_DIR, "*.json")) or \
                dryrun.get("skip_message") != \
                f"no dry-run results under {DRYRUN_DIR}":
            raise AssertionError(f"model/dryrun_rooflines: {dryrun}")
        log(f"model/dryrun_rooflines skipped: {dryrun['skip_message']}")
        del records["model/dryrun_rooflines"]
    for name, r in records.items():
        if r.get("error_occurred") or r.get("skipped"):
            raise AssertionError(f"{name}: {r.get('error_message')}")
        if "compile_time_s" not in r:
            raise AssertionError(f"{name}: no compile_time_s")
        if not (math.isfinite(r["real_time"]) and r["real_time"] > 0):
            raise AssertionError(f"{name}: real_time {r['real_time']}")
    for kernel, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {kernel}")
    # the mxu scope's bf16 cuda rows (n = 256..1024, fresh aligned
    # operands) are its only bf16 products: they take the tensor cores
    mxu_bf16 = [n for n in records
                if n.startswith("mxu/") and "backend:cuda" in n
                and "dtype:bf16" in n]
    if not mxu_bf16 or by_variant["matmul"]["wgmma"] == 0:
        raise AssertionError(f"mxu bf16 cuda rows {mxu_bf16} did not go "
                             f"through matmul's wgmma variant: "
                             f"{by_variant['matmul']}")
    # the nn scope's flash_attention_cuda rows are float32 with keys:
    # the ffma body
    nn_flash = [n for n in records if n.startswith("nn/flash_attention_cuda")]
    if not nn_flash or by_variant["flash_attention"]["ffma"] == 0:
        raise AssertionError(f"nn flash rows {nn_flash} did not go through "
                             f"flash attention's ffma variant: "
                             f"{by_variant['flash_attention']}")
    # the nn scope's ssd_scan_cuda rows (state size 64): the tiled body
    nn_ssd = [n for n in records if n.startswith("nn/ssd_scan_cuda")]
    if not nn_ssd or by_variant["ssd_scan"]["tiled_n64"] == 0:
        raise AssertionError(f"nn ssd rows {nn_ssd} did not go through the "
                             f"SSD kernel's tiled_n64 variant: "
                             f"{by_variant['ssd_scan']}")
    # the linalg scope's only kernel row is matmul_rect (float32: simt)
    rect = records.get("linalg/matmul_rect/m:512/n:256/k:256")
    rect_launches = per_scope.launched("linalg")
    if rect is None or rect_launches == 0:
        raise AssertionError(f"linalg/matmul_rect: record {rect}, simt "
                             f"launches while linalg ran {rect_launches}")
    by_variant["matmul"]["simt_linalg"] = rect_launches
    model_free = check_model_free(records)
    model_free["scope_walls_s"] = dict(per_scope.walls)
    log(f"main path: {len(records)} records from {', '.join(scopes)} in "
        f"{wall:.1f} s on {ctx['device_kind']}; launches {launches}; by "
        f"variant {by_variant} (simt_linalg: the linalg scope's, all "
        f"matmul_rect); last tile each: "
        + "; ".join(f"{k} {v} {tile_str(c)}"
                    for k, (_, v, c) in sorted(tuning.last_resolved.items())))
    log("main path scope walls (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_scope.walls.items()))
    for name, r in records.items():
        if name.startswith(("mxu/", "histo/", "nn/", "linalg/", "instr/",
                            "comm/all_reduce", "io/", "model/", "serve/")):
            log(f"  {name}: {r['real_time']:.3f} {r['time_unit']} "
                f"(compile {r['compile_time_s']:.3f} s)")
    return launches, by_variant, model_free


#: Run in a child process (the scopes register once a process): the
#: main path again under torch.profiler, CUDA activity only.  The union
#: of the device's activity spans against the window they cover gives
#: the device's idle share.
_IDLE_CHILD = """
import json, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.main import main
with tempfile.TemporaryDirectory() as tmp:
    argv = json.loads(sys.argv[2]) + ["--benchmark_out", tmp + "/run.json"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)
busy, reach = 0, None
for a, b in spans:
    if reach is None or a > reach:
        busy += b - a
        reach = b
    elif b > reach:
        busy += b - reach
        reach = b
window = reach - spans[0][0] if spans else 0
print(json.dumps({"rc": rc, "wall_s": wall, "device_spans": len(spans),
                  "busy_s": busy / 1e9, "window_s": window / 1e9,
                  "idle_share": 1 - busy / window if window else None}))
"""


def phase_idle_share() -> dict:
    """The device's idle share over the main path (phase 10 run again,
    profiled, in a child process: the profiler's own cost on the host
    is in this run's wall, not in phase 10's records)."""
    r = subprocess.run(
        [sys.executable, "-c", _IDLE_CHILD, os.path.join(ROOT, "src"),
         json.dumps(main_argv("")[:-2])],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"profiled main path failed: {r.stderr[-3000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    if got["rc"] != 0 or not got["device_spans"]:
        raise AssertionError(f"profiled main path: {got}")
    log(f"main path under torch.profiler: wall {got['wall_s']:.1f} s, "
        f"{got['device_spans']} device spans, busy {got['busy_s']:.3f} s of "
        f"a {got['window_s']:.3f} s window: idle share "
        f"{got['idle_share']:.4f}")
    return got


#: The run pipeline's scopes and their timing: each instance is
#: calibrated to fill ``PIPELINE_MIN_TIME`` seconds.
PIPELINE_SCOPES = ["mxu", "linalg"]
PIPELINE_MIN_TIME = "0.02"


def repro_torch(*args, timeout=600, env_extra=None
                ) -> subprocess.CompletedProcess:
    """``python -m repro_torch <args>`` in a child process from the
    checkout's ``src`` (with ``env_extra`` in its environment); its wall
    seconds on the result's ``wall_s``."""
    env = dict(os.environ, **(env_extra or {}), PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch", *args],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    r.wall_s = time.perf_counter() - t0
    return r


def checked_run(*args, ok=(0,)) -> subprocess.CompletedProcess:
    r = repro_torch(*args)
    if r.returncode not in ok:
        raise AssertionError(f"repro_torch {' '.join(args)} exited "
                             f"{r.returncode}:\n{r.stderr[-3000:]}")
    return r


def matmul_flops(name: str) -> float:
    """2·m·n·k of a matmul row, from its instance name's axes."""
    axes = dict(part.split(":", 1) for part in name.split("/")[2:])
    if name.startswith("mxu/matmul/"):
        return 2.0 * int(axes["n"]) ** 3
    if name.startswith("linalg/batched_matmul/"):
        return 2.0 * int(axes["b"]) * int(axes["n"]) ** 3
    return 2.0 * int(axes["m"]) * int(axes["n"]) * int(axes["k"])


def phase_pipeline() -> dict:
    """plan → run (inline, then ``--jobs 2`` at benchmark grain in a
    pool) → resume → compare → the cost meter, all through the CLI on
    the card."""
    scopes = [a for s in PIPELINE_SCOPES for a in ("--enable-scope", s)]
    card = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        # 1. plan lists what --benchmark_list_tests lists
        plan = checked_run("plan", *scopes, "--jobs", "2")
        planned = [line.split()[0] for line in plan.stdout.splitlines()
                   if line.startswith(tuple(f"{s}/" for s in PIPELINE_SCOPES))]
        listed = checked_run("run", *scopes, "--results-dir", "",
                             "--benchmark_list_tests").stdout.split()
        if planned != listed or not planned:
            raise AssertionError(f"plan {planned} != list {listed}")
        # 2. inline, then two workers at benchmark grain sharing the card
        inline_out = os.path.join(tmp, "inline.json")
        inline = checked_run("run", *scopes, "--benchmark_min_time",
                             PIPELINE_MIN_TIME, "--results-dir", "",
                             "--benchmark_out", inline_out)
        results = os.path.join(tmp, "results")
        par = checked_run("run", *scopes, "--benchmark_min_time",
                          PIPELINE_MIN_TIME, "--jobs", "2", "--shard-grain",
                          "benchmark", "--isolate", "pool", "--results-dir",
                          results, "--run-id", "pipe", "--benchmark_out",
                          os.path.join(tmp, "par.json"))
        run_dir = os.path.join(results, "pipe")
        with open(inline_out) as f:
            inline_doc = json.load(f)
        with open(os.path.join(run_dir, "merged.json")) as f:
            merged = json.load(f)
        names = [r["name"] for r in merged["benchmarks"]]
        if names != [r["name"] for r in inline_doc["benchmarks"]] \
                or names != listed:
            raise AssertionError(f"merged.json names {names} differ from "
                                 f"the inline run's")
        errors = [r["name"] for d in (inline_doc, merged)
                  for r in d["benchmarks"] if r.get("error_occurred")]
        if errors:
            raise AssertionError(f"records with errors: {errors}")
        ctx = merged["context"]
        if ctx["backend"] != "cuda" or ctx["device_kind"] != card \
                or ctx.get("run_id") != "pipe" \
                or [s["scope"] for s in ctx.get("shards", [])] != \
                PIPELINE_SCOPES or len(ctx.get("instances", [])) != len(names):
            raise AssertionError(f"merged context: { {k: ctx.get(k) for k in ('backend', 'device_kind', 'run_id', 'shards')} }")
        history = os.path.join(results, "history.jsonl")
        with open(history) as f:
            history_lines = [line for line in f if line.strip()]
        if len(history_lines) != len(names):
            raise AssertionError(f"history.jsonl: {len(history_lines)} "
                                 f"lines for {len(names)} instances")
        # 3. resume re-runs exactly the instance whose shard is gone
        with open(os.path.join(run_dir, "manifest.json")) as f:
            items = json.load(f)["items"]
        victim = next(i for i in items
                      if i["name"].startswith("linalg/matmul_rect/"))
        os.remove(os.path.join(run_dir, victim["shard"]))
        resume = checked_run("run", *scopes, "--benchmark_min_time",
                             PIPELINE_MIN_TIME, "--jobs", "2",
                             "--results-dir", results, "--resume", "pipe")
        with open(os.path.join(run_dir, "manifest.json")) as f:
            rerun = [i["name"] for i in json.load(f)["items"]
                     if not i.get("cached")]
        with open(os.path.join(run_dir, "merged.json")) as f:
            resumed = json.load(f)
        if rerun != [victim["name"]] or \
                [r["name"] for r in resumed["benchmarks"]] != names:
            raise AssertionError(f"resume re-ran {rerun}, expected only "
                                 f"{victim['name']}")
        # 4. compare pairs every row (exit 1 only flags timing)
        comp = checked_run("compare", inline_out,
                           os.path.join(run_dir, "merged.json"), ok=(0, 1))
        rows = [line.split()[0] for line in comp.stdout.splitlines()
                if line.startswith(tuple(f"{s}/" for s in PIPELINE_SCOPES))]
        unpaired = [line for line in comp.stdout.splitlines()
                    if line.endswith((" added", " removed"))]
        if sorted(rows) != sorted(names) or unpaired:
            raise AssertionError(f"compare paired {len(rows)} of "
                                 f"{len(names)} rows: {unpaired}")
        # 5. the cost meter: every matmul row counts 2·m·n·k
        cost_out = os.path.join(tmp, "cost.json")
        checked_run("run", "--enable-scope", "linalg", "--enable-scope",
                    "mxu", "--meters", "wall,cpu,costmodel",
                    "--benchmark_min_time", PIPELINE_MIN_TIME,
                    "--results-dir", "", "--benchmark_out", cost_out)
        with open(cost_out) as f:
            cost = {r["name"]: r for r in json.load(f)["benchmarks"]}
        matmuls = [n for n in cost if n.startswith(
            ("mxu/matmul/", "linalg/batched_matmul/", "linalg/matmul_rect/"))]
        wrong = {n: (cost[n].get("flops"), cost[n].get("bytes_accessed"))
                 for n in matmuls
                 if cost[n].get("flops") != matmul_flops(n)
                 or not cost[n].get("bytes_accessed", 0) > 0}
        kinds = {(b, d) for n in matmuls if n.startswith("mxu/")
                 for b in ("torch", "cuda") for d in ("f32", "bf16")
                 if f"backend:{b}/dtype:{d}/" in n}
        if wrong or len(kinds) != 4 or \
                "linalg/matmul_rect/m:512/n:256/k:256" not in matmuls:
            raise AssertionError(f"cost meter: wrong rows {wrong}, "
                                 f"backend/dtype pairs {sorted(kinds)}")
    facts = {
        "scopes": PIPELINE_SCOPES, "instances": len(names),
        "plan_equals_list": True, "merged_equals_inline": True,
        "context": {"backend": ctx["backend"],
                    "device_kind": ctx["device_kind"],
                    "run_id": ctx["run_id"], "shards": len(ctx["shards"])},
        "history_lines": len(history_lines),
        "resume_reran": rerun, "compare_rc": comp.returncode,
        "compare_rows": len(rows),
        "costmodel_matmul_rows": len(matmuls),
        "costmodel": {n: {k: cost[n].get(k) for k in
                          ("flops", "bytes_accessed", "arithmetic_intensity",
                           "flops_per_second")}
                      for n in sorted(matmuls)},
        "inline_wall_s": inline.wall_s, "jobs2_wall_s": par.wall_s,
        "resume_wall_s": resume.wall_s,
    }
    log(f"pipeline: {len(names)} instances of {', '.join(PIPELINE_SCOPES)}; "
        f"inline wall {inline.wall_s:.1f} s, --jobs 2 (pool, benchmark "
        f"grain) {par.wall_s:.1f} s, resume of one instance "
        f"{resume.wall_s:.1f} s; compare exit {comp.returncode}; "
        f"{len(matmuls)} matmul rows at 2mnk flops")
    return facts


#: The incremental loop's scopes: one with no kernel, and one whose
#: family is tunable on matmul; its runs and artifacts under build/.
INCREMENTAL_SCOPES = ["example", "mxu"]
INCREMENTAL_DIR = os.path.join(ROOT, "build", "incremental")


def phase_incremental() -> dict:
    """Fingerprints, ``--since`` delta runs, ``ci``, ``store`` and
    ``query`` through the CLI on the card, with a tuned artifact written
    for this card between two delta runs."""
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.scope import ScopeManager
    card = torch.cuda.get_device_name(0)
    shutil.rmtree(INCREMENTAL_DIR, ignore_errors=True)
    tuned_dir = os.path.join(INCREMENTAL_DIR, "tuned")
    results = os.path.join(INCREMENTAL_DIR, "results")
    env = {tuning.DIR_ENV: tuned_dir}
    scopes = [a for s in INCREMENTAL_SCOPES for a in ("--enable-scope", s)]
    common = [*scopes, "--results-dir", results, "--benchmark_min_time",
              PIPELINE_MIN_TIME]
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load([f"repro_torch.scopes.{s}_scope" for s in INCREMENTAL_SCOPES])
    mgr.register_all()
    benches = mgr.registry.all()
    names = sorted(n for b in benches for n, _ in b.instances())
    tunable = sorted(n for b in benches
                     if b.tunable is not None and b.tunable.kernel == "matmul"
                     for n, _ in b.instances())

    def run(run_id, *extra):
        r = repro_torch("run", *common, "--run-id", run_id, *extra,
                        "--benchmark_out", os.devnull, env_extra=env)
        if r.returncode != 0:
            raise AssertionError(f"run {run_id} exited {r.returncode}:\n"
                                 f"{r.stderr[-3000:]}")
        with open(os.path.join(results, run_id, "merged.json")) as f:
            doc = json.load(f)
        live = sorted(b["name"] for b in doc["benchmarks"]
                      if not b.get("cached"))
        cached = sorted(b["name"] for b in doc["benchmarks"]
                        if b.get("cached"))
        errors = [b["name"] for b in doc["benchmarks"]
                  if b.get("error_occurred")]
        if errors:
            raise AssertionError(f"run {run_id}: records with errors "
                                 f"{errors}")
        return r, doc, live, cached

    def history():
        with open(os.path.join(results, "history.jsonl")) as f:
            return [json.loads(line) for line in f if line.strip()]

    # 1. a measured run stamps fingerprints on its context and records
    first, doc, live, cached = run("a")
    fingerprints = doc["context"].get("fingerprints", {})
    if live != names or cached or sorted(fingerprints) != names:
        raise AssertionError(f"run a: measured {live}, cached {cached}, "
                             f"fingerprints for {sorted(fingerprints)}")
    recs = [r for r in history() if r["run_id"] == "a"]
    if len(recs) != len(names) or any(
            r.get("fingerprint") != fingerprints[r["name"]] for r in recs):
        raise AssertionError(f"history of run a: {recs}")
    # 2. nothing changed: --since plans 0 instances, replays every record
    since, doc, live, cached = run("b", "--since")
    if live or cached != names:
        raise AssertionError(f"--since measured {live}, cached {cached}")
    # 3. a tuned matmul artifact for this card: exactly the instances of
    #    the families tunable on matmul re-measure
    tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 128, "bk": 64},
                                  "source": {"run_id": "chip_smoke"}},
                       device=card, variant="wgmma",
                       path=os.path.join(tuned_dir, "matmul", "tuned.json"))
    retuned, doc, live, cached = run("c", "--since")
    if live != tunable or cached != sorted(set(names) - set(tunable)):
        raise AssertionError(f"after the artifact --since measured {live} "
                             f"(expected {tunable}), cached {cached}")
    # 4. ci over the same scopes: nothing stale, gate clean
    ci = repro_torch("ci", *common, "--run-id", "d", "--no-report",
                     env_extra=env)
    if ci.returncode != 0 or \
            f"0 measured, {len(names)} cached" not in ci.stdout:
        raise AssertionError(f"ci exited {ci.returncode}: {ci.stdout} "
                             f"{ci.stderr[-3000:]}")
    # 5. the store index, 6. a query through it, 7. coverage
    index = checked_run("store", "index", "--results-dir", results)
    if not os.path.exists(os.path.join(results, "history.db")):
        raise AssertionError(f"store index wrote no history.db: "
                             f"{index.stdout}")
    query = checked_run("query", "--results-dir", results, "--scope", "mxu",
                        "--format", "jsonl")
    rows = [json.loads(line) for line in query.stdout.splitlines()
            if line.strip()]
    mxu_recs = [r for r in history() if r["name"].startswith("mxu/")]
    if not rows or rows != mxu_recs:
        raise AssertionError(f"query --scope mxu: {len(rows)} rows, "
                             f"history has {len(mxu_recs)}")
    status = repro_torch("store", "status", "--results-dir", results,
                         "--coverage", "--format", "json", env_extra=env)
    if status.returncode != 0:
        raise AssertionError(f"store status exited {status.returncode}: "
                             f"{status.stderr[-3000:]}")
    coverage = json.loads(status.stdout)["coverage"]
    counts = {s: coverage["scopes"].get(s) for s in INCREMENTAL_SCOPES}
    want = {s: {"fresh": sum(n.startswith(s + "/") for n in names),
                "stale": 0, "never": 0} for s in INCREMENTAL_SCOPES}
    if counts != want:
        raise AssertionError(f"coverage {counts}, expected {want}")
    facts = {
        "scopes": INCREMENTAL_SCOPES, "instances": len(names),
        "fingerprinted_records": len(recs),
        "since_planned": 0, "since_cached": len(names),
        "artifact": {"kernel": "matmul", "device": card,
                     "variant": "wgmma"},
        "retuned_measured": len(tunable),
        "retuned_cached": len(names) - len(tunable),
        "ci_rc": ci.returncode, "store_index_rc": index.returncode,
        "query_rows": len(rows), "coverage": counts,
        "first_run_wall_s": first.wall_s, "since_run_wall_s": since.wall_s,
        "retuned_run_wall_s": retuned.wall_s, "ci_wall_s": ci.wall_s,
    }
    log(f"incremental: {len(names)} instances of "
        f"{', '.join(INCREMENTAL_SCOPES)}; first run {first.wall_s:.1f} s, "
        f"--since (0 planned) {since.wall_s:.1f} s, after a {card} matmul "
        f"artifact {len(tunable)} re-measured in {retuned.wall_s:.1f} s; "
        f"ci exit {ci.returncode} in {ci.wall_s:.1f} s; query {len(rows)} "
        f"mxu rows; coverage {counts}")
    return facts


#: The tune phase: tunable families of the main path's scopes (the
#: matmul and flash attention kernels' tiles; phase 18 tunes RMSNorm's
#: rows), with the arguments that narrow each instance, searched
#: through the CLI.
TUNE_FAMILIES = [("mxu/matmul", ["--param", "n=1024"]),
                 ("nn/flash_attention_cuda", [])]
TUNE_ARGS = ["--budget", "8", "--benchmark_min_time", "0.02", "--no-report"]
#: Artifacts and trial records of the tune phase: under build/, never in
#: the source tree.
TUNE_DIR = os.path.join(ROOT, "build", "tune")


def source_artifacts() -> dict:
    """Every ``tuned.json`` in the port's source tree, with its bytes."""
    found = {}
    for path in glob.glob(os.path.join(ROOT, "src", "repro_torch",
                                       "kernels", "*", "tuned.json")):
        with open(path, "rb") as f:
            found[path] = f.read()
    return found


def phase_tune() -> list:
    """``python -m repro_torch tune`` for every family of
    ``TUNE_FAMILIES`` on the card, artifacts under ``TUNE_DIR``."""
    card = torch.cuda.get_device_name(0)
    before = source_artifacts()
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    tuned_dir = os.path.join(TUNE_DIR, "tuned")
    results = os.path.join(TUNE_DIR, "results")
    rows = []
    for family, extra in TUNE_FAMILIES:
        run_id = family.replace("/", "_")
        r = repro_torch("tune", family, *TUNE_ARGS, *extra, "--results-dir",
                        results, "--run-id", run_id,
                        env_extra={tuning.DIR_ENV: tuned_dir})
        if r.returncode != 0:
            raise AssertionError(f"tune {family} exited {r.returncode}:\n"
                                 f"{r.stderr[-3000:]}")
        with open(os.path.join(results, run_id, "tune.json")) as f:
            summary = json.load(f)
        trials = summary["search"]["trials"]
        failed = [t for t in trials if t.get("error")]
        if failed:
            raise AssertionError(f"tune {family}: failed trials {failed}")
        kernel = summary["kernel"]
        with open(os.path.join(tuned_dir, kernel, "tuned.json")) as f:
            entries = json.load(f)["devices"][card]
        variant, entry = next(
            (v, e) for v, e in entries.items()
            if e["source"]["run_id"] == run_id)
        base, best = summary["baseline"], summary["best"]
        if entry["config"] != best["params"]:
            raise AssertionError(f"tune {family}: artifact {entry} is not "
                                 f"the winner {best}")
        row = {"family": family, "instance": summary["instance"],
               "kernel": kernel, "variant": variant,
               "builtin": base["params"],
               "builtin_ms": base["metrics"]["real_time_s"] * 1e3,
               "winner": best["params"],
               "winner_ms": best["metrics"]["real_time_s"] * 1e3,
               "speedup": summary["speedup"], "trials": len(trials),
               "budget": 8, "wall_s": r.wall_s,
               "trial_ms": [[t["params"], t["metrics"]["real_time_s"] * 1e3]
                            for t in trials]}
        log(f"tune {family} ({variant}) at {row['instance']}: builtin "
            f"{tile_str(row['builtin'])} {row['builtin_ms']:.4f} ms, "
            f"winner {tile_str(row['winner'])} {row['winner_ms']:.4f} ms, "
            f"speedup {row['speedup']:.3f}x, {row['trials']} trials, "
            f"{r.wall_s:.1f} s")
        rows.append(row)
    if source_artifacts() != before:
        raise AssertionError("the tune phase wrote a tuned.json into the "
                             "source tree")
    return rows


#: The host steps of one wrapper call, each timed alone over
#: ``HOST_CALLS`` calls (host clock, the device synchronised at the end
#: of each run).  Shapes whose device time stays below the host's, so
#: that the launch queue never holds the host back.
HOST_CALLS = 10000
HOST_HISTOGRAM = (1 << 20, 4096)
HOST_FLASH = (1, 64, 4, 2, 64)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_host_path() -> dict:
    """Split a wrapper call's host time: the public function (argument
    checks, and within them for flash the tile's resolution through the
    tuning registry), the custom_op dispatch, and inside the launch
    function the output allocation, the device and stream lookup, the
    library lookup, the ctypes call (which enqueues the launches) and
    ``_build.check``."""
    dev = torch.device("cuda", 0)

    def lookup():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    n, bins = HOST_HISTOGRAM
    x = torch.randint(0, bins, (n,), device=dev, dtype=torch.int32)
    hlib = _build.load("histogram", histogram_ops._SIGNATURES)
    fits = histogram_ops.max_clusters(hlib, 0, bins)
    h_out = torch.empty(bins, dtype=torch.int32, device=dev)
    h_args = (x.data_ptr(), n, h_out.data_ptr(), bins,
              histogram_ops.grid_size(n, fits), lookup())
    B, S, H, K, D = HOST_FLASH
    q, k, v = (torch.randn(sh, device=dev) for sh in
               ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    flib = _build.load("flash_attention", flash_ops._SIGNATURES)
    f_out = torch.empty_like(q)
    part = torch.empty(flash_ops.FFMA_SPLITS * B * S * H * (D + 2),
                       device=dev)
    tile = flash_ops.resolve_tile(q)[2]
    bq, bk = tile["bq"], tile["bk"]
    f_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), f_out.data_ptr(),
              part.data_ptr(), B, S, S, H, K, D, 1, 1.0 / math.sqrt(D),
              bq, bk, lookup())
    ffma = getattr(flib, flash_ops._SYMBOLS["ffma", torch.float32])
    steps = {
        "histogram": {
            "call": lambda: histogram(x, bins),
            "op": lambda: torch.ops.repro_torch.histogram(x, bins),
            "launch": lambda: histogram_ops._launch(x, bins),
            "alloc": lambda: torch.empty(bins, dtype=torch.int32,
                                         device=dev),
            "lookup": lookup,
            "load": lambda: _build.load("histogram",
                                        histogram_ops._SIGNATURES),
            "ctypes": lambda: hlib.histogram_i32(*h_args),
            "check": lambda: _build.check(hlib, 0, "histogram")},
        "flash_attention": {
            "call": lambda: flash_attention(q, k, v),
            "op": lambda: torch.ops.repro_torch.flash_attention(
                q, k, v, True, bq, bk),
            "resolve": lambda: flash_ops.resolve_tile(q),
            "launch": lambda: flash_ops._launch(q, k, v, True, bq, bk),
            "alloc": lambda: (torch.empty_like(q), torch.empty(
                part.numel(), device=dev)),
            "lookup": lookup,
            "load": lambda: _build.load("flash_attention",
                                        flash_ops._SIGNATURES),
            "ctypes": lambda: ffma(*f_args),
            "check": lambda: _build.check(flib, 0, "flash_attention")}}
    split = {}
    for name, fns in steps.items():
        t = {step: host_us(fn) for step, fn in fns.items()}
        split[name] = {
            "us_per_call": t["call"],
            "argument_checks": t["call"] - t["op"],
            "custom_op_dispatch": t["op"] - t["launch"],
            "output_allocation": t["alloc"],
            "device_and_stream_lookup": t["lookup"],
            "library_lookup": t["load"],
            "ctypes_call": t["ctypes"],
            "build_check": t["check"],
            "rest_of_launch": t["launch"] - t["alloc"] - t["lookup"]
            - t["load"] - t["ctypes"] - t["check"]}
        if "resolve" in t:
            # the tile's resolution (device key, registry, validation,
            # shared-memory lookup): part of the argument checks
            split[name]["tuning_resolve"] = t["resolve"]
        log(f"host path {name} ({HOST_CALLS} calls each, us a call): "
            + ", ".join(f"{k} {v:.2f}" for k, v in split[name].items()))
    return split


#: The full-width models of the model phase: llama3.2-1b and mamba2-780m
#: at their published widths and depths, one batch of ``MODEL_BATCH``
#: rows of ``MODEL_SEQ`` random tokens (train_4k's sequence, the batch
#: cut from 256 to what one step on one card holds), at least
#: ``MODEL_STEPS`` timed steps after a warm one.
MODEL_ARCHS = ("llama3.2-1b", "mamba2-780m")
MODEL_BATCH, MODEL_SEQ, MODEL_STEPS = 2, 4096, 5
#: The bfloat16 loss against the float32 loss of the same weights and
#: tokens on the card.
MODEL_BF16_TOL = 5e-2
#: The card's float32 run against the port's CPU run (same weights and
#: tokens, B 1 x S ``MODEL_CPU_SEQ``): the loss (absolute) and the
#: logits (largest absolute difference).
MODEL_CPU_SEQ = 256
MODEL_CPU_LOSS_TOL, MODEL_CPU_LOGITS_TOL = 1e-4, 5e-3


def causal_attention_flops(cfg, B, S) -> float:
    """A forward's causal attention: 2·B·S²·H·hd (QKᵀ and PV, halved by
    the mask) per attention layer."""
    attn_layers = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    return attn_layers * 2.0 * B * S * S * cfg.num_heads * cfg.hd


def forward_flops(cfg, B, S) -> float:
    """A forward's model FLOPs: the roofline's 2·N·tokens
    (``repro_torch.roofline.model_flops``) plus causal attention."""
    from repro_torch.roofline import model_flops
    return model_flops(cfg, B * S, "prefill") \
        + causal_attention_flops(cfg, B, S)


def profile_step(fn, top: int = 8, ops: bool = True) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the device's busy
    time and idle share over the call's wall, and (with ``ops``, which
    traces the host's ops too) the ``top`` aten ops by the device time
    of the kernels they launched (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, reach = 0, None
    for a, b in spans:
        if reach is None or a > reach:
            busy += b - a
            reach = b
        elif b > reach:
            busy += b - reach
            reach = b
    by_op = sorted(((e.key, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.key.startswith("aten::")
                    and e.self_device_time_total > 0),
                   key=lambda kv: -kv[1]) if ops else []
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e6,
            "idle_share": 1 - busy / 1e9 / wall, "kernels": len(spans),
            "device_ms_by_op": dict(by_op[:top])}


def phase_models(hw: dict) -> list:
    """Each of ``MODEL_ARCHS`` at full width on the card through the
    port's model API (weights from its ``init``, seeded): the bfloat16
    loss step's median ms, tokens/s, model FLOPs, ``mfu`` and peak
    memory; the bfloat16 loss against the float32 one (and with cuBLAS's
    bf16 reduced-precision reduction off, to see what it moves); and a
    float32 run at B 1 against the port's CPU run on the same weights."""
    from repro_torch.models import build, get_config
    from repro_torch.models import tree
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products must not run in TF32 here")
    rows = []
    for arch in MODEL_ARCHS:
        cfg = get_config(arch)
        api, api32 = build(cfg), build(cfg.override(dtype="float32"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = api.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the tree's own count; the config's (the FLOPs' N) counts two
        # norms a layer, where a Mamba2 block holds one
        n_weights = sum(t.numel() for _, t in tree.leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (MODEL_BATCH, MODEL_SEQ),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        batch = {"tokens": tokens}

        def step(a=api, b=batch):
            with torch.inference_mode():
                return a.loss(params, b)[0]
        torch.cuda.reset_peak_memory_stats()
        loss = step()                                   # warm
        torch.cuda.synchronize()
        times = []
        for _ in range(MODEL_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        ms = sorted(times)[len(times) // 2]
        profiled = profile_step(step)
        flops = forward_flops(cfg, MODEL_BATCH, MODEL_SEQ)
        loss32 = step(api32)
        reduced = torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
        try:
            loss_full_sums = step()
        finally:
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = reduced
        loss, loss32, loss_full_sums = (float(loss), float(loss32),
                                        float(loss_full_sums))
        if not (math.isfinite(loss) and abs(loss - loss32)
                <= MODEL_BF16_TOL):
            raise AssertionError(f"{arch}: bf16 loss {loss} against float32 "
                                 f"{loss32} (tol {MODEL_BF16_TOL})")
        # float32 at B 1 x S MODEL_CPU_SEQ: the card against the CPU
        small = {"tokens": tokens[:1, :MODEL_CPU_SEQ].contiguous()}
        with torch.inference_mode():
            card_logits = api32.logits(params, small)[0].cpu()
            card_loss = float(api32.loss(params, small)[0])
        cpu_params = _to_cpu(params)
        del params
        torch.cuda.empty_cache()
        small_cpu = {"tokens": small["tokens"].cpu()}
        t0 = time.perf_counter()
        with torch.inference_mode():
            cpu_logits = api32.logits(cpu_params, small_cpu)[0]
            cpu_loss = float(api32.loss(cpu_params, small_cpu)[0])
        cpu_s = time.perf_counter() - t0
        del cpu_params
        logits_err = (card_logits - cpu_logits).abs().max().item()
        loss_err = abs(card_loss - cpu_loss)
        if not (loss_err <= MODEL_CPU_LOSS_TOL
                and logits_err <= MODEL_CPU_LOGITS_TOL):
            raise AssertionError(
                f"{arch}: float32 on the card against the CPU: loss "
                f"{card_loss} vs {cpu_loss} ({loss_err:.3g}, tol "
                f"{MODEL_CPU_LOSS_TOL}), logits max_abs_err "
                f"{logits_err:.3g} (tol {MODEL_CPU_LOGITS_TOL})")
        row = {
            "arch": arch, "family": cfg.family, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "params": cfg.num_params(),
            "weights_in_tree": n_weights,
            "batch": MODEL_BATCH, "seq": MODEL_SEQ, "dtype": cfg.dtype,
            "loss": loss, "loss_float32": loss32,
            "loss_bf16_full_sums": loss_full_sums,
            "ms": ms, "step_ms": times,
            "tokens_per_s": MODEL_BATCH * MODEL_SEQ / (ms / 1e3),
            "model_flops": flops,
            "mfu": flops / (ms / 1e3 * hw["peak_bf16_flops"]),
            "peak_bf16_flops": hw["peak_bf16_flops"],
            "max_memory_allocated": peak, "init_s": init_s,
            "profiled_step": profiled,
            "cpu_check": {"batch": 1, "seq": MODEL_CPU_SEQ,
                          "loss_card": card_loss, "loss_cpu": cpu_loss,
                          "loss_abs_err": loss_err,
                          "logits_max_abs_err": logits_err,
                          "cpu_s": cpu_s},
            "card": hw["card"],
        }
        log(f"model {arch} ({cfg.family}, {cfg.num_layers} layers, d "
            f"{cfg.d_model}, {cfg.num_params():,} params by the config, "
            f"{n_weights:,} in the tree) B{MODEL_BATCH} x "
            f"S{MODEL_SEQ} {cfg.dtype} on {hw['card']}: loss {loss:.6f} (float32 "
            f"{loss32:.6f}, bf16 with full float32 sums {loss_full_sums:.6f})"
            f"; median {ms:.2f} ms a step over {MODEL_STEPS} "
            f"({', '.join(f'{t:.2f}' for t in times)}); "
            f"{row['tokens_per_s']:.0f} tokens/s; {flops:.4g} model FLOPs; "
            f"mfu {row['mfu']:.4f}; max_memory_allocated {peak / 2**30:.2f} "
            f"GiB; float32 B1 x S{MODEL_CPU_SEQ} against the CPU: loss "
            f"{loss_err:.3g} (tol {MODEL_CPU_LOSS_TOL}), logits "
            f"{logits_err:.3g} (tol {MODEL_CPU_LOGITS_TOL})")
        log(f"  {arch} profiled step: wall {profiled['wall_ms']:.2f} ms, "
            f"device busy {profiled['device_busy_ms']:.2f} ms (idle share "
            f"{profiled['idle_share']:.4f}), {profiled['kernels']} kernels;"
            f" device ms by op: " + ", ".join(
                f"{k} {v:.2f}" for k, v in
                profiled["device_ms_by_op"].items()))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


#: The serve phase: llama3.2-1b as ``get_config`` gives it (16 layers,
#: d_model 2048, 32 heads, 8 KV heads, head_dim 64, d_ff 8192, vocab
#: 128,256, tied embeddings), served by the port's engine in bfloat16
#: with a bfloat16 cache of ``SERVE_CONFIG``'s slots and positions.
SERVE_ARCH = "llama3.2-1b"
SERVE_CONFIG = dict(max_batch=8, max_len=4096, prompt_buckets=(128, 512, 2048))
#: Open-loop traffic, all from ``SERVE_SEED``: ``SERVE_REQUESTS`` Poisson
#: arrivals at ``SERVE_RATE`` req/s (the port's ``arrivals.generate``),
#: prompt lengths uniform in ``SERVE_PROMPT_LENS``, ``SERVE_MAX_TOKENS``
#: tokens each; then a closed batch of ``max_batch`` requests of
#: ``SERVE_CLOSED_PROMPT`` tokens submitted at once, to time the decode
#: step with every slot live.
SERVE_SEED = 0
SERVE_REQUESTS, SERVE_RATE, SERVE_MAX_TOKENS = 32, 4.0, 128
SERVE_PROMPT_LENS = (64, 2000)
SERVE_CLOSED_PROMPT = 500
#: Check (a), float32 with a float32 cache: three requests of these
#: prompt lengths, ``SERVE_CHECK_TOKENS`` tokens each, through an engine
#: of ``SERVE_CHECK_CONFIG`` against per-request prefill plus uniform
#: ``decode_step``: the same greedy tokens.  Check (b): the float32
#: prefill and first decode step against the float32 teacher-forced
#: logits within ``MODEL_CPU_LOGITS_TOL``.  (c), logged only: the bf16
#: engine path's first decode logits against the bf16 teacher-forced
#: ones, beside the reference test's atol and rtol ``SERVE_BF16_TOL``.
SERVE_CHECK_CONFIG = dict(max_batch=2, max_len=512, prompt_buckets=(128, 512))
SERVE_CHECK_PROMPTS, SERVE_CHECK_TOKENS = (37, 300, 90), 16
SERVE_BF16_TOL = (5e-2, 1e-2)


def greedy_tokens(api, params, prompt, n_tokens, max_len, cache_dtype):
    """One request alone: prefill, then uniform ``decode_step``s."""
    toks = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")[None]
    with torch.inference_mode():
        cache = api.init_cache(1, max_len, cache_dtype, device="cuda")
        logits, cache = api.prefill(params, {"tokens": toks}, cache)
        out = [int(logits[0, -1].argmax())]
        for _ in range(n_tokens - 1):
            logits, cache = api.decode_step(
                params, torch.tensor([[out[-1]]], dtype=torch.int32,
                                     device="cuda"), cache)
            out.append(int(logits[0, 0].argmax()))
    return out


def serve_checks(api, api32, params, gen) -> dict:
    """Checks (a) and (b) (each raises) and (c) (logged) of the serve
    phase, on the full-width weights."""
    from repro_torch.models import transformer
    from repro_torch.serve import ServeConfig, ServeEngine
    V = api.cfg.vocab_size
    prompts = [torch.randint(1, V, (n,), generator=gen).numpy()
               for n in SERVE_CHECK_PROMPTS]
    max_len = SERVE_CHECK_CONFIG["max_len"]
    refs = [greedy_tokens(api32, params, p, SERVE_CHECK_TOKENS, max_len,
                          torch.float32) for p in prompts]
    eng = ServeEngine(api32, params, ServeConfig(
        **SERVE_CHECK_CONFIG, cache_dtype=torch.float32))
    reqs = [eng.submit(p, max_tokens=SERVE_CHECK_TOKENS) for p in prompts]
    eng.run()
    got = [r.output for r in reqs]
    if got != refs:
        raise AssertionError(f"serve (a): float32 engine tokens {got} "
                             f"against per-request generation {refs}")
    # (b) and (c): a prompt and its next token, teacher-forced
    n = SERVE_CHECK_PROMPTS[1]
    seq = torch.as_tensor(prompts[1].tolist() + [refs[1][0]],
                          dtype=torch.int32, device="cuda")[None]
    errs = {}
    with torch.inference_mode():
        full32 = api32.logits(params, {"tokens": seq})[0]
        cache = api32.init_cache(1, max_len, torch.float32, device="cuda")
        lp, cache = api32.prefill(params, {"tokens": seq[:, :n]}, cache)
        ld, cache = api32.decode_step(params, seq[:, n:], cache)
        errs["prefill"] = (lp[:, 0] - full32[:, n - 1]).abs().max().item()
        errs["decode"] = (ld[:, 0] - full32[:, n]).abs().max().item()
        del full32
        # (c) the engine's own bf16 path: a bucket-padded one-row
        # prefill, then one ragged decode step at the row's clock
        full16 = api.logits(params, {"tokens": seq})[0][:, n]
        bucket = SERVE_CONFIG["prompt_buckets"][1]
        padded = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
        padded[:, :n] = seq[:, :n]
        cache = api.init_cache(1, SERVE_CONFIG["max_len"], device="cuda")
        _, cache = api.prefill(params, {"tokens": padded}, cache,
                               logit_pos=n - 1)
        cache["pos"] = torch.tensor([n], dtype=torch.int32, device="cuda")
        ld16, _ = transformer.decode_step_ragged(api.cfg, params,
                                                 seq[:, n:], cache)
        del cache
    atol, rtol = SERVE_BF16_TOL
    bf16_err = (ld16[:, 0] - full16).abs().max().item()
    bf16_units = ((ld16[:, 0] - full16).abs()
                  / (atol + rtol * full16.abs())).max().item()
    if not max(errs.values()) <= MODEL_CPU_LOGITS_TOL:
        raise AssertionError(f"serve (b): float32 prefill/decode against "
                             f"teacher forcing {errs} (tol "
                             f"{MODEL_CPU_LOGITS_TOL})")
    log(f"serve checks: (a) float32 engine, {len(prompts)} requests x "
        f"{SERVE_CHECK_TOKENS} tokens (prompts {SERVE_CHECK_PROMPTS}), the "
        f"same greedy tokens as per-request decode_step; (b) float32 "
        f"prefill {errs['prefill']:.3g}, first decode {errs['decode']:.3g} "
        f"from teacher forcing (tol {MODEL_CPU_LOGITS_TOL}); (c) bf16 "
        f"engine path's first decode logits {bf16_err:.3g} from teacher "
        f"forcing, {bf16_units:.3g} of the reference test's atol {atol} "
        f"rtol {rtol} (logged only)")
    return {"a_requests": len(prompts), "a_tokens": SERVE_CHECK_TOKENS,
            "b_prefill_max_abs_err": errs["prefill"],
            "b_decode_max_abs_err": errs["decode"],
            "b_tol": MODEL_CPU_LOGITS_TOL,
            "c_bf16_decode_max_abs_err": bf16_err,
            "c_bf16_units_of_tol": bf16_units,
            "c_bf16_tol": {"atol": atol, "rtol": rtol}}


def phase_serve(hw: dict) -> dict:
    """llama3.2-1b at full width served by the port's engine on the card:
    the float32 checks, prefill ms per bucket, open-loop TTFT and
    latency, output tokens/s, the decode step with every slot live
    against its bound, a profiled step and peak memory."""
    from repro_torch.core.arrivals import generate
    from repro_torch.core.quantile import percentile
    from repro_torch.models import build, get_config, tree
    from repro_torch.serve import ServeConfig, ServeEngine
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products must not run in TF32 here")
    cfg = get_config(SERVE_ARCH)
    api, api32 = build(cfg), build(cfg.override(dtype="float32"))
    params = api.init(torch.Generator(device="cuda").manual_seed(SERVE_SEED))
    n_weights = sum(t.numel() for _, t in tree.leaves(params))
    gen = torch.Generator().manual_seed(SERVE_SEED)
    checks = serve_checks(api, api32, params, gen)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    V, scfg = cfg.vocab_size, ServeConfig(**SERVE_CONFIG)

    def prompt(n):
        return torch.randint(1, V, (n,), generator=gen).numpy()
    engine = ServeEngine(api, params, scfg)
    cache_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree.leaves(engine.cache))
    for b in scfg.prompt_buckets:                  # warm every bucket
        engine.submit(prompt(b), max_tokens=2)
    engine.run()
    prefill_ms = {}
    for b in scfg.prompt_buckets:
        toks = torch.as_tensor(prompt(b), device="cuda")[None]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                c = api.init_cache(1, scfg.max_len, device="cuda")
                api.prefill(params, {"tokens": toks}, c, logit_pos=b - 1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prefill_ms[b] = sorted(times)[1]
    # open loop
    offsets = generate("poisson", SERVE_RATE, SERVE_REQUESTS, SERVE_SEED)
    lo, hi = SERVE_PROMPT_LENS
    lens = torch.randint(lo, hi + 1, (SERVE_REQUESTS,), generator=gen)
    prompts = [prompt(int(n)) for n in lens]
    engine.queue_depth_log.clear()
    done, idx, steps = [], 0, 0
    t0 = time.perf_counter()
    while idx < len(prompts) or engine.queue or \
            any(s is not None for s in engine.slots):
        now = time.perf_counter() - t0
        while idx < len(prompts) and offsets[idx] <= now:
            engine.submit(prompts[idx], max_tokens=SERVE_MAX_TOKENS,
                          submitted_at=t0 + offsets[idx])
            idx += 1
        if not (engine.queue or any(s is not None for s in engine.slots)):
            time.sleep(1e-4)                   # idle until the next arrival
            continue
        done.extend(engine.step())
        steps += 1
    open_wall = time.perf_counter() - t0
    ttft = [r.first_token_at - r.submitted_at for r in done]
    lat = [r.done_at - r.submitted_at for r in done]
    out_tokens = sum(len(r.output) for r in done)
    if len(done) != SERVE_REQUESTS or any(
            len(r.output) != SERVE_MAX_TOKENS for r in done):
        raise AssertionError(f"serve: {len(done)} of {SERVE_REQUESTS} "
                             f"requests finished, outputs "
                             f"{sorted({len(r.output) for r in done})}")
    depth = sum(engine.queue_depth_log) / len(engine.queue_depth_log)
    # closed batch: every slot live
    for _ in range(scfg.max_batch):
        engine.submit(prompt(SERVE_CLOSED_PROMPT), max_tokens=SERVE_MAX_TOKENS)
    engine.step()                              # admits all, first decode
    step_ms, profiled = [], None
    while all(s is not None for s in engine.slots):
        if len(step_ms) == SERVE_MAX_TOKENS // 2 and profiled is None:
            profiled = profile_step(engine.step)
            continue
        ts = time.perf_counter()
        engine.step()
        step_ms.append((time.perf_counter() - ts) * 1e3)
    decode_ms = sorted(step_ms)[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    bound_bytes = 2 * n_weights + cache_bytes
    bound_ms = bound_bytes / hw["hbm_bandwidth"] * 1e3
    del engine, params
    torch.cuda.empty_cache()
    row = {
        "arch": SERVE_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "weights_in_tree": n_weights, "dtype": cfg.dtype,
        "cache_dtype": str(scfg.cache_dtype).replace("torch.", ""),
        **{k: v for k, v in SERVE_CONFIG.items()},
        "checks": checks,
        "prefill_ms": prefill_ms,
        "open_loop": {
            "requests": SERVE_REQUESTS, "rate": SERVE_RATE,
            "prompt_lens": list(SERVE_PROMPT_LENS),
            "max_tokens": SERVE_MAX_TOKENS, "wall_s": open_wall,
            "steps": steps, "ttft_p50_s": percentile(ttft, 0.50),
            "ttft_p99_s": percentile(ttft, 0.99),
            "latency_p50_s": percentile(lat, 0.50),
            "latency_p99_s": percentile(lat, 0.99),
            "output_tokens": out_tokens,
            "tokens_per_s": out_tokens / (max(r.done_at for r in done) - t0),
            "queue_depth_mean": depth},
        "decode_step_ms": decode_ms, "decode_steps_timed": len(step_ms),
        "decode_step_bound_ms": bound_ms,
        "decode_step_bound_bytes": bound_bytes,
        "closed_tokens_per_s": scfg.max_batch / (decode_ms / 1e3),
        "cache_bytes": cache_bytes, "max_memory_allocated": peak,
        "profiled_step": profiled, "card": hw["card"],
    }
    ol = row["open_loop"]
    log(f"serve {SERVE_ARCH} ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{n_weights:,} weights) bf16, cache {cache_bytes:,} B bf16 "
        f"(B{scfg.max_batch} x {scfg.max_len}) on {hw['card']}: prefill ms "
        + ", ".join(f"{b}: {t:.2f}" for b, t in prefill_ms.items())
        + f"; open loop {SERVE_REQUESTS} poisson at {SERVE_RATE}/s x "
        f"{SERVE_MAX_TOKENS} tokens in {open_wall:.2f} s, {steps} steps: "
        f"TTFT p50 {ol['ttft_p50_s'] * 1e3:.1f} ms p99 "
        f"{ol['ttft_p99_s'] * 1e3:.1f} ms, latency p50 "
        f"{ol['latency_p50_s']:.3f} s p99 {ol['latency_p99_s']:.3f} s, "
        f"{ol['tokens_per_s']:.0f} output tokens/s, queue depth mean "
        f"{depth:.2f}; decode step with {scfg.max_batch} live "
        f"{decode_ms:.3f} ms (median of {len(step_ms)}; bound {bound_ms:.3f}"
        f" ms: {bound_bytes:,} B of bf16 weights and one cache read); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"  serve profiled decode step: wall {profiled['wall_ms']:.2f} ms, "
        f"device busy {profiled['device_busy_ms']:.2f} ms (idle share "
        f"{profiled['idle_share']:.4f}), {profiled['kernels']} kernels; "
        f"device ms by op: " + ", ".join(
            f"{k} {v:.2f}" for k, v in profiled["device_ms_by_op"].items()))
    return row


#: The latency counters every record of the serve scope's child run
#: must carry.
SERVE_COUNTERS = ("latency_p99_s", "ttft_p99_s", "queue_depth_mean",
                  "slo_attainment")


def phase_serve_scope() -> dict:
    """``python -m repro_torch run --enable-scope serve --meters
    wall,cpu,latency --slo-ms 200`` in a child process on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "serve.json")
        r = checked_run("run", "--enable-scope", "serve", "--meters",
                        "wall,cpu,latency", "--slo-ms", "200",
                        "--results-dir", "", "--benchmark_out", out)
        with open(out) as f:
            doc = json.load(f)
    if doc["context"]["backend"] != "cuda":
        raise AssertionError(f"serve scope not on the card: "
                             f"{doc['context']}")
    rows = {}
    for rec in doc["benchmarks"]:
        missing = [k for k in SERVE_COUNTERS if k not in rec]
        if rec.get("error_occurred") or missing:
            raise AssertionError(f"{rec['name']}: error "
                                 f"{rec.get('error_message')}, missing "
                                 f"{missing}")
        rows[rec["name"]] = {k: rec[k] for k in SERVE_COUNTERS}
    if len(rows) != 6:
        raise AssertionError(f"serve scope: {len(rows)} records")
    log(f"serve scope child (--meters wall,cpu,latency --slo-ms 200): "
        f"{len(rows)} records in {r.wall_s:.1f} s; " + "; ".join(
            f"{n.split('/', 2)[2]} p99 {v['latency_p99_s'] * 1e3:.1f} ms "
            f"ttft p99 {v['ttft_p99_s'] * 1e3:.1f} ms depth "
            f"{v['queue_depth_mean']:.2f} slo {v['slo_attainment']:.2f}"
            for n, v in rows.items()))
    return {"wall_s": r.wall_s, "records": rows}


#: The train phase: llama3.2-1b at its published width and depth (16
#: layers, d_model 2048, vocab 128,256) trained by the port's one-card
#: trainer (``repro_torch.launch.train.train``) under the reference's
#: training policy (``src/repro/launch/dryrun.py:62``: remat full, the
#: loss in chunks of 1024 positions), bf16 compute over float32
#: parameters, gradients and AdamW moments, one microbatch of
#: ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens from the port's data pipeline
#: (seed 0), ``TRAIN_STEPS`` steps at lr ``TRAIN_LR``.  Step times are
#: the median from the third step on.
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 4096, 6, 3e-4
TRAIN_OVERRIDES = {"remat": "full", "loss_chunk": 1024}
#: (a) the first step's loss against ``api.loss`` under inference_mode
#: on the same weights and batch.
TRAIN_FIRST_LOSS_TOL = 1e-3
#: (b) float32 steps on the card against the CPU from one state:
#: ``TRAIN_CHECK_STEPS`` steps of B ``TRAIN_CHECK_BATCH`` x S
#: ``TRAIN_CHECK_SEQ`` on each reduced arch (llama with 2 layers); the
#: loss (absolute) and grad_norm (relative) per step.
TRAIN_CHECK_ARCHS = (("llama3.2-1b", {"num_layers": 2}),
                     ("mamba2-780m", {}), ("deepseek-moe-16b", {}))
TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 3, 2, 64
TRAIN_CPU_LOSS_TOL, TRAIN_CPU_NORM_RTOL = 1e-4, 1e-4
#: (c) gradients under remat none, full and dots (largest |difference|).
TRAIN_REMAT_TOL = 1e-6
#: (d) a run halted at step 7 of 14 and resumed through the manager
#: against the uninterrupted run: the last loss (the reference test's
#: bound).
TRAIN_RESUME_TOL = 2e-3
#: (e) the bf16 steps' loss against float32's from one state.
TRAIN_BF16_TOL = 5e-2


def _train_batches(cfg, n, batch, seq, seed=0):
    """``n`` batches of the port's data pipeline, as on the trainer's
    path (tokens and labels, int32)."""
    from repro_torch.data import DataConfig, SyntheticLM
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch, seed=seed))
    return [{k: torch.from_numpy(v) for k, v in src.batch(i).items()}
            for i in range(n)]


def _on(t, device):
    """A copy of a tree of tensors on ``device`` (each step writes its
    state in place, so two runs never share one)."""
    from repro_torch.models import tree
    return tree.map(lambda x: x.to(device, copy=True), t)


def train_checks(hw) -> dict:
    """Checks (b)–(e) at reduced size, each failing the phase."""
    from repro_torch.launch.train import train
    from repro_torch.models import build, get_config, tree
    from repro_torch.train import AdamWConfig, make_init_fn, make_train_step
    from repro_torch.train.step import _grad_fn
    out = {"cpu": {}}
    opt = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    # (b) float32: the card against the CPU, one state, the same batches
    for arch, kw in TRAIN_CHECK_ARCHS:
        cfg = get_config(arch).reduced().override(dtype="float32", **kw)
        api = build(cfg)
        state = make_init_fn(api, opt)(torch.Generator().manual_seed(0))
        batches = _train_batches(cfg, TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH,
                                 TRAIN_CHECK_SEQ)
        step = make_train_step(api, opt)
        runs = {}
        for device in ("cuda", "cpu"):
            st, ms = _on(state, device), []
            for b in batches:
                st, m = step(st, _on(b, device))
                ms.append({k: float(v) for k, v in m.items()})
            runs[device] = ms
        loss_err = max(abs(c["loss"] - h["loss"])
                       for c, h in zip(runs["cuda"], runs["cpu"]))
        norm_err = max(abs(c["grad_norm"] - h["grad_norm"]) / h["grad_norm"]
                       for c, h in zip(runs["cuda"], runs["cpu"]))
        out["cpu"][arch] = {"layers": cfg.num_layers,
                            "loss_card": [m["loss"] for m in runs["cuda"]],
                            "loss_cpu": [m["loss"] for m in runs["cpu"]],
                            "loss_abs_err": loss_err,
                            "grad_norm_rel_err": norm_err}
        log(f"train check (b) {arch} reduced ({cfg.num_layers} layers) "
            f"float32, {TRAIN_CHECK_STEPS} steps B{TRAIN_CHECK_BATCH} x "
            f"S{TRAIN_CHECK_SEQ}, card against CPU: loss "
            f"{loss_err:.3g} (tol {TRAIN_CPU_LOSS_TOL}), grad_norm relative "
            f"{norm_err:.3g} (tol {TRAIN_CPU_NORM_RTOL})")
        if not (loss_err <= TRAIN_CPU_LOSS_TOL
                and norm_err <= TRAIN_CPU_NORM_RTOL):
            raise AssertionError(f"train (b) {arch}: card against CPU: "
                                 f"{out['cpu'][arch]}")
    # (c) remat none, full and dots give the same gradients on the card
    cfg = get_config(TRAIN_ARCH).reduced().override(dtype="float32")
    params = build(cfg).init(torch.Generator(device="cuda").manual_seed(1))
    batch = _on(_train_batches(cfg, 1, 2, 128)[0], "cuda")
    grads = {m: _grad_fn(build(cfg.override(remat=m)))(params, batch)[1]
             for m in ("none", "full", "dots")}
    remat_err = max(float((a - b).abs().max())
                    for m in ("full", "dots")
                    for (_, a), (_, b) in zip(tree.leaves(grads[m]),
                                              tree.leaves(grads["none"])))
    out["remat_max_abs_err"] = remat_err
    log(f"train check (c) {TRAIN_ARCH} reduced float32 on the card: "
        f"gradients under remat full and dots against none: max abs err "
        f"{remat_err:.3g} (tol {TRAIN_REMAT_TOL})")
    if not remat_err <= TRAIN_REMAT_TOL:
        raise AssertionError(f"train (c): remat gradients differ by "
                             f"{remat_err}")
    # (d) halt at step 7 of 14, resume through the manager, on the card
    kw = dict(steps=14, global_batch=2, seq_len=32, lr=1e-3, seed=5,
              log_every=100, device="cuda")
    full = train(TRAIN_ARCH, **kw)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train-resume-",
                            dir=os.path.join(ROOT, "build"))
    try:
        half = train(TRAIN_ARCH, ckpt_dir=ckpt, ckpt_every=7, halt_at=7,
                     **kw)
        resumed = train(TRAIN_ARCH, ckpt_dir=ckpt, ckpt_every=7, **kw)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resume_err = abs(resumed["last_loss"] - full["last_loss"])
    out["resume"] = {"full_last_loss": full["last_loss"],
                     "resumed_last_loss": resumed["last_loss"],
                     "halted_steps": half["steps"],
                     "resumed_steps": resumed["steps"],
                     "abs_err": resume_err}
    log(f"train check (d) resume on the card: halted after "
        f"{half['steps']} steps, resumed for {resumed['steps']}; last loss "
        f"{resumed['last_loss']:.6f} against the uninterrupted "
        f"{full['last_loss']:.6f}: {resume_err:.3g} (tol {TRAIN_RESUME_TOL})")
    if not (half["steps"] == 7 and resumed["steps"] == 7
            and resume_err <= TRAIN_RESUME_TOL):
        raise AssertionError(f"train (d): {out['resume']}")
    # (e) bf16 against float32 from one state, the same batches
    cfg = get_config(TRAIN_ARCH).reduced()
    state = make_init_fn(build(cfg), opt)(
        torch.Generator(device="cuda").manual_seed(2))
    batches = [_on(b, "cuda") for b in _train_batches(
        cfg, TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ)]
    losses = {}
    for dtype in ("bfloat16", "float32"):
        step = make_train_step(build(cfg.override(dtype=dtype)), opt)
        st, losses[dtype] = _on(state, "cuda"), []
        for b in batches:
            st, m = step(st, b)
            losses[dtype].append(float(m["loss"]))
    bf16_err = max(abs(a - b) for a, b in zip(losses["bfloat16"],
                                              losses["float32"]))
    out["bf16"] = {"loss_bf16": losses["bfloat16"],
                   "loss_float32": losses["float32"], "abs_err": bf16_err}
    log(f"train check (e) {TRAIN_ARCH} reduced, {TRAIN_CHECK_STEPS} steps: "
        f"bf16 loss {losses['bfloat16']} against float32 "
        f"{losses['float32']}: {bf16_err:.3g} (tol {TRAIN_BF16_TOL})")
    if not bf16_err <= TRAIN_BF16_TOL:
        raise AssertionError(f"train (e): {out['bf16']}")
    return out


def train_split(api, opt, state, batch) -> dict:
    """One train step taken apart, each part fenced, as
    ``make_train_step`` runs it: the loss forward under grad (on
    aliases of the parameters that require grad), the backward
    (``torch.autograd.grad``), clipping and AdamW (ms); and the memory
    above the state's own bytes: what the forward keeps for the
    backward, and the peaks of the forward, the backward and the
    optimizer."""
    from repro_torch.models import tree
    from repro_torch.train import (adamw_update, clip_by_global_norm,
                                   warmup_cosine)
    nbytes = sum(t.numel() * t.element_size() for t in tree.flatten(state))
    alias = tree.map(lambda p: p.detach().requires_grad_(), state["params"])
    leaves = tree.flatten(alias)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    marks, peaks = [time.perf_counter()], {}

    def fence(name):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        peaks[name] = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = api.loss(alias, batch)
    fence("forward")
    kept = torch.cuda.memory_allocated() - base
    grads = torch.autograd.grad(loss, leaves)
    del loss
    fence("backward")
    grads = tree.unflatten(alias, grads)    # the tuple goes: one copy
    grads, _ = clip_by_global_norm(grads, opt.grad_clip)
    fence("clip")
    adamw_update(opt, grads, state["opt"], state["params"],
                 warmup_cosine(opt))
    fence("adamw")
    names = ["forward", "backward", "clip", "adamw"]
    return {"state_bytes": nbytes, "forward_kept_bytes": kept,
            "ms": {n: (b - a) * 1e3 for n, a, b in
                   zip(names, marks, marks[1:])},
            "peak_above_state_bytes": peaks}


def phase_train(hw: dict) -> dict:
    """llama3.2-1b trained at full width on the card through the port's
    trainer: the step's median ms, tokens/s, ``mfu`` (three forwards'
    model FLOPs: remat's recompute is not counted), peak memory, each
    step's loss, grad_norm and lr, and one profiled step; check (a), the
    first step's loss against the inference forward's; then checks
    (b)–(e) at reduced size."""
    from repro_torch.launch.train import train
    from repro_torch.models import build, get_config
    from repro_torch.train import AdamWConfig, make_init_fn, make_train_step
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 products must not run in TF32 here")
    t_phase = time.perf_counter()
    # this phase measures the one-card trainer: the default group the
    # main path's comm scope left up (phase 10) would put train() on its
    # meshed path (phase 21 measures that one)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    cfg = get_config(TRAIN_ARCH).override(**TRAIN_OVERRIDES)
    api = build(cfg)
    batch0 = _on(_train_batches(cfg, 1, TRAIN_BATCH, TRAIN_SEQ)[0], "cuda")
    # (a) the trainer's weights (its init from seed 0) under inference_mode
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    with torch.inference_mode():
        loss_inference = float(api.loss(params, batch0)[0])
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train(TRAIN_ARCH, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, lr=TRAIN_LR, reduced=False,
                overrides=TRAIN_OVERRIDES, log_every=1, seed=0,
                device="cuda")
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    if not (len(hist) == TRAIN_STEPS and all(
            math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
            for h in hist)):
        raise AssertionError(f"train: steps not all finite: {hist}")
    first_err = abs(hist[0]["loss"] - loss_inference)
    if not first_err <= TRAIN_FIRST_LOSS_TOL:
        raise AssertionError(
            f"train (a): first step's loss {hist[0]['loss']} against the "
            f"inference forward's {loss_inference} ({first_err:.3g}, tol "
            f"{TRAIN_FIRST_LOSS_TOL})")
    times = [h["seconds"] * 1e3 for h in hist]
    steady = sorted(times[2:])
    ms = steady[len(steady) // 2]
    # three forwards: the roofline's 6·N·tokens and the attention thrice
    from repro_torch.roofline import model_flops
    flops = model_flops(cfg, TRAIN_BATCH * TRAIN_SEQ, "train") \
        + 3 * causal_attention_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    # one profiled step on a fresh state (the trainer's is gone)
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=5)
    step_fn = make_train_step(api, opt)
    held = {"state": make_init_fn(api, opt)(
        torch.Generator(device="cuda").manual_seed(0))}

    def one_step():
        held["state"], m = step_fn(held["state"], batch0)
        return float(m["loss"])
    one_step()                                              # warm
    profiled = profile_step(one_step, top=10)
    split = train_split(api, opt, held["state"], batch0)
    del held["state"]
    torch.cuda.empty_cache()
    row = {
        "arch": TRAIN_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": cfg.num_params(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "dtype": cfg.dtype, "remat": cfg.remat, "loss_chunk": cfg.loss_chunk,
        "microbatches": 1, "lr": TRAIN_LR, "steps": TRAIN_STEPS,
        "ms": ms, "step_ms": times,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
        "model_flops": flops,
        "mfu": flops / (ms / 1e3 * hw["peak_bf16_flops"]),
        "max_memory_allocated": peak,
        "loss": [h["loss"] for h in hist],
        "grad_norm": [h["grad_norm"] for h in hist],
        "lr_by_step": [h["lr"] for h in hist],
        "loss_inference": loss_inference, "first_loss_abs_err": first_err,
        "trainer_seconds": out["seconds"],
        "profiled_step": profiled, "split": split, "card": hw["card"],
    }
    log(f"train {TRAIN_ARCH} ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_params():,} params) B{TRAIN_BATCH} x S{TRAIN_SEQ} "
        f"{cfg.dtype}, remat {cfg.remat}, loss chunk {cfg.loss_chunk}, "
        f"float32 parameters and AdamW on {hw['card']}: median "
        f"{ms:.2f} ms a step from step 3 ("
        + ", ".join(f"{t:.1f}" for t in times)
        + f"); {row['tokens_per_s']:.0f} tokens/s; {flops:.4g} model FLOPs "
        f"(3 forwards); mfu {row['mfu']:.4f}; max_memory_allocated "
        f"{peak:,} B ({peak / 2**30:.2f} GiB)")
    log("  loss " + ", ".join(f"{h['loss']:.4f}" for h in hist)
        + "; grad_norm " + ", ".join(f"{h['grad_norm']:.4f}" for h in hist)
        + "; lr " + ", ".join(f"{h['lr']:.3g}" for h in hist))
    log(f"  check (a): first step's loss {hist[0]['loss']:.6f} against the "
        f"inference forward's {loss_inference:.6f}: {first_err:.3g} (tol "
        f"{TRAIN_FIRST_LOSS_TOL})")
    log(f"  profiled step: wall {profiled['wall_ms']:.2f} ms, device busy "
        f"{profiled['device_busy_ms']:.2f} ms (idle share "
        f"{profiled['idle_share']:.4f}), {profiled['kernels']} kernels; "
        f"device ms by op: " + ", ".join(
            f"{k} {v:.2f}" for k, v in profiled["device_ms_by_op"].items()))
    log("  one step taken apart: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in split["ms"].items())
        + f"; state {split['state_bytes']:,} B; the forward keeps "
        f"{split['forward_kept_bytes']:,} B for the backward; peaks above "
        f"the state: " + ", ".join(
            f"{k} {v:,} B" for k, v in
            split["peak_above_state_bytes"].items()))
    row["checks"] = train_checks(hw)
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"train phase: {row['phase_s']:.1f} s")
    return row


#: The report phase: two runs of these scopes in one results directory
#: (the mxu and histo rows launch the matmul and histogram kernels; serve
#: carries the latency meter's counters), then the port's ScopePlot over
#: them, each CLI step in a child that cannot import matplotlib or yaml.
REPORT_SCOPES = ["mxu", "serve"]
REPORT_RUN_ARGS = ["--meters", "wall,cpu,latency", "--slo-ms", "200",
                   "--benchmark_min_time", PIPELINE_MIN_TIME]
#: The family tuned once with its report (a quick one).
REPORT_TUNE = ("nn/rmsnorm", [])
#: ``python -c`` program: ``python -m <argv[1]> <argv[2:]>`` with
#: matplotlib and yaml made unimportable before the CLI starts.
BLOCKED_CLI = ("import runpy, sys\n"
               "sys.modules['matplotlib'] = None\n"
               "sys.modules['yaml'] = None\n"
               "module = sys.argv[1]\n"
               "sys.argv = sys.argv[1:]\n"
               "runpy.run_module(module, run_name='__main__', "
               "alter_sys=True)\n")


def blocked_cli(module, *args, env_extra=None, ok=(0,)
                ) -> subprocess.CompletedProcess:
    """``python -m <module> <args>`` from the checkout's ``src`` in a
    child that cannot import matplotlib or yaml; its wall on ``wall_s``."""
    env = dict(os.environ, **(env_extra or {}), PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", BLOCKED_CLI, module, *args],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    r.wall_s = time.perf_counter() - t0
    if r.returncode not in ok:
        raise AssertionError(f"{module} {' '.join(args)} exited "
                             f"{r.returncode}:\n{r.stderr[-3000:]}")
    return r


def report_images(report_dir: str) -> dict:
    """Every image ``report.md`` names: it must exist, parse as XML and
    hold at least one mark per series of the spec that drew it.  Returns
    image → (marks, bytes)."""
    import xml.etree.ElementTree as ET
    from repro_torch.scopeplot import specyaml
    with open(os.path.join(report_dir, "report.md")) as f:
        md = f.read()
    images = [line[line.index("](") + 2:-1] for line in md.splitlines()
              if line.startswith("![")]
    out = {}
    for image in images:
        path = os.path.join(report_dir, image)
        root = ET.parse(path).getroot()
        marks = sum(1 for e in root.iter()
                    if "mark" in e.get("class", "").split())
        spec_path = os.path.join(report_dir, "specs",
                                 image[:-len(".svg")] + ".yaml")
        with open(spec_path) as f:
            spec, _ = specyaml.load(f.read(), spec_path)
        if marks < len(spec["series"]):
            raise AssertionError(f"{image}: {marks} marks for "
                                 f"{len(spec['series'])} series")
        out[image] = (marks, os.path.getsize(path))
    return out


def phase_report() -> dict:
    """Two runs on the card, then ``report``, ``report history``,
    ``scopeplot batch``, ``ci`` and ``tune`` with their reports, each in
    a child that cannot import matplotlib or yaml, and the dashboard."""
    import importlib.util
    import threading
    import urllib.request
    from repro_torch.scopeplot.dashboard import create_server
    card = torch.cuda.get_device_name(0)
    scopes = [a for s in REPORT_SCOPES for a in ("--enable-scope", s)]
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        results = os.path.join(tmp, "results")
        # 1. two runs, a then b
        for run_id in ("a", "b"):
            r = repro_torch("run", *scopes, *REPORT_RUN_ARGS,
                            "--results-dir", results, "--run-id", run_id,
                            "--benchmark_out", os.devnull)
            if r.returncode != 0:
                raise AssertionError(f"run {run_id} exited {r.returncode}:"
                                     f"\n{r.stderr[-3000:]}")
            walls[f"run_{run_id}"] = r.wall_s
        merged = os.path.join(results, "b", "merged.json")
        with open(merged) as f:
            doc = json.load(f)
        names = [b["name"] for b in doc["benchmarks"]]
        errors = [b["name"] for b in doc["benchmarks"]
                  if b.get("error_occurred")]
        if errors or doc["context"].get("device_kind") != card:
            raise AssertionError(f"run b: errors {errors}, context "
                                 f"{doc['context'].get('device_kind')}")
        # 2. the run report
        r = blocked_cli("repro_torch", "report", "b", "--results-dir",
                        results)
        walls["report"] = r.wall_s
        report_dir = os.path.join(results, "b", "report")
        for f in ("report.md", "index.html"):
            if not os.path.exists(os.path.join(report_dir, f)):
                raise AssertionError(f"report wrote no {f}")
        images = report_images(report_dir)
        want = {f"{s}_{k}.svg" for s in REPORT_SCOPES
                for k in ("times", "trend", "speedup")} | \
            {"serve_latency.svg"}
        if not want <= set(images):
            raise AssertionError(f"report images {sorted(images)}, missing "
                                 f"{sorted(want - set(images))}")
        with open(os.path.join(report_dir, "report.md")) as f:
            md = f.read()
        system = md.split("## System", 1)[1].split("\n## ", 1)[0]
        verdicts = md.split("## Verdicts", 1)[1].split("\n## ", 1)[0]
        for row in (f"| device_kind | {card} |",
                    f"| cuda_version | {torch.version.cuda} |"):
            if row not in system:
                raise AssertionError(f"System table lacks {row!r}:\n"
                                     f"{system}")
        missing = [n for n in names if f"| {n} |" not in verdicts]
        if missing:
            raise AssertionError(f"verdict table lacks {missing}")
        # 3. the history report
        r = blocked_cli("repro_torch", "report", "history", "--results-dir",
                        results)
        walls["report_history"] = r.wall_s
        history_images = report_images(os.path.join(results, "report"))
        # 4. batch: every spec fresh; after merged.json moves, exactly the
        #    specs that read it render
        specs = os.path.join(report_dir, "specs")

        def batch():
            r = blocked_cli("repro_torch.scopeplot", "batch", specs)
            status = {}
            for line in r.stdout.splitlines():
                path, _, rest = line.partition(": ")
                status[os.path.basename(path)] = rest.split()[0]
            return r, status
        r, first = batch()
        walls["batch_fresh"] = r.wall_s
        if set(first.values()) != {"fresh"}:
            raise AssertionError(f"batch after report: {first}")
        from repro_torch.scopeplot.plot import load_spec, spec_dependencies
        readers = sorted(
            name for name in first
            if os.path.realpath(merged) in {
                os.path.realpath(os.path.join(specs, d))
                for d in spec_dependencies(load_spec(
                    os.path.join(specs, name)))})
        future = max(os.path.getmtime(os.path.join(report_dir, i))
                     for i in images) + 60
        os.utime(merged, (future, future))
        r, second = batch()
        walls["batch_after_touch"] = r.wall_s
        rendered = sorted(n for n, st in second.items() if st == "rendered")
        if not readers or rendered != readers or any(
                st != "fresh" for n, st in second.items()
                if n not in readers):
            raise AssertionError(f"batch after touching merged.json: "
                                 f"{second}, readers {readers}")
        # 5. ci with and without --no-report; one tune with its report
        common = [*scopes, "--results-dir", results, "--benchmark_min_time",
                  PIPELINE_MIN_TIME]
        ci_quiet = blocked_cli("repro_torch", "ci", *common, "--run-id",
                               "c1", "--no-report", ok=(0, 1))
        ci_loud = blocked_cli("repro_torch", "ci", *common, "--run-id",
                              "c2", ok=(0, 1))
        walls["ci_no_report"], walls["ci_report"] = (ci_quiet.wall_s,
                                                     ci_loud.wall_s)
        if ci_loud.returncode != ci_quiet.returncode or os.path.exists(
                os.path.join(results, "c1", "report")) or \
                not os.path.exists(os.path.join(results, "c2", "report",
                                                "index.html")):
            raise AssertionError(f"ci exits {ci_quiet.returncode} with "
                                 f"--no-report, {ci_loud.returncode} "
                                 f"without; reports "
                                 f"{os.listdir(results)}")
        ci_images = report_images(os.path.join(results, "c2", "report"))
        family, extra = REPORT_TUNE
        tune_results = os.path.join(tmp, "tune")
        r = blocked_cli("repro_torch", "tune", family, "--budget", "8",
                        "--benchmark_min_time", PIPELINE_MIN_TIME, *extra,
                        "--results-dir", tune_results, "--run-id", "t",
                        env_extra={tuning.DIR_ENV: os.path.join(tmp,
                                                                "tuned")})
        walls["tune"] = r.wall_s
        tune_report = os.path.join(tune_results, "t", "report")
        if f"  report:   {os.path.join(tune_report, 'index.html')}" not in \
                r.stdout:
            raise AssertionError(f"tune printed no report path:\n"
                                 f"{r.stdout}")
        tune_images = report_images(tune_report)
        if "tune_speedup.svg" not in tune_images:
            raise AssertionError(f"tune report images {tune_images}")
        # 6. the dashboard
        t0 = time.perf_counter()
        server = create_server(results, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        codes = {}
        try:
            host, port = server.server_address
            for path in ("/", "/api/runs", "/api/status"):
                with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                            timeout=30) as resp:
                    codes[path] = resp.status
                    body = resp.read()
                if path == "/api/runs":
                    runs = [x["run_id"] for x in json.loads(body)]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        walls["dashboard"] = time.perf_counter() - t0
        if set(codes.values()) != {200} or runs[:2] != ["a", "b"]:
            raise AssertionError(f"dashboard answered {codes}, runs {runs}")
    written = {**images, **{f"history/{k}": v
                            for k, v in history_images.items()},
               **{f"ci/{k}": v for k, v in ci_images.items()},
               **{f"tune/{k}": v for k, v in tune_images.items()}}
    facts = {
        "scopes": REPORT_SCOPES, "instances": len(names),
        "walls_s": walls,
        "plots": len(written),
        "svg_bytes": sum(b for _, b in written.values()),
        "marks": {k: m for k, (m, _) in written.items()},
        "batch_rendered_after_touch": rendered,
        "ci_rc": {"no_report": ci_quiet.returncode,
                  "report": ci_loud.returncode},
        "tune_family": family, "dashboard": codes, "runs": runs,
        "host_has": {m: importlib.util.find_spec(m) is not None
                     for m in ("matplotlib", "yaml")},
    }
    log(f"report: runs a, b of {', '.join(REPORT_SCOPES)} "
        f"({len(names)} instances) in {walls['run_a']:.1f} and "
        f"{walls['run_b']:.1f} s; report {walls['report']:.1f} s "
        f"({len(images)} plots), history {walls['report_history']:.1f} s, "
        f"batch fresh {walls['batch_fresh']:.1f} s, after touching "
        f"merged.json {len(rendered)} rendered in "
        f"{walls['batch_after_touch']:.1f} s; ci exit "
        f"{ci_quiet.returncode}/{ci_loud.returncode} "
        f"({walls['ci_no_report']:.1f}/{walls['ci_report']:.1f} s); tune "
        f"{family} {walls['tune']:.1f} s; dashboard {codes}; "
        f"{facts['plots']} SVGs, {facts['svg_bytes']} bytes; host has "
        f"{facts['host_has']}")
    return facts


#: Phase 19: the scopes ``run --lint --strict`` drives (the five scope
#: kernels).
LINT_RUN_SCOPES = ["mxu", "histo", "nn", "linalg"]
#: The families whose fixtures do not follow ``(callable, *operands)``:
#: their SCOPE203 infos are the only findings the lint may report.
LINT_OPAQUE = {"example/axpy", "serve/under_load"}
#: The examples, each with its defaults but for these arguments
#: (train_lm's 300 steps cut to 30: the phase checks that it runs).
EXAMPLES = {"quickstart": [], "characterize": [], "serve_lm": [],
            "train_lm": ["--steps", "30"]}
#: A scope whose one family the trace tier refuses (SCOPE201): its
#: callable sums a constant, whatever its operand.
PLANTED = "chip_smoke_planted_scope"


@contextlib.contextmanager
def fresh_cli_state():
    """The process-global flags, hooks and registry as a new process has
    them (core flags only, no scope), restored afterwards: an in-process
    CLI call after the main path's loads every scope again."""
    from repro_torch.core.flags import FLAGS
    from repro_torch.core.hooks import HOOKS
    from repro_torch.core.registry import REGISTRY
    saved = (dict(FLAGS._specs), dict(FLAGS._values),
             list(HOOKS._pre_parse), list(HOOKS._post_parse),
             dict(REGISTRY._benchmarks))
    for name in [n for n, spec in FLAGS._specs.items()
                 if spec.owner != "core"]:
        del FLAGS._specs[name]
        FLAGS._values.pop(name, None)
    HOOKS._pre_parse[:] = [h for h in HOOKS._pre_parse if h[0] == "core"]
    HOOKS._post_parse[:] = [h for h in HOOKS._post_parse if h[0] == "core"]
    REGISTRY._benchmarks.clear()
    try:
        yield
    finally:
        FLAGS._specs.clear(), FLAGS._specs.update(saved[0])
        FLAGS._values.clear(), FLAGS._values.update(saved[1])
        HOOKS._pre_parse[:], HOOKS._post_parse[:] = saved[2], saved[3]
        REGISTRY._benchmarks.clear(), REGISTRY._benchmarks.update(saved[4])


def start_module(module, *args, cwd, env_extra=None):
    """``python -m <module> <args>`` from the checkout's ``src``, started
    in a child working in ``cwd``: (its start time, the child)."""
    env = dict(os.environ, **(env_extra or {}), PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")])))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", module, *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=cwd)


def finish_module(t0, child, timeout=600) -> subprocess.CompletedProcess:
    """The finished child of :func:`start_module`; its wall on
    ``wall_s``."""
    try:
        stdout, stderr = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise
    r = subprocess.CompletedProcess(child.args, child.returncode, stdout,
                                    stderr)
    r.wall_s = time.perf_counter() - t0
    return r


def python_module(module, *args, cwd, env_extra=None
                  ) -> subprocess.CompletedProcess:
    """``python -m <module> <args>`` from the checkout's ``src`` in a
    child working in ``cwd``; its wall on ``wall_s``."""
    return finish_module(*start_module(module, *args, cwd=cwd,
                                       env_extra=env_extra))


def zero_launches() -> None:
    for ops in KERNEL_OPS.values():
        ops.launches = 0


def planted_scope() -> str:
    """A scope module holding the SCOPE201 family, in ``sys.modules``."""
    import types
    from repro_torch.core import Scope, State, benchmark

    def register(registry):
        @benchmark(scope="planted", registry=registry)
        def folded(state: State):
            fn, x = state.fixture
            while state.keep_running():
                state.deliver(fn(x))
            state.set_items_processed(state.params.n)
        folded.param_space(n=[1 << 20])
        folded.set_fixture(lambda params: (
            lambda x: torch.ones(4, device=x.device).sum(),
            torch.ones(params.n, device="cuda")))
    mod = types.ModuleType(PLANTED)
    mod.SCOPE = Scope(name="planted", register=register)
    sys.modules[PLANTED] = mod
    return PLANTED


def traced_families() -> dict:
    """Every family's first fixture built on the card and traced by the
    lint's trace tier, in this process: the families traced, the
    ``repro_torch`` kernel nodes their graphs hold, and the launches
    the traces made (none: fake tensors)."""
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.lint import compile_workload
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.scope import ScopeManager
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load()
    mgr.register_all()
    zero_launches()
    traced, nodes, untraced = 0, {}, []
    for bench in mgr.registry.all():
        out = compile_workload(bench)
        if out is None:
            continue
        if not out.analyzed():
            untraced.append(bench.name)
            continue
        traced += 1
        for op in out.kernel_ops:
            nodes[op] = nodes.get(op, 0) + 1
    torch.cuda.synchronize()
    launched = {name: ops.launches for name, ops in KERNEL_OPS.items()}
    if any(launched.values()):
        raise AssertionError(f"the trace tier launched kernels: {launched}")
    if set(untraced) != LINT_OPAQUE:
        raise AssertionError(f"families not traced: {untraced}")
    return {"families_traced": traced, "kernel_nodes": nodes,
            "untraced": untraced}


def phase_lint() -> dict:
    """Phase 19: ``lint`` over the ten scopes with the trace tier on, the
    ``run --lint --strict`` pre-flight over the kernels' scopes, a planted
    SCOPE201 family refused, the paper's harness, ``serve_demo`` at full
    width and the four examples, each on the card."""
    from repro_torch.core.main import main
    from repro_torch.launch.serve import serve_demo
    row = {}
    t_phase = time.perf_counter()
    # (a) the linter, in a child, as a user runs it
    r = repro_torch("lint", "--strict", "--format", "json",
                    "--device", "cuda")
    if r.returncode != 0:
        raise AssertionError(f"lint exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    doc = json.loads(r.stdout)
    infos = {(f["rule"], f["family"]) for f in doc["findings"]}
    if doc["counts"]["error"] or doc["counts"]["warning"] or \
            infos != {("SCOPE203", f) for f in LINT_OPAQUE} or \
            doc["scopes_checked"] != 10 or "SCOPE201" not in doc["rules_run"]:
        raise AssertionError(f"lint: {doc}")
    row["lint"] = {"rc": r.returncode, "wall_s": r.wall_s,
                   "counts": doc["counts"],
                   "families_checked": doc["families_checked"],
                   "scopes_checked": doc["scopes_checked"],
                   **traced_families()}
    log(f"lint: exit 0 in {r.wall_s:.1f} s, {doc['families_checked']} "
        f"families, counts {doc['counts']}; traced "
        f"{row['lint']['families_traced']}, kernel nodes "
        f"{row['lint']['kernel_nodes']}")
    # (b) the pre-flight, then the run: every kernel must launch
    scopes = [a for s in LINT_RUN_SCOPES for a in ("--enable-scope", s)]
    with tempfile.TemporaryDirectory() as tmp, fresh_cli_state():
        out = os.path.join(tmp, "run.json")
        zero_launches()
        t0 = time.perf_counter()
        rc = main(["run", "--lint", "--strict", *scopes,
                   "--benchmark_min_time", "0.02", "--results-dir", "",
                   "--benchmark_out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: KERNEL_OPS[name].launches
                    for name in SCOPE_KERNELS}
        with open(out) as f:
            records = json.load(f)["benchmarks"]
    if rc != 0 or not all(launches.values()) or \
            any(rec.get("error_occurred") for rec in records):
        raise AssertionError(f"run --lint --strict exited {rc}, launches "
                             f"{launches}")
    row["run_lint_strict"] = {"rc": rc, "wall_s": wall,
                              "records": len(records),
                              "launches": launches}
    log(f"run --lint --strict over {', '.join(LINT_RUN_SCOPES)}: exit 0 "
        f"in {wall:.1f} s, {len(records)} records, launches {launches}")
    # (c) the planted family: refused before anything runs or persists
    with tempfile.TemporaryDirectory() as tmp, fresh_cli_state():
        results = os.path.join(tmp, "results")
        zero_launches()
        t0 = time.perf_counter()
        rc = main(["run", "--lint", "--results-dir", results],
                  scope_modules=[planted_scope()])
        wall = time.perf_counter() - t0
        sys.modules.pop(PLANTED)
        written = os.path.exists(results)
    if rc != 1 or written:
        raise AssertionError(f"planted SCOPE201 family: run --lint exited "
                             f"{rc}, results written: {written}")
    row["planted"] = {"rc": rc, "wall_s": wall, "results_written": written}
    log(f"planted SCOPE201 family: run --lint exit {rc} in {wall:.2f} s, "
        f"nothing written")
    # (e) serve_demo at full width
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats = serve_demo("llama3.2-1b", reduced=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if stats["requests"] != 16 or stats["tokens"] != 16 * 16:
        raise AssertionError(f"serve_demo: {stats}")
    row["serve_demo"] = {"wall_s": wall, **stats}
    torch.cuda.empty_cache()
    log(f"serve_demo llama3.2-1b full width: {stats} in {wall:.1f} s")
    # (d) the paper's harness over the ten scopes and (f) the four
    # examples, side by side (each is checked for its exit and output)
    with contextlib.ExitStack() as stack:
        dirs = {name: stack.enter_context(tempfile.TemporaryDirectory())
                for name in ["harness", *EXAMPLES]}
        started = {"harness": start_module("repro_torch.benchmarks.run",
                                           cwd=dirs["harness"])}
        for name, args in EXAMPLES.items():
            started[name] = start_module(
                f"repro_torch.examples.{name}", "--device", "cuda", *args,
                cwd=dirs[name], env_extra={"TMPDIR": dirs[name]})
        try:
            done = {name: finish_module(*child)
                    for name, child in started.items()}
        finally:
            for _, child in started.values():
                if child.poll() is None:
                    child.kill()
                    child.wait()
        r = done["harness"]
        lines = r.stdout.splitlines()
        failed = [line for line in lines if "/SCOPE_FAILED," in line]
        fig = os.path.join(dirs["harness"], "results", "fig3_saxpy.svg")
        if r.returncode != 0 or failed or not os.path.exists(fig):
            raise AssertionError(f"harness exited {r.returncode}, failed "
                                 f"scopes {failed}:\n{r.stderr[-3000:]}")
    rows = [line for line in lines if "," in line]
    row["harness"] = {"rc": r.returncode, "wall_s": r.wall_s,
                      "lines": len(rows),
                      "scopes": sorted({line.split(",")[0].split("/")[0]
                                        for line in rows})}
    log(f"harness: exit 0 in {r.wall_s:.1f} s, {len(rows)} lines, no "
        f"failed scope, fig3 written")
    row["examples"] = {}
    for name in EXAMPLES:
        r = done[name]
        if r.returncode != 0:
            raise AssertionError(f"example {name} exited {r.returncode}:"
                                 f"\n{r.stderr[-3000:]}")
        row["examples"][name] = {"rc": r.returncode, "wall_s": r.wall_s,
                                 "last_line": r.stdout.strip()
                                 .splitlines()[-1][:200]}
        log(f"example {name}: exit 0 in {r.wall_s:.1f} s: "
            f"{row['examples'][name]['last_line']}")
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"lint phase: {row['phase_s']:.1f} s")
    return row
#: The dry-run phase: llama3.2-1b's cells at its published width and
#: depth on the reference's production meshes, traced for one rank over
#: fake groups of 256 and 512 ranks.
DRYRUN_ARCH = "llama3.2-1b"
DRYRUN_MESHES = {"pod16x16": [], "pod2x16x16": ["--multi-pod"]}
DRYRUN_OK_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
#: (b) the one-card cell's per-device FLOPs against ``FlopCounterMode``
#: over one real step on the card (relative).
DRYRUN_FLOP_RTOL = 0.01
#: the wall a child may take (each traces four cells)
DRYRUN_TIMEOUT_S = 500


def dryrun_one_card() -> dict:
    """Phase 20 (b), run in a child: the cell of phase 17's step on a
    one-rank mesh of the card (``make_host_mesh(1)``), through the
    dry-run's API with a ``ShapeSpec`` of B ``TRAIN_BATCH`` x S
    ``TRAIN_SEQ`` under the train_4k policy, and ``FlopCounterMode``
    over one real step of the same configuration on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.inputs import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, get_config
    from repro_torch.train import AdamWConfig, make_init_fn, make_train_step
    spec = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    base = get_config(DRYRUN_ARCH)
    t0 = time.perf_counter()
    with make_host_mesh(1, device_type="cuda") as mesh:
        traced, meta = dryrun.lower_cell(DRYRUN_ARCH, "train_4k", mesh=mesh,
                                         spec=spec, device="cuda", cfg=base)
    wall = time.perf_counter() - t0
    cfg = dryrun.tune_config(base, "train_4k", {})
    api = build(cfg)
    opt = AdamWConfig(lr=TRAIN_LR)
    step = make_train_step(api, opt,
                           num_microbatches=meta["microbatches"])
    state = make_init_fn(api, opt)(
        torch.Generator(device="cuda").manual_seed(0))
    batch = _on(_train_batches(cfg, 1, TRAIN_BATCH, TRAIN_SEQ)[0], "cuda")
    with FlopCounterMode(display=False) as counter:
        state, m = step(state, batch)
        loss = float(m["loss"])
    return {"cell": meta, "wall_s": wall,
            "real_step_flops": float(counter.get_total_flops()),
            "real_step_loss": loss}


def _cell_line(d: dict) -> str:
    r, mem = d["roofline"], d["memory"]
    coll = ", ".join(f"{k} {v:.4g}" for k, v in r["per_kind"].items() if v)
    return (f"{d['arch']} {d['shape']} {d['mesh']} ({d['chips']} ranks, "
            f"{d['param_mode']}"
            + (f", {d['microbatches']} microbatches" if "microbatches" in d
               else "")
            + f"): traced in {d['compile_s']} s ({d['graph_nodes']} nodes); "
            f"per rank {r['hlo_flops']:.4g} FLOPs, {r['hlo_bytes']:.4g} HBM "
            f"B, collective {r['collective_bytes_']:.4g} B ({coll or 'none'}"
            f"); compute {r['compute_s'] * 1e3:.3f} ms, memory "
            f"{r['memory_s'] * 1e3:.3f} ms, collective "
            f"{r['collective_s'] * 1e3:.3f} ms: {r['dominant']}; useful "
            f"{r['useful_ratio']:.3f}; static peak {mem['peak_bytes']:,} B")


def start_dryrun() -> dict:
    """Phase 20's three children, started ahead of the phase (they run
    while phases 18 and 19 do): the two meshes' traces, on fake tensors
    (the CPU only), and the one-card cell with its real step."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")])))
    out = tempfile.mkdtemp(prefix="dryrun-")
    children = {}
    for mesh, extra in DRYRUN_MESHES.items():
        children[mesh] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", DRYRUN_ARCH, "--shape", "all", "--device",
             "cuda", "--out", out, *extra], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    one_card = (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c",
         "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.dryrun_one_card()))"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    return {"out": out, "children": children, "one_card": one_card}


def stop_dryrun(started: dict) -> None:
    """Kill whatever :func:`start_dryrun` started and remove its
    directory."""
    for _, child in [*started["children"].values(), started["one_card"]]:
        if child.poll() is None:
            child.kill()
            child.wait()
    shutil.rmtree(started["out"], ignore_errors=True)


def phase_dryrun(hw: dict, trained: dict, started: dict) -> dict:
    """Phase 20: the dry-run's cells on the production meshes, the
    one-card cell against a real step, the model scope and the report
    over the cells (see the module docstring), from the children
    :func:`start_dryrun` started."""
    t_phase = time.perf_counter()
    row: dict = {"card": hw["card"], "meshes": {}}
    out, children, one_card = (started["out"], started["children"],
                               started["one_card"])
    for mesh, (t0, child) in children.items():
        try:
            stdout, stderr = child.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            child.kill()
        # started before phases 18-19: the child ran beside them
        wall = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(
                f"dryrun {mesh} exited {child.returncode}:\n"
                f"{stdout[-2000:]}\n{stderr[-3000:]}")
        row["meshes"][mesh] = {"done_within_s": wall}
        log(f"dryrun {DRYRUN_ARCH} --shape all on {mesh}: exit 0, done "
            f"within {wall:.1f} s of its start (beside phases 18-19)")
    cells = {}
    for path in sorted(glob.glob(os.path.join(out, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        cells[(d["shape"], d["mesh"])] = d
    for mesh in DRYRUN_MESHES:
        for shape in DRYRUN_OK_SHAPES:
            d = cells.get((shape, mesh))
            if d is None or d["status"] != "ok":
                raise AssertionError(f"dryrun {shape} on {mesh}: {d}")
            log("  " + _cell_line(d))
        skip = cells.get(("long_500k", mesh))
        if skip is None or skip["status"] != "skip" or \
                not skip["reason"].startswith("long_500k skipped"):
            raise AssertionError(f"dryrun long_500k on {mesh}: {skip}")
    row["cells"] = [cells[k] for k in sorted(cells)]
    slowest = max((d for d in cells.values() if d["status"] == "ok"),
                  key=lambda d: d["compile_s"])
    row["slowest"] = f"{slowest['shape']} {slowest['mesh']}"
    log(f"  slowest trace: {row['slowest']} ({slowest['compile_s']} s)")

    # (b) one card: the cell's FLOPs against a real step's
    t0, child = one_card
    try:
        stdout, stderr = child.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        child.kill()
    if child.returncode != 0:
        raise AssertionError(f"dryrun one-card child exited "
                             f"{child.returncode}:\n{stderr[-3000:]}")
    one = json.loads(stdout.strip().splitlines()[-1])
    cell = one["cell"]
    traced_flops = cell["roofline"]["hlo_flops"]
    real = one["real_step_flops"]
    flop_err = abs(traced_flops - real) / real
    bound_ms = 1e3 * max(cell["roofline"][k] for k in (
        "compute_s", "memory_s", "collective_s"))
    one.update(flop_rel_err=flop_err, bound_ms=bound_ms,
               phase17_step_ms=trained["ms"],
               phase17_max_memory_allocated=trained[
                   "max_memory_allocated"])
    row["one_card"] = one
    log("  one card: " + _cell_line(cell))
    log(f"  one card: traced FLOPs {traced_flops:.6g} against "
        f"FlopCounterMode over one real step {real:.6g}: relative "
        f"{flop_err:.3g} (tol {DRYRUN_FLOP_RTOL}); static peak "
        f"{cell['memory']['peak_bytes']:,} B beside phase 17's "
        f"max_memory_allocated {trained['max_memory_allocated']:,} B; "
        f"bound {bound_ms:.2f} ms beside phase 17's step "
        f"{trained['ms']:.2f} ms")
    if not flop_err <= DRYRUN_FLOP_RTOL:
        raise AssertionError(
            f"dryrun one-card FLOPs {traced_flops} against the real "
            f"step's {real}: {flop_err:.3g} > {DRYRUN_FLOP_RTOL}")

    # (c) the model scope reads the cells
    doc = os.path.join(out, "model_scope.json")
    r = checked_run("run", "--enable-scope", "model",
                    "--benchmark_filter", "dryrun_rooflines",
                    "--model.dryrun_dir", out, "--results-dir", "",
                    "--benchmark_out", doc)
    with open(doc) as f:
        (rec,) = json.load(f)["benchmarks"]
    ok_cells = sum(d["status"] == "ok" for d in cells.values())
    if rec.get("skipped") or rec.get("error_occurred") or \
            rec["cells"] < 6 or rec["cells"] != ok_cells:
        raise AssertionError(f"model/dryrun_rooflines over the cells: "
                             f"{rec}")
    row["model_scope"] = {"cells": rec["cells"],
                          "sum_bound_s": rec["sum_bound_s"],
                          "wall_s": r.wall_s}
    log(f"  model/dryrun_rooflines: cells {rec['cells']}, sum_bound_s "
        f"{rec['sum_bound_s']:.6g} ({r.wall_s:.1f} s)")

    # (d) the report over the cells
    rep = python_module("repro_torch.roofline.report", "--dir", out,
                        cwd=ROOT)
    if rep.returncode != 0 or \
            f"| {DRYRUN_ARCH} | train_4k | ok |" not in rep.stdout:
        raise AssertionError(f"roofline.report exited "
                             f"{rep.returncode}:\n{rep.stdout[-2000:]}"
                             f"\n{rep.stderr[-2000:]}")
    row["report"] = {"wall_s": rep.wall_s,
                     "lines": len(rep.stdout.splitlines())}
    for line in rep.stdout.splitlines():
        if line.startswith(f"| {DRYRUN_ARCH}"):
            log("  " + line)
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"dryrun phase: {row['phase_s']:.1f} s")
    return row


#: Phase 21, the multi-rank runtime on one card.  (a) The gradient
#: codecs over llama3.2-1b's full-width parameter tree (1.24e9 float32
#: values, a gradient's stand-in) on the card; two leaves held to the
#: CPU codec bit for bit.
CODEC_LEAVES = (("embed", "table"), ("blocks", "mlp", "w_up"))
#: (b) deepseek-moe-16b at its published width (d 2048, 64 experts,
#: top-6, expert d_ff 1408, 2 shared) with ``num_layers`` cut to
#: ``MOE_LAYERS``: the layer in float32 at B x S ``MOE_CHECK`` against
#: ``moe_scatter`` within ``MOE_TOL``, its ms both ways in bf16 at
#: ``MOE_TIME``, and one meshed train step at ``MOE_STEP``.
MOE_ARCH, MOE_LAYERS = "deepseek-moe-16b", 2
MOE_CHECK, MOE_TIME, MOE_STEP = (1, 512), (2, 4096), (1, 512)
MOE_TOL = 1e-5
#: (c) the meshed trainer at phase 17's shape and policy, full width and
#: depth, ``MULTIRANK_STEPS`` steps with a sharded save at the last;
#: (d) phase 17's resume check (reduced llama, 2 layers, float32) on
#: the meshed path.
MULTIRANK_STEPS = 4
MULTIRANK_TIMEOUT_S = 900


def _cuda_ms(fn, reps: int = 3):
    """(the last result, the median ms of ``reps`` fenced calls)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(times)[len(times) // 2]


def _leaf(t, path):
    for k in path:
        t = t[k]
    return t


def codec_checks(hw: dict) -> dict:
    """Phase 21 (a): both codecs over the full-width tree on the card,
    their bytes and ms; the embedding and layer 0's ``w_up`` through
    the CPU codec, bit-equal."""
    from repro_torch.distributed import compression as C
    from repro_torch.models import build, get_config, tree
    cfg = get_config(TRAIN_ARCH)
    grads = build(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    n = sum(t.numel() for t in tree.flatten(grads))
    bf16, bf16_ms = _cuda_ms(lambda: C.bf16_compress(grads))
    _, bf16_back_ms = _cuda_ms(lambda: C.bf16_decompress(bf16))
    (packed, err), int8_ms = _cuda_ms(lambda: C.ef_compress_tree(grads))
    _, int8_back_ms = _cuda_ms(lambda: C.ef_decompress_tree(packed, grads))
    int8_bytes = sum(p["q"].numel() + 4 * p["scale"].numel() + 4
                     for p in C.packed_leaves(packed))
    equal = {}
    for path in CODEC_LEAVES:
        g = _leaf(grads, path)
        if path[0] == "blocks":                 # layer 0 of the stack
            g = g[0]
        cpu = g.to("cpu")
        cp, ce = (t["g"] for t in C.ef_compress_tree({"g": cpu}))
        blocks = cp["q"].shape[0]
        card_p, card_e = _leaf(packed, path), _leaf(err, path)
        card_e = card_e[0] if path[0] == "blocks" else card_e
        equal["/".join(path)] = bool(
            torch.equal(card_p["q"][:blocks].cpu(), cp["q"])
            and torch.equal(card_p["scale"][:blocks].cpu(), cp["scale"])
            and torch.equal(card_e.cpu(), ce)
            and torch.equal(C.bf16_compress(cpu).view(torch.int16),
                            C.bf16_compress(g).cpu().view(torch.int16)))
    del grads, bf16, packed, err
    torch.cuda.empty_cache()
    row = {"values": n, "float32_bytes": 4 * n, "bf16_bytes": 2 * n,
           "int8_bytes": int8_bytes, "int8_ratio": 4 * n / int8_bytes,
           "bf16_compress_ms": bf16_ms, "bf16_decompress_ms": bf16_back_ms,
           "int8_ef_compress_ms": int8_ms,
           "int8_ef_decompress_ms": int8_back_ms,
           "bit_equal_to_cpu": equal}
    log(f"multirank (a) codecs over {TRAIN_ARCH}'s {n:,} float32 values "
        f"on {hw['card']}: {4 * n:,} B; bf16 {2 * n:,} B, compress "
        f"{bf16_ms:.2f} ms, decompress {bf16_back_ms:.2f} ms; int8 with "
        f"error feedback {int8_bytes:,} B ({row['int8_ratio']:.3f}x), "
        f"compress {int8_ms:.2f} ms, decompress {int8_back_ms:.2f} ms; "
        f"bit-equal to the CPU codec: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"multirank (a): card codec differs from the "
                             f"CPU's: {equal}")
    return row


def _moe_checks() -> dict:
    """Phase 21 (b), in the launcher's child: deepseek-moe-16b's MoE
    layer at full width on the (1, 1) mesh of a one-rank NCCL group."""
    from repro_torch.distributed import logical, partition as part
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import build, get_config
    from repro_torch.models import layers as L
    cfg = get_config(MOE_ARCH).override(num_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = L.init_moe(gen, cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff,
                   cfg.moe_num_shared)
    out: dict = {"arch": MOE_ARCH, "layers": MOE_LAYERS,
                 "d_model": cfg.d_model, "experts": cfg.moe_num_experts,
                 "top_k": cfg.moe_top_k, "moe_d_ff": cfg.moe_d_ff,
                 "shared": cfg.moe_num_shared,
                 "reduced": f"num_layers {cfg.num_layers} of "
                            f"{get_config(MOE_ARCH).num_layers}"}

    def scatter(x):
        return L.moe_scatter(p, x, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor,
                             act=cfg.act, n_shared=cfg.moe_num_shared)[0]
    with make_host_mesh(1, device_type="cuda") as mesh:
        c32 = cfg.override(dtype="float32")
        rules = logical.default_rules(c32, mesh)
        if rules["experts"] != "model":
            raise AssertionError(f"experts not on 'model': {rules}")
        dp = part.distribute_tree(p, part.param_specs(cfg, {"moe": p},
                                                      mesh)["moe"], mesh)
        B, S = MOE_CHECK
        x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda")
        with torch.no_grad(), logical.logical_rules(rules):
            y = L.moe_layer(dp, part.distribute(x, mesh, (
                "data", None, None)), c32)[0].full_tensor()
            err = float((y - scatter(x)).abs().max())
        out["float32_max_abs_err"] = err
        B, S = MOE_TIME
        xb = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        dxb = part.distribute(xb, mesh, ("data", None, None))
        with torch.no_grad(), logical.logical_rules(rules):
            out["bf16_ms"] = {
                "moe_shard_map": time_ms(lambda: L.moe_layer(dp, dxb, cfg)),
                "moe_scatter": time_ms(lambda: scatter(xb))}
    del p, dp
    torch.cuda.empty_cache()
    # one meshed train step against the inference loss on its weights
    B, S = MOE_STEP
    api = build(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    batch = _on(_train_batches(cfg, 1, B, S)[0], "cuda")
    with torch.inference_mode():
        want = float(api.loss(params, batch)[0])
    del params
    torch.cuda.empty_cache()
    res = train(MOE_ARCH, steps=1, global_batch=B, seq_len=S, lr=TRAIN_LR,
                reduced=False, overrides={"num_layers": MOE_LAYERS},
                log_every=1, seed=0, device="cuda")
    h = res["history"][0]
    out["step"] = {"batch": B, "seq": S, "loss": h["loss"],
                   "grad_norm": h["grad_norm"], "loss_inference": want,
                   "ms": h["seconds"] * 1e3}
    torch.cuda.empty_cache()
    return out


def _meshed_train(first_loss: float) -> dict:
    """Phase 21 (c), in the launcher's child: phase 17's run on the
    meshed path, a sharded save at its last step, read back with every
    checksum; then one profiled step of the same state on the mesh."""
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.checkpoint.store import load_manifest
    from repro_torch.distributed import partition as part
    from repro_torch.distributed.logical import default_rules, logical_rules
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build, get_config
    from repro_torch.train import AdamWConfig, make_init_fn, make_train_step
    cfg = get_config(TRAIN_ARCH).override(**TRAIN_OVERRIDES)
    ckpt = tempfile.mkdtemp(prefix="multirank-", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        torch.cuda.reset_peak_memory_stats()
        res = train_mod.train(
            TRAIN_ARCH, steps=MULTIRANK_STEPS, global_batch=TRAIN_BATCH,
            seq_len=TRAIN_SEQ, lr=TRAIN_LR, reduced=False,
            overrides=TRAIN_OVERRIDES, log_every=1, seed=0, device="cuda",
            ckpt_dir=ckpt, ckpt_every=MULTIRANK_STEPS)
        peak = torch.cuda.max_memory_allocated()
        mgr = CheckpointManager(ckpt)
        path = mgr.path_for(MULTIRANK_STEPS)
        t0 = time.perf_counter()
        _, step = load_checkpoint(path, train_mod._state_like(cfg),
                                  verify=True)
        load_s = time.perf_counter() - t0
        manifest = load_manifest(path)
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    hist = res["history"]
    times = [h["seconds"] * 1e3 for h in hist]
    steady = sorted(times[2:])
    out = {"steps": len(hist), "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "step_ms": times, "ms": steady[len(steady) // 2],
           "max_memory_allocated": peak,
           "first_loss_abs_err": abs(hist[0]["loss"] - first_loss),
           "trainer_seconds": res["seconds"],
           "checkpoint": {"step": step, "bytes": ckpt_bytes,
                          "leaves": len(manifest["leaves"]),
                          "process_count": manifest["process_count"],
                          "load_verify_s": load_s}}
    # one profiled step on a fresh state on the mesh
    api = build(cfg)
    opt = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=5)
    batch0 = _train_batches(cfg, 1, TRAIN_BATCH, TRAIN_SEQ)[0]
    with make_host_mesh(1, device_type="cuda") as mesh:
        like = train_mod._state_like(cfg)
        specs = train_mod._state_specs(cfg, like, mesh)
        held = {"state": part.distribute_tree(make_init_fn(api, opt)(
            torch.Generator(device="cuda").manual_seed(0)), specs, mesh)}
        dbatch = part.distribute_tree(
            batch0, part.input_specs_tree(cfg, batch0, mesh), mesh)
        step_fn = make_train_step(api, opt, grad_specs=specs["opt"]["m"])
        t0 = time.perf_counter()
        with logical_rules(default_rules(cfg, mesh)):
            def one_step():
                held["state"], m = step_fn(held["state"], dbatch)
                return float(m["loss"].full_tensor())
            # the kernels are warm from the trainer's steps; the device
            # alone is traced
            out["profiled_step"] = profile_step(one_step, ops=False)
        out["profile_s"] = time.perf_counter() - t0
        del held["state"]
    torch.cuda.empty_cache()
    return out


def _elastic_resume() -> dict:
    """Phase 21 (d), in the launcher's child: phase 17's (d) on the
    meshed path, the resume through ``restore_resharded``."""
    from repro_torch.launch.train import train
    kw = dict(steps=14, global_batch=2, seq_len=32, lr=1e-3, seed=5,
              log_every=100, device="cuda",
              overrides={"num_layers": 2, "dtype": "float32"})
    full = train(TRAIN_ARCH, **kw)
    ckpt = tempfile.mkdtemp(prefix="multirank-resume-",
                            dir=os.path.join(ROOT, "build"))
    try:
        half = train(TRAIN_ARCH, ckpt_dir=ckpt, ckpt_every=7, halt_at=7,
                     **kw)
        resumed = train(TRAIN_ARCH, ckpt_dir=ckpt, ckpt_every=7, **kw)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"full_last_loss": full["last_loss"],
            "resumed_last_loss": resumed["last_loss"],
            "halted_steps": half["steps"], "resumed_steps": resumed["steps"],
            "abs_err": abs(resumed["last_loss"] - full["last_loss"])}


def multirank_child(first_loss: float) -> dict:
    """Phase 21 (b)–(d) in a process a launcher started
    (``WORLD_SIZE`` 1): it joins the one-rank NCCL group
    (``launcher_group``) and runs every check on the meshed path."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import launcher_group
    if launcher_group("cuda") != 1 or dist.get_backend() != "nccl":
        raise AssertionError("no one-rank NCCL group from the launcher")
    try:
        out = {"backend": dist.get_backend(),
               "world_size": dist.get_world_size()}
        for name, fn in (("moe", _moe_checks),
                         ("train", lambda: _meshed_train(first_loss)),
                         ("resume", _elastic_resume)):
            t0 = time.perf_counter()
            out[name] = fn()
            out[name]["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multirank(hw: dict, trained: dict) -> dict:
    """Phase 21: the multi-rank runtime on one card (see the module
    docstring): (a) here, (b)–(d) in a child with a launcher's
    environment for one rank (as ``torchrun --standalone
    --nproc-per-node 1`` sets it)."""
    t_phase = time.perf_counter()
    row = {"card": hw["card"], "codecs": codec_checks(hw)}
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join(filter(None, [
                   os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH")])))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c",
         "import json, sys, chip_smoke; print(json.dumps("
         "chip_smoke.multirank_child(float(sys.argv[1]))))",
         repr(trained["loss"][0])],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=MULTIRANK_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"multirank child exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    child = json.loads(r.stdout.strip().splitlines()[-1])
    row.update(child, child_wall_s=time.perf_counter() - t0)
    moe, tr, res = child["moe"], child["train"], child["resume"]
    step = moe["step"]
    moe_step_err = abs(step["loss"] - step["loss_inference"])
    log(f"multirank (b) {MOE_ARCH} at full width ({moe['reduced']}) on a "
        f"one-rank {child['backend']} mesh (1, 1): the expert-parallel "
        f"layer float32 B{MOE_CHECK[0]} x S{MOE_CHECK[1]} against "
        f"moe_scatter: max abs err {moe['float32_max_abs_err']:.3g} (tol "
        f"{MOE_TOL}); bf16 B{MOE_TIME[0]} x S{MOE_TIME[1]}: moe_shard_map "
        f"{moe['bf16_ms']['moe_shard_map']:.3f} ms, moe_scatter "
        f"{moe['bf16_ms']['moe_scatter']:.3f} ms; one meshed train step "
        f"B{step['batch']} x S{step['seq']}: loss {step['loss']:.6f} "
        f"(inference {step['loss_inference']:.6f}, {moe_step_err:.3g}), "
        f"grad_norm {step['grad_norm']:.4f}, {step['ms']:.1f} ms; "
        f"{moe['wall_s']:.1f} s")
    log(f"multirank (c) {TRAIN_ARCH} full width, B{TRAIN_BATCH} x "
        f"S{TRAIN_SEQ}, {tr['steps']} meshed steps on (1, 1): median "
        f"{tr['ms']:.2f} ms a step from step 3 (phase 17 "
        f"{trained['ms']:.2f} ms); steps " + ", ".join(
            f"{t:.1f}" for t in tr["step_ms"])
        + f"; max_memory_allocated {tr['max_memory_allocated']:,} B (phase "
        f"17 {trained['max_memory_allocated']:,} B); loss "
        + ", ".join(f"{v:.4f}" for v in tr["loss"])
        + f"; first loss against phase 17's: {tr['first_loss_abs_err']:.3g}"
        f" (tol {TRAIN_FIRST_LOSS_TOL}); checkpoint step "
        f"{tr['checkpoint']['step']}, {tr['checkpoint']['bytes']:,} B, "
        f"{tr['checkpoint']['leaves']} leaves, read back with every crc in "
        f"{tr['checkpoint']['load_verify_s']:.1f} s; the trainer "
        f"{tr['trainer_seconds']:.1f} s (the save's wait included), the "
        f"profiled step {tr['profile_s']:.1f} s; {tr['wall_s']:.1f} s")
    prof = tr["profiled_step"]
    log(f"  profiled meshed step: wall {prof['wall_ms']:.2f} ms, device "
        f"busy {prof['device_busy_ms']:.2f} ms (idle share "
        f"{prof['idle_share']:.4f}), {prof['kernels']} kernels (phase 17: "
        f"{trained['profiled_step']['wall_ms']:.2f} ms, "
        f"{trained['profiled_step']['device_busy_ms']:.2f} busy, "
        f"{trained['profiled_step']['kernels']} kernels)")
    log(f"multirank (d) resume on the meshed path: halted after "
        f"{res['halted_steps']} steps, resumed for {res['resumed_steps']}; "
        f"last loss {res['resumed_last_loss']:.6f} against the "
        f"uninterrupted {res['full_last_loss']:.6f}: {res['abs_err']:.3g} "
        f"(tol {TRAIN_RESUME_TOL}); {res['wall_s']:.1f} s")
    finite = all(math.isfinite(v) for v in tr["loss"] + tr["grad_norm"]
                 + [step["loss"], step["grad_norm"]])
    if not (moe["float32_max_abs_err"] <= MOE_TOL and finite
            and moe_step_err <= TRAIN_FIRST_LOSS_TOL
            and tr["steps"] == MULTIRANK_STEPS
            and tr["first_loss_abs_err"] <= TRAIN_FIRST_LOSS_TOL
            and tr["checkpoint"]["step"] == MULTIRANK_STEPS
            and tr["checkpoint"]["process_count"] == 1
            and res["halted_steps"] == 7 and res["resumed_steps"] == 7
            and res["abs_err"] <= TRAIN_RESUME_TOL):
        raise AssertionError(f"multirank: {child}")
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"multirank phase: {row['phase_s']:.1f} s")
    return row


def main() -> int:
    hw = phase_device()
    sass = phase_build()
    kernels = [phase_matmul(hw), phase_histogram(hw), phase_flash(hw),
               phase_rmsnorm(hw), phase_ssd(hw), phase_decode_attention(hw)]
    flash_train = phase_flash_train(hw)
    models = phase_models(hw)
    host = phase_host_path()
    launches, by_variant, model_free = phase_main_path()
    idle = phase_idle_share()
    pipeline = phase_pipeline()
    incremental = phase_incremental()
    tune = phase_tune()
    serve = phase_serve(hw)
    serve["scope_child"] = phase_serve_scope()
    trained = phase_train(hw)
    started = start_dryrun()
    try:
        report = phase_report()
        linted = phase_lint()
        dry = phase_dryrun(hw, trained, started)
    finally:
        stop_dryrun(started)
    multirank = phase_multirank(hw, trained)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["sass"] = sass[k["name"]]
        if k["name"] in by_variant:
            k["launches_by_variant"] = by_variant[k["name"]]
    print(json.dumps({"pipeline": pipeline}), flush=True)
    print(json.dumps({"incremental": incremental}), flush=True)
    print(json.dumps({"tune": tune}), flush=True)
    print(json.dumps({"host_path_us": host, "main_path_idle": idle,
                      "main_path_model_free": model_free}), flush=True)
    print(json.dumps({"models": models}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"report": report}), flush=True)
    print(json.dumps({"lint": linted}), flush=True)
    print(json.dumps({"dryrun": dry}), flush=True)
    print(json.dumps({"multirank": multirank}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"flash_train": flash_train}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
