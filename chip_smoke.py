#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``coinstac_dinunet_tpu_torch``) on one
NVIDIA card.

Phases, in order; any failure exits non-zero before the last line:

1. device — the card's name and power limit, TF32 switches set explicitly;
2. build — every hand-written kernel from ``coinstac_dinunet_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a`` (one compiler per source, started together),
   and the native wire runtime (``coinstac_dinunet_tpu_torch/native/wire.cc``)
   with ``g++``; a build that fails fails the run;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and at edge shapes, with kernel,
   plain-version, bound and library times: K1 (int8 quantize) bit-equal,
   one leaf a launch and whole payloads in one launch (the data section of
   one VBM gradient, special values and the edges of the kernel's fast
   division, edge sizes, a misaligned view, 200 segments);
   K2–K4 (flash-attention forward, dq, dk/dv) at head dims 16, 32, 64 and
   128 (16: the sequence example's attention, B 8, H 4, T 128, in both
   types, and T 4096) within stated tolerances
   (the bfloat16 tensor-core forward, dq and dk/dv against the plain
   version with the kernels' bfloat16 roundings and against the float32
   one, with ``scaled_dot_product_attention``'s forward and backward as the
   witnesses of the format's error), with bit-identical results from two
   launches of each;
4. reference — the VBM model's and the sequence model's logits on the card
   against the CPU on a small input (float32, TF32 off), within 1e-4; the
   compression math (``orthogonalize``, ``power_iteration_BC`` with the
   start block injected) on the card against the CPU at the rankDAD embed
   layer's shapes, within 1e-4·max;
5. main path 1 — ``InProcessEngine`` federated dSGD over 2 sites, the VBM
   3-D CNN at its full width 16, 64³ input, batch 16, bfloat16 autocast,
   the int8 wire codec (``precision_bits=8``), run to SUCCESS; in every
   gradient round K1 must have launched once per payload (2 sites + the
   aggregator) over all 23 leaves of each, and the outputs must be finite;
6. main path 2 — ``InProcessEngine`` federated dSGD over 2 sites, the
   sequence transformer at its full width (d_model 128, 4 heads, 2 blocks)
   on 4096-step sequences, batch 16, bfloat16 autocast, run to SUCCESS;
   K2, K3 and K4 must each have launched in every gradient round, once per
   block and site at least, and the outputs must be finite;
7. main path 3 — path 1's VBM federation with ``agg_engine="powerSGD"``
   (rank 1, one dSGD warm-up round) after a local pretrain of one epoch on
   the site with the most data: the aggregator's broadcast reaches every
   site and each site's parameters equal the pretrainer's best weights bit
   for bit after the load; in every gradient round K1 launched once per
   payload per node (dSGD 23 segments, P 8, Q 8, rank-1 15), and the
   payloads of the first round of each kind bit-equal to K1's plain version
   on the same leaves; SUCCESS with finite outputs; wire bytes of the P
   round and the Q + rank-1 round;
8. main path 4 — path 2's sequence federation with ``agg_engine="rankDAD"``
   (rank 10, 5 power iterations) at ``precision_bits=8``: the capture plan
   is exactly the embed and the head; K2, K3 and K4 launched in every
   gradient round and K1 once per payload per node (factors 4 segments,
   rest 23), one round's payloads bit-equal to K1's plain version on the
   same leaves; SUCCESS with finite outputs; wire bytes per round and a
   profiled steady round;
9. main path 5 — path 2's configuration, cut in depth to
   ``FRESH_SITES`` site of ``FRESH_SEQ_FILES`` subjects (one gradient
   round: every invocation pays a process start), through ``SubprocessEngine`` and
   the port's ``seq_classification`` entry scripts with
   ``persist_round_state`` and ``--device cuda``: every site and aggregator
   invocation a fresh ``python`` process (a wrapper written to a temporary
   directory runs the entry module's ``compute`` and appends the process's
   kernel launch counts and clock readings to a JSON-lines file).  SUCCESS
   in the number of rounds of the same federation run in one process
   (``run_seq_path`` at that size); ``train_log``,
   ``validation_log``, ``test_metrics`` and every site's final parameters
   (from its round file) equal that run's bit for bit; K2, K3 and K4
   launched in every
   gradient-round site invocation, once per block at least; the round file
   at every site; the cost of an invocation split into the start-up before
   the node's entry, the node's compute, and the total;
10. main path 6 — path 2's configuration through ``DaemonEngine`` (one
   warm worker process per site and aggregator, the same entry scripts
   behind a wrapper that records each invocation's pid, kernel launches,
   clocks, ``torch._dynamo`` import and round-file write) with
   ``persist_round_state`` and the engine's telemetry lane; site_1's
   worker SIGKILLed after the first gradient round.  SUCCESS in path 2's
   number of rounds with path 2's results bit for bit, K2–K4 launched as
   in path 2 inside the workers and in every gradient-round site
   invocation once per block at least, 3 ``worker:start`` and 1
   ``worker:restart`` (site_1, generation 2), cold frames on each worker's
   first invocation only, one pid per target (site_1's two), no worker
   left on the card after ``close()``; the cost of a worker's start, its
   first and steady invocations, the restart, the frames and the round
   files;
11. main path 7 — path 2's model on 3 sites through ``DaemonEngine`` with
   staleness-bounded async rounds (k 1, an invocation pool of 3, discount
   0.5), ``site_quorum=2``, two invoke attempts, ``precision_bits=8``, and
   a chaos fault plan (``ASYNC_FAULTS``): site_1's worker killed between
   rounds (one ``worker:restart``, generation 2), site_0 slowed (a stand-in
   at lag 1 that the aggregator's window accepts and the reducer weighs
   0.5), a stale replay, site_2 crashed for good (``site_died``,
   ``quorum:drop``, ``quorum:continue``), site_1's gradient payload
   corrupted (``chaos:heal`` through the aggregator's retry).  SUCCESS with
   finite test metrics, every expected event on the engine lane, K2–K4 in
   every gradient-round site invocation once per block at least and K1
   once per int8 payload per node inside the workers, no worker left on
   the card; each round's wall time with its events, and for the steady
   rounds the sites' summed compute over the round's wall time (the card's
   concurrency over the workers' contexts); the compute processes
   ``nvidia-smi`` lists while the workers are up;
12. main path 8 — the site-vectorized federation (``SiteVectorizedEngine``:
   every site's step as one forward and one backward over the sites'
   batches folded into one).  12a: path 2's configuration through it, its
   train, validation, test and global test logs within 2e-3 of path 2's
   (the JAX package's tolerance between its vectorized and file
   transports; if bfloat16 misses it, the distance is printed and a
   float32 rerun of both must meet it).  12b: 16 sites of 192 subjects
   (9 full gradient rounds in the epoch) at path 2's width, 2 of them
   killed at round 2 (``fraction_kill_plan``)
   under ``site_quorum=0.75``, one spare slot joining at round 3: SUCCESS
   with finite test metrics, exactly the planned sites dead, one
   ``membership:join`` on the engine lane, K2, K3 and K4 each launched
   ``num_layers × k`` times in every gradient round whatever the number
   of sites (in 12a too); each round's wall time and samples, the median
   and range over the full-batch rounds after the join, the lane's
   ``rounds_per_sec``/``sites_per_sec``, ``torch.cuda.max_memory_allocated``
   and a profiled full-batch round in the middle of the epoch (from the
   end of the previous round's step to the end of its own, the data
   loading included);
13. main path 9 — path 2's model and arguments through ``DaemonEngine``
   with the int8 wire, the k-ary tree fan-in (k 2), async rounds (k 1),
   run-ahead (d 1) and ``site_quorum=2``: three founding sites and a spare
   worker, and a plan (``MEM_FAULTS``) of a join, a graceful leave, a crash
   and a rejoin.  13a: SUCCESS with finite test metrics, the roster epoch
   1 + the operations, one ``membership:*`` event per operation (the leave
   no ``site_died``), each joiner's first contribution in the round after
   its admission, each joiner's warm-started state (parameters, Adam
   moments and steps) bit-equal to its donor's and, after its first
   update, to every founding member's that applied the same broadcast,
   ``pipeline:reduce_concurrent`` seconds > 0 and ``site_run_ahead`` on
   the engine lane, a ``pipeline:drain`` (membership) in each operation's
   round, the aggregator's tree mean within 2e-6 of the flat guarded mean
   of the same payloads in two gradient rounds, K1–K4 launched in every
   site worker (the joiners' included), no worker left on the card.  13b:
   two sites, no faults, k 0, a pool of 2, three runs — d 1 under the
   engine's ``_PIPELINE_FORCE_DRAIN``, d 0, d 1 pipelined: the first two
   end on the same ``avg_grads``, cursors and logs bit for bit; the steady
   rounds of the last two side by side.  The aggregator's quorum, window,
   discount and membership records of paths 7 and 9 are read from its own
   lane (``remote_out/telemetry.remote.jsonl``) merged with the engine's;
14. main path 10 — the health layer, run right after phase 2 (late in a
   long process ``torch.profiler``'s trace came without the round's first
   kernels).  10a: path 2's model and arguments
   on 3 sites through ``InProcessEngine`` with the int8 wire, the tree
   fan-in (k 2), ``profile``, ``quarantine_on_anomaly`` and
   ``capture_on_anomaly``; site_2's batch of one gradient round R is NaN
   (its inputs, so every gradient).  SUCCESS with finite test metrics;
   K1–K4 launched; on the aggregator's lane an ``anomaly:nonfinite``
   attributed to site_2 at R, a ``reduce:nonfinite_skip`` naming it, its
   ``quarantine``, ``survivors`` 2 from R on, the site-agreement series at
   every tree reduce; site_2's inputs carry ``health.quarantined``; site_2's
   round R + 1 captured by ``torch.profiler`` (the anomaly on its own
   ``grad_norm`` armed it), the Chrome trace under its output directory
   naming K2–K4's device kernels; the ``grad_norm``, ``update_norm``,
   ``val_score``, ``samples_per_sec`` and memory series, the memory limit
   the card's total (``torch.cuda.mem_get_info``).  10b: path 8's 12a
   configuration with ``profile`` and ``capture_on_anomaly``: every
   round's ``rounds_per_sec``, ``sites_per_sec`` and memory sample, the
   ``fed_step`` samples/s, no anomaly; the wall and steady round times of
   both (10a's first gradient round holds the process's first launches on
   the card);
15. main path 11 — the other metrics and data: path 1's VBM configuration
   reading NIfTI files (``NiftiVBMDataset``) written on SPM's standard-space
   grid (91 x 109 x 91, center-cropped to 64^3), half float32 ``.nii.gz``,
   half int16 ``.nii`` with a header slope, 64 labelled subjects and one
   unlabelled stray file a site.  11a: 3 classes (``ConfusionMatrix``)
   after a one-epoch local pretrain on site_0 through ``device_prefetch``
   (``prefetch_batches=2``): SUCCESS, each site indexing exactly its 64
   labelled files, K1 once per payload over 23 leaves in every gradient
   round, every log row loss + P, R, F1 and accuracy, the reduced test
   matrix summing to the test subjects, the broadcast load bit-equal, and
   the pretrainer's weights bit-equal to a rerun with
   ``prefetch_batches=0`` (cuDNN's deterministic algorithms for both).
   11b: ``monitor_metric="auc"`` on the binary labels
   (``labels_file``): every validation and the global test AUC in (0, 1],
   the global test AUC within 1e-4 of this script's rank-sum AUC over the
   (probability, label) pairs the aggregator received, K1 as in 11a.
   11c: path 8's 12a configuration with the AUC through
   ``SiteVectorizedEngine`` against ``InProcessEngine``: the four logs
   within 2e-3 (bfloat16, or a float32 rerun of both), the train-log AUC
   above 0, K2-K4 in every gradient round.  Printed: the data's writing
   time, the host ms to read a batch of 16 volumes of each kind, the
   pretrain epoch with ``prefetch_batches`` 0 and 2 in turns, 11a's
   gradient rounds and a profiled one, the wall times of 11a-11c.

16. main path 12 — the FLOP count and the telemetry tools, run right
   after phase 14 (its lanes).  16a: one ``grads`` step of path 1's VBM
   (width 16, 64^3, batch 16) and one of path 2's transformer (T 4096,
   batch 16), bfloat16, each a fresh trainer's first step with telemetry
   on, so counted (``record_jit_cost``): each count equals the closed form
   of ``models/flops.py``, K2, K3 and K4 launched during the transformer's
   counted step, ``perf:backend`` names the card at 989 TFLOP/s, and the
   next step's ``mfu`` lies in (0, 1); GFLOP a step and the attention share
   printed.  16b: phase 14's lanes through the port's tools: ``python -m
   coinstac_dinunet_tpu_torch.telemetry`` writes the summary and a Chrome
   trace naming every node's lane, ``doctor`` markdown and JSON whose
   roofline names the card at 989 TFLOP/s and whose first verdict is
   site_2's (critical), every site's lane with ``achieved_tflops`` and
   ``mfu`` for ``grads`` and 10b's for ``fed_step``, each ``mfu`` in (0, 1);
   one ``watch`` snapshot with ``--serve``, and ``/metrics`` and ``/healthz``
   served on 127.0.0.1 and scraped, show ``mfu``; the medians of the steady
   samples printed.

17. main path 13 — the remaining models.  17a: ResNet-18 at config 4
   (64x64x3, width 64, batch 256, bfloat16) through ``InProcessEngine``
   over 16 sites, dSGD on the int8 wire to SUCCESS, every site warm-started
   through ``pretrained_path`` from a ``source='coinstac'`` ``weights.tar``
   of a torchvision-style ResNet-18 written here after one Adam step:
   each site's weights after the load bit-equal to the file's, then the
   file's Adam state loaded (every parameter's ``step`` the file's count);
   K1 once per payload (62 segments) in every gradient round, every site's
   parameters equal after the run; the second gradient round's host time
   split by part (``HostSplit``, fenced), the third neither fenced nor
   profiled (the steady round and its samples/s), the last profiled; one
   counted grads step equals ``resnet18_grads_flops`` (its TFLOP/s and mfu
   printed).  17b: one grads step of 17a's model and of path 1's VBM with
   ``fused_groupnorm`` on and off from the same weights and batch:
   gradients within 1e-2 x the largest gradient of all leaves (the worst
   leaf's gap against its own largest gradient printed), the fused norm
   called only when on, both step times printed.  17c: two VBM nets
   (config 5: 32^3, width 16, batch 128, bfloat16) on 4 sites, dSGD on the
   int8 wire to SUCCESS, K1 once per payload (46 segments), the sites'
   parameters equal after every round and every leaf of both nets changed
   from the seeded start.

18. main path 14 — the native wire, background commits and the examples'
   simulations, run after phase 17.  14a: 17 ResNet-18 gradient payloads at
   config 4 (62 leaves, 11.18 M values), int8 through K1 and float32, each
   packed once and committed by the native gather-write and by the Python
   writer (``COINN_NATIVE=0``): the files equal byte for byte; read back by
   the native many-file reader, through read-only maps and by the Python
   loop: the arrays equal bit for bit; the guarded flat and tree (k 4)
   means with the fan-in's maps on and off equal bit for bit; ms a payload
   written and read and the fan-in seconds of each way, and path 13a's
   fenced payload reads and writes beside the Python wire's.  14b: path 1 with
   ``async_wire_commit``: the same rounds, logs, parameters and every
   round's payload files bit for bit, K1 once a payload, every payload
   committed by the background thread and none pending at any node's
   output.  14c: the FSV, VBM and sequence examples' ``run_sim.main`` at
   their ``inputspec.json`` sizes to SUCCESS with finite global test
   metrics, the sequence example through K2-K4 at head dim 16 in every
   gradient round, the training-curve PNGs decoded where matplotlib
   imports (else the skip is printed).  Paths 1-13 run on the native wire
   and the mapped fan-in too (the defaults); path 1 checks that every
   payload was gather-written and every site's read of the mean was native.

19. main path 15 — the mesh planes, every rank on the one card
   (``devices=["cuda:0"] * n``).  15a: path 2's configuration through
   ``MeshEngine`` with ``sequence_parallel`` 2 (2 sites × 2 ranks, the ring
   over K2–K4) against ``MeshFederation`` with one rank a site, 3 gradient
   rounds each: K2, K3 and K4 launched exactly sites × ranks × hops ×
   blocks times a round (16 and 4), the losses of the logs within
   ``MESH_LOSS_ATOL``, the final parameters within ``MESH_PARAM_ATOL``, and
   the first round's reduced gradient, leaf by leaf, within
   ``MESH_GRAD_RTOL`` of the leaf's norm, a check shown to fail on
   ``MESH_FAULTS`` planted in the same gradients.
   15b: the same with ``tensor_parallel`` 2 (8 launches a round).  15c: the
   ring at sp 2 and 4 and Ulysses at sp 2 and 4, causal and not, at B 2,
   H 4, T 4096, d 32 in bfloat16, outputs and q/k/v gradients within
   ``RING_RTOL`` of one ``flash_attention`` call, their launches counted,
   and rank 0's fully masked hops of a causal ring of 4 (zeros, the
   sentinel lse, zero gradients under a nonzero ``g_lse``).  15d: the
   sequence example's ``main_mesh(sp=2)`` at its ``inputspec.json`` size
   (head dim 16) to SUCCESS, its launches counted a round.  Each part
   timed.

20. main path 16 — the sharded transformer steps (``parallel/sequence.py``,
   ``parallel/pipeline.py``), every rank on the one card, at
   ``TSPConfig``'s full width (``TSP_ARGS``: d_model 128, 8 heads of 16, 2
   layers, d_ff 512; T 4096, batch 16), each mesh against one rank from the
   same weights and batches: first a float32 pair (the logits, the aux
   loss and the first step's gradient, leaf by leaf, within
   ``TSP_F32_RTOL``, the MoE's within ``TSP_F32_MOE_RTOL``), then bfloat16,
   the logits within ``TSP_LOGITS_RTOL``, the first gradient within
   ``TSP_GRAD_RTOL`` of each leaf's norm (``MESH_FAULTS`` planted in it
   read above the gate), three donated steps whose losses lie within
   ``TSP_LOSS_ATOL`` and whose updates within ``TSP_GRAD_RTOL`` of one
   rank's, each fenced (the MoE's bfloat16 gates: ``TSP_MOE_LOGITS_RTOL``,
   ``TSP_MOE_GRAD_RTOL``).  16a: the dense causal step on dp2 x tp2 x sp2,
   K2/K3/K4 exactly 32 a step (2 on one rank).  16b: the switch MoE (4
   experts, capacity factor 1.25) on tp2 x sp2 x ep2: 16 a step (attention
   is not replicated over ``ep``), the dropped-token share of each layer
   and the tokens routed otherwise than on one rank printed, the steps'
   peak memory below one ``(N, E, C)`` float32 dispatch tensor.  16c: GPipe
   on pp2 x dp2 with 4 microbatches against pp 1 on 16a's weights stacked:
   16 a step (8 on pp 1), each stage holding one of the two layers, its
   bytes printed.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` name/power
line, and the last line ``{"ok": true, "device": {...}}``.  Per-shape
numbers go to ``chiprun_out/chip_smoke.json``.

Run from the repository root: ``python3 chip_smoke.py``.
"""
import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # log()'s phase headers count from here

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and the
# float32 rate outside the tensor cores, used for the integer/float work of
# the quantize kernel
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# exponentials a clock on one SM's special function units
EXP_PER_CLOCK_PER_SM = 16
# operations per element of the quantize kernel: one Philox4x32-10 call
# (10 rounds of 2 multiplies, 2 high multiplies, 4 xors, 2 key adds) per 4
# elements = 25, plus ~12 float/convert/compare steps
QUANT_OPS_PER_ELEMENT = 37

N_SITES = 2
WIDTH = 16
VBM_LEAVES = 23
# the main path's rounds traced by torch.profiler: the first gradient round
# (which also builds the models and makes the first cuDNN calls) and the
# second, a steady one
PROFILED_ROUNDS = (2, 3)

# the sequence path: the repository's configuration of the transformer
# (examples/seq_classification/compspec.json, SeqTrainer's defaults) at the
# longest sequence its positional table takes
SEQ_ARGS = dict(
    d_model=128, num_heads=4, num_layers=2, num_features=16, num_classes=2,
    seq_len=4096, max_len=4096, batch_size=16, epochs=1,
    split_ratio=[0.75, 0.125, 0.125], compute_dtype="bfloat16",
)
SEQ_FILES = 48
# path 5's depth: one site (paths 6, 7 and 9 run several through worker
# processes) of 16 subjects, 12 training sequences, one gradient round of the
# batch of 16 (path 2's 48 give three), as every invocation there pays a
# process start of 10–20 s
FRESH_SITES = 1
FRESH_SEQ_FILES = 16
SEQ_TASK = "seq_classification"  # the example whose entry scripts path 5 runs
SEQ_LOGS = ("train_log", "validation_log", "test_metrics")
SEQ_PROFILED_ROUND = 3  # the second gradient round, a steady one
# path 3: the pretrainer holds the most training data
PRETRAIN_EXTRA_FILES = 8
# the compressed wire's payloads: segments (float leaves) per payload
VBM_MATRIX_LEAVES, VBM_RANK1_LEAVES = 8, 15
SEQ_LEAVES, DAD_LAYERS, DAD_RANK = 27, 2, 10
POWER_ITERATION_RTOL = 1e-4
# the port's kernels by their device-side names, picked out of a profile
PORT_KERNEL_NAMES = ("quantize_int8", "flash_fwd", "flash_bwd", "flash_dq", "flash_dkv")


def log(msg):
    """A line of the report; a phase's header (``[n ...]``) also gives the
    seconds since the script started."""
    if msg.startswith("["):
        msg = f"{msg} | t+{time.perf_counter() - T_START:.1f} s"
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def max_sm_clock_hz():
    """The card's top SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def count_sass(_cuda, source, mnemonic):
    """How many instructions of the built library of ``source`` carry
    ``mnemonic``, by ``cuobjdump -sass`` from the compiler's directory."""
    cuobjdump = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda.library_path(source)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return sum(mnemonic in line for line in sass.splitlines())


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of ``fn()`` on the card, CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def quant_bound_ms(ns):
    """Least time for quantizing leaves of ``ns`` floats (an int or a list):
    the larger of the bytes (n·4 read, rows·128 int8 + rows·4 scales
    written, summed over the leaves) over HBM bandwidth and the operations
    over the CUDA-core rate."""
    ns = [ns] if isinstance(ns, int) else list(ns)
    moved = sum(4 * n + -(-n // 128) * 132 for n in ns)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = QUANT_OPS_PER_ELEMENT * sum(ns) / CUDA_CORE_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def vbm_leaf_shapes():
    """The wire shapes of the width-16 VBM gradient, in wire order."""
    from coinstac_dinunet_tpu_torch.interop import to_flax, wire_leaves
    from coinstac_dinunet_tpu_torch.models import VBM3DNet

    model = VBM3DNet(width=WIDTH)
    models = {"vbm_net": model}
    return [tuple(to_flax(models[m], p, models[m].get_parameter(p)).shape)
            for m, p in wire_leaves(models)]


def check_quantize(dev, report):
    """K1 against its plain version on the card: bit-equal values and
    scales at every shape, one leaf a launch, and bit-equal data sections
    for whole payloads; times for one VBM gradient payload (the main path's
    launch) and for 64 Mi values."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q
    from coinstac_dinunet_tpu_torch.utils import tensorutils

    leaf_shapes = vbm_leaf_shapes()
    if len(leaf_shapes) != VBM_LEAVES:
        raise AssertionError(f"expected {VBM_LEAVES} VBM leaves, got {len(leaf_shapes)}")
    shapes = leaf_shapes + [(64 * 1024 * 1024,), (1,), (127,), (129,), (0,)]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows_out, max_err = [], 0.0
    leaf_inputs = []
    for i, shape in enumerate(shapes):
        x = torch.randn(shape, generator=gen, device=dev) * 1e-2
        seed = 1234567 + i
        vals, scales, _ = q.quantize_int8(x, seed)
        n = x.numel()
        rows = -(-n // q.GROUP)
        groups = torch.nn.functional.pad(x.reshape(-1), (0, rows * q.GROUP - n)).view(rows, q.GROUP)
        pv, ps = q.quantize_int8_plain(groups, seed)
        torch.cuda.synchronize()
        if not (torch.equal(vals, pv) and torch.equal(scales.view(torch.int32), ps.view(torch.int32))):
            raise AssertionError(f"K1 differs from its plain version at shape {shape}")
        err = float((vals.float() * scales - pv.float() * ps).abs().max()) if n else 0.0
        max_err = max(max_err, err)
        row = {"shape": list(shape), "n": n, "bit_equal": True}
        if n:
            row["ms"] = cuda_ms(lambda: q.quantize_int8(x, seed), 20)
            row["plain_ms"] = cuda_ms(lambda: q.quantize_int8_plain(groups, seed), 3, warmup=1)
            row["bound_ms"], row["bound_by"] = quant_bound_ms(n)
            log(f"  K1 {str(shape):22s} bit-equal; kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
        else:
            log(f"  K1 {str(shape):22s} bit-equal (empty: no launch)")
        rows_out.append(row)
        if i < VBM_LEAVES:
            leaf_inputs.append((x, groups, seed))

    # the main path's work: one gradient payload = the 23 leaves in one
    # launch, written in the wire's data-section layout; then the edges (a
    # zero-size leaf among them), a 16-byte-misaligned view and 200
    # segments (four launches), each bit-equal to the batched plain version
    payload = [x for x, _, _ in leaf_inputs]
    seeds = [seed for _, _, seed in leaf_inputs]
    # groups that take the kernel's exact division (zeros, tiny, subnormal
    # and huge values, NaN, infinity) or lie at the edges of its
    # shared-reciprocal path (a scale just under 2^40; one just over 2^-40
    # with every |x| >= 2^-40)
    special = torch.randn((10, 128), generator=gen, device=dev)
    special[0, ::3] = 0.0
    special[1, 5] = 1e-30
    special[2] = 1e-42
    special[3] *= 1e30
    special[4, 9] = float("nan")
    special[5, 1] = float("inf")
    special[6] *= 1e-12
    special[7] *= 127 * 0.999 * 2.0 ** 40 / special[7].abs().max()
    special[8] = torch.sign(special[8]) * 2.0 ** -40 * (
        1 + 126 * torch.rand(128, generator=gen, device=dev))
    special[8, 0] = 128 * 2.0 ** -40
    cases = [
        ("special", [special, special[2:]], [12, 13]),
        ("vbm_payload", payload, seeds),
        ("edges", [torch.randn(s, generator=gen, device=dev) for s in [(1,), (127,), (0,), (129,)]],
         [7, 8, 9, 10]),
        ("misaligned", [torch.randn(1001, generator=gen, device=dev)[1:]], [11]),
        ("200_segments", [torch.randn(1 + i % 300, generator=gen, device=dev) for i in range(200)],
         list(range(200))),
    ]
    for case, leaves, case_seeds in cases:
        launches = q.KERNEL.launches
        got = q.quantize_int8_many(leaves, case_seeds)
        want = q.quantize_int8_many_plain(leaves, case_seeds)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"batched K1 differs from its plain version at {case}")
        n_launch = q.KERNEL.launches - launches
        log(f"  K1 batched {case:14s} {len(leaves):3d} leaves, {got.numel():8d} bytes: "
            f"bit-equal in {n_launch} launch(es)")
        rows_out.append({"case": case, "leaves": len(leaves), "bytes": got.numel(),
                         "launches": n_launch, "bit_equal": True})

    ms = cuda_ms(lambda: q.quantize_int8_many(payload, seeds), 200, warmup=10)
    plain_ms = cuda_ms(lambda: q.quantize_int8_many_plain(payload, seeds), 10)
    sizes = [x.numel() for x in payload]
    bound_ms, bound_by = quant_bound_ms(sizes)
    # the wire's whole step: one launch, one copy into pinned memory, one wait
    for _ in range(10):
        tensorutils._quantize_to_host(payload, seeds)
    t0 = time.perf_counter()
    for _ in range(100):
        tensorutils._quantize_to_host(payload, seeds)
    to_host_ms = (time.perf_counter() - t0) * 10
    log(f"  K1 VBM width-16 gradient payload ({VBM_LEAVES} leaves, {sum(sizes)} values, one "
        f"launch): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it); launch + pinned copy + wait "
        f"{to_host_ms:.4f} ms (host clock)")
    big = rows_out[VBM_LEAVES]
    log(f"  K1 at {big['n']} values: {big['bound_ms'] / big['ms']:.1%} of its byte bound")
    report["quantize_shapes"] = rows_out
    report["quantize_payload"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "to_host_ms": to_host_ms, "values": sum(sizes)}
    return {
        "name": "quantize_int8",
        "route": "cuda",
        "source": "coinstac_dinunet_tpu_torch/csrc/quantize_int8.cu",
        "replaces": "coinstac_dinunet_tpu/ops/quantize.py:47",
        "launches": None,
        "bit_equal": True,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_64mi": big["ms"],
        "bound_ms_64mi": big["bound_ms"],
    }


# K2–K4 checks: (name, B, H, T, d, dtype, causal, q_offset, k_offset,
# kv_len, g_lse nonzero).  "main" is the sequence path's shape, "tpu" the
# shape scripts/validate_tpu.py measured the TPU kernels at; the rest are
# edges: a T that is no tile multiple, every head dim, a masked key tail,
# no valid key at all, a causal slice with every row masked, and a causal
# slice with both offsets nonzero.  Every edge runs in float32 (the
# CUDA-core kernels) and in bfloat16 (the tensor-core kernels).
_FLASH_EDGES = [
    ("t160", 1, 2, 160, 32, False, 0, 0, None, True),
    ("t160_causal", 1, 2, 160, 32, True, 0, 0, None, True),
    ("t160_d64_causal", 1, 2, 160, 64, True, 0, 0, None, True),
    ("t160_d128", 1, 2, 160, 128, False, 0, 0, None, True),
    ("kv_len_96", 1, 1, 128, 32, False, 0, 0, 96, False),
    ("kv_len_0", 1, 1, 128, 32, False, 0, 0, 0, False),
    ("causal_all_masked", 1, 1, 48, 32, True, 0, 64, None, False),
    ("offsets_d64", 1, 2, 333, 64, True, 100, 37, 300, True),
    ("offsets_d128", 1, 2, 333, 128, True, 100, 37, 300, True),
    # head dim 16 (the sequence example's d_model 64 over 4 heads)
    ("t160_d16_causal", 1, 2, 160, 16, True, 0, 0, None, True),
    ("offsets_d16", 1, 2, 333, 16, True, 100, 37, 300, True),
]
FLASH_CASES = [
    ("main", 16, 4, 4096, 32, "bfloat16", False, 0, 0, None, False),
    ("tpu", 1, 8, 8192, 128, "bfloat16", True, 0, 0, None, False),
    # path 8's folded batch: 16 sites and a spare slot of 16 sequences each
    ("vectorized", 272, 4, 4096, 32, "bfloat16", False, 0, 0, None, False),
    # the sequence example's attention (path 14c: batch 8, 4 heads, T 128,
    # d 16) in both types, and d 16 at a long T
    ("seq_example", 8, 4, 128, 16, "bfloat16", False, 0, 0, None, False),
    ("seq_example_f32", 8, 4, 128, 16, "float32", False, 0, 0, None, False),
    ("d16_long", 8, 4, 4096, 16, "bfloat16", False, 0, 0, None, False),
] + [(name, b, h, t, d, "float32", *rest) for name, b, h, t, d, *rest in _FLASH_EDGES] + [
    (name + "_bf16", b, h, t, d, "bfloat16", *rest) for name, b, h, t, d, *rest in _FLASH_EDGES]
# Tolerance of a kernel's output against its plain version: 1e-4 of the
# plain output's largest magnitude, plus 1e-6.  Both compute in float32 from
# the same (bf16 or f32) input values; they differ in the order of the
# float32 sums over up to 8192 keys (online-softmax rescaling in the
# kernel, cuBLAS's order in the plain version) and in expf/logf against
# torch's exp/log (a few ulp each), which stays some 100x below this.
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-6
# On bfloat16 inputs K2 rounds p, K3 and K4 round g_out, p and ds to
# bfloat16 before their tensor-core products.  Against the plain version
# with the same roundings (for K2 the online softmax over the kernel's key
# tiles) what is left is the order of the float32 sums and, here and
# there, a bfloat16 rounding of p or ds that falls the other way: the two
# sides' float32 values differ in their last bits (tensor-core sums,
# ex2.approx against torch.exp), and a value that lies on a rounding
# boundary then moves by a whole bfloat16 step, 2^-8 of itself.  Over
# thousands of keys one such term drowns in the sum: the long shapes are
# held to 1e-3 (up to 6.0e-4 was seen).  Where a row sees a few hundred
# keys or fewer, one flipped term of the larger ones is worth up to 2^-8 =
# 3.9e-3 of the largest output (2.2e-3 was seen at d 128, T 333), so the
# short edges are held to 4e-3, one bfloat16 step.
FLASH_BF16_MATCHED_RTOL = 1e-3
FLASH_BF16_MATCHED_RTOL_SHORT = 4e-3
FLASH_LONG_T = 1024  # from here on a case counts as long
# Against the float32 plain version the difference is the format's: 2^-9
# relative on each of p (K2) or g_out, p and ds (K3, K4).
# scaled_dot_product_attention's forward and backward on the same inputs
# are the witnesses: at the "main" and "tpu" shapes the kernels may err at
# most FLASH_BF16_LIBRARY_FACTOR times as much as the library does.
# lse is held to FLASH_RTOL in both types, and two launches of any kernel
# must give the same bits (no atomics).
FLASH_BF16_RTOL = 2e-2
FLASH_BF16_LIBRARY_FACTOR = 2.0
# the cases whose kernel, plain-version, bound and library times are taken
FLASH_D16_TIMED = ("seq_example", "seq_example_f32", "d16_long")
FLASH_TIMED = ("main", "tpu", "vectorized", *FLASH_D16_TIMED)
FLASH_SOURCES = {
    "flash_attention_fwd": ("coinstac_dinunet_tpu_torch/csrc/flash_attention_fwd.cu",
                            "coinstac_dinunet_tpu/ops/flash_attention.py:79"),
    "flash_attention_dq": ("coinstac_dinunet_tpu_torch/csrc/flash_attention_bwd.cu",
                           "coinstac_dinunet_tpu/ops/flash_attention.py:231"),
    "flash_attention_dkv": ("coinstac_dinunet_tpu_torch/csrc/flash_attention_bwd.cu",
                            "coinstac_dinunet_tpu/ops/flash_attention.py:273"),
}
# operations per valid (query, key) pair and head-dim element: the forward
# two products (S = QKᵀ, PV), dq three (S, dP, dS·K), dk/dv four (S, dP,
# dSᵀQ, PᵀdO), two operations per multiply-add
FLASH_OPS = {"flash_attention_fwd": 4, "flash_attention_dq": 6, "flash_attention_dkv": 8}


def flash_bound_ms(name, bh, tq, tk, d, pairs, in_bytes, exp_per_s):
    """Least time of one launch, the largest of three terms: the bytes
    (each input read once, each output written once) over HBM bandwidth;
    the product operations on the valid pairs over the peak rate for the
    inputs' type (bf16 tensor cores, or float32 on the CUDA cores); one
    exponential per valid pair over the special function units' rate at the
    card's top SM clock.  Returns ``(ms, "bytes" or "operations", term)``
    with ``term`` one of bytes / products / exp."""
    qkv = bh * (tq + 2 * tk) * d * in_bytes
    rows = bh * tq * 4  # one float32 per query row
    if name == "flash_attention_fwd":
        moved = qkv + bh * tq * d * 4 + rows                  # out, lse
    elif name == "flash_attention_dq":
        moved = qkv + bh * tq * d * 4 * 2 + 3 * rows          # g_out, dq; lse, Δ, g_lse
    else:
        moved = qkv + bh * tq * d * 4 + 3 * rows + 2 * bh * tk * d * 4  # dk, dv
    rate = BF16_TENSOR_OPS_PER_S if in_bytes == 2 else CUDA_CORE_OPS_PER_S
    terms = {"bytes": moved / HBM_BYTES_PER_S,
             "products": FLASH_OPS[name] * pairs * d / rate,
             "exp": pairs / exp_per_s}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], ("bytes" if term == "bytes" else "operations"), term


def _close(got, want, what, scales=None, rtol=FLASH_RTOL):
    """max |got - want|, which must stay within ``rtol·max|want| +
    FLASH_ATOL``; records max |want| in ``scales`` when given."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if scales is not None:
        scales.append(scale)
    tol = rtol * scale + FLASH_ATOL
    if not err <= tol:
        raise AssertionError(f"{what}: max |kernel - plain| {err:.3e} > tolerance {tol:.3e}")
    return err


def library_forward(F, shape, q, k, v, causal):
    """``scaled_dot_product_attention``'s output on the same inputs, as
    float32 ``(BH, T, d)``: the yardstick of K2's format error."""
    b, h, t, d = shape
    ql, kl, vl = [x.reshape(b, h, t, d) for x in (q, k, v)]
    return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal).reshape(b * h, t, d).float()


def library_backward(F, shape, q, k, v, g_out, causal):
    """``scaled_dot_product_attention``'s (dq, dk, dv) on the same inputs
    in ``(B, H, T, d)``, as float32 ``(BH, T, d)``: the yardstick of the
    bfloat16 format's error, used nowhere in the port."""
    import torch

    b, h, t, d = shape
    ql, kl, vl = [x.reshape(b, h, t, d).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    grads = torch.autograd.grad(out, (ql, kl, vl), g_out.reshape(b, h, t, d).to(q.dtype))
    return [g.reshape(b * h, t, d).float() for g in grads]


def check_flash(dev, report):
    """K2, K3 and K4 against their plain versions on the card at every
    case of FLASH_CASES; times at path 2's, path 8's and the TPU's
    shapes."""
    import torch
    import torch.nn.functional as F

    # the module (the package exports its function under the same name)
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

    rows, kernels = [], {}
    errs = {name: 0.0 for name in FLASH_SOURCES}
    errs_f32 = {name: 0.0 for name in FLASH_SOURCES}
    library_errs = {}
    exp_per_s = (EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
                 * max_sm_clock_hz())
    for (case, b, h, t, d, dtype, causal, qo, ko, kv, nz_glse) in FLASH_CASES:
        gen = torch.Generator(device=dev).manual_seed(len(rows))
        dt = getattr(torch, dtype)
        bh = b * h
        q, k, v = [torch.randn((bh, t, d), generator=gen, device=dev).to(dt) for _ in range(3)]
        kv_len = t if kv is None else kv
        scale = d ** -0.5
        pos = (qo, ko, kv_len, causal, scale)
        bf16 = dt == torch.bfloat16
        m_rtol = FLASH_BF16_MATCHED_RTOL if t >= FLASH_LONG_T else FLASH_BF16_MATCHED_RTOL_SHORT
        out, lse = fa.flash_forward_cuda(q, k, v, *pos)
        p_out, p_lse = fa.flash_forward_plain(q, k, v, *pos)
        scales = []  # max |plain| of out, lse, dq, dk, dv
        extra = ""
        if bf16:
            # first against the plain version with the kernel's roundings ...
            m_out = fa.flash_forward_plain(q, k, v, *pos, round_dtype=dt)[0]
            e_out = _close(out, m_out, f"K2 out at {case} (rounding-matched)", rtol=m_rtol)
            del m_out
            # ... then against the float32 statement of the function
            f_out = _close(out, p_out, f"K2 out at {case} (float32 plain)", scales,
                           rtol=FLASH_BF16_RTOL)
            errs_f32["flash_attention_fwd"] = max(errs_f32["flash_attention_fwd"], f_out)
            extra = f"; vs float32 plain out {f_out:.2e}"
            if case in ("main", "tpu"):
                l_out = float((library_forward(F, (b, h, t, d), q, k, v, causal)
                               - p_out).abs().max())
                extra += f"; library forward vs float32 plain out {l_out:.2e}"
                if not f_out <= FLASH_BF16_LIBRARY_FACTOR * l_out:
                    raise AssertionError(
                        f"K2 out at {case}: error {f_out:.3e} against the float32 plain "
                        f"version is over {FLASH_BF16_LIBRARY_FACTOR} x the library "
                        f"forward's {l_out:.3e}")
                library_errs[case] = {"out": (f_out, l_out)}
        else:
            e_out = _close(out, p_out, f"K2 out at {case}", scales)
        e_fwd = max(e_out, _close(lse, p_lse, f"K2 lse at {case}", scales))
        if not all(torch.equal(a, b_) for a, b_ in zip((out, lse),
                                                       fa.flash_forward_cuda(q, k, v, *pos))):
            raise AssertionError(f"K2 at {case}: two launches differ")
        # the backward kernels get the plain forward's residuals, as the
        # plain backward does, so each check isolates one kernel
        g_out = torch.randn((bh, t, d), generator=gen, device=dev)
        g_lse = (torch.randn((bh, t), generator=gen, device=dev) if nz_glse
                 else torch.zeros((bh, t), device=dev))
        delta = fa.flash_delta(p_out, g_out)
        args = (q, k, v, g_out, p_lse, delta, g_lse, *pos)
        dq = fa.flash_dq_cuda(*args)
        dk, dv = fa.flash_dkv_cuda(*args)
        p_dq = fa.flash_dq_plain(*args)
        p_dk, p_dv = fa.flash_dkv_plain(*args)
        torch.cuda.synchronize()
        if bf16:
            # first against the plain version with the kernels' roundings ...
            m_dq = fa.flash_dq_plain(*args, round_dtype=dt)
            m_dk, m_dv = fa.flash_dkv_plain(*args, round_dtype=dt)
            e_dq = _close(dq, m_dq, f"K3 dq at {case} (rounding-matched)", rtol=m_rtol)
            e_dkv = max(_close(dk, m_dk, f"K4 dk at {case} (rounding-matched)", rtol=m_rtol),
                        _close(dv, m_dv, f"K4 dv at {case} (rounding-matched)", rtol=m_rtol))
            del m_dq, m_dk, m_dv
            # ... then against the float32 statement of the function
            f_errs = [_close(got, want, f"{what} at {case} (float32 plain)", scales,
                             rtol=FLASH_BF16_RTOL)
                      for what, got, want in (("K3 dq", dq, p_dq), ("K4 dk", dk, p_dk),
                                              ("K4 dv", dv, p_dv))]
            errs_f32["flash_attention_dq"] = max(errs_f32["flash_attention_dq"], f_errs[0])
            errs_f32["flash_attention_dkv"] = max(errs_f32["flash_attention_dkv"], *f_errs[1:])
            extra += "; vs float32 plain dq {:.2e} dk {:.2e} dv {:.2e}".format(*f_errs)
            if case in ("main", "tpu"):
                lib = library_backward(F, (b, h, t, d), q, k, v, g_out, causal)
                l_errs = [float((got - want).abs().max())
                          for got, want in zip(lib, (p_dq, p_dk, p_dv))]
                del lib
                extra += "; library backward vs float32 plain dq {:.2e} dk {:.2e} dv {:.2e}".format(*l_errs)
                for what, mine, theirs in zip(("dq", "dk", "dv"), f_errs, l_errs):
                    if not mine <= FLASH_BF16_LIBRARY_FACTOR * theirs:
                        raise AssertionError(
                            f"{what} at {case}: error {mine:.3e} against the float32 plain "
                            f"version is over {FLASH_BF16_LIBRARY_FACTOR} x the library "
                            f"backward's {theirs:.3e}")
                library_errs[case].update(zip(("dq", "dk", "dv"), zip(f_errs, l_errs)))
        else:
            e_dq = _close(dq, p_dq, f"K3 dq at {case}", scales)
            e_dkv = max(_close(dk, p_dk, f"K4 dk at {case}", scales),
                        _close(dv, p_dv, f"K4 dv at {case}", scales))
        if case.startswith("kv_len_96") and (dk[:, 96:].abs().max() != 0
                                             or dv[:, 96:].abs().max() != 0):
            raise AssertionError("K4: keys past kv_len got a nonzero gradient")
        if case.startswith(("kv_len_0", "causal_all_masked")):
            if out.abs().max() != 0 or not bool((lse <= fa._MASKED_LSE).all()):
                raise AssertionError(f"K2 at {case}: masked rows must give zeros and lse <= "
                                     f"{fa._MASKED_LSE}")
            if any(x.abs().max() != 0 for x in (dq, dk, dv)):
                raise AssertionError(f"K3/K4 at {case}: masked rows must give zero gradients")
        # no atomics: a second launch gives the same bits
        if not (torch.equal(dq, fa.flash_dq_cuda(*args))
                and all(torch.equal(a, b_) for a, b_ in zip((dk, dv), fa.flash_dkv_cuda(*args)))):
            raise AssertionError(f"K3/K4 at {case}: two launches differ")
        errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], e_fwd)
        errs["flash_attention_dq"] = max(errs["flash_attention_dq"], e_dq)
        errs["flash_attention_dkv"] = max(errs["flash_attention_dkv"], e_dkv)
        row = {"case": case, "shape": [b, h, t, d], "dtype": dtype, "causal": causal,
               "q_offset": qo, "k_offset": ko, "kv_len": kv_len, "g_lse_nonzero": nz_glse,
               "max_abs_err": {"fwd": e_fwd, "dq": e_dq, "dkv": e_dkv},
               "max_abs_plain": dict(zip(("out", "lse", "dq", "dk", "dv"), scales))}
        log(f"  K2-K4 {case:18s} {str([b, h, t, d]):20s} {dtype:8s} causal={causal!s:5s} "
            f"max|d| fwd {e_fwd:.2e} dq {e_dq:.2e} dk/dv {e_dkv:.2e}"
            + (" (rounding-matched plain)" if bf16 else "") + "; bit-identical reruns; "
            "max|plain| out/lse/dq/dk/dv " + " ".join(f"{x:.3g}" for x in scales) + extra)
        if case in FLASH_TIMED:
            row["times"] = time_flash(fa, F, case, (b, h, t, d), q, k, v, g_out, args, pos,
                                      kernels if case == "main" else None, exp_per_s)
        rows.append(row)
        del q, k, v, out, lse, p_out, p_lse, g_out, g_lse, delta, dq, dk, dv, p_dq, p_dk, p_dv
        torch.cuda.empty_cache()
    report["flash_cases"] = rows
    report["flash_library_errors"] = library_errs
    # the head-dim-16 shapes' times ride along in the kernels' entries
    for row in rows:
        if row["case"] in FLASH_D16_TIMED:
            for name, kern in kernels.items():
                kern.setdefault("times_d16", {})[row["case"]] = row["times"][name]
    for name, kern in kernels.items():
        kern["max_abs_err"] = errs[name]
        # bfloat16 cases: max_abs_err is against the rounding-matched plain
        # version, this one against the float32 plain version
        kern["max_abs_err_vs_float32_plain"] = errs_f32[name]
    return [kernels[name] for name in FLASH_SOURCES]


def time_flash(fa, F, case, shape, q, k, v, g_out, args, pos, kernels, exp_per_s):
    """Kernel, plain-version, bound and library times of K2, K3 and K4 at
    one shape; fills ``kernels`` (the main path's entries) when given."""
    import torch

    b, h, t, d = shape
    bh = b * h
    qo, ko, kv_len, causal, scale = pos
    pairs = bh * int(fa._valid_mask(t, t, qo, ko, kv_len, causal, q.device).sum())
    in_bytes = q.element_size()
    timed = {
        "flash_attention_fwd": (lambda: fa.flash_forward_cuda(q, k, v, *pos),
                                lambda: fa.flash_forward_plain(q, k, v, *pos)),
        "flash_attention_dq": (lambda: fa.flash_dq_cuda(*args), lambda: fa.flash_dq_plain(*args)),
        "flash_attention_dkv": (lambda: fa.flash_dkv_cuda(*args), lambda: fa.flash_dkv_plain(*args)),
    }
    # the library yardstick: scaled_dot_product_attention on the same
    # inputs in (B, H, T, d), its forward for K2, its backward for K3+K4
    ql, kl, vl = [x.reshape(b, h, t, d).detach().requires_grad_() for x in (q, k, v)]
    gl = g_out.reshape(b, h, t, d).to(q.dtype)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal), 10)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), gl, retain_graph=True), 10)
    out = {}
    for name, (kern, plain) in timed.items():
        ms = cuda_ms(kern, 10, warmup=2)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        bound_ms, bound_by, term = flash_bound_ms(name, bh, t, t, d, pairs, in_bytes, exp_per_s)
        lib = lib_fwd if name == "flash_attention_fwd" else lib_bwd
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_term": term, "library_ms": lib}
        log(f"    {name:20s} at {case}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.5f} ms ({bound_by}: {term}), library {lib:.4f} ms"
            + ("" if name == "flash_attention_fwd" else " (backward: dq, dk and dv together)"))
        if kernels is not None:
            source, replaces = FLASH_SOURCES[name]
            kernels[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": None, **out[name],
            }
    del lib_out
    return out


def check_reference(dev):
    """The port's VBM forward on the card against the CPU (float32)."""
    import torch

    from coinstac_dinunet_tpu_torch.models import VBM3DNet

    model = VBM3DNet(width=4)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn((2, 16, 16, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"VBM logits on the card differ from the CPU by {err}")
    return err


def check_seq_reference(dev):
    """The port's sequence model on the card (K2–K4) against the CPU
    (plain versions), float32, at the full width on a short input: logits
    and the loss gradient of every parameter."""
    import torch

    from coinstac_dinunet_tpu_torch.interop import wire_leaves
    from coinstac_dinunet_tpu_torch.models import SeqClassifier

    model = SeqClassifier(max_len=SEQ_ARGS["max_len"])
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn((2, 200, 16), generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1])
    leaves = [p for _, p in wire_leaves({"seq_net": model})]

    def run(device):
        model.to(device).zero_grad()
        logits = model(x.to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        # clones: moving the model to the card moves its CPU gradients too
        return (logits.detach().cpu().clone(),
                [model.get_parameter(p).grad.cpu().clone() for p in leaves])

    want, gw = run(torch.device("cpu"))
    got, gg = run(dev)
    err = float((got - want).abs().max())
    gerr = max(float((a - b).abs().max() / (b.abs().max() + 1e-12)) for a, b in zip(gg, gw))
    if not (err <= 1e-4 and gerr <= 1e-4):
        raise AssertionError(f"sequence model on the card differs from the CPU: logits {err}, "
                             f"gradients (relative) {gerr}")
    return err, gerr


def check_power_iteration(dev):
    """``orthogonalize`` and ``power_iteration_BC`` on the card against the
    CPU, float32 (TF32 off), at the rankDAD embed layer's shapes on the
    sequence path (N = batch·T rows, d_model outputs, features + 1
    inputs, rank 10) with the start block injected: the projector Q Qᵀ and
    the product Brᵀ Cr (column signs may differ) within 1e-4·max."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import orthogonalize, power_iteration_BC

    gen = torch.Generator().manual_seed(3)
    n = SEQ_ARGS["batch_size"] * SEQ_ARGS["seq_len"]
    B = torch.randn((n, SEQ_ARGS["d_model"]), generator=gen)
    C = torch.randn((n, SEQ_ARGS["num_features"] + 1), generator=gen)
    q0 = torch.randn((SEQ_ARGS["d_model"], DAD_RANK), generator=gen)
    m = torch.randn((SEQ_ARGS["d_model"], DAD_RANK), generator=gen)
    errs = {}
    for name, fn in (
        ("orthogonalize", lambda d: (lambda q: q @ q.T)(orthogonalize(m.to(d)))),
        ("power_iteration_BC", lambda d: (lambda f: f[0].T @ f[1])(
            power_iteration_BC(B.to(d), C.to(d), rank=DAD_RANK, iterations=5, q0=q0))),
    ):
        want, got = fn(torch.device("cpu")), fn(dev).cpu()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if not err <= POWER_ITERATION_RTOL * scale:
            raise AssertionError(f"{name} on the card differs from the CPU by {err} > "
                                 f"{POWER_ITERATION_RTOL} x {scale}")
        errs[name] = {"max_abs_err": err, "relative": err / scale}
    return errs


VBM_BATCH = 16
VBM_SHAPE = [64, 64, 64]


def make_vbm_engine(dev, workdir, extra_files=None, **args):
    """The VBM main path's engine: 2 sites, the width-16 VBM at
    precision_bits=8, 64 subjects a site (plus ``extra_files[site]``), not
    yet run; ``args`` add to the configuration."""
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SyntheticVBMDataset, VBMTrainer

    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=VBMTrainer,
        dataset_cls=SyntheticVBMDataset, device=dev,
        data_dir="data", input_shape=VBM_SHAPE, model_width=WIDTH,
        batch_size=VBM_BATCH, epochs=1, split_ratio=[0.75, 0.125, 0.125],
        precision_bits=8, compute_dtype="bfloat16", seed=7, patience=100, **args,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(64 + (extra_files or {}).get(s, 0)):
            open(os.path.join(d, f"{s}_subject_{i:03d}"), "w").close()
    return eng


def payload_digests(workdir):
    """sha256 of every wire payload file (``*.npy``) under ``workdir``, by
    relative path."""
    import hashlib

    out = {}
    for root, _, files in os.walk(workdir):
        for f in files:
            if f.endswith(".npy"):
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, workdir)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def param_digests(eng):
    """sha256 of every site's parameters, by site and name."""
    import hashlib

    return {s: {f"{m}.{k}": hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes())
                .hexdigest()
                for m, net in eng.site_caches[s]["_train_state"].nn.items()
                for k, v in net.state_dict().items()}
            for s in eng.site_ids}


def run_main_path(dev, workdir, profiled=PROFILED_ROUNDS, **args):
    """Federated dSGD of the width-16 VBM at precision_bits=8 to SUCCESS
    (``args`` add to the configuration: path 14b's background commits),
    every round's payload files and the final parameters digested; the
    payloads written by the native gather-write and the sites' reads of
    the mean by the native reader (the aggregator's fan-in maps the
    files)."""
    import torch

    from coinstac_dinunet_tpu_torch import native
    from coinstac_dinunet_tpu_torch.ops import quantize as q

    eng = make_vbm_engine(dev, workdir, **args)
    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    native.reset_counts()
    grad_rounds = 0
    round_s, profiles, per_round, digests = [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = q.KERNEL.launches, q.KERNEL.segments
        tr = time.perf_counter()
        if eng.rounds + 1 in profiled:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        digests.append(payload_digests(workdir))
        grew = q.KERNEL.launches - before[0], q.KERNEL.segments - before[1]
        per_round.append(grew)
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            # exactly one launch per payload (2 sites + the aggregator), every
            # leaf of every payload through the kernel
            want = N_SITES + 1, (N_SITES + 1) * VBM_LEAVES
            if grew != want:
                raise AssertionError(
                    f"round {eng.rounds}: K1 launched {grew[0]} times over {grew[1]} "
                    f"segments, expected {want[0]} launches over {want[1]} segments")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = q.KERNEL.launches
    counts = dict(native.COUNTS)
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0 or launches == 0:
        raise AssertionError("the main path shipped no gradients through K1")
    # every payload through the native gather-write, every site's read of
    # the mean through the native reader
    want = {"packs": (N_SITES + 1) * grad_rounds, "loads": N_SITES * grad_rounds}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"native wire calls {counts}, expected {want}")

    metrics = check_outputs(eng, workdir)
    # wire bytes of the last gradient round (the payload files persist):
    # int8 values + float32 scales against float32 values of the gradient
    grads_bytes = [os.path.getsize(os.path.join(workdir, "remote_base", s, "grads.npy"))
                   for s in eng.site_ids]
    avg_bytes = os.path.getsize(os.path.join(workdir, "remote_xfer", "avg_grads.npy"))
    n_values = sum(p.numel() for m in eng.site_caches[eng.site_ids[0]]["_train_state"].nn.values()
                   for p in m.parameters())
    samples = grad_rounds * N_SITES * VBM_BATCH
    return {
        "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes,
                       "float32_values": 4 * n_values},
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "segments": q.KERNEL.segments, "launches_segments_per_round": per_round,
        "wall_s": wall, "samples_per_s": samples / wall, "round_s": round_s,
        "profiled_rounds": profiles, "global_test_metrics": metrics, "native_calls": counts,
        # for path 14b, which holds its run to these bit for bit (not written out)
        "payload_digests": digests, "final_params": param_digests(eng),
        "logs": {k: eng.remote_cache[k] for k in SEQ_LOGS},
    }


def run_seq_path(dev, workdir, compute_dtype=None, extra=None, n_sites=N_SITES,
                 n_files=SEQ_FILES, trace_round=SEQ_PROFILED_ROUND):
    """Federated dSGD of the width-128 sequence transformer on 4096-step
    sequences to SUCCESS; K2–K4 launched in every gradient round.
    ``compute_dtype`` replaces path 2's bfloat16 (phase 12a's rerun);
    ``extra`` adds to the node arguments (phase 15c's AUC); ``n_sites``
    sites of ``n_files`` subjects and no traced round
    (``trace_round=None``) for path 5's reference."""
    import json as _json

    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    eng = InProcessEngine(
        workdir, n_sites=n_sites, trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset,
        device=dev, task_id=SEQ_TASK,
        **{**seq_node_args(), **({"compute_dtype": compute_dtype} if compute_dtype else {}),
           **(extra or {})},
    )
    make_seq_files(eng, n_files)

    names = list(FLASH_SOURCES)
    for kern in fa.KERNELS:
        kern.launches = 0
    need = n_sites * SEQ_ARGS["num_layers"]
    grad_rounds, round_s, profiles, per_round = 0, [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = [kern.launches for kern in fa.KERNELS]
        tr = time.perf_counter()
        if eng.rounds + 1 == trace_round:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
        per_round.append(dict(zip(names, grew)))
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if min(grew) < need:
                raise AssertionError(f"round {eng.rounds}: K2/K3/K4 launched {grew} times, "
                                     f"expected >= {need} each")
        elif eng.rounds == trace_round:
            raise AssertionError(f"the profiled round {eng.rounds} shipped no gradients")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(names, (kern.launches for kern in fa.KERNELS)))
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0 or min(launches.values()) == 0:
        raise AssertionError("the sequence path ran no gradient through K2-K4")

    metrics = check_outputs(eng, workdir)
    train = 0
    for s in eng.site_ids:
        with open(os.path.join(workdir, s, "out", SEQ_TASK, "splits", "SPLIT.json")) as f:
            train += len(_json.load(f)["train"])
    grads_bytes = [os.path.getsize(os.path.join(workdir, "remote_base", s, "grads.npy"))
                   for s in eng.site_ids]
    avg_bytes = os.path.getsize(os.path.join(workdir, "remote_xfer", "avg_grads.npy"))
    return {
        "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes},
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "launches_per_round": per_round, "train_samples": train * SEQ_ARGS["epochs"],
        "wall_s": wall, "samples_per_s": train * SEQ_ARGS["epochs"] / wall, "round_s": round_s,
        "profiled_rounds": profiles, "global_test_metrics": metrics,
        "logs": {k: eng.remote_cache[k] for k in SEQ_LOGS},
        "global_test_log": eng.remote_cache["global_test_metrics"],
        # for paths 5 and 6, which hold their sites to these bit for bit (not
        # written out)
        "final_params": {s: {k: v.detach().cpu().clone() for k, v in
                             eng.site_caches[s]["_train_state"].nn["seq_net"].state_dict().items()}
                         for s in eng.site_ids},
    }


def seq_node_args():
    """The node arguments of the sequence paths 2 and 5."""
    return dict(data_dir="data", seed=7, patience=100, **SEQ_ARGS)


def make_seq_files(eng, n_files=SEQ_FILES):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(n_files):
            open(os.path.join(d, f"{s}_subj_{i:03d}"), "w").close()


def check_outputs(eng, workdir):
    """Every site's parameters on the card and finite, and the global test
    metrics finite; returns the metrics."""
    import torch

    for s in eng.site_ids:
        for name, m in eng.site_caches[s]["_train_state"].nn.items():
            for pname, p in m.named_parameters():
                if not p.is_cuda or not torch.isfinite(p).all():
                    raise AssertionError(f"{s} {name}.{pname} is not finite on the card")
    return check_metrics_csv(workdir, eng.remote_cache.get("task_id", "task"))


def check_metrics_csv(workdir, task):
    """The global test metrics of ``task`` finite; returns them."""
    csv = os.path.join(workdir, "remote_out", task, "global_test_metrics.csv")
    with open(csv) as f:
        header, row = f.read().strip().splitlines()[:2]
    values = [float(v) for v in row.split(",")]
    if len(values) != len(header.split(",")) or not all(v == v for v in values):
        raise AssertionError(f"bad global test metrics: {header} / {row}")
    return dict(zip(header.split(","), values))


def wire_sizes(eng, workdir, up, down=None):
    """Bytes of a round's payload files: what each site shipped up (the
    files ``up`` in ``remote_base/<site>``) and what the aggregator shipped
    down (``down``, default the same names, in ``remote_xfer``)."""
    return {"site_to_aggregator": [sum(os.path.getsize(os.path.join(workdir, "remote_base", s, n))
                                       for n in up) for s in eng.site_ids],
            "aggregator_to_site": sum(os.path.getsize(os.path.join(workdir, "remote_xfer", n))
                                      for n in (down or up))}


class PayloadRecorder:
    """While ``on``, keeps every payload the wire hands K1: a copy of its
    leaves and seeds and of the kernel's output, taken on the launch's
    stream right after it.  :meth:`check` then holds each output bit-equal
    to the plain version on the same leaves (no launch: the counts stay
    the main path's)."""

    def __init__(self):
        self.on, self.payloads = False, []

    def __enter__(self):
        from coinstac_dinunet_tpu_torch.utils import tensorutils

        real = self._real = tensorutils.quantize_int8_many

        def record(leaves, seeds):
            leaves, seeds = list(leaves), list(seeds)
            out = real(leaves, seeds)
            if self.on:
                self.payloads.append(([x.detach().clone() for x in leaves], seeds, out.clone()))
            return out

        tensorutils.quantize_int8_many = record
        return self

    def __exit__(self, *exc):
        from coinstac_dinunet_tpu_torch.utils import tensorutils

        tensorutils.quantize_int8_many = self._real

    def take(self):
        """The payloads recorded since the last call."""
        taken, self.payloads = self.payloads, []
        return taken

    @staticmethod
    def check(payloads, what):
        """``[(leaves, values, bytes)]`` of recorded payloads, each
        bit-equal to ``quantize_int8_many_plain``; raises otherwise."""
        import torch

        from coinstac_dinunet_tpu_torch.ops import quantize as q

        rows = []
        for leaves, seeds, got in payloads:
            want = q.quantize_int8_many_plain(leaves, seeds)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{what}: K1's payload of {len(leaves)} leaves "
                                     f"({[tuple(x.shape) for x in leaves]}) differs from its "
                                     "plain version")
            rows.append((len(leaves), sum(x.numel() for x in leaves), got.numel()))
        return rows


def hold_payloads(payloads, round_no, segments):
    """A round's recorded payloads held to the plain version; every
    segment K1 took in the round must be among them."""
    rows = PayloadRecorder.check(payloads, f"round {round_no}")
    if sum(n for n, _, _ in rows) != segments:
        raise AssertionError(f"round {round_no}: held {rows}, K1 took {segments} segments")
    return rows


def _flat_leaves(tree, prefix=""):
    """``[(path, array)]`` of a nested dict, keys sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += (_flat_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])
    return out


def check_pretrain_load(eng):
    """``pretrained_weights.ckpt`` in every site's base directory, and each
    site's parameters bit-equal to the pretrainer's best weights (the file
    it wrote into its transfer directory)."""
    import numpy as np

    from coinstac_dinunet_tpu_torch.interop import params_to_jax
    from coinstac_dinunet_tpu_torch.utils import flax_msgpack

    (pre,) = [s for s in eng.site_ids if eng.site_caches[s].get("pretrain")]
    src = os.path.join(eng.site_states[pre]["transferDirectory"], eng.site_caches[pre]["weights_file"])
    with open(src, "rb") as f:
        want = _flat_leaves(flax_msgpack.restore(f.read())["models"])
    for s in eng.site_ids:
        if not os.path.exists(os.path.join(eng.site_states[s]["baseDirectory"],
                                           "pretrained_weights.ckpt")):
            raise AssertionError(f"the pretrain broadcast did not reach {s}")
        ts = eng.site_caches[s]["_train_state"]
        got = _flat_leaves({n: params_to_jax(m) for n, m in ts.nn.items()})
        if [k for k, _ in got] != [k for k, _ in want] or not all(
                np.array_equal(a, b) for (_, a), (_, b) in zip(got, want)):
            raise AssertionError(f"{s}'s parameters differ from the pretrainer's ({pre}) after the load")
    return pre, len(want)


def run_powersgd_path(dev, workdir):
    """Path 1's VBM federation with a local pretrain and PowerSGD to
    SUCCESS: the broadcast load checked bit for bit, K1 once per payload
    per node in every gradient round."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q

    eng = make_vbm_engine(dev, workdir, extra_files={"site_0": PRETRAIN_EXTRA_FILES},
                          agg_engine="powerSGD", matrix_approximation_rank=1,
                          start_powerSGD_iter=1, pretrain_args={"epochs": 1})
    # segments of each payload a gradient round's site ships, by its key
    payloads = {"grads_file": (VBM_LEAVES,), "powerSGD_P_file": (VBM_MATRIX_LEAVES,),
                "powerSGD_Q_file": (VBM_MATRIX_LEAVES, VBM_RANK1_LEAVES)}
    files = {"grads_file": (("grads.npy",), ("avg_grads.npy",)),
             "powerSGD_P_file": (("powerSGD_P.npy",),),
             "powerSGD_Q_file": (("powerSGD_Q.npy", "powerSGD_rank1.npy"),)}
    # every payload of a round is held to the plain version until each
    # kind has been held once (after the run, outside its timing)
    recorder, held, recorded = PayloadRecorder(), [], set()
    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    grad_rounds, round_s, per_round, wire, pretrain = 0, [], [], {}, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 60:
        broadcast = eng.site_inputs[eng.site_ids[0]].get("pretrained_weights")
        before = q.KERNEL.launches, q.KERNEL.segments
        recorder.on = recorded != set(payloads)
        tr = time.perf_counter()
        with recorder:
            site_outs, _ = eng.step_round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = q.KERNEL.launches - before[0], q.KERNEL.segments - before[1]
        kinds = [k for k in payloads if all(k in o for o in site_outs.values())]
        per_round.append({"round": eng.rounds, "payload": kinds, "launches": grew[0],
                          "segments": grew[1]})
        if broadcast:
            pretrain = check_pretrain_load(eng)
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if len(kinds) != 1:
                raise AssertionError(f"round {eng.rounds}: sites shipped {kinds}")
            segs = payloads[kinds[0]]
            want = (N_SITES + 1) * len(segs), (N_SITES + 1) * sum(segs)
            if grew != want:
                raise AssertionError(
                    f"round {eng.rounds} ({kinds[0]}): K1 launched {grew[0]} times over "
                    f"{grew[1]} segments, expected {want[0]} launches over {want[1]}")
            wire[kinds[0]] = wire_sizes(eng, workdir, *files[kinds[0]])
            if recorder.on:
                recorded.add(kinds[0])
        if recorder.on:
            held.append((eng.rounds, kinds, grew[1], recorder.take()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held = [{"round": r, "payload": kinds, "leaves_values_bytes": hold_payloads(p, r, segs)}
            for r, kinds, segs, p in held if p]
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if pretrain is None:
        raise AssertionError("no site loaded a pretrain broadcast")
    if set(wire) != set(payloads) or recorded != set(payloads):
        raise AssertionError(f"the run shipped only {sorted(wire)}, held {sorted(recorded)}")
    return {
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": q.KERNEL.launches,
        "segments": q.KERNEL.segments, "per_round": per_round, "wire_bytes": wire,
        "payloads_held": held,
        "pretrainer": pretrain[0], "pretrain_leaves_checked": pretrain[1],
        "wall_s": wall, "round_s": round_s,
        "global_test_metrics": check_outputs(eng, workdir),
    }


def run_rankdad_path(dev, workdir):
    """Path 2's sequence federation with rankDAD at precision_bits=8 to
    SUCCESS: the capture plan is the embed and the head, K2–K4 in every
    gradient round, K1 once per payload per node."""
    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.interop import wire_leaves
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset
    from coinstac_dinunet_tpu_torch.ops import quantize as q

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    eng = InProcessEngine(
        workdir, n_sites=N_SITES, trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset,
        device=dev, data_dir="data", seed=7, patience=100, agg_engine="rankDAD",
        dad_reduction_rank=DAD_RANK, dad_num_pow_iters=5, precision_bits=8, **SEQ_ARGS,
    )
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(SEQ_FILES):
            open(os.path.join(d, f"{s}_subj_{i:03d}"), "w").close()
    want_plan = {"Dense_0@0": ("embed.weight", "embed.bias"),
                 "Dense_1@0": ("head.weight", "head.bias")}
    names = list(FLASH_SOURCES)
    for kern in fa.KERNELS:
        kern.launches = 0
    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    need = N_SITES * SEQ_ARGS["num_layers"]
    # per node a round two payloads: the factors (B and C of each of the 2
    # layers: 4 segments) and the rest leaves (27 - 4 = 23 segments)
    k1_want = 2 * (N_SITES + 1), (N_SITES + 1) * SEQ_LEAVES
    # the payloads of the first gradient round that is not profiled are
    # held to the plain version (after the run, outside its timing)
    recorder, held = PayloadRecorder(), None
    grad_rounds, round_s, profiles, per_round, plan = 0, [], [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = [kern.launches for kern in fa.KERNELS], q.KERNEL.launches, q.KERNEL.segments
        tr = time.perf_counter()
        if eng.rounds + 1 == SEQ_PROFILED_ROUND:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            recorder.on = held is None
            with recorder:
                site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = [kern.launches - b for kern, b in zip(fa.KERNELS, before[0])]
        k1 = q.KERNEL.launches - before[1], q.KERNEL.segments - before[2]
        per_round.append({**dict(zip(names, grew)), "quantize_int8": k1})
        if all(o.get("reduce") for o in site_outs.values()):
            grad_rounds += 1
            if min(grew) < need:
                raise AssertionError(f"round {eng.rounds}: K2/K3/K4 launched {grew} times, "
                                     f"expected >= {need} each")
            if k1 != k1_want:
                raise AssertionError(f"round {eng.rounds}: K1 launched {k1[0]} times over "
                                     f"{k1[1]} segments, expected {k1_want}")
            for s in eng.site_ids:
                st = eng.site_caches[s]["_rankdad_state"]
                leaves = wire_leaves(eng.site_caches[s]["_train_state"].nn)
                plan = {k: tuple(leaves[i][1] for i in st.leaf_map[k]) for k in st.layer_keys}
                if st.layer_keys != list(want_plan) or plan != want_plan:
                    raise AssertionError(f"{s}: the capture plan is {plan}, expected {want_plan}")
            wire = wire_sizes(eng, workdir, ("dad_data.npy", "dad_rest.npy"))
            if recorder.on and held is None:
                held = eng.rounds, k1[1], recorder.take()
        elif eng.rounds == SEQ_PROFILED_ROUND:
            raise AssertionError(f"the profiled round {eng.rounds} shipped no gradients")
        recorder.take()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if held is None:
        raise AssertionError("no gradient round's payloads were held to the plain version")
    r, segs, payloads = held
    held = {"round": r, "leaves_values_bytes": hold_payloads(payloads, r, segs)}
    launches = dict(zip(names, (kern.launches for kern in fa.KERNELS)))
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0 or min(launches.values()) == 0 or plan is None:
        raise AssertionError("the rankDAD path ran no gradient round")
    return {
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": launches,
        "k1_launches": q.KERNEL.launches, "k1_segments": q.KERNEL.segments,
        "per_round": per_round, "plan": plan, "wire_bytes": wire, "payloads_held": held,
        "wall_s": wall, "round_s": round_s, "profiled_rounds": profiles,
        "global_test_metrics": check_outputs(eng, workdir),
    }


# path 5's node process: the entry module's compute, then this process's
# kernel launch counts and clock readings appended to a JSON-lines file.
# It sets the TF32 switches as phase 1 does in this process, so that the
# two runs path 5 compares use the same ones.
FRESH_WRAPPER = """\
import time
T_START = time.time()
import importlib, importlib.util, json, sys
ROOT, ENTRY, RECORDS, ROLE = {root!r}, {entry!r}, {records!r}, {role!r}
sys.path.insert(0, ROOT)
device = sys.argv[sys.argv.index("--device") + 1]
import torch
t_torch = time.time()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.zeros(1, device=device)
torch.cuda.synchronize()
t_context = time.time()
import coinstac_dinunet_tpu_torch
t_port = time.time()
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
if ROLE == "site":
    for kern in fa.KERNELS:
        kern._load()  # dlopen of the library phase 2 built: no launch
t_kernels = time.time()
spec = importlib.util.spec_from_file_location("entry", ENTRY)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
payload = json.loads(sys.stdin.read())
dynamo_before = "torch._dynamo" in sys.modules
t_entry = time.time()
result = mod.compute(payload, device=device)
torch.cuda.synchronize()
t_exit = time.time()
phase_in = (payload["input"] if ROLE == "site" else
            next(iter(payload["input"].values()), {{}})).get("phase", "init_runs")
record = dict(role=ROLE, site=payload["state"].get("clientId", "remote"), phase=phase_in,
              reduce=bool(result["output"].get("reduce")),
              launches=[k.launches for k in fa.KERNELS],
              dynamo_import_in_compute="torch._dynamo" in sys.modules and not dynamo_before,
              t=dict(start=T_START, torch=t_torch, context=t_context, port=t_port,
                     kernels=t_kernels, entry=t_entry, exit=t_exit))
with open(RECORDS, "a") as f:
    f.write(json.dumps(record) + "\\n")
print(json.dumps(result))
"""


def run_fresh_process_path(dev, workdir, seq_path):
    """Path 2's sequence federation at ``FRESH_SITES`` sites of
    ``FRESH_SEQ_FILES`` subjects with every node invocation a fresh process (``SubprocessEngine``, the
    port's ``seq_classification`` entry scripts, ``persist_round_state``):
    SUCCESS, ``seq_path``'s results (the same federation in one process)
    bit for bit, K2–K4 in every gradient-round site invocation, and the
    cost of an invocation split into start-up and compute."""
    import torch

    from coinstac_dinunet_tpu_torch.engine import SubprocessEngine

    class TimedEngine(SubprocessEngine):
        """Records the parent's clock around each child process."""

        def _invoke(self, script, payload, **kw):
            t0 = time.time()
            res = super()._invoke(script, payload, **kw)
            spans.append((t0, time.time()))
            return res

    entry_dir = os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples", SEQ_TASK)
    records = os.path.join(workdir, "invocations.jsonl")
    scripts, spans = {}, []
    for role, entry in (("site", "local.py"), ("remote", "remote.py")):
        scripts[role] = os.path.join(workdir, f"fresh_{role}.py")
        with open(scripts[role], "w") as f:
            f.write(FRESH_WRAPPER.format(root=HERE, entry=os.path.join(entry_dir, entry),
                                         records=records, role=role))
    fed = os.path.join(workdir, "fed")
    eng = TimedEngine(
        fed, n_sites=FRESH_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600,
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), "persist_round_state": True}},
    )
    make_seq_files(eng, FRESH_SEQ_FILES)
    round_s = []
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        tr = time.perf_counter()
        eng.step_round()
        round_s.append(time.perf_counter() - tr)
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != len(spans) or len(recs) != eng.rounds * (FRESH_SITES + 1):
        raise AssertionError(f"{len(recs)} records for {len(spans)} invocations "
                             f"in {eng.rounds} rounds")

    # the results against the one-process run's, bit for bit; every
    # difference gathered before the verdict
    faults = []
    if eng.rounds != seq_path["rounds"]:
        faults.append(f"{eng.rounds} rounds against one process's {seq_path['rounds']}")
    for key in SEQ_LOGS:
        if eng.remote_cache[key] != seq_path["logs"][key]:
            faults.append(f"{key}: {eng.remote_cache[key]} against {seq_path['logs'][key]}")
    round_files, param_gaps = {}, {}
    for s in eng.site_ids:
        path = os.path.join(eng.site_states[s]["outputDirectory"], ".round_state.ckpt")
        round_files[s] = os.path.getsize(path)
        got = torch.load(path, map_location="cpu", weights_only=True)["models"]["seq_net"]
        want = seq_path["final_params"][s]
        if sorted(got) != sorted(want):
            raise AssertionError(f"{s}: the round file holds {sorted(got)}")
        if not all(torch.isfinite(v).all() for v in got.values()):
            faults.append(f"{s}: a parameter in its round file is not finite")
        param_gaps[s] = max(float((got[k].double() - want[k].double()).abs().max())
                            for k in want)
        differ = sorted(k for k in want if not torch.equal(got[k], want[k]))
        if differ:
            faults.append(f"{s}: {len(differ)} of {len(want)} parameters differ from the "
                          f"one-process run's (max |d| {param_gaps[s]:.3e}): {differ[:6]}")

    # K2-K4 in every gradient-round site invocation, once per block at least
    need = SEQ_ARGS["num_layers"]
    names = list(FLASH_SOURCES)
    launches = dict.fromkeys(names, 0)
    for rec in recs:
        for name, n in zip(names, rec["launches"]):
            launches[name] += n
        if rec["role"] == "site" and rec["reduce"] and min(rec["launches"]) < need:
            faults.append(f"{rec['site']} ({rec['phase']}): K2/K3/K4 launched "
                          f"{rec['launches']} times, expected >= {need} each")
    if not any(r["reduce"] for r in recs) or min(launches.values()) == 0:
        faults.append("no gradient round ran through K2-K4")
    if faults:
        raise AssertionError("path 5 against one process:\n  " + "\n  ".join(faults))

    # the cost of one invocation: start-up (process start to the node's
    # entry), the node's compute, and the total on the engine's clock
    per_inv = []
    for rec, (t_spawn, t_done) in zip(recs, spans):
        t = rec["t"]
        per_inv.append(dict(
            role=rec["role"], site=rec["site"], phase=rec["phase"], reduce=rec["reduce"],
            dynamo_import_in_compute=rec["dynamo_import_in_compute"],
            startup_s=t["entry"] - t_spawn, compute_s=t["exit"] - t["entry"],
            total_s=t_done - t_spawn, interpreter_s=t["start"] - t_spawn,
            torch_import_s=t["torch"] - t["start"], cuda_context_s=t["context"] - t["torch"],
            port_import_s=t["port"] - t["context"], kernel_load_s=t["kernels"] - t["port"],
            entry_s=t["entry"] - t["kernels"], exit_s=t_done - t["exit"]))
    dynamo = subprocess.run(
        [sys.executable, "-c", "import time, torch; t = time.time(); import torch._dynamo; "
                               "print(time.time() - t)"],
        capture_output=True, text=True, check=True, timeout=300)
    return {
        "rounds": eng.rounds, "invocations": len(recs), "launches": launches,
        "wall_s": wall, "round_s": round_s, "round_file_bytes": round_files,
        "param_max_abs_diff": param_gaps, "per_invocation": per_inv,
        "split": summarize_invocations(per_inv),
        "torch_dynamo_import_s": float(dynamo.stdout.strip()),
        "global_test_metrics": check_metrics_csv(fed, SEQ_TASK),
    }


def summarize_invocations(per_inv):
    """Sums and means of the per-invocation split, by role."""
    keys = ("startup_s", "compute_s", "total_s", "interpreter_s", "torch_import_s",
            "cuda_context_s", "port_import_s", "kernel_load_s", "entry_s", "exit_s")
    out = {}
    for role in ("site", "remote", "all"):
        rows = [r for r in per_inv if role in ("all", r["role"])]
        out[role] = {"n": len(rows), **{f"sum_{k}": sum(r[k] for r in rows) for k in keys},
                     **{f"mean_{k}": sum(r[k] for r in rows) / len(rows) for k in keys}}
    return out


# path 6's and path 7's worker module, one per role: the entry module's
# compute behind a compute of its own, which appends to a JSON-lines file
# the worker's pid, its role, the input phase, whether the output ships a
# gradient (reduce) or an update, the change in the launch counts of K2-K4
# and of K1 since this process's last invocation, the compute clocks, the
# seconds of the torch._dynamo import (torch.optim's first optimizer pulls
# it in) and of the round-file write inside the invocation.  At import it sets phase
# 1's TF32 switches and, on the card, makes the CUDA context and loads the
# kernels' libraries (no launch), so a worker's start counts both.
DAEMON_WRAPPER = """\
import importlib, importlib.util, json, os, sys, time
ROOT, ENTRY, RECORDS, ROLE = {root!r}, {entry!r}, {records!r}, {role!r}
sys.path.insert(0, ROOT)
DEVICE = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
quant = importlib.import_module("coinstac_dinunet_tpu_torch.ops.quantize")
from coinstac_dinunet_tpu_torch.nodes import local as node_local
if DEVICE == "cuda":
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    if ROLE == "site":
        for kern in fa.KERNELS:
            kern._load()  # dlopen of the library phase 2 built: no launch
spec = importlib.util.spec_from_file_location("entry", ENTRY)
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
CLOCKS = {{"dynamo_s": 0.0, "round_file_s": 0.0}}


class _TimeDynamoImport:
    def find_spec(self, name, path=None, target=None):
        if name != "torch._dynamo":
            return None
        sys.meta_path.remove(self)
        found = importlib.util.find_spec(name)
        exec_module = found.loader.exec_module

        def timed(module):
            t = time.perf_counter()
            try:
                exec_module(module)
            finally:
                CLOCKS["dynamo_s"] += time.perf_counter() - t

        found.loader.exec_module = timed
        return found


if "torch._dynamo" not in sys.modules:
    sys.meta_path.insert(0, _TimeDynamoImport())
persist = node_local.COINNLocal._persist_round_state


def timed_persist(self, trainer):
    t = time.perf_counter()
    try:
        return persist(self, trainer)
    finally:
        CLOCKS["round_file_s"] += time.perf_counter() - t


node_local.COINNLocal._persist_round_state = timed_persist
last = [k.launches for k in fa.KERNELS]
last_k1 = quant.KERNEL.launches
calls = 0


def compute(payload, device=None):
    global last, last_k1, calls
    for k in CLOCKS:
        CLOCKS[k] = 0.0
    t_entry = time.time()
    result = mod.compute(payload, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t_exit = time.time()
    now = [k.launches for k in fa.KERNELS]
    phase_in = (payload["input"] if ROLE == "site" else
                next(iter(payload["input"].values()), {{}})).get("phase", "init_runs")
    record = dict(pid=os.getpid(), role=ROLE, site=payload["state"].get("clientId", "remote"),
                  phase=phase_in, call=calls, reduce=bool(result["output"].get("reduce")),
                  update=bool(result["output"].get("update")),
                  launches=[n - b for n, b in zip(now, last)],
                  k1_launches=quant.KERNEL.launches - last_k1, t_entry=t_entry, t_exit=t_exit,
                  **CLOCKS)
    last, last_k1, calls = now, quant.KERNEL.launches, calls + 1
    with open(RECORDS, "a") as f:
        f.write(json.dumps(record) + "\\n")
    return result
"""
# path 6 kills site_1's worker after this many gradient rounds
DAEMON_KILL_AFTER_GRAD_ROUNDS = 1


def card_compute_pids():
    """The pids ``nvidia-smi`` lists with a context on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return sorted(int(p) for p in out.split() if p.strip().isdigit())


def _card_left(on_card, pids_end, faults):
    """``close()`` shut every worker down: the card lists no more compute
    processes than before the workers started (the listed pids may come
    from another pid namespace than this process's)."""
    for _ in range(100):
        on_card["after_close"] = card_compute_pids()
        if len(on_card["after_close"]) <= len(on_card["before"]):
            return
        time.sleep(0.1)
    faults.append(f"compute processes on the card {on_card} (this process {os.getpid()}, "
                  f"workers {pids_end})")


def _spread(xs):
    xs = sorted(xs)
    if not xs:
        return None
    mid = len(xs) // 2
    median = xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2
    return {"n": len(xs), "median": median, "min": xs[0], "max": xs[-1]}


def write_daemon_wrappers(workdir, records):
    """``DAEMON_WRAPPER`` around the ``seq_classification`` entry scripts,
    one per role, writing to ``records``; returns ``{role: path}``."""
    entry_dir = os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples", SEQ_TASK)
    scripts = {}
    for role, entry in (("site", "local.py"), ("remote", "remote.py")):
        scripts[role] = os.path.join(workdir, f"daemon_{role}.py")
        with open(scripts[role], "w") as f:
            f.write(DAEMON_WRAPPER.format(root=HERE, entry=os.path.join(entry_dir, entry),
                                          records=records, role=role))
    return scripts


def run_daemon_path(dev, workdir, seq_path):
    """Path 2's sequence federation through ``DaemonEngine``: one warm
    worker per site and aggregator (the port's ``seq_classification``
    entry scripts behind ``DAEMON_WRAPPER``), site_1's worker SIGKILLed
    between two gradient rounds and restarted by the supervisor.  SUCCESS,
    path 2's results bit for bit, K2–K4 in every gradient-round site
    invocation, the engine lane's worker and frame records; the cost of a
    worker's start, its first and its steady invocations, the restart, the
    frames and the round files."""
    import signal

    import torch

    from coinstac_dinunet_tpu_torch.federation import DaemonEngine

    torch.cuda.empty_cache()  # leave the workers' contexts the memory
    records = os.path.join(workdir, "invocations.jsonl")
    scripts = write_daemon_wrappers(workdir, records)
    fed = os.path.join(workdir, "fed")
    faults, round_s, killed = [], [], {}
    on_card = {"before": card_compute_pids()}
    with DaemonEngine(
        fed, n_sites=N_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600,
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), "persist_round_state": True,
                                          "profile": True}},
    ) as eng:
        make_seq_files(eng)
        grad_rounds = 0
        t0 = time.perf_counter()
        while not eng.success and eng.rounds < 40:
            tr = time.perf_counter()
            site_outs, _ = eng.step_round()
            round_s.append(time.perf_counter() - tr)
            if eng.rounds == 1:
                on_card["workers_up"] = card_compute_pids()
            grad_rounds += all(o.get("reduce") for o in site_outs.values())
            if not killed and grad_rounds == DAEMON_KILL_AFTER_GRAD_ROUNDS:
                # the drill: SIGKILL between two gradient rounds, from outside
                killed = {"after_round": eng.rounds, "pid": eng.worker_pids()["site_1"]}
                os.kill(killed["pid"], signal.SIGKILL)
                while "site_1" in eng.worker_pids():
                    time.sleep(0.01)
        wall = time.perf_counter() - t0
        pids_end = eng.worker_pids()
    _card_left(on_card, pids_end, faults)
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if not killed:
        raise AssertionError("the run had no gradient round to kill a worker after")
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(fed, "telemetry.engine.jsonl")) as f:
        lane = [json.loads(line) for line in f]
    lane_events = [e for e in lane if e["kind"] == "event"]

    # the results against path 2's, bit for bit
    if eng.rounds != seq_path["rounds"]:
        faults.append(f"{eng.rounds} rounds against path 2's {seq_path['rounds']}")
    for key in SEQ_LOGS:
        if eng.remote_cache[key] != seq_path["logs"][key]:
            faults.append(f"{key}: {eng.remote_cache[key]} against {seq_path['logs'][key]}")
    round_files = {}
    for s in eng.site_ids:
        path = os.path.join(eng.site_states[s]["outputDirectory"], ".round_state.ckpt")
        round_files[s] = os.path.getsize(path)
        got = torch.load(path, map_location="cpu", weights_only=True)["models"]["seq_net"]
        want = seq_path["final_params"][s]
        differ = sorted(k for k in want if k not in got or not torch.equal(got[k], want[k]))
        if sorted(got) != sorted(want) or differ:
            faults.append(f"{s}: {len(differ)} of {len(want)} parameters differ from path 2's: "
                          f"{differ[:6]}")

    # K2-K4 inside the workers: path 2's totals, and every gradient-round
    # site invocation once per block at least
    names = list(FLASH_SOURCES)
    launches = dict.fromkeys(names, 0)
    for rec in recs:
        for name, n in zip(names, rec["launches"]):
            launches[name] += n
        if (rec["role"] == "site" and rec["reduce"]
                and min(rec["launches"]) < SEQ_ARGS["num_layers"]):
            faults.append(f"{rec['site']} ({rec['phase']}): K2/K3/K4 launched {rec['launches']} "
                          f"times, expected >= {SEQ_ARGS['num_layers']} each")
    if launches != seq_path["launches"]:
        faults.append(f"launches {launches} against path 2's {seq_path['launches']}")
    if len(recs) != eng.rounds * (N_SITES + 1):
        faults.append(f"{len(recs)} invocation records in {eng.rounds} rounds")

    # the engine lane: 3 starts, 1 restart (site_1, generation 2), a frame
    # per invocation, cold frames exactly on each worker's first invocation
    starts = [e for e in lane_events if e["name"] == "worker:start"]
    restarts = [e for e in lane_events if e["name"] == "worker:restart"]
    frames = [e for e in lane_events if e["name"] == "daemon:frame"]
    if sorted(e["target"] for e in starts) != ["remote", "site_0", "site_1"]:
        faults.append(f"worker:start events {[e['target'] for e in starts]}")
    if [(e["target"], e["generation"]) for e in restarts] != [("site_1", 2)]:
        faults.append("worker:restart events "
                      f"{[(e['target'], e['generation']) for e in restarts]}")
    if len(frames) != len(recs):
        faults.append(f"{len(frames)} daemon:frame events for {len(recs)} invocations")
    fresh = set()
    for e in lane_events:
        if e["name"] in ("worker:start", "worker:restart"):
            fresh.add(e["target"])
        elif e["name"] == "daemon:frame":
            cold = e["target"] in fresh
            fresh.discard(e["target"])
            if e["delta"] == cold or e["warm"] == cold:
                faults.append(f"round {e['round']} {e['target']}: delta {e['delta']}, warm "
                              f"{e['warm']} on a {'cold' if cold else 'warm'} worker")
    # one pid per target across the run, site_1's after the restart apart
    pids = {}
    for rec in recs:
        pids.setdefault(rec["site"], []).append(rec["pid"])
    for target, seen in pids.items():
        runs = [p for i, p in enumerate(seen) if i == 0 or p != seen[i - 1]]
        want_runs = 2 if target == "site_1" else 1
        if len(runs) != want_runs or len(set(runs)) != want_runs:
            faults.append(f"{target}: worker pids {runs} across the run")
    if restarts and pids.get("site_1", [None])[-1] != restarts[0]["pid"]:
        faults.append("site_1's last invocations ran on another pid than its restart's")
    if faults:
        raise AssertionError("path 6:\n  " + "\n  ".join(faults))

    # the costs: each worker's start (interpreter, torch, the port, the
    # CUDA context, the kernels' dlopen), its invocations on the engine's
    # clock (the invoke spans) and inside the worker (compute, the
    # torch._dynamo import, the round-file write)
    spans = {(e["name"][len("invoke:"):], e["round"]): e["dur"] for e in lane
             if e["kind"] == "span" and e["name"].startswith("invoke:")}
    workers = []
    for e in sorted(starts + restarts, key=lambda e: e["t0"]):
        mine = [r for r in recs if r["pid"] == e["pid"]]
        workers.append({"target": e["target"], "generation": e["generation"], "pid": e["pid"],
                        "warm_s": e["warm_s"], "invocations": len(mine)})
    per_inv = []
    for i, rec in enumerate(recs):
        rnd = i // (N_SITES + 1) + 1  # sites, then the aggregator, every round
        total = spans[(rec["site"], rnd)]
        per_inv.append(dict(round=rnd, site=rec["site"], pid=rec["pid"], call=rec["call"],
                            phase=rec["phase"], reduce=rec["reduce"], total_s=total,
                            compute_s=rec["t_exit"] - rec["t_entry"], dynamo_s=rec["dynamo_s"],
                            round_file_s=rec["round_file_s"]))
    first = [r for r in per_inv if r["call"] == 0]
    steady = [r for r in per_inv if r["call"] > 0 and r["dynamo_s"] == 0.0]
    restart_inv = next(r for r in per_inv
                       if r["site"] == "site_1" and r["round"] == killed["after_round"] + 1)
    site_steady = _spread([r["total_s"] for r in steady if r["site"] != "remote"])
    cold_frames = [e for e in frames if not e["delta"]]
    warm_frames = [e for e in frames if e["delta"]]
    return {
        "rounds": eng.rounds, "invocations": len(recs), "launches": launches, "wall_s": wall,
        "round_s": round_s, "killed": killed, "round_file_bytes": round_files,
        "workers": workers, "per_invocation": per_inv,
        "first_invocations": first,
        "dynamo_imports": [r for r in per_inv if r["dynamo_s"] > 0],
        "steady_site_total_s": site_steady,
        "steady_site_compute_s": _spread([r["compute_s"] for r in steady if r["site"] != "remote"]),
        "steady_remote_total_s": _spread([r["total_s"] for r in steady if r["site"] == "remote"]),
        "round_file_write_s": _spread([r["round_file_s"] for r in per_inv
                                       if r["reduce"] and r["site"] != "remote"]),
        # a worker's first invocation on the engine's clock holds its start
        "restart": {"warm_s": restarts[0]["warm_s"], "first_invocation_total_s": restart_inv["total_s"],
                    "first_invocation_compute_s": restart_inv["compute_s"],
                    "first_invocation_dynamo_s": restart_inv["dynamo_s"],
                    "over_a_steady_invocation_s": restart_inv["total_s"] - site_steady["median"]},
        "frames": {"cold": [(e["target"], e["tx_bytes"], e["rx_bytes"]) for e in cold_frames],
                   "warm_tx": _spread([e["tx_bytes"] for e in warm_frames]),
                   "warm_rx": _spread([e["rx_bytes"] for e in warm_frames])},
        "card_compute_pids": on_card,
        "global_test_metrics": check_metrics_csv(fed, SEQ_TASK),
    }


def log_daemon_path(daemon_path, seq_path, fresh_path, smi):
    """Phase 10's lines: path 6 against paths 2 and 5, and its costs."""
    log(f"[10 main path 6: sequence, one warm worker per node] {daemon_path['rounds']} rounds, "
        f"{daemon_path['invocations']} invocations, to SUCCESS in {daemon_path['wall_s']:.3f} s "
        f"(path 2 in one process: {seq_path['wall_s']:.3f} s; path 5, a process per "
        f"invocation: {fresh_path['wall_s']:.3f} s); site_1's worker SIGKILLed after round "
        f"{daemon_path['killed']['after_round']} and restarted; train_log, validation_log, "
        f"test_metrics and both sites' parameters equal path 2's bit for bit; launches "
        f"{daemon_path['launches']} inside the workers | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in daemon_path["round_s"]))
    log("  workers (target/generation/pid: start s, invocations): " + " ".join(
        f"{w['target']}/{w['generation']}/{w['pid']}:{w['warm_s']:.3f},{w['invocations']}"
        for w in daemon_path["workers"]))
    log("  each worker's first invocation (round target: engine total s, which holds the "
        "worker's start | compute s, of which torch._dynamo import s): " + " ".join(
            f"r{r['round']} {r['site']}: {r['total_s']:.3f} | {r['compute_s']:.3f}, "
            f"{r['dynamo_s']:.3f}" for r in daemon_path["first_invocations"]))
    log("  torch._dynamo imports (round target: import s of compute s): " + " ".join(
        f"r{r['round']} {r['site']}: {r['dynamo_s']:.3f} of {r['compute_s']:.3f}"
        for r in daemon_path["dynamo_imports"]))
    for key in ("steady_site_total_s", "steady_site_compute_s", "steady_remote_total_s",
                "round_file_write_s"):
        d = daemon_path[key]
        log(f"  {key}: median {d['median']:.4f}, range {d['min']:.4f}-{d['max']:.4f} "
            f"(n {d['n']})")
    r = daemon_path["restart"]
    log(f"  restart: worker start {r['warm_s']:.3f} s, first invocation "
        f"{r['first_invocation_total_s']:.3f} s (compute {r['first_invocation_compute_s']:.3f}, "
        f"torch._dynamo {r['first_invocation_dynamo_s']:.3f}), "
        f"{r['over_a_steady_invocation_s']:.3f} s over a "
        "steady site invocation")
    fr = daemon_path["frames"]
    log(f"  frames (target, tx, rx bytes): cold {fr['cold']}; warm tx median "
        f"{fr['warm_tx']['median']} ({fr['warm_tx']['min']}-{fr['warm_tx']['max']}), rx median "
        f"{fr['warm_rx']['median']} ({fr['warm_rx']['min']}-{fr['warm_rx']['max']})")
    log(f"  round files (bytes): {daemon_path['round_file_bytes']}; compute processes "
        f"nvidia-smi lists on the card: {daemon_path['card_compute_pids']} (this process: "
        f"{os.getpid()})")


# path 7: path 2's model on three sites through DaemonEngine with
# staleness-bounded async rounds (k 1, a pool of 3, discount 0.5),
# site_quorum 2, two invoke attempts, the int8 wire, and a fault plan that
# pins each fault to its own round (224 sequences a site, 168 of them
# training at split 0.75, batch 16: 11 gradient rounds, engine rounds 2-12
# without faults; round 2 holds each worker's one-off torch._dynamo
# import, rounds 3-5 are steady rounds of three contexts on the card):
# - round 1: site_1's worker SIGKILLed at the relay (worker_kill, idle),
#   restarted by round 2's request.  A restart takes far longer than the
#   grace window, so in a steady round it would make a stand-in (below);
#   round 2 blocks (no warm invocation yet, no steady contribution);
# - rounds 6 and 8: site_0 slowed by ASYNC_SLOW_FACTOR x the median site
#   invocation of round 3.  Round 6: its last contribution stands in (lag
#   1, weighed 0.5) while it computes on; round 7 blocks on it (its lag
#   would exceed k), and so does round 8.  A stand-in leaves its site
#   one batch behind the others for good, and sites out of phase never
#   meet at the epoch barrier (the barrier needs every site's waiting mode
#   in one round; a site told another still trains trains on — the
#   protocol of both packages), so
# - round 7: site_1 replays its round-6 output (stale, lag 1) instead of
#   computing, which puts it back in phase with site_0;
# - round 9: site_2, now the one ahead, crashes for good (site_died,
#   quorum:drop, quorum:continue), and the survivors run in phase;
# - round 13, the survivors' last gradient round: site_1's gradient
#   payload corrupted (healed by the aggregator's invoke retry; site_1's
#   next output is a barrier one, so no stand-in ever names the damaged
#   alias).
ASYNC_SITES = 3
ASYNC_FILES = 224
ASYNC_NODE_ARGS = dict(precision_bits=8, async_staleness=1, async_invoke_pool=3,
                       async_stale_discount=0.5, site_quorum=2, invoke_retry_attempts=2)
ASYNC_SLOW_FACTOR = 3.0
ASYNC_BASIS_ROUND = 3
ASYNC_FAULTS = [
    {"kind": "worker_kill", "round": 1, "site": "site_1", "when": "idle"},
    {"kind": "slow", "round": 6, "site": "site_0"},
    {"kind": "stale", "round": 7, "site": "site_1"},
    {"kind": "slow", "round": 8, "site": "site_0"},
    {"kind": "crash", "round": 9, "site": "site_2"},
    {"kind": "corrupt_payload", "round": 13, "site": "site_1", "file": "grads.npy"},
]


def _record_rounds(recs, lane):
    """Each invocation record's engine round: the round of the engine's
    ``invoke:<target>`` span (the submission round) that holds it."""
    spans = [e for e in lane if e["kind"] == "span" and e["name"].startswith("invoke:")]
    for rec in recs:
        held = [e["round"] for e in spans if e["name"] == f"invoke:{rec['site']}"
                and e["t0"] - 1e-3 <= rec["t_entry"] and rec["t_exit"] <= e["t0"] + e["dur"] + 1e-3]
        rec["round"] = held[-1] if held else None


def run_async_chaos_path(dev, workdir):
    """Path 2's model on three sites through ``DaemonEngine`` with async
    rounds, quorum, invoke retries and ``ASYNC_FAULTS``: every expected
    outcome on the engine lane, K1-K4 launched in the workers as the path
    needs them, SUCCESS with finite test metrics, no worker left on the
    card; each round's wall time and the card's concurrency over the three
    workers' contexts."""
    import torch

    from coinstac_dinunet_tpu_torch.federation import DaemonEngine

    torch.cuda.empty_cache()
    records = os.path.join(workdir, "invocations.jsonl")
    scripts = write_daemon_wrappers(workdir, records)
    fed = os.path.join(workdir, "fed")
    faults, round_s, on_card = [], [], {"before": card_compute_pids()}
    with DaemonEngine(
        fed, n_sites=ASYNC_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600, fault_plan={"faults": ASYNC_FAULTS},
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), **ASYNC_NODE_ARGS,
                                          "persist_round_state": True, "profile": True}},
    ) as eng:
        make_seq_files(eng, ASYNC_FILES)
        slow_s = None
        t0 = time.perf_counter()
        while not eng.success and eng.rounds < 60:
            tr = time.perf_counter()
            eng.step_round()
            round_s.append(time.perf_counter() - tr)
            if eng.rounds == ASYNC_BASIS_ROUND:
                # every worker up (round 1's relay killed site_1's; round 2
                # restarted it)
                on_card["workers_up"] = card_compute_pids()
                # the plan's slow faults last ASYNC_SLOW_FACTOR x this run's
                # median site invocation, read off the engine lane
                eng._telemetry_rec.flush()
                with open(os.path.join(fed, "telemetry.engine.jsonl")) as f:
                    basis = sorted(e["dur"] for e in map(json.loads, f)
                                   if e["kind"] == "span" and e["name"].startswith("invoke:site")
                                   and e.get("round") == ASYNC_BASIS_ROUND)
                slow_s = ASYNC_SLOW_FACTOR * basis[len(basis) // 2]
                for fault in eng.chaos.faults:
                    if fault.kind == "slow":
                        fault.seconds = slow_s
        wall = time.perf_counter() - t0
        pids_end = eng.worker_pids()
        pool = eng._async_config()["pool"]
    _card_left(on_card, pids_end, faults)
    if not eng.success:
        raise AssertionError(f"path 7: no SUCCESS after {eng.rounds} rounds")
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    lane = read_lanes(fed)
    _record_rounds(recs, lane)
    ev = [e for e in lane if e["kind"] == "event"]

    def named(name, **attrs):
        return [e for e in ev if e["name"] == name
                and all(e.get(k) == v for k, v in attrs.items())]

    # (a) a stand-in of site_0 at lag 1, accepted by the window and weighed 0.5
    standins = named("async:stale", site="site_0", lag=1)
    weighed = [e for e in standins
               if any(w["round"] == e["round"] and w["stale"].get("site_0") == 1
                      for w in named("async:window"))
               and any(d["round"] == e["round"] and d["weights"].get("site_0") == 0.5
                       for d in named("async:discount"))]
    if not weighed:
        faults.append(f"no stand-in of site_0 at lag 1 with its window and weight 0.5: "
                      f"stand-ins {[(e['site'], e['lag'], e['round']) for e in named('async:stale')]}")
    # (b) the corrupted payload healed by the aggregator's retry
    if not named("chaos:inject", fault="corrupt_payload", site="site_1"):
        faults.append("the corrupt_payload fault never fired")
    if not named("chaos:heal", fault="corrupt_payload"):
        faults.append("no chaos:heal of the corrupted payload")
    if not [e for e in named("invoke:retry", target="remote") if e["healed"] >= 1]:
        faults.append("no healing invoke:retry of the aggregator")
    # (c) the idle kill: one restart of site_1 at generation 2
    if [(e["target"], e["generation"]) for e in named("worker:restart")] != [("site_1", 2)]:
        faults.append("worker:restart events "
                      f"{[(e['target'], e['generation']) for e in named('worker:restart')]}")
    # (d) the crash: site_died, then quorum:drop and quorum:continue
    died = named("site_died")
    if [e["site"] for e in died] != ["site_2"]:
        faults.append(f"site_died events {[e['site'] for e in died]}")
    order = [e["name"] for e in ev if e["name"] in ("site_died", "quorum:drop", "quorum:continue")]
    if order[:3] != ["site_died", "quorum:drop", "quorum:continue"] or \
            named("quorum:drop")[0]["sites"] != ["site_2"]:
        faults.append(f"quorum records {order}")
    if eng.dead_sites != {"site_2"} or eng.remote_cache.get("dropped_sites") != ["site_2"]:
        faults.append(f"dead {eng.dead_sites}, dropped {eng.remote_cache.get('dropped_sites')}")
    if named("quorum:fail"):
        faults.append(f"quorum:fail {named('quorum:fail')}")
    # the kernels inside the workers: K2-K4 in every gradient-round site
    # invocation once per block at least, K1 once per payload per node
    names = list(FLASH_SOURCES)
    launches = dict.fromkeys(names, 0)
    k1 = 0
    for rec in recs:
        for name, n in zip(names, rec["launches"]):
            launches[name] += n
        k1 += rec["k1_launches"]
        if rec["role"] == "site" and rec["reduce"] and min(rec["launches"]) < SEQ_ARGS["num_layers"]:
            faults.append(f"r{rec['round']} {rec['site']}: K2/K3/K4 launched {rec['launches']} "
                          f"times, expected >= {SEQ_ARGS['num_layers']} each")
        payloads = int(rec["reduce"]) + int(rec["update"])
        if rec["k1_launches"] != payloads:
            faults.append(f"r{rec['round']} {rec['site']}: K1 launched {rec['k1_launches']} "
                          f"times for {payloads} int8 payloads")
    if None in [rec["round"] for rec in recs]:
        faults.append("an invocation record outside every invoke span")
    metrics = check_metrics_csv(fed, SEQ_TASK)
    if faults:
        raise AssertionError("path 7:\n  " + "\n  ".join(faults))

    # the rounds: wall time, what happened in each, and for the steady
    # rounds (every alive site fresh with a gradient, no fault, no
    # stand-in, no restart) the sites' summed compute over the round's wall
    # time — the concurrency the card gave the three contexts
    marks = {}
    for e in ev:
        if e["name"] == "chaos:inject":
            marks.setdefault(e["round"], []).append(f"{e['fault']} {e.get('site', '')}".strip())
        elif e["name"] in ("async:stale", "async:staleness_exceeded", "worker:restart",
                           "site_died"):
            marks.setdefault(e["round"], []).append(f"{e['name']} {e.get('site', e.get('target'))}")
        elif e["name"] == "invoke:retry":
            marks.setdefault(e["round"], []).append(f"invoke:retry {e['target']}")
    rounds = []
    for i, wall_r in enumerate(round_s):
        rnd = i + 1
        mine = [r for r in recs if r["round"] == rnd and r["role"] == "site"]
        alive = ASYNC_SITES - sum(1 for e in died if e["round"] < rnd)
        steady = (rnd not in marks and len(mine) == alive
                  and all(r["reduce"] and r["dynamo_s"] == 0.0 for r in mine))
        compute = sum(r["t_exit"] - r["t_entry"] for r in mine)
        rounds.append({"round": rnd, "wall_s": wall_r, "events": marks.get(rnd, []),
                       "sites": len(mine), "site_compute_s": compute, "steady": steady,
                       "concurrency": compute / wall_r if steady else None})
    slow_rounds = sorted({e["round"] for e in named("chaos:inject", fault="slow")})
    standin_rounds = sorted({e["round"] for e in named("async:stale")})
    steady_rounds = [r for r in rounds if r["steady"]]
    return {
        "rounds": eng.rounds, "invocations": len(recs), "wall_s": wall, "pool": pool,
        "slow_s": slow_s, "round_detail": rounds, "slow_rounds": slow_rounds,
        "standin_rounds": standin_rounds,
        # by the number of sites computing at once (3 before the crash, 2 after)
        "steady_concurrency": {n: _spread([r["concurrency"] for r in steady_rounds
                                           if r["sites"] == n]) for n in (3, 2)},
        "steady_round_s": {n: _spread([r["wall_s"] for r in steady_rounds if r["sites"] == n])
                           for n in (3, 2)},
        "launches": launches, "k1_launches": k1,
        "worker_starts": [(e["target"], e["generation"], e["round"], e["warm_s"])
                          for e in named("worker:start") + named("worker:restart")],
        "card_compute_pids": on_card, "workers_up": len(on_card.get("workers_up", [])),
        "global_test_metrics": metrics,
    }


def log_async_chaos_path(path, smi):
    """Phase 11's lines."""
    log(f"[11 main path 7: sequence, 3 sites, async k=1 pool {path['pool']}, quorum 2, chaos] "
        f"{path['rounds']} rounds, {path['invocations']} invocations, to SUCCESS in "
        f"{path['wall_s']:.3f} s; stand-in of site_0 at lag 1 weighed 0.5, corrupt payload "
        f"healed by the aggregator's retry, site_1's worker restarted (generation 2), site_2 "
        f"dead and quorum-dropped; launches {path['launches']}, K1 {path['k1_launches']} | {smi}")
    log(f"  slow faults {path['slow_s']:.3f} s each at rounds {path['slow_rounds']}; stand-in "
        f"rounds {path['standin_rounds']}; worker starts (target/generation/round: s): "
        + " ".join(f"{t}/{g}/r{r}:{w:.3f}" for t, g, r, w in path["worker_starts"]))
    log("  round seconds (* steady; events): " + " ".join(
        f"r{r['round']}:{r['wall_s']:.3f}{'*' if r['steady'] else ''}"
        + (f"({'; '.join(r['events'])})" if r["events"] else "")
        for r in path["round_detail"]))
    log("  steady rounds (sites computing): the sites' summed compute / the round's wall "
        "time, the card's concurrency over the workers' contexts: " + " ".join(
            f"r{r['round']}({r['sites']}):{r['site_compute_s']:.3f}/{r['wall_s']:.3f}"
            f"={r['concurrency']:.3f}" for r in path["round_detail"] if r["steady"]))
    for key in ("steady_concurrency", "steady_round_s"):
        for n, d in path[key].items():
            if d:
                log(f"  {key}, {n} sites: median {d['median']:.4f}, range {d['min']:.4f}-"
                    f"{d['max']:.4f} (n {d['n']})")
    log(f"  compute processes nvidia-smi lists: before {len(path['card_compute_pids']['before'])}, "
        f"with the workers up {path['workers_up']}, after close "
        f"{len(path['card_compute_pids']['after_close'])}; global test metrics "
        f"{path['global_test_metrics']}")


# Path 8: the site-vectorized federation.  12a runs path 2's configuration
# through SiteVectorizedEngine and holds its logs to path 2's within the JAX
# package's tolerance between its vectorized and file transports; 12b scales
# to VEC_SITES simulated sites, kills VEC_KILL_FRACTION of them at round
# VEC_KILL_ROUND under the quorum and admits one spare slot at
# VEC_JOIN_ROUND.  Each gradient round must launch K2, K3 and K4 once per
# block and micro-batch over the folded batch, whatever the number of sites.
# 12b's sites hold VEC_SUBJECTS subjects each, 4x path 2's, so that the
# epoch's training split (144 = 9 batches of 16) has full-batch rounds
# after the kill and the join to measure and profile.
VEC_LOG_ATOL = 2e-3
VEC_SITES = 16
VEC_SUBJECTS = 4 * SEQ_FILES
VEC_KILL_FRACTION = 0.125
VEC_KILL_ROUND = 2
VEC_JOIN_ROUND = 3
VEC_QUORUM = 0.75
VEC_PROFILED_ROUND = 6  # a full-batch round in the middle of the epoch
VEC_MIN_STEADY = 4  # full-batch rounds after the join, the profiled one aside


class RoundMeter:
    """Meters a site-vectorized engine's gradient rounds by wrapping its
    plane's ``train_step``.  A round runs from the end of the previous
    step (after a ``synchronize``) to the end of its own: the epoch
    accumulators' host copy, the next batches' loading, the engine's round
    hook and the step.  Per round: its wall time, the step's part of it,
    the unmasked samples, and each flash kernel's launches; round
    ``profile_round`` runs under ``torch.profiler``."""

    def __init__(self, fa, profile_round=None):
        self.fa = fa
        self.profile_round = profile_round
        self.rounds, self.profile = [], None
        self._prof = None
        self._t_last = None

    def engine_cls(self):
        from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine

        meter = self

        class MeteredEngine(SiteVectorizedEngine):
            def _build_federation(self, rc):
                return meter.wrap(super()._build_federation(rc))

        return MeteredEngine

    def start(self):
        import torch

        torch.cuda.synchronize()
        self._t_last = time.perf_counter()

    def wrap(self, fed):
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        step = fed.train_step

        def metered(site_batches):
            n = len(self.rounds) + 1
            samples = int(sum(np.asarray(b["_mask"]).sum() for site in site_batches
                              for b in site))
            before = [kern.launches for kern in self.fa.KERNELS]
            t_step = time.perf_counter()
            aux = step(site_batches)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            self.rounds.append({
                "round": n, "wall_s": t_end - self._t_last, "step_s": t_end - t_step,
                "samples": samples, "folded_rows": len(site_batches) * len(
                    site_batches[0][0]["_mask"]) * len(site_batches[0]),
                "launches": [kern.launches - b for kern, b in zip(self.fa.KERNELS, before)],
                "profiled": n == self.profile_round,
            })
            if self._prof is not None:
                self._prof.stop()
                self.profile = {"round": n, **profile_summary(self._prof, t_end - self._t_last)}
                self._prof = None
            if n + 1 == self.profile_round:
                self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self._prof.start()
            self._t_last = time.perf_counter()
            return aux

        fed.train_step = metered
        return fed


def check_vec_outputs(eng, workdir):
    """The vectorized engine's models on the card and finite, and the
    global test metrics finite; returns the metrics."""
    import torch

    for name, m in eng._trainer.nn.items():
        for pname, p in m.named_parameters():
            if not p.is_cuda or not torch.isfinite(p).all():
                raise AssertionError(f"{name}.{pname} is not finite on the card")
    return check_metrics_csv(workdir, SEQ_TASK)


def vec_flash_per_round():
    """K2-K4's launches a gradient round: num_layers x k (k micro-batches
    a round), and k."""
    k = max(int(seq_node_args().get("local_iterations", 1)), 1)
    return SEQ_ARGS["num_layers"] * k, k


def vec_flash_counts(meter):
    """Faults of the K2-K4 count per gradient round: each kernel exactly
    num_layers x k times."""
    want, _ = vec_flash_per_round()
    return [f"round {r['round']}: K2/K3/K4 launched {r['launches']} times, expected "
            f"{want} each" for r in meter.rounds if r["launches"] != [want] * 3]


def log_distance(got, want):
    """The largest absolute difference between two runs' score logs."""
    import numpy as np

    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max())
               for k in want)


def run_vec_same_function(dev, workdir, fa, compute_dtype=None, extra=None):
    """12a: path 2's configuration through ``SiteVectorizedEngine`` (both
    sites' steps in one folded batch): its logs against path 2's.  With
    ``compute_dtype`` both runs take that dtype (the float32 rerun);
    ``extra`` adds to the node arguments (phase 15c's AUC)."""
    args = {**seq_node_args(), **(extra or {})}
    if compute_dtype is not None:
        args["compute_dtype"] = compute_dtype
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    meter = RoundMeter(fa)
    eng = meter.engine_cls()(workdir, n_sites=N_SITES, trainer_cls=SeqTrainer,
                             dataset_cls=SyntheticSeqDataset, device=dev, task_id=SEQ_TASK, **args)
    make_seq_files(eng)
    for kern in fa.KERNELS:
        kern.launches = 0
    meter.start()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError("12a: no SUCCESS")
    faults = vec_flash_counts(meter)
    if faults:
        raise AssertionError("12a:\n  " + "\n  ".join(faults))
    check_vec_outputs(eng, workdir)
    return {"logs": {k: eng.cache[k] for k in (*SEQ_LOGS, "global_test_metrics")},
            "wall_s": wall, "rounds": meter.rounds,
            "launches": dict(zip(FLASH_SOURCES, (k.launches for k in fa.KERNELS)))}


def run_vectorized_path(dev, workdir, seq_path):
    """Path 8 (phase 12): 12a, path 2's function through the vectorized
    plane, held to path 2's logs (or, if bfloat16 on the folded batch
    cannot meet the tolerance, the distance reported and a float32 rerun of
    both that must); 12b, ``VEC_SITES`` sites at path 2's width with the
    kill plan, a spare slot's join and the quorum: SUCCESS, the planned
    deaths, the join, K2-K4 per round independent of the sites; its round
    times, throughput, peak memory and a profiled round."""
    import torch

    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset
    from coinstac_dinunet_tpu_torch.resilience import chaos

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    out = {}
    same = run_vec_same_function(dev, os.path.join(workdir, "12a"), fa)
    want = {**seq_path["logs"], "global_test_metrics": seq_path["global_test_log"]}
    out["12a"] = {**same, "distance": log_distance(same["logs"], want)}
    if out["12a"]["distance"] > VEC_LOG_ATOL:
        # the float32 rerun of both (TF32 is off since phase 1)
        serial = run_seq_path(dev, os.path.join(workdir, "12a_f32_serial"),
                              compute_dtype="float32")
        rerun = run_vec_same_function(dev, os.path.join(workdir, "12a_f32"), fa,
                                      compute_dtype="float32")
        want32 = {**serial["logs"], "global_test_metrics": serial["global_test_log"]}
        out["12a_float32"] = {"distance": log_distance(rerun["logs"], want32),
                              "logs": rerun["logs"], "serial_logs": want32}
        if out["12a_float32"]["distance"] > VEC_LOG_ATOL:
            raise AssertionError(
                f"12a: logs {out['12a']['distance']:.3e} from path 2's in bfloat16 and "
                f"{out['12a_float32']['distance']:.3e} in float32, tolerance {VEC_LOG_ATOL}")

    # ---- 12b: the scaled run
    plan = chaos.fraction_kill_plan(VEC_SITES, VEC_KILL_FRACTION, round=VEC_KILL_ROUND, seed=1)
    planned = {f["site"] for f in plan["faults"]}
    spare = f"site_{VEC_SITES}"
    plan["faults"].append({"kind": "join", "round": VEC_JOIN_ROUND, "site": spare})
    meter = RoundMeter(fa, profile_round=VEC_PROFILED_ROUND)
    wd = os.path.join(workdir, "12b")
    eng = meter.engine_cls()(wd, n_sites=VEC_SITES, trainer_cls=SeqTrainer,
                             dataset_cls=SyntheticSeqDataset, device=dev, task_id=SEQ_TASK,
                             fault_plan=plan, site_quorum=VEC_QUORUM, profile=True,
                             **seq_node_args())
    make_seq_files(eng, VEC_SUBJECTS)  # every slot, the spare included
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kern in fa.KERNELS:
        kern.launches = 0
    meter.start()
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    launches = dict(zip(FLASH_SOURCES, (k.launches for k in fa.KERNELS)))
    peak = torch.cuda.max_memory_allocated()
    faults = vec_flash_counts(meter)
    if not eng.success:
        faults.append("no SUCCESS")
    if eng.dead_sites != planned:
        faults.append(f"dead sites {sorted(eng.dead_sites)}, planned {sorted(planned)}")
    with open(os.path.join(wd, "telemetry.engine.jsonl")) as f:
        lane = [json.loads(line) for line in f]
    joins = [e for e in lane if e["name"] == "membership:join"]
    if [(e["site"], e["round"]) for e in joins] != [(spare, VEC_JOIN_ROUND)]:
        faults.append(f"membership:join records {[(e['site'], e['round']) for e in joins]}")
    if eng.capacity != VEC_SITES + 1 or eng.spare_sites:
        faults.append(f"capacity {eng.capacity}, spare slots left {eng.spare_sites}")
    # steady: the full-batch rounds after the join, the profiled one aside.
    # Loaders start with the epoch, as in the JAX package: the spare's
    # rides masked until the next one, the dead sites' run on masked, so
    # a full batch is the 14 live sites' 16 rows each of 17 x 16
    live_rows = (VEC_SITES - len(planned)) * SEQ_ARGS["batch_size"]
    steady = [r for r in meter.rounds if r["round"] > VEC_JOIN_ROUND
              and r["samples"] == live_rows and not r["profiled"]]
    if len(steady) < VEC_MIN_STEADY:
        faults.append(f"{len(steady)} full-batch rounds after the join, want "
                      f">= {VEC_MIN_STEADY}")
    if meter.profile is None or meter.rounds[VEC_PROFILED_ROUND - 1]["samples"] != live_rows:
        faults.append(f"round {VEC_PROFILED_ROUND} not profiled at a full batch")
    if faults:
        raise AssertionError("12b:\n  " + "\n  ".join(faults))
    metrics = check_vec_outputs(eng, wd)
    steady_ids = {r["round"] for r in steady}
    # the lane's round r runs from round r's hook to round r+1's: round r's
    # step and round r+1's loading, so both rounds must be steady ones
    lane_ids = {r for r in steady_ids if r + 1 in steady_ids}
    out["12b"] = {
        "sites": VEC_SITES, "capacity": eng.capacity, "dead_sites": sorted(eng.dead_sites),
        "joined": spare, "rounds": meter.rounds, "wall_s": wall, "launches": launches,
        "steady_rounds": sorted(steady_ids),
        "steady_round_s": _spread([r["wall_s"] for r in steady]),
        "steady_step_s": _spread([r["step_s"] for r in steady]),
        "steady_samples_per_s": _spread([r["samples"] / r["wall_s"] for r in steady]),
        "rounds_per_sec": [e["value"] for e in lane if e["name"] == "rounds_per_sec"],
        "sites_per_sec": [e["value"] for e in lane if e["name"] == "sites_per_sec"],
        "steady_rounds_per_sec": _spread([e["value"] for e in lane if e["name"] ==
                                          "rounds_per_sec" and e["round"] in lane_ids]),
        "steady_sites_per_sec": _spread([e["value"] for e in lane if e["name"] ==
                                         "sites_per_sec" and e["round"] in lane_ids]),
        "engine_round_s": [e["dur"] for e in lane if e["name"] == "engine:round"],
        "max_memory_allocated_bytes": peak, "profile": meter.profile,
        "global_test_metrics": metrics,
    }
    return out


def log_vectorized_path(path, smi):
    a, b = path["12a"], path["12b"]
    want, k = vec_flash_per_round()
    log(f"  K2/K3/K4 expected {want} launches each a gradient round "
        f"(num_layers {SEQ_ARGS['num_layers']} x k {k})")
    log(f"  12a: path 2's configuration "
        f"({N_SITES} sites folded into one batch) to SUCCESS in {a['wall_s']:.3f} s; logs "
        f"{a['distance']:.3e} from path 2's (tolerance {VEC_LOG_ATOL}); launches "
        f"{a['launches']} | {smi}")
    if "12a_float32" in path:
        log(f"  bfloat16 missed the tolerance; float32 rerun of both (TF32 off): logs "
            f"{path['12a_float32']['distance']:.3e} apart")
    log("  12a rounds (wall/step s, samples, K2/K3/K4): " + " ".join(
        f"r{r['round']}:{r['wall_s']:.3f}/{r['step_s']:.3f},{r['samples']},"
        f"{'/'.join(map(str, r['launches']))}" for r in a["rounds"]))
    log(f"  12b: {b['sites']} sites of {VEC_SUBJECTS} subjects + 1 spare slot "
        f"(capacity {b['capacity']}) to SUCCESS in "
        f"{b['wall_s']:.3f} s; dead {b['dead_sites']} (quorum {VEC_QUORUM}), {b['joined']} "
        f"joined at round {VEC_JOIN_ROUND}; launches {b['launches']}; "
        f"torch.cuda.max_memory_allocated {b['max_memory_allocated_bytes'] / 2 ** 30:.3f} GiB | {smi}")
    log("  12b rounds (wall/step s, unmasked samples of folded rows, K2/K3/K4; * profiled): "
        + " ".join(f"r{r['round']}{'*' if r['profiled'] else ''}:{r['wall_s']:.3f}/"
                   f"{r['step_s']:.3f},{r['samples']}/{r['folded_rows']},"
                   f"{'/'.join(map(str, r['launches']))}" for r in b["rounds"]))
    log(f"  steady rounds {b['steady_rounds']} (full batch, after the join, not profiled):")
    for key in ("steady_round_s", "steady_step_s", "steady_samples_per_s",
                "steady_rounds_per_sec", "steady_sites_per_sec"):
        d = b[key]
        log(f"    {key}: median {d['median']:.4f}, range {d['min']:.4f}-{d['max']:.4f} "
            f"(n={d['n']})")
    log("  engine lane: engine:round s " + " ".join(f"{x:.4f}" for x in b["engine_round_s"])
        + "; rounds_per_sec " + " ".join(f"{x:.4f}" for x in b["rounds_per_sec"])
        + "; sites_per_sec " + " ".join(f"{x:.3f}" for x in b["sites_per_sec"]))
    log(f"  global test metrics {b['global_test_metrics']}")
    log_profiles([b["profile"]])


# Path 9: path 2's model and arguments through DaemonEngine with the int8
# wire, the k-ary tree fan-in (k 2), async rounds (k 1), run-ahead (d 1) and
# a quorum of 2, three founding sites and one spare worker, and a plan of
# membership operations.  MEM_FILES sequences a site give 224 training
# sequences, 14 gradient rounds (engine rounds 2-15) in the one epoch.
# Round 1 is INIT and round 2 the first gradient round, whose broadcast
# follows NEXT_RUN (not steady): round 3 is the first pipelined round, so
# each operation sits after a pipelined round, whose reduce the membership
# round drains:
# - round 4: site_3 joins (the spare worker started with the engine).  The
#   sites' invocations are in flight, so the admission request waits for
#   round 5, whose donor invocation (idle after the barrier round 4) ships
#   its train state; the admission broadcast of round 5 carries it, and
#   site_3 enters in round 6;
# - round 7: site_1 leaves (its round-8 invocation, the first idle one,
#   carries ``leave``; the aggregator retires it in round 8);
# - round 9: site_2 crashes for good (site_died, quorum:drop; site_0 and
#   site_3 stay, which the quorum of 2 allows);
# - round 10: site_2 rejoins (admitted in round 11, entering in round 12).
# No slow fault: a stand-in would dephase its site for good.
MEM_SITES = 3
MEM_FILES = 300
MEM_NODE_ARGS = dict(precision_bits=8, reduce_fanin=2, async_staleness=1, run_ahead=1,
                     site_quorum=2)
MEM_FAULTS = [
    {"kind": "join", "round": 4, "site": "site_3"},
    {"kind": "leave", "round": 7, "site": "site_1"},
    {"kind": "crash", "round": 9, "site": "site_2"},
    {"kind": "rejoin", "round": 10, "site": "site_2"},
]
MEM_TREE_TOL = 2e-6  # the JAX package's tolerance between its tree and flat means
MEM_TREE_CHECKS = 2  # gradient rounds whose tree mean is held to the flat mean
# 13b: two sites, no fault, k 0, a pool of 2, 128 sequences a site (96
# training: six gradient rounds in the one epoch); the first gradient round
# holds each worker's torch._dynamo import and is left out of the medians
DRAIN_FILES = 128
DRAIN_NODE_ARGS = dict(precision_bits=8, async_staleness=0, async_invoke_pool=2)

# path 9's worker module: DAEMON_WRAPPER plus one more JSON-lines file of
# the invocation: its input round, whether it applied an update, the
# membership keys it got, a digest of the site's train state after the
# invocation (the parameters, the Adam moments and steps, the step) and,
# for a joiner's first invocation, of the state its warm start loaded; on
# the aggregator the first MEM_TREE_CHECKS tree means against the flat
# guarded mean of the same payload files (both sides dequantized by the
# same load, weighed alike; the flat one computed without side effects).
# Each worker also holds the first launch of each of its kernels, on the
# path's own inputs, against the plain version (no launch of its own):
# K1's payload bit for bit, K2's out and K3's dq, K4's dk and dv against the
# rounding-matched plain versions within phase 3's tolerance (the backward
# ones on the kernels' own residuals, so each check isolates one kernel)
MEMBERSHIP_WRAPPER = DAEMON_WRAPPER + """
import hashlib
from coinstac_dinunet_tpu_torch import telemetry as _tel
from coinstac_dinunet_tpu_torch.parallel import reducer as _red
from coinstac_dinunet_tpu_torch.utils import tensorutils as _tu
EXTRA = {{"warm": None, "tree": [], "held": {{}}}}
HELD = set()
TREE_LEFT = [{checks}]


def _err(got, want):
    return [float((got.float() - want.float()).abs().max()), float(want.float().abs().max())]


_quantize = _tu.quantize_int8_many


def _held_quantize(leaves, seeds):
    leaves, seeds = list(leaves), list(seeds)
    buf = _quantize(leaves, seeds)
    if "k1" not in HELD and buf.device.type == "cuda":
        HELD.add("k1")
        EXTRA["held"]["k1"] = bool(torch.equal(buf, quant.quantize_int8_many_plain(leaves, seeds)))
    return buf


_tu.quantize_int8_many = _held_quantize
_fwd_cuda, _bwd_cuda = fa.flash_forward_cuda, fa.flash_backward_cuda


def _round_dtype(q):
    return None if q.dtype == torch.float32 else q.dtype


def _held_fwd(q, k, v, *pos):
    out, lse = _fwd_cuda(q, k, v, *pos)
    if "fwd" not in HELD:
        HELD.add("fwd")
        want = fa.flash_forward_plain(q, k, v, *pos, round_dtype=_round_dtype(q))[0]
        EXTRA["held"]["fwd"] = [_err(out, want)]
    return out, lse


def _held_bwd(q, k, v, out, lse, g_out, g_lse, *pos):
    grads = _bwd_cuda(q, k, v, out, lse, g_out, g_lse, *pos)
    if "bwd" not in HELD:
        HELD.add("bwd")
        args = (q, k, v, g_out.to(q.dtype), lse, fa.flash_delta(out, g_out), g_lse, *pos)
        rd = _round_dtype(q)
        want = (fa.flash_dq_plain(*args, round_dtype=rd), *fa.flash_dkv_plain(*args, round_dtype=rd))
        EXTRA["held"]["bwd"] = [_err(g, w) for g, w in zip(grads, want)]
    return grads


fa.flash_forward_cuda, fa.flash_backward_cuda = _held_fwd, _held_bwd


def _digest(ts):
    h = hashlib.sha256()
    for name in sorted(ts.nn):
        opt = ts.optimizer[name]
        for pname, p in ts.nn[name].named_parameters():
            h.update(pname.encode())
            h.update(p.detach().float().cpu().numpy().tobytes())
            st = opt.state.get(p) or {{}}
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    h.update(st[key].detach().float().cpu().numpy().tobytes())
            if "step" in st:
                h.update(str(int(st["step"])).encode())
    h.update(str(int(ts.step)).encode())
    return h.hexdigest()


_join_run = node_local.COINNLocal._join_run


def _digest_join(self, trainer, admission):
    out = _join_run(self, trainer, admission)
    if trainer.train_state is not None:
        EXTRA["warm"] = _digest(trainer.train_state)
    return out


node_local.COINNLocal._join_run = _digest_join
_tree_average = _red.COINNReducer._tree_average


def _checked_tree(self, file_key, **kw):
    tree = _tree_average(self, file_key, **kw)
    if TREE_LEFT[0] > 0:
        TREE_LEFT[0] -= 1
        with _tel.activate(_tel.NULL_RECORDER):
            weights = self._site_weights()
            flat, _ok = _red.guarded_mean(self._stack(self._load(file_key)), weights)
        err = max(float((t.float() - f).abs().max()) for t, f in zip(tree, flat))
        bad = sum(int((~torch.isclose(t.float(), f, rtol={tol}, atol={tol})).sum())
                  for t, f in zip(tree, flat))
        scale = max(float(f.abs().max()) for f in flat)
        EXTRA["tree"].append(dict(sites=len(self.input), leaves=len(tree), max_abs_err=err,
                                  max_abs=scale, outside=bad,
                                  fanin=self._tree_fanin()))
    return tree


_red.COINNReducer._tree_average = _checked_tree
_compute = compute


def compute(payload, device=None):
    EXTRA["warm"], EXTRA["tree"], EXTRA["held"] = None, [], {{}}
    inp = payload["input"]
    result = _compute(payload, device=device)
    me = payload["state"].get("clientId", "remote")
    ts = payload["cache"].get("_train_state") if ROLE == "site" else None
    extra = dict(pid=os.getpid(), call=calls - 1, site=me,
                 input_round=inp.get("wire_round") if ROLE == "site" else None,
                 update=bool(inp.get("update")) if ROLE == "site" else None,
                 sync=bool(inp.get("membership_sync")), leave=bool(inp.get("leave")),
                 admitted=bool((inp.get("admissions") or {{}}).get(me)) if ROLE == "site" else None,
                 digest=_digest(ts) if ts is not None else None, warm=EXTRA["warm"],
                 tree=EXTRA["tree"], held=EXTRA["held"])
    with open(RECORDS + ".extra", "a") as f:
        f.write(json.dumps(extra) + "\\n")
    return result
"""


def write_membership_wrappers(workdir, records):
    """``MEMBERSHIP_WRAPPER`` around the ``seq_classification`` entry
    scripts, one per role; returns ``{role: path}``."""
    entry_dir = os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples", SEQ_TASK)
    scripts = {}
    for role, entry in (("site", "local.py"), ("remote", "remote.py")):
        scripts[role] = os.path.join(workdir, f"membership_{role}.py")
        with open(scripts[role], "w") as f:
            f.write(MEMBERSHIP_WRAPPER.format(
                root=HERE, entry=os.path.join(entry_dir, entry), records=records, role=role,
                checks=MEM_TREE_CHECKS, tol=MEM_TREE_TOL))
    return scripts


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def read_lanes(workdir):
    """The engine's lane and the aggregator's (``remote_out``), merged in
    time order: the aggregator's quorum, window, discount and membership
    records are on its own lane, its round its invocation count (the
    engine's round).  Wire records (no name) are left out."""
    lane = _read_jsonl(os.path.join(workdir, "telemetry.engine.jsonl"))
    remote = os.path.join(workdir, "remote_out", "telemetry.remote.jsonl")
    lane += [r for r in _read_jsonl(remote) if "name" in r]
    return sorted(lane, key=lambda r: r["t0"])


def run_membership_path(dev, workdir):
    """13a: path 9's full plan.  Roster epochs and membership events, the
    joiners' first contributions, their warm starts bit-equal to a founding
    member's state, the pipeline's overlap and drains, the tree mean against
    the flat mean, K1-K4 in every site worker, no worker left on the card."""
    import torch

    from coinstac_dinunet_tpu_torch.federation import DaemonEngine

    torch.cuda.empty_cache()
    records = os.path.join(workdir, "invocations.jsonl")
    scripts = write_membership_wrappers(workdir, records)
    fed = os.path.join(workdir, "fed")
    faults, rounds, on_card = [], [], {"before": card_compute_pids()}
    with DaemonEngine(
        fed, n_sites=MEM_SITES, local_script=scripts["site"], remote_script=scripts["remote"],
        device=dev.type, timeout=600, fault_plan={"faults": MEM_FAULTS},
        first_input={f"{SEQ_TASK}_args": {**seq_node_args(), **MEM_NODE_ARGS,
                                          "persist_round_state": True, "profile": True}},
    ) as eng:
        make_seq_files(eng, MEM_FILES)
        # the joiner's data is in place before it joins (its loader reads it
        # at its admission)
        d = os.path.join(fed, "site_3", "data")
        os.makedirs(d, exist_ok=True)
        for i in range(MEM_FILES):
            open(os.path.join(d, f"site_3_subj_{i:03d}"), "w").close()
        t0 = time.perf_counter()
        while not eng.success and eng.rounds < 80:
            tr = time.perf_counter()
            site_outs, remote_out = eng.step_round()
            rounds.append({"round": eng.rounds, "wall_s": time.perf_counter() - tr,
                           "sites": sorted(site_outs),
                           "epoch": (eng.remote_cache.get("roster") or {}).get("epoch")})
            if eng.rounds == 6:
                on_card["workers_up"] = card_compute_pids()
        wall = time.perf_counter() - t0
        eng._pipeline_drain(eng._recorder())
        pids_end = eng.worker_pids()
        roster = dict(eng.remote_cache.get("roster") or {})
        dead, left = set(eng.dead_sites), set(eng.left_sites)
    _card_left(on_card, pids_end, faults)
    if not eng.success:
        raise AssertionError(f"path 9: no SUCCESS after {eng.rounds} rounds")
    recs, extras = _read_jsonl(records), _read_jsonl(records + ".extra")
    lane = read_lanes(fed)
    ev = [e for e in lane if e["kind"] == "event"]

    def named(name, **attrs):
        return [e for e in ev if e["name"] == name
                and all(e.get(k) == v for k, v in attrs.items())]

    # the roster: one epoch bump and one membership event per operation;
    # the leave is no death, the crash is the only one
    mem = [(e["name"], e["site"], e["epoch"], e.get("round")) for e in ev
           if e["name"].startswith("membership:")]
    want_mem = [("membership:join", "site_3", 2), ("membership:leave", "site_1", 3),
                ("membership:rejoin", "site_2", 4)]
    if [m[:3] for m in mem] != want_mem:
        faults.append(f"membership events {mem}, expected {want_mem}")
    if roster.get("epoch") != 1 + len(want_mem):
        faults.append(f"roster epoch {roster.get('epoch')}, expected {1 + len(want_mem)}")
    if sorted(roster.get("members", {})) != ["site_0", "site_2", "site_3"] or \
            roster.get("left") != ["site_1"]:
        faults.append(f"roster {roster}")
    if [e["site"] for e in named("site_died")] != ["site_2"]:
        faults.append(f"site_died events {[e['site'] for e in named('site_died')]}")
    if dead or left != {"site_1"}:
        faults.append(f"dead {dead}, left {left}")
    for name in ("quorum:fail", "membership:refused"):
        if named(name):
            faults.append(f"{name} {named(name)}")
    # a joiner admitted in round r contributes from round r + 1, once
    joins = []
    for name, site, epoch, rnd in mem:
        if name == "membership:leave":
            continue
        after = [r["round"] for r in rounds if r["round"] > rnd and site in r["sites"]]
        absent = [r["round"] for r in rounds if r["round"] > rnd and site not in r["sites"]
                  and r["round"] < (after[0] if after else 0)]
        joins.append({"site": site, "admitted_round": rnd, "first_round": after[0] if after
                      else None})
        if not after or after[0] != rnd + 1 or absent:
            faults.append(f"{site} admitted in round {rnd} first contributed in round "
                          f"{after[:1]}")
    # the warm starts: the joiner's loaded state is the donor's after its
    # sync invocation, and after its first invocation it equals every
    # founding member's that consumed the same broadcast
    warm = []
    for x in extras:
        if x["site"] == "remote" or not x["admitted"] or x["warm"] is None:
            continue
        donor = [y for y in extras if y["sync"] and y["digest"] is not None
                 and y["input_round"] is not None and y["input_round"] < x["input_round"]]
        donor = donor[-1] if donor else None
        peers = [y for y in extras if y["site"] not in ("remote", x["site"]) and y["update"]
                 and y["input_round"] == x["input_round"] and not y["admitted"]]
        row = {"site": x["site"], "input_round": x["input_round"],
               "donor": donor and donor["site"],
               "warm_equals_donor": bool(donor) and x["warm"] == donor["digest"],
               "peers": [y["site"] for y in peers],
               "after_equals_peers": bool(peers) and all(y["digest"] == x["digest"]
                                                         for y in peers)}
        warm.append(row)
        if not (row["warm_equals_donor"] and row["after_equals_peers"]):
            faults.append(f"warm start {row}")
    if [w["site"] for w in warm] != ["site_3", "site_2"]:
        faults.append(f"warm starts {warm}")
    # the pipeline: reduces ran while sites computed, run-ahead depths were
    # recorded, and every operation's round drained it
    overlap = sum(e["secs"] for e in named("pipeline:reduce_concurrent"))
    if overlap <= 0:
        faults.append("no pipeline:reduce_concurrent seconds")
    depth = [e for e in lane if e["kind"] == "metric" and e["name"] == "site_run_ahead"]
    if not depth:
        faults.append("no site_run_ahead metric on the engine lane")
    drains = [e["round"] for e in named("pipeline:drain", reason="membership")]
    op_rounds = [f["round"] for f in MEM_FAULTS if f["kind"] != "crash"]
    if drains != op_rounds:
        faults.append(f"membership drains in rounds {drains}, expected {op_rounds}")
    # the tree fan-in against the flat mean
    trees = [t for x in extras if x["site"] == "remote" for t in x["tree"]]
    if len(trees) != MEM_TREE_CHECKS or any(t["outside"] for t in trees):
        faults.append(f"tree means against the flat means: {trees}")
    if not named("reduce:tree"):
        faults.append("no reduce:tree record")
    # the kernels inside every site worker, the joiners' included
    names = list(FLASH_SOURCES)
    per_worker = {}
    for rec in recs:
        w = per_worker.setdefault((rec["site"], rec["pid"]), {"launches": [0, 0, 0], "k1": 0,
                                                            "invocations": 0})
        w["launches"] = [a + b for a, b in zip(w["launches"], rec["launches"])]
        w["k1"] += rec["k1_launches"]
        w["invocations"] += 1
        if rec["role"] == "site" and rec["reduce"] and min(rec["launches"]) < SEQ_ARGS["num_layers"]:
            faults.append(f"{rec['site']} call {rec['call']}: K2/K3/K4 launched "
                          f"{rec['launches']} times, expected >= {SEQ_ARGS['num_layers']} each")
        payloads = int(rec["reduce"]) + int(rec["update"])
        if rec["k1_launches"] != payloads:
            faults.append(f"{rec['site']} call {rec['call']}: K1 launched {rec['k1_launches']} "
                          f"times for {payloads} int8 payloads")
    # each worker's first launch of each kernel, held to the plain version
    held = {}
    for x in extras:
        held.setdefault((x["site"], x["pid"]), {}).update(x["held"])
    for key, h in held.items():
        want = {"k1"} if key[0] == "remote" else {"k1", "fwd", "bwd"}
        if set(h) != want or not h["k1"]:
            faults.append(f"worker {key}: held {h}")
        for what in ("fwd", "bwd"):
            for err, scale in h.get(what, []):
                if not err <= FLASH_BF16_MATCHED_RTOL * scale + FLASH_ATOL:
                    faults.append(f"worker {key}: {what} {err:.3e} from its rounding-matched "
                                  f"plain version (max {scale:.3e})")
    if sorted(held) != sorted(per_worker):
        faults.append(f"held in workers {sorted(held)}, workers {sorted(per_worker)}")
    site_workers = {k: v for k, v in per_worker.items() if k[0] != "remote"}
    if sorted({k[0] for k in site_workers}) != ["site_0", "site_1", "site_2", "site_3"] or \
            len([k for k in site_workers if k[0] == "site_2"]) != 2:
        faults.append(f"site workers {sorted(site_workers)}")
    for key, w in site_workers.items():
        if min(w["launches"]) == 0 or w["k1"] == 0:
            faults.append(f"worker {key}: K2/K3/K4 {w['launches']}, K1 {w['k1']}")
    launches = {n: sum(w["launches"][i] for w in per_worker.values())
                for i, n in enumerate(names)}
    metrics = check_metrics_csv(fed, SEQ_TASK)
    if faults:
        raise AssertionError("path 9 (13a):\n  " + "\n  ".join(faults))

    marks = {}
    for e in ev:
        if e["name"].startswith("membership:") or e["name"] in (
                "site_died", "worker:start", "worker:shutdown", "async:stale",
                "pipeline:stall", "quorum:drop"):
            marks.setdefault(e.get("round"), []).append(
                f"{e['name']} {e.get('site', e.get('target', ''))}".strip())
        elif e["name"] == "pipeline:drain":
            marks.setdefault(e["round"], []).append(f"drain {e['reason']}")
    for r in rounds:
        r["events"] = marks.get(r["round"], [])
    return {
        "rounds": len(rounds), "wall_s": wall, "round_detail": rounds,
        "roster_epochs": [r["epoch"] for r in rounds], "membership": mem, "joins": joins,
        "warm_starts": warm, "overlap_s": overlap,
        "reduce_concurrent": len(named("pipeline:reduce_concurrent")),
        "run_ahead_submissions": len(named("async:run_ahead")),
        "stalls": len(named("pipeline:stall")), "drains": drains, "tree_checks": trees,
        "launches": launches, "k1_launches": sum(w["k1"] for w in per_worker.values()),
        "per_worker": [{"target": k[0], "pid": k[1], **v, "held": held.get(k, {})}
                       for k, v in per_worker.items()],
        "worker_starts": [(e["target"], e["generation"], e.get("round"), e["warm_s"])
                          for e in named("worker:start") + named("worker:restart")],
        "card_compute_pids": on_card, "global_test_metrics": metrics,
    }


def run_drain_path(dev, workdir):
    """13b: two sites, no faults, k 0, a pool of 2, three runs: d 1 under
    ``_PIPELINE_FORCE_DRAIN``, d 0, d 1 pipelined.  Runs 1 and 2 end on the
    same ``avg_grads`` bit for bit, with the same site cursors and logs;
    the steady rounds of runs 2 and 3 are timed."""
    import numpy as np
    import torch

    from coinstac_dinunet_tpu_torch import config
    from coinstac_dinunet_tpu_torch import engine as engine_module
    from coinstac_dinunet_tpu_torch.federation import DaemonEngine
    from coinstac_dinunet_tpu_torch.utils import tensorutils

    def run(tag, extra, force):
        torch.cuda.empty_cache()
        wd = os.path.join(workdir, tag)
        os.makedirs(wd)
        records = os.path.join(wd, "invocations.jsonl")
        scripts = write_daemon_wrappers(wd, records)
        fed = os.path.join(wd, "fed")
        engine_module._PIPELINE_FORCE_DRAIN = force
        rounds = []
        try:
            with DaemonEngine(
                fed, n_sites=N_SITES, local_script=scripts["site"],
                remote_script=scripts["remote"], device=dev.type, timeout=600,
                first_input={f"{SEQ_TASK}_args": {**seq_node_args(), **DRAIN_NODE_ARGS,
                                                  **extra, "persist_round_state": True,
                                                  "profile": True}},
            ) as eng:
                make_seq_files(eng, DRAIN_FILES)
                while not eng.success and eng.rounds < 40:
                    tr = time.perf_counter()
                    site_outs, _ = eng.step_round()
                    rounds.append({"round": eng.rounds, "wall_s": time.perf_counter() - tr,
                                   "grad": all(o.get("reduce") for o in site_outs.values())
                                   and len(site_outs) == N_SITES})
                eng._pipeline_drain(eng._recorder())
                cursors = {s: (c.get("cursor"), c.get("epoch"))
                           for s, c in eng.site_caches.items()}
                logs = {k: eng.remote_cache[k] for k in SEQ_LOGS}
                d = eng._async_config()["run_ahead"]
        finally:
            engine_module._PIPELINE_FORCE_DRAIN = False
        if not eng.success:
            raise AssertionError(f"13b {tag}: no SUCCESS after {eng.rounds} rounds")
        avg = tensorutils.load_arrays(os.path.join(fed, "remote_xfer", config.avg_grads_file))
        lane = _read_jsonl(os.path.join(fed, "telemetry.engine.jsonl"))
        grad = [r for r in rounds if r["grad"]]
        return {"tag": tag, "d": d, "rounds": rounds, "avg": avg, "cursors": cursors,
                "logs": logs, "grad_rounds": len(grad),
                "steady_round_s": _spread([r["wall_s"] for r in grad[1:]]),
                "forced_drains": sum(1 for e in lane if e.get("name") == "pipeline:drain"
                                     and e.get("reason") == "forced"),
                "overlap_s": sum(e.get("secs", 0.0) for e in lane
                                 if e.get("name") == "pipeline:reduce_concurrent")}

    drained = run("drained", {"run_ahead": 1}, True)
    d0 = run("d0", {}, False)
    pipelined = run("pipelined", {"run_ahead": 1}, False)
    faults = []
    if (drained["d"], d0["d"], pipelined["d"]) != (1, 0, 1):
        faults.append(f"depths {drained['d']}, {d0['d']}, {pipelined['d']}")
    if not drained["forced_drains"]:
        faults.append("the forced run never drained")
    same = len(drained["avg"]) == len(d0["avg"]) > 0 and all(
        torch.equal(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
        for a, b in zip(drained["avg"], d0["avg"]))
    if not same:
        faults.append("the drained d=1 run's final avg_grads differ from d=0's")
    if drained["cursors"] != d0["cursors"] or drained["logs"] != d0["logs"]:
        faults.append(f"cursors {drained['cursors']} / {d0['cursors']}, or logs, differ")
    if drained["grad_rounds"] != 6 or d0["grad_rounds"] != 6:
        faults.append(f"gradient rounds {drained['grad_rounds']}, {d0['grad_rounds']}")
    if pipelined["overlap_s"] <= 0:
        faults.append("the pipelined run overlapped no reduce")
    if faults:
        raise AssertionError("path 9 (13b):\n  " + "\n  ".join(faults))
    for r in (drained, d0, pipelined):
        r.pop("avg")
    return {"drained": drained, "d0": d0, "pipelined": pipelined}


def log_membership_path(path, drain, smi):
    """Phase 13's lines."""
    log(f"[13 main path 9: sequence, membership + run-ahead + tree fan-in] 13a: "
        f"{path['rounds']} rounds to SUCCESS in {path['wall_s']:.3f} s; membership "
        f"{[m[:2] + (m[3],) for m in path['membership']]}; launches {path['launches']}, K1 "
        f"{path['k1_launches']} | {smi}")
    log("  round seconds (events): " + " ".join(
        f"r{r['round']}:{r['wall_s']:.3f}" + (f"({'; '.join(r['events'])})" if r["events"] else "")
        for r in path["round_detail"]))
    log(f"  roster epochs by round: {path['roster_epochs']}")
    log(f"  joins (admitted round -> first contribution): "
        + " ".join(f"{j['site']}:{j['admitted_round']}->{j['first_round']}" for j in path["joins"]))
    log("  warm starts (joiner, broadcast round, donor; loaded state = donor's, state after "
        "the first update = the peers'): " + " ".join(
            f"{w['site']}@{w['input_round']}<-{w['donor']}:{w['warm_equals_donor']}/"
            f"{w['after_equals_peers']}{w['peers']}" for w in path["warm_starts"]))
    log(f"  pipeline: reduce_concurrent {path['reduce_concurrent']} records, "
        f"{path['overlap_s']:.4f} s overlapped; run-ahead submissions "
        f"{path['run_ahead_submissions']}; stalls {path['stalls']}; membership drains in rounds "
        f"{path['drains']}")
    log("  tree mean vs flat guarded mean (sites, fan-in, max |d|, max |mean|, outside "
        f"rtol/atol {MEM_TREE_TOL}): " + " ".join(
            f"{t['sites']}/{t['fanin']}:{t['max_abs_err']:.3e},{t['max_abs']:.3e},{t['outside']}"
            for t in path["tree_checks"]))
    log("  worker starts (target/generation/round: s): " + " ".join(
        f"{t}/{g}/r{r}:{w:.3f}" for t, g, r, w in path["worker_starts"]))
    log("  launches per worker (target/pid: K2/K3/K4, K1, invocations): " + " ".join(
        f"{w['target']}/{w['pid']}:{'/'.join(map(str, w['launches']))},{w['k1']},"
        f"{w['invocations']}" for w in path["per_worker"]))
    log("  first launches held in each worker (K1 bit-equal; K2 out, K3 dq, K4 dk/dv: max |d| / "
        f"max |plain|, tolerance {FLASH_BF16_MATCHED_RTOL} x max + {FLASH_ATOL}): " + " ".join(
            f"{w['target']}/{w['pid']}:K1={w['held'].get('k1')}"
            + "".join(f",{e:.2e}/{m:.2e}" for e, m in w["held"].get("fwd", []) + w["held"].get("bwd", []))
            for w in path["per_worker"]))
    log(f"  compute processes nvidia-smi lists: before {len(path['card_compute_pids']['before'])}, "
        f"at round 6 {len(path['card_compute_pids'].get('workers_up', []))}, after close "
        f"{len(path['card_compute_pids']['after_close'])}; global test metrics "
        f"{path['global_test_metrics']}")
    log(f"  13b: d=1 drained == d=0 bit for bit (final avg_grads, cursors, logs); gradient "
        f"rounds {drain['drained']['grad_rounds']}/{drain['d0']['grad_rounds']}/"
        f"{drain['pipelined']['grad_rounds']}; forced drains {drain['drained']['forced_drains']}; "
        f"pipelined overlap {drain['pipelined']['overlap_s']:.4f} s | {smi}")
    for tag in ("drained", "d0", "pipelined"):
        log(f"  13b {tag} round seconds: " + " ".join(
            f"r{r['round']}:{r['wall_s']:.3f}{'*' if r['grad'] else ''}"
            for r in drain[tag]["rounds"]))
    a, b = drain["d0"]["steady_round_s"], drain["pipelined"]["steady_round_s"]
    log(f"  13b steady gradient rounds (after the first): d=0 median {a['median']:.4f} "
        f"({a['min']:.4f}-{a['max']:.4f}, n {a['n']}) | d=1 pipelined median "
        f"{b['median']:.4f} ({b['min']:.4f}-{b['max']:.4f}, n {b['n']})")


# path 10: the health layer at path 2's width on 3 sites through the tree
HEALTH_SITES = 3
HEALTH_FILES = 80  # 60 training sequences a site: 4 gradient rounds in the epoch
HEALTH_NAN_SITE = "site_2"
HEALTH_NAN_CURSOR = 1  # site_2's second gradient round, R, is NaN
# the divergence floor below the watchdog's default 0: a first round's
# gradients of freshly initialised replicas can sit near orthogonal to the
# mean (a CPU rehearsal at d_model 32 saw -0.0067), and a quarantine must
# come from the NaN round alone here
HEALTH_NODE_ARGS = dict(precision_bits=8, reduce_fanin=2, profile=True,
                        quarantine_on_anomaly=True, capture_on_anomaly=True,
                        watchdog_cosine_floor=-0.5)
HEALTH_MEMORY_SERIES = ("hbm_in_use_bytes", "hbm_peak_bytes", "hbm_limit_bytes",
                        "hbm_utilization")
# the port's bfloat16 kernels in a captured trace, by the parts of their
# demangled names: K2 the forward, K3 and K4 the backward template's dq
# (kDq = true) and dk/dv (false) instances
HEALTH_TRACE_KERNELS = {
    "flash_attention_fwd": ("flash_fwd_wgmma_kernel",),
    "flash_attention_dq": ("flash_bwd_wgmma_kernel", "true>"),
    "flash_attention_dkv": ("flash_bwd_wgmma_kernel", "false>"),
}


def nan_seq_dataset():
    """Path 2's synthetic sequences, but a site whose cache names
    ``nan_at_cursor`` gets NaN inputs for that one batch of the first epoch:
    one gradient round of NaN gradients, finite before and after (the
    batch index is the site's cursor when the loader fetches it)."""
    import numpy as np

    from coinstac_dinunet_tpu_torch.models import SyntheticSeqDataset

    class NaNSeqDataset(SyntheticSeqDataset):
        def __getitem__(self, ix):
            item = super().__getitem__(ix)
            at = self.cache.get("nan_at_cursor")
            if (at is not None and self.mode == "train" and int(self.cache.get("epoch", 0)) == 0
                    and int(self.cache.get("cursor", 0)) == int(at)):
                item = dict(item, inputs=np.full_like(item["inputs"], np.nan))
            return item

    return NaNSeqDataset


def trace_kernels(path):
    """The port's flash kernels a captured Chrome trace names: ``{K2/K3/K4
    name: [kernel names]}`` over its device-kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = sorted({e.get("name", "") for e in events if e.get("cat") == "kernel"})
    return {k: [n for n in names if all(p in n for p in parts)]
            for k, parts in HEALTH_TRACE_KERNELS.items()}


def run_health_path(dev, workdir):
    """Path 10a (phase 14): path 2's model at full width on 3 sites through
    ``InProcessEngine`` with the int8 wire (K1), the tree fan-in (k 2) and
    its health pass, ``profile``, ``quarantine_on_anomaly`` and
    ``capture_on_anomaly``; site_2's batch of one gradient round R is NaN.
    Checks (a)-(g): K1-K4 launched; ``anomaly:nonfinite`` for site_2 at R
    and a ``reduce:nonfinite_skip`` naming it; site_2 quarantined, weight 0
    after R (survivors 2) and the broadcast read by site_2; site
    agreement at every tree reduce; site_2's round R + 1 captured by
    ``torch.profiler`` with K2-K4's device kernels in its trace; the health
    and perf series, the memory limit the card's total; SUCCESS."""
    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SeqTrainer
    from coinstac_dinunet_tpu_torch.ops import quantize as q
    from coinstac_dinunet_tpu_torch.utils import profiling

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    torch.cuda.empty_cache()
    eng = InProcessEngine(
        workdir, n_sites=HEALTH_SITES, trainer_cls=SeqTrainer, dataset_cls=nan_seq_dataset(),
        device=dev, task_id=SEQ_TASK, **{**seq_node_args(), **HEALTH_NODE_ARGS},
        site_args={HEALTH_NAN_SITE: {"nan_at_cursor": HEALTH_NAN_CURSOR}},
    )
    make_seq_files(eng, HEALTH_FILES)
    names = list(FLASH_SOURCES)
    for kern in fa.KERNELS:
        kern.launches = 0
    q.KERNEL.launches = 0
    rounds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        tr = time.perf_counter()
        site_outs, _ = eng.step_round()
        torch.cuda.synchronize()
        rounds.append({"round": eng.rounds, "wall_s": time.perf_counter() - tr,
                       "grad": all(o.get("reduce") for o in site_outs.values()),
                       "site_2_input_health": (eng.site_inputs.get(HEALTH_NAN_SITE) or {}).get(
                           "health")})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(names, (kern.launches for kern in fa.KERNELS)))
    k1 = q.KERNEL.launches
    mem_total = torch.cuda.mem_get_info(dev)[1]

    faults = []
    # (g) SUCCESS, finite outputs
    if not eng.success:
        raise AssertionError(f"path 10a: no SUCCESS after {eng.rounds} rounds")
    metrics = check_outputs(eng, workdir)
    remote = _read_jsonl(os.path.join(workdir, "remote_out", "telemetry.remote.jsonl"))
    sites = {s: _read_jsonl(os.path.join(eng.site_states[s]["outputDirectory"],
                                         f"telemetry.{s}.jsonl")) for s in eng.site_ids}
    # (a) K1-K4 on the path
    if min(launches.values()) == 0 or k1 == 0:
        faults.append(f"launches K2-K4 {launches}, K1 {k1}")
    # (b) the anomaly at R, attributed, and the skip naming site_2
    anomalies = [(e["name"], e.get("site"), e["round"]) for e in remote
                 if e.get("cat") == "anomaly"]
    nonfinite = [r for n, site, r in anomalies
                 if n == "anomaly:nonfinite" and site == HEALTH_NAN_SITE]
    R = nonfinite[0] if nonfinite else None
    skips = [(e["round"], e["sites"]) for e in remote if e.get("name") == "reduce:nonfinite_skip"]
    if R is None or skips != [(R, [HEALTH_NAN_SITE])]:
        faults.append(f"anomalies {anomalies}, nonfinite skips {skips}")
    grad_rounds = [r["round"] for r in rounds if r["grad"]]
    if R is not None and R != grad_rounds[HEALTH_NAN_CURSOR]:
        faults.append(f"R = round {R}, site_2's NaN batch in round {grad_rounds[HEALTH_NAN_CURSOR]}")
    # (c) the quarantine: site_2 weight 0 from then on, the broadcast read
    if eng.remote_cache.get("quarantined_sites") != [HEALTH_NAN_SITE]:
        faults.append(f"quarantined_sites {eng.remote_cache.get('quarantined_sites')}")
    quarantine = [(e["site"], e["round"]) for e in remote if e.get("name") == "quarantine"]
    if quarantine != [(HEALTH_NAN_SITE, R)]:
        faults.append(f"quarantine events {quarantine}")
    survivors = {e["round"]: e["value"] for e in remote if e.get("name") == "survivors"}
    after = {r: v for r, v in survivors.items() if R is not None and r >= R}
    if not after or set(after.values()) != {2.0} or len(after) < 2:
        faults.append(f"survivors by round {survivors}")
    read = [r["round"] for r in rounds if R is not None and r["round"] >= R
            and HEALTH_NAN_SITE in ((r["site_2_input_health"] or {}).get("quarantined") or [])]
    if R is None or R not in read:
        faults.append(f"site_2's inputs carried health.quarantined in rounds {read}")
    # (d) site agreement at every tree reduce
    trees = sorted(e["round"] for e in remote if e.get("name") == "reduce:tree")
    cos = {}
    for e in remote:
        if e.get("name") == "site_cosine":
            cos.setdefault(e["round"], []).append(e["site"])
    disp = sorted(e["round"] for e in remote if e.get("name") == "site_dispersion")
    if not trees or trees != grad_rounds or disp != trees or any(
            sorted(cos.get(r, [])) != eng.site_ids for r in trees):
        faults.append(f"tree reduces {trees}, gradient rounds {grad_rounds}, dispersion "
                      f"{disp}, cosines {cos}")
    # (e) the round after R on site_2 captured, K2-K4 in its trace
    site2 = sites[HEALTH_NAN_SITE]
    caps = [e for e in site2 if e.get("name") == "capture:profile"]
    traced = {}
    if R is None or [e["round"] for e in caps] != [R + 1]:
        faults.append(f"site_2 captures {[(e['round'], e.get('path')) for e in caps]}, "
                      f"failures {[e for e in site2 if e.get('name') == 'capture:failed']}")
    else:
        trace = os.path.join(caps[0]["path"], profiling.TRACE_FILE)
        if not caps[0]["path"].startswith(eng.site_states[HEALTH_NAN_SITE]["outputDirectory"]) \
                or not os.path.exists(trace):
            faults.append(f"no trace at {trace}")
        else:
            traced = trace_kernels(trace)
            traced["trace_bytes"] = os.path.getsize(trace)
            if not all(traced[k] for k in HEALTH_TRACE_KERNELS):
                faults.append(f"the captured trace names {traced}")
    # (f) the series
    series = {}
    for lane in (remote, *sites.values()):
        for e in lane:
            if e.get("kind") == "metric":
                series.setdefault(e["name"], []).append(e)
    for name in ("grad_norm", "update_norm", "val_score", "samples_per_sec",
                 *HEALTH_MEMORY_SERIES):
        if not series.get(name):
            faults.append(f"no {name} series")
    limits = {e["value"] for e in series.get("hbm_limit_bytes", [])}
    if limits != {float(mem_total)}:
        faults.append(f"hbm_limit_bytes {limits}, mem_get_info total {mem_total}")
    if faults:
        raise AssertionError("path 10a:\n  " + "\n  ".join(faults))

    steady = [r["wall_s"] for r in rounds if r["grad"] and r["round"] not in
              (grad_rounds[0], R, R + 1)]
    return {
        "rounds": eng.rounds, "grad_rounds": grad_rounds, "R": R, "wall_s": wall,
        "round_s": [r["wall_s"] for r in rounds], "steady_round_s": _spread(steady),
        "launches": launches, "k1_launches": k1, "anomalies": anomalies,
        "survivors": survivors, "quarantine_read_in_rounds": read,
        "captured": {"round": caps[0]["round"], "path": caps[0]["path"], **traced},
        "samples_per_sec": [(e["node"], e["round"], e["value"])
                            for e in series["samples_per_sec"]],
        "hbm": {name: [e["value"] for e in series[name] if e["node"] == "site_0"]
                for name in HEALTH_MEMORY_SERIES},
        "mem_get_info_total": mem_total, "global_test_metrics": metrics,
    }


def run_health_vectorized_path(dev, workdir):
    """Path 10b (phase 14): path 8's 12a configuration (path 2's on 2 sites
    through ``SiteVectorizedEngine``) with ``profile`` and
    ``capture_on_anomaly``: every round's ``rounds_per_sec`` and
    ``sites_per_sec``, the plane's ``fed_step`` samples/s after its first
    step, one memory sample a round (the limit the card's total), no
    anomaly and no capture; SUCCESS."""
    import torch

    from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine
    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    torch.cuda.empty_cache()
    eng = SiteVectorizedEngine(workdir, n_sites=N_SITES, trainer_cls=SeqTrainer,
                               dataset_cls=SyntheticSeqDataset, device=dev, task_id=SEQ_TASK,
                               profile=True, capture_on_anomaly=True, **seq_node_args())
    make_seq_files(eng)
    for kern in fa.KERNELS:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(FLASH_SOURCES, (k.launches for k in fa.KERNELS)))
    mem_total = torch.cuda.mem_get_info(dev)[1]
    if not eng.success:
        raise AssertionError("path 10b: no SUCCESS")
    check_vec_outputs(eng, workdir)
    lane = _read_jsonl(os.path.join(workdir, "telemetry.engine.jsonl"))
    by = {}
    for e in lane:
        if e["kind"] == "metric":
            by.setdefault(e["name"], []).append(e)
    spans = [e for e in lane if e["name"] == "engine:round"]
    fed = [e for e in by.get("samples_per_sec", []) if e.get("fn") == "fed_step"]
    faults = []
    if min(launches.values()) == 0:
        faults.append(f"launches {launches}")
    if not spans or any(len(by.get(n, [])) != len(spans) for n in (
            "rounds_per_sec", "sites_per_sec", *HEALTH_MEMORY_SERIES)):
        faults.append(f"{len(spans)} rounds; series " + ", ".join(
            f"{n} {len(by.get(n, []))}" for n in ("rounds_per_sec", "sites_per_sec",
                                                 *HEALTH_MEMORY_SERIES)))
    if len(fed) != eng.rounds - 1 or not all(e["value"] > 0 for e in fed):
        faults.append(f"{len(fed)} fed_step samples/s over {eng.rounds} rounds")
    if {e["value"] for e in by.get("hbm_limit_bytes", [])} != {float(mem_total)}:
        faults.append(f"hbm_limit_bytes {by.get('hbm_limit_bytes')}, total {mem_total}")
    odd = [e["name"] for e in lane if e.get("cat") in ("anomaly", "capture")]
    if odd:
        faults.append(f"anomaly or capture records {odd}")
    if faults:
        raise AssertionError("path 10b:\n  " + "\n  ".join(faults))
    return {
        "rounds": eng.rounds, "wall_s": wall, "launches": launches,
        "engine_round_s": [e["dur"] for e in spans],
        "steady_round_s": _spread([e["dur"] for e in spans[1:]]),
        "rounds_per_sec": [e["value"] for e in by["rounds_per_sec"]],
        "sites_per_sec": [e["value"] for e in by["sites_per_sec"]],
        "fed_step_samples_per_sec": [e["value"] for e in fed],
        "hbm_in_use_bytes": [e["value"] for e in by["hbm_in_use_bytes"]],
        "hbm_peak_bytes": [e["value"] for e in by["hbm_peak_bytes"]],
        "hbm_utilization": [e["value"] for e in by["hbm_utilization"]],
        "mem_get_info_total": mem_total,
    }


def log_health_paths(path, vec, smi):
    a = path
    log(f"  10a: {a['rounds']} rounds (gradient rounds {a['grad_rounds']}) to SUCCESS in "
        f"{a['wall_s']:.3f} s; R = round {a['R']}; launches {a['launches']}, K1 "
        f"{a['k1_launches']} | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in a["round_s"]))
    st = a["steady_round_s"]
    if st:
        log(f"  steady gradient rounds (not the first, R or R + 1): median {st['median']:.4f} s "
            f"({st['min']:.4f}-{st['max']:.4f}, n {st['n']})")
    log(f"  anomalies on the aggregator's lane: {a['anomalies']}")
    log(f"  survivors by round: {a['survivors']}; site_2 read health.quarantined in rounds "
        f"{a['quarantine_read_in_rounds']}")
    c = a["captured"]
    log(f"  site_2's round {c['round']} captured: {c['path']} ({c.get('trace_bytes')} bytes); "
        + "; ".join(f"{k}: {v[:2]}" for k, v in c.items() if k in HEALTH_TRACE_KERNELS))
    log("  samples_per_sec (node, round, value): " + " ".join(
        f"{n}/{r}/{v:.2f}" for n, r, v in a["samples_per_sec"]))
    log(f"  site_0 memory (bytes): in use {a['hbm']['hbm_in_use_bytes']}, peak "
        f"{a['hbm']['hbm_peak_bytes']}, limit {a['hbm']['hbm_limit_bytes'][:1]} "
        f"(mem_get_info total {a['mem_get_info_total']}), utilization "
        f"{a['hbm']['hbm_utilization']}")
    b = vec
    st = b["steady_round_s"]
    log(f"  10b: {b['rounds']} rounds to SUCCESS in {b['wall_s']:.3f} s; launches "
        f"{b['launches']}; engine:round s {[round(x, 4) for x in b['engine_round_s']]}"
        + (f", steady median {st['median']:.4f} s ({st['min']:.4f}-{st['max']:.4f})" if st else "")
        + f" | {smi}")
    log(f"  rounds_per_sec {[round(x, 3) for x in b['rounds_per_sec']]}, sites_per_sec "
        f"{[round(x, 3) for x in b['sites_per_sec']]}, fed_step samples/s "
        f"{[round(x, 2) for x in b['fed_step_samples_per_sec']]}")
    log(f"  memory (bytes): in use {b['hbm_in_use_bytes']}, peak {b['hbm_peak_bytes']}, "
        f"utilization {b['hbm_utilization']} of {b['mem_get_info_total']}")


# ---- path 12 (phase 16): the FLOP count on the card, and the telemetry
# tools over phase 14's lanes.  12a counts one grads step of path 1's VBM
# and one of path 2's transformer through the trainer (telemetry on, as a
# user runs it) and holds each count to the closed form of models/flops.py,
# the function the CPU tests hold; 12b reads path 10's lanes with the
# port's CLI, doctor, live plane and exporter
FLOP_PEAK_TFLOPS = 989.0  # the table's entry for the H100 SXM, dense bf16
FLOP_LANES = ("site_0", "site_1", "site_2", "remote", "engine")


def run_flop_count_path(dev, workdir):
    """Path 12a (phase 16): a fresh trainer's first ``compute_grads`` runs
    under the FLOP counter (``record_jit_cost``); its count must equal the
    closed form, with K2, K3 and K4 launched during the transformer's
    counted step (the count saw their operators, not plain products); a
    second step gives the ``achieved_tflops``/``mfu`` sample; the lane holds
    one ``jit_cost`` and a ``perf:backend`` naming the card at its peak."""
    import numpy as np

    from coinstac_dinunet_tpu_torch.models import SeqTrainer, VBMTrainer
    from coinstac_dinunet_tpu_torch.models import flops as closed

    rng = np.random.default_rng(7)
    seq = {k: SEQ_ARGS[k] for k in ("d_model", "num_heads", "num_layers", "num_features",
                                    "num_classes", "max_len", "compute_dtype")}
    t, f, b = SEQ_ARGS["seq_len"], SEQ_ARGS["num_features"], SEQ_ARGS["batch_size"]
    cases = {
        "vbm": (VBMTrainer, dict(input_shape=[64, 64, 64], model_width=WIDTH,
                                 compute_dtype="bfloat16"), (VBM_BATCH, 64, 64, 64),
                closed.vbm_grads_flops(VBM_BATCH, (64, 64, 64), WIDTH, 2), 0),
        "seq": (SeqTrainer, seq, (b, t, f),
                closed.seq_grads_flops(b, t, f, seq["d_model"], seq["num_heads"],
                                       seq["num_layers"], seq["num_classes"]),
                closed.seq_attention_flops(b, t, seq["d_model"], seq["num_heads"],
                                           seq["num_layers"])),
    }
    out, faults = {}, []
    for name, (cls, args, shape, want, attention) in cases.items():
        out[name] = count_grads_step(dev, os.path.join(workdir, name), name, cls, args, shape,
                                     want, rng, faults)
        out[name]["attention_flops"] = attention
        out[name]["attention_share"] = attention / want
        if name == "seq" and min(out[name]["launches"].values()) == 0:
            faults.append(f"{name}: K2-K4 launches during the counted step {out[name]['launches']}")
    if faults:
        raise AssertionError("path 12a:\n  " + "\n  ".join(faults))
    return out


def count_grads_step(dev, lane_dir, name, cls, args, shape, want, rng, faults):
    """A fresh ``cls`` trainer's first ``compute_grads`` on one batch of
    ``shape`` with telemetry on (counted: its ``jit_cost`` must be ``want``,
    the closed form) and a second one (the ``achieved_tflops``/``mfu``
    sample); ``faults`` collects what did not hold.  K2-K4 launches during
    the counted step are returned too."""
    import numpy as np
    import torch

    from coinstac_dinunet_tpu_torch import telemetry

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    torch.cuda.empty_cache()
    cache = {**args, "seed": 7, "profile": True}
    trainer = cls(cache=cache, state={"outputDirectory": lane_dir}, device=dev).init_nn()
    host = {"inputs": rng.normal(size=shape).astype(np.float32),
            "labels": rng.integers(0, 2, shape[0]).astype(np.int32),
            "_mask": np.ones(shape[0], np.float32)}
    batches = trainer._stack_batches([host])
    rec = telemetry.Recorder(name, cache=cache, out_dir=lane_dir)
    for kern in fa.KERNELS:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with telemetry.activate(rec):
        trainer.compute_grads(batches)  # the counted step
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(zip(FLASH_SOURCES, (k.launches for k in fa.KERNELS)))
    with telemetry.activate(rec):
        trainer.compute_grads(batches)  # timed: the series' sample
    rec.flush()
    lane = _read_jsonl(rec.path())
    costs = [e for e in lane if e.get("name") == "jit_cost"]
    backend = [e for e in lane if e.get("name") == "perf:backend"]
    series = {e["name"]: e["value"] for e in lane if e.get("kind") == "metric"
              and e["name"] in ("achieved_tflops", "mfu", "samples_per_sec")}
    got = trainer.cache.get("_perf_flops", {}).get("grads")
    if got is None or int(got) != want or [int(e["flops"]) for e in costs] != [want]:
        faults.append(f"{name}: counted {got}, jit_cost {costs}, closed form {want}")
    if [(e.get("device_kind"), e.get("peak_tflops"), e.get("peak_source")) for e in backend] \
            != [(torch.cuda.get_device_name(dev), FLOP_PEAK_TFLOPS, "table")]:
        faults.append(f"{name}: perf:backend {backend}")
    if not 0.0 < series.get("mfu", 0.0) < 1.0:
        faults.append(f"{name}: the second step's series {series}")
    del trainer, batches
    return {"flops": int(got or 0), "closed_form": want, "launches": launches,
            "counted_step_s": counted_s, **series}


def _tool_series(events, name, fn):
    """``{node: [values]}`` of the metric series ``name`` of step ``fn``."""
    by = {}
    for e in events:
        if e.get("kind") == "metric" and e["name"] == name and e.get("fn") == fn:
            by.setdefault(e["node"], []).append(e["value"])
    return by


def run_tools_path(dev, health_wd, vec_wd, workdir):
    """Path 12b (phase 16): path 10's lanes (10a: 3 sites, the NaN round;
    10b: the site-vectorized plane) read with the port's tools.  The CLI as
    ``python -m`` writes the summary and a Chrome trace naming every lane;
    ``doctor`` writes markdown and JSON whose roofline names the card at its
    peak and whose first verdict is site_2's; every site's lane holds
    ``achieved_tflops`` and ``mfu`` for ``grads`` and 10b's for
    ``fed_step``, each ``mfu`` in (0, 1); one ``watch`` snapshot, and
    ``/metrics`` and ``/healthz`` served on 127.0.0.1 and scraped, show
    ``mfu``."""
    import urllib.request

    import torch

    from coinstac_dinunet_tpu_torch.telemetry.__main__ import main as cli
    from coinstac_dinunet_tpu_torch.telemetry.collect import load_events
    from coinstac_dinunet_tpu_torch.telemetry.live import LiveState, Tailer
    from coinstac_dinunet_tpu_torch.telemetry.serve import OpsServer

    kind = torch.cuda.get_device_name(dev)
    faults = []
    paths = {k: os.path.join(workdir, k) for k in ("trace.json", "summary.json", "doctor.json",
                                                   "doctor.md", "vec.json", "board.txt",
                                                   "healthz.json", "metrics.prom")}
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "coinstac_dinunet_tpu_torch.telemetry",
                           health_wd, "--trace", paths["trace.json"], "--summary-json",
                           paths["summary.json"]], capture_output=True, text=True, env=env,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"path 12b: the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(paths["trace.json"]) as f:
        trace = json.load(f)
    named = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    if not set(FLOP_LANES) <= named:
        faults.append(f"the trace's lanes {sorted(named)}")
    rcs = [cli(["doctor", health_wd, "--quiet", "--json", paths["doctor.json"],
                "--markdown", paths["doctor.md"]]),
           cli(["doctor", vec_wd, "--quiet", "--json", paths["vec.json"]]),
           cli(["watch", health_wd, "--quiet", "--serve", "0", "--snapshot", paths["board.txt"],
                "--json", paths["healthz.json"], "--metrics-out", paths["metrics.prom"]])]
    if rcs != [0, 0, 0]:
        faults.append(f"doctor, doctor (10b), watch exit codes {rcs}")
    with open(paths["doctor.json"]) as f:
        report = json.load(f)
    with open(paths["doctor.md"]) as f:
        md = f.read()
    with open(paths["vec.json"]) as f:
        vec_report = json.load(f)
    for tag, rep in (("10a", report), ("10b", vec_report)):
        backend = (rep.get("roofline") or {}).get("backend") or {}
        if (backend.get("device_kind"), backend.get("peak_tflops")) != (kind, FLOP_PEAK_TFLOPS):
            faults.append(f"{tag}: the roofline's backend {backend}")
    if kind not in md or f"{FLOP_PEAK_TFLOPS:g}" not in md:
        faults.append("the markdown's roofline names neither the card nor its peak")
    top = report["verdicts"][0] if report["verdicts"] else {}
    if top.get("severity") != "critical" or HEALTH_NAN_SITE not in top.get("cause", ""):
        faults.append(f"the first verdict {top}")
    events, vec_events = load_events(health_wd), load_events(vec_wd)
    tflops, mfu = (_tool_series(events, n, "grads") for n in ("achieved_tflops", "mfu"))
    grads = {s: (tflops.get(s), mfu.get(s)) for s in ("site_0", "site_1", "site_2")}
    fed = tuple(_tool_series(vec_events, n, "fed_step").get("engine")
                for n in ("achieved_tflops", "mfu"))
    for who, (tflops, mfu) in [*grads.items(), ("10b fed_step", fed)]:
        if not tflops or not mfu or not all(0.0 < m < 1.0 for m in mfu):
            faults.append(f"{who}: achieved_tflops {tflops}, mfu {mfu}")
    with open(paths["metrics.prom"]) as f:
        prom = f.read()
    with open(paths["board.txt"]) as f:
        board = f.read()
    if "coinstac_dinunet_mfu " not in prom or "site_2" not in board:
        faults.append("the watch snapshot's /metrics scrape or board lacks mfu or site_2")
    # the exporter over a live state of the same lanes, scraped over HTTP
    state = LiveState()
    state.ingest(Tailer(health_wd).poll())
    server = OpsServer(state.snapshot, port=0)
    try:
        with urllib.request.urlopen(server.url("/metrics"), timeout=30) as resp:
            scraped = resp.read().decode()
        with urllib.request.urlopen(server.url("/healthz"), timeout=30) as resp:
            healthz = json.loads(resp.read().decode())
    finally:
        server.close()
    if "coinstac_dinunet_mfu " not in scraped or not healthz.get("mfu"):
        faults.append(f"/metrics or /healthz without mfu: healthz {sorted(healthz)}")
    if faults:
        raise AssertionError("path 12b:\n  " + "\n  ".join(faults))
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "doctor_health_path.md"), "w") as f:
        f.write(md)
    steady_grads = [v for s in grads.values() for v in s[0][1:]]
    steady_mfu = [v for s in grads.values() for v in s[1][1:]]
    return {"cli_s": cli_s, "trace_lanes": sorted(named), "trace_events": len(trace["traceEvents"]),
            "roofline": report["roofline"]["backend"], "first_verdict": top["cause"],
            "grads": grads, "fed_step": fed,
            "steady_grads_tflops": _spread(steady_grads), "steady_grads_mfu": _spread(steady_mfu),
            "fed_step_tflops": _spread(fed[0][1:]), "fed_step_mfu": _spread(fed[1][1:]),
            "healthz_mfu": healthz.get("mfu"), "summary_lines": proc.stdout.count("\n")}


def log_flop_tools_paths(count, tools, smi):
    for name, c in count.items():
        log(f"  12a {name}: {c['flops']} FLOP a grads step = the closed form ({c['flops'] / 1e9:.3f} "
            f"GFLOP; attention {c['attention_share']:.4f} of it); K2-K4 launches during the count "
            f"{c['launches']}; counted step {c['counted_step_s']:.3f} s; the next step "
            f"{c.get('achieved_tflops', 0.0):.3f} TFLOP/s, mfu {c.get('mfu', 0.0):.5f}, "
            f"{c.get('samples_per_sec', 0.0):.2f} samples/s | {smi}")
    t = tools
    log(f"  12b: CLI summary + trace in {t['cli_s']:.2f} s ({t['trace_events']} trace events, "
        f"lanes {t['trace_lanes']}); roofline {t['roofline']}; first verdict: {t['first_verdict']}")
    for s, (tflops, mfu) in t["grads"].items():
        log(f"  12b {s} grads achieved_tflops {[round(v, 3) for v in tflops]}, mfu "
            f"{[round(v, 5) for v in mfu]}")
    log(f"  12b 10b fed_step achieved_tflops {[round(v, 3) for v in t['fed_step'][0]]}, mfu "
        f"{[round(v, 5) for v in t['fed_step'][1]]}")
    for key in ("steady_grads_tflops", "steady_grads_mfu", "fed_step_tflops", "fed_step_mfu"):
        st = t[key]
        if st:
            log(f"  12b {key} (after each lane's first sample): median {st['median']:.5f} "
                f"({st['min']:.5f}-{st['max']:.5f}, n {st['n']}) | {smi}")


# ---- path 13 (phase 17): the remaining models.  17a: ResNet-18 at config
# 4's full shape (bench.py resnet18_16site: 64x64x3 images, width 64, batch
# 256, bfloat16, 16 sites), warm-started on every site from a torch
# checkpoint of a ResNet-18 written here in plain torch with torchvision's
# module names, one Adam step taken.  17b: the fused GroupNorm against the
# plain one on one grads step of 17a's model and of path 1's VBM.  17c: the
# two-network scheme at config 5's shape (2 x VBM at 32^3, width 16, batch
# 128), cut to 4 sites of config 5's 32.
RESNET_SITES = 16
RESNET_LEAVES = 62
# 1280 images a site: 1024 training images, four gradient rounds of 256
RESNET_FILES = 1280
RESNET_SPLIT_ROUND = 3  # the second gradient round, split by part (fenced)
RESNET_STEADY_ROUND = 4  # the third, neither fenced nor profiled
RESNET_PROFILED_ROUND = 5  # the last, under torch.profiler
RESNET_ARGS = dict(input_shape=[64, 64, 3], model_width=64, batch_size=256, epochs=1,
                   split_ratio=[0.8, 0.1, 0.1], precision_bits=8, compute_dtype="bfloat16",
                   seed=7, patience=100)
MULTI_SITES = 4
MULTI_LEAVES = 2 * VBM_LEAVES
MULTI_FILES = 320  # 256 training volumes a site: two gradient rounds of 128
MULTI_ARGS = dict(input_shape=[32, 32, 32], model_width=16, batch_size=128, epochs=1,
                  split_ratio=[0.8, 0.1, 0.1], precision_bits=8, compute_dtype="bfloat16",
                  seed=7, patience=100)
# fused against plain GroupNorm under bfloat16 autocast: the fused norm
# returns bfloat16 (as the JAX package's does), the plain one float32, so
# the residual stream and the pooled head run one bfloat16 rounding apart.
# Held against the largest gradient of all leaves: a leaf whose gradient
# is a sum that cancels (the stem's) differs by a fifth of its own largest
# in bfloat16 without any fault, so its own scale is printed, not held
GN_RTOL = 1e-2
GN_TIMED_STEPS = 10


def torchvision_style_resnet18(width=64, num_classes=2):
    """ResNet-18 as a torch user writes it (torchvision's names: ``conv1``,
    ``bn1``, ``layer1.0.conv1`` ... ``downsample``, ``fc``), with GroupNorm
    (``min(8, C)`` groups, eps 1e-6) for BatchNorm: the checkpoint a user of
    the reference framework brings.  Its own names and torch's symmetric
    paddings; only the order of its parameters is the port's."""
    import torch.nn.functional as F
    from torch import nn

    def gn(c):
        return nn.GroupNorm(min(8, c), c, eps=1e-6)

    class BasicBlock(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = gn(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = gn(cout)
            self.downsample = None
            if stride != 1 or cin != cout:
                self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                                gn(cout))

        def forward(self, x):
            y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
            return F.relu(y + (x if self.downsample is None else self.downsample(x)))

    class ResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
            self.bn1 = gn(width)
            cin = width
            for i, c in enumerate((width, 2 * width, 4 * width, 8 * width)):
                setattr(self, f"layer{i + 1}",
                        nn.Sequential(BasicBlock(cin, c, 1 if i == 0 else 2), BasicBlock(c, c, 1)))
                cin = c
            self.fc = nn.Linear(cin, num_classes)

        def forward(self, x):
            x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
            for i in range(4):
                x = getattr(self, f"layer{i + 1}")(x)
            return self.fc(x.mean(dim=(2, 3)))

    return ResNet()


def write_warm_start_file(dev, path):
    """A ``source='coinstac'`` ``weights.tar`` of a torchvision-style
    ResNet-18 after one Adam step on a random batch; returns its parameters
    (on the CPU, in its ``parameters()`` order) and the Adam count."""
    import torch
    import torch.nn.functional as F

    torch.manual_seed(RESNET_ARGS["seed"])
    net = torchvision_style_resnet18(RESNET_ARGS["model_width"]).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    h, w, c = RESNET_ARGS["input_shape"]
    x = torch.randn(8, c, h, w, device=dev)
    F.cross_entropy(net(x), torch.randint(0, 2, (8,), device=dev)).backward()
    opt.step()
    to_cpu = lambda v: v.detach().cpu() if isinstance(v, torch.Tensor) else v  # noqa: E731
    opt_sd = opt.state_dict()
    opt_sd["state"] = {i: {k: to_cpu(v) for k, v in st.items()} for i, st in opt_sd["state"].items()}
    torch.save({"source": "coinstac",
                "models": {"resnet": {k: to_cpu(v) for k, v in net.state_dict().items()}},
                "optimizers": {"resnet": opt_sd}}, path)
    return [to_cpu(p) for p in net.parameters()], 1


def warm_started_resnet_trainer(file_params, records):
    """``ResNetTrainer`` whose sites record what the warm start gave them:
    the weights right after ``pretrained_path``'s load (the JAX package's
    rule: weights only, a fresh optimizer) against the file's, bit for bit;
    then the file loaded again with its Adam state, as a run resumed from
    the reference framework's checkpoint does, and every parameter's Adam
    ``step``."""
    import torch

    from coinstac_dinunet_tpu_torch.interop import creation_order
    from coinstac_dinunet_tpu_torch.models import ResNetTrainer

    class WarmStartedResNet(ResNetTrainer):
        def _init_nn_weights(self):
            super()._init_nn_weights()
            m = self.nn["resnet"]
            self._weights_equal = [torch.equal(m.get_parameter(p).detach().cpu(), t)
                                   for p, t in zip(creation_order(m), file_params)]

        def init_nn(self, init_models=True, init_weights=True, init_optimizer=True):
            super().init_nn(init_models, init_weights, init_optimizer)
            if init_weights and init_optimizer and self.cache.get("pretrained_path"):
                fresh_step = self.step
                self.load_checkpoint(full_path=self.cache["pretrained_path"])
                state = self.optimizer["resnet"].state
                records.append({
                    "site": self.state.get("clientId"), "weights_equal": self._weights_equal,
                    "step_before": fresh_step, "step": self.step, "states": len(state),
                    "adam_steps": sorted({float(st["step"]) for st in state.values()})})
            return self

    return WarmStartedResNet


def _site_params(eng, site):
    ts = eng.site_caches[site].get("_train_state")
    return None if ts is None else {n: [p.detach() for p in m.parameters()]
                                    for n, m in ts.nn.items()}


def _equal_across_sites(eng):
    """Every site's parameters bit-equal to the first site's (None before
    the sites hold models)."""
    import torch

    first = _site_params(eng, eng.site_ids[0])
    if first is None:
        return None
    for s in eng.site_ids[1:]:
        other = _site_params(eng, s)
        if other is None or any(not torch.equal(a, b) for n in first
                                for a, b in zip(first[n], other[n])):
            return False
    return True


def run_federation(eng, sites, leaves, after_round=None, profiled=()):
    """Step ``eng`` to SUCCESS; every gradient round must launch K1 once per
    payload (``sites`` + the aggregator's) over ``leaves`` segments each.
    ``after_round(eng, grad_round)`` runs after every round; the rounds
    numbered in ``profiled`` run under ``torch.profiler``.  Returns the
    round times, the K1 counts, the profiles and the wall time."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q

    q.KERNEL.launches = q.KERNEL.segments = 0
    round_s, per_round, profiles, grad_rounds = [], [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 40:
        before = q.KERNEL.launches, q.KERNEL.segments
        tr = time.perf_counter()
        if eng.rounds + 1 in profiled:
            site_outs, profile = profiled_round(eng)
            profiles.append(profile)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        round_s.append(time.perf_counter() - tr)
        grew = q.KERNEL.launches - before[0], q.KERNEL.segments - before[1]
        per_round.append(grew)
        grad = all(o.get("reduce") for o in site_outs.values())
        if grad:
            grad_rounds += 1
            if grew != (sites + 1, (sites + 1) * leaves):
                raise AssertionError(
                    f"round {eng.rounds}: K1 launched {grew[0]} times over {grew[1]} segments, "
                    f"expected {sites + 1} over {(sites + 1) * leaves}")
        if after_round is not None:
            after_round(eng, grad)
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if grad_rounds == 0:
        raise AssertionError("no gradient round went through K1")
    return {"rounds": eng.rounds, "grad_rounds": grad_rounds, "launches": q.KERNEL.launches,
            "segments": q.KERNEL.segments, "launches_segments_per_round": per_round,
            "round_s": round_s, "profiled_rounds": profiles, "wall_s": wall}


def _provision(eng, n_files, stem):
    for s in eng.site_ids:
        for i in range(n_files):
            open(os.path.join(eng.site_data_dir(s), f"{s}_{stem}_{i:04d}"), "w").close()


class HostSplit:
    """Seconds a round spends in each named part of the sites' and the
    aggregator's work, fenced on the card: the synthetic images
    (``__getitem__``), the batches' cast and copy (``_stack_batches``), the
    gradient step, the optimizer step, writing and reading payloads (K1
    and the files), the aggregator's reduce, the evaluations, building the
    models and writing and reading checkpoints, each
    exclusive of the others it calls (the reduce's payload reads count as
    reads).  While open, it wraps those functions where the port looks
    them up; the wrappers time and fence only while ``armed`` is set, so
    the rounds it is not armed for run as without it.  :meth:`take`
    returns the sums and starts anew."""

    def __init__(self, dataset_cls):
        from coinstac_dinunet_tpu_torch.nn.basetrainer import NNTrainer
        from coinstac_dinunet_tpu_torch.parallel.reducer import COINNReducer
        from coinstac_dinunet_tpu_torch.utils import tensorutils

        self.sums, self.stack, self.armed = {}, [], False
        self.targets = [(dataset_cls, "__getitem__", "images"),
                        (NNTrainer, "_stack_batches", "cast_copy"),
                        (NNTrainer, "compute_grads", "grads_step"),
                        (NNTrainer, "apply_grads", "adam_step"),
                        (NNTrainer, "evaluation", "evaluation"),
                        (NNTrainer, "init_nn", "init_nn"),
                        (NNTrainer, "save_checkpoint", "checkpoint_save"),
                        (NNTrainer, "load_checkpoint", "checkpoint_load"),
                        (tensorutils, "save_wire", "save_payload"),
                        (tensorutils, "load_arrays", "load_payload"),
                        (tensorutils, "load_arrays_many", "load_payload"),
                        (COINNReducer, "reduce", "reduce")]

    def _timed(self, fn, name):
        import threading

        import torch

        def timed(*a, **kw):
            # the fan-in's pool threads run inside a timed read of the main
            # thread's: only the main thread's calls are timed
            if not self.armed or threading.current_thread() is not threading.main_thread():
                return fn(*a, **kw)
            torch.cuda.synchronize()
            self.stack.append([time.perf_counter(), 0.0])
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                t0, inner = self.stack.pop()
                took = time.perf_counter() - t0
                self.sums[name] = self.sums.get(name, 0.0) + took - inner
                if self.stack:
                    self.stack[-1][1] += took
        return timed

    def __enter__(self):
        self.saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in self.targets]
        for obj, attr, name in self.targets:
            setattr(obj, attr, self._timed(getattr(obj, attr), name))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in self.saved:
            setattr(obj, attr, fn)

    def take(self):
        out, self.sums = self.sums, {}
        return out


def run_resnet_path(dev, workdir):
    """Path 13a (phase 17): ResNet-18 at config 4 over 16 sites, every site
    warm-started from the torchvision-style file (weights bit-equal to the
    file's, then its Adam state: every parameter's ``step`` the file's
    count), lockstep dSGD on the int8 wire to SUCCESS, K1 on every
    payload, every site's parameters equal after the run."""
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import SyntheticImageDataset

    os.makedirs(workdir, exist_ok=True)
    weights = os.path.join(workdir, "weights.tar")
    file_params, count = write_warm_start_file(dev, weights)
    records = []
    eng = InProcessEngine(os.path.join(workdir, "run"), n_sites=RESNET_SITES,
                          trainer_cls=warm_started_resnet_trainer(file_params, records),
                          dataset_cls=SyntheticImageDataset, device=dev, data_dir="data",
                          pretrained_path=weights, **RESNET_ARGS)
    _provision(eng, RESNET_FILES, "image")
    host_split = {}

    def after_round(eng, grad):
        if eng.rounds == RESNET_SPLIT_ROUND:
            host_split.update(split.take())
        split.armed = eng.rounds + 1 == RESNET_SPLIT_ROUND

    with HostSplit(SyntheticImageDataset) as split:
        split.armed = RESNET_SPLIT_ROUND == 1
        fed = run_federation(eng, RESNET_SITES, RESNET_LEAVES, after_round=after_round,
                             profiled=(RESNET_PROFILED_ROUND,))
    faults = []
    for n in (RESNET_SPLIT_ROUND, RESNET_PROFILED_ROUND, RESNET_STEADY_ROUND):
        if n > len(fed["round_s"]) or fed["launches_segments_per_round"][n - 1][0] == 0:
            faults.append(f"round {n} is not a gradient round")
    sites = {r["site"] for r in records if str(r["site"]).startswith("site_")}
    if sites != set(eng.site_ids):
        faults.append(f"warm-started sites {sorted(sites)}")
    for r in records:
        if not (all(r["weights_equal"]) and len(r["weights_equal"]) == RESNET_LEAVES):
            faults.append(f"{r['site']}: weights after pretrained_path not the file's "
                          f"({sum(r['weights_equal'])}/{len(r['weights_equal'])} leaves)")
        if (r["step_before"], r["step"], r["states"], r["adam_steps"]) != \
                (0, count, RESNET_LEAVES, [float(count)]):
            faults.append(f"{r['site']}: Adam after the load {r}")
    if not _equal_across_sites(eng):
        faults.append("the sites' parameters differ after the run")
    if faults:
        raise AssertionError("path 13a:\n  " + "\n  ".join(faults))
    run_dir = os.path.join(workdir, "run")
    metrics = check_outputs(eng, run_dir)
    grads_bytes = [os.path.getsize(os.path.join(run_dir, "remote_base", s, "grads.npy"))
                   for s in eng.site_ids]
    avg_bytes = os.path.getsize(os.path.join(run_dir, "remote_xfer", "avg_grads.npy"))
    samples = fed["grad_rounds"] * RESNET_SITES * RESNET_ARGS["batch_size"]
    steady_s = fed["round_s"][RESNET_STEADY_ROUND - 1]
    return {**fed, "samples_per_s": samples / fed["wall_s"], "warm_started_sites": len(sites),
            "host_split": host_split, "steady_round_s": steady_s,
            "steady_samples_per_s": RESNET_SITES * RESNET_ARGS["batch_size"] / steady_s,
            "adam_count": count, "global_test_metrics": metrics,
            "wire_bytes": {"site_to_aggregator": grads_bytes, "aggregator_to_site": avg_bytes,
                           "float32_values": 4 * sum(p.numel() for p in file_params)}}


def grads_fused_vs_plain(dev, cls, args, shape):
    """One ``grads`` step of ``cls`` from the same seeded weights and batch
    with ``fused_groupnorm`` off and on: the gradients' largest difference
    against the plain step's largest gradient, of all leaves and of each
    leaf, the fused norm's calls in each (0 with it off), and the median
    step time of a few more."""
    import numpy as np
    import torch

    from coinstac_dinunet_tpu_torch.ops import groupnorm

    rng = np.random.default_rng(11)
    host = {"inputs": rng.normal(size=shape).astype(np.float32),
            "labels": rng.integers(0, 2, shape[0]).astype(np.int32),
            "_mask": np.ones(shape[0], np.float32)}
    calls = [0]
    fused_fn = groupnorm.group_norm

    def counted(*a, **kw):
        calls[0] += 1
        return fused_fn(*a, **kw)

    grads, out = {}, {}
    groupnorm.group_norm = counted
    try:
        for fused in (False, True):
            torch.cuda.empty_cache()
            calls[0] = 0
            trainer = cls(cache={**args, "seed": 7, "fused_groupnorm": fused},
                          device=dev).init_nn()
            batches = trainer._stack_batches([host])
            g, _ = trainer.compute_grads(batches)
            grads[fused] = [t.detach().float().clone() for m in g.values() for t in m.values()]
            n_calls, times = calls[0], []
            for _ in range(GN_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.compute_grads(batches)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out["fused" if fused else "plain"] = {"gn_calls": n_calls,
                                                  "step_ms": 1e3 * float(np.median(times))}
            del trainer, batches, g
    finally:
        groupnorm.group_norm = fused_fn
    errs = [float((a - b).abs().max()) for a, b in zip(grads[True], grads[False])]
    scales = [float(b.abs().max()) for b in grads[False]]
    err, scale = max(errs), max(scales)
    leaf_rel = [e / max(s, 1e-30) for e, s in zip(errs, scales)]
    worst = max(range(len(leaf_rel)), key=leaf_rel.__getitem__)
    out.update(max_abs_err=err, max_abs_grad=scale, relative=err / scale,
               worst_leaf=worst, worst_leaf_relative=leaf_rel[worst],
               worst_leaf_max_abs_grad=scales[worst], leaf_relative=leaf_rel)
    if out["plain"]["gn_calls"] != 0 or out["fused"]["gn_calls"] == 0:
        raise AssertionError(f"path 13b {cls.__name__}: fused GroupNorm calls {out}")
    if not err <= GN_RTOL * scale:
        raise AssertionError(f"path 13b {cls.__name__}: fused and plain gradients differ by "
                             f"{err} > {GN_RTOL} x {scale}")
    return out


def run_fused_groupnorm_path(dev):
    """Path 13b (phase 17): 17a's ResNet-18 (batch 256) and path 1's VBM
    (width 16, 64^3, batch 16), one grads step each with the fused
    GroupNorm and with the plain one."""
    from coinstac_dinunet_tpu_torch.models import ResNetTrainer, VBMTrainer

    resnet = {k: RESNET_ARGS[k] for k in ("input_shape", "model_width", "compute_dtype")}
    vbm = dict(input_shape=[64, 64, 64], model_width=WIDTH, compute_dtype="bfloat16")
    return {
        "resnet": grads_fused_vs_plain(dev, ResNetTrainer, resnet,
                                       (RESNET_ARGS["batch_size"], *RESNET_ARGS["input_shape"])),
        "vbm": grads_fused_vs_plain(dev, VBMTrainer, vbm, (VBM_BATCH, 64, 64, 64)),
    }


def run_multinet_path(dev, workdir):
    """Path 13c (phase 17): two VBM nets at config 5's width on 4 sites,
    dSGD on the int8 wire to SUCCESS: one payload of both nets' 46 leaves
    through K1 a site, every site's parameters equal to the others' after
    every round, and from the round that applies the first mean gradient on
    each leaf of both nets changed from the seeded start."""
    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import MultiNetTrainer, SyntheticVBMDataset

    start = MultiNetTrainer(cache={**MULTI_ARGS}, device=dev).init_nn()
    initial = {n: [p.detach().clone() for p in m.parameters()] for n, m in start.nn.items()}
    del start
    eng = InProcessEngine(workdir, n_sites=MULTI_SITES, trainer_cls=MultiNetTrainer,
                          dataset_cls=SyntheticVBMDataset, device=dev, data_dir="data",
                          **MULTI_ARGS)
    _provision(eng, MULTI_FILES, "subject")
    faults, seen = [], {"equal_rounds": 0, "changed_checks": 0, "shipped": False}

    def after_round(eng, grad):
        equal = _equal_across_sites(eng)
        if equal is None:
            return
        if not equal:
            faults.append(f"round {eng.rounds}: the sites' parameters differ")
        seen["equal_rounds"] += 1
        # a gradient round ships the gradients; the sites apply the mean
        # when the next round brings it
        if seen["shipped"]:
            for s in eng.site_ids:
                for n, params in _site_params(eng, s).items():
                    same = sum(torch.equal(a, b) for a, b in zip(params, initial[n]))
                    if same:
                        faults.append(f"round {eng.rounds}: {s} {n}: {same} leaves unchanged")
            seen["changed_checks"] += 1
        seen["shipped"] = seen["shipped"] or grad

    fed = run_federation(eng, MULTI_SITES, MULTI_LEAVES, after_round)
    if faults:
        raise AssertionError("path 13c:\n  " + "\n  ".join(faults[:20]))
    metrics = check_outputs(eng, workdir)
    samples = fed["grad_rounds"] * MULTI_SITES * MULTI_ARGS["batch_size"]
    return {**fed, **seen, "samples_per_s": samples / fed["wall_s"],
            "global_test_metrics": metrics,
            "wire_bytes": wire_sizes(eng, workdir, ["grads.npy"], ["avg_grads.npy"])}


def run_remaining_models_path(dev, workdir):
    """Path 13 (phase 17): 13a, 13b, 13c and 17a's counted grads step."""
    import numpy as np

    from coinstac_dinunet_tpu_torch.models import ResNetTrainer
    from coinstac_dinunet_tpu_torch.models import flops as closed

    t0 = time.perf_counter()
    out = {"resnet": run_resnet_path(dev, os.path.join(workdir, "resnet"))}
    out["resnet_s"] = time.perf_counter() - t0
    faults = []
    shape = (RESNET_ARGS["batch_size"], *RESNET_ARGS["input_shape"])
    args = {k: RESNET_ARGS[k] for k in ("input_shape", "model_width", "compute_dtype")}
    out["resnet_count"] = count_grads_step(
        dev, os.path.join(workdir, "count"), "resnet", ResNetTrainer, args, shape,
        closed.resnet18_grads_flops(shape[0], RESNET_ARGS["input_shape"],
                                    RESNET_ARGS["model_width"]),
        np.random.default_rng(7), faults)
    if faults:
        raise AssertionError("path 13a count:\n  " + "\n  ".join(faults))
    t1 = time.perf_counter()
    out["fused_groupnorm"] = run_fused_groupnorm_path(dev)
    out["fused_groupnorm_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    out["multinet"] = run_multinet_path(dev, os.path.join(workdir, "multinet"))
    out["multinet_s"] = time.perf_counter() - t2
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_remaining_models_path(path, smi):
    r = path["resnet"]
    log(f"  17a ResNet-18, config 4: {RESNET_SITES} sites warm-started from a torchvision-style "
        f"weights.tar (weights bit-equal, Adam step {r['adam_count']} on all "
        f"{RESNET_LEAVES} parameters); {r['rounds']} rounds ({r['grad_rounds']} with gradients) "
        f"to SUCCESS in {r['wall_s']:.3f} s, {r['samples_per_s']:.1f} samples/s, K1 launches "
        f"{r['launches']} over {r['segments']} segments | {smi}")
    log("  17a round seconds: " + " ".join(f"{t:.3f}" for t in r["round_s"]))
    log(f"  17a steady round {RESNET_STEADY_ROUND} (unfenced, unprofiled) "
        f"{r['steady_round_s']:.3f} s, {r['steady_samples_per_s']:.1f} samples/s | {smi}")
    sp, t = r["host_split"], r["round_s"][RESNET_SPLIT_ROUND - 1]
    log(f"  17a round {RESNET_SPLIT_ROUND} split (fenced) {t:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(sp.items()))
        + f", the rest {t - sum(sp.values()):.3f}")
    log_profiles(r["profiled_rounds"])
    log("  17a K1 launches/segments per round: " + " ".join(
        f"{n}/{m}" for n, m in r["launches_segments_per_round"]))
    wb = r["wire_bytes"]
    log(f"  17a wire bytes per gradient round: site->aggregator {wb['site_to_aggregator'][0]} "
        f"(x{len(wb['site_to_aggregator'])}), aggregator->each site {wb['aggregator_to_site']} "
        f"(float32 values alone: {wb['float32_values']})")
    c = path["resnet_count"]
    log(f"  17a counted grads step (batch {RESNET_ARGS['batch_size']}): {c['flops']} FLOP = the "
        f"closed form ({c['flops'] / 1e9:.3f} GFLOP); counted step {c['counted_step_s']:.3f} s; "
        f"the next step {c.get('achieved_tflops', 0.0):.3f} TFLOP/s, mfu {c.get('mfu', 0.0):.5f}, "
        f"{c.get('samples_per_sec', 0.0):.1f} samples/s | {smi}")
    for name, g in path["fused_groupnorm"].items():
        log(f"  17b {name}: grads fused vs plain GroupNorm max |d| {g['max_abs_err']:.3e} "
            f"({g['relative']:.3e} of max |g| {g['max_abs_grad']:.3e}; tolerance {GN_RTOL}); "
            f"worst leaf {g['worst_leaf']} {g['worst_leaf_relative']:.3e} of its max |g| "
            f"{g['worst_leaf_max_abs_grad']:.3e}; "
            f"step {g['plain']['step_ms']:.3f} ms plain, {g['fused']['step_ms']:.3f} ms fused "
            f"({g['fused']['gn_calls']} fused calls) | {smi}")
    m = path["multinet"]
    log(f"  17c two VBM nets, config 5 at {MULTI_SITES} sites: {m['rounds']} rounds "
        f"({m['grad_rounds']} with gradients) to SUCCESS in {m['wall_s']:.3f} s, "
        f"{m['samples_per_s']:.1f} samples/s; sites equal after {m['equal_rounds']} rounds, both "
        f"nets changed on every site in {m['changed_checks']}; K1 launches {m['launches']} over "
        f"{m['segments']} segments | {smi}")
    log("  17c round seconds: " + " ".join(f"{t:.3f}" for t in m["round_s"]))
    log(f"  17c wire bytes per gradient round: site->aggregator "
        f"{m['wire_bytes']['site_to_aggregator']}, aggregator->each site "
        f"{m['wire_bytes']['aggregator_to_site']}")
    log(f"  phase 17: 17a {path['resnet_s']:.1f} s, 17b {path['fused_groupnorm_s']:.1f} s, "
        f"17c {path['multinet_s']:.1f} s, all {path['wall_s']:.1f} s")


# ---- path 11 (phase 15): the other metrics and data.  The VBM gray-matter
# maps as a deployment holds them: one NIfTI file per subject on SPM's
# standard-space grid (MNI 2 mm, 91 x 109 x 91), which NiftiVBMDataset
# center-crops to the model's 64^3 on every axis; half float32 .nii.gz,
# half int16 .nii whose header scales them (scl_slope != 1, patched at
# byte 112 as tests/test_nifti.py does); a class offset on the mean of a
# central region (a whole-volume offset would not survive the per-subject
# z-score); one unlabelled stray file a site
NIFTI_TASK = "vbm_nifti"
NIFTI_GRID = (91, 109, 91)
NIFTI_SUBJECTS = 64
NIFTI_CLASSES = 3
NIFTI_REGION = 24  # the edge of the central cube that carries the class offset
NIFTI_CLASS_OFFSET = 0.5
NIFTI_INT16_SCALING = (2.5e-4, 0.5)  # scl_slope, scl_inter
NIFTI_PREFETCH_TURNS = 3
NIFTI_AUC_ATOL = 1e-4
NIFTI_NODE_ARGS = dict(
    task_id=NIFTI_TASK, data_dir="data", input_shape=[64, 64, 64], model_width=WIDTH,
    batch_size=VBM_BATCH, epochs=1, split_ratio=[0.75, 0.125, 0.125], precision_bits=8,
    compute_dtype="bfloat16", seed=7, patience=100,
)
AUC_NODE_ARGS = dict(monitor_metric="auc", log_header="loss|auc")


def _write_subject(path, vol, int16):
    import struct

    import numpy as np

    from coinstac_dinunet_tpu_torch.data.nifti import save_nifti

    if not int16:
        save_nifti(path, vol)
        return
    slope, inter = NIFTI_INT16_SCALING
    save_nifti(path, np.round((vol - inter) / slope).astype(np.int16))
    with open(path, "r+b") as f:
        f.seek(112)
        f.write(struct.pack("<2f", slope, inter))


def write_nifti_sites(root, sites):
    """Each site's directory under ``root``: ``NIFTI_SUBJECTS`` labelled
    volumes (label ``i % 3``; even ``i`` float32 ``.nii.gz``, odd ``i``
    int16 ``.nii``), one stray ``.nii.gz``, ``labels.csv`` (3 classes) and
    ``labels_binary.csv`` (label >= 1).  Written by 8 threads (zlib
    releases the GIL); returns the seconds and bytes."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    t0 = time.perf_counter()
    jobs = []
    c = [(n - NIFTI_REGION) // 2 for n in NIFTI_GRID]
    region = tuple(slice(a, a + NIFTI_REGION) for a in c)
    for k, s in enumerate(sites):
        d = os.path.join(root, s)
        os.makedirs(d)
        rng = np.random.default_rng(1000 + k)
        rows3, rows2 = [], []
        for i in range(NIFTI_SUBJECTS):
            y = i % NIFTI_CLASSES
            vol = rng.normal(size=NIFTI_GRID).astype(np.float32)
            vol[region] += NIFTI_CLASS_OFFSET * y
            name = f"{s}_sub{i:03d}" + (".nii" if i % 2 else ".nii.gz")
            jobs.append((os.path.join(d, name), vol, bool(i % 2)))
            rows3.append(f"{name},{y}")
            rows2.append(f"{name},{int(y >= 1)}")
        jobs.append((os.path.join(d, "stray_scan.nii.gz"),
                     rng.normal(size=NIFTI_GRID).astype(np.float32), False))
        for fname, rows in (("labels.csv", rows3), ("labels_binary.csv", rows2)):
            with open(os.path.join(d, fname), "w") as f:
                f.write("filename,label\n" + "\n".join(rows) + "\n")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda j: _write_subject(*j), jobs))
    size = sum(os.path.getsize(os.path.join(root, s, f)) for s in sites
               for f in os.listdir(os.path.join(root, s)))
    return time.perf_counter() - t0, size


def make_nifti_engine(dev, workdir, data_root, **args):
    """Path 11's engine over the files under ``data_root`` (linked into
    each site's data directory), not yet run."""
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset, VBMTrainer

    eng = InProcessEngine(workdir, n_sites=N_SITES, trainer_cls=VBMTrainer,
                          dataset_cls=NiftiVBMDataset, device=dev,
                          **{**NIFTI_NODE_ARGS, **args})
    for s in eng.site_ids:
        src = os.path.join(data_root, s)
        for f in os.listdir(src):
            os.symlink(os.path.join(src, f), os.path.join(eng.site_data_dir(s), f))
    return eng


def _weights_leaves(eng, site):
    """The leaves of the wire checkpoint ``site`` advertised (its best
    pretrain weights)."""
    from coinstac_dinunet_tpu_torch.utils import flax_msgpack

    path = os.path.join(eng.site_states[site]["transferDirectory"],
                        eng.site_caches[site]["weights_file"])
    with open(path, "rb") as f:
        return _flat_leaves(flax_msgpack.restore(f.read())["models"])


def run_nifti_engine(eng, profile=False, stop_after_pretrain=False):
    """Step a path-11 engine to SUCCESS: K1 once per payload over all 23
    leaves in every gradient round (path 1's check); the pretrain's
    weights read as soon as the pretrainer advertises them, and every
    site's load of the broadcast checked bit for bit; with ``profile``
    the second gradient round under ``torch.profiler``."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import quantize as q

    q.KERNEL.launches = 0
    q.KERNEL.segments = 0
    grad_rounds, rounds, prof, pretrain = 0, [], None, None
    want = N_SITES + 1, (N_SITES + 1) * VBM_LEAVES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not eng.success and eng.rounds < 60:
        broadcast = eng.site_inputs[eng.site_ids[0]].get("pretrained_weights")
        before = q.KERNEL.launches, q.KERNEL.segments
        profiled = profile and prof is None and grad_rounds == 1
        tr = time.perf_counter()
        if profiled:
            site_outs, p = profiled_round(eng)
        else:
            site_outs, _ = eng.step_round()
            torch.cuda.synchronize()
        dt = time.perf_counter() - tr
        grew = q.KERNEL.launches - before[0], q.KERNEL.segments - before[1]
        grad = all(o.get("reduce") for o in site_outs.values())
        rounds.append({"round": eng.rounds, "s": dt, "gradient": grad, "profiled": profiled,
                       "launches": grew[0], "segments": grew[1]})
        if grad:
            grad_rounds += 1
            if grew != want:
                raise AssertionError(
                    f"round {eng.rounds}: K1 launched {grew[0]} times over {grew[1]} "
                    f"segments, expected {want[0]} launches over {want[1]} segments")
            if profiled:
                prof = p
        if pretrain is None:
            pre = [s for s in eng.site_ids if eng.site_caches[s].get("pretrain")
                   and eng.site_caches[s].get("weights_file")]
            if pre:
                pretrain = {"site": pre[0], "round": eng.rounds,
                            "leaves": _weights_leaves(eng, pre[0])}
                if stop_after_pretrain:
                    break
        if broadcast:
            check_pretrain_load(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not stop_after_pretrain and not eng.success:
        raise AssertionError(f"no SUCCESS after {eng.rounds} rounds")
    if not stop_after_pretrain and (grad_rounds == 0 or q.KERNEL.launches == 0):
        raise AssertionError("the NIfTI path shipped no gradients through K1")
    return {"rounds": rounds, "grad_rounds": grad_rounds, "wall_s": wall,
            "launches": q.KERNEL.launches, "segments": q.KERNEL.segments,
            "profile": prof, "pretrain": pretrain}


def _indexed(eng, site, split=None, **cache):
    """The subjects ``site``'s dataset indexes from its split file (one
    split or all three)."""
    from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset

    with open(os.path.join(eng.site_states[site]["outputDirectory"], NIFTI_TASK, "splits",
                           "SPLIT.json")) as f:
        splits = json.load(f)
    ds = NiftiVBMDataset()
    files = [f for k, v in splits.items() if split in (None, k) for f in v]
    ds.add(files, cache={**NIFTI_NODE_ARGS, **cache}, state=eng.site_states[site])
    return [f for _, f in ds.indices]


def rank_sum_auc(probs, labels):
    """The pairwise (Mann-Whitney) AUC, a tie counting one half."""
    import numpy as np

    probs, labels = np.asarray(probs, np.float64), np.asarray(labels, np.float64)
    pos, neg = probs[labels > 0.5], probs[labels <= 0.5]
    wins = (pos[:, None] > neg[None, :]).sum() + 0.5 * (pos[:, None] == neg[None, :]).sum()
    return float(wins) / (len(pos) * len(neg))


def time_volume_reads(site_dir):
    """Host milliseconds to read one batch of 16 volumes of each file kind:
    the read (and gunzip) alone, and the dataset's whole ``__getitem__``
    (read, parse, scale, crop, z-score).  The files were just written: the
    page cache holds them."""
    from coinstac_dinunet_tpu_torch.data import nifti
    from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset

    ds = NiftiVBMDataset()
    ds.add(sorted(os.listdir(site_dir)), cache={"input_shape": [64, 64, 64], "data_dir": ""},
           state={"baseDirectory": site_dir})
    out = {}
    for kind, ext in (("float32 .nii.gz", ".nii.gz"), ("int16 .nii, scaled", ".nii")):
        ix = [i for i, (_, f) in enumerate(ds.indices) if f.endswith(ext)][:VBM_BATCH]
        for _ in range(2):  # the second pass is the one kept
            t0 = time.perf_counter()
            for i in ix:
                nifti._read_bytes(os.path.join(site_dir, ds.indices[i][1]))
            t1 = time.perf_counter()
            for i in ix:
                ds[i]
            t2 = time.perf_counter()
        out[kind] = {"volumes": len(ix), "read_ms": (t1 - t0) * 1e3,
                     "getitem_ms": (t2 - t1) * 1e3,
                     "parse_crop_zscore_ms": (t2 - t1 - (t1 - t0)) * 1e3}
    return out


def time_pretrain_epochs(dev, workdir, site_dir):
    """The pretrain's epoch alone (``train_local``, one epoch, no
    validation) on one site's files with ``prefetch_batches`` 0 and 2 in
    turns, after one warm-up epoch; a fresh trainer each turn."""
    import torch

    from coinstac_dinunet_tpu_torch.data import COINNDataHandle
    from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset, VBMTrainer

    times = {0: [], 2: []}
    order = [2] + [p for _ in range(NIFTI_PREFETCH_TURNS) for p in (0, 2)]
    for turn, prefetch in enumerate(order):
        root = os.path.join(workdir, f"turn{turn}")
        os.makedirs(os.path.join(root, "xfer"))
        os.symlink(site_dir, os.path.join(root, "data"))
        cache = {**NIFTI_NODE_ARGS, "num_classes": NIFTI_CLASSES, "validation_epochs": 2,
                 "autosave_epochs": 0, "prefetch_batches": prefetch, "verbose": False,
                 "log_dir": os.path.join(root, "logs")}
        state = {"baseDirectory": root, "outputDirectory": os.path.join(root, "out"),
                 "transferDirectory": os.path.join(root, "xfer"), "clientId": "site_0"}
        handle = COINNDataHandle(cache=cache, state=state, dataset_cls=NiftiVBMDataset)
        handle.prepare_data()
        cache["split_ix"] = 0
        trainer = VBMTrainer(cache=cache, state=state, data_handle=handle, device=dev)
        trainer.init_nn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_local()
        torch.cuda.synchronize()
        if turn:
            times[prefetch].append(time.perf_counter() - t0)
    return times


def run_nifti_path(dev, workdir):
    """Path 11 (phase 15): 11a the 3-class NIfTI pipeline with a local
    pretrain (prefetch on, bit-equal to a rerun with it off), 11b the AUC
    over the file wire, 11c the AUC on the vectorized plane against the
    file wire through K2-K4; and the host's costs."""
    import numpy as np
    import torch

    from coinstac_dinunet_tpu_torch.config.keys import Key
    from coinstac_dinunet_tpu_torch.metrics import AUCROCMetrics, ConfusionMatrix

    out = {}
    data = os.path.join(workdir, "nifti")
    sites = [f"site_{i}" for i in range(N_SITES)]
    write_s, write_bytes = write_nifti_sites(data, sites)
    out["data"] = {"write_s": write_s, "bytes": write_bytes, "grid": NIFTI_GRID,
                   "files_per_site": len(os.listdir(os.path.join(data, sites[0])))}
    out["read_batch_ms"] = time_volume_reads(os.path.join(data, sites[0]))
    faults = []

    # ---- 11a: 3 classes, a pretrain with prefetch on; cuDNN's
    # deterministic algorithms, so that the rerun can be held bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eng = make_nifti_engine(dev, os.path.join(workdir, "11a"), data,
                                num_classes=NIFTI_CLASSES, prefetch_batches=2,
                                pretrain_args={"epochs": 1})
        a = run_nifti_engine(eng, profile=True)
        rerun = make_nifti_engine(dev, os.path.join(workdir, "11a_rerun"), data,
                                  num_classes=NIFTI_CLASSES, prefetch_batches=0,
                                  pretrain_args={"epochs": 1})
        r = run_nifti_engine(rerun, stop_after_pretrain=True)
        out["pretrain_epoch_s"] = time_pretrain_epochs(dev, os.path.join(workdir, "turns"),
                                                       os.path.join(data, sites[0]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    metrics = check_outputs(eng, os.path.join(workdir, "11a"))
    if a["pretrain"] is None or r["pretrain"] is None:
        faults.append("11a: no pretrain weights advertised")
    else:
        pa, pr = a["pretrain"]["leaves"], r["pretrain"]["leaves"]
        if [k for k, _ in pa] != [k for k, _ in pr] or not all(
                np.array_equal(x, y) for (_, x), (_, y) in zip(pa, pr)):
            faults.append("11a: the pretrainer's weights with prefetch_batches=2 differ from "
                          "the rerun's with prefetch_batches=0")
    for s in sites:
        indexed = _indexed(eng, s)
        if len(indexed) != NIFTI_SUBJECTS or len(set(indexed)) != NIFTI_SUBJECTS or \
                any("stray" in f for f in indexed):
            faults.append(f"11a: {s} indexed {len(indexed)} files, want its "
                          f"{NIFTI_SUBJECTS} labelled ones")
    rows = {k: eng.remote_cache[k] for k in ("train_log", "validation_log", "test_metrics",
                                             "global_test_metrics")}
    if not all(len(row) == 5 and all(np.isfinite(row)) for v in rows.values() for row in v):
        faults.append(f"11a: log rows are not loss + P, R, F1, accuracy: {rows}")
    matrix = ConfusionMatrix.reduce_sites(
        [p["metrics"] for p in eng.remote_cache[Key.GLOBAL_TEST_SERIALIZABLE.value]]).matrix
    n_test = sum(len(_indexed(eng, s, "test")) for s in sites)
    if matrix.shape != (NIFTI_CLASSES,) * 2 or matrix.sum() != n_test:
        faults.append(f"11a: the reduced test matrix {matrix.tolist()} does not sum to the "
                      f"{n_test} test subjects")
    steady = [x["s"] for x in a["rounds"] if x["gradient"] and not x["profiled"]][1:]
    out["11a"] = {**{k: v for k, v in a.items() if k != "pretrain"},
                  "pretrain_site": a["pretrain"] and a["pretrain"]["site"],
                  "pretrain_round": a["pretrain"] and a["pretrain"]["round"],
                  "pretrain_leaves_held": a["pretrain"] and len(a["pretrain"]["leaves"]),
                  "steady_grad_round_s": steady, "test_matrix": matrix.tolist(),
                  "logs": rows, "global_test_metrics": metrics}

    # ---- 11b: the AUC over the file wire
    eng = make_nifti_engine(dev, os.path.join(workdir, "11b"), data, num_classes=2,
                            labels_file="labels_binary.csv", **AUC_NODE_ARGS)
    b = run_nifti_engine(eng)
    check_outputs(eng, os.path.join(workdir, "11b"))
    pairs = [p["metrics"] for p in eng.remote_cache[Key.GLOBAL_TEST_SERIALIZABLE.value]]
    labels = np.concatenate([np.asarray(m[0]) for m in pairs])
    probs = np.concatenate([np.asarray(m[1]) for m in pairs])
    mine = rank_sum_auc(probs, labels)
    val_auc = [row[-1] for row in eng.remote_cache["validation_log"]]
    test_auc = eng.remote_cache["global_test_metrics"][0][-1]
    if not all(0.0 < v <= 1.0 for v in [*val_auc, test_auc]):
        faults.append(f"11b: AUC outside (0, 1]: validation {val_auc}, test {test_auc}")
    if abs(test_auc - mine) > NIFTI_AUC_ATOL or \
            AUCROCMetrics.reduce_sites(pairs).auc != test_auc:
        faults.append(f"11b: global test AUC {test_auc}, the pairs' rank-sum AUC {mine}")
    out["11b"] = {**{k: v for k, v in b.items() if k != "pretrain"}, "validation_auc": val_auc,
                  "global_test_auc": test_auc, "pairs_auc": mine, "pairs": len(labels)}

    # ---- 11c: the AUC on the vectorized plane against the file wire
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    c = {}
    for dtype in (None, "float32"):
        serial = run_seq_path(dev, os.path.join(workdir, f"11c_serial_{dtype}"),
                              compute_dtype=dtype, extra=AUC_NODE_ARGS)
        vec = run_vec_same_function(dev, os.path.join(workdir, f"11c_vec_{dtype}"), fa,
                                    compute_dtype=dtype, extra=AUC_NODE_ARGS)
        want = {**serial["logs"], "global_test_metrics": serial["global_test_log"]}
        c[dtype or "bfloat16"] = {
            "distance": log_distance(vec["logs"], want), "serial_wall_s": serial["wall_s"],
            "vec_wall_s": vec["wall_s"], "serial_launches": serial["launches"],
            "vec_launches": vec["launches"], "vec_logs": vec["logs"], "serial_logs": want}
        if dtype is None:
            out["11c_launches"] = {k: serial["launches"][k] + vec["launches"][k]
                                   for k in FLASH_SOURCES}
        if min(row[-1] for row in vec["logs"]["train_log"]) <= 0.0:
            faults.append(f"11c ({dtype or 'bfloat16'}): a train-log AUC is not above 0: "
                          f"{vec['logs']['train_log']}")
        if c[dtype or "bfloat16"]["distance"] <= VEC_LOG_ATOL:
            break
    else:
        faults.append(f"11c: logs {c['bfloat16']['distance']:.3e} apart in bfloat16 and "
                      f"{c['float32']['distance']:.3e} in float32, tolerance {VEC_LOG_ATOL}")
    out["11c"] = c
    if faults:
        raise AssertionError("path 11:\n  " + "\n  ".join(faults))
    return out


def log_nifti_path(path, smi):
    d, a, b = path["data"], path["11a"], path["11b"]
    log(f"  data: {2 * NIFTI_SUBJECTS} labelled subjects + {N_SITES} strays on the "
        f"{'x'.join(map(str, d['grid']))} grid, {d['bytes']} bytes written in "
        f"{d['write_s']:.3f} s (apart from the runs)")
    for kind, t in path["read_batch_ms"].items():
        log(f"  host ms to read a batch of {t['volumes']} {kind}: {t['getitem_ms']:.2f} "
            f"(read{' + gunzip' if 'gz' in kind else ''} {t['read_ms']:.2f}, parse + scale + "
            f"crop + z-score {t['parse_crop_zscore_ms']:.2f})")
    pe = path["pretrain_epoch_s"]
    log("  pretrain epoch s, prefetch_batches 0 / 2 in turns: " + ", ".join(
        f"{x:.3f} / {y:.3f}" for x, y in zip(pe[0], pe[2])))
    grads = [x for x in a["rounds"] if x["gradient"]]
    log(f"  11a: {len(a['rounds'])} rounds ({a['grad_rounds']} with gradients) to SUCCESS in "
        f"{a['wall_s']:.3f} s; pretrain on {a['pretrain_site']} in round "
        f"{a['pretrain_round']}, its {a['pretrain_leaves_held']} leaves bit-equal to the "
        f"prefetch_batches=0 rerun; K1 launches {a['launches']} over {a['segments']} "
        f"segments; test matrix {a['test_matrix']} | {smi}")
    log("  11a gradient rounds s: " + " ".join(
        f"{x['s']:.3f}{'(profiled)' if x['profiled'] else ''}" for x in grads)
        + f"; steady {' '.join(f'{t:.4f}' for t in a['steady_grad_round_s'])}")
    if a["profile"]:
        log_profiles([a["profile"]])
    log(f"  11b: AUC over the file wire, {len(b['rounds'])} rounds to SUCCESS in "
        f"{b['wall_s']:.3f} s; validation AUC {b['validation_auc']}, global test AUC "
        f"{b['global_test_auc']} vs {b['pairs_auc']:.6f} from the {b['pairs']} pairs; K1 "
        f"launches {b['launches']} | {smi}")
    for dtype, c in path["11c"].items():
        log(f"  11c ({dtype}): AUC on the vectorized plane {c['vec_wall_s']:.3f} s, file wire "
            f"{c['serial_wall_s']:.3f} s, logs {c['distance']:.3e} apart (tolerance "
            f"{VEC_LOG_ATOL}); launches vectorized {c['vec_launches']}, file wire "
            f"{c['serial_launches']}")



# ---- path 14 (phase 18): the native wire at config 4's payload, the
# background commits on path 1, and the examples' simulations on the card.
NATIVE_PAYLOADS = 17  # path 13a's 16 sites and its aggregator
NATIVE_WIDTH = 64  # ResNet-18 at config 4: 62 leaves, 11.18 M values a payload
NATIVE_TREE_FANIN = 4
# path 13a's fenced split round on the Python wire, as PERF.md §5 records it
# (NVIDIA H100 80GB HBM3, 700 W)
PYTHON_WIRE_SPLIT_S = {"load_payload": 0.803, "save_payload": 0.486}
EXAMPLES = ("fsv_classification", "vbm_classification", "seq_classification")


@contextlib.contextmanager
def python_wire():
    """``COINN_NATIVE=0`` while open: the port's Python writer and readers."""
    old = os.environ.get("COINN_NATIVE")
    os.environ["COINN_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["COINN_NATIVE"]
        else:
            os.environ["COINN_NATIVE"] = old


def resnet_grad_payloads(dev, n, width):
    """``n`` gradient wire lists of ResNet-18 on the card (config 4's model
    at ``width``): its leaves in the wire's order and flax layout, float32
    values from a seeded generator."""
    import torch

    from coinstac_dinunet_tpu_torch.models.resnet import ResNet18
    from coinstac_dinunet_tpu_torch.utils import tensorutils

    model = ResNet18(width=width).to(dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    out = []
    for _ in range(n):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
        out.append(tensorutils.extract_grads({"resnet": model}))
    return out


def _same_arrays(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def run_native_wire_path(dev, workdir):
    """Path 14a: 17 ResNet-18 gradient payloads at config 4, int8 through
    K1 and float32, each packed once and committed by the native
    gather-write and by the Python writer (the files equal byte for byte),
    read back by the native many-file reader, through maps and by the
    Python loop (the arrays equal bit for bit), and reduced by the guarded
    flat and tree (k 4) means with the fan-in's maps on and off (equal bit
    for bit).  Seconds of each way."""
    import shutil
    import types

    import torch

    from coinstac_dinunet_tpu_torch import native
    from coinstac_dinunet_tpu_torch.config.keys import Federation
    from coinstac_dinunet_tpu_torch.ops import quantize as q
    from coinstac_dinunet_tpu_torch.parallel.reducer import COINNReducer
    from coinstac_dinunet_tpu_torch.resilience import transport
    from coinstac_dinunet_tpu_torch.utils import tensorutils

    if not native.available():
        raise AssertionError("path 14a: the native wire runtime is not available")
    n = NATIVE_PAYLOADS
    payloads = resnet_grad_payloads(dev, n, NATIVE_WIDTH)
    out = {"payloads": n, "leaves": len(payloads[0]),
           "values": sum(t.numel() for t in payloads[0]), "codecs": {}}
    faults = []
    q.KERNEL.launches = 0
    for codec in ("int8", "float32"):
        row = out["codecs"][codec] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [tensorutils._pack_parts(p, codec="int8" if codec == "int8" else None,
                                         seed=1000 * i) for i, p in enumerate(payloads)]
        row["pack_ms"] = 1e3 * (time.perf_counter() - t0) / n
        row["payload_bytes"] = len(parts[0][0]) + sum(len(b) for b in parts[0][1])
        dirs = {way: os.path.join(workdir, codec, way) for way in ("native", "python")}
        paths = {way: [os.path.join(d, f"site_{i:02d}", "grads.npy") for i in range(n)]
                 for way, d in dirs.items()}
        for way in ("native", "python"):
            for path in paths[way]:
                os.makedirs(os.path.dirname(path), exist_ok=True)
        # the two writers in turns, each first on every other payload
        write_s = {"native": 0.0, "python": 0.0}
        packs = native.COUNTS["packs"]
        for i, (header, blobs, crc) in enumerate(parts):
            for way in (("native", "python") if i % 2 == 0 else ("python", "native")):
                with python_wire() if way == "python" else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    transport.commit_bytes(paths[way][i], header, blobs, crc=crc)
                    write_s[way] += time.perf_counter() - t0
        for way, secs in write_s.items():
            row[f"write_ms_{way}"] = 1e3 * secs / n
        if native.COUNTS["packs"] - packs != n:
            faults.append(f"{codec}: {native.COUNTS['packs'] - packs} native packs for {n} "
                          "native writes")
        del parts
        for a, b in zip(paths["native"], paths["python"]):
            with open(a, "rb") as fa_, open(b, "rb") as fb_:
                if fa_.read() != fb_.read():
                    faults.append(f"{codec}: {a} differs from the Python writer's file")
        # the reads hit the page cache the writes just filled
        loaded = {}
        for way in ("native", "mmap", "python"):
            many = native.COUNTS["load_many"]
            with python_wire() if way == "python" else contextlib.nullcontext():
                t0 = time.perf_counter()
                loaded[way] = tensorutils.load_arrays_many(paths["native"], mmap=way == "mmap")
                row[f"read_ms_{way}"] = 1e3 * (time.perf_counter() - t0) / n
            if native.COUNTS["load_many"] - many != (way == "native"):
                faults.append(f"{codec} {way}: {native.COUNTS['load_many'] - many} native "
                              "many-file reads")
        for i in range(n):
            if not (_same_arrays(loaded["native"][i], loaded["mmap"][i])
                    and _same_arrays(loaded["native"][i], loaded["python"][i])):
                faults.append(f"{codec}: payload {i} reads differently by way")
            if codec == "float32" and not _same_arrays(
                    loaded["native"][i], [t.cpu().numpy() for t in payloads[i]]):
                faults.append(f"float32: payload {i} is not the gradient written")
        del loaded
        means = {}
        inp = {f"site_{i:02d}": {"grads_file": "grads.npy"} for i in range(n)}
        for fanin in (0, NATIVE_TREE_FANIN):
            for mmap in (True, False):
                red_dir = os.path.join(workdir, codec, f"reduce_{fanin}_{mmap}")
                os.makedirs(red_dir, exist_ok=True)
                red = COINNReducer(trainer=types.SimpleNamespace(
                    device=dev, input=inp,
                    cache={Federation.WIRE_MMAP: mmap, Federation.REDUCE_FANIN: fanin},
                    state={"baseDirectory": dirs["native"], "outputDirectory": red_dir,
                           "transferDirectory": red_dir}))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean = (red._tree_average("grads_file") if fanin
                        else red._average(red._load("grads_file")))
                torch.cuda.synchronize()
                row[f"fan_in_s_{'tree' if fanin else 'flat'}_{'mmap' if mmap else 'heap'}"] = (
                    time.perf_counter() - t0)
                means[fanin, mmap] = mean
            if not all(torch.equal(a, b) for a, b in zip(means[fanin, True],
                                                         means[fanin, False])):
                faults.append(f"{codec}: the {'tree' if fanin else 'flat'} mean with maps "
                              "differs from the heap one")
        row["tree_vs_flat_max_abs"] = max(
            float((a.float() - b.float()).abs().max())
            for a, b in zip(means[NATIVE_TREE_FANIN, True], means[0, True]))
        del means
        shutil.rmtree(os.path.join(workdir, codec), ignore_errors=True)
    out["k1_launches"] = q.KERNEL.launches
    if out["k1_launches"] != n:
        faults.append(f"K1 launched {out['k1_launches']} times for {n} int8 payloads")
    if faults:
        raise AssertionError("path 14a:\n  " + "\n  ".join(faults))
    return out


def run_async_commit_path(dev, workdir, main_path):
    """Path 14b: path 1 with ``async_wire_commit``: the same rounds, logs,
    parameters and payload files (every round's) bit for bit, K1 once a
    payload, every payload committed by the background thread, and no
    commit pending when a node's output leaves it."""
    from coinstac_dinunet_tpu_torch.nodes.local import COINNLocal
    from coinstac_dinunet_tpu_torch.nodes.remote import COINNRemote
    from coinstac_dinunet_tpu_torch.resilience import transport

    committer = transport.async_committer()
    seen = {"outputs": 0, "submitted": 0}
    saved = [(cls, cls.__call__) for cls in (COINNLocal, COINNRemote)]

    def guarded(fn):
        def call(self, *a, **kw):
            result = fn(self, *a, **kw)
            if committer.pending():
                raise AssertionError(f"{committer.pending()} commits pending at a node's output")
            seen["outputs"] += 1
            return result
        return call

    real_submit = committer.submit

    def submit(fn):
        seen["submitted"] += 1
        real_submit(fn)

    committer.submit = submit
    for cls, fn in saved:
        cls.__call__ = guarded(fn)
    try:
        path = run_main_path(dev, workdir, profiled=(), async_wire_commit=True)
    finally:
        for cls, fn in saved:
            cls.__call__ = fn
        del committer.submit
    faults = []
    for key in ("rounds", "launches", "segments", "launches_segments_per_round", "logs",
                "final_params"):
        if path[key] != main_path[key]:
            faults.append(f"{key} differs from path 1's")
    if path["payload_digests"] != main_path["payload_digests"]:
        bad = [r + 1 for r, (a, b) in enumerate(zip(path["payload_digests"],
                                                    main_path["payload_digests"])) if a != b]
        faults.append(f"payload files differ from path 1's in rounds {bad}")
    if seen["submitted"] != path["native_calls"]["packs"] or seen["submitted"] == 0:
        faults.append(f"{seen['submitted']} background commits for "
                      f"{path['native_calls']['packs']} payloads")
    if faults:
        raise AssertionError("path 14b:\n  " + "\n  ".join(faults))
    path.update(outputs_checked=seen["outputs"], background_commits=seen["submitted"])
    return path


def load_script(path):
    """A script of the repository as a module."""
    import importlib.util

    name = "_smoke_" + "_".join(os.path.normpath(path).split(os.sep)[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples_path(dev, workdir):
    """Path 14c: the FSV, VBM and sequence examples' ``run_sim.main`` on the
    card at their ``inputspec.json`` sizes, each to SUCCESS with finite
    global test metrics; the sequence example's attention through K2-K4 at
    head dim 16 in every gradient round; the aggregator's training-curve
    PNGs decoded by Pillow where matplotlib imports."""
    import torch

    from coinstac_dinunet_tpu_torch import InProcessEngine

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    head_dims, per_round = set(), []
    real = {name: getattr(fa, name) for name in ("flash_forward_cuda", "flash_backward_cuda")}

    def recording(fn):
        def call(q, *a, **kw):
            head_dims.add(int(q.shape[-1]))
            return fn(q, *a, **kw)
        return call

    real_step = InProcessEngine.step_round

    def step_round(self, *a, **kw):
        before = [kern.launches for kern in fa.KERNELS]
        result = real_step(self, *a, **kw)
        per_round.append((all(o.get("reduce") for o in result[0].values()),
                          [kern.launches - b for kern, b in zip(fa.KERNELS, before)]))
        return result

    out, faults = {}, []
    for name, fn in real.items():
        setattr(fa, name, recording(fn))
    InProcessEngine.step_round = step_round
    try:
        for ex in EXAMPLES:
            mod = load_script(os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples", ex,
                                           "run_sim.py"))
            head_dims.clear()
            per_round.clear()
            for kern in fa.KERNELS:
                kern.launches = 0
            wd = os.path.join(workdir, ex)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = mod.main(wd, device=dev.type)
            torch.cuda.synchronize()
            row = out[ex] = {"wall_s": time.perf_counter() - t0, "rounds": eng.rounds,
                             "sites": len(eng.site_ids), "args": dict(mod.ARGS)}
            if not eng.success:
                faults.append(f"{ex}: no SUCCESS after {eng.rounds} rounds")
                continue
            row["global_test_metrics"] = check_outputs(eng, wd)
            grads = [grew for reduce, grew in per_round if reduce]
            row["grad_rounds"] = len(grads)
            row["launches"] = dict(zip(FLASH_SOURCES, (kern.launches for kern in fa.KERNELS)))
            if ex == "seq_classification":
                need = len(eng.site_ids) * mod.ARGS["num_layers"]
                if not grads or any(min(g) < need for g in grads):
                    faults.append(f"{ex}: K2/K3/K4 launches per gradient round {grads}, "
                                  f"expected >= {need} each")
                if head_dims != {mod.ARGS["d_model"] // mod.ARGS["num_heads"]}:
                    faults.append(f"{ex}: attention head dims {sorted(head_dims)}")
                row["head_dims"] = sorted(head_dims)
            log_dir = eng.remote_cache["log_dir"]
            pngs = sorted(f for f in os.listdir(log_dir) if f.endswith(".png"))
            row["pngs"] = pngs
            if plots:
                from PIL import Image as PILImage

                if pngs != ["train_log.png", "validation_log.png"]:
                    faults.append(f"{ex}: PNGs {pngs}")
                for f in pngs:
                    with PILImage.open(os.path.join(log_dir, f)) as im:
                        im.load()
                        row.setdefault("png_sizes", {})[f] = list(im.size)
            elif pngs:
                faults.append(f"{ex}: PNGs {pngs} without matplotlib")
    finally:
        for name, fn in real.items():
            setattr(fa, name, fn)
        InProcessEngine.step_round = real_step
    if faults:
        raise AssertionError("path 14c:\n  " + "\n  ".join(faults))
    out["plots"] = "written" if plots else "skipped (matplotlib does not import)"
    return out


def run_native_examples_path(dev, workdir, main_path):
    """Path 14 (phase 18): 14a, 14b and 14c."""
    t0 = time.perf_counter()
    out = {"native": run_native_wire_path(dev, os.path.join(workdir, "native"))}
    out["native_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["async"] = run_async_commit_path(dev, os.path.join(workdir, "async"), main_path)
    out["async_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    out["examples"] = run_examples_path(dev, os.path.join(workdir, "examples"))
    out["examples_s"] = time.perf_counter() - t2
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_native_examples_path(path, models_path, smi):
    a = path["native"]
    log(f"  14a {a['payloads']} ResNet-18 gradient payloads (config 4: {a['leaves']} leaves, "
        f"{a['values']} values): native and Python writes byte-identical, native/mmap/Python "
        f"reads bit-identical, flat and tree (k {NATIVE_TREE_FANIN}) means with and without "
        f"maps bit-identical; K1 launches {a['k1_launches']} | {smi}")
    for codec, r in a["codecs"].items():
        log(f"  14a {codec} ({r['payload_bytes']} B a payload), ms a payload: pack "
            f"{r['pack_ms']:.3f}, write native {r['write_ms_native']:.3f} / Python "
            f"{r['write_ms_python']:.3f}, read native {r['read_ms_native']:.3f} / mmap "
            f"{r['read_ms_mmap']:.3f} / Python {r['read_ms_python']:.3f}; fan-in s: flat "
            f"mmap {r['fan_in_s_flat_mmap']:.3f} / heap {r['fan_in_s_flat_heap']:.3f}, tree "
            f"mmap {r['fan_in_s_tree_mmap']:.3f} / heap {r['fan_in_s_tree_heap']:.3f}; tree vs "
            f"flat max |d| {r['tree_vs_flat_max_abs']:.3e}")
    sp = models_path["resnet"]["host_split"]
    log(f"  14a path 13a's fenced split round {RESNET_SPLIT_ROUND} on the native wire and the "
        f"mapped fan-in: payload reads {sp.get('load_payload', 0.0):.3f} s (on the Python wire: "
        f"{PYTHON_WIRE_SPLIT_S['load_payload']}), payload writes "
        f"{sp.get('save_payload', 0.0):.3f} s (on the Python wire: "
        f"{PYTHON_WIRE_SPLIT_S['save_payload']}) | {smi}")
    b = path["async"]
    log(f"  14b path 1 with async_wire_commit: {b['rounds']} rounds, logs, parameters and every "
        f"round's payload files equal path 1's bit for bit; K1 launches {b['launches']}; "
        f"{b['background_commits']} background commits, none pending at any of "
        f"{b['outputs_checked']} node outputs; {b['wall_s']:.3f} s | {smi}")
    log("  14b round seconds: " + " ".join(f"{t:.3f}" for t in b["round_s"]))
    for ex in EXAMPLES:
        r = path["examples"][ex]
        log(f"  14c {ex}: {r['sites']} sites, {r['rounds']} rounds ({r['grad_rounds']} with "
            f"gradients) to SUCCESS in {r['wall_s']:.3f} s, global test "
            f"{r['global_test_metrics']}; K2/K3/K4 launches "
            f"{list(r['launches'].values())}" + (f" at head dims {r['head_dims']}"
                                                   if "head_dims" in r else "")
            + f"; PNGs {r['pngs']}")
    log(f"  14c plots: {path['examples']['plots']}")
    log(f"  phase 18: 14a {path['native_s']:.1f} s, 14b {path['async_s']:.1f} s, 14c "
        f"{path['examples_s']:.1f} s, all {path['wall_s']:.1f} s")


# path 15: the mesh planes, every rank on the one card
# bf16 logs of sp/tp 2 against sp 1 over 3 rounds (the H100 read 1.98e-3 and
# 1.3e-4, the same in every run): a forward check, the gradients are below
MESH_LOSS_ATOL = 5e-3
MESH_LR = 1e-3  # SeqTrainer's default learning rate, path 2's
# Adam moves a parameter by about lr a step whatever its gradient, so this
# bounds the steps taken, not the gradients: MESH_GRAD_RTOL holds those
MESH_PARAM_ATOL = 3 * 2 * MESH_LR
# the first round's reduced gradient (one start for both runs) against sp 1's,
# each leaf's ‖got − want‖ / ‖want‖: bf16 activations and attention operands
# (2^-8 a rounding) summed over B·T = 65536 positions, in another order and
# blocking (the H100 read 3.0e-3 for sp 2 and tp 2, a CPU rehearsal at T 64
# 4.1e-2, a LayerNorm leaf's).  Each planted fault reads 1 or more
MESH_GRAD_RTOL = 1e-1
# planted faults the gradient check must see: every leaf zero, doubled (a sum
# where a mean belongs) or negated, and the one leaf the check sees least
MESH_FAULTS = ("zero", "doubled", "negated", "one leaf zero")
RING_SHAPE = (2, 4, 4096, 32)  # 15c: B, H, T, d
RING_RTOL = 2e-2  # bf16: every hop's partial output is rounded before the float32 merge
RING_CASES = (("ring", 2), ("ring", 4), ("ulysses", 2), ("ulysses", 4))


def metered_mesh_engine(fa, rounds, first_grads=None):
    """``MeshEngine`` whose plane's ``train_step`` records, each round, its
    fenced step time, the flash kernels' launches and the loss; with
    ``first_grads`` (an empty dict) also the first round's reduced
    gradient, as the plane hands it to the optimizer (float32, on the
    host)."""
    import torch

    from coinstac_dinunet_tpu_torch.engine import MeshEngine

    class MeteredMesh(MeshEngine):
        def _build_federation(self, rc):
            fed = super()._build_federation(rc)
            step = fed.train_step

            def metered(site_batches):
                before = [kern.launches for kern in fa.KERNELS]
                trainer = fed.trainer
                record = first_grads is not None and not first_grads
                if record:
                    apply = trainer.apply_grads

                    def recording(grads):
                        first_grads.update({f"{m}.{n}": g.detach().float().cpu()
                                            for m, leaves in grads.items()
                                            for n, g in leaves.items()})
                        return apply(grads)

                    trainer.apply_grads = recording
                t0 = time.perf_counter()
                try:
                    aux = step(site_batches)
                finally:
                    if record:
                        del trainer.apply_grads  # the class's method again
                torch.cuda.synchronize()
                rounds.append({"step_s": time.perf_counter() - t0, "loss": float(aux["loss"]),
                               "launches": [kern.launches - b
                                            for kern, b in zip(fa.KERNELS, before)]})
                return aux

            fed.train_step = metered
            return fed

    return MeteredMesh


def mesh_launch_faults(tag, rounds, want):
    """Each round's K2/K3/K4 launches against their closed form."""
    return [f"{tag} round {i + 1}: K2/K3/K4 launched {r['launches']} times, expected {want} "
            "each" for i, r in enumerate(rounds) if r["launches"] != [want] * 3]


def run_mesh_engine(dev, workdir, ranks, hops, **extra):
    """Path 2's configuration through ``MeshEngine`` with ``ranks`` ranks a
    site on the one card; every round's launches held to sites × ranks ×
    hops × blocks × micro-batches."""
    import torch

    from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    rounds, first_grads = [], {}
    eng = metered_mesh_engine(fa, rounds, first_grads)(
        workdir, n_sites=N_SITES, trainer_cls=SeqTrainer, dataset_cls=SyntheticSeqDataset,
        device=dev, devices=[dev] * (N_SITES * ranks), task_id=SEQ_TASK,
        **{**seq_node_args(), **extra})
    make_seq_files(eng)
    for kern in fa.KERNELS:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError(f"path 15 {extra}: no SUCCESS")
    k = max(int(seq_node_args().get("local_iterations", 1)), 1)
    want = N_SITES * ranks * hops * SEQ_ARGS["num_layers"] * k
    faults = mesh_launch_faults(str(extra), rounds, want)
    if faults:
        raise AssertionError("path 15:\n  " + "\n  ".join(faults))
    launches = dict(zip(FLASH_SOURCES, (kern.launches for kern in fa.KERNELS)))
    if min(launches.values()) == 0:
        raise AssertionError(f"path 15 {extra}: a flash kernel was never launched")
    return {"wall_s": wall, "rounds": rounds, "launches": launches,
            "launches_per_round": want, "mesh": {k_: int(v) for k_, v in
                                                 eng._last_fed.mesh.shape.items()},
            "global_test_metrics": check_vec_outputs(eng, workdir),
            "logs": {key: eng.cache[key] for key in (*SEQ_LOGS, "global_test_metrics")},
            "first_grads": first_grads,
            "params": {n: p.detach().float().cpu()
                       for n, p in eng._trainer.nn["seq_net"].named_parameters()}}


def mesh_gaps(got, want):
    """The largest loss gap over the train, validation and test logs
    (their first column) and the largest parameter gap of two runs."""
    import numpy as np

    loss = max(float(np.abs(np.asarray(got["logs"][key], np.float64)[:, 0]
                            - np.asarray(want["logs"][key], np.float64)[:, 0]).max())
               for key in SEQ_LOGS)
    param = max(float((got["params"][n] - want["params"][n]).abs().max())
                for n in want["params"])
    return loss, param


def grad_gaps(got, want):
    """``got``'s first-round gradient against ``want``'s: the worst leaf's
    relative distance ``‖got − want‖ / ‖want‖``, and that leaf."""
    gaps = {n: float((got[n] - w).norm()) / max(float(w.norm()), 1e-30)
            for n, w in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def planted_grad_faults(got, want):
    """What :func:`grad_gaps` reads when ``got`` carries each of
    ``MESH_FAULTS``; "one leaf zero" is the least reading over the
    leaves."""
    out = {"zero": grad_gaps({n: 0 * g for n, g in got.items()}, want)[0],
           "doubled": grad_gaps({n: 2 * g for n, g in got.items()}, want)[0],
           "negated": grad_gaps({n: -g for n, g in got.items()}, want)[0]}
    out["one leaf zero"] = min(grad_gaps({**got, n: 0 * got[n]}, want)[0] for n in got)
    return out


def check_ring_on_card(dev):
    """15c: the ring (sp 2, 4) and Ulysses (sp 2, 4), causal and not, at
    ``RING_SHAPE`` in bfloat16, held to one ``flash_attention`` call over
    the whole sequence (outputs and q/k/v gradients within ``RING_RTOL``
    of the largest magnitude); both also measured against the float32
    plain version.  Then rank 0's fully masked hops of a causal ring of 4
    on their own: zeros and the sentinel lse from K2, zero gradients from
    K3/K4 under a nonzero ``g_lse``."""
    import torch

    from coinstac_dinunet_tpu_torch.ops import flash_attention
    from coinstac_dinunet_tpu_torch.parallel import ring_attention, ulysses_attention
    from coinstac_dinunet_tpu_torch.parallel.mesh import RankAxis

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    b, h, t, d = RING_SHAPE
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = [torch.randn((b, h, t, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3)]
    g_out = torch.randn((b, h, t, d), generator=g, device=dev)

    def run(fn, n, causal):
        full = [x.clone().requires_grad_(True) for x in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fn is None:
            out = flash_attention(*full, causal=causal)
        else:
            axis = RankAxis("sp", [dev] * n)
            out = torch.cat(fn(*[list(x.chunk(n, dim=2)) for x in full], axis,
                               causal=causal), dim=2)
        (out.float() * g_out).sum().backward()
        torch.cuda.synchronize()
        return [out.detach().float()] + [x.grad.float() for x in full], time.perf_counter() - t0

    def reference(causal):
        """The float32 plain version of the same bfloat16 inputs."""
        full = [x.float().reshape(b * h, t, d) for x in (q, k, v)]
        scale = 1.0 / d ** 0.5
        o, lse = fa.flash_forward_plain(*full, 0, 0, t, causal, scale)
        dq, dk, dv = fa.flash_backward_plain(*full, o, lse, g_out.reshape(b * h, t, d),
                                             torch.zeros_like(lse), 0, 0, t, causal, scale)
        return [x.reshape(b, h, t, d) for x in (o, dq, dk, dv)]

    def rel(got, want):
        return max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(got, want))

    rows, faults = [], []
    for causal in (False, True):
        ref = reference(causal)
        one, one_s = run(None, 1, causal)
        for name, n in RING_CASES:
            before = [kern.launches for kern in fa.KERNELS]
            got, got_s = run(fns[name], n, causal)
            launches = [kern.launches - x for kern, x in zip(fa.KERNELS, before)]
            want_calls = n * n if name == "ring" else n
            row = {"fn": name, "sp": n, "causal": causal, "launches": launches,
                   "vs_one_call": rel(got, one), "vs_float32": rel(got, ref),
                   "one_call_vs_float32": rel(one, ref), "s": got_s, "one_call_s": one_s}
            rows.append(row)
            if launches != [want_calls] * 3:
                faults.append(f"15c {name} sp {n} causal {causal}: launches {launches}, "
                              f"expected {want_calls} each")
            if not all(torch.isfinite(x).all() for x in got):
                faults.append(f"15c {name} sp {n} causal {causal}: not finite")
            if row["vs_one_call"] > RING_RTOL:
                faults.append(f"15c {name} sp {n} causal {causal}: {row['vs_one_call']:.3e} "
                              f"of max from the one call (tolerance {RING_RTOL})")
    n, tl = 4, t // 4
    masked = []
    for src in range(1, n):  # rank 0's hops 1..3 hold ranks 3, 2, 1's blocks
        qq = q[:, :, :tl].clone().requires_grad_(True)
        kk = k[:, :, src * tl:(src + 1) * tl].clone().requires_grad_(True)
        vv = v[:, :, src * tl:(src + 1) * tl].clone().requires_grad_(True)
        out, lse = flash_attention(qq, kk, vv, q_offset=0, k_offset=src * tl, causal=True,
                                   return_lse=True)
        g_lse = torch.randn(lse.shape, generator=g, device=dev)
        ((out.float() * g_out[:, :, :tl]).sum() + (lse * g_lse).sum()).backward()
        ok = (bool(torch.all(out == 0)) and float(lse.detach().max()) <= -5e29
              and all(bool(torch.all(x.grad == 0)) for x in (qq, kk, vv)))
        masked.append({"src": src, "ok": ok, "lse_max": float(lse.detach().max())})
        if not ok:
            faults.append(f"15c rank 0's hop from rank {src}: not fully masked")
    if faults:
        raise AssertionError("path 15c:\n  " + "\n  ".join(faults))
    return {"cases": rows, "masked_hops": masked}


def run_mesh_example(dev, workdir):
    """15d: the sequence example's ``main_mesh(sp=2)`` at its
    ``inputspec.json`` size (head dim 16) on the card to SUCCESS, every
    round's launches held to their closed form."""
    import torch

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    mod = load_script(os.path.join(HERE, "coinstac_dinunet_tpu_torch", "examples",
                                   "seq_classification", "run_sim.py"))
    rounds = []
    mod.MeshEngine = metered_mesh_engine(fa, rounds)
    for kern in fa.KERNELS:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = mod.main_mesh(workdir, device=dev.type)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not eng.success:
        raise AssertionError("path 15d: no SUCCESS")
    sp = 2
    want = len(eng.site_ids) * sp * sp * mod.ARGS["num_layers"]
    faults = mesh_launch_faults("15d", rounds, want)
    if faults:
        raise AssertionError("path 15d:\n  " + "\n  ".join(faults))
    return {"wall_s": wall, "rounds": len(rounds), "launches_per_round": want,
            "launches": dict(zip(FLASH_SOURCES, (kern.launches for kern in fa.KERNELS))),
            "head_dim": mod.ARGS["d_model"] // mod.ARGS["num_heads"],
            "global_test_metrics": check_vec_outputs(eng, workdir)}


def run_mesh_path(dev, workdir):
    """Path 15 (phase 19): 15a sp 2 against sp 1 and 15b tp 2 against
    it through ``MeshEngine`` at path 2's configuration, 15c the ring and
    Ulysses against one call, 15d the example's ``main_mesh``; each part
    timed."""
    out = {}
    t0 = time.perf_counter()
    one = run_mesh_engine(dev, os.path.join(workdir, "sp1"), ranks=1, hops=1)
    sp2 = run_mesh_engine(dev, os.path.join(workdir, "sp2"), ranks=2, hops=2,
                          sequence_parallel=2)
    out["15a_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    tp2 = run_mesh_engine(dev, os.path.join(workdir, "tp2"), ranks=2, hops=1,
                          tensor_parallel=2)
    out["15b_s"] = time.perf_counter() - t1
    faults = []
    for tag, run in (("sp2", sp2), ("tp2", tp2)):
        loss, param = mesh_gaps(run, one)
        run["loss_gap"], run["param_gap"] = loss, param
        run["grad_gap"], run["grad_worst_leaf"] = grad_gaps(run["first_grads"],
                                                            one["first_grads"])
        run["planted"] = planted_grad_faults(run["first_grads"], one["first_grads"])
        if loss > MESH_LOSS_ATOL or param > MESH_PARAM_ATOL:
            faults.append(f"15 {tag} against sp 1: loss gap {loss:.3e} (tolerance "
                          f"{MESH_LOSS_ATOL}), parameter gap {param:.3e} (tolerance "
                          f"{MESH_PARAM_ATOL})")
        if not run["grad_gap"] <= MESH_GRAD_RTOL:
            faults.append(f"15 {tag} against sp 1: the first round's gradient, leaf "
                          f"{run['grad_worst_leaf']}, {run['grad_gap']:.3e} of its norm "
                          f"(tolerance {MESH_GRAD_RTOL})")
        blind = [f for f, r in run["planted"].items() if not r > MESH_GRAD_RTOL]
        if blind:
            faults.append(f"15 {tag}: the gradient check would pass planted faults {blind} "
                          f"({run['planted']})")
    if faults:
        raise AssertionError("path 15:\n  " + "\n  ".join(faults))
    for run in (one, sp2, tp2):
        run.pop("params")
        run.pop("first_grads")
    out.update(sp1=one, sp2=sp2, tp2=tp2)
    t2 = time.perf_counter()
    out["15c"] = check_ring_on_card(dev)
    out["15c_s"] = time.perf_counter() - t2
    t3 = time.perf_counter()
    out["15d"] = run_mesh_example(dev, os.path.join(workdir, "example"))
    out["15d_s"] = time.perf_counter() - t3
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_mesh_path(path, smi):
    for tag in ("sp1", "sp2", "tp2"):
        r = path[tag]
        gaps = ("" if tag == "sp1" else f"; against sp 1: loss gap {r['loss_gap']:.3e}, "
                f"parameter gap {r['param_gap']:.3e}, first-round gradient "
                f"{r['grad_gap']:.3e} of its norm (leaf {r['grad_worst_leaf']}; planted "
                + ", ".join(f"{f} {x:.3e}" for f, x in r["planted"].items()) + ")")
        log(f"  15 {tag}: mesh {r['mesh']}, {len(r['rounds'])} gradient rounds to SUCCESS in "
            f"{r['wall_s']:.3f} s, K2/K3/K4 {r['launches_per_round']} each a round "
            f"({list(r['launches'].values())} in all), step s "
            + " ".join(f"{x['step_s']:.3f}" for x in r["rounds"])
            + f", global test {r['global_test_metrics']}{gaps} | {smi}")
    for row in path["15c"]["cases"]:
        log(f"  15c {row['fn']} sp {row['sp']} causal {row['causal']}: launches "
            f"{row['launches']}, max |d| / max against one call {row['vs_one_call']:.3e}, "
            f"against float32 {row['vs_float32']:.3e} (one call {row['one_call_vs_float32']:.3e}); "
            f"forward+backward {row['s'] * 1e3:.2f} ms (one call {row['one_call_s'] * 1e3:.2f} ms)")
    log("  15c rank 0's fully masked hops: " + ", ".join(
        f"from rank {m['src']} {'ok' if m['ok'] else 'FAILED'} (lse max {m['lse_max']:.3e})"
        for m in path["15c"]["masked_hops"]))
    r = path["15d"]
    log(f"  15d seq example main_mesh(sp=2), head dim {r['head_dim']}: {r['rounds']} gradient "
        f"rounds to SUCCESS in {r['wall_s']:.3f} s, K2/K3/K4 {r['launches_per_round']} each a "
        f"round, global test {r['global_test_metrics']} | {smi}")
    log(f"  phase 19: 15a {path['15a_s']:.1f} s, 15b {path['15b_s']:.1f} s, 15c "
        f"{path['15c_s']:.1f} s, 15d {path['15d_s']:.1f} s, all {path['wall_s']:.1f} s")


# path 16: the sharded transformer steps, every rank on the one card, at
# TSPConfig's full width (d_model 128, 8 heads of 16, 2 layers, d_ff 512)
TSP_ARGS = dict(num_features=16, num_classes=2, d_model=128, num_heads=8, num_layers=2,
                mlp_ratio=4, max_len=4096)
TSP_BATCH, TSP_T = 16, 4096
TSP_STEPS = 3
TSP_LR = 1e-3  # the default of make_tsp_train_step and make_pp_train_step
TSP_EXPERTS, TSP_CAPACITY = 4, 1.25
PP_MICROBATCHES = 4
# float32, the mesh against one rank: the same function in another blocking
# and sum order (the CPU tests hold it to JAX within 2e-5; the H100 read
# 3.6e-7 and 2.8e-6): the logits within TSP_F32_RTOL of their largest
# magnitude, the aux loss within TSP_F32_RTOL of itself, each first-step
# gradient leaf within TSP_F32_RTOL of its norm
TSP_F32_RTOL = 1e-3
# the MoE's float32 pair: a near tie between two gates may route a token to
# another expert in the other blocking, and with capacity binding that moves
# one token's place in two experts' buffers; each such token moves the logits
# by about 2e-4 of their largest magnitude (1/T of a token's FFN output
# through the pool and the head), so the gate allows a few dozen; the tokens
# routed differently are counted and printed
TSP_F32_MOE_RTOL = 1e-2
# bfloat16: each blocking rounds its activations and projections (the tp
# partials before their sum) to 2^-8, so the mesh and one rank differ by the
# format's error, which the float32 pair above shows is all they differ by:
# logits within TSP_LOGITS_RTOL of their largest magnitude (the aux loss of
# itself), the steps' losses within TSP_LOSS_ATOL (path 15's gate), each
# first-step gradient leaf and each leaf's update over the steps within
# TSP_GRAD_RTOL of one rank's (path 15's MESH_GRAD_RTOL: its planted faults,
# MESH_FAULTS, read 1 or more)
TSP_LOGITS_RTOL = 2e-2
TSP_LOSS_ATOL = 5e-3
TSP_GRAD_RTOL = 1e-1
# the MoE in bfloat16: the router's input differs by the format's rounding
# between the blockings, so near ties route tokens to other experts.  The
# gates were set from a CPU rehearsal at d_model 32, T 64-256 (0.1-0.5 % of
# the tokens rerouted, logits 2.4e-2-2.9e-2 of max, the router's gradient
# 7e-2 and its update 1.6e-1 of one rank's); the H100 at full width read
# 0.13 % and 0.33 % rerouted, logits 2.9e-3, the worst gradient leaf 2.6e-2.
# The planted faults (1 or more) read above them
TSP_MOE_LOGITS_RTOL = 5e-2
TSP_MOE_GRAD_RTOL = 3e-1


def tsp_batches(n, seed):
    """``n`` batches of the JAX tests' recipe (a label-dependent sine under
    noise) at ``(TSP_BATCH, TSP_T, num_features)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(TSP_T)[None, :, None]
    out = []
    for _ in range(n):
        y = rng.integers(0, TSP_ARGS["num_classes"], size=TSP_BATCH)
        sig = np.sin(2 * np.pi * (y[:, None, None] + 1) * t / TSP_T)
        x = rng.normal(size=(TSP_BATCH, TSP_T, TSP_ARGS["num_features"])) * 0.3 + sig
        out.append((x.astype(np.float32), y))
    return out


def named_leaves(tree, prefix=""):
    """``{path: float32 host tensor}`` of a whole parameter tree (dicts and
    the layer list)."""
    import torch

    if not isinstance(tree, (dict, list)):
        return {prefix.rstrip("/"): torch.as_tensor(tree).detach().float().cpu()}
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        out.update(named_leaves(v, f"{prefix}{k}/"))
    return out


def update_gaps(got, want, base):
    """Each leaf's update from ``base`` against ``want``'s: the worst
    ``‖got − want‖ / ‖want − base‖`` and its leaf."""
    return grad_gaps({n: g - base[n] for n, g in got.items()},
                     {n: w - base[n] for n, w in want.items()})


def run_tsp_case(dev, shape, cfg, whole, batches, steps=TSP_STEPS):
    """The sharded step on ``shape`` ranks of the one card from the whole
    tree ``whole``: the logits, aux loss and MoE stats on ``batches[0]``,
    the first step's gradient, then ``steps`` donated steps, each fenced,
    its K2/K3/K4 launches counted from 0; the peak memory of the steps and
    the gathered tree after them."""
    import torch

    from coinstac_dinunet_tpu_torch.parallel import sequence as seq

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    n = 1
    for s in shape:
        n *= s
    mesh = seq.build_tsp_mesh(*shape, devices=[dev] * n)
    params = seq.shard_tsp_params(whole, mesh)
    stats = []
    with torch.no_grad():
        logits, aux = seq.tsp_forward(params, batches[0][0], cfg, mesh, stats=stats)
    xs, ys = seq.shard_tsp_batch(*batches[0], mesh)
    _, grads = seq.value_and_grad(lambda p, x, y: seq.tsp_loss(p, x, y, cfg, mesh),
                                  params, xs, ys)
    out = {"shape": list(shape), "logits": logits.float().cpu(), "aux": float(aux),
           "dropped": [float(s["dropped"]) for s in stats],
           "capacity": [s["capacity"] for s in stats],
           "experts": [s["expert"].cpu() for s in stats],
           "grads": named_leaves(seq.gather_tsp_params(grads)), "steps": []}
    del grads
    step = seq.make_tsp_train_step(cfg, mesh, lr=TSP_LR)
    torch.cuda.reset_peak_memory_stats()
    for x, y in batches[:steps]:
        xs, ys = seq.shard_tsp_batch(x, y, mesh)
        for kern in fa.KERNELS:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, xs, ys)
        torch.cuda.synchronize()
        out["steps"].append({"step_s": time.perf_counter() - t0, "loss": float(loss),
                             "launches": [kern.launches for kern in fa.KERNELS]})
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["params"] = named_leaves(seq.gather_tsp_params(params))
    return out


def launch_faults(tag, run, want):
    """Each step's K2/K3/K4 launches against their closed form."""
    return [f"{tag} {run['shape']} step {i + 1}: K2/K3/K4 launched {s['launches']} times, "
            f"expected {want} each" for i, s in enumerate(run["steps"])
            if s["launches"] != [want] * 3]


def tsp_gaps(tag, mesh, one, base, logits_rtol, grad_rtol, loss_atol=TSP_LOSS_ATOL):
    """``mesh`` against ``one`` (the same weights and batches on one rank),
    each reading stored in ``mesh``: logits, aux loss, losses, the first
    gradient (with the planted faults) and the updates."""
    faults = []
    mesh["logits_gap"] = (float((mesh["logits"] - one["logits"]).abs().max())
                          / float(one["logits"].abs().max()))
    if not mesh["logits_gap"] <= logits_rtol:
        faults.append(f"{tag}: logits {mesh['logits_gap']:.3e} of max from one rank's "
                      f"(tolerance {logits_rtol})")
    if one["aux"]:
        mesh["aux_gap"] = abs(mesh["aux"] - one["aux"]) / abs(one["aux"])
        if not mesh["aux_gap"] <= logits_rtol:
            faults.append(f"{tag}: aux loss {mesh['aux_gap']:.3e} of one rank's (tolerance "
                          f"{logits_rtol})")
    mesh["grad_gap"], mesh["grad_worst_leaf"] = grad_gaps(mesh["grads"], one["grads"])
    mesh["planted"] = planted_grad_faults(mesh["grads"], one["grads"])
    if not mesh["grad_gap"] <= grad_rtol:
        faults.append(f"{tag}: first gradient, leaf {mesh['grad_worst_leaf']}, "
                      f"{mesh['grad_gap']:.3e} of its norm (tolerance {grad_rtol})")
    blind = [f for f, r in mesh["planted"].items() if not r > grad_rtol]
    if blind:
        faults.append(f"{tag}: the gradient check would pass planted faults {blind} "
                      f"({mesh['planted']})")
    if mesh["steps"]:
        mesh["loss_gap"] = max(abs(a["loss"] - b["loss"])
                               for a, b in zip(mesh["steps"], one["steps"]))
        if not mesh["loss_gap"] <= loss_atol:
            faults.append(f"{tag}: losses {mesh['loss_gap']:.3e} from one rank's (tolerance "
                          f"{loss_atol})")
        mesh["update_gap"], mesh["update_worst_leaf"] = update_gaps(mesh["params"],
                                                                    one["params"], base)
        if not mesh["update_gap"] <= grad_rtol:
            faults.append(f"{tag}: leaf {mesh['update_worst_leaf']}'s update "
                          f"{mesh['update_gap']:.3e} of one rank's (tolerance {grad_rtol})")
    return faults


def run_tsp_pair(dev, tag, shape, moe, seed):
    """``shape`` against one rank from the same weights and batches: a
    float32 pair (logits, aux loss, first gradient; no steps), then the
    bfloat16 pair with ``TSP_STEPS`` steps each."""
    import torch

    from coinstac_dinunet_tpu_torch.parallel import sequence as seq

    extra = dict(num_experts=TSP_EXPERTS, capacity_factor=TSP_CAPACITY) if moe else {}
    batches = tsp_batches(TSP_STEPS, seed)
    cfg = seq.TSPConfig(**TSP_ARGS, causal=not moe, dtype=torch.float32, **extra)
    whole = seq.init_tsp_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    base = named_leaves(whole)
    f32 = [run_tsp_case(dev, s, cfg, whole, batches, steps=0) for s in (shape, (1, 1, 1, 1))]
    rtol = TSP_F32_MOE_RTOL if moe else TSP_F32_RTOL
    faults = tsp_gaps(f"{tag} float32", *f32, base, rtol, rtol)
    cfg.dtype = torch.bfloat16
    one = run_tsp_case(dev, (1, 1, 1, 1), cfg, whole, batches)
    mesh = run_tsp_case(dev, shape, cfg, whole, batches)
    faults += tsp_gaps(tag, mesh, one, base, *((TSP_MOE_LOGITS_RTOL, TSP_MOE_GRAD_RTOL) if moe
                                                else (TSP_LOGITS_RTOL, TSP_GRAD_RTOL)))
    for got, want in ((f32[0], f32[1]), (mesh, one)):  # tokens routed differently a layer
        got["rerouted"] = [int((a != b).sum()) for a, b in zip(got["experts"], want["experts"])]
    dp, tp, sp, _ = shape
    faults += launch_faults(tag, mesh, TSP_ARGS["num_layers"] * dp * tp * sp * sp)
    faults += launch_faults(tag, one, TSP_ARGS["num_layers"])
    for run in (*f32, one, mesh):  # what the report keeps is JSON
        for key in ("grads", "logits", "experts", "params"):
            run.pop(key)
    return {"float32": f32[0], "one": one, "mesh": mesh, "whole": whole, "cfg": cfg,
            "batches": batches}, faults


def run_pp_case(dev, pp_size, dp, cfg, whole, batches):
    """The GPipe step on ``pp_size × dp`` ranks of the one card from the
    whole tree ``whole`` (stacked here), ``PP_MICROBATCHES`` microbatches:
    each donated step fenced with its launches counted from 0; each stage
    rank's parameter bytes and the gathered tree after the steps."""
    import torch

    from coinstac_dinunet_tpu_torch.parallel import pipeline as pp
    from coinstac_dinunet_tpu_torch.parallel import sequence as seq

    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    mesh = pp.build_pp_mesh(pp_size, dp, devices=[dev] * (pp_size * dp))
    params = pp.shard_pp_params(pp.stack_layers(whole), mesh)
    layers = seq.tensors(params["layers"])  # leaf by leaf, each leaf's pp shards in turn
    rest = seq.tensors({k: v for k, v in params.items() if k != "layers"})
    stage_bytes = [sum(t.numel() * t.element_size() for t in layers[p::pp_size])
                   for p in range(pp_size)]
    stage_layers = sorted({t.shape[0] for t in layers})
    step = pp.make_pp_train_step(cfg, mesh, lr=TSP_LR, num_microbatches=PP_MICROBATCHES)
    steps = []
    for x, y in batches:
        xs, ys = pp.shard_pp_batch(x, y, mesh)
        for kern in fa.KERNELS:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, xs, ys)
        torch.cuda.synchronize()
        steps.append({"step_s": time.perf_counter() - t0, "loss": float(loss),
                      "launches": [kern.launches for kern in fa.KERNELS]})
    return {"shape": [pp_size, dp], "steps": steps, "stage_layer_bytes": stage_bytes,
            "replicated_bytes": sum(t.numel() * t.element_size() for t in rest),
            "layers_a_stage": stage_layers,
            "params": named_leaves(pp.gather_pp_params(params))}


def run_sharded_path(dev):
    """Path 16 (phase 20): 16a the dense causal step on dp2×tp2×sp2, 16b
    the switch MoE on tp2×sp2×ep2, each against one rank from the same
    weights and batches (a float32 pair, then bfloat16 steps); 16c GPipe on
    pp2×dp2 against pp 1 on 16a's weights; each part timed."""
    from coinstac_dinunet_tpu_torch.parallel import pipeline as pp

    out, faults = {}, []
    t0 = time.perf_counter()
    dense, f = run_tsp_pair(dev, "16a", (2, 2, 2, 1), moe=False, seed=16)
    faults += f
    out["16a_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    moe, f = run_tsp_pair(dev, "16b", (1, 2, 2, 2), moe=True, seed=17)
    faults += f
    n_tok = TSP_BATCH * TSP_T
    dispatch_bytes = n_tok * TSP_EXPERTS * moe["mesh"]["capacity"][0] * 4
    if not moe["mesh"]["peak_bytes"] < dispatch_bytes:
        faults.append(f"16b: the steps' peak memory {moe['mesh']['peak_bytes']} B reaches one "
                      f"(N, E, C) float32 dispatch tensor's {dispatch_bytes} B")
    out["16b_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    base = named_leaves(pp.stack_layers(dense["whole"]))
    one = run_pp_case(dev, 1, 1, dense["cfg"], dense["whole"], dense["batches"])
    mesh = run_pp_case(dev, 2, 2, dense["cfg"], dense["whole"], dense["batches"])
    mesh["loss_gap"] = max(abs(a["loss"] - b["loss"]) for a, b in zip(mesh["steps"],
                                                                       one["steps"]))
    mesh["update_gap"], mesh["update_worst_leaf"] = update_gaps(mesh["params"], one["params"],
                                                                base)
    if not mesh["loss_gap"] <= TSP_LOSS_ATOL:
        faults.append(f"16c: losses {mesh['loss_gap']:.3e} from pp 1's (tolerance "
                      f"{TSP_LOSS_ATOL})")
    if not mesh["update_gap"] <= TSP_GRAD_RTOL:
        faults.append(f"16c: leaf {mesh['update_worst_leaf']}'s update {mesh['update_gap']:.3e}"
                      f" of pp 1's (tolerance {TSP_GRAD_RTOL})")
    layers = TSP_ARGS["num_layers"]
    faults += launch_faults("16c", mesh, 2 * PP_MICROBATCHES * layers)
    faults += launch_faults("16c", one, PP_MICROBATCHES * layers)
    if mesh["layers_a_stage"] != [layers // 2]:
        faults.append(f"16c: a stage holds {mesh['layers_a_stage']} layers, not {layers // 2}")
    for run in (one, mesh):
        run.pop("params")
    out["16c_s"] = time.perf_counter() - t2
    if faults:
        raise AssertionError("path 16:\n  " + "\n  ".join(faults))
    for part in (dense, moe):
        for key in ("whole", "cfg", "batches"):
            part.pop(key)
    out.update({"16a": dense, "16b": moe, "16c": {"one": one, "mesh": mesh},
                "dispatch_bytes": dispatch_bytes, "wall_s": time.perf_counter() - t0})
    fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")
    out["launches"] = {
        path: dict(zip(FLASH_SOURCES, (sum(s["launches"][i] for s in run["steps"])
                                       for i in range(len(fa.KERNELS)))))
        for path, run in (("tsp_dense_mesh", dense["mesh"]), ("tsp_dense_one_rank", dense["one"]),
                          ("tsp_moe_mesh", moe["mesh"]), ("tsp_moe_one_rank", moe["one"]),
                          ("pp_gpipe", mesh), ("pp_one_stage", one))}
    return out


def log_sharded_path(path, smi):
    def steps(run):
        return " ".join(f"{s['step_s']:.4f}" for s in run["steps"])

    for tag, key in (("16a dense causal dp2 x tp2 x sp2", "16a"),
                     ("16b switch MoE tp2 x sp2 x ep2", "16b")):
        part = path[key]
        m, one, f32 = part["mesh"], part["one"], part["float32"]
        aux = (f"; aux {m['aux']:.6f} against {one['aux']:.6f} ({m['aux_gap']:.3e}, float32 "
               f"{f32['aux_gap']:.3e})" if "aux_gap" in m else "")
        log(f"  {tag}: float32 against one rank: logits {f32['logits_gap']:.3e} of max, first "
            f"gradient {f32['grad_gap']:.3e} (leaf {f32['grad_worst_leaf']}); bf16: logits "
            f"{m['logits_gap']:.3e} of max, losses {m['loss_gap']:.3e}, first gradient "
            f"{m['grad_gap']:.3e} (leaf {m['grad_worst_leaf']}; planted "
            + ", ".join(f"{f} {x:.3e}" for f, x in m["planted"].items())
            + f"), updates {m['update_gap']:.3e} (leaf {m['update_worst_leaf']}){aux}")
        log(f"    K2/K3/K4 a step {m['steps'][0]['launches']} (one rank "
            f"{one['steps'][0]['launches']}); losses " + " ".join(
                f"{s['loss']:.5f}" for s in m["steps"])
            + f"; fenced step s {steps(m)} against one rank's {steps(one)}; peak memory "
            f"{m['peak_bytes'] / 2**30:.3f} GiB (one rank {one['peak_bytes'] / 2**30:.3f})"
            + (f"; dropped tokens a layer {[round(x, 4) for x in m['dropped']]} (one rank "
               f"{[round(x, 4) for x in one['dropped']]}), capacity {m['capacity'][0]}, tokens "
               f"routed otherwise than on one rank {m['rerouted']} (float32 "
               f"{f32['rerouted']}); one "
               f"(N, E, C) float32 dispatch tensor would take "
               f"{path['dispatch_bytes'] / 2**30:.2f} GiB" if m["dropped"] else "")
            + f" | {smi}")
    m, one = path["16c"]["mesh"], path["16c"]["one"]
    log(f"  16c GPipe pp2 x dp2, M {PP_MICROBATCHES}, against pp 1: losses {m['loss_gap']:.3e} "
        f"apart, updates {m['update_gap']:.3e} (leaf {m['update_worst_leaf']}); K2/K3/K4 a step "
        f"{m['steps'][0]['launches']} (pp 1 {one['steps'][0]['launches']}); layer bytes a stage "
        f"{m['stage_layer_bytes']} ({m['layers_a_stage']} layer each; pp 1 "
        f"{one['stage_layer_bytes']}), replicated {m['replicated_bytes']}; fenced step s "
        f"{steps(m)} against pp 1's {steps(one)} | {smi}")
    log(f"  phase 20: 16a {path['16a_s']:.1f} s, 16b {path['16b_s']:.1f} s, 16c "
        f"{path['16c_s']:.1f} s, all {path['wall_s']:.1f} s")


def profiled_round(eng):
    """One engine round under ``torch.profiler``: the round's host wall
    time, the device time its kernels took, the idle share, and the
    kernels that took most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        site_outs, _ = eng.step_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return site_outs, {"round": eng.rounds, **profile_summary(prof, wall)}


def profile_summary(prof, wall):
    """A finished ``torch.profiler`` trace of ``wall`` seconds: the device
    time its kernels took, the idle share, the device-to-host copies, the
    top device operations and the port's own kernels."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, sets): a CPU operator's
        # device time repeats its kernels', and a user annotation (e.g.
        # "Optimizer.step#Adam.step") spans its kernels and the gaps between
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    d2h = [(us, c) for us, k, c in rows if "DtoH" in k]
    # the port's own kernels, whatever their rank: device time per launch
    ours = [{"name": k[:120], "device_ms": us / 1e3, "count": c, "ms_per_launch": us / 1e3 / c}
            for us, k, c in rows if any(n in k for n in PORT_KERNEL_NAMES)]
    return {
        "wall_s_profiled": wall, "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall),
        "d2h_copies": sum(c for _, c in d2h), "d2h_ms": sum(us for us, _ in d2h) / 1e3,
        "top_device_ops": [{"name": k[:120], "device_ms": us / 1e3, "count": c}
                           for us, k, c in rows[:12]],
        "port_kernels": ours,
    }


def log_profiles(profiles):
    for prof in profiles:
        log(f"  profiled round {prof['round']}: wall {prof['wall_s_profiled']:.3f} s, device "
            f"busy {prof['device_busy_s'] * 1e3:.2f} ms, idle share "
            f"{prof['device_idle_share']:.4f}; {prof['d2h_copies']} device->host copies, "
            f"{prof['d2h_ms']:.4f} ms")
        for op in prof["top_device_ops"][:8]:
            log(f"    {op['device_ms']:9.3f} ms x{op['count']:<4d} {op['name'][:80]}")
        for op in prof["port_kernels"]:
            log(f"    port kernel {op['name'][:60]}: {op['device_ms']:.4f} ms in {op['count']} "
                f"launches, {op['ms_per_launch'] * 1e3:.2f} us a launch")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from coinstac_dinunet_tpu_torch.ops import _cuda

    report = {}
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1 device] {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    build_logs = _cuda.build(_cuda.all_sources())
    log(f"[2 build] {', '.join(_cuda.all_sources())} in {time.perf_counter() - t0:.2f} s")
    from coinstac_dinunet_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build()
    if not native.available():
        raise AssertionError("the native wire runtime is off (COINN_NATIVE=0)")
    log(f"[2 build] native wire runtime {os.path.relpath(lib, HERE)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for source, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                log(f"  {source}: {line.strip()}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"{source}: a kernel spills registers: {line.strip()}")
    for source in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        n_hgmma = count_sass(_cuda, source, "HGMMA")
        log(f"  {source}: {n_hgmma} HGMMA (wgmma) instructions in the SASS")
        if n_hgmma == 0:
            raise AssertionError(f"{source} holds no tensor-core (HGMMA) instruction")

    # phase 14 runs first: its captured trace must hold the round's first
    # kernels, and late in a long process torch.profiler's Chrome trace
    # came without them (K2's forward launches missing, K3's and K4's there)
    log(f"[14 main path 10: sequence, health layer, quarantine and capture] "
        f"{HEALTH_SITES} sites through the tree, then the site-vectorized plane; run "
        f"right after the build | {smi}")
    with tempfile.TemporaryDirectory() as health_wd, tempfile.TemporaryDirectory() as vec_wd:
        health_path = run_health_path(dev, health_wd)
        health_vec = run_health_vectorized_path(dev, vec_wd)
        log_health_paths(health_path, health_vec, smi)
        # phase 16 reads phase 14's lanes
        log(f"[16 main path 12: the FLOP count and the telemetry tools] one counted grads "
            f"step of paths 1 and 2's models, then the CLI, doctor, watch and /metrics over "
            f"phase 14's lanes | {smi}")
        with tempfile.TemporaryDirectory() as wd:
            flop_path = run_flop_count_path(dev, wd)
        with tempfile.TemporaryDirectory() as wd:
            tools_path = run_tools_path(dev, health_wd, vec_wd, wd)
    log_flop_tools_paths(flop_path, tools_path, smi)

    log("[3 kernels] K1 quantize_int8 against its plain version")
    k1 = check_quantize(dev, report)
    log(f"[3 kernels] K2-K4 flash attention against their plain versions (tolerance "
        f"{FLASH_RTOL} x max|plain| + {FLASH_ATOL}; bfloat16 K2, K3 and K4: "
        f"{FLASH_BF16_MATCHED_RTOL} (T >= {FLASH_LONG_T}) or {FLASH_BF16_MATCHED_RTOL_SHORT} "
        "against the rounding-matched plain version, "
        f"{FLASH_BF16_RTOL} against the float32 one and at most {FLASH_BF16_LIBRARY_FACTOR} x "
        "the library's error)")
    k234 = check_flash(dev, report)

    err = check_reference(dev)
    log(f"[4 reference] VBM logits card vs CPU, float32: max |d| {err:.3e}")
    err, gerr = check_seq_reference(dev)
    log(f"[4 reference] sequence model card vs CPU, float32, T=200: logits max |d| {err:.3e}, "
        f"gradients max relative |d| {gerr:.3e}")
    report["power_iteration_errors"] = check_power_iteration(dev)
    log("[4 reference] compression math card vs CPU, float32, rankDAD embed shapes: "
        + ", ".join(f"{k} max |d| {v['max_abs_err']:.3e} ({v['relative']:.2e} of max)"
                    for k, v in report["power_iteration_errors"].items())
        + f" (tolerance {POWER_ITERATION_RTOL} x max)")

    with tempfile.TemporaryDirectory() as wd:
        main_path = run_main_path(dev, wd)
    k1["launches"] = main_path["launches"]
    # the kernel's device time a launch in the profiled rounds (the CUDA
    # events of phase 3 take the host's enqueue of back-to-back launches)
    k1["device_ms_per_launch"] = [op["ms_per_launch"] for prof in main_path["profiled_rounds"]
                                  for op in prof["port_kernels"] if "quantize" in op["name"]]
    log(f"[5 main path 1: VBM] {main_path['rounds']} rounds ({main_path['grad_rounds']} with "
        f"gradients) to SUCCESS in {main_path['wall_s']:.3f} s, "
        f"{main_path['samples_per_s']:.1f} samples/s, K1 launches {main_path['launches']} "
        f"over {main_path['segments']} segments | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in main_path["round_s"]))
    log("  K1 launches/segments per round: " + " ".join(
        f"{n}/{m}" for n, m in main_path["launches_segments_per_round"]))
    log(f"  native wire calls: {main_path['native_calls']} (every payload gather-written, "
        "every site's read of the mean native; the aggregator's fan-in maps the files)")
    wb = main_path["wire_bytes"]
    log(f"  wire bytes per gradient round: site->aggregator {wb['site_to_aggregator']}, "
        f"aggregator->each site {wb['aggregator_to_site']} (float32 values alone: "
        f"{wb['float32_values']})")
    log_profiles(main_path["profiled_rounds"])

    with tempfile.TemporaryDirectory() as wd:
        seq_path = run_seq_path(dev, wd)
    for kern in k234:
        kern["launches"] = seq_path["launches"][kern["name"]]
    log(f"[6 main path 2: sequence] {seq_path['rounds']} rounds ({seq_path['grad_rounds']} "
        f"with gradients) to SUCCESS in {seq_path['wall_s']:.3f} s, "
        f"{seq_path['samples_per_s']:.2f} samples/s ({seq_path['train_samples']} training "
        f"sequences of {SEQ_ARGS['seq_len']}), launches {seq_path['launches']} | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in seq_path["round_s"]))
    log("  launches per round: " + " ".join(
        "/".join(str(n) for n in r.values()) for r in seq_path["launches_per_round"]))
    wb = seq_path["wire_bytes"]
    log(f"  wire bytes per gradient round: site->aggregator {wb['site_to_aggregator']}, "
        f"aggregator->each site {wb['aggregator_to_site']}")
    log_profiles(seq_path["profiled_rounds"])

    with tempfile.TemporaryDirectory() as wd:
        psgd_path = run_powersgd_path(dev, wd)
    log(f"[7 main path 3: VBM + pretrain + PowerSGD] {psgd_path['rounds']} rounds "
        f"({psgd_path['grad_rounds']} with gradients) to SUCCESS in {psgd_path['wall_s']:.3f} s; "
        f"pretrainer {psgd_path['pretrainer']}, every site bit-equal to its best weights "
        f"({psgd_path['pretrain_leaves_checked']} leaves) after the load; K1 launches "
        f"{psgd_path['launches']} over {psgd_path['segments']} segments | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in psgd_path["round_s"]))
    log("  payload, K1 launches/segments per round: " + " ".join(
        f"{'+'.join(r['payload']) or '-'}:{r['launches']}/{r['segments']}"
        for r in psgd_path["per_round"]))
    for h in psgd_path["payloads_held"]:
        log(f"  round {h['round']} ({'+'.join(h['payload']) or '-'}): K1's payloads bit-equal "
            "to the plain version (leaves/values/bytes): "
            + " ".join("/".join(map(str, row)) for row in h["leaves_values_bytes"]))
    for key, wb in psgd_path["wire_bytes"].items():
        log(f"  wire bytes, {key} round: site->aggregator {wb['site_to_aggregator']}, "
            f"aggregator->each site {wb['aggregator_to_site']} (path 1's dSGD round: "
            f"{main_path['wire_bytes']['site_to_aggregator']})")

    with tempfile.TemporaryDirectory() as wd:
        dad_path = run_rankdad_path(dev, wd)
    log(f"[8 main path 4: sequence + rankDAD] {dad_path['rounds']} rounds "
        f"({dad_path['grad_rounds']} with gradients) to SUCCESS in {dad_path['wall_s']:.3f} s; "
        f"capture plan {dad_path['plan']}; launches {dad_path['launches']}, K1 "
        f"{dad_path['k1_launches']} over {dad_path['k1_segments']} segments | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in dad_path["round_s"]))
    h = dad_path["payloads_held"]
    log(f"  round {h['round']}: K1's payloads bit-equal to the plain version "
        "(leaves/values/bytes): " + " ".join("/".join(map(str, row))
                                             for row in h["leaves_values_bytes"]))
    wb = dad_path["wire_bytes"]
    log(f"  wire bytes per gradient round (factors + rest, int8): site->aggregator "
        f"{wb['site_to_aggregator']}, aggregator->each site {wb['aggregator_to_site']} "
        f"(path 2's dSGD round, float32 wire: {seq_path['wire_bytes']['site_to_aggregator']})")
    log_profiles(dad_path["profiled_rounds"])

    with tempfile.TemporaryDirectory() as wd, tempfile.TemporaryDirectory() as ref_wd:
        fresh_ref = run_seq_path(dev, ref_wd, n_sites=FRESH_SITES, n_files=FRESH_SEQ_FILES,
                                 trace_round=None)
        fresh_path = run_fresh_process_path(dev, wd, fresh_ref)
    log(f"[9 main path 5: sequence, a fresh process per invocation] {FRESH_SITES} site of "
        f"{FRESH_SEQ_FILES} subjects, {fresh_path['rounds']} rounds, {fresh_path['invocations']} invocations, to "
        f"SUCCESS in {fresh_path['wall_s']:.3f} s (in one process: {fresh_ref['wall_s']:.3f} "
        f"s); train_log, validation_log, test_metrics and every site's parameters equal the "
        f"one-process run's bit for bit; launches {fresh_path['launches']} | {smi}")
    log("  round seconds: " + " ".join(f"{t:.3f}" for t in fresh_path["round_s"]))
    log(f"  round files (bytes): {fresh_path['round_file_bytes']}")
    for role, row in fresh_path["split"].items():
        log(f"  {role} ({row['n']} invocations), mean s: start-up {row['mean_startup_s']:.3f} "
            f"(interpreter {row['mean_interpreter_s']:.3f}, torch {row['mean_torch_import_s']:.3f}, "
            f"CUDA context {row['mean_cuda_context_s']:.3f}, port {row['mean_port_import_s']:.3f}, "
            f"kernel libraries {row['mean_kernel_load_s']:.4f}, entry {row['mean_entry_s']:.3f}), "
            f"compute {row['mean_compute_s']:.3f}, exit {row['mean_exit_s']:.3f}, "
            f"total {row['mean_total_s']:.3f}; sums: start-up {row['sum_startup_s']:.3f}, "
            f"compute {row['sum_compute_s']:.3f}, total {row['sum_total_s']:.3f}")
    log("  per invocation (role/input phase/reduce: start-up + compute = total s): " + " ".join(
        f"{r['role'][0]}/{r['phase']}/{int(r['reduce'])}{'/dynamo' * r['dynamo_import_in_compute']}:"
        f"{r['startup_s']:.2f}+{r['compute_s']:.2f}={r['total_s']:.2f}"
        for r in fresh_path["per_invocation"]))
    log(f"  torch._dynamo import in a fresh process (torch.optim's first optimizer pulls it "
        f"in): {fresh_path['torch_dynamo_import_s']:.3f} s")

    log(f"[10 main path 6: sequence, one warm worker per node] starting {N_SITES + 1} workers | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        daemon_path = run_daemon_path(dev, wd, seq_path)
    seq_path.pop("final_params")
    log_daemon_path(daemon_path, seq_path, fresh_path, smi)

    log(f"[11 main path 7: sequence, async rounds, quorum and chaos] starting "
        f"{ASYNC_SITES + 1} workers | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        async_path = run_async_chaos_path(dev, wd)
    log_async_chaos_path(async_path, smi)

    log(f"[12 main path 8: sequence, site-vectorized] {N_SITES} sites, then {VEC_SITES} + 1 "
        f"spare | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        vec_path = run_vectorized_path(dev, wd, seq_path)
    log_vectorized_path(vec_path, smi)

    log(f"[13 main path 9: sequence, membership, run-ahead, tree fan-in] starting "
        f"{MEM_SITES + 2} workers (a spare among them) | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        mem_path = run_membership_path(dev, wd)
    with tempfile.TemporaryDirectory() as wd:
        drain_path = run_drain_path(dev, wd)
    log_membership_path(mem_path, drain_path, smi)

    log(f"[15 main path 11: VBM on NIfTI files, ConfusionMatrix, AUC, device prefetch] "
        f"{N_SITES} sites x {NIFTI_SUBJECTS} subjects on the {'x'.join(map(str, NIFTI_GRID))} "
        f"grid | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        nifti_path = run_nifti_path(dev, wd)
    log_nifti_path(nifti_path, smi)

    log(f"[17 main path 13: the remaining models] ResNet-18 (config 4) on {RESNET_SITES} sites "
        f"warm-started from a torch checkpoint, the fused GroupNorm, two VBM nets "
        f"(config 5) on {MULTI_SITES} sites | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        models_path = run_remaining_models_path(dev, wd)
    log_remaining_models_path(models_path, smi)

    log(f"[18 main path 14: the native wire, background commits, the examples] "
        f"{NATIVE_PAYLOADS} ResNet-18 payloads, path 1 with async_wire_commit, the FSV, VBM "
        f"and sequence examples at their inputspec sizes | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        native_path = run_native_examples_path(dev, wd, main_path)
    log_native_examples_path(native_path, models_path, smi)
    for key in ("payload_digests", "final_params"):
        main_path.pop(key)
        native_path["async"].pop(key)

    log(f"[19 main path 15: the mesh planes] path 2's configuration through MeshEngine with "
        f"sequence_parallel 2 and tensor_parallel 2 against 1 ({N_SITES} sites, every rank on "
        f"the one card), the ring and Ulysses against one call, the example's main_mesh | {smi}")
    with tempfile.TemporaryDirectory() as wd:
        mesh_path = run_mesh_path(dev, wd)
    log_mesh_path(mesh_path, smi)

    log(f"[20 main path 16: the sharded transformer steps] TSPConfig's full width (d_model "
        f"{TSP_ARGS['d_model']}, {TSP_ARGS['num_heads']} heads of "
        f"{TSP_ARGS['d_model'] // TSP_ARGS['num_heads']}, T {TSP_T}, batch {TSP_BATCH}, bf16): "
        f"dp2 x tp2 x sp2, a switch MoE on tp2 x sp2 x ep2 and GPipe on pp2 x dp2 against one "
        f"rank, every rank on the one card | {smi}")
    sharded_path = run_sharded_path(dev)
    log_sharded_path(sharded_path, smi)

    k1["launches_by_path"] = {"vbm_dsgd": main_path["launches"],
                              "vbm_pretrain_powersgd": psgd_path["launches"],
                              "seq_rankdad": dad_path["k1_launches"],
                              "seq_async_chaos": async_path["k1_launches"],
                              "seq_membership_run_ahead": mem_path["k1_launches"],
                              "seq_health_quarantine": health_path["k1_launches"],
                              "vbm_nifti_metrics": (nifti_path["11a"]["launches"]
                                                    + nifti_path["11b"]["launches"]),
                              "resnet18_config4": models_path["resnet"]["launches"],
                              "multinet_config5": models_path["multinet"]["launches"],
                              "native_wire_resnet18_payloads": native_path["native"]["k1_launches"],
                              "vbm_async_commit": native_path["async"]["launches"]}
    for kern in k234:
        kern["launches_by_path"] = {"seq_dsgd": seq_path["launches"][kern["name"]],
                                    "seq_rankdad": dad_path["launches"][kern["name"]],
                                    "seq_fresh_process": fresh_path["launches"][kern["name"]],
                                    "seq_daemon": daemon_path["launches"][kern["name"]],
                                    "seq_async_chaos": async_path["launches"][kern["name"]],
                                    "seq_vectorized": vec_path["12b"]["launches"][kern["name"]],
                                    "seq_membership_run_ahead": mem_path["launches"][kern["name"]],
                                    "seq_health_quarantine": health_path["launches"][kern["name"]],
                                    "seq_health_vectorized": health_vec["launches"][kern["name"]],
                                    "seq_flop_count": flop_path["seq"]["launches"][kern["name"]],
                                    "vbm_nifti_metrics": nifti_path["11c_launches"][kern["name"]],
                                    "seq_example_d16": native_path["examples"][
                                        "seq_classification"]["launches"][kern["name"]],
                                    "seq_mesh_sp1": mesh_path["sp1"]["launches"][kern["name"]],
                                    "seq_mesh_sp2": mesh_path["sp2"]["launches"][kern["name"]],
                                    "seq_mesh_tp2": mesh_path["tp2"]["launches"][kern["name"]],
                                    "seq_example_mesh_sp2": mesh_path["15d"]["launches"][
                                        kern["name"]],
                                    **{path: counts[kern["name"]] for path, counts in
                                       sharded_path["launches"].items()}}
    kernels = [k1, *k234]
    report.update(main_path=main_path, seq_path=seq_path, powersgd_path=psgd_path,
                  rankdad_path=dad_path, fresh_process_path=fresh_path,
                  daemon_path=daemon_path, async_chaos_path=async_path,
                  vectorized_path=vec_path, membership_path=mem_path,
                  drain_path=drain_path, health_path=health_path,
                  health_vectorized_path=health_vec, nifti_path=nifti_path,
                  flop_count_path=flop_path, tools_path=tools_path,
                  resnet18_config4=models_path["resnet"],
                  resnet18_config4_count=models_path["resnet_count"],
                  fused_groupnorm=models_path["fused_groupnorm"],
                  multinet_config5=models_path["multinet"], native_examples_path=native_path,
                  mesh_path=mesh_path, sharded_path=sharded_path,
                  device=kind,
                  power=smi, kernels=kernels)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=2)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
