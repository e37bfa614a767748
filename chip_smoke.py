#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elephas_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the process exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. build: ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` compiled with
   ``nvcc`` for ``sm_90a``, one ``nvcc`` each, both at once; ptxas's
   registers and spills per kernel, and from ``cuobjdump -sass`` the
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions of each
   kernel instantiation: every kernel, K1-K3 in bf16 and in float32 (split
   tf32), runs on wgmma fed by TMA, and the run fails if an instantiation
   has none of either (``required_ops``);
3. kernels: the flash-attention forward (K1) against its plain PyTorch
   version (``blockwise_reference``), then the backward kernels (K2 dq,
   K3 dk/dv) against theirs (``flash_backward_reference``, on K1's o and
   lse and a seeded dO; by max error and by norm, over each output and
   each 64-row block), on the card, at the LM's shape in float32 and
   bf16, at head_dim 64 and 128 and at a 37-token sequence, causal and
   full, the plain versions at each kernel's own tiling
   (``attention_cuda.kernel_tiles``); each timed at the LM's shape beside
   its plain version and one PyTorch call
   (``F.scaled_dot_product_attention`` and its backward: the yardsticks,
   never called by the port) and printed with its bound (each float32
   kernel also with the split-tf32 tensor-core bound, ``bound_tc_ms``), the floor the
   exponentials set (one per valid score, 16 a clock per SM at the card's
   maximum SM clock) and the card's clock, power draw and temperature;
4. inference: the Transformer LM at the registry's full width
   (``get_model("transformer_lm")``, random weights from a NumPy seed) —
   scoring forwards of 8 x 2048 tokens in float32 and bf16 through K1,
   checked against the dense-attention model, then greedy and sampled
   ``generate`` on 8 ragged prompts, two rows of the greedy stream checked
   against the same port on the CPU; a ``torch.profiler`` kernel breakdown
   of one scoring forward per dtype and of one greedy ``generate``;
5. training: the same LM through ``make_train_step`` (Adam, lr 1e-3) on
   a seeded 8 x 2048 batch — float32 and bf16 loss and gradients through
   K1-K3 checked against the dense-attention model, then 20 steps in float32
   and in bf16 (loss falls, stays finite, exactly 4 launches of each
   kernel per step), train tokens/s, MFU and a kernel breakdown of one
   step per dtype;
5b. the sequence-parallel phase (``seq_parallel_phase``): the ring's hop
   modes here at (8, 8, 512, 32) in float32 and bf16 (K1 full with the
   lse, K2/K3 given a global lse and delta) against the plain versions,
   timed beside their bounds and SDPA; then four ranks of this script
   (``--seq-rank``) on cuda:0 in one gloo group (NCCL refuses two ranks
   on one GPU; the ring's hops cross the host, counted in bytes): ring
   and Ulysses attention at (8, 8, 2048, 32) against single-process
   ``flash_attention``, 3 Adam steps of the full-width LM with
   ``attention='ring'``, ``'ulysses'`` and ``'auto'`` on a seq mesh of 4
   against the single-process flash model (losses, first gradients; 40
   launches of each kernel a step over the ranks for the ring, 16 for
   Ulysses), and a data 2 x seq 2 ``SeqParallelTrainer.fit`` with
   validation (the loss falls, one ``val_loss``, one history on every
   rank); each rank's step ms and staged bytes;
5c. the tensor-parallel phase (``tensor_parallel_phase``): K1-K3 at the
   shards' head counts ((8, 2, 2048, 32) and (4, 4, 2048, 32), causal,
   float32 and bf16) against their plain versions, timed with their
   bounds; then four ranks of this script (``--tp-rank``) on cuda:0 in one
   gloo group: the full-width LM sharded by ``LM_RULES`` on data 1 x model
   4 in float32 and bf16 (3 Adam steps against the single-process flash
   model: losses, first gathered gradients; 16 launches of each kernel a
   step over the ranks; replicated parameters equal to the bit on every
   rank; a checkpoint restored into one process equal to the gathered
   state), data 2 x model 2, sp x tp on data 1 x seq 2 x model 2 with the
   ring (24 a step) and Ulysses (16) and a ``SeqParallelTrainer(rules=
   LM_RULES).fit`` with validation, and ``shard_serving`` over model 4
   against the single-process engine (greedy streams up to near-ties, new
   tokens/s, ITL); each rank's step ms and tensor-parallel bytes;
6. the ResNet phase (``resnet_phase``), the paper's main path: the
   CIFAR-10 ResNet-18 at full width, one train step on the card in
   float64, float32 and bf16 against the port's CPU path, the bf16
   train-step throughput over a batch sweep and f32 at the best batch
   (samples/s, MFU, a kernel breakdown), then
   ``SparkModel(mode="synchronous").fit``, ``evaluate`` and ``predict``
   on the synthetic CIFAR-10 set, launching no flash kernel;
7. the repair checks (``repair_phase``): ``flash_attention`` runs the
   kernels on every CUDA input, each held against the plain version: a
   head_dim 16 LM trained against the dense one (K1-K3 at head_dim 32
   on zero-padded columns), head_dim 16 and 80, float16 and float64
   (the float32 kernels), a strided view, 65600 (batch, head) pairs and
   a caller's block sizes; head_dim 16 timed against SDPA;
8. the serving phase (``serving_phase``): ``InferenceEngine`` serving
   the full-width LM in float32 from the default paged pool (64-column
   blocks, prefix cache, 128-token prefill chunks at 2 a step, the
   pipelined scheduler, the decode step one captured CUDA graph) to 48
   seeded requests, a quarter sharing a 256-token system prompt: the
   greedy streams against the contiguous pool, the sync scheduler and
   one-shot prefill, sampled streams (temperature 0.8, top-k 40) across
   paged/contiguous and pipelined/sync and inside the teacher-forced
   top-40, three requests against the port's CPU engine, one build of
   each program, the pool's invariants and addresses, no flash launch,
   no blocking read outside ``serving/host_sync.py`` and a staged read
   that waits for its own launch only; then requests/s,
   new tokens/s, TTFT and ITL at p50 and p99, the decode step's time as a
   graph replay and eagerly, its kernels, and a kernel breakdown of 50
   serving steps with the card's busy share;
9. the async phase (``async_phase``): ``SparkModel(mode="asynchronous")``
   and ``"hogwild"`` — Downpour SGD against the parameter server, a
   ``ParameterBuffer`` on the card, with several worker threads on
   cuda:0, each on its own stream: the MNIST CNN (4 workers, local
   server; loss, per-epoch validation, every locked push applied,
   evaluate and predict), one worker on the card against the CPU, the
   socket and HTTP servers with the comms pipeline off (held to the
   accuracy bar) and on (every push applied, the server at the start
   minus their sum; accuracy printed), socket against local to the bit,
   and the local comms pipeline on against off, the
   full-width ResNet-18 hogwild in both granularities with the applied
   share, samples/s with 1 and 4 workers beside the synchronous fit at
   the same global batch, pull and push ms from the ``async/*`` spans, a
   kernel breakdown of one epoch, and no flash launch;
9b. the multi-process async phase (``async_multiproc_phase``): two ranks
   of this script (``--async-rank``) on cuda:0 in one gloo group, two
   worker threads each, one parameter server on rank 0: the MNIST CNN
   asynchronous over socket, hogwild over HTTP (autotuned) and hogwild
   over HTTP streamed, 2 epochs each; the same weights, history,
   validation, predictions and evaluation on both ranks, the server's
   version equal to every rank's pushes and its weights the start minus
   the deltas its tree holds (``ApplyChain``), the job-wide history, a
   client without the job's key refused, rank 0's autotune choice on
   both; then rank 1 killed mid-fit and rank 0's teardown barrier timing
   out; samples/s beside the in-process 4-worker fit;
9c. the ops phase (``ops_phase``): the PS endpoint of an async fit
   scraped at 10 Hz (the JAX package's document keys) with the fit's
   samples/s with and without the poller, the server killed and warm-
   restarted and the incident rebuilt from its journal; a remote
   ``/profile`` capture of the LM f32 train step whose trace names
   K1-K3, and ``/profile``'s memory against ``torch.cuda.memory_stats``;
   the serving engine's endpoint scraped while it serves;
10. the estimator phase (``estimator_phase``), BASELINE config 3: the
   registry's full-width LSTM (2,691,842 parameters), one f32 Adam step
   on the card against the CPU, then ``ElephasEstimator.fit`` on the
   synthetic IMDB DataFrame (8192 rows of 200 tokens, 3 epochs at batch
   32) and ``transform`` of 2048 held-out rows (accuracy above 0.7), one
   epoch in the default asynchronous mode, the transformer, the
   ``SparkModel`` and the estimator saved and loaded (the card's payload
   also on the CPU), a fit resumed from its epoch-1 checkpoint against
   the uninterrupted one, the bare train step's samples/s at batch 32,
   256 and 1024 and a kernel breakdown; no flash launch;
11. the search phase (``search_phase``), BASELINE config 5: the masked
   MLP (``mlp_masked``, width 100 in bucket 128) against the plain one at
   width 100 (logits, loss, live gradients; padded entries exactly still
   under Adam and under hogwild), then ``HyperParamModel.minimize`` at
   parity.py's full size (16 TPE trials of ``mlp_masked`` at buckets 128
   and 256 on 4096 synthetic MNIST rows, 2 epochs at batch 64; every
   sample equal to TPE replayed on the card's losses; steady-state
   trials/s and samples/s, first against steady trial seconds, the busy
   share of one trial), then the elastic ASHA tuner (``run_search``, 9
   trials through ``SparkModel(mode="asynchronous")``, 2 pool workers on
   cuda:0) clean, with one worker, and with a worker killed over a
   ``GroupVault``: no trial lost, the budget saved, the killed run's
   digests equal to the one-worker run's; no flash launch;
12. the fit-slice phase (``fit_slice_phase``), the sync fit's autotune
   and streamed epochs: train steps eagerly and captured as one CUDA
   graph equal to the bit (the ResNet-18 in float32 and bf16, the masked
   MLP under a scheduled Adam at two widths through one graph, the CNN
   with re-seeded dropout), the autotune A/B table, autotuned fits
   beside plain ones (the ResNet-18 and config 2's async CNN), the
   ResNet-18 streamed on 50,000 rows beside the resident fit (the
   streamed data on the card within 3 chunks), the async CNN streamed,
   the ``GroupVault`` and ``HyperParamModel`` repairs, the epoch spans;
   no flash launch;
13. a JSON line with each kernel's launches on the paths, errors, times
   and bound;
14. the last line: ``{"ok": true, "device": {...}}``.

Needs a CUDA device, ``nvcc`` and this repository; exits non-zero without
them. Imports nothing of JAX.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

# cuBLAS is deterministic across streams only with a fixed workspace; the
# search phase's ASHA runs need it (torch.use_deterministic_algorithms)
# and it must be set before CUDA starts. ":4096:8" is Hopper's default size.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SEED = 0
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
BATCH, SEQ = 8, 2048          # scoring batch: the LM's full context
NEW_TOKENS = 128
PROMPT_LENS = np.linspace(128, 1024, 8).astype(int)
CPU_ROWS = (0, 1)             # greedy rows re-run on the CPU
MARGIN = 1e-3                 # top-2 logit gap below which a tie may flip

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # (O, lse)
# K2/K3: max |error| <= tol * max(1, max |reference|), per output.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2/K3: ||error|| <= tol * ||reference||, per output and per 64-row block
# of each (batch, head): the late rows and keys of a causal sequence carry
# gradients far below the early ones' max, which the max-abs limit misses.
TOL_BWD_NORM = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_STEPS, TRAIN_WARMUP = 20, 2  # steps per dtype; untimed leading steps
LOSS_DROP = 2.0                    # the loss falls by at least this over the steps
GRAD_RTOL = 1e-3                   # flash vs dense f32 grads, relative to each max
LOSS_ATOL = 1e-4                   # flash vs dense f32 loss
BF16_GRAD_RTOL = 5e-2              # flash vs dense bf16 grads, by norm, per parameter
BF16_LOSS_ATOL = 1e-2              # flash vs dense bf16 loss

# ResNet phase (CIFAR-10 ResNet-18 at full width, width 64, 10 classes).
RESNET_CPU_BATCH = 64              # the card's step against the port's CPU path
RESNET_SWEEP = (256, 512, 1024, 2048)
RESNET_WARMUP, RESNET_STEPS = 5, 20
FIT_TRAIN, FIT_TEST, FIT_EPOCHS = 16384, 2048, 3
FIT_MIN_VAL_ACC = 0.2
# The checked fit takes the sweep's fastest batch of those that give at
# least this many steps an epoch. At batch 2048 (8 steps an epoch, 24 in
# all, at lr 0.1) the eval-mode accuracy stays near chance in float32 as
# in bf16 (scripts/torch_fit_witness.py: held-out accuracy 0.10-0.29
# over 3 seeds each, the loss rising in 3 of the 6 fits) while the same
# weights score 0.88 with batch statistics and 0.86-0.89 once the
# running statistics are recalibrated: they lag the weights, and bf16 is
# not the cause. At 1024 every fit of the 6 trained (held-out accuracy
# 0.53-0.84). The fastest batch's fit still runs, and its history and
# rate are printed, not held.
FIT_MIN_STEPS = 16
# One train step on the card against the same step on the CPU, same
# weights and batch: loss relative; logits and running statistics by max
# |error| over max(1, max |reference|); gradients and the parameters'
# change by ||error|| / ||reference|| per tensor ("grads", "update") and
# over all tensors ("grads_all", "update_all"). These limits were written
# before the first run; they hold the float64 step on the card against the
# CPU's whole, and the float32 steps' loss, logits and statistics.
RESNET_F32_LIMITS = {"loss": 1e-4, "logits": 1e-3, "stats": 1e-5, "grads": 1e-3,
                     "grads_all": 1e-3, "update": 1e-3, "update_all": 1e-3}
# The float32 gradients at initialisation are ill-conditioned: sums over
# 64 x H x W positions that nearly cancel (a BatchNorm's bias gradient
# above all) leave the CPU's own float32 step 4e-3 from its float64 one
# over all tensors, so two float32 steps cannot agree to 1e-3 (the first
# run's card read 3.3e-3 against the CPU). Each float32 step, the card's
# and the CPU's, is held against the float64 step instead, at limits set
# after that run (PERF.md, PR 6).
RESNET_F32_GRAD_LIMITS = {"grads": 5e-2, "grads_all": 2e-2, "update": 5e-2,
                          "update_all": 2e-2}
# One bf16 step on the card against that f32 CPU step. bf16 activations
# move a ResNet's gradients at initialisation by about a third of their
# norm (0.32 over all tensors at this batch with the port's bf16 on the
# CPU; the JAX package's bf16 step sits as far from its f32 one), and a
# small tensor's (a norm's bias) by more than its norm, so the gradients
# and the update are held over all tensors only.
RESNET_BF16_LIMITS = {"loss": 1e-2, "logits": 1e-1, "stats": 1e-2, "grads_all": 0.6,
                      "update_all": 0.6}
REPAIR_LOSS_ATOL, REPAIR_GRAD_RTOL = 1e-4, 1e-3  # head_dim 16 LM, flash vs dense f32
# float16 inputs run the float32 kernels and round their results to
# float16, as the plain version does: one float16 rounding (2^-11 of the
# value) either side, relative to max(1, max |reference|).
REPAIR_F16_LIMITS = {"o": 2e-3, "grads": 2e-3}

# Serving phase: the registry's full-width LM behind InferenceEngine.
# The KV pool is 16 slots x 1024 columns x 4 layers x (K, V) x 8 heads x
# 32 x 4 B = 134 MB.
SERVE_ENGINE = {"max_slots": 16, "max_prompt_len": 512, "max_len": 1024,
                "queue_depth": 64, "kv_block_size": 64, "prefill_chunk": 128,
                "prefill_chunks_per_step": 2, "prefix_cache": True}
SERVE_REQUESTS = 48
SERVE_PROMPT_LENS = (64, 512)      # inclusive
SERVE_NEW_TOKENS = (64, 128)       # inclusive
SERVE_PREFIX = 256                 # system prompt of every 4th request
SERVE_SAMPLING = {"temperature": 0.8, "top_k": 40, "seed": 5}
SERVE_CPU_REQUESTS = (1, 2, 3)     # served again by the CPU engine, 2 slots
SERVE_STEPS = 50                   # decode steps timed and profiled
SERVE_SLEEP_CYCLES = 200_000_000   # ~0.1 s of a spinning kernel at 1.98 GHz
# A sampled token's teacher-forced logit may sit this far under the 40th
# largest: the teacher-forced full forward and the cache path differ in
# the last bits.
SERVE_TOP_K_SLACK = 1e-4

# Async phase: Downpour SGD against the parameter server on the card,
# several workers on cuda:0, each on its own stream.
ASYNC_WORKERS = 4
ASYNC_CNN_ROWS = (8192, 2048)      # synthetic_mnist train, test (BASELINE config 2)
ASYNC_CNN_EPOCHS, ASYNC_CNN_BATCH = 3, 64
# 4 workers each pushing a whole epoch of Adam steps overshoot: on the
# CPU this config ended at val_acc 0.16-0.70 over 5 port runs and
# 0.61-0.79 over 5 JAX-package runs (chance 0.10). Held above this, set
# before the first card run.
ASYNC_MIN_VAL_ACC = 0.15
# The locked server's final weights against the start minus the float64
# sum of the 12 pushed deltas, by norm over all tensors: 12 float32
# subtractions round to a few 1e-8 of the weights.
ASYNC_SUM_LIMIT = 1e-6
# One worker, batch frequency, 1 epoch of this many rows (16 pushes), on
# the card and on the CPU from the same weights and row order. On the
# CPU a 1e-7 relative perturbation of the start moved the final weights
# by 2-5e-6 of their norm over 1-16 pushes (and by 0.11 over 64, where
# Adam's near-sign updates go chaotic), so 16. Limits (set before the
# first card run, f32, TF32 off): the final weights by ||card - cpu|| /
# ||cpu|| over all tensors, the epoch's loss relative.
ASYNC_CPU_ROWS = 1024
ASYNC_CPU_LIMITS = {"weights_all": 1e-3, "loss": 1e-4}
# Transports: 2 workers, batch frequency, 1 epoch over the 8192 rows.
# The CPU runs ended at evaluate acc 0.37-0.84 (6 runs); held above
# this and under the untrained loss ln 10, with the comms pipeline off:
# on the H100 (700 W) 16 such fits ended at acc 0.893-0.900, while the
# pipelined ones spread over 0.26-0.74 and the local server's pipelined
# ones over 0.18-0.70 (scripts/torch_async_wire_repeat.py, PERF.md §6).
ASYNC_WIRE_WORKERS, ASYNC_WIRE_MIN_ACC, ASYNC_WIRE_MAX_LOSS = 2, 0.2, float(np.log(10.0))
ASYNC_BITWISE_ROWS = 1024          # socket vs local, 1 worker, unpipelined
# ResNet-18 hogwild (BASELINE config 4): full width, bf16, batch 256 per
# worker, plain SGD at lr 0.05. The reference config's momentum 0.9 at lr
# 0.05 (parity.py) diverges with 4 workers at batch frequency (on the
# H100, val_acc 0.10-0.16 after 2 epochs, in 'tree' and 'leaf'): each
# worker pushes lr times its own momentum trace while the others' pushes
# land in between, so staleness adds momentum on top of momentum. SGD at
# the same lr reached 0.86 and momentum at lr / 4 0.88 (PERF.md §6).
HOGWILD_ROWS = (16384, 2048)       # synthetic_cifar10 train, test
HOGWILD_EPOCHS, HOGWILD_BATCH = 2, 256
HOGWILD_OPTIMIZER = {"name": "sgd", "learning_rate": 0.05}

# Estimator phase (BASELINE config 3): the registry's full-width LSTM
# (2,691,842 parameters) on synthetic IMDB, through ElephasEstimator at
# parity.py's settings, then serialization and a checkpoint resume.
IMDB_ROWS, IMDB_MAXLEN = (8192, 2048), 200
LSTM_WIDTH = {"vocab_size": 20000, "embed_dim": 128, "hidden_dim": 128, "num_classes": 2}
LSTM_PARAMS = 2_691_842
IMDB_BATCH, IMDB_EPOCHS = 32, 3
IMDB_ADAM = {"name": "adam", "learning_rate": 1e-3}
IMDB_MIN_ACC = 0.7                  # examples/imdb_lstm_estimator.py's bar
# One f32 Adam step on the card against the CPU port, same seeded weights
# and batch, TF32 off (set before the first card run): logits max |error|,
# loss relative, each gradient and each parameter after the step by
# ||error|| / ||cpu|| (the worst tensor).
LSTM_CPU_LIMITS = {"logits": 1e-4, "loss": 1e-5, "grads": 1e-3, "params": 1e-4}
LSTM_SWEEP = (32, 256, 1024)        # the bare train step's batches
LSTM_WARMUP, LSTM_STEPS = 5, 30
IMDB_CPU_ROWS = 512                 # the card's payload predicted on the CPU
IMDB_PAYLOAD_LIMIT = 1e-4           # card vs CPU outputs, absolute
IMDB_RELOAD_LIMIT = 1e-6            # reloaded on the card, deterministic cuDNN
IMDB_RESUME_LIMIT = 1e-6            # resumed vs uninterrupted, by norm over all tensors

# Search phase (BASELINE config 5, parity.py's hyperparam_search at full
# size): mlp_masked trials on synthetic MNIST through HyperParamModel, then
# the elastic ASHA tuner (examples/asha_search.py's setup) clean and under
# a worker kill. Limits set before the first card run.
SEARCH_ROWS = (4096, 1024)          # load_mnist train rows, held-out rows
SEARCH_BUCKETS = (128, 256)
SEARCH_WIDTHS = (64, 128, 256)
SEARCH_LR = (1e-4, 1e-2)            # hp.loguniform(log lo, log hi)
SEARCH_EPOCHS, SEARCH_BATCH = 2, 64
SEARCH_EVALS = 16                   # max_evals, TPE, seed 0
SEARCH_MIN_VAL_ACC = 0.6            # chance (0.1) plus the margin of PERF.md §6
MASKED_CHECK = (128, 100)           # (bucket, active): held against mlp at width 100
MASKED_LIMIT = 1e-5                 # logits, loss, live gradients, by norm
ASHA_SPACE = {"lr": (1e-4, 1e-1), "width": (32, 64, 128), "batch_size": (32, 64)}
ASHA_BUCKETS = (128,)               # one bucket: every trial's state has one shape
ASHA_TRIALS, ASHA_ETA, ASHA_RUNGS, ASHA_R0, ASHA_WORKERS = 9, 3, 3, 1, 2
ASHA_KILL = {"w1": 1}               # w1 dies at its second unit
ASHA_MIN_SAVED = 0.4                # examples/asha_search.py's bar

# Fit-slice phase: the sync fit's autotune (the eager step against the
# same step captured as one CUDA graph), streamed epochs, the epoch
# loop's spans, and the two repairs, at full width.
CAPTURE_STEPS = 8                   # eager vs captured: 3 warm-up steps, then the graph
CAPTURE_BATCH = 256                 # the ResNet-18's, f32 and bf16
CAPTURE_MASKED = (128, (100, 64))   # mlp_masked bucket and the widths one graph serves
CAPTURE_COSINE = {"schedule": "cosine_decay", "init_value": 1e-3, "decay_steps": 16}
CAPTURE_CNN_BATCH, CAPTURE_DROPOUT = 64, 0.5
AB_RESNET_BATCHES = (256, 2048)     # the A/B table's bf16 ResNet-18 batches
AB_MASKED_BATCH, AB_LSTM_BATCH, AB_CNN_BATCH = 64, 32, 64
STREAM_ROWS, STREAM_BATCH, STREAM_CHUNK, STREAM_EPOCHS = 50_000, 1024, 4, 2
# 3 chunks of 4 batches of 1024 rows of 32 x 32 x 3 f32 features and 10
# f32 one-hot labels (12,328 B a row): 151,486,464 B.
STREAM_RESIDENCY_LIMIT = 3 * STREAM_CHUNK * STREAM_BATCH * (32 * 32 * 3 + 10) * 4
STREAM_SLOW_CYCLES = 400_000_000    # a chunk's device delay: 0.2 s at 2 GHz

# Chaos phase: the async path's resilience (BASELINE configs 2 and 4):
# AsyncTrainer(elastic=True) on config 2's CNN at the async phase's
# settings (ASYNC_CNN_*), 4 pool workers on cuda:0 over 4 partitions, a
# socket server with a write-ahead log; seeded chaos; the sharded group
# with hot standbys on config 4's ResNet-18 tree. The gates are exact
# (units, deaths, digests, bitwise WAL frames and promotions) and the
# async phase's accuracy bar; the final loss beside the undisturbed fit's
# (the JAX package's 0.02) is printed, not held: a 4-worker async CNN
# ends anywhere in val_acc 0.16-0.79 on the CPU (the CPU tests hold the
# 0.02 on the blobs MLP).
CHAOS_WORKERS = 4
CHAOS_UNITS = CHAOS_WORKERS * ASYNC_CNN_EPOCHS  # (epoch, partition) units
CHAOS_KILL_PLAN = {"seed": 11, "kill_worker_at": {"w1": 0}, "stall_worker_at": {"w0": 0},
                   "stall_seconds": 0.4}
CHAOS_PARTITION_PLAN = {"seed": 23, "partition": {"*": (6, 14)}}
CHAOS_KILL_VERSION = 3             # the server dies once the buffer reaches this
CHAOS_OUTAGE_S = 4.0               # held down past the client's ~2.8 s retry budget
CHAOS_GRACE_S = 30.0               # ps_recovery_grace
CHAOS_LOSS_TOL = 0.02              # printed beside the baseline, not held
CHAOS_BATCHES_PER_UNIT = 4
CHAOS_GROUP = {"k": 2, "standby": 1, "suspect_after": 0.5}
CHAOS_MONITOR_S = 0.2              # ShardGroup.start_monitor's interval
CHAOS_GROUP_PUSHES = 8
RESNET_PARAMS = 11_173_962
WAL_KEEP = 3                       # the servers' default: the pinned-pull window

# Sequence-parallel phase: ring and Ulysses attention (K1-K3 per hop and at
# full length) and the data x seq SeqParallelTrainer on the full-width LM,
# in SP_RANKS processes that share cuda:0 in one gloo group: NCCL refuses
# two ranks on one GPU, and gloo's send/recv take no CUDA tensors, so the
# ring's hops cross the host (parallel/collectives.py, counted in bytes;
# scripts/torch_gloo_cuda_probe.py). Its times say nothing of NCCL
# sequence parallelism across cards.
SP_RANKS = 4
SP_HOP = (BATCH, 8, SEQ // SP_RANKS, 32)   # one ring hop at n = SP_RANKS
SP_STEPS = 3                               # Adam steps per layout
SP_LOSS_RTOL = 1e-4                        # vs the single-process flash model, each step
# Against single-process flash_attention: max |error| <= tol * max(1, max
# |reference|) in float32; bf16 O within an absolute 2e-2 (K1's oracle),
# its gradients within 3e-2 * max(1, max |reference|) (K2/K3's).
SP_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)}  # (O, gradients)
SP_FIT = {"rows": 32, "val_rows": 8, "batch_size": 8, "epochs": 1}  # data 2 x seq 2
SP_TIMEOUT_S = 600

# Tensor-parallel phase: the full-width LM with its parameters sharded over
# a model axis (parallel/tensor_parallel.py, LM_RULES), in TP_RANKS
# processes that share cuda:0 in one gloo group, as the seq-parallel phase.
# Each rank runs K1-K3 on its own heads; the model group's all-reduces of
# the (batch, seq, d_model) activations cross the host inside gloo. Its
# times say nothing of NCCL tensor parallelism across cards.
TP_RANKS = 4
TP_STEPS = 3                               # Adam steps per layout
TP_SHAPES = ((BATCH, 8 // TP_RANKS, SEQ, 32),       # data 1 x model 4: 2 heads a rank;
                                                    # sp x tp Ulysses after its all_to_all
             (BATCH // 2, 8 // 2, SEQ, 32))         # data 2 x model 2: 4 heads, 4 rows
TP_HOP = (BATCH, 8 // 2, SEQ // 2, 32)      # sp x tp ring: a hop of 4 heads at seq 2
TP_SERVE_REQUESTS = 16                     # of serving_traffic(), sharded over model 4
TP_TIMEOUT_S = 600

# async_multiproc phase: SparkModel's asynchronous and hogwild fits across
# MP_RANKS processes of this script on cuda:0 in one gloo group, which
# carries the control plane only (the PS address and key, the autotune
# broadcast, the history allgather): parameters travel through the one
# parameter server on rank 0, which every rank's MP_WORKERS worker
# threads dial. The MNIST CNN (config 2) at epoch frequency over
# ASYNC_CNN_ROWS, as the async phase's in-process 4-worker fit (1).
MP_RANKS, MP_WORKERS, MP_EPOCHS = 2, 2, 2
MP_FITS = {  # name: (mode, transport, stream_batches, autotune)
    "async_socket": ("asynchronous", "socket", None, False),
    "hogwild_http": ("hogwild", "http", None, True),
    "hogwild_http_streamed": ("hogwild", "http", 4, False),
}
MP_PREDICT_ROWS = 512
MP_BARRIER_TIMEOUT_S = 12          # ELEPHAS_BARRIER_TIMEOUT of the peer-death run
MP_TIMEOUT_S = 300

# ops phase: the endpoints of the PS, a trainer and the serving engine.
# Each route's top-level document keys, as the JAX package's OpsServer
# answers them (tests/test_torch_opsd.py and test_torch_ops_mounts.py
# hold the port's to the JAX package's on the CPU).
OPS_POLL_S = 0.1                   # the poller's period: 10 Hz
OPS_PS_KEYS = {
    "/healthz": ["membership", "status", "uptime_s"],
    "/vars": ["boot", "ops_host", "ops_port", "pid", "ps_host", "ps_port", "transport",
              "version"],
    "/meta": ["boot", "ops_host", "ops_port", "pid", "role", "routes", "worker_id"],
    "/workers": ["lag_p50", "lag_p95", "lag_p99", "total_updates", "unstamped_updates",
                 "window_samples", "workers"],
    "/history?window=5": ["capacity", "period_s", "series", "ticks", "window_s"],
    "/trace": ["clockSync", "displayTimeUnit", "droppedSpans", "traceEvents"],
    "/incidents": ["meta", "recent"],
}
OPS_SERVING_KEYS = {
    "/load": ["observations", "rate_window_s", "raw", "score", "signals", "tau_s"],
    "/slo": ["burn", "evaluated", "goodput", "goodput_ratio", "objectives", "windows"],
    "/tenants": ["alerts", "kv_share", "tenants", "totals"],
    "/alerts": ["active", "fired", "fired_kinds", "rules"],
}
OPS_PROFILE_STEPS = 3              # LM f32 train steps inside the capture
OPS_TRACE_KERNELS = {"flash_fwd": "flash_fwd_f32", "flash_dq": "flash_dq_f32",
                     "flash_dkv": "flash_dkv_f32"}
WAL_COST_EVERY, WAL_COST_PUSHES = (1, 8), 16


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops, nbytes, dtype):
    """Least time (ms) for the work: operations over the dtype's peak, and
    each input read once and each output written once over memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_work(shape, itemsize, causal):
    """FLOPs and bytes of each kernel at ``shape`` (B, H, S, D), from the
    Pallas kernels' CostEstimates: K1 2·B·H·S²·D FLOPs causal (4 full),
    reading q, k, v and writing o and lse; K2 3 (6) and K3 4 (8), both
    reading q, k, v, dO, lse and delta, K2 writing dq and K3 dk and dv."""
    b, h, s, d = shape
    flops = (1.0 if causal else 2.0) * b * h * s * s * d
    tensor, rows = b * h * s * d * itemsize, 4.0 * b * h * s
    return {"flash_fwd": (2 * flops, 4 * tensor + rows),
            "flash_dq": (3 * flops, 5 * tensor + 2 * rows),
            "flash_dkv": (4 * flops, 6 * tensor + 2 * rows)}


def split_tf32_bound_ms(flops, nbytes):
    """A float32 kernel on tf32 tensor cores in split tf32: three products
    for each of its FLOPs over the tf32 peak, or its bytes over the memory
    rate."""
    return max(3 * flops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3


def exp_floor_ms(shape, causal, sms, clock_mhz):
    """Least time (ms) the special-function units take for the kernel's
    exponentials: one per valid score element, 16 per clock per SM."""
    b, h, s, _ = shape
    valid = b * h * (s * (s + 1) / 2 if causal else s * s)
    return valid / (16.0 * sms * clock_mhz * 1e6) * 1e3


def smi(fields):
    """The card's ``nvidia-smi`` values of ``fields`` (comma-separated), as
    printed (units included)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sass_counts(lib, cuobjdump):
    """``HGMMA`` and ``UTMALDG`` instructions per kernel instantiation in
    the library's SASS (``cuobjdump -sass``)."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        entry = re.search(r"Function : \S*?(flash_[a-z]+)_(bf16|f32)_kernelILi(\d+)E", line)
        if entry:
            name = f"{entry.group(1)} {entry.group(2)} D={entry.group(3)}"
            counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += line.count(op)
    return counts


def required_ops(instance):
    """SASS instructions the instantiation ``instance`` (``"flash_fwd f32
    D=32"``) must hold: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load), as
    every kernel, K1-K3 in bf16 and in float32, is built for Hopper."""
    name, dtype, _ = instance.split()
    if name not in ("flash_fwd", "flash_dq", "flash_dkv") or dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown kernel instantiation {instance!r}")
    return ("HGMMA", "UTMALDG")


def ptxas_summary(log):
    """Registers and spills per kernel instantiation from nvcc's -Xptxas -v."""
    parts, name = [], None
    for line in log.splitlines():
        entry = re.search(r"(flash_[a-z]+)_(bf16|f32)_kernelILi(\d+)E", line)
        if "Compiling entry function" in line and entry:
            name = f"{entry.group(1)} {entry.group(2)} D={entry.group(3)}"
            spill = "spills not reported"
        elif name and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            parts.append(f"{name}: {regs} registers, {spill}")
            name = None
    return "; ".join(parts)


def device_breakdown(fn, top=6):
    """Kernel time by name over one call of ``fn`` under torch.profiler,
    beside the call's wall time (which includes the profiler's cost), and
    each flash kernel's total. User annotations (the optimizer's
    ``Optimizer.step`` range) are left out: their device time is that of
    the kernels inside them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_" in e.key) / 1e3 for name in KERNELS}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "flash_ms": flash_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def norm_errors(got, ref, rows=64):
    """||got - ref|| / ||ref|| over the whole tensor, and the largest over
    blocks of ``rows`` rows of each (batch, head) of a (B, H, S, D) pair."""
    got, ref = got.float(), ref.float()
    whole = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % rows)
    diff = F.pad(got - ref, pad).reshape(b, h, -1, rows * d)
    ref = F.pad(ref, pad).reshape(b, h, -1, rows * d)
    block = (diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    return whole, block


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def kernel_case(attention_cuda, shape, causal, dtype, gen, timed=False):
    """K1 against ``blockwise_reference`` and K2/K3 against
    ``flash_backward_reference`` at one case, the plain versions at each
    kernel's own tiling (a disagreement raises). Returns each kernel's max
    error, K2's and K3's worst norm errors (whole, worst 64-row block)
    and, ``timed``, each kernel's timing beside its plain version, SDPA
    and its bounds."""
    from elephas_tpu_torch.ops.attention import (
        blockwise_reference,
        flash_backward_reference,
    )

    tiles = {name: attention_cuda.kernel_tiles(name, dtype, shape[3]) for name in KERNELS}
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    o, lse = attention_cuda.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = attention_cuda.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = attention_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = blockwise_reference(q, k, v, causal, *tiles["flash_fwd"])
    err_o = (o.float() - ref_o.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    tol_o, tol_lse = TOL[dtype]
    print(f"kernel {tuple(shape)} causal={causal} {dtype}: "
          f"max|dO|={err_o:.3e} (atol {tol_o}) max|dlse|={err_lse:.3e} "
          f"(atol {tol_lse})", flush=True)
    check(err_o <= tol_o and err_lse <= tol_lse,
          f"flash_fwd disagrees with blockwise_reference at {shape} {dtype}")
    errors = {"flash_fwd": max(err_o, err_lse), "flash_dq": 0.0, "flash_dkv": 0.0}
    norms = {"flash_dq": [0.0, 0.0], "flash_dkv": [0.0, 0.0]}

    # K2's dq and K3's dk, dv each from the plain version at its tiling.
    ref = dict(zip(("dq", "dk", "dv"), flash_backward_reference(
        q, k, v, o, lse, do, causal, *tiles["flash_dq"])))
    if tiles["flash_dkv"] != tiles["flash_dq"]:
        ref["dk"], ref["dv"] = flash_backward_reference(
            q, k, v, o, lse, do, causal, *tiles["flash_dkv"])[1:]
    parts = []
    for name, label, got in (("flash_dq", "dq", dq), ("flash_dkv", "dk", dk),
                             ("flash_dkv", "dv", dv)):
        err = (got.float() - ref[label].float()).abs().max().item()
        allowed = TOL_BWD[dtype] * max(1.0, ref[label].float().abs().max().item())
        whole, block = norm_errors(got, ref[label])
        parts.append(f"max|d{label}|={err:.3e} (allowed {allowed:.3e}) "
                     f"norm {whole:.2e} worst block {block:.2e}")
        check(err <= allowed, f"{name} {label} disagrees with "
              f"flash_backward_reference at {shape} causal={causal} {dtype}")
        check(max(whole, block) <= TOL_BWD_NORM[dtype],
              f"{name} {label} norm error {whole:.2e} (worst block {block:.2e}) "
              f"above {TOL_BWD_NORM[dtype]} at {shape} causal={causal} {dtype}")
        errors[name] = max(errors[name], err)
        norms[name] = [max(norms[name][0], whole), max(norms[name][1], block)]
    print(f"kernel bwd {tuple(shape)} causal={causal} {dtype}: " + "; ".join(parts)
          + f" (norm limit {TOL_BWD_NORM[dtype]})", flush=True)
    if not timed:
        return errors, norms, None

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock = float(smi("clocks.max.sm").split()[0])
    work = kernel_work(shape, q.element_size(), causal)
    bounds = {name: bound_ms(*work[name], dtype) for name in KERNELS}
    exp_floor = exp_floor_ms(shape, causal, sms, max_clock)
    timing = {"flash_fwd": {
        "ms": cuda_ms(lambda: attention_cuda.flash_fwd(q, k, v, causal), 20),
        "plain_ms": cuda_ms(lambda: blockwise_reference(
            q, k, v, causal, *tiles["flash_fwd"]), 3, 1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20),
    }}
    # The plain version and SDPA's backward each compute dq, dk and
    # dv together; SDPA's forward runs once, outside the timing.
    plain_ms = cuda_ms(lambda: flash_backward_reference(
        q, k, v, o, lse, do, causal, *tiles["flash_dkv"]), 3, 1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 20)
    launch = {
        "flash_dq": lambda: attention_cuda.flash_bwd_dq(
            q, k, v, do, lse, delta, causal),
        "flash_dkv": lambda: attention_cuda.flash_bwd_dkv(
            q, k, v, do, lse, delta, causal),
    }
    for name, fn in launch.items():
        timing[name] = {"ms": cuda_ms(fn, 20), "plain_ms": plain_ms,
                        "library_ms": library_ms}
    for name in KERNELS:
        bound, by = bounds[name]
        timing[name].update(bound_ms=bound, bound_by=by, exp_floor_ms=exp_floor)
        if dtype == torch.float32:
            timing[name]["bound_tc_ms"] = split_tf32_bound_ms(*work[name])
    print(f"card during the timings ({dtype}): "
          f"{smi('clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu')} "
          "(clocks.sm, clocks.max.sm, power.draw, power.limit, temperature.gpu)",
          flush=True)
    for name in KERNELS:
        print(f"timing {name} {tuple(shape)} {dtype}: "
              f"{json.dumps(timing[name])}", flush=True)
    return errors, norms, timing


def kernel_phase(attention_cuda):
    """Every kernel against its plain version at 14 cases, the plain
    version at the kernel's own tiling; times at the LM's shape. Returns
    per-kernel max errors and timings by dtype."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [((BATCH, 8, SEQ, 32), True, torch.float32),
             ((BATCH, 8, SEQ, 32), True, torch.bfloat16)]
    cases += [((2, 8, 1000, d), causal, dtype)
              for d in (64, 128) for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((3, 2, 37, 32), causal, dtype) for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    errors = {name: {torch.float32: 0.0, torch.bfloat16: 0.0} for name in KERNELS}
    norm_worst = {name: {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
                  for name in KERNELS if name != "flash_fwd"}
    timing = {name: {} for name in KERNELS}
    for shape, causal, dtype in cases:
        errs, norms, times = kernel_case(attention_cuda, shape, causal, dtype, gen,
                                         timed=shape[2] == SEQ)
        for name in KERNELS:
            errors[name][dtype] = max(errors[name][dtype], errs[name])
        for name, (whole, block) in norms.items():
            worst = norm_worst[name][dtype]
            worst[:] = max(worst[0], whole), max(worst[1], block)
        if times is not None:
            for name in KERNELS:
                timing[name][dtype] = times[name]
    for name, by_dtype in norm_worst.items():
        for dtype, (whole, block) in by_dtype.items():
            print(f"kernel bwd {name} {dtype}: worst norm error {whole:.3e}, worst "
                  f"64-row block {block:.3e} over the cases", flush=True)
    return errors, timing


def inference_phase(attention_cuda):
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.metrics import mfu, peak_flops, transformer_flops_per_token
    from elephas_tpu_torch.models import generate, get_model

    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 32000, (BATCH, SEQ)), device="cuda")

    def compiled(**kw):
        return CompiledModel(get_model("transformer_lm", **kw),
                             loss="sparse_categorical_crossentropy",
                             metrics=["acc"], seed=SEED)

    report = {}
    flash_forwards = 0
    attention_cuda.reset_launches()
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model = compiled(attention="flash", dtype=dtype)
        layers = model.module.num_layers
        before = attention_cuda.launches["flash_fwd"]
        logits[dtype] = model.apply_eval(tokens)
        torch.cuda.synchronize()
        flash_forwards += 1
        launched = attention_cuda.launches["flash_fwd"] - before
        check(launched == layers,
              f"{dtype} forward launched flash_fwd {launched} times, expected {layers}")
        check(tuple(logits[dtype].shape) == (BATCH, SEQ, 32000)
              and bool(torch.isfinite(logits[dtype]).all()),
              f"{dtype} logits not finite or misshapen")
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            model.apply_eval(tokens)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / reps
        flash_forwards += reps
        tok_s = BATCH * SEQ / elapsed
        fpt = transformer_flops_per_token(model.count_params(), layers,
                                          model.module.d_model, SEQ)
        out = logits[dtype][:, :-1]
        report[f"profile_score_{dtype}"] = device_breakdown(
            lambda: model.apply_eval(tokens))
        flash_forwards += 1
        report[f"score_{dtype}"] = {
            "forward_ms": elapsed * 1e3,
            "tokens_per_s": tok_s,
            "mfu_vs_bf16_peak": mfu(tok_s, fpt, peak_flops()),
            "loss": float(model.loss_fn(out, tokens[:, 1:]).mean()),
            "acc": float(model.metric_fns[0](out, tokens[:, 1:]).mean()),
        }
        print(f"score {dtype}: {json.dumps(report[f'score_{dtype}'])}", flush=True)
        print(f"profile score {dtype}: "
              f"{json.dumps(report[f'profile_score_{dtype}'])}", flush=True)
        del model
    dense = compiled(attention="dense")
    err = (dense.apply_eval(tokens) - logits["float32"]).abs().max().item()
    print(f"score float32 flash vs dense: max|dlogits|={err:.3e} (atol 1e-3)")
    check(err <= 1e-3, "flash and dense float32 logits disagree")
    report["bf16_vs_f32_max_dlogits"] = (
        logits["bfloat16"] - logits["float32"]).abs().max().item()
    del dense, logits

    model = compiled(attention="flash")
    prompts = [rng.integers(1, 32000, n).tolist() for n in PROMPT_LENS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = generate(model, prompts, NEW_TOKENS)
    elapsed = time.perf_counter() - t0
    plen = int(PROMPT_LENS.max())
    check(greedy.shape == (len(prompts), plen + NEW_TOKENS)
          and ((greedy >= 0) & (greedy < 32000)).all(), "greedy stream misshapen")
    for row, p in zip(greedy, prompts):
        check(row[plen - len(p):plen].tolist() == p, "prompt not carried through")
    report["generate_greedy"] = {"s": elapsed,
                                 "new_tokens_per_s": len(prompts) * NEW_TOKENS / elapsed}
    report["profile_generate_greedy"] = device_breakdown(
        lambda: generate(model, prompts, NEW_TOKENS))
    t0 = time.perf_counter()
    sampled = generate(model, prompts, NEW_TOKENS, temperature=0.8, top_k=40, seed=1)
    report["generate_sampled"] = {"s": time.perf_counter() - t0}
    check(sampled.shape == greedy.shape
          and ((sampled >= 0) & (sampled < 32000)).all(), "sampled stream misshapen")
    check((generate(model, prompts, NEW_TOKENS, temperature=0.8, top_k=40, seed=1)
           == sampled).all(), "sampled stream not reproducible from its seed")
    launches = dict(attention_cuda.launches)
    check(launches == {"flash_fwd": flash_forwards * 4, "flash_dq": 0, "flash_dkv": 0},
          f"inference launched {launches}, expected {flash_forwards * 4} flash_fwd "
          "and no backward kernel")
    print(f"generate: {json.dumps(report['generate_greedy'])} "
          f"sampled {json.dumps(report['generate_sampled'])}", flush=True)

    # Greedy rows against the same port on the CPU, same weights: the CPU's
    # own stream up to its first step whose top-2 logit gap is below
    # MARGIN, and, teacher-forced on the GPU's stream, every step whose
    # CPU gap is at least MARGIN.
    cpu = CompiledModel(get_model("transformer_lm", device="cpu"),
                        params=model.get_weights())
    cpu_prompts = [prompts[i] for i in CPU_ROWS]
    cpu_out = generate(cpu, cpu_prompts, NEW_TOKENS)
    cpu_plen = max(len(p) for p in cpu_prompts)

    def cpu_steps(prompt, new):
        """CPU argmax and top-2 gap of each step, given prompt + new."""
        stream = torch.as_tensor(np.concatenate([prompt, new[:-1]]))[None]
        top2 = torch.topk(cpu.apply_eval(stream)[0, len(prompt) - 1:], 2, dim=-1)
        return top2.indices[:, 0].numpy(), (top2.values[:, 0] - top2.values[:, 1]).numpy()

    compared, forced = [], []
    for i, row in zip(CPU_ROWS, cpu_out):
        check(row[cpu_plen - len(prompts[i]):cpu_plen].tolist() == prompts[i],
              "CPU prompt not carried through")
        new_cpu, new_gpu = row[cpu_plen:], greedy[i, plen:]
        _, gaps = cpu_steps(prompts[i], new_cpu)
        n = int(np.argmax(gaps < MARGIN)) if (gaps < MARGIN).any() else NEW_TOKENS
        check((new_cpu[:n] == new_gpu[:n]).all(),
              f"row {i}: GPU greedy stream differs from the CPU's within the "
              f"first {n} steps")
        compared.append(n)
        best, gaps = cpu_steps(prompts[i], new_gpu)
        clear = gaps >= MARGIN
        check((best[clear] == new_gpu[clear]).all(),
              f"row {i}: a GPU greedy token is not the CPU's argmax on the "
              "GPU's own stream")
        forced.append(int(clear.sum()))
    print(f"generate: GPU greedy rows {CPU_ROWS} equal the CPU's stream over "
          f"{compared} of {NEW_TOKENS} steps (cut at top-2 gap < {MARGIN}); "
          f"teacher-forced, the GPU's token is the CPU's argmax at {forced} "
          f"steps (all with gap >= {MARGIN})", flush=True)
    report["cpu_rows_stream_steps"] = compared
    report["cpu_rows_forced_steps"] = forced
    return launches, report


def train_phase(attention_cuda):
    """LM training at full width through K1-K3: f32 loss and gradients
    against the dense model, then TRAIN_STEPS steps per dtype."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.engine.step import (
        init_train_state,
        make_loss_fn,
        make_train_step,
    )
    from elephas_tpu_torch.metrics import mfu, peak_flops, transformer_flops_per_token
    from elephas_tpu_torch.models import get_model

    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 32000, (BATCH, SEQ + 1)), device="cuda")
    x, y = tokens[:, :-1], tokens[:, 1:]

    def compiled(**kw):
        return CompiledModel(get_model("transformer_lm", **kw),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="sparse_categorical_crossentropy",
                             metrics=["acc"], seed=SEED)

    def expect_launches(before, steps, what):
        launched = {k: attention_cuda.launches[k] - before[k] for k in KERNELS}
        layers = 4
        check(launched == {k: layers * steps for k in KERNELS},
              f"{what} launched {launched}, expected {layers * steps} of each")

    report = {}
    attention_cuda.reset_launches()

    def loss_and_grads(attention, dtype):
        """One loss and gradient; the key third of each qkv bias is left
        out, its exact gradient being 0 (softmax ignores a shift shared by
        all of a query's scores), so that what is left is rounding."""
        model = compiled(attention=attention, dtype=dtype)
        before = dict(attention_cuda.launches)
        loss, _ = make_loss_fn(model)(x, y)
        loss.backward()
        torch.cuda.synchronize()
        if attention == "flash":
            expect_launches(before, 1, f"the {dtype} flash loss and gradient")
        grads = {}
        for n, p in model.module.named_parameters():
            g = p.grad
            if n.endswith("attn.qkv.bias"):
                third = len(g) // 3
                g = torch.cat([g[:third], g[2 * third:]])
            grads[n] = g
        return loss.item(), grads

    def norm_rel(got, ref):
        """Worst parameter's ||got - ref|| / ||ref||, and its name."""
        rel = {n: ((got[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
               for n, g in ref.items()}
        name = max(rel, key=rel.get)
        return rel[name], name

    # (a) One float32 loss and gradient through the kernels, and through
    # plain autograd of the dense-attention model on the same weights;
    # then the same in bf16, each also held against the f32 dense one.
    losses, grads = {}, {}
    for attention in ("flash", "dense"):
        losses[attention], grads[attention] = loss_and_grads(attention, "float32")
    worst = max(((grads["flash"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in grads["dense"].items())
    dloss = abs(losses["flash"] - losses["dense"])
    print(f"train f32 flash vs dense: loss {losses['flash']:.6f} vs {losses['dense']:.6f} "
          f"(|d| {dloss:.2e}, atol {LOSS_ATOL}); worst gradient max|d| / max|g| "
          f"{worst:.2e} (rtol {GRAD_RTOL}) over {len(grads['dense'])} parameters",
          flush=True)
    check(dloss <= LOSS_ATOL, "flash and dense f32 losses disagree")
    check(worst <= GRAD_RTOL, "flash and dense f32 gradients disagree")
    report["f32_flash_vs_dense"] = {"loss_abs_err": dloss, "grad_rel_err": worst}
    f32 = grads.pop("dense")
    for attention in ("flash", "dense"):
        losses[attention], grads[attention] = loss_and_grads(attention, "bfloat16")
    rel, rel_name = norm_rel(grads["flash"], grads["dense"])
    flash_f32, flash_f32_name = norm_rel(grads["flash"], f32)
    dense_f32, dense_f32_name = norm_rel(grads["dense"], f32)
    dloss = abs(losses["flash"] - losses["dense"])
    print(f"train bf16 flash vs dense: loss {losses['flash']:.6f} vs {losses['dense']:.6f} "
          f"(|d| {dloss:.2e}, atol {BF16_LOSS_ATOL}); worst gradient ||d|| / ||g|| "
          f"{rel:.3e} at {rel_name} (rtol {BF16_GRAD_RTOL}); against the f32 dense "
          f"gradients: flash {flash_f32:.3e} at {flash_f32_name}, dense {dense_f32:.3e} "
          f"at {dense_f32_name}", flush=True)
    check(dloss <= BF16_LOSS_ATOL, "flash and dense bf16 losses disagree")
    check(rel <= BF16_GRAD_RTOL, "flash and dense bf16 gradients disagree")
    report["bf16_flash_vs_dense"] = {"loss_abs_err": dloss, "grad_norm_rel_err": rel,
                                     "flash_vs_f32_dense": flash_f32,
                                     "dense_vs_f32_dense": dense_f32}
    del grads, f32

    # (b)-(d) TRAIN_STEPS steps per dtype on the fixed batch.
    for dtype in ("float32", "bfloat16"):
        model = compiled(attention="flash", dtype=dtype)
        step = make_train_step(model)
        state = init_train_state(model)
        before = dict(attention_cuda.launches)
        history = []
        for i in range(TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = step(state, x, y)
            history.append(metrics)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / (TRAIN_STEPS - TRAIN_WARMUP)
        expect_launches(before, TRAIN_STEPS, f"{TRAIN_STEPS} {dtype} train steps")
        curve = [float(m["loss"]) for m in history]
        print(f"train {dtype} loss: {[round(v, 4) for v in curve]}", flush=True)
        check(all(np.isfinite(curve)), f"{dtype} training loss not finite")
        check(curve[-1] <= curve[0] - LOSS_DROP,
              f"{dtype} loss fell {curve[0] - curve[-1]:.3f} over {TRAIN_STEPS} steps, "
              f"expected at least {LOSS_DROP}")
        tok_s = BATCH * SEQ / elapsed
        fpt = transformer_flops_per_token(model.count_params(), model.module.num_layers,
                                          model.module.d_model, SEQ, backward=True)
        report[f"train_{dtype}"] = {
            "step_ms": elapsed * 1e3,
            "tokens_per_s": tok_s,
            "mfu_vs_bf16_peak": mfu(tok_s, fpt, peak_flops()),
            "loss_first": curve[0],
            "loss_last": curve[-1],
            "acc_last": float(history[-1]["acc"]),
        }
        report[f"profile_train_{dtype}"] = device_breakdown(lambda: step(state, x, y))
        print(f"train {dtype}: {json.dumps(report[f'train_{dtype}'])}", flush=True)
        print(f"profile train {dtype}: {json.dumps(report[f'profile_train_{dtype}'])}",
              flush=True)
        del model, step, state, history
    return dict(attention_cuda.launches), report


def resnet_flops_per_sample(width=64, num_classes=10, size=32, stages=(2, 2, 2, 2)):
    """Forward FLOPs of one CIFAR ResNet image, from the conv and dense
    shapes: 2·k²·C_in·C_out·H_out·W_out per conv (SAME padding, so H_out =
    ceil(H / stride)), 2·in·out for the head. Norms, ReLUs, adds and the
    pool are left out, as model FLOPs leave them out."""
    flops = 2 * 9 * 3 * width * size * size  # 3x3 stem
    channels = width
    for stage, blocks in enumerate(stages):
        out = width * 2 ** stage
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            size = -(-size // stride)
            flops += 2 * 9 * channels * out * size * size  # conv1
            flops += 2 * 9 * out * out * size * size  # conv2
            if stride != 1 or channels != out:
                flops += 2 * channels * out * size * size  # 1x1 shortcut
            channels = out
    return flops + 2 * channels * num_classes


def step_record(compiled, x, y):
    """One train step (forward, backward, optimizer update) of
    ``compiled`` on (x, y), through ``make_loss_fn`` so the logits are
    kept: loss, logits, gradients, float buffers and the parameters'
    change, all on the CPU."""
    from elephas_tpu_torch.engine.step import init_train_state, make_loss_fn

    state = init_train_state(compiled)
    before = {n: p.detach().clone() for n, p in compiled.module.named_parameters()}
    loss, logits = make_loss_fn(compiled)(x, y)
    loss.backward()
    state.optimizer.step()
    module = compiled.module
    return {
        "loss": loss.item(),
        "logits": logits.detach().float().cpu(),
        "grads": {n: p.grad.detach().cpu() for n, p in module.named_parameters()},
        "stats": {n: b.detach().cpu() for n, b in module.named_buffers() if b.is_floating_point()},
        "update": {n: (p.detach() - before[n]).cpu() for n, p in module.named_parameters()},
    }


def step_errors(got, ref):
    """What ``RESNET_*_LIMITS`` bound, of step record ``got`` against
    ``ref``; each per-tensor entry names its worst tensor."""

    def scaled_max(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())

    def by_norm(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()

    errors = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
              "logits": scaled_max(got["logits"], ref["logits"])}
    stats = {n: scaled_max(got["stats"][n], b) for n, b in ref["stats"].items()}
    errors["stats"] = max(stats.values()) if stats else 0.0
    errors["stats_worst"] = max(stats, key=stats.get) if stats else None
    for key in ("grads", "update"):
        per = {n: by_norm(got[key][n], t) for n, t in ref[key].items()}
        errors[key] = max(per.values())
        errors[f"{key}_worst"] = max(per, key=per.get)
        diff = sum(((got[key][n].double() - t.double()) ** 2).sum() for n, t in ref[key].items())
        total = sum((t.double() ** 2).sum() for t in ref[key].values())
        errors[f"{key}_all"] = (diff / total).sqrt().item()
    return errors


def breaches(errors, limits):
    """The names of ``limits`` whose measured error is above its limit
    (or missing, or not a number)."""
    return [k for k, limit in limits.items()
            if not (isinstance(errors.get(k), float) and errors[k] <= limit)]


def resnet_phase(attention_cuda):
    """The paper's main path on the card: the CIFAR-10 ResNet-18 at full
    width (width 64, 10 classes, ~11.2 M parameters, seeded weights),
    momentum lr 0.1, categorical cross-entropy, accuracy. (1) one float64,
    float32 and bf16 train step against the port's CPU path; (2)
    train-step throughput, a bf16 batch sweep and f32 at the best batch,
    with MFU and a device breakdown; (3) ``SparkModel(mode="synchronous")
    .fit`` on the synthetic CIFAR-10 (the checked fit under deterministic
    algorithms), then ``evaluate`` and ``predict``, which must launch no
    flash kernel. Returns the launch counts of (3) and a report."""
    from elephas_tpu_torch import SparkModel, compile_model, to_simple_rdd
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.data.datasets import one_hot, synthetic_cifar10
    from elephas_tpu_torch.engine.step import init_train_state, make_train_step
    from elephas_tpu_torch.metrics import mfu
    from elephas_tpu_torch.models import get_model

    momentum = {"name": "momentum", "learning_rate": 0.1}

    def compiled(dtype, device=None, params=None):
        return CompiledModel(get_model("resnet18", dtype=dtype, device=device), params,
                             optimizer=momentum, loss="categorical_crossentropy",
                             metrics=["acc"], input_shape=(32, 32, 3), seed=SEED)

    report = {}
    fps = 3 * resnet_flops_per_sample()  # training: forward and backward
    cpu_model = compiled("float32", device="cpu")
    weights = cpu_model.get_weights()
    print(f"resnet18: {cpu_model.count_params()} parameters, {fps / 3:.4e} forward FLOPs "
          f"a 32x32 image, {fps:.4e} a trained one", flush=True)

    # (1) The card's steps against the CPU's: float64 against float64, then
    # float32 and bf16 against the CPU's float32 step, each float32 step's
    # gradients also against the float64 one.
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.random((RESNET_CPU_BATCH, 32, 32, 3), dtype=np.float32))
    y = torch.as_tensor(one_hot(rng.integers(0, 10, RESNET_CPU_BATCH), 10))

    def wide(device):
        model = compiled("float64", device=device, params=weights)
        model.module.double()
        return model

    exact = step_record(wide("cpu"), x.double(), y.double())
    reference = step_record(cpu_model, x, y)
    steps = {"float64": step_record(wide("cuda"), x.cuda().double(), y.cuda().double()),
             "float32": step_record(compiled("float32", params=weights), x.cuda(), y.cuda()),
             "bfloat16": step_record(compiled("bfloat16", params=weights), x.cuda(), y.cuda())}
    held = {
        "card float64 vs cpu float64": (steps["float64"], exact, RESNET_F32_LIMITS),
        "card float32 vs cpu float32": (steps["float32"], reference, {
            k: RESNET_F32_LIMITS[k] for k in ("loss", "logits", "stats")}),
        "card float32 vs cpu float64": (steps["float32"], exact, RESNET_F32_GRAD_LIMITS),
        "cpu float32 vs cpu float64": (reference, exact, RESNET_F32_GRAD_LIMITS),
        "card bfloat16 vs cpu float32": (steps["bfloat16"], reference, RESNET_BF16_LIMITS),
    }
    for what, (got, ref, limits) in held.items():
        errors = step_errors(got, ref)
        report[what.replace(" ", "_")] = errors
        print(f"resnet step, {what} (batch {RESNET_CPU_BATCH}; cudnn.benchmark="
              f"{torch.backends.cudnn.benchmark}, TF32 off): {json.dumps(errors)} "
              f"limits {json.dumps(limits)}", flush=True)
        check(not breaches(errors, limits),
              f"resnet step, {what}: breaches {breaches(errors, limits)}")
    del exact, reference, steps, held

    # (2) Throughput of make_train_step, bf16 sweep then f32 at the best batch.
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def throughput(dtype, batch):
        model = compiled(dtype, params=weights)
        step, state = make_train_step(model), init_train_state(model)
        bx = torch.rand((batch, 32, 32, 3), generator=gen, device="cuda")
        by = F.one_hot(torch.randint(0, 10, (batch,), generator=gen, device="cuda"),
                       10).float()
        for _ in range(RESNET_WARMUP):
            state, metrics = step(state, bx, by)
        float(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(RESNET_STEPS):
            state, metrics = step(state, bx, by)
        loss = float(metrics["loss"])
        elapsed = time.perf_counter() - t0
        rate = batch * RESNET_STEPS / elapsed
        out = {"dtype": dtype, "batch": batch, "step_ms": elapsed / RESNET_STEPS * 1e3,
               "samples_per_s": rate, "mfu_vs_bf16_peak": mfu(rate, fps, PEAK_OPS[torch.bfloat16]),
               "share_of_dtype_peak": rate * fps / PEAK_OPS[getattr(torch, dtype)],
               "loss": loss, "cudnn_benchmark": torch.backends.cudnn.benchmark}
        check(np.isfinite(loss), f"resnet {dtype} loss not finite at batch {batch}")
        print(f"resnet throughput: {json.dumps(out)}", flush=True)
        return out, (lambda: step(state, bx, by))

    sweep = [throughput("bfloat16", b) for b in RESNET_SWEEP]
    report["sweep_bf16"] = [r for r, _ in sweep]
    best_rate, best_step = max(sweep, key=lambda r: r[0]["samples_per_s"])
    best = best_rate["batch"]
    f32_rate, f32_step = throughput("float32", best)
    report["f32_at_best_batch"] = f32_rate
    for dtype, step_fn in (("bfloat16", best_step), ("float32", f32_step)):
        report[f"profile_{dtype}"] = device_breakdown(step_fn)
        print(f"resnet profile {dtype} batch {best}: "
              f"{json.dumps(report[f'profile_{dtype}'])}", flush=True)
    del sweep, best_step, f32_step

    # (3) The main path: SparkModel.fit on the synthetic CIFAR-10 set, at
    # the fastest batch with FIT_MIN_STEPS steps an epoch (checked), then
    # at the sweep's fastest batch where that is another. The checked fit
    # runs under deterministic algorithms with cuDNN's heuristic choice:
    # its eval-mode accuracy after 48 steps, with BatchNorm's running
    # statistics lagging the weights, ranged 0.10-0.79 over nondeterministic
    # card runs (PERF.md §6), and held to FIT_MIN_VAL_ACC it must be one
    # fixed number; the fastest batch's fit keeps the user's settings.
    (x_train, y_train), (x_test, y_test) = synthetic_cifar10(n_train=FIT_TRAIN, n_test=FIT_TEST)
    x_train, x_test = x_train.astype(np.float32) / 255.0, x_test.astype(np.float32) / 255.0
    y_train, y_test = one_hot(y_train, 10), one_hot(y_test, 10)
    rates = {r["batch"]: r["samples_per_s"] for r in report["sweep_bf16"]}
    checked = max((b for b in rates if FIT_TRAIN // b >= FIT_MIN_STEPS), key=rates.get)
    attention_cuda.reset_launches()
    for batch in dict.fromkeys((checked, best)):
        net = compile_model(get_model("resnet18", dtype="bfloat16"), optimizer=momentum,
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(32, 32, 3), seed=SEED)
        model = SparkModel(net, mode="synchronous", frequency="batch")
        ends = []
        flags = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark
        if batch == checked:
            torch.use_deterministic_algorithms(True)
            torch.backends.cudnn.benchmark = False
        try:
            t0 = time.perf_counter()
            history = model.fit(to_simple_rdd(None, x_train, y_train), epochs=FIT_EPOCHS,
                                batch_size=batch, validation_data=(x_test, y_test),
                                callbacks=[lambda e, state, m: ends.append(time.perf_counter())])
            fit_s = time.perf_counter() - t0
            deterministic = torch.are_deterministic_algorithms_enabled()
            cudnn_benchmark = torch.backends.cudnn.benchmark
        finally:
            torch.use_deterministic_algorithms(flags[0])
            torch.backends.cudnn.benchmark = flags[1]
        evaluation = model.evaluate(x_test, y_test)
        predictions = model.predict(x_test)
        rows = (FIT_TRAIN // batch) * batch
        key = "fit" if batch == checked else "fit_fastest_batch"
        report[key] = {
            "history": history, "evaluate": evaluation, "batch": batch,
            "steps_per_epoch": FIT_TRAIN // batch, "fit_s": fit_s,
            "epoch_s": np.diff([t0, *ends]).tolist(),
            "samples_per_s_epochs_2_3": 2 * rows / (ends[2] - ends[0]),
            "cudnn_benchmark": cudnn_benchmark, "deterministic": deterministic,
        }
        print(f"resnet {key} (SparkModel synchronous, batch frequency, bf16, batch {batch}, "
              f"{FIT_TRAIN} synthetic CIFAR-10 rows, {FIT_EPOCHS} epochs): "
              f"{json.dumps(report[key])}", flush=True)
        loss = history["loss"]
        check(all(np.isfinite(loss)), f"fit loss not finite: {loss}")
        check(predictions.shape == (FIT_TEST, 10) and np.isfinite(predictions).all(),
              f"predict gave {predictions.shape}, expected ({FIT_TEST}, 10), finite")
        check(np.isfinite(list(evaluation.values())).all(), f"evaluate gave {evaluation}")
        if batch == checked:  # the fastest batch's convergence is measured, not held
            check(loss[-1] < loss[0], f"fit loss did not fall: {loss}")
            check(history["val_acc"][-1] > FIT_MIN_VAL_ACC,
                  f"val_acc {history['val_acc'][-1]:.4f} not above {FIT_MIN_VAL_ACC}")
    launches = dict(attention_cuda.launches)
    check(launches == {k: 0 for k in KERNELS},
          f"the ResNet path launched flash kernels: {launches}")
    return launches, report


def repair_phase(attention_cuda):
    """The dispatch of ``flash_attention`` on the card: every CUDA input
    runs the kernels. A head_dim 16 LM trains under ``attention="flash"``
    as the dense one does, through K1-K3 at head_dim 32 (zero columns);
    head_dim 16, float16 and float64 inputs (the float32 kernels), a
    strided (b, s, h, d) view, more than 65535 (batch, head) pairs and a
    caller's block sizes each launch the kernels and agree with the plain
    version; a head_dim 32 LM step still launches 4 of each. Returns the
    phase's launch counts and a report."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.engine.step import init_train_state, make_loss_fn, make_train_step
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.ops.attention import (
        blockwise_reference,
        flash_attention,
        kernel_layout,
    )

    report = {}
    attention_cuda.reset_launches()
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 32000, (2, 257)), device="cuda")
    x, y = tokens[:, :-1], tokens[:, 1:]

    def lm(**kw):
        return CompiledModel(get_model("transformer_lm", **kw),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="sparse_categorical_crossentropy", metrics=["acc"], seed=SEED)

    def counted(fn):
        before = dict(attention_cuda.launches)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: attention_cuda.launches[k] - before[k] for k in KERNELS}

    # head_dim 16 (256 / 16 heads): flash against dense, f32, 4 of each.
    losses, grads = {}, {}
    for attention in ("flash", "dense"):
        model = lm(num_heads=16, attention=attention)

        def loss_and_grads():
            loss, _ = make_loss_fn(model)(x, y)
            loss.backward()
            return loss.item()

        losses[attention], launched = counted(loss_and_grads)
        want = {k: 4 if attention == "flash" else 0 for k in KERNELS}
        check(launched == want, f"head_dim 16 {attention} launched {launched}, expected {want}")
        grads[attention] = {}
        for n, p in model.module.named_parameters():
            g = p.grad
            if n.endswith("attn.qkv.bias"):  # the key third's exact gradient is 0
                third = len(g) // 3
                g = torch.cat([g[:third], g[2 * third:]])
            grads[attention][n] = g
    worst = max(((grads["flash"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in grads["dense"].items())
    dloss = abs(losses["flash"] - losses["dense"])
    report["head_dim_16_lm"] = {"loss_abs_err": dloss, "grad_rel_err": worst}
    print(f"repair: head_dim 16 LM (2 x 256, f32) flash vs dense: |dloss| {dloss:.2e} "
          f"(atol {REPAIR_LOSS_ATOL}), worst gradient max|d| / max|g| {worst:.2e} "
          f"(rtol {REPAIR_GRAD_RTOL}), 4 launches of each kernel", flush=True)
    check(dloss <= REPAIR_LOSS_ATOL and worst <= REPAIR_GRAD_RTOL,
          "head_dim 16 flash and dense disagree")
    del grads

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def held(what, shape, dtype, limits, view=None, blocks=(None, None)):
        """flash_attention and its gradients against blockwise_reference
        under autograd, at the tiling of the kernel that computes the
        input; each a 1-launch forward and a 1 + 1 launch backward. The
        inputs are (b, s, h, d) tensors viewed as (b, h, s, d) where
        ``view`` is set. Returns the errors, max|d| / max(1, max|ref|)."""
        make = (lambda: torch.randn(shape, device="cuda", generator=gen).to(dtype))
        tensors = [make() for _ in range(4)]
        if view:
            tensors = [t.transpose(1, 2) for t in tensors]
        head_dim, kernel_dtype = kernel_layout(shape[-1], dtype)
        tiles = attention_cuda.kernel_tiles("flash_fwd", kernel_dtype, head_dim)
        results = []
        for kernels in (True, False):
            leaves = [t.detach().clone().requires_grad_() for t in tensors[:3]]
            if kernels:
                out, fwd = counted(lambda: flash_attention(*leaves, True, *blocks))
                got, bwd = counted(lambda: torch.autograd.grad(out, leaves, tensors[3]))
            else:
                out = blockwise_reference(*leaves, True, *tiles)[0]
                got = torch.autograd.grad(out, leaves, tensors[3])
            results.append((out.detach(), got))
        (out, got), (ref_out, ref) = results

        def err(a, b):
            return ((a.double() - b.double()).abs().max() / max(1.0, b.abs().max().item())).item()

        errors = {"o": err(out, ref_out), "grads": max(err(a, b) for a, b in zip(got, ref))}
        report[what] = {**errors, "launches": [fwd, bwd], "shape": list(shape),
                        "dtype": str(dtype)}
        print(f"repair: {what} {tuple(shape)} {dtype}: {json.dumps(errors)} limits "
              f"{json.dumps(limits)}; launches {fwd} then {bwd}", flush=True)
        check(fwd == {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0}
              and bwd == {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1},
              f"{what} launched {fwd} then {bwd}")
        check(not breaches(errors, limits), f"{what}: breaches {breaches(errors, limits)}")
        return [t.detach() for t in tensors[:3]], out

    f32 = {"o": TOL[torch.float32][0], "grads": TOL_BWD[torch.float32]}
    bf16 = {"o": TOL[torch.bfloat16][0], "grads": TOL_BWD[torch.bfloat16]}
    held("transposed view", (2, 256, 8, 32), torch.float32, f32, view=True)
    held("head_dim 16", (2, 16, 256, 16), torch.float32, f32)
    held("head_dim 16", (2, 16, 256, 16), torch.bfloat16, bf16)
    held("head_dim 80", (2, 4, 256, 80), torch.float32, f32)
    held("float16", (2, 256, 8, 32), torch.float16, REPAIR_F16_LIMITS, view=True)
    held("float64", (2, 8, 256, 32), torch.float64, f32)
    held("batch*heads 65600", (1025, 64, 40, 32), torch.bfloat16, bf16)
    inputs, own = held("caller blocks", (2, 8, 256, 32), torch.float32, f32, blocks=(16, 16))
    check(torch.equal(own, flash_attention(*inputs, True)),
          "the kernels' output moved with the caller's block sizes")

    # head_dim 16 at the LM's scoring shape: the kernels (at head_dim 32)
    # against the yardstick, SDPA, forward and forward + backward.
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((BATCH, 16, SEQ, 16), device="cuda", generator=gen,
                                   dtype=dtype) for _ in range(4))
        leaves = [t.requires_grad_() for t in (q, k, v)]

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(*leaves), leaves, do)

        sdpa = (lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True))
        flash = (lambda a, b, c: flash_attention(a, b, c, True))
        # The kernels alone on the padded inputs: what is left of
        # flash_attention's time is the padding, casts and autograd.
        padded = [F.pad(t.detach(), (0, 16)) for t in (q, k, v, do)]
        o, lse = attention_cuda.flash_fwd(*padded[:3], True, 0.25)
        delta = (padded[3].float() * o.float()).sum(-1)
        bwd_args = (*padded, lse, delta, True, 0.25)
        times[str(dtype)] = {
            "flash_fwd_ms": cuda_ms(lambda: flash(*leaves), 10),
            "sdpa_fwd_ms": cuda_ms(lambda: sdpa(*leaves), 10),
            "flash_fwd_bwd_ms": cuda_ms(fwd_bwd(flash), 10),
            "sdpa_fwd_bwd_ms": cuda_ms(fwd_bwd(sdpa), 10),
            "k1_ms": cuda_ms(lambda: attention_cuda.flash_fwd(*padded[:3], True, 0.25), 10),
            "k2_ms": cuda_ms(lambda: attention_cuda.flash_bwd_dq(*bwd_args), 10),
            "k3_ms": cuda_ms(lambda: attention_cuda.flash_bwd_dkv(*bwd_args), 10),
        }
    report["head_dim_16_times"] = {"shape": [BATCH, 16, SEQ, 16], **times}
    print(f"repair: head_dim 16 at ({BATCH}, 16, {SEQ}, 16), causal, flash_attention (its "
          f"zero-padding included) vs SDPA, and K1-K3 alone at head_dim 32: "
          f"{json.dumps(times)}", flush=True)

    # head_dim 32: one LM train step still launches 4 of each kernel.
    model = lm(attention="flash")
    step, state = make_train_step(model), init_train_state(model)
    (_, metrics), launched = counted(lambda: step(state, x, y))
    check(launched == {k: 4 for k in KERNELS}, f"a head_dim 32 LM step launched {launched}")
    check(np.isfinite(float(metrics["loss"])), "head_dim 32 LM loss not finite")
    report["head_dim_32_step_launches"] = launched
    print(f"repair: head_dim 32 LM train step launches {launched}", flush=True)
    return dict(attention_cuda.launches), report


def serving_traffic(seed=SEED):
    """The serving phase's requests, ``[(prompt, max_new_tokens)]``: 48,
    prompt lengths and budgets drawn from ``seed``, every 4th prompt
    starting with the same ``SERVE_PREFIX``-token system prompt."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, 32000, SERVE_PREFIX).tolist()
    traffic = []
    for i in range(SERVE_REQUESTS):
        new = int(rng.integers(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1))
        if i % 4 == 0:
            n = int(rng.integers(SERVE_PREFIX + 1, SERVE_PROMPT_LENS[1] + 1))
            prompt = prefix + rng.integers(1, 32000, n - SERVE_PREFIX).tolist()
        else:
            n = int(rng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1))
            prompt = rng.integers(1, 32000, n).tolist()
        traffic.append((prompt, new))
    return traffic


def first_difference(a, b):
    """Index of the first token where streams ``a`` and ``b`` differ, or
    None when they are equal; streams of different lengths whose shorter
    one is a prefix of the other are not allowed."""
    k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    check(k is not None or len(a) == len(b),
          f"streams of {len(a)} and {len(b)} tokens, one a prefix of the other")
    return k


def compare_streams(ref, got, gap_at, margin=MARGIN):
    """Hold the streams ``got`` to ``ref`` request by request: equal, or
    equal up to a token where the reference run's top-2 gap,
    ``gap_at(request, token)``, is below ``margin`` (a near-tie that
    rounding may break either way). Raises at any other difference;
    returns the count of equal streams and each near-tie as
    ``[request, token, gap]``."""
    check(len(ref) == len(got), f"{len(got)} streams against {len(ref)}")
    identical, ties = 0, []
    for i, (a, b) in enumerate(zip(ref, got)):
        k = first_difference(a, b)
        if k is None:
            identical += 1
            continue
        gap = gap_at(i, k)
        check(gap < margin, f"request {i}: streams differ at token {k}, where the "
                            f"reference's top-2 gap is {gap:.3e} (not below {margin})")
        ties.append([i, k, gap])
    return {"identical": identical, "near_ties": ties}


def serve(engine, traffic):
    """Submit every request at once, run the engine until drained, and
    return the token streams and the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [engine.submit(prompt, max_new_tokens=new) for prompt, new in traffic]
    engine.run_until_drained()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    results = [engine.result(i) for i in ids]
    check(all(r.status == "completed" for r in results), "a request did not complete")
    check([len(r.tokens) for r in results] == [new for _, new in traffic],
          "a stream is not its budget long")
    return [r.tokens for r in results], elapsed


def serving_phase(attention_cuda):
    """``InferenceEngine`` on the full-width LM: the port's serving path,
    which runs dense cache attention and launches no flash kernel."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.models.transformer import sampling_scores
    from elephas_tpu_torch.serving import InferenceEngine, host_sync

    blocking = host_sync.blocking_reads()
    check(blocking == [], f"blocking reads outside serving/host_sync.py: {blocking}")
    # A staged read waits for the launch that made the value, not for work
    # queued after it (the pipelined scheduler reads step N behind N+1).
    staged = host_sync.stage(torch.arange(16, device="cuda"))
    torch.cuda._sleep(SERVE_SLEEP_CYCLES)  # stands in for step N+1
    t0 = time.perf_counter()
    check(host_sync.fetch(staged).tolist() == list(range(16)), "staged read is wrong")
    fetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    queued_ms = (time.perf_counter() - t0) * 1e3
    check(fetch_ms < queued_ms, f"the staged read waited {fetch_ms:.2f} ms, for the work "
                                f"queued after it ({queued_ms:.2f} ms more)")
    model = CompiledModel(get_model("transformer_lm"), loss="sparse_categorical_crossentropy",
                          metrics=[], seed=SEED).module
    traffic = serving_traffic()
    report = {"requests": len(traffic),
              "prompt_tokens": sum(len(p) for p, _ in traffic),
              "new_tokens": sum(n for _, n in traffic),
              "staged_fetch_ms": fetch_ms, "queued_after_ms": queued_ms}

    def engine(**kw):
        return InferenceEngine(model, **{**SERVE_ENGINE, **kw})

    def last_logits(prompt, stream, k):
        with torch.no_grad():
            context = torch.as_tensor([prompt + stream[:k]], device="cuda")
            return model(context)[0, -1:]

    def greedy_gap(ref):
        def gap_at(i, k):
            top2 = torch.topk(last_logits(traffic[i][0], ref[i], k), 2).values[0]
            return float(top2[0] - top2[1])
        return gap_at

    def sampled_gap(ref):
        def gap_at(i, k):
            position = torch.tensor([len(traffic[i][0]) + k], device="cuda")
            scores = sampling_scores(last_logits(traffic[i][0], ref[i], k),
                                     SERVE_SAMPLING["seed"], position,
                                     SERVE_SAMPLING["top_k"], SERVE_SAMPLING["temperature"])
            top2 = torch.topk(scores, 2).values[0]
            return float(top2[0] - top2[1])
        return gap_at

    # The main path: the paged engine, pipelined, its decode step a graph.
    paged = engine()
    addresses = [t.data_ptr() for t in paged.pool.tensors()]
    attention_cuda.reset_launches()
    greedy, elapsed = serve(paged, traffic)
    launches = dict(attention_cuda.launches)
    check(launches == {name: 0 for name in KERNELS},
          f"the serving path launched flash kernels: {launches}")
    stats = paged.stats()
    check(stats["decode_traces"] == 1 and stats["prefill_traces"] == 1,
          f"decode built {stats['decode_traces']} times, prefill {stats['prefill_traces']}")
    check(isinstance(getattr(paged, "_graph", None), torch.cuda.CUDAGraph),
          "the paged decode step is not a captured CUDA graph")
    check(stats["prefix_hits"] > 0, "no prefix hit on the shared system prompt")
    paged.pool.assert_block_invariants()
    check(paged.pool.free_count == paged.pool.max_slots, "a slot was not released")
    check([t.data_ptr() for t in paged.pool.tensors()] == addresses,
          "a pool tensor moved: a step copied the pool")
    summary = paged.metrics.summary()
    report["paged"] = {
        "s": elapsed, "requests_per_s": len(traffic) / elapsed,
        "new_tokens_per_s": report["new_tokens"] / elapsed,
        **{k: summary[k] for k in ("ttft_s_p50", "ttft_s_p99", "itl_s_p50", "itl_s_p99",
                                   "steps", "max_concurrent")},
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "prefix_tokens_saved": stats["prefix_tokens_saved"],
        "kv_blocks_in_use": paged.pool.blocks_in_use,
        "kv_blocks_total": paged.pool.num_blocks,
    }
    print(f"serving paged: {json.dumps(report['paged'])}", flush=True)

    # The oracles, greedy: contiguous pool, sync scheduler, one-shot prefill.
    contiguous, report["contiguous_s"] = serve(engine(
        paged=False, kv_block_size=None, prefill_chunk=None, prefill_chunks_per_step=None),
        traffic)
    report["paged_vs_contiguous"] = compare_streams(contiguous, greedy, greedy_gap(contiguous))
    sync, report["sync_s"] = serve(engine(pipeline=False), traffic)
    check(sync == greedy, "the sync scheduler's greedy streams differ from the pipelined")
    one_shot, report["one_shot_s"] = serve(engine(prefill_chunk=SERVE_ENGINE["max_prompt_len"],
                                                  prefill_chunks_per_step=None), traffic)
    report["chunked_vs_one_shot"] = compare_streams(one_shot, greedy, greedy_gap(one_shot))
    print(f"serving greedy oracles: paged vs contiguous "
          f"{json.dumps(report['paged_vs_contiguous'])}, pipelined vs sync identical, "
          f"chunked vs one-shot {json.dumps(report['chunked_vs_one_shot'])}", flush=True)

    # Sampled: position-keyed, so every path draws the same numbers.
    sampled, _ = serve(engine(**SERVE_SAMPLING), traffic)
    sampled_sync, _ = serve(engine(pipeline=False, **SERVE_SAMPLING), traffic)
    check(sampled_sync == sampled, "sampled streams differ between pipelined and sync")
    sampled_contiguous, _ = serve(engine(
        paged=False, kv_block_size=None, prefill_chunk=None, prefill_chunks_per_step=None,
        **SERVE_SAMPLING), traffic)
    report["sampled_paged_vs_contiguous"] = compare_streams(
        sampled_contiguous, sampled, sampled_gap(sampled_contiguous))
    check(sampled != greedy, "sampled streams equal the greedy ones")
    outside = []
    with torch.no_grad():
        for i, ((prompt, _), stream) in enumerate(zip(traffic, sampled)):
            logits = model(torch.as_tensor([prompt + stream[:-1]], device="cuda"))[0]
            rows = logits[len(prompt) - 1:]
            kth = torch.topk(rows, SERVE_SAMPLING["top_k"], dim=-1).values[:, -1]
            got = rows.gather(1, torch.as_tensor(stream, device="cuda")[:, None])[:, 0]
            rank = (rows > got[:, None]).sum(-1)
            for k in torch.nonzero(got < kth - SERVE_TOP_K_SLACK)[:, 0].tolist():
                outside.append([i, k, int(rank[k]), float(kth[k] - got[k])])
    check(outside == [], f"{len(outside)} sampled tokens lie outside the teacher-forced "
                         f"top-40 ([request, token, rank, under the 40th]): {outside[:12]}")
    print(f"serving sampled: pipelined vs sync identical, paged vs contiguous "
          f"{json.dumps(report['sampled_paged_vs_contiguous'])}, every token in the "
          f"teacher-forced top-{SERVE_SAMPLING['top_k']}", flush=True)

    # Three requests through the port's CPU engine, same weights: the CPU's
    # stream up to its first near-tie, and teacher-forced on the card's
    # stream, the CPU's argmax wherever its top-2 gap is at least MARGIN.
    cpu_model = get_model("transformer_lm", device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_traffic = [traffic[i] for i in SERVE_CPU_REQUESTS]
    cpu_engine = InferenceEngine(cpu_model, **{**SERVE_ENGINE, "max_slots": 2})
    cpu_ids = [cpu_engine.submit(p, max_new_tokens=n) for p, n in cpu_traffic]
    cpu_engine.run_until_drained()
    compared, forced = [], []
    for i, rid, (prompt, new) in zip(SERVE_CPU_REQUESTS, cpu_ids, cpu_traffic):
        cpu_stream, gpu_stream = cpu_engine.result(rid).tokens, greedy[i]

        def cpu_steps(stream):
            with torch.no_grad():
                logits = cpu_model(torch.as_tensor([prompt + stream[:-1]]))[0, len(prompt) - 1:]
            top2 = torch.topk(logits, 2, dim=-1)
            return (top2.indices[:, 0].numpy(),
                    (top2.values[:, 0] - top2.values[:, 1]).numpy())

        _, gaps = cpu_steps(cpu_stream)
        n = int(np.argmax(gaps < MARGIN)) if (gaps < MARGIN).any() else new
        check(cpu_stream[:n] == gpu_stream[:n],
              f"request {i}: the card's stream differs from the CPU's within {n} steps")
        best, gaps = cpu_steps(gpu_stream)
        clear = gaps >= MARGIN
        check((best[clear] == np.asarray(gpu_stream)[clear]).all(),
              f"request {i}: a token of the card is not the CPU's argmax on its stream")
        compared.append(n)
        forced.append(int(clear.sum()))
    report["cpu"] = {"requests": list(SERVE_CPU_REQUESTS), "stream_steps": compared,
                     "forced_steps": forced,
                     "decode_traces": cpu_engine.stats()["decode_traces"]}
    print(f"serving cpu: {json.dumps(report['cpu'])}", flush=True)

    # The decode step, as replayed and called eagerly (a measurement, not a
    # path): with every lane inactive it does the same fixed-shape work and
    # writes nothing.
    from torch.profiler import ProfilerActivity, profile

    paged._inputs.zero_()
    report["decode_step_graph_ms"] = cuda_ms(paged._decode_step, SERVE_STEPS)
    report["decode_step_eager_ms"] = cuda_ms(paged._decode_body, SERVE_STEPS)
    for name, fn in (("eager", paged._decode_body), ("graph", paged._decode_step)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        report[f"kernels_per_decode_step_{name}"] = sum(
            e.count for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    # 50 steps of the live loop, 16 lanes decoding.
    live = [paged.submit(p[:64], max_new_tokens=SERVE_STEPS + 20) for p, _ in traffic[:16]]
    while paged.scheduler._prefilling or len(paged.queue) or \
            paged.scheduler.active_count < len(live):
        paged.step()
    report["serving_breakdown"] = device_breakdown(
        lambda: [paged.step() for _ in range(SERVE_STEPS)])
    paged.run_until_drained()
    check(paged.stats()["decode_traces"] == 1, "the decode step was rebuilt")
    check(dict(attention_cuda.launches) == launches, "the serving phase launched a flash kernel")
    print(f"serving decode step: graph {report['decode_step_graph_ms']:.4f} ms, eager "
          f"{report['decode_step_eager_ms']:.4f} ms; kernels "
          f"{report['kernels_per_decode_step_eager']} eager, "
          f"{report['kernels_per_decode_step_graph']} replayed; 50 live steps: "
          f"{json.dumps(report['serving_breakdown'])}", flush=True)
    return launches, report


def span_ms(events, names):
    """Mean, total and count of each named span's wall milliseconds."""
    out = {}
    for name in names:
        ms = [(e.end_s - e.begin_s) * 1e3 for e in events if e.name == name]
        out[name] = {"mean_ms": float(np.mean(ms)) if ms else None,
                     "total_ms": float(np.sum(ms)), "count": len(ms)}
    return out


def epoch_rate(ends, rows):
    """Samples/s over epochs 2 and later from the epochs' end times (None
    for a fit of one epoch)."""
    return rows * (len(ends) - 1) / (ends[-1] - ends[0]) if len(ends) > 1 else None


def summing_pushes(sums, count, classes=None):
    """Patch the clients' push (the wire clients', or ``classes``') to
    also sum every delta it sends in float64 on the host, by parameter
    name, and count the pushes; returns the function that takes the patch
    off."""
    from elephas_tpu_torch.parameter import client as client_mod

    lock, real = threading.Lock(), {}
    for cls in classes or (client_mod.HttpClient, client_mod.SocketClient):
        real[cls] = cls.update_parameters

        def push(self, delta, _real=real[cls]):
            host = client_mod.to_host(delta)
            flat = {n: t.double().numpy() for g in host for n, t in host[g].items()}
            # A pipelined push's host copy is waited for once, here.
            _real(self, host if isinstance(delta, client_mod.HostCopy) else delta)
            with lock:
                for name, value in flat.items():
                    sums[name] = sums.get(name, 0.0) + value
                count[0] += 1

        cls.update_parameters = push

    def restore():
        for cls, fn in real.items():
            cls.update_parameters = fn

    return restore


def sum_error_by_norm(final, start, sums):
    """||final - (start - sums)|| / ||start|| over the summed tensors;
    ``final``/``start`` are name -> tensor, ``sums`` name -> float64."""
    diff = sum(float(np.sum((final[n].double().numpy() - (start[n].double().numpy()
                                                          - sums[n])) ** 2)) for n in sums)
    norm = sum(float(np.sum(start[n].double().numpy() ** 2)) for n in sums)
    return (diff / norm) ** 0.5


class ApplyChain:
    """Records the parameter server's applies (tree granularity): each
    published tree carries the float64 sum of the deltas it holds and
    their count, chained from the tree its apply read. Under the lock the
    final tree holds every push; under hogwild a racing apply can drop a
    whole delta (``parameter/buffer.py``) and the final tree holds exactly
    the survivors. A tree is known by its first leaf, and its entry goes
    with that tensor, so only the live ones are kept. ``received`` sums
    every delta the server was handed. ``close()`` takes the patch off."""

    def __init__(self):
        import weakref

        from elephas_tpu_torch.parameter import buffer as buffer_mod
        from elephas_tpu_torch.utils.functional_utils import tree_leaves_with_path

        self.chains, self.received, self._live = {0: ({}, 0)}, {}, {}
        lock, seq = threading.Lock(), [0]
        self._cls, self._real = buffer_mod.ParameterBuffer, buffer_mod.ParameterBuffer._subtract
        self._first = lambda tree: tree_leaves_with_path(tree)[0][1]
        real = self._real

        def forget(key, n):
            with lock:
                if self._live.get(key) == n:
                    del self._live[key]
                self.chains.pop(n, None)

        def subtract(params, delta):
            out = real(params, delta)
            flat = {p[-1]: t.detach().double().cpu().numpy()
                    for p, t in tree_leaves_with_path(delta)}
            leaf = self._first(out)
            with lock:
                seq[0] += 1
                n = seq[0]
                cum, count = self.chains[self._live.get(id(self._first(params)), 0)]
                self.chains[n] = ({k: cum.get(k, 0.0) + v for k, v in flat.items()}, count + 1)
                self._live[id(leaf)] = n
                for k, v in flat.items():
                    self.received[k] = self.received.get(k, 0.0) + v
            weakref.finalize(leaf, forget, id(leaf), n)
            return out

        self._cls._subtract = staticmethod(subtract)

    def final(self, buffer):
        """(deltas summed by parameter name, their count) of the buffer's
        published tree."""
        return self.chains[self._live.get(id(self._first(buffer._head[0])), 0)]

    def close(self):
        self._cls._subtract = staticmethod(self._real)


def mnist_cnn_data():
    """BASELINE config 2's data: synthetic MNIST at ``ASYNC_CNN_ROWS``,
    NHWC float images in [0, 1] and one-hot labels; (train, test)."""
    from elephas_tpu_torch.data.datasets import one_hot, synthetic_mnist

    return tuple((x.astype(np.float32)[..., None] / 255.0, one_hot(y, 10))
                 for x, y in synthetic_mnist(*ASYNC_CNN_ROWS))


def mnist_cnn(device=None):
    """BASELINE config 2's CNN at the registry's full width, Adam, seeded."""
    from elephas_tpu_torch import compile_model
    from elephas_tpu_torch.models import get_model

    return compile_model(get_model("cnn", device=device),
                         optimizer={"name": "adam", "learning_rate": 1e-3},
                         loss="categorical_crossentropy", metrics=["acc"],
                         input_shape=(28, 28, 1), seed=SEED)


def state_digest(module):
    """sha256 of a module's state_dict, tensor by tensor in name order."""
    import hashlib

    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def async_phase(attention_cuda):
    """Asynchronous and hogwild training on the card: Downpour SGD
    against the parameter server (a ``ParameterBuffer`` on cuda:0), the
    workers threads on cuda:0, each on its own stream. (1) The MNIST CNN
    (BASELINE config 2), 4 workers over the local server: loss falls,
    one val entry per epoch above ``ASYNC_MIN_VAL_ACC``, every locked
    push applied (the server ends at the start minus the sum of the
    pushed deltas), evaluate and predict; (2) one worker on the card against
    the port's CPU path, same weights and row order; (3) 2 workers over
    the socket and the HTTP servers, and with 1 worker socket against
    local to the bit, and the local server's comms pipeline on against
    off; (4) the ResNet-18 (BASELINE config 4) hogwild in
    'tree' and 'leaf' granularity, 4 workers, SGD (``HOGWILD_OPTIMIZER``);
    (5) samples/s with 1 and 4
    workers beside the synchronous fit at the same global batch, pull and
    push ms from the ``async/*`` spans, a kernel breakdown of one epoch.
    No flash kernel may launch. Returns the launch counts and a report."""
    from elephas_tpu_torch import SparkModel, compile_model, obs, to_simple_rdd
    from elephas_tpu_torch.data.datasets import one_hot, synthetic_cifar10
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parameter.client import LocalClient

    attention_cuda.reset_launches()
    report = {}
    registry = obs.default_registry()

    def counter(name, **labels):
        family = registry.counter(name, labelnames=tuple(labels))
        return family.labels(**labels).value if labels else family.value

    def images(pair):
        x, y = pair
        x = x.astype(np.float32) / 255.0
        return (x[..., None] if x.ndim == 3 else x), one_hot(y, 10)  # NHWC, one-hot

    (x, y), (xv, yv) = mnist_cnn_data()
    cnn = mnist_cnn

    # (1) The CNN, asynchronous, 4 workers on one card. Each push's delta
    # is also copied to the host on its pusher's stream and summed in
    # float64: with the lock every push lands, so the server must end at
    # the start minus that sum (a delta read before its stream wrote it
    # would not).
    sums, summed = {}, [0]
    pushes0 = counter("ps_push_total", transport="local")
    net = cnn()
    start = net.get_weights()
    model = SparkModel(net, mode="asynchronous", frequency="epoch",
                       parameter_server_mode="local", mesh=["cuda:0"] * ASYNC_WORKERS)
    restore = summing_pushes(sums, summed, classes=(LocalClient,))
    try:
        t0 = time.perf_counter()
        history = model.fit(to_simple_rdd(None, x, y), epochs=ASYNC_CNN_EPOCHS,
                            batch_size=ASYNC_CNN_BATCH, validation_data=(xv, yv))
        fit_s = time.perf_counter() - t0
    finally:
        restore()
    sum_error = sum_error_by_norm(model.get_weights(), start, sums)
    pushes = counter("ps_push_total", transport="local") - pushes0
    version = model.async_trainer.server.buffer.version
    evaluation, predictions = model.evaluate(xv, yv), model.predict(xv)
    report["cnn_async"] = {"history": history, "fit_s": fit_s, "pushes": pushes,
                           "version": version, "evaluate": evaluation,
                           "summed_pushes": summed[0], "start_minus_sum_error": sum_error,
                           "epoch_end_s": np.diff([t0, *model.last_epoch_end_times]).tolist()}
    print(f"async cnn (SparkModel asynchronous, epoch frequency, local PS, "
          f"{ASYNC_WORKERS} workers on cuda:0, batch {ASYNC_CNN_BATCH}): "
          f"{json.dumps(report['cnn_async'])}", flush=True)
    loss = history["loss"]
    check(all(np.isfinite(loss)) and loss[-1] < loss[0], f"cnn async loss did not fall: {loss}")
    check(len(history["val_acc"]) == ASYNC_CNN_EPOCHS, f"val entries: {history['val_acc']}")
    check(history["val_acc"][-1] > ASYNC_MIN_VAL_ACC,
          f"cnn async val_acc {history['val_acc'][-1]:.4f} not above {ASYNC_MIN_VAL_ACC}")
    check(version == pushes == summed[0] == ASYNC_WORKERS * ASYNC_CNN_EPOCHS,
          f"buffer version {version}, pushes {pushes}: every locked push must apply")
    check(sum_error <= ASYNC_SUM_LIMIT,
          f"the server's weights are {sum_error:.3e} (by norm) from the start minus the "
          f"pushed deltas; limit {ASYNC_SUM_LIMIT}")
    check(abs(evaluation["loss"] - history["val_loss"][-1])
          <= 1e-4 * max(1.0, abs(evaluation["loss"])),
          f"evaluate after the fit {evaluation} is not the last epoch's validation")
    check(predictions.shape == (len(xv), 10) and np.isfinite(predictions).all(),
          f"predict gave {predictions.shape}")

    # (2) One worker on the card against the CPU, same weights and rows,
    # and (3b) below, with cuDNN's deterministic algorithms: benchmark
    # mode may pick a different algorithm in each fit, and some conv
    # backward algorithms sum with atomics, neither of which a comparison
    # of two fits should see.
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    for device in ("cuda:0", "cpu"):
        net = cnn(device="cpu" if device == "cpu" else None)
        m = SparkModel(net, mode="asynchronous", frequency="batch", mesh=[device])
        h = m.fit(to_simple_rdd(None, x[:ASYNC_CPU_ROWS], y[:ASYNC_CPU_ROWS]), epochs=1,
                  batch_size=ASYNC_CNN_BATCH)
        runs[device] = (h, m.get_weights())
    (h_card, w_card), (h_cpu, w_cpu) = runs["cuda:0"], runs["cpu"]
    diff = sum(float((w_card[k].double() - w_cpu[k].double()).norm() ** 2) for k in w_cpu)
    ref = sum(float(w_cpu[k].double().norm() ** 2) for k in w_cpu)
    errors = {"weights_all": (diff / ref) ** 0.5,
              "loss": abs(h_card["loss"][0] - h_cpu["loss"][0]) / abs(h_cpu["loss"][0])}
    report["card_vs_cpu"] = {"errors": errors, "limits": ASYNC_CPU_LIMITS,
                             "loss_card": h_card["loss"], "loss_cpu": h_cpu["loss"]}
    print(f"async card vs cpu (1 worker, batch frequency, {ASYNC_CPU_ROWS} rows): "
          f"{json.dumps(report['card_vs_cpu'])}", flush=True)
    check(not breaches(errors, ASYNC_CPU_LIMITS),
          f"async card vs cpu: breaches {breaches(errors, ASYNC_CPU_LIMITS)}")

    # (3) The wire transports: 2 workers each, with the comms pipeline off
    # and at its default (on), then 1 worker (deterministic cuDNN) socket
    # against local to the bit. Off, each pull follows the worker's own
    # push: held to the accuracy bar. On, pull k+1 leaves before push k,
    # as in the JAX package (tests/test_torch_async_pipeline_order.py), and
    # the accuracy spreads from fit to fit (scripts/torch_async_wire_repeat.py):
    # held to what it guarantees, every push applied and the server at the
    # start minus their float64 sum; its accuracy is printed.
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    wire_sums, wire_pushes = {}, [0]
    restore = summing_pushes(wire_sums, wire_pushes)
    try:
        for mode in ("socket", "http"):
            for pipelined in (False, None):
                wire_sums.clear()
                wire_pushes[0] = 0
                hits0 = counter("ps_cache_hit_total")
                net = cnn()
                start = net.get_weights()
                m = SparkModel(net, mode="asynchronous", frequency="batch",
                               parameter_server_mode=mode, port=0,
                               mesh=["cuda:0"] * ASYNC_WIRE_WORKERS, pipelined_comms=pipelined)
                t0 = time.perf_counter()
                h = m.fit(to_simple_rdd(None, x, y), epochs=1, batch_size=ASYNC_CNN_BATCH)
                fit_s = time.perf_counter() - t0
                ev = m.evaluate(xv, yv)
                key = f"cnn_{mode}" + ("" if pipelined is False else "_pipelined")
                version = m.async_trainer.server.buffer.version
                report[key] = {"history": h, "evaluate": ev, "fit_s": fit_s,
                               "not_modified": counter("ps_cache_hit_total") - hits0,
                               "version": version, "pushes": wire_pushes[0],
                               "start_minus_sum_error": sum_error_by_norm(
                                   m.get_weights(), start, wire_sums)}
                print(f"async cnn over {mode} ({ASYNC_WIRE_WORKERS} workers, batch frequency, "
                      f"1 epoch, comms pipeline {'off' if pipelined is False else 'on'}): "
                      f"{json.dumps(report[key])}", flush=True)
                if pipelined is False:
                    check(ev["acc"] > ASYNC_WIRE_MIN_ACC and ev["loss"] < ASYNC_WIRE_MAX_LOSS,
                          f"{mode}: evaluate {ev} not above acc {ASYNC_WIRE_MIN_ACC} and under "
                          f"loss {ASYNC_WIRE_MAX_LOSS:.4f}")
                    continue
                want = ASYNC_WIRE_WORKERS * (len(x) // ASYNC_WIRE_WORKERS // ASYNC_CNN_BATCH)
                check(version == wire_pushes[0] == want,
                      f"{mode} pipelined: buffer version {version}, pushes {wire_pushes[0]}, "
                      f"expected {want}: every locked push must apply")
                check(report[key]["start_minus_sum_error"] <= ASYNC_SUM_LIMIT,
                      f"{mode} pipelined: the server's weights are "
                      f"{report[key]['start_minus_sum_error']:.3e} (by norm) from the start "
                      f"minus the pushed deltas; limit {ASYNC_SUM_LIMIT}")
    finally:
        restore()
    # The same pair at epoch frequency with the local server's comms
    # pipeline on (the delta crosses to the comms thread behind an event,
    # the pull comes back from it), against it off: with one worker the
    # epoch's pull follows its own push either way.
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    weights = {}
    for key, mode, frequency, pipelined in (("local", "local", "batch", False),
                                            ("socket", "socket", "batch", False),
                                            ("local_epoch", "local", "epoch", False),
                                            ("local_epoch_pipelined", "local", "epoch", True)):
        m = SparkModel(cnn(), mode="asynchronous", frequency=frequency,
                       parameter_server_mode=mode, port=0, mesh=["cuda:0"],
                       pipelined_comms=pipelined)
        m.fit(to_simple_rdd(None, x[:ASYNC_BITWISE_ROWS], y[:ASYNC_BITWISE_ROWS]), epochs=2,
              batch_size=ASYNC_CNN_BATCH)
        weights[key] = m.get_weights()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags

    def same(a, b):
        return all(torch.equal(weights[a][k], weights[b][k]) for k in weights[a])

    report["socket_equals_local"] = same("local", "socket")
    report["pipelined_equals_unpipelined"] = same("local_epoch", "local_epoch_pipelined")
    print(f"async, 1 worker, {ASYNC_BITWISE_ROWS} rows, 2 epochs: socket vs local (batch "
          f"frequency, unpipelined) identical {report['socket_equals_local']}; local "
          f"pipelined vs unpipelined (epoch frequency) identical "
          f"{report['pipelined_equals_unpipelined']}", flush=True)
    check(report["socket_equals_local"], "socket and local gave different weights, 1 worker")
    check(report["pipelined_equals_unpipelined"],
          "the local comms pipeline changed the weights of an epoch-frequency fit, 1 worker")

    # (4) The ResNet-18, hogwild, 4 workers, both granularities; then
    # (5) 1 worker, and the synchronous fit at the same global batch.
    train, test = synthetic_cifar10(*HOGWILD_ROWS)
    (x, y), (xv, yv) = images(train), images(test)
    def resnet():
        return compile_model(get_model("resnet18", dtype="bfloat16"), optimizer=HOGWILD_OPTIMIZER,
                             loss="categorical_crossentropy", metrics=["acc"],
                             input_shape=(32, 32, 3), seed=SEED)

    def hogwild(workers, granularity, epochs=HOGWILD_EPOCHS):
        m = SparkModel(resnet(), mode="hogwild", frequency="batch",
                       hogwild_granularity=granularity, mesh=["cuda:0"] * workers)
        t0 = time.perf_counter()
        h = m.fit(to_simple_rdd(None, x, y), epochs=epochs, batch_size=HOGWILD_BATCH,
                  validation_data=(xv, yv))
        fit_s = time.perf_counter() - t0
        rows = workers * (len(x) // workers // HOGWILD_BATCH) * HOGWILD_BATCH
        return m, h, {"history": h, "fit_s": fit_s, "workers": workers,
                      "granularity": granularity, "global_batch": workers * HOGWILD_BATCH,
                      "samples_per_s_epochs_2_on": epoch_rate(m.last_epoch_end_times, rows)}

    tracer = obs.enable_tracing(annotate_device=False)
    for granularity in ("tree", "leaf"):
        tracer.clear()
        m, h, rec = hogwild(ASYNC_WORKERS, granularity)
        buffer = m.async_trainer.server.buffer
        ev = m.evaluate(xv, yv)
        finite = all(bool(torch.isfinite(t).all()) for t in m.get_weights().values()
                     if t.is_floating_point())
        rec.update({"version": buffer.version, "applied_share": buffer.applied_share(),
                    "evaluate": ev, "weights_finite": finite,
                    "spans": span_ms(tracer.events(), ("async/unit", "async/pull",
                                                       "async/train", "async/push",
                                                       "ps/pull", "ps/push"))})
        report[f"resnet_hogwild_{granularity}"] = rec
        print(f"async resnet18 hogwild ({granularity}; batch frequency, bf16, "
              f"{ASYNC_WORKERS} workers on cuda:0, batch {HOGWILD_BATCH} each): "
              f"{json.dumps(rec)}", flush=True)
        check(all(np.isfinite(h["loss"])) and h["loss"][-1] < h["loss"][0],
              f"hogwild {granularity} loss not finite or not falling: {h['loss']}")
        check(finite and np.isfinite(list(ev.values())).all(),
              f"hogwild {granularity}: weights finite {finite}, evaluate {ev}")
    obs.disable_tracing()
    _, _, report["resnet_hogwild_1_worker"] = hogwild(1, "tree")
    print(f"async resnet18 hogwild, 1 worker: "
          f"{json.dumps(report['resnet_hogwild_1_worker'])}", flush=True)
    net = resnet()
    ends = []
    t0 = time.perf_counter()
    h = SparkModel(net, mode="synchronous", frequency="batch").fit(
        to_simple_rdd(None, x, y), epochs=HOGWILD_EPOCHS,
        batch_size=ASYNC_WORKERS * HOGWILD_BATCH, validation_data=(xv, yv),
        callbacks=[lambda e, state, metrics: ends.append(time.perf_counter())])
    rows = (len(x) // (ASYNC_WORKERS * HOGWILD_BATCH)) * ASYNC_WORKERS * HOGWILD_BATCH
    report["resnet_sync_same_global_batch"] = {
        "history": h, "fit_s": time.perf_counter() - t0,
        "batch": ASYNC_WORKERS * HOGWILD_BATCH, "samples_per_s_epochs_2_on": epoch_rate(ends, rows)}
    print(f"resnet18 synchronous fit at the same global batch: "
          f"{json.dumps(report['resnet_sync_same_global_batch'])}", flush=True)
    report["profile_hogwild_epoch"] = device_breakdown(
        lambda: hogwild(ASYNC_WORKERS, "tree", epochs=1), top=8)
    print(f"async resnet18 hogwild, one epoch with {ASYNC_WORKERS} workers (fit set-up "
          f"included; kernels on all streams summed): "
          f"{json.dumps(report['profile_hogwild_epoch'])}", flush=True)

    launches = dict(attention_cuda.launches)
    check(launches == {k: 0 for k in KERNELS},
          f"the async path launched flash kernels: {launches}")
    return launches, report


def lstm_step_errors(got, ref):
    """The card's LSTM step record against the CPU's (``step_record``):
    logits max |error|, loss relative, and for the gradients and the
    parameters after the step the worst tensor's ||error|| / ||ref||."""
    def by_norm(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()

    errors = {"logits": (got["logits"] - ref["logits"]).abs().max().item(),
              "loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"])}
    for key in ("grads", "params"):
        per = {n: by_norm(got[key][n], t) for n, t in ref[key].items()}
        errors[key], errors[f"{key}_worst"] = max(per.values()), max(per, key=per.get)
    return errors


def estimator_phase(attention_cuda):
    """BASELINE config 3 on the card: the IMDB LSTM through the ML
    pipeline, at the registry's full width. (1) One f32 Adam step on the
    card against the port's CPU path (``LSTM_CPU_LIMITS``; both also
    against a float64 CPU step, reported); (2) ``ElephasEstimator.fit``
    (synchronous, epoch frequency, Adam 1e-3, batch 32, 3 epochs) on the
    synthetic IMDB DataFrame, ``transform`` of the test frame (held-out
    accuracy above ``IMDB_MIN_ACC``), and one epoch in the default mode
    (asynchronous, local server, one worker) whose loss is finite and
    below the untrained model's; (3) with deterministic cuDNN: the
    transformer saved and reloaded predicts the same, ``SparkModel.save``/
    ``load_spark_model`` evaluates the same loss, the card's payload
    predicts on the CPU within ``IMDB_PAYLOAD_LIMIT``, the estimator's
    params survive save/load; (4) a fit resumed from its epoch-1
    checkpoint ends where the uninterrupted fit ends; (5) the bare train
    step's samples/s over ``LSTM_SWEEP`` and a kernel breakdown at batch
    32. No flash kernel may launch. Returns the launch counts and a
    report."""
    import tempfile

    from elephas_tpu_torch import (ElephasEstimator, SparkModel, compile_model,
                                   load_spark_model, to_simple_rdd)
    from elephas_tpu_torch.checkpoint import CheckpointManager
    from elephas_tpu_torch.data.dataframe import to_data_frame
    from elephas_tpu_torch.data.datasets import synthetic_imdb
    from elephas_tpu_torch.engine.step import init_train_state, make_train_step
    from elephas_tpu_torch.ml import load_ml_estimator, load_ml_transformer
    from elephas_tpu_torch.models import get_model

    attention_cuda.reset_launches()
    report = {"cudnn_benchmark": torch.backends.cudnn.benchmark}

    def lstm(device=None, seed=SEED):
        return compile_model(get_model("lstm", device=device, **LSTM_WIDTH),
                             optimizer=IMDB_ADAM, loss="sparse_categorical_crossentropy",
                             metrics=["acc"], input_shape=(IMDB_MAXLEN,),
                             input_dtype=torch.int32, seed=seed)

    (xtr, ytr), (xte, yte) = synthetic_imdb(*IMDB_ROWS, num_words=LSTM_WIDTH["vocab_size"],
                                            maxlen=IMDB_MAXLEN)
    card_model = lstm()
    card = next(card_model.module.parameters()).device
    check(card_model.count_params() == LSTM_PARAMS,
          f"lstm has {card_model.count_params()} parameters, not {LSTM_PARAMS}")

    # (1) One step on the card against the CPU, same seeded weights.
    x = torch.as_tensor(xtr[:IMDB_BATCH])
    y = torch.as_tensor(ytr[:IMDB_BATCH])

    def record(model, device):
        rec = step_record(model, x.to(device), y.to(device))
        rec["params"] = {n: p.detach().cpu() for n, p in model.module.named_parameters()}
        return rec

    cpu_model = lstm(device="cpu")
    wide = lstm(device="cpu")
    wide.module.double()
    got, ref, exact = record(card_model, card), record(cpu_model, "cpu"), record(wide, "cpu")
    errors = lstm_step_errors(got, ref)
    report["card_vs_cpu"] = {"errors": errors, "limits": LSTM_CPU_LIMITS,
                             "card_vs_cpu_float64": lstm_step_errors(got, exact),
                             "cpu_vs_cpu_float64": lstm_step_errors(ref, exact)}
    print(f"lstm step, card vs cpu (f32, batch {IMDB_BATCH} x {IMDB_MAXLEN}, Adam, TF32 off): "
          f"{json.dumps(report['card_vs_cpu'])}", flush=True)
    check(not breaches(errors, LSTM_CPU_LIMITS),
          f"lstm step, card vs cpu: breaches {breaches(errors, LSTM_CPU_LIMITS)}")
    del cpu_model, wide, got, ref, exact

    # (2) The pipeline: DataFrame -> ElephasEstimator.fit -> transform.
    df = to_data_frame(None, xtr.astype(np.float32), ytr.astype(np.float32))
    test_df = to_data_frame(None, xte.astype(np.float32), yte.astype(np.float32))
    config = {"name": "lstm", "kwargs": LSTM_WIDTH, "input_shape": [IMDB_MAXLEN],
              "input_dtype": "int32"}
    stage = dict(keras_model_config=config, optimizer_config=IMDB_ADAM,
                 loss="sparse_categorical_crossentropy", metrics=["acc"], batch_size=IMDB_BATCH,
                 num_workers=1, categorical=False, nb_classes=2)
    ends = []
    estimator = ElephasEstimator(mode="synchronous", frequency="epoch", epochs=IMDB_EPOCHS,
                                 callbacks=[lambda e, state, m: ends.append(time.perf_counter())],
                                 **stage)
    t0 = time.perf_counter()
    transformer = estimator.fit(df)
    fit_s = time.perf_counter() - t0
    outputs = transformer.transform(test_df)["prediction"]
    acc = float(np.mean(outputs.argmax(-1) == yte))
    rows = (IMDB_ROWS[0] // IMDB_BATCH) * IMDB_BATCH
    report["estimator"] = {"history": transformer.history, "fit_s": fit_s,
                           "epoch_s": np.diff([t0, *ends]).tolist(), "heldout_acc": acc,
                           "samples_per_s_epochs_2_3": epoch_rate(ends, rows)}
    print(f"imdb lstm estimator (synchronous, epoch frequency, batch {IMDB_BATCH}, "
          f"{IMDB_EPOCHS} epochs, {IMDB_ROWS[0]} synthetic rows): "
          f"{json.dumps(report['estimator'])}", flush=True)
    check(outputs.shape == (IMDB_ROWS[1], 2) and np.isfinite(outputs).all(),
          f"transform gave {outputs.shape}, expected ({IMDB_ROWS[1]}, 2), finite")
    check(all(np.isfinite(transformer.history["loss"])), "estimator loss not finite")
    check(acc > IMDB_MIN_ACC, f"held-out accuracy {acc:.4f} not above {IMDB_MIN_ACC}")

    untrained = SparkModel(lstm(), mode="synchronous").evaluate(xte, yte)["loss"]
    t0 = time.perf_counter()
    async_transformer = ElephasEstimator(epochs=1, **stage).fit(df)
    async_s = time.perf_counter() - t0
    async_loss = SparkModel(async_transformer.get_model(), mode="synchronous").evaluate(
        xte, yte)["loss"]
    report["estimator_async"] = {"history": async_transformer.history, "fit_s": async_s,
                                 "untrained_test_loss": untrained, "test_loss": async_loss}
    print(f"imdb lstm estimator, default mode (asynchronous, local server, 1 worker, "
          f"1 epoch): {json.dumps(report['estimator_async'])}", flush=True)
    check(np.isfinite(async_transformer.history["loss"]).all() and async_loss < untrained,
          f"async epoch: loss {async_transformer.history['loss']}, test loss {async_loss} "
          f"against {untrained} untrained")

    # (3) Serialization on the card, with cuDNN's deterministic algorithms.
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tmp = tempfile.TemporaryDirectory()
    try:
        path = Path(tmp.name)
        before = transformer.transform(test_df)["prediction"]
        transformer.save(path / "transformer.pkl")
        after = load_ml_transformer(path / "transformer.pkl").transform(test_df)["prediction"]
        model = SparkModel(transformer.get_model(), mode="synchronous")
        loss_before = model.evaluate(xte, yte)["loss"]
        model.save(path / "model.pkl")
        loss_after = load_spark_model(path / "model.pkl").evaluate(xte, yte)["loss"]
        small = to_data_frame(None, xte[:IMDB_CPU_ROWS].astype(np.float32),
                              yte[:IMDB_CPU_ROWS].astype(np.float32))
        on_cpu = load_ml_transformer(path / "transformer.pkl", device="cpu").transform(small)
        estimator.save(path / "estimator.pkl")
        params_equal = load_ml_estimator(path / "estimator.pkl").param_map() == \
            estimator.param_map()

        # (4) Checkpoint resume against an uninterrupted fit.
        rdd = to_simple_rdd(None, xtr.astype(np.float32), ytr.astype(np.float32))
        fit = dict(epochs=IMDB_EPOCHS, batch_size=IMDB_BATCH)
        whole = SparkModel(lstm(), mode="synchronous", frequency="epoch")
        whole.fit(rdd, **fit)
        manager = CheckpointManager(str(path / "ckpt"), keep=2)
        SparkModel(lstm(), mode="synchronous", frequency="epoch").fit(
            rdd, **{**fit, "epochs": 1}, callbacks=[manager.callback()])
        resumed_model = lstm(seed=SEED + 1)
        state = manager.restore(init_train_state(resumed_model))
        resumed = SparkModel(resumed_model, mode="synchronous", frequency="epoch")
        resumed.fit(rdd, **{**fit, "epochs": IMDB_EPOCHS - 1}, initial_state=state)
        manager.close()
    finally:
        tmp.cleanup()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    a, b = resumed.get_weights(), whole.get_weights()
    resume_error = (sum(float((a[k].double() - b[k].double()).norm() ** 2) for k in b)
                    / sum(float(b[k].double().norm() ** 2) for k in b)) ** 0.5
    report["serialization"] = {
        "transformer_reload_max_abs": float(np.abs(after - before).max()),
        "transformer_reload_argmax_equal": bool((after.argmax(-1) == before.argmax(-1)).all()),
        "spark_model_loss": [loss_before, loss_after],
        "card_payload_on_cpu_max_abs": float(np.abs(on_cpu["prediction"]
                                                    - before[:IMDB_CPU_ROWS]).max()),
        "estimator_params_equal": params_equal,
        "resume_vs_uninterrupted_by_norm": resume_error, "resumed_step": state.step,
        "resumed_epoch": state.epoch}
    print(f"imdb lstm serialization and resume (deterministic cuDNN): "
          f"{json.dumps(report['serialization'])}", flush=True)
    ser = report["serialization"]
    check(ser["transformer_reload_argmax_equal"]
          and ser["transformer_reload_max_abs"] <= IMDB_RELOAD_LIMIT,
          f"reloaded transformer: {ser['transformer_reload_max_abs']} (limit "
          f"{IMDB_RELOAD_LIMIT}), argmax equal {ser['transformer_reload_argmax_equal']}")
    check(loss_after == loss_before, f"load_spark_model evaluates {loss_after}, "
                                     f"the saved model {loss_before}")
    check(ser["card_payload_on_cpu_max_abs"] <= IMDB_PAYLOAD_LIMIT,
          f"the card's payload on the CPU is {ser['card_payload_on_cpu_max_abs']} off")
    check(params_equal, "load_ml_estimator changed the estimator's params")
    check(resume_error <= IMDB_RESUME_LIMIT,
          f"the resumed fit ends {resume_error:.3e} (by norm) from the uninterrupted one")

    # (5) The bare f32 train step over batches, and its kernels at 32.
    gen = torch.Generator(device=card).manual_seed(SEED)
    sweep, step_at = [], {}
    for batch in LSTM_SWEEP:
        model = lstm()
        step, state = make_train_step(model), init_train_state(model)
        bx = torch.randint(1, LSTM_WIDTH["vocab_size"], (batch, IMDB_MAXLEN), generator=gen,
                           device=card)
        by = torch.randint(0, 2, (batch,), generator=gen, device=card)
        for _ in range(LSTM_WARMUP):
            state, metrics = step(state, bx, by)
        float(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(LSTM_STEPS):
            state, metrics = step(state, bx, by)
        loss = float(metrics["loss"])
        elapsed = time.perf_counter() - t0
        sweep.append({"batch": batch, "step_ms": elapsed / LSTM_STEPS * 1e3,
                      "samples_per_s": batch * LSTM_STEPS / elapsed, "loss": loss})
        check(np.isfinite(loss), f"lstm step loss not finite at batch {batch}")
        step_at[batch] = (step, state, bx, by)
    report["step_sweep_f32"] = sweep
    print(f"lstm train step (f32, Adam, seq {IMDB_MAXLEN}): {json.dumps(sweep)}", flush=True)
    step, state, bx, by = step_at[LSTM_SWEEP[0]]
    report["profile_batch_32"] = device_breakdown(
        lambda: [step(state, bx, by) for _ in range(10)], top=8)
    print(f"lstm profile, 10 steps at batch {LSTM_SWEEP[0]}: "
          f"{json.dumps(report['profile_batch_32'])}", flush=True)

    launches = dict(attention_cuda.launches)
    check(launches == {k: 0 for k in KERNELS},
          f"the estimator path launched flash kernels: {launches}")
    return launches, report


def search_space():
    """Config 5's space (parity.py): Adam's lr log-uniform, the width a
    choice over ``SEARCH_WIDTHS``."""
    from elephas_tpu_torch.hyperparam import hp

    return {"lr": hp.loguniform(np.log(SEARCH_LR[0]), np.log(SEARCH_LR[1])),
            "width": hp.choice(list(SEARCH_WIDTHS))}


def asha_space():
    """``examples/asha_search.py``'s space."""
    from elephas_tpu_torch.hyperparam import hp

    lo, hi = ASHA_SPACE["lr"]
    return {"lr": hp.loguniform(np.log(lo), np.log(hi)),
            "width": hp.choice(list(ASHA_SPACE["width"])),
            "batch_size": hp.choice(list(ASHA_SPACE["batch_size"]))}


def asha_data():
    """``examples/asha_search.py``'s blobs: 4 classes in 20 dimensions,
    1536 training rows and 512 held out."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=3.0, size=(4, 20))
    labels = rng.integers(0, 4, size=2048)
    x = (centers[labels] + rng.normal(size=(2048, 20))).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[labels]
    return x[:1536], y[:1536], x[1536:], y[1536:]


def steady_trials(trials, buckets):
    """parity.py's steady window: each worker's trials in order, split into
    its first trial of each width bucket (the first model of that shape)
    and the rest."""
    from elephas_tpu_torch.hyperparam import width_bucket

    seen, first, steady = set(), [], []
    for t in sorted(trials, key=lambda t: (t["worker"], t["trial"])):
        key = (t["worker"], width_bucket(int(t["sample"]["width"]), buckets))
        (steady if key in seen else first).append(t)
        seen.add(key)
    return first, steady


def replay_tpe(trials, space, seed):
    """Each worker's TPE draws replayed on the CPU, fed the recorded
    losses: ``(worker, trial, sample)`` rows to equal the recorded ones."""
    from elephas_tpu_torch.hyperparam import _TPESampler

    rows = []
    for g in sorted({t["worker"] for t in trials}):
        sampler = _TPESampler(space, np.random.default_rng([seed, g]))
        for t in sorted((t for t in trials if t["worker"] == g), key=lambda t: t["trial"]):
            values, sample = sampler.suggest()
            rows.append((g, t["trial"], sample))
            sampler.observe(values, float(t["loss"]))
    return rows


def masked_vs_plain(masked, plain, active):
    """A one-hidden-layer masked model's ``step_record`` against the plain
    MLP's at the active width: logits and loss, and the live slice of each
    gradient and update, by ||error|| / ||plain|| (the worst tensor); and
    the largest |gradient| and |update| over the padded entries."""
    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    live = {"hidden.0.weight": (slice(0, active),), "hidden.0.bias": (slice(0, active),),
            "out.weight": (slice(None), slice(0, active)), "out.bias": (slice(None),)}
    pad = {"hidden.0.weight": (slice(active, None),), "hidden.0.bias": (slice(active, None),),
           "out.weight": (slice(None), slice(active, None))}
    out = {"logits": rel(masked["logits"], plain["logits"]),
           "loss": abs(masked["loss"] - plain["loss"]) / abs(plain["loss"])}
    for part in ("grads", "update"):
        errs = {n: rel(masked[part][n][idx], plain[part][n]) for n, idx in live.items()}
        out[part] = max(errs.values())
        out[f"{part}_worst"] = max(errs, key=errs.get)
        out[f"padded_{part}_max"] = max(float(masked[part][n][idx].abs().max())
                                        for n, idx in pad.items())
    return out


def search_phase(attention_cuda):
    """BASELINE config 5 on the card (parity.py's hyperparam_search at full
    size). (1) ``mlp_masked`` at width 100 in bucket 128 against the plain
    ``mlp`` at width 100 on its sliced weights: logits, loss and the live
    gradients within ``MASKED_LIMIT`` by norm, padded entries exactly zero
    gradient and unchanged by one Adam step; and under hogwild with two
    workers the mask and the padded entries unchanged to the bit. (2)
    ``HyperParamModel(None).minimize``: ``SEARCH_EVALS`` TPE trials, each a
    ``SyncTrainer`` fit of ``mlp_masked`` (buckets ``SEARCH_BUCKETS``,
    Adam injected) on ``current_trial_device()``: exactly that many
    trials, every sample equal to a CPU replay of TPE fed the card's
    losses, the best held-out accuracy above ``SEARCH_MIN_VAL_ACC``;
    steady-state trials/s and samples/s (each worker's first trial per
    bucket left out), first against steady trial seconds, and the card's
    busy share over one steady trial. (3) ``run_search`` on
    ``examples/asha_search.py``'s setup, every trial an ``mlp_masked``
    through ``SparkModel(mode="asynchronous")`` on the card, 2 pool
    workers on cuda:0 with a ``MemoryVault``, once more with one worker
    (its wall time against the two workers'), then again with w1 killed
    at its second unit and a ``GroupVault`` over a ``local`` server on the
    card, all under deterministic algorithms: no lost trial, more than
    ``ASHA_MIN_SAVED`` of the full budget saved, each run's winner,
    search digest, counts and epochs those of the scheduler replaying
    its own arrival order, every (trial, rung) unit one loss across the
    three runs, the mask unchanged by every asynchronous fit. No flash
    kernel may launch. Returns the launch counts and a report."""
    from elephas_tpu_torch import SparkModel, compile_model, to_simple_rdd
    from elephas_tpu_torch.data.datasets import load_mnist, one_hot
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine.sync import SyncTrainer
    from elephas_tpu_torch.hyperparam import (HyperParamModel, current_trial_device,
                                              width_bucket)
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parameter.server import make_server
    from elephas_tpu_torch.resilience import FaultInjector, FaultPlan
    from elephas_tpu_torch.tune import GroupVault, MemoryVault, run_search, sample_trials
    from elephas_tpu_torch.tune.scheduler import AshaScheduler

    attention_cuda.reset_launches()
    t_phase = time.perf_counter()
    report = {}
    (xtr, ytr), (xte, yte), real = load_mnist()
    n, n_val = SEARCH_ROWS
    x = xtr[:n].reshape(n, -1).astype(np.float32) / 255.0
    y = one_hot(ytr[:n], 10)
    xv = xte[:n_val].reshape(n_val, -1).astype(np.float32) / 255.0
    yv = one_hot(yte[:n_val], 10)
    data = (x, y, xv, yv)
    card = torch.device("cuda", 0)

    # (1) The masked MLP against the plain one at the active width.
    bucket, active = MASKED_CHECK
    adam = {"name": "adam", "learning_rate": 1e-3, "injected": True}

    def masked_model():
        return compile_model(get_model("mlp_masked", features=(bucket,), active=(active,),
                                       num_classes=10, device=card),
                             optimizer=adam, loss="categorical_crossentropy", metrics=["acc"],
                             input_shape=(x.shape[1],), seed=SEED)

    masked = masked_model()
    w = masked.get_weights()
    sliced = {"hidden.0.weight": w["hidden.0.weight"][:active],
              "hidden.0.bias": w["hidden.0.bias"][:active],
              "out.weight": w["out.weight"][:, :active], "out.bias": w["out.bias"]}
    plain = compile_model(get_model("mlp", features=(active,), num_classes=10, device=card),
                          params=sliced, optimizer=adam, loss="categorical_crossentropy",
                          metrics=["acc"])
    bx = torch.as_tensor(x[:SEARCH_BATCH]).to(card)
    by = torch.as_tensor(y[:SEARCH_BATCH]).to(card)
    errors = masked_vs_plain(step_record(masked, bx, by), step_record(plain, bx, by), active)
    hog = masked_model()
    before = hog.get_weights()
    SparkModel(hog, mode="hogwild", frequency="batch", mesh=[card, card]).fit(
        to_simple_rdd(None, x[:1024], y[:1024]), epochs=1, batch_size=SEARCH_BATCH)
    after = hog.get_weights()
    errors["hogwild_mask_equal"] = torch.equal(after["mask_0"], before["mask_0"])
    errors["hogwild_padded_equal"] = (
        torch.equal(after["hidden.0.weight"][active:], before["hidden.0.weight"][active:])
        and torch.equal(after["out.weight"][:, active:], before["out.weight"][:, active:]))
    errors["hogwild_live_moved"] = not torch.equal(after["out.weight"][:, :active],
                                                   before["out.weight"][:, :active])
    report["masked_mlp"] = {"bucket": bucket, "active": active, "limit": MASKED_LIMIT, **errors}
    print(f"masked mlp on the card (width {active} in bucket {bucket} vs mlp at {active}, "
          f"Adam, TF32 off): {json.dumps(report['masked_mlp'])}", flush=True)
    for key in ("logits", "loss", "grads"):
        check(errors[key] <= MASKED_LIMIT,
              f"masked mlp {key} {errors[key]:.3e} from the plain mlp (limit {MASKED_LIMIT})")
    check(errors["padded_grads_max"] == 0.0 and errors["padded_update_max"] == 0.0,
          f"padded entries moved: gradient {errors['padded_grads_max']}, "
          f"update {errors['padded_update_max']}")
    check(errors["hogwild_mask_equal"] and errors["hogwild_padded_equal"]
          and errors["hogwild_live_moved"],
          f"hogwild over the masked mlp: {json.dumps(errors)}")

    # (2) HyperParamModel: config 5 at full size.
    def objective(sample, data):
        xs, ys, xvs, yvs = data
        width = int(sample["width"])
        net = compile_model(
            get_model("mlp_masked", features=(width_bucket(width, SEARCH_BUCKETS),),
                      active=(width,), num_classes=10, device=current_trial_device()),
            optimizer={"name": "adam", "learning_rate": sample["lr"], "injected": True},
            loss="categorical_crossentropy", metrics=["acc"], input_shape=xs.shape[1:])
        trainer = SyncTrainer(net, build_mesh(num_data=1), frequency="batch")
        state, _ = trainer.fit(ShardedDataset(xs, ys, 1), epochs=SEARCH_EPOCHS,
                               batch_size=SEARCH_BATCH)
        val = trainer.evaluate_state(state, xvs, yvs)
        return {"loss": float(val["loss"]), "val_acc": float(val["acc"])}

    search = HyperParamModel(None)
    t0 = time.perf_counter()
    best = search.minimize(objective, lambda: data, max_evals=SEARCH_EVALS, space=search_space(),
                           seed=SEED, algo="tpe")
    search_s = time.perf_counter() - t0
    trials = search.trials
    recorded = [(t["worker"], t["trial"], t["sample"]) for t in
                sorted(trials, key=lambda t: (t["worker"], t["trial"]))]
    replay_equal = replay_tpe(trials, search_space(), SEED) == recorded
    first, steady = steady_trials(trials, SEARCH_BUCKETS)
    span = max(t["t_end"] for t in steady) - min(t["t_start"] for t in steady)
    rows = n * SEARCH_EPOCHS
    report["search"] = {
        "data_real": real, "workers": search.num_workers, "trials": len(trials),
        "best": {k: best[k] for k in ("loss", "val_acc", "sample", "worker", "trial")},
        "search_s": search_s, "tpe_replay_equal": replay_equal,
        "steady_trials": len(steady), "warmup_trials": len(first),
        "trials_per_s_steady": len(steady) / span,
        "samples_per_s_steady": rows * len(steady) / span,
        "first_trial_s": [t["secs"] for t in first],
        "steady_trial_s_mean": float(np.mean([t["secs"] for t in steady])),
        "per_trial": [[t["worker"], t["trial"], int(t["sample"]["width"]),
                       float(t["sample"]["lr"]), t["loss"], t["val_acc"], t["secs"]]
                      for t in sorted(trials, key=lambda t: (t["worker"], t["trial"]))],
    }
    steady_sample = steady[0]["sample"]
    with torch.cuda.device(card):
        report["search"]["profile_steady_trial"] = device_breakdown(
            lambda: objective(steady_sample, data), top=8)
    print(f"hyperparam search (config 5: mlp_masked buckets {SEARCH_BUCKETS}, {n} synthetic "
          f"MNIST rows, {SEARCH_EPOCHS} epochs at batch {SEARCH_BATCH}, TPE seed {SEED}, "
          f"{SEARCH_EVALS} trials): {json.dumps(report['search'])}", flush=True)
    check(len(trials) == SEARCH_EVALS, f"{len(trials)} trials ran, not {SEARCH_EVALS}")
    check(replay_equal, "the card's samples differ from TPE replayed on its losses")
    check(all(np.isfinite([t["loss"] for t in trials])), "a trial's loss is not finite")
    check(best["val_acc"] > SEARCH_MIN_VAL_ACC,
          f"best val_acc {best['val_acc']:.4f} not above {SEARCH_MIN_VAL_ACC}")

    # (3) The elastic ASHA tuner, clean and with w1 killed.
    ax, ay, axv, ayv = asha_data()
    masks_equal = []

    def trial_fn(config, state, epochs, seed, rung):
        width = int(config["width"])
        net = compile_model(
            get_model("mlp_masked", features=(width_bucket(width, ASHA_BUCKETS),),
                      active=(width,), num_classes=4, device=card),
            optimizer={"name": "adam", "learning_rate": config["lr"], "injected": True},
            loss="categorical_crossentropy", metrics=["acc"], input_shape=(ax.shape[1],),
            seed=seed)
        if state is not None:
            net.set_weights(state)
        mask = net.get_weights()["mask_0"]
        model = SparkModel(net, mode="asynchronous", frequency="epoch",
                           parameter_server_mode="local", num_workers=1)
        model.fit(to_simple_rdd(None, ax, ay, 1), epochs=int(epochs),
                  batch_size=int(config["batch_size"]))
        val = model.evaluate(axv, ayv)
        weights = net.get_weights()
        masks_equal.append(torch.equal(weights["mask_0"], mask))
        return {"loss": float(val["loss"]), "state": weights, "val_acc": float(val["acc"])}

    search_args = dict(num_trials=ASHA_TRIALS, seed=SEED, eta=ASHA_ETA, rungs=ASHA_RUNGS,
                       r0=ASHA_R0, workers=ASHA_WORKERS)

    def summary(doc, secs):
        return {"winner_digest": doc["winner_digest"], "search_digest": doc["search_digest"],
                "best_loss": doc["best_loss"], "winner_config": doc["winner"]["config"],
                "epochs_spent": doc["epochs_spent"],
                "full_budget_epochs": doc["full_budget_epochs"],
                "saved": 1.0 - doc["epochs_spent"] / doc["full_budget_epochs"],
                "lost_trials": doc["lost_trials"], "counts": doc["counts"],
                "pool": doc["pool"], "secs": secs}

    # Every result each run's scheduler receives, in arrival order.
    arrivals = {"clean": [], "one_worker": [], "killed": []}
    on_result = AshaScheduler.on_result

    def recording(name):
        def record(self, trial_id, rung, loss, delta_norm=None):
            arrivals[name].append((trial_id, rung, loss, delta_norm))
            return on_result(self, trial_id, rung, loss, delta_norm)
        return record

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        AshaScheduler.on_result = recording("clean")
        clean = run_search(trial_fn, asha_space(), vault=MemoryVault(), **search_args)
        clean_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        AshaScheduler.on_result = recording("one_worker")
        single = run_search(trial_fn, asha_space(), vault=MemoryVault(),
                            **{**search_args, "workers": 1})
        single_s = time.perf_counter() - t0
        AshaScheduler.on_result = recording("killed")
        specs = sample_trials(asha_space(), ASHA_TRIALS, SEED)
        template = compile_model(get_model("mlp_masked", features=ASHA_BUCKETS,
                                           num_classes=4, device="cpu"),
                                 input_shape=(ax.shape[1],)).get_weights()
        server = make_server("local", GroupVault.build_store(
            [spec.trial_id for spec in specs], template), device=card)
        server.start()
        try:
            vault = GroupVault(server.client())
            plan = FaultPlan(seed=SEED, kill_worker_at=ASHA_KILL)
            t0 = time.perf_counter()
            killed = run_search(trial_fn, asha_space(), vault=vault,
                                injector=FaultInjector(plan), **search_args)
            killed_s = time.perf_counter() - t0
            store = server.client().get_parameters()
            winner_ckpt = vault.load(killed["winner"]["trial"])
        finally:
            server.stop()
    finally:
        AshaScheduler.on_result = on_result
        torch.use_deterministic_algorithms(deterministic)
    slot = store[GroupVault.key(killed["winner"]["trial"])]
    unequal = unequal_units(arrivals.values())
    report["asha"] = {
        "clean": summary(clean, clean_s), "one_worker": summary(single, single_s),
        "killed": summary(killed, killed_s),
        "kill_plan": ASHA_KILL, "plan_trace_digest": plan.trace_digest(),
        "asynchronous_fits": len(masks_equal), "masks_unchanged": all(masks_equal),
        "vault_leaves": {"rung": [str(slot["rung"].dtype), str(slot["rung"].device)],
                         "loss": [str(slot["loss"].dtype), str(slot["loss"].device)]},
        "winner_checkpoint": [winner_ckpt.rung, winner_ckpt.loss],
        "arrivals": {name: len(sequence) for name, sequence in arrivals.items()},
        "unequal_units": unequal,
        "killed_equals_one_worker": [killed["winner_digest"], killed["search_digest"]]
        == [single["winner_digest"], single["search_digest"]],
        "clean_equals_one_worker": [clean["winner_digest"], clean["search_digest"]]
        == [single["winner_digest"], single["search_digest"]],
    }
    print(f"asha search (examples/asha_search.py's setup: {ASHA_TRIALS} mlp_masked trials "
          f"through SparkModel(mode='asynchronous'), eta {ASHA_ETA}, {ASHA_RUNGS} rungs, "
          f"r0 {ASHA_R0}, {ASHA_WORKERS} pool workers on cuda:0, deterministic algorithms; "
          f"clean with a MemoryVault, again with one worker, killed {ASHA_KILL} with a "
          f"GroupVault on a local server): {json.dumps(report['asha'])}", flush=True)
    print(f"asha wall time: {ASHA_WORKERS} workers {clean_s:.3f} s, one worker "
          f"{single_s:.3f} s, on one card", flush=True)
    for name, doc in (("clean", clean), ("one_worker", single), ("killed", killed)):
        saved = 1.0 - doc["epochs_spent"] / doc["full_budget_epochs"]
        check(doc["lost_trials"] == 0, f"asha {name}: {doc['lost_trials']} trials lost")
        check(saved > ASHA_MIN_SAVED, f"asha {name}: saved {saved:.3f}, not above "
                                      f"{ASHA_MIN_SAVED}")
    check(killed["pool"]["worker_deaths"] == 1,
          f"the kill plan killed {killed['pool']['worker_deaths']} workers, not 1")
    # Async halving promotes from the results that have arrived, and many
    # trials tie at loss 0.0 (the trial id breaks the tie among the
    # arrived), so a two-worker run's winner follows its workers' arrival
    # order (3 of 8 clean two-worker runs took another winner on the card,
    # scripts/torch_asha_order.py). So each run is held to the scheduler
    # replaying its own arrivals serially, and every unit (trial, rung) to
    # one loss in every run: a resumed or re-run unit trains what the
    # uninterrupted one-worker run's did.
    for name, doc in (("clean", clean), ("one_worker", single), ("killed", killed)):
        want = replay_asha(arrivals[name])
        got = {k: doc[k] for k in want}
        check(got == want, f"asha {name}: {got} is not its arrivals replayed: {want}")
    check(not unequal, f"asha units whose loss differs between runs: {unequal}")
    check(all(masks_equal), "an asynchronous fit changed a mask")
    check(slot["rung"].dtype == torch.float64 and slot["loss"].dtype == torch.float64
          and slot["rung"].device.type == "cuda", f"vault leaves {report['asha']['vault_leaves']}")
    check(winner_ckpt.rung == killed["winner"]["top_rung"]
          and winner_ckpt.loss == killed["best_loss"],
          f"the winner's vault checkpoint {winner_ckpt[1:]} is not its top rung's "
          f"({killed['winner']['top_rung']}, {killed['best_loss']})")

    report["phase_s"] = time.perf_counter() - t_phase
    launches = dict(attention_cuda.launches)
    check(launches == {k: 0 for k in KERNELS},
          f"the search path launched flash kernels: {launches}")
    return launches, report


class ResidencyProbe:
    """The bytes of streamed chunks on the device, as its allocator must
    hold them: a ``ChunkStream`` chunk is ``record_stream``-ed on the
    compute stream, so it stays from its upload until the compute stream
    has passed the steps that used it. Inside the ``with`` block each
    ``ChunkStream.put`` first takes the stream's ``mark()`` (an event
    after the work queued so far; None off the card, where that work is
    done), which releases every chunk used (``Chunk.arrays``) before it
    once it has completed; right after the upload the probe sums the
    chunks not yet used or not yet released. ``peak`` and ``chunk`` map
    each ``ChunkStream`` to its most bytes held and its largest chunk."""

    def __init__(self, sync_module):
        self.sync, self.peak, self.chunk = sync_module, {}, {}
        self._held, self._by_chunk = {}, {}

    def __enter__(self):
        self._put, self._arrays = self.sync.ChunkStream.put, self.sync.Chunk.arrays
        probe = self

        def put(stream, rows):
            held = probe._held.setdefault(id(stream), [])
            mark = stream.mark()
            for entry in held:
                if entry["used"] and "mark" not in entry:
                    entry["mark"] = mark
            chunk = probe._put(stream, rows)
            entry = {"bytes": chunk.nbytes, "used": False}
            probe._by_chunk[id(chunk)] = entry
            held.append(entry)
            held[:] = [e for e in held if "mark" not in e
                       or (e["mark"] is not None and not e["mark"].query())]
            key = id(stream)
            probe.peak[key] = max(probe.peak.get(key, 0), sum(e["bytes"] for e in held))
            probe.chunk[key] = max(probe.chunk.get(key, 0), chunk.nbytes)
            return chunk

        def arrays(chunk, batch_size):
            entry = probe._by_chunk.pop(id(chunk), None)
            if entry is not None:
                entry["used"] = True
            return probe._arrays(chunk, batch_size)

        self.sync.ChunkStream.put, self.sync.Chunk.arrays = put, arrays
        return self

    def __exit__(self, *exc):
        self.sync.ChunkStream.put, self.sync.Chunk.arrays = self._put, self._arrays

    def chunks_held(self):
        """Per stream, the most chunks held at once (peak over largest)."""
        return sorted(self.peak[k] / self.chunk[k] for k in self.peak)


def streamed_residency(x, y, name, slow_cycles=0):
    """One epoch of ``fit(stream_batches=STREAM_CHUNK)`` at batch
    ``STREAM_BATCH`` of ``name`` (``"resnet18"`` in bf16, or ``"mlp"``, a
    few launches a step) under a ``ResidencyProbe``. ``slow_cycles``: a
    ``torch.cuda._sleep`` after each chunk's steps slows the device, so
    that only the fit's own waits keep the host from running ahead (an
    eager ResNet-18's ~2,000 launches a chunk fill CUDA's launch queue
    first). Returns the most streamed bytes and chunks held."""
    from elephas_tpu_torch import SparkModel, compile_model, to_simple_rdd
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.models import get_model

    module = (get_model("resnet18", dtype="bfloat16") if name == "resnet18"
              else get_model("mlp", features=(512, 512), num_classes=10))
    net = compile_model(module, optimizer={"name": "momentum", "learning_rate": 0.1},
                        loss="categorical_crossentropy", metrics=["acc"],
                        input_shape=(32, 32, 3), seed=SEED)
    steps = sync.SyncTrainer._steps

    def slowed(self, *args):
        out = steps(self, *args)
        torch.cuda._sleep(slow_cycles)
        return out

    sync.SyncTrainer._steps = slowed if slow_cycles else steps
    try:
        with ResidencyProbe(sync) as probe:
            history = SparkModel(net, mode="synchronous", frequency="batch").fit(
                to_simple_rdd(None, x, y), epochs=1, batch_size=STREAM_BATCH,
                stream_batches=STREAM_CHUNK)
    finally:
        sync.SyncTrainer._steps = steps
    return {"model": name, "slow_cycles": slow_cycles, "loss": history["loss"],
            "streamed_data_peak_bytes": max(probe.peak.values()),
            "chunks_held": probe.chunks_held()}


def replay_asha(sequence):
    """The search phase's ASHA scheduler fed one run's arrivals, ``[(trial,
    rung, loss, delta_norm)]`` in order, one at a time: its winner and
    search digests, counts and epochs spent."""
    from elephas_tpu_torch.tune import sample_trials
    from elephas_tpu_torch.tune.scheduler import AshaScheduler

    sched = AshaScheduler(sample_trials(asha_space(), ASHA_TRIALS, SEED), eta=ASHA_ETA,
                          rungs=ASHA_RUNGS, r0=ASHA_R0)
    for trial_id, rung, loss, delta_norm in sequence:
        sched.on_lease(trial_id, rung, "w0")
        sched.on_result(trial_id, rung, loss, delta_norm)
    winner = sched.finalize()
    return {"winner_digest": None if winner is None else winner.spec.digest,
            "search_digest": sched.search_digest(), "counts": sched.counts(),
            "epochs_spent": sched.epochs_spent}


def unequal_units(runs):
    """The (trial, rung) units whose loss differs between (or within) the
    arrival sequences ``runs``."""
    losses = {}
    for sequence in runs:
        for trial_id, rung, loss, _ in sequence:
            losses.setdefault((trial_id, rung), set()).add(loss)
    return sorted(unit for unit, seen in losses.items() if len(seen) > 1)


def bitwise_equal(a, b):
    """Names of the entries of two equal-keyed dicts of tensors that
    differ in a single bit (empty: equal)."""
    return [k for k in a if not (a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                                 and torch.equal(a[k], b[k]))]


def run_steps(model, batches, captured, reseed=None):
    """``len(batches)`` train steps of ``model`` from its current weights,
    eager or captured (``CapturedStep``: 3 eager warm-up steps on a side
    stream, then the graph); ``reseed(i)`` re-seeds the module's dropout
    generator before step i, as an async worker does every unit. Returns
    every tensor the steps wrote (weights, BatchNorm statistics,
    optimizer state, each step's metrics), the step and the count."""
    from elephas_tpu_torch.engine.step import CapturedStep, init_train_state, make_train_step

    step = make_train_step(model)
    if captured:
        step = CapturedStep(model, step)
    state = init_train_state(model)
    metrics = []
    for i, (x, y) in enumerate(batches):
        if reseed is not None:
            model.module.dropout_generator.manual_seed(reseed(i))
        state, m = step(state, x, y)
        metrics.append(torch.stack(list(m.values())))
    torch.cuda.synchronize()
    out = {f"module/{k}": v.detach().clone() for k, v in model.module.state_dict().items()}
    for i, per_param in enumerate(state.optimizer.state.values()):
        out.update({f"opt/{i}/{k}": v.clone() for k, v in per_param.items()})
    out["metrics"] = torch.stack(metrics)
    return out, state, step


def fit_slice_phase(attention_cuda):
    """The sync fit's left-outs on the card. (1) Under deterministic
    algorithms, ``CAPTURE_STEPS`` train steps eagerly and through
    ``CapturedStep`` from the same weights must leave every weight,
    BatchNorm statistic, optimizer state and metric equal to the bit: the
    ResNet-18 (momentum, lr 0.1) at batch ``CAPTURE_BATCH`` in float32 and
    bf16; ``mlp_masked`` (bucket 128) under Adam with a cosine schedule,
    width 100, then width 64 loaded in place into the same module and
    stepped by the same graph; the CNN and the LSTM (cuDNN's RNN, batch
    ``AB_LSTM_BATCH``) with dropout from a CUDA generator re-seeded every
    step. (2) The autotune A/B table
    (``SyncTrainer._run_autotune``, ``AsyncTrainer._run_autotune``: the
    eager step against the captured one, ms per 2-batch run): the bf16
    ResNet-18 at ``AB_RESNET_BATCHES``, the search trial's ``mlp_masked``,
    the LSTM, the async CNN worker. (3) ``SparkModel(autotune=True)``:
    the bf16 ResNet-18 fit (the ResNet phase's settings) beside the same
    fit without autotune, both under deterministic algorithms (equal
    histories), and config 2's asynchronous CNN beside its eager run (the
    async phase holds that one); each autotuned fit records its winner
    and passes its path's checks. (4)
    ``fit(stream_batches=STREAM_CHUNK)`` of the bf16 ResNet-18 on
    ``STREAM_ROWS`` rows beside the resident fit (the streamed data on the
    card within ``STREAM_RESIDENCY_LIMIT``, memory above the model and
    optimizer, samples/s), and the async CNN streamed. (5) The repairs:
    a ``GroupVault`` load between another vault's two pushes on a server
    on the card gives no checkpoint; ``HyperParamModel(None)`` takes the
    one card once. (6) The ``train/epoch`` spans and gauges of a traced
    fit. No flash kernel may launch. Returns the launch counts and a
    report."""
    from elephas_tpu_torch import SparkModel, compile_model, obs, to_simple_rdd
    from elephas_tpu_torch.data.datasets import (one_hot, synthetic_cifar10, synthetic_imdb,
                                                 synthetic_mnist)
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.engine.async_engine import AsyncTrainer
    from elephas_tpu_torch.hyperparam import HyperParamModel
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parameter.server import make_server
    from elephas_tpu_torch.tune import GroupVault

    attention_cuda.reset_launches()
    t_phase = time.perf_counter()
    report = {"cudnn_benchmark": torch.backends.cudnn.benchmark}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    momentum = {"name": "momentum", "learning_rate": 0.1}

    def resnet(dtype="bfloat16"):
        return compile_model(get_model("resnet18", dtype=dtype), optimizer=momentum,
                             loss="categorical_crossentropy", metrics=["acc"],
                             input_shape=(32, 32, 3), seed=SEED)

    def masked(active, lr=CAPTURE_COSINE, injected=False):
        return compile_model(
            get_model("mlp_masked", features=(CAPTURE_MASKED[0],), active=(active,)),
            optimizer={"name": "adam", "learning_rate": lr, **({"injected": True}
                                                               if injected else {})},
            loss="categorical_crossentropy", metrics=["acc"], input_shape=(784,),
            seed=SEED + active)

    def cnn(dropout_rate=0.0):
        return compile_model(get_model("cnn", dropout_rate=dropout_rate),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="categorical_crossentropy", metrics=["acc"],
                             input_shape=(28, 28, 1), seed=SEED)

    def lstm(dropout_rate=0.0):
        return compile_model(get_model("lstm", dropout_rate=dropout_rate, **LSTM_WIDTH),
                             optimizer=IMDB_ADAM, loss="categorical_crossentropy",
                             metrics=["acc"], input_shape=(IMDB_MAXLEN,),
                             input_dtype=torch.int32, seed=SEED)

    def batches(n, shape, classes=10, count=CAPTURE_STEPS):
        return [(torch.rand((n, *shape), generator=gen, device="cuda"),
                 F.one_hot(torch.randint(0, classes, (n,), generator=gen, device="cuda"),
                           classes).float()) for _ in range(count)]

    # (1) Eager against captured, to the bit.
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    pairs = {}
    try:
        for dtype in ("float32", "bfloat16"):
            data = batches(CAPTURE_BATCH, (32, 32, 3))
            eager, _, _ = run_steps(resnet(dtype), data, captured=False)
            graph, _, step = run_steps(resnet(dtype), data, captured=True)
            pairs[f"resnet18_{dtype}"] = {"differ": bitwise_equal(eager, graph),
                                          "tensors": len(eager), "captures": step.captures}
            del eager, graph, step
        bucket, (wide, narrow) = CAPTURE_MASKED
        data = batches(AB_MASKED_BATCH, (784,))
        eager, _, _ = run_steps(masked(wide), data, captured=False)
        shared = masked(wide)
        graph, state, step = run_steps(shared, data, captured=True)
        pairs[f"mlp_masked_{bucket}_width_{wide}"] = {
            "differ": bitwise_equal(eager, graph), "tensors": len(eager),
            "captures": step.captures}
        # Width 64 into the same module, in place, through the same graph.
        addresses = [t.data_ptr() for t in shared.module.state_dict().values()]
        shared.module.load_state_dict(masked(narrow).module.state_dict())
        with torch.no_grad():
            for per_param in state.optimizer.state.values():
                for value in per_param.values():
                    value.zero_()
        state.optimizer.param_groups[0]["count"] = 0
        metrics = []
        for x, y in data:
            state, m = step(state, x, y)
            metrics.append(torch.stack(list(m.values())))
        torch.cuda.synchronize()
        graph = {f"module/{k}": v.detach().clone() for k, v in shared.module.state_dict().items()}
        for i, per_param in enumerate(state.optimizer.state.values()):
            graph.update({f"opt/{i}/{k}": v.clone() for k, v in per_param.items()})
        graph["metrics"] = torch.stack(metrics)
        eager, _, _ = run_steps(masked(narrow), data, captured=False)
        pairs[f"mlp_masked_{bucket}_width_{narrow}_same_graph"] = {
            "differ": bitwise_equal(eager, graph), "tensors": len(eager),
            "captures": step.captures,
            "addresses_kept": [t.data_ptr() for t in shared.module.state_dict().values()]
            == addresses}
        del shared, state, step
        data = batches(CAPTURE_CNN_BATCH, (28, 28, 1))
        runs = []
        for captured in (False, True):
            model = cnn(CAPTURE_DROPOUT)
            model.module.dropout_generator = torch.Generator(device="cuda")
            runs.append(run_steps(model, data, captured, reseed=lambda i: 977 + i))
        pairs["cnn_dropout_reseeded"] = {"differ": bitwise_equal(runs[0][0], runs[1][0]),
                                         "tensors": len(runs[0][0]),
                                         "captures": runs[1][2].captures}
        # The estimator's LSTM (cuDNN's RNN) at the A/B's batch, with dropout.
        data = [(torch.randint(1, LSTM_WIDTH["vocab_size"], (AB_LSTM_BATCH, IMDB_MAXLEN),
                               generator=gen, device="cuda", dtype=torch.int32), y)
                for _, y in batches(AB_LSTM_BATCH, (1,), classes=2)]
        runs = []
        for captured in (False, True):
            model = lstm(CAPTURE_DROPOUT)
            model.module.dropout_generator = torch.Generator(device="cuda")
            runs.append(run_steps(model, data, captured, reseed=lambda i: 977 + i))
        pairs[f"lstm_batch_{AB_LSTM_BATCH}_dropout_reseeded"] = {
            "differ": bitwise_equal(runs[0][0], runs[1][0]), "tensors": len(runs[0][0]),
            "captures": runs[1][2].captures}
        del runs
    finally:
        torch.use_deterministic_algorithms(deterministic)
    report["captured_vs_eager"] = pairs
    print(f"fit_slice captured vs eager ({CAPTURE_STEPS} steps, deterministic algorithms): "
          f"{json.dumps(pairs)}", flush=True)
    for name, pair in pairs.items():
        check(not pair["differ"] and pair["captures"] == 1,
              f"captured vs eager, {name}: {pair['differ'][:8]} differ")
        check(pair.get("addresses_kept", True), f"{name}: a tensor moved")

    # (2) The A/B table: ms per 2-batch run, eager against captured.
    table = {}

    def ab_sync(name, model, xs, ys):
        trainer = sync.SyncTrainer(model, build_mesh(num_data=1), frequency="batch",
                                   autotune=True)
        trainer._run_autotune(xs, ys)
        table[name] = trainer.autotune_choice
        print(f"fit_slice autotune {name}: {json.dumps(table[name])}", flush=True)

    for batch in AB_RESNET_BATCHES:
        xs, ys = zip(*batches(batch, (32, 32, 3), count=2))
        ab_sync(f"resnet18_bf16_batch_{batch}", resnet(), torch.stack(xs), torch.stack(ys))
    xs, ys = zip(*batches(AB_MASKED_BATCH, (784,), count=2))
    ab_sync(f"mlp_masked_{CAPTURE_MASKED[0]}_batch_{AB_MASKED_BATCH}",
            masked(CAPTURE_MASKED[1][0], lr=1e-3, injected=True),
            torch.stack(xs), torch.stack(ys))
    (xi, yi), _ = synthetic_imdb(n_train=2 * AB_LSTM_BATCH, n_test=1, maxlen=IMDB_MAXLEN)
    ab_sync(f"lstm_batch_{AB_LSTM_BATCH}", lstm(),
            torch.as_tensor(xi).cuda().reshape(2, AB_LSTM_BATCH, IMDB_MAXLEN),
            torch.as_tensor(one_hot(yi, 2)).cuda().reshape(2, AB_LSTM_BATCH, 2))
    train, test = synthetic_mnist(*ASYNC_CNN_ROWS)
    xm = train[0].astype(np.float32)[..., None] / 255.0
    ym = one_hot(train[1], 10)
    xmv, ymv = test[0].astype(np.float32)[..., None] / 255.0, one_hot(test[1], 10)
    worker_ab = AsyncTrainer(cnn(), ["cuda:0"] * ASYNC_WORKERS, autotune=True)
    worker_ab._run_autotune(ShardedDataset(xm, ym, ASYNC_WORKERS), AB_CNN_BATCH)
    table[f"cnn_async_worker_batch_{AB_CNN_BATCH}"] = worker_ab.autotune_choice
    print(f"fit_slice autotune cnn async worker: {json.dumps(worker_ab.autotune_choice)}",
          flush=True)
    report["autotune_table"] = table
    for name, choice in table.items():
        check(choice["winner"] in ("default", "cuda_graph")
              and set(choice["ms_per_2batch"]) == {"default", "cuda_graph"},
              f"autotune {name}: {choice}")

    # (3) Autotuned fits beside plain ones.
    (x_train, y_train), (x_test, y_test) = synthetic_cifar10(n_train=FIT_TRAIN, n_test=FIT_TEST)
    x_train, x_test = x_train.astype(np.float32) / 255.0, x_test.astype(np.float32) / 255.0
    y_train, y_test = one_hot(y_train, 10), one_hot(y_test, 10)
    # Under deterministic algorithms and cuDNN's heuristic (untimed)
    # choice, the plain and the autotuned fit take the same steps to the
    # bit, run after run: the eval-mode accuracy held below, volatile after
    # 48 steps at batch 1024 while BatchNorm's running statistics lag
    # (0.18-0.79 over three nondeterministic card runs), is then one fixed
    # number, and the two histories must be equal.
    fits = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    benchmark = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    try:
        for tuned in (False, True):
            model = SparkModel(resnet(), mode="synchronous", frequency="batch", autotune=tuned)
            ends = []
            t0 = time.perf_counter()
            history = model.fit(to_simple_rdd(None, x_train, y_train), epochs=FIT_EPOCHS,
                                batch_size=STREAM_BATCH, validation_data=(x_test, y_test),
                                callbacks=[lambda e, state, m: ends.append(time.perf_counter())])
            rows = (FIT_TRAIN // STREAM_BATCH) * STREAM_BATCH
            key = "autotuned" if tuned else "plain"
            fits[key] = {"history": history, "fit_s": time.perf_counter() - t0,
                         "autotune": model.last_autotune,
                         "samples_per_s_epochs_2_3": 2 * rows / (ends[2] - ends[0])}
            print(f"fit_slice resnet18 bf16 fit, batch {STREAM_BATCH}, {key} (deterministic "
                  f"algorithms, cudnn.benchmark off): {json.dumps(fits[key])}", flush=True)
            loss = history["loss"]
            check(all(np.isfinite(loss)) and loss[-1] < loss[0], f"fit loss did not fall: {loss}")
            check(history["val_acc"][-1] > FIT_MIN_VAL_ACC,
                  f"val_acc {history['val_acc'][-1]:.4f} not above {FIT_MIN_VAL_ACC}")
    finally:
        torch.use_deterministic_algorithms(deterministic)
        torch.backends.cudnn.benchmark = benchmark
    tuned_history = dict(fits["autotuned"]["history"])
    check(tuned_history.pop("compile_autotune", None) in ("default", "cuda_graph"),
          f"autotuned fit recorded {fits['autotuned']['history'].get('compile_autotune')}")
    check(tuned_history == fits["plain"]["history"],
          "the autotuned fit's history is not the plain fit's")
    report["resnet_fit"] = fits

    def async_cnn(held=True, **fit_args):
        """Config 2's CNN; ``held``: PR 8's async checks, else (the eager
        run the async phase already holds) the locked pushes and a finite
        falling loss only."""
        autotune = fit_args.pop("autotune", False)
        model = SparkModel(cnn(), mode="asynchronous", frequency="epoch",
                           parameter_server_mode="local", mesh=["cuda:0"] * ASYNC_WORKERS,
                           autotune=autotune)
        t0 = time.perf_counter()
        history = model.fit(to_simple_rdd(None, xm, ym), epochs=ASYNC_CNN_EPOCHS,
                            batch_size=ASYNC_CNN_BATCH, validation_data=(xmv, ymv),
                            **fit_args)
        out = {"history": history, "fit_s": time.perf_counter() - t0,
               "samples_per_s_epochs_2_on": epoch_rate(model.last_epoch_end_times, len(xm)),
               "version": model.async_trainer.server.buffer.version,
               "evaluate": model.evaluate(xmv, ymv)}
        loss = history["loss"]
        check(all(np.isfinite(loss)) and loss[-1] < loss[0], f"cnn async loss: {loss}")
        check(out["version"] == ASYNC_WORKERS * ASYNC_CNN_EPOCHS,
              f"buffer version {out['version']}: every locked push must apply")
        if not held:
            return out
        check(len(history["val_acc"]) == ASYNC_CNN_EPOCHS, f"val: {history['val_acc']}")
        check(history["val_acc"][-1] > ASYNC_MIN_VAL_ACC,
              f"cnn async val_acc {history['val_acc'][-1]:.4f} not above {ASYNC_MIN_VAL_ACC}")
        check(abs(out["evaluate"]["loss"] - history["val_loss"][-1])
              <= 1e-4 * max(1.0, abs(history["val_loss"][-1])),
              f"evaluate {out['evaluate']} is not the last validation")
        return out

    report["cnn_async"] = {"eager": async_cnn(held=False),
                           "autotuned": async_cnn(autotune=True)}
    check(report["cnn_async"]["autotuned"]["history"]["compile_autotune"]
          in ("default", "cuda_graph"), "the autotuned async fit recorded no winner")
    print(f"fit_slice cnn async (config 2), eager / autotuned: "
          f"{json.dumps(report['cnn_async'])}", flush=True)

    # (4) Streamed against resident, on CIFAR-10's row count.
    (xs_big, ys_big), _ = synthetic_cifar10(n_train=STREAM_ROWS, n_test=1)
    xs_big, ys_big = xs_big.astype(np.float32) / 255.0, one_hot(ys_big, 10)
    streams = {}
    for stream_batches in (None, STREAM_CHUNK):
        net = resnet()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() + sum(  # + the momentum trace
            p.numel() * p.element_size() for p in net.module.parameters())
        torch.cuda.reset_peak_memory_stats()
        model = SparkModel(net, mode="synchronous", frequency="batch")
        ends = []
        t0 = time.perf_counter()
        with ResidencyProbe(sync) as probe:
            history = model.fit(to_simple_rdd(None, xs_big, ys_big), epochs=STREAM_EPOCHS,
                                batch_size=STREAM_BATCH, validation_data=(x_test, y_test),
                                stream_batches=stream_batches,
                                callbacks=[lambda e, state, m: ends.append(time.perf_counter())])
        torch.cuda.synchronize()
        rows = (STREAM_ROWS // STREAM_BATCH) * STREAM_BATCH
        key = "resident" if stream_batches is None else f"streamed_{stream_batches}"
        streams[key] = {
            "history": history, "fit_s": time.perf_counter() - t0,
            "peak_above_model_and_optimizer_bytes": torch.cuda.max_memory_allocated() - base,
            "streamed_data_peak_bytes": max(probe.peak.values(), default=0),
            "streamed_chunks_held": probe.chunks_held(),
            "samples_per_s_epoch_2": rows / (ends[1] - ends[0])}
        loss = history["loss"]
        check(all(np.isfinite(loss)) and loss[-1] < loss[0], f"{key} loss: {loss}")
        check(history["val_acc"][-1] > FIT_MIN_VAL_ACC,
              f"{key} val_acc {history['val_acc'][-1]:.4f} not above {FIT_MIN_VAL_ACC}")
        del model, net
    streams["residency_limit_bytes"] = STREAM_RESIDENCY_LIMIT
    report["resnet_stream"] = streams
    print(f"fit_slice resnet18 bf16, {STREAM_ROWS} rows, batch {STREAM_BATCH}, "
          f"{STREAM_EPOCHS} epochs, resident / streamed by {STREAM_CHUNK}: "
          f"{json.dumps(streams)}", flush=True)
    streamed = streams[f"streamed_{STREAM_CHUNK}"]
    check(0 < streamed["streamed_data_peak_bytes"] <= STREAM_RESIDENCY_LIMIT,
          f"streamed data on the card {streamed['streamed_data_peak_bytes']} B, limit "
          f"{STREAM_RESIDENCY_LIMIT}")
    # The same rows through a light step on a slowed device: here only
    # the fit's backpressure bounds what the card holds.
    slowed = streamed_residency(xs_big, ys_big, "mlp", STREAM_SLOW_CYCLES)
    streams["mlp_slowed_device"] = slowed
    print(f"fit_slice streamed residency, mlp on a slowed device: {json.dumps(slowed)}",
          flush=True)
    check(0 < slowed["streamed_data_peak_bytes"] <= STREAM_RESIDENCY_LIMIT,
          f"streamed data on a slowed card {slowed['streamed_data_peak_bytes']} B, limit "
          f"{STREAM_RESIDENCY_LIMIT}")
    with ResidencyProbe(sync) as probe:
        report["cnn_async_streamed"] = async_cnn(stream_batches=STREAM_CHUNK)
    report["cnn_async_streamed"]["streamed_chunks_held"] = probe.chunks_held()
    print(f"fit_slice cnn async streamed by {STREAM_CHUNK}: "
          f"{json.dumps(report['cnn_async_streamed'])}", flush=True)
    check(len(probe.peak) == ASYNC_WORKERS and max(probe.chunks_held()) <= 3,
          f"async streamed chunks held per worker: {probe.chunks_held()}")

    # (5) The repairs on the card.
    template = {"w": np.zeros(4, np.float32)}
    server = make_server("local", GroupVault.build_store([0], template), device="cuda:0")
    server.start()
    try:
        reader, seen = GroupVault(server.client()), []

        class Interleaved:
            def __init__(self, client):
                self.client = client

            def get_parameters(self):
                return self.client.get_parameters()

            def update_parameters(self, delta):
                self.client.update_parameters(delta)
                if not seen:
                    seen.append(reader.load(0))

        for rung, loss, value in ((0, 1.25, 3.0), (1, 0.5, 7.0)):
            seen.clear()
            GroupVault(Interleaved(server.client())).save(
                0, rung, loss, {"w": np.full(4, value, np.float32)})
            after = reader.load(0)
            check(seen == [None], f"a load between a save's pushes gave {seen}")
            check((after.rung, after.loss) == (rung, loss)
                  and np.array_equal(after.state["w"], np.full(4, value, np.float32)),
                  f"after the save: {after}")
        slot = server.client().get_parameters()["t0"]
        report["vault"] = {"between": "None", "store_device": str(slot["rung"].device)}
    finally:
        server.stop()
    search = HyperParamModel(None)
    report["hyperparam_devices"] = [str(d) for d in search.devices]
    check(search.devices == [torch.device("cuda", 0)] and search.num_workers == 1,
          f"HyperParamModel(None) took {search.devices}")

    # (6) The epoch loop's spans and gauges.
    tracer = obs.enable_tracing(annotate_device=False)
    try:
        model = SparkModel(resnet(), mode="synchronous", frequency="batch")
        model.fit(to_simple_rdd(None, x_train, y_train), epochs=2, batch_size=STREAM_BATCH,
                  validation_data=(x_test, y_test))
        events = tracer.events()
    finally:
        obs.disable_tracing()
    epochs = [e for e in events if e.name == "train/epoch"]
    report["spans"] = {"train/epoch": [e.args for e in epochs],
                       "train/eval": sum(e.name == "train/eval" for e in events)}
    check(len(epochs) == 2 and report["spans"]["train/eval"] == 2
          and all(e.args["delta_norm"] > 0 for e in epochs), f"spans: {report['spans']}")

    report["phase_s"] = time.perf_counter() - t_phase
    launches = dict(attention_cuda.launches)
    check(launches == {k: 0 for k in KERNELS},
          f"the fit-slice path launched flash kernels: {launches}")
    return launches, report


def mttr_summary(samples):
    """Count, min, median and max of a list of recovery seconds (None
    values and an empty list give ``n`` 0)."""
    values = sorted(float(v) for v in samples if v is not None)
    if not values:
        return {"n": 0, "min_s": None, "median_s": None, "max_s": None}
    return {"n": len(values), "min_s": values[0], "median_s": float(np.median(values)),
            "max_s": values[-1]}


def first_success(fn, timeout, errors=(Exception,), clock=time.monotonic,
                  sleep=time.sleep, interval=0.01):
    """Call ``fn`` until it returns without one of ``errors``; returns
    ``(value, seconds from the first call, attempts)``. Raises the last
    error once ``timeout`` seconds have passed."""
    t0, attempts = clock(), 0
    while True:
        attempts += 1
        try:
            return fn(), clock() - t0, attempts
        except errors:
            if clock() - t0 >= timeout:
                raise
        sleep(interval)


def flat_tree(tree, prefix=""):
    """A nested dict of tensors as ``{"a/b": tensor on the CPU}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v.detach().cpu() if isinstance(v, torch.Tensor) \
                else torch.as_tensor(np.asarray(v))
    return out


def frame_differences(frame_tree, tree):
    """Leaves where a decoded WAL frame and a tree (on any device) differ
    in a single bit, or that one of them lacks (empty: equal)."""
    a, b = flat_tree(frame_tree), flat_tree(tree)
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    return bitwise_equal(a, b)


def fs_type(path):
    """The file system type of the mount holding ``path`` (/proc/mounts;
    None where it cannot be read)."""
    path, best = os.path.realpath(path), (None, "")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) > 2 and (path == parts[1] or path.startswith(
                        parts[1].rstrip("/") + "/")) and len(parts[1]) >= len(best[1]):
                    best = (parts[2], parts[1])
    except OSError:
        return None
    return best[0]


def wal_cost(tree, device, every, pushes, directory, seed=SEED):
    """What durability costs a push: a ``ParameterBuffer`` of ``tree`` on
    ``device`` takes ``pushes`` seeded deltas, each followed by the
    server's ``WalWriter.after_update`` (every ``every`` versions), and
    again with no log. Per durable snapshot: the copy to the host
    (``get_host_with_version``), the encode (``wire.encode_tree``, timed
    once more on the same snapshot) and the write with its fsync (the
    append less the encode); per push: the wall time the ack waits for,
    with and without the log."""
    from elephas_tpu_torch.parameter import wire
    from elephas_tpu_torch.parameter.buffer import ParameterBuffer
    from elephas_tpu_torch.resilience import SnapshotWAL, WalWriter

    gen = torch.Generator(device=device).manual_seed(seed)
    deltas = [{k: torch.randn(v.shape, generator=gen, device=device, dtype=v.dtype) * 1e-3
               if v.is_floating_point() else torch.zeros_like(v)
               for k, v in flat_tree(tree).items()} for _ in range(2)]
    base = {k: v.to(device) for k, v in flat_tree(tree).items()}
    split = {"d2h": [], "encode": [], "write_fsync": []}

    class TimedWAL(SnapshotWAL):
        def append(self, snap, version):
            t0 = time.perf_counter()
            frames = wire.encode_tree(snap, version=version)
            t1 = time.perf_counter()
            out = super().append(snap, version)
            t2 = time.perf_counter()
            split["encode"].append((t1 - t0) * 1e3)
            split["write_fsync"].append((t2 - t1 - (t1 - t0)) * 1e3)
            split["bytes"] = frames.nbytes
            return out

    def run(with_wal):
        buffer = ParameterBuffer(base, device=device)
        writer = WalWriter(buffer, TimedWAL(directory, keep=2), every=every) \
            if with_wal else None
        if writer is not None:
            read = buffer.get_host_with_version

            def timed_read():
                t0 = time.perf_counter()
                out = read()
                split["d2h"].append((time.perf_counter() - t0) * 1e3)
                return out

            buffer.get_host_with_version = timed_read
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(pushes):
            buffer.apply_delta(deltas[i % 2])
            if writer is not None:
                writer.after_update()
        wall = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return wall * 1e3 / pushes

    plain_ms = run(False)
    wal_ms = run(True)
    return {"every": every, "pushes": pushes, "snapshots": len(split["d2h"]),
            "frame_bytes": split.get("bytes"), "ms_per_push": wal_ms,
            "no_wal_ms_per_push": plain_ms,
            **{f"{k}_ms": float(np.mean(v)) if v else None for k, v in split.items()
               if k != "bytes"}}


def chaos_phase(attention_cuda):
    """The async path's resilience on the card (BASELINE configs 2 and 4).
    (a) ``AsyncTrainer(elastic=True)`` on the CNN at the async phase's
    settings, ``CHAOS_WORKERS`` pool workers on cuda:0, a socket server
    with a write-ahead log at ``wal_every=1``: 12 units, none re-queued,
    the loss falls, one val entry per epoch above ``ASYNC_MIN_VAL_ACC``,
    and after the clean stop the WAL's newest frame is the buffer's
    version and state, bitwise; samples/s beside the same fit without a
    log, in turns, and with ``autotune=True`` (its winner's step). (b) A worker killed (``CHAOS_KILL_PLAN``), twice:
    exact units, deaths ``["w1"]``, equal plan digests. (c) The server
    killed at version ``CHAOS_KILL_VERSION``, held down
    ``CHAOS_OUTAGE_S``, warm-restarted on its port from its WAL and a
    cold init: at least the version durable at the kill, that frame
    bitwise; the fit completes, every outage recovered; the MTTR.
    (d) A partition window, twice: exact units, equal digests.
    (e) ``batches_per_unit``: the ledger's unit count. (f) The ResNet-18
    tree in a ``ShardGroup`` on the card (2 shards, a standby each): the
    plan equal to the CPU's, 8 seeded pushes, shard 0's primary killed,
    the spare promoted by the monitor, the first pull bitwise the last
    acked state, a zombie of the old primary fenced; the failover MTTR.
    (g) An elastic CNN fit over ``ps_shards=2, standby=1`` with shard 0's
    primary killed mid-fit: exact units through a promotion. (h) Pinned
    pulls against (a)'s log: the live and an older version bitwise, a
    pruned one ``VersionUnavailable``. (i) What durability costs a push
    (``wal_cost``) for the CNN's and the ResNet-18's trees at
    ``WAL_COST_EVERY``. No flash kernel may launch. Returns the launch
    counts and a report."""
    import tempfile

    from elephas_tpu_torch import compile_model
    from elephas_tpu_torch.data.datasets import one_hot, synthetic_mnist
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine.async_engine import AsyncTrainer, store_of
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parameter import (FencedPrimaryError, GroupDirectory,
                                             ShardedParameterClient, ShardGroup,
                                             ShardGroupError, ShardPlan, wire)
    from elephas_tpu_torch.parameter.client import (ParameterServerUnavailable,
                                                    VersionUnavailable)
    from elephas_tpu_torch.parameter.server import make_server
    from elephas_tpu_torch.resilience import FaultPlan, SnapshotWAL, UnitLedger

    attention_cuda.reset_launches()
    t_phase = time.perf_counter()
    report = {}
    scratch = tempfile.mkdtemp(prefix="chaos-")
    report["wal_fs"] = fs_type(scratch)
    device = torch.device("cuda:0")

    def images(pair):
        x, y = pair
        return (x.astype(np.float32) / 255.0)[..., None], one_hot(y, 10)

    train, test = synthetic_mnist(*ASYNC_CNN_ROWS)
    (x, y), (xv, yv) = images(train), images(test)
    rows = len(x) // CHAOS_WORKERS // ASYNC_CNN_BATCH * ASYNC_CNN_BATCH * CHAOS_WORKERS

    def cnn():
        return compile_model(get_model("cnn"), optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="categorical_crossentropy", metrics=["acc"],
                             input_shape=(28, 28, 1), seed=SEED)

    def trainer(**kw):
        return AsyncTrainer(cnn(), ["cuda:0"] * CHAOS_WORKERS, frequency="epoch",
                            parameter_server_mode="socket", port=0, elastic=True, **kw)

    def fit(t, **kw):
        t0 = time.perf_counter()
        _, history = t.fit(ShardedDataset(x, y, CHAOS_WORKERS), epochs=ASYNC_CNN_EPOCHS,
                           batch_size=ASYNC_CNN_BATCH, **kw)
        seconds = time.perf_counter() - t0
        return history, {"fit_s": seconds, "samples_per_s": rows * ASYNC_CNN_EPOCHS / seconds,
                         "completed_units": t.elastic_stats["completed_units"],
                         "requeued_units": t.elastic_stats["requeued_units"],
                         "deaths": [d["worker"] for d in t.elastic_stats["worker_deaths"]],
                         "final_loss": history["loss"][-1]}

    # (a) The baseline elastic fit with a WAL, in turns with the same fit
    # without one (plain, WAL, WAL, plain), after an untimed one-epoch fit
    # (the workers' first cuDNN and stream set-up).
    trainer().fit(ShardedDataset(x, y, CHAOS_WORKERS), epochs=1, batch_size=ASYNC_CNN_BATCH)
    runs = {"plain": [], "wal": []}
    for i, arm in enumerate(("plain", "wal", "wal", "plain")):
        wal_dir = os.path.join(scratch, f"a{i}") if arm == "wal" else None
        t = trainer(ps_wal_dir=wal_dir, wal_every=1)
        history, rec = fit(t, validation_data=(xv, yv))
        rec["val_acc"] = history["val_acc"]
        runs[arm].append(rec)
        check(rec["completed_units"] == CHAOS_UNITS and rec["requeued_units"] == 0,
              f"baseline elastic fit ({arm}): {rec}")
        check(all(np.isfinite(history["loss"])) and history["loss"][-1] < history["loss"][0],
              f"baseline elastic loss did not fall: {history['loss']}")
        check(len(history["val_acc"]) == ASYNC_CNN_EPOCHS, f"val entries: {history['val_acc']}")
        # The accuracy bar holds the baseline, the first fit with a WAL;
        # the other turns time the log and print theirs (4 async workers
        # ended anywhere from 0.19 to 0.87 on the H100, PERF.md §6).
        check(i != 1 or history["val_acc"][-1] > ASYNC_MIN_VAL_ACC,
              f"baseline elastic val_acc {history['val_acc']} (bar {ASYNC_MIN_VAL_ACC})")
        if wal_dir is not None:
            wal = SnapshotWAL(wal_dir)
            version, frame = wal.restore_latest()
            diff = frame_differences(frame, t.server.buffer.get())
            check(version == t.server.buffer.version == CHAOS_UNITS and not diff,
                  f"WAL after the clean stop: newest {version}, buffer "
                  f"{t.server.buffer.version}, differing leaves {diff[:5]}")
            baseline_wal, baseline_loss = wal_dir, history["loss"][-1]
    report["baseline"] = runs
    report["wal_over_plain_samples_per_s"] = (
        np.mean([r["samples_per_s"] for r in runs["wal"]])
        / np.mean([r["samples_per_s"] for r in runs["plain"]]))
    print(f"chaos (a) baseline elastic CNN, {CHAOS_WORKERS} workers on cuda:0, socket PS: "
          f"{json.dumps(runs)}", flush=True)
    # The same fit with autotune=True: each worker id's clone runs the
    # A/B's winning step (a captured one keeps its graph across units,
    # the pulled weights loaded in place).
    t = trainer(autotune=True)
    history, rec = fit(t)
    rec["autotune"] = t.autotune_choice
    report["baseline_autotuned"] = rec
    print(f"chaos (a) autotuned: {json.dumps(rec)}", flush=True)
    check(rec["completed_units"] == CHAOS_UNITS and history["loss"][-1] < history["loss"][0]
          and t.autotune_choice["winner"] in ("default", "cuda_graph"),
          f"autotuned elastic fit: {rec}, loss {history['loss']}")

    # (b) A killed worker, twice.
    digests, kills = [], []
    for _ in range(2):
        plan = FaultPlan(**CHAOS_KILL_PLAN)
        history, rec = fit(trainer(fault_plan=plan))
        rec["loss_minus_baseline"] = rec["final_loss"] - baseline_loss
        kills.append(rec)
        check(rec["completed_units"] == CHAOS_UNITS and rec["deaths"] == ["w1"]
              and rec["requeued_units"] >= 1, f"kill_worker: {rec}")
        digests.append(plan.trace_digest())
    check(digests[0] == digests[1], f"kill_worker plan digests differ: {digests}")
    report["kill_worker"] = {"runs": kills, "digest": digests[0],
                             "within_tol": [abs(r["loss_minus_baseline"]) < CHAOS_LOSS_TOL
                                            for r in kills]}
    print(f"chaos (b) kill_worker: {json.dumps(report['kill_worker'])}", flush=True)

    # (c) The server killed, held down, warm-restarted from its WAL.
    wal_dir = os.path.join(scratch, "c")
    t = trainer(ps_wal_dir=wal_dir, ps_recovery_grace=CHAOS_GRACE_S)
    result, errors = {}, []

    def run_fit():
        try:
            result["out"] = fit(t)
        except BaseException as exc:  # surfaced below
            errors.append(exc)

    fit_thread = threading.Thread(target=run_fit)
    fit_thread.start()
    try:
        deadline = time.monotonic() + 60.0
        while t._elastic_server is None or t._elastic_server.buffer.version < CHAOS_KILL_VERSION:
            check(fit_thread.is_alive() and time.monotonic() < deadline,
                  f"kill_ps: the fit ended or stalled before version {CHAOS_KILL_VERSION}")
            time.sleep(0.001)
        server = t._elastic_server
        server.kill()
        killed_at, durable_at_kill = server.buffer.version, SnapshotWAL(wal_dir).latest_version()
        time.sleep(CHAOS_OUTAGE_S)
        params, buffers = store_of(cnn().module)  # a supervisor's restart: a cold init
        fresh = make_server("socket", {"params": params, "batch_stats": buffers},
                            port=server.port, device=device, wal_dir=wal_dir)
        version, frame = SnapshotWAL(wal_dir).restore_latest()
        diff = frame_differences(frame, fresh.buffer.get())
        restored = fresh.buffer.version
        fresh.start()
        t._elastic_server = fresh
    finally:
        fit_thread.join(timeout=300)
    check(not fit_thread.is_alive() and not errors, f"kill_ps fit: {errors}")
    history, rec = result["out"]
    stats = t.elastic_stats
    rec.update(killed_at=killed_at, durable_at_kill=durable_at_kill, restored=restored,
               outages=stats["ps_outages"], mttr=mttr_summary(stats["mttr_samples"]),
               loss_minus_baseline=rec["final_loss"] - baseline_loss)
    report["kill_ps"] = rec
    print(f"chaos (c) kill_ps: {json.dumps(rec)}", flush=True)
    check(restored >= durable_at_kill and restored == version and not diff,
          f"kill_ps restart: restored {restored}, durable at the kill {durable_at_kill}, "
          f"WAL newest {version}, differing leaves {diff[:5]}")
    check(rec["completed_units"] == CHAOS_UNITS and stats["ps_outages"]
          and all(o["recovered"] for o in stats["ps_outages"]) and stats["mttr_samples"],
          f"kill_ps fit: {rec}")

    # (d) A partition window, twice.
    digests, parts = [], []
    for _ in range(2):
        plan = FaultPlan(**CHAOS_PARTITION_PLAN)
        _, rec = fit(trainer(fault_plan=plan))
        parts.append(rec)
        check(rec["completed_units"] == CHAOS_UNITS, f"partition window: {rec}")
        digests.append(plan.trace_digest())
    check(digests[0] == digests[1], f"partition plan digests differ: {digests}")
    report["partition"] = {"runs": parts, "digest": digests[0]}
    print(f"chaos (d) partition: {json.dumps(report['partition'])}", flush=True)

    # (e) Batch-range units.
    t = trainer(batches_per_unit=CHAOS_BATCHES_PER_UNIT)
    history, rec = fit(t)
    nb = len(x) // CHAOS_WORKERS // ASYNC_CNN_BATCH
    ledger = UnitLedger(ASYNC_CNN_EPOCHS, list(range(CHAOS_WORKERS)),
                        n_batches={p: nb for p in range(CHAOS_WORKERS)},
                        batches_per_unit=CHAOS_BATCHES_PER_UNIT)
    rec["ledger_units"] = ledger.total_units
    report["batch_ranges"] = rec
    print(f"chaos (e) batches_per_unit={CHAOS_BATCHES_PER_UNIT}: {json.dumps(rec)}", flush=True)
    check(rec["completed_units"] == ledger.total_units and len(history["loss"]) == ASYNC_CNN_EPOCHS,
          f"batch ranges: {rec}, {len(history['loss'])} epochs")

    # (f) Shard failover on the ResNet-18 tree on the card.
    resnet = compile_model(get_model("resnet18"), optimizer={"name": "sgd", "learning_rate": 0.1},
                           loss="categorical_crossentropy", metrics=["acc"],
                           input_shape=(32, 32, 3), seed=SEED)
    params, buffers = store_of(resnet.module)
    tree = {"params": params, "batch_stats": buffers}
    n_params = sum(v.numel() for v in params.values())
    check(n_params == RESNET_PARAMS, f"ResNet-18 has {n_params} parameters")
    group = ShardGroup(tree, CHAOS_GROUP["k"], mode="socket", standby=CHAOS_GROUP["standby"],
                       wal_root=os.path.join(scratch, "f"), device=device,
                       suspect_after=CHAOS_GROUP["suspect_after"])
    cpu_plan = ShardPlan.build({g: {k: v.cpu() for k, v in tree[g].items()} for g in tree},
                               CHAOS_GROUP["k"])
    fo = {"digest": group.plan.digest, "bytes_per_shard": group.plan.bytes_per_shard()}
    check(group.plan.digest == cpu_plan.digest
          and group.plan.bytes_per_shard() == cpu_plan.bytes_per_shard(),
          f"the card's plan {fo} is not the CPU's {cpu_plan.describe()}")
    group.start()
    group.start_monitor(interval=CHAOS_MONITOR_S)  # beating every shard from here on
    client = group.client()
    gen = torch.Generator(device=device).manual_seed(SEED)
    try:
        t0 = time.perf_counter()
        for _ in range(CHAOS_GROUP_PUSHES):
            client.update_parameters({g: {k: (torch.randn(v.shape, generator=gen, device=device)
                                              * 1e-3 if v.is_floating_point()
                                              else torch.zeros_like(v))
                                          for k, v in tree[g].items()} for g in tree})
        fo["push_ms"] = (time.perf_counter() - t0) * 1e3 / CHAOS_GROUP_PUSHES
        acked = client.get_parameters()
        fo["versions"] = [group.primary(i).buffer.version for i in range(CHAOS_GROUP["k"])]
        _, fo["standby_catch_up_s"], _ = first_success(
            lambda: check(group.streamer_of(0).lag() == 0, "standby lag"), 30.0,
            errors=(AssertionError,))
        promoted_at = []
        watcher = threading.Thread(target=lambda: promoted_at.append(first_success(
            lambda: check(bool(group.promotions), "no promotion"), 30.0,
            errors=(AssertionError,), interval=0.001)[1]), daemon=True)
        dead = group.primary(0)
        old_boot = dead.boot
        group.kill_primary(0)
        watcher.start()
        after, fo["mttr_s"], fo["pull_attempts"] = first_success(
            client.get_parameters, 60.0, errors=(ParameterServerUnavailable, ShardGroupError,
                                                 OSError))
        watcher.join(timeout=60)
        fo["promotion_after_kill_s"] = promoted_at[0] if promoted_at else None
        fo["promotions"] = group.promotions
        diff = frame_differences(after, acked)
        check(group.promotions and group.promotions[0]["shard"] == 0
              and group.directory.is_fenced(old_boot) and not diff,
              f"failover: {group.promotions}, differing leaves {diff[:5]}")
        # A zombie of the old primary, serving its old (fenced) boot again.
        dead.start()
        stale = GroupDirectory(group.plan.digest, CHAOS_GROUP["k"])
        stale.publish(0, ShardGroup._address(dead), dead.boot)
        stale.publish(1, group.directory.address_of(1), group.primary(1).boot)
        stale.fence(old_boot)
        zombie_client = ShardedParameterClient("socket", stale, group.plan)
        try:
            zombie_client.get_parameters()
            fenced = False
        except FencedPrimaryError:
            fenced = True
        finally:
            zombie_client.close()
            dead.kill()
        check(fenced, "a client dialing the fenced primary's zombie was not refused")
        fo["zombie_fenced"] = fenced
    finally:
        client.close()
        group.stop()
    report["failover"] = fo
    print(f"chaos (f) ResNet-18 shard failover ({n_params} parameters, "
          f"{CHAOS_GROUP['k']} shards, a standby each): {json.dumps(fo)}", flush=True)

    # (g) An elastic CNN fit over the group, shard 0's primary killed mid-fit.
    t = trainer(ps_shards=CHAOS_GROUP["k"], standby=1, ps_wal_dir=os.path.join(scratch, "g"),
                ps_recovery_grace=CHAOS_GRACE_S)
    result, errors = {}, []
    fit_thread = threading.Thread(target=run_fit)
    fit_thread.start()
    try:
        deadline = time.monotonic() + 60.0
        while t._elastic_group is None or t._elastic_group.primary(0).buffer.version < 2:
            check(fit_thread.is_alive() and time.monotonic() < deadline,
                  "group fit: ended or stalled before version 2")
            time.sleep(0.001)
        group = t._elastic_group
        group.kill_primary(0)
    finally:
        fit_thread.join(timeout=300)
    check(not fit_thread.is_alive() and not errors, f"group fit: {errors}")
    _, rec = result["out"]
    rec["promotions"] = group.promotions
    rec["mttr"] = mttr_summary(t.elastic_stats["mttr_samples"])
    report["group_fit"] = rec
    print(f"chaos (g) elastic CNN over ps_shards=2, standby=1: {json.dumps(rec)}", flush=True)
    check(rec["completed_units"] == CHAOS_UNITS and group.promotions
          and group.promotions[0]["shard"] == 0, f"group fit: {rec}")

    # (h) Pinned pulls against (a)'s log (a server warm-restarted over it).
    server = make_server("socket", {"params": params, "batch_stats": buffers}, port=0,
                         device=device, wal_dir=baseline_wal, wal_keep=WAL_KEEP)
    server.start()
    pinned = {}
    try:
        client = server.client()
        wal = SnapshotWAL(baseline_wal)
        live = server.buffer.version
        versions = wal.versions()
        check(versions == list(range(live - WAL_KEEP + 1, live + 1)),
              f"WAL window {versions} at live version {live}")
        for v in (live, live - 1):
            frame = wire.decode(bytearray(wal.read_version(v))).tree
            pinned[v] = frame_differences(frame, client.get_parameters_pinned(v))
        try:
            client.get_parameters_pinned(live - WAL_KEEP)
            pinned["pruned"] = "served"
        except VersionUnavailable:
            pinned["pruned"] = "VersionUnavailable"
        client.close()
    finally:
        server.stop()
    report["pinned"] = {str(k): v for k, v in pinned.items()}
    print(f"chaos (h) pinned pulls: {json.dumps(report['pinned'])}", flush=True)
    check(all(not v for k, v in pinned.items() if k != "pruned")
          and pinned["pruned"] == "VersionUnavailable", f"pinned pulls: {pinned}")

    # (i) What durability costs a push on this card.
    cost = {}
    for name, tree_of in (("cnn", lambda: store_of(cnn().module)),
                          ("resnet18", lambda: (params, buffers))):
        p, b = tree_of()
        for every in WAL_COST_EVERY:
            cost[f"{name}/every{every}"] = wal_cost(
                {"params": p, "batch_stats": b}, device, every, WAL_COST_PUSHES,
                os.path.join(scratch, f"i-{name}-{every}"))
    report["wal_cost"] = cost
    print(f"chaos (i) WAL cost on {report['wal_fs']}: {json.dumps(cost)}", flush=True)

    report["phase_s"] = time.perf_counter() - t_phase
    launches = dict(attention_cuda.launches)
    check(launches == {k: 0 for k in KERNELS}, f"the chaos path launched flash kernels: {launches}")
    return launches, report


def seq_launch_schedule(layout, ranks, layers, causal=True):
    """Launches of each kernel (K1, K2, K3 alike) per rank for one train
    step of a ``layers``-deep LM at ``ranks`` sequence ranks: the ring's
    rank r runs its own hop and, causal, the r earlier owners' (1 + r),
    full every hop (ranks); Ulysses one full-length call a layer."""
    if layout == "ring":
        return [layers * ((1 + r) if causal else ranks) for r in range(ranks)]
    if layout == "ulysses":
        return [layers] * ranks
    raise ValueError(f"unknown layout {layout!r}")


def hop_checks(attention_cuda, shape=SP_HOP, phase="seq_parallel"):
    """The hop modes at a ring's hop ``shape`` on the kernels, in this
    process: K1 non-causal with the lse against ``blockwise_reference``,
    and K2/K3 of an earlier owner's hop given the global lse and delta of
    a two-hop combined softmax against ``flash_backward_reference``; each
    timed with its bound, plain version and SDPA's time."""
    from elephas_tpu_torch.ops.attention import (
        blockwise_reference,
        flash_attention_bwd,
        flash_attention_fwd,
        flash_backward_reference,
    )
    from elephas_tpu_torch.parallel.ring_attention import _combine

    report = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    for dtype in (torch.float32, torch.bfloat16):
        tiles = {name: attention_cuda.kernel_tiles(name, dtype, shape[3]) for name in KERNELS}
        q, ka, va, kb, vb, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                                 for _ in range(6))
        o2, l2 = flash_attention_fwd(q, kb, vb, causal=False)
        ref_o, ref_l = blockwise_reference(q, kb, vb, False, *tiles["flash_fwd"])
        err_o = (o2.float() - ref_o.float()).abs().max().item()
        err_l = (l2 - ref_l).abs().max().item()
        tol_o, tol_l = TOL[dtype]
        check(err_o <= tol_o and err_l <= tol_l,
              f"K1 non-causal with the lse disagrees at {shape} {dtype}: {err_o}, {err_l}")
        # The global softmax of the own hop (causal) and one earlier hop (full).
        o1, l1 = flash_attention_fwd(q, ka, va, causal=True)
        of, lse = _combine(o1.float(), l1, o2.float(), l2)
        out = of.to(dtype)
        delta = (do.float() * out.float()).sum(-1)
        got = dict(zip(("dq", "dk", "dv"), flash_attention_bwd(
            q, kb, vb, out, lse, do, delta, causal=False)))
        ref = dict(zip(("dq", "dk", "dv"), flash_backward_reference(
            q, kb, vb, out, lse, do, False, *tiles["flash_dq"])))
        ref["dk"], ref["dv"] = flash_backward_reference(
            q, kb, vb, out, lse, do, False, *tiles["flash_dkv"])[1:]
        errs = {"o": err_o, "lse": err_l}
        for label in ("dq", "dk", "dv"):
            err = (got[label].float() - ref[label].float()).abs().max().item()
            allowed = TOL_BWD[dtype] * max(1.0, ref[label].float().abs().max().item())
            whole, block = norm_errors(got[label], ref[label])
            check(err <= allowed and max(whole, block) <= TOL_BWD_NORM[dtype],
                  f"hop {label} with the global lse disagrees at {shape} {dtype}: "
                  f"{err} (allowed {allowed}), norm {whole}, block {block}")
            errs[label] = err
            errs[f"{label}_norm"] = max(whole, block)
        work = kernel_work(shape, q.element_size(), causal=False)
        plain_bwd_ms = cuda_ms(lambda: flash_backward_reference(
            q, kb, vb, out, lse, do, False, *tiles["flash_dkv"]), 3, 1)
        leaves = [t.detach().requires_grad_() for t in (q, kb, vb)]
        sdpa = F.scaled_dot_product_attention(*leaves)
        sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, leaves, do,
                                                          retain_graph=True), 20)
        times = {
            "flash_fwd": {
                "ms": cuda_ms(lambda: attention_cuda.flash_fwd(q, kb, vb, False), 20),
                "plain_ms": cuda_ms(lambda: blockwise_reference(
                    q, kb, vb, False, *tiles["flash_fwd"]), 3, 1),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, kb, vb), 20)},
            "flash_dq": {"ms": cuda_ms(lambda: attention_cuda.flash_bwd_dq(
                q, kb, vb, do, lse, delta, False), 20),
                "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms},
            "flash_dkv": {"ms": cuda_ms(lambda: attention_cuda.flash_bwd_dkv(
                q, kb, vb, do, lse, delta, False), 20),
                "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms},
        }
        for name in KERNELS:
            times[name]["bound_ms"], times[name]["bound_by"] = bound_ms(*work[name], dtype)
            if dtype == torch.float32:
                times[name]["bound_tc_ms"] = split_tf32_bound_ms(*work[name])
            print(f"{phase} hop {name} {shape} full {dtype}: {json.dumps(times[name])}",
                  flush=True)
        print(f"{phase} hop errors {dtype}: {json.dumps(errs)}", flush=True)
        report[str(dtype).split(".")[-1]] = {"errors": errs, "timing": times}
    return report


def seq_rank_checks(rank, config=None):
    """The checks of one rank of the seq-parallel phase: (a) ring and
    Ulysses attention at the LM's full shape, (b) 3 Adam steps of the
    full-width LM per layout on a seq mesh of SP_RANKS, (c) a data 2 x seq
    2 fit; each path's launches read with the counts set to 0 just before
    it. Returns the rank's report; a failed check raises."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.engine.step import init_train_state, make_loss_fn, make_train_step
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.ops import attention_cuda
    from elephas_tpu_torch.ops.attention import flash_attention
    from elephas_tpu_torch.parallel import collectives
    from elephas_tpu_torch.parallel.mesh import bind_mesh, build_mesh
    from elephas_tpu_torch.parallel.ring_attention import ring_attention
    from elephas_tpu_torch.parallel.seq_parallel import (
        SeqParallelTrainer,
        init_lm_state,
        make_lm_train_step,
        shard_lm_batch,
    )
    from elephas_tpu_torch.parallel.ulysses import ulysses_attention

    report = {"rank": rank, "errors": {}, "launches": {}, "staged_bytes": {}, "ms": {}}
    mesh = build_mesh(num_data=1, num_seq=SP_RANKS)
    local = SEQ // SP_RANKS
    rows = slice(rank * local, (rank + 1) * local)

    def run_path(name, fn):
        torch.cuda.synchronize()
        attention_cuda.reset_launches()
        collectives.reset_staged()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        report["ms"][name] = (time.perf_counter() - t0) * 1e3
        report["launches"][name] = dict(attention_cuda.launches)
        report["staged_bytes"][name] = collectives.staged_bytes
        return out

    def expect(name, counts):
        check(report["launches"][name] == counts,
              f"rank {rank} {name} launched {report['launches'][name]}, expected {counts}")

    # (a) ring and Ulysses attention against single-process flash_attention.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).split(".")[-1]
        q, k, v, do = (torch.randn((BATCH, 8, SEQ, 32), device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_o = flash_attention(*leaves)
        ref = [ref_o.detach()] + list(torch.autograd.grad(ref_o, leaves, do))
        ref = [t[:, :, rows] for t in ref]
        del leaves, ref_o
        for layout, attend in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            def go():
                shards = [t[:, :, rows].clone().requires_grad_() for t in (q, k, v)]
                with bind_mesh(mesh):
                    out = attend(*shards)
                return [out.detach(), *torch.autograd.grad(out, shards, do[:, :, rows])]

            name = f"attention_{layout}_{label}"
            got = run_path(name, go)
            errs = {}
            for i, part in enumerate(("o", "dq", "dk", "dv")):
                err = (got[i].float() - ref[i].float()).abs().max().item()
                scale = max(1.0, ref[i].float().abs().max().item())
                allowed = SP_TOL[dtype][i > 0] * (
                    1.0 if i == 0 and dtype == torch.bfloat16 else scale)
                check(err <= allowed, f"rank {rank} {name} {part}: {err} above {allowed}")
                errs[part] = err
            report["errors"][name] = errs
            per_rank = seq_launch_schedule(layout, SP_RANKS, 1)[rank]
            expect(name, {k_: per_rank for k_ in KERNELS})
        del q, k, v, do, ref

    # (b) the full-width LM: SP_STEPS Adam steps per layout against the
    # single-process flash model from the same weights.
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, 32000, (BATCH, SEQ + 1))
    x_np, y_np = tokens[:, :-1], tokens[:, 1:]

    def compiled(attention):
        return CompiledModel(get_model("transformer_lm", attention=attention),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="sparse_categorical_crossentropy", metrics=["acc"],
                             seed=SEED)

    def grads_of(model):
        """Each parameter's gradient, the key third of each qkv bias left
        out (its exact gradient is 0: what is left there is rounding)."""
        out = {}
        for n, p in model.module.named_parameters():
            g = p.grad
            if n.endswith("attn.qkv.bias"):
                third = len(g) // 3
                g = torch.cat([g[:third], g[2 * third:]])
            out[n] = g.clone()
        return out

    def reference():
        x, y = (torch.as_tensor(a, device="cuda") for a in (x_np, y_np))
        model = compiled("flash")
        loss, _ = make_loss_fn(model)(x, y)
        loss.backward()
        grads = grads_of(model)
        model.module.zero_grad(set_to_none=True)
        step, state = make_train_step(model), init_train_state(model)
        return [float(step(state, x, y)[1]["loss"]) for _ in range(SP_STEPS)], grads

    ref_losses, ref_grads = run_path("reference", reference)
    expect("reference", {k_: 4 * (1 + SP_STEPS) for k_ in KERNELS})
    xl, yl = shard_lm_batch(mesh, x_np, y_np, "cuda")
    for attention in ("ring", "ulysses", "auto"):
        model = compiled(attention)
        step = make_lm_train_step(model, mesh)
        state = init_lm_state(model, mesh)

        def go():
            losses, grads, times = [], None, []
            for i in range(SP_STEPS):
                t0 = time.perf_counter()
                _, metrics = step(state, xl, yl)
                losses.append(float(metrics["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    grads = grads_of(model)
            return losses, grads, times

        name = f"lm_{attention}"
        losses, grads, times = run_path(name, go)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        grad_err = max(((grads[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                       for n, g in ref_grads.items())
        check(loss_err <= SP_LOSS_RTOL, f"rank {rank} {name} losses {losses} vs the "
              f"single-process {ref_losses}: {loss_err} above {SP_LOSS_RTOL}")
        check(grad_err <= GRAD_RTOL, f"rank {rank} {name} first-step gradients: worst "
              f"max|d| / max|g| {grad_err} above {GRAD_RTOL}")
        report["errors"][name] = {"loss_rel": loss_err, "grad_rel": grad_err,
                                  "losses": losses, "reference_losses": ref_losses}
        report["ms"][f"{name}_steps"] = times
        layout = "ring" if attention == "ring" else "ulysses"  # 'auto': 8 heads over 4
        per_step = seq_launch_schedule(layout, SP_RANKS, model.module.num_layers)[rank]
        expect(name, {k_: per_step * SP_STEPS for k_ in KERNELS})
        del model, step, state, grads
    del ref_grads

    # (c) a data 2 x seq 2 fit with validation.
    mesh22 = build_mesh(num_data=2, num_seq=2)
    fit_rng = np.random.default_rng(SEED + 7)
    train = fit_rng.integers(0, 32000, (SP_FIT["rows"], SEQ + 1))
    val = fit_rng.integers(0, 32000, (SP_FIT["val_rows"], SEQ + 1))
    model = compiled("auto")
    trainer = SeqParallelTrainer(model, mesh22)
    bs = SP_FIT["batch_size"]
    state0 = run_path("fit_init", lambda: init_lm_state(model, mesh22))
    before = run_path("fit_eval_before", lambda: trainer.evaluate(state0, train, bs))["loss"]
    state, history = run_path("fit", lambda: trainer.fit(
        train, epochs=SP_FIT["epochs"], batch_size=bs, validation_tokens=val,
        initial_state=state0, seed=SEED))
    after = run_path("fit_eval_after", lambda: trainer.evaluate(state, train, bs))["loss"]
    check(after < before, f"rank {rank}: the fit's training-set loss went {before} -> {after}")
    check(len(history["val_loss"]) == 1 and all(np.isfinite(history["loss"])),
          f"rank {rank}: fit history {history}")
    steps = SP_FIT["rows"] // bs * SP_FIT["epochs"]
    layers = model.module.num_layers
    expect("fit", {"flash_fwd": layers * (steps + SP_FIT["val_rows"] // bs),
                   "flash_dq": layers * steps, "flash_dkv": layers * steps})
    for name in ("fit_eval_before", "fit_eval_after"):
        expect(name, {"flash_fwd": layers * SP_FIT["rows"] // bs, "flash_dq": 0,
                      "flash_dkv": 0})
    expect("fit_init", {k_: 0 for k_ in KERNELS})
    report["fit"] = {"history": history, "train_loss_before": before, "train_loss_after": after}
    return report


def rank_main(checks, config_path, rank):
    """Entry of one rank of a multi-process phase (``chip_smoke.py
    --seq-rank|--tp-rank CONFIG RANK``): joins the gloo group of
    ``config["world"]`` through ``parallel.distributed.initialize``, runs
    ``checks(rank, config)`` and writes its report as JSON."""
    from elephas_tpu_torch.parallel import distributed

    with open(config_path) as f:
        config = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    distributed.initialize(f"file://{config['store']}", config["world"], rank,
                           heartbeat_timeout=config["timeout"], backend="gloo")
    try:
        report = checks(rank, config)
    finally:
        torch.distributed.destroy_process_group()
    with open(f"{config['out']}.rank{rank}", "w") as f:
        json.dump(report, f)
    return 0


def run_ranks(flag, world, timeout, label, extra=None, env=None, expect=None):
    """``world`` processes of this script (``flag`` CONFIG RANK) on cuda:0
    in one gloo group; returns their reports and the seconds they took.
    ``extra`` joins the ranks' config, ``env`` their environment;
    ``expect``: the exit codes each rank must end with (all 0), a rank
    that ends otherwise leaving no report (None in the list). A rank's
    unexpected exit prints the tail of every rank's log and raises."""
    import tempfile

    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "2", **(env or {})}
    expect = expect or [0] * world
    with tempfile.TemporaryDirectory() as tmp:
        config = Path(tmp) / "config.json"
        config.write_text(json.dumps({"store": f"{tmp}/store", "out": f"{tmp}/report",
                                      "dir": tmp, "world": world, "timeout": timeout,
                                      **(extra or {})}))
        logs = [open(Path(tmp) / f"rank{r}.log", "w") for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag,
                                   str(config), str(r)], env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(world)]
        try:
            deadline = time.monotonic() + timeout
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        seconds = time.perf_counter() - t0
        if codes != expect:
            for r in range(world):
                tail = (Path(tmp) / f"rank{r}.log").read_text()[-3000:]
                print(f"{label} rank {r} log (tail):\n{tail}", flush=True)
        check(codes == expect,
              f"{label} ranks exited {codes}, expected {expect} (None: past {timeout} s)")
        return [json.loads((Path(tmp) / f"report.rank{r}").read_text()) if code == 0 else None
                for r, code in enumerate(codes)], seconds


SP_PATHS = ("attention_ring_float32", "attention_ulysses_float32", "attention_ring_bfloat16",
            "attention_ulysses_bfloat16", "lm_ring", "lm_ulysses", "lm_auto",
            "fit_eval_before", "fit", "fit_eval_after")


def seq_parallel_phase(attention_cuda):
    """The hop modes here, then SP_RANKS ranks on cuda:0 (``seq_rank_main``;
    the kernel libraries are built before they start). Returns the
    launches of the seq-parallel paths summed over the ranks, and the
    report."""
    t_phase = time.perf_counter()
    report = {"hops": hop_checks(attention_cuda)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks, report["ranks_s"] = run_ranks("--seq-rank", SP_RANKS, SP_TIMEOUT_S, "seq_parallel")
    summed = {path: {k: sum(r["launches"][path][k] for r in ranks) for k in KERNELS}
              for path in SP_PATHS}
    for path, want in (("lm_ring", 40 * SP_STEPS), ("lm_ulysses", 16 * SP_STEPS),
                       ("lm_auto", 16 * SP_STEPS)):
        check(summed[path] == {k: want for k in KERNELS},
              f"{path} launched {summed[path]} over the ranks, expected {want} of each "
              f"({want // SP_STEPS} a step)")
    histories = [r["fit"]["history"] for r in ranks]
    check(all(h == histories[0] for h in histories),
          f"the data 2 x seq 2 fit's history differs between ranks: {histories}")
    for r in ranks:
        print(f"seq_parallel rank {r['rank']} (four processes sharing one card over a "
              f"host-staged gloo exchange): step ms ring {r['ms']['lm_ring_steps']}, "
              f"ulysses {r['ms']['lm_ulysses_steps']}, auto {r['ms']['lm_auto_steps']}; "
              f"ring-hop bytes staged by the port per path {json.dumps(r['staged_bytes'])} "
              f"(gloo's own CUDA all_to_all and all_reduce also cross the host, uncounted); "
              f"errors {json.dumps(r['errors'])}", flush=True)
    report["ranks"] = [{k: r[k] for k in ("rank", "errors", "ms", "staged_bytes", "launches",
                                          "fit")} for r in ranks]
    report["launches_summed"] = summed
    report["phase_s"] = time.perf_counter() - t_phase
    total = {k: sum(summed[path][k] for path in SP_PATHS) for k in KERNELS}
    print(f"seq_parallel launches summed over the ranks: {json.dumps(summed)}", flush=True)
    return total, report


def tp_kernel_checks(attention_cuda):
    """K1-K3 at every shape the tensor-parallel paths give them, in float32
    and bf16, against their plain versions, each timed with its bounds,
    plain version and SDPA's time: causal at the shards' head counts
    (TP_SHAPES) and at the sp x tp ring's own hop (TP_HOP), and the ring's
    other hop modes at TP_HOP (``hop_checks``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    report = {}
    for shape in (*TP_SHAPES, TP_HOP):
        for dtype in (torch.float32, torch.bfloat16):
            errors, norms, timing = kernel_case(attention_cuda, shape, True, dtype, gen,
                                                timed=True)
            report[f"{shape} {str(dtype).split('.')[-1]}"] = {
                "errors": errors, "norms": norms, "timing": timing}
    report["hops"] = hop_checks(attention_cuda, TP_HOP, "tensor_parallel")
    return report


def replicated_digest(module):
    """A digest of the parameters a tensor-parallel module replicates:
    equal on every rank of a model group when they are equal to the bit."""
    import hashlib

    from elephas_tpu_torch.parallel.tensor_parallel import tensor_parallel_of

    layout = tensor_parallel_of(module).layout
    digest = hashlib.sha256()
    for name, p in module.named_parameters():
        if name not in layout:
            digest.update(name.encode())
            digest.update(p.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def tp_rank_checks(rank, config):
    """The checks of one rank of the tensor-parallel phase: (a) the
    full-width LM on data 1 x model 4 in float32 and bf16 (TP_STEPS Adam
    steps against the single-process flash model: losses, first gathered
    gradients; then a checkpoint of the f32 run restored into one
    process), (b) data 2 x model 2, (c) sp x tp on data 1 x seq 2 x model
    2 with the ring and Ulysses, and a ``SeqParallelTrainer(rules=
    LM_RULES).fit`` with validation, (d) ``shard_serving`` over model 4
    against the single-process engine (rank 0 serves, the others follow).
    Each path's launches are read with the counts set to 0 just before it.
    Returns the rank's report; a failed check raises."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.checkpoint import CheckpointManager
    from elephas_tpu_torch.engine.step import init_train_state, make_loss_fn, make_train_step
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.ops import attention_cuda
    from elephas_tpu_torch.parallel import collectives
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parallel.seq_parallel import (
        SeqParallelTrainer,
        init_lm_state,
        make_lm_train_step,
        shard_lm_batch,
    )
    from elephas_tpu_torch.parallel.tensor_parallel import (
        LM_RULES,
        init_lm_state_tp,
        make_lm_train_step_tp,
        tensor_parallel_of,
    )
    from elephas_tpu_torch.serving import InferenceEngine

    report = {"rank": rank, "errors": {}, "launches": {}, "tp_bytes": {}, "ms": {},
              "digests": {}}
    mesh14 = build_mesh(num_data=1, num_model=TP_RANKS)
    mesh22 = build_mesh(num_data=2, num_model=2)
    mesh122 = build_mesh(num_data=1, num_seq=2, num_model=2)

    def run_path(name, fn):
        torch.cuda.synchronize()
        attention_cuda.reset_launches()
        collectives.reset_tp_bytes()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        report["ms"][name] = (time.perf_counter() - t0) * 1e3
        report["launches"][name] = dict(attention_cuda.launches)
        report["tp_bytes"][name] = collectives.tp_bytes
        return out

    def expect(name, per_rank_step, steps=TP_STEPS):
        counts = {k: per_rank_step * steps for k in KERNELS}
        check(report["launches"][name] == counts,
              f"rank {rank} {name} launched {report['launches'][name]}, expected {counts}")

    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, 32000, (BATCH, SEQ + 1))
    x_np, y_np = tokens[:, :-1], tokens[:, 1:]

    def compiled(attention, dtype="float32"):
        return CompiledModel(get_model("transformer_lm", attention=attention, dtype=dtype),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="sparse_categorical_crossentropy", metrics=[], seed=SEED)

    def without_key_bias(name, g):
        """The key third of a qkv bias left out (its exact gradient is 0:
        what is left there is rounding)."""
        if name.endswith("attn.qkv.bias"):
            third = len(g) // 3
            return torch.cat([g[:third], g[2 * third:]])
        return g

    def reference(dtype):
        x, y = (torch.as_tensor(a, device="cuda") for a in (x_np, y_np))
        model = compiled("flash", dtype)
        loss, _ = make_loss_fn(model)(x, y)
        loss.backward()
        grads = {n: without_key_bias(n, p.grad).clone()
                 for n, p in model.module.named_parameters()}
        model.module.zero_grad(set_to_none=True)
        step, state = make_train_step(model), init_train_state(model)
        return [float(step(state, x, y)[1]["loss"]) for _ in range(TP_STEPS)], grads

    def train(model, step, state, batch, gather_grads=False):
        losses, grads, times, moved = [], None, [], []
        for i in range(TP_STEPS):
            before = collectives.tp_bytes
            t0 = time.perf_counter()
            _, metrics = step(state, *batch)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            moved.append(collectives.tp_bytes - before)
            if i == 0 and gather_grads:
                info = tensor_parallel_of(model.module)
                grads = {n: without_key_bias(n, info.gather(n, p.grad))
                         for n, p in model.module.named_parameters()}
        return losses, grads, times, moved

    def hold(name, losses, ref_losses, grads=None, ref_grads=None, dtype=torch.float32):
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        check(loss_err <= SP_LOSS_RTOL, f"rank {rank} {name} losses {losses} vs the "
              f"single-process {ref_losses}: {loss_err} above {SP_LOSS_RTOL}")
        errs = {"loss_rel": loss_err, "losses": losses, "reference_losses": ref_losses}
        if grads is not None:
            worst = 0.0
            for n, g in ref_grads.items():
                err = (grads[n].float() - g.float()).abs().max().item()
                allowed = SP_TOL[dtype][1] * max(1.0, g.float().abs().max().item())
                check(err <= allowed, f"rank {rank} {name} gradient of {n}: {err} above "
                      f"{allowed}")
                worst = max(worst, err / allowed)
            errs["grad_worst_of_limit"] = worst
        report["errors"][name] = errs

    # (a) data 1 x model 4, float32 and bf16, then a checkpoint of the f32 run.
    refs = {}
    for dtype in ("float32", "bfloat16"):
        refs[dtype] = run_path(f"reference_{dtype}", lambda: reference(getattr(torch, dtype)))
        expect(f"reference_{dtype}", 4, 1 + TP_STEPS)
        model = compiled("flash", dtype)
        step = make_lm_train_step_tp(model, mesh14)
        state = init_lm_state_tp(model, mesh14)
        name = f"lm_model4_{dtype}"
        losses, grads, times, moved = run_path(name, lambda: train(
            model, step, state, (x_np, y_np), gather_grads=True))
        hold(name, losses, refs[dtype][0], grads, refs[dtype][1], getattr(torch, dtype))
        expect(name, 4)
        report["ms"][f"{name}_steps"] = times
        report["tp_bytes"][f"{name}_steps"] = moved
        report["digests"][name] = replicated_digest(model.module)
        if dtype == "float32":
            directory = os.path.join(config["dir"], "tp_checkpoint")
            full = {k: v.clone() for k, v in tensor_parallel_of(model.module).full_state(
                model.module.state_dict()).items()}
            manager = CheckpointManager(directory)
            manager.save(state, block=True)
            manager.close()
            torch.distributed.barrier()  # rank 0 has written
            if rank == 0:
                single = compiled("flash")
                restored = CheckpointManager(directory).restore(init_train_state(single))
                unequal = [k for k, v in single.module.state_dict().items()
                           if not torch.equal(v, full[k])]
                check(restored.step == TP_STEPS and not unequal,
                      f"the checkpoint restored into one process at step {restored.step} "
                      f"differs from the gathered state in {unequal}")
                report["checkpoint"] = {"step": restored.step, "tensors": len(full)}
                del single, restored
        del model, step, state, grads
        torch.cuda.empty_cache()
    ref_losses = refs["float32"][0]
    del refs

    # (b) data 2 x model 2.
    model = compiled("flash")
    step = make_lm_train_step_tp(model, mesh22)
    state = init_lm_state_tp(model, mesh22)
    losses, _, times, moved = run_path("lm_data2_model2", lambda: train(
        model, step, state, (x_np, y_np)))
    hold("lm_data2_model2", losses, ref_losses)
    expect("lm_data2_model2", 4)
    report["ms"]["lm_data2_model2_steps"] = times
    report["tp_bytes"]["lm_data2_model2_steps"] = moved
    report["digests"]["lm_data2_model2"] = replicated_digest(model.module)
    del model, step, state

    # (c) sp x tp: data 1 x seq 2 x model 2, the ring and Ulysses, then a fit.
    batch = shard_lm_batch(mesh122, x_np, y_np, "cuda")
    for attention in ("ring", "ulysses"):
        model = compiled(attention)
        step = make_lm_train_step(model, mesh122)
        state = init_lm_state(model, mesh122, rules=LM_RULES)
        name = f"lm_sptp_{attention}"
        losses, _, times, moved = run_path(name, lambda: train(model, step, state, batch))
        hold(name, losses, ref_losses)
        expect(name, seq_launch_schedule(attention, 2, model.module.num_layers)[
            mesh122.seq_rank])
        report["ms"][f"{name}_steps"] = times
        report["tp_bytes"][f"{name}_steps"] = moved
        report["digests"][name] = replicated_digest(model.module)
        del model, step, state
    fit_rng = np.random.default_rng(SEED + 7)
    train_rows = fit_rng.integers(0, 32000, (SP_FIT["rows"], SEQ + 1))
    val_rows = fit_rng.integers(0, 32000, (SP_FIT["val_rows"], SEQ + 1))
    model = compiled("auto")
    trainer = SeqParallelTrainer(model, mesh122, rules=LM_RULES)
    bs = SP_FIT["batch_size"]
    _, history = run_path("fit", lambda: trainer.fit(
        train_rows, epochs=SP_FIT["epochs"], batch_size=bs, validation_tokens=val_rows,
        seed=SEED))
    check(len(history["val_loss"]) == 1 and all(np.isfinite(history["loss"] +
                                                            history["val_loss"])),
          f"rank {rank}: the sp x tp fit's history {history}")
    steps = SP_FIT["rows"] // bs * SP_FIT["epochs"]
    layers = model.module.num_layers
    check(report["launches"]["fit"] == {
        "flash_fwd": layers * (steps + SP_FIT["val_rows"] // bs),
        "flash_dq": layers * steps, "flash_dkv": layers * steps},
        f"rank {rank} fit launched {report['launches']['fit']}")
    report["fit"] = {"history": history}
    del model, trainer
    torch.cuda.empty_cache()

    # (d) shard_serving over model 4 against the single-process engine.
    module = CompiledModel(get_model("transformer_lm"), loss="sparse_categorical_crossentropy",
                           metrics=[], seed=SEED).module
    engine = InferenceEngine(module, **SERVE_ENGINE).shard_serving(mesh14)
    if rank != 0:
        run_path("serving", engine.follow)
    else:
        traffic = serving_traffic()[:TP_SERVE_REQUESTS]

        def sharded():
            try:
                return serve(engine, traffic)
            finally:
                engine.close()

        streams, elapsed = run_path("serving", sharded)
        plain, plain_s = serve(InferenceEngine(module, **SERVE_ENGINE), traffic)

        def gap_at(i, k):
            with torch.no_grad():
                context = torch.as_tensor([traffic[i][0] + plain[i][:k]], device="cuda")
                top2 = torch.topk(module(context)[0, -1], 2).values
            return float(top2[0] - top2[1])

        summary = engine.metrics.summary()
        new_tokens = sum(n for _, n in traffic)
        report["serving"] = {
            "requests": len(traffic), "new_tokens": new_tokens, "s": elapsed,
            "new_tokens_per_s": new_tokens / elapsed, "itl_s_p50": summary["itl_s_p50"],
            "single_process_s": plain_s,
            "single_process_new_tokens_per_s": new_tokens / plain_s,
            "streams": compare_streams(plain, streams, gap_at),
            "stats": engine.stats()["tensor_parallel"]}
    check(report["launches"]["serving"] == {k: 0 for k in KERNELS},
          f"rank {rank}: the sharded serving path launched {report['launches']['serving']}")
    return report


TP_PATHS = ("lm_model4_float32", "lm_model4_bfloat16", "lm_data2_model2", "lm_sptp_ring",
            "lm_sptp_ulysses", "fit", "serving")


def tensor_parallel_phase(attention_cuda):
    """K1-K3 at the shards' head counts here, then TP_RANKS ranks on cuda:0
    (``tp_rank_checks``). Returns the launches of the tensor-parallel
    paths summed over the ranks, and the report."""
    t_phase = time.perf_counter()
    report = {"kernels": tp_kernel_checks(attention_cuda)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ranks, report["ranks_s"] = run_ranks("--tp-rank", TP_RANKS, TP_TIMEOUT_S,
                                         "tensor_parallel")
    summed = {path: {k: sum(r["launches"][path][k] for r in ranks) for k in KERNELS}
              for path in TP_PATHS}
    ring = 2 * sum(seq_launch_schedule("ring", 2, 4))  # two model indices
    for path, want in (("lm_model4_float32", 16), ("lm_model4_bfloat16", 16),
                       ("lm_data2_model2", 16), ("lm_sptp_ring", ring),
                       ("lm_sptp_ulysses", 16)):
        check(summed[path] == {k: want * TP_STEPS for k in KERNELS},
              f"{path} launched {summed[path]} over the ranks, expected {want} of each a step")
    for path in ("lm_model4_float32", "lm_model4_bfloat16", "lm_data2_model2",
                 "lm_sptp_ring", "lm_sptp_ulysses"):
        digests = {r["digests"][path] for r in ranks}
        check(len(digests) == 1, f"{path}: the replicated parameters differ between ranks")
    histories = [r["fit"]["history"] for r in ranks]
    check(all(h == histories[0] for h in histories),
          f"the sp x tp fit's history differs between ranks: {histories}")
    card = smi("name,power.limit")
    for r in ranks:
        print(f"tensor_parallel rank {r['rank']} (four processes sharing one card, {card}; "
              f"gloo all-reduces through the host): step ms "
              + json.dumps({k: v for k, v in r["ms"].items() if k.endswith("_steps")})
              + "; tensor-parallel bytes a step "
              + json.dumps({k: v for k, v in r["tp_bytes"].items() if k.endswith("_steps")})
              + f"; errors {json.dumps(r['errors'])}", flush=True)
    print(f"tensor_parallel serving over model {TP_RANKS} ({card}): "
          f"{json.dumps(ranks[0]['serving'])}", flush=True)
    report["ranks"] = [{k: r[k] for k in ("rank", "errors", "ms", "tp_bytes", "launches",
                                          "fit")} for r in ranks]
    report["checkpoint"] = ranks[0]["checkpoint"]
    report["serving"] = ranks[0]["serving"]
    report["launches_summed"] = summed
    report["phase_s"] = time.perf_counter() - t_phase
    total = {k: sum(summed[path][k] for path in TP_PATHS) for k in KERNELS}
    print(f"tensor_parallel launches summed over the ranks: {json.dumps(summed)}", flush=True)
    return total, report


def async_rank_checks(rank, config):
    """One rank of the async_multiproc phase (``--async-rank``): the fits
    of ``MP_FITS`` (``config["death"]`` false), or the peer-death run.
    Reports, per fit, what the phase holds across ranks: the weights'
    digest, the history and each worker's epoch metrics, this rank's
    pushes and the float64 sum of their deltas (summed over the ranks by
    gloo), on rank 0 the server's version, its applied tree (``ApplyChain``)
    and what a client without the job's key got; the predictions' digest,
    the evaluation, the autotune choice, the fit's seconds and the flash
    launches."""
    import hashlib
    import signal

    from elephas_tpu_torch import SparkModel, to_simple_rdd
    from elephas_tpu_torch.engine import async_engine
    from elephas_tpu_torch.ops import attention_cuda
    from elephas_tpu_torch.parallel import distributed
    from elephas_tpu_torch.parameter import client as client_mod

    (x, y), (xv, yv) = mnist_cnn_data()
    servers, per_worker, timed = [], {}, [0]
    real_make_server, real_run_worker = async_engine.make_server, async_engine.AsyncTrainer._run_worker
    real_ab = async_engine.autotune_compile_options

    def make_server(*args, **kwargs):
        servers.append(real_make_server(*args, **kwargs))
        return servers[-1]

    def run_worker(self, index, *args, **kwargs):
        per_worker[index] = real_run_worker(self, index, *args, **kwargs)
        return per_worker[index]

    def ab(*args, **kwargs):
        timed[0] += 1
        return real_ab(*args, **kwargs)

    async_engine.make_server = make_server
    async_engine.AsyncTrainer._run_worker = run_worker
    async_engine.autotune_compile_options = ab

    if config.get("death"):
        # Rank 1 dies after its first push; rank 0's teardown barrier must
        # time out, and its server must be stopped.
        if rank == 1:
            for cls in (client_mod.HttpClient, client_mod.SocketClient):
                real = cls.update_parameters

                def push(self, delta, _real=real):
                    _real(self, delta)
                    os.kill(os.getpid(), signal.SIGKILL)

                cls.update_parameters = push
        ends = []
        model = SparkModel(mnist_cnn(), mode="asynchronous", frequency="epoch",
                           parameter_server_mode="http", port=0, mesh=["cuda:0"] * MP_WORKERS)
        t0 = time.monotonic()
        try:
            model.fit(to_simple_rdd(None, x, y), epochs=MP_EPOCHS, batch_size=ASYNC_CNN_BATCH,
                      callbacks=[lambda e, state, metrics: ends.append(time.monotonic())])
            out = {"error": None}
        except Exception as exc:
            out = {"error": type(exc).__name__, "message": str(exc)}
        raised = time.monotonic()
        out.update(fit_s=raised - t0, epochs_done=len(ends),
                   after_last_epoch_s=raised - ends[-1] if ends else None,
                   server_stopped=bool(servers) and servers[-1]._server is None)
        with open(f"{config['out']}.rank{rank}", "w") as f:
            json.dump(out, f)
        os._exit(0)  # the group has a dead member: no teardown

    # A first fit in a fresh process pays for CUDA's and cuDNN's set-up:
    # one small fit before the measured ones.
    SparkModel(mnist_cnn(), mode="asynchronous", frequency="epoch",
               parameter_server_mode="socket", port=0, mesh=["cuda:0"] * MP_WORKERS).fit(
        to_simple_rdd(None, x[:ASYNC_BITWISE_ROWS], y[:ASYNC_BITWISE_ROWS]), epochs=1,
        batch_size=ASYNC_CNN_BATCH)
    sums, pushes = {}, [0]
    summing_pushes(sums, pushes)
    chain = ApplyChain() if rank == 0 else None
    fits = {}
    for name, (mode, transport, stream, autotune) in MP_FITS.items():
        sums.clear()
        pushes[0] = 0
        if chain is not None:
            chain.received.clear()
        servers.clear()
        per_worker.clear()
        timed[0] = 0
        attention_cuda.reset_launches()
        net = mnist_cnn()
        start = net.get_weights()
        names = sorted(start)
        unauthenticated = []

        def probe(epoch, state, metrics):
            """Rank 0's epoch fire, the server live: a client without the
            job's key must be refused."""
            if unauthenticated or not servers:
                return
            client = client_mod.make_client(transport, f"127.0.0.1:{servers[-1].port}")
            client.timeout = 5.0
            try:
                client.get_parameters()
                unauthenticated.append("answered")
            except Exception as exc:
                unauthenticated.append(type(exc).__name__)
            finally:
                if hasattr(client, "close"):
                    client.close()

        model = SparkModel(net, mode=mode, frequency="epoch", parameter_server_mode=transport,
                           port=0, mesh=["cuda:0"] * MP_WORKERS, autotune=autotune)
        t0 = time.perf_counter()
        history = model.fit(to_simple_rdd(None, x, y), epochs=MP_EPOCHS,
                            batch_size=ASYNC_CNN_BATCH, validation_data=(xv, yv),
                            stream_batches=stream, callbacks=[probe])
        fit_s = time.perf_counter() - t0
        launches = dict(attention_cuda.launches)
        final = net.get_weights()
        # Every rank's pushed deltas, summed over the ranks.
        total = torch.as_tensor(np.concatenate(
            [np.ravel(sums.get(n, np.zeros(start[n].shape))) for n in names]))
        torch.distributed.all_reduce(total)
        offsets = np.cumsum([0] + [start[n].numel() for n in names])
        pushed = {n: total[offsets[i]:offsets[i + 1]].numpy().reshape(start[n].shape)
                  for i, n in enumerate(names)}
        all_pushes = [int(b) for b in distributed.allgather_bytes(str(pushes[0]).encode())]
        record = {"digest": state_digest(net.module), "history": history,
                  "per_worker": {str(i): [{k: float(v) for k, v in e.items()} for e in m]
                                 for i, m in per_worker.items()},
                  "pushes": all_pushes, "fit_s": fit_s, "timed": timed[0],
                  "autotune": model.last_autotune, "launches": launches,
                  "workers": [g for g, _ in model.async_trainer.workers],
                  "n_global_workers": model.async_trainer.n_global_workers}
        if rank == 0:
            buffer = servers[-1].buffer
            survivors, count = chain.final(buffer)
            record.update(
                version=buffer.version, applied=buffer._head[1], survivors=count,
                unauthenticated=unauthenticated,
                pushed_error=sum_error_by_norm(final, start, pushed),
                survivor_error=sum_error_by_norm(final, start, survivors),
                received_error=sum_error_by_norm(
                    {n: torch.as_tensor(start[n].double().numpy() - chain.received[n])
                     for n in chain.received}, start, pushed))
        predictions = np.ascontiguousarray(model.predict(xv[:MP_PREDICT_ROWS]))
        record.update(predict_digest=hashlib.sha256(predictions.tobytes()).hexdigest(),
                      predict_shape=list(predictions.shape),
                      predict_finite=bool(np.isfinite(predictions).all()),
                      evaluate=model.evaluate(xv, yv))
        fits[name] = record
    return {"rank": rank, "fits": fits}


def async_multiproc_phase(attention_cuda, inprocess):
    """SparkModel asynchronous and hogwild across MP_RANKS processes on
    cuda:0 (``async_rank_checks``): every rank ends with the same weights,
    history, validation, predictions and evaluation; the server's version
    is every rank's pushes; the server ends at the start minus the float64
    sum of the deltas its tree holds (every push under the lock, the
    survivors under hogwild); the history is the worker-count-weighted mean
    of the per-worker means; a client without the job's key is refused;
    rank 0 alone times the autotune candidates and both ranks adopt its
    choice; no flash kernel launches. Then rank 1 is killed mid-fit and
    rank 0's teardown barrier must time out within
    ``MP_BARRIER_TIMEOUT_S`` with its server stopped. ``inprocess``: the
    async phase's in-process 4-worker fit, for the samples/s beside it.
    Returns the launches and the report."""
    t_phase = time.perf_counter()
    env = {"ELEPHAS_PS_BIND": "127.0.0.1"}
    ranks, seconds = run_ranks("--async-rank", MP_RANKS, MP_TIMEOUT_S, "async_multiproc",
                               env=env)
    report = {"ranks_s": seconds}
    rows = MP_RANKS * MP_WORKERS * (ASYNC_CNN_ROWS[0] // (MP_RANKS * MP_WORKERS)
                                    // ASYNC_CNN_BATCH) * ASYNC_CNN_BATCH
    launches = {k: 0 for k in KERNELS}
    for name, (mode, transport, stream, autotune) in MP_FITS.items():
        r0, r1 = (r["fits"][name] for r in ranks)
        what = f"async_multiproc {name}"
        for r in (r0, r1):
            for k in KERNELS:
                launches[k] += r["launches"][k]
        check(r0["digest"] == r1["digest"], f"{what}: the ranks' weights differ")
        check(r0["history"] == r1["history"], f"{what}: the ranks' histories differ")
        check(all(len(r0["history"][f"val_{k}"]) == MP_EPOCHS for k in ("loss", "acc")),
              f"{what}: val entries {r0['history']}")
        check((r0["predict_digest"], r0["evaluate"]) == (r1["predict_digest"], r1["evaluate"])
              and r0["predict_finite"]
              and r0["predict_shape"] == [min(MP_PREDICT_ROWS, ASYNC_CNN_ROWS[1]), 10],
              f"{what}: predict/evaluate differ between ranks or are not finite")
        check(r0["workers"] == [0, 1] and r1["workers"] == [2, 3]
              and r0["n_global_workers"] == MP_RANKS * MP_WORKERS,
              f"{what}: workers {r0['workers']}, {r1['workers']}")
        check(r0["pushes"] == r1["pushes"] == [MP_WORKERS * MP_EPOCHS] * MP_RANKS
              and r0["version"] == sum(r0["pushes"]),
              f"{what}: server version {r0['version']}, pushes {r0['pushes']}")
        check(r0["received_error"] <= 1e-12, f"{what}: the server received "
              f"{r0['received_error']:.3e} (by norm) other than what the ranks pushed")
        check(r0["survivors"] == r0["applied"] and r0["survivor_error"] <= ASYNC_SUM_LIMIT,
              f"{what}: the server's weights are {r0['survivor_error']:.3e} from the start "
              f"minus the {r0['survivors']} deltas its tree holds (applied {r0['applied']})")
        if mode == "asynchronous":
            check(r0["applied"] == r0["version"] and r0["pushed_error"] <= ASYNC_SUM_LIMIT,
                  f"{what}: every locked push must apply; start minus all pushes off by "
                  f"{r0['pushed_error']:.3e}")
        # The JAX package's job-wide history: each rank's per-epoch means
        # over its workers, weighted by its worker count.
        keys = sorted(next(iter(r0["per_worker"].values()))[0])
        counts = np.array([len(r["per_worker"]) for r in (r0, r1)], dtype=np.float64)
        means = np.array([[[np.mean([m[e][k] for m in r["per_worker"].values()])
                            for k in keys] for e in range(MP_EPOCHS)] for r in (r0, r1)])
        want = (means * counts[:, None, None]).sum(axis=0) / counts.sum()
        for i, k in enumerate(keys):
            got = (r0["history"]["worker_retries"] if k == "_retries"
                   else r0["history"][k])
            ref = ([int(round(v * counts.sum())) for v in want[:, i]] if k == "_retries"
                   else want[:, i])
            check(np.allclose(got, ref, rtol=1e-12, atol=0),
                  f"{what}: history {k} {got} is not the weighted mean {list(ref)}")
        check(r0["unauthenticated"] and r0["unauthenticated"][0] != "answered",
              f"{what}: a client without the job's key got {r0['unauthenticated']}")
        if autotune:
            check(r0["autotune"] == r1["autotune"] and r0["autotune"] is not None
                  and r0["timed"] == 1 and r1["timed"] == 0,
                  f"{what}: autotune {r0['autotune']} vs {r1['autotune']}, timed "
                  f"{r0['timed']}/{r1['timed']}")
        report[name] = {
            "fit_s": [r0["fit_s"], r1["fit_s"]], "history": r0["history"],
            "evaluate": r0["evaluate"], "version": r0["version"], "applied": r0["applied"],
            "survivor_error": r0["survivor_error"], "pushed_error": r0["pushed_error"],
            "autotune": r0["autotune"], "unauthenticated": r0["unauthenticated"],
            "samples_per_s": MP_EPOCHS * rows / max(r0["fit_s"], r1["fit_s"])}
        print(f"async_multiproc {name} ({MP_RANKS} ranks x {MP_WORKERS} workers on cuda:0, "
              f"{mode} over {transport}, epoch frequency, {MP_EPOCHS} epochs"
              f"{f', stream_batches {stream}' if stream else ''}): "
              f"{json.dumps(report[name])}", flush=True)
    check(launches == {k: 0 for k in KERNELS},
          f"the async_multiproc path launched flash kernels: {launches}")
    inproc_rows = ASYNC_WORKERS * (ASYNC_CNN_ROWS[0] // ASYNC_WORKERS
                                   // ASYNC_CNN_BATCH) * ASYNC_CNN_BATCH
    report["inprocess_4_workers_samples_per_s"] = (
        ASYNC_CNN_EPOCHS * inproc_rows / inprocess["fit_s"])
    print(f"async_multiproc samples/s (whole fits with per-epoch validation): "
          f"{MP_RANKS} ranks x {MP_WORKERS} workers, asynchronous over socket "
          f"{report['async_socket']['samples_per_s']:.1f}; one process, "
          f"{ASYNC_WORKERS} worker threads, local server "
          f"{report['inprocess_4_workers_samples_per_s']:.1f}", flush=True)

    ranks, seconds = run_ranks("--async-rank", MP_RANKS, MP_TIMEOUT_S, "async_multiproc death",
                               extra={"death": True},
                               env={**env, "ELEPHAS_BARRIER_TIMEOUT": str(MP_BARRIER_TIMEOUT_S)},
                               expect=[0, -9])
    death = ranks[0]
    report["death"] = {**death, "ranks_s": seconds}
    print(f"async_multiproc peer death (rank 1 killed after its first push; "
          f"ELEPHAS_BARRIER_TIMEOUT {MP_BARRIER_TIMEOUT_S} s): {json.dumps(report['death'])}",
          flush=True)
    check(death["error"] == "TimeoutError" and "elephas:pushes_done" in death["message"],
          f"rank 0 raised {death['error']}: {death.get('message')}")
    check(death["epochs_done"] == MP_EPOCHS and death["after_last_epoch_s"] is not None
          and death["after_last_epoch_s"] <= MP_BARRIER_TIMEOUT_S + 5,
          f"rank 0 raised {death['after_last_epoch_s']} s after its last epoch "
          f"(barrier timeout {MP_BARRIER_TIMEOUT_S} s)")
    check(death["server_stopped"], "rank 0's parameter server was not stopped")
    report["phase_s"] = time.perf_counter() - t_phase
    return launches, report


def scrape(url):
    """GET ``url``; (status, the document's sorted top-level keys), or the
    error's name."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return resp.status, sorted(json.loads(resp.read()))
    except urllib.error.HTTPError as err:
        return err.code, None
    except Exception as exc:  # noqa: BLE001 - reported, then held
        return type(exc).__name__, None


class Poller:
    """Scrapes ``routes`` (route -> expected top-level keys) of the
    endpoint ``url_fn()`` names (None: not mounted) every ``OPS_POLL_S``
    on a thread of its own; counts rounds and keeps every answer that was
    not 200 with the expected keys. A round that the endpoint's unmount
    cut short (``url_fn()`` no longer names it) is dropped."""

    def __init__(self, url_fn, routes):
        self.url_fn, self.routes = url_fn, routes
        self.rounds, self.bad = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def poll_once(self):
        url = self.url_fn()
        if url is None:
            return
        bad = []
        for route, keys in self.routes.items():
            got = scrape(f"{url}{route}")
            if got != (200, sorted(keys)):
                bad.append([route, *got])
        if bad and self.url_fn() != url:
            return  # unmounted mid-round
        self.bad.extend(bad)
        self.rounds += 1

    def _run(self):
        while not self._stop.wait(OPS_POLL_S):
            self.poll_once()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def ops_phase(attention_cuda):
    """The ops endpoints on the card. (a) The PS of a single-process
    async CNN fit over HTTP (``ps_ops_port=0``, a WAL directory so
    ``store_dir="auto"`` journals beside it), scraped at 10 Hz while it
    trains, every answer 200 with the JAX package's keys; the fit's
    samples/s with and without the poller; then the server warm-restarted
    on the WAL, killed, restarted again, and the incident rebuilt from
    the journal alone holding the kill and the restarts. (b)
    ``SyncTrainer.mount_ops`` beside the full-width LM f32 train step:
    ``/profile?action=start``, OPS_PROFILE_STEPS steps, ``?action=stop``;
    the exported trace names K1-K3's float32 kernels, a second start
    answers busy, a bare ``/profile`` reports the card's memory as
    ``torch.cuda.memory_stats`` does. (c) ``InferenceEngine.mount_ops``
    while it serves ``serving_traffic()``: /load, /slo, /tenants and
    /alerts scraped throughout, /metrics with the serving counters,
    ``unmount_ops`` twice. Returns the launches (K1-K3 of (b)) and the
    report."""
    import tempfile
    import urllib.request

    from elephas_tpu_torch import obs
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine.async_engine import AsyncTrainer, store_of
    from elephas_tpu_torch.engine.step import init_train_state
    from elephas_tpu_torch.engine.sync import SyncTrainer
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parameter.server import make_server
    from elephas_tpu_torch.serving import InferenceEngine

    t_phase = time.perf_counter()
    report = {}
    attention_cuda.reset_launches()
    (x, y), _ = mnist_cnn_data()
    rows = ASYNC_WIRE_WORKERS * (len(x) // ASYNC_WIRE_WORKERS // ASYNC_CNN_BATCH) * ASYNC_CNN_BATCH

    # (a) The parameter server's endpoint under a poller, fits without and
    # with it in turn; each fit's WAL directory of its own (a server warm-
    # restarts from the WAL it is given).
    with tempfile.TemporaryDirectory() as tmp:
        for i, polled in enumerate((None, False, True, False, True)):  # None: warm-up
            wal = os.path.join(tmp, f"fit{i}")
            trainer = AsyncTrainer(mnist_cnn(), ["cuda:0"] * ASYNC_WIRE_WORKERS,
                                   frequency="batch", parameter_server_mode="http", port=0,
                                   ps_ops_port=0, ps_wal_dir=wal)

            def url():
                server = trainer.server
                ops = getattr(server, "ops", None) if server is not None else None
                return ops.url if ops is not None else None

            poller = Poller(url if polled else (lambda: None), OPS_PS_KEYS)
            with poller:
                t0 = time.perf_counter()
                trainer.fit(ShardedDataset(x, y, ASYNC_WIRE_WORKERS), epochs=1,
                            batch_size=ASYNC_CNN_BATCH)
                fit_s = time.perf_counter() - t0
            if polled is None:
                continue
            key = "polled" if polled else "unpolled"
            report.setdefault(f"ps_{key}_samples_per_s", []).append(rows / fit_s)
            if polled:
                report.setdefault("ps_poll_rounds", []).append(poller.rounds)
                check(poller.rounds >= 5 and not poller.bad,
                      f"the PS endpoint under the poller: {poller.rounds} rounds, "
                      f"answers off the JAX keys {poller.bad[:5]}")
        tree = store_of(trainer.compiled.module)
        tree = {"params": tree[0], "batch_stats": tree[1]}
        restarted = make_server("http", tree, port=0, wal_dir=wal, ops_port=0)
        restarted.start()
        version = restarted.buffer.version
        restarted.kill()
        check(restarted.ops is None, "the killed server's endpoint is still mounted")
        again = make_server("http", tree, port=0, wal_dir=wal, ops_port=0)
        again.start()
        check(again.buffer.version == version, f"the warm restart resumed at version "
              f"{again.buffer.version}, the killed server held {version}")
        again.stop()
        builder = obs.IncidentBuilder()
        builder.add_store(os.path.join(wal, "telemetry"), name="ps")
        incident = builder.build()
        names = [e["name"] for e in incident["timeline"]]
        report["incident"] = {"boots": len(incident["boots_by_proc"]["ps"]),
                              "trigger": (incident["triggering_event"] or {}).get("kind"),
                              "events": len(names), "digest": incident["digest"]}
        check(report["incident"]["boots"] == 3 and report["incident"]["trigger"] == "ps_kill"
              and "ps_kill" in names and names.count("boot (warm restart)") >= 2,
              f"the incident rebuilt from the journal: {report['incident']}, "
              f"timeline {names[-12:]}")
    print(f"ops ps (AsyncTrainer over HTTP, {ASYNC_WIRE_WORKERS} workers on cuda:0, batch "
          f"frequency, 1 epoch, ps_ops_port=0, {len(OPS_PS_KEYS)} routes polled every "
          f"{OPS_POLL_S} s): {json.dumps(report)}", flush=True)

    # (b) The trainer's endpoint: remote capture of the LM f32 train step.
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 32000, (BATCH, SEQ + 1)), device="cuda")
    lm = CompiledModel(get_model("transformer_lm", attention="flash", dtype="float32"),
                       optimizer={"name": "adam", "learning_rate": 1e-3},
                       loss="sparse_categorical_crossentropy", metrics=["acc"], seed=SEED)
    trainer = SyncTrainer(lm, build_mesh())
    state = init_train_state(lm)
    ops = trainer.mount_ops()
    with tempfile.TemporaryDirectory() as capture:
        state, _ = trainer._train_step(state, tokens[:, :-1], tokens[:, 1:])  # warm
        torch.cuda.synchronize()
        attention_cuda.reset_launches()
        started = scrape(f"{ops.url}/profile?action=start&dir={capture}")
        busy = scrape(f"{ops.url}/profile?action=start")
        for _ in range(OPS_PROFILE_STEPS):
            state, metrics = trainer._train_step(state, tokens[:, :-1], tokens[:, 1:])
        torch.cuda.synchronize()
        stopped = scrape(f"{ops.url}/profile?action=stop")
        launches = dict(attention_cuda.launches)
        traces = sorted(Path(capture).glob("trace-*.json"))
        check(started[0] == 200 and busy[0] == 409 and stopped[0] == 200 and len(traces) == 1,
              f"/profile start {started}, second start {busy}, stop {stopped}, "
              f"traces {traces}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        found = {k: sum(name in n for n in kernels) for k, name in OPS_TRACE_KERNELS.items()}
        report["profile"] = {"trace_bytes": traces[0].stat().st_size,
                             "kernel_events": len(kernels), "flash_events": found,
                             "launches": launches, "loss": float(metrics["loss"])}
    with urllib.request.urlopen(f"{ops.url}/profile", timeout=10.0) as resp:
        before = torch.cuda.memory_stats(0)["allocated_bytes.all.current"]
        doc = json.loads(resp.read())
    after = torch.cuda.memory_stats(0)["allocated_bytes.all.current"]
    trainer.unmount_ops()
    report["profile"]["device_memory"] = doc["device_memory"]
    report["profile"]["memory_stats"] = after
    print(f"ops trainer (SyncTrainer.mount_ops, the full-width LM f32 train step, "
          f"{OPS_PROFILE_STEPS} steps captured over /profile): {json.dumps(report['profile'])}",
          flush=True)
    check(launches == {k: 4 * OPS_PROFILE_STEPS for k in KERNELS},
          f"the captured steps launched {launches}, expected {4 * OPS_PROFILE_STEPS} of each")
    # The capture can miss the first launches after its start (2 of K1's
    # 12 in one run): every launch of the steps after the first must be
    # in the trace, and none that was not made.
    check(all(4 * (OPS_PROFILE_STEPS - 1) <= found[k] <= launches[k] for k in KERNELS),
          f"the trace names the kernels {found} times; launched {launches}")
    check(before == after == doc["device_memory"].get("cuda_0"),
          f"/profile memory {doc['device_memory']}, torch.cuda.memory_stats {before}/{after}")
    del trainer, state, lm, tokens

    # (c) The serving engine's endpoint while it serves.
    model = CompiledModel(get_model("transformer_lm"), loss="sparse_categorical_crossentropy",
                          metrics=[], seed=SEED).module
    engine = InferenceEngine(model, **SERVE_ENGINE)
    ops = engine.mount_ops()
    with Poller(lambda: ops.url, OPS_SERVING_KEYS) as poller:
        _, elapsed = serve(engine, serving_traffic())
        time.sleep(3 * OPS_POLL_S)
    with urllib.request.urlopen(f"{ops.url}/metrics", timeout=10.0) as resp:
        text = resp.read().decode()
    engine.unmount_ops()
    engine.unmount_ops()
    report["serving"] = {"s": elapsed, "poll_rounds": poller.rounds, "bad": poller.bad[:5],
                         "metrics_lines": len(text.splitlines())}
    print(f"ops serving (InferenceEngine.mount_ops, {SERVE_REQUESTS} requests): "
          f"{json.dumps(report['serving'])}", flush=True)
    check(poller.rounds >= 3 and not poller.bad,
          f"the serving endpoint under the poller: {report['serving']}")
    check(all(f"{name}" in text for name in ("serving_itl_seconds", "elephas_process_info",
                                             "serving_prefix_cache_hit_total")),
          "the serving counters are missing from /metrics")
    check(engine.ops is None, "unmount_ops left the endpoint mounted")
    report["phase_s"] = time.perf_counter() - t_phase
    return launches, report


def kernel_entries(timing, errors, launches):
    """The ``{"kernels": [...]}`` line's entries: each kernel's source,
    the TPU kernel it replaces, its launches on the main path (the LM
    train run) and on every path, its errors and its f32 (and bf16)
    times and bounds."""
    sources = {
        "flash_fwd": ("elephas_tpu_torch/csrc/flash_fwd.cu",
                      "elephas_tpu/ops/attention_pallas.py:36"),
        "flash_dq": ("elephas_tpu_torch/csrc/flash_bwd.cu",
                     "elephas_tpu/ops/attention_pallas.py:248"),
        "flash_dkv": ("elephas_tpu_torch/csrc/flash_bwd.cu",
                      "elephas_tpu/ops/attention_pallas.py:307"),
    }
    entries = []
    for name in KERNELS:
        f32, bf16 = timing[name][torch.float32], timing[name][torch.bfloat16]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches["train"][name],
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
            "max_abs_err": errors[name][torch.float32],
            "max_err_f32": errors[name][torch.float32],
            "max_err_bf16": errors[name][torch.bfloat16],
            **f32,
            "bf16": bf16,
        })
    return entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi("name,power.limit"))
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    libs = attention_cuda.build_all()
    print(f"build: {', '.join(lib.name for lib in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cuobjdump = str(Path(attention_cuda._nvcc()).with_name("cuobjdump"))
    instances = {"flash_fwd": [f"flash_fwd {t} D={d}" for t in ("bf16", "f32")
                               for d in attention_cuda.HEAD_DIMS],
                 "flash_bwd": [f"flash_{k} {t} D={d}" for k in ("dq", "dkv")
                               for t in ("bf16", "f32") for d in attention_cuda.HEAD_DIMS]}
    for source, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        summary = ptxas_summary(log)
        print("ptxas: " + summary, flush=True)
        check(all(f"{name}:" in summary for name in instances[source]),
              f"ptxas summary of {lib.name} misses a kernel of {instances[source]}")
        for line in log.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"nvcc: {line.strip()}", flush=True)
        counts = sass_counts(lib, cuobjdump)
        print(f"sass {lib.name}: {json.dumps(counts)}", flush=True)
        for name in instances[source]:
            need, ops = required_ops(name), counts.get(name, {})
            print(f"sass {name}: requires {' and '.join(need) or 'nothing'}, has {ops}",
                  flush=True)
            check(all(ops.get(op, 0) > 0 for op in need),
                  f"{name} has {ops} in its SASS: it needs {need}")

    errors, timing = kernel_phase(attention_cuda)
    launches = {}
    launches["inference"], report = inference_phase(attention_cuda)
    print(f"inference: {json.dumps(report)}", flush=True)
    launches["train"], report = train_phase(attention_cuda)
    print(f"train: {json.dumps(report)}", flush=True)
    launches["seq_parallel"], report = seq_parallel_phase(attention_cuda)
    print(f"seq_parallel: {json.dumps(report)}", flush=True)
    launches["tensor_parallel"], report = tensor_parallel_phase(attention_cuda)
    print(f"tensor_parallel: {json.dumps(report)}", flush=True)
    launches["resnet"], report = resnet_phase(attention_cuda)
    print(f"resnet: {json.dumps(report)}", flush=True)
    launches["repair"], report = repair_phase(attention_cuda)
    print(f"repair: {json.dumps(report)}", flush=True)
    launches["serving"], report = serving_phase(attention_cuda)
    print(f"serving: {json.dumps(report)}", flush=True)
    launches["async"], report = async_phase(attention_cuda)
    print(f"async: {json.dumps(report)}", flush=True)
    launches["async_multiproc"], report = async_multiproc_phase(attention_cuda,
                                                                report["cnn_async"])
    print(f"async_multiproc: {json.dumps(report)}", flush=True)
    launches["ops"], report = ops_phase(attention_cuda)
    print(f"ops: {json.dumps(report)}", flush=True)
    launches["estimator"], report = estimator_phase(attention_cuda)
    print(f"estimator: {json.dumps(report)}", flush=True)
    launches["search"], report = search_phase(attention_cuda)
    print(f"search: {json.dumps(report)}", flush=True)
    launches["fit_slice"], report = fit_slice_phase(attention_cuda)
    print(f"fit_slice: {json.dumps(report)}", flush=True)
    launches["chaos"], report = chaos_phase(attention_cuda)
    print(f"chaos: {json.dumps(report)}", flush=True)

    print(json.dumps({"kernels": kernel_entries(timing, errors, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seq-rank"]:
        sys.exit(rank_main(seq_rank_checks, sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(rank_main(tp_rank_checks, sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--async-rank"]:
        sys.exit(rank_main(async_rank_checks, sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
