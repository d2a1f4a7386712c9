#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda); imports
nothing of JAX. Phases, each of which makes the script exit non-zero when
it fails:

1. start-up: the card's name and power limit (nvidia-smi), then nvcc builds
   every kernel of both paths from ray_tpu_torch/csrc into
   ray_tpu_torch/_build (one nvcc per source, all at once); ptxas's
   registers and spills of the bf16 flash kernels K3-K5 (tensor cores) at
   D 16, 32, 64 and 128, where any spill, a missing instantiation or a
   bf16 instantiation of the f32 FMA kernels fails the run;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (and GQA, ragged,
   tile-edge, split-edge, long-cache and small-page shapes), in f32 and
   bf16; the bf16 flash gradients against a bound derived from the
   numerics; the split decode kernels K6 and K7 twice on the same inputs
   (the same bits), and K7 against K6 on the same rows (the same bits);
   K1's residual form against PyTorch's add and the plain K1 launch (the
   same bits), and K1's backward against the plain backward and against
   itself on a second launch (the same bits);
3. the serving path at the flagship config's full width (vocab 32000,
   d_model 1024, 8 layers, 16 heads, bf16, 8 slots, max_seq 2048, random
   weights from a seed): one batched LMBackend call of 12 greedy requests,
   one seeded sampled request twice, one streamed request; every launch
   counter is set to 0 just before and read just after, and must show the
   path went through each kernel as often as its structure says (K1 once
   plain and 2L times in its residual form per prefill and per tick);
3b. the paged serving path, LMBackend(paged=True) at the same config (page
   size 128), counters set to 0 before and read after: 16 greedy requests
   sharing a 512-token prefix, on the default pool and on a tight one that
   queues admission, one 1,536-token prompt through chunked prefill, one
   seeded sampled request twice and one streamed request; greedy outputs
   must equal the contiguous engine's, and every decode tick must launch
   exactly 8 paged-decode, 0 decode and 17 RMSNorm kernels (1 plain, 16 in
   the residual form);
3c. speculative serving, LMBackend(speculative_k=4, speculative_ngram=2)
   over each engine at the same config, counters set to 0 before and read
   after: (a) 8 quoting requests (a 96-token passage and its first 32
   tokens again, 64 new tokens), (b) phase 3's 12 greedy requests, (c) a
   seeded sampled request beside 3 greedy ones, the batch twice (equal),
   (d) a stream equal to the same request's whole response, (e) a request
   that ends at exactly max_seq; the paged one also the 16 shared-prefix
   requests, whose prefix pages must keep their bits through every verify
   pass. Every verify pass must launch 17 RMSNorm kernels and no decode
   kernel, every paged tick with no drafts 17 RMSNorm and 8 paged-decode
   kernels. Greedy outputs against the same engines with speculation off:
   each request that differs must differ first where the plain path's
   top-2 logits lie within FLIP_ULPS bf16 ulps;
4. the same weights in f32 on the card and on the CPU, teacher-forced
   through 3 prompts for 16 decode steps and one 5-wide verify chunk,
   through the contiguous and the paged engine: logits within atol 1e-3;
   and in f32 on the card, each engine's greedy tokens with speculation on
   equal to its tokens with it off on phase 3c's traffic (a) and (b);
5. the training path at the same config (bf16 compute, f32 params, AdamW):
   5 train steps at batch 8, seq 2048 on one seeded batch; the counters are
   set to 0 just before and read after every step, which must show 1 plain
   and 2L residual RMSNorm forwards, 2L+1 RMSNorm backwards, 1
   cross-entropy, and L each of the flash forward, dq and dk/dv launches;
   the loss starts within 1.0 of ln(32000) and falls;
6. one f32 train step at full width and depth (batch 1, seq 256) on the
   card and on the CPU from the same weights: the loss, every gradient,
   and the loss after a second step, within stated tolerances;
7. timings (CUDA events) of each kernel, its plain version and the
   PyTorch library call that computes the same function, beside the
   kernel's least possible time on the card (the paged kernel also beside
   the contiguous one and SDPA on the same rows, at a median tick's short
   lengths, ~600 and ~2000 rows, with the number of splits; the flash
   kernels also in f32, at
   a GQA shape, and as TFLOP/s beside SDPA's forward and backward); the
   paged decode tick against the contiguous one; K1's residual form at
   the decode and train rows against x + a then F.rms_norm, K1's backward
   against the plain one and autograd through F.rms_norm, and the host µs
   per K1 call at the decode shape; the train step's device time against
   its wall, and its kernels by name (torch.profiler), K1 and K3-K5 each;
   on phase 3c's traffic (a), speculation on against off for each engine:
   decode tokens/s, tokens per tick, the acceptance rate, and one full
   verify tick's device time and wall beside the plain tick's at the same
   lengths;
8. the placement passes (ray_tpu_torch.scheduler, torch ops: no kernel of
   their own) at bench.py's scheduler workloads on 256 nodes: (a) the
   100k-task random DAG, whose rounds (57) and placement sha256 at
   prng_key(0) must be the JAX package's (SCHED_A_*), (b) the 10k fan-out,
   (c) the 50k chain through schedule_dag_collapsed, (d) the 64k-map,
   256-reduce DAG with locality hints, each placement and round count
   equal to the port's scalar reference (reference.py) on the host; (e) 50
   BatchScheduler ticks of 1,024 tasks, each equal to the reference; S1's
   draws at 8,192 tasks against numpy, and the gang, pending-reason and
   locality passes once each at control-plane sizes against the
   reference. Each prints tasks/s (the least wall of 5 runs after a
   warm-up), rounds, wall a round, host syncs and device launches a round
   (torch's sync debug mode, torch.profiler), device time (rounds replayed
   behind a sleep and timed by CUDA events, and the profiler's kernel sum)
   and the card's busy share; (a) also its ten costliest kernels, (e) the
   tick's p50 and p99;
9. the local runtime (ray_tpu_torch.init, tasks, actors, the object store
   with spill, placement groups): (a) init() counts the card as the GPU
   resource; (b) a num_gpus=1 actor builds the flagship LMBackend from
   put() parameters (the driver's tensors by data_ptr, device memory no
   more than the same backend built directly) and serves phase 3's 12
   requests in one call: phase 3's tokens, and per tick 17 K1 and 8 K6
   launches (counters set to 0 before the call and read after: the
   backend's pump thread is the only thread launching); a seeded sample
   equal twice; (c) a num_gpus=1 task waits (wait() not ready, a capacity
   pending reason) while the actor holds the card, and kill() admits it:
   one K1 launch on a put() tensor, within phase 2's tolerance; (d) an
   actor in a {GPU: 1, CPU: 1} placement-group bundle runs K1, and the GPU
   is free again after the group's removal; (e) eight 256 MiB CUDA tensors
   through a 1 GiB store spill and come back on the card with their bits,
   with the spill and restore rates; (f) the runtime's own costs: task and
   actor-call round trips over 1,000 calls, a 10k no-op fan-out, put and
   get of a 256 MiB CUDA tensor, and the 12-request batch's wall through
   the actor and directly, in turns; (g) timeline() holds an event for
   every task and actor call, and shutdown() leaves no runtime thread;
10. the serve control plane (ray_tpu_torch.serve: master, router, replica
   actors, HTTP ingress) with the flagship LMBackend behind
   serve.create_backend, its engine under a probe (the Probe class
   below): (a) one contiguous replica answers phase 3's 12 requests with
   phase 3's tokens, the router batching them, with 17 K1 and 8 K6
   launches a tick (counters set to 0 before and read after: the
   replica's pump thread is the only thread launching), the replica's
   parameters at the driver's data_ptr; (b) a stream through the handle
   and one over HTTP NDJSON equal the whole response, a seeded sample
   equal twice; (c) a 0.5/0.5 traffic split with a paged replica answers
   phase 3b's 16 shared-prefix requests with the contiguous engine's
   tokens, both K6 and K7 launching, and delete_backend frees the paged
   pool; (d) with two replicas, one is killed with a batch in it and 16
   more requests follow: every answer right, the master replaces it, and
   the card holds no more than two replicas did; (e) a scale-down to one
   drains a stream pinned to the retired replica, which frees its cache;
   (f) serve's no-op round trips through the handle and over HTTP, the
   12-request batch through serve against LMBackend directly, in turns,
   stat()'s latency and the Prometheus series; (g) serve.shutdown() and
   shutdown() leave no serve or runtime thread, and the card's memory
   within half a replica of its value before the phase;
11. the cluster runtime (ray_tpu_torch.cluster: a GCS head with a
   colocated node controller, three node processes, worker processes) with
   the GCS's placement passes on the card: (a) init(address=...) against a
   head of {CPU: 8, GPU: 1} and three nodes of {CPU: 2}, the pass knobs
   RAY_TPU_TORCH_{PG,REASON,LOCALITY}_KERNEL=1: every node's arena native
   (its /dev/shm segment opens as ShmObjectStore), a transfer server on
   each, the GCS's frame pump native, no segment with a JAX prefix; (b)
   1,000 no-op task and actor-call round trips, a 10k fan-out; (c) 2 waves
   of 5,000 no-op tasks, each gated on one task so that it reaches the GCS
   as one matrix tick (the second wave waits for the GCS's warm-up of the
   bucket, and is the first the GCS routes to the card): kernel:place and
   kernel:warmup counted, the place device cuda, the GCS's per-bucket EMAs
   printed; a STRICT_SPREAD group of 4 bundles
   (gang pass), an infeasible task's reason (reason pass), 8 mappers in a
   bundle off the head and their reducers placed at the data (locality
   pass); no kernel_fallback:* counted; (d) the flagship parameters put
   through the arena and a num_gpus=1 actor in a worker process building
   LMBackend from them: phase 3's tokens, 17 K1 and 8 K6 launches a tick
   counted in the actor's process, the batch's wall beside the direct
   one's in turns; a num_gpus=1 task waits while the actor lives (in the
   head controller's queue for the GPU, on none of its workers) and runs
   after kill(), when the card's free memory (device-wide) rises by at
   least the actor's KV cache; (e) a 256 MiB CUDA tensor doubled by a task
   on another node, its bits checked, with the copy and transfer rates;
   (f) no node declared dead while the phase ran (the GCS's event log holds
   no node_down), with the GCS loop's slowest callbacks printed; after
   shutdown() and the cluster's, none of the phase's processes, /dev/shm
   segments or spill directories is left;
12. the operator's path, through the entry points an operator and a C host
   use: (a) ``python -m ray_tpu_torch.scripts.cli start --head`` with no
   --device (its GCS places on the card) and ``start --address`` for one
   node of {CPU: 2}, the session file in a temporary directory; ``cli
   status`` lists 2 alive nodes and GPU 1.0, the GCS's place device is
   cuda, and after 2 gated waves of 5,000 no-op tasks from a driver
   kernel:place is counted and no kernel_fallback:*; (b) the C API built
   from the checkout (libray_tpu_torch_c.so, build_c_api) and the C host
   ray_tpu_torch/_native/src/capi_actor.c: through ray_tpu_init,
   ray_tpu_actor_create and ray_tpu_actor_call_json it creates
   chip_smoke:CapiServer in a worker process of the CLI's cluster, which
   builds the flagship LMBackend on the card from the seed and answers
   phase 3's 12 requests: phase 3's tokens, and per tick 17 K1 and 8 K6
   launches counted in the actor's process; the batch's wall at the actor
   and at the C host; (c) while the actor lives: ``cli memory --refs``
   lists the C host's refs, ``cli tasks`` the actor's creation, ``cli
   profile --component gcs`` writes a folded file of the GCS's stacks, and
   a dashboard connected to the cluster serves both nodes and the GPU
   (/api/nodes), the actor alive (/api/actors) and Prometheus text
   (/metrics); (d) ray_tpu_actor_kill and ray_tpu_shutdown: the card's
   free memory (device-wide) rises by at least the actor's KV cache; (e)
   ``cli stop`` leaves no process of the session, no rtts-/rttr- segment
   and no session file;
13. the train library and the single-device models: (a) the MoE
   transformer's train step (ray_tpu_torch.models.moe_transformer) at the
   flagship's widths and depth with 8 experts of d_ff 4096, top 2,
   capacity 1.25, bf16 with f32 params, batch 8, seq 2048, AdamW at weight
   decay 1e-4, 5 steps on one seeded batch: per step exactly 1 plain, 16
   residual and 17 backward K1, 1 K2 and 8 each of K3-K5; the step-0 loss
   less the aux loss within 1.0 of ln 32000 and the loss falling; its
   median step wall, tokens/s, peak memory, aux loss and the choices each
   layer dropped by capacity at step 0; (b) moe_ffn's index-form dispatch
   against its dense one-hot plain version at E 1024, F 4096, 8 experts,
   1,024 tokens, in f32 and bf16: routing equal, y and every gradient
   within a stated tolerance of its largest magnitude, two forwards the
   same bits; (c) one f32 MoE step at full width, batch 1, seq 256, card vs
   CPU: loss within 1e-4, each gradient within 1e-3 of its largest
   magnitude, routing equal but at printed near-ties (4 f32 ulps); (d)
   ``TPUTrainer`` of 2 worker actors of the local runtime on the card on
   the dense flagship's loss_fn, batch 4 x seq 2048 a rank, 3 steps: the
   ranks start from the driver's parameters, the loss falls, per step
   exactly twice phase 5's launches, the step wall against phase 5's and
   the gradient bytes through the store; then a killed worker and a
   train() that recovers (retries 1); (e) the vision family at
   VisionConfig()'s defaults through ``MeshTrainer``, 30 steps at batch
   256 on the quadrant task drawn with numpy: the loss falls, its step
   wall, and f32 logits card vs CPU;
14. meshes for training: one world of 2 rank processes sharing the card
   (ray_tpu_torch.parallel.launch; gloo, each collective staged through
   pinned host memory), layouts built one after another, each layout's
   memory freed before the next: (a) f32 at the flagship's widths, depth 2,
   batch 2, seq 256, TF32 off: one step of dp2, tp2, sp2 (ring attention)
   and pp2 (2 microbatches), the loss and every gathered gradient within
   1e-5 of its largest magnitude of one process on the card, and Ulysses
   at [2, 256, 16, 64] against one flash_attention, forward and gradients;
   (b) bf16 at the flagship's width and depth, phase 5's weights and batch,
   3 AdamW steps: dp2 through MeshTrainer(mesh, param_shardings,
   batch_spec=P("dp")), tp2, sp2 and pp2 (4 microbatches) through
   make_train_step(cfg, mesh): each rank's launches a step exactly what
   the layout's structure says (mesh_per_step), the losses within 2^-7 of
   phase 5's, step wall, tokens/s, peak memory a rank and the bytes and
   seconds of the host staging a step (sp2's batch is cut, and printed, if
   the ring's saved scores would not fit); (c) the MoE flagship in the
   layout moe_transformer.param_shardings gives (attention and experts
   over tp2): first in f32 at depth 2, batch 2, seq 256, step 0's loss and
   every gathered gradient within 1e-5 of one process's, routing equal,
   and 3 AdamW steps' losses within 1e-5; then in bf16 from phase 13's
   weights and batch, 3 steps: exact launches, each layer's step-0 routing
   equal to one device's routing of the mesh's own layer input, against
   one process layer 0's routing moved by bf16 rounding alone (no token's
   top-K logit margin moved past what 2 ulps an input element can move
   it) and each layer's drops apart by at most its changed choices, and
   the losses within the larger of 2^-7 and one process's bf16-to-f32
   gap a step (the parent runs phase 13's steps in f32 for it); (d) vision at VisionConfig() over dp2,
   f32, cuDNN deterministic: loss and every gradient within 1e-5 of one
   process taking the batch in the same two halves (and the distance to
   its whole-batch gradients printed); (e) Ulysses in
   bf16 at [8, 2048, 16, 64] over sp2: exactly one K3, K4 and K5 a rank,
   out and gradients against one flash_attention;
15. serving under tensor parallelism: one process first reruns phases 3,
   3b and 3c's traffic (the same tokens) and keeps the top-2 gap of every
   greedy token and the logits of every sampled draw; then one world of 2
   rank processes on the card, each with its engine over a ("tp",) mesh
   (8 of the 16 kv heads a rank, phase 3's weights from the seed): (a) the
   contiguous engine on phase 3's 12 greedy, sampled and streamed
   requests, (b) the paged engine on phase 3b's shared-prefix requests
   and chunked prefill, (c) both engines with speculative_k=4 on phase
   3c's quoting requests, each tick's launches read in each rank (17 K1
   and 8 K6, 8 K7 paged, a verify pass K1 only), the caches and pools at
   8 heads, the ranks' logits bit-equal every tick, and every rank's
   tokens equal to one process's but where the first difference lies at
   a near tie (FLIP_ULPS bf16 ulps; a sampled draw within what they can
   move an edge of its interval); (d) an f32 witness at depth 2: every
   token equal to one process's, logits within the f32 reorder bound;
   (e) LMBackend(tp=2) behind serve, contiguous (tokens equal to (a)'s)
   and paged with speculative_k=3 (held to one process's as (b)), a
   handle and a stream, the card's memory back by both ranks' KV stores
   after each backend goes; it prints the tick wall at tp2 against one
   process's, the bytes staged and the shares of gloo and pinned copies a
   tick, the worlds' start-up, and K6 and K7 at 8 heads beside their
   bound;
16. the data plane's legacy paths and head failover: (a) a cluster whose
   GCS places on the card with RAY_TPU_TORCH_DISPATCH_WAVE=0, and three
   2-CPU nodes, each with its own knobs: node 1 pickle-only on the wire
   with the native frame pump off, and the card's {"GPU": 1}; node 2 with
   transfer admission off; node 3 with 256 KiB transfer chunks and one
   pull in flight a source. The driver submits per-task frames and has no
   completion ring. It runs phase 11's 10k fan-out, a gated wave of 5,000
   tasks on the card's matrix path, 8 mappers of 4 MiB on node 1 read by
   reducers on nodes 2 and 3, a 256 MiB CUDA tensor from a task on node
   1 to a task on node 3 (its bits), and the flagship LMBackend in a
   num_gpus=1 actor on the pickle-only node (phase 3's tokens, 17 K1 and
   8 K6 a tick counted in its process); every switch is read back from
   its counters, and the card's memory comes back after kill(); it prints
   the fan-out's tasks/s and the tensor's GB/s beside phase 11's. (b) a
   leader and a warm standby, both placing on the card, a 1.5 s lease:
   5,000 tasks in flight, the leader SIGKILLed; every result arrives once
   with its value, the promoted leader places on the card, the dead
   leader's CUDA context memory comes back; it prints the seconds from
   the kill to the promotion and to the last result;
17. the tune and util libraries (ray_tpu_torch.tune, ray_tpu_torch.util) on
   the card: (a) tune.run of TPUTrainer.as_trainable under
   PopulationBasedTraining, two trials at once with resources_per_trial
   {"CPU": 1, "GPU": 0.5}, each a TPUTrainer of one worker on the dense
   flagship (bf16, f32 params, AdamW) at batch 4 x seq 2048, learning
   rates 1e-5 and 1e-3, perturbation_interval 2, 6 iterations of one step:
   every trial TERMINATED, tune.run's launches (the trials stepping at
   once) exactly phase 5's per step times the steps logged, at least one
   exploit, after which the recipient's parameters, AdamW moments and step
   equal the donor's saved ones bit for bit (a digest mixed on the card,
   equal also to the donor's own step's) and it steps at its explored
   learning rate, the best trial's loss falling, no object spilled, and
   the card's free memory back after tune.run within LIB_MEM_MARGIN and by
   at least one trial's state; it prints an iteration's wall, the
   exploit's blob bytes and the seconds from the save to the restore; (b)
   a util.ActorPool of 2 actors (num_gpus=0.5), each a GenerationEngine
   over the driver's flagship parameters (at their data_ptr): phase 3's 12
   prompts through pool.map in two halves, every token equal to phase 3's
   but where the first difference lies at a near tie (FLIP_ULPS bf16 ulps
   of phase 15's one-process gaps), the two actors serving at once and the
   launches 17 K1 for each prefill and tick and 8 K6 for each tick; kill()
   frees both KV caches and the GPU; then util.multiprocessing.Pool(2).map
   of K1 over 8 row blocks of a CUDA tensor: one launch a block, on the
   block in place, against the plain version; the card's free memory back
   after both pools;
18. streaming and the distributed arrays (ray_tpu_torch.streaming,
   ray_tpu_torch.experimental) on a fresh init(num_gpus=1): (a)
   experimental.array at 4096 x 4096 f32 (8 x 8 blocks of 512): random
   x2, dot, add, subtract, transpose, eye and dot(eye, a), every block a
   CUDA tensor on cuda:0; dot within experimental.array._dot_bound (2
   gamma_K |A| @ |B|, derived from the numerics) of one torch.matmul of the
   assembled operands, the rest exact; the 64 output-block tasks' wall and
   the matmul's device time; (b) a DataStream of 64 CUDA tensors [512,
   1024] bf16 through map(rms_norm, K1, parallelism 2), key_by(index mod
   4), reduce(float64 elementwise sum) and a sink, batches of 4 on the
   native ring: the four sums bit-equal to the same K1 calls and sums run
   eagerly (exact sums, checked, so arrival order cannot move a bit), K1
   counted exactly 64 in the stream and 64 eager, all 12 channels native,
   records/s and GB/s through the rings, and one CUDA batch's pickle and
   unpickle; (c) (b) again with a sink sleeping 5 ms a call, the same sums;
   after each ctx.shutdown() the card's allocated memory back at its level
   before the job; internal_kv and set_resource as the reference's tests
   run them;
19. rllib on the card (ray_tpu_torch.rllib) on a fresh init(num_gpus=1):
   (a) PPO, A2C, DQN and A3C's learners at PPO_CONFIG's network on one
   CartPole batch, their parameters CUDA tensors: the loss and gradients
   normwise within 1e-4 of the CPU's, one Adam step from the same
   gradients within 1e-6; PPO's whole update replayed as a CUDA graph
   equal bit for bit to its eager steps on the card; (b) PPOTrainer on
   CartPole at PPO_CONFIG, 2 rollout workers of 8 envs, seed 0, to
   episode_reward_mean 150 within 30 iterations, printing each
   iteration's wall, sampling against learning, learn_on_batch's span by
   CUDA events and the card's busy share (the profiler's raw trace); (c)
   PG, A2C, A3C with 2 remote workers, DQN, APEX, IMPALA, IMPALA's tree
   aggregation, APPO, DD-PPO, ES and ARS at their reference tests'
   configs and rewards, and the multi-agent shared policy, each one's
   wall, and ES's one-observation env step on the card and the CPU; (d)
   after every cleanup(), rt.shutdown() and the end of every thread the
   phase started, this process's allocated memory within 1 MiB of its
   level before the phase;
20. the repo's programs (ray_tpu_torch.examples and the soak's LM
   workload) on a fresh init(num_gpus=1): (a) every example that
   computes at its full size on the card, each one's wall: lm_serving (its
   own checks: greedy outputs equal to generate() on the card, the stream
   to its whole response, the speculative output to greedy; every decode
   tick of its plain backend 1 + 2L K1 and L K6, at D 64 f32),
   serve_model (replicas, the 80/20 canary, HTTP), parameter_server sync
   and async (loss under 1.0), hyperparameter_search (6 learning rates
   under ASHA), cartpole_ppo (30 iterations, the reward curve) and
   pipelined_transformer (dp2 x pp2 x tp2 over 8 rank processes sharing
   the card: every rank's losses equal and falling, its K3, K4, K5
   launches a step exactly L/pp x microbatches); (b) lm_serving --smoke
   (K6 at D 16), and K3-K5 at pipelined_transformer --smoke's shapes of a
   rank (D 16, f32) against their plain versions; (c) soak.lm_serve for
   SOAK_S seconds: its own pins and stall rule, its iterations and median,
   K1 and K7 (at D 8) launched, and this process's allocated memory
   after its serve.shutdown() within half of what its replica's build
   added; (d) K6 and K7 at D 8, 16 and 32 and K3-K5 at D 16 and 32, in
   f32 and bf16, against their plain versions (K7 equal to K6 bit for bit
   on the same rows), each timed beside its bound and plain version.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import hashlib
import http.client
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
import weakref

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import metrics as rt_metrics
from ray_tpu_torch._kernels import build
from ray_tpu_torch._tree import tree_map
from ray_tpu_torch.models import (
    TransformerConfig, VisionConfig, init_params, init_vision_params,
    loss_fn, make_train_step, named_leaves, to_compute, vision_accuracy,
    vision_apply, vision_loss,
)
from ray_tpu_torch.models import engine as engine_mod
from ray_tpu_torch.models import moe_transformer as moe_tr
from ray_tpu_torch.models import paged_engine as paged_mod
from ray_tpu_torch.models import speculative
from ray_tpu_torch.ops import attention, fused, paged_attention
from ray_tpu_torch.parallel import moe as moe_mod
from ray_tpu_torch.scheduler import kernel as sched
from ray_tpu_torch.scheduler import reference as sched_ref
from ray_tpu_torch.scheduler.dag import (
    collapse_chains, fanout_dag, random_dag, uniform_cluster,
)
from ray_tpu_torch import serve
from ray_tpu_torch.serve import LMBackend, ServeRequest, accept_batch
from ray_tpu_torch.serve.master import MASTER_NAME
from ray_tpu_torch.train import MeshTrainer, TPUTrainer

# Flagship config (scripts/model_bench.py's decode benchmark) and engine.
FLAGSHIP = dict(vocab_size=32_000, d_model=1024, n_layers=8, n_heads=16,
                n_kv_heads=16, d_ff=4096, max_seq_len=2048)
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 2048, 32
# The paged engine: the JAX package's default page size; a 512-token shared
# prefix (4 full pages); a pool of 17 pages (the scratch page and one
# max_seq sequence), on which that traffic queues for pages; the chunked
# prefill of one long prompt.
PAGE, PREFIX, TIGHT_PAGES, CHUNK, LONG_PROMPT = 128, 512, 17, 256, 1536
# Speculative serving: 4 drafts from bigram prompt lookup; quoting prompts of
# a 96-token passage and its first 32 tokens again, 64 new tokens.
SPEC_K, SPEC_NGRAM = 4, 2
QUOTE_PASSAGE, QUOTE_REPEAT, QUOTE_NEW = 96, 32, 64
# The train step of scripts/model_bench.py's bench_config: batch 8, seq 2048.
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 2048, 5
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet), for the least-time bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
EPS = 1e-5
# Workload (a) of phase 8 (bench.py's 100k-task random DAG on 256 nodes) at
# prng_key(0): its rounds and the sha256 of its int32 placement bytes, as
# the JAX package computes them (tests/test_torch_scheduler.py checks both).
SCHED_A_ROUNDS = 57
SCHED_A_SHA256 = "857b62605f345e68b0f66dddc2563fc22bd68c56230cc39b899a10a323d4422e"


def log(msg: str) -> None:
    print(msg, flush=True)


# Every kernel wrapper's launch counter (the wrapper and the attribute it
# counts in), by the kernel's name in the {"kernels": [...]} line. K1 has
# three: its plain forward, its residual form and its backward.
COUNTED = {
    "rms_norm": (fused.rms_norm, "launches"),
    "add_rms_norm": (fused.add_rms_norm, "launches"),
    "rms_norm_backward": (fused.rms_norm, "backward_launches"),
    "decode_attention": (attention.decode_attention, "launches"),
    "softmax_xent": (fused.softmax_cross_entropy, "launches"),
    "flash_forward": (attention.flash_forward, "launches"),
    "flash_backward_dq": (attention.flash_backward_dq, "launches"),
    "flash_backward_dkv": (attention.flash_backward_dkv, "launches"),
    "paged_decode_attention": (paged_attention.paged_decode_attention,
                               "launches"),
}


def reset_counts() -> None:
    for fn, attr in COUNTED.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTED.items()}


# Where phases 11-17 put their tensors, ranks and actors, and where the
# cluster's GCS must place: the card. A CPU rehearsal sets "cpu" (with the
# kernels' plain versions counting launches).
DEVICE = "cuda"


def dev_sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def dev_free() -> int:
    """The card's free bytes, device-wide, after a collect, with this
    process's cached blocks handed back (0 on the CPU). cuBLAS keeps a
    workspace for each handle a thread used after the thread ends (actor
    threads), and one carved from a large freed segment keeps the whole
    segment reserved: they are cleared first."""
    gc.collect()
    if DEVICE != "cuda":
        return 0
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                atol: float, rtol: float) -> float:
    err = max_err(got, want)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{name}: {m}")
    # The least atol that would pass beside this rtol: the margin left.
    need = ((got.float() - want.float()).abs()
            - rtol * want.float().abs()).clamp_min(0).max().item()
    log(f"  {name}: max_abs_err {err:.3e}, needs atol {need:.3e} at rtol "
        f"{rtol} (atol {atol}) ok")
    return err


def check_bound(name: str, got: torch.Tensor, want: torch.Tensor,
                bnd: torch.Tensor) -> float:
    """|got - want| <= bnd everywhere, else fail. Prints the largest error,
    the largest ratio of error to bound, and the one-ulp check's reading
    (atol 1e-5, rtol 2^-7): the elements it fails and the most any
    exceeds it by."""
    d = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    ratio = torch.where(d > 0, d / bnd, 0.0).max().item()
    over = d - (1e-5 + 2 ** -7 * want.float().abs())
    n_old = int((over > 0).sum())
    log(f"  {name}: max_abs_err {d.max().item():.3e}, at most "
        f"{ratio:.3f} of the bound; one-ulp check fails {n_old} of "
        f"{d.numel()} by up to {max(over.max().item(), 0.0):.3e}")
    if ratio > 1.0:
        raise AssertionError(f"{name}: error {ratio:.3f} times its bound")
    return d.max().item()


# ------------------------------------------------------------- timing


def device_ms(what: str, fn, arg_sets, iters: int,
              sleep_cycles: int = 1_000_000_000) -> float:
    """Device time per call of fn(*args), args cycling through arg_sets
    (copies that together exceed the 50 MB L2, so each call finds its
    inputs cold, as the serving path does). A sleep kernel first holds
    the stream while the host queues every call, so CUDA events time the
    calls back to back and not the host's launch overhead; if the sleep
    ended before the host finished queueing, the figure is host-bound and
    a line naming ``what`` says so."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    if start.query():
        log(f"  ({what}: the sleep ended before the host queued every "
            "call, so this time is an upper bound set by the host)")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, ops: int, dtype) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the peak
    rate for the inputs' type, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def n_copies(bytes_per_call: int) -> int:
    return max(1, min(64, math.ceil(128e6 / max(bytes_per_call, 1))))


def ptxas_report(log_text: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from nvcc -Xptxas=-v output."""
    out, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


TC_KERNELS = ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
              "flash_dkv_tc_kernel")   # K3, K4, K5 in bf16


TC_HEAD_DIMS = set(attention.FLASH_HEAD_DIMS)   # each tensor-core K3-K5


def check_tc_ptxas(log_text: str) -> None:
    """The bf16 K3, K4 and K5 (tensor cores) at D 16, 32, 64 and 128:
    registers and spills as ptxas reports them; any spill, a missing
    instantiation, or a bf16 instantiation of the FMA kernels fails the
    run."""
    seen = {kern: set() for kern in TC_KERNELS}
    for name, r in sorted(ptxas_report(log_text).items()):
        if re.search(r"flash_(fwd|dq|dkv)_kernelI13__nv_bfloat16", name):
            raise AssertionError(f"a bf16 FMA flash kernel is built: {name}")
        m = re.search(r"(flash_(?:fwd|dq|dkv)_tc_kernel)ILi(\d+)ELb([01])E",
                      name)
        if not m:
            continue
        D, causal = int(m.group(2)), m.group(3) == "1"
        what = f"{m.group(1)}<D={D}, causal={causal}>"
        log(f"  {what}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads, "
            f"{r.get('stack')} bytes stack")
        if r.get("spill_stores") != 0 or r.get("spill_loads") != 0:
            raise AssertionError(f"{what} spills: {r}")
        seen[m.group(1)].add(D)
    for kern, ds in seen.items():
        if ds != TC_HEAD_DIMS:
            raise AssertionError(f"ptxas reported no {kern} at D "
                                 f"{sorted(TC_HEAD_DIMS - ds)}")


# ------------------------------------------------- phase 2: kernel checks


def rms_inputs(rows: int, dtype, seed: int):
    g = cuda_gen(seed)
    x = torch.randn(rows, FLAGSHIP["d_model"], generator=g, device="cuda")
    w = 1.0 + 0.1 * torch.randn(FLAGSHIP["d_model"], generator=g,
                                device="cuda")
    return x.to(dtype), w.to(dtype)


def decode_inputs(B, H, KH, D, S, lengths, dtype, seed: int):
    g = cuda_gen(seed)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KH, D, generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def split_edges(B, KH, S, count):
    """count lengths below S at the split edges of the decode kernels' plan
    at B*KH (attention.decode_splits): a length whose last row is the first
    row of a split (a split of one row) or the row before it (the last row
    of the split before), spread over the ones there are."""
    n_split = attention.decode_splits(B * KH)
    edges = set()
    for L in range(1, S):
        plan = attention.split_plan(L, n_split)
        if len(plan) > 1 and plan[-1][0] == L:
            edges |= {L - 1, L}
    edges = sorted(edges)
    return [edges[round(i * (len(edges) - 1) / (count - 1))]
            for i in range(count)]


def check_kernels() -> dict:
    """Each kernel against its plain version on the same CUDA tensors.
    f32: RMSNorm rtol 1e-5 (atol 1e-6 near zero), decode atol 2e-5 — the
    two differ only in summation order. bf16: atol = rtol = 2e-2, since the
    plain versions round intermediates (x*inv; scores and probabilities)
    to bf16 and the kernels do not."""
    errs = {"rms_norm": 0.0}
    log("phase 2: kernels vs plain PyTorch on the card")
    # RMSNorm at the serving rows (a decode tick's 8, the prefill buckets
    # 64 and 2048), the train step's B*T rows, and the [B, T, E] input the
    # train forward passes it, requiring grad; its recorded error is the
    # largest over these shapes in bf16.
    E = FLAGSHIP["d_model"]
    for shape in ((8, E), (64, E), (2048, E), (TRAIN_B * TRAIN_T, E),
                  (TRAIN_B, TRAIN_T, E)):
        rows = math.prod(shape[:-1])
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_inputs(rows, dtype, seed=rows + len(shape) - 2)
            x = x.reshape(shape).requires_grad_(len(shape) == 3)
            tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(
                f"rms_norm {list(shape)} {str(dtype)[6:]}",
                fused.rms_norm(x, w, EPS).detach(),
                fused._rms_norm_ref(x, w, EPS).detach(), **tol)
            if dtype == torch.bfloat16:
                errs["rms_norm"] = max(errs["rms_norm"], err)
            del x, w
    check_k1_residual_and_backward(errs)
    # Flagship decode shape (G=1, D=64) with lengths at 0, mid-tile, a tile
    # edge and S-1, and at the edges of its splits; a GQA shape (G=8,
    # D=128); a long cache, where many splits are live. Each split launch
    # must give the same bits twice.
    flag_lens = [0, 31, 63, 64, 100, 1000, 2046, 2047]
    for (B, H, KH, D, S, lens), tag in (
            ((8, 16, 16, 64, 2048, flag_lens), "flagship"),
            ((8, 16, 16, 64, 2048, split_edges(8, 16, 2048, 8)),
             "split edges"),
            ((4, 32, 4, 128, 1024, [0, 511, 64, 1023]), "gqa"),
            ((2, 16, 16, 64, 8192, [8191, 5000]), "long cache")):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ln = decode_inputs(B, H, KH, D, S, lens, dtype, seed=D)
            tol = (dict(atol=2e-5, rtol=0.0) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            what = (f"decode_attention {tag} B={B} H={H} KH={KH} D={D} "
                    f"S={S} {str(dtype)[6:]}, "
                    f"{attention.decode_splits(B * KH)} splits")
            got = attention.decode_attention(q, k, v, ln)
            err = check_close(
                what, got, attention._decode_attention_ref(q, k, v, ln),
                **tol)
            if not torch.equal(attention.decode_attention(q, k, v, ln), got):
                raise AssertionError(f"{what}: a second launch differs")
            if tag == "flagship" and dtype == torch.bfloat16:
                errs["decode_attention"] = err
            del q, k, v
    torch.cuda.synchronize()
    return errs


def check_k1_residual_and_backward(errs: dict) -> None:
    """K1's residual form at the shapes of check_kernels: h must be
    PyTorch's x + a and y the plain K1 launch's y on that h, bit for bit
    (y is also held to the plain version as K1 is). K1's backward at a
    decode tick's 8 rows and the train step's B*T, with and without the
    residual's gradient g_h: the same bits on a second launch; against
    the plain backward plus g_h (as autograd added it), dx within f32
    atol = rtol = 1e-5 and, without g_h, bf16 atol = rtol = 2^-7; with
    g_h the bf16 dx within fused._rms_norm_dx_bound (the plain version
    rounds the norm's dx before adding g_h, the kernel rounds once); dw in
    bf16 within 2^-7 and in f32 within fused._rms_norm_dw_bound (over
    16384 rows the plain column sum is itself further than 1e-5 from the
    exact sum). The bounds' derivations are beside the helpers; check_bound
    prints the one-ulp check's reading (atol 1e-5, rtol 2^-7) beside."""
    E = FLAGSHIP["d_model"]
    errs.update(add_rms_norm=0.0, rms_norm_backward=0.0)
    for shape in ((8, E), (64, E), (2048, E), (TRAIN_B * TRAIN_T, E),
                  (TRAIN_B, TRAIN_T, E)):
        rows = math.prod(shape[:-1])
        for dtype in (torch.float32, torch.bfloat16):
            x, w = rms_inputs(rows, dtype, seed=rows + 7)
            a, _ = rms_inputs(rows, dtype, seed=rows + 8)
            x, a = x.reshape(shape), a.reshape(shape)
            what = f"add_rms_norm {list(shape)} {str(dtype)[6:]}"
            h, y = fused.add_rms_norm(x, a, w, EPS)
            if not torch.equal(h, x + a):
                raise AssertionError(f"{what}: h differs from x + a")
            plain_k1 = fused.rms_norm(h, w, EPS)
            if not torch.equal(y, plain_k1):
                raise AssertionError(f"{what}: y differs from rms_norm(h) "
                                     f"by {max_err(y, plain_k1)}")
            tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(f"{what} y", y, fused._rms_norm_ref(h, w, EPS),
                              **tol)
            if dtype == torch.bfloat16:
                errs["add_rms_norm"] = max(errs["add_rms_norm"], err)
            del x, a, h, y, plain_k1
    log("  add_rms_norm: h == x + a and y == rms_norm(h), bit for bit, at "
        "every shape")
    blocks_of = fused._rms_fn("rms_norm_backward_blocks")
    for rows in (SLOTS, TRAIN_B * TRAIN_T):
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            h, w = rms_inputs(rows, dtype, seed=rows + 9)
            gy, _ = rms_inputs(rows, dtype, seed=rows + 10)
            gh, _ = rms_inputs(rows, dtype, seed=rows + 11)
            for g_h in (gh, None):
                what = (f"rms_norm_backward [{rows}, {E}] {str(dtype)[6:]}, "
                        f"{'with' if g_h is not None else 'no'} g_h")
                dx, dw = fused._rms_norm_bwd_cuda(h, w, gy, g_h, EPS)
                dx2, dw2 = fused._rms_norm_bwd_cuda(h, w, gy, g_h, EPS)
                if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
                    raise AssertionError(f"{what}: a second launch differs")
                dx_norm, want_dw = fused._rms_norm_bwd(h, w, gy, EPS)
                want_dx = dx_norm if g_h is None else dx_norm + g_h
                tol = (dict(atol=1e-5, rtol=1e-5) if f32
                       else dict(atol=2 ** -7, rtol=2 ** -7))
                if f32 or g_h is None:
                    e_dx = check_close(f"{what} dx", dx, want_dx, **tol)
                else:
                    e_dx = check_bound(f"{what} dx", dx, want_dx,
                                       fused._rms_norm_dx_bound(
                                           dx, want_dx, dx_norm))
                if f32:
                    bnd = fused._rms_norm_dw_bound(h, gy, EPS, want_dw,
                                                   blocks_of(rows))
                    d = (dw - want_dw).abs()
                    ratio = (d / bnd).max().item()
                    over = int((d > 1e-5 + 1e-5 * want_dw.abs()).sum())
                    log(f"  {what} dw: max_abs_err {d.max().item():.3e}, at "
                        f"most {ratio:.3f} of the bound; atol = rtol = 1e-5 "
                        f"fails {over} of {E}")
                    if ratio > 1.0:
                        raise AssertionError(f"{what} dw: error {ratio:.3f} "
                                             f"times its bound")
                else:
                    e_dw = check_close(f"{what} dw", dw, want_dw, **tol)
                    if rows > SLOTS and g_h is not None:
                        errs["rms_norm_backward"] = max(e_dx, e_dw)
            del h, w, gy, gh
    log("  rms_norm_backward: every second launch gives the first's bits")


def paged_inputs(B, H, KH, D, ps, P, lengths, dtype, seed: int):
    """A pool of B * P pages past the scratch page 0, handed to the
    sequences in shuffled order; tables -1 padded past each sequence's
    pages. The last sequence is idle (length 0, a table of -1)."""
    g = cuda_gen(seed)
    num_pages = B * P + 1
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(num_pages, ps, KH, D, generator=g,
                     device="cuda").to(dtype)
    vp = torch.randn(num_pages, ps, KH, D, generator=g,
                     device="cuda").to(dtype)
    ids = np.random.default_rng(seed).permutation(B * P) + 1
    table = np.full((B, P), -1, np.int32)
    for b, L in enumerate(lengths[:-1]):
        used = -(-(L + 1) // ps)
        table[b, :used] = ids[b * P:b * P + used]
    lens = list(lengths[:-1]) + [0]
    return (q, kp, vp, torch.tensor(table, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


PAGED_SHAPES = (   # (tag, B, H, KH, D, page size, P, lengths; last idle)
    ("flagship", SLOTS, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"],
     FLAGSHIP["d_model"] // FLAGSHIP["n_heads"], PAGE, MAX_SEQ // PAGE,
     [0, 127, 128, 600, 2047, 1000, 64, 0]),
    ("split edges", SLOTS, 16, 16, 64, PAGE, MAX_SEQ // PAGE,
     split_edges(SLOTS, 16, MAX_SEQ, SLOTS - 1) + [0]),
    ("gqa", 5, 32, 4, 128, 64, 16, [0, 63, 500, 1023, 0]),
    ("small page", 4, 8, 2, 64, 16, 16, [80, 127, 250, 0]),
    ("long cache", 3, 16, 16, 64, PAGE, 64, [8191, 5000, 0]),
)


def check_paged_kernel() -> dict:
    """K7 against its plain version on the same CUDA tensors, with shuffled
    physical pages, -1 padded tables and an idle row: f32 atol 2e-5 (the
    two differ only in summation order), bf16 atol = rtol = 2e-2 (the
    plain version rounds scores and probabilities to bf16). And K7 against
    K6 on the same rows gathered into a contiguous cache: equal bit for
    bit, since both split a sequence by K6's plan and walk K6's tiles with
    K6's arithmetic; and to itself on a second launch."""
    errs = {}
    log("phase 2: paged decode kernel vs plain PyTorch on the card")
    for tag, B, H, KH, D, ps, P, lens in PAGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, ln = paged_inputs(B, H, KH, D, ps, P, lens,
                                                dtype, seed=D + ps)
            what = (f"paged_decode_attention {tag} B={B} H={H} KH={KH} "
                    f"D={D} ps={ps} P={P} {str(dtype)[6:]}, "
                    f"{attention.decode_splits(B * KH)} splits")
            got = paged_attention.paged_decode_attention(q, kp, vp, table,
                                                         ln)
            if not torch.equal(paged_attention.paged_decode_attention(
                    q, kp, vp, table, ln), got):
                raise AssertionError(f"{what}: a second launch differs")
            tol = (dict(atol=2e-5, rtol=0.0) if dtype == torch.float32
                   else dict(atol=2e-2, rtol=2e-2))
            err = check_close(
                what, got, paged_attention._paged_decode_ref(
                    q, kp, vp, table, ln), **tol)
            k6 = attention.decode_attention(
                q, paged_attention.paged_gather(kp, table).contiguous(),
                paged_attention.paged_gather(vp, table).contiguous(), ln)
            if not torch.equal(got, k6):
                raise AssertionError(
                    f"{what}: differs from K6 on the same rows by "
                    f"{max_err(got, k6):.3e}")
            if tag == "flagship" and dtype == torch.bfloat16:
                errs["paged_decode_attention"] = err
    log("  every paged check equals K6 on the same rows, bit for bit")
    torch.cuda.synchronize()
    return errs


def flash_inputs(B, T, H, KH, D, dtype, seed: int):
    g = cuda_gen(seed)
    q = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, T, KH, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, T, KH, D, generator=g, device="cuda").to(dtype)
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def xent_inputs(N, V, dtype, seed: int):
    g = cuda_gen(seed)
    logits = 3 * torch.randn(N, V, generator=g, device="cuda")
    labels = torch.randint(0, V, (N,), generator=g, device="cuda")
    return logits.to(dtype), labels


FLASH_SHAPES = (   # (tag, B, T = S, H, KH, D, causal)
    ("train", TRAIN_B, TRAIN_T, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"],
     FLAGSHIP["d_model"] // FLAGSHIP["n_heads"], True),
    ("gqa", 2, 1024, 32, 4, 128, True),
    ("ragged", 2, 1000, 8, 2, 64, False),
    ("tile edge", 2, 129, 8, 2, 128, True),
)


def check_train_kernels() -> dict:
    """K2-K5 against their plain versions on the same CUDA tensors.
    K2 (f32 losses of 10-40): atol 1e-4, rtol 1e-5, the two differ in
    summation order and the kernel's online rescaling of the sum. K3-K5 in
    f32: out within atol 1e-5, rtol 1e-5 and lse within 1e-5 (summation
    order; the kernel's softmax is online, the plain one takes the final
    max); dq, dk, dv within atol 1e-4, rtol 1e-4 (sums of up to 2048 x G
    terms in another order). In bf16: lse as in f32 (it is an f32 sum of
    unrounded exponentials in both); out within atol = rtol = 2e-2, since
    the kernel rounds p to bf16 against a running max and the plain version
    against the final one (on an H100 80GB HBM3 at 700 W the largest error
    read 3.9e-3 on |out| up to 3.9, and needed atol 1.2e-3 beside rtol
    2e-2); dq, dk, dv within the bound that
    attention._flash_grad_bounds derives from the numerics (one bf16 ulp of
    the plain result, the f32 sum reordered, the f32 error of p and ds
    before their bf16 rounding, and 16 flipped roundings of p or ds, each
    worth 2^-7 of the row's largest p or ds times the column's largest
    operand; the derivation is beside the helper). The kernels form s and
    dp on the tensor cores in another order than the plain version, so
    roundings of p and ds to bf16 flip and the one-ulp check that held the
    FMA kernels (atol 1e-5, rtol 2^-7) no longer applies; its reading is
    printed for information."""
    errs = {}
    log("phase 2: training kernels vs plain PyTorch on the card")
    for N, V in ((TRAIN_B * TRAIN_T, FLAGSHIP["vocab_size"]), (1000, 32001)):
        logits, labels = xent_inputs(N, V, torch.float32, seed=N)
        err = check_close(f"softmax_xent [{N}, {V}] f32",
                          fused.softmax_cross_entropy(logits, labels),
                          fused._xent_ref(logits, labels), atol=1e-4,
                          rtol=1e-5)
        errs.setdefault("softmax_xent", err)
        del logits, labels
    for tag, B, T, H, KH, D, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            q, k, v, do = flash_inputs(B, T, H, KH, D, dtype, seed=T + D)
            what = (f"{tag} B={B} T=S={T} H={H} KH={KH} D={D} "
                    f"{'causal' if causal else 'full'} {str(dtype)[6:]}")
            out, lse = attention.flash_forward(q, k, v, causal)
            ref_out, ref_lse = attention._flash_forward_ref(q, k, v, causal)
            e_out = check_close(f"flash_forward out {what}", out, ref_out,
                                **(dict(atol=1e-5, rtol=1e-5) if f32
                                   else dict(atol=2e-2, rtol=2e-2)))
            check_close(f"flash_forward lse {what}", lse, ref_lse,
                        atol=1e-5, rtol=1e-6)
            dsum = attention._flash_dsum(ref_out, do)
            args = (q, k, v, do, ref_lse, dsum, causal)
            got = (attention.flash_backward_dq(*args),
                   *attention.flash_backward_dkv(*args))
            want = (attention._flash_backward_dq_ref(*args),
                    *attention._flash_backward_dkv_ref(*args))
            names = [f"flash_backward_dq {what}",
                     f"flash_backward_dkv dk {what}",
                     f"flash_backward_dkv dv {what}"]
            if f32:
                e = [check_close(n, x, w, atol=1e-4, rtol=1e-4)
                     for n, x, w in zip(names, got, want)]
            else:
                bounds = attention._flash_grad_bounds(*args[:6], *want,
                                                      causal=causal)
                e = [check_bound(n, x, w, bd)
                     for n, x, w, bd in zip(names, got, want, bounds)]
                del bounds
            e_dq, e_dkv = e[0], max(e[1:])
            if tag == "train" and not f32:
                errs.update(flash_forward=e_out, flash_backward_dq=e_dq,
                            flash_backward_dkv=e_dkv)
            del q, k, v, do, out, lse, ref_out, ref_lse, dsum, got, want
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


# -------------------------------------------- phase 3: the serving path


def count_delta(before: dict) -> dict:
    return {n: c - before[n] for n, c in read_counts().items()}


class PathProbe:
    """Counts and times the engine's prefills and decode ticks (host clock
    around work that ends in a synchronize), keeps each tick's slot lengths
    so the kernels can be timed on this run's data, and the kernel launches
    of each prefill and each tick."""

    def __init__(self, eng):
        self.prefills, self.ticks = [], []
        self.tick_lengths = []
        self.prefill_launches, self.tick_launches = [], []
        self._prefill, self._decode = eng._prefill_slot, eng._decode_all
        eng._prefill_slot, eng._decode_all = self.prefill, self.decode
        self.eng = eng

    def prefill(self, slot, req):
        T0 = len(req.prompt)
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        done = self._prefill(slot, req)
        torch.cuda.synchronize()
        bucket = min(1 << (T0 - 1).bit_length(), self.eng.max_seq)
        self.prefills.append((bucket, (time.perf_counter() - t0) * 1e3))
        self.prefill_launches.append(count_delta(before))
        return done

    def decode(self):
        active = sum(r is not None for r in self.eng.active)
        self.tick_lengths.append((active, self.eng.lengths.copy()))
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        logits = self._decode()
        torch.cuda.synchronize()
        self.ticks.append((active, (time.perf_counter() - t0) * 1e3))
        self.tick_launches.append(count_delta(before))
        return logits


class PagedProbe(PathProbe):
    """PathProbe for the paged engine: also keeps each tick's page tables,
    the pages two or more active slots read, the pages each active slot
    reads through K7, and how often the page budget refused the queue head
    while a slot was free."""

    def __init__(self, eng):
        super().__init__(eng)
        self.tables, self.shared, self.pages_read = [], [], []
        self.refusals = 0
        self._can_admit = eng._can_admit
        eng._can_admit = self.can_admit

    def can_admit(self, req) -> bool:
        ok = self._can_admit(req)
        if not ok and any(r is None for r in self.eng.active):
            self.refusals += 1
        return ok

    def decode(self):
        eng = self.eng
        self.tables.append(eng._tables.copy())
        live = [s for s, r in enumerate(eng.active) if r is not None]
        pages = [int(pg) for s in live for pg in eng._tables[s] if pg >= 0]
        self.shared.append(len({pg for pg in pages if pages.count(pg) > 1}))
        self.pages_read.append([int(eng.lengths[s]) // eng.page_size + 1
                                for s in live])
        return super().decode()


def stream_all(backend, prompt, n):
    tok = backend.stream_start(prompt, max_new_tokens=n)
    got = []
    for _ in range(10_000):
        r = backend.stream_poll(tok, wait_s=5.0)
        got += r["tokens"]
        if r["done"]:
            return got
    raise AssertionError("stream did not finish")


def serving_prompts(V: int) -> list:
    """Phase 3's 12 greedy prompts, 17-64 tokens (buckets 32 and 64)."""
    rng = np.random.default_rng(SEED)
    lens = [17, 20, 24, 29, 32, 33, 40, 47, 52, 58, 61, 64]
    return [rng.integers(0, V, T0).tolist() for T0 in lens]


def main_path(params, cfg) -> dict:
    log("phase 3: serving path, LMBackend at the flagship config, bf16, "
        "8 slots, max_seq 2048")
    backend = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        device="cuda")
    V = cfg.vocab_size
    # Warm-up outside the counted run (cuBLAS handles, first launches).
    backend([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
    probe = PathProbe(backend.engine)

    prompts = serving_prompts(V)
    reset_counts()

    t0 = time.perf_counter()
    outs = backend([ServeRequest((p,), {"max_new_tokens": NEW_TOKENS})
                    for p in prompts])
    batch_s = time.perf_counter() - t0
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = backend([ServeRequest((prompts[3],), sample_kw)])[0]
    s2 = backend([ServeRequest((prompts[3],), sample_kw)])[0]
    streamed = stream_all(backend, prompts[0], NEW_TOKENS)

    launches = read_counts()
    n_pre, n_tick = len(probe.prefills), len(probe.ticks)
    log(f"  12 greedy requests x {NEW_TOKENS} tokens in {batch_s:.3f} s; "
        f"{n_pre} prefills, {n_tick} decode ticks on the whole path")
    for i, out in enumerate(outs):
        if len(out) != NEW_TOKENS or not all(0 <= t < V for t in out):
            raise AssertionError(f"request {i}: bad output {out}")
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"seeded sampling not reproducible: {s1} {s2}")
    log(f"  sampled (T=0.8, seed=42) twice, equal: {s1[:8]}...")
    if streamed != outs[0]:
        raise AssertionError(
            f"stream {streamed} != whole response {outs[0]}")
    log(f"  streamed request equals its whole response: {streamed[:8]}...")

    L = cfg.n_layers
    want = {"rms_norm": n_pre + n_tick,
            "add_rms_norm": 2 * L * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    log(f"  launches {launches}, expected {want} "
        f"(K1 {2 * L + 1} per prefill and per tick: rms_norm 1, "
        f"add_rms_norm {2 * L}; decode_attention {L} per tick)")
    for name in want:
        if launches[name] == 0 or launches[name] != want[name]:
            raise AssertionError(
                f"{name}: {launches[name]} launches on the main path, "
                f"expected {want[name]}")
    stray = {n: c for n, c in launches.items() if n not in want and c}
    if stray:
        raise AssertionError(f"training kernels ran while serving: {stray}")
    check_launches_each(probe.prefill_launches + probe.tick_launches, L,
                        "prefill or tick")
    return {"launches": launches, "probe": probe, "backend": backend,
            "outs": outs, "sampled": s1}


def check_launches_each(per_run, L: int, what: str) -> None:
    """Every forward (a prefill, a prefill chunk, a decode tick) launches
    K1 2L + 1 times: once plain, 2L times in its residual form."""
    for i, got in enumerate(per_run):
        n = got["rms_norm"]
        if n == 0 or got["add_rms_norm"] != 2 * L * n:
            raise AssertionError(
                f"{what} {i}: {n} plain and {got['add_rms_norm']} residual "
                f"K1 launches, expected 1 and {2 * L} per forward")


# --------------------------------- phase 3b: the paged serving path


def check_paged_launches(probes, L: int) -> dict:
    """Every paged decode tick launches exactly L paged-decode, 0 decode
    and 2L+1 RMSNorm kernels (1 plain, 2L in the residual form) and
    nothing else; every prefill launches K1 so per forward (once, or once
    per chunk run) and no attention kernel. Returns the totals they add
    up to."""
    per_tick = {n: 0 for n in COUNTED}
    per_tick.update(rms_norm=1, add_rms_norm=2 * L,
                    paged_decode_attention=L)
    total = {n: 0 for n in COUNTED}
    for probe in probes:
        for i, got in enumerate(probe.tick_launches):
            if got != per_tick:
                raise AssertionError(f"paged tick {i}: launches {got}, "
                                     f"expected {per_tick}")
        check_launches_each(probe.prefill_launches, L, "paged prefill")
        for i, got in enumerate(probe.prefill_launches):
            if any(c for n, c in got.items()
                   if n not in ("rms_norm", "add_rms_norm")):
                raise AssertionError(f"paged prefill {i}: launches {got}")
        for got in probe.tick_launches + probe.prefill_launches:
            for n, c in got.items():
                total[n] += c
    return total


def paged_traffic(V: int):
    """Phase 3b's requests: a 512-token prefix, 16 suffix lengths, the 16
    shared-prefix prompts and one long prompt."""
    rng = np.random.default_rng(SEED + 5)
    prefix = rng.integers(0, V, PREFIX).tolist()
    suffixes = rng.permutation(np.arange(8, 201))[:16]
    shared = [prefix + rng.integers(0, V, int(n)).tolist() for n in suffixes]
    long_prompt = rng.integers(0, V, LONG_PROMPT).tolist()
    return prefix, suffixes, shared, long_prompt


def paged_path(params, cfg) -> dict:
    """LMBackend(paged=True) at the flagship config, against LMBackend
    over the contiguous engine on the same requests. The contiguous runs
    come first, outside the counted window."""
    log(f"phase 3b: paged serving path, LMBackend(paged=True) at the "
        f"flagship config, bf16, {SLOTS} slots, max_seq {MAX_SEQ}, page "
        f"size {PAGE}")
    V, L = cfg.vocab_size, cfg.n_layers
    prefix, suffixes, shared, long_prompt = paged_traffic(V)

    def served(backend, prompts, n):
        return backend([ServeRequest((p,), {"max_new_tokens": n})
                        for p in prompts])

    contig = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                       device="cuda")
    contig_probe = PathProbe(contig.engine)
    want_shared = served(contig, shared, NEW_TOKENS)
    want_long = served(LMBackend(params, cfg, max_slots=SLOTS,
                                 max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                                 device="cuda"), [long_prompt], 64)[0]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    # (a) 16 greedy requests sharing a 4-page prefix, on the default pool.
    backend = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        paged=True, page_size=PAGE, device="cuda")
    probe_a = PagedProbe(backend.engine)
    outs = served(backend, shared, NEW_TOKENS)
    # (d) one seeded sampled request twice, one streamed request.
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = backend([ServeRequest((shared[0],), sample_kw)])[0]
    s2 = backend([ServeRequest((shared[0],), sample_kw)])[0]
    streamed = stream_all(backend, shared[1], NEW_TOKENS)
    # (b) the same traffic on a pool that queues admission for pages.
    tight = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                      paged=True, page_size=PAGE, num_pages=TIGHT_PAGES,
                      device="cuda")
    probe_b = PagedProbe(tight.engine)
    outs_tight = served(tight, shared, NEW_TOKENS)
    # (c) one long prompt through chunked prefill.
    chunked = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                        paged=True, page_size=PAGE, prefill_chunk=CHUNK,
                        device="cuda")
    probe_c = PagedProbe(chunked.engine)
    out_long = served(chunked, [long_prompt], 64)[0]
    torch.cuda.synchronize()
    launches = read_counts()
    wall_s = time.perf_counter() - t0

    probes = (probe_a, probe_b, probe_c)
    n_tick = sum(len(p.ticks) for p in probes)
    n_pre = sum(len(p.prefills) for p in probes)
    log(f"  (a)-(d) in {wall_s:.3f} s: {n_pre} prefills, {n_tick} paged "
        f"decode ticks")
    if outs != want_shared:
        bad = [i for i, (a, b) in enumerate(zip(outs, want_shared)) if a != b]
        raise AssertionError(f"(a) paged outputs differ from the contiguous "
                             f"engine's for requests {bad}")
    most = max(probe_a.shared)
    if most < PREFIX // PAGE:
        raise AssertionError(f"(a) at most {most} pages were shared between "
                             f"live requests, expected {PREFIX // PAGE}")
    log(f"  (a) 16 greedy requests (prefix {PREFIX} + suffixes "
        f"{int(suffixes.min())}-{int(suffixes.max())} tokens) equal the "
        f"contiguous engine's; up to {most} pages shared by live requests; "
        f"pool {backend.engine.num_pages} pages")
    if outs_tight != want_shared:
        raise AssertionError("(b) tight-pool outputs differ from the "
                             "contiguous engine's")
    if probe_b.refusals == 0:
        raise AssertionError("(b) the page budget never held the queue")
    log(f"  (b) pool of {TIGHT_PAGES} pages: the page budget held the queue "
        f"head {probe_b.refusals} times while a slot was free; at most "
        f"{max(a for a, _ in probe_b.ticks)} requests ran at once; every "
        f"output equals the contiguous engine's")
    if out_long != want_long:
        raise AssertionError("(c) chunked paged prefill output differs from "
                             "the contiguous engine's")
    reads = sorted({n for r in probe_c.pages_read for n in r})
    log(f"  (c) {LONG_PROMPT}-token prompt, prefill_chunk {CHUNK}, 64 new "
        f"tokens: equal to the contiguous engine's; {len(probe_c.prefills)} "
        f"prefill ({probe_c.prefill_launches[0]['rms_norm']} chunks), "
        f"decode ticks read {reads[0]}-{reads[-1]} pages through K7")
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"seeded sampling not reproducible: {s1} {s2}")
    if streamed != outs[1]:
        raise AssertionError(f"stream {streamed} != whole response "
                             f"{outs[1]}")
    log(f"  (d) sampled (T=0.8, seed=42) twice, equal: {s1[:8]}...; "
        f"streamed request equals its whole response")
    total = check_paged_launches(probes, L)
    if total != launches:
        raise AssertionError(f"launches {launches} != the prefills' and "
                             f"ticks' {total}")
    log(f"  launches {launches}: every tick exactly {L} paged_decode, 0 "
        f"decode_attention, 1 rms_norm and {2 * L} add_rms_norm")
    return {"launches": launches, "probe": probe_a, "backend": backend,
            "contig": contig.engine, "contig_probe": contig_probe,
            "want_shared": want_shared, "out_long": out_long}


# ------------------------------ phase 3c: speculative serving, both engines


def ulp_bf16(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


# A greedy token of the speculative path may differ from the plain path's
# only where the plain path's top-2 logits lie within this many bf16 ulps
# of its top logit: one ulp for the two paths' roundings of each logit to
# bf16 (half an ulp each), and one for each bf16 rounding the plain verify
# attention makes and K6 does not (its scores, its probabilities, its
# output), each taken to reach the logit as at most one ulp. A fault in the
# verify (a wrong position, row or mask) moves logits by far more.
FLIP_ULPS = 4


def spec_traffic(V: int) -> dict:
    """Phase 3c's requests: (a) 8 quoting prompts, each a seeded 96-token
    passage followed by its first 32 tokens again (prompt lookup's own
    traffic: extraction and summaries that quote the source); (b) phase
    3's 12 greedy prompts; (e) one prompt whose QUOTE_NEW new tokens end at
    exactly max_seq (the passage of (a)'s first prompt repeated)."""
    rng = np.random.default_rng(SEED + 9)
    quoting = []
    for _ in range(SLOTS):
        passage = rng.integers(0, V, QUOTE_PASSAGE).tolist()
        quoting.append(passage + passage[:QUOTE_REPEAT])
    passage = quoting[0][:QUOTE_PASSAGE]
    boundary = (passage * (MAX_SEQ // QUOTE_PASSAGE + 1))[
        :MAX_SEQ - QUOTE_NEW]
    return {"quoting": quoting, "greedy": serving_prompts(V),
            "boundary": boundary}


class SpecProbe(PathProbe):
    """PathProbe for speculative serving: also wraps the verify pass and
    step(). Per pass (verify or decode): its kind and width, launches,
    chunk, lengths and page tables (for replay). Per tick: the slots
    active, its wall (step() less the prefills inside it), the tokens it
    emitted and its pass. With ``gaps`` it also keeps, for every greedy
    token a decode pass picks, the top-2 gap and top logit of its row,
    by (prompt, index in the output), read after the tick's wall is
    taken."""

    def __init__(self, eng, gaps: bool = False):
        super().__init__(eng)
        self.passes, self.chunks, self.tables, self.steps = [], [], [], []
        self.gaps = {} if gaps else None
        self._pending = None
        self._verify, self._step = eng._verify_all, eng.step
        eng._verify_all, eng.step = self.verify, self.step

    def _tables(self):
        t = getattr(self.eng, "_tables", None)
        return None if t is None else t.copy()

    def verify(self, chunk):
        eng = self.eng
        active = sum(r is not None for r in eng.active)
        self.tick_lengths.append((active, eng.lengths.copy()))
        self.chunks.append(chunk.copy())
        self.tables.append(self._tables())
        torch.cuda.synchronize()
        before = read_counts()
        t0 = time.perf_counter()
        logits = self._verify(chunk)
        torch.cuda.synchronize()
        self.ticks.append((active, (time.perf_counter() - t0) * 1e3))
        self.tick_launches.append(count_delta(before))
        self.passes.append(("verify", chunk.shape[1]))
        return logits

    def decode(self):
        eng = self.eng
        self.chunks.append(eng.tokens[:, None].copy())
        self.tables.append(self._tables())
        logits = super().decode()
        self.passes.append(("decode", 1))
        if self.gaps is not None:
            self._pending = (logits, [
                (s, tuple(r.prompt), len(r.out))
                for s, r in enumerate(eng.active)
                if r is not None and r.temperature == 0])
        return logits

    def step(self):
        n_pre, n_pass = len(self.prefills), len(self.passes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = self._step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if len(self.passes) > n_pass:
            ms -= sum(m for _, m in self.prefills[n_pre:])
            self.steps.append((self.ticks[-1][0], ms,
                               len(events) - (len(self.prefills) - n_pre),
                               len(self.passes) - 1))
        if self._pending is not None:
            logits, rows = self._pending
            self._pending = None
            top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
            for s, key, idx in rows:
                self.gaps[key, idx] = (float(top[s, 0] - top[s, 1]),
                                       float(top[s, 0]))
        return events

    def mark(self) -> int:
        return len(self.steps)


def served(backend, prompts, n, **kw):
    return backend([ServeRequest((p,), dict(max_new_tokens=n, **kw))
                    for p in prompts])


def check_spec_launches(probe, L: int, paged: bool) -> dict:
    """Every verify pass launches K1 2L+1 times (1 plain, 2L residual) and
    no decode kernel; the contiguous engine runs no decode pass; a paged
    pass with no drafts launches K1 2L+1 times and K7 L times; prefills
    launch K1 per forward and no attention kernel. Returns the totals."""
    verify = {n: 0 for n in COUNTED}
    verify.update(rms_norm=1, add_rms_norm=2 * L)
    decode = dict(verify, paged_decode_attention=L)
    total = {n: 0 for n in COUNTED}
    for i, ((kind, width), got) in enumerate(zip(probe.passes,
                                                 probe.tick_launches)):
        if kind == "decode" and not paged:
            raise AssertionError(f"pass {i}: the contiguous engine ran its "
                                 "decode pass with speculation on")
        want = verify if kind == "verify" else decode
        if got != want:
            raise AssertionError(f"{kind} pass {i} (width {width}): "
                                 f"launches {got}, expected {want}")
    check_launches_each(probe.prefill_launches, L, "prefill")
    for got in probe.prefill_launches:
        if any(c for n, c in got.items()
               if n not in ("rms_norm", "add_rms_norm")):
            raise AssertionError(f"speculative prefill launches {got}")
    for got in probe.tick_launches + probe.prefill_launches:
        for n, c in got.items():
            total[n] += c
    return total


def greedy_flips(name, got, want, prompts, gaps) -> list:
    """Greedy requests whose speculative output differs from the plain
    path's; at each first difference the plain path's top-2 gap must be
    under FLIP_ULPS bf16 ulps of its top logit, else the run fails."""
    flips = []
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap, top = gaps.get((tuple(p), j), (math.inf, 0.0))
        bnd = FLIP_ULPS * ulp_bf16(top)
        log(f"  {name}: greedy request (prompt {len(p)}) differs from the "
            f"plain path at token {j}: plain top-2 gap {gap:.6g} at top "
            f"logit {top:.6g}, bound {bnd:.6g} ({FLIP_ULPS} bf16 ulps)")
        if not gap < bnd:
            raise AssertionError(f"{name}: a greedy token differs where the "
                                 f"plain path's top-2 gap {gap} is not under "
                                 f"{bnd}")
        flips.append((len(p), j, gap, bnd))
    return flips


def speculative_path(params, cfg, main: dict, paged: dict) -> dict:
    """Both engines with speculative_k=4 through LMBackend at the flagship
    config, against the same engines with speculation off on the same
    requests. The plain runs come first, outside the counted window."""
    log(f"phase 3c: speculative serving, LMBackend(speculative_k={SPEC_K}, "
        f"speculative_ngram={SPEC_NGRAM}) and LMBackend(paged=True, ...) at "
        f"the flagship config, bf16, {SLOTS} slots, max_seq {MAX_SEQ}, page "
        f"size {PAGE}")
    V, L = cfg.vocab_size, cfg.n_layers
    tr = spec_traffic(V)
    quoting, greedy, boundary = tr["quoting"], tr["greedy"], tr["boundary"]
    prefix, _, shared, _ = paged_traffic(V)
    common = dict(max_slots=SLOTS, max_seq=MAX_SEQ, device="cuda")
    spec = dict(speculative_k=SPEC_K, speculative_ngram=SPEC_NGRAM)
    paged_kw = dict(paged=True, page_size=PAGE)

    # The plain paths: every greedy reference, and traffic (a)'s ticks.
    plain = {}
    for name, kw in (("contiguous", {}), ("paged", paged_kw)):
        b = LMBackend(params, cfg, **common, **kw)
        served(b, [[1, 2, 3]], 4)
        pr = SpecProbe(b.engine, gaps=True)
        ref = {"a": served(b, quoting, QUOTE_NEW)}
        seg_a = (0, pr.mark())
        ref["b"] = served(b, greedy, NEW_TOKENS)
        ref["e"] = served(b, [boundary], QUOTE_NEW)
        if kw:
            ref["shared"] = served(b, shared, NEW_TOKENS)
        plain[name] = {"ref": ref, "probe": pr, "seg_a": seg_a,
                       "backend": b}
    for k in ("a", "b", "e"):
        if plain["paged"]["ref"][k] != plain["contiguous"]["ref"][k]:
            raise AssertionError(f"({k}) the plain paged engine's greedy "
                                 "outputs differ from the contiguous one's")
    if plain["paged"]["ref"]["shared"] != paged["want_shared"]:
        raise AssertionError("the plain paged engine's shared-prefix outputs "
                             "differ from phase 3b's")

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runs = {}
    for name, kw in (("contiguous", {}), ("paged", paged_kw)):
        b = LMBackend(params, cfg, **common, **spec, **kw)
        pr = SpecProbe(b.engine)
        out = {"a": served(b, quoting, QUOTE_NEW)}
        seg_a = (0, pr.mark())
        stats_a = b.stats()["speculative"]
        out["b"] = served(b, greedy, NEW_TOKENS)
        # (c) a sampled request beside 3 greedy ones, the batch twice.
        mix = [ServeRequest((quoting[0],), {"max_new_tokens": NEW_TOKENS,
                                            "temperature": 0.8,
                                            "seed": 42})] + [
            ServeRequest((p,), {"max_new_tokens": NEW_TOKENS})
            for p in quoting[1:4]]
        out["c"] = [b(mix), b(mix)]
        # (d) a whole response alone, then the same request streamed.
        out["d"] = [served(b, [quoting[4]], QUOTE_NEW)[0],
                    stream_all(b, quoting[4], QUOTE_NEW)]
        # (e) a request that ends at exactly max_seq.
        seg_e = pr.mark()
        out["e"] = served(b, [boundary], QUOTE_NEW)
        seg_e = (seg_e, pr.mark())
        if kw:
            # The shared-prefix traffic: its prefix pages (published by the
            # first request's prefill) must hold the same K/V bits after
            # every verify pass of the 16.
            out["shared_first"] = served(b, shared[:1], NEW_TOKENS)
            eng = b.engine
            pages = eng._cached_prefix(eng._prefix_keys(prefix),
                                       promote=False)
            if len(pages) != PREFIX // PAGE:
                raise AssertionError(f"{len(pages)} prefix pages cached, "
                                     f"expected {PREFIX // PAGE}")
            keep = (eng.k_pages[:, pages].clone(),
                    eng.v_pages[:, pages].clone())
            n_pass = len(pr.passes)
            out["shared"] = served(b, shared, NEW_TOKENS)
            same = (torch.equal(eng.k_pages[:, pages], keep[0])
                    and torch.equal(eng.v_pages[:, pages], keep[1]))
            sums = [float(t.float().abs().sum()) for t in keep]
            hit = sum(1 for i in range(n_pass, len(pr.passes))
                      if pr.passes[i][0] == "verify"
                      and sum(int(pg) in pr.tables[i][s]
                              for s in range(SLOTS)
                              for pg in pages[:1]) >= 2)
            log(f"  (shared) 16 requests on a {PREFIX}-token prefix: its "
                f"{len(pages)} pages (checksums |K| {sums[0]:.6g}, |V| "
                f"{sums[1]:.6g}) read by two or more slots in {hit} verify "
                f"passes; bits after those passes equal: {same}")
            if not same:
                raise AssertionError("a verify pass wrote a shared prefix "
                                     "page")
            if hit == 0:
                raise AssertionError("no verify pass ran with the prefix "
                                     "pages shared")
        runs[name] = {"out": out, "probe": pr, "backend": b,
                      "seg_a": seg_a, "seg_e": seg_e, "stats_a": stats_a}
    torch.cuda.synchronize()
    launches = read_counts()
    wall_s = time.perf_counter() - t0

    total = {n: 0 for n in COUNTED}
    for name, run in runs.items():
        pr, out = run["probe"], run["out"]
        got = check_spec_launches(pr, L, name == "paged")
        for n, c in got.items():
            total[n] += c
        kinds = [k for k, _ in pr.passes]
        widths = sorted({w for k, w in pr.passes if k == "verify"})
        log(f"  {name}: {len(pr.prefills)} prefills, {kinds.count('verify')} "
            f"verify passes (widths {widths}), {kinds.count('decode')} "
            f"decode passes; every verify pass {2 * L + 1} K1 (rms_norm 1, "
            f"add_rms_norm {2 * L}), 0 decode_attention, 0 "
            f"paged_decode_attention" + (
                f"; every draft-less tick {2 * L + 1} K1 and {L} "
                f"paged_decode_attention" if name == "paged" else ""))
        for k, n in (("a", QUOTE_NEW), ("b", NEW_TOKENS), ("e", QUOTE_NEW)):
            for o in out[k]:
                if len(o) != n or not all(0 <= t < V for t in o):
                    raise AssertionError(f"{name} ({k}): bad output {o}")
        if len(boundary) + len(out["e"][0]) != MAX_SEQ:
            raise AssertionError(f"{name} (e) does not end at max_seq")
        lo, hi = run["seg_e"]
        tail = [pr.passes[pr.steps[i][3]] for i in range(lo, hi)][-3:]
        log(f"  {name} (e): a {len(boundary)}-token prompt + {QUOTE_NEW} "
            f"new tokens ends at max_seq {MAX_SEQ}; its last ticks ran "
            f"{tail}")
        c1, c2 = out["c"]
        if c1 != c2 or len(c1[0]) != NEW_TOKENS:
            raise AssertionError(f"{name} (c): the batch with a seeded "
                                 f"sampled request differs between runs")
        log(f"  {name} (c): sampled (T=0.8, seed=42) beside 3 greedy, the "
            f"batch twice, equal: {c1[0][:8]}...")
        if out["d"][0] != out["d"][1]:
            raise AssertionError(f"{name} (d): stream {out['d'][1]} != whole "
                                 f"response {out['d'][0]}")
        log(f"  {name} (d): streamed request equals its whole response")
        ref = plain[name]["ref"]
        gaps = plain[name]["probe"].gaps
        flips, n_req = [], 0
        for k, prompts in (("a", quoting), ("b", greedy), ("e", [boundary]),
                           ("shared", shared)):
            if k in out:
                flips += greedy_flips(f"{name} ({k})", out[k], ref[k],
                                      prompts, gaps)
                n_req += len(prompts)
        all_gaps = np.array([g / (FLIP_ULPS * ulp_bf16(t))
                             for g, t in gaps.values()])
        log(f"  {name}: {len(flips)} of {n_req} greedy requests differ from "
            f"the plain path's (bf16; each at a near-tie within "
            f"{FLIP_ULPS} ulps); over the plain path's {len(all_gaps)} "
            f"decode tokens the top-2 gap is under that bound for "
            f"{(all_gaps < 1).mean():.1%}, median {np.median(all_gaps):.2f} "
            f"times it")
        log(f"  {name} stats()['speculative']: "
            f"{run['backend'].stats()['speculative']}; after (a) alone: "
            f"{run['stats_a']}")
        run["flips"], run["n_greedy"] = flips, n_req
    log(f"  phase 3c in {wall_s:.3f} s; launches {launches}")
    if total != launches:
        raise AssertionError(f"launches {launches} != the prefills' and "
                             f"passes' {total}")
    for n in ("rms_norm", "add_rms_norm", "paged_decode_attention"):
        if launches[n] == 0:
            raise AssertionError(f"{n} never launched in phase 3c")
    return {"launches": launches, "runs": runs, "plain": plain}


# ------------------------------------- phase 4: card vs CPU, f32, full width


class _Recorded(engine_mod._Request):
    """A greedy request that keeps the logits its prefill hands pick(), so
    phase 4 reads them through the engine's own _prefill_slot."""
    __slots__ = ("logits",)

    def pick(self, logits_row):
        self.logits = torch.from_numpy(np.array(logits_row))
        return int(np.argmax(logits_row))


def card_vs_cpu(params, engine_cls, what: str, **kw) -> float:
    log(f"phase 4: f32 at full width, card vs CPU, {what}, teacher-forced 3 "
        "prompts x 16 steps (atol 1e-3)")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    cpu_params = to_compute(params, cfg, "cpu")
    engines = [engine_cls(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cuda", **kw),
               engine_cls(cpu_params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          device="cpu", **kw)]
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, T0).tolist()
               for T0 in (17, 40, 64)]
    worst, flips, checked = 0.0, 0, 0

    def compare(gpu_logits, cpu_logits, what):
        nonlocal worst, flips, checked
        g = gpu_logits.float().cpu()
        c = cpu_logits.float()
        err = max_err(g, c)
        worst = max(worst, err)
        if not torch.isfinite(g).all() or err > 1e-3:
            raise AssertionError(f"{what}: card vs CPU max_abs_err {err}")
        top2 = torch.topk(c, 2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > 1e-3
        agree = g.argmax(-1) == c.argmax(-1)
        checked += int(decisive.sum())
        if not bool(agree[decisive].all()):
            raise AssertionError(f"{what}: greedy token differs where the "
                                 f"CPU's top-2 margin exceeds 1e-3")
        flips += int((~agree).sum())
        return c.argmax(-1)

    with torch.inference_mode():
        for slot, p in enumerate(prompts):
            reqs = [_Recorded(slot, p, 17) for _ in engines]
            for e, req in zip(engines, reqs):
                e._prefill_slot(slot, req)
            tok = int(compare(reqs[0].logits, reqs[1].logits,
                              f"prefill {slot}"))
            for e in engines:   # both follow the CPU run's tokens
                e.tokens[slot] = tok
        for step in range(16):
            logits = [e._decode_all() for e in engines]
            nxt = compare(logits[0][:3], logits[1][:3], f"decode {step}")
            for e in engines:
                e.tokens[:3] = nxt.numpy()
                e.lengths[:3] += 1
        # One speculative verify chunk (the current token and SPEC_K seeded
        # drafts) at the lengths the decode steps reached.
        drafts = rng.integers(0, cfg.vocab_size, (SLOTS, SPEC_K))
        chunk = np.concatenate([engines[1].tokens[:, None],
                                drafts.astype(np.int32)], axis=1)
        logits = [e._verify_all(chunk) for e in engines]
        compare(logits[0][:3], logits[1][:3], "verify chunk")
    log(f"  max_abs_err {worst:.3e} over 3 prefills + 16 steps + one "
        f"{SPEC_K + 1}-wide verify chunk; argmax agrees on all {checked} "
        f"decisive rows ({flips} near-ties differ)")
    return worst


def spec_f32_equal(params) -> None:
    """f32 at full width on the card: each engine's greedy tokens with
    speculation on equal its tokens with speculation off, on phase 3c's
    traffic (a) and (b) together."""
    log(f"phase 4: f32 at full width on the card, greedy tokens with "
        f"speculative_k={SPEC_K} vs 0 on traffic (a) + (b), both engines")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    tr = spec_traffic(cfg.vocab_size)
    for name, cls, kw in (
            ("contiguous", engine_mod.GenerationEngine, {}),
            ("paged", paged_mod.PagedGenerationEngine, dict(page_size=PAGE))):
        outs = []
        for k in (0, SPEC_K):
            eng = cls(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                      speculative_k=k, speculative_ngram=SPEC_NGRAM,
                      device="cuda", **kw)
            ids = ([eng.submit(p, QUOTE_NEW) for p in tr["quoting"]]
                   + [eng.submit(p, NEW_TOKENS) for p in tr["greedy"]])
            res = eng.run_until_done()
            outs.append([res[i] for i in ids])
            stats = dict(eng.spec_stats)
            del eng
            torch.cuda.empty_cache()
        diff = [i for i, (a, b) in enumerate(zip(*outs)) if a != b]
        log(f"  {name}: {len(outs[0])} greedy requests, {len(diff)} differ "
            f"(speculative run: {stats})")
        if diff:
            raise AssertionError(f"{name}: f32 speculative greedy tokens "
                                 f"differ from plain ones for requests "
                                 f"{diff}")


# ------------------------------------------------ phase 5: the train path


def train_setup():
    """The flagship in bf16 with f32 params from the seed, its AdamW state
    and one seeded batch of B x (T + 1) tokens, on the card."""
    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = init_params(cuda_gen(SEED), cfg, device="cuda")
    init_opt, train_step = make_train_step(cfg)
    rng = np.random.default_rng(SEED + 2)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1))).to("cuda")}
    return cfg, params, init_opt(params), train_step, batch


def train_per_step(L: int, ranks: int = 1) -> dict:
    """K1 (plain, residual, backward), K2 and K3-K5 launches of one train
    step of an L-layer model through transformer._decoder, per rank."""
    one = {"rms_norm": 1, "add_rms_norm": 2 * L,
           "rms_norm_backward": 2 * L + 1, "softmax_xent": 1,
           "flash_forward": L, "flash_backward_dq": L,
           "flash_backward_dkv": L}
    return {n: ranks * v for n, v in one.items()}


def train_path(card: str) -> dict:
    log(f"phase 5: training path, {TRAIN_STEPS} train steps at the flagship "
        f"config, bf16, batch {TRAIN_B}, seq {TRAIN_T}, AdamW")
    cfg, params, opt, train_step, batch = train_setup()
    V, L = cfg.vocab_size, cfg.n_layers
    per_step = train_per_step(L)
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    seen = read_counts()
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, batch)
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        now = read_counts()
        got = {n: now[n] - seen[n] for n in now}
        seen = now
        want = {n: per_step.get(n, 0) for n in now}
        if got != want:
            raise AssertionError(f"train step {step}: launches {got}, "
                                 f"expected {want}")
        log(f"  step {step}: loss {losses[-1]:.6f}, {walls[-1]:.3f} ms wall, "
            f"launches {got}")
    launches = read_counts()
    ln_v = math.log(V)
    if not (math.isfinite(losses[0]) and abs(losses[0] - ln_v) < 1.0):
        raise AssertionError(f"step-0 loss {losses[0]} is not within 1.0 "
                             f"of ln({V}) = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    step_ms = float(np.median(walls))
    tokens = TRAIN_B * TRAIN_T
    log(f"  losses {losses} (ln {V} = {ln_v:.4f}); launches over the run "
        f"{launches}")
    log(f"  train step: median {step_ms:.3f} ms wall over {TRAIN_STEPS} "
        f"steps (first {walls[0]:.3f} ms), {tokens / step_ms * 1e3:.1f} "
        f"tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "walls": walls}


# ------------------------------ phase 6: train step, card vs CPU, f32


def train_card_vs_cpu() -> dict:
    """One f32 train step at full width and depth (batch 1, seq 256) from
    the same weights on the card and on the CPU. Tolerances: the loss
    within 1e-4; each gradient within 1e-3 of its own largest magnitude
    (cuBLAS and the CPU's BLAS sum in other orders, as do the kernels and
    their plain versions, and the differences compound through 8 layers
    and back); the loss after the first update within 1e-3 (AdamW divides
    by sqrt(v), so entries whose gradient is near 0 move by a visible
    fraction of the learning rate when it rounds differently)."""
    log("phase 6: one f32 train step at full width, batch 1, seq 256, card "
        "vs CPU")
    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    cpu = init_params(torch.Generator().manual_seed(SEED + 3), cfg,
                      device="cpu")
    gpu = to_compute(cpu, cfg, "cuda")
    tokens = np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (1, 257))
    init_opt, train_step = make_train_step(cfg)
    runs = []
    for params in (gpu, cpu):
        opt = init_opt(params)
        batch = {"tokens": torch.from_numpy(tokens)}
        t0 = time.perf_counter()
        _, _, loss0 = train_step(params, opt, batch)
        grads = {name: t.grad.float().cpu()
                 for name, t in named_leaves(params).items()}
        _, _, loss1 = train_step(params, opt, batch)
        runs.append((loss0.item(), grads, loss1.item(),
                     time.perf_counter() - t0))
    (g0, ggrads, g1, gs), (c0, cgrads, c1, cs) = runs
    worst = 0.0
    for name, want in cgrads.items():
        got = ggrads[name]
        scale = want.abs().max().item()
        err = max_err(got, want)
        if not torch.isfinite(got).all() or err > 1e-3 * scale:
            raise AssertionError(f"grad {name}: card vs CPU max_abs_err "
                                 f"{err} above 1e-3 x {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    if abs(g0 - c0) > 1e-4 or not math.isfinite(g0):
        raise AssertionError(f"loss card {g0} vs CPU {c0}")
    if abs(g1 - c1) > 1e-3 or not math.isfinite(g1):
        raise AssertionError(f"loss after a step: card {g1} vs CPU {c1}")
    log(f"  loss card {g0:.7f} CPU {c0:.7f} (diff {abs(g0 - c0):.2e}); "
        f"every gradient within {worst:.2e} of its largest magnitude; "
        f"after one update card {g1:.7f} CPU {c1:.7f} (diff "
        f"{abs(g1 - c1):.2e}); two steps {gs:.1f} s on the card, {cs:.1f} "
        f"s on the CPU")
    return {"loss_diff": abs(g0 - c0), "grad_rel_err": worst,
            "loss1_diff": abs(g1 - c1)}


# ----------------------------------------------------- phase 7: timings


def timings(main: dict, card: str) -> dict:
    log(f"phase 7: timings on {card}")
    probe = main["probe"]
    out = {}
    by_bucket = {}
    for bucket, ms in probe.prefills:
        by_bucket.setdefault(bucket, []).append(ms)
    for bucket in sorted(by_bucket):
        log(f"  prefill bucket {bucket}: median "
            f"{np.median(by_bucket[bucket]):.3f} ms over "
            f"{len(by_bucket[bucket])} prefills [{card}]")
    full = [ms for active, ms in probe.ticks if active == SLOTS]
    tick_ms = float(np.median(full))
    log(f"  decode tick at {SLOTS} active slots: median {tick_ms:.3f} ms "
        f"over {len(full)} ticks, {SLOTS / tick_ms * 1e3:.1f} tokens/s "
        f"[{card}]")
    # The same tick's device time, its ~400 launches queued back to back
    # behind a ~1 s sleep: the gap to the wall time is the card's idle
    # share, time the host spends issuing eager PyTorch ops.
    eng = main["backend"].engine
    mid = [lens for active, lens in probe.tick_lengths if active == SLOTS]
    args = (eng.params, eng._device_ints(eng.tokens),
            eng._device_ints(mid[len(mid) // 2]), eng.cache_k, eng.cache_v,
            eng.cfg)
    with torch.inference_mode():
        dev_ms = min(device_ms("decode tick", engine_mod._batched_decode,
                               [args], 2, sleep_cycles=2_000_000_000)
                     for _ in range(3))
    log(f"  decode tick device time {dev_ms:.3f} ms back to back vs "
        f"{tick_ms:.3f} ms wall: card busy {dev_ms / tick_ms:.1%}, idle "
        f"{1 - dev_ms / tick_ms:.1%} of the tick [{card}]")

    E = FLAGSHIP["d_model"]
    bf16 = torch.bfloat16
    # K1 at the decode shape: 8 rows of d_model, bf16 (the path's most
    # frequent launch).
    rows = SLOTS
    sets = [rms_inputs(rows, bf16, seed=100 + i)
            for i in range(n_copies(2 * rows * E * 2))]
    k1_bytes = (2 * rows * E + E) * 2
    k1_ops = 4 * rows * E
    lib_rms = getattr(torch.nn.functional, "rms_norm", None)
    out["rms_norm"] = dict(
        ms=device_ms("rms_norm kernel",
                     lambda x, w: fused.rms_norm(x, w, EPS), sets, 200),
        plain_ms=device_ms("rms_norm plain",
                           lambda x, w: fused._rms_norm_ref(x, w, EPS), sets,
                           100),
        library_ms=(device_ms("F.rms_norm",
                              lambda x, w: lib_rms(x, (E,), w, EPS), sets,
                              200) if lib_rms is not None else None),
        **bound(k1_bytes, k1_ops, bf16),
        shape=f"[{rows}, {E}] bf16")

    out.update(k1_residual_timings(card))

    # K6 at the flagship decode shape with the lengths of a median
    # full-slot tick of this run.
    full_lens = [lens for active, lens in probe.tick_lengths
                 if active == SLOTS]
    lens = full_lens[len(full_lens) // 2]
    B, H, KH, D, S = SLOTS, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"], \
        E // FLAGSHIP["n_heads"], MAX_SEQ
    live = int((lens.astype(np.int64) + 1).sum())
    k6_bytes = 2 * live * KH * D * 2 + 2 * B * H * D * 2 + 4 * B
    k6_ops = 4 * live * H * D
    sets = []
    for i in range(n_copies(2 * live * KH * D * 2)):
        q, k, v, ln = decode_inputs(B, H, KH, D, S, lens.tolist(), bf16,
                                    seed=200 + i)
        mask = (torch.arange(S, device="cuda")[None, :]
                <= ln[:, None].long())[:, None, None, :]
        sets.append((q, k, v, ln, mask))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["decode_attention"] = dict(
        ms=device_ms("decode_attention kernel", lambda q, k, v, ln, m:
                     attention.decode_attention(q, k, v, ln), sets,
                     200),
        # Fewer calls: each is ~20 launches, and every launch has to fit in
        # the queue behind the sleep for the time to be the device's.
        plain_ms=device_ms("decode_attention plain", lambda q, k, v, ln, m:
                           attention._decode_attention_ref(q, k, v, ln),
                           sets, 40),
        library_ms=device_ms("SDPA", lambda q, k, v, ln, m: sdpa(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=m), sets, 100),
        **bound(k6_bytes, k6_ops, bf16), lens=lens.tolist(),
        shape=f"B={B} H={H} KH={KH} D={D} S={S} bf16, lengths "
              f"{lens.tolist()}, {attention.decode_splits(B * KH)} splits")
    for name, t in out.items():
        lib = ("n/a" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.2f} us")
        log(f"  {name} at {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    # The prefill shape of K1, for the record.
    sets = [rms_inputs(64, bf16, seed=300 + i)
            for i in range(n_copies(2 * 64 * E * 2))]
    prefill_ms = device_ms("rms_norm kernel [64]",
                           lambda x, w: fused.rms_norm(x, w, EPS), sets, 200)
    log(f"  rms_norm at [64, {E}] bf16: kernel {prefill_ms * 1e3:.2f} us "
        f"[{card}]")
    return out


def host_us(fns: dict, calls: int = 1000, rounds: int = 5) -> dict:
    """Host µs per call of each fn(): calls queued back to back on the CPU
    clock, with no synchronize between them (the launches run behind), in
    rounds that take the fns in turn; the median over rounds of each, so a
    noisy neighbour on the host's cores does not decide a comparison."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def k1_residual_timings(card: str) -> dict:
    """K1's residual form (add_rms_norm) at a decode tick's 8 rows and the
    train step's B*T, against its plain version and against x + a then
    F.rms_norm (two PyTorch calls: no one call computes it, so the
    {"kernels": [...]} line has no library time for it); then, at the
    decode shape under torch.inference_mode as the engines run, the host
    µs per call of rms_norm, add_rms_norm and that pair. The line takes
    the decode shape."""
    E = FLAGSHIP["d_model"]
    bf16 = torch.bfloat16
    lib_rms = torch.nn.functional.rms_norm
    out = {}
    for rows, iters in ((SLOTS, 200), (TRAIN_B * TRAIN_T, 50)):
        sets = [rms_inputs(rows, bf16, seed=110 + i)
                + rms_inputs(rows, bf16, seed=150 + i)[:1]
                for i in range(n_copies(4 * rows * E * 2))]
        t = dict(
            ms=device_ms("add_rms_norm kernel", lambda x, w, a:
                         fused.add_rms_norm(x, a, w, EPS), sets, iters),
            plain_ms=device_ms("add_rms_norm plain", lambda x, w, a:
                               fused._add_rms_norm_ref(x, a, w, EPS), sets,
                               iters // 2),
            pair_ms=device_ms("x + a, F.rms_norm", lambda x, w, a:
                              lib_rms(x + a, (E,), w, EPS), sets, iters),
            unfused_ms=device_ms("x + a, rms_norm kernel", lambda x, w, a:
                                 fused.rms_norm(x + a, w, EPS), sets, iters),
            library_ms=None, **bound((4 * rows * E + E) * 2, 5 * rows * E,
                                     bf16),
            shape=f"[{rows}, {E}] bf16")
        log(f"  add_rms_norm at {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, x + a then F.rms_norm "
            f"{t['pair_ms'] * 1e3:.2f} us, x + a then the rms_norm kernel "
            f"{t['unfused_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
        if rows == SLOTS:
            out["add_rms_norm"] = t
            x, w, a = sets[0]
            with torch.inference_mode():
                hosts = host_us({
                    "rms_norm": lambda: fused.rms_norm(x, w, EPS),
                    "F.rms_norm": lambda: lib_rms(x, (E,), w, EPS),
                    "add_rms_norm": lambda: fused.add_rms_norm(x, a, w, EPS),
                    "x + a then F.rms_norm": lambda: lib_rms(x + a, (E,), w,
                                                             EPS),
                })
            log("  host us per call at [8, 1024] bf16, 1000 calls queued, "
                "median of 5 rounds in turn, inference mode: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in hosts.items()) + f" [{card}]")
        del sets
    return out


def paged_timings(paged: dict, short_lens: list, card: str) -> dict:
    """The paged decode tick against the contiguous one (wall and device
    time at 8 active slots, on the same lengths), and K7 and K6 at the
    flagship decode shape, at the short lengths of a median contiguous
    tick (short_lens), at ~600 and at ~2000 rows: each beside its bound,
    its plain version, the number of splits, and the library on the same
    rows (K7: the gather + SDPA; K6: SDPA on the contiguous cache with a
    length mask). The {"kernels": [...]} line takes K7 at ~600 rows."""
    log(f"phase 7: paged timings on {card}")
    probe, contig = paged["probe"], paged["contig"]
    eng = paged["backend"].engine
    walls = {}
    for name, pr in (("paged", probe), ("contiguous", paged["contig_probe"])):
        full = [ms for active, ms in pr.ticks if active == SLOTS]
        walls[name] = float(np.median(full))
        log(f"  {name} decode tick at {SLOTS} active slots, the 16 "
            f"shared-prefix requests: median {walls[name]:.3f} ms wall over "
            f"{len(full)} ticks [{card}]")
    full = [i for i, (active, _) in enumerate(probe.ticks) if active == SLOTS]
    mid = full[len(full) // 2]
    lens = probe.tick_lengths[mid][1]
    tokens = eng._device_ints(eng.tokens)
    lengths = eng._device_ints(lens)
    runs = {
        "paged": (paged_mod._paged_decode, (
            eng.params, tokens, lengths,
            eng._device_ints(probe.tables[mid]), eng.k_pages, eng.v_pages,
            eng.cfg)),
        "contiguous": (engine_mod._batched_decode, (
            contig.params, tokens, lengths, contig.cache_k, contig.cache_v,
            contig.cfg)),
    }
    with torch.inference_mode():
        for name, (fn, args) in runs.items():
            dev = min(device_ms(f"{name} decode tick", fn, [args], 2,
                                sleep_cycles=2_000_000_000)
                      for _ in range(3))
            log(f"  {name} decode tick device time {dev:.3f} ms back to "
                f"back at lengths {lens.tolist()} vs {walls[name]:.3f} ms "
                f"wall: card busy {dev / walls[name]:.1%} [{card}]")

    bf16 = torch.bfloat16
    B, H, KH = SLOTS, FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    D = FLAGSHIP["d_model"] // H
    P = MAX_SEQ // PAGE
    n_split = attention.decode_splits(B * KH)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for tag, lens in (("short", list(short_lens)),
                      ("~600", [600 + i for i in range(B)]),
                      ("~2000", [2000 + i for i in range(B)])):
        live = sum(L + 1 for L in lens)
        pages = sum(-(-(L + 1) // PAGE) for L in lens)
        kv_bytes = 2 * live * KH * D * 2 + 2 * B * H * D * 2 + 4 * B
        sets = []
        for i in range(n_copies(2 * live * KH * D * 2)):
            q, kp, vp, table, ln = paged_inputs(B + 1, H, KH, D, PAGE, P,
                                                lens + [0], bf16,
                                                seed=700 + i)
            q, table, ln = q[:B].contiguous(), table[:B], ln[:B]
            kc = paged_attention.paged_gather(kp, table).contiguous()
            vc = paged_attention.paged_gather(vp, table).contiguous()
            mask = (torch.arange(P * PAGE, device="cuda")[None, :]
                    <= ln[:, None].long())[:, None, None, :]
            sets.append((q, kp, vp, table, ln, kc, vc, mask))

        def library(q, kp, vp, table, ln, kc, vc, mask):
            k = paged_attention.paged_gather(kp, table).transpose(1, 2)
            v = paged_attention.paged_gather(vp, table).transpose(1, 2)
            return sdpa(q[:, :, None], k, v, attn_mask=mask)

        t = dict(
            ms=device_ms("paged_decode_attention kernel", lambda *a:
                         paged_attention.paged_decode_attention(*a[:5]),
                         sets, 200),
            plain_ms=device_ms("paged_decode_attention plain", lambda *a:
                               paged_attention._paged_decode_ref(*a[:5]),
                               sets, 40),
            library_ms=device_ms("paged_gather + SDPA", library, sets, 60),
            k6_ms=device_ms("decode_attention on the same rows", lambda *a:
                            attention.decode_attention(a[0], a[5], a[6],
                                                       a[4]), sets, 200),
            k6_library_ms=device_ms(
                "SDPA on the same rows", lambda q, kp, vp, table, ln, kc, vc,
                mask: sdpa(q[:, :, None], kc.transpose(1, 2),
                           vc.transpose(1, 2), attn_mask=mask), sets, 100),
            k6_bound_ms=bound(kv_bytes, 4 * live * H * D, bf16)["bound_ms"],
            **bound(kv_bytes + 4 * pages, 4 * live * H * D, bf16),
            shape=f"B={B} H={H} KH={KH} D={D} ps={PAGE} P={P} bf16, "
                  f"lengths {lens[0]}-{lens[-1]} ({tag}), {n_split} splits")
        log(f"  paged_decode_attention at {t['shape']}: kernel "
            f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
            f"paged_gather + SDPA {t['library_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
        log(f"  decode_attention on the same rows laid out contiguously "
            f"({tag}): kernel {t['k6_ms'] * 1e3:.2f} us, SDPA with a length "
            f"mask {t['k6_library_ms'] * 1e3:.2f} us, bound "
            f"{t['k6_bound_ms'] * 1e3:.3f} us (bytes) [{card}]")
        if tag == "~600":
            out["paged_decode_attention"] = t
        del sets
        torch.cuda.empty_cache()
    return out


def spec_timings(spec: dict, card: str) -> None:
    """Traffic (a) at 8 slots, speculation on against off, each engine:
    decode tokens/s (tokens the ticks emitted over the ticks' wall, step()
    less its prefills), tokens per tick and per slot-tick, the acceptance
    rate, and the device time of one verify tick of full width at 8 active
    slots (its median-wall one, replayed behind a sleep) beside its wall,
    and the plain tick's at the same lengths."""
    log(f"phase 7: speculative timings on {card}, traffic (a): {SLOTS} "
        f"quoting requests x {QUOTE_NEW} tokens")
    for name in ("contiguous", "paged"):
        run, ref = spec["runs"][name], spec["plain"][name]
        rows = {}
        for label, r in (("plain", ref), ("speculative", run)):
            lo, hi = r["seg_a"]
            steps = r["probe"].steps[lo:hi]
            wall = sum(st[1] for st in steps)
            toks = sum(st[2] for st in steps)
            full = [st[1] for st in steps if st[0] == SLOTS]
            rows[label] = dict(ticks=len(steps), tokens=toks, wall_ms=wall,
                               median_ms=float(np.median(full)))
            log(f"  {name} {label}: {toks} tokens in {len(steps)} ticks, "
                f"{wall:.3f} ms of tick wall: {toks / wall * 1e3:.1f} decode "
                f"tokens/s, {toks / len(steps):.3f} tokens a tick, "
                f"{sum(st[2] / st[0] for st in steps) / len(steps):.3f} a "
                f"slot-tick; median tick at {SLOTS} active "
                f"{rows[label]['median_ms']:.3f} ms [{card}]")
        st = run["stats_a"]
        log(f"  {name}: acceptance rate {st['accepted']} / {st['drafted']} = "
            f"{st['accepted'] / max(st['drafted'], 1):.4f}, {st['emitted']} "
            f"tokens emitted by greedy slots in {st['ticks']} ticks [{card}]")
        pr = run["probe"]
        lo, hi = run["seg_a"]
        cands = sorted((s for s in pr.steps[lo:hi] if s[0] == SLOTS
                        and pr.passes[s[3]] == ("verify", SPEC_K + 1)),
                       key=lambda s: s[1])
        if not cands:
            raise AssertionError(f"{name}: no verify tick of width "
                                 f"{SPEC_K + 1} at {SLOTS} active slots")
        _, v_wall, v_toks, i = cands[len(cands) // 2]
        eng = run["backend"].engine
        chunk, lens = pr.chunks[i], pr.tick_lengths[i][1]
        ints = eng._device_ints
        tokens = ints(np.ascontiguousarray(chunk[:, 0]))
        if name == "contiguous":
            verify = (speculative._batched_verify, (
                eng.params, ints(chunk), ints(lens), eng.cache_k,
                eng.cache_v, eng.cfg))
            plain = (engine_mod._batched_decode, (
                eng.params, tokens, ints(lens), eng.cache_k, eng.cache_v,
                eng.cfg))
        else:
            tables = ints(pr.tables[i])
            verify = (paged_mod._paged_verify, (
                eng.params, ints(chunk), ints(lens), tables, eng.k_pages,
                eng.v_pages, eng.cfg))
            plain = (paged_mod._paged_decode, (
                eng.params, tokens, ints(lens), tables, eng.k_pages,
                eng.v_pages, eng.cfg))
        # One tick queued behind the sleep: a verify tick's ~530 launches
        # twice over do not fit in the launch queue, and the host would
        # then wait for the sleep to end.
        with torch.inference_mode():
            dev = {what: min(device_ms(f"{name} {what} tick", fn, [args], 1,
                                       sleep_cycles=2_000_000_000)
                             for _ in range(3))
                   for what, (fn, args) in (("verify", verify),
                                            ("plain", plain))}
        p_wall = rows["plain"]["median_ms"]
        log(f"  {name} verify tick ({SPEC_K + 1} wide, {SLOTS} slots, "
            f"lengths {lens.min()}-{lens.max()}, {v_toks} tokens): device "
            f"{dev['verify']:.3f} ms back to back vs {v_wall:.3f} ms wall, "
            f"card busy {dev['verify'] / v_wall:.1%}; plain tick at the same "
            f"lengths: device {dev['plain']:.3f} ms vs {p_wall:.3f} ms median "
            f"wall, busy {dev['plain'] / p_wall:.1%} [{card}]")
        for what, (fn, args) in (("verify", verify), ("plain", plain)):
            tick_profile(f"{name} {what} tick", fn, args, card)


def tick_profile(what: str, fn, args, card: str) -> None:
    """One call under torch.profiler: its device events and their summed
    time, the kernels that take the most, and the PyTorch ops whose
    kernels do (an op's device time includes the ops inside it)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in avg
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in kern)
    if total == 0:
        log(f"  {what}: torch.profiler recorded no device time")
        return
    log(f"  {what} under torch.profiler: {total:.3f} ms of device time in "
        f"{sum(r[2] for r in kern)} device events [{card}]")
    for name, ms, count in kern[:4]:
        log(f"    {ms:8.3f} ms x{count:<4d} {name[:72]}")
    ops = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in avg
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")), key=lambda r: -r[1])
    log("    ops: " + ", ".join(f"{k} {ms:.3f} ms x{c}"
                                for k, ms, c in ops[:6]))


def train_timings(card: str) -> dict:
    """K2-K5 at the training path's shapes: the kernel, its plain version
    and the PyTorch call that computes the same function."""
    out = {}
    f32, bf16 = torch.float32, torch.bfloat16
    N, V, E = TRAIN_B * TRAIN_T, FLAGSHIP["vocab_size"], FLAGSHIP["d_model"]
    sets = [xent_inputs(N, V, f32, seed=400)]
    out["softmax_xent"] = dict(
        ms=device_ms("softmax_xent kernel", fused.softmax_cross_entropy,
                     sets, 20),
        plain_ms=device_ms("softmax_xent plain", fused._xent_ref, sets, 5),
        library_ms=device_ms("F.cross_entropy", lambda x, y:
                             torch.nn.functional.cross_entropy(
                                 x, y, reduction="none"), sets, 20),
        **bound(N * V * 4 + N * 8 + N * 4, 4 * N * V, f32),
        shape=f"[{N}, {V}] f32 logits, int64 labels")
    del sets

    B, T = TRAIN_B, TRAIN_T
    H, KH = FLAGSHIP["n_heads"], FLAGSHIP["n_kv_heads"]
    D = E // H
    sdpa = torch.nn.functional.scaled_dot_product_attention
    one = B * T * H * D * 2                  # bytes of one q-shaped tensor
    kv = B * T * KH * D * 2
    stat = B * H * T * 4                     # bytes of lse or dsum
    mm = 2 * B * H * D * (T * (T + 1) // 2)  # one causal product's flops
    fsets = []
    for i in range(n_copies(2 * one + 2 * kv)):
        q, k, v, do = flash_inputs(B, T, H, KH, D, bf16, seed=500 + i)
        o, lse = attention.flash_forward(q, k, v, True)
        dsum = attention._flash_dsum(o, do)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True)
        fsets.append((q, k, v, do, lse, dsum, qt, kt, vt, ot,
                      do.transpose(1, 2)))
    lib_bwd = device_ms("SDPA backward", lambda *a: torch.autograd.grad(
        a[9], (a[6], a[7], a[8]), a[10], retain_graph=True), fsets, 10)
    shape = f"B={B} T=S={T} H={H} KH={KH} D={D} causal bf16"
    out["flash_forward"] = dict(
        ms=device_ms("flash_forward kernel", lambda *a:
                     attention.flash_forward(*a[:3], True), fsets, 10),
        plain_ms=device_ms("flash_forward plain", lambda *a:
                           attention._flash_forward_ref(*a[:3], True),
                           fsets, 3),
        library_ms=device_ms("SDPA forward", lambda *a: sdpa(
            *a[6:9], is_causal=True), fsets, 20),
        **bound(2 * one + 2 * kv + stat, 2 * mm, bf16), shape=shape)
    out["flash_backward_dq"] = dict(
        ms=device_ms("flash_backward_dq kernel", lambda *a:
                     attention.flash_backward_dq(*a[:6], True), fsets, 10),
        plain_ms=device_ms("flash_backward_dq plain", lambda *a:
                           attention._flash_backward_dq_ref(*a[:6], True),
                           fsets, 3),
        library_ms=lib_bwd,
        **bound(3 * one + 2 * kv + 2 * stat, 3 * mm, bf16), shape=shape)
    out["flash_backward_dkv"] = dict(
        ms=device_ms("flash_backward_dkv kernel", lambda *a:
                     attention.flash_backward_dkv(*a[:6], True), fsets, 10),
        plain_ms=device_ms("flash_backward_dkv plain", lambda *a:
                           attention._flash_backward_dkv_ref(*a[:6], True),
                           fsets, 3),
        library_ms=lib_bwd,
        **bound(2 * one + 4 * kv + 2 * stat, 4 * mm, bf16), shape=shape)
    del fsets
    torch.cuda.empty_cache()
    for name in ("softmax_xent", "flash_forward", "flash_backward_dq",
                 "flash_backward_dkv"):
        t = out[name]
        log(f"  {name} at {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
            f"plain {t['plain_ms'] * 1e3:.2f} us, library "
            f"{t['library_ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    log("  (the library time of both backward kernels is one SDPA backward, "
        "which computes dq, dk and dv together)")
    k3 = out["flash_forward"]
    log(f"  flash_forward bf16 (tensor cores) at {shape}: "
        f"{2 * mm / k3['ms'] / 1e9:.1f} TFLOP/s, SDPA's forward "
        f"{2 * mm / k3['library_ms'] / 1e9:.1f} TFLOP/s; kernel / SDPA "
        f"{k3['ms'] / k3['library_ms']:.3f}, kernel / bound "
        f"{k3['ms'] / k3['bound_ms']:.3f} [{card}]")
    k4, k5 = out["flash_backward_dq"], out["flash_backward_dkv"]
    log(f"  flash_backward_dq bf16 (tensor cores) at {shape}: "
        f"{3 * mm / k4['ms'] / 1e9:.1f} TFLOP/s, kernel / bound "
        f"{k4['ms'] / k4['bound_ms']:.3f}; flash_backward_dkv "
        f"{4 * mm / k5['ms'] / 1e9:.1f} TFLOP/s, kernel / bound "
        f"{k5['ms'] / k5['bound_ms']:.3f} [{card}]")
    log(f"  K4 + K5 {(k4['ms'] + k5['ms']) * 1e3:.2f} us (bounds "
        f"{(k4['bound_ms'] + k5['bound_ms']) * 1e3:.3f} us) vs SDPA's "
        f"backward {lib_bwd * 1e3:.2f} us "
        f"({7 * mm / lib_bwd / 1e9:.1f} TFLOP/s for its dq, dk, dv): "
        f"K4 + K5 / SDPA {(k4['ms'] + k5['ms']) / lib_bwd:.3f} [{card}]")
    # The f32 routes (FMA loops, no TF32) of K3-K5 at the same shape, and
    # K3-K5 at a GQA shape beside SDPA on k/v repeated to every query head.
    q, k, v, do = flash_inputs(B, T, H, KH, D, f32, seed=510)
    o, lse = attention.flash_forward(q, k, v, True)
    f32_set = [(q, k, v, do, lse, attention._flash_dsum(o, do))]
    f32_ms = device_ms("flash_forward kernel f32", lambda *a:
                       attention.flash_forward(*a[:3], True), f32_set, 3)
    f32_dq = device_ms("flash_backward_dq kernel f32", lambda *a:
                       attention.flash_backward_dq(*a, True), f32_set, 3)
    f32_dkv = device_ms("flash_backward_dkv kernel f32", lambda *a:
                        attention.flash_backward_dkv(*a, True), f32_set, 3)
    log(f"  f32 (FMA loops) at B={B} T=S={T} H={H} KH={KH} D={D} causal: "
        f"flash_forward {f32_ms * 1e3:.2f} us "
        f"({2 * mm / f32_ms / 1e9:.1f} TFLOP/s), flash_backward_dq "
        f"{f32_dq * 1e3:.2f} us, flash_backward_dkv {f32_dkv * 1e3:.2f} us "
        f"[{card}]")
    del q, k, v, do, o, lse, f32_set
    Bg, Tg, Hg, KHg, Dg = 2, 1024, 32, 4, 128
    mm_g = 2 * Bg * Hg * Dg * (Tg * (Tg + 1) // 2)
    one_g, kv_g = Bg * Tg * Hg * Dg * 2, Bg * Tg * KHg * Dg * 2
    stat_g = Bg * Hg * Tg * 4
    gsets = []
    for i in range(4):
        q, k, v, do = flash_inputs(Bg, Tg, Hg, KHg, Dg, bf16, seed=520 + i)
        o, lse = attention.flash_forward(q, k, v, True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (
            q, attention._repeat_kv(k, Hg), attention._repeat_kv(v, Hg)))
        gsets.append((q, k, v, do, lse, attention._flash_dsum(o, do), qt,
                      kt, vt, sdpa(qt, kt, vt, is_causal=True),
                      do.transpose(1, 2)))
    g_ms = device_ms("flash_forward kernel gqa", lambda *a:
                     attention.flash_forward(*a[:3], True), gsets, 20)
    g_lib = device_ms("SDPA forward gqa", lambda *a: sdpa(
        *a[6:9], is_causal=True), gsets, 20)
    b_fwd = bound(2 * one_g + 2 * kv_g + stat_g, 2 * mm_g, bf16)
    log(f"  flash_forward bf16 at B={Bg} T=S={Tg} H={Hg} KH={KHg} D={Dg} "
        f"causal: kernel {g_ms * 1e3:.2f} us "
        f"({2 * mm_g / g_ms / 1e9:.1f} TFLOP/s), SDPA forward on repeated "
        f"k/v {g_lib * 1e3:.2f} us, bound {b_fwd['bound_ms'] * 1e3:.3f} us "
        f"[{card}]")
    g_dq = device_ms("flash_backward_dq kernel gqa", lambda *a:
                     attention.flash_backward_dq(*a[:6], True), gsets, 20)
    g_dkv = device_ms("flash_backward_dkv kernel gqa", lambda *a:
                      attention.flash_backward_dkv(*a[:6], True), gsets, 20)
    g_bwd = device_ms("SDPA backward gqa", lambda *a: torch.autograd.grad(
        a[9], (a[6], a[7], a[8]), a[10], retain_graph=True), gsets, 10)
    b_dq = bound(3 * one_g + 2 * kv_g + 2 * stat_g, 3 * mm_g, bf16)
    b_dkv = bound(2 * one_g + 4 * kv_g + 2 * stat_g, 4 * mm_g, bf16)
    log(f"  at the same GQA shape: flash_backward_dq {g_dq * 1e3:.2f} us "
        f"({3 * mm_g / g_dq / 1e9:.1f} TFLOP/s, bound "
        f"{b_dq['bound_ms'] * 1e3:.3f} us), flash_backward_dkv "
        f"{g_dkv * 1e3:.2f} us ({4 * mm_g / g_dkv / 1e9:.1f} TFLOP/s, "
        f"bound {b_dkv['bound_ms'] * 1e3:.3f} us); SDPA backward on "
        f"repeated k/v {g_bwd * 1e3:.2f} us: K4 + K5 / SDPA "
        f"{(g_dq + g_dkv) / g_bwd:.3f} [{card}]")
    del gsets
    torch.cuda.empty_cache()
    # K1 at the training shape, for the record.
    sets = [rms_inputs(N, bf16, seed=600)]
    k1_ms = device_ms("rms_norm kernel [train]",
                      lambda x, w: fused.rms_norm(x, w, EPS), sets, 50)
    log(f"  rms_norm at [{N}, {E}] bf16: kernel {k1_ms * 1e3:.2f} us, bound "
        f"{bound((2 * N * E + E) * 2, 4 * N * E, bf16)['bound_ms'] * 1e3:.3f}"
        f" us [{card}]")
    out["rms_norm_backward"] = k1_backward_timings(card)
    return out


def k1_backward_timings(card: str) -> dict:
    """K1's backward at the train step's [B*T, d_model] bf16, with the
    residual's gradient g_h (16 of a step's 17 calls) and without; against
    the plain backward plus the add that autograd did, and against
    torch.autograd.grad through F.rms_norm (no g_h: its graph retained,
    its forward outside the clock)."""
    N, E = TRAIN_B * TRAIN_T, FLAGSHIP["d_model"]
    bf16 = torch.bfloat16
    h, w = rms_inputs(N, bf16, seed=610)
    gy, gh = rms_inputs(N, bf16, seed=611)[0], rms_inputs(N, bf16, seed=612)[0]
    hl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
    yl = torch.nn.functional.rms_norm(hl, (E,), wl, EPS)
    sets = [(h, w, gy, gh)]

    def plain(h, w, gy, gh):
        dx, dw = fused._rms_norm_bwd(h, w, gy, EPS)
        return dx + gh, dw

    t = dict(
        ms=device_ms("rms_norm_backward kernel", lambda h, w, gy, gh:
                     fused._rms_norm_bwd_cuda(h, w, gy, gh, EPS), sets, 50),
        no_gh_ms=device_ms("rms_norm_backward kernel, no g_h",
                           lambda h, w, gy, gh: fused._rms_norm_bwd_cuda(
                               h, w, gy, None, EPS), sets, 50),
        plain_ms=device_ms("rms_norm_backward plain", plain, sets, 10),
        library_ms=device_ms("autograd.grad through F.rms_norm",
                             lambda h, w, gy, gh: torch.autograd.grad(
                                 yl, (hl, wl), gy, retain_graph=True),
                             sets, 20),
        **bound((4 * N * E + 2 * E) * 2, 10 * N * E, bf16),
        shape=f"[{N}, {E}] bf16, with g_h")
    log(f"  rms_norm_backward at [{N}, {E}] bf16: kernel "
        f"{t['ms'] * 1e3:.2f} us with g_h, {t['no_gh_ms'] * 1e3:.2f} us "
        f"without; plain backward + add {t['plain_ms'] * 1e3:.2f} us; "
        f"autograd.grad through F.rms_norm {t['library_ms'] * 1e3:.2f} us; "
        f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    return t


def train_breakdown(card: str, step_ms: float) -> None:
    """Where a flagship train step's device time goes: one step queued
    behind a sleep (device time back to back, against the median wall of
    phase 5) and one step under torch.profiler, its kernels summed by
    name."""
    _, params, opt, train_step, batch = train_setup()
    dev_ms = device_ms("train step", lambda: train_step(params, opt, batch),
                       [()], 2, sleep_cycles=2_000_000_000)
    log(f"  train step device time {dev_ms:.3f} ms back to back vs "
        f"{step_ms:.3f} ms wall: card busy {dev_ms / step_ms:.1%} "
        f"[{card}]")
    profile_breakdown("train step", lambda: train_step(params, opt, batch),
                      card)


# Kernel families of a train step's device time, by a piece of their names.
STEP_GROUPS = {"flash attention K3-K5": ("flash_",),
               "RMSNorm K1 (forward, residual form, backward)":
                   ("rms_norm",),
               "cross-entropy K2": ("xent_kernel",),
               "cuBLAS matmuls": ("nvjet", "gemm", "sm90_", "cutlass"),
               "memcpy, memset": ("Memcpy", "Memset")}


def profile_breakdown(what: str, fn, card: str, groups=None,
                      ops: int = 0) -> None:
    """One call of fn() under torch.profiler, its device time summed by
    kernel family (``groups``, default STEP_GROUPS) and its largest
    kernels; with ``ops``, also the ``ops`` aten ops whose own launches
    took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    groups = groups or STEP_GROUPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: a CPU range (an aten op, an autograd node)
    # also reports the device time of the kernels it launched, and so does
    # a user annotation on the device's timeline (the optimizer's
    # "Optimizer.step#AdamW.step"), which would count them twice.
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith(("Optimizer.", "ProfilerStep#"))),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if total == 0:
        log("  torch.profiler recorded no device time: kernel breakdown "
            "not measured")
        return
    by_group = dict.fromkeys([*groups, "other PyTorch kernels"], 0.0)
    for name, ms, _ in rows:
        hit = [g for g, keys in groups.items()
               if any(k in name for k in keys)]
        by_group[hit[0] if hit else "other PyTorch kernels"] += ms
    log(f"  torch.profiler, one {what}: {total:.3f} ms of device time "
        f"in {sum(r[2] for r in rows)} device events [{card}]")
    for group, ms in by_group.items():
        log(f"    {ms:9.3f} ms {ms / total:6.1%}  {group}")
    for tag, key in (("K3 forward", "flash_fwd"), ("K4 dq", "flash_dq"),
                     ("K5 dk/dv", "flash_dkv")):
        ms = sum(r[1] for r in rows if key in r[0])
        log(f"    {ms:9.3f} ms {ms / total:6.1%}    of which {tag}")
    # The device time under K1's autograd nodes (their forwards and
    # backwards, as torch.profiler records them).
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and "RMSNorm" in e.key and e.device_time_total > 0):
            log(f"    {e.device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
                f"under {e.key}")
    log("  largest kernels:")
    for name, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms {ms / total:6.1%} x{count:<5d} {name[:80]}")
    if ops:
        def own(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3
        cpu_ops = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CPU
                          and own(e) > 0), key=lambda e: -own(e))
        log("  aten ops by the device time of their own launches:")
        for e in cpu_ops[:ops]:
            log(f"    {own(e):9.3f} ms {own(e) / total:6.1%} x{e.count:<5d} "
                f"{e.key[:80]}")


# ------------------------------------------- phase 8: the placement passes


SCHED_NODES, SCHED_RUNS = 256, 5
SCHED_TICKS, SCHED_BATCH = 50, 1024
# Cycles of the sleep that holds the stream while the host queues one
# round (~400 launches, a few ms) of a replayed placement run.
SCHED_SLEEP = 40_000_000


def sched_workloads() -> dict:
    """bench.py's scheduler workloads (a)-(d) (bench.py:175-258), as numpy:
    {tag: (title, demand, parents, avail, locality, chunk)}."""
    N = SCHED_NODES
    a_demand, a_parents = random_dag(100_000, max_parents=3,
                                     parent_window=100_000, seed=0)
    b_demand, b_parents = fanout_dag(10_000, cpu=1.0)
    c_demand = np.full((50_000, 1), 1000, np.int32)
    c_parents = (np.arange(50_000, dtype=np.int32) - 1).reshape(-1, 1)
    n_map, n_reduce = 64_000, 256
    fan_in = n_map // n_reduce
    d_demand = np.full((n_map + n_reduce, 1), 1000, np.int32)
    d_parents = np.full((n_map + n_reduce, fan_in), -1, np.int32)
    d_parents[n_map:] = np.arange(n_map, dtype=np.int32).reshape(n_reduce,
                                                                 fan_in)
    d_locality = np.full(n_map + n_reduce, -1, np.int32)
    d_locality[n_map:] = np.arange(n_reduce) % N
    cluster = uniform_cluster(N, cpu=16.0)
    return {
        "a": ("random DAG", a_demand, a_parents, cluster, None, 8192),
        "b": ("10k no-op fan-out", b_demand, b_parents, cluster, None, 8192),
        "c": ("50k linear chain, schedule_dag_collapsed", c_demand,
              c_parents, cluster[:, :1], None, 64),
        "d": ("64k map + 256 reduce with locality", d_demand, d_parents,
              uniform_cluster(N, cpu=300.0)[:, :1], d_locality, 8192),
    }


def count_syncs(fn) -> int:
    """How often fn() makes the host wait for the card, as torch's sync
    debug mode reports it (one warning per synchronizing call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def profile_launches(fn, top: int = 0) -> tuple:
    """(device events, their summed device ms) of one fn() under
    torch.profiler: kernels, copies and fills; with ``top``, also logs the
    ``top`` kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in rows) / 1e3
    for e in rows[:top]:
        ms = e.device_time_total / 1e3
        log(f"    {ms:9.3f} ms {ms / max(total, 1e-9):6.1%} x{e.count:<6d} "
            f"{e.key[:90]}")
    return sum(e.count for e in rows), total


def best_wall(fn) -> tuple:
    """(least, all) host walls of SCHED_RUNS calls after a warm-up; fn ends
    by reading its result on the host, which waits for the card."""
    fn()
    walls = []
    for _ in range(SCHED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return min(walls), walls


def replay_device_ms(state) -> tuple:
    """Device ms of one schedule_dag run, replayed a round at a time: each
    round's work (its ready mask, the loop's condition and the body)
    queued behind a sleep and timed by CUDA events, the rounds summed.
    Returns (ms, rounds, whether the host was slower than the sleep)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total, r, host_bound = 0.0, 0, False
    while True:
        torch.cuda._sleep(SCHED_SLEEP)
        start.record()
        ready = state.ready()
        more = ready.any()
        state.step(r, ready)      # with nothing ready it places nothing
        host_bound |= start.query()
        end.record()
        end.synchronize()
        if not bool(more):
            return total, r, host_bound
        total += start.elapsed_time(end)
        r += 1


def sched_line(tag, title, T, rounds, wall, walls, syncs, launches,
               dev_ms, prof_ms, card, extra="") -> None:
    log(f"  ({tag}) {title}, {T} tasks: {rounds} rounds{extra}; "
        f"{T / wall:.1f} tasks/s (least wall {wall:.6f} s of "
        f"{[round(w, 6) for w in walls]}); {1e3 * wall / rounds:.3f} ms a "
        f"round; {syncs} host syncs ({syncs / rounds:.2f} a round); "
        f"{launches} device launches ({launches / rounds:.1f} a round); "
        f"device {dev_ms:.3f} ms (CUDA events, rounds replayed), "
        f"{prof_ms:.3f} ms (torch.profiler kernel sum); busy "
        f"{dev_ms / (1e3 * wall):.1%} of the least wall [{card}]")


def sched_path(card: str) -> None:
    """Phase 8: the port's placement passes on the card at bench.py's
    sizes, each result held to the port's scalar reference on the host."""
    log(f"phase 8: the placement passes (torch ops) at bench.py's sizes, "
        f"{SCHED_NODES} nodes [{card}]")
    dev = torch.device("cuda")
    key = sched.prng_key(0)
    t_phase = time.perf_counter()
    for tag, (title, demand, parents, avail, loc, chunk) in \
            sched_workloads().items():
        T = demand.shape[0]
        if tag == "c":
            avail_t = torch.from_numpy(avail).to(dev)

            def run():
                return sched.schedule_dag_collapsed(demand, parents,
                                                    avail_t, key,
                                                    chunk=chunk)
            got, rounds = run()
            r_demand, r_parents, _, expand = collapse_chains(demand,
                                                             parents)
            want, want_rounds = sched_ref.schedule_dag_reference(
                r_demand, r_parents, avail, key, chunk=chunk)
            want = want[expand]
            inputs = (r_demand, r_parents, avail, None)
        else:
            inputs = tuple(None if x is None else torch.from_numpy(x).to(dev)
                           for x in (demand, parents, avail, loc))

            def run():
                p, r = sched.schedule_dag(*inputs[:3], key,
                                          locality=inputs[3], chunk=chunk)
                return p.cpu().numpy(), int(r)
            got, rounds = run()
            t0 = time.perf_counter()
            want, want_rounds = sched_ref.schedule_dag_reference(
                demand, parents, avail, key, locality=loc, chunk=chunk)
            log(f"  ({tag}) scalar reference on the host: {want_rounds} "
                f"rounds in {time.perf_counter() - t0:.1f} s")
        if rounds != want_rounds or not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(
                f"({tag}) card placement differs from the reference: "
                f"rounds {rounds} vs {want_rounds}, {bad.size} tasks, first "
                f"{bad[:5].tolist()}")
        placed = int((got >= 0).sum())
        extra = f", {placed} placed, equal to the reference"
        if tag == "a":
            digest = hashlib.sha256(got.astype(np.int32).tobytes()
                                    ).hexdigest()
            if (rounds, placed, digest) != (SCHED_A_ROUNDS, T,
                                            SCHED_A_SHA256):
                raise AssertionError(
                    f"(a) {rounds} rounds, {placed} placed, sha256 {digest}"
                    f"; want {SCHED_A_ROUNDS}, {T}, {SCHED_A_SHA256}")
            extra += f", sha256 {digest} as JAX's"
        if tag == "d":
            hit = float((got[64_000:] == loc[64_000:]).mean())
            extra += f", locality hit rate {hit:.4f}"
        wall, walls = best_wall(run)
        syncs = count_syncs(run)
        launches, prof_ms = profile_launches(run, top=10 if tag == "a" else 0)
        state = sched._DagRounds(
            *(x if x is None or isinstance(x, torch.Tensor)
              else torch.from_numpy(x).to(dev) for x in inputs[:3]), key,
            inputs[3] if isinstance(inputs[3], torch.Tensor) else None,
            None, chunk, dev)
        dev_ms, replayed, host_bound = replay_device_ms(state)
        if replayed != rounds:
            raise AssertionError(f"({tag}) replay took {replayed} rounds")
        if tag != "c" and not np.array_equal(
                state.placement[:T].cpu().numpy(), got):
            raise AssertionError(f"({tag}) replayed placement differs")
        if host_bound:
            log(f"  ({tag}) the sleep ended before the host queued a round:"
                " its device time is an upper bound")
        sched_line(tag, title, T, rounds, wall, walls, syncs, launches,
                   dev_ms, prof_ms, card, extra)
    sched_dispatch(card, key)
    sched_control_plane(card, key)
    log(f"  phase 8 in {time.perf_counter() - t_phase:.1f} s")


def sched_dispatch(card: str, key) -> None:
    """(e) bench.py's dispatch latency: 50 ticks of a 1,024-task batch on
    256 nodes through BatchScheduler, each tick held to the reference."""
    avail = uniform_cluster(SCHED_NODES, cpu=16.0)
    demand = np.full((SCHED_BATCH, avail.shape[1]), 1000, np.int32)
    bs = sched.BatchScheduler(avail, seed=0, chunk=SCHED_BATCH)
    bs.place(demand)                                  # tick 0, warm-up
    lat, outs = [], []
    for _ in range(SCHED_TICKS):
        t0 = time.perf_counter()
        outs.append(bs.place(demand))
        lat.append(time.perf_counter() - t0)
    no_parents = np.full((SCHED_BATCH, 1), -1, np.int32)
    for tick, got in enumerate(outs, start=1):
        want, _ = sched_ref.schedule_dag_reference(
            demand, no_parents, avail, sched.fold_in(key, tick),
            chunk=SCHED_BATCH, max_rounds=1)
        if not np.array_equal(got, want):
            raise AssertionError(f"(e) tick {tick} differs from the "
                                 "reference")
    lat.sort()
    syncs = count_syncs(lambda: bs.place(demand))
    launches, prof_ms = profile_launches(lambda: bs.place(demand))
    dev = torch.device("cuda")
    demand_t = torch.from_numpy(demand).to(dev)
    parents_t = torch.from_numpy(no_parents).to(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SCHED_SLEEP)
    start.record()
    st = sched._DagRounds(demand_t, parents_t, bs.avail,
                          sched.fold_in(key, 1), None, None, SCHED_BATCH,
                          dev)
    st.step(0, st.ready())
    end.record()
    end.synchronize()
    dev_ms = start.elapsed_time(end)
    p50, p99 = lat[len(lat) // 2], lat[-1]
    log(f"  (e) dispatch, {SCHED_TICKS} ticks of {SCHED_BATCH} tasks on "
        f"{SCHED_NODES} nodes, each equal to the reference: p50 "
        f"{1e3 * p50:.3f} ms, p99 (max of {SCHED_TICKS}) {1e3 * p99:.3f} "
        f"ms, {1e6 * p50 / SCHED_BATCH:.3f} us a task at p50; a tick: "
        f"{syncs} host syncs, {launches} device launches, device "
        f"{dev_ms:.3f} ms (CUDA events), {prof_ms:.3f} ms (torch.profiler "
        f"kernel sum); busy {dev_ms / (1e3 * p50):.1%} of the p50 [{card}]")


def sched_control_plane(card: str, key) -> None:
    """S1 at a chunk's 8,192 tasks, and S3-S5 once each at control-plane
    sizes, each held to the reference."""
    dev = torch.device("cuda")
    idx = torch.arange(8192, device=dev)
    bits = sched.task_bits(key, 3, idx)
    if not np.array_equal(bits.cpu().numpy(),
                          sched.task_bits_host(key, 3, np.arange(8192))):
        raise AssertionError("S1 task_bits on the card differ from numpy")
    launches, prof_ms = profile_launches(lambda: sched.task_bits(key, 3,
                                                                 idx))
    dev_ms = device_ms("task_bits", lambda: sched.task_bits(key, 3, idx),
                       [()], 1, sleep_cycles=SCHED_SLEEP)
    log(f"  S1 task_bits, 8192 tasks (one round's chunk): equal to numpy; "
        f"{launches} device launches, device {dev_ms:.3f} ms (CUDA "
        f"events), {prof_ms:.3f} ms (torch.profiler kernel sum) [{card}]")
    rng = np.random.default_rng(SEED)
    sizes = rng.integers(1, 9, size=230)
    group = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    gangs = (rng.integers(0, 4000, size=(len(group), 4)).astype(np.int32),
             group, (np.arange(len(sizes)) % 4).astype(np.int32),
             rng.integers(2000, 16000, size=(SCHED_NODES, 4)
                          ).astype(np.int32), key)
    T = 8192
    pending = (rng.integers(0, 20000, size=(T, 4)).astype(np.int32),
               rng.integers(-2, SCHED_NODES, size=T).astype(np.int32),
               gangs[3], rng.random(T) < 0.2, rng.random(T) < 0.2,
               rng.random(T) < 0.2)
    nbytes = rng.integers(0, 1 << 31, size=(T, SCHED_NODES))
    big = rng.random(nbytes.shape) < 0.25
    nbytes[big] = rng.integers(1 << 31, 1 << 45, size=int(big.sum()))
    nbytes[rng.random(nbytes.shape) < 0.5] = 0
    nbytes[::97] = 0
    passes = {
        "S3 admit_gangs_host": (
            f"{len(group)} bundles in {len(sizes)} groups, all 4 "
            f"strategies", lambda: sched.admit_gangs_host(*gangs),
            lambda: sched_ref.admit_gangs_reference(*gangs)),
        "S4 classify_pending_host": (
            f"{T} tasks", lambda: sched.classify_pending_host(*pending),
            lambda: sched_ref.classify_pending_reference(*pending)),
        "S5 score_locality_host": (
            f"[{T}, {SCHED_NODES}] int64 bytes, {int(big.sum())} above "
            "2^31", lambda: sched.score_locality_host(nbytes),
            lambda: sched_ref.score_locality_reference(nbytes)),
    }
    for name, (what, fn, ref) in passes.items():
        got = fn()
        if not np.array_equal(got, ref()):
            raise AssertionError(f"{name} differs from the reference")
        wall, _ = best_wall(fn)
        syncs = count_syncs(fn)
        launches, prof_ms = profile_launches(fn)
        log(f"  {name}, {what}: equal to the reference; least wall "
            f"{1e3 * wall:.3f} ms of {SCHED_RUNS}; {syncs} host syncs, "
            f"{launches} device launches, {prof_ms:.3f} ms device "
            f"(torch.profiler kernel sum) [{card}]")


# ------------------------------------------ phase 9: the local runtime


# Round trips and fan-out of (f); the spill of (e): eight 256 MiB f32
# tensors into a 1 GiB store.
RT_CALLS, RT_FANOUT, RT_PUTS = 1000, 10_000, 100
SPILL_N, SPILL_ELEMS, SPILL_BUDGET = 8, 64 * 2**20, 2**30
RUNTIME_THREADS = ("task-", "actor-", "pg-", "flight-recorder")


class Server:
    """Phase 9's GPU actor: the flagship LMBackend, built from the
    parameters the actor got through an ObjectRef and warmed as phase 3's,
    its engine under a PathProbe."""

    def __init__(self, params, cfg):
        self.params = params
        self.backend = LMBackend(params, cfg, max_slots=SLOTS,
                                 max_seq=MAX_SEQ, device="cuda")
        self.backend([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
        self.probe = PathProbe(self.backend.engine)

    def param_ptrs(self) -> list:
        return [t.data_ptr() for t in named_leaves(self.params).values()]

    def cache_bytes(self) -> int:
        eng = self.backend.engine
        return eng.cache_k.nbytes + eng.cache_v.nbytes

    def engine_id(self) -> int:
        return id(self.backend.engine)

    def __ray_shutdown__(self):
        """kill() frees the engine's cache and workspace: the probe holds
        the engine too."""
        self.backend.close()
        self.probe = None

    def serve(self, prompts, n) -> list:
        return self.backend([ServeRequest((p,), {"max_new_tokens": n})
                             for p in prompts])

    def sample(self, prompt, kw) -> list:
        return self.backend([ServeRequest((prompt,), kw)])[0]

    def probed(self) -> tuple:
        """(prefills, ticks, launches of each tick) since the last call."""
        p = self.probe
        out = len(p.prefills), len(p.ticks), list(p.tick_launches)
        p.prefills, p.ticks, p.tick_launches = [], [], []
        return out


class K1Worker:
    """Phase 9's actor in a placement group's GPU bundle."""

    def run(self, x, w):
        return fused.rms_norm(x, w, EPS)


class Echo:
    def m(self):
        return None


def k1_task(x, w):
    return x.data_ptr(), fused.rms_norm(x, w, EPS)


def noop():
    return None


def direct_backend_growth(params, cfg) -> int:
    """Bytes of device memory the flagship LMBackend takes when a fresh
    thread builds and warms it without the runtime (its cache and
    workspace, the per-thread cuBLAS workspaces included): what the actor,
    a fresh thread too, may add."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    held = []

    def build_and_warm():
        backend = LMBackend(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                            device="cuda")
        backend([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
        held.append(backend)

    t = threading.Thread(target=build_and_warm, name="direct-backend")
    t.start()
    t.join(600)
    if not held:
        raise AssertionError("(b) the direct LMBackend did not build")
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - mem0
    held[0].close()
    return growth


def pct_us(ts: list) -> str:
    a = np.asarray(ts) * 1e6
    return f"p50 {np.percentile(a, 50):.1f} us, p99 {np.percentile(a, 99):.1f} us"


def wait_until(what: str, cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.005)


def spill_counters() -> dict:
    """The spill directory's byte counters and per-object latency sums
    (ray_tpu_torch.metrics)."""
    snap = rt_metrics.collect_all()
    out = {}
    for kind in ("spilled", "restored"):
        vals = snap.get(f"object_store_{kind}_bytes", {"values": {}})
        out[f"{kind}_bytes"] = sum(vals["values"].values())
        cells = rt_metrics.histogram_cells(
            f"object_store_{'spill' if kind == 'spilled' else 'restore'}"
            f"_latency_ms")
        out[f"{kind}_ms"] = sum(c["sum"] for c in cells.values())
        out[f"{kind}_n"] = sum(c["count"] for c in cells.values())
    return out


def runtime_path(params, cfg, main: dict, card: str) -> int:
    """Phase 9: the local runtime on the card, the flagship LMBackend in a
    GPU actor, GPU accounting, a placement group, spill of CUDA tensors,
    the runtime's own costs, timeline() and shutdown(). Returns the device
    memory the backend takes when built directly."""
    log(f"phase 9: the local runtime (ray_tpu_torch.init, tasks, actors, "
        f"object store, placement groups) on the card [{card}]")
    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    n_gpu = torch.cuda.device_count()
    L, V = cfg.n_layers, cfg.vocab_size

    # (a) init() counts the card.
    rt.init()
    total = rt.cluster_resources()
    if total.get("GPU") != n_gpu:
        raise AssertionError(f"(a) cluster_resources {total}, "
                             f"{n_gpu} cards")
    log(f"  (a) init(): cluster_resources {total}")

    # (b) The flagship in a GPU actor, its parameters through put().
    direct_growth = direct_backend_growth(params, cfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    pref = rt.put(params)
    if rt.get(pref) is not params:
        raise AssertionError("(b) get(put(params)) is not the same object")
    server = rt.remote(num_gpus=1)(Server).remote(pref, cfg)
    ptrs = rt.get(server.param_ptrs.remote(), timeout=600)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - mem0
    leaves = named_leaves(params)
    if ptrs != [t.data_ptr() for t in leaves.values()]:
        raise AssertionError("(b) the actor's parameters are not the "
                             "driver's tensors (data_ptr differs)")
    if growth > direct_growth:
        raise AssertionError(
            f"(b) the actor added {growth} bytes of device memory, more "
            f"than the backend's own cache and workspace ({direct_growth})")
    param_bytes = sum(t.nbytes for t in leaves.values())
    log(f"  (b) Server actor (num_gpus=1) built LMBackend from put(params): "
        f"{len(ptrs)} parameter tensors ({param_bytes / 2**20:.1f} MiB) at "
        f"the driver's data_ptr; device memory +{growth / 2**20:.1f} MiB, "
        f"the same backend built directly +{direct_growth / 2**20:.1f} MiB")
    prompts = serving_prompts(V)
    want_outs = main["outs"]
    reset_counts()
    outs = rt.get(server.serve.remote(prompts, NEW_TOKENS), timeout=600)
    launches = read_counts()
    n_pre, n_tick, ticks = rt.get(server.probed.remote())
    if outs != want_outs:
        bad = [i for i, (a, b) in enumerate(zip(outs, want_outs)) if a != b]
        raise AssertionError(f"(b) the actor's tokens differ from phase 3's "
                             f"in requests {bad}")
    want = {"rms_norm": n_pre + n_tick,
            "add_rms_norm": 2 * L * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    got = {n: c for n, c in launches.items() if c}
    if got != want or not n_tick:
        raise AssertionError(f"(b) launches {got}, expected {want}")
    per_tick = {"rms_norm": 1, "add_rms_norm": 2 * L, "decode_attention": L}
    for i, t in enumerate(ticks):
        if {n: c for n, c in t.items() if c} != per_tick:
            raise AssertionError(f"(b) tick {i}: launches {t}, expected "
                                 f"{per_tick}")
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = rt.get(server.sample.remote(prompts[3], sample_kw))
    s2 = rt.get(server.sample.remote(prompts[3], sample_kw))
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"(b) seeded sampling differs: {s1} {s2}")
    log(f"  (b) 12 greedy requests through the actor: phase 3's tokens, "
        f"token for token; {n_pre} prefills, {n_tick} ticks, launches "
        f"{got}, every tick {per_tick}; seeded sample equal twice: "
        f"{s1[:6]}...")

    # (f), the part that needs the actor: the batch's wall, in turns.
    walls = {"direct": [], "actor": []}
    for how in ("direct", "actor", "actor", "direct"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "direct":
            again = main["backend"]([ServeRequest((p,), {
                "max_new_tokens": NEW_TOKENS}) for p in prompts])
        else:
            again = rt.get(server.serve.remote(prompts, NEW_TOKENS))
        torch.cuda.synchronize()
        walls[how].append(time.perf_counter() - t0)
        if again != want_outs:
            raise AssertionError(f"(f) {how} batch: tokens differ from "
                                 f"phase 3's")
    rt.get(server.probed.remote())

    # (c) While the actor holds the card a GPU task waits; kill admits it.
    x, w = rms_inputs(64, torch.bfloat16, seed=9)
    xref = rt.put(x)
    ref = rt.remote(num_gpus=1)(k1_task).remote(xref, w)
    ready, rest = rt.wait([ref], timeout=0.5)
    row = rt.state.tasks(name_contains="k1_task")[0]
    held = rt.available_resources().get("GPU", 0.0)
    if ready or rest != [ref] or row["state"] != "PENDING" \
            or row["pending_reason"] != "waiting-for-capacity":
        raise AssertionError(f"(c) the GPU task did not wait: ready {ready}, "
                             f"row {row}")
    cache_bytes = rt.get(server.cache_bytes.remote())
    engine_id = rt.get(server.engine_id.remote())
    torch.cuda.synchronize()
    mem_held = torch.cuda.memory_allocated()
    reset_counts()
    rt.kill(server)
    ptr, k1_out = rt.get(ref, timeout=60)
    counts = {n: c for n, c in read_counts().items() if c}
    gc.collect()
    torch.cuda.synchronize()
    freed = mem_held + k1_out.nbytes - torch.cuda.memory_allocated()
    if freed < cache_bytes:
        held = [o for o in gc.get_objects() if id(o) == engine_id]
        log(f"  (c) the actor's engine still alive: {bool(held)}; its "
            f"referrers: {[type(r).__name__ for e in held
                           for r in gc.get_referrers(e)]}")
        raise AssertionError(
            f"(c) kill() freed {freed} bytes of device memory, less than "
            f"the actor's KV cache ({cache_bytes})")
    if counts != {"rms_norm": 1}:
        raise AssertionError(f"(c) launches {counts}, expected one K1")
    if ptr != x.data_ptr() or k1_out.device.type != "cuda":
        raise AssertionError("(c) the task's tensor was copied or left the "
                             "card")
    err = check_close("(c) the GPU task's rms_norm [64, 1024] bfloat16",
                      k1_out, fused._rms_norm_ref(x, w, EPS), atol=2e-2,
                      rtol=2e-2)
    log(f"  (c) num_gpus=1 task pending while the actor holds the card "
        f"(wait: not ready; reason {row['pending_reason']}; GPU available "
        f"{held}); kill() admitted it: one K1 launch, err {err:.3e}; "
        f"kill() freed {freed / 2**20:.1f} MiB of the actor's "
        f"+{growth / 2**20:.1f} MiB (its KV cache "
        f"{cache_bytes / 2**20:.1f} MiB)")

    # (d) A placement group's GPU bundle.
    pg = rt.placement_group([{"GPU": 1, "CPU": 1}])
    if not pg.wait(30):
        raise AssertionError(f"(d) {rt.placement_group_table(pg)}")
    worker = rt.remote(K1Worker).options(
        placement_group=pg, placement_group_bundle_index=0, num_gpus=1,
        num_cpus=1).remote()
    reset_counts()
    pg_out = rt.get(worker.run.remote(xref, w), timeout=60)
    counts = {n: c for n, c in read_counts().items() if c}
    if counts != {"rms_norm": 1} or not torch.equal(pg_out, k1_out):
        raise AssertionError(f"(d) launches {counts}, or not (c)'s bits")
    inside = rt.available_resources()
    rt.kill(worker)
    rt.remove_placement_group(pg)
    wait_until("(d) GPU back after remove_placement_group",
               lambda: rt.available_resources().get("GPU") == n_gpu)
    log(f"  (d) actor in a {{GPU: 1, CPU: 1}} bundle: one K1 launch, (c)'s "
        f"bits; GPU available {inside.get('GPU', 0.0)} while the group "
        f"lived, {rt.available_resources()['GPU']} after its removal")

    # (f) The runtime's own costs on this host.
    fn = rt.remote(noop)
    echo = rt.remote(Echo).remote()
    rt.get([fn.remote(), echo.m.remote()])
    task_rtt, actor_rtt = [], []
    for _ in range(RT_CALLS):
        t0 = time.perf_counter()
        rt.get(fn.remote())
        task_rtt.append(time.perf_counter() - t0)
    for _ in range(RT_CALLS):
        t0 = time.perf_counter()
        rt.get(echo.m.remote())
        actor_rtt.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    rt.get([fn.remote() for _ in range(RT_FANOUT)])
    fanout_s = time.perf_counter() - t0
    big = torch.randn(SPILL_ELEMS, generator=cuda_gen(SEED + 9),
                      device="cuda")
    put_us, get_us = [], []
    for _ in range(RT_PUTS):
        t0 = time.perf_counter()
        bref = rt.put(big)
        t1 = time.perf_counter()
        if rt.get(bref) is not big:
            raise AssertionError("(f) get(put(t)) is not t")
        put_us.append(t1 - t0)
        get_us.append(time.perf_counter() - t1)
        del bref
    log(f"  (f) no-op task submit -> get round trip over {RT_CALLS}: "
        f"{pct_us(task_rtt)}; actor call round trip: {pct_us(actor_rtt)}; "
        f"{RT_FANOUT} no-op fan-out: {RT_FANOUT / fanout_s:.1f} tasks/s; "
        f"put of a 256 MiB CUDA tensor {pct_us(put_us)}, get "
        f"{pct_us(get_us)}; the 12-request batch's wall, direct "
        f"{[round(1e3 * s, 3) for s in walls['direct']]} ms, through the "
        f"actor {[round(1e3 * s, 3) for s in walls['actor']]} ms (turns "
        f"direct, actor, actor, direct) [{card}]")

    # (g) timeline() has an event for every task and actor call.
    rows = rt.state.tasks(limit=10**6)
    calls = {r["task_id"] for r in rows if r["kind"] in ("task",
                                                          "actor_method")}
    creations = sum(r["kind"] == "actor_creation" for r in rows)
    if len(calls) < 2 * RT_CALLS + RT_FANOUT:
        raise AssertionError(f"(g) only {len(calls)} task records")

    def covered():
        events = rt.timeline()
        tids = {e["tid"] for e in events if e["cat"] == "task"}
        return calls <= tids and creations == sum(
            e["cat"] == "actor_creation" for e in events)
    wait_until("(g) timeline() covers every task and actor call", covered)
    log(f"  (g) timeline(): an event for each of {len(calls)} task and "
        f"actor calls and {creations} actor creations")
    rt.shutdown()

    # (e) Spill: eight 256 MiB CUDA tensors through a 1 GiB store.
    rt.init(object_store_memory=SPILL_BUDGET)
    gen = cuda_gen(SEED + 10)
    vals = [torch.randn(SPILL_ELEMS, generator=gen, device="cuda")
            for _ in range(SPILL_N)]
    torch.cuda.synchronize()
    c0 = spill_counters()
    t0 = time.perf_counter()
    refs = [rt.put(v) for v in vals]
    put_s = time.perf_counter() - t0
    c1 = spill_counters()
    stats = rt.state.object_store_stats()
    if not stats["spilled_objects"]:
        raise AssertionError(f"(e) nothing spilled: {stats}")
    t0 = time.perf_counter()
    gots = [rt.get(r) for r in refs]   # one at a time: each fits alone
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    c2 = spill_counters()
    for i, (got, v) in enumerate(zip(gots, vals)):
        if got.device.type != "cuda" or got.dtype != v.dtype or \
                not torch.equal(got.view(torch.int32), v.view(torch.int32)):
            raise AssertionError(f"(e) tensor {i} did not come back on the "
                                 f"card with its bits")
    gb = 1e9
    sp_put = c1["spilled_bytes"] - c0["spilled_bytes"]
    moved = (c2["spilled_bytes"] - c1["spilled_bytes"]
             + c2["restored_bytes"] - c1["restored_bytes"])
    w_ms = c2["spilled_ms"] - c0["spilled_ms"]
    r_ms = c2["restored_ms"] - c0["restored_ms"]
    log(f"  (e) {SPILL_N} x 256 MiB CUDA tensors into a 1 GiB store: "
        f"{stats['spilled_objects']} spilled after the puts, "
        f"{c2['spilled_n'] - c0['spilled_n']} spills and "
        f"{c2['restored_n'] - c0['restored_n']} restores in all, every get "
        f"on the card with its bits; puts {put_s:.3f} s (spill end to end "
        f"{sp_put / gb / put_s:.3f} GB/s: pickle with the copy off the "
        f"card, write, fsync), gets {get_s:.3f} s ({moved / gb / get_s:.3f}"
        f" GB/s restored and spilled: each restore spills another); the "
        f"spill directory alone writes "
        f"{(c2['spilled_bytes'] - c0['spilled_bytes']) / gb / (w_ms / 1e3):.3f}"
        f" GB/s and reads "
        f"{(c2['restored_bytes'] - c0['restored_bytes']) / gb / (r_ms / 1e3):.3f}"
        f" GB/s [{card}]")
    del gots, refs, vals
    rt.shutdown()

    # (g) shutdown() leaves no thread of the runtime alive.
    def runtime_threads():
        return [t.name for t in threading.enumerate()
                if t not in threads_before and t.name.startswith(
                    RUNTIME_THREADS + ("lm-engine-pump",))]
    wait_until(f"(g) runtime threads alive after shutdown(): "
               f"{runtime_threads()}", lambda: not runtime_threads())
    others = sorted(t.name for t in threading.enumerate()
                    if t not in threads_before)
    log(f"  (g) shutdown() left no runtime thread and no LMBackend pump "
        f"(threads of this phase "
        f"still alive: {others})")
    log(f"  phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return direct_growth


# ------------------------------------------------ phase 10: serve on the card


# The serve phase: the reference's documented LMBackend deployment, the
# round trips of (f), and the new tokens of (e)'s streams, which outlast
# the scale-down's drain.
SERVE_CONFIG = dict(max_batch_size=8, batch_wait_timeout_s=0.05,
                    max_concurrent_queries=16, replica_concurrency=8)
SERVE_CALLS, DRAIN_TOKENS = 1000, 512
# (e)'s drain limit: its two streams decode on two pumps in this one
# process, about 17-35 s on the chip machine, so serve's default 30 s could
# retire the replica while its stream still runs.
DRAIN_TIMEOUT_S = 120.0
SERVE_THREADS = ("serve-reconcile", "serve-http", "lm-engine-pump")


class Probe(LMBackend):
    """Phase 10's backend class, built by serve in each replica: the
    flagship LMBackend on the card, warmed as phase 3's, its engine under a
    PathProbe (a PagedProbe when paged) with the size of every batch serve
    hands it and the data_ptr of every parameter it was given. The probes
    stay in ``Probe.live`` for the driver thread to read; closing the
    backend detaches its probe from the engine, so a closed replica's
    engine is freed."""

    live: list = []

    def __init__(self, params, cfg, **kw):
        super().__init__(params, cfg, device="cuda", **kw)
        super().__call__([ServeRequest(([1, 2, 3],), {"max_new_tokens": 4})])
        eng = self.engine
        probe = (PagedProbe if kw.get("paged") else PathProbe)(eng)
        probe.paged = bool(kw.get("paged"))
        probe.batches, probe.closed = [], False
        probe.param_ptrs = [t.data_ptr()
                            for t in named_leaves(params).values()]
        caches = ((eng.k_pages, eng.v_pages) if probe.paged
                  else (eng.cache_k, eng.cache_v))
        probe.cache_bytes = sum(t.nbytes for t in caches)
        self.probe = probe
        Probe.live.append(probe)

    @accept_batch
    def __call__(self, requests):
        self.probe.batches.append(len(requests))
        return super().__call__(requests)

    def close(self) -> None:
        super().close()
        probe = self.probe
        for name in ("eng", "_prefill", "_decode", "_can_admit"):
            if hasattr(probe, name):
                setattr(probe, name, None)
        probe.closed = True

    __ray_shutdown__ = close


def serve_noop(x=None):
    return x


def since(probe, mark: dict) -> tuple:
    """A probe's prefills, ticks and their launches after ``mark``."""
    return (probe.prefill_launches[mark["pre"]:],
            probe.tick_launches[mark["tick"]:])


def mark(probe) -> dict:
    return {"pre": len(probe.prefill_launches),
            "tick": len(probe.tick_launches),
            "batches": len(probe.batches)}


def mem_now() -> int:
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def ndjson(url: str, body: dict) -> tuple:
    """(Content-Type, decoded chunks) of one streamed HTTP request."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        ctype = resp.headers.get("Content-Type")
        chunks = [json.loads(ln) for ln in resp if ln.strip()]
    return ctype, chunks


def serve_path(params, cfg, main: dict, paged: dict, direct_growth: int,
               card: str) -> None:
    """Phase 10: the flagship LMBackend behind the serve control plane
    (serve.create_backend, the router, replica actors, the HTTP ingress)
    on the card, through the reference's public API. A failed check shuts
    serve and the runtime down before it propagates, so no replica outlives
    the run."""
    try:
        serve_checks(params, cfg, main, paged, direct_growth, card)
    except BaseException:
        serve.shutdown()
        rt.shutdown()
        raise


def serve_checks(params, cfg, main: dict, paged: dict, direct_growth: int,
                 card: str) -> None:

    log(f"phase 10: serve control plane (serve.create_backend -> router -> "
        f"replicas, HTTP ingress) with the flagship LMBackend on the card "
        f"[{card}]")
    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    L, V = cfg.n_layers, cfg.vocab_size
    prompts, want = serving_prompts(V), main["outs"]
    mem_start = mem_now()

    # (a) One contiguous replica behind serve.
    rt.init()
    serve.init(http_port=0)
    bc = serve.BackendConfig(**SERVE_CONFIG)
    Probe.live.clear()
    serve.create_backend("lm:contig", Probe, params, cfg, max_slots=SLOTS,
                         max_seq=MAX_SEQ, config=bc)
    serve.create_endpoint("gen", backend="lm:contig", route="/generate",
                          methods=["POST"])
    growth = mem_now() - mem_start
    contig = Probe.live[0]
    if contig.param_ptrs != [t.data_ptr()
                             for t in named_leaves(params).values()]:
        raise AssertionError("(a) the replica's parameters are not the "
                             "driver's tensors (data_ptr differs)")
    if growth > direct_growth:
        raise AssertionError(f"(a) the replica added {growth} bytes, more "
                             f"than the backend built directly "
                             f"({direct_growth}): were the weights copied?")
    h = serve.get_handle("gen")
    m0 = mark(contig)
    reset_counts()
    t0 = time.perf_counter()
    outs = rt.get([h.remote(p, max_new_tokens=NEW_TOKENS) for p in prompts],
                  timeout=600)
    batch_s = time.perf_counter() - t0
    launches = read_counts()
    pres, ticks = since(contig, m0)
    batches = contig.batches[m0["batches"]:]
    if outs != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
        raise AssertionError(f"(a) tokens through serve differ from phase "
                             f"3's in requests {bad}")
    n_pre, n_tick = len(pres), len(ticks)
    exp = {"rms_norm": n_pre + n_tick,
           "add_rms_norm": 2 * L * (n_pre + n_tick),
           "decode_attention": L * n_tick}
    got = {n: c for n, c in launches.items() if c}
    if got != exp or not n_tick:
        raise AssertionError(f"(a) launches {got}, expected {exp}")
    check_launches_each(pres + ticks, L, "(a) prefill or tick")
    for i, t in enumerate(ticks):
        if t["decode_attention"] != L:
            raise AssertionError(f"(a) tick {i}: launches {t}")
    st = serve.stat()
    if max(batches) < 2 or sum(batches) != len(prompts) \
            or not st["backends"]["lm:contig"]["batched"]:
        raise AssertionError(f"(a) the router did not batch: batches "
                             f"{batches}, stat {st['backends']}")
    log(f"  (a) 12 greedy requests through get_handle('gen').remote in "
        f"{batch_s:.3f} s: phase 3's tokens, token for token; the router "
        f"batched them as {batches} (handle_batch calls); {n_pre} prefills, "
        f"{n_tick} ticks, launches {got} (K1 {2 * L + 1} and K6 {L} a "
        f"tick); the replica's {len(contig.param_ptrs)} parameters at the "
        f"driver's data_ptr, device memory +{growth / 2**20:.1f} MiB (the "
        f"backend built directly +{direct_growth / 2**20:.1f} MiB)")

    # (b) Streams through the handle and over HTTP; seeded sampling.
    streamed = list(h.stream(prompts[0], max_new_tokens=NEW_TOKENS))
    ctype, chunks = ndjson(f"{serve.http_address()}/generate", {
        "args": [prompts[0]],
        "kwargs": {"max_new_tokens": NEW_TOKENS, "stream": True}})
    http_toks = [t for c in chunks for t in c.get("tokens", [])]
    if streamed != want[0] or http_toks != want[0]:
        raise AssertionError(f"(b) streams differ from the whole response: "
                             f"handle {streamed}, HTTP {chunks}")
    if ctype != "application/x-ndjson" or not chunks[-1].get("done") \
            or any(c.get("done") for c in chunks[:-1]):
        raise AssertionError(f"(b) HTTP stream: type {ctype}, chunks "
                             f"{chunks}")
    sample_kw = {"max_new_tokens": 16, "temperature": 0.8, "seed": 42}
    s1 = rt.get(h.remote(prompts[3], **sample_kw))
    s2 = rt.get(h.remote(prompts[3], **sample_kw))
    if s1 != s2 or len(s1) != 16:
        raise AssertionError(f"(b) seeded sampling differs: {s1} {s2}")
    log(f"  (b) handle.stream and HTTP NDJSON ({ctype}, {len(chunks)} "
        f"chunks, the last done) each give the whole response's "
        f"{NEW_TOKENS} tokens; seeded sample through the handle equal "
        f"twice: {s1[:6]}...")

    # (c) A traffic split between the contiguous and the paged engine.
    m_paged0 = mem_now()
    serve.create_backend("lm:paged", Probe, params, cfg, max_slots=SLOTS,
                         max_seq=MAX_SEQ, paged=True, page_size=PAGE,
                         config=bc)
    paged_growth = mem_now() - m_paged0
    pprobe = Probe.live[1]
    serve.set_traffic("gen", {"lm:contig": 0.5, "lm:paged": 0.5})
    shared, want_shared = paged_traffic(V)[2], paged["want_shared"]
    random.seed(SEED)   # the router draws the split from module random
    reset_counts()
    split = rt.get([h.remote(p, max_new_tokens=NEW_TOKENS) for p in shared],
                   timeout=600)
    launches = read_counts()
    per_backend = {tag: w["count"] for tag, w in
                   serve.stat()["metrics"]["backends"].items()}
    if split != want_shared:
        bad = [i for i, (a, b) in enumerate(zip(split, want_shared))
               if a != b]
        raise AssertionError(f"(c) split answers differ from the contiguous "
                             f"engine's in requests {bad}")
    if not per_backend.get("lm:paged") or not pprobe.batches:
        raise AssertionError(f"(c) the paged backend served nothing: "
                             f"{per_backend}")
    if launches["decode_attention"] == 0 \
            or launches["paged_decode_attention"] == 0:
        raise AssertionError(f"(c) launches {launches}: both decode kernels "
                             f"must run")
    train = {n: launches[n] for n in ("softmax_xent", "flash_forward",
                                      "flash_backward_dq",
                                      "flash_backward_dkv",
                                      "rms_norm_backward")}
    if any(train.values()):
        raise AssertionError(f"(c) training kernels ran: {train}")
    serve.set_traffic("gen", {"lm:contig": 1.0})
    m_del0 = mem_now()
    serve.delete_backend("lm:paged")
    paged_freed = m_del0 - mem_now()
    if not pprobe.closed or paged_freed < pprobe.cache_bytes:
        raise AssertionError(
            f"(c) delete_backend freed {paged_freed} bytes, less than the "
            f"paged replica's pool ({pprobe.cache_bytes}); closed "
            f"{pprobe.closed}")
    log(f"  (c) split 0.5/0.5 with LMBackend(paged=True, page_size={PAGE}) "
        f"(+{paged_growth / 2**20:.1f} MiB): 16 shared-prefix requests "
        f"equal the contiguous engine's tokens; served per backend "
        f"{per_backend}; paged batches {pprobe.batches}; launches (two pump "
        f"threads: each above 0) K6 "
        f"{launches['decode_attention']}, K7 "
        f"{launches['paged_decode_attention']}; delete_backend closed the "
        f"paged replica and freed {paged_freed / 2**20:.1f} MiB (its pool "
        f"{pprobe.cache_bytes / 2**20:.1f} MiB)")

    # (d) Failover and replacement: a replica killed with requests in it.
    master = rt.get_actor(MASTER_NAME)
    serve.update_backend_config("lm:contig", {"num_replicas": 2})
    victim_h = rt.get(master.get_replicas.remote("lm:contig"))[0]
    if Probe.live[2].paged or len(Probe.live) != 3:
        raise AssertionError("(d) the second contiguous replica is missing")
    mem_two = mem_now()
    m1 = mark(contig)
    refs = [h.remote(p, max_new_tokens=NEW_TOKENS) for p in shared]
    wait_until("(d) a batch in the replica to be killed",
               lambda: len(contig.batches) > m1["batches"], timeout=60)
    t_kill = time.perf_counter()
    rt.kill(victim_h)
    # A second wave right after the kill: until the master's next probe
    # the router still counts the dead replica, so some of it fails over.
    refs += [h.remote(p, max_new_tokens=NEW_TOKENS) for p in shared]
    failover = rt.get(refs, timeout=600)
    answered_s = time.perf_counter() - t_kill
    if failover != want_shared + want_shared:
        raise AssertionError("(d) answers after the kill differ from the "
                             "contiguous engine's")
    wait_until("(d) the killed replica's backend closed",
               lambda: contig.closed, timeout=60)

    def healed():
        s = serve.stat()
        return (s["backends"]["lm:contig"]["up"] == 2
                and s["fleet_counters"]["replicas_replaced"] >= 1)
    wait_until("(d) the master brings the contiguous backend back to 2 up",
               healed, timeout=120)
    healed_s = time.perf_counter() - t_kill
    st = serve.stat()
    mem_healed = mem_now()
    if mem_healed - mem_two > growth // 2:
        raise AssertionError(
            f"(d) after the replacement the card holds {mem_healed - mem_two}"
            f" bytes more than two replicas did: the killed replica's "
            f"engine was not freed")
    log(f"  (d) 2 replicas; killed one with a batch in it and sent 16 more: "
        f"all 32 answered with the contiguous engine's tokens in "
        f"{answered_s:.3f} s "
        f"(counters {st['counters']}); its backend closed; the master "
        f"replaced it ({st['fleet_counters']['replicas_replaced']} replaced) "
        f"and had 2 up after {healed_s:.3f} s; device memory after the "
        f"replacement {(mem_healed - mem_two) / 2**20:+.1f} MiB against two "
        f"replicas before the kill (one replica +{growth / 2**20:.1f} MiB)")

    # (e) Scale-down drains a live stream on the retired replica. The
    # streams start through the router (what handle.stream does first) and
    # are polled only once the drain has begun, so each stays pinned to its
    # replica until the driver reads its last token.
    long_want = main["backend"]([ServeRequest((p,), {
        "max_new_tokens": DRAIN_TOKENS}) for p in prompts[:2]])
    reps = rt.get(master.get_replicas.remote("lm:contig"))
    router = rt.get(master.get_router.remote())[0]
    retired = [p for p in Probe.live if not p.closed and not p.paged][-1]
    tokens = [rt.get(router.route.remote(
        "gen", "stream_start", (p,), {"max_new_tokens": DRAIN_TOKENS}))
        for p in prompts[:2]]
    pinned = [rt.get(router.replica_load.remote("lm:contig", r))["streams"]
              for r in reps]
    if pinned != [1, 1]:
        raise AssertionError(f"(e) streams pinned per replica {pinned}, "
                             f"expected one on each")
    mem_before = mem_now()
    scaler = threading.Thread(target=serve.update_backend_config, args=(
        "lm:contig", {"num_replicas": 1, "drain_timeout_s": DRAIN_TIMEOUT_S}),
        name="scale-down")
    scaler.start()
    wait_until("(e) the retired replica draining", lambda: rt.get(
        router.stats.remote())["backends"]["lm:contig"]["draining"] == 1,
        timeout=60)
    streams, t_drain, polls = [], time.perf_counter(), []
    for tok in tokens:
        got, done = [], False
        while not done:
            try:
                out = rt.get(router.route.remote(
                    "gen", "stream_poll", (tok,), {"wait_s": 2.0}),
                    timeout=600)
            except Exception:
                log(f"  (e) stream {len(streams)} failed after "
                    f"{len(got)} tokens, {time.perf_counter() - t_drain:.3f}"
                    f" s into the drain; the streams before it: {polls}")
                raise
            got, done = got + out["tokens"], out["done"]
            polls.append((len(streams), len(out["tokens"]),
                          round(time.perf_counter() - t_drain, 3)))
        streams.append(got)
    scaler.join(DRAIN_TIMEOUT_S)
    drain_s = time.perf_counter() - t_drain
    if scaler.is_alive():
        raise AssertionError("(e) the scale-down did not end")
    retired_freed = mem_before - mem_now()
    if streams != long_want:
        raise AssertionError("(e) a stream through the scale-down differs "
                             "from its whole response")
    if not retired.closed or retired_freed < retired.cache_bytes:
        raise AssertionError(f"(e) the retired replica freed "
                             f"{retired_freed} bytes (its cache "
                             f"{retired.cache_bytes}); closed "
                             f"{retired.closed}")
    log(f"  (e) scale-down to 1 while two {DRAIN_TOKENS}-token streams were "
        f"pinned, one to each replica: the drain waited for the retired "
        f"one's ({drain_s:.3f} s of its {DRAIN_TIMEOUT_S:.0f} s limit; "
        f"streams done at "
        f"{[t for i, n, t in polls if i == 0][-1]:.3f} and {polls[-1][2]:.3f}"
        f" s, in {len(polls)} polls), both equal their whole responses; "
        f"the retired replica "
        f"closed and freed {retired_freed / 2**20:.1f} MiB (its cache "
        f"{retired.cache_bytes / 2**20:.1f} MiB)")

    # (f) What serve costs on this host.
    serve.create_backend("noop", serve_noop)
    serve.create_endpoint("noop", backend="noop", route="/noop",
                          methods=["GET"])
    hn = serve.get_handle("noop")
    rt.get(hn.remote())
    rtt_h = []
    for _ in range(SERVE_CALLS):
        t0 = time.perf_counter()
        rt.get(hn.remote())
        rtt_h.append(time.perf_counter() - t0)
    host, port = serve.http_address().split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    rtt_http = []
    for _ in range(SERVE_CALLS):
        t0 = time.perf_counter()
        conn.request("GET", "/noop")
        body = conn.getresponse().read()
        rtt_http.append(time.perf_counter() - t0)
        if json.loads(body) != {"result": None}:
            raise AssertionError(f"(f) HTTP no-op answered {body!r}")
    conn.close()
    walls = {"direct": [], "serve": []}
    for how in ("direct", "serve", "serve", "direct"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "direct":
            again = main["backend"]([ServeRequest((p,), {
                "max_new_tokens": NEW_TOKENS}) for p in prompts])
        else:
            again = rt.get([h.remote(p, max_new_tokens=NEW_TOKENS)
                            for p in prompts])
        torch.cuda.synchronize()
        walls[how].append(time.perf_counter() - t0)
        if again != want:
            raise AssertionError(f"(f) {how} batch: tokens differ from "
                                 f"phase 3's")
    ep = serve.stat()["metrics"]["endpoints"]["gen"]

    def exported():
        text = rt_metrics.render_prometheus()
        return ("serve_route_latency_p99_ms" in text
                and "serve_replicas" in text)
    wait_until("(f) render_prometheus() holds the serve series", exported)
    log(f"  (f) no-op round trip over {SERVE_CALLS}: handle "
        f"{pct_us(rtt_h)}, HTTP (keep-alive) {pct_us(rtt_http)}; the "
        f"12-request batch's wall, direct "
        f"{[round(1e3 * s, 3) for s in walls['direct']]} ms, through serve "
        f"{[round(1e3 * s, 3) for s in walls['serve']]} ms (turns direct, "
        f"serve, serve, direct); stat() for 'gen': {ep['count']} requests, "
        f"p50 {ep['latency_ms_p50']} ms, p99 {ep['latency_ms_p99']} ms; "
        f"render_prometheus() holds serve_route_latency_p99_ms and "
        f"serve_replicas [{card}]")

    # (g) Teardown.
    serve.shutdown()
    rt.shutdown()

    def left():
        return [t.name for t in threading.enumerate()
                if t not in threads_before and t.name.startswith(
                    RUNTIME_THREADS + SERVE_THREADS)]
    wait_until(f"(g) threads alive after shutdown: {left()}",
               lambda: not left(), timeout=30)
    margin = direct_growth // 2
    mem_end = mem_now()
    if mem_end - mem_start > margin:
        raise AssertionError(
            f"(g) the card holds {mem_end - mem_start} bytes more than "
            f"before phase 10 (margin {margin}: half a replica)")
    log(f"  (g) serve.shutdown() and shutdown(): no serve-reconcile, "
        f"serve-http, lm-engine-pump or runtime thread left; device memory "
        f"{(mem_end - mem_start) / 2**20:+.1f} MiB against before phase 10 "
        f"(margin {margin / 2**20:.1f} MiB, half a replica)")
    log(f"  phase 10 in {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------ main


# ---------------------------------------- phase 11: the cluster on the card


# The cluster: a head of 8 CPUs and the card with its colocated node
# controller, and three nodes of 2 CPUs, so that a placement tick takes the
# matrix path from 257 entries (len(entries) * alive nodes > 1024). The
# burst: 2 waves of 5,000 no-op tasks, each gated on one task that the
# driver lets go only once the GCS holds the whole wave waiting on it, so
# that a wave reaches the placement loop as one tick (the first cold, the
# second on the card);
# the map stage: 8 mappers of 4 MiB each (above the inline limit, so the GCS
# directory holds their sizes).
CL_HEAD = {"CPU": 8, "GPU": 1}
CL_NODES, CL_NODE = 3, {"CPU": 2}
CL_KNOBS = {"RAY_TPU_TORCH_PG_KERNEL": "1", "RAY_TPU_TORCH_REASON_KERNEL": "1",
            "RAY_TPU_TORCH_LOCALITY_KERNEL": "1"}
CL_WAVES, CL_WAVE = 2, 5000
CL_MAPS, CL_MAP_BYTES = 8, 4 * 2**20
CL_IN_BUNDLE = 0.5         # CPUs a task in a 1-CPU bundle asks (C9)
CL_PASSES = ("place", "warmup", "gang", "reason", "locality")
CL_TENSOR = 64 * 2**20     # float32 elements: 256 MiB


class ClusterServer(Server):
    """Phase 11's GPU actor, in a worker process of the cluster: phase 9's
    Server, and the kernel launches of a call counted in its own process."""

    def __init__(self, params, cfg):
        t0 = time.perf_counter()
        super().__init__(params, cfg)
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0

    def ready(self) -> tuple:
        leaves = named_leaves(self.params)
        return (self.build_s, os.getpid(), len(leaves),
                sum(t.nbytes for t in leaves.values()),
                {str(t.device) for t in leaves.values()})

    def serve_counted(self, prompts, n) -> tuple:
        reset_counts()
        outs = self.serve(prompts, n)
        return outs, read_counts(), self.probed()

    def serve_timed(self, prompts, n) -> tuple:
        """The batch timed inside the worker process: its outputs, wall,
        ticks' median wall and the process's CPU time."""
        k = len(self.probe.ticks)
        outs, wall, cpu = timed_batch(lambda: self.serve(prompts, n))
        return outs, wall, median_tick_ms(self.probe.ticks[k:]), cpu


def timed_batch(run) -> tuple:
    """run()'s outputs, its wall in s, and the CPU time in s that this
    process's threads took meanwhile."""
    torch.cuda.synchronize()
    c0, t0 = time.process_time(), time.perf_counter()
    outs = run()
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, time.process_time() - c0


def median_tick_ms(ticks) -> float:
    """Median host wall of a PathProbe's decode ticks, synchronize to
    synchronize."""
    return float(np.median([ms for _, ms in ticks])) if ticks else float("nan")


def cl_gate(path):
    """Returns once ``path`` exists (at most 120 s), or at once when its
    folder is gone: the wave it gated is over. A leader promoted after a
    failover runs again the tasks its table holds as dispatched, earlier
    waves' gates among them; each would otherwise poll its removed path
    for 120 s on a worker the next wave's gate needs (phase 16 (b))."""
    deadline = time.monotonic() + 120.0
    while not os.path.exists(path) and time.monotonic() < deadline:
        if not os.path.isdir(os.path.dirname(path)):
            break
        time.sleep(0.005)
    return 0


def gated_wave(fn, n: int, what: str) -> tuple:
    """``n`` tasks of ``fn`` on one gate task, let go once the GCS holds all
    of them waiting for it, so that they reach its placement loop as one
    tick. A gate of fixed length split a wave whenever the GCS read the
    submits slower than the gate ran. (refs, the gate's ref, submit s)."""
    folder = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    path = os.path.join(folder, "open")
    g = rt.remote(cl_gate).remote(path)
    t0 = time.perf_counter()
    refs = [fn.remote(g) for _ in range(n)]
    sub_s = time.perf_counter() - t0

    # Polled at 10 Hz: each poll scans the GCS's whole task table.
    deadline = time.monotonic() + 120.0
    while rt.state.summarize_tasks()["pending_reasons"].get(
            "waiting-for-deps", 0) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: the GCS did not hold the wave's "
                                 f"{n} tasks on the gate within 120 s")
        time.sleep(0.1)
    open(path, "w").close()
    try:
        rt.get(g, timeout=60)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return refs, g, sub_s


def cl_noop(x=None):
    return None


def cl_home():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().core._home_addr


def cl_map(i):
    return cl_home(), np.full(CL_MAP_BYTES // 8, i, np.int64)


def cl_reduce(part):
    return cl_home(), int(part[1][0])


def cl_double(x):
    t0 = time.perf_counter()
    y = x * 2
    torch.cuda.synchronize()
    return y, cl_home(), str(x.device), time.perf_counter() - t0


def port_procs(roots=None) -> set:
    """Pids of the descendants of ``roots`` (default: this process), the
    roots included, that run the port's cluster modules (the head, the
    nodes and their workers)."""
    parent, cmds = {}, {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmds[int(pid)] = f.read()
        except OSError:
            continue
        if stat[0] != "Z":
            parent[int(pid)] = int(stat[1])
    mine, grew = set(roots or {os.getpid()}), True
    while grew:
        more = {p for p, pp in parent.items() if pp in mine} - mine
        mine |= more
        grew = bool(more)
    return {p for p in mine if b"ray_tpu_torch.cluster" in cmds.get(p, b"")}


def alive(pids: set) -> set:
    out = set()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] != "Z":
                    out.add(pid)
        except OSError:
            pass
    return out


def port_segments() -> set:
    return {n for n in os.listdir("/dev/shm")
            if n.startswith(("rtts-", "rttr-"))}


def spill_dirs() -> set:
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_spill")
    return set(os.listdir(base)) if os.path.isdir(base) else set()


def gcs_stats() -> dict:
    return global_core().gcs.call({"type": "debug_stats"})


def kernel_cells(stats: dict) -> dict:
    return {k: v["count"] for k, v in stats["handlers"].items()
            if k.startswith(("kernel:", "kernel_fallback:"))}


def cluster_start(cluster, shm0: set, t0: float, card: str) -> None:
    """(a) The head (GCS on the card, colocated controller) and three
    nodes; every node with the native arena and a transfer server, the
    GCS's frame pump native, and only the port's segment names."""
    head_s = time.perf_counter() - t0
    threads = [threading.Thread(target=cluster.add_node,
                                args=(dict(CL_NODE), 1))
               for _ in range(CL_NODES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cluster.wait_for_nodes(CL_NODES + 1)
    start_s = time.perf_counter() - t0
    rt.init(address=cluster.address)
    nodes = [n for n in rt.nodes() if n["Alive"]]
    total = rt.cluster_resources()
    if len(nodes) != CL_NODES + 1 or total.get("GPU") != 1 \
            or total.get("CPU") != CL_HEAD["CPU"] + CL_NODES * CL_NODE["CPU"]:
        raise AssertionError(f"(a) nodes {nodes}, resources {total}")
    from ray_tpu_torch._native import ShmObjectStore, open_store

    arenas, ports = [], []
    for n in nodes:
        name, port = n.get("StoreName", ""), n.get("TransferPort", 0)
        store = open_store(name) if name else None
        if not isinstance(store, ShmObjectStore):
            raise AssertionError(f"(a) node {n['NodeID'][:12]}: arena "
                                 f"{name!r} is {type(store).__name__}")
        arenas.append(name)
        ports.append(port)
        store.close()
        if not port or port <= 0:
            raise AssertionError(f"(a) node {n['NodeID'][:12]}: no transfer "
                                 f"server (port {port})")
    stats = gcs_stats()
    if stats["recv_stats"].get("native") != 1:
        raise AssertionError(f"(a) the GCS's frame pump is not native: "
                             f"{stats['recv_stats']}")
    new = set(os.listdir("/dev/shm")) - shm0
    foreign = sorted(n for n in new if n.startswith(("rtps-", "rtcr-")))
    if foreign or not new <= port_segments():
        raise AssertionError(f"(a) segments {sorted(new)}: foreign {foreign}")
    log(f"  (a) head (GCS on {stats['place_perf']['device']}, colocated "
        f"controller) up in {head_s:.3f} s, {CL_NODES} nodes more, all "
        f"{len(nodes)} alive in {start_s:.3f} s; resources {total}; native "
        f"arenas {arenas}, transfer ports {ports}; GCS frame pump native "
        f"({stats['recv_stats']}); this run's segments {sorted(new)}, none "
        f"with a JAX prefix")


def cluster_round_trips(card: str) -> dict:
    """(b) No-op task and actor-call round trips, and a 10k fan-out."""
    fn = rt.remote(noop)
    echo = rt.remote(Echo).remote()
    rt.get([fn.remote() for _ in range(100)] + [echo.m.remote()], timeout=120)
    task_rtt, actor_rtt = [], []
    for _ in range(RT_CALLS):
        t0 = time.perf_counter()
        rt.get(fn.remote(), timeout=60)
        task_rtt.append(time.perf_counter() - t0)
    for _ in range(RT_CALLS):
        t0 = time.perf_counter()
        rt.get(echo.m.remote(), timeout=60)
        actor_rtt.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    out = rt.get([fn.remote() for _ in range(RT_FANOUT)], timeout=600)
    fanout_s = time.perf_counter() - t0
    if out != [None] * RT_FANOUT:
        raise AssertionError("(b) the fan-out's results are wrong")
    rt.kill(echo)
    log(f"  (b) no-op task submit -> get round trip over {RT_CALLS}: "
        f"{pct_us(task_rtt)}; actor call round trip: {pct_us(actor_rtt)}; "
        f"{RT_FANOUT} no-op fan-out: {RT_FANOUT / fanout_s:.1f} tasks/s "
        f"[{card}]")
    return {"task_rtt": task_rtt, "actor_rtt": actor_rtt,
            "fanout_tps": RT_FANOUT / fanout_s}


def cluster_placement(card: str):
    """(c) A gated burst whose ticks take the matrix path on the card; a
    STRICT_SPREAD group (gang pass), an infeasible task (reason pass) and a
    map stage (locality pass). Every pass counted on the card, none fell
    back. Returns the group, whose bundles (e) uses."""
    fn = rt.remote(cl_noop)
    waves, routes = [], []
    for w in range(CL_WAVES):
        t0 = time.perf_counter()
        refs, g, sub_s = gated_wave(fn, CL_WAVE, f"(c) wave {w}")
        if rt.get(refs, timeout=600) != [None] * CL_WAVE:
            raise AssertionError(f"(c) wave {w}: results are wrong")
        wall_s = time.perf_counter() - t0
        # The driver reads the gate's ref too: while a direct-call ref
        # stays unobserved, no idle lease goes back (ROADMAP C9), and (d)'s
        # GPU task would wait behind a GPU lease taken at the kill.
        rt.get(g, timeout=60)
        stats = gcs_stats()
        cells = kernel_cells(stats)
        numpy_ticks = sum(v["samples"] for k, v in stats["place_perf"].items()
                          if k.startswith("numpy:"))
        routes.append((cells.get("kernel:place", 0), numpy_ticks))
        waves.append((round(sub_s, 3), round(wall_s, 3)))
        if w == 0:
            # The first wave's bucket is cold: the GCS serves it on numpy
            # and warms the kernel on a thread. The next wave waits for
            # the warm-up, as traffic that keeps coming would.
            wait_until("(c) the GCS's warm-up of the wave's bucket",
                       lambda: kernel_cells(gcs_stats()), timeout=120)
    perf = stats["place_perf"]
    buckets = sorted({int(k.split(":")[1]) for k in perf if ":" in k})
    steps = [(k - k0, n - n0) for (k, n), (k0, n0)
             in zip(routes, [(0, 0)] + routes[:-1])]
    log(f"  (c) {CL_WAVES} waves of {CL_WAVE} no-op tasks, each gated on one "
        f"task, {CL_WAVES * CL_WAVE} in all: (submit s, wave "
        f"wall s) {waves}; matrix ticks of each wave (on the card, on "
        f"numpy) {steps}")
    log(f"  (c) matrix ticks by bucket (T rounded up to a power of two) "
        f"{buckets}; the GCS's per-bucket EMAs {perf}; device passes "
        f"{cells}; phase:gcs_place {stats['handlers']['phase:gcs_place']} "
        f"[{card}]")
    if perf.get("device", "").split(":")[0] != DEVICE:
        raise AssertionError(f"(c) the place device is {perf.get('device')}")
    if not cells.get("kernel:place") or not cells.get("kernel:warmup"):
        raise AssertionError(f"(c) the placement pass never ran on the "
                             f"card: {cells}")

    pg = rt.placement_group([{"CPU": 1}] * (CL_NODES + 1),
                            strategy="STRICT_SPREAD")
    if not pg.wait(60):
        raise AssertionError(f"(c) STRICT_SPREAD group: "
                             f"{rt.placement_group_table(pg)}")
    row = rt.placement_group_table(pg)[pg.id.hex()]
    addr = {n["NodeID"]: tuple(n["Address"]) for n in rt.nodes()}
    head = driver_node()
    other = next((i for i, n in enumerate(row["nodes"]) if n != head), None)
    if len(set(row["nodes"])) != CL_NODES + 1 or other is None:
        raise AssertionError(f"(c) STRICT_SPREAD group: {row}")
    bad = rt.remote(cl_noop).options(num_cpus=64).remote()
    wait_until("(c) the infeasible task's reason", lambda: any(
        r["pending_reason"] == "infeasible"
        for r in rt.state.tasks(name_contains="cl_noop", state="PENDING")))
    rt.cancel(bad)
    # The map stage: every mapper in the group's bundle on a node other
    # than the head; the reducers, placed freely, must follow their input.
    # They ask 1/8 CPU each, so that all fit in the one CPU the node has
    # beside the bundle: the hint decides where they run, not a queue.
    # A bundle task asks half the bundle's CPU: the driver's direct-call
    # lease for that resource class, taken at the first submit, holds the
    # other half (ROADMAP C9).
    data_node = addr[row["nodes"][other]]
    maps = [rt.remote(cl_map).options(
        placement_group=pg, placement_group_bundle_index=other,
        num_cpus=CL_IN_BUNDLE).remote(i) for i in range(CL_MAPS)]
    rt.wait(maps, num_returns=CL_MAPS, timeout=120)
    reds = rt.get([rt.remote(cl_reduce).options(
        num_cpus=1 / CL_MAPS).remote(m) for m in maps], timeout=120)
    where = {tuple(h) for h, _ in rt.get(maps, timeout=120)} | \
        {tuple(h) for h, _ in reds}
    if [i for _, i in reds] != list(range(CL_MAPS)) or where != {data_node}:
        raise AssertionError(f"(c) mappers and reducers ran on {where}, "
                             f"the data's node is {data_node}")
    cells = kernel_cells(gcs_stats())
    missing = [p for p in CL_PASSES if not cells.get(f"kernel:{p}")]
    fell = {k: c for k, c in cells.items() if k.startswith("kernel_fallback")}
    if missing or fell:
        raise AssertionError(f"(c) passes not on the card {missing}, "
                             f"fallbacks {fell}")
    log(f"  (c) STRICT_SPREAD group of {CL_NODES + 1} bundles "
        f"{row['state']}, one on each node; an infeasible task's reason "
        f"'infeasible'; {CL_MAPS} mappers in the bundle on node "
        f"{row['nodes'][other][:12]} (not the head), their {CL_MAPS} "
        f"reducers all placed on that node by the locality pass; device "
        f"passes {cells}, no fallback")
    return pg, other


def cluster_flagship(params, cfg, main: dict, card: str) -> None:
    """(d) The flagship LMBackend in a GPU actor in a worker process, its
    parameters through the arena; a GPU task pending until kill(); the
    card's memory back when the worker process dies."""
    L = cfg.n_layers
    prompts = serving_prompts(cfg.vocab_size)
    want_outs = main["outs"]
    leaves = named_leaves(params)
    param_bytes = sum(t.nbytes for t in leaves.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pref = rt.put(params)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server = rt.remote(num_gpus=1)(ClusterServer).remote(pref, cfg)
    build_s, pid, n_leaves, nbytes, devs = rt.get(server.ready.remote(),
                                                  timeout=600)
    ready_s = time.perf_counter() - t0
    if pid == os.getpid() or n_leaves != len(leaves) \
            or nbytes != param_bytes or devs != {"cuda:0"}:
        raise AssertionError(f"(d) actor pid {pid}, {n_leaves} tensors, "
                             f"{nbytes} bytes on {devs}")
    outs, launches, (n_pre, n_tick, ticks) = rt.get(
        server.serve_counted.remote(prompts, NEW_TOKENS), timeout=600)
    if outs != want_outs:
        bad = [i for i, (a, b) in enumerate(zip(outs, want_outs)) if a != b]
        raise AssertionError(f"(d) the actor's tokens differ from phase 3's "
                             f"in requests {bad}")
    want = {"rms_norm": n_pre + n_tick,
            "add_rms_norm": 2 * L * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    got = {n: c for n, c in launches.items() if c}
    per_tick = {"rms_norm": 1, "add_rms_norm": 2 * L, "decode_attention": L}
    if got != want or not n_tick or any(
            {n: c for n, c in t.items() if c} != per_tick for t in ticks):
        raise AssertionError(f"(d) launches {got}, expected {want}; every "
                             f"tick {per_tick}")
    log(f"  (d) {n_leaves} parameter tensors ({param_bytes / 2**20:.1f} MiB) "
        f"through the arena in a put of {put_s:.3f} s; the num_gpus=1 "
        f"ClusterServer in worker process {pid} built LMBackend in "
        f"{build_s:.3f} s ({ready_s:.3f} s from submit to ready, the "
        f"process's start and the parameters' copy to the card included); "
        f"phase 3's 12 requests: phase 3's tokens; {n_pre} prefills, "
        f"{n_tick} ticks, launches counted in the actor's process {got}, "
        f"every tick {per_tick}")
    # Each turn's wall as the driver sees it, and inside the process that
    # serves: the batch's wall, its ticks' median wall and the process's
    # CPU time, so that the actor's cost splits into the call and the work
    # in the worker process.
    walls = {"direct": [], "actor": []}
    probe = main["probe"]
    for how in ("direct", "actor", "actor", "direct"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "direct":
            k = len(probe.ticks)
            again, inner, cpu = timed_batch(lambda: main["backend"]([
                ServeRequest((p,), {"max_new_tokens": NEW_TOKENS})
                for p in prompts]))
            tick = median_tick_ms(probe.ticks[k:])
        else:
            again, inner, tick, cpu = rt.get(
                server.serve_timed.remote(prompts, NEW_TOKENS), timeout=600)
        torch.cuda.synchronize()
        walls[how].append((round(1e3 * (time.perf_counter() - t0), 3),
                           round(1e3 * inner, 3), round(tick, 3),
                           round(1e3 * cpu, 3)))
        if again != want_outs:
            raise AssertionError(f"(d) {how} batch: tokens differ")
    for how in ("direct", "actor"):
        log(f"  (d) the 12-request batch {how} (turns direct, actor, actor, "
            f"direct): (driver's wall ms, wall ms in the serving process, "
            f"median tick ms, the process's CPU ms) {walls[how]} [{card}]")
    log(f"  (d) {os.cpu_count()} cores; {len(port_procs())} port processes")

    x, w = rms_inputs(64, torch.bfloat16, seed=9)
    held = rt.available_resources().get("GPU", 0.0)
    ref = rt.remote(num_gpus=1)(k1_task).remote(rt.put(x), w)
    ready, _ = rt.wait([ref], timeout=2.0)
    row = rt.state.tasks(name_contains="k1_task")[0]
    head_workers = global_core()._home_controller().call(
        {"type": "stats"})["workers"]
    running = [w for w in head_workers if "k1_task" in (w["task"] or "")]
    # The GCS places a task it cannot admit now on a node whose totals fit
    # it (queue-at-node), so its reason in the GCS is empty: it must be
    # dispatched to the head, the one node with a GPU, and run on none of
    # the head's workers, held in the controller's queue for the GPU. A
    # task still in the GCS must carry a reason.
    at_head = row["state"] == "DISPATCHED" and not running \
        and row["node_id"] == driver_node()
    in_gcs = row["state"] == "PENDING" and bool(row["pending_reason"])
    if ready or held != 0.0 or not (at_head or in_gcs):
        raise AssertionError(f"(d) the GPU task did not wait for the actor: "
                             f"ready {ready}, GPU available {held}, {row}, "
                             f"the head's workers {head_workers}")
    cache_bytes = rt.get(server.cache_bytes.remote())
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    rt.kill(server)
    wait_until("(d) the card's memory back after kill()",
               lambda: torch.cuda.mem_get_info()[0] - free0 >= cache_bytes,
               timeout=30)
    back_s = time.perf_counter() - t0
    back = torch.cuda.mem_get_info()[0] - free0
    wait_until(f"(d) the actor's worker process {pid} gone after kill()",
               lambda: not alive({pid}), timeout=30)
    try:
        _, k1_out = rt.get(ref, timeout=120)
    except rt.exceptions.GetTimeoutError:
        raise AssertionError(
            f"(d) the GPU task did not run after kill(): "
            f"{rt.state.tasks(name_contains='k1_task')}, GPU available "
            f"{rt.available_resources().get('GPU', 0.0)}, the head's workers "
            f"{global_core()._home_controller().call({'type': 'stats'})}")
    err = check_close("(d) the GPU task's rms_norm [64, 1024] bfloat16",
                      k1_out.to("cuda"), fused._rms_norm_ref(x, w, EPS),
                      atol=2e-2, rtol=2e-2)
    log(f"  (d) num_gpus=1 task pending while the actor held the card "
        f"(GPU available {held}; state {row['state']} on node "
        f"{row['node_id'][:12]} (the head), reason {row['pending_reason']!r}, "
        f"on none of the head's {len(head_workers)} workers); kill(): the "
        f"card's free memory (device-wide) up {back / 2**20:.1f} MiB within "
        f"{back_s:.3f} s "
        f"(the actor's KV cache {cache_bytes / 2**20:.1f} MiB); then the task "
        f"ran, err {err:.3e}")


def cluster_cuda_tensor(pg, other: int, card: str) -> None:
    """(e) A 256 MiB CUDA tensor put by the driver, doubled by a task in the
    group's bundle on a node other than the head, and got back with its
    bits."""
    head = tuple(global_core()._home_addr)
    big = torch.randn(CL_TENSOR, generator=cuda_gen(SEED + 11),
                      device="cuda")
    nbytes = big.nbytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = big.cpu()
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = host.to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del host, again
    t0 = time.perf_counter()
    bref = rt.put(big)
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = rt.remote(cl_double).options(
        placement_group=pg, placement_group_bundle_index=other,
        num_cpus=CL_IN_BUNDLE).remote(bref)
    rt.wait([out], timeout=120)
    task_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y, where, xdev, dbl_s = rt.get(out, timeout=120)
    get_s = time.perf_counter() - t0
    if y.device.type != "cuda" or xdev != "cuda:0" or tuple(where) == head or \
            not torch.equal(y.view(torch.int32), (big * 2).view(torch.int32)):
        raise AssertionError(f"(e) the doubled tensor: device {y.device}, "
                             f"task's input on {xdev}, node {where}")
    gb = 1e9
    log(f"  (e) 256 MiB CUDA tensor: the driver's D2H copy alone "
        f"{nbytes / gb / d2h_s:.3f} GB/s, H2D alone "
        f"{nbytes / gb / h2d_s:.3f} GB/s; put (D2H into the head's arena) "
        f"{nbytes / gb / put_s:.3f} GB/s; the task on node {where} (pulls it "
        f"across, copies it to the card, doubles it, {dbl_s * 1e3:.3f} ms, "
        f"copies it back off) done in {task_s:.3f} s "
        f"({2 * nbytes / gb / task_s:.3f}"
        f" GB/s of both copies); get (transfer to the head's arena and H2D) "
        f"{nbytes / gb / get_s:.3f} GB/s; the bits equal 2 x the input "
        f"[{card}]")
    return nbytes / gb / task_s


def global_core():
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().core


def driver_node() -> str:
    """The node id of the driver's node (the head's colocated controller)."""
    home = tuple(global_core()._home_addr)
    return next(n["NodeID"] for n in rt.nodes()
                if tuple(n["Address"]) == home)


def cluster_liveness() -> None:
    """(f) Every node lived through the phase. C16: a stall of the GCS's
    loop past the heartbeat timeout once made its checker declare all four
    nodes dead at once, and (d)'s task then waited for ever on a put whose
    only copy lay on a node the GCS counted as dead."""
    core = global_core()
    downs = core.cluster_events(kind="node_down")
    stalls = [e["seconds"] for e in core.cluster_events(kind="gcs_stall")]
    slow = core.gcs.call({"type": "get_loop_stats"})["slow"].get("gcs", [])
    if downs:
        raise AssertionError(f"(f) nodes declared dead during the phase: "
                             f"{downs}; the GCS loop's stalls (s) {stalls}, "
                             f"its slowest callbacks {slow[:5]}")
    log(f"  (f) no node declared dead during the phase; the heartbeat "
        f"checker held up (s) {stalls}; the GCS loop's slowest callbacks "
        f"(name, count, total s, max s) {slow[:3]}")


def cluster_teardown(cluster, shm0: set, spill0: set, card: str) -> None:
    """(f) shutdown() and the cluster's shutdown leave no process, segment
    or spill directory of the port."""
    procs = port_procs()
    t0 = time.perf_counter()
    rt.shutdown()
    cluster.shutdown()
    wait_until(f"(f) port processes alive: {alive(procs)}",
               lambda: not alive(procs), timeout=30)
    left_shm = port_segments() - shm0
    left_spill = spill_dirs() - spill0
    if left_shm or left_spill:
        raise AssertionError(f"(f) left behind: segments {left_shm}, spill "
                             f"directories {left_spill}")
    log(f"  (f) shutdown in {time.perf_counter() - t0:.3f} s: none of the "
        f"{len(procs)} port processes (head, nodes, workers) alive, no "
        f"/dev/shm segment or spill directory left")


def cluster_path(params, cfg, main: dict, card: str) -> dict:
    """Phase 11: the cluster runtime on the card (see the docstring)."""
    log(f"phase 11: the cluster runtime (init(address=...), GCS, node "
        f"controllers, worker processes) with the GCS placing on the card "
        f"[{card}]")
    from ray_tpu_torch.cluster.testing import Cluster

    t_phase = time.perf_counter()
    spill0, shm0 = spill_dirs(), set(os.listdir("/dev/shm"))
    t0 = time.perf_counter()
    cluster = Cluster(head_resources=CL_HEAD, num_workers=2,
                      extra_env=CL_KNOBS)
    try:
        cluster_start(cluster, shm0, t0, card)
        rates = {"fanout_tps": cluster_round_trips(card)["fanout_tps"]}
        pg, other = cluster_placement(card)
        cluster_flagship(params, cfg, main, card)
        rates["tensor_gbps"] = cluster_cuda_tensor(pg, other, card)
        rt.remove_placement_group(pg)
        cluster_liveness()
    except BaseException:
        rt.shutdown()
        cluster.shutdown()
        raise
    cluster_teardown(cluster, shm0, spill0, card)
    log(f"  phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return rates


# -------------------------------------------- phase 12: the operator's path


# The CLI-started cluster: a head of 4 CPUs and the card, one node of 2
# CPUs. A burst tick takes the matrix path from 513 entries with 2 alive
# nodes (len(entries) * alive nodes > 1024): 2 waves of 5,000 gated no-op
# tasks, as phase 11's.
OP_HEAD, OP_NODE = {"CPU": 4, "GPU": 1}, {"CPU": 2}
OP_WAVES, OP_WAVE = 2, 5000
OP_ACTOR = "chip_smoke:CapiServer"     # the C host's actor class
HERE = os.path.dirname(os.path.abspath(__file__))


class CapiServer(Server):
    """Phase 12's actor, created by the C host through the C API with the
    seed as its one JSON argument: phase 9's Server over the flagship
    parameters made from that seed in the actor's own process. Its methods
    take and return JSON values."""

    def __init__(self, seed):
        t0 = time.perf_counter()
        self.cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
        super().__init__(init_params(cuda_gen(seed), self.cfg,
                                     device="cuda"), self.cfg)
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0

    def ready(self) -> dict:
        return {"build_s": self.build_s, "pid": os.getpid(),
                "cache_bytes": self.cache_bytes()}

    def serve_json(self, n) -> dict:
        """Phase 3's 12 requests: the tokens, the batch's wall in this
        process, and the kernel launches counted here, in all and by
        tick."""
        prompts = serving_prompts(self.cfg.vocab_size)
        self.probed()                   # drop the warm-up's forwards
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = self.serve(prompts, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        n_pre, n_tick, ticks = self.probed()
        return {"tokens": [[int(t) for t in o] for o in outs],
                "wall_ms": 1e3 * wall, "launches": launches,
                "prefills": n_pre, "ticks": n_tick,
                "tick_launches": ticks}


def op_cli(env: dict, *args, check: bool = True):
    """One ``python -m ray_tpu_torch.scripts.cli`` call: (result, wall s).
    A failed call fails the phase unless ``check`` is False."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if check and out.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} exited "
                             f"{out.returncode}: {out.stdout[-2000:]}"
                             f"{out.stderr[-2000:]}")
    return out, wall


def op_session(env: dict) -> dict:
    with open(env["RAY_TPU_TORCH_SESSION_FILE"]) as f:
        return json.load(f)


def op_start(env: dict, card: str) -> str:
    """(a) The head and a node through the CLI; status; the GCS places on
    the card, and a burst's ticks run there. Returns the head's address."""
    out, head_s = op_cli(env, "start", "--head", "--num-workers", "2",
                         "--resources", json.dumps(OP_HEAD))
    addr = op_session(env)["address"]
    _, node_s = op_cli(env, "start", "--address", addr, "--num-workers",
                       "1", "--resources", json.dumps(OP_NODE))
    t0 = time.perf_counter()
    rt.init(address=addr)
    wait_until("(a) both nodes alive", lambda: sum(
        n["Alive"] for n in rt.nodes()) == 2, timeout=120)
    join_s = time.perf_counter() - t0
    status, status_s = op_cli(env, "status")
    if not re.search(r"^nodes: 2 alive / 2$", status.stdout, re.M) or \
            "'GPU': 1.0" not in status.stdout.split(
                "total resources:")[1].splitlines()[0]:
        raise AssertionError(f"(a) cli status: {status.stdout}")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch"], check=True)
    torch_s = time.perf_counter() - t0
    device = gcs_stats()["place_perf"].get("device", "")
    if device.split(":")[0] != DEVICE:
        raise AssertionError(f"(a) the CLI-started GCS places on {device!r}")
    log(f"  (a) cli start --head (no --device) {head_s:.3f} s, cli start "
        f"--address {node_s:.3f} s, the node alive {join_s:.3f} s later; "
        f"cli status {status_s:.3f} s: 2 alive nodes, total "
        f"{status.stdout.split('total resources:')[1].splitlines()[0].strip()}"
        f"; the GCS places on {device}; a bare `python -c 'import torch'` "
        f"{torch_s:.3f} s [{card}]")
    fn = rt.remote(cl_noop)
    walls = []
    for w in range(OP_WAVES):
        t0 = time.perf_counter()
        refs, g, _ = gated_wave(fn, OP_WAVE, f"(a) wave {w}")
        if rt.get(refs, timeout=600) != [None] * OP_WAVE:
            raise AssertionError(f"(a) wave {w}: results are wrong")
        walls.append(round(time.perf_counter() - t0, 3))
        if w == 0:
            wait_until("(a) the GCS's warm-up of the wave's bucket",
                       lambda: kernel_cells(gcs_stats()), timeout=120)
    cells = kernel_cells(gcs_stats())
    fell = {k: c for k, c in cells.items() if k.startswith("kernel_fallback")}
    if not cells.get("kernel:place") or fell:
        raise AssertionError(f"(a) device passes {cells}")
    log(f"  (a) {OP_WAVES} waves of {OP_WAVE} gated no-op tasks, walls "
        f"{walls} s; device passes {cells}, no fallback [{card}]")
    return addr


def op_build_host() -> str:
    """The C API and the C host, built from the checkout."""
    from ray_tpu_torch._native import build as native_build

    t0 = time.perf_counter()
    exe = native_build.build_c_host(
        os.path.join(HERE, "ray_tpu_torch", "_native", "src",
                     "capi_actor.c"), "capi_actor")
    if exe is None:
        import sysconfig

        errs = [open(p).read() for p in (
            os.path.join(native_build._BUILD_DIR, n + ".err")
            for n in ("libray_tpu_torch_c.so", "capi_actor"))
            if os.path.exists(p)]
        raise AssertionError(
            f"(b) the C API or the C host did not build: LIBDIR "
            f"{sysconfig.get_config_var('LIBDIR')}, LDVERSION "
            f"{sysconfig.get_config_var('LDVERSION')}, Py_ENABLE_SHARED "
            f"{sysconfig.get_config_var('Py_ENABLE_SHARED')}; {errs}")
    log(f"  (b) built libray_tpu_torch_c.so and capi_actor in "
        f"{time.perf_counter() - t0:.1f} s")
    return exe


def op_capi(addr: str, main: dict, card: str):
    """(b) The C host creates CapiServer in the cluster and serves phase
    3's requests through it. Returns the running host, its results' refs,
    the actor's hex and its KV cache's bytes."""
    exe = op_build_host()
    L = FLAGSHIP["n_layers"]
    env = dict(os.environ)
    # The embedded interpreter finds the port, chip_smoke and this
    # interpreter's packages on its path.
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in sys.path if p and os.path.isdir(p)])
    t0 = time.perf_counter()
    host = subprocess.Popen(
        [exe, addr, OP_ACTOR, json.dumps([SEED]), "ready",
         "[]", "serve_json", json.dumps([NEW_TOKENS])],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    lines = []
    while not lines or not lines[-1].startswith("ALIVE"):
        line = host.stdout.readline()
        if not line:
            host.kill()
            raise AssertionError(f"(b) the C host ended: {lines} "
                                 f"{host.stderr.read()[-4000:]}")
        lines.append(line.strip())
    first_s = time.perf_counter() - t0
    (_, _, ready_ms, ready), (_, ref2, serve_ms, served) = (
        ln.split(" ", 3) for ln in lines[:2])
    ready, served = json.loads(ready), json.loads(served)
    actor = lines[2].split()[1]
    if served["tokens"] != main["outs"]:
        bad = [i for i, (a, b) in enumerate(zip(served["tokens"],
                                                main["outs"])) if a != b]
        raise AssertionError(f"(b) the C-hosted actor's tokens differ from "
                             f"phase 3's in requests {bad}")
    n_pre, n_tick = served["prefills"], served["ticks"]
    per_tick = {"rms_norm": 1, "add_rms_norm": 2 * L, "decode_attention": L}
    want = {"rms_norm": n_pre + n_tick,
            "add_rms_norm": 2 * L * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    got = {n: c for n, c in served["launches"].items() if c}
    if got != want or not n_tick or any(
            {n: c for n, c in t.items() if c} != per_tick
            for t in served["tick_launches"]):
        raise AssertionError(f"(b) launches {got}, expected {want}; every "
                             f"tick {per_tick}")
    log(f"  (b) the C host (ray_tpu_init, ray_tpu_actor_create, "
        f"ray_tpu_actor_call_json) created {OP_ACTOR} in worker "
        f"process {ready['pid']}, which built the flagship LMBackend in "
        f"{ready['build_s']:.3f} s (the C host's first call back after "
        f"{float(ready_ms):.3f} ms, {first_s:.3f} s from the host's start); "
        f"phase 3's 12 requests: phase 3's tokens; {n_pre} prefills, "
        f"{n_tick} ticks, launches counted in the actor's process {got}, "
        f"every tick {per_tick}; the batch's wall {served['wall_ms']:.3f} ms "
        f"at the actor, {float(serve_ms):.3f} ms at the C host (call to "
        f"get) [{card}]")
    refs = [ln.split()[1] for ln in lines[:2]]
    return host, refs, actor, ready["cache_bytes"]


def op_read(env: dict, refs: list, actor: str, card: str) -> None:
    """(c) The cluster read through the CLI and a dashboard while the C
    host's actor lives."""
    from ray_tpu_torch.dashboard import start_dashboard

    mem, mem_s = op_cli(env, "memory", "--refs")
    missing = [r for r in refs if r not in mem.stdout]
    if missing:
        raise AssertionError(f"(c) cli memory --refs lacks {missing}: "
                             f"{mem.stdout[-2000:]}")
    tasks, tasks_s = op_cli(env, "tasks", "--kind", "actor")
    row = [ln for ln in tasks.stdout.splitlines()
           if ln.startswith(actor[:16])]
    if not row or " actor " not in row[0]:
        raise AssertionError(f"(c) cli tasks has no creation row of actor "
                             f"{actor}: {tasks.stdout[-2000:]}")
    folded = os.path.join(os.path.dirname(env["RAY_TPU_TORCH_SESSION_FILE"]),
                          "gcs.folded")
    _, prof_s = op_cli(env, "profile", "--component", "gcs", "--seconds",
                       "0", "--out", folded)
    with open(folded) as f:
        n_folded = sum(1 for ln in f if ln.strip())
    if not n_folded:
        raise AssertionError("(c) cli profile wrote an empty folded file")
    dash = start_dashboard()
    try:
        def get(path):
            with urllib.request.urlopen(dash.url + path, timeout=60) as r:
                return r.headers.get("Content-Type"), r.read().decode()
        nodes = json.loads(get("/api/nodes")[1])
        actors = json.loads(get("/api/actors")[1])
        ctype, text = get("/metrics")
    finally:
        dash.stop()
    alive = [n for n in nodes if n["Alive"]]
    gpus = sum(n["Resources"].get("GPU", 0) for n in alive)
    state = next((a["State"] for h, a in actors.items()
                  if h.startswith(actor)), None)
    bad = [ln for ln in text.splitlines() if not re.match(
        r"^(# (HELP|TYPE) \S+ .*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+)$",
        ln)]
    if len(alive) != 2 or gpus != 1 or state != "ALIVE" or bad or \
            "version=0.0.4" not in ctype:
        raise AssertionError(f"(c) dashboard: nodes {nodes}, actor "
                             f"{actor} {state}, /metrics {ctype}, lines "
                             f"that do not parse {bad[:5]}")
    log(f"  (c) while the actor lives: cli memory --refs {mem_s:.3f} s "
        f"lists the C host's refs {refs}; cli tasks {tasks_s:.3f} s: "
        f"{' '.join(row[0].split())}; cli profile --component gcs "
        f"{prof_s:.3f} s wrote {n_folded} folded stacks; the dashboard "
        f"serves {len(alive)} alive nodes with GPU {gpus}, the actor "
        f"{state}, and {len(text.splitlines())} Prometheus lines that "
        f"parse [{card}]")


def op_kill(host, cache_bytes: int, card: str) -> None:
    """(d) ray_tpu_actor_kill, then ray_tpu_shutdown: the card's memory
    comes back."""
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    out, err = host.communicate("\n", timeout=120)
    host_s = time.perf_counter() - t0
    if host.returncode != 0 or out.strip() != "CAPI_ACTOR_OK":
        raise AssertionError(f"(d) the C host: exit {host.returncode}, "
                             f"{out!r} {err[-4000:]}")
    wait_until("(d) the card's memory back after ray_tpu_actor_kill",
               lambda: torch.cuda.mem_get_info()[0] - free0 >= cache_bytes,
               timeout=30)
    back_s = time.perf_counter() - t0
    log(f"  (d) ray_tpu_actor_kill and ray_tpu_shutdown: the C host exited "
        f"after {host_s:.3f} s; the card's free memory (device-wide) up "
        f"{(torch.cuda.mem_get_info()[0] - free0) / 2**20:.1f} MiB within "
        f"{back_s:.3f} s (the actor's KV cache "
        f"{cache_bytes / 2**20:.1f} MiB) [{card}]")


def operator_path(main: dict, card: str) -> None:
    """Phase 12: the operator's path (see the docstring)."""
    log(f"phase 12: the operator's path: a CLI-started cluster whose GCS "
        f"places on the card, a C host serving the flagship LM through the "
        f"C API, the CLI and the dashboard reading it [{card}]")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_operator_")
    env = dict(os.environ)
    env["RAY_TPU_TORCH_SESSION_FILE"] = os.path.join(tmp, "session.json")
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    shm0 = port_segments()
    host, procs = None, set()
    try:
        addr = op_start(env, card)
        state = op_session(env)
        procs = port_procs([state["head_pid"], *state["worker_pids"]])
        host, refs, actor, cache_bytes = op_capi(addr, main, card)
        op_read(env, refs, actor, card)
        rt.shutdown()
        op_kill(host, cache_bytes, card)
    finally:
        if host is not None and host.poll() is None:
            host.kill()
        rt.shutdown()
        t0 = time.perf_counter()
        stop, stop_s = op_cli(env, "stop", check=False)
    wait_until(f"(e) port processes alive after cli stop: {alive(procs)}",
               lambda: not alive(procs), timeout=30)
    left = port_segments() - shm0
    if stop.returncode != 0 or left or \
            os.path.exists(env["RAY_TPU_TORCH_SESSION_FILE"]):
        raise AssertionError(f"(e) cli stop: exit {stop.returncode} "
                             f"{stop.stdout}; segments left {left}")
    log(f"  (e) cli stop {stop_s:.3f} s ({stop.stdout.strip()}): none of the "
        f"{len(procs)} processes of the session (head, node, workers) alive "
        f"{time.perf_counter() - t0:.3f} s after, no rtts-/rttr- segment "
        f"and no session file left [{card}]")
    log(f"  phase 12 in {time.perf_counter() - t_phase:.1f} s [{card}]")


# ------------------ phase 13: the train library and single-device models

# The MoE flagship: FLAGSHIP's widths and depth, MoETransformerConfig's
# defaults (8 experts, top 2, capacity 1.25, aux weight 0.01), each expert
# a FLAGSHIP-wide SwiGLU. MOE_B is the batch of its train step: TRAIN_B,
# cut only if memory bounds the step (the width and depth never are).
MOE = dict(n_experts=8, top_k=2, capacity_factor=1.25, aux_loss_weight=0.01)
MOE_B = TRAIN_B
# (b): moe_ffn against its dense plain version at a size the dense
# one-hot dispatch fits.
MOE_CHECK_B, MOE_CHECK_T = 2, 512
# (d): TPUTrainer's ranks, each at phase 5's tokens per step halved.
TT_WORKERS, TT_B, TT_STEPS = 2, 4, 3
# (e): the vision family at VisionConfig()'s defaults, trained through
# MeshTrainer on the quadrant task.
VIS_STEPS, VIS_B = 30, 256


def tl_gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(seed)


def check_step_counts(what: str, seen: dict, want: dict) -> dict:
    now = read_counts()
    got = {n: now[n] - seen[n] for n in now}
    want = {n: want.get(n, 0) for n in now}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return now


# A MoE step's kernel families: the dense step's, and the index form's
# gathers and scatters, and AdamW's fused multi-tensor kernels.
MOE_GROUPS = {**STEP_GROUPS,
              "indexing (gathers, scatters, their sorts)":
                  ("index", "scatter", "gather", "Sort", "sort"),
              "AdamW (multi_tensor_apply)": ("multi_tensor_apply",)}


class RoutingProbe:
    """Wraps moe_transformer.moe_ffn to keep each layer's routing (the
    index form's own, moe_ffn_routed), while it is installed; with
    ``keep_inputs``, also each layer's input and router."""

    def __init__(self, keep_inputs: bool = False):
        self.layers, self.inputs, self.routers = [], [], []
        self.keep = keep_inputs
        self.orig = moe_tr.moe_ffn

    def __enter__(self):
        def recording(x, params, cfg, *args, **kw):
            y, aux, r = moe_mod.moe_ffn_routed(x, params, cfg, *args, **kw)
            self.layers.append(r)
            if self.keep:
                self.inputs.append(x.detach())
                self.routers.append(params["router"].detach().clone())
            return y, aux
        moe_tr.moe_ffn = recording
        return self

    def __exit__(self, *exc):
        moe_tr.moe_ffn = self.orig


def moe_train(card: str) -> dict:
    """(a) The MoE flagship's train step at full width and depth."""
    cfg = moe_tr.MoETransformerConfig(dtype=torch.bfloat16, **FLAGSHIP,
                                      **MOE)
    L, V = cfg.n_layers, cfg.vocab_size
    log(f"phase 13 (a): MoE train step at the flagship's widths and depth "
        f"({L} layers, d_model {cfg.d_model}, {cfg.n_experts} experts of "
        f"d_ff {cfg.d_ff}, top {cfg.top_k}, capacity {cfg.capacity_factor}),"
        f" bf16, f32 params, batch {MOE_B}, seq {TRAIN_T}, AdamW (weight "
        f"decay 1e-4), {TRAIN_STEPS} steps")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = moe_tr.init_params(tl_gen(SEED + 20), cfg, device=DEVICE)
    n_params = sum(t.numel() for t in named_leaves(params).values())
    init_opt, train_step = moe_tr.make_train_step(cfg)
    opt = init_opt(params)
    if opt.param_groups[0]["weight_decay"] != 1e-4:
        raise AssertionError("MoE AdamW weight decay is not optax's 1e-4")
    rng = np.random.default_rng(SEED + 21)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, V, (MOE_B, TRAIN_T + 1))).to(DEVICE)}
    per_step = train_per_step(L)
    losses, auxes, walls, dropped = [], [], [], None
    torch.cuda.synchronize()
    reset_counts()
    seen = read_counts()
    for step in range(TRAIN_STEPS):
        with RoutingProbe() as probe:
            t0 = time.perf_counter()
            params, opt, loss = train_step(params, opt, batch)
            losses.append(loss.item())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        seen = check_step_counts(f"(a) MoE train step {step}", seen,
                                 per_step)
        auxes.append(sum(r.aux.item() for r in probe.layers))
        if step == 0:
            dropped = [int((~r.in_cap).sum()) for r in probe.layers]
            tokens_out = [int((~r.in_cap).all(1).sum())
                          for r in probe.layers]
            capacity = probe.layers[0].capacity
        log(f"  step {step}: loss {losses[-1]:.6f} (aux {auxes[-1]:.6f}), "
            f"{walls[-1]:.3f} ms wall, launches as per step {per_step}")
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    ln_v = math.log(V)
    ce0 = losses[0] - auxes[0]
    if not (math.isfinite(losses[0]) and abs(ce0 - ln_v) < 1.0):
        raise AssertionError(f"(a) step-0 loss minus aux {ce0} is not "
                             f"within 1.0 of ln({V}) = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a) MoE loss did not fall: {losses}")
    step_ms = float(np.median(walls))
    tokens = MOE_B * TRAIN_T
    log(f"  {n_params:,} parameters; losses {losses}; step-0 loss minus aux "
        f"{ce0:.6f} (ln {V} = {ln_v:.4f}); aux a step {auxes}")
    log(f"  capacity {capacity} slots an expert; step 0's (token, k) "
        f"choices dropped by capacity, per layer, of {tokens * cfg.top_k}: "
        f"{dropped}; tokens with both choices dropped: {tokens_out}")
    log(f"  MoE train step: median {step_ms:.3f} ms wall over {TRAIN_STEPS} "
        f"steps (first {walls[0]:.3f} ms), {tokens / step_ms * 1e3:.1f} "
        f"tokens/s, peak memory {peak / 2 ** 30:.2f} GiB "
        f"({(peak - base) / 2 ** 30:.2f} GiB over the "
        f"{base / 2 ** 30:.2f} GiB held before the phase) [{card}]")

    def step():
        train_step(params, opt, batch)

    syncs = count_syncs(step)
    dev_ms = device_ms("MoE train step", step, [()], 2,
                       sleep_cycles=2_000_000_000)
    log(f"  MoE train step: {syncs} host syncs a step (torch's sync debug "
        f"mode); device time {dev_ms:.3f} ms back to back vs {step_ms:.3f} "
        f"ms wall: card busy {dev_ms / step_ms:.1%} [{card}]")
    profile_breakdown("MoE train step", step, card, MOE_GROUPS, ops=12)
    del params, opt, batch
    gc.collect()
    return {"step_ms": step_ms, "walls": walls, "losses": losses,
            "peak_gib": peak / 2 ** 30, "dropped": dropped,
            "launches": launches}


def moe_vs_dense(card: str) -> None:
    """(b) moe_ffn against _moe_ffn_dense_ref on the card: routing equal,
    y and every gradient within a tolerance of its largest magnitude (f32
    1e-5: the products are the same, but the dense einsums sum the K terms
    and the zeros in other orders, with FMAs; bf16 2^-7: one bf16 rounding
    of a gate's gradient can fall on either side); the same forward twice,
    the same bits."""
    log(f"phase 13 (b): moe_ffn (index form) vs its dense plain version on "
        f"the card, E {FLAGSHIP['d_model']}, F {FLAGSHIP['d_ff']}, N "
        f"{MOE['n_experts']}, B {MOE_CHECK_B}, T {MOE_CHECK_T}")
    # The flagship's capacity factor in both dtypes, and 1.0, at which
    # some choices must drop.
    for dt, tol, cf in ((torch.float32, 1e-5, MOE["capacity_factor"]),
                        (torch.bfloat16, 2 ** -7, MOE["capacity_factor"]),
                        (torch.float32, 1e-5, 1.0)):
        cfg = moe_mod.MoEConfig(d_model=FLAGSHIP["d_model"],
                                d_ff=FLAGSHIP["d_ff"], dtype=dt,
                                **{**MOE, "capacity_factor": cf})
        base = moe_mod.init_moe_params(tl_gen(SEED + 23), cfg,
                                       device=DEVICE)
        g = tl_gen(SEED + 24)
        x = torch.randn(MOE_CHECK_B, MOE_CHECK_T, cfg.d_model, generator=g,
                        device=DEVICE).to(dt)
        gy = torch.randn(x.shape, generator=g, device=DEVICE)
        outs = []
        for fn in (moe_mod.moe_ffn_routed, moe_mod._moe_ffn_dense_ref):
            p = {k: v.clone().requires_grad_(True) for k, v in base.items()}
            xx = x.clone().requires_grad_(True)
            y, aux, r = fn(xx, p, cfg)
            ((y.float() * gy).sum() + aux).backward()
            outs.append((y.detach(), aux.detach(), r,
                         {"x": xx.grad, **{k: v.grad for k, v in p.items()}}))
        (y, aux, r, grads), (ry, raux, rr, rgrads) = outs
        for field in ("expert_idx", "position", "in_cap"):
            if not torch.equal(getattr(r, field), getattr(rr, field)):
                raise AssertionError(f"(b) {dt}: routing {field} differs "
                                     f"from the dense version's")
        if cf == 1.0 and r.in_cap.all():
            raise AssertionError("(b) capacity factor 1.0 dropped nothing")
        worst = {}
        for name, got, want in [("y", y, ry), ("aux", aux, raux)] + [
                (k, grads[k], rgrads[k]) for k in grads]:
            scale = want.float().abs().max().item()
            err = max_err(got, want)
            if not torch.isfinite(got.float()).all() or err > tol * scale:
                raise AssertionError(f"(b) {dt} {name}: max_abs_err {err} "
                                     f"above {tol} x {scale}")
            worst[name] = err / max(scale, 1e-30)
        with torch.no_grad():
            y1, a1 = moe_mod.moe_ffn(x, base, cfg)
            y2, a2 = moe_mod.moe_ffn(x, base, cfg)
        if not (torch.equal(y1, y2) and torch.equal(a1, a2)):
            raise AssertionError(f"(b) {dt}: two forwards differ")
        # The backward's bits twice (reported: gathers add at most K terms
        # into a row).
        p2 = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        y3, a3 = moe_mod.moe_ffn(x, p2, cfg)
        ((y3.float() * gy).sum() + a3).backward()
        same_bwd = all(torch.equal(p2[k].grad, grads[k]) for k in p2)
        log(f"  {str(dt)[6:]}, capacity factor {cf}: routing equal "
            f"({int((~r.in_cap).sum())} of "
            f"{r.in_cap.numel()} choices dropped at capacity "
            f"{r.capacity}); errors / largest magnitude "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f" (tolerance {tol:.2e}); two forwards the same bits; the "
            f"backward's bits twice {'the same' if same_bwd else 'differ'}")


def moe_card_vs_cpu(card: str) -> None:
    """(c) One f32 MoE train step's loss and gradients at full width (batch
    1, seq 256), card vs CPU: the loss within 1e-4, each gradient within
    1e-3 of its largest magnitude (phase 6's tolerances). Routing must be
    equal, but where a token's k-th and (k+1)-th router probabilities lie
    within 4 f32 ulps on either side: such places are printed."""
    log("phase 13 (c): one f32 MoE train step at full width, batch 1, seq "
        "256, card vs CPU")
    cfg = moe_tr.MoETransformerConfig(dtype=torch.float32, **FLAGSHIP,
                                      **MOE)
    K = cfg.top_k
    gpu = moe_tr.init_params(tl_gen(SEED + 25), cfg, device=DEVICE)
    cpu = tree_map(lambda t: t.detach().cpu(), gpu)
    tokens = np.random.default_rng(SEED + 26).integers(
        0, cfg.vocab_size, (1, 257))
    runs = []
    for params in (gpu, cpu):
        for t in named_leaves(params).values():
            t.requires_grad_(True)
        t0 = time.perf_counter()
        with RoutingProbe() as probe:
            loss = moe_tr.loss_fn(params, {"tokens": torch.from_numpy(
                tokens)}, cfg)
            loss.backward()
        grads = {name: t.grad.float().cpu()
                 for name, t in named_leaves(params).items()}
        runs.append((loss.item(), grads, probe.layers,
                     time.perf_counter() - t0))
    (gl, ggrads, groute, gs), (cl, cgrads, croute, cs) = runs
    near = []
    for i, (a, b) in enumerate(zip(groute, croute)):
        sa = a.expert_idx.cpu().sort(-1).values
        sb = b.expert_idx.sort(-1).values
        rows = (sa != sb).any(-1).nonzero().flatten().tolist()
        for row in rows:
            gaps = []
            for probs in (a.probs[row].cpu(), b.probs[row]):
                top = probs.sort(descending=True).values
                gaps.append((top[K - 1] - top[K]).item()
                            / torch.finfo(torch.float32).eps
                            / top[K - 1].item())
            if min(gaps) > 4:
                raise AssertionError(f"(c) layer {i} token {row}: experts "
                                     f"{sa[row].tolist()} on the card, "
                                     f"{sb[row].tolist()} on the CPU, top-k "
                                     f"margins {gaps} ulps")
            near.append((i, row, gaps))
            log(f"  layer {i} token {row}: experts differ at a near-tie "
                f"(margins {gaps[0]:.2f} / {gaps[1]:.2f} f32 ulps)")
        if not rows:
            for field in ("position", "in_cap"):
                if not torch.equal(getattr(a, field).cpu(),
                                   getattr(b, field)):
                    raise AssertionError(f"(c) layer {i}: {field} differs")
    worst = 0.0
    for name, want in cgrads.items():
        got = ggrads[name]
        scale = want.abs().max().item()
        err = max_err(got, want)
        if not torch.isfinite(got).all() or err > 1e-3 * scale:
            raise AssertionError(f"(c) grad {name}: card vs CPU max_abs_err "
                                 f"{err} above 1e-3 x {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    if abs(gl - cl) > 1e-4 or not math.isfinite(gl):
        raise AssertionError(f"(c) MoE loss card {gl} vs CPU {cl}")
    log(f"  loss card {gl:.7f} CPU {cl:.7f} (diff {abs(gl - cl):.2e}); "
        f"routing equal in all {len(groute)} layers but {len(near)} "
        f"near-tie places; every gradient within {worst:.2e} of its largest "
        f"magnitude; {gs:.1f} s on the card, {cs:.1f} s on the CPU")
    del gpu, cpu
    gc.collect()


def tpu_trainer_path(train: dict, card: str) -> None:
    """(d) TPUTrainer on the card: TT_WORKERS worker actors (CPU shares,
    no GPU share) of the local runtime on the dense flagship's loss_fn."""
    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    L = cfg.n_layers
    log(f"phase 13 (d): TPUTrainer on the card, {TT_WORKERS} workers "
        f"(num_cpus_per_worker=1), the dense flagship bf16, batch {TT_B} x "
        f"seq {TRAIN_T} a rank, AdamW, {TT_STEPS} steps")
    sums = []

    def init_fn(gen):
        params = init_params(gen, cfg, device=DEVICE)
        sums.append([t.double().sum().item()
                     for t in named_leaves(params).values()])
        return params

    def data_creator(rank, world, config):
        rng = np.random.default_rng(SEED + 30 + rank)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TT_B, TRAIN_T + 1))).to(DEVICE)
        while True:
            yield {"tokens": tokens}

    rt.init(num_cpus=4, num_gpus=1)
    trainer = None
    try:
        t0 = time.perf_counter()
        trainer = TPUTrainer(init_fn, lambda p, b: loss_fn(p, b, cfg),
                             data_creator, num_workers=TT_WORKERS,
                             num_cpus_per_worker=1, max_retries=1,
                             device=DEVICE)
        start_s = time.perf_counter() - t0
        if len(sums) != 1 + TT_WORKERS or any(s != sums[0] for s in sums):
            raise AssertionError("(d) the ranks' initial parameters differ "
                                 "from the driver's")
        grad_bytes = sum(t.numel() * t.element_size()
                         for t in named_leaves(trainer.params).values())
        per_step = train_per_step(L, TT_WORKERS)
        losses, walls = [], []
        torch.cuda.synchronize()
        reset_counts()
        seen = read_counts()
        for step in range(TT_STEPS):
            t0 = time.perf_counter()
            stats = trainer.train(num_steps=1)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(stats["loss"])
            seen = check_step_counts(f"(d) TPUTrainer step {step}", seen,
                                     per_step)
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"(d) TPUTrainer loss did not fall: "
                                 f"{losses}")
        step_ms = float(np.median(walls))
        log(f"  start (driver and {TT_WORKERS} ranks built from seed "
            f"{SEED}, the same parameters in each) {start_s:.3f} s; losses "
            f"{losses}; launches as per step {per_step} (each rank phase "
            f"5's)")
        log(f"  TPUTrainer step: median {step_ms:.3f} ms wall over "
            f"{TT_STEPS} steps ({TT_WORKERS * TT_B * TRAIN_T} tokens, "
            f"{TT_WORKERS * TT_B * TRAIN_T / step_ms * 1e3:.1f} tokens/s) "
            f"against phase 5's {train['step_ms']:.3f} ms for the same "
            f"tokens in one process; gradients through the store "
            f"{grad_bytes / 1e6:.1f} MB a rank a step [{card}]")
        rt.kill(trainer.workers[0])
        t0 = time.perf_counter()
        stats = trainer.train(num_steps=1)
        heal_s = time.perf_counter() - t0
        if stats["retries"] != 1 or trainer.step != TT_STEPS + 1 or \
                not math.isfinite(stats["loss"]):
            raise AssertionError(f"(d) after kill(): {stats}")
        log(f"  a worker killed: the next train() rebuilt the workers and "
            f"stepped (retries {stats['retries']}, loss "
            f"{stats['loss']:.6f}) in {heal_s:.3f} s")
    finally:
        if trainer is not None:
            trainer.shutdown()
        rt.shutdown()
    gc.collect()


def quadrant_batches(cfg, n: int, count: int, seed: int) -> list:
    """tests/test_vision.py's task drawn with numpy: the label is the
    quadrant that holds a bright square; on the card."""
    rng = np.random.default_rng(seed)
    size, half = cfg.image_size, cfg.image_size // 2
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(count):
        labels = rng.integers(0, 4, n)
        imgs = 0.1 * rng.standard_normal(
            (n, size, size, cfg.in_channels)).astype(np.float32)
        y0 = (labels // 2 * half)[:, None, None]
        x0 = (labels % 2 * half)[:, None, None]
        inside = ((yy >= y0) & (yy < y0 + half) & (xx >= x0)
                  & (xx < x0 + half))
        imgs[inside] = 1.0
        out.append({"images": torch.from_numpy(imgs).to(DEVICE),
                    "labels": torch.from_numpy(labels).to(DEVICE)})
    return out


def vision_path(card: str) -> None:
    """(e) The vision family through MeshTrainer on the card, and its f32
    logits card vs CPU (within atol = rtol = 1e-4: cuDNN's convolutions and
    the CPU's sum in other orders through 13 convolutions and GroupNorms)."""
    cfg = VisionConfig()
    log(f"phase 13 (e): vision, VisionConfig() ({cfg.image_size}x"
        f"{cfg.image_size}x{cfg.in_channels}, widths {cfg.widths}, "
        f"{cfg.blocks_per_stage} blocks a stage, {cfg.num_classes} classes)"
        f" through MeshTrainer, {VIS_STEPS} steps at batch {VIS_B}, AdamW "
        f"3e-3")
    data = quadrant_batches(cfg, VIS_B, VIS_STEPS + 1, SEED + 40)
    trainer = MeshTrainer(
        lambda gen: init_vision_params(gen, cfg, device=DEVICE),
        lambda p, b: vision_loss(p, b, cfg), learning_rate=3e-3,
        seed=SEED + 41, device=DEVICE)
    first = trainer.train_step(data[0])
    stats = trainer.train(iter(data[1:VIS_STEPS]), VIS_STEPS - 1)
    last = stats["last_loss"]
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"(e) vision loss did not fall: {first} -> "
                             f"{last}")
    held = data[VIS_STEPS]
    acc = vision_accuracy(trainer.state.params, held, cfg).item()
    with torch.no_grad():
        gpu = vision_apply(trainer.state.params, held["images"][:64], cfg)
        cpu_params = tree_map(lambda t: t.detach().cpu(),
                              trainer.state.params)
        cpu = vision_apply(cpu_params, held["images"][:64].cpu(), cfg)
    check_close("(e) f32 vision logits, card vs CPU", gpu.cpu(), cpu,
                atol=1e-4, rtol=1e-4)
    log(f"  loss {first:.6f} -> {last:.6f} over {VIS_STEPS} steps; "
        f"{stats['time_s'] / (VIS_STEPS - 1) * 1e3:.3f} ms a step (host "
        f"clock over {VIS_STEPS - 1} steps ending in a synchronize); "
        f"held-out accuracy {acc:.4f} [{card}]")


def train_library_path(train: dict, card: str) -> dict:
    t_phase = time.perf_counter()
    out = moe_train(card)
    moe_vs_dense(card)
    moe_card_vs_cpu(card)
    tpu_trainer_path(train, card)
    vision_path(card)
    log(f"  phase 13 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# ------------------------------------------- phase 14: the mesh on the card

# One world of MESH_RANKS processes sharing the card (gloo; collectives
# staged through pinned host memory), started once by parallel.launch.
MESH_RANKS = 2
MESH_LAYOUTS = (("dp2", {"dp": 2}), ("tp2", {"tp": 2}), ("sp2", {"sp": 2}),
                ("pp2", {"pp": 2}))
# (a): f32 at the flagship's widths, depth 2, batch 2 x seq 256, pp with 2
# microbatches; Ulysses at [B, T, H, D] = MESH_UL.
MESH_F32_L, MESH_F32_B, MESH_F32_T, MESH_F32_MB = 2, 2, 256, 2
MESH_UL = (2, 256, 16, 64)
# (b), (c): 3 steps a layout from phases 5's and 13's weights and batches;
# pp with 4 microbatches.
MESH_STEPS, MESH_PP_MB = 3, 4
# (b), (c): the bound on |sharded loss - single-process loss| at each bf16
# step. The layouts compute each logit with other reduction orders and
# splits, so a bf16 logit may differ by rounding (2^-8 of its magnitude,
# logits of magnitude ~1 at these weights); a token's loss moves by at most
# twice its largest logit change, and the mean over the batch by no more
# than the largest token's. AdamW's first steps move every parameter by
# about lr whatever its gradient's size, so a gradient within rounding of
# zero may flip the sign of its update: a second-order change of the loss.
MESH_LOSS_BOUND = 2 ** -7
# (c): the MoE layout's bf16 losses at step s are held within the larger
# of MESH_LOSS_BOUND and |bf16 - f32| of one process at step s: the
# routing is discrete, and the layout's rounding moves near-tie choices
# (below) as bf16 itself does, so its losses may stray from one process's
# as far as bf16's own from f32's on the same weights and batch.
# A choice is a near tie where its token's top-K margin (the K-th minus
# the (K+1)-th router logit) is below what MESH_NEAR_ULPS bf16 ulps of
# every router-input element can move it: tp2 rounds each `wo` partial
# to bf16 and then their sum, where one process rounds once.
MESH_NEAR_ULPS = 2
# (d): vision batch; (e): Ulysses in bf16 at [B, T, H, D].
MESH_VIS_B = 64
MESH_UL_BF16 = (8, 2048, 16, 64)
# Autograd's saved f32 elements a ring fold keeps, per B * H * t * t
# (ring_attention._block_step; 2.44 measured at t = 512 on the CPU with
# saved_tensors_hooks, falling with t): sizes sp2's batch in (b).
RING_SAVED = 2.5


def mesh_per_step(layout: str, L: int) -> dict:
    """K1 (plain, residual, backward), K2 and K3-K5 launches a rank makes
    in one train step of an L-layer flagship: dp2 and tp2 as one device
    (tp at H/2 heads); sp2 the same K1 and K2 and no K3-K5 (ring attention
    is plain torch ops); pp2 with M microbatches of L/2 layers a stage: a
    microbatch's 1 plain and L - 1 residual K1 (its last add plain), the
    final norm once, K2 once (every stage runs the head) and K3-K5 once a
    layer a microbatch."""
    if layout == "sp2":
        return {**train_per_step(L), "flash_forward": 0,
                "flash_backward_dq": 0, "flash_backward_dkv": 0}
    if layout == "pp2":
        M, Ls = MESH_PP_MB, L // 2
        return {"rms_norm": M + 1, "add_rms_norm": M * (2 * Ls - 1),
                "rms_norm_backward": M * 2 * Ls + 1, "softmax_xent": 1,
                "flash_forward": M * Ls, "flash_backward_dq": M * Ls,
                "flash_backward_dkv": M * Ls}
    return train_per_step(L)


def mesh_sp_batch() -> int:
    """(b)'s sp2 batch: TRAIN_B unless the ring's saved scores of both
    ranks would take more than half the card's free memory, then the
    largest power-of-two cut that fits (the width is never cut)."""
    free = (torch.cuda.mem_get_info()[0] if DEVICE == "cuda"
            else float("inf"))
    H, T, L = FLAGSHIP["n_heads"], TRAIN_T, FLAGSHIP["n_layers"]
    B = TRAIN_B
    while B > 1 and MESH_RANKS * RING_SAVED * 4 * B * H * (T // 2) ** 2 \
            * 2 * L > free / 2:
        B //= 2
    return B


def rlog(msg: str) -> None:
    """A line from rank 0 of the phase-14 world."""
    import torch.distributed as dist
    if dist.get_rank() == 0:
        log(msg)


def msync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def rel_errs(got: dict, want: dict) -> dict:
    """{leaf: max |got - want| / max |want|}."""
    return {n: max_err(got[n], w) / max(w.abs().max().item(), 1e-30)
            for n, w in want.items()}


def mesh_f32(dev) -> dict:
    """(a) One f32 step of each layout against the single-process step on
    the card: the loss and every gathered gradient (averaged over dp and
    sp as the train step does) within 1e-5 of its largest magnitude; and
    Ulysses against single-rank flash_attention, forward and gradients."""
    import torch.distributed as dist
    from ray_tpu_torch.models import param_shardings
    from ray_tpu_torch.parallel import (P, gather, make_mesh, shard,
                                        ulysses_attention)
    from ray_tpu_torch.parallel.collectives import (_reduce_raw,
                                                    reduce_gradients)

    cfg = TransformerConfig(dtype=torch.float32,
                            **{**FLAGSHIP, "n_layers": MESH_F32_L})
    rlog(f"phase 14 (a): f32, the flagship's widths at depth {MESH_F32_L}, "
         f"batch {MESH_F32_B}, seq {MESH_F32_T}, TF32 off: one step of "
         f"{', '.join(n for n, _ in MESH_LAYOUTS)} (pp with {MESH_F32_MB} "
         f"microbatches) against one process on the card")
    rank0 = dist.get_rank() == 0
    params = init_params(torch.Generator(device=dev).manual_seed(SEED + 60),
                         cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 61).integers(
        0, cfg.vocab_size, (MESH_F32_B, MESH_F32_T + 1))).to(dev)
    out = {}
    if rank0:
        single = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          params)
        ref_loss = loss_fn(single, {"tokens": tokens}, cfg)
        ref_loss.backward()
        ref = {n: t.grad for n, t in named_leaves(single).items()}
        del single
    for name, spec in MESH_LAYOUTS:
        mesh = make_mesh(spec)
        specs = param_shardings(cfg, mesh)
        local = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         shard(params, specs, mesh))
        loss = loss_fn(local, {"tokens": shard(tokens, P("dp"), mesh)}, cfg,
                       mesh, num_microbatches=MESH_F32_MB)
        loss.backward()
        reduce_gradients(list(named_leaves(local).values()), mesh)
        grads = named_leaves(gather(tree_map(lambda t: t.grad, local), specs,
                                    mesh))
        if rank0:
            errs = rel_errs(grads, ref)
            worst = max(errs, key=errs.get)
            dl = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
            if errs[worst] > 1e-5 or dl > 1e-5:
                raise AssertionError(
                    f"(a) {name}: loss off by {dl:.2e} (relative), gradient "
                    f"{worst} off by {errs[worst]:.2e} of its largest "
                    f"magnitude (bound 1e-5)")
            log(f"  (a) {name}: loss {loss.item():.7f} vs "
                f"{ref_loss.item():.7f} ({dl:.2e} relative); every gradient "
                f"within "
                f"{errs[worst]:.2e} of its largest magnitude ({worst})")
            out[name] = {"loss_rel": dl, "grad_rel": errs[worst]}
        del local, grads, loss
        mesh_free(dev)

    B, T, H, D = MESH_UL
    mesh = make_mesh({"sp": 2})
    g = torch.Generator(device=dev).manual_seed(SEED + 62)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=dev)
                   for _ in range(4))
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ulysses_attention(qs, ks, vs, mesh, causal=True)
    (o * do).sum().backward()
    got = {"out": o.detach(), **{n: _reduce_raw(t.grad, mesh, "sp")
                                 for n, t in zip("qkv", (qs, ks, vs))}}
    if rank0:
        q1, k1, v1 = (t.clone().requires_grad_(True) for t in (q, k, v))
        o1 = attention.flash_attention(q1, k1, v1, causal=True)
        (o1 * do).sum().backward()
        want = {"out": o1.detach(), "q": q1.grad, "k": k1.grad, "v": v1.grad}
        errs = rel_errs(got, want)
        worst = max(errs, key=errs.get)
        if errs[worst] > 1e-5:
            raise AssertionError(f"(a) Ulysses {worst} off by "
                                 f"{errs[worst]:.2e} of its largest magnitude")
        log(f"  (a) Ulysses f32 [{B}, {T}, {H}, {D}] over sp2: out, dq, dk, "
            f"dv within {errs[worst]:.2e} of their largest magnitudes of "
            f"flash_attention on one rank")
        out["ulysses_rel"] = errs[worst]
    mesh_free(dev)
    return out


def mesh_steps(what: str, step, per_step: dict, dev, B: int) -> dict:
    """MESH_STEPS calls of ``step`` (it returns the step's global loss), each
    with the launch counters and the staging counters set to 0 before and
    read after; launches must be exactly ``per_step``."""
    from ray_tpu_torch.parallel import collectives as coll

    losses, walls, staged = [], [], []
    for s in range(MESH_STEPS):
        msync(dev)
        reset_counts()
        coll.reset_staging()
        t0 = time.perf_counter()
        losses.append(step())
        msync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        check_step_counts(f"{what} step {s}", {n: 0 for n in COUNTED},
                          per_step)
        staged.append(dict(coll.STAGING))
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    return {"losses": losses, "walls": walls, "staged": staged,
            "peak_gib": peak, "B": B}


def mesh_report(name: str, res: dict, want: list, card: str,
                bounds: list = None) -> None:
    """Rank 0's line of a bf16 layout ``name`` ("(b) tp2"), and the loss
    bound (``bounds`` a step, MESH_LOSS_BOUND by default) against the
    single-process run's losses ``want``."""
    bounds = bounds or [MESH_LOSS_BOUND] * MESH_STEPS
    tokens = res["B"] * TRAIN_T
    ms = float(np.median(res["walls"]))
    st = res["staged"][-1]
    rlog(f"  {name}: losses {res['losses']} vs one process "
         f"{want[:MESH_STEPS]}; step {ms:.1f} ms median wall (first "
         f"{res['walls'][0]:.1f}), {tokens / ms * 1e3:.1f} tokens/s, peak "
         f"{res['peak_gib']:.2f} GiB a rank; staged {st['bytes'] / 1e6:.1f} "
         f"MB a step a rank in {st['calls']} collectives: copies "
         f"{st['copy_s'] * 1e3:.1f} ms, gloo {st['comm_s'] * 1e3:.1f} ms "
         f"[{card}]")
    for s, (got, ref, bound) in enumerate(zip(res["losses"], want,
                                              bounds)):
        if not (math.isfinite(got) and abs(got - ref) <= bound):
            raise AssertionError(f"{name} step {s}: loss {got} vs one "
                                 f"process {ref}, bound {bound}")


def single_losses(cfg, tokens, dev) -> list:
    """MESH_STEPS single-process steps of phase 5's train step from the
    seed's weights on ``tokens`` (a batch cut for sp2)."""
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         device=dev)
    init_opt, train_step = make_train_step(cfg)
    opt = init_opt(params)
    out = []
    for _ in range(MESH_STEPS):
        params, opt, loss = train_step(params, opt, {"tokens": tokens})
        out.append(loss.item())
    del params, opt
    mesh_free(dev)
    return out


def mesh_bf16(ref: dict, dev, card: str) -> dict:
    """(b) The bf16 flagship at full width and depth, phase 5's weights and
    batch, MESH_STEPS AdamW steps: dp2 through MeshTrainer, tp2, sp2 and
    pp2 through make_train_step."""
    import torch.distributed as dist
    from ray_tpu_torch.models import param_shardings
    from ray_tpu_torch.parallel import P, make_mesh, shard
    from ray_tpu_torch.train import MeshTrainer

    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    L, V = cfg.n_layers, cfg.vocab_size
    rlog(f"phase 14 (b): bf16, the flagship at full width and depth, "
         f"{MESH_STEPS} AdamW steps a layout from phase 5's weights and "
         f"batch ({TRAIN_B} x {TRAIN_T}; sp2 at batch {ref['sp_batch']}), "
         f"pp2 with {MESH_PP_MB} microbatches; losses within "
         f"{MESH_LOSS_BOUND} of one process")
    every = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, V, (TRAIN_B, TRAIN_T + 1))).to(dev)

    def adamw(leaves):   # make_train_step's optimizer
        return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.01)

    out = {}
    for name, spec in MESH_LAYOUTS:
        B = ref["sp_batch"] if name == "sp2" else TRAIN_B
        tokens = every[:B]
        want = ref["train_losses"]
        if B != TRAIN_B:
            rlog(f"  (b) sp2: batch cut from {TRAIN_B} to {B}: the ring's "
                 f"saved scores would not fit beside the rest; one process "
                 f"runs {MESH_STEPS} steps at batch {B} for the reference")
            got = single_losses(cfg, tokens, dev) if dist.get_rank() == 0 \
                else None
            want = _bcast_list(got, make_mesh(spec))
        mesh = make_mesh(spec)
        mesh_free(dev)
        if name == "dp2":
            trainer = MeshTrainer(
                lambda gen: init_params(gen, cfg, device=dev),
                lambda p, b: loss_fn(p, b, cfg, mesh), optimizer=adamw,
                mesh=mesh, param_shardings=param_shardings(cfg, mesh),
                batch_spec=P("dp"), seed=SEED)

            def step():
                return trainer.train_step({"tokens": tokens})
        else:
            state = {"params": shard(init_params(
                torch.Generator(device=dev).manual_seed(SEED), cfg,
                device=dev), param_shardings(cfg, mesh), mesh)}
            init_opt, train_step = make_train_step(
                cfg, mesh, num_microbatches=MESH_PP_MB if name == "pp2"
                else 0)
            state["opt"] = init_opt(state["params"])
            batch = {"tokens": shard(tokens, P("dp"), mesh)}

            def step():
                state["params"], state["opt"], loss = train_step(
                    state["params"], state["opt"], batch)
                return loss.item()
        res = mesh_steps(f"(b) {name} rank {dist.get_rank()}", step,
                         mesh_per_step(name, L), dev, B)
        mesh_report(f"(b) {name}", res, want, card)
        out[name] = res
        trainer = state = step = None
        mesh_free(dev)
    return out


def _bcast_list(values, mesh) -> list:
    """rank 0's list of floats on every rank."""
    from ray_tpu_torch.parallel.collectives import _broadcast_raw
    t = torch.tensor(values if values is not None else [0.0] * MESH_STEPS,
                     dtype=torch.float64)
    for axis in mesh.axis_names:
        t = _broadcast_raw(t, mesh, axis, 0)
    return t.tolist()


def bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp of each element of ``y`` (0 where it is 0)."""
    m, e = torch.frexp(y.float())
    return torch.where(y == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def near_ties(x: torch.Tensor, router: torch.Tensor, K: int) -> tuple:
    """Per token of a bf16 router input ``x`` [.., E]: the top-K margin of
    its f32 router logits, and the most that MESH_NEAR_ULPS ulps of each
    element can move the logit gap of the experts K and K+1."""
    y = x.reshape(-1, x.shape[-1])
    r = router.float()
    top, idx = (y.float() @ r).topk(K + 1, dim=-1)
    diff = (r[:, idx[:, K - 1]] - r[:, idx[:, K]]).abs().T      # [n, E]
    reach = MESH_NEAR_ULPS * (bf16_ulp(y) * diff).sum(-1)
    return top[:, K - 1] - top[:, K], reach


def moe_vs_one_process(cfg, tokens, mesh_probe, drops: list, ref: dict,
                       dev) -> list:
    """(c) on rank 0: one process's step-0 forward of phase 13's weights and
    batch (no gradient; its drops must be phase 13's), and per layer the
    mesh's choices that differ from it. At layer 0, where the inputs
    differ by the layout's rounding alone, no token's K/K+1 logit gap may
    move by more than its reach (``near_ties``), so every changed choice
    is a near tie; later layers carry the earlier layers' changes and
    rounding through the residual stream and attention, and are counted.
    At every layer the drops may differ by at most the changed choices (a
    choice moved to another expert moves at most one drop). Returns a row
    of counts a layer."""
    N, K = cfg.n_experts, cfg.top_k
    params = moe_tr.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 20), cfg, device=dev)
    with torch.no_grad(), RoutingProbe(keep_inputs=True) as one:
        moe_tr.forward(params, tokens[:, :-1], cfg)
    del params
    one_drops = [int((~r.in_cap).sum()) for r in one.layers]
    if one_drops != ref["moe_dropped"]:
        raise AssertionError(f"(c) one process's forward drops {one_drops}, "
                             f"its train step (phase 13) "
                             f"{ref['moe_dropped']}")
    earlier = None
    rows = []
    for i, (x1, r1, xm, rm) in enumerate(zip(one.inputs, one.layers,
                                             mesh_probe.inputs,
                                             mesh_probe.layers)):
        margin, reach = near_ties(x1, one.routers[i], K)
        near = margin < reach
        changed = (torch.nn.functional.one_hot(rm.expert_idx, N).sum(1)
                   > torch.nn.functional.one_hot(r1.expert_idx, N).sum(1)
                   ).sum(1)                                      # [n]
        if earlier is None:
            earlier = torch.zeros_like(near)
        # The input's differences, in ulps of the larger of the two values,
        # and what they move each token's gap of experts K and K+1 by,
        # over its reach.
        n = near.numel()
        d = (xm.float() - x1.float()).reshape(n, -1)
        big = torch.maximum(x1.float().abs(), xm.float().abs())
        ulps = d.abs() / bf16_ulp(big).reshape(n, -1).clamp_min(2 ** -126)
        r = one.routers[i].float()
        top = (x1.reshape(n, -1).float() @ r).topk(K + 1, dim=-1)[1]
        shift = (d * (r[:, top[:, K - 1]] - r[:, top[:, K]]).T).sum(-1)
        over = (shift.abs() / reach.clamp_min(1e-30))
        row = {"dropped": drops[i], "one": one_drops[i],
               "changed": int(changed.sum()),
               "near_tokens": int(near.sum()),
               "near": int(changed[near].sum()),
               "after_earlier": int(changed[~near & earlier].sum()),
               "other": int(changed[~near & ~earlier].sum()),
               "differ": (d != 0).float().mean().item(),
               "ulps_max": ulps.max().item(),
               "shift_over_reach": (over[~earlier].max().item()
                                    if bool((~earlier).any()) else 0.0)}
        rows.append(row)
        rlog(f"  (c) layer {i}: dropped {row['dropped']}, one process "
             f"{row['one']}; {row['changed']} choices on other experts than "
             f"one process's: {row['near']} near ties (of "
             f"{row['near_tokens']} near-tie tokens, margin below "
             f"{MESH_NEAR_ULPS} bf16 ulps of the input), "
             f"{row['after_earlier']} on tokens changed at an earlier layer, "
             f"{row['other']} other; {row['differ']:.2%} of the router "
             f"input's elements differ, by at most {row['ulps_max']:.0f} "
             f"ulps; on tokens not changed before, the K/K+1 logit gap moved "
             f"by at most {row['shift_over_reach']:.3f} of its reach")
        if abs(row["dropped"] - row["one"]) > row["changed"]:
            raise AssertionError(f"(c) layer {i}: drops {row['dropped']} vs "
                                 f"{row['one']}, more apart than the "
                                 f"{row['changed']} changed choices")
        earlier = earlier | (changed > 0)
    if rows[0]["changed"] != rows[0]["near"] or \
            rows[0]["shift_over_reach"] > 1:
        raise AssertionError(
            f"(c) layer 0: {rows[0]['changed']} changed choices, "
            f"{rows[0]['near']} of them near ties; a token's K/K+1 logit gap "
            f"moved by {rows[0]['shift_over_reach']:.3f} of its reach")
    return rows


def mesh_moe_f32(dev) -> dict:
    """(c)'s witness: the MoE flagship's widths at depth MESH_F32_L, batch
    MESH_F32_B x MESH_F32_T, f32, TF32 off, in the shipped tp2 layout
    (``moe_transformer.param_shardings``: attention and experts over tp):
    step 0's loss and every gathered gradient within 1e-5 of one
    process's, each layer's routing equal to one process's, then
    MESH_STEPS AdamW steps with each loss within 1e-5 (relative)."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import gather, make_mesh, shard

    cfg = moe_tr.MoETransformerConfig(
        dtype=torch.float32, **{**FLAGSHIP, "n_layers": MESH_F32_L}, **MOE)
    rlog(f"phase 14 (c) f32: the MoE flagship's widths at depth "
         f"{MESH_F32_L}, batch {MESH_F32_B}, seq {MESH_F32_T}, TF32 off, "
         f"attention and experts over tp2, against one process")
    rank0 = dist.get_rank() == 0
    mesh = make_mesh({"tp": 2})
    specs = moe_tr.param_shardings(cfg, mesh)
    params = moe_tr.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 63), cfg, device=dev)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        SEED + 64).integers(0, cfg.vocab_size,
                            (MESH_F32_B, MESH_F32_T + 1))).to(dev)}

    def grads_and_steps(p, m):
        """(loss, gradients, routings) of one backward, and the losses of
        MESH_STEPS train steps, from ``p`` on mesh ``m``."""
        local = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        with RoutingProbe() as probe:
            loss = moe_tr.loss_fn(local, batch, cfg, m)
        loss.backward()
        grads = tree_map(lambda t: t.grad, local)
        init_opt, step = moe_tr.make_train_step(cfg, m)
        state = {"p": tree_map(lambda t: t.detach().clone(), p)}
        opt = init_opt(state["p"])
        losses = []
        for _ in range(MESH_STEPS):
            state["p"], opt, value = step(state["p"], opt, batch)
            losses.append(value.item())
        return loss.item(), grads, probe.layers, losses

    loss, grads, routed, losses = grads_and_steps(shard(params, specs, mesh),
                                                  mesh)
    grads = named_leaves(gather(grads, specs, mesh))
    out = {}
    if rank0:
        ref_loss, ref_grads, ref_routed, ref_losses = grads_and_steps(params,
                                                                      None)
        errs = rel_errs(grads, named_leaves(ref_grads))
        worst = max(errs, key=errs.get)
        gaps = [abs(a - b) / abs(b) for a, b in zip([loss] + losses,
                                                    [ref_loss] + ref_losses)]
        same = all(torch.equal(a.expert_idx, b.expert_idx)
                   and torch.equal(a.position, b.position)
                   for a, b in zip(routed, ref_routed))
        log(f"  (c) f32: loss {loss:.7f} vs {ref_loss:.7f}; every gradient "
            f"within {errs[worst]:.2e} of its largest magnitude ({worst}); "
            f"routing equal to one process's at every layer: {same}; "
            f"{MESH_STEPS} AdamW steps {losses} vs {ref_losses}, largest "
            f"relative gap {max(gaps):.2e}")
        if errs[worst] > 1e-5 or max(gaps) > 1e-5 or not same:
            raise AssertionError(
                f"(c) f32: gradient {worst} off by {errs[worst]:.2e}, losses "
                f"by {max(gaps):.2e} (bound 1e-5), routing equal: {same}")
        out = {"grad_rel": errs[worst], "loss_rel": max(gaps)}
    grads = routed = None
    mesh_free(dev)
    return out


def mesh_moe(ref: dict, dev, card: str) -> dict:
    """(c) The MoE flagship (phase 13's config, weights and batch) in the
    shipped layout (``moe_transformer.param_shardings``: attention over
    tp2 as the dense model's, experts over tp2), MESH_STEPS steps: exact
    launches; at step 0 each layer's routing equal to one device's routing
    of the mesh's own layer input (experts, queue positions, capacity),
    and against one process (``moe_vs_one_process``) layer 0's routing
    moved by rounding alone; the losses within the larger of
    MESH_LOSS_BOUND and one process's |bf16 - f32| a step
    (``ref["moe_f32_losses"]``). The f32 witness (``mesh_moe_f32``) runs
    first."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import make_mesh, shard

    out = {"f32": mesh_moe_f32(dev)}
    cfg = moe_tr.MoETransformerConfig(dtype=torch.bfloat16, **FLAGSHIP,
                                      **MOE)
    L, V = cfg.n_layers, cfg.vocab_size
    bounds = [max(MESH_LOSS_BOUND, abs(a - b)) for a, b in
              zip(ref["moe_losses"], ref["moe_f32_losses"])]
    rlog(f"phase 14 (c): the MoE flagship ({cfg.n_experts} experts, top "
         f"{cfg.top_k}, capacity {cfg.capacity_factor}) with attention and "
         f"experts over tp2, batch {MOE_B} x {TRAIN_T}, {MESH_STEPS} steps "
         f"from phase 13's weights and batch; losses within {bounds} of one "
         f"process's (one process's bf16 - f32: "
         f"{[abs(a - b) for a, b in zip(ref['moe_losses'], ref['moe_f32_losses'])]})")
    mesh = make_mesh({"tp": 2})
    mesh_free(dev)
    specs = moe_tr.param_shardings(cfg, mesh, expert_axis="tp")
    params = shard(moe_tr.init_params(
        torch.Generator(device=dev).manual_seed(SEED + 20), cfg, device=dev),
        specs, mesh)
    init_opt, train_step = moe_tr.make_train_step(cfg, mesh)
    state = {"params": params, "opt": init_opt(params)}
    del params
    tokens = torch.from_numpy(np.random.default_rng(SEED + 21).integers(
        0, V, (MOE_B, TRAIN_T + 1))).to(dev)
    probes = []

    def step():
        with RoutingProbe(keep_inputs=not probes) as probe:
            state["params"], state["opt"], loss = train_step(
                state["params"], state["opt"], {"tokens": tokens})
            value = loss.item()
        probes.append(probe)
        return value

    res = mesh_steps(f"(c) MoE tp2 rank {dist.get_rank()}", step,
                     train_per_step(L), dev, MOE_B)
    state = None
    first = probes[0]
    moe = cfg.moe_cfg()
    drops = []
    for i, (x, r) in enumerate(zip(first.inputs, first.layers)):
        # Step 0's layer input and (replicated) router, kept by the probe.
        one = moe_mod.route(x.reshape(-1, x.shape[-1]), first.routers[i],
                            moe)
        for field in ("expert_idx", "position", "in_cap"):
            if not torch.equal(getattr(one, field), getattr(r, field)):
                raise AssertionError(f"(c) layer {i}: the mesh's {field} "
                                     "differs from one device's on the same "
                                     "input")
        drops.append(int((~r.in_cap).sum()))
    rlog(f"  (c) step 0: routing equal to one device's on each layer's own "
         f"input; choices dropped a layer {drops}, one process (phase 13) "
         f"{ref['moe_dropped']}")
    mesh_free(dev)
    if dist.get_rank() == 0:
        res["layers"] = moe_vs_one_process(cfg, tokens, first, drops, ref,
                                           dev)
    mesh_report("(c) MoE tp2", res, ref["moe_losses"], card, bounds)
    res.update(dropped=drops, bounds=bounds, **out)
    probes = first = None
    mesh_free(dev)
    return res


def mesh_vision(dev) -> dict:
    """(d) The vision family at VisionConfig()'s defaults over dp2, f32,
    cuDNN deterministic: the loss (the mean of the ranks') and every
    gradient (averaged over dp) against one process that takes the batch
    in the same two halves and averages, within 1e-5 of its largest
    magnitude; the distance to one process's whole-batch gradients is
    printed (cuDNN sums a batch of 64 and of 32 in other orders, and the
    GroupNorm biases' gradients cancel: 1.06e-4 of the largest magnitude
    on an H100)."""
    import torch.distributed as dist
    from ray_tpu_torch.models import vision_param_shardings
    from ray_tpu_torch.parallel import P, gather, make_mesh, shard
    from ray_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                    reduce_gradients)

    cfg = VisionConfig()
    rlog(f"phase 14 (d): vision, VisionConfig(), f32, batch {MESH_VIS_B} "
         f"over dp2 against one process")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh({"dp": 2})
    params = init_vision_params(
        torch.Generator(device=dev).manual_seed(SEED + 70), cfg, device=dev)
    batch = {k: v.to(dev) for k, v in quadrant_batches(
        cfg, MESH_VIS_B, 1, SEED + 71)[0].items()}
    specs = vision_param_shardings(cfg, mesh)
    local = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     shard(params, specs, mesh))
    loss = all_reduce_mean(vision_loss(local, shard(batch, P("dp"), mesh),
                                       cfg), mesh, "dp")
    loss.backward()
    reduce_gradients(list(named_leaves(local).values()), mesh)
    grads = named_leaves(gather(tree_map(lambda t: t.grad, local), specs,
                                mesh))
    out = {}
    if dist.get_rank() == 0:
        def one_process(parts):
            """The mean loss of ``parts`` and its gradients, one device."""
            single = tree_map(
                lambda t: t.detach().clone().requires_grad_(True), params)
            value = sum(vision_loss(single, part, cfg) for part in parts)
            (value / len(parts)).backward()
            return (value.item() / len(parts),
                    {n: t.grad for n, t in named_leaves(single).items()})

        half = MESH_VIS_B // 2
        ref, want = one_process([{k: v[:half] for k, v in batch.items()},
                                 {k: v[half:] for k, v in batch.items()}])
        errs = rel_errs(grads, want)
        worst = max(errs, key=errs.get)
        dl = abs(loss.item() - ref) / abs(ref)
        if errs[worst] > 1e-5 or dl > 1e-5:
            raise AssertionError(f"(d) vision: loss off by {dl:.2e}, "
                                 f"gradient {worst} by {errs[worst]:.2e}")
        whole, want_whole = one_process([batch])
        werrs = rel_errs(grads, want_whole)
        wworst = max(werrs, key=werrs.get)
        log(f"  (d) loss {loss.item():.7f} vs {ref:.7f} ({dl:.2e} "
            f"relative); every gradient within {errs[worst]:.2e} of its "
            f"largest magnitude ({worst}); against the whole batch on one "
            f"device: loss {whole:.7f}, gradients within "
            f"{werrs[wworst]:.2e} ({wworst})")
        out = {"loss_rel": dl, "grad_rel": errs[worst],
               "whole_batch_rel": werrs[wworst]}
    torch.backends.cudnn.deterministic = deterministic
    mesh_free(dev)
    return out


def mesh_ulysses_bf16(dev, card: str) -> dict:
    """(e) ulysses_attention_sharded in bf16 at MESH_UL_BF16 over sp2, a
    forward and backward: per rank exactly one K3, one K4 and one K5 (at
    H/2 heads over the whole sequence); out and gradients, gathered,
    against one flash_attention over all heads (the same kernels, each head
    computed alone: within bf16's 2e-2, and the bits compared)."""
    import torch.distributed as dist
    from ray_tpu_torch.parallel import (P, gather, make_mesh, shard,
                                        ulysses_attention_sharded)

    B, T, H, D = MESH_UL_BF16
    rlog(f"phase 14 (e): Ulysses, bf16 [{B}, {T}, {H}, {D}] over sp2, a "
         f"forward and backward")
    mesh = make_mesh({"sp": 2})
    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    spec = P(None, "sp")
    ql, kl, vl = (t.clone().requires_grad_(True)
                  for t in shard((q, k, v), spec, mesh))
    msync(dev)
    reset_counts()
    t0 = time.perf_counter()
    ol = ulysses_attention_sharded(ql, kl, vl, mesh, causal=True)
    ol.backward(shard(do, spec, mesh))
    msync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    check_step_counts(f"(e) Ulysses rank {dist.get_rank()}",
                      {n: 0 for n in COUNTED},
                      {"flash_forward": 1, "flash_backward_dq": 1,
                       "flash_backward_dkv": 1})
    got = gather({"out": ol.detach(), "q": ql.grad, "k": kl.grad,
                  "v": vl.grad}, spec, mesh)
    out = {"wall_ms": wall}
    if dist.get_rank() == 0:
        q1, k1, v1 = (t.clone().requires_grad_(True) for t in (q, k, v))
        o1 = attention.flash_attention(q1, k1, v1, causal=True)
        o1.backward(do)
        want = {"out": o1.detach(), "q": q1.grad, "k": k1.grad, "v": v1.grad}
        same = {n: torch.equal(got[n], want[n]) for n in want}
        for n in want:
            check_close(f"(e) Ulysses {n} vs one flash_attention", got[n],
                        want[n], atol=2e-2, rtol=2e-2)
        log(f"  (e) {wall:.1f} ms a forward and backward (host clock, "
            f"collectives included); the same bits as one flash_attention: "
            f"{same}; launches a rank exactly 1 K3, 1 K4, 1 K5 [{card}]")
        out["same_bits"] = same
    mesh_free(dev)
    return out


def mesh_rank(ref: dict, card: str) -> dict:
    """Phase 14 in one rank of the world: (a)-(e) in turn."""
    from ray_tpu_torch.parallel.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device()
    t0 = time.perf_counter()
    out = {"f32": mesh_f32(dev), "bf16": mesh_bf16(ref, dev, card),
           "moe": mesh_moe(ref, dev, card), "vision": mesh_vision(dev),
           "ulysses": mesh_ulysses_bf16(dev, card)}
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank_entry(ref: dict, card: str) -> dict:
    """What ``launch`` runs in each rank: this script imported as a module
    there (the rank's function travels by value, and this one names
    nothing of the script), then its ``mesh_rank``."""
    import chip_smoke
    return chip_smoke.mesh_rank(ref, card)


def moe_f32_losses(card: str) -> list:
    """(c)'s yardstick: MESH_STEPS steps of phase 13's MoE train step in
    f32 on one process (TF32 off), from its weights and batch."""
    cfg = moe_tr.MoETransformerConfig(dtype=torch.float32, **FLAGSHIP,
                                      **MOE)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    params = moe_tr.init_params(tl_gen(SEED + 20), cfg, device=DEVICE)
    init_opt, train_step = moe_tr.make_train_step(cfg)
    opt = init_opt(params)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        SEED + 21).integers(0, cfg.vocab_size,
                            (MOE_B, TRAIN_T + 1))).to(DEVICE)}
    t0 = time.perf_counter()
    losses = []
    for _ in range(MESH_STEPS):
        params, opt, loss = train_step(params, opt, batch)
        losses.append(loss.item())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"phase 14 (c)'s yardstick: the MoE flagship in f32 on one process, "
        f"{MESH_STEPS} steps of phase 13's: losses {losses} "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")
    del params, opt, batch
    dev_free()
    return losses


def mesh_path(train: dict, moe: dict, card: str) -> dict:
    """Phase 14: the training half of the meshes (A7b) on the card."""
    from ray_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    # The ranks share the card with this process: hand its cached blocks
    # back first.
    dev_free()
    sp_b = mesh_sp_batch()
    free = (torch.cuda.mem_get_info()[0] / 2 ** 30 if DEVICE == "cuda"
            else float("nan"))
    log(f"phase 14: meshes for training, one world of {MESH_RANKS} rank "
        f"processes on the card (gloo, collectives staged through pinned "
        f"host memory); {free:.2f} GiB of the card free; sp2's batch "
        f"{sp_b}")
    ref = {"train_losses": train["losses"], "moe_losses": moe["losses"],
           "moe_dropped": moe["dropped"], "sp_batch": sp_b,
           "moe_f32_losses": moe_f32_losses(card)}
    ranks = launch(mesh_rank_entry, MESH_RANKS, ref, card,
                   device=DEVICE)
    for part in ("bf16",):
        for name in ranks[0][part]:
            losses = [r[part][name]["losses"] for r in ranks]
            if any(ls != losses[0] for ls in losses):
                raise AssertionError(f"(b) {name}: ranks report different "
                                     f"losses {losses}")
    if ranks[0]["moe"]["losses"] != ranks[1]["moe"]["losses"]:
        raise AssertionError("(c) ranks report different losses")
    log(f"  phase 14 in {time.perf_counter() - t0:.1f} s "
        f"({ranks[0]['seconds']:.1f} s in the ranks' function) [{card}]")
    return ranks[0]


# ---------------- phase 15: serving under tensor parallelism (A7c)

TP_RANKS = 2
TP_F32_LAYERS = 2      # (d): the flagship's widths at this depth, in f32
TP_F32_SEED = SEED + 30


def _f32_reorder_bound() -> float:
    """(d)'s bound on max |tp2 logits - one process's| / max |one
    process's|. An f32 sum of n terms taken in another order moves by at
    most 2 gamma_n of the sum of the terms' magnitudes (gamma_n = n u, u =
    2^-24); tp2 reorders, on the way to a logit, the vocab-parallel
    embedding's sum, each layer's wo (H * Dh terms) and w_down (d_ff)
    products, and the head's (d_model), so the bound is that of d_ff, the
    longest of them, once for each: (2 L + 2) 2 d_ff u, taking the terms'
    magnitudes to sum to the largest logit's and the norms between them to
    pass a relative error through unchanged."""
    n = FLAGSHIP["d_ff"]
    return (2 * TP_F32_LAYERS + 2) * 2 * n * 2.0 ** -24


def tp_gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(seed)


def tp_rank_entry(job: str, card: str):
    """What the tp world runs in each rank: this script imported as a
    module there (the function travels by value, and this one names
    nothing of the script), then its ``tp_rank``."""
    import chip_smoke
    return chip_smoke.tp_rank(job, card)


def run_engine(eng, reqs) -> list:
    """Each (prompt, max_new_tokens, kwargs) submitted, then every request
    run to its end; the outputs in order."""
    ids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    res = eng.run_until_done()
    return [res[i] for i in ids]


def logits_digest(logits: torch.Tensor) -> str:
    return hashlib.sha1(logits.float().cpu().numpy().tobytes()).hexdigest()


class TpStaging:
    """Mixed into a probe of a rank's engine: each decode tick's bytes
    staged through pinned host memory and seconds copying and in gloo
    (``collectives.STAGING``), and a digest of its full logits, so the
    ranks' logits can be held bit-equal; with ``keep``, the logits too."""

    def __init__(self, eng, keep: bool = False):
        super().__init__(eng)
        self.staging, self.digests, self.logits = [], [], []
        self.keep = keep

    def decode(self):
        from ray_tpu_torch.parallel.collectives import STAGING
        before = dict(STAGING)
        logits = super().decode()
        self.staging.append({k: STAGING[k] - before[k] for k in STAGING})
        self.digests.append(logits_digest(logits))
        if self.keep:
            self.logits.append(logits.float().cpu().numpy())
        return logits


class TpProbe(TpStaging, PathProbe):
    pass


class TpPagedProbe(TpStaging, PagedProbe):
    pass


def tp_tick_report(probes) -> dict:
    """Full-slot ticks of a rank's probes: walls, staged bytes, seconds in
    copies and in gloo."""
    rows = [(ms, st) for pr in probes
            for (active, ms), st in zip(pr.ticks, pr.staging)
            if active == SLOTS]
    return {"tick_ms": [ms for ms, _ in rows],
            "bytes": [st["bytes"] for _, st in rows],
            "copy_ms": [st["copy_s"] * 1e3 for _, st in rows],
            "comm_ms": [st["comm_s"] * 1e3 for _, st in rows],
            "calls": [st["calls"] for _, st in rows],
            "lens": [pr.tick_lengths[i][1].tolist() for pr in probes
                     for i, (active, _) in enumerate(pr.ticks)
                     if active == SLOTS]}


def tp_contiguous(params, mesh, cfg) -> dict:
    """(a) in a rank: phase 3's traffic through the contiguous engine over
    the tp mesh, each tick's launches from this rank's counters."""
    from ray_tpu_torch.parallel.collectives import reset_staging
    L, V = cfg.n_layers, cfg.vocab_size
    eng = engine_mod.GenerationEngine(params, cfg, max_slots=SLOTS,
                                      max_seq=MAX_SEQ, mesh=mesh)
    run_engine(eng, [([1, 2, 3], 4, {})])   # warm-up, as phase 3's
    probe = TpProbe(eng)
    prompts = serving_prompts(V)
    reset_counts()
    reset_staging()
    outs = run_engine(eng, [(p, NEW_TOKENS, {}) for p in prompts])
    sample = (prompts[3], 16, {"temperature": 0.8, "seed": 42})
    sampled = [run_engine(eng, [sample])[0] for _ in range(2)]
    rid = eng.submit(prompts[0], NEW_TOKENS)
    streamed = []
    while eng.queue or any(r is not None for r in eng.active):
        streamed += [t for r, t, _ in eng.step() if r == rid]
    eng.done.pop(rid)
    launches = read_counts()
    per_tick = {n_: 0 for n_ in COUNTED}
    per_tick.update(rms_norm=1, add_rms_norm=2 * L, decode_attention=L)
    for i, got in enumerate(probe.tick_launches):
        if got != per_tick:
            raise AssertionError(f"(a) tick {i}: launches {got}, expected "
                                 f"{per_tick}")
    check_launches_each(probe.prefill_launches, L, "(a) prefill")
    n = len(probe.prefills) + len(probe.ticks)
    want = {n_: 0 for n_ in COUNTED}
    want.update(rms_norm=n, add_rms_norm=2 * L * n,
                decode_attention=L * len(probe.ticks))
    if launches != want:
        raise AssertionError(f"(a) launches {launches}, expected {want}")
    return {"outs": outs, "sampled": sampled, "streamed": streamed,
            "kv": tuple(eng.cache_k.shape), "ticks": len(probe.ticks),
            "prefills": len(probe.prefills), "launches": launches,
            "digests": probe.digests, **tp_tick_report([probe])}


def tp_paged(params, mesh, cfg) -> dict:
    """(b) in a rank: phase 3b's 16 shared-prefix requests on the default
    pool and its chunked prefill, through the paged engine over the tp
    mesh."""
    from ray_tpu_torch.parallel.collectives import reset_staging
    L, V = cfg.n_layers, cfg.vocab_size
    _, _, shared, long_prompt = paged_traffic(V)
    eng = paged_mod.PagedGenerationEngine(params, cfg, max_slots=SLOTS,
                                          max_seq=MAX_SEQ, page_size=PAGE,
                                          mesh=mesh)
    chunked = paged_mod.PagedGenerationEngine(
        params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        prefill_chunk=CHUNK, mesh=mesh)
    probes = (TpPagedProbe(eng), TpPagedProbe(chunked))
    reset_counts()
    reset_staging()
    outs = run_engine(eng, [(p, NEW_TOKENS, {}) for p in shared])
    hits = eng._prefix_hits(shared[0])
    out_long = run_engine(chunked, [(long_prompt, 64, {})])[0]
    launches = read_counts()
    total = check_paged_launches(probes, L)
    if total != launches:
        raise AssertionError(f"(b) launches {launches} != the prefills' and "
                             f"ticks' {total}")
    return {"outs": outs, "out_long": out_long, "hits": hits,
            "shared": max(probes[0].shared), "pool": tuple(eng.k_pages.shape),
            "ticks": sum(len(p.ticks) for p in probes), "launches": launches,
            "digests": probes[0].digests + probes[1].digests,
            **tp_tick_report(probes)}


def tp_spec(params, mesh, cfg) -> dict:
    """(c) in a rank: phase 3c's quoting traffic through both engines with
    speculative_k=4 over the tp mesh; every verify pass K1 only, every
    draft-less paged tick K1 and K7."""
    L, V = cfg.n_layers, cfg.vocab_size
    quoting = spec_traffic(V)["quoting"]
    out = {}
    for name, cls, kw in (
            ("contiguous", engine_mod.GenerationEngine, {}),
            ("paged", paged_mod.PagedGenerationEngine,
             dict(page_size=PAGE))):
        eng = cls(params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                  speculative_k=SPEC_K, speculative_ngram=SPEC_NGRAM,
                  mesh=mesh, **kw)
        pr = SpecProbe(eng)
        reset_counts()
        toks = run_engine(eng, [(p, QUOTE_NEW, {}) for p in quoting])
        launches = read_counts()
        total = check_spec_launches(pr, L, name == "paged")
        if total != launches:
            raise AssertionError(f"(c) {name}: launches {launches} != the "
                                 f"passes' {total}")
        kinds = [k for k, _ in pr.passes]
        out[name] = {"out": toks, "stats": dict(eng.spec_stats),
                     "verify": kinds.count("verify"),
                     "decode": kinds.count("decode"), "launches": launches}
    return out


def tp_f32(mesh, dev) -> dict:
    """(d) in a rank: the f32 witness, phase 3's 12 greedy requests at the
    flagship's widths and TP_F32_LAYERS layers; rank 0 keeps every decode
    tick's logits."""
    import torch.distributed as dist
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(FLAGSHIP, n_layers=TP_F32_LAYERS))
    params = init_params(tp_gen(TP_F32_SEED), cfg, device=dev)
    eng = engine_mod.GenerationEngine(params, cfg, max_slots=SLOTS,
                                      max_seq=MAX_SEQ, mesh=mesh)
    del params
    probe = TpProbe(eng, keep=dist.get_rank() == 0)
    outs = run_engine(eng, [(p, NEW_TOKENS, {})
                            for p in serving_prompts(cfg.vocab_size)])
    return {"outs": outs, "digests": probe.digests,
            "logits": probe.logits, "kv": tuple(eng.cache_k.shape)}


def tp_rank(job: str, card: str):
    """Phase 15 in one rank of the tp world: build the flagship's weights
    from phase 3's seed ("params"), then (a)-(d) one call each."""
    from ray_tpu_torch.parallel import make_mesh, rank_state
    from ray_tpu_torch.parallel.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device()
    state = rank_state()
    mesh = make_mesh({"tp": TP_RANKS})
    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    t0 = time.perf_counter()
    if job == "hello":
        return str(dev)
    if job == "params":
        state["tp_params"] = init_params(tp_gen(SEED), cfg, device=dev)
        return {"checksum": params_checksum(state["tp_params"])}
    with torch.inference_mode():
        if job == "d":
            state.pop("tp_params", None)
            out = tp_f32(mesh, dev)
        else:
            run = {"a": tp_contiguous, "b": tp_paged, "c": tp_spec}[job]
            out = run(state["tp_params"], mesh, cfg)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def params_checksum(params) -> list:
    return [float(t.double().sum()) for t in named_leaves(params).values()]


class GapProbe(SpecProbe):
    """One process's reference run for phase 15: the top-2 gap and top
    logit of every greedy token it picks (prefill, decode and verify
    passes) and every logits row a sampling request draws from, by
    (prompt, index in the output). Used as a context manager: inside,
    ``_Request.pick`` is wrapped to see the prefills' and the sampling
    requests' rows."""

    def __init__(self, eng):
        super().__init__(eng, gaps=True)
        self.rows = {}

    def verify(self, chunk):
        logits = super().verify(chunk)
        top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
        for s, r in enumerate(self.eng.active):
            if r is not None and r.temperature == 0:
                for i in range(chunk.shape[1]):
                    self.gaps[tuple(r.prompt), len(r.out) + i] = (
                        float(top[s, i, 0] - top[s, i, 1]),
                        float(top[s, i, 0]))
        return logits

    def __enter__(self):
        self._pick = orig = engine_mod._Request.pick
        probe = self

        def pick(req, row):
            key = (tuple(req.prompt), len(req.out))
            if req.temperature == 0:
                lo, hi = np.partition(row, -2)[-2:]
                probe.gaps[key] = (float(hi - lo), float(hi))
            else:
                probe.rows[key] = (np.array(row, np.float32),
                                   req.temperature)
            return orig(req, row)

        engine_mod._Request.pick = pick
        return self

    def __exit__(self, *exc):
        engine_mod._Request.pick = self._pick


def sampled_flip(name: str, got: list, want: list, prompt: list, seed: int,
                 rows: dict) -> None:
    """A seeded sampled request's tokens against one process's: at the
    first difference the draw must lie within what FLIP_ULPS bf16 ulps of
    the top logit can move the edges of the drawn token's interval of the
    cumulative distribution (every logit moved by eps moves every
    probability by a factor within exp(+-2 eps / T), so every edge by less
    than expm1(2 eps / T)); else the run fails."""
    if got == want:
        return
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    if (tuple(prompt), j) not in rows or j >= len(want):
        raise AssertionError(f"{name}: the sampled request differs at token "
                             f"{j}, where one process's row is not known")
    row, T = rows[tuple(prompt), j]
    z = row.astype(np.float64) / T
    p = np.exp(z - z.max())
    cdf = np.cumsum(p / p.sum())
    cdf /= cdf[-1]
    u = np.random.default_rng(seed).random(j + 1)[j]
    t = want[j]
    if int(np.searchsorted(cdf, u, side="right")) != t:
        raise AssertionError(f"{name}: the replayed draw does not give one "
                             f"process's token {t}")
    margin = min(u - (cdf[t - 1] if t else 0.0), cdf[t] - u)
    reach = math.expm1(2 * FLIP_ULPS * ulp_bf16(float(row.max())) / T)
    log(f"  {name}: the sampled request differs from one process's at token "
        f"{j}: the draw {u:.6g} lies {margin:.3g} from an edge of token "
        f"{t}'s interval, reach {reach:.3g} ({FLIP_ULPS} bf16 ulps)")
    if not margin < reach:
        raise AssertionError(f"{name}: a sampled token differs where the "
                             f"draw is {margin} from an edge, not under "
                             f"{reach}")


def tp_references(params, cfg, main: dict, paged: dict, spec: dict) -> dict:
    """One process's runs of (a)-(c)'s traffic on the card, each held equal
    to its phase's tokens (the same engine on the same requests gives the
    same bits), under GapProbes: the near ties the tp runs are held to."""
    V = cfg.vocab_size
    common = dict(max_slots=SLOTS, max_seq=MAX_SEQ, device=DEVICE)
    prompts = serving_prompts(V)
    _, _, shared, long_prompt = paged_traffic(V)
    quoting = spec_traffic(V)["quoting"]
    refs = {}
    with torch.inference_mode():
        eng = engine_mod.GenerationEngine(params, cfg, **common)
        run_engine(eng, [([1, 2, 3], 4, {})])
        with GapProbe(eng) as g:
            outs = run_engine(eng, [(p, NEW_TOKENS, {}) for p in prompts])
            sampled = run_engine(eng, [(prompts[3], 16, {
                "temperature": 0.8, "seed": 42})])[0]
        refs["a"] = {"outs": outs, "sampled": sampled, "gaps": g.gaps,
                     "rows": g.rows}
        if outs != main["outs"] or sampled != main["sampled"]:
            raise AssertionError("one process's rerun of phase 3's traffic "
                                 "differs from phase 3's tokens")
        del eng, g
        eng = paged_mod.PagedGenerationEngine(params, cfg, page_size=PAGE,
                                              **common)
        chunked = paged_mod.PagedGenerationEngine(
            params, cfg, page_size=PAGE, prefill_chunk=CHUNK, **common)
        with GapProbe(eng) as g, GapProbe(chunked) as gc_:
            outs = run_engine(eng, [(p, NEW_TOKENS, {}) for p in shared])
            out_long = run_engine(chunked, [(long_prompt, 64, {})])[0]
        refs["b"] = {"outs": outs, "out_long": out_long,
                     "gaps": {**g.gaps, **gc_.gaps}}
        if outs != paged["want_shared"] or out_long != paged["out_long"]:
            raise AssertionError("one process's rerun of phase 3b's traffic "
                                 "differs from phase 3b's tokens")
        del eng, chunked, g, gc_
        for name, cls, kw in (
                ("contiguous", engine_mod.GenerationEngine, {}),
                ("paged", paged_mod.PagedGenerationEngine,
                 dict(page_size=PAGE))):
            eng = cls(params, cfg, speculative_k=SPEC_K,
                      speculative_ngram=SPEC_NGRAM, **common, **kw)
            with GapProbe(eng) as g:
                outs = run_engine(eng, [(p, QUOTE_NEW, {}) for p in quoting])
            if outs != spec["runs"][name]["out"]["a"]:
                raise AssertionError(f"one process's rerun of phase 3c's "
                                     f"traffic (a), {name}, differs from "
                                     f"phase 3c's tokens")
            refs["c", name] = {"outs": outs, "gaps": g.gaps}
            del eng, g
    dev_free()
    return refs


def tp_f32_reference(card: str) -> dict:
    """(d)'s yardstick: one process's f32 engine at the same depth and
    seed, every decode tick's logits kept."""
    cfg = TransformerConfig(dtype=torch.float32,
                            **dict(FLAGSHIP, n_layers=TP_F32_LAYERS))
    params = init_params(tp_gen(TP_F32_SEED), cfg, device=DEVICE)
    with torch.inference_mode():
        eng = engine_mod.GenerationEngine(params, cfg, max_slots=SLOTS,
                                          max_seq=MAX_SEQ, device=DEVICE)
        probe = TpProbe(eng, keep=True)
        outs = run_engine(eng, [(p, NEW_TOKENS, {})
                                for p in serving_prompts(cfg.vocab_size)])
    return {"outs": outs, "logits": probe.logits}


def tp_equal_ranks(what: str, ranks: list, keys) -> dict:
    for k in keys:
        if any(r[k] != ranks[0][k] for r in ranks[1:]):
            raise AssertionError(f"{what}: the ranks disagree on {k}")
    return ranks[0]


def tp_kernel_times(lens: list, card: str) -> dict:
    """K6 and K7 a launch at a rank's 8 heads (H = KH = 8, D 64) on one
    tick's lengths of (a), each beside its bound (bytes over the HBM
    rate)."""
    bf16 = torch.bfloat16
    B, D = SLOTS, FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    H = KH = FLAGSHIP["n_kv_heads"] // TP_RANKS
    live = sum(n + 1 for n in lens)
    pages = sum(-(-(n + 1) // PAGE) for n in lens)
    kv_bytes = 2 * live * KH * D * 2 + 2 * B * H * D * 2 + 4 * B
    k6, k7 = [], []
    for i in range(n_copies(2 * live * KH * D * 2)):
        k6.append(decode_inputs(B, H, KH, D, MAX_SEQ, list(lens), bf16,
                                seed=1500 + i))
        q, kp, vp, table, ln = paged_inputs(B + 1, H, KH, D, PAGE,
                                            MAX_SEQ // PAGE,
                                            list(lens) + [0], bf16,
                                            seed=1600 + i)
        k7.append((q[:B].contiguous(), kp, vp, table[:B], ln[:B]))
    out = {"decode_attention": dict(
        ms=device_ms("decode_attention at 8 heads",
                     attention.decode_attention, k6, 200),
        **bound(kv_bytes, 4 * live * H * D, bf16)),
        "paged_decode_attention": dict(
        ms=device_ms("paged_decode_attention at 8 heads",
                     paged_attention.paged_decode_attention, k7, 200),
        **bound(kv_bytes + 4 * pages, 4 * live * H * D, bf16))}
    for name, t in out.items():
        log(f"  {name} at a rank's {H} heads (B={B} H=KH={H} D={D}, "
            f"lengths {min(lens)}-{max(lens)}, "
            f"{attention.decode_splits(B * KH)} splits): "
            f"{t['ms'] * 1e3:.2f} us a launch, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) [{card}]")
    return out


def tp_serve(params, cfg, a: dict, refs: dict, card: str) -> dict:
    """(e): LMBackend(tp=2) behind serve, contiguous and then paged with
    speculative_k=3, through a handle and one stream; the card's memory
    back after each backend goes. The contiguous backend's tokens must
    equal (a)'s, bit for bit. The paged one's are held to one process's
    by (b)'s rule: speculation rounds bf16 otherwise than K7 (phase 3c),
    and which ticks verify depends on the batch serve forms, so it cannot
    match (b)'s tokens bit for bit."""
    V = cfg.vocab_size
    prompts = serving_prompts(V)
    _, _, shared, _ = paged_traffic(V)
    cache_bytes = 2 * cfg.n_layers * SLOTS * MAX_SEQ * (
        cfg.n_kv_heads // TP_RANKS) * cfg.head_dim * 2
    pool_bytes = 2 * cfg.n_layers * (SLOTS * (MAX_SEQ // PAGE) + 1) * PAGE * (
        cfg.n_kv_heads // TP_RANKS) * cfg.head_dim * 2
    res = {}
    rt.init()
    try:
        serve.init()
        bc = serve.BackendConfig(**SERVE_CONFIG)
        for tag, kw, reqs, per_rank in (
                ("contig", {}, prompts, cache_bytes),
                ("paged", dict(paged=True, page_size=PAGE,
                               speculative_k=SPEC_K - 1), shared,
                 pool_bytes)):
            free0 = dev_free()
            t0 = time.perf_counter()
            serve.create_backend(f"lm:tp-{tag}", LMBackend, params, cfg,
                                 tp=TP_RANKS, max_slots=SLOTS,
                                 max_seq=MAX_SEQ, device=DEVICE,
                                 config=bc, **kw)
            start_s = time.perf_counter() - t0
            serve.create_endpoint(f"tp-{tag}", backend=f"lm:tp-{tag}")
            h = serve.get_handle(f"tp-{tag}")
            t0 = time.perf_counter()
            outs = rt.get([h.remote(p, max_new_tokens=NEW_TOKENS)
                           for p in reqs], timeout=600)
            streamed = list(h.stream(reqs[1], max_new_tokens=NEW_TOKENS))
            batch_s = time.perf_counter() - t0
            stats = rt.get(h.options(method="stats").remote(), timeout=60)
            free1 = dev_free()
            if tag == "contig":
                if outs != a["outs"] or streamed != outs[1]:
                    raise AssertionError("(e) LMBackend(tp=2) behind serve "
                                         "differs from (a)'s tokens")
            else:
                rb = refs["b"]
                flips = greedy_flips("(e) paged, speculative_k=3",
                                     outs + [streamed],
                                     rb["outs"] + [rb["outs"][1]],
                                     shared + [shared[1]], rb["gaps"])
                if stats["speculative"]["ticks"] == 0:
                    raise AssertionError("(e) no speculative tick counted")
            serve.delete_endpoint(f"tp-{tag}")
            serve.delete_backend(f"lm:tp-{tag}")
            if tag == "paged":
                serve.shutdown()
            want = TP_RANKS * per_rank
            wait_until(f"(e) {tag}: the card's memory back by both ranks' "
                       f"KV stores", lambda: dev_free() - free1 >= want, 60)
            back = dev_free() - free1
            log(f"  (e) {tag}: serve.create_backend(LMBackend, tp=2) ready "
                f"in {start_s:.2f} s; {len(reqs)} requests and one stream "
                f"through the handle in {batch_s:.3f} s, "
                + ("equal to (a)'s" if tag == "contig" else
                   f"{len(flips)} of {len(reqs) + 1} differing from one "
                   f"process's, each first at a near tie")
                + f"; stats()['speculative'] {stats['speculative']}; in use "
                f"{(free0 - free1) / 2**30:.2f} GiB of the card, "
                f"{back / 2**30:.2f} GiB back after the backend went (both "
                f"ranks' KV {want / 2**30:.2f} GiB) [{card}]")
            res[tag] = {"start_s": start_s, "back": back}
    finally:
        serve.shutdown()
        rt.shutdown()
    return res


def tp_serve_path(params, cfg, main: dict, paged: dict, spec: dict,
                  card: str) -> dict:
    """Phase 15: serving under tensor parallelism on the card. One world of
    TP_RANKS rank processes sharing it, each with its engine over a
    ("tp",) mesh: (a) contiguous, (b) paged, (c) speculative, (d) the f32
    witness; then (e) LMBackend(tp=2) behind serve."""
    from ray_tpu_torch.parallel import World

    t_phase = time.perf_counter()
    L = cfg.n_layers
    KH = cfg.n_kv_heads // TP_RANKS
    log(f"phase 15: serving under tensor parallelism, one world of "
        f"{TP_RANKS} rank processes on the card (gloo), each over {KH} of "
        f"the flagship's {cfg.n_kv_heads} kv heads [{card}]")
    refs = tp_references(params, cfg, main, paged, spec)
    f32_ref = tp_f32_reference(card)
    log(f"  one process's references: phases 3, 3b, 3c's tokens again, "
        f"{sum(len(r['gaps']) for r in refs.values())} greedy gaps kept; "
        f"(d)'s f32 run at depth {TP_F32_LAYERS} "
        f"({time.perf_counter() - t_phase:.1f} s)")
    checksum = params_checksum(params)
    dev_free()
    world = World(TP_RANKS, device=DEVICE)
    try:
        t0 = time.perf_counter()
        devs = world.run(tp_rank_entry, "hello", card)
        start_s = time.perf_counter() - t0
        ranks = world.run(tp_rank_entry, "params", card)
        if any(r["checksum"] != checksum for r in ranks):
            raise AssertionError("the ranks' weights are not phase 3's")
        log(f"  the world's {TP_RANKS} ranks on {devs} up (processes, "
            f"torch, gloo, this script imported) in {start_s:.2f} s; each "
            f"drew phase 3's weights from seed {SEED} (checksums equal this "
            f"process's) [{card}]")
        got = {}
        for job in ("a", "b", "c", "d"):
            t0 = time.perf_counter()
            got[job] = world.run(tp_rank_entry, job, card)
            log(f"  ({job}) ran in {time.perf_counter() - t0:.1f} s")
    finally:
        world.close()

    # (a)
    ranks = got["a"]
    a = tp_equal_ranks("(a)", ranks, ("outs", "sampled", "streamed",
                                      "digests", "launches"))
    want_kv = (L, SLOTS, MAX_SEQ, KH, cfg.head_dim)
    if any(r["kv"] != want_kv for r in ranks):
        raise AssertionError(f"(a) caches {[r['kv'] for r in ranks]}, "
                             f"expected {want_kv} on every rank")
    ra = refs["a"]
    prompts = serving_prompts(cfg.vocab_size)
    flips = greedy_flips("(a)", a["outs"], ra["outs"], prompts, ra["gaps"])
    for i, s in enumerate(a["sampled"]):
        sampled_flip(f"(a) sampled, run {i}", s, ra["sampled"], prompts[3],
                     42, ra["rows"])
    if a["streamed"] != a["outs"][0]:
        raise AssertionError("(a) the streamed request differs from its "
                             "whole response")
    tick = float(np.median(a["tick_ms"]))
    one = float(np.median([ms for n, ms in main["probe"].ticks
                           if n == SLOTS]))
    staged = float(np.median(a["bytes"]))
    gloo = float(np.median(a["comm_ms"]))
    copy = float(np.median(a["copy_ms"]))
    log(f"  (a) contiguous: {len(prompts)} greedy requests, the sampled one "
        f"twice and a stream; {len(flips)} of {len(prompts)} greedy requests "
        f"differ from one process's, each first at a near tie; every rank's "
        f"cache {list(want_kv)}; every tick on every rank {2 * L + 1} K1 "
        f"and {L} K6 ({a['ticks']} ticks, {a['prefills']} prefills, "
        f"launches {a['launches']} a rank); the ranks' logits bit-equal on "
        f"all {len(a['digests'])} ticks")
    log(f"  (a) tick at {SLOTS} active slots: {tick:.3f} ms wall at tp2 vs "
        f"{one:.3f} ms one process (phase 3/7), {staged / 1e6:.3f} MB staged "
        f"a tick in {int(np.median(a['calls']))} collectives, gloo "
        f"{gloo:.3f} ms ({gloo / tick:.1%}) and pinned copies {copy:.3f} ms "
        f"({copy / tick:.1%}) of it [{card}]")

    # (b)
    ranks = got["b"]
    b = tp_equal_ranks("(b)", ranks, ("outs", "out_long", "digests",
                                      "launches", "hits"))
    want_pool = (L, SLOTS * (MAX_SEQ // PAGE) + 1, PAGE, KH, cfg.head_dim)
    if any(r["pool"] != want_pool for r in ranks) or b["hits"] <= 0:
        raise AssertionError(f"(b) pools {[r['pool'] for r in ranks]} "
                             f"(expected {want_pool}), prefix hits "
                             f"{b['hits']}")
    _, _, shared, long_prompt = paged_traffic(cfg.vocab_size)
    rb = refs["b"]
    flips = greedy_flips("(b)", b["outs"] + [b["out_long"]],
                         rb["outs"] + [rb["out_long"]],
                         shared + [long_prompt], rb["gaps"])
    log(f"  (b) paged: 16 shared-prefix requests and a {LONG_PROMPT}-token "
        f"chunked prefill; {len(flips)} of 17 differ from one process's, "
        f"each first at a near tie; every rank's pool {list(want_pool)}; "
        f"{b['hits']} prefix pages hit on the split pool, up to "
        f"{b['shared']} shared by live requests; every tick {2 * L + 1} K1 "
        f"and {L} K7 on every rank ({b['ticks']} ticks, launches "
        f"{ {n: c for n, c in b['launches'].items() if c} } a rank); tick "
        f"{float(np.median(b['tick_ms'])):.3f} ms wall [{card}]")

    # (c)
    c = tp_equal_ranks("(c)", got["c"], ("contiguous", "paged"))
    quoting = spec_traffic(cfg.vocab_size)["quoting"]
    for name in ("contiguous", "paged"):
        run, ref = c[name], refs["c", name]
        flips = greedy_flips(f"(c) {name}", run["out"], ref["outs"], quoting,
                             ref["gaps"])
        log(f"  (c) {name}, speculative_k={SPEC_K}: {len(flips)} of "
            f"{len(quoting)} quoting requests differ from one process's, "
            f"each first at a near tie; {run['verify']} verify passes, "
            f"{run['decode']} draft-less ticks through K7; launches "
            f"{ {n: c for n, c in run['launches'].items() if c} } a rank; "
            f"stats {run['stats']}")
    if c["paged"]["launches"]["paged_decode_attention"] == 0:
        raise AssertionError("(c) no draft-less paged tick counted K7")

    # (d)
    ranks = got["d"]
    d = tp_equal_ranks("(d)", ranks, ("outs", "digests"))
    if d["outs"] != f32_ref["outs"]:
        bad = [i for i, (x, y) in enumerate(zip(d["outs"], f32_ref["outs"]))
               if x != y]
        raise AssertionError(f"(d) f32 greedy tokens differ from one "
                             f"process's in requests {bad}")
    got32 = np.stack(ranks[0]["logits"])
    ref32 = np.stack(f32_ref["logits"])
    rel = float(np.abs(got32 - ref32).max() / np.abs(ref32).max())
    bnd = _f32_reorder_bound()
    log(f"  (d) f32 witness (depth {TP_F32_LAYERS}): every greedy token of "
        f"12 requests equal to one process's; logits over {len(got32)} "
        f"ticks: max |tp2 - one process| / max |one process| {rel:.3e}, "
        f"bound {bnd:.3e} (the f32 partial-sum reorder)")
    if not rel <= bnd:
        raise AssertionError(f"(d) f32 logits {rel} off one process's, above "
                             f"the reorder bound {bnd}")

    kernels = tp_kernel_times(a["lens"][len(a["lens"]) // 2], card)
    served = tp_serve(params, cfg, a, refs, card)
    log(f"  world start-up {start_s:.2f} s here, "
        f"{served['contig']['start_s']:.2f} and "
        f"{served['paged']['start_s']:.2f} s for the backends' worlds; "
        f"phase 15 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"kernels": kernels, "tick_ms": tick, "one_ms": one,
            "one_process": refs["a"]}


# ----------- phase 16: the data plane's legacy paths and head failover (A6c)


# (a) The head's GCS places on the card and relays legacy assign_batch
# frames; each node carries its own switches (and a resource of its own, so
# that a task can be sent to it); the driver submits per-task frames and
# harvests results without a completion ring.
DP_HEAD_ENV = {"RAY_TPU_TORCH_DISPATCH_WAVE": "0"}
DP_CHUNK = 256 * 2**10
DP_NODES = (
    ({"CPU": 2, "GPU": 1, "dp1": 8},
     {"RAY_TPU_TORCH_WIRE_PICKLE_ONLY": "1",
      "RAY_TPU_TORCH_NATIVE_FRAMEPUMP": "0"}),
    ({"CPU": 2, "dp2": 8}, {"RAY_TPU_TORCH_TRANSFER_SCHED": "0"}),
    ({"CPU": 2, "dp3": 8}, {"RAY_TPU_TORCH_TRANSFER_CHUNK": str(DP_CHUNK),
                            "RAY_TPU_TORCH_TRANSFER_MAX_INFLIGHT": "1"}),
)
DP_DRIVER_ENV = {"RAY_TPU_TORCH_COLUMNAR_SUBMIT": "0",
                 "RAY_TPU_TORCH_COMPLETION_RING": "0"}
# (b) test_cluster_ha.py's drill: a head without a node, one 2-CPU node of
# 2 workers, a warm standby, a 1.5 s lease and 5,000 tasks in flight.
HA_TASKS, HA_DONE_AT, HA_TTL_S = 5000, 500, "1.5"
HA_WAVE = 2048     # a gated wave past the matrix threshold on one node
HA_MAX_WAVES = 3


class DpServer(ClusterServer):
    """Phase 16's GPU actor: phase 11's, and the node it lives on."""

    def home(self) -> tuple:
        return tuple(cl_home())


def dp_probe() -> dict:
    """What a worker process of a node sees of its own switches: its wire,
    its frame pump, its transfer knobs, and an object_added frame as it
    would encode it."""
    from ray_tpu_torch._native import framepump
    from ray_tpu_torch.cluster import transfer_manager as tm
    from ray_tpu_torch.cluster import wire
    from ray_tpu_torch.cluster.protocol import encode_frames

    core = global_core()
    frame = b"".join(encode_frames(
        {"type": "object_added", "object_id": b"O" * 24, "size": 1},
        binary_ok=True))[8:]
    return {"home": tuple(core._home_addr), "pickle_only": wire.pickle_only(),
            "client_binary": core._controller(core._home_addr)._binary,
            "frame_binary": wire.is_binary(frame),
            "pump": framepump.enabled(), "sched": tm.sched_enabled(),
            "chunk": tm.chunk_size(), "inflight": tm.max_inflight_per_source()}


def dp_make(n: int, seed: int):
    """A seeded CUDA tensor made on the card by a task, and its node (two
    returns)."""
    x = torch.randn(n, generator=cuda_gen(seed), device="cuda")
    torch.cuda.synchronize()
    return x, cl_home()


def dp_bump(i: int, marks: str) -> int:
    """test_cluster_ha.py's task, which also notes each execution."""
    with open(os.path.join(marks, str(os.getpid())), "a") as f:
        f.write(f"{i}\n")
    return i + 1


def handler_counts(stats: dict, keys) -> dict:
    return {k: stats["handlers"].get(k, {"count": 0})["count"] for k in keys}


def node_transfer(node_id: str, want) -> dict:
    """A node's transfer counters from its heartbeat (every 2 s), once
    ``want(counters)`` holds."""
    box = {}

    def ready():
        box["t"] = (rt.state.node_stats().get(node_id) or {}).get("transfer")
        return box["t"] is not None and want(box["t"])

    wait_until(f"(a) node {node_id[:12]}'s transfer counters", ready,
               timeout=30)
    return box["t"]


@contextlib.contextmanager
def env_set(env: dict):
    """``env`` in this process's environment, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_start(cluster) -> list:
    """(a) Nodes 1-3 with their own switches; their node ids in order."""
    ids = [None] * len(DP_NODES)

    def add(i):
        res, env = DP_NODES[i]
        ids[i] = cluster.add_node(dict(res), 1, env=env).node_id

    threads = [threading.Thread(target=add, args=(i,))
               for i in range(len(DP_NODES))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cluster.wait_for_nodes(len(DP_NODES) + 1)
    if None in ids:
        raise AssertionError(f"(a) nodes not started: {ids}")
    return ids


def dp_switches(ids: list, addr: dict) -> list:
    """(a) Each node's switches as a worker process there sees them, and
    each controller's frame pump: node 1 alone is pickle-only with the
    Python pump, node 2 alone unadmitted, node 3 alone chunked at 256 KiB
    with one pull in flight."""
    probe = rt.remote(dp_probe)
    seen = rt.get([probe.options(resources={f"dp{i + 1}": 1},
                                 num_cpus=CL_IN_BUNDLE).remote()
                   for i in range(len(ids))], timeout=120)
    core = global_core()
    pumps = [core._controller(addr[n]).call({"type": "stats"})["recv_stats"]
             for n in ids]
    want = [{"pickle_only": True, "client_binary": False,
             "frame_binary": False, "pump": False, "sched": True,
             "chunk": 1 << 20, "inflight": 4},
            {"pickle_only": False, "client_binary": True,
             "frame_binary": True, "pump": True, "sched": False,
             "chunk": 1 << 20, "inflight": 4},
            {"pickle_only": False, "client_binary": True,
             "frame_binary": True, "pump": True, "sched": True,
             "chunk": DP_CHUNK, "inflight": 1}]
    for i, (got, w, pump) in enumerate(zip(seen, want, pumps)):
        if tuple(got.pop("home")) != addr[ids[i]] or got != w \
                or pump.get("native") != int(w["pump"]):
            raise AssertionError(f"(a) node {i + 1}'s switches: {got}, its "
                                 f"controller's pump {pump}; want {w}")
    from ray_tpu_torch.cluster import wire

    if wire.columnar_submit_enabled() or core._ring is not None:
        raise AssertionError(f"(a) the driver's switches: columnar "
                             f"{wire.columnar_submit_enabled()}, ring "
                             f"{core._ring}")
    log(f"  (a) each node's switches, read in a worker process there: "
        f"{seen}; the controllers' frame pumps {pumps}; the driver: "
        f"per-task submits, no completion ring")
    return seen


def dp_fanout() -> float:
    """(a) Phase 11's 10k no-op fan-out; its tasks/s."""
    fn = rt.remote(noop)
    rt.get([fn.remote() for _ in range(100)], timeout=120)
    t0 = time.perf_counter()
    out = rt.get([fn.remote() for _ in range(RT_FANOUT)], timeout=600)
    tps = RT_FANOUT / (time.perf_counter() - t0)
    if out != [None] * RT_FANOUT:
        raise AssertionError("(a) the fan-out's results are wrong")
    return tps


def gated_waves(n: int, what: str, max_waves: int) -> tuple:
    """Gated waves of ``n`` no-op tasks, each reaching the GCS as one tick,
    until one takes the matrix path on the device: a wave whose bucket is
    cold goes on numpy while the GCS warms the bucket, and the next must
    take the device. (waves, device ticks of the last, the GCS's stats)."""
    fn = rt.remote(cl_noop)
    for w in range(1, max_waves + 1):
        k0 = kernel_cells(gcs_stats()).get("kernel:place", 0)
        refs, g, _ = gated_wave(fn, n, f"{what}: wave {w}")
        if rt.get(refs, timeout=600) != [None] * n:
            raise AssertionError(f"{what}: wave {w}'s results are wrong")
        stats = gcs_stats()
        ticks = kernel_cells(stats).get("kernel:place", 0) - k0
        if ticks:
            return w, ticks, stats
        wait_until(f"{what}: the GCS's warm-up of the wave's bucket",
                   lambda: kernel_cells(gcs_stats()).get("kernel:warmup"),
                   timeout=120)
    raise AssertionError(f"{what}: no gated wave took the matrix path on "
                         f"the device")


def dp_shuffle(ids: list, addr: dict) -> None:
    """(a) CL_MAPS mappers of 4 MiB on node 1; half the reducers on node 2
    (its pulls unadmitted), half on node 3 (256 KiB chunks, one in
    flight). The transfer counters of nodes 2 and 3 after."""
    before = {n: node_transfer(n, lambda t: True) for n in ids[1:]}
    maps = [rt.remote(cl_map).options(resources={"dp1": 1},
                                      num_cpus=CL_IN_BUNDLE).remote(i)
            for i in range(CL_MAPS)]
    rt.wait(maps, num_returns=CL_MAPS, timeout=120)
    half = CL_MAPS // 2
    reds = rt.get([rt.remote(cl_reduce).options(
        resources={f"dp{2 + (i >= half)}": 1},
        num_cpus=CL_IN_BUNDLE).remote(m) for i, m in enumerate(maps)],
        timeout=120)
    mapped = {tuple(h) for h, _ in rt.get(maps, timeout=120)}
    where = [tuple(h) for h, _ in reds]
    want = [addr[ids[1]]] * half + [addr[ids[2]]] * (CL_MAPS - half)
    if [i for _, i in reds] != list(range(CL_MAPS)) or where != want \
            or mapped != {addr[ids[0]]}:
        raise AssertionError(f"(a) mappers on {mapped}, reducers on {where}, "
                             f"values {[i for _, i in reds]}")
    after = {n: node_transfer(
        n, lambda t, n=n: t["pulls_ok"] - before[n]["pulls_ok"] >= half)
        for n in ids[1:]}
    t2, t3 = after[ids[1]], after[ids[2]]
    pulled = [after[n]["bytes_in"] - before[n]["bytes_in"] for n in ids[1:]]
    if t2["sched_enabled"] or t2["queued_total"] or t2["max_inflight"] != 4 \
            or not t3["sched_enabled"] or t3["max_inflight"] != 1 \
            or min(pulled) < half * CL_MAP_BYTES:
        raise AssertionError(f"(a) transfer counters: node 2 {t2}, node 3 "
                             f"{t3}, bytes pulled {pulled}")
    log(f"  (a) {CL_MAPS} mappers of {CL_MAP_BYTES >> 20} MiB on node 1, "
        f"{half} reducers each on nodes 2 and 3, every value right; bytes "
        f"pulled by nodes 2 and 3 {pulled}; node 2's transfer counters {t2} "
        f"(admission off: none queued); node 3's {t3} (one in flight a "
        f"source)")


def dp_tensor(ids: list, addr: dict, card: str) -> float:
    """(a) A 256 MiB CUDA tensor made by a task on node 1 and doubled by a
    task on node 3, which pulls it in 256 KiB chunks: node 1's transfer
    server answers one request a chunk. Returns the doubling task's GB/s
    (the pull, both copies and the doubling), as phase 11's (e)."""
    n1 = ids[0]
    s0 = node_transfer(n1, lambda t: True)
    made, made_on = rt.remote(dp_make).options(
        resources={"dp1": 1}, num_cpus=CL_IN_BUNDLE, num_returns=2).remote(
        CL_TENSOR, SEED + 16)
    rt.wait([made, made_on], num_returns=2, timeout=120)
    t0 = time.perf_counter()
    out = rt.remote(cl_double).options(resources={"dp3": 1},
                                       num_cpus=CL_IN_BUNDLE).remote(made)
    rt.wait([out], timeout=120)
    task_s = time.perf_counter() - t0
    (y, where, xdev, dbl_s), made_on = rt.get([out, made_on], timeout=120)
    big = torch.randn(CL_TENSOR, generator=cuda_gen(SEED + 16),
                      device="cuda")
    nbytes = big.nbytes
    if tuple(where) != addr[ids[2]] or tuple(made_on) != addr[n1] \
            or xdev != "cuda:0" or \
            not torch.equal(y.view(torch.int32), (big * 2).view(torch.int32)):
        raise AssertionError(f"(a) the doubled tensor: made on {made_on}, "
                             f"doubled on {where}, its input on {xdev}")
    s1 = node_transfer(n1, lambda t: t["bytes_out"] - s0["bytes_out"]
                       >= nbytes)
    reqs = s1["requests_served"] - s0["requests_served"]
    chunks = -(-nbytes // DP_CHUNK)
    if reqs < chunks:
        raise AssertionError(f"(a) node 1 answered {reqs} requests for the "
                             f"tensor; {chunks} chunks of {DP_CHUNK} bytes "
                             f"were due")
    gbps = nbytes / 1e9 / task_s
    log(f"  (a) 256 MiB CUDA tensor made on node 1, doubled on node 3 "
        f"({dbl_s * 1e3:.3f} ms on the card): the task done in {task_s:.3f}"
        f" s ({gbps:.3f} GB/s, the pull across and both copies); node 1's "
        f"server answered {reqs} requests meanwhile ({chunks} chunks of "
        f"{DP_CHUNK >> 10} KiB; at the default chunk "
        f"{-(-nbytes // (1 << 20))}); the bits equal 2 x the input [{card}]")
    return gbps


def dp_flagship(params, cfg, main: dict, ids: list, addr: dict) -> None:
    """(a) The flagship LMBackend in a num_gpus=1 actor, which lands on the
    pickle-only node 1: phase 3's tokens, K1 and K6 counted in its process
    every tick, and the card's memory back after kill()."""
    L = cfg.n_layers
    server = rt.remote(num_gpus=1)(DpServer).remote(rt.put(params), cfg)
    build_s, pid, *_ = rt.get(server.ready.remote(), timeout=600)
    home = rt.get(server.home.remote(), timeout=60)
    if tuple(home) != addr[ids[0]]:
        raise AssertionError(f"(a) the GPU actor is on {home}, not node 1")
    outs, launches, (n_pre, n_tick, ticks) = rt.get(
        server.serve_counted.remote(serving_prompts(cfg.vocab_size),
                                    NEW_TOKENS), timeout=600)
    if outs != main["outs"]:
        bad = [i for i, (a, b) in enumerate(zip(outs, main["outs"]))
               if a != b]
        raise AssertionError(f"(a) the actor's tokens differ from phase 3's "
                             f"in requests {bad}")
    per_tick = {"rms_norm": 1, "add_rms_norm": 2 * L, "decode_attention": L}
    got = {n: c for n, c in launches.items() if c}
    want = {"rms_norm": n_pre + n_tick,
            "add_rms_norm": 2 * L * (n_pre + n_tick),
            "decode_attention": L * n_tick}
    if got != want or not n_tick or any(
            {n: c for n, c in t.items() if c} != per_tick for t in ticks):
        raise AssertionError(f"(a) launches {got}, expected {want}; every "
                             f"tick {per_tick}")
    cache_bytes = rt.get(server.cache_bytes.remote())
    free0 = torch.cuda.mem_get_info()[0]
    rt.kill(server)
    wait_until("(a) the card's memory back after kill()",
               lambda: torch.cuda.mem_get_info()[0] - free0 >= cache_bytes,
               timeout=30)
    wait_until(f"(a) the actor's worker process {pid} gone after kill()",
               lambda: not alive({pid}), timeout=30)
    log(f"  (a) the num_gpus=1 actor on the pickle-only node 1 (worker "
        f"process {pid}, LMBackend built in {build_s:.3f} s): phase 3's 12 "
        f"requests, phase 3's tokens; {n_pre} prefills, {n_tick} ticks, "
        f"launches counted in its process {got}, every tick {per_tick}; "
        f"kill(): the card's free memory (device-wide) up by at least its "
        f"KV cache, {cache_bytes / 2**20:.1f} MiB")


def dp_legacy(params, cfg, main: dict, fast: dict, card: str) -> None:
    """Phase 16 (a): the legacy paths, each selected by its switch."""
    from ray_tpu_torch.cluster.testing import Cluster

    spill0, shm0 = spill_dirs(), set(os.listdir("/dev/shm"))
    t0 = time.perf_counter()
    cluster = Cluster(head_resources={"CPU": CL_HEAD["CPU"]}, num_workers=2,
                      extra_env=DP_HEAD_ENV)
    keys = ("submit_batch", "submit_batch_cols", "relay:wave",
            "relay:opaque", "relay:pickled")
    try:
        ids = dp_start(cluster)
        with env_set(DP_DRIVER_ENV):
            rt.init(address=cluster.address)
            addr = {n["NodeID"]: tuple(n["Address"]) for n in rt.nodes()
                    if n["Alive"]}
            total = rt.cluster_resources()
            if total.get("GPU") != 1 or len(addr) != len(ids) + 1:
                raise AssertionError(f"(a) nodes {addr}, resources {total}")
            log(f"  (a) the head (GCS on the card, dispatch waves off) and "
                f"{len(ids)} nodes up in {time.perf_counter() - t0:.3f} s; "
                f"resources {total}")
            h0 = handler_counts(gcs_stats(), keys)
            dp_switches(ids, addr)
            tps = dp_fanout()
            waves, ticks, _ = gated_waves(CL_WAVE, "(a)", 2)
            dp_shuffle(ids, addr)
            gbps = dp_tensor(ids, addr, card)
            dp_flagship(params, cfg, main, ids, addr)
            stats = gcs_stats()
            h1 = handler_counts(stats, keys)
            d = {k: h1[k] - h0[k] for k in keys}
            cells = kernel_cells(stats)
            res = {k: global_core().phase_stats.get(f"result:{k}", [0])[0]
                   for k in ("ring", "inline")}
            fell = {k: c for k, c in cells.items()
                    if k.startswith("kernel_fallback")}
            device = stats["place_perf"]["device"].split(":")[0]
            if d["submit_batch_cols"] or not d["submit_batch"] \
                    or d["relay:wave"] \
                    or not d["relay:opaque"] + d["relay:pickled"] \
                    or any(res.values()) or not cells.get("kernel:place") \
                    or fell or device != DEVICE:
                raise AssertionError(
                    f"(a) GCS counters over the program {d}, device passes "
                    f"{cells}, place device {stats['place_perf']['device']}, "
                    f"results by the ring {res}")
            log(f"  (a) the GCS's counters over the program {d}: per-task "
                f"submits only, assign_batch relayed and no dispatch wave; "
                f"the driver's ring and inline results {res}; device passes "
                f"{cells} on {stats['place_perf']['device']}, no fallback; "
                f"the gated wave of {CL_WAVE} on the card's matrix path at "
                f"wave {waves} ({ticks} ticks)")
            log(f"  (a) legacy paths against phase 11's fast ones, this run: "
                f"{RT_FANOUT} no-op fan-out {tps:.1f} tasks/s (phase 11: "
                f"{fast['fanout_tps']:.1f}); the 256 MiB tensor's task "
                f"{gbps:.3f} GB/s (phase 11: {fast['tensor_gbps']:.3f}) "
                f"[{card}]")
            cluster_teardown(cluster, shm0, spill0, card)
    except BaseException:
        rt.shutdown()
        cluster.shutdown()
        raise


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ha_runs(marks: str) -> collections.Counter:
    """Executions of each dp_bump task, from the notes its runs left."""
    runs = collections.Counter()
    for name in os.listdir(marks):
        with open(os.path.join(marks, name)) as f:
            runs.update(int(line) for line in f if line.strip())
    return runs


def dp_failover(card: str) -> None:
    """Phase 16 (b): test_cluster_ha.py's drill with both heads placing on
    the card."""
    from ray_tpu_torch._private.config import reset_config
    from ray_tpu_torch.cluster.testing import Cluster

    sport = free_port()
    work = tempfile.mkdtemp(prefix="ray_tpu_torch_ha_")
    marks = os.path.join(work, "marks")
    os.mkdir(marks)
    env = {"RAY_TPU_TORCH_GCS_ADDRS": f"127.0.0.1:{sport}",
           "RAY_TPU_TORCH_GCS_LEASE_TTL_S": HA_TTL_S}
    spill0, shm0 = spill_dirs(), set(os.listdir("/dev/shm"))
    torch.cuda.synchronize()
    free_base = torch.cuda.mem_get_info()[0]
    with env_set(env):
        reset_config()
        cluster = Cluster(head_resources={"CPU": 2}, num_workers=1,
                          persist_path=os.path.join(work, "gcs_state.bin"),
                          head_with_node=False)
        try:
            cluster.add_node(resources={"CPU": 2}, num_workers=2)
            cluster.start_standby(port=sport)
            rt.init(address=cluster.address)
            waves0, _, stats0 = gated_waves(HA_WAVE, "(b) the leader",
                                            HA_MAX_WAVES)
            leader_ctx = free_base - torch.cuda.mem_get_info()[0]
            if stats0["place_perf"]["device"].split(":")[0] != DEVICE \
                    or leader_ctx < 64 * 2**20:
                raise AssertionError(
                    f"(b) the leader places on "
                    f"{stats0['place_perf']['device']}, the card's memory "
                    f"down {leader_ctx} bytes")
            bump = rt.remote(dp_bump)
            refs = [bump.remote(i, marks) for i in range(HA_TASKS)]
            done, pending = rt.wait(refs, num_returns=HA_DONE_AT,
                                    timeout=120)
            if len(done) < HA_DONE_AT or not pending:
                raise AssertionError(f"(b) before the kill: {len(done)} "
                                     f"done, {len(pending)} pending")
            free_pre = torch.cuda.mem_get_info()[0]
            t_kill = time.perf_counter()
            cluster.kill_head()
            back = [0]

            def ctx_back():
                back[0] = max(back[0],
                              torch.cuda.mem_get_info()[0] - free_pre)
                return back[0] >= 0.8 * leader_ctx

            wait_until("(b) the dead leader's CUDA context memory back",
                       ctx_back, timeout=5)
            back_s = time.perf_counter() - t_kill
            ha = cluster.wait_for_leader(sport, timeout=45)
            promote_s = time.perf_counter() - t_kill
            out = rt.get(refs, timeout=240)
            last_s = time.perf_counter() - t_kill
            runs = ha_runs(marks)
            if out != [i + 1 for i in range(HA_TASKS)] \
                    or set(runs) != set(range(HA_TASKS)) \
                    or ha["failover_count"] < 1 \
                    or not ha["time_to_recover_s"] > 0.0:
                lost = [i for i, v in enumerate(out) if v != i + 1]
                raise AssertionError(f"(b) results wrong at {lost[:10]}, "
                                     f"{HA_TASKS - len(runs)} tasks never "
                                     f"run; ha_status {ha}")
            again = sum(1 for c in runs.values() if c > 1)
            waves1, _, stats1 = gated_waves(HA_WAVE, "(b) the promoted "
                                            "leader", HA_MAX_WAVES)
            device = stats1["place_perf"]["device"]
            if device.split(":")[0] != DEVICE:
                raise AssertionError(f"(b) the promoted leader places on "
                                     f"{device}")
            log(f"  (b) leader and warm standby, both placing on the card "
                f"(the leader's matrix ticks on the card from gated wave "
                f"{waves0}; the leader's process held "
                f"{leader_ctx / 2**20:.1f} MiB of the card); {HA_TASKS} "
                f"tasks, the leader SIGKILLed with {len(pending)} pending: "
                f"its memory back ({back[0] / 2**20:.1f} MiB) "
                f"{back_s:.3f} s after the kill; the standby promoted "
                f"{promote_s:.3f} s after the kill (failover_count "
                f"{ha['failover_count']}, epoch {ha['epoch']}, "
                f"time_to_recover_s {ha['time_to_recover_s']:.3f}); the "
                f"last result {last_s:.3f} s after the kill; every result "
                f"once with its value, 0 lost, 0 doubled; "
                f"{sum(runs.values())} executions ({again} tasks run twice, "
                f"retried across the failover); the promoted leader places "
                f"on {device}, its place count {kernel_cells(stats1)} from "
                f"gated wave {waves1} [{card}]")
            cluster_teardown(cluster, shm0, spill0, card)
        except BaseException:
            rt.shutdown()
            cluster.shutdown()
            raise
    reset_config()  # the config of the environment without the drill's
    shutil.rmtree(work, ignore_errors=True)


def data_plane_path(params, cfg, main: dict, fast: dict, card: str) -> None:
    """Phase 16: the data plane's legacy paths and head failover."""
    log(f"phase 16: the data plane's legacy paths (a pickle-only node, the "
        f"Python frame pump, no admission, 256 KiB chunks, per-task "
        f"submits, no completion ring, assign_batch relays) and head "
        f"failover, the GCS on the card [{card}]")
    t_phase = time.perf_counter()
    dp_legacy(params, cfg, main, fast, card)
    dp_failover(card)
    log(f"  phase 16 in {time.perf_counter() - t_phase:.1f} s")


# ---------------- phase 17: the tune and util libraries on the card (A8.1)

# (a) PBT over two trials at once, each a TPUTrainer of one worker on the
# dense flagship (bf16, f32 params, AdamW) at batch TT_B x seq TRAIN_T, one
# step an iteration; the learning-rate grid and its mutations. Both trials
# start from the same weights and batch, and PBT compares each trial's
# latest result, whichever trial has stepped further: at 1e-5 three steps
# barely move the loss, one step at 1e-3 takes it well below, so the slow
# trial is the bottom one at iteration 4 at the latest (at 2 if the other
# has reported 2 by then).
TUNE_LRS = (1e-5, 1e-3)
TUNE_MUTATIONS = [1e-5, 1e-4, 3e-4, 1e-3, 3e-3]
TUNE_ITERS, TUNE_INTERVAL = 6, 2
TUNE_RESOURCES = {"CPU": 1, "GPU": 0.5}
# The store holds an exploit's blob (the trainer's f32 parameters and AdamW
# moments, pickled on the host) as the donor's return value and as the
# recipient's argument at once, and never spills it.
TUNE_STORE = 16 * 2**30
# How far the card's free memory may stay below its value before (a) and
# before (b), read by dev_free: what stays after its clear is about 32 MiB
# for each actor thread that ran a matmul, up to 8 threads in (a) (two
# trials and their workers, and a new pair for each of two exploits). The
# H100 kept 37.6 and 192.0 MiB after (a) in two runs; the margin is 1.5
# times the larger. (a) also checks that at least one trial's state (the
# exploit's blob) comes back.
LIB_MEM_MARGIN = 288 * 2**20
# (b) An ActorPool of two GPU actors, each a GenerationEngine over the
# driver's flagship parameters; Pool.map of K1 over row blocks.
POOL_ACTORS, POOL_GPUS = 2, 0.5
POOL_ROWS, POOL_BLOCK = TT_B * TRAIN_T, 1024     # 8 blocks


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def state_digest(trainer) -> str:
    """A digest of a TPUTrainer's parameters, AdamW state and step, its
    bits mixed on the card: per tensor, the sums of its elements' bit
    patterns as int64, plain and weighted by position; only those two
    numbers a tensor come back to the host."""
    tensors = list(named_leaves(trainer.params).values())
    opt = trainer.optimizer.state_dict()["state"]
    for i in sorted(opt):
        tensors += [opt[i][k] for k in sorted(opt[i])
                    if isinstance(opt[i][k], torch.Tensor)]
    sums = []
    for t in tensors:
        bits = t.detach().to(DEVICE).reshape(-1).view(
            _INT_OF_SIZE[t.element_size()])
        plain = torch.zeros((), dtype=torch.int64, device=DEVICE)
        weighted = torch.zeros((), dtype=torch.int64, device=DEVICE)
        for start in range(0, bits.numel(), 1 << 24):
            x = bits[start:start + (1 << 24)].to(torch.int64)
            pos = torch.arange(start, start + x.numel(), device=DEVICE)
            plain += x.sum()
            weighted += (x * (pos % 65521 + 1)).sum()
        sums += [plain, weighted]
    host = torch.stack(sums).cpu().numpy()
    return hashlib.sha256(host.tobytes() + str(trainer.step).encode()
                          ).hexdigest()[:16]


def tune_trainable(cfg):
    """TPUTrainer.as_trainable over the dense flagship, one worker on
    DEVICE, under a probe: each step reports its wall (the two trials step
    at once), learning rate, the state's digest and the card's free bytes;
    a checkpoint carries the digest of the state it saved, and the step
    after a restore reports that digest beside the restored state's, the
    blob's bytes and the seconds from the save to the restore."""
    def init_fn(gen):
        return init_params(gen, cfg, device=DEVICE)

    def data_creator(rank, world, config):
        rng = np.random.default_rng(SEED + 50 + rank)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TT_B, TRAIN_T + 1))).to(DEVICE)
        while True:
            yield {"tokens": tokens}

    base = TPUTrainer.as_trainable(
        init_fn, lambda p, b: loss_fn(p, b, cfg), data_creator,
        num_workers=1, num_cpus_per_worker=1, device=DEVICE)

    class Probed(base):
        restored = None

        def step(self):
            dev_sync()
            t0 = time.perf_counter()
            result = super().step()
            dev_sync()
            wall = (time.perf_counter() - t0) * 1e3
            result.update(
                wall_ms=wall, digest=state_digest(self.trainer),
                lr=self.trainer.optimizer.param_groups[0]["lr"],
                free=(torch.cuda.mem_get_info()[0] if DEVICE == "cuda"
                      else 0))
            if self.restored:
                result.update(self.restored)
                self.restored = None
            return result

        def save_checkpoint(self, checkpoint_dir):
            path = super().save_checkpoint(checkpoint_dir)
            with open(os.path.join(checkpoint_dir, "probe.json"), "w") as f:
                json.dump({"digest": state_digest(self.trainer),
                           "donor": self.trial_id, "at": time.time()}, f)
            return path

        def load_checkpoint(self, checkpoint_path):
            super().load_checkpoint(checkpoint_path)
            where = checkpoint_path if os.path.isdir(checkpoint_path) \
                else os.path.dirname(checkpoint_path)
            with open(os.path.join(where, "probe.json")) as f:
                saved = json.load(f)
            self.restored = {
                "restored_digest": state_digest(self.trainer),
                "saved_digest": saved["digest"], "donor": saved["donor"],
                "save_to_restore_s": time.time() - saved["at"]}

        def restore_from_object(self, obj):
            super().restore_from_object(obj)
            self.restored["blob_bytes"] = len(obj)

    Probed.__name__ = "FlagshipTrainable"
    return Probed


def trial_rows(analysis) -> dict:
    """Every result each trial logged (tune.run's JsonLogger), by trial."""
    out = {}
    for t in analysis.trials:
        path = os.path.join(analysis.local_dir, f"trial_{t.trial_id}",
                            "result.json")
        with open(path) as f:
            out[t.trial_id] = [json.loads(line) for line in f]
    return out


def lib_tune(cfg, card: str) -> dict:
    """(a) tune.run of TPUTrainer.as_trainable under PBT on the card."""
    from ray_tpu_torch import tune

    L = cfg.n_layers
    per_step = train_per_step(L)
    log(f"phase 17 (a): tune.run(TPUTrainer.as_trainable(...)) under PBT, "
        f"{len(TUNE_LRS)} trials at once (resources_per_trial "
        f"{TUNE_RESOURCES}), each a TPUTrainer of 1 worker on the dense "
        f"flagship, bf16, batch {TT_B} x seq {TRAIN_T}, AdamW at "
        f"learning rates {TUNE_LRS}, perturbation_interval {TUNE_INTERVAL},"
        f" {TUNE_ITERS} iterations of 1 step")
    free0 = dev_free()
    rt.init(num_cpus=8, num_gpus=1, object_store_memory=TUNE_STORE)
    local_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_tune_")
    try:
        sched = tune.PopulationBasedTraining(
            time_attr="training_iteration", metric="loss", mode="min",
            perturbation_interval=TUNE_INTERVAL,
            hyperparam_mutations={"learning_rate": TUNE_MUTATIONS})
        dev_sync()
        reset_counts()
        t0 = time.perf_counter()
        analysis = tune.run(
            tune_trainable(cfg),
            config={"learning_rate": tune.grid_search(list(TUNE_LRS))},
            resources_per_trial=TUNE_RESOURCES, scheduler=sched,
            stop={"training_iteration": TUNE_ITERS}, local_dir=local_dir,
            verbose=0)
        run_s = time.perf_counter() - t0
        total = read_counts()
        spilled = rt.state.object_store_stats()["spilled_objects"]
        gpu_back = rt.available_resources().get("GPU")
        rows = trial_rows(analysis)
    finally:
        rt.shutdown()
        shutil.rmtree(local_dir, ignore_errors=True)
    for t in analysis.trials:
        log(f"  trial {t.trial_id} (lr {t.config['learning_rate']}, "
            f"{t.status}): loss " + ", ".join(
                f"{r['training_iteration']}: {r['loss']:.6f}"
                for r in rows.get(t.trial_id, [])))
    statuses = [t.status for t in analysis.trials]
    if statuses != ["TERMINATED"] * len(TUNE_LRS):
        raise AssertionError(f"(a) trial statuses {statuses}: "
                             f"{[t.error_msg for t in analysis.trials]}")
    if gpu_back != 1.0:
        raise AssertionError(f"(a) GPU available after tune.run: {gpu_back}")
    # The two trials step at once, and the counters are the process's: over
    # tune.run they hold one rank's train step for each step the trials
    # logged, and nothing else.
    steps = [r for rs in rows.values() for r in rs]
    by_iter = collections.Counter(r["training_iteration"] for r in steps)
    want_total = {n: len(steps) * per_step.get(n, 0) for n in COUNTED}
    if total != want_total:
        raise AssertionError(f"(a) launches over tune.run {total}, expected "
                             f"{len(steps)} steps' {want_total}")
    # PBT exploited, and the recipient holds the donor's saved state.
    exploits = [(tid, r) for tid, rs in rows.items() for r in rs
                if "restored_digest" in r]
    if sched.num_perturbations < 1 or not exploits:
        raise AssertionError(f"(a) no exploit: {sched.num_perturbations} "
                             f"perturbations, {len(exploits)} restores")
    for tid, r in exploits:
        donor_digests = {d["digest"] for d in rows.get(r["donor"], [])}
        if r["restored_digest"] != r["saved_digest"]:
            raise AssertionError(f"(a) trial {tid} restored state "
                                 f"{r['restored_digest']}, the donor saved "
                                 f"{r['saved_digest']}")
        if r["saved_digest"] not in donor_digests:
            raise AssertionError(f"(a) the donor {r['donor']} saved a state "
                                 f"none of its steps reported")
    trials = {t.trial_id: t for t in analysis.trials}
    for tid, rs in rows.items():
        if rs[-1]["lr"] != trials[tid].config["learning_rate"]:
            raise AssertionError(f"(a) trial {tid} steps at {rs[-1]['lr']}, "
                                 f"its config says "
                                 f"{trials[tid].config['learning_rate']}")
    best = min(analysis.trials, key=lambda t: t.last_result["loss"])
    curve = [r["loss"] for r in rows[best.trial_id]]
    if not (all(map(math.isfinite, curve)) and curve[-1] < curve[0]):
        raise AssertionError(f"(a) the best trial's loss did not fall: "
                             f"{curve}")
    if spilled:
        raise AssertionError(f"(a) {spilled} objects spilled: the store "
                             f"({TUNE_STORE} bytes) did not hold the blob")
    free1 = dev_free()
    if free0 - free1 > LIB_MEM_MARGIN:
        raise AssertionError(f"(a) the card holds {free0 - free1} bytes more"
                             f" after tune.run (margin {LIB_MEM_MARGIN})")
    blob = max(r["blob_bytes"] for _, r in exploits)
    back = free1 - min(r["free"] for r in steps)
    if DEVICE == "cuda" and back < blob:
        raise AssertionError(f"(a) {back} bytes came back after tune.run, "
                             f"less than one trial's state ({blob})")
    walls = [r["wall_ms"] for r in steps]
    log(f"  every trial TERMINATED; tune.run {run_s:.1f} s; {len(steps)} "
        f"steps, trials stepping at each iteration "
        f"{dict(sorted(by_iter.items()))}, two at once; launches over "
        f"tune.run {total}: the steps' count times phase 5's per step "
        f"{per_step}")
    log(f"  {sched.num_perturbations} PBT perturbations; the best trial "
        f"(lr {best.config['learning_rate']}) loss {curve}")
    for tid, r in exploits:
        log(f"  exploit: trial {tid} restored trial {r['donor']}'s state, "
            f"digest {r['restored_digest']} on the card equal to the saved "
            f"one and to the donor's step; blob {r['blob_bytes']:,} bytes "
            f"({r['blob_bytes'] / 2**30:.3f} GiB), save to restore "
            f"{r['save_to_restore_s']:.3f} s (the recipient's new trainer "
            f"built in between); learning rate after it "
            f"{rows[tid][-1]['lr']} [{card}]")
    iter_ms = float(np.median(walls))
    log(f"  a trial's iteration (1 step, the other trial stepping beside "
        f"it): median {iter_ms:.3f} ms wall, "
        f"{TT_B * TRAIN_T / iter_ms * 1e3:.1f} tokens/s; no object spilled "
        f"(store {TUNE_STORE / 2**30:.0f} GiB); the card's free memory "
        f"after tune.run {(free1 - free0) / 2**20:+.1f} MiB against before "
        f"(margin {LIB_MEM_MARGIN / 2**20:.0f} MiB), "
        f"{back / 2**20:.1f} MiB back against the trials' last step (one "
        f"trial's state {blob / 2**20:.1f} MiB) [{card}]")
    return {"launches": total, "steps": len(steps), "iter_ms": iter_ms}


class PoolEngine:
    """Phase 17 (b)'s actor: a GenerationEngine over the driver's flagship
    parameters (SLOTS, MAX_SEQ), warmed as phase 3's, under a PathProbe
    that counts its prefills and ticks."""

    def __init__(self, params, cfg):
        self.params = params
        with torch.inference_mode():
            self.eng = engine_mod.GenerationEngine(
                params, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                device=DEVICE)
            run_engine(self.eng, [([1, 2, 3], 4, {})])
        self.probe = PathProbe(self.eng)

    def param_ptrs(self) -> list:
        return [t.data_ptr() for t in named_leaves(self.params).values()]

    def cache_bytes(self) -> int:
        return self.eng.cache_k.nbytes + self.eng.cache_v.nbytes

    def serve(self, prompts) -> list:
        with torch.inference_mode():
            return run_engine(self.eng,
                              [(p, NEW_TOKENS, {}) for p in prompts])

    def probed(self) -> tuple:
        return len(self.probe.prefills), len(self.probe.ticks)

    def __ray_shutdown__(self):
        """kill() frees the engine's cache: the probe holds it too."""
        self.probe = None
        self.eng = None


def lib_pool(params, cfg, main: dict, refs: dict, card: str) -> dict:
    """(b) util on the card: an ActorPool of GPU actors serving phase 3's
    prompts, and multiprocessing.Pool.map of K1 over CUDA row blocks."""
    from ray_tpu_torch.util import ActorPool
    from ray_tpu_torch.util.multiprocessing import Pool

    L = cfg.n_layers
    log(f"phase 17 (b): util.ActorPool of {POOL_ACTORS} actors "
        f"(num_gpus={POOL_GPUS}), each a GenerationEngine over the driver's "
        f"flagship parameters ({SLOTS} slots, max_seq {MAX_SEQ}); "
        f"util.multiprocessing.Pool.map of K1 over {POOL_ROWS // POOL_BLOCK} "
        f"CUDA blocks of {POOL_BLOCK} rows")
    prompts = serving_prompts(cfg.vocab_size)
    free0 = dev_free()
    rt.init(num_cpus=8, num_gpus=1)
    try:
        dev_sync()
        mem0 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        pref = rt.put(params)
        actors = [rt.remote(num_gpus=POOL_GPUS)(PoolEngine).remote(pref, cfg)
                  for _ in range(POOL_ACTORS)]
        ptrs = rt.get([a.param_ptrs.remote() for a in actors], timeout=600)
        cache = sum(rt.get([a.cache_bytes.remote() for a in actors]))
        held_gpu = rt.available_resources().get("GPU", 0.0)
        want_ptrs = [t.data_ptr() for t in named_leaves(params).values()]
        if any(p != want_ptrs for p in ptrs) or held_gpu != 0.0:
            raise AssertionError(f"(b) the actors' parameters are not the "
                                 f"driver's tensors, or the GPU left free is "
                                 f"{held_gpu}")
        pool = ActorPool(actors)
        half = len(prompts) // 2
        reset_counts()
        t0 = time.perf_counter()
        parts = list(pool.map(lambda a, ps: a.serve.remote(ps),
                              [prompts[:half], prompts[half:]]))
        wall = time.perf_counter() - t0
        launches = read_counts()
        outs = parts[0] + parts[1]
        # The two actors serve at once, and the counters are the
        # process's: 17 K1 for each prefill and tick and 8 K6 for each tick
        # of either actor, and nothing else.
        probed = rt.get([a.probed.remote() for a in actors])
        per_tick = {"rms_norm": 1, "add_rms_norm": 2 * L,
                    "decode_attention": L}
        per_prefill = {"rms_norm": 1, "add_rms_norm": 2 * L}
        for i, (_, ticks) in enumerate(probed):
            if not ticks:
                raise AssertionError(f"(b) actor {i} ran no tick")
        n_pre = sum(pre for pre, _ in probed)
        n_tick = sum(ticks for _, ticks in probed)
        want = {"rms_norm": n_pre + n_tick,
                "add_rms_norm": 2 * L * (n_pre + n_tick),
                "decode_attention": L * n_tick}
        if {n: c for n, c in launches.items() if c} != want:
            raise AssertionError(f"(b) launches over pool.map {launches}, "
                                 f"expected {want}")
        flips = greedy_flips("(b) ActorPool", outs, main["outs"], prompts,
                             refs["gaps"])
        dev_sync()
        mem_held = torch.cuda.memory_allocated() if DEVICE == "cuda" \
            else 0
        for a in actors:
            rt.kill(a)
        del pool, actors
        gc.collect()
        dev_sync()
        freed = mem_held - (torch.cuda.memory_allocated()
                            if DEVICE == "cuda" else 0)
        if DEVICE == "cuda" and freed < cache:
            raise AssertionError(f"(b) kill() freed {freed} bytes, less than "
                                 f"the actors' KV caches ({cache})")
        if rt.available_resources().get("GPU") != 1.0:
            raise AssertionError("(b) the GPU did not come back after kill()")
        log(f"  12 greedy requests in two halves through pool.map in "
            f"{wall:.3f} s; the actors' parameters at the driver's data_ptr; "
            f"{len(flips)} of {len(prompts)} requests differ from phase 3's "
            f"tokens, each first at a near tie ({FLIP_ULPS} bf16 ulps); "
            f"{n_pre} prefills and {n_tick} ticks over both actors "
            f"({probed}), serving at once; launches {want}: {per_tick} a "
            f"tick and {per_prefill} a prefill")
        log(f"  kill() of both actors freed {freed / 2**20:.1f} MiB (their KV "
            f"caches {cache / 2**20:.1f} MiB; device memory before the "
            f"actors {mem0 / 2**20:.1f} MiB) [{card}]")

        # Pool.map of K1 over CUDA row blocks.
        x, w = rms_inputs(POOL_ROWS, torch.bfloat16, seed=SEED + 17)
        x, w = x.to(DEVICE), w.to(DEVICE)
        blocks = list(x.split(POOL_BLOCK))
        dev_sync()
        reset_counts()
        t0 = time.perf_counter()
        with Pool(POOL_ACTORS) as mp_pool:
            got = mp_pool.map(functools.partial(k1_task, w=w), blocks)
        dev_sync()
        map_s = time.perf_counter() - t0
        counts = {n: c for n, c in read_counts().items() if c}
        if counts != {"rms_norm": len(blocks)}:
            raise AssertionError(f"(b) Pool.map launches {counts}, expected "
                                 f"{len(blocks)} K1")
        for i, ((ptr, out), blk) in enumerate(zip(got, blocks)):
            if ptr != blk.data_ptr() or out.device != blk.device:
                raise AssertionError(f"(b) Pool.map block {i} was copied or "
                                     f"left the card")
        err = check_close(
            f"(b) Pool.map: rms_norm [{POOL_ROWS}, {cfg.d_model}] bfloat16 "
            f"in {len(blocks)} blocks", torch.cat([o for _, o in got]),
            fused._rms_norm_ref(x, w, EPS), atol=2e-2, rtol=2e-2)
        log(f"  Pool({POOL_ACTORS}).map: {len(blocks)} blocks, one K1 launch "
            f"each on the block in place (no copy), max |err| vs the plain "
            f"version {err:.3e} (atol = rtol = 2e-2), {map_s * 1e3:.3f} ms "
            f"[{card}]")
        del x, w, blocks, got
    finally:
        rt.shutdown()
    free1 = dev_free()
    if free0 - free1 > LIB_MEM_MARGIN:
        raise AssertionError(f"(b) the card holds {free0 - free1} bytes more "
                             f"after the pools (margin {LIB_MEM_MARGIN})")
    log(f"  the card's free memory after the pools {(free1 - free0) / 2**20:+.1f}"
        f" MiB against before (margin {LIB_MEM_MARGIN / 2**20:.0f} MiB)")
    return {"launches": launches, "flips": len(flips)}


def library_path(params, cfg, main: dict, refs: dict, card: str) -> dict:
    """Phase 17: the tune and util libraries on the card."""
    t_phase = time.perf_counter()
    out = {"tune": lib_tune(cfg, card),
           "pool": lib_pool(params, cfg, main, refs, card)}
    log(f"  phase 17 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# -------------------------------- phase 18: streaming and distributed arrays

ARR_N = 4096                     # (a) 8 x 8 blocks of 512: 64 MiB an array
STREAM_ITEMS, STREAM_ROWS = 64, 512   # (b) [512, 1024] bf16: 1 MiB an item
STREAM_BATCH = 4                 # 4 MiB batches in the 8 MiB ring
STREAM_KEYS = 4
STREAM_SLEEP_S = 0.005           # (c) the slow sink, a call


def arrays_path(card: str) -> dict:
    """(a) experimental.array at 4096 x 4096 f32 on the card: every block
    a CUDA tensor, dot within _dot_bound of one torch.matmul, the
    elementwise ops, transpose and dot(eye, a) exact."""
    from ray_tpu_torch.experimental import array as ra

    n = ARR_N
    dev = torch.device(DEVICE, 0) if DEVICE == "cuda" else torch.device(
        "cpu")
    log(f"phase 18 (a): experimental.array at {n} x {n} float32, blocks "
        f"of {ra.BLOCK_SIZE} ({n // ra.BLOCK_SIZE} x {n // ra.BLOCK_SIZE}), "
        f"device={DEVICE!r}")
    a = ra.random((n, n), seed=1, device=DEVICE)
    b = ra.random((n, n), seed=2, device=DEVICE)
    A, B = a.assemble(), b.assemble()
    dev_sync()
    t0 = time.perf_counter()
    c = ra.dot(a, b)
    rt.get(list(c.blocks.flat))
    dev_sync()
    dot_wall = time.perf_counter() - t0
    ident = ra.eye(n, device=DEVICE)
    arrays = {"a": a, "b": b, "dot": c, "add": ra.add(a, b),
              "subtract": ra.subtract(a, b), "transpose": ra.transpose(a),
              "eye": ident, "eye_a": ra.dot(ident, a)}
    for name, arr in arrays.items():
        for ref in arr.blocks.flat:
            blk = rt.get(ref)
            if not isinstance(blk, torch.Tensor) or blk.device != dev \
                    or blk.dtype != torch.float32:
                raise AssertionError(f"(a) a block of {name} is "
                                     f"{type(blk).__name__} on "
                                     f"{getattr(blk, 'device', None)}")
    exact = {"add": A + B, "subtract": A - B, "transpose": A.t(),
             "eye": torch.eye(n, device=A.device), "eye_a": A}
    for name, want in exact.items():
        got = arrays[name].assemble()
        if got.device != A.device or not torch.equal(got, want):
            raise AssertionError(f"(a) {name} differs from its exact answer")
    C = c.assemble()
    one = torch.matmul(A, B)
    gap = (C.double() - one.double()).abs()
    bnd = ra._dot_bound(A, B)
    ratio = torch.where(gap > 0, gap / bnd, 0.0).max().item()
    if not torch.isfinite(C).all() or ratio > 1.0:
        raise AssertionError(f"(a) dot is {ratio:.3f} times its bound away "
                             f"from one torch.matmul")
    mm_ms = device_ms("torch.matmul", torch.matmul, [(A, B)], 5) \
        if DEVICE == "cuda" else float("nan")
    log(f"  random x2, dot, add, subtract, transpose, eye and dot(eye, a): "
        f"every block a float32 tensor on {dev}; add, subtract, transpose "
        f"and dot(eye, a) exact; dot against one torch.matmul: max |gap| "
        f"{gap.max().item():.3e}, at most {ratio:.4f} of the bound "
        f"2 gamma_K (|A| @ |B|), K {n}")
    log(f"  dot's {c.blocks.size} output-block tasks: {dot_wall * 1e3:.3f} "
        f"ms wall; one torch.matmul [{n}, {n}] x [{n}, {n}] f32 (TF32 off): "
        f"{mm_ms:.3f} ms device time [{card}]")
    del arrays, a, b, c, ident, A, B, C, one, gap, bnd, exact
    return {"dot_wall_ms": dot_wall * 1e3, "matmul_ms": mm_ms,
            "dot_ratio": ratio}


def stream_k1(item, w):
    i, x = item
    return i, fused.rms_norm(x, w, EPS)


def stream_key(item):
    # A Python int: keyed routing hashes repr(key), and a tensor's repr
    # carries its device and formatting.
    return item[0] % STREAM_KEYS


def stream_sum(acc, item):
    # float64: every partial sum of these bf16 terms is exact (checked by
    # sums_are_exact), so the order in which the two key_by instances'
    # batches arrive cannot change a bit.
    return acc[0], acc[1].double() + item[1].double()


def slow_sink(item):
    time.sleep(STREAM_SLEEP_S)


def sums_are_exact(terms) -> bool:
    """Whether every float64 sum, elementwise, of ``terms`` (bf16 tensors)
    is exact in any order: a bf16 value is an 8-bit integer times
    2^(e-8), so each partial sum of n terms is a multiple of 2^(e_min-8)
    below n * 2^e_max, which float64 holds while e_max - e_min + 8 +
    ceil(log2 n) <= 53."""
    stack = torch.stack(list(terms)).double()
    nz = stack != 0
    e = torch.frexp(stack).exponent
    hi = torch.where(nz, e, -(1 << 20)).amax(0)
    lo = torch.where(nz, e, 1 << 20).amin(0)
    span = (hi - lo)[nz.any(0)]
    need = 8 + math.ceil(math.log2(len(stack)))
    return span.numel() == 0 or int(span.max()) + need <= 53


class RingMeter:
    """Counts the bytes, writes and longest wait of every native-ring write
    of the streaming workers (_OutChannel._write_with_backpressure), while
    installed."""

    def __init__(self):
        from ray_tpu_torch.streaming import worker as stream_worker

        self.cls = stream_worker._OutChannel
        self.lock = threading.Lock()
        self.bytes = self.writes = 0
        self.max_wait_s = 0.0

    def __enter__(self):
        orig = self.orig = self.cls._write_with_backpressure
        meter = self

        def write(ch, payload):
            t0 = time.perf_counter()
            orig(ch, payload)
            waited = time.perf_counter() - t0
            with meter.lock:
                meter.bytes += len(payload)
                meter.writes += 1
                meter.max_wait_s = max(meter.max_wait_s, waited)

        self.cls._write_with_backpressure = write
        return self

    def __exit__(self, *exc):
        self.cls._write_with_backpressure = self.orig


def stream_job(xs, w, sink=None) -> tuple:
    """(b)'s job: (index, x) items through K1 in two map instances, keyed by
    index mod 4 over two key_by instances, summed over two reduce
    instances, into one sink. Returns the context (not shut down), the
    sink's results, the wall of submit(), the ring's meter and every
    edge's transport."""
    from ray_tpu_torch.streaming import StreamingContext

    ctx = StreamingContext(batch_size=STREAM_BATCH)
    (ctx.from_collection(list(enumerate(xs)))
        .map(functools.partial(stream_k1, w=w), parallelism=2)
        .key_by(stream_key, parallelism=2)
        .reduce(stream_sum, parallelism=2)
        .sink(sink))
    with RingMeter() as meter:
        t0 = time.perf_counter()
        results = ctx.submit()
        dev_sync()
        wall = time.perf_counter() - t0
    transports = {k: v for ws in ctx._workers.values() for wk in ws
                  for k, v in rt.get(wk.transports.remote()).items()}
    return ctx, results, wall, meter, transports


def check_stream(what: str, ctx, results, transports, eager: dict) -> None:
    # source -> map 1 x 2, map -> key_by 2 x 2, key_by -> reduce 2 x 2,
    # reduce -> sink 2 x 1: 12 channels.
    if len(transports) != 12 or set(transports.values()) != {"native"}:
        raise AssertionError(f"{what}: not every edge took the native ring: "
                             f"{transports}")
    if sorted(k for k, _ in results) != list(range(STREAM_KEYS)):
        raise AssertionError(f"{what}: the sink holds keys "
                             f"{[k for k, _ in results]}")
    for key, (_, total) in results:
        if total.device != eager[key].device \
                or not torch.equal(total, eager[key]):
            raise AssertionError(f"{what}: key {key}'s sum differs from the "
                                 f"eager loop's")
    stats = ctx.stats()
    n = STREAM_ITEMS
    want = {"source_0": (n, n), "map_1": (n, n), "key_by_2": (n, n),
            "reduce_3": (n, STREAM_KEYS), "sink_4": (STREAM_KEYS, 0)}
    got = {k: (v["records_in"], v["records_out"]) for k, v in stats.items()}
    if got != want:
        raise AssertionError(f"{what}: stats {got}, expected {want}")


def ring_cost(xs, card: str) -> str:
    """What one CUDA batch of (b) costs through the ring's pickle: the
    sender's dumps (a copy to the host) and the reader's loads (a copy
    back to the card), each on this thread."""
    import pickle

    batch = list(enumerate(xs[:STREAM_BATCH]))
    payload = pickle.dumps(batch, protocol=5)
    pickle.loads(payload)
    reps = 5
    dev_sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        pickle.dumps(batch, protocol=5)
    dump_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        back = pickle.loads(payload)
    dev_sync()
    load_s = (time.perf_counter() - t0) / reps
    if back[0][1].device != xs[0].device or not torch.equal(back[0][1],
                                                            xs[0]):
        raise AssertionError("(b) a batch did not come back from its "
                             "pickle on the card with its bits")
    nbytes = sum(x.nbytes for x in xs[:STREAM_BATCH])
    return (f"one batch of {STREAM_BATCH} CUDA items ({nbytes / 2**20:.1f} "
            f"MiB of tensor, {len(payload) / 2**20:.3f} MiB pickled): "
            f"dumps {dump_s * 1e3:.3f} ms ({nbytes / dump_s / 1e9:.2f} GB/s, "
            f"device to host), loads {load_s * 1e3:.3f} ms "
            f"({nbytes / load_s / 1e9:.2f} GB/s, host to device) [{card}]")


def holders(obj, depth: int = 5) -> list:
    """What keeps ``obj`` alive, up to ``depth`` referrers up: each frame by
    its function and line, each container by its type."""
    me = sys._getframe()
    seen = {id(me)}
    frontier, found = [obj], []
    for level in range(depth):
        seen.add(id(frontier))
        nxt: list = []
        seen.add(id(nxt))
        for o in frontier:
            for r in gc.get_referrers(o):
                if id(r) in seen:
                    continue
                seen.add(id(r))
                if isinstance(r, types.FrameType):
                    found.append(f"{level}: frame {r.f_code.co_name}:"
                                 f"{r.f_lineno}")
                elif type(r).__module__ != "builtins" or isinstance(
                        r, (dict, list, tuple, types.CellType)):
                    found.append(f"{level}: {type(r).__name__}")
                    nxt.append(r)
        frontier = nxt
    return found


def stream_teardown(what: str, ctx, mem0: int, sums: list) -> int:
    """ctx.shutdown() must give the card's memory back to mem0 (the level
    before the job) and free the sink's sums (``sums``: weak references to
    them); on a failure, what still holds them."""
    ctx.shutdown()
    gc.collect()
    dev_sync()
    mem1 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    live = [t for t in (r() for r in sums) if t is not None]
    if mem1 != mem0 or live:
        n_live = len(live)
        why = (f"{n_live} of the sink's {len(sums)} sums alive, the first"
               f" held by {holders(live.pop())}" if live else
               f"none of the sink's {len(sums)} sums alive")
        del live
        print(f"  {what}: {why}", file=sys.stderr, flush=True)
        raise AssertionError(f"{what}: the card holds {mem1 - mem0} bytes "
                             f"more after ctx.shutdown() than before the "
                             f"job, or a sum of the sink outlived it")
    return mem1


def stream_path(card: str) -> dict:
    """(b) and (c): DataStream jobs carrying CUDA tensors through K1."""
    import ray_tpu_torch.experimental as rx

    d = FLAGSHIP["d_model"]
    log(f"phase 18 (b): a DataStream of {STREAM_ITEMS} CUDA tensors "
        f"[{STREAM_ROWS}, {d}] bf16 (1 MiB each): map(rms_norm, K1, "
        f"parallelism=2) -> key_by(index % {STREAM_KEYS}, parallelism=2) -> "
        f"reduce(float64 elementwise sum, parallelism=2) -> sink, batches "
        f"of {STREAM_BATCH} on the native ring")
    g = cuda_gen(SEED + 18) if DEVICE == "cuda" else \
        torch.Generator().manual_seed(SEED + 18)
    xs = [torch.randn(STREAM_ROWS, d, generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(STREAM_ITEMS)]
    w = (1.0 + 0.1 * torch.randn(d, generator=g, device=DEVICE)).to(
        torch.bfloat16)
    cost = ring_cost(xs, card)
    reset_counts()
    ys = [fused.rms_norm(x, w, EPS) for x in xs]
    if not all(sums_are_exact(ys[k::STREAM_KEYS])
               for k in range(STREAM_KEYS)):
        raise AssertionError("(b) a float64 sum of these K1 outputs would "
                             "round: the sums would depend on arrival order")
    eager: dict = {}
    for i, y in enumerate(ys):
        k = i % STREAM_KEYS
        eager[k] = y.double() if k not in eager else eager[k] + y.double()
    del ys
    dev_sync()
    mem0 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    ctx, results, wall, meter, transports = stream_job(xs, w)
    launches = {n: c for n, c in read_counts().items() if c}
    if launches != {"rms_norm": 2 * STREAM_ITEMS}:
        raise AssertionError(f"(b) launches {launches}: expected "
                             f"{STREAM_ITEMS} K1 in the stream and "
                             f"{STREAM_ITEMS} in the eager loop")
    check_stream("(b)", ctx, results, transports, eager)
    sums = [weakref.ref(total) for _, (_, total) in results]
    del results
    stream_teardown("(b)", ctx, mem0, sums)
    log(f"  the sink's {STREAM_KEYS} sums bit-equal to the eager loop's; "
        f"rms_norm.launches +{2 * STREAM_ITEMS} ({STREAM_ITEMS} in the "
        f"stream, {STREAM_ITEMS} eager); all {len(transports)} channels on "
        f"the native ring; keys are Python ints (a tensor key's repr "
        f"carries its device)")
    log(f"  {STREAM_ITEMS} records in {wall * 1e3:.3f} ms: "
        f"{STREAM_ITEMS / wall:.1f} records/s; {meter.writes} ring writes "
        f"of {meter.bytes / 2**20:.1f} MiB: {meter.bytes / wall / 1e9:.3f} "
        f"GB/s through the rings; longest write {meter.max_wait_s * 1e3:.3f}"
        f" ms [{card}]")
    log(f"  {cost}")

    log(f"phase 18 (c): (b) again with a sink that sleeps "
        f"{STREAM_SLEEP_S * 1e3:.0f} ms a call, then internal_kv and "
        f"set_resource on this runtime")
    reset_counts()
    ctx, results, wall_c, meter_c, transports = stream_job(xs, w, slow_sink)
    check_stream("(c)", ctx, results, transports, eager)
    if read_counts()["rms_norm"] != STREAM_ITEMS:
        raise AssertionError("(c) the stream's K1 launches are not "
                             f"{STREAM_ITEMS}")
    sums = [weakref.ref(total) for _, (_, total) in results]
    del results
    stream_teardown("(c)", ctx, mem0, sums)
    log(f"  completed with the same sums in {wall_c * 1e3:.3f} ms (against "
        f"{wall * 1e3:.3f} ms), longest ring write "
        f"{meter_c.max_wait_s * 1e3:.3f} ms; the card's allocated memory back"
        f" at {mem0 / 2**20:.1f} MiB after each ctx.shutdown() [{card}]")

    # The reference's internal kv and dynamic-resource programs.
    if rx._internal_kv_get(b"k") is not None \
            or rx._internal_kv_put(b"k", b"v1") is not False \
            or rx._internal_kv_put(b"k", b"v2", overwrite=False) is not True \
            or rx._internal_kv_get(b"k") != b"v1" \
            or rx._internal_kv_put(b"k", b"v3") is not True \
            or rx._internal_kv_get(b"k") != b"v3" \
            or not rx._internal_kv_exists(b"k"):
        raise AssertionError("(c) internal_kv put/get gave the wrong answer")
    rx._internal_kv_del(b"k")
    if rx._internal_kv_exists(b"k"):
        raise AssertionError("(c) internal_kv del left the key")
    for builtin in ("CPU", "GPU"):
        try:
            rx.set_resource(builtin, 4)
        except ValueError:
            continue
        raise AssertionError(f"(c) set_resource({builtin!r}) did not raise")
    rx.set_resource("widget", 2)
    if rt.cluster_resources().get("widget") != 2.0:
        raise AssertionError("(c) set_resource did not add the resource")
    if rt.get(rt.remote(resources={"widget": 1})(noop).remote(),
              timeout=60) is not None:
        raise AssertionError("(c) a task demanding the resource failed")
    rx.set_resource("widget", 0)
    if "widget" in rt.cluster_resources():
        raise AssertionError("(c) set_resource(0) left the resource")
    log("  internal_kv put/get/exists/del and set_resource (CPU and GPU "
        "refused, a custom resource added, used by a task, deleted) as the "
        "reference's tests run them")
    del xs, w, eager
    return {"records_per_s": STREAM_ITEMS / wall,
            "ring_gbps": meter.bytes / wall / 1e9, "wall_ms": wall * 1e3,
            "slow_wall_ms": wall_c * 1e3}


def streaming_path(card: str) -> dict:
    """Phase 18: streaming and distributed arrays on the card, on a fresh
    local runtime."""
    t_phase = time.perf_counter()
    free0 = dev_free()
    alloc0 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    rt.init(num_cpus=8, num_gpus=1)
    try:
        out = {"arrays": arrays_path(card)}
        free_a = dev_free()
        log(f"  after (a), the card's free memory (device-wide) "
            f"{(free_a - free0) / 2**20:+.1f} MiB against before, with "
            f"{threading.active_count()} threads in this process [{card}]")
        out["stream"] = stream_path(card)
    finally:
        rt.shutdown()
    free1 = dev_free()
    alloc1 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    log(f"  after the phase, the card's free memory (device-wide) "
        f"{(free1 - free0) / 2**20:+.1f} MiB and this process's allocated "
        f"memory {(alloc1 - alloc0) / 2**20:+.1f} MiB against before; phase "
        f"18 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


# ------------------------------------- phase 19: rllib on the card (A8.4 (i))

# (b): PPO on CartPole at PPO_CONFIG (ray_tpu_torch/rllib/agents/ppo.py),
# 2 rollout workers of 8 envs: 2,048 steps an iteration.
RL_CARTPOLE = {"env": "CartPole", "num_workers": 2, "num_envs_per_worker": 8,
               "seed": 0}
RL_TARGET, RL_MAX_ITERS = 150.0, 30
# (a): the learners' f32 losses and gradients on the card against the
# CPU's, normwise per leaf (max |card - cpu| over max |cpu|). The card and
# the CPU sum in different orders; the longest sum here has n = 1,024 rows,
# whose rounding error is at most about n u = 6.1e-5 of the terms' scale
# (u = 2^-24), and 1e-4 allows for the three layers it passes through. One
# Adam step taken from the same gradients on both: each element is the same
# few f32 operations, within a few ulps of parameters of order 1.
RL_GRAD_BOUND = 1e-4
RL_STEP_BOUND = 1e-6
# (c): each other trainer of the part at its reference test's config and
# min_reward (tests/test_rllib.py), on StatelessBandit or TwoStepGame.
_RL_BANDIT = {"env": "StatelessBandit"}
RL_BANDITS = [
    ("PG", "PGTrainer", {**_RL_BANDIT, "num_workers": 0,
                         "num_envs_per_worker": 8,
                         "rollout_fragment_length": 8, "lr": 0.05,
                         "hiddens": [16], "seed": 1}, 40, 0.85),
    ("A2C", "A2CTrainer", {**_RL_BANDIT, "num_workers": 0,
                           "num_envs_per_worker": 8,
                           "rollout_fragment_length": 8, "lr": 0.05,
                           "hiddens": [16], "seed": 1}, 40, 0.85),
    ("A3C", "A3CTrainer", {**_RL_BANDIT, "num_workers": 2,
                           "num_envs_per_worker": 8,
                           "rollout_fragment_length": 8,
                           "grads_per_step": 4, "lr": 0.02,
                           "hiddens": [16], "seed": 1,
                           "entropy_coeff": 0.001}, 40, 0.85),
    ("DQN", "DQNTrainer", {**_RL_BANDIT, "num_workers": 0,
                           "num_envs_per_worker": 4,
                           "rollout_fragment_length": 8,
                           "train_batch_size": 32, "learning_starts": 64,
                           "epsilon_timesteps": 300, "final_epsilon": 0.02,
                           "num_train_batches_per_step": 8, "lr": 0.01,
                           "hiddens": [16], "seed": 0}, 40, 0.8),
    ("APEX", "ApexTrainer", {**_RL_BANDIT, "num_workers": 2,
                             "num_envs_per_worker": 4,
                             "rollout_fragment_length": 8,
                             "train_batch_size": 32, "learning_starts": 64,
                             "num_replay_shards": 2,
                             "epsilon_timesteps": 300, "final_epsilon": 0.02,
                             "num_train_batches_per_step": 8, "lr": 0.01,
                             "hiddens": [16], "seed": 0}, 50, 0.8),
    ("IMPALA", "ImpalaTrainer", {**_RL_BANDIT, "num_workers": 2,
                                 "num_envs_per_worker": 4,
                                 "rollout_fragment_length": 8,
                                 "train_batch_size": 64,
                                 "sgd_minibatch_size": 32, "num_sgd_iter": 2,
                                 "lr": 0.02, "hiddens": [16], "seed": 1,
                                 "entropy_coeff": 0.001}, 40, 0.85),
    ("IMPALA tree", "ImpalaTrainer", {**_RL_BANDIT, "num_workers": 3,
                                      "num_aggregation_workers": 2,
                                      "num_envs_per_worker": 4,
                                      "rollout_fragment_length": 8,
                                      "train_batch_size": 64,
                                      "sgd_minibatch_size": 32,
                                      "num_sgd_iter": 2, "lr": 0.02,
                                      "hiddens": [16], "seed": 1,
                                      "entropy_coeff": 0.001}, 40, 0.85),
    ("APPO", "APPOTrainer", {**_RL_BANDIT, "num_workers": 2,
                             "num_envs_per_worker": 4,
                             "rollout_fragment_length": 8,
                             "train_batch_size": 64,
                             "sgd_minibatch_size": 32, "lr": 0.02,
                             "hiddens": [16], "seed": 1,
                             "entropy_coeff": 0.001}, 40, 0.85),
    ("DD-PPO", "DDPPOTrainer", {**_RL_BANDIT, "num_workers": 2,
                                "num_envs_per_worker": 4,
                                "rollout_fragment_length": 16,
                                "sgd_minibatch_size": 32, "num_sgd_iter": 4,
                                "lr": 0.02, "hiddens": [16], "seed": 1,
                                "entropy_coeff": 0.001}, 30, 0.85),
    ("ES", "ESTrainer", {**_RL_BANDIT, "num_workers": 2,
                         "episodes_per_batch": 16, "sigma": 0.1,
                         "step_size": 0.1, "max_episode_steps": 1,
                         "hiddens": [8]}, 25, 1.0),
    ("ARS", "ARSTrainer", {**_RL_BANDIT, "num_workers": 2,
                           "episodes_per_batch": 16, "top_directions": 4,
                           "sigma": 0.1, "step_size": 0.2,
                           "max_episode_steps": 4, "hiddens": [8],
                           "seed": 0}, 25, 1.0),
]
# The multi-agent shared policy sampled by 2 remote workers, on TwoStepGame.
RL_MULTI = ({"rollout_fragment_length": 32, "lr": 0.01, "hiddens": [16],
             "seed": 0, "entropy_coeff": 0.01}, 40, 13.5)
# (c), the second part's trainers: (name, class, config, iterations, the
# result's key, its min reward), each its reference test's
# (tests/test_rllib.py); MARWIL trains its 15 steps with no early stop,
# and RL_CHECKS holds the tests' other asserts.
_RL_CONTROL = {"env": "MoveToTarget", "num_workers": 0,
               "num_envs_per_worker": 8, "rollout_fragment_length": 4,
               "train_batch_size": 64, "learning_starts": 128,
               "num_train_batches_per_step": 16, "lr": 3e-3,
               "exploration_noise": 0.15, "hiddens": [32, 32]}
RL_PART2 = [
    ("SAC", "SACTrainer", {**_RL_BANDIT, "num_workers": 0,
                           "num_envs_per_worker": 4,
                           "rollout_fragment_length": 8,
                           "train_batch_size": 32, "learning_starts": 64,
                           "num_train_batches_per_step": 8, "lr": 0.01,
                           "target_entropy": 0.05, "hiddens": [16],
                           "seed": 0}, 40, "episode_reward_mean", 0.8),
    ("Dyna", "DynaTrainer", {**_RL_BANDIT, "num_workers": 0,
                             "num_envs_per_worker": 4,
                             "rollout_fragment_length": 8,
                             "train_batch_size": 32, "learning_starts": 64,
                             "num_train_batches_per_step": 2,
                             "imagined_batches_per_step": 6,
                             "model_train_batches_per_step": 6,
                             "epsilon_timesteps": 300, "final_epsilon": 0.02,
                             "lr": 0.01, "model_lr": 0.01, "hiddens": [16],
                             "model_hiddens": [16], "seed": 0}, 50,
     "episode_reward_mean", 0.8),
    ("TD3", "TD3Trainer", {**_RL_CONTROL, "seed": 0}, 70,
     "episode_reward_mean", -0.15),
    ("DDPG", "DDPGTrainer", {**_RL_CONTROL, "seed": 1}, 70,
     "episode_reward_mean", -0.18),
    ("MAML", "MAMLTrainer", {"env": "TaskBandit", "num_workers": 0,
                             "num_envs_per_worker": 8,
                             "rollout_fragment_length": 8,
                             "meta_batch_size": 8, "inner_lr": 3.0,
                             "meta_lr": 0.03, "hiddens": [16], "seed": 1},
     50, "post_adapt_reward_mean", 0.6),
    ("QMIX", "QMIXTrainer", {"seed": 1, "lr": 5e-3, "episodes_per_step": 8,
                             "epsilon_timesteps": 800, "final_epsilon": 0.02,
                             "learning_starts": 64,
                             "num_train_batches_per_step": 4,
                             "target_update_freq": 5, "hiddens": [32],
                             "mixing_embed": 8}, 80, "episode_reward_mean",
     15.0),
    ("MARWIL", "MARWILTrainer", {"obs_dim": 1, "num_actions": 4,
                                 "beta": 1.0, "lr": 0.01, "hiddens": [16],
                                 "updates_per_step": 20}, 15, "bc_loss",
     None),
]


def rl_on(params, what: str) -> None:
    """Every leaf of a learner's parameter tree lies on the phase's
    device."""
    bad = [tuple(p.shape) for p in rl_leaves(params)
           if p.device.type != DEVICE]
    if bad:
        raise AssertionError(f"{what}: parameters {bad} are not on "
                             f"{DEVICE!r}")


def rl_leaves(tree) -> list:
    from ray_tpu_torch._tree import tree_leaves

    return [p for p in tree_leaves(tree) if isinstance(p, torch.Tensor)]


def rl_normwise(got, want) -> float:
    """The largest, over leaves, of max |got - want| / max |want|."""
    worst = 0.0
    for g, w in zip(rl_leaves(got), rl_leaves(want)):
        w = w.double()
        scale = w.abs().max().item() or 1.0
        worst = max(worst, (g.cpu().double() - w).abs().max().item() / scale)
    return worst


def rl_abs(got, want) -> float:
    return max((g.cpu().double() - w.double()).abs().max().item()
               for g, w in zip(rl_leaves(got), rl_leaves(want)))


def rl_learners(card: str) -> None:
    """(a) PPO, A2C, DQN and A3C: a gradient and one Adam step on the card
    against the CPU, on the same carried weights and CartPole batch."""
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.rllib import DQNPolicy, PPOPolicy, RolloutWorker
    from ray_tpu_torch.rllib.agents.a3c import A3CPolicy
    from ray_tpu_torch.rllib.agents.pg import A2CPolicy
    from ray_tpu_torch.rllib.agents.ppo import PPO_CONFIG
    from ray_tpu_torch.rllib.policy import batch_to, value_and_grad

    log(f"phase 19 (a): learners on {DEVICE!r} against the CPU, f32 (TF32 "
        f"off), PPO_CONFIG's network ([64, 64]), carried weights, one "
        f"CartPole batch; gradients normwise within {RL_GRAD_BOUND:g}, one "
        f"Adam step from the same gradients within {RL_STEP_BOUND:g}")
    cpu_cfg = {**PPO_CONFIG, "seed": SEED, "device": "cpu",
               "num_envs_per_worker": 8}
    batch = RolloutWorker("CartPole", PPOPolicy, cpu_cfg).sample()
    cases = {
        "PPO": (PPOPolicy, lambda pol: pol._loss_fn,
                PPOPolicy._batch_keys, PPO_CONFIG["sgd_minibatch_size"]),
        "A2C": (A2CPolicy, lambda pol: pol._loss_fn,
                A2CPolicy._batch_keys, batch.count),
        "DQN": (DQNPolicy, lambda pol: lambda p, b: pol.loss(
            p, pol.target_params, b), DQNPolicy._batch_keys, 64),
    }
    for name, (cls, loss_of, keys, rows) in cases.items():
        pols = {dev: cls(4, 2, {**PPO_CONFIG, "seed": SEED, "device": dev})
                for dev in ("cpu", DEVICE)}
        pols[DEVICE].set_weights(pols["cpu"].get_weights())
        rl_on(pols[DEVICE].params, f"(a) {name}'s learner")
        out = {}
        for dev, pol in pols.items():
            b = batch_to(batch.slice(0, rows), keys, torch.device(dev))
            out[dev] = value_and_grad(loss_of(pol), pol.params, b)
        loss_err = rl_normwise([out[DEVICE][0]], [out["cpu"][0]])
        grad_err = rl_normwise(out[DEVICE][2], out["cpu"][2])
        grads = out["cpu"][2]
        steps = {dev: pol.opt.step(pol.params, tree_map(
            lambda g: g.to(dev), grads), pol.opt_state)[0]
            for dev, pol in pols.items()}
        step_err = rl_abs(steps[DEVICE], steps["cpu"])
        log(f"  {name}: {rows} rows, loss {out['cpu'][0].item():.6f}, "
            f"normwise error of the loss {loss_err:.2e} and gradients "
            f"{grad_err:.2e}; one Adam step |card - cpu| {step_err:.2e}")
        if max(loss_err, grad_err) > RL_GRAD_BOUND or \
                step_err > RL_STEP_BOUND:
            raise AssertionError(f"(a) {name} on the card differs from the "
                                 f"CPU beyond its bound")
    rl_ppo_graph(batch)
    pols = {dev: A3CPolicy(4, 2, {**PPO_CONFIG, "seed": SEED, "device": dev})
            for dev in ("cpu", DEVICE)}
    pols[DEVICE].set_weights(pols["cpu"].get_weights())
    rl_on(pols[DEVICE].params, "(a) A3C's learner")
    grads = {dev: pol.compute_gradients(batch)[0]
             for dev, pol in pols.items()}
    to_t = functools.partial(tree_map, torch.as_tensor)
    grad_err = rl_normwise(to_t(grads[DEVICE]), to_t(grads["cpu"]))
    for pol in pols.values():
        pol.apply_gradients(grads["cpu"])
    step_err = rl_abs(pols[DEVICE].params, pols["cpu"].params)
    log(f"  A3C: compute_gradients on {batch.count} rows, normwise error "
        f"{grad_err:.2e}; apply_gradients of the CPU's gradients "
        f"|card - cpu| {step_err:.2e}")
    if grad_err > RL_GRAD_BOUND or step_err > RL_STEP_BOUND:
        raise AssertionError("(a) A3C on the card differs from the CPU "
                             "beyond its bound")
    rl_learners_part2(batch)


def rl_hold(name: str, rows: int, out: dict, steps: dict,
            note: str = "") -> None:
    """(a)'s bounds for one learner: ``out[dev]`` is (its losses, its
    gradients) on each device, ``steps[dev]`` the parameters after one Adam
    step from the CPU's gradients."""
    loss_err = rl_normwise(out[DEVICE][0], out["cpu"][0])
    grad_err = rl_normwise(out[DEVICE][1], out["cpu"][1])
    step_err = rl_abs(steps[DEVICE], steps["cpu"])
    log(f"  {name}: {rows} rows{note}, loss {out['cpu'][0][0].item():.6f}, "
        f"normwise error of the losses {loss_err:.2e} and gradients "
        f"{grad_err:.2e}; one Adam step |card - cpu| {step_err:.2e}")
    if max(loss_err, grad_err) > RL_GRAD_BOUND or step_err > RL_STEP_BOUND:
        raise AssertionError(f"(a) {name} on the card differs from the CPU "
                             f"beyond its bound")


def rl_adam_steps(pols: dict, opt_of, grads) -> dict:
    """Each device's parameters after one Adam step of ``grads`` (the
    CPU's)."""
    from ray_tpu_torch._tree import tree_map

    out = {}
    for dev, pol in pols.items():
        opt, params, state = opt_of(pol)
        out[dev] = opt.step(params, tree_map(lambda g: g.to(dev), grads),
                            state)[0]
    return out


def rl_learners_part2(cartpole) -> None:
    """(a) the second part's learners, each on DEVICE against the CPU on
    carried weights and one batch: DDPG's and TD3's critic and actor
    gradients on an update that steps the actor and one that the delay
    may skip, SAC's (log_alpha among the leaves), Dyna's model, MARWIL's,
    MAML's second-order meta-gradient and QMIX's."""
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.rllib import RolloutWorker
    from ray_tpu_torch.rllib.agents import (ddpg, dyna, maml, marwil, qmix,
                                            sac)
    from ray_tpu_torch.rllib.models import init_mlp
    from ray_tpu_torch.rllib.policy import (Adam, batch_to, to_device,
                                            to_host, value_and_grad)

    def carried(pols):
        pols[DEVICE].set_weights(pols["cpu"].get_weights())
        return pols

    # DDPG and TD3 on a MoveToTarget batch of 256 rows.
    moves = RolloutWorker("MoveToTarget", ddpg.DDPGPolicy, {
        **ddpg.DDPG_CONFIG, "seed": SEED, "device": "cpu",
        "num_envs_per_worker": 8, "rollout_fragment_length": 32}).sample()
    gen = torch.Generator().manual_seed(SEED)
    noise = torch.randn((moves.count, 2), generator=gen)
    for name, cfg in (("DDPG", ddpg.DDPG_CONFIG), ("TD3", ddpg.TD3_CONFIG)):
        pols = carried({dev: ddpg.DDPGPolicy(2, 2, {**cfg, "seed": SEED,
                                                    "device": dev})
                        for dev in ("cpu", DEVICE)})
        rl_on(pols[DEVICE].params, f"(a) {name}'s learner")
        for n_updates in (0, 1):
            out = {}
            for dev, pol in pols.items():
                stats, grads = pol.gradients(
                    pol.params, pol.target, n_updates,
                    batch_to(moves, pol._batch_keys, torch.device(dev)),
                    noise.to(dev))
                out[dev] = ([stats["critic_loss"], stats["actor_loss"]],
                            grads)
            skipped = n_updates % cfg["policy_delay"] != 0
            if skipped and any(g.any() for g in rl_leaves(
                    [out[d][1]["actor"] for d in pols])):
                raise AssertionError(f"(a) {name}: the delay's skipped step "
                                     f"has a non-zero actor gradient")
            steps = rl_adam_steps(pols, lambda p: (p.opt, p.params,
                                                   p.opt_state),
                                  out["cpu"][1])
            rl_hold(name, moves.count, out, steps,
                    f", update {n_updates} (the actor "
                    f"{'skipped' if skipped else 'stepped'})")

    # SAC, Dyna's model and MARWIL on CartPole rows.
    rows = cartpole.slice(0, sac.SAC_CONFIG["train_batch_size"])
    pols = carried({dev: sac.SACPolicy(4, 2, {**sac.SAC_CONFIG, "seed": SEED,
                                              "device": dev})
                    for dev in ("cpu", DEVICE)})
    rl_on(pols[DEVICE].params, "(a) SAC's learner")
    out = {}
    for dev, pol in pols.items():
        loss, stats, grads = value_and_grad(
            lambda p, b: pol.loss(p, pol.target, b), pol.params,
            batch_to(rows, pol._batch_keys, torch.device(dev)))
        out[dev] = ([loss] + list(stats.values()), grads)
    rl_hold("SAC", rows.count, out, rl_adam_steps(
        pols, lambda p: (p.opt, p.params, p.opt_state), out["cpu"][1]))

    rows = cartpole.slice(0, dyna.DYNA_CONFIG["train_batch_size"])
    models = {dev: dyna._DynamicsModel(4, 2, {**dyna.DYNA_CONFIG,
                                              "seed": SEED, "device": dev})
              for dev in ("cpu", DEVICE)}
    models[DEVICE].params = to_device(to_host(models["cpu"].params), DEVICE)
    rl_on(models[DEVICE].params, "(a) Dyna's model")
    out = {}
    for dev, m in models.items():
        loss, _, grads = value_and_grad(
            m.loss, m.params, batch_to(rows, m._batch_keys,
                                       torch.device(dev)))
        out[dev] = ([loss], grads)
    rl_hold("Dyna's model", rows.count, out, rl_adam_steps(
        models, lambda m: (m.opt, m.params, m.opt_state), out["cpu"][1]))

    cfg = marwil.MARWIL_CONFIG
    rows = marwil.MARWILTrainer._with_returns(
        cartpole.slice(0, cfg["train_batch_size"]), cfg["gamma"])
    gen = torch.Generator().manual_seed(SEED)
    params = {"pi": init_mlp(gen, [4] + cfg["hiddens"] + [2]),
              "vf": init_mlp(gen, [4] + cfg["hiddens"] + [1])}
    loss_fn = marwil.make_marwil_loss(cfg["beta"], cfg["vf_coeff"])
    learners = {dev: to_device(to_host(params), dev)
                for dev in ("cpu", DEVICE)}
    rl_on(learners[DEVICE], "(a) MARWIL's learner")
    out = {}
    for dev, p in learners.items():
        loss, stats, grads = value_and_grad(
            loss_fn, p, batch_to(rows, ("obs", "actions", "returns"),
                                 torch.device(dev)))
        out[dev] = ([loss] + list(stats.values()), grads)
    opt = Adam(cfg["lr"])
    rl_hold("MARWIL", rows.count, out, rl_adam_steps(
        learners, lambda p: (opt, p, opt.init(p)), out["cpu"][1]))

    # MAML at its reference test's config: 8 TaskBandit tasks, each a
    # support and a query batch of 64 rows, inner_lr 3.0.
    cfg = {**maml.MAML_CONFIG, "num_envs_per_worker": 8,
           "rollout_fragment_length": 8, "meta_batch_size": 8,
           "inner_lr": 3.0, "meta_lr": 0.03, "hiddens": [16], "seed": SEED}
    worker = RolloutWorker("TaskBandit", maml.MAMLPolicy,
                           {**cfg, "device": "cpu"})
    theta = worker.policy.get_weights()
    pairs = [maml._run_task(worker, t, theta)
             for t in worker.vec_env.envs[0].sample_tasks(8)]
    pols = {dev: maml.MAMLPolicy(1, 4, {**cfg, "device": dev})
            for dev in ("cpu", DEVICE)}
    for pol in pols.values():
        pol.set_weights(theta)
    rl_on(pols[DEVICE].params, "(a) MAML's learner")
    out = {}
    for dev, pol in pols.items():
        loss, _, grads = value_and_grad(
            pol.meta_loss, pol.params, pol._to_device([s for s, _ in pairs]),
            pol._to_device([q for _, q in pairs]))
        out[dev] = ([loss], grads)
    rl_hold("MAML", 8 * pairs[0][0].count, out, rl_adam_steps(
        pols, lambda p: (p.opt, p.params, p.opt_state), out["cpu"][1]),
        ", 8 tasks, the second-order meta-gradient at inner_lr 3.0")

    # QMIX on 32 TwoStepGame transitions from a CPU trainer's replay.
    cfg = {**qmix.QMIX_CONFIG, "seed": SEED}
    trainer = qmix.QMIXTrainer("TwoStepGame", {**cfg, "device": "cpu"})
    for _ in range(4):
        trainer.train()
    idx = np.random.RandomState(SEED).randint(0, len(trainer._replay), 32)
    rows = {k: np.stack([trainer._replay[i][k] for i in idx])
            for k in trainer._replay[0]}
    pols = {dev: qmix.QMIXPolicy(2, 4, 2, 8, {**cfg, "device": dev})
            for dev in ("cpu", DEVICE)}
    pols[DEVICE].params = to_device(to_host(pols["cpu"].params), DEVICE)
    pols[DEVICE].target = to_device(to_host(pols["cpu"].target), DEVICE)
    rl_on(pols[DEVICE].params, "(a) QMIX's learner")
    out = {}
    for dev, pol in pols.items():
        batch = {k: torch.as_tensor(v.astype(np.float32), device=dev)
                 for k, v in rows.items()}
        loss, stats, grads = value_and_grad(
            lambda p, b: pol.loss(p, pol.target, b), pol.params, batch)
        out[dev] = ([loss] + list(stats.values()), grads)
    rl_hold("QMIX", 32, out, rl_adam_steps(
        pols, lambda p: (p.opt, p.params, p.opt_state), out["cpu"][1]))


def rl_ppo_graph(batch) -> None:
    """PPO's whole update (8 epochs of 8 minibatches) on the card, its
    minibatch step replayed as a CUDA graph, against the eager steps on
    the card (the same kernels in the same order: the same bits) and
    against the CPU's (reported)."""
    from ray_tpu_torch.rllib import PPOPolicy
    from ray_tpu_torch.rllib.agents.ppo import PPO_CONFIG
    from ray_tpu_torch.rllib.policy import batch_to

    cfg = {**PPO_CONFIG, "seed": SEED}
    pols = {name: PPOPolicy(4, 2, {**cfg, "device": dev}) for name, dev in
            (("cpu", "cpu"), ("eager", DEVICE), ("graphed", DEVICE))}
    pols["eager"].graphed = False
    perms = pols["cpu"].permutations(batch.count)
    out = {}
    for name, pol in pols.items():
        pol.set_weights(pols["cpu"].get_weights())
        dev = torch.device(pol.device)
        t0 = time.perf_counter()
        out[name] = pol.update(
            pol.params, pol.opt_state, batch_to(batch, pol._batch_keys, dev),
            [p.to(dev) for p in perms])
        dev_sync()
        log(f"  PPO's update, {name}: {len(perms)} epochs of "
            f"{batch.count // pol.mb_size} minibatches in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms"
            + (" (the first: the graph's capture included)"
               if pol.graphed else ""))
    same = all(torch.equal(a, b) for a, b in zip(
        rl_leaves([out["graphed"][:2]]), rl_leaves([out["eager"][:2]])))
    log(f"  PPO's update on {DEVICE!r}: the graph's parameters and Adam "
        f"state {'equal' if same else 'NOT equal'} to the eager steps' bit "
        f"for bit; against the CPU's, normwise "
        f"{rl_normwise(out['graphed'][0], out['cpu'][0]):.2e} after "
        f"{int(out['cpu'][1]['step'])} Adam steps")
    if not same:
        raise AssertionError("(a) PPO's graphed update differs from its "
                             "eager steps on the card")


def rl_profiled(fn):
    """fn() with the card's activity traced: its result, its host wall in
    ms and the device time of its kernels and copies in ms (nan on the
    CPU). The raw trace is summed as it comes from the profiler: building
    torch.profiler's event tables for an iteration's ~20,000 kernels took
    seconds of host time on an H100 host."""
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3, float("nan")
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (DeviceType, ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CUDA}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        trace = _disable_profiler()
    busy = sum(e.duration_ns() for e in trace.events()
               if e.device_type() == DeviceType.CUDA) / 1e6
    return out, wall, busy


def rl_cartpole(card: str) -> dict:
    """(b) PPOTrainer on CartPole at PPO_CONFIG, 2 rollout workers on the
    card, until episode_reward_mean reaches RL_TARGET."""
    from ray_tpu_torch.rllib import PPOTrainer

    log(f"phase 19 (b): PPOTrainer on CartPole at PPO_CONFIG, "
        f"num_workers 2, num_envs_per_worker 8, seed {SEED}, "
        f"device={DEVICE!r}: episode_reward_mean >= {RL_TARGET:g} within "
        f"{RL_MAX_ITERS} iterations")
    trainer = PPOTrainer({**RL_CARTPOLE, "device": DEVICE})
    local = trainer.workers.local_worker()
    rl_on(local.policy.params, "(b) the learner")
    cuda = DEVICE == "cuda"
    tick: dict = {}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            if cuda and name == "learn":
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
            out = fn(*args)
            if cuda and name == "learn":
                ev[1].record()
                ev[1].synchronize()
                tick["learn_span"] = ev[0].elapsed_time(ev[1])
            tick[name] = (time.perf_counter() - t0) * 1e3
            return out
        return call

    local.learn_on_batch = timed("learn", local.learn_on_batch)
    trainer._train_op = timed("train_op", trainer._train_op)
    trainer._train_step = timed("train_step", trainer._train_step)
    rows, result = [], None
    t_run = time.perf_counter()
    for it in range(RL_MAX_ITERS):
        tick.clear()
        result, wall, busy = rl_profiled(trainer.train)
        row = {"wall": wall, "sample": tick["train_step"] - tick["train_op"],
               "learn": tick["learn"], "learn_span": tick.get(
                   "learn_span", float("nan")),
               "busy": busy / wall, "reward": result["episode_reward_mean"]}
        rows.append(row)
        log(f"  iteration {it:2d}: episode_reward_mean "
            f"{row['reward']:7.2f}, wall {wall:8.3f} ms: sampling "
            f"{row['sample']:8.3f} ms, learn_on_batch {row['learn']:8.3f} "
            f"ms (device span {row['learn_span']:8.3f} ms by CUDA events), "
            f"the rest {wall - tick['train_step']:7.3f} ms; card busy "
            f"{busy:8.3f} ms, {row['busy']:6.1%} of the wall [{card}]")
        if row["reward"] >= RL_TARGET:
            break
    run_s = time.perf_counter() - t_run
    rl_on(local.policy.params, "(b) the learner after training")
    trainer.cleanup()
    if result["episode_reward_mean"] < RL_TARGET:
        raise AssertionError(f"(b) PPO reached episode_reward_mean "
                             f"{result['episode_reward_mean']:.2f} < "
                             f"{RL_TARGET:g} in {RL_MAX_ITERS} iterations")
    med = {k: float(np.median([r[k] for r in rows]))
           for k in ("wall", "sample", "learn", "learn_span", "busy")}
    log(f"  reached {result['episode_reward_mean']:.2f} after {len(rows)} "
        f"iterations ({result['timesteps_total']} steps) in {run_s:.2f} s; "
        f"medians: wall {med['wall']:.3f} ms, sampling {med['sample']:.3f} "
        f"ms, learn_on_batch {med['learn']:.3f} ms (device span "
        f"{med['learn_span']:.3f} ms), card busy {med['busy']:.1%} [{card}]")
    return {"iterations": len(rows), "seconds": run_s, **med}


def rl_es_step(card: str) -> dict:
    """ES's one observation an env step (``_ESWorker._episode_return``, as
    the JAX package's): CartPole episodes of up to 200 steps at ES_CONFIG's
    hiddens, each step one forward and one host sync on the device, timed
    on the phase's device and on the CPU."""
    from ray_tpu_torch.rllib.agents.es import ES_CONFIG, _ESWorker

    out = {}
    for dev in dict.fromkeys((DEVICE, "cpu")):
        w = _ESWorker("CartPole", ES_CONFIG["hiddens"], ES_CONFIG["sigma"],
                      0, dev)
        flat = w._on_device(w.flat)
        w._episode_return(flat, 10)
        steps, t0 = 0, time.perf_counter()
        while steps < 1000:   # CartPole pays 1 a step: a return is steps
            steps += int(w._episode_return(flat, 200))
        out[dev] = (time.perf_counter() - t0) * 1e3 / steps
    log(f"  ES's episode loop on CartPole, one observation an env step "
        f"(a forward and a host sync): {out[DEVICE]:.4f} ms a step on "
        f"{DEVICE!r}, {out['cpu']:.4f} ms on the CPU [{card}]")
    return out


def rl_learner(trainer):
    """The parameter tree of a trainer's learner, which must lie on the
    card: its local policy's, QMIX's joint policy's, MARWIL's own; None for
    ES and ARS, whose flat parameters live on the host (their workers
    evaluate them on the card)."""
    from ray_tpu_torch.rllib import ARSTrainer, ESTrainer, MARWILTrainer
    from ray_tpu_torch.rllib import QMIXTrainer

    if isinstance(trainer, (ESTrainer, ARSTrainer)):
        return None
    if isinstance(trainer, QMIXTrainer):
        return trainer.policy.params
    if isinstance(trainer, MARWILTrainer):
        return trainer.params
    return trainer.get_policy().params


def rl_expert_rows(path: str) -> None:
    """test_marwil_clones_expert's offline data: 300 bandit rows, the
    expert's arm 2 seven times in ten, written with JsonWriter."""
    from ray_tpu_torch.rllib import JsonWriter, SampleBatch

    rng = np.random.RandomState(0)
    acts = [2 if rng.rand() < 0.7 else rng.randint(4) for _ in range(300)]
    w = JsonWriter(path)
    w.write(SampleBatch({
        "obs": np.zeros((300, 1), np.float32), "actions": np.asarray(acts),
        "rewards": (np.asarray(acts) == 2).astype(np.float32),
        "dones": np.ones(300, np.float32)}))
    w.close()


def rl_train(name: str, make, iters: int, key: str, min_reward, card: str,
             check=None):
    """A trainer made by ``make()``, its learner checked on the card, trained
    until ``result[key] >= min_reward`` (all ``iters`` when None), held to
    ``check(trainer, result)`` (which raises, or returns a note for the
    log), then stopped (QMIX's ``stop``, every other's ``cleanup``):
    (result, wall s)."""
    from ray_tpu_torch.rllib import QMIXTrainer

    t0 = time.perf_counter()
    trainer = make()
    try:
        params = rl_learner(trainer)
        if params is not None:
            rl_on(params, f"(c) {name}'s learner")
        for it in range(iters):
            result = trainer.train()
            if min_reward is not None and result[key] >= min_reward:
                break
        if params is not None:
            rl_on(rl_learner(trainer), f"(c) {name}'s learner after training")
        extra = check(trainer, result) if check else ""
    finally:
        trainer.stop() if isinstance(trainer, QMIXTrainer) \
            else trainer.cleanup()
    wall = time.perf_counter() - t0
    log(f"  {name:12s}: {key} {result[key]:.3f}"
        + (f" >= {min_reward}" if min_reward is not None else "")
        + f" after {it + 1} iterations{extra}, {wall:.3f} s [{card}]")
    if min_reward is not None and result[key] < min_reward:
        raise AssertionError(f"(c) {name} reached {key} "
                             f"{result[key]:.3f} < {min_reward}")
    return result, wall


def rl_dyna_check(trainer, result) -> str:
    if result["model_loss"] >= 0.15:
        raise AssertionError(f"(c) Dyna's model_loss "
                             f"{result['model_loss']:.3f} >= 0.15")
    return f", model_loss {result['model_loss']:.3f}"


def rl_maml_check(trainer, result) -> str:
    gain = result["post_adapt_reward_mean"] - result["pre_adapt_reward_mean"]
    if gain < 0.2:
        raise AssertionError(f"(c) MAML's adaptation gains {gain:.3f} < 0.2")
    return f", post minus pre {gain:.3f}"


def rl_marwil_check(trainer, result) -> str:
    action = trainer.compute_action(np.zeros(1))
    if action != 2 or result["bc_loss"] >= 2.0:
        raise AssertionError(f"(c) MARWIL chose arm {action} with bc_loss "
                             f"{result['bc_loss']:.3f}")
    return f", greedy arm {action}"


# (c)'s checks beyond the min reward, each its reference test's.
RL_CHECKS = {"Dyna": rl_dyna_check, "MAML": rl_maml_check,
             "MARWIL": rl_marwil_check}


def rl_bandits(card: str) -> dict:
    """(c) every other trainer of rllib, and the multi-agent shared policy,
    on the card at its reference test's config and min_reward."""
    import ray_tpu_torch.rllib as rllib

    log(f"phase 19 (c): each other trainer on device={DEVICE!r} at its "
        f"reference test's config (tests/test_rllib.py) until its "
        f"min_reward")
    walls = {}
    for name, cls, cfg, iters, min_reward in RL_BANDITS:
        key = "eval_return" if cls in ("ESTrainer", "ARSTrainer") \
            else "episode_reward_mean"
        _, walls[name] = rl_train(
            name, lambda: getattr(rllib, cls)({**cfg, "device": DEVICE}),
            iters, key, min_reward, card)
    with tempfile.TemporaryDirectory() as data:
        rl_expert_rows(data)
        for name, cls, cfg, iters, key, min_reward in RL_PART2:
            cfg = {**cfg, "device": DEVICE}
            if cls == "QMIXTrainer":
                make = functools.partial(rllib.QMIXTrainer, "TwoStepGame",
                                         cfg)
            elif cls == "MARWILTrainer":
                make = functools.partial(rllib.MARWILTrainer,
                                         {**cfg, "input_path": data})
            else:
                make = functools.partial(getattr(rllib, cls), cfg)
            _, walls[name] = rl_train(name, make, iters, key, min_reward,
                                      card, RL_CHECKS.get(name))
    cfg, iters, min_reward = RL_MULTI
    t0 = time.perf_counter()
    trainer = rllib.MultiAgentTrainer(
        "TwoStepGame", policies={"shared": {}},
        policy_mapping_fn=lambda agent_id: "shared",
        config={**cfg, "device": DEVICE}, num_workers=2)
    rl_on(trainer.local.policies["shared"].params, "(c) the shared policy")
    try:
        for it in range(iters):
            result = trainer.train()
            if result["episode_reward_mean"] >= min_reward:
                break
    finally:
        trainer.stop()
    walls["multi-agent"] = time.perf_counter() - t0
    log(f"  multi-agent shared policy, 2 remote workers: "
        f"episode_reward_mean {result['episode_reward_mean']:.3f} >= "
        f"{min_reward} after {it + 1} iterations, "
        f"{walls['multi-agent']:.3f} s [{card}]")
    if result["episode_reward_mean"] < min_reward:
        raise AssertionError("(c) the multi-agent shared policy fell short")
    walls["es_step_ms"] = rl_es_step(card)
    return walls


def rllib_path(card: str) -> dict:
    """Phase 19: rllib on the card, on a fresh local runtime; (d) this
    process's allocated memory back within 1 MiB after the trainers'
    cleanup() and rt.shutdown()."""
    t_phase = time.perf_counter()
    free0 = dev_free()
    alloc0 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    threads0 = set(threading.enumerate())
    rl_learners(card)
    rt.init(num_cpus=8, num_gpus=1)
    try:
        out = {"cartpole": rl_cartpole(card), "bandits": rl_bandits(card)}
    finally:
        rt.shutdown()
    # A killed actor finishes the call it is running; no thread of the
    # phase may still be inside a torch op when the process exits.
    for t in set(threading.enumerate()) - threads0:
        t.join(timeout=30)
        if t.is_alive():
            raise AssertionError(f"(d) thread {t.name} outlived the phase")
    free1 = dev_free()
    alloc1 = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    log(f"phase 19 (d): after every trainer's cleanup(), rt.shutdown() and "
        f"the phase's threads' end, this process's allocated memory {(alloc1 - alloc0) / 2**20:+.3f} "
        f"MiB and the card's free memory (device-wide) "
        f"{(free1 - free0) / 2**20:+.1f} MiB against before the phase; "
        f"phase 19 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    if abs(alloc1 - alloc0) > 2**20:
        raise AssertionError(f"(d) this process holds {alloc1 - alloc0} "
                             f"bytes more after the phase than before")
    return out


# ------------------------------------------ phase 20: the repo's programs

SOAK_S = 20.0            # (c) soak.lm_serve's duration
# The small models' head dims beside the flagship's 64 and 128.
P20_DECODE_DIMS = tuple(d for d in attention.DECODE_HEAD_DIMS if d < 64)
P20_FLASH_DIMS = tuple(d for d in attention.FLASH_HEAD_DIMS if d < 64)


class ExampleBackend(LMBackend):
    """Phase 20's LMBackend, put in the place of the class an example or
    the soak builds: the same backend, its contiguous engine under a
    PathProbe, the device memory its build added and its head dim, in
    ``ExampleBackend.live``. close() detaches the probe, so a closed
    replica's engine is freed."""

    live: list = []

    def __init__(self, params, cfg, **kw):
        mem0 = mem_now()
        super().__init__(params, cfg, **kw)
        self.probe = (None if kw.get("paged") else PathProbe(self.engine))
        self.growth = mem_now() - mem0
        self.head_dim, self.n_layers, self.kw = cfg.head_dim, \
            cfg.n_layers, kw
        ExampleBackend.live.append(self)

    def close(self) -> None:
        super().close()
        for name in ("eng", "_prefill", "_decode"):
            if self.probe is not None and hasattr(self.probe, name):
                setattr(self.probe, name, None)

    __ray_shutdown__ = close


@contextlib.contextmanager
def example_backend(module):
    """``module.LMBackend`` is ExampleBackend for the block."""
    ExampleBackend.live.clear()
    saved = module.LMBackend
    module.LMBackend = ExampleBackend
    try:
        yield ExampleBackend.live
    finally:
        module.LMBackend = saved


def check_ticks(backend, what: str) -> int:
    """Every decode tick of a contiguous engine without speculation
    launches 1 plain and 2L residual K1 and L K6 and nothing else, every
    prefill K1 2L + 1 times; returns the ticks."""
    L = backend.n_layers
    per_tick = {n: 0 for n in COUNTED}
    per_tick.update(rms_norm=1, add_rms_norm=2 * L, decode_attention=L)
    ticks = backend.probe.tick_launches
    for i, got in enumerate(ticks):
        if got != per_tick:
            raise AssertionError(f"{what} tick {i}: launches {got}, "
                                 f"expected {per_tick}")
    check_launches_each(backend.probe.prefill_launches, L, f"{what} prefill")
    if not ticks:
        raise AssertionError(f"{what}: no decode tick ran")
    return len(ticks)


def p20_lm_serving(smoke: bool, card: str) -> float:
    """lm_serving's main on the card, its two backends probed: its own
    checks (greedy outputs equal generate() on the card, the stream equal
    to its whole response, the speculative output equal to greedy), and
    the plain backend's launches a tick."""
    from ray_tpu_torch.examples import lm_serving

    reset_counts()
    t0 = time.perf_counter()
    with example_backend(lm_serving) as live:
        outs = lm_serving.main(smoke=smoke, device=DEVICE)
    wall = time.perf_counter() - t0
    counts = read_counts()
    plain, spec = live
    D, L = plain.head_dim, plain.n_layers
    n = check_ticks(plain, "lm:v1")
    if len(outs) != 6 or spec.kw.get("speculative_k") != 4:
        raise AssertionError(f"lm_serving: {len(outs)} outputs, backends "
                             f"{[b.kw for b in live]}")
    if counts["decode_attention"] == 0:
        raise AssertionError("lm_serving launched no decode_attention")
    log(f"  lm_serving{' --smoke' if smoke else ''}: 6 greedy requests "
        f"equal generate() on the card, sampled twice equal, stream equal, "
        f"speculative equal to greedy; {n} ticks of lm:v1 at D {D}, f32, "
        f"each {1 + 2 * L} K1 ({2 * L} residual) and {L} K6 ({L} layers); "
        f"the run's launches {counts}; wall {wall:.2f} s [{card}]")
    return wall


def p20_rank_shapes() -> tuple:
    """A rank's K3-K5 shapes in pipelined_transformer --smoke: batch 4
    over dp 2 in 2 microbatches, the full sequence (sp 1), the heads over
    tp 2: (B, T, H, KH, D)."""
    from ray_tpu_torch.examples import pipelined_transformer as pt

    cfg = pt.config(smoke=True)
    tp, dp = pt.MESH["tp"], pt.MESH["dp"]
    return (pt.BATCH // dp // pt.MICROBATCHES, cfg.max_seq_len,
            cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim)


def p20_examples(card: str) -> dict:
    """(a) every example at its full size on the card, (b) lm_serving
    --smoke (K6 at D 16) and K3-K5 at pipelined_transformer --smoke's
    shapes of a rank (D 16)."""
    from ray_tpu_torch.examples import (cartpole_ppo, hyperparameter_search,
                                        parameter_server,
                                        pipelined_transformer, serve_model)

    walls = {"lm_serving": p20_lm_serving(False, card)}

    t0 = time.perf_counter()
    serve_model.main(smoke=False, device=DEVICE)
    walls["serve_model"] = time.perf_counter() - t0
    log(f"  serve_model: 2 replicas, the 80/20 canary and an HTTP POST, "
        f"each call a tensor op on the card; wall {walls['serve_model']:.2f}"
        f" s [{card}]")

    for mode in ("sync", "async"):
        t0 = time.perf_counter()
        loss = parameter_server.main(use_async=mode == "async",
                                     smoke=False, device=DEVICE)
        walls[f"parameter_server {mode}"] = time.perf_counter() - t0
        if not loss < 1.0:
            raise AssertionError(f"parameter_server {mode}: loss {loss}")
        log(f"  parameter_server {mode}: 50 rounds of 4 gradient tasks on "
            f"the card, final loss {loss:.6f} (< 1.0); wall "
            f"{walls[f'parameter_server {mode}']:.2f} s [{card}]")

    t0 = time.perf_counter()
    best = hyperparameter_search.main(smoke=False, device=DEVICE)
    walls["hyperparameter_search"] = time.perf_counter() - t0
    if best["lr"] not in (0.0001, 0.001, 0.01, 0.1, 0.5, 1.0):
        raise AssertionError(f"hyperparameter_search: best {best}")
    log(f"  hyperparameter_search: 6 learning rates under ASHA, the MLP on "
        f"the card; best lr {best['lr']}; wall "
        f"{walls['hyperparameter_search']:.2f} s [{card}]")

    curve = []

    class Curve(cartpole_ppo.PPOTrainer):
        def train(self):
            result = super().train()
            curve.append(result["episode_reward_mean"])
            return result

    saved, cartpole_ppo.PPOTrainer = cartpole_ppo.PPOTrainer, Curve
    t0 = time.perf_counter()
    try:
        result = cartpole_ppo.main(smoke=False, device=DEVICE)
    finally:
        cartpole_ppo.PPOTrainer = saved
    walls["cartpole_ppo"] = time.perf_counter() - t0
    if result["timesteps_total"] <= 0 or len(curve) != 30 or not all(
            math.isfinite(r) for r in curve):
        raise AssertionError(f"cartpole_ppo: {len(curve)} iterations, "
                             f"{result['timesteps_total']} steps")
    log(f"  cartpole_ppo: 30 iterations, the learner on the card; "
        f"episode_reward_mean by iteration "
        f"{[round(r, 1) for r in curve]}; {result['timesteps_total']} "
        f"steps; wall {walls['cartpole_ppo']:.2f} s [{card}]")

    out = pipelined_transformer.run(smoke=False, device=DEVICE)
    walls["pipelined_transformer"] = out["wall_s"]
    cfg = pipelined_transformer.config(smoke=False)
    per_step = [cfg.n_layers // pipelined_transformer.MESH["pp"]
                * pipelined_transformer.MICROBATCHES] * 3
    ranks = out["ranks"]
    losses = ranks[0]["losses"]
    for i, r in enumerate(ranks):
        if r["losses"] != losses:
            raise AssertionError(f"pipelined_transformer: rank {i}'s losses "
                                 f"{r['losses']} differ from rank 0's")
        if any(got != per_step for got in r["launches"]):
            raise AssertionError(
                f"pipelined_transformer rank {i}: K3, K4, K5 launches a "
                f"step {r['launches']}, expected {per_step}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"pipelined_transformer: losses {losses}")
    step_s = float(np.median(ranks[0]["walls"][1:]))
    log(f"  pipelined_transformer: dp2 x pp2 x tp2 over 8 rank processes "
        f"sharing the card, D {cfg.head_dim} f32, 1 + 20 steps; losses "
        f"{[round(x, 4) for x in losses]}; every rank's K3, K4, K5 a step "
        f"{per_step} ({cfg.n_layers // pipelined_transformer.MESH['pp']} "
        f"layers a stage x {pipelined_transformer.MICROBATCHES} "
        f"microbatches); median step {step_s * 1e3:.1f} ms, "
        f"{out['tokens_per_step'] / step_s:,.0f} tok/s; first step "
        f"{ranks[0]['walls'][0]:.2f} s; wall with the world's start-up "
        f"{out['wall_s']:.2f} s [{card}]")

    log("phase 20 (b): the smoke sizes' head dims on the card")
    walls["lm_serving --smoke"] = p20_lm_serving(True, card)
    B, T, H, KH, D = p20_rank_shapes()
    q, k, v, do = flash_inputs(B, T, H, KH, D, torch.float32, seed=2000)
    check_flash(f"pipelined_transformer --smoke, a rank's microbatch "
                f"B={B} T={T} H={H} KH={KH} D={D} causal f32",
                q, k, v, do, True)
    return walls


def check_flash(what: str, q, k, v, do, causal: bool) -> None:
    """K3, K4, K5 against their plain versions on one input: f32 out and
    lse atol 1e-5, gradients 1e-4 (summation order); bf16 2e-2, the
    gradients also within attention._flash_grad_bounds."""
    f32 = q.dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if f32 else dict(atol=2e-2, rtol=2e-2)
    gtol = dict(atol=1e-4, rtol=1e-4) if f32 else tol
    before = read_counts()
    out, lse = attention.flash_forward(q, k, v, causal)
    ref_out, ref_lse = attention._flash_forward_ref(q, k, v, causal)
    check_close(f"flash_forward {what}", out, ref_out, **tol)
    check_close(f"flash_forward lse {what}", lse, ref_lse, atol=1e-5,
                rtol=1e-5)
    args = (q, k, v, do, ref_lse, attention._flash_dsum(ref_out, do),
            causal)
    got = (attention.flash_backward_dq(*args),
           *attention.flash_backward_dkv(*args))
    want = (attention._flash_backward_dq_ref(*args),
            *attention._flash_backward_dkv_ref(*args))
    bounds = (attention._flash_grad_bounds(*args[:6], *want, causal=causal)
              if not f32 else (None,) * 3)
    for name, g, w, b in zip(("dq", "dk", "dv"), got, want, bounds):
        if b is None:
            check_close(f"flash_backward {name} {what}", g, w, **gtol)
        else:
            check_bound(f"flash_backward {name} {what}", g, w, b)
    delta = count_delta(before)
    if [delta[n] for n in ("flash_forward", "flash_backward_dq",
                           "flash_backward_dkv")] != [1, 1, 1]:
        raise AssertionError(f"{what}: K3-K5 launches {delta}")


def p20_soak(card: str) -> dict:
    """(c) soak.lm_serve on the card for SOAK_S seconds: its own pins
    (every whole-response and streamed output equal to generate(), the
    seeded sample equal every iteration) and stall rule, the launches of
    K1 and K7 (the paged engine's draft-less ticks) at D 8, the median
    iteration, and this process's allocated memory back after its
    serve.shutdown() within half of what its replica's build added (phase
    10's bound)."""
    from ray_tpu_torch.scripts import soak

    log(f"phase 20 (c): soak.lm_serve for {SOAK_S:g} s on the card")
    mem0 = mem_now()
    reset_counts()
    with example_backend(serve) as live:
        iters = soak.lm_serve(SOAK_S, device=DEVICE)
    counts = read_counts()
    (backend,) = live
    D, kw, growth = backend.head_dim, backend.kw, backend.growth
    live.clear()        # the closed backend still holds its parameters
    del backend
    mem1 = mem_now()
    times = soak.LAST_TIMES["lm_serve"]
    med = float(np.median(times))
    if D != 8 or not kw.get("paged"):
        raise AssertionError(f"soak backend: D {D}, {kw}")
    for name in ("rms_norm", "add_rms_norm", "paged_decode_attention"):
        if counts[name] == 0:
            raise AssertionError(f"soak: no {name} launch: {counts}")
    if mem1 - mem0 > growth // 2:
        raise AssertionError(
            f"soak: {mem1 - mem0} bytes more after serve.shutdown() than "
            f"before, over half the replica's {growth}")
    log(f"  soak.lm_serve: {iters} iterations in {SOAK_S:g} s, every one's "
        f"3 whole-response, 1 streamed and 1 sampled outputs pinned; median "
        f"iteration {med * 1e3:.1f} ms, longest {max(times) * 1e3:.1f} ms "
        f"(no stall under the soak's rule); the paged speculative engine at "
        f"D {D} f32: K7 {counts['paged_decode_attention']}, "
        f"K1 {counts['rms_norm']} plain + {counts['add_rms_norm']} "
        f"residual, K6 {counts['decode_attention']}; "
        f"allocated memory {(mem1 - mem0) / 2**20:+.3f} MiB after "
        f"serve.shutdown() (the replica's build +{growth / 2**20:.3f} MiB) "
        f"[{card}]")
    return {"iters": iters, "median_ms": med * 1e3}


def p20_decode_inputs(B, H, KH, D, S, lens, dtype, seed):
    """K6's inputs and K7's on the same rows: a pool of 16-row pages
    (the soak's page size) holding each sequence's rows in shuffled
    pages, and the same rows laid out contiguously."""
    ps = 16
    P = S // ps
    q, kp, vp, table, ln = paged_inputs(B + 1, H, KH, D, ps, P,
                                        list(lens) + [0], dtype, seed)
    q, table, ln = q[:B].contiguous(), table[:B], ln[:B]
    kc = paged_attention.paged_gather(kp, table).contiguous()
    vc = paged_attention.paged_gather(vp, table).contiguous()
    return q, kc, vc, ln, kp, vp, table


def p20_kernels(card: str) -> None:
    """(d) K6 and K7 at D 8, 16, 32 and K3-K5 at D 16, 32 against their
    plain versions, in f32 and bf16; K7 equal to K6 bit for bit on the
    same rows; each timed beside its bound (bytes over 3.35 TB/s for
    K6/K7, operations over the dtype's peak for K3-K5: 989 TFLOP/s bf16,
    67 f32) and its plain version."""
    log("phase 20 (d): the small head dims' kernels against their plain "
        "versions, and their times")
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = (("the programs' shape", 8, 4, 2, 128, [0, 15, 16, 63, 64,
                                                      100, 126, 127]),
              ("~600 rows", 8, 16, 16, 1024, [600 + i for i in range(8)]))
    for D in P20_DECODE_DIMS:
        for tag, B, H, KH, S, lens in shapes:
            for dtype in (f32, bf16):
                q, kc, vc, ln, kp, vp, table = p20_decode_inputs(
                    B, H, KH, D, S, lens, dtype, seed=3000 + D)
                tol = (dict(atol=2e-5, rtol=0.0) if dtype == f32
                       else dict(atol=2e-2, rtol=2e-2))
                what = (f"D={D} {tag} B={B} H={H} KH={KH} "
                        f"{str(dtype)[6:]}, "
                        f"{attention.decode_splits(B * KH)} splits")
                with torch.inference_mode():
                    k6 = attention.decode_attention(q, kc, vc, ln)
                    check_close(f"decode_attention {what}", k6,
                                attention._decode_attention_ref(q, kc, vc,
                                                                ln), **tol)
                    k7 = paged_attention.paged_decode_attention(
                        q, kp, vp, table, ln)
                    check_close(f"paged_decode_attention {what}", k7,
                                paged_attention._paged_decode_ref(
                                    q, kp, vp, table, ln), **tol)
                    if not torch.equal(k7, k6):
                        raise AssertionError(f"{what}: K7 != K6 bits")
                if tag == shapes[0][0] and dtype == bf16:
                    continue   # the programs run f32: time it there
                if tag != shapes[0][0] and dtype == f32:
                    continue   # the ~600-row shape: time bf16
                live = sum(L + 1 for L in lens)
                es = q.element_size()
                k6_bytes = 2 * live * KH * D * es + 2 * B * H * D * es + 4 * B
                pages = sum(-(-(L + 1) // 16) for L in lens)
                sets = [p20_decode_inputs(B, H, KH, D, S, lens, dtype,
                                          seed=3100 + i)
                        for i in range(n_copies(2 * live * KH * D * es))]
                with torch.inference_mode():
                    t = {
                        "K6": device_ms(
                            "decode_attention kernel", lambda *a:
                            attention.decode_attention(*a[:4]), sets, 100,
                            sleep_cycles=200_000_000),
                        "K6 plain": device_ms(
                            "decode_attention plain", lambda *a:
                            attention._decode_attention_ref(*a[:4]), sets,
                            20, sleep_cycles=200_000_000),
                        "K7": device_ms(
                            "paged_decode_attention kernel", lambda *a:
                            paged_attention.paged_decode_attention(
                                a[0], *a[4:], a[3]), sets, 100,
                            sleep_cycles=200_000_000),
                        "K7 plain": device_ms(
                            "paged_decode_attention plain", lambda *a:
                            paged_attention._paged_decode_ref(
                                a[0], *a[4:], a[3]), sets, 20,
                            sleep_cycles=200_000_000)}
                b6 = bound(k6_bytes, 4 * live * H * D, dtype)
                b7 = bound(k6_bytes + 4 * pages, 4 * live * H * D, dtype)
                log(f"  time {what}, lengths {lens[0]}-{lens[-1]}: K6 "
                    f"{t['K6'] * 1e3:.2f} us (plain {t['K6 plain'] * 1e3:.2f}"
                    f"), bound {b6['bound_ms'] * 1e3:.3f} us "
                    f"({b6['bound_by']}); K7 {t['K7'] * 1e3:.2f} us (plain "
                    f"{t['K7 plain'] * 1e3:.2f}), bound "
                    f"{b7['bound_ms'] * 1e3:.3f} us ({b7['bound_by']}) "
                    f"[{card}]")
                del sets
    for D in P20_FLASH_DIMS:
        for dtype in (f32, bf16):
            for B, T, H, KH, causal in ((1, 64, 2, 1, True),
                                        (2, 129, 4, 2, False),
                                        (1, 300, 4, 1, True)):
                q, k, v, do = flash_inputs(B, T, H, KH, D, dtype,
                                           seed=3200 + D + T)
                check_flash(f"B={B} T={T} H={H} KH={KH} D={D} "
                            f"{'causal' if causal else 'full'} "
                            f"{str(dtype)[6:]}", q, k, v, do, causal)
            p20_flash_times(D, dtype, card)
    torch.cuda.empty_cache()


def p20_flash_times(D: int, dtype, card: str) -> None:
    """K3, K4, K5 at B 4, T = S 1024, H 8, KH 4, causal: each kernel and
    its plain version beside its bound (K3 two causal products, K4 three,
    K5 four; each input read and each output written once)."""
    B, T, H, KH = 4, 1024, 8, 4
    es = torch.tensor([], dtype=dtype).element_size()
    one, kv, stat = B * T * H * D * es, B * T * KH * D * es, B * H * T * 4
    mm = 2 * B * H * D * (T * (T + 1) // 2)
    sets = []
    for i in range(n_copies(2 * one + 2 * kv)):
        q, k, v, do = flash_inputs(B, T, H, KH, D, dtype, seed=3300 + i)
        o, lse = attention.flash_forward(q, k, v, True)
        sets.append((q, k, v, do, lse, attention._flash_dsum(o, do)))
    rows = []
    for name, fn, ref, nbytes, ops in (
            ("K3", lambda *a: attention.flash_forward(*a[:3], True),
             lambda *a: attention._flash_forward_ref(*a[:3], True),
             2 * one + 2 * kv + stat, 2 * mm),
            ("K4", lambda *a: attention.flash_backward_dq(*a, True),
             lambda *a: attention._flash_backward_dq_ref(*a, True),
             3 * one + 2 * kv + 2 * stat, 3 * mm),
            ("K5", lambda *a: attention.flash_backward_dkv(*a, True),
             lambda *a: attention._flash_backward_dkv_ref(*a, True),
             2 * one + 4 * kv + 2 * stat, 4 * mm)):
        ms = device_ms(f"{name} kernel", fn, sets, 20,
                       sleep_cycles=300_000_000)
        plain = device_ms(f"{name} plain", ref, sets, 3,
                          sleep_cycles=300_000_000)
        b = bound(nbytes, ops, dtype)
        rows.append(f"{name} {ms * 1e3:.2f} us (plain {plain * 1e3:.2f}, "
                    f"bound {b['bound_ms'] * 1e3:.3f} {b['bound_by']})")
    log(f"  time B={B} T=S={T} H={H} KH={KH} D={D} causal "
        f"{str(dtype)[6:]}: " + "; ".join(rows) + f" [{card}]")


def programs_path(card: str) -> dict:
    """Phase 20: the repo's programs (ray_tpu_torch.examples, the soak's
    LM workload) on a fresh local runtime, then the small head dims'
    kernels."""
    t_phase = time.perf_counter()
    log(f"phase 20 (a): the examples at their full size on {card}")
    rt.init(num_cpus=8, num_gpus=1)
    try:
        walls = p20_examples(card)
        soak = p20_soak(card)
    finally:
        rt.shutdown()
    p20_kernels(card)
    log(f"phase 20: walls {json.dumps({k: round(v, 3) for k, v in walls.items()})};"
        f" phase 20 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"walls": walls, "soak": soak}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available; this script "
                 "drives the port on an NVIDIA card")
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build()
    log(f"phase 1: built {len(built)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: nvcc {info['seconds']:.1f} s; " + " | ".join(ptxas))
    check_tc_ptxas(built["flash_attention"]["log"])

    errs = check_kernels()
    errs.update(check_paged_kernel())
    errs.update(check_train_kernels())

    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    params = init_params(cuda_gen(SEED), cfg, device="cuda")
    main = main_path(params, cfg)
    paged = paged_path(params, cfg)
    spec = speculative_path(params, cfg, main, paged)
    card_vs_cpu(params, engine_mod.GenerationEngine, "contiguous engine")
    card_vs_cpu(params, paged_mod.PagedGenerationEngine, "paged engine",
                page_size=PAGE)
    spec_f32_equal(params)
    train = train_path(card)
    train_card_vs_cpu()
    times = timings(main, card)
    times.update(paged_timings(paged, times["decode_attention"]["lens"],
                               card))
    spec_timings(spec, card)
    times.update(train_timings(card))
    train_breakdown(card, train["step_ms"])
    sched_path(card)
    direct_growth = runtime_path(params, cfg, main, card)
    serve_path(params, cfg, main, paged, direct_growth, card)
    fast = cluster_path(params, cfg, main, card)
    operator_path(main, card)
    library = train_library_path(train, card)
    mesh_path(train, library, card)
    tp = tp_serve_path(params, cfg, main, paged, spec, card)
    data_plane_path(params, cfg, main, fast, card)
    library_path(params, cfg, main, tp["one_process"], card)
    streaming_path(card)
    rllib_path(card)
    programs_path(card)

    # (kernel, its source, the TPU kernel it replaces, the path it runs on)
    table = {
        "rms_norm": ("rms_norm.cu", "ray_tpu/ops/fused.py:40", main),
        "add_rms_norm": ("rms_norm.cu", "ray_tpu/ops/fused.py:40", main),
        "rms_norm_backward": ("rms_norm.cu", "ray_tpu/ops/fused.py:77",
                              train),
        "decode_attention": ("decode_attention.cu",
                             "ray_tpu/ops/attention.py:544", main),
        "softmax_xent": ("softmax_xent.cu", "ray_tpu/ops/fused.py:117",
                         train),
        "flash_forward": ("flash_attention.cu",
                          "ray_tpu/ops/attention.py:185", train),
        "flash_backward_dq": ("flash_attention.cu",
                              "ray_tpu/ops/attention.py:371", train),
        "flash_backward_dkv": ("flash_attention.cu",
                               "ray_tpu/ops/attention.py:393", train),
        "paged_decode_attention": ("paged_decode_attention.cu",
                                   "ray_tpu/ops/paged_attention.py:74",
                                   paged),
    }
    kernels = []
    for name, (source, replaces, path) in table.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": path["launches"][name],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
