#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. Device and build: print the card's name and power limit, build the
   CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Kernel checks: each kernel (and three kernels compiled at run time
   through ``rtc``) against its plain PyTorch version on the card, at the
   serving, training and deploy paths' shapes and at ragged ones, with its
   time, the plain version's, a PyTorch library call's, and the least time
   the card could take (one JSON line per kernel and shape); matmul_bias_act's
   two schedules timed against each other over M; the conv kernels and their
   float32 plain versions against float64 at stage 4's 3x3.
3. Serving: full-width Transformer-base greedy decode through
   ``KVCacheDecoder`` on the card, with the kernel launch counts of that run
   checked against the path's expected counts (matmul_bias_act's small-M
   schedule at each decode step, its tiles at the prefill), then the same tokens
   teacher-forced through the port on the card and on the CPU, whose logits
   must agree.
   3b. Megastep: the same decoder's greedy tokens at K = 8 tokens a
   dispatch, each megastep one CUDA-graph replay, equal its single-step
   tokens; launches (a replay's counted from its capture), host-clock
   latency a token at K = 1 and K = 8, card time a megastep (profiler and
   CUDA events), the device's idle share.
   3c. Paged serving: ``PagedKVDecoder`` with eight lanes over one pool of
   2048 slots, eight prompts sharing a 64-token prefix: greedy tokens
   through ``step`` and through the graphed ``step_megastep`` equal;
   teacher-forced logits on the card and the CPU agree; with the prefix
   cache, cached admits give the cold admit's logits bitwise and the chunk
   program's launches are the path's; ``SpeculativeDecoder`` (a one-layer
   draft) gives the target's plain greedy tokens; nothing binds after
   warmup; latencies and card time as in 3b.
4. Training: the same model bound for training (``simple_bind``,
   ``forward_backward``, an SGD-momentum updater) on one fixed batch. One
   step at batch 2 gives the same loss and gradients on the card and on the
   CPU; then timed steps at batch 8 whose launch counts must be the path's
   and whose loss must fall, with a profiler breakdown of one step.
5. ResNet-50 serving: the zoo's ResNet-50 v2 at its ImageNet widths, random
   weights from a numpy seed, bound with ``grad_req="null"`` and run with
   ``forward(is_train=False)`` at batch 32 and at batch 1 (median latency,
   images/s, a profiler breakdown); the stats-free conv_bn kernel's
   launches are the plan's 49 a forward; card and CPU probabilities agree
   at batch 2.
6. ResNet-50 training: the same symbol bound for training at batch 32, one
   fixed batch, SGD-momentum: one step at batch 2 gives the same loss,
   gradients and new moving stats on the card and on the CPU; then timed
   steps whose conv_bn and conv_bn_bwd launches are the plan's 49 each a
   step, whose loss must fall and whose moving stats must change, with a
   profiler breakdown of one step. TF32 must be off in both ResNet phases.
7. Deploy: ResNet-50's symbol, weights and moving stats are written with
   ``model.save_checkpoint``, read back as a string and bytes, and served by
   ``Predictor`` on the default context; raw images are normalised on the
   card by a CUDA kernel compiled at run time through ``rtc``; the
   probabilities must agree with a direct ``bind``; ``reshape`` to batch 1
   and back binds nothing the second time; a second predictor over the
   symbol's internals taps the input of stage 1's 1x1 shortcut convolution,
   and ``matmul_with_stats`` gives that convolution's output and its
   per-channel statistics from the checkpoint's weight, held against
   ``F.conv2d``. Latencies of ``forward`` + ``get_output`` at batch 32 and 1.
8. Engine: ``InferenceEngine`` serves ResNet-50 (buckets 1-32) to eight
   client threads, three loads of 640 requests, each in a profiler window
   of its own: each request equals its rows of the batch it rode in and
   each batch a second run of it, bitwise; 49 conv_bn launches a batch; no
   bind after warmup; throughput, client and engine latency and the card's
   idle share of each load. The oversize refusal; the manifest replayed by
   a fresh cache; a batch-32 dispatch against the bare forward. Then an injected dispatch
   fault is retried (health degraded, then healthy), a burst with 1 ms
   deadlines is shed, and new weights are reloaded under load (requests
   before on the old weights, after on the new, each batch equal to a
   fresh cache's). The Transformer-base prefill graph through the engine
   (6 / 13 / 6 launches of the flash forward, LayerNorm and ffn1 a batch),
   and a decoder's weights swapped under its captured megastep (a fresh
   decoder's tokens, no new capture).
9. Module: ResNet-50 through ``Module.fit`` (an ``NDArrayIter`` of four
   fixed batches of 32 on the card, two epochs, SGD-momentum with a
   ``FactorScheduler``, metrics acc and top-5, a ``Speedometer``,
   ``do_checkpoint``) against phase 6's manual executor + updater loop over
   the same 8 batches from the same weights: parameters and moving stats
   within 1e-6 of each array's largest magnitude (expected bitwise), 49
   conv_bn and 49 conv_bn_bwd launches a step, 49 stats-free conv_bn a
   ``score`` batch, the checkpoint reloaded by ``Module.load`` scores the
   same bits; both steps timed in turns (host p50/p80), their card time by
   the profiler within 5 % of each other, the shares of ``load_data_label``,
   the executor, ``update`` and ``update_metric`` in a Module step, and
   ``io.input_bound_pct``. Then the MNIST ``mlp`` and ``lenet`` through
   ``MNISTIter`` over idx files the phase writes (synthetic digits), card
   against the port's CPU run from the same Xavier weights (rtol 1e-4,
   atol 1e-5), validation accuracy over 0.9, ``matmul_bias_act``'s launches
   the plan's, and ``FeedForward.fit`` equal to ``Module.fit``.
10. The zoo's image classifiers at their published widths. Inception-v3
   (299 x 299): each distinct fused conv site shape at batch 32 against the
   plain versions (forward, stats-free forward, backward), timed against
   ``F.conv2d``, ``aten.convolution_backward`` and its bound; served at
   batch 32 and 1 (50 stats-free conv_bn launches a forward, latency,
   images/s, the card's idle share); card vs CPU at batch 2 (probabilities,
   and a training step held as phase 6 holds ResNet-50's); ``Module.fit`` at
   batch 32 over fixed batches (50 conv_bn and 50 conv_bn_bwd launches a
   step, the loss falling, host p50/p80, card time, idle share, images/s).
   Inception-BN (224 x 224) the same (its convs carry a bias: no fused site).
   Kernel 6 at AlexNet's and VGG-16's classifier shapes; AlexNet and VGG-16
   at batch 32: 2 kernel-6 launches a forward, card vs CPU at batch 2
   (inference, and a training step with every Dropout's p at 0), two
   training steps at p = 0.5 from the same seed bitwise equal, the kept
   fraction within 4σ of 0.5, timed steps.
11. MT: ``get_symbol_mt`` at its defaults trained at batch 32: card vs CPU at
   batch 2 (the loss, every gradient, the encoder's nonzero), launches of
   kernels 1-6 the plan's (18 flash, 32 LayerNorm, 12 ffn1 a step), the loss
   falls, step time, card time and idle share. Phase 2 holds its
   non-causal flash shape (256, 64, 64, 64) forward and backward.
12. LSTM: (a) example/rnn/lstm_bucketing.py's network through
   ``BucketingModule.fit`` for one epoch: its first 6 batches' parameters
   equal the port's CPU run's, one bind a bucket, the perplexity falls,
   tokens/s over real tokens, host p50 a batch, idle share; (b)
   ``models/lstm.py`` on the fused RNN op: card vs CPU at batch 2, timed
   steps and tokens/s, ``FusedRNNCell.unfuse()`` equal to the fused outputs.
13. SSD: VGG16-SSD-300 (``vgg16-ssd-300-train`` and ``vgg16-ssd-300``) at its
   published widths. The op sweep: every op of the vision, sequence, CTC,
   Custom and sampler modules and the rest of the layer and matrix ops,
   forward and backward on the card against the port's CPU run of the
   same numpy inputs, the samplers held to their distributions. One
   training step at batch 2 card vs CPU (the SSD loss, every gradient by
   its distance from the CPU's float64 one; the CPU takes the card's side
   at ReLU and max-pool kinks and the card's MultiBoxTarget outputs).
   ``Module.fit`` at batch 8 over
   ``SyntheticDetIter``'s fixed batches (the loss of the fixed targets must
   fall; step p50/p80,
   images/s, card time, idle share). MultiBoxTarget and MultiBoxDetection
   on the trained model's predictions, card against CPU from the same
   inputs: equal but for the counted near-ties. The deploy graph at batch 8
   and 1 (latency, images/s, idle share, launches a request, detections an
   image). None of the port's ten kernels launches on the SSD path.
14. KVStore: the recommender (``models/recommender.py`` at its defaults:
   tables 65536 x 64 and 32768 x 64) at batch 512 through
   ``Module.fit(kvstore='device')`` over ``[gpu(0), gpu(0)]``, one epoch of
   SGD with momentum and one of Adam on a synthetic click task, its
   embedding gradients through the sparse round and the lazy update: the
   logistic loss falls, the tables' states are ``RowSparseState``, the
   sparse counters tick, untouched rows keep their initial weights bit for
   bit and hold no state, kernel 6 launches 4 times an executor a step;
   three steps card vs CPU (rtol 1e-4, atol 1e-5); step time (CUDA events,
   host clock), ``update()``'s host time, the idle share. Kernel 6 at the
   four FC+relu shapes (256 and 512 rows; K = 193 its 4-byte route)
   against its plain version, ``addmm`` + relu and its bound. The MNIST
   ``mlp`` over one context at batch 40 and two at 20 + 20 agree; one NCCL
   rank of ``dist_sync`` (on the per-device path, ``MXNET_MODULE_FUSED_STEP=0``)
   gives the bits of a ``local`` store, and its process group is destroyed.
15. Fused step (``module/spmd_adapter.py`` over ``parallel.SPMDTrainer``):
   forward, backward and the update as one CUDA graph a step. ResNet-50
   through ``Module.fit`` on ``[gpu(0)]`` with ``MXNET_MODULE_FUSED_STEP=1``
   at phase 9's settings: a captured step holds 49 conv_bn and 49
   conv_bn_bwd launches, counted at each replay and seen by the profiler
   as in the eager step; the loss falls; after 3 steps the fused step's
   parameters and moving stats equal the per-device path's; a batch-2
   fused step on the card equals the CPU's; fused and per-device steps
   timed in turns (host p50/p80, CUDA events, idle share, ``update()``'s
   share). ``MXNET_TRAIN_MEGASTEP_N=4``: bitwise the N = 1 weights after 8
   steps, 2 dispatches against 8, per-step latency. A ``FactorScheduler``
   freezes the weights inside the graph; under ``MXNET_ANOMALY_GUARD=skip``
   a NaN batch leaves weights, moving stats and optimizer state bitwise
   unchanged. The recommender with Adam on one context: kernel 6 four times
   in its graph, three steps card vs CPU, fused against per-device times.
   The bucketed LSTM LM over two buckets: one graph a bucket, one shared
   state cell, real tokens/s. ``dist_sync`` on one NCCL rank: the fused
   step, bitwise the local fused step's weights.
16. Checkpoint (``checkpoint.Checkpointer``, ``module/elastic.py``):
   ResNet-50 at phase 9's settings through the fused step with
   ``fit(elastic={"checkpoint_dir": d, "checkpoint_period": 4})``: saves
   at rounds 4 and 8 (``states.bin`` in each), ``checkpoint.inflight`` > 0
   after a step while a save is written, 49 + 49 launches a step; a second
   module resumes from the round-4 set and finishes, its weights, moving
   stats and momentum within 1e-6 of each array's largest magnitude of the
   uninterrupted run's (bitwise expected; the largest difference printed).
   A step with and without a save timed in turns (host p50/p80, each
   ending in a synchronize of the compute stream), supersedes, one save's
   submit-to-landed seconds and bytes, both kinds' idle shares. The MNIST
   ``mlp`` on one NCCL rank of ``dist_sync`` with
   ``MXNET_KVSTORE_UPDATE=sharded``: ``Checkpointer.save_sharded`` every 2
   steps, every shard's digest checked, a fresh module's
   ``load_sharded_checkpoint`` continues to the uninterrupted run's bits
   (kernel 6 on the path). The recommender over ``[gpu(0)] * 2`` with
   ``kvstore='device'``: its sparse tables saved with ``save_sharded`` and
   loaded by a fresh store: weights, state rows, the touched set and update
   counts bitwise. The checkpoints live in a temporary directory the phase
   removes.
17. Planner (``analysis/``, ``parallel/autoplan.py``,
   ``module.PipelineExecutorGroup``, ``fusion._conv_block_sharded``):
   ResNet-50 bound at batch 32 for training under ``MXNET_GRAPHLINT=error``
   lints clean, its memory plan's predicted peak printed beside the card's
   measured one (and the MNIST ``mlp``'s prediction within the reference's
   2x of its live buffers); ResNet-50's fused ``Module.fit`` at phase 9's
   settings under ``MXNET_AUTOPLAN=1`` (the plan's ``summary()``, 49 + 49
   launches a captured step) is bitwise the unplanned fit; ResNet-50 through
   ``PipelineExecutorGroup`` (two stages, four microbatches of 8,
   SGD-momentum, 8 steps): launches exact in each phase (``conv_bn`` a site
   a microbatch in the forward phase and again in the recompute,
   ``conv_bn_bwd`` once), the loss falls, a batch-4 step (two microbatches)
   card vs CPU by phase 6's rule, host p50/p80 a step, CUDA-event spans,
   the profiler's idle share and the peak memory against the per-device
   step's; the MNIST ``mlp`` pipeline equals its full-batch step (atol
   1e-5) with its kernel-6 launches counted; ``_conv_block_sharded`` at
   stage 1's 3x3 shape on one NCCL rank: outputs, statistics and gradients
   bitwise ``ConvBlock``'s, the process group destroyed after.
18. Native runtime (``engine``, ``recordio``, ``io_native``, ``image_native``,
   ``image``, ``c_api``, ``predict_api``): the five host libraries built
   from the checkout into ``build/torch_native/`` (path and seconds each;
   the image pipeline where libjpeg's and libpng's headers are, else one
   line naming what is missing); raw records through ``MXIndexedRecordIO``
   and ``NativePrefetchReader``; 256 JPEG images of 256 x 256 packed with
   ``recordio.pack_img`` and read by ``ImageRecordIter`` as
   ``train_imagenet.py`` reads them (224 crops, mirrors, ImageNet means, 4
   threads; the path that ran asserted: native exactly where the pipeline
   built), its batches staged through two page-locked buffers; ResNet-50's
   fused ``Module.fit`` from it for two epochs of 8 steps under
   ``ThreadedEngine`` with ``do_checkpoint`` (49 + 49 launches a step, the
   loss falling, ``load_checkpoint`` bitwise ``get_params()`` after
   ``nd.waitall()``), one more epoch continued and resumed from the
   checkpoint (``resume_or_init`` and the saved optimizer states) bitwise
   equal; images/s, host p50/p80 a step, ``io.input_bound_pct``, the
   profiler's idle share of iterator-fed and fixed-batch steps,
   ``save_checkpoint``'s return against its write landing; native against
   Python decode where both exist. LeNet trained through the C training
   ABI at ``dev_type=2`` (20 steps, the loss falling, one kernel-6 launch a
   step) and ResNet-50 served through the C predict ABI at ``dev_type=2``,
   batch 1, from the fit's ``.params`` (49 stats-free conv_bn launches),
   equal to the in-process ``Predictor``; both driven in this process
   through ``ctypes``, and the predict program once more as an executable
   with an embedded interpreter.
19. The serving fleet (``serving/fleet/``): ResNet-50 (phase 5's seed)
   behind the port's ``Router`` over the engine phase's buckets. An
   in-process cache gives the reference outputs of eight payloads of 8
   images (the plain conv_bn version on the card differs from them, so the
   bitwise checks see which ran); one ``ReplicaApp`` in this process gives
   them bitwise through a Router, with 49 stats-free conv_bn launches a
   dispatch; ``Fleet(spec, n_replicas=2)`` spawns two replica processes on
   the card from a ``save_params_npz`` file (seconds to ready each, the
   kernel library loaded, not built again, each process's card memory),
   which give the same bits through the Router and each over its own
   ``RpcClient``; the same closed-loop load through the single replica and
   the fleet (images/s, host p50/p99); a chaos load with replica 0
   SIGKILLed at a third and ``Fleet.rollout`` to new weights at half: no
   request lost, replica 0 restarted (seconds), the rollout applied or
   recycled on both (seconds), and the payloads then give the swapped
   reference's bits; the merged fleet trace passes the port's ``mxtrace``
   check, holds a request chain across the router and a replica and prints
   under ``--fleet``; after ``close`` no replica process remains, nor on
   the card.
20. A ``smoke`` line (the run's seconds from the import of the port), a
   ``profiler`` line (how many timing windows were taken again after the
   profiler's gap), a ``{"kernels": [...]}`` line of ten kernels (rows 6, 8
   and 9 with the module phase's ``module_launches``, the zoo's
   ``zoo_launches`` and the MT step's ``mt_launches``; every row with the
   SSD phase's ``ssd_launches``, 0, and the KVStore phase's
   ``recommender_launches``; row 6 with ``recommender_fc``; rows 6, 8 and 9
   with the fused-step phase's ``fused_launches``, the checkpoint
   phase's ``checkpoint_launches``, the planner phase's
   ``planner_launches`` and the native phase's ``native_launches``; row 8
   with the fleet phase's ``fleet_launches``), the
   card's name/power line, then the last line ``{"ok": true, "device":
   {...}}``.

Imports nothing of JAX or of the JAX package.
"""
import contextlib
import hashlib
import io
import json
import logging
import math
import os
import pickle
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

# Transformer-base LM (the defaults of models/transformer.get_symbol) and the
# serving shape this smoke drives: prompts of 100 tokens, 64 greedy tokens.
MODEL = dict(vocab_size=32000, num_layers=6, num_heads=8, model_dim=512, ffn_dim=2048)
SERVE = dict(batch=8, prefill_len=128, max_len=256, pos_len=256)
PROMPT_LEN, NEW_TOKENS, SEED = 100, 64, 0
# the paged decoder: eight lanes of 256 slots over one pool of 2048, pages of
# 8 slots; its eight prompts of PROMPT_LEN tokens share their first
# PREFIX_LEN, cached in chunks of PREFIX_CHUNK. Megasteps of MEGASTEP_K
# tokens (one CUDA graph each); speculative rounds of SPEC_GAMMA draft
# tokens from a draft of DRAFT_LAYERS layers; CPU_CHECK_STEPS paged steps
# teacher-forced on the CPU too.
PAGED = dict(lanes=8, max_len=256, page_size=8, prefill_len=128, pos_len=256)
PREFIX_LEN, PREFIX_CHUNK, MEGASTEP_K = 64, 8, 8
SPEC_GAMMA, DRAFT_LAYERS, CPU_CHECK_STEPS = 4, 1, 4
# the training step this smoke drives: 8 sequences of 256 tokens (2048 a
# step), SGD with momentum and rescale_grad = 1/batch as Module sets it
TRAIN = dict(batch=8, seq_len=256, check_batch=2, warmup_steps=2, steps=10, lr=0.002,
             momentum=0.9, wd=1e-4)

# ResNet-50 v2 (models/resnet.get_symbol's ImageNet widths: filters
# 64/256/512/1024/2048, units 3/4/6/3, 1000 classes), f32, TF32 off; not cut.
# Served at batch 32 and 1; trained at batch 32 on one fixed batch with
# SGD-momentum, rescale_grad = 1/batch as Module sets it.
RESNET = dict(num_classes=1000, num_layers=50, image_shape="3,224,224")
RESNET_SERVE = dict(batches=(32, 1), check_batch=2, iters=20)
RESNET_TRAIN = dict(batch=32, check_batch=2, warmup_steps=2, steps=10, lr=0.01, momentum=0.9,
                    wd=1e-4)
# the plan's fused conv sites (49 of the 53 convolutions; conv0 and the three
# 3x3 stride-2 convs stay F.conv2d): one launch each a forward, and one
# backward launch each a training step
RESNET_SITES = 49
# the batch-2 card vs CPU training check: a gradient that misses rtol 1e-3,
# atol 1e-3·max|grad| of the CPU's float32 one must lie as close to the
# CPU's float64 gradient as this many times the CPU's float32 one does (the
# randomly initialised net is chaotic there, PERF.md §6, PR 3)
RESNET_F64_FACTOR = 8.0

# The deploy phase: ResNet-50 served by Predictor from a checkpoint on disk at
# batch 32 and 1; raw images in U(0, 255) are normalised on the card with
# ImageNet's per-channel mean and standard deviation by an rtc kernel.
DEPLOY = dict(batch=32, epoch=10, iters=20, mean=(123.68, 116.78, 103.94),
              std=(58.40, 57.12, 57.38), tap="stage1_unit1_relu1_output",
              tap_weight="stage1_unit1_sc_weight")
# The engine phase: InferenceEngine over ResNet-50 (buckets up to 32, 5 ms
# batching delay) under eight closed-loop clients of 80 requests of 1-4
# images each (about 3 s of load), taken three times, each a profiler window
# of its own; a dispatch fault, a shed burst and a reload under load (four
# clients of 16 requests of 4 images); then the Transformer-base prefill
# graph over buckets 1-8 of 128 tokens.
ENGINE = dict(buckets=(1, 2, 4, 8, 16, 32), max_delay_ms=5, clients=8, requests=80,
              load_seeds=(SEED + 20, SEED + 27, SEED + 28), reload_requests=16, rows=(1, 4),
              health_window_s=0.5, prefill_buckets=(1, 2, 4, 8))
# The module phase: ResNet-50 through Module.fit from phase 6's weights on
# four fixed batches of 32 for two epochs (8 steps), SGD-momentum with
# RESNET_TRAIN's lr, momentum and wd and a FactorScheduler (lr halved every
# 3 updates), against phase 6's manual executor + updater loop over the
# same batches; then the MNIST mlp (784-128-64-10) and lenet (20 and 50
# filters, 500 hidden) at their published widths through MNISTIter on
# synthetic digits (example/image-classification/train_mnist.py's
# _synthetic_mnist), cut from 60 000 training images to 6000 (and 1000 for
# validation) for time, batch 100, two epochs, fc1's lr halved through
# set_lr_mult; card against the port's CPU run.
MODULE = dict(batches=4, epochs=2, factor_step=3, factor=0.5, top_k=5, timed_steps=10,
              breakdown_steps=5, mnist_train=6000, mnist_val=1000, mnist_batch=100,
              mnist_epochs=2, mnist_lr=0.05, mnist_momentum=0.9, fc1_lr_mult=0.5,
              budget_s=60.0)
# the MNIST nets' fused matmul_bias_act sites a forward: mlp's fc1+relu and
# fc2+relu, lenet's fc1+tanh
MNIST_SITES = {"mlp": 2, "lenet": 1}
# Phase 10, the zoo's image classifiers at their published widths (f32, TF32
# off, random weights from the seed, He-scaled as RESNET's): Inception-v3
# (299 x 299, 1000 classes, 23 834 568 parameters; 50 fused conv sites of 23
# distinct shapes at batch 32, each shape held against its plain version and
# timed) and Inception-BN (224 x 224; its convolutions carry a bias, so the
# planner fuses none, as the JAX planner does), each served at batch 32 and 1
# and trained through Module.fit at batch 32 over ``fit_batches`` fixed
# batches for ``fit_epochs`` epochs, SGD-momentum; AlexNet and VGG-16 at 224 x
# 224 and batch 32: an inference forward and ``cls_steps`` training steps
# with Dropout at p = 0.5. Not cut.
ZOO = dict(batch=32, check_batch=2, serve_iters=10, lr=0.01, momentum=0.9, wd=1e-4, cls_steps=3,
           conv_iters=5)
INCEPTION = {"inception-v3": dict(image=(3, 299, 299), sites=50, fit_batches=2, fit_epochs=3,
                                  check_shapes=True),
             "inception-bn": dict(image=(3, 224, 224), sites=0, fit_batches=2, fit_epochs=2)}
# AlexNet's fc1 + relu and fc2 + relu, VGG-16's fc6 + relu6 and fc7 + relu7:
# kernel 6 twice a forward; its shapes there at batch 32, as (M, K, N):
# AlexNet's fc1 at 224 x 224 (K = 256·5·5; 256·6·6 = 9216 at 227 x 227),
# fc2 and VGG-16's fc7, VGG-16's fc6
CLASSIFIERS = {"alexnet": (3, 224, 224), "vgg16": (3, 224, 224)}
CLASSIFIER_FC_SITES = 2
FC_SHAPES = [(32, 6400, 4096), (32, 9216, 4096), (32, 4096, 4096), (32, 25088, 4096)]
# Phase 11: the MT Transformer at get_symbol_mt's defaults (6 + 6 layers, 8
# heads, model 512, ffn 2048, vocab 32 000, 64 source and 64 target tokens),
# trained at batch 32 (2048 target tokens a step) on one fixed batch. Not cut.
MT = dict(vocab_size=32000, num_layers=6, num_heads=8, model_dim=512, ffn_dim=2048, src_len=64,
          tgt_len=64, batch=32, check_batch=2, warmup_steps=2, steps=6, lr=0.002, momentum=0.9,
          wd=1e-4)
# Phase 12: (a) example/rnn/lstm_bucketing.py's network and settings (two
# LSTMCells of 200, embed 200, buckets 10-60, batch 32, SGD lr 0.01, wd 1e-5,
# Xavier(in, 2.34), Perplexity(0)) over its synthetic Zipf corpus at PTB's
# 10 000 words and 2000 sentences, one epoch; its first ``check_batches``
# batches card vs CPU. (b) models/lstm.py at its defaults on the fused RNN op.
LSTM_BUCKETING = dict(num_hidden=200, num_embed=200, num_layers=2,
                      buckets=(10, 20, 30, 40, 50, 60), batch=32, lr=0.01, wd=1e-5,
                      sentences=2000, vocab=10000, check_batches=6)
LSTM_FUSED = dict(num_classes=10000, num_embed=256, num_hidden=512, num_layers=2, seq_len=32,
                  batch_size=32, steps=6, lr=0.01)
# Phase 13: VGG16-SSD-300 (BASELINE.json config 4) with example/ssd/train_ssd.py's
# settings: 20 classes + background, 300 x 300, batch 8, SGD momentum 0.9,
# wd 5e-4, Xavier, metric.Loss, over SyntheticDetIter's random rectangles (up
# to 4 a image); cut to 2 fixed batches for 4 epochs. The script's lr 0.01
# diverges from Xavier weights within 5 steps, and so does 0.004
# (tools/torch_ssd_lr.py, PERF.md §4), so the phase trains at 0.001. The
# deploy graph keeps the 400 best boxes for NMS (get_symbol's nms_topk).
SSD = dict(num_classes=20, image=(3, 300, 300), batch=8, check_batch=2, fit_batches=2,
           fit_epochs=4, lr=0.001, momentum=0.9, wd=5e-4, max_objects=4, serve_iters=10,
           nms_topk=400)
# the MultiBox card-vs-CPU check's near-ties: a mined negative whose
# background probability lies within mining_rel (relative) of the image's
# cut-off; a box pair whose IoU lies within nms_iou of the NMS threshold
SSD_TIE = dict(mining_rel=1e-6, nms_iou=1e-5)
# the op sweep, card vs CPU: forward outputs (float32 elementwise ops and
# short sums; log, exp and division round apart by an ulp) and gradients
SSD_OP_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# matmul_with_stats: ResNet-50's 1x1 convolutions at batch 32 as (M, K, N)
# matrices (stage 1's 64->256, 64->64 and 256->64 at 56 x 56, stage 2's
# 512->128 at 28 x 28, stage 4's 2048->512 at 7 x 7), then a ragged one
MATMUL_STATS_SHAPES = [(100352, 64, 256, ""), (100352, 64, 64, "n64_"),
                       (100352, 256, 64, "k256_"), (25088, 512, 128, "k512_"),
                       (1568, 2048, 512, "k2048_"), (1000, 70, 200, None)]

# The user kernels rtc compiles at run time. The parameters are the inputs'
# device pointers in order, then the outputs'; sizes are written into the
# source. Beside each stands its plain version, a torch expression.
RTC_NORMALISE = r"""
extern "C" __global__ void rtc_normalise(const float* x, const float* mean, const float* stdv,
                                         float* y) {
  const int HW = %(hw)d, C = %(c)d, n = %(n)d;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int ch = (i / HW) %% C;
    y[i] = (x[i] - mean[ch]) / stdv[ch];
  }
}
"""
RTC_FMA = r"""
extern "C" __global__ void rtc_fma(const float* a, const float* b, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < %(n)d) o[i] = a[i] + b[i] * 3.0f;
}
"""
RTC_SPLIT = r"""
extern "C" __global__ void rtc_split(const float* x, float* o1, float* o2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < %(n)d) { o1[i] = x[i] + 1.0f; o2[i] = x[i] - 1.0f; }
}
"""
# the tensor cores' own rate through mma.sync (m16n8k8, TF32): a block's
# warps each run CHAINS independent accumulators for ITERS rounds, with no
# memory traffic; %(step)s is one accumulator's work a round, one product or
# the kernels' 3xTF32 step (tf32x3.cuh mma3: three products), into a fresh
# accumulator added to the running sum. Each chain has its own A and B
# changes every round, so the compiler can neither merge chains nor hoist a
# product out of the loop.
RTC_MMA_RATE = r"""
#define MMA(D, A) asm volatile( \
    "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%%0, %%1, %%2, %%3}, " \
    "{%%4, %%5, %%6, %%7}, {%%8, %%9}, {%%0, %%1, %%2, %%3};\n" \
    : "+f"(D[0]), "+f"(D[1]), "+f"(D[2]), "+f"(D[3]) \
    : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(b0), "r"(b1))
extern "C" __global__ void rtc_mma_rate(const float* in, float* out) {
  const int lane = threadIdx.x & 31;
  unsigned a[%(chains)d][4];
  for (int c = 0; c < %(chains)d; ++c)
    for (int i = 0; i < 4; ++i)
      a[c][i] = __float_as_uint(in[(lane + 8 * i + c) %% 64]) & 0xffffe000u;
  const unsigned b = __float_as_uint(in[(lane + 5) %% 64]) & 0xffffe000u;
  float acc[%(chains)d][4] = {};
  for (int it = 0; it < %(iters)d; ++it) {
    const unsigned b0 = b ^ ((it & 7u) << 13), b1 = b0 ^ 0x2000u;
#pragma unroll
    for (int c = 0; c < %(chains)d; ++c) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      %(step)s
      for (int i = 0; i < 4; ++i) acc[c][i] += d[i];
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < %(chains)d; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""
# the launch floor under the LayerNorm kernel: an empty kernel, and one block
# that copies n4 float4 (16 KB at the decode's 8 rows of 512)
RTC_EMPTY = r"""
extern "C" __global__ void rtc_empty(float* o) {}
"""
RTC_COPY = r"""
extern "C" __global__ void rtc_copy(const float* x, float* y) {
  const float4* s = reinterpret_cast<const float4*>(x);
  float4* d = reinterpret_cast<float4*>(y);
  for (int i = threadIdx.x; i < %(n4)d; i += blockDim.x) d[i] = s[i];
}
"""
MMA_RATE_STEPS = {"tf32": (1, "MMA(d, a[c]);"),
                  "mma3": (3, "MMA(d, a[c]); MMA(d, a[c]); MMA(d, a[c]);")}
MMA_RATE = dict(chains=8, iters=4096, blocks_per_sm=2, threads=256)

# Published peaks, dense, from NVIDIA's H100 data sheet: float32 outside the
# tensor cores, TF32 on the tensor cores (half the sheet's figure with
# sparsity) and HBM bandwidth.
PEAKS = {"PCIe": dict(f32=51e12, tf32=378e12, bytes=2.0e12),
         "NVL": dict(f32=60e12, tf32=417.5e12, bytes=3.9e12),
         "SXM": dict(f32=67e12, tf32=495e12, bytes=3.35e12)}
# matmul_bias_act's small-M schedule against its tiles at the decode's K and
# N, on both sides of the crossover (ops/matmul_bias_act.py SMALL_M_MAX)
CROSSOVER_M = (8, 16, 32, 48, 64, 96, 128, 160, 192, 256)

# kernel checks: the largest absolute difference of each kernel from its
# plain version (f32, TF32 off; the two sum in other orders: K-long dot
# products for the GEMM, S-long ones for dq, T-long ones for dk/dv, and
# 2048-row column sums for LayerNorm's dgamma and dbeta)
TOL = {"flash_attention": 1e-5, "norm_residual": 1e-5, "matmul_bias_act": 1e-4,
       "flash_attention_dq": 1e-4, "flash_attention_dkv": 1e-4, "norm_residual_bwd": 1e-4}
# the conv kernels: each output's largest difference from the plain version
# over the plain version's largest magnitude. c and dx are K·taps- and
# N·taps-long f32 dot products (up to 4608 terms); ssum, ssq, dw, dscale and
# dshift are B·H'W'-long f32 sums (up to 100 352 terms), taken in another
# order than cuDNN's and torch.sum's
CONV_TOL = {"elementwise": 1e-5, "sums": 1e-4}

# the conv_bn_bwd call's kernels (csrc/conv_bn_bwd.cu), timed one by one
BWD_PARTS = ("fold", "wflip", "dgrad", "wgrad", "partials_sum")

# name -> (source, the TPU kernel it replaces, its symbol in the profiler)
KERNELS = {
    "flash_attention": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                        "mxnet_tpu/ops/pallas_attention.py:81", "flash_fwd_kernel"),
    "flash_attention_dq": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                           "mxnet_tpu/ops/pallas_attention.py:118", "flash_bwd_dq_kernel"),
    "flash_attention_dkv": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                            "mxnet_tpu/ops/pallas_attention.py:151", "flash_bwd_dkv_kernel"),
    "norm_residual": ("mxnet_tpu_torch/csrc/norm_residual.cu",
                      "mxnet_tpu/ops/pallas_norm_residual.py:78", "layer_norm_fwd_kernel"),
    # both of its kernels: layer_norm_bwd_kernel and layer_norm_bwd_sums_kernel
    "norm_residual_bwd": ("mxnet_tpu_torch/csrc/norm_residual.cu",
                          "mxnet_tpu/ops/pallas_norm_residual.py:92", "layer_norm_bwd"),
    "matmul_bias_act": ("mxnet_tpu_torch/csrc/matmul_bias_act.cu",
                        "mxnet_tpu/ops/pallas_matmul_bias_act.py:57", "matmul_bias_act"),
    "conv_bn": ("mxnet_tpu_torch/csrc/conv_bn.cu", "mxnet_tpu/ops/pallas_conv_bn.py:240",
                "conv_bn_fwd"),
    "conv_bn_bwd": ("mxnet_tpu_torch/csrc/conv_bn_bwd.cu", "mxnet_tpu/ops/pallas_conv_bn.py:511",
                    "conv_bn_bwd"),
    "matmul_stats": ("mxnet_tpu_torch/csrc/matmul_stats.cu",
                     "mxnet_tpu/ops/pallas_matmul_stats.py:47", "matmul_stats"),
    # the mechanism is rtc.py; the kernels it launches here are the strings above
    "rtc": ("mxnet_tpu_torch/rtc.py", "mxnet_tpu/rtc.py:65", "rtc_"),
}


def check(cond, what):
    """Fail the run (also under python -O, which strips asserts)."""
    if not cond:
        raise RuntimeError("chip_smoke check failed: %r" % (what,))


def log(obj):
    print(json.dumps(obj), flush=True)


def with_zeros(expected):
    """An expected launch-count dict over every counter of the port, 0 where
    ``expected`` names none."""
    from mxnet_tpu_torch import ops

    return {k: expected.get(k, 0) for k in ops.KERNELS}


def peaks_for(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


# The profiler drops the card's events for a spell of under 0.2 s about every
# 10 s (tools/torch_profiler_windows.py): a window that overlaps the spell
# holds none or only some of its kernels, and so does a window opened at once
# after it. A window is taken again after this pause until it is whole.
PROFILER_GAP_S = 0.3
# timing windows opened / taken again; breakdown windows with fewer device
# events than their twin (logged as the "profiler" phase)
PROFILER_TALLY = {"timing_windows": 0, "timing_windows_retaken": 0,
                  "breakdown_windows": 0, "breakdown_windows_short": 0,
                  "load_windows": 0, "load_windows_short": 0}


def profiler_window(fn, activities, sync=None):
    """Run ``fn`` in one profiler window, ended by ``sync`` (by default a
    synchronize of the device): (the window's device events as {name:
    [count, microseconds]}, its host wall ms, the wrappers' launches in
    it)."""
    from torch.profiler import profile

    from mxnet_tpu_torch import ops

    before = ops.launch_counts()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        (sync or torch.cuda.synchronize)()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    events = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            e = events.setdefault(evt.key, [0, 0.0])
            e[0] += int(evt.count)
            e[1] += float(getattr(evt, "self_device_time_total",
                                  getattr(evt, "self_cuda_time_total", 0.0)))
    return events, wall_ms, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def calls(fn, n):
    for _ in range(n):
        fn()


def device_events(fn, iters=30):
    """The profiler's device time per call of each kernel ``fn`` runs on the
    card, {name: ms}. A window is whole when each kernel ran a multiple of
    ``iters`` times, or when it shows the same counts as the window before
    it; the run fails when six windows in a row are not."""
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    counts, whole = None, False
    for attempt in range(6):
        if attempt:
            time.sleep(PROFILER_GAP_S)
        events, _, _ = profiler_window(lambda: calls(fn, iters), [ProfilerActivity.CUDA])
        PROFILER_TALLY["timing_windows"] += 1
        PROFILER_TALLY["timing_windows_retaken"] += bool(attempt)
        last, counts = counts, {k: n for k, (n, _) in events.items()}
        whole = bool(counts) and (all(n % iters == 0 for n in counts.values())
                                  or counts == last)
        if whole:
            break
    check(whole, ("the profiler shows no whole window of device events", counts))
    return {k: us / 1e3 / iters for k, (_, us) in events.items()}


def device_ms(fn, iters=30, key=None):
    """Device time per call of everything ``fn`` runs on the card (or of the
    events whose name holds ``key``), from the profiler's CUDA events. Fails
    the run when that is none: every time this script reports is that one
    measure, but for ``event_ms``."""
    ms = sum(v for k, v in device_events(fn, iters).items() if key is None or key in k)
    check(ms > 0, ("the profiler shows no device time", key))
    return ms


def event_ms(fn, iters=30):
    """Time per call of ``fn`` between two CUDA events around ``iters``
    calls on the current stream, after a warm-up: the cross-check of the
    profiler's time. The calls are queued behind a sleep on the card that
    outlasts their queueing (checked, and the sleep made longer until it
    does), so the window holds the card's time and none of the host's."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_first = not start.query()  # the card still slept when the last call was queued
        torch.cuda.synchronize()
        if queued_first:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("event_ms: the host did not queue %d calls within a sleep of %d cycles"
                       % (iters, cycles // 4))


def bound(flops, nbytes, peaks, products=False):
    """The least time (ms) for ``flops`` operations on ``nbytes`` bytes, and
    what bounds it. ``products``: the work is products that must keep f32
    accuracy, so the operations count three times at the TF32 tensor-core
    rate (3xTF32); otherwise at the f32 rate."""
    t_ops = (3.0 * flops / peaks["tf32"] if products else flops / peaks["f32"]) * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def product_bound(flops, nbytes, peaks):
    """A product kernel's bound on the tensor cores and, as ``f32_bound_ms``,
    its bound on the f32 CUDA cores (the figure earlier slices reported)."""
    b_ms, b_by = bound(flops, nbytes, peaks, products=True)
    return b_ms, b_by, bound(flops, nbytes, peaks)[0]


def entry(name, **fields):
    source, replaces, _ = KERNELS[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces, **fields)


def check_kernels(peaks):
    """Phase 2: each kernel against its plain version; returns the kernels line's
    entries (main-path shape) keyed by kernel name."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import matmul_bias_act as mba
    from mxnet_tpu_torch.ops import norm_residual as nr

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    entries, worst = {}, {}
    L, H = MODEL["num_layers"], MODEL["num_heads"]
    B, P, M = SERVE["batch"], SERVE["prefill_len"], MODEL["model_dim"]
    dh, FF = M // H, MODEL["ffn_dim"]
    BT, T0 = TRAIN["batch"], TRAIN["seq_len"]

    def record(name, prefix, **times):
        """The kernels line's entry: the first timed shape, then others'
        times under their prefix."""
        if not prefix:
            entries[name] = entry(name, **times)
        else:
            entries[name].update({prefix + k: v for k, v in times.items()
                                  if k not in ("bound_by", "shape")})

    # ---- flash attention: (BH, T, S, D, causal); the prefill's, the training
    # step's (also between CUDA events), then ragged
    timed = {0: "", 1: "train_", 6: "mt_"}
    Lmt = MT["src_len"]
    for i, (BH, T, S, D, causal) in enumerate([(B * H, P, P, dh, True),
                                                (BT * H, T0, T0, dh, True),
                                                (H, P, P, dh, True),  # a paged admit's
                                                (5, 77, 77, 40, True),
                                                (3, 50, 131, 128, True),
                                                (4, 33, 70, 96, False),
                                                # the MT step's encoder and cross
                                                (MT["batch"] * H, Lmt, Lmt, dh, False)]):
        q, k, v = randn(BH, T, D), randn(BH, S, D), randn(BH, S, D)
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max(float((o - po).abs().max()), float((lse - plse).abs().max()))
        check(math.isfinite(err) and err <= TOL["flash_attention"],
              ("flash_attention", BH, T, S, D, err))
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0), err)
        rec = {"phase": "kernel", "name": "flash_attention", "shape": [BH, T, S, D],
               "causal": causal, "max_abs_err": err}
        if i in timed:
            pairs = causal_pairs(T, S, causal)
            ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
            plain_ms = device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal))
            q4, k4, v4 = (t.reshape(BH // H, H, -1, D) for t in (q, k, v))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
            b_ms, b_by, f32_ms = product_bound(
                4.0 * D * pairs * BH, 4.0 * (2 * BH * T * D + 2 * BH * S * D + BH * T), peaks)
            # f32_work_tflops: the products' f32 work a second, against
            # mma_sync_rate's ceiling
            times = dict(plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         f32_bound_ms=f32_ms, f32_work_tflops=4.0 * D * pairs * BH / ms / 1e9)
            rec.update(kernel_ms=ms, **times)
            if timed[i] == "train_":
                # the call alone between two CUDA events: the profiler's cross-check
                times["event_ms"] = event_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
                rec["flash_attention_event_ms"] = times["event_ms"]
            record("flash_attention", timed[i], ms=ms, **times,
                   shape="prefill q,k,v (%d,%d,%d) causal" % (BH, T, D))
        log(rec)

    # ---- LayerNorm + affine: (R, D); prefill rows, decode rows, training rows,
    # a paged admit's and a verify chunk's rows, ragged
    timed = {0: "", 1: "decode_", 2: "train_"}
    for i, (R, D) in enumerate([(B * P, M), (B, M), (BT * T0, M), (P, M), (SPEC_GAMMA + 1, M),
                                (37, 300), (5, 1000)]):
        x, g, bb = randn(R, D), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
        y, mean, rstd = nr.layer_norm_affine(x, g, bb)
        py, pmean, prstd = nr.layer_norm_affine_plain(x, g, bb)
        torch.cuda.synchronize()
        err = max(float((y - py).abs().max()), float((mean - pmean).abs().max()),
                  float((rstd - prstd).abs().max()))
        check(math.isfinite(err) and err <= TOL["norm_residual"], ("norm_residual", R, D, err))
        worst["norm_residual"] = max(worst.get("norm_residual", 0.0), err)
        rec = {"phase": "kernel", "name": "norm_residual", "shape": [R, D], "max_abs_err": err}
        if i in timed:
            ms = device_ms(lambda: nr.layer_norm_affine(x, g, bb))
            ev_ms = event_ms(lambda: nr.layer_norm_affine(x, g, bb))
            plain_ms = device_ms(lambda: nr.layer_norm_affine_plain(x, g, bb))
            lib_ms = device_ms(lambda: F.layer_norm(x, (D,), g, bb, 1e-5))
            b_ms, b_by = bound(7.0 * R * D, 4.0 * (2 * R * D + 2 * D + 2 * R), peaks)
            rec.update(kernel_ms=ms, event_ms=ev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by, rows_per_warp=nr._rows_per_warp(R, D))
            record("norm_residual", timed[i], ms=ms, event_ms=ev_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   shape="prefill x (%d,%d)" % (R, D))
        log(rec)
    entries["norm_residual"]["launch_floor_ms"] = check_launch_floor(B, M)

    # ---- matmul + bias + act: (M, K, N, act, bias); prefill ffn1, decode ffn1,
    # training ffn1, a paged admit's and a verify chunk's ffn1, ragged
    timed = {0: "", 1: "decode_", 2: "train_"}
    cases = [(B * P, M, FF, "relu", True), (B, M, FF, "relu", True),
             (BT * T0, M, FF, "relu", True), (P, M, FF, "relu", True),
             (SPEC_GAMMA + 1, M, FF, "relu", True),
             (77, 200, 130, "sigmoid", True), (77, 200, 130, "tanh", False),
             (5, 33, 70, "softrelu", True), (130, 65, 3, "relu", True)]
    for i, (Mr, K, N, act, has_b) in enumerate(cases):
        a, w = randn(Mr, K), randn(N, K, scale=1.0 / math.sqrt(K))
        b = randn(N, scale=0.1) if has_b else None
        c = mba.matmul_bias_act(a, w, b, act)
        pc = mba.matmul_bias_act_plain(a, w, b, act)
        torch.cuda.synchronize()
        err = float((c - pc).abs().max())
        check(math.isfinite(err) and err <= TOL["matmul_bias_act"],
              ("matmul_bias_act", Mr, K, N, act, err))
        worst["matmul_bias_act"] = max(worst.get("matmul_bias_act", 0.0), err)
        rec = {"phase": "kernel", "name": "matmul_bias_act", "shape": [Mr, K, N], "act": act,
               "bias": has_b, "max_abs_err": err}
        if i in timed:
            ms = device_ms(lambda: mba.matmul_bias_act(a, w, b, act))
            plain_ms = device_ms(lambda: mba.matmul_bias_act_plain(a, w, b, act))
            lib_ms = device_ms(lambda: torch.relu(torch.addmm(b, a, w.t())))
            b_ms, b_by, f32_ms = product_bound(2.0 * Mr * N * K + 2.0 * Mr * N,
                                               4.0 * (Mr * K + N * K + N + Mr * N), peaks)
            sched = mba._schedule(Mr, N, K)
            rec.update(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, f32_bound_ms=f32_ms, schedule=sched)
            record("matmul_bias_act", timed[i], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, f32_bound_ms=f32_ms, library_ms=lib_ms, schedule=sched,
                   shape="prefill ffn1 a (%d,%d) w (%d,%d) relu" % (Mr, K, N, K))
        log(rec)
    check_crossover(randn, M, FF)
    check_backward_kernels(randn, peaks, entries, worst)
    check_conv_kernels(randn, peaks, entries, worst)
    check_deploy_kernels(randn, peaks, entries, worst)
    check_mma_rate(randn, peaks)
    for name, e in entries.items():
        e["max_abs_err"] = worst[name]
    return entries


def check_crossover(randn, K, N):
    """matmul_bias_act's two schedules timed against each other at the
    decode's K and N and a range of M: where the small-M schedule stops
    winning is the crossover (SMALL_M_MAX)."""
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    w, b = randn(N, K, scale=1.0 / math.sqrt(K)), randn(N, scale=0.1)
    rows = []
    for M in CROSSOVER_M:
        a = randn(M, K)
        c = torch.empty(M, N, device=a.device)
        want = mba.matmul_bias_act_plain(a, w, b, "relu")
        row = {"M": M, "picked": mba._schedule(M, N, K)}
        for sched in mba.SCHEDULES:
            if sched == "small_m" and not mba._small_m_takes(M, K):
                continue
            mba._launch(a, w, b, "relu", c, sched)
            torch.cuda.synchronize()
            err = float((c - want).abs().max())
            check(math.isfinite(err) and err <= TOL["matmul_bias_act"],
                  ("matmul_bias_act crossover", M, sched, err))
            row[sched + "_ms"] = device_ms(lambda: mba._launch(a, w, b, "relu", c, sched))
        row["library_ms"] = device_ms(lambda: torch.relu(torch.addmm(b, a, w.t())))
        rows.append(row)
    log({"phase": "kernel", "name": "matmul_bias_act_crossover", "K": K, "N": N,
         "small_m_max": mba.SMALL_M_MAX, "rows": rows})


def causal_pairs(T, S, causal):
    """The (query, key) pairs a bottom-right causal mask leaves visible."""
    return sum(min(S, r + (S - T) + 1) for r in range(T)) if causal else T * S


def check_backward_kernels(randn, peaks, entries, worst):
    """Phase 2, the training path's kernels: flash dq and dk/dv, LayerNorm
    backward, each against its plain version; the first shape of each is the
    training step's, and is timed."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import norm_residual as nr

    H, M = MODEL["num_heads"], MODEL["model_dim"]
    B, T0, dh = TRAIN["batch"], TRAIN["seq_len"], M // H

    # ---- flash backward: (BH, T, S, D, causal); the last, the MT step's
    # non-causal encoder and cross-attention shape, is timed too
    Lmt = MT["src_len"]
    for i, (BH, T, S, D, causal) in enumerate([(B * H, T0, T0, dh, True),
                                                (5, 77, 77, 40, True),
                                                (3, 50, 131, 128, True),
                                                (4, 33, 70, 96, False),
                                                (MT["batch"] * H, Lmt, Lmt, dh, False)]):
        q, k, v, do = randn(BH, T, D), randn(BH, S, D), randn(BH, S, D), randn(BH, T, D)
        scale = 1.0 / math.sqrt(D)
        o, lse = fa.flash_attention(q, k, v, causal=causal)
        delta = (do * o).sum(dim=-1)
        args = (q, k, v, lse, do, delta, causal, scale)
        dq, (dk, dv) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
        pdq = fa.flash_attention_bwd_dq_plain(*args)
        pdk, pdv = fa.flash_attention_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        err = {"flash_attention_dq": float((dq - pdq).abs().max()),
               "flash_attention_dkv": max(float((dk - pdk).abs().max()),
                                          float((dv - pdv).abs().max()))}
        for name, e in err.items():
            check(math.isfinite(e) and e <= TOL[name], (name, BH, T, S, D, e))
            worst[name] = max(worst.get(name, 0.0), e)
        rec = {"phase": "kernel", "name": "flash_attention_bwd", "shape": [BH, T, S, D],
               "causal": causal, "max_abs_err_dq": err["flash_attention_dq"],
               "max_abs_err_dkv": err["flash_attention_dkv"]}
        if i in (0, 4):
            prefix = "" if i == 0 else "mt_"
            pairs = causal_pairs(T, S, causal) * BH
            reads = 4.0 * (2 * BH * T * D + 2 * BH * S * D + 2 * BH * T)
            q4, k4, v4 = (t.reshape(BH // H, H, -1, D).detach().requires_grad_(True)
                          for t in (q, k, v))
            out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            do4 = do.reshape(BH // H, H, T, D)
            # one library call computes dq, dk and dv together: SDPA's backward
            lib_ms = device_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                           retain_graph=True))
            for name, fn, plain, flops, writes in (
                    ("flash_attention_dq", fa.flash_attention_bwd_dq,
                     fa.flash_attention_bwd_dq_plain, 6.0 * D * pairs, 4.0 * BH * T * D),
                    ("flash_attention_dkv", fa.flash_attention_bwd_dkv,
                     fa.flash_attention_bwd_dkv_plain, 8.0 * D * pairs, 8.0 * BH * S * D)):
                ms = device_ms(lambda: fn(*args))
                # the pass alone between two CUDA events: the profiler's cross-check
                ev_ms = event_ms(lambda: fn(*args))
                plain_ms = device_ms(lambda: plain(*args))
                b_ms, b_by, f32_ms = product_bound(flops, reads + writes, peaks)
                rec.update({name + "_ms": ms, name + "_event_ms": ev_ms,
                            name + "_plain_ms": plain_ms, name + "_bound_ms": b_ms,
                            name + "_f32_bound_ms": f32_ms})
                if prefix:
                    entries[name].update({prefix + "ms": ms, prefix + "event_ms": ev_ms,
                                          prefix + "plain_ms": plain_ms,
                                          prefix + "bound_ms": b_ms, prefix + "library_ms": lib_ms,
                                          prefix + "f32_bound_ms": f32_ms})
                    continue
                entries[name] = entry(
                    name, ms=ms, event_ms=ev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, f32_bound_ms=f32_ms,
                    library_ms=lib_ms, library="SDPA backward (dq, dk and dv together)",
                    shape="train q,k,v,dO (%d,%d,%d) causal" % (BH, T, D))
            if prefix:
                rec.update(library_ms=lib_ms)
                log(rec)
                continue
            # the whole call (δ, dq, dk/dv) and its δ = rowsum(dO∘O) alone
            # between two CUDA events
            bwd_event_ms = event_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                                   causal=causal))
            delta_event_ms = event_ms(lambda: (do * o).sum(dim=-1))
            rec.update(library_ms=lib_ms, dq_plus_dkv_ms=entries["flash_attention_dq"]["ms"]
                       + entries["flash_attention_dkv"]["ms"], bwd_event_ms=bwd_event_ms,
                       delta_event_ms=delta_event_ms)
            entries["flash_attention_dq"]["bwd_event_ms"] = bwd_event_ms
        log(rec)

    # ---- LayerNorm backward: (R, D); the training step's rows, then ragged
    for i, (R, D) in enumerate([(B * T0, M), (8, M), (37, 300), (5, 1000)]):
        x, g, bb, dy = randn(R, D), 1.0 + randn(D, scale=0.1), randn(D, scale=0.1), randn(R, D)
        _, mean, rstd = nr.layer_norm_affine(x, g, bb)
        got = nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)
        want = nr.layer_norm_affine_bwd_plain(x, g, mean, rstd, dy)
        torch.cuda.synchronize()
        err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        check(math.isfinite(err) and err <= TOL["norm_residual_bwd"],
              ("norm_residual_bwd", R, D, err))
        worst["norm_residual_bwd"] = max(worst.get("norm_residual_bwd", 0.0), err)
        rec = {"phase": "kernel", "name": "norm_residual_bwd", "shape": [R, D],
               "max_abs_err": err}
        if i == 0:
            fn = lambda: nr.layer_norm_affine_bwd(x, g, mean, rstd, dy)  # noqa: E731
            ms = device_ms(fn)  # the whole call: the kernel and the partial rows' sums
            kernel_only_ms = device_ms(fn, key="layer_norm_bwd_kernel")
            plain_ms = device_ms(lambda: nr.layer_norm_affine_bwd_plain(x, g, mean, rstd, dy))
            xr, gr, br = (t.detach().requires_grad_(True) for t in (x, g, bb))
            yr = F.layer_norm(xr, (D,), gr, br, 1e-5)
            lib_ms = device_ms(lambda: torch.autograd.grad(yr, (xr, gr, br), dy,
                                                           retain_graph=True))
            # the function's bytes: x and dy read, dx written, mean, rstd and
            # gamma read, dgamma and dbeta written (the partial rows are the
            # design's, not the function's)
            b_ms, b_by = bound(10.0 * R * D, 4.0 * (3 * R * D + 2 * R + 3 * D), peaks)
            rec.update(kernel_ms=ms, kernel_only_ms=kernel_only_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            entries["norm_residual_bwd"] = entry(
                "norm_residual_bwd", ms=ms, kernel_only_ms=kernel_only_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                shape="train x, dy (%d,%d)" % (R, D))
        log(rec)


def conv_case(randn, B, K, H, W, N, kernel, stride, prologue, res):
    """One fused conv's inputs on the card: x, He-scaled w, scale in
    [0.5, 1.5), small shift, and a residual."""
    x = randn(B, K, H, W)
    w = randn(N, K, kernel, kernel, scale=math.sqrt(2.0 / (K * kernel * kernel)))
    scale = shift = r = None
    if prologue:
        scale = 0.5 + torch.rand(K, device=x.device)
        shift = randn(K, scale=0.1)
    Ho, Wo = (-(-H // stride), -(-W // stride)) if kernel == 1 else (H, W)
    if res:
        r = randn(B, N, Ho, Wo)
    return x, w, scale, shift, r, (Ho, Wo)


def rel_err(got, want):
    """Largest |got − want| over the plain result's largest magnitude."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def conv_bytes(*tensors):
    return 4.0 * sum(t.numel() for t in tensors if t is not None)


def read_of_x(x, kernel, stride):
    """The part of x a conv must read: a strided 1x1 kernel reads only the
    sampled positions x[:, :, ::s, ::s] (a view; only its size is used)."""
    return x[:, :, ::stride, ::stride] if kernel == 1 else x


def check_conv_kernels(randn, peaks, entries, worst):
    """Phase 2, the ResNet path's kernels: the fused conv+BN forward (with
    its statistics, and the stats-free inference variant) and backward,
    each against its plain version, at the path's shapes and ragged ones.
    The first five shapes are the training step's (batch 32) and are
    timed: stage 1's 3x3 64->64 56x56 with a prologue, stage 1's 1x1 64->256
    with a prologue and the residual, stage 2's 1x1 stride-2 256->512
    shortcut, stage 3's 3x3 256->256 at 14x14 and stage 4's 1x1 512->2048
    with the residual at 7x7 (the grids the forward's tiling was cut for)."""
    from mxnet_tpu_torch.ops import conv_bn as cb

    Bt = RESNET_TRAIN["batch"]
    shapes = [  # (B, K, H, W, N, kernel, stride, prologue, res, prefix)
        (Bt, 64, 56, 56, 64, 3, 1, True, False, ""),
        (Bt, 64, 56, 56, 256, 1, 1, True, True, "res1x1_"),
        (Bt, 256, 56, 56, 512, 1, 2, True, False, "s2_"),
        (Bt, 256, 14, 14, 256, 3, 1, True, False, "s3_3x3_"),
        (Bt, 512, 7, 7, 2048, 1, 1, True, True, "s4_res1x1_"),
        (3, 16, 9, 9, 24, 3, 1, True, True, None),
        (2, 16, 9, 9, 40, 1, 2, True, False, None),
        (2, 8, 5, 7, 16, 1, 1, False, True, None),
        (1, 64, 7, 7, 200, 3, 1, False, False, None)]
    for B, K, H, W, N, kernel, stride, prologue, res, prefix in shapes:
        x, w, scale, shift, r, (Ho, Wo) = conv_case(randn, B, K, H, W, N, kernel, stride,
                                                    prologue, res)
        st = (stride, stride)
        got = cb.conv_block(x, w, scale, shift, r, st, prologue)
        want = cb.conv_block_plain(x, w, scale, shift, r, st, prologue)
        infer = cb.conv_block_infer(x, w, scale, shift, st, prologue)
        infer_want = cb.conv_block_infer_plain(x, w, scale, shift, st, prologue)
        dc, ds, dq = randn(B, N, Ho, Wo), randn(N, scale=0.01), randn(N, scale=1e-3)
        args = (x, w, scale, shift, want[0], dc, ds, dq, st, prologue, res)
        gb, pb = cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {"c": rel_err(got[0], want[0]), "c_infer": rel_err(infer, infer_want),
                "ssum": rel_err(got[1], want[1]), "ssq": rel_err(got[2], want[2])}
        for name, g, p in zip(("dx", "dw", "dscale", "dshift", "dres"), gb, pb):
            check((g is None) == (p is None), ("conv_bn_bwd outputs", name))
            if g is not None:
                errs[name] = rel_err(g, p)
        for name, e in errs.items():
            tol = CONV_TOL["elementwise" if name in ("c", "c_infer", "dx", "dres") else "sums"]
            check(math.isfinite(e) and e <= tol, ("conv kernels", name, B, K, H, W, N, kernel,
                                                  stride, e))
        fwd_abs = max(float((got[0] - want[0]).abs().max()), float((infer - infer_want).abs().max()))
        bwd_abs = float((gb[0] - pb[0]).abs().max())
        worst["conv_bn"] = max(worst.get("conv_bn", 0.0), fwd_abs)
        worst["conv_bn_bwd"] = max(worst.get("conv_bn_bwd", 0.0), bwd_abs)
        rec = {"phase": "kernel", "name": "conv_bn", "shape": [B, K, H, W, N, kernel, stride],
               "prologue": prologue, "res": res, "rel_err": errs,
               "max_abs_err_c": fwd_abs, "max_abs_err_dx": bwd_abs}
        if prefix is not None:
            flops = cb.flops(x.shape, w.shape, st)
            c = got[0]
            fwd_ms = device_ms(lambda: cb.conv_block(x, w, scale, shift, r, st, prologue),
                               key=KERNELS["conv_bn"][2])
            infer_ms = device_ms(lambda: cb.conv_block_infer(x, w, scale, shift, st, prologue),
                                 key=KERNELS["conv_bn"][2])
            fwd_plain = device_ms(lambda: cb.conv_block_plain(x, w, scale, shift, r, st,
                                                              prologue))
            xn = cb._prologue(x, scale, shift, prologue)
            pad = (kernel - 1) // 2
            fwd_lib = device_ms(lambda: F.conv2d(xn, w, stride=st, padding=pad))
            xr = read_of_x(x, kernel, stride)
            fb, fby, ff32 = product_bound(flops, conv_bytes(xr, w, scale, shift, r, c) + 8.0 * N,
                                          peaks)
            if stride > 1:
                # the same product through the stride-1 kernel on the sampled
                # input made contiguous: its 16-byte copies move only the
                # elements the strided conv reads, the least any staging of x
                # could move
                xs = x[:, :, ::stride, ::stride].contiguous()
                rec["presampled_ms"] = device_ms(
                    lambda: cb.conv_block(xs, w, scale, shift, r, (1, 1), prologue),
                    key=KERNELS["conv_bn"][2])
            per_kernel = device_events(lambda: cb.conv_block_bwd(*args))
            bwd_ms = sum(v for k, v in per_kernel.items() if KERNELS["conv_bn_bwd"][2] in k)
            check(bwd_ms > 0, ("the profiler shows no conv_bn_bwd kernel", prefix))
            # the backward's kernels one by one, and the whole call between
            # two CUDA events (with its allocations, as bwd_with_allocs_ms)
            rec["bwd_kernels_ms"] = {part: sum(v for k, v in per_kernel.items()
                                               if "conv_bn_bwd_" + part in k)
                                     for part in BWD_PARTS}
            bwd_event_ms = event_ms(lambda: cb.conv_block_bwd(*args))
            bwd_call_ms = device_ms(lambda: cb.conv_block_bwd(*args))
            bwd_plain = device_ms(lambda: cb.conv_block_bwd_plain(*args))
            dce = dc + ds.reshape(1, -1, 1, 1) + 2.0 * c * dq.reshape(1, -1, 1, 1)
            bwd_lib = device_ms(lambda: torch.ops.aten.convolution_backward(
                dce, xn, w, None, list(st), [pad, pad], [1, 1], False, [0, 0], 1,
                [True, True, False]))
            bb, bby, bf32 = product_bound(
                2.0 * flops, conv_bytes(xr, w, scale, shift, c, dc, ds, dq, *gb), peaks)
            rec.update(kernel_ms=fwd_ms, infer_ms=infer_ms, plain_ms=fwd_plain,
                       library_ms=fwd_lib, bound_ms=fb, bound_by=fby, f32_bound_ms=ff32,
                       bwd_kernel_ms=bwd_ms, bwd_with_allocs_ms=bwd_call_ms,
                       bwd_event_ms=bwd_event_ms,
                       bwd_plain_ms=bwd_plain, bwd_library_ms=bwd_lib, bwd_bound_ms=bb,
                       bwd_bound_by=bby, bwd_f32_bound_ms=bf32)
            label = "x (%d,%d,%d,%d) w (%d,%d,%d,%d) stride %d%s%s" % (
                B, K, H, W, N, K, kernel, kernel, stride, " prologue" if prologue else "",
                " + res" if res else "")
            fwd = dict(ms=fwd_ms, infer_ms=infer_ms, plain_ms=fwd_plain, bound_ms=fb,
                       bound_by=fby, f32_bound_ms=ff32, library_ms=fwd_lib)
            bwd = dict(ms=bwd_ms, with_allocs_ms=bwd_call_ms, event_ms=bwd_event_ms,
                       plain_ms=bwd_plain, bound_ms=bb, bound_by=bby, f32_bound_ms=bf32,
                       library_ms=bwd_lib)
            if not prefix:
                entries["conv_bn"] = entry(
                    "conv_bn", library="F.conv2d of the normalised input (the product alone)",
                    shape=label, **fwd)
                entries["conv_bn_bwd"] = entry(
                    "conv_bn_bwd", library="aten.convolution_backward (dgrad + wgrad)",
                    shape=label, **bwd)
            else:
                entries["conv_bn"].update({prefix + k: v for k, v in fwd.items()})
                entries["conv_bn_bwd"].update({prefix + k: v for k, v in bwd.items()})
        log(rec)
    check_conv_f64(randn, cb)


def check_conv_f64(randn, cb):
    """Stage 4's 3x3 (512 -> 512 at 7 x 7: N·taps = 4608-long dx sums) and
    stage 1's (64 -> 64 at 56 x 56: B·H'W' = 100 352-long dw sums, the
    longest), at batch 32, with and without a prologue: the forward and
    backward kernels and their float32 plain versions (cuDNN), each against
    the same function in float64 on the same inputs (with the float32
    prologue's ReLU decisions, conv_f64_pinned). Each kernel output must lie
    within the CONV_TOL of the float64 result."""
    B = RESNET_TRAIN["batch"]
    for K, H, N in ((512, 7, 512), (64, 56, 64)):
        for prologue in (False, True):
            check_conv_f64_case(randn, cb, B, K, H, H, N, prologue)


def check_conv_f64_case(randn, cb, B, K, H, W, N, prologue):
    x, w, scale, shift, _, _ = conv_case(randn, B, K, H, W, N, 3, 1, prologue, False)
    st = (1, 1)
    dc, ds, dq = randn(B, N, H, W), randn(N, scale=0.01), randn(N, scale=1e-3)
    c = cb.conv_block(x, w, scale, shift, None, st, prologue)[0]
    args = (x, w, scale, shift, c, dc, ds, dq, st, prologue, False)
    outs = {"kernel": (c, *cb.conv_block_bwd(*args)),
            "plain_f32": (cb.conv_block_plain(x, w, scale, shift, None, st, prologue)[0],
                          *cb.conv_block_bwd_plain(*args))}
    exact, kinks = conv_f64_pinned(cb, *args[:8], st, prologue)
    names = ("c", "dx", "dw", "dscale", "dshift")
    rec = {"phase": "kernel", "name": "conv_bn_f64", "shape": [B, K, H, W, N, 3, 1],
           "prologue": prologue, "relu_kinks_pinned": kinks}
    for who, got in outs.items():
        rec[who] = {n: rel_err(g.double(), e) for n, g, e in zip(names, got, exact)
                    if e is not None}
    log(rec)
    for n, e in rec["kernel"].items():
        tol = CONV_TOL["elementwise" if n in ("c", "dx") else "sums"]
        check(math.isfinite(e) and e <= tol, ("conv kernels against float64", n, B, K, H, N,
                                              prologue, e))


def conv_f64_pinned(cb, x, w, scale, shift, c, dc, ds, dq, st, relu):
    """The 3x3 conv's forward c and backward (dx, dw, dscale, dshift) in
    float64 on these inputs, but for the ReLU's decisions, which are the
    float32 prologue's as the kernels and the plain version take them: a
    pre-activation within float32 rounding of 0 may fall on the other side
    of the kink in float64 (at stage 1's 3x3, 6.4 million of them, about
    one a run), and its dx then differs by a whole term. So the comparison
    holds the products' long sums alone. Returns the outputs and the count
    of decisions that float64 would have taken otherwise."""
    f, b = torch.float64, (1, -1, 1, 1)
    x64, w64 = x.to(f), w.to(f)
    if scale is None:
        xn, keep, kinks = x64, None, 0
    else:
        pre = x64 * scale.to(f).reshape(b) + shift.to(f).reshape(b)
        keep = (cb._prologue(x, scale, shift, False) > 0).to(f) if relu else None
        kinks = int(((pre > 0).to(f) != keep).sum()) if relu else 0
        xn = pre * keep if relu else pre
    out = F.conv2d(xn, w64, padding=1)
    dce = dc.to(f) + ds.to(f).reshape(b) + 2.0 * c.to(f) * dq.to(f).reshape(b)
    dxn = torch.nn.grad.conv2d_input(x.shape, w64, dce, stride=st, padding=1)
    dw = torch.nn.grad.conv2d_weight(xn, w.shape, dce, stride=st, padding=1)
    if scale is None:
        return (out, dxn, dw, None, None), kinks
    if relu:
        dxn = dxn * keep
    return (out, dxn * scale.to(f).reshape(b), dw, (dxn * x64).sum(dim=(0, 2, 3)),
            dxn.sum(dim=(0, 2, 3))), kinks


def normalise_kernel(pt, shape):
    """The rtc image-normalisation kernel for NCHW ``shape``, with a
    grid-stride launch that fills the card."""
    B, C, H, W = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pt.rtc.Rtc("rtc_normalise", RTC_NORMALISE % dict(hw=H * W, c=C, n=B * C * H * W),
                      kernel_name="rtc_normalise", grid=(8 * sms,), block=(256,))


def check_deploy_kernels(randn, peaks, entries, worst):
    """Phase 2, the deploy path's kernels: matmul_with_stats against its
    plain version at ResNet-50's 1x1 convolutions and a ragged shape, and
    three kernels compiled at run time through rtc against their torch
    expressions."""
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch.ops import matmul_stats as ms

    for M, K, N, prefix in MATMUL_STATS_SHAPES:
        a, b = randn(M, K), randn(K, N, scale=1.0 / math.sqrt(K))
        got, again = ms.matmul_with_stats(a, b), ms.matmul_with_stats(a, b)
        want = ms.matmul_with_stats_plain(a, b)
        c64 = a.double() @ b.double()
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              ("matmul_stats: two runs differ", M, K, N))
        names = ("c", "col_sum", "col_sumsq")
        errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
        # and against float64 on the same inputs
        errs_f64 = {n: rel_err(g.double(), w) for n, g, w in
                    zip(names, got, (c64, c64.sum(dim=0), (c64 * c64).sum(dim=0)))}
        del c64
        for n in names:
            tol = CONV_TOL["elementwise" if n == "c" else "sums"]
            check(math.isfinite(errs[n]) and errs[n] <= tol and errs_f64[n] <= tol,
                  ("matmul_stats", n, M, K, N, errs[n], errs_f64[n]))
        abs_err = float((got[0] - want[0]).abs().max())
        worst["matmul_stats"] = max(worst.get("matmul_stats", 0.0), abs_err)
        sched = ms._schedule(M, K, N)
        rec = {"phase": "kernel", "name": "matmul_stats", "shape": [M, K, N], "rel_err": errs,
               "rel_err_f64": errs_f64, "max_abs_err": abs_err, "bitwise_repeatable": True,
               "schedule": sched._asdict()}
        if prefix is not None:
            ms_ = device_ms(lambda: ms.matmul_with_stats(a, b), key=KERNELS["matmul_stats"][2])
            ev_ms = event_ms(lambda: ms.matmul_with_stats(a, b))
            plain_ms = device_ms(lambda: ms.matmul_with_stats_plain(a, b))

            def library():
                c = torch.mm(a, b)
                return c, c.sum(dim=0), (c * c).sum(dim=0)

            lib_ms = device_ms(library)
            mm_ms = device_ms(lambda: torch.mm(a, b))
            b_ms, b_by, f32_ms = product_bound(2.0 * M * K * N + 3.0 * M * N,
                                               4.0 * (M * K + K * N + M * N + 2 * N), peaks)
            times = dict(ms=ms_, event_ms=ev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, f32_bound_ms=f32_ms, library_ms=lib_ms,
                         mm_alone_ms=mm_ms, f32_work_tflops=2.0 * M * K * N / ms_ / 1e9,
                         schedule=sched.layout)
            rec.update(times, kernel_ms=ms_)
            if not prefix:
                entries["matmul_stats"] = entry(
                    "matmul_stats", library="torch.mm + c.sum(0) + (c*c).sum(0)",
                    shape="a (%d,%d) b (%d,%d)" % (M, K, K, N), **times)
            else:
                entries["matmul_stats"].update({prefix + k: v for k, v in times.items()
                                                if k != "bound_by"})
        log(rec)

    # ---- rtc: (a) per-channel normalisation at the deploy batch, (b) a + 3b,
    # (c) one input and two outputs; each synchronised and checked after its push
    gpu = pt.gpu(0)

    def nd(t):
        return pt.nd.NDArray(t, gpu)

    shape = (DEPLOY["batch"],) + image_shape()
    x = torch.rand(*shape, device="cuda") * 255.0
    mean = torch.tensor(DEPLOY["mean"], device="cuda")
    std = torch.tensor(DEPLOY["std"], device="cuda")
    k = normalise_kernel(pt, shape)
    t0 = time.perf_counter()
    (y,) = k.push([nd(x), nd(mean), nd(std)], out_shapes=[shape])
    torch.cuda.synchronize()
    first_push_s = time.perf_counter() - t0
    compiled = k.compiles  # 0 when build/torch_kernels/rtc/ already held the image
    check(compiled <= 1 and k.launches == 1, ("rtc compiles/launches", compiled, k.launches))

    def plain():
        return (x - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)

    want = plain()
    err = float((y._tensor() - want).abs().max())
    # the kernel does the same two IEEE operations an element: equal up to rounding
    check(math.isfinite(err) and err <= 1e-6 * float(want.abs().max()), ("rtc_normalise", err))
    (y2,) = k.push([nd(x), nd(mean), nd(std)], out_shapes=[shape], grid_dims=(1024, 1, 1),
                   block_dims=(128,))
    torch.cuda.synchronize()
    check(k.compiles == compiled and torch.equal(y2._tensor(), y._tensor()),
          "rtc: a second geometry recompiled or changed the result")
    args = [nd(x), nd(mean), nd(std)]
    host_us = []
    for _ in range(50):
        t0 = time.perf_counter()
        k.push(args, out_shapes=[shape])
        host_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    ms_ = device_ms(lambda: k.push(args, out_shapes=[shape]), key="rtc_normalise")
    plain_ms = device_ms(plain)
    n = x.numel()
    b_ms, b_by = bound(2.0 * n, 4.0 * (2 * n + 2 * len(DEPLOY["mean"])), peaks)
    worst["rtc"] = err
    entries["rtc"] = entry("rtc", ms=ms_, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=None, library="no single PyTorch call computes it",
                           shape="rtc_normalise x %s" % (shape,), first_push_s=first_push_s,
                           first_push_compiled=bool(compiled),
                           push_host_us_p50=float(np.median(host_us)))
    log({"phase": "kernel", "name": "rtc_normalise", "shape": list(shape), "max_abs_err": err,
         "bitwise": bool(torch.equal(y._tensor(), want)), "kernel_ms": ms_, "plain_ms": plain_ms,
         "bound_ms": b_ms, "bound_by": b_by, "first_push_s": first_push_s,
         "first_push_compiled": bool(compiled),
         "push_host_us_p50": float(np.median(host_us)),
         "push_host_us_p80": float(np.percentile(host_us, 80))})

    a, b = randn(1000, 333), randn(1000, 333)
    n = a.numel()
    fma = pt.rtc.Rtc("rtc_fma", RTC_FMA % dict(n=n), kernel_name="rtc_fma")
    (o,) = fma.push([nd(a), nd(b)], out_shapes=[a.shape], grid_dims=(-(-n // 256),),
                    block_dims=(256,))
    torch.cuda.synchronize()
    want = a + b * 3.0
    err_fma = float((o._tensor() - want).abs().max())
    # the compiler may fuse the multiply into the add: one rounding fewer
    check(err_fma <= 1e-6 * float(want.abs().max()), ("rtc_fma", err_fma))
    split = pt.rtc.Rtc("rtc_split", RTC_SPLIT % dict(n=n), kernel_name="rtc_split",
                       grid=(-(-n // 128),), block=(128,))
    o1, o2 = split.push([nd(a)], out_shapes=[a.shape, (n,)])
    torch.cuda.synchronize()
    check(o2.shape == (n,) and o2.dtype == np.float32, ("rtc_split output", o2.shape, o2.dtype))
    err_split = max(float((o1._tensor() - (a + 1.0)).abs().max()),
                    float((o2._tensor() - (a - 1.0).reshape(-1)).abs().max()))
    check(err_split == 0.0, ("rtc_split", err_split))
    worst["rtc"] = max(worst["rtc"], err_fma, err_split)
    for name, e in (("rtc_fma", err_fma), ("rtc_split", err_split)):
        log({"phase": "kernel", "name": name, "shape": list(a.shape), "max_abs_err": e})


def check_launch_floor(rows, D):
    """The card's floor under a LayerNorm launch: the profiler's device time
    (and the CUDA-event time) of an empty kernel on the decode LayerNorm's
    grid, and of a one-block kernel that copies its 16 KB (``rows`` x
    ``D`` f32), each compiled by rtc and launched on the current stream, as
    the LayerNorm kernel is."""
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch.ops import norm_residual as nr

    gpu = pt.gpu(0)
    n = rows * D
    x = pt.nd.NDArray(torch.randn(n, device="cuda"), gpu)
    blocks = -(-rows // (nr.WARPS_PER_BLOCK * nr._rows_per_warp(rows, D)))
    empty = pt.rtc.Rtc("rtc_empty", RTC_EMPTY, kernel_name="rtc_empty", grid=(blocks,),
                       block=(32 * nr.WARPS_PER_BLOCK,))
    copy = pt.rtc.Rtc("rtc_copy", RTC_COPY % dict(n4=n // 4), kernel_name="rtc_copy", grid=(1,),
                      block=(32 * nr.WARPS_PER_BLOCK,))
    empty.push([], out_shapes=[(1,)])
    (y,) = copy.push([x], out_shapes=[(n,)])
    torch.cuda.synchronize()
    check(torch.equal(y._tensor(), x._tensor()), "rtc_copy")
    floor = {"empty_ms": device_ms(lambda: empty.push([], out_shapes=[(1,)]), key="rtc_empty"),
             "copy_ms": device_ms(lambda: copy.push([x], out_shapes=[(n,)]), key="rtc_copy"),
             "empty_event_ms": event_ms(lambda: empty.push([], out_shapes=[(1,)])),
             "copy_event_ms": event_ms(lambda: copy.push([x], out_shapes=[(n,)])),
             "empty_grid": blocks, "copy_bytes": 4 * n}
    log({"phase": "kernel", "name": "launch_floor_ms", **floor})
    return floor


def check_mma_rate(randn, peaks):
    """The rate mma.sync reaches on this card with nothing else to do: one
    TF32 product alone, and the kernels' 3xTF32 step (its rate counted in
    f32 work, a third of the products'), against the published TF32 peak.
    The ceiling for the product kernels' mma.sync core."""
    import mxnet_tpu_torch as pt

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid, block = sms * MMA_RATE["blocks_per_sm"], MMA_RATE["threads"]
    x = pt.nd.NDArray(randn(64, scale=1e-3), pt.gpu(0))
    rec = {"phase": "kernel", "name": "mma_sync_rate", **MMA_RATE, "sms": sms}
    for name, (per, step) in MMA_RATE_STEPS.items():
        probe = pt.rtc.Rtc("rtc_mma_rate_" + name, RTC_MMA_RATE % dict(step=step, **MMA_RATE),
                           kernel_name="rtc_mma_rate", grid=(grid,), block=(block,))
        (out,) = probe.push([x], out_shapes=[(grid * block,)])
        check(bool(torch.isfinite(out._tensor()).all()), ("mma_sync_rate output", name))
        ms = device_ms(lambda: probe.push([x], out_shapes=[(grid * block,)]), iters=10,
                       key="rtc_mma_rate")
        mmas = grid * block / 32 * MMA_RATE["iters"] * MMA_RATE["chains"] * per
        tflops = mmas * 2 * 16 * 8 * 8 / per / (ms * 1e-3) / 1e12
        rec[name] = {"ms": ms, "tflops": tflops,
                     "share_of_tf32_peak": tflops * per / (peaks["tf32"] / 1e12)}
    log(rec)


def random_params(seed=SEED):
    """Random weights from the seed, named and shaped by the training symbol."""
    from mxnet_tpu_torch.models import transformer

    net = transformer.get_symbol(seq_len=SERVE["pos_len"], **MODEL)
    arg_shapes = net.infer_shape(data=(1, SERVE["pos_len"]), softmax_label=(1, SERVE["pos_len"]))[0]
    rs = np.random.RandomState(seed)
    return {n: (rs.standard_normal(s) * 0.05).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def profile_window(fn, per=1, setup=None, sync=None):
    """Host wall time of ``fn`` (ending in ``sync``, by default a
    synchronize of the device) against the card's busy time in it (the
    profiler's device events), and the device time of the port's kernels
    against the rest, in all and by kernel; per call, ``fn`` running
    ``per``. ``copy_to_host_ms``: the busy time's copies to the host
    (``Memcpy DtoH``). ``port_kernel_launches``: the port's kernels the
    trace shows by name, in the whole window; ``wrapper_launches``: the
    wrappers' counts in it. ``fn`` runs in two windows, each after
    ``setup``, ``PROFILER_GAP_S`` apart, so that at most one of them can meet
    the profiler's gap; the one with more device events is kept."""
    from torch.profiler import ProfilerActivity

    runs = []
    for attempt in range(2):
        if attempt:
            time.sleep(PROFILER_GAP_S)
        if setup is not None:
            setup()
        runs.append(profiler_window(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                    sync=sync))
    totals = [sum(n for n, _ in events.values()) for events, _, _ in runs]
    PROFILER_TALLY["breakdown_windows"] += 2
    PROFILER_TALLY["breakdown_windows_short"] += totals[0] != totals[1]
    events, wall_ms, wrapped = runs[1] if totals[1] >= totals[0] else runs[0]
    busy, port, copy, n_kernels, top = 0.0, 0.0, 0.0, 0, {}
    by_kernel, launched = dict.fromkeys(KERNELS, 0.0), dict.fromkeys(KERNELS, 0)
    for key, (count, us) in events.items():
        busy += us
        copy += us if "DtoH" in key else 0.0
        n_kernels += count
        owner = [name for name, (_, _, sym) in KERNELS.items() if sym in key]
        if owner:
            port += us
            by_kernel[owner[0]] += us
            launched[owner[0]] += count
        top[key[:60]] = top.get(key[:60], 0.0) + us
    return {"wall_ms": wall_ms / per, "device_busy_ms": busy / 1e3 / per,
            "device_idle_share": 1.0 - busy / 1e3 / wall_ms if wall_ms else None,
            "copy_to_host_ms": copy / 1e3 / per, "port_kernels_ms": port / 1e3 / per,
            "port_kernels_share_of_busy": port / busy if busy else None,
            "port_kernel_ms": {k: v / 1e3 / per for k, v in by_kernel.items() if v},
            "port_kernel_launches": {k: v for k, v in launched.items() if v},
            "wrapper_launches": wrapped, "device_events_per_call": n_kernels / per,
            "device_events_per_window": totals,
            "top_device_ms": {k: v / 1e3 / per for k, v in
                              sorted(top.items(), key=lambda kv: -kv[1])[:8]}}


def breakdown(dec, prompt, steps=8):
    """Where one prefill and ``steps`` greedy decode steps spend their time."""
    dec.reset()
    nxt = np.argmax(dec.prefill(prompt), axis=-1)

    def prefill():
        dec.reset()
        dec.prefill(prompt)

    def decode():
        n = nxt
        for _ in range(steps):
            n = dec.greedy_step(n)

    def seed():
        dec.reset()
        dec.prefill(prompt)

    return {"prefill": profile_window(prefill), "decode": profile_window(decode, steps, seed)}


def teacher_forced_logits(dec, prompt, tokens):
    dec.reset()
    out = [dec.prefill(prompt)]
    for t in range(tokens.shape[1] - 1):
        out.append(dec.decode_step(tokens[:, t]))
    return np.stack(out, axis=1)  # (B, n, vocab)


def run_slice(pt):
    """Phase 3: full-width greedy decode on the card, launch counts, and the
    teacher-forced comparison with the port's CPU path."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import KVCacheDecoder

    params = random_params()
    rs = np.random.RandomState(SEED + 1)
    prompt = rs.randint(1, MODEL["vocab_size"], (SERVE["batch"], PROMPT_LEN))
    dec = KVCacheDecoder(params, ctx=pt.gpu(0), **MODEL, **SERVE)
    t0 = time.perf_counter()
    dec.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = dec.greedy(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    schedules = ops.schedule_counts()

    L, steps = MODEL["num_layers"], NEW_TOKENS - 1
    expected = {"flash_attention": L, "flash_attention_dq": 0, "flash_attention_dkv": 0,
                "norm_residual": (2 * L + 1) * (1 + steps), "norm_residual_bwd": 0,
                "matmul_bias_act": L * (1 + steps)}
    check(launches == with_zeros(expected), ("launch counts", launches, expected))
    # the prefill's ffn1 (M = batch · prefill_len) on the tiles, each decode
    # step's (M = batch) on the small-M schedule
    expected_schedules = {"matmul_bias_act.small_m": L * steps, "matmul_bias_act.tiles": L}
    check(schedules == expected_schedules, ("schedule counts", schedules, expected_schedules))
    check(tokens.shape == (SERVE["batch"], NEW_TOKENS), ("token shape", tokens.shape))
    check(((tokens >= 0) & (tokens < MODEL["vocab_size"])).all(), "token ids out of range")
    greedy_s = [greedy_s]
    for _ in range(2):  # the spread of the host clock; the tokens must repeat exactly
        t0 = time.perf_counter()
        again = dec.greedy(prompt, NEW_TOKENS)
        greedy_s.append(time.perf_counter() - t0)
        check((again == tokens).all(), "greedy decode is not deterministic")
    # host-clock latencies: 20 prefills, and each of the 63 greedy steps of
    # one sequence (a step ends with its (B,) token ids on the host)
    prefill_ms = []
    for _ in range(20):
        dec.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt = np.argmax(dec.prefill(prompt), axis=-1)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        nxt = dec.greedy_step(nxt)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()  # a greedy call after the loops: does the host clock drift?
    dec.greedy(prompt, NEW_TOKENS)
    greedy_after_s = time.perf_counter() - t0

    gpu_logits = teacher_forced_logits(dec, prompt, tokens)
    check(np.isfinite(gpu_logits).all(), "non-finite card logits")
    # the card's greedy tokens are the argmax of its own teacher-forced logits
    check((np.argmax(gpu_logits, axis=-1) == tokens).all(), "greedy != teacher-forced argmax")
    cpu_dec = KVCacheDecoder(params, ctx=pt.cpu(), **MODEL, **SERVE)
    t0 = time.perf_counter()
    cpu_logits = teacher_forced_logits(cpu_dec, prompt, tokens)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu_logits - cpu_logits).max())
    # f32 on both sides, TF32 off; sums run in other orders on the card
    check(np.allclose(gpu_logits, cpu_logits, atol=1e-3, rtol=1e-3), ("card vs CPU logits", err))
    agree = float((np.argmax(cpu_logits, axis=-1) == tokens).mean())
    log({"phase": "breakdown", **breakdown(dec, prompt)})
    step_p50 = float(np.percentile(step_ms, 50))
    log({"phase": "slice", "model": MODEL, "serve": SERVE, "prompt_len": PROMPT_LEN,
         "new_tokens": NEW_TOKENS, "launches": launches, "expected_launches": expected,
         "schedule_launches": schedules,
         "warmup_s": warmup_s, "greedy_s": greedy_s, "greedy_after_loops_s": greedy_after_s,
         "prefill_ms_p50": float(np.median(prefill_ms)), "prefill_ms_max": max(prefill_ms),
         "prefill_samples": len(prefill_ms),
         "decode_step_ms_p50": step_p50, "decode_step_ms_p80": float(np.percentile(step_ms, 80)),
         "decode_step_samples": len(step_ms),
         "tokens_per_s": SERVE["batch"] * NEW_TOKENS / float(np.median(greedy_s)),
         "decode_tokens_per_s": SERVE["batch"] * 1e3 / step_p50,
         "card_vs_cpu_max_abs_err": err, "cpu_argmax_token_agreement": agree,
         "cpu_reference_s": cpu_s})
    return launches


# ------------------------------------------------------------ paged serving
def paged_prompts():
    """Eight prompts of PROMPT_LEN tokens sharing their first PREFIX_LEN."""
    rs = np.random.RandomState(SEED + 2)
    prefix = rs.randint(1, MODEL["vocab_size"], PREFIX_LEN)
    return [np.concatenate([prefix, rs.randint(1, MODEL["vocab_size"], PROMPT_LEN - PREFIX_LEN)])
            for _ in range(PAGED["lanes"])]


def step_launches(steps, layers=None, schedule="small_m"):
    """A decode step's (or a chunk's) launches: 2L+1 LayerNorm forwards and
    L ffn1 products (one rectangular dispatch of a few rows is one step)."""
    layers = layers or MODEL["num_layers"]
    return ({"norm_residual": (2 * layers + 1) * steps, "matmul_bias_act": layers * steps},
            {"matmul_bias_act." + schedule: layers * steps})


def add_launches(*parts):
    counts, schedules = {}, {}
    for c, s in parts:
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        for k, v in s.items():
            schedules[k] = schedules.get(k, 0) + v
    return counts, schedules


def prefill_launches(n, layers=None, schedule="small_m"):
    """n prefills: L flash forwards, 2L+1 LayerNorms, L ffn1 products each."""
    layers = layers or MODEL["num_layers"]
    c, s = step_launches(n, layers, schedule)
    c["flash_attention"] = layers * n
    return c, s


def check_launches(what, expected):
    """The launches since the last reset against ``expected`` (counts,
    schedules); returns the counts."""
    from mxnet_tpu_torch import ops

    counts, schedules = expected
    got, got_s = ops.launch_counts(), ops.schedule_counts()
    want_s = {k: schedules.get(k, 0) for k in got_s}
    check(got == with_zeros(counts), (what, "launch counts", got, counts))
    check(got_s == want_s, (what, "schedule counts", got_s, want_s))
    return got


def binds(*decoders):
    return sum(d._pf_cache.binds + d._dec_cache.binds for d in decoders)


def latency_stats(ms, tokens_per_call, rows):
    """Per-token latency (median, p80) from host-clock ms per call of
    ``tokens_per_call`` tokens a row, and tokens/s over ``rows`` rows."""
    per = np.asarray(ms) / tokens_per_call
    return {"per_token_ms_p50": float(np.median(per)),
            "per_token_ms_p80": float(np.percentile(per, 80)),
            "call_ms_p50": float(np.median(ms)), "samples": len(ms),
            "tokens_per_s": rows * tokens_per_call * 1e3 / float(np.median(ms))}


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def profiled(what, fn, per, expected, setup):
    """``profile_window`` of ``fn`` (each window after ``setup``), whose
    launches of the port's kernels are held three ways: the wrappers' counts
    (a graph's replays by its capture's), the kernels the trace shows by
    name, and ``expected``."""
    prof = profile_window(fn, per, setup)
    counted = prof["wrapper_launches"]
    want = {k: v for k, v in expected.items() if v}
    check(counted == want and prof["port_kernel_launches"] == want,
          (what, "launches counted / traced / expected", counted,
           prof["port_kernel_launches"], want))
    return prof


def megastep_card_time(ms_prog, iters=10):
    """One megastep's card time between CUDA events around ``iters``
    back-to-back replays of its graph on its last inputs (a replay is one
    launch, milliseconds of card work: the host is not in the window)."""
    ms_prog._graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        ms_prog._graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_megastep(pt, params, smi):
    """Phase 3b: the lockstep decoder's K-step megastep as one CUDA graph:
    greedy tokens at K = MEGASTEP_K equal the single-step tokens, the
    launches are the path's, host latency a token at K = 1 and K, card time
    per megastep."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import KVCacheDecoder

    K, L, B = MEGASTEP_K, MODEL["num_layers"], SERVE["batch"]
    rs = np.random.RandomState(SEED + 1)
    prompt = rs.randint(1, MODEL["vocab_size"], (B, PROMPT_LEN))
    dec = KVCacheDecoder(params, ctx=pt.gpu(0), **MODEL, **SERVE)
    t0 = time.perf_counter()
    dec.warmup()
    dec.greedy(prompt, 1 + K, k=K)  # builds and captures the K-step graph
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    bound = binds(dec)
    # one prefill and 63 steps either way: at K, 7 megasteps and a 7-step tail
    expected = add_launches(prefill_launches(1, schedule="tiles"),
                            step_launches(NEW_TOKENS - 1))
    ops.reset_launch_counts()
    single = dec.greedy(prompt, NEW_TOKENS, k=1)
    torch.cuda.synchronize()
    check_launches("megastep phase, K=1", expected)
    ops.reset_launch_counts()
    mega = dec.greedy(prompt, NEW_TOKENS, k=K)
    torch.cuda.synchronize()
    launches = check_launches("megastep phase, K=%d" % K, expected)
    check((mega == single).all(), "graphed megastep tokens != single-step tokens")
    ms_prog = dec._megasteps[(K, ("greedy", 1.0, 0))]
    per_replay = step_launches(K)
    check(ms_prog.replay_launches == (with_zeros(per_replay[0]), {
        k: per_replay[1].get(k, 0) for k in ops.SCHEDULE_COUNTERS}),
        ("launches a replay", ms_prog.replay_launches))
    # host clock: each greedy step / megastep of three sequences
    step_ms, mega_ms = [], []
    for _ in range(3):
        nxt = np.argmax(dec.prefill(prompt), axis=-1)
        for _ in range(NEW_TOKENS - 1):
            nxt, t = timed(lambda: dec.greedy_step(nxt))
            step_ms.append(t)
        nxt = np.argmax(dec.prefill(prompt), axis=-1)
        for _ in range((NEW_TOKENS - 1) // K):
            ids, t = timed(lambda: dec.decode_megastep(nxt, k=K))
            nxt = ids[:, -1]
            mega_ms.append(t)
    check(binds(dec) == bound, "the megastep phase bound an executable after warmup")
    nxt = np.argmax(dec.prefill(prompt), axis=-1)

    def megasteps():
        n = nxt
        for _ in range(4):
            n = dec.decode_megastep(n, k=K)[:, -1]

    # the trace shows each replay's kernels: 4 replays launch 4 x the capture's
    def seed():
        dec.prefill(prompt)

    prof_mega = profiled("megastep window", megasteps, 4,
                         {k: 4 * v for k, v in ms_prog.replay_launches[0].items()}, seed)

    def steps():
        n = nxt
        for _ in range(4 * K):
            n = dec.greedy_step(n)

    prof_steps = profiled("K=1 window", steps, 4 * K, step_launches(4 * K)[0], seed)
    log({"phase": "megastep", "k": K, "nvidia_smi": smi, "warmup_and_capture_s": warm_s,
         "launches": launches, "launches_per_replay": ms_prog.replay_launches[0],
         "traced_launches_4_replays": prof_mega["port_kernel_launches"],
         "tokens_equal_single_step": True,
         "k1": latency_stats(step_ms, 1, B), "kK": latency_stats(mega_ms, K, B),
         "card_ms_per_megastep": prof_mega["device_busy_ms"],
         "card_ms_per_megastep_events": megastep_card_time(ms_prog),
         "card_ms_per_step_k1": prof_steps["device_busy_ms"],
         "device_idle_share_kK": prof_mega["device_idle_share"],
         "device_idle_share_k1": prof_steps["device_idle_share"],
         "profile_kK": prof_mega, "profile_k1": prof_steps})
    return launches


def paged_teacher_forced(dec, prompts, tokens, steps):
    """Admit logits, then ``steps`` steps fed the given tokens: (lanes,
    1 + steps, vocab)."""
    sids, rows = [], []
    for p in prompts:
        sid, lg = dec.admit(p)
        sids.append(sid)
        rows.append([lg])
    for t in range(steps):
        out = dec.step({sid: int(tokens[i][t]) for i, sid in enumerate(sids)})
        for i, sid in enumerate(sids):
            rows[i].append(out[sid])
    for sid in sids:
        dec.retire(sid)
    return np.asarray(rows)


def prefix_teacher_forced(dec, prompts, tokens):
    """A prefix-cache decoder's logits: the first prompt's cold chunked admit,
    the second's admit on the prefix the first cached, and a verify chunk of
    ``tokens`` after it: (2 + len(tokens), vocab)."""
    s0, cold = dec.admit(prompts[0])
    s1, cached = dec.admit(prompts[1])
    rows = dec.verify_chunk(s1, tokens)
    dec.retire(s0)
    dec.retire(s1)
    return np.concatenate([cold[None], cached[None], rows])


def time_paged(dec, prompts, k, rounds=2):
    """Host ms of each step (k = 1) or megastep of the eight lanes."""
    out = []
    for _ in range(rounds):
        sids = {}
        for p in prompts:
            sid, lg = dec.admit(p)
            sids[sid] = int(np.argmax(lg))
        for _ in range((NEW_TOKENS - 1) // k):
            if k == 1:
                lg, t = timed(lambda: dec.step(sids))
                sids = {s: int(np.argmax(v)) for s, v in lg.items()}
            else:
                ids, t = timed(lambda: dec.step_megastep(sids, k=k))
                sids = {s: int(v[-1]) for s, v in ids.items()}
            out.append(t)
        for sid in list(sids):
            dec.retire(sid)
    return out


def count_calls(obj, name, tally, key):
    """Count the calls of ``obj.name`` in ``tally[key]``."""
    fn = getattr(obj, name)
    tally[key] = 0

    def wrapped(*a, **kw):
        tally[key] += 1
        return fn(*a, **kw)

    setattr(obj, name, wrapped)


def run_paged(pt, params, smi):
    """Phase 3c: the paged decoder on the card (eight lanes over one pool of
    2048 slots): greedy tokens through ``step`` and through the graphed
    ``step_megastep`` are equal; teacher-forced logits agree with the CPU's;
    the prefix cache's cached admits give the cold admit's logits bitwise;
    speculative greedy equals the target's plain greedy; no bind after
    warmup; the launches are the path's."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.serving import PagedKVDecoder, SpeculativeDecoder

    K, L = MEGASTEP_K, MODEL["num_layers"]
    prompts = paged_prompts()
    n = len(prompts)
    pd = PagedKVDecoder(params, ctx=pt.gpu(0), **MODEL, **PAGED)
    t0 = time.perf_counter()
    pd.greedy(prompts[:1], 1 + K, k=K)  # binds, builds and captures
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    bound = binds(pd)
    # eight batch-1 prefills (M = 128: the small-M schedule) and 63 steps
    expected = add_launches(prefill_launches(n), step_launches(NEW_TOKENS - 1))
    ops.reset_launch_counts()
    single = pd.greedy(prompts, NEW_TOKENS, k=1)
    torch.cuda.synchronize()
    check_launches("paged K=1", expected)
    ops.reset_launch_counts()
    mega = pd.greedy(prompts, NEW_TOKENS, k=K)
    torch.cuda.synchronize()
    launches = check_launches("paged K=%d" % K, expected)
    check(all((a == b).all() for a, b in zip(single, mega)),
          "paged graphed megastep tokens != single-step tokens")
    step_ms = time_paged(pd, prompts, 1)
    mega_ms = time_paged(pd, prompts, K)
    sids = {}
    for p in prompts:
        sid, lg = pd.admit(p)
        sids[sid] = int(np.argmax(lg))

    def megasteps():
        cur = dict(sids)
        for _ in range(4):
            cur = {s: int(v[-1]) for s, v in pd.step_megastep(cur, k=K).items()}

    ms_prog = pd._megasteps[(K, ("greedy", 1.0, 0))]
    def back_to_the_prompts():
        for sid in sids:
            pd.rollback(sid, PROMPT_LEN)

    prof_mega = profiled("paged megastep window", megasteps, 4,
                         {k: 4 * v for k, v in ms_prog.replay_launches[0].items()},
                         back_to_the_prompts)

    def steps():
        cur = dict(sids)
        for _ in range(4 * K):
            cur = {s: int(np.argmax(v)) for s, v in pd.step(cur).items()}

    prof_steps = profiled("paged K=1 window", steps, 4 * K, step_launches(4 * K)[0],
                          back_to_the_prompts)
    for sid in list(sids):
        pd.retire(sid)
    mega_event_ms = megastep_card_time(ms_prog)

    # teacher-forced logits, card against CPU, over a few steps
    t0 = time.perf_counter()
    gpu_tf = paged_teacher_forced(pd, prompts, single, CPU_CHECK_STEPS)
    cpu_tf = paged_teacher_forced(PagedKVDecoder(params, ctx=pt.cpu(), **MODEL, **PAGED),
                                  prompts, single, CPU_CHECK_STEPS)
    cpu_s = time.perf_counter() - t0
    tf_err = float(np.abs(gpu_tf - cpu_tf).max())
    check(np.isfinite(gpu_tf).all(), "non-finite paged card logits")
    check(np.allclose(gpu_tf, cpu_tf, atol=1e-3, rtol=1e-3), ("paged card vs CPU logits", tf_err))

    # the prefix cache: chunked admits of C tokens
    pc = PagedKVDecoder(params, ctx=pt.gpu(0), prefix_cache=True, prefix_chunk=PREFIX_CHUNK,
                        **MODEL, **PAGED)
    s0, cold = pc.admit(prompts[0])
    pc.step_megastep({s0: int(np.argmax(cold))}, k=K)  # captures
    pc.retire(s0)
    pc_bound = binds(pc)
    full = PROMPT_LEN // PREFIX_CHUNK
    tail = int(PROMPT_LEN % PREFIX_CHUNK > 0)
    shared = PREFIX_LEN // PREFIX_CHUNK
    # prompt 0 is cached whole but for its tail; the others share the prefix
    chunks = tail + (n - 1) * (full - shared + tail)
    ops.reset_launch_counts()
    admitted = [pc.admit(p) for p in prompts]
    torch.cuda.synchronize()
    check_launches("prefix-cache admits", step_launches(chunks))
    check(np.array_equal(admitted[0][1], cold), "cached admit logits != cold admit logits")
    stats = pc.stats()
    # teacher-forced against the CPU: prompt 0's cold chunked admit, prompt
    # 1's admit on the cached prefix, and one verify chunk after it
    verify_toks = single[1][:SPEC_GAMMA + 1]
    gpu_pc = np.concatenate([cold[None], admitted[1][1][None],
                             pc.verify_chunk(admitted[1][0], verify_toks)])
    t0 = time.perf_counter()
    cpu_pc = prefix_teacher_forced(
        PagedKVDecoder(params, ctx=pt.cpu(), prefix_cache=True, prefix_chunk=PREFIX_CHUNK,
                       **MODEL, **PAGED), prompts[:2], verify_toks)
    cpu_s += time.perf_counter() - t0
    pc_err = float(np.abs(gpu_pc - cpu_pc).max())
    check(np.isfinite(gpu_pc).all(), "non-finite prefix-cache card logits")
    check(np.allclose(gpu_pc, cpu_pc, atol=1e-3, rtol=1e-3),
          ("prefix-cache admit and verify chunk, card vs CPU logits", pc_err))
    for sid, _ in admitted:
        pc.retire(sid)
    # every prompt is now cached but for its tail: one chunk an admit
    expected_pc = add_launches(step_launches(n), step_launches(NEW_TOKENS - 1))
    ops.reset_launch_counts()
    pc_single = pc.greedy(prompts, NEW_TOKENS, k=1)
    check_launches("prefix-cache K=1", expected_pc)
    ops.reset_launch_counts()
    pc_mega = pc.greedy(prompts, NEW_TOKENS, k=K)
    check_launches("prefix-cache K=%d" % K, expected_pc)
    check(all((a == b).all() for a, b in zip(pc_single, pc_mega)),
          "prefix-cache megastep tokens != single-step tokens")
    chunked_vs_prefill = float(np.mean([(a == b).mean() for a, b in zip(pc_single, single)]))
    check(chunked_vs_prefill == 1.0,
          ("chunked admits' greedy tokens != prefill admits'", chunked_vs_prefill))

    # speculative decoding: a one-layer draft cut from the same checkpoint
    spec = SpeculativeDecoder.build(params, draft_layers=DRAFT_LAYERS, gamma=SPEC_GAMMA,
                                    ctx=pt.gpu(0), **MODEL, **PAGED).warmup()
    want = spec.target.greedy(prompts[:1], NEW_TOKENS, k=1)[0]
    spec_bound = binds(spec.target, spec.draft)
    tally = {}
    for key, obj, name in (("verify_chunk", spec.target, "verify_chunk"),
                           ("target_step", spec.target, "step"),
                           ("draft_megastep", spec.draft, "step_megastep"),
                           ("draft_step", spec.draft, "step")):
        count_calls(obj, name, tally, key)
    ops.reset_launch_counts()
    got, spec_ms = timed(lambda: spec.greedy(prompts[0], NEW_TOKENS))
    torch.cuda.synchronize()
    check((got == want).all(), "speculative tokens != the target's plain greedy")
    D = DRAFT_LAYERS
    expected_spec = add_launches(
        prefill_launches(1), prefill_launches(1, layers=D),
        step_launches(tally["verify_chunk"] + tally["target_step"]),
        step_launches(tally["draft_megastep"] * SPEC_GAMMA + tally["draft_step"], layers=D))
    spec_launches = check_launches("speculative", expected_spec)
    # a draft equal to the target: rounds that accept all SPEC_GAMMA draft
    # tokens, and the draft's catch-up step after them
    full = SpeculativeDecoder.build(params, draft_layers=L, gamma=SPEC_GAMMA, ctx=pt.gpu(0),
                                    **MODEL, **PAGED).warmup()
    tally_full = {}
    for key, obj, name in (("verify_chunk", full.target, "verify_chunk"),
                           ("target_step", full.target, "step"),
                           ("draft_megastep", full.draft, "step_megastep"),
                           ("draft_step", full.draft, "step")):
        count_calls(obj, name, tally_full, key)
    ops.reset_launch_counts()
    got_full, full_ms = timed(lambda: full.greedy(prompts[0], NEW_TOKENS))
    torch.cuda.synchronize()
    check((got_full == want).all(), "speculative tokens (full draft) != the target's plain greedy")
    check(tally_full["draft_step"] > 0, ("no round accepted every draft token", tally_full))
    check_launches("speculative, full draft", add_launches(
        prefill_launches(2),
        step_launches(tally_full["verify_chunk"] + tally_full["target_step"]
                      + tally_full["draft_megastep"] * SPEC_GAMMA + tally_full["draft_step"])))
    check(binds(pd) == bound and binds(pc) == pc_bound
          and binds(spec.target, spec.draft) == spec_bound,
          "the paged phase bound an executable after warmup")
    log({"phase": "paged", "paged": PAGED, "k": K, "nvidia_smi": smi,
         "warmup_and_capture_s": warm_s, "launches": launches,
         "tokens_equal_single_step": True,
         "k1": latency_stats(step_ms, 1, n), "kK": latency_stats(mega_ms, K, n),
         "card_ms_per_megastep": prof_mega["device_busy_ms"],
         "card_ms_per_megastep_events": mega_event_ms,
         "card_ms_per_step_k1": prof_steps["device_busy_ms"],
         "device_idle_share_kK": prof_mega["device_idle_share"],
         "device_idle_share_k1": prof_steps["device_idle_share"],
         "profile_kK": prof_mega, "profile_k1": prof_steps,
         "card_vs_cpu_max_abs_err": tf_err, "cpu_check_steps": CPU_CHECK_STEPS,
         "cpu_check_s": cpu_s,
         "prefix": {"chunk": PREFIX_CHUNK, "chunk_dispatches": chunks, "stats": stats,
                    "cached_equals_cold_bitwise": True,
                    "admit_and_verify_card_vs_cpu_max_abs_err": pc_err,
                    "token_agreement_with_prefill_admits": chunked_vs_prefill},
         "speculative": {"gamma": SPEC_GAMMA, "draft_layers": D, "calls": tally,
                         "greedy_ms": spec_ms, "launches": spec_launches,
                         "tokens_equal_plain_greedy": True,
                         "full_draft": {"draft_layers": L, "calls": tally_full,
                                        "greedy_ms": full_ms}}})
    return launches


# set while a matmul_bias_act site runs, so that relu_kinks leaves its ReLU
# (the plain version's, on the CPU) to relu_decisions
IN_FUSED_SITE = [False]


@contextlib.contextmanager
def relu_decisions(record=None, pinned=None):
    """Record the output of every matmul_bias_act site of a run (``record``),
    or pin a run's ReLU decisions to recorded ones (``pinned``), and yield
    the list of (decisions that differed, largest |Δy| among them) per site.

    Where a pre-activation lies within rounding of 0, the card and the CPU,
    summing in other orders, can land on the two sides of the ReLU, and the
    gradient jumps there by the whole upstream gradient. A pinned run takes
    the recorded side at such kinks (a value of 0, or the smallest normal
    float), and its own values everywhere else."""
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    orig = mba.MatmulBiasAct.forward
    flips, ys = [], iter(pinned or ())

    def forward(ctx, a, w, b, act):
        IN_FUSED_SITE[0] = True  # the CPU's plain version applies the act through _ACTS
        try:
            y = orig(ctx, a, w, b, act)
        finally:
            IN_FUSED_SITE[0] = False
        if record is not None:
            record.append(y.detach().cpu())
        if pinned is not None:
            check(act == "relu", ("pinned decisions need relu", act))
            ref = next(ys).to(y.device)
            flip = (ref > 0) != (y > 0)
            flips.append((int(flip.sum()),
                          float((ref - y).abs()[flip].max()) if flip.any() else 0.0))
            # in place: the Function saved this y, and its backward reads y > 0
            y.copy_(torch.where(ref > 0, y.clamp_min(torch.finfo(y.dtype).tiny),
                                torch.zeros_like(y)))
        return y

    mba.MatmulBiasAct.forward = staticmethod(forward)
    try:
        yield flips
    finally:
        mba.MatmulBiasAct.forward = orig


def train_model(params):
    """The training phase's symbol, its fixed batch of tokens (from the
    seed) and a bind of it: ``(net, batch, bind)``, ``bind(ctx, rows)``
    giving an executor on the batch's first ``rows`` sequences."""
    from mxnet_tpu_torch.models import transformer

    B, T = TRAIN["batch"], TRAIN["seq_len"]
    net = transformer.get_symbol(seq_len=T, **MODEL)
    rs = np.random.RandomState(SEED + 2)
    tokens = rs.randint(0, MODEL["vocab_size"], (B, T + 1)).astype(np.float32)
    batch = {"data": tokens[:, :-1], "softmax_label": tokens[:, 1:]}
    reqs = {n: "write" for n in params}  # data and labels: null

    def bind(ctx, rows):
        exe = net.simple_bind(ctx, grad_req=reqs, data=(rows, T), softmax_label=(rows, T))
        for n, a in exe.arg_dict.items():
            a[:] = params[n] if n in params else batch[n][:rows]
        return exe

    return net, batch, bind


def train_step_fn(net, params, exe):
    """One training step on ``exe``: forward_backward, the SGD-momentum
    update of every parameter, a synchronize."""
    from mxnet_tpu_torch import optimizer

    names = [n for n in net.list_arguments() if n in params]
    opt = optimizer.create("sgd", learning_rate=TRAIN["lr"], momentum=TRAIN["momentum"],
                           wd=TRAIN["wd"], rescale_grad=1.0 / TRAIN["batch"],
                           param_idx2name=dict(enumerate(names)))
    updater = optimizer.get_updater(opt)

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

    return step


def run_train(pt, params):
    """Phase 4: training the full-width model on one fixed batch."""
    from mxnet_tpu_torch import ops

    B, T, L = TRAIN["batch"], TRAIN["seq_len"], MODEL["num_layers"]
    net, batch, bind = train_model(params)

    def loss_of(exe, rows):
        """SoftmaxOutput's cross-entropy on the batch, from its probabilities."""
        prob = exe.outputs[0]._tensor()
        lab = torch.as_tensor(batch["softmax_label"][:rows].reshape(-1, 1),
                              device=prob.device).long()
        return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())

    # (c) one step at batch 2, from the same weights, on the card and the CPU;
    # the CPU takes the card's side at every ReLU kink the two split
    small = [bind(ctx, TRAIN["check_batch"]) for ctx in (pt.gpu(0), pt.cpu())]
    card_ys = []
    with relu_decisions(record=card_ys):
        small[0].forward_backward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with relu_decisions(pinned=card_ys) as flips:
        small[1].forward_backward()
    cpu_s = time.perf_counter() - t0
    n_flips = sum(n for n, _ in flips)
    flip_dy = max(d for _, d in flips)
    # a split decision is a kink: both sides' values are within rounding of 0
    check(n_flips <= 1e-5 * sum(y.numel() for y in card_ys) and flip_dy <= 1e-5,
          ("ReLU decisions that differ beyond kinks", n_flips, flip_dy))
    small_loss = [loss_of(e, TRAIN["check_batch"]) for e in small]
    check(abs(small_loss[0] - small_loss[1]) <= 1e-3 * max(1.0, abs(small_loss[1])),
          ("card vs CPU loss", small_loss))
    worst_name, worst_rel = None, 0.0
    for n in params:
        got, want = small[0].grad_dict[n].asnumpy(), small[1].grad_dict[n].asnumpy()
        scale = float(np.abs(want).max())
        check(np.isfinite(got).all(), ("non-finite card gradient", n))
        # f32 on both sides, TF32 off; sums run in other orders on the card
        check(np.allclose(got, want, rtol=1e-3, atol=1e-3 * scale), ("card vs CPU grad", n))
        rel = float(np.abs(got - want).max()) / (scale or 1.0)
        if rel >= worst_rel:
            worst_name, worst_rel = n, rel
    log({"phase": "train_check", "batch": TRAIN["check_batch"], "loss_card": small_loss[0],
         "loss_cpu": small_loss[1], "worst_grad": worst_name,
         "worst_grad_abs_err_over_max": worst_rel, "relu_kinks_pinned": n_flips,
         "relu_kink_max_abs_dy": flip_dy, "relu_outputs": sum(y.numel() for y in card_ys),
         "cpu_step_s": cpu_s})
    del small

    exe = bind(pt.gpu(0), B)
    step = train_step_fn(net, params, exe)
    losses = []
    for _ in range(TRAIN["warmup_steps"]):
        step()
        losses.append(loss_of(exe, B))
    expected = {"flash_attention": L, "flash_attention_dq": L, "flash_attention_dkv": L,
                "norm_residual": 2 * L + 1, "norm_residual_bwd": 2 * L + 1,
                "matmul_bias_act": L}
    ops.reset_launch_counts()
    step_ms = []
    for i in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            check(ops.launch_counts() == with_zeros(expected),
                  ("one step's launch counts", ops.launch_counts(), expected))
        losses.append(loss_of(exe, B))
    launches = ops.launch_counts()
    check(launches == with_zeros({k: v * TRAIN["steps"] for k, v in expected.items()}),
          ("training launch counts", launches))
    schedules = ops.schedule_counts()  # ffn1 at M = batch · seq_len: the tiles
    check(schedules == {"matmul_bias_act.small_m": 0, "matmul_bias_act.tiles": L * TRAIN["steps"]},
          ("training schedule counts", schedules))
    check(all(math.isfinite(x) for x in losses), ("non-finite loss", losses))
    check(losses[-1] < losses[0], ("the loss did not fall", losses))
    log({"phase": "train_breakdown", **profile_window(step)})
    p50 = float(np.percentile(step_ms, 50))
    log({"phase": "train", "model": MODEL, "train": TRAIN, "tokens_per_step": B * T,
         "launches_per_step": expected, "launches": launches, "schedule_launches": schedules,
         "losses": losses, "step_ms_p50": p50, "step_ms_p80": float(np.percentile(step_ms, 80)),
         "step_ms": step_ms, "tokens_per_s": B * T * 1e3 / p50,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def check_tf32_off():
    """The unfused convs go through cuDNN, whose float32 default is TF32:
    the port switches it off at import, and nothing may switch it back."""
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          ("TF32 is on", torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))


def resnet_values(net, seed=SEED + 3):
    """Random ResNet weights from the seed (``zoo_values``)."""
    return zoo_values(net, image_shape(), seed)


def image_shape():
    return tuple(int(v) for v in RESNET["image_shape"].split(","))


def resnet_batch(B):
    """One fixed batch (``zoo_batch``)."""
    return zoo_batch(B, image_shape(), RESNET["num_classes"], SEED + 4)


def resnet_bind(pt, net, ctx, B, args, aux, grad_req, images, labels, dtype="float32"):
    """A bind of ``net`` (any classifier over ``images``) at batch ``B``."""
    types = {n: dtype for n in net.list_arguments() + net.list_auxiliary_states()}
    exe = net.simple_bind(ctx, grad_req=grad_req, type_dict=types,
                          data=(B,) + tuple(images.shape[1:]), softmax_label=(B,))
    exe.copy_params_from(dict(args, data=images[:B], softmax_label=labels[:B]), aux)
    return exe


def run_resnet_serve(pt, net, args, aux):
    """Phase 5: ResNet-50 inference on the card at batch 32 and 1: launch
    counts, latency and images/s, a breakdown; card vs CPU at batch 2."""
    from mxnet_tpu_torch import ops

    check_tf32_off()
    images, labels = resnet_batch(max(RESNET_SERVE["batches"]))
    out = {"phase": "resnet_serve", "model": RESNET}
    for B in RESNET_SERVE["batches"]:
        exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, "null", images, labels)
        for _ in range(3):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        prob = exe.forward(is_train=False)[0]
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check(launches == with_zeros({"conv_bn_infer": RESNET_SITES}),
              ("inference launch counts", B, launches))
        p = prob.asnumpy()
        check(p.shape == (B, RESNET["num_classes"]) and np.isfinite(p).all(),
              ("inference output", B, p.shape))
        check(np.allclose(p.sum(axis=1), 1.0, atol=1e-4), ("probabilities", B))
        lat = []
        for _ in range(RESNET_SERVE["iters"]):
            t0 = time.perf_counter()
            exe.forward(is_train=False)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(lat))
        out["batch%d" % B] = {"launches": launches, "latency_ms_p50": med,
                              "latency_ms_p80": float(np.percentile(lat, 80)),
                              "latency_ms": lat, "images_per_s": B * 1e3 / med}
        torch.cuda.reset_peak_memory_stats()
        log({"phase": "resnet_serve_breakdown", "batch": B,
             **profile_window(lambda: exe.forward(is_train=False)),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        del exe
    Bc = RESNET_SERVE["check_batch"]
    probs = []
    for ctx in (pt.gpu(0), pt.cpu()):
        exe = resnet_bind(pt, net, ctx, Bc, args, aux, "null", images, labels)
        probs.append(exe.forward(is_train=False)[0].asnumpy())
    err = float(np.abs(probs[0] - probs[1]).max())
    # f32 on both sides, TF32 off; sums in other orders on the card
    check(np.allclose(probs[0], probs[1], rtol=1e-3, atol=1e-6), ("card vs CPU probs", err))
    out.update(card_vs_cpu_max_abs_err=err, card_vs_cpu_batch=Bc,
               argmax_agree=bool((probs[0].argmax(1) == probs[1].argmax(1)).all()))
    log(out)
    return out["batch%d" % max(RESNET_SERVE["batches"])]["launches"]


def cnn_train_check(pt, net, args, aux, images, labels, Bc, phase, fc_relus=False,
                    distance="max"):
    """One training step of a classifier at batch ``Bc`` from the same
    weights on the card and on the CPU (phase 6's check, and phase 10's):
    the loss, every gradient and the new moving stats. ``fc_relus``: the
    net also has ReLUs inside fused ``matmul_bias_act`` sites, pinned too.
    ``distance``: how far a gradient lies from the float64 one, "max" (the
    largest element's difference over the largest magnitude: phase 6's) or
    "fro" (the difference's norm over the gradient's). The CPU's float32
    and float64 runs sum in the same orders, so their errors share a part
    the card's do not; one element's difference is that noise at its most.
    Phase 10 reads the norm (PERF.md §6)."""
    reqs = {n: "write" for n in args}  # data and labels: null
    fc_kinks = relu_decisions if fc_relus else _no_kinks

    def loss_of(exe, rows):
        prob = exe.outputs[0]._tensor()
        lab = torch.as_tensor(labels[:rows].reshape(-1, 1), device=prob.device).long()
        return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())

    # one step at batch 2 from the same weights on the card, and on the CPU
    # in float32 and in float64, the CPU runs pinned to the card's side at
    # every ReLU kink they split. At batch 2 a randomly initialised ResNet
    # (or Inception) is chaotic: a 1e-7 relative change of the images moves
    # deep gradients by percents with every ReLU pinned (PERF.md §6). So a
    # gradient passes within rtol 1e-3, atol 1e-3·max|grad| of the CPU's
    # float32 one, or when it lies as close to the float64 gradient as
    # RESNET_F64_FACTOR times the float32 CPU's own distance from it
    card, fc_card = [], []
    exe = resnet_bind(pt, net, pt.gpu(0), Bc, args, aux, reqs, images, labels)
    with relu_kinks(record=card), fc_kinks(record=fc_card):
        exe.forward_backward()
    torch.cuda.synchronize()
    got = ({n: exe.grad_dict[n].asnumpy() for n in args},
           {n: exe.aux_dict[n].asnumpy() for n in aux}, loss_of(exe, Bc))
    del exe

    def cpu_step(dtype):
        e = resnet_bind(pt, net, pt.cpu(), Bc, args, aux, reqs, images, labels, dtype)
        with relu_kinks(compare=card, pin=True) as flips, fc_kinks(pinned=fc_card) as fc_flips:
            e.forward_backward()
        return ({n: e.grad_dict[n].asnumpy() for n in args},
                {n: e.aux_dict[n].asnumpy() for n in aux}, loss_of(e, Bc)), flips + fc_flips

    t0 = time.perf_counter()
    want, flips = cpu_step("float32")
    cpu_s = time.perf_counter() - t0
    exact, flips64 = cpu_step("float64")

    def rel(a, b):
        return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)

    n_flips, flip_pre = sum(n for n, _ in flips), max([d for _, d in flips] or [0.0])
    n_decisions = sum(int(d.numel()) for d in card) + sum(int(y.numel()) for y in fc_card)
    strict = [n for n in args if np.allclose(got[0][n], want[0][n], rtol=1e-3,
                                             atol=1e-3 * float(np.abs(want[0][n]).max()))]
    def fro(a, b):
        return float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b)) or 1.0)

    far = rel if distance == "max" else fro
    card64 = {n: far(got[0][n], exact[0][n]) for n in args}
    cpu64 = {n: far(want[0][n], exact[0][n]) for n in args}
    ratio = {n: card64[n] / max(cpu64[n], 1e-30) for n in args}
    # a gradient that is 0 in exact arithmetic (a conv bias a BatchNorm
    # follows: the BN takes its mean out) is rounding on both sides; it must
    # stay at that level on the card
    gscale = max(float(np.abs(exact[0][n]).max()) for n in args)
    null = {n for n in args if float(np.abs(exact[0][n]).max()) <= 1e-6 * gscale}
    loose = [n for n in args if n not in strict and n not in null]
    worst = max(loose, key=lambda n: ratio[n]) if loose else None
    aux_rel = max([rel(got[1][n], want[1][n]) for n in aux] or [0.0])
    log({"phase": phase, "batch": Bc, "distance": distance, "loss_card": got[2],
         "loss_cpu": want[2],
         "loss_cpu_f64": exact[2], "relu_kinks_pinned": n_flips, "relu_kink_max_abs_pre": flip_pre,
         "relu_kinks_pinned_f64": sum(n for n, _ in flips64), "relu_decisions": n_decisions,
         "grads": len(args), "grads_within_1e-3_of_cpu": len(strict),
         "card_vs_cpu_worst": max(rel(got[0][n], want[0][n]) for n in args),
         "card_vs_f64_worst": max(card64.values()), "cpu_vs_f64_worst": max(cpu64.values()),
         "card_vs_f64_median": float(np.median(list(card64.values()))),
         "cpu_vs_f64_median": float(np.median(list(cpu64.values()))),
         "worst_ratio_grad": worst, "worst_ratio": ratio[worst] if worst else None,
         "ratios_over_2": sorted(n for n in loose if ratio[n] > 2),
         "null_grads": len(null),
         "worst_aux_abs_err_over_max": aux_rel, "cpu_step_s": cpu_s})
    check(abs(got[2] - want[2]) <= 1e-3 * max(1.0, abs(want[2])), ("card vs CPU loss", got[2],
                                                                    want[2]))
    # a split decision is a kink: within rounding of 0 on both sides, and rare
    check(n_flips <= 1e-5 * n_decisions and flip_pre <= 1e-3,
          ("ReLU decisions that differ beyond kinks", n_flips, flip_pre))
    for n in null:
        check(float(np.abs(got[0][n]).max()) <= 1e-4 * gscale, ("card vs CPU null grad", n))
    for n in args:
        check(np.isfinite(got[0][n]).all(), ("non-finite card gradient", n))
        check(n in strict or n in null or card64[n] <= RESNET_F64_FACTOR * cpu64[n],
              ("card vs CPU grad", n, card64[n], cpu64[n]))
    check(aux_rel <= 1e-3, ("card vs CPU moving stats", aux_rel))
    return {"loss_card": got[2], "loss_cpu": want[2], "relu_kinks_pinned": n_flips,
            "grads_within_1e-3_of_cpu": len(strict), "grads": len(args),
            "worst_ratio": ratio[worst] if worst else None}


@contextlib.contextmanager
def _no_kinks(record=None, pinned=None):
    yield []


@contextlib.contextmanager
def relu_kinks(record=None, compare=None, pin=False):
    """Record every ReLU decision of a ResNet run (``record``), or compare a
    run's ReLU decisions with recorded ones (``compare``) and, with ``pin``,
    pin them to the recorded side; yields the list of (decisions that
    differed, largest |pre-activation| among them) per ReLU: the fused
    convs' prologues and the unfused ``Activation`` ReLUs, in the order the
    forward reaches them.

    Where a pre-activation lies within rounding of 0, the card and the CPU,
    summing in other orders, can put it on the two sides of the ReLU, and
    the gradient there jumps by the whole upstream gradient; at batch 2 a
    late stage's weight gradient sums a few hundred positions, so one such
    jump moves it by percents. A pinned run (the CPU's, through the
    kernels' plain versions) takes the recorded side at such a kink, a
    value of 0 or the smallest normal float, and its own values everywhere
    else, in the prologue's forward and in its backward's recomputation
    alike. The kernel's prologue rounds x·scale and the sum as the torch
    ops here do, so the card's recorded decisions are the kernel's."""
    from mxnet_tpu_torch.ops import conv_bn as cb
    from mxnet_tpu_torch.ops import nn as pnn

    orig_apply, orig_prologue, orig_relu = cb.ConvBlock.apply, cb._prologue, pnn._ACTS["relu"]
    flips, refs, masks, state = [], iter(compare or ()), {}, {"forward": False}

    def decide(pre):
        """The recorded decision and the flipped elements, or None."""
        if record is not None:
            record.append((pre > 0).cpu())
        if compare is None:
            return None
        want = next(refs).to(pre.device)
        flip = want != (pre > 0)
        flips.append((int(flip.sum()), float(pre.abs()[flip].max()) if flip.any() else 0.0))
        return want, flip

    def pinned(pre, want_flip):
        want, flip = want_flip
        tiny = torch.full_like(pre, torch.finfo(pre.dtype).tiny)
        return torch.where(flip, torch.where(want, tiny, torch.zeros_like(pre)), pre)

    def conv_block(x, w, scale, shift, res, stride, relu):
        if record is not None and scale is not None and relu:
            b = (1, -1, 1, 1)
            decide(x.detach() * scale.detach().reshape(b) + shift.detach().reshape(b))
        state["forward"] = True
        try:
            return orig_apply(x, w, scale, shift, res, stride, relu)
        finally:
            state["forward"] = False

    def prologue(x, scale, shift, relu):
        if scale is None or not relu or compare is None:
            return orig_prologue(x, scale, shift, relu)
        b = (1, -1, 1, 1)
        pre = x * scale.to(x.dtype).reshape(b) + shift.to(x.dtype).reshape(b)
        key = (x.data_ptr(), scale.data_ptr(), shift.data_ptr())
        if state["forward"]:  # the forward's call; the backward recomputes
            masks[key] = decide(pre)
        return torch.relu(pinned(pre, masks[key]) if pin else pre)

    def relu(data):
        if IN_FUSED_SITE[0]:  # a matmul_bias_act site's: relu_decisions pins it
            return orig_relu(data)
        got = decide(data.detach()) if (record is not None or compare is not None) else None
        if pin and got is not None and got[1].any():
            # the pinned value exactly, with data's gradient: x - x is 0 in
            # floating point, where x + (pinned - x) may round to 0 instead
            data = torch.where(got[1], (data - data.detach()) + pinned(data.detach(), got), data)
        return orig_relu(data)

    cb.ConvBlock.apply, cb._prologue, pnn._ACTS["relu"] = conv_block, prologue, relu
    try:
        yield flips
    finally:
        cb.ConvBlock.apply, cb._prologue, pnn._ACTS["relu"] = orig_apply, orig_prologue, orig_relu


def run_resnet_train(pt, net, args, aux):
    """Phase 6: ResNet-50 training on one fixed batch: card vs CPU at batch
    2, then timed steps at batch 32 with launch counts, a falling loss and
    changed moving stats."""
    from mxnet_tpu_torch import ops, optimizer

    check_tf32_off()
    B = RESNET_TRAIN["batch"]
    images, labels = resnet_batch(B)
    reqs = {n: "write" for n in args}  # data and labels: null

    def loss_of(exe, rows):
        prob = exe.outputs[0]._tensor()
        lab = torch.as_tensor(labels[:rows].reshape(-1, 1), device=prob.device).long()
        return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())

    cnn_train_check(pt, net, args, aux, images, labels, RESNET_TRAIN["check_batch"],
                    "resnet_train_check")

    exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, reqs, images, labels)
    names = [n for n in net.list_arguments() if n in args]
    opt = optimizer.create("sgd", learning_rate=RESNET_TRAIN["lr"],
                           momentum=RESNET_TRAIN["momentum"], wd=RESNET_TRAIN["wd"],
                           rescale_grad=1.0 / B, param_idx2name=dict(enumerate(names)))
    updater = optimizer.get_updater(opt)

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

    losses = []
    for _ in range(RESNET_TRAIN["warmup_steps"]):
        step()
        losses.append(loss_of(exe, B))
    expected = {"conv_bn": RESNET_SITES, "conv_bn_bwd": RESNET_SITES}
    ops.reset_launch_counts()
    step_ms = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(RESNET_TRAIN["steps"]):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            check(ops.launch_counts() == with_zeros(expected),
                  ("one ResNet step's launch counts", ops.launch_counts()))
        losses.append(loss_of(exe, B))
    launches = ops.launch_counts()
    check(launches == with_zeros({k: v * RESNET_TRAIN["steps"] for k, v in expected.items()}),
          ("ResNet training launch counts", launches))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses), ("non-finite loss", losses))
    check(losses[-1] < losses[0], ("the ResNet loss did not fall", losses))
    moved = {n: float(np.abs(a.asnumpy() - aux[n]).max()) for n, a in exe.aux_dict.items()}
    check(all(v > 0 for v in moved.values()),
          ("moving stats that did not change", [n for n, v in moved.items() if v == 0]))
    check_tf32_off()
    log({"phase": "resnet_train_breakdown", **profile_window(step)})
    p50 = float(np.percentile(step_ms, 50))
    log({"phase": "resnet_train", "model": RESNET, "train": RESNET_TRAIN,
         "launches_per_step": expected, "launches": launches, "losses": losses,
         "step_ms_p50": p50, "step_ms_p80": float(np.percentile(step_ms, 80)),
         "step_ms": step_ms, "images_per_s": B * 1e3 / p50, "peak_memory_gb": peak_gb,
         "aux_moved_min": min(moved.values())})
    return launches


def run_deploy(pt, net, args, aux):
    """Phase 7: the deploy surface at ResNet-50's full width."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.ops import matmul_stats as ms
    from mxnet_tpu_torch.predictor import Predictor, load_ndarray_file

    check_tf32_off()
    B, shape1 = DEPLOY["batch"], (1,) + image_shape()
    shape = (B,) + image_shape()
    out = {"phase": "deploy", "model": RESNET, "batch": B}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = tmp + "/resnet50"
        t0 = time.perf_counter()
        pt.model.save_checkpoint(prefix, DEPLOY["epoch"], net, args, aux)
        out["save_return_s"] = time.perf_counter() - t0
        pt.nd.waitall()  # the write is queued on the engine
        out["save_checkpoint_s"] = time.perf_counter() - t0
        with open(prefix + "-symbol.json") as f:
            json_str = f.read()
        with open("%s-%04d.params" % (prefix, DEPLOY["epoch"]), "rb") as f:
            blob = f.read()
        check(pt.model.find_last_checkpoint(prefix) == DEPLOY["epoch"], "find_last_checkpoint")
    out["checkpoint_bytes"] = len(blob)
    t0 = time.perf_counter()
    loaded = load_ndarray_file(blob)  # onto the default context, the card
    torch.cuda.synchronize()
    out["load_params_s"] = time.perf_counter() - t0
    check(set(loaded) == {"arg:" + n for n in args} | {"aux:" + n for n in aux},
          "the checkpoint's names")
    for tag, values in (("arg:", args), ("aux:", aux)):
        for n, v in values.items():
            arr = loaded[tag + n]
            check(arr.context == pt.gpu(0) and np.array_equal(arr.asnumpy(), v),
                  ("the .params file does not load back equal", n))

    t0 = time.perf_counter()
    pred = Predictor(json_str, blob, {"data": shape})
    torch.cuda.synchronize()
    out["predictor_create_s"] = time.perf_counter() - t0
    check(pred.executables_bound == 1, "the predictor binds its first shape once")

    rs = np.random.RandomState(SEED + 5)
    raw = pt.nd.array(rs.uniform(0, 255, shape).astype(np.float32))
    mean, std = pt.nd.array(np.array(DEPLOY["mean"], np.float32)), \
        pt.nd.array(np.array(DEPLOY["std"], np.float32))
    kernel = normalise_kernel(pt, shape)
    kernel.push([raw, mean, std], out_shapes=[shape])  # loads the image (built in phase 2)
    torch.cuda.synchronize()
    tap = Predictor(pt.sym.load_json(json_str).get_internals()[DEPLOY["tap"]].tojson(), blob,
                    {"data": shape})
    w_sc = loaded["arg:" + DEPLOY["tap_weight"]]  # (256, 64, 1, 1)

    # ---- the main path, with the counts set to 0 just before and read just after
    ops.reset_launch_counts()
    (x,) = kernel.push([raw, mean, std], out_shapes=[shape])
    torch.cuda.synchronize()  # a fault inside the pushed kernel shows here
    pred.forward(data=x)
    probs = pred.get_output(0)
    tap.forward(data=x)
    feat = pt.nd.array(tap.get_output(0))  # (B, 64, 56, 56)
    a = pt.nd.transpose(feat, axes=(0, 2, 3, 1)).reshape((-1, feat.shape[1]))
    b = w_sc.reshape(w_sc.shape[:2]).T
    c, col_sum, col_sumsq = ms.matmul_with_stats(a._tensor(), b._tensor())
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = {"rtc": 1, "conv_bn_infer": RESNET_SITES, "matmul_stats": 1}
    check(launches == with_zeros(expected), ("deploy launch counts", launches))

    # ---- what came out
    check(probs.shape == (B, RESNET["num_classes"]) and np.isfinite(probs).all(),
          ("deploy output", probs.shape))
    check(np.allclose(probs.sum(axis=1), 1.0, atol=1e-4), "deploy probabilities")
    xn = x.asnumpy()
    want_x = (raw.asnumpy() - np.array(DEPLOY["mean"], np.float32).reshape(1, -1, 1, 1)) \
        / np.array(DEPLOY["std"], np.float32).reshape(1, -1, 1, 1)
    check(np.allclose(xn, want_x, rtol=1e-6, atol=1e-6), "rtc normalisation vs numpy")
    exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, "null", xn, np.zeros((B,), np.float32))
    direct = exe.forward(is_train=False)[0].asnumpy()
    del exe
    err = float(np.abs(probs - direct).max())
    # the same kernels on the same inputs
    check(np.allclose(probs, direct, rtol=1e-5, atol=1e-7)
          and (probs.argmax(1) == direct.argmax(1)).all(), ("predictor vs a direct bind", err))
    out.update(predictor_vs_bind_max_abs_err=err,
               predictor_vs_bind_bitwise=bool(np.array_equal(probs, direct)))
    # matmul_with_stats is the 1x1 shortcut convolution and its statistics
    ft = feat._tensor()
    conv = F.conv2d(ft, w_sc._tensor())
    M = a.shape[0]
    stats_err = {"c": rel_err(c, conv.permute(0, 2, 3, 1).reshape(M, -1)),
                 "col_sum": rel_err(col_sum, conv.sum(dim=(0, 2, 3))),
                 "col_sumsq": rel_err(col_sumsq, (conv * conv).sum(dim=(0, 2, 3)))}
    for n, e in stats_err.items():
        check(math.isfinite(e) and e <= CONV_TOL["elementwise" if n == "c" else "sums"],
              ("deploy matmul_with_stats vs conv2d", n, e))
    out.update(matmul_stats_shape=[M, a.shape[1], b.shape[1]], matmul_stats_vs_conv2d=stats_err)

    # ---- reshape to batch 1 and back
    pred.reshape({"data": shape1})
    check(pred.executables_bound == 2, "reshape to a new shape binds once")
    pred.forward(data=x[0:1])  # a view of the batch
    one = pred.get_output(0)
    # one image through the same kernels at another grid; cuBLAS may pick
    # another algorithm for the classifier
    check(np.allclose(one, probs[:1], rtol=1e-4, atol=1e-7), "batch 1 vs batch 32")
    lat1 = []
    for _ in range(DEPLOY["iters"]):
        t0 = time.perf_counter()
        pred.forward(data=x[0:1])
        pred.get_output(0)
        lat1.append((time.perf_counter() - t0) * 1e3)
    pred.reshape({"data": shape})
    check(pred.executables_bound == 2, "reshape back to a seen shape bound an executor")
    ops.reset_launch_counts()
    pred.forward(data=x)
    again = pred.get_output(0)
    check(ops.launch_counts() == with_zeros({"conv_bn_infer": RESNET_SITES}),
          ("a forward's launch counts", ops.launch_counts()))
    check(np.array_equal(again, probs), "the first probabilities do not repeat after reshape")
    lat = []
    for _ in range(DEPLOY["iters"]):
        t0 = time.perf_counter()
        pred.forward(data=x)
        pred.get_output(0)
        lat.append((time.perf_counter() - t0) * 1e3)

    def call():
        pred.forward(data=x)
        pred.get_output(0)

    log({"phase": "deploy_breakdown", "batch": B, **profile_window(call)})
    for tag, samples, n in (("batch%d" % B, lat, B), ("batch1", lat1, 1)):
        med = float(np.median(samples))
        out[tag] = {"latency_ms_p50": med, "latency_ms_p80": float(np.percentile(samples, 80)),
                    "latency_ms": samples, "images_per_s": n * 1e3 / med}
    out.update(launches=launches, executables_bound=pred.executables_bound,
               rtc_compiles=kernel.compiles, rtc_launches=kernel.launches)
    log(out)
    return launches


# ------------------------------------------------------------ engine phase
class Recorder:
    """Wraps a cache's ``run`` and ``swap_params``: every dispatched padded
    batch with its outputs and the weight version it ran on."""

    def __init__(self, cache):
        self.cache, self.batches, self.version = cache, [], 0
        self._run, self._swap = cache.run, cache.swap_params
        cache.run, cache.swap_params = self.run, self.swap
        self._index, self._indexed = {}, 0  # a row's leading bytes -> (batch, row)

    def clear(self):
        """Forget the recorded batches; the weight version stays."""
        self.batches, self._index, self._indexed = [], {}, 0

    def run(self, inputs):
        outs = self._run(inputs)
        self.batches.append((inputs, outs, self.version))
        return outs

    def swap(self, *args, **kwargs):
        n = self._swap(*args, **kwargs)
        self.version += 1
        return n

    def locate(self, name, rows):
        """(batch index, row offset) of the first dispatched batch that holds
        a request's rows (seeded random rows: their leading bytes find them)."""
        for i in range(self._indexed, len(self.batches)):
            for off, row in enumerate(self.batches[i][0][name]):
                self._index.setdefault(row.reshape(-1)[:16].tobytes(), (i, off))
        self._indexed = len(self.batches)
        hit = self._index.get(rows[0].reshape(-1)[:16].tobytes())
        check(hit is not None, "a request's rows are in no dispatched batch")
        b, off = hit
        check(np.array_equal(self.batches[b][0][name][off:off + rows.shape[0]], rows),
              "a request's rows are not whole in its batch")
        return b, off

    def rerun_bitwise(self, first=0):
        """Each recorded batch from ``first`` on run again through the cache:
        the count of batches whose every output repeats its bits."""
        same = 0
        for inputs, outs, _ in self.batches[first:]:
            again = self._run(inputs)
            same += all(np.array_equal(a, b) for a, b in zip(outs, again))
        return same


def clients(eng, requests, timeout=120):
    """One thread a list of requests, each submitted and waited for in turn
    (closed loop). Returns {(thread, i): (outputs, submit start, submit end,
    latency ms)}; an error in any client fails the run."""
    got, errors = {}, []

    def worker(t, reqs):
        try:
            for i, inputs in enumerate(reqs):
                t0 = time.perf_counter()
                fut = eng.submit(inputs)
                t1 = time.perf_counter()
                out = fut.result(timeout=timeout)
                got[(t, i)] = (out, t0, t1, (time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # surfaced by the check below
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(t, reqs)) for t, reqs in enumerate(requests)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, ("engine client errors", errors[:3]))
    return got


def image_requests(seed, threads, per, rows):
    """Seeded requests of ``rows`` images each, uniform in [-1, 1)."""
    rng = np.random.default_rng(seed)
    return [[{"data": rng.random((int(rng.integers(rows[0], rows[1] + 1)),) + image_shape(),
                                 dtype=np.float32) * 2 - 1}
             for _ in range(per)] for _ in range(threads)]


def check_rows(rec, requests, got, name="data"):
    """Each request's outputs are its rows of the batch it rode in, bitwise
    (sliced by the engine's row factors). Returns {request: batch index}."""
    where = {}
    for t, reqs in enumerate(requests):
        for i, inputs in enumerate(reqs):
            rows = inputs[name]
            b, off = rec.locate(name, rows)
            outs = rec.batches[b][1]
            for o, want in zip(got[(t, i)][0], outs):
                k = want.shape[0] // rec.batches[b][0][name].shape[0]
                check(np.array_equal(o, want[off * k:(off + rows.shape[0]) * k]),
                      ("request", t, i, "differs from its rows of the dispatched batch"))
            where[(t, i)] = b
    return where


def timer_ms(tm, name):
    t = tm.timer(name)
    return {"count": t.count, "mean_ms": t.total_ms / t.count if t.count else None,
            **{k + "_ms": v for k, v in t.quantiles_ms((0.5, 0.99)).items()}}


def engine_load(tm, eng, rec, warm, requests, binds):
    """One closed-loop load of ``requests`` in one profiler window of the
    card's activity, after one request ``warm`` outside it (so that the
    first host gap the engine times is not the pause before the load).
    Gated: exactly 49 conv_bn launches a batch, no bind, each request its
    rows of its batch and each batch a second run of it, bitwise. Returns
    throughput, client and engine latency, batching, and the card's busy
    time and idle share, all of this one run. The window is whole when its
    trace holds every conv_bn launch of the wrappers' count (the profiler
    drops its events for a spell now and then); a short window's idle share
    is null, its trace's share of the launches given instead."""
    from torch.profiler import ProfilerActivity

    t0 = time.perf_counter()
    eng.infer(warm)
    rec.clear()
    tm.reset()
    got = {}
    events, wall_ms, wrapped = profiler_window(lambda: got.update(clients(eng, requests)),
                                               [ProfilerActivity.CUDA])
    launches, n_batches = with_zeros(wrapped), len(rec.batches)
    check(launches == with_zeros({"conv_bn_infer": RESNET_SITES * n_batches}),
          ("engine launches", n_batches, launches))
    check(rec.cache.binds == binds, ("binds after warmup", rec.cache.binds))
    check_rows(rec, requests, got)
    bitwise = rec.rerun_bitwise()
    check(bitwise == n_batches, ("batches whose second run repeats its bits",
                                 bitwise, n_batches))
    busy = sum(us for _, us in events.values()) / 1e3
    traced = sum(n for key, (n, _) in events.items() if KERNELS["conv_bn"][2] in key)
    whole = traced == launches["conv_bn_infer"]
    PROFILER_TALLY["load_windows"] += 1
    PROFILER_TALLY["load_windows_short"] += not whole
    top = sorted(events.items(), key=lambda kv: -kv[1][1])[:4]
    lat = [v[3] for v in got.values()]
    rows = sum(r["data"].shape[0] for reqs in requests for r in reqs)
    by_bucket = {}
    for inputs, _, _ in rec.batches:
        b = inputs["data"].shape[0]
        by_bucket[b] = by_bucket.get(b, 0) + 1
    snap = tm.snapshot()
    seconds = wall_ms / 1e3
    return {
        "requests": len(lat), "rows": rows, "seconds": seconds,
        "requests_per_s": len(lat) / seconds, "images_per_s": rows / seconds,
        "client_latency_ms_p50": float(np.percentile(lat, 50)),
        "client_latency_ms_p99": float(np.percentile(lat, 99)),
        "serving_request": timer_ms(tm, "serving.request"),
        "serving_queue_wait": timer_ms(tm, "serving.queue_wait"),
        "serving_dispatch": timer_ms(tm, "serving.dispatch"),
        "dispatch_host_gap": timer_ms(tm, "dispatch.host_gap"),
        "batches": n_batches, "batches_by_bucket": by_bucket,
        "mean_occupancy": snap["serving.batch_items"] / snap["serving.batch_capacity"],
        "padded_rows": snap["serving.padded_rows"], "launches": launches,
        "batches_bitwise_on_rerun": bitwise,
        "device_busy_ms": busy, "trace_whole": whole,
        "traced_share_of_launches": traced / launches["conv_bn_infer"],
        "device_idle_share": 1.0 - busy / wall_ms if whole else None,
        "top_device_ms": {k[:60]: us / 1e3 for k, (_, us) in top},
        "with_checks_s": time.perf_counter() - t0}


def run_engine(pt, net, args, aux, params, smi):
    """Phase 8: ``InferenceEngine`` on the card. A: ResNet-50 under eight
    closed-loop clients in three profiled loads (``engine_load``), the
    oversize refusal, the manifest replayed by a fresh cache, a batch-32
    dispatch against the bare forward. B: retry under an
    injected dispatch fault, shedding, and a hitless reload under load.
    C: the Transformer-base prefill graph served by the engine, its
    launches a batch, and a reload of a decoder's weights that lands in the
    next megastep without a new capture."""
    from mxnet_tpu_torch import faultinject as fi
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.serving import (InferenceEngine, KVCacheDecoder,
                                         PersistentExecutableCache, ServeOverloadError)

    check_tf32_off()
    E = ENGINE
    t_phase = time.perf_counter()
    tm.set_mode("counters")
    tm.reset()
    out = {"phase": "engine", "card": smi, "model": RESNET, "buckets": E["buckets"],
           "max_delay_ms": E["max_delay_ms"], "clients": E["clients"],
           "requests_per_client": E["requests"], "rows": E["rows"]}
    with tempfile.TemporaryDirectory() as tmp:
        # --- A: ResNet-50 under concurrent load
        cache = PersistentExecutableCache(net, args, aux, model_key="resnet50", cache_dir=tmp)
        eng = InferenceEngine(cache, {"data": image_shape()}, buckets=E["buckets"],
                              max_delay_ms=E["max_delay_ms"])
        t0 = time.perf_counter()
        eng.start()
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
        warm_binds = cache.binds
        check(warm_binds == len(E["buckets"]) and cache.sealed, ("warmup binds", warm_binds))
        rec = Recorder(cache)
        warm = image_requests(SEED + 19, 1, 1, E["rows"])[0][0]
        out["load"] = []
        for w, seed in enumerate(E["load_seeds"]):
            if w:
                time.sleep(PROFILER_GAP_S)
            requests = image_requests(seed, E["clients"], E["requests"], E["rows"])
            out["load"].append(engine_load(tm, eng, rec, warm, requests, warm_binds))
        refusal = None
        try:
            eng.submit({"data": np.zeros((E["buckets"][-1] + 1,) + image_shape(), np.float32)})
        except pt.MXNetError as exc:
            refusal = str(exc)
        check(refusal is not None and "exceed the largest bucket" in refusal,
              ("oversize request", refusal))
        # one batch-32 dispatch (host pad, copy in, forward, read back) and the
        # bare forward of the same executor, on the card and on the host clock
        b32 = {"data": np.random.RandomState(SEED + 22).uniform(
            -1, 1, (E["buckets"][-1],) + image_shape()).astype(np.float32)}
        exe = cache.executable({"data": b32["data"].shape})
        bare = lambda: exe.forward(is_train=False)  # noqa: E731
        host = {"dispatch": [], "bare_forward": []}
        for _ in range(10):
            _, ms = timed(lambda: rec._run(b32))
            host["dispatch"].append(ms)
            _, ms = timed(lambda: (bare(), torch.cuda.synchronize()))
            host["bare_forward"].append(ms)
        out["batch32"] = {"dispatch_card_ms": device_ms(lambda: rec._run(b32), iters=10),
                          "bare_forward_card_ms": device_ms(bare, iters=10),
                          "dispatch_host_ms_p50": float(np.median(host["dispatch"])),
                          "bare_forward_host_ms_p50": float(np.median(host["bare_forward"]))}
        eng.close()
        check(eng.health()["state"] == "stopped", "engine A did not stop")
        fresh = PersistentExecutableCache(net, args, aux, model_key="resnet50", cache_dir=tmp)
        check(fresh.warmup(None) == len(E["buckets"]) and fresh.sealed
              and sorted(fresh.keys()) == sorted(cache.keys()), "the manifest did not replay")
        out["manifest"] = {"path": fresh._manifest_path()[len(tmp) + 1:],
                           "buckets": len(fresh.keys())}
        del fresh

        # --- B: resilience on the card
        eng = InferenceEngine(cache, {"data": image_shape()}, buckets=E["buckets"],
                              max_delay_ms=E["max_delay_ms"], health_window_s=E["health_window_s"])
        eng.start()
        one = requests[0][1]
        want = eng.infer(one)[0]
        with fi.inject("serving.dispatch", "raise", prob=1.0, seed=SEED, times=1) as plan:
            again = eng.infer(one, timeout=60)[0]
        h = eng.health()
        check(plan.fired == 1 and np.array_equal(again, want), "a retried batch differs")
        check(h["state"] == "degraded" and h["recent_dispatch_errors"] == 1, ("health", h))
        time.sleep(E["health_window_s"] + 0.1)
        check(eng.health()["state"] == "healthy", "health did not recover")
        out["retry"] = {"fired": plan.fired, "retries": tm.counters()["serving.dispatch_retries"],
                        "health_after_fault": h["state"]}
        four = {"data": np.repeat(one["data"][:1], 4, axis=0)}
        shed = []
        with fi.inject("serving.dispatch", "delay_ms", prob=1.0, seed=SEED, arg=100, times=1):
            n0 = tm.counters()["serving.batches"]
            futs = [eng.submit(four) for _ in range(40)]  # five full batches
            t_end = time.time() + 30
            while tm.counters()["serving.batches"] < n0 + 2 and time.time() < t_end:
                time.sleep(0.001)
            for _ in range(8):
                try:
                    eng.submit({"data": four["data"][:1]}, deadline_ms=1)
                except ServeOverloadError as exc:
                    shed.append(exc.retry_after_ms)
            h = eng.health()
            for f in futs:
                f.result(60)
        check(len(shed) == 8 and all(r >= 1 for r in shed), ("shed", shed))
        check(h["state"] == "degraded" and h["recent_sheds"] == 8, ("health after shedding", h))
        out["shed"] = {"shed": len(shed), "retry_after_ms": shed, "health": h["state"],
                       "shed_rate": h["shed_rate"]}
        new_args, new_aux = resnet_values(net, seed=SEED + 23)
        load = image_requests(SEED + 24, E["clients"] // 2, E["reload_requests"], (4, 4))
        first = len(rec.batches)
        reload_at = {}

        def reload_mid_load():
            t_end = time.time() + 60
            while len(rec.batches) - first < 2 and time.time() < t_end:
                time.sleep(0.001)
            reload_at["call"] = time.perf_counter()
            fut = eng.reload(new_args, new_aux)
            reload_at["returned"] = time.perf_counter()
            check(fut.result(60) is True, "reload failed")
            reload_at["resolved"] = time.perf_counter()

        th = threading.Thread(target=reload_mid_load)
        th.start()
        got = clients(eng, load)
        th.join()
        check("resolved" in reload_at, "the reload did not resolve")
        check(cache.binds == warm_binds, ("binds after the reload", cache.binds))
        where = check_rows(rec, load, got)
        ref = {0: PersistentExecutableCache(net, args, aux), 1: PersistentExecutableCache(
            net, new_args, new_aux)}
        old = new = 0
        for key, b in where.items():
            _, t_start, t_end, _ = got[key]
            version = rec.batches[b][2]  # 0: the old weights, 1: the new
            if t_end < reload_at["call"]:
                check(version == 0, ("a request before the reload ran the new weights", key))
                old += 1
            elif t_start > reload_at["resolved"]:
                check(version == 1, ("a request after the reload ran the old weights", key))
                new += 1
        check(old and new, ("requests before / after the reload", old, new))
        versions = {}
        for inputs, outs, v in rec.batches[first:]:
            versions[v] = versions.get(v, 0) + 1
            check(all(np.array_equal(a, b) for a, b in zip(outs, ref[v].run(inputs))),
                  ("a batch differs from a fresh cache with its weights", v))
        h = eng.health()
        check(h["reloads"] == 1 and h["state"] in ("healthy", "degraded"), ("health", h))
        eng.close()
        out["reload"] = {"requests": len(got), "before": old, "after": new,
                         "batches_by_version": versions, "binds": cache.binds,
                         "reload_ms": (reload_at["resolved"] - reload_at["call"]) * 1e3,
                         "health": h["state"], "reloads": h["reloads"]}
        del ref, rec, cache, eng

        # --- C: the Transformer-base prefill graph through the engine
        from mxnet_tpu_torch.models import transformer

        P = SERVE["prefill_len"]
        sym = transformer.get_prefill_symbol(prefill_len=P, pos_len=SERVE["pos_len"], **MODEL)
        cache = PersistentExecutableCache(sym, params, {}, model_key="transformer_prefill",
                                          cache_dir=tmp)
        eng = InferenceEngine(cache, {"data": (P,)}, buckets=E["prefill_buckets"],
                              max_delay_ms=E["max_delay_ms"]).start()
        check(eng._row_factors == [P] + [1] * (2 * MODEL["num_layers"]),
              ("prefill row factors", eng._row_factors))
        rec = Recorder(cache)
        rs = np.random.RandomState(SEED + 25)
        treqs = [[{"data": rs.randint(1, MODEL["vocab_size"], (int(rs.randint(1, 4)), P))
                   .astype(np.float32)} for _ in range(3)] for _ in range(4)]
        ops.reset_launch_counts()
        got = clients(eng, treqs)
        tl = ops.launch_counts()
        nb = len(rec.batches)
        L = MODEL["num_layers"]
        check(tl == with_zeros({"flash_attention": L * nb, "norm_residual": (2 * L + 1) * nb,
                                "matmul_bias_act": L * nb}), ("prefill engine launches", nb, tl))
        check_rows(rec, treqs, got)
        tbitwise = rec.rerun_bitwise()
        check(tbitwise == nb, ("prefill batches bitwise on a second run", tbitwise, nb))
        for (t, i), (outs, _, _, _) in got.items():
            r = treqs[t][i]["data"].shape[0]
            check(outs[0].shape == (r * P, MODEL["vocab_size"]) and np.isfinite(outs[0]).all(),
                  ("prefill logits", outs[0].shape))
        eng.close()
        out["prefill"] = {"requests": len(got), "batches": nb, "launches": tl,
                          "batches_bitwise_on_rerun": tbitwise,
                          "launches_per_batch": {k: v // nb for k, v in tl.items() if v}}
        del rec, cache, eng

    # --- C': a decoder's weights reloaded under its captured megastep
    K, B = MEGASTEP_K, SERVE["batch"]
    prompt = np.random.RandomState(SEED + 1).randint(1, MODEL["vocab_size"], (B, PROMPT_LEN))
    dec = KVCacheDecoder(params, ctx=pt.gpu(0), **MODEL, **SERVE)
    dec.greedy(prompt, 1 + K, k=K)  # captures the K-step graph
    progs = dict(dec._megasteps)
    prog = next(iter(progs.values()))
    graph = prog._graph
    check(graph is not None, "no megastep graph was captured")
    new_params = random_params(SEED + 26)
    t0 = time.perf_counter()
    n_pf, n_dec = dec._pf_cache.swap_params(new_params), dec._dec_cache.swap_params(new_params)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    ops.reset_launch_counts()
    tokens = dec.greedy(prompt, 1 + K, k=K)
    check_launches("decoder reload", add_launches(prefill_launches(1, schedule="tiles"),
                                                  step_launches(K)))
    check(dict(dec._megasteps) == progs and prog._graph is graph, "the megastep was captured again")
    fresh = KVCacheDecoder(new_params, ctx=pt.gpu(0), **MODEL, **SERVE)
    want = fresh.greedy(prompt, 1 + K, k=K)
    check(np.array_equal(tokens, want), "reloaded decoder's tokens differ from a fresh decoder's")
    out["decoder_reload"] = {"k": K, "swapped": [n_pf, n_dec], "swap_ms": swap_ms,
                             "graphs": len(dec._megasteps), "tokens_equal_fresh": True}
    tm.set_mode(None)
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    return {"conv_bn_infer": sum(w["launches"]["conv_bn_infer"] for w in out["load"]),
            **{k: v for k, v in out["prefill"]["launches"].items() if v}}


def module_data(n):
    """n fixed images in U(-1, 1) and labels uniform over the classes."""
    rs = np.random.RandomState(SEED + 5)
    return (rs.uniform(-1, 1, (n,) + image_shape()).astype(np.float32),
            rs.randint(0, RESNET["num_classes"], (n,)).astype(np.float32))


def rel_diff(got, want):
    """The largest difference over the largest magnitude of ``want``."""
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) or 1.0)


class LogLines(logging.Handler):
    """Collects the messages the training loop and its callbacks log."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def collect_logs():
    handler, root = LogLines(), logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        root.removeHandler(handler)
        root.setLevel(level)


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables for a block (None removes one)."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def step_of(mod, batches, k=1):
    """A call that trains ``mod`` ``k`` steps (forward_backward, update),
    taking ``batches`` in turn from where the last call stopped."""
    i = [0]

    def fn():
        for _ in range(k):
            mod.forward_backward(batches[i[0] % len(batches)])
            mod.update()
            i[0] += 1
    return fn


def run_module(pt, net, args, aux, smi):
    """Phase 9: the Module.fit trunk. (a) ResNet-50 through ``Module.fit``
    against the manual executor + updater loop of phase 6; (b) the MNIST
    mlp and lenet through ``MNISTIter`` and ``Module.fit``, card against
    CPU, and ``FeedForward.fit`` against ``Module.fit``. Returns the launches
    of the phase's card runs, by kernel."""
    t_phase = time.perf_counter()
    check_tf32_off()
    out = {"phase": "module", "nvidia_smi": smi}
    # the unfused convs (conv0 and the stride-2 3x3s) on deterministic
    # cuDNN algorithms, so that two runs of the same steps give the same bits
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches = run_module_resnet(pt, net, args, aux, out)
        for k, v in run_module_mnist(pt, out).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["seconds"] = time.perf_counter() - t_phase
    out["budget_s"] = MODULE["budget_s"]
    out["within_budget"] = out["seconds"] <= MODULE["budget_s"]
    log(out)
    return launches


def run_module_resnet(pt, net, args, aux, out):
    """Phase 9a: ResNet-50 trained through ``Module.fit`` (metrics acc and
    top-5, a Speedometer, ``do_checkpoint`` each epoch) and by the manual
    loop from the same weights over the same 8 batches: the parameters and
    moving stats must agree within 1e-6 of each array's largest magnitude,
    the launches be the plan's, the checkpoint reload to the same outputs;
    then both steps timed in turns and by the profiler."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch import telemetry as tm

    B, nb, epochs = RESNET_TRAIN["batch"], MODULE["batches"], MODULE["epochs"]
    steps = nb * epochs
    images, labels = module_data(B * nb)
    names = [n for n in net.list_arguments() if n in args]

    def sched():
        return pt.lr_scheduler.FactorScheduler(step=MODULE["factor_step"],
                                               factor=MODULE["factor"])

    opt_params = (("learning_rate", RESNET_TRAIN["lr"]), ("momentum", RESNET_TRAIN["momentum"]),
                  ("wd", RESNET_TRAIN["wd"]), ("rescale_grad", 1.0 / B))

    # --- the manual loop (phase 6's step), over the same batches
    exe = net.simple_bind(pt.gpu(0), grad_req={n: "write" for n in args},
                          data=(B,) + image_shape(), softmax_label=(B,))
    exe.copy_params_from(args, aux)
    updater = pt.optimizer.get_updater(pt.optimizer.create(
        "sgd", lr_scheduler=sched(), sym=net, param_idx2name=dict(enumerate(names)),
        **dict(opt_params)))
    dev = pt.gpu(0).torch_device
    dev_images = torch.from_numpy(images).to(dev)
    dev_labels = torch.from_numpy(labels).to(dev)

    def manual_step(i):
        exe.arg_dict["data"]._tensor().copy_(dev_images[i * B:(i + 1) * B])
        exe.arg_dict["softmax_label"]._tensor().copy_(dev_labels[i * B:(i + 1) * B])
        exe.forward_backward()
        for k, n in enumerate(names):
            updater(k, exe.grad_dict[n], exe.arg_dict[n])

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for step in range(steps):
        manual_step(step % nb)
    torch.cuda.synchronize()
    manual_launches = ops.launch_counts()

    # --- Module.fit over an NDArrayIter on the card
    tmp = tempfile.mkdtemp(prefix="module_phase_")
    prefix = os.path.join(tmp, "resnet50")
    train = pt.io.NDArrayIter(images, labels, batch_size=B, shuffle=False)
    check(train.data[0][1].context == pt.gpu(0), "NDArrayIter's data is not on the card")
    mod = pt.mod.Module(net, context=pt.gpu(0))
    metric = pt.metric.create(["acc", pt.metric.TopKAccuracy(top_k=MODULE["top_k"])])
    saved_mode = tm.current_override()
    tm.set_mode("counters")
    tm.reset()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with collect_logs() as lines:
        mod.fit(train, eval_metric=metric, optimizer="sgd",
                optimizer_params=opt_params + (("lr_scheduler", sched()),),
                arg_params=args, aux_params=aux,
                batch_end_callback=pt.callback.Speedometer(B, frequent=nb // 2),
                epoch_end_callback=pt.callback.do_checkpoint(prefix), num_epoch=epochs)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = ops.launch_counts()
    input_bound_pct = tm.snapshot().get("io.input_bound_pct")
    tm.set_mode(saved_mode)
    expected = {"conv_bn": RESNET_SITES * steps, "conv_bn_bwd": RESNET_SITES * steps}
    check(fit_launches == with_zeros(expected), ("Module.fit launch counts", fit_launches))
    check(manual_launches == fit_launches, ("manual loop launch counts", manual_launches))
    speed_lines = [ln for ln in lines if "Speed:" in ln]
    # a Speedometer line a metric, once an epoch (frequent = half the batches)
    check(len(speed_lines) == epochs * len(metric.get_name_value()), ("Speedometer lines", lines))
    pt.nd.waitall()  # do_checkpoint's writes are queued on the engine
    check(os.path.exists("%s-%04d.params" % (prefix, epochs)), "no checkpoint of the last epoch")

    # --- the two runs' parameters and moving stats
    got_args, got_aux = mod.get_params()
    diffs = {}
    for n in names:
        diffs[n] = rel_diff(got_args[n].asnumpy(), exe.arg_dict[n].asnumpy())
    for n in exe.aux_dict:
        diffs[n] = rel_diff(got_aux[n].asnumpy(), exe.aux_dict[n].asnumpy())
    worst = max(diffs, key=diffs.get)
    differing = sorted(n for n, d in diffs.items() if d > 0)
    check(diffs[worst] <= 1e-6, ("Module.fit vs the manual loop", worst, diffs[worst]))
    moved = max(rel_diff(got_args[n].asnumpy(), args[n]) for n in names)
    check(moved > 0, "Module.fit did not change the weights")

    # --- score, and the checkpoint reloaded
    def score(m):
        outs = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = m.score(pt.io.NDArrayIter(images, labels, batch_size=B), "acc",
                      batch_end_callback=lambda p: outs.append(m.get_outputs()[0].asnumpy()))
        torch.cuda.synchronize()
        return res[0][1], outs, ops.launch_counts()

    acc, outs, score_launches = score(mod)
    check(score_launches == with_zeros({"conv_bn_infer": RESNET_SITES * nb}),
          ("score launch counts", score_launches))
    loaded = pt.mod.Module.load(prefix, epochs, context=pt.gpu(0))
    loaded.bind(data_shapes=train.provide_data, label_shapes=train.provide_label,
                for_training=False)
    acc2, outs2, _ = score(loaded)
    check(acc2 == acc and len(outs2) == len(outs) == nb
          and all(np.array_equal(a, b) for a, b in zip(outs, outs2)),
          ("the reloaded checkpoint scores otherwise", acc, acc2))
    del loaded

    # --- both steps in turns: host clock, then the profiler's card time
    train.reset()
    batches = list(train)

    def module_step(i):
        b = batches[i]
        mod.forward_backward(b)
        mod.update()
        mod.update_metric(metric, b.label)

    host = {"module": [], "manual": []}
    fns = {"module": module_step, "manual": manual_step}
    for r in range(MODULE["timed_steps"]):
        for kind in (("module", "manual") if r % 2 == 0 else ("manual", "module")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[kind](r % nb)
            torch.cuda.synchronize()
            host[kind].append((time.perf_counter() - t0) * 1e3)
    card = {}
    for kind in ("module", "manual", "module_again"):
        step_i = iter(range(1000))
        fn = fns[kind.split("_")[0]]
        card[kind] = profile_window(lambda: fn(next(step_i) % nb))
    module_ms = min(card["module"]["device_busy_ms"], card["module_again"]["device_busy_ms"])
    manual_ms = card["manual"]["device_busy_ms"]
    check(abs(module_ms - manual_ms) <= 0.05 * manual_ms,
          ("Module step card time vs the manual step's", module_ms, manual_ms))
    # the manual step on cuDNN's default algorithms, as phase 6 runs it: what
    # the deterministic ones cost the four unfused convs
    torch.backends.cudnn.deterministic = False
    step_i = iter(range(1000))
    card["manual_cudnn_default"] = profile_window(lambda: manual_step(next(step_i) % nb))
    torch.backends.cudnn.deterministic = True

    # --- where a Module step's host time goes
    parts = {k: [] for k in ("load_data_label", "forward_backward", "update", "update_metric")}
    group = mod._exec_group
    for i in range(MODULE["breakdown_steps"]):
        b = batches[i % nb]
        marks = []
        for fn in (lambda: group.load_data_label(b),
                   lambda: [ex.forward_backward() for ex in group.execs],
                   mod.update, lambda: mod.update_metric(metric, b.label)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            marks.append((time.perf_counter() - t0) * 1e3)
        for k, v in zip(parts, marks):
            parts[k].append(v)
    med = {k: float(np.median(v)) for k, v in parts.items()}
    total = sum(med.values())
    out["resnet"] = {
        "model": RESNET, "batch": B, "batches": nb, "epochs": epochs, "steps": steps,
        "optimizer": dict(opt_params, lr_scheduler="FactorScheduler(step=%d, factor=%g)"
                          % (MODULE["factor_step"], MODULE["factor"])),
        "fit_s": fit_s, "fit_launches": {k: v for k, v in fit_launches.items() if v},
        "score_launches": {k: v for k, v in score_launches.items() if v},
        "module_vs_manual_worst": diffs[worst], "module_vs_manual_worst_array": worst,
        "arrays_not_bitwise": differing, "arrays_compared": len(diffs),
        "weights_moved_rel": moved, "train_metric": metric.get_name_value(),
        "score_acc": acc, "reloaded_score_acc": acc2, "reloaded_outputs_bitwise": True,
        "speedometer": speed_lines, "io_input_bound_pct": input_bound_pct,
        "step_ms": {k: {"p50": float(np.percentile(v, 50)), "p80": float(np.percentile(v, 80)),
                        "all": v} for k, v in host.items()},
        "card": {k: {f: v[f] for f in ("device_busy_ms", "device_idle_share", "wall_ms",
                                       "port_kernels_ms", "port_kernel_launches")}
                 for k, v in card.items()},
        "card_ms_module_over_manual": module_ms / manual_ms,
        "breakdown_ms": med, "breakdown_share": {k: v / total for k, v in med.items()},
    }
    del exe, mod, dev_images, dev_labels, train, batches
    shutil.rmtree(tmp)
    return {"conv_bn": fit_launches["conv_bn"], "conv_bn_bwd": fit_launches["conv_bn_bwd"],
            "conv_bn_infer": score_launches["conv_bn_infer"]}


# copied from example/image-classification/train_mnist.py (_synthetic_mnist)
def synthetic_mnist(n, num_classes, seed):
    """Deterministic stand-in when the real idx files are absent: each class
    is a distinct blocky template + noise, so models actually converge (the
    templates are fixed across train/val; only the noise seed differs)."""
    templates = np.random.RandomState(12345).rand(num_classes, 28, 28) > 0.7
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, num_classes, (n,)).astype(np.float32)
    imgs = templates[labels.astype(int)].astype(np.float32) * 255
    imgs += rs.normal(0, 32, imgs.shape)
    return labels, np.clip(imgs, 0, 255).astype(np.uint8)


def write_idx(path, arr):
    """An unsigned-byte idx file (MNIST's layout: magic, dims, data)."""
    with open(path, "wb") as f:
        f.write(struct.pack(">I", (0x08 << 8) | arr.ndim))
        f.write(struct.pack(">%dI" % arr.ndim, *arr.shape))
        f.write(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())


def run_module_mnist(pt, out):
    """Phase 9b: mlp and lenet through MNISTIter and Module.fit on the card
    and on the CPU from the same Xavier weights drawn on the CPU generator:
    final parameters within rtol 1e-4, atol 1e-5, validation accuracy over
    0.9, matmul_bias_act's launches the plan's; FeedForward.fit of mlp
    equal to Module.fit with the same arguments."""
    from mxnet_tpu_torch import ops

    tmp = tempfile.mkdtemp(prefix="module_mnist_")
    files = {}
    for split, n, seed in (("train", MODULE["mnist_train"], 0), ("val", MODULE["mnist_val"], 1)):
        lbl, img = synthetic_mnist(n, 10, seed)
        files[split] = (os.path.join(tmp, "%s-images-idx3-ubyte" % split),
                        os.path.join(tmp, "%s-labels-idx1-ubyte" % split))
        write_idx(files[split][0], img)
        write_idx(files[split][1], lbl.astype(np.uint8))
    Bm, epochs = MODULE["mnist_batch"], MODULE["mnist_epochs"]
    steps = (MODULE["mnist_train"] // Bm) * epochs
    val_batches = (MODULE["mnist_val"] // Bm) * epochs

    def iters():
        np.random.seed(SEED + 6)  # MNISTIter shuffles with numpy's global stream
        return (pt.io.MNISTIter(*files["train"], batch_size=Bm, shuffle=True),
                pt.io.MNISTIter(*files["val"], batch_size=Bm, shuffle=False))

    def optimizer(net):
        names = [n for n in net.list_arguments() if n not in ("data", "softmax_label")]
        opt = pt.optimizer.create("sgd", learning_rate=MODULE["mnist_lr"],
                                  momentum=MODULE["mnist_momentum"], rescale_grad=1.0 / Bm,
                                  sym=net, param_idx2name=dict(enumerate(names)))
        opt.set_lr_mult({"fc1_weight": MODULE["fc1_lr_mult"]})
        return opt

    def xavier():
        return pt.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)

    launches = {"matmul_bias_act": 0}
    out["mnist"] = {"train_images": MODULE["mnist_train"], "val_images": MODULE["mnist_val"],
                    "batch": Bm, "epochs": epochs}
    for name in ("mlp", "lenet"):
        net = getattr(pt.models, name).get_symbol(num_classes=10)
        pt.random.seed(SEED + 7)
        with pt.cpu():
            shapes = net.infer_shape(data=(Bm, 1, 28, 28), softmax_label=(Bm,))[0]
            params = {}
            for n, shape in zip(net.list_arguments(), shapes):
                if n not in ("data", "softmax_label"):
                    params[n] = pt.nd.zeros(shape)
                    xavier()(pt.init.InitDesc(n), params[n])
        runs = []
        for ctx in (pt.gpu(0), pt.cpu()):
            with ctx:
                train, val = iters()
                mod = pt.mod.Module(net, context=ctx)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                mod.fit(train, eval_data=val, eval_metric="acc", optimizer=optimizer(net),
                        arg_params=params, num_epoch=epochs)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                got = ops.launch_counts()
                acc = mod.score(val, "acc")[0][1]
                runs.append(({n: a.asnumpy() for n, a in mod.get_params()[0].items()},
                             acc, got, seconds))
        card, cpu = runs
        expected = {"matmul_bias_act": MNIST_SITES[name] * (steps + val_batches)}
        check(card[2] == with_zeros(expected), ("%s Module.fit launches" % name, card[2]))
        check(cpu[2] == with_zeros({}), ("%s CPU launches" % name, cpu[2]))
        check(card[1] > 0.9 and cpu[1] > 0.9, ("%s validation accuracy" % name, card[1], cpu[1]))
        errs = {n: float(np.abs(card[0][n] - cpu[0][n]).max()) for n in card[0]}
        bad = [n for n in card[0]
               if not np.allclose(card[0][n], cpu[0][n], rtol=1e-4, atol=1e-5)]
        check(not bad, ("%s card vs CPU parameters" % name, bad, errs))
        launches["matmul_bias_act"] += card[2]["matmul_bias_act"]
        out["mnist"][name] = {"val_acc_card": card[1], "val_acc_cpu": cpu[1],
                              "steps": steps, "forward_only_batches": val_batches,
                              "launches": {k: v for k, v in card[2].items() if v},
                              "card_vs_cpu_max_abs_err": max(errs.values()),
                              "fit_s_card": card[3], "fit_s_cpu": cpu[3]}

        if name == "mlp":
            # FeedForward.fit against Module.fit with the same arguments
            with pt.gpu(0):
                train, _ = iters()
                ff = pt.model.FeedForward(net, ctx=pt.gpu(0), num_epoch=1,
                                          optimizer=optimizer(net), initializer=xavier(),
                                          arg_params=params, aux_params={})
                ff.fit(train)
                train, _ = iters()
                mod = pt.mod.Module(net, context=pt.gpu(0))
                mod.fit(train, optimizer=optimizer(net), initializer=xavier(), arg_params=params,
                        aux_params={}, allow_missing=True, num_epoch=1)
                want = mod.get_params()[0]
                ff_diff = max(rel_diff(ff.arg_params[n].asnumpy(), want[n].asnumpy())
                              for n in want)
            check(ff_diff <= 1e-6, ("FeedForward.fit vs Module.fit", ff_diff))
            out["mnist"]["feedforward_vs_module_worst"] = ff_diff
    shutil.rmtree(tmp)
    return launches


# ------------------------------------------------------------- phases 10-12
def zoo_values(net, data_shape, seed):
    """Random weights of an image classifier from the seed: He-scaled conv
    and fc weights, γ in U(0.5, 1.5), β in U(-0.1, 0.1), biases 0; moving
    means 0 and variances 1, as a fresh model has them."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=(1,) + tuple(data_shape),
                                                softmax_label=(1,))
    rs = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = rs.uniform(0.5, 1.5, s)
        elif n.endswith("_beta"):
            v = rs.uniform(-0.1, 0.1, s)
        elif n.endswith("_bias"):
            v = np.zeros(s)
        else:
            v = rs.standard_normal(s) * math.sqrt(2.0 / np.prod(s[1:]))
        args[n] = v.astype(np.float32)
    aux = {n: (np.ones(s) if n.endswith("_var") else np.zeros(s)).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def zoo_batch(B, image, classes, seed):
    """One fixed batch: images in U(-1, 1), labels uniform over the classes."""
    rs = np.random.RandomState(seed)
    return (rs.uniform(-1, 1, (B,) + tuple(image)).astype(np.float32),
            rs.randint(0, classes, (B,)).astype(np.float32))


def fused_site_shapes(net, data_shape):
    """The conv+BN plan's fused sites of ``net`` at ``data_shape``, as
    {(K, H, W, N, kernel, stride, prologue): sites} with the sites the shape
    gate takes, and the count of sites it declines."""
    from collections import Counter

    from mxnet_tpu_torch import fusion
    from mxnet_tpu_torch import symbol as psymbol
    from mxnet_tpu_torch.ops import conv_bn as cb

    topo = net._topo()
    plan = fusion.plan(topo, output_ids={id(n) for n, _ in net._outputs})
    arg_s, _, aux_s = net.infer_shape(data=tuple(data_shape), softmax_label=(data_shape[0],))
    known = dict(zip(net.list_arguments(), arg_s))
    known.update(zip(net.list_auxiliary_states(), aux_s))
    shapes, sites, declined = {}, Counter(), 0
    for node in topo:
        if node.is_variable:
            shapes[(id(node), 0)] = tuple(known[node.name])
            continue
        ins = tuple(shapes[(id(i), oi)] for i, oi in node.inputs)
        res = psymbol._eval_node_shape(node.op, psymbol._freeze(node.parsed_attrs()), ins,
                                       ("float32",) * len(ins), psymbol._aux_positions(node))
        for k, (sh, _) in enumerate(res):
            shapes[(id(node), k)] = sh
        d = plan.get(id(node))
        if d is None or d["kind"] != "conv":
            continue
        x, w = ins[0], ins[1]
        if not cb.supported(x, w, d["stride"]):
            declined += 1
            continue
        prologue = plan.get(id(node.inputs[0][0]), {}).get("kind") == "relu_fold"
        sites[(x[1], x[2], x[3], w[0], w[2], d["stride"][0], prologue)] += 1
    return sites, declined


def check_zoo_conv_shapes(randn, peaks, shapes, B):
    """Phase 10: each distinct fused conv site shape of a zoo net at batch
    ``B``, forward (with statistics, and stats-free) and backward, against
    the plain versions on the card; each timed between CUDA events against
    ``F.conv2d`` of the normalised input and ``aten.convolution_backward``,
    and against its bound. Returns the shapes' records."""
    from mxnet_tpu_torch.ops import conv_bn as cb

    it = ZOO["conv_iters"]
    recs = []
    for (K, H, W, N, kernel, stride, prologue), sites in sorted(shapes.items()):
        x, w, scale, shift, _, (Ho, Wo) = conv_case(randn, B, K, H, W, N, kernel, stride,
                                                    prologue, False)
        st = (stride, stride)
        got = cb.conv_block(x, w, scale, shift, None, st, prologue)
        want = cb.conv_block_plain(x, w, scale, shift, None, st, prologue)
        infer = cb.conv_block_infer(x, w, scale, shift, st, prologue)
        infer_want = cb.conv_block_infer_plain(x, w, scale, shift, st, prologue)
        dc, ds, dq = randn(B, N, Ho, Wo), randn(N, scale=0.01), randn(N, scale=1e-3)
        args = (x, w, scale, shift, want[0], dc, ds, dq, st, prologue, False)
        gb, pb = cb.conv_block_bwd(*args), cb.conv_block_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {"c": rel_err(got[0], want[0]), "c_infer": rel_err(infer, infer_want),
                "ssum": rel_err(got[1], want[1]), "ssq": rel_err(got[2], want[2])}
        for name, g, p in zip(("dx", "dw", "dscale", "dshift", "dres"), gb, pb):
            check((g is None) == (p is None), ("conv_bn_bwd outputs", name))
            if g is not None:
                errs[name] = rel_err(g, p)
        for name, e in errs.items():
            tol = CONV_TOL["elementwise" if name in ("c", "c_infer", "dx") else "sums"]
            check(math.isfinite(e) and e <= tol, ("zoo conv kernels", name, B, K, H, W, N,
                                                  kernel, e))
        flops = cb.flops(x.shape, w.shape, st)
        xn = cb._prologue(x, scale, shift, prologue)
        pad = (kernel - 1) // 2
        dce = dc + ds.reshape(1, -1, 1, 1) + 2.0 * got[0] * dq.reshape(1, -1, 1, 1)
        fb, fby, _ = product_bound(flops, conv_bytes(x, w, scale, shift, got[0]) + 8.0 * N, peaks)
        bb, bby, _ = product_bound(2.0 * flops, conv_bytes(x, w, scale, shift, got[0], dc, ds,
                                                           dq, *gb), peaks)
        rec = {"phase": "kernel", "name": "conv_bn_zoo", "shape": [B, K, H, W, N, kernel, stride],
               "prologue": prologue, "sites": sites, "rel_err": errs,
               "event_ms": event_ms(lambda: cb.conv_block(x, w, scale, shift, None, st,
                                                          prologue), it),
               "infer_event_ms": event_ms(lambda: cb.conv_block_infer(x, w, scale, shift, st,
                                                                      prologue), it),
               "plain_event_ms": event_ms(lambda: cb.conv_block_plain(x, w, scale, shift, None,
                                                                      st, prologue), it),
               "library_event_ms": event_ms(lambda: F.conv2d(xn, w, stride=st, padding=pad), it),
               "bound_ms": fb, "bound_by": fby,
               "bwd_event_ms": event_ms(lambda: cb.conv_block_bwd(*args), it),
               "bwd_plain_event_ms": event_ms(lambda: cb.conv_block_bwd_plain(*args), it),
               "bwd_library_event_ms": event_ms(lambda: torch.ops.aten.convolution_backward(
                   dce, xn, w, None, list(st), [pad, pad], [1, 1], False, [0, 0], 1,
                   [True, True, False]), it),
               "bwd_bound_ms": bb, "bwd_bound_by": bby}
        rec["over_library"] = rec["event_ms"] / rec["library_event_ms"]
        rec["bwd_over_library"] = rec["bwd_event_ms"] / rec["bwd_library_event_ms"]
        log(rec)
        recs.append(rec)
        del x, w, got, want, infer, gb, pb, xn, dce, dc
    return recs


def fit_timed(mod, train, per_epoch, epochs, opt_params, arg_params, aux_params, metric):
    """``Module.fit`` over ``train`` (``per_epoch`` batches an epoch) with a
    synchronize at each batch's end: (host ms a step, the training metric at
    the end of each epoch)."""
    marks, epoch_metric = [time.perf_counter()], []

    def batch_end(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if param.nbatch == per_epoch - 1:
            epoch_metric.append(float(param.eval_metric.get()[1]))

    mod.fit(train, eval_metric=metric, optimizer="sgd", optimizer_params=opt_params,
            arg_params=arg_params, aux_params=aux_params, batch_end_callback=batch_end,
            num_epoch=epochs)
    return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])], epoch_metric


def run_inception(pt, name, smi, randn, peaks):
    """Phase 10a: an Inception net at its published widths: the kernel
    shapes of its fused sites, serving at batch 32 and 1, card vs CPU at
    batch 2 (inference, and a training step), and Module.fit at batch 32."""
    from mxnet_tpu_torch import models, ops

    cfg, B, Bc = INCEPTION[name], ZOO["batch"], ZOO["check_batch"]
    t_phase = time.perf_counter()
    net = models.get_symbol(name, num_classes=1000)
    args, aux = zoo_values(net, cfg["image"], SEED + 30)
    n_params = sum(int(v.size) for v in args.values())
    shapes, declined = fused_site_shapes(net, (B,) + cfg["image"])
    sites = sum(shapes.values())
    check(sites == cfg["sites"] and declined == 0, ("%s fused sites" % name, sites, declined))
    out = {"phase": "zoo_" + name.replace("-", "_"), "nvidia_smi": smi,
           "image": cfg["image"], "params": n_params, "fused_sites": sites,
           "distinct_site_shapes": len(shapes)}
    if cfg.get("check_shapes"):
        recs = check_zoo_conv_shapes(randn, peaks, shapes, B)
        out["shapes_over_library"] = {"fwd_worst": max(r["over_library"] for r in recs),
                                      "bwd_worst": max(r["bwd_over_library"] for r in recs),
                                      "fwd_losing": sum(r["over_library"] > 1 for r in recs),
                                      "bwd_losing": sum(r["bwd_over_library"] > 1 for r in recs)}
    images, labels = zoo_batch(B * cfg["fit_batches"], cfg["image"], 1000, SEED + 31)

    # --- serving at batch 32 and 1
    for Bs in (B, 1):
        exe = resnet_bind(pt, net, pt.gpu(0), Bs, args, aux, "null", images, labels)
        for _ in range(2):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        prob = exe.forward(is_train=False)[0].asnumpy()
        launches = ops.launch_counts()
        check(launches == with_zeros({"conv_bn_infer": sites}),
              ("%s inference launch counts" % name, Bs, launches))
        check(prob.shape == (Bs, 1000) and np.isfinite(prob).all()
              and np.allclose(prob.sum(axis=1), 1.0, atol=1e-4), ("%s probabilities" % name, Bs))
        lat = []
        for _ in range(ZOO["serve_iters"]):
            t0 = time.perf_counter()
            exe.forward(is_train=False)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(lat))
        card = profile_window(lambda: exe.forward(is_train=False))
        out["serve_batch%d" % Bs] = {
            "launches": {k: v for k, v in launches.items() if v}, "latency_ms_p50": med,
            "latency_ms_p80": float(np.percentile(lat, 80)), "images_per_s": Bs * 1e3 / med,
            "device_busy_ms": card["device_busy_ms"],
            "device_idle_share": card["device_idle_share"],
            "port_kernels_ms": card["port_kernels_ms"]}
        del exe
    probs = [resnet_bind(pt, net, ctx, Bc, args, aux, "null", images, labels).forward(
        is_train=False)[0].asnumpy() for ctx in (pt.gpu(0), pt.cpu())]
    err = float(np.abs(probs[0] - probs[1]).max())
    check(np.allclose(probs[0], probs[1], rtol=1e-3, atol=1e-6), ("%s card vs CPU probs" % name,
                                                                  err))
    out["serve_card_vs_cpu_max_abs_err"] = err

    # --- one training step at batch 2, card vs CPU (phase 6's check)
    out["train_check"] = cnn_train_check(pt, net, args, aux, images, labels, Bc,
                                         "zoo_%s_train_check" % name.replace("-", "_"),
                                         distance="fro")

    # --- Module.fit at batch 32 over fixed batches
    with pt.gpu(0):
        train = pt.io.NDArrayIter(images, labels, batch_size=B, shuffle=False)
    mod = pt.mod.Module(net, context=pt.gpu(0))
    opt = (("learning_rate", ZOO["lr"]), ("momentum", ZOO["momentum"]), ("wd", ZOO["wd"]),
           ("rescale_grad", 1.0 / B))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    steps = cfg["fit_batches"] * cfg["fit_epochs"]
    t0 = time.perf_counter()
    step_ms, ce = fit_timed(mod, train, cfg["fit_batches"], cfg["fit_epochs"], opt, args, aux,
                            pt.metric.create("ce"))
    fit_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches == with_zeros({"conv_bn": sites * steps, "conv_bn_bwd": sites * steps}),
          ("%s Module.fit launch counts" % name, launches))
    check(len(ce) == cfg["fit_epochs"] and all(math.isfinite(v) for v in ce) and ce[-1] < ce[0],
          ("%s: the training loss did not fall" % name, ce))
    moved = {n: float(np.abs(a.asnumpy() - aux[n]).max()) for n, a in mod.get_params()[1].items()}
    check(all(v > 0 for v in moved.values()), ("%s moving stats unchanged" % name))
    train.reset()
    batch = next(iter(train))

    def step():
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()

    card = profile_window(step)
    timed = step_ms[1:]  # the first step binds nothing but warms the allocator
    p50 = float(np.percentile(timed, 50))
    out["fit"] = {"batch": B, "batches": cfg["fit_batches"], "epochs": cfg["fit_epochs"],
                  "launches": {k: v for k, v in launches.items() if v},
                  "epoch_cross_entropy": ce, "step_ms_p50": p50,
                  "step_ms_p80": float(np.percentile(timed, 80)), "step_ms": step_ms,
                  "images_per_s": B * 1e3 / p50, "fit_s": fit_s,
                  "device_busy_ms": card["device_busy_ms"],
                  "device_idle_share": card["device_idle_share"],
                  "port_kernel_ms": card["port_kernel_ms"],
                  "port_kernel_launches": card["port_kernel_launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    del mod, train
    return launches


def run_classifier(pt, name, smi):
    """Phase 10b: AlexNet or VGG-16 at 224 x 224: kernel 6 at the fc sites of
    an inference forward at batch 32; card vs CPU at batch 2 (inference, and
    a training step with every Dropout's p at 0); two training steps at p =
    0.5 from the same seed give the same bits, the kept fraction within 4σ
    of 0.5; timed training steps."""
    from mxnet_tpu_torch import models, ops, optimizer

    t_phase = time.perf_counter()
    B, Bc, image, fc = ZOO["batch"], ZOO["check_batch"], CLASSIFIERS[name], CLASSIFIER_FC_SITES
    net = models.get_symbol(name, num_classes=1000)
    args, aux = zoo_values(net, image, SEED + 40)
    images, labels = zoo_batch(B, image, 1000, SEED + 41)
    out = {"phase": "zoo_" + name, "nvidia_smi": smi, "params": sum(int(v.size) for v in
                                                                     args.values())}
    exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, "null", images, labels)
    exe.forward(is_train=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    prob = exe.forward(is_train=False)[0].asnumpy()
    infer_launches = ops.launch_counts()
    check(infer_launches == with_zeros({"matmul_bias_act": fc}),
          ("%s inference launches" % name, infer_launches))
    check(np.isfinite(prob).all() and np.allclose(prob.sum(1), 1.0, atol=1e-4),
          ("%s probabilities" % name))
    lat = []
    for _ in range(ZOO["serve_iters"]):
        t0 = time.perf_counter()
        exe.forward(is_train=False)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    out["serve_batch32"] = {"latency_ms_p50": float(np.median(lat)),
                            "images_per_s": B * 1e3 / float(np.median(lat))}
    del exe
    probs = [resnet_bind(pt, net, ctx, Bc, args, aux, "null", images, labels).forward(
        is_train=False)[0].asnumpy() for ctx in (pt.gpu(0), pt.cpu())]
    err = float(np.abs(probs[0] - probs[1]).max())
    check(np.allclose(probs[0], probs[1], rtol=1e-3, atol=1e-6), ("%s card vs CPU" % name, err))
    out["serve_card_vs_cpu_max_abs_err"] = err
    graph = json.loads(net.tojson())
    for node in graph["nodes"]:
        if node["op"] == "Dropout":
            node["attr"]["p"] = "0"
    out["train_check_p0"] = cnn_train_check(pt, pt.sym.load_json(json.dumps(graph)), args, aux,
                                            images, labels, Bc, "zoo_%s_train_check" % name,
                                            fc_relus=True, distance="fro")

    # --- training at p = 0.5: the same seed, the same bits
    op = pt.ops.registry.get_op("Dropout")
    orig, kept = op.fn, []

    def recording(attrs, data, is_train=False, rng=None):
        y = orig(attrs, data, is_train=is_train, rng=rng)
        if is_train:
            kept.append((int((y != 0).sum()), int((data != 0).sum())))
        return y

    reqs = {n: "write" for n in args}
    names = [n for n in net.list_arguments() if n in args]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    op.fn = recording
    try:
        exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, reqs, images, labels)
        runs = []
        for _ in range(2):
            pt.random.seed(SEED + 42)
            exe.forward_backward()
            runs.append(({n: exe.grad_dict[n].asnumpy() for n in names},
                         exe.outputs[0].asnumpy()))
        check(all(np.array_equal(runs[0][0][n], runs[1][0][n]) for n in names)
              and np.array_equal(runs[0][1], runs[1][1]),
              ("%s: two steps from the same seed differ" % name))
        n_kept = sum(k for k, _ in kept[:2])
        n_in = sum(n for _, n in kept[:2])
        frac = n_kept / n_in
        check(abs(frac - 0.5) <= 4 * math.sqrt(0.25 / n_in), ("%s kept fraction" % name, frac))
        opt = optimizer.create("sgd", learning_rate=ZOO["lr"], momentum=ZOO["momentum"],
                               wd=ZOO["wd"], rescale_grad=1.0 / B,
                               param_idx2name=dict(enumerate(names)))
        updater = optimizer.get_updater(opt)

        def step():
            exe.forward_backward()
            for i, n in enumerate(names):
                updater(i, exe.grad_dict[n], exe.arg_dict[n])
            torch.cuda.synchronize()

        step()
        ops.reset_launch_counts()
        step_ms = []
        for _ in range(ZOO["cls_steps"]):
            t0 = time.perf_counter()
            step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = ops.launch_counts()
        check(launches == with_zeros({"matmul_bias_act": fc * ZOO["cls_steps"]}),
              ("%s training launches" % name, launches))
        card = profile_window(step)
    finally:
        op.fn = orig
        torch.backends.cudnn.deterministic = deterministic
    p50 = float(np.median(step_ms))
    out["train"] = {"dropout_kept_fraction": frac, "dropout_elements": n_in,
                    "same_seed_bitwise": True, "step_ms_p50": p50, "step_ms": step_ms,
                    "images_per_s": B * 1e3 / p50, "launches": {k: v for k, v in launches.items()
                                                                 if v},
                    "device_busy_ms": card["device_busy_ms"],
                    "device_idle_share": card["device_idle_share"],
                    "port_kernel_ms": card["port_kernel_ms"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    del exe
    return {k: v + infer_launches[k] for k, v in launches.items()}


def check_fc_kernels(randn, peaks, entries):
    """Phase 10c: kernel 6 at AlexNet's and VGG-16's classifier shapes
    (batch 32), against its plain version, ``addmm`` + relu and its bound,
    each timed between CUDA events (as the zoo's conv shapes are: a
    profiler window taken this late in the run came back empty six times
    in a row in one run)."""
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    rows = []
    for Mr, K, N in FC_SHAPES:
        a, w, b = randn(Mr, K), randn(N, K, scale=1.0 / math.sqrt(K)), randn(N, scale=0.1)
        c, pc = mba.matmul_bias_act(a, w, b, "relu"), mba.matmul_bias_act_plain(a, w, b, "relu")
        torch.cuda.synchronize()
        err = float((c - pc).abs().max())
        check(math.isfinite(err) and err <= TOL["matmul_bias_act"], ("zoo fc", Mr, K, N, err))
        ms = event_ms(lambda: mba.matmul_bias_act(a, w, b, "relu"), 10)
        plain_ms = event_ms(lambda: mba.matmul_bias_act_plain(a, w, b, "relu"), 10)
        lib_ms = event_ms(lambda: torch.relu(torch.addmm(b, a, w.t())), 10)
        b_ms, b_by, f32_ms = product_bound(2.0 * Mr * N * K + 2.0 * Mr * N,
                                           4.0 * (Mr * K + N * K + N + Mr * N), peaks)
        rec = {"phase": "kernel", "name": "matmul_bias_act_zoo_fc", "shape": [Mr, K, N],
               "max_abs_err": err, "event_ms": ms, "plain_event_ms": plain_ms,
               "library_event_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "f32_bound_ms": f32_ms,
               "schedule": mba._schedule(Mr, N, K), "over_library": ms / lib_ms}
        log(rec)
        rows.append(rec)
        entries["matmul_bias_act"]["zoo_fc_%d_event_ms" % K] = ms
        entries["matmul_bias_act"]["zoo_fc_%d_library_event_ms" % K] = lib_ms
        entries["matmul_bias_act"]["zoo_fc_%d_bound_ms" % K] = b_ms
    return rows


def run_zoo_cnn(pt, smi, peaks, entries):
    """Phase 10: the zoo's image classifiers. Returns their launches."""
    dev = pt.gpu(0).torch_device
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    check_tf32_off()
    t_phase = time.perf_counter()
    launches = {}
    for name in INCEPTION:
        for k, v in run_inception(pt, name, smi, randn, peaks).items():
            launches["%s:%s" % (name, k)] = v
    check_fc_kernels(randn, peaks, entries)
    for name in CLASSIFIERS:
        for k, v in run_classifier(pt, name, smi).items():
            launches["%s:%s" % (name, k)] = v
    check_tf32_off()
    log({"phase": "zoo_cnn", "seconds": time.perf_counter() - t_phase})
    return launches


def mt_params(net, B, seed=SEED + 50):
    """Random MT weights from the seed (as ``random_params``) and its fixed
    batch of source, target and label tokens."""
    L = MT["src_len"]
    shapes = net.infer_shape(data=(1, L), dec_data=(1, MT["tgt_len"]),
                             softmax_label=(1, MT["tgt_len"]))[0]
    rs = np.random.RandomState(seed)
    params = {n: (rs.standard_normal(s) * 0.05).astype(np.float32)
              for n, s in zip(net.list_arguments(), shapes)
              if n not in ("data", "dec_data", "softmax_label")}
    V = MT["vocab_size"]
    tgt = rs.randint(0, V, (B, MT["tgt_len"] + 1)).astype(np.float32)
    batch = {"data": rs.randint(0, V, (B, L)).astype(np.float32), "dec_data": tgt[:, :-1],
             "softmax_label": tgt[:, 1:]}
    return params, batch


def run_mt(pt, smi):
    """Phase 11: the MT Transformer (``get_symbol_mt`` at its defaults)
    trained at batch 32: card vs CPU at batch 2, launches of kernels 1-6
    the plan's, the loss falls, step time, card time and idle share."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.models import transformer

    t_phase = time.perf_counter()
    cfg = {k: MT[k] for k in ("vocab_size", "num_layers", "num_heads", "model_dim", "ffn_dim",
                              "src_len", "tgt_len")}
    net = transformer.get_symbol_mt(**cfg)
    B, Bc, L = MT["batch"], MT["check_batch"], MT["num_layers"]
    params, batch = mt_params(net, B)
    reqs = {n: "write" for n in params}

    def bind(ctx, rows):
        exe = net.simple_bind(ctx, grad_req=reqs, data=(rows, MT["src_len"]),
                              dec_data=(rows, MT["tgt_len"]), softmax_label=(rows, MT["tgt_len"]))
        for n, a in exe.arg_dict.items():
            a[:] = params[n] if n in params else batch[n][:rows]
        return exe

    def loss_of(exe, rows):
        prob = exe.outputs[0]._tensor()
        lab = torch.as_tensor(batch["softmax_label"][:rows].reshape(-1, 1),
                              device=prob.device).long()
        return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())

    # one step at batch 2 on the card and on the CPU, the CPU pinned to the
    # card's side at every ffn ReLU kink the two split (phase 4's check)
    small = [bind(ctx, Bc) for ctx in (pt.gpu(0), pt.cpu())]
    card_ys = []
    with relu_decisions(record=card_ys):
        small[0].forward_backward()
    torch.cuda.synchronize()
    with relu_decisions(pinned=card_ys) as flips:
        small[1].forward_backward()
    n_flips, flip_dy = sum(n for n, _ in flips), max(d for _, d in flips)
    check(n_flips <= 1e-5 * sum(y.numel() for y in card_ys) and flip_dy <= 1e-5,
          ("MT ReLU decisions that differ beyond kinks", n_flips, flip_dy))
    losses_small = [loss_of(e, Bc) for e in small]
    check(abs(losses_small[0] - losses_small[1]) <= 1e-3 * max(1.0, abs(losses_small[1])),
          ("MT card vs CPU loss", losses_small))
    worst_name, worst_rel = None, 0.0
    for n in params:
        got, want = small[0].grad_dict[n].asnumpy(), small[1].grad_dict[n].asnumpy()
        scale = float(np.abs(want).max())
        check(np.isfinite(got).all(), ("non-finite MT card gradient", n))
        check(np.allclose(got, want, rtol=1e-3, atol=1e-3 * scale), ("MT card vs CPU grad", n))
        rel = float(np.abs(got - want).max()) / (scale or 1.0)
        if rel >= worst_rel:
            worst_name, worst_rel = n, rel
    # the encoder learns through the cross-attention (tests/test_models.py:124)
    for n in ("enc0_self_qkv_weight", "enc_embed_weight"):
        check(float(np.abs(small[0].grad_dict[n].asnumpy()).sum()) > 0, ("MT encoder grad", n))
    del small

    exe = bind(pt.gpu(0), B)
    names = [n for n in net.list_arguments() if n in params]
    opt = pt.optimizer.create("sgd", learning_rate=MT["lr"], momentum=MT["momentum"],
                              wd=MT["wd"], rescale_grad=1.0 / B,
                              param_idx2name=dict(enumerate(names)))
    updater = pt.optimizer.get_updater(opt)

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

    losses = []
    for _ in range(MT["warmup_steps"]):
        step()
        losses.append(loss_of(exe, B))
    # the plan's sites: 3L attention (L encoder non-causal, L decoder causal,
    # L cross non-causal), 2L + 1 encoder and 3L + 1 decoder LayerNorms, L
    # encoder and L decoder ffn1
    expected = {"flash_attention": 3 * L, "flash_attention_dq": 3 * L,
                "flash_attention_dkv": 3 * L, "norm_residual": 5 * L + 2,
                "norm_residual_bwd": 5 * L + 2, "matmul_bias_act": 2 * L}
    ops.reset_launch_counts()
    step_ms = []
    for _ in range(MT["steps"]):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss_of(exe, B))
    launches = ops.launch_counts()
    check(launches == with_zeros({k: v * MT["steps"] for k, v in expected.items()}),
          ("MT training launch counts", launches))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          ("the MT loss did not fall", losses))
    card = profile_window(step)
    p50 = float(np.percentile(step_ms, 50))
    tokens = B * MT["tgt_len"]
    log({"phase": "mt", "nvidia_smi": smi, "model": cfg, "batch": B,
         "target_tokens_per_step": tokens, "launches_per_step": expected,
         "launches": {k: v for k, v in launches.items() if v}, "losses": losses,
         "check_batch": Bc, "loss_card": losses_small[0], "loss_cpu": losses_small[1],
         "worst_grad": worst_name, "worst_grad_abs_err_over_max": worst_rel,
         "relu_kinks_pinned": n_flips, "step_ms_p50": p50,
         "step_ms_p80": float(np.percentile(step_ms, 80)), "step_ms": step_ms,
         "target_tokens_per_s": tokens * 1e3 / p50, "device_busy_ms": card["device_busy_ms"],
         "device_idle_share": card["device_idle_share"],
         "port_kernels_ms": card["port_kernels_ms"], "port_kernel_ms": card["port_kernel_ms"],
         "port_kernel_launches": card["port_kernel_launches"],
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "seconds": time.perf_counter() - t_phase})
    del exe
    return launches


# copied from example/rnn/lstm_bucketing.py (_synthetic_corpus; BUCKETS passed in)
def synthetic_corpus(n_sentences, vocab_size=500, seed=0, buckets=(10, 20, 30, 40, 50, 60)):
    rs = np.random.RandomState(seed)
    # Zipf-ish token frequencies, bucket-spread sentence lengths
    probs = 1.0 / np.arange(2, vocab_size + 2)
    probs /= probs.sum()
    sentences = []
    for _ in range(n_sentences):
        length = int(rs.choice(list(buckets))) - rs.randint(0, 5)
        toks = rs.choice(np.arange(2, vocab_size + 2), size=max(length, 3), p=probs)
        sentences.append(toks.tolist())
    return sentences, vocab_size + 2


def bucketing_module(pt, vocab, ctx):
    """``example/rnn/lstm_bucketing.py``'s network on ``ctx``: two LSTMCells
    under SequentialRNNCell.unroll, an embedding, the softmax head."""
    cfg = LSTM_BUCKETING
    stack = pt.rnn.SequentialRNNCell()
    for i in range(cfg["num_layers"]):
        stack.add(pt.rnn.LSTMCell(num_hidden=cfg["num_hidden"], prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pt.sym.Variable("data")
        label = pt.sym.Variable("softmax_label")
        embed = pt.sym.Embedding(data=data, input_dim=vocab, output_dim=cfg["num_embed"],
                                 name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True,
                                  begin_state=stack.begin_state(batch_size=cfg["batch"]))
        pred = pt.sym.Reshape(outputs, shape=(-1, cfg["num_hidden"]))
        pred = pt.sym.FullyConnected(data=pred, num_hidden=vocab, name="pred")
        label = pt.sym.Reshape(label, shape=(-1,))
        pred = pt.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen


class FirstBatches:
    """The first ``n`` batches of a bucketing iterator (a DataIter)."""

    def __init__(self, it, n):
        self.it, self.n, self.i = it, n, 0
        self.batch_size = it.batch_size
        self.provide_data, self.provide_label = it.provide_data, it.provide_label
        self.default_bucket_key = it.default_bucket_key

    def __iter__(self):
        return self

    def reset(self):
        self.it.reset()
        self.i = 0

    def __next__(self):
        if self.i == self.n:
            raise StopIteration
        self.i += 1
        return self.it.next()

    next = __next__


def run_lstm(pt, smi):
    """Phase 12: (a) the bucketed LSTM LM of example/rnn/lstm_bucketing.py
    through BucketingModule.fit for one epoch on the card; its first batches
    against the port's CPU run; tokens/s. (b) models/lstm.py on the fused
    RNN op: card vs CPU, timed training steps, unfuse() on the card."""
    from mxnet_tpu_torch import models

    t_phase = time.perf_counter()
    cfg = LSTM_BUCKETING
    sentences, vocab = synthetic_corpus(cfg["sentences"], vocab_size=cfg["vocab"], seed=SEED,
                                        buckets=cfg["buckets"])
    out = {"phase": "lstm_bucketing", "nvidia_smi": smi, "vocab": vocab,
           "sentences": len(sentences), **{k: v for k, v in cfg.items() if k != "buckets"},
           "buckets": list(cfg["buckets"])}
    binds = []
    orig_bind = pt.mod.Module.bind

    def counting_bind(self, *a, **k):
        binds.append(self)
        return orig_bind(self, *a, **k)

    def fit(ctx, n_batches, params, record=None):
        with ctx:
            it = pt.rnn.BucketSentenceIter(sentences, cfg["batch"], buckets=list(cfg["buckets"]),
                                           invalid_label=0)
            data = FirstBatches(it, n_batches) if n_batches else it
            mod = pt.mod.BucketingModule(sym_gen=bucketing_module(pt, vocab, ctx),
                                         default_bucket_key=it.default_bucket_key, context=ctx)
            metric = pt.metric.Perplexity(0)
            mod.fit(data, eval_metric=metric, optimizer="sgd",
                    optimizer_params={"learning_rate": cfg["lr"], "momentum": 0.0,
                                      "wd": cfg["wd"]},
                    arg_params=params, batch_end_callback=record, num_epoch=1)
        return mod

    # the weights: the example's Xavier, drawn once on the CPU and handed to
    # both runs
    pt.random.seed(SEED + 61)
    with pt.cpu():
        it = pt.rnn.BucketSentenceIter(sentences, cfg["batch"], buckets=list(cfg["buckets"]),
                                       invalid_label=0)
        init_mod = pt.mod.BucketingModule(sym_gen=bucketing_module(pt, vocab, pt.cpu()),
                                          default_bucket_key=it.default_bucket_key,
                                          context=pt.cpu())
        init_mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        init_mod.init_params(initializer=pt.init.Xavier(factor_type="in", magnitude=2.34))
        params = {n: a.asnumpy() for n, a in init_mod.get_params()[0].items()}
    del init_mod
    n_check = cfg["check_batches"]
    runs = []
    for ctx in (pt.gpu(0), pt.cpu()):
        mod = fit(ctx, n_check, {n: pt.nd.array(v, ctx=ctx) for n, v in params.items()})
        runs.append(({n: a.asnumpy() for n, a in mod.get_params()[0].items()},
                     sorted(mod._buckets)))
        del mod
    card, cpu = runs
    check(card[1] == cpu[1] and len(card[1]) >= 3, ("buckets of the first batches", card[1]))
    errs = {n: float(np.abs(card[0][n] - cpu[0][n]).max()) for n in card[0]}
    bad = [n for n in card[0] if not np.allclose(card[0][n], cpu[0][n], rtol=1e-4, atol=1e-5)]
    check(not bad, ("bucketed LSTM card vs CPU parameters", bad, errs))
    out.update(check_batches=n_check, check_buckets=card[1],
               card_vs_cpu_max_abs_err=max(errs.values()))

    # --- one epoch on the card
    marks, ppl, tokens = [], [], [0]
    real, seen_sum = {}, [0.0]

    def record(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        # Perplexity sums a perplexity a batch: this batch's is the increase
        ppl.append(float(param.eval_metric.sum_metric - seen_sum[0]))
        seen_sum[0] = param.eval_metric.sum_metric

    # the epoch's batches in the fit's order (the same seed and sentences),
    # read on the host: real tokens (padding excluded) and buckets
    with pt.cpu():
        order = [(b.bucket_key, int((b.data[0].asnumpy() != 0).sum()))
                 for b in pt.rnn.BucketSentenceIter(sentences, cfg["batch"],
                                                    buckets=list(cfg["buckets"]),
                                                    invalid_label=0)]
    for key, n in order:
        tokens[0] += n
        real[key] = real.get(key, 0) + 1
    pt.mod.Module.bind = counting_bind
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks.append(t0)
        mod = fit(pt.gpu(0), 0, {n: pt.nd.array(v, ctx=pt.gpu(0)) for n, v in params.items()},
                  record)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
    finally:
        pt.mod.Module.bind = orig_bind
    n_batches = len(ppl)
    check(n_batches == sum(real.values()), ("batches of the epoch", n_batches, real))
    # one bind a bucket, at its first batch (the default bucket's, the first)
    check(len(binds) == len(real), ("binds", len(binds), sorted(real)))
    q = max(1, n_batches // 5)
    first, last = float(np.mean(ppl[:q])), float(np.mean(ppl[-q:]))
    check(all(math.isfinite(v) for v in ppl) and last < first,
          ("the perplexity did not fall", first, last))
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    # host time a batch after each bucket's first (which binds)
    seen, steady = set(), []
    for ms, (key, _) in zip(step_ms, order):
        if key in seen:
            steady.append(ms)
        seen.add(key)
    with pt.gpu(0):
        batch = next(iter(pt.rnn.BucketSentenceIter(sentences, cfg["batch"],
                                                    buckets=list(cfg["buckets"]),
                                                    invalid_label=0)))

    def step():
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()

    card = profile_window(step)
    out.update(batches=n_batches, batches_per_bucket=real, binds=len(binds),
               real_tokens=tokens[0], epoch_s=epoch_s, tokens_per_s=tokens[0] / epoch_s,
               batch_ms_p50=float(np.percentile(steady, 50)),
               batch_ms_p80=float(np.percentile(steady, 80)),
               perplexity_first_fifth=first, perplexity_last_fifth=last,
               one_batch=dict(bucket=batch.bucket_key, device_busy_ms=card["device_busy_ms"],
                              device_idle_share=card["device_idle_share"],
                              wall_ms=card["wall_ms"],
                              device_events=card["device_events_per_call"]),
               seconds=time.perf_counter() - t_phase)
    log(out)
    bucketing_tokens_per_s = out["tokens_per_s"]
    t_phase = time.perf_counter()
    del mod

    # --- (b) models/lstm.py at its defaults on the fused RNN op
    fc = LSTM_FUSED
    Bc = 2
    out = {"phase": "lstm_fused", "nvidia_smi": smi, **fc}
    rs = np.random.RandomState(SEED + 62)

    def lm(batch_size):
        return models.lstm.get_symbol(batch_size=batch_size, **{k: v for k, v in fc.items()
                                                                if k not in ("steps", "lr",
                                                                             "batch_size")})

    net = lm(fc["batch_size"])
    shapes = dict(data=(fc["batch_size"], fc["seq_len"]),
                  softmax_label=(fc["batch_size"], fc["seq_len"]))
    arg_shapes = net.infer_shape(**shapes)[0]
    params = {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), arg_shapes) if n not in shapes}
    tokens = rs.randint(0, fc["num_classes"], (fc["batch_size"], fc["seq_len"] + 1))
    data = {"data": tokens[:, :-1].astype(np.float32),
            "softmax_label": tokens[:, 1:].astype(np.float32)}
    for n in ("lstm_init_h", "lstm_init_c"):
        params[n] = np.zeros_like(params[n])
    small = []
    for ctx in (pt.gpu(0), pt.cpu()):
        snet = lm(Bc)
        exe = snet.simple_bind(ctx, grad_req={n: "write" for n in params if "init" not in n},
                               data=(Bc, fc["seq_len"]), softmax_label=(Bc, fc["seq_len"]))
        exe.copy_params_from({n: (v[:, :Bc] if "init" in n else v) for n, v in params.items()})
        exe.copy_params_from({k: v[:Bc] for k, v in data.items()})
        exe.forward_backward()
        small.append((exe.outputs[0].asnumpy(), {n: exe.grad_dict[n].asnumpy()
                                                 for n in params if "init" not in n}))
    check(np.allclose(small[0][0], small[1][0], rtol=1e-4, atol=1e-6),
          ("fused LSTM card vs CPU outputs", float(np.abs(small[0][0] - small[1][0]).max())))
    for n, g in small[0][1].items():
        w = small[1][1][n]
        check(np.allclose(g, w, rtol=1e-3, atol=1e-3 * float(np.abs(w).max())),
              ("fused LSTM card vs CPU grad", n))
    exe = net.simple_bind(pt.gpu(0), grad_req={n: "write" for n in params if "init" not in n},
                          **shapes)
    exe.copy_params_from(params)
    exe.copy_params_from(data)
    names = [n for n in net.list_arguments() if n in params and "init" not in n]
    updater = pt.optimizer.get_updater(pt.optimizer.create(
        "sgd", learning_rate=fc["lr"], rescale_grad=1.0 / fc["batch_size"],
        param_idx2name=dict(enumerate(names))))

    def step():
        exe.forward_backward()
        for i, n in enumerate(names):
            updater(i, exe.grad_dict[n], exe.arg_dict[n])
        torch.cuda.synchronize()

    step()
    step_ms = []
    for _ in range(fc["steps"]):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    card = profile_window(step)
    p50 = float(np.median(step_ms))
    tok = fc["batch_size"] * fc["seq_len"]

    # --- FusedRNNCell.unfuse() with unpack_weights: the fused outputs
    cell = pt.rnn.FusedRNNCell(fc["num_hidden"], num_layers=fc["num_layers"], mode="lstm",
                               prefix="f_")
    fout, _ = cell.unroll(fc["seq_len"], inputs=pt.sym.Variable("data"), layout="NTC")
    uouts, _ = cell.unfuse().unroll(fc["seq_len"], inputs=pt.sym.Variable("data"),
                                    layout="NTC", merge_outputs=True)
    x = rs.uniform(-1, 1, (fc["batch_size"], fc["seq_len"], fc["num_embed"])).astype(np.float32)
    blob = params["lstm_parameters"]
    zeros = np.zeros((fc["num_layers"], fc["batch_size"], fc["num_hidden"]), np.float32)
    with pt.gpu(0):
        fexe = fout.simple_bind(pt.gpu(0), grad_req="null", data=x.shape)
        fexe.copy_params_from({"data": x, "f_parameters": blob, "f_begin_state_0": zeros,
                               "f_begin_state_1": zeros})
        fused = fexe.forward(is_train=False)[0].asnumpy()
        weights = cell.unpack_weights({"f_parameters": pt.nd.array(blob)})
        states = {n: zeros[0].shape for n in uouts.list_arguments() if "begin_state" in n}
        uexe = uouts.simple_bind(pt.gpu(0), grad_req="null", data=x.shape, **states)
        uargs = {"data": x}
        uargs.update({k: v.asnumpy() for k, v in weights.items()})
        uargs.update({n: zeros[0] for n in states})
        uexe.copy_params_from(uargs)
        unfused = uexe.forward(is_train=False)[0].asnumpy()
    uerr = float(np.abs(fused - unfused).max())
    check(np.allclose(unfused, fused, rtol=1e-4, atol=1e-5), ("unfuse() on the card", uerr))
    out.update(card_vs_cpu_batch=Bc, step_ms_p50=p50, step_ms=step_ms, tokens_per_step=tok,
               tokens_per_s=tok * 1e3 / p50, device_busy_ms=card["device_busy_ms"],
               device_idle_share=card["device_idle_share"],
               device_events_per_step=card["device_events_per_call"],
               unfused_vs_fused_max_abs_err=uerr,
               seconds=time.perf_counter() - t_phase)
    log(out)
    return bucketing_tokens_per_s


# ----------------------------------------------------------------- phase 13
def _u(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def _ids(rs, n, *shape):
    return rs.randint(0, n, shape).astype(np.float32)


def ssd_op_cases():
    """(op, attrs, numpy inputs, has a backward) for every op of the rest of
    the library but the samplers (held to their distributions instead), at
    small shapes, inputs drawn from one seed."""
    rs = np.random.RandomState(SEED + 60)
    anchors = np.concatenate([
        np.stack(np.meshgrid(np.arange(4) / 4, np.arange(4) / 4, indexing="xy"), -1).reshape(-1, 2),
        np.stack(np.meshgrid(np.arange(4) / 4, np.arange(4) / 4, indexing="xy"), -1).reshape(-1, 2)
        + np.array([0.3, 0.35])], axis=1).astype(np.float32)[None]  # (1, 16, 4)
    label = -np.ones((2, 3, 5), np.float32)
    label[0, :2] = [[1, 0.1, 0.1, 0.45, 0.4], [2, 0.5, 0.4, 0.9, 0.95]]
    label[1, 0] = [0, 0.2, 0.55, 0.6, 0.9]
    probs = np.exp(_u(rs, 2, 4, 16) * 3)
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    rois = np.array([[0, 1, 2, 9, 13], [1, 0, 0, 15, 15], [0, 6, 3, 7, 4]], np.float32)
    mining = {"negative_mining_ratio": "3", "negative_mining_thresh": "0.5",
              "minimum_negative_samples": "1"}
    return [
        ("Deconvolution", {"kernel": "(3, 3)", "num_filter": "4", "stride": "(2, 2)",
                           "pad": "(1, 1)", "adj": "(1, 1)"},
         [_u(rs, 2, 3, 5, 5), _u(rs, 3, 4, 3, 3), _u(rs, 4)], True),
        ("Deconvolution", {"kernel": "(2, 2)", "num_filter": "6", "num_group": "2",
                           "no_bias": "True"}, [_u(rs, 2, 4, 3, 4), _u(rs, 4, 3, 2, 2)], True),
        ("LeakyReLU", {"act_type": "leaky", "slope": "0.1"}, [_u(rs, 3, 4)], True),
        ("LeakyReLU", {"act_type": "elu"}, [_u(rs, 3, 4)], True),
        ("LeakyReLU", {"act_type": "prelu"}, [_u(rs, 2, 3, 4), _u(rs, 3)], True),
        ("LeakyReLU", {"act_type": "rrelu"}, [_u(rs, 3, 4)], True),
        ("log_softmax", {"axis": "1"}, [_u(rs, 2, 5, 3)], True),
        ("SoftmaxActivation", {}, [_u(rs, 2, 3, 4)], True),
        ("SoftmaxActivation", {"mode": "channel"}, [_u(rs, 2, 21, 64)], True),
        ("LinearRegressionOutput", {"grad_scale": "0.5"}, [_u(rs, 4, 3), _u(rs, 4, 3)], True),
        ("LogisticRegressionOutput", {}, [_u(rs, 4, 3), _ids(rs, 2, 4, 3)], True),
        ("MAERegressionOutput", {}, [_u(rs, 4, 3), _u(rs, 4, 3)], True),
        ("MakeLoss", {"grad_scale": "0.25", "normalization": "batch"}, [_u(rs, 4, 3)], True),
        ("SVMOutput", {"margin": "0.5"}, [_u(rs, 4, 5), _ids(rs, 5, 4)], True),
        ("SVMOutput", {"use_linear": "True"}, [_u(rs, 4, 5), _ids(rs, 5, 4)], True),
        ("IdentityAttachKLSparseReg", {"penalty": "0.01"},
         [_u(rs, 3, 4), np.array([0.2], np.float32)], True),
        ("InstanceNorm", {"eps": "1e-05"}, [_u(rs, 2, 3, 4, 5), _u(rs, 3), _u(rs, 3)], True),
        ("L2Normalization", {}, [_u(rs, 2, 3, 4)], True),
        ("L2Normalization", {"mode": "channel"}, [_u(rs, 2, 512, 38, 38)], True),
        ("L2Normalization", {"mode": "spatial"}, [_u(rs, 2, 3, 4, 2)], True),
        ("UpSampling", {"scale": "2"}, [_u(rs, 2, 3, 3, 4)], True),
        ("UpSampling", {"scale": "3", "num_args": "2"}, [_u(rs, 1, 2, 2, 3), _u(rs, 1, 3, 2, 3)],
         True),
        ("UpSampling", {"scale": "2", "sample_type": "bilinear"}, [_u(rs, 2, 3, 3, 4)], True),
        ("ROIPooling", {"pooled_size": "(2, 3)", "spatial_scale": "0.5"},
         [_u(rs, 2, 3, 8, 8), rois], True),
        ("BilinearSampler", {}, [_u(rs, 2, 3, 5, 6), _u(rs, 2, 2, 4, 5) * 1.1], True),
        ("GridGenerator", {"transform_type": "affine", "target_shape": "(3, 4)"}, [_u(rs, 2, 6)],
         True),
        ("GridGenerator", {"transform_type": "warp"}, [_u(rs, 2, 2, 3, 4)], True),
        ("SpatialTransformer", {"target_shape": "(5, 4)"},
         [_u(rs, 2, 3, 6, 6), np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0],
                                        [1.1, 0.03, -0.13, 0.07, 0.83, 0.11]], np.float32)], True),
        ("Crop", {"offset": "(1, 2)", "h_w": "(3, 3)"}, [_u(rs, 2, 3, 6, 6)], True),
        ("Crop", {"num_args": "2", "center_crop": "True"}, [_u(rs, 2, 3, 6, 7), _u(rs, 1, 1, 3, 5)],
         True),
        ("MultiBoxPrior", {"sizes": "[0.1, 0.141]", "ratios": "[1, 2, 0.5]"},
         [_u(rs, 1, 3, 38, 38)], True),
        ("MultiBoxPrior", {"sizes": "(0.5, 0.8)", "ratios": "(1, 3)", "clip": "True",
                           "steps": "(0.2, 0.25)", "offsets": "(0.4, 0.6)"},
         [_u(rs, 1, 3, 5, 4)], True),
        ("MultiBoxTarget", {}, [anchors, label, _u(rs, 2, 4, 16)], True),
        ("MultiBoxTarget", mining, [anchors, label, _u(rs, 2, 4, 16) * 3], True),
        ("MultiBoxDetection", {}, [probs, _u(rs, 2, 64) * 0.5, anchors], True),
        ("MultiBoxDetection", {"nms_threshold": "0.3", "threshold": "0.2", "nms_topk": "5"},
         [probs, _u(rs, 2, 64) * 0.5, anchors], True),
        ("Proposal", {"rpn_post_nms_top_n": "8", "rpn_pre_nms_top_n": "40", "rpn_min_size": "4"},
         [_u(rs, 2, 24, 4, 4, lo=0.0), _u(rs, 2, 48, 4, 4) * 0.1,
          np.array([[64, 64, 1.0], [60, 50, 0.5]], np.float32)], True),
        ("fft", {}, [_u(rs, 2, 8)], True),
        ("ifft", {}, [_u(rs, 2, 3, 16)], True),
        ("count_sketch", {"out_dim": "4"},
         [_u(rs, 3, 6), np.array([0, 3, 1, 0, 3, 2], np.float32),
          np.array([1, -1, 1, 1, -1, -1], np.float32)], True),
        ("Correlation", {"max_displacement": "1", "pad_size": "1"},
         [_u(rs, 2, 3, 4, 5), _u(rs, 2, 3, 4, 5)], True),
        ("Correlation", {"max_displacement": "2", "stride2": "2", "is_multiply": "False"},
         [_u(rs, 1, 2, 5, 5), _u(rs, 1, 2, 5, 5)], True),
        ("batch_dot", {"transpose_b": "True"}, [_u(rs, 2, 3, 4), _u(rs, 2, 5, 4)], True),
        ("slice", {"begin": "(1, 0, 2)", "end": "(2, 3, 4)"}, [_u(rs, 3, 4, 5)], True),
        ("repeat", {"repeats": "2", "axis": "1"}, [_u(rs, 2, 3)], True),
        ("tile", {"reps": "(2, 1, 3)"}, [_u(rs, 2, 3)], True),
        ("reverse", {"axis": "(0, 2)"}, [_u(rs, 2, 3, 4)], True),
        ("take", {"axis": "1", "mode": "wrap"}, [_u(rs, 2, 5, 3), np.array([1, -1, 7], np.float32)],
         True),
        ("batch_take", {}, [_u(rs, 4, 5), np.array([0, 4, 2, 2], np.float32)], True),
        ("pick", {"axis": "0", "keepdims": "True"}, [_u(rs, 3, 5, 2), _ids(rs, 3, 5, 2)], True),
        ("topk", {"k": "3", "ret_typ": "both"}, [np.round(_u(rs, 4, 6) * 4) / 4], True),
        ("topk", {"k": "2", "ret_typ": "mask", "axis": "1"}, [np.round(_u(rs, 3, 5, 2) * 4) / 4],
         False),
        ("sort", {"axis": "0", "is_ascend": "False"}, [np.round(_u(rs, 4, 6) * 4) / 4], True),
        ("argsort", {}, [np.round(_u(rs, 4, 6) * 4) / 4], False),
        ("Pad", {"mode": "constant", "pad_width": "(0, 0, 0, 0, 1, 2, 2, 1)",
                 "constant_value": "1.5"}, [_u(rs, 2, 3, 4, 5)], True),
        ("Pad", {"mode": "edge", "pad_width": "(0, 0, 0, 0, 2, 1, 0, 3)"}, [_u(rs, 2, 3, 4, 5)],
         True),
        ("Pad", {"mode": "reflect", "pad_width": "(0, 0, 0, 0, 1, 2, 2, 1)"},
         [_u(rs, 2, 3, 4, 5)], True),
        ("SequenceLast", {"use_sequence_length": "True"},
         [_u(rs, 4, 3, 2), np.array([1, 4, 2], np.float32)], True),
        ("SequenceMask", {"use_sequence_length": "True", "value": "-1.0"},
         [_u(rs, 4, 3, 2), np.array([1, 4, 0], np.float32)], True),
        ("SequenceReverse", {"use_sequence_length": "True"},
         [_u(rs, 4, 3, 2), np.array([1, 4, 2], np.float32)], True),
        ("WarpCTC", {"input_length": "6", "label_length": "4"},
         [_u(rs, 24, 6), np.array([[1, 0, 2, 0], [3, 3, 0, 0], [1, 2, 3, 4], [5, 5, 5, 5]],
                                  np.float32)], True),
        ("Custom", {"op_type": "smoke_scaled_tanh", "factor": "2.0"}, [_u(rs, 3, 4)], True),
    ]


def register_smoke_custom_op(pt):
    """tanh(x)·factor with its hand-written backward, as a user's Custom op."""

    @pt.operator.register("smoke_scaled_tanh")
    class Prop(pt.operator.CustomOpProp):
        def __init__(self, factor="1.5"):
            super().__init__(need_top_grad=True)
            self.factor = float(factor)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            factor = self.factor

            class Op(pt.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], np.tanh(in_data[0].asnumpy()) * factor)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    y = out_data[0].asnumpy() / factor
                    self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * factor * (1 - y * y))

            return Op()


def run_op_sweep(pt):
    """Every case of ``ssd_op_cases`` forward (and backward) on the card
    against the port's CPU run of the same numpy inputs; the samplers'
    card draws held to their distributions."""
    from mxnet_tpu_torch.ops import registry as reg

    register_smoke_custom_op(pt)
    dev = pt.gpu(0).torch_device
    rs = np.random.RandomState(SEED + 61)
    worst_fwd, worst_bwd, n_grads, ops_seen = 0.0, 0.0, 0, set()
    for op, attrs, inputs, has_grad in ssd_op_cases():
        opdef = reg.get_op(op)
        ops_seen.add(opdef.name)
        pa = reg.parse_attrs(opdef, attrs)
        n_in = len(opdef.input_names(pa))
        runs, cots = [], None
        for d in (torch.device("cpu"), dev):
            xs = [torch.from_numpy(x).to(d) for x in inputs]
            leaves = [x.requires_grad_(True) if has_grad else x for x in xs[:n_in]]
            with torch.enable_grad():
                outs, _ = opdef.apply(pa, leaves, aux=xs[n_in:])
            if cots is None:
                cots = [rs.standard_normal(tuple(o.shape)).astype(np.float32) for o in outs]
            grads = []
            heads = [(o, torch.from_numpy(c).to(d)) for o, c in zip(outs, cots)
                     if o.requires_grad]
            if has_grad and heads:
                grads = torch.autograd.grad([o for o, _ in heads], leaves,
                                            [c for _, c in heads], allow_unused=True)
            runs.append(([o.detach().cpu().numpy() for o in outs],
                         [None if g is None else g.cpu().numpy() for g in grads]))
        (cpu_outs, cpu_grads), (card_outs, card_grads) = runs
        for got, want in zip(card_outs, cpu_outs):
            check(got.shape == want.shape and got.dtype == want.dtype, ("sweep shape", op, attrs))
            check(np.allclose(got, want, **SSD_OP_TOL, equal_nan=True),
                  ("sweep forward card vs CPU", op, attrs, float(np.abs(got - want).max())))
            worst_fwd = max(worst_fwd, float(np.abs(got - want).max()) if got.size else 0.0)
        for got, want in zip(card_grads, cpu_grads):
            check((got is None) == (want is None), ("sweep gradient presence", op, attrs))
            if got is None:
                continue
            n_grads += 1
            check(np.allclose(got, want, **SSD_GRAD_TOL),
                  ("sweep backward card vs CPU", op, attrs, float(np.abs(got - want).max())))
            worst_bwd = max(worst_bwd, float(np.abs(got - want).max()))
    draws = check_card_samplers(pt)
    ops_seen |= set(draws)
    return {"ops": len(ops_seen), "cases": len(ssd_op_cases()), "gradients": n_grads,
            "forward_worst_abs": worst_fwd, "backward_worst_abs": worst_bwd, "samplers": draws}


# sampler -> (attrs or parameter rows, moments (mean, std, kurtosis) of each row)
CARD_SAMPLERS = {
    "random_gamma": ({"alpha": "2.0", "beta": "1.5"}, (3.0, 1.5 * math.sqrt(2.0), 6.0)),
    "random_exponential": ({"lam": "2.0"}, (0.5, 0.5, 9.0)),
    "random_poisson": ({"lam": "3.0"}, (3.0, math.sqrt(3.0), 3.0 + 1.0 / 3.0)),
    "random_negative_binomial": ({"k": "3", "p": "0.4"}, (4.5, math.sqrt(11.25),
                                                           5.0 + 0.16 / 1.8)),
    "random_generalized_negative_binomial": ({"mu": "2.0", "alpha": "0.5"}, (2.0, 2.0, 6.25)),
    "sample_uniform": ([[0.0, -2.0], [1.0, 3.0]],
                       lambda lo, hi: ((lo + hi) / 2, (hi - lo) / math.sqrt(12.0), 1.8)),
    "sample_normal": ([[0.0, 1.5], [1.0, 0.25]], lambda mu, s: (mu, s, 3.0)),
    "sample_gamma": ([[2.0, 0.5], [1.5, 2.0]], lambda a, b: (a * b, math.sqrt(a) * b, 3 + 6 / a)),
    "sample_exponential": ([[2.0, 0.5]], lambda lam: (1 / lam, 1 / lam, 9.0)),
    "sample_poisson": ([[3.0, 0.5]], lambda lam: (lam, math.sqrt(lam), 3 + 1 / lam)),
    "sample_negative_binomial": ([[3.0, 5.0], [0.4, 0.7]], lambda k, p: (
        k * (1 - p) / p, math.sqrt(k * (1 - p)) / p, 3 + 6 / k + p * p / (k * (1 - p)))),
    "sample_generalized_negative_binomial": ([[2.0, 1.0], [0.5, 0.25]], lambda mu, a: (
        mu, math.sqrt(mu + a * mu * mu),
        3 + 6 * a + (1 / (1 + a * mu)) ** 2 / ((1 / a) * (a * mu / (1 + a * mu))))),
}


def check_card_samplers(pt, n=20000):
    """Each sampler's draws on the card within 5 standard errors of its
    mean and std (the std's from its kurtosis); the same seed, the same
    draws."""
    ctx = pt.gpu(0)
    out = {}
    for op, (spec, moments) in CARD_SAMPLERS.items():
        fn = getattr(pt.nd, op)
        if isinstance(spec, dict):
            draw = lambda: fn(ctx=ctx, shape=(n,), **spec)  # noqa: E731
            rows = [moments]
        else:
            params = [pt.nd.array(np.array(p, np.float32), ctx=ctx) for p in spec]
            draw = lambda: fn(*params, shape=(n,))  # noqa: E731
            rows = [moments(*[p[i] for p in spec]) for i in range(len(spec[0]))]
        pt.random.seed(SEED + 62)
        x = draw()
        check(x.context == ctx, ("sampler context", op))
        xs = x.asnumpy().astype(np.float64).reshape(len(rows), n)
        for row, (mean, std, kurt) in zip(xs, rows):
            check(abs(row.mean() - mean) < 5 * std / math.sqrt(n)
                  and abs(row.std() - std) < 5 * std * math.sqrt((kurt - 1) / (4 * n)),
                  ("card sampler moments", op, row.mean(), row.std(), mean, std))
        pt.random.seed(SEED + 62)
        check(np.array_equal(draw().asnumpy(), x.asnumpy()), ("card sampler reseed", op))
        out[op] = [float(r.mean()) for r in xs]
    return out


def ssd_fixed_loss(outs):
    """The part of the SSD loss whose targets do not move as the net trains:
    the cross-entropy of the matched anchors at their classes and the
    smooth-L1 location loss (the mined negatives change with the net)."""
    prob, loc, target = (o._tensor() if hasattr(o, "_tensor") else o for o in outs)
    pos = target > 0
    picked = prob.gather(1, target.clamp(min=0).long()[:, None])[:, 0]
    return float(-(torch.log(picked.clamp_min(1e-30)) * pos).sum() / prob.shape[0]
                 + loc.sum() / prob.shape[0])


def check_target_ties(card, run, prob_bg, what, atol=1e-6):
    """A run's MultiBoxTarget outputs (``run``) held to the card's
    (``card``), each (loc_target, loc_mask, cls_target) on the CPU: the
    location masks and the positives equal, the location targets within
    rtol 1e-5 and ``atol``, and every class target that differs a near-tie:
    a mined negative (0) on one side and ignored (-1) on the other, whose
    background probability (``prob_bg``, (B, N), the run's) lies within
    SSD_TIE["mining_rel"] (relative) of the image's cut-off. Returns the
    count of near-tie rows."""
    lt, lm, ct = (o.double() for o in card)
    lt_r, lm_r, ct_r = (o.double() for o in run)
    check(torch.equal(lm, lm_r), (what, "location masks"))
    pos = ct_r > 0
    check(torch.equal(ct[pos], ct_r[pos]), (what, "positives"))
    check(torch.allclose(lt, lt_r, rtol=1e-5, atol=atol), (what, "location targets"))
    ties = 0
    for b in range(ct.shape[0]):
        diff = torch.nonzero(ct[b] != ct_r[b]).flatten()
        if not len(diff):
            continue
        cut = float(prob_bg[b][ct_r[b] == 0].max())
        for j in diff.tolist():
            check({float(ct[b, j]), float(ct_r[b, j])} == {0.0, -1.0}
                  and abs(float(prob_bg[b, j]) - cut) <= SSD_TIE["mining_rel"] * cut,
                  (what, "beyond a near-tie", b, j))
            ties += 1
    return ties


@contextlib.contextmanager
def pinned_targets(record=None, pinned=None):
    """Record the card's MultiBoxTarget outputs (``record``), or hold a
    run's own to recorded ones (``check_target_ties``; the location targets
    within 1e-5 of the largest, as a float64 run's lie up to 1e-6 of it
    from float32's) and replace them with the recorded ones (``pinned``);
    yields the count of near-tie rows as a one-element list."""
    from mxnet_tpu_torch.ops import registry as reg

    opdef = reg.get_op("_contrib_MultiBoxTarget")
    orig, ties, refs = opdef.fn, [0], iter(pinned or ())

    def fn(attrs, anchor, label, cls_pred):
        outs = orig(attrs, anchor, label, cls_pred)
        if record is not None:
            record.append(tuple(o.cpu() for o in outs))
        if pinned is None:
            return outs
        want = next(refs)
        prob_bg = torch.softmax(cls_pred.detach().cpu().double(), dim=1)[:, 0]
        ties[0] += check_target_ties(want, [o.cpu() for o in outs], prob_bg,
                                     "SSD step MultiBoxTarget card vs CPU",
                                     atol=1e-5 * float(want[0].abs().max()))
        return tuple(w.to(device=o.device, dtype=o.dtype) for w, o in zip(want, outs))

    opdef.fn = fn
    try:
        yield ties
    finally:
        opdef.fn = orig


@contextlib.contextmanager
def pool_kinks(record=None, compare=None, pin=False):
    """Record each max-pool's choices (the index of the element it took in
    every window, ``record``), or compare a run's with recorded ones
    (``compare``) and, with ``pin``, take the recorded element where they
    differ. The port's own pooling computes every output; a max_pool2d
    with ``return_indices`` on the same padded input reads which element
    each window took. Two elements of a window within rounding of each
    other are a kink of the max, as a pre-activation near 0 is of a ReLU:
    the card and the CPU may take different ones, and the backward routes
    the window's whole gradient to the element taken. Yields the list of
    (windows that differed, the largest gap between the two elements over
    the input's largest magnitude) per max-pool, in the order the forward
    reaches them."""
    import torch.nn.functional as tF
    from mxnet_tpu_torch.ops import nn as pnn

    orig, refs, flips = pnn._pooling_nd, iter(compare or ()), []

    def pooling(data, kernel, stride, pads, pool_type):
        out = orig(data, kernel, stride, pads, pool_type)
        if pool_type != "max" or data.ndim != 4:
            return out
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        x = tF.pad(data, flat, value=-math.inf) if any(flat) else data
        idx = tF.max_pool2d(x.detach(), kernel, stride, return_indices=True)[1]
        if record is not None:
            record.append(idx.cpu())
        if compare is None:
            return out
        want = next(refs).to(idx.device)
        flip = want != idx
        taken = x.flatten(2).gather(2, want.flatten(2)).view_as(out)
        gap = float((taken - out).detach().abs()[flip].max() / x.detach().abs().max()) \
            if bool(flip.any()) else 0.0
        flips.append((int(flip.sum()), gap))
        return torch.where(flip, taken, out) if pin else out

    pnn._pooling_nd = pooling
    try:
        yield flips
    finally:
        pnn._pooling_nd = orig


def ssd_bind(pt, net, ctx, args, images, labels, grad_req, dtype="float32"):
    arrays = {k: pt.nd.array(v, ctx=ctx, dtype=dtype) for k, v in args.items()}
    arrays["data"] = pt.nd.array(images, ctx=ctx, dtype=dtype)
    if labels is not None:
        arrays["label"] = pt.nd.array(labels, ctx=ctx, dtype=dtype)
    grads = {n: pt.nd.zeros(arrays[n].shape, ctx=ctx, dtype=dtype)
             for n, r in grad_req.items() if r != "null"} if isinstance(grad_req, dict) else None
    return pt.executor.bind(net, ctx, arrays, args_grad=grads,
                            grad_req=grad_req if grads else "null")


def ssd_train_check(pt, net, args, images, labels):
    """One SSD-300 training step at batch 2 from the same weights on the
    card and on the CPU in float32 and float64 (phase 10's check): the SSD
    loss, and every gradient by its norm distance from the float64 one.
    The CPU runs take the card's side at every ReLU and max-pool kink and
    the card's MultiBoxTarget outputs (constants), and count where their own
    differed: their own targets must equal the card's but at near-ties."""
    from mxnet_tpu_torch.models import vgg16_ssd as ssd

    reqs = {n: "write" for n in args}
    card, pools, targets = [], [], []
    exe = ssd_bind(pt, net, pt.gpu(0), args, images, labels, reqs)
    with relu_kinks(record=card), pool_kinks(record=pools), pinned_targets(record=targets):
        exe.forward_backward()
    torch.cuda.synchronize()
    got = ({n: exe.grad_dict[n].asnumpy() for n in args}, ssd.ssd_objective(exe.outputs))
    del exe

    def cpu_step(dtype):
        e = ssd_bind(pt, net, pt.cpu(), args, images, labels, reqs, dtype)
        with relu_kinks(compare=card, pin=True) as flips, \
                pool_kinks(compare=pools, pin=True) as pool_flips, \
                pinned_targets(pinned=targets) as d:
            e.forward_backward()
        return ({n: e.grad_dict[n].asnumpy() for n in args}, ssd.ssd_objective(e.outputs)), flips, \
            pool_flips, d[0]

    t0 = time.perf_counter()
    want, flips, pool_flips, target_diffs = cpu_step("float32")
    cpu_s = time.perf_counter() - t0
    exact, _, pool_flips64, target_diffs64 = cpu_step("float64")

    def fro(a, b):
        return float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b)) or 1.0)

    strict = [n for n in args if np.allclose(got[0][n], want[0][n], rtol=1e-3,
                                             atol=1e-3 * float(np.abs(want[0][n]).max()))]
    card64 = {n: fro(got[0][n], exact[0][n]) for n in args}
    cpu64 = {n: fro(want[0][n], exact[0][n]) for n in args}
    ratio = {n: card64[n] / max(cpu64[n], 1e-30) for n in args}
    n_flips = sum(n for n, _ in flips)
    n_decisions = sum(int(d.numel()) for d in card)
    n_pool_flips, pool_gap = sum(n for n, _ in pool_flips), max([g for _, g in pool_flips] or [0])
    n_windows = sum(int(i.numel()) for i in pools)
    loose = [n for n in args if n not in strict]
    worst = max(loose, key=lambda n: ratio[n]) if loose else None
    out = {"batch": len(images), "loss_card": got[1], "loss_cpu": want[1], "loss_cpu_f64": exact[1],
           "relu_kinks_pinned": n_flips, "relu_decisions": n_decisions,
           "pool_kinks_pinned": n_pool_flips, "pool_kink_max_gap": pool_gap,
           "pool_kinks_pinned_f64": sum(n for n, _ in pool_flips64), "pool_windows": n_windows,
           "target_rows_pinned": target_diffs, "target_rows_pinned_f64": target_diffs64,
           "grads": len(args), "grads_within_1e-3_of_cpu": len(strict),
           "card_vs_f64_worst": max(card64.values()), "cpu_vs_f64_worst": max(cpu64.values()),
           "card_vs_f64_median": float(np.median(list(card64.values()))),
           "worst_ratio_grad": worst, "worst_ratio": ratio[worst] if worst else None,
           "over_2": {n: [card64[n], cpu64[n]] for n in loose if ratio[n] > 2},
           "cpu_step_s": cpu_s}
    check(abs(got[1] - want[1]) <= 1e-3 * max(1.0, abs(want[1])), ("SSD card vs CPU loss", out))
    check(n_flips <= 1e-5 * n_decisions, ("SSD ReLU decisions that differ beyond kinks", out))
    check(n_pool_flips <= 1e-5 * n_windows and pool_gap <= 1e-5,
          ("SSD max-pool choices that differ beyond kinks", out))
    for n in args:
        check(np.isfinite(got[0][n]).all(), ("non-finite SSD card gradient", n))
        check(n in strict or card64[n] <= RESNET_F64_FACTOR * cpu64[n],
              ("SSD card vs CPU grad", n, card64[n], cpu64[n]))
    return out


def check_multibox_card_vs_cpu(pt, cls_preds, loc_preds, anchors, labels):
    """MultiBoxTarget (the training symbol's settings) and MultiBoxDetection
    (the deploy symbol's) on the card and on the CPU from the same inputs,
    the card's, copied. Targets and kept boxes must agree but at near-ties:
    a mined negative whose background probability lies within
    SSD_TIE["mining_rel"] (relative) of the image's cut-off, or a box whose
    IoU with an earlier box (in the NMS order) lies within SSD_TIE["nms_iou"]
    of the threshold, and the boxes that such a box's flip suppressed or
    freed in turn. Returns the counts."""
    from mxnet_tpu_torch.ops import registry as reg

    def run(op, attrs, inputs):
        opdef = reg.get_op(op)
        pa = reg.parse_attrs(opdef, attrs)
        return [[o.cpu() for o in opdef.apply(pa, [x.to(d) for x in inputs])[0]]
                for d in (cls_preds.device, torch.device("cpu"))]

    tattrs = {"overlap_threshold": "0.5", "ignore_label": "-1", "negative_mining_ratio": "3",
              "negative_mining_thresh": "0.5", "variances": "(0.1, 0.1, 0.2, 0.2)"}
    (lt, lm, ct), (lt_c, lm_c, ct_c) = run("_contrib_MultiBoxTarget", tattrs,
                                           [anchors, labels, cls_preds])
    prob_bg = torch.softmax(cls_preds.cpu(), dim=1)[:, 0]
    mined_ties = check_target_ties((lt, lm, ct), (lt_c, lm_c, ct_c), prob_bg,
                                   "MultiBoxTarget card vs CPU")

    probs = torch.softmax(cls_preds, dim=1)
    dattrs = {"nms_threshold": "0.5", "nms_topk": str(SSD["nms_topk"]),
              "variances": "(0.1, 0.1, 0.2, 0.2)"}
    (det,), (det_c,) = run("_contrib_MultiBoxDetection", dattrs, [probs, loc_preds, anchors])
    check(torch.equal(det[..., 1], det_c[..., 1]), ("MultiBoxDetection scores",))
    check(torch.allclose(det[..., 2:], det_c[..., 2:], rtol=1e-5, atol=1e-6),
          ("MultiBoxDetection boxes",))
    from mxnet_tpu_torch.ops.vision import _corner_iou
    from mxnet_tpu_torch.ops.matrix import sort_key

    nms_ties = cascade = 0
    N, topk = det.shape[1], min(SSD["nms_topk"], det.shape[1])
    for b in range(det.shape[0]):
        differ = det[b, :, 0] != det_c[b, :, 0]
        if not bool(differ.any()):
            continue
        score = torch.where(det_c[b, :, 1] > 0.01, det_c[b, :, 1], torch.tensor(-1.0))
        order = torch.argsort(sort_key(-score), stable=True)
        rank = torch.empty(N, dtype=torch.long)
        rank[order] = torch.arange(N)
        flipped = set()
        for j in sorted(torch.nonzero(differ).flatten().tolist(), key=lambda j: int(rank[j])):
            earlier = order[:min(int(rank[j]), topk)]
            iou = _corner_iou(det_c[b, j:j + 1, 2:], det_c[b, earlier, 2:])[0]
            kept = (det[b, earlier, 0] >= 0) | (det_c[b, earlier, 0] >= 0)
            if bool(((iou - 0.5).abs() <= SSD_TIE["nms_iou"])[kept].any()):
                nms_ties += 1
            elif any(bool(iou[k] > 0.5 - SSD_TIE["nms_iou"]) for k, i in enumerate(earlier.tolist())
                     if i in flipped):
                cascade += 1
            else:
                check(False, ("MultiBoxDetection card vs CPU beyond a near-tie", b, j))
            flipped.add(j)
    return {"target_rows": int(ct.numel()), "positives": int((ct_c > 0).sum()),
            "mined_negatives": int((ct_c == 0).sum()), "mined_near_ties": mined_ties,
            "kept": int((det_c[..., 0] >= 0).sum()), "nms_near_ties": nms_ties,
            "nms_near_tie_cascade": cascade}


def time_detection(pt, deploy, params, images):
    """The deploy graph's MultiBoxDetection node alone on the card, on its
    inputs from the deploy forward: host ms a call (p50 of SSD["serve_iters"],
    each ending in a synchronize) and the profiler's window of one call."""
    from mxnet_tpu_torch.ops import registry as reg

    internals = deploy.get_internals()
    heads = pt.sym.Group([internals[k] for k in ("cls_prob_output", "loc_preds_output",
                                                 "anchors_output")])
    exe = ssd_bind(pt, heads, pt.gpu(0), {k: v for k, v in params.items()
                                          if k in heads.list_arguments()}, images, None, "null")
    ins = [o._tensor() for o in exe.forward(is_train=False)]
    opdef = reg.get_op("_contrib_MultiBoxDetection")
    node = [n for n in deploy._topo() if n.op == opdef.name][0]
    attrs = node.parsed_attrs()

    def call():
        opdef.apply(attrs, ins)
        torch.cuda.synchronize()

    call()
    ms = []
    for _ in range(SSD["serve_iters"]):
        t0 = time.perf_counter()
        call()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), profile_window(call)


def run_ssd(pt, smi):
    """Phase 13: VGG16-SSD-300 (BASELINE config 4) at its published widths.
    The op sweep; one training step at batch 2 card vs CPU; Module.fit at
    batch 8 over SyntheticDetIter's fixed batches (the loss must fall);
    MultiBoxTarget and MultiBoxDetection card vs CPU on the trained model's
    predictions; the deploy graph at batch 8 and 1. None of the port's ten
    kernels runs on this path (every SSD conv has a bias: no fused site)."""
    from mxnet_tpu_torch import models, ops
    from mxnet_tpu_torch.models import vgg16_ssd as ssd

    check_tf32_off()
    t_phase = time.perf_counter()
    out = {"phase": "ssd", "nvidia_smi": smi}
    t0 = time.perf_counter()
    out["op_sweep"] = run_op_sweep(pt)
    out["op_sweep"]["seconds"] = time.perf_counter() - t0
    B, Bc, image = SSD["batch"], SSD["check_batch"], SSD["image"]
    net = models.get_symbol("vgg16-ssd-300-train", num_classes=SSD["num_classes"])
    deploy = models.get_symbol("vgg16-ssd-300", num_classes=SSD["num_classes"],
                               nms_topk=SSD["nms_topk"])
    with pt.gpu(0):
        train = ssd.SyntheticDetIter(B, image, SSD["num_classes"], SSD["fit_batches"],
                                     max_objects=SSD["max_objects"], seed=SEED + 63)
    images, labels = train.batches[0]

    # --- one training step at batch 2, card vs CPU, from Xavier weights
    arg_shapes, _, _ = net.infer_shape(data=(Bc,) + tuple(image), label=(Bc, 4, 5))
    pt.random.seed(SEED + 64)
    init = pt.init.Xavier()
    attrs = net.attr_dict()
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "label"):
            continue
        arr = pt.nd.zeros(s, ctx=pt.cpu())
        init(pt.initializer.InitDesc(n, attrs.get(n)), arr)
        args[n] = arr.asnumpy()
    t0 = time.perf_counter()
    out["train_check"] = ssd_train_check(pt, net, args, images[:Bc], labels[:Bc])
    out["train_check"]["seconds"] = time.perf_counter() - t0

    # --- Module.fit at batch 8 over the fixed batches, from Xavier weights
    mod = pt.mod.Module(net, data_names=("data",), label_names=("label",), context=pt.gpu(0))
    mod.bind(train.provide_data, train.provide_label)
    pt.random.seed(SEED + 65)
    mod.init_params(pt.init.Xavier())

    def fixed_losses():
        train.reset()
        vals = []
        for b in train:
            mod.forward(b, is_train=False)
            vals.append(ssd_fixed_loss(mod.get_outputs()))
        return vals

    before = fixed_losses()
    train.reset()
    objective, marks = [], [time.perf_counter()]

    def batch_end(param):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        objective.append(ssd.ssd_objective(mod.get_outputs()))

    loss_metric = pt.metric.Loss()
    opt = (("learning_rate", SSD["lr"]), ("momentum", SSD["momentum"]), ("wd", SSD["wd"]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=loss_metric, optimizer="sgd", optimizer_params=opt,
            batch_end_callback=batch_end, num_epoch=SSD["fit_epochs"])
    fit_s = time.perf_counter() - t0
    fit_launches = ops.launch_counts()
    check(fit_launches == with_zeros({}), ("SSD Module.fit launches of the port's kernels",
                                           fit_launches))
    per = SSD["fit_batches"]
    after = fixed_losses()
    check(len(objective) == per * SSD["fit_epochs"] and all(map(math.isfinite, objective))
          and sum(after) < sum(before), ("SSD: the training loss did not fall", objective,
                                         before, after))
    train.reset()
    batch = next(iter(train))

    def step():
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()

    card = profile_window(step)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    timed = step_ms[1:]  # the first step binds and warms the allocator
    p50 = float(np.percentile(timed, 50))
    out["fit"] = {"batch": B, "batches": per, "epochs": SSD["fit_epochs"],
                  "objective": objective, "metric_loss": float(loss_metric.get()[1]),
                  "fixed_loss_before": before, "fixed_loss_after": after,
                  "step_ms_p50": p50, "step_ms_p80": float(np.percentile(timed, 80)),
                  "step_ms": step_ms, "images_per_s": B * 1e3 / p50, "fit_s": fit_s,
                  "device_busy_ms": card["device_busy_ms"],
                  "device_idle_share": card["device_idle_share"],
                  "device_events_per_step": card["device_events_per_call"],
                  "port_kernel_launches": {k: v for k, v in fit_launches.items() if v},
                  "top_device_ms": card["top_device_ms"]}
    arg_params, _ = mod.get_params()
    trained = {k: v.asnumpy() for k, v in arg_params.items()}
    del mod

    # --- MultiBoxTarget / MultiBoxDetection, card vs CPU on the same inputs
    internals = net.get_internals()
    heads = pt.sym.Group([internals[k] for k in ("cls_preds_output", "loc_preds_output",
                                                 "anchors_output")])
    exe = ssd_bind(pt, heads, pt.gpu(0), {k: v for k, v in trained.items()
                                          if k in heads.list_arguments()}, images, None, "null")
    cls_preds, loc_preds, anchors = (o._tensor() for o in exe.forward(is_train=False))
    del exe
    out["multibox"] = check_multibox_card_vs_cpu(
        pt, cls_preds, loc_preds, anchors, torch.as_tensor(labels, device=cls_preds.device))

    # --- the deploy graph at batch 8 and 1 with the trained weights
    for Bs in (B, 1):
        exe = ssd_bind(pt, deploy, pt.gpu(0), trained, images[:Bs], None, "null")
        for _ in range(2):
            exe.forward(is_train=False)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        det = exe.forward(is_train=False)[0].asnumpy()
        launches = ops.launch_counts()
        check(launches == with_zeros({}), ("SSD deploy launches of the port's kernels", launches))
        check(det.shape == (Bs, 8732, 6) and np.isfinite(det).all(), ("SSD detections", Bs))
        kept = (det[..., 0] >= 0).sum(axis=1)
        check(bool((kept > 0).all()), ("SSD detections above the threshold", kept))
        lat = []
        for _ in range(SSD["serve_iters"]):
            t0 = time.perf_counter()
            exe.forward(is_train=False)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(lat))
        card = profile_window(lambda: exe.forward(is_train=False))
        det_ms, det_card = time_detection(pt, deploy, trained, images[:Bs])
        out["deploy_batch%d" % Bs] = {
            "latency_ms_p50": med, "latency_ms_p80": float(np.percentile(lat, 80)),
            "images_per_s": Bs * 1e3 / med, "device_busy_ms": card["device_busy_ms"],
            "device_idle_share": card["device_idle_share"],
            "device_launches_per_request": card["device_events_per_call"],
            "detection_ms_p50": det_ms, "detection_device_busy_ms": det_card["device_busy_ms"],
            "detection_launches": det_card["device_events_per_call"],
            "detection_share_of_latency": det_ms / med,
            "detections_per_image": [int(k) for k in kept],
            "top_device_ms": card["top_device_ms"]}
        del exe
    out["port_kernel_launches"] = {"fit": {k: v for k, v in fit_launches.items() if v},
                                   "deploy": {k: v for k, v in launches.items() if v}}
    check_tf32_off()
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    return fit_launches



# Phase 14: the KVStore and the row-sparse round. The recommender at the
# defaults of models/recommender.get_symbol (tables 65536 x 64 and 32768 x 64,
# dense 16, bottom (128,), top (512, 256)) at the chip batch of 512 over two
# contexts on the one card; kernel 6 at its four FC+relu sites' shapes, per
# executor (256 rows) and on one context (512).
KVSTORE = dict(batch=512, contexts=2, batches=8, lr_sgd=0.05, momentum=0.9, lr_adam=0.002,
               check_steps=3, timed_steps=6, mlp_batch=40, mlp_steps=3, dist_steps=3,
               seed=SEED + 71)
REC_NAMES = ["dense", "item", "user"]  # NDArrayIter's order: a dict's sorted keys
REC_FC = [("bot_fc0", 16, 128), ("bot_fc1", 128, 64), ("top_fc0", 193, 512),
          ("top_fc1", 512, 256)]
REC_TOL = dict(rtol=1e-4, atol=1e-5)


def click_data(n, seed):
    """A synthetic click task from a numpy seed: ids over the full tables,
    16 dense features, and a label that is a fixed function of (user, item,
    dense), so the loss can fall."""
    rs = np.random.RandomState(seed)
    user = rs.randint(0, 65536, n)
    item = rs.randint(0, 32768, n)
    dense = rs.randn(n, 16).astype(np.float32)
    v = np.random.RandomState(seed + 1).randn(16).astype(np.float32)
    score = dense @ v + 0.5 * (user % 2 * 2 - 1) - 0.5 * (item % 3 == 0)
    return {"user": user.astype(np.float32), "item": item.astype(np.float32),
            "dense": dense, "label": (score > 0).astype(np.float32)}


def rec_params(net, seed):
    """Random weights from a numpy seed: the tables uniform in +-0.05, each
    FullyConnected weight normal with variance 2 / fan-in, biases 0."""
    rs = np.random.RandomState(seed)
    B = KVSTORE["batch"]
    arg_shapes, _, _ = net.infer_shape(user=(B,), item=(B,), dense=(B, 16), label=(B,))
    out = {}
    for name, shape in zip(net.list_arguments(), arg_shapes):
        if name in REC_NAMES + ["label"]:
            continue
        if name.endswith("_embed_weight"):
            out[name] = rs.uniform(-0.05, 0.05, shape).astype(np.float32)
        elif name.endswith("_weight"):
            out[name] = (rs.randn(*shape) * math.sqrt(2.0 / shape[1])).astype(np.float32)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def rec_batches(pt, data, ctx):
    """The data as DataBatches of 512 on ``ctx``."""
    B = KVSTORE["batch"]
    out = []
    for i in range(len(data["label"]) // B):
        sl = slice(i * B, (i + 1) * B)
        out.append(pt.io.DataBatch(data=[pt.nd.array(data[n][sl], ctx=ctx) for n in REC_NAMES],
                                   label=[pt.nd.array(data["label"][sl], ctx=ctx)], pad=0,
                                   index=None))
    return out


def rec_module(pt, net, ctxs, params, kvstore, optimizer, opt_params):
    B = KVSTORE["batch"]
    mod = pt.mod.Module(net, data_names=REC_NAMES, label_names=["label"], context=ctxs)
    mod.bind(data_shapes=[("dense", (B, 16)), ("item", (B,)), ("user", (B,))],
             label_shapes=[("label", (B,))])
    mod.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu()) for k, v in params.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer, optimizer_params=opt_params)
    return mod


def logistic_loss(mod, batches):
    """The mean logistic loss of ``mod``'s predictions over ``batches``."""
    total = 0.0
    for b in batches:
        mod.forward(b, is_train=False)
        p = np.clip(mod.get_outputs()[0].asnumpy().reshape(-1), 1e-7, 1 - 1e-7)
        y = b.label[0].asnumpy()
        total += float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    return total / len(batches)


def check_recommender_fc(randn, peaks, entries):
    """Kernel 6 at the recommender's four FC+relu shapes, per executor (256
    rows) and on one context (512): against its plain version, ``addmm`` +
    relu and its bound, each timed between CUDA events. top_fc0's K = 193
    takes the kernel's 4-byte-copy route (K % 4 != 0)."""
    from mxnet_tpu_torch.ops import matmul_bias_act as mba

    rows = []
    for Mr in (KVSTORE["batch"] // KVSTORE["contexts"], KVSTORE["batch"]):
        for site, K, N in REC_FC:
            a, w, b = randn(Mr, K), randn(N, K, scale=1.0 / math.sqrt(K)), randn(N, scale=0.1)
            c, pc = mba.matmul_bias_act(a, w, b, "relu"), mba.matmul_bias_act_plain(a, w, b,
                                                                                  "relu")
            torch.cuda.synchronize()
            err = float((c - pc).abs().max())
            check(math.isfinite(err) and err <= TOL["matmul_bias_act"],
                  ("recommender fc", site, Mr, K, N, err))
            ms = event_ms(lambda: mba.matmul_bias_act(a, w, b, "relu"), 30)
            plain_ms = event_ms(lambda: mba.matmul_bias_act_plain(a, w, b, "relu"), 30)
            lib_ms = event_ms(lambda: torch.relu(torch.addmm(b, a, w.t())), 30)
            b_ms, b_by, f32_ms = product_bound(2.0 * Mr * N * K + 2.0 * Mr * N,
                                               4.0 * (Mr * K + N * K + N + Mr * N), peaks)
            rec = {"phase": "kernel", "name": "matmul_bias_act_recommender", "site": site,
                   "shape": [Mr, K, N], "max_abs_err": err, "event_ms": ms,
                   "plain_event_ms": plain_ms, "library_event_ms": lib_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "f32_bound_ms": f32_ms,
                   "schedule": mba._schedule(Mr, N, K), "k_mod_4": K % 4}
            log(rec)
            rows.append(rec)
    entries["matmul_bias_act"]["recommender_fc"] = [
        {k: r[k] for k in ("site", "shape", "event_ms", "plain_event_ms", "library_event_ms",
                           "bound_ms", "max_abs_err")} for r in rows]
    return rows


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_kvstore(pt, smi, peaks, entries):
    """Phase 14: the KVStore, the row-sparse round and several contexts.
    The full-width recommender through ``Module.fit(kvstore='device')`` over
    ``[gpu(0), gpu(0)]`` at batch 512 (one epoch of SGD with momentum, then
    one of Adam), its embedding gradients through the sparse round and the
    lazy update: the loss falls, the tables' states are ``RowSparseState``,
    ``kvstore.sparse_rows_pushed`` ticks, untouched rows keep their initial
    weights bit for bit and have no state, kernel 6 launches 4 times an
    executor a step; three steps card vs CPU (rtol 1e-4, atol 1e-5); step
    time, the device's idle share and ``update()``'s host time. The MNIST
    ``mlp`` over one context at batch 40 and two at 20 + 20 agree. One NCCL
    rank of ``dist_sync`` gives the bits of a ``local`` store. Returns the
    recommender fit's launches."""
    from mxnet_tpu_torch import models, ops, telemetry

    check_tf32_off()
    t_phase = time.perf_counter()
    old_tm = os.environ.get("MXNET_TELEMETRY")
    os.environ["MXNET_TELEMETRY"] = "counters"
    out = {"phase": "kvstore", "nvidia_smi": smi}
    dev = pt.gpu(0).torch_device
    gen = torch.Generator(device=dev).manual_seed(KVSTORE["seed"])

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    out["fc_kernels"] = len(check_recommender_fc(randn, peaks, entries))

    B, nb = KVSTORE["batch"], KVSTORE["batches"]
    net = models.get_symbol("recommender")
    params = rec_params(net, KVSTORE["seed"])
    data = click_data(B * nb, KVSTORE["seed"] + 2)
    card = [pt.gpu(0)] * KVSTORE["contexts"]
    host = [pt.cpu(i) for i in range(KVSTORE["contexts"])]
    batches = rec_batches(pt, data, pt.gpu(0))
    sgd = (("learning_rate", KVSTORE["lr_sgd"]), ("momentum", KVSTORE["momentum"]))
    adam = (("learning_rate", KVSTORE["lr_adam"]),)

    # -- the main path: Module.fit through the store, two epochs
    mod = rec_module(pt, net, card, params, "device", "sgd", sgd)
    loss_first = logistic_loss(mod, batches[:1])
    counters = ("kvstore.sparse_rows_pushed", "kvstore.push_calls", "embedding.rows_touched",
                "embedding.host_syncs")
    c0 = {k: telemetry.counter(k).value for k in counters}
    with pt.gpu(0):
        it = pt.io.NDArrayIter({n: data[n] for n in REC_NAMES}, {"label": data["label"]},
                               batch_size=B)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore="device", optimizer="sgd", optimizer_params=sgd,
            eval_metric="mse")
    sgd_args, _ = mod.get_params()
    mod2 = rec_module(pt, net, card, {k: v.asnumpy() for k, v in sgd_args.items()}, "device",
                      "adam", adam)
    it.reset()
    mod2.fit(it, num_epoch=1, kvstore="device", optimizer="adam", optimizer_params=adam,
             eval_metric="mse")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = 2 * nb
    check(launches == with_zeros({"matmul_bias_act": 4 * KVSTORE["contexts"] * steps}),
          ("recommender fit launches", launches))
    loss_last = logistic_loss(mod2, batches)
    check(math.isfinite(loss_last) and loss_last < loss_first,
          ("recommender loss", loss_first, loss_last))
    c1 = {k: telemetry.counter(k).value for k in counters}
    check(c1["kvstore.sparse_rows_pushed"] > c0["kvstore.sparse_rows_pushed"],
          "sparse_rows_pushed ticks")
    final, _ = mod2.get_params()
    untouched_rows = 0
    for m in (mod, mod2):
        kv = m._kvstore
        check(kv is not None and kv.type == "device" and m._update_on_kvstore, "device store")
        for idx, name in enumerate(m._param_names):
            if not name.endswith("_embed_weight"):
                continue
            st = kv._updater.states[idx]
            check(isinstance(st, pt.sparse.RowSparseState), (name, type(st).__name__))
            ids = data["user" if name.startswith("user") else "item"].astype(np.int64)
            untouched = np.setdiff1d(np.arange(params[name].shape[0]), ids)
            check(not np.isin(st.indices, untouched).any(), (name, "state on untouched rows"))
            w = final[name].asnumpy()
            check(np.array_equal(w[untouched], params[name][untouched]),
                  (name, "untouched rows changed"))
            untouched_rows += untouched.size
    out["fit"] = {"seconds": fit_s, "steps": steps, "batch": B, "contexts": len(card),
                  "loss_first_batch": loss_first, "loss_after": loss_last,
                  "launches": {k: v for k, v in launches.items() if v},
                  "counters": {k: c1[k] - c0[k] for k in counters},
                  "untouched_rows_checked": untouched_rows,
                  "state_rows": {mod2._param_names[i]: int(mod2._kvstore._updater.states[i].nnz)
                                 for i in (0, 1)}}

    # -- three steps, card vs CPU, from the same numpy weights and batches
    def three_steps(ctxs, ctx):
        m = rec_module(pt, net, ctxs, params, "device", "sgd", sgd)
        for b in rec_batches(pt, {k: v[:B * KVSTORE["check_steps"]] for k, v in data.items()},
                             ctx):
            m.forward_backward(b)
            m.update()
        args, _ = m.get_params()
        return {k: v.asnumpy() for k, v in args.items()}

    got = three_steps(card, pt.gpu(0))
    # the CPU's distinct contexts would engage the fused step: the
    # per-device path there too, as on the card's duplicate contexts
    with pt.cpu(), env_vars(MXNET_MODULE_FUSED_STEP="0"):
        want = three_steps(host, pt.cpu())
    worst = 0.0
    for k in want:
        check(np.allclose(got[k], want[k], **REC_TOL), ("recommender card vs cpu", k))
        worst = max(worst, float(np.abs(got[k] - want[k]).max()))
    out["card_vs_cpu"] = {"steps": KVSTORE["check_steps"], "max_abs_diff": worst, **REC_TOL}

    # -- step time, update()'s host time, idle share (the trained module)
    step_ms, update_ms, host_ms = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    syncs0 = telemetry.counter("embedding.host_syncs").value
    for i in range(KVSTORE["timed_steps"]):
        b = batches[i % nb]
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        start.record()
        mod2.forward_backward(b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod2.update()
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t1) * 1e3)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t_step) * 1e3)
        step_ms.append(start.elapsed_time(end))
    syncs = (telemetry.counter("embedding.host_syncs").value - syncs0) / KVSTORE["timed_steps"]

    def one_step():
        mod2.forward_backward(batches[0])
        mod2.update()

    for _ in range(4):
        prof = profile_window(one_step)
        if prof["device_busy_ms"] > 0:
            break
        time.sleep(PROFILER_GAP_S)
    check(prof["device_busy_ms"] > 0, "recommender step: the profiler shows no device time")
    out["step"] = {"event_ms_p50": float(np.median(step_ms)), "event_ms": step_ms,
                   "host_ms_p50": float(np.median(host_ms)),
                   "update_host_ms_p50": float(np.median(update_ms)),
                   "update_share_of_step": float(np.median(update_ms) / np.median(step_ms)),
                   "from_dense_host_syncs_per_step": syncs,
                   "samples_per_s": B * 1e3 / float(np.median(step_ms)),
                   "wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
                   "device_idle_share": prof["device_idle_share"],
                   "top_device_ms": prof["top_device_ms"]}
    del mod, mod2

    # -- several contexts: the MNIST mlp over [gpu(0)] at 40 and [gpu(0)] * 2
    t0 = time.perf_counter()
    mlp = models.get_symbol("mlp", num_classes=10)
    Bm = KVSTORE["mlp_batch"]
    rs = np.random.RandomState(KVSTORE["seed"] + 5)
    x = rs.rand(Bm * KVSTORE["mlp_steps"], 784).astype(np.float32)
    y = rs.randint(0, 10, Bm * KVSTORE["mlp_steps"]).astype(np.float32)
    shapes, _, _ = mlp.infer_shape(data=(Bm, 784))
    mlp_params = {n: (rs.randn(*s) * 0.05).astype(np.float32)
                  for n, s in zip(mlp.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
    results, mlp_launches = [], []
    for ctxs in ([pt.gpu(0)], [pt.gpu(0), pt.gpu(0)]):
        m = pt.mod.Module(mlp, context=ctxs)
        m.bind(data_shapes=[("data", (Bm, 784))], label_shapes=[("softmax_label", (Bm,))])
        m.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu())
                                  for k, v in mlp_params.items()})
        m.init_optimizer(kvstore="device", optimizer="sgd",
                         optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
        if len(ctxs) == 2:
            ptrs = {a._tensor().data_ptr() for a in m._exec_group.param_arrays[0]}
            check(len(ptrs) == 2 and m._kvstore is not None, "two contexts, two tensors, a store")
        ops.reset_launch_counts()
        for i in range(KVSTORE["mlp_steps"]):
            sl = slice(i * Bm, (i + 1) * Bm)
            m.forward_backward(pt.io.DataBatch(data=[pt.nd.array(x[sl], ctx=pt.gpu(0))],
                                               label=[pt.nd.array(y[sl], ctx=pt.gpu(0))],
                                               pad=0, index=None))
            m.update()
        mlp_launches.append(ops.launch_counts()["matmul_bias_act"])
        args, _ = m.get_params()
        results.append({k: v.asnumpy() for k, v in args.items()})
    mlp_worst = 0.0
    for k in results[0]:
        check(np.allclose(results[1][k], results[0][k], **REC_TOL), ("mlp contexts", k))
        mlp_worst = max(mlp_worst, float(np.abs(results[1][k] - results[0][k]).max()))
    check(mlp_launches == [2 * KVSTORE["mlp_steps"], 4 * KVSTORE["mlp_steps"]],
          ("mlp launches", mlp_launches))
    out["multi_context"] = {"max_abs_diff": mlp_worst, "launches": mlp_launches,
                            "seconds": time.perf_counter() - t0, **REC_TOL}

    # -- dist_sync on one NCCL rank: the bits of a local store
    t0 = time.perf_counter()
    env = {"MXNET_TPU_COORDINATOR": "127.0.0.1:%d" % free_port(),
           "MXNET_TPU_NUM_WORKERS": "1", "MXNET_TPU_WORKER_ID": "0"}
    # the per-device path (a dist store would engage the fused step, which
    # phase 15 drives)
    with env_vars(**env, MXNET_MODULE_FUSED_STEP="0"):
        try:
            dist_args = []
            for kv in ("dist_sync", pt.kv.create("local")):
                m = rec_module(pt, net, [pt.gpu(0)], params, kv, "sgd", sgd)
                for b in batches[:KVSTORE["dist_steps"]]:
                    m.forward_backward(b)
                    m.update()
                args, _ = m.get_params()
                dist_args.append({k: v.asnumpy() for k, v in args.items()})
                if kv == "dist_sync":
                    check(m._kvstore.type == "dist_sync" and m._kvstore.num_workers == 1
                          and pt.dist.is_initialized() and pt.dist.backend() == "nccl",
                          "one NCCL rank")
            for k in dist_args[1]:
                check(np.array_equal(dist_args[0][k], dist_args[1][k]), ("dist_sync vs local", k))
        finally:
            pt.dist.shutdown()
    check(not pt.dist.is_initialized(), "process group destroyed")
    out["dist_sync"] = {"backend": "nccl", "world": 1, "steps": KVSTORE["dist_steps"],
                        "bitwise_equal_to_local": True, "seconds": time.perf_counter() - t0}

    if old_tm is None:
        os.environ.pop("MXNET_TELEMETRY", None)
    else:
        os.environ["MXNET_TELEMETRY"] = old_tm
    check_tf32_off()
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    return launches


# Phase 15: the fused training step (module/spmd_adapter.py over
# parallel.SPMDTrainer): ResNet-50 at phase 9's settings (batch 32, its 4
# fixed batches, SGD-momentum) through Module.fit on [gpu(0)] with
# MXNET_MODULE_FUSED_STEP=1, each step one CUDA graph; MXNET_TRAIN_MEGASTEP_N=4;
# the scheduler and the anomaly guard inside the graph (momentum 0, so that a
# frozen lr freezes the weights); the recommender at phase 14's settings on
# one context with Adam; the bucketed LSTM LM of phase 12 over two of its
# buckets; dist_sync on one NCCL rank. ``timed_steps`` steps of each kind are
# timed in turns; ``check_batch`` is the card-vs-CPU ResNet step's batch.
FUSED = dict(check_steps=3, timed_steps=8, check_batch=2, megastep_n=4, guard_steps=4,
             rec_steps=3, rec_timed_steps=8, lstm_buckets=(30, 60), lstm_batches=8,
             mlp_steps=3, budget_s=60.0)
# the ResNet step's parameters and moving stats, fused against the per-device
# path on the card (the same kernels, summed in the same order: expected
# equal; the flat update runs the per-key op's expression), as phase 9 holds
# Module.fit against the manual loop
FUSED_TOL = dict(vs_per_device=1e-6)


def fused_resnet_module(pt, net, args, aux, ctx, B, opt_params, fused=True, megastep_n=None):
    """ResNet-50 bound at batch ``B`` on ``ctx`` from the same weights, its
    optimizer set up with the fused step (MXNET_MODULE_FUSED_STEP=1) or on
    the per-device path."""
    mod = pt.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (B,) + image_shape())], label_shapes=[("softmax_label", (B,))])
    mod.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu()) for k, v in args.items()},
                    aux_params={k: pt.nd.array(v, ctx=pt.cpu()) for k, v in aux.items()})
    with env_vars(MXNET_MODULE_FUSED_STEP="1" if fused else None,
                  MXNET_TRAIN_MEGASTEP_N=None if megastep_n is None else str(megastep_n)):
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
    check((mod._spmd is not None) == fused, ("fused step active", fused))
    return mod


def module_arrays(mod):
    args, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()}, {k: v.asnumpy() for k, v in aux.items()})


def worst_rel(got, want):
    """(the array, its largest difference over its largest magnitude, the
    largest absolute difference) over two {name: array} dicts."""
    rels = {k: rel_diff(got[k], want[k]) for k in want}
    k = max(rels, key=rels.get)
    return k, rels[k], max(float(np.abs(got[n] - want[n]).max()) for n in want)


def timed_turns(fns, rounds, sync=None):
    """Host ms of each of ``fns`` (each ending in ``sync``, by default a
    synchronize of the device), called in turns, the order flipping each
    round."""
    sync = sync or torch.cuda.synchronize
    host = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for kind in (names if r % 2 == 0 else names[::-1]):
            sync()
            t0 = time.perf_counter()
            fns[kind]()
            sync()
            host[kind].append((time.perf_counter() - t0) * 1e3)
    return {k: {"p50": float(np.percentile(v, 50)), "p80": float(np.percentile(v, 80)),
                "all": v} for k, v in host.items()}


def one_graph(mod):
    """The fused step's one captured program (a CUDA graph)."""
    graphs = list(mod._spmd.trainer._graphs.values())
    check(len(graphs) == 1, ("captured programs", len(graphs)))
    return graphs[0]


def run_fused_step(pt, smi, lstm_tokens_per_s):
    """Phase 15: the fused training step, forward, backward and the update
    as one CUDA graph. Returns its launches by kernel (ResNet-50's
    Module.fit, the recommender's and the LSTM's fused steps)."""
    from mxnet_tpu_torch import models, ops, telemetry
    from mxnet_tpu_torch.models import resnet

    t_phase = time.perf_counter()
    check_tf32_off()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # conv0 and the stride-2 3x3s: the same bits
    net = resnet.get_symbol(**RESNET)
    args, aux = resnet_values(net)
    B, nb = RESNET_TRAIN["batch"], MODULE["batches"]
    images, labels = module_data(B * nb)
    opt_params = (("learning_rate", RESNET_TRAIN["lr"]), ("momentum", RESNET_TRAIN["momentum"]),
                  ("wd", RESNET_TRAIN["wd"]), ("rescale_grad", 1.0 / B))
    with pt.gpu(0):
        train = pt.io.NDArrayIter(images, labels, batch_size=B, shuffle=False)
    batches = list(train)
    train.reset()
    launches = {}

    # --- 1. ResNet-50 through Module.fit, one CUDA graph a step
    t0 = time.perf_counter()
    fit_mod = pt.mod.Module(net, context=pt.gpu(0))
    losses = []

    def record_loss(param):
        prob = param.locals["self"].get_outputs()[0]._tensor()
        lab = param.locals["data_batch"].label[0]._tensor().long().reshape(-1, 1)
        losses.append(float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean()))

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with env_vars(MXNET_MODULE_FUSED_STEP="1"):
        fit_mod.fit(train, eval_metric="acc", optimizer="sgd", optimizer_params=opt_params,
                    arg_params=args, aux_params=aux, batch_end_callback=record_loss,
                    num_epoch=MODULE["epochs"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = ops.launch_counts()
    steps = nb * MODULE["epochs"]
    check(fit_mod._spmd is not None, "Module.fit: the fused step is not active")
    graph = one_graph(fit_mod)
    per_replay = {k: v for k, v in graph.replay_launches[0].items() if v}
    check(per_replay == {"conv_bn": RESNET_SITES, "conv_bn_bwd": RESNET_SITES},
          ("a captured ResNet step's launches", per_replay))
    check(graph.replays == steps - 1, ("replays", graph.replays, steps))
    check(fit_launches == with_zeros({"conv_bn": RESNET_SITES * steps,
                                      "conv_bn_bwd": RESNET_SITES * steps}),
          ("fused Module.fit launch counts", fit_launches))
    first, last = float(np.mean(losses[:nb])), float(np.mean(losses[-nb:]))
    check(len(losses) == steps and all(math.isfinite(v) for v in losses) and last < first,
          ("the fused fit's loss did not fall", losses))
    launches["resnet"] = {k: fit_launches[k] for k in ("conv_bn", "conv_bn_bwd")}

    # the profiler over one replayed step: its port kernels by name

    fused_step = step_of(fit_mod, batches)
    for _ in range(4):
        ops.reset_launch_counts()
        prof = profile_window(fused_step)
        if prof["device_busy_ms"] > 0:
            break
        time.sleep(PROFILER_GAP_S)
    check(prof["wrapper_launches"] == {"conv_bn": RESNET_SITES, "conv_bn_bwd": RESNET_SITES},
          ("a replayed step's counted launches", prof["wrapper_launches"]))
    out = {"phase": "fused_step", "part": "resnet_fit", "nvidia_smi": smi,
           "model": RESNET, "batch": B, "steps": steps, "fit_s": fit_s,
           "captured_launches_per_step": per_replay, "replays": graph.replays,
           "fit_launches": {k: v for k, v in fit_launches.items() if v},
           "loss_first_epoch": first, "loss_last_epoch": last,
           "profiler_replay_launches": prof["port_kernel_launches"],
           "replay_window": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                   "device_idle_share", "port_kernels_ms",
                                                   "device_events_per_call")}}

    # after 3 steps: fused against the per-device path on the card
    ref = fused_resnet_module(pt, net, args, aux, pt.gpu(0), B, opt_params, fused=False)
    fused = fused_resnet_module(pt, net, args, aux, pt.gpu(0), B, opt_params)
    for mod in (ref, fused):
        for i in range(FUSED["check_steps"]):
            mod.forward_backward(batches[i])
            mod.update()
    (ra, rx), (fa, fx) = module_arrays(ref), module_arrays(fused)
    name, rel, absd = worst_rel({**fa, **fx}, {**ra, **rx})
    check(rel <= FUSED_TOL["vs_per_device"], ("fused vs per-device", name, rel, absd))
    out.update(vs_per_device={"steps": FUSED["check_steps"], "worst_array": name,
                              "max_rel": rel, "max_abs": absd,
                              "tol_rel": FUSED_TOL["vs_per_device"]})

    # the batch-2 fused step's gradients (the step body the graph captures,
    # run eagerly), card against CPU, held as phase 6 holds the per-device
    # step's: within rtol 1e-3, atol 1e-3·max|grad| of the CPU's float32
    # gradient, or as close to the float64 one as RESNET_F64_FACTOR times
    # the CPU's own, the CPU pinned to the card's side at every ReLU kink
    Bc = FUSED["check_batch"]

    def fused_grads(ctx, dtype, kinks):
        mesh = pt.parallel.make_mesh((1,), ("data",), [ctx])
        tr = pt.parallel.SPMDTrainer(net, mesh, optimizer="sgd", optimizer_params={
            "learning_rate": RESNET_TRAIN["lr"], "momentum": RESNET_TRAIN["momentum"],
            "rescale_grad": 1.0 / Bc})
        tr.set_params({k: v.astype(dtype) for k, v in args.items()},
                      {k: v.astype(dtype) for k, v in aux.items()})
        placed = tr._place_batch({"data": images[:Bc].astype(dtype)},
                                 {"softmax_label": labels[:Bc].astype(dtype)})
        tr._build()
        with kinks as flips:
            outs, _ = tr._one_step(placed, tr._lr_tensor(RESNET_TRAIN["lr"]))
        prob = outs[0].double()
        loss = float(-torch.log(prob.gather(1, placed["softmax_label"].long().reshape(-1, 1))
                                .clamp_min(1e-30)).mean())
        grads = {n: g.double().cpu().numpy()
                 for n, g in tr._state.flats["grads_by_name"].items()}
        new_aux = {n: a.double().cpu().numpy() for n, a in tr.aux.items()}
        return grads, new_aux, loss, flips

    card_kinks = []
    got = fused_grads(pt.gpu(0), np.float32, relu_kinks(record=card_kinks))
    want = fused_grads(pt.cpu(), np.float32, relu_kinks(compare=card_kinks, pin=True))
    exact = fused_grads(pt.cpu(), np.float64, relu_kinks(compare=card_kinks, pin=True))
    strict = [n for n in got[0] if np.allclose(got[0][n], want[0][n], rtol=1e-3,
                                               atol=1e-3 * float(np.abs(want[0][n]).max()))]
    card64 = {n: rel_diff(got[0][n], exact[0][n]) for n in got[0]}
    cpu64 = {n: rel_diff(want[0][n], exact[0][n]) for n in got[0]}
    gscale = max(float(np.abs(g).max()) for g in exact[0].values())
    null = {n for n in got[0] if float(np.abs(exact[0][n]).max()) <= 1e-6 * gscale}
    loose = [n for n in got[0] if n not in strict and n not in null]
    bad = [n for n in loose if card64[n] > RESNET_F64_FACTOR * cpu64[n]]
    aux_rel = max(rel_diff(got[1][n], want[1][n]) for n in got[1])
    check(abs(got[2] - want[2]) <= 1e-3 * max(1.0, abs(want[2])),
          ("fused batch-2 loss card vs CPU", got[2], want[2]))
    check(not bad and aux_rel <= 1e-3, ("fused batch-2 grads card vs CPU", bad[:5], aux_rel))
    n_flips = sum(n for n, _ in want[3])
    out.update(card_vs_cpu={"batch": Bc, "loss_card": got[2], "loss_cpu": want[2],
                            "grads": len(got[0]), "grads_within_1e-3_of_cpu": len(strict),
                            "null_grads": len(null), "relu_kinks_pinned": n_flips,
                            "worst_ratio": max([card64[n] / max(cpu64[n], 1e-30)
                                                for n in loose] or [0.0]),
                            "card_vs_cpu_worst": max(rel_diff(got[0][n], want[0][n])
                                                     for n in got[0]),
                            "moving_stats_worst": aux_rel, "f64_factor": RESNET_F64_FACTOR})

    # the fused step against the per-device one, in turns: host, card, idle
    host = timed_turns({"fused": step_of(fused, batches), "per_device": step_of(ref, batches)},
                       FUSED["timed_steps"])
    # CUDA events over 10 queued replays (the per-device step reads back on
    # the host, so its card time is the profiler's busy time below)
    card = {"fused": event_ms(step_of(fused, batches), 10)}
    windows = {}
    for kind, fn in (("fused", step_of(fused, batches)), ("per_device", step_of(ref, batches))):
        for _ in range(4):
            w = profile_window(fn)
            if w["device_busy_ms"] > 0:
                break
            time.sleep(PROFILER_GAP_S)
        windows[kind] = {k: w[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                           "device_events_per_call", "port_kernel_launches")}
    # the profiler sees every kernel of the eager per-device step in a replay
    check(prof["port_kernel_launches"] == windows["per_device"]["port_kernel_launches"]
          and prof["port_kernel_launches"].get("conv_bn", 0) >= RESNET_SITES
          and prof["port_kernel_launches"].get("conv_bn_bwd", 0) >= RESNET_SITES,
          ("a replay's kernels in the profiler", prof["port_kernel_launches"],
           windows["per_device"]["port_kernel_launches"]))
    # update()'s share of a step's host time on each path
    shares = {}
    for kind, mod in (("fused", fused), ("per_device", ref)):
        fb, up = [], []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(batches[i % nb])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mod.update()
            torch.cuda.synchronize()
            fb.append(t1 - t0)
            up.append(time.perf_counter() - t1)
        shares[kind] = float(np.median(up) / (np.median(fb) + np.median(up)))
    out.update(step_ms=host, card_event_ms=card, windows=windows, update_share=shares)
    log(out)
    del fit_mod, ref

    # --- 2. MXNET_TRAIN_MEGASTEP_N=4 against N=1: bitwise after 8 steps
    n4 = fused_resnet_module(pt, net, args, aux, pt.gpu(0), B, opt_params,
                             megastep_n=FUSED["megastep_n"])
    n1 = fused_resnet_module(pt, net, args, aux, pt.gpu(0), B, opt_params)
    saved_mode = telemetry.current_override()
    telemetry.set_mode("counters")
    dispatches = {}
    for kind, mod in (("n1", n1), ("n4", n4)):
        c0 = telemetry.counter("trainer.dispatches").value
        for i in range(2 * FUSED["megastep_n"]):
            mod.forward_backward(batches[i % nb])
            mod.update()
        mod.flush_pending_steps()
        dispatches[kind] = telemetry.counter("trainer.dispatches").value - c0
    telemetry.set_mode(saved_mode)
    (a1, x1), (a4, x4) = module_arrays(n1), module_arrays(n4)
    differ = sorted(k for k in {**a1, **x1} if not np.array_equal({**a1, **x1}[k],
                                                                   {**a4, **x4}[k]))
    check(not differ, ("N=4 vs N=1 not bitwise", differ[:5]))
    check(dispatches == {"n1": 8, "n4": 2}, ("dispatches", dispatches))
    check(one_graph(n4).replays == 1, "the N=4 graph replayed once")

    mhost = timed_turns({"n4": step_of(n4, batches, FUSED["megastep_n"]),
                         "n1": step_of(n1, batches, FUSED["megastep_n"])},
                        FUSED["timed_steps"] // 2)
    per_step = {k: v["p50"] / FUSED["megastep_n"] for k, v in mhost.items()}
    log({"phase": "fused_step", "part": "megastep", "n": FUSED["megastep_n"],
         "steps": 2 * FUSED["megastep_n"], "bitwise_equal": True, "dispatches": dispatches,
         "step_ms_p50_per_step": per_step, "dispatch_ms": mhost})
    del n4, n1

    # --- 3. the scheduler and the guard inside the graph (momentum 0)
    with env_vars(MXNET_ANOMALY_GUARD="skip"):
        sched = pt.lr_scheduler.FactorScheduler(step=1, factor=1e-8)
        gm = fused_resnet_module(pt, net, args, aux, pt.gpu(0), B,
                                 (("learning_rate", RESNET_TRAIN["lr"]), ("momentum", 0.0),
                                  ("rescale_grad", 1.0 / B), ("lr_scheduler", sched)))
        gm.forward_backward(batches[0])
        gm.update()
        after1 = module_arrays(gm)[0]
        for i in range(1, FUSED["guard_steps"]):
            gm.forward_backward(batches[i % nb])
            gm.update()
        after_n, aux_n = module_arrays(gm)
        frozen = max(float(np.abs(after_n[k] - after1[k]).max()) for k in after1)
        check(frozen <= 1e-6, ("the scheduler's lr did not reach the graph", frozen))
        moved = max(rel_diff(after1[k], args[k]) for k in after1)
        check(moved > 0, "step 1 did not move the weights")
        tr = gm._spmd.trainer
        t_before = int(tr.opt_state["t"])
        nan_images = images[:B].copy()
        nan_images[0, 0, 0, 0] = np.nan
        gm.forward_backward(pt.io.DataBatch(data=[pt.nd.array(nan_images, ctx=pt.gpu(0))],
                                            label=[pt.nd.array(labels[:B], ctx=pt.gpu(0))]))
        gm.update()
        after_nan, aux_nan = module_arrays(gm)
        check(gm.skipped_steps == 1, ("skipped steps", gm.skipped_steps))
        check(all(np.array_equal(after_nan[k], after_n[k]) for k in after_n)
              and all(np.array_equal(aux_nan[k], aux_n[k]) for k in aux_n)
              and int(tr.opt_state["t"]) == t_before,
              "a NaN batch changed the params, the moving stats or the optimizer state")
        check(one_graph(gm).replays == FUSED["guard_steps"], "the NaN step replayed the graph")
    log({"phase": "fused_step", "part": "schedule_and_guard", "max_change_after_step_1": frozen,
         "skipped_steps": gm.skipped_steps, "nan_step_bitwise_unchanged": True,
         "replays": one_graph(gm).replays})
    del gm

    # --- 4. the recommender on one context, Adam, kernel 6 inside the graph
    rnet = models.get_symbol("recommender")
    R = KVSTORE["batch"]
    rparams = rec_params(rnet, KVSTORE["seed"])
    rdata = click_data(R * KVSTORE["batches"], KVSTORE["seed"] + 2)
    rbatches = rec_batches(pt, rdata, pt.gpu(0))
    adam = (("learning_rate", KVSTORE["lr_adam"]),)

    def rec(ctxs, fused):
        with env_vars(MXNET_MODULE_FUSED_STEP="1" if fused else None):
            m = rec_module(pt, rnet, ctxs, rparams, "device", "adam", adam)
        check((m._spmd is not None) == fused, ("recommender fused", fused))
        return m

    rf = rec([pt.gpu(0)], True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b in rbatches[:FUSED["rec_steps"]]:
        rf.forward_backward(b)
        rf.update()
    torch.cuda.synchronize()
    rec_launches = ops.launch_counts()
    rgraph = one_graph(rf)
    check({k: v for k, v in rgraph.replay_launches[0].items() if v} == {"matmul_bias_act": 4},
          ("the recommender graph's launches", rgraph.replay_launches[0]))
    check(rec_launches == with_zeros({"matmul_bias_act": 4 * FUSED["rec_steps"]}),
          ("recommender fused launches", rec_launches))
    launches["recommender"] = {"matmul_bias_act": rec_launches["matmul_bias_act"]}
    card_w = {k: v.asnumpy() for k, v in rf.get_params()[0].items()}
    with pt.cpu():
        rc = rec([pt.cpu()], True)
        for b in rec_batches(pt, {k: v[:R * FUSED["rec_steps"]] for k, v in rdata.items()},
                             pt.cpu()):
            rc.forward_backward(b)
            rc.update()
        cpu_w = {k: v.asnumpy() for k, v in rc.get_params()[0].items()}
    del rc
    rworst = max(float(np.abs(card_w[k] - cpu_w[k]).max()) for k in cpu_w)
    check(all(np.allclose(card_w[k], cpu_w[k], **REC_TOL) for k in cpu_w),
          ("recommender fused card vs CPU", rworst))
    rp = rec([pt.gpu(0)], False)

    rhost = timed_turns({"fused": step_of(rf, rbatches), "per_device": step_of(rp, rbatches)},
                        FUSED["rec_timed_steps"])
    rcard = {"fused": event_ms(step_of(rf, rbatches), 10)}
    rwin = {}
    for kind, mod in (("fused", rf), ("per_device", rp)):
        for _ in range(4):
            w = profile_window(step_of(mod, rbatches))
            if w["device_busy_ms"] > 0:
                break
            time.sleep(PROFILER_GAP_S)
        rwin[kind] = {k: w[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}
    log({"phase": "fused_step", "part": "recommender", "batch": R, "optimizer": "adam",
         "captured_launches_per_step": {"matmul_bias_act": 4}, "card_vs_cpu_max_abs": rworst,
         **REC_TOL, "step_ms": rhost, "card_event_ms": rcard, "windows": rwin})
    del rf, rp

    # --- 5. the bucketed LSTM LM over two buckets: one graph a bucket, one cell
    cfg = LSTM_BUCKETING
    sentences, vocab = synthetic_corpus(cfg["sentences"], vocab_size=cfg["vocab"], seed=SEED,
                                        buckets=cfg["buckets"])
    buckets = list(FUSED["lstm_buckets"])
    with pt.gpu(0):
        it = pt.rnn.BucketSentenceIter(sentences, cfg["batch"], buckets=buckets, invalid_label=0)
        lbatches = [next(it) for _ in range(FUSED["lstm_batches"])]
        check(len({b.bucket_key for b in lbatches}) == 2, "both buckets in the batches")
        lm = pt.mod.BucketingModule(sym_gen=bucketing_module(pt, vocab, pt.gpu(0)),
                                    default_bucket_key=it.default_bucket_key,
                                    context=pt.gpu(0))
        lm.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        pt.random.seed(SEED + 61)
        lm.init_params(initializer=pt.init.Xavier(factor_type="in", magnitude=2.34))
        with env_vars(MXNET_MODULE_FUSED_STEP="1"):
            lm.init_optimizer(optimizer="sgd", optimizer_params={
                "learning_rate": cfg["lr"], "momentum": 0.0, "wd": cfg["wd"]})
    tokens, marks = 0, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b in lbatches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.forward_backward(b)
        lm.update()
        torch.cuda.synchronize()
        marks.append((b.bucket_key, time.perf_counter() - t0, int((b.data[0].asnumpy() != 0)
                                                                  .sum())))
    mods = list(lm._buckets.values())
    check(len(mods) == 2 and all(m._spmd is not None for m in mods), "a fused step a bucket")
    check(all(len(m._spmd.trainer._graphs) == 1 for m in mods), "one graph a bucket")
    ptrs = [{k: v.data_ptr() for k, v in m._spmd.trainer.params.items()} for m in mods]
    check(len({id(m._spmd.trainer._state) for m in mods}) == 1 and ptrs[0] == ptrs[1],
          "one shared state cell")
    small = min(buckets)
    before = {k: v.asnumpy() for k, v in lm.get_params()[0].items()}
    sb = next(b for b in lbatches if b.bucket_key == small)
    lm.forward_backward(sb)
    lm.update()
    after = {k: v.asnumpy() for k, v in lm.get_params()[0].items()}
    check(any(np.abs(after[k] - before[k]).max() > 0 for k in before),
          "a step through the small bucket did not move the params")
    seen, steady = set(), []
    for key, s, n in marks:
        if key in seen:
            steady.append((s, n))
        seen.add(key)
    tps = sum(n for _, n in steady) / sum(s for s, _ in steady)
    log({"phase": "fused_step", "part": "lstm_bucketing", "buckets": buckets,
         "batches": len(lbatches), "graphs_per_bucket": 1, "shared_state_cell": True,
         "replays": sorted(next(iter(m._spmd.trainer._graphs.values())).replays
                           for m in mods),
         "real_tokens_per_s_after_capture": tps,
         "phase12_per_device_tokens_per_s": lstm_tokens_per_s,
         "launches": {k: v for k, v in ops.launch_counts().items() if v}})
    del lm, mods

    # --- 6. dist_sync on one NCCL rank: the fused step, the bits of the local one
    mlp = models.get_symbol("mlp", num_classes=10)
    rs = np.random.RandomState(KVSTORE["seed"] + 5)
    Bm = KVSTORE["mlp_batch"]
    x = rs.rand(Bm * FUSED["mlp_steps"], 784).astype(np.float32)
    y = rs.randint(0, 10, Bm * FUSED["mlp_steps"]).astype(np.float32)
    shapes, _, _ = mlp.infer_shape(data=(Bm, 784))
    mlp_params = {n: (rs.randn(*s) * 0.05).astype(np.float32)
                  for n, s in zip(mlp.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
    env = {"MXNET_TPU_COORDINATOR": "127.0.0.1:%d" % free_port(),
           "MXNET_TPU_NUM_WORKERS": "1", "MXNET_TPU_WORKER_ID": "0"}
    results = []
    try:
        for kv in ("dist_sync", "local"):
            with env_vars(**(env if kv == "dist_sync" else {}),
                          MXNET_MODULE_FUSED_STEP=None if kv == "dist_sync" else "1"):
                m = pt.mod.Module(mlp, context=pt.gpu(0))
                m.bind(data_shapes=[("data", (Bm, 784))],
                       label_shapes=[("softmax_label", (Bm,))])
                m.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu())
                                          for k, v in mlp_params.items()})
                m.init_optimizer(kvstore=kv, optimizer="sgd",
                                 optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
            check(m._spmd is not None, ("the fused step under", kv))
            if kv == "dist_sync":
                check(m._kvstore.type == "dist_sync" and pt.dist.backend() == "nccl",
                      "one NCCL rank")
            for i in range(FUSED["mlp_steps"]):
                sl = slice(i * Bm, (i + 1) * Bm)
                m.forward_backward(pt.io.DataBatch(data=[pt.nd.array(x[sl], ctx=pt.gpu(0))],
                                                   label=[pt.nd.array(y[sl], ctx=pt.gpu(0))]))
                m.update()
            results.append({k: v.asnumpy() for k, v in m.get_params()[0].items()})
            del m
    finally:
        pt.dist.shutdown()
    check(not pt.dist.is_initialized(), "process group destroyed")
    check(all(np.array_equal(results[0][k], results[1][k]) for k in results[1]),
          "dist_sync fused vs local fused")
    torch.backends.cudnn.deterministic = deterministic
    check_tf32_off()
    seconds = time.perf_counter() - t_phase
    log({"phase": "fused_step", "part": "dist_sync", "backend": "nccl", "world": 1,
         "steps": FUSED["mlp_steps"], "bitwise_equal_to_local_fused": True,
         "phase_seconds": seconds, "budget_s": FUSED["budget_s"]})
    return launches


# Phase 16: fault-tolerant training (checkpoint.Checkpointer, module/elastic.py).
# ResNet-50 at phase 9's settings through the fused step with
# fit(elastic=...), a checkpoint every 4 rounds, resumed from its first one by
# a second module; the MNIST mlp on one NCCL rank of dist_sync with the
# sharded update, saved every 2 steps and resumed by a fresh module; the
# recommender at phase 14's settings over [gpu(0)] * 2, its sparse tables
# saved and resumed. Checkpoints go to a temporary directory the phase
# removes. A save's cost: ``save_rounds`` rounds, each a run of
# ``save_run`` + 1 steps without a save and one that starts with a save, in
# turns, the writer idle before each run.
CKPT = dict(period=4, save_rounds=6, save_run=24, mlp_steps=6, mlp_period=2, mlp_batch=40,
            rec_steps=3, tol_rel=1e-6)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def fused_state(mod):
    """The fused step's weights, aux values and optimizer state as numpy."""
    args, aux = module_arrays(mod)
    return args, aux, pickle.loads(mod._spmd.get_states())


def run_checkpoint(pt, smi):
    """Phase 16: the checkpoint and fault-tolerant training. Returns the
    launches of its three card runs by kernel (the ResNet-50 fits, the
    sharded mlp's steps, the recommender's)."""
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch import models, ops, telemetry
    from mxnet_tpu_torch.models import resnet

    t_phase = time.perf_counter()
    check_tf32_off()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # conv0 and the stride-2 3x3s: the same bits
    saved_mode = telemetry.current_override()
    telemetry.set_mode("counters")
    root = tempfile.mkdtemp(prefix="mxnet-ckpt-")
    launches = {}
    try:
        # --- 1. ResNet-50 through the fused step, checkpointed and resumed
        net = resnet.get_symbol(**RESNET)
        args, aux = resnet_values(net)
        B, nb, epochs = RESNET_TRAIN["batch"], MODULE["batches"], MODULE["epochs"]
        steps = nb * epochs
        images, labels = module_data(B * nb)
        opt_params = (("learning_rate", RESNET_TRAIN["lr"]),
                      ("momentum", RESNET_TRAIN["momentum"]),
                      ("wd", RESNET_TRAIN["wd"]), ("rescale_grad", 1.0 / B))
        with pt.gpu(0):
            train = pt.io.NDArrayIter(images, labels, batch_size=B, shuffle=False)
        inflight_seen = []

        def at_batch_end(param):
            # the writer's gauge after the step returned: > 0 while a save
            # made before it is still being written
            inflight_seen.append(telemetry.gauge("checkpoint.inflight").value or 0)

        def fit(directory, resume):
            mod = pt.mod.Module(net, context=pt.gpu(0))
            train.reset()
            with env_vars(MXNET_MODULE_FUSED_STEP="1"):
                ctl = mod.fit(train, eval_metric="acc", optimizer="sgd",
                              optimizer_params=opt_params, arg_params=args, aux_params=aux,
                              batch_end_callback=at_batch_end, num_epoch=epochs,
                              elastic={"checkpoint_dir": directory,
                                       "checkpoint_period": CKPT["period"], "resume": resume})
            torch.cuda.synchronize()
            check(mod._spmd is not None and not ctl.evicted and ctl._round == steps,
                  ("elastic fit", mod._spmd is not None, ctl.evicted, ctl._round))
            return mod, ctl

        dir_a = os.path.join(root, "resnet")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        mod_a, _ = fit(dir_a, False)
        fit_s = time.perf_counter() - t0
        fit_launches = ops.launch_counts()
        check(fit_launches == with_zeros({"conv_bn": RESNET_SITES * steps,
                                          "conv_bn_bwd": RESNET_SITES * steps}),
              ("elastic fit launch counts", fit_launches))
        saved_steps = ckpt.list_steps(dir_a)
        check(saved_steps == list(range(CKPT["period"], steps + 1, CKPT["period"])),
              ("checkpoint steps", saved_steps))
        step, manifest = ckpt.latest_complete(dir_a)
        check(step == steps and manifest["kind"] == "replicated"
              and "states.bin" in os.listdir(ckpt.step_dir(dir_a, step)),
              ("the newest complete step and its states.bin", step, manifest["files"]))
        check(max(inflight_seen) > 0, ("checkpoint.inflight never above 0 after a step",
                                       inflight_seen))
        # the second module resumes from the FIRST checkpoint and finishes
        dir_b = os.path.join(root, "resnet-resume")
        first = saved_steps[0]
        shutil.copytree(ckpt.step_dir(dir_a, first), ckpt.step_dir(dir_b, first))
        ops.reset_launch_counts()
        mod_b, _ = fit(dir_b, True)
        resume_launches = ops.launch_counts()
        rest = steps - first
        check(resume_launches == with_zeros({"conv_bn": RESNET_SITES * rest,
                                             "conv_bn_bwd": RESNET_SITES * rest}),
              ("resumed fit launch counts", resume_launches))
        launches["resnet"] = {k: fit_launches[k] + resume_launches[k]
                              for k in ("conv_bn", "conv_bn_bwd")}
        sa, sb = fused_state(mod_a), fused_state(mod_b)
        want = {**sa[0], **{"aux:" + k: v for k, v in sa[1].items()},
                **{"mom:" + k: v for k, v in sa[2]["mom"].items()}}
        got = {**sb[0], **{"aux:" + k: v for k, v in sb[1].items()},
               **{"mom:" + k: v for k, v in sb[2]["mom"].items()}}
        name, rel, absd = worst_rel(got, want)
        bitwise = all(np.array_equal(got[k], want[k]) for k in want)
        check(rel <= CKPT["tol_rel"] and int(sb[2]["t"]) == int(sa[2]["t"]) == steps,
              ("resumed vs uninterrupted", name, rel, absd, int(sb[2]["t"])))
        out = {"phase": "checkpoint", "part": "resnet_fused", "nvidia_smi": smi,
               "model": RESNET, "batch": B, "steps": steps, "period": CKPT["period"],
               "fit_s": fit_s, "saved_steps": saved_steps, "resumed_from": first,
               "fit_launches": {k: v for k, v in fit_launches.items() if v},
               "resume_launches": {k: v for k, v in resume_launches.items() if v},
               "arrays_compared": len(want), "worst_array": name, "max_rel": rel,
               "max_abs": absd, "bitwise": bitwise, "tol_rel": CKPT["tol_rel"],
               "inflight_after_steps": inflight_seen,
               "save_files": sorted(os.listdir(ckpt.step_dir(dir_a, step))),
               "save_bytes": dir_bytes(ckpt.step_dir(dir_a, step))}
        del mod_b

        # a save's cost, on the trained module: runs of save_run + 1 steps,
        # one without a save and one whose first step ends in the elastic
        # loop's own save (a freeze, then the writer thread), in turns. The
        # writer is idle before each run, so the runs without a save never
        # share the host with it; each step ends in a synchronize of the
        # compute stream only (the writer copies to the host on its own)
        batches = list(train)
        ctl = pt.mod.ElasticFit(mod_a, checkpoint_dir=os.path.join(root, "timed"),
                                checkpoint_period=0)
        saver = ctl._ensure_writer()
        one = step_of(mod_a, batches)
        sync = torch.cuda.current_stream().synchronize

        def with_save():
            one()
            ctl._round += 1
            ctl._save_checkpoint(0, ctl._round)

        def writing():
            with saver._cv:
                return saver._active is not None or saver._queued is not None

        def timed(fn):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            return (time.perf_counter() - t0) * 1e3

        K = CKPT["save_run"]
        runs = {"no_save": [], "save": []}
        while_writing, after_landed, to_land = [], [], []
        drops0 = telemetry.counter("checkpoint.drops").value
        for r in range(CKPT["save_rounds"]):
            for kind in (("no_save", "save") if r % 2 == 0 else ("save", "no_save")):
                saver.wait()
                if kind == "no_save":
                    runs[kind].append([timed(one) for _ in range(K + 1)])
                    continue
                ms, landed = [timed(with_save)], None
                for i in range(K):
                    busy = writing()
                    ms.append(timed(one))
                    (while_writing if busy else after_landed).append(ms[-1])
                    if landed is None and not writing():
                        landed = i + 1
                runs[kind].append(ms)
                to_land.append(landed)
        saver.wait()
        supersedes = telemetry.counter("checkpoint.drops").value - drops0

        def pct(v):
            return {"p50": float(np.percentile(v, 50)), "p80": float(np.percentile(v, 80)),
                    "n": len(v)} if v else None

        no_save = [m for run in runs["no_save"] for m in run]
        # what a save adds to a run: the run with the save less the run
        # without it, round by round
        added = [sum(a) - sum(b) for a, b in zip(runs["save"], runs["no_save"])]
        host = {"step": {**pct(no_save), "all": no_save},
                "step_with_save": {**pct([run[0] for run in runs["save"]]),
                                   "all": [run[0] for run in runs["save"]]},
                "steps_while_writing": {**(pct(while_writing) or {}), "all": while_writing},
                "steps_after_landed": {**(pct(after_landed) or {}), "all": after_landed},
                "run_ms": {k: [sum(run) for run in v] for k, v in runs.items()},
                "save_adds_to_run_ms": added,
                "save_adds_to_run_ms_p50": float(np.percentile(added, 50)),
                "steps_to_land": to_land}
        # one save alone: submit to landed, and what it wrote
        w = ckpt.Checkpointer(os.path.join(root, "alone"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights, states = mod_a._spmd.freeze()
        job = w.save_replicated(1, weights, states_bytes=states)
        submit_ms = (time.perf_counter() - t0) * 1e3
        job.done.wait()
        landed_s = time.perf_counter() - t0
        w.close()
        written = dir_bytes(ckpt.step_dir(os.path.join(root, "alone"), 1))

        # idle shares over a run with and without its save, the writer idle
        # before each; the run with a save waits for the save to land, and
        # the device synchronize that ends each window takes the writer's
        # copies to the host in
        def save_run():
            with_save()
            for _ in range(K):
                one()
            saver.wait()

        windows = {"no_save": profile_window(step_of(mod_a, batches, K + 1), per=K + 1,
                                             setup=saver.wait),
                   "save": profile_window(save_run, per=K + 1, setup=saver.wait)}
        saver.close()
        out.update(step_ms=host, supersedes=supersedes, save_submit_ms=submit_ms,
                   save_submit_to_landed_s=landed_s, save_bytes_alone=written,
                   windows=windows)
        log(out)
        del mod_a, ctl, weights, states

        # --- 2. the sharded set: the mlp on one NCCL rank of dist_sync
        mlp = models.get_symbol("mlp", num_classes=10)
        Bm, n_mlp = CKPT["mlp_batch"], CKPT["mlp_steps"]
        rs = np.random.RandomState(KVSTORE["seed"] + 9)
        x = rs.rand(Bm * n_mlp, 784).astype(np.float32)
        y = rs.randint(0, 10, Bm * n_mlp).astype(np.float32)
        shapes, _, _ = mlp.infer_shape(data=(Bm, 784))
        mlp_params = {n: (rs.randn(*s) * 0.05).astype(np.float32)
                      for n, s in zip(mlp.list_arguments(), shapes)
                      if n not in ("data", "softmax_label")}
        mlp_batches = [pt.io.DataBatch(
            data=[pt.nd.array(x[i * Bm:(i + 1) * Bm], ctx=pt.gpu(0))],
            label=[pt.nd.array(y[i * Bm:(i + 1) * Bm], ctx=pt.gpu(0))]) for i in range(n_mlp)]
        env = {"MXNET_TPU_COORDINATOR": "127.0.0.1:%d" % free_port(),
               "MXNET_TPU_NUM_WORKERS": "1", "MXNET_TPU_WORKER_ID": "0",
               "MXNET_MODULE_FUSED_STEP": "0", "MXNET_KVSTORE_UPDATE": "sharded"}
        dir_s = os.path.join(root, "sharded")

        def mlp_module():
            m = pt.mod.Module(mlp, context=pt.gpu(0))
            m.bind(data_shapes=[("data", (Bm, 784))], label_shapes=[("softmax_label", (Bm,))])
            m.init_params(arg_params={k: pt.nd.array(v, ctx=pt.cpu())
                                      for k, v in mlp_params.items()})
            m.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                             optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
            return m

        with env_vars(**env):
            try:
                m = mlp_module()
                kv = m._kvstore
                check(kv.type == "dist_sync" and kv.num_workers == 1
                      and pt.dist.backend() == "nccl" and m._spmd is None,
                      "one NCCL rank, the per-device path")
                writer = ckpt.Checkpointer(dir_s)
                ops.reset_launch_counts()
                for i, b in enumerate(mlp_batches):
                    m.forward_backward(b)
                    m.update()
                    if (i + 1) % CKPT["mlp_period"] == 0 and i + 1 < n_mlp:
                        check(kv._bucket_engine.mode == "sharded", "the sharded update")
                        writer.save_sharded(kv, i + 1, meta={"nbatch": i})
                writer.close()
                straight_launches = ops.launch_counts()
                want = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
                del m
                got_step, manifest = ckpt.latest_complete(dir_s)
                check(got_step == n_mlp - CKPT["mlp_period"] and manifest["kind"] == "sharded"
                      and manifest["world"] == 1, ("the newest sharded step", got_step))
                # the set reread with the port's readers, each shard's digest
                digests = []
                for r in range(manifest["world"]):
                    base = os.path.join(ckpt.step_dir(dir_s, got_step),
                                        "shard-%05d-of-%05d" % (r, manifest["world"]))
                    with open(base + ".json") as f:
                        side = json.load(f)
                    with open(base + ".npz", "rb") as f:
                        data = f.read()
                    digests.append(hashlib.sha256(data).hexdigest() == side["digest"]
                                   and len(data) == side["nbytes"])
                check(all(digests), ("shard digests", digests))
                shards = ckpt.read_shard_set(dir_s, got_step, manifest)
                flats = ckpt.read_flat_buckets(dir_s, got_step, manifest, shards=shards)
                per_key = ckpt.per_key_states(manifest, flats)
                m2 = mlp_module()
                loaded_step, weights = m2._kvstore.load_sharded_checkpoint(dir_s)
                names = m2._param_names
                m2.set_params({names[k]: pt.nd.array(w, ctx=pt.gpu(0))
                               for k, w in weights.items()}, {}, allow_missing=True)
                ops.reset_launch_counts()
                for b in mlp_batches[got_step:]:
                    m2.forward_backward(b)
                    m2.update()
                resumed_launches = ops.launch_counts()
                got = {k: v.asnumpy() for k, v in m2.get_params()[0].items()}
                bitwise = all(np.array_equal(got[k], want[k]) for k in want)
                check(loaded_step == got_step and bitwise,
                      ("sharded resume vs uninterrupted", loaded_step,
                       max(float(np.abs(got[k] - want[k]).max()) for k in want)))
                check(straight_launches == with_zeros({"matmul_bias_act": 2 * n_mlp})
                      and resumed_launches == with_zeros(
                          {"matmul_bias_act": 2 * (n_mlp - got_step)}),
                      ("sharded mlp launches", straight_launches, resumed_launches))
                del m2
                # the same steps through the per-key Updater, the path the
                # JAX package takes for one process: the one-rank engine's
                # weights against it
                with env_vars(MXNET_KVSTORE_UPDATE="replicated"):
                    m3 = mlp_module()
                    for b in mlp_batches:
                        m3.forward_backward(b)
                        m3.update()
                check(m3._kvstore._bucket_engine is None, "the per-key Updater")
                per_key_w = {k: v.asnumpy() for k, v in m3.get_params()[0].items()}
                vs_name, vs_rel, vs_abs = worst_rel(want, per_key_w)
                check(vs_rel <= CKPT["tol_rel"],
                      ("sharded vs per-key Updater", vs_name, vs_rel, vs_abs))
                del m3
            finally:
                pt.dist.shutdown()
        check(not pt.dist.is_initialized(), "process group destroyed")
        launches["sharded_mlp"] = {"matmul_bias_act": straight_launches["matmul_bias_act"]
                                   + resumed_launches["matmul_bias_act"]}
        log({"phase": "checkpoint", "part": "sharded_mlp", "backend": "nccl", "world": 1,
             "steps": n_mlp, "saved_steps": ckpt.list_steps(dir_s), "resumed_from": got_step,
             "buckets": len(manifest["plan"]["buckets"]), "state_keys": len(per_key),
             "shard_digests_ok": len(digests), "bitwise": bitwise,
             "vs_per_key": {"worst_array": vs_name, "max_rel": vs_rel, "max_abs": vs_abs,
                            "bitwise": all(np.array_equal(want[k], per_key_w[k])
                                           for k in want)},
             "launches": launches["sharded_mlp"],
             "shard_bytes": dir_bytes(ckpt.step_dir(dir_s, got_step))})

        # --- 3. the recommender's sparse tables, saved and resumed
        rnet = models.get_symbol("recommender")
        R = KVSTORE["batch"]
        rparams = rec_params(rnet, KVSTORE["seed"])
        rdata = click_data(R * CKPT["rec_steps"], KVSTORE["seed"] + 2)
        rbatches = rec_batches(pt, rdata, pt.gpu(0))
        sgd = (("learning_rate", KVSTORE["lr_sgd"]), ("momentum", KVSTORE["momentum"]))
        card = [pt.gpu(0)] * KVSTORE["contexts"]
        with env_vars(MXNET_MODULE_FUSED_STEP="0"):
            rm = rec_module(pt, rnet, card, rparams, "device", "sgd", sgd)
        check(rm._spmd is None and rm._kvstore is not None, "the per-device path and a store")
        ops.reset_launch_counts()
        for b in rbatches:
            rm.forward_backward(b)
            rm.update()
        rec_launches = ops.launch_counts()
        check(rec_launches == with_zeros(
            {"matmul_bias_act": 4 * KVSTORE["contexts"] * CKPT["rec_steps"]}),
            ("recommender launches", rec_launches))
        launches["recommender"] = {"matmul_bias_act": rec_launches["matmul_bias_act"]}
        kv = rm._kvstore
        dir_r = os.path.join(root, "sparse")
        t0 = time.perf_counter()
        writer = ckpt.Checkpointer(dir_r)
        writer.save_sharded(kv, CKPT["rec_steps"], block=True)
        writer.close()
        save_s = time.perf_counter() - t0
        manifest = ckpt.load_manifest(dir_r, CKPT["rec_steps"])
        check(len(manifest["sparse"]) == 2 and manifest["plan"]["buckets"] == [],
              ("the sparse section", manifest["sparse"]))
        with env_vars(MXNET_MODULE_FUSED_STEP="0"):
            rm2 = rec_module(pt, rnet, card, rec_params(rnet, KVSTORE["seed"] + 1), "device",
                             "sgd", sgd)
        kv2 = rm2._kvstore
        loaded_step, weights = kv2.load_sharded_checkpoint(dir_r)
        rows = {}
        for row in manifest["sparse"]:
            key = row["key"]
            st1, st2 = kv._updater.states[key], kv2._updater.states[key]
            same = (np.array_equal(kv._store[key].asnumpy(), kv2._store[key].asnumpy())
                    and np.array_equal(st1.indices, st2.indices)
                    and all(np.array_equal(a, b) for a, b in zip(st1.rows, st2.rows)))
            check(isinstance(st2, pt.sparse.RowSparseState) and same,
                  ("sparse table round trip", key))
            rows[rm._param_names[key]] = int(st2.nnz)
        counts = {k: v for k, v in kv._optimizer._index_update_count.items()}
        check(loaded_step == CKPT["rec_steps"]
              and kv2._optimizer._index_update_count == counts,
              ("update counts", kv2._optimizer._index_update_count, counts))
        log({"phase": "checkpoint", "part": "recommender_sparse", "batch": R,
             "contexts": len(card), "steps": CKPT["rec_steps"], "state_rows": rows,
             "bitwise": True, "save_s": save_s,
             "save_bytes": dir_bytes(ckpt.step_dir(dir_r, CKPT["rec_steps"])),
             "launches": launches["recommender"]})
        del rm, rm2, kv, kv2
    finally:
        shutil.rmtree(root, ignore_errors=True)
        telemetry.set_mode(saved_mode)
        torch.backends.cudnn.deterministic = deterministic
    check(not os.path.exists(root), "the checkpoint directory was removed")
    check_tf32_off()
    log({"phase": "checkpoint", "part": "done", "seconds": time.perf_counter() - t_phase})
    return launches


# Phase 17: the graph lint, the planner and the pipeline (``analysis/``,
# ``parallel/autoplan.py``, ``module.PipelineExecutorGroup``) and BatchNorm
# across processes (``fusion._conv_block_sharded``), at phase 9's ResNet-50:
# its four fixed batches of 32, two epochs, SGD with momentum.
PLANNER = dict(stages=2, microbatches=4, check_batch=4, check_microbatches=2, mlp_batch=64,
               mlp_cut="relu1", timed_steps=24, budget_s=60.0)


def nbytes_of(arrays):
    return sum(int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize for a in arrays
               if a is not None)


def step_peak(step):
    """(bytes allocated before ``step``, the peak while it ran): the caching
    allocator's counters around one call, synchronized."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return base, torch.cuda.max_memory_allocated()


def pipeline_group(pt, net, data_shape, ctx, B, mu, args, aux, dtype="float32", cuts=None):
    """``PipelineExecutorGroup`` over ``net`` (inputs ``data`` of
    ``data_shape`` a row, ``softmax_label``) at batch ``B`` in ``mu``
    microbatches on ``ctx``, in ``dtype``, from the given weights."""
    from mxnet_tpu_torch.module import PipelineExecutorGroup

    types = {n: dtype for n in net.list_arguments() + net.list_auxiliary_states()}
    types.update({"__pipe%d__" % i: dtype for i in range(PLANNER["stages"] - 1)})
    pg = PipelineExecutorGroup(net, ctx, [("data", (B,) + tuple(data_shape))],
                               [("softmax_label", (B,))], num_stages=PLANNER["stages"],
                               microbatches=mu, cut_entries=cuts, type_dict=types)
    pg.set_params({k: v.astype(dtype) for k, v in args.items()},
                  {k: v.astype(dtype) for k, v in aux.items()})
    return pg


def data_batch(pt, x, y, ctx):
    return pt.io.DataBatch(data=[pt.nd.array(x, ctx=ctx)], label=[pt.nd.array(y, ctx=ctx)])


def pipeline_loss(pg, labels):
    prob = pg.get_outputs()[0]._tensor()
    lab = torch.as_tensor(labels.reshape(-1, 1), device=prob.device).long()
    return float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean())


def pipeline_sites(pg, kind):
    """The planned sites of the stages' programs: conv+BN sites (``conv``)
    or a pattern's (by name)."""
    if kind == "conv":
        return sum(sum(1 for d in ex._prog.fusion_plan.values() if d["kind"] == "conv")
                   for ex in pg.execs)
    return sum(ex._prog.pattern_sites.get(kind, 0) for ex in pg.execs)


def pipeline_train_check(pt, net, args, aux, images, labels):
    """A pipelined step at batch ``check_batch`` (``check_microbatches``
    microbatches) from the same weights on the card and on the CPU, in
    float32 and float64, by phase 6's rule: each gradient within rtol 1e-3,
    atol 1e-3·max|grad| of the CPU's float32 one, or at most
    RESNET_F64_FACTOR times as far from the float64 one as the CPU's; the
    CPU pinned to the card's side at every ReLU kink (both phases of the
    schedule reach the ReLUs in the same order on either device)."""
    Bc, mu = PLANNER["check_batch"], PLANNER["check_microbatches"]

    def run(ctx, dtype, kinks):
        pg = pipeline_group(pt, net, image_shape(), ctx, Bc, mu, args, aux, dtype)
        b = data_batch(pt, images[:Bc].astype(dtype), labels[:Bc].astype(dtype), ctx)
        with kinks as flips:
            pg.forward_backward(b)
        grads = {n: g.asnumpy().astype(np.float64)
                 for n, g in zip(pg.param_names, pg.grad_arrays)}
        p_args, p_aux = {}, {}
        pg.get_params(p_args, p_aux)
        return (grads, {n: v.asnumpy().astype(np.float64) for n, v in p_aux.items()},
                pipeline_loss(pg, labels[:Bc])), flips

    card = []
    got, _ = run(pt.gpu(0), np.float32, relu_kinks(record=card))
    torch.cuda.synchronize()
    want, flips = run(pt.cpu(), np.float32, relu_kinks(compare=card, pin=True))
    exact, _ = run(pt.cpu(), np.float64, relu_kinks(compare=card, pin=True))
    names = list(got[0])
    strict = [n for n in names if np.allclose(got[0][n], want[0][n], rtol=1e-3,
                                              atol=1e-3 * float(np.abs(want[0][n]).max()))]
    card64 = {n: rel_diff(got[0][n], exact[0][n]) for n in names}
    cpu64 = {n: rel_diff(want[0][n], exact[0][n]) for n in names}
    gscale = max(float(np.abs(exact[0][n]).max()) for n in names)
    null = {n for n in names if float(np.abs(exact[0][n]).max()) <= 1e-6 * gscale}
    loose = [n for n in names if n not in strict and n not in null]
    bad = [n for n in loose if card64[n] > RESNET_F64_FACTOR * cpu64[n]]
    aux_rel = max(rel_diff(got[1][n], want[1][n]) for n in got[1])
    check(abs(got[2] - want[2]) <= 1e-3 * max(1.0, abs(want[2])),
          ("pipelined batch-4 loss card vs CPU", got[2], want[2]))
    check(all(np.isfinite(g).all() for g in got[0].values()), "non-finite pipelined gradient")
    check(not bad and aux_rel <= 1e-3, ("pipelined batch-4 grads card vs CPU", bad[:5], aux_rel))
    return {"batch": Bc, "microbatches": mu, "loss_card": got[2], "loss_cpu": want[2],
            "grads": len(names), "grads_within_1e-3_of_cpu": len(strict),
            "null_grads": len(null), "relu_kinks_pinned": sum(n for n, _ in flips),
            "worst_ratio": max([card64[n] / max(cpu64[n], 1e-30) for n in loose] or [0.0]),
            "moving_stats_worst": aux_rel, "f64_factor": RESNET_F64_FACTOR}


def run_planner(pt, smi):
    """Phase 17: the graph lint at bind, the planner on the fused step, the
    GPipe pipeline (ResNet-50 and the MNIST ``mlp``) and the sharded conv+BN
    statistics on one NCCL rank. Returns its launches by kernel."""
    import torch.distributed as tdist

    from mxnet_tpu_torch import analysis, fusion, models, ops, telemetry
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import conv_bn as cb
    from mxnet_tpu_torch.parallel import autoplan

    t_phase = time.perf_counter()
    check_tf32_off()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # conv0 and the stride-2 3x3s: the same bits
    saved_mode = telemetry.current_override()
    telemetry.set_mode("counters")
    net = resnet.get_symbol(**RESNET)
    args, aux = resnet_values(net)
    B, nb = RESNET_TRAIN["batch"], MODULE["batches"]
    steps = nb * MODULE["epochs"]
    images, labels = module_data(B * nb)
    shapes = {"data": (B,) + image_shape(), "softmax_label": (B,)}
    launches = {}

    # --- 1. the graph lint at bind: ResNet-50 at batch 32 for training
    telemetry.reset()
    with env_vars(MXNET_GRAPHLINT="error"):
        exe = resnet_bind(pt, net, pt.gpu(0), B, args, aux, {n: "write" for n in args},
                          images, labels)
    predicted = telemetry.gauge("memlint.predicted_peak_bytes").value
    report = analysis.lint(net, shapes=shapes, target="resnet-50")
    check(not report.errors and predicted == report.memory_plan["per_device"]["peak"],
          ("ResNet-50 lint at bind", report.codes(), predicted))
    base, peak = step_peak(exe.forward_backward)
    live = nbytes_of(exe.arg_arrays + exe.grad_arrays + exe.aux_arrays + exe.outputs)
    plan = report.memory_plan
    out = {"phase": "planner", "part": "lint", "nvidia_smi": smi, "batch": B,
           "codes": report.codes(), "predicted_peak_bytes": int(predicted),
           "predicted": plan["per_device"], "predicted_peak_node": plan["peak_node"],
           "predicted_peak_phase": plan["peak_phase"],
           "measured_peak_bytes": int(peak), "allocated_before_step_bytes": int(base),
           "measured_step_bytes": int(peak - base), "live_buffers_bytes": int(live),
           "predicted_over_measured_peak": predicted / peak}
    del exe
    # the reference's own bound (tests/test_graphlint.py): the MNIST mlp's
    # prediction within 2x of the buffers a bound step holds
    mlp = models.get_symbol("mlp", num_classes=10)
    mshapes = {"data": (32, 784), "softmax_label": (32,)}
    mpred = analysis.lint(mlp, shapes=mshapes).memory_plan["per_device"]["peak"]
    mexe = mlp.simple_bind(pt.gpu(0), **mshapes)
    mexe.forward_backward()
    mlive = nbytes_of(mexe.arg_arrays + mexe.grad_arrays + mexe.aux_arrays + mexe.outputs)
    check(mlive / 2 <= mpred <= 2 * mlive, ("mlp predicted vs live", mpred, mlive))
    out.update(mlp_predicted_bytes=int(mpred), mlp_live_buffers_bytes=int(mlive))
    del mexe
    log(out)

    # --- 2. the planner on the fused step: Module.fit under MXNET_AUTOPLAN=1
    opt_params = (("learning_rate", RESNET_TRAIN["lr"]), ("momentum", RESNET_TRAIN["momentum"]),
                  ("wd", RESNET_TRAIN["wd"]), ("rescale_grad", 1.0 / B))
    plan = autoplan.plan_parallel(net, shapes, devices=1)
    check(plan.feasible and plan.mesh == {"data": 1, "model": 1}
          and plan.pipeline_stages == 1, ("ResNet-50's one-card plan", plan.summary()))

    def fused_fit(planned):
        with pt.gpu(0):
            train = pt.io.NDArrayIter(images, labels, batch_size=B, shuffle=False)
        mod = pt.mod.Module(net, context=pt.gpu(0))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with env_vars(MXNET_MODULE_FUSED_STEP="1", MXNET_AUTOPLAN="1" if planned else None,
                      MXNET_GRAPHLINT="warn" if planned else None):
            mod.fit(train, eval_metric="acc", optimizer="sgd", optimizer_params=opt_params,
                    arg_params=args, aux_params=aux, num_epoch=MODULE["epochs"])
        torch.cuda.synchronize()
        got = ops.launch_counts()
        check(mod._spmd is not None, ("the fused step", planned))
        graph = one_graph(mod)
        per_replay = {k: v for k, v in graph.replay_launches[0].items() if v}
        check(per_replay == {"conv_bn": RESNET_SITES, "conv_bn_bwd": RESNET_SITES},
              ("a captured step's launches", planned, per_replay))
        check(got == with_zeros({"conv_bn": RESNET_SITES * steps,
                                 "conv_bn_bwd": RESNET_SITES * steps}),
              ("fused Module.fit launches", planned, got))
        return mod, got

    t0 = time.perf_counter()
    planned, fit_launches = fused_fit(True)
    planned_s = time.perf_counter() - t0
    check(dict(planned._spmd.trainer.mesh.shape) == plan.mesh, "the planned mesh")
    fit_gauge = telemetry.gauge("memlint.predicted_peak_bytes").value
    plain, _ = fused_fit(False)
    (pa, px), (qa, qx) = module_arrays(planned), module_arrays(plain)
    same = all(np.array_equal(pa[k], qa[k]) for k in qa) and \
        all(np.array_equal(px[k], qx[k]) for k in qx)
    check(same, "the planned fused fit is not bitwise the unplanned one")
    launches["autoplan_fit"] = {k: fit_launches[k] for k in ("conv_bn", "conv_bn_bwd")}
    log({"phase": "planner", "part": "autoplan_fit", "nvidia_smi": smi, "batch": B,
         "steps": steps, "plan": plan.summary(), "plan_mesh": plan.mesh,
         "fit_s": planned_s, "fit_launches": launches["autoplan_fit"],
         "spmd_lint_predicted_peak_bytes": fit_gauge,
         "bitwise_equal_to_unplanned_fused_fit": same})
    del planned, plain

    # --- 3. the pipeline: ResNet-50 at batch 32, two stages, four microbatches
    mu = PLANNER["microbatches"]
    pg = pipeline_group(pt, net, image_shape(), pt.gpu(0), B, mu, args, aux)
    sites = pipeline_sites(pg, "conv")
    check(sites == RESNET_SITES, ("the stages' conv+BN sites", sites))
    batches = [data_batch(pt, images[i * B:(i + 1) * B], labels[i * B:(i + 1) * B], pt.gpu(0))
               for i in range(nb)]
    updater = pt.optimizer.get_updater(pt.optimizer.create(
        "sgd", learning_rate=RESNET_TRAIN["lr"], momentum=RESNET_TRAIN["momentum"],
        wd=RESNET_TRAIN["wd"], rescale_grad=1.0 / B))

    def update():
        for i, (w, g) in enumerate(zip(pg.param_arrays, pg.grad_arrays)):
            updater(i, g, w)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    pg.forward(batches[0])
    torch.cuda.synchronize()
    fwd = ops.launch_counts()
    ops.reset_launch_counts()
    pg.backward()
    torch.cuda.synchronize()
    bwd = ops.launch_counts()
    update()
    check(fwd == with_zeros({"conv_bn": sites * mu}), ("pipeline forward phase", fwd))
    check(bwd == with_zeros({"conv_bn": sites * mu, "conv_bn_bwd": sites * mu}),
          ("pipeline backward phase (recompute)", bwd))
    losses = [pipeline_loss(pg, labels[:B])]
    ops.reset_launch_counts()
    for s in range(1, steps):
        b = s % nb
        pg.forward_backward(batches[b])
        update()
        losses.append(pipeline_loss(pg, labels[b * B:(b + 1) * B]))
    torch.cuda.synchronize()
    run_launches = ops.launch_counts()
    check(run_launches == with_zeros({"conv_bn": 2 * sites * mu * (steps - 1),
                                      "conv_bn_bwd": sites * mu * (steps - 1)}),
          ("pipelined steps' launches", run_launches))
    first, last = float(np.mean(losses[:nb])), float(np.mean(losses[-nb:]))
    check(all(math.isfinite(v) for v in losses) and last < first,
          ("the pipelined loss did not fall", losses))
    launches["pipeline"] = {k: fwd[k] + bwd[k] + run_launches[k]
                            for k in ("conv_bn", "conv_bn_bwd")}

    i = [0]

    def pipe_step():
        pg.forward_backward(batches[i[0] % nb])
        update()
        i[0] += 1

    host = timed_turns({"pipeline": pipe_step}, PLANNER["timed_steps"])["pipeline"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spans = []
    for _ in range(4):
        torch.cuda.synchronize()
        start.record()
        pipe_step()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    for _ in range(4):
        w = profile_window(pipe_step)
        if w["device_busy_ms"] > 0:
            break
        time.sleep(PROFILER_GAP_S)
    pipe_mem = step_peak(pipe_step)
    cut = pg.cut_entries
    del pg
    ref = resnet_bind(pt, net, pt.gpu(0), B, args, aux, {n: "write" for n in args},
                      images, labels)
    plain_mem = step_peak(ref.forward_backward)
    del ref
    check_out = pipeline_train_check(pt, net, args, aux, images, labels)
    log({"phase": "planner", "part": "pipeline", "nvidia_smi": smi, "model": RESNET,
         "batch": B, "stages": PLANNER["stages"], "microbatches": mu, "cut": cut,
         "sites": sites, "forward_phase_launches": {k: v for k, v in fwd.items() if v},
         "backward_phase_launches": {k: v for k, v in bwd.items() if v},
         "steps": steps, "loss_first_epoch": first, "loss_last_epoch": last,
         "step_ms": host, "step_ms_samples": len(host["all"]), "card_event_span_ms": spans,
         "window": {k: w[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                      "port_kernels_ms", "port_kernel_launches",
                                      "device_events_per_call")},
         "peak_bytes": {"pipeline": pipe_mem[1], "per_device_step": plain_mem[1]},
         "step_bytes": {"pipeline": pipe_mem[1] - pipe_mem[0],
                        "per_device_step": plain_mem[1] - plain_mem[0]},
         "card_vs_cpu": check_out})

    # --- 4. the mlp pipeline against its full-batch step on the card
    Bm = PLANNER["mlp_batch"]
    rs = np.random.RandomState(SEED + 60)
    mshapes, _, _ = mlp.infer_shape(data=(Bm, 784))
    margs = {n: (rs.randn(*s) * 0.05).astype(np.float32)
             for n, s in zip(mlp.list_arguments(), mshapes) if n not in ("data", "softmax_label")}
    mx_ = rs.rand(Bm, 784).astype(np.float32)
    my = rs.randint(0, 10, Bm).astype(np.float32)
    full = resnet_bind(pt, mlp, pt.gpu(0), Bm, margs, {}, {n: "write" for n in margs},
                       mx_, my)
    full.forward_backward()
    want = {n: full.grad_dict[n].asnumpy() for n in margs}
    want_out = full.outputs[0].asnumpy()
    del full
    mpg = pipeline_group(pt, mlp, (784,), pt.gpu(0), Bm, mu, margs, {},
                         cuts=[PLANNER["mlp_cut"]])
    msites = pipeline_sites(mpg, "matmul_bias_act")
    check(msites == MNIST_SITES["mlp"], ("the mlp stages' matmul_bias_act sites", msites))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    mpg.forward_backward(data_batch(pt, mx_, my, pt.gpu(0)))
    torch.cuda.synchronize()
    mlaunch = ops.launch_counts()
    check(mlaunch == with_zeros({"matmul_bias_act": 2 * msites * mu}),
          ("the mlp pipeline's launches", mlaunch))
    gerr = max(float(np.abs(mpg._owner(n).grad_dict[n].asnumpy() - want[n]).max())
               for n in margs)
    oerr = float(np.abs(mpg.get_outputs()[0].asnumpy() - want_out).max())
    check(gerr <= 1e-5 and oerr <= 1e-5, ("mlp pipeline vs full batch", gerr, oerr))
    launches["mlp_pipeline"] = {"matmul_bias_act": mlaunch["matmul_bias_act"]}
    del mpg
    log({"phase": "planner", "part": "mlp_pipeline", "batch": Bm, "microbatches": mu,
         "cut": PLANNER["mlp_cut"], "sites": msites, "launches": launches["mlp_pipeline"],
         "max_abs_grad_err": gerr, "max_abs_out_err": oerr, "atol": 1e-5})

    # --- 5. the sharded statistics on one NCCL rank, bitwise the kernel's
    env = {"MXNET_TPU_COORDINATOR": "127.0.0.1:%d" % free_port(),
           "MXNET_TPU_NUM_WORKERS": "1", "MXNET_TPU_WORKER_ID": "0"}
    dev = pt.gpu(0).torch_device
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x, w = randn(B, 64, 56, 56), randn(64, 64, 3, 3) * 0.05
    scale, shift = randn(64).abs() + 0.5, randn(64) * 0.1
    cots = [randn(B, 64, 56, 56), randn(64), randn(64)]
    try:
        with env_vars(**env):
            pt.dist.init()
        check(pt.dist.is_initialized() and pt.dist.backend() == "nccl", "one NCCL rank")
        mesh = pt.parallel.mesh.Mesh(np.array([pt.gpu(0)], dtype=object), ("data",), 1,
                                     tdist.group.WORLD)
        results = []
        for sharded in (True, False):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            if sharded:
                outs = fusion._conv_block_sharded(mesh, *leaves, None, (1, 1), True)
            else:
                outs = cb.ConvBlock.apply(*leaves, None, (1, 1), True)
            grads = torch.autograd.grad(outs, leaves, grad_outputs=cots)
            torch.cuda.synchronize()
            results.append(([o.detach() for o in outs], grads, ops.launch_counts()))
    finally:
        pt.dist.shutdown()
    check(not pt.dist.is_initialized(), "process group destroyed")
    (so, sg, sl), (po, pg_, pl) = results
    bitwise = all(torch.equal(a, b) for a, b in zip(so + list(sg), po + list(pg_)))
    check(bitwise, "the sharded statistics are not bitwise the kernel's")
    check(sl == pl == with_zeros({"conv_bn": 1, "conv_bn_bwd": 1}), ("sharded launches", sl))
    launches["sharded_stats"] = {"conv_bn": sl["conv_bn"], "conv_bn_bwd": sl["conv_bn_bwd"]}
    torch.backends.cudnn.deterministic = deterministic
    telemetry.set_mode(saved_mode)
    check_tf32_off()
    seconds = time.perf_counter() - t_phase
    log({"phase": "planner", "part": "sharded_stats", "backend": "nccl", "world": 1,
         "x": list(x.shape), "w": list(w.shape), "bitwise_equal_to_conv_block": bitwise,
         "launches": launches["sharded_stats"], "phase_seconds": seconds,
         "budget_s": PLANNER["budget_s"]})
    return launches


# Phase 18, the native runtime: ResNet-50 trained the way
# example/image-classification/train_imagenet.py trains it. A RecordIO pack
# of 256 images of 256 x 256 x 3 (a colour a class from a seeded table of
# 1000, plus uniform noise of +-40, JPEG quality 95) read by ImageRecordIter
# at (3, 224, 224), batch 32, shuffled, random crops and mirrors, the
# ImageNet means, 4 decode threads (common/data.py's arguments), into
# Module.fit on the fused step, SGD-momentum at RESNET_TRAIN's settings, 2
# epochs of 8 steps, do_checkpoint each epoch under ThreadedEngine; then one
# more epoch continued and resumed. LeNet through the C training ABI at
# batch 32 for 20 steps, ResNet-50 through the C predict ABI at batch 1.
NATIVE = dict(images=256, image_size=256, classes=1000, noise=40, batch=32, epochs=2,
              threads=4, mean=(123.68, 116.779, 103.939), quality=95, c_train_steps=20,
              c_train_batch=32, profile_steps=4, latency_saves=3, dev_type=2, budget_s=90.0)
# tests/test_image_native.py:93-94: the native and Python decoders' JPEG
# rounding on one unaugmented batch
NATIVE_DECODE_TOL = dict(mean=0.02, max=0.2)
NATIVE_PREDICT_TOL = dict(rtol=1e-5, atol=1e-6)

# LeNet trained through include/mxtpu/c_api.h (tests/test_c_api.py's
# program as a function): the executor binds on the default context, every
# array the program makes is on dev_type; the KVStore round trip and an
# imperative add run there too. Returns 0, or the failing step's code.
C_NATIVE_TRAIN = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "mxtpu/c_api.h"

static unsigned long rng_state = 12345;
static float frand(void) {
  rng_state ^= rng_state << 13; rng_state ^= rng_state >> 7; rng_state ^= rng_state << 17;
  return (float)((double)(rng_state % 100000) / 100000.0 - 0.5);
}

static int fill(NDArrayHandle h, float scale) {
  mx_uint ndim; const mx_uint* shp;
  if (MXNDArrayGetShape(h, &ndim, &shp)) return -1;
  size_t n = 1; for (mx_uint i = 0; i < ndim; ++i) n *= shp[i];
  float* buf = (float*)malloc(n * sizeof(float));
  for (size_t i = 0; i < n; ++i) buf[i] = frand() * scale;
  int rc = MXNDArraySyncCopyFromCPU(h, buf, n);
  free(buf);
  return rc;
}

#define CHECK(x, code) do { if (x) { \
  fprintf(stderr, "%s failed: %s\n", #x, MXGetLastError()); return code; } } while (0)

int train_lenet(const char* json, int dev_type, int batch, int steps, float* losses) {
  enum { NCLS = 10 };
  const char* keys[] = {"data", "softmax_label"};
  mx_uint indptr[] = {0, 4, 5};
  mx_uint shapes[] = {(mx_uint)batch, 1, 28, 28, (mx_uint)batch};
  ExecutorHandle ex = NULL;
  CHECK(MXTrainExecutorCreate(json, 2, keys, indptr, shapes, &ex), 1);
  mx_uint n_args; const char** names;
  CHECK(MXExecutorListArguments(ex, &n_args, &names), 2);
  float* label = (float*)malloc(batch * sizeof(float));
  float* prob = (float*)malloc(batch * NCLS * sizeof(float));
  for (int i = 0; i < batch; ++i) label[i] = (float)(i % NCLS);
  for (mx_uint i = 0; i < n_args; ++i) {
    NDArrayHandle a;
    CHECK(MXExecutorGetArg(ex, names[i], &a), 3);
    if (!strcmp(names[i], "softmax_label")) CHECK(MXNDArraySyncCopyFromCPU(a, label, batch), 4);
    else CHECK(fill(a, strcmp(names[i], "data") ? 0.2f : 1.0f), 4);
    MXNDArrayFree(a);
  }
  const char* okeys[] = {"lr"};
  const char* ovals[] = {"0.01"};
  for (int step = 0; step < steps; ++step) {
    CHECK(MXExecutorForward(ex, 1), 5);
    NDArrayHandle out;
    CHECK(MXExecutorGetOutput(ex, 0, &out), 6);
    CHECK(MXNDArraySyncCopyToCPU(out, prob, batch * NCLS), 7);
    MXNDArrayFree(out);
    float loss = 0.0f;
    for (int i = 0; i < batch; ++i) loss += -logf(prob[i * NCLS + (int)label[i]] + 1e-9f);
    losses[step] = loss / batch;
    CHECK(MXExecutorBackward(ex, 0, NULL), 8);
    for (mx_uint i = 0; i < n_args; ++i) {
      NDArrayHandle w, g;
      CHECK(MXExecutorGetArg(ex, names[i], &w), 9);
      CHECK(MXExecutorGetGrad(ex, names[i], &g), 9);
      if (g) {
        NDArrayHandle ins[2] = {w, g};
        NDArrayHandle* outs = &w;
        int n_out = 1;
        CHECK(MXImperativeInvokeByName("sgd_update", 2, ins, &n_out, &outs, 1, okeys, ovals), 10);
        MXNDArrayFree(g);
      }
      MXNDArrayFree(w);
    }
  }
  CHECK(MXNDArrayWaitAll(), 11);
  /* arrays of the program's own on dev_type: an add and a KVStore round trip */
  KVStoreHandle kv;
  CHECK(MXKVStoreCreate("local", &kv), 12);
  mx_uint vshape[] = {4};
  NDArrayHandle v0, delta, got;
  CHECK(MXNDArrayCreate(vshape, 1, dev_type, 0, 0, &v0), 13);
  CHECK(MXNDArrayCreate(vshape, 1, dev_type, 0, 0, &delta), 13);
  CHECK(MXNDArrayCreate(vshape, 1, dev_type, 0, 0, &got), 13);
  float dbuf[4] = {1.0f, 2.0f, 3.0f, 4.0f}, gbuf[4];
  CHECK(MXNDArraySyncCopyFromCPU(delta, dbuf, 4), 14);
  NDArrayHandle pair[2] = {delta, delta};
  NDArrayHandle* sum = NULL;
  int n_sum = 0;
  CHECK(MXImperativeInvokeByName("elemwise_add", 2, pair, &n_sum, &sum, 0, NULL, NULL), 15);
  CHECK(n_sum != 1 || MXNDArraySyncCopyToCPU(sum[0], gbuf, 4), 15);
  for (int i = 0; i < 4; ++i) if (gbuf[i] != 2.0f * dbuf[i]) return 16;
  MXNDArrayFree(sum[0]);
  int kv_keys[] = {3};
  CHECK(MXKVStoreInit(kv, 1, kv_keys, &v0), 17);
  CHECK(MXKVStorePush(kv, 1, kv_keys, &delta, 0), 17);
  CHECK(MXKVStorePull(kv, 1, kv_keys, &got, 0), 17);
  CHECK(MXNDArraySyncCopyToCPU(got, gbuf, 4), 18);
  for (int i = 0; i < 4; ++i) if (fabsf(gbuf[i] - dbuf[i]) > 1e-6f) return 19;
  MXNDArrayFree(v0); MXNDArrayFree(delta); MXNDArrayFree(got);
  MXKVStoreFree(kv);
  MXExecutorFree(ex);
  free(label); free(prob);
  return 0;
}
"""

# ResNet-50 served through include/mxtpu/c_predict_api.h: create at
# dev_type, one forward, the output copied out. Built as a library (the
# smoke calls predict_once in its own process) and, with WITH_MAIN, as a
# program that reads its inputs from files (an embedded interpreter).
C_NATIVE_PREDICT = r"""
#include <stdio.h>
#include <stdlib.h>
#include "mxtpu/c_predict_api.h"

int predict_once(const char* json, const void* params, int param_size, int dev_type,
                 const mx_uint* shape, const float* input, mx_uint n_in, float* out,
                 mx_uint n_out) {
  const char* keys[] = {"data"};
  mx_uint indptr[] = {0, 4};
  PredictorHandle h = NULL;
  if (MXPredCreate(json, params, param_size, dev_type, 0, 1, keys, indptr, shape, &h)) {
    fprintf(stderr, "create: %s\n", MXGetLastError()); return 1;
  }
  if (MXPredSetInput(h, "data", input, n_in)) {
    fprintf(stderr, "set: %s\n", MXGetLastError()); return 2;
  }
  if (MXPredForward(h)) { fprintf(stderr, "forward: %s\n", MXGetLastError()); return 3; }
  mx_uint* oshape; mx_uint ondim;
  if (MXPredGetOutputShape(h, 0, &oshape, &ondim)) return 4;
  mx_uint total = 1;
  for (mx_uint i = 0; i < ondim; ++i) total *= oshape[i];
  if (total != n_out || MXPredGetOutput(h, 0, out, n_out)) {
    fprintf(stderr, "get: %s\n", MXGetLastError()); return 5;
  }
  return MXPredFree(h) ? 6 : 0;
}

#ifdef WITH_MAIN
static void* slurp(const char* path, long* size) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END); *size = ftell(f); fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(*size + 1);
  if (fread(buf, 1, *size, f) != (size_t)*size) return NULL;
  buf[*size] = 0;
  fclose(f);
  return buf;
}

/* argv: symbol.json params input.bin out.bin n_out dev_type side */
int main(int argc, char** argv) {
  long js, ps, is;
  char* json = (char*)slurp(argv[1], &js);
  void* params = slurp(argv[2], &ps);
  float* input = (float*)slurp(argv[3], &is);
  if (!json || !params || !input) return 10;
  mx_uint n_out = (mx_uint)atoi(argv[5]);
  float* out = (float*)malloc(n_out * sizeof(float));
  mx_uint side = (mx_uint)atoi(argv[7]);
  mx_uint shape[] = {1, 3, side, side};
  int rc = predict_once(json, params, (int)ps, atoi(argv[6]), shape, input,
                        (mx_uint)(is / sizeof(float)), out, n_out);
  if (rc) return rc;
  FILE* f = fopen(argv[4], "wb");
  fwrite(out, sizeof(float), n_out, f);
  fclose(f);
  return 0;
}
#endif
"""


def native_images(n, seed):
    """``n`` images of NATIVE's size (HWC uint8, BGR as cv2 writes them) and
    their labels: a colour a class plus uniform noise."""
    rs = np.random.RandomState(seed)
    colours = rs.randint(40, 216, (NATIVE["classes"], 1, 1, 3))
    labels = rs.randint(0, NATIVE["classes"], n)
    S = NATIVE["image_size"]
    for i in range(n):
        noise = rs.randint(-NATIVE["noise"], NATIVE["noise"] + 1, (S, S, 3))
        yield np.clip(colours[labels[i]] + noise, 0, 255).astype(np.uint8), int(labels[i])


def build_native_libraries():
    """Every host library from the checkout into build/torch_native: path and
    seconds each. The engine, io and the two C ABIs must build; the image
    pipeline builds where libjpeg's and libpng's headers are (its missing
    prerequisites are returned)."""
    from mxnet_tpu_torch import _native_build as nb

    built, missing = {}, nb.missing_prerequisites("image")
    for name in nb.LIBS:
        if name == "image" and missing:
            continue
        t0 = time.perf_counter()
        path = nb.build(name, raise_errors=True)
        built[name] = {"path": os.path.relpath(path), "seconds": time.perf_counter() - t0}
    return built, missing


def compile_c(src_text, workdir, name, lib, shared):
    """gcc the phase's own C source against include/mxtpu and ``lib``."""
    src = os.path.join(workdir, name + ".c")
    with open(src, "w") as f:
        f.write(src_text)
    out = os.path.join(workdir, ("lib%s.so" % name) if shared else name)
    flags = ["-shared", "-fPIC"] if shared else ["-DWITH_MAIN"]
    subprocess.run(["gcc", *flags, src, "-I", "include", "-o", out, lib,
                    "-Wl,-rpath," + os.path.dirname(os.path.abspath(lib)), "-lm"],
                   check=True, capture_output=True, text=True)
    return out


def run_native(pt, smi):
    """Phase 18: the native runtime. Returns its launches by kernel (the
    .rec-fed ResNet-50 fits, the C training ABI's LeNet, the predict ABI's
    ResNet-50)."""
    import ctypes

    from mxnet_tpu_torch import (c_api, engine, image, io_native, models, ops, predict_api,
                                 recordio, telemetry)
    from mxnet_tpu_torch.models import resnet

    t_phase = time.perf_counter()
    check_tf32_off()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # conv0 and the stride-2 3x3s: the same bits
    saved_mode = telemetry.current_override()
    telemetry.set_mode("counters")
    root = tempfile.mkdtemp(prefix="mxnet-native-")
    launches = {}
    try:
        # --- 1. the host libraries, and what the image path can use
        t0 = time.perf_counter()
        built, missing = build_native_libraries()
        codecs = {}
        for mod in ("cv2", "PIL"):
            try:
                codecs[mod] = __import__(mod).__version__
            except ImportError:
                pass
        log({"phase": "native", "part": "build", "libraries": built,
             "image_pipeline_missing": missing, "codecs": codecs,
             "seconds": time.perf_counter() - t0})
        if missing:
            log({"phase": "native", "part": "prerequisites",
                 "missing": "the native image pipeline (src/image_native.cc) needs %s, which "
                            "this host lacks; ImageRecordIter decodes through %s"
                            % (" and ".join(missing), ", ".join(codecs) or "nothing")})
        check(codecs, "no cv2 and no PIL: nothing can write or read the JPEG records")

        # raw records through MXIndexedRecordIO and NativePrefetchReader
        rs = np.random.RandomState(SEED + 80)
        raw = [rs.bytes(int(rs.randint(1, 4096))) for _ in range(64)]
        raw_rec = recordio.MXIndexedRecordIO(os.path.join(root, "raw.idx"),
                                             os.path.join(root, "raw.rec"), "w")
        for i, payload in enumerate(raw):
            raw_rec.write_idx(i, recordio.pack((0, np.float32(i), i, 0), payload))
        raw_rec.close()
        got = [recordio.unpack(r)[1] for r in
               io_native.NativePrefetchReader(os.path.join(root, "raw.rec"), 8)]
        check(got == raw, "NativePrefetchReader did not return the raw records")

        # --- 2. the .rec pack and the iterator
        t0 = time.perf_counter()
        rec_path, idx_path = os.path.join(root, "train.rec"), os.path.join(root, "train.idx")
        rec = recordio.MXIndexedRecordIO(idx_path, rec_path, "w")
        for i, (img, label) in enumerate(native_images(NATIVE["images"], SEED + 81)):
            rec.write_idx(i, recordio.pack_img((0, float(label), i, 0), img,
                                               quality=NATIVE["quality"]))
        rec.close()
        pack_s = time.perf_counter() - t0
        B, epochs = NATIVE["batch"], NATIVE["epochs"]
        steps_per_epoch = NATIVE["images"] // B
        mr, mg, mb = NATIVE["mean"]
        iter_args = dict(data_shape=image_shape(), batch_size=B, shuffle=True, rand_crop=True,
                         rand_mirror=True, mean_r=mr, mean_g=mg, mean_b=mb,
                         preprocess_threads=NATIVE["threads"], path_imgidx=idx_path)
        with pt.gpu(0):
            train = image.ImageRecordIter(rec_path, **iter_args)
        check(train.native == (not missing),
              ("the iterator's path", "native" if train.native else "python", missing))
        path = "native" if train.native else "python"

        # one unaugmented batch, native against the Python path
        if train.native:
            plain = dict(data_shape=image_shape(), batch_size=B, mean_r=mr, mean_g=mg,
                         mean_b=mb, preprocess_threads=NATIVE["threads"],
                         path_imgidx=idx_path)
            with pt.gpu(0):
                a = image.ImageRecordIter(rec_path, **plain).next().data[0].asnumpy()
                with env_vars(MXNET_NATIVE_IMAGE_PIPELINE="0"):
                    b = image.ImageRecordIter(rec_path, **plain).next().data[0].asnumpy()
            diff = np.abs(a - b)
            decode = {"mean_abs": float(diff.mean()), "max_abs": float(diff.max()),
                      **NATIVE_DECODE_TOL}
            check(decode["mean_abs"] < NATIVE_DECODE_TOL["mean"]
                  and decode["max_abs"] < NATIVE_DECODE_TOL["max"],
                  ("native vs Python decode", decode))
        else:
            decode = "not run: the native pipeline is not built on this host"

        # --- 3. ResNet-50 through Module.fit from the iterator, epoch
        # checkpoints through the engine
        net = resnet.get_symbol(**RESNET)
        args, aux = resnet_values(net)
        opt_params = (("learning_rate", RESNET_TRAIN["lr"]),
                      ("momentum", RESNET_TRAIN["momentum"]),
                      ("wd", RESNET_TRAIN["wd"]), ("rescale_grad", 1.0 / B))
        prefix = os.path.join(root, "resnet")
        engine.set_engine_type("ThreadedEngine")
        check(engine.get().native, "the ThreadedEngine is not the native one")
        losses, stamps = [], []

        def at_batch_end(param):
            prob = param.locals["self"].get_outputs()[0]._tensor()
            lab = param.locals["data_batch"].label[0]._tensor().long().reshape(-1, 1)
            losses.append(float(-torch.log(prob.gather(1, lab).clamp_min(1e-30)).mean()))
            stamps.append(time.perf_counter())

        def save_states(epoch, *_):
            mod_a.save_optimizer_states("%s-%04d.states" % (prefix, epoch + 1))

        mod_a = pt.mod.Module(net, context=pt.gpu(0))
        telemetry.reset()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with env_vars(MXNET_MODULE_FUSED_STEP="1"):
            mod_a.fit(train, eval_metric="acc", optimizer="sgd", optimizer_params=opt_params,
                      arg_params=args, aux_params=aux, num_epoch=epochs,
                      batch_end_callback=at_batch_end,
                      epoch_end_callback=[pt.callback.do_checkpoint(prefix), save_states])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = ops.launch_counts()
        input_bound = telemetry.gauge("io.input_bound_pct").value
        steps = steps_per_epoch * epochs
        check(mod_a._spmd is not None, "Module.fit: the fused step is not active")
        check(fit_launches == with_zeros({"conv_bn": RESNET_SITES * steps,
                                          "conv_bn_bwd": RESNET_SITES * steps}),
              ("the .rec-fed fit's launch counts", fit_launches))
        first = float(np.mean(losses[:steps_per_epoch]))
        last = float(np.mean(losses[-steps_per_epoch:]))
        check(len(losses) == steps and all(math.isfinite(v) for v in losses) and last < first,
              ("the .rec-fed fit's loss did not fall", losses))
        launches["resnet_fit"] = {k: fit_launches[k] for k in ("conv_bn", "conv_bn_bwd")}
        # the second epoch (the step captured): host time between batch ends,
        # the first of them across the epoch boundary (its checkpoint, the
        # optimizer states, the iterator's reset)
        gaps = np.diff(stamps[steps_per_epoch - 1:]) * 1e3
        epoch2_s = stamps[-1] - stamps[steps_per_epoch - 1]

        # the engine-queued checkpoint: drained by waitall, bitwise the module
        pt.nd.waitall()
        check(pt.model.find_last_checkpoint(prefix) == epochs, "epoch checkpoints missing")
        _, ck_args, ck_aux = pt.model.load_checkpoint(prefix, epochs, ctx=pt.cpu())
        (fa, fx) = module_arrays(mod_a)
        check(sorted(ck_args) == sorted(fa) and sorted(ck_aux) == sorted(fx)
              and all(np.array_equal(ck_args[k].asnumpy(), fa[k]) for k in fa)
              and all(np.array_equal(ck_aux[k].asnumpy(), fx[k]) for k in fx),
              "load_checkpoint(prefix, 2) is not get_params() bitwise")

        # --- 4. one more epoch: continued, and resumed from the checkpoint
        cont_x, cont_y = [], []
        train.reset()
        for batch in train:
            cont_x.append(batch.data[0].asnumpy())
            cont_y.append(batch.label[0].asnumpy())
        with pt.gpu(0):
            cont = pt.io.NDArrayIter(np.concatenate(cont_x), np.concatenate(cont_y),
                                     batch_size=B, shuffle=False)

        def one_more(mod):
            cont.reset()
            ops.reset_launch_counts()
            with env_vars(MXNET_MODULE_FUSED_STEP="1"):
                mod.fit(cont, eval_metric="acc", optimizer="sgd", optimizer_params=opt_params,
                        begin_epoch=epochs, num_epoch=epochs + 1)
            torch.cuda.synchronize()
            got = ops.launch_counts()
            check(got == with_zeros({"conv_bn": RESNET_SITES * steps_per_epoch,
                                     "conv_bn_bwd": RESNET_SITES * steps_per_epoch}),
                  ("one more epoch's launch counts", got))
            return {k: got[k] for k in ("conv_bn", "conv_bn_bwd")}

        launches["resnet_continue"] = one_more(mod_a)
        begin, r_args, r_aux = pt.model.resume_or_init(prefix, ctx=pt.cpu())
        check(begin == epochs, ("resume_or_init's epoch", begin))
        mod_b = pt.mod.Module(net, context=pt.gpu(0))
        mod_b.bind(data_shapes=cont.provide_data, label_shapes=cont.provide_label)
        mod_b.init_params(arg_params=r_args, aux_params=r_aux)
        with env_vars(MXNET_MODULE_FUSED_STEP="1"):
            mod_b.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
        mod_b.load_optimizer_states("%s-%04d.states" % (prefix, begin))
        launches["resnet_resume"] = one_more(mod_b)
        (ra, rx), (ca, cx) = module_arrays(mod_b), module_arrays(mod_a)
        name, rel, absd = worst_rel({**ra, **rx}, {**ca, **cx})
        bitwise = all(np.array_equal(ra[k], ca[k]) for k in ca) and \
            all(np.array_equal(rx[k], cx[k]) for k in cx)
        check(bitwise, ("resumed vs continued", name, rel, absd))

        # the card's idle share: steps fed by the iterator, and by one fixed
        # batch (phase 15's kind of window), on the trained module
        train.reset()
        fixed = next(iter(cont))

        def fed(k=NATIVE["profile_steps"]):
            for _ in range(k):
                try:
                    batch = train.next()
                except StopIteration:
                    train.reset()
                    batch = train.next()
                mod_a.forward_backward(batch)
                mod_a.update()

        def synthetic(k=NATIVE["profile_steps"]):
            for _ in range(k):
                mod_a.forward_backward(fixed)
                mod_a.update()

        windows = {}
        for kind, fn in (("iterator", fed), ("fixed_batch", synthetic)):
            prof = profile_window(fn, per=NATIVE["profile_steps"])
            windows[kind] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                  "device_idle_share", "port_kernels_ms")}

        # save_checkpoint's return against its write landing
        latency = []
        for i in range(NATIVE["latency_saves"]):
            t0 = time.perf_counter()
            pt.model.save_checkpoint(prefix + "-latency", i + 1, None, *mod_a.get_params())
            returned = time.perf_counter()
            pt.model.find_last_checkpoint(prefix + "-latency")
            latency.append({"return_ms": (returned - t0) * 1e3,
                            "landed_ms": (time.perf_counter() - t0) * 1e3})
        out = {"phase": "native", "part": "resnet_rec_fit", "nvidia_smi": smi, "path": path,
               "images": NATIVE["images"], "batch": B, "epochs": epochs, "steps": steps,
               "pack_s": pack_s, "rec_bytes": os.path.getsize(rec_path), "fit_s": fit_s,
               "fit_launches": {k: v for k, v in fit_launches.items() if v},
               "loss_first_epoch": first, "loss_last_epoch": last,
               "images_per_s_epoch2": B * steps_per_epoch / epoch2_s,
               "images_per_s_within_epoch": 1e3 * B / float(np.median(gaps[1:])),
               "host_step_ms": {"p50": float(np.percentile(gaps[1:], 50)),
                                "p80": float(np.percentile(gaps[1:], 80)),
                                "epoch_boundary": float(gaps[0]), "all": gaps.tolist()},
               "input_bound_pct": input_bound, "profiler_windows": windows,
               "decode_native_vs_python": decode, "checkpoint_bitwise": True,
               "resumed_vs_continued": {"bitwise": bitwise, "worst_array": name,
                                        "max_rel": rel, "max_abs": absd},
               "save_checkpoint_latency": latency,
               "engine": type(engine.get()).__name__}
        log(out)
        del mod_b, cont, train

        # --- 5. the C training ABI: LeNet at dev_type=2
        work = os.path.join(root, "c")
        os.makedirs(work)
        with open(os.path.join(work, "lenet-symbol.json"), "w") as f:
            f.write(models.lenet.get_symbol(num_classes=10).tojson())
        dev_type = NATIVE["dev_type"]
        c_lib = c_api.build()
        train_so = ctypes.CDLL(compile_c(C_NATIVE_TRAIN, work, "native_train", c_lib, True))
        train_so.train_lenet.restype = ctypes.c_int
        train_so.train_lenet.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        n_steps = NATIVE["c_train_steps"]
        c_losses = (ctypes.c_float * n_steps)()
        with open(os.path.join(work, "lenet-symbol.json"), "rb") as f:
            lenet_json = f.read()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = train_so.train_lenet(lenet_json, dev_type, NATIVE["c_train_batch"], n_steps,
                                  c_losses)
        torch.cuda.synchronize()
        c_train_s = time.perf_counter() - t0
        c_launches = ops.launch_counts()
        c_losses = [float(v) for v in c_losses]
        check(rc == 0, ("the C training program failed", rc))
        check(all(math.isfinite(v) for v in c_losses) and c_losses[-1] < c_losses[0],
              ("the C training ABI's loss did not fall", c_losses))
        check(c_launches == with_zeros({"matmul_bias_act": MNIST_SITES["lenet"] * n_steps}),
              ("the C training ABI's launch counts", c_launches))
        launches["c_train_abi"] = {"matmul_bias_act": c_launches["matmul_bias_act"]}

        # --- 6. the C predict ABI: ResNet-50 from the fit's .params at batch 1
        p_lib = predict_api.build()
        pred_so = ctypes.CDLL(compile_c(C_NATIVE_PREDICT, work, "native_predict", p_lib, True))
        pred_so.predict_once.restype = ctypes.c_int
        P = ctypes.POINTER
        pred_so.predict_once.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, P(ctypes.c_uint32), P(ctypes.c_float),
                                         ctypes.c_uint32, P(ctypes.c_float), ctypes.c_uint32]
        with open("%s-symbol.json" % prefix, "rb") as f:
            sym_json = f.read()
        params_path = "%s-%04d.params" % (prefix, epochs)
        with open(params_path, "rb") as f:
            params = f.read()
        side = image_shape()[1]
        o = (NATIVE["image_size"] - side) // 2
        x = next(native_images(1, SEED + 82))[0][o:o + side, o:o + side, ::-1].transpose(2, 0, 1)
        x = ((x - np.array(NATIVE["mean"], np.float32).reshape(3, 1, 1))[None]
             .astype(np.float32).copy())
        n_out = NATIVE["classes"]
        got = np.zeros(n_out, np.float32)
        shape = (ctypes.c_uint32 * 4)(*x.shape)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rc = pred_so.predict_once(sym_json, params, len(params), dev_type, shape,
                                  x.ctypes.data_as(P(ctypes.c_float)), x.size,
                                  got.ctypes.data_as(P(ctypes.c_float)), n_out)
        torch.cuda.synchronize()
        p_launches = ops.launch_counts()
        check(rc == 0, ("the C predict program failed", rc))
        # MXPredCreate binds and warms the executable with one forward
        # (serving/cache.py), MXPredForward runs the second
        check(p_launches == with_zeros({"conv_bn_infer": 2 * RESNET_SITES}),
              ("the predict ABI's launch counts", p_launches))
        launches["predict_abi"] = {"conv_bn_infer": p_launches["conv_bn_infer"]}
        pred = pt.predictor.Predictor(sym_json.decode(), params, {"data": x.shape})
        pred.forward(data=x)
        want = pred.get_output(0).reshape(-1)
        check(np.allclose(got, want, **NATIVE_PREDICT_TOL),
              ("predict ABI vs Predictor", float(np.abs(got - want).max())))
        # the same program as an executable: an embedded interpreter on the card
        exe = compile_c(C_NATIVE_PREDICT, work, "native_predict_main", p_lib, False)
        x.tofile(os.path.join(work, "input.bin"))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.abspath(".")] + [p for p in sys.path if p]))
        env.pop("MXNET_DEFAULT_CONTEXT", None)
        t0 = time.perf_counter()
        r = subprocess.run([exe, "%s-symbol.json" % prefix, params_path,
                            os.path.join(work, "input.bin"), os.path.join(work, "out.bin"),
                            str(n_out), str(dev_type), str(side)], capture_output=True,
                           text=True, env=env,
                           timeout=300)
        embedded_s = time.perf_counter() - t0
        check(r.returncode == 0, ("the embedded predict program", r.returncode,
                                  r.stderr[-800:]))
        embedded = np.fromfile(os.path.join(work, "out.bin"), np.float32)
        check(np.allclose(embedded, want, **NATIVE_PREDICT_TOL),
              ("embedded predict vs Predictor", float(np.abs(embedded - want).max())))
        log({"phase": "native", "part": "c_abis", "nvidia_smi": smi,
             "c_train": {"dev_type": dev_type, "batch": NATIVE["c_train_batch"],
                         "steps": n_steps,
                         "loss_first": c_losses[0], "loss_last": c_losses[-1],
                         "seconds": c_train_s,
                         "launches": {k: v for k, v in c_launches.items() if v},
                         "counted": "in the smoke's process (ctypes)"},
             "predict": {"dev_type": dev_type, "batch": 1,
                         "max_abs_vs_predictor": float(np.abs(got - want).max()),
                         "launches": {k: v for k, v in p_launches.items() if v},
                         "counted": "in the smoke's process (ctypes)",
                         "embedded_process": {"max_abs_vs_predictor":
                                              float(np.abs(embedded - want).max()),
                                              "seconds": embedded_s}},
             **NATIVE_PREDICT_TOL})
    finally:
        engine.set_engine_type(os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice"))
        telemetry.set_mode(saved_mode)
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log({"phase": "native", "part": "summary", "seconds": seconds,
         "budget_s": NATIVE["budget_s"], "within_budget": seconds <= NATIVE["budget_s"],
         "launches": launches})
    return launches


# Phase 19, the serving fleet: ResNet-50 (RESNET, the weights of phase 5's
# seed) served over the engine phase's buckets and 5 ms batching delay behind
# the port's Router: first one ReplicaApp in this process, then two replica
# processes on the one card (each its own CUDA context; the card
# time-slices them). Eight fixed payloads of 8 images (bucket 8: one request
# a dispatch) are held bitwise to an in-process cache; the same closed-loop
# load (ENGINE's 8 clients, 40 requests of 1-4 images each) runs through
# both; then a chaos load (60 requests a client) during which replica 0 is
# SIGKILLed once a third of its requests completed and a rollout to new
# weights starts at half, as tools/serve_bench.py's fleet leg. serve_bench's
# new = old x 1.02 + 0.01 sends the random ResNet-50's activations to inf
# (its He-scaled conv weights are 0.02-0.06 across, so +0.01 moves each by
# 15-50 %): the conv and fc weights take x 1.02, the BatchNorm gammas and
# betas and the biases x 1.02 + 0.01.
FLEET = dict(replicas=2, payloads=8, payload_rows=8, requests=40, chaos_requests=60,
             kill_at=1 / 3, rollout_at=1 / 2, scale=1.02, shift=0.01, ready_timeout_s=300,
             dispatch_wait_ms=120000, heartbeat_ms=300, drain_timeout_s=60,
             reload_timeout_s=120)


def compute_apps():
    """(pid, used memory) of each process nvidia-smi sees on the card."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    apps = []
    for line in res.stdout.splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps.append((int(pid), mem.strip()))
    return apps


def pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


class Resubmit:
    """A Router whose admission sheds while no replica is eligible (one
    restarting, the other draining for a rollout): ``submit`` tries again
    after the shed's ``retry_after_ms``, counting the sheds."""

    def __init__(self, router, shed_error):
        self.router, self.shed_error, self.sheds = router, shed_error, []

    def submit(self, inputs):
        while True:
            try:
                return self.router.submit(inputs)
            except self.shed_error as exc:
                self.sheds.append(exc.retry_after_ms)
                time.sleep(max(1, exc.retry_after_ms or 1) / 1e3)


def fleet_clients(router, requests, shed_error):
    """``clients`` through a Router, sheds submitted again. Returns
    (results as ``clients``' are, sheds, wall seconds)."""
    resubmit = Resubmit(router, shed_error)
    t0 = time.perf_counter()
    got = clients(resubmit, requests, timeout=300)
    wall = time.perf_counter() - t0
    for (t, i), (outs, _, _, _) in got.items():
        rows = requests[t][i]["data"].shape[0]
        check(outs[0].shape == (rows, RESNET["num_classes"]) and np.isfinite(outs[0]).all(),
              ("fleet outputs", t, i, outs[0].shape))
    return got, len(resubmit.sheds), wall


def load_stats(got, requests, wall):
    """Throughput and host latency of one closed-loop load."""
    ms = [v[3] for v in got.values()]
    images = sum(r["data"].shape[0] for reqs in requests for r in reqs)
    return {"requests": len(got), "images": images, "seconds": wall,
            "images_per_s": images / wall, "requests_per_s": len(got) / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def check_payloads(call, payloads, want, what):
    for i, (p, w) in enumerate(zip(payloads, want)):
        got = call(p)[0]
        check(np.array_equal(got, w), (what, i, float(np.abs(got - w).max())))


def run_fleet(pt, smi):
    """Phase 19: the serving fleet. Returns the in-process replica's
    launches by kernel."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch import telemetry as tm
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import conv_bn as cb
    from mxnet_tpu_torch.ops import cuda_build
    from mxnet_tpu_torch.serving import PersistentExecutableCache, ServeOverloadError
    from mxnet_tpu_torch.serving.fleet import (Fleet, ReplicaApp, Router, RpcClient,
                                               save_params_npz)
    from mxnet_tpu_torch.telemetry import cli

    t_phase = time.perf_counter()
    check_tf32_off()
    Fc, E = FLEET, ENGINE
    saved_mode = tm.current_override()
    tm.set_mode("trace")  # trace ids minted by the router, spans in every process
    out = {"phase": "fleet", "nvidia_smi": smi, "model": RESNET, "buckets": E["buckets"],
           "replicas": Fc["replicas"], "clients": E["clients"], "rows": E["rows"],
           "requests_per_client": Fc["requests"], "chaos_requests_per_client":
           Fc["chaos_requests"]}
    net = resnet.get_symbol(**RESNET)
    args, aux = resnet_values(net)
    new_args = {n: (v * Fc["scale"] + (Fc["shift"] if n.endswith(("_gamma", "_beta", "_bias"))
                                       else 0.0)).astype(np.float32) for n, v in args.items()}
    rs = np.random.RandomState(SEED + 90)
    payloads = [{"data": rs.uniform(-1, 1, (Fc["payload_rows"],) + image_shape())
                 .astype(np.float32)} for _ in range(Fc["payloads"])]
    load = image_requests(SEED + 91, E["clients"], Fc["requests"], E["rows"])
    chaos = image_requests(SEED + 92, E["clients"], Fc["chaos_requests"], E["rows"])
    root = tempfile.mkdtemp(prefix="mxnet-fleet-")
    spawned = set()
    try:
        # --- 1. the reference: an in-process cache on the card
        ref = PersistentExecutableCache(net, args, aux, ctx=pt.gpu(0))
        want = [ref.run(p)[0] for p in payloads]
        check(all(w.shape == (Fc["payload_rows"], RESNET["num_classes"])
                  and np.isfinite(w).all() for w in want), "reference outputs")
        kernel = cb.conv_block_infer
        cb.conv_block_infer = cb.conv_block_infer_plain  # the plain version, on the card
        try:
            plain = ref.run(payloads[0])[0]
        finally:
            cb.conv_block_infer = kernel
        # the random net's probabilities are nearly one-hot; the entries
        # strictly between 0 and 1 carry the logits' bits
        out["plain_vs_kernel"] = {
            "max_abs_diff": float(np.abs(plain - want[0]).max()),
            "entries_differing": int((plain != want[0]).sum()),
            "entries_in_0_1": int(((want[0] > 0) & (want[0] < 1)).sum()),
            "entries": int(want[0].size)}
        check(out["plain_vs_kernel"]["entries_differing"] > 0,
              "the plain version gives the kernel's bits: the bitwise checks cannot tell them")
        check(np.array_equal(ref.run(payloads[0])[0], want[0]), "the reference repeats its bits")
        params_path = os.path.join(root, "params.npz")
        save_params_npz(params_path, args, aux)
        spec = {"model": "resnet", "model_kwargs": dict(RESNET),
                "item_shapes": {"data": list(image_shape())}, "buckets": list(E["buckets"]),
                "params": params_path, "engine": {"max_delay_ms": E["max_delay_ms"]},
                "telemetry": "trace", "heartbeat_ms": Fc["heartbeat_ms"]}
        router_kw = dict(health_interval_ms=100, dispatch_wait_ms=Fc["dispatch_wait_ms"])

        # --- 2. one replica in this process behind a Router
        t0 = time.perf_counter()
        app = ReplicaApp(dict(spec, replica_id="inproc")).start()
        out["inproc_ready_s"] = time.perf_counter() - t0
        cache, batches = app.engine.cache, []
        run = cache.run
        cache.run = lambda inputs: (batches.append(1), run(inputs))[1]
        router = Router(lambda: {0: app.server.addr}, **router_kw).start()
        try:
            ops.reset_launch_counts()
            check_payloads(lambda p: router.infer(p, timeout=120), payloads, want,
                           "the in-process replica differs from the reference")
            launches = with_zeros(ops.launch_counts())
            check(len(batches) == len(payloads) and launches == with_zeros(
                {"conv_bn_infer": RESNET_SITES * len(batches)}),
                  ("in-process replica launches", len(batches), launches))
            inproc_launches = launches["conv_bn_infer"]
            out["inproc_launches"] = {"batches": len(batches), **{k: v for k, v in
                                                                  launches.items() if v}}
            del cache.run
            got, sheds, wall = fleet_clients(router, load, ServeOverloadError)
            out["single_replica_load"] = dict(load_stats(got, load, wall), sheds=sheds)
        finally:
            router.close()
            app.close()
        del app, cache, router, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        tm.clear_events()

        # --- 3. two replica processes over the same npz
        lib = cuda_build.build_library()
        lib_state = (os.stat(lib).st_mtime_ns, sorted(os.listdir(lib.parent)))
        apps_before = compute_apps()
        free_before = torch.cuda.mem_get_info()[0]
        fleet = Fleet(spec, n_replicas=Fc["replicas"], workdir=os.path.join(root, "fleet"),
                      ready_timeout_s=Fc["ready_timeout_s"], router_kwargs=router_kw)
        t0 = time.perf_counter()
        fleet.start()
        try:
            out["fleet_start_s"] = time.perf_counter() - t0
            sup, router = fleet.supervisor, fleet.router
            out["ready_s"] = [h.ready_t - h.spawned_t for h in sup._handles]
            pids = {rid: s["pid"] for rid, s in sup.states().items()}
            spawned.update(pids.values())
            check(lib_state == (os.stat(lib).st_mtime_ns, sorted(os.listdir(lib.parent))),
                  "a replica built the kernel library again")
            # nvidia-smi may list the processes of a container under one pid
            # with the container's total: the free memory's fall is the
            # replicas' together
            apps = compute_apps()
            free_fleet = torch.cuda.mem_get_info()[0]
            out["card_memory"] = {"compute_apps": apps, "before_fleet": apps_before,
                                  "free_mib_before": free_before / 2**20,
                                  "free_mib_with_fleet": free_fleet / 2**20,
                                  "replicas_mib": (free_before - free_fleet) / 2**20}
            check_payloads(lambda p: router.infer(p, timeout=120), payloads, want,
                           "the fleet differs from the reference")
            for rid, addr in sorted(sup.addresses().items()):
                cli_ = RpcClient(addr, timeout_s=120)
                check_payloads(lambda p: cli_.call("infer", inputs=p), payloads, want,
                               ("replica %d differs from the reference" % rid))
                cli_.close()
            got, sheds, wall = fleet_clients(router, load, ServeOverloadError)
            out["fleet_load"] = dict(load_stats(got, load, wall), sheds=sheds)
            # the same load through replica 0's process alone: the in-process
            # replica shares this process's interpreter with the router and
            # the clients, a replica process does not
            one = Router(lambda: {0: sup.addresses()[0]}, **router_kw).start()
            try:
                got, sheds, wall = fleet_clients(one, load, ServeOverloadError)
            finally:
                one.close()
            out["one_process_load"] = dict(load_stats(got, load, wall), sheds=sheds)
            out["fleet_over_one_process_images_per_s"] = (
                out["fleet_load"]["images_per_s"] / out["one_process_load"]["images_per_s"])
            out["fleet_over_single_images_per_s"] = (out["fleet_load"]["images_per_s"]
                                                     / out["single_replica_load"]["images_per_s"])

            # --- 4. chaos: a SIGKILL and a rollout under load
            total = sum(len(c) for c in chaos)
            done0 = router.health()["counts"]["completed"]
            plan = {}

            def wait_done(frac):
                t_end = time.perf_counter() + 300
                while router.health()["counts"]["completed"] - done0 < frac * total:
                    check(time.perf_counter() < t_end, ("chaos load stalled", frac))
                    time.sleep(0.005)

            def chaos_plan():
                try:
                    wait_done(Fc["kill_at"])
                    plan["kill_t"] = time.perf_counter()
                    plan["killed_pid"] = sup.kill_replica(0)
                    wait_done(Fc["rollout_at"])
                    t0 = time.perf_counter()
                    plan["rollout"] = fleet.rollout(
                        new_args, aux, drain_timeout_s=Fc["drain_timeout_s"],
                        reload_timeout_s=Fc["reload_timeout_s"])
                    plan["rollout_s"] = time.perf_counter() - t0
                except Exception as exc:  # surfaced by the check below
                    plan["error"] = repr(exc)

            counts0 = dict(router.health()["counts"])
            th = threading.Thread(target=chaos_plan)
            th.start()
            got, sheds, wall = fleet_clients(router, chaos, ServeOverloadError)
            th.join(timeout=600)
            check("error" not in plan and "rollout" in plan, ("chaos plan", plan))
            counts = router.health()["counts"]
            delta = {k: counts[k] - counts0[k] for k in counts}
            check(delta["completed"] == delta["submitted"] == total and delta["failed"] == 0,
                  ("requests lost under chaos", delta))
            res = plan["rollout"]
            check(set(res["applied"]) | set(res["recycled"]) == set(range(Fc["replicas"])),
                  ("rollout", res))
            spawned.add(plan["killed_pid"])
            # the fleet back at full strength, replica 0 restarted
            t_end = time.perf_counter() + Fc["ready_timeout_s"]
            while True:
                st = sup.states()
                spawned.update(s["pid"] for s in st.values() if s["pid"])
                if all(s["state"] == "ready" for s in st.values()) and \
                        sum(d["fresh"] for d in router.health()["replicas"].values()) \
                        == Fc["replicas"]:
                    break
                check(time.perf_counter() < t_end, ("the fleet did not recover", st))
                time.sleep(0.05)
            check(st[0]["restarts"] >= 1 and st[0]["pid"] != plan["killed_pid"],
                  ("replica 0 was not restarted", st))
            out["chaos"] = dict(load_stats(got, chaos, wall), sheds=sheds, counts=delta,
                                rollout=res, rollout_s=plan["rollout_s"],
                                restarts={rid: s["restarts"] for rid, s in st.items()},
                                restart_s=sup._handles[0].ready_t - plan["kill_t"],
                                restart_ready_s=(sup._handles[0].ready_t
                                                 - sup._handles[0].spawned_t))
            # the new weights everywhere: the reference after its own swap
            ref.swap_params(new_args, aux)
            want_new = [ref.run(p)[0] for p in payloads]
            check(all(np.isfinite(w).all() for w in want_new)
                  and not np.array_equal(want_new[0], want[0]), "the rolled-out weights' outputs")
            check_payloads(lambda p: router.infer(p, timeout=120), payloads, want_new,
                           "the fleet after the rollout differs from the swapped reference")
            for rid, addr in sorted(sup.addresses().items()):
                cli_ = RpcClient(addr, timeout_s=120)
                check_payloads(lambda p: cli_.call("infer", inputs=p), payloads, want_new,
                               ("replica %d after the rollout differs" % rid))
                cli_.close()

            # --- 5. the merged trace, read by the port's mxtrace
            trace = fleet.collect_fleet_trace()
            problems = cli.check(trace)
            check(problems == [], ("fleet trace schema", problems))
            labels = {int(pid): d["label"]
                      for pid, d in trace["otherData"]["processes"].items()}
            chains = cli.request_chains(trace, top=0)
            spanning = [tid for tid, spans in chains.items()
                        if {labels.get(s["pid"], "").split("-")[0] for s in spans}
                        >= {"router", "replica"}]
            check(spanning, ("no request chain spans the router and a replica", labels))
            path = os.path.join(root, "fleet_trace.json")
            with open(path, "w") as f:
                json.dump(trace, f)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main([path, "--fleet"])
            check(rc == 0, ("mxtrace --fleet", rc))
            out["trace"] = {"events": len(trace["traceEvents"]), "processes": sorted(
                labels.values()), "chains": len(chains), "chains_across_processes":
                len(spanning), "dropped": trace["otherData"].get("dropped", 0),
                "mxtrace_fleet": text.getvalue().splitlines()[:3]}
        finally:
            fleet.close()

        # --- 6. nothing of the fleet remains
        t_end = time.perf_counter() + 30
        while True:
            alive = sorted(p for p in spawned if pid_alive(p))
            apps = compute_apps()
            on_card = sorted(p for p, _ in apps if p in spawned)
            if not alive and not on_card and len(apps) <= len(apps_before):
                break
            check(time.perf_counter() < t_end, ("replicas left after close", alive, on_card,
                                                apps))
            time.sleep(0.2)
        out["teardown"] = {"replica_pids": sorted(spawned), "compute_apps_after": apps}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        tm.set_mode(saved_mode)
        tm.clear_events()
    out["seconds"] = time.perf_counter() - t_phase
    log(out)
    return {"conv_bn_infer": inproc_launches}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    t_smoke = time.perf_counter()
    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    log({"phase": "device", "name": name, "nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "peak_f32_flops": peaks["f32"],
         "peak_tf32_flops": peaks["tf32"], "peak_bytes_per_s": peaks["bytes"]})
    t0 = time.perf_counter()
    lib_path = cuda_build.build_library()
    cuda_build.library()
    log({"phase": "build", "library": str(lib_path.name), "seconds": time.perf_counter() - t0})

    entries = check_kernels(peaks)
    serve_launches = run_slice(pt)
    params = random_params()
    megastep_launches = run_megastep(pt, params, smi)
    paged_launches = run_paged(pt, params, smi)
    train_launches = run_train(pt, params)
    from mxnet_tpu_torch.models import resnet

    net = resnet.get_symbol(**RESNET)
    args, aux = resnet_values(net)
    resnet_serve_launches = run_resnet_serve(pt, net, args, aux)
    resnet_train_launches = run_resnet_train(pt, net, args, aux)
    deploy_launches = run_deploy(pt, net, args, aux)
    engine_launches = run_engine(pt, net, args, aux, params, smi)
    module_launches = run_module(pt, net, args, aux, smi)
    del net, args, aux
    zoo_launches = run_zoo_cnn(pt, smi, peaks, entries)
    mt_launches = run_mt(pt, smi)
    lstm_tokens_per_s = run_lstm(pt, smi)
    ssd_launches = run_ssd(pt, smi)
    kvstore_launches = run_kvstore(pt, smi, peaks, entries)
    fused_launches = run_fused_step(pt, smi, lstm_tokens_per_s)
    checkpoint_launches = run_checkpoint(pt, smi)
    planner_launches = run_planner(pt, smi)
    native_launches = run_native(pt, smi)
    fleet_launches = run_fleet(pt, smi)
    for name_, e in entries.items():
        if name_ in ("matmul_bias_act", "conv_bn", "conv_bn_bwd"):
            # the module phase's card runs: ResNet-50's Module.fit (conv_bn,
            # conv_bn_bwd; its score's stats-free conv_bn as
            # module_infer_launches) and the MNIST nets' (matmul_bias_act)
            e.update(module_launches=module_launches[name_])
            if name_ == "conv_bn":
                e.update(module_infer_launches=module_launches["conv_bn_infer"])
        if name_ in ("matmul_stats", "rtc"):
            e.update(launches=deploy_launches[name_])  # the deploy phase's main path
        elif name_.startswith("conv_bn"):
            # launches: the ResNet's timed training steps; the stats-free
            # variant's: one batch-32 inference forward
            e.update(launches=resnet_train_launches[name_])
            if name_ == "conv_bn":
                # fleet_launches: the fleet phase's in-process replica, the
                # stats-free variant's launches over its payloads
                e.update(infer_launches=resnet_serve_launches["conv_bn_infer"],
                         deploy_infer_launches=deploy_launches["conv_bn_infer"],
                         engine_infer_launches=engine_launches["conv_bn_infer"],
                         fleet_launches=fleet_launches["conv_bn_infer"])
        else:
            # launches: the transformer's timed training steps, the path that
            # runs all six of its kernels
            e.update(launches=train_launches[name_], serve_launches=serve_launches[name_],
                     megastep_launches=megastep_launches[name_],
                     paged_launches=paged_launches[name_],
                     engine_launches=engine_launches.get(name_, 0))
        # the zoo phases' card runs: Inception-v3's and Inception-BN's
        # Module.fit, AlexNet's and VGG-16's training steps and forwards, and
        # the MT step's timed steps
        zoo = {k.split(":")[0]: v for k, v in zoo_launches.items() if k.endswith(":" + name_)}
        if any(zoo.values()):
            e.update(zoo_launches={k: v for k, v in zoo.items() if v})
        if mt_launches.get(name_):
            e.update(mt_launches=mt_launches[name_])
        # the SSD phase's Module.fit: none of the kernels runs there
        e.update(ssd_launches=ssd_launches[name_])
        # the KVStore phase's recommender Module.fit: kernel 6 only
        e.update(recommender_launches=kvstore_launches[name_])
        # the fused-step phase's card runs, each step one CUDA graph:
        # ResNet-50's Module.fit (kernels 8, 9) and the recommender's (6)
        fused = {k: v[name_] for k, v in fused_launches.items() if v.get(name_)}
        if fused:
            e.update(fused_launches=fused)
        # the checkpoint phase's card runs: ResNet-50's elastic fits (8, 9),
        # the sharded mlp's and the recommender's steps (6)
        saved = {k: v[name_] for k, v in checkpoint_launches.items() if v.get(name_)}
        if saved:
            e.update(checkpoint_launches=saved)
        # the planner phase's card runs: ResNet-50's planned fused fit (8, 9),
        # its pipeline (8, 9), the mlp's pipeline (6) and the sharded
        # statistics on one NCCL rank (8, 9)
        planned = {k: v[name_] for k, v in planner_launches.items() if v.get(name_)}
        if planned:
            e.update(planner_launches=planned)
        # the native-runtime phase's card runs: the .rec-fed ResNet-50 fits
        # (8, 9), the C training ABI's LeNet (6), the predict ABI's
        # ResNet-50 (8, stats-free)
        native = {k: v.get(name_ if k != "predict_abi" else name_ + "_infer")
                  for k, v in native_launches.items()}
        native = {k: v for k, v in native.items() if v}
        if native:
            e.update(native_launches=native)
    log({"phase": "smoke", "seconds": time.perf_counter() - t_smoke})
    log({"phase": "profiler", "gap_pause_s": PROFILER_GAP_S, **PROFILER_TALLY})
    log({"kernels": [entries[k] for k in KERNELS]})
    print(smi)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
