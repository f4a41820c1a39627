#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which checks its results (any failure exits non-zero):

1. preamble: the card (``nvidia-smi`` name and power limit), versions,
   and float32 matmuls pinned to full precision (TF32 off);
2. build: the hand-written CUDA kernels, one nvcc per source in
   ``poor_man_gplvm_tpu_torch/csrc``, all started together;
3. kernels: K1 (filter) and K2 (smoother) against their plain PyTorch
   versions on the same inputs on the card, at L in {100, 500}, n_dyn in
   {1, 2}, three cases (constant channel, identical non-constant rows,
   masked bins) and at the decode shape, with the per-step times (both on
   the band of nonzeros and, at L=500, forced dense, bit for bit); their
   batched launches (one thread block per sequence, ragged lengths with a
   1-bin sequence and an odd longest one) against ``*_batch_plain`` and,
   bit for bit, against the unbatched kernel on each sequence alone, and
   held against ``*_batch_plain`` and timed at the batches the epochs
   phase launches (at L=500 its 256-epoch batch, and the launch over all
   1,000 epochs held on those 256);
4. parallel kernels: K3 (filter pass: finals-only, emit) and K4 (smoother
   pass: finals-only, full, marginal, marginal+acc) against their plain
   versions over the same grid at an odd T (ragged last chunk, T-1
   mid-chunk), in "highest" and, with masked bins, in the K5 precisions
   "bf16x3" and "bf16", over whole passes and by the one-step check
   (``testing.pfilter_step_check``), with controls that the check fails
   a kernel held against another precision; K2, K3 and K4 on the band
   against the same kernel forced dense (bit for bit, every mode and
   precision, all three cases; K1 with them); ``joint_acc``
   against its plain version per entry, with its one-pass control that
   must fail; then
   every kernel and mode held against its plain version and timed at
   T=100,000 for L in {100, 500} (CUDA events), beside its bound (the
   nonzeros these inputs need) and, for ``joint_acc``, the one PyTorch call
   that computes the same sum; K3 and K4 finals-only with the band cut to
   one row (the step's fixed cost) and on a dense channel at L=500;
   rng: a fit's initial posterior drawn on the card from a CPU
   generator's MT19937 stream at T=100,000, L=500, the uniforms and the
   generator's state bit for bit against ``torch.rand``, the posterior
   within a few ulps of the host recipe, kernels A (recurrence) and B
   (normalise) timed (``phase_rng``);
5. slice: ``PoissonGPLVMJump1D.decode_latent`` at T=10,000 for (N, L) =
   (100, 100) and (500, 500) through the engine 'auto' resolves to (the
   parallel one above its threshold), held against the plain ``'prob'``
   engine on the card, chunk invariance, naive Bayes, and the decode rate;
   and a decode below the threshold, through K1/K2;
   epochs: ``decode_latent_epochs`` on 100 epochs of 100 bins from a
   T=10,000, N = L = 100 recording (``bench.py``'s epoch cell) and on 1,000
   ragged epochs of 50-400 bins from a T=100,000, N = L = 500 recording,
   through one launch of K1 and one of K2 per batch, every epoch held
   against ``decode_latent`` on that epoch alone and against the unbatched
   kernels on the batch's own log-likelihood rows, a sample against the
   ``'prob'`` engine, with ``batch_size`` invariance, and all epochs
   timed, batched against the per-epoch loop;
6. crossover: decode time of the sequential ('cuda', K1/K2) and the
   parallel ('cuda_parallel', K3/K4) engine over T, at N = L = 100 and
   500;
7. long decode: ``decode_latent`` at T=100,000 for both shapes through the
   engine 'auto' resolves to (the parallel one), held against the
   sequential engine on the card; and at N = L = 500 in the "bf16" and
   "bf16x3" scan precisions, held against "highest";
8. fit: ``fit_em`` at T=100,000, L = N = 100 (the repo's headline fit
   cell): the profiled host loop (s/EM-iteration, M-step/E-step split),
   the unprofiled fused schedule that ``bench.py``'s fit cell runs, the
   device's busy share in a fused fit (``torch.profiler``), the warm-start
   gate measurement (fused fit and mid-iteration E-step with and without
   warm-started fixed points), and the first iterations held against a
   sequential-engine fit;
9. north-star: ``fit_em(output_mode='lean')`` at T=1,000,000, L = N = 500
   (``bench.py``'s north-star cell), a warm-up fit and timed fits in the
   "highest" and "bf16x3" scan precisions (the bench's certificate: final
   log-marginals within 1e-5 relative), a capped fused vs ``fused=False``
   pair (the latter profiled: M-step / E-step seconds per iteration), a
   fused fit under ``torch.profiler`` (device busy share, the count of
   host-to-device copies), a
   middle E-step cold and warm-started, K3 emit and K4 marginal held
   against their plain versions at this shape, and
   ``smooth_combined_chunked(marginal_smooth=True)`` at T=100,000, with
   and without the pairwise joint, held against the full mode in each
   scan precision.
10. precision: the lower levels of ``config.set_matmul_precision``
    ('high', bf16x3; 'default', bf16) on ``bf16_gemm``: (a) the kernel
    against its plain version at both levels on the north-star emission
    (1e6, 500) @ (500, 500), one statistics chunk post.T (500, 2e5) @ y
    read in place and the sweep's batched statistics (64 runs of 1e4
    rows), timed beside its bound, the f32 product and the library's bf16
    product; (b) against a float64 product ('high' close, 'default'
    measurably reduced) and a one-pass control that gate (a) must fail;
    (c) rows (the emission, a statistics chunk) or a batch entry and a
    block of columns alone, and the TMA and cp.async variants (A through a
    padded-stride view, timed), bit for bit; (d) ``decode_latent``
    at T=100,000, N = L = 500 at each level (the CUDA engines
    bit-identical, the log marginal near 'highest', 'checkpoint' equal to
    'full' at 'high'); (e) the north-star lean fit at each level,
    s/EM-iter; (f) a Gaussian jump decode at each level against
    'highest'; (g) back at 'highest', the first decode's bits; (h) the
    pipeline session's widths N = 490, L = 101 (rows TMA refuses): a decode
    and a 2-iteration fit at each level through the cp.async variant;
    launches counted by level and by variant;

11. families: the other three model classes through their entry points
    (``phase_families``);
12. session: one sampled ``PoissonGPLVMJump1D`` recording at N = L = 500
    in a ``TsdFrame``: ``decode_latent`` on it at T=100,000 (the wrapped
    keys against the unwrapped decode, bit for bit, and timed with and
    without bin times), naive Bayes with ``t_l``, ``_decode_latent`` from
    the model's own and from a dense log transition; ``fit_em`` at
    T=20,000 checkpointed every iteration, interrupted and resumed, held
    against the uninterrupted fit, a save timed and sized; and
    ``validation.test_one_model`` at T=10,000, the dynamics null (32
    shuffles in its batches of 16, then ``shuffle_and_decode`` alone at
    ``shuffle_batch_size`` 16 and 132, equal to it; one launch of K1 and
    one of K2 per batch, no NaN, two shuffles bit for bit against
    ``decode_latent`` of each alone, the first batch's K1/K2 against their
    plain versions at T=10,000 on its first 2 shuffles) and the
    naive-Bayes null (100 shuffles);
13. selection: on a sampled recording at N = L = 500, ``bench.py``'s sweep
    fan-out (``sweep_fit_poisson_jump``, 64 runs of T=10,000: one K1 and
    one K2 launch per EM iteration, each run under its own transition,
    every run's E-step rows bit for bit against the unbatched kernels under
    its own configuration and band, four runs against each alone, the
    stages of a call), the config-indexed K1/K2 and the norm-only K1
    against their plain versions and the cost of a padded band, the
    batched Adam runner's fused trip at the sweep's shape (against its
    plain version, timed beside the autograd trip and its bound),
    ``model_selection_one_split`` batched against serial, a realistic
    batched selection (1,600 masked filters through the norm-only K1),
    the gain model (its decode at T=100,000 bit for bit between the two
    CUDA engines, 3 EM iterations) and the L-BFGS M-step;
14. compat (last): the drop-in surface and the reactivation workflow on
    the session's recording (N = L = 500): the functional decoder
    (``decoder.smooth_all_step_combined_ma_chunk`` at T=100,000 through
    K3/K4, bit for bit against ``hmm.smooth_combined_chunked`` on the same
    matrices and within the decode tolerance of ``decode_latent``; the
    filter through one K1 launch; ``filter_all_step``/``smooth_all_step``
    from a precomputed log-likelihood through one K1 and one K2 launch;
    the latent-only pair on a ``PoissonGPLVM1D`` recording; the gain
    smoother bit for bit against ``smooth_combined_chunked(dt_l=gain)``),
    and ``analysis.reactivation``: the within-epoch shuffle null on two
    epochs of 20,000 bins (100 shuffles in batches of 32: one K1 and one
    K2 launch per batch and epoch, two shuffles of each epoch bit for bit
    against the serial path on K1/K2, the serial loop timed, only the
    means copied to the host, the first batch's kernels against plain at
    its full length), the naive-Bayes null, and ``decode_ripple_epochs``
    on the epochs phase's 1,000 ragged epochs, equal to
    ``decode_latent_epochs``;
15. mesh (last): ``parallel.spmd`` on meshes of cuda:0 repeated, at
    N = L = 500: K3/K4 with a time shard's validity bound n_valid (0, 1,
    T - 3, T, T + 1) against their plain versions on the band and forced
    dense, with a failing control, and timed at a shard's bounds; the
    batched K1/K2 with a carry per chain against plain;
    ``decode_latent(mesh=)`` at T = 99,999 on the (1, 4, 1) and (1, 2, 2)
    meshes with both time engines, against the unsharded 'cuda_parallel'
    decode (a neuron-split mesh also against it on its own emission
    rows), its passes and ms per decode; a capped 3-iteration
    ``fit_em(mesh=)`` against the unsharded host loop; one sharded Poisson
    EM step on 2 chains at T = 2e4 against each chain's unsharded
    iteration.

16. pipeline: ``scripts/pipeline_session.py`` on a seeded two-probe
    Kilosort session through the port's loaders, the native binner, the
    filters and sort, a fit and decode, the bursts' epoch decode and the
    naive-Bayes baselines (``phase_pipeline``);
17. workflows (last): the post-fit layer at full width: the T-maze
    workflow (``workflows.tmaze_dataset``) on a fit and decode of a 30 min
    session (N = 500, L = 100, T = 72,000, 40 trials; the decode against
    the sequential engine; the reward zone's latents, the arrivals, the
    jump consensus around them against 100 circular shifts, the
    jump-triggered and null contrastive projections from the fitted
    ``tuning`` on the card), and the ACh workflow
    (``workflows.ach_dataset``) on a model selection (2 chains, 3 EM
    iterations on 80 % of a 20 min sleep session, N = 500, L = 100,
    T = 120,000, evaluated on the rest): ``main`` (event-triggered
    analyses with 100 shuffles) and the distance-vs-label analysis; every
    result computed from card tensors equal to the same function on the
    host copies, the planted effects found (``phase_workflows``);
18. memory (last): recordings longer than the card holds
    (``phase_memory``): (a) ``smooth_combined_chunked`` in 'checkpoint',
    'filter' and 'filter_bf16' against 'full' at T=200,000, N = L = 500 in
    4 chunks on K1/K2 (bit for bit; bf16 within its rounding), each
    mode's peak allocation beside its prediction, and K2 with the prior
    recomputed against its plain version, K2 on K1's priors and its band
    forced dense; (b) a 12-hour recording at 10 ms bins, T=4,320,000,
    N = L = 500, where neither the parallel engine nor full mode fits: a
    lean 2-iteration ``fit_em`` whose E-steps run 'checkpoint' and a
    'filter' decode of the fitted model, bit for bit the last E-step's
    latent marginal, peak memory and seconds per pass; (c) the
    out-of-memory retry of ``decode_latent`` at the north-star shape
    (T=1e6): the card filled after the gate's read, one retry under the
    lean config with the warning, equal to an unforced decode under it;
    a second out-of-memory error raises with the guidance.

Each main path (phases 5 with the epochs, 7-18) runs
with the kernels' launch counts, by mode and precision, set to 0 just
before it and read just after; comparison runs are not counted.  The
line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports torch, numpy and the port
only.
"""

import contextlib
import functools
import json
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np
import torch

T_GRID = 2001  # odd, so no power-of-two blocking hides a ragged tail
T_PSCAN = 20_001  # odd: the last chunk is ragged and T-1 falls inside it
T_DECODE = 10_000  # the repo's decode workload (bench.py decode cell)
T_LONG = 100_000  # the repo's headline fit cell (bench.py fit cell)
SLICE_SHAPES = ((100, 100), (500, 500))  # (N, L)
CROSSOVER_T = {100: (1000, 2000, 5000, 10_000, 20_000, 50_000, 100_000),
               500: (1000, 2000, 5000, 10_000)}  # L = N: decode lengths
# the epochs phase: (N = L, recording length, epochs, (fewest, most) bins,
# batch_size of the second run or None)
EPOCH_CELLS = ((100, 10_000, 100, (100, 100), None),
               (500, 100_000, 1000, (50, 400), 256))
EPOCH_PROB_SAMPLE = 5  # epochs also held against the 'prob' engine
EPOCH_ONE_SAMPLE = 50  # epochs also decoded as a batch of one
# The batched decode of every epoch is held against two references.
# (1) The unbatched kernels on the batch's own log-likelihood rows: the
# same recursion on the same inputs, to EPOCH_SAME_LL_ATOL and
# EPOCH_SAME_LL_LML_RTOL (the marginal over the dynamics and the sum of
# the log ratios are the only operations in another order).
# (2) decode_latent on the epoch alone, whose emission product, (bins, N)
# @ (N, L), sums its N terms in another order than the batch's (E * Tmax,
# N) @ (N, L): the log-likelihoods (~5e2 in size at N = 500) then differ by
# f32 rounding, held to EPOCH_LL_ATOL, and sharp posteriors carry that
# (3.1e-4 on the H100 at N = L = 500; the parallel engine's folded
# emissions moved them by as much).  At N = L = 100 (2) keeps
# DECODE_POST_ATOL.  A Gaussian model's log-likelihoods are quadratic in y
# and sum three products (-1/2 (y^2 w - 2 y w mu + w mu^2)) of ~1e3 at
# N = 100: their gap reached 5.8e-4 there on the H100 and the posteriors
# 2.2e-4, so a Gaussian model is held to EPOCH_LL_ATOL at that width.
EPOCH_POST_ATOL = {(100, "poisson"): 1e-4, (500, "poisson"): 1e-3,
                   (100, "gaussian"): 1e-3}
EPOCH_LL_ATOL = 1e-3
EPOCH_SAME_LL_ATOL = 1e-5
EPOCH_SAME_LL_LML_RTOL = 1e-6
EPOCH_ALONE_ATOL = 1e-5  # a batch of ONE epoch against decode_latent
FIT_ITERS = 10
FIT_CMP_ITERS = 3
GATE_PAIRS = 5  # fused fits with and without warm start, in turns
# the engine comparison fits cap the Adam loop: its relative-change stop
# flips under 1-ulp loss differences, which would compare stopping
# iterations rather than engines
FIT_CMP_MAXITER = 20
DECODE_LMF_RTOL = 1e-5
DECODE_POST_ATOL = 1e-4
FIT_LML_RTOL = 1e-5
# "bf16" scan precision against "highest": its dots round the vector
# operand to bf16 (~1e-3 on the posteriors, the JAX package's own figure)
BF16_POST_ATOL = 1e-2
BF16_LMF_RTOL = 1e-4
# "bf16x3" against "highest": ~2^-17 per dot (the log-marginal is the
# bench's certificate, 1e-5)
BF16X3_POST_ATOL = 1e-3
# the north-star cell (bench.py:_run_northstar)
NS_T, NS_N, NS_L = 1_000_000, 500, 500
NS_ITERS = 12  # the bench's n_iter
NS_WARMUP_ITERS = 3
NS_CMP_ITERS = 4
NS_CMP_MAXITER = 20
NS_CERT_RTOL = 1e-5  # the bench's bf16x3-vs-strict-f32 certificate
T_ACC = 100_000  # the marginal+acc check of the north-star model
# the families phase: the other three model classes
FAMILIES = ("PoissonGPLVM1D", "GaussianGPLVM1D", "GaussianGPLVMJump1D")
FAM_FIT_NL = 100  # N = L of the families' fits (the fit cell's width)
FAM_LEAN_ITERS = 4  # PoissonGPLVM1D's lean fit at the north-star shape
FAM_LOG_T = 2_000  # engine='log' against 'prob', N = L = 100
FAM_LOG_CLASSES = ("PoissonGPLVM1D", "GaussianGPLVMJump1D")
# the session phase: one sampled PoissonGPLVMJump1D session at N = L = 500
# in a TsdFrame, bins of SESSION_DT seconds
SESSION_DT = 0.025
SESSION_NL = 500  # N = L, the north-star width
SESSION_T_FIT = 20_000  # the checkpointed fit
SESSION_FIT_ITERS = 4
SESSION_RESUME_AT = 2  # the fit interrupted after this many iterations
SESSION_SAVES = 3  # timed saves of a checkpoint
SESSION_T_DENSE = 20_000  # _decode_latent on a dense latent channel
SESSION_T_NULL = 10_000  # the circular-shuffle nulls
SESSION_N_SHUFFLE = 32  # the dynamics null
SESSION_BATCHES = (16, 132)  # shuffle_batch_size: the default, the SMs
SESSION_NB_SHUFFLE = 100  # the naive-Bayes null
SESSION_PLAIN_E = 2  # the null's first batch held against plain on these
SESSION_ALONE = 2  # shuffles held against decode_latent alone
# fit_em resumed from a checkpoint against the uninterrupted checkpointed
# fit: the log-marginals within the certified fixed point of the parallel
# engine's E-steps
SESSION_RESUME_RTOL = 1e-5
SEL_NL = 500  # N = L of the selection phase, the north-star width
SEL_T = 20_000  # the sampled recording; (a) and (b) take its head
SWEEP_T = 10_000
SWEEP_GRID = {"movement_variance": [0.5, 1.0, 2.0, 4.0],
              "p_move_to_jump": [0.005, 0.01, 0.02, 0.05]}
SWEEP_KW = dict(n_repeat=4, n_iter=3, tuning_lengthscale=10.0,
                m_maxiter=100)  # bench.py's sweep fan-out cell
SWEEP_ALONE_MAXITER = 20  # four runs against each alone
SWEEP_ALONE_RTOL = 1e-5
# the batched Adam runner's fused trip (csrc/adam_poisson.cu) timed at the
# sweep's shape: runs, the basis rank at tuning_lengthscale 10, and held to
# its plain version one trip from a warm state (tests/test_torch_adam_fused):
# the losses 2e-6 relative, the weights a thousandth of Adam's step of 0.01
# (an update divides the gradient by its own running scale, so a small
# gradient's f32 sums in another order move it most: 1.9e-6 seen)
ADAM_TRIP_RUNS, ADAM_TRIP_RANK = 64, 77
ADAM_TRIP_LOSS_RTOL, ADAM_TRIP_PARAMS_ATOL = 2e-6, 1e-5
# kernel rows vs plain: runs per band width, bins (the sweep's own length)
SWEEP_PLAIN = (1, SWEEP_T)
SPLIT_T = 5_000  # bench.py's model_selection_one_split cell
SPLIT_KW = dict(
    hyperparam_dict={"movement_variance": [0.5, 1.0, 2.0, 4.0],
                     "tuning_lengthscale": [10.0]},
    fit_kwargs={"n_iter": 3, "log_posterior_init": None,
                "n_time_per_chunk": None, "dt": 1.0, "likelihood_scale": 1.0,
                "save_every": None, "posterior_init_kwargs": {
                    "random_scale": 0.1}, "verboase": False},
    model_class_str="poisson", n_repeat=2, latent_downsample_frac=(0.5,),
    downsample_n_repeat=3, verbose=False)
SPLIT_RTOL, SPLIT_ATOL = 1e-4, 1e-6
SPLIT_MAXITER = 25  # the JAX contract's Adam cap (tests/test_selection.py)
GAIN_T = 100_000  # the gain decode and fit, N = L = 500
GAIN_ITERS = 3
GAIN_LML_RTOL = 1e-6  # EM log-marginals non-decreasing to this
BASIS_SHAPE = (100_000, 100, 100)  # bench.py's L-BFGS cell: T, L, N
BASIS_MAXITER = 50
REAL_KW = dict(
    hyperparam_dict={"movement_variance": [0.5, 1.0, 2.0, 4.0],
                     "tuning_lengthscale": [5.0, 10.0]},
    fit_kwargs={"n_iter": 5, "log_posterior_init": None,
                "n_time_per_chunk": None, "dt": 1.0, "likelihood_scale": 1.0,
                "save_every": None, "posterior_init_kwargs": {
                    "random_scale": 0.1}, "verboase": False},
    model_class_str="poisson", n_repeat=5, verbose=False,
    backend="batched")  # default fractions (0.2 ... 0.8) x 10 masks
# the compat phase: the functional decoder on the session's recording
# (N = L = SESSION_NL, T_LONG bins), K1/K2 alone on COMPAT_T_LL rows of
# its log-likelihood, and the reactivation null on two epochs of
# COMPAT_T_EP bins each with the JAX function's defaults
COMPAT_T_LL = 10_000
COMPAT_T_EP = 20_000  # ~8 min at 25 ms
COMPAT_N_SHUFFLE = 100
COMPAT_NB_SHUFFLE = 32  # the naive-Bayes null, cut from 100 for time
COMPAT_BATCH = 32
COMPAT_ALONE = 2  # shuffles of each key bit for bit against the serial path
COMPAT_SERIAL = 4  # shuffles of the timed serial loop
COMPAT_PLAIN_E = 2  # the first batch's shuffles held against plain K1/K2
COMPAT_NULL_RTOL = 1e-5  # batched against serial on the default engine
COMPAT_PROFILE = 8  # shuffles of the profiled null and the host-build timing
MESH_NL = 500  # N = L of the mesh phase, the north-star width
MESH_T = 99_999  # 1e5 - 1: the last time shard holds a padded row
MESH_SHAPES = ((1, 4, 1), (1, 2, 2))  # (data, time, neuron) over cuda:0
MESH_FIT_ITERS = 3
MESH_FIT_MAXITER = 20  # Adam capped, as tests/test_spmd.py caps it
MESH_EM = (2, 20_000, (1, 2, 2), 10)  # chains B, T, mesh, Adam cap
MESH_POST_ATOL = 1e-4  # decode posteriors (PARITY.json)
#: a neuron-split mesh against the unsharded decode: the emissions sum the
#: neuron shards' partial products, another order than one product, and at
#: N = L = 500 sharp posteriors move by ~4e-4 (ROADMAP §3; the epochs
#: phase's gate for an emission product summed in another order); on its
#: own emission rows the mesh is held to MESH_POST_ATOL
MESH_SPLIT_POST_ATOL = 1e-3
MESH_FIT_POST_ATOL = 1e-2  # fit posteriors (PARITY.json)
MESH_NV_REPS = 3
# the session pipeline (scripts/pipeline_session.py on a realistic session)
PIPE_PROBES, PIPE_UNITS = 2, 250
PIPE_DURATION_S, PIPE_DT = 1200.0, 0.01  # T = 120,000 bins of 10 ms
PIPE_L = 101  # the pipeline's n_latent_bin
PIPE_RATE_HZ = 5.0
#: the pipeline's unit filters (scripts/pipeline_session.py defaults)
PIPE_FILTERS = dict(min_total_spikes=500, min_mean_rate=0.01,
                    min_presence_ratio=0.50, n_coarse_bins=100)
PIPE_FIT_ITERS = 3
PIPE_CHUNK = 10_000  # the pipeline's n_time_per_chunk
PIPE_FOLDS = 5
PIPE_BAYES_RTOL = 1e-9  # card float64 against the CPU float64 run
# the post-fit workflows (workflows/{tmaze,ach}_dataset.py) at full width
WF_TMAZE = dict(n_neuron=500, n_latent_bin=100, T=72_000, dt=0.025,
                n_trials=40)  # 30 min of 25 ms bins
WF_ACH = dict(n_neuron=500, n_latent_bin=100, T=120_000, dt=0.01)  # 20 min
WF_FIT_ITERS = 3
WF_CHAINS = 2  # the ACh selection's chains
WF_TEST_FRAC = 0.2  # the ACh selection's held-out tail
WF_N_SHUFFLE = 100
WF_LIN_PT = 108.5  # reward arrival: the first bin past it is in the zone
WF_WINDOW = 10  # the consensus windows' largest half-width (bins)
WF_NULL_Q = 0.95  # the planted effects must clear this shuffle quantile
#: the post-fit functions the card's machine cannot run, by the package
#: they need there
WF_NOT_ON_CARD = {
    "sklearn": ("tmaze_dataset.classify_latent (DBSCAN)",
                "ach_dataset.cluster_peri_event (KMeans)",
                "ach_dataset.latent_cluster_vs_timing_regression"),
    "dill": ("ach_dataset.load_data_and_fit_res",),
    "matplotlib": ("the plot_* functions of tmaze_dataset",
                   "do_plot=True of the ach_dataset functions",
                   "plotting/, plot_helper"),
    "plotly": ("plotting.plotly_helpers",),
}
#: the n_dyn = 1 kernel rows of the kernels line: wrapper[mode] names
NDYN1_KERNELS = ("filter_scan", "smoother_scan",
                 "pfilter_pass[finals/highest]", "pfilter_pass[emit/highest]",
                 "psmooth_pass[finals/highest]", "psmooth_pass[full/highest]",
                 "psmooth_pass[marginal/highest]",
                 "psmooth_pass[marginal_acc/highest]", "joint_acc")
MEM_NL = 500  # N = L of the memory phase, the north-star width
MEM_PARITY_T = 200_000  # (a) the modes against full mode
MEM_PARITY_CHUNK = 50_000  # (a) 4 chunks
MEM_KERNEL_T = 5_000  # (a) K2 with the prior recomputed against plain
MEM_T = 4_320_000  # (b) a 12-hour overnight recording at 10 ms bins
MEM_FIT_ITERS = 2
MEM_FIT_MAXITER = 20  # Adam capped, as the other capped phases
MEM_SEED = 41
MEM_BF16_BOUND = 2.0 ** -8  # bf16's rounding of a probability in [0, 1]
PREC_LEVELS = ("high", "default")  # the lower levels of set_matmul_precision
PREC_T_STATS = 200_000  # one statistics chunk (get_statistics' chunk)
PREC_SWEEP = (64, 10_000)  # the sweep's batched statistics: runs, rows
PREC_ROWS = slice(1000, 1500)  # rows of the emission called alone
PREC_STAT_ROWS = slice(37, 301)  # rows of a statistics chunk called alone
PREC_COLS = slice(130, 300)  # columns called alone (a 4-byte offset)
PREC_PIPE = (490, 101)  # N, L of the pipeline session: the cp.async variant
PREC_ENTRY = 7  # the batch entry called alone
PREC_F64_ROWS = 4096  # the emission slice held against a float64 product
PREC_HIGH_F64 = 5e-6  # 'high' within this of the float64 product
PREC_DEFAULT_F64 = 1e-4  # 'default' farther than this somewhere
PREC_DECODE_RTOL = {"high": 1e-5, "default": 1e-4}  # log marginal vs highest
PREC_CKPT_CHUNK = 25_000  # the checkpoint-vs-full decode: 4 chunks
PREC_NS_ITERS = 5  # the north-star lean fit at each level
PREC_NS_RTOL = 1e-5  # 'high' log_marginal_l vs 'highest'
PREC_GAUSS_T = 100_000  # the Gaussian decode at each level
# the card's peaks (NVIDIA's data sheet, H100 SXM, 700 W): device memory
# rate, float32 outside the tensor cores, dense bf16 and TF32 in the tensor
# cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12

PS_SRC = "poor_man_gplvm_tpu_torch/csrc/parallel_scan.cu"
JPS = "poor_man_gplvm_tpu/ops/pallas/parallel_scan.py"
K5 = f" with K5 {JPS}:126-150"
#: every kernel and mode of the main paths: (wrapper, mode/precision key or
#: None, source, the TPU kernel it replaces)
KERNELS = {
    "filter_scan": ("filter_scan", None,
                    "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
                    "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:80"),
    "smoother_scan": ("smoother_scan", None,
                      "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
                      "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:200"),
    "filter_scan_batch": ("filter_scan_batch", None,
                          "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
                          "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:80"),
    "smoother_scan_batch": (
        "smoother_scan_batch", None,
        "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
        "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:200"),
    **{f"{fn}[{mode}/{prec}]": (fn, f"{mode}/{prec}", PS_SRC, f"{JPS}:{line}"
                                + ("" if prec == "highest" else K5))
       for prec in ("highest", "bf16x3", "bf16")
       for fn, line, modes in (
           ("pfilter_pass", 334, ("finals", "emit")),
           ("psmooth_pass", 474, ("finals", "full", "marginal",
                                  "marginal_acc")))
       for mode in modes},
    "joint_acc": ("joint_acc", "acc/highest", PS_SRC, f"{JPS}:600"),
    # the emission and M-step products at the lower matmul precisions: on
    # the TPU XLA's product (poor_man_gplvm_tpu/ops/emissions.py:103-104,
    # :111-112, :148-149, ops/mstep.py:57, ...), not a Pallas kernel
    **{f"bf16_gemm[{lvl}]": (
        "bf16_gemm", lvl, "poor_man_gplvm_tpu_torch/csrc/bf16_gemm.cu",
        "poor_man_gplvm_tpu/ops/emissions.py:103")
       for lvl in ("high", "default")},
    # K1/K2 with a transition configuration per sequence, and K1 without
    # its row stores (the selection phase)
    "filter_scan_batch[cfg]": (
        "filter_scan_batch", "cfg",
        "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
        "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:80"),
    "smoother_scan_batch[cfg]": (
        "smoother_scan_batch", "cfg",
        "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
        "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:200"),
    "filter_scan_batch[norm]": (
        "filter_scan_batch", "norm",
        "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
        "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:80"),
    # K2 with the prior recomputed from the stored filter posteriors, f32
    # ('filter') and bf16 ('filter_bf16'): the memory phase
    **{f"smoother_push_scan[{key}]": (
        "smoother_push_scan", key,
        "poor_man_gplvm_tpu_torch/csrc/scan_kernels.cu",
        "poor_man_gplvm_tpu/ops/pallas/scan_kernels.py:200")
       for key in ("f32", "bf16")},
    # K3/K4 with a time shard's validity bound n_valid other than its row
    # count (the mesh phase, parallel/spmd.py)
    **{f"{fn}[{mode}/highest/nv]": (fn, f"{mode}/highest/nv", PS_SRC,
                                    f"{JPS}:{line}")
       for fn, line, modes in (("pfilter_pass", 334, ("finals", "emit")),
                               ("psmooth_pass", 474, ("finals", "full")))
       for mode in modes},
}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (exit code 1, no result line) unless ``ok``."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(fn):
    """(result, milliseconds on the card) of one call, no warm-up (the
    plain versions compile nothing)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def wall_s(fn):
    """Host seconds of one call that ends in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _wrappers():
    from poor_man_gplvm_tpu_torch.ops import mstep
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.ops import precision, rng
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk

    return {"filter_scan": sk.filter_scan, "smoother_scan": sk.smoother_scan,
            "filter_scan_batch": sk.filter_scan_batch,
            "smoother_scan_batch": sk.smoother_scan_batch,
            "smoother_push_scan": sk.smoother_push_scan,
            "pfilter_pass": ps.pfilter_pass, "psmooth_pass": ps.psmooth_pass,
            "joint_acc": ps.joint_acc, "bf16_gemm": precision.bf16_gemm,
            "mt19937_draw": rng._launch_draw,
            "mt19937_normalise": rng._launch_normalise,
            "adam_poisson_trip": mstep._launch_adam_trip,
            "adam_poisson_finish": mstep._launch_adam_finish}


@contextlib.contextmanager
def counted(launches):
    """Run a main path with every launch count set to 0 just before it;
    add the counts read just after it to ``launches`` (by wrapper, and by
    wrapper[mode/precision])."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps

    wrappers = _wrappers()
    by = ("launches_by_mode", "launches_by_variant")
    for fn in wrappers.values():
        fn.launches = 0
        for attr in by:
            if hasattr(fn, attr):
                setattr(fn, attr, {})
    ps.reset_launches()
    yield
    torch.cuda.synchronize()
    for name, fn in wrappers.items():
        launches[name] = launches.get(name, 0) + fn.launches
        for attr in by:
            for key, n in getattr(fn, attr, {}).items():
                launches[f"{name}[{key}]"] = launches.get(
                    f"{name}[{key}]", 0) + n


def _path_launches(launches, name):
    wrapper, key = KERNELS[name][:2]
    return launches.get(wrapper if key is None else f"{wrapper}[{key}]", 0)


def bound(nbytes, op_seconds):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of moving ``nbytes`` (each input read once, each output
    written once) and doing the operations (``op_seconds`` at peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, op_seconds), ("bytes" if t_bytes >= op_seconds
                                            else "operations")


def kernel_bound(name, T, L, n_dyn, nnz):
    """The bound of one call of a kernel (name as in KERNELS) over T rows,
    L latent bins and n_dyn channels, whose non-constant channels hold
    ``nnz`` nonzeros in all (a constant channel takes a row sum).  A
    recursion dot needs 2 nnz operations per step, whatever the kernel
    computes (the exact zeros add nothing): f32 in "highest", bf16
    products on the tensor cores in "bf16x3" (3 passes) and "bf16" (1
    pass); K4 does two per step (push and pull).  ``joint_acc`` is three
    TF32 products of 2 T (n_dyn L)^2 operations.  Inputs are the weights
    or posteriors and the transition matrices; outputs what the mode
    stores."""
    f4 = 4.0
    mats = n_dyn * L * L * f4
    state = T * n_dyn * L * f4
    key = name[name.index("[") + 1:-1] if "[" in name else ""
    mode, _, prec = key.partition("/")
    prec = prec or "highest"
    passes = {"highest": 1, "bf16x3": 3, "bf16": 1}[prec]
    rate = F32_FLOP_PER_S if prec == "highest" else BF16_FLOP_PER_S
    dot_s = T * 2.0 * nnz * passes / rate
    joint_s = 3 * 2.0 * T * (n_dyn * L) ** 2 / TF32_FLOP_PER_S
    if name.startswith("filter_scan"):  # a batch: T rows in all
        return bound(T * L * f4 + mats + 2 * state + T * f4, dot_s)
    if name.startswith("smoother_scan"):
        return bound(4 * state + mats, dot_s)
    if name == "joint_acc":
        return bound(2 * state + n_dyn * mats, joint_s)
    if name.startswith("pfilter_pass"):
        out = state + T * f4 if mode == "emit" else 0.0
        return bound(T * L * f4 + mats + out, dot_s)
    out = {"finals": 0.0, "full": 2 * state,
           "marginal": T * (L + n_dyn) * f4,
           "marginal_acc": T * (L + n_dyn) * f4 + n_dyn * mats}[mode]
    return bound(state + 2 * mats + out,
                 2 * dot_s + (joint_s if mode == "marginal_acc" else 0.0))


@contextlib.contextmanager
def scan_precision(mode):
    """Run with the parallel scans' recursion dots in ``mode``."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps

    ps.set_scan_precision(mode)
    try:
        yield
    finally:
        ps.set_scan_precision("highest")


@contextlib.contextmanager
def matmul_precision(level):
    """Run with the emission and M-step products at ``level``."""
    from poor_man_gplvm_tpu_torch import config

    config.set_matmul_precision(level)
    try:
        yield
    finally:
        config.set_matmul_precision("highest")


@contextlib.contextmanager
def sequential_engine():
    """Keep 'cuda' on the sequential kernels K1/K2 at every T (the
    reference runs the parallel engine is held against)."""
    from poor_man_gplvm_tpu_torch.ops import hmm

    saved = hmm._PARALLEL_UPGRADE_MIN_T
    hmm._PARALLEL_UPGRADE_MIN_T = float("inf")
    try:
        yield
    finally:
        hmm._PARALLEL_UPGRADE_MIN_T = saved


def host_line():
    """The host's CPU, the cores this process may use, and the best of
    three timings of 1e7 numpy uniform draws: the host-bound timings move
    with the host (the card's host is shared, and its load averages read
    zero there)."""
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.lower().startswith("model name")), model)
    except OSError:
        pass
    rng, probe = np.random.default_rng(0), float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        rng.random(10_000_000)
        probe = min(probe, time.perf_counter() - t0)
    return (f"host: {model}, {len(os.sched_getaffinity(0))} cores for this "
            f"process, 1e7 numpy draws {1e3 * probe:.1f} ms (best of 3)")


def phase_preamble():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    card = card_line()
    log(f"card: {card}")
    log(host_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, compute capability "
        f"{torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")


def _ptxas_report(text):
    """(kernel and its template arguments as mangled, registers, spill
    stores/loads in bytes) of each entry function in ``nvcc -Xptxas -v``
    output."""
    out, kernel, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.findall(r"\d([a-z][a-z_]*_kernel(?:I\w*?EE)?)", m.group(1))
            kernel = k[-1] if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append((kernel, int(m.group(1)), spill))
            kernel = None
    return out


def phase_build():
    from poor_man_gplvm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    sec = time.perf_counter() - t0
    for name, text in _build.build_log.items():
        for kernel, regs, spill in _ptxas_report(text):
            log(f"  ptxas {name}: {kernel}: {regs} registers, spill {spill}")
    seq = _build.load_scan_kernels()
    par = _build.load_parallel_scan()
    def res(kind, L, W, prec=0):
        return bool(par.pmg_pscan_resident(kind, 2, 1, L, W, prec))

    log(f"build: {sec:.2f} s, one nvcc per source in parallel (resident in "
        f"shared memory, n_dyn=2: K1/K2, each its half of the band of one "
        f"RBF channel (W=21) L=500 "
        f"{bool(seq.pmg_scan_band_resident(2, 1, 500, 21))}, dense L=100 "
        f"{bool(seq.pmg_scan_band_resident(2, 1, 100, 100))}, dense L=500 "
        f"{bool(seq.pmg_scan_band_resident(2, 1, 500, 500))}; K3 push band "
        f"W=21 L=500 {res(0, 500, 21)}, bf16x3 {res(0, 500, 21, 1)}, W=81 "
        f"{res(0, 500, 81)}, dense L=100 {res(0, 100, 100)}, dense L=500 "
        f"{res(0, 500, 500)}; K4 both bands W=21 L=100 {res(1, 100, 21)}, "
        f"L=500 {res(1, 500, 21)}, bf16x3 L=500 {res(1, 500, 21, 1)}, W=81 "
        f"{res(1, 500, 81)}, dense L=100 {res(1, 100, 100)}, dense L=500 "
        f"{res(1, 500, 500)})")


def _fmt(err):
    return ", ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in err.items())


def _forced_dense_band(tlat, tlat_t, flags):
    from poor_man_gplvm_tpu_torch.ops.band import (
        set_band_override, transition_band,
    )

    set_band_override(True)
    try:
        return transition_band(tlat, tlat_t, flags)
    finally:
        set_band_override(False)


def phase_kernels():
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.ops.band import transition_band
    from poor_man_gplvm_tpu_torch.testing import (
        BATCH_LENGTHS, SCAN_CASES, SCAN_TOLERANCES, batch_vs_single,
        kernel_vs_plain, scan_case,
    )

    dev = torch.device("cuda")
    worst = {name: 0.0 for name in ("filter_scan", "smoother_scan",
                                    "filter_scan_batch",
                                    "smoother_scan_batch")}
    grid = [(L, nd, c, T_GRID) for L in (100, 500) for nd in (1, 2)
            for c in SCAN_CASES]
    grid += [(L, 2, "jump", T_DECODE) for L in (100, 500)]
    for L, n_dyn, case, T in grid:
        err = kernel_vs_plain(scan_case(L * 10 + n_dyn, T, L, n_dyn, case),
                              dev)
        torch.cuda.synchronize()
        log(f"kernel vs plain T={T} L={L} n_dyn={n_dyn} {case}: {_fmt(err)}")
        for key, tol in SCAN_TOLERANCES.items():
            check(err[key] <= tol,
                  f"{key}={err[key]} > {tol} ({L}, {n_dyn}, {case})")
        check(err["finite"] and err["masked_exact_zero"], err)
        worst["filter_scan"] = max(worst["filter_scan"], err["post_abs"],
                                   err["prior_abs"])
        worst["smoother_scan"] = max(worst["smoother_scan"],
                                     err["smooth_abs"])

    # the batched launches, one thread block per sequence: ragged lengths
    # with a 1-bin sequence and an odd longest one, against *_batch_plain
    # and, bit for bit, against the unbatched kernel on each sequence alone
    # (the normalisers to 1e-5 relative: a block sum in another order)
    for L, n_dyn, case in [g[:3] for g in grid[:-2]]:
        err = batch_vs_single(scan_case(L * 10 + n_dyn, sum(BATCH_LENGTHS), L,
                                        n_dyn, case), dev)
        torch.cuda.synchronize()
        log(f"K1/K2 batch of {len(BATCH_LENGTHS)} (lengths {BATCH_LENGTHS}) "
            f"vs plain and vs unbatched L={L} n_dyn={n_dyn} {case}: "
            f"{_fmt(err)}")
        for key in ("post_abs", "prior_abs", "smooth_abs", "r_rel"):
            check(err[key] <= SCAN_TOLERANCES[key], (key, err))
        check(err["norm_rel"] <= 1e-5 and err["equal_single"]
              and err["finite"] and err["masked_exact_zero"], err)
        worst["filter_scan_batch"] = max(worst["filter_scan_batch"],
                                         err["post_abs"], err["prior_abs"])
        worst["smoother_scan_batch"] = max(worst["smoother_scan_batch"],
                                           err["smooth_abs"])

    # per-step times at the decode shape (n_dyn=2 with the jump channel),
    # each kernel on its half of the band, made once as a decode makes it,
    # and at L=500 also forced dense (every window the whole column: the
    # design before the band, in the same run), which must give the band's
    # bits
    times = {}
    for L in (100, 500):
        c = scan_case(L, T_DECODE, L, 2, "jump")
        t = {k: torch.as_tensor(v, device=dev) for k, v in c.items()
             if k != "masked"}
        flags = sk._detect_uniform_rows(t["tlat"])
        w = torch.exp(t["ll"] - t["ll"].amax(dim=1, keepdim=True)).contiguous()
        tlat_t = t["tlat"].transpose(-1, -2).contiguous()
        band = transition_band(t["tlat"], tlat_t, flags)
        args_f = (w, t["tlat"], t["tdyn"], t["p_init"], flags)
        post, prior, _ = sk.filter_scan(*args_f, band=band)
        args_s = (post[:-1].contiguous(), prior[1:].contiguous(), tlat_t,
                  t["tdyn"], post[-1].contiguous(), flags)
        runs = {"filter_scan": (sk.filter_scan, sk.filter_scan_plain, args_f),
                "smoother_scan": (sk.smoother_scan, sk.smoother_scan_plain,
                                  args_s)}
        times[L] = {}
        for name, (kern, plain, args) in runs.items():
            ms = cuda_ms(lambda: kern(*args, band=band), 5)
            plain_ms = cuda_ms(lambda: plain(*args), 1)
            times[L][name] = (ms, plain_ms)
            log(f"time {name} L={L} T={T_DECODE}: kernel {ms:.3f} ms "
                f"({1e3 * ms / T_DECODE:.3f} us/step), plain {plain_ms:.1f} "
                f"ms ({1e3 * plain_ms / T_DECODE:.2f} us/step), band "
                f"W={band.W}")
        if L == 500:
            dense = _forced_dense_band(t["tlat"], tlat_t, flags)
            check(dense.W == L, dense.W)
            for name, (kern, plain, args) in runs.items():
                got = kern(*args, band=band)
                want = kern(*args, band=dense)
                check(all(torch.equal(g, x) for g, x in zip(got, want)),
                      f"{name} on the band differs from {name} forced dense")
                ref, plain_ms = timed_once(lambda: plain(*args))
                # K1: posteriors and priors; K2: the smoothed posteriors
                n_out = 2 if name == "filter_scan" else 1
                err = max(float((g - x).abs().max())
                          for g, x in zip(want[:n_out], ref[:n_out]))
                ms = cuda_ms(lambda: kern(*args, band=dense), 3)
                # the bound of the work a dense channel (W = L) needs, as
                # the K3/K4 dense rows count it: L * L nonzeros in the one
                # channel that takes a matvec
                b_ms, b_by = kernel_bound(name, T_DECODE, L, 2, L * L)
                times[L][f"{name}_dense"] = dict(
                    max_abs_err_L500_dense=err, ms_L500_dense=ms,
                    plain_ms_L500_dense=plain_ms, bound_ms_L500_dense=b_ms,
                    bound_by_L500_dense=b_by)
                log(f"time {name} L={L} T={T_DECODE} forced dense "
                    f"(W={dense.W}): kernel {ms:.3f} ms "
                    f"({1e3 * ms / T_DECODE:.3f} us/step), plain "
                    f"{plain_ms:.1f} ms, bound of a dense channel "
                    f"{b_ms:.4f} ms ({b_by}); bit-equal to the band, max "
                    f"|kernel - plain| {err:.3e}")
                check(err <= SCAN_TOLERANCES["post_abs"], (name, err))
    return worst, times, {cell[0]: _batch_timed(cell, dev)
                          for cell in EPOCH_CELLS}


def _epoch_lengths(seed, E, bins):
    """E epoch lengths, uniform over [fewest, most] bins, from a seed."""
    return np.random.default_rng(seed).integers(bins[0], bins[1] + 1, size=E)


def _batch_timed(cell, dev):
    """K1 and K2 batched at the batches a cell of the epochs phase
    launches (its L, its epochs and their lengths, padded to the cell's
    longest; n_dyn=2 with the jump channel): all E epochs where the cell
    runs in one batch, else the first batch of its ``batch_size`` run, held
    against ``*_batch_plain`` over every row of every sequence (posteriors
    and priors; the smoothed posterior, and r relative where prior and
    numerator are > 1e-30) and both timed; then the launch over all E
    epochs (the row's ``all`` entry), timed and held on that first batch's
    epochs.  K2 runs in place on K1's outputs.  The bound takes a batch as
    the sum of its rows."""
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.ops.band import transition_band
    from poor_man_gplvm_tpu_torch.testing import (
        SCAN_TOLERANCES, _max_rel, scan_case,
    )

    L, _, E, bins, bs = cell
    lengths = _epoch_lengths(L, E, bins)
    Tmax = int(lengths.max())
    c = scan_case(L + 1, 64 * Tmax, L, 2, "jump")
    t = {k: torch.as_tensor(v, device=dev) for k, v in c.items()
         if k != "masked"}
    flags = sk._detect_uniform_rows(t["tlat"])
    tlat_t = t["tlat"].transpose(-1, -2).contiguous()
    band = transition_band(t["tlat"], tlat_t, flags)
    nnz = _nnz(t["tlat"], flags)
    w = torch.exp(t["ll"] - t["ll"].amax(dim=1, keepdim=True))
    starts = (torch.arange(E, device=dev) * 7919) % (63 * Tmax)
    w_all = w[starts[:, None] + torch.arange(Tmax, device=dev)[None, :]]
    init_all = t["p_init"].expand(E, 2, L).contiguous()
    len_all = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    valid = torch.arange(Tmax, device=dev)[None, :] < len_all[:, None]
    post, prior, _ = sk.filter_scan_batch(
        w_all, t["tlat"], t["tdyn"], init_all, len_all, flags, band=band)
    last = post[torch.arange(E, device=dev), (len_all - 1).long()].contiguous()
    runs = {"filter_scan_batch": (
                sk.filter_scan_batch, sk.filter_scan_batch_plain,
                lambda sl: (w_all[sl], t["tlat"], t["tdyn"], init_all[sl],
                            len_all[sl].contiguous(), flags)),
            "smoother_scan_batch": (
                sk.smoother_scan_batch, sk.smoother_scan_batch_plain,
                lambda sl: (post[sl, :-1], prior[sl, 1:], tlat_t, t["tdyn"],
                            last[sl], len_all[sl] - 1, flags))}

    def held(name, launch, want, plain_ms, cmp=None):
        """The kernel on the epochs ``launch``, held against ``want`` on its
        first epochs ``cmp`` (all by default), and timed."""
        kern, _, args = runs[name]
        is_k1 = name == "filter_scan_batch"
        got = kern(*args(launch), band=band)
        sl = cmp or launch
        n = sl.stop - sl.start
        got = tuple(g[:n] for g in got)
        # K1 over a sequence's rows, K2 over one row fewer
        own = valid[sl] if is_k1 else valid[sl, 1:]
        err = max(float((g - x).abs()[own].max())
                  for g, x in zip(got[:2 if is_k1 else 1], want))
        check(err <= SCAN_TOLERANCES["post_abs" if is_k1 else "smooth_abs"],
              (name, n, err))
        r_rel = None
        if not is_k1:
            # r[t] = smooth[t + 1] / prior[t + 1], the last row's
            # numerator being the filter's last posterior
            nxt = torch.cat([want[0][:, 1:],
                             torch.zeros_like(last[sl, None])], dim=1)
            nxt[torch.arange(n, device=dev),
                (len_all[sl] - 2).long()] = last[sl]
            where = (own[:, :, None, None] & (prior[sl, 1:] > 1e-30)
                     & (nxt > 1e-30))
            r_rel = _max_rel(got[1], want[1], where)
            check(r_rel <= SCAN_TOLERANCES["r_rel"], (name, n, r_rel))
            del nxt, where
        del got
        if plain_ms is None:
            steps = int(lengths[launch].sum()) - (
                0 if is_k1 else launch.stop - launch.start)
            ms = cuda_ms(lambda: kern(*args(launch), band=band), 5)
            log(f"time {name} L={L} E={launch.stop} epochs ({steps} steps "
                f"in all): kernel {ms:.3f} ms; held on its first {n} "
                f"epochs: max |kernel - plain| {err:.3e}"
                + ("" if r_rel is None else f", r rel {r_rel:.2e}"))
            return dict(err=err, ms=ms, E=launch.stop, steps=steps)
        steps = int(lengths[sl].sum()) - (0 if is_k1 else n)
        b_ms, b_by = kernel_bound(name, steps, L, 2, nnz)
        ms = cuda_ms(lambda: kern(*args(sl), band=band), 5)
        log(f"time {name} L={L} E={n} epochs of {bins[0]}-{bins[1]} bins "
            f"padded to {Tmax} ({steps} steps in all): kernel {ms:.3f} ms "
            f"({1e3 * ms / steps:.4f} us per step of the batch), plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); max |kernel - "
            f"plain| {err:.3e}"
            + ("" if r_rel is None else f", r rel {r_rel:.2e}"))
        return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, E=n, steps=steps)

    first = slice(0, bs or E)
    rows = {}
    for name, (_, plain, args) in runs.items():
        want, plain_ms = timed_once(lambda: plain(*args(first)))
        rows[name] = held(name, first, want, plain_ms)
        if bs:
            # the launch over all E epochs, held on its first batch's
            # epochs (the plain loop over all of them took ~110 s)
            rows[name]["all"] = held(name, slice(0, E), want, None, first)
    return rows


#: the output of each K3/K4 mode that ``_pscan_timed`` holds against the
#: plain version: (index in the returned tuple, tolerance key)
TIMED_OUTPUT = {"emit": (0, "post_abs"), "full": (0, "smooth_abs"),
                "marginal": (0, "lat_abs"), "marginal_acc": (2, "acc_rel"),
                "acc": (0, "acc_rel")}


def _pscan_timed(L, dev, case=None, precs=None, extras=True):
    """Every K3/K4 mode and precision, and joint_acc, at the fit cell's
    length T=100,000, n_dyn=2 with the jump channel (or on ``case``, in
    ``precs``): each kernel call held against its plain version on the
    same inputs (its main output, by the whole-pass tolerance of its
    precision), K3 emit and K4 full by the one-step check, both versions
    timed, with the bound and, for joint_acc, the PyTorch call for the same
    sum; with ``extras`` the one-row probes and, at L=500, the dense
    rows."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.testing import (
        bwd_guess, pfilter_step_check, pscan_inputs, pscan_tolerances,
        psmooth_step_check, scan_case,
    )

    if case is None:
        case = scan_case(L, T_LONG, L, 2, "jump")
    T, n_dyn = case["ll"].shape[0], case["tlat"].shape[0]
    rows = {}
    for prec in precs or ps.SCAN_PRECISIONS:
        tols = pscan_tolerances(prec)
        a = pscan_inputs(case, dev, scan_prec=prec)
        C = a["ins"].shape[0]
        nnz = _nnz(a["tlat"], a["flags"])
        fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
        post = ps.pfilter_pass_plain(*fwd, True, prec)[0]
        ins_b = bwd_guess(post, a["tc"], C)
        bwd = (post, a["tlat"], a["tlat_t"], a["tdyn"], ins_b, a["tc"],
               a["flags"])
        # the band, made once per solve as smooth_parallel makes it
        band = ps.transition_band(a["tlat"], a["tlat_t"], a["flags"], prec)
        # (kernel, plain, the output compared and its tolerance key)
        calls = {f"pfilter_pass[{m}/{prec}]": (
            lambda e=(m == "emit"): ps.pfilter_pass(*fwd, e, prec, band=band),
            lambda e=(m == "emit"): ps.pfilter_pass_plain(*fwd, e, prec),
            TIMED_OUTPUT.get(m, (2, "fwd_finals_abs")))
            for m in ("finals", "emit")}
        for m in ps.PSMOOTH_MODES:
            calls[f"psmooth_pass[{m}/{prec}]"] = (
                lambda m=m: ps.psmooth_pass(*bwd, m, prec, band=band),
                lambda m=m: ps.psmooth_pass_plain(*bwd, m, prec),
                TIMED_OUTPUT.get(m, (2, "bwd_finals_abs")))
        if prec == "highest":
            r = ps.psmooth_pass_plain(*bwd, "full", prec)[1]
            calls["joint_acc"] = (lambda: ps.joint_acc(post, r),
                                  lambda: ps.joint_acc_plain(post, r),
                                  TIMED_OUTPUT["acc"])
        # every mode in every precision is held and timed (KERNELS)
        for name, (kern, plain, (idx, key)) in calls.items():
            want, plain_ms = timed_once(plain)
            got = kern()
            got = got if torch.is_tensor(got) else got[idx]
            want = want if torch.is_tensor(want) else want[idx]
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            ms = cuda_ms(kern, 3)
            bound_ms, bound_by = kernel_bound(name, T, L, n_dyn, nnz)
            probe_ms, probe_txt = _probe(name, prec, fwd, bwd, band, post,
                                         r if prec == "highest" else None) \
                if extras else (None, "")
            lib_ms = None
            if name == "joint_acc":
                lib_ms = cuda_ms(lambda: torch.einsum("tdi,tej->deij", post,
                                                      r), 3)
            rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=lib_ms, probe_ms=probe_ms, C=C,
                              tc=a["tc"])
            log(f"time {name} L={L} T={T} n_dyn={n_dyn} C={C} tc={a['tc']} "
                f"band W={band.W}: kernel "
                f"{ms:.3f} ms ({1e3 * ms / a['tc']:.3f} us/step), plain "
                f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                + ("" if lib_ms is None else f", einsum {lib_ms:.3f} ms")
                + f"; max |kernel - plain| {err:.3e} ({rel:.2e} of max)"
                + probe_txt)
            held = rel if key == "acc_rel" else err
            check(held <= tols[key], (name, key, held, tols[key]))
        step = pfilter_step_check(
            a, ps.pfilter_pass(*fwd, True, prec, band=band)[0], prec)
        sm_k, r_k, _ = ps.psmooth_pass(*bwd, "full", prec, band=band)
        step.update(psmooth_step_check(a, post, ins_b, sm_k, r_k, prec))
        log(f"one-step check K3 emit, K4 full L={L} T={T} n_dyn={n_dyn} "
            f"{prec}: {_fmt(step)}")
        for key, v in step.items():
            check(v <= tols[key], (L, prec, key, v, tols[key]))
    if L == 500 and extras:
        for name, row in _dense_rows(L, dev).items():
            rows[name].update(row)
    return rows


def _probe(name, prec, fwd, bwd, band, post, r):
    """What bounds the redesigned kernels, as (ms or None, log suffix): K3
    and K4 finals-only with the band cut to one row (the step's fixed
    cost: barriers, block sums, divisions, stores), and joint_acc's
    one-product control (the cost of the tensor-core products against the
    rest)."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps

    def cut():
        return band._replace(W=1, mats=band.mats[:, :, :1].contiguous())

    if name == "pfilter_pass[finals/highest]":
        one = cut()
        ms = cuda_ms(lambda: ps.pfilter_pass(*fwd, False, prec, band=one), 3)
        return ms, f"; band cut to one row {ms:.3f} ms"
    if name == "psmooth_pass[finals/highest]":
        one = cut()
        ms = cuda_ms(lambda: ps.psmooth_pass(*bwd, "finals", prec, band=one),
                     3)
        return ms, f"; band cut to one row {ms:.3f} ms"
    if name == "joint_acc":
        ms = cuda_ms(lambda: ps._joint_acc_run(post, r, 1), 3)
        return ms, f"; one TF32 product (the control) {ms:.3f} ms"
    return None, ""


def _nnz(tlat, flags):
    """Nonzeros of the channels of ``tlat`` that take a matvec."""
    return sum(int(torch.count_nonzero(tlat[d]))
               for d, flag in enumerate(flags) if not flag)


def _dense_rows(L, dev):
    """K3 and K4 finals-only in "highest" on a dense channel (the
    'identical' case: channel 0's rows all equal and nonzero, so the band
    is W = L, what a custom kernel gives) at T=100,000: each held against
    its plain version and timed; the ``*_dense`` keys of the kernels
    line, by kernel name."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.testing import (
        bwd_guess, pscan_inputs, pscan_tolerances, scan_case,
    )

    a = pscan_inputs(scan_case(L + 7, T_LONG, L, 2, "identical"), dev)
    C = a["ins"].shape[0]
    fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    post = ps.pfilter_pass_plain(*fwd, True)[0]
    bwd = (post, a["tlat"], a["tlat_t"], a["tdyn"],
           bwd_guess(post, a["tc"], C), a["tc"], a["flags"])
    band = ps.transition_band(a["tlat"], a["tlat_t"], a["flags"])
    check(band.W == L, band.W)
    nnz = _nnz(a["tlat"], a["flags"])
    tols = pscan_tolerances("highest")
    out = {}
    for name, kern, plain, key in (
            ("pfilter_pass[finals/highest]",
             lambda: ps.pfilter_pass(*fwd, False, band=band),
             lambda: ps.pfilter_pass_plain(*fwd, False), "fwd_finals_abs"),
            ("psmooth_pass[finals/highest]",
             lambda: ps.psmooth_pass(*bwd, "finals", band=band),
             lambda: ps.psmooth_pass_plain(*bwd, "finals"),
             "bwd_finals_abs")):
        want, plain_ms = timed_once(plain)
        err = float((kern()[2] - want[2]).abs().max())
        ms = cuda_ms(kern, 3)
        bound_ms, bound_by = kernel_bound(name, T_LONG, L, 2, nnz)
        log(f"time {name} dense channel (W={band.W}) L={L} T={T_LONG}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); max |kernel - plain| {err:.3e}")
        check(err <= tols[key], (name, err))
        out[name] = {"max_abs_err_L500_dense": err, "ms_L500_dense": ms,
                     "plain_ms_L500_dense": plain_ms,
                     "bound_ms_L500_dense": bound_ms,
                     "bound_by_L500_dense": bound_by}
    return out


#: controls of the K3/K4 check: (kernel precision, plain precision) pairs
#: that it must reject, a kernel run in another precision than asked.  On
#: the H100 the one-step share past 1e-5 was 0.42-0.85 with a bf16 side and
#: 2.5e-2 (posteriors, r) for bf16x3 against f32, against a limit of 1e-3.
CONTROLS = (("bf16", "highest"), ("bf16", "bf16x3"), ("highest", "bf16"),
            ("bf16x3", "bf16"), ("bf16x3", "highest"))


def phase_pscan_kernels():
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.testing import (
        JOINT_ACC_ENTRY_RTOL, PSCAN_TOLERANCES, SCAN_CASES, band_vs_dense,
        joint_acc_vs_plain, pscan_failures, pscan_vs_plain, scan_case,
    )

    dev = torch.device("cuda")
    worst = {}

    def hold(err, prec, what):
        torch.cuda.synchronize()
        log(f"K3/K4 vs plain {what} {prec}: {_fmt(err)}")
        check(not pscan_failures(err, prec),
              f"{pscan_failures(err, prec)} ({what}, {prec}): {err}")
        for key in PSCAN_TOLERANCES:
            if key in err:
                worst[(prec, key)] = max(worst.get((prec, key), 0.0), err[key])

    for L in (100, 500):
        for n_dyn in (1, 2):
            for case in SCAN_CASES:
                hold(pscan_vs_plain(scan_case(L * 10 + n_dyn, T_PSCAN, L,
                                              n_dyn, case), dev),
                     "highest", f"T={T_PSCAN} L={L} n_dyn={n_dyn} {case}")
            for prec in ("bf16x3", "bf16"):
                hold(pscan_vs_plain(scan_case(L * 10 + n_dyn, T_PSCAN, L,
                                              n_dyn, "masked"), dev,
                                    scan_prec=prec),
                     prec, f"T={T_PSCAN} L={L} n_dyn={n_dyn} masked")
            # K2, K3 and K4 on the band give the same kernel forced dense
            # bit for bit: W = 21 for the RBF channel, W = L where a
            # channel is dense ('identical'), no band for a lone constant
            # channel
            for case in SCAN_CASES:
                want_W = L if case == "identical" else (
                    0 if (n_dyn, case) == (1, "jump") else 21)
                for prec in ps.SCAN_PRECISIONS:
                    eq = band_vs_dense(scan_case(L * 10 + n_dyn, T_PSCAN, L,
                                                 n_dyn, case), dev, prec)
                    torch.cuda.synchronize()
                    log(f"K2/K3/K4 band vs dense T={T_PSCAN} L={L} "
                        f"n_dyn={n_dyn} {case} {prec}: {eq}")
                    check(eq["band_equal_dense"] and eq["finite"]
                          and eq["masked_exact_zero"] and eq["W"] == want_W
                          and eq["W_dense"] == (L if want_W else 0)
                          and ("k2" in eq["equal_by_mode"])
                          == (prec == "highest"), eq)
            # joint_acc per entry, and its one-pass control, which must fail
            err = joint_acc_vs_plain(L + n_dyn, T_PSCAN, L, n_dyn, dev)
            ctl = joint_acc_vs_plain(L + n_dyn, T_PSCAN, L, n_dyn, dev,
                                     passes=1)
            log(f"joint_acc vs plain T={T_PSCAN} L={L} n_dyn={n_dyn}: "
                f"{_fmt(err)}; one-pass control {_fmt(ctl)} (limit "
                f"{JOINT_ACC_ENTRY_RTOL:.0e} per entry)")
            check(err["acc_entry_rel"] <= JOINT_ACC_ENTRY_RTOL
                  and err["repeatable"], err)
            check(ctl["acc_entry_rel"] > JOINT_ACC_ENTRY_RTOL,
                  f"one-pass control passed: {ctl}")
        # controls: the same check fails a kernel held against the plain
        # version of another precision
        case = scan_case(L * 10 + 2, T_PSCAN, L, 2, "masked")
        for kern_prec, plain_prec in CONTROLS:
            err = pscan_vs_plain(case, dev, scan_prec=kern_prec,
                                 plain_prec=plain_prec, lean=True)
            bad = pscan_failures(err, kern_prec)
            log(f"control T={T_PSCAN} L={L} n_dyn=2 masked: kernel "
                f"{kern_prec} against plain {plain_prec} fails on {bad}: "
                f"{_fmt({k: v for k, v in err.items() if 'step' in k})}")
            check(any(k.startswith("step") for k in bad),
                  f"control passed: kernel {kern_prec}, plain {plain_prec}")
    return worst, {L: _pscan_timed(L, dev) for L in (100, 500)}


def _spikes(seed, tuning, T):
    """Poisson counts along a random-walk latent path with rare jumps."""
    rng = np.random.default_rng(seed)
    L = tuning.shape[0]
    lat = np.empty(T, dtype=np.int64)
    x = int(rng.integers(L))
    steps = rng.integers(-1, 2, size=T)
    jumps = rng.random(T) < 0.01
    targets = rng.integers(L, size=T)
    for t in range(T):
        x = int(targets[t]) if jumps[t] else min(max(x + steps[t], 0), L - 1)
        lat[t] = x
    return rng.poisson(tuning[lat]).astype(np.float32)


def _model(N, L, engine, params=None):
    """The bench model on the card; ``params`` (numpy, from a seed) are
    carried in as a JAX model's state would be."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, convert

    m = PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                           tuning_lengthscale=10.0, device="cuda",
                           inference_engine=engine)
    if params is not None:
        convert.load_jax_state(m, params, m.tuning_basis.cpu().numpy())
    return m


def _decode_setup(N, L, T):
    basis_rank = _model(N, L, "prob").tuning_basis.shape[1]
    params = np.random.default_rng(N + L).normal(
        size=(basis_rank, N)).astype(np.float32)
    m = _model(N, L, "auto", params)
    y = torch.as_tensor(_spikes(N * L, m.tuning.cpu().numpy(), T),
                        device="cuda")
    return m, params, y


def _check_decode(res, T, L):
    check(len(res) == 19, sorted(res))
    post = res["posterior_all"]
    check(post.shape == (T, 2, L), post.shape)
    check(all(bool(torch.isfinite(v).all()) for v in res.values()
              if torch.is_tensor(v)), "non-finite decode output")
    row_err = float((post.sum(dim=(1, 2)) - 1).abs().max())
    ptl_err = float((res["p_transition_latent"].sum(dim=1) - 1).abs().max())
    check(row_err < 1e-4 and ptl_err < 1e-4, (row_err, ptl_err))
    return row_err, ptl_err


def phase_slice(launches):
    from poor_man_gplvm_tpu_torch.ops import hmm

    setups = []
    for N, L in SLICE_SHAPES:
        m_auto, params, y = _decode_setup(N, L, T_DECODE)
        check(m_auto.inference_engine == "cuda", m_auto.inference_engine)
        setups.append((N, L, m_auto, _model(N, L, "prob", params), y))

    # the main path: the repo's decode workload through 'auto'
    with counted(launches):
        results = [m.decode_latent(y) for _, _, m, _, y in setups]
    log(f"decode T={T_DECODE} launches: {launches}")

    for (N, L, m_auto, m_prob, y), res in zip(setups, results):
        row_err, ptl_err = _check_decode(res, T_DECODE, L)
        ref = m_prob.decode_latent(y)
        lmf, lmf_ref = res["log_marginal_final"], ref["log_marginal_final"]
        lmf_rel = abs(lmf - lmf_ref) / abs(lmf_ref)
        post_err = float((res["posterior_all"]
                          - ref["posterior_all"]).abs().max())
        lmf_chunk = m_auto.decode_latent(
            y, n_time_per_chunk=3337)["log_marginal_final"]
        chunk_rel = abs(lmf_chunk - lmf) / abs(lmf)
        nb = m_auto.decode_latent_naive_bayes(y)
        check(nb["posterior_latent"].shape == (T_DECODE, L)
              and np.isfinite(nb["log_marginal_total"]), "naive Bayes")
        log(f"decode N={N} L={L}: log_marginal_final {lmf!r} vs prob "
            f"{lmf_ref!r} (rel {lmf_rel:.2e}), max |post - prob| "
            f"{post_err:.2e}, chunked(3337) rel {chunk_rel:.2e}, row-sum err "
            f"{row_err:.1e}, p_transition_latent row-sum err {ptl_err:.1e}, "
            f"naive-Bayes log marginal {nb['log_marginal_total']!r}")
        check(lmf_rel <= DECODE_LMF_RTOL, lmf_rel)
        check(post_err <= DECODE_POST_ATOL, post_err)
        check(chunk_rel <= DECODE_LMF_RTOL, chunk_rel)

        for name, model, reps in (("auto", m_auto, 5), ("prob", m_prob, 1)):
            def run():
                model.decode_latent(y)["posterior_all"]
            ms = cuda_ms(run, reps)  # ends in a device synchronise
            log(f"decode_latent N={N} L={L} T={T_DECODE} engine={name}: "
                f"{ms:.1f} ms/call, {T_DECODE / (ms / 1e3):.0f} timesteps/s")

    # below the parallel engine's threshold 'auto' stays on K1/K2
    T_short = min(T_DECODE, hmm._PARALLEL_UPGRADE_MIN_T) - 1
    _, _, m_auto, m_prob, y = setups[0]
    with counted(launches):
        res = m_auto.decode_latent(y[:T_short])
    ref = m_prob.decode_latent(y[:T_short])
    rel = abs(res["log_marginal_final"] - ref["log_marginal_final"]) / abs(
        ref["log_marginal_final"])
    log(f"decode T={T_short} (below the threshold): rel {rel:.2e} vs prob; "
        f"launches so far {launches}")
    check(rel <= DECODE_LMF_RTOL, rel)


def _epochs_on_batch_ll(m, y, intervals, post, lml):
    """Hold the batched decode (``post`` (E, Tmax, L), ``lml`` (E,), numpy)
    against the unbatched K1/K2 on each epoch's rows of the batch's own
    log-likelihoods (the one (E * Tmax, N) @ (N, L) product of
    ``hmm.smooth_epochs``): the same recursion on the same inputs.  Returns
    (max |posterior diff|, max relative log-marginal diff, max |batch's
    log-likelihoods - those of the epoch's own (bins, N) @ (N, L)
    product|) over all epochs."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.ops.emissions import get_loglikelihood_ma_all

    dev = y.device
    lengths = intervals[:, 1] - intervals[:, 0]
    lens = torch.as_tensor(lengths, device=dev)
    steps = torch.arange(int(lengths.max()), device=dev)
    valid = steps[None, :] < lens[:, None]
    rows = (torch.as_tensor(intervals[:, 0], device=dev)[:, None]
            + steps[None, :]).clamp(max=y.shape[0] - 1)
    hyper = m._emission_hyper({})
    ll = hmm.epoch_loglikelihoods(
        y[rows] * valid[:, :, None], lens, m.tuning, hyper,
        m.ma_neuron_default, m.ma_latent_default, m.observation_model)
    trans, _ = m._make_transition({})
    tlat, tdyn = hmm._transition_stack(trans)
    band = hmm._cached_band(trans, tlat)
    p_init = torch.exp(trans.uniform_log_init()).reshape(tlat.shape[0], -1)
    post_err = lml_rel = ll_gap = 0.0
    for e, (a, b) in enumerate(intervals):
        n = b - a
        f_post, f_prior, ratios = sk.filter_chunk(
            ll[e, :n], tlat, tdyn, p_init, 1.0,
            uniform_rows=trans.uniform_rows, band=band)
        smooth, _ = sk.smoother_chunk(
            f_post[:-1], f_prior[1:], tlat, tdyn, f_post[-1],
            uniform_rows=trans.uniform_rows, band=band)
        lat = torch.cat([smooth.sum(dim=1), f_post[-1].sum(dim=0)[None]])
        post_err = max(post_err, float(
            (lat - torch.as_tensor(post[e, :n], device=dev)).abs().max()))
        want = float(ratios.sum())
        lml_rel = max(lml_rel, abs(want - lml[e]) / abs(want))
        alone = get_loglikelihood_ma_all(
            y[a:b], m.tuning, hyper, m.ma_neuron_default,
            m.ma_latent_default, observation_model=m.observation_model)
        ll_gap = max(ll_gap, float((alone - ll[e, :n]).abs().max()))
    return post_err, lml_rel, ll_gap


def phase_epochs(launches):
    """``decode_latent_epochs`` at full width (EPOCH_CELLS): the batched
    decode through K1/K2 batch, every epoch held against ``decode_latent``
    on that epoch alone (the per-epoch loop of the reference workflow) and
    against the unbatched kernels on the batch's own log-likelihood rows, a
    sample against the 'prob' engine; all epochs timed on both sides, after
    a warm-up."""
    for cell in EPOCH_CELLS:
        L, T = cell[:2]
        m, params, y = _decode_setup(L, L, T)
        _epochs_cell(m, _model(L, L, "prob", params), y, cell, launches)
        del y


def _epochs_cell(m, m_prob, y, cell, launches):
    """One cell of the epochs phase on the model ``m`` (``m_prob`` the same
    weights on the 'prob' engine) and its recording ``y`` on the card,
    under every gate of the phase."""
    L, T, E, bins, bs = cell
    post_atol = EPOCH_POST_ATOL[L, m.observation_model]
    rng = np.random.default_rng(L + E)
    lengths = _epoch_lengths(L, E, bins)
    starts = rng.integers(0, T - lengths)
    intervals = np.stack([starts, starts + lengths], axis=1)
    Tmax = int(lengths.max())

    def batch_launches(run):
        before = dict(launches)
        with counted(launches):
            sec, res = wall_s(run)
        return sec, res, tuple(
            launches[k] - before.get(k, 0)
            for k in ("filter_scan_batch", "smoother_scan_batch"))

    m.decode_latent_epochs(y, intervals)  # warm-up
    sec, res, n_launch = batch_launches(
        lambda: m.decode_latent_epochs(y, intervals))
    check(n_launch == (1, 1), f"K1/K2 batch launches {n_launch}")
    post, lml = res["posterior_latent_marg"], res["log_marginal_per_epoch"]
    valid = np.arange(Tmax)[None, :] < lengths[:, None]
    check(post.shape == (E, Tmax, L) and lml.shape == (E,)
          and res["posterior_mean"].shape == (E, L)
          and np.array_equal(res["lengths"], lengths)
          and np.array_equal(res["valid"], valid), "epochs result shapes")
    check(np.array_equal(np.isnan(post),
                         np.broadcast_to(~valid[:, :, None], post.shape)),
          "NaN exactly past each epoch's end")
    row_err = float(np.abs(post.sum(axis=2)[valid] - 1).max())
    check(row_err <= 1e-4 and np.isfinite(lml).all()
          and np.isfinite(res["posterior_mean"]).all(), row_err)
    if bs:
        sec_bs, res_bs, n_launch = batch_launches(
            lambda: m.decode_latent_epochs(y, intervals, batch_size=bs))
        n_batch = -(-E // bs)
        check(n_launch == (n_batch, n_batch), n_launch)
        check(all(np.array_equal(res[k], res_bs[k], equal_nan=True)
                  for k in res), f"batch_size={bs} changed the result")
        log(f"epochs N=L={L}: batch_size={bs} ({n_batch} batches, "
            f"{n_launch} launches of K1/K2 batch) equals one batch bit "
            f"for bit; {sec_bs:.3f} s")

    # the per-epoch loop, every epoch, through K1/K2 unbatched
    m.decode_latent(y[intervals[0, 0]:intervals[0, 1]])  # warm-up
    kept = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in intervals:
        d = m.decode_latent(y[a:b])
        kept.append((d["posterior_latent_marg"], d["log_marginal_final"]))
    torch.cuda.synchronize()
    loop_sec = time.perf_counter() - t0
    alone = [k[0].cpu().numpy() for k in kept]
    post_err = max(float(np.abs(alone[e] - post[e, :lengths[e]]).max())
                   for e in range(E))
    lml_rel = max(abs(kept[e][1] - lml[e]) / abs(kept[e][1])
                  for e in range(E))
    same_err, same_rel, ll_gap = _epochs_on_batch_ll(m, y, intervals,
                                                     post, lml)
    # a batch of one epoch: the same kernels on the epoch's own
    # emission product
    one_err = 0.0
    pick = np.sort(rng.choice(E, min(E, EPOCH_ONE_SAMPLE), replace=False))
    for e in pick:
        one = m.decode_latent_epochs(y, intervals[e:e + 1])
        one_err = max(one_err, float(np.abs(
            one["posterior_latent_marg"][0] - alone[e]).max()))
    prob_post, prob_rel = 0.0, 0.0
    for e in pick[:EPOCH_PROB_SAMPLE]:
        a, b = intervals[e]
        ref = m_prob.decode_latent(y[a:b])
        prob_post = max(prob_post, float(np.abs(
            ref["posterior_latent_marg"].cpu().numpy()
            - post[e, :lengths[e]]).max()))
        prob_rel = max(prob_rel, abs(ref["log_marginal_final"] - lml[e])
                       / abs(ref["log_marginal_final"]))
    log(f"decode_latent_epochs {type(m).__name__} N=L={L} E={E} epochs "
        f"of {bins[0]}-{bins[1]}"
        f" bins (Tmax={Tmax}, {int(lengths.sum())} bins in all) from a "
        f"T={T} recording: batched {sec:.4f} s (one launch each of K1 and "
        f"K2 batch), per-epoch decode_latent loop over all {E} epochs "
        f"{loop_sec:.4f} s ({loop_sec / sec:.1f}x); all {E} epochs vs the "
        f"unbatched kernels on the batch's own log-likelihood rows: max "
        f"|post diff| {same_err:.2e} (limit {EPOCH_SAME_LL_ATOL:.0e}), "
        f"log-marginal rel {same_rel:.2e}; the batch's log-likelihoods vs "
        f"each epoch's own product: max |diff| {ll_gap:.2e} (limit "
        f"{EPOCH_LL_ATOL:.0e}); all {E} epochs vs decode_latent alone: "
        f"max |post diff| {post_err:.2e} (limit "
        f"{post_atol:.0e}), log-marginal rel {lml_rel:.2e}; a "
        f"batch of one epoch vs that epoch alone on {len(pick)}: "
        f"{one_err:.2e}; vs the prob engine on "
        f"{min(len(pick), EPOCH_PROB_SAMPLE)}: {prob_post:.2e}, "
        f"{prob_rel:.2e}; row-sum err {row_err:.1e}")
    check(same_err <= EPOCH_SAME_LL_ATOL
          and same_rel <= EPOCH_SAME_LL_LML_RTOL, (same_err, same_rel))
    check(ll_gap <= EPOCH_LL_ATOL, ll_gap)
    check(post_err <= post_atol and lml_rel <= DECODE_LMF_RTOL,
          (post_err, lml_rel))
    check(one_err <= EPOCH_ALONE_ATOL, one_err)
    check(prob_post <= post_atol and prob_rel <= DECODE_LMF_RTOL,
          (prob_post, prob_rel))


def phase_crossover():
    """Decode time of the two engines over T at N = L (the measurement
    behind hmm._PARALLEL_UPGRADE_MIN_T)."""
    for L, lengths in CROSSOVER_T.items():
        m, params, y = _decode_setup(L, L, max(lengths))
        m_par = _model(L, L, "cuda_parallel", params)
        for T in lengths:
            yt = y[:T]
            with sequential_engine():
                seq = cuda_ms(lambda: m.decode_latent(yt)["posterior_all"], 3)
            par = cuda_ms(lambda: m_par.decode_latent(yt)["posterior_all"], 3)
            log(f"crossover N=L={L} T={T}: sequential {seq:.2f} ms, parallel "
                f"{par:.2f} ms ({seq / par:.2f}x)")


def phase_long_decode(launches):
    from poor_man_gplvm_tpu_torch.ops import hmm

    for N, L in SLICE_SHAPES:
        m, params, y = _decode_setup(N, L, T_LONG)
        trans = m._make_transition({})[0]
        check(hmm.engine_resolves_parallel(T_LONG, trans, "cuda", "cuda"),
              "the long decode does not resolve to the parallel engine")
        with counted(launches):
            res = m.decode_latent(y)
        log(f"decode T={T_LONG} N={N} L={L} launches so far: {launches}")
        _check_decode(res, T_LONG, L)
        with sequential_engine():
            ref = m.decode_latent(y)
        lmf, lmf_ref = res["log_marginal_final"], ref["log_marginal_final"]
        lmf_rel = abs(lmf - lmf_ref) / abs(lmf_ref)
        post_err = float((res["posterior_all"]
                          - ref["posterior_all"]).abs().max())
        diag = []
        m._smooth(y, m.tuning, {}, trans, m.ma_neuron_default,
                  m.ma_latent_default, 1.0, None, diag_out=diag)
        log(f"decode T={T_LONG} N={N} L={L}: log_marginal_final {lmf!r} vs "
            f"sequential {lmf_ref!r} (rel {lmf_rel:.2e}), max |post - seq| "
            f"{post_err:.2e}, fixed-point passes (fwd, bwd, fwd_delta, "
            f"bwd_delta) {diag[0]}")
        check(lmf_rel <= DECODE_LMF_RTOL, lmf_rel)
        check(post_err <= DECODE_POST_ATOL, post_err)
        par_ms = cuda_ms(lambda: m.decode_latent(y)["posterior_all"], 3)
        with sequential_engine():
            seq_ms = cuda_ms(lambda: m.decode_latent(y)["posterior_all"], 1)
        log(f"decode_latent N={N} L={L} T={T_LONG}: parallel {par_ms:.1f} "
            f"ms/call ({T_LONG / (par_ms / 1e3):.0f} timesteps/s), "
            f"sequential {seq_ms:.1f} ms/call "
            f"({T_LONG / (seq_ms / 1e3):.0f} timesteps/s)")

    # the same decode (N = L = 500) with the recursion dots in one bf16
    # pass and in the 3-pass split
    for prec, post_atol, lmf_rtol in (("bf16", BF16_POST_ATOL, BF16_LMF_RTOL),
                                      ("bf16x3", BF16X3_POST_ATOL,
                                       NS_CERT_RTOL)):
        with scan_precision(prec):
            with counted(launches):
                res_p = m.decode_latent(y)
            prec_ms = cuda_ms(lambda: m.decode_latent(y)["posterior_all"], 3)
        _check_decode(res_p, T_LONG, L)
        rel_p = abs(res_p["log_marginal_final"] - lmf) / abs(lmf)
        err_p = float((res_p["posterior_all"]
                       - res["posterior_all"]).abs().max())
        log(f"decode T={T_LONG} N=L={L} scan precision {prec}: {prec_ms:.1f} "
            f"ms/call (highest {par_ms:.1f}), log_marginal_final rel "
            f"{rel_p:.2e}, max |post - highest| {err_p:.2e}; launches so far "
            f"{launches}")
        check(rel_p <= lmf_rtol and err_p <= post_atol, (prec, rel_p, err_p))


RNG_SEED = 3_141_592_653  # the generator of the initial-draw phase
RNG_SCALE = 0.1  # the models' random_scale
RNG_POST_ULPS = 8  # the card posterior's gap to the host recipe's


def _clone_generator(g):
    h = torch.Generator()
    h.set_state(g.get_state())
    return h


def phase_rng():
    """The fit's initial posterior drawn on the card from a CPU generator's
    MT19937 stream (``ops/rng.py``) at T_LONG x NS_L, the benchmark fit's
    shape: the uniforms bit for bit against ``torch.rand`` on the host and
    the generator's state after; the posterior within ``RNG_POST_ULPS`` of
    the host recipe's (normalised on the host, copied), its log within
    3e-7; kernel A (the recurrence) and kernel B (normalise and log) timed
    by CUDA events beside their byte bounds; both paths' wall time.
    Returns the rows of kernels A and B."""
    from poor_man_gplvm_tpu_torch.models.base import _log_posterior_init
    from poor_man_gplvm_tpu_torch.ops import rng

    dev = torch.device("cuda")
    T, L = T_LONG, NS_L
    g = torch.Generator().manual_seed(RNG_SEED)
    torch.rand(5, generator=g)  # start inside a twist
    host = _clone_generator(g)
    got = rng._draw((T, L), g, dev, RNG_SCALE)
    t0 = time.perf_counter()
    want = torch.rand((T, L), generator=host) * RNG_SCALE
    host_draw_s = time.perf_counter() - t0
    check(torch.equal(got.cpu(), want), "mt19937: the card's uniforms are "
          "not torch.rand's")
    check(torch.equal(g.get_state(), host.get_state()),
          "mt19937: the generator's state differs from torch.rand's")
    del got, want

    g_card, g_host = _clone_generator(g), _clone_generator(g)
    card_s, (log_post, post) = wall_s(lambda: rng.cpu_stream_posterior(
        T, L, g_card, dev, RNG_SCALE))

    def host_recipe():
        u = torch.rand((T, L), generator=g_host) * RNG_SCALE
        return _log_posterior_init(u / u.sum(dim=1, keepdim=True), dev)

    host_s, (want_log, want_post) = wall_s(host_recipe)
    check(torch.equal(g_card.get_state(), g_host.get_state()),
          "mt19937: the posterior's generator state")
    ulps = int((post.view(torch.int32).long()
                - want_post.view(torch.int32).long()).abs().max())
    rel = float(((log_post.double() - want_log.double()).abs()
                 / want_log.double().abs().clamp_min(1e-30)).max())
    check(ulps <= RNG_POST_ULPS and rel <= 3e-7,
          f"mt19937 posterior against the host recipe: {ulps} ulps, its "
          f"log {rel:.3e}")
    del log_post, post, want_log, want_post

    lib = rng._lib()
    words, left, _ = rng.read_state(g)
    state_in = torch.as_tensor(words.view(np.int32), device=dev)
    state_out = torch.empty_like(state_in)
    out = torch.empty((T, L), device=dev)
    log_out = torch.empty_like(out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms_a = cuda_ms(lambda: lib.pmg_mt_draw(
        state_in.data_ptr(), 625 - left, T * L, RNG_SCALE, out.data_ptr(),
        state_out.data_ptr(), stream), 5)
    ms_b = cuda_ms(lambda: lib.pmg_mt_normalise(
        out.data_ptr(), log_out.data_ptr(), T, L, 0.0, -3.0e38, stream), 20)
    twists = rng.end_position(625 - left, T * L)[0]
    shape = (f"T={T} x L={L} from a CPU generator moved by 5 draws; "
             "launches: the main paths' card fits")
    rows = {
        "mt19937_draw": {
            "ms": ms_a, "bound_ms": 4 * T * L / HBM_BYTES_PER_S * 1e3,
            "bound_by": "the recurrence's chain", "twists": twists,
            "ns_per_twist": ms_a * 1e6 / twists, "host_draw_s": host_draw_s,
            "shape": shape},
        "mt19937_normalise": {
            "ms": ms_b, "bound_ms": 12 * T * L / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "max_ulps_post": ulps,
            "max_rel_err_log_post": rel, "wall_s_card": card_s,
            "wall_s_host_recipe": host_s, "shape": shape}}
    log(f"mt19937 at T={T}, L={L}: uniforms and generator state equal to "
        f"torch.rand's; the posterior within {ulps} ulps of the host "
        f"recipe's, its log within {rel:.3e}; kernel A {ms_a:.3f} ms "
        f"({twists} twists, {ms_a * 1e6 / twists:.1f} ns a twist; bytes "
        f"bound {rows['mt19937_draw']['bound_ms']:.4f} ms: the chain bounds "
        f"it), kernel B {ms_b:.3f} ms (bytes bound "
        f"{rows['mt19937_normalise']['bound_ms']:.4f} ms); the card path "
        f"{card_s:.4f} s against the host recipe {host_s:.4f} s (its draw "
        f"alone {host_draw_s:.4f} s)")
    return rows


def _fit_data(N, L):
    """The fit cell's spikes (Poisson(1), on the card) and initial log
    posterior, from numpy seed 0."""
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.poisson(1.0, size=(T_LONG, N)).astype(np.float32),
                        device="cuda")
    init = rng.random((T_LONG, L)) * 0.1
    return y, np.log(init / init.sum(axis=1, keepdims=True)).astype(np.float32)


def phase_fit(launches):
    """fit_em on the bench model: Poisson(1) spikes and the initial log
    posterior from numpy seeds, random weights from the model's seed."""
    N = L = 100
    y, lpi = _fit_data(N, L)

    def fit(n_iter, **kw):
        em = _model(N, L, "auto").fit_em(y, n_iter=n_iter,
                                         log_posterior_init=lpi,
                                         verboase=False, **kw)
        torch.cuda.synchronize()
        return em

    # the warm-up runs both schedules: the host loop and a fused segment
    t0 = time.perf_counter()
    fit(2)
    fit(3)
    log(f"fit warm-up (2 + 3 EM iterations): {time.perf_counter() - t0:.2f} s")
    with counted(launches):
        t0 = time.perf_counter()
        em = fit(FIT_ITERS, profile=True)
        wall = time.perf_counter() - t0
    log(f"fit T={T_LONG} launches so far: {launches}")
    lml = [float(v) for v in em["log_marginal_l"]]
    check(all(np.isfinite(lml)), lml)
    drops = [(a - b) / abs(a) for a, b in zip(lml, lml[1:])]
    check(all(d <= 1e-6 for d in drops), f"log_marginal_l decreased: {lml}")
    prof = em["profile"]
    m_s, e_s = np.mean(prof["m_step"]), np.mean(prof["e_step"])
    adam = em["m_step_res_l"]["n_iter"]
    adam_ms = 1e3 * sum(prof["m_step"]) / sum(adam)
    check(em["posterior"].shape == (T_LONG, 2, L)
          and bool(torch.isfinite(em["posterior"]).all()), "fit posterior")
    log(f"fit_em T={T_LONG} L={L} N={N}: {wall / FIT_ITERS:.4f} s/EM-iter "
        f"over {FIT_ITERS} iterations (profile on): M-step {m_s:.4f} s, "
        f"E-step {e_s:.4f} s, collect {np.mean(prof['collect']):.6f} s; "
        f"Adam iterations per M-step {adam} ({adam_ms:.3f} ms each); "
        f"fixed-point passes (fwd, bwd) {prof['scan_passes']}")
    log(f"fit log_marginal_l {lml}")

    # the schedule bench.py's fit cell times: no profile, verboase=False,
    # so iterations 1..8 run as the fused segment
    with counted(launches):
        fused_wall, em_f = wall_s(lambda: fit(FIT_ITERS))
    lml_f = [float(v) for v in em_f["log_marginal_l"]]
    check(all(np.isfinite(lml_f)) and all(
        (a - b) / abs(a) <= 1e-6 for a, b in zip(lml_f, lml_f[1:])), lml_f)
    log(f"fit_em T={T_LONG} L={L} N={N} fused schedule (unprofiled): "
        f"{fused_wall / FIT_ITERS:.4f} s/EM-iter over {FIT_ITERS} "
        f"iterations (profiled host loop {wall / FIT_ITERS:.4f}); Adam "
        f"iterations {em_f['m_step_res_l']['n_iter']}; final "
        f"log_marginal {lml_f[-1]!r} (host loop {lml[-1]!r})")
    log_busy("fused fit (5 iterations)", device_busy(lambda: fit(5)))
    _warm_start_gate(y, lpi)

    par = fit(FIT_CMP_ITERS, m_step_maxiter=FIT_CMP_MAXITER)
    with sequential_engine():
        seq = fit(FIT_CMP_ITERS, m_step_maxiter=FIT_CMP_MAXITER)
    a = np.array([float(v) for v in par["log_marginal_l"]])
    b = np.array([float(v) for v in seq["log_marginal_l"]])
    rel = np.abs(a - b) / np.abs(b)
    post_err = float((par["posterior"] - seq["posterior"]).abs().max())
    log(f"fit parallel vs sequential engine, {FIT_CMP_ITERS} iterations, "
        f"m_step_maxiter={FIT_CMP_MAXITER}: log_marginal_l rel {rel.tolist()}, "
        f"max |posterior diff| {post_err:.2e}")
    check(float(rel.max()) <= FIT_LML_RTOL, rel)


def device_busy(fn, top=6):
    """(wall s, device busy s, the ``top`` kernels by device time as (name,
    ms, calls), the count of host-to-device copies) of ``fn`` under
    torch.profiler: the sum of the CUDA kernels' times against the host
    clock around the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_s(fn)
    # a host span (record_function) is mirrored on the device under its
    # own name, which no kernel, copy or fill shares
    ops = prof.key_averages()
    host = {e.key for e in ops if e.device_type != DeviceType.CUDA}
    kernels = [e for e in ops
               if e.device_type == DeviceType.CUDA and e.key not in host]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    h2d = sum(e.count for e in kernels if "memcpy htod" in e.key.lower())
    return wall, busy_us / 1e6, [
        (e.key[:48], round(e.self_device_time_total / 1e3, 1), e.count)
        for e in kernels[:top]], h2d


def log_busy(what, busy):
    wall, dev = busy[:2]
    log(f"{what} under torch.profiler: wall {wall:.3f} s, device busy "
        f"{dev:.3f} s ({100 * dev / wall:.1f} %), idle "
        f"{100 - 100 * dev / wall:.1f} % (the host gap between launches and "
        f"reads); host-to-device copies {busy[3]}; top kernels (name, ms, "
        f"calls) {busy[2]}")


@contextlib.contextmanager
def warm_start(on):
    """Run the fused fits of engine 'auto' with warm-started fixed points
    forced (``on``) or without them, whatever the work gate says."""
    from poor_man_gplvm_tpu_torch.models import base

    saved = base.WARM_START_MIN_WORK
    base.WARM_START_MIN_WORK = 0.0 if on else float("inf")
    try:
        yield
    finally:
        base.WARM_START_MIN_WORK = saved


def _warm_start_gate(y, lpi, pairs=GATE_PAIRS):
    """The warm-start work gate at T=1e5, L=N=100 (T n_dyn L^2 = 2e9):
    ``pairs`` pairs of fused fits of engine 'auto' without warm start and
    with it forced, the order alternating from pair to pair
    (medians, the pairs warm start wins, the spread between the quartiles
    of the fits without it, and the Adam iterations per fit), and one
    mid-iteration E-step at the third iteration's tuning, cold (strict)
    against warm (fast, seeded from the second iteration's solve)."""
    from poor_man_gplvm_tpu_torch.models import base

    N = L = 100
    work = float(y.shape[0]) * 2 * L * L
    per_iter = {"off": [], "on": []}
    adam = {"off": set(), "on": set()}
    for k in range(pairs):
        for ws in ("off", "on") if k % 2 == 0 else ("on", "off"):
            m = _model(N, L, "auto")
            with warm_start(ws == "on"):
                sec, em = wall_s(lambda: m.fit_em(y, n_iter=FIT_ITERS,
                                                  log_posterior_init=lpi,
                                                  verboase=False))
            per_iter[ws].append(sec / FIT_ITERS)
            adam[ws].add(int(sum(em["m_step_res_l"]["n_iter"])))
    wins = sum(a < b for a, b in zip(per_iter["on"], per_iter["off"]))
    q75, q25 = np.percentile(per_iter["off"], [75, 25])
    log(f"warm-start gate, fused fits T={y.shape[0]} L=N={L}, {pairs} pairs: "
        f"s/EM-iter median without warm start "
        f"{np.median(per_iter['off']):.4f}, with it "
        f"{np.median(per_iter['on']):.4f}; warm start faster in {wins} of "
        f"{pairs} pairs; quartile spread without it {q75 - q25:.4f}; Adam "
        f"iterations per fit {adam}; all: {per_iter}")
    m = _model(N, L, "cuda_parallel")
    em = m.fit_em(y, n_iter=3, log_posterior_init=lpi, verboase=False,
                  save_every=1)
    log(f"warm-start gate T={y.shape[0]} L=N={L} (work {work:.1e}, gate "
        f"{base.WARM_START_MIN_WORK:.0e}): "
        + _mid_e_step(m, y, em["tuning_saved"][1:3], reps=3))


def _mid_e_step(m, y, tunings, reps, **kw):
    """One middle E-step of a fit (engine 'cuda_parallel', marginal
    smoothing, no joint; ``kw`` e.g. the memory mode) at the tuning
    ``tunings[1]``, cold (strict fixed points) and warm (fast, seeded from
    the solve at ``tunings[0]``, the iteration before): the host medians
    of ``reps`` calls, the passes, and the log-marginals' gap, which must
    be within 1e-5 relative."""
    from poor_man_gplvm_tpu_torch.ops import hmm

    trans = m._make_transition({})[0]

    def e_step(tuning, **more):
        return hmm.smooth_combined_chunked(
            y, tuning, {}, trans, m.ma_neuron_default, m.ma_latent_default,
            engine="cuda_parallel", marginal_smooth=True, want_acc=False,
            want_scan_carry=True, **kw, **more)

    seed = e_step(tunings[0])[6]
    cold = [wall_s(lambda: e_step(tunings[1])) for _ in range(reps)]
    warm = [wall_s(lambda: e_step(tunings[1], scan_carry_in=seed[:3] + (True,),
                                  scan_fast=True)) for _ in range(reps)]
    cold_ms = 1e3 * float(np.median([c[0] for c in cold]))
    warm_ms = 1e3 * float(np.median([w[0] for w in warm]))
    rel = abs(float(warm[0][1][1]) - float(cold[0][1][1])) / abs(
        float(cold[0][1][1]))
    check(rel <= FIT_LML_RTOL, rel)
    return (f"mid-iteration E-step cold {cold_ms:.2f} ms (passes "
            f"{cold[0][1][6][3][:2]}), warm fast {warm_ms:.2f} ms (passes "
            f"{warm[0][1][6][3][:2]}), medians of {reps}, log-marginal rel "
            f"{rel:.1e}")


@functools.lru_cache(maxsize=1)
@functools.cache
def _ns_spikes():
    """bench.py's north-star spikes on the card, Poisson(0.5) from
    np.random.default_rng(7), made once for the script (~15 s; the
    families phase frees them)."""
    sec, y = wall_s(lambda: torch.as_tensor(
        np.random.default_rng(7).poisson(0.5, size=(NS_T, NS_N))
        .astype(np.float32), device="cuda"))
    log(f"north-star spikes ({NS_T}, {NS_N}) Poisson(0.5): {sec:.1f} s")
    return y


def phase_northstar(launches):
    """bench.py's north-star cell through the port: T=1e6, L = N = 500,
    Poisson(0.5) spikes from np.random.default_rng(7), lean output."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D
    from poor_man_gplvm_tpu_torch.ops import hmm

    y = _ns_spikes()
    kw = dict(output_mode="lean", save_every=10**9, verboase=False)

    def model():
        return PoissonGPLVMJump1D(NS_N, n_latent_bin=NS_L, movement_variance=1,
                                  tuning_lengthscale=10.0, device="cuda")

    sec, _ = wall_s(lambda: model().fit_em(y, n_iter=NS_WARMUP_ITERS, **kw))
    log(f"north-star warm-up fit ({NS_WARMUP_ITERS} iterations): {sec:.1f} s")
    final = {}
    for prec in ("highest", "bf16x3"):
        m = model()
        torch.cuda.reset_peak_memory_stats()
        before = dict(launches)
        with scan_precision(prec), counted(launches):
            sec, em = wall_s(lambda: m.fit_em(y, n_iter=NS_ITERS, **kw))
        peak = torch.cuda.max_memory_allocated() / 1e9
        lml = [float(v) for v in em["log_marginal_l"]]
        check(all(np.isfinite(lml)), lml)
        check(all((a - b) / abs(a) <= 1e-6 for a, b in zip(lml, lml[1:])),
              f"log_marginal_l decreased: {lml}")
        post = em["posterior"]
        row_err = float((post.sum(dim=1) - 1).abs().max())
        check(post.shape == (NS_T, NS_L) and em["log_posterior_final"] is None
              and em["posterior_dynamics_marg"].shape == (NS_T, 2)
              and row_err <= 1e-4, (post.shape, row_err))
        modes = {k: launches.get(k, 0) - before.get(k, 0) for k in launches
                 if "[" in k and launches.get(k, 0) > before.get(k, 0)}
        check(modes.get(f"psmooth_pass[marginal/{prec}]", 0) > 0
              and modes.get(f"pfilter_pass[emit/{prec}]", 0) > 0, modes)
        log(f"north-star fit_em T={NS_T} L=N={NS_L} lean, scan precision "
            f"{prec}: {sec / NS_ITERS:.3f} s/EM-iter over {NS_ITERS} "
            f"iterations ({sec:.1f} s); Adam iterations "
            f"{em['m_step_res_l']['n_iter']}; fixed-point passes per middle "
            f"iteration (fwd, bwd) {m._scan_passes_mid.tolist()}; drift "
            f"{m._scan_drift_mid.tolist()}; emit residuals "
            f"{m._scan_emit_delta_mid.tolist()}; peak memory {peak:.2f} GB; "
            f"row-sum err {row_err:.1e}; launches by mode {modes}")
        log(f"north-star log_marginal_l ({prec}) {lml}")
        final[prec] = (lml[-1], sec / NS_ITERS, peak)
    cert = abs(final["bf16x3"][0] - final["highest"][0]) / abs(
        final["highest"][0])
    log(f"north-star certificate: bf16x3 final log-marginal "
        f"{final['bf16x3'][0]!r} vs highest {final['highest'][0]!r}, rel "
        f"{cert:.2e} (limit {NS_CERT_RTOL:.0e})")
    check(cert <= NS_CERT_RTOL, cert)

    kw_c = dict(kw, n_iter=NS_CMP_ITERS, m_step_maxiter=NS_CMP_MAXITER)
    fused = model().fit_em(y, fused=True, **kw_c)
    # the host loop, profiled: the per-iteration M-step / E-step split
    # (every E-step cold, strict fixed points)
    loop = model().fit_em(y, fused=False, profile=True, **kw_c)
    a = np.array([float(v) for v in fused["log_marginal_l"]])
    b = np.array([float(v) for v in loop["log_marginal_l"]])
    rel = np.abs(a - b) / np.abs(b)
    prof = loop["profile"]
    log(f"north-star fused vs fused=False, {NS_CMP_ITERS} iterations, "
        f"m_step_maxiter={NS_CMP_MAXITER}: log_marginal_l rel {rel.tolist()}; "
        f"host loop (profile on) M-step s {prof['m_step']}, E-step s "
        f"{prof['e_step']}, Adam iterations {loop['m_step_res_l']['n_iter']}, "
        f"fixed-point passes {prof['scan_passes']}")
    check(float(rel.max()) <= FIT_LML_RTOL, rel)
    log_busy(f"north-star fused lean fit ({NS_CMP_ITERS} iterations)",
             device_busy(lambda: model().fit_em(y, n_iter=NS_CMP_ITERS,
                                                **kw)))
    del fused, loop, em
    em3 = model().fit_em(y, n_iter=3, **dict(kw, save_every=1))
    log(f"north-star T={NS_T} L=N={NS_L} lean: "
        + _mid_e_step(m, y, em3["tuning_saved"][1:3], reps=2,
                      memory_mode="checkpoint"))
    del em3
    _northstar_kernels(m, y)

    # marginal smoothing, with the pairwise joint (K4 marginal+acc and
    # joint_acc) and without it, against the full mode in the same scan
    # precision, on the fitted north-star model, in every precision
    trans = m._make_transition({})[0]
    args = (y[:T_ACC], m.tuning, {}, trans, m.ma_neuron_default,
            m.ma_latent_default)
    for prec in ("highest", "bf16x3", "bf16"):
        with scan_precision(prec):
            full = hmm.smooth_combined_chunked(*args, engine="cuda_parallel",
                                               memory_mode="full")
        with scan_precision(prec), counted(launches):
            marg = hmm.smooth_combined_chunked(
                *args, engine="cuda_parallel", memory_mode="checkpoint",
                marginal_smooth=True, want_acc=True)
            lean = hmm.smooth_combined_chunked(
                *args, engine="cuda_parallel", memory_mode="checkpoint",
                marginal_smooth=True, want_acc=False)
        p_full = torch.exp(full[0])
        lat_err = float((torch.exp(marg[0][0])
                         - p_full.sum(dim=1)).abs().max())
        dyn_err = float((torch.exp(marg[0][1])
                         - p_full.sum(dim=2)).abs().max())
        acc_f, acc_m = torch.exp(full[4]), torch.exp(marg[4])
        acc_rel = float((acc_m - acc_f).abs().max() / acc_f.abs().max())
        lml_rel = abs(float(marg[1]) - float(full[1])) / abs(float(full[1]))
        same = all(torch.equal(a, b) for a, b in zip(lean[0], marg[0])) \
            and lean[4] is None
        log(f"smooth_combined_chunked T={T_ACC} L={NS_L} {prec}: marginal+acc "
            f"vs full: latent marginal {lat_err:.2e}, dynamics marginal "
            f"{dyn_err:.2e}, joint {acc_rel:.2e} of max, log-marginal rel "
            f"{lml_rel:.1e}; want_acc=False marginals bit-equal {same}; "
            f"launches so far {launches}")
        check(lat_err <= DECODE_POST_ATOL and dyn_err <= DECODE_POST_ATOL
              and acc_rel <= DECODE_POST_ATOL and lml_rel <= DECODE_LMF_RTOL
              and same, (prec, lat_err, dyn_err, acc_rel, lml_rel, same))
    del y


def _northstar_kernels(m, y):
    """K3 emit and K4 marginal, the modes of every lean E-step, held
    against their plain versions at the north-star's own shape (T = 1e6,
    L = 500, C = 128 chunks of 7,813 rows) in "highest" and "bf16x3", on
    the fitted model's log-likelihood: posteriors, marginals, finals and
    the one-step check (not counted: a comparison)."""
    from poor_man_gplvm_tpu_torch.ops.emissions import get_loglikelihood_ma_all
    from poor_man_gplvm_tpu_torch.testing import pscan_failures, pscan_vs_plain

    trans = m._make_transition({})[0]
    ll = get_loglikelihood_ma_all(
        y, m.tuning, {}, torch.broadcast_to(m.ma_neuron_default, y.shape),
        m.ma_latent_default, observation_model="poisson")
    case = {"ll": ll, "tlat": trans.Tlat, "tdyn": trans.Tdyn,
            "p_init": torch.exp(trans.uniform_log_init()),
            "masked": np.array([], dtype=np.int64)}
    for prec in ("highest", "bf16x3"):
        sec, err = wall_s(lambda: pscan_vs_plain(case, y.device,
                                                 scan_prec=prec, lean=True))
        log(f"K3 emit / K4 marginal vs plain at the north-star shape T={NS_T} "
            f"L={NS_L} C=128 {prec} ({sec:.1f} s): {_fmt(err)}")
        check(not pscan_failures(err, prec), (prec, pscan_failures(err, prec)))
    del case, ll


def _family_model(name, N, L, engine, seed=None, **kw):
    """A model of class ``name`` on the card (the bench model's
    lengthscales); ``seed``: random weights from numpy, carried in as a JAX
    model's state would be."""
    import poor_man_gplvm_tpu_torch as pmt
    from poor_man_gplvm_tpu_torch import convert

    m = getattr(pmt, name)(N, n_latent_bin=L, movement_variance=1,
                           tuning_lengthscale=10.0, device="cuda",
                           inference_engine=engine, **kw)
    if seed is not None:
        params = np.random.default_rng(seed).normal(
            size=(m.n_basis, N)).astype(np.float32)
        convert.load_jax_state(m, params, m.tuning_basis.cpu().numpy())
    return m


def _family_data(m, T, seed, lo=0):
    """Observations of the model ``m`` along a numpy random walk over the
    bins [lo, L) (with jumps at rate 0.01 where the model has a jump state;
    a latent-only model follows steps only), on the card: Poisson counts
    at its rates, or its means plus normal noise of ``noise_std``; and the
    walk, (T,) int64 numpy."""
    rng = np.random.default_rng(seed)
    L = m.n_latent_bin
    steps = rng.integers(-1, 2, size=T)
    jumps = rng.random(T) < (0.01 if m.has_dynamics else 0.0)
    targets = rng.integers(lo, L, size=T)
    lat = np.empty(T, dtype=np.int64)
    x = int(rng.integers(lo, L))
    for t in range(T):
        x = int(targets[t]) if jumps[t] else min(max(x + steps[t], lo), L - 1)
        lat[t] = x
    mean = m.tuning.cpu().numpy()[lat]
    if m.observation_model == "gaussian":
        y = mean + m.noise_std * rng.normal(size=mean.shape)
    else:
        y = rng.poisson(mean)
    return torch.as_tensor(y.astype(np.float32), device="cuda"), lat


def _row_sum_err(post):
    return float((post.sum(dim=tuple(range(1, post.ndim))) - 1).abs().max())


def _max_key_diff(res, ref):
    """max |difference| per tensor key of two decode results."""
    return {k: float((v - ref[k]).abs().max()) for k, v in res.items()
            if torch.is_tensor(v)}


@contextlib.contextmanager
def counted_into(*targets):
    """``counted`` into several launch dicts at once."""
    got = {}
    with counted(got):
        yield
    for target in targets:
        for k, v in got.items():
            target[k] = target.get(k, 0) + v


def _gemm_bound(a, b, passes):
    """(ms, by) of one product a @ b: its operands read once and its f32
    output written once, against ``passes`` bf16 products on the tensor
    cores (the f32 product of 'highest': one product at the f32 rate)."""
    B = a.shape[0] if a.ndim == 3 else 1
    M, K = a.shape[-2:]
    N = b.shape[-1]
    nbytes = 4.0 * (B * M * K + b.numel() + B * M * N)
    rate = F32_FLOP_PER_S if passes == 0 else BF16_FLOP_PER_S
    return bound(nbytes, max(passes, 1) * 2.0 * B * M * N * K / rate)


def _prec_products():
    """The three products of the main path at full size: the north-star
    emission y (1e6, 500) @ (log lam).T (a transposed view), one
    statistics chunk post.T (500, 2e5) (read in place) @ y, and the sweep's
    batched statistics (64 runs of 1e4 rows)."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D
    from poor_man_gplvm_tpu_torch.testing import bf16_gemm_case

    m = PoissonGPLVMJump1D(NS_N, n_latent_bin=NS_L, movement_variance=1,
                           tuning_lengthscale=10.0, device="cuda")
    yield "emission", (_ns_spikes(), torch.log(m.tuning + 1e-20).T)
    yield "statistics", bf16_gemm_case("statistics", PREC_T_STATS, NS_N,
                                       NS_L, "cuda", 1501)
    yield "batched", bf16_gemm_case("batched", PREC_SWEEP[1], NS_N, NS_L,
                                    "cuda", 1502, batch=PREC_SWEEP[0])


def _prec_kernel(rows):
    """(a)-(c): ``bf16_gemm`` at each level against its plain version on
    the main path's products, timed beside the plain version, its bound,
    the f32 product and the library's bf16 product; the failing controls
    against a float64 product; rows (the emission, the statistics) or a
    batch entry (the batched statistics) alone and a block of columns
    alone, bit for bit; the TMA variant and the cp.async one (A through a
    padded-stride view, timed) bit for bit."""
    from poor_man_gplvm_tpu_torch.ops import precision
    from poor_man_gplvm_tpu_torch.testing import (bf16_gemm_cols_alone,
                                                  bf16_gemm_rows_alone,
                                                  bf16_gemm_rtol,
                                                  bf16_gemm_variants_equal,
                                                  padded_copy)

    for kind, (a, b) in _prec_products():
        sfx = "" if kind == "emission" else f"_{kind}"
        K = a.shape[-1]
        scale = float(torch.matmul(a.abs(), b.abs()).max())
        f32_ms = cuda_ms(lambda: torch.matmul(a, b), 3)
        try:
            ab, bb = a.bfloat16(), b.bfloat16()
            lib_ms = cuda_ms(lambda: torch.mm(ab, bb, out_dtype=torch.float32),
                             3) if a.ndim == 2 else None
            del ab, bb
        except (TypeError, RuntimeError) as exc:  # no out_dtype
            lib_ms = None
            log(f"precision (a) {kind}: torch.mm(out_dtype=float32) not "
                f"available ({exc!r:.120})")
        f32_bound = _gemm_bound(a, b, 0)
        for lvl in PREC_LEVELS:
            passes = precision.PASSES[lvl]
            want, plain_ms = timed_once(lambda: precision.matmul_plain(
                a, b, lvl))
            got = precision._gemm_run(a, b, passes)
            diff = float((got - want).abs().max())
            err = diff / scale
            ms = cuda_ms(lambda: precision._gemm_run(a, b, passes), 3)
            b_ms, b_by = _gemm_bound(a, b, passes)
            r = PREC_ROWS if kind == "emission" else PREC_STAT_ROWS
            alone = (bf16_gemm_rows_alone(a, b, lvl, entry=PREC_ENTRY)
                     if a.ndim == 3 else
                     bf16_gemm_rows_alone(a, b, lvl, rows=r))
            cols = bf16_gemm_cols_alone(a, b, lvl, PREC_COLS)
            same, variants = bf16_gemm_variants_equal(a, b, lvl)
            padded = padded_copy(a)
            cp_ms = cuda_ms(lambda: precision._gemm_run(padded, b, passes), 3)
            del padded
            log(f"precision (a) bf16_gemm[{lvl}] {kind} {tuple(a.shape)} @ "
                f"{tuple(b.shape)}: {ms:.3f} ms (plain {plain_ms:.3f}, bound "
                f"{b_ms:.4f} by {b_by}; f32 torch.matmul {f32_ms:.3f}, bound "
                f"{f32_bound[0]:.4f}; library bf16 with f32 output "
                f"{lib_ms if lib_ms is None else round(lib_ms, 3)}); vs plain "
                f"max |diff| {diff:.3e} = {err:.2e} of max |a|@|b| (limit "
                f"{bf16_gemm_rtol(K):.0e}); (c) "
                + ("entry %d alone" % PREC_ENTRY if a.ndim == 3 else
                   "rows [%d, %d) alone" % (r.start, r.stop))
                + f" bit-equal {alone}, columns [{PREC_COLS.start}, "
                f"{PREC_COLS.stop}) alone bit-equal {cols}, variants "
                f"{variants} bit-equal {same} (cp.async {cp_ms:.3f} ms) "
                f"({card_line()})")
            check(err <= bf16_gemm_rtol(K), (lvl, kind, err))
            check(alone and cols, (lvl, kind, "not row independent"))
            check(same and variants == ("tma", "cp_async"),
                  (lvl, kind, "the variants differ", variants))
            row = rows.setdefault(f"bf16_gemm[{lvl}]", {})
            row.update({
                f"max_abs_err{sfx}": diff, f"rel_err{sfx}": err,
                f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                f"bound_ms{sfx}": b_ms, f"bound_by{sfx}": b_by,
                f"library_ms{sfx}": lib_ms if lvl == "default" else f32_ms,
                f"f32_matmul_ms{sfx}": f32_ms,
                f"f32_matmul_bound_ms{sfx}": f32_bound[0],
                f"cp_async_ms{sfx}": cp_ms})
            if kind == "emission":
                _prec_controls(a, b, lvl, got, want, scale)
            del want, got
        del a, b
        torch.cuda.empty_cache()


def _prec_controls(a, b, lvl, got, want, scale):
    """(b): the level against a float64 product on the first
    PREC_F64_ROWS rows ('high' within PREC_HIGH_F64, 'default' farther
    than PREC_DEFAULT_F64 somewhere); at 'high' the kernel run with one
    pass where three were asked must fail gate (a)."""
    from poor_man_gplvm_tpu_torch.ops import precision
    from poor_man_gplvm_tpu_torch.testing import bf16_gemm_rtol

    r = PREC_F64_ROWS
    ref = a[:r].double() @ b.double()
    sc = float(torch.matmul(a[:r].abs(), b.abs()).max())
    f64_err = float((got[:r].double() - ref).abs().max()) / sc
    ok = (f64_err <= PREC_HIGH_F64 if lvl == "high"
          else f64_err > PREC_DEFAULT_F64)
    log(f"precision (b) bf16_gemm[{lvl}] emission rows [0, {r}) vs float64: "
        f"{f64_err:.2e} of max |a|@|b| (" + (
            f"limit {PREC_HIGH_F64:.0e})" if lvl == "high" else
            f"must exceed {PREC_DEFAULT_F64:.0e}: the level is reduced)"))
    check(ok, (lvl, "float64 control", f64_err))
    if lvl == "high":
        one = precision._gemm_run(a, b, 1)
        bad = float((one - want).abs().max()) / scale
        log(f"precision (b) control: one bf16 pass where 'high' was asked, "
            f"vs the plain 'high' product {bad:.2e} (must exceed "
            f"{bf16_gemm_rtol(a.shape[-1]):.0e})")
        check(bad > bf16_gemm_rtol(a.shape[-1]), ("one-pass control", bad))
        del one


def _prec_decode(launches):
    """(d) decode_latent at T = T_LONG, N = L = 500 at each level: the
    engines 'cuda' (K1/K2) and 'cuda_parallel' (K3/K4) bit-identical, the
    log marginal within PREC_DECODE_RTOL of 'highest', 'checkpoint'
    bit-equal to 'full' at 'high'; (g) back at 'highest', the first
    decode's bits.  Returns the decode ms per level."""
    from poor_man_gplvm_tpu_torch.ops import hmm

    N = L = SLICE_SHAPES[1][0]
    m, params, y = _decode_setup(N, L, T_LONG)
    m_seq, m_par = _model(N, L, "cuda", params), _model(N, L,
                                                        "cuda_parallel",
                                                        params)
    trans, _ = m_seq._make_transition({})
    args = (y, m_seq.tuning, {}, trans.logTlat, trans.logTdyn,
            m_seq.ma_neuron_default)
    first, lmf, times = None, {}, {}
    for lvl in ("highest",) + PREC_LEVELS:
        with matmul_precision(lvl):
            with counted(launches):
                res = m.decode_latent(y)
            _check_decode(res, T_LONG, L)
            times[lvl] = cuda_ms(lambda: m.decode_latent(y)["posterior_all"],
                                 3)
            with sequential_engine():
                seq = m_seq._decode_latent(*args, n_time_per_chunk=T_LONG)
            par = m_par._decode_latent(*args, n_time_per_chunk=T_LONG)
            same = torch.equal(seq[0], par[0]) and float(seq[1]) == float(
                par[1])
            del seq, par
        lmf[lvl] = float(res["log_marginal_final"])
        if first is None:
            first = res
        rel = abs(lmf[lvl] - lmf["highest"]) / abs(lmf["highest"])
        err = float((res["posterior_all"] - first["posterior_all"]).abs()
                    .max())
        log(f"precision (d) decode T={T_LONG} N=L={L} at '{lvl}': "
            f"{times[lvl]:.1f} ms/call; 'cuda' and 'cuda_parallel' "
            f"bit-identical {same}; log_marginal_final {lmf[lvl]!r}, rel to "
            f"'highest' {rel:.2e}, max |post - highest| {err:.2e}; launches "
            f"so far {launches} ({card_line()})")
        check(same, (lvl, "the CUDA engines differ"))
        if lvl != "highest":
            check(rel <= PREC_DECODE_RTOL[lvl], (lvl, rel))
            check(err > 0.0, (lvl, "the level changed nothing"))
        del res
    trans_j = m._make_transition({})[0]
    with matmul_precision("high"), sequential_engine():
        out = {mode: hmm.smooth_combined_chunked(
            y, m.tuning, {}, trans_j, m.ma_neuron_default, None,
            n_time_per_chunk=PREC_CKPT_CHUNK, engine="cuda",
            memory_mode=mode) for mode in ("full", "checkpoint")}
    same = (torch.equal(out["full"][0], out["checkpoint"][0])
            and float(out["full"][1]) == float(out["checkpoint"][1])
            and torch.equal(out["full"][3], out["checkpoint"][3]))
    log(f"precision (d) 'checkpoint' vs 'full' at 'high', T={T_LONG} in "
        f"chunks of {PREC_CKPT_CHUNK} on K1/K2: posteriors, log marginal and "
        f"ratios bit-equal {same}")
    check(same, "'checkpoint' differs from 'full' at 'high'")
    del out
    with counted(launches):
        again = m.decode_latent(y)
    same = all(torch.equal(v, again[k]) if torch.is_tensor(v)
               else v == again[k] for k, v in first.items())
    log(f"precision (g) back at 'highest': the first decode's bits {same}")
    check(same, "'highest' after the lower levels differs from before")
    return times


def _prec_pipeline_widths(launches):
    """(h) The pipeline session's widths, N = 490 and L = 101, whose rows
    TMA refuses: ``decode_latent`` at T = T_LONG and a 2-iteration fit at
    each lower level, through ``bf16_gemm``'s cp.async variant (counted),
    the log marginal within PREC_DECODE_RTOL of 'highest'."""
    N, L = PREC_PIPE
    _, params, y = _decode_setup(N, L, T_LONG)
    ref = None
    for lvl in ("highest",) + PREC_LEVELS:
        m = _model(N, L, "auto", params)  # the fit moves its parameters
        before = dict(launches)
        with matmul_precision(lvl), counted(launches):
            res = m.decode_latent(y)
            em = m.fit_em(y, n_iter=2, verboase=False)
        _check_decode(res, T_LONG, L)
        lmf = float(res["log_marginal_final"])
        ref = lmf if ref is None else ref
        rel = abs(lmf - ref) / abs(ref)
        key = f"bf16_gemm[{lvl}/cp_async]"
        n_cp = launches.get(key, 0) - before.get(key, 0)
        log(f"precision (h) N={N} L={L} T={T_LONG} at '{lvl}': decode "
            f"log_marginal_final rel to 'highest' {rel:.2e}; a 2-iteration "
            f"fit log_marginal_l {[float(v) for v in em['log_marginal_l']]}; "
            f"bf16_gemm cp.async launches {n_cp}")
        check(np.all(np.isfinite([float(v) for v in em["log_marginal_l"]])),
              (lvl, "non-finite fit"))
        if lvl != "highest":
            check(n_cp > 0, (lvl, "no cp.async launch at N=490, L=101"))
            check(rel <= PREC_DECODE_RTOL[lvl], (lvl, "pipeline widths", rel))
        del res, em, m
    del y


def _prec_northstar(launches):
    """(e) The north-star lean fit at each level, PREC_NS_ITERS
    iterations: s/EM-iter; 'high' log_marginal_l within PREC_NS_RTOL of
    'highest', 'default' measured."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D

    y = _ns_spikes()
    kw = dict(output_mode="lean", save_every=10**9, verboase=False,
              n_iter=PREC_NS_ITERS)
    lml, secs = {}, {}
    for lvl in ("highest",) + PREC_LEVELS:
        m = PoissonGPLVMJump1D(NS_N, n_latent_bin=NS_L, movement_variance=1,
                               tuning_lengthscale=10.0, device="cuda")
        before = dict(launches)
        with matmul_precision(lvl), counted(launches):
            sec, em = wall_s(lambda: m.fit_em(y, **kw))
        n_gemm = launches.get(f"bf16_gemm[{lvl}]", 0) - before.get(
            f"bf16_gemm[{lvl}]", 0)
        lml[lvl] = np.array([float(v) for v in em["log_marginal_l"]])
        secs[lvl] = sec / PREC_NS_ITERS
        check(np.all(np.isfinite(lml[lvl])), (lvl, lml[lvl]))
        rel = np.abs(lml[lvl] - lml["highest"]) / np.abs(lml["highest"])
        log(f"precision (e) north-star lean fit T={NS_T} L=N={NS_L} at "
            f"'{lvl}': {secs[lvl]:.3f} s/EM-iter over {PREC_NS_ITERS} "
            f"iterations ('highest' {secs['highest']:.3f}); Adam iterations "
            f"{em['m_step_res_l']['n_iter']}; bf16_gemm launches {n_gemm}; "
            f"log_marginal_l {lml[lvl].tolist()}, rel to 'highest' "
            f"{rel.tolist()} ({card_line()})")
        check(lvl == "highest" or n_gemm > 0, (lvl, "no bf16_gemm launch"))
        if lvl == "high":
            check(float(rel.max()) <= PREC_NS_RTOL, ("north-star high", rel))
        del em
    return secs


def _prec_gaussian(launches):
    """(f) A GaussianGPLVMJump1D decode at T = PREC_GAUSS_T, N = L = 500
    at each level against 'highest', recorded (the expansion cancels, so
    one bf16 pass loses most of it, as on the TPU)."""
    m = _family_model("GaussianGPLVMJump1D", 500, 500, "auto", seed=1503)
    y, _ = _family_data(m, PREC_GAUSS_T, 1504)
    ref = None
    for lvl in ("highest",) + PREC_LEVELS:
        with matmul_precision(lvl), counted(launches):
            res = m.decode_latent(y)
        check(all(bool(torch.isfinite(v).all()) for v in res.values()
                  if torch.is_tensor(v)), (lvl, "non-finite Gaussian decode"))
        if ref is None:
            ref = res
            continue
        rel = abs(float(res["log_marginal_final"])
                  - float(ref["log_marginal_final"])) / abs(
                      float(ref["log_marginal_final"]))
        err = float((res["posterior_latent_marg"]
                     - ref["posterior_latent_marg"]).abs().max())
        log(f"precision (f) Gaussian jump decode T={PREC_GAUSS_T} N=L=500 at "
            f"'{lvl}' vs 'highest': log_marginal_final rel {rel:.3e}, max "
            f"|latent marginal - highest| {err:.3e}")
        del res
    del y, ref


def phase_precision(launches):
    """The lower levels of ``set_matmul_precision`` on the card: (a)-(c)
    ``bf16_gemm`` against its plain version on the main path's products,
    with its controls, row independence and its two variants; (d) and (g)
    the decode at each level; (h) the pipeline's widths through the
    cp.async variant; (e) the north-star lean fit at each level; (f) a
    Gaussian decode.  Returns the kernels line's rows of ``bf16_gemm``."""
    t0 = time.perf_counter()
    rows = {}
    _prec_kernel(rows)
    dec_ms = _prec_decode(launches)
    _prec_pipeline_widths(launches)
    ns = _prec_northstar(launches)
    _prec_gaussian(launches)
    for lvl in PREC_LEVELS:
        by_variant = {v: launches.get(f"bf16_gemm[{lvl}/{v}]", 0)
                      for v in ("tma", "cp_async")}
        log(f"precision: bf16_gemm[{lvl}] main-path launches by variant "
            f"{by_variant}")
        check(all(by_variant.values()), (lvl, "a variant never launched",
                                         by_variant))
        rows[f"bf16_gemm[{lvl}]"]["launches_by_variant"] = by_variant
        rows[f"bf16_gemm[{lvl}]"].update({
            f"decode_ms_T{T_LONG}": dec_ms[lvl],
            f"decode_ms_T{T_LONG}_highest": dec_ms["highest"],
            "northstar_s_per_em_iter": ns[lvl],
            "northstar_s_per_em_iter_highest": ns["highest"]})
    log(f"precision phase {time.perf_counter() - t0:.1f} s ({card_line()})")
    return rows


def phase_families(launches):
    """The other three model classes through their entry points on the
    card (see ``_families_*``); returns the n_dyn = 1 launches and kernel
    rows for the kernels line."""
    ndyn1 = {}
    _families_gaussian_ll()
    _families_decode(launches, ndyn1)
    _families_fit(launches, ndyn1)
    _families_lean(launches, ndyn1)
    _ns_spikes.cache_clear()
    _families_log()
    _families_isolated(launches, ndyn1)
    m = _family_model("GaussianGPLVMJump1D", 100, 100, "auto", seed=17)
    y, _ = _family_data(m, EPOCH_CELLS[0][1], 18)
    _epochs_cell(m, _family_model("GaussianGPLVMJump1D", 100, 100, "prob",
                                  seed=17), y, EPOCH_CELLS[0], launches)
    del y
    rows = {}
    for L in (100, 500):
        m = _family_model("PoissonGPLVM1D", L, L, "auto", seed=900 + L)
        y, _ = _family_data(m, T_LONG, 901 + L)
        rows[L] = _ndyn1_kernel_rows(m, y)
        del y
    log(f"families: n_dyn=1 launches on the main paths {ndyn1}")
    check(all(ndyn1.get(k, 0) > 0 for k in (
        "filter_scan", "smoother_scan", "pfilter_pass", "psmooth_pass")),
        f"K1-K4 not all launched at n_dyn=1 from a model: {ndyn1}")
    return ndyn1, rows


#: gaussian_loglik (f32, matmul form) against the float64 sum of the normal
#: log-densities: max |difference| over max |log-likelihood|, the
#: max-normalised relative error the CPU tests hold log keys to (1e-5)
GAUSS_LL_RTOL = 1e-5


def _families_gaussian_ll(T=2_000, N=500, L=500, rows=200):
    """``gaussian_loglik`` on the card at N = L = 500 (scalar and
    per-neuron ``noise_std``) against the float64 direct evaluation,
    sum_n log N(y | mu, s), in blocks of ``rows`` bins; with TF32 on (the
    control) the expansion's cancellation must break the limit."""
    from poor_man_gplvm_tpu_torch.ops.emissions import gaussian_loglik

    m = _family_model("GaussianGPLVM1D", N, L, "auto", seed=1000)
    y, _ = _family_data(m, T, 1001)
    ones_n, ones_l = m.ma_neuron_default, m.ma_latent_default
    stds = {"scalar": m.noise_std, "per-neuron": torch.as_tensor(
        np.random.default_rng(1002).uniform(0.3, 1.0, m.n_neuron).astype(
            np.float32),
        device=y.device)}
    mu = m.tuning.double()
    for kind, std in stds.items():
        s64 = torch.as_tensor(std, dtype=torch.float64, device=y.device)
        direct = torch.cat([
            (-0.5 * ((y[a:a + rows, None, :].double() - mu) / s64) ** 2
             - torch.log(s64) - 0.5 * np.log(2 * np.pi)).sum(-1)
            for a in range(0, T, rows)])
        errs = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                ll = gaussian_loglik(y, m.tuning, std, ones_n, ones_l)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            gap = (ll.double() - direct).abs()
            top = direct.argmax(dim=1)
            at_top = gap[torch.arange(T, device=y.device), top] / direct[
                torch.arange(T, device=y.device), top].abs()
            errs[tf32] = (float(gap.max()) / float(direct.abs().max()),
                          float(gap.max()), float(at_top.max()))
        log(f"families gaussian_loglik N=L={L} T={T} noise_std {kind}: vs "
            f"float64 direct, max |diff| {errs[False][1]:.3e} "
            f"({errs[False][0]:.2e} of max |ll|, limit {GAUSS_LL_RTOL:.0e}; "
            f"{errs[False][2]:.2e} relative at each bin's most likely "
            f"state); TF32 on (control) {errs[True][1]:.3e} "
            f"({errs[True][0]:.2e}; {errs[True][2]:.2e})")
        check(errs[False][0] <= GAUSS_LL_RTOL, (kind, errs[False]))
        check(errs[True][0] > GAUSS_LL_RTOL,
              f"TF32 control passed: {errs[True]}")
    del y, direct


def _families_decode(launches, ndyn1):
    """Each class: decode_latent at T=1e5, N = L = 500 through 'auto' (the
    parallel engine), bit for bit against the sequential engine (the
    posteriors and the log marginal; every key's gap printed); at T=1e4,
    N = L = 100 against 'prob'; a latent-only decode below the parallel
    threshold (K1/K2 at n_dyn=1)."""
    from poor_man_gplvm_tpu_torch.ops import hmm

    for k, name in enumerate(FAMILIES):
        into = (launches, ndyn1) if "Jump" not in name else (launches,)
        for L, T in ((500, T_LONG), (100, T_DECODE)):
            m = _family_model(name, L, L, "auto", seed=100 + k + L)
            y, _ = _family_data(m, T, 200 + k + L)
            m.decode_latent(y[:T_GRID])  # warm-up
            with counted_into(*into):
                sec, res = wall_s(lambda: m.decode_latent(y))
            post = res["posterior_all"]
            row_err = _row_sum_err(post)
            check(all(bool(torch.isfinite(v).all()) for v in res.values()
                      if torch.is_tensor(v)) and row_err <= 1e-4,
                  (name, L, row_err))
            if L == 500:
                with sequential_engine():
                    seq_sec, ref = wall_s(lambda: m.decode_latent(y))
                gaps = _max_key_diff(res, ref)
                lmf_gap = abs(res["log_marginal_final"]
                              - ref["log_marginal_final"])
                log(f"families decode {name} T={T} N=L={L}: 'auto' (parallel)"
                    f" {1e3 * sec:.1f} ms, sequential {1e3 * seq_sec:.1f} ms;"
                    f" log_marginal_final {res['log_marginal_final']!r}, gap "
                    f"to sequential {lmf_gap!r}; max |diff| by key {gaps}; "
                    f"row-sum err {row_err:.1e}")
                check(lmf_gap == 0.0 and gaps["posterior_all"] == 0.0
                      and gaps["log_posterior_all"] == 0.0,
                      f"{name}: parallel and sequential engines differ")
            else:
                m_prob = _family_model(name, L, L, "prob", seed=100 + k + L)
                prob_sec, ref = wall_s(lambda: m_prob.decode_latent(y))
                rel = abs(res["log_marginal_final"]
                          - ref["log_marginal_final"]) / abs(
                              ref["log_marginal_final"])
                post_err = float((post - ref["posterior_all"]).abs().max())
                log(f"families decode {name} T={T} N=L={L}: 'auto' "
                    f"{1e3 * sec:.1f} ms, 'prob' {1e3 * prob_sec:.1f} ms; "
                    f"log_marginal_final rel {rel:.2e}, max |post - prob| "
                    f"{post_err:.2e}; row-sum err {row_err:.1e}")
                check(rel <= DECODE_LMF_RTOL and post_err <= DECODE_POST_ATOL,
                      (name, rel, post_err))
                if "Jump" not in name:  # below the threshold: K1/K2
                    T_short = hmm._PARALLEL_UPGRADE_MIN_T - 1
                    with counted_into(*into):
                        short = m.decode_latent(y[:T_short])
                    ref_s = m_prob.decode_latent(y[:T_short])
                    rel_s = abs(short["log_marginal_final"]
                                - ref_s["log_marginal_final"]) / abs(
                                    ref_s["log_marginal_final"])
                    log(f"families decode {name} T={T_short} N=L={L} "
                        f"(K1/K2): log_marginal_final rel {rel_s:.2e} vs prob")
                    check(rel_s <= DECODE_LMF_RTOL, rel_s)
            del res, post, y


def _fit_lml(em):
    lml = [float(v) for v in em["log_marginal_l"]]
    check(all(np.isfinite(lml)), lml)
    return lml


def _families_fit(launches, ndyn1):
    """Each class: fit_em at T=1e5, N = L = 100, FIT_ITERS iterations on
    the fused schedule ('auto'), log_marginal_l finite and non-decreasing
    up to 1e-6, the saved first posterior readable; FIT_CMP_ITERS
    iterations against a sequential-engine fit (the Poisson M-step capped
    at FIT_CMP_MAXITER Adam iterations) within FIT_LML_RTOL.  The data
    follow a random walk through another model's tuning curves, and each
    fit starts from the walk's labels (``initializers.init_with_label_1D``):
    from a random posterior a latent-only model's EM must find the walk
    itself, and its probability-space posteriors then leave the exact
    trajectory (ROADMAP section 3)."""
    from poor_man_gplvm_tpu_torch.initializers import init_with_label_1D

    N = L = FAM_FIT_NL
    for k, name in enumerate(FAMILIES):
        into = (launches, ndyn1) if "Jump" not in name else (launches,)
        cap = {"m_step_maxiter": FIT_CMP_MAXITER} if "Poisson" in name else {}
        gen = _family_model(name, N, L, "prob", seed=300 + k)
        y, lat = _family_data(gen, T_LONG, 400 + k)
        lpi = init_with_label_1D(lat, L)

        def fit(n_iter, **kw):
            return _family_model(name, N, L, "auto").fit_em(
                y, n_iter=n_iter, verboase=False, log_posterior_init=lpi,
                **kw)

        fit(3, **cap)  # warm-up
        with counted_into(*into):
            sec, em = wall_s(lambda: fit(FIT_ITERS))
        lml = _fit_lml(em)
        drops = [(a - b) / abs(a) for a, b in zip(lml, lml[1:])]
        adam = em["m_step_res_l"].get("n_iter", [])
        # the first iteration's posterior stays readable after the fit (the
        # JAX package guards a buffer-donation trap there)
        saved = em["log_posterior_all_saved"][0]
        check(saved.shape[0] == T_LONG and bool(torch.isfinite(saved).all())
              and _row_sum_err(torch.exp(saved)) <= 1e-4, name)
        par = fit(FIT_CMP_ITERS, **cap)
        with sequential_engine():
            seq_sec, seq = wall_s(lambda: fit(FIT_CMP_ITERS, **cap))
        rel = np.abs(np.subtract(_fit_lml(par), _fit_lml(seq))) / np.abs(
            _fit_lml(seq))
        log(f"families fit {name} T={T_LONG} N=L={L}: {sec / FIT_ITERS:.4f} "
            f"s/EM-iter over {FIT_ITERS} iterations (fused schedule); "
            f"log_marginal_l {lml}; largest relative decrease "
            f"{max(drops):.2e}; M-step "
            f"Adam iterations {adam}; {FIT_CMP_ITERS} iterations vs the "
            f"sequential engine ({seq_sec:.2f} s): rel {rel.tolist()}")
        check(max(drops) <= 1e-6, f"{name}: log_marginal_l decreased {lml}")
        check(float(rel.max()) <= FIT_LML_RTOL, (name, rel))
        del y


def _families_lean(launches, ndyn1):
    """PoissonGPLVM1D lean at the north-star shape, T=1e6, L = N = 500,
    FAM_LEAN_ITERS iterations: work T L^2 = 2.5e11 passes the warm-start
    gate, so K3/K4 run warm at n_dyn=1; fused against fused=False (Adam
    capped at NS_CMP_MAXITER) within FIT_LML_RTOL, lean rows summing to 1,
    the peak memory."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVM1D

    y = _ns_spikes()
    kw = dict(output_mode="lean", save_every=10**9, verboase=False,
              n_iter=FAM_LEAN_ITERS, m_step_maxiter=NS_CMP_MAXITER)

    def model():
        return PoissonGPLVM1D(NS_N, n_latent_bin=NS_L, movement_variance=1,
                              tuning_lengthscale=10.0, device="cuda")

    # fused=False first: the reference, and the warm-up of the timed fit
    l_sec, loop = wall_s(lambda: model().fit_em(y, fused=False, **kw))
    b = _fit_lml(loop)
    del loop
    torch.cuda.reset_peak_memory_stats()
    m = model()
    with counted_into(launches, ndyn1):
        f_sec, fused = wall_s(lambda: m.fit_em(y, fused=True, **kw))
    peak = torch.cuda.max_memory_allocated() / 1e9
    a = _fit_lml(fused)
    rel = np.abs(np.subtract(a, b)) / np.abs(b)
    post = fused["posterior"]
    row_err = float((post.sum(dim=1) - 1).abs().max())
    passes = getattr(m, "_scan_passes_mid", None)
    log(f"families lean PoissonGPLVM1D T={NS_T} L=N={NS_L}: fused {f_sec:.1f}"
        f" s ({f_sec / FAM_LEAN_ITERS:.3f} s/EM-iter), fused=False (run "
        f"first) {l_sec:.1f} s; log_marginal_l {a}; rel {rel.tolist()}; "
        f"warm-started passes per middle iteration "
        f"{None if passes is None else passes.tolist()}; peak memory "
        f"{peak:.2f} GB (the spikes' 2 GB included); row-sum err "
        f"{row_err:.1e}")
    check(post.shape == (NS_T, NS_L) and fused["log_posterior_final"] is None
          and row_err <= 1e-4 and float(rel.max()) <= FIT_LML_RTOL
          and passes is not None, (post.shape, row_err, rel, passes))
    del fused, post


def _families_log():
    """engine='log' (a plain loop, asked for by name) against 'prob' at
    T = FAM_LOG_T, N = L = 100, for a latent-only and a jump class."""
    N = L = 100
    for k, name in enumerate(FAM_LOG_CLASSES):
        m = _family_model(name, N, L, "log", seed=500 + k)
        y, _ = _family_data(m, FAM_LOG_T, 600 + k)
        sec, res = wall_s(lambda: m.decode_latent(y))
        p_sec, ref = wall_s(lambda: _family_model(
            name, N, L, "prob", seed=500 + k).decode_latent(y))
        rel = abs(res["log_marginal_final"] - ref["log_marginal_final"]) / abs(
            ref["log_marginal_final"])
        post_err = float((res["posterior_all"]
                          - ref["posterior_all"]).abs().max())
        log(f"families engine='log' {name} T={FAM_LOG_T} N=L={L}: "
            f"{sec:.2f} s ('prob' {p_sec:.2f} s); log_marginal_final rel "
            f"{rel:.2e}, max |post - prob| {post_err:.2e}")
        check(rel <= DECODE_LMF_RTOL and post_err <= DECODE_POST_ATOL,
              (name, rel, post_err))


def _families_isolated(launches, ndyn1):
    """PoissonGPLVM1D with the rbf-plus-isolated tuning and transition
    kernels (row 0 uniform, column 0 ``p_to_isolated``: no band narrower
    than L) at T=1e5, N = L in {100, 500}: 'auto' bit for bit against the
    sequential engine, with the band width and the times."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops.band import transition_band
    from poor_man_gplvm_tpu_torch.ops.kernels import (
        get_custom_kernel_rbf_plus_isolated,
    )

    for L in (100, 500):
        tun_k, tr_k = get_custom_kernel_rbf_plus_isolated(
            torch.arange(L), 10.0, 1.0)
        m = _family_model("PoissonGPLVM1D", L, L, "auto", seed=700 + L,
                          custom_tuning_kernel=tun_k,
                          custom_transition_kernel=tr_k)
        y, _ = _family_data(m, T_LONG, 800 + L, lo=1)
        trans = m._make_transition({})[0]
        tlat = hmm._transition_stack(trans)[0].contiguous()
        W = transition_band(tlat, tlat.transpose(-1, -2).contiguous(),
                            trans.uniform_rows).W
        m.decode_latent(y[:T_GRID])  # warm-up
        with counted_into(launches, ndyn1):
            sec, res = wall_s(lambda: m.decode_latent(y))
        with sequential_engine():
            seq_sec, ref = wall_s(lambda: m.decode_latent(y))
        gaps = _max_key_diff(res, ref)
        lmf_gap = abs(res["log_marginal_final"] - ref["log_marginal_final"])
        row_err = _row_sum_err(res["posterior_all"])
        log(f"families rbf-plus-isolated PoissonGPLVM1D T={T_LONG} N=L={L}: "
            f"band W={W}; 'auto' (parallel) {1e3 * sec:.1f} ms, sequential "
            f"{1e3 * seq_sec:.1f} ms; log_marginal_final gap {lmf_gap!r}; "
            f"max |diff| by key {gaps}; row-sum err {row_err:.1e}")
        check(W == m.n_latent_bin and lmf_gap == 0.0
              and gaps["posterior_all"] == 0.0
              and row_err <= 1e-4, (L, W, lmf_gap, gaps, row_err))
        del y, res, ref


def _ndyn1_kernel_rows(m, y):
    """K1/K2 at T = T_DECODE and K3/K4 (every mode, "highest") and
    joint_acc at T = T_LONG on a latent-only model's own inputs (its
    log-likelihoods of ``y``, its one RBF channel, n_dyn = 1): each held
    against its plain version (one call) and timed, with its bound."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.ops.band import transition_band
    from poor_man_gplvm_tpu_torch.ops.emissions import get_loglikelihood_ma_all
    from poor_man_gplvm_tpu_torch.testing import SCAN_TOLERANCES

    L = m.n_latent_bin
    trans = m._make_transition({})[0]
    tlat, tdyn = hmm._transition_stack(trans)
    flags = trans.uniform_rows
    ll = get_loglikelihood_ma_all(
        y, m.tuning, {}, torch.broadcast_to(m.ma_neuron_default, y.shape),
        m.ma_latent_default, observation_model=m.observation_model)
    p_init = torch.exp(trans.uniform_log_init())[None]
    tlat = tlat.contiguous()
    band = transition_band(tlat, tlat.transpose(-1, -2).contiguous(), flags)
    nnz = _nnz(tlat, flags)
    w = torch.exp(ll[:T_DECODE] - ll[:T_DECODE].amax(dim=1, keepdim=True))
    args_f = (w.contiguous(), tlat, tdyn, p_init, flags)
    post, prior, _ = sk.filter_scan(*args_f, band=band)
    args_s = (post[:-1].contiguous(), prior[1:].contiguous(),
              tlat.transpose(-1, -2).contiguous(), tdyn,
              post[-1].contiguous(), flags)
    rows = {}
    for name, kern, plain, args, key in (
            ("filter_scan", sk.filter_scan, sk.filter_scan_plain, args_f,
             "post_abs"),
            ("smoother_scan", sk.smoother_scan, sk.smoother_scan_plain,
             args_s, "smooth_abs")):
        want, plain_ms = timed_once(lambda: plain(*args))
        err = float((kern(*args, band=band)[0] - want[0]).abs().max())
        ms = cuda_ms(lambda: kern(*args, band=band), 5)
        b_ms, b_by = kernel_bound(name, T_DECODE, L, 1, nnz)
        log(f"time {name} L={L} T={T_DECODE} n_dyn=1 (band W={band.W}): "
            f"kernel {ms:.3f} ms ({1e3 * ms / T_DECODE:.3f} us/step), plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); max |kernel - "
            f"plain| {err:.3e}")
        check(err <= SCAN_TOLERANCES[key], (name, L, err))
        rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
    case = {"ll": ll, "tlat": tlat, "tdyn": tdyn, "p_init": p_init}
    rows.update(_pscan_timed(L, y.device, case=case, precs=("highest",),
                             extras=False))
    return rows


def _session_model():
    """The session's model (N = L = 500, random weights from numpy seed
    1000 carried in as a JAX model's state would be), a sampled recording
    of T_LONG bins as a TsdFrame on the bin times, and its spikes on the
    card."""
    from poor_man_gplvm_tpu_torch import TsdFrame

    N = L = SESSION_NL
    basis_rank = _model(N, L, "prob").tuning_basis.shape[1]
    params = np.random.default_rng(1000).normal(
        size=(basis_rank, N)).astype(np.float32)
    m = _model(N, L, "auto", params)
    _, y = m.sample(T_LONG, generator=torch.Generator().manual_seed(1001))
    y_np = y.cpu().numpy()
    return m, params, y, TsdFrame(d=y_np, t=np.arange(T_LONG) * SESSION_DT)


def _session_decode(m, y, y_tsdf, launches):
    """decode_latent on the TsdFrame (T_LONG bins through 'auto'),
    naive Bayes with t_l, _decode_latent from the model's own log matrices
    and from a dense latent channel."""
    from poor_man_gplvm_tpu_torch import TsdFrame
    from poor_man_gplvm_tpu_torch.ops import hmm

    t = y_tsdf.t
    L = m.n_latent_bin
    with counted(launches):
        res = m.decode_latent(y_tsdf)
        nb = m.decode_latent_naive_bayes(y, t_l=t)
    ref = m.decode_latent(y)
    for k in ("posterior_latent_marg", "posterior_dynamics_marg"):
        check(isinstance(res[k], TsdFrame) and np.array_equal(res[k].t, t)
              and np.array_equal(res[k].d, ref[k].cpu().numpy()),
              f"decode_latent(TsdFrame)[{k!r}] is not the unwrapped decode "
              "on the input's times")
    check(res["log_marginal_final"] == ref["log_marginal_final"]
          and torch.equal(res["posterior_all"], ref["posterior_all"]),
          "decode_latent(TsdFrame) differs from the unwrapped decode")
    _check_decode(ref, T_LONG, m.n_latent_bin)
    nb_post = nb["posterior_latent"]
    check(isinstance(nb_post, TsdFrame) and np.array_equal(nb_post.t, t)
          and np.array_equal(nb_post.d, torch.exp(
              nb["log_posterior_latent"]).cpu().numpy()),
          "decode_latent_naive_bayes(t_l=...)")
    ms = {}
    for _ in range(2):  # in turns: with bin times, without
        for key, fn in (("t_l", lambda: m.decode_latent(y, t_l=t)),
                        ("plain", lambda: m.decode_latent(y)[
                            "posterior_latent_marg"])):
            ms.setdefault(key, []).append(1e3 * wall_s(fn)[0])
    log(f"session decode T={T_LONG} N=L={L} through 'auto': TsdFrame keys "
        f"equal to the unwrapped decode on the input's times; "
        f"{min(ms['t_l']):.1f} ms with t_l (wrapped keys copied to the "
        f"host), {min(ms['plain']):.1f} ms without (best of 2, host clock); "
        f"naive Bayes with t_l wrapped, bit-equal")

    trans, attrs = m._make_transition({})
    lat, dyn = (attrs["log_latent_transition_kernel_l"],
                attrs["log_dynamics_transition_kernel"])
    with counted(launches):
        own = m._decode_latent(y, m.tuning, {}, lat, dyn, m.ma_neuron_default)
    post_err = float((torch.exp(own[0]) - ref["posterior_all"]).abs().max())
    lmf_rel = abs(float(own[1]) - ref["log_marginal_final"]) / abs(
        ref["log_marginal_final"])
    tlat_err = float((torch.exp(lat) - trans.Tlat).abs().max())
    log(f"session _decode_latent from the model's own log matrices: max "
        f"|post - decode_latent| {post_err:.3e}, log marginal rel "
        f"{lmf_rel:.3e} (exp(log Tlat) differs from Tlat by up to "
        f"{tlat_err:.3e}, so the bits differ; bit-equal: "
        f"{post_err == 0.0})")
    check(post_err <= DECODE_POST_ATOL and lmf_rel <= DECODE_LMF_RTOL,
          (post_err, lmf_rel))

    # a dense latent channel (not an RBF): the band is W = L
    dense = np.random.default_rng(1002).random((L, L)) + 0.05
    dense = np.log(dense / dense.sum(axis=1, keepdims=True))
    lat_dense = lat.clone()
    lat_dense[0] = torch.as_tensor(dense, dtype=torch.float32,
                                   device=m.device)
    y_d = y[:SESSION_T_DENSE]
    t_par, par = wall_s(lambda: m._decode_latent(
        y_d, m.tuning, {}, lat_dense, dyn, m.ma_neuron_default))
    with counted(launches):
        par = m._decode_latent(y_d, m.tuning, {}, lat_dense, dyn,
                               m.ma_neuron_default)
    with sequential_engine():
        t_seq, seq = wall_s(lambda: m._decode_latent(
            y_d, m.tuning, {}, lat_dense, dyn, m.ma_neuron_default))
    dense_trans = hmm.JointTransition(
        Tdyn=torch.exp(dyn), Tlat=torch.exp(lat_dense), logTdyn=dyn,
        logTlat=lat_dense)
    W = hmm._cached_band(dense_trans, dense_trans.Tlat).W
    rel = abs(float(par[1]) - float(seq[1])) / abs(float(seq[1]))
    log(f"session _decode_latent, dense latent channel (band W={W}), "
        f"T={SESSION_T_DENSE} N=L={L}: parallel (K3/K4) {1e3 * t_par:.1f} ms, "
        f"sequential (K1/K2) {1e3 * t_seq:.1f} ms (host clock); posteriors "
        f"bit-equal {torch.equal(par[0], seq[0])}, log marginal rel "
        f"{rel:.2e}")
    check(W == L and torch.equal(par[0], seq[0]) and rel <= DECODE_LMF_RTOL,
          ("dense _decode_latent", W, rel))


def _session_fit(m_fresh, y, launches):
    """fit_em at SESSION_T_FIT bins, checkpointed every iteration;
    interrupted after SESSION_RESUME_AT iterations and resumed, held
    against the uninterrupted checkpointed fit; a checkpoint's save timed
    and sized."""
    import os
    import shutil

    from poor_man_gplvm_tpu_torch.utils.checkpoint import EMCheckpointer

    mf = m_fresh()
    L = mf.n_latent_bin
    y_fit = y[:SESSION_T_FIT]
    init = np.random.default_rng(1003).random((SESSION_T_FIT, L)) * 0.1
    lpi = np.log(init / init.sum(axis=1, keepdims=True)).astype(np.float32)
    root = os.path.join("build", "session_checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(log_posterior_init=lpi, verboase=False)
    try:
        with counted(launches):
            sec, full = wall_s(lambda: mf.fit_em(
                y_fit, n_iter=SESSION_FIT_ITERS,
                checkpoint_dir=os.path.join(root, "full"), **kw))
        m_fresh().fit_em(y_fit, n_iter=SESSION_RESUME_AT,
                         checkpoint_dir=os.path.join(root, "cut"), **kw)
        with counted(launches):
            resumed = m_fresh().fit_em(
                y_fit, n_iter=SESSION_FIT_ITERS,
                checkpoint_dir=os.path.join(root, "cut"), resume=True, **kw)
        steps = EMCheckpointer(os.path.join(root, "cut")).all_steps()
        want = np.array([float(v) for v in
                         full["log_marginal_l"][SESSION_RESUME_AT:]])
        got = np.array([float(v) for v in resumed["log_marginal_l"]])
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        bits = all(torch.equal(resumed[k], full[k])
                   for k in ("params", "posterior"))
        check(steps == list(range(SESSION_FIT_ITERS)), steps)
        check(np.all(np.isfinite(got)) and rel <= SESSION_RESUME_RTOL,
              ("resumed fit", got, want))
        # one checkpoint's save: the state fit_em writes, from the card
        state = EMCheckpointer(os.path.join(root, "full")).restore()
        state = {k: (torch.as_tensor(v, device=mf.device)
                     if isinstance(v, np.ndarray) and k != "rng" else v)
                 for k, v in state.items()}
        timing = EMCheckpointer(os.path.join(root, "timing"))
        save_s = [wall_s(lambda: timing.save(i, state))[0]
                  for i in range(SESSION_SAVES)]
        mb = os.path.getsize(os.path.join(
            timing._step_path(0), "state.pkl")) / 2**20
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_adam = full["m_step_res_l"]["n_iter"]
    log(f"session fit T={SESSION_T_FIT} N=L={L}, checkpointed every "
        f"iteration: {sec / SESSION_FIT_ITERS:.4f} s/EM-iter over "
        f"{SESSION_FIT_ITERS} iterations (Adam iterations {list(n_adam)}); "
        f"interrupted after {SESSION_RESUME_AT} and resumed to "
        f"{SESSION_FIT_ITERS}: log_marginal_l {got.tolist()} vs "
        f"uninterrupted {want.tolist()} (rel {rel:.2e}; params and "
        f"posterior bit-equal: {bits}); a save {np.median(save_s):.4f} s "
        f"(median of {SESSION_SAVES}: {[round(x, 4) for x in save_s]}), "
        f"{mb:.1f} MB per save")


def _session_null(m, y_tsdf, launches):
    """The nulls at SESSION_T_NULL bins: test_one_model's dynamics null
    (batches of 16, its default), then shuffle_and_decode alone at every
    batch size of SESSION_BATCHES, equal to it; each dynamics batch one
    launch of K1 and one of K2; SESSION_ALONE shuffles against
    decode_latent alone; the first batch's K1/K2 against plain at the
    null's own length on its first SESSION_PLAIN_E shuffles; and
    test_one_model's naive-Bayes null.  Returns the
    kernels line's session rows."""
    import itertools

    from poor_man_gplvm_tpu_torch import TsdFrame, Tsd, validation
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import SCAN_TOLERANCES, _max_rel

    T, L = SESSION_T_NULL, m.n_latent_bin
    y_null = TsdFrame(d=y_tsdf.d[:T], t=y_tsdf.t[:T])
    seed = 1004

    def check_null(null, got, bs, what):
        n_batch = -(-SESSION_N_SHUFFLE // bs)
        check(got.get("filter_scan_batch") == n_batch
              and got.get("smoother_scan_batch") == n_batch,
              f"{what} in batches of {bs}: {got}")
        check(null["posterior_all"].shape == (SESSION_N_SHUFFLE, T, 2, L),
              null["posterior_all"].shape)
        nan = [k for k, v in null.items()
               if v is not None and not np.all(np.isfinite(v))]
        check(not nan, f"NaN or inf in the {what}: {nan}")
        return n_batch

    got = {}
    with counted_into(got, launches):
        sec, res = wall_s(lambda: validation.test_one_model(
            y_null, m, n_shuffle=SESSION_N_SHUFFLE, decoder_type="dynamics",
            seed=seed))
    first = res["decode_res_shuffle"]
    n_batch = check_null(first, got, 16, "test_one_model's dynamics null")
    check(isinstance(res["is_sig_tsd"], Tsd), type(res["is_sig_tsd"]))
    log(f"session null T={T} N=L={L}, {SESSION_N_SHUFFLE} shuffles: "
        f"test_one_model(decoder_type='dynamics') {sec:.3f} s, "
        f"{1e3 * sec / SESSION_N_SHUFFLE:.1f} ms per shuffle (the true "
        f"decode included; {n_batch} batches of 16, one K1 and one K2 "
        f"launch each: {got}); significant bins "
        f"{float(np.mean(res['is_sig_tsd'].d)):.3f}; no NaN")
    del res
    for bs in SESSION_BATCHES:
        got = {}
        with counted_into(got, launches):
            sec, null = wall_s(lambda: validation.shuffle_and_decode(
                m, y_null, n_shuffle=SESSION_N_SHUFFLE,
                decoder_type="dynamics", seed=seed, verbose=False,
                shuffle_batch_size=bs))
        n_batch = check_null(null, got, bs, "shuffle_and_decode")
        same = all(np.array_equal(null[k], first[k]) for k in first
                   if first[k] is not None)
        log(f"session null T={T} N=L={L}, {SESSION_N_SHUFFLE} shuffles, "
            f"shuffle_and_decode(shuffle_batch_size={bs}): {sec:.3f} s, "
            f"{1e3 * sec / SESSION_N_SHUFFLE:.1f} ms per shuffle ({n_batch} "
            f"batches, one K1 and one K2 launch each: {got}); every key "
            f"equal to test_one_model's null: {same}; no NaN")
        check(same, f"shuffle_batch_size={bs} changes the null")
        del null

    # SESSION_ALONE shuffles against decode_latent on each alone (K1/K2)
    null = first
    shuffles = list(itertools.islice(validation.circular_shuffle_data(
        y_null, n_shuffle=SESSION_BATCHES[0], seed=seed),
        SESSION_BATCHES[0]))
    for s in range(SESSION_ALONE):
        with sequential_engine():
            alone = m.decode_latent(shuffles[s], n_time_per_chunk=10000)
        diff = {k: float(np.abs(null[k][s] - (
            v.cpu().numpy() if torch.is_tensor(v) else np.float32(v))).max())
                for k, v in alone.items()}
        log(f"session null shuffle {s} against decode_latent alone "
            f"(K1/K2): max |difference| per key {diff}")
        check(all(v == 0.0 for v in diff.values()),
              f"shuffle {s} differs from decode_latent alone: {diff}")
    del first, null

    # the first batch's K1/K2, launched and timed over the whole batch at
    # its full length, held against their plain versions on its first
    # SESSION_PLAIN_E shuffles' own log-likelihood rows
    trans, _ = m._make_transition({})
    E, P = SESSION_BATCHES[0], SESSION_PLAIN_E
    y_b = torch.as_tensor(np.stack(shuffles), device=m.device)
    ll = hmm.sequence_loglikelihoods(
        y_b, m.tuning, {}, m.ma_neuron_default, m.ma_latent_default, 10000)
    del y_b
    w, _ = sk._weights(ll, 1.0)
    band = hmm._cached_band(trans, trans.Tlat)
    tlat_t = trans.Tlat.transpose(-1, -2).contiguous()
    flags = trans.uniform_rows
    p_init = torch.exp(trans.uniform_log_init())[None].expand(
        E, 2, L).contiguous()
    lengths = torch.full((E,), T, dtype=torch.int32, device=m.device)
    nnz = _nnz(trans.Tlat, flags)
    k1 = lambda: sk.filter_scan_batch(  # noqa: E731
        w, trans.Tlat, trans.Tdyn, p_init, lengths, flags, band=band)
    post, prior, norm = k1()
    want, plain1 = timed_once(lambda: sk.filter_scan_batch_plain(
        w[:P], trans.Tlat, trans.Tdyn, p_init[:P], lengths[:P], flags))
    err1 = max(float((a[:P] - b).abs().max())
               for a, b in zip((post, prior), want[:2]))
    last = post[:, -1].contiguous()
    k2 = lambda: sk.smoother_scan_batch(  # noqa: E731
        post[:, :-1], prior[:, 1:], tlat_t, trans.Tdyn, last, lengths - 1,
        flags, band=band)
    smooth, r = k2()
    want2, plain2 = timed_once(lambda: sk.smoother_scan_batch_plain(
        want[0][:, :-1], want[1][:, 1:], tlat_t, trans.Tdyn,
        want[0][:, -1].contiguous(), lengths[:P] - 1, flags))
    err2 = float((smooth[:P] - want2[0]).abs().max())
    nxt = torch.cat([smooth[:P, 1:], last[:P, None]], dim=1)
    where = (prior[:P, 1:] > 1e-30) & (nxt > 1e-30)
    r_rel = _max_rel(r[:P], want2[1], where)
    finite = all(bool(torch.isfinite(x).all())
                 for x in (post, prior, norm, smooth, r))
    check(err1 <= SCAN_TOLERANCES["post_abs"]
          and err2 <= SCAN_TOLERANCES["smooth_abs"]
          and r_rel <= SCAN_TOLERANCES["r_rel"] and finite,
          ("the null's first batch against plain", err1, err2, r_rel))
    rows = {}
    for name, kern, err, plain_ms, steps in (
            ("filter_scan_batch", k1, err1, plain1, E * T),
            ("smoother_scan_batch", k2, err2, plain2, E * (T - 1))):
        ms = cuda_ms(kern, 5)
        b_ms, b_by = kernel_bound(name, steps, L, 2, nnz)
        rows[name] = dict(E=E, steps=steps, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, plain_E=P, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
        log(f"time {name} on the null's first batch (E={E} shuffles of "
            f"{T} bins, L={L}, {steps} steps in all): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms on its first {P} "
            f"shuffles, bound {b_ms:.4f} ms ({b_by}); max |kernel - plain| "
            f"{err:.3e} on those {P}"
            + (f", r rel {r_rel:.2e}" if name.startswith("smoother") else ""))
    del w, post, prior, smooth, r, want, want2, nxt, where, ll

    with counted(launches):
        sec, nb = wall_s(lambda: validation.test_one_model(
            y_null, m, n_shuffle=SESSION_NB_SHUFFLE,
            decoder_type="naive_bayes", seed=seed + 1))
    nb_null = nb["decode_res_shuffle"]
    nan = [k for k, v in nb_null.items() if not np.all(np.isfinite(v))]
    check(not nan and nb_null["posterior_latent"].shape == (
        SESSION_NB_SHUFFLE, T, L), ("naive-Bayes null", nan))
    log(f"session naive-Bayes null T={T} N=L={L}, {SESSION_NB_SHUFFLE} "
        f"shuffles in batches of 16: test_one_model {sec:.3f} s, "
        f"{1e3 * sec / SESSION_NB_SHUFFLE:.1f} ms per shuffle; significant "
        f"bins {float(np.mean(nb['is_sig_tsd'].d)):.3f}; no NaN")
    return rows


def phase_session(launches):
    """The session workflow at N = L = 500 on a sampled recording in a
    TsdFrame: decode with bin times, a checkpointed fit resumed, and the
    circular-shuffle nulls (see ``_session_*``).  Returns the kernels
    line's rows of the batched K1/K2 on the null's first batch."""
    m, params, y, y_tsdf = _session_model()
    _session_decode(m, y, y_tsdf, launches)
    _session_fit(lambda: _model(m.n_neuron, m.n_latent_bin, "auto", params),
                 y, launches)
    return _session_null(m, y_tsdf, launches)


# ---------------------------------------------------------------------------
# selection: sweeps and model selection (parallel/sweep.py, selection.py)
# ---------------------------------------------------------------------------


def _sel_data():
    """SEL_T bins sampled with the port's own sampler, on the card, from a
    model at N = L = 500 with random weights (numpy seed 1100, carried in
    as a JAX model's state would be)."""
    N = L = SEL_NL
    basis_rank = _model(N, L, "prob").tuning_basis.shape[1]
    params = np.random.default_rng(1100).normal(
        size=(basis_rank, N)).astype(np.float32)
    m = _model(N, L, "auto", params)
    return m.sample(SEL_T, generator=torch.Generator().manual_seed(1101))[1]


@contextlib.contextmanager
def stage_timer(times, *targets):
    """Add the host seconds of every call of each (module, name) in
    ``targets``, each ending in a device synchronise, to ``times[name]``
    while the block runs."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def timed(*a, **kw):
            sec, out = wall_s(lambda: fn(*a, **kw))
            times[name] = times.get(name, 0.0) + sec
            return out
        return timed

    for mod, name, fn in saved:
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _cfg_bound(nnz_per_seq, cfg, band, n_dyn, T, L, rows):
    """The bound of one config-indexed K1 (``rows``: "k1", "norm") or K2
    ("k2") launch over sequences of T rows, sequence e under configuration
    ``cfg[e]`` of ``band``, its non-constant channels holding
    ``nnz_per_seq[e]`` nonzeros: the weights (or K2's posteriors and
    priors) and the configuration index, what each configuration in use
    gives the kernel (its band half, W x L values and L window starts for
    each non-constant channel, the constant channels' first row, and
    Tdyn), and what the launch stores; 2 nnz f32 operations per step of
    each sequence."""
    f4 = 4.0
    E = len(nnz_per_seq)
    G = int(torch.unique(cfg).numel())
    n_mat = band.mats.shape[-3]
    per_cfg = (n_mat * (band.W * L + L) + (n_dyn - n_mat) * L
               + n_dyn * n_dyn) * f4
    state = E * T * n_dyn * L * f4
    ins = G * per_cfg + E * f4
    ops = sum(T * 2.0 * n for n in nnz_per_seq) / F32_FLOP_PER_S
    if rows == "k1":
        return bound(E * T * L * f4 + ins + 2 * state + E * T * f4, ops)
    if rows == "norm":
        return bound(E * T * L * f4 + ins + E * T * f4, ops)
    return bound(4 * state + ins, ops)


def _sweep_rows_vs_single(y, res, launches):
    """Every run of the sweep ``res``: its E-step on its final tuning, one
    config-indexed K1 and K2 launch for all runs on the sweep's own
    log-likelihoods (``sweep._runs_loglik``), against the unbatched
    kernels under the run's own configuration and its own band, bit for
    bit."""
    from poor_man_gplvm_tpu_torch.ops import band as bd
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.ops.emissions import poisson_lgamma_term
    from poor_man_gplvm_tpu_torch.parallel import sweep

    grid = res["grid"]
    B = len(res["config_index"])
    hps = [{k: float(v[i]) for k, v in grid.items()
            if k != "tuning_lengthscale"} for i in range(B)]
    stack, cfg = sweep._transition_stack("poisson", hps, SEL_NL, y.device)
    ll = sweep._runs_loglik(y, res["tuning"], hps, "poisson",
                            poisson_lgamma_term(y, torch.ones_like(y)))
    T = y.shape[0]
    lengths = torch.full((B,), T, dtype=torch.int32, device=y.device)
    flags = stack.uniform_rows
    band = hmm._cached_band(stack, stack.Tlat)
    # the E-step's two launches (hmm._scan_batch), keeping the priors
    post, prior, _ = sk.filter_chunk_batch(
        ll, stack.Tlat, stack.Tdyn,
        torch.exp(stack.uniform_log_init())[None].expand(B, 2, SEL_NL),
        lengths, 1.0, uniform_rows=flags, band=band, cfg=cfg)
    last = post[:, -1].contiguous()
    smooth, r = sk.smoother_chunk_batch(
        post[:, :-1], prior[:, 1:], stack.Tlat, stack.Tdyn, last,
        lengths - 1, uniform_rows=flags, band=band, cfg=cfg)
    equal = True
    for b in range(B):
        g = int(cfg[b])
        tlat, tdyn = stack.Tlat[g], stack.Tdyn[g]
        own = bd.transition_band(tlat, tlat.transpose(-1, -2).contiguous(),
                                 flags)
        p0 = torch.exp(stack.uniform_log_init())
        f_post, f_prior, _ = sk.filter_chunk(ll[b], tlat, tdyn, p0, 1.0,
                                             uniform_rows=flags, band=own)
        s_sm, s_r = sk.smoother_chunk(post[b, :-1], prior[b, 1:], tlat, tdyn,
                                      last[b], uniform_rows=flags, band=own)
        equal &= (torch.equal(f_post, post[b]) and torch.equal(
            f_prior, prior[b]) and torch.equal(s_sm, smooth[b])
            and torch.equal(s_r, r[b]))
    log(f"selection (a): all {B} runs' E-step rows (one config-indexed K1 "
        f"and K2 launch, bands padded to W={getattr(band, 'W', None)}) "
        f"against the unbatched kernels under each run's own configuration "
        f"and band: bit-equal {equal}")
    check(equal, "config-indexed K1/K2 rows differ from the run alone")
    return ll, stack, cfg


def _sel_kernel_rows(ll, stack, cfg):
    """The config-indexed K1/K2 and the norm-only K1 against their plain
    versions on the sweep's first batch cut to SWEEP_PLAIN (runs per band
    width, at the sweep's full length); the kernels line's rows."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import SCAN_TOLERANCES, _max_rel

    per_w, T = SWEEP_PLAIN
    movement = SWEEP_GRID["movement_variance"]
    n_pj = len(SWEEP_GRID["p_move_to_jump"]) * SWEEP_KW["n_repeat"]
    pick = [i * n_pj + j for i in range(len(movement)) for j in range(per_w)]
    idx = torch.as_tensor(pick, device=ll.device)
    w, _ = sk._weights(ll[idx, :T].contiguous(), 1.0)
    c = cfg[idx].contiguous()
    E, L = len(pick), SEL_NL
    flags = stack.uniform_rows
    band = hmm._cached_band(stack, stack.Tlat)
    tlat_t = stack.Tlat.transpose(-1, -2).contiguous()
    p0 = torch.exp(stack.uniform_log_init())[None].expand(E, 2, L) \
        .contiguous()
    lengths = torch.full((E,), T, dtype=torch.int32, device=ll.device)
    nnz = [_nnz(stack.Tlat[int(g)], flags) for g in c.tolist()]
    k1 = lambda: sk.filter_scan_batch(  # noqa: E731
        w, stack.Tlat, stack.Tdyn, p0, lengths, flags, band=band, cfg=c)
    kn = lambda: sk.filter_scan_batch(  # noqa: E731
        w, stack.Tlat, stack.Tdyn, p0, lengths, flags, band=band, cfg=c,
        norm_only=True)
    post, prior, norm = k1()
    norm_only = kn()[2]
    want, plain1 = timed_once(lambda: sk.filter_scan_batch_plain(
        w, stack.Tlat, stack.Tdyn, p0, lengths, flags, cfg=c))
    err1 = max(float((a - b).abs().max()) for a, b in zip((post, prior),
                                                         want[:2]))
    errn = float((norm_only - want[2]).abs().max())
    reln = float(((norm_only - want[2]).abs() / want[2]).max())
    last = post[:, -1].contiguous()
    k2 = lambda: sk.smoother_scan_batch(  # noqa: E731
        post[:, :-1], prior[:, 1:], tlat_t, stack.Tdyn, last, lengths - 1,
        flags, band=band, cfg=c)
    smooth, r = k2()
    want2, plain2 = timed_once(lambda: sk.smoother_scan_batch_plain(
        want[0][:, :-1], want[1][:, 1:], tlat_t, stack.Tdyn,
        want[0][:, -1].contiguous(), lengths - 1, flags, cfg=c))
    err2 = float((smooth - want2[0]).abs().max())
    nxt = torch.cat([smooth[:, 1:], last[:, None]], dim=1)
    r_rel = _max_rel(r, want2[1], (prior[:, 1:] > 1e-30) & (nxt > 1e-30))
    same_norm = bool(torch.equal(norm_only, norm))
    check(err1 <= SCAN_TOLERANCES["post_abs"]
          and err2 <= SCAN_TOLERANCES["smooth_abs"]
          and r_rel <= SCAN_TOLERANCES["r_rel"] and reln <= 1e-5
          and same_norm, ("config-indexed kernels against plain", err1,
                          err2, r_rel, reln, same_norm))
    rows = {}
    for name, kern, err, plain_ms, kind, steps in (
            ("filter_scan_batch[cfg]", k1, err1, plain1, "k1", T),
            ("filter_scan_batch[norm]", kn, errn, plain1, "norm", T),
            ("smoother_scan_batch[cfg]", k2, err2, plain2, "k2", T - 1)):
        ms = cuda_ms(kern, 5)
        b_ms, b_by = _cfg_bound(nnz, c, band, len(flags), steps, L, kind)
        rows[name] = dict(E=E, steps=E * steps, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)
        log(f"time {name} on the sweep's first batch cut to {E} runs "
            f"({per_w} per band width) x {steps} bins, L={L}: kernel "
            f"{ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); max "
            f"|kernel - plain| {err:.3e}"
            + (f", rel {reln:.2e}, bit-equal to the full K1's normalisers "
               f"{same_norm}" if kind == "norm" else "")
            + (f", r rel {r_rel:.2e}" if kind == "k2" else ""))
    # the cost of padding a narrow band: K1 at W = 21 alone against the
    # same runs padded to the widest configuration's band (W = 81)
    narrow = [i for i, mv in enumerate(movement) if mv == 1.0][0]
    sel = torch.as_tensor([i for i, g in enumerate(c.tolist())
                           if g == int(cfg[pick[narrow * per_w]])],
                          device=ll.device)
    g = int(c[sel[0]])
    alone = hmm.stack_transitions([hmm.JointTransition(
        stack.Tdyn[g], stack.Tlat[g], torch.log(stack.Tdyn[g]),
        torch.log(stack.Tlat[g]))])
    w1 = ll[torch.as_tensor([pick[i] for i in sel.tolist()],
                            device=ll.device)].contiguous()
    zero = torch.zeros(len(sel), dtype=torch.int32, device=ll.device)
    l1 = torch.full((len(sel),), ll.shape[1], dtype=torch.int32,
                    device=ll.device)
    p1 = p0[:len(sel)].contiguous()
    ww, _ = sk._weights(w1, 1.0)
    band1 = hmm._cached_band(alone, alone.Tlat)
    pad = lambda: sk.filter_scan_batch(  # noqa: E731
        ww, stack.Tlat, stack.Tdyn, p1, l1, flags, band=band,
        cfg=torch.full_like(zero, g))
    own = lambda: sk.filter_scan_batch(  # noqa: E731
        ww, alone.Tlat, alone.Tdyn, p1, l1, flags, band=band1, cfg=zero)
    ms_own, ms_pad = cuda_ms(own, 5), cuda_ms(pad, 5)
    check(all(torch.equal(a, b) for a, b in zip(own(), pad())),
          "padded band changes K1's bits")
    W_own, W_pad = getattr(band1, "W", None), getattr(band, "W", None)
    log(f"band padding: K1 at W={W_own} alone {ms_own:.3f} ms against the "
        f"same {len(sel)} runs padded to W={W_pad} {ms_pad:.3f} ms "
        f"({ms_pad / ms_own:.2f}x), T={ll.shape[1]}, L={L}, bit-equal")
    rows["filter_scan_batch[cfg]"].update(
        ms_band_own=ms_own, ms_band_padded=ms_pad, W_own=W_own,
        W_padded=W_pad)
    return rows


def _sel_sweep(y, launches):
    """(a) the sweep fan-out: bench.py's grid at N = L = 500, T = 1e4."""
    from poor_man_gplvm_tpu_torch.parallel import sweep
    from poor_man_gplvm_tpu_torch.utils import profiling

    ys = y[:SWEEP_T].contiguous()
    kw = dict(SWEEP_KW, n_latent_bin=SEL_NL, device="cuda")
    sweep.sweep_fit_poisson_jump(ys, SWEEP_GRID, **kw)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    got = {}
    # the call's stages from its spans, each ending in a device synchronise
    profiling.reset()
    with counted_into(got, launches), profiling.recording(sync=True):
        sec, res = wall_s(lambda: sweep.sweep_fit_poisson_jump(
            ys, SWEEP_GRID, **kw))
    top = next(s for s in profiling.spans() if s.name == "sweep")
    stage = {}
    for s in profiling.spans():
        if s.parent == top.id:
            stage[s.name] = stage.get(s.name, 0.0) + s.seconds
    profiling.reset()
    peak = torch.cuda.max_memory_allocated() / 1e9
    B = len(res["config_index"])
    n_iter = SWEEP_KW["n_iter"]
    lml = res["log_marginal_l"]
    check(bool(torch.isfinite(lml).all()) and lml.shape == (B, n_iter),
          ("sweep log-marginals", lml.shape))
    check(got.get("filter_scan_batch[cfg]") == n_iter
          and got.get("smoother_scan_batch[cfg]") == n_iter
          and got.get("filter_scan_batch") == n_iter
          and got.get("smoother_scan_batch") == n_iter,
          f"one K1 and one K2 launch per EM iteration: {got}")
    alone_kw = dict(kw, n_repeat=1)
    sweep.sweep_fit_poisson_jump(ys, {"movement_variance": [1.0]},
                                 **alone_kw)
    sec1, _ = wall_s(lambda: sweep.sweep_fit_poisson_jump(
        ys, {"movement_variance": [1.0]}, **alone_kw))
    agg = B * SWEEP_T * n_iter / sec
    log(f"selection (a) sweep fan-out ({B} runs x T={SWEEP_T} x {n_iter} EM "
        f"iterations, N=L={SEL_NL}, m_maxiter={SWEEP_KW['m_maxiter']}): "
        f"{sec:.3f} s per call (its stage syncs in) -> {agg:.0f} aggregate "
        f"EM timesteps/s; one run alone {sec1:.3f} s, x{B} = "
        f"{B * sec1:.2f} s ({B * sec1 / sec:.1f}x the batch); launches "
        f"{got} (one K1 and one K2 per EM iteration); peak memory "
        f"{peak:.2f} GB")
    stages = {"initial draws": stage["sweep.init"],
              "emissions": stage["sweep.emissions"],
              "K1/K2 E-steps": stage["sweep.e_step"],
              "statistics": stage["sweep.statistics"],
              "Adam M-steps": stage["sweep.m_step"],
              "the rest of the call": top.seconds - sum(stage.values())}
    log(f"selection (a) stages of that call from its spans: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
    ll, stack, cfg = _sweep_rows_vs_single(ys, res, launches)
    rows = _sel_kernel_rows(ll, stack, cfg)
    del ll, res

    # four runs, one per band width, against each alone, capped Adam
    configs = [{"n_latent_bin": SEL_NL, "tuning_lengthscale": 10.0,
                "movement_variance": mv} for mv in SWEEP_GRID[
                    "movement_variance"]]
    fit_kw = dict(n_iter=n_iter, m_maxiter=SWEEP_ALONE_MAXITER,
                  device="cuda")
    gens = sweep.split_generator(torch.Generator().manual_seed(5), 4)
    states = [g.get_state() for g in gens]
    batch = sweep.sweep_fit_model_class(ys, configs, gens, "poisson",
                                        **fit_kw)
    worst = 0.0
    for i, cfg_i in enumerate(configs):
        g = torch.Generator()
        g.set_state(states[i])
        one = sweep.sweep_fit_model_class(ys, [cfg_i], [g], "poisson",
                                          **fit_kw)[0]
        a, b = batch[i]["log_marginal_l"], one["log_marginal_l"]
        worst = max(worst, float(((a - b).abs() / b.abs()).max()))
    log(f"selection (a) four runs (W = 11 ... 81) in one batch against "
        f"sweep_fit_model_class of each alone (m_maxiter="
        f"{SWEEP_ALONE_MAXITER}): log_marginal_l max rel {worst:.2e}")
    check(worst <= SWEEP_ALONE_RTOL, ("runs against alone", worst))
    return rows


def _split_columns(tb, ts):
    """(worst scaled gap over the columns, its column, all columns within
    rtol SPLIT_RTOL and atol SPLIT_ATOL) of two results tables."""
    check(tb.columns == ts.columns, (tb.columns, ts.columns))
    worst, ok = {}, True
    for col in ts.columns:
        a = np.asarray(tb[col], dtype=float)
        b = np.asarray(ts[col], dtype=float)
        worst[col] = float(np.nanmax(np.abs(a - b) / (
            SPLIT_ATOL / SPLIT_RTOL + np.abs(b)), initial=0.0))
        ok &= bool(np.allclose(a, b, rtol=SPLIT_RTOL, atol=SPLIT_ATOL,
                               equal_nan=True))
    col = max(worst, key=worst.get)
    return worst[col], col, ok


def _sel_one_split(y, launches):
    """(b) model_selection_one_split, batched against serial: timed at
    bench.py's settings (N = L = 500, Adam up to 1,000 iterations), then
    held to every column within rtol 1e-4 / atol 1e-6 and the same
    best_config with the Adam loop capped at SPLIT_MAXITER, the JAX
    package's own contract (test_one_split_batched_equals_serial caps it:
    the stop test flips under 1-ulp loss differences)."""
    from poor_man_gplvm_tpu_torch import selection

    ys = y[:SPLIT_T].cpu().numpy()

    def run(backend, kw):
        got = {}
        with counted_into(got, launches):
            sec, res = wall_s(lambda: selection.model_selection_one_split(
                ys, backend=backend, device="cuda",
                generator=torch.Generator().manual_seed(9), **kw))
        if backend == "batched":
            check(got.get("filter_scan_batch[norm]", 0) >= 1, got)
        return sec, res

    out, secs = {}, {}
    for backend in ("batched", "serial", "batched", "serial"):
        sec, out[backend] = run(backend, SPLIT_KW)
        secs.setdefault(backend, []).append(sec)
    gap, col, ok = _split_columns(
        out["batched"]["model_eval_result_all_configs"],
        out["serial"]["model_eval_result_all_configs"])
    same = out["batched"]["best_config"] == out["serial"]["best_config"]
    log(f"selection (b) model_selection_one_split (4 configs x 2 chains, "
        f"T={SPLIT_T}, N=L={SEL_NL}, Adam up to 1,000 iterations): batched "
        f"{secs['batched'][-1]:.3f} s vs serial {secs['serial'][-1]:.3f} s "
        f"-> {secs['serial'][-1] / secs['batched'][-1]:.1f}x (warm-up calls "
        f"{secs['batched'][0]:.3f} / {secs['serial'][0]:.3f} s); worst "
        f"column gap {gap:.2e} ({col}), all within rtol {SPLIT_RTOL}: {ok}; "
        f"best_config {out['batched']['best_config']} (same: {same})")
    capped = dict(SPLIT_KW, fit_kwargs=dict(SPLIT_KW["fit_kwargs"],
                                            m_step_maxiter=SPLIT_MAXITER))
    cap = {b: run(b, capped)[1] for b in ("batched", "serial")}
    gap, col, ok = _split_columns(
        cap["batched"]["model_eval_result_all_configs"],
        cap["serial"]["model_eval_result_all_configs"])
    same = cap["batched"]["best_config"] == cap["serial"]["best_config"]
    log(f"selection (b) with m_step_maxiter={SPLIT_MAXITER}: worst column "
        f"gap {gap:.2e} ({col}), every column within rtol {SPLIT_RTOL} atol "
        f"{SPLIT_ATOL}: {ok}; best_config {cap['batched']['best_config']} "
        f"(same: {same})")
    check(ok and same, ("batched against serial", gap, col, same))


def _sel_realistic(y, launches):
    """(c) a realistic selection, batched only: 8 configs (two basis
    ranks) x 5 chains on T = 2e4, with the default downsampled LMLs
    (4 fractions x 10 masks x 40 runs = 1,600 norm-only K1 filters)."""
    from poor_man_gplvm_tpu_torch import selection
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.parallel import sweep

    ys = y.cpu().numpy()
    times, got = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with counted_into(got, launches), stage_timer(
            times, (sweep, "sweep_fit_model_class"),
            (sweep, "sweep_eval_model_class"), (hmm, "filter_lml_batch")):
        sec, res = wall_s(lambda: selection.model_selection_one_split(
            ys, device="cuda", generator=torch.Generator().manual_seed(11),
            **REAL_KW))
    peak = torch.cuda.max_memory_allocated() / 1e9
    table = res["model_eval_result_all_configs"]
    n_masks = 4 * 10 * 40
    # a chain that detects no jump has a NaN consensus (the reference's
    # definition); every other column is finite
    check(len(table) == 8 and all(np.all(np.isfinite(np.asarray(
        table[c], dtype=float))) for c in table.columns
        if not c.startswith("jump_consensus")), "realistic table")
    check(got.get("filter_scan_batch[cfg]") == 2 * REAL_KW["fit_kwargs"][
        "n_iter"] + 1 and got.get("smoother_scan_batch[cfg]") == 2 * REAL_KW[
            "fit_kwargs"]["n_iter"] + 1, f"launches {got}")
    decodes = times["sweep_eval_model_class"] - times["filter_lml_batch"]
    log(f"selection (c) realistic: 8 configs (movement_variance x "
        f"tuning_lengthscale 5, 10: two basis ranks) x 5 chains, T={SEL_T} "
        f"(train {int(SEL_T * 0.8)}, test {int(SEL_T * 0.2)}), n_iter 5, "
        f"{n_masks} masked filters: {sec:.3f} s in all; fit "
        f"{times['sweep_fit_model_class']:.3f} s, test decodes "
        f"{decodes:.3f} s, masked filters {times['filter_lml_batch']:.3f} s "
        f"({got.get('filter_scan_batch[norm]')} norm-only K1 launches), "
        f"table and host {sec - times['sweep_fit_model_class'] - times['sweep_eval_model_class']:.3f} s; "
        f"peak memory {peak:.2f} GB; best_config {res['best_config']}")


def _sel_gain(launches):
    """The gain model at N = L = 500: its gain-aware decode (the gain in
    the per-bin dt of the emissions) at T = 1e5 on the sequential kernels
    and on the parallel ones, bit for bit, and GAIN_ITERS EM iterations."""
    from poor_man_gplvm_tpu_torch import convert
    from poor_man_gplvm_tpu_torch.experimental import (
        PoissonGPLVMGain1D_gain,
    )

    N = L = SEL_NL

    def model(engine):
        m = PoissonGPLVMGain1D_gain(N, n_latent_bin=L, movement_variance=1,
                                    tuning_lengthscale=10.0, device="cuda",
                                    inference_engine=engine)
        params = np.random.default_rng(1200).normal(
            size=(m.n_basis, N)).astype(np.float32)
        return convert.load_jax_state(m, params, m.tuning_basis.cpu().numpy())

    m_seq, m_par = model("cuda"), model("cuda_parallel")
    rng = np.random.default_rng(1201)
    gain = torch.as_tensor(np.exp(np.convolve(
        rng.normal(0, 0.5, GAIN_T), np.ones(200) / 200, "same")).astype(
            np.float32), device="cuda")
    _, y = m_seq.sample(GAIN_T, generator=torch.Generator().manual_seed(1202),
                        gain=gain)
    trans, _ = m_seq._make_transition({})
    args = (y, m_seq.tuning, {}, trans.logTlat, trans.logTdyn,
            m_seq.ma_neuron_default)
    kw = dict(n_time_per_chunk=GAIN_T, gain=gain)
    got = {}
    with counted_into(got, launches):
        with sequential_engine():
            sec_seq, seq = wall_s(lambda: m_seq._decode_latent(*args, **kw))
        sec_par, par = wall_s(lambda: m_par._decode_latent(*args, **kw))
    same = torch.equal(seq[0], par[0]) and float(seq[1]) == float(par[1])
    check(got.get("filter_scan", 0) >= 1 and got.get("pfilter_pass", 0) >= 1,
          got)
    log(f"gain decode T={GAIN_T} N=L={L} (the gain in the per-bin dt): "
        f"sequential K1/K2 {sec_seq:.3f} s, parallel K3/K4 {sec_par:.3f} s, "
        f"bit-identical {same}; log marginal {float(par[1])!r}")
    check(same, "gain decode differs between 'cuda' and 'cuda_parallel'")
    del seq, par
    with counted_into(got, launches):
        sec, em = wall_s(lambda: m_par.fit_em(y, n_iter=GAIN_ITERS,
                                              verboase=False))
    lml = np.array([float(v) for v in em["log_marginal_l"]])
    up = bool(np.all(lml[1:] >= lml[:-1] - GAIN_LML_RTOL * np.abs(lml[:-1])))
    log(f"gain fit T={GAIN_T} N=L={L}, {GAIN_ITERS} EM iterations: {sec:.3f} "
        f"s; log_marginal_l {lml.tolist()} (finite, non-decreasing to "
        f"{GAIN_LML_RTOL}: {up}); gain range "
        f"[{float(em['gain'].min()):.3f}, {float(em['gain'].max()):.3f}]")
    check(np.all(np.isfinite(lml)) and up, ("gain fit", lml))


def _sel_basis():
    """The legacy L-BFGS M-step at bench.py's shape: its time and its
    objective against the initial point."""
    from poor_man_gplvm_tpu_torch.ops import fit_tuning_with_basis as ftb
    from poor_man_gplvm_tpu_torch.ops.basis import generate_basis

    T, L, N = BASIS_SHAPE
    basis = generate_basis(10.0, L).cuda()
    rank = basis.shape[1]
    post = torch.as_tensor(np.random.default_rng(1).dirichlet(
        np.ones(L), size=T).astype(np.float32), device="cuda")
    tuning = _model(N, L, "prob").tuning.cpu().numpy()
    y = torch.as_tensor(_spikes(1300, tuning, T), device="cuda")
    init = (torch.zeros((rank, N), device="cuda"),
            torch.zeros(N, device="cuda"))
    args = (init, y, basis, post, 1.0)
    _, _, f0 = ftb.m_step_get_tuning_all_neuron_grouped(*args, maxiter=0)
    ftb.m_step_get_tuning_all_neuron_grouped(*args, maxiter=BASIS_MAXITER)
    sec, (_, tuning_fit, f) = wall_s(
        lambda: ftb.m_step_get_tuning_all_neuron_grouped(
            *args, maxiter=BASIS_MAXITER))
    log(f"fit_tuning_with_basis (T={T}, L={L}, N={N}, rank {rank}, "
        f"{BASIS_MAXITER} L-BFGS iterations, all neurons batched): "
        f"{1e3 * sec:.1f} ms per M-step; summed objective {float(f):.6f} "
        f"from {float(f0):.6f} at the start")
    check(float(f) < float(f0) and bool(torch.isfinite(tuning_fit).all()),
          ("L-BFGS did not improve", float(f), float(f0)))


def _sel_adam_trip():
    """The batched Adam runner's fused trip (kernels A and B) at the
    sweep's shape, (runs, L, rank, N) = (64, 500, 77, 500), on statistics
    drawn on the card: held to its plain version one trip from a warm state
    (run 1 stopped: its entries bit for bit), then timed with every run
    live beside the plain version, the autograd trip it replaces and its
    bound (4 B L K N operations at the f32 rate; yw and t read, W, mu and
    nu read and written).  Returns the kernels line's row."""
    from poor_man_gplvm_tpu_torch.ops import mstep
    from poor_man_gplvm_tpu_torch.ops.basis import generate_basis

    dev = torch.device("cuda")
    B, L, N = ADAM_TRIP_RUNS, SEL_NL, SEL_NL
    basis = generate_basis(SWEEP_KW["tuning_lengthscale"], L).to(dev)
    K = basis.shape[1]
    check(K == ADAM_TRIP_RANK, ("the sweep's basis rank", K))
    g = torch.Generator(device=dev).manual_seed(23)
    yw = torch.rand((B, L, N), generator=g, device=dev) ** 2 * 20
    tw = torch.rand((B, L), generator=g, device=dev) * 40 + 1
    args = ({"param_prior_std": torch.ones(B, device=dev)}, basis, yw, tw)
    params = torch.randn((B, K, N), generator=g, device=dev)
    state = mstep.adam_init_batch(params)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(3):
        r = mstep.poisson_value_and_grad_batch_plain(
            params, *args, opt_state=state, active=active, step_size=0.01)
        params, state = r["params"], r["opt_state"]
    active[1] = False
    hist = (torch.zeros((B, 8), device=dev), torch.zeros((B, 8), device=dev))
    _, advance = mstep._fused_poisson_trip(params, args, 0.01, hist)
    s = {"params": params.clone(), "count": state.count.clone(),
         "mu": state.mu.clone(), "nu": state.nu.clone(),
         "loss": torch.zeros(B, device=dev),
         "loss_prev": torch.zeros(B, device=dev),
         "error": torch.zeros(B, device=dev),
         "n_iter": torch.ones(B, dtype=torch.int64, device=dev),
         "active": active.clone()}
    advance(s, 5)
    want, plain_ms = timed_once(
        lambda: mstep.poisson_value_and_grad_batch_plain(
            params, *args, opt_state=state, active=active, step_size=0.01))
    err = float((s["params"] - want["params"])[active].abs().max())
    rel = float(((s["loss"] - want["loss"]).abs()
                 / want["loss"].abs())[active].max())
    frozen = all(torch.equal(s[k][1], v[1]) for k, v in (
        ("params", params), ("mu", state.mu), ("nu", state.nu)))
    check(err <= ADAM_TRIP_PARAMS_ATOL and rel <= ADAM_TRIP_LOSS_RTOL
          and frozen, ("the fused Adam trip against plain", err, rel,
                       frozen))
    s["active"].fill_(True)
    ms = cuda_ms(lambda: advance(s, 5), 50)
    fun = mstep.poisson_m_step_objective_batch

    def autograd_trip():
        p = s["params"].detach().requires_grad_(True)
        with torch.enable_grad():
            (grads,) = torch.autograd.grad(fun(p, *args).sum(), p)
        upd, new = mstep.adam_update(
            grads, mstep.AdamState(s["count"], s["mu"], s["nu"]), 0.01)
        return s["params"] + upd, new, torch.sqrt(
            torch.sum(torch.square(grads), dim=(1, 2)))

    auto_ms = cuda_ms(autograd_trip, 10)
    b_ms, b_by = bound(4.0 * (B * L * N + B * L + 5 * B * K * N),
                       4.0 * B * L * K * N / F32_FLOP_PER_S)
    log(f"time adam_poisson_trip (kernels A + B, a trip of the batched Adam "
        f"runner) at (runs, L, rank, N) = ({B}, {L}, {K}, {N}): {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, the autograd trip {auto_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); against plain one trip from a warm state: "
        f"weights max |diff| {err:.2e}, loss rel {rel:.2e}, the stopped "
        f"run's entries bit for bit {frozen}")
    return {"adam_poisson_trip": dict(
        ms=ms, plain_ms=plain_ms, autograd_trip_ms=auto_ms, bound_ms=b_ms,
        bound_by=b_by, max_abs_err=err, max_rel_err_loss=rel,
        shape=(f"a trip of the sweep's batched Adam runner: {B} runs, L={L},"
               f" rank {K} (tuning_lengthscale 10), N={N}, every run live; "
               "the check one trip from a warm state with run 1 stopped; "
               "launches: the main paths' (the host's; a CUDA graph's "
               "replays launch it again uncounted)"))}


def phase_selection(launches):
    """Sweeps and model selection at N = L = 500 on a sampled recording:
    (a) the sweep fan-out, (b) model_selection_one_split batched against
    serial, (c) a realistic batched selection; the config-indexed and
    norm-only kernels held against plain, the batched Adam runner's fused
    trip timed; then the gain model and the L-BFGS M-step.  Returns the
    kernels line's rows of the config-indexed and norm-only kernels and of
    the fused trip."""
    log(f"selection phase starts; {host_line()}")
    y = _sel_data()
    rows = _sel_sweep(y, launches)
    rows.update(_sel_adam_trip())
    _sel_one_split(y, launches)
    _sel_realistic(y, launches)
    del y
    _sel_gain(launches)
    _sel_basis()
    log(f"selection phase ends; {host_line()}")
    return rows


# ---------------------------------------------------------------------------
# compat: the drop-in surface (decoder, decoder_latentonly, decoder_exp) and
# the reactivation workflow (analysis/reactivation.py)
# ---------------------------------------------------------------------------


def _ms(fn):
    """(milliseconds on the host clock, result) of one call that ends in a
    device synchronise."""
    sec, out = wall_s(fn)
    return 1e3 * sec, out


def _post_err(a, b):
    """Max |exp(a) - exp(b)| of two log posteriors where either is above
    1e-30 (below, the kernels floor the log at -3e38 where the log-space
    path keeps a finite log)."""
    pa, pb = torch.exp(a), torch.exp(b)
    where = (pa > 1e-30) | (pb > 1e-30)
    return float((pa - pb).abs()[where].max())


def _compat_decoder(m, y, launches):
    """The functional decoder at N = L = SESSION_NL, T_LONG bins, through
    the entry points a JAX caller's script calls, default engine: each
    call's kernels counted and its ms printed."""
    from poor_man_gplvm_tpu_torch import decoder, decoder_latentonly, gp_kernel
    from poor_man_gplvm_tpu_torch.experimental import decoder_exp
    from poor_man_gplvm_tpu_torch.ops import hmm

    L = m.n_latent_bin
    _, log_lat, _, log_dyn = gp_kernel.create_transition_prob_1d(
        m.possible_latent_bin, m.possible_dynamics, m.movement_variance,
        m.p_move_to_jump, m.p_jump_to_move)
    args = (y, m.tuning, {}, log_lat, log_dyn, m.ma_neuron_default,
            m.ma_latent_default)

    def run(what, fn, want):
        """One counted call, its result; ``want`` (wrapper: n, or None for
        at least one) the launches it must make, and no other kernel but
        ``joint_acc`` (the parallel smoother's pairwise joint).  Then the
        call again, uncounted: its ms is the one reported (the first
        includes the kernels' first launches)."""
        got = {}
        with counted_into(got, launches):
            ms_first, out = _ms(fn)
        ms, _ = _ms(fn)
        ok = all((got.get(k, 0) == n if n is not None else got.get(k, 0) > 0)
                 for k, n in want.items())
        other = [k for k, n in got.items() if n and "[" not in k
                 and k not in want and k != "joint_acc"]
        check(ok and not other, f"{what}: launches {got}, want {want}")
        log(f"compat {what}: {ms:.1f} ms (host clock; first call "
            f"{ms_first:.1f}), launches "
            f"{ {k: v for k, v in got.items() if '[' not in k and v} }")
        return out

    par = {"pfilter_pass": None, "psmooth_pass": None}
    smooth = run(f"decoder.smooth_all_step_combined_ma_chunk T={T_LONG} "
                 f"N=L={L}", lambda: decoder.smooth_all_step_combined_ma_chunk(
                     *args), par)
    ref = hmm.smooth_combined_chunked(
        y, m.tuning, {}, decoder._joint(log_lat, log_dyn), m.ma_neuron_default,
        m.ma_latent_default, n_time_per_chunk=10000, engine="cuda")
    bits = all(torch.equal(a, b) for a, b in zip(smooth, ref))
    dec = m.decode_latent(y)
    post_err = float((torch.exp(smooth[0]) - dec["posterior_all"]).abs().max())
    lmf_rel = abs(float(smooth[1]) - dec["log_marginal_final"]) / abs(
        dec["log_marginal_final"])
    log(f"compat smoother: bit-equal to hmm.smooth_combined_chunked on "
        f"decoder._joint of the same matrices: {bits}; against "
        f"decode_latent: max |post| {post_err:.3e}, log marginal rel "
        f"{lmf_rel:.3e}")
    check(bits and post_err <= DECODE_POST_ATOL
          and lmf_rel <= DECODE_LMF_RTOL, (bits, post_err, lmf_rel))
    lml = float(smooth[1])
    ll = smooth[5]
    del smooth, ref, dec

    filt = run(f"decoder.filter_all_step_combined_ma T={T_LONG}",
               lambda: decoder.filter_all_step_combined_ma(*args),
               {"filter_scan": 1})
    rel = abs(float(filt[1]) - lml) / abs(lml)
    check(filt[0].shape == (T_LONG, 2, L) and rel <= DECODE_LMF_RTOL
          and bool(torch.isfinite(filt[3]).all()), ("filter", rel))
    log(f"compat filter: log marginal rel {rel:.3e} to the smoother's")
    del filt

    t = COMPAT_T_LL
    f = run(f"decoder.filter_all_step from a ({t}, {L}) log-likelihood",
            lambda: decoder.filter_all_step(ll[:t], log_lat, log_dyn),
            {"filter_scan": 1})
    s = run(f"decoder.smooth_all_step over {t} steps",
            lambda: decoder.smooth_all_step(f[0], f[2][1:], log_lat, log_dyn),
            {"smoother_scan": 1})
    with sequential_engine():
        want = hmm.smooth_combined_chunked(
            y[:t], m.tuning, {}, decoder._joint(log_lat, log_dyn),
            m.ma_neuron_default, m.ma_latent_default, engine="cuda")
    errs = (_post_err(f[0], want[2]), _post_err(s[0], want[0]),
            abs(float(f[1]) - float(want[1])) / abs(float(want[1])))
    log(f"compat filter_all_step/smooth_all_step against the chunked "
        f"smoother (K1/K2): max |filter post| {errs[0]:.3e}, max |smoothed "
        f"post| {errs[1]:.3e}, log marginal rel {errs[2]:.3e}")
    check(errs[0] <= DECODE_POST_ATOL and errs[1] <= DECODE_POST_ATOL
          and errs[2] <= DECODE_LMF_RTOL, ("filter/smooth_all_step", errs))
    del f, s, want, ll

    gain = torch.as_tensor(np.random.default_rng(1010).uniform(
        0.5, 2.0, T_LONG).astype(np.float32), device="cuda")
    g = run(f"decoder_exp.smooth_all_step_combined_ma_chunk_gain T={T_LONG}",
            lambda: decoder_exp.smooth_all_step_combined_ma_chunk_gain(
                *args, gain_l=gain), par)
    ref = hmm.smooth_combined_chunked(
        y, m.tuning, {}, decoder._joint(log_lat, log_dyn), m.ma_neuron_default,
        m.ma_latent_default, n_time_per_chunk=10000, engine="cuda",
        dt_l=gain)
    bits = all(torch.equal(a, b) for a, b in zip(g, ref))
    log(f"compat gain smoother: bit-equal to smooth_combined_chunked("
        f"dt_l=gain): {bits}")
    check(bits and np.isfinite(float(g[1])), "gain smoother")
    del g, ref

    # the latent-only pair at n_dyn = 1, on a PoissonGPLVM1D recording
    m1 = _family_model("PoissonGPLVM1D", m.n_neuron, L, "auto", seed=1011)
    y1, _ = _family_data(m1, T_LONG, 1012)
    _, log_k = gp_kernel.create_transition_prob_latent_1d(
        m1.possible_latent_bin, m1.movement_variance)
    args1 = (y1, m1.tuning, {}, log_k, m1.ma_neuron_default,
             m1.ma_latent_default)
    s1 = run(f"decoder_latentonly.smooth_all_step_combined_ma_chunk_latent "
             f"T={T_LONG}", lambda: decoder_latentonly
             .smooth_all_step_combined_ma_chunk_latent(*args1), par)
    dec1 = m1.decode_latent(y1)
    post_err = float((torch.exp(s1[0]) - dec1["posterior_all"]).abs().max())
    lmf_rel = abs(float(s1[1]) - dec1["log_marginal_final"]) / abs(
        dec1["log_marginal_final"])
    f1 = run(f"decoder_latentonly.filter_all_step_combined_ma_latent "
             f"T={T_LONG}", lambda: decoder_latentonly
             .filter_all_step_combined_ma_latent(*args1), {"filter_scan": 1})
    rel = abs(float(f1[1]) - float(s1[1])) / abs(float(s1[1]))
    log(f"compat latent-only: smoother against decode_latent max |post| "
        f"{post_err:.3e}, log marginal rel {lmf_rel:.3e}; filter log "
        f"marginal rel {rel:.3e}")
    check(post_err <= DECODE_POST_ATOL and lmf_rel <= DECODE_LMF_RTOL
          and rel <= DECODE_LMF_RTOL, ("latent-only", post_err, lmf_rel, rel))


def _compat_shuffles(v, seed, key_index, n_keys, E):
    """The first ``E`` shuffles of one key of the reactivation null:
    the seeds are drawn one per (shuffle, key), shuffle by shuffle."""
    from poor_man_gplvm_tpu_torch.analysis import reactivation

    rng = np.random.default_rng(seed)
    seeds = [int(rng.integers(2**31)) for _ in range(E * n_keys)]
    return np.stack([reactivation.circular_shuffle_column_independently(
        v, min_shift=5, rng=s) for s in seeds[key_index::n_keys]])


def _compat_plain_rows(m, v, seed):
    """The null's first batch, cut to COMPAT_PLAIN_E shuffles at its full
    length: batched K1 and K2 against their plain versions on the batch's
    own log-likelihood rows, timed.  Returns the kernels line's rows."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import SCAN_TOLERANCES, _max_rel

    E, (T, L) = COMPAT_PLAIN_E, (v.shape[0], m.n_latent_bin)
    trans, _ = m._make_transition({})
    y_b = torch.as_tensor(_compat_shuffles(v, seed, 0, 2, E),
                          dtype=torch.float32, device=m.device)
    ll = hmm.sequence_loglikelihoods(
        y_b, m.tuning, {}, m.ma_neuron_default, m.ma_latent_default,
        hmm.auto_chunk_size(T, 2 * L, L, m.device))
    w, _ = sk._weights(ll, 1.0)
    band = hmm._cached_band(trans, trans.Tlat)
    tlat_t = trans.Tlat.transpose(-1, -2).contiguous()
    flags = trans.uniform_rows
    p_init = torch.exp(trans.uniform_log_init())[None].expand(
        E, 2, L).contiguous()
    lengths = torch.full((E,), T, dtype=torch.int32, device=m.device)
    nnz = _nnz(trans.Tlat, flags)
    k1 = lambda: sk.filter_scan_batch(  # noqa: E731
        w, trans.Tlat, trans.Tdyn, p_init, lengths, flags, band=band)
    post, prior, norm = k1()
    want, plain1 = timed_once(lambda: sk.filter_scan_batch_plain(
        w, trans.Tlat, trans.Tdyn, p_init, lengths, flags))
    err1 = max(float((a - b).abs().max())
               for a, b in zip((post, prior), want[:2]))
    last = post[:, -1].contiguous()
    k2 = lambda: sk.smoother_scan_batch(  # noqa: E731
        post[:, :-1], prior[:, 1:], tlat_t, trans.Tdyn, last, lengths - 1,
        flags, band=band)
    smooth, r = k2()
    want2, plain2 = timed_once(lambda: sk.smoother_scan_batch_plain(
        want[0][:, :-1], want[1][:, 1:], tlat_t, trans.Tdyn,
        want[0][:, -1].contiguous(), lengths - 1, flags))
    err2 = float((smooth - want2[0]).abs().max())
    nxt = torch.cat([smooth[:, 1:], last[:, None]], dim=1)
    r_rel = _max_rel(r, want2[1], (prior[:, 1:] > 1e-30) & (nxt > 1e-30))
    finite = all(bool(torch.isfinite(x).all())
                 for x in (post, prior, norm, smooth, r))
    check(err1 <= SCAN_TOLERANCES["post_abs"]
          and err2 <= SCAN_TOLERANCES["smooth_abs"]
          and r_rel <= SCAN_TOLERANCES["r_rel"] and finite,
          ("the reactivation null's first batch against plain", err1, err2,
           r_rel))
    rows = {}
    for name, kern, err, plain_ms, steps in (
            ("filter_scan_batch", k1, err1, plain1, E * T),
            ("smoother_scan_batch", k2, err2, plain2, E * (T - 1))):
        ms = cuda_ms(kern, 5)
        b_ms, b_by = kernel_bound(name, steps, L, 2, nnz)
        rows[name] = dict(E=E, steps=steps, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)
        log(f"time {name} on the reactivation null's first batch (E={E} "
            f"shuffles of {T} bins, L={L}, {steps} steps in all): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
            f"({b_by}); max |kernel - plain| {err:.3e}"
            + (f", r rel {r_rel:.2e}" if name.startswith("smoother") else ""))
    return rows


def _compat_reactivation(m, y, y_tsdf, launches):
    """The reactivation workflow at N = L = SESSION_NL: the within-epoch
    null on two epochs of COMPAT_T_EP bins, batched (one K1 and one K2
    launch per batch and key), two shuffles of each key bit for bit
    against the serial path on K1/K2, the serial loop timed, the first
    batch's kernels against plain, the naive-Bayes null, and
    decode_ripple_epochs over the epochs phase's ragged epochs.  Returns
    the kernels line's reactivation rows."""
    from poor_man_gplvm_tpu_torch import IntervalSet
    from poor_man_gplvm_tpu_torch.analysis import reactivation

    T, L, dt, seed = COMPAT_T_EP, m.n_latent_bin, SESSION_DT, 1020
    eps = {"pre": IntervalSet(0.0, (T - 0.5) * dt),
           "post": IntervalSet(2 * T * dt, (3 * T - 0.5) * dt)}
    null = reactivation.circular_shuffle_spikes_within_epoch_and_decode
    kw = dict(decoder_type="dynamics", rng=seed, verbose=False)

    got = {}
    reactivation._to_host.bytes = 0
    torch.cuda.reset_peak_memory_stats()
    with counted_into(got, launches):
        sec, table = wall_s(lambda: null(
            m, y_tsdf, eps, n_shuffle=COMPAT_N_SHUFFLE,
            shuffle_batch_size=COMPAT_BATCH, **kw))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_launch = 2 * -(-COMPAT_N_SHUFFLE // COMPAT_BATCH)
    host_b = reactivation._to_host.bytes / COMPAT_N_SHUFFLE
    check(got.get("filter_scan_batch") == n_launch
          and got.get("smoother_scan_batch") == n_launch
          and not got.get("pfilter_pass") and not got.get("psmooth_pass"),
          f"reactivation null launches {got}")
    check(len(table) == COMPAT_N_SHUFFLE * L and table.columns == [
        "pre", "post", "diff"] and all(np.isfinite(table[c]).all()
                                       for c in table.columns),
          "reactivation null table")
    sums = table["pre"].reshape(COMPAT_N_SHUFFLE, L).sum(axis=1)
    check(np.abs(sums - 1).max() <= 1e-4, "mean posteriors sum to 1")
    check(host_b == 2 * L * 4, f"{host_b} bytes per shuffle to the host")
    log(f"compat reactivation null: 2 epochs of {T} bins, N=L={L}, "
        f"{COMPAT_N_SHUFFLE} shuffles in batches of {COMPAT_BATCH}: "
        f"{sec:.3f} s, {1e3 * sec / COMPAT_N_SHUFFLE:.1f} ms per shuffle "
        f"(both epochs; launches {got}); {host_b:.0f} bytes per shuffle to "
        f"the host (2 x L floats); peak device memory {peak:.2f} GiB")

    # where the null's time goes: the host's shuffles, and the device's
    # busy share of a small null (one batch per epoch)
    v_pre = np.asarray(y_tsdf.restrict(eps["pre"]).d)
    t0 = time.perf_counter()
    _compat_shuffles(v_pre, seed, 0, 2, COMPAT_PROFILE)
    host_ms = 1e3 * (time.perf_counter() - t0) / COMPAT_PROFILE
    wall, busy, top, h2d = device_busy(lambda: null(
        m, y_tsdf, eps, n_shuffle=COMPAT_PROFILE,
        shuffle_batch_size=COMPAT_PROFILE, **kw))
    log(f"compat reactivation null: one epoch's shuffle built on the host "
        f"in {host_ms:.1f} ms (500 column rolls of {T} bins); under "
        f"torch.profiler a null of {COMPAT_PROFILE} shuffles (one batch per "
        f"epoch) keeps the device busy {busy:.3f} of {wall:.3f} s "
        f"({100 * busy / wall:.1f} %), {h2d} host-to-device copies; top "
        f"kernels {top}")

    with sequential_engine():
        alone = null(m, y_tsdf, eps, n_shuffle=COMPAT_ALONE, batched=False,
                     **kw)
    rows = COMPAT_ALONE * L
    bits = all(np.array_equal(alone[c], table[c][:rows])
               for c in table.columns)
    log(f"compat reactivation null: shuffles 0-{COMPAT_ALONE - 1} of each "
        f"epoch bit for bit against the serial path on K1/K2: {bits}")
    check(bits, "batched null against the serial path")
    sec_s, serial = wall_s(lambda: null(
        m, y_tsdf, eps, n_shuffle=COMPAT_SERIAL, batched=False, **kw))
    rows = COMPAT_SERIAL * L
    rel = max(float(np.abs(serial[c] - table[c][:rows]).max()
                    / np.abs(table[c][:rows]).max()) for c in table.columns)
    log(f"compat reactivation null, serial loop on {COMPAT_SERIAL} shuffles "
        f"(decode_latent, K3/K4 at {T} bins): {sec_s:.3f} s, "
        f"{1e3 * sec_s / COMPAT_SERIAL:.1f} ms per shuffle; against the "
        f"batched table max rel {rel:.2e}")
    check(rel <= COMPAT_NULL_RTOL, ("serial against batched", rel))

    kernel_rows = _compat_plain_rows(m, v_pre, seed)

    with counted(launches):
        sec_nb, nb = wall_s(lambda: null(
            m, y_tsdf, eps, n_shuffle=COMPAT_NB_SHUFFLE,
            **dict(kw, decoder_type="naive_bayes")))
    check(len(nb) == COMPAT_NB_SHUFFLE * L
          and all(np.isfinite(nb[c]).all() for c in nb.columns),
          "naive-Bayes reactivation null")
    log(f"compat reactivation naive-Bayes null: {COMPAT_NB_SHUFFLE} "
        f"shuffles {sec_nb:.3f} s, {1e3 * sec_nb / COMPAT_NB_SHUFFLE:.1f} ms "
        "per shuffle")

    _, T_rec, E, bins, _ = EPOCH_CELLS[1]
    lengths = _epoch_lengths(L, E, bins)
    starts = np.random.default_rng(L + E).integers(0, T_rec - lengths)
    intervals = np.stack([starts, starts + lengths], axis=1)
    with counted(launches):
        sec_r, rip = wall_s(lambda: reactivation.decode_ripple_epochs(
            m, y, intervals))
    own = m.decode_latent_epochs(y, intervals)
    mean = np.stack([rip["posterior_mean_df"][j] for j in range(L)], axis=1)
    same = np.array_equal(mean, own["posterior_mean"]) and np.array_equal(
        rip["log_marginal_per_epoch"], own["log_marginal_per_epoch"])
    log(f"compat decode_ripple_epochs: {E} ragged epochs of {bins[0]}-"
        f"{bins[1]} bins, {1e3 * sec_r:.1f} ms; posterior_mean equal to "
        f"decode_latent_epochs': {same}")
    check(same, "decode_ripple_epochs against decode_latent_epochs")
    return kernel_rows


def phase_compat(launches):
    """The drop-in surface and the reactivation workflow at N = L =
    SESSION_NL on the session's sampled recording (``_compat_*``).
    Returns the kernels line's rows of the batched K1/K2 on the
    reactivation null's first batch."""
    t0 = time.perf_counter()
    m, _, y, y_tsdf = _session_model()
    _compat_decoder(m, y, launches)
    rows = _compat_reactivation(m, y, y_tsdf, launches)
    log(f"compat phase {time.perf_counter() - t0:.1f} s")
    return rows


def _mesh(shape):
    """A ('data', 'time', 'neuron') mesh of ``shape`` over cuda:0
    repeated."""
    from poor_man_gplvm_tpu_torch.parallel import spmd

    n = int(np.prod(shape))
    return spmd.make_mesh(n, devices=[torch.device("cuda", 0)] * n,
                          shape=shape)


@contextlib.contextmanager
def time_engine(name, diag):
    """Run the mesh path's sharded smoother on the time engine ``name``,
    its fixed-point diagnostics appended to ``diag``."""
    from poor_man_gplvm_tpu_torch.parallel import spmd

    orig = spmd.sharded_smooth
    spmd.sharded_smooth = functools.partial(orig, time_engine=name,
                                            diag_out=diag)
    try:
        yield
    finally:
        spmd.sharded_smooth = orig


def _merge(launches, mine):
    for k, v in mine.items():
        launches[k] = launches.get(k, 0) + v


def _k3k4_nvalid():
    """K3/K4 with a shard-local validity bound against their plain
    versions at L = MESH_NL (``testing.pscan_nvalid_vs_plain``: K3 finals
    and emit, K4 finals and full), n_dyn in {1, 2}, n_valid in {0, 1,
    T - 3, T, T + 1 (K4)}, on the band and forced dense, with the control
    that fails a plain version at another bound."""
    from poor_man_gplvm_tpu_torch.ops import band as bd
    from poor_man_gplvm_tpu_torch.testing import (
        pscan_nvalid_failures, pscan_nvalid_vs_plain, scan_case,
    )

    dev, T = torch.device("cuda"), T_PSCAN
    for n_dyn in (1, 2):
        case = scan_case(MESH_NL * 10 + n_dyn, T, MESH_NL, n_dyn, "masked")
        for nv in (0, 1, T - 3, T, T + 1):
            for dense in (False, True):
                bd.set_band_override(dense)
                try:
                    err = pscan_nvalid_vs_plain(case, dev, nv)
                    torch.cuda.synchronize()
                finally:
                    bd.set_band_override(False)
                bad = pscan_nvalid_failures(err, "highest")
                log(f"K3/K4 n_valid={nv} vs plain T={T} L={MESH_NL} "
                    f"n_dyn={n_dyn} {'dense' if dense else 'band'}: "
                    f"{_fmt(err)}")
                check(not bad, f"K3/K4 n_valid={nv}: {bad} {err}")
        ctl = pscan_nvalid_vs_plain(case, dev, T - 3, plain_n_valid=T // 2)
        bad = pscan_nvalid_failures(ctl, "highest")
        log(f"control n_dyn={n_dyn}: kernels at n_valid={T - 3} against "
            f"plain at {T // 2} fail on {bad}")
        check(bad, f"n_valid control passed: {ctl}")


def _k3k4_nvalid_timed(Tl, n_valid_f, n_valid_b):
    """The kernels line's rows of K3/K4 at a time shard's bounds: the
    shard of the (1, 4, 1) decode that holds the padded row (Tl rows,
    n_valid_f steps of K3; K4 at n_valid_b, Tl + 1 on the shards before
    it), n_dyn = 2 with the jump channel, L = MESH_NL; each call held
    against its plain version and timed, beside its bound."""
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps
    from poor_man_gplvm_tpu_torch.testing import (
        PSCAN_TOLERANCES, bwd_guess, pscan_inputs, scan_case,
    )

    dev, L = torch.device("cuda"), MESH_NL
    a = pscan_inputs(scan_case(L, Tl, L, 2, "jump"), dev)
    C = a["ins"].shape[0]
    nnz = _nnz(a["tlat"], a["flags"])
    fwd = (a["w"], a["tlat"], a["tdyn"], a["ins"], a["tc"], a["flags"])
    post = ps.pfilter_pass_plain(*fwd, True, n_valid=n_valid_f)[0]
    bwd = (post, a["tlat"], a["tlat_t"], a["tdyn"],
           bwd_guess(post, a["tc"], C), a["tc"], a["flags"])
    band = ps.transition_band(a["tlat"], a["tlat_t"], a["flags"])
    calls = {}
    for m in ("finals", "emit"):
        e = m == "emit"
        calls[f"pfilter_pass[{m}/highest/nv]"] = (
            lambda e=e: ps.pfilter_pass(*fwd, e, band=band,
                                        n_valid=n_valid_f),
            lambda e=e: ps.pfilter_pass_plain(*fwd, e, n_valid=n_valid_f),
            TIMED_OUTPUT.get(m, (2, "fwd_finals_abs")))
    for m in ("finals", "full"):
        calls[f"psmooth_pass[{m}/highest/nv]"] = (
            lambda m=m: ps.psmooth_pass(*bwd, m, band=band,
                                        n_valid=n_valid_b),
            lambda m=m: ps.psmooth_pass_plain(*bwd, m, n_valid=n_valid_b),
            TIMED_OUTPUT.get(m, (2, "bwd_finals_abs")))
    rows = {}
    for name, (kern, plain, (idx, key)) in calls.items():
        want, plain_ms = timed_once(plain)
        got = kern()
        err = float((got[idx] - want[idx]).abs().max())
        ms = cuda_ms(kern, MESH_NV_REPS)
        bound_ms, bound_by = kernel_bound(name.replace("/nv", ""), Tl, L, 2,
                                          nnz)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
        log(f"time {name} T={Tl} L={L} n_dyn=2 C={C} tc={a['tc']} "
            f"n_valid={n_valid_f if 'pfilter' in name else n_valid_b}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); max |kernel - plain| "
            f"{err:.3e}")
        check(err <= PSCAN_TOLERANCES[key], (name, key, err))
    return rows


def _k12_chains_vs_plain(Tl, L):
    """The batched K1/K2 as the pipeline engine launches them, a chain per
    sequence with its own carry (K1's p_init, K2's init) and lengths,
    against their plain versions."""
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import SCAN_TOLERANCES, scan_case

    dev = torch.device("cuda")
    case = scan_case(77, Tl, L, 2, "jump")
    tlat = torch.as_tensor(case["tlat"], device=dev)
    tdyn = torch.as_tensor(case["tdyn"], device=dev)
    rng = np.random.default_rng(78)
    ll = torch.as_tensor(np.stack([case["ll"], case["ll"][::-1].copy()]),
                         device=dev)
    carry = torch.as_tensor(rng.dirichlet(np.ones(2 * L), size=2).astype(
        np.float32).reshape(2, 2, L), device=dev)
    lengths = torch.tensor([Tl, Tl - 7], dtype=torch.int32, device=dev)
    flags = sk._detect_uniform_rows(tlat)
    post, prior, _ = sk.filter_chunk_batch(ll, tlat, tdyn, carry, lengths,
                                           1.0, uniform_rows=flags)
    w, _ = sk._weights(ll, 1.0)
    post_p, prior_p, _ = sk.filter_scan_batch_plain(w, tlat, tdyn, carry,
                                                    lengths, flags)
    err = {"post_abs": 0.0, "smooth_abs": 0.0}
    filt = torch.stack([torch.where(
        (torch.arange(Tl, device=dev) < n)[:, None, None], post[e], 0.0)
        for e, n in enumerate(lengths.tolist())])
    sm, _ = sk.smoother_chunk_batch(filt, prior, tlat, tdyn, carry, lengths,
                                    uniform_rows=flags)
    sm_p, _ = sk.smoother_scan_batch_plain(
        filt, prior, tlat.transpose(-1, -2).contiguous(), tdyn, carry,
        lengths, flags)
    for e, n in enumerate(lengths.tolist()):
        err["post_abs"] = max(err["post_abs"], float(
            (post[e, :n] - post_p[e, :n]).abs().max()))
        err["smooth_abs"] = max(err["smooth_abs"], float(
            (sm[e, :n] - sm_p[e, :n]).abs().max()))
    log(f"K1/K2 batched with a carry per chain, E=2 T={Tl} L={L} lengths "
        f"{lengths.tolist()}: vs plain {_fmt(err)}")
    check(err["post_abs"] <= SCAN_TOLERANCES["post_abs"]
          and err["smooth_abs"] <= SCAN_TOLERANCES["smooth_abs"], err)


def _split_ll_smooth(trans, tuning, y, n_neuron):
    """The smoothed posterior (T, n_dyn, L) of the unsharded parallel
    engine on the emissions a mesh of ``n_neuron`` neuron shards forms:
    each shard's partial product (``spmd._ll_partial``), summed in shard
    order."""
    from poor_man_gplvm_tpu_torch.ops import hmm, parallel_scan as ps
    from poor_man_gplvm_tpu_torch.parallel import spmd

    Nl = y.shape[1] // n_neuron
    ll = None
    for n in range(n_neuron):
        cols = slice(n * Nl, (n + 1) * Nl)
        part = spmd._ll_partial(y[:, cols], tuning[:, cols],
                                torch.ones_like(y[:, cols]), "poisson",
                                torch.tensor(1.0, device=y.device))
        ll = part if ll is None else ll + part
    tlat, tdyn = hmm._transition_stack(trans)
    return ps.smooth_parallel(ll, tlat, tdyn,
                              torch.exp(trans.uniform_log_init()), 1.0,
                              uniform_rows=trans.uniform_rows,
                              want_acc=False)[0]


def _mesh_decodes(launches):
    """``decode_latent(mesh=)`` on both meshes and both time engines,
    against the unsharded 'cuda_parallel' decode (a neuron-split mesh also
    against the unsharded engine on its own emission rows)."""
    N = L = MESH_NL
    m, params, y = _decode_setup(N, L, MESH_T)
    ref_model = _model(N, L, "cuda_parallel", params)
    ref = ref_model.decode_latent(y)
    _check_decode(ref, MESH_T, L)
    split_ref = {n: _split_ll_smooth(m._make_transition({})[0], m.tuning, y,
                                     n)
                 for n in {shape[2] for shape in MESH_SHAPES if shape[2] > 1}}
    ref_ms = cuda_ms(lambda: ref_model.decode_latent(y)["posterior_all"], 2)
    log(f"mesh: unsharded decode N=L={L} T={MESH_T} engine=cuda_parallel "
        f"{ref_ms:.1f} ms/call")
    for shape in MESH_SHAPES:
        mesh = _mesh(shape)
        for eng in ("pscan", "pipeline"):
            diag, mine = [], {}
            with time_engine(eng, diag), counted(mine):
                res = m.decode_latent(y, mesh=mesh)
            _merge(launches, mine)
            _check_decode(res, MESH_T, L)
            lmf_rel = abs(res["log_marginal_final"]
                          - ref["log_marginal_final"]) / abs(
                              ref["log_marginal_final"])
            post_err = float((res["posterior_all"]
                              - ref["posterior_all"]).abs().max())
            with time_engine(eng, []):
                ms = cuda_ms(lambda: m.decode_latent(
                    y, mesh=mesh)["posterior_all"], 1)
            own = ""
            if shape[2] > 1:
                own_err = float((res["posterior_all"]
                                 - split_ref[shape[2]]).abs().max())
                own = (f", max |post - unsharded on the mesh's own "
                       f"emissions| {own_err:.2e}")
                check(own_err <= MESH_POST_ATOL, (shape, eng, own_err))
            log(f"mesh decode {shape} {eng}: {ms:.1f} ms/call (unsharded "
                f"{ref_ms:.1f}), log_marginal_final rel {lmf_rel:.2e}, max "
                f"|post - unsharded| {post_err:.2e}{own}, fixed-point passes "
                f"(fwd, bwd) {[d[:2] for d in diag]}, launches {mine}")
            check(lmf_rel <= DECODE_LMF_RTOL, (shape, eng, lmf_rel))
            check(post_err <= (MESH_POST_ATOL if shape[2] == 1
                               else MESH_SPLIT_POST_ATOL),
                  (shape, eng, post_err))
            if eng == "pscan":
                check(len(diag) == 1 and mine.get("pfilter_pass", 0) > 0,
                      (diag, mine))
            else:
                check(mine.get("filter_scan_batch", 0) > 0
                      and mine.get("pfilter_pass", 0) == 0, mine)
    return m, params, y


def _mesh_fit(launches, params, y):
    """A capped 3-iteration ``fit_em(mesh=)`` against the unsharded host
    loop on the same engine."""
    N = L = MESH_NL
    rng = np.random.default_rng(1)
    init = rng.random((MESH_T, L)) * 0.1
    lpi = np.log(init / init.sum(axis=1, keepdims=True)).astype(np.float32)
    kw = dict(n_iter=MESH_FIT_ITERS, log_posterior_init=lpi, verboase=False,
              m_step_maxiter=MESH_FIT_MAXITER)
    t0 = time.perf_counter()
    ref = _model(N, L, "cuda_parallel", params).fit_em(y, fused=False, **kw)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    mine = {}
    with counted(mine):
        t0 = time.perf_counter()
        em = _model(N, L, "auto", params).fit_em(
            y, mesh=_mesh(MESH_SHAPES[0]), **kw)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
    _merge(launches, mine)
    a = np.array([float(v) for v in em["log_marginal_l"]])
    b = np.array([float(v) for v in ref["log_marginal_l"]])
    rel = float((np.abs(a - b) / np.abs(b)).max())
    post_err = float((em["posterior"] - ref["posterior"]).abs().max())
    log(f"mesh fit_em {MESH_SHAPES[0]} {MESH_FIT_ITERS} iterations "
        f"(m_step_maxiter={MESH_FIT_MAXITER}): {mesh_s:.2f} s (unsharded "
        f"host loop {ref_s:.2f} s), log_marginal_l rel {rel:.2e}, max "
        f"|posterior diff| {post_err:.2e}, launches {mine}")
    check(rel <= FIT_LML_RTOL and post_err <= MESH_FIT_POST_ATOL,
          (rel, post_err))


def _mesh_em_step(launches, m):
    """One sharded Poisson EM step on B chains (the pipeline engine, a
    batched K1/K2 launch where two chains meet), each chain against the
    unsharded iteration: the params against the unsharded M-step
    (test_spmd.py's tolerance), the log marginal against the decode with
    those params (1e-5), and the posteriors against the unsharded parallel
    engine on the step's own emission rows (its params, its neuron-shard
    sum; MESH_POST_ATOL).  The posteriors against the unsharded decodes are
    logged: the neuron shards' sum rounds the emissions otherwise, and
    sharp posteriors move with it (as in the decodes)."""
    from poor_man_gplvm_tpu_torch.ops import hmm, mstep
    from poor_man_gplvm_tpu_torch.parallel import spmd

    B, T, shape, maxiter = MESH_EM
    N = L = MESH_NL
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    y = torch.as_tensor(np.stack([_spikes(10 + b, m.tuning.cpu().numpy(), T)
                                  for b in range(B)]), device=dev)
    basis = m.tuning_basis
    params = torch.as_tensor(rng.normal(size=(B, basis.shape[1], N)) * 0.3,
                             dtype=torch.float32, device=dev)
    post0 = rng.random((B, T, L)) + 0.05
    log_post = torch.as_tensor(np.log(post0 / post0.sum(-1, keepdims=True)),
                               dtype=torch.float32, device=dev)
    trans, _ = m._make_transition({})
    step = spmd.make_sharded_poisson_em_step(_mesh(shape), basis, trans,
                                             m_maxiter=maxiter)
    mine = {}
    with counted(mine):
        t0 = time.perf_counter()
        p2, opt2, lp2, lml, loss = step(params, mstep.adam_init_batch(params),
                                        log_post, y)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    _merge(launches, mine)
    worst = {"params": 0.0, "lml_rel": 0.0, "post_own": 0.0, "post": 0.0,
             "post_full": 0.0}
    for b in range(B):
        y_w, t_w = mstep.get_statistics(log_post[b], y[b])
        run, init = mstep.make_adam_runner(mstep.poisson_m_step_objective,
                                           0.01, maxiter=maxiter)
        p_ref = run(params[b], init(params[b]), {"param_prior_std": 1.0},
                    basis, y_w, t_w)["params"]
        worst["params"] = max(worst["params"], float(
            ((p2[b] - p_ref).abs() - 2e-4 * p_ref.abs()).max()))
        for key, p in (("post_full", p_ref), ("post", p2[b])):
            sm, lml_ref = hmm.smooth_combined_chunked(
                y[b], mstep.get_tuning_softplus(p, basis), {}, trans,
                torch.ones(N, device=dev), engine="cuda")[:2]
            want = torch.exp(torch.logsumexp(sm, dim=1))
            worst[key] = max(worst[key], float(
                ((torch.exp(lp2[b]) - want).abs() - 2e-3 * want).max()))
            if key == "post_full":
                worst["lml_rel"] = max(worst["lml_rel"], abs(
                    float(lml[b]) - float(lml_ref)) / abs(float(lml_ref)))
        own = _split_ll_smooth(trans, mstep.get_tuning_softplus(p2[b], basis),
                               y[b], shape[2]).sum(dim=1)
        worst["post_own"] = max(worst["post_own"], float(
            (torch.exp(lp2[b]) - own).abs().max()))
    log(f"mesh EM step {shape} B={B} T={T}: {step_s:.2f} s, Adam state "
        f"count {opt2.count.tolist()}, final loss {loss.tolist()}; against "
        f"each chain's unsharded iteration (params: |diff| - 2e-4 |want|; "
        f"post_own: max |diff| on the step's own emissions; post, "
        f"post_full: |diff| - 2e-3 |want| against the unsharded decode "
        f"with the step's / the unsharded M-step's params): {_fmt(worst)}; "
        f"launches {mine}")
    # test_spmd.py's tolerances: params 2e-4 rel + 2e-5 abs, log marginal
    # 1e-5 rel; the E-step's posteriors PARITY's 1e-4
    check(worst["params"] <= 2e-5 and worst["post_own"] <= MESH_POST_ATOL
          and worst["lml_rel"] <= FIT_LML_RTOL, worst)
    check(mine.get("filter_scan_batch", 0) == B + shape[1] - 1
          and mine.get("smoother_scan_batch", 0) == B + shape[1] - 1, mine)


def phase_mesh(launches):
    """The mesh path (``parallel/spmd.py``) at N = L = MESH_NL on meshes of
    cuda:0 repeated.  Returns the kernels line's rows of K3/K4 at a time
    shard's validity bounds."""
    t0 = time.perf_counter()
    _k3k4_nvalid()
    Tl = -(-MESH_T // 4)
    rows = _k3k4_nvalid_timed(Tl, MESH_T - 3 * Tl, Tl + 1)
    _k12_chains_vs_plain(MESH_EM[1] // MESH_EM[2][1], MESH_NL)
    m, params, y = _mesh_decodes(launches)
    _mesh_fit(launches, params, y)
    _mesh_em_step(launches, m)
    log(f"mesh phase {time.perf_counter() - t0:.1f} s ({card_line()})")
    return rows


def _pipeline_counts(dirs):
    """Each probe's counts through ``compute_spike_counts_old`` (the
    native binner above 1e5 spikes), held equal to the numpy binner on
    the same spikes, with a control that must differ (the windows shifted
    by half a bin); then the pipeline's unit filters.  Returns (filtered
    counts of each probe, time bins, seconds by stage)."""
    from poor_man_gplvm_tpu_torch import data as pdata
    from poor_man_gplvm_tpu_torch.data import kilosort, native

    sec = {"load+bin (native)": 0.0, "bin (native)": 0.0,
           "bin (numpy)": 0.0, "filters": 0.0}
    mats, time_ref = [], None
    for d in dirs:
        calls = native.bin_sliding_native.calls
        t0 = time.perf_counter()
        counts, tb, units = pdata.compute_spike_counts_old(
            d, window_size=PIPE_DT, step_size=PIPE_DT, use_units="good",
            sigma=0, zscore=False, adj="")
        sec["load+bin (native)"] += time.perf_counter() - t0
        check(native.bin_sliding_native.calls == calls + 1,
              "compute_spike_counts_old did not run the native binner")
        st, clu = kilosort.load_kilosort_spikes(d, "good", "")
        for key, native_flag in (("bin (native)", True),
                                 ("bin (numpy)", False)):
            t0 = time.perf_counter()
            got = pdata.bin_spikes_sliding(st, clu, PIPE_DT, PIPE_DT,
                                           use_native=native_flag)
            sec[key] += time.perf_counter() - t0
            check(all(np.array_equal(a, b) for a, b in
                      zip(got, (counts, tb, units))),
                  f"{key} counts differ from compute_spike_counts_old's")
        shifted = pdata.bin_spikes_sliding(st, clu, PIPE_DT, PIPE_DT,
                                           t_origin=PIPE_DT / 2,
                                           use_native=True)[0]
        check(shifted.shape != counts.shape
              or not np.array_equal(shifted, counts),
              "the control (windows shifted by half a bin) equals the counts")
        t0 = time.perf_counter()
        total = counts.sum(axis=1)
        mean_rate = total / (len(tb) * PIPE_DT)
        presence = pdata.get_presence_ratio(counts, tb,
                                            PIPE_FILTERS["n_coarse_bins"])
        keep = ((total >= PIPE_FILTERS["min_total_spikes"])
                & (mean_rate >= PIPE_FILTERS["min_mean_rate"])
                & (presence >= PIPE_FILTERS["min_presence_ratio"]))
        sec["filters"] += time.perf_counter() - t0
        # the session's units 0 (presence 0.2) and 1 (1 % of the rate)
        check(sorted(units[~keep]) == [0, 1], ("filtered", units[~keep]))
        check(time_ref is None or np.array_equal(tb, time_ref),
              "the probes bin to different time grids")
        time_ref = tb
        log(f"pipeline probe {os.path.basename(d)}: {int(keep.sum())}/"
            f"{len(keep)} good units pass the filters, {int(total.sum())} "
            f"spikes, counts {counts.shape} equal on the native and numpy "
            "binners, the shifted control differs")
        mats.append(counts[keep])
    return mats, time_ref, sec


def _pipeline_epoch_rows(m, y, intervals, ep):
    """The bursts' batch (one batch: every burst) on its own
    log-likelihood rows, as ``decode_latent_epochs`` forms them: batched
    K1 and K2 against their plain versions over each epoch's rows, timed,
    and the batch's latent marginals against the decode's ``ep``.  Returns
    the kernels line's ``*_pipeline`` rows."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import SCAN_TOLERANCES, _max_rel

    dev, L = y.device, m.n_latent_bin
    lengths = intervals[:, 1] - intervals[:, 0]
    E, Tmax = len(lengths), int(lengths.max())
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    steps = torch.arange(Tmax, device=dev)
    valid = steps[None, :] < lens[:, None]
    rows = (torch.as_tensor(intervals[:, 0], device=dev)[:, None]
            + steps[None, :]).clamp(max=y.shape[0] - 1)
    ll = hmm.epoch_loglikelihoods(
        y[rows] * valid[:, :, None], lens, m.tuning, m._emission_hyper({}),
        m.ma_neuron_default, m.ma_latent_default, m.observation_model)
    w, _ = sk._weights(ll, 1.0)
    trans, _ = m._make_transition({})
    band = hmm._cached_band(trans, trans.Tlat)
    tlat_t = trans.Tlat.transpose(-1, -2).contiguous()
    flags = trans.uniform_rows
    p_init = torch.exp(trans.uniform_log_init()).reshape(1, 2, L).expand(
        E, 2, L).contiguous()
    each = torch.arange(E, device=dev)
    end = (lens - 1).long()

    def masked_err(a, b, mask):
        return float(torch.where(mask[:, :, None, None], a - b, 0.0)
                     .abs().max())

    k1 = lambda: sk.filter_scan_batch(  # noqa: E731
        w, trans.Tlat, trans.Tdyn, p_init, lens, flags, band=band)
    post, prior, norm = k1()
    want, plain1 = timed_once(lambda: sk.filter_scan_batch_plain(
        w, trans.Tlat, trans.Tdyn, p_init, lens, flags))
    err1 = max(masked_err(a, b, valid) for a, b in zip((post, prior),
                                                       want[:2]))
    last = post[each, end].contiguous()
    k2 = lambda: sk.smoother_scan_batch(  # noqa: E731
        post[:, :-1], prior[:, 1:], tlat_t, trans.Tdyn, last, lens - 1,
        flags, band=band)
    smooth, r = k2()
    want2, plain2 = timed_once(lambda: sk.smoother_scan_batch_plain(
        want[0][:, :-1], want[1][:, 1:], tlat_t, trans.Tdyn,
        want[0][each, end].contiguous(), lens - 1, flags))
    own = valid[:, 1:]
    err2 = masked_err(smooth, want2[0], own)
    # r[t] = smooth[t + 1] / prior[t + 1], the last row's numerator the
    # filter's last posterior
    nxt = torch.cat([smooth[:, 1:], torch.zeros_like(last[:, None])], dim=1)
    nxt[each, (lens - 2).long()] = last
    r_rel = _max_rel(r, want2[1], own[:, :, None, None]
                     & (prior[:, 1:] > 1e-30) & (nxt > 1e-30))
    lat = torch.cat([smooth.sum(dim=2), torch.zeros_like(
        smooth[:, :1].sum(dim=2))], dim=1)
    lat[each, end] = last.sum(dim=1)
    got = torch.as_tensor(ep["posterior_latent_marg"], device=dev)
    same = float(torch.where(valid[:, :, None], lat - got, 0.0).abs().max())
    finite = all(bool(torch.isfinite(torch.where(
        valid[:, :, None, None], x, 0.0)).all()) for x in (post, prior))
    check(err1 <= SCAN_TOLERANCES["post_abs"]
          and err2 <= SCAN_TOLERANCES["smooth_abs"]
          and r_rel <= SCAN_TOLERANCES["r_rel"] and finite
          and same <= EPOCH_SAME_LL_ATOL,
          ("the bursts' batch against plain", err1, err2, r_rel, same))
    nnz = _nnz(trans.Tlat, flags)
    out = {}
    for name, kern, err, plain_ms, n_steps in (
            ("filter_scan_batch", k1, err1, plain1, int(lengths.sum())),
            ("smoother_scan_batch", k2, err2, plain2,
             int(lengths.sum()) - E)):
        ms = cuda_ms(kern, 5)
        b_ms, b_by = kernel_bound(name, n_steps, L, 2, nnz)
        out[name] = dict(E=E, steps=n_steps, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
        log(f"time {name} on the bursts' batch (E={E} bursts of "
            f"{int(lengths.min())}-{Tmax} bins, L={L}, {n_steps} steps in "
            f"all): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); max |kernel - plain| {err:.3e}"
            + (f", r rel {r_rel:.2e}" if name.startswith("smoother") else "")
            + f"; the decode's marginals {same:.2e} from the batch's")
    return out


def _pipeline_bayes(counts, position):
    """The naive-Bayes baselines over PIPE_FOLDS folds of ``cv_split``
    on the card (float64), each against its plain CPU float64 run:
    predictions equal, log-probabilities within PIPE_BAYES_RTOL of the
    largest magnitude.  Returns (card s, CPU s, mean accuracy) by class."""
    from poor_man_gplvm_tpu_torch import data as pdata

    dev = torch.device("cuda")
    card = pdata.DecoderDataset(torch.as_tensor(counts, device=dev),
                                torch.as_tensor(position, device=dev))
    host = pdata.DecoderDataset(counts, position)
    out = {}
    for kind in ("Poisson", "Gaussian"):
        cls = getattr(pdata, f"{kind}BayesDecoder")
        sec_card = sec_cpu = acc = worst = 0.0
        for k in range(PIPE_FOLDS):
            (xtr, ytr), (xte, yte), _, _ = card.split(k, k_CV=PIPE_FOLDS)
            (cxtr, cytr), (cxte, _), _, _ = host.split(k, k_CV=PIPE_FOLDS)
            dec = cls(PIPE_L)
            check(dec.device.type == "cuda" and xte.is_cuda,
                  f"{kind}BayesDecoder is not on the card")
            s, lp = wall_s(lambda: dec.fit(xtr, ytr)
                           .predict_log_probabilities(xte))
            sec_card += s
            t0 = time.perf_counter()
            ref = cls(PIPE_L, device="cpu").fit(cxtr, cytr) \
                .predict_log_probabilities(cxte)
            sec_cpu += time.perf_counter() - t0
            check(lp.is_cuda and lp.dtype == torch.float64, lp.device)
            pred = torch.argmax(lp, dim=0).cpu()
            check(torch.equal(pred, torch.argmax(ref, dim=0)),
                  f"{kind}BayesDecoder fold {k}: the card's predictions "
                  "differ from the CPU float64 run")
            rel = float((lp.cpu() - ref).abs().max() / ref.abs().max())
            worst = max(worst, rel)
            acc += float((pred == yte.cpu()).double().mean()) / PIPE_FOLDS
        check(worst <= PIPE_BAYES_RTOL, (kind, worst))
        log(f"pipeline {kind}BayesDecoder, {PIPE_FOLDS} folds, K={PIPE_L}: "
            f"card {sec_card:.3f} s, CPU float64 {sec_cpu:.3f} s, "
            f"predictions equal, log-probabilities {worst:.2e} relative, "
            f"accuracy {acc:.3f}")
        out[kind] = (sec_card, sec_cpu, acc)
    return out


def phase_pipeline(launches):
    """``scripts/pipeline_session.py`` on a realistic two-probe session
    through the port's modules only: the Kilosort directory
    (``testing.kilosort_session``: 2 x 250 units, 1,200 s, ~3e6 spikes),
    counts on the native binner (equal to the numpy binner), the unit
    filters, the correlation sort, the fit and decode on the card (K3/K4,
    the decode against the sequential engine), the bursts of the MUA and
    their epoch decode (one batched K1 and one K2 launch, held against
    plain), a burst-restricted fit, the naive-Bayes baselines over 5
    folds on the card, the posterior-weighted position and the neuron
    sort.  Returns the kernels line's ``*_pipeline`` rows."""
    import tempfile

    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D
    from poor_man_gplvm_tpu_torch import data as pdata
    from poor_man_gplvm_tpu_torch import testing
    from poor_man_gplvm_tpu_torch.analysis import (
        get_posterior_weighted_average,
    )
    from poor_man_gplvm_tpu_torch.utils import compat, post_fit_sort_neuron

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sec = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        info = testing.kilosort_session(
            root, n_probes=PIPE_PROBES, n_units=PIPE_UNITS,
            duration_s=PIPE_DURATION_S, dt=PIPE_DT, n_latent_bin=PIPE_L,
            rate_hz=PIPE_RATE_HZ, seed=0)
        sec["session written"] = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(d, f)) for d in info["dirs"]
                   for f in os.listdir(d))
        log(f"pipeline session: {PIPE_PROBES} probes x {PIPE_UNITS} units, "
            f"{PIPE_DURATION_S:.0f} s, {info['n_spikes']} spikes, "
            f"{disk} bytes on disk, {len(info['burst_starts'])} bursts put "
            f"in")
        mats, time_bins, bin_sec = _pipeline_counts(info["dirs"])
    sec.update(bin_sec)
    t0 = time.perf_counter()
    counts = pdata.sort_units(np.vstack(mats), mode="corr")
    sec["sort (corr)"] = time.perf_counter() - t0
    N, T = counts.shape
    check(N == PIPE_PROBES * (PIPE_UNITS - 5), N)
    t0 = time.perf_counter()
    y = torch.as_tensor(counts.T, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    sec["counts to the card"] = time.perf_counter() - t0
    log(f"pipeline counts: N={N} x T={T} ({counts.nbytes} bytes float64 on "
        f"the host, {y.numel() * 4} bytes float32 on the card)")

    m = PoissonGPLVMJump1D(N, n_latent_bin=PIPE_L, movement_variance=1.0,
                           tuning_lengthscale=1.0)
    fit_l = {}
    with counted(fit_l):
        sec["fit"], em = wall_s(lambda: m.fit_em(
            y, generator=torch.Generator().manual_seed(3),
            n_iter=PIPE_FIT_ITERS, n_time_per_chunk=PIPE_CHUNK,
            verboase=False))
    lml = np.array([float(v) for v in em["log_marginal_l"]])
    check(np.isfinite(lml).all() and np.all(
        np.diff(lml) >= -1e-6 * np.abs(lml[:-1])), ("fit lml", lml))
    check(fit_l.get("pfilter_pass", 0) > 0 and fit_l.get("psmooth_pass", 0)
          > 0, ("the fit did not run K3/K4", fit_l))
    dec_l = {}
    with counted(dec_l):
        sec["decode"], res = wall_s(lambda: m.decode_latent(y))
    check(dec_l.get("pfilter_pass", 0) > 0 and dec_l.get("psmooth_pass", 0)
          > 0, ("the decode did not run K3/K4", dec_l))
    _check_decode(res, T, PIPE_L)
    with sequential_engine():
        ref = m.decode_latent(y)
    lmf_rel = abs(res["log_marginal_final"] - ref["log_marginal_final"]) / \
        abs(ref["log_marginal_final"])
    post_err = float((res["posterior_all"] - ref["posterior_all"])
                     .abs().max())
    check(lmf_rel <= DECODE_LMF_RTOL and post_err <= DECODE_POST_ATOL,
          ("the session decode against the sequential engine", lmf_rel,
           post_err))
    log(f"pipeline fit: {PIPE_FIT_ITERS} EM iterations {sec['fit']:.3f} s "
        f"({sec['fit'] / PIPE_FIT_ITERS:.3f} s/EM-iter; Adam iterations "
        f"{em['m_step_res_l']['n_iter']}), log marginals "
        f"{lml.tolist()}, K3/K4 launches {fit_l}; decode T={T} "
        f"{1e3 * sec['decode']:.1f} ms, against the sequential engine: "
        f"log_marginal_final rel {lmf_rel:.2e}, max |post| {post_err:.2e}")

    t0 = time.perf_counter()
    z = pdata.smooth_and_zscore(counts.sum(axis=0)[None], sigma=1.0,
                                zscore=True)[0]
    bursts = pdata.detect_population_bursts(z, STEP_SIZE=PIPE_DT)
    sec["bursts"] = time.perf_counter() - t0
    check(0.5 * len(info["burst_starts"]) <= len(bursts)
          <= 2 * len(info["burst_starts"]),
          ("bursts found against put in", len(bursts),
           len(info["burst_starts"])))
    intervals = np.array([[s, e + 1] for s, e in bursts])
    ep_l = {}
    with counted(ep_l):
        sec["burst epochs decode"], ep = wall_s(
            lambda: m.decode_latent_epochs(y, intervals))
    check(ep_l.get("filter_scan_batch", 0) == 1
          and ep_l.get("smoother_scan_batch", 0) == 1,
          ("one batched K1 and one K2 launch for the one batch", ep_l))
    check(np.isfinite(np.asarray(ep["log_marginal_per_epoch"])).all(),
          "burst log marginals")
    rows = _pipeline_epoch_rows(m, y, intervals, ep)

    ma = torch.zeros((T, N), dtype=torch.float32, device=dev)
    for s, e in bursts:
        ma[s:e + 1] = 1.0
    m_b = PoissonGPLVMJump1D(N, n_latent_bin=PIPE_L, movement_variance=0.5,
                             tuning_lengthscale=3.0)
    burst_l = {}
    with counted(burst_l):
        sec["burst-restricted fit"], em_b = wall_s(lambda: m_b.fit_em(
            y, generator=torch.Generator().manual_seed(3),
            n_iter=PIPE_FIT_ITERS, ma_neuron=ma, verboase=False))
    lml_b = np.array([float(v) for v in em_b["log_marginal_l"]])
    check(np.isfinite(lml_b).all() and lml_b[-1] > lml_b[0],
          ("burst-restricted fit", lml_b))
    log(f"pipeline bursts: {len(bursts)} found ({len(info['burst_starts'])} "
        f"put in), epoch decode {1e3 * sec['burst epochs decode']:.1f} ms; "
        f"burst-restricted fit ({int(ma[:, 0].sum())} burst bins) "
        f"{sec['burst-restricted fit']:.3f} s, log marginals "
        f"{lml_b.tolist()}")
    del ma

    bayes = _pipeline_bayes(counts, info["position"][:T].astype(np.int64))
    sec["Bayes decoders (card)"] = sum(v[0] for v in bayes.values())

    t0 = time.perf_counter()
    post = compat.tsdframe(res["posterior_latent_marg"], time_bins)
    pwa = get_posterior_weighted_average(
        compat.tsd(info["position"][:T], time_bins), post)[None]
    order = post_fit_sort_neuron({"tuning": m.tuning}, y)["argsort"]
    sec["posterior average + neuron sort"] = time.perf_counter() - t0
    visited = res["posterior_latent_marg"].sum(dim=0).cpu().numpy() > 0
    check(pwa.shape == (PIPE_L,) and np.isfinite(pwa[visited]).all(),
          ("posterior-weighted position", pwa))
    check(np.array_equal(np.sort(order), np.arange(N)), "neuron sort")
    _merge(launches, fit_l)
    _merge(launches, dec_l)
    _merge(launches, ep_l)
    _merge(launches, burst_l)
    log("pipeline stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sec.items()))
    log(f"pipeline phase {time.perf_counter() - t_phase:.1f} s "
        f"({card_line()})")
    return rows


def _same(a, b, path="result"):
    """Check two workflow results equal exactly (walking dicts, lists and
    tuples; ``ResultTable``s by columns and index; time-series containers
    by times and values)."""
    from poor_man_gplvm_tpu_torch.utils.table import ResultTable

    if isinstance(a, dict):
        check(list(a) == list(b), (path, "keys"))
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), (path, "length"))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, ResultTable):
        check(a.columns == b.columns, (path, "columns"))
        for x, y in zip([a[c] for c in a.columns] + a.index,
                        [b[c] for c in b.columns] + b.index):
            _same(x, y, path)
    elif hasattr(a, "t") and not torch.is_tensor(a) or hasattr(a, "start"):
        for attr in ("t", "d", "start", "end", "rel_times"):
            if hasattr(a, attr):
                _same(getattr(a, attr), getattr(b, attr), f"{path}.{attr}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        check(x.shape == y.shape and x.dtype == y.dtype and (
            np.array_equal(x, y, equal_nan=x.dtype.kind in "fc")
            if x.dtype != object else all(
                np.array_equal(np.asarray(u), np.asarray(v))
                for u, v in zip(x.ravel(), y.ravel()))),
            (path, "differs from the host copy's result"))


def _finite_tables(obj, path="result"):
    """Check every float column of every ``ResultTable`` in ``obj`` has no
    NaN."""
    from poor_man_gplvm_tpu_torch.utils.table import ResultTable

    if isinstance(obj, dict):
        for k, v in obj.items():
            _finite_tables(v, f"{path}[{k!r}]")
    elif isinstance(obj, ResultTable):
        for c in obj.columns:
            col = obj[c]
            check(col.dtype.kind not in "fc" or not np.isnan(col).any(),
                  (path, c, "NaN in a table"))


def _wf_tmaze(sec, launches):
    """The T-maze post-fit path on a seeded session
    (``testing.tmaze_session``): fit and decode on the card, then the
    workflow's functions on the results."""
    from poor_man_gplvm_tpu_torch import PoissonGPLVMJump1D, testing
    from poor_man_gplvm_tpu_torch.utils import compat
    from poor_man_gplvm_tpu_torch.utils.table import ResultTable
    from poor_man_gplvm_tpu_torch.workflows import tmaze_dataset as tmz

    nap = compat.timeseries_module()
    t0 = time.perf_counter()
    s = testing.tmaze_session(**WF_TMAZE, seed=0)
    sec["tmaze session written"] = time.perf_counter() - t0
    N, L, T = WF_TMAZE["n_neuron"], WF_TMAZE["n_latent_bin"], WF_TMAZE["T"]
    t = s["t"]
    y = torch.as_tensor(s["spikes"], device="cuda")
    m = PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1.0,
                           tuning_lengthscale=1.0)
    fit_l, dec_l = {}, {}
    with counted(fit_l):
        sec["tmaze fit"], em = wall_s(lambda: m.fit_em(
            y, generator=torch.Generator().manual_seed(3),
            n_iter=WF_FIT_ITERS, verboase=False))
    lml = np.array([float(v) for v in em["log_marginal_l"]])
    check(np.isfinite(lml).all() and np.all(
        np.diff(lml) >= -1e-6 * np.abs(lml[:-1])), ("tmaze fit lml", lml))
    with counted(dec_l):
        sec["tmaze decode"], dec = wall_s(lambda: m.decode_latent(y))
    check(dec_l.get("pfilter_pass", 0) > 0 and dec_l.get("psmooth_pass", 0)
          > 0, ("the decode did not run K3/K4", dec_l))
    _check_decode(dec, T, L)
    with sequential_engine():
        ref = m.decode_latent(y)
    lmf_rel = abs(dec["log_marginal_final"] - ref["log_marginal_final"]) / \
        abs(ref["log_marginal_final"])
    post_err = max(float((dec[k] - ref[k]).abs().max()) for k in (
        "posterior_all", "posterior_latent_marg", "posterior_dynamics_marg"))
    check(lmf_rel <= DECODE_LMF_RTOL and post_err <= DECODE_POST_ATOL,
          ("the T-maze decode against the sequential engine", lmf_rel,
           post_err))
    _merge(launches, fit_l)
    _merge(launches, dec_l)

    # the decode's results stay on the card up to the workflow
    map_d = dec["posterior_latent_marg"].argmax(dim=1)
    jump_p = dec["posterior_dynamics_marg"][:, 1]
    planted = s["dynamics"] == 1
    jump_host = compat.to_numpy(jump_p) > 0.5
    log(f"workflows tmaze: N={N} L={L} T={T} ({T * WF_TMAZE['dt']:.0f} s, "
        f"{WF_TMAZE['n_trials']} trials), fit {WF_FIT_ITERS} EM iterations "
        f"{sec['tmaze fit']:.3f} s, log marginals {lml.tolist()}, decode "
        f"{1e3 * sec['tmaze decode']:.1f} ms (against the sequential engine:"
        f" rel {lmf_rel:.2e}, max |post| {post_err:.2e}); jump calls "
        f"p>0.5: {jump_host[planted].mean():.3f} of the planted jump bins, "
        f"{jump_host[~planted].mean():.5f} of the others")
    map_host = compat.to_numpy(map_d)
    map_tsd = nap.Tsd(d=map_host.astype(float), t=t)
    speed = nap.Tsd(d=s["speed"], t=t)
    lin = nap.Tsd(d=s["lin"], t=t)
    trials = ResultTable(s["trials"])
    spk = nap.TsdFrame(d=s["spikes"], t=t)
    t0 = time.perf_counter()
    occ = tmz.get_latent_occurance_index_per_speed_level(map_d, speed, [5])
    _same(occ, tmz.get_latent_occurance_index_per_speed_level(
        map_host, speed, [5]), "occurrence index")
    # one place field per latent seen running (DBSCAN is sklearn's, not
    # on the card's machine)
    clusters = {k: np.zeros(len(v[1]), dtype=np.int64)
                for k, v in occ.items() if len(v[1]) > 10}
    fields = tmz.get_latent_field_properties(
        occ, clusters, lin, trial_intervals=trials,
        trial_range_to_compare={"early": (0, 10), "late": (-10, None)})
    in_range = tmz.get_latent_in_position_range(occ, lin, trials)
    single = tmz.get_single_reward_latent(in_range)
    both = tmz.get_both_reward_latent(in_range)
    changes = np.nonzero(map_host[1:] != map_host[:-1])[0] + 1
    pairs, n_pair = np.unique(np.column_stack(
        [map_host[changes - 1], map_host[changes]]), axis=0,
        return_counts=True)
    top = [tuple(int(v) for v in pairs[i]) for i in np.argsort(-n_pair)[:3]]
    idx = tmz.find_all_index_per_latent_pair(top, map_d)
    _same(idx, tmz.find_all_index_per_latent_pair(top, map_host),
          "latent pairs")
    trans = tmz.find_transition_times(lin, trials, lin_pt=WF_LIN_PT)
    sec["tmaze fields, reward latents, pairs, transitions"] = \
        time.perf_counter() - t0
    check(len(trans.t) == WF_TMAZE["n_trials"], ("arrivals", len(trans.t)))
    _finite_tables({"fields": fields, "in_range": in_range})

    t0 = time.perf_counter()
    jump_bin = compat.tsd((jump_p > 0.5).float(), t)
    cons = tmz.analyze_peri_transition_jump_consensus(
        lin, trials, jump_bin, lin_pt=WF_LIN_PT, max_window_size=WF_WINDOW,
        n_shuffle=WF_N_SHUFFLE, rng=0)
    sec["tmaze peri-arrival consensus (100 shuffles x 10 windows)"] = \
        time.perf_counter() - t0
    frac = cons["consensus_fractions"][None]
    null_q = np.array([np.quantile(cons["shuffle_fractions"][w], WF_NULL_Q)
                       for w in range(1, WF_WINDOW + 1)])
    _finite_tables(cons)
    check(frac[-1] > null_q[-1], ("the arrival jump consensus is not above "
                                  "its shuffles", frac.tolist(),
                                  null_q.tolist()))
    log(f"workflows tmaze: {len(trans.t)} arrivals; jump consensus by "
        f"window {np.round(frac, 3).tolist()}, shuffles' "
        f"{WF_NULL_Q:.0%} {np.round(null_q, 3).tolist()}; "
        f"{len(occ)} latents, {len(fields)} fields, reward latents: "
        f"{len(single)} one arm, {len(both)} both arms; pairs {top}")

    # the first MAP change at or after the first arrival: its pair
    first = changes[np.searchsorted(changes, int(round(
        s["arrival_t"][0] / WF_TMAZE["dt"])))]
    t0 = time.perf_counter()
    trig = tmz.latent_jump_triggered_analysis(
        map_tsd, nap.TsdFrame(d=np.column_stack([s["x"], s["y"], s["lin"],
                                                 s["speed"]]), t=t,
                              columns=["x", "y", "lin", "speed_gauss"]),
        spk, m.tuning, t=t[first])
    sec["tmaze jump-triggered"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    null = tmz.get_null_contrastive_projection(
        spk, m.tuning, map_tsd, jump_p[:, None], n_shuffle=WF_N_SHUFFLE,
        rng=0)
    sec["tmaze null projection (100 shuffles)"] = time.perf_counter() - t0
    tuning_host = compat.to_numpy(m.tuning)
    _same(null, tmz.get_null_contrastive_projection(
        spk, tuning_host, map_tsd, compat.to_numpy(jump_p)[:, None],
        n_shuffle=WF_N_SHUFFLE, rng=0), "null projection")
    check(np.isfinite(null[0]).all(), "null projection")
    check(all(np.isfinite(v.d).all() or np.isnan(v.d).all(axis=0).any()
              for v in trig[0].values()), "jump-triggered analysis")
    log(f"workflows tmaze: jump-triggered: {len(trig[1].t)} occurrences of "
        f"the MAP pair {map_host[first - 1:first + 1].tolist()} first seen "
        f"at the first arrival; null projection "
        f"{null[0].shape}; card results equal to the host copies' "
        "(occurrence index, latent pairs, null projection)")
    return dec, t, trig


def _wf_ach(sec, launches):
    """The ACh post-fit path on a seeded sleep session
    (``testing.ach_session``): the selection's fit and held-out
    evaluation on the card, ``prep_res`` as ``load_data_and_fit_res``
    builds it, ``main`` and the representational analysis."""
    from poor_man_gplvm_tpu_torch import selection, testing
    from poor_man_gplvm_tpu_torch.utils import compat
    from poor_man_gplvm_tpu_torch.workflows import ach_dataset as ach

    nap = compat.timeseries_module()
    t0 = time.perf_counter()
    a = testing.ach_session(**WF_ACH, seed=1)
    sec["ach session written"] = time.perf_counter() - t0
    L, T = WF_ACH["n_latent_bin"], WF_ACH["T"]
    n_train = int(T * (1 - WF_TEST_FRAC))
    y = torch.as_tensor(a["spikes"], device="cuda")
    config = dict(n_latent_bin=L, movement_variance=1.0,
                  tuning_lengthscale=1.0)
    fit_kw = dict(selection.default_fit_kwargs, n_iter=WF_FIT_ITERS,
                  verboase=False)
    sel_l, ev_l = {}, {}
    with counted(sel_l):
        sec["ach selection fit"], (model_fit_l, em_res_l) = wall_s(
            lambda: selection.fit_model_one_config(
                config, y[:n_train], generator=torch.Generator(
                ).manual_seed(0), fit_kwargs=fit_kw, n_repeat=WF_CHAINS))
    for em in em_res_l:
        lml = np.array([float(v) for v in em["log_marginal_l"]])
        check(np.isfinite(lml).all(), ("ach fit lml", lml))
    with counted(ev_l):
        sec["ach held-out evaluation"], metric = wall_s(
            lambda: selection.evaluate_model_one_config(model_fit_l,
                                                        y[n_train:]))
    best = int(metric["metric_overall"]["best_index"])
    _merge(launches, sel_l)
    _merge(launches, ev_l)
    log(f"workflows ach: N={WF_ACH['n_neuron']} L={L} T={T} "
        f"({T * WF_ACH['dt']:.0f} s), {len(a['onset_t'])} ACh ramps; "
        f"selection fit ({WF_CHAINS} chains x {WF_FIT_ITERS} EM iterations, "
        f"T={n_train}) {sec['ach selection fit']:.3f} s, launches {sel_l}; "
        f"evaluation on the held-out {T - n_train} bins "
        f"{sec['ach held-out evaluation']:.3f} s, launches {ev_l}; best "
        f"chain {best}")

    t_l = a["t"][:n_train]
    t0 = time.perf_counter()
    decode_res_l = ach.get_decode_res_l_from_em_res_l(em_res_l, t_l)
    sec["ach posteriors to the host"] = time.perf_counter() - t0
    _same(decode_res_l, ach.get_decode_res_l_from_em_res_l(
        [{"log_posterior_final": compat.to_numpy(e["log_posterior_final"])}
         for e in em_res_l], t_l), "posterior marginals")
    prep_res = {
        "spike_mat_sub": nap.TsdFrame(d=a["spikes"][:n_train], t=t_l),
        "fluo_data": nap.TsdFrame(d=a["ach"][:, None], t=a["t"],
                                  columns=["ACh"]),
        "sleep_state_index": nap.Tsd(d=a["sleep_state_index"], t=a["t"]),
        "is_stim": nap.Tsd(d=a["is_stim"], t=a["t"]),
        "t_l": t_l, **decode_res_l[best], "model_fit": model_fit_l[best]}
    t0 = time.perf_counter()
    res = ach.main(prep_res=prep_res, event_triggered_analysis_kwargs={
        "n_shuffle": WF_N_SHUFFLE, "minmax": 4, "do_zscore": False,
        "test_win": 2, "do_plot": False})
    sec["ach main (event-triggered, 100 shuffles)"] = \
        time.perf_counter() - t0
    _finite_tables(res)
    lines = []
    for state in ("NREM", "REM", "Awake"):
        key = ("p_continuous", f"ACh_onset_{state}")
        if key not in res:
            continue
        r = res[key]
        tp = ach.test_pre_post_against_shuffle(r["feature"], r["shuffle"],
                                               test_win=2)
        lines.append(f"{state}: {len(r['feature'])} onsets, post-pre "
                     f"{tp['diff']:.4f}, shuffles' 5-95% "
                     f"[{np.quantile(tp['diff_shuffle'][None], 0.05):.4f}, "
                     f"{np.quantile(tp['diff_shuffle'][None], 0.95):.4f}],"
                     f" p {tp['p']:.3f}")
        if state == "NREM":
            check(tp["diff"] < 0 and tp["p"] <= 1 - WF_NULL_Q,
                  ("p_continuous does not fall after ACh onset beyond its "
                   "shuffles", tp["diff"], tp["p"]))
    check(("p_continuous", "ACh_onset_NREM") in res, sorted(res))
    nrem = ach.turn_sleep_state_tsd_to_interval(
        prep_res["sleep_state_index"])["NREM"]
    t0 = time.perf_counter()
    dist = ach.feature_distance_vs_label_distance_analysis(
        prep_res, nrem, ach_onset=nap.Ts(a["onset_t"]),
        interval_key_l=("ACh_onset",), n_shuffles=200)
    sec["ach distance vs label (200 shuffles)"] = time.perf_counter() - t0
    for k, d in dist["dist_d"].items():
        check(np.isfinite(d).all(), ("distance matrix", k))
    log(f"workflows ach: {len(res)} (feature, event) analyses; "
        f"p_continuous after ACh onset: {'; '.join(lines)}; distance vs "
        f"label: {[(k, v.shape) for k, v in dist['dist_d'].items()]}")


def phase_workflows(launches):
    """The post-fit layer on the card's results, at full width: the T-maze
    workflow on a fit and decode of a 30 min session (N = 500, L = 100,
    T = 72,000) and the ACh workflow on a model selection's fits of a
    20 min sleep session (N = 500, L = 100, T = 120,000), each result
    computed from card tensors held equal to the same function on the host
    copies, the planted effects found, no NaN in a table.  Returns the
    phase's launch counts."""
    import importlib.util

    from poor_man_gplvm_tpu_torch import (  # noqa: F401
        pandas_util, plot_helper, plotting, workflows)
    from poor_man_gplvm_tpu_torch.utils import compat

    t_phase = time.perf_counter()
    sec, mine = {}, {}
    dec, t, _ = _wf_tmaze(sec, mine)
    _wf_ach(sec, mine)
    present = {lib: importlib.util.find_spec(lib) is not None
               for lib in WF_NOT_ON_CARD}
    if present["matplotlib"]:
        import tempfile

        nap = compat.timeseries_module()
        plotting.core._pyplot().switch_backend("Agg")
        with tempfile.TemporaryDirectory() as d:
            fig, _, _ = plotting.plot_pynapple_data_mpl({
                "posterior": nap.TsdFrame(d=dec["posterior_latent_marg"][
                    :4000].cpu().numpy(), t=t[:4000]),
                "p_jump": nap.Tsd(d=dec["posterior_dynamics_marg"][
                    :4000, 1].cpu().numpy(), t=t[:4000])},
                add_scatter_to_heatmap=True)
            path = plotting.save_fig(fig, "decode", d, fig_format=["png"],
                                     do_close=True)[0]
            log(f"workflows: plot_pynapple_data_mpl of the decode drawn "
                f"with Agg, {os.path.getsize(path)} bytes of PNG")
    else:
        log("workflows: matplotlib is not installed here: "
            "plot_pynapple_data_mpl not drawn (plotting is held on the CPU)")
    log("workflows: not called on the card: " + "; ".join(
        f"{', '.join(fns)} (need {lib}, "
        f"{'installed' if present[lib] else 'not installed'} here)"
        for lib, fns in WF_NOT_ON_CARD.items()))
    _merge(launches, mine)
    log(f"workflows launches (counted): {mine}")
    log("workflows stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sec.items()))
    log(f"workflows phase {time.perf_counter() - t_phase:.1f} s "
        f"({card_line()})")
    return mine


def _mem_predicted_peak(mode, T, n_dyn, L, N, chunk, marginal):
    """The peak bytes a sequential ``smooth_combined_chunked`` call should
    allocate above what was live before it (the spikes are the caller's),
    from what each mode keeps: the outputs (the log posterior (T, state),
    or its marginals), 'full''s filter posteriors, priors and
    log-likelihoods, 'filter''s store, and one chunk's working set (K1's
    post and prior, the log-likelihoods and weights, the (Tc, N) emission
    temporaries, then in the backward pass the chunk's filter rows, the
    shifted priors, K2's smooth and r and the pairwise joint's operand
    copies: ~6 (Tc, state) arrays)."""
    S = n_dyn * L
    Tc = min(chunk, T)
    state, c = 4.0 * T * S, 4.0 * Tc * S
    work = 6 * c + 2 * 4.0 * Tc * L + 3 * 4.0 * Tc * N
    out = 4.0 * T * (L + n_dyn) if marginal else state
    keep = {"full": 2 * state + 4.0 * T * L, "checkpoint": 0.0,
            "filter": state, "filter_bf16": state / 2}[mode]
    if mode == "full" and marginal:
        out = state + 4.0 * T * (L + n_dyn)
    return out + keep + work + 4.0 * T


def _mem_parity(launches, rows):
    """(a) The memory modes against 'full' at MEM_PARITY_T, N = L = MEM_NL,
    chunks of MEM_PARITY_CHUNK, on K1/K2 (``sequential_engine``); each
    mode's peak allocation beside the prediction; then K2 with the prior
    recomputed launched on the first chunk, the main path's launch shape,
    held against K2 on K1's priors and its forced-dense band there, and
    against its plain version on the chunk's last MEM_KERNEL_T rows (the
    scan runs from the last row down, so those rows depend only on its
    ``init`` and their own filter rows), and timed.  Fills ``rows`` with
    the kernels line's rows of the new mode."""
    from poor_man_gplvm_tpu_torch.ops import hmm
    from poor_man_gplvm_tpu_torch.ops import scan_kernels as sk
    from poor_man_gplvm_tpu_torch.testing import (SCAN_TOLERANCES, _max_rel,
                                                  memory_mode_peaks)

    T, NL, chunk = MEM_PARITY_T, MEM_NL, MEM_PARITY_CHUNK
    m, _, y = _decode_setup(NL, NL, T)
    trans = m._make_transition({})[0]
    counts = {}

    def run(mode):
        with counted(counts.setdefault(mode, {})):
            return hmm.smooth_combined_chunked(
                y, m.tuning, {}, trans, m.ma_neuron_default, None,
                n_time_per_chunk=chunk, engine="cuda", memory_mode=mode)

    with sequential_engine():
        hmm.smooth_combined_chunked(  # warm-up: the band, the libraries
            y[:chunk], m.tuning, {}, trans, m.ma_neuron_default, None,
            engine="cuda")
    res = memory_mode_peaks(run, ("full", "checkpoint", "filter",
                                  "filter_bf16"))
    outs, peaks = {}, {}
    n_chunks = -(-T // chunk)
    for mode, (peak, sec, out) in res.items():
        mine = counts[mode]
        _merge(launches, mine)
        want = {"full": (n_chunks, n_chunks, 0),
                "checkpoint": (2 * n_chunks - 1, n_chunks, 0),
                "filter": (n_chunks, 0, n_chunks),
                "filter_bf16": (n_chunks, 0, n_chunks)}[mode]
        got = (mine["filter_scan"], mine["smoother_scan"],
               mine["smoother_push_scan"])
        check(got == want and mine["pfilter_pass"] == 0,
              (f"memory mode {mode}: launches (K1, K2, K2 push) {got}, "
               f"expected {want} on K1/K2", mine))
        outs[mode] = out
        peaks[mode] = peak
        pred = _mem_predicted_peak(mode, T, 2, NL, NL, chunk, False)
        log(f"memory (a) {mode} T={T} N=L={NL}, {n_chunks} chunks of "
            f"{chunk} on K1/K2: {sec:.3f} s ({1e6 * sec / T:.3f} us a "
            f"step); peak {peak / 1e9:.3f} GB above the inputs, "
            f"predicted {pred / 1e9:.3f} GB; launches (K1, K2, K2 push) "
            f"{got}")
    del res
    full = outs["full"]
    for mode in ("checkpoint", "filter", "filter_bf16"):
        out = outs[mode]
        check(out[2] is None and out[5] is None,
              f"{mode} returned causal posteriors or log-likelihoods")
        check(float(out[1]) == float(full[1])
              and torch.equal(out[3], full[3]),
              f"{mode}: log marginal or ratios differ from full mode")
        err = float((torch.exp(out[0]) - torch.exp(full[0])).abs().max())
        if mode == "filter_bf16":
            check(err <= MEM_BF16_BOUND, (mode, err))
            log(f"memory (a) filter_bf16 against full: posteriors within "
                f"{err:.3e} (bound {MEM_BF16_BOUND:.3e}, bf16's rounding of "
                f"a probability), log marginal and ratios bit-equal")
        else:
            check(torch.equal(out[0], full[0]) and torch.equal(out[4],
                                                               full[4]),
                  (f"{mode}: posteriors or pairwise joint differ from full "
                   f"mode", err))
            log(f"memory (a) {mode} against full: posteriors, log marginal, "
                f"ratios and pairwise joint bit-equal")
    del outs, full, out

    # K2 with the prior recomputed, alone, on the first chunk
    n, k = chunk, MEM_KERNEL_T
    ll = hmm._loglik(y[:n + 1], m.tuning, {}, torch.broadcast_to(
        m.ma_neuron_default, (n + 1, NL)), m.ma_latent_default, "poisson")
    w, _ = sk._weights(ll, 1.0)
    p_init = torch.exp(trans.uniform_log_init())
    post, prior, _ = sk.filter_scan(w, trans.Tlat, trans.Tdyn, p_init,
                                    trans.uniform_rows)
    tlat, tdyn, flags = trans.Tlat, trans.Tdyn, trans.uniform_rows
    tlat_t = tlat.transpose(-1, -2).contiguous()
    band = hmm._cached_band(trans, tlat)
    dense = _forced_dense_band(tlat, tlat_t, flags)
    init = post[-1].contiguous()
    nnz = _nnz(tlat, flags)
    k2_ref = sk.smoother_scan(post[:-1].contiguous(),
                              prior[1:].contiguous(), tlat_t, tdyn, init,
                              flags, band=band)
    step_us = {}
    for dt_name, dtype, key in (("f32", torch.float32, "f32"),
                                ("bf16", torch.bfloat16, "bf16")):
        filt = post[:-1].to(dtype).contiguous()
        args = (filt, tlat, tlat_t, tdyn, init, flags)
        kern = lambda args=args: sk.smoother_push_scan(  # noqa: E731
            *args, band=band)
        sm, r = kern()
        sm_d, r_d = sk.smoother_push_scan(*args, band=dense)
        (sm_p, r_p), plain_ms = timed_once(
            lambda: sk.smoother_push_scan_plain(filt[n - k:], *args[1:]))
        err = float((sm[n - k:] - sm_p).abs().max())
        nxt = torch.cat([sm_p[1:], init[None]])
        r_rel = _max_rel(r[n - k:], r_p,
                         (prior[n - k + 1:] > 1e-30) & (nxt > 1e-30))
        same_dense = torch.equal(sm, sm_d) and torch.equal(r, r_d)
        check(err <= SCAN_TOLERANCES["smooth_abs"]
              and r_rel <= SCAN_TOLERANCES["r_rel"] and same_dense
              and bool(torch.isfinite(sm).all()),
              (f"K2 push [{dt_name}] against plain / dense", err, r_rel,
               same_dense))
        if dtype == torch.float32:
            check(torch.equal(sm, k2_ref[0]) and torch.equal(r, k2_ref[1]),
                  "K2 with the prior recomputed differs from K2 on K1's "
                  "priors")
        ms = cuda_ms(kern, 5)
        step_us[dt_name] = 1e3 * ms / n
        fb = 2 if dtype == torch.bfloat16 else 4
        S = 2 * NL
        b_ms, b_by = bound(n * S * (fb + 8) + 2 * 2 * NL * NL * 4,
                           n * 2.0 * 2 * nnz / F32_FLOP_PER_S)
        rows[f"smoother_push_scan[{key}]"] = dict(
            T=n, plain_T=k, max_abs_err=err, r_rel=r_rel, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None)
        log(f"time smoother_push_scan[{key}] (K2 with the prior recomputed, "
            f"{dt_name} store) T={n} n_dyn=2 L={NL}: kernel {ms:.3f} ms "
            f"({1e3 * ms / n:.3f} us a step), plain {plain_ms:.1f} ms on the "
            f"last {k} rows, bound {b_ms:.4f} ms ({b_by}); max |kernel - "
            f"plain| {err:.3e}, r rel {r_rel:.2e} on those {k}; band = "
            f"forced dense bit for bit"
            + ("; = K2 on K1's priors bit for bit"
               if dtype == torch.float32 else ""))
    k2_ms = cuda_ms(lambda: sk.smoother_scan(
        post[:-1].contiguous(), prior[1:].contiguous(), tlat_t, tdyn, init,
        flags, band=band), 5)
    log(f"time smoother_scan (K2 on K1's priors) at the same rows: "
        f"{k2_ms:.3f} ms ({1e3 * k2_ms / n:.3f} us a step)")
    plan = sk.push_plan(2, 1, NL, band.W, False)
    log(f"memory (a) per step at L={NL}, n_dyn=2, W={band.W}: K2 with the "
        f"prior recomputed {step_us['f32']:.3f} us (f32 store), "
        f"{step_us['bf16']:.3f} us (bf16 store) against K2 on stored priors "
        f"{1e3 * k2_ms / n:.3f} us ({step_us['f32'] / (1e3 * k2_ms / n):.3f}x"
        f"); a cluster of {plan['cluster']} blocks of {plan['threads']} "
        f"threads, {plan['stages']} ring stages, {plan['smem']} bytes of "
        f"shared memory a block ({card_line()})")
    del m, y, post, prior, w, ll
    return peaks["full"] / T


def _mem_init_posterior(T, L, seed):
    """The fit's initial log posterior (T, L), drawn on the card as the
    model's ``init_latent_posterior`` draws on the host (uniform * 0.1,
    normalised, log): at T = MEM_T the host draw and its copy are 8.6 GB."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    post = torch.rand((T, L), generator=g, device="cuda")
    post.div_(post.sum(dim=1, keepdim=True))
    return post.log_()


def _mem_long(launches, full_per_step):
    """(b) The long recording: T = MEM_T, N = L = MEM_NL, spikes drawn on
    the card from a seeded generator; the parallel gate's and full mode's
    estimates against the card's free memory; a lean ``fit_em`` of
    MEM_FIT_ITERS iterations (Adam capped) whose E-steps run 'checkpoint'
    on K1/K2; then ``smooth_combined_chunked(memory_mode='filter',
    marginal_smooth=True)`` on the fitted model, its latent marginal bit
    for bit the last E-step's.  ``full_per_step``: (a)'s measured peak of
    full mode per step, above its inputs."""
    from poor_man_gplvm_tpu_torch.ops import hmm

    T, NL = MEM_T, MEM_NL
    m = _model(NL, NL, "auto")
    check(m.inference_engine == "cuda", m.inference_engine)
    g = torch.Generator(device="cuda").manual_seed(MEM_SEED)
    y = torch.empty((T, NL), device="cuda")
    for a in range(0, T, 500_000):  # Poisson(0.5), bench.py's north-star
        y[a:a + 500_000] = torch.poisson(
            torch.full((min(500_000, T - a), NL), 0.5, device="cuda"),
            generator=g)
    trans = m._make_transition({})[0]
    S = 2 * NL
    free = hmm._device_free_bytes(torch.device("cuda"))
    par = hmm._parallel_buffer_bytes(T, NL, 2)
    rule = hmm._full_mode_bytes(T, S, NL)
    chunk = hmm.auto_chunk_size(T, S, NL, "cuda")
    n_chunks = -(-T // chunk)
    full = _mem_predicted_peak("full", T, 2, NL, NL, chunk, True)
    scaled = full_per_step * T
    auto = hmm._resolve_memory_mode("auto", T, S, NL, "cuda")
    log(f"memory (b) T={T} (12 h of 10 ms bins) N=L={NL}: spikes on the card "
        f"{4 * T * NL / 1e9:.2f} GB; free {free / 1e9:.2f} GB; parallel "
        f"engine's buffers {par / 1e9:.2f} GB (gate: 3/4 of free, "
        f"{0.75 * free / 1e9:.2f}); full mode: the 'auto' rule's working "
        f"set {rule / 1e9:.2f} GB, its predicted peak above the spikes "
        f"{full / 1e9:.2f} GB, (a)'s measured peak per step x T "
        f"{scaled / 1e9:.2f} GB; 'auto' resolves to {auto!r}; chunks of "
        f"{chunk} ({n_chunks})")
    check(par > free and full > free and scaled > free,
          ("the parallel engine and full mode must not fit", par, full,
           scaled, free))
    check(not hmm.engine_resolves_parallel(T, trans, "cuda", "cuda")
          and auto == "checkpoint", "the long recording's engine and mode")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mine = {}
    with counted(mine):
        sec, em = wall_s(lambda: m.fit_em(
            y, n_iter=MEM_FIT_ITERS, output_mode="lean", verboase=False,
            log_posterior_init=_mem_init_posterior(T, NL, MEM_SEED + 1),
            m_step_maxiter=MEM_FIT_MAXITER, profile=True))
    peak = torch.cuda.max_memory_allocated()
    _merge(launches, mine)
    lml = [float(v) for v in em["log_marginal_l"]]
    check(all(np.isfinite(lml)) and all(b >= a for a, b in zip(lml, lml[1:])),
          ("lean fit log marginals", lml))
    want = (MEM_FIT_ITERS * (2 * n_chunks - 1), MEM_FIT_ITERS * n_chunks)
    got = (mine["filter_scan"], mine["smoother_scan"])
    check(got == want and mine["pfilter_pass"] == 0
          and mine["smoother_push_scan"] == 0,
          ("the lean fit's E-steps must run 'checkpoint' on K1/K2", got,
           want, mine))
    e_step = em["profile"]["e_step"]
    pred = _mem_predicted_peak("checkpoint", T, 2, NL, NL, chunk, True)
    log(f"memory (b) lean fit_em {MEM_FIT_ITERS} iterations (Adam capped at "
        f"{MEM_FIT_MAXITER}; initial posterior drawn on the card: the host "
        f"draw is {4 * T * NL / 1e9:.1f} GB): {sec:.1f} s; E-steps "
        f"'checkpoint' on K1/K2 {[round(s, 2) for s in e_step]} s "
        f"({e_step[-1] / 3:.2f} s a pass, {1e6 * e_step[-1] / (3 * T):.3f} "
        f"us a step-pass); M-steps "
        f"{[round(s, 2) for s in em['profile']['m_step']]} s; log_marginal_l "
        f"{lml}; peak {peak / 1e9:.2f} GB in all ({(peak - base) / 1e9:.2f} "
        f"above the spikes; an E-step predicted {pred / 1e9:.2f}), against "
        f"{(scaled + 4 * T * NL) / 1e9:.2f} GB for full mode with the "
        f"spikes ((a)'s per step x T); launches (K1, K2) {got}")
    post_fit = em["posterior"]
    del em

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mine = {}
    with counted(mine):
        sec, out = wall_s(lambda: hmm.smooth_combined_chunked(
            y, m.tuning, {}, trans, m.ma_neuron_default, None,
            engine="cuda", memory_mode="filter", marginal_smooth=True))
    peak = torch.cuda.max_memory_allocated() - base
    _merge(launches, mine)
    got = (mine["filter_scan"], mine["smoother_push_scan"])
    check(got == (n_chunks, n_chunks) and mine["smoother_scan"] == 0
          and mine["pfilter_pass"] == 0,
          ("the 'filter' decode must run K1 and K2 with the prior "
           "recomputed", mine))
    lat = torch.exp(out[0][0])
    same = torch.equal(lat, post_fit)
    err = float((lat - post_fit).abs().max())
    check(same, ("the 'filter' latent marginal differs from the last "
                 "'checkpoint' E-step's", err))
    check(bool(torch.isfinite(out[0][1]).all()) and out[0][1].shape == (T, 2),
          "dynamics marginal")
    pred = _mem_predicted_peak("filter", T, 2, NL, NL, chunk, True)
    log(f"memory (b) smooth_combined_chunked memory_mode='filter', "
        f"marginal_smooth: {sec:.1f} s ({sec / 2:.2f} s a pass); latent "
        f"marginal bit-equal to the last E-step's 'checkpoint' one; peak "
        f"{peak / 1e9:.2f} GB above its inputs (predicted "
        f"{pred / 1e9:.2f}); launches (K1, K2 push) {got}")
    del out, lat, post_fit, y


def _mem_oom(launches):
    """(c) The out-of-memory retry at the north-star shape (T = NS_T, N =
    L = NS_N, the default engine: K3/K4): one ``decode_latent`` whose first
    parallel solve finds the card filled by an allocation made after the
    gate read free memory (held by the solve's own frame, so that the
    retry's ``gc.collect``/``empty_cache`` return it), recovered once
    under the lean config with the warning, equal to an unforced decode
    under that config and within the decode tolerances of the default
    one; a second out-of-memory error raises with the guidance.  Also
    the peak of a decode with and without the lean config.  The retried
    decode's launches count with the main path's ``launches``."""
    import warnings

    from poor_man_gplvm_tpu_torch.models import base as mbase
    from poor_man_gplvm_tpu_torch.ops import parallel_scan as ps

    T, NL = NS_T, NS_N
    m = _model(NL, NL, "auto")
    g = torch.Generator(device="cuda").manual_seed(MEM_SEED + 2)
    y = torch.poisson(torch.full((T, NL), 0.5, device="cuda"), generator=g)
    real = ps.smooth_parallel
    fill = {"calls": set()}

    def filled(*a, **k):
        fill["n"] = fill.get("n", 0) + 1
        hold = None
        if fill["n"] in fill["calls"]:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            hold = torch.empty(  # noqa: F841 (held until the frame ends)
                int(torch.cuda.mem_get_info()[0] - 2e9), dtype=torch.uint8,
                device="cuda")
        return real(*a, **k)

    peaks, res = {}, {}
    for name, cfg in (("default", None), ("lean", mbase._LEAN_SCAN_CONFIG)):
        ps.set_config_override(cfg)
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            sec, res[name] = wall_s(lambda: m.decode_latent(y))
            peaks[name] = (torch.cuda.max_memory_allocated() - base, sec)
        finally:
            ps.set_config_override(None)
    log(f"memory (c) decode_latent T={T} N=L={NL} (K3/K4): peak "
        f"{peaks['default'][0] / 1e9:.2f} GB at C=128, "
        f"{peaks['lean'][0] / 1e9:.2f} GB under the lean config "
        f"{mbase._LEAN_SCAN_CONFIG} (C=64): the override alone saves "
        f"{(peaks['default'][0] - peaks['lean'][0]) / 1e9:.3f} GB; "
        f"{peaks['default'][1]:.3f} / {peaks['lean'][1]:.3f} s")
    ps.smooth_parallel = filled
    try:
        fill.update(n=0, calls={1})
        mine = {}
        with warnings.catch_warnings(record=True) as caught, counted(mine):
            warnings.simplefilter("always")
            sec, got = wall_s(lambda: m.decode_latent(y))
        _merge(launches, mine)
        msgs = [str(w.message) for w in caught
                if "lean parallel-scan config" in str(w.message)]
        check(fill["n"] == 2 and len(msgs) == 1
              and ps._CONFIG_OVERRIDE is None,
              ("the out-of-memory retry", fill["n"], msgs))
        check(mine["pfilter_pass"] > 0 and mine["psmooth_pass"] > 0
              and mine["filter_scan"] == 0,
              ("the retried decode must run K3/K4", mine))
        same = all(torch.equal(got[k], res["lean"][k]) if torch.is_tensor(
            got[k]) else got[k] == res["lean"][k] for k in res["lean"])
        err = float((got["posterior_all"]
                     - res["default"]["posterior_all"]).abs().max())
        lmf = abs(got["log_marginal_final"]
                  - res["default"]["log_marginal_final"]) / abs(
                      res["default"]["log_marginal_final"])
        check(same and err <= DECODE_POST_ATOL and lmf <= DECODE_LMF_RTOL,
              ("the retried decode", same, err, lmf))
        log(f"memory (c) out-of-memory on the first solve (the card filled "
            f"after the gate read it): warned {msgs[0][:60]!r}..., retried "
            f"once under {mbase._LEAN_SCAN_CONFIG}, override restored; "
            f"{sec:.2f} s on K3/K4 (launches K3 {mine['pfilter_pass']}, K4 "
            f"{mine['psmooth_pass']}); every key bit-equal to an unforced "
            f"decode under "
            f"the lean config, posteriors {err:.2e} and log marginal "
            f"{lmf:.2e} from the default one")
        del got
        fill.update(n=0, calls={1, 2})
        raised = None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                m.decode_latent(y)
            except torch.cuda.OutOfMemoryError as e:
                raised = str(e)
        check(raised is not None and "set_config_override" in raised
              and "memory_mode='checkpoint'" in raised
              and ps._CONFIG_OVERRIDE is None and fill["n"] == 2,
              ("a second out-of-memory error must raise with the guidance",
               raised and raised[-200:]))
        log("memory (c) a second out-of-memory error raises "
            "torch.cuda.OutOfMemoryError with the knob ladder; override "
            "restored")
    finally:
        ps.smooth_parallel = real
    del res, y, m


def phase_memory(launches):
    """Recordings longer than the card holds: (a) the memory modes against
    full mode, (b) the 12-hour recording's lean fit and 'filter' decode,
    (c) the out-of-memory retry.  Returns the kernels line's rows of K2
    with the prior recomputed."""
    t0 = time.perf_counter()
    rows = {}
    full_per_step = _mem_parity(launches, rows)
    _mem_long(launches, full_per_step)
    _mem_oom(launches)
    log(f"memory phase {time.perf_counter() - t0:.1f} s ({card_line()})")
    return rows


def main():
    t_start = time.perf_counter()
    phase_preamble()
    from poor_man_gplvm_tpu_torch.testing import scan_case

    phase_build()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{name} phase {time.perf_counter() - t0:.1f} s")
        return out

    worst, times, batch_rows = timed("kernels", phase_kernels)
    pworst, rows = timed("parallel kernels", phase_pscan_kernels)
    rng_rows = timed("rng", phase_rng)
    launches = {}
    timed("slice", phase_slice, launches)
    timed("epochs", phase_epochs, launches)
    timed("crossover", phase_crossover)
    timed("long decode", phase_long_decode, launches)
    timed("fit", phase_fit, launches)
    timed("north-star", phase_northstar, launches)
    precision_rows = timed("precision", phase_precision, launches)
    ndyn1, ndyn1_rows = timed("families", phase_families, launches)
    session_rows = timed("session", phase_session, launches)
    selection_rows = timed("selection", phase_selection, launches)
    compat_rows = phase_compat(launches)
    mesh_rows = phase_mesh(launches)
    pipeline_rows = phase_pipeline(launches)
    workflow_launches = phase_workflows(launches)
    memory_rows = phase_memory(launches)
    log(f"main-path launches: {launches}")
    path = {name: _path_launches(launches, name) for name in KERNELS}
    path.update({name: launches.get(name, 0) for name in rng_rows})
    path["adam_poisson_trip"] = launches.get("adam_poisson_trip", 0)
    check(all(n > 0 for n in path.values()), path)
    card = card_line()
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": path[name]}
        if _path_launches(workflow_launches, name):
            entry["launches_workflows"] = _path_launches(workflow_launches,
                                                         name)
        if name in precision_rows:
            entry.update(precision_rows[name])
            entry["note"] = ("XLA's product on the TPU, not a Pallas kernel; "
                             "replaces names its first site")
            entry["shape"] = (
                f"the north-star emission y ({NS_T}, {NS_N}) @ (log "
                f"lam).T ({NS_N}, {NS_L}), a transposed view; *_statistics "
                f"one statistics chunk post.T ({NS_L}, {PREC_T_STATS}) read "
                f"in place @ y; *_batched the sweep's statistics, "
                f"{PREC_SWEEP[0]} runs of {PREC_SWEEP[1]} rows; "
                "library_ms: torch.mm on bf16 copies with f32 output "
                "('default'), the f32 torch.matmul of 'highest' ('high')")
            kernels.append(entry)
            continue
        if name in memory_rows:
            entry.update(memory_rows[name])
            entry["shape"] = (
                f"the first {MEM_PARITY_CHUNK}-row chunk of the memory "
                f"phase's (a) recording's filter posteriors (K1's), stored "
                f"in {'bf16' if 'bf16' in name else 'f32'}, n_dyn=2 (one RBF "
                f"channel, ls=1, and the jump channel), L={MEM_NL}, as the "
                f"main path launches it once per chunk in (a) (in (b) on "
                f"auto_chunk_size's rows at T={MEM_T}); the plain version "
                f"on its last plain_T rows")
            kernels.append(entry)
            continue
        if name in mesh_rows:
            entry.update(mesh_rows[name])
            entry["shape"] = (
                f"a time shard of the mesh phase's (1, 4, 1) decode, "
                f"T={-(-MESH_T // 4)} rows, n_dyn=2 (one RBF channel, ls=1, "
                f"and the jump channel), L={MESH_NL}: K3 at n_valid = the "
                f"shard's real rows ({MESH_T - 3 * (-(-MESH_T // 4))}), K4 at "
                f"n_valid = T + 1 (every row recurses, as on the shards "
                f"before the last)")
            kernels.append(entry)
            continue
        if name in selection_rows:
            entry.update(selection_rows[name])
            entry["shape"] = (
                "the sweep fan-out's first batch cut to E runs, one per "
                "band width (W = 11, 21, 41, 81, padded to 81), of `steps` "
                f"rows in all, n_dyn=2, L={SEL_NL}; ms_band_* K1 on the "
                "W=21 runs alone and padded, at T=10,000")
            kernels.append(entry)
            continue
        for L in (100, 500):
            sfx = "" if L == 100 else "_L500"
            if name in batch_rows[L]:
                row = dict(batch_rows[L][name], err=max(
                    worst[name], batch_rows[L][name]["err"]))
                for key in ("E", "steps"):
                    entry[f"{key}{sfx}"] = row[key]
                for key, v in row.get("all", {}).items():
                    key = "max_abs_err" if key == "err" else key
                    entry[f"{key}_all{sfx}"] = v
                shape_T = None
            elif name in ("filter_scan", "smoother_scan"):
                ms, plain_ms = times[L][name]
                b_ms, b_by = kernel_bound(name, T_DECODE, L, 2, int(
                    np.count_nonzero(scan_case(L, 2, L, 2, "jump")["tlat"][0])))
                row = dict(err=worst[name], ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
                row.update(times[L].get(f"{name}_dense", {}))
                shape_T = T_DECODE
            else:
                row = rows[L][name]
                shape_T = T_LONG
            if row.get("probe_ms") is not None:
                entry[f"probe_ms{sfx}"] = row["probe_ms"]
            entry.update({
                f"max_abs_err{sfx}": row["err"], f"ms{sfx}": row["ms"],
                f"plain_ms{sfx}": row["plain_ms"],
                f"bound_ms{sfx}": row["bound_ms"],
                f"bound_by{sfx}": row["bound_by"],
                f"library_ms{sfx}": row["library_ms"],
            })
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"):
            if f"{key}_L500_dense" in row:
                entry[f"{key}_L500_dense"] = row[f"{key}_L500_dense"]
        if name in session_rows:
            # on the circular-shuffle null's first batch
            entry.update({f"{k}_session": v
                          for k, v in session_rows[name].items()})
        if name in compat_rows:
            # on the reactivation null's first batch
            entry.update({f"{k}_reactivation": v
                          for k, v in compat_rows[name].items()})
        if name in pipeline_rows:
            # on the session pipeline's bursts (one batch)
            entry.update({f"{k}_pipeline": v
                          for k, v in pipeline_rows[name].items()})
        if name in NDYN1_KERNELS:
            # the same kernel at n_dyn = 1, on a latent-only model's inputs
            entry["launches_ndyn1"] = _path_launches(ndyn1, name)
            for L in (100, 500):
                sfx = "_ndyn1" + ("" if L == 100 else "_L500")
                r1 = ndyn1_rows[L][name]
                entry.update({
                    f"max_abs_err{sfx}": r1["err"], f"ms{sfx}": r1["ms"],
                    f"plain_ms{sfx}": r1["plain_ms"],
                    f"bound_ms{sfx}": r1["bound_ms"],
                    f"bound_by{sfx}": r1["bound_by"],
                    f"library_ms{sfx}": r1["library_ms"]})
        entry["shape"] = (
            "a batch of E sequences of `steps` rows in all, one thread "
            "block each, n_dyn=2 (one RBF channel, ls=1, and the jump "
            "channel): a batch the epochs phase launches, all E epochs of "
            "its cell at L=100 and, *_L500, the first batch of its "
            "batch_size run at L=500, *_all_L500 the launch over all its "
            "epochs (timed; held on that first batch's epochs); *_session "
            "the first batch "
            "of the session's dynamics null (E shuffles of "
            f"{SESSION_T_NULL} bins, L={SESSION_NL}; the plain version on "
            "its first plain_E_session); *_reactivation the "
            "reactivation null's first batch cut to E shuffles of "
            f"{COMPAT_T_EP} bins, L={SESSION_NL}; *_pipeline the session "
            f"pipeline's bursts (E epochs, L={PIPE_L}); each held against "
            "plain"
            if shape_T is None else
            f"T={shape_T} n_dyn=2 (one RBF channel, ls=1, and "
            "the jump channel) L=100; *_L500 at L=500; *_L500_dense on a "
            "dense channel (K1, K2: the band forced dense); probe_ms* with "
            "the band cut to one row (joint_acc: one TF32 product)")
        kernels.append(entry)
    for name, row in rng_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "poor_man_gplvm_tpu_torch/csrc/mt19937.cu",
            "replaces": None, "launches": path[name], **row})
    kernels.append({
        "name": "adam_poisson_trip", "route": "cuda",
        "source": "poor_man_gplvm_tpu_torch/csrc/adam_poisson.cu",
        "replaces": None, "launches": path["adam_poisson_trip"],
        **selection_rows["adam_poisson_trip"]})
    log(f"K3/K4 grid, worst kernel-vs-plain by precision: "
        f"{ {f'{p}/{k}': v for (p, k), v in pworst.items()} }")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
