#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--phases NAME[,NAME...] | list]

Run from the root of a checkout on a machine with a CUDA GPU, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch. It imports nothing
of JAX or of the JAX package. With no ``--phases`` it runs every phase;
``--phases`` runs the card, the build and the named phases only
(``PHASES``; ``faults`` brings ``main`` along) and prints no ``kernels``
line. Phases, each fatal on failure:

1. the card: ``nvidia-smi``'s name and power limit;
2. build: every kernel of the port from ``fedtorch_tpu_torch/csrc``;
3. kernels vs plain, each kernel against its plain PyTorch version on
   the card — within one quantization step per element, bitwise on
   exact-sum inputs, the same NaN pattern — and timed (CUDA graphs of
   back-to-back launches, CUDA events, median of repeats):
   - the ragged pair (stats + apply, one launch of each per tree call)
     at the row-path trees of all three main paths (every leaf of at
     most 524,288 elements: ``[10, n]`` uplink and ``[1, n]`` downlink
     leaves), int8 and int16, plus edge trees (rows of 1, 10 and 86
     elements that put later rows off 16-byte alignment, NaN in a first
     chunk, inf in a middle one, -inf in a ragged last one, a constant
     row, NaN in a dyadic tree, and a tree of more leaves than one
     launch's table holds); timed per round of each path (the uplink
     and the downlink call), inputs rotating over at least 128 MB, with
     ResNet-20 also hot in L2, and the whole tree function on each
     path's payload;
   - the multi-block pair (stats + apply) at the 3 uplink and 3
     downlink bucket shapes of a WideResNet-28-10 payload past 524,288
     elements, int8 and int16, plus edge rows (NaN in the first chunk,
     inf in a middle one, -inf in a ragged last one, a constant row,
     rows that are not 16-byte aligned, one chunk); its inputs rotate
     over at least 128 MB so that each launch reads device memory;
   - the single-tensor entry at n = 1, 4,097, 272,474, 524,288 (the
     ragged pair on one row) and 524,289 (the tiled pair);
   - the flash attention forward against its plain version (TF32 off) on
     strided q, k, v views of one projection, bfloat16 and float32, each
     case through the kernel ``_route`` picks (the wgmma kernel for aligned
     bfloat16 at head dim 64, 128, 192, 256 or 512, the TF32 kernel
     otherwise) and checked to have taken it: each kernel at the shape its
     transformer path gives it ((8, 2048, 4, 64) bfloat16 and float32,
     (8, 2048, 4, 128) bfloat16, (8, 2048, 4, 256) and (8, 2048, 4, 512)
     bfloat16 and float32) causal and not; the wgmma kernel at D 64, 128,
     192, 256 and 512, T in {1, 63, 65, 300, 2048}, causal and not; both
     dtypes at D in {16, 24, 25, 32, 64, 100, 128} and T in {1, 50, 257,
     2048}, causal and not, and at ``FLASH_WIDE_DIMS`` (the kernels'
     instances past 128, and past 256 the TF32 kernel's clusters of 2 to
     4 CTAs and its chunked kernel past 2048, the wgmma kernel's D-512
     cluster; each cluster's size and cudaOccupancyMaxActiveClusters
     logged first) and T in {1, 129, 2048}, causal
     and not; misaligned views; a NaN q row with a +inf k row and a -inf
     k element whose scores stay -inf beside scores that overflow exp
     unless the running max is kept (D 64, 256, 384 and 512); +inf and
     -inf v elements in both dtypes (the wgmma kernel at D 64, 128, 256
     and 512, the TF32 kernel at 64, 256, 384 and 512, past 256 one in a
     second CTA's columns; causal and not), o +-inf where p > 0 meets them
     and NaN where the plain version computes 0 inf or inf - inf. lse and
     float32 o within atol = rtol = 2e-5, bfloat16 o within one bfloat16
     spacing past that bar, the NaN and +-inf patterns identical. Timed
     (inputs rotating over at least 128 MB) against the plain version: the
     wgmma kernel at (8, 2048, 4, D) bfloat16, D in {64, 128, 256, 512},
     against ``F.scaled_dot_product_attention`` at each head dim (the
     backend it took named); the TF32 kernel at (8, 2048, 4, 64) in
     float32 (against float32 SDPA, TF32 off, against the 3xTF32 bound,
     the smaller of it and the CUDA-core float32 bound) and in bfloat16
     (its launcher, as the route would pick the wgmma kernel), and at
     (8, 2048, 4, 25), (8, 2048, 4, 256) and (8, 2048, 4, 512) in float32
     (the default width's heads and heads of 256 and 512, against float32
     SDPA); the wgmma kernel's non-finite-v pre-pass alone at its four
     main-path head dims;
4. reference: a float32 ResNet-20 forward, one quantized ResNet-8 round
   and one quantized WideResNet-16-4 round (whose stage-3 convs go
   through the pair) on the card against the same on the CPU (TF32
   off), the CPU path being the one the tests hold against the JAX
   package. Each round's wire format is held within one step of the
   CPU's on the card's own payloads. Its update is held within
   ``order_spread.SPREAD_FACTOR`` times what float32 order alone moves
   it (``fedtorch_tpu_torch/tools/order_spread.py`` says why): at
   WideResNet-16-4 the CPU's own spread over other orders, measured in
   the same run; at ResNet-8, where one or two ReLU flips set the gap,
   the largest gap between CPU orders over 64 seeds. Then two float32
   transformers (2 layers, T 256, flash): d_model 64 (4 heads of 16) and
   the default width, ``rnn_hidden_size`` 50 (d_model 100, 4 heads of
   25): logits and one FedAvg round, the card (the kernel) against the
   CPU (the plain version), each within 1e-4; float32, so the card must
   take the TF32 kernel once per layer;
5. main path: the north-star round at full width through the library
   entry points (``define_model`` -> ``make_algorithm`` ->
   ``FederatedTrainer`` -> ``init_state`` -> ``run_rounds``): quantized
   FedAvg, ResNet-20 in bfloat16, 100 clients x 250 CIFAR-10-shaped
   samples made from ``--seed``, k = 10, batch 50, 10 local steps, flip
   and crop augmentation; 1 warm-up round, then ``TIMED_ROUNDS`` timed
   round(s). The launch counters are set to 0 just before and must read
   2 ragged stats and 2 ragged apply launches per round after;
6. profile: one more main-path round under ``torch.profiler`` — the
   device's busy share and its time by kernel (another round, up to
   three in all, if the profiler lost the records of the round's
   quantizer launches);
6b. stream: the main path's round on the stream data plane. The
   population (100 clients x 250 samples from ``--seed``) is written
   with ``save_client_store`` into a temporary directory (bytes and
   seconds logged); then from one seed, with cuDNN deterministic,
   ``resident`` twice (its own spread), ``stream_ram``,
   ``stream_mmap``, ``stream_mmap_scan`` (one timed ``run_rounds(2)``:
   a window of 2, no warm-up) and ``stream_mmap_depth1`` (producer depth
   1, 3 rounds back to back), each 1 warm-up and 1 timed round but the
   last two. Every feed a
   stream path consumes is held bitwise against a fresh host gather of
   its plan copied over synchronously (the pinned-buffer race check);
   each of the first three stream paths' server params after its 2
   rounds within ``SPREAD_FACTOR`` times the resident runs' gap (0:
   bitwise) of ``resident``'s, its generator state bitwise; 2 + 2
   ragged launches a round on every path; round ms beside
   ``resident``'s, ``stream_stats`` a round (gather, H2D, wait), the
   feed's bytes, and the device memory held for data (at construction,
   and after the rounds with the producer's queue full);
7. cli: the port's program as a user runs it,
   ``fedtorch_tpu_torch.cli.main`` on ``CLI_ARGV`` (the north-star
   round: ResNet-20, 100 clients, k = 10, batch 50, 10 local steps,
   int8 both ways, bf16, 2 rounds, the test set evaluated every round)
   with ``-p`` a temporary directory holding CIFAR-10 python-pickle
   files of random pixels and labels made from ``--seed`` (50,000
   training and 10,000 test images, ~184 MB) and ``-c`` a directory
   beside them for the run's log. The counters must read 2 ragged stats
   and 2 ragged apply launches per round; the results dict must hold 3
   rounds and a finite test and best top-1 in [0, 1]; the final server
   params evaluated in float32 on the first 1,024 test images on the
   card (TF32 off) and on the CPU must agree within ``CLI_EVAL_BAR``.
   Prints the data-build seconds, round ms, eval ms per call and top-1.
   Then ``CLI_ARGV`` on the stream plane, ``--data_plane stream
   --data_store mmap`` from a store written with ``save_client_store``
   from the same files: 2 + 2 ragged launches a round, the device-plane
   run's round-0 cohort, finite loss lines. Then ``CLI_ARGV`` with
   ``--federated_type apfl`` (adaptive alpha, 2
   rounds): 2 + 2 ragged launches a round and a finite
   ``validation_personal`` line a round in its log. Then ``CLI_ARGV``
   with ``--client_fusion fused`` for ``CLI_FUSED_ROUNDS`` rounds on the
   same files: 2 + 2 ragged launches a round, the device-plane run's
   round-0 cohort, finite loss lines (reported in the fusion line);
8. zoo: every algorithm beyond FedAvg on the north-star round at full
   width through the library entry points (ResNet-20, bf16, 100 clients
   x 250 samples from ``--seed``, k = 10, batch 50, 10 local steps, flip
   and crop): SCAFFOLD (momentum off), FedGATE dense, FedCOMGATE (FedGATE
   with int8 uplink and downlink through the ragged pair), Qsparse at
   the CLI's default ratio, qFFL at q = 1, AFL (its one local step),
   DRFA over FedAvg, and on 200 train and 50 val rows a client APFL
   (adaptive alpha), ``apfl_q`` (APFL with int8 both ways), PerFedMe (lr
   0.05) and PerFedAvg; 1 timed round each (no warm-up: the main path
   warmed ResNet-20's kernels), the counters
   set to 0 just before each and read just after (2 + 2 ragged launches
   a round on FedCOMGATE and ``apfl_q``, none elsewhere); finite losses
   and aux trees, moved server params, AFL's and DRFA's lambda on the
   simplex within 1e-6; the personalized paths' ``evaluate_personal``
   once, timed, finite, APFL's online alpha one value in [0, 1]. Then
   each algorithm (and top-k FedGATE, DRFA over FedGATE and over
   SCAFFOLD) one round card vs CPU on an MLP (float32, TF32 off, the
   same plan): the update's and each aux tree's relative L2 (and the
   ``evaluate_personal`` summary) within ``ZOO_CARD_BAR``; and a
   quantized FedCOMGATE ResNet-8 round held as the reference phase
   holds quantized FedAvg's;
8b. localsgd: ``LocalSGDTrainer.fit`` (``build_local_sgd``) on the zoo's
   data pooled over 10 ResNet-20 workers, all online, 10 local steps of
   batch 50 a round (iteration mode: 2 rounds, the second timed), cuDNN
   deterministic, no kernel launched; finite losses, moved params; the
   hashes of each rank's workers' rows at two ranks, which the
   ``podscale`` phase's ``localsgd_W2`` is held to;
8c. tasks: the federated tasks through the library entry points
   (``define_model`` -> ``make_algorithm`` -> ``FederatedTrainer`` ->
   ``run_rounds`` -> ``evaluate``), int8 both ways, k = 10, batch 50, 10
   local steps, data from ``--seed`` (``TASK_PATHS``): ``cnn_mnist`` (the
   LeNet ``cnn``, FedAvg, 10 clients IID all online, float32, 28x28x1),
   ``cnn_cifar`` (100 clients, bf16, 32x32x3: its ``Dense_0`` kernel of
   640,000 elements takes the tiled pair), ``rnn_shakespeare`` (the
   char-GRU, vocab 86, hidden 50, windows of 50 from text that the port's
   window encoder turns into tokens and next-character labels, 100
   characters, float32), ``mlp_emnist_apfl`` and ``mlp_emnist_drfa``
   (an MLP of width 200 on 500 EMNIST-shaped writers of 50-150 rows:
   APFL at alpha 0.5 on the val split, DRFA at gamma 0.1). Each path: its
   round cut to 4 clients and 2 steps card vs CPU (TF32 off; the card's
   wire format within one step of the plain version on its payloads, the
   update within ``TASK_CARD_FLOOR`` or ``SPREAD_FACTOR`` times the CPU's
   own order spread, which for the bf16 path includes the round in
   float32); then 1 warm-up and 1 timed round with the counters set to 0
   just before and read just after (2 + 2 ragged a round, and 2 + 2 tiled
   on ``cnn_cifar``, from the leaf buckets), metrics of
   ``[2, metrics_width]``, finite losses, and ``evaluate`` on 1,000 test
   rows (the rnn's from a fresh carry per batch). Then ``cli_tff``: TFF
   HDF5 files written here and read back through the CLI (``-d
   shakespeare -a rnn``, ``-d emnist -a cnn``; 2 quantized rounds), or,
   where ``import h5py`` fails, ``"not run: no h5py"``;
8d. models: the rest of the model zoo and the robust rules.
   ``densenet_bc100_main_path``: quantized FedAvg (int8 both ways) on
   DenseNet-BC-100 (growth 12, compression 0.5; 769,162 params in 299
   leaves), bf16, the north-star round (100 clients x 250 samples from
   ``--seed``, k = 10, batch 50, 10 local steps): its round cut by
   ``DENSENET_CARD_CUT`` card vs CPU as a bf16 tasks path is held, then 1
   warm-up, 1 timed and 1 profiled rounds, 2 + 2 ragged launches a round
   (2,990 uplink rows in one launch of each kernel) and no tiled one;
   round ms, local steps/s, device busy share, launches a local step and
   peak MiB. ``resnet18_imagenet``: the ImageNet ResNet-18 class built
   directly, a float32 forward and one local step at (50, 224, 224, 3)
   card (TF32 off) vs CPU within ``SPREAD_FACTOR`` times the CPU's NCHW
   spread (never tighter than ``MODELS_CARD_BAR``), and one uplink tree
   call on its params (k = 10): 1 + 1 ragged and 3 + 3 tiled launches,
   each row within one step of the plain version. ``resnet20_gn``,
   ``resnet20_matmul_conv`` and ``wrn16_4_dropout_0.3``: one small
   quantized round each held card vs CPU as the reference phase holds
   its rounds (the dropout round's CPU runs replay the card's masks),
   and the im2col conv timed against the native conv (a ResNet-20 local
   step at batch 50, bf16). ``robust_logistic_regression``: its cut
   round card vs CPU, a round, then ``evaluate`` with the noise ascent
   card vs CPU within ``MODELS_CARD_BAR``. ``robust_agg``: a guarded
   quantized ResNet-20 round per rule of ``ROBUST_RULES`` (8 clients, k
   = 4), each held card vs CPU;
8e. faults: the fault planes on the main path's round (ResNet-20, bf16,
   100 clients x 250 samples from ``--seed``, k = 10, batch 50, 10 local
   steps, int8 both ways), cuDNN deterministic: ``faults_free`` (no
   knob, the phase's own reference, run first and last),
   ``faults_drill`` (``FAULTS_DRILL``: over-selection to k' = 13, the
   trace availability model with dropout 0.1, a diurnal period of 24 and
   a quorum of 0.8, crashes 0.1, stragglers 0.2, nan poison 0.1, a
   byzantine cohort of 0.1 sign-flipping at scale 3, the guards,
   ``trimmed_mean`` 0.2), the drill again on the
   stream plane and ``faults_dp`` (``FAULTS_DP``: DP-FedAvg at noise
   multiplier 1 and clip 1, with ``trimmed_mean``); each 1 warm-up and 1
   timed round with the counters set to 0 just before and read just
   after (2 + 2 ragged launches a round), every round's fault counters
   and DP gauges, round ms beside ``faults_free``'s and the main path's,
   then (but the stream drill and ``faults_free_again``) one profiled
   round (device busy share, launches a local step of the k' dispatched
   clients); the warm-up round's uplink stack of k'
   rows held against the plain version within one step; the stream
   drill's server params and generator state after its 2 rounds bitwise
   the resident drill's. Then a ``zero`` and a ``collude`` drill round
   that send crafted uploads (colluding rows identical, zero rows zero),
   their uplink stacks held against the plain version; then the drill's
   and the DP path's rounds cut to 4 clients and 2 steps (one adversary:
   ``FAULTS_CUT_BYZANTINE_RATE``) in float32 card (TF32 off) vs CPU,
   every count equal, the update within the larger of ``TASK_CARD_FLOOR``
   and ``SPREAD_FACTOR`` times the CPU's order spread, the CPU runs
   replaying the card's DP normals;
8f. lifecycle: the run lifecycle through the CLI on the main path's
   round from CIFAR-10 files written from ``--seed``, cuDNN
   deterministic (``lifecycle_phase``): a reference with a
   checkpoint and a keep every round (each round's server params and
   generator hashed, 2 + 2 ragged launches a round, every metrics row
   valid, health ``complete``, the checkpoint's MB and the sync save's
   ms), run three times in this process: saves off, sync saves and
   ``--async_checkpoint``, bitwise one another, their round and
   checkpoint ms side by side; telemetry default and off with the same device-to-host memcpys
   a round; a torn checkpoint and keep resumed from the previous keep,
   named; two kill drills (sync and ``--async_checkpoint``) of ``python
   -m fedtorch_tpu_torch.cli`` children under the restart harness,
   SIGTERM once round index ``LIFECYCLE_KILL_AFTER`` is logged: exit
   codes [75, 0], every keep bitwise the reference's, the resumed
   child's 2 + 2 ragged launches a round, no rebuild (beside them, the
   federation phase's async kill drill and the podscale phase's CLI
   pair, whose results those phases hold); the supervisor with nan poison, every rollback bitwise the
   pre-round state, the cut round's counts card = CPU; stream-plane
   gather faults bitwise a fault-free run; within ``LIFECYCLE_BUDGET_S``;
8g. federation: the federation plane's observers and the async commit
   plane on the main path's round (ResNet-20, bf16, int8 both ways, 100
   clients x 250 samples from ``--seed``, batch 50, 10 local steps),
   cuDNN deterministic (``federation_phase``): ``cohort_stats_off`` and
   ``cohort_stats_on`` (k = 10; 1 warm-up round, round index 1's
   ``run_round`` and its one fetch watched in sync debug mode, 1 timed
   rounds): params and generator state bitwise, the same synchronizing
   CUDA calls, 2 + 2 ragged launches a round, the cohort vectors [k] with
   ids the round's cohort; a float32 cut round under ``krum`` card vs
   CPU with the same selection mask, its sum ``robust_selected``. Then
   ``async_resnet20`` (``ASYNC_FED``: 10 in flight, m = 5, a ring of 8,
   poly staleness 0.5; ``ASYNC_FAULT``: stragglers 0.4 at a tenth of the
   speed) on the device and the stream plane (1 warm-up, 4 timed and 1
   profiled commit; 2 + 2 ragged launches a commit; the warm-up commit's
   uplink stack of m rows within one step of the plain version; the
   stream plane's params, ring and generator bitwise the device
   plane's; ms a commit over the sync round's, staleness a commit, the
   histogram, dispatches and ring clamps), ``async_trace`` (the trace
   availability model, 2 commits), the commit cut to 4 clients in
   flight, m = 2 and 2 steps (``ASYNC_CUT``) card vs CPU in float32 over
   3 commits (every commit's numbers equal, the update within
   ``faults_card_vs_cpu``'s bar), and the CLI with ``--sync_mode async
   --cohort_stats true`` (``ASYNC_CLI_WORDS``) from CIFAR-10 files
   written from ``--seed``: ``ASYNC_CLI_COMMITS`` commits with an
   evaluation and a keep each (``client_ledger.json``'s participation m
   x commits, the staleness histogram and the anomaly summary in the
   events), its kill drill (run beside the lifecycle phase's untimed
   runs; exit codes [75, 0], every keep bitwise), and 3 stream-plane commits
   whose rows carry ``overlap_efficiency`` in [0, 1]; within
   ``FEDERATION_BUDGET_S``;
8h. fusion: client fusion and remat (``fusion_phase``). The ResNet-20
   cell (bf16, int8 both ways, 100 clients x 250 samples from
   ``--seed``, k = 10, batch 50, 10 local steps, flip and crop) with
   ``client_fusion='fused'`` beside ``'vmap'``, both from one seed: a
   warm-up round each (the fused uplink stack held to the plain version
   within one step), ``FUSION_TIMED_ROUNDS`` timed rounds each in
   alternation, 2 + 2 ragged launches every round; per path the memory a
   round adds over the resident state, a round's synchronizing CUDA
   calls (``run_round`` + the loop's one fetch, sync debug mode) and a
   profiled round (busy share, launches a local step). The cell cut by
   ``TASK_CARD_CUT`` in float32 (TF32 off): the card's fused round
   against the CPU's fused round and against the card's vmap round,
   each update within the larger of ``TASK_CARD_FLOOR`` and
   ``SPREAD_FACTOR`` times the CPU's order spread
   (``FUSION_CUT_ORDERS``), every count equal; the same for SCAFFOLD
   under epoch sync with stragglers at batch 8. SCAFFOLD under epoch
   sync with stragglers (``FUSION_STRAGGLERS``) on the cell, one round
   fused and one vmap in bf16 and in float32: the same clients frozen
   after the same steps, the same straggler count, the update fused vs
   vmap within ``SPREAD_FACTOR`` times what NCHW memory (and bf16
   rounding) moves the vmap round. ``cnn_cifar`` fused: 2 + 2 ragged and 2 + 2
   tiled launches a round. WideResNet-28-10 with remat off and on
   (``FUSION_WRN_CLIENTS`` clients, all online; cuDNN deterministic): a
   warm-up and a timed round each, the memory a round adds, the params
   bitwise the same. Within ``FUSION_BUDGET_S``;
9. WideResNet main path: the same round on WideResNet-28-10 (widen 10,
   36.5 M parameters, full width and depth) after the ResNet-20 objects
   are freed; 1 warm-up round, then 1 timed round, then one profiled
   round. The counters must read the launches derived from the model's
   own leaf sizes (2 ragged stats, 2 ragged apply, 6 tiled stats, 6
   tiled apply per round);
10. transformer main path: quantized FedAvg on the causal transformer LM
   with flash attention (``rnn_hidden_size`` 128: d_model 256, 4 heads
   of 64, 4 layers, T 2048, 3,723,862 params, bfloat16; ``define_model``
   takes any width, d_model = 2 x rnn_hidden_size), 100 clients x 100
   windows of
   2048 characters with next-token labels made from ``--seed``, k = 10,
   batch 8, 10 local steps, SGD lr 0.05; 1 warm-up, 1 timed and 1
   profiled round. The counters must read 400 flash launches (layers x
   local steps x k), all on the tensor-core kernel, and 2 ragged stats
   and 2 ragged apply launches per round. Then ``evaluate`` of its
   server params on 32 windows of 2048 at batch 8: 16 tensor-core flash
   launches (layers x batches) under inference mode, and its loss within
   ``LM_EVAL_LOSS_BAR`` of the same evaluation through the plain flash
   version on the card;
11. transformer_d512: the same round at ``rnn_hidden_size`` 256 (d_model
    512, 4 heads of 128, 4 layers, T 2048, 13,739,094 params,
    bfloat16); 1 warm-up, timed and 1 profiled round. The counters must
    read 400 flash launches a round, all on the wgmma kernel (head dim
    128), 2 + 2 ragged launches and, for its leaves past 524,288
    elements (the qkv weights of 786,432, the positional embedding and
    MLP weights of 1,048,576: two sizes), 4 + 4 tiled launches;
11b. transformer_d1024: the same round at ``rnn_hidden_size`` 512
    (d_model 1024, 4 heads of 256, 4 layers, T 2048, 52,643,926 params,
    bfloat16); 1 warm-up, timed and 1 profiled round. The counters must
    read 400 flash launches a round, all on the wgmma kernel's head-dim-256
    instance, 2 + 2 ragged launches and, for its 17 leaves past 524,288
    elements (four sizes: 1,048,576, 2,097,152, 3,145,728, 4,194,304),
    8 + 8 tiled launches. Then its round cut by ``D1024_CUT`` (2 clients,
    2 local steps, T 128, 1 layer) in float32 (TF32 off): logits and the
    FedAvg round's update card (the TF32 kernel at D 256) vs CPU within
    1e-4, as the reference phase holds its transformers;
11c. transformer_d2048: the same round at ``rnn_hidden_size`` 1024
    (d_model 2048, 4 heads of 512, 4 layers, T 2048, 205,951,062
    params, bfloat16), its population cut to 10 clients, all online
    (``D2048_POPULATION``: k = 10 as in the other cells; the client
    state of 100 would not fit the card); 1 warm-up, timed and 1
    profiled round. The counters must read 400 flash launches a round,
    all on the wgmma kernel's head-dim-512 instance, 2 + 2 ragged
    launches and, for its 17 leaves past 524,288 elements (three sizes),
    6 + 6 tiled launches. Then its round cut by ``D2048_CUT`` in float32
    card (the TF32 kernel's clusters at D 512, 4 launches) vs CPU
    within 1e-4, as item 11b's;
12. transformer_f32: the path of item 10 in float32, the library's
    default ``compute_dtype``; 1 warm-up, timed and 1 profiled round.
    The counters must read 400 flash launches a round, all on the TF32
    kernel, and 2 + 2 ragged launches;
13. moe (``moe_phase``): the transformer path of item 10 with Switch MoE
    blocks (``MOE``: 16 experts, capacity factor 1.25, aux weight 0.01;
    35,274,326 params) through the library entry points; 1 warm-up, 1
    timed and 1 profiled round, the counters set to 0 just before: 400
    wgmma flash launches, 2 + 2 ragged and, for the 8 expert-weight leaves
    of 4,194,304 elements, 2 + 2 tiled launches a round; the mean aux loss
    and each block's routed and dropped fractions on a batch of the
    server params; launches a local step and busy share from the
    profiled round's raw records; peak MiB. Then its round cut to 2
    clients, 2 steps, T 128 and 4 experts in float32 (TF32 off) card vs
    CPU in both dispatch modes, held as a tasks path's cut, with the
    tokens that route otherwise; the flash ring's per-step pieces over one
    card at (8, 2048, 4, 64), bf16 (the wgmma kernel) and float32 (the
    TF32 kernel), n in ``RING_NS``: the merged o and lse against the
    whole-sequence kernel and its plain version, and a backward through
    the pieces against the whole-sequence backward; ``long_context_apply``
    (ring and Ulysses, flash), ``ep_moe_apply`` (both modes), ``tp_apply``
    and ``pipeline_apply`` at one NCCL rank against the module's own
    forward; and the CLI on the cell at T 256 for one round
    (``MOE_CLI_WORDS``). Within ``MOE_BUDGET_S``.
14. podscale (``podscale_phase``): client sharding on the ResNet-20 main
    path's round, cuDNN deterministic: ``client_shards`` 0 and 1 in this
    process (1: the armed twin, no collective), plain, at 1 with the
    update guards judging a 'gauss' attack and at 0 robust, then S=2 as
    two spawned ranks on
    the one card over gloo (``init_multihost`` on a ``file://`` store),
    each running its 5 clients on the device plane, on the stream plane
    and guarded under attack: the client state and the population
    sharded (each rank holds its 50 clients' rows, the two cover the 100
    once), every rank's hash of its own rows, server params, generator
    and metrics bitwise the S=1 twin's of the same rows, 2 + 2 ragged
    launches, 1 seam collective, 1 exchange and (guarded) 1 norm gather
    a round a rank, the collectives' bytes and the gather's gauges; in
    the same pair, S=0 (the JAX package's 1-D mesh: each rank's 5
    clients' loops, then one cohort gather and the rest of the round on
    all 10) plain (``S0_resident``) and with ``trimmed_mean`` and the
    cohort statistics (``S0_robust``), each rank bitwise the S=0 round
    in this process on its rows, 2 + 2 ragged launches, 0 seam
    collectives, 1 exchange and 1 cohort gather a round a rank with
    their bytes, and local-SGD mode on the two ranks (``localsgd_W2``,
    the ``localsgd`` phase's configuration, 5 workers a rank) bitwise
    the ``localsgd`` phase's in-process ``fit``; the resident MiB of the
    client state and the population and ``memory_allocated`` at S 1, 2
    and 0 (S 2's client state half of S 1's, S 0's equal to S 2's);
    round ms at S 0, 1 and 2 and of local SGD a rank, nothing else
    running beside them. And the CLI on two ranks (``--client_shards 2
    --num_processes 2 --coordinator_address 127.0.0.1:<a free port>``,
    synthetic data, 2 rounds and a resume; run beside the lifecycle
    phase's untimed runs): equal metric lines, rank 0's checkpoints the
    only ones. Within ``PODSCALE_BUDGET_S``.

The observability checks (``fedtorch_tpu_torch/utils/tracing.py``,
``tools/trace_attrib.py``, ``telemetry/costs.py``,
``utils/lock_sentinel.py``) ride those phases' existing rounds: every
profiled round is attributed by ``trace_attrib`` (>= 95% into named
categories, its hand-kernel rows and PERF.md's E/M/N/F/Q columns; the
ResNet-20 round's profile is ``capture_round_trace``'s, its trace file
attributed too, within 1% of the in-memory records and holding the
round's 2 + 2 ragged launches; the transformer round's holds its 400
flash launches); the watched rounds (ResNet-20's round index 1 in
``federation``, the fused and vmap rounds in ``fusion``) name each
synchronizing CUDA call by its site with the ``SyncSentinel``, its total
held to the profiler's record of the synchronizing runtime calls (as
many ``cudaStreamSynchronize``, no other beyond the window's own
drains); each main path's round FLOPs (``costs.round_flops``) give its
MFU against the card's peak (the flash forward at its kernel's rate); the ``cli`` run's
``program_costs.json`` and its rows' five device gauges are asserted;
the ``lifecycle`` CLI runs go under a strict ``LockOrderSentinel``. An
``observability`` line gathers them.

Prints a ``{"kernels": [...]}`` line, then ``main_path``, ``profile``,
``stream``, ``cli``, ``cli_apfl``, ``zoo``, ``localsgd``,
``tasks``, ``models``, ``faults``, ``lifecycle``, ``federation``,
``fusion``, ``wrn_main_path``,
``wrn_profile``,
``transformer_main_path``,
``transformer_profile``, ``transformer_d512_main_path``,
``transformer_d512_profile``, ``transformer_d1024_main_path``,
``transformer_d1024_profile``, ``transformer_d2048_main_path``,
``transformer_d2048_profile``, ``transformer_f32_main_path``,
``transformer_f32_profile``, ``moe``, ``podscale`` and ``observability``
lines, the card's name and power limit and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import io
import itertools
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA's data sheet): device memory, float32 outside
# the tensor cores, dense bfloat16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# float32 operations per element of the round trip: min, max and add for
# the statistics; subtract, divide, add, round, two clips, subtract,
# multiply and add for the output
STATS_OPS_PER_ELEM = 3
APPLY_OPS_PER_ELEM = 9
QDQ_OPS_PER_ELEM = STATS_OPS_PER_ELEM + APPLY_OPS_PER_ELEM
TPU_QUANT = "fedtorch_tpu/ops/pallas/quant_kernel.py"
TPU_KERNEL = f"{TPU_QUANT}:76"
RAGGED_SOURCE = "fedtorch_tpu_torch/csrc/qdq_ragged.cu"
TILED_SOURCE = "fedtorch_tpu_torch/csrc/qdq_tiled.cu"
NO_LIBRARY = ("no single PyTorch call computes a per-row adaptive "
              "quantize -> dequantize round trip")
FLASH_TF32_SOURCE = "fedtorch_tpu_torch/csrc/flash_fwd_tf32.cuh"
FLASH_TC_SOURCE = "fedtorch_tpu_torch/csrc/flash_fwd_sm90.cu"
FLASH_TPU_KERNEL = "fedtorch_tpu/ops/pallas/flash_attention.py:82"
# timed inputs of the quantizer pairs rotate over at least this many
# bytes, twice the 50 MB L2, so that each launch streams from device
# memory
COLD_BYTES = 128 * 2 ** 20

# north-star sizes (bench.py)
NUM_CLIENTS, SAMPLES, BATCH, LOCAL_STEPS, ONLINE_RATE = 100, 250, 50, 10, 0.1
TIMED_ROUNDS = 1
WRN_TIMED_ROUNDS = 1
# the transformer path: define_model gives d_model 2 * 128 = 256, 4 heads
# of 64, 4 layers; 100 windows of 2048 characters per client, batch 8
LM = dict(rnn_hidden_size=128, mlp_num_layers=4, rnn_seq_len=2048,
          vocab_size=86)
LM_WINDOWS, LM_BATCH, LM_TIMED_ROUNDS = 100, 8, 1
LM_FLASH_PER_ROUND = LM["mlp_num_layers"] * LOCAL_STEPS * 10  # k = 10
LM_SHAPE = (LM_BATCH, 2048, 4, 64)  # its attention's [B, T, H, D]
# transformer_d512: d_model 512, 4 heads of 128, bf16; transformer_f32:
# the LM path in the library's default dtype
LM_D512 = dict(LM, rnn_hidden_size=256)
LM_D512_SHAPE = (LM_BATCH, 2048, 4, 128)
D512_TIMED_ROUNDS = F32_TIMED_ROUNDS = 1
# transformer_d1024: d_model 1024, 4 heads of 256 (Gemma 7B's head width),
# bf16; beside it its round cut to 2 clients, 2 steps, T 128 and 1 layer
# in float32 card vs CPU (the TF32 kernel at D 256 inside a round)
LM_D1024 = dict(LM, rnn_hidden_size=512)
LM_D1024_SHAPE = (LM_BATCH, 2048, 4, 256)
D1024_TIMED_ROUNDS = 1
D1024_CUT = dict(hidden=512, layers=1, T=128, clients=2, rate=1.0)
# transformer_d2048: d_model 2048, 4 heads of 512, bf16 (the wgmma
# kernel's D-512 instance), its population cut from 100 clients to 10,
# all online (k = 10 as in every transformer cell: the client state of
# 100 would not fit the card); beside it its float32 cut card vs CPU (the
# TF32 kernel's clusters at D 512 inside a round)
LM_D2048 = dict(LM, rnn_hidden_size=1024)
LM_D2048_SHAPE = (LM_BATCH, 2048, 4, 512)
D2048_POPULATION = (10, 1.0)
D2048_TIMED_ROUNDS = 1
D2048_CUT = dict(hidden=1024, layers=1, T=128, clients=2, rate=1.0)
# the flash phase's head dims past 128 (both kernels' wide instances; past
# 256 the TF32 kernel's clusters and, past 2048, its chunked kernel, and
# the wgmma kernel's D-512 cluster) and their sequence lengths; B.H 4
# past 576
FLASH_WIDE_DIMS = (136, 192, 200, 256, 257, 320, 384, 512, 576, 1024, 2056)
FLASH_WIDE_TS = (1, 129, 2048)
# the moe phase: the transformer cell with Switch MoE blocks (MOE_AB.json's
# 16 experts, the README's capacity factor 1.25 for E >= 8, Switch's aux
# weight 0.01); its float32 cut card vs CPU (2 clients, 2 steps, T 128, 4
# experts, both dispatch modes); the ring's flash blocks over one card at
# the transformer's attention shape, n blocks each; the CLI at T 256
MOE = dict(LM, moe_experts=16, moe_capacity_factor=1.25, moe_aux_weight=0.01)
MOE_CUT = dict(LM, rnn_seq_len=128, moe_experts=4, moe_aux_weight=0.01)
MOE_CUT_CFS = (0.0, 1.25)
RING_NS = (2, 4, 8)
MOE_NCCL_BATCH = 2
# the merged bf16 o: each merge rounds o1 * w1, o2 * w2 and their sum
# over the weights to bf16 (3 spacings of at most 2^-8 of max |o| each),
# and the whole-sequence kernel rounds its o once
RING_BF16_SPACING = 2.0 ** -8
# the ring's gradients against the whole-sequence backward, relative L2:
# float32 (the TF32 kernel's forward, the float32 backward) sums in
# other groupings only; bf16 through the merges' bf16 roundings
RING_GRAD_BAR = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
# the model-parallel forwards at one NCCL rank against the module's own
# forward, float32 with TF32 off: the same products in the same order
MOE_NCCL_BAR = 1e-4
MOE_CLI_WORDS = ["-d", "shakespeare", "-a", "transformer",
                 "--rnn_hidden_size", "128", "--mlp_num_layers", "4",
                 "--rnn_seq_len", "256", "--attention", "flash",
                 "--compute_dtype", "bfloat16", "--moe_experts", "16",
                 "--moe_capacity_factor", "1.25", "--moe_aux_weight", "0.01",
                 "-f", "true", "--num_workers", "5",
                 "--online_client_rate", "1.0", "--federated_sync_type",
                 "local_step", "--local_step", "10", "-b", "8", "--lr",
                 "0.05", "--quantized", "true", "--num_comms", "1",
                 "--eval_freq", "1"]
MOE_CLI_WINDOWS = 12
MOE_BUDGET_S = 150.0
# the stream phase: 1 warm-up and this many timed rounds a path (the scan
# path: one timed window of 1 + this many rounds, no warm-up), and the
# depth-1 path's rounds back to back; 2 timed rounds before the cut for
# the script's time
STREAM_TIMED_ROUNDS = 1
STREAM_STRESS_ROUNDS = 3
# the default transformer width's heads (rnn_hidden_size 50: 4 of 25)
DEFAULT_WIDTH_SHAPE = (LM_BATCH, 2048, 4, 25)
SINGLE_NS = (1, 4097, 272_474, 524_288, 524_289)
# the CLI path: the north-star round from CIFAR-10 files at full size
# (50,000 training images over 100 clients, 10,000 test images evaluated
# every round in 40 batches of 256)
CLI_ROUNDS = 2
CLI_ARGV = ["-d", "cifar10", "-a", "resnet20", "-f", "true", "--num_workers",
            "100", "--online_client_rate", "0.1", "--federated_sync_type",
            "local_step", "--local_step", "10", "-b", "50", "--lr", "0.1",
            "--in_momentum", "true", "--quantized", "true", "--compute_dtype",
            "bfloat16", "--num_comms", str(CLI_ROUNDS), "--evaluate", "true",
            "--eval_freq", "1"]
# the CLI's fused run (``--client_fusion fused``) on the same files
CLI_FUSED_ROUNDS = 2
CLI_BATCH_IMAGES = 10_000
CLI_SUBSET = 1024
# float32 evaluate of the final params, card (TF32 off) vs CPU, on
# CLI_SUBSET images: the two sum the convolutions in other orders
CLI_EVAL_BAR = dict(loss_rel=1e-4, top_images=2)
# the transformer path's evaluate: 4 batches of 8 windows
LM_EVAL_WINDOWS = 32
# its loss through the kernel vs through the plain version, both bf16:
# one bfloat16 spacing at the loss's magnitude
LM_EVAL_LOSS_BAR = 2.0 ** -8
# the zoo phase: every algorithm beyond FedAvg on the north-star ResNet-20
# round (bf16, 100 clients, k = ZOO_ONLINE_RATE x 100, batch 50, 10 local
# steps, data from --seed); (name, federated fields, optim fields). qsparse at the CLI's
# default --compressed_ratio (1.0: top-k keeps half of each leaf), AFL at
# the one local step its config forces
ZOO_PATHS = (
    ("scaffold", dict(algorithm="scaffold"), dict(in_momentum=False)),
    ("fedgate", dict(algorithm="fedgate"), {}),
    ("fedcomgate", dict(algorithm="fedgate", quantized=True), {}),
    ("qsparse", dict(algorithm="qsparse"), {}),
    ("qffl", dict(algorithm="qffl", qffl_q=1.0), {}),
    ("afl", dict(algorithm="afl"), {}),
    ("drfa", dict(algorithm="fedavg", drfa=True), {}),
    # the personalized algorithms on the val split (200 train and 50 val
    # rows a client), evaluate_personal timed once after the rounds;
    # apfl_q is APFL with FedAvg's int8 wire format both ways. PerFedMe
    # at lr 0.05: with perfedme_lambda 15, lr 0.1 makes lr * lambda 1.5
    # and the personal model oscillates
    # (fedtorch_tpu/algorithms/perfedme.py:15-19)
    ("apfl", dict(algorithm="apfl", adaptive_alpha=True), {}),
    ("apfl_q", dict(algorithm="apfl", adaptive_alpha=True, quantized=True),
     {}),
    ("perfedme", dict(algorithm="perfedme"), dict(lr=0.05)),
    ("perfedavg", dict(algorithm="perfedavg"), {}),
)
ZOO_TIMED_ROUNDS = 1
# the zoo paths' cohort: k = 5 of the 100 clients (half the cell's k: the
# cohort cut for the script's time; model, data and steps as the cell's)
ZOO_ONLINE_RATE = 0.05
# each algorithm's round card vs CPU (an MLP on 60 features, float32,
# unquantized, TF32 off): the relative L2 of the server update and of
# each aux tree (and, personalized, each evaluate_personal summary
# figure within it, relative or absolute); top-k at ratio 0.5 besides
# qsparse's default
ZOO_CARD_BAR = 1e-4
ZOO_CARD_CASES = tuple((n, f, o) for n, f, o in ZOO_PATHS
                       if not f.get("quantized")) + (
    ("fedgate_topk", dict(algorithm="fedgate", compressed=True,
                          compressed_ratio=0.5), {}),
    ("drfa_fedgate", dict(algorithm="fedgate", drfa=True), {}),
    ("drfa_scaffold", dict(algorithm="scaffold", drfa=True),
     dict(in_momentum=False)))
# local-SGD mode on the north-star data pooled over 10 workers (num_clients
# cut from 100 so that a round is the FedAvg round's 100 client-steps:
# 10 workers x 10 local steps of 50), every worker online; 2 rounds of
# fit, the first a warm-up
LOCALSGD_WORKERS, LOCALSGD_ROUNDS = 10, 2
# the CLI's APFL run: CLI_ARGV (int8 both ways) with adaptive alpha
CLI_APFL_ROUNDS = 1
CLI_APFL_WORDS = ["--federated_type", "apfl", "--fed_adaptive_alpha", "true",
                  "--num_comms", str(CLI_APFL_ROUNDS)]
# the tasks phase: the federated tasks through the library entry points,
# each quantized FedAvg-family round int8 both ways, data made from
# --seed: (name, arch, dataset, compute dtype, clients, federated fields).
# k = 10 online, batch 50, 10 local steps on every path; 1 warm-up and
# TASK_TIMED_ROUNDS timed rounds. The MLP paths are BASELINE config 5
# (APFL -pa 0.5 -fp, DRFA -fd -dg 0.1) at run_tpu.py's EMNIST width (200)
TASK_PATHS = (
    ("cnn_mnist", "cnn", "mnist", "float32", 10, dict(algorithm="fedavg")),
    ("cnn_cifar", "cnn", "cifar10", "bfloat16", 100,
     dict(algorithm="fedavg")),
    ("rnn_shakespeare", "rnn", "shakespeare", "float32", 100,
     dict(algorithm="fedavg")),
    ("mlp_emnist_apfl", "mlp", "emnist", "float32", 500,
     dict(algorithm="apfl", personal_alpha=0.5, personal=True)),
    ("mlp_emnist_drfa", "mlp", "emnist", "float32", 500,
     dict(algorithm="fedavg", drfa=True, drfa_gamma=0.1)),
)
TASK_ONLINE, TASK_TIMED_ROUNDS, TASK_MLP_HIDDEN = 10, 1, 200
# rows a client: the IID image paths' (a cut: MNIST's 60,000 over 10
# clients would be 6,000), EMNIST writers' and Shakespeare characters'
# windows of 50 drawn uniformly from these ranges with --seed
TASK_IMAGE_ROWS = dict(mnist=600, cifar10=250)
EMNIST_ROWS, SHAKESPEARE_WINDOWS = (50, 150), (20, 60)
TASK_EVAL_ROWS = 1000
# card vs CPU: each path's round cut to 4 clients, 2 online, 2 local
# steps (the same model, dtype, batch and wire format), from one seed,
# TF32 off. The card's wire-format calls must be within one step of the
# plain version on the card's own payloads; the update's relative L2
# within the larger of TASK_CARD_FLOOR and SPREAD_FACTOR times the CPU's
# own spread over other CPU orders measured in this run (NCHW memory
# inside an image model, or 2 threads, and 1 thread). The bf16 cnn_cifar
# round's orders add the same round in float32: CPU layouts and threads
# barely move a bf16 round, but the card rounds to bf16 at other points
# than the CPU (on an H100 at seed 0 the card sat 1.79e-2 relative L2
# and 4.97 steps from the CPU, the CPU's own orders 2.5e-4 and 1.0), and
# the float32 round measures what bf16 rounding moves (3.6e-2 and 11.0
# steps at seed 0 on the CPU). It is also held in int8 downlink
# steps, within the larger of 2 and SPREAD_FACTOR times the spread, as
# the WideResNet round is held. The floor: what sets a float32 path's
# gap is one-step flips of int8 wire values, and their count moves from
# run to run with cuDNN's nondeterministic backward (cnn_mnist on an
# H100: 1.1e-4, 1.3e-4 and 8.1e-4 relative L2 in three runs of seed 0;
# the rnn 1.3e-4 to 4.9e-7); a wrong forward or backward moves the update
# by order 1, and the wire format is held to one step on its own
TASK_CARD_FLOOR = 1e-2
TASK_CARD_CUT = dict(num_clients=4, online_client_rate=0.5, local_step=2)
# DenseNet-BC-100's cut: the same with 1 local step (cut for the
# script's time: its CPU runs take most of the check's time)
DENSENET_CARD_CUT = dict(TASK_CARD_CUT, local_step=1)
# the models phase: DenseNet-BC-100 (Huang et al., CVPR 2017, Table 2:
# growth 12, compression 0.5) on the north-star round; ResNet-18 (ImageNet)
# at this batch of 224x224 images; float32 card vs CPU bars never tighter
# than MODELS_CARD_BAR (the zoo's ZOO_CARD_BAR); the robust rules' rounds
# on ROBUST_CLIENTS clients (k = 4: krum has candidates to rank), the
# robust logistic regression on ROBUST_LR_CLIENTS
DENSENET = dict(densenet_bc_mode=True, densenet_growth_rate=12,
                densenet_compression=0.5)
RESNET18_BATCH = 50
MODELS_CARD_BAR = 1e-4
ROBUST_RULES = ("median", "trimmed_mean", "krum", "multikrum", "norm_bound")
ROBUST_CLIENTS, ROBUST_LR_CLIENTS = 8, 20
# cli_tff: the CLI on TFF HDF5 files written here (20 EMNIST writers and
# 20 Shakespeare characters; k = 10 of them, 2 rounds)
TFF_CLIENTS, TFF_ROUNDS = 20, 2
# the faults phase (the fault planes on the north-star round): the drill
# arms every sync plane, the DP path DP-FedAvg with a robust rule
FAULTS_DRILL = dict(over_select_frac=1.3, avail_model="trace",
                    avail_dropout_rate=0.1, avail_diurnal_period=24,
                    avail_quorum_frac=0.8, client_drop_rate=0.1,
                    straggler_rate=0.2, nan_inject_rate=0.1,
                    byzantine_rate=0.1, byzantine_mode="sign_flip",
                    byzantine_scale=3.0, guard_updates=True,
                    robust_agg="trimmed_mean", robust_trim_frac=0.2)
FAULTS_DP = dict(dp_noise_multiplier=1.0, dp_clip_norm=1.0,
                 robust_agg="trimmed_mean", robust_trim_frac=0.2)
FAULTS_TIMED_ROUNDS = 1
# rounds a zero or collude drill runs until one sends crafted uploads
FAULTS_CRAFT_ROUNDS = 6
# floor(0.1 x 4) is no adversary: the cut round keeps one of its 4 clients
FAULTS_CUT_BYZANTINE_RATE = 0.25
FAULT_COUNTERS = ("dropped_clients", "straggler_clients",
                  "rejected_updates", "clipped_updates", "byzantine_clients",
                  "robust_selected", "robust_trimmed", "avail_dropped",
                  "deadline_missed", "quorum_degraded")
PROFILE_TRIES = 3
# the lifecycle phase: the reference's rounds with saves off (evaluations
# off with them), whose hashes the drills hold their keeps to; the rounds
# of the reference with sync saves and with async ones (an evaluation, a
# checkpoint and a keep each, the newest LIFECYCLE_KEEP kept: two rounds
# show both keeps, for the phase's budget); the kill
# drills' rounds (SIGTERM once round index LIFECYCLE_KILL_AFTER is logged;
# the signal can land after that round's boundary check, and the child
# then drains a round later, so the drill runs as many rounds as the
# reference and the resumed child runs 1 or 2 of them; the fewest
# rounds that allow it, for the script's time); the stream runs' rounds (telemetry default and off, round index
# 1 watched, and the chaos run); the supervisor drill (nan poison at 0.05
# on the main path's round, guards off, 2 retries) and its cut round's
# poison rate (4 clients, k = 2: 0.05 would leave the cut's counts at 0);
# the stream chaos drill (gather faults at rate 0.3 from seed 1, which
# fires at the gather's second check, 3 retries); the phase's budget
LIFECYCLE_ROUNDS = 3
LIFECYCLE_SAVED_ROUNDS = 2
LIFECYCLE_DRILL_ROUNDS = 3
LIFECYCLE_KILL_AFTER = 0
LIFECYCLE_KEEP = 2
LIFECYCLE_SUP = dict(nan_inject_rate=0.05, supervisor=True, max_retries=2,
                     backoff_base_s=0.0)
LIFECYCLE_SUP_ROUNDS = 2
LIFECYCLE_SUP_MAX_ROUNDS = 10
LIFECYCLE_CUT_NAN_RATE = 0.3
LIFECYCLE_CUT_ROUNDS = 3
LIFECYCLE_STREAM_ROUNDS = 2
LIFECYCLE_CHAOS = ("--host_fault_seams", "stream.gather", "--host_fault_rate",
                   "0.3", "--host_fault_seed", "1", "--host_retry_max", "3",
                   "--host_retry_backoff_s", "0")
LIFECYCLE_BUDGET_S = 150.0
# the federation phase: cohort statistics on the main path's round, and
# ``async_resnet20``, the FedBuff commit loop on it (ASYNC_AB.json's
# arrival knobs; concurrency and buffer auto: k_online = 10 in flight,
# m = 5 a commit)
FED_COHORT_TIMED = 1
ASYNC_FED = dict(sync_mode="async", async_concurrency=0,
                 async_buffer_size=0, snapshot_ring=8,
                 staleness_weight="poly", staleness_exponent=0.5)
ASYNC_FAULT = dict(straggler_rate=0.4, straggler_step_frac=0.1)
ASYNC_TRACE = dict(avail_model="trace", avail_dropout_rate=0.1,
                   avail_diurnal_period=24)
ASYNC_TIMED_COMMITS = 2
ASYNC_TRACE_COMMITS = 2
# the commit cut for card vs CPU: 4 clients in flight, m = 2, 2 steps
ASYNC_CUT = dict(num_clients=8, online_client_rate=0.5, async_concurrency=4,
                 async_buffer_size=2, local_step=2)
ASYNC_CUT_COMMITS = 3
ASYNC_CLI_COMMITS = LIFECYCLE_DRILL_ROUNDS
ASYNC_CLI_STREAM_COMMITS = 3
ASYNC_CLI_WORDS = ("--sync_mode", "async", "--cohort_stats", "true",
                   "--fault_straggler_rate", "0.4",
                   "--fault_straggler_step_frac", "0.1", "--snapshot_ring",
                   "8")
# the phase took 142.3 s alone on an H100; whole-script runs have read
# phases up to 1.3x slower
FEDERATION_BUDGET_S = 240.0
# the fusion phase: the north-star cell with client_fusion='fused' beside
# 'vmap' (timed rounds a path, in alternation); the card-vs-CPU cut's
# CPU orders (the fused forward copies every batch into one packed
# layout, so 'cpu-nchw' would move nothing); the SCAFFOLD epoch-sync cell
# with stragglers (250 rows a client, batch 50: 5 steps, a straggler
# frozen after its cut); WideResNet-28-10 with remat on and off on a
# population cut to FUSION_WRN_CLIENTS clients, all online (k = 5, half
# the cell's k: the cohort cut for the script's time; a step's memory
# does not depend on it); the phase's budget
FUSION_TIMED_ROUNDS = 2
FUSION_CUT_ORDERS = ("cpu-1thread", "cpu-2thread")
FUSION_SCAFFOLD = dict(algorithm="scaffold", sync_type="epoch")
FUSION_STRAGGLERS = dict(straggler_rate=0.5, straggler_step_frac=0.5)
FUSION_WRN_CLIENTS = 5
FUSION_BUDGET_S = 100.0
# rows of at most this many elements count as short (ResNet-20's norm
# scales and biases: 16, 32 and 64)
SHORT_ROW = 64


def log(*a):
    print(*a, flush=True)


_T0 = time.perf_counter()


def phase(name):
    log(f"== {name} (at {time.perf_counter() - _T0:.1f} s)")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def device_ms(fn, inner: int = 20, reps: int = 15) -> float:
    """Device time of one ``fn()`` call: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events; median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rotating(fn, inputs):
    """``fn`` over ``inputs`` in turn, one per call."""
    it = itertools.cycle(inputs)
    return lambda: fn(*next(it))


def bound(elems: float, bytes_moved: float, ops_per_elem: int):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_elem * elems / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms,
            ops_ms)


def compare(qk, got, want, x, bits, bitwise=False, what=""):
    """Raise unless ``got`` has the NaN pattern of ``want`` and is within
    one quantization step of it per element (bitwise if asked); returns
    (worst error in steps, worst absolute error)."""
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_got, nan_want):
        raise AssertionError(f"NaN pattern differs at {what} "
                             f"{tuple(x.shape)}")
    if bitwise:
        if not bool(((got == want) | nan_got).all()):
            raise AssertionError(f"kernel != plain bitwise at {what} "
                                 f"{tuple(x.shape)} bits {bits}")
        return 0.0, 0.0
    qmin, qmax = qk.qrange(bits)
    fin = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    step = (fin.amax(1, keepdim=True) - fin.amin(1, keepdim=True)) \
        / (qmax - qmin)
    step = torch.where(step == 0, 1e-3, step)  # the scale floor
    diff = torch.where(nan_got, torch.zeros_like(got), (got - want).abs())
    # one step, plus the float32 rounding of the dequantized value
    slack = step * (1 + 1e-5) + 1e-6 * want.abs().nan_to_num() + 1e-7
    if bool((diff > slack).any()):
        raise AssertionError(f"kernel off by more than one step at {what} "
                             f"{tuple(x.shape)} bits {bits}")
    return float((diff / step).max()), float(diff.max())


def check_partials(qk, got_p, want_p, abs_sums, bitwise, what) -> float:
    """Raise unless the kernel's per-chunk ``[..., 3]`` partials agree
    with the plain version's: min and max exactly (they are exact in any
    order), each sum within the float32 bound of recursive summation,
    (chunk - 1) u sum|x| (``abs_sums``), and exactly if asked. Returns
    the largest finite |diff| of the sums."""
    mm_got, mm_want = got_p[..., :2], want_p[..., :2]
    if not torch.equal(mm_got.nan_to_num(7.0), mm_want.nan_to_num(7.0)) \
            or not torch.equal(mm_got.isnan(), mm_want.isnan()):
        raise AssertionError(f"partial min/max differ at {what}")
    s_got, s_want = got_p[..., 2], want_p[..., 2]
    tol = qk._CHUNK * 2.0 ** -24 * abs_sums
    d = (s_got - s_want).abs()
    same = (s_got == s_want) | (s_got.isnan() & s_want.isnan())
    if not bool((same | (d <= tol)).all()):
        raise AssertionError(f"partial sums differ at {what}")
    if bitwise and not bool(same.all()):
        raise AssertionError(f"partial sums not exact at {what}")
    fin = same.logical_not() & d.isfinite()
    return float(d[fin].max()) if bool(fin.any()) else 0.0


def model_shapes(cfg, define_model):
    """The parameter shapes of ``cfg``'s model, in order (built on the
    CPU)."""
    model = define_model(cfg, batch_size=cfg.data.batch_size, device="cpu")
    return [tuple(v.shape) for _, v in model.module.named_parameters()]


def leaf_shapes(tcfg, define_model, arch, widen=None, model=None):
    """The parameter shapes of a main path's model, in order."""
    return model_shapes(path_config(tcfg, arch, widen, model=model),
                        define_model)


def launches_per_round(qk, numels) -> dict:
    """Quantizer launches of one quantized round (uplink + downlink) for
    leaves of ``numels`` elements: one ragged stats and one ragged apply
    launch per tree call for the leaves of up to ``_MAX_ROW_ELEMS``
    elements (one more of each per ``_TABLE_LEAVES`` leaves), one tiled
    stats and one tiled apply launch per size past it."""
    row = sum(1 for n in numels if n <= qk._MAX_ROW_ELEMS)
    pair = len({n for n in numels if n > qk._MAX_ROW_ELEMS})
    ragged = 2 * -(-row // qk._TABLE_LEAVES)
    return dict(ragged_stats=ragged, ragged_apply=ragged, stats=2 * pair,
                apply=2 * pair)


def counters(qk, fa) -> dict:
    return dict(ragged_stats=qk.ragged_stats_launches,
                ragged_apply=qk.ragged_apply_launches,
                stats=qk.stats_launches, apply=qk.apply_launches,
                flash=fa.flash_launches, flash_tc=fa.flash_tc_launches,
                flash_tf32=fa.flash_tf32_launches)


def reset_counters(qk, fa):
    qk.launches = qk.ragged_stats_launches = qk.ragged_apply_launches = 0
    qk.stats_launches = qk.apply_launches = 0
    fa.flash_launches = fa.flash_tc_launches = fa.flash_tf32_launches = 0


def ragged_phase(qk, fa, cells, k_online):
    """The ragged pair vs its plain version on the card at every main
    path's row-path trees and at edge trees, then timed per round of each
    path; returns the kernels-line fields of the stats and the apply
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = dict(steps=0.0, abs=0.0, partial_abs=0.0)
    trees = {}
    for cell, shapes in cells.items():
        row = [math.prod(s) for s in shapes
               if math.prod(s) <= qk._MAX_ROW_ELEMS]
        trees[cell] = ([(k_online, n) for n in row], [(1, n) for n in row])

    def randn(shape, scale=1e-3):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def dyadic(shape):
        return torch.randint(-64, 65, shape, generator=gen,
                             device="cuda").float() / 16.0

    def check(leaves, bits, bitwise=False, what=""):
        got_p = qk.qdq_ragged_stats(leaves)
        want_p = qk.qdq_ragged_stats_ref(leaves)
        got = qk.qdq_ragged_apply(leaves, got_p, bits)
        want = qk.qdq_ragged_apply_ref(leaves, want_p, bits)
        torch.cuda.synchronize()
        abs_sums = qk.qdq_ragged_stats_ref(
            [x.abs().nan_to_num(0.0, 0.0, 0.0) for x in leaves])[:, 2]
        worst["partial_abs"] = max(worst["partial_abs"], check_partials(
            qk, got_p, want_p, abs_sums, bitwise, what))
        for x, g, w in zip(leaves, got, want):
            st, ab = compare(qk, g, w, x, bits, bitwise, what)
            worst["steps"] = max(worst["steps"], st)
            worst["abs"] = max(worst["abs"], ab)

    cases = 0
    for bits in (8, 16):
        for cell, (up, down) in trees.items():
            for side, shapes in (("uplink", up), ("downlink", down)):
                what = f"{cell} {side}"
                check([randn(s) for s in shapes], bits, what=what)
                # dyadic grid: every sum is exact and both divide IEEE, so
                # the statistics and each output bit must agree
                check([dyadic(s) for s in shapes], bits, True, what)
                cases += 2
        short = [randn((10, n), 1.0) for n in (1, 10, 86)] \
            + [randn((7, 4097), 1.0), randn((3, 255), 1.0)]
        check(short, bits, what="short, misaligned rows")
        n = 3 * qk._CHUNK + 101  # ragged last chunk
        edge = randn((5, n), 1.0)
        edge[1, 5] = float("nan")                 # first chunk
        edge[2, qk._CHUNK + 17] = float("inf")    # a middle chunk
        edge[3, n - 1] = -float("inf")            # the ragged last chunk
        edge[4] = 0.25                            # constant: the scale floor
        # n is odd: every row after the first starts off 16-byte alignment
        check([randn((3, 10), 1.0), edge], bits, what="non-finite chunks")
        dy = [dyadic((10, 86)), dyadic((4, 3 * qk._CHUNK + 3))]
        dy[0][3, 40] = float("nan")
        dy[1][1, qk._CHUNK + 2] = float("nan")
        check(dy, bits, True, "dyadic tree with NaN")
        many = [randn((2, 1 + i), 1.0) for i in range(qk._TABLE_LEAVES + 34)]
        before = counters(qk, fa)
        check(many, bits, what="more leaves than one table")
        after = counters(qk, fa)
        if after["ragged_stats"] - before["ragged_stats"] != 2 \
                or after["ragged_apply"] - before["ragged_apply"] != 2:
            raise AssertionError(f"{len(many)} leaves launched {before} -> "
                                 f"{after}, expected two of each kernel")
        cases += 5
    log(f"ragged pair vs plain: {cases} trees, max error "
        f"{worst['steps']:.6f} steps ({worst['abs']:.3e} abs); partial "
        f"sums max |diff| {worst['partial_abs']:.3e}")
    torch.cuda.empty_cache()

    # timing at int8: one round = the uplink call and the downlink call
    by_cell = {}
    for cell, (up, down) in trees.items():
        elems = sum(r * n for r, n in up + down)
        chunks = sum(r * -(-n // qk._CHUNK) for r, n in up + down)
        copies = max(1, math.ceil(COLD_BYTES / (4 * elems)))
        rounds = [([randn(s) for s in up], [randn(s) for s in down])
                  for _ in range(copies)]
        with_p = [(u, d, qk.qdq_ragged_stats(u), qk.qdq_ragged_stats(d))
                  for u, d in rounds]
        r = dict(elements_per_round=elems, chunks_per_round=chunks,
                 leaves=len(up), rotating_copies=copies)
        for key, fn, args in (
                ("round_ms", lambda u, d: (qk.qdq_ragged(u, 8),
                                           qk.qdq_ragged(d, 8)), rounds),
                ("round_plain_ms", lambda u, d: (qk.qdq_ragged_ref(u, 8),
                                                 qk.qdq_ragged_ref(d, 8)),
                 rounds),
                ("stats_ms", lambda u, d: (qk.qdq_ragged_stats(u),
                                           qk.qdq_ragged_stats(d)), rounds),
                ("stats_plain_ms", lambda u, d: (
                    qk.qdq_ragged_stats_ref(u),
                    qk.qdq_ragged_stats_ref(d)), rounds),
                ("apply_ms", lambda u, d, pu, pd: (
                    qk.qdq_ragged_apply(u, pu, 8),
                    qk.qdq_ragged_apply(d, pd, 8)), with_p),
                ("apply_plain_ms", lambda u, d, pu, pd: (
                    qk.qdq_ragged_apply_ref(u, pu, 8),
                    qk.qdq_ragged_apply_ref(d, pd, 8)), with_p)):
            # the plain versions take milliseconds: fewer replays (as
            # the flash plain version's) give a steady median
            r[key] = device_ms(rotating(fn, args), inner=2, reps=5) \
                if "plain" in key else device_ms(rotating(fn, args),
                                                 inner=10, reps=11)
        if cell == "resnet20":  # hot in L2, as the row kernel was timed
            u, d = rounds[0]
            r["round_hot_ms"] = device_ms(lambda: (qk.qdq_ragged(u, 8),
                                                   qk.qdq_ragged(d, 8)))
            # the uplink with and without its short rows (the norm layers'
            # scales and biases), each one mostly idle block
            short = [x for x in u if x.shape[1] <= SHORT_ROW]
            rest = [x for x in u if x.shape[1] > SHORT_ROW]
            r["short_rows"] = dict(
                rows=sum(x.shape[0] for x in short), max_n=SHORT_ROW,
                uplink_ms=device_ms(lambda: qk.qdq_ragged(u, 8)),
                uplink_without_ms=device_ms(lambda: qk.qdq_ragged(rest, 8)),
                alone_ms=device_ms(lambda: qk.qdq_ragged(short, 8)))
            s = r["short_rows"]
            log(f"resnet20 uplink hot in L2: {s['uplink_ms']:.4f} ms, "
                f"without its {s['rows']} rows of <= {SHORT_ROW} elements "
                f"{s['uplink_without_ms']:.4f}, those rows alone "
                f"{s['alone_ms']:.4f}")
        del rounds, with_p
        torch.cuda.empty_cache()
        # the whole tree function on the path's payload (the tiled pair's
        # buckets, the views and the casts included)
        payloads = [({f"p{i}": randn((k_online, *s))
                      for i, s in enumerate(cells[cell])},
                     {f"p{i}": randn(s) for i, s in enumerate(cells[cell])})
                    for _ in range(max(1, math.ceil(
                        COLD_BYTES / (4 * (k_online + 1) * sum(
                            math.prod(s) for s in cells[cell])))))]
        r["tree_ms"] = device_ms(rotating(
            lambda u, d: (qk.fused_quantize_dequantize_tree(u, 8, True),
                          qk.fused_quantize_dequantize_tree(d, 8)),
            payloads), inner=5, reps=7)
        del payloads
        torch.cuda.empty_cache()
        partial_bytes = 12 * chunks
        r["bound_ms"], r["bound_by"], _, _ = bound(elems, 8 * elems,
                                                   QDQ_OPS_PER_ELEM)
        r["stats_bound_ms"], r["stats_bound_by"], _, _ = bound(
            elems, 4 * elems + partial_bytes, STATS_OPS_PER_ELEM)
        r["apply_bound_ms"], r["apply_bound_by"], _, _ = bound(
            elems, 8 * elems + partial_bytes, APPLY_OPS_PER_ELEM)
        log(f"ragged pair per {cell} round ({len(up)} leaves, {elems:,} "
            f"elements, {chunks:,} blocks, int8): {r['round_ms']:.4f} ms"
            + (f" (hot in L2 {r['round_hot_ms']:.4f})"
               if "round_hot_ms" in r else "")
            + f", plain {r['round_plain_ms']:.4f}, bound "
            f"{r['bound_ms']:.5f} by {r['bound_by']}; stats "
            f"{r['stats_ms']:.4f} (plain {r['stats_plain_ms']:.4f}, bound "
            f"{r['stats_bound_ms']:.5f}), apply {r['apply_ms']:.4f} (plain "
            f"{r['apply_plain_ms']:.4f}, bound {r['apply_bound_ms']:.5f}); "
            f"tree function on the whole payload {r['tree_ms']:.4f} ms")
        by_cell[cell] = r

    main = by_cell["resnet20"]
    common = dict(by_cell=by_cell, launches_per_round=2, chunk=qk._CHUNK,
                  timed="int8, per ResNet-20 round (uplink + downlink call), "
                        "inputs rotating over at least COLD_BYTES")
    stats = dict(max_abs_err=worst["partial_abs"], ms=main["stats_ms"],
                 plain_ms=main["stats_plain_ms"],
                 bound_ms=main["stats_bound_ms"],
                 bound_by=main["stats_bound_by"], **common)
    apply = dict(max_abs_err=worst["abs"], max_err_steps=worst["steps"],
                 ms=main["apply_ms"], plain_ms=main["apply_plain_ms"],
                 bound_ms=main["apply_bound_ms"],
                 bound_by=main["apply_bound_by"], **common)
    return stats, apply


def tiled_phase(qk, buckets, k_online):
    """The multi-block pair vs its plain version on the card, at the
    WideResNet-28-10 bucket shapes past the row threshold; returns the
    kernels-line fields of the stats and the apply kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(b * k_online, n) for b, n in buckets] \
        + [(b, n) for b, n in buckets]
    worst = dict(steps=0.0, abs=0.0, partial_abs=0.0)

    def check(x, bits, bitwise=False):
        got_p = qk.qdq_tiled_stats(x)
        want_p = qk.qdq_tiled_stats_ref(x)
        got = qk.qdq_tiled_apply(x, got_p, bits)
        want = qk.qdq_tiled_apply_ref(x, want_p, bits)
        torch.cuda.synchronize()
        abs_sums = qk.qdq_tiled_stats_ref(
            x.abs().nan_to_num(0.0, 0.0, 0.0))[..., 2]
        worst["partial_abs"] = max(worst["partial_abs"], check_partials(
            qk, got_p, want_p, abs_sums, bitwise, tuple(x.shape)))
        s, a = compare(qk, got, want, x, bits, bitwise, "qdq_tiled")
        worst["steps"], worst["abs"] = max(worst["steps"], s), \
            max(worst["abs"], a)

    for bits in (8, 16):
        for rows, n in shapes:
            x = torch.randn(rows, n, generator=gen, device="cuda") * 1e-3
            check(x, bits)
            d = torch.randint(-64, 65, (rows, n), generator=gen,
                              device="cuda").float() / 16.0
            check(d, bits, bitwise=True)
            del x, d
        n = 3 * qk._CHUNK + 101  # ragged last chunk, rows misaligned
        edge = torch.randn(6, n, generator=gen, device="cuda")
        edge[1, 5] = float("nan")            # first chunk
        edge[2, qk._CHUNK + 17] = float("inf")  # a middle chunk
        edge[3, n - 1] = -float("inf")       # the ragged last chunk
        edge[4] = 0.25                       # constant: the scale floor
        check(edge, bits)
        check(torch.randn(3, 600_001, generator=gen, device="cuda"), bits)
        check(torch.randn(4, 1000, generator=gen, device="cuda"), bits)
    log(f"pair vs plain: {2 * len(shapes)} bucket shapes + edge rows, "
        f"max error {worst['steps']:.6f} steps ({worst['abs']:.3e} abs); "
        f"partial sums max |diff| {worst['partial_abs']:.3e}")
    torch.cuda.empty_cache()

    # timing at the int8 main-path shapes: one round = 6 launches of each
    ms = dict(stats=0.0, apply=0.0, stats_plain=0.0, apply_plain=0.0)
    elems = rows_chunks = 0
    for rows, n in shapes:
        copies = max(1, math.ceil(COLD_BYTES / (4 * rows * n)))
        xs = [torch.randn(rows, n, generator=gen, device="cuda") * 1e-3
              for _ in range(copies)]
        xps = [(x, qk.qdq_tiled_stats(x)) for x in xs]
        for key, fn, args in (
                ("stats", qk.qdq_tiled_stats, [(x,) for x in xs]),
                ("stats_plain", qk.qdq_tiled_stats_ref, [(x,) for x in xs]),
                ("apply", lambda x, p: qk.qdq_tiled_apply(x, p, 8), xps),
                ("apply_plain", lambda x, p: qk.qdq_tiled_apply_ref(x, p, 8),
                 xps)):
            ms[key] += device_ms(rotating(fn, args), inner=2, reps=5) \
                if "plain" in key else device_ms(rotating(fn, args),
                                                 inner=10, reps=11)
        elems += rows * n
        rows_chunks += rows * -(-n // qk._CHUNK)
        del xs, xps
        torch.cuda.empty_cache()
    partial_bytes = 12 * rows_chunks
    # stats: read x once, write the partials; apply: read x and the
    # partials once, write the output once
    sb = bound(elems, 4 * elems + partial_bytes, STATS_OPS_PER_ELEM)
    ab = bound(elems, 8 * elems + partial_bytes, APPLY_OPS_PER_ELEM)
    log(f"pair per WideResNet-28-10 round ({len(shapes)} launches each, "
        f"int8, {elems:,} elements): stats {ms['stats']:.4f} ms (plain "
        f"{ms['stats_plain']:.4f}, bound {sb[0]:.4f} by {sb[1]}), apply "
        f"{ms['apply']:.4f} ms (plain {ms['apply_plain']:.4f}, bound "
        f"{ab[0]:.4f} by {ab[1]})")
    common = dict(elements_per_round=elems,
                  launches_per_round=len(shapes), chunk=qk._CHUNK)
    stats = dict(max_abs_err=worst["partial_abs"], ms=ms["stats"],
                 plain_ms=ms["stats_plain"], bound_ms=sb[0],
                 bound_by=sb[1], bytes_per_round=4 * elems + partial_bytes,
                 **common)
    apply = dict(max_abs_err=worst["abs"], max_err_steps=worst["steps"],
                 ms=ms["apply"], plain_ms=ms["apply_plain"],
                 bound_ms=ab[0], bound_by=ab[1],
                 bytes_per_round=8 * elems + partial_bytes, **common)
    return stats, apply


def single_phase(qk, fa):
    """The single-tensor entry vs plain on the card on both sides of
    ``_MAX_ROW_ELEMS``; returns its kernels-line fields."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst_steps = worst_abs = 0.0
    for n in SINGLE_NS:
        plain = qk.qdq_batch_ref if n <= qk._MAX_ROW_ELEMS \
            else qk.qdq_tiled_ref
        for bits in (8, 16):
            for bitwise in (False, True):
                if bitwise:
                    x = torch.randint(-64, 65, (n,), generator=gen,
                                      device="cuda").float() / 16.0
                else:
                    x = torch.randn(n, generator=gen, device="cuda") \
                        * 0.05 + 0.01
                before = counters(qk, fa)
                got = qk.fused_quantize_dequantize(x, bits)
                after = counters(qk, fa)
                want = plain(x.view(1, -1), bits)
                torch.cuda.synchronize()
                row = n <= qk._MAX_ROW_ELEMS
                want_delta = dict(ragged_stats=int(row),
                                  ragged_apply=int(row), stats=int(not row),
                                  apply=int(not row), flash=0, flash_tc=0,
                                  flash_tf32=0)
                if any(after[c] - before[c] != want_delta[c] for c in after):
                    raise AssertionError(f"single-tensor entry at n = {n} "
                                         f"launched {before} -> {after}")
                s, a = compare(qk, got.view(1, -1), want, x.view(1, -1),
                               bits, bitwise, "fused_quantize_dequantize")
                worst_steps, worst_abs = max(worst_steps, s), \
                    max(worst_abs, a)
    x = torch.randn(64, 3, 3, 16, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        out = qk.fused_quantize_dequantize(x.to(dtype), 8)
        if out.shape != x.shape or out.dtype != dtype:
            raise AssertionError(f"single-tensor entry gave {out.dtype} "
                                 f"{tuple(out.shape)}")
    log(f"single-tensor entry vs plain at n = {SINGLE_NS}: max error "
        f"{worst_steps:.6f} steps ({worst_abs:.3e} abs)")

    by_n = {}
    for n in SINGLE_NS[:-1]:  # the ragged pair's sizes
        x = torch.randn(n, generator=gen, device="cuda") * 0.05
        by_n[n] = dict(
            ms=device_ms(lambda: qk.fused_quantize_dequantize(x, 8)),
            plain_ms=device_ms(lambda: qk.qdq_batch_ref(x.view(1, -1), 8)),
            bound_ms=bound(n, 8 * n, QDQ_OPS_PER_ELEM)[0])
    n = SINGLE_NS[-2]
    b = bound(n, 8 * n, QDQ_OPS_PER_ELEM)
    log("single-tensor entry, int8: " + ", ".join(
        f"n = {k}: {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound "
        f"{v['bound_ms']:.5f})" for k, v in by_n.items()))
    return dict(max_abs_err=worst_abs, max_err_steps=worst_steps,
                ms=by_n[n]["ms"], plain_ms=by_n[n]["plain_ms"],
                bound_ms=b[0], bound_by=b[1], timed_n=n,
                by_n={str(k): v for k, v in by_n.items()})


def bf16_steps(got, want) -> float:
    """Largest excess of |got - want| over the float32 bar (2e-5 abs +
    2e-5 rel), in bfloat16 spacings at the larger of the two magnitudes:
    two float32 results within the bar, each rounded once to bfloat16,
    stay within 1. Equal values (infinities, NaN against NaN) count 0."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).nan_to_num(0.0, 0.0, 0.0)
    spacing = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                         - 7)
    excess = ((g - w).abs() - 2e-5 - 2e-5 * w.abs()).clamp_min(0.0)
    same = (g == w) | (g.isnan() & w.isnan())
    return float(torch.where(same, 0.0, excess / spacing).max())


def close_f32(got, want, what) -> float:
    """Raise unless ``got`` is within atol = rtol = 2e-5 of ``want`` with
    the same NaN pattern; returns the largest finite |diff|."""
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"NaN pattern differs at {what}")
    g = torch.where(got.isnan(), 0.0, got)
    w = torch.where(want.isnan(), 0.0, want)
    if not bool(torch.isclose(g, w, rtol=2e-5, atol=2e-5).all()):
        raise AssertionError(f"flash kernel != plain at {what}: max |diff| "
                             f"{float((g - w).abs().max())}")
    d = (g - w).abs()
    return float(d[d.isfinite()].max()) if bool(d.isfinite().any()) else 0.0


def qkv_views(gen, B, T, H, D, dtype, offset=0):
    """q, k, v as the model makes them: strided [B, T, H, D] chunks of
    one projection (``offset`` > 0 misaligns them, the scalar loads)."""
    x = torch.randn(B, T, 3 * H * D + offset, generator=gen,
                    device="cuda").to(dtype)
    x = x[..., offset:]
    return tuple(c.view(B, T, H, D) for c in x.chunk(3, dim=-1))


def flash_bound(B, T, H, D, elem, causal=True, peak=BF16_OPS_PER_S,
                products=1):
    """(bound ms, what bounds it): ``products`` x 4 B H D T(T+1)/2
    operations (causal; T^2 pairs otherwise) at ``peak`` (the bf16
    tensor-core rate; float32 on the CUDA cores ``FP32_OPS_PER_S``; the
    3xTF32 split, 3 products at ``TF32_OPS_PER_S``), q, k, v read and o,
    lse written once at the memory rate."""
    pairs = T * (T + 1) / 2 if causal else T * T
    ops_ms = products * 4 * B * H * D * pairs / peak * 1e3
    bytes_ms = (4 * B * T * H * D * elem + 4 * B * H * T) \
        / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def sdpa_backend(q, k, v) -> str:
    """The kernel PyTorch's scaled_dot_product_attention launched."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) > 0
             and not e.key.startswith("Memset")]
    return "; ".join(n[:100] for n in names) or "not recorded"


# the kernels-line entries of the flash forward: the wgmma kernel at each
# head dim of a main path, the TF32 kernel; the wgmma kernel's instance at
# 192, on no main path, is checked and reported inside the tc256 entry
FLASH_KEYS = ("tc64", "tc128", "tc256", "tc512", "tf32")


def flash_phase(fa):
    """Both flash forward kernels vs the plain version on the card (TF32
    off for the plain version), each case through the route ``_route``
    picks; then timed at the transformer paths' shapes against the plain
    version and PyTorch's SDPA. Returns the kernels-line fields of the
    wgmma kernel at each head dim of a main path and of the TF32
    kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {r: dict(abs=0.0, bf16_steps=0.0, cases=0)
             for r in FLASH_KEYS + ("tc192",)}
    # each cluster launch past head dim 256, as its kernel reports it:
    # (CTAs a cluster, bytes of shared memory a CTA, the most clusters the
    # card holds at once)
    clusters = {}
    for route, dtype, d in [("tc", torch.bfloat16, 512)] + [
            ("tf32", dt, d) for dt in (torch.float32, torch.bfloat16)
            for d in FLASH_WIDE_DIMS if d > 256]:
        plan = fa.cluster_plan(route, dtype, d)
        clusters[f"{route}_{str(dtype)[6:]}_d{d}"] = plan and dict(
            zip(("ctas", "smem_bytes", "max_active_clusters"), plan))
        log(f"flash {route} {str(dtype)[6:]} at head dim {d}: "
            + (f"a cluster of {plan[0]} CTAs, {plan[1]} B of shared memory "
               f"a CTA, cudaOccupancyMaxActiveClusters {plan[2]}"
               if plan else "no cluster (the chunked kernel)"))

    def check(q, k, v, causal, what, want):
        """One case, which must take route ``want``."""
        scale = 1.0 / math.sqrt(q.shape[-1])
        route = fa._route(q, k, v)
        before = (fa.flash_launches, fa.flash_tc_launches,
                  fa.flash_tf32_launches)
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        launched = (fa.flash_launches - before[0],
                    fa.flash_tc_launches - before[1],
                    fa.flash_tf32_launches - before[2])
        ro, rl = fa.flash_fwd_ref(q, k, v, scale, causal)
        torch.cuda.synchronize()
        what = f"{what} {tuple(q.shape)} {q.dtype} causal={causal}"
        if route != want or launched != (1, int(route == "tc"),
                                         int(route == "tf32")):
            raise AssertionError(f"{what}: route {route} (want {want}), "
                                 f"launches {launched}")
        w = worst[f"tc{q.shape[-1]}" if route == "tc" else route]
        if not torch.equal(o.isinf(), ro.isinf()) \
                or not torch.equal(o[o.isinf()], ro[ro.isinf()]):
            raise AssertionError(f"+-inf pattern differs at {what}")
        w["abs"] = max(w["abs"], close_f32(lse, rl, what + " lse"))
        if q.dtype == torch.float32:
            w["abs"] = max(w["abs"], close_f32(o, ro, what))
        else:
            if not torch.equal(o.isnan(), ro.isnan()):
                raise AssertionError(f"NaN pattern differs at {what}")
            steps = bf16_steps(o, ro)
            if steps > 1.0:
                raise AssertionError(f"flash kernel ({route}) {steps} bf16 "
                                     f"steps past the float32 bar at {what}")
            w["bf16_steps"] = max(w["bf16_steps"], steps)
        w["cases"] += 1

    def want(dtype, d, offset=0):
        # aligned bf16 views at head dim 64, 128, 192, 256 or 512 take the
        # wgmma kernel
        return "tc" if dtype == torch.bfloat16 and d in fa.TC_HEAD_DIMS \
            and offset == 0 else "tf32"

    # each kernel at the shape its main path gives it
    for shape, dtype, route in ((LM_SHAPE, torch.bfloat16, "tc"),
                                (LM_SHAPE, torch.float32, "tf32"),
                                (LM_D512_SHAPE, torch.bfloat16, "tc"),
                                (LM_D1024_SHAPE, torch.bfloat16, "tc"),
                                (LM_D1024_SHAPE, torch.float32, "tf32"),
                                (LM_D2048_SHAPE, torch.bfloat16, "tc"),
                                (LM_D2048_SHAPE, torch.float32, "tf32")):
        for causal in (True, False):
            check(*qkv_views(gen, *shape, dtype), causal, "main path", route)
    B, T, H, D = LM_SHAPE
    for d in fa.TC_HEAD_DIMS:
        for t in (1, 63, 65, 300, 2048):
            for causal in (True, False):
                check(*qkv_views(gen, 2, t, H, d, torch.bfloat16), causal,
                      "wgmma T", "tc")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 24, 25, 32, 64, 100, 128):
            for t in (1, 50, 257, 2048):
                for causal in (True, False):
                    check(*qkv_views(gen, 2, t, H, d, dtype), causal,
                          "head dim, T", want(dtype, d))
            check(*qkv_views(gen, 2, 129, H, d, dtype, offset=1), True,
                  "misaligned", "tf32")
        # past head dim 128: the TF32 kernel's 16-key tiles at padded
        # widths 192 and 256, its clusters past 256 and its chunked kernel
        # past 2048, the wgmma kernel's 32-key instances
        for d in FLASH_WIDE_DIMS:
            b = 1 if d > 576 else 2
            for t in FLASH_WIDE_TS:
                for causal in (True, False):
                    check(*qkv_views(gen, b, t, H, d, dtype), causal,
                          "wide head dim, T", want(dtype, d))
            for offset in (1, 2):
                check(*qkv_views(gen, b, 129, H, d, dtype, offset), True,
                      "wide misaligned", "tf32")
        # the non-finite rules: at 512 on both kernels, at 384 on the TF32
        # kernel (bf16 at 384 is the TF32 kernel's too)
        for offset, d in itertools.product((0, 1), (D, 256, 384, 512)):
            q, k, v = qkv_views(gen, 2, 257, H, d, dtype, offset)
            q[0, 5, 1] = float("nan")
            k[1, 3, 2] = float("inf")
            # a -inf k element under q elements > 0 scores -inf (p = 0, the
            # max unmoved); key 5's scores (>= 125) overflow exp unless the
            # max is kept
            q[1, :, 3, 0] = q[1, :, 3, 0].abs() + 1
            k[1, 3, 3, 0] = float("-inf")
            k[1, 5, 3] = 0.0
            k[1, 5, 3, 0] = 1000.0
            check(q, k, v, True, "NaN q row, +inf k row, -inf k element",
                  want(dtype, d, offset))
        for offset in (0, 1):
            # infinite v: +-inf where p > 0 meets it, NaN where the plain
            # version computes 0 inf (the rows before the key, whose tiles
            # the kernels' causal loops skip) or inf - inf; the wgmma
            # kernel (aligned bf16) at 64, 128, 256 and 512, the TF32
            # kernel at 64, 256, 384 and 512 (past 256 an infinity in a
            # second column block)
            for d in (D, 128, 256, 384, 512) \
                    if want(dtype, D, offset) == "tc" \
                    else (D, 256, 384, 512):
                q, k, v = qkv_views(gen, 2, 300, H, d, dtype, offset)
                v[0, 0, 1, 11] = float("inf")
                v[0, 40, 1, 3] = float("inf")
                v[0, 100, 1, 3] = float("-inf")
                v[0, 100, 1, 7] = float("-inf")
                v[1, 200, 2, 9] = float("inf")
                v[1, 299, 3, 0] = float("-inf")
                v[1, 150, 0, d - 1] = float("inf")
                if d > 300:
                    v[1, 77, 2, 300] = float("-inf")
                for causal in (True, False):
                    check(q, k, v, causal, "+-inf v elements",
                          want(dtype, d, offset))
    for r, w in worst.items():
        log(f"flash kernel ({r}) vs plain: {w['cases']} cases, max |diff| "
            f"{w['abs']:.3e} (lse, float32 o), max {w['bf16_steps']:.3f} "
            f"bfloat16 steps past the float32 bar (bfloat16 o)")

    out = {r: dict(max_abs_err=worst[r]["abs"],
                   max_bf16_steps=worst[r]["bf16_steps"],
                   cases=worst[r]["cases"]) for r in FLASH_KEYS}
    out["tc512"]["cluster"] = clusters.pop("tc_bfloat16_d512")
    out["tf32"]["clusters"] = clusters
    out["tc256"]["d192"] = dict(max_abs_err=worst["tc192"]["abs"],
                                max_bf16_steps=worst["tc192"]["bf16_steps"],
                                cases=worst["tc192"]["cases"])
    for key, shape, dtype, launch in (
            ("tc64", LM_SHAPE, torch.bfloat16, fa._launch_tc),
            ("tc128", LM_D512_SHAPE, torch.bfloat16, fa._launch_tc),
            ("tc256", LM_D1024_SHAPE, torch.bfloat16, fa._launch_tc),
            ("tc512", LM_D2048_SHAPE, torch.bfloat16, fa._launch_tc),
            ("tf32", LM_SHAPE, torch.float32, fa._launch_tf32)):
        out[key].update(time_flash(fa, gen, shape, dtype, launch))
    # the TF32 kernel beside its float32 line: bfloat16 at head dim 64
    # (through its launcher), the default width's heads, heads of 256
    # (its 16-key tiles) and of 512 (its clusters) in float32
    for tag, shape, dtype in (("bf16", LM_SHAPE, torch.bfloat16),
                              ("d25", DEFAULT_WIDTH_SHAPE, torch.float32),
                              ("d256", LM_D1024_SHAPE, torch.float32),
                              ("d512", LM_D2048_SHAPE, torch.float32)):
        t = time_flash(fa, gen, shape, dtype, fa._launch_tf32)
        out["tf32"].update({f"{tag}_{k}": v for k, v in t.items()})
    # the wgmma kernel's non-finite pre-pass alone (inside "ms" above)
    for key, shape in (("tc64", LM_SHAPE), ("tc128", LM_D512_SHAPE),
                       ("tc256", LM_D1024_SHAPE), ("tc512", LM_D2048_SHAPE)):
        out[key]["prepass_ms"] = time_prepass(fa, gen, shape)
        log(f"flash_fwd_tc's pre-pass at {shape}: "
            f"{out[key]['prepass_ms']:.5f} ms of {out[key]['ms']:.4f}")
    return out


def time_prepass(fa, gen, shape):
    """``flash_tc_last_nonfinite`` (the pass ``_launch_tc`` launches
    before the kernel) on the v of rotating bf16 views."""
    from fedtorch_tpu_torch.ops.cuda.build import load_library
    B, T, H, D = shape
    views = [qkv_views(gen, B, T, H, D, torch.bfloat16) for _ in range(
        max(1, math.ceil(COLD_BYTES / (3 * B * T * H * D * 2))))]
    last = torch.empty(B * H * D, dtype=torch.int32, device="cuda")
    fn = load_library().flash_tc_last_nonfinite

    def prepass(q, k, v):
        if fn(v.data_ptr(), last.data_ptr(), B, T, H, D, *fa._tc_strides(v),
              torch.cuda.current_stream().cuda_stream) != 0:
            raise AssertionError("flash_tc_last_nonfinite failed")
    ms = device_ms(rotating(prepass, views), inner=10, reps=11)
    del views
    torch.cuda.empty_cache()
    return ms


def time_flash(fa, gen, shape, dtype, launch):
    """One flash kernel's launcher at ``shape`` causal, inputs rotating
    over at least COLD_BYTES, against the plain version and
    ``F.scaled_dot_product_attention`` on the same tensors as [B, H, T,
    D] views (float32 with TF32 off). Bounds: bf16 on the tensor cores;
    float32 on the CUDA cores and, the TF32 kernel's, three TF32
    products. Returns the kernels-line fields."""
    import torch.nn.functional as F
    B, T, H, D = shape
    elem = torch.finfo(dtype).bits // 8
    views = [qkv_views(gen, B, T, H, D, dtype) for _ in range(
        max(1, math.ceil(COLD_BYTES / (3 * B * T * H * D * elem))))]
    scale = 1.0 / math.sqrt(D)
    r = dict(timed_shape=list(shape), timed_dtype=str(dtype)[6:])
    r["ms"] = device_ms(rotating(
        lambda q, k, v: launch(q, k, v, scale, True), views), inner=10,
        reps=11)
    r["plain_ms"] = device_ms(rotating(
        lambda q, k, v: fa.flash_fwd_ref(q, k, v, scale, True), views),
        inner=2, reps=5)
    if dtype == torch.float32:
        # float32 on the CUDA cores, or the 3 TF32 products the kernel
        # issues on the tensor cores: the smaller is the bound
        cuda_core = flash_bound(B, T, H, D, elem, peak=FP32_OPS_PER_S)
        r["bound_ms"], r["bound_by"] = min(cuda_core, flash_bound(
            B, T, H, D, elem, peak=TF32_OPS_PER_S, products=3))
        r["cuda_core_bound_ms"] = cuda_core[0]
        r["bound_note"] = ("bound_ms: the smaller of 3 TF32 products at 495 "
                           "TFLOP/s and cuda_core_bound_ms, float32 on the "
                           "CUDA cores at 67 TFLOP/s")
    else:
        r["bound_ms"], r["bound_by"] = flash_bound(B, T, H, D, elem)
    torch.cuda.empty_cache()
    lib = [tuple(t.transpose(1, 2) for t in qkv) for qkv in views]
    r["library_ms"] = device_ms(rotating(
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), lib), inner=10, reps=11)
    r["library_backend"] = sdpa_backend(*lib[0])
    r["library_note"] = (
        "F.scaled_dot_product_attention(is_causal=True) on the same "
        f"{r['timed_dtype']} tensors as [B, H, T, D] views"
        + (", TF32 off" if dtype == torch.float32 else "")
        + "; it returns no logsumexp")
    lib_o = F.scaled_dot_product_attention(*lib[0], is_causal=True)
    r["library_vs_kernel_max_abs"] = float(
        (lib_o.transpose(1, 2).float()
         - launch(*views[0], scale, True)[0].float()).abs().max())
    r["vs_library"] = r["ms"] / r["library_ms"]
    del lib, lib_o
    r["vs_bound"] = r["ms"] / r["bound_ms"]
    log(f"flash {launch.__name__} at {shape} {r['timed_dtype']} causal: "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
        f"{r['bound_ms']:.5f} by {r['bound_by']} ({r['vs_bound']:.1f}x)"
        + (f", CUDA-core float32 bound {r['cuda_core_bound_ms']:.5f}"
           if "cuda_core_bound_ms" in r else "")
        + f"; SDPA {r['library_ms']:.4f} ({r['vs_library']:.2f}x) via "
        f"{r['library_backend']}, max |diff| "
        f"{r['library_vs_kernel_max_abs']:.3e}")
    del views
    torch.cuda.empty_cache()
    return r


def _round_card_vs_cpu(os_mod, cfg, qk, fa, seed, runs=("cpu", "cuda")):
    """One quantized round, same weights and plan, in each of ``runs``
    (``order_spread.run_round``'s names); returns the updates, the
    card's quantizer launches, the initial params and the card's
    wire-format calls (name, input, output)."""
    updates, wire, launched = {}, [], {}

    def record(alg):
        for name in ("payload_batch_transform", "aggregate_transform"):
            def recorded(tree, _real=getattr(alg, name), _name=name):
                out = _real(tree)
                wire.append((_name, {k: v.cpu() for k, v in tree.items()},
                             {k: v.cpu() for k, v in out.items()}))
                return out
            setattr(alg, name, recorded)

    for run in runs:
        before = counters(qk, fa)
        updates[run], p0 = os_mod.run_round(
            cfg, seed, run, record if run == "cuda" else None)
        if run == "cuda":
            after = counters(qk, fa)
            launched = {c: after[c] - before[c] for c in after}
    return updates, launched, p0, wire


def _hold_round(os_mod, arch, qk, fa, seed, cfg=None, card_first=False,
                floor_l2=1e-3):
    """One quantized round of ``os_mod.round_cfg(arch)``, card vs CPU:
    the card's quantizer launches, its wire format against the CPU's on
    the card's own payloads within one step, and its update against the
    CPU's.

    A pre-activation within float32 rounding of 0 can land on either
    side of its ReLU in two summation orders, and that moves whole
    leaves of the update by several downlink steps between any two
    float32 orders, the CPU's own included (order_spread.py measures
    it). At WideResNet-16-4 many such flips average out: the card must
    stay within SPREAD_FACTOR times the CPU's spread over SPREAD_ORDERS
    in this run, never tighter than 2 steps and 1e-3 relative L2. At
    ResNet-8 one or two flips set the gap and no spread of a few orders
    bounds it, so the card must stay within SPREAD_FACTOR times
    RESNET8_MAX_GAP, the largest gap between CPU orders over 64 seeds.
    ``cfg`` (default ``os_mod.round_cfg(arch)``) may name another
    algorithm with the same wire format (FedCOMGATE). ``card_first``
    runs the card's round before the CPU's (the dropout path's CPU runs
    replay the card's masks); ``floor_l2`` the relative L2 bar's floor.
    Returns the bars and gaps."""
    cfg = cfg or os_mod.round_cfg(arch)
    per_run = arch != "resnet8"
    runs = ("cpu", *os_mod.SPREAD_ORDERS, "cuda") if per_run else \
        ("cpu", "cuda")
    if card_first:
        runs = ("cuda",) + runs[:-1]
    ups, launched, p0, wire = _round_card_vs_cpu(os_mod, cfg, qk, fa, seed,
                                                 runs)
    want = launches_per_round(qk, [v.numel() for v in p0.values()])
    # every leaf of ResNet-8 takes the ragged pair; WideResNet-16-4's
    # stage-3 convs take the tiled pair
    if any(launched[c] != want[c] for c in want) or not want["ragged_stats"] \
            or (arch == "wideresnet16") != bool(want["stats"]):
        raise AssertionError(f"{arch} round launched {launched}, expected "
                             f"{want}")
    wire_steps = 0.0
    for name, tree, out in wire:
        uplink = name == "payload_batch_transform"
        ref = qk.fused_quantize_dequantize_tree(tree, 8, uplink)
        for k, v in tree.items():
            rows = v.shape[0] if uplink else 1
            s, _ = compare(qk, out[k].reshape(rows, -1),
                           ref[k].reshape(rows, -1), v.reshape(rows, -1), 8,
                           what=f"{name} {k}")
            wire_steps = max(wire_steps, s)
    if len(wire) != 2:
        raise AssertionError(f"recorded {len(wire)} wire-format calls")
    worst, worst_l2 = os_mod.update_gap(ups["cpu"], ups["cuda"])
    f = os_mod.SPREAD_FACTOR
    if per_run:
        spread, spread_l2 = os_mod.spread(ups["cpu"], ups)
        bar, bar_l2 = max(2.0, f * spread), max(floor_l2, f * spread_l2)
        against = (f"CPU vs CPU in {os_mod.SPREAD_ORDERS} max {spread:.4f} "
                   f"steps, relative L2 {spread_l2:.3e}")
    else:
        bar, bar_l2 = (f * g for g in os_mod.RESNET8_MAX_GAP)
        against = f"RESNET8_MAX_GAP {os_mod.RESNET8_MAX_GAP}"
    log(f"quantized {cfg.federated.algorithm} {arch} round: wire format "
        f"card vs CPU on the card's "
        f"payloads max {wire_steps:.6f} steps; update card vs CPU max "
        f"{worst:.4f} downlink steps, relative L2 {worst_l2:.3e} (bars "
        f"{bar:.4f}, {bar_l2:.3e}); {against}; launches {launched}")
    if worst > bar or worst_l2 > bar_l2:
        raise AssertionError(f"quantized {arch} round card vs CPU: {worst} "
                             f"steps, relative L2 {worst_l2}")
    return dict(wire_steps=wire_steps, update_steps=worst,
                update_rel_l2=worst_l2, bar_steps=bar, bar_rel_l2=bar_l2,
                launches=launched)


def reference_phase(tcfg, define_model, os_mod, qk, fa):
    """float32 ResNet-20 logits, a quantized ResNet-8 round and a
    quantized WideResNet-16-4 round, card vs CPU on the same weights and
    plan."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10"),
        model=tcfg.ModelConfig(arch="resnet20")).finalize()
    gpu, cpu = define_model(cfg, device="cuda"), define_model(cfg,
                                                              device="cpu")
    params = cpu.init(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 32, 32, 3)
                         .astype(np.float32))
    with torch.no_grad():
        want = cpu.apply(params, x)
        got = gpu.apply({k: v.cuda() for k, v in params.items()},
                        x.cuda()).cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"ResNet-20 logits card vs CPU: {err}")
    log(f"ResNet-20 f32 logits, card vs CPU: max |diff| {err:.3e}")

    _hold_round(os_mod, "resnet8", qk, fa, seed=2)

    # WideResNet-16-4: its stage-3 convs (589,824 elements) take the pair
    cfg = os_mod.round_cfg("wideresnet16")
    gpu, cpu = define_model(cfg, device="cuda"), define_model(cfg,
                                                              device="cpu")
    params = cpu.init(torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = cpu.apply(params, x)
        got = gpu.apply({k: v.cuda() for k, v in params.items()},
                        x.cuda()).cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"WideResNet-16-4 logits card vs CPU: {err}")
    log(f"WideResNet-16-4 f32 logits, card vs CPU: max |diff| {err:.3e}")

    _hold_round(os_mod, "wideresnet16", qk, fa, seed=4)
    torch.backends.cudnn.allow_tf32 = True


def lm_reference_phase(tcfg, define_model, make_algorithm,
                       stack_partitions, FederatedTrainer, fa, hidden=32,
                       layers=2, T=256, clients=4, rate=0.5):
    """A small float32 transformer with flash attention (d_model 2 x
    ``hidden``, 4 heads, ``layers`` layers, length ``T``; ``clients``
    clients at online ``rate``, 2 local steps): logits from the same
    weights and one unquantized FedAvg round from the same state and
    plan, the card (the TF32 kernel) against the CPU (the plain version),
    TF32 off. GELU and softmax are smooth, so only float32 rounding
    separates the two: the bars are 1e-4 on the logits and on the
    update's relative L2. Returns the numbers and the card round's
    kernel launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    C, N, B = clients, 8, 4
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="shakespeare", batch_size=B),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=C, online_client_rate=rate,
            algorithm="fedavg", sync_type="local_step"),
        model=tcfg.ModelConfig(arch="transformer", rnn_hidden_size=hidden,
                               mlp_num_layers=layers, rnn_seq_len=T,
                               attention="flash"),
        optim=tcfg.OptimConfig(lr=0.05, weight_decay=0.0),
        train=tcfg.TrainConfig(local_step=2)).finalize()
    stream = np.random.RandomState(5).randint(0, 86, C * N * T + 1)
    x = stream[:-1].reshape(C * N, T).astype(np.int32)
    y = stream[1:].reshape(C * N, T).astype(np.int32)
    data = stack_partitions(x, y, [np.arange(i * N, (i + 1) * N)
                                   for i in range(C)])
    gpu, cpu = define_model(cfg, device="cuda"), define_model(cfg,
                                                              device="cpu")
    params = cpu.init(torch.Generator().manual_seed(6))
    toks = torch.from_numpy(x[:B])
    with torch.no_grad():
        want = cpu.apply(params, toks)
        before = (fa.flash_launches, fa.flash_tc_launches,
                  fa.flash_tf32_launches)
        got = gpu.apply({k: v.cuda() for k, v in params.items()},
                        toks.cuda()).cpu()
    layers = cfg.model.mlp_num_layers
    if (fa.flash_launches - before[0], fa.flash_tc_launches - before[1],
            fa.flash_tf32_launches - before[2]) != (layers, 0, layers):
        raise AssertionError("the card's float32 forward did not run the "
                             "TF32 kernel once per layer")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"transformer logits card vs CPU: {err}")

    updates, plan, launched = {}, None, None
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(cfg, define_model(cfg, B, device=dev),
                              make_algorithm(cfg), data, device=dev)
        server, state = tr.init_state(7)
        p0 = {k: v.cpu() for k, v in server.params.items()}
        plan = plan or tr.draw_plan(server)
        before = dict(flash=fa.flash_launches, flash_tc=fa.flash_tc_launches,
                      flash_tf32=fa.flash_tf32_launches)
        server, _, _ = tr.round_fn(server, state, plan)
        if dev == "cuda":
            launched = dict(flash=fa.flash_launches - before["flash"],
                            flash_tc=fa.flash_tc_launches
                            - before["flash_tc"],
                            flash_tf32=fa.flash_tf32_launches
                            - before["flash_tf32"])
        updates[dev] = torch.cat([(v.cpu() - p0[k]).reshape(-1)
                                  for k, v in server.params.items()])
    rel = float(torch.linalg.vector_norm(updates["cuda"] - updates["cpu"])
                / torch.linalg.vector_norm(updates["cpu"]))
    # one forward a layer, local step and online client, all on the TF32
    # kernel (float32)
    want = layers * tr.local_steps * tr.k_online
    log(f"transformer (d {2 * hidden}, {layers} layers, T {T}) f32 flash: "
        f"logits card vs CPU max |diff| {err:.3e}; FedAvg round update "
        f"card vs CPU relative L2 {rel:.3e}; flash launches {launched}")
    if not rel <= 1e-4:
        raise AssertionError(f"transformer round card vs CPU: relative L2 "
                             f"{rel}")
    if launched != dict(flash=want, flash_tc=0, flash_tf32=want):
        raise AssertionError(f"transformer round (d {2 * hidden}): flash "
                             f"launches {launched}, expected {want} on the "
                             f"TF32 kernel")
    return dict(d_model=2 * hidden, layers=layers, T=T,
                logits_max_abs_diff=err, round_update_rel_l2=rel,
                round_flash_launches=launched)


def path_config(tcfg, arch, widen=None, lm=LM, dtype="bfloat16",
                model=None, population=(NUM_CLIENTS, ONLINE_RATE)):
    """The quantized FedAvg round of a main path: the north-star round
    (bench.py) on a CIFAR model (``model``: more of its ModelConfig), or
    a transformer path's round (``lm``: its model sizes, ``dtype`` its
    compute dtype); ``population``: clients and online rate."""
    fed = tcfg.FederatedConfig(
        federated=True, num_clients=population[0],
        online_client_rate=population[1], algorithm="fedavg",
        sync_type="local_step", quantized=True)
    train = tcfg.TrainConfig(local_step=LOCAL_STEPS)
    mesh = tcfg.MeshConfig(compute_dtype=dtype)
    if arch == "transformer":
        return tcfg.ExperimentConfig(
            data=tcfg.DataConfig(dataset="shakespeare", batch_size=LM_BATCH),
            federated=fed,
            model=tcfg.ModelConfig(arch="transformer", attention="flash",
                                   **lm),
            optim=tcfg.OptimConfig(lr=0.05, weight_decay=0.0),
            train=train, mesh=mesh).finalize()
    kw = {} if widen is None else dict(wideresnet_widen_factor=widen)
    kw.update(model or {})
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=BATCH),
        federated=fed, model=tcfg.ModelConfig(arch=arch, **kw),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True), train=train,
        mesh=mesh).finalize()


def path_data(cfg, seed, stack_partitions, clients=NUM_CLIENTS):
    """``clients`` clients' data made from ``seed``: CIFAR-10-shaped
    images and labels, or next-character windows of a random character
    stream with their next-token labels."""
    rng = np.random.RandomState(seed)
    if cfg.model.arch == "transformer":
        T, per = cfg.model.rnn_seq_len, LM_WINDOWS
        stream = rng.randint(0, cfg.model.vocab_size,
                             clients * per * T + 1).astype(np.int32)
        feats = stream[:-1].reshape(-1, T)
        labels = stream[1:].reshape(-1, T)
    else:
        per = SAMPLES
        feats = rng.randn(clients * per, 32, 32, 3).astype(np.float32)
        labels = rng.randint(0, 10, clients * per)
    parts = [np.arange(i * per, (i + 1) * per) for i in range(clients)]
    return stack_partitions(feats, labels, parts)


def main_path_phase(seed, tcfg, define_model, make_algorithm,
                    stack_partitions, FederatedTrainer, qk, fa,
                    arch="resnet20", widen=None, timed_rounds=TIMED_ROUNDS,
                    lm=LM, dtype="bfloat16", model=None,
                    population=(NUM_CLIENTS, ONLINE_RATE)):
    """A quantized FedAvg main path on ``arch`` through the library entry
    points (``population``: clients and online rate); returns (numbers,
    trainer, server, clients)."""
    cfg = path_config(tcfg, arch, widen, lm, dtype, model, population)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = path_data(cfg, seed, stack_partitions, population[0])
    model = define_model(cfg, batch_size=cfg.data.batch_size)
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data)
    del data
    server, clients = trainer.init_state(seed)
    init = {k: v.clone() for k, v in server.params.items()}
    expect = launches_per_round(qk, [v.numel() for v in init.values()])
    # one forward per attention layer and local step of each online client,
    # all on one kernel: bfloat16 at a head dim of TC_HEAD_DIMS on the
    # wgmma kernel, anything else on the TF32 kernel
    expect["flash"] = (cfg.model.mlp_num_layers * trainer.local_steps
                       * trainer.k_online if arch == "transformer" else 0)
    head_dim = 2 * lm["rnn_hidden_size"] // 4
    tc = dtype == "bfloat16" and head_dim in fa.TC_HEAD_DIMS
    expect["flash_tc"] = expect["flash"] if tc else 0
    expect["flash_tf32"] = expect["flash"] - expect["flash_tc"]
    setup_s = time.perf_counter() - t0
    init_mib = torch.cuda.memory_allocated() / 2**20
    log(f"{arch}: set-up {setup_s:.2f} s (data, model, state; "
        f"{sum(v.numel() for v in init.values()):,} params; "
        f"{init_mib:.0f} MiB on the card)")

    reset_counters(qk, fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server, clients, _ = trainer.run_rounds(server, clients, 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    server, clients, metrics = trainer.run_rounds(server, clients,
                                                  timed_rounds)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launched = counters(qk, fa)
    total_ms = start.elapsed_time(end)

    rounds = 1 + timed_rounds
    want = {c: n * rounds for c, n in expect.items()}
    if launched != want:
        raise AssertionError(f"{arch}: kernels launched {launched} in "
                             f"{rounds} rounds, expected {want}")
    online = metrics.online_mask.bool()
    losses = metrics.train_loss[online]
    if losses.numel() != timed_rounds * trainer.k_online \
            or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"bad losses {losses.tolist()}")
    if not all(bool(torch.isfinite(v).all())
               for v in server.params.values()):
        raise AssertionError("non-finite server params")
    moved = max(float((server.params[k] - init[k]).abs().max())
                for k in init)
    if not moved > 0.0:
        raise AssertionError("server params did not change")
    steps = timed_rounds * trainer.k_online * trainer.local_steps
    round_ms = total_ms / timed_rounds
    out = dict(arch=arch, widen=widen, dtype=dtype,
               d_model=2 * lm["rnn_hidden_size"] if arch == "transformer"
               else None, params=sum(v.numel() for v in init.values()),
               round_ms=round_ms,
               local_steps_per_s=steps / (total_ms / 1e3),
               timed_rounds=timed_rounds, setup_s=setup_s,
               warmup_round_s=warm_s, host_wall_s=host_s, launches=launched,
               tree_launches=want,
               launches_per_round={c: n / rounds
                                   for c, n in launched.items()},
               mean_loss=float(losses.mean()),
               max_param_change=moved, num_clients=population[0],
               online_rate=population[1], k_online=trainer.k_online,
               init_state_mib=init_mib,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    out["costs"] = round_costs(trainer, server, round_ms, dtype)
    log(f"{arch} main path: {round_ms:.1f} ms/round, "
        f"{out['local_steps_per_s']:.1f} local-steps/s, launches in "
        f"{rounds} rounds {launched}, peak {out['peak_mib']:.0f} MiB")
    return out, trainer, server, clients


def round_costs(trainer, server, round_ms, dtype) -> dict:
    """The round's FLOPs as the CLI's cost capture counts them
    (``telemetry.costs.round_flops``: a training step on copies of the
    params and the first client's first batch, outside every counted
    window) and its MFU at ``round_ms`` against the card's peak for
    ``dtype`` (``round_peak_tflops``: the flash forward at its kernel's
    own rate)."""
    from fedtorch_tpu_torch.telemetry.costs import (
        round_flops, round_peak_tflops,
    )
    B = trainer.batch_size
    t0 = time.perf_counter()
    counted = round_flops(trainer, server.params, trainer.data.x[0, :B],
                          trainer.data.y[0, :B])
    peak, source = round_peak_tflops(counted, dtype,
                                     torch.cuda.get_device_name(0))
    return dict(flops=counted, peak_tflops=peak, peak_source=source,
                mfu=counted["round"] / (round_ms / 1e3 * peak * 1e12)
                if peak else None,
                count_s=time.perf_counter() - t0)


def _params_gap(got, want) -> float:
    return max(float((got[k].float() - want[k].float()).abs().max())
               for k in want)


def stream_path(name, cfg, data, seed, define_model, make_algorithm,
                FederatedTrainer, qk, fa, ref_store, *, scan=False,
                depth=2, rounds=1 + STREAM_TIMED_ROUNDS):
    """One path of the stream phase: a trainer on ``cfg``'s data plane,
    ``rounds`` rounds from ``seed`` (the first a warm-up) through
    ``run_round``; with ``scan``, one timed ``run_rounds(rounds)`` window
    and no warm-up (the paths before it warmed the process up). On a stream path every
    consumed feed's device rows are held bitwise against a fresh gather
    of its plan from ``ref_store`` (the population in RAM), copied over
    synchronously. Returns (numbers, final server params, generator
    state)."""
    from fedtorch_tpu_torch.data.streaming import feed_nbytes

    stream = cfg.data.data_plane == "stream"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = define_model(cfg, batch_size=cfg.data.batch_size)
    m_model = torch.cuda.memory_allocated()
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data)
    m_data = torch.cuda.memory_allocated() - m_model
    trainer.stream_depth = depth
    server, clients = trainer.init_state(seed)
    torch.cuda.synchronize()
    m_state = torch.cuda.memory_allocated()
    checked = dict(feeds=0, rows=0, check_s=0.0, nbytes=0, device_nbytes=0)
    if stream:
        round_stream_fn = trainer.round_stream_fn

        def checked_round(server, clients, feed):
            t0 = time.perf_counter()
            want = ref_store.pack(feed.idx.numpy(), feed.rows.numpy(),
                                  cfg.data.batch_size)
            for f in ("x", "y", "pre_x", "pre_y"):
                got = getattr(feed, f)
                if got.device != trainer.device or not torch.equal(
                        got, getattr(want, f).to(got.device)):
                    raise AssertionError(
                        f"stream {name}: feed {f} of round {server.round} "
                        "differs from a fresh host gather of its plan")
            checked["feeds"] += 1
            checked["rows"] += int(feed.x.shape[0] * feed.x.shape[1])
            checked["check_s"] += time.perf_counter() - t0
            checked["nbytes"] = feed_nbytes(feed)
            checked["device_nbytes"] = sum(
                getattr(feed, f).numel() * getattr(feed, f).element_size()
                for f in ("x", "y", "pre_x", "pre_y"))
            return round_stream_fn(server, clients, feed)

        trainer.round_stream_fn = checked_round

    reset_counters(qk, fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not scan:
        server, clients, _ = trainer.run_round(server, clients)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    before = dict(trainer.stream_stats() or {})
    producer = trainer._stream
    timed = rounds if scan else rounds - 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if scan:
        server, clients, _ = trainer.run_rounds(server, clients, timed)
    else:
        for _ in range(timed):
            server, clients, _ = trainer.run_round(server, clients)
    end.record()
    torch.cuda.synchronize()
    round_ms = start.elapsed_time(end) / timed
    launched = counters(qk, fa)
    want = dict(ragged_stats=2 * rounds, ragged_apply=2 * rounds, stats=0,
                apply=0, flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"stream {name}: kernels launched {launched} "
                             f"in {rounds} rounds, expected {want}")
    if stream and checked["feeds"] != rounds:
        raise AssertionError(f"stream {name}: {checked['feeds']} feeds "
                             f"checked in {rounds} rounds")
    stats = trainer.stream_stats() or {}
    if trainer._stream is not producer:
        # the window changed: the timed rounds ran on a new producer
        before = dict.fromkeys(before, 0.0)
    per_round = {k: (stats[k] - before.get(k, 0.0)) / timed
                 for k in ("gather_s", "h2d_s", "wait_s")} if stream else {}
    # the feeds the producer holds ahead, once its queue is full
    deadline = time.monotonic() + 5.0
    while stream and trainer.stream_stats()["depth"] < depth \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    torch.cuda.synchronize()
    ahead = torch.cuda.memory_allocated() - m_state
    params = {k: v.detach().clone() for k, v in server.params.items()}
    rng_state = server.rng.get_state()
    trainer.close()
    if stream and any(t.name == "stream-feed-producer" and t.is_alive()
                      for t in threading.enumerate()):
        raise AssertionError(f"stream {name}: producer thread outlived "
                             "close()")
    out = dict(path=name, data_plane=cfg.data.data_plane,
               store=cfg.data.store if stream else None,
               dispatch="scan" if scan else "round", depth=depth,
               rounds=rounds, timed_rounds=timed, round_ms=round_ms,
               warmup_round_s=warm_s, launches=launched, tree_launches=want,
               launches_per_round={c: n / rounds
                                   for c, n in launched.items()},
               stream_stats_per_round=per_round,
               stream_stats_total=stats,
               feeds_checked=checked["feeds"],
               rows_checked=checked["rows"],
               check_ms_per_round=checked["check_s"] / rounds * 1e3,
               feed_nbytes=checked["nbytes"],
               feed_device_nbytes=checked["device_nbytes"],
               data_mib_at_construction=m_data / 2**20,
               mib_held_after_rounds=ahead / 2**20,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    log(f"stream {name}: {round_ms:.1f} ms/round over {timed}, data on the "
        f"card {m_data / 2**20:.1f} MiB at construction, "
        f"{ahead / 2**20:.1f} MiB held after the rounds, feeds checked "
        f"{checked['feeds']}, per round {per_round}")
    return out, params, rng_state


def stream_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
                 FederatedTrainer, qk, fa):
    """The north-star quantized FedAvg round on the stream data plane: the
    100-client population written with ``save_client_store``, then from
    one seed ``resident`` (twice: its own spread), ``stream_ram``,
    ``stream_mmap``, each 1 warm-up and 1 timed round,
    ``stream_mmap_scan`` (one timed window of 2, no warm-up), and
    ``stream_mmap_depth1`` (depth 1,
    ``STREAM_STRESS_ROUNDS`` rounds back to back). cuDNN runs
    deterministic here, so that the paths can be held to each other: each stream path's server params after its 2
    rounds within ``SPREAD_FACTOR`` times the two resident runs' gap (0:
    bitwise), its generator state bitwise."""
    import dataclasses
    import tempfile

    from fedtorch_tpu_torch.data.streaming import (
        HostClientStore, save_client_store,
    )
    from fedtorch_tpu_torch.tools.order_spread import SPREAD_FACTOR

    cfg = path_config(tcfg, "resnet20")
    data = path_data(cfg, seed, stack_partitions)
    ref_store = HostClientStore(data)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as store_dir:
            t0 = time.perf_counter()
            save_client_store(store_dir, data)
            write_s = time.perf_counter() - t0
            store_bytes = sum(os.path.getsize(os.path.join(store_dir, n))
                              for n in os.listdir(store_dir))
            log(f"stream: store of {NUM_CLIENTS} clients, {store_bytes:,} "
                f"bytes, written in {write_s:.2f} s")

            def plane(**kw):
                return dataclasses.replace(cfg, data=dataclasses.replace(
                    cfg.data, **kw))

            mmap = plane(data_plane="stream", store="mmap",
                         store_dir=store_dir)
            runs = [("resident", cfg, {}), ("resident_again", cfg, {}),
                    ("stream_ram", plane(data_plane="stream"), {}),
                    ("stream_mmap", mmap, {}),
                    ("stream_mmap_scan", mmap, dict(scan=True)),
                    ("stream_mmap_depth1", mmap,
                     dict(depth=1, rounds=STREAM_STRESS_ROUNDS))]
            paths, finals = {}, {}
            for name, run_cfg, kw in runs:
                paths[name], params, rng = stream_path(
                    name, run_cfg, data, seed, define_model, make_algorithm,
                    FederatedTrainer, qk, fa, ref_store, **kw)
                finals[name] = (params, rng)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    spread = _params_gap(finals["resident_again"][0], finals["resident"][0])
    bar = SPREAD_FACTOR * spread
    trajectory = {}
    for name in ("resident_again", "stream_ram", "stream_mmap",
                 "stream_mmap_scan"):
        params, rng = finals[name]
        gap = _params_gap(params, finals["resident"][0])
        same_rng = bool(torch.equal(rng, finals["resident"][1]))
        trajectory[name] = dict(max_abs_gap=gap, rng_state_equal=same_rng)
        if gap > bar or not same_rng:
            raise AssertionError(
                f"stream {name}: server params {gap} from resident's (bar "
                f"{bar}: {SPREAD_FACTOR} x the resident runs' {spread}), "
                f"generator state equal: {same_rng}")
    resident_ms = paths["resident"]["round_ms"]
    for out in paths.values():
        out["round_ms_over_resident"] = out["round_ms"] / resident_ms
    log(f"stream: resident spread {spread}, trajectories {trajectory}")
    return dict(store_bytes=store_bytes, store_write_s=write_s,
                clients=NUM_CLIENTS, resident_spread=spread,
                spread_factor=SPREAD_FACTOR, trajectory=trajectory,
                cudnn_deterministic=True, paths=paths)


def write_cifar10(root: str, seed: int) -> float:
    """A CIFAR-10 python-pickle tree (``cifar-10-batches-py``: five
    training batches of 10,000 images and a test batch of 10,000) of
    random pixels and labels made from ``seed``, the layout the real
    files have; returns the megabytes written."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        batch = {b"batch_label": name.encode(),
                 b"labels": rng.randint(0, 10, CLI_BATCH_IMAGES).tolist(),
                 b"data": rng.randint(0, 256, (CLI_BATCH_IMAGES, 3072),
                                      dtype=np.uint8)}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f, protocol=pickle.HIGHEST_PROTOCOL)
    return sum(os.path.getsize(os.path.join(base, n)) for n in names) / 1e6


def cli_stream_run(root, cohort, qk, fa, extra=()):
    """``CLI_ARGV`` on the CIFAR-10 files in ``root`` on the stream plane,
    from an on-disk store written from the same files (``--data_plane
    stream --data_store mmap``): 2 + 2 ragged launches a round, round 0's
    cohort the device-plane run's ``cohort``, finite loss lines."""
    import glob

    from fedtorch_tpu_torch import cli
    from fedtorch_tpu_torch.data import build_federated_data
    from fedtorch_tpu_torch.data.streaming import save_client_store

    argv = CLI_ARGV + list(extra) + ["-p", root]
    store_dir = os.path.join(root, "store")
    t0 = time.perf_counter()
    save_client_store(store_dir, build_federated_data(
        cli.args_to_config(cli.build_parser().parse_args(argv))).train)
    store_s = time.perf_counter() - t0
    seen = {}

    def keep_cohort(r, trainer, server, clients, metrics):
        if r == 0:
            seen["cohort"] = metrics.online_mask.nonzero().flatten().tolist()
            seen["stats"] = trainer.stream_stats()

    reset_counters(qk, fa)
    res = cli.main(argv + ["-c", os.path.join(root, "runs_stream"),
                           "--data_plane", "stream", "--data_store", "mmap",
                           "--data_store_dir", store_dir],
                   round_callback=keep_cohort)
    launched = counters(qk, fa)
    (record,) = glob.glob(os.path.join(root, "runs_stream", "**", "record0"),
                          recursive=True)
    with open(record) as f:
        losses = [float(v) for v in re.findall(
            r"Round: \d+\. Epoch: .*? Loss: (\S+) \|", f.read())]
    want = dict(ragged_stats=2 * CLI_ROUNDS, ragged_apply=2 * CLI_ROUNDS,
                stats=0, apply=0, flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"cli stream: kernels launched {launched}, "
                             f"expected {want}")
    if seen["cohort"] != cohort or res["data_plane"] != "stream":
        raise AssertionError(f"cli stream: round-0 cohort {seen['cohort']},"
                             f" the device plane's {cohort}")
    if len(losses) != CLI_ROUNDS \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli stream: loss lines {losses}")
    out = dict(rounds=res["rounds"], test_top1=res["test_top1"],
               store_write_s=store_s, round0_cohort=seen["cohort"],
               losses=losses,
               round_ms=res["timer"]["round"] / CLI_ROUNDS * 1e3,
               stream_stats_after_round0=seen["stats"], launches=launched,
               tree_launches=launched)
    log(f"cli stream (mmap store written in {store_s:.2f} s): "
        f"{out['round_ms']:.1f} ms/round, round-0 cohort {seen['cohort']} "
        f"as the device plane's, losses {losses}, test top-1 "
        f"{res['test_top1']:.4f}")
    return out


def cli_fused_run(root, cohort, qk, fa):
    """``CLI_ARGV`` for ``CLI_FUSED_ROUNDS`` rounds with ``--client_fusion
    fused`` on the CIFAR-10 files in ``root``: 2 + 2 ragged launches a
    round, round 0's cohort the per-client ('vmap') run's ``cohort``,
    finite loss lines and a test top-1 in [0, 1]."""
    import glob

    from fedtorch_tpu_torch import cli

    seen = {}

    def keep_cohort(r, trainer, server, clients, metrics):
        if r == 0:
            seen["cohort"] = metrics.online_mask.nonzero().flatten().tolist()
            seen["execution"] = trainer.client_fusion

    argv = CLI_ARGV + ["-p", root, "-c", os.path.join(root, "runs_fused"),
                       "--num_comms", str(CLI_FUSED_ROUNDS),
                       "--client_fusion", "fused"]
    reset_counters(qk, fa)
    res = cli.main(argv, round_callback=keep_cohort)
    launched = counters(qk, fa)
    (record,) = glob.glob(os.path.join(root, "runs_fused", "**", "record0"),
                          recursive=True)
    with open(record) as f:
        losses = [float(v) for v in re.findall(
            r"Round: \d+\. Epoch: .*? Loss: (\S+) \|", f.read())]
    want = dict(ragged_stats=2 * CLI_FUSED_ROUNDS,
                ragged_apply=2 * CLI_FUSED_ROUNDS, stats=0, apply=0,
                flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"cli fused: kernels launched {launched}, "
                             f"expected {want}")
    if seen["cohort"] != cohort or seen["execution"] != "fused" \
            or res["rounds"] != CLI_FUSED_ROUNDS \
            or not 0.0 <= res["test_top1"] <= 1.0:
        raise AssertionError(f"cli fused: {seen}, the vmap run's cohort "
                             f"{cohort}; results {res}")
    if len(losses) != CLI_FUSED_ROUNDS \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli fused: loss lines {losses}")
    out = dict(rounds=res["rounds"], test_top1=res["test_top1"],
               round0_cohort=seen["cohort"], losses=losses,
               round_ms=res["timer"]["round"] / CLI_FUSED_ROUNDS * 1e3,
               data_build_s=res["timer"]["data"], launches=launched,
               tree_launches=launched)
    log(f"cli fused: {out['round_ms']:.1f} ms/round, round-0 cohort "
        f"{seen['cohort']} as the vmap run's, losses {losses}, test top-1 "
        f"{res['test_top1']:.4f}")
    return out


DEVICE_GAUGES = ("model_flops_utilization", "hbm_program_peak_bytes",
                 "hbm_live_bytes", "round_device_min_s", "round_host_frac")


def cli_costs(runs_root: str) -> dict:
    """The CLI run's cost capture (telemetry on): ``program_costs.json``
    must exist and validate, its ``cost.capture`` event say ok, and every
    metrics row carry the five device gauges; a capture that failed (and
    was logged, as the CLI must) fails the phase."""
    import glob

    from fedtorch_tpu_torch.telemetry import load_jsonl
    from fedtorch_tpu_torch.telemetry.costs import read_program_costs
    (metrics,) = glob.glob(os.path.join(runs_root, "**", "metrics.jsonl"),
                           recursive=True)
    run_dir = os.path.dirname(metrics)
    doc = read_program_costs(run_dir)
    rows = _rows(run_dir)
    _, events, _ = load_jsonl(os.path.join(run_dir, "events.jsonl"))
    capture = [e.get("ok") for e in events if e["event"] == "cost.capture"]
    missing = {r["round"]: [g for g in DEVICE_GAUGES if g not in r]
               for r in rows}
    if doc is None or capture != [True] \
            or any(missing.values()) or not rows:
        raise AssertionError(f"cli cost capture: document "
                             f"{doc is not None}, events {capture}, "
                             f"gauges missing {missing}")
    primary = doc["programs"][doc["primary"]]
    out = dict(primary=doc["primary"], flops=primary["flops"],
               flops_breakdown=doc["run"]["flops_breakdown"],
               peak_tflops=doc["peak_tflops_per_chip"],
               peak_source=doc["peak_source"], card=doc["run"]["card"],
               **{g: [r[g] for r in rows] for g in DEVICE_GAUGES})
    log(f"cli cost capture: {out}")
    return out


def cli_phase(seed, tcfg, define_model, qk, fa):
    """The port's CLI as a user runs it (``fedtorch_tpu_torch.cli.main``
    on ``CLI_ARGV``) on CIFAR-10 files written from ``seed`` into a
    temporary directory, which also takes the run's log (``-c``). The
    counters are set to 0 just before and must read 2 ragged stats and 2
    ragged apply launches per round after. Then the final server params
    are evaluated on the first ``CLI_SUBSET`` test images on the card and
    on the CPU, both in float32 (TF32 off), and must agree within
    ``CLI_EVAL_BAR``. Then the same command on the stream plane from a
    store written from the same files (``--data_plane stream --data_store
    mmap``): 2 + 2 ragged launches a round, the device-plane run's round-0
    cohort and finite loss lines. Returns the phase's numbers."""
    import tempfile

    from fedtorch_tpu_torch import cli
    from fedtorch_tpu_torch.data.datasets import load_cifar
    from fedtorch_tpu_torch.parallel.evaluate import evaluate

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        mb = write_cifar10(root, seed)
        write_s = time.perf_counter() - t0
        argv = CLI_ARGV + ["-p", root, "-c", os.path.join(root, "runs")]
        final = {}

        def keep_final(r, trainer, server, clients, metrics):
            if r == 0:
                final["cohort"] = \
                    metrics.online_mask.nonzero().flatten().tolist()
            if r == CLI_ROUNDS - 1:
                final["params"] = {k: v.detach().clone()
                                   for k, v in server.params.items()}
                final["cfg"] = trainer.cfg

        reset_counters(qk, fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(argv, round_callback=keep_final)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launched = counters(qk, fa)
        costs = cli_costs(os.path.join(root, "runs"))
        test_x, test_y = load_cifar("cifar10", root)[2:4]

        gc.collect()
        torch.cuda.empty_cache()
        stream_out = cli_stream_run(root, final["cohort"], qk, fa)
        gc.collect()
        torch.cuda.empty_cache()
        fused_out = cli_fused_run(root, final["cohort"], qk, fa)
    want = dict(ragged_stats=2 * CLI_ROUNDS, ragged_apply=2 * CLI_ROUNDS,
                stats=0, apply=0, flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"cli: kernels launched {launched}, expected "
                             f"{want}")
    if res.get("rounds") != CLI_ROUNDS or not all(
            math.isfinite(res[k]) and 0.0 <= res[k] <= 1.0
            for k in ("test_top1", "best_top1")):
        raise AssertionError(f"cli results {res}")
    timer = res["timer"]

    # the final server params, evaluated on the card and on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import dataclasses
    cfg = final["cfg"]
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, compute_dtype="float32"))
    x, y = test_x[:CLI_SUBSET], test_y[:CLI_SUBSET]
    got = [float(v) for v in evaluate(define_model(cfg, device="cuda"),
                                      final["params"], x, y)]
    want_cpu = [float(v) for v in evaluate(
        define_model(cfg, device="cpu"),
        {k: v.cpu() for k, v in final["params"].items()}, x, y)]
    torch.backends.cudnn.allow_tf32 = True
    loss_rel = abs(got[0] - want_cpu[0]) / abs(want_cpu[0])
    top_gap = [abs(g - w) * CLI_SUBSET for g, w in zip(got[1:], want_cpu[1:])]
    out = dict(argv=CLI_ARGV, rounds=res["rounds"],
               test_top1=res["test_top1"], best_top1=res["best_top1"],
               data_mb_written=mb, data_write_s=write_s,
               data_build_s=timer["data"],
               round_ms=timer["round"] / CLI_ROUNDS * 1e3,
               eval_ms_per_call=timer["eval"] / CLI_ROUNDS * 1e3,
               run_s=run_s, launches=launched,
               launches_per_round={c: n / CLI_ROUNDS
                                   for c, n in launched.items()},
               subset_eval=dict(images=CLI_SUBSET, card=got, cpu=want_cpu,
                                loss_rel_diff=loss_rel,
                                top1_top5_diff_images=top_gap,
                                bar=CLI_EVAL_BAR),
               stream_mmap=stream_out, fused=fused_out, costs=costs)
    log(f"cli: {mb:.1f} MB of CIFAR-10 files written in {write_s:.2f} s; "
        f"data build {timer['data']:.2f} s, {out['round_ms']:.1f} ms/round, "
        f"eval {out['eval_ms_per_call']:.1f} ms per call "
        f"({len(test_y):,} images), "
        f"test top-1 {res['test_top1']:.4f} (best {res['best_top1']:.4f}); "
        f"launches {launched}; final params on {CLI_SUBSET} test images, "
        f"float32 card vs CPU: loss {got[0]:.6f} vs {want_cpu[0]:.6f} "
        f"(relative {loss_rel:.3e}), top-1/top-5 apart by {top_gap} images")
    if loss_rel > CLI_EVAL_BAR["loss_rel"] \
            or max(top_gap) > CLI_EVAL_BAR["top_images"]:
        raise AssertionError(f"cli: card evaluate vs CPU {got} vs "
                             f"{want_cpu}")
    return out


PERSONAL_LINE = re.compile(r"Round: (\d+)\. Mode: validation_personal\. "
                           r"Loss: (\S+) \| top1: (\S+)")


def cli_apfl_phase(seed, qk, fa):
    """The CLI's APFL run: ``CLI_ARGV`` plus ``CLI_APFL_WORDS`` on the
    CIFAR-10 files written from ``seed``: 2 + 2 ragged launches a round,
    and one ``validation_personal`` line a round in the run's log with a
    finite loss and top-1 in [0, 1]."""
    import glob
    import tempfile

    from fedtorch_tpu_torch import cli
    with tempfile.TemporaryDirectory() as root:
        write_cifar10(root, seed)
        runs = os.path.join(root, "runs")
        reset_counters(qk, fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(CLI_ARGV + CLI_APFL_WORDS + ["-p", root, "-c", runs])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launched = counters(qk, fa)
        (record,) = glob.glob(os.path.join(runs, "cifar10", "resnet20", "*",
                                           "record0"))
        lines = [(int(r), float(loss), float(top1)) for r, loss, top1 in
                 PERSONAL_LINE.findall(open(record).read())]
    want = dict(ragged_stats=2 * CLI_APFL_ROUNDS,
                ragged_apply=2 * CLI_APFL_ROUNDS, stats=0, apply=0, flash=0,
                flash_tc=0, flash_tf32=0)
    if launched != want or res.get("rounds") != CLI_APFL_ROUNDS:
        raise AssertionError(f"cli apfl: launches {launched} (want {want}),"
                             f" results {res}")
    if [r for r, _, _ in lines] != list(range(CLI_APFL_ROUNDS)) or not all(
            math.isfinite(loss) and 0.0 <= top1 <= 1.0
            for _, loss, top1 in lines):
        raise AssertionError(f"cli apfl: validation_personal lines {lines}")
    out = dict(argv=CLI_ARGV + CLI_APFL_WORDS, rounds=res["rounds"],
               test_top1=res["test_top1"], run_s=run_s,
               round_ms=res["timer"]["round"] / CLI_APFL_ROUNDS * 1e3,
               validation_personal=lines, launches=launched,
               tree_launches=launched)
    log(f"cli apfl: {out['round_ms']:.1f} ms/round, validation_personal "
        f"{lines}, launches {launched}")
    return out


def zoo_config(tcfg, fed, optim, arch="resnet20", dtype="bfloat16",
               clients=NUM_CLIENTS, rate=ONLINE_RATE, batch=BATCH,
               steps=LOCAL_STEPS, dataset="cifar10", **model):
    """A zoo path's round: the north-star round's sizes with ``fed``'s
    algorithm and wire format and ``optim``'s overrides."""
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset=dataset, batch_size=batch),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=clients, online_client_rate=rate,
            sync_type="local_step", **fed),
        model=tcfg.ModelConfig(arch=arch, **model),
        optim=tcfg.OptimConfig(**{"lr": 0.1, "in_momentum": True,
                                  **optim}),
        train=tcfg.TrainConfig(local_step=steps),
        mesh=tcfg.MeshConfig(compute_dtype=dtype)).finalize()


def _leaves(tree, path=""):
    """(path, tensor) of every tensor of a nested state tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _check_lambda(name, lam):
    """AFL's and DRFA's dual variable: on the simplex."""
    total = float(lam.double().sum())
    if abs(total - 1.0) > 1e-6 or not bool((lam >= 0).all()):
        raise AssertionError(f"{name}: lambda sums to {total}, min "
                             f"{float(lam.min())}")
    return total


def _check_alpha(name, alpha, online):
    """APFL's alpha after a round: in [0, 1], one value for the round's
    online clients (the mean that pre_round writes to each)."""
    on = alpha[online.bool()]
    if not (bool(((on >= 0) & (on <= 1)).all())
            and float(on.max() - on.min()) == 0.0):
        raise AssertionError(f"{name}: online alpha {on.tolist()}")
    return float(on[0])


def zoo_path(name, fed, optim, data, seed, tcfg, define_model,
             make_algorithm, FederatedTrainer, qk, fa, val=None):
    """One zoo path at the north-star sizes through the library entry
    points: ``ZOO_TIMED_ROUNDS`` timed rounds (no warm-up: the main path
    warmed the model's kernels), the counters set to 0 just before and
    read just after; finite losses, moved and
    finite server params, every aux tree finite, lambda on the simplex.
    A personalized path trains on ``data`` with ``val`` as the clients'
    validation rows, then runs ``evaluate_personal`` once, timed: finite
    [C] losses and summary, APFL's online alpha one value in [0, 1]."""
    from fedtorch_tpu_torch.parallel import evaluate_personal
    cfg = zoo_config(tcfg, fed, optim, rate=ZOO_ONLINE_RATE)
    model = define_model(cfg, batch_size=cfg.data.batch_size)
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data,
                               val_data=val)
    server, clients = trainer.init_state(seed)
    init = {k: v.clone() for k, v in server.params.items()}
    per = launches_per_round(qk, [v.numel() for v in init.values()]) \
        if cfg.federated.quantized else dict.fromkeys(
            ("ragged_stats", "ragged_apply", "stats", "apply"), 0)
    per.update(flash=0, flash_tc=0, flash_tf32=0)
    rounds = ZOO_TIMED_ROUNDS
    reset_counters(qk, fa)
    # the timed rounds' wire-format calls between CUDA events
    wire = []
    for hook in ("payload_batch_transform", "aggregate_transform"):
        def timed(tree, _real=getattr(trainer.algorithm, hook)):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = _real(tree)
            ev[1].record()
            wire.append(ev)
            return out
        setattr(trainer.algorithm, hook, timed)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    server, clients, metrics = trainer.run_rounds(server, clients,
                                                  ZOO_TIMED_ROUNDS)
    end.record()
    torch.cuda.synchronize()
    wire_ms = sum(a.elapsed_time(b) for a, b in wire) / ZOO_TIMED_ROUNDS
    launched = counters(qk, fa)
    want = {c: n * rounds for c, n in per.items()}
    if launched != want:
        raise AssertionError(f"zoo {name}: kernels launched {launched} in "
                             f"{rounds} rounds, expected {want}")
    losses = metrics.train_loss[metrics.online_mask.bool()]
    if losses.numel() != ZOO_TIMED_ROUNDS * trainer.k_online \
            or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"zoo {name}: bad losses {losses.tolist()}")
    for where, t in itertools.chain(
            _leaves(server.params, "params"), _leaves(server.aux, "server"),
            _leaves(clients.aux, "clients")):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"zoo {name}: non-finite {where}")
    moved = max(float((server.params[k] - init[k]).abs().max())
                for k in init)
    if not moved > 0.0:
        raise AssertionError(f"zoo {name}: server params did not change")
    round_ms = start.elapsed_time(end) / ZOO_TIMED_ROUNDS
    out = dict(path=name, algorithm=cfg.effective_algorithm,
               quantized=cfg.federated.quantized,
               compressed_ratio=cfg.federated.compressed_ratio
               if cfg.federated.compressed else None,
               local_steps=trainer.local_steps, round_ms=round_ms,
               local_steps_per_s=trainer.k_online * trainer.local_steps
               / (round_ms / 1e3),
               timed_rounds=ZOO_TIMED_ROUNDS, launches=launched,
               tree_launches=want,
               launches_per_round={c: n / rounds
                                   for c, n in launched.items()},
               wire_format_ms_per_round=wire_ms,
               losses_finite=True, aux_finite=True,
               mean_loss=float(losses.mean()), max_param_change=moved)
    if "lambda" in server.aux:
        out["lambda_sum"] = _check_lambda(name, server.aux["lambda"])
        out["lambda_min"] = float(server.aux["lambda"].min())
    if val is not None:
        t0 = time.perf_counter()
        p_loss, _, summary = evaluate_personal(
            model, clients.aux, clients.params, trainer.val_data,
            cfg.effective_algorithm)
        torch.cuda.synchronize()
        out["evaluate_personal_ms"] = (time.perf_counter() - t0) * 1e3
        if not (bool(torch.isfinite(p_loss).all()) and all(
                math.isfinite(v) for v in summary.values())):
            raise AssertionError(f"zoo {name}: evaluate_personal {summary}")
        out.update(evaluate_personal=summary,
                   val_rows_per_client=int(trainer.val_data.sizes[0]),
                   train_rows_per_client=trainer.sizes[0])
        if "alpha" in clients.aux:
            out["alpha"] = _check_alpha(name, clients.aux["alpha"],
                                        metrics.online_mask[-1])
    log(f"zoo {name}: {round_ms:.1f} ms/round ({trainer.local_steps} local "
        f"steps; wire format {wire_ms:.4f} ms), losses finite, params "
        f"moved {moved:.3e}, aux finite, "
        f"launches per round {out['launches_per_round']}"
        + (f", lambda sum {out['lambda_sum']:.9f} min "
           f"{out['lambda_min']:.3e}" if "lambda_sum" in out else "")
        + (f"; evaluate_personal {out['evaluate_personal_ms']:.1f} ms: "
           f"{out['evaluate_personal']}" if val is not None else "")
        + (f", online alpha {out['alpha']:.6f}" if "alpha" in out else ""))
    return out


def _rel_l2(got, want) -> float:
    got, want = got.double().flatten(), want.double().flatten()
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got - want))
    return num / den if den > 0 else num


def zoo_card_vs_cpu(name, fed, optim, tcfg, define_model, make_algorithm,
                    stack_partitions, FederatedTrainer):
    """One round of ``name`` at a small size (an MLP of 2 x 32 on 60
    features, 8 clients, k = 2, batch 8, 2 local steps, float32,
    unquantized), same weights and plan (drawn once, DRFA's draws
    included), on the CPU and on the card with TF32 off: the update's
    and each aux tree's relative L2 within ``ZOO_CARD_BAR``."""
    from fedtorch_tpu_torch.data.batching import train_val_split
    from fedtorch_tpu_torch.parallel import evaluate_personal
    C, B = 8, 8
    cfg = zoo_config(tcfg, fed, optim, arch="mlp", dtype="float32",
                     clients=C, rate=0.25, batch=B, steps=2,
                     dataset="synthetic", mlp_hidden_size=32)
    N = 20 if cfg.federated.personal else 16
    rng = np.random.RandomState(11)
    feats = rng.randn(C * N, 60).astype(np.float32)
    labels = rng.randint(0, 10, C * N)
    parts = [np.arange(N * i, N * i + N) for i in range(C)]
    val = None
    if cfg.federated.personal:
        # 16 train and 4 val rows a client
        parts, vparts = train_val_split(parts, cfg.data.val_fraction)
        val = stack_partitions(feats, labels, vparts)
    data = stack_partitions(feats, labels, parts)
    runs, plan = [], None
    for dev in ("cpu", "cuda"):
        tr = FederatedTrainer(cfg, define_model(cfg, B, device=dev),
                              make_algorithm(cfg), data, val_data=val,
                              device=dev)
        server, clients = tr.init_state(12)
        p0 = {k: v.cpu() for k, v in server.params.items()}
        plan = plan or tr.draw_plan(server)
        server, clients, metrics = tr.round_fn(server, clients, plan)
        if "alpha" in clients.aux:
            _check_alpha(name, clients.aux["alpha"], metrics.online_mask)
        runs.append(dict(
            update={k: v.cpu() - p0[k] for k, v in server.params.items()},
            aux={p: t.cpu() for p, t in itertools.chain(
                _leaves(server.aux, "server"), _leaves(clients.aux,
                                                       "clients"))},
            personal=evaluate_personal(
                tr.model, clients.aux, clients.params, tr.val_data,
                cfg.effective_algorithm)[2] if val is not None else {}))
    want, got = runs
    gaps = {"update": _rel_l2(
        torch.cat([v.flatten() for v in got["update"].values()]),
        torch.cat([v.flatten() for v in want["update"].values()]))}
    # one group per params-shaped tree (its leaves are named
    # "module.param") or bare tensor
    groups = {}
    for p in want["aux"]:
        head, last = p.rsplit("/", 1)
        groups.setdefault(head if "." in last else p, []).append(p)
    for g, paths in groups.items():
        gaps[g] = _rel_l2(
            torch.cat([got["aux"][p].flatten() for p in paths]),
            torch.cat([want["aux"][p].flatten() for p in paths]))
    # evaluate_personal's summary: each figure relative, or absolute
    # below 1
    for key, w in want["personal"].items():
        gaps[f"evaluate_personal/{key}"] = abs(got["personal"][key] - w) \
            / max(abs(w), 1.0)
    worst = max(gaps.values())
    log(f"zoo {name} card vs CPU (MLP, f32): relative L2 "
        + ", ".join(f"{g} {v:.3e}" for g, v in gaps.items()))
    if not worst <= ZOO_CARD_BAR:
        raise AssertionError(f"zoo {name} card vs CPU: {gaps}")
    return gaps


def personal_split(data, stack_partitions):
    """The north-star clients' rows split by ``train_val_split`` (val
    fraction 0.2, seed 0), as ``cfg.federated.personal`` splits a
    dataset: 200 train and 50 val rows a client."""
    from fedtorch_tpu_torch.data.batching import train_val_split
    C, n = data.x.shape[:2]
    parts, vparts = train_val_split(
        [np.arange(c * n, (c + 1) * n) for c in range(C)], 0.2)
    x = data.x.reshape((C * n,) + tuple(data.x.shape[2:])).numpy()
    y = data.y.reshape(-1).numpy()
    return stack_partitions(x, y, parts), stack_partitions(x, y, vparts)


def zoo_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
              FederatedTrainer, os_mod, qk, fa):
    """Each zoo path at full width, then each algorithm card vs CPU at a
    small size, and one quantized FedCOMGATE ResNet-8 round held as the
    reference phase holds quantized FedAvg's."""
    cfg = zoo_config(tcfg, {"algorithm": "fedavg"}, {})
    t0 = time.perf_counter()
    data = path_data(cfg, seed, stack_partitions)
    train, val = personal_split(data, stack_partitions)
    out = {"data_s": time.perf_counter() - t0, "paths": {}, "card_vs_cpu":
           {}}
    for name, fed, optim in ZOO_PATHS:
        personal = fed["algorithm"] in tcfg.PERSONALIZED_ALGORITHMS
        out["paths"][name] = zoo_path(
            name, fed, optim, train if personal else data, seed, tcfg,
            define_model, make_algorithm, FederatedTrainer, qk, fa,
            val=val if personal else None)
        gc.collect()
        torch.cuda.empty_cache()
    del data, train, val
    # TF32 off for the checks, then as it was (the later paths' backward
    # runs its float32 products as the library's default leaves them)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, fed, optim in ZOO_CARD_CASES:
        out["card_vs_cpu"][name] = zoo_card_vs_cpu(
            name, fed, optim, tcfg, define_model, make_algorithm,
            stack_partitions, FederatedTrainer)
    cfg = os_mod.round_cfg("resnet8")
    _hold_round(os_mod, "resnet8", qk, fa, seed=2, cfg=dataclasses.replace(
        cfg, federated=dataclasses.replace(cfg.federated,
                                           algorithm="fedgate")))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    return out


def localsgd_trainer(seed, tcfg, define_model, stack_partitions):
    """The local-SGD path's trainer (``build_local_sgd``): ResNet-20 in
    bf16 on the north-star data pooled and re-partitioned IID over
    ``LOCALSGD_WORKERS`` workers, 10 local steps of batch 50 a round in
    iteration mode (``fit`` stops after ``LOCALSGD_ROUNDS`` rounds); on
    the ranks of the process group where one is up. Returns it and the
    seconds its data took."""
    from fedtorch_tpu_torch.parallel.local_sgd import build_local_sgd
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="cifar10", batch_size=BATCH),
        federated=tcfg.FederatedConfig(
            federated=False, num_clients=LOCALSGD_WORKERS,
            sync_type="local_step"),
        model=tcfg.ModelConfig(arch="resnet20"),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(
            local_step=LOCAL_STEPS, stop_criteria="iteration",
            num_iterations=LOCALSGD_ROUNDS * LOCAL_STEPS),
        mesh=tcfg.MeshConfig(compute_dtype="bfloat16")).finalize()
    t0 = time.perf_counter()
    data = path_data(zoo_config(tcfg, {"algorithm": "fedavg"}, {}), seed,
                     stack_partitions)
    x = data.x.reshape((-1,) + tuple(data.x.shape[2:])).numpy()
    trainer = build_local_sgd(cfg, define_model(cfg, batch_size=BATCH), x,
                              data.y.reshape(-1).numpy())
    return trainer, time.perf_counter() - t0


def localsgd_fit(trainer, seed, hash_rows=()):
    """``trainer.fit`` from ``seed``, cuDNN deterministic (so that a run
    on two ranks can be held bitwise to it): the server, clients and
    history, each round's end on the host clock, and
    :func:`state_hashes` of the rows this process holds and of each
    ``(lo, hi)`` of ``hash_rows``."""
    ends = []

    def tick(server, clients, metrics):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server, clients, history = trainer.fit(seed, callback=tick)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return dict(
        server=server, clients=clients, history=history, t0=t0, ends=ends,
        hashes=state_hashes(server, clients, history),
        hashes_by_rows={f"{lo}:{hi}": state_hashes(
            server, clients, history, rows=(lo, hi)) for lo, hi in hash_rows})


def localsgd_phase(seed, tcfg, define_model, stack_partitions, qk, fa):
    """Local-SGD mode through its entry points (``build_local_sgd`` ->
    ``LocalSGDTrainer.fit``, :func:`localsgd_trainer`), cuDNN
    deterministic, the counters set to 0 just before and read just after
    (no kernel: unquantized); finite losses, every round K = 10, moved
    server params, the second round timed; the hashes of each rank's
    workers' rows at two ranks (the ``podscale`` phase's ``localsgd_W2``
    twin)."""
    from fedtorch_tpu_torch.parallel.mesh import owned_client_rows
    trainer, data_s = localsgd_trainer(seed, tcfg, define_model,
                                       stack_partitions)
    reset_counters(qk, fa)
    run = localsgd_fit(trainer, seed, hash_rows=[
        owned_client_rows(LOCALSGD_WORKERS, 2, r) for r in (0, 1)])
    launched = counters(qk, fa)
    server, clients, history = run["server"], run["clients"], run["history"]
    ends, t0 = run["ends"], run["t0"]
    init = trainer.init_state(seed)[0].params
    moved = max(float((server.params[k] - init[k]).abs().max())
                for k in init)
    losses = torch.stack([m.train_loss for m in history])
    if len(history) != LOCALSGD_ROUNDS or any(launched.values()) \
            or not bool(torch.isfinite(losses).all()) or not moved > 0.0 \
            or int(clients.local_index.max()) != LOCALSGD_ROUNDS \
            * LOCAL_STEPS:
        raise AssertionError(f"localsgd: {len(history)} rounds, launches "
                             f"{launched}, losses {losses.tolist()}, moved "
                             f"{moved}")
    round_ms = (ends[-1] - ends[-2]) * 1e3
    out = dict(workers=LOCALSGD_WORKERS, rounds=len(history),
               local_steps=LOCAL_STEPS, batch=BATCH,
               rows_per_worker=trainer.sizes[0], data_s=data_s,
               warmup_round_ms=(ends[0] - t0) * 1e3, round_ms=round_ms,
               local_steps_per_s=LOCALSGD_WORKERS * LOCAL_STEPS
               / (round_ms / 1e3),
               mean_loss=float(losses[-1].mean()), max_param_change=moved,
               launches=launched, tree_launches=launched,
               hashes_by_rows=run["hashes_by_rows"],
               reduced="num_clients 100 -> 10 workers, so that a round is "
                       "the FedAvg round's 100 client-steps")
    log(f"localsgd: {LOCALSGD_WORKERS} workers x {trainer.sizes[0]} rows, "
        f"{len(history)} rounds of K {LOCAL_STEPS}: {round_ms:.1f} ms/round "
        f"(warm-up {out['warmup_round_ms']:.1f}), losses finite, params "
        f"moved {moved:.3e}, launches {launched}")
    return out


def task_config(tcfg, arch, dataset, dtype, clients, fed, **cut):
    """A tasks path's round: quantized, k = ``TASK_ONLINE``, batch
    ``BATCH``, ``LOCAL_STEPS`` steps; ``cut`` overrides the client
    count, online rate and local steps (the card-vs-CPU round)."""
    fed = dict(fed, quantized=True, num_clients=clients,
               online_client_rate=TASK_ONLINE / clients)
    steps = cut.pop("local_step", LOCAL_STEPS)
    fed.update(cut)
    return tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset=dataset, batch_size=BATCH),
        federated=tcfg.FederatedConfig(federated=True,
                                       sync_type="local_step", **fed),
        model=tcfg.ModelConfig(arch=arch, mlp_hidden_size=TASK_MLP_HIDDEN),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(local_step=steps),
        mesh=tcfg.MeshConfig(compute_dtype=dtype)).finalize()


def shakespeare_text(rng, n_windows: int, seq_len: int) -> str:
    """Random play text of ``n_windows`` windows of ``seq_len`` and one
    more character, from the 86-character vocabulary with one character
    in 50 outside it (the readers map those to 0)."""
    from fedtorch_tpu_torch.data.datasets import _SHAKESPEARE_CHARS
    chars = np.array(list(_SHAKESPEARE_CHARS + "{"))
    p = np.full(len(chars), 0.98 / (len(chars) - 1))
    p[-1] = 0.02
    return "".join(rng.choice(chars, n_windows * seq_len + 1, p=p))


def task_data(cfg, seed, stack_partitions):
    """(train ClientData, personal val ClientData or None, test x, test
    y) of a tasks path, from ``seed``: IID normalized images for the
    cnn paths; for the rnn, each character's text made into windows of
    ``rnn_seq_len`` with next-character labels by the port's own window
    encoder; for EMNIST, writers of 28x28 pixels in [0, 1] (the TFF
    files' range) whose row counts are drawn from ``EMNIST_ROWS``. The
    clients' rows are split into train and val by ``train_val_split``
    when the config is personalized."""
    from fedtorch_tpu_torch.data.batching import train_val_split
    from fedtorch_tpu_torch.data.datasets import shakespeare_windows
    rng = np.random.RandomState(seed)
    C, ds = cfg.federated.num_clients, cfg.data.dataset
    if ds == "shakespeare":
        T = cfg.model.rnn_seq_len
        wins = [shakespeare_windows(
            [shakespeare_text(rng, n, T).encode()], T)
            for n in [*rng.randint(*SHAKESPEARE_WINDOWS, C), TASK_EVAL_ROWS]]
        x = np.concatenate([w[0] for w in wins[:C]])
        y = np.concatenate([w[1] for w in wins[:C]])
        sizes = [len(w[0]) for w in wins[:C]]
        test_x, test_y = wins[C]
    else:
        if ds == "emnist":
            sizes = rng.randint(EMNIST_ROWS[0], EMNIST_ROWS[1] + 1, C)
        else:
            sizes = [TASK_IMAGE_ROWS[ds]] * C
        shape = (28, 28, 1) if ds in ("mnist", "emnist") else (32, 32, 3)
        n = int(np.sum(sizes)) + TASK_EVAL_ROWS
        x = (rng.rand(n, *shape) if ds == "emnist"
             else rng.randn(n, *shape)).astype(np.float32)
        y = rng.randint(0, 10, n)
        x, test_x = x[:-TASK_EVAL_ROWS], x[-TASK_EVAL_ROWS:]
        y, test_y = y[:-TASK_EVAL_ROWS], y[-TASK_EVAL_ROWS:]
    ends = np.cumsum(sizes)
    parts = [np.arange(e - s, e) for s, e in zip(sizes, ends)]
    val = None
    if cfg.federated.personal:
        parts, vparts = train_val_split(parts, cfg.data.val_fraction)
        val = stack_partitions(x, y, vparts)
    return stack_partitions(x, y, parts), val, test_x, test_y


def _first(data, n):
    """The first ``n`` clients of a ClientData."""
    return None if data is None else type(data)(*(t[:n] for t in data))


def task_card_vs_cpu(name, cfg, data, val, seed, os_mod, qk, orders=None):
    """A tasks path's round cut by ``TASK_CARD_CUT``, card vs CPU (TF32
    off): the card's wire format within one step of the plain version on
    its own payloads, the update held to ``TASK_CARD_FLOOR`` / the CPU
    order spread (``orders``: the CPU orders to measure it over, by
    default the model's layout or threads, and float32 for a bf16
    round)."""
    n = cfg.federated.num_clients
    data, val = _first(data, n), _first(val, n)
    bf16 = cfg.mesh.compute_dtype == "bfloat16"
    if orders is None:
        orders = ("cpu-nchw", "cpu-1thread") if cfg.model.arch == "cnn" \
            else ("cpu-2thread", "cpu-1thread")
        orders += ("cpu-float32",) if bf16 else ()
    wire = []

    def record(alg):
        # DRFA quantizes its inner algorithm's payload only
        alg = getattr(alg, "inner", alg)
        for hook in ("payload_batch_transform", "aggregate_transform"):
            def recorded(tree, _real=getattr(alg, hook), _hook=hook):
                out = _real(tree)
                wire.append((_hook, {k: v.cpu() for k, v in tree.items()},
                             {k: v.cpu() for k, v in out.items()}))
                return out
            setattr(alg, hook, recorded)
    ups = {run: os_mod.run_round(cfg, seed, run,
                                 record if run == "cuda" else None,
                                 data=data, val_data=val)[0]
           for run in ("cpu", *orders, "cuda")}
    if len(wire) != 2:
        raise AssertionError(f"tasks {name}: recorded {len(wire)} "
                             "wire-format calls")
    wire_steps = 0.0
    for hook, tree, got in wire:
        uplink = hook == "payload_batch_transform"
        want = qk.fused_quantize_dequantize_tree(tree, 8, uplink)
        for k, v in tree.items():
            rows = v.shape[0] if uplink else 1
            wire_steps = max(wire_steps, compare(
                qk, got[k].reshape(rows, -1), want[k].reshape(rows, -1),
                v.reshape(rows, -1), 8, what=f"tasks {name} {hook} {k}")[0])
    steps, l2 = os_mod.update_gap(ups["cpu"], ups["cuda"])
    gaps = [os_mod.update_gap(ups["cpu"], ups[o]) for o in orders]
    s_steps, s_l2 = max(g[0] for g in gaps), max(g[1] for g in gaps)
    f = os_mod.SPREAD_FACTOR
    bar_l2 = max(TASK_CARD_FLOOR, f * s_l2)
    bar_steps = max(2.0, f * s_steps) if bf16 else None
    out = dict(update_rel_l2=l2, update_steps=steps, spread_rel_l2=s_l2,
               spread_steps=s_steps, bar_rel_l2=bar_l2, bar_steps=bar_steps,
               orders=list(orders), wire_steps=wire_steps,
               cut=TASK_CARD_CUT)
    log(f"tasks {name} card vs CPU ({n} clients, "
        f"{cfg.train.local_step} steps): wire format max {wire_steps:.6f} "
        f"steps; update relative L2 {l2:.3e} (bar {bar_l2:.3e}), "
        f"{steps:.3f} downlink steps (bar {bar_steps}); CPU order spread "
        f"{s_l2:.3e}, {s_steps:.3f} steps")
    if l2 > bar_l2 or (bar_steps is not None and steps > bar_steps):
        raise AssertionError(f"tasks {name} card vs CPU: {out}")
    return out


def task_path(name, arch, dataset, dtype, clients, fed, seed, tcfg,
              define_model, make_algorithm, stack_partitions,
              FederatedTrainer, os_mod, qk, fa):
    """One tasks path through the library entry points (``define_model``
    -> ``make_algorithm`` -> ``FederatedTrainer`` -> ``run_rounds`` ->
    ``evaluate``): its cut round card vs CPU, then 1 warm-up and
    ``TASK_TIMED_ROUNDS`` timed rounds on the card with the counters set
    to 0 just before and read just after (the leaf buckets' launches a
    round), finite losses of the timed rounds, and the server model's
    test loss and top-1 (the rnn's from a fresh carry per batch)."""
    from fedtorch_tpu_torch.parallel.evaluate import evaluate
    cfg = task_config(tcfg, arch, dataset, dtype, clients, fed)
    t0 = time.perf_counter()
    data, val, test_x, test_y = task_data(cfg, seed, stack_partitions)
    data_s = time.perf_counter() - t0
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        held = task_card_vs_cpu(
            name, task_config(tcfg, arch, dataset, dtype, clients, fed,
                              **TASK_CARD_CUT),
            data, val, seed, os_mod, qk)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    model = define_model(cfg, batch_size=cfg.data.batch_size)
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data,
                               val_data=val)
    server, clients_state = trainer.init_state(seed)
    numels = [v.numel() for v in server.params.values()]
    per = launches_per_round(qk, numels)
    per.update(flash=0, flash_tc=0, flash_tf32=0)
    rounds = 1 + TASK_TIMED_ROUNDS
    reset_counters(qk, fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server, clients_state, _ = trainer.run_rounds(server, clients_state, 1)
    torch.cuda.synchronize()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    server, clients_state, metrics = trainer.run_rounds(
        server, clients_state, TASK_TIMED_ROUNDS)
    end.record()
    torch.cuda.synchronize()
    launched = counters(qk, fa)
    want = {c: n * rounds for c, n in per.items()}
    if launched != want:
        raise AssertionError(f"tasks {name}: kernels launched {launched} in "
                             f"{rounds} rounds, expected {want}")
    if tuple(metrics.train_loss.shape) != (TASK_TIMED_ROUNDS,
                                           trainer.metrics_width):
        raise AssertionError(f"tasks {name}: metrics of shape "
                             f"{tuple(metrics.train_loss.shape)}")
    losses = (metrics.train_loss.sum(1)
              / metrics.online_mask.sum(1)).tolist()
    round_ms = start.elapsed_time(end) / TASK_TIMED_ROUNDS
    t0 = time.perf_counter()
    ev = evaluate(model, server.params, test_x, test_y)
    loss, top1, top5 = (float(v) for v in ev)
    eval_ms = (time.perf_counter() - t0) * 1e3
    if not (all(math.isfinite(v) for v in losses) and math.isfinite(loss)
            and 0.0 <= top1 <= 1.0):
        raise AssertionError(f"tasks {name}: losses {losses}, evaluate "
                             f"{loss} {top1}")
    out = dict(path=name, arch=arch, dataset=dataset, dtype=dtype,
               algorithm=cfg.effective_algorithm, quantized=True,
               clients=clients, k=trainer.k_online, batch=BATCH,
               local_steps=trainer.local_steps,
               rows_per_client=[int(data.sizes.min()),
                                int(data.sizes.max())],
               params=sum(numels), largest_leaf=max(numels),
               data_s=data_s, card_vs_cpu=held, warmup_round_ms=warmup_ms,
               round_ms=round_ms,
               local_steps_per_s=trainer.k_online * trainer.local_steps
               / (round_ms / 1e3),
               timed_rounds=TASK_TIMED_ROUNDS, losses=losses,
               launches=launched, tree_launches=want,
               launches_per_round={c: n / rounds
                                   for c, n in launched.items()},
               eval=dict(rows=len(test_y), loss=loss, top1=top1, top5=top5,
                         ms=eval_ms))
    log(f"tasks {name}: {cfg.effective_algorithm} {arch} {dtype}, "
        f"{sum(numels)} params: {round_ms:.1f} ms/round (warm-up "
        f"{warmup_ms:.1f}), losses {losses}, launches per round "
        f"{out['launches_per_round']}, evaluate {eval_ms:.1f} ms: loss "
        f"{loss:.4f} top-1 {top1:.4f}")
    return out


def write_tff_files(root: str, seed: int, h5py) -> dict:
    """TFF HDF5 files in the layout the readers take (``examples/<client
    id>/{pixels, label}`` and ``examples/<client id>/snippets``, as
    ``tests/format_fixtures.py`` writes them): ``TFF_CLIENTS`` EMNIST
    writers (train and test files) and Shakespeare characters from
    ``seed``. Returns the files' bytes."""
    rng = np.random.RandomState(seed)
    paths = {}
    for split, n_clients in (("train", TFF_CLIENTS), ("test", 5)):
        p = os.path.join(root, "emnist",
                         f"fed_emnist_digitsonly_{split}.h5")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with h5py.File(p, "w") as f:
            ex = f.create_group("examples")
            for i in range(n_clients):
                n = int(rng.randint(*EMNIST_ROWS))
                g = ex.create_group(f"f{i:04d}_{(i * 7) % 100:02d}")
                g.create_dataset("pixels", data=rng.rand(n, 28, 28)
                                 .astype(np.float32))
                g.create_dataset("label", data=rng.randint(0, 10, n)
                                 .astype(np.int32))
        paths[f"emnist_{split}"] = p
    p = os.path.join(root, "shakespeare", "shakespeare_train.h5")
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with h5py.File(p, "w") as f:
        ex = f.create_group("examples")
        for i in range(TFF_CLIENTS):
            text = shakespeare_text(rng, int(rng.randint(
                *SHAKESPEARE_WINDOWS)), 50)
            cut = len(text) // 3
            g = ex.create_group(f"PLAY_{i:02d}_CHARACTER")
            g.create_dataset("snippets", data=np.asarray(
                [text[:cut].encode(), text[cut:].encode()], dtype=object),
                dtype=h5py.string_dtype())
    paths["shakespeare"] = p
    return {k: os.path.getsize(v) for k, v in paths.items()}


def cli_tff_phase(seed, define_model, qk, fa):
    """The CLI on TFF HDF5 files written into a temporary directory:
    ``-d shakespeare -a rnn`` and ``-d emnist -a cnn``, quantized, 2
    rounds of k = 10 of the first ``TFF_CLIENTS`` clients, the test set
    evaluated every round; the counters set to 0 just before each run
    and read just after (the model's leaf buckets' launches a round);
    finite loss lines and test top-1. Not run, and said so, where
    ``import h5py`` fails."""
    import glob
    import tempfile
    try:
        import h5py
    except ImportError:
        return "not run: no h5py"
    from fedtorch_tpu_torch import cli
    out = {}
    with tempfile.TemporaryDirectory() as root:
        out["file_bytes"] = write_tff_files(root, seed, h5py)
        for name, words in (("shakespeare_rnn", ["-d", "shakespeare", "-a",
                                                 "rnn"]),
                            ("emnist_cnn", ["-d", "emnist", "-a", "cnn"])):
            argv = words + [
                "-f", "true", "--num_workers", str(TFF_CLIENTS),
                "--online_client_rate", "0.5", "--federated_sync_type",
                "local_step", "--local_step", str(LOCAL_STEPS), "-b",
                str(BATCH), "--lr", "0.1", "--quantized", "true",
                "--num_comms", str(TFF_ROUNDS), "--eval_freq", "1", "-p",
                root, "-c", os.path.join(root, "runs_" + name)]
            cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
            numels = [math.prod(s) for s in model_shapes(cfg, define_model)]
            want = {c: n * TFF_ROUNDS for c, n in
                    launches_per_round(qk, numels).items()}
            want.update(flash=0, flash_tc=0, flash_tf32=0)
            reset_counters(qk, fa)
            t0 = time.perf_counter()
            res = cli.main(argv)
            run_s = time.perf_counter() - t0
            launched = counters(qk, fa)
            (record,) = glob.glob(os.path.join(root, "runs_" + name, "**",
                                               "record0"), recursive=True)
            with open(record) as f:
                losses = [float(v) for v in re.findall(
                    r"Round: \d+\. Epoch: .*? Loss: (\S+) \|", f.read())]
            if launched != want or len(losses) != TFF_ROUNDS or not all(
                    math.isfinite(v) for v in losses) \
                    or not 0.0 <= res["test_top1"] <= 1.0:
                raise AssertionError(f"cli_tff {name}: launches {launched} "
                                     f"(expected {want}), losses {losses},"
                                     f" {res}")
            out[name] = dict(rounds=res["rounds"], losses=losses,
                             test_top1=res["test_top1"], run_s=run_s,
                             round_ms=res["timer"]["round"] / TFF_ROUNDS
                             * 1e3, launches=launched, tree_launches=want)
            log(f"cli_tff {name}: {TFF_ROUNDS} rounds in {run_s:.1f} s "
                f"({out[name]['round_ms']:.1f} ms/round), losses {losses}, "
                f"test top-1 {res['test_top1']:.4f}, launches {launched}")
    return out


def tasks_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
                FederatedTrainer, os_mod, qk, fa):
    """Every tasks path (``TASK_PATHS``), then ``cli_tff``."""
    out = {"paths": {}}
    for name, arch, dataset, dtype, clients, fed in TASK_PATHS:
        out["paths"][name] = task_path(
            name, arch, dataset, dtype, clients, fed, seed, tcfg,
            define_model, make_algorithm, stack_partitions,
            FederatedTrainer, os_mod, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()
    out["cli_tff"] = cli_tff_phase(seed, define_model, qk, fa)
    return out


def cut_config(cfg, **cut):
    """``cfg`` cut as ``TASK_CARD_CUT`` cuts a tasks path's round."""
    steps = cut.pop("local_step")
    return dataclasses.replace(
        cfg, federated=dataclasses.replace(cfg.federated, **cut),
        train=dataclasses.replace(cfg.train, local_step=steps)).finalize()


def densenet_path(seed, tcfg, define_model, make_algorithm,
                  stack_partitions, FederatedTrainer, os_mod, qk, fa):
    """The slice's main path: quantized FedAvg (int8 both ways) on
    DenseNet-BC-100 (growth 12, compression 0.5), bf16, the north-star
    round's 100 clients x 250 CIFAR-10-shaped samples from ``seed``, k =
    10, batch 50, 10 local steps. Its round cut by ``DENSENET_CARD_CUT`` in
    float32 card (TF32 off) vs CPU first, held to twice what NCHW memory
    moves it on the CPU (the bf16 round moves ~1,000x as far between
    float32 and bf16 as between CPU orders, so it is timed, not held),
    then 1 warm-up, 2 timed and 1 profiled bf16 rounds with 2 + 2 ragged
    launches a round and no tiled one."""
    cfg = path_config(tcfg, "densenet100", model=DENSENET)
    t0 = time.perf_counter()
    data = path_data(cfg, seed, stack_partitions)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = path_config(tcfg, "densenet100", dtype="float32",
                          model=DENSENET)
        held = task_card_vs_cpu("densenet_bc100_float32",
                                cut_config(f32, **DENSENET_CARD_CUT), data,
                                None, seed, os_mod, qk, orders=("cpu-nchw",))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    del data
    gc.collect()
    held["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, trainer, server, clients = main_path_phase(
        seed, tcfg, define_model, make_algorithm, stack_partitions,
        FederatedTrainer, qk, fa, arch="densenet100", model=DENSENET)
    per = out["launches_per_round"]
    if [per[c] for c in ("ragged_stats", "ragged_apply", "stats",
                         "apply")] != [2, 2, 0, 0]:
        raise AssertionError(f"DenseNet-BC-100: expected 2 + 2 ragged and "
                             f"no tiled launches a round, got {per}")
    rounds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = profile_phase(trainer, server, clients, per)
    prof["s"] = time.perf_counter() - t0
    steps = trainer.k_online * trainer.local_steps
    out.update(card_vs_cpu=held, profile=prof,
               leaves=len(server.params),
               uplink_rows=len(server.params) * trainer.k_online,
               launches_per_local_step=prof["kernel_launches"] / steps,
               busy_share=prof["busy_share"], rounds_s=rounds_s)
    log(f"densenet_bc100: {out['round_ms']:.1f} ms/round, "
        f"{out['local_steps_per_s']:.1f} local-steps/s, device busy "
        f"{prof['busy_share']}, {out['launches_per_local_step']:.0f} "
        f"launches a local step, peak {out['peak_mib']:.0f} MiB, "
        f"{out['leaves']} leaves ({out['uplink_rows']} uplink rows); "
        f"card vs CPU {held['s']:.1f} s, rounds {rounds_s:.1f} s, profile "
        f"{prof['s']:.1f} s")
    del trainer, server, clients
    return out


def _resnet18_step(x, y, cfg, make_algorithm, seed, device, nchw=None):
    """ResNet-18 (the ImageNet class built directly) from ``seed``'s
    weights on ``device``: the float32 logits of ``x`` and one FedAvg
    local step's update (lr 0.1, momentum), both on the CPU; ``nchw``
    (a forward pre-hook) runs the model on NCHW memory (another float32
    order)."""
    from fedtorch_tpu_torch.core import optim
    from fedtorch_tpu_torch.core.losses import make_criterion
    from fedtorch_tpu_torch.core.state import (
        tree_broadcast_clients, tree_take,
    )
    from fedtorch_tpu_torch.models.common import ModelDef
    from fedtorch_tpu_torch.models.resnet import ResNetImageNet
    module = ResNetImageNet("imagenet", 18).to(device)
    if nchw is not None:
        module.register_forward_pre_hook(nchw)
    model = ModelDef("resnet18", module, x[:1].to(device))
    params = model.init(torch.Generator().manual_seed(seed))
    alg = make_algorithm(cfg)
    alg.bind(model, make_criterion(False))
    opt = tree_take(optim.init_client_opt_state(
        tree_broadcast_clients(params, 1), cfg.optim), 0)
    bx, by = x.to(device), y.to(device)
    with torch.no_grad():
        logits = model.apply(params, bx).cpu()
    new = alg.local_step(
        params=params, opt=opt, client_aux=(), rnn_carry=None,
        server_params=params, server_aux=(), bx=bx, by=by, bval_x=None,
        bval_y=None, lr=0.1, step_idx=0,
        local_index=torch.zeros((), dtype=torch.int32, device=device),
        step_budget=1)[0]
    return logits, {k: (new[k] - params[k]).cpu() for k in params}, params


def resnet18_path(seed, tcfg, make_algorithm, os_mod, qk, fa):
    """The ImageNet ResNet-18, built directly (``define_model`` cannot
    reach it, as the JAX package's cannot): a float32 forward and one
    local step at (50, 224, 224, 3) on the card (TF32 off) against the
    CPU, within ``SPREAD_FACTOR`` times what NCHW memory moves on the
    CPU (never tighter than ``MODELS_CARD_BAR``); then one quantized
    uplink tree call on its params stacked for k = 10: 1 + 1 ragged and
    3 + 3 tiled launches (its three bucket sizes past 524,288 elements),
    each row within one step of the plain version."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(RESNET18_BATCH, 224, 224, 3)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, RESNET18_BATCH))
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(arch="resnet20"),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True)).finalize()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        card = _resnet18_step(x, y, cfg, make_algorithm, seed, "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = _resnet18_step(x, y, cfg, make_algorithm, seed, "cpu")
        nchw = _resnet18_step(x, y, cfg, make_algorithm, seed, "cpu",
                              nchw=os_mod._nchw_inside)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def rel(a, b):
        if isinstance(a, dict):
            a = torch.cat([v.flatten() for v in a.values()])
            b = torch.cat([b[k].flatten() for k in b])
        return float((a - b).norm() / b.norm())
    f = os_mod.SPREAD_FACTOR
    gaps = dict(logits=rel(card[0], cpu[0]), update=rel(card[1], cpu[1]))
    spread = dict(logits=rel(nchw[0], cpu[0]), update=rel(nchw[1], cpu[1]))
    bars = {k: max(MODELS_CARD_BAR, f * spread[k]) for k in gaps}
    log(f"resnet18_imagenet (50, 224, 224, 3) float32 card vs CPU: logits "
        f"relative L2 {gaps['logits']:.3e}, update {gaps['update']:.3e} "
        f"(bars {bars}; CPU NCHW spread {spread}); card {card_s:.1f} s, "
        f"CPU two orders {cpu_s:.1f} s")
    if any(gaps[k] > bars[k] for k in gaps):
        raise AssertionError(f"resnet18_imagenet card vs CPU: {gaps}, "
                             f"bars {bars}")
    params = card[2]
    del card, cpu, nchw
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tree = {k: v.unsqueeze(0).repeat((TASK_ONLINE,) + (1,) * v.dim())
            + 1e-3 * torch.randn((TASK_ONLINE,) + tuple(v.shape),
                                 generator=gen, device="cuda")
            for k, v in params.items()}
    numels = [v.numel() for v in params.values()]
    sizes = sorted({n for n in numels if n > qk._MAX_ROW_ELEMS})
    reset_counters(qk, fa)
    got = qk.fused_quantize_dequantize_tree(tree, 8, True)
    torch.cuda.synchronize()
    launched = counters(qk, fa)
    want = dict(launches_per_round(qk, numels))
    want = {c: n // 2 for c, n in want.items()}  # one tree call
    if any(launched[c] != want[c] for c in want) or want["stats"] != 3:
        raise AssertionError(f"ResNet-18 uplink tree call launched "
                             f"{launched}, expected {want}")
    cpu_tree = {k: v.cpu() for k, v in tree.items()}
    plain = qk.fused_quantize_dequantize_tree(cpu_tree, 8, True)
    steps = 0.0
    for k, v in cpu_tree.items():
        rows = v.shape[0]
        steps = max(steps, compare(qk, got[k].cpu().reshape(rows, -1),
                                   plain[k].reshape(rows, -1),
                                   v.reshape(rows, -1), 8,
                                   what=f"resnet18 {k}")[0])
    log(f"resnet18_imagenet uplink tree call ({len(numels)} leaves, k = "
        f"{TASK_ONLINE}, buckets {sizes}): launches {launched}, max "
        f"{steps:.6f} steps from the plain version")
    del tree, got, params
    torch.cuda.empty_cache()
    return dict(batch=RESNET18_BATCH, image=224, params=sum(numels),
                card_vs_cpu=dict(gaps=gaps, cpu_nchw_spread=spread,
                                 bars=bars), card_s=card_s, cpu_s=cpu_s,
                tree_call=dict(launches=launched, buckets=sizes,
                               max_err_steps=steps),
                launches=launched, tree_launches=launched)


def _record_card_masks():
    """Patch ``drop_source`` so a card forward records its masks per
    dropout key and a CPU forward replays them; returns the undo."""
    from fedtorch_tpu_torch.models import common
    real = common.drop_source
    masks = {}

    def source(key, device):
        if torch.device(device).type == "cuda":
            draw = real(key, device)
            masks[key] = []

            def recording(shape, keep):
                m = draw(shape, keep)
                masks[key].append(m.cpu())
                return m
            return recording
        it = iter(masks[key])
        return lambda shape, keep: next(it)

    common.drop_source = source
    return lambda: setattr(common, "drop_source", real), masks


def local_step_ms(seed, tcfg, define_model, make_algorithm, arch, model,
                  keys=False):
    """One local step (forward, backward, optimizer step) of ``arch``
    (``model``: more of its ModelConfig) at batch 50 in bf16 on the card,
    timed by CUDA events over 20 steps after 3; ``keys`` gives each step
    its own dropout key, as the round does."""
    from fedtorch_tpu_torch.core import optim
    from fedtorch_tpu_torch.core.losses import make_criterion
    from fedtorch_tpu_torch.core.state import (
        tree_broadcast_clients, tree_take,
    )
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(BATCH, 32, 32, 3).astype(np.float32)) \
        .cuda()
    y = torch.from_numpy(rng.randint(0, 10, BATCH)).cuda()
    cfg = path_config(tcfg, arch, model=model)
    model = define_model(cfg, batch_size=BATCH)
    params = model.init(torch.Generator().manual_seed(seed))
    alg = make_algorithm(cfg)
    alg.bind(model, make_criterion(False))
    opt = tree_take(optim.init_client_opt_state(
        tree_broadcast_clients(params, 1), cfg.optim), 0)
    li = torch.zeros((), dtype=torch.int32, device="cuda")

    def step(i):
        alg.local_step(params=params, opt=opt, client_aux=(), rnn_carry=None,
                       server_params=params, server_aux=(), bx=x, by=y,
                       bval_x=None, bval_y=None, lr=0.1, step_idx=0,
                       local_index=li, step_budget=1,
                       rng=seed + i if keys else None)
    for i in range(3):
        step(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(20):
        step(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def conv_ab(seed, tcfg, define_model, make_algorithm):
    """The im2col conv against the native conv on the card: one
    ResNet-20 local step at batch 50 in bf16 each (``local_step_ms``)."""
    out = {f"{impl}_step_ms": local_step_ms(
        seed, tcfg, define_model, make_algorithm, "resnet20",
        dict(conv_impl=impl)) for impl in ("conv", "matmul")}
    out["matmul_over_conv"] = out["matmul_step_ms"] / out["conv_step_ms"]
    log(f"conv A/B, ResNet-20 local step at batch {BATCH} bf16: native "
        f"conv {out['conv_step_ms']:.3f} ms, im2col matmul "
        f"{out['matmul_step_ms']:.3f} ms ({out['matmul_over_conv']:.2f}x)")
    return out


def dropout_cost(seed, tcfg, define_model, make_algorithm):
    """What the dropout draw costs the local step: a WideResNet-16-4
    local step at batch 50 in bf16 without dropout, and at 0.3 with its
    own key a step (a device generator reseeded, 6 masks drawn), and the
    reseed alone (host ms, 1,000 calls)."""
    from fedtorch_tpu_torch.models.common import drop_source
    wrn = dict(wideresnet_widen_factor=4)
    out = dict(plain_step_ms=local_step_ms(
        seed, tcfg, define_model, make_algorithm, "wideresnet16", wrn),
        dropout_step_ms=local_step_ms(
            seed, tcfg, define_model, make_algorithm, "wideresnet16",
            dict(wrn, drop_rate=0.3), keys=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1000):
        drop_source(i, "cuda")
    # seconds for 1,000 calls: ms a call
    out["reseed_host_ms"] = time.perf_counter() - t0
    log(f"dropout, WideResNet-16-4 local step at batch {BATCH} bf16: "
        f"{out['plain_step_ms']:.3f} ms without, {out['dropout_step_ms']:.3f}"
        f" ms at 0.3 with a key a step; a reseed {out['reseed_host_ms']:.4f}"
        f" ms of host time")
    return out


def robust_lr_path(seed, tcfg, define_model, make_algorithm,
                   stack_partitions, FederatedTrainer, os_mod, qk, fa):
    """``robust_logistic_regression`` on MNIST-shaped rows: its round cut
    by ``TASK_CARD_CUT`` card vs CPU, then one round of 20 clients x 50
    rows (k = 10, batch 50, 10 local steps, int8 both ways) and
    ``evaluate`` on 1,000 rows with the noise ascent, card (TF32 off) vs
    CPU on the same params: the loss within ``MODELS_CARD_BAR``."""
    from fedtorch_tpu_torch.parallel.evaluate import evaluate
    cfg = tcfg.ExperimentConfig(
        data=tcfg.DataConfig(dataset="mnist", batch_size=BATCH),
        federated=tcfg.FederatedConfig(
            federated=True, num_clients=ROBUST_LR_CLIENTS,
            online_client_rate=TASK_ONLINE / ROBUST_LR_CLIENTS,
            sync_type="local_step", quantized=True),
        model=tcfg.ModelConfig(arch="robust_logistic_regression"),
        optim=tcfg.OptimConfig(lr=0.1, in_momentum=True),
        train=tcfg.TrainConfig(local_step=LOCAL_STEPS)).finalize()
    rng = np.random.RandomState(seed)
    n = ROBUST_LR_CLIENTS * 50
    x = rng.rand(n + TASK_EVAL_ROWS, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, n + TASK_EVAL_ROWS)
    data = stack_partitions(x[:n], y[:n], [np.arange(i * 50, (i + 1) * 50)
                                           for i in range(ROBUST_LR_CLIENTS)])
    held = task_card_vs_cpu("robust_logistic_regression",
                            cut_config(cfg, **TASK_CARD_CUT), data, None,
                            seed, os_mod, qk)
    model = define_model(cfg, batch_size=BATCH)
    trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), data)
    server, clients = trainer.init_state(seed)
    reset_counters(qk, fa)
    server, clients, m = trainer.run_rounds(server, clients, 1)
    torch.cuda.synchronize()
    launched = counters(qk, fa)
    tx, ty = x[n:], y[n:]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        got = [float(v) for v in evaluate(model, server.params, tx, ty)]
        eval_ms = (time.perf_counter() - t0) * 1e3
        cpu_model = define_model(cfg, batch_size=BATCH, device="cpu")
        want = [float(v) for v in evaluate(
            cpu_model, {k: v.cpu() for k, v in server.params.items()},
            tx, ty)]
        plain = [float(v) for v in evaluate(model, server.params, tx, ty,
                                            robust_ascent=False)]
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = abs(got[0] - want[0]) / abs(want[0])
    log(f"robust_logistic_regression: round launches {launched}, "
        f"evaluate with the ascent {eval_ms:.1f} ms: loss {got[0]:.6f} "
        f"(CPU {want[0]:.6f}, relative {rel:.3e}; without the ascent "
        f"{plain[0]:.6f}), top-1 {got[1]:.4f}")
    if not math.isfinite(got[0]) or rel > MODELS_CARD_BAR \
            or not got[0] >= plain[0] - 1e-6:
        raise AssertionError(f"robust_logistic_regression evaluate {got}, "
                             f"CPU {want}, without the ascent {plain}")
    return dict(card_vs_cpu=held, launches=launched, tree_launches=launched,
                eval=dict(ms=eval_ms, loss=got[0], top1=got[1],
                          cpu_loss=want[0], loss_rel_diff=rel,
                          loss_without_ascent=plain[0]),
                losses=float(m.train_loss.sum() / m.online_mask.sum()))


def models_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
                 FederatedTrainer, os_mod, qk, fa):
    """The rest of the model zoo and the robust rules: the DenseNet-BC-100
    main path, ResNet-18 (ImageNet), one round card vs CPU each of
    ResNet-20 with GroupNorm, with the im2col conv (and the conv A/B) and
    WideResNet-16-4 with dropout 0.3 (the CPU replaying the card's
    masks), ``robust_logistic_regression`` with its evaluation ascent,
    and a guarded quantized ResNet-20 round per robust rule. The small
    float32 rounds' relative L2 floor is ``TASK_CARD_FLOOR``, as the
    tasks paths': ResNet-20 with GroupNorm read 3.2e-4 and 1.05e-3 in two
    runs of one seed (one-step int8 flips whose count moves with
    cuDNN's nondeterministic backward)."""
    out = {"paths": {}}
    t_phase = time.perf_counter()
    out["paths"]["densenet_bc100_main_path"] = densenet_path(
        seed, tcfg, define_model, make_algorithm, stack_partitions,
        FederatedTrainer, os_mod, qk, fa)
    gc.collect()
    torch.cuda.empty_cache()
    out["paths"]["resnet18_imagenet"] = resnet18_path(
        seed, tcfg, make_algorithm, os_mod, qk, fa)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"models: DenseNet-BC-100 and ResNet-18 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    # float32 rounds card vs CPU: TF32 off on the card
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _models_rounds(out, seed, tcfg, define_model, make_algorithm,
                       stack_partitions, FederatedTrainer, os_mod, qk, fa)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"models phase: {out['phase_s']:.1f} s")
    return out


def _models_rounds(out, seed, tcfg, define_model, make_algorithm,
                   stack_partitions, FederatedTrainer, os_mod, qk, fa):
    """The models phase's small rounds card vs CPU, the conv A/B, the
    robust logistic regression and the robust rules, into ``out``."""
    t0 = time.perf_counter()
    small = {
        "resnet20_gn": ("resnet20", dict(norm="gn")),
        "resnet20_matmul_conv": ("resnet20", dict(conv_impl="matmul")),
        "wrn16_4_dropout_0.3": ("wideresnet16",
                                dict(wideresnet_widen_factor=4,
                                     drop_rate=0.3)),
    }
    for name, (arch, model) in small.items():
        cfg = os_mod.small_round_cfg(arch, **model)
        before = counters(qk, fa)
        if model.get("drop_rate"):
            undo, masks = _record_card_masks()
            try:
                r = _hold_round(os_mod, arch, qk, fa, seed, cfg,
                                card_first=True, floor_l2=TASK_CARD_FLOOR)
            finally:
                undo()
            r["masks_replayed"] = sum(len(v) for v in masks.values())
        else:
            r = _hold_round(os_mod, arch, qk, fa, seed, cfg,
                            floor_l2=TASK_CARD_FLOOR)
        after = counters(qk, fa)
        r["tree_launches"] = r["launches"]
        r["launches"] = {c: after[c] - before[c] for c in after}
        out["paths"][name] = r
    out["paths"]["resnet20_matmul_conv"]["ab"] = conv_ab(
        seed, tcfg, define_model, make_algorithm)
    out["paths"]["wrn16_4_dropout_0.3"]["cost"] = dropout_cost(
        seed, tcfg, define_model, make_algorithm)
    out["paths"]["robust_logistic_regression"] = robust_lr_path(
        seed, tcfg, define_model, make_algorithm, stack_partitions,
        FederatedTrainer, os_mod, qk, fa)
    rules = {}
    for rule in ROBUST_RULES:
        base = os_mod.small_round_cfg("resnet20")
        cfg = dataclasses.replace(
            base, federated=dataclasses.replace(
                base.federated, num_clients=ROBUST_CLIENTS),
            fault=dataclasses.replace(base.fault, robust_agg=rule,
                                      guard_updates=True)).finalize()
        before = counters(qk, fa)
        rules[rule] = _hold_round(os_mod, "resnet20", qk, fa, seed, cfg,
                                  floor_l2=TASK_CARD_FLOOR)
        after = counters(qk, fa)
        rules[rule]["tree_launches"] = rules[rule]["launches"]
        rules[rule]["launches"] = {c: after[c] - before[c] for c in after}
    out["paths"]["robust_agg"] = dict(
        rules=rules, launches={c: sum(r["launches"][c]
                                      for r in rules.values())
                               for c in counters(qk, fa)})
    out["paths"]["robust_agg"]["tree_launches"] = \
        out["paths"]["robust_agg"]["launches"]
    log(f"models: the small rounds, the A/B and the robust paths in "
        f"{time.perf_counter() - t0:.1f} s")


def faults_config(tcfg, fault: dict, plane: str = "device", dtype="bfloat16"):
    """The north-star round (``path_config``'s ResNet-20) with the fault
    planes ``fault`` armed, on ``plane``."""
    cfg = path_config(tcfg, "resnet20", dtype=dtype)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_plane=plane),
        fault=tcfg.FaultConfig(**fault)).finalize()


def fault_counts(metrics) -> dict:
    """A round's fault-plane counters (and the DP gauges when armed) as
    floats."""
    out = {f: float(getattr(metrics, f)) for f in FAULT_COUNTERS}
    out["reporters"] = float(metrics.online_mask.sum())
    for f in ("dp_clipped_frac", "dp_noise_sigma"):
        if getattr(metrics, f) is not None:
            out[f] = float(getattr(metrics, f))
    return out


def _record_uplink(trainer, calls: list, plans: list):
    """Record each round's plan and the uplink wire format's stacked
    input and output (on the CPU) on ``trainer``."""
    alg = trainer.algorithm
    real_transform, real_draw = alg.payload_batch_transform, \
        trainer.draw_plan

    def transform(tree):
        out = real_transform(tree)
        calls.append(({k: v.cpu() for k, v in tree.items()},
                      {k: v.cpu() for k, v in out.items()}))
        return out

    def draw(server):
        plan = real_draw(server)
        plans.append(plan)
        return plan
    alg.payload_batch_transform = transform
    trainer.draw_plan = draw
    return lambda: (setattr(alg, "payload_batch_transform", real_transform),
                    setattr(trainer, "draw_plan", real_draw))


def _hold_uplink(qk, name, tree, out) -> dict:
    """The card's uplink wire format on a round's stacked payloads
    against the plain version on the same stack (``compare``'s bars)."""
    want = qk.fused_quantize_dequantize_tree(tree, 8, True)
    steps = absd = 0.0
    rows = 0
    for k, v in tree.items():
        n = v.shape[0]
        s, a = compare(qk, out[k].reshape(n, -1), want[k].reshape(n, -1),
                       v.reshape(n, -1), 8, what=f"faults {name} {k}")
        steps, absd, rows = max(steps, s), max(absd, a), rows + n
    return dict(max_err_steps=steps, max_abs_err=absd, rows=rows,
                leaves=len(tree))


def faults_path(name, cfg, data, seed, define_model, make_algorithm,
                FederatedTrainer, qk, fa, timed=FAULTS_TIMED_ROUNDS,
                profile=True):
    """One faults path: ``cfg``'s trainer from ``seed``, 1 warm-up and
    ``timed`` timed rounds through ``run_round`` with the counters set to
    0 just before (2 + 2 ragged launches a round, no other kernel), the
    warm-up round's uplink stack held against the plain version, each
    round's fault counters, then (``profile``) one profiled round.
    Returns (numbers, server params and generator state after the
    1 + ``timed`` rounds)."""
    gc.collect()
    torch.cuda.empty_cache()
    trainer = FederatedTrainer(cfg, define_model(
        cfg, batch_size=cfg.data.batch_size), make_algorithm(cfg), data)
    trainer.stream_timeout_s = 60.0
    server, clients = trainer.init_state(seed)
    calls, plans = [], []
    undo = _record_uplink(trainer, calls, plans)
    reset_counters(qk, fa)
    torch.cuda.synchronize()
    server, clients, m = trainer.run_round(server, clients)
    torch.cuda.synchronize()
    undo()
    per_round = [fault_counts(m)]
    held = _hold_uplink(qk, name, *calls[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    start.record()
    for _ in range(timed):
        server, clients, m = trainer.run_round(server, clients)
        ms.append(m)
    end.record()
    torch.cuda.synchronize()
    round_ms = start.elapsed_time(end) / timed
    launched = counters(qk, fa)
    rounds = 1 + timed
    want = dict(ragged_stats=2 * rounds, ragged_apply=2 * rounds, stats=0,
                apply=0, flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"faults {name}: kernels launched {launched} "
                             f"in {rounds} rounds, expected {want}")
    per_round += [fault_counts(m) for m in ms]
    params = {k: v.detach().clone() for k, v in server.params.items()}
    rng_state = server.rng.get_state()
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError(f"faults {name}: non-finite server params")
    steps = trainer.k_dispatch * trainer.local_steps
    out = dict(path=name, data_plane=cfg.data.data_plane,
               k_online=trainer.k_online, k_dispatch=trainer.k_dispatch,
               rounds=rounds, timed_rounds=timed, round_ms=round_ms,
               launches=launched, tree_launches=want,
               launches_per_round={c: n / rounds
                                   for c, n in launched.items()},
               per_round=per_round, uplink_vs_plain=held)
    if plans:  # the stream plane's plans are drawn by its producer
        out["plan_fields"] = sorted(f for f in plans[0]._fields
                                    if getattr(plans[0], f) is not None)
    if profile:
        prof = profile_phase(trainer, server, clients,
                             out["launches_per_round"])
        out.update(profile=prof, busy_share=prof["busy_share"],
                   launches_per_local_step=prof["kernel_launches"] / steps)
    trainer.close()
    log(f"faults {name}: {round_ms:.1f} ms/round over {timed}, k' "
        f"{trainer.k_dispatch}, launches {launched}, per round "
        f"{per_round}, uplink stack vs plain {held}, busy "
        f"{out.get('busy_share')}, launches a local step "
        f"{out.get('launches_per_local_step')}")
    del trainer, server, clients
    return out, params, rng_state


def crafted_stack(name, cfg, data, seed, define_model, make_algorithm,
                  FederatedTrainer, qk, need: int):
    """Rounds of ``cfg`` (a byzantine mode) until one sends at least
    ``need`` crafted uploads (at most ``FAULTS_CRAFT_ROUNDS``); that
    round's uplink stack held against the plain version, and under
    ``collude`` its crafted rows checked identical (every client carries
    the same weight here)."""
    trainer = FederatedTrainer(cfg, define_model(
        cfg, batch_size=cfg.data.batch_size), make_algorithm(cfg), data)
    server, clients = trainer.init_state(seed)
    key = int(server.aux["fault_key"])
    cohort = trainer._byzantine_cohort(key)
    for r in range(FAULTS_CRAFT_ROUNDS):
        calls, plans = [], []
        undo = _record_uplink(trainer, calls, plans)
        server, clients, m = trainer.run_round(server, clients)
        undo()
        byz = cohort[plans[0].idx].bool()
        if int(byz.sum()) >= need:
            break
    else:
        raise AssertionError(f"faults {name}: no round of "
                             f"{FAULTS_CRAFT_ROUNDS} sent {need} crafted "
                             "uploads")
    tree, out = calls[0]
    identical = None
    if cfg.fault.byzantine_mode == "collude":
        rows = byz.nonzero().flatten().tolist()
        identical = all(torch.equal(v[rows[0]], v[j]) for v in tree.values()
                        for j in rows[1:])
        if not identical:
            raise AssertionError(f"faults {name}: colluding rows differ")
    if cfg.fault.byzantine_mode == "zero" and not all(
            float(v[byz].abs().max()) == 0.0 for v in tree.values()):
        raise AssertionError(f"faults {name}: a zero row is not zero")
    held = _hold_uplink(qk, name, tree, out)
    held.update(round=r, crafted_rows=int(byz.sum()),
                identical_rows=identical, counts=fault_counts(m))
    log(f"faults {name}: round {r}'s uplink stack ({int(byz.sum())} "
        f"crafted rows) vs plain {held}")
    del trainer, server, clients
    return held


def faults_card_vs_cpu(name, cfg, data, seed, os_mod, qk,
                       orders=("cpu-nchw", "cpu-1thread")):
    """A faults path's round cut by ``TASK_CARD_CUT`` (one adversary of 4
    clients: ``FAULTS_CUT_BYZANTINE_RATE``) in float32, card (TF32 off)
    vs CPU: every fault count and the DP gauges equal, the update within
    the larger of ``TASK_CARD_FLOOR`` and ``SPREAD_FACTOR`` times the
    CPU's own order spread. The CPU runs replay the card's DP and gauss
    normals (a CUDA and a CPU generator draw other normals from one
    seed)."""
    from fedtorch_tpu_torch.robustness import chaos
    n = cfg.federated.num_clients
    data = _first(data, n)
    real = chaos.leaf_normals
    normals = {}

    def source(seed_, shape, device):
        if torch.device(device).type == "cuda":
            xi = real(seed_, shape, device)
            normals[(seed_, tuple(shape))] = xi.cpu()
            return xi
        return normals[(seed_, tuple(shape))].to(device)
    chaos.leaf_normals = source
    try:
        runs = {run: os_mod.run_round(cfg, seed, run, data=data,
                                      with_metrics=True)
                for run in ("cuda", "cpu", *orders)}
    finally:
        chaos.leaf_normals = real
    counts = {run: fault_counts(r[2]) for run, r in runs.items()}
    if counts["cuda"] != counts["cpu"] or not torch.equal(
            runs["cuda"][2].online_mask, runs["cpu"][2].online_mask):
        raise AssertionError(f"faults {name} card vs CPU: counts "
                             f"{counts['cuda']} against {counts['cpu']}")
    ups = {run: r[0] for run, r in runs.items()}
    steps, l2 = os_mod.update_gap(ups["cpu"], ups["cuda"])
    gaps = [os_mod.update_gap(ups["cpu"], ups[o]) for o in orders]
    s_l2 = max(g[1] for g in gaps)
    bar_l2 = max(TASK_CARD_FLOOR, os_mod.SPREAD_FACTOR * s_l2)
    out = dict(update_rel_l2=l2, update_steps=steps, spread_rel_l2=s_l2,
               spread_steps=max(g[0] for g in gaps), bar_rel_l2=bar_l2,
               orders=list(orders), counts=counts["cuda"],
               normals_replayed=len(normals),
               cut=dict(TASK_CARD_CUT,
                        byzantine_rate=cfg.fault.byzantine_rate))
    log(f"faults {name} card vs CPU ({n} clients, float32): counts equal "
        f"{counts['cuda']}; update relative L2 {l2:.3e} (bar "
        f"{bar_l2:.3e}), CPU order spread {s_l2:.3e}; {len(normals)} "
        "normals replayed")
    if l2 > bar_l2:
        raise AssertionError(f"faults {name} card vs CPU: {out}")
    return out


def faults_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
                 FederatedTrainer, os_mod, qk, fa, main_round_ms):
    """The fault planes on the north-star round (quantized FedAvg,
    ResNet-20, bf16, 100 clients, k = 10, batch 50, 10 local steps):
    ``faults_free`` (no fault knob; run first and last, the armed paths'
    round ms over the two runs' mean), ``faults_drill`` (``FAULTS_DRILL``:
    over-selection to k' = 13, the trace availability model, crashes,
    stragglers, nan poison, a sign-flipping cohort, the guards and
    ``trimmed_mean``), the drill on the stream plane (bitwise the
    resident run's params and generator state after its 2 rounds) and
    ``faults_dp`` (``FAULTS_DP``: DP-FedAvg composed with
    ``trimmed_mean``), each 1 warm-up and 1 timed round and (but the
    stream run and the second fault-free run) 1 profiled; cuDNN deterministic for the phase. Then the
    uplink stack of a ``zero`` and a ``collude`` round held against the
    plain version, and the drill's and the DP path's rounds cut to 4
    clients and 2 steps card vs CPU in float32."""
    t_phase = time.perf_counter()
    base = path_config(tcfg, "resnet20")
    data = path_data(base, seed, stack_partitions)
    out = {"paths": {}}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # the fault-free round before and after the armed ones: round
        # ms move from run to run (PERF.md section 5)
        runs = (("faults_free", {}, "device"),
                ("faults_drill", FAULTS_DRILL, "device"),
                ("faults_drill_stream", FAULTS_DRILL, "stream"),
                ("faults_dp", FAULTS_DP, "device"),
                ("faults_free_again", {}, "device"))
        finals = {}
        for name, fault, plane in runs:
            # faults_free_again's profile would be faults_free's again
            out["paths"][name], *finals[name] = faults_path(
                name, faults_config(tcfg, fault, plane), data, seed,
                define_model, make_algorithm, FederatedTrainer, qk, fa,
                profile=plane == "device" and name != "faults_free_again")
        crafted = {}
        for mode, need in (("zero", 1), ("collude", 2)):
            crafted[mode] = crafted_stack(
                f"drill_{mode}",
                faults_config(tcfg, dict(FAULTS_DRILL, byzantine_mode=mode)),
                data, seed, define_model, make_algorithm, FederatedTrainer,
                qk, need)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (rp, rr), (sp, sr) = finals["faults_drill"], \
        finals["faults_drill_stream"]
    gap = _params_gap(sp, rp)
    same_rng = bool(torch.equal(sr, rr))
    if gap != 0.0 or not same_rng:
        raise AssertionError(f"faults_drill on the stream plane: params "
                             f"{gap} from the resident run's, generator "
                             f"state equal: {same_rng}")
    free_ms = statistics.mean(out["paths"][n]["round_ms"] for n in (
        "faults_free", "faults_free_again"))
    for p in out["paths"].values():
        p["round_ms_over_faults_free"] = p["round_ms"] / free_ms
        p["round_ms_over_main_path"] = p["round_ms"] / main_round_ms
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = {}
    try:
        for name, fault in (("faults_drill", FAULTS_DRILL),
                            ("faults_dp", FAULTS_DP)):
            cut = dict(fault)
            if cut.get("byzantine_rate"):
                cut["byzantine_rate"] = FAULTS_CUT_BYZANTINE_RATE
            cfg = cut_config(faults_config(tcfg, cut, dtype="float32"),
                             **TASK_CARD_CUT)
            card[name] = faults_card_vs_cpu(name, cfg, data, seed, os_mod,
                                            qk)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    out.update(stream_bitwise=dict(max_abs_gap=gap, rng_state_equal=same_rng),
               crafted_stacks=crafted, card_vs_cpu=card,
               main_path_round_ms=main_round_ms, cudnn_deterministic=True,
               drill=FAULTS_DRILL, dp=FAULTS_DP,
               phase_s=time.perf_counter() - t_phase)
    log(f"faults phase: {out['phase_s']:.1f} s; round ms "
        + ", ".join(f"{n} {p['round_ms']:.1f} "
                    f"({p['round_ms_over_faults_free']:.3f}x faults_free, "
                    f"{p['round_ms_over_main_path']:.3f}x the main path)"
                    for n, p in out["paths"].items()))
    return out


def leaf_hashes(params, rng_state) -> dict:
    """sha256 of each server param's bytes (by name) and of the
    generator state (``"rng"``): a round's bitwise fingerprint."""
    out = {}
    for name, t in params.items():
        raw = t.detach().reshape(-1).contiguous().view(torch.uint8)
        out[name] = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()
    out["rng"] = hashlib.sha256(rng_state.numpy().tobytes()).hexdigest()
    return out


def keep_hashes(run_dir) -> dict:
    """{round: :func:`leaf_hashes`} of every per-round keep a run wrote,
    read from the files."""
    from fedtorch_tpu_torch.utils.checkpoint import _unframe_payload
    out = {}
    for name in os.listdir(run_dir):
        m = re.match(r"checkpoint_r(\d+)\.ckpt$", name)
        if m:
            with open(os.path.join(run_dir, name), "rb") as f:
                data, bad = _unframe_payload(f.read())
            if bad is not None:
                raise AssertionError(f"{name}: {bad}")
            s = torch.load(io.BytesIO(data), weights_only=True)["server"]
            out[int(m.group(1))] = leaf_hashes(s["params"], s["rng_state"])
    return dict(sorted(out.items()))


def first_difference(got: dict, want: dict):
    """The first (round, leaf) whose hash differs, or None."""
    for r in sorted(set(got) | set(want)):
        g, w = got.get(r), want.get(r)
        if g is None or w is None:
            return (r, "missing")
        for leaf in w:
            if g.get(leaf) != w[leaf]:
                return (r, leaf)
    return None


def lifecycle_argv(root, rounds=LIFECYCLE_ROUNDS, extra=()):
    """``CLI_ARGV`` for ``rounds`` rounds on the CIFAR-10 files in
    ``root``: an evaluation and a checkpoint every round, a keep every
    round (the newest ``LIFECYCLE_KEEP`` kept), telemetry at its
    default."""
    argv = list(CLI_ARGV)
    argv[argv.index("--num_comms") + 1] = str(rounds)
    return argv + ["-p", root, "--save_all_models", "true",
                   "--checkpoint_keep_last_n", str(LIFECYCLE_KEEP),
                   "--telemetry", "default", "--debug", "false"] + list(extra)


def log_sync_sites(what: str, n: dict) -> None:
    """A watched round's named synchronizing calls (``tracing.Watch``),
    the sites on lines of their own. The sentinel's total (the sync-debug
    warnings) is held against the profiler's record of the runtime
    calls, which no warning feeds: it fails unless the profiler holds as
    many ``cudaStreamSynchronize`` (the call under every warning) and no
    other synchronizing call beyond the window's own drains (a sync the
    debug mode missed)."""
    from fedtorch_tpu_torch.utils.tracing import (
        WARNED_SYNC_CALL, WINDOW_DRAINS,
    )
    rt = n["runtime_syncs"]
    calls = ", ".join(f"{k} {v}" for k, v in rt.items()
                      if k not in ("total", "unwarned") and v)
    log(f"{what}: {n['syncs']} synchronizing CUDA calls named by the "
        f"sentinel; the profiler's runtime syncs {rt['total']} ({calls}; "
        f"{WINDOW_DRAINS} the window's own drains, {rt['unwarned']} "
        "unwarned)")
    for site in n["sync_sites"]:
        log(f"  {site['count']:4d}  {site['site']} ({site['function']})")
    if n["syncs"] != rt[WARNED_SYNC_CALL] or rt["unwarned"] != 0:
        raise AssertionError(
            f"{what}: the sentinel's {n['syncs']} synchronizing calls "
            f"against the profiler's {rt}: {rt['unwarned']} sync(s) the "
            "debug mode did not report, or a warning without its call")


def lifecycle_run(argv, run_dir, qk, fa, window_round=None):
    """``fedtorch_tpu_torch.cli.main`` in this process on ``argv +
    --run_dir run_dir``, under a strict ``LockOrderSentinel`` (every
    host-plane lock the run makes records its acquisition order; an
    inversion or a re-entrant acquire fails the run): the results, the
    kernel launches (counters set to 0 just before), each round's
    :func:`leaf_hashes`, the wall, and (``window_round``) what that
    round's loop body, from the end of the round before to the end of
    its own, copied and synchronized (``tracing.Watch``), with the
    sentinel's lock names and order edges under ``locks``."""
    from fedtorch_tpu_torch import cli
    from fedtorch_tpu_torch.utils.lock_sentinel import LockOrderSentinel
    from fedtorch_tpu_torch.utils.tracing import Watch
    hashes, window, live = [], {}, []

    def callback(r, trainer, server, clients, metrics):
        if live:
            window.update(live.pop().close(), round=r)
        hashes.append(leaf_hashes(server.params, server.rng.get_state()))
        if window_round is not None and r + 1 == window_round:
            live.append(Watch())

    gc.collect()
    torch.cuda.empty_cache()
    reset_counters(qk, fa)
    t0 = time.perf_counter()
    with LockOrderSentinel(strict=True) as locks:
        res = cli.main(argv + ["--run_dir", run_dir],
                       round_callback=callback)
    wall = time.perf_counter() - t0
    window["locks"] = dict(names=locks.lock_names(),
                           order_edges=locks.order_edges(),
                           violations=locks.violations)
    return res, counters(qk, fa), hashes, wall, window


def _rows(run_dir, name="metrics.jsonl"):
    from fedtorch_tpu_torch.telemetry import load_jsonl
    return load_jsonl(os.path.join(run_dir, name))[1]


def lifecycle_drill(root, name, extra, want, qk):
    """The kill drill (``fedtorch_tpu_torch/tools/kill_drill.py``): ``python
    -m fedtorch_tpu_torch.cli`` on ``lifecycle_argv`` + ``extra`` under
    the port's ``ElasticRunner``, SIGTERM once it logged round index
    ``LIFECYCLE_KILL_AFTER``,
    the relaunch with ``--resume``; exit codes [75, 0], every round's
    keep (all kept) bitwise ``want`` (or what ``want()`` gives once the
    drill ends, for a reference run beside it), the resumed process's 2 + 2 ragged
    launches a round (its ``kernels.launches`` event), and the kernel
    library not rebuilt. The children get cuDNN's deterministic mode, as
    this process has it for the phase, from a ``sitecustomize`` on their
    path."""
    from fedtorch_tpu_torch.ops.cuda import build
    from fedtorch_tpu_torch.tools.kill_drill import kill_drill
    run_dir = os.path.join(root, name)
    site = os.path.join(root, "site")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write("import torch\ntorch.backends.cudnn.deterministic = True\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [site, os.path.dirname(os.path.abspath(__file__)),
         env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "fedtorch_tpu_torch.cli"] + lifecycle_argv(
        root, rounds=LIFECYCLE_DRILL_ROUNDS,
        extra=list(extra) + ["--checkpoint_keep_last_n", "0", "--debug",
                             "true", "--run_dir", run_dir])
    libs = {p.name: p.stat().st_mtime_ns
            for p in build.BUILD_DIR.glob("*.so")}
    out = kill_drill(cmd, run_dir, kill_after=LIFECYCLE_KILL_AFTER,
                     timeout_s=300, env=env)
    rebuilt = {p.name: p.stat().st_mtime_ns
               for p in build.BUILD_DIR.glob("*.so")} != libs
    if callable(want):
        # the reference ran beside the drill
        want = want()
    got = keep_hashes(run_dir)
    diff = first_difference(got, {r: want[r] for r in range(
        1, LIFECYCLE_DRILL_ROUNDS + 1)})
    events = _rows(run_dir, "events.jsonl")
    resumed = [e for e in events if e.get("event") == "kernels.launches"]
    last = resumed[-1] if resumed else {}
    per_round = {k: last.get(k, 0) / max(last.get("rounds", 0), 1)
                 for k in ("ragged_stats", "ragged_apply")}
    res = dict(rcs=out["rcs"], harness_rc=out["rc"],
               killed_after_round_index=out["killed_after"],
               seconds=out["seconds"], keeps=sorted(got),
               first_difference=diff, resumed_rounds=last.get("rounds"),
               resumed_launches_per_round=per_round,
               kernel_library_rebuilt=rebuilt)
    log(f"lifecycle {name}: exit codes {out['rcs']} in "
        f"{out['seconds']:.1f} s; keeps {sorted(got)}, first difference "
        f"{diff}; the resumed process ran {last.get('rounds')} round(s) "
        f"at {per_round} ragged launches a round")
    if out["rcs"] != [75, 0] or diff is not None \
            or last.get("rounds", 0) < 1 \
            or per_round != {"ragged_stats": 2.0, "ragged_apply": 2.0} \
            or rebuilt or out["killed_after"] != LIFECYCLE_KILL_AFTER:
        tail = "\n".join(ln for lines in out["outputs"]
                         for ln in lines[-15:])
        raise AssertionError(f"lifecycle {name}: {res}\n{tail}\n"
                             + "\n".join(out["harness_log"]))
    return res


def lifecycle_supervisor(seed, tcfg, define_model, make_algorithm,
                         stack_partitions, FederatedTrainer, data):
    """``LIFECYCLE_SUP`` (nan poison at 0.05, guards off, 2 retries) on
    the main path's round under ``RoundSupervisor`` for
    ``LIFECYCLE_SUP_ROUNDS`` rounds (more, up to
    ``LIFECYCLE_SUP_MAX_ROUNDS``, until one rolled back): after every
    rollback the restored
    server (params, optimizer state, aux, round), every client tensor
    and the generator are bitwise the pre-round state; the final params
    finite. Then the round cut by ``TASK_CARD_CUT`` in float32 with nan
    poison at ``LIFECYCLE_CUT_NAN_RATE``, ``LIFECYCLE_CUT_ROUNDS``
    supervised rounds on the card and on the CPU: the same counts."""
    from fedtorch_tpu_torch.core.state import tree_leaves
    from fedtorch_tpu_torch.robustness.supervisor import RoundSupervisor
    from fedtorch_tpu_torch.utils.diagnostics import check_finite

    def supervised(cfg, d, device, rounds, checked=False):
        model = define_model(cfg, device=device)
        trainer = FederatedTrainer(cfg, model, make_algorithm(cfg), d,
                                   device=device)
        sup = RoundSupervisor(trainer, sleep_fn=lambda s: None)
        pre, restores = {}, []
        if checked:
            orig = sup._restore

            def restore(snap, server, clients):
                s, c = orig(snap, server, clients)
                same = s.round == pre["round"] and torch.equal(
                    s.rng.get_state(), pre["rng"]) and all(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves((s.params, s.opt, s.aux, c)),
                        pre["leaves"]))
                restores.append(bool(same))
                return s, c
            sup._restore = restore
        s, c = trainer.init_state(seed)
        t0 = time.perf_counter()
        # a checked drill goes on past ``rounds`` until a rollback came
        # (up to LIFECYCLE_SUP_MAX_ROUNDS): the check must have run
        while s.round < rounds or (checked and not sup.stats.rollbacks
                                   and s.round < LIFECYCLE_SUP_MAX_ROUNDS):
            if checked:
                pre.update(round=s.round, rng=s.rng.get_state(),
                           leaves=[t.clone() for t in tree_leaves(
                               (s.params, s.opt, s.aux, c))])
            s, c, _ = sup.run_round(s, c)
        if device == "cuda":
            torch.cuda.synchronize()
        st = sup.stats
        counts = dict(rounds=s.round, rollbacks=st.rollbacks,
                      retries=st.retries, skipped=st.skipped_rounds,
                      healthy=st.healthy_rounds)
        return counts, restores, check_finite(s.params), \
            time.perf_counter() - t0

    cfg = faults_config(tcfg, LIFECYCLE_SUP)
    counts, restores, finite, sup_s = supervised(
        cfg, data, "cuda", LIFECYCLE_SUP_ROUNDS, checked=True)
    gc.collect()
    torch.cuda.empty_cache()
    cut = cut_config(faults_config(tcfg, dict(
        LIFECYCLE_SUP, nan_inject_rate=LIFECYCLE_CUT_NAN_RATE),
        dtype="float32"), **TASK_CARD_CUT)
    small = _first(data, cut.federated.num_clients)
    cut_counts = {dev: supervised(cut, small, dev, LIFECYCLE_CUT_ROUNDS)[0]
                  for dev in ("cuda", "cpu")}
    out = dict(config=LIFECYCLE_SUP, rounds=LIFECYCLE_SUP_ROUNDS,
               rounds_run=counts["rounds"], counts=counts,
               restores_bitwise=restores,
               final_params_finite=finite, seconds=sup_s,
               cut=dict(TASK_CARD_CUT, nan_inject_rate=LIFECYCLE_CUT_NAN_RATE,
                        rounds=LIFECYCLE_CUT_ROUNDS),
               cut_counts=cut_counts)
    log(f"lifecycle supervisor: {counts} over {counts['rounds']} rounds "
        f"in {sup_s:.1f} s, restores bitwise {restores}, final params "
        f"finite {finite}; cut round card {cut_counts['cuda']} vs CPU "
        f"{cut_counts['cpu']}")
    if not restores or not all(restores) \
            or len(restores) != counts["rollbacks"] or not finite \
            or cut_counts["cuda"] != cut_counts["cpu"]:
        raise AssertionError(f"lifecycle supervisor: {out}")
    return out


def lifecycle_stream_and_supervisor(root, seed, tcfg, define_model,
                                    make_algorithm, stack_partitions,
                                    FederatedTrainer, qk, fa, want,
                                    want_launch, out, lap):
    """The lifecycle phase's in-process runs beside the kill drills: the
    stream plane's telemetry pair and chaos run, then the supervisor
    drill (:func:`lifecycle_phase`); fills ``out``."""
    # -- the stream plane without saves: telemetry default and off (round
    # index 1 watched: equal synchronizing calls, the profiled memcpys
    # beside them), then stream.gather faults bitwise the fault-free
    # (default) run
    runs = {}
    for name, extra in (
            ("stream_default", ("--telemetry", "default")),
            ("stream_off", ("--telemetry", "off")),
            ("stream_chaos", LIFECYCLE_CHAOS)):
        argv = lifecycle_argv(
            root, rounds=LIFECYCLE_STREAM_ROUNDS,
            extra=["--data_plane", "stream", "--eval_freq", "1000",
                   *extra])
        run_dir = os.path.join(root, name)
        res, launched, hashes, wall, window = lifecycle_run(
            argv, run_dir, qk, fa,
            window_round=None if name == "stream_chaos" else 1)
        runs[name] = hashes
        out[name] = dict(
            wall_s=wall, launches=launched, window=window,
            round_ms=res["timer"]["round"]
            / LIFECYCLE_STREAM_ROUNDS * 1e3,
            host_recovery=res.get("host_recovery"))
        if name != "stream_off":
            last = _rows(run_dir)[-1]
            out[name].update(
                stream_wait_s=last["stream_wait_s"],
                stream_gather_s=last["stream_gather_s"],
                stream_rebuilds=last["stream_rebuilds"],
                host_retries=last["host_retries"])
        if launched != {k: v * LIFECYCLE_STREAM_ROUNDS
                        for k, v in want_launch.items()}:
            raise AssertionError(f"lifecycle {name}: {out[name]}")
    lap("stream")
    on, off = (out[n]["window"] for n in ("stream_default",
                                          "stream_off"))
    out["telemetry"] = dict(
        syncs_default=on["syncs"], syncs_off=off["syncs"],
        profiled_dtoh_default=on["dtoh"],
        profiled_dtoh_off=off["dtoh"],
        profiled_quantizer=[on["quantizer"], off["quantizer"]],
        stream_bitwise_reference=runs["stream_default"]
        == [want[r + 1] for r in range(LIFECYCLE_STREAM_ROUNDS)])
    if on["syncs"] != off["syncs"]:
        raise AssertionError(f"lifecycle telemetry: {out['telemetry']}")
    rec = out["stream_chaos"]["host_recovery"] or {}
    if runs["stream_chaos"][-1] != runs["stream_default"][-1] \
            or rec.get("host_retries", 0) < 1:
        raise AssertionError(
            f"lifecycle stream chaos: {out['stream_chaos']}, "
            "difference "
            f"{first_difference({0: runs['stream_chaos'][-1]}, {0: runs['stream_default'][-1]})}")
    # -- the supervisor, on the main path's synthetic data
    cfg = faults_config(tcfg, LIFECYCLE_SUP)
    data = path_data(cfg, seed, stack_partitions)
    out["supervisor"] = lifecycle_supervisor(
        seed, tcfg, define_model, make_algorithm, stack_partitions,
        FederatedTrainer, data)
    lap("supervisor")


def lifecycle_phase(seed, tcfg, define_model, make_algorithm,
                    stack_partitions, FederatedTrainer, qk, fa, beside=None):
    """The run lifecycle on the ResNet-20 main path's round (quantized
    int8 both ways, 100 clients, k = 10, batch 50, 10 local steps) from
    CIFAR-10 files written from ``seed``, through the CLI, cuDNN
    deterministic:

    * ``reference``: rounds with an evaluation, a checkpoint and a keep
      every round (the newest 2 kept), telemetry at its default; each
      round's server params and generator hashed; 2 + 2 ragged launches
      a round; every metrics row valid, one a round, the final health
      intent ``complete``; the checkpoint's size and the sync save's ms.
      Run three times on the device plane, one after another:
      ``reference_off`` (no evaluations and so no saves;
      ``LIFECYCLE_ROUNDS`` rounds, the hashes the drills are held to),
      ``reference_sync`` and ``reference_async`` (``--async_checkpoint``;
      ``LIFECYCLE_SAVED_ROUNDS`` rounds each), each bitwise the others
      round by round, the async keeps bitwise the sync ones; their round
      ms (the timer's round, saves outside it) and
      the loop's checkpoint ms a round (the save call in the loop; the
      async writer's final flush apart) side by side.
    * ``stream_default``, ``stream_off``: ``LIFECYCLE_STREAM_ROUNDS``
      rounds on the stream plane without evaluations or saves at
      ``--telemetry default`` and ``off``, round index 1's loop body
      watched: the same count of synchronizing CUDA calls (sync debug
      mode, every device-to-host copy that waits among them), and the
      profiler's memcpy records beside it (reported: its records can be
      lost).
    * ``torn``: the reference run directory copied, its newest keep and
      its checkpoint torn through the ``ckpt.torn`` seam; ``--resume``
      takes the previous valid keep, names both skipped files, and its
      round is bitwise the reference's; its resume ms.
    * ``drill_sync`` and ``drill_async``: the kill drill
      (:func:`lifecycle_drill`), with sync and with ``--async_checkpoint``
      saves, beside this process's torn, stream and supervisor runs
      (their round ms are not comparable and not reported). ``beside()``, when
      given, is called as the drills start: it starts other phases'
      child processes that belong in this untimed window.
    * ``supervisor``: :func:`lifecycle_supervisor`.
    * ``stream_chaos``: the same rounds with ``stream.gather`` faults
      (``LIFECYCLE_CHAOS``): params and generator bitwise
      ``stream_default``'s, retries counted, the consumer's wait
      reported.
    """
    import shutil
    import tempfile
    import warnings

    from fedtorch_tpu_torch.robustness import host_chaos
    from fedtorch_tpu_torch.telemetry import read_health, validate_metrics_row

    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"laps_s": {}}

    def lap(name):
        out["laps_s"][name] = time.perf_counter() - t_phase
        log(f"lifecycle: {name} done at {out['laps_s'][name]:.1f} s")
    S = LIFECYCLE_SAVED_ROUNDS
    want_launch = dict(ragged_stats=2, ragged_apply=2, stats=0, apply=0,
                       flash=0, flash_tc=0, flash_tf32=0)
    try:
        with tempfile.TemporaryDirectory() as root:
            write_cifar10(root, seed)
            # -- the reference: saves off, sync and async, in this
            # process on the device plane, one after another
            refs, want = {}, None
            for name, extra, R in (
                    ("reference_off", ("--eval_freq", "1000"),
                     LIFECYCLE_ROUNDS),
                    ("reference_sync", (), S),
                    ("reference_async", ("--async_checkpoint",), S)):
                run_dir = os.path.join(root, name)
                res, launched, hashes, wall, win = lifecycle_run(
                    lifecycle_argv(root, rounds=R, extra=extra), run_dir,
                    qk, fa)
                rows = _rows(run_dir)
                for row in rows:
                    validate_metrics_row(row)
                health = read_health(run_dir)
                saves = [r.get("checkpoint_s", 0.0) * 1e3 for r in rows]
                refs[name] = dict(
                    rounds=res["rounds"], wall_s=wall, launches=launched,
                    round_ms=res["timer"]["round"] / R * 1e3,
                    round_ms_each=[r["round_s"] * 1e3 for r in rows],
                    round_ms_median=statistics.median(
                        r["round_s"] for r in rows) * 1e3,
                    save_ms=saves, checkpoint_ms=statistics.mean(saves),
                    final_flush_ms=res["timer"].get("checkpoint", 0.0)
                    * 1e3 - sum(saves),
                    eval_ms=res["timer"].get("eval", 0.0) / R * 1e3,
                    rows=len(rows), health=health["intent"],
                    keeps=sorted(keep_hashes(run_dir)),
                    lock_sentinel=win["locks"])
                refs[name]["loop_ms"] = refs[name]["round_ms"] \
                    + refs[name]["checkpoint_ms"]
                if name != "reference_off":
                    refs[name]["ckpt_mb"] = os.path.getsize(os.path.join(
                        run_dir, "checkpoint.ckpt")) / 1e6
                got = {r + 1: h for r, h in enumerate(hashes)}
                if want is None:
                    want = got
                if launched != {k: v * R for k, v in want_launch.items()} \
                        or [r["round"] for r in rows] != list(range(R)) \
                        or health["intent"] != "complete" \
                        or res["rounds"] != R:
                    raise AssertionError(f"lifecycle {name}: {refs[name]}")
                if got != {r: want[r] for r in got}:
                    raise AssertionError(
                        f"lifecycle {name}: its rounds differ from "
                        f"reference_off's: {first_difference(got, want)}")
                if name != "reference_off" and keep_hashes(run_dir) \
                        != {r: want[r] for r in (R - 1, R)}:
                    raise AssertionError(
                        f"lifecycle {name}: its keeps differ from its "
                        f"rounds: "
                        f"{first_difference(keep_hashes(run_dir), want)}")
            out["reference"] = refs
            lap("reference")
            # -- the kill drills: their children run beside this process's
            # torn, stream and supervisor runs (a drill waits on its
            # children; one child a drill runs at a time), and so do the
            # children ``beside()`` starts (a third drill, the podscale
            # CLI pair)
            drills = {}

            def drill(name, extra):
                try:
                    drills[name] = lifecycle_drill(root, name, extra, want,
                                                   qk)
                except BaseException as e:  # re-raised after the join
                    drills[name] = e

            threads = [threading.Thread(target=drill, args=a,
                                        name=f"lifecycle-{a[0]}")
                       for a in (("drill_sync", ()),
                                 ("drill_async", ("--async_checkpoint",)))]
            for t in threads:
                t.start()
            if beside is not None:
                beside()
            try:
                # -- a torn newest keep: resume takes the previous valid
                # one
                torn_dir = os.path.join(root, "torn")
                shutil.copytree(os.path.join(root, "reference_sync"),
                                torn_dir)
                inj = host_chaos.HostFaultInjector(("ckpt.torn",),
                                                   rate=1.0).install()
                try:
                    for fname in ("checkpoint.ckpt", f"checkpoint_r{S}.ckpt"):
                        path = os.path.join(torn_dir, fname)
                        with open(path, "rb") as f:
                            blob = host_chaos.maybe_truncate("ckpt.torn",
                                                             f.read())
                        with open(path, "wb") as f:
                            f.write(blob)
                finally:
                    inj.uninstall()
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    res, launched, hashes, _, _ = lifecycle_run(
                        lifecycle_argv(root, rounds=S,
                                       extra=["--resume", torn_dir]),
                        torn_dir, qk, fa)
                said = " ".join(str(w.message) for w in seen)
                named = [f for f in ("checkpoint.ckpt",
                                     f"checkpoint_r{S}.ckpt",
                                     f"checkpoint_r{S - 1}.ckpt")
                         if f in said]
                out["torn"] = dict(
                    warning=said[:400], named=named, rounds_run=len(hashes),
                    resume_ms=res["timer"]["resume"] * 1e3,
                    launches=launched)
                lap("torn")
                if len(named) != 3 or len(hashes) != 1 \
                        or hashes[0] != want[S]:
                    raise AssertionError(f"lifecycle torn: {out['torn']}")
                lifecycle_stream_and_supervisor(
                    root, seed, tcfg, define_model, make_algorithm,
                    stack_partitions, FederatedTrainer, qk, fa, want,
                    want_launch, out, lap)
            finally:
                for t in threads:
                    t.join(600)
            for name in ("drill_sync", "drill_async"):
                if isinstance(drills.get(name), BaseException):
                    raise drills[name]
                out[name] = drills[name]
                rows = _rows(os.path.join(root, name))
                out[name]["last_row_ckpt"] = {
                    k: v for k, v in rows[-1].items()
                    if k.startswith("ckpt_")}
            lap("drills")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref = out["reference"]
    writers = (("saves_off", "reference_off"), ("sync", "reference_sync"),
               ("async", "reference_async"))
    out.update(
        ckpt_mb=ref["reference_sync"]["ckpt_mb"],
        save_ms=ref["reference_sync"]["checkpoint_ms"],
        resume_ms=out["torn"]["resume_ms"],
        round_ms={w: ref[n]["round_ms"] for w, n in writers},
        round_ms_median={w: ref[n]["round_ms_median"] for w, n in writers},
        checkpoint_ms={w: ref[n]["checkpoint_ms"] for w, n in writers},
        loop_ms={w: ref[n]["loop_ms"] for w, n in writers},
        cudnn_deterministic=True, phase_s=time.perf_counter() - t_phase,
        budget_s=LIFECYCLE_BUDGET_S)
    log(f"lifecycle phase: {out['phase_s']:.1f} s; checkpoint "
        f"{out['ckpt_mb']:.1f} MB, sync save {out['save_ms']:.1f} ms, resume "
        f"{out['resume_ms']:.1f} ms; round ms "
        f"{out['round_ms']} (medians {out['round_ms_median']}); the loop's "
        "checkpoint ms "
        f"{out['checkpoint_ms']}; round + checkpoint ms {out['loop_ms']}")
    if out["phase_s"] > LIFECYCLE_BUDGET_S:
        log(json.dumps(out))
        raise AssertionError(f"lifecycle phase took {out['phase_s']:.1f} s, "
                             f"over its {LIFECYCLE_BUDGET_S} s budget")
    return out


def federation_config(tcfg, fed=None, fault=None, cohort=False,
                      plane="device", dtype="bfloat16"):
    """The north-star round (``path_config``'s ResNet-20) with federated
    fields ``fed`` (``ASYNC_FED``: the commit plane), the fault planes
    ``fault``, cohort statistics on or off, on ``plane``."""
    cfg = path_config(tcfg, "resnet20", dtype=dtype)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_plane=plane),
        federated=dataclasses.replace(cfg.federated, **(fed or {})),
        fault=tcfg.FaultConfig(**(fault or {})),
        telemetry=dataclasses.replace(cfg.telemetry,
                                      cohort_stats=cohort)).finalize()


def _record_plans(trainer, plans: list):
    """Record each round's drawn plan on ``trainer`` (its cohort)."""
    real = trainer.draw_plan

    def draw(server):
        plan = real(server)
        plans.append(plan)
        return plan
    trainer.draw_plan = draw


def cohort_path(name, cfg, data, seed, define_model, make_algorithm,
                FederatedTrainer, qk, fa):
    """The main path's round with cohort statistics ``cfg`` on or off:
    1 warm-up round (its uplink stack held against the plain version),
    round index 1 watched (``tracing.watch``: its ``run_round`` and the
    loop's one fetch, ``round_host_scalars(..., ledger=True)``), then
    ``FED_COHORT_TIMED`` timed rounds; the counters set to 0 just before
    (2 + 2 ragged launches a round); with the statistics on, each
    round's cohort vectors [k] with ids the round's cohort."""
    gc.collect()
    torch.cuda.empty_cache()
    trainer = FederatedTrainer(cfg, define_model(
        cfg, batch_size=cfg.data.batch_size), make_algorithm(cfg), data)
    server, clients = trainer.init_state(seed)
    calls, plans = [], []
    undo = _record_uplink(trainer, calls, [])
    reset_counters(qk, fa)
    torch.cuda.synchronize()
    server, clients, m = trainer.run_round(server, clients)
    trainer.round_host_scalars(clients, m, ledger=True)
    undo()
    held = _hold_uplink(qk, name, *calls[0])
    del calls
    _record_plans(trainer, plans)
    vectors = []

    def body():
        s, c, mm = trainer.run_round(server, clients)
        return s, c, mm, trainer.round_host_scalars(c, mm, ledger=True)
    from fedtorch_tpu_torch.utils.tracing import watch
    (server, clients, m, (sc, led1)), watched = watch(body)
    log_sync_sites(f"federation {name}: round index 1 (run_round and its "
                   "one fetch)", watched)
    vectors.append(led1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    start.record()
    for _ in range(FED_COHORT_TIMED):
        server, clients, m = trainer.run_round(server, clients)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    round_ms = start.elapsed_time(end) / FED_COHORT_TIMED
    vectors += [trainer.round_host_scalars(clients, m, ledger=True)[1]
                for m in metrics]
    launched = counters(qk, fa)
    rounds = 2 + FED_COHORT_TIMED
    want = dict(ragged_stats=2 * rounds, ragged_apply=2 * rounds, stats=0,
                apply=0, flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"federation {name}: kernels launched "
                             f"{launched} in {rounds} rounds, expected "
                             f"{want}")
    k = trainer.k_online
    cohort = None
    if cfg.telemetry.cohort_stats:
        for plan, v in zip(plans, vectors):
            if v is None or v["idx"].shape != (k,) or v["idx"].tolist() \
                    != plan.idx.tolist() or v["norm_q"].shape != (5,) \
                    or not all(np.isfinite(x).all() for x in v.values()):
                raise AssertionError(f"federation {name}: cohort vectors "
                                     f"{v} for the cohort {plan.idx}")
        cohort = dict(
            dispersion_round_1=sc["cohort_dispersion"],
            norm_q_last=vectors[-1]["norm_q"].tolist(),
            suspicion_last=vectors[-1]["suspicion"].tolist(),
            selected=[float(v["selected"].sum()) for v in vectors])
    elif any(v is not None for v in vectors):
        raise AssertionError(f"federation {name}: cohort vectors with the "
                             "statistics off")
    out = dict(path=name, cohort_stats=cfg.telemetry.cohort_stats,
               rounds=rounds, timed_rounds=FED_COHORT_TIMED,
               round_ms=round_ms, launches=launched, tree_launches=want,
               launches_per_round={c: n / rounds
                                   for c, n in launched.items()},
               round_index_1=watched, uplink_vs_plain=held, cohort=cohort)
    params = {n: v.detach().clone() for n, v in server.params.items()}
    rng_state = server.rng.get_state()
    log(f"federation {name}: {round_ms:.1f} ms/round over "
        f"{FED_COHORT_TIMED}; round index 1: {watched}; launches "
        f"{launched}; uplink stack vs plain {held}; cohort {cohort}")
    trainer.close()
    del trainer, server, clients
    return out, params, rng_state


def commit_numbers(m) -> dict:
    return dict(staleness_mean=float(m.staleness_mean),
                stragglers=float(m.straggler_clients),
                reporters=float(m.online_mask.sum()),
                dropped=float(m.dropped_clients))


def async_path(name, cfg, data, seed, define_model, make_algorithm,
               AsyncFederatedTrainer, qk, fa, timed=ASYNC_TIMED_COMMITS,
               profile=True):
    """``async_resnet20`` (``cfg``) on its plane: 1 warm-up commit (its
    uplink stack of m rows held against the plain version), ``timed``
    timed commits, the counters set to 0 just before (2 + 2 ragged
    launches a commit), then (``profile``) one profiled commit. Returns
    (numbers, server params, ring params and generator state after the
    1 + ``timed`` commits)."""
    gc.collect()
    torch.cuda.empty_cache()
    trainer = AsyncFederatedTrainer(cfg, define_model(
        cfg, batch_size=cfg.data.batch_size), make_algorithm(cfg), data)
    trainer.stream_timeout_s = 60.0
    server, clients = trainer.init_state(seed)
    calls = []
    undo = _record_uplink(trainer, calls, [])
    reset_counters(qk, fa)
    torch.cuda.synchronize()
    server, clients, m = trainer.run_round(server, clients)
    torch.cuda.synchronize()
    undo()
    held = _hold_uplink(qk, name, *calls[0])
    del calls
    per_commit = [commit_numbers(m)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    start.record()
    for _ in range(timed):
        server, clients, m = trainer.run_round(server, clients)
        ms.append(m)
    end.record()
    torch.cuda.synchronize()
    commit_ms = start.elapsed_time(end) / timed
    launched = counters(qk, fa)
    commits = 1 + timed
    want = dict(ragged_stats=2 * commits, ragged_apply=2 * commits,
                stats=0, apply=0, flash=0, flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"federation {name}: kernels launched "
                             f"{launched} in {commits} commits, expected "
                             f"{want}")
    per_commit += [commit_numbers(m) for m in ms]
    params = {n: v.detach().clone() for n, v in server.params.items()}
    ring = {n: v.detach().clone()
            for n, v in server.aux["ring"]["params"].items()}
    rng_state = server.rng.get_state()
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError(f"federation {name}: non-finite server params")
    gauges = trainer.telemetry_gauges()
    m_buf = trainer.buffer_size
    out = dict(path=name, data_plane=cfg.data.data_plane,
               avail_model=cfg.fault.avail_model,
               concurrency=trainer.concurrency, buffer=m_buf,
               snapshot_ring=trainer.snapshot_ring, commits=commits,
               timed_commits=timed, commit_ms=commit_ms, launches=launched,
               tree_launches=want,
               launches_per_round={c: n / commits
                                   for c, n in launched.items()},
               per_commit=per_commit,
               staleness_histogram=trainer.staleness_histogram(),
               dispatches=gauges.get("async_dispatches"),
               stragglers_dispatched=gauges.get("async_stragglers"),
               ring_clamped=gauges.get("async_ring_clamped"),
               dropouts=gauges.get("async_dropouts"),
               uplink_vs_plain=held)
    if profile:
        prof = profile_phase(trainer, server, clients,
                             out["launches_per_round"], commit=True)
        out.update(profile=prof, busy_share=prof["busy_share"],
                   launches_per_local_step=prof["kernel_launches"]
                   / (m_buf * trainer.local_steps))
    trainer.close()
    log(f"federation {name}: {commit_ms:.1f} ms/commit over {timed}, "
        f"{trainer.concurrency} in flight, m {m_buf}, launches {launched}, "
        f"per commit {per_commit}, histogram {out['staleness_histogram']}"
        f", dispatches {out['dispatches']}, clamped {out['ring_clamped']}, "
        f"uplink stack vs plain {held}, busy {out.get('busy_share')}, "
        f"launches a local step {out.get('launches_per_local_step')}")
    del trainer, server, clients
    return out, params, ring, rng_state


def async_cut_run(cfg, seed, run, data, os_mod, AsyncFederatedTrainer,
                  define_model, make_algorithm, commits=ASYNC_CUT_COMMITS):
    """``commits`` commits of ``cfg`` from the weights of ``seed`` in
    ``run`` (``order_spread.run_round``'s runs: ``cuda``, ``cpu``,
    ``cpu-nchw``, ``cpu-1thread``): (the update on the CPU, each
    commit's numbers and cohort)."""
    dev, *opts = run.split("-")
    threads = torch.get_num_threads()
    try:
        for opt in opts:
            if opt.endswith("thread"):
                torch.set_num_threads(int(opt[:-len("thread")]))
        model = define_model(cfg, cfg.data.batch_size, device=dev)
        if "nchw" in opts:
            model.module.register_forward_pre_hook(os_mod._nchw_inside)
        tr = AsyncFederatedTrainer(cfg, model, make_algorithm(cfg), data,
                                   device=dev)
        server, clients = tr.init_state(seed + 1)
        p0 = {k: v.cpu() for k, v in server.params.items()}
        numbers = []
        for _ in range(commits):
            server, clients, m = tr.run_round(server, clients)
            numbers.append(dict(commit_numbers(m), online=m.online_mask.cpu()
                                .tolist()))
        return {k: v.cpu() - p0[k] for k, v in server.params.items()}, \
            numbers
    finally:
        torch.set_num_threads(threads)


def async_card_vs_cpu(cfg, data, seed, os_mod, AsyncFederatedTrainer,
                      define_model, make_algorithm,
                      orders=("cpu-nchw", "cpu-1thread")):
    """The commit cut (``ASYNC_CUT``) in float32, card (TF32 off) vs CPU,
    ``ASYNC_CUT_COMMITS`` commits: every commit's numbers equal, the
    update's relative L2 within the larger of ``TASK_CARD_FLOOR`` and
    ``SPREAD_FACTOR`` times the CPU's order spread (``faults_card_vs_cpu``'s
    bar)."""
    data = _first(data, cfg.federated.num_clients)
    runs = {run: async_cut_run(cfg, seed, run, data, os_mod,
                               AsyncFederatedTrainer, define_model,
                               make_algorithm)
            for run in ("cuda", "cpu", *orders)}
    if runs["cuda"][1] != runs["cpu"][1]:
        raise AssertionError(f"async card vs CPU: commits "
                             f"{runs['cuda'][1]} against {runs['cpu'][1]}")
    ups = {run: r[0] for run, r in runs.items()}
    steps, l2 = os_mod.update_gap(ups["cpu"], ups["cuda"])
    gaps = [os_mod.update_gap(ups["cpu"], ups[o]) for o in orders]
    s_l2 = max(g[1] for g in gaps)
    bar_l2 = max(TASK_CARD_FLOOR, os_mod.SPREAD_FACTOR * s_l2)
    out = dict(update_rel_l2=l2, update_steps=steps, spread_rel_l2=s_l2,
               spread_steps=max(g[0] for g in gaps), bar_rel_l2=bar_l2,
               orders=list(orders), commits=runs["cuda"][1],
               cut=ASYNC_CUT)
    log(f"async card vs CPU ({ASYNC_CUT}, {ASYNC_CUT_COMMITS} commits, "
        f"float32): commits equal {runs['cuda'][1]}; update relative L2 "
        f"{l2:.3e} (bar {bar_l2:.3e}), CPU order spread {s_l2:.3e}")
    if l2 > bar_l2:
        raise AssertionError(f"async card vs CPU: {out}")
    return out


def krum_card_vs_cpu(cfg, data, seed, os_mod):
    """A float32 cut round under ``krum`` with cohort statistics on, card
    (TF32 off) vs CPU: the same ``sel_mask`` (``cohort_selected``), its
    sum the round's ``robust_selected``."""
    data = _first(data, cfg.federated.num_clients)
    ms = {run: os_mod.run_round(cfg, seed, run, data=data,
                                with_metrics=True)[2]
          for run in ("cuda", "cpu")}
    sel = {run: m.cohort_selected.tolist() for run, m in ms.items()}
    out = dict(sel_mask=sel["cuda"], robust_selected=float(
        ms["cuda"].robust_selected), suspicion_cuda=ms[
            "cuda"].cohort_suspicion.tolist(),
        suspicion_cpu=ms["cpu"].cohort_suspicion.tolist())
    log(f"federation krum card vs CPU: {out}")
    if sel["cuda"] != sel["cpu"] \
            or sum(sel["cuda"]) != out["robust_selected"]:
        raise AssertionError(f"federation krum card vs CPU: {sel}, {out}")
    return out


def start_async_drill(root, qk) -> dict:
    """The kill drill of :func:`async_cli`'s reference
    (``lifecycle_drill`` on ``ASYNC_CLI_WORDS``), started at once on a
    thread: its children run beside whatever this process runs next
    (``children`` is set once they have ended), and its keeps are held,
    when it ends, to the hashes the reference puts in ``ref["want"]``
    (``ready`` set)."""
    drills, ready, children, ref = {}, threading.Event(), \
        threading.Event(), {}

    def want_fn():
        children.set()
        if not ready.wait(600) or "want" not in ref:
            raise AssertionError("federation async_drill: no reference")
        return ref["want"]

    def drill():
        try:
            drills["drill"] = lifecycle_drill(
                root, "async_drill", list(ASYNC_CLI_WORDS), want_fn, qk)
        except BaseException as e:  # re-raised after the join
            drills["drill"] = e
        finally:
            children.set()

    thread = threading.Thread(target=drill, name="federation-drill")
    thread.start()
    return dict(thread=thread, result=drills, ready=ready, ref=ref,
                children=children)


def async_cli(root, seed, qk, fa, out, lap, drill):
    """The CLI's commit plane (``ASYNC_CLI_WORDS``: ``--sync_mode async
    --cohort_stats true``) on the main path's round from the CIFAR-10
    files in ``root``, telemetry at its default: a reference of
    ``ASYNC_CLI_COMMITS`` commits in this process (an evaluation, a
    checkpoint and a keep a commit; 2 + 2 ragged launches a commit;
    ``client_ledger.json``'s participation m x commits; the staleness
    histogram and the anomaly summary in the events; rows valid, health
    ``complete``), the kill drill on it (``drill``, from
    :func:`start_async_drill`: exit codes [75, 0], every keep bitwise the
    reference's) and a stream-plane run without evaluations whose rows
    carry ``overlap_efficiency`` in [0, 1]."""
    words = list(ASYNC_CLI_WORDS)
    run_dir = os.path.join(root, "async_cli")
    try:
        async_cli_runs(root, words, run_dir, qk, fa, out, lap, drill["ref"],
                       drill["ready"])
    finally:
        drill["ready"].set()
        drill["thread"].join(600)
    drills = drill["result"]
    if isinstance(drills.get("drill"), BaseException):
        raise drills["drill"]
    if "drill" not in drills:
        raise AssertionError("federation async_drill: did not finish")
    out["async_drill"] = drills["drill"]
    lap("async_drill")


def async_cli_runs(root, words, run_dir, qk, fa, out, lap, ref, ready):
    """:func:`async_cli`'s reference and stream-plane runs; the
    reference's hashes go to ``ref["want"]`` (``ready`` set)."""
    from fedtorch_tpu_torch.telemetry import read_health, validate_metrics_row
    res, launched, hashes, wall, _ = lifecycle_run(
        lifecycle_argv(root, rounds=ASYNC_CLI_COMMITS, extra=words),
        run_dir, qk, fa)
    ref["want"] = {r + 1: h for r, h in enumerate(hashes)}
    ready.set()
    C = ASYNC_CLI_COMMITS
    rows = _rows(run_dir)
    for row in rows:
        validate_metrics_row(row)
    events = _rows(run_dir, "events.jsonl")
    with open(os.path.join(run_dir, "client_ledger.json")) as f:
        ledger = json.load(f)
    hist = [e for e in events if e.get("event") == "async.staleness_hist"]
    m = int(rows[-1]["async_buffer"])
    want_launch = dict(ragged_stats=2 * C, ragged_apply=2 * C, stats=0,
                       apply=0, flash=0, flash_tc=0, flash_tf32=0)
    cli = dict(commits=res["rounds"], wall_s=wall, launches=launched,
               tree_launches=want_launch,
               commit_ms=res["timer"]["round"] / C * 1e3,
               buffer=m, ledger_rounds=ledger["rounds"],
               ledger_participation=sum(
                   ledger["counters"]["participation"]),
               staleness_histogram=hist[-1]["hist"] if hist else None,
               staleness=[r["staleness"] for r in rows],
               anomaly_events=sum(e.get("event") == "anomaly.detected"
                                  for e in events),
               health=read_health(run_dir)["intent"])
    log(f"federation async_cli: {cli}")
    if launched != want_launch or res["rounds"] != C \
            or cli["ledger_participation"] != m * C \
            or ledger["rounds"] != C or not hist \
            or sum(hist[-1]["hist"].values()) != m * C \
            or cli["health"] != "complete" \
            or not any(e.get("event") == "anomaly.summary" for e in events):
        raise AssertionError(f"federation async_cli: {cli}")
    out["async_cli"] = cli
    lap("async_cli")
    stream_dir = os.path.join(root, "async_cli_stream")
    res, launched, _, wall, _ = lifecycle_run(
        lifecycle_argv(root, rounds=ASYNC_CLI_STREAM_COMMITS,
                       extra=words + ["--data_plane", "stream",
                                      "--eval_freq", "1000"]),
        stream_dir, qk, fa)
    effs = [r.get("overlap_efficiency") for r in _rows(stream_dir)]
    S = ASYNC_CLI_STREAM_COMMITS
    stream = dict(commits=res["rounds"], launches=launched,
                  tree_launches={k: v // C * S
                                 for k, v in want_launch.items()},
                  commit_ms=res["timer"]["round"] / S * 1e3,
                  overlap_efficiency=effs, wall_s=wall)
    log(f"federation async_cli_stream: {stream}")
    if launched != stream["tree_launches"] or effs[0] is not None \
            or not all(e is not None and 0.0 <= e <= 1.0
                       for e in effs[1:]):
        raise AssertionError(f"federation async_cli_stream: {stream}")
    out["async_cli_stream"] = stream


def federation_phase(seed, tcfg, define_model, make_algorithm,
                     stack_partitions, FederatedTrainer,
                     AsyncFederatedTrainer, os_mod, qk, fa, root, drill):
    """The federation plane's observers and the async commit plane on
    the main path's round (quantized FedAvg, ResNet-20, bf16, 100
    clients, batch 50, 10 local steps), cuDNN deterministic:

    * ``cohort_stats_off`` / ``cohort_stats_on`` (:func:`cohort_path`):
      params and generator state bitwise after their rounds, the same
      synchronizing CUDA calls in round index 1's body; then a float32
      cut round under ``krum`` card vs CPU (:func:`krum_card_vs_cpu`);
    * ``async_device`` / ``async_stream``: ``async_resnet20``
      (``ASYNC_FED``, ``ASYNC_FAULT``; :func:`async_path`), the stream
      plane's params, ring and generator bitwise the device plane's;
      ``async_trace`` (``ASYNC_TRACE``, ``ASYNC_TRACE_COMMITS`` commits);
    * ``async_card_vs_cpu`` (:func:`async_card_vs_cpu`);
    * ``async_cli``, ``async_drill``, ``async_cli_stream``
      (:func:`async_cli`) from the CIFAR-10 files in ``root``; the drill
      (``drill``, from :func:`start_async_drill`) was started beside the
      lifecycle phase's untimed runs, so that nothing runs beside this
      phase's timed rounds and commits, and its keeps are held here to
      the reference's;
    within ``FEDERATION_BUDGET_S``."""
    t_phase = time.perf_counter()
    out = {"paths": {}, "laps_s": {}}

    def lap(name):
        out["laps_s"][name] = time.perf_counter() - t_phase
        log(f"federation: {name} done at {out['laps_s'][name]:.1f} s")
    base = path_config(tcfg, "resnet20")
    data = path_data(base, seed, stack_partitions)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    finals = {}
    try:
        for name, cohort in (("cohort_stats_off", False),
                             ("cohort_stats_on", True)):
            out["paths"][name], *finals[name] = cohort_path(
                name, federation_config(tcfg, cohort=cohort), data, seed,
                define_model, make_algorithm, FederatedTrainer, qk, fa)
        lap("cohort_stats")
        (p_off, r_off), (p_on, r_on) = finals["cohort_stats_off"], \
            finals["cohort_stats_on"]
        w_off = out["paths"]["cohort_stats_off"]["round_index_1"]
        w_on = out["paths"]["cohort_stats_on"]["round_index_1"]
        gap = _params_gap(p_on, p_off)
        same_rng = bool(torch.equal(r_on, r_off))
        out["cohort_bitwise"] = dict(max_abs_gap=gap,
                                     rng_state_equal=same_rng,
                                     syncs_off=w_off["syncs"],
                                     syncs_on=w_on["syncs"])
        if gap != 0.0 or not same_rng or w_off["syncs"] != w_on["syncs"]:
            raise AssertionError(f"federation cohort stats on vs off: "
                                 f"{out['cohort_bitwise']}")
        for name, plane, fault, timed in (
                ("async_device", "device", ASYNC_FAULT,
                 ASYNC_TIMED_COMMITS),
                ("async_stream", "stream", ASYNC_FAULT,
                 ASYNC_TIMED_COMMITS),
                ("async_trace", "device", ASYNC_TRACE,
                 ASYNC_TRACE_COMMITS - 1)):
            out["paths"][name], *finals[name] = async_path(
                name, federation_config(tcfg, fed=ASYNC_FED, fault=fault,
                                        cohort=True, plane=plane),
                data, seed, define_model, make_algorithm,
                AsyncFederatedTrainer, qk, fa, timed=timed,
                profile=name != "async_trace")
        lap("async")
        (dp, dring, dr), (sp, sring, sr) = finals["async_device"], \
            finals["async_stream"]
        gaps = (_params_gap(sp, dp), _params_gap(sring, dring))
        same_rng = bool(torch.equal(sr, dr))
        out["async_stream_bitwise"] = dict(
            params_max_abs_gap=gaps[0], ring_max_abs_gap=gaps[1],
            rng_state_equal=same_rng)
        if gaps != (0.0, 0.0) or not same_rng:
            raise AssertionError(f"federation async_stream vs async_device: "
                                 f"{out['async_stream_bitwise']}")
        sync_ms = statistics.mean(out["paths"][n]["round_ms"] for n in (
            "cohort_stats_off", "cohort_stats_on"))
        for n in ("async_device", "async_stream"):
            p = out["paths"][n]
            p["commit_ms_over_sync_round"] = p["commit_ms"] / sync_ms
        tf32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out["krum_card_vs_cpu"] = krum_card_vs_cpu(
                cut_config(federation_config(
                    tcfg, fault=dict(robust_agg="krum",
                                     robust_trim_frac=0.2),
                    cohort=True, dtype="float32"),
                    num_clients=8, online_client_rate=0.5, local_step=2),
                data, seed, os_mod)
            out["async_card_vs_cpu"] = async_card_vs_cpu(
                cut_config(federation_config(
                    tcfg, fed=ASYNC_FED, fault=ASYNC_FAULT, cohort=True,
                    dtype="float32"), **ASYNC_CUT),
                data, seed, os_mod, AsyncFederatedTrainer, define_model,
                make_algorithm)
        finally:
            torch.backends.cudnn.allow_tf32, \
                torch.backends.cuda.matmul.allow_tf32 = tf32
        lap("card_vs_cpu")
        del data
        gc.collect()
        torch.cuda.empty_cache()
        async_cli(root, seed, qk, fa, out, lap, drill)
    finally:
        drill["ready"].set()
        drill["thread"].join(600)
        torch.backends.cudnn.deterministic = deterministic
    out.update(sync_round_ms=sync_ms, cudnn_deterministic=True,
               phase_s=time.perf_counter() - t_phase,
               budget_s=FEDERATION_BUDGET_S, async_fed=ASYNC_FED,
               async_fault=ASYNC_FAULT, async_trace=ASYNC_TRACE)
    log(f"federation phase: {out['phase_s']:.1f} s; sync round "
        f"{sync_ms:.1f} ms; commit ms "
        + ", ".join(f"{n} {out['paths'][n]['commit_ms']:.1f} "
                    f"({out['paths'][n]['commit_ms_over_sync_round']:.3f}x)"
                    for n in ("async_device", "async_stream")))
    if out["phase_s"] > FEDERATION_BUDGET_S:
        log(json.dumps(out))
        raise AssertionError(f"federation phase took {out['phase_s']:.1f} "
                             f"s, over its {FEDERATION_BUDGET_S} s budget")
    return out


def with_fusion(cfg, execution, **fed):
    """``cfg`` with ``client_fusion=execution`` and the federated fields
    ``fed``."""
    return dataclasses.replace(
        cfg, mesh=dataclasses.replace(cfg.mesh, client_fusion=execution),
        federated=dataclasses.replace(cfg.federated, **fed)).finalize()


def _ragged_round(qk, fa, fn, what):
    """``fn()`` (one round) with the counters set to 0 just before: its
    result, after checking 2 + 2 ragged launches and no other kernel."""
    reset_counters(qk, fa)
    out = fn()
    launched = counters(qk, fa)
    want = dict(ragged_stats=2, ragged_apply=2, stats=0, apply=0, flash=0,
                flash_tc=0, flash_tf32=0)
    if launched != want:
        raise AssertionError(f"fusion {what}: kernels launched {launched} "
                             f"in a round, expected {want}")
    return out


def fusion_cell(seed, tcfg, define_model, make_algorithm, stack_partitions,
                FederatedTrainer, qk, fa):
    """The ResNet-20 north-star cell (quantized, bf16, 100 clients, k =
    10, batch 50, 10 steps, flip and crop) on ``client_fusion='fused'``
    and on ``'vmap'``, both trainers from one seed (so every round trains
    the same cohort on the same rows): a warm-up round each (the fused
    uplink stack held to the plain version), ``FUSION_TIMED_ROUNDS``
    timed rounds each in alternation (fused, vmap, vmap, fused, ...),
    every round 2 + 2 ragged launches; then per path the device memory a
    round adds over the resident state, round index 3's synchronizing
    CUDA calls (``run_round`` + the loop's one fetch) and one profiled
    round (busy share, launches a local step)."""
    base = path_config(tcfg, "resnet20")
    data = path_data(base, seed, stack_partitions)
    paths = {}
    for ex in ("fused", "vmap"):
        cfg = with_fusion(base, ex)
        t = FederatedTrainer(cfg, define_model(cfg, batch_size=BATCH),
                             make_algorithm(cfg), data)
        if t.client_fusion != ex:
            raise AssertionError(f"fusion: {ex} resolved {t.client_fusion}")
        paths[ex] = [t, *t.init_state(seed)]
    del data
    calls = []
    t, server, clients = paths["fused"]
    undo = _record_uplink(t, calls, [])
    for ex in ("fused", "vmap"):
        t, server, clients = paths[ex]
        server, clients, _ = _ragged_round(
            qk, fa, lambda: t.run_round(server, clients), f"{ex} warm-up")
        torch.cuda.synchronize()
        paths[ex][1:] = server, clients
        if ex == "fused":
            undo()
    held = _hold_uplink(qk, "fusion fused", *calls[0])
    del calls
    round_ms = {"fused": [], "vmap": []}
    order = []
    for i in range(FUSION_TIMED_ROUNDS):
        order += ["fused", "vmap"] if i % 2 == 0 else ["vmap", "fused"]
    for ex in order:
        t, server, clients = paths[ex]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        server, clients, m = _ragged_round(
            qk, fa, lambda: t.run_round(server, clients), ex)
        end.record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(m.train_loss).all()):
            raise AssertionError(f"fusion {ex}: losses {m.train_loss}")
        round_ms[ex].append(start.elapsed_time(end))
        paths[ex][1:] = server, clients
    out = {}
    del m
    for ex in ("fused", "vmap"):
        t, server, clients = paths[ex]
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def body():
            s, c, mm = t.run_round(server, clients)
            return s, c, mm, t.round_host_scalars(c, mm)
        from fedtorch_tpu_torch.utils.tracing import watch
        (server, clients, m, sc), watched = watch(body)
        peak = torch.cuda.max_memory_allocated()
        log_sync_sites(f"fusion {ex}: round index 3 (run_round and its one "
                       "fetch)", watched)
        prof = profile_phase(t, server, clients, dict(
            ragged_stats=2, ragged_apply=2, stats=0, apply=0))
        per_step = prof["kernel_launches"] / (t.k_online * t.local_steps)
        counted = dict(ragged_stats=2 * (1 + FUSION_TIMED_ROUNDS),
                       ragged_apply=2 * (1 + FUSION_TIMED_ROUNDS), stats=0,
                       apply=0, flash=0, flash_tc=0, flash_tf32=0)
        out[ex] = dict(round_ms=round_ms[ex],
                       mean_round_ms=statistics.mean(round_ms[ex]),
                       launches=counted, tree_launches=counted,
                       round_peak_over_resident_mib=(peak - resident)
                       / 2**20, resident_mib=resident / 2**20,
                       round_index_3=watched, profile=prof,
                       launches_per_local_step=per_step,
                       mean_loss_last=sc["loss_sum"] / sc["n_online"])
        log(f"fusion {ex}: rounds {round_ms[ex]} ms, a round adds "
            f"{out[ex]['round_peak_over_resident_mib']:.0f} MiB over "
            f"{resident / 2**20:.0f} resident, round index 3 {watched}, "
            f"{per_step:.1f} launches a local step, busy "
            f"{prof['busy_share']}")
        paths[ex][1:] = server, clients
    for ex in ("fused", "vmap"):
        paths[ex][0].close()
    del paths
    out.update(order=order, uplink_vs_plain=held,
               fused_over_vmap=out["fused"]["mean_round_ms"]
               / out["vmap"]["mean_round_ms"])
    return out


def fusion_card_vs_cpu(name, cfg, seed, os_mod, data=None):
    """``cfg``'s fused round in float32 (TF32 off) on the card against the
    same round on the CPU and against the card's own vmap round: each
    update within the larger of ``TASK_CARD_FLOOR`` and
    ``SPREAD_FACTOR`` times the CPU's order spread over
    ``FUSION_CUT_ORDERS`` measured here, and (``with_metrics``) each
    run's step counts and fault counters equal."""
    vmap = with_fusion(cfg, "vmap")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {run: os_mod.run_round(cfg, seed, run, data=data,
                                      with_metrics=True)
                for run in ("cpu", *FUSION_CUT_ORDERS, "cuda")}
        runs["cuda-vmap"] = os_mod.run_round(vmap, seed, "cuda", data=data,
                                             with_metrics=True)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    counts = {run: fault_counts(r[2]) for run, r in runs.items()}
    if any(c != counts["cpu"] for c in counts.values()):
        raise AssertionError(f"fusion {name}: counts {counts}")
    ups = {run: r[0] for run, r in runs.items()}
    f = os_mod.SPREAD_FACTOR
    gaps = [os_mod.update_gap(ups["cpu"], ups[o]) for o in FUSION_CUT_ORDERS]
    s_l2 = max(g[1] for g in gaps)
    bar_l2 = max(TASK_CARD_FLOOR, f * s_l2)
    steps, l2 = os_mod.update_gap(ups["cpu"], ups["cuda"])
    v_steps, v_l2 = os_mod.update_gap(ups["cuda-vmap"], ups["cuda"])
    out = dict(update_rel_l2=l2, update_steps=steps, vs_vmap_rel_l2=v_l2,
               vs_vmap_steps=v_steps, spread_rel_l2=s_l2,
               spread_steps=max(g[0] for g in gaps), bar_rel_l2=bar_l2,
               orders=list(FUSION_CUT_ORDERS), counts=counts["cuda"])
    log(f"fusion {name} (float32, {cfg.federated.num_clients} clients, "
        f"{cfg.train.local_step} steps): card vs CPU relative L2 {l2:.3e}, "
        f"card fused vs card vmap {v_l2:.3e} (bar {bar_l2:.3e}; CPU order "
        f"spread {s_l2:.3e}); counts {counts['cuda']}")
    if l2 > bar_l2 or v_l2 > bar_l2:
        raise AssertionError(f"fusion {name}: {out}")
    return out


def fusion_scaffold(seed, tcfg, define_model, make_algorithm,
                    stack_partitions, FederatedTrainer, os_mod):
    """SCAFFOLD under epoch sync with stragglers on the ResNet-20 cell
    (plain local SGD), one round fused and one vmap from one seed (the
    same cohort, rows and straggler cuts), in bf16 and in float32 (TF32
    off): the same clients freeze after the same steps (each dispatched
    client's local index and epoch equal), the same straggler count (at
    least one), finite state. At this size a round's update moves far
    under any change of float order (the batch-statistics norms of
    channels that are nearly constant at init amplify a last-bit change
    about a thousandfold a step), so the update fused vs vmap is held to
    what another order moves the vmap round: within the larger of
    ``TASK_CARD_FLOOR`` and ``SPREAD_FACTOR`` times its float32 vmap
    round in NCHW memory against the same round (and in bf16 also its
    bf16 round against its float32 one)."""
    base = path_config(tcfg, "resnet20")
    base = dataclasses.replace(
        base, optim=dataclasses.replace(base.optim, in_momentum=False),
        fault=tcfg.FaultConfig(**FUSION_STRAGGLERS))
    data = path_data(base, seed, stack_partitions)
    res = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    runs = [("bfloat16", "fused"), ("bfloat16", "vmap"), ("float32", "fused"),
            ("float32", "vmap"), ("float32", "vmap-nchw")]
    try:
        for dtype, ex in runs:
            torch.backends.cudnn.allow_tf32 = \
                torch.backends.cuda.matmul.allow_tf32 = dtype == "bfloat16"
            cfg = with_fusion(base, ex.split("-")[0], **FUSION_SCAFFOLD)
            cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
                cfg.mesh, compute_dtype=dtype)).finalize()
            model = define_model(cfg, batch_size=BATCH)
            if ex.endswith("nchw"):
                # another float32 order on the card: NCHW memory inside
                model.module.register_forward_pre_hook(os_mod._nchw_inside)
            t = FederatedTrainer(cfg, model, make_algorithm(cfg), data)
            server, clients = t.init_state(seed)
            p0 = {k: v.clone() for k, v in server.params.items()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            server, clients, m = t.run_round(server, clients)
            end.record()
            torch.cuda.synchronize()
            on = m.online_mask.bool()
            res[dtype, ex] = dict(
                ms=start.elapsed_time(end), steps=t.local_steps,
                stragglers=float(m.straggler_clients),
                local_index=clients.local_index[on].tolist(),
                epoch=clients.epoch[on].tolist(),
                update=torch.cat([(server.params[k] - p0[k]).float()
                                  .flatten() for k in p0]),
                finite=all(bool(torch.isfinite(v).all()) for v in
                           list(server.params.values())
                           + list(server.aux["control"].values())))
            t.close()
            del t, server, clients, model
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    del data

    def rel(a, b):
        return float((res[a]["update"] - res[b]["update"]).norm()
                     / res[b]["update"].norm())
    order = rel(("float32", "vmap-nchw"), ("float32", "vmap"))
    rounding = rel(("bfloat16", "vmap"), ("float32", "vmap"))
    gaps = {d: rel((d, "fused"), (d, "vmap")) for d in ("bfloat16",
                                                         "float32")}
    factor = os_mod.SPREAD_FACTOR
    bars = dict(float32=max(TASK_CARD_FLOOR, factor * order),
                bfloat16=max(TASK_CARD_FLOOR,
                              factor * max(order, rounding)))
    f = res["bfloat16", "fused"]
    frozen = sum(1 for li in f["local_index"] if li < f["steps"])
    out = dict(steps=f["steps"], stragglers=f["stragglers"],
               frozen_clients=frozen, local_index=f["local_index"],
               ms={f"{d}_{e}": r["ms"] for (d, e), r in res.items()},
               update_rel_l2_fused_vs_vmap=gaps,
               nchw_order_rel_l2=order, bf16_rounding_rel_l2=rounding,
               bar_rel_l2=bars)
    log(f"fusion scaffold (epoch sync, stragglers): {frozen} of "
        f"{len(f['local_index'])} clients frozen before step {f['steps']} "
        f"({f['local_index']}), the same on every run; ms {out['ms']}; "
        f"update fused vs vmap relative L2 {gaps} (bars {bars}; the vmap "
        f"round moves {order:.3e} in NCHW memory, {rounding:.3e} in bf16)")
    same = all(r[k] == f[k] for r in res.values()
               for k in ("local_index", "epoch", "stragglers"))
    if not same or not frozen or not all(r["finite"] for r in res.values()) \
            or any(gaps[d] > bars[d] for d in gaps):
        raise AssertionError(f"fusion scaffold: {out}; " + str(
            [(k, r["local_index"], r["stragglers"])
             for k, r in res.items()]))
    return out


def fusion_cnn(seed, tcfg, define_model, make_algorithm, stack_partitions,
               FederatedTrainer, qk, fa):
    """The ``cnn_cifar`` task (bf16, int8 both ways, 100 clients, k = 10)
    fused: a warm-up and a timed round, each 2 + 2 ragged and 2 + 2 tiled
    launches (its 640,000-element ``Dense_0`` takes the tiled pair)."""
    cfg = with_fusion(task_config(tcfg, "cnn", "cifar10", "bfloat16", 100,
                                  dict(algorithm="fedavg")), "fused")
    data = task_data(cfg, seed, stack_partitions)[0]
    t = FederatedTrainer(cfg, define_model(cfg, batch_size=BATCH),
                         make_algorithm(cfg), data)
    server, clients = t.init_state(seed)
    per = launches_per_round(qk, [v.numel() for v in server.params.values()])
    per.update(flash=0, flash_tc=0, flash_tf32=0)
    reset_counters(qk, fa)
    server, clients, _ = t.run_round(server, clients)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    server, clients, m = t.run_round(server, clients)
    end.record()
    torch.cuda.synchronize()
    launched = counters(qk, fa)
    want = {c: 2 * n for c, n in per.items()}
    if launched != want or per["stats"] != 2 \
            or not bool(torch.isfinite(m.train_loss).all()):
        raise AssertionError(f"fusion cnn_cifar: launched {launched}, "
                             f"expected {want}; losses {m.train_loss}")
    out = dict(round_ms=start.elapsed_time(end), launches=launched,
               tree_launches=want,
               launches_per_round={c: n / 2 for c, n in launched.items()})
    log(f"fusion cnn_cifar: {out['round_ms']:.1f} ms/round, launches per "
        f"round {out['launches_per_round']}")
    t.close()
    return out


def fusion_remat(seed, tcfg, define_model, make_algorithm,
                 stack_partitions, FederatedTrainer):
    """WideResNet-28-10 (quantized, bf16, batch 50, 10 steps) with remat
    off and on, on a population cut to ``FUSION_WRN_CLIENTS`` clients all
    online, cuDNN deterministic: a warm-up round,
    then one round each: its ms, the device memory it adds over the
    resident state, and the server params after it bitwise the same."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {}
    try:
        for remat in (False, True):
            cfg = path_config(tcfg, "wideresnet28", 10)
            cfg = dataclasses.replace(
                cfg, mesh=dataclasses.replace(cfg.mesh, remat=remat),
                federated=dataclasses.replace(
                    cfg.federated, num_clients=FUSION_WRN_CLIENTS,
                    online_client_rate=1.0)).finalize()
            rng = np.random.RandomState(seed)
            n = FUSION_WRN_CLIENTS * SAMPLES
            data = stack_partitions(
                rng.randn(n, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, n),
                [np.arange(i * SAMPLES, (i + 1) * SAMPLES)
                 for i in range(FUSION_WRN_CLIENTS)])
            model = define_model(cfg, batch_size=BATCH)
            t = FederatedTrainer(cfg, model, make_algorithm(cfg), data)
            del data
            server, clients = t.init_state(seed)
            server, clients, _ = t.run_round(server, clients)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            server, clients, _ = t.run_round(server, clients)
            end.record()
            torch.cuda.synchronize()
            round_peak = torch.cuda.max_memory_allocated() - resident
            # one client step's forward and backward alone (a batch of
            # 50 through the server params): the activations remat trades
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in server.params.items()}
            x = t.data.x[0, :BATCH]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = model.apply(leaves, x, train=True).float().square().mean()
            torch.autograd.grad(loss, list(leaves.values()))
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated() - before
            del leaves, loss
            res[remat] = dict(
                ms=start.elapsed_time(end),
                peak_over_resident_mib=round_peak / 2**20,
                step_peak_mib=step_peak / 2**20,
                resident_mib=resident / 2**20, remat=model.module.remat,
                params={k: v.detach().clone()
                        for k, v in server.params.items()})
            t.close()
            del t, server, clients, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    off, on = res[False], res[True]
    bitwise = all(torch.equal(off["params"][k], on["params"][k])
                  for k in off["params"])
    out = {("remat_on" if r else "remat_off"): {
        k: v for k, v in res[r].items() if k != "params"} for r in res}
    out.update(params_bitwise=bitwise, clients=FUSION_WRN_CLIENTS,
               cudnn_deterministic=True,
               ms_ratio=on["ms"] / off["ms"],
               round_peak_ratio=on["peak_over_resident_mib"]
               / off["peak_over_resident_mib"],
               step_peak_ratio=on["step_peak_mib"] / off["step_peak_mib"])
    log(f"fusion remat (WideResNet-28-10, {FUSION_WRN_CLIENTS} clients): "
        f"off {off['ms']:.1f} ms, a round +{off['peak_over_resident_mib']:.0f}"
        f" MiB, a step +{off['step_peak_mib']:.0f} MiB; on {on['ms']:.1f} "
        f"ms, +{on['peak_over_resident_mib']:.0f} MiB, a step "
        f"+{on['step_peak_mib']:.0f} MiB; params bitwise {bitwise}")
    if not bitwise or not on["remat"] or off["remat"] \
            or not on["step_peak_mib"] < off["step_peak_mib"]:
        raise AssertionError(f"fusion remat: {out}")
    return out


def fusion_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
                 FederatedTrainer, os_mod, qk, fa, cli_fused):
    """Client fusion and remat: ``fusion_cell`` (fused vs vmap
    on the ResNet-20 cell), the cell's float32 cut card vs CPU and fused
    vs vmap (``fusion_card_vs_cpu``), SCAFFOLD's epoch-sync freeze and its
    cut, the fused ``cnn_cifar`` with its tiled pair, the CLI's fused
    run (``cli_fused``, run in the cli phase on its CIFAR files) and
    WideResNet-28-10 with remat off and on; within
    ``FUSION_BUDGET_S``."""
    t_phase = time.perf_counter()
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - t_phase
    cell = fusion_cell(seed, tcfg, define_model, make_algorithm,
                       stack_partitions, FederatedTrainer, qk, fa)
    lap("cell")
    gc.collect()
    torch.cuda.empty_cache()
    cut = cut_config(with_fusion(path_config(tcfg, "resnet20",
                                             dtype="float32"), "fused"),
                     **TASK_CARD_CUT)
    cut_out = fusion_card_vs_cpu("resnet20_cut", cut, seed, os_mod)
    # the SCAFFOLD cut at batch 8: 16 rows a client, 2 steps, a straggler
    # frozen after 1
    scut = with_fusion(cut, "fused", **FUSION_SCAFFOLD)
    scut = dataclasses.replace(
        scut, data=dataclasses.replace(scut.data, batch_size=8),
        optim=dataclasses.replace(scut.optim, in_momentum=False),
        fault=tcfg.FaultConfig(**FUSION_STRAGGLERS)).finalize()
    scut_out = fusion_card_vs_cpu("scaffold_cut", scut, seed, os_mod)
    lap("card_vs_cpu")
    scaffold = fusion_scaffold(seed, tcfg, define_model, make_algorithm,
                               stack_partitions, FederatedTrainer, os_mod)
    lap("scaffold")
    gc.collect()
    torch.cuda.empty_cache()
    cnn = fusion_cnn(seed, tcfg, define_model, make_algorithm,
                     stack_partitions, FederatedTrainer, qk, fa)
    lap("cnn")
    gc.collect()
    torch.cuda.empty_cache()
    remat = fusion_remat(seed, tcfg, define_model, make_algorithm,
                         stack_partitions, FederatedTrainer)
    lap("remat")
    out = dict(cell=cell, cut=cut_out, scaffold_cut=scut_out,
               scaffold=scaffold, cnn_cifar=cnn, cli=cli_fused, remat=remat,
               laps_s=laps, phase_s=time.perf_counter() - t_phase,
               budget_s=FUSION_BUDGET_S)
    log(f"fusion phase: {out['phase_s']:.1f} s ({laps}); fused/vmap round "
        f"{cell['fused_over_vmap']:.3f}; launches a local step fused "
        f"{cell['fused']['launches_per_local_step']:.1f}, vmap "
        f"{cell['vmap']['launches_per_local_step']:.1f}")
    if out["phase_s"] > FUSION_BUDGET_S:
        raise AssertionError(f"fusion phase took {out['phase_s']:.1f} s, "
                             f"over its {FUSION_BUDGET_S} s budget")
    return out


def lm_eval_step(trainer, server, seed, qk, fa):
    """``evaluate`` of the transformer path's server params on
    ``LM_EVAL_WINDOWS`` windows of 2048 characters made from ``seed``, at
    batch ``LM_BATCH``: one tensor-core flash launch per layer and batch
    (the counters set to 0 just before), no saved tensors under
    inference mode; then the same evaluation through the plain flash
    version on the card, whose loss it must match within
    ``LM_EVAL_LOSS_BAR``."""
    from fedtorch_tpu_torch.parallel.evaluate import evaluate
    cfg = trainer.cfg
    T = cfg.model.rnn_seq_len
    stream = np.random.RandomState(seed + 1).randint(
        0, cfg.model.vocab_size, LM_EVAL_WINDOWS * T + 1).astype(np.int32)
    x, y = stream[:-1].reshape(-1, T), stream[1:].reshape(-1, T)
    reset_counters(qk, fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [float(v) for v in evaluate(trainer.model, server.params, x, y,
                                      batch_size=LM_BATCH)]
    eval_ms = (time.perf_counter() - t0) * 1e3
    launched = counters(qk, fa)
    batches = -(-LM_EVAL_WINDOWS // LM_BATCH)
    want = dict(ragged_stats=0, ragged_apply=0, stats=0, apply=0,
                flash=cfg.model.mlp_num_layers * batches, flash_tf32=0)
    want["flash_tc"] = want["flash"]
    if launched != want:
        raise AssertionError(f"transformer evaluate launched {launched}, "
                             f"expected {want}")
    kernel_fwd = fa.flash_fwd
    fa.flash_fwd = fa.flash_fwd_ref  # the plain version, on the card
    try:
        plain = [float(v) for v in evaluate(trainer.model, server.params,
                                            x, y, batch_size=LM_BATCH)]
    finally:
        fa.flash_fwd = kernel_fwd
    rel = abs(got[0] - plain[0]) / abs(plain[0])
    log(f"transformer evaluate ({LM_EVAL_WINDOWS} windows of {T}, batch "
        f"{LM_BATCH}): {eval_ms:.1f} ms, launches {launched}; loss "
        f"{got[0]:.6f}, plain flash {plain[0]:.6f} (relative {rel:.3e}, bar "
        f"{LM_EVAL_LOSS_BAR:.3e}); top-1 {got[1]:.4f} vs {plain[1]:.4f}")
    if not math.isfinite(got[0]) or rel > LM_EVAL_LOSS_BAR:
        raise AssertionError(f"transformer evaluate {got} vs plain {plain}")
    return dict(windows=LM_EVAL_WINDOWS, batch=LM_BATCH, eval_ms=eval_ms,
                launches=launched, loss=got[0], top1=got[1], top5=got[2],
                plain_loss=plain[0], plain_top1=plain[1],
                loss_rel_diff=rel, bar=LM_EVAL_LOSS_BAR)


def profile_phase(trainer, server, clients, launched: dict,
                  commit: bool = False, log_dir=None):
    """One more main-path round under torch.profiler: the device's busy
    share of the round and where its time goes, attributed by
    ``tools/trace_attrib.py`` (its categories, >= 95% attributed or the
    phase fails, its hand-kernel rows and PERF.md's E/M/N/F/Q columns)
    from the per-name sums of the raw records (``attribute_sums``: three
    reads a record; kernels on a stream do not nest). The profiler's own
    host cost lengthens the round, so the busy share is a lower bound.
    Only CUDA activity is traced (kernels and the runtime calls that
    launch them): operator-level host events would multiply the events,
    and the time to process them, several times over. With ``log_dir``
    the round is ``capture_round_trace``'s: its Chrome trace is written
    there and attributed from the file too, held to the sums.

    The profiler can lose the records of a round's last kernels (one run
    lost the last ~16% of a ResNet-20 round's, the quantizer's among
    them), and the quantizer runs at the end of the round; others lost
    a transformer round's first flash record. So a profile
    must hold as many quantizer and flash kernels as ``launched`` (a
    round's launches per kernel) says the round made; otherwise another
    round is profiled, up to ``PROFILE_TRIES`` in all, and the last is
    returned with ``records_complete`` false."""
    want = round(sum(launched[c] for c in ("ragged_stats", "ragged_apply",
                                           "stats", "apply")))
    want_flash = round(launched.get("flash", 0))
    for attempt in range(1, PROFILE_TRIES + 1):
        out = _profile_round(trainer, server, clients, commit, log_dir)
        got = sum(q["calls"] for q in out["quantizer_kernels"])
        flash = sum(out["hand_kernels"].get(r, {}).get("launches", 0)
                    for r in ("flash_fwd_tc", "flash_fwd_tf32"))
        complete = got == want and flash == want_flash
        out.update(attempt=attempt, quantizer_calls=got,
                   quantizer_launches=want, flash_calls=flash,
                   flash_launches=want_flash, records_complete=complete)
        if complete:
            break
        log(f"the profile holds {got} of the round's {want} quantizer and "
            f"{flash} of its {want_flash} flash launches: records lost "
            f"(attempt {attempt})")
    return out


def _profile_round(trainer, server, clients, commit=False, log_dir=None):
    """One round (``commit``: one async commit, whose plane has no scan
    dispatch) in a ``utils.tracing.profile_window``, attributed in
    memory (the raw kineto records; ``key_averages()`` took 133 s for
    DenseNet-BC-100's 462,561 launches)."""
    from fedtorch_tpu_torch.tools import trace_attrib
    from fedtorch_tpu_torch.utils.tracing import profile_window
    wall = []

    def one():
        t0 = time.perf_counter()
        if commit:
            res = trainer.run_round(server, clients)
        else:
            res = trainer.run_rounds(server, clients, 1)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        return res
    _, window = profile_window(one, log_dir=log_dir)
    t0 = time.perf_counter()
    doc = trace_attrib.attribute_sums(window)
    out = trace_attrib.summary(doc, wall[0], window)
    out["attribution"]["attribute_s"] = time.perf_counter() - t0
    out["quantizer_kernels"] = [
        dict(name=r, ms=v["ms"], calls=v["launches"])
        for r, v in out["hand_kernels"].items() if r.startswith("qdq_")]
    busy = out["device_ms"]
    if not busy:
        raise AssertionError("a profiled round with no device time")
    log(f"profiled round: {wall[0]:.1f} ms wall, device busy {busy:.1f} ms "
        f"({100 * busy / wall[0]:.1f}%), {out['kernel_launches']} device "
        f"records, attributed {100 * doc['attributed_frac']:.2f}% "
        f"({out['attribution']['attribute_s']:.1f} s), columns "
        f"{out['device_ms_by_column']}")
    if not doc["attributed_ok"]:
        raise AssertionError(f"trace_attrib attributes "
                             f"{doc['attributed_frac']} of the round, under "
                             f"the 95% invariant: {doc.get('other_ops')}")
    if log_dir is not None:
        # the file entry on the trace capture_round_trace wrote: its
        # records summed as read are the in-memory sums' (within 1%); its
        # self-time split takes out the overlap of a stream's kernels
        t0 = time.perf_counter()
        disk = trace_attrib.attribute(log_dir)
        disk_ms = trace_attrib.device_ms(disk)
        raw = trace_attrib.event_sums(log_dir).values()
        summed_ms = sum(ms for ms, _ in raw)
        out["file_attribution"] = dict(
            trace_files=len(disk["trace_files"]),
            attributed_frac=disk["attributed_frac"],
            summed_ms=summed_ms, records=sum(n for _, n in raw),
            summed_over_in_memory=summed_ms / busy,
            self_time_ms=disk_ms, self_time_over_summed=disk_ms / summed_ms,
            hand_kernels=disk["hand_kernels"],
            attribute_s=time.perf_counter() - t0)
        log(f"its trace file attributed: {out['file_attribution']}")
        launches = {r: v["launches"] for r, v in disk["hand_kernels"].items()}
        if not disk["attributed_ok"] or abs(summed_ms / busy - 1) > 0.01 \
                or launches != {r: v["launches"]
                                for r, v in out["hand_kernels"].items()}:
            raise AssertionError(f"the trace file's attribution "
                                 f"{out['file_attribution']} against the "
                                 f"in-memory one ({out['hand_kernels']})")
    return out


def _moe_routes(model, params, toks):
    """``{block_<i>: sel}``: each MoE block's routed expert per token, from
    its input through ``moe_route``."""
    from fedtorch_tpu_torch.models.transformer import moe_route
    routes, hooks = {}, []
    for i in range(model.module.num_layers):
        moe = getattr(model.module, f"block_{i}").moe

        def hook(mod, args, _i=i):
            routes[f"block_{_i}"] = moe_route(args[0],
                                              mod.gate.kernel)[2].cpu()
        hooks.append(moe.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            model.apply(params, toks)
    finally:
        for h in hooks:
            h.remove()
    return routes


def moe_cut_card_vs_cpu(seed, tcfg, define_model, stack_partitions, os_mod,
                        qk, capacity_factor):
    """The MoE cell cut (``MOE_CUT``: T 128, 4 experts, 2 clients, 2
    steps, float32, TF32 off) card vs CPU at ``capacity_factor``: the
    round held as a tasks path's cut (``task_card_vs_cpu``: the update
    within ``SPREAD_FACTOR`` times the CPU orders' spread, never tighter
    than ``TASK_CARD_FLOOR``), and the tokens of the first batch that
    route to another expert on the card than on the CPU, from the same
    weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = path_config(tcfg, "transformer",
                      lm=dict(MOE_CUT, moe_capacity_factor=capacity_factor),
                      dtype="float32")
    cfg = cut_config(cfg, num_clients=2, online_client_rate=1.0,
                     local_step=2)
    T, per = cfg.model.rnn_seq_len, 2 * LM_BATCH
    rng = np.random.RandomState(seed)
    stream = rng.randint(0, cfg.model.vocab_size, 2 * per * T + 1)
    data = stack_partitions(stream[:-1].reshape(-1, T).astype(np.int32),
                            stream[1:].reshape(-1, T).astype(np.int32),
                            [np.arange(i * per, (i + 1) * per)
                             for i in range(2)])
    out = task_card_vs_cpu(f"moe_cut_cf{capacity_factor}", cfg, data, None,
                           seed, os_mod, qk,
                           orders=("cpu-2thread", "cpu-1thread"))
    routes = {}
    params = define_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    toks = data.x[0, :LM_BATCH].long()
    for dev in ("cpu", "cuda"):
        model = define_model(cfg, LM_BATCH, device=dev)
        routes[dev] = _moe_routes(model, {k: v.to(dev) for k, v in
                                          params.items()}, toks.to(dev))
    out["tokens_routed_otherwise"] = {
        b: int((routes["cuda"][b] != sel).sum())
        for b, sel in routes["cpu"].items()}
    out["tokens"] = int(toks.numel())
    log(f"moe cut cf {capacity_factor}: tokens routed otherwise card vs "
        f"CPU {out['tokens_routed_otherwise']} of {out['tokens']}")
    return out


def ring_blocks_check(fa):
    """The flash ring's per-step pieces over one card: q, k, v at
    ``LM_SHAPE`` (bf16: the wgmma kernel; float32: the TF32 kernel), and
    for each n of ``RING_NS`` the blocks each of n ranks would see, in
    ring order, through ``_flash_block`` (the non-causal kernel off the
    diagonal, the causal one on it, later blocks skipped) and
    ``_merge_lse``. The merged o and lse against the whole-sequence
    kernel and its plain version, and a backward through the pieces
    (``_bwd_chunked`` with each piece's nonzero lse gradient) against the
    whole-sequence backward."""
    from fedtorch_tpu_torch.parallel.sequence import _flash_block, _merge_lse
    B, T, H, D = LM_SHAPE
    scale = 1.0 / math.sqrt(D)
    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        gen = torch.Generator(device="cuda").manual_seed(11)
        q, k, v = (torch.randn(B, T, H, D, device="cuda", generator=gen)
                   .to(dtype).requires_grad_(True) for _ in range(3))
        g = torch.randn(B, T, H, D, device="cuda", generator=gen)
        o_ref, lse_ref = fa.flash_attention_with_lse(q, k, v, causal=True)
        want = torch.autograd.grad((o_ref.float() * g).sum(), (q, k, v))
        with torch.no_grad():
            o_plain, lse_plain = fa.flash_fwd_ref(q, k, v, scale, True)
        lse_plain = lse_plain.transpose(1, 2)
        top = float(o_ref.detach().float().abs().max())
        for n in RING_NS:
            rows = T // n
            pieces_o, pieces_lse = [], []
            for r in range(n):
                qr = q[:, r * rows:(r + 1) * rows]
                o = torch.zeros_like(qr)
                lse = torch.full(qr.shape[:-1], -math.inf, device="cuda")
                for s in range(n):
                    src = (r - s) % n
                    blk = slice(src * rows, (src + 1) * rows)
                    o, lse = _merge_lse(o, lse, *_flash_block(
                        qr, k[:, blk], v[:, blk], r, src, True, scale))
                pieces_o.append(o.to(dtype))
                pieces_lse.append(lse)
            o_ring = torch.cat(pieces_o, dim=1)
            lse_ring = torch.cat(pieces_lse, dim=1)
            got = torch.autograd.grad((o_ring.float() * g).sum(), (q, k, v))
            o_ring, lse_ring = o_ring.detach().float(), lse_ring.detach()
            res = dict(
                o_vs_kernel=float((o_ring - o_ref.detach().float())
                                  .abs().max()),
                o_vs_plain=float((o_ring - o_plain.float()).abs().max()),
                lse_vs_kernel=float((lse_ring - lse_ref.detach())
                                    .abs().max()),
                lse_vs_plain=float((lse_ring - lse_plain).abs().max()),
                grad_rel_l2=max(float(torch.linalg.vector_norm(
                    (a.float() - b.float())) / torch.linalg.vector_norm(
                    b.float())) for a, b in zip(got, want)))
            if name == "float32":
                o_bar = None
                ok = torch.allclose(o_ring, o_ref.detach(), rtol=2e-5,
                                    atol=2e-5) and torch.allclose(
                    o_ring, o_plain, rtol=2e-5, atol=2e-5)
            else:
                o_bar = (3 * (n - 1) + 2) * RING_BF16_SPACING * top
                ok = res["o_vs_kernel"] <= o_bar \
                    and res["o_vs_plain"] <= o_bar
            ok = ok and torch.allclose(lse_ring, lse_ref.detach(), rtol=2e-5,
                                       atol=2e-5) \
                and torch.allclose(lse_ring, lse_plain, rtol=2e-5, atol=2e-5)
            res.update(o_bar=o_bar, grad_bar=RING_GRAD_BAR[name])
            log(f"ring blocks {name} n {n}: o vs kernel "
                f"{res['o_vs_kernel']:.3e}, vs plain {res['o_vs_plain']:.3e}"
                f" (bar {o_bar if o_bar is not None else '2e-5 + 2e-5 |o|'})"
                f", lse vs kernel {res['lse_vs_kernel']:.3e}, vs plain "
                f"{res['lse_vs_plain']:.3e}; gradients relative L2 "
                f"{res['grad_rel_l2']:.3e} (bar {RING_GRAD_BAR[name]})")
            if not ok or res["grad_rel_l2"] > RING_GRAD_BAR[name]:
                raise AssertionError(f"ring blocks {name} n {n}: {res}")
            out[f"{name}_n{n}"] = res
    return out


def moe_nccl_check(tcfg, define_model):
    """The model-parallel forwards at one NCCL rank on the card (a
    ``HashStore`` group, destroyed at the end), on the MoE cell's model in
    float32 (TF32 off) at batch ``MOE_NCCL_BATCH``: ``long_context_apply``
    (ring and Ulysses, flash), ``ep_moe_apply`` (block 0's layer, both
    dispatch modes), ``tp_apply`` and ``pipeline_apply``, each against
    the module's own forward within ``MOE_NCCL_BAR`` of its scale."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.func import functional_call
    from fedtorch_tpu_torch.models.transformer import (
        MoEMLP, long_context_apply,
    )
    from fedtorch_tpu_torch.parallel import (
        ep_moe_apply, pipeline_apply, tp_apply,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = path_config(tcfg, "transformer", lm=MOE, dtype="float32")
    model = define_model(cfg, MOE_NCCL_BATCH, device="cuda")
    module = model.module
    params = {k: v.cuda() for k, v in model.init(
        torch.Generator().manual_seed(5)).items()}
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.model.vocab_size, (MOE_NCCL_BATCH, cfg.model.rnn_seq_len))
    ).cuda()
    layer = {k[len("block_0.moe."):]: v for k, v in params.items()
             if k.startswith("block_0.moe.")}
    x = torch.randn(MOE_NCCL_BATCH, cfg.model.rnn_seq_len,
                    2 * cfg.model.rnn_hidden_size, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
        with torch.no_grad():
            ref = model.apply(params, toks)
            dense_layer = MoEMLP(x.shape[-1], cfg.model.moe_experts).cuda()
            checks = {
                "long_context_ring_flash": (lambda: long_context_apply(
                    module, params, toks, mesh, strategy="ring",
                    block_impl="flash"), ref),
                "long_context_ulysses_flash": (lambda: long_context_apply(
                    module, params, toks, mesh, strategy="ulysses",
                    block_impl="flash"), ref),
                "ep_moe_sparse": (lambda: ep_moe_apply(
                    layer, x, mesh, axis_name="sp",
                    capacity_factor=cfg.model.moe_capacity_factor),
                    functional_call(module.block_0.moe, layer, (x,))[0]),
                "ep_moe_dense": (lambda: ep_moe_apply(
                    layer, x, mesh, axis_name="sp"),
                    functional_call(dense_layer, layer, (x,))[0]),
                "tp_apply": (lambda: tp_apply(module, params, toks, mesh,
                                              axis_name="sp"), ref),
                "pipeline_apply": (lambda: pipeline_apply(
                    module, params, toks, mesh, axis_name="sp",
                    num_microbatches=1), ref),
            }
            for name, (run, want) in checks.items():
                got = run()
                err = float((got - want).abs().max())
                bar = MOE_NCCL_BAR * float(want.abs().max())
                out[name] = dict(max_abs_diff=err, bar=bar)
                log(f"one NCCL rank {name}: max |diff| {err:.3e} (bar "
                    f"{bar:.3e})")
                if not err <= bar:
                    raise AssertionError(f"{name} at one NCCL rank: {err}")
    finally:
        dist.destroy_process_group()
    return out


def moe_cli_run(seed, tcfg, define_model, qk, fa):
    """``MOE_CLI_WORDS``: the CLI on the MoE cell at T 256 for one round,
    on in-memory Shakespeare windows from ``seed`` (``MOE_CLI_WINDOWS`` a
    character, through the port's window encoder; the
    TFF reader needs h5py, which the card's machine may lack), 5
    clients, all online (its checkpoint holds every client's state: 20
    clients' took 35.5 s to write): the counters set to 0 before, 200
    wgmma flash launches a round (4 layers x 10 steps x 5 clients, and
    the evaluation's), the tiled and ragged pairs from the leaf sizes, a
    finite loss line and test top-1 in [0, 1]."""
    import glob
    import tempfile
    from fedtorch_tpu_torch import cli
    from fedtorch_tpu_torch.data import datasets
    T = 256
    rng = np.random.RandomState(seed)
    xs, ys, parts = [], [], []
    for i in range(5):
        x, y = datasets.shakespeare_windows(
            [shakespeare_text(rng, MOE_CLI_WINDOWS, T).encode()], T)
        parts.append(np.arange(i * len(x), (i + 1) * len(x)))
        xs.append(x)
        ys.append(y)
    train_x, train_y = np.concatenate(xs), np.concatenate(ys)
    splits = datasets.DatasetSplits(train_x, train_y, train_x[:1],
                                    train_y[:1], client_partitions=parts)
    real = datasets.load_shakespeare
    datasets.load_shakespeare = lambda data_dir, seq_len=50: splits
    try:
        with tempfile.TemporaryDirectory() as root:
            argv = MOE_CLI_WORDS + ["-p", root, "-c",
                                    os.path.join(root, "runs")]
            cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
            numels = [math.prod(s) for s in model_shapes(cfg, define_model)]
            want = launches_per_round(qk, numels)
            reset_counters(qk, fa)
            t0 = time.perf_counter()
            res = cli.main(argv)
            run_s = time.perf_counter() - t0
            launched = counters(qk, fa)
            (record,) = glob.glob(os.path.join(root, "runs", "**",
                                               "record0"), recursive=True)
            with open(record) as f:
                losses = [float(v) for v in re.findall(
                    r"Round: \d+\. Epoch: .*? Loss: (\S+) \|", f.read())]
    finally:
        datasets.load_shakespeare = real
    if any(launched[c] != n for c, n in want.items()) \
            or launched["flash_tc"] < 200 or launched["flash_tf32"] \
            or len(losses) != 1 or not math.isfinite(losses[0]) \
            or not 0.0 <= res["test_top1"] <= 1.0:
        raise AssertionError(f"moe cli: launches {launched} (quantizer "
                             f"{want}), losses {losses}, {res}")
    out = dict(rounds=res["rounds"], losses=losses,
               test_top1=res["test_top1"], run_s=run_s,
               round_ms=res["timer"]["round"] * 1e3, launches=launched,
               tree_launches=dict(want, flash=0, flash_tc=0, flash_tf32=0))
    log(f"moe cli (T {T}): 1 round in {run_s:.1f} s ({out['round_ms']:.1f} "
        f"ms), loss {losses}, test top-1 {res['test_top1']:.4f}, launches "
        f"{launched}")
    return out


def moe_phase(seed, tcfg, define_model, make_algorithm, stack_partitions,
              FederatedTrainer, os_mod, qk, fa):
    """The Switch-MoE transformer cell (``MOE``) through the library entry
    points: 1 warm-up, 1 timed and 1 profiled round (the counters set to 0
    just before the warm-up: 400 wgmma flash launches a round, 2 + 2
    ragged and, for the expert weights of 4,194,304 elements, 2 + 2 tiled
    launches), the mean aux loss and each block's routed and dropped
    fractions on a batch of the server params, launches a local step and
    busy share from the profiled round's raw records, peak MiB; then its
    float32 cut card vs CPU in both dispatch modes, the ring's blocks over
    one card, the model-parallel forwards at one NCCL rank and the CLI at
    T 256. Within ``MOE_BUDGET_S``."""
    from fedtorch_tpu_torch.models.transformer import (
        drop_fractions, routing_fractions,
    )
    t0 = time.perf_counter()
    out, trainer, server, clients = main_path_phase(
        seed, tcfg, define_model, make_algorithm, stack_partitions,
        FederatedTrainer, qk, fa, arch="transformer", timed_rounds=1,
        lm=MOE)
    check_lm_launches(out, "flash_tc")
    per = out["launches_per_round"]
    if per["stats"] != 2 or per["apply"] != 2:
        raise AssertionError(f"moe_transformer: expected 2 + 2 tiled "
                             f"launches a round, got {per}")
    toks = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        0, MOE["vocab_size"], (LM_BATCH, MOE["rnn_seq_len"]))).cuda()
    model = trainer.model
    with torch.no_grad():
        _, aux = model.apply_with_aux(server.params, toks)
    layers = MOE["mlp_num_layers"]
    out["aux_loss_sum"] = float(aux)
    out["aux_loss_mean"] = float(aux) / layers
    out["routing_fractions"] = {
        b: f.tolist() for b, f in routing_fractions(
            model.module, server.params, toks).items()}
    out["drop_fractions"] = {
        b: float(f) for b, f in drop_fractions(
            model.module, server.params, toks).items()}
    if not math.isfinite(out["aux_loss_sum"]) \
            or len(out["routing_fractions"]) != layers \
            or len(out["drop_fractions"]) != layers:
        raise AssertionError(f"moe_transformer aux and fractions: {out}")
    log(f"moe_transformer: aux loss {out['aux_loss_sum']:.4f} (a block "
        f"{out['aux_loss_mean']:.4f}); drop fractions "
        f"{out['drop_fractions']}")
    prof = profile_phase(trainer, server, clients, per)
    steps = trainer.k_online * trainer.local_steps
    out["profile"] = prof
    out["launches_per_local_step"] = prof["kernel_launches"] / steps
    out["busy_share"] = prof["busy_share"]
    del trainer, server, clients, model
    gc.collect()
    torch.cuda.empty_cache()
    out["main_path_s"] = time.perf_counter() - t0
    out["cut"] = {f"cf{cf}": moe_cut_card_vs_cpu(
        seed, tcfg, define_model, stack_partitions, os_mod, qk, cf)
        for cf in MOE_CUT_CFS}
    out["ring_blocks"] = ring_blocks_check(fa)
    out["one_nccl_rank"] = moe_nccl_check(tcfg, define_model)
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = moe_cli_run(seed, tcfg, define_model, qk, fa)
    out["phase_s"] = time.perf_counter() - t0
    log(f"moe phase: {out['phase_s']:.1f} s (budget {MOE_BUDGET_S}); "
        f"round {out['round_ms']:.1f} ms, "
        f"{out['launches_per_local_step']:.1f} launches a local step, busy "
        f"{100 * (out['busy_share'] or 0):.1f}%, peak "
        f"{out['peak_mib']:.0f} MiB")
    if out["phase_s"] > MOE_BUDGET_S:
        raise AssertionError(f"moe phase took {out['phase_s']:.1f} s, over "
                             f"its {MOE_BUDGET_S} s budget")
    return out


# the podscale phase: the ResNet-20 main path's round at client_shards S
# in {0, 1} in this process and S=2 and S=0 as two spawned ranks on the
# one card (gloo: NCCL refuses two ranks on one device), resident and
# feed, and local-SGD mode on the two ranks; the CLI on two ranks;
# rounds each, the ranks' collective timeout, budget
PODSCALE_ROUNDS = 2
PODSCALE_TIMEOUT_S = 180
PODSCALE_BUDGET_S = 90.0
PODSCALE_CLI = ["-d", "synthetic", "-a", "logistic_regression", "-f",
                "true", "--num_workers", "8", "--online_client_rate", "0.5",
                "--local_step", "2", "-b", "8", "--eval_freq", "1",
                "--debug", "false"]


# the guarded round under attack: the update guards judging a 'gauss'
# attack from 30% of the population
PODSCALE_GUARDED = dict(guard_updates=True, byzantine_rate=0.3,
                        byzantine_mode="gauss")
# the robust round: a rule and the cohort statistics the client-shard
# seam refuses, served at client_shards 0
PODSCALE_ROBUST = dict(robust_agg="trimmed_mean")


def podscale_config(tcfg, shards, plane="device", guarded=False,
                    robust=False, **mesh):
    """The ResNet-20 main path's quantized round at ``shards``
    (``guarded``: with :data:`PODSCALE_GUARDED`; ``robust``: with
    :data:`PODSCALE_ROBUST` and ``cohort_stats``)."""
    cfg = path_config(tcfg, "resnet20")
    fault = dataclasses.replace(cfg.fault, **PODSCALE_GUARDED) \
        if guarded else cfg.fault
    telemetry = cfg.telemetry
    if robust:
        fault = dataclasses.replace(fault, **PODSCALE_ROBUST)
        telemetry = dataclasses.replace(telemetry, cohort_stats=True)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, data_plane=plane),
        mesh=dataclasses.replace(cfg.mesh, client_shards=shards, **mesh),
        fault=fault, telemetry=telemetry)


def state_hashes(server, clients, metrics, rows=None) -> dict:
    """sha256 of the server params and generator (:func:`leaf_hashes`),
    of every client-state leaf (``rows`` = ``(lo, hi)``: of those rows of
    the params, optimizer and aux trees, with the whole replicated epoch
    and local index), and of each round's metrics: the round's bitwise
    fingerprint, small enough to send between ranks."""
    from fedtorch_tpu_torch.core.state import tree_leaves, tree_map
    if rows is not None:
        lo, hi = rows
        clients = clients._replace(**{f: tree_map(
            lambda t: t[lo:hi] if isinstance(t, torch.Tensor) else t,
            getattr(clients, f)) for f in ("params", "opt", "aux")})
    out = leaf_hashes(server.params, server.rng.get_state())
    for what, tree in (("clients", clients), ("metrics", tuple(metrics))):
        h = hashlib.sha256()
        for t in tree_leaves(tree):
            raw = t.detach().reshape(-1).contiguous()
            if raw.dtype == torch.bool:
                raw = raw.to(torch.uint8)
            h.update(raw.view(torch.uint8).cpu().numpy().tobytes())
        out[what] = h.hexdigest()
    return out


def podscale_rounds(cfg, seed, qk, fa, data=None, hash_rows=()):
    """``PODSCALE_ROUNDS`` rounds of the main path's round at ``cfg``
    through ``run_round``, cuDNN deterministic: each round's ms, the
    ragged launches and the collectives of each kind each round issued
    (the seam's, the exchange's, the guards' norm gather's and the 1-D
    mesh's cohort gather and layout, with their bytes; counters set to
    0 just before it), the gauges, the
    memory the trainer and its state took (``torch.cuda.
    memory_allocated`` after ``init_state``, and its growth since
    before the trainer was built), and :func:`state_hashes` at the end:
    of the client rows this process holds, and of each ``(lo, hi)`` of
    ``hash_rows``. ``data``: the path's data, when already built."""
    from fedtorch_tpu_torch.algorithms import make_algorithm
    from fedtorch_tpu_torch.data.batching import stack_partitions
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.parallel import FederatedTrainer, podscale

    if data is None:
        data = path_data(cfg, seed, stack_partitions)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    trainer = FederatedTrainer(cfg, define_model(
        cfg, batch_size=cfg.data.batch_size), make_algorithm(cfg), data)
    del data
    server, clients = trainer.init_state(seed)
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    mib = 1 << 20
    memory = dict(allocated_after_init_mib=mem / mib,
                  trainer_and_state_mib=(mem - mem0) / mib)
    ms, launches, metrics = [], [], []
    kinds = {kind: dict(count=[], bytes=[])
             for kind in ("seam", "exchange", "norms", "cohort", "layout")}
    try:
        for _ in range(PODSCALE_ROUNDS):
            torch.cuda.synchronize()
            reset_counters(qk, fa)
            podscale.reset_collective_count()
            t0 = time.perf_counter()
            server, clients, m = trainer.run_round(server, clients)
            trainer.round_host_scalars(clients, m)
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(counters(qk, fa))
            for kind, c in kinds.items():
                c["count"].append(podscale.collective_count(kind))
                c["bytes"].append(podscale.gathered_bytes(kind))
            metrics.append(m)
        gauges = trainer.telemetry_gauges()
    finally:
        trainer.close()
    from fedtorch_tpu_torch.core.state import tree_leaves
    memory.update(
        client_state_mib=sum(t.numel() * t.element_size()
                             for t in tree_leaves(clients)) / mib,
        population_mib=sum(t.numel() * t.element_size()
                           for t in trainer.data) / mib
        if trainer.data is not None else 0.0)
    hashes = state_hashes(server, clients, metrics)
    by_rows = {f"{lo}:{hi}": state_hashes(server, clients, metrics,
                                          rows=(lo, hi))
               for lo, hi in hash_rows}
    return dict(round_ms=ms, launches=launches,
                collectives=kinds["seam"]["count"],
                exchange=kinds["exchange"], norm_gather=kinds["norms"],
                cohort_gather=kinds["cohort"], layout=kinds["layout"],
                gauges=gauges, client_shards=trainer.client_shards,
                rows=list(trainer.cohort_rows(trainer.k_dispatch)),
                client_rows=list(trainer.client_rows), memory=memory,
                guard_counts=[[float(m.byzantine_clients),
                               float(m.rejected_updates)] for m in metrics],
                hashes=hashes, hashes_by_rows=by_rows,
                fingerprint=hashlib.sha256(json.dumps(
                    hashes, sort_keys=True).encode()).hexdigest())


def podscale_rank(rank, store, seed, queue):
    """One spawned rank of the two-rank runs: the process group through
    ``init_multihost`` (a ``file://`` store), then
    :func:`podscale_rounds` at S=2 on the device plane, on the stream
    plane and guarded under attack on the device plane
    (:data:`PODSCALE_GUARDED`), and at S=0 on the device plane plain
    (``S0_resident``) and robust (``S0_robust``,
    :data:`PODSCALE_ROBUST` with ``cohort_stats``), from one build of
    the path's data; then local-SGD mode (``localsgd_W2``:
    :func:`localsgd_trainer` and :func:`localsgd_fit`, the counters set
    to 0 just before); its results (or its traceback) on ``queue``."""
    import traceback
    try:
        from fedtorch_tpu_torch import config as tcfg
        from fedtorch_tpu_torch.data.batching import stack_partitions
        from fedtorch_tpu_torch.models import define_model
        from fedtorch_tpu_torch.ops.cuda import (
            flash_attention as fa, quant_kernel as qk,
        )
        from fedtorch_tpu_torch.parallel import podscale
        from fedtorch_tpu_torch.parallel.mesh import init_multihost
        torch.backends.cudnn.deterministic = True
        out = {}
        data = None
        for name, shards, plane, guarded, robust in (
                ("device", 2, "device", False, False),
                ("stream", 2, "stream", False, False),
                ("guarded", 2, "device", True, False),
                ("S0_resident", 0, "device", False, False),
                ("S0_robust", 0, "device", False, True)):
            cfg = podscale_config(
                tcfg, shards, plane, guarded, robust,
                coordinator_address=f"file://{store}",
                num_processes=2, process_id=rank,
                init_timeout_s=float(PODSCALE_TIMEOUT_S))
            if data is None:
                out["backend"] = init_multihost(cfg.mesh)
                data = path_data(cfg, seed, stack_partitions)
            out[name] = podscale_rounds(cfg, seed, qk, fa, data)
            out[name]["backend"] = out["backend"]
            gc.collect()
            torch.cuda.empty_cache()
        del data
        gc.collect()
        trainer, data_s = localsgd_trainer(seed, tcfg, define_model,
                                           stack_partitions)
        reset_counters(qk, fa)
        podscale.reset_collective_count()
        run = localsgd_fit(trainer, seed)
        ends = [run["t0"]] + run["ends"]
        out["localsgd_W2"] = dict(
            rounds=len(run["history"]), hashes=run["hashes"],
            round_ms=[(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
            launches=counters(qk, fa), data_s=data_s,
            collectives={kind: dict(count=podscale.collective_count(kind),
                                    bytes=podscale.gathered_bytes(kind))
                         for kind in ("seam", "exchange", "norms", "cohort",
                                      "layout")},
            client_rows=list(trainer.client_rows),
            rows=list(trainer.cohort_rows(trainer.k_dispatch)),
            gauges=trainer.telemetry_gauges())
        del trainer, run
        gc.collect()
        torch.cuda.empty_cache()
        queue.put((rank, "ok", out))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def podscale_pair(root, seed) -> list:
    """Both ranks' :func:`podscale_rank`, spawned together;
    raises with a rank's traceback, or when a rank is silent for
    ``PODSCALE_TIMEOUT_S`` (both are killed)."""
    import multiprocessing
    import queue as queue_mod
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(root, "store")
    procs = [ctx.Process(target=podscale_rank,
                         args=(r, store, seed, q), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + PODSCALE_TIMEOUT_S
        while len(got) < 2:
            try:
                rank, status, value = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError(
                        f"podscale pair: a rank died or hung "
                        f"(exit codes {[p.exitcode for p in procs]})")
                continue
            if status != "ok":
                raise AssertionError(f"podscale pair rank {rank}:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[0], got[1]]


def podscale_cli(root) -> dict:
    """The CLI on two ranks on the card (``--client_shards 2
    --num_processes 2 --process_id {0,1} --coordinator_address
    127.0.0.1:<a free port>``), synthetic data, 2 rounds, then both
    resumed for a third: the two ranks' metric lines equal, rank 0's
    checkpoints the only ones (rank 1's run directory holds its log and
    health file only), and the resumed rounds go on in step."""
    import socket
    line = re.compile(r"Round: (\d+)\. ((?:Epoch|Mode).*?)$", re.M)

    def lines(path):
        with open(path) as f:
            return [re.sub(r"Load: .*?Global: [\d.]+s \| ", "", m.group(2))
                    for m in line.finditer(f.read())]

    def pair(rounds, resume):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for rank in (0, 1):
            run_dir = os.path.join(root, f"rank{rank}")
            argv = [sys.executable, "-m", "fedtorch_tpu_torch.cli"] \
                + PODSCALE_CLI + [
                    "--num_comms", str(rounds), "--client_shards", "2",
                    "--num_processes", "2", "--process_id", str(rank),
                    "--coordinator_address", f"127.0.0.1:{port}",
                    "--run_dir", run_dir]
            if resume:
                # every rank resumes from rank 0's files
                argv += ["--resume", os.path.join(root, "rank0")]
            procs.append(subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=PODSCALE_TIMEOUT_S)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (rc, out, err) in enumerate(outs):
            if rc != 0:
                raise AssertionError(f"podscale cli rank {rank}: exit {rc}"
                                     f"\n{err[-3000:]}")
        return [o for _, o, _ in outs]

    t0 = time.perf_counter()
    said = pair(2, False)
    first = [lines(os.path.join(root, f"rank{r}", f"record{r}"))
             for r in (0, 1)]
    files = {r: sorted(os.listdir(os.path.join(root, f"rank{r}")))
             for r in (0, 1)}
    ckpts = {r: [f for f in files[r] if f.endswith(".ckpt")] for r in (0, 1)}
    pair(3, True)
    after = [lines(os.path.join(root, f"rank{r}", f"record{r}"))
             for r in (0, 1)]
    out = dict(lines=first[0], rank1_files=files[1], rank0_ckpts=ckpts[0],
               resumed_lines=after[0][len(first[0]):],
               backend=[re.findall(r"init_multihost: backend (\w+)", o)
                        for o in said],
               s=time.perf_counter() - t0)
    if first[0] != first[1] or len(first[0]) != 4:
        raise AssertionError(f"podscale cli: rank lines differ {first}")
    if ckpts[1] or not ckpts[0]:
        raise AssertionError(f"podscale cli: checkpoints {ckpts}")
    if after[0] != after[1] or after[0][:4] != first[0] \
            or len(after[0]) != 6:
        raise AssertionError(f"podscale cli: resumed lines {after}")
    return out


def start_podscale_cli():
    """:func:`podscale_cli` in a temporary directory of its own, on a
    thread started now; returns a callable that joins it and returns its
    result (or raises what it raised)."""
    import tempfile
    box = {}

    def run():
        try:
            with tempfile.TemporaryDirectory() as root:
                box["out"] = podscale_cli(root)
        except BaseException as e:  # re-raised by the join
            box["out"] = e
    thread = threading.Thread(target=run, name="podscale-cli")
    thread.start()

    def join():
        thread.join(2 * PODSCALE_TIMEOUT_S + 60)
        if isinstance(box.get("out"), BaseException):
            raise box["out"]
        if "out" not in box:
            raise AssertionError("podscale cli: did not finish")
        return box["out"]
    return join


def podscale_phase(seed, tcfg, qk, fa, cli, localsgd=None):
    """Client sharding (``parallel/podscale.py``) and the 1-D mesh on the
    ResNet-20 main path's round (quantized FedAvg, int8 both ways, bf16,
    100 clients, k = 10, batch 50, 10 local steps), cuDNN deterministic:

    * ``S0``, ``S1``, ``S1_guarded`` and ``S0_robust``:
      ``PODSCALE_ROUNDS`` rounds in this process at ``client_shards`` 0
      and 1 (the armed twin: the grouped sum, no collective), at 1 with
      the update guards judging a 'gauss' attack
      (:data:`PODSCALE_GUARDED`), and at 0 with ``trimmed_mean`` and the
      cohort statistics (:data:`PODSCALE_ROBUST`, which the seam
      refuses); each round's ms, 2 + 2 ragged launches a round; the
      hashes of each rank's rows at two ranks;
    * ``S2_resident``, ``S2_feed`` and ``S2_guarded``: two spawned ranks
      on this card (``init_multihost`` through a ``file://`` store, the
      backend gloo by the module's rule), each running its 5 clients of
      the cohort on the device plane, on the stream plane (its producer
      packing only its rows) and guarded under attack on the device
      plane. The client state and the device plane's population are
      sharded: each rank holds its 50 clients' rows
      (``owned_client_rows``), the two ranks' rows cover the 100 once,
      and each rank's hash of its rows (with the server params,
      generator and metrics) equals the twin's hash of the same rows.
      Each rank launches the ragged pair 2 + 2 times a round (its
      [5]-row uplink, the downlink) and issues 1 seam collective, 1
      exchange and, guarded, 1 norm gather a round; the collectives'
      bytes, ``cohort_allreduce_bytes`` and ``cohort_gather_bytes`` as
      the counters and gauges say;
    * ``S0_resident`` and ``S0_robust``: the same pair at
      ``client_shards`` 0 (the JAX package's 1-D mesh), each rank running
      its 5 clients' loops, then one cohort gather bringing it the whole
      cohort, and the rest of the round on all 10: each rank's hashes
      bitwise ``S0``'s (``S0_robust``'s) of its rows, the ragged pair 2 +
      2 a round (the whole [10]-row uplink on every rank), 0 seam
      collectives, 1 exchange and 1 cohort gather a round, with bytes;
    * ``localsgd_W2``: local-SGD mode on the two ranks
      (:func:`localsgd_trainer`, 5 of the 10 workers a rank, 2 rounds of
      K = 10), each rank's hashes bitwise the ``localsgd`` phase's
      in-process ``fit`` (``localsgd``; run here when that phase did not
      run), one exchange and one cohort gather a round, each rank's
      round ms;
    * memory at S = 1, 2 and 0 (each rank): the client-state trees' and
      the population's resident MiB and ``memory_allocated`` after
      ``init_state``; the S = 2 client-state trees must be half of S =
      1's (the replicated [C] epoch and local index aside), and S = 0's
      equal S = 2's (the owner rule does not depend on S);
    * ``cli``: what :func:`podscale_cli` returned, run beside the
      lifecycle phase's untimed runs (:func:`start_podscale_cli`), so
      that nothing runs beside the timed rounds above.

    Two processes on one card: their round ms is no multi-card speed. No
    NCCL collective crosses two cards here (this machine has one)."""
    import tempfile
    from fedtorch_tpu_torch.parallel.mesh import owned_client_rows
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    rank_rows = [owned_client_rows(NUM_CLIENTS, 2, r) for r in (0, 1)]
    lsgd_rows = [owned_client_rows(LOCALSGD_WORKERS, 2, r) for r in (0, 1)]
    try:
        from fedtorch_tpu_torch.data.batching import stack_partitions
        data = path_data(podscale_config(tcfg, 0), seed, stack_partitions)
        for name, shards, guarded, robust in (
                ("S0", 0, False, False), ("S1", 1, False, False),
                ("S1_guarded", 1, True, False),
                ("S0_robust", 0, False, True)):
            gc.collect()
            torch.cuda.empty_cache()
            out[name] = podscale_rounds(
                podscale_config(tcfg, shards, guarded=guarded,
                                robust=robust), seed, qk, fa, data,
                hash_rows=rank_rows)
        del data
        if localsgd is None or "hashes_by_rows" not in localsgd:
            from fedtorch_tpu_torch.models import define_model
            trainer, _ = localsgd_trainer(seed, tcfg, define_model,
                                          stack_partitions)
            localsgd = localsgd_fit(trainer, seed, hash_rows=lsgd_rows)
            del trainer
        lsgd_twin = localsgd.pop("hashes_by_rows")
        gc.collect()
        torch.cuda.empty_cache()
        ranks = podscale_pair(root, seed)
        for name, key in (("S2_resident", "device"), ("S2_feed", "stream"),
                          ("S2_guarded", "guarded"),
                          ("S0_resident", "S0_resident"),
                          ("S0_robust_W2", "S0_robust"),
                          ("localsgd_W2", "localsgd_W2")):
            out[name] = [r[key] for r in ranks]
        out["cli"] = cli
    finally:
        tmp.cleanup()
        torch.backends.cudnn.deterministic = deterministic
    want = dict(ragged_stats=2, ragged_apply=2, stats=0, apply=0, flash=0,
                flash_tc=0, flash_tf32=0)
    ones, zeros = [1] * PODSCALE_ROUNDS, [0] * PODSCALE_ROUNDS
    for name in ("S0", "S1", "S1_guarded", "S0_robust"):
        r = out[name]
        if any(l != want for l in r["launches"]) or any(r["collectives"]) \
                or any(r["exchange"]["count"]) \
                or any(r["norm_gather"]["count"]) \
                or any(r["cohort_gather"]["count"]):
            raise AssertionError(f"podscale {name}: {r}")
    if not any(b for b, _ in out["S1_guarded"]["guard_counts"]):
        raise AssertionError("podscale S1_guarded: no attacker in a cohort "
                             f"{out['S1_guarded']['guard_counts']}")
    for name, twin in (("S2_resident", "S1"), ("S2_feed", "S1"),
                       ("S2_guarded", "S1_guarded"), ("S0_resident", "S0"),
                       ("S0_robust_W2", "S0_robust")):
        ranges = [tuple(r["client_rows"]) for r in out[name]]
        # the ranks' rows cover the 100 clients once, in rank order
        if ranges != [tuple(x) for x in rank_rows] or ranges[0][0] != 0 \
                or ranges[0][1] != ranges[1][0] \
                or ranges[1][1] != NUM_CLIENTS:
            raise AssertionError(f"podscale {name}: client rows {ranges}")
        flat = name.startswith("S0")
        for rank, r in enumerate(out[name]):
            mine = out[twin]["hashes_by_rows"]["%d:%d" % ranges[rank]]
            if r["hashes"] != mine:
                diff = [k for k in mine if r["hashes"].get(k) != mine[k]]
                raise AssertionError(
                    f"podscale {name} rank {rank}: not bitwise the {twin} "
                    f"twin on its rows ({len(diff)} of {len(mine)} hashes "
                    f"differ: {diff[:8]})")
            norms = ones if name == "S2_guarded" else zeros
            if any(l != want for l in r["launches"]) \
                    or r["collectives"] != (zeros if flat else ones) \
                    or r["exchange"]["count"] != ones \
                    or r["norm_gather"]["count"] != norms \
                    or r["cohort_gather"]["count"] != (ones if flat
                                                       else zeros) \
                    or any(r["layout"]["count"]) \
                    or r["backend"] != "gloo" \
                    or r["client_shards"] != (1 if flat else 2) \
                    or r["rows"] != [5 * rank, 5 * rank + 5]:
                raise AssertionError(f"podscale {name} rank {rank}: {r}")
    for rank, r in enumerate(out["localsgd_W2"]):
        rows = lsgd_rows[rank]
        mine = lsgd_twin["%d:%d" % rows]
        if r["hashes"] != mine:
            diff = [k for k in mine if r["hashes"].get(k) != mine[k]]
            raise AssertionError(
                f"podscale localsgd_W2 rank {rank}: not bitwise the "
                f"in-process fit on its rows ({len(diff)} of {len(mine)} "
                f"hashes differ: {diff[:8]})")
        c = r["collectives"]
        if r["rounds"] != LOCALSGD_ROUNDS or any(r["launches"].values()) \
                or c["seam"]["count"] or c["norms"]["count"] \
                or c["layout"]["count"] \
                or c["exchange"]["count"] != LOCALSGD_ROUNDS \
                or c["cohort"]["count"] != LOCALSGD_ROUNDS \
                or r["client_rows"] != list(rows) \
                or r["rows"] != [5 * rank, 5 * rank + 5]:
            raise AssertionError(f"podscale localsgd_W2 rank {rank}: {r}")
    memory = dict(S1=out["S1"]["memory"],
                  S2=[r["memory"] for r in out["S2_resident"]],
                  S0=[r["memory"] for r in out["S0_resident"]])
    # the trees hold 100 -> 50 clients' rows; the replicated [C] epoch
    # and local index (800 B) ride in both; S = 0 holds what S = 2 does
    for m, m0 in zip(memory["S2"], memory["S0"]):
        if abs(2 * m["client_state_mib"] - memory["S1"]["client_state_mib"]) \
                > 0.01 * memory["S1"]["client_state_mib"] \
                or abs(2 * m["population_mib"]
                       - memory["S1"]["population_mib"]) \
                > 0.01 * memory["S1"]["population_mib"] \
                or m0["client_state_mib"] != m["client_state_mib"] \
                or m0["population_mib"] != m["population_mib"]:
            raise AssertionError(f"podscale memory: {memory}")
    gauges = out["S2_resident"][0]["gauges"]
    out.update(
        cohort_allreduce_bytes=gauges["cohort_allreduce_bytes"],
        cohort_gather_bytes=gauges["cohort_gather_bytes"],
        flat_cohort_gather_bytes=dict(
            (name, [r["gauges"]["flat_cohort_gather_bytes"]
                    for r in out[name]])
            for name in ("S0_resident", "S0_robust_W2")),
        exchange=dict((name, [dict(count=r["exchange"]["count"],
                                   bytes=r["exchange"]["bytes"])
                              for r in out[name]])
                      for name in ("S2_resident", "S2_feed", "S2_guarded",
                                   "S0_resident", "S0_robust_W2")),
        cohort_gather=dict((name, [dict(count=r["cohort_gather"]["count"],
                                        bytes=r["cohort_gather"]["bytes"])
                                   for r in out[name]])
                           for name in ("S0_resident", "S0_robust_W2")),
        norm_gather=[dict(count=r["norm_gather"]["count"],
                          bytes=r["norm_gather"]["bytes"])
                     for r in out["S2_guarded"]],
        localsgd_collectives=[r["collectives"]
                              for r in out["localsgd_W2"]],
        guard_counts=out["S1_guarded"]["guard_counts"], memory=memory,
        round_ms=dict(S0=out["S0"]["round_ms"][-1],
                      S1=out["S1"]["round_ms"][-1],
                      S1_guarded=out["S1_guarded"]["round_ms"][-1],
                      S0_robust=out["S0_robust"]["round_ms"][-1],
                      localsgd_W2=[r["round_ms"][-1]
                                   for r in out["localsgd_W2"]]),
        launches_per_round_a_rank=out["S2_resident"][0]["launches"][-1],
        collectives_per_round=out["S2_resident"][0]["collectives"][-1],
        backend=out["S2_resident"][0]["backend"], bitwise=True,
        phase_s=time.perf_counter() - t0, budget_s=PODSCALE_BUDGET_S)
    for name in ("S2_resident", "S2_feed", "S2_guarded", "S0_resident",
                 "S0_robust_W2"):
        out["round_ms"][name] = [r["round_ms"][-1] for r in out[name]]
    # the per-leaf hashes are held above; the output keeps each run's
    # fingerprint of them
    for name in ("S0", "S1", "S1_guarded", "S0_robust"):
        del out[name]["hashes"], out[name]["hashes_by_rows"]
    for name in ("S2_resident", "S2_feed", "S2_guarded", "S0_resident",
                 "S0_robust_W2"):
        for r in out[name]:
            del r["hashes"], r["hashes_by_rows"]
    for r in out["localsgd_W2"]:
        del r["hashes"]
    # rank 0's launches over its rounds (the kernels line's
    # launches_by_path); each rank's a round are checked above
    out["launches"] = {c: sum(l[c] for l in out["S2_resident"][0]["launches"])
                       for c in want}
    out["tree_launches"] = out["launches"]
    for key, name in (("guarded", "S2_guarded"), ("S0_rank0", "S0_resident")):
        g = {c: sum(l[c] for l in out[name][0]["launches"]) for c in want}
        out[key] = dict(launches=g, tree_launches=g)
    log(f"podscale phase: {out['phase_s']:.1f} s (budget "
        f"{PODSCALE_BUDGET_S}); backend {out['backend']}; S=2 resident, "
        "feed and guarded (gauss attack) bitwise the S=1 twin, S=0 "
        "resident and robust (trimmed_mean, cohort_stats) bitwise the "
        "one-process S=0 round, and local SGD on two ranks bitwise the "
        "one-process fit, on every rank's own client rows, the ranks' "
        "rows covering the 100 once; a rank a round: ragged "
        f"{out['launches_per_round_a_rank']}, seam collectives "
        f"{out['collectives_per_round']} (S=0: 0), exchange "
        f"{out['exchange']} (count and bytes a round), cohort gather "
        f"{out['cohort_gather']}, guards' norm gather "
        f"{out['norm_gather']}; local SGD collectives "
        f"{out['localsgd_collectives']}; attackers and rejected a round (S1 "
        f"guarded) {out['guard_counts']}; cohort_allreduce_bytes "
        f"{out['cohort_allreduce_bytes']:.0f}, cohort_gather_bytes "
        f"{out['cohort_gather_bytes']:.0f}, flat_cohort_gather_bytes "
        f"{out['flat_cohort_gather_bytes']}; memory (MiB) {memory}; round "
        f"ms {out['round_ms']} (two ranks share one card: no multi-card "
        f"speed); cli {out['cli']['s']:.1f} s, rank 0's checkpoints "
        f"{out['cli']['rank0_ckpts']}, rank 1 wrote {out['cli']['rank1_files']}")
    if out["phase_s"] > PODSCALE_BUDGET_S:
        log(json.dumps(out))
        raise AssertionError(f"podscale phase took {out['phase_s']:.1f} s, "
                             f"over its {PODSCALE_BUDGET_S} s budget")
    return out


def check_lm_launches(out, route):
    """A transformer path's round: ``LM_FLASH_PER_ROUND`` flash launches
    (layers x 10 local steps x 10 clients), all on ``route``'s kernel,
    and 2 + 2 ragged launches."""
    per = out["launches_per_round"]
    other = "flash_tf32" if route == "flash_tc" else "flash_tc"
    n = LM_FLASH_PER_ROUND
    if per["flash"] != n or per[route] != n or per[other] != 0 \
            or per["ragged_stats"] != 2 or per["ragged_apply"] != 2:
        raise AssertionError(f"d_model {out['d_model']} {out['dtype']}: "
                             f"expected {n} {route} and 2 + 2 ragged "
                             f"launches per round, got {per}")


# the phases after the card and the build, in their order; ``--phases``
# runs a subset (a phase that needs another's numbers brings it along)
PHASES = ("kernels", "reference", "main", "stream", "cli", "zoo", "localsgd",
          "tasks", "models", "faults", "lifecycle", "federation", "fusion",
          "wideresnet", "transformer", "transformer_d512", "transformer_d1024",
          "transformer_d2048", "transformer_f32", "moe", "podscale")
PHASE_NEEDS = {"faults": ("main",)}


def chosen_phases(spec) -> set:
    """The phases ``--phases`` names (all without it)."""
    if spec is None:
        return set(PHASES)
    names = {n.strip() for n in spec.split(",") if n.strip()}
    unknown = names - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; "
                         f"the phases: {' '.join(PHASES)}")
    for n in list(names):
        names.update(PHASE_NEEDS.get(n, ()))
    return names


def kernels_line(results, fa, ragged_stats_fields, ragged_apply_fields,
                 stats_fields, apply_fields, single_fields, flash_fields):
    """The ``kernels`` entries, every kernel's launches by path (the full
    run's)."""
    main, cli_out = results["main_path"], results["cli"]
    wrn, lm = results["wrn_main_path"], results["transformer_main_path"]
    d512, d1024, d2048, f32 = (results[f"{n}_main_path"]
                               for n in ("transformer_d512",
                                         "transformer_d1024",
                                         "transformer_d2048",
                                         "transformer_f32"))
    zoo, tasks, models = (results[n] for n in ("zoo", "tasks", "models"))
    faults, stream = results["faults"], results["stream"]
    federation, fusion = results["federation"], results["fusion"]
    moe, podscale = results["moe"], results["podscale"]
    cli_out["tree_launches"] = cli_out["launches"]
    paths = (("resnet20", main), ("cli", cli_out),
             ("cli_apfl", results["cli_apfl"]),
             ("localsgd", results["localsgd"]), ("wideresnet28_10", wrn),
             ("transformer", lm), ("transformer_d512", d512),
             ("transformer_d1024", d1024), ("transformer_d2048", d2048),
             ("transformer_f32", f32),
             ("cli_stream_mmap", cli_out["stream_mmap"])) + tuple(
                 (f"zoo_{n}", r) for n, r in zoo["paths"].items()) + tuple(
                 (f"tasks_{n}", r) for n, r in tasks["paths"].items()) + tuple(
                 (f"models_{n}", r) for n, r in models["paths"].items()) + tuple(
                 (n, r) for n, r in faults["paths"].items()) + tuple(
                 (f"cli_tff_{n}", tasks["cli_tff"][n])
                 for n in ("shakespeare_rnn", "emnist_cnn")
                 if isinstance(tasks["cli_tff"], dict)) + tuple(
                 (n, r) for n, r in stream["paths"].items()
                 if n.startswith("stream_")) + tuple(
                 federation["paths"].items()) + tuple(
                 (n, federation[n]) for n in ("async_cli",
                                              "async_cli_stream")) + (
                 ("fusion_cell_fused", fusion["cell"]["fused"]),
                 ("fusion_cell_vmap", fusion["cell"]["vmap"]),
                 ("fusion_cnn_cifar", fusion["cnn_cifar"]),
                 ("cli_fused", cli_out["fused"]),
                 ("moe_transformer", moe), ("cli_moe", moe["cli"]),
                 ("podscale_S2_rank0", podscale),
                 ("podscale_S2_guarded_rank0", podscale["guarded"]),
                 ("podscale_S0_rank0", podscale["S0_rank0"]))
    by_path = {c: {p: r["launches"][c] for p, r in paths}
               for c in main["launches"]}
    single_by_path = {p: r["launches"]["ragged_apply"]
                      - r["tree_launches"]["ragged_apply"] for p, r in paths}
    # one counter for every head dim of the wgmma kernel: a path's
    # launches go to its head dim's entry (64 but on these three)
    dims = {"transformer_d512": 128, "transformer_d1024": 256,
            "transformer_d2048": 512}
    tc_by_dim = {d: {p: n for p, n in by_path["flash_tc"].items()
                     if dims.get(p, 64) == d} for d in (64, 128, 256, 512)}
    # the TF32 kernel at D 256 and 512: the float32 cuts of
    # transformer_d1024 and transformer_d2048
    tf32_by_path = dict(
        by_path["flash_tf32"],
        transformer_d1024_f32_cut=(
            d1024["f32_cut"]["round_flash_launches"]["flash_tf32"]),
        transformer_d2048_f32_cut=(
            d2048["f32_cut"]["round_flash_launches"]["flash_tf32"]))
    kernels = [
        dict(name="qdq_ragged_stats_f32", route="cuda", source=RAGGED_SOURCE,
             replaces=TPU_KERNEL, launches=main["launches"]["ragged_stats"],
             launches_by_path=by_path["ragged_stats"], library_ms=None,
             library_note="no single PyTorch call gives per-chunk "
                          "[min, max, sum] partials", **ragged_stats_fields),
        dict(name="qdq_ragged_apply_f32", route="cuda", source=RAGGED_SOURCE,
             replaces=TPU_KERNEL, launches=main["launches"]["ragged_apply"],
             launches_by_path=by_path["ragged_apply"], library_ms=None,
             library_note=NO_LIBRARY, **ragged_apply_fields),
        dict(name="qdq_tiled_stats_f32", route="cuda", source=TILED_SOURCE,
             replaces=f"{TPU_QUANT}:83", launches=wrn["launches"]["stats"],
             launches_by_path=by_path["stats"], library_ms=None,
             library_note="no single PyTorch call gives per-chunk "
                          "[min, max, sum] partials", **stats_fields),
        dict(name="qdq_tiled_apply_f32", route="cuda", source=TILED_SOURCE,
             replaces=f"{TPU_QUANT}:111", launches=wrn["launches"]["apply"],
             launches_by_path=by_path["apply"], library_ms=None,
             library_note=NO_LIBRARY, **apply_fields),
        # the entry launches the ragged pair on [1, n]; a main path's
        # ragged launches past those of its tree function would be the
        # entry's
        dict(name="fused_quantize_dequantize (the ragged pair on [1, n])",
             route="cuda", source=RAGGED_SOURCE, replaces=f"{TPU_QUANT}:72",
             launches=sum(single_by_path.values()),
             launches_by_path=single_by_path, on_main_path=False,
             library_ms=None, library_note=NO_LIBRARY, **single_fields),
        # the wgmma kernel: head dim 64 on the transformer path, 128 on
        # transformer_d512, 256 on transformer_d1024, 512 on
        # transformer_d2048 (one counter for all)
        dict(name="flash_fwd_tc (D 64)", route="cuda",
             source=FLASH_TC_SOURCE, replaces=FLASH_TPU_KERNEL,
             launches=lm["launches"]["flash_tc"],
             launches_by_path=dict(
                 tc_by_dim[64],
                 transformer_evaluate=lm["evaluate"]["launches"]["flash_tc"]),
             launches_per_round=lm["launches_per_round"]["flash_tc"],
             **flash_fields["tc64"]),
        dict(name="flash_fwd_tc (D 128)", route="cuda",
             source=FLASH_TC_SOURCE, replaces=FLASH_TPU_KERNEL,
             launches=d512["launches"]["flash_tc"],
             launches_by_path=tc_by_dim[128],
             launches_per_round=d512["launches_per_round"]["flash_tc"],
             **flash_fields["tc128"]),
        dict(name="flash_fwd_tc (D 256)", route="cuda",
             source=FLASH_TC_SOURCE, replaces=FLASH_TPU_KERNEL,
             launches=d1024["launches"]["flash_tc"],
             launches_by_path=tc_by_dim[256],
             launches_per_round=d1024["launches_per_round"]["flash_tc"],
             **flash_fields["tc256"]),
        dict(name="flash_fwd_tc (D 512)", route="cuda",
             source=FLASH_TC_SOURCE, replaces=FLASH_TPU_KERNEL,
             launches=d2048["launches"]["flash_tc"],
             launches_by_path=tc_by_dim[512],
             launches_per_round=d2048["launches_per_round"]["flash_tc"],
             **flash_fields["tc512"]),
        # the TF32 kernel: float32 (transformer_f32, the reference phase,
        # the float32 cuts of transformer_d1024 at D 256 and
        # transformer_d2048 at D 512), other head dims, misaligned views
        dict(name="flash_fwd_tf32", route="cuda", source=FLASH_TF32_SOURCE,
             replaces=FLASH_TPU_KERNEL,
             launches=f32["launches"]["flash_tf32"],
             launches_by_path=tf32_by_path,
             launches_per_round=f32["launches_per_round"]["flash_tf32"],
             **flash_fields["tf32"]),
    ]
    return kernels


def _sync_summary(n: dict) -> dict:
    return dict(syncs=n["syncs"], runtime_syncs=n["runtime_syncs"], sites=n["sync_sites"])


def observability(results: dict, card: str) -> dict:
    """The observability checks' numbers from the phases that ran: the
    named synchronizing calls of ResNet-20's round index 1 (the
    federation phase's cohort-stats paths) and of the fused and vmap
    rounds (the fusion phase), the profiled rounds' attribution, each
    cell's MFU and memory gauges, and the lock sentinel's locks."""
    out = {"card": card}
    fed = results.get("federation")
    if fed:
        out["syncs_resnet20_round_1"] = {
            n: _sync_summary(fed["paths"][n]["round_index_1"])
            for n in ("cohort_stats_off", "cohort_stats_on")}
    fusion = results.get("fusion")
    if fusion:
        out["syncs_fusion_round_3"] = {
            ex: _sync_summary(fusion["cell"][ex]["round_index_3"])
            for ex in ("fused", "vmap")}
    out["attribution"] = {
        name: dict(p["attribution"], hand_kernels=p["hand_kernels"],
                   device_ms_by_column=p["device_ms_by_column"],
                   device_ms=p["device_ms"], busy_share=p["busy_share"],
                   file=p.get("file_attribution"))
        for name, p in results.items()
        if name.endswith("profile") and isinstance(p, dict)}
    out["mfu"] = {name[:-len("_main_path")] if name != "main_path"
                  else "resnet20": dict(
                      mfu=r["costs"]["mfu"], round_ms=r["round_ms"],
                      round_flops=r["costs"]["flops"]["round"],
                      peak_tflops=r["costs"]["peak_tflops"],
                      peak_mib=r["peak_mib"])
                  for name, r in results.items()
                  if name.endswith("main_path")}
    if results.get("cli"):
        out["cli_costs"] = results["cli"]["costs"]
    life = results.get("lifecycle")
    if life:
        out["lock_sentinel"] = {n: r["lock_sentinel"]
                                for n, r in life["reference"].items()}
    return out


def log_observability(obs: dict) -> None:
    for name, m in obs["mfu"].items():
        log(f"MFU {name}: {m['mfu']:.6f} ({m['round_flops']:.4g} FLOPs a "
            f"round in {m['round_ms']:.1f} ms at {m['peak_tflops']} TFLOP/s; "
            f"{obs['card']})")
    if "cli_costs" in obs:
        c = obs["cli_costs"]
        log(f"CLI gauges: MFU {c['model_flops_utilization']}, program peak "
            f"{c['hbm_program_peak_bytes']} B, live {c['hbm_live_bytes']} B "
            f"({c['card']})")
    for name, a in obs["attribution"].items():
        log(f"attribution {name}: {100 * a['attributed_frac']:.2f}%, "
            f"columns {a['device_ms_by_column']}, hand kernels "
            + ", ".join(f"{r} {v['launches']}"
                        for r, v in a["hand_kernels"].items()))
    for name, locks in obs.get("lock_sentinel", {}).items():
        log(f"lock sentinel {name}: clean, {len(locks['names'])} locks "
            f"({', '.join(locks['names'])}), edges {locks['order_edges']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after the card and "
                         "the build (default: all; 'list' names them)")
    args = ap.parse_args(argv)
    if args.phases == "list":
        print(" ".join(PHASES))
        return 0
    phases = chosen_phases(args.phases)
    want = phases.__contains__
    full = phases == set(PHASES)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from fedtorch_tpu_torch import config as tcfg
    from fedtorch_tpu_torch.algorithms import make_algorithm
    from fedtorch_tpu_torch.data.batching import stack_partitions
    from fedtorch_tpu_torch.models import define_model
    from fedtorch_tpu_torch.ops.cuda import (
        build, flash_attention as fa, quant_kernel as qk,
    )
    from fedtorch_tpu_torch.async_plane import AsyncFederatedTrainer
    from fedtorch_tpu_torch.parallel import FederatedTrainer
    from fedtorch_tpu_torch.tools import order_spread

    t_start = time.perf_counter()
    phase("card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    phase("build")
    res = build.build()
    log(f"built {res.path.name} in {res.seconds:.2f} s with "
        f"{build.nvcc_path()}")
    if res.log.strip():
        log(res.log.strip())
    build.load_library()

    if want("kernels"):
        phase("kernels vs plain")
        k_online = max(int(ONLINE_RATE * NUM_CLIENTS), 1)
        cells = {cell: leaf_shapes(tcfg, define_model, arch, widen)
                 for cell, arch, widen in (
                     ("resnet20", "resnet20", None),
                     ("wideresnet28_10", "wideresnet28", 10),
                     ("transformer", "transformer", None))}
        # DenseNet-BC-100: 299 leaves, 2,990 rows an uplink call
        cells["densenet_bc100"] = leaf_shapes(
            tcfg, define_model, "densenet100", model=DENSENET)
        ragged_stats_fields, ragged_apply_fields = ragged_phase(
            qk, fa, cells, k_online)
        wrn_sizes = {}
        for shape in cells["wideresnet28_10"]:
            n = math.prod(shape)
            wrn_sizes[n] = wrn_sizes.get(n, 0) + 1
        stats_fields, apply_fields = tiled_phase(
            qk, sorted((b, n) for n, b in wrn_sizes.items()
                       if n > qk._MAX_ROW_ELEMS), k_online)
        single_fields = single_phase(qk, fa)
        flash_fields = flash_phase(fa)

    lm_ref = None
    if want("reference"):
        phase("reference")
        reference_phase(tcfg, define_model, order_spread, qk, fa)
        # d_model 64, and the default width (d_model 100: heads of 25)
        lm_ref = [lm_reference_phase(tcfg, define_model, make_algorithm,
                                     stack_partitions, FederatedTrainer, fa,
                                     hidden) for hidden in (32, 50)]

    import tempfile
    results = {}
    main = None
    if want("main"):
        phase("main path")
        main, trainer, server, clients = main_path_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, qk, fa)
        if main["launches_per_round"]["ragged_stats"] != 2 \
                or main["launches_per_round"]["ragged_apply"] != 2:
            raise AssertionError("expected 2 ragged stats and 2 ragged apply "
                                 "launches per ResNet-20 round")

        phase("profile")
        # capture_round_trace's round: its trace file attributed beside
        # the in-memory records
        with tempfile.TemporaryDirectory() as cap:
            prof = profile_phase(trainer, server, clients,
                                 main["launches_per_round"], log_dir=cap)
        ragged = {r: prof["hand_kernels"].get(r, {}).get("launches")
                  for r in ("qdq_ragged_stats", "qdq_ragged_apply")}
        if ragged != {"qdq_ragged_stats": 2, "qdq_ragged_apply": 2}:
            raise AssertionError(f"the ResNet-20 round's attribution holds "
                                 f"{ragged} ragged launches, not 2 + 2")
        results["main_path"] = main
        results["profile"] = prof
        del trainer, server, clients

    if want("stream"):
        phase("stream")
        results["stream"] = stream_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, qk, fa)

    cli_out = None
    if want("cli"):
        phase("cli")
        gc.collect()
        torch.cuda.empty_cache()
        cli_out = cli_phase(args.seed, tcfg, define_model, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()
        results["cli"] = cli_out
        results["cli_apfl"] = cli_apfl_phase(args.seed, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()

    if want("zoo"):
        phase("zoo")
        results["zoo"] = zoo_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, order_spread, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()

    if want("localsgd"):
        phase("localsgd")
        results["localsgd"] = localsgd_phase(
            args.seed, tcfg, define_model, stack_partitions, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()

    if want("tasks"):
        phase("tasks")
        results["tasks"] = tasks_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, order_spread, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()

    if want("models"):
        phase("models")
        results["models"] = models_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, order_spread, qk, fa)
        gc.collect()
        torch.cuda.empty_cache()

    if want("faults"):
        phase("faults")
        results["faults"] = faults_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, order_spread, qk, fa, main["round_ms"])
        gc.collect()
        torch.cuda.empty_cache()

    # the child processes that run beside the lifecycle phase's untimed
    # stream and supervisor runs: the federation phase's async kill drill
    # (on CIFAR-10 files in beside_dir, where that phase's reference runs
    # too) and the podscale phase's CLI pair
    beside_dir = tempfile.TemporaryDirectory()
    beside = {}

    def start_beside():
        if want("federation"):
            write_cifar10(beside_dir.name, args.seed)
            beside["async_drill"] = start_async_drill(beside_dir.name, qk)
        if want("podscale"):
            beside["podscale_cli"] = start_podscale_cli()

    if want("lifecycle"):
        phase("lifecycle")
        results["lifecycle"] = lifecycle_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, qk, fa, beside=start_beside)
    else:
        start_beside()
    # their children end before the next timed round
    if "async_drill" in beside \
            and not beside["async_drill"]["children"].wait(600):
        raise AssertionError("federation async_drill: its children did not "
                             "end")
    podscale_cli_out = beside["podscale_cli"]() \
        if "podscale_cli" in beside else None
    gc.collect()
    torch.cuda.empty_cache()

    if want("federation"):
        phase("federation")
        results["federation"] = federation_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, AsyncFederatedTrainer, order_spread, qk, fa,
            beside_dir.name, beside["async_drill"])
        gc.collect()
        torch.cuda.empty_cache()

    if want("fusion"):
        phase("fusion")
        results["fusion"] = fusion_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, order_spread, qk, fa,
            cli_out["fused"] if cli_out else None)
        gc.collect()
        torch.cuda.empty_cache()

    if want("wideresnet"):
        phase("WideResNet main path")
        wrn, trainer, server, clients = main_path_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, qk, fa, arch="wideresnet28", widen=10,
            timed_rounds=WRN_TIMED_ROUNDS)
        if [wrn["launches_per_round"][c] for c in (
                "ragged_stats", "ragged_apply", "stats", "apply")] \
                != [2, 2, 6, 6]:
            raise AssertionError(f"expected 2 + 2 ragged and 6 + 6 tiled "
                                 f"launches per WideResNet round: "
                                 f"{wrn['launches_per_round']}")
        results["wrn_main_path"] = wrn
        results["wrn_profile"] = profile_phase(trainer, server, clients,
                                               wrn["launches_per_round"])
        del trainer, server, clients

    if want("transformer"):
        phase("transformer main path")
        gc.collect()
        torch.cuda.empty_cache()
        lm, trainer, server, clients = main_path_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, qk, fa, arch="transformer",
            timed_rounds=LM_TIMED_ROUNDS)
        check_lm_launches(lm, "flash_tc")
        lm["reference"] = lm_ref
        lm["evaluate"] = lm_eval_step(trainer, server, args.seed, qk, fa)
        lm_prof = profile_phase(trainer, server, clients,
                                lm["launches_per_round"])
        flash = lm_prof["hand_kernels"].get("flash_fwd_tc", {})
        if flash.get("launches") != LM_FLASH_PER_ROUND:
            raise AssertionError(f"the transformer round's attribution "
                                 f"holds {flash} flash launches, not "
                                 f"{LM_FLASH_PER_ROUND}")
        results["transformer_main_path"] = lm
        results["transformer_profile"] = lm_prof
        del trainer, server, clients

    # the wide cells' float32 cuts (the TF32 kernel at D 256 and 512
    # inside a round, card vs CPU) and tiled launches a round
    cuts = {"transformer_d1024": (D1024_CUT, 8),
            "transformer_d2048": (D2048_CUT, 6)}
    for name, sizes, dtype, rounds, route, population in (
            ("transformer_d512", LM_D512, "bfloat16", D512_TIMED_ROUNDS,
             "flash_tc", (NUM_CLIENTS, ONLINE_RATE)),
            ("transformer_d1024", LM_D1024, "bfloat16", D1024_TIMED_ROUNDS,
             "flash_tc", (NUM_CLIENTS, ONLINE_RATE)),
            ("transformer_d2048", LM_D2048, "bfloat16", D2048_TIMED_ROUNDS,
             "flash_tc", D2048_POPULATION),
            ("transformer_f32", LM, "float32", F32_TIMED_ROUNDS,
             "flash_tf32", (NUM_CLIENTS, ONLINE_RATE))):
        if not want(name):
            continue
        phase(f"{name} main path")
        gc.collect()
        torch.cuda.empty_cache()
        out, trainer, server, clients = main_path_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, qk, fa, arch="transformer",
            timed_rounds=rounds, lm=sizes, dtype=dtype,
            population=population)
        check_lm_launches(out, route)
        results[f"{name}_main_path"] = out
        results[f"{name}_profile"] = profile_phase(
            trainer, server, clients, out["launches_per_round"])
        del trainer, server, clients
        if name in cuts:
            cut, tiled = cuts[name]
            gc.collect()
            torch.cuda.empty_cache()
            per = out["launches_per_round"]
            log(f"{name}: tiled launches a round {per['stats']:g} + "
                f"{per['apply']:g} (one of each per leaf size past "
                f"{qk._MAX_ROW_ELEMS:,}, uplink and downlink)")
            if (per["stats"], per["apply"]) != (tiled, tiled):
                raise AssertionError(f"{name}: expected {tiled} + {tiled} "
                                     f"tiled launches a round, got {per}")
            # its round cut in float32: the TF32 kernel inside a round,
            # card vs CPU
            out["f32_cut"] = lm_reference_phase(
                tcfg, define_model, make_algorithm, stack_partitions,
                FederatedTrainer, fa, **cut)

    if want("moe"):
        phase("moe")
        gc.collect()
        torch.cuda.empty_cache()
        results["moe"] = moe_phase(
            args.seed, tcfg, define_model, make_algorithm, stack_partitions,
            FederatedTrainer, order_spread, qk, fa)

    if want("podscale"):
        phase("podscale")
        gc.collect()
        torch.cuda.empty_cache()
        results["podscale"] = podscale_phase(
            args.seed, tcfg, qk, fa, podscale_cli_out,
            results.get("localsgd"))
    beside_dir.cleanup()

    if full:
        print(json.dumps({"kernels": kernels_line(
            results, fa, ragged_stats_fields, ragged_apply_fields,
            stats_fields, apply_fields, single_fields, flash_fields)}))
    for key, value in results.items():
        line = {key: value}
        if not key.endswith("_profile") and key != "profile":
            line["card"] = card
        print(json.dumps(line))
    obs = observability(results, card)
    log_observability(obs)
    print(json.dumps({"observability": obs}))
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s"
        + ("" if full else f" (phases: {', '.join(sorted(phases))})"))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0




if __name__ == "__main__":
    sys.exit(main())
