#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which fails the run:

1. build: ``nvcc`` compiles every ``src/repro_torch/kernels/csrc/*.cu``
   into ``build/repro_torch_kernels/`` (one process per source, in
   parallel) and prints ``-Xptxas -v``'s register report. The kernels
   built on Hopper's warpgroup products and TMA (``flash_attention``,
   ``dist_topk``, the dense CE kernels ``ce_softmax_fwd`` and
   ``ce_softmax_bwd``, and the sparse ones ``sparse_ce_fwd`` and
   ``sparse_ce_bwd``, whose TMA loads are f's halves) must show ``HGMMA``
   and ``UTMALDG`` in their SASS (``cuobjdump -sass``) and no spills; the
   FMA kernels that stream by 1-D bulk copies (``ivf_rerank``,
   ``topk_stage1``) must show ``UBLKCP`` and no spills.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same card tensors, at the shapes of the paper's 1M-class
   configuration (V=1,020,250, D=512; B=64 for serving, B=256 for
   training) and at small ragged shapes with masked columns, labels off
   the shard, ties and -inf rows. Tolerances: ``ce_forward`` m and corr
   atol 1e-4, z rtol 1e-4, amax equal except on rows whose top-2 score
   gap is below 1e-5 (fp32 sums in another order may swap a near-tie);
   ``stage1_topk`` values and ids exact (also at k = chunk / 2 and k =
   chunk, -0 tied with +0, rows 4 and 12 bytes off 16, chunks of 4,096 and
   10,000, k = 1,048 on a [512, 2,048] DGC group of |N(0, 1)| values, and
   the serving logits, whose odd rows start 8 bytes off 16; the wrapper's
   shared-memory limit equal to the kernel's); ``ce_backward`` max|kernel -
   plain| <= 2e-5 * max|plain| for df, dW's label rows and dW's other rows,
   each against its own max (sums over V or B in another order), at the
   training shapes both with the loss's cotangents and with the softmax
   term alone (gc = 0); both CE kernels bit-identical across two runs (no
   atomics). The CE kernels take their products in 3xTF32; at the training
   shapes the plain versions with the products emulated in 1xTF32
   (``repro_torch.testing``) must fail both CE gates, so the gates tell the
   design from plain TF32. Then
   CUDA-event times of the kernel, its plain version, the library call
   that computes the same function, or for the CE kernels its dense
   ``f @ W.T`` product alone (cuBLAS, TF32 off), and the bound (bytes
   over 3.35 TB/s or operations over 67 TFLOP/s fp32 / 494.7 TFLOP/s TF32
   / 989 TFLOP/s bf16, the H100 SXM data sheet's rates, whichever is
   larger); the CE kernels' bound counts their 3xTF32 products (three
   TF32 products for each fp32 one), with the fp32-FMA bound beside it.
   The knn slice's kernels: ``sparse_ce_forward`` / ``_backward`` at the
   knn training shapes (B=256, A=102,025 active rows of the 1M x 512 unit
   shard, labels first, 100 repeated ids, scale 16) and at ragged shapes
   (repeated ids, labels off the shard, a label column listed twice,
   ``mask_hits`` both ways, every column invalid, non-zero bias), through
   ``repro_torch.testing``'s sparse gates: forward m and corr atol 1e-4, z
   rtol 1e-4, hit column exact, amax exact outside near-ties; backward df,
   dW's label rows and dW's other active rows each within BWD_TOL of its
   own max, rows off the active set untouched; both bit-identical across
   two runs; library ``f @ W[ids].T``. They too take their products in
   3xTF32, and the plain versions with 1xTF32 products must fail the
   sparse gates at the training shapes.
   ``dist_topk``: 1,024 unit rows in bf16 against all 1,020,250 (values
   within 1e-5, ids equal except at reported near-ties below 1e-5),
   integer-valued inputs with duplicated rows (ids exact: the lowest
   column), k' > Nk, ``col_offset``, a depth of 72 and depths of 1,024,
   2,048, 3,072, 7,168 and 8,192 (600 x 20,000 unit rows; kimi-K2's and
   chameleon-34B's widths), bit-identical across two
   runs; timed on 16,896 rows (the earlier design's one wave of blocks)
   against all keys, the plain version and the library's bf16 ``q @ K.T``
   in 1,024-row chunks. Its main time, pass 1 over all rows, comes from
   the knn phase.
3. serving (a main path): ``Experiment.from_config(system="paper",
   classes=1_020_250, feat_dim=512)`` with the ``full`` head on the
   ``kernel`` backend, random weights from a seed; ``serve(batch=64)`` and
   ``serve(batch=64, top_k=5, return_scores=True)`` through the serving
   engine, with every kernel's launch counter set to 0 just before and
   read just after (each must have launched). The results are checked
   for shape, range and order, against the ``ref`` backend on the same
   weights and queries, and greedy ids against the top-1 of the top-5.
4. launcher: ``repro_torch.launch.serve`` replaying 0.5 s of the bursty
   Zipfian trace through the engine at the same width.
5. training (the main path of the training slice): the same width with
   ``batch=256``, LARS and FCCS batch growth (``eta0=0.4``, ``t_warm=2``,
   ``b0=b_min=256``, ``b_max=1024``, ``t_ini=2``, ``t_final=6``), on the
   ``kernel`` backend; ``fit(6, use_fccs_batch=True)`` runs micro-batch
   counts 1, 1, 1, 2, 4, 4, so ``ce_forward`` and ``ce_backward`` must
   each launch exactly 13 times between the counters' reset and their
   reading. Losses must be finite and W must move. Then 3 steps on the
   ``kernel`` and ``ref`` backends from the same initial weights on the
   same batches: losses within rtol 1e-4 and max|dW| <= 1e-4 * max|W|.
   Before that, one batch's head gradient through ``loss_local`` on both
   backends from the same W: the label rows and the other rows each within
   BWD_TOL of their own max.
   Step time (host clock, synchronised, n_micro=1), samples/s, one
   profiled step and peak memory are printed.
6. train launcher: ``python -m repro_torch.launch.train`` for 4 steps
   with ``--fccs`` at the same width; it must exit 0 with a finite
   accuracy.
7. knn training (the main path of the knn slice): the same experiment
   with ``HeadConfig(softmax_impl="knn", knn_k=16, knn_kprime=32,
   active_frac=0.1, rebuild_every=4, knn_pad_random=True)``; the counters
   are set to 0 before the experiment is made (it builds the exact 1M x 1M
   graph) and read after ``fit(6, use_fccs_batch=True)``, which rebuilds
   it after step 3: ``sparse_ce_forward`` and ``_backward`` must each
   launch 13 times, ``dist_topk`` twice (one ring hop a build).
   ``label_recall`` must be 1.0 on every step, losses finite, W moved. The
   graph build is timed apart (pass 1, merge + pass 2, copy,
   compression); step time, samples/s, a profiled step (its costliest
   device kernels printed) and peak memory as for the full head. Then 3
   steps on the kernel and the ref backend from the same W and the same
   kernel-built graph, without fillers or rebuilds: losses within rtol
   1e-4, max|dW| <= 1e-4 * max|W|.
8. the train launcher again with ``--head knn``.
9. the four remaining heads (the main paths of the heads slice), each
   with the experiment of phase 5 and Table 2's ratios: ``selective`` (4
   tables of 8 bits, 32 classes a bucket, 10% active classes), ``mach``
   and ``csoft`` (R = 4 repetitions of N // 16 = 63,765 buckets),
   ``sampled`` (102,025 uniform draws). Every counter is set to 0 just
   before ``fit(6, use_fccs_batch=True)`` and read just after:
   ``sparse_ce_forward`` and ``_backward`` 13 times each for selective and
   sampled, ``ce_forward`` and ``ce_backward`` 52 times each (once a
   repetition) for mach and csoft, nothing else. FCCS batches, finite
   losses, selective's ``label_recall`` 1.0 and sampled's ``sample_frac``
   0.1 on every step, the params moved; the head gradient of one batch on
   the kernel and the ref backend from the same params (label rows, or the
   labels' buckets, and the other rows each within BWD_TOL of their own
   max|ref|; sampled with both draws). The step at n_micro = 1 (median of
   5), one profiled step, peak memory, ``evaluate`` on 1,024 rows (its
   peak memory apart) and greedy serving of 64 queries through the engine
   (median of 5). At MACH's bucket shard ([256, 63,765] x 512 on a view
   of repetition 1, scale 1, limit = B) ``ce_forward`` / ``_backward``
   through the CE gates, bit-identical, with the emulated 1xTF32 fault
   failing both, a W 4 bytes off 16-byte alignment refused, times and
   bounds; at the sampled head's draws (A = 102,025, bias -logQ,
   ``mask_hits``; uniform, then log_uniform with its repeated ids) the
   sparse pair through the sparse gates, bit-identical, times and bounds.
   Then the train launcher with each head for 2 steps, and the serve
   launcher's greedy serving with each head, in this process.
10. the paper's own trainer (the main path of the cnn slice):
   ``sku100m_resnet.config_1m()`` (ResNet-50, D = 512, 1,020,250 classes,
   bf16 convs over fp32 params) through ``Experiment.from_config(system=
   "paper", model=...)`` on 224 x 224 synthetic images in micro-batches of
   128, the ``full`` head on the ``kernel`` backend, LARS, FCCS from 256
   to 1,024 images (micro-batch counts 2, 2, 2, 4, 8, 8) and
   ``DGCConfig(enabled=True, backend="kernel")`` at its defaults (sparsity
   0.999, momentum 0.9, factor masking, chunks of 2,048, 4 MiB groups).
   Every counter is set to 0 just before ``fit(6)`` and read just after:
   ``ce_forward`` and ``ce_backward`` 26 times each, ``stage1_topk`` 26 a
   step (one a group of the trunk's gradients), nothing else; finite
   losses, the trunk and W moved. On one step's FE gradients
   ``dgc_exchange`` on the kernel backend against the ref backend: the
   26 thresholds bit-equal, and equal to a full sort's; the updates, u and
   v equal; 26 launches. The exchange timed (host, median of 5) and
   profiled, its two stages timed group by group (stage 1 beside its
   bound and ``torch.topk``; stage 2's sort). The step at n_micro 1 and 2
   (median of 5), the same step without DGC, one step taken apart by CUDA
   events (trunk forward and backward, head forward and backward,
   ``dgc_exchange``, LARS) and one profiled; compression from the step's
   metrics (about 500). ``evaluate`` and greedy and top-5 ``serve`` of 64
   image queries (timed through the engine, counters read). Then 2 steps
   of the trunk in fp32 on the kernel and the ref backend (head and DGC):
   losses within rtol 1e-4. Last, the train launcher with ``--trunk cnn
   --dgc --backend kernel`` at the same class count (its reduced ResNet on
   32 x 32 images) with the full head and with ``--head knn``, in this
   process.
10b. checkpoints (the main path of the checkpoint slice), after phase 10:
   ResNet-50 + DGC at the same width, ``fit(6)`` twice from one state;
   bit-equal snapshots (``resilience.tree_compare`` on the card) make
   ``"bitwise"`` the class the recovery is held to, otherwise
   ``"trajectory"`` (losses within the harness's 1e-4 relative) with the
   differing leaves and one micro-step's gradients run twice named. Then
   ``resilience.kill_and_recover``: the victim checkpoints every 4 steps
   (``build/chip_ckpt``, in this slice's codec) and is killed before step
   5; every kernel counter is set to 0 just before the resumed leg (a
   fresh experiment, ``restore``, steps 4 and 5 replayed) and read after:
   ``{'ce_forward': 16, 'ce_backward': 16, 'stage1_topk': 52}``. Printed:
   the verdict, max |diff|, the restored step and steps replayed, save and
   restore seconds, the file's bytes, the codec, host peak RSS and card
   peak memory, and the n_micro = 1 step with cuDNN's deterministic
   algorithms beside its default (measured, not used). The knn head on
   the feats trunk: 4 steps past a graph refresh, saved, restored into a
   fresh experiment (snapshots bitwise, the one-step-stale graph
   included), one more step on each (bitwise). The full head's fitted IVF
   index (1,010 clusters) saved, restored onto the card, installed, and
   top-5 of 64 queries equal before and after. The train launcher with
   ``--ckpt-dir --ckpt-every 2 --steps 4``, then ``--resume --steps 6``
   from t = 4. The files are removed at the end.
11. IVF serving (the main path of the IVF slice): ``ivf_rerank`` against
   its plain version at ragged shapes (pads, rows with fewer real
   candidates than k, rows with nothing, repeated candidates, ids past the
   shard, A not a multiple of the kernel's segment, k up to 32,
   integer-valued inputs with exact ties: ids exact in candidate-position
   order), each through both entries (the generic one on cand, the probed
   one on cand cut into clusters: the two must agree bit for bit), and at
   D = 2,048, 3,072, 7,168 and 8,192 through the probed entry (one
   query a tile at the widest; clusters with more
   queries than a tile, a cluster nobody probes), bit-identical across two
   runs. Then the same 1M-class experiment as phase 3: the IVF
   index is fit twice (timed by part: Lloyd, scores and short preference
   lists, claim), the two fits must be bit-identical and every valid row
   packed exactly once; ``ivf_rerank``'s counter is set to 0, then
   ``serve(batch=64, top_k=5, return_scores=True, index="ivf")`` runs and
   the counter must have moved. That result is held against the ``ref``
   backend on the same index and queries (scores within 1e-5, ids equal
   except where adjacent scores lie within 1e-5), the kernel's probed entry
   (the one serving launches, on the index's members and the queries'
   probes, B=64, P=31 x cap 1,263) against its plain version (values
   within 1e-5, ids equal except at near-ties, bit-identical, the generic
   entry's bits on the same candidates), and with all 64 queries on the
   first query's 31 clusters (skew); timed at B=64 and B=1 (a different
   query each launch) and skewed, beside the generic entry, its plain
   version and the gathered ``einsum`` (the bounds from the union of the
   probed rows' bytes), ``nprobe=C`` against the exact top-5
   (ids equal except at near-ties), batch latency exact vs IVF top-5 at
   batch 64 and 1 (host clock, median of 10) and one profiled IVF serve.
   Last, clustered class rows at full width (15,941 centres, offset 0.3;
   the port's copy of the JAX test's construction) are installed, the
   index refit, and recall@5 against the exact scan printed at nprobe 2 and
   31 for 256 near-prototype queries (reported, not gated).
12. the serve launcher with ``--index ivf --topk 5 --replay 0.5`` at the
   same width.
13. flash attention: ``flash_attention`` against its plain version at the
   JAX test's sweep (``tests/test_flash_kernel.py``: ragged Sq != T
   non-causal, a window of 100, Dh 32/64/128) plus Dh 96 and 256, rows
   with no valid key (Sq=300, T=100, causal, window 50: exactly 0) and
   grouped KV heads (g = 8; g = 3 on a ragged S), in fp32 (within 2e-5)
   and bf16 (the gate below), and at BH = 70,000 heads of 40 causal rows;
   then at the zoo prefill's shapes (BH = 72 query heads over 24 KV heads,
   S = T = 2,000, Dh = 64, bf16, causal): the bf16 gate with its emulated
   faults, bit-identical across two runs, timed beside its plain version and
   ``scaled_dot_product_attention`` on the [8, 9, 2000, 64] view with
   ``enable_gqa`` (and on KV heads expanded beforehand); and at the zoo
   trainer's ``evaluate`` shapes (BH = 144 over 48 KV heads, S = T = 512,
   Dh = 64, bf16, causal): the bf16 gate, bit-identical, timed.
14. zoo serving (the main path of the zoo slice):
   ``Experiment.from_config(system="zoo", arch="smollm_135m")`` at its
   full width (30 layers, bf16 over fp32 params, random weights from seed
   0) on the ``kernel`` backend; every kernel's counter is set to 0 just
   before ``serve(prompt_len=2000, gen=48, batch=8)`` and read just after:
   ``flash_attention`` must have launched exactly 30 times (once a layer
   of the prefill). Tokens [8, 48] in range. Against the ``ref`` backend
   on the same weights and prompts: the prefill's final hidden states
   within ZOO_H_TOL of max|h| in bf16 and ZOO_H32_TOL in fp32 compute,
   the first greedy tokens equal except on rows whose top-2 logit gap is
   below twice the logits' kernel-vs-ref difference, and the agreement
   over all 48 tokens (reported). Prefill and decode times (median of 5
   serves), tok/s, one profiled prefill and decode step (the flash
   kernel's share, the device time of copies and of casts, and the idle
   share) and peak memory.
15. the serve launcher with ``--system zoo`` at the same shapes; it must
   return 0 and launch ``flash_attention``.
16. zoo training (the main paths of the zoo trainer): SmolLM-135M at its
   published width and depth, 16 x 512 = 8,192 tokens a step, SGD at lr
   0.5, on the ``kernel`` backend (the trunk trains on the ``ref``
   attention: the flash kernel has no backward). Every counter is set to
   0 just before each path and read just after, and must equal
   ``ZOO_WANT`` (written in PERF.md before the first run): ``fit(4)``
   with the full head (``ce_forward`` and ``ce_backward`` 4 times each,
   raw logits at scale 1), ``evaluate`` (``ce_forward`` 1, and
   ``flash_attention`` 30: no grad there), ``fit(4)`` at two
   micro-batches (8 each), the knn head (k 16, k' 32, 10% active, rebuilt
   every 2 steps: the sparse pair 4 times each, ``dist_topk`` 3, once a
   build; ``label_recall`` equal to Algorithm 1's, which is below 1 here:
   8,192 tokens carry ~7,300 distinct labels, more than the 4,915 active
   slots; 1.0 on every step of a ``fit(2)`` at 8 x 512 tokens), MACH
   (R = 4 x 3,072 buckets, ``fit(2)``: the CE pair 8 times each). Losses
   finite, the head and a trunk weight moved. ``evaluate``'s picks
   against the ``ref`` backend on the same params and batch: its accuracy
   is its kernel path's, features within ZOO_H_TOL, logits within
   ZOO_LOGIT_TOL, picks equal but at near-ties. Against the ``ref``
   backend from the same params and batch: one step's loss within
   ZOO_LOSS_RTOL; the tied table's gradient within ZOO_TABLE_GRAD_STEPS
   bf16 steps of its max (its embedding part is formed in bf16), and every
   leaf within ZOO_GRAD32_TOL in fp32 compute; the updated tables within lr
   times that; the table's head gradient (label rows and other rows)
   within BWD_TOL of its max. MACH likewise: its loss, the bucket block's
   gradient within BWD_TOL, and the CE pair at its [8,192, 3,072] block
   through the CE gates and the 1xTF32 emulation. The CE pair at [8,192, 49,152]
   x 576 through the CE gates (bit-identical runs; the 1xTF32 emulation
   must fail both), the sparse pair at the knn active set through the
   sparse gates, ``dist_topk`` over the table's 49,152 rows; each timed
   beside its plain version, the library call and the bound. The step at
   n_micro 1 and 2 (host clock, median of 5), tokens/s, one profiled step
   (idle share, kernels by group, the costliest kernels), peak memory.
17. zoo retrieval on the trained full-head experiment: top-5 of 64 queries
   (the JAX package's default pool) through the serving engine, exact
   (``stage1_topk`` 1) and through the IVF index (``ivf_rerank`` 1), each
   held against the ``ref`` backend (scores within IVF_TOL, ids equal but
   at near-ties), batch latencies (median of 10), both kernels at these
   shapes against their plain versions.
18. the train launcher with ``--system zoo`` at the same width for 2 steps
   with the full and the knn head, and the serve launcher's zoo top-5,
   exact and with ``--index ivf``; each must return 0.
19. the ssm and hybrid families' serving (their main paths): mamba2-370M
   (48 layers, d_model 1,024, d_state 128, vocab 50,280) and hymba-1.5B
   (32 layers, d_model 1,600, 25 query heads over 5 KV heads in a sliding
   window of 1,024 beside 25 SSM heads, vocab 32,001) at their published
   widths and half their depths (FAM_LAYERS: 24 and 16 layers), random
   weights from seed 0, on the ``kernel``
   backend: every counter set to 0 just before ``serve(prompt_len=2000,
   gen=48, batch=8)`` and read just after (``FAM_WANT``: nothing for
   mamba2, whose greedy head is dense; ``flash_attention`` 16 for hymba,
   once a layer). A prefill of 2,000 tokens and one decode step against a
   prefill of 2,001 (``tests/test_decode.py``'s check): in fp32 compute
   the features within FAM_CONT32_TOL and every greedy token equal; in
   bf16 the same readings, reported. hymba against the ``ref`` backend:
   the prefill's last ZOO_TOKEN_ROWS positions (features within
   FAM_H_TOL, logits within FAM_LOGIT_TOL, tokens equal but where the
   ref's top-2 gap is below twice the kernel-free bf16 spread of the
   decode check), and in fp32 compute every served token equal. Prefill
   and decode times (the median of the main path's serve and FAM_REPS
   more), one profiled prefill and decode step, peak memory.
20. ``flash_attention`` at hymba's prefill shapes (q [200, 2,000, 64] over
   40 KV heads, bf16, causal, window 1,024): the bf16 gate, bit-identical
   across two runs, timed beside its plain version and SDPA with the
   window as a boolean mask.
21. the families' training (their main paths), at FAM_TRAIN_DEPTH (12
   of mamba2's layers, 8 of hymba's): the
   full head on 16 x 512 tokens a step (the stream's first batch, every
   step) in FAM_MICRO micro-batches, SGD at lr 0.5, ``fit(5)`` with every counter set to 0
   just before and read just after (the CE pair once a micro-step);
   losses finite and falling, the params moved; step 1's loss within
   ZOO_LOSS_RTOL of the ``ref`` backend's; the step (the median of the
   fit's steps 2 to 5, their synchronised spans),
   tokens/s, a profiled step, peak memory; the CE pair at [tokens a
   micro-batch, V] x D: on the trained batch (where p - 1 may cancel at
   the labels) the backward through the CE gate with a floor of
   CE_OWN_ROUNDING times the plain version's own rounding (against itself
   in fp64), which 1xTF32 products must fail; on a held-out batch
   through the CE gates and the 1xTF32 emulation, timed beside its bound
   and ``f @ W.T``; one layer's SSD at chunk 256
   against the token-by-token recurrence in fp32 (FAM_SCAN_TOL), its
   gradient finite, and the dt gradient with the JAX package's order (exp
   before the mask) with its NaN count reported. mamba2's trained state
   saved and restored into a fresh experiment: the snapshots bit-equal,
   save and restore seconds by part. On each trained experiment, every
   counter reset just before each leg and read just after (``FAM_WANT``):
   ``evaluate``, and top-5 of 64 queries exact and through the IVF index,
   both against the ``ref`` backend (scores within IVF_TOL, ids equal but
   at near-ties); then each of the six heads one step at 2 x 512 tokens
   on a finite loss, and the next batch's loss from that state on the
   kernel backend within ZOO_LOSS_RTOL of the ref backend's. At
   hymba's shapes (FAM_GATED) the sparse CE pair (the knn head's active
   set), ``dist_topk`` (the graph build over all 32,001 rows at D 1,600),
   ``stage1_topk`` and ``ivf_rerank`` against their plain versions, as
   the SmolLM-135M phases hold them, timed beside their bounds.
22. the zoo's checkpoints at SmolLM-135M's width, the full and the knn
   head, a checkpoint every 2 steps: two uninterrupted ``fit(6)`` runs
   compared bit for bit set the class ``kill_and_recover`` is held to;
   killed before step 5, a fresh experiment restores t = 4 and replays 4
   and 5 with every counter reset just before that leg (``FAM_WANT``);
   save and restore seconds by part, bytes, host and card peaks. Then the
   train launcher's ``--system zoo --ckpt-every 2 --steps 4`` and
   ``--resume --steps 6``. The files are removed at the end.
23. the moe and vlm families' serving, training and heads (their main
   paths), phases 19-21 at qwen3-moe-30B-A3B's published width (2,048
   wide, 32 / 4 heads of 128, 128 experts top-8 of d_ff 768, vocab
   151,936; 4 layers to serve, 3 to train) and chameleon-34B's (8,192
   wide, 64 / 8 heads of 128, d_ff 22,016, vocab 65,536; 4 layers to
   serve, 2 to train), the cut depths reckoned at ``FAM_LAYERS``: the
   serve's flash attention once a layer; the decode step against the
   prefill one token longer (the moe family row by row at a capacity
   factor of E / k, where nothing drops), kernel vs ref as hymba's;
   ``flash_attention``
   at the prefill's shapes, g 8 over 2,000 tokens; ``fit(5)`` at one
   micro-batch of 16 x 512 tokens, step 1 against the ref backend's loss
   from the same params, the share of (token, expert) pairs dropped past
   capacity, and (qwen3-moe) a first ``fit(5)`` run before it that it
   must equal bit for bit; the CE pair at [8,192, V] x D through the
   floor gate (the fp32 plain version's own rounding passes 2e-5 of its
   max over these sums); then ``evaluate``, exact and IVF top-5 and each
   head one step, the trained params waiting on the host, with the
   sparse pair, ``dist_topk``, ``stage1_topk`` and ``ivf_rerank`` at
   these shapes against their plain versions.
24. the encdec family, whisper-tiny at its published width and depth (4 +
   4 layers, 384 wide, 6 heads of 64, 1,500 frames, vocab 51,865):
   ``fit(5)`` at 16 x 448 tokens (its text context) over the stream's
   frames, ``evaluate`` (the encoder's flash attention non-causal over
   1,500 frames, the decoder's causal), each head one step and the
   kernels at its shapes as in phase 23, ``flash_attention`` at its
   encoder's shapes; a greedy decode of 48 tokens for 8 rows through
   ``lm.decode`` with the cross caches, every counter reset around it
   (``FAM_WANT``: the prefill's flash attention a layer), and in fp32 the
   kernel and ref backends' tokens equal and the decode step against the
   prefill one token longer.
25. remat: SmolLM-135M ``fit(5)`` at 16 x 512 tokens in one micro-batch
   with ``remat`` none and full (``ParallelConfig.remat`` through the
   step builder's ``par``), every counter reset around each fit
   (``REMAT_WANT``): the launches, the losses (bit-equal, or the first
   step where they part, reported), peaks and steps; mamba2-370M and
   hymba-1.5B in one micro-batch with remat: peak and step.
26. the dry run against the card: ``launch.dryrun.lower_paper_one`` of
   the paper's full step (1,020,250 x 512, B 256, SGD, kernel backend)
   and ``lower_one`` of SmolLM's step (remat none and full), on the
   host's meta device: argument bytes and the predicted peak beside the
   real step's bytes and ``torch.cuda.max_memory_allocated``, the ledger
   held to the counted collectives; then one member's bytes at 10^8
   classes x 512 on rings of 64 and 256 (B 4,096).
27. the roofline of real steps: one paper full step and one SmolLM step
   (each remat) counted on the card by ``roofline.counter.WorkCounter``
   (the kernels charged by their cost functions): compute and memory
   terms against the measured step, the share of the roofline it
   reaches; the collective term is 0 on a ring of one.
28. the grid (``dist.grid``): SmolLM-135M at full width ``fit(3)`` at 16 x
   512 tokens, SGD at lr 0.5, on the ring and on a (1, 1) grid in this
   process, every counter reset around each fit (``GRID_WANT``), losses
   bit-equal; then a (1, 2) grid of two gloo processes on this card (the
   grid's collectives staged through pinned host memory), each member's
   losses against the (1, 1) grid's (within GRID_LOSS_RTOL, the members
   equal) and the norm of its fit's whole change to the params against
   the (1, 1) grid's (within GRID_UPDATE_RTOL), its peak beside the dry run's prediction for member (0, 0) of
   (1, 2) (``launch.dryrun.lower_deep``, remat none); then on each member
   ``evaluate``, exact and IVF top-5 and a knn ``fit(1)``, every counter
   reset around each leg (``GRID_LEGS``: every kernel on the member's
   shard), the members' answers equal. The host-only dry runs
   (``GRID_DRY``, ``lower_deep`` on the meta device, remat full,
   ``train_4k``, FSDP: SmolLM-135M, qwen3-moe-30B-A3B and kimi-K2 on 16 x
   16, kimi-K2 on 2 x 16 x 16) run in one subprocess started after the
   build, beside the card's phases: each one's member rows,
   micro-batches, argument and peak bytes, and whether the peak fits the
   card.
29. the grid's families (``grid_families_phase``): mamba2-370M and
   hymba-1.5B at full width and FAM_TRAIN_DEPTH (12 and 8 layers) and
   whisper-tiny at full width and depth, ``fit(3)`` in one
   micro-batch of 16 x 512 tokens (whisper 16 x 448 over 1,500 frames)
   with remat full, SGD at lr 0.5, on a (1, 1) grid in this process (the
   vocab padded as on (1, 2)), then the three in turn on one (1, 2) grid
   of two gloo processes: each member's leaves its ``param_pspecs``
   blocks (mamba2's ``in_proj`` 2,192 columns, hymba's whole with its
   ``norm_scale`` 800, whisper's MLP 768), its losses and the norm of its
   whole update against the (1, 1) grid's (``GRID_FAM_LOSS_RTOL``,
   ``GRID_FAM_UPDATE_RTOL``), its launches by leg (``GRID_FAM_LEGS``:
   fit, evaluate, exact and IVF top-5, and for mamba2 and hymba 64 x
   2,000 prompts and 48 greedy tokens), its peak beside the dry run's
   (1, 2) prediction at the same depth, the members' answers equal; then the (1, 2) save of
   whisper restored on a (1, 1) grid (``restore(reshard=True)``): the
   params bit-equal to the gathered save, the next step's loss within the
   same limit. The dry runs add mamba2 and hymba
   ``train_4k`` as member (0, 0) of 16 x 16.
30. the paper system on a ring of two processes (``paper_ring_phase``):
   the ring of one in this process, then ``dist.spawn_ring`` of two gloo
   processes on this card (collectives staged through pinned host
   memory), each holding 510,125 of the 1,020,250 x 512 rows, every
   counter reset around each leg (``RING_LEGS``): the full head
   ``fit(4)`` of 256 a step in two micro-batches (LARS, FCCS held), in
   turn and overlapped (``hybrid.make_train_step(overlap=)``): losses, W
   shards and LARS moments bit-equal, every loss within RING_LOSS_RTOL of
   the ring of one's, step times and ``train.gather_wait_s`` of both;
   greedy, exact top-5 and IVF top-5 of 64 queries (the IVF index also
   probed at every cluster), the ids equal to the ring of one's on the
   gathered W; ResNet-50 + DGC ``fit(3)`` at 224 x 224, 64 images a
   member a micro-batch, both schedules bit-equal (trunk, W, moments,
   DGC u and v); the knn head ``fit(2)`` with its graph built over the
   ring (``label_recall``); each member's peaks. Then the train launcher
   (``--system paper --share-cards --classes 1020250 --feat-dim 512
   --batch 256 --steps 4 --fccs``) and the serve launcher's ``--topk 5``
   and ``--topk 5 --index ivf`` under ``torchrun --standalone
   --nproc-per-node 2``, the three at once: each exits 0 and prints its
   result line once. kimi-K2's peak after the in-place accumulation is
   the grid phase's dry run.
31. the examples (``examples_phase``), in this process: first every
   kernel against its plain version at the small shapes of
   ``scripts/smoke_torch.sh``'s legs (``SMALL_SHAPES``: class shards of
   16 to 128 rows, D 16 to 64, k' 16; ivf_rerank through both entries),
   then ``examples/quickstart_torch.py`` as it is (4,096 classes, the knn
   head, 150 steps of FCCS growth to 1,024),
   ``examples/train_sku_cnn_torch.py --classes 1020250 --steps 20`` (the
   reduced ResNet at D 128 under a 0.52 GB head, knn at 20% active, DGC)
   and ``examples/serve_lm_torch.py`` for smollm_135m and mamba2_370m,
   every counter reset around each (``EXAMPLES_WANT``). Each kernel
   entry copies the inputs of its first call at each distinct shape
   during an example (``captured_calls``), and after the example each
   copy is held against the kernel's plain version on the same inputs
   (``check_captured``): the examples' own shapes. Then the results'
   lines and finite values; the quickstart's accuracy is logged beside
   the JAX example's CPU figure (``JAX_CPU_ACC``).

The kernels' bounds (``bound_ms``, ``ce_bounds``, ``_flash_bound``,
``ivf_union_bytes``) are their modules' cost functions'
(``repro_torch.kernels.cost``), the counts the roofline counter charges.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, one ``{"end_to_end": ...}`` line and, last, ``{"ok": true,
"device": {...}}``. Without a CUDA card, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
B, V, D, K = 64, 1_020_250, 512, 5          # configs/sku100m_resnet.config_1m
BTRAIN = 256                                 # training micro-batch
# ce_backward: max|kernel - plain| <= BWD_TOL * max|plain| for df, dW's label
# rows and dW's other rows, each against its own max; the training shapes
# read at most 1.0e-5 on an H100 (df: fp32 sums over V in another order),
# 8e-7 for dW; the head gradient, kernel vs ref backend, 7e-7
BWD_TOL = 2e-5
FIT_STEPS, FIT_LAUNCHES = 6, 1 + 1 + 1 + 2 + 4 + 4   # n_micro per step
CHUNK = 2048                                 # ops.topk_rows' chunk
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet (roofline.hardware)
# dist_topk timing slice, kept from the earlier design's one wave of 132
# blocks of 128 rows (66 blocks of 256 rows now); pass 1 over every row is
# timed in the knn phase
QSLICE = 132 * 128
# the zoo's knn heads' depths (ROADMAP A.9.2): SmolLM-135M's neighbours,
# qwen3-moe's 2,048, and kimi-K2's 7,168 and chameleon-34B's 8,192, which
# dist_topk and ivf_rerank take since their D cap was lifted (ROADMAP B)
DEEP_DIMS = (1024, 2048, 3072, 7168, 8192)
HOPPER_KERNELS = ("flash_attention", "knn_dist_topk",  # wgmma + TMA
                  "ce_softmax_fwd", "ce_softmax_bwd", "sparse_ce_fwd",
                  "sparse_ce_bwd")
KNN_K, KPRIME, ACTIVE_FRAC = 16, 32, 0.1    # the knn head (launch/train.py)
# the four remaining heads at the 1M-class width, with the paper's Table 2
# ratios: MACH and CSoft R = 4 repetitions of N // 16 buckets; the sampled
# head draws 10% of the classes (the knn head's active share); selective
# keeps its defaults of 4 tables of 8 bits, 32 classes a bucket, and the
# knn head's 10% active classes
SKETCH_B, SKETCH_R = V // 16, 4
HEAD_CFGS = {
    "selective": dict(softmax_impl="selective", active_frac=ACTIVE_FRAC),
    "mach": dict(softmax_impl="mach", mach_b=SKETCH_B, mach_r=SKETCH_R),
    "sampled": dict(softmax_impl="sampled", sampled_n=int(V * ACTIVE_FRAC)),
    "csoft": dict(softmax_impl="csoft", csoft_b=SKETCH_B, csoft_r=SKETCH_R),
}
# the kernels without warpgroup products, redesigned to stream by 1-D bulk
# copies (TMA without a map): their SASS must hold UBLKCP, and ptxas must
# report no spills
FMA_KERNELS = ("ivf_rerank", "topk_stage1")
# DGC's stage 1 (src/repro/core/sparsify.py): k of each 2,048-wide chunk
# of one group of 512 rows, |N(0, 1)| values
DGC_ROWS, DGC_CHUNK, DGC_K = 512, 2048, 1048
# the paper's own trainer (ResNet-50 + DGC): 224 x 224 images in
# micro-batches of 128 (the fp32 trunk's kernel vs ref losses too); the FE
# gradients pack into 26 groups of 4 MiB, one stage1_topk launch each
RES_HW, RES_MICRO, RES_DGC_GROUPS = 224, 128, 26
# device kernels by part, by name: the DGC selection's two stages, the CE
# pair, the trunk's convolutions and GroupNorm
KERNEL_GROUPS = {"stage 1 (stage1_topk)": ("topk_stage1",),
              "stage 2 sort": ("radixsort", "radix_sort", "sort"),
              "CE pair": ("ce_fwd", "ce_bwd", "ce_softmax", "ce_dw",
                          "ce_df"),
              "convolutions": ("conv", "xmma", "cudnn", "gemm", "wgrad",
                               "dgrad", "fprop"),
              "GroupNorm": ("group_norm", "groupnorm", "rowwisemoments",
                            "computefusedparams", "gammabeta")}
# checkpoints: kill and recover runs 6 steps, checkpointing every 4 and
# killed before step 5, so one checkpoint (t = 4) is written and steps 4
# and 5 are replayed
CKPT_DIR = ROOT / "build" / "chip_ckpt"
CKPT_TOTAL, CKPT_EVERY, CKPT_KILL = 6, 4, 5
IVF_TOL = 1e-5       # ivf_rerank: fp32 dot products of D terms in another order
RECALL_QUERIES = 256
# flash_attention vs its plain version (the TPU kernel's arithmetic: p =
# exp(s scale - m) in fp32, rounded to bf16 before p.v). fp32: max abs
# error, fp32 sums in another order. bf16: per element |out - plain| <=
# one bf16 step of |plain| (2^-7 |plain|: outputs rounded to bf16 from fp32
# sums in another order land one step apart) + FLASH_BF16_ATOL + the flip
# bound, read as the largest ratio of the two sides; and mean|out - plain|
# / mean|plain| <= FLASH_BF16_MEAN_TOL, which a diffuse fault (p left
# unrounded) breaks. The flip bound (flash_flip_bound) is what a p can move
# an output by when the kernel rounds it to bf16 on the other side of a
# boundary: the kernel's p is 2^(s sl2 - m) by one FMA and ex2.approx over
# fp32 sums in another order, within ~2^-18.5 of the plain version's p
# (an emulation of both on the CPU, Dh 32 to 256), so a p that lies within
# FLASH_FLIP_EPS (2^-16) of a bf16 rounding boundary may round either way.
# Outside such p's the bound is 0, and in a short row one such flip moves
# an output by up to a bf16 step of p times |v| over l, past the fixed part
# of the gate. On an H100 SXM (700 W) the kernel reads 0.68 at the
# prefill's shapes with no output past the fixed part, at most 0.79 over
# the sweep; at 70,000 heads of 40 causal rows 3.1 without the flip bound
# and 0.90 with it, the same from eps 2^-20 up (the phase logs 2^-24 and
# 2^-20 beside the gate), 0.90 being one bf16 step of an output (at most
# 2^-6 / (2^-6 + 1e-3) = 0.94 just above a power of two). p left unrounded
# reads 2.03, the ragged last key tile dropped 56. The flash phase runs
# such emulated faults through the gate at the prefill's shapes and fails
# if one passes.
FLASH_FP32_TOL = 2e-5
BF16_STEP, FLASH_BF16_ATOL, FLASH_BF16_MEAN_TOL = 2.0 ** -7, 1e-3, 1e-4
FLASH_FLIP_EPS = 2.0 ** -16
# (bh, sq, t, dh, causal, window, g): tests/test_flash_kernel.py's sweep,
# then Dh 96 and 256, then rows >= 149 with no valid key, then grouped KV
# heads (g query heads a KV head: 8, and SmolLM's 3 on a ragged S)
FLASH_SWEEP = [(4, 256, 256, 64, True, 0, 1), (2, 200, 300, 32, False, 0, 1),
               (3, 256, 256, 64, True, 100, 1), (1, 512, 512, 128, True, 0, 1),
               (2, 192, 192, 96, True, 0, 1), (2, 130, 130, 256, True, 0, 1),
               (2, 300, 100, 32, True, 50, 1), (8, 256, 256, 64, True, 0, 8),
               (6, 333, 333, 64, True, 0, 3)]
FLASH_MANY_HEADS = 70_000    # past the earlier 65,535-head grid limit
# the zoo serve: SmolLM-135M, 9 query heads of 64 over 3 KV heads; 2,000 +
# 48 = 2,048 tokens, its context
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN, ZOO_HEADS, ZOO_HEAD_DIM = 8, 2000, 48, 9, 64
ZOO_KV_HEADS = 3
ZOO_REPS = 5
# prefill hidden states, kernel vs ref backend, max abs difference over
# max|h|: bf16 activations through 30 layers, where the ref backend rounds
# the normalised probabilities to bf16 and the kernel the unnormalised ones
ZOO_H_TOL = 5e-2
# greedy logits of the last ZOO_TOKEN_ROWS prompt positions of every row,
# kernel vs ref backend: max abs difference over max|logit| (1.25e-2 on an
# H100 SXM). A greedy token may differ only where the ref's top-2 gap is
# below twice this bound
ZOO_LOGIT_TOL, ZOO_TOKEN_ROWS = 2e-2, 256
ZOO_H32_TOL = 1e-4     # the same in fp32 compute: sums in another order
# the zoo trainer: SmolLM-135M at its published width and depth (30
# layers, d_model 576, 9 query over 3 KV heads, vocab 49,152, bf16 over
# fp32 params), 16 sequences of 512 tokens a step (8,192 tokens, one
# micro-batch by auto_micro_batches), SGD (momentum 0.9) at lr 0.5, random
# weights from seed 0. The knn head at the train launcher's k, k' and
# active share, rebuilt every 2 steps; MACH with Table 2's ratios (R = 4
# repetitions of V // 16 buckets)
ZOO_TB, ZOO_TS, ZOO_STEPS, ZOO_LR = 16, 512, 4, 0.5
ZOO_V, ZOO_D = 49_152, 576
ZOO_KNN = dict(softmax_impl="knn", knn_k=KNN_K, knn_kprime=KPRIME,
               active_frac=ACTIVE_FRAC, rebuild_every=2)
ZOO_MACH = dict(softmax_impl="mach", mach_b=ZOO_V // 16, mach_r=4)
ZOO_MACH_STEPS = 2
# the launches each zoo path must make, every counter reset just before
# and read just after (PERF.md §6, written before the first run on the
# card): the CE pair once a micro-step (n_micro 1, then 2), once a
# repetition a micro-step for MACH; the sparse pair once a micro-step and
# dist_topk once a graph build (fit's first build and the rebuilds after
# steps 2 and 4) for knn; evaluate's argmax and the flash attention of its
# 30 layers (evaluate runs under no grad, so its trunk takes the kernel);
# one stage1_topk a top-5 serve, one ivf_rerank an IVF top-5 serve
ZOO_WANT = {
    "zoo_training": {"ce_forward": ZOO_STEPS, "ce_backward": ZOO_STEPS},
    "zoo_training_n2": {"ce_forward": 2 * ZOO_STEPS,
                        "ce_backward": 2 * ZOO_STEPS},
    "zoo_evaluate": {"ce_forward": 1, "flash_attention": 30},
    "zoo_knn_training": {"sparse_ce_forward": ZOO_STEPS,
                         "sparse_ce_backward": ZOO_STEPS, "dist_topk": 3},
    "zoo_mach_training": {"ce_forward": 4 * ZOO_MACH_STEPS,
                          "ce_backward": 4 * ZOO_MACH_STEPS},
    "zoo_retrieval": {"stage1_topk": 1},
    "zoo_ivf_retrieval": {"ivf_rerank": 1},
}
ZOO_LOSS_RTOL = 1e-4   # one step's loss, kernel vs ref backend
# the tied table's gradient of one batch, kernel vs ref backend from the
# same params. In the step's own precision its embedding part is formed in
# bf16, so the kernels' fp32-level differences in df move it by whole bf16
# steps (read: 2 steps of max|ref|, with or without the features upcast
# before the head): within ZOO_TABLE_GRAD_STEPS bf16 steps of max|ref|. In
# fp32 compute throughout only the sums' order differs (read 1.8e-6): every
# leaf within ZOO_GRAD32_TOL of its max|ref| (PERF.md §6)
ZOO_TABLE_GRAD_STEPS = 4
ZOO_GRAD32_TOL = 1e-5
ZOO_RET_B = 64         # zoo retrieval: 64 queries, top-5
# the ssm and hybrid families at their published width and depth, random
# weights from seed 0, bf16 over fp32 params: mamba2-370M (48 layers,
# d_model 1,024, 32 SSM heads of 64, d_state 128, vocab 50,280) and
# hymba-1.5B (32 layers, d_model 1,600, 25 query heads over 5 KV heads of
# 64 in a sliding window of 1,024 beside 25 SSM heads of 64, d_state 16,
# d_ff 5,504, vocab 32,001), both at chunk 256. Serving: the zoo serve's 8
# prompts of 2,000 tokens (past hymba's window: its K/V slots rotate) and
# 48 greedy tokens. Training: the full head on 16 x 512 tokens a step in
# FAM_MICRO micro-batches (what fits on 80 GB: without remat every layer
# keeps its SSD products, [b, 2, 256, 256, heads] fp32, and hymba its fp32
# attention scores), SGD at lr 0.5, FAM_STEPS steps
FAMILIES = ("mamba2_370m", "hymba_1_5b")
_ARCH = {"ssm": "mamba2_370m", "hybrid": "hymba_1_5b"}
FAM_MICRO = {"mamba2_370m": 4, "hymba_1_5b": 4}
FAM_STEPS, FAM_REPS = 5, 2
# their training and heads phases, and the grid families phase, run a
# quarter of the layers, their serving half (FAM_LAYERS), to keep the
# script inside its time limit (PERF.md §4); their remat phase runs all
FAM_TRAIN_DEPTH = {"mamba2_370m": 12, "hymba_1_5b": 8}
# a prefill of S tokens and one decode step against a prefill of S + 1 in
# fp32 compute: the chunked scan's sums against the recurrence's, ~1e-6
FAM_CONT32_TOL = 1e-4
# one layer's chunked scan at chunk 256 against the token-by-token
# recurrence, fp32: outputs and final states, each over its max
FAM_SCAN_TOL = 1e-4
# hymba's prefill, kernel vs ref backend in bf16 (the last ZOO_TOKEN_ROWS
# positions of every row): features over max|h|, greedy logits over
# max|logit|. bf16 alone moves these deep stacks further than SmolLM's:
# the decode step against the prefill one token longer (the same
# arithmetic in another order, no kernel) read 3.5e-2 / 2.6e-2 for hymba
# and 2.8e-2 / 2.6e-2 for mamba2 on an H100 SXM; the kernel path against
# ref read 3.0e-2 on the logits. A greedy token may differ only where the
# ref's top-2 gap is below twice that kernel-free spread, as this run
# reads it (not twice the bound: that would leave few positions checked).
# The strict check is in fp32 compute, where every served token must be
# equal
FAM_H_TOL, FAM_LOGIT_TOL = 1e-1, 5e-2
# the family whose retrieval and knn shapes hold sparse_ce, dist_topk,
# stage1_topk and ivf_rerank against their plain versions: hymba's D of
# 1,600 and odd vocab of 32,001 are the furthest from the shapes checked
# before (D 512 and 576)
FAM_GATED = "hymba_1_5b"
# the zoo's kill and recover: a checkpoint every 2 steps, killed before
# step 5 (CKPT_KILL), so t = 4 is restored and steps 4 and 5 replayed
ZOO_CKPT_EVERY = 2
# the launches each new path must make, every counter reset just before
# and read just after (PERF.md §6, written before the first run on the
# card): mamba2's serve launches no kernel (its greedy head is the dense
# serve_logits_local, as in the JAX package); hymba's prefill takes the
# flash kernel once a layer; training the CE pair once a micro-step; the
# zoo's resumed legs replay 2 steps (knn's graph rebuilt after step 5).
# On each family's trained experiment: evaluate's argmax (ce_forward; and
# a flash attention for each of hymba's trained layers: evaluate runs
# under no grad), one
# stage1_topk a top-5 serve, one ivf_rerank an IVF top-5 serve; one step
# of each head at 2 x 512 tokens (one micro-batch): the CE pair for full,
# the sparse pair for knn (and dist_topk for the graph built before it),
# selective and sampled, the CE pair once a repetition (R = 4) for MACH
# and CSoft
_FAM_LEGS = {
    "retrieval": {"stage1_topk": 1},
    "ivf_retrieval": {"ivf_rerank": 1},
    "full_step": {"ce_forward": 1, "ce_backward": 1},
    "knn_step": {"sparse_ce_forward": 1, "sparse_ce_backward": 1,
                 "dist_topk": 1},
    "selective_step": {"sparse_ce_forward": 1, "sparse_ce_backward": 1},
    "sampled_step": {"sparse_ce_forward": 1, "sparse_ce_backward": 1},
    "mach_step": {"ce_forward": 4, "ce_backward": 4},
    "csoft_step": {"ce_forward": 4, "ce_backward": 4},
}
# the moe, vlm and encdec families (ROADMAP A.9.2) at their published
# widths, random weights from seed 0, bf16 over fp32 params:
# qwen3-moe-30B-A3B (d_model 2,048, 32 query heads over 4 KV heads of 128,
# 128 experts top-8 of d_ff 768, vocab 151,936, untied) and chameleon-34B
# (d_model 8,192, 64 query heads over 8 KV heads of 128, d_ff 22,016,
# vocab 65,536, untied, qk-norm) at cut depths, and whisper-tiny (4 + 4
# layers, d_model 384, 6 heads of 64, 1,500 frames, vocab 51,865, tied) at
# its full depth. A layer holds ~623 M params (qwen3-moe) or ~692 M
# (chameleon), 2.49 / 2.77 GB in fp32, beside 2.49 / 4.29 GB of embedding
# and head; training keeps params, gradients and SGD momentum in fp32, the
# bf16 copies and activations of 8,192 tokens, and the update's new
# moments and steps (two more copies of the params) at its peak:
# (serve, train) depths that fit 80 GB with room for the phases' second
# experiments, and keep the whole script inside its time limit. On an H100
# SXM qwen3-moe at 4 layers peaked at 77.2 GB alone and ran out in its
# update after the script's earlier phases (7 GB of the allocator's cache
# reserved but free), and chameleon at 3 ran out in its update alone: they
# train 3 and 2
NEW_FAMILIES = ("qwen3_moe_30b_a3b", "chameleon_34b")
ENCDEC = "whisper_tiny"
_ARCH.update(moe="qwen3_moe_30b_a3b", vlm="chameleon_34b", encdec=ENCDEC)
FAM_LAYERS = {"qwen3_moe_30b_a3b": (4, 3), "chameleon_34b": (4, 2),
              "mamba2_370m": (24, None), "hymba_1_5b": (16, None)}
FAM_MICRO.update({"qwen3_moe_30b_a3b": 1, "chameleon_34b": 1, ENCDEC: 1})
# the CE pair's gate on the trained batch takes its first 2,048 rows (its
# fp64 reference holds a few [rows, V] tensors; the families' micro-batch)
FAM_GATE_ROWS = 2048
# whisper's text context: 16 rows of 448 tokens a step (7,168 tokens)
FAM_SEQ = {ENCDEC: 448}
# whisper's greedy decode through the cross caches: 8 rows of frames, a
# decoder prompt of 4 tokens, 48 greedy tokens
WHISPER_B, WHISPER_PROMPT = 8, 4
FAM_WANT = {
    "ssm_serving": {},
    "hybrid_serving": {"flash_attention": FAM_LAYERS["hymba_1_5b"][0]},
    "ssm_training": {"ce_forward": FAM_STEPS * FAM_MICRO["mamba2_370m"],
                     "ce_backward": FAM_STEPS * FAM_MICRO["mamba2_370m"]},
    "hybrid_training": {"ce_forward": FAM_STEPS * FAM_MICRO["hymba_1_5b"],
                        "ce_backward": FAM_STEPS * FAM_MICRO["hymba_1_5b"]},
    "ssm_evaluate": {"ce_forward": 1},
    "hybrid_evaluate": {"ce_forward": 1,
                        "flash_attention": FAM_TRAIN_DEPTH["hymba_1_5b"]},
    **{f"{fam}_{leg}": want for fam in ("ssm", "hybrid")
       for leg, want in _FAM_LEGS.items()},
    # the new families: the prefill's flash attention once a layer at the
    # serve depth (4); the CE pair once a step (one micro-batch); evaluate
    # the CE forward and a flash attention a layer at the train depth
    # (whisper: 4 encoder layers, non-causal, and 4 decoder layers); the
    # whisper decode's prefill a flash attention a layer, its decode steps
    # none (the ref branches over the caches)
    "moe_serving": {"flash_attention": FAM_LAYERS["qwen3_moe_30b_a3b"][0]},
    "vlm_serving": {"flash_attention": FAM_LAYERS["chameleon_34b"][0]},
    **{f"{fam}_training": {"ce_forward": FAM_STEPS, "ce_backward": FAM_STEPS}
       for fam in ("moe", "vlm", "encdec")},
    "moe_evaluate": {"ce_forward": 1,
                     "flash_attention": FAM_LAYERS["qwen3_moe_30b_a3b"][1]},
    "vlm_evaluate": {"ce_forward": 1,
                     "flash_attention": FAM_LAYERS["chameleon_34b"][1]},
    "encdec_evaluate": {"ce_forward": 1, "flash_attention": 8},
    "encdec_decode": {"flash_attention": 8},
    **{f"{fam}_{leg}": want for fam in ("moe", "vlm", "encdec")
       for leg, want in _FAM_LEGS.items()},
    "zoo_checkpoint_full": {"ce_forward": 2, "ce_backward": 2},
    "zoo_checkpoint_knn": {"sparse_ce_forward": 2, "sparse_ce_backward": 2,
                           "dist_topk": 1},
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - _T0:.0f}s] {msg}",
          flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up,
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Median host wall-clock of ``fn`` (which returns host arrays), after
    a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_ms(torch, fn, groups=None, device_only: bool = False) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host wall-clock,
    the device time of the kernels it ran, the device's idle share, and
    the costliest kernels by name; with ``groups`` ({label: substrings}),
    also the device time of the kernels whose full name holds one of a
    label's substrings (case-insensitive). ``device_only``: ``fn`` has
    run before and the tracer has been set up, so the warm-up call and
    the set-up's profiled call are spared, and the device alone is traced
    (a step of tens of thousands of host ops otherwise costs the profiler
    a minute to take apart)."""
    from torch.profiler import ProfilerActivity, profile
    if not device_only:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([] if device_only
                                            else [ProfilerActivity.CPU])
    # the first profiled call of a process also pays the tracer's set-up
    for _ in range(1 if device_only else 2):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels: dict = {}          # device ms by (shortened) kernel name
    # by full name: copies (torch's direct_copy kernels, memcpys) and the
    # dtype casts (its <dtype>_copy kernels)
    copy_ms = cast_ms = 0.0
    averages = prof.key_averages()
    for e in averages:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            name = e.key[:90]
            ms = e.self_device_time_total / 1e3
            kernels[name] = kernels.get(name, 0.0) + ms
            if "direct_copy" in e.key or "memcpy" in e.key.lower():
                copy_ms += ms
            elif "_copy_kernel" in e.key:
                cast_ms += ms
    busy = sum(kernels.values())
    if busy <= 0:
        fail("the profiler saw no device time in a profiled call")
    top = sorted(kernels.items(), key=lambda k: -k[1])[:8]
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall),
           "copy_ms": copy_ms, "cast_ms": cast_ms,
           "top_kernels_ms": dict(top)}
    if groups:
        by = dict.fromkeys(groups, 0.0)
        for e in averages:
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            name = e.key.lower()
            for label, subs in groups.items():
                if any(sub.lower() in name for sub in subs):
                    by[label] += e.self_device_time_total / 1e3
                    break
        out["device_ms_by_group"] = by
    return out


def bound_ms(cost):
    """(least ms, "bytes" or "operations") of a kernel call's cost: the
    kernel module's own cost function (``repro_torch.kernels.cost``), the
    one count of its work that the roofline counter also charges."""
    from repro_torch.kernels.cost import bound_ms as cost_bound
    return cost_bound(cost)


def ce_bounds(cost) -> dict:
    """A CE kernel's bounds from its cost (``forward_cost`` /
    ``backward_cost`` of its module): its products as 3xTF32 on the
    tensor cores (three TF32 products each; the kernels' design), and on
    CUDA cores in fp32 FMA, each against its bytes."""
    from repro_torch.kernels.cost import as_fp32_fma
    t32, by32 = bound_ms(cost)
    fma, by_fma = bound_ms(as_fp32_fma(cost))
    return {"bound_ms": t32, "bound_by": by32, "bound_fp32_fma_ms": fma,
            "bound_fp32_fma_by": by_fma}


def hopper_path_check(build):
    """The kernels rebuilt on wgmma and TMA really use them: their SASS
    holds HGMMA (warpgroup products) and UTMALDG (TMA tile loads), and
    ``ptxas`` reports no spills for them."""
    libs = build.build_all()
    for stem in HOPPER_KERNELS:
        sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                               str(libs[stem])], capture_output=True,
                              text=True, check=True).stdout
        counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
        if not all(counts.values()):
            fail(f"{stem}: its SASS lacks the Hopper path {counts}")
        spills = [line.strip() for line in
                  libs[stem].with_suffix(".log").read_text().splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        if spills:
            fail(f"{stem} spills: {spills}")
        log(f"build: {stem} SASS {counts}, no spills")


def fma_kernel_check(build):
    """The redesigned FMA kernels: their SASS holds the bulk copies, no
    spills, and their ``ptxas`` lines."""
    libs = build.build_all()
    for stem in FMA_KERNELS:
        sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                               str(libs[stem])], capture_output=True,
                              text=True, check=True).stdout
        if "UBLKCP" not in sass:
            fail(f"{stem}: its SASS holds no bulk copy (UBLKCP)")
        log(f"build: {stem} SASS UBLKCP x{sass.count('UBLKCP')}")
        log_lines = libs[stem].with_suffix(".log").read_text().splitlines()
        spills = [line.strip() for line in log_lines
                  if "spill" in line and " 0 bytes spill stores" not in line]
        if spills:
            fail(f"{stem} spills: {spills}")
        for line in log_lines:
            if "registers" in line:
                log(f"build: {stem} ptxas: {line.strip()}")
        log(f"build: {stem} no spills")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def check_ce(torch, ce, f, w, y, limit, scale=1.0, label=""):
    """ce_forward's kernel vs ce_forward_plain on the same card tensors,
    through ``repro_torch.testing.ce_forward_gate`` (m and corr atol 1e-4,
    z rtol 1e-4, amax equal except at top-2 gaps below 1e-5), twice: the
    two kernel runs must agree bit for bit. Returns the largest absolute
    error of m and corr, and the largest relative error of z."""
    from repro_torch import testing
    out = ce.ce_forward(f, w, y, limit=limit, scale=scale)
    again = ce.ce_forward(f, w, y, limit=limit, scale=scale)
    yl = torch.where((y >= 0) & (y < w.shape[0]), y, -1).to(torch.int32)
    lim = max(0, min(int(limit), w.shape[0]))
    ref = ce.ce_forward_plain(f, w, yl, lim, scale)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"ce_forward {label}: two runs on the same inputs differ")
    gate = testing.ce_forward_gate(out, ref, f, w, lim, scale)
    if not gate["ok"]:
        rows = gate["amax_rows"][:8]
        fail(f"ce_forward {label}: {gate['failed']} fail; m/corr max abs err "
             f"{gate['m_corr_err']:.3g} (atol {testing.CE_ATOL:g}), z max rel "
             f"err {gate['z_rel_err']:.3g} (rtol {testing.CE_Z_RTOL:g}), amax "
             f"rows {rows} kernel {out[3][rows].tolist()} plain "
             f"{ref[3][rows].tolist()}")
    # m and corr are scores; z is a sum over V terms, so its error is
    # relative
    return gate["m_corr_err"], gate["z_rel_err"]


def check_topk(torch, dc, x, k, chunk=None, label=""):
    v1, i1 = dc.stage1_topk(x, k, chunk=chunk)
    v2, i2 = dc.stage1_topk_plain(x, k, chunk)
    torch.cuda.synchronize()
    if not torch.equal(v1, v2):
        bad = (v1 != v2).any(dim=1).nonzero()[:4, 0].tolist()
        fail(f"stage1_topk values {label}: rows {bad} kernel "
             f"{v1[bad].tolist()} plain {v2[bad].tolist()}")
    if not torch.equal(i1, i2):
        bad = (i1 != i2).any(dim=1).nonzero()[:4, 0].tolist()
        fail(f"stage1_topk ids {label}: rows {bad} kernel "
             f"{i1[bad].tolist()} plain {i2[bad].tolist()}")
    return 0.0


def topk_lib():
    """The loaded stage1_topk library, its argument types set."""
    from repro_torch.kernels import build
    lib = build.library("topk_stage1")
    lib.topk_stage1_smem.argtypes = [ctypes.c_int] * 2
    return lib


def kernel_phase(torch, ce, dc, sharded):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    # -- small ragged shapes: masking, labels off the shard, ties, -inf ----
    b, v, d = 37, 5013, 36
    f = torch.randn((b, d), generator=g, device=dev)
    w = torch.randn((v, d), generator=g, device=dev) * 0.1
    y = torch.randint(0, v, (b,), generator=g, device=dev, dtype=torch.int32)
    y[:4] = torch.tensor([-1, v + 3, v - 1, 4500], device=dev,
                         dtype=torch.int32)      # off shard, masked column
    check_ce(torch, ce, f, w, y, v, 1.0, "ragged")
    check_ce(torch, ce, f, w, y, 4000, 16.0, "ragged limit=4000")
    check_ce(torch, ce, f, w, y, 0, 1.0, "all masked")
    fb = torch.randn((200, d), generator=g, device=dev)  # 4 batch tiles
    yb = torch.randint(-1, v, (200,), generator=g, device=dev,
                       dtype=torch.int32)
    check_ce(torch, ce, fb, w[:100].contiguous(), yb, 100, 1.0,
             "200 rows x 100 classes")
    # integer-valued inputs make every product exact, so duplicated rows
    # tie exactly and amax must take the lowest column
    fi = torch.randint(-3, 4, (b, d), generator=g, device=dev).float()
    wi = torch.randint(-3, 4, (v, d), generator=g, device=dev).float()
    wi[4000:4100] = wi[17]
    wi[2500] = wi[17]
    m, _, _, a = ce.ce_forward(fi, wi, y, limit=v)
    m2, _, _, a2 = ce.ce_forward_plain(fi, wi, torch.where(
        (y >= 0) & (y < v), y, -1), v)
    if not (torch.equal(a, a2) and torch.equal(m, m2)):
        fail("ce_forward ties: amax or m differ from the plain version")

    x = torch.randn((7, 3000), generator=g, device=dev)
    x = torch.round(x * 4) / 4                   # many exact ties
    x[2] = float("-inf")                         # a row with nothing
    x[3, 100:] = float("-inf")                   # a row short of k
    check_topk(torch, dc, x, 7, 512, "ragged chunks")
    check_topk(torch, dc, x[:, :100].contiguous(), 5, None, "n <= chunk")
    check_topk(torch, dc, x, 16, 2048, "ragged 2048")
    check_topk(torch, dc, x[:, :2500], 7, 512, "strided rows")
    x[4, 10:20] = 0.0
    x[4, 15:18] = -0.0                           # -0 ties +0: lowest index
    check_topk(torch, dc, x, 256, 512, "k = chunk / 2")
    check_topk(torch, dc, x, 512, 512, "k = chunk")
    check_topk(torch, dc, x[:, 1:], 16, 512, "rows 4 bytes off")
    check_topk(torch, dc, x[:, 3:], 300, 2048, "rows 12 bytes off")
    check_topk(torch, dc, x, 5, 4096, "chunk 4,096")
    check_topk(torch, dc, x, 2048, 4096, "chunk 4,096, k 2,048")
    xl = torch.randn((3, 20000), generator=g, device=dev)
    check_topk(torch, dc, xl, 33, 10000, "chunk 10,000 (two-byte counters)")
    lib = topk_lib()
    for chunk, k in ((2048, 5), (2048, 1048), (4096, 2048), (10000, 33)):
        if lib.topk_stage1_smem(chunk, k) != dc.cuda_smem_bytes(chunk, k):
            fail(f"stage1_topk: the wrapper's shared-memory limit for chunk "
                 f"{chunk}, k {k} is not the kernel's")
    log("kernel phase: ragged shapes agree with the plain versions")

    # -- the serving shapes ------------------------------------------------
    fs = sharded._normalize(torch.randn((B, D), generator=g, device=dev))
    ws = sharded._normalize(torch.randn((V, D), generator=g, device=dev))
    ys = torch.randint(0, V, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    ys[::7] = -1
    ce_err, z_rel = check_ce(torch, ce, fs, ws, ys, V, 1.0, "serving shapes")
    logits = fs @ ws.T
    # V = 1,020,250 is 2 mod 4: every odd row starts 8 bytes off 16
    tk_err = check_topk(torch, dc, logits, K, CHUNK, "serving shapes")
    grp = torch.randn((DGC_ROWS, DGC_CHUNK), generator=g, device=dev).abs()
    check_topk(torch, dc, grp, DGC_K, DGC_CHUNK, f"k = {DGC_K}")
    log(f"kernel phase: serving shapes agree, ce_forward bit-identical "
        f"across runs (m/corr max abs err {ce_err:.3g}, z max rel err "
        f"{z_rel:.3g})")

    yl = torch.where(ys >= 0, ys, -1)
    ce_ms = cuda_ms(torch, lambda: ce.ce_forward(fs, ws, ys, limit=V), 20)
    ce_plain = cuda_ms(torch, lambda: ce.ce_forward_plain(fs, ws, yl, V), 5)
    nch = -(-V // CHUNK)
    tk_ms = cuda_ms(torch, lambda: dc.stage1_topk(logits, K, chunk=CHUNK), 50)
    tk_plain = cuda_ms(torch, lambda: dc.stage1_topk_plain(logits, K, CHUNK),
                       5)
    padded = torch.nn.functional.pad(logits, (0, nch * CHUNK - V),
                                     value=float("-inf")).reshape(-1, CHUNK)
    tk_lib = cuda_ms(torch, lambda: torch.topk(padded, K, dim=1), 50)
    del padded
    dgc_ms = cuda_ms(torch, lambda: dc.stage1_topk(grp, DGC_K,
                                                   chunk=DGC_CHUNK), 50)
    dgc_plain = cuda_ms(torch, lambda: dc.stage1_topk_plain(grp, DGC_K,
                                                           DGC_CHUNK), 1)
    dgc_lib = cuda_ms(torch, lambda: torch.topk(grp, DGC_K, dim=1), 50)
    dgc_bound, dgc_by = bound_ms(dc.cost(DGC_ROWS, DGC_CHUNK, DGC_K,
                                         DGC_CHUNK))
    ce_lib = cuda_ms(torch, lambda: fs @ ws.T, 20)     # the product alone

    ce_bound = ce_bounds(ce.forward_cost(B, V, D))
    log(f"kernel phase: ce_forward at B={B} {ce_ms:.3f} ms (3xTF32 bound "
        f"{ce_bound['bound_ms']:.3f} ms by {ce_bound['bound_by']}, fp32-FMA "
        f"{ce_bound['bound_fp32_fma_ms']:.3f}), plain {ce_plain:.3f} ms, "
        f"f @ W.T {ce_lib:.3f} ms")
    # the logits read once and the candidates written; one compare an
    # element (the selection's least work, whatever k is)
    tk_bound, tk_by = bound_ms(dc.cost(B, V, K, CHUNK))
    log(f"kernel phase: stage1_topk k={K} on [{B}, {V}] {tk_ms:.4f} ms "
        f"(bound {tk_bound:.4f} by {tk_by}), plain {tk_plain:.3f}, torch.topk "
        f"{tk_lib:.3f}; k={DGC_K} on [{DGC_ROWS}, {DGC_CHUNK}] {dgc_ms:.4f} ms "
        f"(bound {dgc_bound:.4f} by {dgc_by}), plain {dgc_plain:.1f}, "
        f"torch.topk {dgc_lib:.4f}")
    return {
        "ce_forward": dict(
            name="ce_forward", route="cuda",
            source="src/repro_torch/kernels/csrc/ce_softmax_fwd.cu",
            replaces="src/repro/kernels/ce_softmax.py:106",
            max_abs_err=ce_err, z_max_rel_err=z_rel, ms=ce_ms,
            plain_ms=ce_plain, **ce_bound,
            library_ms=ce_lib, library="f @ W.T (cuBLAS fp32, TF32 off)",
            shape=f"f[{B},{D}] W[{V},{D}]"),
        "stage1_topk": dict(
            name="stage1_topk", route="cuda",
            source="src/repro_torch/kernels/csrc/topk_stage1.cu",
            replaces="src/repro/kernels/topk_dc.py:46",
            max_abs_err=tk_err, ms=tk_ms, plain_ms=tk_plain,
            bound_ms=tk_bound, bound_by=tk_by, library_ms=tk_lib,
            shape=f"x[{B},{V}] chunk {CHUNK} k {K}",
            dgc_k=DGC_K, dgc_ms=dgc_ms, dgc_plain_ms=dgc_plain,
            dgc_bound_ms=dgc_bound, dgc_bound_by=dgc_by,
            dgc_library_ms=dgc_lib,
            dgc_shape=f"x[{DGC_ROWS},{DGC_CHUNK}] |N(0,1)| k {DGC_K}"),
    }


def ce_bwd_plain64(torch, ce, f, w, y, m, gz, gc, limit, scale, rows=1024):
    """``ce_backward_plain`` in fp64, a block of rows at a time (df's rows
    are independent, dW sums the blocks' parts in fp64): the floor gate's
    reference at shapes whose [B, V] fp64 passes do not fit at once."""
    w64 = w.double()
    df = torch.empty(f.shape, dtype=torch.float64, device=f.device)
    dw = torch.zeros(w.shape, dtype=torch.float64, device=f.device)
    for r in range(0, f.shape[0], rows):
        sl = slice(r, r + rows)
        d_f, d_w = ce.ce_backward_plain(
            f[sl].double(), w64, y[sl], m[sl].double(), gz[sl].double(),
            gc[sl].double(), limit, scale)
        df[sl] = d_f
        dw += d_w
        del d_f, d_w
    return df, dw


def check_ce_bwd(torch, ce, f, w, y, m, gz, gc, limit, scale, label,
                 floor=False):
    """ce_backward's kernel vs ce_backward_plain on the same card tensors,
    twice: the two kernel runs must agree bit for bit. Each part is held
    against its own max|plain|: df, dW's label rows, and dW's other rows,
    whose only term is the softmax one (it is orders of magnitude below the
    one-hot term of the label rows, so a shared scale would not see it).
    The gate is ``repro_torch.testing.ce_backward_gate`` (BWD_TOL);
    ``floor``: ``testing.ce_backward_floor_gate`` against the plain version
    in fp64 (``ce_bwd_plain64``), for sums so long (V = 151,936 or D =
    8,192) that the fp32 plain version's own rounding passes BWD_TOL of
    its max. Returns {part: (max abs err, max abs err / max|plain|)}."""
    from repro_torch import testing
    df1, dw1 = ce.ce_backward(f, w, y, m, gz, gc, limit=limit, scale=scale)
    df2, dw2 = ce.ce_backward(f, w, y, m, gz, gc, limit=limit, scale=scale)
    yl = torch.where((y >= 0) & (y < w.shape[0]), y, -1).to(torch.int32)
    lim = max(0, min(int(limit), w.shape[0]))
    pdf, pdw = ce.ce_backward_plain(f, w, yl, m, gz, gc, lim, scale)
    torch.cuda.synchronize()
    if not (torch.equal(df1, df2) and torch.equal(dw1, dw2)):
        fail(f"ce_backward {label}: two runs on the same inputs differ")
    del df2, dw2
    if floor:
        rel = testing.ce_backward_gate(df1, dw1, pdf, pdw, yl)
        gate = testing.ce_backward_floor_gate(
            df1, dw1, pdf, pdw, *ce_bwd_plain64(torch, ce, f, w, yl, m, gz,
                                                gc, lim, scale), yl)
        log(f"ce_backward {label}: floor gate (err, err / max, plain's own "
            f"rounding against fp64) {gate['parts']}; the relative gate "
            f"alone fails {rel['failed']}")
        torch.cuda.empty_cache()
        if not gate["ok"]:
            fail(f"ce_backward {label}: {gate['failed']} fail the floor "
                 f"gate: {gate['parts']}")
        return {k: (e, r) for k, (e, r, _) in gate["parts"].items()}
    gate = testing.ce_backward_gate(df1, dw1, pdf, pdw, yl)
    if not gate["ok"]:
        fail(f"ce_backward {label}: {gate['failed']} fail; max abs err (of "
             f"max|plain|) by part {gate['parts']}, gate {BWD_TOL:g}")
    return gate["parts"]


def backward_kernel_phase(torch, ce, sharded):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def inputs(b, v, d, w_scale=0.1):
        f = torch.randn((b, d), generator=g, device=dev)
        w = torch.randn((v, d), generator=g, device=dev) * w_scale
        y = torch.randint(0, v, (b,), generator=g, device=dev,
                          dtype=torch.int32)
        gz = torch.randn((b,), generator=g, device=dev)
        gc = torch.randn((b,), generator=g, device=dev)
        return f, w, y, gz, gc

    # -- small ragged shapes: B and V off the tiles, masks, -inf rows -------
    f, w, y, gz, gc = inputs(37, 5013, 36)
    y[:4] = torch.tensor([-1, 5013 + 3, 5012, 4500], device=dev,
                         dtype=torch.int32)      # off shard, masked column
    ragged = {}
    for limit, scale in ((5013, 1.0), (4000, 16.0), (0, 1.0)):
        m = ce.ce_forward(f, w, y, limit=limit, scale=scale)[0]
        if limit == 5013:
            m[5:7] = float("-inf")               # rows with nothing live
        ragged[f"limit={limit}"] = check_ce_bwd(
            torch, ce, f, w, y, m, gz, gc, limit, scale, f"ragged limit={limit}")
    f, w, y, gz, gc = inputs(300, 1000, 64)      # two 256-row chunks
    m = ce.ce_forward(f, w, y, limit=1000)[0]
    ragged["300 rows"] = check_ce_bwd(torch, ce, f, w, y, m, gz, gc, 1000,
                                      1.0, "300 rows")
    # 70 rows (two 64-row tiles for df), D = 612: two 512-feature groups,
    # a last 32-deep slab and 64-feature block cut short
    f, w, y, gz, gc = inputs(70, 3000, 612, w_scale=0.05)
    check_ce(torch, ce, f, w, y, 2900, 4.0, "70 rows, D=612")
    m = ce.ce_forward(f, w, y, limit=2900, scale=4.0)[0]
    ragged["D=612"] = check_ce_bwd(torch, ce, f, w, y, m, gz, gc, 2900, 4.0,
                                   "70 rows, D=612")
    log("kernel phase: ce_backward ragged shapes agree with the plain "
        "version, bit-identical across runs; max abs err / max|plain| by "
        "part: " + "; ".join(
            f"{case} {part} {r:.3g}" for case, parts in ragged.items()
            for part, (_, r) in parts.items()))

    # -- the training shapes: unit rows, scale 16, the loss's cotangents ---
    ft = sharded._normalize(torch.randn((BTRAIN, D), generator=g, device=dev))
    wt = sharded._normalize(torch.randn((V, D), generator=g, device=dev))
    yt = torch.randint(0, V, (BTRAIN,), generator=g, device=dev,
                       dtype=torch.int32)
    m, z, _, _ = ce.ce_forward(ft, wt, yt, limit=V, scale=16.0)
    gz = 1.0 / (BTRAIN * z)                      # d mean(log z) / dz
    gc = torch.full_like(z, -1.0 / BTRAIN)       # d mean(-corr) / dcorr
    # the loss's cotangents, then the softmax term alone (gc = 0): with the
    # one-hot term present it dominates df, and the softmax term's share of
    # df is below any tolerance relative to the one-hot's
    parts = {}
    for term, gct in (("loss", gc), ("softmax term", torch.zeros_like(gc))):
        for part, v in check_ce_bwd(torch, ce, ft, wt, yt, m, gz, gct, V, 16.0,
                                    f"training shapes, {term}").items():
            parts[f"{part}, {term}"] = v
    err = max(e for e, _ in parts.values())
    rel = max(r for _, r in parts.values())
    log("kernel phase: ce_backward at training shapes agrees, bit-identical "
        "across runs; max abs err (of max|plain|) by part: " + "; ".join(
            f"{k} {e:.3g} ({r:.3g})" for k, (e, r) in parts.items()))
    fwd_err, fwd_z = check_ce(torch, ce, ft, wt, yt, V, 16.0,
                              "training shapes")
    fault = tf32_fault(torch, ce, ft, wt, yt, m, gz, gc)
    ms = cuda_ms(torch, lambda: ce.ce_backward(ft, wt, yt, m, gz, gc,
                                               limit=V, scale=16.0), 5)
    plain = cuda_ms(torch, lambda: ce.ce_backward_plain(
        ft, wt, yt, m, gz, gc, V, 16.0), 3)
    lib = cuda_ms(torch, lambda: ft @ wt.T, 10)
    fwd = cuda_ms(torch, lambda: ce.ce_forward(ft, wt, yt, limit=V,
                                               scale=16.0), 10)
    bound = ce_bounds(ce.backward_cost(BTRAIN, V, D))
    fwd_bound = ce_bounds(ce.forward_cost(BTRAIN, V, D))
    log(f"kernel phase: ce_backward {ms:.3f} ms (3xTF32 bound "
        f"{bound['bound_ms']:.3f} ms by {bound['bound_by']}, fp32-FMA "
        f"{bound['bound_fp32_fma_ms']:.3f}), plain {plain:.3f} ms, f @ W.T "
        f"{lib:.3f} ms; ce_forward at B={BTRAIN} {fwd:.3f} ms (3xTF32 bound "
        f"{fwd_bound['bound_ms']:.3f} ms by {fwd_bound['bound_by']}, "
        f"fp32-FMA {fwd_bound['bound_fp32_fma_ms']:.3f}; m/corr max abs err "
        f"{fwd_err:.3g}, z max rel err {fwd_z:.3g})")
    return dict(
        name="ce_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/ce_softmax_bwd.cu",
        replaces="src/repro/kernels/ce_softmax.py:184",
        max_abs_err=err, ms=ms, plain_ms=plain, **bound,
        library_ms=lib, library="f @ W.T (cuBLAS fp32, TF32 off)",
        max_rel_err=rel,
        rel_err_by_part={k: r for k, (_, r) in parts.items()},
        tf32_fault=fault,
        ce_forward_train={"ms": fwd, "max_abs_err": fwd_err,
                          "z_max_rel_err": fwd_z,
                          **{k: v for k, v in fwd_bound.items()}},
        shape=f"f[{BTRAIN},{D}] W[{V},{D}]")


def tf32_fault(torch, ce, f, w, y, m, gz, gc, limit=V, scale=16.0,
               label="the training shapes"):
    """The plain versions with their products emulated in 1xTF32 (each
    operand rounded to TF32 once: a kernel that dropped the 3xTF32 lo
    terms) must fail both CE gates at the training shapes (and at MACH's
    bucket shard), or the gates could not tell the design from plain TF32.
    Returns the readings."""
    from repro_torch import testing
    yl = torch.where((y >= 0) & (y < w.shape[0]), y, -1).to(torch.int32)
    fwd = testing.ce_forward_gate(
        testing.ce_forward_tf32(f, w, yl, limit, scale, 1),
        ce.ce_forward_plain(f, w, yl, limit, scale), f, w, limit, scale)
    bwd = testing.ce_backward_gate(
        *testing.ce_backward_tf32(f, w, yl, m, gz, gc, limit, scale, 1),
        *ce.ce_backward_plain(f, w, yl, m, gz, gc, limit, scale), yl)
    out = {"forward_failed": fwd["failed"], "forward_m_corr_err":
           fwd["m_corr_err"], "forward_z_rel_err": fwd["z_rel_err"],
           "backward_failed": bwd["failed"],
           "backward_rel_err_by_part": {k: r for k, (_, r) in
                                        bwd["parts"].items()}}
    log(f"kernel phase: CE products emulated in 1xTF32 at {label}: {out}")
    if fwd["ok"] or bwd["ok"]:
        fail("the CE gates pass products in 1xTF32: they cannot tell the "
             "3xTF32 design from plain TF32")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the knn slice's kernels: sparse_ce forward / backward, dist_topk
# ---------------------------------------------------------------------------


def check_sparse(torch, sp, f, w, ids, gids, bias, valid, y, scale, mask_hits,
                 gz, gc, label):
    """sparse_ce_forward / _backward's kernels vs their plain versions on
    the same card tensors, each kernel twice: the two runs must agree bit
    for bit. The gates are ``repro_torch.testing.sparse_ce_forward_gate``
    (m and corr atol 1e-4, z rtol 1e-4, the hit column exact, amax exact
    except on rows whose best two kept scores lie within 1e-5) and
    ``sparse_ce_backward_gate`` (df, dW's label rows and dW's other active
    rows each within BWD_TOL of its own max|plain|; rows off the active set
    untouched). Returns {part: error}."""
    from repro_torch import testing
    f1 = sp.sparse_ce_forward(f, w, ids, gids, bias, valid, y, scale=scale,
                              mask_hits=mask_hits)
    f2 = sp.sparse_ce_forward(f, w, ids, gids, bias, valid, y, scale=scale,
                              mask_hits=mask_hits)
    idc = ids.clamp(0, w.shape[0] - 1).to(torch.int32)
    cols = (f, w, idc, gids, bias, valid, y)
    p = sp.sparse_ce_forward_plain(*cols, scale, mask_hits)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(f1, f2)):
        fail(f"sparse_ce_forward {label}: two runs on the same inputs differ")
    gate = testing.sparse_ce_forward_gate(f1, p, *cols, scale, mask_hits)
    if not gate["ok"]:
        rows = gate["amax_rows"][:8]
        fail(f"sparse_ce_forward {label}: {gate['failed']} fail; m/corr max "
             f"abs err {gate['m_corr_err']:.3g} (atol {testing.CE_ATOL:g}), "
             f"z max rel err {gate['z_rel_err']:.3g} (rtol "
             f"{testing.CE_Z_RTOL:g}), amax rows {rows} kernel "
             f"{f1[3][rows].tolist()} plain {p[3][rows].tolist()}")
    out = {"fwd m/corr": gate["m_corr_err"], "fwd z rel": gate["z_rel_err"]}

    b1 = sp.sparse_ce_backward(f, w, ids, gids, bias, valid, y, f1[0], gz, gc,
                               f1[4], scale=scale, mask_hits=mask_hits)
    b2 = sp.sparse_ce_backward(f, w, ids, gids, bias, valid, y, f1[0], gz, gc,
                               f1[4], scale=scale, mask_hits=mask_hits)
    pdf, pdw = sp.sparse_ce_backward_plain(*cols, f1[0], gz, gc, p[4], scale,
                                           mask_hits)
    torch.cuda.synchronize()
    if not (torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])):
        fail(f"sparse_ce_backward {label}: two runs on the same inputs differ")
    gate = testing.sparse_ce_backward_gate(*b1, pdf, pdw, idc, gids, y)
    if not gate["ok"]:
        fail(f"sparse_ce_backward {label}: {gate['failed']} fail; max abs "
             f"err (of max|plain|) by part {gate['parts']}, gate "
             f"{BWD_TOL:g}")
    out.update({k: r for k, (_, r) in gate["parts"].items()})
    return out


def sparse_tf32_fault(torch, sp, f, w, ids, bias, valid, y, m, gz, gc, hit):
    """The sparse plain versions with their products emulated in 1xTF32
    (a kernel that dropped the 3xTF32 lo terms) must fail the forward's
    gate and the backward's at the training shapes. Returns the
    readings."""
    from repro_torch import testing
    cols = (f, w, ids, ids, bias, valid, y)
    fwd = testing.sparse_ce_forward_gate(
        testing.sparse_ce_forward_tf32(*cols, 16.0, False, 1),
        sp.sparse_ce_forward_plain(*cols, 16.0, False), *cols, 16.0, False)
    rows = (m, gz, gc, hit, 16.0, False)
    bwd = testing.sparse_ce_backward_gate(
        *testing.sparse_ce_backward_tf32(*cols, *rows, 1),
        *sp.sparse_ce_backward_plain(*cols, *rows), ids, ids, y)
    out = {"forward_failed": fwd["failed"], "forward_m_corr_err":
           fwd["m_corr_err"], "forward_z_rel_err": fwd["z_rel_err"],
           "backward_failed": bwd["failed"],
           "backward_rel_err_by_part": {k: r for k, (_, r) in
                                        bwd["parts"].items()}}
    log(f"kernel phase: sparse CE products emulated in 1xTF32 at the "
        f"training shapes: {out}")
    if fwd["ok"] or bwd["ok"]:
        fail("the sparse CE gates pass products in 1xTF32: they cannot tell "
             "the 3xTF32 design from plain TF32")
    torch.cuda.empty_cache()
    return out


def sparse_problem(torch, g, b, v, d, a, *, n_dup=0, unit=False, dev):
    """Inputs of the sparse CE kernels: the rows' labels come first in the
    active set, random rows fill it, ``n_dup`` of them repeated."""
    f = torch.randn((b, d), generator=g, device=dev)
    w = torch.randn((v, d), generator=g, device=dev)
    if unit:
        f = f / f.norm(dim=1, keepdim=True)
        w = w / w.norm(dim=1, keepdim=True)
    else:
        w = w * 0.1
    y = torch.randint(0, v, (b,), generator=g, device=dev, dtype=torch.int32)
    lab = torch.unique(y)[: a // 2]
    fill = torch.randint(0, v, (a - lab.numel(),), generator=g, device=dev,
                         dtype=torch.int32)
    if n_dup:
        fill[-n_dup:] = fill[:n_dup]
    ids = torch.cat([lab.to(torch.int32), fill])
    return f, w, ids, y


def sparse_kernel_phase(torch, sp):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(2)

    # -- small ragged shapes ----------------------------------------------
    b, v, d, a = 37, 5013, 36, 777
    f, w, ids, y = sparse_problem(torch, g, b, v, d, a, n_dup=40, dev=dev)
    ids[5] = ids[0]                      # a duplicated label column
    ids[6] = v + 7                       # clipped into [0, V)
    y[:3] = torch.tensor([-1, v + 3, 2 * v], device=dev, dtype=torch.int32)
    gids = ids.clamp(0, v - 1)           # one shard: gids are ids
    valid = (torch.rand((a,), generator=g, device=dev) > 0.1).to(torch.int32)
    valid[0] = 1
    bias = torch.randn((a,), generator=g, device=dev) * 0.5
    gz = torch.randn((b,), generator=g, device=dev)
    gc = torch.randn((b,), generator=g, device=dev)
    ragged = {}
    for mh in (False, True):
        ragged[f"mask_hits={mh}"] = check_sparse(
            torch, sp, f, w, ids, gids, bias, valid, y, 1.0, mh, gz, gc,
            f"ragged mask_hits={mh}")
    f2, w2, ids2, y2 = sparse_problem(torch, g, 200, 1000, 64, 300, n_dup=9,
                                      dev=dev)
    ones = torch.ones(300, dtype=torch.int32, device=dev)
    ragged["200 rows scale 16"] = check_sparse(
        torch, sp, f2, w2, ids2, ids2, torch.zeros(300, device=dev), ones, y2,
        16.0, False, gz.repeat(6)[:200], gc.repeat(6)[:200], "200 rows")
    ragged["all invalid"] = check_sparse(
        torch, sp, f2, w2, ids2, ids2, torch.zeros(300, device=dev),
        torch.zeros_like(ones), y2, 16.0, False, gz.repeat(6)[:200],
        gc.repeat(6)[:200], "all invalid")
    log("kernel phase: sparse_ce ragged shapes agree with the plain versions, "
        "bit-identical across runs; errors " + "; ".join(
            f"{case} {part} {e:.3g}" for case, parts in ragged.items()
            for part, e in parts.items()))

    # -- the knn training shapes: unit rows, scale 16, the loss's cotangents
    a = max(8, int(V * ACTIVE_FRAC))      # the knn head's m_local
    ft, wt, idt, yt = sparse_problem(torch, g, BTRAIN, V, D, a, n_dup=100,
                                     unit=True, dev=dev)
    bias = torch.zeros(a, device=dev)
    valid = torch.ones(a, dtype=torch.int32, device=dev)
    m, z, _, _, hit = sp.sparse_ce_forward(ft, wt, idt, idt, bias, valid, yt,
                                           scale=16.0)
    gz = 1.0 / (BTRAIN * z)
    gc = torch.full_like(z, -1.0 / BTRAIN)
    parts = {}
    for term, gct in (("loss", gc), ("softmax term", torch.zeros_like(gc))):
        for part, e in check_sparse(torch, sp, ft, wt, idt, idt, bias, valid,
                                    yt, 16.0, False, gz, gct,
                                    f"training shapes, {term}").items():
            parts[f"{part}, {term}"] = e
    log("kernel phase: sparse_ce at training shapes agrees, bit-identical "
        "across runs; " + "; ".join(f"{k} {e:.3g}" for k, e in parts.items()))
    fault = sparse_tf32_fault(torch, sp, ft, wt, idt, bias, valid, yt, m, gz,
                              gc, hit)
    fwd = lambda: sp.sparse_ce_forward(ft, wt, idt, idt, bias, valid, yt,
                                       scale=16.0)
    fwd_ms = cuda_ms(torch, fwd, 20)
    fwd_plain = cuda_ms(torch, lambda: sp.sparse_ce_forward_plain(
        ft, wt, idt, idt, bias, valid, yt, 16.0, False), 5)
    lib = cuda_ms(torch, lambda: ft @ wt[idt.long()].T, 20)
    bwd = lambda: sp.sparse_ce_backward(ft, wt, idt, idt, bias, valid, yt, m,
                                        gz, gc, hit, scale=16.0)
    bwd_ms = cuda_ms(torch, bwd, 10)
    bwd_plain = cuda_ms(torch, lambda: sp.sparse_ce_backward_plain(
        ft, wt, idt, idt, bias, valid, yt, m, gz, gc, hit, 16.0, False), 3)
    # the dense dW zero-fill that the backward's timed window includes
    fill_ms = cuda_ms(torch, lambda: torch.zeros_like(wt), 10)
    fb = ce_bounds(sp.forward_cost(BTRAIN, a, D))
    bb = ce_bounds(sp.backward_cost(BTRAIN, a, V, D))
    log(f"kernel phase: sparse_ce_forward {fwd_ms:.3f} ms (3xTF32 bound "
        f"{fb['bound_ms']:.3f} by {fb['bound_by']}, fp32-FMA "
        f"{fb['bound_fp32_fma_ms']:.3f}), plain {fwd_plain:.3f}, f @ "
        f"W[ids].T {lib:.3f}; sparse_ce_backward {bwd_ms:.3f} ms (3xTF32 "
        f"bound {bb['bound_ms']:.3f} by {bb['bound_by']}, fp32-FMA "
        f"{bb['bound_fp32_fma_ms']:.3f}; the dW zero-fill alone "
        f"{fill_ms:.3f}), plain {bwd_plain:.3f}")
    shape = f"f[{BTRAIN},{D}] W[{V},{D}] A={a}"
    fwd_err = max(e for k, e in parts.items() if k.startswith("fwd"))
    bwd_err = max(e for k, e in parts.items() if not k.startswith("fwd"))
    return {
        "sparse_ce_forward": dict(
            name="sparse_ce_forward", route="cuda",
            source="src/repro_torch/kernels/csrc/sparse_ce_fwd.cu",
            replaces="src/repro/kernels/sparse_ce.py:140",
            max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain, **fb,
            library_ms=lib,
            library="f @ W[ids].T (gather + cuBLAS fp32, TF32 off)",
            tf32_fault=fault, shape=shape),
        "sparse_ce_backward": dict(
            name="sparse_ce_backward", route="cuda",
            source="src/repro_torch/kernels/csrc/sparse_ce_bwd.cu",
            replaces="src/repro/kernels/sparse_ce.py:232",
            max_abs_err=bwd_err, max_rel_err=bwd_err, ms=bwd_ms,
            plain_ms=bwd_plain, **bb, library_ms=lib,
            library="f @ W[ids].T (gather + cuBLAS fp32, TF32 off)",
            zero_fill_ms=fill_ms, rel_err_by_part=parts, shape=shape),
    }


def check_dist_topk(torch, dk, q, k, kprime, col_offset=0, label="",
                    exact_ids=False):
    """dist_topk's kernel vs its plain version: values within 1e-5; ids
    equal, except, unless ``exact_ids``, at slots whose plain value lies
    within 1e-5 of a neighbouring slot's (or of the first value left out).
    Returns the largest value error."""
    v1, i1 = dk.dist_topk(q, k, kprime, col_offset=col_offset)
    v2, i2 = dk.dist_topk_plain(q, k, kprime + 1, col_offset)
    torch.cuda.synchronize()
    ext = v2
    v2, i2 = v2[:, :kprime], i2[:, :kprime]
    both = torch.isfinite(v2)
    if not torch.equal(torch.isfinite(v1), both):
        fail(f"dist_topk {label}: filled slots differ")
    err = float((v1[both] - v2[both]).abs().max()) if both.any() else 0.0
    if err > 1e-5:
        fail(f"dist_topk {label}: values differ by {err:.3g}")
    bad = i1 != i2
    if not exact_ids:
        gap_prev = torch.nn.functional.pad(ext[:, 1:] - ext[:, :-1], (1, 0),
                                           value=float("-inf")).abs()[:, :kprime]
        gap_next = (ext[:, :-1] - ext[:, 1:]).abs()[:, :kprime]
        near = (gap_prev < 1e-5) | (gap_next < 1e-5)
        bad &= ~near
    if bool(bad.any()):
        rows = bad.any(dim=1).nonzero()[:4, 0].tolist()
        fail(f"dist_topk ids {label}: rows {rows} kernel {i1[rows].tolist()} "
             f"plain {i2[rows].tolist()}")
    return err, int((i1 != i2).sum())


def dist_topk_phase(torch, dk, sharded, w_unit=None):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf = torch.bfloat16

    # -- exact inputs: integer values make every score exact, so duplicated
    # rows tie exactly and the lowest column must win
    qi = torch.randint(-3, 4, (300, 64), generator=g, device=dev).to(bf)
    ki = torch.randint(-3, 4, (5000, 64), generator=g, device=dev).to(bf)
    ki[4000:4100] = ki[17]
    ki[2500] = ki[17]
    ki[3000:3064] = qi[:64]
    check_dist_topk(torch, dk, qi, ki, 32, 0, "integer ties", exact_ids=True)
    check_dist_topk(torch, dk, qi, ki, 7, 1000, "integer ties, col_offset",
                    exact_ids=True)
    check_dist_topk(torch, dk, qi, ki[:20].contiguous(), 32, 0, "k' > Nk",
                    exact_ids=True)
    # unit rows, as the graph build gives it: scores within [-1, 1]
    qr = sharded._normalize(torch.randn((257, 72), generator=g,
                                        device=dev)).to(bf)
    kr = sharded._normalize(torch.randn((3001, 72), generator=g,
                                        device=dev)).to(bf)
    check_dist_topk(torch, dk, qr, kr, 16, 5, "ragged D=72")
    # the depths of the zoo's knn heads: Q and K stream over depth. The
    # queries are among the keys, as in a graph build, so each row's top
    # score is its own, ~1: there the sums are largest and a drift of the
    # tensor cores' accumulation over the depth would show
    deep = {}
    for d in DEEP_DIMS:
        qd = sharded._normalize(torch.randn((600, d), generator=g,
                                            device=dev)).to(bf)
        kd = sharded._normalize(torch.randn((20_000, d), generator=g,
                                            device=dev)).to(bf)
        kd[7_000:7_600] = qd
        deep[d] = check_dist_topk(torch, dk, qd, kd, KPRIME, 0, f"D={d}")
    log(f"kernel phase: dist_topk exact ties, k' > Nk, col_offset, a "
        f"ragged depth and D = {DEEP_DIMS} (600 x 20,000 unit rows: (max "
        f"abs err, near-tie id swaps) {deep}) agree with the plain version")

    # -- the graph build's shapes: unit W in bf16 ----------------------------
    if w_unit is None:
        w_unit = sharded._normalize(torch.randn((V, D), generator=g,
                                                device=dev))
    w16 = w_unit.to(bf)
    q = w16[:QSLICE]
    err, swaps = check_dist_topk(torch, dk, q[:1024], w16, KPRIME, 0,
                                 "1,024 rows x all keys")
    log(f"kernel phase: dist_topk on 1,024 unit rows x {V} keys agrees "
        f"(values max abs err {err:.3g}; ids swapped at near-ties: {swaps})")
    first = dk.dist_topk(q, w16, KPRIME)
    again = dk.dist_topk(q, w16, KPRIME)
    if not (torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                            again[1])):
        fail("dist_topk is not bit-identical across two runs")
    del first, again
    ms = cuda_ms(torch, lambda: dk.dist_topk(q, w16, KPRIME), 3)

    def plain():
        for r in range(0, QSLICE, 1024):
            dk.dist_topk_plain(q[r:r + 1024], w16, KPRIME)

    def library():
        for r in range(0, QSLICE, 1024):
            q[r:r + 1024] @ w16.T

    plain_ms = cuda_ms(torch, plain, 1)
    lib_ms = cuda_ms(torch, library, 3)
    bound, by = bound_ms(dk.cost(QSLICE, V, D, KPRIME))
    log(f"kernel phase: dist_topk {QSLICE} x {V} rows {ms:.2f} ms (bound "
        f"{bound:.2f} ms by {by}), plain {plain_ms:.1f} ms (1,024-row "
        f"chunks), bf16 q @ k.T {lib_ms:.2f} ms; bit-identical")
    return dict(
        name="dist_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/knn_dist_topk.cu",
        replaces="src/repro/kernels/knn_dist_topk.py:82",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms,
        library="q @ K.T (cuBLAS bf16) in 1,024-row chunks",
        near_tie_id_swaps=swaps, deep_dims=deep,
        shape=f"q[{QSLICE},{D}] K[{V},{D}] bf16, k'={KPRIME}")


# ---------------------------------------------------------------------------
# serving phase (the main path) and launcher phase
# ---------------------------------------------------------------------------


def serving_phase(torch, np, ce, dc, sharded):
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig
    from repro_torch.train import hybrid

    t0 = time.perf_counter()
    exp = Experiment.from_config(
        system="paper", classes=V, feat_dim=D, batch=B, seed=0,
        device=DEVICE, head=HeadConfig(softmax_impl="full", backend="kernel"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"serving phase: experiment with W {tuple(exp.state.w_head.shape)} "
        f"on {exp.device} in {setup_s:.1f} s")

    ce.LAUNCHES = 0
    dc.LAUNCHES = 0
    ids = exp.serve(batch=B)
    tids, tscores = exp.serve(batch=B, top_k=K, return_scores=True)
    launches = {"ce_forward": ce.LAUNCHES, "stage1_topk": dc.LAUNCHES}
    for name, n in launches.items():
        if n < 1:
            fail(f"the serving path never launched {name}")
    log(f"serving phase: launches on the main path {launches}")

    if ids.shape != (B,) or tids.shape != (B, K) or tscores.shape != (B, K):
        fail(f"result shapes {ids.shape} {tids.shape} {tscores.shape}")
    if not (np.all((ids >= 0) & (ids < V)) and np.all((tids >= 0)
                                                      & (tids < V))):
        fail("class ids out of range")
    if not np.all(np.isfinite(tscores)) or np.any(np.diff(tscores, 1) > 0):
        fail("top-k scores not finite or not descending")

    # the same queries through the ref backend, on the same weights
    q = exp.data_fn(10**6, B)["features"]
    ref_cfg = dataclasses.replace(exp.head_cfg, backend="ref")
    greedy_ref = hybrid.make_batched_serve_step(exp.model_cfg, ref_cfg)
    topk_ref = hybrid.make_batched_topk_serve_step(exp.model_cfg, ref_cfg, K)
    rids = greedy_ref(exp.state, q, B).cpu().numpy()
    rvals, rgids = (t.cpu().numpy() for t in topk_ref(exp.state, q, B))
    # rows whose best two cosine scores lie within 1e-5 may swap
    near_tie = (rvals[:, 0] - rvals[:, 1]) < 1e-5
    bad = (ids != rids) & ~near_tie
    if bad.any():
        fail(f"greedy ids differ from the ref backend on rows "
             f"{np.nonzero(bad)[0][:8].tolist()}")
    if not np.array_equal(ids[~near_tie], tids[~near_tie, 0]):
        fail("greedy ids are not the top-1 of the top-k")
    close = np.abs(tscores - rvals) <= 1e-5
    if not close.all():
        fail(f"top-k scores differ from the ref backend by up to "
             f"{np.abs(tscores - rvals).max():.3g}")
    gaps = np.diff(rvals, axis=1) > -1e-5       # adjacent near-ties
    same = (tids == rgids) | np.pad(gaps, ((0, 0), (0, 1))) | np.pad(
        gaps, ((0, 0), (1, 0)))
    if not same.all():
        fail("top-k ids differ from the ref backend")
    max_err = float(np.abs(tscores - rvals).max())
    log(f"serving phase: kernel backend agrees with ref (top-k score max "
        f"abs err {max_err:.3g}; near-tie rows {int(near_tie.sum())})")

    acc = exp.evaluate(eval_batch=B)
    if not 0.0 <= acc <= 1.0:
        fail(f"evaluate() returned {acc}")

    e2e = {
        "setup_s": setup_s,
        "greedy_ms": host_ms(torch, lambda: exp.serve(batch=B), 10),
        "top5_ms": host_ms(torch, lambda: exp.serve(batch=B, top_k=K,
                                                    return_scores=True), 10),
        "normalize_w_ms": cuda_ms(
            torch, lambda: sharded._normalize(exp.state.w_head), 10),
        "dense_logits_ms": cuda_ms(
            torch, lambda: q @ exp.state.w_head.T, 10),
        "evaluate_accuracy": acc,
        "top5_score_max_abs_err_vs_ref": max_err,
        "greedy_profile": profile_ms(torch, lambda: exp.serve(batch=B)),
        "top5_profile": profile_ms(torch, lambda: exp.serve(
            batch=B, top_k=K, return_scores=True)),
    }
    return exp, launches, e2e


def launcher_phase(torch, ce, dc):
    from repro_torch.launch import serve as launcher

    metrics = ROOT / "build" / "chip_smoke" / "replay_metrics.jsonl"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    metrics.unlink(missing_ok=True)
    before = (ce.LAUNCHES, dc.LAUNCHES)
    rc = launcher.main(["--system", "paper", "--classes", str(V),
                        "--feat-dim", str(D), "--topk", str(K),
                        "--batch", str(B), "--replay", "0.5",
                        "--device", DEVICE,
                        "--metrics-out", str(metrics)])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"launcher returned {rc}")
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    if not rows or rows[-1].get("n", 0) < 1:
        fail("the launcher's replay served no request")
    if dc.LAUNCHES == before[1]:
        fail("the launcher's top-k replay never launched stage1_topk")
    row = rows[-1]
    return {"replay_n": row["n"], "replay_p50_ms": row["p50_ms"],
            "replay_p99_ms": row["p99_ms"], "replay_qps": row["qps"],
            "replay_batches": row["n_batches"],
            "replay_occupancy": row["mean_batch_occupancy"]}


# ---------------------------------------------------------------------------
# training phase (the main path of the training slice) and its launcher
# ---------------------------------------------------------------------------


def _train_experiment(backend: str, data_fn=None, impl=None, exp_kw=None,
                      **knn):
    """The training phases' experiment: the ``full`` head, or with ``knn``
    settings (``rebuild_every``, ``knn_pad_random``) the ``knn`` head at
    the train launcher's k=16, k'=32 and 10% active classes, or with
    ``impl`` one of ``HEAD_CFGS``' heads; ``exp_kw`` (``ckpt_dir``, ...)
    goes to ``Experiment.from_config``."""
    from repro_torch.api import Experiment
    from repro_torch.configs.base import FCCSConfig, HeadConfig, TrainConfig

    if impl:
        head = HeadConfig(backend=backend, **HEAD_CFGS[impl])
    elif knn:
        head = HeadConfig(softmax_impl="knn", backend=backend, knn_k=KNN_K,
                          knn_kprime=KPRIME, active_frac=ACTIVE_FRAC, **knn)
    else:
        head = HeadConfig(softmax_impl="full", backend=backend)
    return Experiment.from_config(
        system="paper", classes=V, feat_dim=D, batch=BTRAIN, seed=0,
        device=DEVICE, log_every=1, data_fn=data_fn, head=head,
        train=TrainConfig(optimizer="lars", fccs=FCCSConfig(
            eta0=0.4, t_warm=2, b0=BTRAIN, b_min=BTRAIN, b_max=4 * BTRAIN,
            t_ini=2, t_final=6)), **(exp_kw or {}))


def head_grad_check(torch, exp, w0, head_cfg=None, tag="training phase"):
    """The head gradient of one batch's loss, through ``loss_local`` (W's
    normalisation, ``ce_shard_stats`` and the completion), on the kernel
    and the ref backend from the same W. The label rows and the other
    rows, whose gradient is the softmax term alone, are each held against
    their own max|ref| at BWD_TOL. (The weights after a few steps cannot
    show the other rows' gradient: weight decay outweighs it there, and
    fp32 rounding of W is larger than it.) For the sketch heads' [R, B, D]
    params the label rows are the buckets the labels hash to in each
    repetition. ``head_cfg`` replaces the experiment's head config (its
    backend set to each in turn). Returns {part: err / max|ref|}."""
    from repro_torch.api.heads import make_head
    from repro_torch.train.trainer import to_device

    batch = to_device(exp.data_fn(10**5 + 1, BTRAIN), exp.device)
    grads = {}
    for backend in ("kernel", "ref"):
        head = make_head(exp.model_cfg, dataclasses.replace(
            head_cfg or exp.head_cfg, backend=backend))
        wp = w0.clone().requires_grad_()
        loss, _ = head.loss_local(batch["features"], batch["labels"], wp,
                                  exp.state.head_aux, global_batch=BTRAIN,
                                  step=0)
        loss.backward()
        grads[backend] = wp.grad
        del wp
    lab = torch.zeros(w0.shape[:-1], dtype=torch.bool, device=w0.device)
    if w0.dim() == 3:                    # [R, B, D]: the labels' buckets
        hashes = exp.state.head_aux[0].long()
        for r in range(w0.shape[0]):
            lab[r, hashes[r, batch["labels"].long()]] = True
    else:
        lab[batch["labels"].long()] = True
    out = {}
    for name, sel in (("label rows", lab), ("other rows", ~lab)):
        k, r = grads["kernel"][sel], grads["ref"][sel]
        ref_max = float(r.abs().max())
        err = float((k - r).abs().max())
        if not ref_max > 0 or err > BWD_TOL * ref_max:
            fail(f"{tag}: head gradient of the {name}: kernel vs ref max abs "
                 f"err {err:.3g} over {BWD_TOL:g} * max|ref| {ref_max:.3g}")
        out[name] = err / ref_max
    del grads, k, r
    torch.cuda.empty_cache()
    log(f"{tag}: head gradient, kernel vs ref backend, max abs err of "
        f"max|ref| by part {out}")
    return out


def training_phase(torch, ce):
    from repro_torch.train.trainer import to_device

    exp = _train_experiment("kernel")
    w0 = exp.state.w_head.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.LAUNCHES = 0
    ce.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    hist = exp.fit(FIT_STEPS, use_fccs_batch=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"ce_forward": ce.LAUNCHES, "ce_backward": ce.BWD_LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"training phase: fit({FIT_STEPS}) in {fit_s:.2f} s, batches "
        f"{[r['batch'] for r in hist]}, launches {launches}, peak memory "
        f"{peak_gb:.2f} GB")
    for name, n in launches.items():
        if n != FIT_LAUNCHES:
            fail(f"the training path launched {name} {n} times, not "
                 f"{FIT_LAUNCHES}")
    if [r["batch"] for r in hist] != [BTRAIN * n for n in (1, 1, 1, 2, 4, 4)]:
        fail(f"FCCS batches {[r['batch'] for r in hist]}")
    losses = [r["loss"] for r in hist]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite training losses {losses}")
    moved = float((exp.state.w_head - w0).abs().max())
    if not moved > 0:
        fail("training did not change the class weights")
    grad_err = head_grad_check(torch, exp, w0)

    # the step at n_micro=1, timed on the host clock and profiled
    step = exp.trainer._get_step(1)
    inputs = to_device(exp.data_fn(10**5, BTRAIN), exp.device)

    def one_step():
        exp.trainer.state = step(exp.trainer.state, inputs, 0.4)[0]

    step_ms = host_ms(torch, one_step, 5)
    prof = profile_ms(torch, one_step)
    log(f"training phase: step (n_micro=1) {step_ms:.2f} ms, "
        f"{BTRAIN / step_ms * 1e3:.0f} samples/s; profiled: {prof}")
    data_fn = exp.data_fn
    del exp, step, inputs
    torch.cuda.empty_cache()

    # kernel vs ref backend: same initial weights, same batches, 3 steps
    out = {}
    for backend in ("kernel", "ref"):
        e = _train_experiment(backend, data_fn)
        e.load_state(e.state._replace(head_params=w0.clone()))
        h = e.fit(3, use_fccs_batch=True)
        torch.cuda.synchronize()
        out[backend] = ([r["loss"] for r in h], e.state.w_head.clone(),
                        e.evaluate() if backend == "kernel" else None)
        del e
        torch.cuda.empty_cache()
    (lk, wk, acc), (lr_, wr, _) = out["kernel"], out["ref"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lr_))
    w_err = float((wk - wr).abs().max())
    w_max = float(wr.abs().max())
    log(f"training phase: kernel vs ref losses {lk} / {lr_} (max rel "
        f"{loss_rel:.3g}); max|dW| {w_err:.3g} vs max|W| {w_max:.3g}; "
        f"evaluate() {acc}")
    if loss_rel > 1e-4:
        fail(f"kernel and ref losses differ by rel {loss_rel:.3g}")
    if w_err > 1e-4 * w_max:
        fail(f"kernel and ref weights differ by {w_err:.3g}")
    if not 0.0 <= acc <= 1.0:
        fail(f"evaluate() returned {acc}")
    del wk, wr, w0
    torch.cuda.empty_cache()
    return launches, {
        "fit_s": fit_s, "fit_losses": losses,
        "fit_batches": [r["batch"] for r in hist],
        "train_step_ms_n1": step_ms,
        "train_samples_per_s_n1": BTRAIN / step_ms * 1e3,
        "train_step_profile": prof, "train_peak_memory_gb": peak_gb,
        "kernel_vs_ref_loss_max_rel": loss_rel,
        "kernel_vs_ref_w_max_abs": w_err, "w_max_abs": w_max,
        "head_grad_kernel_vs_ref_rel_err": grad_err,
        "train_evaluate_accuracy": acc}


def train_launcher_phase(head: str = "full"):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--system",
           "paper", "--head", head, "--classes", str(V), "--feat-dim",
           str(D), "--batch", str(BTRAIN), "--steps", "4", "--fccs",
           "--backend", "kernel"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines()[-6:]:
        log(f"train launcher --head {head}: {line}")
    if proc.returncode != 0:
        fail(f"train launcher --head {head} exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    acc = [line for line in proc.stdout.splitlines()
           if "final eval accuracy" in line]
    if not acc or not math.isfinite(float(acc[-1].split()[-1])):
        fail(f"train launcher --head {head} printed no finite final accuracy")
    tag = "" if head == "full" else f"_{head}"
    return {f"train_launcher{tag}_s": wall,
            f"train_launcher{tag}_accuracy": float(acc[-1].split()[-1])}


# ---------------------------------------------------------------------------
# knn training (the main path of the knn slice)
# ---------------------------------------------------------------------------


def graph_build_breakdown(torch, w):
    """The graph build of ``w`` taken apart, each piece synchronised on the
    host clock: pass 1 alone (the ``dist_topk`` launch over all rows), the
    ring build (pass 1 again, the merge and pass 2's fp32 re-rank), the
    copy of the [N, k] graph to the host, and its compression."""
    import numpy as np

    from repro_torch.core import knn_graph as kg
    from repro_torch.core.sharded_softmax import _normalize
    from repro_torch.kernels import ops

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    w16 = _normalize(w.float()).to(torch.bfloat16)
    _, pass1_s = timed(lambda: ops.dist_topk(w16, w16, KPRIME))
    del w16
    g, ring_s = timed(lambda: kg.ring_knn_local(w, k=KNN_K, kprime=KPRIME))
    graph, host_s = timed(lambda: g.cpu().numpy())
    cg, compress_s = timed(lambda: kg.compress_graph(graph, 1))
    if not np.array_equal(graph[:, 0], np.arange(V)):
        fail("the rebuilt graph does not list every class first in its own "
             "row")
    out = {"pass1_dist_topk_s": pass1_s, "pass2_and_merge_s": ring_s - pass1_s,
           "ring_build_s": ring_s, "to_host_s": host_s,
           "compress_s": compress_s,
           "build_s": ring_s + host_s + compress_s,
           "graph_storage_bytes": kg.graph_storage_bytes(cg)["total_bytes"]}
    log(f"knn phase: graph build {out['build_s']:.2f} s = pass 1 (dist_topk) "
        f"{pass1_s:.2f} s + merge and pass 2 {ring_s - pass1_s:.2f} s + to "
        f"host {host_s:.2f} s + compression {compress_s:.2f} s; storage "
        f"{out['graph_storage_bytes'] / 1e6:.1f} MB")
    return out


def knn_training_phase(torch, sp, dk):
    from repro_torch.train.trainer import to_device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sp.LAUNCHES = 0
    sp.BWD_LAUNCHES = 0
    dk.LAUNCHES = 0
    t0 = time.perf_counter()
    exp = _train_experiment("kernel", rebuild_every=4, knn_pad_random=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w0 = exp.state.w_head.clone()
    t0 = time.perf_counter()
    hist = exp.fit(FIT_STEPS, use_fccs_batch=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"sparse_ce_forward": sp.LAUNCHES,
                "sparse_ce_backward": sp.BWD_LAUNCHES,
                "dist_topk": dk.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"knn phase: experiment (one graph build) {setup_s:.2f} s, "
        f"fit({FIT_STEPS}) {fit_s:.2f} s, batches "
        f"{[r['batch'] for r in hist]}, launches {launches}, peak memory "
        f"{peak_gb:.2f} GB")
    builds = 2                     # at construction and after step 3
    want = {"sparse_ce_forward": FIT_LAUNCHES,
            "sparse_ce_backward": FIT_LAUNCHES, "dist_topk": builds}
    for name, n in launches.items():
        if n != want[name]:
            fail(f"the knn training path launched {name} {n} times, not "
                 f"{want[name]}")
    if [r["batch"] for r in hist] != [BTRAIN * n for n in (1, 1, 1, 2, 4, 4)]:
        fail(f"FCCS batches {[r['batch'] for r in hist]}")
    losses = [r["loss"] for r in hist]
    recall = [r["label_recall"] for r in hist]
    active = [r["active_frac"] for r in hist]
    log(f"knn phase: losses {losses}, label_recall {recall}, active_frac "
        f"{active}")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite knn training losses {losses}")
    if any(r != 1.0 for r in recall):
        fail(f"label_recall {recall}: a label missed its active set")
    moved = float((exp.state.w_head - w0).abs().max())
    if not moved > 0:
        fail("knn training did not change the class weights")
    build = graph_build_breakdown(torch, exp.state.w_head)

    # the step at n_micro=1, timed on the host clock and profiled
    step = exp.trainer._get_step(1)
    inputs = to_device(exp.data_fn(10**5, BTRAIN), exp.device)

    def one_step():
        exp.trainer.state = step(exp.trainer.state, inputs, 0.4)[0]

    step_ms = host_ms(torch, one_step, 5)
    prof = profile_ms(torch, one_step)
    log(f"knn phase: step (n_micro=1) {step_ms:.2f} ms, "
        f"{BTRAIN / step_ms * 1e3:.0f} samples/s; profiled: {prof}")
    log("knn phase: top device kernels of one step (ms): " + "; ".join(
        f"{k} {v:.3f}" for k, v in prof["top_kernels_ms"].items()))
    aux, data_fn = exp.state.head_aux, exp.data_fn
    del exp, step, inputs
    torch.cuda.empty_cache()

    # kernel vs ref backend: the same W and graph, no fillers, no rebuild
    out = {}
    for backend in ("kernel", "ref"):
        e = _train_experiment(backend, data_fn, rebuild_every=0,
                              knn_pad_random=False)
        e.load_state(e.state._replace(head_params=w0.clone(), head_aux=aux))
        h = e.fit(3, use_fccs_batch=True)
        torch.cuda.synchronize()
        out[backend] = ([r["loss"] for r in h], e.state.w_head.clone())
        del e
        torch.cuda.empty_cache()
    (lk, wk), (lr_, wr) = out["kernel"], out["ref"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lr_))
    w_err = float((wk - wr).abs().max())
    w_max = float(wr.abs().max())
    log(f"knn phase: kernel vs ref losses {lk} / {lr_} (max rel "
        f"{loss_rel:.3g}); max|dW| {w_err:.3g} vs max|W| {w_max:.3g}")
    if loss_rel > 1e-4:
        fail(f"knn kernel and ref losses differ by rel {loss_rel:.3g}")
    if w_err > 1e-4 * w_max:
        fail(f"knn kernel and ref weights differ by {w_err:.3g}")
    del wk, wr, w0, aux
    torch.cuda.empty_cache()
    return launches, {
        "knn_setup_s": setup_s, "knn_fit_s": fit_s, "knn_fit_losses": losses,
        "knn_label_recall": recall, "knn_active_frac": active,
        "knn_graph_build": build, "knn_train_step_ms_n1": step_ms,
        "knn_train_samples_per_s_n1": BTRAIN / step_ms * 1e3,
        "knn_train_step_profile": prof, "knn_train_peak_memory_gb": peak_gb,
        "knn_kernel_vs_ref_loss_max_rel": loss_rel,
        "knn_kernel_vs_ref_w_max_abs": w_err, "knn_w_max_abs": w_max}


# ---------------------------------------------------------------------------
# the four remaining heads (the main paths of the heads slice)
# ---------------------------------------------------------------------------


def _reset(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read(counters) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def ce_mach_rows(torch, ce, exp):
    """ce_forward / ce_backward at MACH's bucket shard: f a training batch's
    features [256, 512] (not normalised), W the experiment's repetition 1,
    a view of [R, B, D] at offset B D 4 bytes, scale 1, limit = B, the
    labels' buckets. Both gates, bit-identical runs, the emulated 1xTF32
    fault (which must fail both gates here too), a view 4 bytes off 16
    (which the wrapper must refuse), times and bounds. Returns the two
    rows."""
    from repro_torch.train.trainer import to_device

    w = exp.state.head_params[1]
    b_loc = w.shape[0]
    if w.data_ptr() % 16 or not w.is_contiguous():
        fail("MACH's repetition view is not a 16-byte aligned contiguous "
             "block")
    batch = to_device(exp.data_fn(10**5 + 2, BTRAIN), exp.device)
    f = batch["features"].float().contiguous()
    y = exp.state.head_aux[0][1, batch["labels"].long()].to(torch.int32)
    fwd_err, fwd_z = check_ce(torch, ce, f, w, y, b_loc, 1.0, "MACH shard")
    m, z, _, _ = ce.ce_forward(f, w, y, limit=b_loc, scale=1.0)
    gz = 1.0 / (BTRAIN * z)
    gc = torch.full_like(z, -1.0 / BTRAIN)
    parts = {}
    for term, gct in (("loss", gc), ("softmax term", torch.zeros_like(gc))):
        for part, v in check_ce_bwd(torch, ce, f, w, y, m, gz, gct, b_loc,
                                    1.0, f"MACH shard, {term}").items():
            parts[f"{part}, {term}"] = v
    fault = tf32_fault(torch, ce, f, w, y, m, gz, gc, b_loc, 1.0,
                       "MACH's bucket shard")
    buf = torch.empty(b_loc * D + 1, device=f.device)
    off = buf[1:].view(b_loc, D)
    try:
        ce.ce_forward(f, off, y, limit=b_loc)
    except ValueError as e:
        refused = str(e)
    else:
        fail("ce_forward took a W 4 bytes off 16-byte alignment")
    del buf, off
    fwd_ms = cuda_ms(torch, lambda: ce.ce_forward(f, w, y, limit=b_loc), 20)
    fwd_plain = cuda_ms(torch, lambda: ce.ce_forward_plain(f, w, y, b_loc,
                                                           1.0), 10)
    bwd_ms = cuda_ms(torch, lambda: ce.ce_backward(f, w, y, m, gz, gc,
                                                   limit=b_loc), 10)
    bwd_plain = cuda_ms(torch, lambda: ce.ce_backward_plain(
        f, w, y, m, gz, gc, b_loc, 1.0), 5)
    lib = cuda_ms(torch, lambda: f @ w.T, 20)
    fb = ce_bounds(ce.forward_cost(BTRAIN, b_loc, D))
    bb = ce_bounds(ce.backward_cost(BTRAIN, b_loc, D))
    log(f"heads phase: at MACH's shard [{BTRAIN}, {b_loc}] x {D}: ce_forward "
        f"{fwd_ms:.4f} ms (3xTF32 bound {fb['bound_ms']:.4f} by "
        f"{fb['bound_by']}), plain {fwd_plain:.4f}; ce_backward {bwd_ms:.4f} "
        f"ms (bound {bb['bound_ms']:.4f} by {bb['bound_by']}), plain "
        f"{bwd_plain:.4f}; f @ W.T {lib:.4f}; m/corr max abs err "
        f"{fwd_err:.3g}, z rel {fwd_z:.3g}; backward by part {parts}; a "
        f"misaligned W refused: {refused}")
    shape = f"f[{BTRAIN},{D}] W[{b_loc},{D}] (rep 1 of [R,B,D]) scale 1"
    lib_name = "f @ W.T (cuBLAS fp32, TF32 off)"
    return (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib,
                 library=lib_name, max_abs_err=fwd_err, z_max_rel_err=fwd_z,
                 **fb, shape=shape),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib,
                 library=lib_name,
                 max_abs_err=max(e for e, _ in parts.values()),
                 rel_err_by_part={k: r for k, (_, r) in parts.items()},
                 tf32_fault=fault, **bb, shape=shape))


def sparse_sampled_rows(torch, sp, exp):
    """sparse_ce_forward / _backward at the sampled head's shapes: f a
    training batch [256, 512], the normalised 1M x 512 shard, scale 16,
    A = 102,025 draws with bias -logQ and mask_hits=True, once from the
    uniform draw (distinct ids) and once from the log_uniform one
    (repeated ids), through the sparse gates, bit-identical runs, times
    and bounds. Returns {draw: (forward row, backward row)}."""
    from repro_torch.core import baselines as bl
    from repro_torch.core.sharded_softmax import _normalize
    from repro_torch.train.trainer import to_device

    batch = to_device(exp.data_fn(10**5 + 3, BTRAIN), exp.device)
    f = _normalize(batch["features"].float()).contiguous()
    w = _normalize(exp.state.w_head).contiguous()
    y = batch["labels"]
    out = {}
    for name in ("uniform", "log_uniform"):
        d = bl.sampled_draw(y, v_loc=V, n_samples=HEAD_CFGS["sampled"][
            "sampled_n"], distribution=name, seed=17, step=0)
        ids, bias, valid = d.ids, -d.logq, d.valid.to(torch.int32)
        a = ids.shape[0]
        _, counts = torch.unique(ids, return_counts=True)
        m, z, _, _, hit = sp.sparse_ce_forward(f, w, ids, ids, bias, valid, y,
                                               scale=16.0, mask_hits=True)
        gz = 1.0 / (BTRAIN * z)
        gc = torch.full_like(z, -1.0 / BTRAIN)
        errs = check_sparse(torch, sp, f, w, ids, ids, bias, valid, y, 16.0,
                            True, gz, gc, f"sampled {name}")
        fwd_ms = cuda_ms(torch, lambda: sp.sparse_ce_forward(
            f, w, ids, ids, bias, valid, y, scale=16.0, mask_hits=True), 20)
        fwd_plain = cuda_ms(torch, lambda: sp.sparse_ce_forward_plain(
            f, w, ids, ids, bias, valid, y, 16.0, True), 5)
        bwd_ms = cuda_ms(torch, lambda: sp.sparse_ce_backward(
            f, w, ids, ids, bias, valid, y, m, gz, gc, hit, scale=16.0,
            mask_hits=True), 10)
        bwd_plain = cuda_ms(torch, lambda: sp.sparse_ce_backward_plain(
            f, w, ids, ids, bias, valid, y, m, gz, gc, hit, 16.0, True), 3)
        lib = cuda_ms(torch, lambda: f @ w[ids.long()].T, 20)
        fb = ce_bounds(sp.forward_cost(BTRAIN, a, D))
        bb = ce_bounds(sp.backward_cost(BTRAIN, a, V, D))
        rep = {"distinct_ids": int(counts.numel()),
               "most_repeated": int(counts.max())}
        log(f"heads phase: sparse CE at the sampled {name} draw (A={a}, "
            f"{rep}): forward {fwd_ms:.3f} ms (bound {fb['bound_ms']:.3f} by "
            f"{fb['bound_by']}), plain {fwd_plain:.3f}; backward {bwd_ms:.3f} "
            f"ms (bound {bb['bound_ms']:.3f} by {bb['bound_by']}), plain "
            f"{bwd_plain:.3f}; f @ W[ids].T {lib:.3f}; errors {errs}")
        shape = (f"f[{BTRAIN},{D}] W[{V},{D}] A={a} {name} draw, bias -logQ, "
                 f"mask_hits")
        lib_name = "f @ W[ids].T (gather + cuBLAS fp32, TF32 off)"
        fwd_err = max(e for k, e in errs.items() if k.startswith("fwd"))
        bwd_err = max(e for k, e in errs.items() if not k.startswith("fwd"))
        out[name] = (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib,
                          library=lib_name, max_abs_err=fwd_err, **fb,
                          shape=shape, **rep),
                     dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib,
                          library=lib_name, max_abs_err=bwd_err,
                          rel_err_by_part=errs, **bb, shape=shape, **rep))
    torch.cuda.empty_cache()
    return out


def one_head_phase(torch, np, counters, impl):
    """``impl``'s main path at the 1M-class width: ``fit(6,
    use_fccs_batch=True)`` on the kernel backend with every counter set to
    0 just before and read just after (selective and sampled: the sparse
    pair 13 times each; mach and csoft: the dense CE pair once a
    repetition, 52 times each; nothing else), then the head gradient on
    both backends, the step at n_micro = 1, evaluate and greedy serving
    through the engine. Returns (launches, numbers, the experiment)."""
    from repro_torch.train.trainer import to_device

    sketch = impl in ("mach", "csoft")
    t0 = time.perf_counter()
    exp = _train_experiment("kernel", impl=impl)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w0 = exp.state.w_head.clone()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    t0 = time.perf_counter()
    hist = exp.fit(FIT_STEPS, use_fccs_batch=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _read(counters)
    fit_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pair = (("ce_forward", "ce_backward") if sketch
            else ("sparse_ce_forward", "sparse_ce_backward"))
    want = FIT_LAUNCHES * (SKETCH_R if sketch else 1)
    log(f"heads phase: {impl} W {tuple(w0.shape)}, experiment {setup_s:.2f} "
        f"s, fit({FIT_STEPS}) {fit_s:.2f} s, batches "
        f"{[r['batch'] for r in hist]}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, peak memory "
        f"{fit_peak_gb:.2f} GB")
    for name, n in launches.items():
        if n != (want if name in pair else 0):
            fail(f"the {impl} training path launched {name} {n} times, not "
                 f"{want if name in pair else 0}")
    if [r["batch"] for r in hist] != [BTRAIN * n for n in (1, 1, 1, 2, 4, 4)]:
        fail(f"{impl}: FCCS batches {[r['batch'] for r in hist]}")
    losses = [r["loss"] for r in hist]
    own = {k: [r[k] for r in hist] for k in hist[0]
           if k not in ("step", "lr", "batch", "loss")}
    log(f"heads phase: {impl} losses {losses}, metrics {own}")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite {impl} training losses {losses}")
    if impl == "selective" and any(r != 1.0 for r in own["label_recall"]):
        fail(f"selective label_recall {own['label_recall']}: a label missed "
             f"its active set")
    frac = HEAD_CFGS["sampled"]["sampled_n"] / V
    if impl == "sampled" and any(abs(r - frac) > 1e-6
                                 for r in own["sample_frac"]):
        fail(f"sampled sample_frac {own['sample_frac']}")
    if not float((exp.state.w_head - w0).abs().max()) > 0:
        fail(f"{impl} training did not change the head params")

    grads = {exp.head_cfg.sampled_dist if impl == "sampled" else impl:
             head_grad_check(torch, exp, w0, tag=f"heads phase: {impl}")}
    if impl == "sampled":
        grads["log_uniform"] = head_grad_check(
            torch, exp, w0, dataclasses.replace(
                exp.head_cfg, sampled_dist="log_uniform"),
            tag="heads phase: sampled log_uniform")
    del w0
    torch.cuda.empty_cache()

    step = exp.trainer._get_step(1)
    inputs = to_device(exp.data_fn(10**5, BTRAIN), exp.device)

    def one_step():
        exp.trainer.state = step(exp.trainer.state, inputs, 0.4)[0]

    step_ms = host_ms(torch, one_step, 5)
    prof = profile_ms(torch, one_step)
    torch.cuda.reset_peak_memory_stats()
    acc = exp.evaluate()
    torch.cuda.synchronize()
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not 0.0 <= acc <= 1.0:
        fail(f"{impl} evaluate() returned {acc}")
    ids = exp.serve(batch=B)
    if ids.shape != (B,) or not np.all((ids >= 0) & (ids < V)):
        fail(f"{impl} greedy serving gave {ids.shape} ids out of range")
    serve_ms = host_ms(torch, lambda: exp.serve(batch=B), 5)
    log(f"heads phase: {impl} step (n_micro=1) {step_ms:.2f} ms, "
        f"{BTRAIN / step_ms * 1e3:.0f} samples/s, idle share "
        f"{prof['idle_share']:.3f}; evaluate {acc} on {4 * BTRAIN} rows (peak "
        f"{eval_peak_gb:.2f} GB); greedy serve at batch {B} {serve_ms:.2f} ms")
    log(f"heads phase: {impl} top device kernels of one step (ms): " +
        "; ".join(f"{k} {v:.3f}" for k, v in prof["top_kernels_ms"].items()))
    del step, inputs
    return launches, {
        "setup_s": setup_s, "fit_s": fit_s, "fit_losses": losses,
        "fit_metrics": own, "fit_peak_memory_gb": fit_peak_gb,
        "head_grad_kernel_vs_ref_rel_err": grads,
        "train_step_ms_n1": step_ms,
        "train_samples_per_s_n1": BTRAIN / step_ms * 1e3,
        "train_step_profile": prof, "evaluate_accuracy": acc,
        "evaluate_peak_memory_gb": eval_peak_gb,
        "greedy_serve_ms_b64": serve_ms}, exp


def head_launchers_phase(torch, impl):
    """``repro_torch.launch.train --head impl`` for 2 steps at the 1M-class
    width, then the serve launcher's greedy serving of 64 queries, both in
    this process."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    lr = ["--lr", "0.3"] if impl in ("mach", "csoft") else []
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_launcher.main(
            ["--head", impl, "--classes", str(V), "--feat-dim", str(D),
             "--batch", str(BTRAIN), "--steps", "2", "--fccs",
             "--device", DEVICE] + lr)
    wall = time.perf_counter() - t0
    text = out.getvalue()
    acc = [line for line in text.splitlines() if "final eval accuracy" in line]
    if rc != 0 or not acc:
        fail(f"train launcher --head {impl} returned {rc}: {text[-500:]}")
    log(f"heads phase: train launcher --head {impl}: {acc[-1]} ({wall:.1f} s)")
    res = {"train_launcher_s": wall,
           "train_launcher_accuracy": float(acc[-1].split()[-1])}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_launcher.main(
            ["--system", "paper", "--head", impl, "--classes", str(V),
             "--feat-dim", str(D), "--batch", str(B), "--device", DEVICE])
    if rc != 0 or "first predictions" not in out.getvalue():
        fail(f"serve launcher --head {impl} returned {rc}")
    log(f"heads phase: serve launcher --head {impl}: "
        f"{out.getvalue().splitlines()[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def heads_phase(torch, np, counters, ce, sp):
    """The four heads in turn (``one_head_phase``); at MACH's the CE pair on
    its bucket shard, at the sampled head's the sparse pair on its draws;
    then the launchers. Returns ({path: launches}, {kernel: {shape: row}},
    numbers)."""
    launches, rows, e2e = {}, {}, {}
    for impl in HEAD_CFGS:
        launches[f"{impl}_training"], e2e[impl], exp = one_head_phase(
            torch, np, counters, impl)
        if impl == "mach":
            fwd, bwd = ce_mach_rows(torch, ce, exp)
            rows["ce_forward"] = {"mach_shard": fwd}
            rows["ce_backward"] = {"mach_shard": bwd}
        if impl == "sampled":
            for name, (fwd, bwd) in sparse_sampled_rows(torch, sp,
                                                        exp).items():
                rows.setdefault("sparse_ce_forward", {})[
                    f"sampled_{name}"] = fwd
                rows.setdefault("sparse_ce_backward", {})[
                    f"sampled_{name}"] = bwd
        del exp
        gc.collect()
        torch.cuda.empty_cache()
    for impl in HEAD_CFGS:
        e2e[impl].update(head_launchers_phase(torch, impl))
    return launches, rows, e2e


# ---------------------------------------------------------------------------
# the paper's own trainer: ResNet-50 + DGC (the main path of the cnn slice)
# ---------------------------------------------------------------------------


def _cnn_experiment(backend: str, *, dtype: str = "bfloat16",
                    batch=None, dgc: bool = True, **exp_kw):
    """``sku100m_resnet.config_1m()`` (ResNet-50, D=512, 1,020,250 classes;
    ``dtype`` its compute type over fp32 params) with the ``full`` head at
    scale 16, LARS, FCCS growth from 256 to 1,024 images and ``DGCConfig()``
    at its defaults, everything on ``backend``; 224 x 224 synthetic
    images, micro-batches of ``batch``; ``exp_kw`` (``ckpt_dir``, ...) goes
    to ``Experiment.from_config``."""
    from repro_torch.api import Experiment
    from repro_torch.configs import sku100m_resnet
    from repro_torch.configs.base import (DGCConfig, FCCSConfig, HeadConfig,
                                          TrainConfig)
    from repro_torch.data.synthetic import sku_image_batch

    model = dataclasses.replace(sku100m_resnet.config_1m(), dtype=dtype)
    return Experiment.from_config(
        system="paper", model=model, batch=batch or RES_MICRO, seed=0,
        device=DEVICE, log_every=1,
        data_fn=lambda t, b: sku_image_batch(t, b, V, hw=RES_HW,
                                             device=DEVICE),
        head=HeadConfig(softmax_impl="full", backend=backend),
        train=TrainConfig(optimizer="lars", dgc=DGCConfig(
            enabled=dgc, backend=backend), fccs=FCCSConfig(
            eta0=0.4, t_warm=2, b0=BTRAIN, b_min=BTRAIN, b_max=4 * BTRAIN,
            t_ini=2, t_final=6)), **exp_kw)


def _fe_grads(torch, exp, inputs, events=None):
    """One micro-batch's loss and gradients through the experiment's trunk
    and head (the body ``hybrid.make_train_step`` differentiates), with
    CUDA events after the trunk forward, the head forward, the head
    backward (a hook on the features' gradient) and the trunk backward
    when ``events`` (five) are given. -> (loss, FE gradient tree, head
    gradient)."""
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train import hybrid

    st = exp.state
    fe = tree_map(lambda p: p.detach().requires_grad_(True), st.fe_params)
    hp = st.head_params.detach().requires_grad_(True)
    rec = (lambda i: events[i].record()) if events else (lambda i: None)
    rec(0)
    f = hybrid._features(exp.model_cfg, fe, inputs)
    rec(1)
    loss, _ = exp.head.loss_local(f, inputs["labels"], hp, st.head_aux,
                                  global_batch=f.shape[0], step=st.step)
    rec(2)
    if events:
        f.register_hook(lambda g: events[3].record())
    leaves = tree_leaves(fe)
    grads = torch.autograd.grad(loss, leaves + [hp])
    rec(4)
    it = iter(grads[:-1])
    return loss.detach(), tree_map(lambda _: next(it), fe), grads[-1]


def ce_cnn_rows(torch, ce, exp):
    """ce_forward / ce_backward at the cnn path's own shapes: f one
    micro-batch's trunk features [RES_MICRO, 512] in bf16, normalised and
    upcast as the full head's kernel body hands them over, W the trained
    [1,020,250, 512] shard normalised, the head's cosine scale, the
    labels on this shard. Both gates, bit-identical runs, the emulated
    1xTF32 fault (which must fail both gates here too), times and bounds.
    Returns the two rows."""
    from repro_torch.core.sharded_softmax import _normalize
    from repro_torch.train import hybrid
    from repro_torch.train.trainer import to_device

    inputs = to_device(exp.data_fn(10**5 + 3, RES_MICRO), exp.device)
    with torch.no_grad():
        f = _normalize(hybrid._features(exp.model_cfg, exp.state.fe_params,
                                        inputs)).float().contiguous()
        w = _normalize(exp.state.w_head).float().contiguous()
    y = inputs["labels"].to(torch.int32)
    b, v = f.shape[0], w.shape[0]
    scale = exp.head_cfg.cosine_scale
    fwd_err, fwd_z = check_ce(torch, ce, f, w, y, v, scale, "cnn features")
    m, z, _, _ = ce.ce_forward(f, w, y, limit=v, scale=scale)
    gz = 1.0 / (b * z)
    gc_ = torch.full_like(z, -1.0 / b)
    parts = {}
    for term, gct in (("loss", gc_), ("softmax term", torch.zeros_like(gc_))):
        for part, r in check_ce_bwd(torch, ce, f, w, y, m, gz, gct, v, scale,
                                    f"cnn features, {term}").items():
            parts[f"{part}, {term}"] = r
    fault = tf32_fault(torch, ce, f, w, y, m, gz, gc_, v, scale,
                       f"the cnn features (B={b})")
    fwd_ms = cuda_ms(torch, lambda: ce.ce_forward(f, w, y, limit=v,
                                                  scale=scale), 10)
    fwd_plain = cuda_ms(torch, lambda: ce.ce_forward_plain(f, w, y, v, scale),
                        3)
    bwd_ms = cuda_ms(torch, lambda: ce.ce_backward(f, w, y, m, gz, gc_,
                                                   limit=v, scale=scale), 5)
    bwd_plain = cuda_ms(torch, lambda: ce.ce_backward_plain(
        f, w, y, m, gz, gc_, v, scale), 3)
    lib = cuda_ms(torch, lambda: f @ w.T, 10)
    fb = ce_bounds(ce.forward_cost(b, v, D))
    bb = ce_bounds(ce.backward_cost(b, v, D))
    log(f"cnn phase: CE pair on the trunk's features [{b}, {D}] x W [{v}, "
        f"{D}] scale {scale:g}: ce_forward {fwd_ms:.3f} ms (3xTF32 bound "
        f"{fb['bound_ms']:.3f} by {fb['bound_by']}), plain {fwd_plain:.3f}; "
        f"ce_backward {bwd_ms:.3f} ms (bound {bb['bound_ms']:.3f} by "
        f"{bb['bound_by']}), plain {bwd_plain:.3f}; f @ W.T {lib:.3f}; m/corr "
        f"max abs err {fwd_err:.3g}, z rel {fwd_z:.3g}; backward by part "
        f"{parts}")
    del f, w, m, z, gz, gc_, inputs
    torch.cuda.empty_cache()
    shape = f"f[{b},{D}] (trunk features) W[{v},{D}] scale {scale:g}"
    lib_name = "f @ W.T (cuBLAS fp32, TF32 off)"
    return (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib,
                 library=lib_name, max_abs_err=fwd_err, z_max_rel_err=fwd_z,
                 **fb, shape=shape),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib,
                 library=lib_name,
                 max_abs_err=max(e for e, _ in parts.values()),
                 rel_err_by_part={k: r for k, (_, r) in parts.items()},
                 tf32_fault=fault, **bb, shape=shape))


def dgc_selection_times(torch, dc, exp, g_fe):
    """DGC's selection on one step's gradients taken apart, group by
    group, each part timed by CUDA events over 5 repeats: stage 1 (the
    ``stage1_topk`` launch over the group's chunks), stage 2 (the stable
    sort of the survivors), the library's ``torch.topk`` of the chunks,
    and the bound (each |v| read once, the survivors written: 4 + 4 bytes
    each; one compare an element). Thresholds from a full ``torch.sort``
    of each group beside them."""
    from repro_torch.core import sparsify as sp_
    from repro_torch.kernels import ops as kops

    cfg = exp.train_cfg.dgc
    leaves, _ = sp_.flatten(g_fe)
    u_l, _ = sp_.flatten(exp.state.dgc.u)
    v_l, _ = sp_.flatten(exp.state.dgc.v)
    rows, full_sort, checked, costs = [], [], set(), []
    n_max = max(sum(leaves[i].numel() for i in grp)
                for grp in sp_.group_leaves(leaves, cfg.group_bytes))
    for grp in sp_.group_leaves(leaves, cfg.group_bytes):
        vflat = torch.cat([v_l[i].reshape(-1) + torch.add(
            leaves[i].float().reshape(-1), u_l[i].reshape(-1),
            alpha=cfg.momentum) for i in grp])
        n = vflat.shape[0]
        k = max(1, int(n * (1.0 - cfg.sparsity)))
        kk = min(k, cfg.chunk)
        x = vflat.abs()
        full_sort.append(float(sp_.topk_threshold_ref(x, k)))
        # the survivors against the plain version: the largest group (whole
        # chunks kept, kk = chunk) and the first of 1,048,576 entries
        if n in (n_max, 1 << 20) and n not in checked:
            check_topk(torch, dc, x[None, :], kk, cfg.chunk,
                       f"DGC group of {n} entries, k {kk}")
            checked.add(n)
        sub_v, _ = dc.stage1_topk(x[None, :], kk, chunk=cfg.chunk)
        flat = sub_v.reshape(-1)
        s1 = cuda_ms(torch, lambda: dc.stage1_topk(x[None, :], kk,
                                                   chunk=cfg.chunk), 5)
        s2 = cuda_ms(torch, lambda: kops.topk_stable(flat, k), 5)
        nch = -(-n // cfg.chunk)
        padded = torch.nn.functional.pad(x, (0, nch * cfg.chunk - n),
                                         value=float("-inf"))
        lib = cuda_ms(torch, lambda: torch.topk(padded.view(nch, -1), kk,
                                                dim=1), 5)
        costs.append(dc.cost(1, n, kk, cfg.chunk))
        rows.append({"n": n, "k": k, "kk": kk, "survivors": flat.numel(),
                     "stage1_ms": s1, "stage2_ms": s2, "library_ms": lib})
        del vflat, x, sub_v, flat, padded
    if checked != {n_max, 1 << 20}:
        fail(f"DGC groups of {sorted(checked)} entries held against "
             f"stage1_topk_plain, not {n_max} and {1 << 20}")
    log(f"cnn phase: stage1_topk equals its plain version on DGC groups of "
        f"{sorted(checked)} entries")
    n_all = sum(r["n"] for r in rows)
    surv = sum(r["survivors"] for r in rows)
    bound, by = bound_ms(costs[0]._replace(
        ops=sum(c.ops for c in costs), bytes=sum(c.bytes for c in costs)))
    return rows, full_sort, {
        "groups": len(rows), "entries": n_all, "survivors": surv,
        "stage1_ms": sum(r["stage1_ms"] for r in rows),
        "stage2_sort_ms": sum(r["stage2_ms"] for r in rows),
        "library_ms": sum(r["library_ms"] for r in rows),
        "bound_ms": bound, "bound_by": by}


def dgc_gate(torch, dc, exp):
    """``dgc_exchange`` on one real step's FE gradients (a micro-batch of
    RES_MICRO images, the state after ``fit``) on the kernel backend against
    the ref backend: the thresholds bit-equal (and equal to a full sort's),
    the updates, u and v equal, as the masks then are; the kernel exchange
    launches ``stage1_topk`` once a group. Then the exchange timed, its
    selection taken apart and one exchange profiled."""
    from repro_torch.core import sparsify as sp_
    from repro_torch.train.trainer import to_device

    inputs = to_device(exp.data_fn(10**5 + 4, RES_MICRO), exp.device)
    _, g_fe, _ = _fe_grads(torch, exp, inputs)
    cfg = exp.train_cfg.dgc
    out = {}
    for backend in ("kernel", "ref"):
        before = dc.LAUNCHES
        out[backend] = sp_.dgc_exchange(g_fe, exp.state.dgc,
                                        dataclasses.replace(cfg,
                                                            backend=backend))
        torch.cuda.synchronize()
        out[backend + "_launches"] = dc.LAUNCHES - before
    (uk, sk, ik), (ur, sr, ir) = out["kernel"], out["ref"]
    n_groups = int(ik["thresholds"].numel())
    if out["kernel_launches"] != n_groups or out["ref_launches"] != 0:
        fail(f"the kernel exchange launched stage1_topk "
             f"{out['kernel_launches']} times for {n_groups} groups (ref: "
             f"{out['ref_launches']})")
    if not torch.equal(ik["thresholds"], ir["thresholds"]):
        fail(f"DGC thresholds differ between the kernel and the ref backend: "
             f"{ik['thresholds'].tolist()} / {ir['thresholds'].tolist()}")
    rows, full_sort, sel = dgc_selection_times(torch, dc, exp, g_fe)
    if ik["thresholds"].tolist() != full_sort:
        fail(f"DGC thresholds differ from a full sort's: "
             f"{ik['thresholds'].tolist()} / {full_sort}")
    for name, a, b in (("update", uk, ur), ("u", sk.u, sr.u),
                       ("v", sk.v, sr.v)):
        for x, y in zip(sp_.flatten(a)[0], sp_.flatten(b)[0]):
            if not torch.equal(x, y):
                fail(f"DGC {name} differs between the kernel and the ref "
                     f"backend")
    sent = int(float(ik["wire_bytes"]) / 8)
    state = exp.state.dgc
    xchg_ms = host_ms(torch, lambda: sp_.dgc_exchange(g_fe, state, cfg), 5)
    prof = profile_ms(torch, lambda: sp_.dgc_exchange(g_fe, state, cfg),
                      groups=KERNEL_GROUPS)
    log(f"cnn phase: DGC on one step's gradients ({n_groups} groups, "
        f"{sel['entries']} entries): thresholds bit-equal between backends "
        f"and to a full sort; updates, u, v equal; {sent} entries sent; "
        f"compression {float(ik['compression']):.1f}; stage1_topk "
        f"{out['kernel_launches']} launches")
    log(f"cnn phase: dgc_exchange {xchg_ms:.3f} ms (host, synchronised); "
        f"stage 1 {sel['stage1_ms']:.3f} ms over {n_groups} groups (bound "
        f"{sel['bound_ms']:.4f} by {sel['bound_by']}; torch.topk "
        f"{sel['library_ms']:.3f}), stage 2 sort {sel['stage2_sort_ms']:.3f} "
        f"ms of {sel['survivors']} survivors; profiled exchange {prof}")
    log("cnn phase: groups (n, k, survivors, stage 1 ms, stage 2 ms): "
        + "; ".join(f"{r['n']} {r['k']} {r['survivors']} "
                    f"{r['stage1_ms']:.4f} {r['stage2_ms']:.4f}"
                    for r in rows))
    del out, uk, sk, ur, sr, g_fe
    torch.cuda.empty_cache()
    return {"groups": n_groups, "thresholds_bit_equal": True,
            "compression": float(ik["compression"]),
            "wire_bytes": float(ik["wire_bytes"]),
            "dense_bytes": float(ik["dense_bytes"]),
            "exchange_ms": xchg_ms, "exchange_profile": prof,
            "selection": sel, "group_rows": rows}


def cnn_step_breakdown(torch, exp, reps: int = 3):
    """One n_micro = 1 step taken apart by CUDA events (median of
    ``reps``): trunk forward, head forward, head backward, trunk backward,
    ``dgc_exchange``, LARS and the update. The state is not changed."""
    from repro_torch.core import sparsify as sp_
    from repro_torch.optim import apply_updates, make_optimizer
    from repro_torch.train.trainer import to_device

    inputs = to_device(exp.data_fn(10**5 + 5, RES_MICRO), exp.device)
    opt = make_optimizer(exp.train_cfg)
    names = ("trunk forward", "head forward", "head backward",
             "trunk backward", "dgc_exchange", "LARS + update")
    times = {k: [] for k in names}
    st = exp.state
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        _, g_fe, g_hp = _fe_grads(torch, exp, inputs, ev)
        upd, _, _ = sp_.dgc_exchange(g_fe, st.dgc, exp.train_cfg.dgc)
        ev[5].record()
        with torch.no_grad():
            updates, _ = opt.update((upd, g_hp), st.opt_state,
                                    (st.fe_params, st.head_params), 0.4)
            apply_updates((st.fe_params, st.head_params), updates)
        ev[6].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            times[k].append(ev[i].elapsed_time(ev[i + 1]))
        del g_fe, g_hp, upd, updates
    return {k: statistics.median(v) for k, v in times.items()}


def cnn_phase(torch, np, counters, ce, dc):
    """The cnn slice's main path: ``fit(6)`` of ResNet-50 + DGC at the
    1M-class width with every counter reset just before and read just
    after, then the gates (the CE pair and stage 1 at this path's own
    shapes) and the timings. Returns (launches, numbers, {kernel: row at
    this path's shapes})."""
    from repro_torch.train.trainer import to_device

    exp = _cnn_experiment("kernel")
    fe0 = [t.clone() for t in _fe_leaves(exp)]
    w0 = exp.state.w_head.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    t0 = time.perf_counter()
    hist = exp.fit(FIT_STEPS, use_fccs_batch=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in _read(counters).items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batches = [r["batch"] for r in hist]
    log(f"cnn phase: fit({FIT_STEPS}) in {fit_s:.2f} s, batches {batches}, "
        f"launches {launches}, peak memory {peak_gb:.2f} GB")
    n_micro = sum(b // RES_MICRO for b in batches)
    want = {"ce_forward": n_micro, "ce_backward": n_micro,
            "stage1_topk": RES_DGC_GROUPS * FIT_STEPS}
    if launches != want:
        fail(f"the cnn + DGC training path launched {launches}, not {want}")
    if batches != [BTRAIN * n for n in (1, 1, 1, 2, 4, 4)]:
        fail(f"FCCS batches {batches}")
    if n_micro != 26:
        fail(f"{n_micro} micro-steps of {RES_MICRO}, not 2+2+2+4+8+8")
    losses = [r["loss"] for r in hist]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite cnn training losses {losses}")
    # a leaf none of whose entries was sent may stay (a GroupNorm bias of
    # zeros, where weight decay has nothing to pull)
    moved = sum(bool((a != b).any()) for a, b in zip(_fe_leaves(exp), fe0))
    if not (moved and float((exp.state.w_head - w0).abs().max()) > 0):
        fail("cnn training left the trunk or the class weights unchanged")
    log(f"cnn phase: losses {losses}; {moved} of {len(fe0)} trunk leaves "
        f"moved")
    del fe0, w0
    ce_rows = dict(zip(("ce_forward", "ce_backward"),
                       ce_cnn_rows(torch, ce, exp)))
    dgc = dgc_gate(torch, dc, exp)

    # the step at n_micro = 1 and 2, with and without DGC; one profiled
    from repro_torch.train import hybrid
    steps, metrics = {}, {}
    for n in (1, 2):
        step = exp.trainer._get_step(n)
        inputs = to_device(exp.data_fn(10**5 + n, RES_MICRO * n), exp.device)

        def one_step(step=step, inputs=inputs):
            exp.trainer.state, _, m = step(exp.trainer.state, inputs, 0.4)
            metrics.update(m)

        steps[n] = host_ms(torch, one_step, 5)
        if n == 1:
            prof = profile_ms(torch, one_step, groups=KERNEL_GROUPS)
        del inputs
    compression = float(metrics["comm_dense_bytes"]
                        / metrics["comm_wire_bytes"])
    dense_cfg = dataclasses.replace(exp.train_cfg, dgc=dataclasses.replace(
        exp.train_cfg.dgc, enabled=False))
    dense_step = hybrid.make_train_step(exp.model_cfg, exp.head_cfg,
                                        dense_cfg, n_micro=1, head=exp.head)
    inputs = to_device(exp.data_fn(10**5 + 1, RES_MICRO), exp.device)

    def dense_one():
        exp.trainer.state = dense_step(exp.trainer.state, inputs, 0.4)[0]

    dense_ms = host_ms(torch, dense_one, 5)
    del inputs
    parts = cnn_step_breakdown(torch, exp)
    log(f"cnn phase: step n_micro=1 {steps[1]:.2f} ms "
        f"({RES_MICRO / steps[1] * 1e3:.0f} images/s), n_micro=2 "
        f"{steps[2]:.2f} ms ({2 * RES_MICRO / steps[2] * 1e3:.0f} images/s); "
        f"without DGC {dense_ms:.2f} ms; compression {compression:.1f}; "
        f"parts (ms) {parts}; profiled: {prof}")
    if not compression > 100:
        fail(f"DGC compression {compression}: expected ~1 / (1 - 0.999)")

    # evaluate and serve image queries (greedy and top-5) at batch 64
    _reset(counters)
    acc = exp.evaluate()
    ev_launch = _read(counters)
    queries = exp.data_fn(10**6 + 7, B)
    serve_ms, serve_launch = {}, {}
    for name, kw in (("greedy", {}), ("top5", {"top_k": K})):
        _reset(counters)
        ids = exp.serve(queries, **kw)
        serve_launch[name] = {k: v for k, v in _read(counters).items() if v}
        if np.asarray(ids).shape != ((B,) if not kw else (B, K)) or not (
                0 <= np.asarray(ids).min() and np.asarray(ids).max() < V):
            fail(f"cnn {name} serve returned ids of shape "
                 f"{np.asarray(ids).shape}")
        # through the engine (the images made by data_fn, copied to the
        # host, submitted one by one, re-stacked and copied back), and the
        # single-shot step on images already on the card
        serve_ms[name] = host_ms(torch, lambda kw=kw: exp.serve(
            batch=B, **kw), 5)
        serve_ms[name + "_on_card"] = host_ms(
            torch, lambda kw=kw: exp.serve(queries, **kw), 5)
    serve_ms["data_fn"] = host_ms(torch, lambda: exp.data_fn(10**6, B), 5)
    serve_prof = {
        "engine": profile_ms(torch, lambda: exp.serve(batch=B)),
        "on_card": profile_ms(torch, lambda: exp.serve(queries))}
    greedy_ids = exp.serve(queries)
    top_ids = exp.serve(queries, top_k=K)
    if not np.array_equal(greedy_ids, top_ids[:, 0]):
        fail("cnn serve: greedy ids differ from the top-1 of the top-5")
    if not (ev_launch["ce_forward"] and serve_launch["greedy"].get(
            "ce_forward") and serve_launch["top5"].get("stage1_topk")):
        fail(f"cnn evaluate / serve launches {ev_launch} {serve_launch}")
    log(f"cnn phase: evaluate() {acc} (launches "
        f"{ {k: v for k, v in ev_launch.items() if v} }); serve {B} image "
        f"queries through the engine greedy {serve_ms['greedy']:.2f} ms, "
        f"top-5 {serve_ms['top5']:.2f} ms; on the card greedy "
        f"{serve_ms['greedy_on_card']:.2f} ms, top-5 "
        f"{serve_ms['top5_on_card']:.2f} ms; making the images "
        f"{serve_ms['data_fn']:.2f} ms; launches {serve_launch}; profiled "
        f"greedy {serve_prof}")
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    # kernel vs ref backends (head and DGC) with the trunk in fp32
    out = {}
    for backend in ("kernel", "ref"):
        e = _cnn_experiment(backend, dtype="float32")
        h = e.fit(2, use_fccs_batch=True)
        torch.cuda.synchronize()
        out[backend] = ([r["loss"] for r in h], [r["batch"] for r in h],
                        e.state.w_head[:4].clone())
        del e
        gc.collect()
        torch.cuda.empty_cache()
    (lk, bk, wk), (lr_, br, wr) = out["kernel"], out["ref"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lr_))
    log(f"cnn phase: fp32 trunk, kernel vs ref losses {lk} / {lr_} (max rel "
        f"{loss_rel:.3g}), batches {bk}")
    if loss_rel > 1e-4 or bk != br:
        fail(f"cnn kernel and ref losses differ by rel {loss_rel:.3g}")
    launcher = cnn_launchers_phase(torch)
    return launches, {
        "cnn_fit_s": fit_s, "cnn_fit_losses": losses, "cnn_fit_batches":
        batches, "cnn_peak_memory_gb": peak_gb, "cnn_leaves_moved": moved,
        "cnn_step_ms_n1": steps[1], "cnn_step_ms_n2": steps[2],
        "cnn_images_per_s_n1": RES_MICRO / steps[1] * 1e3,
        "cnn_images_per_s_n2": 2 * RES_MICRO / steps[2] * 1e3,
        "cnn_step_ms_n1_without_dgc": dense_ms,
        "cnn_step_parts_ms": parts, "cnn_step_profile": prof,
        "cnn_compression": compression, "cnn_dgc": dgc,
        "cnn_evaluate_accuracy": acc, "cnn_serve_ms": serve_ms,
        "cnn_serve_launches": serve_launch, "cnn_serve_profile": serve_prof,
        "cnn_fp32_kernel_vs_ref_loss_max_rel": loss_rel,
        "cnn_launchers": launcher}, ce_rows


def _fe_leaves(exp):
    from repro_torch.core import sparsify as sp_
    return sp_.flatten(exp.state.fe_params)[0]


def cnn_launchers_phase(torch):
    """``repro_torch.launch.train --trunk cnn --dgc --backend kernel`` at
    the 1M-class width (the launcher's reduced ResNet, D=128, on 32 x 32
    images) for 4 FCCS steps, with the full head and with ``--head knn``,
    in this process: each must return 0 and print a finite accuracy."""
    import contextlib
    import io

    from repro_torch.launch import train as train_launcher

    res = {}
    for head in ("full", "knn"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_launcher.main(
                ["--trunk", "cnn", "--dgc", "--backend", "kernel", "--head",
                 head, "--classes", str(V), "--batch", str(BTRAIN),
                 "--steps", "4", "--fccs", "--optimizer", "lars",
                 "--device", DEVICE])
        wall = time.perf_counter() - t0
        acc = [line for line in out.getvalue().splitlines()
               if "final eval accuracy" in line]
        if rc != 0 or not acc or not math.isfinite(float(acc[-1].split()[-1])):
            fail(f"train launcher --trunk cnn --dgc --head {head} returned "
                 f"{rc}: {out.getvalue()[-500:]}")
        log(f"cnn phase: train launcher --trunk cnn --dgc --head {head}: "
            f"{acc[-1]} ({wall:.1f} s)")
        res[head] = {"s": wall, "accuracy": float(acc[-1].split()[-1])}
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# IVF serving (the main path of the IVF slice) and its launcher
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# checkpoints (the main path of the checkpoint slice)
# ---------------------------------------------------------------------------


def _host_peak_gb() -> float:
    """This process's peak resident host memory so far (ru_maxrss, KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _micro_step_diff(torch, exp) -> dict:
    """Which part of one cnn micro-step differs between two runs on the
    same state and images: the loss (the trunk's and the head's forward),
    the head's gradient, and the trunk's gradients leaf by leaf (the
    trunk's backward: its convolutions and GroupNorms)."""
    from repro_torch.core import sparsify as sp_
    from repro_torch.train.trainer import to_device

    inputs = to_device(exp.data_fn(10**5 + 9, RES_MICRO), exp.device)
    (la, ga, ha), (lb, gb, hb) = (_fe_grads(torch, exp, inputs)
                                  for _ in range(2))
    names = [k for k, _ in sp_.flatten(ga, with_paths=True)[0]]
    differ = [n for n, x, y in zip(names, sp_.flatten(ga)[0],
                                   sp_.flatten(gb)[0])
              if not torch.equal(x, y)]
    return {"loss_equal": bool(torch.equal(la, lb)),
            "head_grad_equal": bool(torch.equal(ha, hb)),
            "trunk_grads_differ": len(differ), "trunk_grads": len(names),
            "differing_leaves": differ[:8]}


def _ckpt_cnn(torch, counters, root) -> tuple:
    """Kill and recover of ResNet-50 + DGC at the 1M-class width: two
    uninterrupted ``fit(6)`` runs from one state set the equivalence class
    the harness holds the recovery to; the victim checkpoints every 4
    steps and dies before step 5; a fresh experiment restores t = 4 and
    replays steps 4 and 5. Returns (launches of the resumed leg, numbers)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.resilience import kill_and_recover, tree_compare

    fit_kw = {"use_fccs_batch": True}

    def make(ckpt_dir):
        return _cnn_experiment("kernel", ckpt_dir=ckpt_dir,
                               ckpt_every=CKPT_EVERY)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = make(None)
    ref.fit(CKPT_TOTAL, **fit_kw)
    twin = make(None)
    twin.fit(CKPT_TOTAL, **fit_kw)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    det = tree_compare(twin.trainer._snapshot(), ref.trainer._snapshot())
    twin_loss = [r["loss"] for r in twin.trainer.history]
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    equivalence = "bitwise" if det["bitwise"] else "trajectory"
    log(f"checkpoint phase: two uninterrupted fit({CKPT_TOTAL}) runs from "
        f"one state ({twin_s:.1f} s): bitwise {det['bitwise']}, max |diff| "
        f"{det['max_abs_diff']:.3g}, {len(det['mismatches'])} leaves differ "
        f"(first {det['mismatches'][:4]}), losses "
        f"{[r['loss'] for r in ref.trainer.history]} / {twin_loss}: the "
        f"recovery is held to {equivalence!r}")

    t0 = time.perf_counter()
    rep = kill_and_recover(
        make, total_steps=CKPT_TOTAL, kill_at=CKPT_KILL,
        ckpt_dir=str(root / "cnn"), equivalence=equivalence,
        head="full+cnn+dgc", fit_kw=fit_kw, reference=ref,
        before_resume=lambda: _reset(counters))
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read(counters).items() if v}
    harness_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    replayed = [r["step"] for r in rep.resumed_history]
    n_micro = sum(r["batch"] // RES_MICRO for r in rep.resumed_history)
    want = {"ce_forward": n_micro, "ce_backward": n_micro,
            "stage1_topk": RES_DGC_GROUPS * len(replayed)}
    log(f"checkpoint phase: {rep.summary()}; verdict {rep.equivalence}, "
        f"bitwise {rep.bitwise}, max_abs_diff {rep.max_abs_diff:.3g}, loss "
        f"max rel {rep.loss_max_rel:.3g}; restored t={rep.restored_step}, "
        f"steps replayed {rep.steps_replayed} (ran {replayed}); save "
        f"{rep.save_s:.2f} s (the leaves to the host {rep.save_fetch_s:.2f} "
        f"s, encoding, compression and the file the rest), restore "
        f"{rep.restore_s:.2f} s (the file read and decoded "
        f"{rep.restore_read_s:.2f} s, the state onto the card "
        f"{rep.restore_place_s:.2f} s; fresh experiment + restore "
        f"{rep.recovery_s:.2f} s), {rep.ckpt_bytes} bytes, codec "
        f"{ckpt.codec_name()}; host peak RSS {_host_peak_gb():.2f} GB, card "
        f"peak {peak_gb:.2f} GB; resumed leg launches {launches}")
    if not rep.ok:
        fail(f"kill and recover at the 1M-class width: {rep.summary()} "
             f"(loss max rel {rep.loss_max_rel:.3g})")
    if (rep.restored_step, rep.steps_replayed, replayed) != (
            CKPT_EVERY, CKPT_KILL - CKPT_EVERY,
            list(range(CKPT_EVERY, CKPT_TOTAL))):
        fail(f"restored t={rep.restored_step}, replayed {replayed}")
    if launches != want:
        fail(f"the resumed leg launched {launches}, not {want}")
    out = {"equivalence": rep.equivalence, "bitwise": rep.bitwise,
           "two_runs_bitwise": det["bitwise"],
           "two_runs_max_abs_diff": det["max_abs_diff"],
           "two_runs_leaves_differ": len(det["mismatches"]),
           "max_abs_diff": rep.max_abs_diff,
           "loss_max_rel": rep.loss_max_rel,
           "restored_step": rep.restored_step,
           "steps_replayed": rep.steps_replayed, "replayed": replayed,
           "save_s": rep.save_s, "save_fetch_s": rep.save_fetch_s,
           "restore_s": rep.restore_s,
           "restore_read_s": rep.restore_read_s,
           "restore_place_s": rep.restore_place_s,
           "recovery_s": rep.recovery_s, "ckpt_bytes": rep.ckpt_bytes,
           "codec": ckpt.codec_name(), "harness_s": harness_s,
           "card_peak_gb": peak_gb, "resumed_launches": launches}
    if not det["bitwise"]:
        out["micro_step_diff"] = _micro_step_diff(torch, ref)
        log(f"checkpoint phase: one micro-step run twice: "
            f"{out['micro_step_diff']}")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def _ckpt_knn(torch) -> dict:
    """The knn head on the feats trunk at the 1M-class width: train past a
    graph refresh, save, restore into a fresh experiment (whose own graph
    was built on its initial weights), hold the snapshots equal leaf for
    leaf (the graph, one step stale, included), then one more step on
    each."""
    from repro_torch.resilience import tree_compare
    from repro_torch.telemetry import Tracer

    root = CKPT_DIR / "knn"

    def make():
        return _train_experiment("kernel", rebuild_every=3,
                                 knn_pad_random=True,
                                 exp_kw={"ckpt_dir": str(root)})

    a = make()
    a.fit(4, use_fccs_batch=True)            # refreshed after step 2
    torch.cuda.synchronize()
    tele = Tracer()                           # the save's and restore's parts
    a.trainer.telemetry = tele
    t0 = time.perf_counter()
    fname = a.trainer.save_checkpoint()
    save_s = time.perf_counter() - t0
    b = make()
    b.trainer.telemetry = tele
    fresh_graph_differs = not all(
        torch.equal(x, y) for x, y in zip(a.state.head_aux, b.state.head_aux))
    t0 = time.perf_counter()
    step = b.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    cmp0 = tree_compare(b.trainer._snapshot(), a.trainer._snapshot())
    ha = a.fit(1, use_fccs_batch=True)
    hb = b.fit(1, use_fccs_batch=True)
    cmp1 = tree_compare(b.trainer._snapshot(), a.trainer._snapshot())
    la, lb = ha[-1]["loss"], hb[-1]["loss"]
    nnz = int(a.state.head_aux[1].numel())
    c = tele.counters
    parts = {"save_fetch_s": c["train.checkpoint.fetch_s"],
             "restore_read_s": c["train.restore.read_s"],
             "restore_place_s": c["train.restore.place_s"]}
    out = {"restored_step": step, "save_s": save_s, "restore_s": restore_s,
           **parts,
           "ckpt_bytes": os.path.getsize(fname), "graph_entries": nnz,
           "fresh_graph_differs": fresh_graph_differs,
           "restored_bitwise": cmp0["bitwise"],
           "after_step_bitwise": cmp1["bitwise"],
           "after_step_max_abs_diff": cmp1["max_abs_diff"],
           "after_step_losses": [la, lb]}
    log(f"checkpoint phase, knn: saved t=4 (graph from the refresh after "
        f"step 2) in {save_s:.2f} s (to the host {parts['save_fetch_s']:.2f}"
        f" s), {out['ckpt_bytes']} bytes, {nnz} graph entries; restored into "
        f"a fresh experiment in {restore_s:.2f} s (read and decoded "
        f"{parts['restore_read_s']:.2f} s, onto the card "
        f"{parts['restore_place_s']:.2f} s): "
        f"snapshot bitwise {cmp0['bitwise']} {cmp0['mismatches'][:4]}; one "
        f"more step each: losses {la} / {lb}, bitwise {cmp1['bitwise']}, "
        f"max |diff| {cmp1['max_abs_diff']:.3g} {cmp1['mismatches'][:4]}")
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    if not (cmp0["bitwise"] and step == 4 and fresh_graph_differs):
        fail(f"knn restore at the 1M-class width: step {step}, bitwise "
             f"{cmp0['bitwise']} {cmp0['mismatches'][:8]}")
    if not cmp1["bitwise"]:
        fail(f"knn: one step from the restored state and from the saved "
             f"one differ in {cmp1['mismatches'][:8]} (losses {la} / {lb})")
    return out


def _ckpt_ivf(torch, np) -> dict:
    """The fitted IVF index of the 1M-class full head through a
    checkpoint: saved, restored onto the card, installed, and serving
    top-5 at batch 64 the ids and scores it served before the save."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.serving import IVFIndex

    exp = _train_experiment("kernel")
    idx = exp.ivf_index(refit=True)
    ids0, sc0 = exp.serve(batch=B, top_k=K, return_scores=True, index="ivf")
    root = str(CKPT_DIR / "ivf")
    t0 = time.perf_counter()
    ckpt.save(root, idx.state_to_save(), step=0)
    tree, _ = ckpt.restore(root, idx.state_to_save(), step=0)
    back = IVFIndex.state_from_restore(tree, device=DEVICE)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if not (back.members.device.type == DEVICE
            and torch.equal(back.centroids, idx.centroids)
            and torch.equal(back.members, idx.members)
            and np.array_equal(back.counts, idx.counts)
            and back.version == idx.version):
        fail("the IVF index changed through its checkpoint")
    exp.install_ivf_index(back)
    if exp.ivf_index() is not back:
        fail("the restored IVF index was refit instead of served")
    ids1, sc1 = exp.serve(batch=B, top_k=K, return_scores=True, index="ivf")
    if not (np.array_equal(ids0, ids1) and np.array_equal(sc0, sc1)):
        fail("top-5 through the restored IVF index differs")
    log(f"checkpoint phase, IVF: {idx.n_clusters} clusters of cap {idx.cap} "
        f"saved, restored and installed in {round_s:.2f} s; top-5 of {B} "
        f"queries equal before and after")
    del exp, idx, back
    gc.collect()
    torch.cuda.empty_cache()
    return {"clusters": int(tree["meta"]["n_clusters"]), "round_trip_s":
            round_s}


def _ckpt_launcher() -> dict:
    """``launch.train --ckpt-dir D --ckpt-every 2 --steps 4`` on the card
    at the 1M-class width (``train_launcher_phase``'s flags), then
    ``--resume --steps 6``: both exit 0, the second from t = 4."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    root = str(CKPT_DIR / "launcher")
    out = {}
    for tag, extra in (("first", ["--steps", "4"]),
                       ("resumed", ["--steps", "6", "--resume"])):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--system",
               "paper", "--head", "full", "--classes", str(V), "--feat-dim",
               str(D), "--batch", str(BTRAIN), "--fccs", "--backend",
               "kernel", "--ckpt-dir", root, "--ckpt-every", "2"] + extra
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        out[f"{tag}_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"train launcher {' '.join(extra)} with checkpoints exited "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        out[f"{tag}_steps"] = sorted(int(f.split("_")[1].split(".")[0])
                                     for f in os.listdir(root))
    if "resumed at t=4: 2 steps to 6" not in proc.stdout:
        fail(f"the resumed launcher did not start at t=4: "
             f"{proc.stdout[-1000:]}")
    if (out["first_steps"], out["resumed_steps"]) != ([2, 4], [2, 4, 6]):
        fail(f"launcher checkpoints {out}")
    log(f"checkpoint phase, launcher: --steps 4 {out['first_s']:.1f} s, "
        f"--resume --steps 6 {out['resumed_s']:.1f} s (from t=4); files at "
        f"steps {out['resumed_steps']}")
    return out


def checkpoint_phase(torch, np, counters) -> tuple:
    """The checkpoint slice: kill and recover at full width (ResNet-50 +
    DGC), the knn head's graph through a checkpoint, the IVF index's
    files, and the launcher's resume. The files go under
    ``build/chip_ckpt`` and are removed at the end. Returns (the resumed
    leg's launches, numbers)."""
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        launches, out = _ckpt_cnn(torch, counters, CKPT_DIR)
        shutil.rmtree(CKPT_DIR / "cnn")
        out["knn"] = _ckpt_knn(torch)
        shutil.rmtree(CKPT_DIR / "knn")
        out["ivf"] = _ckpt_ivf(torch, np)
        out["launcher"] = _ckpt_launcher()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out["host_peak_rss_gb"] = _host_peak_gb()
    out["phase_s"] = time.perf_counter() - t0
    log(f"checkpoint phase: {out['phase_s']:.1f} s")
    return launches, out


def check_ivf(torch, ivf, f, w, cand, k, label, exact_ids=False,
              members=None, probe=None):
    """ivf_rerank's kernel, twice (the runs must agree bit for bit), vs its
    plain version on ``cand``: the same slots filled, values within IVF_TOL
    times the scores' scale (max(1, max|plain value|): 1 for the unit rows
    the serve path scores), ids equal except, unless ``exact_ids``, at
    slots whose plain value lies within that tolerance of a neighbouring
    slot's (or of the first value left out). With ``members`` and
    ``probe`` (whose ``members[probe].reshape(B, -1)`` is ``cand``) it runs
    the probed entry, the serve path's, instead of the generic one.
    Returns (largest value error, ids that differ, the kernel's result)."""
    if members is None:
        def run():
            return ivf.ivf_rerank(f, w, cand, k)
    else:
        def run():
            return ivf.ivf_rerank_probed(f, w, members, probe, k)
    v1, i1 = run()
    v2, i2 = run()
    pv, pi = ivf.ivf_rerank_plain(f, w, cand, k + 1)
    torch.cuda.synchronize()
    if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
        fail(f"ivf_rerank {label}: two runs on the same inputs differ")
    ext = pv
    pv, pi = pv[:, :k], pi[:, :k]
    if not torch.equal(i1 >= 0, pi >= 0):
        fail(f"ivf_rerank {label}: filled slots differ")
    both = pi >= 0
    err = float((v1[both] - pv[both]).abs().max()) if both.any() else 0.0
    tol = IVF_TOL * max(1.0, float(pv[both].abs().max()) if both.any()
                        else 0.0)
    if err > tol:
        fail(f"ivf_rerank {label}: values differ by {err:.3g} (tolerance "
             f"{tol:.3g})")
    bad = i1 != pi
    if not exact_ids:
        gaps = (ext[:, :-1] - ext[:, 1:]).abs()
        gap_prev = torch.nn.functional.pad(gaps, (1, 0),
                                           value=float("inf"))[:, :k]
        near = (gap_prev < tol) | (gaps[:, :k] < tol)
        bad &= ~near
    if bool(bad.any()):
        rows = bad.any(dim=1).nonzero()[:4, 0].tolist()
        fail(f"ivf_rerank ids {label}: rows {rows} kernel {i1[rows].tolist()} "
             f"plain {pi[rows].tolist()}")
    return err, int((i1 != pi).sum()), (v1, i1)


def check_ivf_both(torch, ivf, f, w, cand, k, label, p, exact_ids=False):
    """``check_ivf`` through both entries: the generic one on cand [B, A],
    and the probed one on cand cut into B * p clusters of A / p slots, each
    query probing its own p in order (the same candidate positions). The
    two entries must give the same bits."""
    b, a = cand.shape
    members = cand.reshape(b * p, a // p)
    probe = torch.arange(b * p, device=cand.device,
                         dtype=torch.int32).reshape(b, p)
    err, _, gen = check_ivf(torch, ivf, f, w, cand, k, label, exact_ids)
    _, _, prb = check_ivf(torch, ivf, f, w, cand, k, f"{label}, probed",
                          exact_ids, members, probe)
    if not all(torch.equal(x, y) for x, y in zip(gen, prb)):
        fail(f"ivf_rerank {label}: the probed entry differs from the generic "
             f"one")
    return err


def ivf_ragged_checks(torch, ivf):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    v, d, b, a = 5013, 36, 37, 3000
    f = torch.randn((b, d), generator=g, device=dev)
    w = torch.randn((v, d), generator=g, device=dev) * 0.1
    cand = torch.randint(0, v, (b, a), generator=g, device=dev,
                         dtype=torch.int32)
    cand[torch.rand((b, a), generator=g, device=dev) < 0.2] = -1
    cand[0] = -1                               # nothing real
    cand[1, 3:] = -1                           # fewer real candidates than k
    cand[2, 1500:] = cand[2, :1500]            # every candidate twice
    cand[4, 7:40] = v + 11                     # past the shard: clipped
    for k in (1, 5, 32):
        check_ivf_both(torch, ivf, f, w, cand, k, f"ragged k={k}", 4)
    check_ivf_both(torch, ivf, f, w, cand[:, :7].contiguous(), 32, "A=7 < k",
                   1)
    # integer-valued inputs: every score exact, so equal rows and repeated
    # candidates tie exactly and the earlier candidate position must win
    fi = torch.randint(-3, 4, (b, 64), generator=g, device=dev).float()
    wi = torch.randint(-3, 4, (v, 64), generator=g, device=dev).float()
    wi[4000:4100] = wi[17]
    ci = torch.randint(0, v, (b, 2500), generator=g, device=dev,
                       dtype=torch.int32)
    ci[:, 40:140] = torch.arange(4000, 4100, device=dev, dtype=torch.int32)
    ci[:, 2000:2100] = 17
    ci[3, ::3] = -1
    for k in (5, 32):
        err = check_ivf_both(torch, ivf, fi, wi, ci, k, f"integer ties k={k}",
                             5, exact_ids=True)
        if err != 0.0:
            fail(f"ivf_rerank integer ties k={k}: values differ by {err}")
    # the serving width, ragged pads
    fw = torch.randn((5, D), generator=g, device=dev)
    ww = torch.randn((v, D), generator=g, device=dev)
    cw = torch.randint(-1, v, (5, 2049), generator=g, device=dev,
                       dtype=torch.int32)
    check_ivf_both(torch, ivf, fw, ww, cw, 5, f"D={D}, A=2049", 3)
    # the zoo's widths (ROADMAP A.9.2), more queries a cluster than a tile
    # holds, repeated probes across queries, a cluster nobody probes
    for dd in DEEP_DIMS[1:]:
        wd = torch.randn((3000, dd), generator=g, device=dev)
        fd = torch.randn((24, dd), generator=g, device=dev)
        md = torch.randint(-1, 3000, (40, 300), generator=g, device=dev,
                           dtype=torch.int32)
        md[5, 100:] = -1
        pd = torch.stack([torch.randperm(39, generator=g, device=dev)[:6]
                          for _ in range(24)]).to(torch.int32)
        pd[:8, 0] = 7                           # one cluster, 8+ queries
        cd = md[pd.long()].reshape(24, -1).contiguous()
        for k in (5, 32):
            check_ivf(torch, ivf, fd, wd, cd, k, f"D={dd} k={k}, probed",
                      members=md, probe=pd)
    log("IVF phase: ivf_rerank ragged shapes (through both entries, which "
        "agree bit for bit), exact ties, ids past the shard, k up to 32 and "
        f"D up to {DEEP_DIMS[-1]} agree with the plain version, "
        "bit-identical across runs")


def ivf_union_bytes(torch, members, probe, b, k, d=D):
    """The cost of a rerank of these probes (``ivf_rerank.cost``: every
    real row of the probed clusters read once, f, the probe and the
    result; 2 d operations a real candidate), the distinct rows and the
    real candidates."""
    from repro_torch.kernels import ivf_rerank
    used = torch.unique(probe[:b])
    rows = members[used.long()]
    union = int((rows >= 0).sum())
    n_real = int((members[probe[:b].long()] >= 0).sum())
    return (ivf_rerank.cost(b, d, k, union, n_real, probe[:b].numel()),
            union, n_real)


def _probe_candidates(torch, ops, sharded, f, idx, nprobe):
    """The serve body's probe, the top-``nprobe`` centroids of each
    normalised query, and the candidates it names: their member slots in
    probe order (what the ``ref`` backend builds)."""
    _, probe = ops.topk_stable(sharded._normalize(f) @ idx.centroids.T,
                               nprobe)
    cand = idx.members[probe.long()].reshape(f.shape[0], -1).contiguous()
    return probe.contiguous(), cand


def _same_topk(np, ids, vals, rids, rvals, what):
    """ids / vals against a reference's: values within IVF_TOL, ids equal
    except next to an adjacent reference gap below IVF_TOL. Returns the
    largest value error."""
    err = float(np.abs(vals - rvals).max())
    if not np.all(np.isfinite(vals)) or err > IVF_TOL:
        fail(f"{what}: scores differ by up to {err:.3g}")
    gaps = np.diff(rvals, axis=1) > -IVF_TOL
    near = np.pad(gaps, ((0, 0), (0, 1))) | np.pad(gaps, ((0, 0), (1, 0)))
    if not ((ids == rids) | near).all():
        fail(f"{what}: ids differ")
    return err


def _recall(np, exp, queries, nprobe):
    exact = exp.serving_engine(top_k=K, max_batch=B, max_wait_ms=0.0)
    ivf_eng = exp.serving_engine(top_k=K, max_batch=B, max_wait_ms=0.0,
                                 index="ivf", nprobe=nprobe)
    hits = []
    for r0 in range(0, queries.shape[0], B):
        q = queries[r0:r0 + B]
        ids_e = exact.step_fn(q, B)[0]
        ids_i = ivf_eng.step_fn(q, B)[0]
        hits += [len(set(e) & set(i)) / K for e, i in zip(ids_e, ids_i)]
    return float(np.mean(hits))


def ivf_phase(torch, np, ivf, sharded):
    from repro_torch import testing
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig
    from repro_torch.kernels import ops
    from repro_torch.train import hybrid

    ivf_ragged_checks(torch, ivf)
    exp = Experiment.from_config(
        system="paper", classes=V, feat_dim=D, batch=B, seed=0,
        device=DEVICE, head=HeadConfig(softmax_impl="full", backend="kernel"))
    torch.cuda.synchronize()

    # -- the fit, twice: bit-identical, every valid row packed once ---------
    idx = exp.ivf_index(refit=True)
    idx2 = exp.ivf_index(refit=True)
    if not (torch.equal(idx.centroids, idx2.centroids)
            and torch.equal(idx.members, idx2.members)):
        fail("two IVF fits of the same weights differ")
    exp.install_ivf_index(idx)
    fit2_s = {k: round(v, 4) for k, v in idx2.fit_s.items()}
    del idx2
    rows = idx.members[idx.members >= 0]
    if not torch.equal(torch.sort(rows).values,
                       torch.arange(V, device=rows.device, dtype=torch.int32)):
        fail("the IVF packing does not hold every class exactly once")
    c, cap, nprobe = idx.n_clusters, idx.cap, idx.nprobe
    fit_s = {k: round(v, 4) for k, v in idx.fit_s.items()}
    log(f"IVF phase: {c} clusters of cap {cap}, nprobe {nprobe}; two fits "
        f"bit-identical, seconds by part {fit_s} and {fit2_s}")

    # -- the main path: launches counted around one IVF top-5 serve ---------
    ivf.LAUNCHES = 0
    tids, tscores = exp.serve(batch=B, top_k=K, return_scores=True,
                              index="ivf")
    launches = {"ivf_rerank": ivf.LAUNCHES}
    if launches["ivf_rerank"] < 1:
        fail("the IVF serving path never launched ivf_rerank")
    log(f"IVF phase: launches on the main path {launches}")
    if tids.shape != (B, K) or tscores.shape != (B, K):
        fail(f"IVF result shapes {tids.shape} {tscores.shape}")
    if not np.all((tids >= 0) & (tids < V)):
        fail("IVF class ids out of range")
    if not np.all(np.isfinite(tscores)) or np.any(np.diff(tscores, 1) > 0):
        fail("IVF top-k scores not finite or not descending")

    # -- the ref backend on the same index and queries ----------------------
    q = exp.data_fn(10**6, B)["features"]
    ref_cfg = dataclasses.replace(exp.head_cfg, backend="ref")
    ref_step = hybrid.make_batched_ivf_topk_serve_step(
        exp.model_cfg, ref_cfg, K, nprobe=nprobe)
    rvals, rgids = (t.cpu().numpy() for t in ref_step(
        exp.state, idx.centroids, idx.members, q, B))
    ref_err = _same_topk(np, tids, tscores, rgids, rvals,
                         "IVF kernel vs ref backend")
    log(f"IVF phase: kernel backend agrees with ref (score max abs err "
        f"{ref_err:.3g})")

    # -- the kernel at the serving shapes: these queries' real candidates,
    #    through the probed entry that serving launches ---------------------
    f = sharded._normalize(q.float())
    wn = sharded._normalize(exp.state.w_head)
    members = idx.members
    probe, cand = _probe_candidates(torch, ops, sharded, f, idx, nprobe)
    err, swaps, prb = check_ivf(torch, ivf, f, wn, cand, K, "serving shapes",
                                members=members, probe=probe)
    _, _, gen = check_ivf(torch, ivf, f, wn, cand, K,
                          "serving shapes, generic entry")
    if not all(torch.equal(x, y) for x, y in zip(gen, prb)):
        fail("ivf_rerank serving shapes: the probed entry differs from the "
             "generic one")
    # skew: all 64 queries probe the first query's 31 clusters
    probe_sk = probe[:1].expand(B, -1).contiguous()
    cand_sk = cand[:1].expand(B, -1).contiguous()
    check_ivf(torch, ivf, f, wn, cand_sk, K, "skewed probe", members=members,
              probe=probe_sk)
    ms = cuda_ms(torch, lambda: ivf.ivf_rerank_probed(f, wn, members, probe,
                                                      K), 20)
    # batch 1: a different query each launch, so its 31 clusters (~80 MB)
    # are not left in the 50 MB L2 by the launch before
    turn = iter(range(10**9))

    def one():
        i = next(turn) % B
        return ivf.ivf_rerank_probed(f[i:i + 1], wn, members,
                                     probe[i:i + 1], K)
    b1_ms = cuda_ms(torch, one, 2 * B)
    skew_ms = cuda_ms(torch, lambda: ivf.ivf_rerank_probed(
        f, wn, members, probe_sk, K), 20)
    gen_ms = cuda_ms(torch, lambda: ivf.ivf_rerank(f, wn, cand, K), 20)
    plain_ms = cuda_ms(torch, lambda: ivf.ivf_rerank_plain(f, wn, cand, K), 3)
    safe = cand.clamp_min(0).long()
    lib_ms = cuda_ms(torch, lambda: torch.einsum("bd,bad->ba", f, wn[safe]), 3)
    del safe
    union_cost, union, n_real = ivf_union_bytes(torch, members, probe, B, K)
    union_bytes = union_cost.bytes
    gathered_bytes = 4 * D * n_real + union_bytes - 4 * D * union
    bound, by = bound_ms(union_cost)
    gathered_ms = gathered_bytes / HBM_BYTES_PER_S * 1e3
    b1 = []
    for i in range(B):
        b1.append(bound_ms(ivf_union_bytes(torch, members, probe[i:i + 1], 1,
                                           K)[0])[0])
    b1_bound = statistics.mean(b1)
    skew_bound, skew_by = bound_ms(ivf_union_bytes(torch, members, probe_sk,
                                                   B, K)[0])
    log(f"IVF phase: ivf_rerank (probed entry) at B={B}, P={nprobe} x cap "
        f"{members.shape[1]} ({n_real} real candidates, {union} distinct "
        f"rows) agrees (values max abs err {err:.3g}, ids swapped at "
        f"near-ties {swaps}), the generic entry bit for bit; {ms:.3f} ms, "
        f"bound {bound:.3f} ms by {by} on the union's "
        f"{union_bytes / 1e9:.3f} GB ({gathered_ms:.3f} ms on the "
        f"{gathered_bytes / 1e9:.3f} GB gathered); batch 1 {b1_ms:.4f} ms "
        f"(bound {b1_bound:.4f}, mean over the {B} queries); skewed (64 "
        f"queries on 31 clusters) {skew_ms:.3f} ms (bound {skew_bound:.4f} "
        f"by {skew_by}); generic entry on cand {gen_ms:.3f} ms; plain "
        f"{plain_ms:.3f} ms, gathered einsum {lib_ms:.3f} ms")
    kernel_row = dict(
        name="ivf_rerank", route="cuda",
        source="src/repro_torch/kernels/csrc/ivf_rerank.cu",
        replaces="src/repro/kernels/ivf_rerank.py:97",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms,
        library="einsum('bd,bad->ba', f, W[cand]) (gather + cuBLAS fp32)",
        gathered_bytes=gathered_bytes, union_bytes=union_bytes,
        gathered_bound_ms=gathered_ms, real_candidates=n_real,
        distinct_rows=union, near_tie_id_swaps=swaps,
        b1_ms=b1_ms, b1_bound_ms=b1_bound, skew_ms=skew_ms,
        skew_bound_ms=skew_bound, generic_entry_ms=gen_ms,
        shape=f"f[{B},{D}] W[{V},{D}] members[{members.shape[0]},"
              f"{members.shape[1]}] probe[{B},{nprobe}] k={K}")
    del wn, cand, cand_sk

    # -- nprobe = C through the kernel against the exact top-5 --------------
    fids, fvals = exp.serve(batch=B, top_k=K, return_scores=True,
                            index="ivf", nprobe=c)
    eids, evals = exp.serve(batch=B, top_k=K, return_scores=True)
    full_err = _same_topk(np, fids, fvals, eids, evals,
                          "IVF at nprobe=C vs the exact scan")
    log(f"IVF phase: nprobe=C equals the exact top-5 (score max abs err "
        f"{full_err:.3g}, ids equal: {bool(np.array_equal(fids, eids))})")

    # -- batch latency, exact vs IVF, and one profiled IVF serve ------------
    lat = {}
    for b in (B, 1):
        lat[f"exact_top5_b{b}_ms"] = host_ms(torch, lambda b=b: exp.serve(
            batch=b, top_k=K, return_scores=True), 10)
        lat[f"ivf_top5_b{b}_ms"] = host_ms(torch, lambda b=b: exp.serve(
            batch=b, top_k=K, return_scores=True, index="ivf"), 10)
    prof = profile_ms(torch, lambda: exp.serve(batch=B, top_k=K,
                                               return_scores=True,
                                               index="ivf"))
    log(f"IVF phase: batch latency {lat}; profiled IVF serve {prof}")

    # -- clustered class rows at full width: refit, recall ------------------
    protos = testing.clustered_weights(V, D, device=DEVICE)
    exp.load_state(exp.state._replace(head_params=protos))
    del protos
    t0 = time.perf_counter()
    cidx = exp.ivf_index()
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    queries = testing.query_pool(exp.state.w_head, RECALL_QUERIES).cpu().numpy()
    recall = {f"nprobe_{p}": _recall(np, exp, queries, p)
              for p in (2, nprobe)}
    log(f"IVF phase: clustered rows, refit {refit_s:.2f} s (by part "
        f"{ {k: round(v, 4) for k, v in cidx.fit_s.items()} }); recall@5 "
        f"vs the exact scan {recall}")
    e2e = {"ivf_clusters": c, "ivf_cap": cap, "ivf_nprobe": nprobe,
           "ivf_fit_s": fit_s, "ivf_fit2_s": fit2_s,
           "ivf_vs_ref_score_max_abs_err": ref_err,
           "ivf_full_probe_score_max_abs_err": full_err,
           "ivf_full_probe_ids_equal": bool(np.array_equal(fids, eids)),
           **{f"ivf_{k}": v for k, v in lat.items()},
           "ivf_top5_profile": prof, "ivf_clustered_refit_s": refit_s,
           "ivf_clustered_fit_s": cidx.fit_s,
           "ivf_clustered_recall_at_5": recall}
    return kernel_row, launches, e2e


def ivf_launcher_phase(torch, ivf):
    from repro_torch.launch import serve as launcher

    metrics = ROOT / "build" / "chip_smoke" / "ivf_replay_metrics.jsonl"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    metrics.unlink(missing_ok=True)
    before = ivf.LAUNCHES
    rc = launcher.main(["--system", "paper", "--classes", str(V),
                        "--feat-dim", str(D), "--topk", str(K),
                        "--index", "ivf", "--batch", str(B),
                        "--replay", "0.5", "--device", DEVICE,
                        "--metrics-out", str(metrics)])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"the IVF launcher returned {rc}")
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    if not rows or rows[-1].get("n", 0) < 1:
        fail("the IVF launcher's replay served no request")
    if ivf.LAUNCHES == before:
        fail("the IVF launcher's replay never launched ivf_rerank")
    row = rows[-1]
    return {"ivf_replay_n": row["n"], "ivf_replay_p50_ms": row["p50_ms"],
            "ivf_replay_p99_ms": row["p99_ms"], "ivf_replay_qps": row["qps"],
            "ivf_replay_batches": row["n_batches"]}


# ---------------------------------------------------------------------------
# flash attention and zoo serving (the main path of the zoo slice)
# ---------------------------------------------------------------------------


def _flash_bound(bh, s, t, dh, elem_bytes, bhkv=None, causal=True,
                 window=0):
    """Least time of a causal (or full) attention
    (``flash_attention.cost``: q and o of bh heads and k and v of bhkv
    heads moved once; 2 Dh flops for q.k and 2 Dh for p.v per (query,
    valid key) pair)."""
    from repro_torch.kernels import flash_attention
    return bound_ms(flash_attention.cost(bh, s, t, dh, elem_bytes, bhkv,
                                         causal, window))


def flash_flip_bound(torch, fa, q, k, v, causal=True, window=0,
                     eps=FLASH_FLIP_EPS):
    """Per output of the plain version on bf16 q, k, v: the sum over keys
    of |v_j| times the gap between the bf16 roundings of (1 - eps) p_j and
    (1 + eps) p_j, over l: the most that p's rounding to bf16 on the other
    side of a boundary can move the output. A p_j farther than eps from a
    boundary adds 0. The plain version's own tile loop, in fp32 (q and k
    widen exactly, so s and p are its own)."""

    def gap(p):
        return ((p * (1 + eps)).to(torch.bfloat16).float()
                - (p * (1 - eps)).to(torch.bfloat16).float())

    return fa.flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal, window=window,
        block_kv=fa.kv_tile(q.shape[2], q.dtype), round_p=gap)


def flash_bf16_gate(torch, out, plain, flip):
    """The bf16 gate's readings: ``ratio``, the largest |out - plain| /
    (one bf16 step of |plain| + FLASH_BF16_ATOL + ``flip``), which passes
    at <= 1; mean|out - plain| / mean|plain|, which passes at <=
    FLASH_BF16_MEAN_TOL; and, for the record, ``fixed_ratio``, the same
    ratio without the flip bound, and ``n_flips``, the outputs past that
    fixed part."""
    d = (out.float() - plain.float()).abs()
    a = plain.float().abs()
    fixed = d / (BF16_STEP * a + FLASH_BF16_ATOL)
    ratio = float((d / (BF16_STEP * a + FLASH_BF16_ATOL + flip)).max())
    mean_rel = float(d.mean() / a.mean().clamp(min=1e-30))
    return {"ratio": ratio, "mean_rel": mean_rel,
            "fixed_ratio": float(fixed.max()),
            "n_flips": int((fixed > 1).sum()),
            "ok": ratio <= 1.0 and mean_rel <= FLASH_BF16_MEAN_TOL}


def flash_faults(torch, fa, q, k, v, plain):
    """Outputs of faulty kernels, emulated with the plain version at the
    kernel's key tile (causal, S = T, S not a multiple of it): p left
    unrounded; the ragged last key tile dropped; the first 64 keys dropped
    on the rows from 1,024 on; each row's own (diagonal) key dropped.
    Shifting q, k and v by n rows keeps the causal mask of the keys that
    stay, since positions are row indices."""
    s, dh = q.shape[1], q.shape[2]
    bkv = fa.kv_tile(dh, q.dtype)
    ragged = (s - 1) // bkv * bkv

    def run(*x):
        return fa.flash_attention_plain(*x, block_kv=bkv)

    shifted = run(q[:, 64:], k[:, 64:], v[:, 64:])
    return {
        "p_unrounded": run(q.float(), k.float(), v.float()).to(q.dtype),
        "ragged_tile_dropped": run(q, k[:, :ragged], v[:, :ragged]),
        "tile0_dropped_rows_ge_1024": torch.cat(
            [plain[:, :1024], shifted[:, 1024 - 64:]], dim=1),
        "diagonal_dropped": torch.cat(
            [torch.zeros_like(plain[:, :1]),
             run(q[:, 1:], k[:, :-1], v[:, :-1])], dim=1)}


def check_flash(torch, fa, bh, s, t, dh, causal, window, dtype, seed,
                group=1, other_eps=()):
    """Kernel vs plain version on one shape (k and v with bh / group heads):
    max abs error (and the bf16 gate's readings, with the ratio at each of
    ``other_eps`` beside it in ``ratio_at``), and the rows with no valid key
    exactly 0 in both."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    q, k, v = (torch.randn((h, n, dh), generator=g, device=DEVICE).to(dtype)
               for h, n in ((bh, s), (bh // group, t), (bh // group, t)))
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    if out.dtype != dtype or out.shape != q.shape:
        fail(f"flash_attention returned {out.dtype} {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail(f"flash_attention gave non-finite values at {bh, s, t, dh}")
    err = float((out.float() - plain.float()).abs().max())
    if window and causal:
        empty = torch.arange(s, device=DEVICE) - window + 1 >= t
        if empty.any() and (out[:, empty].any() or plain[:, empty].any()):
            fail("rows with no valid key are not 0")
    if dtype == torch.bfloat16:
        flip = flash_flip_bound(torch, fa, q, k, v, causal, window)
        gate = flash_bf16_gate(torch, out, plain, flip)
        gate["ratio_at"] = {
            e: flash_bf16_gate(torch, out, plain, flash_flip_bound(
                torch, fa, q, k, v, causal, window, e))["ratio"]
            for e in other_eps}
    else:
        gate = {"ok": err <= FLASH_FP32_TOL}
    return err, gate


def flash_kernel_phase(torch, fa):
    """``flash_attention`` against its plain version at the JAX test's
    sweep (and Dh 96 / 256, and rows with no valid key) in fp32 and bf16,
    then at the zoo prefill's shapes: held to the bf16 gate, which must
    reject emulated faults on the same inputs, bit-identical across two
    runs, timed beside its plain version and SDPA."""
    errs, gates = {}, {}
    for i, (bh, s, t, dh, causal, window, grp) in enumerate(FLASH_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            err, gate = check_flash(torch, fa, bh, s, t, dh, causal, window,
                                    dtype, seed=i, group=grp)
            name = (f"{bh}x{s}x{t}x{dh}{'c' if causal else ''}w{window}"
                    f"g{grp}")
            errs[f"{name}_{str(dtype)[6:]}"] = err
            if dtype == torch.bfloat16:
                gates[name] = (gate["ratio"], gate["mean_rel"],
                               gate["fixed_ratio"], gate["n_flips"])
            if not gate["ok"]:
                fail(f"flash_attention {name} {dtype}: max abs err {err:.3g}"
                     f", gate {gate}")
    log(f"flash phase: the sweep agrees with the plain version "
        f"(fp32 max {max(e for k, e in errs.items() if 'float32' in k):.3g}"
        f", bf16 max {max(e for k, e in errs.items() if 'bfloat16' in k):.3g}"
        f"; bf16 gate (ratio, mean, fixed ratio, outputs past the fixed "
        f"part) {gates}; {errs})")

    # BH = 70,000 heads (the heads share the grid's x axis with the query
    # tiles; the earlier kernel took at most 65,535) of 40 causal rows: 2.8
    # million short rows, where p's rounding flips show past the gate's
    # fixed part
    many, rows = FLASH_MANY_HEADS, 40
    name = f"{many}x{rows}x{rows}x64cw0g1"
    for dtype in (torch.float32, torch.bfloat16):
        err, gate = check_flash(torch, fa, many, rows, rows, 64, True, 0,
                                dtype, seed=11,
                                other_eps=(2.0 ** -24, 2.0 ** -20))
        if not gate["ok"]:
            fail(f"flash_attention at BH={many} {dtype}: max abs err "
                 f"{err:.3g}, gate {gate}")
        errs[f"{name}_{str(dtype)[6:]}"] = err
    gates[name] = (gate["ratio"], gate["mean_rel"], gate["fixed_ratio"],
                   gate["n_flips"])
    log(f"flash phase: BH={many} heads agree (fp32 max abs err "
        f"{errs[f'{name}_float32']:.3g}; bf16 gate ratio "
        f"{gate['ratio']:.3g}, mean {gate['mean_rel']:.3g}; without the "
        f"flip bound {gate['fixed_ratio']:.3g}, {gate['n_flips']} outputs "
        f"past it; with the bound at eps 2^-24 / 2^-20: "
        f"{gate['ratio_at'][2.0 ** -24]:.3g} / "
        f"{gate['ratio_at'][2.0 ** -20]:.3g})")

    # the zoo prefill's shapes: 9 query heads over 3 KV heads, g = 3
    bh, s, dh = ZOO_BATCH * ZOO_HEADS, ZOO_PROMPT, ZOO_HEAD_DIM
    bhkv = ZOO_BATCH * ZOO_KV_HEADS
    g = torch.Generator(device=DEVICE)
    g.manual_seed(7)
    q, k, v = (torch.randn((h, s, dh), generator=g, device=DEVICE).to(
        torch.bfloat16) for h in (bh, bhkv, bhkv))
    out = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail("flash_attention is not bit-identical across two runs")
    plain = fa.flash_attention_plain(q, k, v)
    flip = flash_flip_bound(torch, fa, q, k, v)
    err = float((out.float() - plain.float()).abs().max())
    gate = flash_bf16_gate(torch, out, plain, flip)
    if not gate["ok"]:
        fail(f"flash_attention at the prefill shapes: max abs err {err:.3g}, "
             f"gate {gate}")
    faults = {}
    for name, bad in flash_faults(torch, fa, q, k, v, plain).items():
        fgate = flash_bf16_gate(torch, bad, plain, flip)
        faults[name] = (fgate["ratio"], fgate["mean_rel"],
                        fgate["fixed_ratio"])
        if fgate["ok"]:
            fail(f"the bf16 gate passes an emulated faulty kernel ({name}: "
                 f"{fgate})")
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 50)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v), 3)
    # SDPA on the same tensors viewed [B, H, S, Dh] (its fused kernels want
    # 4-d inputs; on [BH, S, Dh] it falls back to the unfused product), the
    # KV heads grouped by enable_gqa; and, for reference, on KV heads
    # expanded beforehand, as the earlier yardstick had them
    q4 = q.view(ZOO_BATCH, ZOO_HEADS, s, dh)
    k4, v4 = (x.view(ZOO_BATCH, ZOO_KV_HEADS, s, dh) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True,
                                         enable_gqa=True), 50)
    ke, ve = (x.repeat_interleave(ZOO_HEADS // ZOO_KV_HEADS, dim=1)
              for x in (k4, v4))
    lib_expanded_ms = cuda_ms(torch, lambda: sdpa(q4, ke, ve, is_causal=True),
                              50)
    del ke, ve
    lib_out = sdpa(q4, k4, v4, is_causal=True,
                   enable_gqa=True).reshape(bh, s, dh)
    lib_err = float((lib_out.float() - plain.float()).abs().max())
    lib_gate = flash_bf16_gate(torch, lib_out, plain, flip)
    bound, by = _flash_bound(bh, s, s, dh, 2, bhkv)
    zoo_eval = flash_zoo_evaluate_check(torch, fa)
    log(f"flash phase: at BH={bh} over {bhkv} KV heads, S=T={s}, Dh={dh}, "
        f"bf16, causal: max abs "
        f"err {err:.3g} vs plain, bf16 gate ratio {gate['ratio']:.3g} (<= 1) "
        f"and mean {gate['mean_rel']:.3g} (<= {FLASH_BF16_MEAN_TOL}), "
        f"without the flip bound {gate['fixed_ratio']:.3g} "
        f"({gate['n_flips']} outputs past it); emulated faults (ratio, "
        f"mean, fixed ratio) {faults}, all rejected; SDPA "
        f"{lib_err:.3g}, ratio {lib_gate['ratio']:.3g}, mean "
        f"{lib_gate['mean_rel']:.3g}; bit-identical; {ms:.4f} ms, bound "
        f"{bound:.4f} ms by {by}, plain {plain_ms:.3f} ms, SDPA "
        f"{lib_ms:.4f} ms ({lib_expanded_ms:.4f} ms on expanded KV heads)")
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms,
        library="scaled_dot_product_attention(is_causal=True, "
                f"enable_gqa=True) on q [{ZOO_BATCH},{ZOO_HEADS},{s},{dh}], "
                f"k, v [{ZOO_BATCH},{ZOO_KV_HEADS},{s},{dh}] bf16",
        library_expanded_kv_ms=lib_expanded_ms,
        library_max_abs_err=lib_err,
        library_bf16_gate=(lib_gate["ratio"], lib_gate["mean_rel"]),
        bf16_gate=(gate["ratio"], gate["mean_rel"]),
        bf16_gate_fixed=(gate["fixed_ratio"], gate["n_flips"]),
        bf16_gate_faults=faults, sweep_bf16_gate=gates,
        sweep_max_abs_err=errs, zoo_evaluate=zoo_eval,
        shape=f"q[{bh},{s},{dh}] k,v[{bhkv},{s},{dh}] bf16 causal")


def flash_zoo_evaluate_check(torch, fa):
    """``flash_attention`` at the zoo trainer's ``evaluate`` shapes (16
    sequences of 512 tokens, 9 query heads over 3 KV heads, Dh 64, bf16,
    causal): held to the bf16 gate against its plain version, bit-identical
    across two runs, timed beside its plain version and SDPA."""
    bh, bhkv = ZOO_TB * ZOO_HEADS, ZOO_TB * ZOO_KV_HEADS
    s, dh = ZOO_TS, ZOO_HEAD_DIM
    g = torch.Generator(device=DEVICE)
    g.manual_seed(8)
    q, k, v = (torch.randn((h, s, dh), generator=g, device=DEVICE).to(
        torch.bfloat16) for h in (bh, bhkv, bhkv))
    out = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail("flash_attention at the zoo's evaluate shapes is not "
             "bit-identical across two runs")
    plain = fa.flash_attention_plain(q, k, v)
    err = float((out.float() - plain.float()).abs().max())
    gate = flash_bf16_gate(torch, out, plain,
                           flash_flip_bound(torch, fa, q, k, v))
    if not gate["ok"]:
        fail(f"flash_attention at the zoo's evaluate shapes: max abs err "
             f"{err:.3g}, gate {gate}")
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v), 50)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v), 3)
    q4 = q.view(ZOO_TB, ZOO_HEADS, s, dh)
    k4, v4 = (x.view(ZOO_TB, ZOO_KV_HEADS, s, dh) for x in (k, v))
    lib_ms = cuda_ms(torch, lambda: torch.nn.functional.
                     scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  enable_gqa=True), 50)
    bound, by = _flash_bound(bh, s, s, dh, 2, bhkv)
    log(f"flash phase: at the zoo's evaluate shapes BH={bh} over {bhkv} KV "
        f"heads, S=T={s}, Dh={dh}, bf16, causal: max abs err {err:.3g}, bf16 "
        f"gate ratio {gate['ratio']:.3g} (<= 1), mean {gate['mean_rel']:.3g} "
        f"(<= {FLASH_BF16_MEAN_TOL}); bit-identical; {ms:.4f} ms, bound "
        f"{bound:.4f} ms by {by}, plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=by, max_abs_err=err,
                bf16_gate=(gate["ratio"], gate["mean_rel"]),
                shape=f"q[{bh},{s},{dh}] k,v[{bhkv},{s},{dh}] bf16 causal")


def _zoo(torch, backend, params=None):
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig
    exp = Experiment.from_config(system="zoo", arch="smollm_135m",
                                 batch=ZOO_BATCH, seq=ZOO_PROMPT + ZOO_GEN,
                                 seed=0, device=DEVICE,
                                 head=HeadConfig(backend=backend))
    if params is not None:
        exp.load_params(params)
    return exp


def zoo_phase(torch, np, counters, fa):
    from repro_torch.core import sharded_softmax as sharded
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves
    from repro_torch.telemetry import Tracer
    from repro_torch.train import gspmd

    exp = _zoo(torch, "kernel")
    cfg = exp.model_cfg
    n_params = sum(p.numel() for p in tree_leaves(exp.params))
    log(f"zoo phase: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}), "
        f"{n_params / 1e6:.1f}M params")

    # -- the main path, with every kernel's counter read around it ----------
    _reset(counters)
    torch.cuda.reset_peak_memory_stats()
    toks = exp.serve(prompt_len=ZOO_PROMPT, gen=ZOO_GEN, batch=ZOO_BATCH)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: n for name, n in _read(counters).items() if n}
    if launches.get("flash_attention") != cfg.n_layers:
        fail(f"the zoo serve launched {launches}, not flash_attention once "
             f"a layer ({cfg.n_layers})")
    log(f"zoo phase: launches on the main path {launches}")
    if toks.shape != (ZOO_BATCH, ZOO_GEN) or toks.dtype != np.int32:
        fail(f"tokens {toks.shape} {toks.dtype}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("tokens out of range")

    # -- against the ref backend on the same weights and prompts ------------
    prompts = synthetic.lm_batch(0, ZOO_BATCH, ZOO_PROMPT, cfg.vocab_size,
                                 device=DEVICE)["tokens"]
    h = {}
    with torch.no_grad():
        for b in ("kernel", "ref"):
            h[b] = lm.backbone(exp.params, cfg, {"tokens": prompts},
                               backend=b)[0].float()
    scale = float(h["ref"].abs().max())
    h_err = float((h["kernel"] - h["ref"]).abs().max()) / scale
    if not torch.isfinite(h["kernel"]).all() or h_err > ZOO_H_TOL:
        fail(f"prefill hidden states, kernel vs ref: {h_err:.3g} of "
             f"max|h| > {ZOO_H_TOL}")
    # the greedy next token at the last ZOO_TOKEN_ROWS positions of every
    # row (the last is the serve's first token), kernel vs ref: the logits
    # within a fixed bound, so a token may differ only where the ref's
    # top-2 gap is below twice that bound
    w = lm.head_weight(exp.params, cfg)
    nxt, logits = {}, {}
    for b in h:
        ids, lg = sharded.serve_logits_local(
            h[b][:, -ZOO_TOKEN_ROWS:].reshape(-1, cfg.d_model).to(
                torch.bfloat16), w)
        nxt[b], logits[b] = ids.view(ZOO_BATCH, -1).cpu().numpy(), lg
    logit_scale = float(logits["ref"].abs().max())
    logit_err = float((logits["kernel"] - logits["ref"]).abs().max())
    if logit_err > ZOO_LOGIT_TOL * logit_scale:
        fail(f"greedy logits, kernel vs ref: {logit_err:.3g} > "
             f"{ZOO_LOGIT_TOL} of max|logit| {logit_scale:.3g}")
    top2 = logits["ref"].topk(2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).view(ZOO_BATCH, -1).cpu().numpy()
    near = gap < 2 * ZOO_LOGIT_TOL * logit_scale
    differ = (nxt["kernel"] != nxt["ref"]) & ~near
    if differ.any():
        fail(f"greedy tokens differ from ref at {int(differ.sum())} "
             f"positions whose top-2 gap is at least "
             f"{2 * ZOO_LOGIT_TOL * logit_scale:.3g}")
    if not np.array_equal(nxt["kernel"][:, -1], toks[:, 0]):
        fail("the serve's first tokens are not the prefill's greedy tokens")
    n_checked = int((~near).sum())
    n_equal = int((nxt["kernel"] == nxt["ref"]).sum())
    del logits
    ref_exp = _zoo(torch, "ref", params=exp.params)
    ref_toks = ref_exp.serve(prompt_len=ZOO_PROMPT, gen=ZOO_GEN,
                             batch=ZOO_BATCH)
    agree = float((ref_toks == toks).mean())
    del h

    # the same prefill in fp32 compute: the kernel's fp32 path vs ref
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        h32 = {b: lm.backbone(exp.params, cfg32, {"tokens": prompts},
                              backend=b)[0]
               for b in ("kernel", "ref")}
    h32_err = float((h32["kernel"] - h32["ref"]).abs().max()
                    / h32["ref"].abs().max())
    if h32_err > ZOO_H32_TOL:
        fail(f"fp32 prefill hidden states, kernel vs ref: {h32_err:.3g}")
    del h32, ref_exp
    n_pos = ZOO_BATCH * ZOO_TOKEN_ROWS
    log(f"zoo phase: kernel vs ref prefill hidden states {h_err:.3g} of "
        f"max|h| in bf16 ({h32_err:.3g} in fp32); greedy logits of the last "
        f"{ZOO_TOKEN_ROWS} positions {logit_err:.3g} of max|logit| "
        f"{logit_scale:.3g} ({logit_err / logit_scale:.3g} <= "
        f"{ZOO_LOGIT_TOL}); next tokens equal at {n_equal}/{n_pos}, all "
        f"{n_checked} with a top-2 gap >= "
        f"{2 * ZOO_LOGIT_TOL * logit_scale:.3g} among them; the serve's "
        f"{ZOO_GEN} tokens agree on {agree:.3f}")

    # -- latency: host clock, synchronised, median of 5 ---------------------
    pre, dec = [], []
    for _ in range(ZOO_REPS + 1):
        tr = Tracer()
        exp.serve(prompt_len=ZOO_PROMPT, gen=ZOO_GEN, batch=ZOO_BATCH,
                  telemetry=tr)
        pre.append(tr.span_stats("serve.prefill")["total_s"] * 1e3)
        dec.append(tr.span_stats("serve.decode")["total_s"] * 1e3)
    pre, dec = pre[1:], dec[1:]                 # the first warms up
    prefill_ms = statistics.median(pre)
    decode_ms = statistics.median(dec)
    step_ms = decode_ms / (ZOO_GEN - 1)
    tok_s = ZOO_BATCH * ZOO_GEN / ((prefill_ms + decode_ms) / 1e3)
    decode_tok_s = ZOO_BATCH * (ZOO_GEN - 1) / (decode_ms / 1e3)

    # -- one profiled prefill and one profiled decode step ------------------
    from repro_torch.configs.base import InputShape
    from repro_torch.models import decoder
    shape = InputShape("serve-decode", ZOO_PROMPT + ZOO_GEN, ZOO_BATCH,
                       "decode")
    prefill = gspmd.make_prefill_step(cfg, shape, backend="kernel")
    step = gspmd.make_serve_step(cfg, shape, backend="kernel")
    with torch.no_grad():
        tok, caches = prefill(exp.params, {"tokens": prompts})
        slots = decoder.init_cache_slots(
            cfg, ZOO_PROMPT + ZOO_GEN,
            prefill_positions=torch.arange(ZOO_PROMPT, device=DEVICE))
        prof_pre = profile_ms(torch, lambda: prefill(
            exp.params, {"tokens": prompts}))
        prof_dec = profile_ms(torch, lambda: step(
            exp.params, caches, slots, tok[:, None]))
    flash_ms = sum(v for k, v in prof_pre["top_kernels_ms"].items()
                   if "flash" in k)
    prof_pre["flash_share"] = flash_ms / prof_pre["device_busy_ms"]
    log(f"zoo phase: prefill {prefill_ms:.2f} ms, decode {step_ms:.3f} ms a "
        f"step ({decode_ms:.1f} ms for {ZOO_GEN - 1}), {tok_s:.1f} tok/s end "
        f"to end, {decode_tok_s:.1f} tok/s decoding; peak memory "
        f"{peak_gb:.2f} GB; profiled prefill {prof_pre}; profiled decode "
        f"step {prof_dec}")
    e2e = {"zoo_prefill_ms": prefill_ms, "zoo_prefill_ms_all": pre,
           "zoo_decode_step_ms": step_ms, "zoo_decode_ms": decode_ms,
           "zoo_tok_per_s": tok_s, "zoo_decode_tok_per_s": decode_tok_s,
           "zoo_peak_memory_gb": peak_gb, "zoo_prefill_profile": prof_pre,
           "zoo_decode_step_profile": prof_dec,
           "zoo_h_rel_err_bf16": h_err, "zoo_h_rel_err_fp32": h32_err,
           "zoo_logit_rel_err": logit_err / logit_scale,
           "zoo_logit_scale": logit_scale,
           "zoo_next_tokens_equal": n_equal,
           "zoo_next_tokens_checked": n_checked,
           "zoo_next_tokens_positions": n_pos,
           "zoo_token_agreement_vs_ref": agree,
           "zoo_first_row": toks[0].tolist()}
    return launches, e2e


def zoo_launcher_phase(torch, fa):
    from repro_torch.launch import serve as launcher

    before = fa.LAUNCHES
    t0 = time.perf_counter()
    rc = launcher.main(["--system", "zoo", "--arch", "smollm_135m",
                        "--prompt-len", str(ZOO_PROMPT), "--gen",
                        str(ZOO_GEN), "--batch", str(ZOO_BATCH),
                        "--device", DEVICE])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"the zoo launcher returned {rc}")
    if fa.LAUNCHES == before:
        fail("the zoo launcher never launched flash_attention")
    return {"zoo_launcher_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the zoo trainer and the zoo's feature retrieval (SmolLM-135M at full width)
# ---------------------------------------------------------------------------


def _zoo_trainer(backend: str, head=None, train=None, log_every: int = 1,
                 batch: int = ZOO_TB, arch: str = "smollm_135m", **kw):
    """The zoo trainer's experiment: ``arch`` (SmolLM-135M) at full width
    (and at its train depth in FAM_LAYERS) on ``batch`` x ``ZOO_TS`` tokens
    a step (FAM_SEQ's for whisper), the ``full`` head unless ``head``
    (HeadConfig fields) says otherwise, SGD unless ``train``; ``kw``
    (``ckpt_dir``, ``ckpt_every``, ``data_fn``) go to the experiment."""
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig, TrainConfig
    with _at_depth(FAM_LAYERS.get(arch, (None, None))[1]):
        return Experiment.from_config(
            system="zoo", arch=arch, batch=batch,
            seq=FAM_SEQ.get(arch, ZOO_TS), seed=0, device=DEVICE,
            log_every=log_every,
            head=HeadConfig(backend=backend, **(head or {})),
            train=train or TrainConfig(optimizer="sgd"), **kw)


@contextlib.contextmanager
def _at_depth(n_layers):
    """Within the block, the zoo experiments built take their arch's
    config with ``n_layers`` layers (None: its published depth), at its
    published width: a card that cannot hold every layer."""
    from repro_torch.api import experiment
    real = experiment.get_model_config
    if n_layers is not None:
        experiment.get_model_config = lambda arch, reduced=False: (
            dataclasses.replace(real(arch, reduced), n_layers=n_layers))
    try:
        yield
    finally:
        experiment.get_model_config = real


def _zoo_fit(torch, counters, exp, steps, path):
    """``exp.fit(steps)`` with every counter set to 0 just before and read
    just after: the launches must be ``ZOO_WANT[path]``, the losses finite
    and the trained params moved. Returns (history, launches, seconds,
    peak GB)."""
    from repro_torch.models import lm
    trained = (lm.head_weight(exp.params, exp.model_cfg)
               if exp.head.params_are_class_weights else exp.head_state.params)
    w0 = trained.detach().clone()
    wq0 = exp.params.blocks[0].attn.wq.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    t0 = time.perf_counter()
    hist = exp.fit(steps, lr=ZOO_LR)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in _read(counters).items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in hist]
    log(f"zoo training phase: {path} fit({steps}) {fit_s:.2f} s, launches "
        f"{launches}, losses {losses}, peak memory {peak_gb:.2f} GB")
    if launches != ZOO_WANT[path]:
        fail(f"the {path} path launched {launches}, not {ZOO_WANT[path]} "
             f"(PERF.md §6)")
    if not all(map(math.isfinite, losses)):
        fail(f"{path}: non-finite losses {losses}")
    moved = float((trained - w0).abs().max())
    wq_moved = float((exp.params.blocks[0].attn.wq - wq0).abs().max())
    if not (moved > 0 and wq_moved > 0):
        fail(f"{path}: training did not move the params (head {moved}, "
             f"layer 0 wq {wq_moved})")
    del w0, wq0
    return hist, launches, fit_s, peak_gb


def _zoo_batch_features(torch, exp, t):
    """A batch's labels and the trunk's features for it, fp32 [B*S, D] (no
    grad, the ref attention, as the training step's trunk)."""
    from repro_torch.models import lm
    batch = exp._batch(t)
    with torch.no_grad():
        h, _, _ = lm.backbone(exp.params, exp.model_cfg, batch,
                              backend="ref")
    f = h.reshape(-1, h.shape[-1]).float().contiguous()
    return f, batch["labels"].reshape(-1).to(torch.int32), batch


def zoo_head_grad_check(torch, exp, f, y):
    """The tied table's head gradient of one batch's loss through the full
    head's ``loss_local``, on the kernel and the ref backend from the same
    table and the same fp32 features: the label rows and the other rows
    each within BWD_TOL (the CE gates' bound) of their own max|ref|."""
    from repro_torch.api.heads import make_head
    from repro_torch.models import lm

    table = lm.head_weight(exp.params, exp.model_cfg)
    grads = {}
    for backend in ("kernel", "ref"):
        head = make_head(exp.model_cfg, dataclasses.replace(
            exp.head_cfg, backend=backend))
        wp = table.detach().clone().requires_grad_()
        loss, _ = head.loss_local(f, y, wp, (), global_batch=f.shape[0])
        loss.backward()
        grads[backend] = wp.grad
        del wp
    lab = torch.zeros(table.shape[0], dtype=torch.bool, device=f.device)
    lab[y.long()] = True
    out = {}
    for name, sel in (("label rows", lab), ("other rows", ~lab)):
        k, r = grads["kernel"][sel], grads["ref"][sel]
        ref_max = float(r.abs().max())
        err = float((k - r).abs().max())
        if not ref_max > 0 or err > BWD_TOL * ref_max:
            fail(f"zoo training phase: the table's head gradient of the "
                 f"{name}: kernel vs ref {err:.3g} over {BWD_TOL:g} * "
                 f"max|ref| {ref_max:.3g}")
        out[name] = err / ref_max
    del grads
    torch.cuda.empty_cache()
    return out


def zoo_ce_rows(torch, ce, f, w, y, model="SmolLM-135M", tag="zoo",
                floor=False):
    """The dense CE pair at a zoo model's shapes (for SmolLM-135M f [8,192,
    576] the trunk's features, W the trained tied table [49,152, 576],
    scale 1: raw logits) through the CE gates, bit-identical runs, the
    emulated 1xTF32 fault (which must fail both gates), times beside the
    bounds and f @ W.T; ``floor``: the backward through the floor gate
    (``check_ce_bwd``). Returns (forward row, backward row)."""
    b, v, d = f.shape[0], w.shape[0], f.shape[1]
    fwd_err, fwd_z = check_ce(torch, ce, f, w, y, v, 1.0, f"{tag} shapes")
    m, z, _, _ = ce.ce_forward(f, w, y, limit=v, scale=1.0)
    gz = 1.0 / (b * z)
    gc = torch.full_like(z, -1.0 / b)
    parts = {}
    for term, gct in (("loss", gc), ("softmax term", torch.zeros_like(gc))):
        for part, val in check_ce_bwd(torch, ce, f, w, y, m, gz, gct, v, 1.0,
                                      f"{tag} shapes, {term}",
                                      floor=floor).items():
            parts[f"{part}, {term}"] = val
    fault = tf32_fault(torch, ce, f, w, y, m, gz, gc, v, 1.0,
                       f"the {tag} shapes")
    fwd_ms = cuda_ms(torch, lambda: ce.ce_forward(f, w, y, limit=v), 10)
    fwd_plain = cuda_ms(torch, lambda: ce.ce_forward_plain(f, w, y, v, 1.0),
                        3)
    bwd_ms = cuda_ms(torch, lambda: ce.ce_backward(f, w, y, m, gz, gc,
                                                   limit=v), 5)
    bwd_plain = cuda_ms(torch, lambda: ce.ce_backward_plain(
        f, w, y, m, gz, gc, v, 1.0), 2)
    lib = cuda_ms(torch, lambda: f @ w.T, 10)
    fb = ce_bounds(ce.forward_cost(b, v, d))
    bb = ce_bounds(ce.backward_cost(b, v, d))
    log(f"{tag} training phase: at {model}'s shapes [{b}, {v}] x {d}: "
        f"ce_forward {fwd_ms:.3f} ms (3xTF32 bound {fb['bound_ms']:.3f} by "
        f"{fb['bound_by']}), plain {fwd_plain:.3f}; ce_backward {bwd_ms:.3f} "
        f"ms (bound {bb['bound_ms']:.3f} by {bb['bound_by']}), plain "
        f"{bwd_plain:.3f}; f @ W.T {lib:.3f}; m/corr max abs err "
        f"{fwd_err:.3g}, z rel {fwd_z:.3g}; backward by part {parts}")
    shape = f"f[{b},{d}] W[{v},{d}] scale 1 ({model} tied table)"
    lib_name = "f @ W.T (cuBLAS fp32, TF32 off)"
    del m, z, gz, gc
    torch.cuda.empty_cache()
    return (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib,
                 library=lib_name, max_abs_err=fwd_err, z_max_rel_err=fwd_z,
                 **fb, shape=shape),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib,
                 library=lib_name,
                 max_abs_err=max(e for e, _ in parts.values()),
                 rel_err_by_part={k: r for k, (_, r) in parts.items()},
                 tf32_fault=fault, **bb, shape=shape))


def ce_trained_batch_gate(torch, ce, f, w, y, tag):
    """The dense CE pair on the batch the fit trained on (f its trunk's
    features, W the trained table, scale 1), where p at the labels grows
    towards 1 and p - 1 may cancel: ce_forward through its gate, bit-equal
    runs; ce_backward with the loss's cotangents through
    ``testing.ce_backward_floor_gate`` (each part within CE_BWD_TOL of its
    max, or CE_OWN_ROUNDING times the plain version's own rounding against
    itself in fp64, whichever is larger), its relative-gate reading
    reported; the plain version with 1xTF32 products must fail the floor
    gate. Returns the readings."""
    from repro_torch import testing
    b, v = f.shape[0], w.shape[0]
    fwd_err, fwd_z = check_ce(torch, ce, f, w, y, v, 1.0,
                              f"{tag} trained batch")
    m, z, corr, _ = ce.ce_forward(f, w, y, limit=v, scale=1.0)
    p_label = torch.exp(corr - m) / z
    gz, gc = 1.0 / (b * z), torch.full_like(z, -1.0 / b)
    df, dw = ce.ce_backward(f, w, y, m, gz, gc, limit=v)
    plain = ce.ce_backward_plain(f, w, y, m, gz, gc, v, 1.0)
    plain64 = ce.ce_backward_plain(f.double(), w.double(), y, m.double(),
                                   gz.double(), gc.double(), v, 1.0)
    rel = testing.ce_backward_gate(df, dw, *plain, y)
    gate = testing.ce_backward_floor_gate(df, dw, *plain, *plain64, y)
    del df, dw
    fault = testing.ce_backward_floor_gate(
        *testing.ce_backward_tf32(f, w, y, m, gz, gc, v, 1.0, 1), *plain,
        *plain64, y)
    out = {"p_label_max": float(p_label.max()),
           "labels_above_0.99": int((p_label > 0.99).sum()),
           "forward_m_corr_err": fwd_err, "forward_z_rel_err": fwd_z,
           "relative_gate_failed": rel["failed"],
           "parts": gate["parts"], "tf32_fault_failed": fault["failed"]}
    del plain, plain64
    torch.cuda.empty_cache()
    log(f"{tag}: CE pair on the trained batch [{b}, {v}] x {f.shape[1]} "
        f"(err, err / max, plain's own rounding by part): {out}")
    if not gate["ok"]:
        fail(f"{tag}: ce_backward on the trained batch fails "
             f"{gate['failed']}: {gate['parts']} (within the larger of "
             f"{testing.CE_BWD_TOL:g} of max|plain| and "
             f"{testing.CE_OWN_ROUNDING:g} x plain's own rounding)")
    if fault["ok"]:
        fail(f"{tag}: the floor gate passes 1xTF32 products on the trained "
             f"batch: {fault['parts']}")
    return out


def zoo_sparse_rows(torch, sp, exp, f, y, tag="zoo training phase"):
    """The sparse CE pair at a zoo model's knn shapes: f the trunk's
    features (SmolLM-135M's [8,192, 576]) normalised, the normalised
    trained table, the active set ``select_active`` draws from the
    experiment's graph for these labels (SmolLM-135M's A = 4,915, fillers
    on), scale 16, through the sparse gates, bit-identical runs, times and
    bounds. Returns (forward, backward)."""
    from repro_torch.core.knn_softmax import select_active
    from repro_torch.core.sharded_softmax import _normalize
    from repro_torch.models import lm

    w = lm.head_weight(exp.params, exp.model_cfg).detach()
    v = w.shape[0]
    offsets, neighbors, ranks = exp.head_state.aux
    a = max(8, int(v * exp.head_cfg.active_frac))
    ids, valid = select_active(y, offsets, neighbors, v_loc=v, m_local=a,
                               k_cap=exp.head_cfg.knn_k, ranks=ranks)
    fn = _normalize(f).contiguous()
    wn = _normalize(w).contiguous()
    bias = torch.zeros(a, device=f.device)
    valid = valid.to(torch.int32)
    b, d = f.shape
    m, z, _, _, hit = sp.sparse_ce_forward(fn, wn, ids, ids, bias, valid, y,
                                           scale=16.0)
    gz = 1.0 / (b * z)
    gc = torch.full_like(z, -1.0 / b)
    errs = check_sparse(torch, sp, fn, wn, ids, ids, bias, valid, y, 16.0,
                        False, gz, gc, f"{tag}: knn shapes")
    fwd_ms = cuda_ms(torch, lambda: sp.sparse_ce_forward(
        fn, wn, ids, ids, bias, valid, y, scale=16.0), 10)
    fwd_plain = cuda_ms(torch, lambda: sp.sparse_ce_forward_plain(
        fn, wn, ids, ids, bias, valid, y, 16.0, False), 3)
    bwd_ms = cuda_ms(torch, lambda: sp.sparse_ce_backward(
        fn, wn, ids, ids, bias, valid, y, m, gz, gc, hit, scale=16.0), 5)
    bwd_plain = cuda_ms(torch, lambda: sp.sparse_ce_backward_plain(
        fn, wn, ids, ids, bias, valid, y, m, gz, gc, hit, 16.0, False), 2)
    lib = cuda_ms(torch, lambda: fn @ wn[ids.long()].T, 10)
    fb = ce_bounds(sp.forward_cost(b, a, d))
    bb = ce_bounds(sp.backward_cost(b, a, v, d))
    log(f"{tag}: sparse CE at the knn shapes (B={b}, A={a}, V={v}, D={d}): "
        f"forward {fwd_ms:.3f} ms (bound "
        f"{fb['bound_ms']:.3f} by {fb['bound_by']}), plain {fwd_plain:.3f}; "
        f"backward {bwd_ms:.3f} ms (bound {bb['bound_ms']:.3f} by "
        f"{bb['bound_by']}), plain {bwd_plain:.3f}; f @ W[ids].T {lib:.3f}; "
        f"errors {errs}")
    shape = f"f[{b},{d}] W[{v},{d}] A={a} knn active set, scale 16"
    lib_name = "f @ W[ids].T (gather + cuBLAS fp32, TF32 off)"
    fwd_err = max(e for k, e in errs.items() if k.startswith("fwd"))
    bwd_err = max(e for k, e in errs.items() if not k.startswith("fwd"))
    del fn, wn, m, z, gz, gc, hit
    torch.cuda.empty_cache()
    return (dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib,
                 library=lib_name, max_abs_err=fwd_err, **fb, shape=shape),
            dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib,
                 library=lib_name, max_abs_err=bwd_err,
                 rel_err_by_part=errs, **bb, shape=shape))


def zoo_dist_topk_row(torch, dk, exp, tag="zoo training phase"):
    """dist_topk at a zoo model's graph build (SmolLM-135M: all 49,152
    unit rows of the trained table at D = 576) in bf16, k' = 32; 1,024
    rows held against the plain version, bit-identical runs, the whole
    pass timed beside the plain version and the library's bf16 q @ K.T in
    4,096-row chunks."""
    from repro_torch.core.sharded_softmax import _normalize
    from repro_torch.models import lm

    w16 = _normalize(lm.head_weight(exp.params, exp.model_cfg).detach()).to(
        torch.bfloat16).contiguous()
    n, d = w16.shape
    err, swaps = check_dist_topk(torch, dk, w16[:1024], w16, KPRIME, 0,
                                 f"{tag}: graph build, 1,024 rows")
    first = dk.dist_topk(w16, w16, KPRIME)
    again = dk.dist_topk(w16, w16, KPRIME)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{tag}: dist_topk at the graph build is not bit-identical")
    del first, again
    ms = cuda_ms(torch, lambda: dk.dist_topk(w16, w16, KPRIME), 3)

    def plain():
        for r in range(0, n, 4096):
            dk.dist_topk_plain(w16[r:r + 4096], w16, KPRIME)

    def library():
        for r in range(0, n, 4096):
            w16[r:r + 4096] @ w16.T

    plain_ms = cuda_ms(torch, plain, 1)
    lib_ms = cuda_ms(torch, library, 3)
    bound, by = bound_ms(dk.cost(n, n, d, KPRIME))
    log(f"{tag}: dist_topk over the table's {n} unit rows at D={d} "
        f"{ms:.3f} ms (bound {bound:.3f} by {by}), plain "
        f"{plain_ms:.2f} ms, bf16 q @ K.T {lib_ms:.3f} ms; 1,024 rows max abs "
        f"err {err:.3g}, near-tie id swaps {swaps}; bit-identical")
    del w16
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library="q @ K.T (cuBLAS bf16) in 4,096-row chunks",
                max_abs_err=err, near_tie_id_swaps=swaps, bound_ms=bound,
                bound_by=by, shape=f"q = K [{n},{d}] bf16, k'={KPRIME}")


def _knn_label_recall(torch, exp, t):
    """The label_recall Algorithm 1 gives step ``t``'s batch: the labels
    come first (each its own nearest neighbour, rank 0), and when they
    outnumber the m_local active slots the lowest ids win the ties, so
    the share of tokens whose label is among the m_local lowest distinct
    labels (1.0 when they all fit). Returns (that share, the distinct
    labels)."""
    y = exp._batch(t)["labels"].reshape(-1)
    labels = torch.unique(y)                      # sorted
    slots = max(8, int(exp.model_cfg.vocab_size * exp.head_cfg.active_frac))
    kept = torch.isin(y, labels[:slots])
    return float(kept.float().mean()), int(labels.numel())


class _UpcastHead:
    """A head whose loss takes the trunk's features in fp32: the ref
    backend then scores fp32 W, as the kernel does, not W rounded to the
    features' bf16."""

    def __init__(self, head):
        self._head = head

    def __getattr__(self, name):
        return getattr(self._head, name)

    def loss_local(self, f, *args, **kw):
        return self._head.loss_local(f.float(), *args, **kw)


def _zoo_grads(torch, exp, batch, backend, mode="bf16"):
    """One batch's loss and gradients of (params, head params) through
    ``gspmd.make_head_loss_fn`` (the loss the step differentiates) on
    ``backend``, from exp's params: ``mode`` "bf16" as the step trains,
    "f32 head" with the trunk's features upcast before the head, "fp32" in
    fp32 compute throughout."""
    from repro_torch.api.heads import make_head
    from repro_torch.core.pipeline import microbatched_value_and_grad
    from repro_torch.train import gspmd

    cfg = exp.model_cfg
    if mode == "fp32":
        cfg = dataclasses.replace(cfg, dtype="float32")
    hcfg = dataclasses.replace(exp.head_cfg, backend=backend)
    head = make_head(cfg, hcfg)
    if mode == "f32 head":
        head = _UpcastHead(head)
    loss_fn = gspmd.make_head_loss_fn(cfg, hcfg, global_tokens=ZOO_TB * ZOO_TS,
                                      head=head)
    (loss, _), grads = microbatched_value_and_grad(
        lambda p, x: loss_fn(p[0], p[1], exp.head_state.aux, x),
        (exp.params, exp.head_state.params), batch, 1)
    return float(loss), grads


def _grad_gap(a, b) -> tuple:
    """(max|a - b|, max|b|) of two tensors."""
    return float((a - b).abs().max()), float(b.abs().max())


def _bf16_steps_bound(top: float) -> float:
    """ZOO_TABLE_GRAD_STEPS steps of bf16 (7 stored mantissa bits) at a
    value of magnitude ``top``."""
    return ZOO_TABLE_GRAD_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def zoo_table_grad_gaps(torch, exp, batch):
    """The tied table's gradient of one batch (its embedding and head parts
    together), kernel vs ref backend from the same params, in three
    precisions: as the step trains ("bf16"), with the features upcast to
    fp32 before the head ("f32 head": the ref head then scores fp32 W),
    and in fp32 compute throughout ("fp32"). The bf16 gaps are held to
    ZOO_TABLE_GRAD_STEPS bf16 steps of max|ref|; in fp32 every leaf is held
    to ZOO_GRAD32_TOL of its own max|ref|."""
    from repro_torch.optim import tree_leaves

    out = {}
    for mode in ("bf16", "f32 head", "fp32"):
        res = {b: _zoo_grads(torch, exp, batch, b, mode)
               for b in ("kernel", "ref")}
        (lk, gk), (lr, gr) = res["kernel"], res["ref"]
        gap, top = _grad_gap(gk[0].embed.table, gr[0].embed.table)
        leaf = max(d / max(t, 1e-30) for d, t in (
            _grad_gap(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gr))))
        bound = (ZOO_GRAD32_TOL * top if mode == "fp32"
                 else _bf16_steps_bound(top))
        out[mode] = dict(table_abs=gap, table_max=top, table_rel=gap / top,
                         table_bound=bound, leaf_rel_max=leaf,
                         loss_rel=abs(lk - lr) / abs(lr))
        del res, gk, gr
        torch.cuda.empty_cache()
        if not (top > 0 and gap <= bound):
            fail(f"zoo training phase: the table's gradient ({mode}), kernel "
                 f"vs ref: {gap:.3g} over {bound:.3g} (max|ref| {top:.3g})")
        if mode == "fp32" and leaf > ZOO_GRAD32_TOL:
            fail(f"zoo training phase: a leaf's gradient in fp32, kernel vs "
                 f"ref: {leaf:.3g} of its max|ref| > {ZOO_GRAD32_TOL:g}")
    log(f"zoo training phase: the table's gradient of one batch, kernel vs "
        f"ref, by precision: {out}")
    return out


def zoo_evaluate_check(torch, exp, acc):
    """``evaluate``'s predictions on its batch, kernel vs ref backend on the
    same params: the kernel path's accuracy is ``acc`` (what ``evaluate``
    returned); the trunk's features within ZOO_H_TOL of max|h| (the
    kernel's trunk runs the flash kernel, the ref's the dense attention);
    the fp32 logits f W^T of the two within ZOO_LOGIT_TOL of max|logit|; the
    kernel head's pick within the CE gate's atol of its features' top
    logit; the two backends' picks equal wherever the ref's top-2 gap is at
    least twice that logit bound."""
    from repro_torch import testing
    from repro_torch.api.heads import make_head
    from repro_torch.models import lm

    cfg = exp.model_cfg
    batch = exp._batch(10**6)                    # evaluate's own batch
    labels = batch["labels"].reshape(-1).long()
    w = lm.head_weight(exp.params, cfg).detach().float()
    h, pred, logits = {}, {}, {}
    with torch.no_grad():
        for b in ("kernel", "ref"):
            h[b] = lm.backbone(exp.params, cfg, batch, backend=b)[0].reshape(
                -1, cfg.d_model)
            head = make_head(cfg, dataclasses.replace(exp.head_cfg,
                                                      backend=b))
            pred[b] = head.eval_logits_local(h[b], w,
                                             exp.head_state.aux)[0].long()
            logits[b] = h[b].float() @ w.T
    acc_k = float((pred["kernel"] == labels).float().mean())
    acc_r = float((pred["ref"] == labels).float().mean())
    if acc_k != acc:
        fail(f"zoo evaluate returned {acc}, its kernel path's picks score "
             f"{acc_k}")
    hs = float(h["ref"].float().abs().max())
    h_err = float((h["kernel"].float() - h["ref"].float()).abs().max()) / hs
    scale = float(logits["ref"].abs().max())
    logit_err = float((logits["kernel"] - logits["ref"]).abs().max())
    top = logits["kernel"].max(dim=1).values
    pick_gap = float((top - logits["kernel"].gather(
        1, pred["kernel"][:, None])[:, 0]).max())
    top2 = logits["ref"].topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) < 2 * ZOO_LOGIT_TOL * scale
    n_diff = int((pred["kernel"] != pred["ref"]).sum())
    n_far_diff = int(((pred["kernel"] != pred["ref"]) & ~near).sum())
    out = dict(accuracy_kernel=acc_k, accuracy_ref=acc_r, h_rel_err=h_err,
               logit_rel_err=logit_err / scale, logit_scale=scale,
               kernel_pick_gap=pick_gap, picks_differ=n_diff,
               picks_checked=int((~near).sum()), tokens=int(labels.numel()))
    log(f"zoo training phase: evaluate, kernel vs ref on its batch: {out}")
    if not torch.isfinite(h["kernel"]).all() or h_err > ZOO_H_TOL:
        fail(f"zoo evaluate's features, kernel vs ref: {h_err:.3g} of max|h| "
             f"> {ZOO_H_TOL}")
    if logit_err > ZOO_LOGIT_TOL * scale:
        fail(f"zoo evaluate's logits, kernel vs ref: {logit_err:.3g} > "
             f"{ZOO_LOGIT_TOL} of max|logit| {scale:.3g}")
    if pick_gap > testing.CE_ATOL:
        fail(f"zoo evaluate: the kernel head's pick is {pick_gap:.3g} below "
             f"its features' top logit")
    if n_far_diff:
        fail(f"zoo evaluate: the picks differ from ref at {n_far_diff} "
             f"tokens whose top-2 gap is at least "
             f"{2 * ZOO_LOGIT_TOL * scale:.3g}")
    del h, logits, w
    torch.cuda.empty_cache()
    return out


def zoo_mach_checks(torch, ce, mach, rows):
    """MACH at the zoo's shapes: the CE pair on a batch's trunk features
    [8,192, 576] against repetition 1's bucket block [3,072, 576] (a view
    of [R, B, D]), scale 1, the labels' buckets, through both CE gates,
    bit-identical runs and the emulated 1xTF32 fault, timed (into
    ``rows``' CE rows as ``mach_rep1``); then one batch's loss and
    gradients, kernel vs ref backend from the same params: the loss within
    ZOO_LOSS_RTOL, the bucket block's gradient within BWD_TOL of its
    max|ref|, the tied table's (trunk) gradient within
    ZOO_TABLE_GRAD_STEPS bf16 steps of its max|ref|. Returns the
    readings."""
    f, y, batch = _zoo_batch_features(torch, mach, 10**5 + 1)
    w = mach.head_state.params[1]
    b_loc, b = w.shape[0], f.shape[0]
    if w.data_ptr() % 16 or not w.is_contiguous():
        fail("MACH's repetition view is not a 16-byte aligned contiguous "
             "block")
    yb = mach.head_state.aux[0][1, y.long()].to(torch.int32)
    fwd_err, fwd_z = check_ce(torch, ce, f, w, yb, b_loc, 1.0,
                              "zoo MACH rep 1")
    m, z, _, _ = ce.ce_forward(f, w, yb, limit=b_loc, scale=1.0)
    gz = 1.0 / (b * z)
    gc = torch.full_like(z, -1.0 / b)
    parts = {}
    for term, gct in (("loss", gc), ("softmax term", torch.zeros_like(gc))):
        for part, v in check_ce_bwd(torch, ce, f, w, yb, m, gz, gct, b_loc,
                                    1.0, f"zoo MACH rep 1, {term}").items():
            parts[f"{part}, {term}"] = v
    fault = tf32_fault(torch, ce, f, w, yb, m, gz, gc, b_loc, 1.0,
                       "the zoo's MACH bucket block")
    fwd_ms = cuda_ms(torch, lambda: ce.ce_forward(f, w, yb, limit=b_loc), 20)
    fwd_plain = cuda_ms(torch, lambda: ce.ce_forward_plain(f, w, yb, b_loc,
                                                           1.0), 5)
    bwd_ms = cuda_ms(torch, lambda: ce.ce_backward(f, w, yb, m, gz, gc,
                                                   limit=b_loc), 10)
    bwd_plain = cuda_ms(torch, lambda: ce.ce_backward_plain(
        f, w, yb, m, gz, gc, b_loc, 1.0), 3)
    lib = cuda_ms(torch, lambda: f @ w.T, 20)
    fb = ce_bounds(ce.forward_cost(b, b_loc, ZOO_D))
    bb = ce_bounds(ce.backward_cost(b, b_loc, ZOO_D))
    shape = (f"f[{b},{ZOO_D}] W[{b_loc},{ZOO_D}] (rep 1 of [R,B,D]) scale 1 "
             f"(zoo MACH)")
    rows["ce_forward"]["mach_rep1"] = dict(
        ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib, max_abs_err=fwd_err,
        z_max_rel_err=fwd_z, **fb, shape=shape)
    rows["ce_backward"]["mach_rep1"] = dict(
        ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib,
        max_abs_err=max(e for e, _ in parts.values()),
        rel_err_by_part={k: r for k, (_, r) in parts.items()},
        tf32_fault=fault, **bb, shape=shape)
    log(f"zoo training phase: at the zoo's MACH block [{b}, {b_loc}] x "
        f"{ZOO_D}: ce_forward {fwd_ms:.4f} ms (bound {fb['bound_ms']:.4f} by "
        f"{fb['bound_by']}), plain {fwd_plain:.4f}; ce_backward {bwd_ms:.4f} "
        f"ms (bound {bb['bound_ms']:.4f} by {bb['bound_by']}), plain "
        f"{bwd_plain:.4f}; f @ W.T {lib:.4f}; m/corr max abs err "
        f"{fwd_err:.3g}, z rel {fwd_z:.3g}; backward by part {parts}")
    del f, y, m, z, gz, gc
    torch.cuda.empty_cache()

    (lk, gk), (lr, gr) = (_zoo_grads(torch, mach, batch, bk)
                          for bk in ("kernel", "ref"))
    loss_rel = abs(lk - lr) / abs(lr)
    blk_gap, blk_top = _grad_gap(gk[1], gr[1])
    tab_gap, tab_top = _grad_gap(gk[0].embed.table, gr[0].embed.table)
    out = dict(loss_kernel=lk, loss_ref=lr, loss_rel=loss_rel,
               bucket_grad_rel=blk_gap / blk_top,
               table_grad_rel=tab_gap / tab_top,
               table_grad_bf16_steps=tab_gap / _bf16_steps_bound(tab_top)
               * ZOO_TABLE_GRAD_STEPS)
    del gk, gr
    torch.cuda.empty_cache()
    log(f"zoo training phase: MACH, one batch kernel vs ref: {out}")
    if loss_rel > ZOO_LOSS_RTOL:
        fail(f"zoo MACH loss, kernel {lk} vs ref {lr}: rel {loss_rel:.3g}")
    if not (blk_top > 0 and blk_gap <= BWD_TOL * blk_top):
        fail(f"zoo MACH bucket gradient, kernel vs ref: {blk_gap:.3g} over "
             f"{BWD_TOL:g} * max|ref| {blk_top:.3g}")
    if not (tab_top > 0 and tab_gap <= _bf16_steps_bound(tab_top)):
        fail(f"zoo MACH table gradient, kernel vs ref: {tab_gap:.3g} over "
             f"{ZOO_TABLE_GRAD_STEPS} bf16 steps of max|ref| {tab_top:.3g}")
    return out


def zoo_training_phase(torch, np, counters, ce, sp, dk):
    """The zoo trainer's main paths at SmolLM-135M's full width (the full
    head at n_micro 1 and 2, evaluate, knn, MACH), each with the counters
    reset and read around it; the full head against the ref backend; the
    kernels at the zoo's shapes; the step taken apart. Returns
    ({path: launches}, {kernel: row}, numbers, the trained full-head
    experiment)."""
    from repro_torch.api.heads import make_head
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import make_optimizer, tree_leaves, tree_map
    from repro_torch.train import gspmd

    launches, rows, e2e = {}, {}, {}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    exp = _zoo_trainer("kernel")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = exp.model_cfg
    n_params = sum(p.numel() for p in tree_leaves(exp.params))
    log(f"zoo training phase: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} over "
        f"{cfg.param_dtype}), {n_params / 1e6:.1f}M params, {ZOO_TB} x "
        f"{ZOO_TS} tokens a step, n_micro "
        f"{gspmd.auto_micro_batches(cfg, exp.shape)} by auto_micro_batches; "
        f"experiment {setup_s:.2f} s")

    # -- the main path: the full head, n_micro 1 ----------------------------
    hist, launches["zoo_training"], fit_s, peak_gb = _zoo_fit(
        torch, counters, exp, ZOO_STEPS, "zoo_training")
    _reset(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc = exp.evaluate()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches["zoo_evaluate"] = {k: v for k, v in _read(counters).items()
                                if v}
    eval_peak = torch.cuda.max_memory_allocated() / 1e9
    if launches["zoo_evaluate"] != ZOO_WANT["zoo_evaluate"]:
        fail(f"zoo evaluate launched {launches['zoo_evaluate']}, not "
             f"{ZOO_WANT['zoo_evaluate']}")
    if not 0.0 <= acc <= 1.0:
        fail(f"zoo evaluate() returned {acc}")
    log(f"zoo training phase: evaluate {acc} in {eval_s:.2f} s, launches "
        f"{launches['zoo_evaluate']}, peak {eval_peak:.2f} GB")
    eval_vs_ref = zoo_evaluate_check(torch, exp, acc)

    # -- the step at n_micro 1 and 2: host clock (median of 5), a profile ----
    inputs = exp._batch(10**5)
    steps = {n: gspmd.make_head_train_step(
        cfg, exp.head_cfg, dataclasses.replace(exp.train_cfg, micro_batch=n),
        exp.shape, head=exp.head) for n in (1, 2)}

    def one_step(n):
        def run():
            exp.params, exp.head_state, exp.opt_state, loss, _ = steps[n](
                exp.params, exp.head_state, exp.opt_state, inputs, ZOO_LR)
            return float(loss)
        return run

    step_ms = {n: host_ms(torch, one_step(n), 5) for n in (1, 2)}
    torch.cuda.reset_peak_memory_stats()
    prof = profile_ms(torch, one_step(1), {
        "CE pair": ("ce_fwd", "ce_bwd", "ce_softmax", "ce_dw", "ce_df"),
        "matmuls (bf16 + fp32)": ("gemm", "cutlass", "sm90_xmma", "ampere",
                                  "cublas"),
        "softmax": ("softmax",), "copies and casts": ("copy",)})
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = ZOO_TB * ZOO_TS
    log(f"zoo training phase: step {step_ms[1]:.2f} ms at n_micro 1 "
        f"({tokens / step_ms[1] * 1e3:.0f} tokens/s), {step_ms[2]:.2f} ms at "
        f"n_micro 2; profiled step (n_micro 1): idle share "
        f"{prof['idle_share']:.3f}, device busy {prof['device_busy_ms']:.2f} "
        f"of {prof['wall_ms']:.2f} ms, by group "
        f"{prof.get('device_ms_by_group')}, peak {step_peak:.2f} GB")
    log("zoo training phase: top device kernels of one step (ms): "
        + "; ".join(f"{k} {v:.3f}"
                    for k, v in prof["top_kernels_ms"].items()))
    del steps

    # -- against the ref backend: one step from the same params and batch ---
    f, y, batch = _zoo_batch_features(torch, exp, 10**5 + 1)
    step_loss, tables = {}, {}
    train1 = dataclasses.replace(exp.train_cfg, micro_batch=1)
    for backend in ("kernel", "ref"):
        hcfg = dataclasses.replace(exp.head_cfg, backend=backend)
        params = tree_map(lambda p: p.detach().clone(), exp.params)
        opt = make_optimizer(train1).init((params, ()))
        step = gspmd.make_head_train_step(cfg, hcfg, train1, exp.shape,
                                          head=make_head(cfg, hcfg))
        _, _, _, loss, _ = step(params, exp.head_state, opt, batch, ZOO_LR)
        step_loss[backend] = float(loss)
        tables[backend] = params.embed.table.detach()
        del params, opt, step
        torch.cuda.empty_cache()
    loss_rel = abs(step_loss["kernel"] - step_loss["ref"]) / abs(
        step_loss["ref"])
    table_err = float((tables["kernel"] - tables["ref"]).abs().max())
    del tables
    if loss_rel > ZOO_LOSS_RTOL:
        fail(f"zoo step loss, kernel {step_loss['kernel']} vs ref "
             f"{step_loss['ref']}: rel {loss_rel:.3g} > {ZOO_LOSS_RTOL:g}")
    grad_gaps = zoo_table_grad_gaps(torch, exp, batch)
    # SGD's first step from a zero momentum moves the table by -lr g, so
    # the updated tables differ by lr times the gradients' gap
    table_bound = ZOO_LR * grad_gaps["bf16"]["table_bound"]
    if table_err > table_bound:
        fail(f"zoo step: the updated tables, kernel vs ref, differ by "
             f"{table_err:.3g} > lr times the gradient's bound "
             f"{table_bound:.3g}")
    grad_err = zoo_head_grad_check(torch, exp, f, y)
    log(f"zoo training phase: one step from the same params and batch, "
        f"kernel vs ref: losses {step_loss} (rel {loss_rel:.3g}); the updated "
        f"tables differ by {table_err:.3g} (lr {ZOO_LR} x the gradient's gap "
        f"{grad_gaps['bf16']['table_abs']:.3g}); the table's head gradient, "
        f"kernel vs ref, max abs err of max|ref| by part {grad_err}")

    # -- the CE pair at the zoo's shapes through the gates ------------------
    w = exp.params.embed.table.detach()
    rows["ce_forward"], rows["ce_backward"] = zoo_ce_rows(torch, ce, f, w, y)
    del w
    torch.cuda.empty_cache()

    # -- n_micro 2: twice the launches ---------------------------------------
    exp2 = _zoo_trainer("kernel", train=TrainConfig(optimizer="sgd",
                                                    micro_batch=2))
    hist2, launches["zoo_training_n2"], fit2_s, peak2 = _zoo_fit(
        torch, counters, exp2, ZOO_STEPS, "zoo_training_n2")
    del exp2
    gc.collect()
    torch.cuda.empty_cache()

    # -- knn: sparse pair a micro-step, dist_topk a graph build --------------
    knn = _zoo_trainer("kernel", head=ZOO_KNN)
    hist_k, launches["zoo_knn_training"], fitk_s, peak_k = _zoo_fit(
        torch, counters, knn, ZOO_STEPS, "zoo_knn_training")
    recall = [r["label_recall"] for r in hist_k]
    want_recall, n_labels = zip(*(_knn_label_recall(torch, knn, t)
                                  for t in range(ZOO_STEPS)))
    if any(abs(r - w) > 1e-6 for r, w in zip(recall, want_recall)):
        fail(f"zoo knn label_recall {recall}, not Algorithm 1's "
             f"{want_recall}")
    rows["sparse_ce_forward"], rows["sparse_ce_backward"] = zoo_sparse_rows(
        torch, sp, knn, f, y)
    rows["dist_topk"] = zoo_dist_topk_row(torch, dk, knn)
    knn_step_ms = host_ms(torch, lambda: knn._train_step(
        knn.params, knn.head_state, knn.opt_state, inputs, ZOO_LR)[3].item(),
        5)
    slots = max(8, int(knn.model_cfg.vocab_size * knn.head_cfg.active_frac))
    del knn
    gc.collect()
    torch.cuda.empty_cache()
    # half the batch: 4,096 tokens, whose labels fit the active slots
    knn_half = _zoo_trainer("kernel", head=ZOO_KNN, batch=ZOO_TB // 2,
                            log_every=0)
    recall_half = [r["label_recall"] for r in knn_half.fit(2, lr=ZOO_LR)]
    if any(r != 1.0 for r in recall_half):
        fail(f"zoo knn at {ZOO_TB // 2} x {ZOO_TS} tokens: label_recall "
             f"{recall_half}, not 1.0")
    del knn_half
    gc.collect()
    torch.cuda.empty_cache()
    log(f"zoo training phase: knn label_recall {recall} (Algorithm 1's: "
        f"the steps' {list(n_labels)} distinct labels outnumber the "
        f"{slots} active slots; at "
        f"{ZOO_TB // 2} x {ZOO_TS} tokens {recall_half}), active_frac "
        f"{[round(r['active_frac'], 4) for r in hist_k]}, step "
        f"{knn_step_ms:.2f} ms")

    # -- MACH: the CE pair once a repetition a micro-step -------------------
    mach = _zoo_trainer("kernel", head=ZOO_MACH)
    hist_m, launches["zoo_mach_training"], fitm_s, peak_m = _zoo_fit(
        torch, counters, mach, ZOO_MACH_STEPS, "zoo_mach_training")
    acc_m = mach.evaluate()
    if not 0.0 <= acc_m <= 1.0:
        fail(f"zoo mach evaluate() returned {acc_m}")
    mach_vs_ref = zoo_mach_checks(torch, ce, mach, rows)
    del mach
    gc.collect()
    torch.cuda.empty_cache()
    del f, y, batch, inputs
    phase_s = time.perf_counter() - t_phase
    log(f"zoo training phase: {phase_s:.1f} s")
    e2e.update({
        "zoo_train_setup_s": setup_s, "zoo_fit_s": fit_s,
        "zoo_fit_losses": [r["loss"] for r in hist],
        "zoo_fit_peak_memory_gb": peak_gb,
        "zoo_evaluate_accuracy": acc, "zoo_evaluate_s": eval_s,
        "zoo_evaluate_peak_memory_gb": eval_peak,
        "zoo_train_step_ms_n1": step_ms[1], "zoo_train_step_ms_n2": step_ms[2],
        "zoo_train_tokens_per_s_n1": tokens / step_ms[1] * 1e3,
        "zoo_train_tokens_per_s_n2": tokens / step_ms[2] * 1e3,
        "zoo_train_step_profile": prof, "zoo_train_step_peak_memory_gb":
            step_peak,
        "zoo_step_loss_kernel_vs_ref": step_loss,
        "zoo_step_loss_rel_err": loss_rel,
        "zoo_step_table_kernel_vs_ref_max_abs": table_err,
        "zoo_head_grad_kernel_vs_ref_rel_err": grad_err,
        "zoo_table_grad_kernel_vs_ref": grad_gaps,
        "zoo_evaluate_kernel_vs_ref": eval_vs_ref,
        "zoo_mach_kernel_vs_ref": mach_vs_ref,
        "zoo_fit_n2_s": fit2_s, "zoo_fit_n2_losses": [r["loss"]
                                                      for r in hist2],
        "zoo_fit_n2_peak_memory_gb": peak2,
        "zoo_knn_fit_s": fitk_s, "zoo_knn_losses": [r["loss"]
                                                    for r in hist_k],
        "zoo_knn_label_recall": recall,
        "zoo_knn_distinct_labels": list(n_labels),
        "zoo_knn_label_recall_half_batch": recall_half,
        "zoo_knn_step_ms": knn_step_ms,
        "zoo_knn_peak_memory_gb": peak_k,
        "zoo_mach_fit_s": fitm_s, "zoo_mach_losses": [r["loss"]
                                                      for r in hist_m],
        "zoo_mach_peak_memory_gb": peak_m, "zoo_mach_evaluate": acc_m,
        "zoo_training_phase_s": phase_s})
    return launches, rows, e2e, exp


def retrieval_kernel_rows(torch, np, dc, ivf, exp, idx, tag):
    """``stage1_topk`` and ``ivf_rerank`` at a zoo model's retrieval
    shapes (64 random queries against the trained table, raw scores, its
    IVF index ``idx``): values and ids against the plain versions, times
    beside the plain versions, the library calls and the bounds. Returns
    {kernel: row}."""
    from repro_torch.core import sharded_softmax as sharded
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = exp.model_cfg
    b, k, d = ZOO_RET_B, K, cfg.d_model
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, d)).astype(np.float32)).to(DEVICE)
    w = lm.head_weight(exp.params, cfg).detach()
    v = w.shape[0]
    logits = q @ w.T
    check_topk(torch, dc, logits, k, CHUNK, f"{tag}: serving logits")
    nch = -(-v // CHUNK)
    tk_ms = cuda_ms(torch, lambda: dc.stage1_topk(logits, k, chunk=CHUNK), 50)
    tk_plain = cuda_ms(torch, lambda: dc.stage1_topk_plain(logits, k, CHUNK),
                       5)
    padded = torch.nn.functional.pad(logits, (0, nch * CHUNK - v),
                                     value=float("-inf")).reshape(-1, CHUNK)
    tk_lib = cuda_ms(torch, lambda: torch.topk(padded, k, dim=1), 50)
    tk_bound, tk_by = bound_ms(dc.cost(b, v, k, CHUNK))
    rows = {"stage1_topk": dict(
        ms=tk_ms, plain_ms=tk_plain, library_ms=tk_lib,
        library="torch.topk on the padded chunks", max_abs_err=0.0,
        bound_ms=tk_bound, bound_by=tk_by,
        shape=f"x[{b},{v}] chunk {CHUNK} k {k} ({cfg.name} raw logits)")}
    probe, cand = _probe_candidates(torch, ops, sharded, q, idx, idx.nprobe)
    members = idx.members
    err, swaps, _ = check_ivf(torch, ivf, q, w, cand, k,
                              f"{tag}: serving shapes", members=members,
                              probe=probe)
    iv_ms = cuda_ms(torch, lambda: ivf.ivf_rerank_probed(q, w, members,
                                                         probe, k), 20)
    iv_plain = cuda_ms(torch, lambda: ivf.ivf_rerank_plain(q, w, cand, k), 3)
    safe = cand.clamp_min(0).long()
    iv_lib = cuda_ms(torch, lambda: torch.einsum("bd,bad->ba", q, w[safe]), 3)
    iv_cost, union, n_real = ivf_union_bytes(torch, members, probe, b, k, d)
    iv_bound, iv_by = bound_ms(iv_cost)
    rows["ivf_rerank"] = dict(
        ms=iv_ms, plain_ms=iv_plain, library_ms=iv_lib,
        library="einsum('bd,bad->ba', f, W[cand]) (gather + cuBLAS fp32)",
        max_abs_err=err, near_tie_id_swaps=swaps, bound_ms=iv_bound,
        bound_by=iv_by, real_candidates=n_real, distinct_rows=union,
        shape=f"f[{b},{d}] W[{v},{d}] members[{members.shape[0]},"
              f"{members.shape[1]}] probe[{b},{idx.nprobe}] k={k} (raw)")
    log(f"{tag}: stage1_topk on [{b}, {v}] {tk_ms:.4f} ms "
        f"(bound {tk_bound:.4f} by {tk_by}), plain {tk_plain:.3f}, "
        f"torch.topk {tk_lib:.4f}; ivf_rerank ({n_real} real candidates, "
        f"{union} distinct rows, D={d}) {iv_ms:.4f} ms (bound "
        f"{iv_bound:.4f} by {iv_by}), plain {iv_plain:.3f}, gathered einsum "
        f"{iv_lib:.3f}; values max abs err {err:.3g}, near-tie swaps {swaps}")
    del logits, padded, safe, cand
    return rows


def zoo_retrieval_phase(torch, np, counters, dc, ivf, exp):
    """The zoo's feature retrieval on the trained full-head experiment:
    exact and IVF top-5 of 64 queries (the JAX package's default pool)
    through the serving engine, each with the counters reset and read
    around it, against the ref backend on the same params (scores within
    IVF_TOL, ids equal except at near-ties), batch latencies (median of
    10), and ``stage1_topk`` / ``ivf_rerank`` at these shapes against
    their plain versions. Returns ({path: launches}, {kernel: row},
    numbers)."""
    t_phase = time.perf_counter()
    launches = {}
    cfg = exp.model_cfg
    b, k = ZOO_RET_B, K
    results = {}
    for path, index in (("zoo_retrieval", None), ("zoo_ivf_retrieval",
                                                  "ivf")):
        if index:
            exp.ivf_index()             # the fit is not the serve's
        _reset(counters)
        ids, scores = exp.serve(batch=b, top_k=k, return_scores=True,
                                index=index)
        torch.cuda.synchronize()
        launches[path] = {n: v for n, v in _read(counters).items() if v}
        if launches[path] != ZOO_WANT[path]:
            fail(f"the {path} path launched {launches[path]}, not "
                 f"{ZOO_WANT[path]}")
        if ids.shape != (b, k) or scores.shape != (b, k):
            fail(f"{path}: result shapes {ids.shape} {scores.shape}")
        if not np.all((ids >= 0) & (ids < cfg.vocab_size)):
            fail(f"{path}: class ids out of range")
        if not np.all(np.isfinite(scores)) or np.any(np.diff(scores, 1) > 0):
            fail(f"{path}: scores not finite or not descending")
        results[path] = (ids, scores)
    idx = exp.ivf_index()
    ref = _zoo_trainer("ref")
    ref.load_params(exp.params)
    errs = {}
    for path, index in (("zoo_retrieval", None), ("zoo_ivf_retrieval",
                                                  "ivf")):
        rids, rscores = ref.serve(batch=b, top_k=k, return_scores=True,
                                  index=index)
        errs[path] = _same_topk(np, *results[path], rids, rscores,
                                f"{path}, kernel vs ref backend")
    overlap = float(np.mean([len(set(e) & set(i)) / k for e, i in zip(
        results["zoo_retrieval"][0], results["zoo_ivf_retrieval"][0])]))
    lat = {"exact_top5_b64_ms": host_ms(torch, lambda: exp.serve(
               batch=b, top_k=k, return_scores=True), 10),
           "ivf_top5_b64_ms": host_ms(torch, lambda: exp.serve(
               batch=b, top_k=k, return_scores=True, index="ivf"), 10)}
    log(f"zoo retrieval phase: launches {launches}; kernel vs ref score max "
        f"abs err {errs}; IVF ({idx.n_clusters} clusters of cap {idx.cap}, "
        f"nprobe {idx.nprobe}) shares {overlap:.3f} of the exact top-5 on "
        f"these random queries; batch latency {lat}")
    del ref

    # -- the kernels at these shapes ----------------------------------------
    rows = retrieval_kernel_rows(torch, np, dc, ivf, exp, idx,
                                 "zoo retrieval phase")
    phase_s = time.perf_counter() - t_phase
    log(f"zoo retrieval phase: {phase_s:.1f} s")
    return launches, rows, {
        "zoo_retrieval_kernel_vs_ref_score_max_abs_err": errs,
        "zoo_ivf_exact_overlap": overlap,
        "zoo_ivf_clusters": idx.n_clusters, "zoo_ivf_cap": idx.cap,
        "zoo_ivf_nprobe": idx.nprobe, "zoo_ivf_fit_s": idx.fit_s,
        **{f"zoo_{k_}": v_ for k_, v_ in lat.items()},
        "zoo_retrieval_phase_s": phase_s}


def zoo_train_launchers_phase(torch):
    """The train launcher with ``--system zoo`` at full width for 2 steps
    (the full and the knn head), then the serve launcher's zoo top-5, exact
    and through the IVF index, all in this process; each must return 0."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    out = {}
    for head in ("full", "knn"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train_launcher.main(
                ["--system", "zoo", "--arch", "smollm_135m", "--batch",
                 str(ZOO_TB), "--seq", str(ZOO_TS), "--steps", "2", "--lr",
                 str(ZOO_LR), "--head", head, "--device", DEVICE])
        text = buf.getvalue()
        acc = [line for line in text.splitlines()
               if "[zoo] final next-token accuracy" in line]
        if rc != 0 or not acc:
            fail(f"train launcher --system zoo --head {head} returned {rc}: "
                 f"{text[-500:]}")
        out[f"zoo_train_launcher_{head}_s"] = time.perf_counter() - t0
        log(f"zoo launchers: train --head {head}: {acc[-1]} "
            f"({out[f'zoo_train_launcher_{head}_s']:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()
    for extra in ([], ["--index", "ivf"]):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_launcher.main(
                ["--system", "zoo", "--arch", "smollm_135m", "--topk",
                 str(K), "--batch", str(ZOO_RET_B), "--device",
                 DEVICE] + extra)
        text = buf.getvalue()
        if rc != 0 or "first query ids" not in text:
            fail(f"serve launcher --system zoo --topk {K} {extra} returned "
                 f"{rc}: {text[-500:]}")
        key = "zoo_serve_launcher_topk" + ("_ivf" if extra else "") + "_s"
        out[key] = time.perf_counter() - t0
        log(f"zoo launchers: serve --topk {K} {' '.join(extra)}: "
            f"{text.splitlines()[0]}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the ssm and hybrid families (mamba2-370M, hymba-1.5B) at full width, and
# the zoo's checkpoints
# ---------------------------------------------------------------------------


def _family(arch: str, backend: str, params=None, dtype=None):
    """A serving experiment of ``arch`` at its published width and depth
    (the serve depth in FAM_LAYERS where it is cut; random weights from
    seed 0; ``params`` installs others), the full head on ``backend``;
    ``dtype`` overrides the compute dtype (``"float32"``: the fp32
    checks)."""
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig
    with _at_depth(FAM_LAYERS.get(arch, (None,))[0]):
        exp = Experiment.from_config(
            system="zoo", arch=arch, batch=ZOO_BATCH,
            seq=ZOO_PROMPT + ZOO_GEN, seed=0, device=DEVICE, log_every=0,
            head=HeadConfig(backend=backend))
    if params is not None:
        exp.load_params(params)
    if dtype is not None:
        exp.model_cfg = dataclasses.replace(exp.model_cfg, dtype=dtype)
    return exp


def _describe(exp) -> str:
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.optim import tree_leaves
    cfg = exp.model_cfg
    parts = [f"{cfg.n_layers} layers"]
    if cfg.family == "encdec":
        parts.append(f"{cfg.n_enc_layers} encoder layers over {cfg.enc_seq} "
                     f"frames")
    parts.append(f"d_model {cfg.d_model}")
    if cfg.family != "ssm":
        parts.append(f"{cfg.n_heads}/{cfg.n_kv_heads} attention heads of "
                     f"{cfg.resolved_head_dim}, window {cfg.sliding_window}")
    if cfg.moe is not None:
        parts.append(f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
                     f"d_ff {cfg.moe.d_ff} (capacity factor "
                     f"{cfg.moe.capacity_factor}, {cfg.moe.n_shared_experts}"
                     f" shared)")
    elif cfg.family != "ssm":
        parts.append(f"d_ff {cfg.d_ff}")
    if cfg.ssm is not None:
        _, n_ssm, _ = ssm_dims(cfg)
        parts.append(f"{n_ssm} SSM heads of {cfg.ssm.head_dim}, d_state "
                     f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}")
    parts.append(f"vocab {cfg.vocab_size}, {cfg.dtype} over "
                 f"{cfg.param_dtype}")
    n_params = sum(p.numel() for p in tree_leaves(exp.params))
    return (f"{cfg.name} ({cfg.family}: {', '.join(parts)}), "
            f"{n_params / 1e6:.1f}M params")


def _greedy_logits(torch, exp, h):
    """The greedy tokens and [b, V] logits of features h [b, D], as the
    serve's head takes them (``serve_logits_local`` on the features in the
    compute dtype)."""
    from repro_torch.core import sharded_softmax as sharded
    from repro_torch.models import lm
    cfg = exp.model_cfg
    return sharded.serve_logits_local(
        h.to(getattr(torch, cfg.dtype)), lm.head_weight(exp.params, cfg))


def _logit_gate(torch, np, exp, h_a, h_b, tol, what, tie=None):
    """Features h_a against h_b ([b, D]): their max abs difference over
    max|h_b|, the greedy logits' over max|logit_b| within ``tol``, and the
    greedy tokens equal but where b's top-2 gap is below twice ``tie`` of
    max|logit_b| (``tie`` None: ``tol``; ``tol`` None: read and reported,
    not gated, the near-ties from the reading). Returns (h rel, logit
    rel, tokens equal, tokens checked)."""
    ids_a, lg_a = _greedy_logits(torch, exp, h_a)
    ids_b, lg_b = _greedy_logits(torch, exp, h_b)
    h_rel = float((h_a.float() - h_b.float()).abs().max()
                  / h_b.float().abs().max())
    scale = float(lg_b.abs().max())
    lg_rel = float((lg_a - lg_b).abs().max()) / scale
    if not torch.isfinite(lg_a).all():
        fail(f"{what}: non-finite logits")
    if tol is not None and lg_rel > tol:
        fail(f"{what}: logits differ by {lg_rel:.3g} of max|logit| > {tol}")
    if tie is None:
        tie = lg_rel if tol is None else tol
    top2 = lg_b.topk(2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]).cpu().numpy() < 2 * tie * scale
    ia, ib = ids_a.cpu().numpy(), ids_b.cpu().numpy()
    if tol is not None and ((ia != ib) & ~near).any():
        fail(f"{what}: greedy tokens differ at {int(((ia != ib) & ~near).sum())}"
             f" rows whose top-2 gap is at least {2 * tie * scale:.3g}")
    return h_rel, lg_rel, int((ia == ib).sum()), int((~near).sum())


def _continuation(torch, exp, prompts, backend="kernel"):
    """The last position's features of a prefill of all S + 1 prompt
    tokens, and of a prefill of S then one decode step through the caches
    (``tests/test_decode.py``'s check of the JAX package)."""
    from repro_torch.models import decoder, lm
    cfg = exp.model_cfg
    s = prompts.shape[1] - 1
    window = lm.decode_window(cfg, s + 1)
    with torch.no_grad():
        full = lm.backbone(exp.params, cfg, {"tokens": prompts},
                           backend=backend)[0][:, -1]
        _, _, caches = lm.backbone(exp.params, cfg,
                                   {"tokens": prompts[:, :s]},
                                   want_cache=True, cache_window=window,
                                   backend=backend)
        slots = decoder.init_cache_slots(
            cfg, window, prefill_positions=torch.arange(s, device=DEVICE))
        step = lm.decode(exp.params, cfg, {"token": prompts[:, s:]}, caches,
                         slots, window=window, backend=backend)[0][:, 0]
    return full, step


def _continuation_checks(torch, np, exp, tag):
    """Prefill of ZOO_PROMPT tokens and one decode step against a prefill
    of ZOO_PROMPT + 1 (``tests/test_decode.py``'s check, which holds the
    JAX package in fp32): in fp32 compute the features within
    FAM_CONT32_TOL of max|h| and every greedy token equal; in the compute
    dtype (bf16, where the two paths round in other places) the same
    readings, reported. The moe family at a capacity factor of E / k,
    where no expert can drop a pair, a row at a time: at its own factor
    the prefill's groups of 2,000 tokens drop pairs past capacity, and the
    last token first (it sorts last within each expert), where the decode
    step drops none, so the two are different functions there."""
    from repro_torch.configs.base import effective_vocab
    from repro_torch.data import synthetic
    prompts = synthetic.lm_batch(0, ZOO_BATCH, ZOO_PROMPT + 1,
                                 effective_vocab(exp.model_cfg),
                                 device=DEVICE)["tokens"]
    out = {}
    moe = exp.model_cfg.moe
    no_drop = {} if moe is None else {"moe": dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)}
    for dtype, tol in ((exp.model_cfg.dtype, None),
                       ("float32", FAM_CONT32_TOL)):
        cfg0 = exp.model_cfg
        exp.model_cfg = dataclasses.replace(cfg0, dtype=dtype, **no_drop)
        try:
            if moe is None:
                full, step = _continuation(torch, exp, prompts)
            else:
                # a row at a time: at E / k every expert's buffer holds the
                # row's 2,001 tokens, [1, 128, 2,008, 2,048] a layer
                rows = [_continuation(torch, exp, prompts[i:i + 1])
                        for i in range(prompts.shape[0])]
                full = torch.cat([r[0] for r in rows])
                step = torch.cat([r[1] for r in rows])
                del rows
            h_rel, lg_rel, n_eq, n_chk = _logit_gate(
                torch, np, exp, step, full, tol,
                f"{tag}: prefill + one decode step vs prefill of S + 1 "
                f"({dtype})")
        finally:
            exp.model_cfg = cfg0
        if tol is not None and h_rel > tol:
            fail(f"{tag}: prefill + one decode step vs prefill of S + 1 "
                 f"({dtype}): features differ by {h_rel:.3g} of max|h| > "
                 f"{tol}")
        if tol is not None and n_eq != ZOO_BATCH:
            fail(f"{tag}: in fp32 the decode step's greedy tokens differ "
                 f"from the longer prefill's at {ZOO_BATCH - n_eq} rows")
        out[dtype] = {"h_rel": h_rel, "logit_rel": lg_rel,
                      "tokens_equal": n_eq, "tokens_checked": n_chk}
        del full, step
    log(f"{tag}: prefill of {ZOO_PROMPT} + one decode step vs prefill of "
        f"{ZOO_PROMPT + 1}, by compute dtype: {out}")
    return out


def _serve_times(torch, exp, first):
    """Prefill and decode of ``serve`` (host clock, synchronised spans):
    the median of the main path's serve (its tracer ``first``) and
    FAM_REPS more; one profiled prefill and one profiled decode step (idle
    share, device time, costliest kernels)."""
    from repro_torch.configs.base import InputShape, effective_vocab
    from repro_torch.data import synthetic
    from repro_torch.models import decoder
    from repro_torch.telemetry import Tracer
    from repro_torch.train import gspmd
    pre, dec = [], []
    for i in range(FAM_REPS + 1):
        tr = first if i == 0 else Tracer()
        if i:
            exp.serve(prompt_len=ZOO_PROMPT, gen=ZOO_GEN, batch=ZOO_BATCH,
                      telemetry=tr)
        pre.append(tr.span_stats("serve.prefill")["total_s"] * 1e3)
        dec.append(tr.span_stats("serve.decode")["total_s"] * 1e3)
    cfg = exp.model_cfg
    shape = InputShape("serve-decode", ZOO_PROMPT + ZOO_GEN, ZOO_BATCH,
                       "decode")
    backend = exp.head_cfg.backend
    prefill = gspmd.make_prefill_step(cfg, shape, backend=backend)
    step = gspmd.make_serve_step(cfg, shape, backend=backend)
    prompts = synthetic.lm_batch(0, ZOO_BATCH, ZOO_PROMPT,
                                 effective_vocab(cfg), device=DEVICE)["tokens"]
    with torch.no_grad():
        # the prompt fills hymba's window: its K/V need no padding
        tok, caches = prefill(exp.params, {"tokens": prompts})
        slots = decoder.init_cache_slots(
            cfg, _decode_window(cfg),
            prefill_positions=torch.arange(ZOO_PROMPT, device=DEVICE))
        prof_pre = profile_ms(torch, lambda: prefill(
            exp.params, {"tokens": prompts}), device_only=True)
        # the step writes its token's cache in place: the profiled calls
        # rewrite the same slot with the same values
        step(exp.params, caches, slots, tok[:, None])
        prof_dec = profile_ms(torch, lambda: step(exp.params, caches, slots,
                                                  tok[:, None]),
                              device_only=True)
    prefill_ms, decode_ms = statistics.median(pre), statistics.median(dec)
    return {"prefill_ms": prefill_ms, "prefill_ms_all": pre,
            "decode_step_ms": decode_ms / (ZOO_GEN - 1),
            "decode_ms": decode_ms,
            "tok_per_s": ZOO_BATCH * ZOO_GEN / ((prefill_ms + decode_ms)
                                                / 1e3),
            "prefill_profile": prof_pre, "decode_step_profile": prof_dec}


def _decode_window(cfg) -> int:
    from repro_torch.models import lm
    return lm.decode_window(cfg, ZOO_PROMPT + ZOO_GEN)


def family_serve_phase(torch, np, counters, arch):
    """``serve(prompt_len=2000, gen=48, batch=8)`` of ``arch`` at full width
    on the kernel backend, every counter reset just before and read just
    after (``FAM_WANT``); the decode's continuation of the prefill; for
    the hybrid family, the tokens against the ref backend's; times,
    profiles and peak memory. Returns (path, launches, numbers)."""
    tag = f"{arch} serve phase"
    t_phase = time.perf_counter()
    exp = _family(arch, "kernel")
    cfg = exp.model_cfg
    log(f"{tag}: {_describe(exp)}; {ZOO_BATCH} prompts of {ZOO_PROMPT} "
        f"tokens, {ZOO_GEN} greedy tokens, decode window "
        f"{_decode_window(cfg)}")
    path = f"{cfg.family}_serving"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.telemetry import Tracer
    first = Tracer()
    _reset(counters)
    toks = exp.serve(prompt_len=ZOO_PROMPT, gen=ZOO_GEN, batch=ZOO_BATCH,
                     telemetry=first)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read(counters).items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{tag}: launches on the main path {launches}; peak {peak_gb:.2f} GB")
    if launches != FAM_WANT[path]:
        fail(f"{tag}: the serve launched {launches}, not {FAM_WANT[path]} "
             f"(PERF.md §6)")
    if toks.shape != (ZOO_BATCH, ZOO_GEN) or toks.dtype != np.int32 or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{tag}: tokens {toks.shape} {toks.dtype} out of shape or range")
    e2e = {"launches": launches, "peak_memory_gb": peak_gb,
           "first_row": toks[0].tolist()}
    e2e["continuation"] = _continuation_checks(torch, np, exp, tag)
    if cfg.family != "ssm":
        e2e["vs_ref"] = _kernel_vs_ref(
            torch, np, exp, tag,
            e2e["continuation"][cfg.dtype]["logit_rel"])
    e2e.update(_serve_times(torch, exp, first))
    e2e["phase_s"] = time.perf_counter() - t_phase
    log(f"{tag}: prefill {e2e['prefill_ms']:.2f} ms (all {e2e['prefill_ms_all']}"
        f"), decode {e2e['decode_step_ms']:.3f} ms a step, "
        f"{e2e['tok_per_s']:.1f} tok/s; profiled prefill: idle "
        f"{e2e['prefill_profile']['idle_share']:.3f}, device "
        f"{e2e['prefill_profile']['device_busy_ms']:.2f} of "
        f"{e2e['prefill_profile']['wall_ms']:.2f} ms, top "
        f"{e2e['prefill_profile']['top_kernels_ms']}; profiled decode step: "
        f"idle {e2e['decode_step_profile']['idle_share']:.3f}, device "
        f"{e2e['decode_step_profile']['device_busy_ms']:.2f} of "
        f"{e2e['decode_step_profile']['wall_ms']:.2f} ms; phase "
        f"{e2e['phase_s']:.1f} s")
    del exp
    gc.collect()
    torch.cuda.empty_cache()
    return path, launches, e2e


def _kernel_vs_ref(torch, np, exp, tag, spread):
    """The kernel backend's serve against the ref backend's on the same
    weights and prompts: the prefill's last ZOO_TOKEN_ROWS positions of
    every row (features within FAM_H_TOL, logits within FAM_LOGIT_TOL,
    greedy tokens equal but where the ref's top-2 gap is below twice
    ``spread`` of max|logit|, the kernel-free bf16 spread this run read
    on the same model (the decode step against the longer prefill); bf16;
    in bf16 the served sequences part at the first near-tie, after which
    they are no longer comparable), and in fp32 compute every served
    token equal."""
    from repro_torch.configs.base import effective_vocab
    from repro_torch.data import synthetic
    from repro_torch.models import lm
    cfg = exp.model_cfg
    prompts = synthetic.lm_batch(0, ZOO_BATCH, ZOO_PROMPT,
                                 effective_vocab(cfg), device=DEVICE)["tokens"]
    with torch.no_grad():
        h = {b: lm.backbone(exp.params, cfg, {"tokens": prompts},
                            backend=b)[0][:, -ZOO_TOKEN_ROWS:].reshape(
                                -1, cfg.d_model)
             for b in ("kernel", "ref")}
    h_rel, lg_rel, n_eq, n_chk = _logit_gate(
        torch, np, exp, h["kernel"], h["ref"], FAM_LOGIT_TOL,
        f"{tag}: prefill, kernel vs ref", tie=spread)
    if h_rel > FAM_H_TOL:
        fail(f"{tag}: prefill features, kernel vs ref, {h_rel:.3g} of max|h|"
             f" > {FAM_H_TOL}")
    del h
    toks32 = {}
    for b in ("kernel", "ref"):
        e32 = _family(_ARCH[cfg.family], b, params=exp.params,
                      dtype="float32")
        toks32[b] = e32.serve(prompt_len=ZOO_PROMPT, gen=ZOO_GEN,
                              batch=ZOO_BATCH)
        del e32
        gc.collect()
        torch.cuda.empty_cache()
    if not np.array_equal(toks32["kernel"], toks32["ref"]):
        fail(f"{tag}: in fp32 compute the kernel backend's tokens differ from "
             f"the ref backend's at "
             f"{int((toks32['kernel'] != toks32['ref']).sum())} of "
             f"{toks32['ref'].size}")
    out = {"prefill_h_rel": h_rel, "prefill_logit_rel": lg_rel,
           "prefill_tokens_equal": n_eq, "prefill_tokens_checked": n_chk,
           "near_tie_spread": spread,
           "prefill_positions": ZOO_BATCH * ZOO_TOKEN_ROWS,
           "served_tokens_equal_fp32": int(
               (toks32["kernel"] == toks32["ref"]).sum())}
    log(f"{tag}: kernel vs ref: prefill features {h_rel:.3g} of max|h|, "
        f"logits {lg_rel:.3g} of max|logit| (<= {FAM_LOGIT_TOL}), next "
        f"tokens equal at {n_eq}/{ZOO_BATCH * ZOO_TOKEN_ROWS} ({n_chk} "
        f"checked: top-2 gap at least twice the kernel-free bf16 spread "
        f"{spread:.3g}); in fp32 compute all {toks32['ref'].size} served "
        f"tokens equal")
    return out


def flash_shape_check(torch, fa, b, heads, kv_heads, s, dh, causal, window,
                      what, seed=9):
    """``flash_attention`` at a model's prefill shapes: q [b * heads, s,
    dh] over b * kv_heads KV heads, bf16 (causal, within ``window`` when it
    is set; or non-causal): the bf16 gate against its plain version,
    bit-identical across two runs, timed beside its plain version and
    SDPA (the window as a boolean mask)."""
    bh, bhkv = b * heads, b * kv_heads
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    q, k, v = (torch.randn((h, s, dh), generator=g, device=DEVICE).to(
        torch.bfloat16) for h in (bh, bhkv, bhkv))
    kw = dict(causal=causal, window=window)
    out = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail(f"flash_attention at {what}'s shapes is not bit-identical across "
             f"two runs")
    plain = fa.flash_attention_plain(q, k, v, **kw)
    err = float((out.float() - plain.float()).abs().max())
    gate = flash_bf16_gate(torch, out, plain, flash_flip_bound(
        torch, fa, q, k, v, causal=causal, window=window))
    if not gate["ok"]:
        fail(f"flash_attention at {what}'s shapes: max abs err {err:.3g}, "
             f"gate {gate}")
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **kw),
                       2)
    q4 = q.view(b, heads, s, dh)
    k4, v4 = (x.view(b, kv_heads, s, dh) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        i = torch.arange(s, device=DEVICE)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        lib_kw, lib = (dict(attn_mask=mask),
                       f"attn_mask=causal window of {window:,}")
    else:
        lib_kw, lib = dict(is_causal=causal), f"is_causal={causal}"
    lib_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, enable_gqa=True,
                                         **lib_kw), 20)
    lib_out = sdpa(q4, k4, v4, enable_gqa=True, **lib_kw).reshape(bh, s, dh)
    lib_err = float((lib_out.float() - plain.float()).abs().max())
    bound, by = _flash_bound(bh, s, s, dh, 2, bhkv, causal, window)
    mode = ("non-causal" if not causal else
            "causal" + (f", window {window}" if window else ""))
    log(f"flash at {what}'s shapes: BH={bh} over {bhkv} KV heads, S=T={s}, "
        f"Dh={dh}, bf16, {mode}: max abs err {err:.3g}, bf16 gate ratio "
        f"{gate['ratio']:.3g} (<= 1), mean {gate['mean_rel']:.3g}; "
        f"bit-identical; {ms:.4f} ms, bound {bound:.4f} ms by {by}, plain "
        f"{plain_ms:.3f} ms, SDPA ({lib}) {lib_ms:.4f} ms (max abs err "
        f"{lib_err:.3g})")
    del q, k, v, out, again, plain, lib_out
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library=f"scaled_dot_product_attention({lib}, "
                        f"enable_gqa=True)",
                bound_ms=bound, bound_by=by, max_abs_err=err,
                library_max_abs_err=lib_err,
                bf16_gate=(gate["ratio"], gate["mean_rel"]),
                shape=f"q[{bh},{s},{dh}] k,v[{bhkv},{s},{dh}] bf16 {mode}")


def flash_family_check(torch, fa, arch):
    """``flash_attention`` at a family's shapes: a serve's prefill (8
    prompts of 2,000 tokens; hymba's 25 query heads over 5 KV heads of 64
    in its window of 1,024, qwen3-moe's 32 over 4 of 128 and chameleon's
    64 over 8: groups of 8, causal) or whisper's encoder over 16 rows of
    1,500 frames (6 heads of 64, non-causal)."""
    from repro_torch.configs.base import get_model_config
    cfg = get_model_config(arch)
    if cfg.family == "encdec":
        return flash_shape_check(torch, fa, ZOO_TB, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.enc_seq,
                                 cfg.resolved_head_dim, False, 0, arch)
    return flash_shape_check(torch, fa, ZOO_BATCH, cfg.n_heads,
                             cfg.n_kv_heads, ZOO_PROMPT,
                             cfg.resolved_head_dim, True,
                             cfg.sliding_window or 0, arch)


def ssd_layer_check(torch, exp):
    """One layer's SSM at the training micro-batch's shapes (4 x 512
    tokens, chunk 256) on the card: the chunked scan against the
    token-by-token ``apply_ssm_step`` recurrence in fp32 compute (outputs
    and final states within FAM_SCAN_TOL of their max), the gradient of
    sum(y^2) through the chunked scan in the training dtype finite in
    every param and the input, and, for the record, the same gradient with
    the decay taken as the JAX package takes it (the exp of every pair,
    masked after): its NaN count."""
    from repro_torch.models import ssm
    cfg = exp.model_cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = exp.params.blocks[0].ssm
    b = ZOO_TB // FAM_MICRO[_ARCH[cfg.family]]
    g = torch.Generator(device=DEVICE)
    g.manual_seed(12)
    x = torch.randn((b, ZOO_TS, cfg.d_model), generator=g, device=DEVICE)
    with torch.no_grad():
        y, cache = ssm.apply_ssm(p, cfg32, x)
        st = ssm.init_ssm_cache(cfg32, b, torch.float32, device=DEVICE)
        ys = []
        for t in range(ZOO_TS):
            yt, st = ssm.apply_ssm_step(p, cfg32, x[:, t:t + 1], st)
            ys.append(yt)
        rec = torch.cat(ys, dim=1)
    y_err = float((y - rec).abs().max() / rec.abs().max())
    s_err = float((cache["ssm_state"] - st["ssm_state"]).abs().max()
                  / st["ssm_state"].abs().max())
    if not (y_err <= FAM_SCAN_TOL and s_err <= FAM_SCAN_TOL):
        fail(f"ssd_chunked at chunk {cfg.ssm.chunk} vs the recurrence: "
             f"outputs {y_err:.3g}, states {s_err:.3g} > {FAM_SCAN_TOL}")
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    from repro_torch.models.layers import ParamDict
    pg = ParamDict(**leaves)
    xg = x.to(getattr(torch, cfg.dtype)).requires_grad_()
    (ssm.apply_ssm(pg, cfg, xg)[0].float() ** 2).sum().backward()
    finite = all(bool(torch.isfinite(t.grad).all())
                 for t in list(leaves.values()) + [xg])
    if not finite:
        fail("the gradient through ssd_chunked at chunk "
             f"{cfg.ssm.chunk} is not finite")
    nan_ref = _reference_order_nans(torch, exp, x)
    log(f"ssd at one layer of {cfg.name} ({b} x {ZOO_TS} tokens, chunk "
        f"{cfg.ssm.chunk}): chunked vs recurrence, fp32: outputs {y_err:.3g},"
        f" states {s_err:.3g} of max (<= {FAM_SCAN_TOL}); the gradient in "
        f"{cfg.dtype} finite; with the JAX package's order (exp, then the "
        f"mask) the dt gradient has {nan_ref} NaN entries")
    del leaves, pg, xg
    return {"scan_vs_recurrence_rel": y_err, "states_rel": s_err,
            "grad_finite": finite, "reference_order_dt_grad_nans": nan_ref}


def _reference_order_nans(torch, exp, x):
    """The layer's intra-chunk term with the JAX package's order (``ssm.py:
    96-98``: exp(cums_i - cums_j) of every pair, the upper triangle zeroed
    after), differentiated with respect to dt in fp32: the NaN entries of
    that gradient (0 * inf in exp's backward)."""
    from repro_torch.models import ssm
    cfg = dataclasses.replace(exp.model_cfg, dtype="float32")
    p = exp.params.blocks[0].ssm
    d_inner, h, _ = ssm.ssm_dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    with torch.no_grad():
        zx = x @ p.in_proj
        _, xbc, dt_raw = ssm._split_in_proj(cfg, zx)
        xbc = torch.nn.functional.silu(ssm._causal_conv(xbc, p.conv_w,
                                                        p.conv_b))
    b, s, _ = x.shape
    c, nc = cfg.ssm.chunk, s // cfg.ssm.chunk
    dt_raw = dt_raw.detach().requires_grad_()
    dt = ssm._softplus(dt_raw + p.dt_bias).view(b, nc, c, h)
    cums = torch.cumsum(dt * -torch.exp(p.A_log), dim=2)
    ldec = torch.exp(cums[:, :, :, None, :] - cums[:, :, None, :, :])
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=DEVICE))
    ldec = torch.where(tri[None, None, :, :, None], ldec, 0.0)
    bm = xbc[..., d_inner:d_inner + gn].reshape(b, nc, c, -1)
    cm = xbc[..., d_inner + gn:].reshape(b, nc, c, -1)
    cb = torch.einsum("bcln,bcmn->bclm", cm, bm)
    xh = xbc[..., :d_inner].reshape(b, nc, c, h, -1)
    y = torch.einsum("bclm,bclmh,bcmhp->bclhp", cb, ldec, xh * dt[..., None])
    (y ** 2).sum().backward()
    n = int(torch.isnan(dt_raw.grad).sum())
    del ldec, y
    torch.cuda.empty_cache()
    return n


def _trunk_leaf(exp):
    """A trunk weight of layer 0 that every training step moves: the SSM's
    input projection, an expert's gate (moe), the decoder's self-attention
    query (encdec) or the attention's query."""
    cfg = exp.model_cfg
    if cfg.family == "encdec":
        return exp.params.encdec.dec_blocks[0].self_attn.wq
    blk = exp.params.blocks[0]
    if cfg.family == "ssm":
        return blk.ssm.in_proj
    return blk.moe.wi_gate if cfg.family == "moe" else blk.attn.wq


def _step1_ref_loss(torch, exp, micro):
    """Step 1's loss on the ref backend from the experiment's present
    (initial) params and head state: the loss the train step
    differentiates, micro-batch by micro-batch under no grad, averaged as
    the step averages them. (A second experiment trained one step would
    hold a second copy of the model, its gradients and moments.)"""
    from repro_torch.api.heads import make_head
    from repro_torch.core.pipeline import split_microbatches
    from repro_torch.train import gspmd
    hcfg = dataclasses.replace(exp.head_cfg, backend="ref")
    batch = exp._batch(0)
    parts = split_microbatches(batch, micro)
    loss_fn = gspmd.make_head_loss_fn(
        exp.model_cfg, hcfg, global_tokens=parts[0]["labels"].numel(),
        head=make_head(exp.model_cfg, hcfg))
    total = 0.0
    with torch.no_grad():
        for part in parts:
            loss, _ = loss_fn(exp.params, exp.head_state.params,
                              exp.head_state.aux, part,
                              step=torch.zeros((), dtype=torch.int32))
            total += float(loss) / micro
    return total


def _params_host(exp):
    from repro_torch.models import lm
    from repro_torch.optim import tree_map
    return tree_map(lambda t: t.detach().cpu(), lm.params_tree(exp.params))


def _first_fit(torch, arch, micro):
    """An uninterrupted ``fit(FAM_STEPS)`` of the training phase's
    experiment, run before it on the card alone: its losses and its
    params on the host, which the phase's own fit from the same seed must
    equal bit for bit (the moe combine sums in a fixed order, and no
    backward adds into one place from two threads)."""
    from repro_torch.configs.base import TrainConfig
    twin = _zoo_trainer("kernel", arch=arch, log_every=0,
                        train=TrainConfig(optimizer="sgd", micro_batch=micro))
    twin.data_fn = lambda t, b: twin._synthetic_batch(0, b)
    losses = [r["loss"] for r in twin.fit(FAM_STEPS, lr=ZOO_LR)]
    first = _params_host(twin)
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    return losses, first


@contextlib.contextmanager
def _routing_record(torch, moe_lib):
    """Within the block, every call of the MoE router (``moe.routing``,
    wrapped here and restored after) appends to the list it yields, on the
    device: the call's pairs per expert [E], the pairs its dispatch drops
    past capacity (in each batch row, an expert's pairs past ``cap``, as
    ``moe._dispatch_group`` keeps the first ``cap``), the pairs routed,
    and the mean cosine of a token's router input to its row's mean."""
    calls = []
    real = moe_lib.routing

    def routing(p, cfg, x):
        out = real(p, cfg, x)
        b, s, _ = x.shape
        n_e = cfg.moe.n_experts
        top_i = out[2].reshape(b, -1).long()
        per_row = torch.zeros((b, n_e), dtype=torch.int64,
                              device=x.device).scatter_add_(
            1, top_i, torch.ones_like(top_i))
        cap = moe_lib.capacity_for(s, cfg)
        xf = x.detach().float()
        cos = torch.nn.functional.cosine_similarity(
            xf, xf.mean(dim=1, keepdim=True), dim=-1).mean()
        calls.append((per_row.sum(0), (per_row - cap).clamp_min(0).sum(),
                      top_i.numel(), cos))
        return out

    moe_lib.routing = routing
    try:
        yield calls
    finally:
        moe_lib.routing = real


def _routing_summary(torch, calls, steps, micro, n_layers):
    """What ``_routing_record`` saw over a fit of ``steps`` steps of
    ``micro`` micro-batches through ``n_layers`` MoE layers (one router
    call a layer and micro-batch, layer 0 first): the drop share in all,
    by step, and by layer at the first and last step; at step 1 by layer,
    the share of the pairs on the 8 busiest experts and on experts 0-7
    (ties to the lowest index would load these), the fewest experts that
    carry half the pairs, the cosine of a token's router input to its
    row's mean, and the pairs per expert."""
    if len(calls) != steps * micro * n_layers:
        fail(f"the fit made {len(calls)} router calls, not {steps} x "
             f"{micro} x {n_layers}")
    counts = torch.stack([c[0] for c in calls]).cpu().view(
        steps, micro, n_layers, -1).sum(1)                 # [step, L, E]
    dropped = torch.stack([c[1] for c in calls]).cpu().view(
        steps, micro, n_layers).sum(1)                     # [step, L]
    routed = calls[0][2] * micro
    cos = torch.stack([c[3] for c in calls]).cpu().view(
        steps, micro, n_layers).mean(1)
    first = counts[0].double()
    srt = first.sort(dim=1, descending=True).values
    half = (srt.cumsum(1) < srt.sum(1, keepdim=True) / 2).sum(1) + 1

    def r(v):
        return [round(float(x), 4) for x in v]

    return {
        "dropped": int(dropped.sum()), "routed": routed * steps * n_layers,
        "dropped_share": float(dropped.sum()) / (routed * steps * n_layers),
        "dropped_share_by_step": r(dropped.sum(1).double()
                                   / (routed * n_layers)),
        "last_step_dropped_by_layer": r(dropped[-1].double() / routed),
        "step1_by_layer": {
            "dropped_share": r(dropped[0].double() / routed),
            "busiest8_share": r(srt[:, :8].sum(1) / srt.sum(1)),
            "lowest8_share": r(first[:, :8].sum(1) / first.sum(1)),
            "experts_for_half": [int(x) for x in half],
            "cos_to_row_mean": r(cos[0]),
            "pairs_per_expert": first.long().tolist()},
    }


def family_training_phase(torch, np, counters, ce, arch):
    """``fit(FAM_STEPS)`` of ``arch`` at full width (the train depth in
    FAM_LAYERS where it is cut) with the full head on the kernel backend,
    16 x 512 tokens a step (whisper 16 x 448, with its frames; the
    stream's first batch, every step) in ``FAM_MICRO[arch]``
    micro-batches, every counter reset just before and read just after
    (``FAM_WANT``): finite losses that fall, the head and a trunk weight
    moved. Step 1's loss against the ref backend's from the same params
    (``_step1_ref_loss``); the step's time (the median of the fit's steps
    2 to FAM_STEPS, their synchronised spans), tokens/s, a profiled step
    (idle share), peak memory; the CE pair at [tokens a micro-batch, V] x
    D through the CE gates; one layer's SSD at chunk 256 where there is
    one (``ssd_layer_check``). The moe family: the share of (token,
    expert) pairs dropped past capacity over the fit, and a first fit run
    before it (``_first_fit``) bit-equal to it. Returns (path, launches, {kernel: row},
    numbers, the trained experiment)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.telemetry import Tracer
    from repro_torch.optim import tree_leaves
    tag = f"{arch} training phase"
    t_phase = time.perf_counter()
    micro = FAM_MICRO[arch]
    first = (_first_fit(torch, arch, micro) if arch == _ARCH["moe"]
             else None)
    exp = _zoo_trainer("kernel", arch=arch, log_every=0,
                       train=TrainConfig(optimizer="sgd", micro_batch=micro))
    # every step the stream's first batch: on fresh batches the loss of
    # random weights stays near log V for many more steps than 5
    exp.data_fn = lambda t, b: exp._synthetic_batch(0, b)
    cfg = exp.model_cfg
    path = f"{cfg.family}_training"
    tokens = ZOO_TB * exp.seq
    log(f"{tag}: {_describe(exp)}; {ZOO_TB} x {exp.seq} tokens a step in "
        f"{micro} micro-batches, SGD at lr {ZOO_LR}")
    ref_loss = _step1_ref_loss(torch, exp, micro)
    w0 = lm.head_weight(exp.params, cfg).detach().clone()
    in0 = _trunk_leaf(exp).detach().clone()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Tracer()
    _reset(counters)
    t0 = time.perf_counter()
    with _routing_record(torch, moe_lib) as calls:
        hist = exp.fit(FAM_STEPS, lr=ZOO_LR, telemetry=tr)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    exp.telemetry = None
    # the steps' own spans (synchronised): the first warms up
    step_all = [e.dur_ns / 1e6 for e in tr.events if e.name == "train.step"]
    step_ms = statistics.median(step_all[1:])
    launches = {k: v for k, v in _read(counters).items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in hist]
    log(f"{tag}: fit({FAM_STEPS}) {fit_s:.2f} s, launches {launches}, losses "
        f"{losses}, peak memory {peak_gb:.2f} GB")
    if launches != FAM_WANT[path]:
        fail(f"{tag}: fit launched {launches}, not {FAM_WANT[path]} "
             f"(PERF.md §6)")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"{tag}: the losses {losses} are not finite and falling")
    moved = (float((lm.head_weight(exp.params, cfg) - w0).abs().max()),
             float((_trunk_leaf(exp) - in0).abs().max()))
    if not min(moved) > 0:
        fail(f"{tag}: training did not move the params {moved}")
    del w0, in0
    routing = (_routing_summary(torch, calls, FAM_STEPS, micro,
                                cfg.n_layers) if calls else None)
    drop_share = routing["dropped_share"] if routing else None
    if routing:
        log(f"{tag}: {routing['dropped']} of {routing['routed']} (token, "
            f"expert) pairs dropped past capacity over the fit (share "
            f"{drop_share:.4f}); by step {routing['dropped_share_by_step']}; "
            f"by layer at step 1 {routing['step1_by_layer']['dropped_share']}"
            f", at step {FAM_STEPS} {routing['last_step_dropped_by_layer']}; "
            f"at step 1 by layer: the 8 busiest experts' share "
            f"{routing['step1_by_layer']['busiest8_share']}, experts 0-7's "
            f"{routing['step1_by_layer']['lowest8_share']}, experts "
            f"carrying half the pairs "
            f"{routing['step1_by_layer']['experts_for_half']}, a token's "
            f"router input against its row's mean (cosine) "
            f"{routing['step1_by_layer']['cos_to_row_mean']}")

    det = None
    if first is not None:
        pairs = list(zip(tree_leaves(_params_host(exp)),
                         tree_leaves(first[1])))
        differ = sum(not torch.equal(x, y) for x, y in pairs)
        det = {"bitwise": differ == 0 and first[0] == losses,
               "leaves_differ": differ, "leaves": len(pairs),
               "first_losses": first[0]}
        del pairs, first
        log(f"{tag}: two uninterrupted fit({FAM_STEPS}) from the same seed: "
            f"bitwise {det['bitwise']} ({det['leaves_differ']} of "
            f"{det['leaves']} leaves differ; losses {det['first_losses']} "
            f"and {losses})")
        if not det["bitwise"]:
            fail(f"{tag}: two uninterrupted fits differ: {det}")
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if loss_rel > ZOO_LOSS_RTOL:
        fail(f"{tag}: step 1's loss, kernel {losses[0]} vs ref {ref_loss}: "
             f"rel {loss_rel:.3g} > {ZOO_LOSS_RTOL:g}")
    # -- a profiled step ------------------------------------------------------
    inputs = exp._batch(10**5)

    def one_step():
        exp.params, exp.head_state, exp.opt_state, loss, _ = exp._train_step(
            exp.params, exp.head_state, exp.opt_state, inputs, ZOO_LR)
        return float(loss)

    prof = profile_ms(torch, one_step, device_only=True, groups={
        "CE pair": ("ce_fwd", "ce_bwd", "ce_softmax", "ce_dw", "ce_df"),
        "matmuls (bf16 + fp32)": ("gemm", "cutlass", "sm90_xmma", "ampere",
                                  "cublas"),
        "copies and casts": ("copy",)})
    log(f"{tag}: step {step_ms:.2f} ms (median of steps 2-{FAM_STEPS}: "
        f"{[round(x, 1) for x in step_all]}; {tokens / step_ms * 1e3:.0f} "
        f"tokens/s); profiled step: idle {prof['idle_share']:.3f}, device "
        f"{prof['device_busy_ms']:.2f} of {prof['wall_ms']:.2f} ms, by group "
        f"{prof.get('device_ms_by_group')}; top "
        + "; ".join(f"{k} {v:.3f}" for k, v in prof["top_kernels_ms"].items()))

    # -- the CE pair at a micro-batch's shapes through the gates ------------
    # on the trained batch (p - 1 may cancel at its labels: the floor
    # gate), then on a held-out batch of the stream (the gates, the 1xTF32
    # fault, the times)
    n = tokens // micro
    if arch in FAM_LAYERS:
        # a model of tens of GB: its moments go before the gates' [n, V]
        # passes (the heads check drops them anyway)
        exp.opt_state, exp._train_step = None, None
        gc.collect()
        torch.cuda.empty_cache()
    w = lm.head_weight(exp.params, cfg).detach()
    f, y, _ = _zoo_batch_features(torch, exp, 0)
    # the trained batch's first rows: the gate's fp64 reference holds a
    # few [rows, V] tensors (2,048 rows, as the families' micro-batches)
    g = min(n, FAM_GATE_ROWS)
    trained = ce_trained_batch_gate(torch, ce, f[:g].contiguous(),
                                    w, y[:g].contiguous(), arch)
    del f, y
    exp.data_fn = exp._synthetic_batch
    f, y, _ = _zoo_batch_features(torch, exp, 10**5 + 1)
    f, y = f[:n].contiguous(), y[:n].contiguous()
    rows = dict(zip(("ce_forward", "ce_backward"), zoo_ce_rows(
        torch, ce, f, w, y, model=cfg.name, tag=arch,
        floor=arch in FAM_LAYERS)))
    rows["ce_backward"]["trained_batch"] = trained
    del f, y, w
    torch.cuda.empty_cache()
    scan = ssd_layer_check(torch, exp) if cfg.ssm is not None else None
    torch.cuda.empty_cache()
    e2e = {"micro_batches": micro, "fit_s": fit_s, "losses": losses,
           "fit_peak_memory_gb": peak_gb, "step1_loss_ref": ref_loss,
           "step1_loss_rel_err": loss_rel, "step_ms": step_ms,
           "step_ms_all": step_all,
           "tokens_per_s": tokens / step_ms * 1e3, "step_profile": prof,
           "params_moved": moved, "ssd_layer": scan,
           "dropped_share": drop_share, "routing": routing, "two_fits": det,
           "phase_s": time.perf_counter() - t_phase}
    log(f"{tag}: step 1 kernel vs ref loss rel {loss_rel:.3g}; phase "
        f"{e2e['phase_s']:.1f} s")
    return path, launches, rows, e2e, exp


def _head_loss_vs_ref(torch, exp):
    """One batch's loss (the stream's next) through the loss the step
    differentiates (``gspmd.make_head_loss_fn``), on the kernel and the
    ref backend from exp's params, head params and aux (the knn graph,
    the LSH tables, the hashes), no grad. Returns (kernel, ref)."""
    from repro_torch.api.heads import make_head
    from repro_torch.train import gspmd
    batch = exp._batch(exp._t)
    losses = []
    with torch.no_grad():
        for backend in ("kernel", "ref"):
            hcfg = dataclasses.replace(exp.head_cfg, backend=backend)
            loss_fn = gspmd.make_head_loss_fn(
                exp.model_cfg, hcfg, global_tokens=batch["labels"].numel(),
                head=make_head(exp.model_cfg, hcfg))
            loss, _ = loss_fn(exp.params, exp.head_state.params,
                              exp.head_state.aux, batch,
                              step=exp.opt_state.step)
            losses.append(float(loss))
    return tuple(losses)


def family_heads_check(torch, np, counters, exp, kern, gate_kernels,
                       park=False):
    """The rest of a family's surface at full width, each leg with every
    counter reset just before it and read just after (``FAM_WANT``):
    ``evaluate``, and top-5 of 64 queries exact and through the IVF index
    on the trained full-head experiment ``exp``, those two held against
    the ref backend on the same params (scores within IVF_TOL, ids equal
    but at near-ties); then each of the six heads trains one step at 2 x
    512 tokens (the knn head at the launcher's settings, MACH and CSoft at
    Table 2's R = 4 x V // 16 buckets, sampled drawing 10% of the
    classes) on a finite loss, and the next batch's loss on the kernel
    backend within ZOO_LOSS_RTOL of the ref backend's from the same
    state. With ``gate_kernels``, the sparse CE pair (the knn head's
    active set), ``dist_topk`` (the graph build over every row),
    ``stage1_topk`` and ``ivf_rerank`` (the retrieval) at this family's
    shapes against their plain versions (``kern``: the kernel modules).
    ``park``: after the retrieval legs the trained experiment's optimizer
    state is dropped and its params wait on the host, and each one-step
    experiment drops its moments after its step (a model of tens of GB
    cannot have two trained copies on the card). Returns ({path: launches}, {kernel: row},
    numbers)."""
    from repro_torch.configs.base import effective_vocab
    cfg = exp.model_cfg
    arch = _ARCH[cfg.family]
    v = effective_vocab(cfg)
    t0 = time.perf_counter()
    launches, rows = {}, {}

    def counted(path, fn):
        torch.cuda.synchronize()
        _reset(counters)
        out = fn()
        torch.cuda.synchronize()
        launches[path] = {k: n for k, n in _read(counters).items() if n}
        if launches[path] != FAM_WANT[path]:
            fail(f"{arch}: the {path} path launched {launches[path]}, not "
                 f"{FAM_WANT[path]} (PERF.md §6)")
        return out

    fam = cfg.family
    out = {"evaluate": counted(f"{fam}_evaluate", exp.evaluate)}
    idx = exp.ivf_index()                 # the fit is not the serve's
    got = {index: counted(path, lambda index=index: exp.serve(
        top_k=K, batch=ZOO_RET_B, return_scores=True, index=index))
        for path, index in ((f"{fam}_retrieval", None),
                            (f"{fam}_ivf_retrieval", "ivf"))}
    if not 0.0 <= out["evaluate"] <= 1.0:
        fail(f"{arch}: evaluate {out['evaluate']}")
    for index, (ids, scores) in got.items():
        if ids.shape != (ZOO_RET_B, K) or not ((ids >= 0) & (ids < v)).all() \
                or not np.all(np.isfinite(scores)) \
                or np.any(np.diff(scores, 1) > 0):
            fail(f"{arch}: top-{K} ({index or 'exact'}) ids {ids.shape} out "
                 f"of range, or scores not finite and descending")
    ref = _zoo_trainer("ref", arch=arch, batch=2, log_every=0)
    ref.load_params(exp.params)
    out["retrieval_vs_ref_score_max_abs_err"] = {
        index or "exact": _same_topk(
            np, *got[index], *ref.serve(top_k=K, batch=ZOO_RET_B,
                                        return_scores=True, index=index),
            f"{arch} top-{K} ({index or 'exact'}), kernel vs ref backend")
        for index in got}
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    out["ivf_top5_overlap"] = float(np.mean([
        len(set(a) & set(b)) / K for a, b in zip(got[None][0],
                                                 got["ivf"][0])]))

    if gate_kernels:
        rows.update(retrieval_kernel_rows(torch, np, kern["dc"], kern["ivf"],
                                          exp, idx, f"{arch} retrieval"))
    if park:
        from repro_torch.optim import tree_map
        exp.opt_state, exp._train_step = None, None
        exp.params = tree_map(lambda t: t.cpu(), exp.params)
        gc.collect()
        torch.cuda.empty_cache()
    heads = {"full": {}, "knn": ZOO_KNN,
             "selective": dict(softmax_impl="selective"),
             "mach": dict(softmax_impl="mach", mach_b=v // 16, mach_r=4),
             "sampled": dict(softmax_impl="sampled", sampled_n=v // 10),
             "csoft": dict(softmax_impl="csoft", csoft_b=v // 16, csoft_r=4)}
    for name, head in heads.items():
        one = _zoo_trainer("kernel", head=head, arch=arch, batch=2,
                           log_every=0)
        loss = counted(f"{fam}_{name}_step",
                       lambda: one.fit(1, lr=ZOO_LR)[0]["loss"])
        lk, lr = _head_loss_vs_ref(torch, one)
        if park:
            one.opt_state, one._train_step = None, None
            gc.collect()
            torch.cuda.empty_cache()
        rel = abs(lk - lr) / abs(lr)
        out[name] = {"loss": loss, "next_loss_kernel": lk,
                     "next_loss_ref": lr, "next_loss_rel": rel}
        if not (math.isfinite(loss) and rel <= ZOO_LOSS_RTOL):
            fail(f"{arch} with the {name} head: step loss {loss}; the next "
                 f"batch's loss, kernel {lk} vs ref {lr}: rel {rel:.3g} > "
                 f"{ZOO_LOSS_RTOL:g}")
        if gate_kernels and name == "knn":
            f, y, _ = _zoo_batch_features(torch, one, 10**5 + 1)
            rows["sparse_ce_forward"], rows["sparse_ce_backward"] = \
                zoo_sparse_rows(torch, kern["sp"], one, f, y, arch)
            rows["dist_topk"] = zoo_dist_topk_row(torch, kern["dk"], one,
                                                  arch)
            del f, y
        del one
        gc.collect()
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    log(f"{arch}: evaluate {out['evaluate']:.4f}; top-{K} of {ZOO_RET_B} "
        f"kernel vs ref {out['retrieval_vs_ref_score_max_abs_err']}, IVF "
        f"overlap {out['ivf_top5_overlap']:.3f}; launches {launches}; one "
        f"step with each head, and the next loss kernel vs ref "
        f"{ {k: r for k, r in out.items() if isinstance(r, dict)} }"
        f" ({out['s']:.1f} s)")
    return launches, rows, out


def _encdec_greedy(torch, exp, frames, prompt, gen, backend):
    """Greedy decoding of the encoder-decoder: the prefill of ``prompt``
    [b, P] over ``frames`` through ``lm.backbone`` (the decoder's self K/V
    and the cross K/V), the self K/V padded to P + ``gen`` slots, then
    ``gen - 1`` one-token ``lm.decode`` steps through the caches, each
    token the argmax of the tied head (``serve_logits_local``). Returns
    (tokens [b, gen], the last prefill position's features)."""
    from repro_torch.models import decoder, lm
    cfg = exp.model_cfg
    p = prompt.shape[1]
    window = p + gen
    with torch.no_grad():
        h, _, c = lm.backbone(exp.params, cfg, {"tokens": prompt,
                                                "frames": frames},
                              want_cache=True, backend=backend)
        pad = (0, 0, 0, 0, 0, window - p)
        caches = {"k": torch.nn.functional.pad(c["k"], pad),
                  "v": torch.nn.functional.pad(c["v"], pad),
                  "cross_k": c["cross_k"], "cross_v": c["cross_v"]}
        del c
        slots = decoder.init_cache_slots(
            cfg, window, prefill_positions=torch.arange(p, device=DEVICE))
        tok = _greedy_logits(torch, exp, h[:, -1])[0]
        out = [tok]
        for _ in range(gen - 1):
            hd, caches, slots = lm.decode(exp.params, cfg,
                                          {"token": tok[:, None]}, caches,
                                          slots, window=window,
                                          backend=backend)
            tok = _greedy_logits(torch, exp, hd[:, 0])[0]
            out.append(tok)
        toks = torch.stack(out, dim=1)
    return toks, h[:, -1]


def encdec_decode_phase(torch, np, counters, exp):
    """whisper-tiny's greedy decode of ZOO_GEN tokens through ``lm.decode``
    with the cross caches, on the trained experiment: WHISPER_B rows of
    the stream's frames and a decoder prompt of WHISPER_PROMPT tokens, on
    the kernel backend, every counter reset just before and read just
    after (``FAM_WANT``: the prefill's flash attention, 4 encoder layers
    non-causal and 4 decoder layers causal; the decode steps take the ref
    branches over the caches). Then in fp32 compute: the kernel and the
    ref backend's tokens equal, and a prefill of P tokens and one decode
    step against a prefill of P + 1 (features within FAM_CONT32_TOL, the
    greedy tokens equal). Prefill and decode times. Returns (path,
    launches, numbers)."""
    cfg = exp.model_cfg
    tag = f"{cfg.name} decode phase"
    t_phase = time.perf_counter()
    batch = exp._synthetic_batch(0, WHISPER_B)
    frames = batch["frames"]
    prompt = batch["tokens"][:, :WHISPER_PROMPT + 1]
    path = "encdec_decode"
    torch.cuda.synchronize()
    _reset(counters)
    t0 = time.perf_counter()
    toks, _ = _encdec_greedy(torch, exp, frames, prompt[:, :-1], ZOO_GEN,
                             "kernel")
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {k: v for k, v in _read(counters).items() if v}
    if launches != FAM_WANT[path]:
        fail(f"{tag}: the decode launched {launches}, not {FAM_WANT[path]}")
    if toks.shape != (WHISPER_B, ZOO_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{tag}: tokens {tuple(toks.shape)} out of shape or range")
    cfg0 = exp.model_cfg
    exp.model_cfg = dataclasses.replace(cfg0, dtype="float32")
    try:
        t32 = {b: _encdec_greedy(torch, exp, frames, prompt[:, :-1],
                                 ZOO_GEN, b)[0] for b in ("kernel", "ref")}
        # a prefill of P + 1 against a prefill of P and one decode step:
        # the decode's first step reads the prompt's last token
        _, h_full = _encdec_greedy(torch, exp, frames, prompt, 1, "kernel")
        from repro_torch.models import decoder, lm
        p = WHISPER_PROMPT
        with torch.no_grad():
            _, _, c = lm.backbone(exp.params, exp.model_cfg,
                                  {"tokens": prompt[:, :p], "frames": frames},
                                  want_cache=True, backend="kernel")
            pad = (0, 0, 0, 0, 0, 1)
            caches = {"k": torch.nn.functional.pad(c["k"], pad),
                      "v": torch.nn.functional.pad(c["v"], pad),
                      "cross_k": c["cross_k"], "cross_v": c["cross_v"]}
            slots = decoder.init_cache_slots(
                exp.model_cfg, p + 1,
                prefill_positions=torch.arange(p, device=DEVICE))
            h_step = lm.decode(exp.params, exp.model_cfg,
                               {"token": prompt[:, p:]}, caches, slots,
                               window=p + 1, backend="kernel")[0][:, 0]
        h_rel, lg_rel, n_eq, _ = _logit_gate(
            torch, np, exp, h_step, h_full, FAM_CONT32_TOL,
            f"{tag}: prefill + one decode step vs prefill of P + 1 (fp32)")
    finally:
        exp.model_cfg = cfg0
    if h_rel > FAM_CONT32_TOL or n_eq != WHISPER_B:
        fail(f"{tag}: prefill + one decode step vs prefill of P + 1: "
             f"features {h_rel:.3g} of max|h|, tokens equal at {n_eq}")
    same = int((t32["kernel"] == t32["ref"]).sum())
    if same != t32["ref"].numel():
        fail(f"{tag}: in fp32 compute the kernel backend's tokens differ "
             f"from the ref backend's at {t32['ref'].numel() - same}")
    reps = []
    for _ in range(FAM_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _encdec_greedy(torch, exp, frames, prompt[:, :-1], ZOO_GEN, "kernel")
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    out = {"launches": launches, "first_row": toks[0].tolist(),
           "decode_s_counted": decode_s, "decode_s_reps": reps,
           "tok_per_s": WHISPER_B * ZOO_GEN / statistics.median(reps),
           "continuation_fp32": {"h_rel": h_rel, "logit_rel": lg_rel,
                                 "tokens_equal": n_eq},
           "fp32_kernel_vs_ref_tokens_equal": same,
           "phase_s": time.perf_counter() - t_phase}
    log(f"{tag}: {WHISPER_B} rows of {cfg.enc_seq} frames, a prompt of "
        f"{WHISPER_PROMPT} tokens, {ZOO_GEN} greedy tokens: launches "
        f"{launches}; first row {toks[0].tolist()[:12]}...; the whole "
        f"decode {statistics.median(reps):.3f} s "
        f"({out['tok_per_s']:.0f} tok/s); fp32 kernel vs ref tokens equal "
        f"{same}/{t32['ref'].numel()}; prefill + one step vs the longer "
        f"prefill {h_rel:.3g} of max|h|; phase {out['phase_s']:.1f} s")
    return path, launches, out


def _ckpt_round_trip(torch, exp, root) -> dict:
    """A trained experiment saved, and restored into a fresh one: the
    snapshots bit-equal. Save and restore seconds by part, the file's
    bytes."""
    from repro_torch.resilience import tree_compare
    from repro_torch.telemetry import Tracer
    cfg = exp.model_cfg
    exp.ckpt_dir = str(root)
    tr = Tracer()
    exp.telemetry = tr
    t0 = time.perf_counter()
    fname = exp.save_checkpoint()
    save_s = time.perf_counter() - t0
    exp.telemetry = None
    fresh = _zoo_trainer("kernel", arch=_ARCH[cfg.family], log_every=0,
                         train=exp.train_cfg, ckpt_dir=str(root))
    ftr = Tracer()
    fresh.telemetry = ftr
    t0 = time.perf_counter()
    step = fresh.restore()
    restore_s = time.perf_counter() - t0
    cmp = tree_compare(fresh._snapshot(), exp._snapshot())
    out = {"step": step, "bitwise": cmp["bitwise"],
           "max_abs_diff": cmp["max_abs_diff"], "save_s": save_s,
           "save_fetch_s": tr.counters["train.checkpoint.fetch_s"],
           "restore_s": restore_s,
           "restore_read_s": ftr.counters["train.restore.read_s"],
           "restore_place_s": ftr.counters["train.restore.place_s"],
           "bytes": os.path.getsize(fname), "host_peak_rss_gb":
               _host_peak_gb()}
    log(f"checkpoint round trip of {cfg.name} at t={step}: bitwise "
        f"{cmp['bitwise']} ({len(cmp['mismatches'])} leaves differ); save "
        f"{save_s:.2f} s (to the host {out['save_fetch_s']:.2f} s), restore "
        f"{restore_s:.2f} s (read {out['restore_read_s']:.2f} s, onto the "
        f"card {out['restore_place_s']:.2f} s), {out['bytes']} bytes")
    if not cmp["bitwise"] or step != exp._t:
        fail(f"{cfg.name}: the restored snapshot differs from the saved one "
             f"at {cmp['mismatches'][:6]} (step {step})")
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_checkpoint_phase(torch, np, counters) -> tuple:
    """The zoo's checkpoints at SmolLM-135M's full width, the full and the
    knn head (16 x 512 tokens a step, a checkpoint every 2 steps): two
    uninterrupted ``fit(6)`` runs compared bit for bit set the class
    ``kill_and_recover`` is held to; the victim dies before step 5, a
    fresh experiment restores t = 4 and replays steps 4 and 5, every
    counter reset just before that leg and read after (``FAM_WANT``).
    Then the train launcher's ``--system zoo --ckpt-every 2`` and
    ``--resume``. Returns ({path: launches}, numbers)."""
    import contextlib
    import io
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train as train_launcher
    from repro_torch.resilience import kill_and_recover, tree_compare

    root = CKPT_DIR / "zoo"
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    launches, out = {}, {}
    try:
        for name, head in (("full", None), ("knn", ZOO_KNN)):
            def make(ckpt_dir, head=head):
                return _zoo_trainer("kernel", head=head, log_every=0,
                                    ckpt_dir=ckpt_dir,
                                    ckpt_every=ZOO_CKPT_EVERY)
            torch.cuda.reset_peak_memory_stats()
            ref = make(None)
            ref.fit(CKPT_TOTAL, lr=ZOO_LR)
            twin = make(None)
            twin.fit(CKPT_TOTAL, lr=ZOO_LR)
            det = tree_compare(twin._snapshot(), ref._snapshot())
            del twin
            gc.collect()
            torch.cuda.empty_cache()
            equivalence = "bitwise" if det["bitwise"] else "trajectory"
            rep = kill_and_recover(
                make, total_steps=CKPT_TOTAL, kill_at=CKPT_KILL,
                ckpt_dir=str(root / name), equivalence=equivalence,
                head=f"zoo/{name}", fit_kw={"lr": ZOO_LR}, reference=ref,
                before_resume=lambda: _reset(counters))
            torch.cuda.synchronize()
            path = f"zoo_checkpoint_{name}"
            launches[path] = {k: v for k, v in _read(counters).items() if v}
            replayed = [r["step"] for r in rep.resumed_history]
            res = {"two_runs_bitwise": det["bitwise"],
                   "two_runs_max_abs_diff": det["max_abs_diff"],
                   "equivalence": rep.equivalence, "ok": rep.ok,
                   "bitwise": rep.bitwise, "max_abs_diff": rep.max_abs_diff,
                   "loss_max_rel": rep.loss_max_rel,
                   "restored_step": rep.restored_step, "replayed": replayed,
                   "save_s": rep.save_s, "save_fetch_s": rep.save_fetch_s,
                   "restore_s": rep.restore_s,
                   "restore_read_s": rep.restore_read_s,
                   "restore_place_s": rep.restore_place_s,
                   "recovery_s": rep.recovery_s,
                   "ckpt_bytes": rep.ckpt_bytes,
                   "host_peak_rss_gb": _host_peak_gb(),
                   "card_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "resumed_launches": launches[path]}
            out[name] = res
            log(f"zoo checkpoint phase ({name}): two uninterrupted "
                f"fit({CKPT_TOTAL}) bitwise {det['bitwise']} (max |diff| "
                f"{det['max_abs_diff']:.3g}); {rep.summary()}; class "
                f"{rep.equivalence}; {res}")
            if not rep.ok or rep.restored_step != CKPT_KILL - 1 or \
                    replayed != list(range(CKPT_KILL - 1, CKPT_TOTAL)):
                fail(f"zoo kill and recover ({name}): {rep.summary()}, "
                     f"replayed {replayed}")
            if launches[path] != FAM_WANT[path]:
                fail(f"zoo kill and recover ({name}): the resumed leg "
                     f"launched {launches[path]}, not {FAM_WANT[path]}")
            del ref, rep
            gc.collect()
            torch.cuda.empty_cache()
        # the launcher: a checkpoint every 2 steps, then a resume from t=4
        d = str(root / "launcher")
        base = ["--system", "zoo", "--arch", "smollm_135m", "--batch", "4",
                "--seq", str(ZOO_TS), "--lr", str(ZOO_LR), "--ckpt-dir", d,
                "--ckpt-every", "2", "--device", DEVICE]
        texts = []
        for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train_launcher.main(base + extra)
            texts.append(buf.getvalue())
            out[f"launcher{len(texts)}_s"] = time.perf_counter() - t0
            if rc != 0:
                fail(f"train launcher --system zoo {extra} returned {rc}: "
                     f"{texts[-1][-500:]}")
            gc.collect()
            torch.cuda.empty_cache()
        if "[zoo] resumed at t=4: 2 steps to 6" not in texts[-1] or \
                ckpt.all_steps(d) != [2, 4, 6]:
            fail(f"the zoo launcher's resume: {texts[-1][-500:]}, files "
                 f"{ckpt.all_steps(d)}")
        log(f"zoo checkpoint phase: launcher --ckpt-every 2 --steps 4, then "
            f"--resume --steps 6: resumed at t=4, files "
            f"{ckpt.all_steps(d)} ({out['launcher1_s']:.1f} + "
            f"{out['launcher2_s']:.1f} s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"zoo checkpoint phase: {out['phase_s']:.1f} s")
    return launches, out


# ---------------------------------------------------------------------------
# remat, the dry run against the card, and the roofline of real steps
# ---------------------------------------------------------------------------

REMAT_STEPS = 5
REMAT_WANT = {"ce_forward": REMAT_STEPS, "ce_backward": REMAT_STEPS}
GRID_STEPS = 3
GRID_WANT = {"ce_forward": GRID_STEPS, "ce_backward": GRID_STEPS}
# a (1, 2) member's legs after its fit: each kernel of the path, launched
# on the member's shard (dist_topk once a hop of the ring build: 2)
GRID_LEGS = {"grid_training": GRID_WANT,
             "grid_evaluate": {"ce_forward": 1, "flash_attention": 30},
             "grid_retrieval": {"stage1_topk": 1},
             "grid_ivf_retrieval": {"ivf_rerank": 1},
             "grid_knn_training": {"sparse_ce_forward": 1,
                                   "sparse_ce_backward": 1, "dist_topk": 2}}
# a (1, 2) member's losses against one member's: the row-parallel MLP's
# two bf16 partial products are each rounded to bf16 before their psum
# (GSPMD's all-reduce of a bf16 dot's partials rounds so too), and the
# CE's sums run in another order; read up to 6.2e-6 on the card (PERF.md),
# while a step moves the loss by 3.5e-4 or more
GRID_LOSS_RTOL = 5e-5
# the norm of fit(3)'s whole change to the params (every step's update,
# the last one's too, which no loss shows), a (1, 2) member's against the
# (1, 1) grid's: a step skipped or a leaf's update wrong moves it by a
# third or more
GRID_UPDATE_RTOL = 2e-3
# the host-only dry runs: (arch, mesh), train_4k, remat full, FSDP
GRID_DRY = (("smollm_135m", "16x16"), ("qwen3_moe_30b_a3b", "16x16"),
            ("kimi_k2_1t_a32b", "16x16"), ("kimi_k2_1t_a32b", "2x16x16"),
            ("mamba2_370m", "16x16"), ("hymba_1_5b", "16x16"))
# the grid's families phase: the ssm, hybrid and encdec trunks at full
# width (mamba2 and hymba at FAM_TRAIN_DEPTH), fit(GRID_STEPS) in one
# micro-batch with remat full, on a (1, 1) grid here and a (1, 2) grid of
# two gloo processes
GRID_FAMILIES = ("mamba2_370m", "hymba_1_5b", ENCDEC)
# each (1, 2) member's token serving after its legs: rows x prompt, greedy
# tokens
GRID_FAM_SERVE = (64, ZOO_PROMPT, ZOO_GEN)
# each member's launches by leg, every counter reset around the leg: the
# CE pair once a step, evaluate's CE forward and a flash attention a layer
# (hymba's 16; whisper's 4 encoder and 4 decoder layers), a stage-1 top-k
# and an IVF rerank for the top-5 legs, the prefill's flash attention a
# layer (the decode steps and the greedy head take no kernel)
GRID_FAM_LEGS = {
    arch: {"fit": GRID_WANT,
           "evaluate": {"ce_forward": 1, **({"flash_attention": n}
                                             if n else {})},
           "top5": {"stage1_topk": 1}, "ivf_top5": {"ivf_rerank": 1},
           **({"serve": {"flash_attention": n} if n else {}}
              if arch != ENCDEC else {})}
    for arch, n in (("mamba2_370m", 0),
                    ("hymba_1_5b", FAM_TRAIN_DEPTH["hymba_1_5b"]),
                    (ENCDEC, 8))}
# each member's split leaves, against the layout of the (1, 2) grid:
# (path in the member's params, the member's shape)
GRID_FAM_SPLIT = {
    # in_proj's 4,384 fused columns: member 0 all of z and x[0:144]
    "mamba2_370m": (("blocks.0.ssm.in_proj", (1024, 2192)),
                    ("blocks.0.ssm.norm_scale", (1024,))),
    # in_proj (3,257 columns, odd) whole; norm_scale cuts head 12 in half
    "hymba_1_5b": (("blocks.0.ssm.in_proj", (1600, 3257)),
                   ("blocks.0.ssm.norm_scale", (800,))),
    ENCDEC: (("encdec.enc_blocks.0.mlp.wi", (384, 768)),
             ("encdec.dec_blocks.0.cross_attn.wq", (384, 3, 64))),
}
# a (1, 2) member's losses against the (1, 1) grid's: bf16 products of
# other shapes (a member's columns, heads and rows) rounded apart through
# the layers and two updates read up to 5.0e-5 at this phase's depths
# (1.43e-4 for mamba2 at its full 48 layers; PERF.md §6); a wrong layout
# moves the first loss by more (dropping the norm's psum moved it 9e-4 at
# the CPU tests' width; not read at the card's), and hymba's step moves its
# loss 1e-3. A mamba2 step at this lr moves its loss only 3e-5 to 1.4e-4,
# under this limit, so mamba2's steps are held by the update norm alone
GRID_FAM_LOSS_RTOL = 5e-4
# the norm of fit(3)'s whole change to the params against the (1, 1)
# grid's: read 2.75e-5 to 1.14e-4 at this phase's depths; a step skipped
# or a leaf's update wrong moves it by a third or more
GRID_FAM_UPDATE_RTOL = 2e-3
# the restore leg's experiment (a small checkpoint); on (1, 1) its vocab
# padded as on (1, 2): the reshard plans the vocab's rows over both model
# axes, which 51,865 rows do not divide, in the JAX package as here
GRID_FAM_RESTORE = ENCDEC
CARD_BYTES = 80e9
FAM_REMAT_STEPS = 3
# the paper's 100M classes over its cluster's rings; the global batch is
# FCCS's initial one (FCCSConfig.b0)
DRY_RINGS, DRY_BATCH = (64, 256), 4096


def _with_remat(exp, remat: str):
    """Point a zoo experiment's train step at ``remat`` (the step
    builder's ``par``; ``ZooExperiment`` has no knob of its own, as the JAX
    package's has none)."""
    from repro_torch.configs.base import ring_parallel_config
    from repro_torch.train import gspmd
    exp._ensure_opt()
    exp._train_step = gspmd.make_head_train_step(
        exp.model_cfg, exp.head_cfg, exp.train_cfg, exp.shape, head=exp.head,
        par=ring_parallel_config(1, remat))


def _timed_fit(torch, exp, steps):
    """``exp.fit(steps)``, the card synchronised before each step: (history,
    each step's ms, peak GB over the fit)."""
    marks = []

    def hook(t):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = exp.fit(steps, lr=ZOO_LR, step_hook=hook)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    return (hist, [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
            torch.cuda.max_memory_allocated() / 1e9)


def _roofline(wc, step_ms: float) -> dict:
    """A counted step's roofline terms (``roofline.counter``) against its
    measured time; the share is the roofline time (the largest term) over
    the measured one."""
    res = wc.result()
    terms = res["terms_s"]
    roof_ms = max(terms.values()) * 1e3
    return {"compute_ms": terms["compute"] * 1e3,
            "memory_ms": terms["memory"] * 1e3,
            "collective_ms": terms["collective"] * 1e3,
            "roofline_ms": roof_ms, "step_ms": step_ms,
            "roofline_share": roof_ms / step_ms,
            "flops_by_rate": res["counted"]["flops_by_rate"],
            "bytes": res["counted"]["bytes"], "ops": res["counted"]["ops"],
            "kernels": {k: v["calls"] for k, v in res["kernels"].items()}}


def remat_phase(torch, np, counters) -> dict:
    """SmolLM-135M ``fit(5)`` at 16 x 512 tokens in one micro-batch with
    ``remat`` none and full (each experiment from seed 0): the launches
    (the same both ways), the losses (bit-equal, or the first step where
    they part, reported), the peaks and the step times (median of steps
    2-5); one more step of each counted (``roofline.counter``) for the
    roofline. Then mamba2-370M and hymba-1.5B in one micro-batch with
    ``remat="full"`` (they take 4 without it): their peak and step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.roofline.counter import WorkCounter
    out, losses = {}, {}
    for remat in ("none", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        exp = _zoo_trainer("kernel", log_every=0,
                           train=TrainConfig(optimizer="sgd", micro_batch=1))
        _with_remat(exp, remat)
        _reset(counters)
        hist, ms, peak = _timed_fit(torch, exp, REMAT_STEPS)
        launches = {k: v for k, v in _read(counters).items() if v}
        if launches != REMAT_WANT:
            fail(f"SmolLM fit({REMAT_STEPS}) with remat {remat} launched "
                 f"{launches}, not {REMAT_WANT}")
        losses[remat] = [r["loss"] for r in hist]
        if not all(map(math.isfinite, losses[remat])):
            fail(f"SmolLM with remat {remat}: losses {losses[remat]}")
        step = statistics.median(ms[1:])
        batch = exp._batch(REMAT_STEPS)
        torch.cuda.synchronize()
        with WorkCounter() as wc:
            exp._train_step(exp.params, exp.head_state, exp.opt_state, batch,
                            ZOO_LR)
            torch.cuda.synchronize()
        roof = _roofline(wc, step)
        out[f"smollm_{remat}"] = dict(
            step_ms=step, step_ms_each=ms, peak_gb=peak,
            peak_over_base_gb=peak - base / 1e9, base_gb=base / 1e9,
            launches=launches, losses=losses[remat], roofline=roof)
        log(f"remat phase: SmolLM-135M remat {remat}: fit({REMAT_STEPS}) "
            f"launches {launches}, step {step:.1f} ms (steps {ms}), peak "
            f"{peak:.2f} GB ({peak - base / 1e9:.2f} over the "
            f"{base / 1e9:.2f} GB held before), losses {losses[remat]}; "
            f"counted step: compute {roof['compute_ms']:.2f} ms, memory "
            f"{roof['memory_ms']:.2f} ms, roofline share "
            f"{roof['roofline_share']:.3f} of {step:.1f} ms")
        del exp, batch
    parted = next((i for i, (a, b) in enumerate(zip(losses["none"],
                                                   losses["full"]))
                   if a != b), None)
    out["smollm_losses_bit_equal"] = parted is None
    out["smollm_losses_part_at_step"] = parted
    log(f"remat phase: SmolLM losses with and without remat "
        + ("bit-equal over every step" if parted is None else
           f"part at step {parted}: {losses['none'][parted]!r} vs "
           f"{losses['full'][parted]!r}"))
    want = {"ce_forward": FAM_REMAT_STEPS, "ce_backward": FAM_REMAT_STEPS}
    for arch in FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        exp = _zoo_trainer("kernel", arch=arch, log_every=0,
                           train=TrainConfig(optimizer="sgd", micro_batch=1))
        exp.data_fn = lambda t, b, exp=exp: exp._synthetic_batch(0, b)
        _with_remat(exp, "full")
        _reset(counters)
        hist, ms, peak = _timed_fit(torch, exp, FAM_REMAT_STEPS)
        launches = {k: v for k, v in _read(counters).items() if v}
        fam_losses = [r["loss"] for r in hist]
        if launches != want or not all(map(math.isfinite, fam_losses)):
            fail(f"{arch} with remat full in one micro-batch: launches "
                 f"{launches} (want {want}), losses {fam_losses}")
        step = statistics.median(ms[1:])
        out[f"{arch}_remat_full_n1"] = dict(step_ms=step, step_ms_each=ms,
                                            peak_gb=peak, losses=fam_losses)
        log(f"remat phase: {arch} remat full, one micro-batch of "
            f"{ZOO_TB} x {exp.seq}: step {step:.1f} ms (steps {ms}), peak "
            f"{peak:.2f} GB, losses {fam_losses}")
        del exp
    return out


def _paper_step(torch):
    """The paper system's full-head step at 1,020,250 x 512 on the kernel
    backend with SGD, the dry run's step, on a ring of one: (its state, the
    step, a batch of B = 256, the bytes allocated before the state). The
    state is ``hybrid.init_state``'s, what the experiment trains, without
    the experiment's data stream (whose class prototypes are another [V,
    D])."""
    from repro_torch.api.experiment import paper_model_config
    from repro_torch.api.heads import make_head
    from repro_torch.configs.base import HeadConfig, TrainConfig
    from repro_torch.train import hybrid
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    mcfg = paper_model_config("feats", V, D)
    hcfg, tcfg = HeadConfig(backend="kernel"), TrainConfig(optimizer="sgd")
    head = make_head(mcfg, hcfg)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    state = hybrid.init_state(g, mcfg, hcfg, tcfg, 1, device=DEVICE,
                              head=head)
    inputs = {"features": torch.randn((BTRAIN, D), generator=g,
                                      device=DEVICE),
              "labels": torch.randint(0, V, (BTRAIN,), generator=g,
                                      device=DEVICE, dtype=torch.int32)}
    step = hybrid.make_train_step(mcfg, hcfg, tcfg, head=head)
    return state, step, inputs, base


def dryrun_roofline_phase(torch, remat_rows) -> tuple:
    """The dry run against the card, and the roofline of real steps.
    (b) ``lower_paper_one`` of the paper's full step at 1,020,250 x 512 (B
    = 256, one member, kernel backend, SGD) and ``lower_one`` of SmolLM's
    step at 16 x 512 (remat none and full) on the meta device: their
    argument bytes and predicted peak beside the real step's bytes and
    ``torch.cuda.max_memory_allocated``, each over what was allocated
    before; then ``lower_paper_one(classes=10**8)`` on rings of 64 and 256
    at D 512, B 4,096: one member's bytes. (c) one real step of the paper
    head counted on the card (the kernels charged by their cost
    functions): its compute and memory terms against its measured time.
    Returns (the dry run's rows, the roofline rows)."""
    from repro_torch.configs.base import HeadConfig
    from repro_torch.launch import dryrun
    from repro_torch.roofline.counter import WorkCounter
    dry, roof = {}, {}
    state, step, inputs, base = _paper_step(torch)
    args_gb = (torch.cuda.memory_allocated() - base) / 1e9
    state, _, _ = step(state, inputs, 0.1)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, loss, _ = step(state, inputs, 0.1)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if not math.isfinite(float(loss)):
        fail(f"the paper step's loss {float(loss)}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = step(state, inputs, 0.1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with WorkCounter() as wc:
        state, _, _ = step(state, inputs, 0.1)
        torch.cuda.synchronize()
    roof["paper_full_b256"] = _roofline(wc, statistics.median(times))
    del state, step, inputs
    gc.collect()
    torch.cuda.empty_cache()
    rec = dryrun.lower_paper_one(classes=V, feat_dim=D, batch=BTRAIN,
                                 n_dev=1, backend="kernel")
    if rec["ledger_divergence"]:
        fail(f"the paper dry run diverges from the ledger: "
             f"{rec['ledger_divergence']}")
    dry["paper_full_b256"] = dict(
        argument_gb=rec["memory"]["argument_bytes"] / 1e9,
        predicted_peak_gb=rec["memory"]["peak_bytes"] / 1e9,
        real_argument_gb=args_gb, real_peak_gb=peak_gb,
        lower_s=rec["lower_s"])
    r = roof["paper_full_b256"]
    log(f"dry run: paper full step 1,020,250 x 512, B {BTRAIN}: arguments "
        f"{dry['paper_full_b256']['argument_gb']:.3f} GB predicted, "
        f"{args_gb:.3f} on the card; peak "
        f"{dry['paper_full_b256']['predicted_peak_gb']:.3f} GB predicted, "
        f"{peak_gb:.3f} GB measured (over the bytes held before); roofline: "
        f"compute {r['compute_ms']:.3f} ms, memory {r['memory_ms']:.3f} ms, "
        f"collective 0 (a ring of one), the step {r['step_ms']:.2f} ms: "
        f"share {r['roofline_share']:.3f}; kernels {r['kernels']}")
    for remat in ("none", "full"):
        rec = dryrun.lower_one("smollm_135m", "train_4k", n_dev=1,
                               remat=remat, batch=ZOO_TB, seq=ZOO_TS,
                               head_cfg=HeadConfig(backend="kernel"))
        real = remat_rows[f"smollm_{remat}"]
        dry[f"smollm_{remat}"] = dict(
            argument_gb=rec["memory"]["argument_bytes"] / 1e9,
            predicted_peak_gb=rec["memory"]["peak_bytes"] / 1e9,
            real_peak_gb=real["peak_over_base_gb"],
            predicted_flops=rec["counted"]["flops"],
            lower_s=rec["lower_s"])
        roof[f"smollm_{remat}"] = real["roofline"]
        r = real["roofline"]
        log(f"dry run: SmolLM step 16 x 512, remat {remat}: arguments "
            f"{dry[f'smollm_{remat}']['argument_gb']:.3f} GB, peak "
            f"{dry[f'smollm_{remat}']['predicted_peak_gb']:.3f} GB "
            f"predicted, {real['peak_over_base_gb']:.3f} GB measured; "
            f"roofline: compute {r['compute_ms']:.2f} ms, memory "
            f"{r['memory_ms']:.2f} ms, the step {r['step_ms']:.1f} ms: "
            f"share {r['roofline_share']:.3f}")
    for n in DRY_RINGS:
        rec = dryrun.lower_paper_one(classes=10**8, feat_dim=D,
                                     batch=DRY_BATCH, n_dev=n,
                                     backend="kernel")
        if rec["ledger_divergence"]:
            fail(f"the 10^8 dry run on {n} diverges from the ledger: "
                 f"{rec['ledger_divergence']}")
        dry[f"paper_1e8_ring{n}"] = dict(
            argument_gb=rec["memory"]["argument_bytes"] / 1e9,
            predicted_peak_gb=rec["memory"]["peak_bytes"] / 1e9,
            collective_bytes=rec["collectives"]["total_bytes"],
            counted_flops=rec["counted"]["flops"], lower_s=rec["lower_s"])
        log(f"dry run: paper step at 10^8 classes x {D} on a ring of {n}, "
            f"B {DRY_BATCH}: one member's arguments "
            f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB, peak "
            f"{rec['memory']['peak_bytes'] / 1e9:.3f} GB, collectives "
            f"{rec['collectives']['total_bytes']:.0f} B a step, "
            f"{rec['lower_s']:.2f} s on the host")
    return dry, roof


_GRID_DRY_CODE = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch import dryrun
for arch, mesh, kw in json.loads(sys.argv[1]):
    lower = dryrun.lower_one if "n_layers" in kw else dryrun.lower_deep
    r = lower(arch, "train_4k", mesh=mesh, **kw)
    print(json.dumps({"arch": arch, "mesh": mesh, "kw": kw,
                      "member_rows": r["member_rows"],
                      "n_micro": r["n_micro"], "n_layers": r["n_layers"],
                      "memory": r["memory"], "lower_s": r["lower_s"],
                      "collectives": r["collectives"]}), flush=True)
"""


def start_grid_dryruns():
    """The grid phases' host-only dry runs (the (1, 2) predictions at the
    grid fits' shapes: SmolLM's, then ``GRID_FAMILIES``'; then
    ``GRID_DRY``), one after another in one subprocess on the host's meta
    device, beside the card's phases."""
    runs = [(arch, mesh, {"remat": "full"}) for arch, mesh in GRID_DRY]
    runs[0:0] = [("smollm_135m", "1x2",
                  {"remat": "none", "batch": ZOO_TB, "seq": ZOO_TS,
                   "backend": "kernel"})] + [
        (arch, "1x2", {"remat": "full", "batch": ZOO_TB,
                       "seq": FAM_SEQ.get(arch, ZOO_TS), "backend": "kernel",
                       **({"n_layers": FAM_TRAIN_DEPTH[arch]}
                          if arch in FAM_TRAIN_DEPTH else {})})
        for arch in GRID_FAMILIES]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", _GRID_DRY_CODE, json.dumps(runs)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _host_params(exp) -> list:
    """A host copy of this member's params, before a fit."""
    from repro_torch.optim import tree_leaves
    return [t.detach().to("cpu", copy=True) for t in tree_leaves(exp.params)]


def _update_norm(exp, before: list) -> float:
    """The norm of the whole model's change since ``before``
    (``_host_params``), from this member's slices: the leaves split over
    ``model`` summed over it, the replicated ones once."""
    import torch
    from repro_torch import dist
    from repro_torch.optim import tree_leaves
    from repro_torch.train import gspmd
    split = rep = 0.0
    for p, q, spec in zip(tree_leaves(exp.params), before,
                          gspmd.leaf_specs(exp.specs, ())):
        sq = float((p.detach().double() - q.to(p.device).double())
                   .pow(2).sum())
        if "model" in dist.spec_axes(spec):
            split += sq
        else:
            rep += sq
    split = float(dist.psum(torch.tensor(split, dtype=torch.float64,
                                         device=exp.device)))
    return math.sqrt(split + rep)


def _grid_member():
    """One member of the (1, 2) grid (``dist.spawn_grid``): SmolLM-135M at
    full width, ``fit(GRID_STEPS)`` from seed 0 (its peak), then on the
    trained experiment ``evaluate``, exact and IVF top-5 of 64 queries, and
    a knn experiment's ``fit(1)``; every kernel counter reset just before
    each leg and read just after (``GRID_LEGS``)."""
    import torch
    from repro_torch import dist
    from repro_torch.kernels import ce_softmax as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ivf_rerank as ivf
    from repro_torch.kernels import knn_dist_topk as dk
    from repro_torch.kernels import sparse_ce as sp
    from repro_torch.kernels import topk_dc as dc
    from repro_torch.optim import tree_leaves
    counters = {"ce_forward": (ce, "LAUNCHES"),
                "ce_backward": (ce, "BWD_LAUNCHES"),
                "sparse_ce_forward": (sp, "LAUNCHES"),
                "sparse_ce_backward": (sp, "BWD_LAUNCHES"),
                "dist_topk": (dk, "LAUNCHES"), "stage1_topk": (dc, "LAUNCHES"),
                "ivf_rerank": (ivf, "LAUNCHES"),
                "flash_attention": (fa, "LAUNCHES")}
    legs = {}

    def leg(name, fn):
        torch.cuda.synchronize()
        _reset(counters)
        out = fn()
        torch.cuda.synchronize()
        legs[name] = {k: v for k, v in _read(counters).items() if v}
        return out

    exp = _zoo_trainer("kernel", log_every=0)
    before = _host_params(exp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = leg("grid_training", lambda: exp.fit(GRID_STEPS, lr=ZOO_LR))
    peak = torch.cuda.max_memory_allocated() / 1e9
    update = _update_norm(exp, before)
    del before
    acc = leg("grid_evaluate", exp.evaluate)
    ids = leg("grid_retrieval", lambda: exp.serve(top_k=5, batch=64))
    exp.ivf_index()
    ivf_ids = leg("grid_ivf_retrieval",
                  lambda: exp.serve(top_k=5, batch=64, index="ivf"))
    param_gb = sum(t.numel() * 4 for t in tree_leaves(exp.params)) / 1e9
    split = {"embed": tuple(exp.params.embed.table.shape),
             "mlp": tuple(exp.params.blocks[0].mlp.wo.shape),
             "attn": tuple(exp.params.blocks[0].attn.wq.shape)}
    del exp
    knn = _zoo_trainer("kernel", head=ZOO_KNN, log_every=0)
    knn_hist = leg("grid_knn_training", lambda: knn.fit(1, lr=ZOO_LR))
    return {"index": (dist.rank("data"), dist.rank("model")),
            "losses": [r["loss"] for r in hist], "update": update,
            "legs": legs,
            "peak_gb": peak, "param_gb": param_gb, "split": split,
            "eval": acc, "ids": ids[:4].tolist(),
            "ivf_ids": ivf_ids[:4].tolist(),
            "knn": {k: knn_hist[0][k] for k in ("loss", "label_recall")}}


def grid_phase(torch, np, counters, dry_proc) -> tuple:
    """Phase 28 (module docstring). Returns (the launches by path, the
    phase's rows)."""
    from repro_torch import dist
    out, launches = {}, {}
    runs = {}
    for name in ("ring", "grid_1x1"):
        gc.collect()
        torch.cuda.empty_cache()
        if name == "grid_1x1":
            dist.grid(1, 1)
        try:
            exp = _zoo_trainer("kernel", log_every=0)
            if (exp.specs is None) != (name == "ring"):
                fail(f"grid phase: the {name} experiment's layout is not "
                     f"the {name}'s")
            before = _host_params(exp) if name == "grid_1x1" else None
            _reset(counters)
            hist = exp.fit(GRID_STEPS, lr=ZOO_LR)
            torch.cuda.synchronize()
            launches[f"grid_{name}" if name == "ring" else name] = got = {
                k: v for k, v in _read(counters).items() if v}
            if before is not None:
                update = _update_norm(exp, before)
                del before
        finally:
            dist.release_grid()
        if got != GRID_WANT:
            fail(f"grid phase: the {name} fit({GRID_STEPS}) launched {got}, "
                 f"not {GRID_WANT}")
        runs[name] = [r["loss"] for r in hist]
        del exp
    if runs["ring"] != runs["grid_1x1"]:
        fail(f"grid phase: the (1, 1) grid's losses {runs['grid_1x1']} are "
             f"not the ring's {runs['ring']} bit for bit")
    out["ring_losses"] = runs["ring"]
    out["grid_1x1_losses_bit_equal"] = True
    out["grid_1x1_update"] = update
    log(f"grid phase: SmolLM-135M fit({GRID_STEPS}) on the ring and on a "
        f"(1, 1) grid: losses {runs['ring']} bit-equal, launches "
        f"{launches['grid_1x1']} each")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    members = dist.spawn_grid(_grid_member, 1, 2)
    out["grid_1x2_s"] = time.perf_counter() - t0
    ref = np.asarray(runs["grid_1x1"])
    for m in members:
        rel = np.abs(np.asarray(m["losses"]) - ref) / np.abs(ref)
        m["loss_rel_vs_1x1"] = rel.tolist()
        m["update_rel_vs_1x1"] = urel = abs(m["update"] - update) / update
        for name, want in GRID_LEGS.items():
            launches[f"{name}_member{m['index'][1]}"] = m["legs"][name]
        if m["legs"] != GRID_LEGS:
            fail(f"grid phase: (1, 2) member {m['index']} launched "
                 f"{m['legs']}, not {GRID_LEGS}")
        if not (math.isfinite(m["knn"]["loss"]) and 0 <= m["eval"] <= 1):
            fail(f"grid phase: (1, 2) member {m['index']}: knn loss "
                 f"{m['knn']}, evaluate {m['eval']}")
        if not rel.max() <= GRID_LOSS_RTOL:
            fail(f"grid phase: (1, 2) member {m['index']}'s losses "
                 f"{m['losses']} are {rel.max():.2e} from the (1, 1) "
                 f"grid's {runs['grid_1x1']}")
        if not urel <= GRID_UPDATE_RTOL:
            fail(f"grid phase: (1, 2) member {m['index']}'s update norm "
                 f"{m['update']} is {urel:.2e} from the (1, 1) grid's "
                 f"{update}")
    for key in ("losses", "eval", "ids", "ivf_ids", "knn"):
        if members[0][key] != members[1][key]:
            fail(f"grid phase: the (1, 2) members' {key} differ: "
                 f"{members[0][key]} / {members[1][key]}")
    if members[0]["split"]["mlp"][0] * 2 != 1536 or \
            members[0]["split"]["embed"][0] * 2 != 49152:
        fail(f"grid phase: a (1, 2) member's MLP / vocab are not split in "
             f"two: {members[0]['split']}")
    out["grid_1x2"] = members
    try:
        stdout, stderr = dry_proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        dry_proc.kill()
        dry_proc.communicate()
        fail("grid phase: the host-only dry runs took over 600 s more")
    if dry_proc.returncode:
        fail(f"grid phase: the host-only dry runs failed:\n{stderr[-3000:]}")
    dry = [json.loads(line) for line in stdout.splitlines()
           if line.startswith("{")]
    n_pred = 1 + len(GRID_FAMILIES)
    if len(dry) != len(GRID_DRY) + n_pred:
        fail(f"grid phase: {len(dry)} dry-run records, not "
             f"{len(GRID_DRY) + n_pred}")
    pred = dry[0]["memory"]
    for m in members:
        log(f"grid phase: (1, 2) member {m['index']}: losses {m['losses']} "
            f"(relative to the (1, 1) grid's {m['loss_rel_vs_1x1']}), "
            f"update norm {m['update']} (the (1, 1) grid's {update}, "
            f"relative {m['update_rel_vs_1x1']:.2e}), "
            f"launches by leg {m['legs']}, evaluate {m['eval']:.4f}, knn "
            f"{m['knn']}, its params {m['param_gb']:.3f} GB "
            f"(split {m['split']}), peak {m['peak_gb']:.2f} GB against the "
            f"dry run's {pred['peak_bytes'] / 1e9:.2f} GB (arguments "
            f"{pred['argument_bytes'] / 1e9:.3f} GB)")
    out["dryrun_1x2_member"] = dry[0]
    out["dryrun_1x2_families"] = dry[1:n_pred]
    out["dryruns"] = dry[n_pred:]
    for rec in dry[n_pred:]:
        mem = rec["memory"]
        rec["fits_card"] = mem["peak_bytes"] <= CARD_BYTES
        log(f"grid phase: dry run {rec['arch']} train_4k on {rec['mesh']} "
            f"(member (0, 0); FSDP, remat full; {rec['member_rows']} rows "
            f"in {rec['n_micro']} micro-batches, {rec['n_layers']} layers "
            f"from 1 and 2): arguments {mem['argument_bytes'] / 1e9:.2f} "
            f"GB, peak {mem['peak_bytes'] / 1e9:.2f} GB, fits "
            f"{CARD_BYTES / 1e9:.0f} GB: {rec['fits_card']} (lowered in "
            f"{rec['lower_s']:.1f} s)")
    return launches, out


def _grid_fam_par(n_model: int):
    """The families' grid layout: (1, n_model), remat full."""
    from repro_torch.configs.base import ParallelConfig
    return ParallelConfig(mesh_shape=(1, n_model),
                          axis_names=("data", "model"), remat="full")


def _grid_fam_trainer(arch: str, model_size: int, **kw):
    """``arch`` at full width (at FAM_TRAIN_DEPTH where it has one) on
    this process's grid (its model axis ``model_size``), one micro-batch
    of ``ZOO_TB`` rows a step with remat full, the full head on the kernel
    backend; ``kw`` go to the experiment."""
    from repro_torch.configs.base import TrainConfig
    with _at_depth(FAM_TRAIN_DEPTH.get(arch)):
        return _zoo_trainer("kernel", arch=arch, log_every=0,
                            train=TrainConfig(optimizer="sgd",
                                              micro_batch=1),
                            par=_grid_fam_par(model_size), **kw)


def _leaf(params, path: str):
    node = params
    for key in path.split("."):
        node = node[int(key)] if key.isdigit() else node[key]
    return node


def _param_digest(tree) -> str:
    """sha1 over every leaf's bytes of a param tree (host copies, in
    ``tree_leaves`` order)."""
    import hashlib
    from repro_torch.optim import tree_leaves
    h = hashlib.sha1()
    for t in tree_leaves(tree):
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _blocks_as_specs(exp) -> bool:
    """Whether every leaf this member holds is its ``param_pspecs`` block
    of the whole model's leaf (the whole one from the meta device)."""
    from repro_torch import dist
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves
    from repro_torch.train import gspmd
    whole = tree_leaves(lm.abstract_model(exp.model_cfg))
    mine = tree_leaves(exp.params)
    specs = gspmd.leaf_specs(exp.specs, ())
    if not len(whole) == len(mine) == len(specs):
        return False
    n = dist.world_size()
    for w, p, spec in zip(whole, mine, specs):
        entries = tuple(spec) + (None,) * (w.dim() - len(spec))
        want = tuple(d // (n if e == "model" else 1)
                     for d, e in zip(w.shape, entries))
        if tuple(p.shape) != want:
            return False
    return True


def _grid_family_member(ckpt_dir: str):
    """One member of the families' (1, 2) grid (``dist.spawn_grid``): each
    of ``GRID_FAMILIES`` at full width in turn, ``fit(GRID_STEPS)`` from
    seed 0 (its peak and the norm of its whole update), then
    ``evaluate``, exact and IVF top-5 of ``ZOO_RET_B`` queries and, for the
    ssm and hybrid trunks, a prefill and greedy tokens (``GRID_FAM_SERVE``);
    every kernel counter reset just before each leg and read just after
    (``GRID_FAM_LEGS``). ``GRID_FAM_RESTORE`` then saves its state under
    ``ckpt_dir`` (member 0 writes), gives the digest of its gathered
    params, and takes one more step."""
    import torch
    from repro_torch import dist
    from repro_torch.kernels import ce_softmax as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ivf_rerank as ivf
    from repro_torch.kernels import knn_dist_topk as dk
    from repro_torch.kernels import sparse_ce as sp
    from repro_torch.kernels import topk_dc as dc
    from repro_torch.models import lm
    counters = {"ce_forward": (ce, "LAUNCHES"),
                "ce_backward": (ce, "BWD_LAUNCHES"),
                "sparse_ce_forward": (sp, "LAUNCHES"),
                "sparse_ce_backward": (sp, "BWD_LAUNCHES"),
                "dist_topk": (dk, "LAUNCHES"), "stage1_topk": (dc, "LAUNCHES"),
                "ivf_rerank": (ivf, "LAUNCHES"),
                "flash_attention": (fa, "LAUNCHES")}
    out = {"index": (dist.rank("data"), dist.rank("model"))}
    for arch in GRID_FAMILIES:
        legs, secs = {}, {}

        def leg(name, fn):
            torch.cuda.synchronize()
            _reset(counters)
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            legs[name] = {k: v for k, v in _read(counters).items() if v}
            log(f"grid families phase: {arch} (1, 2) member "
                f"{out['index'][1]}: {name} {secs[name]:.1f} s")
            return res

        gc.collect()
        torch.cuda.empty_cache()
        exp = _grid_fam_trainer(arch, 2)
        before = _host_params(exp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hist = leg("fit", lambda: exp.fit(GRID_STEPS, lr=ZOO_LR))
        peak = torch.cuda.max_memory_allocated() / 1e9
        update = _update_norm(exp, before)
        del before
        row = {"losses": [r["loss"] for r in hist], "update": update,
               "peak_gb": peak, "blocks_ok": _blocks_as_specs(exp),
               "split": {path: tuple(_leaf(exp.params, path).shape)
                         for path, _ in GRID_FAM_SPLIT[arch]}}
        row["eval"] = leg("evaluate", exp.evaluate)
        row["ids"] = leg("top5", lambda: exp.serve(
            top_k=5, batch=ZOO_RET_B))[:4].tolist()
        exp.ivf_index()
        row["ivf_ids"] = leg("ivf_top5", lambda: exp.serve(
            top_k=5, batch=ZOO_RET_B, index="ivf"))[:4].tolist()
        if arch != ENCDEC:
            b, prompt, gen = GRID_FAM_SERVE
            torch.cuda.reset_peak_memory_stats()
            toks = leg("serve", lambda: exp.serve(prompt_len=prompt,
                                                  gen=gen, batch=b))
            row["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            row["tokens"] = toks[:2].tolist()
            row["tokens_in_range"] = bool(
                ((toks >= 0) & (toks < exp.model_cfg.vocab_size)).all())
        if arch == GRID_FAM_RESTORE:
            exp.ckpt_dir = ckpt_dir
            exp.save_checkpoint()
            row["saved_digest"] = _param_digest(lm.params_tree(
                lm.gather_params(exp.params, exp.specs)))
            exp.ckpt_dir = None
            row["next_loss"] = exp.fit(1, lr=ZOO_LR)[-1]["loss"]
            log(f"grid families phase: {arch} (1, 2) member "
                f"{out['index'][1]}: saved, digested, one more step")
        row["legs"], row["leg_s"] = legs, secs
        out[arch] = row
        del exp
    return out


def grid_families_phase(torch, np, counters, preds) -> tuple:
    """Phase 29 (module docstring): the ssm, hybrid and encdec trunks on a
    (1, 1) grid here and a (1, 2) grid of two gloo processes on this card.
    ``preds``: the dry run's (1, 2) records of ``GRID_FAMILIES``. Returns
    (the launches by path, the phase's rows)."""
    import shutil

    from repro_torch import dist
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    out, launches, ref = {}, {}, {}
    for arch in GRID_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        dist.grid(1, 1)
        try:
            # the vocab padded to 2 as on (1, 2): the same draws, the same
            # model (hymba's 32,001 and whisper's 51,865 are odd)
            exp = _grid_fam_trainer(arch, 1, n_model=2)
            before = _host_params(exp)
            _reset(counters)
            t0 = time.perf_counter()
            hist = exp.fit(GRID_STEPS, lr=ZOO_LR)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches[f"grid_fam_{arch}_1x1"] = got = {
                k: v for k, v in _read(counters).items() if v}
            update = _update_norm(exp, before)
            del before, exp
        finally:
            dist.release_grid()
        losses = [r["loss"] for r in hist]
        if got != GRID_WANT or not all(map(math.isfinite, losses)):
            fail(f"grid families phase: {arch} fit({GRID_STEPS}) on (1, 1) "
                 f"launched {got} (want {GRID_WANT}), losses {losses}")
        ref[arch] = {"losses": losses, "update": update, "fit_s": fit_s}
        log(f"grid families phase: {arch} on a (1, 1) grid, fit("
            f"{GRID_STEPS}) in {fit_s:.1f} s: losses {losses}, update norm "
            f"{update}")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = CKPT_DIR / "grid_families"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        members = dist.spawn_grid(_grid_family_member, 1, 2, str(ckpt))
        out["grid_1x2_s"] = time.perf_counter() - t0
        for arch, pred in zip(GRID_FAMILIES, preds):
            want_split = dict(GRID_FAM_SPLIT[arch])
            r = ref[arch]
            for m in members:
                row = m[arch]
                tag = f"grid families phase: {arch} (1, 2) member {m['index']}"
                serving = (f"(serving {row['serve_peak_gb']:.2f} GB) "
                           if "serve_peak_gb" in row else "")
                rel = np.abs(np.asarray(row["losses"]) - r["losses"]) \
                    / np.abs(r["losses"])
                row["loss_rel_vs_1x1"] = rel.tolist()
                row["update_rel_vs_1x1"] = urel = abs(
                    row["update"] - r["update"]) / r["update"]
                for name, got in row["legs"].items():
                    launches[f"grid_fam_{arch}_{name}_member"
                             f"{m['index'][1]}"] = got
                if row["legs"] != GRID_FAM_LEGS[arch]:
                    fail(f"{tag} launched {row['legs']}, not "
                         f"{GRID_FAM_LEGS[arch]}")
                if not row["blocks_ok"] or row["split"] != want_split:
                    fail(f"{tag}: its leaves are not their param_pspecs "
                         f"blocks ({row['split']}, want {want_split})")
                if not rel.max() <= GRID_FAM_LOSS_RTOL:
                    fail(f"{tag}: losses {row['losses']} are {rel.max():.2e} "
                         f"from the (1, 1) grid's {r['losses']}")
                if not urel <= GRID_FAM_UPDATE_RTOL:
                    fail(f"{tag}: update norm {row['update']} is "
                         f"{urel:.2e} from the (1, 1) grid's {r['update']}")
                if not (0 <= row["eval"] <= 1
                        and row.get("tokens_in_range", True)):
                    fail(f"{tag}: evaluate {row['eval']}, tokens out of "
                         f"range")
                log(f"{tag}: losses {row['losses']} (relative to the "
                    f"(1, 1) grid's {row['loss_rel_vs_1x1']}), update norm "
                    f"{row['update']} (relative {urel:.2e}), launches by "
                    f"leg {row['legs']}, leg seconds "
                    f"{ {k: round(v, 2) for k, v in row['leg_s'].items()} }, "
                    f"split {row['split']}, peak {row['peak_gb']:.2f} GB "
                    f"{serving}"
                    f"against the dry run's "
                    f"{pred['memory']['peak_bytes'] / 1e9:.2f} GB "
                    f"(arguments {pred['memory']['argument_bytes'] / 1e9:.3f}"
                    f" GB), evaluate {row['eval']:.4f}")
            for key in ("losses", "eval", "ids", "ivf_ids", "tokens",
                        "update"):
                a, b = members[0][arch].get(key), members[1][arch].get(key)
                if key == "update":
                    if abs(a - b) > 1e-9 * abs(a):
                        fail(f"grid families phase: {arch}'s members' "
                             f"update norms differ: {a} / {b}")
                elif a != b:
                    fail(f"grid families phase: {arch}'s (1, 2) members' "
                         f"{key} differ: {a} / {b}")
            out[arch] = {"ref_1x1": r, "members": [m[arch] for m in members],
                         "dryrun_1x2": pred}
        # the restore leg: the (1, 2) save on a (1, 1) grid
        saved = members[0][GRID_FAM_RESTORE]
        gc.collect()
        torch.cuda.empty_cache()
        dist.grid(1, 1)
        try:
            exp = _grid_fam_trainer(GRID_FAM_RESTORE, 1, n_model=2,
                                    ckpt_dir=str(ckpt))
            t0 = time.perf_counter()
            step = exp.restore(reshard=True)
            restore_s = time.perf_counter() - t0
            digest = _param_digest(lm.params_tree(exp.params))
            exp.ckpt_dir = None
            _reset(counters)
            next_loss = exp.fit(1, lr=ZOO_LR)[-1]["loss"]
            launches["grid_fam_restore_1x1"] = {
                k: v for k, v in _read(counters).items() if v}
            reshard = exp.last_reshard
            del exp
        finally:
            dist.release_grid()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rel = abs(next_loss - saved["next_loss"]) / abs(saved["next_loss"])
    out["restore"] = {"step": step, "bit_equal": digest ==
                      saved["saved_digest"], "next_loss": next_loss,
                      "member_next_loss": saved["next_loss"],
                      "next_loss_rel": rel, "restore_s": restore_s,
                      "reshard": None if reshard is None else
                      (reshard["src"].describe(), reshard["dst"].describe())}
    log(f"grid families phase: the (1, 2) save of {GRID_FAM_RESTORE} at "
        f"step {step} "
        f"restored on a (1, 1) grid in {restore_s:.1f} s "
        f"({out['restore']['reshard']}): params bit-equal to the gathered "
        f"save: {out['restore']['bit_equal']}; the next step's loss "
        f"{next_loss} against the member's {saved['next_loss']} (relative "
        f"{rel:.2e})")
    if not out["restore"]["bit_equal"] or step != GRID_STEPS or \
            reshard is None:
        fail(f"grid families phase: the restore on (1, 1): step {step}, "
             f"reshard {out['restore']['reshard']}, params bit-equal "
             f"{out['restore']['bit_equal']}")
    if not rel <= GRID_FAM_LOSS_RTOL:
        fail(f"grid families phase: the restored step's loss {next_loss} is "
             f"{rel:.2e} from the member's {saved['next_loss']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"grid families phase: {out['phase_s']:.1f} s (the (1, 2) grid "
        f"{out['grid_1x2_s']:.1f} s)")
    return launches, out


# ---------------------------------------------------------------------------
# the paper system on a ring of two processes (phase 30)
# ---------------------------------------------------------------------------

# two gloo processes share the card (NCCL refuses two ranks on one card;
# gloo stages the collectives through pinned host memory), each holding
# 510,125 of the 1,020,250 x 512 rows
RING_N = 2
# a step's global batch of 256 in RING_MICRO micro-batches of RING_HW over
# the ring: 64 rows a member a micro-batch (FCCS held at 256)
RING_HW, RING_MICRO = 128, 2
RING_STEPS, RING_CNN_STEPS, RING_KNN_STEPS = 4, 3, 2
# every step's loss, the ring of two against the ring of one from the same
# seed: the z and corr psums over two shards add in another order (fp32
# rounding, ~1e-7), and LARS takes each member's trust ratio off its own
# shard's norms, not the whole W's; the CPU at 65,536 x 512 read <= 1.7e-7
# over the same four steps (PERF.md §6)
RING_LOSS_RTOL = 1e-5
_RING_FULL = {"ce_forward": RING_MICRO * RING_STEPS,
              "ce_backward": RING_MICRO * RING_STEPS}
_RING_CNN = {"ce_forward": RING_MICRO * RING_CNN_STEPS,
             "ce_backward": RING_MICRO * RING_CNN_STEPS,
             "stage1_topk": RES_DGC_GROUPS * RING_CNN_STEPS}
# the launches each member must make on each leg: the knn experiment's
# graph build (one dist_topk a hop of the ring) counts with its fit
RING_LEGS = {"ring_full_turn": _RING_FULL, "ring_full_overlap": _RING_FULL,
             "ring_serve_greedy": {"ce_forward": 1},
             "ring_serve_top5": {"stage1_topk": 1},
             "ring_serve_ivf": {"ivf_rerank": 1},
             "ring_serve_ivf_all": {"ivf_rerank": 1},
             "ring_cnn_turn": _RING_CNN, "ring_cnn_overlap": _RING_CNN,
             "ring_knn": {"sparse_ce_forward": RING_MICRO * RING_KNN_STEPS,
                          "sparse_ce_backward": RING_MICRO * RING_KNN_STEPS,
                          "dist_topk": RING_N}}
RING_LAUNCH_TIMEOUT_S = 400


def _ring_experiment(impl: str = "full", trunk: str = "feats",
                     overlap: bool = True, data_fn=None):
    """The ring phase's experiment at the paper's width: ``impl`` head on
    the kernel backend, LARS, FCCS held at RING_MICRO micro-batches of
    RING_HW; the ``feats`` trunk, or ResNet-50 (bf16 over fp32 params) on
    224 x 224 images with DGC at its defaults. ``overlap=False`` puts the
    in-turn schedule in the trainer's step."""
    from repro_torch.api import Experiment
    from repro_torch.configs import sku100m_resnet
    from repro_torch.configs.base import (DGCConfig, FCCSConfig, HeadConfig,
                                          TrainConfig)
    from repro_torch.data.synthetic import sku_image_batch
    from repro_torch.train import hybrid

    b = RING_HW * RING_MICRO
    fccs = FCCSConfig(eta0=0.4, t_warm=2, b0=b, b_min=b, b_max=b, t_ini=2,
                      t_final=6)
    kw = dict(classes=V, feat_dim=D, data_fn=data_fn)
    dgc = DGCConfig()
    if trunk == "cnn":
        kw = dict(model=dataclasses.replace(sku100m_resnet.config_1m(),
                                            dtype="bfloat16"),
                  data_fn=data_fn or (lambda t, n: sku_image_batch(
                      t, n, V, hw=RES_HW, device=DEVICE)))
        dgc = DGCConfig(enabled=True, backend="kernel")
    knn = (dict(knn_k=KNN_K, knn_kprime=KPRIME, active_frac=ACTIVE_FRAC)
           if impl == "knn" else {})
    exp = Experiment.from_config(
        system="paper", batch=RING_HW, seed=0, device=DEVICE, log_every=0,
        head=HeadConfig(softmax_impl=impl, backend="kernel", **knn),
        train=TrainConfig(optimizer="lars", fccs=fccs, dgc=dgc), **kw)
    if not overlap:
        exp.trainer._steps[RING_MICRO] = hybrid.make_train_step(
            exp.model_cfg, exp.head_cfg, exp.train_cfg, n_micro=RING_MICRO,
            head=exp.head, overlap=False)
    return exp


def _ring_fit(torch, exp, steps: int) -> dict:
    """``fit(steps)`` under a tracer (whose live spans sync the card):
    the losses, each step's ms and the seconds blocked in the gathers'
    ``wait()`` (``train.gather_wait_s``)."""
    from repro_torch.telemetry import Tracer
    tr = Tracer()
    hist = exp.fit(steps, use_fccs_batch=True, telemetry=tr)
    if [r["batch"] for r in hist] != [RING_HW * RING_MICRO] * steps:
        fail(f"ring phase: batches {[r['batch'] for r in hist]}")
    return {"losses": [r["loss"] for r in hist],
            "label_recall": [r.get("label_recall") for r in hist],
            "step_ms": [e.dur_ns / 1e6 for e in tr.events
                        if e.name == "train.step"],
            "gather_wait_s": tr.counters.get("train.gather_wait_s", 0.0)}


def _ring_member(shard_dir: str) -> dict:
    """One member of the ring of two: on each leg every kernel counter is
    set to 0 just before and read just after. The full head ``fit``s in
    turn and overlapped (bit-equal losses, W shards and LARS moments);
    greedy, exact and IVF top-5 of 64 queries on the trained experiment
    (its W shard saved for the parent's ring of one); ResNet-50 + DGC in
    both schedules (bit-equal); the knn head."""
    import torch
    from repro_torch import dist
    from repro_torch.kernels import ce_softmax as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ivf_rerank as ivf
    from repro_torch.kernels import knn_dist_topk as dk
    from repro_torch.kernels import sparse_ce as sp
    from repro_torch.kernels import topk_dc as dc
    from repro_torch.resilience import tree_compare
    counters = {"ce_forward": (ce, "LAUNCHES"),
                "ce_backward": (ce, "BWD_LAUNCHES"),
                "sparse_ce_forward": (sp, "LAUNCHES"),
                "sparse_ce_backward": (sp, "BWD_LAUNCHES"),
                "dist_topk": (dk, "LAUNCHES"), "stage1_topk": (dc, "LAUNCHES"),
                "ivf_rerank": (ivf, "LAUNCHES"),
                "flash_attention": (fa, "LAUNCHES")}
    legs, out = {}, {"rank": dist.rank()}

    def bitwise(a, b) -> bool:
        return tree_compare(a, b)["bitwise"]

    def leg(name, fn):
        torch.cuda.synchronize()
        _reset(counters)
        got = fn()
        torch.cuda.synchronize()
        legs[name] = {k: v for k, v in _read(counters).items() if v}
        return got

    # the full head, feats trunk: in turn, then overlapped
    torch.cuda.reset_peak_memory_stats()
    turn = _ring_experiment(overlap=False)
    out["full_turn"] = leg("ring_full_turn",
                           lambda: _ring_fit(torch, turn, RING_STEPS))
    exp = _ring_experiment(data_fn=turn.data_fn)
    out["full_overlap"] = leg("ring_full_overlap",
                              lambda: _ring_fit(torch, exp, RING_STEPS))
    out["full_bit_equal"] = {
        "losses": out["full_turn"]["losses"] == out["full_overlap"]["losses"],
        "w": bitwise(turn.state.w_head, exp.state.w_head),
        "lars_moments": bitwise(turn.state.opt_state.mu,
                                exp.state.opt_state.mu)}
    out["w_shard"] = list(exp.state.w_head.shape)
    del turn
    gc.collect()
    torch.cuda.empty_cache()
    # serving on the trained ring: greedy, exact top-5, IVF top-5 at the
    # default nprobe and at every cluster (exact by construction)
    out["greedy"] = leg("ring_serve_greedy",
                        lambda: exp.serve(batch=64)).tolist()
    out["top5"] = leg("ring_serve_top5",
                      lambda: exp.serve(batch=64, top_k=5)).tolist()
    idx = exp.ivf_index()
    out["ivf_index"] = {"clusters": idx.n_clusters, "cap": idx.cap,
                        "nprobe": idx.nprobe}
    out["ivf"] = leg("ring_serve_ivf", lambda: exp.serve(
        batch=64, top_k=5, index="ivf")).tolist()
    out["ivf_all"] = leg("ring_serve_ivf_all", lambda: exp.serve(
        batch=64, top_k=5, index="ivf", nprobe=idx.n_clusters)).tolist()
    torch.save(exp.state.w_head.cpu(), os.path.join(
        shard_dir, f"w{dist.rank()}.pt"))
    out["full_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del exp, idx
    gc.collect()
    torch.cuda.empty_cache()

    # ResNet-50 + DGC, 64 images a member a micro-batch, both schedules
    torch.cuda.reset_peak_memory_stats()
    turn = _ring_experiment(trunk="cnn", overlap=False)
    out["cnn_turn"] = leg("ring_cnn_turn",
                          lambda: _ring_fit(torch, turn, RING_CNN_STEPS))
    cnn = _ring_experiment(trunk="cnn", data_fn=turn.data_fn)
    out["cnn_overlap"] = leg("ring_cnn_overlap",
                             lambda: _ring_fit(torch, cnn, RING_CNN_STEPS))
    a, b = turn.state, cnn.state
    out["cnn_bit_equal"] = {
        "losses": out["cnn_turn"]["losses"] == out["cnn_overlap"]["losses"],
        "fe": bitwise(a.fe_params, b.fe_params),
        "w": bitwise(a.w_head, b.w_head),
        "lars_moments": bitwise(a.opt_state.mu, b.opt_state.mu),
        "dgc": bitwise(a.dgc, b.dgc)}
    out["cnn_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del turn, cnn, a, b
    gc.collect()
    torch.cuda.empty_cache()

    # the knn head: its graph built over the ring, then fit
    def knn_leg():
        knn = _ring_experiment(impl="knn")
        return _ring_fit(torch, knn, RING_KNN_STEPS)

    out["knn"] = leg("ring_knn", knn_leg)
    out["legs"] = legs
    return out


def _torchrun(argv: list):
    """A launcher of the port under ``torchrun`` on two processes sharing
    this card, started in the background."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(RING_N), "-m"] + argv, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def paper_ring_phase(torch, np, counters) -> tuple:
    """Phase 30 (module docstring). Returns (the launches by path, the
    phase's rows)."""
    import shutil

    from repro_torch import dist
    t_phase = time.perf_counter()
    out, launches = {}, {}
    # the ring of one, from the same seed
    exp = _ring_experiment()
    _reset(counters)
    one = _ring_fit(torch, exp, RING_STEPS)
    torch.cuda.synchronize()
    launches["ring_of_one"] = got = {k: v for k, v in _read(counters).items()
                                     if v}
    if got != _RING_FULL:
        fail(f"ring phase: the ring of one launched {got}, not {_RING_FULL}")
    out["ring_of_one"] = one
    del exp
    gc.collect()
    torch.cuda.empty_cache()

    shard_dir = ROOT / "build" / "chip_ring"
    shutil.rmtree(shard_dir, ignore_errors=True)
    shard_dir.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        members = dist.spawn_ring(_ring_member, RING_N, str(shard_dir))
        out["ring_s"] = time.perf_counter() - t0
        w = torch.cat([torch.load(shard_dir / f"w{r}.pt")
                       for r in range(RING_N)]).to(DEVICE)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    ref = np.asarray(one["losses"])
    for m in members:
        r = m["rank"]
        for name in RING_LEGS:
            launches[f"{name}_member{r}"] = m["legs"].get(name, {})
        if m["legs"] != RING_LEGS:
            fail(f"ring phase: member {r} launched {m['legs']}, not "
                 f"{RING_LEGS}")
        for key in ("full_bit_equal", "cnn_bit_equal"):
            if not all(m[key].values()):
                fail(f"ring phase: member {r}'s schedules are not "
                     f"bit-equal: {key} {m[key]}")
        rel = np.abs(np.asarray(m["full_overlap"]["losses"]) - ref) / ref
        m["loss_rel_vs_ring_of_one"] = rel.tolist()
        if not rel.max() <= RING_LOSS_RTOL:
            fail(f"ring phase: member {r}'s losses "
                 f"{m['full_overlap']['losses']} are {rel.max():.2e} from "
                 f"the ring of one's {one['losses']}")
        for key in ("full_overlap", "cnn_overlap", "knn"):
            if not all(map(math.isfinite, m[key]["losses"])):
                fail(f"ring phase: member {r}'s {key} losses "
                     f"{m[key]['losses']}")
    for key in ("full_overlap", "cnn_overlap", "knn", "greedy", "top5",
                "ivf", "ivf_all"):
        a, b = (members[0][key], members[1][key])
        if key in ("full_overlap", "cnn_overlap", "knn"):
            a, b = a["losses"], b["losses"]
        if a != b:
            fail(f"ring phase: the members' {key} differ: {a} / {b}")

    # the ring of one serving the gathered W: the same ids
    exp = _ring_experiment()
    exp.load_state(exp.state._replace(head_params=w))
    greedy = exp.serve(batch=64).tolist()
    top5 = exp.serve(batch=64, top_k=5).tolist()
    n_all = exp.ivf_index().n_clusters
    ivf_all = exp.serve(batch=64, top_k=5, index="ivf",
                        nprobe=n_all).tolist()
    m = members[0]
    same = {"greedy": m["greedy"] == greedy, "top5": m["top5"] == top5,
            "ivf_all_vs_exact": m["ivf_all"] == top5,
            "ring_of_one_ivf_all_vs_exact": ivf_all == top5}
    recall = float(np.mean([len(set(a) & set(b)) / 5
                            for a, b in zip(m["ivf"], top5)]))
    out["serve"] = {"same_ids": same, "ivf_recall_at_5": recall,
                    "ivf_index_member": m["ivf_index"]}
    del exp, w
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ring phase: serving 64 queries on the ring of two against the "
        f"ring of one on the gathered W: {same}; IVF top-5 recall@5 "
        f"{recall:.3f} at the members' default nprobe "
        f"({m['ivf_index']})")
    if not all(same.values()):
        fail(f"ring phase: the ring's ids are not the ring of one's: {same}")

    # the launchers under torchrun, two processes on this card each
    base = ["--system", "paper", "--share-cards", "--classes", str(V),
            "--feat-dim", str(D)]
    runs = {"train": (["repro_torch.launch.train"] + base + [
        "--batch", "256", "--steps", "4", "--fccs"], "final eval accuracy"),
        "serve_top5": (["repro_torch.launch.serve"] + base + [
            "--batch", "64", "--topk", "5"], "first query ids"),
        "serve_ivf": (["repro_torch.launch.serve"] + base + [
            "--batch", "64", "--topk", "5", "--index", "ivf"],
            "first query ids")}
    t0 = time.perf_counter()
    procs = {name: _torchrun(argv) for name, (argv, _) in runs.items()}
    try:
        out["launchers"] = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=RING_LAUNCH_TIMEOUT_S)
            lines = [line for line in stdout.splitlines()
                     if runs[name][1] in line]
            out["launchers"][name] = {"rc": proc.returncode, "lines": lines}
            if proc.returncode or len(lines) != 1:
                fail(f"ring phase: the {name} launcher under torchrun: exit "
                     f"{proc.returncode}, {len(lines)} result lines:\n"
                     f"{stdout[-2000:]}\n{stderr[-3000:]}")
            log(f"ring phase: torchrun {name}: {lines[0].strip()}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out["launchers_s"] = time.perf_counter() - t0

    for m in members:
        for key in ("full_turn", "full_overlap", "cnn_turn", "cnn_overlap"):
            st = m[key]["step_ms"]
            log(f"ring phase: member {m['rank']} {key}: losses "
                f"{m[key]['losses']}, steps {[round(s, 2) for s in st]} ms "
                f"(median of steps 1+ {statistics.median(st[1:]):.2f}), "
                f"train.gather_wait_s {m[key]['gather_wait_s']:.4f}")
        log(f"ring phase: member {m['rank']}: losses relative to the ring "
            f"of one's {one['losses']}: {m['loss_rel_vs_ring_of_one']}; "
            f"bit-equal {m['full_bit_equal']}, cnn {m['cnn_bit_equal']}; "
            f"knn losses {m['knn']['losses']}, label_recall "
            f"{m['knn']['label_recall']}; launches {m['legs']}; peaks full "
            f"{m['full_peak_gb']:.2f} GB, cnn {m['cnn_peak_gb']:.2f} GB; W "
            f"shard {m['w_shard']}")
    out["members"] = [{k: v for k, v in m.items()
                       if k not in ("greedy", "top5", "ivf", "ivf_all")}
                      for m in members]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"ring phase: {out['phase_s']:.1f} s (the ring of two "
        f"{out['ring_s']:.1f} s, the launchers {out['launchers_s']:.1f} s); "
        f"the ring of one's steps {[round(s, 2) for s in one['step_ms']]} "
        f"ms")
    return launches, out


# ---------------------------------------------------------------------------
# the examples on the card (phase 31)
# ---------------------------------------------------------------------------

# every kernel at the shapes of scripts/smoke_torch.sh's legs, which the
# phases above never use: (B, class rows of a member's shard, D). The paper
# legs on rings of 8 (512 classes at D 64: 64 rows; 256 at D 32: 32),
# the elastic restores on 4 and 16 (64 and 16 rows), the IVF leg (1,024
# at D 16 on 8: 128 rows)
SMALL_SHAPES = ((32, 64, 64), (16, 32, 32), (16, 16, 32), (16, 64, 32),
                (16, 128, 16))
SMALL_KPRIME = 16             # the smoke legs' knn_kprime
SMALL_ACTIVE = 8              # a shard's active rows there (k' + labels)
# flash_attention in fp32 at the reduced SmolLM's prefill (3 heads of 32):
# serve_lm's 8 prompts of 24 tokens, the smoke grid's 2 a data shard of 16
SMALL_FLASH = ((24, 24, 32), (6, 16, 32))
EX_CNN_ARGV = ["--classes", str(V), "--steps", "20"]
EX_SERVE_ARCHS = ("smollm_135m", "mamba2_370m")
# launches of each example, every counter reset just before it:
# quickstart: the knn head's micro-batches over 150 FCCS steps at a
# hardware batch of 128 (1 x 43, 2 x 25, 4 x 23, 8 x 59 steps: 657), the
# graph built at start and after steps 49, 99 and 149 (one dist_topk a
# build on a ring of one), evaluate and the greedy serve one ce_forward
# each. train_sku_cnn: 20 steps of one micro-batch, the graph built at
# start (rebuild_every 60), DGC's threshold once a step over the reduced
# trunk's one group of leaves, evaluate one ce_forward. serve_lm: the
# prefill's self-attention once a layer (2 layers; decode runs the ref
# branches), mamba2 none (its SSD mixer has no kernel)
EXAMPLES_WANT = {
    "examples_quickstart": {"sparse_ce_forward": 657,
                            "sparse_ce_backward": 657, "dist_topk": 4,
                            "ce_forward": 2},
    "examples_train_sku_cnn": {"sparse_ce_forward": 20,
                               "sparse_ce_backward": 20, "dist_topk": 1,
                               "stage1_topk": 20, "ce_forward": 1},
    "examples_serve_lm_smollm_135m": {"flash_attention": 2},
    "examples_serve_lm_mamba2_370m": {}}
# the JAX quickstart's accuracy on the CPU (examples/quickstart.py as
# committed, on 8 host devices: a ring of 8), logged beside the port's.
# The JAX ring of 8 takes head steps 8 times the ring of one's at the same
# lr (ROADMAP C.1): the port's quickstart on a ring of one learns faster
# than on a ring of 8
JAX_CPU_ACC = {"quickstart": 0.3184}
# the kernel wrappers an example's calls are captured from, by counter:
# (the counter's module, its entries)
EX_ENTRIES = {"ce_forward": ("ce_forward",), "ce_backward": ("ce_backward",),
              "sparse_ce_forward": ("sparse_ce_forward",),
              "sparse_ce_backward": ("sparse_ce_backward",),
              "dist_topk": ("dist_topk",), "stage1_topk": ("stage1_topk",),
              "ivf_rerank": ("ivf_rerank", "ivf_rerank_probed"),
              "flash_attention": ("flash_attention",)}
EX_CAPTURE = 3      # distinct input shapes of an entry held, per example
EX_DIST_ROWS = 512  # dist_topk queries held at each end of a larger call


def _example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def captured_calls(torch, counters):
    """For the body, each kernel entry (``EX_ENTRIES``) copies the inputs
    of its first call at each distinct signature (the tensors' shapes and
    dtypes, the other arguments' values), up to ``EX_CAPTURE`` of them,
    before it runs. Yields {entry: [bound arguments]}, filled as the body
    runs; the entries are restored on exit."""
    import inspect
    calls, saved = {}, []

    def wrap(mod, entry):
        fn = getattr(mod, entry)
        sig = inspect.signature(fn)
        seen = set()
        calls[entry] = []

        def rec(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            key = tuple((tuple(x.shape), x.dtype)
                        if isinstance(x, torch.Tensor) else x
                        for x in bound.arguments.values())
            if key not in seen and len(seen) < EX_CAPTURE:
                seen.add(key)
                calls[entry].append(
                    {k: x.detach().clone() if isinstance(x, torch.Tensor)
                     else x for k, x in bound.arguments.items()})
            return fn(*args, **kwargs)

        saved.append((mod, entry, fn))
        setattr(mod, entry, rec)

    try:
        for name, entries in EX_ENTRIES.items():
            for entry in entries:
                wrap(counters[name][0], entry)
        yield calls
    finally:
        for mod, entry, fn in saved:
            setattr(mod, entry, fn)


def check_captured(torch, kern, calls, what) -> dict:
    """Each captured call (``captured_calls``) held against its kernel's
    plain version on the same inputs, through the gates of the phases
    above; dist_topk on its first and last ``EX_DIST_ROWS`` queries over
    every key. Returns {entry: {"shapes": [...], "max_err": x}}."""
    ce, sp, dk, dc, ivf, fa = kern
    out = {}

    def shape(a):
        return {k: list(x.shape) if isinstance(x, torch.Tensor) else x
                for k, x in a.items()
                if isinstance(x, (torch.Tensor, int, float, bool))}

    for entry, bound in calls.items():
        for a in bound:
            label = f"{what}, {entry} at {shape(a)}"
            if entry == "ce_forward":
                lim = a["w"].shape[0] if a["limit"] is None else a["limit"]
                err = max(check_ce(torch, ce, a["f"], a["w"], a["y"], lim,
                                   a["scale"], label))
            elif entry == "ce_backward":
                lim = a["w"].shape[0] if a["limit"] is None else a["limit"]
                parts = check_ce_bwd(torch, ce, a["f"], a["w"], a["y"],
                                     a["m"], a["gz"], a["gc"], lim,
                                     a["scale"], label)
                err = max(r for _, r in parts.values())
            elif entry.startswith("sparse_ce"):
                cols = (a["f"], a["w"], a["ids"], a["gids"], a["bias"],
                        a["valid"], a["y"])
                if entry == "sparse_ce_forward":
                    z = sp.sparse_ce_forward(*cols, scale=a["scale"],
                                             mask_hits=a["mask_hits"])[1]
                    b = a["f"].shape[0]
                    gz, gc_ = 1.0 / (b * z), torch.full_like(z, -1.0 / b)
                else:
                    gz, gc_ = a["gz"], a["gc"]
                err = max(check_sparse(torch, sp, *cols, a["scale"],
                                       a["mask_hits"], gz, gc_,
                                       label).values())
            elif entry == "dist_topk":
                q = a["q"]
                if q.shape[0] > 2 * EX_DIST_ROWS:
                    q = torch.cat([q[:EX_DIST_ROWS], q[-EX_DIST_ROWS:]])
                err, _ = check_dist_topk(torch, dk, q, a["kmat"],
                                         a["kprime"], a["col_offset"],
                                         label)
            elif entry == "stage1_topk":
                err = check_topk(torch, dc, a["x"], a["k"], a["chunk"],
                                 label)
            elif entry == "ivf_rerank":
                err = check_ivf(torch, ivf, a["f"], a["w"], a["cand"],
                                a["k"], label)[0]
            elif entry == "ivf_rerank_probed":
                cand = a["members"][a["probe"].long()].reshape(
                    a["f"].shape[0], -1).contiguous()
                err = check_ivf(torch, ivf, a["f"], a["w"], cand, a["k"],
                                label, members=a["members"],
                                probe=a["probe"])[0]
            else:                                   # flash_attention
                q, k = a["q"], a["k"]
                err, gate = check_flash(
                    torch, fa, q.shape[0], q.shape[1], k.shape[1],
                    q.shape[2], a["causal"], a["window"], q.dtype, 31,
                    group=q.shape[0] // k.shape[0])
                if not gate["ok"]:
                    fail(f"flash_attention {label}: max abs err {err:.3g}, "
                         f"gate {gate}")
            row = out.setdefault(entry, {"shapes": [], "max_err": 0.0})
            row["shapes"].append(shape(a))
            row["max_err"] = max(row["max_err"], float(err))
        torch.cuda.empty_cache()
    return out


def small_shapes_check(torch, ce, sp, dk, dc, ivf, fa) -> dict:
    """Each kernel against its plain version at ``SMALL_SHAPES``: class
    shards below one tile, through the gates of the phases above. Returns
    the largest error of each kernel over the shapes."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    errs = {}

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), float(err))

    for b, v, d in SMALL_SHAPES:
        what = f"smoke shape B={b} V={v} D={d}"
        f = torch.nn.functional.normalize(
            torch.randn((b, d), generator=g, device=dev), dim=1)
        w = torch.nn.functional.normalize(
            torch.randn((v, d), generator=g, device=dev), dim=1)
        y = torch.randint(0, v, (b,), generator=g, device=dev,
                          dtype=torch.int32)
        y[0] = -1                                   # a label off the shard
        m_corr, z_rel = check_ce(torch, ce, f, w, y, v, 16.0, what)
        keep("ce_forward", max(m_corr, z_rel))
        m, z = ce.ce_forward(f, w, y, limit=v, scale=16.0)[:2]
        gz, gc = 1.0 / (b * z), torch.full_like(z, -1.0 / b)
        parts = check_ce_bwd(torch, ce, f, w, y, m, gz, gc, v, 16.0, what)
        keep("ce_backward", max(r for _, r in parts.values()))
        keep("stage1_topk", check_topk(torch, dc, f @ w.T, 5, label=what))
        wb = w.to(torch.bfloat16)       # the graph build's rows
        err, _ = check_dist_topk(torch, dk, wb, wb, SMALL_KPRIME, label=what)
        keep("dist_topk", err)
        a = min(SMALL_ACTIVE + b // 4, v)
        fs, ws, ids, ys = sparse_problem(torch, g, b, v, d, a, n_dup=1,
                                         unit=True, dev=dev)
        bias = torch.zeros(a, device=dev)
        valid = torch.ones(a, dtype=torch.int32, device=dev)
        ms, zs = sp.sparse_ce_forward(fs, ws, ids, ids, bias, valid, ys,
                                      scale=16.0)[:2]
        for part, e in check_sparse(
                torch, sp, fs, ws, ids, ids, bias, valid, ys, 16.0, False,
                1.0 / (b * zs), torch.full_like(zs, -1.0 / b), what).items():
            keep(f"sparse_ce_{'forward' if part.startswith('fwd') else 'backward'}",
                 e)
        cand = torch.randint(0, v, (b, min(v, 40)), generator=g,
                             device=dev, dtype=torch.int32)
        cand[torch.rand(cand.shape, generator=g, device=dev) < 0.2] = -1
        keep("ivf_rerank", check_ivf_both(torch, ivf, f, w, cand, 5, what,
                                          4))
    for bh, s, dh in SMALL_FLASH:
        err, gate = check_flash(torch, fa, bh, s, s, dh, True, 0,
                                torch.float32, 31, group=1)
        if not gate["ok"]:
            fail(f"flash_attention fp32 at q [{bh}, {s}, {dh}]: max abs err "
                 f"{err:.3g} (tolerance {FLASH_FP32_TOL:g})")
        keep("flash_attention", err)
    log(f"examples phase: every kernel agrees with its plain version at the "
        f"smoke script's shapes {SMALL_SHAPES} (B, V, D), k' "
        f"{SMALL_KPRIME}, flash fp32 {SMALL_FLASH}: largest errors {errs}")
    return errs


def examples_phase(torch, np, counters, kern) -> tuple:
    """Phase 31 (module docstring). Returns (the launches by example, the
    phase's rows)."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    out = {"small_shapes": small_shapes_check(torch, *kern)}
    launches = {}

    def run(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        text = io.StringIO()
        with captured_calls(torch, counters) as calls:
            _reset(counters)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                got = fn()
            torch.cuda.synchronize()
            launches[name] = {k: v for k, v in _read(counters).items() if v}
        out[name] = {"s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": launches[name]}
        lines = text.getvalue().strip().splitlines()
        log(f"examples phase: {name}: {out[name]['s']:.1f} s, peak "
            f"{out[name]['peak_gb']:.2f} GB, launches {launches[name]}; "
            f"its last lines: {lines[-3:]}")
        if launches[name] != EXAMPLES_WANT[name]:
            fail(f"examples phase: {name} launched {launches[name]}, not "
                 f"{EXAMPLES_WANT[name]}")
        out[name]["captured"] = check_captured(torch, kern, calls, name)
        log(f"examples phase: {name}: every kernel agrees with its plain "
            f"version on the inputs of its calls: {out[name]['captured']}")
        return got, text.getvalue()

    (exp, acc), text = run("examples_quickstart",
                           lambda: _example("quickstart_torch").main([]))
    hist = exp.trainer.history
    if (len(hist) != 150 or hist[-1]["batch"] != 1024
            or not all(math.isfinite(r["loss"]) for r in hist)
            or not 0.0 <= acc <= 1.0
            or "serve() returned 64 retrieval ids" not in text):
        fail(f"examples phase: quickstart: {len(hist)} steps, final batch "
             f"{hist[-1]['batch']}, accuracy {acc}:\n{text[-2000:]}")
    out["examples_quickstart"].update(
        accuracy=acc, losses=[hist[0]["loss"], hist[-1]["loss"]],
        label_recall=min(r["label_recall"] for r in hist))
    del exp

    (trainer, acc), text = run(
        "examples_train_sku_cnn",
        lambda: _example("train_sku_cnn_torch").main(EX_CNN_ARGV))
    hist = trainer.history
    w = trainer.state.w_head
    if (len(hist) != 20 or tuple(w.shape) != (V, 128)
            or not all(math.isfinite(r["loss"]) for r in hist)
            or not 0.0 <= acc <= 1.0 or "final accuracy" not in text):
        fail(f"examples phase: train_sku_cnn: {len(hist)} steps, W "
             f"{tuple(w.shape)}, accuracy {acc}:\n{text[-2000:]}")
    out["examples_train_sku_cnn"].update(
        accuracy=acc, losses=[hist[0]["loss"], hist[-1]["loss"]],
        head_gb=w.numel() * w.element_size() / 1e9,
        label_recall=min(r["label_recall"] for r in hist))
    del trainer, w

    for arch in EX_SERVE_ARCHS:
        rc, text = run(f"examples_serve_lm_{arch}",
                       lambda: _example("serve_lm_torch").main(
                           ["--arch", arch]))
        line = [x for x in text.splitlines() if "generated (8, 12)" in x]
        if rc != 0 or len(line) != 1:
            fail(f"examples phase: serve_lm {arch}: exit {rc}:\n"
                 f"{text[-2000:]}")
        out[f"examples_serve_lm_{arch}"]["line"] = line[0]
    out["jax_cpu_accuracy"] = JAX_CPU_ACC
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"examples phase: quickstart accuracy "
        f"{out['examples_quickstart']['accuracy']:.4f} (the JAX example on "
        f"the CPU on a ring of 8 {JAX_CPU_ACC['quickstart']:.4f}), "
        f"train_sku_cnn at {V:,} classes "
        f"{out['examples_train_sku_cnn']['accuracy']:.4f}; the phase "
        f"{out['phase_s']:.1f} s")
    return launches, out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.core import sharded_softmax as sharded
    from repro_torch.kernels import build
    from repro_torch.kernels import ce_softmax as ce
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ivf_rerank as ivf
    from repro_torch.kernels import knn_dist_topk as dk
    from repro_torch.kernels import sparse_ce as sp
    from repro_torch.kernels import topk_dc as dc

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"ptxas: {line.strip()}")
    hopper_path_check(build)
    fma_kernel_check(build)
    dry_proc = start_grid_dryruns()
    try:
        return _main_phases(torch, np, smi, build_s, dry_proc, sharded, ce,
                            fa, ivf, dk, sp, dc)
    finally:
        if dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.communicate()


def _main_phases(torch, np, smi, build_s, dry_proc, sharded, ce, fa, ivf,
                 dk, sp, dc) -> int:

    kernels = kernel_phase(torch, ce, dc, sharded)
    kernels["ce_backward"] = backward_kernel_phase(torch, ce, sharded)
    # ce_forward at the training batch, its main path's 13 launches
    kernels["ce_forward"]["train_b256"] = kernels["ce_backward"].pop(
        "ce_forward_train")
    torch.cuda.empty_cache()
    kernels.update(sparse_kernel_phase(torch, sp))
    torch.cuda.empty_cache()
    kernels["dist_topk"] = dist_topk_phase(torch, dk, sharded)
    torch.cuda.empty_cache()
    exp, serve_launches, e2e = serving_phase(torch, np, ce, dc, sharded)
    del exp
    torch.cuda.empty_cache()
    e2e.update(launcher_phase(torch, ce, dc))
    e2e["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    kernels["ivf_rerank"], ivf_launches, ivf_e2e = ivf_phase(
        torch, np, ivf, sharded)
    gc.collect()                 # the engines and the experiment hold a cycle
    torch.cuda.empty_cache()
    e2e.update(ivf_e2e)
    e2e.update(ivf_launcher_phase(torch, ivf))
    e2e["ivf_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    train_launches, train_e2e = training_phase(torch, ce)
    e2e.update(train_e2e)
    e2e.update(train_launcher_phase())
    knn_launches, knn_e2e = knn_training_phase(torch, sp, dk)
    e2e.update(knn_e2e)
    # dist_topk's main time: pass 1 of the graph build over every row
    pass1_bound, _ = bound_ms(dk.cost(V, V, D, KPRIME))
    kernels["dist_topk"].update(
        pass1_ms=knn_e2e["knn_graph_build"]["pass1_dist_topk_s"] * 1e3,
        pass1_bound_ms=pass1_bound)
    e2e.update(train_launcher_phase("knn"))
    gc.collect()
    torch.cuda.empty_cache()
    counters = {"ce_forward": (ce, "LAUNCHES"),
                "ce_backward": (ce, "BWD_LAUNCHES"),
                "sparse_ce_forward": (sp, "LAUNCHES"),
                "sparse_ce_backward": (sp, "BWD_LAUNCHES"),
                "dist_topk": (dk, "LAUNCHES"), "stage1_topk": (dc, "LAUNCHES"),
                "ivf_rerank": (ivf, "LAUNCHES"),
                "flash_attention": (fa, "LAUNCHES")}
    head_launches, head_rows, e2e["heads"] = heads_phase(torch, np, counters,
                                                         ce, sp)
    for name, shapes in head_rows.items():
        kernels[name].update(shapes)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cnn_launches, e2e["cnn"], cnn_rows = cnn_phase(torch, np, counters, ce,
                                                   dc)
    for name, row in cnn_rows.items():
        kernels[name]["cnn_b128"] = row
    sel = e2e["cnn"]["cnn_dgc"]["selection"]
    kernels["stage1_topk"].update(
        dgc_step_groups=sel["groups"], dgc_step_ms=sel["stage1_ms"],
        dgc_step_bound_ms=sel["bound_ms"], dgc_step_bound_by=sel["bound_by"],
        dgc_step_library_ms=sel["library_ms"],
        dgc_step_stage2_sort_ms=sel["stage2_sort_ms"],
        dgc_exchange_ms=e2e["cnn"]["cnn_dgc"]["exchange_ms"],
        dgc_exchange_share=sel["stage1_ms"]
        / e2e["cnn"]["cnn_dgc"]["exchange_ms"])
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_launches, e2e["checkpoint"] = checkpoint_phase(torch, np, counters)
    gc.collect()
    torch.cuda.empty_cache()
    kernels["flash_attention"] = flash_kernel_phase(torch, fa)
    zoo_launches, zoo_e2e = zoo_phase(torch, np, counters, fa)
    e2e.update(zoo_e2e)
    e2e.update(zoo_launcher_phase(torch, fa))
    gc.collect()
    torch.cuda.empty_cache()
    zoo_train_launches, zoo_rows, e2e["zoo_training"], zexp = \
        zoo_training_phase(torch, np, counters, ce, sp, dk)
    zoo_ret_launches, zoo_ret_rows, e2e["zoo_retrieval"] = \
        zoo_retrieval_phase(torch, np, counters, dc, ivf, zexp)
    del zexp
    gc.collect()
    torch.cuda.empty_cache()
    e2e["zoo_launchers"] = zoo_train_launchers_phase(torch)
    for name, row in {**zoo_rows, **zoo_ret_rows}.items():
        kernels[name]["zoo"] = row

    # the ssm and hybrid families at full width, and the zoo's checkpoints
    fam_launches, e2e["families"] = {}, {}
    kern = {"sp": sp, "dk": dk, "dc": dc, "ivf": ivf}
    for arch in FAMILIES:
        path, fam_launches[path], e2e["families"][f"{arch}_serve"] = \
            family_serve_phase(torch, np, counters, arch)
    kernels["flash_attention"]["hymba"] = flash_family_check(torch, fa,
                                                            "hymba_1_5b")
    gc.collect()
    torch.cuda.empty_cache()
    for arch in FAMILIES:
        with _at_depth(FAM_TRAIN_DEPTH[arch]):
            path, fam_launches[path], rows, \
                e2e["families"][f"{arch}_train"], fexp = \
                family_training_phase(torch, np, counters, ce, arch)
            for name, row in rows.items():
                kernels[name][arch] = row
            paths, rows, e2e["families"][f"{arch}_heads"] = \
                family_heads_check(torch, np, counters, fexp, kern,
                                   arch == FAM_GATED)
            fam_launches.update(paths)
            for name, row in rows.items():
                kernels[name][arch] = row
            if arch == "mamba2_370m":
                import shutil
                try:
                    e2e["families"]["mamba2_370m_checkpoint"] = \
                        _ckpt_round_trip(torch, fexp, CKPT_DIR / "mamba2")
                finally:
                    shutil.rmtree(CKPT_DIR / "mamba2", ignore_errors=True)
        del fexp
        gc.collect()
        torch.cuda.empty_cache()
    zck_launches, e2e["zoo_checkpoint"] = zoo_checkpoint_phase(
        torch, np, counters)
    gc.collect()
    torch.cuda.empty_cache()

    # the moe, vlm and encdec families at their published widths
    for arch in NEW_FAMILIES + (ENCDEC,):
        if arch != ENCDEC:
            path, fam_launches[path], e2e["families"][f"{arch}_serve"] = \
                family_serve_phase(torch, np, counters, arch)
        kernels["flash_attention"][arch] = flash_family_check(torch, fa, arch)
        gc.collect()
        torch.cuda.empty_cache()
        path, fam_launches[path], rows, e2e["families"][f"{arch}_train"], \
            fexp = family_training_phase(torch, np, counters, ce, arch)
        for name, row in rows.items():
            kernels[name][arch] = row
        paths, rows, e2e["families"][f"{arch}_heads"] = family_heads_check(
            torch, np, counters, fexp, kern, True, park=arch != ENCDEC)
        fam_launches.update(paths)
        for name, row in rows.items():
            kernels[name][arch] = row
        if arch == ENCDEC:
            path, fam_launches[path], e2e["families"][f"{arch}_decode"] = \
                encdec_decode_phase(torch, np, counters, fexp)
        del fexp
        gc.collect()
        torch.cuda.empty_cache()
    # remat, the dry run against the card, the roofline of real steps
    e2e["remat"] = remat_phase(torch, np, counters)
    e2e["dryrun"], e2e["roofline"] = dryrun_roofline_phase(torch,
                                                           e2e["remat"])
    gc.collect()
    torch.cuda.empty_cache()
    grid_launches, e2e["grid"] = grid_phase(torch, np, counters, dry_proc)
    gc.collect()
    torch.cuda.empty_cache()
    fam_grid_launches, e2e["grid_families"] = grid_families_phase(
        torch, np, counters, e2e["grid"]["dryrun_1x2_families"])
    grid_launches.update(fam_grid_launches)
    gc.collect()
    torch.cuda.empty_cache()
    ring_launches, e2e["paper_ring"] = paper_ring_phase(torch, np, counters)
    grid_launches.update(ring_launches)
    gc.collect()
    torch.cuda.empty_cache()
    ex_launches, e2e["examples"] = examples_phase(
        torch, np, counters, (ce, sp, dk, dc, ivf, fa))
    grid_launches.update(ex_launches)
    e2e["build_s"] = build_s

    # launches on each main path, from its own reset-and-read of the counters
    by_path = {name: {"serving": serve_launches.get(name, 0),
                      "training": train_launches.get(name, 0),
                      "knn_training": knn_launches.get(name, 0),
                      "ivf_serving": ivf_launches.get(name, 0),
                      "zoo_serving": zoo_launches.get(name, 0),
                      "dgc_training": cnn_launches.get(name, 0),
                      "checkpoint": ckpt_launches.get(name, 0),
                      **{path: n.get(name, 0)
                         for path, n in head_launches.items()},
                      **{path: n.get(name, 0)
                         for path, n in {**zoo_train_launches,
                                         **zoo_ret_launches, **fam_launches,
                                         **zck_launches,
                                         **grid_launches}.items()}}
               for name in kernels}
    rows = []
    for name, k in kernels.items():
        path = next(p for p in ("zoo_serving", "knn_training", "training",
                                "dgc_training", "ivf_serving", "serving")
                    if by_path[name][p] or p == "serving")
        rows.append({**k, "launches": by_path[name][path],
                     "launches_path": path, "launches_by_path": by_path[name],
                     "kernel_ms": k["ms"], "max_err": k["max_abs_err"]})
    log("every phase passed; the results follow")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"end_to_end": e2e, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
