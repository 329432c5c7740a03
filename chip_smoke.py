#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (the
   PAop and flash-attention libraries in parallel, one ``nvcc`` per
   source, each library timed), print what ``ptxas`` reports per
   instantiation (registers, spills, the wgmma kernel's shared memory, and
   any ``wgmma ... serialized`` warning; for the PAop kernel and its
   baseline, the first port's kernel, also the shared bytes per block and
   the blocks an SM holds), and hold the probe kernel against ``2 * x``;
3. hold the PAop kernel against its plain PyTorch version on the card for
   p = 1..8 in float64, float32 and bfloat16 at NE in {1, 7, 4096}
   (bfloat16 also from views at a storage offset of 1 and 3 values, and at
   every (p, NE) that phase 5d's solves and service give it, within 2^-7
   of max |plain|), and at every
   (p, NE) the single and the batched solve give it (S * NE elements, and
   the coarse probe's n * S * NE) and phase 8's sweep times it at (p = 1..8
   at the refinements of ``ABLATION_REFINE``, and beam_p8_51m), with the
   tests' tolerances; hold the
   flash-attention kernels against their plain version in float32 (atol
   2e-5) and bfloat16 (atol 3e-2, and 1e-2 per-row relative) at the
   shapes of ``tests/test_flash_kernel.py``, windows {16, 48, 128},
   ragged S in {1, 7, 100, 1000}, the wgmma route's D = 64 and 128 cases,
   phase 10's (H, K, D) (query groups of 4, 7 and 8; MHA at D = 128 and
   64), and the serve path's (8, 2048, 16, 8, 128), each case asserting which
   route (``ops.route``: wgmma, mma_sync or fma) launched; and at phase 12's
   head dim of 80 in bf16, (8, 2048, 32, 32, 80), (4, 4096, 32, 32, 80) and
   (2, 333, 32, 32, 80): the wgmma forward (its o bitwise that of the
   LSE-writing launch, and its LSE) and backward (bitwise repeated)
   against their plain versions, routes asserted wgmma, and the kept
   mma_sync kernels launched by name on the same inputs, both ways;
4. the solve path: ``solve_beam(4, 4, precision="f64", device="cuda")`` on
   the 2-material beam (32,768 elements, 6,502,275 DoFs) with every
   kernel count zeroed just before and read just after; it must converge
   to rel_tol 1e-6 through the kernels alone, to a finite solution, and a
   small solve on the card must agree with the same solve on the CPU
   (its iterations, solve time and peak memory are printed again in
   phase 5d);
5. the batched solve path: ``BatchedGMGSolver(beam_hex(), 4, 4,
   precision="f64", device="cuda")`` at S = 8 requests of the reference
   ``serve_solve`` workload (``repro_torch.launch.workload``: 4 rows of
   attribute dicts, 4 of ``lognormal:0`` per-element fields; rel_tol 1e-8
   and 1e-6 in turns).  A cold ``solve`` first, then each row alone
   through a warm ``solve_beam``, timed; then, with every count zeroed
   just before and read just after, a warm run of the user's entry
   points: a new solver, ``prepare`` and one ``run_chunk`` to the end,
   each timed between synchronize fences, with its peak memory, and
   compared with the rows' summed ``solve_beam`` times.  Every row must
   converge through the kernels alone, rows 0 and 4 must match
   ``solve_beam`` of their own scenario (same iterations, x within 1e-10
   of max |x|), and the warm run must equal the cold one bitwise.  Host syncs per ``solve`` are counted
   under ``torch.cuda.set_sync_debug_mode("warn")``; the folded coarse
   probe is timed beside a column-by-column loop, and a last prepare +
   run_chunk runs under ``torch.profiler`` for the device's busy share in
   each.  A small batched solve (p=2, refine=1, S=3) must agree with the
   CPU, and its chunked run and a masked row refill must be bitwise where
   they should be;
5b. the solve service: ``ElasticityService(max_batch=8, precision="f64",
   device="cuda")`` on 16 requests of the same ``serve_solve`` traffic
   (``--n-requests 16 --max-batch 8``: requests 0-3 and 8-11 attribute
   dicts, 4-7 and 12-15 ``lognormal:0`` fields, so 0-7 are phase 5's batch
   and 12-15 repeat 4-7), each run with every count zeroed just before and
   read just after: ``solve`` (generational; generation 0 must give phase
   5's iterations), then ``solve_continuous`` under the fixed and the
   adaptive chunk policy (chunks of 8; the adaptive run under sync debug
   mode), each request with the generational run's iterations and flags
   and the kept solutions of requests 0, 4, 8 and 12 within 1e-10 of max
   |x|, through the kernels alone; scenarios/s of each on the host clock
   between fences, latency quantiles, the scheduler summary (chunks,
   wasted iterations, refills), prep calls and copies, host syncs per
   step, peak memory; and a last continuous run under ``torch.profiler``
   with a fencing ``SpanRecorder``, whose per-ticket queue_wait + compute +
   overhead must equal the wall, its Chrome trace written to a temporary
   directory.  A small service (p=2, refine=1, 6 requests, max_batch 4,
   continuous) must agree with the CPU;
5c. recovery: phase 5b's requests and service under
   ``ServiceRecovery(every=2, keep=2)`` in a temporary directory (which
   must hold three checkpoints, or the phase fails), a scripted crash
   inside step 4 right after the chunk launch, the service dropped, a
   fresh one restored from step 3 with a step watchdog (1 ms) and
   drained with every count zeroed just before the restore and read
   after: every ticket bitwise as phase 5b's fixed run (iterations,
   flags, final_rel_norm, kept x) through the kernels alone (PAop and the
   probe launched, no plain call), one restore, the checkpoint writes the
   steps call for, the watchdog fired (counter and span).  Printed beside
   the card's name and power limit: free disk, checkpoint leaves and
   bytes, each write's seconds and one write's parts (device-to-host
   copy, crc32, np.save + fsync), the restore's seconds, the resumed run
   against phase 5b's undisturbed one.  In phase 9(d), beside the train
   CLI's round trip, ``serve_solve --continuous`` on the card (p=2,
   refine=1, 6 requests, max_batch 4, chunks of 2) uninterrupted and
   SIGKILLed after 2 steps with a checkpoint every step, then resumed: the
   resumed run's ``--report-out`` lines must equal the uninterrupted
   run's;
5d. the ``mixed-bf16`` policy (``[bf16]`` lines, beside the card's name
   and power limit): (a) ``solve_beam(4, 4, precision="mixed-bf16",
   device="cuda")`` with every count zeroed just before and read just
   after, converged to 1e-6 through the kernels alone (bfloat16 and f64
   PAop launches, no plain call), its iterations, solve time and peak
   memory beside phase 4's f64 solve and a ``mixed`` solve of the same
   beam, and a small solve (p=2, refine=1) within 1 iteration and 1e-5 of
   max |x| of the same solve on the CPU; (b) ``BatchedGMGSolver(beam_hex(),
   4, 4, precision="mixed-bf16")`` on phase 5's S = 8 rows, counted the
   same way: every row converged (a row the policy's breakdown or
   stagnation check flags is re-solved in f64: the fallback flags are
   printed), each with the true residual of an f64 solver's operator and
   preconditioner within its rel_tol, the rows' iterations beside phase
   5's; (c) a small continuous service (p=2, refine=1, 6 requests,
   max_batch 4) on the card and the CPU, every request converged, within
   1 iteration of each other;
6. the serve path: qwen3-1.7b at full width in bfloat16 (28 layers,
   seeded random weights) generates 32 greedy tokens for each of 8
   requests of 2048 prompt tokens, with every count zeroed just before
   and read just after: 28 flash-attention launches per prefill batch
   and no plain call, all 28 on the wgmma route.  A 2-token warm-up at
   the same shapes, its prompts
   left-padded to 2048, keeps the q/k/v that the first and the last
   layer give the kernel, and once the engine is freed the kernel's output
   on them is held against the plain version (1e-2 per-row relative); a
   reduced float32 qwen3 must give the same tokens and logits on the card
   as on the CPU;
7. time the PAop apply at p in {2, 4, 8} (NE=32768, f64; p=4 is the
   fine level of the solve; and its f32 and bfloat16 instantiations in the
   same rounds, the bfloat16 one with its own bound and plain version)
   beside the baseline kernel, and the flash
   kernel at (8, 2048, 16, 8, 128) bf16, beside their plain versions, a
   library call where one exists, and their bounds: rounds of back-to-back
   launches between one pair of CUDA events, the versions in turns (the
   kernel, the baseline, the plain version; the wgmma kernel, the same
   writing the LSE, SDPA, the mma_sync kernel), the median round; then the
   host time per call of the
   wrappers (``time.perf_counter`` over back-to-back calls, no sync
   inside), with the probe's wrapper split into its parts;
8. the ablation, the paper's assembly ladder on the card (``[ablation]``
   lines, each beside the card's name and power limit): (a) on small
   beams at p in {1, 2, 4, 8}, every level's ``apply`` on the card equal
   to the same level on the CPU and to ``paop_cuda`` on the card (the f64
   tolerances of ``TOL``), and ``fa``'s SpMV bitwise repeatable; (b)
   ``operator_throughput`` (``repro_torch.obs.throughput``) of every
   matrix-free level at p = 1..8, S = 1, f64, at the paper's 6,502,275
   DoFs (p = 1, 2, 4, 8) or the refinement nearest it (p = 3, 5, 6, 7),
   plus the 51,171,075-DoF beam at p = 8 for ``pa_baseline``,
   ``pa_sumfact_voigt`` and ``paop_cuda``: ms per apply, GDoF/s, roofline
   share (for ``pa_baseline`` both by the reference's dense model, which
   counts 3x the FLOPs its GEMMs run, and by the GEMMs' 36 Q^3 D^3), peak
   memory; three applies of each matrix-free level at p in
   {1, 4, 8} under ``torch.profiler`` (device time by kernel); (c)
   ``fa`` at 839,619 DoFs where its analytic
   bytes (``fa_memory_bytes``) fit a tenth of the card's memory (p = 1
   and 2), the model's bytes against the card's memory at p = 4 and 8,
   decided from the model before anything is built; (d) the paper's
   Table 4 on the card: ``solve_beam(4, 4)`` through ``pa_baseline``,
   ``pa_sumfact_voigt`` and ``paop_cuda``, and ``solve_beam(2, 4)``
   through ``fa`` and ``paop_cuda``, each with every count zeroed just
   before and read just after: the same iterations across levels at each
   size, phase times, the operator's ``memory_bytes``, peak memory, PAop
   and probe launches and no plain call; then the p=4/refine=4 coarse
   factor built from the scipy-assembled matrix and from the probe, timed
   in turns, the two matrices equal to 1e-12.  "pa_baseline" is MFEM's
   Algorithm 1 (dense O((p+1)^6) contractions, cuBLAS GEMMs); it is not
   the "baseline kernel" of phase 7, the PAop kernel of the first port
   (``csrc/pa_elasticity_baseline.cu``).

9. training (``[train]`` lines, each beside the card's name and power
   limit): (a) the flash backward routes against their plain version in
   float32 (fma; 1e-4 of max |plain|) and bfloat16 (wgmma at D in {64, 80, 128},
   mma_sync at D in {16, 32}; 2e-2 of max |plain| and per row,
   ``ref.flash_bwd_errors``) at S in {1, 77, 300, 1024}, G in {1, 2},
   windows, and the training shape (4, 4096, 16, 8, 128) bf16 (there the
   mma_sync route on the same inputs too), each case's route asserted,
   bitwise repeatable, its forward o and LSE (every forward route's: fma,
   mma_sync, wgmma) first held against ``flash_ref`` as phase 5 holds it and
   against ``flash_lse`` (``ref.LSE_TOL``); then the wgmma and the mma_sync
   backward on the same inputs, SDPA's backward (fwd+bwd minus fwd) and the
   plain version timed in turns at the training shape, (8, 2048, 16, 8, 128)
   and (4, 4096, 16, 8, 64), each beside its bound; (c)
   ``train_loop`` of qwen3-1.7b at full width in bf16, B = 4 and S = 4096
   (``SHAPES["train_4k"]``'s sequence, its global batch of 256 cut to 4),
   batches from ``data/pipeline``, one warm-up step and 3 timed, with every
   count zeroed just before and read just after each step: 56 flash forward
   launches (28, and 28 in the remat recompute, all wgmma), 28 backward
   launches, all wgmma, no plain call, every loss and grad norm finite; per
   step loss, grad norm, lr, fenced step seconds, tokens/s and peak memory;
   model FLOPs over the bf16 peak; one more step under ``torch.profiler`` by
   category; the forward's o and LSE (of the remat recompute) and the
   backward on the q/k/v/o/dO/LSE that layers 0 and 27 gave them in the
   warm-up step against their plain versions; (b) at the reduced width in
   float32, first-step gradients (1e-3 of max |CPU| a leaf) and three train
   steps' losses (1e-4 relative) on the card against the CPU from one
   state; (d) ``python -m repro_torch.launch.train --reduced --steps 6
   --ckpt-every 3`` on the card uninterrupted and, in a second process
   started beside it, SIGKILLed after step 4; then rerun: it resumes from
   step 3 with the same batches, and steps 4-6 and the final state are
   bitwise the uninterrupted run's (phase 5c's serve_solve round trip runs
   beside it, its processes started with these); (e) ``train_loop``
   of that ``--reduced`` configuration in bf16 (head dim 16) at the CLI's
   --seq 256 --batch 8, two steps, each counted: every flash forward and
   backward launch on the mma_sync routes, no plain call; the forward's o
   and LSE and the backward (route asserted, bitwise repeated) on the
   inputs the first and last layers gave the backward in step 1, against
   their plain versions; the mma_sync backward timed on the last layer's,
   beside SDPA's backward, the plain version and the bound: its JSON
   entry's numbers, all at this shape;
10. the attention families without experts (``[serve]``, ``[train]``,
   ``[compression]`` and ``[time]`` lines, each beside the card's name and
   power limit): granite-8b, qwen3-32b, qwen1.5-32b, qwen2-vl-7b and
   musicgen-medium at full width in bf16, each served through the same
   counted run as phase 6 (``serve_full_width``): ``ServeEngine`` draws the
   seeded weights on the card (``init_params``' peak must stay within the
   weights plus one leaf's f32 draw), 2048 prompt tokens and 32 new for the
   largest batch of (8, 4, 2, 1) whose reckoned peak (weights, KV cache,
   prefill transients; printed) leaves 3 GB of the free memory (qwen1.5-32b's
   MHA cache cuts it to 2), n_layers wgmma flash launches per prefill batch
   and no plain call, and the kernel held against its plain version on the
   warm-up's first and last layers' q/k/v (qwen2-vl-7b with zero vision
   embeddings over 256 positions and M-RoPE; musicgen-medium with (2048, 4)
   codebook prompts); each reduced configuration in f32 on the card against
   the CPU (tokens and logits as phase 6; first-step gradients and three
   steps' losses as 9(b)); musicgen-medium trained at full width as 9(c)
   (B = 4 by the printed reckoning, S = 4096; 96 forward and 48 backward
   launches a step, all wgmma at D = 64, no plain call; MFU through
   ``launch/roofline.py::model_flops_estimate``); gradient compression
   (``int8_compress`` and ``topk_compress`` on the card bitwise as on the
   CPU; one reduced train step with an int8 ``grad_transform``, card
   against CPU: loss, levels, parameters); the wgmma forward at each serve
   shape beside SDPA, the plain version and the bound, and the backward at
   musicgen's training shape beside SDPA's backward;
11. the mixtures of experts (``[serve]``, ``[train]``, ``[moe]`` and
   ``[time]`` lines, each beside the card's name and power limit):
   olmoe-1b-7b at full width and depth in bf16 served as phase 10 (8 x 2048
   prompt tokens + 32 new; the batch reckoning counts the MoE's capacity
   buffers, assignment rows and one-hot, ``ffn_transients``); mixtral-8x7b
   at full width with its layers cut to the most that a printed reckoning
   fits for both of its request sets, served 8 x 2048 + 32 and 1 x 8192 +
   32 (past its 4096 window: the wgmma forward applies the window, prefill
   fills the rolling cache, decode runs past it), each counted (n_layers
   wgmma launches a prefill batch, 0 plain, the kernel held against its
   plain version on the first and last layers' q/k/v); each reduced
   configuration in f32 card against CPU (tokens and logits, first-step
   gradients and three steps' losses, every layer's expert ids and, at
   capacity factor 0.25, its dropped assignments identical) and
   ``moe_apply`` forward and backward on the card under sync debug mode
   "error"; one reduced olmoe train step in bf16, at capacity factors 1.25
   and 0.25, twice from one state: bitwise equal loss, gradients,
   parameters and moments; olmoe-1b-7b trained as 9(c) with its layers cut
   by a printed reckoning (B = 4, S = 4096; 2L forward and L backward
   launches a step, all wgmma, 0 plain; the profile with the MoE dispatch
   and combine as entries of their own); the wgmma forward at (8, 2048, 16,
   16, 128), (8, 2048, 32, 8, 128) and (1, 8192, 32, 8, 128) window 4096
   beside SDPA (a band mask under the window), the plain version and the
   bound, and the backward at (4, 4096, 16, 16, 128) beside SDPA's
   backward;
12. Mamba2 and the zamba2 hybrid (``[serve]``, ``[train]``, ``[ssm]`` and
   ``[time]`` lines, each beside the card's name and power limit):
   zamba2-2.7b (54 Mamba2 layers, a weight-shared attention+MLP block after
   each group of 6, head dim 80) at full width and depth in bf16, served as
   phase 10 (8 x 2048 prompt tokens + 32 new, the batch from the printed
   reckoning: weights, shared KV cache, Mamba2 states, the chunked scan's
   transients), counted: 9 wgmma flash launches a prefill batch, 0
   mma_sync, 0 plain, the kernel held against its plain version on the first and last
   shared applications' q/k/v; its reduced configuration and a reduced
   plain Mamba2 stack in f32 card against CPU (tokens and logits,
   first-step gradients and three steps' losses); a reduced zamba2 forward
   and backward under sync debug mode "error" and a reduced bf16 zamba2
   step twice from one state, bitwise, counted together (head dim 16: the
   mma_sync routes); zamba2-2.7b trained as 9(c) (B = 4, S =
   4096, its depth cut to 24 layers, 4 of its 9 groups; 8 forward and 4
   backward flash launches a step on wgmma, 0 mma_sync, 0 plain; MFU
   counting every application of the shared block; the profile with the
   scan and the conv as entries of their own); the wgmma and mma_sync
   forwards at (8, 2048, 32, 32, 80) and (4, 4096, 32, 32, 80) in turns
   with SDPA, beside the plain version and the bound, and both backwards
   at (4, 4096, 32, 32, 80) beside SDPA's backward;
13. xLSTM (``[serve]``, ``[train]`` and ``[xlstm]`` lines, each beside the
   card's name and power limit): xlstm-125m (12 layers at d_model 768, 4
   heads; sLSTM blocks at 5 and 11, mLSTM blocks elsewhere at d_inner 1536,
   head dim 384, chunk 256) at full width and depth in bf16, served as
   phase 10 (8 x 2048 prompt tokens + 32 new, the batch from the printed
   reckoning: weights, the mLSTM's matrix memories and the sLSTM's carries,
   the chunked scan's transients), counted: no flash launch and no plain
   call; its reduced configuration in f32 card against CPU (tokens and
   logits, first-step gradients and three steps' losses); a reduced
   forward and backward under sync debug mode "error" and a reduced bf16
   step twice from one state, bitwise, counted together (no launch);
   xlstm-125m at full width, its depth cut to its first 6 layers (the
   sLSTM at 5, mLSTM blocks before it), trained as 9(c) at S = 4096, its
   global batch of 256 cut to the largest of (16, 8, 4) that the printed
   reckoning fits (0
   flash launches; MFU through ``model_flops_estimate`` and, beside it,
   with N counted from the parameters built plus the mLSTM's chunked
   products; the profile with ``xlstm.mlstm`` and ``xlstm.slstm`` as
   entries of their own; the device's idle share).
14. the solver side over a scenario mesh of virtual devices on the card
   (repeated ``cuda:0`` entries; ``[dd]``, ``[mesh batched]``, ``[mesh
   service]``, ``[mesh restore]`` and ``[mesh cli]`` lines): (a) the
   domain-decomposed PAop (``core/paop_dd.py``) at beam_p8_51m (51.17M
   DoFs, f32) on 4 devices, a 2x2 grid of 64x8x16 elements a shard, held
   to the global ``paop_cuda`` apply, counted (4 PAop launches an apply, no
   plain call), and timed beside the card's name and power limit: the DD
   apply fenced, the halo rounds' share by CUDA events, the global apply;
   the shards queue on one card, so no number says anything of traffic
   between cards; (b) the DD in f64 at phase 4's size on 1, 2 and 4
   devices at rtol 1e-11; (c) phase 5's batch with ``mesh`` of 2 and 4
   devices against the unsharded solver (iterations, flags, solutions to
   1e-12 of max |x|, host syncs of prepare and of every chunk equal) and
   each one's ``solve()`` wall time; (d) phase 5b's service on 2 devices,
   generational and continuous, against the unsharded runs, then a
   checkpoint on 2 devices restored onto 1 (to 1e-12 of max |x|; whether
   bitwise is printed) and a 3-row flight restored onto 2 (the re-bucket
   branch: the row kept in place bitwise, the moved row within 1e-12);
   (e) ``serve_solve --devices`` past the
   host's cards raises, naming the count.
15. the LM side on a (data, model) mesh of virtual devices of the card
   (``[lm mesh]`` lines; the shards queue on one card, so no number says
   anything of traffic between cards): (a) phase 9's cell (qwen3-1.7b at
   full width and depth, bf16, B = 4, S = 4096) through
   ``train_loop(mesh=make_local_mesh(2, devices=("cuda:0",) * 4))``, its
   memory reckoning printed, step 1 run twice from one state (bitwise),
   then one warm-up and three timed steps, each counted (4 x (2L + L) wgmma
   flash launches, no plain call), the losses held to phase 9's, and one
   more step profiled (the collectives' share); (b) olmoe-1b-7b: one full-width MoE layer
   expert parallel on (2, 2) against ``moe_apply`` on each data row's
   rows (ids identical), then the model at the depth its mesh reckoning
   allows, two steps, the loss with the global aux against the unsharded
   forward's and the share of equal expert ids printed, and the same
   reduced in f32; (c) ``pipeline_apply`` of qwen3-1.7b's 28 blocks as 4
   stages of 7 on 4 virtual devices, 8 microbatches of 1 x 2048, bitwise
   equal to the sequential apply, both timed, the bubble fraction
   printed; (d) (a)'s cell at full width with its depth cut to
   LM_RESTART_LAYERS, trained on (2, 2) through ``train_loop`` with a
   gathered checkpoint; 2 of its 4 devices fail, ``elastic_remesh`` gives
   (1, 2), the checkpoint is restored and resharded onto it and stepped
   twice: bitwise equal to the final state resharded in memory and
   stepped the same, within 2^-8 of its own continuation on (2, 2); (e) a mesh naming one card
   more than the host has raises, naming the count; (f) (a)'s cell with
   the reference's specs, ``make_train_step(mesh=,
   act_spec=act_pspec(axes), logits_spec=P(dp, None, "model"))``
   (sequence parallelism and the vocab-parallel CE): step 1 run twice
   from one state (bitwise), then three timed steps after it, each
   counted (4 x (2L + L) wgmma flash launches, no plain call), the
   losses held to phase 9's and (a)'s, step s and the peak beside (a)'s,
   one more step profiled (the ``collective.*`` ranges' share); (b)'s
   full-width MoE layer also runs on blocks of positions gathered along
   the sequence, its expert ids identical to (b)'s; (g) the recurrent
   mixers tensor parallel by heads (``[mixer tp]`` lines, and a ``[wall]
   phase 15 (g)`` line): zamba2-2.7b at full width cut to 6 of 54 layers
   (one group and one application of the shared block), bf16, B = 4, S =
   4096, on (a)'s (2, 2) mesh with (f)'s specs: step 1 twice from one
   state (bitwise), two timed steps and one profiled, each counted (4 x
   (2 + 1) D = 80 wgmma flash launches, no plain call), the mixers asserted
   to have run on H / M heads, the losses within 2^-8 of the same model's
   two unsharded steps on the card, step s, the peak and the ``mamba.ssd``,
   ``mamba.conv`` and ``collective.*`` ranges' device ms, the summed SSD
   time beside its prediction from phase 12's; xlstm-125m at full width
   cut to 6 of 12 layers on (1, 2), B = 16, S = 256, two steps against the
   unsharded ones the same way.
16. the cell grid and serving on a mesh (``[mesh serve]``, ``[cells]``,
   ``[dryrun]`` and ``[roofline]`` lines, each beside the card's name and
   power limit): (a) phase 6's requests (qwen3-1.7b, bf16, 8 x 2048 + 32)
   through ``mesh_prefill`` and ``mesh_decode_step`` on phase 15's (2, 2)
   mesh of virtual devices, counted (4 x 28 wgmma flash launches, no plain
   call), a repeated prefill bitwise equal, every step's logits
   teacher-forced on phase 6's tokens within ``MESH_SERVE_TOL`` of max
   |logit| of phase 6's and the greedy tokens equal where phase 6's top-2
   margin exceeds it, prefill s, decode s a step and the peak; (b) the
   three elasticity cells (``launch/cells.py``) in f32 through
   ``paop_cuda`` on a (1, 1) mesh of the card and ``beam_p8_51m:dd`` on
   four virtual devices, counted, each against ``ElasticityOperator``'s
   apply, timed and placed against its dry-run bound; (c) the dry-run
   CLI (``launch/dryrun.py``) of ``DRYRUN_CELLS`` on the meta production
   meshes, one process at a lower priority with no card visible, started
   after the build and run beside phases 3-15 (a trace runs on the host
   alone); (d) phase 15's (2, 2) train cell dry-run on meta devices (with
   the reference's specs: the step of 15(f)), its peak a device x 4
   beside 15(f)'s and 15(a)'s measured peaks; the dry-run and
   roofline tables of every record.  The wall time of each phase is
   printed (``[wall]`` lines).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import SHAPES, ShapeConfig, get_config, get_reduced  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.core.basis import basis_tables  # noqa: E402
from repro_torch.core.flops import dense_gemm_flops_per_elem, paop_flops_per_elem  # noqa: E402
from repro_torch.kernels.flash_attention import build as flash_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    BWD_ROW_REL, BWD_TOL, LSE_TOL, flash_bwd_errors, flash_bwd_ref, flash_lse, flash_ref)
from repro_torch.kernels.pa_elasticity import build, ops  # noqa: E402
from repro_torch.kernels.pa_elasticity.ref import paop_ref, probe_ref  # noqa: E402
from repro_torch.launch.solve import solve_beam  # noqa: E402
from repro_torch.launch.serve_solve import make_workload as serve_workload  # noqa: E402
from repro_torch.launch.workload import make_workload  # noqa: E402
from repro_torch.obs import MetricsRegistry, SpanRecorder, diff_snapshots  # noqa: E402
from repro_torch.profiling import device_time_by_category, print_profile  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import make_train_step, train_state_init  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    LOSS_CHUNK, _leaves, _tree_map, attention_layers, loss_fn, param_shapes)
from repro_torch.distributed.compression import (  # noqa: E402
    int8_compress, int8_decompress, topk_compress)
from repro_torch.models import attention as attention_module  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models import ssm as ssm_module  # noqa: E402
from repro_torch.models import transformer as transformer_module  # noqa: E402
from repro_torch.models.transformer import forward as model_forward  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve import elasticity_service  # noqa: E402
from repro_torch.serve.chunk_policy import SchedulerTrace, make_chunk_policy  # noqa: E402
from repro_torch.serve.elasticity_service import ElasticityService  # noqa: E402
from repro_torch.serve.recovery import ServiceRecovery  # noqa: E402
from repro_torch.checkpoint.manager import _crc32  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, ServeStats  # noqa: E402
from repro_torch.core.geometry import MATERIALS_BEAM  # noqa: E402
from repro_torch.solvers.batched import BatchedGMGSolver, bpcg_result  # noqa: E402
from repro_torch.core.paop_dd import SlabDecomposition  # noqa: E402
from repro_torch.distributed.sharding import gather_scenario  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    P, LMMesh, Sharded, act_pspec, dp_axes, mesh_all_gather, mesh_block, param_pspecs, place,
    state_pspecs)
from repro_torch.distributed.elastic import (  # noqa: E402
    elastic_remesh, reshard_state, simulate_failures)
from repro_torch.distributed.pipeline import (  # noqa: E402
    bubble_fraction, pipeline_apply, split_stages)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.report import (  # noqa: E402
    load_records, measured_fraction, render_dryrun, render_roofline, terms_of)
from repro_torch.models.transformer import mesh_decode_step, mesh_prefill  # noqa: E402
from repro_torch.launch.train import _host_like  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.train.trainer import _requires_grad  # noqa: E402
from repro_torch.models.transformer import _block_x as model_block  # noqa: E402
from repro_torch.models.transformer import _positions as model_positions  # noqa: E402
from repro_torch.models.transformer import _unstack as model_unstack  # noqa: E402
from repro_torch.serve.elasticity_service import SolveRequest  # noqa: E402
from repro_torch.solvers.coarse import (  # noqa: E402
    assembled_coarse_matrix, cholesky_solver, make_coarse_solver, probe_coarse_matrix)
from repro_torch.solvers.gmg import hierarchy_spaces  # noqa: E402
from repro_torch.fem.mesh import beam_hex  # noqa: E402
from repro_torch.configs.elasticity import ELASTICITY_SHAPES  # noqa: E402
from repro_torch.core.fa import fa_memory_bytes  # noqa: E402
from repro_torch.core.operators import ASSEMBLY_LEVELS, ElasticityOperator  # noqa: E402
from repro_torch.fem.space import H1Space  # noqa: E402
from repro_torch.launch.roofline import H100_SXM, model_flops_estimate, place_measured  # noqa: E402
from repro_torch.obs.throughput import operator_throughput  # noqa: E402

# H100 SXM data sheet: HBM3 rate, and the peak rates used for the bound
# (f64 and bf16 with the tensor cores; f32 outside them).
MEM_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_FLOPS = {dt: H100_SXM.peak(dt) for dt in (torch.float64, torch.float32, torch.bfloat16)}
# The tests' tolerances (docs/KERNELS.md): rtol, and atol as a fraction
# of max |plain|.
TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-4, 2e-5),
       # bfloat16: the kernel and its plain version sum in other orders
       # in f32, so a value may round to its neighbouring bfloat16.
       torch.bfloat16: (0.0, 2.0 ** -7)}
DT_TAG = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
MAIN_P, MAIN_REFINE = 4, 4
PA_TIME_P = (2, 4, 8)  # orders timed at the fine level's NE, in f64
SEED = 0
# Flash attention: absolute tolerances of tests/test_flash_kernel.py on
# unit-normal inputs; (B, S, H, K, D, window) cases held against the plain
# version, and the serve path's shape.
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16 is also held row by row, ||o - ref|| / ||ref|| over each (b, s, h)
# row of D values, which scales with the values compared: late causal rows
# average many keys and are small.  Rounding p and o to bf16 reads a few
# 1e-3; a dropped or mis-rescaled tile of 64 keys on a row of n keys reads
# about sqrt(64 / n), 0.18 at n = 2048.
FLASH_ROW_REL = 1e-2
FLASH_CASES = [
    (2, 128, 4, 2, 16, None),  # the shapes of tests/test_flash_kernel.py
    (1, 256, 8, 8, 32, None),  # MHA
    (2, 64, 8, 1, 8, None),  # MQA
    (1, 512, 4, 2, 64, None),
    (1, 128, 4, 4, 32, None),
    (2, 128, 4, 2, 16, 16),  # windows
    (2, 128, 4, 2, 16, 48),
    (2, 128, 4, 2, 16, 128),
    (2, 1, 16, 8, 128, None),  # ragged S
    (2, 7, 16, 8, 128, None),
    (2, 100, 16, 8, 128, None),
    (1, 1000, 16, 8, 128, 128),
    (2, 300, 8, 8, 128, None),  # the wgmma route: MHA, MQA, windows, D = 64
    (2, 300, 8, 1, 128, 128),
    (1, 384, 8, 2, 64, 48),
    (2, 2048, 4, 2, 64, None),
    (8, 256, 4, 2, 16, None),  # the train CLI's --reduced model (phase 9e)
    # phase 10's (H, K, D): granite-8b (G = 4), qwen3-32b (G = 8), qwen1.5-32b
    # (MHA), qwen2-vl-7b (G = 7), musicgen-medium (MHA at D = 64)
    (1, 300, 32, 8, 128, None),
    (2, 200, 64, 8, 128, None),
    (1, 300, 40, 40, 128, None),
    (2, 300, 28, 4, 128, 128),
    (2, 300, 24, 24, 64, None),
]
# The serve path: qwen3-1.7b, 8 requests of 2048 prompt tokens, 32 new.
SERVE_ARCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = "qwen3-1.7b", 8, 2048, 32
FLASH_MAIN = (SERVE_REQUESTS, SERVE_PROMPT, 16, 8, 128)  # (B, S, H, K, D)
SMALL_SERVE_PROMPTS = (5, 9, 3, 12, 7)
SMALL_SERVE_REL = 1e-4  # card vs CPU logits, of max |logit| (f32)
# The batched solve path: S = 8 rows, the reference's serve_solve --max-batch
# default, at its --rel-tol default; rows 0 and 4 (a dict and a field) are
# held against solve_beam.
BATCH_S, BATCH_BASE_TOL, BATCH_CHECK_ROWS = 8, 1e-6, (0, 4)
# The solve service: 16 requests of the same traffic (serve_solve's example
# --n-requests 16 --max-batch 8), continuous chunks of 8 (its default);
# four requests keep their solutions for the continuous-vs-generational check.
SERVICE_N, SERVICE_CHUNK, SERVICE_KEEP = 16, 8, (0, 4, 8, 12)
# Recovery: phase 5b's fixed run checkpointed every 2 steps (the last 2
# kept), crashed inside step 4 right after its chunk launch, restored
# from step 3; the watchdog's timeout is well below one step.  The CLI's
# SIGKILL/--resume round trip runs at a small size.
RECOVERY_EVERY, RECOVERY_KEEP, RECOVERY_CRASH_STEP, RECOVERY_WATCHDOG_S = 2, 2, 4, 1e-3
RECOVERY_CLI = ["--p", "2", "--refine", "1", "--n-requests", "6", "--max-batch", "4",
                "--chunk-iters", "2"]
# The ablation (phase 8).  Matrix-free levels swept at p = 1..8, S = 1, f64,
# each p at the refinement that gives the paper's 6,502,275 DoFs (p = 1, 2,
# 4, 8; beam_p2_6m and beam_p8_6m of configs/elasticity.py) or the one
# nearest it (p = 3, 5, 6, 7); beam_p8_51m for three levels.
ABLATION_LEVELS = ("pa_baseline", "pa_sumfact", "pa_sumfact_voigt", "paop", "paop_cuda")
ABLATION_REFINE = {1: 6, 2: ELASTICITY_SHAPES["beam_p2_6m"].n_h_refine, 3: 4, 4: 4, 5: 4,
                   6: 3, 7: 3, 8: ELASTICITY_SHAPES["beam_p8_6m"].n_h_refine}
ABLATION_51M = ("pa_baseline", "pa_sumfact_voigt", "paop_cuda")
# FA at the paper's 839,619 DoFs (p -> refinement); it runs where its
# analytic bytes fit a tenth of the card's memory: the host's scipy
# assembly and the padded ELL copy on the card grow with them.
ABLATION_FA = {1: 5, 2: 4, 4: 3, 8: 2}
FA_RUN_SHARE = 0.1
ABLATION_CHECK_REFINE = {1: 1, 2: 1, 4: 0, 8: 0}  # small beams of check (a)
ABLATION_PROFILE_P = (1, 4, 8)  # where an apply's device time goes, per level
# The paper's Table 4 on the card: (p, refine) -> levels, iterations equal
# within each size.
TABLE4 = {(MAIN_P, MAIN_REFINE): ("pa_baseline", "pa_sumfact_voigt", "paop_cuda"),
          (2, 4): ("fa", "paop_cuda")}


# Training (phase 9): qwen3-1.7b at full width in bf16, train_4k's sequence
# with its global batch of 256 cut to 4 so that one card holds the step; one
# warm-up step and 3 timed (phases 10-13 and 15(a) take as many).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_STEPS = "qwen3-1.7b", 4, 4
TRAIN_SEQ = SHAPES["train_4k"].seq_len
FLASH_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128)  # (B, S, H, K, D)
# The backward kernel against its plain version (B, S, H, K, D, window):
# S = 1, 77, 300, 1024; G = 1, 2 (and MQA); a window; D = 16, 64, 128.
BWD_CASES = [
    (2, 1, 4, 2, 64, None),
    (2, 77, 4, 2, 16, None),
    (1, 77, 2, 1, 128, None),
    (1, 300, 4, 4, 64, None),
    (2, 300, 8, 4, 128, 48),
    (1, 300, 4, 2, 32, 16),
    (1, 1024, 16, 8, 128, None),
    (1, 1024, 8, 8, 64, 128),
    (1, 1024, 4, 2, 16, 256),
    (8, 256, 4, 2, 16, None),  # the train CLI's --reduced model (phase 9e)
    # phase 10's (H, K, D), as FLASH_CASES
    (1, 300, 32, 8, 128, None),
    (1, 200, 64, 8, 128, None),
    (1, 300, 40, 40, 128, None),
    (1, 300, 28, 4, 128, 48),
    (2, 300, 24, 24, 64, None),
]
# The backward routes timed in turns (wgmma, mma_sync on the same inputs,
# SDPA's backward, the plain version): the training shape, the serve shape
# and the training shape at D = 64.
BWD_TIME_SHAPES = [FLASH_TRAIN, (8, 2048, 16, 8, 128), (4, 4096, 16, 8, 64)]
# The train CLI's --reduced configuration in bf16 (head dim 16, both flash
# routes mma_sync) at its --seq and --batch defaults, counted in phase 9(e);
# the mma_sync backward's JSON entry is timed and held at its shape, on the
# inputs the run gave it.
TRAIN_REDUCED_SHAPE, TRAIN_REDUCED_STEPS = ShapeConfig("train CLI --reduced", "train", 256, 8), 2
# Tolerances and measure of a backward: ref.py's BWD_TOL, BWD_ROW_REL and
# flash_bwd_errors (f32 1e-4 of max |plain|; bf16 2e-2 of max and per row).
# The forward's o that each case feeds the backward is held to the forward
# tolerances first (flash_check), at the training shape too.
# Card against CPU at the reduced width in f32 (phase 9b).
TRAIN_SMALL_SHAPE = ShapeConfig("small", "train", 64, 2)
TRAIN_SMALL_LOSS_REL, TRAIN_SMALL_GRAD_REL = 1e-4, 1e-3
TRAIN_CLI = ["--reduced", "--steps", "6", "--ckpt-every", "3", "--log-every", "1"]
TRAIN_LINE = re.compile(r"\[train\] step +(\d+) loss (\S+) gnorm (\S+) lr (\S+) .* tokens crc32 (\S+)")
# Phase 10: the attention families without experts at full width in bf16.
# Each serves SERVE_PROMPT + SERVE_NEW tokens to the largest batch of
# SLICE_BATCHES whose reckoned peak (weights, KV cache, prefill's largest
# transients) leaves SLICE_SPARE bytes of the card's free memory (qwen1.5-32b's
# MHA cache cuts its batch); each reduced configuration holds card against
# CPU; musicgen-medium also trains at full width, train_4k's sequence with its
# global batch of 256 cut to the largest of SLICE_TRAIN_BATCHES that fits.
SLICE_ARCHS = ("granite-8b", "qwen3-32b", "qwen1.5-32b", "qwen2-vl-7b", "musicgen-medium")
SLICE_BATCHES, SLICE_SPARE = (8, 4, 2, 1), 3e9
SLICE_TRAIN_ARCH, SLICE_TRAIN_BATCHES = "musicgen-medium", (4, 2, 1)
# Phase 11: the mixtures of experts at full width in bf16.  olmoe-1b-7b serves
# 8 x (SERVE_PROMPT + SERVE_NEW) at full depth; mixtral-8x7b's 93 GB of weights
# do not fit the card, so its layers are cut to the most that the printed
# reckoning fits (with SLICE_SPARE to spare) for both of its request sets, 8 x
# (SERVE_PROMPT + SERVE_NEW) and 1 x (MOE_LONG_PROMPT + SERVE_NEW), the second
# past its 4096-token window.  olmoe-1b-7b trains at train_4k's sequence, its
# global batch cut to MOE_TRAIN_BATCH and its layers to the most that fit.
# Each reduced configuration holds card against CPU, also at MOE_DROP_CF,
# where assignments are dropped; a reduced train step repeats bitwise.
MOE_SERVE_ARCH, MOE_CUT_ARCH, MOE_LONG_PROMPT = "olmoe-1b-7b", "mixtral-8x7b", 8192
MOE_TRAIN_ARCH, MOE_TRAIN_BATCH, MOE_DROP_CF = "olmoe-1b-7b", 4, 0.25
# The flash kernels at the new shapes: (name, (B, S, H, K, D), window).
MOE_FLASH_TIMES = [("olmoe-1b-7b", (8, SERVE_PROMPT, 16, 16, 128), None),
                   ("mixtral-8x7b", (8, SERVE_PROMPT, 32, 8, 128), None),
                   ("mixtral-8x7b", (1, MOE_LONG_PROMPT, 32, 8, 128), 4096)]
MOE_BWD_SHAPE = (MOE_TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128)
# Phase 12: zamba2-2.7b (Mamba2 with a shared attention block every 6
# layers) at full width and depth in bf16, served 8 x (SERVE_PROMPT +
# SERVE_NEW), and trained at full width at train_4k's sequence, its global
# batch cut to SSM_TRAIN_BATCH and its depth to SSM_TRAIN_LAYERS (4 of its
# 9 groups); its reduced configuration and a reduced plain Mamba2
# stack card against CPU; a reduced zamba2 step repeated bitwise.  Its
# head dim of 80 (2560 / 32) takes the wgmma flash routes: held in phase 3
# at the serve and training shapes and a ragged S (the mma_sync kernels
# too, launched by name), both routes timed at the first two.
SSM_ARCH, SSM_TRAIN_BATCH, SSM_TRAIN_LAYERS = "zamba2-2.7b", 4, 24
D80_SERVE = (SERVE_REQUESTS, SERVE_PROMPT, 32, 32, 80)  # (B, S, H, K, D)
D80_TRAIN = (SSM_TRAIN_BATCH, TRAIN_SEQ, 32, 32, 80)
D80_SHAPES = [D80_SERVE, D80_TRAIN, (2, 333, 32, 32, 80)]
# Phase 13: xlstm-125m (mLSTM blocks, sLSTM at 5 and 11) at full width and
# depth in bf16, served 8 x (SERVE_PROMPT + SERVE_NEW), and at full width
# with its depth cut to its first XLSTM_TRAIN_LAYERS (one sLSTM block: the
# host launches every step of its recurrence, so a layer costs its share of
# the step and of the profiled step, where each launch is recorded) trained
# at train_4k's sequence, its global batch of 256 cut to the largest of
# XLSTM_TRAIN_BATCHES that the printed reckoning fits; its reduced
# configuration card against CPU; a reduced step with no host sync and one
# repeated bitwise.  No attention: no flash launch anywhere.
XLSTM_ARCH, XLSTM_TRAIN_BATCHES, XLSTM_TRAIN_LAYERS = "xlstm-125m", (16, 8, 4), 6
# The sLSTM's gradient at full width overflows f32 past ~1,000 positions, in
# the reference too (ROADMAP Queue 3): the S = 4096 run times the step, and
# a short run at XLSTM_FINITE_SEQ holds the losses finite and falling.
XLSTM_FINITE_SEQ, XLSTM_FINITE_BATCH, XLSTM_FINITE_STEPS = 256, 32, 4
# Gradient compression on the card: int8 and top-k of one tensor bitwise as
# on the CPU, and one reduced-width train step with int8 compression from
# one state (losses and parameters to 1e-4).
COMPRESS_REL, COMPRESS_TOPK_FRAC = 1e-4, 0.01
# Phase 14: the solver side over a scenario mesh of virtual devices on the
# one card (repeated "cuda:0" entries).  (a) the DD at the paper's 51.17M
# DoFs in f32 on DD_SHARDS shards, held to the global operator within
# DD_F32_TOL of max |y| (the two sum each shared node's element
# contributions in different orders); (b) in f64 at phase 4's size on
# DD_F64_SHARDS shards at tests/test_paop_dd.py's rtol; (c) phase 5's batch
# and (d) phase 5b's service on MESH_SIZES virtual devices, solutions within
# MESH_X_REL of max |x| and residuals within MESH_NORM_RTOL of the unsharded
# runs'; the sharded chunks counted in chunks of MESH_CHUNK iterations.
DD_SHAPE, DD_SHARDS, DD_F32_TOL, DD_F64_SHARDS, DD_F64_RTOL = "beam_p8_51m", 4, 1e-5, (1, 2, 4), 1e-11
MESH_SIZES, MESH_CHUNK, MESH_X_REL, MESH_NORM_RTOL = (2, 4), 8, 1e-12, 1e-8
# (d)'s restores at a small size: p=2, refine=1, chunks of 2.
MESH_RESTORE_P, MESH_RESTORE_REFINE = 2, 1
# Phase 15: the LM side on a (data, model) mesh of virtual devices of the
# card.  (a) phase 9's cell on a (2, 2) mesh: its losses against phase 9's
# within LM_MESH_LOSS_REL of each loss: the two runs differ only in the
# order and bf16 rounding of sums (a projection's two halves all-reduced,
# two data rows' gradients summed), and one bf16 rounding of the loss is
# 2^-8 of it; (b) olmoe-1b-7b on the same mesh at the depth its reckoning
# allows, one step's loss against the unsharded forward's to the same
# tolerance, the share of expert ids that agree printed (random-init gates
# are near uniform, so ids flip within the rounding of the router input),
# and one full-width MoE layer on the mesh against moe_apply on each data
# row's rows (ids identical, outputs within LM_MESH_LOSS_REL of max);
# (c) GPipe of qwen3-1.7b's 28 blocks as
# PIPE_STAGES stages; (d) (a)'s cell cut to LM_RESTART_LAYERS layers
# trained LM_RESTART_STEPS steps on (2, 2) with a gathered checkpoint of
# its whole state (the embedding and its moments most of it; at full
# depth the 17 GB written and read back through the temporary directory's
# disk took a minute of the phase), and restarted on the (1, 2) mesh left
# after 2 of its 4 devices fail; (f) (a)'s cell with the reference's
# act_spec and logits_spec, LM_SP_STEPS steps after the repeated first,
# its losses within LM_MESH_LOSS_REL of phase 9's and (a)'s; (g) tensor
# parallelism of the recurrent mixers by heads: zamba2-2.7b at full width,
# its depth cut to MIXER_TP_LAYERS (one group of Mamba2 layers and one
# application of the shared block), B = SSM_TRAIN_BATCH, S = TRAIN_SEQ, on
# (a)'s (2, 2) mesh with (f)'s specs, step 1 twice from one state, then
# MIXER_TP_TIMED timed steps and one profiled, its first MIXER_TP_REF
# losses within LM_MESH_LOSS_REL of the same model's unsharded steps on the
# card; xlstm-125m at full width cut to XLSTM_TRAIN_LAYERS on (1, 2), B =
# MIXER_TP_XLSTM_BATCH at S = XLSTM_FINITE_SEQ (its gradient is NaN at 4096,
# ROADMAP Queue 3), MIXER_TP_REF steps against the unsharded ones.
LM_MESH_DEVICES, LM_MESH_MP = ("cuda:0",) * 4, 2
LM_MESH_LOSS_REL = 2.0 ** -8
LM_MESH_RESUME_STEPS = 2
LM_RESTART_LAYERS, LM_RESTART_STEPS = 4, 2
LM_SP_STEPS = 3
MIXER_TP_LAYERS, MIXER_TP_TIMED, MIXER_TP_REF, MIXER_TP_XLSTM_BATCH = 6, 2, 2, 16
# (g)'s prediction, written before its first run: the profiled step's
# mamba.ssd device time summed over the four virtual devices over phase
# 12's at MIXER_TP_LAYERS / SSM_TRAIN_LAYERS of its layers (each device
# scans its data row's rows on H / M heads: the whole once, where the
# gathered-whole layout scanned it twice)
MIXER_TP_SSD_PREDICTED = (0.9, 1.2)
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 4, 8, 8, 2048
# Phase 16: the cell grid and serving on a mesh.  (a) phase 6's requests
# (qwen3-1.7b, bf16, 8 x 2048 + 32) through mesh_prefill and
# mesh_decode_step on phase 15's (2, 2) mesh of virtual devices,
# teacher-forced on phase 6's tokens: each step's logits within
# MESH_SERVE_TOL of max |logit| of phase 6's (bf16 products summed in
# another order: a projection's halves, the KV cache's two blocks of
# positions combined by log-sum-exp in f32 where phase 6 rounds the softmax
# to bf16 before PV; one bf16 rounding of a logit is 2^-8 of it), the
# greedy tokens equal wherever phase 6's top-2 margin exceeds that bound;
# (b) the elasticity cells at f32 through paop_cuda on a (1, 1) mesh of the
# card, and the DD cell on (2, 2) virtual devices, each within CELL_REL of
# max |y| of ElasticityOperator's apply, timed (fenced, median of
# CELL_ROUNDS) and placed against its dry-run bound; (c) the dry-run of
# DRYRUN_CELLS on the meta production meshes (traced beside phases 3-15 in
# a process of its own); (d) phase 15's (2, 2) train
# cell dry-run, its peak bytes a device x 4 beside phase 15's measured peak.
MESH_SERVE_TOL = 2.0 ** -5
CELL_SHAPES, CELL_REL, CELL_ROUNDS = ("beam_p2_6m", "beam_p8_6m", "beam_p8_51m"), 1e-5, 5
DD_CELL = "beam_p8_51m:dd"
# (c)'s cells, one of each kind that traces in seconds to a minute on the
# chip host (the CLI's run, PERF.md: elasticity beam_p8_51m ~3-4 s on each
# production mesh, qwen3-1.7b's decode_32k ~35-50 s on (16, 16); its
# train_4k takes 74-184 s and zamba2-2.7b's long_500k ~45-60 s, more than
# the script's time limit holds beside phases 1-15); the train kind is (d)'s
# (2, 2) cell.
DRYRUN_CELLS = {"single": [("elasticity", "beam_p8_51m", "paop_cuda"),
                           ("qwen3_17b", "decode_32k", "paop")],
                "multi": [("elasticity", "beam_p8_51m", "paop_cuda")]}
SERVE_RECORD: dict = {}  # phase 6's prompts, tokens and every step's logits
LM_MESH_PEAK: list = []  # phase 15(a)'s measured peak, GiB
LM_SP_PEAK: list = []  # phase 15(f)'s measured peak, GiB
TRAIN_HISTORY: dict = {}  # phase 9's (and every train_full_width run's) logged steps
TRAIN_PROFILE: dict = {}  # every train_full_width run's profiled step: (layers, ms by category)

# Where a train step's device time goes (phase 9c's profile): kernels by
# name, the optimizer by its record_function range.
TRAIN_TOP_KERNELS = 6  # kernels listed per category
TRAIN_CATEGORIES = {
    "flash forward": r"flash_fwd",
    "flash backward": r"bwd_(prep|dkdv|dq)",
    "GEMMs": r"gemm|nvjet|cutlass|xmma|cublas|sm80_|sm90_",
    "CE": r"SoftMax|softmax|nll_loss|cross_entropy",
}


_WALL = [time.perf_counter()]


def wall(phase: str) -> None:
    """Print the wall seconds since the last call (or the start)."""
    now = time.perf_counter()
    print(f"[wall] phase {phase}: {now - _WALL[0]} s", flush=True)
    _WALL[0] = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def ptxas_summary(log: str, smem_bytes=None, pa_config=None, bwd_smem_bytes=None) -> list[str]:
    """One line per kernel instantiation: registers and spills, the dynamic
    shared memory ``smem_bytes(D)`` gives for the wgmma forward and
    ``bwd_smem_bytes(which, D)`` for the wgmma backward's dkdv (0) and dq (1)
    kernels, and for the PAop kernels what ``pa_config(name, dtype, D)``
    (``KernelLibrary.config``) gives; then every ptxas warning that wgmma
    instructions were serialized."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if re.search(r"wgmma.*serializ", line):
            rows.append(f"  WARNING {line.strip()}")
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"pa_elasticity_(baseline_)?kernelI(d|f|13__nv_bfloat16)Li(\d+)E", name)
            f = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
            tc = re.search(r"flash_fwd_tc_kernelILi(\d+)ELi(\d+)E", name)
            wg = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELb([01])E", name)
            bw = re.search(r"(bwd_(?:dkdv|dq)_(?:tc|fma))ILi(\d+)E", name)
            bwg = re.search(r"bwd_(dkdv|dq)_wgmmaILi(\d+)E", name)
            prep = re.search(r"bwd_prepI(f|13__nv_bfloat16)Li(\d+)E", name)
            if bw:
                kind = "mma.sync, bf16" if bw.group(1).endswith("tc") else "FMA, f32"
                name = f"flash_attention backward {bw.group(1)}<D={bw.group(2)}> ({kind})"
            elif bwg:
                d = int(bwg.group(2))
                smem = (f", {bwd_smem_bytes(int(bwg.group(1) == 'dq'), d)} B dynamic shared "
                        f"memory" if bwd_smem_bytes else "")
                name = f"flash_attention backward bwd_{bwg.group(1)}_wgmma<D={d}> (wgmma, TMA{smem})"
            elif prep:
                dt = "f32" if prep.group(1) == "f" else "bf16"
                name = f"flash_attention backward bwd_prep<{dt}, D={prep.group(2)}> (delta)"
            elif wg:
                d = int(wg.group(1))
                smem = f", {smem_bytes(d)} B dynamic shared memory" if smem_bytes else ""
                lse = ", writes the LSE" if wg.group(2) == "1" else ""
                name = f"flash_attention<bf16, D={d}, BQ=BK=128> (wgmma, TMA{smem}{lse})"
            elif k:
                kname = "pa_elasticity_baseline" if k.group(1) else "pa_elasticity"
                dt = {"d": torch.float64, "f": torch.float32}.get(k.group(2), torch.bfloat16)
                d = int(k.group(3))
                name = f"{kname}<{str(dt)[6:]}, D={d}, Q={d + 1}>"
                if pa_config:
                    c = pa_config(kname, dt, d)
                    name += (f" ({c['threads']} threads, {c['elems']} elements, "
                             f"{c['smem_bytes']} B shared per block, "
                             f"{c['blocks_per_sm']} blocks per SM)")
            elif f:
                name = f"flash_attention<{'f32' if f.group(1) == 'f' else 'bf16'}, D={f.group(2)}, BK={f.group(3)}> (FMA)"
            elif tc:
                name = f"flash_attention<bf16, D={tc.group(1)}, BK={tc.group(2)}> (mma.sync)"
            elif "probe_kernel" in name:
                name = "probe"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill st/ld {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"  {name}: {m.group(1)} registers, {spill}")
            name, spill = None, ""
    return rows


def round_ms(fn, n: int) -> float:
    """Device time per call of ``n`` back-to-back calls of ``fn()`` between
    one pair of CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def event_ms(fns: dict, n: int, rounds: int, warmup: int = 2) -> dict[str, float]:
    """Median over ``rounds`` of :func:`round_ms` for each of ``fns``
    (name -> callable), the callables timed in turns within each round."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(round_ms(fn, n))
    return {name: statistics.median(t) for name, t in times.items()}


def pa_inputs(p: int, ne: int, dtype, gen: torch.Generator, offset: int = 0) -> tuple:
    """PAop inputs on the card: x, lam_w, mu_w in ``dtype`` (with ``offset``
    > 0 as views that start ``offset`` values into their storage), the
    tables in the kernel's table dtype for it (f32 for bfloat16)."""
    tb = basis_tables(p)
    d, q = tb.d1d, tb.q1d
    dev, tdt = "cuda", ops.TABLE_DTYPE[dtype]

    def at_offset(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    x = at_offset(torch.randn((ne, 3, d, d, d), generator=gen, dtype=dtype, device=dev))
    lam = at_offset(torch.rand((ne, q, q, q), generator=gen, dtype=dtype, device=dev) + 0.5)
    mu = at_offset(torch.rand((ne, q, q, q), generator=gen, dtype=dtype, device=dev) + 0.5)
    # A non-diagonal J^{-1}, as a linear_map mesh gives.
    jinv = torch.diag(torch.tensor([2.0, 3.0, 4.0], dtype=tdt, device=dev))
    jinv = jinv + 0.1 * torch.randn((3, 3), generator=gen, dtype=tdt, device=dev)
    B = torch.as_tensor(tb.B, dtype=tdt, device=dev)
    G = torch.as_tensor(tb.G, dtype=tdt, device=dev)
    return x, lam, mu, jinv, B, G


def compare(y, ref, dtype) -> tuple[float, float, bool]:
    """(max abs err, max rel err against max |ref|, within tolerance)."""
    rtol, atol_frac = TOL[dtype]
    if dtype == torch.bfloat16:
        y, ref = y.float(), ref.float()
    scale = float(ref.abs().max())
    diff = (y - ref).abs()
    ok = bool((diff <= atol_frac * scale + rtol * ref.abs()).all())
    err = float(diff.max())
    return err, err / scale if scale else err, ok


def paop_bound(args, y, p: int) -> tuple[float, str]:
    """Least time for one apply: the larger of bytes over the memory rate
    (each input read once, the output written once) and FLOPs over the
    peak rate of the dtype it computes in (f32 for bfloat16 storage)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y))
    flops = paop_flops_per_elem(p) * args[0].shape[0]
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[ops.TABLE_DTYPE[args[0].dtype]]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def host_us(fn, n: int = 200, warmup: int = 20) -> float:
    """Host time per call of ``n`` back-to-back calls of ``fn()``, in
    microseconds, with no sync inside (what a caller's thread pays to
    enqueue the call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def reset_all_counts() -> None:
    ops.reset_counts()
    flash_ops.reset_counts()


def expected_route(dt, D: int, pad: int) -> str:
    """The flash kernel each case must launch: bf16 at D in {64, 80, 128}
    with 16-byte rows takes wgmma, other bf16 at D >= 16 mma_sync, the rest
    fma."""
    if dt == torch.bfloat16 and D in flash_ops.WGMMA_D and pad == 0:
        return "wgmma"
    return "mma_sync" if dt == torch.bfloat16 and D >= 16 else "fma"


def all_counts() -> dict[str, tuple[int, int]]:
    both = {**ops.counts, **flash_ops.counts}
    return {k: (c.launches, c.plain_calls) for k, c in both.items()}


def flash_inputs(B, S, H, K, D, dtype, gen, pad: int = 0) -> tuple:
    """Unit-normal q, k, v; ``pad`` > 0 gives views of wider rows, whose
    strides are no multiple of 8 elements (the kernel's unaligned loads)."""
    q = torch.randn((B, S, H, D + pad), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, K, D + pad), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, K, D + pad), generator=gen, device="cuda").to(dtype)
    return q[..., :D], k[..., :D], v[..., :D]


def band_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal call scores: S(S+1)/2, or under a window
    W each query's min(i + 1, W) keys."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_bound(q, k, v, window=None) -> tuple[float, str]:
    """Least time for one causal call: the larger of bytes over the memory
    rate (q, k, v read once, o written once) and the band's operations,
    4 B H D x its (query, key) pairs, over the dtype's peak rate."""
    B, S, H, D = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * D * band_pairs(S, window)
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_check(o, ref, dt) -> tuple[float, float, bool]:
    """(max abs err, max per-row relative err, within tolerance)."""
    diff = o.float() - ref.float()
    abs_err = float(diff.abs().max())
    row_rel = float((diff.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(1e-30)).max())
    ok = abs_err <= FLASH_ATOL[dt] and (dt != torch.bfloat16 or row_rel <= FLASH_ROW_REL)
    return abs_err, row_rel, ok


def capture_flash_inputs(calls: set[int]) -> tuple[list, object]:
    """Wrap the attention module's kernel call to keep clones of the q, k,
    v of the given calls (0-based, in call order); returns the list they
    go into and the wrapped function, to put back."""
    kept, inner, seen = [], attention_module.flash_attention, [0]

    def keeping(q, k, v, *, window=None):
        if seen[0] in calls:
            kept.append((seen[0], q.clone(), k.clone(), v.clone(), window))
        seen[0] += 1
        return inner(q, k, v, window=window)

    attention_module.flash_attention = keeping
    return kept, inner


def record_logits(eng: ServeEngine) -> list:
    """Wrap the engine's host sampler to keep every step's logits."""
    seen, sample = [], eng._sample

    def recording(logits, temps):
        seen.append(logits.copy())
        return sample(logits, temps)

    eng._sample = recording
    return seen


def numpy_tree(tree):
    """A tree of tensors (dicts; the xLSTM's list of blocks, in index order)
    as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.cpu().numpy()


def init_transient(shapes) -> int:
    """init_params' largest transient in bytes: a top-level leaf's f32 draw
    (the embedding, the head; zamba2's shared block's weights beside their
    bf16 cast), or one layer's f32 draw of a stacked leaf beside its bf16
    cast (the xLSTM's list of blocks: a block's leaf, unstacked)."""
    per_layer = (lambda sh: sh) if isinstance(shapes["blocks"], list) else (lambda sh: sh[1:])
    return max([4 * math.prod(shapes[k]) for k in ("embed", "lm_head") if k in shapes]
               + [6 * math.prod(sh) for sh in _leaves(shapes.get("shared", {}))]
               + [6 * math.prod(per_layer(sh)) for sh in _leaves(shapes["blocks"])])


def ssm_line(cfg) -> str:
    """The Mamba2 (or xLSTM) widths of a recurrent configuration, for its
    [serve] and [train] lines."""
    if cfg.block_pattern == "attn":
        return ""
    d_in = cfg.ssm_expand * cfg.d_model
    if cfg.block_pattern == "xlstm":
        return (f" xlstm: sLSTM at {cfg.slstm_indices} (head dim {cfg.d_model // cfg.n_heads}), "
                f"mLSTM elsewhere (d_inner={d_in}, {cfg.n_heads} heads of {d_in // cfg.n_heads}, "
                f"conv={cfg.conv_width}, chunk={cfg.chunk_size})")
    shared = (f", a shared attention block every {cfg.shared_attn_every} layers"
              if cfg.block_pattern == "zamba2" else "")
    return (f" {cfg.block_pattern}: d_inner={d_in} ssm heads={d_in // cfg.ssm_head_dim} "
            f"head dim={cfg.ssm_head_dim} state={cfg.ssm_state} conv={cfg.conv_width} "
            f"chunk={cfg.chunk_size}{shared}")


def serve_full_width(cfg, batch: int, rng, card: str,
                     prompt: int = SERVE_PROMPT) -> dict[str, tuple[int, int]]:
    """A serve path at full width in bf16, counted (phases 6, 10, 11 and
    12): the engine draws seeded random weights on the card (the init's peak
    memory against the weights' bytes is printed: each stacked leaf is
    allocated once), then ``batch`` requests of ``prompt`` tokens (codebook
    models: (prompt, n_cb)) generate SERVE_NEW greedy tokens each,
    with every count zeroed just before and read just after: one flash
    launch per attention block (``attention_layers``: n_layers, zamba2's
    n_groups shared applications, none for xLSTM) per prefill batch, all on the route of
    the head dim (wgmma at 64, 80 (zamba2's) and 128), no plain
    call.  A 2-token warm-up at the same shapes (cuBLAS's first calls pick
    their kernels), its prompts cut to ``prompt`` - 32 i tokens so that the
    batch is left-padded to ``prompt``, keeps the q/k/v that the first and
    the last attention block give the kernel (after qk-norm and (M-)RoPE,
    as the model gives them); once the engine is freed, the kernel's output
    on them is held against the plain version (1e-2 per-row relative).
    Returns the counted run's counts."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, max_len=prompt + SERVE_NEW + 8, max_batch=batch, seed=SEED,
                      device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    shapes = param_shapes(cfg)
    weights = 2 * sum(math.prod(sh) for sh in _leaves(shapes))
    transient = init_transient(shapes)
    print(f"[serve] {cfg.name} init_params on the card: {init_s} s, peak "
          f"{init_peak / 1e9:.3f} GB over the weights' {weights / 1e9:.3f} GB (the largest "
          f"transient, one leaf's draw: {transient / 1e9:.3f} GB) ({card})")
    if init_peak > weights + transient + 2**28:
        raise SystemExit(f"{cfg.name}: init_params peaked at {init_peak} B, above the weights "
                         f"{weights} B and one leaf's draw {transient} B")
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, (prompt,) + cb).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for _ in range(batch)]
    n_attn, route = attention_layers(cfg), expected_route(torch.bfloat16, cfg.head_dim_, 0)
    kept, inner = capture_flash_inputs({0, n_attn - 1})
    try:
        eng.generate([Request(prompt=r.prompt[32 * i:], max_new_tokens=2)
                      for i, r in enumerate(reqs)])
    finally:
        attention_module.flash_attention = inner
    if len(kept) != min(n_attn, 2):
        raise SystemExit(f"serve warm-up kept the q/k/v of {len(kept)} blocks, expected "
                         f"{min(n_attn, 2)}")
    eng.stats = ServeStats()
    logits_seen = record_logits(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    eng.generate(reqs)
    serve_counts = all_counts()
    serve_routes = dict(flash_ops.route_launches)
    st = eng.stats
    print(f"[serve] {cfg.name} {cfg.dtype} L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} K={cfg.n_kv_heads} hd={cfg.head_dim_} vocab={cfg.vocab}"
          f"{f' codebooks={cfg.n_codebooks}' if cfg.n_codebooks else ''}"
          f"{f' vision tokens={cfg.n_vision_tokens}' if cfg.n_vision_tokens else ''}"
          f"{f' experts={cfg.n_experts} top_k={cfg.top_k} d_ff={cfg.d_ff}' if cfg.is_moe else ''}"
          f"{f' window={cfg.sliding_window}' if cfg.sliding_window else ''}"
          f"{ssm_line(cfg)}: "
          f"{len(reqs)} requests x {prompt} prompt tokens, {SERVE_NEW} new")
    print(f"[serve] {cfg.name} prefill {st.prefill_s} s ({st.prompt_tokens / st.prefill_s} "
          f"prompt tok/s, {st.prefill_batches} batches), decode {st.decode_s} s "
          f"({st.decode_tokens / st.decode_s} decode tok/s, {st.decode_steps} steps), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    print(f"[serve] {cfg.name} counts (launches, plain_calls): {serve_counts}; flash "
          f"launches per route: {serve_routes}")
    launches, plain = serve_counts["flash_attention"]
    want_routes = {**dict.fromkeys(flash_ops.ROUTES, 0), route: n_attn * st.prefill_batches}
    if launches != n_attn * st.prefill_batches or plain != 0 or serve_routes != want_routes:
        raise SystemExit(f"{cfg.name} serve path did not run only through the {route} flash "
                         f"kernel: launches={launches} plain_calls={plain} routes={serve_routes}, "
                         f"expected {n_attn} x {st.prefill_batches} batches on {route}")
    toks = [np.asarray(r.out_tokens) for r in reqs]
    if any(t.shape != (SERVE_NEW,) + cb or not ((0 <= t) & (t < cfg.vocab)).all() for t in toks):
        raise SystemExit(f"{cfg.name} serve path: a request did not get {SERVE_NEW} tokens "
                         f"in [0, vocab)")
    if not all(np.isfinite(lg).all() for lg in logits_seen):
        raise SystemExit(f"{cfg.name} serve path: non-finite logits")
    print(f"[serve] {cfg.name} req0 tokens: {reqs[0].out_tokens[:8]}...")
    if cfg.name == get_config(SERVE_ARCH).name:  # phase 6: phase 16(a) serves it on a mesh
        SERVE_RECORD[cfg.name] = (np.stack([r.prompt for r in reqs]), np.stack(toks),
                                  logits_seen)
    del eng, logits_seen
    gc.collect()
    torch.cuda.empty_cache()
    for layer, q, k, v, window in kept:
        o = flash_ops.flash_attention(q, k, v, window=window)
        ref = flash_ref(q, k, v, window=window)
        # The model's values are not unit-normal: only the per-row check.
        real_err, real_rel, _ = flash_check(o, ref, q.dtype)
        ok = real_rel <= FLASH_ROW_REL
        print(f"[flash vs plain] {cfg.name} serve attention block {layer} q/k/v "
              f"{tuple(q.shape)} "
              f"{str(q.dtype)[6:]}: max abs err {real_err:.3e} (max |ref| "
              f"{float(ref.float().abs().max()):.3e}), max row rel err {real_rel:.3e} "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            raise SystemExit(f"flash kernel disagrees with its plain version on {cfg.name} "
                             f"attention block {layer}'s prefill q/k/v: {real_rel}")
        del o, ref
    del kept
    torch.cuda.empty_cache()
    return serve_counts


def small_serve_check(arch: str, rng, **change) -> None:
    """The reduced configuration of ``arch`` (with ``change``'s fields) in
    f32 on the card against the CPU, same weights: greedy tokens equal,
    logits within SMALL_SERVE_REL of max |logit| (prompts lengthened by the
    VLM's vision positions)."""
    small_cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **change)
    weights = numpy_tree(init_params(torch.Generator().manual_seed(SEED), small_cfg))
    cb = (small_cfg.n_codebooks,) if small_cfg.n_codebooks else ()
    prompts = [rng.integers(0, small_cfg.vocab, (n + small_cfg.n_vision_tokens,) + cb)
               .astype(np.int32) for n in SMALL_SERVE_PROMPTS]
    small = {}
    for dev in ("cuda", "cpu"):
        seng = ServeEngine(small_cfg, params=lm_params(weights, small_cfg, device=dev),
                           max_len=32, max_batch=4, device=dev)
        seen = record_logits(seng)
        sreqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        seng.generate(sreqs)
        small[dev] = ([r.out_tokens for r in sreqs], seen)
    (tok_gpu, lg_gpu), (tok_cpu, lg_cpu) = small["cuda"], small["cpu"]
    lg_rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(lg_gpu, lg_cpu))
    print(f"[small serve] {small_cfg.name} f32, {len(prompts)} requests, max_batch 4: tokens "
          f"{'equal' if tok_gpu == tok_cpu else 'DIFFER'}, max logit diff {lg_rel:.3e} "
          f"of max |logit|")
    if tok_gpu != tok_cpu or lg_rel > SMALL_SERVE_REL:
        raise SystemExit(f"small serve of {small_cfg.name} on the card disagrees with the CPU")


def batched_scenarios() -> tuple[list, np.ndarray, np.ndarray]:
    """S = 8 requests of the reference's serve_solve workload (its
    ``make_workload``, copied in ``repro_torch.launch.workload``) at
    refine 4 and base_tol 1e-6: rows 0-3 with attribute dicts, rows 4-7
    with ``lognormal:SEED`` per-element fields; each row's traction and
    rel_tol (1e-8 for even rows, 1e-6 for odd) those of its request."""
    dicts, trs, tols = make_workload(BATCH_S, MAIN_REFINE, BATCH_BASE_TOL)
    fields, _, _ = make_workload(BATCH_S, MAIN_REFINE, BATCH_BASE_TOL, f"lognormal:{SEED}")
    half = BATCH_S // 2
    return dicts[:half] + fields[half:], trs, tols


def sync_sites(fn):
    """(fn(), {"file:line": count}): the synchronizing CUDA operations that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports while it runs, by the
    Python line that made each."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        for w in seen if "synchroniz" in str(w.message))


def count_syncs(fn):
    """(fn(), the host syncs it made), as :func:`sync_sites` counts them."""
    out, sites = sync_sites(fn)
    return out, sum(sites.values())


def small_batched_check() -> None:
    """p=2, refine=1, S=3 (dict, field, dict; rel_tol 1e-6, 1e-8, 1e-10) on
    the card and on the CPU from the same start vectors: iterations equal,
    solutions within 1e-10 relative.  On the card, chunks of 3 to the end
    equal one uninterrupted chunk bitwise, and a row refilled through
    prepare(reset_mask) + run_chunk(do_reset=True) leaves the other rows
    bitwise as they would be without it."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    rng = np.random.default_rng(SEED)
    ne = spaces[-1].nelem
    mats = [MATERIALS_BEAM, (rng.lognormal(0, 0.5, ne), rng.lognormal(0, 0.5, ne)),
            {1: (10.0, 5.0), 2: (2.0, 2.0)}]
    trs = np.array([[0.0, 0.0, -1e-2], [0.0, 1e-3, -2e-2], [0.0, 0.0, -5e-3]])
    tols = np.array([1e-6, 1e-8, 1e-10])
    gpu = BatchedGMGSolver(beam_hex(), 1, 2, device="cuda", start_vectors=sv)
    cpu = BatchedGMGSolver(beam_hex(), 1, 2, device="cpu", start_vectors=sv)
    a, b = gpu.solve(mats, trs, tols), cpu.solve(mats, trs, tols)
    diff = float((a.x.cpu() - b.x).abs().max()) / float(b.x.abs().max())
    print(f"[small batched] p=2 refine=1 S=3 iters card/cpu {a.iterations.tolist()}/"
          f"{b.iterations.tolist()}, max rel diff {diff:.3e}")
    if not torch.equal(a.iterations.cpu(), b.iterations) or diff > 1e-10 \
            or not bool(b.converged.all()):
        raise SystemExit("small batched solve on the card disagrees with the CPU")
    lam, mu = gpu.pack_materials(mats)
    ones = np.ones(3, bool)
    prep = gpu.prepare(lam, mu, ones, gpu.empty_prep(3))
    whole, _ = gpu.run_chunk(trs, tols, ones, gpu.empty_state(3), prep, gpu.maxiter,
                             do_reset=True)
    state, _ = gpu.run_chunk(trs, tols, ones, gpu.empty_state(3), prep, 3, do_reset=True)
    after3, chunks = state, 1
    while bool(state.active.any()):
        state, _ = gpu.run_chunk(trs, tols, ~ones, state, prep, 3)
        chunks += 1
    chunked_equal = all(torch.equal(getattr(state, f.name), getattr(whole, f.name))
                        for f in dataclasses.fields(state))
    mask = np.array([False, True, False])
    lam2, mu2 = gpu.pack_materials([mats[0], {1: (9.0, 9.0), 2: (1.0, 3.0)}, mats[2]])
    prep2 = gpu.prepare(lam2, mu2, mask, prep)
    refilled, _ = gpu.run_chunk(trs, tols, mask, after3, prep2, 4, do_reset=True)
    untouched, _ = gpu.run_chunk(trs, tols, ~ones, after3, prep, 4)
    kept_equal = all(
        torch.equal(getattr(refilled, f.name)[[0, 2]], getattr(untouched, f.name)[[0, 2]])
        for f in dataclasses.fields(refilled))
    prep_kept = all(torch.equal(o.reshape(3, -1)[[0, 2]], n.reshape(3, -1)[[0, 2]])
                    for key in ("lam_w", "mu_w", "dinv", "lmax")
                    for o, n in zip(prep[key], prep2[key]))
    print(f"[small batched] {chunks} chunks of 3 == one chunk, bitwise: {chunked_equal}; "
          f"row 1 refilled, rows 0 and 2 of prep and state bitwise kept: "
          f"{prep_kept and kept_equal}")
    if not (chunked_equal and kept_equal and prep_kept):
        raise SystemExit("batched chunks or refill are not bitwise on the card")


def batched_phase() -> tuple[dict[str, tuple[int, int]], list[int]]:
    """The batched solve path (phase 5); returns the counted run's
    (launches, plain_calls) per kernel and its per-row iterations."""
    n_coarse = hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)[0].nscalar * 3
    t_setup0 = time.perf_counter()
    bsolver = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="f64",
                               device="cuda")
    fine = bsolver.fine_space
    mats, trs, tols = batched_scenarios()
    torch.cuda.synchronize()
    t_cold0 = time.perf_counter()
    cold = bsolver.solve(mats, trs, tols)
    torch.cuda.synchronize()
    t_cold1 = time.perf_counter()
    print(f"[batched] cold: setup {t_cold0 - t_setup0} s, solve {t_cold1 - t_cold0} s")
    # The same rows one solve_beam at a time, as they are served without the
    # batched solver: after one untimed warm-up call, each call timed on the
    # host clock between synchronize fences.  Rows 0 and 4 are held against
    # the batch.
    solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda", materials=mats[0],
               traction=tuple(trs[0]), rel_tol=float(tols[0]))
    seq_wall, seq_solve, seq_iters = [], [], []
    for row in range(BATCH_S):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one = solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda",
                         materials=mats[row], traction=tuple(trs[row]),
                         rel_tol=float(tols[row]), keep_solution=row in BATCH_CHECK_ROWS)
        torch.cuda.synchronize()
        seq_wall.append(time.perf_counter() - t)
        seq_solve.append(one.t_solve)
        seq_iters.append(one.iterations)
        if row in BATCH_CHECK_ROWS:
            scale = float(one.x.abs().max())
            rdiff = float((cold.x[row] - one.x).abs().max()) / scale
            print(f"[batched] row {row} vs solve_beam: iters {int(cold.iterations[row])}/"
                  f"{one.iterations}, max diff {rdiff:.3e} of max |x|")
            if int(cold.iterations[row]) != one.iterations or rdiff > 1e-10:
                raise SystemExit(f"batched row {row} disagrees with solve_beam")
        del one
    torch.cuda.empty_cache()
    print(f"[batched] one warm solve_beam a row: iters {seq_iters}, wall {seq_wall} s "
          f"(sum {sum(seq_wall)} s), t_solve sum {sum(seq_solve)} s")
    # The folded coarse probe (one apply of n * S rows) beside a loop over
    # the n identity columns (n applies of S rows), on the prepared level.
    lam, mu = bsolver.pack_materials(mats)
    prep = bsolver.prepare(lam, mu, np.ones(BATCH_S, bool), bsolver.empty_prep(BATCH_S))
    op0 = bsolver._base_ops[0].with_material_weights(prep["lam_w"][0], prep["mu_w"][0],
                                                     BATCH_S)
    cop0, n0 = op0.constrained(), n_coarse
    eye = torch.eye(n0, dtype=torch.float64, device="cuda")

    def probe_loop():
        return torch.stack([cop0(eye[j].reshape(1, -1, 3).expand(BATCH_S, -1, 3)
                                 .contiguous()).reshape(BATCH_S, n0)
                            for j in range(n0)], dim=2)

    probe_diff = float((probe_coarse_matrix(op0) - probe_loop()).abs().max())
    probe_t = event_ms({"folded": lambda: probe_coarse_matrix(op0), "loop": probe_loop},
                       n=3, rounds=3)
    print(f"[batched] coarse probe S={BATCH_S} n={n0}, in turns, median of 3 rounds of 3: "
          f"folded {probe_t['folded']} ms, column loop {probe_t['loop']} ms, max abs diff "
          f"{probe_diff:.3e}")
    del prep, lam, mu, op0, cop0, bsolver
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bsolver = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="f64",
                               device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lam, mu = bsolver.pack_materials(mats)
    ones = np.ones(BATCH_S, bool)
    prep = bsolver.prepare(lam, mu, ones, bsolver.empty_prep(BATCH_S))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, _ = bsolver.run_chunk(trs, tols, ones, bsolver.empty_state(BATCH_S), prep,
                                 bsolver.maxiter, do_reset=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    batch_counts = all_counts()
    batch_peak = torch.cuda.max_memory_allocated()
    t_setup, t_prepare, t_solve = t1 - t0, t2 - t1, t3 - t2
    rel = (torch.sqrt(state.nom.abs()) / torch.sqrt(state.nom0.abs())).tolist()
    converged = (state.nom <= state.threshold).tolist()
    ndof = fine.ndof
    print(f"[batched] p={MAIN_P} refine={MAIN_REFINE} f64 S={BATCH_S}: {ndof} DoFs a row, "
          f"{BATCH_S * fine.nelem} elements through the kernel at the fine level")
    print(f"[batched] iters {state.iters.tolist()}, converged {converged}, final rel norms "
          f"{rel}, rel_tol {tols.tolist()}")
    print(f"[batched] warm: setup {t_setup} s, prepare {t_prepare} s, solve {t_solve} s; "
          f"{BATCH_S / (t_prepare + t_solve)} scenarios/s (prepare + solve), "
          f"{ndof * BATCH_S / t_solve} DoF*rows/s (solve), peak memory "
          f"{batch_peak / 2**30:.3f} GiB")
    print(f"[batched] counts (launches, plain_calls): {batch_counts}")
    t_batch = t_setup + t_prepare + t_solve
    print(f"[batched] against one warm solve_beam a row, same run: {BATCH_S / t_batch} "
          f"against {BATCH_S / sum(seq_wall)} scenarios/s (setup + prepare + solve "
          f"{t_batch} s, summed wall {sum(seq_wall)} s: {sum(seq_wall) / t_batch}x); "
          f"t_solve {t_solve} s against summed t_solve {sum(seq_solve)} s: "
          f"{t_solve / sum(seq_solve)}x")
    if not all(converged):
        raise SystemExit("batched solve: a row did not converge")
    for name in ops.counts:
        launches, plain = batch_counts[name]
        if launches == 0 or plain != 0:
            raise SystemExit(f"batched path did not run only through {name}: "
                             f"launches={launches} plain_calls={plain}")
    if not (torch.equal(state.x, cold.x) and torch.equal(state.iters, cold.iterations)):
        raise SystemExit("batched warm run differs from the cold solve")
    if not bool(torch.isfinite(state.x).all()):
        raise SystemExit("batched solution is not finite")
    batch_iters = state.iters.tolist()
    del state, prep, lam, mu, cold
    torch.cuda.synchronize()
    ts0 = time.perf_counter()
    res, syncs = count_syncs(lambda: bsolver.solve(mats, trs, tols))
    torch.cuda.synchronize()
    print(f"[batched] solve() under sync debug mode: {syncs} host syncs, "
          f"{int(res.iterations.max())} iterations for the slowest row, "
          f"{time.perf_counter() - ts0} s")
    del res
    # The same prepare + run_chunk under torch.profiler: device busy share
    # of each phase (each ends in a synchronize).
    lam, mu = bsolver.pack_materials(mats)

    def profiled():
        with record_function("batched.prepare"):
            prep = bsolver.prepare(lam, mu, ones, bsolver.empty_prep(BATCH_S))
            torch.cuda.synchronize()
        with record_function("batched.pcg"):
            bsolver.run_chunk(trs, tols, ones, bsolver.empty_state(BATCH_S), prep,
                              bsolver.maxiter, do_reset=True)
            torch.cuda.synchronize()

    print_profile(profiled, prefix="batched.")
    del lam, mu, bsolver
    torch.cuda.empty_cache()
    return batch_counts, batch_iters


def service_requests() -> list:
    """SERVICE_N requests of the reference's serve_solve traffic at
    p=MAIN_P, refine=MAIN_REFINE: request i has the traction and rel_tol of
    request i of its ``make_workload``; requests 0-3 and 8-11 carry
    attribute dicts, 4-7 and 12-15 ``lognormal:SEED`` fields (12-15 repeat
    4-7, so prep rows are reused); 0-7 are phase 5's batch.  The requests
    of SERVICE_KEEP keep their solutions."""
    dicts = serve_workload(SERVICE_N, [MAIN_P], MAIN_REFINE, BATCH_BASE_TOL)
    fields = serve_workload(SERVICE_N, [MAIN_P], MAIN_REFINE, BATCH_BASE_TOL,
                            f"lognormal:{SEED}")
    return [dataclasses.replace((fields if (i // 4) % 2 else dicts)[i],
                                keep_solution=i in SERVICE_KEEP)
            for i in range(SERVICE_N)]


def service_run(svc: ElasticityService, reqs: list, continuous: bool):
    """One counted run of the service (every count zeroed just before,
    read just after), between synchronize fences: (reports, seconds,
    counts, stats delta, scheduler summary of this run's decisions,
    latency quantiles of this run's requests)."""
    stats0, n0 = dict(svc.stats), len(svc.trace.decisions)
    snap0 = svc.registry.snapshot()
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports = svc.solve_continuous(reqs) if continuous else svc.solve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_counts()
    stats = {k: v - stats0[k] for k, v in svc.stats.items() if v != stats0[k]}
    run_trace = SchedulerTrace()
    for d in svc.trace.decisions[n0:]:
        run_trace.append(d)
    window = MetricsRegistry.from_snapshot(diff_snapshots(svc.registry.snapshot(), snap0))
    lat = window.merged_histogram("request_latency_seconds")
    latency = {f"p{round(q * 100)}": lat.quantile(q) for q in (0.5, 0.9, 0.99)}
    return reports, dt, counts, stats, run_trace.summary(), latency


def check_service_counts(tag: str, counts: dict, want_probe: bool) -> None:
    """The run went through the kernels alone: PAop launched (and the probe,
    where the run built a solver), no plain call."""
    for name in ops.counts:
        launches, plain = counts[name]
        if plain != 0 or (launches == 0 and (name == "pa_elasticity" or want_probe)):
            raise SystemExit(f"service {tag} run did not go only through {name}: "
                             f"launches={launches} plain_calls={plain}")


def check_same_as(tag: str, got: list, want: list) -> None:
    """Per request the same iterations and flags as ``want``, and kept
    solutions within 1e-10 of max |x|."""
    for g, w in zip(got, want, strict=True):
        if (g.iterations, g.converged, g.born_converged) != (w.iterations, w.converged,
                                                              w.born_converged):
            raise SystemExit(f"service {tag}: request {g.request} gave {g.iterations} "
                             f"iterations, converged {g.converged}; generational "
                             f"{w.iterations}, {w.converged}")
        if w.x is not None:
            scale = float(np.abs(w.x).max())
            diff = float(np.abs(g.x - w.x).max()) / scale
            if diff > 1e-10:
                raise SystemExit(f"service {tag}: a kept solution differs by {diff} of "
                                 f"max |x| from the generational run's")


def service_phase(batch_iters: list[int]) -> tuple[list, float]:
    """The solve service (phase 5b) on one ElasticityService, so that its
    solver stays warm between runs (the chunk policy is swapped between
    them): the generational path, the continuous path under the fixed and
    the adaptive chunk policy (the adaptive run with host syncs counted),
    and a continuous run under torch.profiler with a fencing
    SpanRecorder.  Returns the continuous fixed run's reports and wall
    seconds (phase 5c's undisturbed run), and the generational reports
    (phase 14's)."""
    t_phase = time.perf_counter()
    reqs = service_requests()
    svc = ElasticityService(max_batch=BATCH_S, precision="f64", chunk_iters=SERVICE_CHUNK,
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    gen, t_gen, counts, stats, _, latency = service_run(svc, reqs, continuous=False)
    t_setup = max(r.t_setup for r in gen)
    print(f"[service] p={MAIN_P} refine={MAIN_REFINE} f64, {SERVICE_N} requests, max_batch "
          f"{BATCH_S}, chunks of {SERVICE_CHUNK}; generational: iters "
          f"{[r.iterations for r in gen]}, {t_gen} s ({t_setup} s of it building the "
          f"solver), {SERVICE_N / (t_gen - t_setup)} scenarios/s without the build; "
          f"latency {latency}; counts {counts}; stats {stats}")
    check_service_counts("generational", counts, want_probe=True)
    if [r.iterations for r in gen[:BATCH_S]] != batch_iters:
        raise SystemExit(f"service generation 0 iterations {[r.iterations for r in gen[:BATCH_S]]}"
                         f" differ from phase 5's {batch_iters}")
    if not all(r.converged for r in gen):
        raise SystemExit("service generational: a request did not converge")
    t_gen_solve = t_gen - t_setup

    for policy in ("fixed", "adaptive"):
        svc.chunk_policy = make_chunk_policy(policy, chunk_iters=SERVICE_CHUNK)
        if policy == "adaptive":
            out, syncs = count_syncs(lambda: service_run(svc, reqs, continuous=True))
        else:
            out, syncs = service_run(svc, reqs, continuous=True), None
        cont, t_cont, counts, stats, sched, latency = out
        check_service_counts(f"continuous {policy}", counts, want_probe=False)
        check_same_as(f"continuous {policy}", cont, gen)
        if policy == "fixed":
            fixed_run = (cont, t_cont)
        print(f"[service] continuous {policy}: {t_cont} s, {SERVICE_N / t_cont} scenarios/s "
              f"({t_gen_solve / t_cont}x generational); latency {latency}; counts {counts}")
        print(f"[service] scheduler[{policy}]: chunks={sched['chunks']} mean_chunk="
              f"{sched['mean_chunk']} wasted_iters={sched['wasted_iters']} refills="
              f"{sched['refills']}; stats {stats}")
        if syncs is not None:
            print(f"[service] continuous {policy} under sync debug mode: {syncs} host syncs "
                  f"in {sched['chunks']} steps, {syncs / sched['chunks']} a step")
    print(f"[service] latency_summary() over the three runs: {svc.latency_summary()}")
    print(f"[service] peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    frozen = sum(max(r.iterations for r in gen[g:g + BATCH_S]) * BATCH_S
                 - sum(r.iterations for r in gen[g:g + BATCH_S])
                 for g in range(0, SERVICE_N, BATCH_S))
    print(f"[service] generational frozen row-iterations {frozen} of "
          f"{sum(r.iterations for r in gen) + frozen}")

    # A last fixed-policy run under torch.profiler, with a fencing span
    # recorder attached: the device's busy share, and the lifecycle spans.
    svc.chunk_policy = make_chunk_policy("fixed", chunk_iters=SERVICE_CHUNK)
    rec = SpanRecorder(fence=True)
    svc.attach_spans(rec)
    runs = []

    def profiled():
        with record_function("service.continuous"):
            runs.append(service_run(svc, reqs, continuous=True))

    t_prof = time.perf_counter()
    print_profile(profiled, prefix="service.", top=12)
    t_prof = time.perf_counter() - t_prof
    fenced, t_fenced, counts, _, _, _ = runs[0]
    check_service_counts("fenced", counts, want_probe=False)
    check_same_as("fenced", fenced, gen)
    waits = {s.args["ticket"]: s for s in rec.by_name("queue_wait")}
    worst = 0.0
    for sp in rec.by_name("solve"):
        a = sp.args
        wall = sp.end - waits[a["ticket"]].start
        worst = max(worst, abs(a["queue_wait"] + a["compute"] + a["overhead"] - wall))
    if len(rec.by_name("solve")) != SERVICE_N or worst > 1e-9:
        raise SystemExit(f"service spans: {len(rec.by_name('solve'))} solve spans, lifecycle "
                         f"identity off by {worst} s")
    span_sum = {name: sum(sp.duration for sp in rec.by_name(name))
                for name in ("chunk_dispatch", "chunk_device", "prep", "step")}
    trace_dir = tempfile.mkdtemp(prefix="service_trace_")
    rec.to_chrome_trace(os.path.join(trace_dir, "service.json"))
    shutil.rmtree(trace_dir)
    print(f"[service] profiled, fenced continuous run: {t_fenced} s ({t_prof} s with the "
          f"profile's processing), {rec.count()} spans, summed seconds {span_sum}; "
          f"queue_wait + compute + overhead == wall per ticket to {worst} s; Chrome trace "
          f"written to a temporary directory")
    print(f"[service] phase wall {time.perf_counter() - t_phase} s")
    del svc, fenced, runs
    torch.cuda.empty_cache()
    return (*fixed_run, gen)


def small_service_check() -> None:
    """p=2, refine=1, 6 requests, max_batch 4, continuous (chunks of 3) on
    the card and on the CPU from the same start vectors: iterations and
    flags equal, solutions within 1e-10 of max |x|."""
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    reqs = [dataclasses.replace(r, keep_solution=True)
            for r in serve_workload(6, [2], 1, BATCH_BASE_TOL, f"lognormal:{SEED}")[:3]
            + serve_workload(6, [2], 1, BATCH_BASE_TOL)[3:]]
    inner = elasticity_service.BatchedGMGSolver
    elasticity_service.BatchedGMGSolver = functools.partial(inner, start_vectors=sv)
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            svc = ElasticityService(max_batch=4, chunk_iters=3, device=dev)
            reset_all_counts()
            out[dev] = svc.solve_continuous(reqs)
            if dev == "cuda":
                check_service_counts("small", all_counts(), want_probe=True)
    finally:
        elasticity_service.BatchedGMGSolver = inner
    diff = max(float(np.abs(a.x - b.x).max() / np.abs(b.x).max())
               for a, b in zip(out["cuda"], out["cpu"]))
    print(f"[small service] p=2 refine=1, 6 requests, max_batch 4, continuous: iters card/cpu "
          f"{[r.iterations for r in out['cuda']]}/{[r.iterations for r in out['cpu']]}, "
          f"max rel diff {diff:.3e}")
    if [(r.iterations, r.converged) for r in out["cuda"]] != \
            [(r.iterations, r.converged) for r in out["cpu"]] or diff > 1e-10 \
            or not all(r.converged for r in out["cpu"]):
        raise SystemExit("small service on the card disagrees with the CPU")


def f64_true_rel(mats, trs, x) -> torch.Tensor:
    """Per row, sqrt((M r, r) / (M b, b)) with r = b - A x, the operator,
    preconditioner and arithmetic of an f64 solver at phase 4's size, from
    scratch: the norm the rows' rel_tol bounds, without the reduced
    policy's recurrence or preconditioner."""
    s64 = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="f64", device="cuda")
    s = len(mats)
    lam, mu = s64.pack_materials(mats)
    prep = s64.prepare(lam, mu, np.ones(s, bool), s64.empty_prep(s))
    _, _, A, M = s64._build_from_prep(prep)
    b = s64._rhs(torch.as_tensor(np.asarray(trs), dtype=torch.float64, device="cuda"))
    r = b - A(x.to(device="cuda", dtype=torch.float64))
    dots = lambda u, v: (u * v).reshape(s, -1).sum(dim=1)  # noqa: E731
    return torch.sqrt(dots(M(r), r) / dots(M(b), b)).cpu()


def bf16_phase(f64_solve: dict, batch_iters: list[int], card: str) -> dict:
    """Phase 5d, the mixed-bf16 policy (see the module docstring); returns
    the PAop launches by dtype of its counted runs."""
    pa = ops.counts["pa_elasticity"]
    launched = collections.Counter()

    def counted(tag: str, want: tuple) -> dict:
        counts, by_dtype = all_counts(), dict(pa.dtype_launches)
        print(f"[bf16] {tag}: PAop launches by dtype "
              f"{ {str(k)[6:]: v for k, v in by_dtype.items()} }, counts {counts}")
        if any(by_dtype.get(dt, 0) == 0 for dt in want) or any(c[1] for c in counts.values()):
            raise SystemExit(f"{tag} did not run only through the kernels: {counts}, "
                             f"{by_dtype}")
        launched.update(by_dtype)
        return by_dtype

    # (a) solve_beam at phase 4's size: mixed for comparison, mixed-bf16 counted
    rows = {"f64 (phase 4)": f64_solve}
    for pol in ("mixed", "mixed-bf16"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        rep = solve_beam(MAIN_P, MAIN_REFINE, precision=pol, device="cuda",
                         keep_solution=True)
        rows[pol] = {"iters": rep.iterations, "t_solve": rep.t_solve,
                     "peak": torch.cuda.max_memory_allocated()}
        print(f"[bf16] solve_beam p={MAIN_P} refine={MAIN_REFINE} {pol}: iters "
              f"{rep.iterations} rel {rep.final_rel_norm:.3e} converged {rep.converged} "
              f"prec {rep.t_precond} s solve {rep.t_solve} s")
        if not (rep.converged and rep.final_rel_norm <= 1e-6
                and bool(torch.isfinite(rep.x).all())):
            raise SystemExit(f"{pol} solve did not converge to 1e-6")
        if pol == "mixed-bf16":
            counted("solve_beam mixed-bf16", (torch.bfloat16, torch.float64))
        del rep
    print(f"[bf16] solve_beam p={MAIN_P} refine={MAIN_REFINE} on {card}: " + "; ".join(
        f"{k} iters {v['iters']}, t_solve {v['t_solve']} s, peak "
        f"{v['peak'] / 2**30:.3f} GiB" for k, v in rows.items()))
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    small = {dev: solve_beam(2, 1, precision="mixed-bf16", device=dev, start_vectors=sv,
                             keep_solution=True) for dev in ("cuda", "cpu")}
    sdiff = float((small["cuda"].x.cpu() - small["cpu"].x).abs().max()
                  / small["cpu"].x.abs().max())
    print(f"[bf16] small solve p=2 refine=1: iters card/cpu {small['cuda'].iterations}/"
          f"{small['cpu'].iterations}, max rel diff {sdiff:.3e}")
    if abs(small["cuda"].iterations - small["cpu"].iterations) > 1 or sdiff > 1e-5 \
            or not (small["cuda"].converged and small["cpu"].converged):
        raise SystemExit("small mixed-bf16 solve on the card disagrees with the CPU")
    del small

    # (b) the batched solver on phase 5's rows
    mats, trs, tols = batched_scenarios()
    torch.cuda.synchronize()
    reset_all_counts()
    t0 = time.perf_counter()
    solver = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="mixed-bf16",
                              device="cuda")
    res = solver.solve(mats, trs, tols)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    counted("batched mixed-bf16", (torch.bfloat16, torch.float64, torch.float32))
    rel = f64_true_rel(mats, trs, res.x)
    print(f"[bf16] batched S={BATCH_S} p={MAIN_P} refine={MAIN_REFINE} mixed-bf16 on {card}: "
          f"construction + solve {t_solve} s; iters {res.iterations.tolist()} (phase 5, f64: "
          f"{batch_iters}); converged {res.converged.tolist()}; stalled "
          f"{res.stalled.tolist()}; fallback {res.fallback.tolist()}; f64 true rel "
          f"{rel.tolist()} against rel_tol {np.asarray(tols).tolist()}")
    if not bool(res.converged.all()) or bool((rel > torch.as_tensor(tols)).any()):
        raise SystemExit("a mixed-bf16 batched row did not converge to its rel_tol")
    del solver, res

    # (c) a small continuous service, card against CPU
    reqs = [dataclasses.replace(r, keep_solution=True, precision="mixed-bf16")
            for r in serve_workload(6, [2], 1, BATCH_BASE_TOL, f"lognormal:{SEED}")[:3]
            + serve_workload(6, [2], 1, BATCH_BASE_TOL)[3:]]
    inner = elasticity_service.BatchedGMGSolver
    elasticity_service.BatchedGMGSolver = functools.partial(inner, start_vectors=sv)
    try:
        out = {dev: ElasticityService(max_batch=4, chunk_iters=3, device=dev)
               .solve_continuous(reqs) for dev in ("cuda", "cpu")}
    finally:
        elasticity_service.BatchedGMGSolver = inner
    print(f"[bf16] small service p=2 refine=1, 6 requests, max_batch 4, continuous: iters "
          f"card/cpu {[r.iterations for r in out['cuda']]}/"
          f"{[r.iterations for r in out['cpu']]}, fallback "
          f"{[r.fallback for r in out['cuda']]}/{[r.fallback for r in out['cpu']]}")
    if not all(r.converged for r in out["cuda"] + out["cpu"]) or any(
            abs(a.iterations - b.iterations) > 1 for a, b in zip(out["cuda"], out["cpu"])):
        raise SystemExit("small mixed-bf16 service on the card disagrees with the CPU")
    return launched


class ScriptedCrash(RuntimeError):
    """Phase 5c's stand-in for process death inside ``step()``."""


def flight_bytes(svc: ElasticityService) -> int:
    """Bytes of the arrays a checkpoint of ``svc`` holds, the host blob
    left out: each flight's state and prep tensors and its host rows."""
    total = 0
    for fl in svc._flights.values():
        tensors = [getattr(fl.state, f.name) for f in dataclasses.fields(fl.state)]
        for v in fl.prep.values():
            tensors += list(v) if isinstance(v, tuple) else [v]
        total += sum(t.numel() * t.element_size() for t in tensors)
        total += sum(a.nbytes for a in (fl.lam, fl.mu, fl.tr, fl.tol, fl.row_iters,
                                        fl.prep_lam, fl.prep_mu))
    return total


def write_parts(svc: ElasticityService, directory: str) -> dict[str, float]:
    """Seconds of each part of a checkpoint write of ``svc``'s flights,
    done one after the other as ``CheckpointManager.save`` does them:
    the device-to-host copy, crc32, and np.save + fsync of every leaf
    into ``directory`` (removed after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays = []
    for fl in svc._flights.values():
        arrays += [*fl.solver.state_to_host(fl.state).values(),
                   *fl.solver.prep_to_host(fl.prep).values()]
    t1 = time.perf_counter()
    for a in arrays:
        _crc32(a)
    t2 = time.perf_counter()
    os.makedirs(directory)
    for i, a in enumerate(arrays):
        with open(os.path.join(directory, f"leaf_{i:05d}.npy"), "wb") as f:
            np.save(f, a)
            f.flush()
            os.fsync(f.fileno())
    t3 = time.perf_counter()
    shutil.rmtree(directory)
    return {"bytes": sum(a.nbytes for a in arrays), "device-to-host": t1 - t0,
            "crc32": t2 - t1, "np.save + fsync": t3 - t2}


def run_together(cmds: list, env: dict, timeout: float = 600) -> list:
    """Run ``cmds`` ((argument list, working directory) pairs) as processes
    started together; returns each one's ``(CompletedProcess, wall
    seconds)`` in order.  A process still running at ``timeout`` fails the
    phase, and every one is killed first."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, cwd in cmds]

    def wait(proc):
        out, err = proc.communicate(timeout=max(timeout - (time.perf_counter() - t0), 1))
        return out, err, time.perf_counter() - t0

    try:
        with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(wait, procs))
    except subprocess.TimeoutExpired as e:
        raise SystemExit(f"{' '.join(e.cmd)} still ran after {timeout} s") from e
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [(subprocess.CompletedProcess(c, p.returncode, out, err), wall)
            for (c, _), p, (out, err, wall) in zip(cmds, procs, done)]


def run_round_trips(*trips) -> None:
    """Drive CLI round trips together: each is a generator that yields a
    stage's (argument list, working directory) pairs and is sent back their
    ``(CompletedProcess, wall seconds)`` pairs; every stage of every trip
    still running starts its processes together."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    stages = {trip: next(trip) for trip in trips}
    while stages:
        outs = run_together([c for cmds in stages.values() for c in cmds], env)
        nxt = {}
        for trip, cmds in stages.items():
            mine, outs = outs[:len(cmds)], outs[len(cmds):]
            try:
                nxt[trip] = trip.send(mine)
            except StopIteration:
                pass
        stages = nxt


def serve_cli_round_trip(tmp: str, card: str):
    """Phase 5c's CLI round trip, run in phase 9(d) beside the train CLI's
    (``run_round_trips``): serve_solve --continuous on the card three
    times: uninterrupted and, in a second process started beside it,
    SIGKILLed after 2 local steps with a checkpoint every step; then
    resumed.  The resumed run's --report-out lines must equal the
    uninterrupted run's, x_sha256 included."""
    common = [sys.executable, "-m", "repro_torch.launch.serve_solve", "--continuous",
              "--device", "cuda", *RECOVERY_CLI]
    (a, wa), (b, wb) = yield [
        (common + ["--report-out", "a.jsonl"], tmp),
        (common + ["--checkpoint-dir", "ckpt", "--checkpoint-every", "1", "--kill-after-steps",
                   "2", "--report-out", "b.jsonl"], tmp)]
    if a.returncode != 0:
        raise SystemExit(f"serve_solve (uninterrupted) failed:\n{a.stderr[-4000:]}")
    if b.returncode != -signal.SIGKILL:
        raise SystemExit(f"serve_solve --kill-after-steps 2 ended with {b.returncode}, not "
                         f"SIGKILL:\n{b.stderr[-4000:]}")
    (c, wc), = yield [(common + ["--checkpoint-dir", "ckpt", "--resume", "--report-out",
                                 "c.jsonl"], tmp)]
    if c.returncode != 0 or "resumed from checkpoint step 2" not in c.stdout:
        raise SystemExit(f"serve_solve --resume failed ({c.returncode}):\n{c.stdout[-2000:]}"
                         f"\n{c.stderr[-4000:]}")

    def lines(name):
        with open(os.path.join(tmp, name)) as f:
            return sorted(map(json.loads, f.read().splitlines()), key=lambda r: r["ticket"])

    base, got = lines("a.jsonl"), lines("c.jsonl")
    if len(base) != 6 or got != base or any(r["x_sha256"] is None for r in base):
        raise SystemExit(f"serve_solve resumed reports differ from the uninterrupted run's:\n"
                         f"{base}\n{got}")
    recovery = [ln for ln in c.stdout.splitlines() if ln.startswith("recovery:")]
    print(f"[recovery] serve_solve --continuous {' '.join(RECOVERY_CLI)} --device cuda: "
          f"uninterrupted {wa} s and SIGKILLed after 2 local steps {wb} s, resumed from step 2 "
          f"{wc} s (process walls; four processes at once, then two, with the train CLI's); "
          f"{len(base)} --report-out lines equal, x_sha256 included, iterations "
          f"{[r['iterations'] for r in base]}; {recovery} ({card})")


def recovery_phase(fixed: list, t_fixed: float, card: str) -> None:
    """Recovery (phase 5c): phase 5b's 16 requests under ServiceRecovery,
    a crash inside step 4 right after the chunk launch, a restore into a
    fresh service with a watchdog, drained with every count zeroed just
    before the restore and read after; bitwise against phase 5b's fixed
    run (``fixed``, ``t_fixed`` s).  The CLI's SIGKILL/--resume round
    trip (``serve_cli_round_trip``) runs in phase 9(d)."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="recovery_")
    try:
        free = shutil.disk_usage(tmp).free
        ckpt = os.path.join(tmp, "ckpt")
        reqs = service_requests()

        def service():
            return ElasticityService(max_batch=BATCH_S, precision="f64",
                                     chunk_iters=SERVICE_CHUNK, device="cuda",
                                     spans=SpanRecorder(fence=False))

        svc = service()
        rec = ServiceRecovery(svc, ckpt, every=RECOVERY_EVERY, keep=RECOVERY_KEEP)
        inner = svc._launch_chunk

        def launch(flight):
            inner(flight)
            if svc._step_index == RECOVERY_CRASH_STEP:
                raise ScriptedCrash(f"scripted crash inside step {svc._step_index}")

        svc._launch_chunk = launch
        for r in reqs:
            svc.submit(r)
        need, crashed = None, False
        try:
            while not svc.idle():
                svc.step()
                # The write's span times the write, not the chunk's tail.
                torch.cuda.synchronize()
                if need is None:
                    need = 3 * flight_bytes(svc)
                    print(f"[recovery] free disk in the temporary directory before the "
                          f"phase: {free} B; three checkpoints' arrays: {need} B ({card})")
                    if free < need:
                        raise SystemExit(f"phase 5c: {free} B free in {tmp}, less than "
                                         f"three checkpoints ({need} B)")
                rec.maybe_checkpoint()
        except ScriptedCrash:
            crashed = True
        if not crashed:
            raise SystemExit(f"phase 5c: the run drained before step {RECOVERY_CRASH_STEP}")
        writes = svc.spans.by_name("checkpoint_write")
        if [sp.args["step"] for sp in writes] != [1, 3] or svc.stats["checkpoints_written"] != 2:
            raise SystemExit(f"phase 5c: checkpoints at steps {[sp.args['step'] for sp in writes]}"
                             f", {svc.stats['checkpoints_written']} counted; expected [1, 3]")
        cdir = os.path.join(ckpt, f"step_{rec.manager.latest():09d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        on_disk = sum(os.path.getsize(os.path.join(cdir, n)) for n in os.listdir(cdir))
        blob = next(e["shape"][0] for e in leaves if e["path"] == "['host']")
        print(f"[recovery] checkpoint of step 3: {len(leaves)} leaves, {on_disk} B on disk "
              f"(arrays {flight_bytes(svc)} B, host blob {blob} B); writes at steps 1 and 3 "
              f"(checkpoint_write spans): {[sp.duration for sp in writes]} s ({card})")
        parts = write_parts(svc, os.path.join(tmp, "parts"))
        print(f"[recovery] one write's parts, one after the other on the crashed service's "
              f"flight: {parts} ({card})")
        del svc, rec, inner, launch
        gc.collect()
        torch.cuda.empty_cache()

        svc = service()
        rec = ServiceRecovery(svc, ckpt, every=RECOVERY_EVERY, keep=RECOVERY_KEEP)
        wd = svc.attach_watchdog(RECOVERY_WATCHDOG_S)
        reset_all_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not rec.restore() or svc._step_index != 3:
            raise SystemExit(f"phase 5c: restore did not land on step 3 ({svc._step_index})")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        while not svc.idle():
            svc.step()
            torch.cuda.synchronize()
            rec.maybe_checkpoint()
        torch.cuda.synchronize()
        t_resumed = time.perf_counter() - t0
        counts = all_counts()
        check_service_counts("resumed", counts, want_probe=True)
        got = sorted(svc.drain(), key=lambda r: r.ticket)
        if [r.ticket for r in got] != list(range(SERVICE_N)):
            raise SystemExit(f"phase 5c: resumed tickets {[r.ticket for r in got]}")
        for g, w in zip(got, fixed, strict=True):
            same = ((g.iterations, g.converged, g.born_converged, g.precision, g.fallback,
                     g.final_rel_norm) == (w.iterations, w.converged, w.born_converged,
                                           w.precision, w.fallback, w.final_rel_norm))
            if not same or (w.x is not None and not np.array_equal(g.x, w.x)):
                raise SystemExit(f"phase 5c: ticket {g.ticket} differs from phase 5b's fixed "
                                 f"run: {g.iterations} iterations, rel {g.final_rel_norm}; "
                                 f"want {w.iterations}, {w.final_rel_norm}")
        later = svc.spans.by_name("checkpoint_write")
        want_writes = len(range(3 + RECOVERY_EVERY, svc._step_index + 1, RECOVERY_EVERY))
        fires = svc.stats["watchdog_fires"]
        if (svc.stats["restores"] != 1 or svc.stats["checkpoints_written"] != want_writes
                or len(later) != want_writes):
            raise SystemExit(f"phase 5c: stats {dict(svc.stats)}, {len(later)} writes, "
                             f"expected 1 restore and {want_writes} writes")
        if not (fires >= 1 and fires == wd.timeouts == svc.spans.count("watchdog_fire")):
            raise SystemExit(f"phase 5c: watchdog fired {fires} (counter), {wd.timeouts} "
                             f"(watchdog), {svc.spans.count('watchdog_fire')} (spans)")
        restore_span = svc.spans.by_name("restore")[0].duration
        print(f"[recovery] crash inside step {RECOVERY_CRASH_STEP} after the chunk launch; "
              f"restore from step 3: {t_restore} s (restore span {restore_span} s); resumed "
              f"run, restore to drain: {t_resumed} s over steps 4-{svc._step_index}, "
              f"{want_writes} more writes {[sp.duration for sp in later]} s, against phase "
              f"5b's undisturbed fixed run {t_fixed} s; counts {counts}; watchdog "
              f"({RECOVERY_WATCHDOG_S} s) fired {fires} times, slowest step {wd.slowest} s "
              f"({card})")
        print(f"[recovery] resumed = phase 5b's fixed run, bitwise: {SERVICE_N} tickets' "
              f"iterations {[r.iterations for r in got]}, flags and final_rel_norm, kept x of "
              f"requests {list(SERVICE_KEEP)} ({card})")
        del svc, rec, got
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[recovery] phase wall {time.perf_counter() - t_phase} s ({card})")


def ablation_line(row: dict, peak: int, base: int, card: str) -> str:
    """One sweep row; ``peak`` is the peak allocation during it, ``base``
    what was allocated before it (earlier phases' tensors)."""
    pl = row["placement"]
    share = (f"roofline share {100 * pl['fraction']}% ({pl['bound']}-bound at OI "
             f"{pl['oi']})")
    if row["assembly"] == "pa_baseline":
        # The reference's dense model counts 3x the FLOPs the GEMMs run;
        # place the same time by the GEMMs' own 36 Q^3 D^3 as well.
        gemm = place_measured(
            flops_per_apply=dense_gemm_flops_per_elem(row["p"]) * row["nelem"] * row["batch"],
            bytes_per_apply=row["bytes_per_apply"], t_apply_s=row["t_apply_s"],
            hw=H100_SXM, dtype=torch.float64)
        share = (f"{share} by the dense model (3x the GEMMs' FLOPs); by the GEMMs' "
                 f"36 Q^3 D^3: {gemm.achieved_flops / 1e9} GFLOP/s, roofline share "
                 f"{100 * gemm.fraction}% ({gemm.bound}-bound at OI {gemm.oi})")
    return (f"[ablation] {row['assembly']} p={row['p']} refine={row['refine']} "
            f"ndof={row['ndof']} nelem={row['nelem']} route={row['route']}: "
            f"{row['t_apply_s'] * 1e3} ms/apply, {row['gdofs_per_s']} GDoF/s, "
            f"{row['gflops_per_s']} GFLOP/s, {row['gbytes_per_s']} GB/s (model), "
            f"{share}, operator {row['memory_bytes']} B, peak "
            f"{peak / 2**30} GiB, {(peak - base) / 2**30} GiB above the "
            f"{base / 2**30} GiB held before ({card})")


def ablation_check(card: str) -> None:
    """Phase 8 (a): every level on the card against the same level on the
    CPU and against paop_cuda on the card; fa's SpMV bitwise repeatable."""
    gen = torch.Generator().manual_seed(SEED)
    bad = []
    for p, refine in ABLATION_CHECK_REFINE.items():
        space = H1Space(beam_hex().refined(refine), p)
        x = torch.randn((space.nscalar, 3), generator=gen, dtype=torch.float64)
        ys = {}
        for a in ASSEMBLY_LEVELS:
            op = ElasticityOperator(space, assembly=a, device="cuda")
            y = op.apply(x.cuda())
            if a == "fa" and not torch.equal(op.apply(x.cuda()), y):
                bad.append((p, a, "SpMV not bitwise repeatable"))
            ys[a] = y
            _, rel, ok = compare(y.cpu(), ElasticityOperator(space, assembly=a, device="cpu")
                                 .apply(x), torch.float64)
            if not ok:
                bad.append((p, a, "card vs CPU", rel))
            print(f"[ablation] check p={p} refine={refine} ndof={space.ndof} {a}: card vs "
                  f"CPU max rel err {rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'} ({card})")
        worst = 0.0
        for a, y in ys.items():
            _, rel, ok = compare(y, ys["paop_cuda"], torch.float64)
            worst = max(worst, rel)
            if not ok:
                bad.append((p, a, "vs paop_cuda", rel))
        print(f"[ablation] check p={p}: every level vs paop_cuda on the card, max rel err "
              f"{worst:.3e}; fa SpMV bitwise repeatable ({card})")
    if bad:
        raise SystemExit(f"phase 8: assembly levels disagree: {bad}")


def ablation_profile(p: int, refine: int, card: str) -> None:
    """Three applies of every matrix-free level under torch.profiler: the
    device time of each, by kernel (cuBLAS GEMMs, elementwise passes,
    gathers, the PAop kernel)."""
    space = H1Space(beam_hex().refined(refine), p)
    x = torch.randn((1, space.nscalar, 3), dtype=torch.float64, device="cuda")
    levels = {a: ElasticityOperator(space, assembly=a, materials=[MATERIALS_BEAM], device="cuda")
              for a in ABLATION_LEVELS}
    for op in levels.values():
        op.apply(x)
    torch.cuda.synchronize()

    def run():
        for a, op in levels.items():
            with record_function(f"ablation.p{p}.{a}"):
                for _ in range(3):
                    op.apply(x)
                torch.cuda.synchronize()

    print(f"[ablation] profile: 3 applies of each level at p={p} refine={refine} "
          f"ndof={space.ndof} ({card})")
    print_profile(run, prefix=f"ablation.p{p}.", top=6)
    del levels, x
    torch.cuda.empty_cache()


def coarse_factor_times(card: str, rounds: int = 5) -> None:
    """The solve's coarse Cholesky factor at p=4/refine=4 (its coarsest
    level: p=1, 8 elements), built from the scipy-assembled matrix (the
    solve's path for attribute-dict materials) and from the probe (its
    path for fields and batches), the two in turns between
    synchronize fences, median of ``rounds``; the two matrices must agree
    to 1e-12 of max |K|."""
    space = hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)[0]
    op = ElasticityOperator(space, materials=MATERIALS_BEAM, device="cuda")
    builds = {
        "assembled": lambda: make_coarse_solver(op),
        "probe": lambda: cholesky_solver(torch.linalg.cholesky(probe_coarse_matrix(op))),
    }
    times = {name: [] for name in builds}
    for _ in range(rounds + 1):  # the first round warms both up
        for name, build_fn in builds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    K = assembled_coarse_matrix(op)
    rel = float((K - probe_coarse_matrix(op)).abs().max() / K.abs().max())
    ms = {name: 1e3 * statistics.median(t[1:]) for name, t in times.items()}
    print(f"[ablation] coarse factor at p={MAIN_P} refine={MAIN_REFINE} (coarsest level "
          f"p={space.p}, nelem={space.nelem}, n={3 * space.nscalar}): assembled "
          f"{ms['assembled']} ms, probe {ms['probe']} ms (median of {rounds}, host clock "
          f"between fences); matrices agree to {rel:.3e} of max |K| ({card})")
    if not rel <= 1e-12:
        raise SystemExit(f"phase 8: assembled and probed coarse matrices differ: {rel}")


def ablation_phase(card: str) -> None:
    """The ablation (phase 8): the paper's assembly ladder on the card."""
    t_phase = time.perf_counter()

    def lap(part):
        print(f"[ablation] {part} done at {time.perf_counter() - t_phase} s of the phase")

    ablation_check(card)
    torch.cuda.empty_cache()
    lap("(a) the check")

    # (b) the sweet-spot sweep, then (c) fa at its own size
    def point(p, refine, a):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        row = operator_throughput(p, refine, assembly=a, device="cuda")
        print(ablation_line(row, torch.cuda.max_memory_allocated(), base, card))
        torch.cuda.empty_cache()
        return row

    rows = []
    for p, refine in ABLATION_REFINE.items():
        rows += [point(p, refine, a) for a in ABLATION_LEVELS]
    for a in ABLATION_LEVELS:
        mine = [r for r in rows if r["assembly"] == a]
        best = max(mine, key=lambda r: r["gdofs_per_s"])
        print(f"[ablation] {a}: GDoF/s by p {[round(r['gdofs_per_s'], 4) for r in mine]}, "
              f"peak at p={best['p']} ({card})")
    lap("(b) the sweep")
    for p in ABLATION_PROFILE_P:
        ablation_profile(p, ABLATION_REFINE[p], card)
    lap("(b) the profiles")
    big = ELASTICITY_SHAPES["beam_p8_51m"]
    rows += [point(big.p, big.n_h_refine, a) for a in ABLATION_51M]
    lap("(b) beam_p8_51m")
    mem_total = torch.cuda.get_device_properties(0).total_memory
    for p, refine in ABLATION_FA.items():
        space = H1Space(beam_hex().refined(refine), p)
        model = fa_memory_bytes(space)
        run = model <= FA_RUN_SHARE * mem_total
        print(f"[ablation] fa p={p} refine={refine} ndof={space.ndof}: model "
              f"{model} B against the card's {mem_total} B ({model / mem_total:.3f} of it): "
              + ("run" if run else "not run, decided from the model"
                 + (" (over the card's memory: the paper's OOM row)" if model > mem_total
                    else f" (over {FA_RUN_SHARE} of the card's memory)"))
              + f" ({card})")
        if run:
            t0 = time.perf_counter()
            rows.append(point(p, refine, "fa"))
            print(f"[ablation] fa p={p}: assembly + timing {time.perf_counter() - t0} s ({card})")
    lap("(c) fa")

    # (d) the paper's Table 4 on the card
    for (p, refine), levels in TABLE4.items():
        iters = {}
        for a in levels:
            mem = next((r["memory_bytes"] for r in rows
                        if (r["assembly"], r["p"], r["refine"]) == (a, p, refine)), None)
            if mem is None:
                mem = ElasticityOperator(H1Space(beam_hex().refined(refine), p), assembly=a,
                                         device="cuda").memory_bytes()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_all_counts()
            rep = solve_beam(p, refine, assembly=a, precision="f64", device="cuda")
            counts = all_counts()
            print(f"[ablation] table4 p={p} refine={refine} ndof={rep.ndof} {a}: "
                  f"iters={rep.iterations} rel={rep.final_rel_norm:.3e} prec={rep.t_precond} s "
                  f"form={rep.t_form_ls} s solve={rep.t_solve} s total={rep.t_total} s, "
                  f"operator {mem} B, peak {torch.cuda.max_memory_allocated() / 2**30} GiB, "
                  f"counts (launches, plain_calls) {counts} ({card})")
            (pa_l, pa_plain), (pr_l, pr_plain) = counts["pa_elasticity"], counts["probe"]
            # A matrix-free hierarchy's coarsest operator is paop_cuda on the
            # card (its construction runs the probe; the dict-material coarse
            # matrix is assembled, so only a paop_cuda hierarchy applies
            # PAop); an all-fa hierarchy runs neither kernel.
            if not (rep.converged and rep.final_rel_norm <= 1e-6) or pa_plain or pr_plain \
                    or (pa_l > 0) != (a == "paop_cuda") or (pr_l > 0) != (a != "fa"):
                raise SystemExit(f"phase 8: table4 {a} at p={p} refine={refine}: converged="
                                 f"{rep.converged} rel={rep.final_rel_norm} counts {counts}")
            iters[a] = rep.iterations
        if len(set(iters.values())) != 1:
            raise SystemExit(f"phase 8: table4 iterations differ across levels at p={p} "
                             f"refine={refine}: {iters}")
    lap("(d) Table 4")
    coarse_factor_times(card)
    torch.cuda.empty_cache()
    print(f"[ablation] phase wall {time.perf_counter() - t_phase} s ({card})")


def bwd_inputs(B, S, H, K, D, dtype, gen, window=None) -> tuple:
    """Unit-normal q, k, v and dO on the card, and the flash kernel's o and
    LSE: (q, k, v, o, lse, do)."""
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
    o, lse = flash_ops.launch(flash_ops.route(q, k, v), q, k, v, window=window, lse=True)
    return q, k, v, o, lse, do


def expected_bwd_route(dt, D: int) -> str:
    """The backward route each case must launch: f32 fma, bf16 at D in
    {64, 80, 128} wgmma, other bf16 mma_sync."""
    if dt == torch.float32:
        return "fma"
    return "wgmma" if D in flash_ops.WGMMA_D else "mma_sync"


def bwd_bound(q, k) -> tuple[float, str]:
    """Least time for one backward: the larger of bytes over the memory
    rate (q, k, v, o, dO read once, dq, dk, dv written once) and 2.5x the
    causal forward's 4 B H D S(S+1)/2 operations over the dtype's peak."""
    B, S, H, D = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    flops = 2.5 * 4 * B * H * D * S * (S + 1) / 2
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def capture_bwd_inputs(calls: set[int]) -> tuple[list, object]:
    """Wrap the backward wrapper to keep clones of the q, k, v, o, dO and
    LSE of the given calls (0-based, in call order: the backward meets the
    last layer first); returns the list and the wrapped function, to put
    back."""
    kept, inner, seen = [], flash_ops.flash_attention_bwd, [0]

    def keeping(q, k, v, o, do, *, lse=None, window=None):
        if seen[0] in calls:
            kept.append((seen[0], *(t.detach().clone() for t in (q, k, v, o, do, lse)), window))
        seen[0] += 1
        return inner(q, k, v, o, do, lse=lse, window=window)

    flash_ops.flash_attention_bwd = keeping
    return kept, inner


def train_kernel_checks(gen, card: str) -> dict[str, dict]:
    """Phase 9(a): every backward case against its plain version, its route
    asserted and the forward's o and LSE held first; then the wgmma and
    mma_sync routes' times.  Returns the numbers of the wgmma route's JSON
    entry, at the training shape."""
    bad, errs = [], {}
    cases = [(c, dt) for c in BWD_CASES for dt in (torch.float32, torch.bfloat16)]
    cases.append(((*FLASH_TRAIN, None), torch.bfloat16))
    for (B, S, H, K, D, window), dt in cases:
        q, k, v, o, lse, do = bwd_inputs(B, S, H, K, D, dt, gen, window)
        # The backward is held against a plain version given this same o,
        # so the forward kernel's o (and LSE) are held against theirs first.
        o_err, o_row, o_ok = flash_check(o, flash_ref(q, k, v, window=window), dt)
        lse_err = float((lse - flash_lse(q, k, window=window)).abs().max())
        want_route = expected_bwd_route(dt, D)
        before = dict(flash_ops.bwd_route_launches)
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
        torch.cuda.synchronize()
        moved = [r for r in flash_ops.BWD_ROUTES if flash_ops.bwd_route_launches[r] != before[r]]
        again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        want = flash_bwd_ref(q, k, v, o, do, window=window)
        abs_err, rel, row = flash_bwd_errors(got, want)
        ok = (o_ok and lse_err <= LSE_TOL and moved == [want_route] and bitwise
              and rel <= BWD_TOL[dt] and (dt != torch.bfloat16 or row <= BWD_ROW_REL))
        print(f"[train] flash backward vs plain (B,S,H,K,D)=({B},{S},{H},{K},{D}) "
              f"window={window} {str(dt)[6:]}: forward o max abs err {o_err:.3e}, max row rel "
              f"err {o_row:.3e}, LSE max abs err {lse_err:.3e}; backward route {moved} "
              f"(expected {want_route}), max abs err {abs_err:.3e}, of max |plain| {rel:.3e}, "
              f"max row err {row:.3e}, bitwise repeat {bitwise} "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            bad.append(((B, S, H, K, D, window), str(dt), moved, o_err, o_row, lse_err, rel,
                        row, bitwise))
        if (B, S, H, K, D) == FLASH_TRAIN:
            errs["wgmma"] = abs_err
            # the mma_sync route on the same inputs, which it is timed on
            sync = flash_ops.launch_bwd("mma_sync", q, k, v, o, do, lse)
            s_err, s_rel, s_row = flash_bwd_errors(sync, want)
            s_ok = s_rel <= BWD_TOL[dt] and s_row <= BWD_ROW_REL
            print(f"[train] flash backward vs plain {FLASH_TRAIN} bf16, the mma_sync route on "
                  f"the same inputs: max abs err {s_err:.3e}, of max |plain| "
                  f"{s_rel:.3e}, max row err {s_row:.3e} {'ok' if s_ok else 'OUT OF TOLERANCE'}")
            if not s_ok:
                bad.append((FLASH_TRAIN, "mma_sync", s_rel, s_row))
            del sync
        del q, k, v, o, lse, do, got, again, want
    if bad:
        raise SystemExit(f"flash kernels disagree with their plain versions (forward o and "
                         f"LSE, backward): {bad}")
    torch.cuda.empty_cache()

    times = {}
    for shape in BWD_TIME_SHAPES:
        q, k, v, o, lse, do = bwd_inputs(*shape, torch.bfloat16, gen)
        t = bwd_times(q, k, v, o, do, lse, ("wgmma", "mma_sync"))
        print(f"[train] flash backward (B,S,H,K,D)={shape} bf16, in turns, median of 5 rounds "
              f"of 10: wgmma {t['wgmma']} ms, mma_sync {t['mma_sync']} ms (wgmma "
              f"{t['mma_sync'] / t['wgmma']}x faster); SDPA backward (enable_gqa) "
              f"{t['library']} ms (fwd+bwd {t['sdpa fwd+bwd']}, fwd {t['sdpa fwd']}); SDPA "
              f"backward with k/v expanded beforehand {t['library expanded']} ms; plain "
              f"{t['plain']} ms (median of 3); bound {t['bound_ms']} ms ({t['bound_by']}): "
              f"wgmma {100 * t['bound_ms'] / t['wgmma']}% of bound, "
              f"{t['wgmma'] / t['library']}x SDPA's backward; mma_sync "
              f"{100 * t['bound_ms'] / t['mma_sync']}% of bound ({card})")
        times[shape] = t
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    return bwd_entry(times[FLASH_TRAIN], "wgmma", errs["wgmma"])


def bwd_times(q, k, v, o, do, lse, routes) -> dict:
    """The named backward routes on these inputs, in turns with SDPA's
    backward as its fwd+bwd minus its fwd (``library``: enable_gqa=True;
    ``library expanded``: k/v expanded to the query heads beforehand), median
    of 5 rounds of 10; the plain version apart (its S x S f32
    intermediates), median of 3; and the bound."""
    G = q.shape[2] // k.shape[2]
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    kx, vx = (t.repeat_interleave(G, dim=1) for t in (ks, vs))
    for t in (qs, ks, vs, kx, vx):
        t.requires_grad_(True)

    def sdpa(kk, vv, gqa):
        return F.scaled_dot_product_attention(qs, kk, vv, is_causal=True, enable_gqa=gqa)

    t = event_ms({
        **{r: functools.partial(flash_ops.launch_bwd, r, q, k, v, o, do, lse) for r in routes},
        "sdpa fwd": lambda: sdpa(ks, vs, True),
        "sdpa fwd+bwd": lambda: torch.autograd.grad(sdpa(ks, vs, True), (qs, ks, vs), dos),
        "sdpa expanded fwd": lambda: sdpa(kx, vx, False),
        "sdpa expanded fwd+bwd": lambda: torch.autograd.grad(sdpa(kx, vx, False),
                                                             (qs, kx, vx), dos),
    }, n=10, rounds=5)
    t["plain"] = event_ms({"plain": lambda: flash_bwd_ref(q, k, v, o, do)}, n=1,
                          rounds=3)["plain"]
    t["library"] = t["sdpa fwd+bwd"] - t["sdpa fwd"]
    t["library expanded"] = t["sdpa expanded fwd+bwd"] - t["sdpa expanded fwd"]
    t["bound_ms"], t["bound_by"] = bwd_bound(q, k)
    return t


def bwd_entry(t: dict, route: str, max_abs_err: float) -> dict:
    """A backward route's numbers for its JSON entry, from :func:`bwd_times`."""
    return {"max_abs_err": max_abs_err, "ms": t[route], "plain_ms": t["plain"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library"]}


def train_full_width(card: str, cfg, batch: int, finite_grads: bool = True) -> int:
    """Phase 9(c) (and 10 for musicgen-medium, 11 for olmoe-1b-7b, 12 for
    zamba2-2.7b, 13 for xlstm-125m): train_loop of ``cfg`` (at full width,
    its layers possibly cut) in bf16, train_4k's sequence with its batch
    cut to ``batch``, each step counted: 2n forward and n backward flash
    launches for n attention blocks (zamba2: n groups, each group
    rematerialized around its rematerialized Mamba2 layers, so its shared
    block runs in the forward and in the group's recompute; xLSTM: none),
    all on the head dim's routes.  A profiled step follows: its device time
    by category and by range (the Mamba2 and xLSTM recurrences as entries
    of their own), and the device's idle share.  Every step's loss and
    gradient norm must be finite; with ``finite_grads`` False (xlstm-125m
    at S = 4096, whose sLSTM gradient overflows f32 in the reference too,
    ROADMAP Queue 3) the first loss must be finite and the gradient norms
    are printed.  Returns the backward's launches over the run."""
    shape = ShapeConfig(f"train_4k, global batch 256 cut to {batch}", "train", TRAIN_SEQ, batch)
    per_step = []

    @contextlib.contextmanager
    def counted(i):
        reset_all_counts()
        yield
        per_step.append((all_counts(), dict(flash_ops.route_launches),
                         dict(flash_ops.bwd_route_launches)))

    L, n = cfg.n_layers, attention_layers(cfg)
    route = expected_route(torch.bfloat16, cfg.head_dim_, 0)
    bwd_route = expected_bwd_route(torch.bfloat16, cfg.head_dim_)
    kept, inner = capture_bwd_inputs({0, n - 1})
    try:
        state, history = train_loop(cfg, shape, steps=TRAIN_STEPS, log_every=1, seed=SEED,
                                    device="cuda", step_context=counted)
    finally:
        flash_ops.flash_attention_bwd = inner
    TRAIN_HISTORY[cfg.name] = history
    want = {"flash_attention": (2 * n, 0), "flash_attention_bwd": (n, 0)}
    for i, (counts, routes, bwd_routes) in enumerate(per_step):
        got = {k: counts[k] for k in want}
        print(f"[train] step {i + 1} counts (launches, plain_calls): {got}; flash forward "
              f"routes {routes}, backward routes {bwd_routes}")
        if got != want or routes[route] != 2 * n or bwd_routes[bwd_route] != n:
            raise SystemExit(f"train step {i + 1} did not run only through the flash kernels: "
                             f"{got}, routes {routes}, backward routes {bwd_routes}; expected "
                             f"{want}, {2 * n} forward on {route} and {n} backward on "
                             f"{bwd_route}")
    finite = [np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in history]
    if len(per_step) != TRAIN_STEPS or not (all(finite) if finite_grads
                                            else np.isfinite(history[0]["loss"])):
        raise SystemExit(f"train steps: {len(per_step)} counted, history {history}")
    if not all(finite):
        print(f"[train] {cfg.name} at S = {TRAIN_SEQ}: first loss {history[0]['loss']!r}; "
              f"gradient norms {[m['grad_norm'] for m in history]}: not finite, as the "
              f"reference's sLSTM gradient at this width and length (ROADMAP Queue 3); the "
              f"steps after it run on non-finite parameters ({card})")

    timed = history[1:]
    N, T = cfg.n_active_params(), batch * TRAIN_SEQ
    B, S, H, D = batch, TRAIN_SEQ, cfg.n_heads, cfg.head_dim_
    shapes = param_shapes(cfg)
    # zamba2: the shared block's parameters, which 6NT counts once for its n
    # applications, and the Mamba2 stack's, which nested remat runs forward
    # three times
    n_shared = sum(math.prod(sh) for sh in _leaves(shapes.get("shared", {})))
    n_mamba = sum(math.prod(sh) for sh in _leaves(shapes["blocks"])) if n_shared else 0
    attn = 4 * B * H * D * S * (S + 1) / 2 * n  # causal forward, every attention block
    # 6 N T + 6 (n - 1) N_shared T (zamba2) + 3 x attention
    model_flops = model_flops_estimate(cfg, shape) + 6 * (n - 1) * n_shared * T + 3 * attn
    # as run: remat's recompute (8 N T), zamba2's second recompute of every
    # Mamba2 layer and its shared block's other applications; this
    # backward's 7 products
    run_flops = (8 * N * T + 2 * n_mamba * T + 8 * (n - 1) * n_shared * T
                 + (2 + 3.5) * attn)
    formula = ("6NT + 6 (n-1) N_shared T + 3 x causal attention, n = "
               f"{n} applications of the {n_shared} shared parameters" if n_shared
               else "6NT + 3 x causal attention")
    step_s = statistics.median(m["step_s"] for m in timed)
    peak = PEAK_FLOPS[torch.bfloat16]
    print(f"[train] {cfg.name} bf16 L={L} d={cfg.d_model} H={cfg.n_heads} K={cfg.n_kv_heads} "
          f"hd={cfg.head_dim_} vocab={cfg.vocab}"
          f"{f' codebooks={cfg.n_codebooks}' if cfg.n_codebooks else ''}"
          f"{f' experts={cfg.n_experts} top_k={cfg.top_k} (N active)' if cfg.is_moe else ''}"
          f"{ssm_line(cfg)} N={N}: B={batch} "
          f"S={TRAIN_SEQ} (train_4k's sequence; its global batch 256 cut to {batch}); timed steps "
          f"2-{TRAIN_STEPS}: step s {[m['step_s'] for m in timed]}, median {step_s} s, "
          f"{T / step_s} tokens/s, peak {max(m['peak_gib'] for m in history)} GiB; warm-up "
          f"step {history[0]['step_s']} s ({card})")
    print(f"[train] model FLOPs a step {formula} = {model_flops:.4e}: "
          f"{model_flops / step_s / 1e12} TFLOP/s, MFU {100 * model_flops / step_s / peak}% of "
          f"the {peak / 1e12:.0f} TFLOP/s bf16 dense peak; as run (remat, a backward of 7 "
          f"causal products) "
          f"{run_flops:.4e}: {run_flops / step_s / 1e12} TFLOP/s ({card})")
    if cfg.block_pattern == "xlstm":
        # n_params() (model_flops_estimate's N) leaves out wq/wk/wv and the
        # sLSTM's own shapes: N counted from the parameters built, and the
        # mLSTM's chunked products, (4Q + 4 dh) d_inner a token a layer's
        # forward (scores and their product with v over a chunk of Q, C q
        # and the chunk-end k v^T update)
        n_built = sum(math.prod(sh) for sh in _leaves(shapes))
        n_mlstm = cfg.n_layers - len(cfg.slstm_indices)
        d_in = cfg.ssm_expand * cfg.d_model
        dh, Q = d_in // cfg.n_heads, ssm_module.chunk_len(TRAIN_SEQ, cfg.chunk_size)
        built_flops = (6 * n_built + 3 * n_mlstm * (4 * Q + 4 * dh) * d_in) * T
        print(f"[train] {cfg.name} model FLOPs a step counted from the parameters built: "
              f"6 N T + 3 x {n_mlstm} mLSTM layers x (4Q + 4 dh) d_inner T, N = {n_built} "
              f"(n_params() counts {cfg.n_params()}), Q = {Q}, dh = {dh}, d_inner = {d_in}: "
              f"{built_flops:.4e}: {built_flops / step_s / 1e12} TFLOP/s, MFU "
              f"{100 * built_flops / step_s / peak}% ({card})")

    # One more step under torch.profiler: where its device time goes.
    step_fn = make_train_step(cfg, AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1))
    batch = {k: torch.from_numpy(a).cuda() for k, a in
             make_batch(cfg, shape, TRAIN_STEPS, SEED).items()}

    def one_step():
        step_fn(state, batch)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    ranges = {"AdamW": "train.optimizer"}
    if cfg.is_moe:  # the forward's ranges, their recompute and their backward
        ranges.update({"MoE dispatch": "moe.dispatch", "MoE combine": "moe.combine"})
    if cfg.block_pattern in ("mamba2", "zamba2"):
        ranges.update({"Mamba2 SSD": "mamba.ssd", "Mamba2 conv": "mamba.conv"})
    if cfg.block_pattern == "xlstm":
        ranges.update({"mLSTM chunk scan": "xlstm.mlstm", "sLSTM recurrence": "xlstm.slstm"})
    ms, count, busy, top = device_time_by_category(one_step, TRAIN_CATEGORIES, ranges,
                                                   other="elementwise/copies")
    host_ms = (time.perf_counter() - t0) * 1e3
    TRAIN_PROFILE[cfg.name] = (cfg.n_layers, ms)
    parts = ", ".join(f"{c} {ms[c]} ms ({100 * ms[c] / busy:.1f}%, x{count[c]})" for c in ms)
    print(f"[train] profile of one step (under the profiler, host {host_ms} ms with its "
          f"overhead): device busy {busy} ms: {parts} ({card})")
    print(f"[train] {cfg.name} device idle share of a step: {1 - busy / (step_s * 1e3)} (the "
          f"profiled step's busy {busy} ms over the timed steps' median {step_s} s; over the "
          f"profiled step's own {host_ms} ms: {1 - busy / host_ms}) ({card})")
    for c, rows in top.items():
        for name, t, calls in rows[:TRAIN_TOP_KERNELS]:
            print(f"[train]   {c}: {t:9.3f} ms x{calls:<5d} {name[:110]}")
    del state, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # The kernels on the inputs the last and first attention blocks gave
    # them in the warm-up step: the forward's o and LSE of the remat
    # recompute against the plain forward on its own q, k, v (o per row, as
    # phase 6 holds real inputs), then the backward.
    for call, q, k, v, o, do, lse, window in kept:
        layer = n - 1 - call
        o_err, o_row, _ = flash_check(o, flash_ref(q, k, v, window=window), q.dtype)
        lse_err = float((lse - flash_lse(q, k, window=window)).abs().max())
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
        abs_err, rel, row = flash_bwd_errors(got, flash_bwd_ref(q, k, v, o, do, window=window))
        ok = o_row <= FLASH_ROW_REL and lse_err <= LSE_TOL and row <= BWD_ROW_REL
        print(f"[train] flash forward and backward vs plain, attention block {layer}'s "
              f"q/k/v/o/dO/LSE of "
              f"the warm-up step {tuple(q.shape)} bf16: forward o max abs err {o_err:.3e}, max "
              f"row rel err {o_row:.3e}, LSE max abs err {lse_err:.3e}; backward max abs err "
              f"{abs_err:.3e}, of max |plain| {rel:.3e}, max row err {row:.3e} "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            raise SystemExit(f"flash kernels disagree with their plain versions on attention "
                             f"block {layer}'s training inputs: forward {o_row}, LSE {lse_err}, "
                             f"backward {row}")
    if len(kept) != min(n, 2):
        raise SystemExit(f"the warm-up step kept {len(kept)} blocks' backward inputs, not "
                         f"{min(n, 2)}")
    del kept
    torch.cuda.empty_cache()
    return sum(b[bwd_route] for _, _, b in per_step)


def train_reduced_bf16(card: str) -> dict:
    """Phase 9(e): train_loop of the train CLI's --reduced configuration on
    the card in bf16 at its --seq and --batch defaults (head dim 16: every
    flash call takes the mma_sync routes), each step counted: 2 L forward
    and L backward launches on mma_sync, no plain call, finite losses.
    Then the forward's o and LSE and the backward on the q/k/v/o/dO/LSE
    that the first and last layers gave the backward in step 1, against
    their plain versions, the route asserted and bitwise repeated; and the
    mma_sync backward timed on the last layer's.  Returns the mma_sync
    backward's JSON entry: its launches over the run, its error, times and
    bound at this shape."""
    cfg = get_reduced(TRAIN_ARCH)
    L = cfg.n_layers
    per_step = []

    @contextlib.contextmanager
    def counted(i):
        reset_all_counts()
        yield
        per_step.append((all_counts(), dict(flash_ops.route_launches),
                         dict(flash_ops.bwd_route_launches)))

    kept, inner = capture_bwd_inputs({0, L - 1})
    t0 = time.perf_counter()
    try:
        _, history = train_loop(cfg, TRAIN_REDUCED_SHAPE, steps=TRAIN_REDUCED_STEPS,
                                log_every=1, seed=SEED, device="cuda", step_context=counted)
    finally:
        flash_ops.flash_attention_bwd = inner
    wall = time.perf_counter() - t0
    want = ({"flash_attention": (2 * L, 0), "flash_attention_bwd": (L, 0)},
            {**dict.fromkeys(flash_ops.ROUTES, 0), "mma_sync": 2 * L},
            {**dict.fromkeys(flash_ops.BWD_ROUTES, 0), "mma_sync": L})
    for i, (counts, routes, bwd_routes) in enumerate(per_step):
        got = ({k: counts[k] for k in want[0]}, routes, bwd_routes)
        print(f"[train] reduced {cfg.dtype} (D={cfg.head_dim_}, L={L}) "
              f"{TRAIN_REDUCED_SHAPE.global_batch} x {TRAIN_REDUCED_SHAPE.seq_len} step {i + 1}: "
              f"counts {got[0]}, forward routes {routes}, backward routes {bwd_routes}")
        if got != want:
            raise SystemExit(f"reduced train step {i + 1} did not run only through the mma_sync "
                             f"flash kernels: {got}, expected {want}")
    if len(per_step) != TRAIN_REDUCED_STEPS or not all(np.isfinite(m["loss"]) for m in history):
        raise SystemExit(f"reduced train steps: {len(per_step)} counted, history {history}")
    print(f"[train] reduced bf16 losses {[m['loss'] for m in history]}, {wall} s ({card})")

    if len(kept) != 2:
        raise SystemExit(f"the reduced run kept {len(kept)} layers' backward inputs, not 2")
    errs = []
    for call, q, k, v, o, do, lse, window in kept:
        o_err, o_row, _ = flash_check(o, flash_ref(q, k, v, window=window), q.dtype)
        lse_err = float((lse - flash_lse(q, k, window=window)).abs().max())
        before = dict(flash_ops.bwd_route_launches)
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
        torch.cuda.synchronize()
        moved = [r for r in flash_ops.BWD_ROUTES if flash_ops.bwd_route_launches[r] != before[r]]
        again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, window=window)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        abs_err, rel, row = flash_bwd_errors(got, flash_bwd_ref(q, k, v, o, do, window=window))
        ok = (o_row <= FLASH_ROW_REL and lse_err <= LSE_TOL and moved == ["mma_sync"]
              and bitwise and rel <= BWD_TOL[q.dtype] and row <= BWD_ROW_REL)
        print(f"[train] reduced bf16 flash forward and backward vs plain, layer {L - 1 - call}'s "
              f"q/k/v/o/dO/LSE of step 1 {tuple(q.shape)}: forward o max abs err {o_err:.3e}, "
              f"max row rel err {o_row:.3e}, LSE max abs err {lse_err:.3e}; backward route "
              f"{moved}, max abs err {abs_err:.3e}, of max |plain| {rel:.3e}, max row err "
              f"{row:.3e}, bitwise repeat {bitwise} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            raise SystemExit(f"flash kernels disagree with their plain versions on the reduced "
                             f"run's layer {L - 1 - call}: forward {o_row}, LSE {lse_err}, "
                             f"route {moved}, backward {rel} / {row}, bitwise {bitwise}")
        errs.append(abs_err)
    _, q, k, v, o, do, lse, _ = kept[0]  # the last layer, which the backward meets first
    t = bwd_times(q, k, v, o, do, lse, ("mma_sync",))
    print(f"[train] reduced bf16 flash backward {tuple(q.shape)} (layer {L - 1}'s inputs), in "
          f"turns, median of 5 rounds of 10: mma_sync {t['mma_sync']} ms; SDPA backward "
          f"(enable_gqa) {t['library']} ms, with k/v expanded beforehand "
          f"{t['library expanded']} ms; plain {t['plain']} ms (median of 3); bound "
          f"{t['bound_ms']} ms ({t['bound_by']}): mma_sync "
          f"{100 * t['bound_ms'] / t['mma_sync']}% of bound ({card})")
    return {"launches": sum(b["mma_sync"] for _, _, b in per_step),
            **bwd_entry(t, "mma_sync", max(errs))}


def train_small_check(card: str, arch: str = TRAIN_ARCH, **change) -> None:
    """Phase 9(b) (and 10-12 for each of their architectures): the reduced
    configuration (with ``change``'s fields) in f32, card against CPU from
    one state: first-step gradients, then three train steps' losses; on the
    card the flash kernels launched (where the model has attention), no
    plain call."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", **change)
    host = numpy_tree(init_params(torch.Generator().manual_seed(SEED), cfg))
    opt = AdamWConfig(total_steps=3, warmup_steps=1)
    batches = [make_batch(cfg, TRAIN_SMALL_SHAPE, i, SEED) for i in range(3)]
    grads, losses = {}, {}
    for dev in ("cuda", "cpu"):
        reset_all_counts()
        state = train_state_init(None, cfg, params=lm_params(host, cfg, device=dev))
        b0 = {k: torch.from_numpy(a).to(dev) for k, a in batches[0].items()}
        leaves = list(_leaves(state.params))
        grads[dev] = torch.autograd.grad(loss_fn(state.params, b0, cfg), leaves)
        step = make_train_step(cfg, opt)
        losses[dev] = []
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(a).to(dev) for k, a in b.items()})
            losses[dev].append(float(m["loss"]))
        if dev == "cuda":
            counts = all_counts()
            if (counts["flash_attention_bwd"][0] == 0) != (attention_layers(cfg) == 0) or any(
                    counts[k][1] for k in ("flash_attention", "flash_attention_bwd")):
                raise SystemExit(f"small train on the card did not run the kernels: {counts}")
    grad_rel = max(float((g.cpu() - c).abs().max() / c.abs().max().clamp_min(1e-30))
                   for g, c in zip(grads["cuda"], grads["cpu"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[train] {cfg.name} f32 card vs CPU: first-step gradients max err {grad_rel:.3e} of "
          f"max |CPU| (worst leaf), three steps' losses {losses['cuda']} vs {losses['cpu']}, "
          f"max rel diff {loss_rel:.3e}")
    if grad_rel > TRAIN_SMALL_GRAD_REL or loss_rel > TRAIN_SMALL_LOSS_REL:
        raise SystemExit(f"small train of {cfg.name} on the card disagrees with the CPU")


def train_cli_round_trip(tmp: str, card: str):
    """Phase 9(d)'s train CLI round trip (a generator for
    ``run_round_trips``): the train CLI on the card uninterrupted and, in a
    second process started beside it, SIGKILLed after step 4; then rerun:
    the rerun resumes from step 3 with the same batches, and its steps and
    final checkpoint must be the uninterrupted run's."""
    common = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda", *TRAIN_CLI]

    def steps(out):
        return {int(m[1]): m.groups()[1:] for m in map(TRAIN_LINE.match, out.splitlines()) if m}

    def manifest(d):
        with open(os.path.join(tmp, d, "step_000000006", "manifest.json")) as f:
            return [(e["path"], e["crc32"]) for e in json.load(f)["leaves"]]

    (a, wa), (b, wb) = yield [(common + ["--ckpt-dir", "a"], tmp),
                              (common + ["--ckpt-dir", "b", "--kill-after-steps", "4"], tmp)]
    if a.returncode != 0:
        raise SystemExit(f"train CLI (uninterrupted) failed:\n{a.stderr[-4000:]}")
    if b.returncode != -signal.SIGKILL:
        raise SystemExit(f"train CLI --kill-after-steps 4 ended with {b.returncode}:\n"
                         f"{b.stderr[-4000:]}")
    (c, wc), = yield [(common + ["--ckpt-dir", "b"], tmp)]
    if c.returncode != 0 or "resumed from checkpoint step 3" not in c.stdout:
        raise SystemExit(f"train CLI rerun failed ({c.returncode}):\n{c.stdout[-2000:]}\n"
                         f"{c.stderr[-4000:]}")
    sa, sb, sc = steps(a.stdout), steps(b.stdout), steps(c.stdout)
    batches = all(sa[i][3] == sc[i][3] for i in (4, 5, 6)) and sorted(sc) == [4, 5, 6]
    same_steps = all(sa[i] == sb[i] for i in sb) and all(sa[i] == sc[i] for i in sc)
    differ = [p for (p, x), (_, y) in zip(manifest("a"), manifest("b")) if x != y]
    print(f"[train] train CLI {' '.join(TRAIN_CLI)} --device cuda: uninterrupted {wa} s and "
          f"SIGKILLed after step 4 {wb} s, rerun {wc} s (process walls; four processes at once, "
          f"then two, with serve_solve's); the rerun resumed from step 3, batches of steps 4-6 "
          f"{'the same' if batches else 'DIFFERENT'} (tokens crc32), steps' loss, grad "
          f"norm and lr {'bitwise equal' if same_steps else 'DIFFER'}, final checkpoint "
          f"{'bitwise equal' if not differ else f'differs in {differ}'} ({card})")
    print(f"[train]   uninterrupted {sa}; resumed {sc}")
    if not batches or not same_steps or differ:
        raise SystemExit("the resumed training run is not the uninterrupted one")


def cli_round_trips(card: str) -> None:
    """Phase 9(d): the train CLI's round trip and phase 5c's serve_solve
    one, their stages' processes started together."""
    dirs = [tempfile.mkdtemp(prefix=f"{tag}_cli_") for tag in ("train", "serve")]
    try:
        run_round_trips(train_cli_round_trip(dirs[0], card),
                        serve_cli_round_trip(dirs[1], card))
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def train_phase(gen, card: str) -> list[dict]:
    """Training (phase 9); returns the backward kernels' JSON entries: the
    wgmma route (the full-width path's, at the training shape) and the
    mma_sync route (the reduced bf16 path's, at its shape)."""
    t_phase = time.perf_counter()
    entries = {"wgmma": train_kernel_checks(gen, card)}
    print(f"[train] (a) done at {time.perf_counter() - t_phase} s of the phase")
    entries["wgmma"]["launches"] = train_full_width(card, get_config(TRAIN_ARCH), TRAIN_BATCH)
    print(f"[train] (c) done at {time.perf_counter() - t_phase} s of the phase")
    train_small_check(card)
    cli_round_trips(card)
    print(f"[train] (b), (d) done at {time.perf_counter() - t_phase} s of the phase")
    entries["mma_sync"] = train_reduced_bf16(card)
    print(f"[train] phase wall {time.perf_counter() - t_phase} s ({card})")
    csrc = "src/repro_torch/kernels/flash_attention/csrc/"
    return [{
        "name": name,
        "route": "cuda",
        "source": csrc + source,
        "replaces": "src/repro/models/attention.py:97",
        **entries[route],
    } for name, route, source in (
        ("flash_attention_bwd_wgmma", "wgmma", "flash_attention_bwd_wgmma.cu"),
        ("flash_attention_bwd", "mma_sync", "flash_attention_bwd.cu"))]


def first_fit(tag: str, candidates, reckon, card: str):
    """The first of ``candidates`` ((label, value) pairs, largest first)
    whose reckoned peak fits the card's free memory with SLICE_SPARE to
    spare; ``reckon(value)`` gives the peak in bytes and its terms, printed
    for each candidate tried."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    for label, value in candidates:
        need, terms = reckon(value)
        fits = need + SLICE_SPARE <= free
        print(f"[{tag}] {label}: {terms} = {need / 1e9:.2f} GB; {free / 1e9:.2f} GB free of "
              f"{total / 1e9:.2f} GB, {(free - need) / 1e9:.2f} GB to spare: "
              f"{'fits' if fits else 'does not fit'} ({SLICE_SPARE / 1e9:.0f} GB wanted) ({card})")
        if fits:
            return value
    raise SystemExit(f"{label}: does not fit the card, nor does any larger candidate")


def serve_reckoning(cfg, request_sets: list) -> tuple[int, str]:
    """The reckoned serve peak of ``cfg`` for every (batch, prompt) of
    ``request_sets``, in bytes, and its printed terms: the bf16 weights, and
    the larger of the init's largest transient (:func:`init_transient`) and
    the decode state (the KV cache, n x 2 x K x hd x 2 B a slot for n
    attention blocks, prompt + SERVE_NEW + 8 slots a row, a rolling
    window's under SWA; and the Mamba2 states,
    :func:`recurrent_state_bytes`) plus the prefill's transients
    (:func:`prefill_transients`)."""
    shapes = param_shapes(cfg)
    weights = 2 * sum(math.prod(sh) for sh in _leaves(shapes))
    init = init_transient(shapes)
    per_slot = attention_layers(cfg) * 2 * cfg.n_kv_heads * cfg.head_dim_ * 2
    needs = []
    for B, prompt in request_sets:
        slots = prompt + SERVE_NEW + 8
        if cfg.sliding_window:
            slots = min(slots, cfg.sliding_window)
        needs.append((B, prompt, per_slot * B * slots + recurrent_state_bytes(cfg, B),
                      prefill_transients(cfg, B, prompt)))
    state = {"attn": "KV cache", "xlstm": "xLSTM states"}.get(cfg.block_pattern,
                                                             "KV cache and Mamba2 states")
    sets = "; ".join(f"{B} x {prompt}: {state} {c / 1e9:.2f} GB + prefill transients "
                     f"{t / 1e9:.2f} GB" for B, prompt, c, t in needs)
    need = weights + max([init] + [c + t for _, _, c, t in needs])
    return need, (f"weights {weights / 1e9:.2f} GB + the larger of init's transient "
                  f"{init / 1e9:.2f} GB and ({sets})")


def train_reckoning(cfg, batch: int) -> tuple[int, str]:
    """The reckoned training peak of ``cfg`` at ``batch`` x TRAIN_SEQ, in
    bytes, and its printed terms: bf16 parameters and gradients and f32
    AdamW moments (12 B a parameter), the largest stacked leaf's gradient
    once more (the layers' gradients are stacked at the end of the
    backward), every block's input kept under remat, one block's recompute
    and backward (its FFN transients, :func:`ffn_transients`, whose buffers
    the backward frees as it consumes them, and its attention's four
    (T, H hd) bf16 tensors; a Mamba2 layer's, :func:`mamba_transients`;
    zamba2 keeps every group's input, and in a group's backward its layers'
    inputs, its shared block's and one Mamba2 layer's transients; xLSTM
    keeps each mLSTM block's input and all that each sLSTM layer's loop
    saves, :func:`slstm_saved` (its blocks are not rematerialized), and runs
    one mLSTM layer's recompute and backward, :func:`mlstm_transients`) and
    a loss chunk's f32 logits three times (logits, softmax, gradient).  AdamW
    updates a large leaf in chunks of its leading axis (its f32 temporaries
    are a chunk's, not counted)."""
    shapes = param_shapes(cfg)
    T = batch * TRAIN_SEQ
    n = sum(math.prod(sh) for sh in _leaves(shapes))
    state = 12 * n
    stack = 2 * max(math.prod(sh) for sh in _leaves(shapes["blocks"]))
    attn = ffn_transients(cfg, batch, TRAIN_SEQ) + 4 * T * cfg.n_heads * cfg.head_dim_ * 2
    if cfg.block_pattern == "attn":
        saved, block = cfg.n_layers * T * cfg.d_model * 2, attn
    elif cfg.block_pattern == "mamba2":
        saved, block = cfg.n_layers * T * cfg.d_model * 2, mamba_transients(cfg, batch,
                                                                            TRAIN_SEQ, True)
    elif cfg.block_pattern == "xlstm":
        n_s = len(cfg.slstm_indices)
        saved = ((cfg.n_layers - n_s) * T * cfg.d_model * 2
                 + n_s * slstm_saved(cfg, batch, TRAIN_SEQ))
        block = mlstm_transients(cfg, batch, TRAIN_SEQ, True)
    else:
        # zamba2's nested remat: every group's input, and in one group's
        # backward its layers' inputs, its shared block's activations and
        # one Mamba2 layer's recompute and backward
        saved = (attention_layers(cfg) + cfg.shared_attn_every) * T * cfg.d_model * 2
        block = attn + mamba_transients(cfg, batch, TRAIN_SEQ, True)
    ce = 3 * batch * min(LOSS_CHUNK, TRAIN_SEQ) * cfg.vocab * 4
    return state + stack + saved + block + ce, (
        f"state {state / 1e9:.2f} GB ({n} parameters) + stacked gradient {stack / 1e9:.2f} GB "
        f"+ kept between blocks {saved / 1e9:.2f} GB + one block {block / 1e9:.2f} GB + loss "
        f"chunk {ce / 1e9:.2f} GB")


def serve_batch_cut(cfg, card: str) -> int:
    """The largest batch of SLICE_BATCHES whose :func:`serve_reckoning` at
    SERVE_PROMPT fits the card."""
    return first_fit("serve", ((f"{cfg.name} batch {B}", B) for B in SLICE_BATCHES),
                     lambda B: serve_reckoning(cfg, [(B, SERVE_PROMPT)]), card)


def train_batch_cut(cfg, card: str, batches=SLICE_TRAIN_BATCHES) -> int:
    """The largest batch of ``batches`` whose :func:`train_reckoning` fits
    the card."""
    return first_fit("train", ((f"{cfg.name} batch {B} x {TRAIN_SEQ}", B)
                               for B in batches),
                     lambda B: train_reckoning(cfg, B), card)


def layer_cuts(cfg):
    """(label, ``cfg`` with L layers) for L from its own count down to 1
    (zamba2: down by whole groups of ``shared_attn_every``)."""
    step = cfg.shared_attn_every if cfg.block_pattern == "zamba2" else 1
    return ((f"{cfg.name} {L} of {cfg.n_layers} layers", dataclasses.replace(cfg, n_layers=L))
            for L in range(cfg.n_layers, 0, -step))


def serve_layer_cut(cfg, request_sets: list, card: str):
    """``cfg`` with the most layers whose :func:`serve_reckoning` for every
    (batch, prompt) of ``request_sets`` fits the card."""
    return first_fit("serve", layer_cuts(cfg), lambda cut: serve_reckoning(cut, request_sets),
                     card)


def train_layer_cut(cfg, batch: int, card: str):
    """``cfg`` with the most layers whose :func:`train_reckoning` at
    ``batch`` fits the card."""
    return first_fit("train", layer_cuts(cfg), lambda cut: train_reckoning(cut, batch), card)


def compression_check(card: str) -> None:
    """Gradient compression on the card: int8_compress and topk_compress of
    one tensor equal the same calls on the CPU bitwise; then one reduced
    f32 train step with int8 compression (make_train_step's grad_transform,
    what train_loop(compression=) hands it) from one state on the card and
    on the CPU: losses to COMPRESS_REL; the int8 levels equal except where
    the two gradients straddle a rounding boundary (at most one level
    apart; counted); the parameters to COMPRESS_REL of a leaf's max on the
    elements whose levels agree."""
    g = torch.randn((257, 129), generator=torch.Generator().manual_seed(SEED))
    g[0, :3] = torch.tensor([0.5, -0.5, 1.5]) * g.abs().max() / 127.0  # near half levels
    (qc, sc), (qh, sh) = int8_compress(g.cuda()), int8_compress(g)
    (tc, mc), (th, mh) = topk_compress(g.cuda(), COMPRESS_TOPK_FRAC), topk_compress(
        g, COMPRESS_TOPK_FRAC)
    same = (torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh) and torch.equal(tc.cpu(), th)
            and torch.equal(mc.cpu(), mh))
    print(f"[compression] int8_compress and topk_compress (frac {COMPRESS_TOPK_FRAC}) of a "
          f"(257, 129) f32 tensor on the card vs the CPU: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise SystemExit("gradient compression on the card differs from the CPU")

    cfg = dataclasses.replace(get_reduced(TRAIN_ARCH), dtype="float32")
    host = numpy_tree(init_params(torch.Generator().manual_seed(SEED), cfg))
    batch = make_batch(cfg, TRAIN_SMALL_SHAPE, 0, SEED)
    opt = AdamWConfig(total_steps=3, warmup_steps=1)
    def int8_roundtrip(levels):
        """A stateless grads -> grads int8 round trip that keeps each leaf's
        levels in ``levels``."""
        def one(t):
            q, scale = int8_compress(t)
            levels.append(q.cpu())
            return int8_decompress(q, scale).to(t.dtype)
        return lambda grads: _tree_map(one, grads)

    out = {}
    for dev in ("cuda", "cpu"):
        levels = []
        state = train_state_init(None, cfg, params=lm_params(host, cfg, device=dev))
        step = make_train_step(cfg, opt, grad_transform=int8_roundtrip(levels))
        state, m = step(state, {k: torch.from_numpy(a).to(dev) for k, a in batch.items()})
        out[dev] = (float(m["loss"]), levels, [p.detach().cpu() for p in _leaves(state.params)])
    (loss_c, lv_c, p_c), (loss_h, lv_h, p_h) = out["cuda"], out["cpu"]
    moved = sum(int((a != b).sum()) for a, b in zip(lv_c, lv_h))
    apart = max(int((a.int() - b.int()).abs().max()) for a, b in zip(lv_c, lv_h))
    p_err = max(float(((pc - ph).abs() * (a == b)).max() / ph.abs().max().clamp_min(1e-30))
                for pc, ph, a, b in zip(p_c, p_h, lv_c, lv_h))
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    n = sum(a.numel() for a in lv_h)
    print(f"[compression] reduced {cfg.name} f32, one train step with int8 compression, card "
          f"vs CPU: loss {loss_c!r} vs {loss_h!r} (rel {loss_rel:.3e}); int8 levels differ at "
          f"{moved} of {n} elements (at most {apart} apart: gradients on either side of a "
          f"rounding boundary); parameters where the levels agree max err {p_err:.3e} of max "
          f"|CPU| (worst leaf) ({card})")
    if loss_rel > COMPRESS_REL or p_err > COMPRESS_REL or apart > 1 or moved > n // 1000:
        raise SystemExit("the compressed train step on the card disagrees with the CPU")


def flash_serve_times(shapes: list, card: str) -> None:
    """The wgmma forward at each serve shape (name, (B, S, H, K, D),
    window) bf16, held against the plain version, then in turns with SDPA
    (median of 5 rounds of 10; under a window SDPA takes the band as a
    boolean mask), the plain version apart (median of 3 rounds of 1),
    beside the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, (B, S, H, K, D), window in shapes:
        args = flash_inputs(B, S, H, K, D, torch.bfloat16, gen)
        if flash_ops.route(*args) != "wgmma":
            raise SystemExit(f"{name}'s timing inputs do not take the wgmma route")
        err, row, ok = flash_check(flash_ops.flash_attention(*args, window=window),
                                   flash_ref(*args, window=window), torch.bfloat16)
        if not ok:
            raise SystemExit(f"the wgmma forward disagrees with its plain version at {name}'s "
                             f"serve shape: {err}, row {row}")
        sdpa_args = [t.transpose(1, 2).contiguous() for t in args]
        sdpa_kw = {"is_causal": True}
        if window is not None:
            i = torch.arange(S, device="cuda")
            sdpa_kw = {"attn_mask": (i[:, None] >= i[None]) & (i[:, None] - i[None] < window)}
        t = event_ms({
            "wgmma": lambda: flash_ops.launch("wgmma", *args, window=window),
            "sdpa": lambda: F.scaled_dot_product_attention(*sdpa_args, enable_gqa=True,
                                                           **sdpa_kw),
        }, n=10, rounds=5)
        plain = event_ms({"plain": lambda: flash_ref(*args, window=window)}, n=1,
                         rounds=3)["plain"]
        bound_ms, bound_by = flash_bound(*args, window=window)
        print(f"[time] flash_attention {name} serve shape (B,S,H,K,D)=({B},{S},{H},{K},{D}) "
              f"window={window} bf16 (max abs err {err:.3e}, max row rel err {row:.3e}), in "
              f"turns, median of 5 rounds of 10: wgmma {t['wgmma']} ms, SDPA "
              f"{t['sdpa']} ms ({t['wgmma'] / t['sdpa']}x SDPA's time), plain {plain} ms; bound "
              f"{bound_ms} ms ({bound_by}): {100 * bound_ms / t['wgmma']}% of bound ({card})")
        del args, sdpa_args, sdpa_kw
        torch.cuda.empty_cache()


def bwd_time_at(name: str, shape: tuple, card: str) -> None:
    """The backward at a training shape on unit-normal inputs: held against
    its plain version, then timed (:func:`bwd_times`) beside SDPA's
    backward, the plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, o, lse, do = bwd_inputs(*shape, torch.bfloat16, gen)
    want = flash_bwd_ref(q, k, v, o, do)
    _, rel, row = flash_bwd_errors(flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse), want)
    del want
    t = bwd_times(q, k, v, o, do, lse, ("wgmma", "mma_sync"))
    print(f"[train] flash backward {name} training shape (B,S,H,K,D)={shape} bf16: of max "
          f"|plain| {rel:.3e}, max row err {row:.3e}; in turns, median of 5 rounds of 10: wgmma "
          f"{t['wgmma']} ms, mma_sync {t['mma_sync']} ms; SDPA backward {t['library']} ms; "
          f"plain {t['plain']} ms; bound {t['bound_ms']} ms ({t['bound_by']}): wgmma "
          f"{100 * t['bound_ms'] / t['wgmma']}% of bound, {t['wgmma'] / t['library']}x SDPA's "
          f"backward ({card})")
    if rel > BWD_TOL[torch.bfloat16] or row > BWD_ROW_REL:
        raise SystemExit(f"the backward disagrees with its plain version at {shape}")
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()


def slice_phase(card: str) -> None:
    """Phase 10: granite-8b, qwen3-32b, qwen1.5-32b, qwen2-vl-7b and
    musicgen-medium at full width, each served with its batch cut printed
    and counted (``serve_full_width``), each reduced configuration card
    against CPU (serve and train); musicgen-medium trained at full width
    (``train_full_width``); gradient compression; the forward timed at each
    serve shape and the backward at musicgen's training shape."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    shapes = []
    for arch in SLICE_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        B = serve_batch_cut(cfg, card)
        serve_full_width(cfg, B, rng, card)
        small_serve_check(arch, rng)
        train_small_check(card, arch)
        shapes.append((cfg.name, (B, SERVE_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_),
                       None))
        print(f"[serve] {cfg.name} wall {time.perf_counter() - t0} s ({card})")
    cfg = get_config(SLICE_TRAIN_ARCH)
    B = train_batch_cut(cfg, card)
    train_full_width(card, cfg, B)
    compression_check(card)
    flash_serve_times(shapes, card)
    bwd_time_at(cfg.name, (B, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_), card)
    print(f"[slice] phase wall {time.perf_counter() - t_phase} s ({card})")


def recurrent_state_bytes(cfg, B: int) -> int:
    """Bytes of the recurrent decode states of every layer at batch B (0 for
    attention).  Mamba2: ssm (B, H, N, P) f32 and conv (B, W - 1, C) bf16 a
    layer.  xLSTM: an mLSTM layer's C (B, H, dh, dh), n (B, H, dh) and m
    (B, H) f32 and its conv tail (B, W - 1, d_inner) bf16; an sLSTM layer's
    four (B, H, dh) f32."""
    if cfg.block_pattern == "attn":
        return 0
    d_in, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    if cfg.block_pattern == "xlstm":
        H, dh = cfg.n_heads, d_in // cfg.n_heads
        n_s = len(cfg.slstm_indices)
        mlstm = B * (H * dh * dh + H * dh + H) * 4 + B * (cfg.conv_width - 1) * d_in * 2
        return (cfg.n_layers - n_s) * mlstm + n_s * 4 * B * cfg.d_model * 4
    return cfg.n_layers * B * (d_in * N * 4 + (cfg.conv_width - 1) * (d_in + 2 * N) * 2)


def mlstm_transients(cfg, B: int, S: int, train: bool = False) -> int:
    """Bytes of one mLSTM layer's largest transients at (B, S): the bf16
    up-projection, conv and q/k/v (8 (B, S, d_inner)); the f32 copies of
    q (twice: cast and scaled), k and v, the weighted keys, the two parts of
    the numerator and h (7 (B, S, d_inner) f32, twice in a backward for
    their gradients); the chunked scan's (B, S / Q, H, Q, Q) f32 blocks (the
    log weights, their stabilized difference, its exponential, the scores and
    their product: 5, 8 in a backward) and the chunks' incoming C states (B,
    S / Q, H, dh, dh) f32 (the loop's list and its stack: 2, 3 in a
    backward)."""
    d_in, H = cfg.ssm_expand * cfg.d_model, cfg.n_heads
    dh = d_in // H
    Q = ssm_module.chunk_len(S, cfg.chunk_size)
    block = B * (S // Q) * H * Q * Q * 4
    states = B * (S // Q) * H * dh * dh * 4
    rows = B * S * d_in
    if train:
        return 16 * rows + 56 * rows + 8 * block + 3 * states
    return 16 * rows + 28 * rows + 5 * block + 2 * states


def slstm_saved(cfg, B: int, S: int) -> int:
    """Bytes that one sLSTM layer's position loop keeps for its backward at
    (B, S): 17 (B, d) f32 tensors a step (the pre-activations, four wide;
    the gates, their activations and the stabilizer's terms; the carries),
    the f32 input projections (B, S, 4 d) and the stacked h (B, S, d)
    f32."""
    return S * 17 * B * cfg.d_model * 4 + B * S * 5 * cfg.d_model * 4


def mamba_transients(cfg, B: int, S: int, train: bool = False) -> int:
    """Bytes of one Mamba2 layer's largest transients at (B, S): its bf16
    in_proj output, three f32 (B, S, d_inner) tensors (the inputs, x dt, y)
    and the chunked scan's (B, S / Q, H, Q, Q) f32 blocks: the decay and its
    product with the scores (three with the masked difference at prefill;
    in a backward also their saved copies and three gradients, five)."""
    d_in, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    Q = ssm_module.chunk_len(S, cfg.chunk_size)
    block = B * (S // Q) * H * Q * Q * 4
    return B * S * (2 * d_in + 2 * N + H) * 2 + 3 * B * S * d_in * 4 + (5 if train else 3) * block


def prefill_transients(cfg, B: int, S: int) -> int:
    """Bytes of a prefill's largest transients in one block at (B, S): the
    FFN's (:func:`ffn_transients`), a Mamba2 layer's
    (:func:`mamba_transients`), the larger for zamba2, or an mLSTM layer's
    (:func:`mlstm_transients`)."""
    if cfg.block_pattern == "attn":
        return ffn_transients(cfg, B, S)
    if cfg.block_pattern == "xlstm":
        return mlstm_transients(cfg, B, S)
    if cfg.block_pattern == "mamba2":
        return mamba_transients(cfg, B, S)
    return max(ffn_transients(cfg, B, S), mamba_transients(cfg, B, S))


def ffn_transients(cfg, B: int, S: int) -> int:
    """Bytes of a prefill's largest transients in one block at (B, S), bf16.
    A dense MLP: its three (B S, d_ff) tensors.  An MoE
    (:mod:`repro_torch.models.moe`): the (E, B, cap + 1) buffers (its
    input and output rows, d each; the expert intermediates g, u, silu(g)
    and h, d_ff each), the B S k assignment rows (expanded, masked,
    gathered, weighted: d each) and the one-hot and its exclusive cumsum
    (bool and two int32 per assignment and expert)."""
    if not cfg.is_moe:
        return 3 * B * S * cfg.d_ff * 2
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    buffers = B * E * (moe_module.capacity(cfg, S) + 1) * (2 * d + 4 * cfg.d_ff) * 2
    return buffers + 4 * B * S * k * d * 2 + B * S * k * E * 9


def record_routes() -> tuple[list, object]:
    """Wrap the MoE module's router to keep each call's expert ids (on the
    host); returns the list and the wrapped function, to put back."""
    kept, inner = [], moe_module.route

    def keeping(params, x, cfg):
        out = inner(params, x, cfg)
        kept.append(out[2].cpu())
        return out

    moe_module.route = keeping
    return kept, inner


def moe_small_check(arch: str, card: str) -> None:
    """The reduced configuration of ``arch`` in f32, card against CPU from
    one set of weights, at its capacity factor and at MOE_DROP_CF (where
    assignments are dropped): a forward of a TRAIN_SMALL_SHAPE batch gives
    every layer's expert ids and dropped assignments identical, and hidden
    states within SMALL_SERVE_REL of max.  Then one moe_apply forward and
    backward on the card under ``torch.cuda.set_sync_debug_mode("error")``:
    the MoE path makes no host sync."""
    for cf in (get_reduced(arch).capacity_factor, MOE_DROP_CF):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32", capacity_factor=cf)
        host = numpy_tree(init_params(torch.Generator().manual_seed(SEED), cfg))
        tokens = make_batch(cfg, TRAIN_SMALL_SHAPE, 0, SEED)["tokens"]
        cap = moe_module.capacity(cfg, tokens.shape[1])
        out = {}
        for dev in ("cuda", "cpu"):
            kept, inner = record_routes()
            try:
                with torch.no_grad():
                    hidden, _ = model_forward(lm_params(host, cfg, device=dev),
                                              {"tokens": torch.from_numpy(tokens).to(dev)}, cfg)
            finally:
                moe_module.route = inner
            drops = [(~moe_module.slots(ids, cfg.n_experts, cap)[2]).nonzero().tolist()
                     for ids in kept]
            out[dev] = (hidden.cpu(), kept, drops)
        (h_c, ids_c, dr_c), (h_h, ids_h, dr_h) = out["cuda"], out["cpu"]
        same_ids = len(ids_c) == cfg.n_layers and all(
            torch.equal(a, b) for a, b in zip(ids_c, ids_h))
        rel = float((h_c - h_h).abs().max() / h_h.abs().max())
        n_drop = [len(d) for d in dr_h]
        print(f"[moe] {cfg.name} f32 capacity factor {cf} (cap {cap} of {tokens.shape[1]} "
              f"tokens x top {cfg.top_k} over {cfg.n_experts} experts a row), card vs CPU: "
              f"expert ids of each layer {'identical' if same_ids else 'DIFFER'}, dropped "
              f"assignments a layer {n_drop} {'identical' if dr_c == dr_h else 'DIFFER'}, "
              f"hidden max diff {rel:.3e} of max ({card})")
        if not same_ids or dr_c != dr_h or rel > SMALL_SERVE_REL:
            raise SystemExit(f"the MoE of {cfg.name} on the card disagrees with the CPU")
        if cf == MOE_DROP_CF and not any(n_drop):
            raise SystemExit(f"{cfg.name} at capacity factor {cf} dropped no assignment")
    params = {k: v.cuda().requires_grad_(True) for k, v in
              moe_module.moe_init(torch.Generator().manual_seed(SEED), cfg, torch.float32).items()}
    x = torch.randn((2, 64, cfg.d_model), device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_module.moe_apply(params, x, cfg)
        grads = torch.autograd.grad(y.square().sum() + aux, [x, *params.values()])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[moe] {cfg.name} moe_apply forward and backward on the card under sync debug mode "
          f"'error': no host sync ({len(grads)} gradients)")


def repeat_check(cfg, tag: str, card: str) -> None:
    """One train step of ``cfg`` (reduced, bf16) run twice on the card from
    one state: the loss, the gradients, and the updated parameters and
    moments bitwise equal."""
    host = numpy_tree(_tree_map(lambda t: t.float(),
                                init_params(torch.Generator().manual_seed(SEED), cfg)))
    batch = {k: torch.from_numpy(a).cuda()
             for k, a in make_batch(cfg, TRAIN_SMALL_SHAPE, 0, SEED).items()}
    step = make_train_step(cfg, AdamWConfig(total_steps=3, warmup_steps=1))
    runs = []
    for _ in range(2):
        state = train_state_init(None, cfg, params=lm_params(host, cfg, device="cuda"))
        grads = torch.autograd.grad(loss_fn(state.params, batch, cfg),
                                    list(_leaves(state.params)))
        state, m = step(state, batch)
        runs.append([m["loss"], *grads, *_leaves(state.params), *_leaves(state.opt_state)])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    cf = f" capacity factor {cfg.capacity_factor}" if cfg.is_moe else ""
    print(f"[{tag}] {cfg.name} {cfg.dtype}{cf}: one train step twice from one state, loss "
          f"{float(runs[0][0])!r}: loss, gradients, parameters and moments "
          f"{'bitwise equal' if same else 'DIFFER'} ({card})")
    if not same:
        raise SystemExit(f"a train step of {cfg.name} is not bitwise repeatable")


def moe_repeat_check(card: str) -> None:
    """One reduced MoE_TRAIN_ARCH train step in bf16, at its capacity factor
    and at MOE_DROP_CF, run twice on the card from one state
    (:func:`repeat_check`)."""
    for cf in (get_reduced(MOE_TRAIN_ARCH).capacity_factor, MOE_DROP_CF):
        repeat_check(dataclasses.replace(get_reduced(MOE_TRAIN_ARCH), capacity_factor=cf),
                     "moe", card)


def moe_phase(card: str) -> None:
    """Phase 11: olmoe-1b-7b served at full width and depth, mixtral-8x7b at
    full width with its layers cut (8 x 2048 and 1 x 8192 past its window),
    each counted (``serve_full_width``); each reduced configuration card
    against CPU (serve, train, routing and drops); olmoe-1b-7b trained at
    full width with its layers cut (``train_full_width``); a reduced MoE
    train step repeated bitwise; the flash kernels timed at the new shapes."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    t0 = time.perf_counter()
    cfg = get_config(MOE_SERVE_ARCH)
    serve_full_width(cfg, serve_batch_cut(cfg, card), rng, card)
    print(f"[serve] {cfg.name} wall {time.perf_counter() - t0} s ({card})")
    t0 = time.perf_counter()
    full = get_config(MOE_CUT_ARCH)
    cfg = serve_layer_cut(full, [(SERVE_REQUESTS, SERVE_PROMPT), (1, MOE_LONG_PROMPT)], card)
    print(f"[serve] {cfg.name} layers cut {full.n_layers} -> {cfg.n_layers} by the reckoning "
          f"above ({card})")
    serve_full_width(cfg, SERVE_REQUESTS, rng, card)
    serve_full_width(cfg, 1, rng, card, prompt=MOE_LONG_PROMPT)
    print(f"[serve] {cfg.name} wall {time.perf_counter() - t0} s ({card})")
    t0 = time.perf_counter()
    for arch in (MOE_SERVE_ARCH, MOE_CUT_ARCH):
        small_serve_check(arch, rng)
        train_small_check(card, arch)
        moe_small_check(arch, card)
    moe_repeat_check(card)
    print(f"[moe] card against CPU and the bitwise repeat: wall {time.perf_counter() - t0} s "
          f"({card})")
    cfg = train_layer_cut(get_config(MOE_TRAIN_ARCH), MOE_TRAIN_BATCH, card)
    train_full_width(card, cfg, MOE_TRAIN_BATCH)
    flash_serve_times(MOE_FLASH_TIMES, card)
    bwd_time_at(MOE_TRAIN_ARCH, MOE_BWD_SHAPE, card)
    print(f"[moe] phase wall {time.perf_counter() - t_phase} s ({card})")


def d80_kernel_checks(gen) -> dict:
    """Phase 3 at zamba2-2.7b's head dim: at each of D80_SHAPES in bf16, the
    forward (route asserted wgmma; FLASH_ATOL and FLASH_ROW_REL), its o
    bitwise that of the LSE-writing launch and its LSE (``ref.LSE_TOL``),
    then the backward on that o and LSE (route asserted wgmma, bitwise
    repeated; ``ref.flash_bwd_errors``' bf16 limits), against their plain
    versions; then the kept mma_sync kernels, launched by name on the same
    inputs, under the same limits.  Returns {(route, "fwd" | "bwd", shape):
    max abs err}."""
    errs, bad = {}, []
    dt = torch.bfloat16
    for shape in D80_SHAPES:
        q, k, v = flash_inputs(*shape, dt, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        ref, lse_ref = flash_ref(q, k, v), flash_lse(q, k)
        before = dict(flash_ops.route_launches)
        o = flash_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        moved = [r for r in flash_ops.ROUTES if flash_ops.route_launches[r] != before[r]]
        f_err, f_row, f_ok = flash_check(o, ref, dt)
        o_lse, lse = flash_ops.launch("wgmma", q, k, v, lse=True)
        lse_err = float((lse - lse_ref).abs().max())
        before = dict(flash_ops.bwd_route_launches)
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
        torch.cuda.synchronize()
        b_moved = [r for r in flash_ops.BWD_ROUTES
                   if flash_ops.bwd_route_launches[r] != before[r]]
        again = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        want = flash_bwd_ref(q, k, v, o, do)
        b_err, rel, row = flash_bwd_errors(got, want)
        ok = (moved == ["wgmma"] and f_ok and torch.equal(o, o_lse) and lse_err <= LSE_TOL
              and b_moved == ["wgmma"] and bitwise and rel <= BWD_TOL[dt]
              and row <= BWD_ROW_REL)
        print(f"[flash vs plain] (B,S,H,K,D)={shape} bf16 (zamba2-2.7b's head dim): forward "
              f"route {moved}, max abs err {f_err:.3e}, max row rel err {f_row:.3e}, LSE max abs "
              f"err {lse_err:.3e}, o bitwise that of the LSE launch {torch.equal(o, o_lse)}; "
              f"backward route {b_moved}, max abs err {b_err:.3e}, of max |plain| {rel:.3e}, max "
              f"row err {row:.3e}, bitwise repeat {bitwise} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            bad.append((shape, moved, f_err, f_row, lse_err, b_moved, rel, row, bitwise))
        errs[("wgmma", "fwd", shape)], errs[("wgmma", "bwd", shape)] = f_err, b_err
        del o, o_lse, got, again
        # the kept mma_sync kernels at D = 80, by name, on the same inputs
        s_o, s_lse = flash_ops.launch("mma_sync", q, k, v, lse=True)
        s_same = torch.equal(s_o, flash_ops.launch("mma_sync", q, k, v))
        sf_err, sf_row, sf_ok = flash_check(s_o, ref, dt)
        s_lse_err = float((s_lse - lse_ref).abs().max())
        sb_err, s_rel, s_row = flash_bwd_errors(
            flash_ops.launch_bwd("mma_sync", q, k, v, s_o, do, s_lse),
            flash_bwd_ref(q, k, v, s_o, do))
        s_ok = (sf_ok and s_same and s_lse_err <= LSE_TOL and s_rel <= BWD_TOL[dt]
                and s_row <= BWD_ROW_REL)
        print(f"[flash vs plain] (B,S,H,K,D)={shape} bf16, the mma_sync kernels by name: "
              f"forward max abs err {sf_err:.3e}, max row rel err {sf_row:.3e}, LSE max abs err "
              f"{s_lse_err:.3e}, o bitwise that of the LSE launch {s_same}; backward max abs err "
              f"{sb_err:.3e}, of max |plain| {s_rel:.3e}, max row err {s_row:.3e} "
              f"{'ok' if s_ok else 'OUT OF TOLERANCE'}")
        if not s_ok:
            bad.append((shape, "mma_sync", sf_err, sf_row, s_lse_err, s_same, s_rel, s_row))
        errs[("mma_sync", "fwd", shape)], errs[("mma_sync", "bwd", shape)] = sf_err, sb_err
        del q, k, v, do, ref, lse_ref, lse, want, s_o, s_lse
        torch.cuda.empty_cache()
    if bad:
        raise SystemExit(f"the flash kernels disagree with their plain versions at D = 80: "
                         f"{bad}")
    return errs


def ssm_sync_check(card: str, arch: str = SSM_ARCH, tag: str = "ssm") -> None:
    """A reduced zamba2 (or ``arch``'s) forward and backward (loss_fn: the
    chunked scan's loop, the nested remat, the shared block's flash kernels;
    xLSTM's chunk and position loops) on the card in bf16 under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync, finite
    gradients."""
    cfg = get_reduced(arch)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    leaves = [t.requires_grad_(True) for t in _leaves(params)]
    batch = {k: torch.from_numpy(a).cuda()
             for k, a in make_batch(cfg, TRAIN_SMALL_SHAPE, 0, SEED).items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = torch.autograd.grad(loss_fn(params, batch, cfg), leaves)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"[{tag}] {cfg.name} bf16 loss and gradients on the card under sync debug mode "
          f"'error': no host sync, {len(grads)} gradients, finite {finite} ({card})")
    if not finite:
        raise SystemExit(f"{cfg.name}: non-finite gradients on the card")


def d80_times(card: str) -> tuple[dict, dict]:
    """The wgmma and mma_sync forwards at D80_SERVE and D80_TRAIN in turns
    with SDPA (median of 5 rounds of 10), the plain version apart (median
    of 3 rounds of 1), beside the bound; then both backwards at D80_TRAIN
    (:func:`bwd_times`: SDPA's backward, the plain version, the bound).
    Returns ({shape: forward numbers}, backward numbers)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fwd = {}
    for shape in (D80_SERVE, D80_TRAIN):
        args = flash_inputs(*shape, torch.bfloat16, gen)
        if flash_ops.route(*args) != "wgmma":
            raise SystemExit(f"{shape}'s timing inputs do not take the wgmma route")
        sdpa_args = [t.transpose(1, 2).contiguous() for t in args]
        t = event_ms({
            "wgmma": lambda: flash_ops.launch("wgmma", *args),
            "mma_sync": lambda: flash_ops.launch("mma_sync", *args),
            "sdpa": lambda: F.scaled_dot_product_attention(*sdpa_args, is_causal=True),
        }, n=10, rounds=5)
        t["plain"] = event_ms({"plain": lambda: flash_ref(*args)}, n=1, rounds=3)["plain"]
        t["bound_ms"], t["bound_by"] = flash_bound(*args)
        print(f"[time] flash_attention (B,S,H,K,D)={shape} bf16, in turns, median of 5 rounds "
              f"of 10: wgmma {t['wgmma']} ms ({100 * t['bound_ms'] / t['wgmma']}% of bound, "
              f"{t['wgmma'] / t['sdpa']}x SDPA's time), mma_sync {t['mma_sync']} ms "
              f"({100 * t['bound_ms'] / t['mma_sync']}% of bound; wgmma "
              f"{t['mma_sync'] / t['wgmma']}x faster), SDPA {t['sdpa']} ms, plain {t['plain']} "
              f"ms (median of 3); bound {t['bound_ms']} ms ({t['bound_by']}) ({card})")
        fwd[shape] = t
        del args, sdpa_args
        torch.cuda.empty_cache()
    q, k, v, o, lse, do = bwd_inputs(*D80_TRAIN, torch.bfloat16, gen)
    t = bwd_times(q, k, v, o, do, lse, ("wgmma", "mma_sync"))
    print(f"[time] flash backward (B,S,H,K,D)={D80_TRAIN} bf16, in turns, median of 5 rounds of "
          f"10: wgmma {t['wgmma']} ms ({100 * t['bound_ms'] / t['wgmma']}% of bound, "
          f"{t['wgmma'] / t['library']}x SDPA's backward), mma_sync {t['mma_sync']} ms "
          f"({100 * t['bound_ms'] / t['mma_sync']}% of bound; wgmma "
          f"{t['mma_sync'] / t['wgmma']}x faster); SDPA backward {t['library']} ms (fwd+bwd "
          f"{t['sdpa fwd+bwd']}, fwd {t['sdpa fwd']}); plain {t['plain']} ms (median of 3); "
          f"bound {t['bound_ms']} ms ({t['bound_by']}) ({card})")
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return fwd, t


def ssm_phase(card: str, d80_errs: dict) -> list[dict]:
    """Phase 12: zamba2-2.7b served at full width and depth (its batch from
    the printed reckoning, counted: ``serve_full_width``); its reduced
    configuration and a reduced plain Mamba2 stack card against CPU (serve,
    train); a reduced zamba2 forward and backward with no host sync and a
    reduced bf16 step repeated bitwise, counted together (head dim 16: only
    the mma_sync routes); zamba2-2.7b trained at full width (its layers cut
    to SSM_TRAIN_LAYERS, or fewer if the printed reckoning says so;
    ``train_full_width``); the D = 80 flash
    kernels timed.  Returns their JSON entries: the wgmma kernels with the
    full-width launches, the mma_sync ones (the route of no full-width path
    since the wgmma kernels took D = 80) with the reduced runs'."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    cfg = get_config(SSM_ARCH)
    serve_counts = serve_full_width(cfg, serve_batch_cut(cfg, card), rng, card)
    print(f"[serve] {cfg.name} wall {time.perf_counter() - t_phase} s ({card})")
    t0 = time.perf_counter()
    for change in ({}, {"block_pattern": "mamba2"}):
        small_serve_check(SSM_ARCH, rng, **change)
        train_small_check(card, SSM_ARCH, **change)
    reset_all_counts()
    ssm_sync_check(card)
    repeat_check(get_reduced(SSM_ARCH), "ssm", card)
    reduced = (all_counts(), dict(flash_ops.route_launches), dict(flash_ops.bwd_route_launches))
    print(f"[ssm] reduced bf16 zamba2 (head dim {get_reduced(SSM_ARCH).head_dim_}), the sync "
          f"check and the repeated step: counts (launches, plain_calls) "
          f"{ {k: reduced[0][k] for k in flash_ops.counts} }; flash routes {reduced[1]}, "
          f"backward routes {reduced[2]} ({card})")
    on_sync = (reduced[1]["mma_sync"], reduced[2]["mma_sync"])
    if (min(on_sync) == 0 or sum(reduced[1].values()) != on_sync[0]
            or sum(reduced[2].values()) != on_sync[1]
            or any(reduced[0][k][1] for k in flash_ops.counts)):
        raise SystemExit(f"the reduced zamba2 runs did not run only through the mma_sync flash "
                         f"kernels: {reduced}")
    print(f"[ssm] card against CPU, no host sync, the bitwise repeat: wall "
          f"{time.perf_counter() - t0} s ({card})")
    t0 = time.perf_counter()
    cut = train_layer_cut(cfg, SSM_TRAIN_BATCH, card)
    cut = dataclasses.replace(cut, n_layers=min(cut.n_layers, SSM_TRAIN_LAYERS))
    print(f"[train] {cfg.name} layers {cfg.n_layers} -> {cut.n_layers} by the reckoning above "
          f"and the cap of {SSM_TRAIN_LAYERS} ({card})")
    bwd_launches = train_full_width(card, cut, SSM_TRAIN_BATCH)
    print(f"[train] {cfg.name} wall {time.perf_counter() - t0} s ({card})")
    t0 = time.perf_counter()
    fwd, bwd = d80_times(card)
    print(f"[time] D = 80 wall {time.perf_counter() - t0} s ({card})")
    print(f"[ssm] phase wall {time.perf_counter() - t_phase} s ({card})")
    csrc = "src/repro_torch/kernels/flash_attention/csrc/"
    serve_t = fwd[D80_SERVE]
    launches = {"wgmma": (serve_counts["flash_attention"][0], bwd_launches),
                "mma_sync": on_sync}
    return [entry for route, fwd_src, bwd_src in (
        ("wgmma", "flash_attention_wgmma.cu", "flash_attention_bwd_wgmma.cu"),
        ("mma_sync", "flash_attention.cu", "flash_attention_bwd.cu"))
        for entry in (
        {"name": f"flash_attention_{route}_d80", "route": "cuda", "source": csrc + fwd_src,
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:42",
         "launches": launches[route][0],
         "max_abs_err": d80_errs[(route, "fwd", D80_SERVE)], "ms": serve_t[route],
         "plain_ms": serve_t["plain"], "bound_ms": serve_t["bound_ms"],
         "bound_by": serve_t["bound_by"], "library_ms": serve_t["sdpa"]},
        {"name": f"flash_attention_bwd_{route}_d80", "route": "cuda", "source": csrc + bwd_src,
         "replaces": "src/repro/models/attention.py:97", "launches": launches[route][1],
         **bwd_entry(bwd, route, d80_errs[(route, "bwd", D80_TRAIN)])})]


def xlstm_finite_train(card: str, cfg) -> None:
    """xlstm-125m at full width and depth in bf16 trained XLSTM_FINITE_STEPS
    steps at S = XLSTM_FINITE_SEQ, where the sLSTM's gradient stays within
    f32 (in the reference too), its batch XLSTM_FINITE_BATCH: every loss and
    gradient norm finite, the loss going down, no flash call."""
    shape = ShapeConfig(f"S = {XLSTM_FINITE_SEQ}", "train", XLSTM_FINITE_SEQ,
                        XLSTM_FINITE_BATCH)
    reset_all_counts()
    _, history = train_loop(cfg, shape, steps=XLSTM_FINITE_STEPS, log_every=1, seed=SEED,
                            device="cuda")
    counts = all_counts()
    losses = [m["loss"] for m in history]
    norms = [m["grad_norm"] for m in history]
    print(f"[train] {cfg.name} bf16 B={XLSTM_FINITE_BATCH} S={XLSTM_FINITE_SEQ}: losses "
          f"{losses}, gradient norms {norms}, step s {[m['step_s'] for m in history]}; counts "
          f"{counts} ({card})")
    if not (all(np.isfinite(losses)) and all(np.isfinite(norms)) and losses[-1] < losses[0]
            and all(c == (0, 0) for c in counts.values())):
        raise SystemExit(f"{cfg.name} at S = {XLSTM_FINITE_SEQ}: non-finite or rising losses, "
                         f"or a kernel launched: {history}, {counts}")


def xlstm_phase(card: str) -> None:
    """Phase 13: xlstm-125m served at full width and depth (its batch from
    the printed reckoning, counted: ``serve_full_width``, no flash call);
    its reduced configuration card against CPU (serve, train); a reduced
    forward and backward with no host sync and a reduced bf16 step repeated
    bitwise, counted together (no flash call); xlstm-125m trained at full
    width, its depth cut to its first XLSTM_TRAIN_LAYERS, its batch the
    largest of XLSTM_TRAIN_BATCHES that the printed reckoning fits
    (``train_full_width``: both MFU figures, the profile with the mLSTM and
    sLSTM recurrences as entries of their own, the idle share)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    cfg = get_config(XLSTM_ARCH)
    serve_counts = serve_full_width(cfg, serve_batch_cut(cfg, card), rng, card)
    print(f"[serve] {cfg.name} wall {time.perf_counter() - t_phase} s ({card})")
    t0 = time.perf_counter()
    small_serve_check(XLSTM_ARCH, rng)
    train_small_check(card, XLSTM_ARCH)
    reset_all_counts()
    ssm_sync_check(card, XLSTM_ARCH, "xlstm")
    repeat_check(get_reduced(XLSTM_ARCH), "xlstm", card)
    reduced = all_counts()
    print(f"[xlstm] reduced {get_reduced(XLSTM_ARCH).name}: card against CPU, the sync check "
          f"and the repeated step; the last two counted (launches, plain_calls): {reduced}; "
          f"wall {time.perf_counter() - t0} s ({card})")
    if any(c != (0, 0) for c in [*reduced.values(), *serve_counts.values()]):
        raise SystemExit(f"the xLSTM runs launched a kernel or ran a plain version: serve "
                         f"{serve_counts}, reduced {reduced}")
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=XLSTM_TRAIN_LAYERS, slstm_indices=tuple(
        i for i in cfg.slstm_indices if i < XLSTM_TRAIN_LAYERS))
    print(f"[train] {cfg.name} trained at {XLSTM_TRAIN_LAYERS} of {cfg.n_layers} layers, sLSTM "
          f"at {cut.slstm_indices} ({card})")
    train_full_width(card, cut, train_batch_cut(cut, card, XLSTM_TRAIN_BATCHES),
                     finite_grads=False)
    print(f"[train] {cfg.name} wall {time.perf_counter() - t0} s ({card})")
    t0 = time.perf_counter()
    xlstm_finite_train(card, cfg)
    print(f"[train] {cfg.name} at S = {XLSTM_FINITE_SEQ} wall {time.perf_counter() - t0} s "
          f"({card})")
    print(f"[xlstm] phase wall {time.perf_counter() - t_phase} s ({card})")


def fenced_ms(fn, n: int = 5) -> float:
    """Median over ``n`` calls of the host-clock time of one call of
    ``fn()`` between synchronize fences, in ms."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def virtual_mesh(n: int) -> tuple:
    """n virtual devices on the one card."""
    return ("cuda:0",) * n


def dd_phase(card: str) -> int:
    """Phase 14 (a) and (b): the domain-decomposed PAop on virtual devices
    of the card against the global operator, counted and timed; returns
    the PAop launches of one DD apply at the 51.17M-DoF size."""
    shape = ELASTICITY_SHAPES[DD_SHAPE]
    space = H1Space(beam_hex().refined(shape.n_h_refine), shape.p)
    m = space.mesh
    dd = SlabDecomposition(space, virtual_mesh(DD_SHARDS), dtype=torch.float32)
    print(f"[dd] {DD_SHAPE}: p={shape.p}, {m.nx}x{m.ny}x{m.nz} elements, {space.ndof} DoFs, "
          f"f32, on {DD_SHARDS} virtual devices of cuda:0: grid {dd.gx}x{dd.gy}, "
          f"{dd.bx}x{dd.by}x{m.nz} elements and {dd.block_ids.shape[1]} nodes a shard")
    if (dd.gx, dd.gy, dd.bx, dd.by) != (2, 2, m.nx // 2, m.ny // 2):
        raise SystemExit(f"DD grid {dd.gx}x{dd.gy} is not 2x2")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((space.nscalar, 3), generator=gen, dtype=torch.float32, device="cuda")
    op = ElasticityOperator(space, "paop_cuda", dtype=torch.float32, device="cuda")
    y_ref = op.apply(x)
    xb = dd.to_blocks(x)
    if [b.device for b in (*xb, *dd.lam_blocks)] != [torch.device("cuda", 0)] * 2 * DD_SHARDS:
        raise SystemExit("DD blocks are not on their mesh devices")
    reset_all_counts()
    yb = dd.apply_blocks(xb)
    torch.cuda.synchronize()
    launches, plain = all_counts()["pa_elasticity"]
    y = dd.from_blocks(yb)
    scale = float(y_ref.abs().max())
    err = float((y - y_ref).abs().max())
    planes_equal = all(torch.equal(y[torch.as_tensor(ids, device="cuda")], b)
                       for ids, b in zip(dd.block_ids, yb))
    print(f"[dd] one DD apply: PAop launches {launches}, plain calls {plain}; against the "
          f"global paop_cuda apply: max abs diff {err:.3e}, {err / scale:.3e} of max |y| "
          f"(tolerance {DD_F32_TOL}); shared planes equal in every block: {planes_equal}")
    if (launches, plain) != (DD_SHARDS, 0):
        raise SystemExit(f"a DD apply launched PAop {launches} times with {plain} plain calls")
    if not (bool(torch.isfinite(y).all()) and err <= DD_F32_TOL * scale and planes_equal):
        raise SystemExit("the DD apply disagrees with the global operator")
    del y, yb
    dd_ms = fenced_ms(lambda: dd.apply_blocks(xb))
    glob_ms = fenced_ms(lambda: op.apply(x))
    split = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ys = [dd.local_apply(k, b) for k, b in enumerate(xb)]
        ev[1].record()
        dd.halo_exchange(ys)
        ev[2].record()
        ev[2].synchronize()
        split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        del ys
    local_ms = statistics.median(t[0] for t in split)
    halo_ms = statistics.median(t[1] for t in split)
    print(f"[dd] {card}: DD apply {dd_ms} ms fenced (median of 5), four shards queued on one "
          f"card (says nothing of traffic between cards)")
    print(f"[dd] {card}: halo rounds {halo_ms} ms by CUDA events, "
          f"{100 * halo_ms / (local_ms + halo_ms)}% of local applies {local_ms} ms + halo "
          f"(median of 5)")
    print(f"[dd] {card}: global paop_cuda apply {glob_ms} ms fenced (median of 5); DD / "
          f"global {dd_ms / glob_ms}")
    del dd, op, x, xb, y_ref
    torch.cuda.empty_cache()

    space = H1Space(beam_hex().refined(MAIN_REFINE), MAIN_P)
    op = ElasticityOperator(space, "paop_cuda", dtype=torch.float64, device="cuda")
    x = torch.randn((space.nscalar, 3), generator=gen, dtype=torch.float64, device="cuda")
    y_ref = op.apply(x)
    scale = float(y_ref.abs().max())
    for n in DD_F64_SHARDS:
        dd = SlabDecomposition(space, virtual_mesh(n), dtype=torch.float64)
        reset_all_counts()
        y = dd.from_blocks(dd.apply_blocks(dd.to_blocks(x)))
        counts = all_counts()["pa_elasticity"]
        diff = (y - y_ref).abs()
        ok = bool((diff <= DD_F64_RTOL * y_ref.abs() + 1e-12 * scale).all())
        print(f"[dd] p={MAIN_P} refine={MAIN_REFINE} f64 on {n} virtual device(s), grid "
              f"{dd.gx}x{dd.gy}: max abs diff {float(diff.max()):.3e} against the global "
              f"apply, within rtol {DD_F64_RTOL}: {ok}; (launches, plain calls) {counts}")
        if not ok or counts != (n, 0):
            raise SystemExit(f"the f64 DD on {n} devices disagrees with the global operator")
        del dd, y, diff
    del op, x, y_ref
    torch.cuda.empty_cache()
    return launches


def sharded_batched_check(batch_iters: list[int], card: str) -> None:
    """Phase 14 (c): phase 5's batch with the scenario axis on 2 and 4
    virtual devices against the unsharded solver: per-row iterations and
    flags, solutions, host syncs of a warm prepare and of every chunk, PAop
    launches; the wall time of one solve() each."""
    mats, trs, tols = batched_scenarios()
    ones = np.ones(BATCH_S, bool)
    runs = {}
    for n in (None, *MESH_SIZES):
        mesh = None if n is None else virtual_mesh(n)
        solver = BatchedGMGSolver(beam_hex(), MAIN_REFINE, MAIN_P, precision="f64",
                                  device="cuda", mesh=mesh)
        lam, mu = solver.pack_materials(mats)
        # A first prepare builds each level's index tables on the card (two
        # copies a level); the counted one runs warm.
        solver.prepare(lam, mu, ones, solver.empty_prep(BATCH_S))
        reset_all_counts()
        prep, prep_sites = sync_sites(
            lambda: solver.prepare(lam, mu, ones, solver.empty_prep(BATCH_S)))
        prep_syncs = sum(prep_sites.values())
        state, chunk_syncs, first = solver.empty_state(BATCH_S), [], True
        while first or bool(gather_scenario(state.active).any()):
            (state, _), syncs = count_syncs(
                lambda: solver.run_chunk(trs, tols, ones, state, prep, MESH_CHUNK,
                                         do_reset=first))
            chunk_syncs.append(syncs)
            first = False
        counts = all_counts()
        res = bpcg_result(state)
        del state, prep, lam, mu
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = solver.solve(mats, trs, tols)
        torch.cuda.synchronize()
        t_solve = time.perf_counter() - t0
        born = (res.iterations == 0) & (res.initial_norm == 0)
        runs[n] = (res.x, res.iterations.tolist(), res.converged.tolist(), born.tolist(),
                   res.final_norm, prep_syncs, chunk_syncs)
        tag = "unsharded" if n is None else f"{n} virtual devices"
        print(f"[mesh batched] {tag}: iters {res.iterations.tolist()}, converged "
              f"{res.converged.tolist()}; host syncs: prepare {prep_syncs} "
              f"({dict(prep_sites)}), chunks of {MESH_CHUNK} {chunk_syncs}; counts "
              f"(launches, plain_calls) {counts}; solve() {t_solve} s wall ({card})")
        if not (torch.equal(full.iterations, res.iterations)
                and float((full.x - res.x).abs().max()) <= MESH_X_REL * float(res.x.abs().max())):
            raise SystemExit(f"{tag}: solve() differs from its chunked run")
        if counts["pa_elasticity"][0] == 0 or any(c[1] for c in counts.values()):
            raise SystemExit(f"{tag}: the chunks did not run only through the PAop kernel")
        del solver, res, full
        torch.cuda.empty_cache()
    x0, iters0, conv0, born0, fin0, prep0, chunks0 = runs[None]
    if iters0 != batch_iters:
        raise SystemExit(f"unsharded chunked iterations {iters0} differ from phase 5's "
                         f"{batch_iters}")
    scale = float(x0.abs().max())
    for n in MESH_SIZES:
        x, iters, conv, born, fin, prep_syncs, chunk_syncs = runs[n]
        rel = float((x - x0).abs().max()) / scale
        norm_rel = float(((fin - fin0).abs() / fin0.abs().clamp_min(1e-300)).max())
        print(f"[mesh batched] {n} virtual devices against unsharded: iterations, converged, "
              f"born_converged equal: {(iters, conv, born) == (iters0, conv0, born0)}; max "
              f"|x| diff {rel:.3e} of max |x|; final norms within {norm_rel:.3e}; host syncs "
              f"equal: prepare {prep_syncs == prep0}, every chunk {chunk_syncs == chunks0}")
        if (iters, conv, born) != (iters0, conv0, born0) or rel > MESH_X_REL \
                or norm_rel > MESH_NORM_RTOL:
            raise SystemExit(f"the batch on {n} virtual devices differs from the unsharded one")
        if chunk_syncs != chunks0 or prep_syncs != prep0:
            raise SystemExit(f"the batch on {n} virtual devices makes other host syncs than "
                             f"the unsharded one")
    del runs
    torch.cuda.empty_cache()


def check_reports_close(tag: str, got: list, want: list, against: str = "unsharded") -> None:
    """Per request the same iterations and flags as ``want`` (the
    ``against`` run's), residuals within MESH_NORM_RTOL and kept solutions
    within MESH_X_REL of max |x|."""
    worst_x = worst_norm = 0.0
    for g, w in zip(got, want, strict=True):
        if (g.iterations, g.converged, g.born_converged) != (w.iterations, w.converged,
                                                              w.born_converged):
            raise SystemExit(f"{tag}: request {g.ticket} gave {g.iterations} iterations, "
                             f"converged {g.converged}; {against} {w.iterations}, {w.converged}")
        if w.final_rel_norm:
            worst_norm = max(worst_norm, abs(g.final_rel_norm / w.final_rel_norm - 1.0))
        if w.x is not None:
            worst_x = max(worst_x, float(np.abs(g.x - w.x).max() / np.abs(w.x).max()))
    print(f"[mesh service] {tag}: iterations and flags equal to the {against} run's; "
          f"residuals within {worst_norm:.3e}, kept solutions within {worst_x:.3e} of max |x|")
    if worst_norm > MESH_NORM_RTOL or worst_x > MESH_X_REL:
        raise SystemExit(f"{tag}: residuals or solutions differ from the {against} run's")


def restore_request(i: int, rel_tol=None) -> SolveRequest:
    mats = ({1: (50.0, 50.0), 2: (1.0, 1.0)}, {1: (80.0, 60.0), 2: (2.0, 1.0)},
            {1: (9.0, 9.0), 2: (1.0, 3.0)})[i % 3]
    return SolveRequest(p=MESH_RESTORE_P, refine=MESH_RESTORE_REFINE, materials=mats,
                        traction=(0.0, 2e-3 * (i % 2), -1e-2 * (1.0 + 0.25 * i)),
                        rel_tol=(1e-8 if i % 2 else 1e-10) if rel_tol is None else rel_tol,
                        keep_solution=True)


def drained(svc: ElasticityService) -> dict:
    while not svc.idle():
        svc.step()
    return {r.ticket: r for r in svc.drain()}


def sharded_service_check(fixed: list, gen: list, card: str) -> None:
    """Phase 14 (d): phase 5b's service with its scenario axis on two
    virtual devices, generational and continuous, against the unsharded
    runs."""
    reqs = service_requests()
    svc = ElasticityService(max_batch=BATCH_S, precision="f64", chunk_iters=SERVICE_CHUNK,
                            device="cuda", mesh=virtual_mesh(2))
    for continuous, want in ((False, gen), (True, fixed)):
        tag = "continuous fixed" if continuous else "generational"
        reps, dt, counts, stats, _, latency = service_run(svc, reqs, continuous=continuous)
        check_service_counts(f"2-device {tag}", counts, want_probe=not continuous)
        print(f"[mesh service] 2 virtual devices, {tag}: {dt} s ({card}), padded rows "
              f"{sorted({r.padded_rows for r in reps})}; counts {counts}; stats {stats}")
        check_reports_close(f"2 virtual devices, {tag}", reps, want)
        if any(r.padded_rows % 2 for r in reps):
            raise SystemExit("a sharded bucket does not divide the mesh")
    del svc
    torch.cuda.empty_cache()


def sharded_restore_check() -> None:
    """Phase 14 (d): a checkpoint on two virtual devices restored onto two
    (bitwise) and onto one, beside undisturbed runs on one and on two
    devices as the witness of what a change of rows a program does; and
    a 3-row flight restored onto two (the re-bucket branch)."""

    def service(n: int, max_batch: int) -> ElasticityService:
        return ElasticityService(max_batch=max_batch, chunk_iters=2, device="cuda",
                                 mesh=virtual_mesh(n))

    tmp = tempfile.mkdtemp(prefix="mesh_restore_")
    try:
        # a checkpoint on two virtual devices restored onto two and onto one
        reqs = [restore_request(i) for i in range(6)]

        def undisturbed(n: int) -> dict:
            svc = service(n, BATCH_S)
            for r in reqs:
                svc.submit(r)
            return drained(svc)

        def restored(n: int, where: str) -> tuple[dict, list]:
            svc = service(2, BATCH_S)
            rec = ServiceRecovery(svc, os.path.join(tmp, where), every=1)
            for r in reqs:
                svc.submit(r)
            svc.step()
            rec.maybe_checkpoint()
            svc = service(n, BATCH_S)
            if not ServiceRecovery(svc, os.path.join(tmp, where)).restore():
                raise SystemExit("no checkpoint to restore from")
            buckets = [fl.bucket for fl in svc._flights.values()]
            got = drained(svc)
            if set(got) != set(base):
                raise SystemExit(f"the restore onto {n} device(s) lost or added tickets")
            return got, buckets

        def bitwise(got: dict, want: dict) -> bool:
            return all(got[t].final_rel_norm == w.final_rel_norm
                       and np.array_equal(got[t].x, w.x) for t, w in want.items())

        base, base1 = undisturbed(2), undisturbed(1)
        got2, _ = restored(2, "a2")
        got, buckets = restored(1, "a1")
        same_layout, rows_matter = bitwise(got2, base), not bitwise(base1, base)
        print(f"[mesh restore] p={MESH_RESTORE_P} refine={MESH_RESTORE_REFINE}, 6 requests "
              f"checkpointed after step 1 on 2 virtual devices (4 rows a program): restored "
              f"onto 2, bitwise as the undisturbed 2-device run: {same_layout}; restored "
              f"onto 1 (buckets {buckets}, identity path, 8 rows a program), bitwise as the "
              f"undisturbed 2-device run: {bitwise(got, base)}, as the undisturbed 1-device "
              f"run: {bitwise(got, base1)}; the undisturbed 1- and 2-device runs differ: "
              f"{rows_matter}")
        if not same_layout:
            raise SystemExit("the restore onto the same 2 devices is not bitwise")
        # The witness: when the undisturbed 1- and 2-device runs differ, the
        # card's GEMMs and row reductions depend on how many rows a program
        # holds, and a change of rows a program is held to the tolerances of
        # a change of mesh.  When they do not, the restore onto one device
        # must be bitwise too.
        if rows_matter:
            check_reports_close("restore 2 -> 1 virtual devices", [got[t] for t in sorted(base)],
                                [base[t] for t in sorted(base)], against="undisturbed")
        elif not bitwise(got, base):
            raise SystemExit("the restore onto one device is not bitwise, while the "
                             "undisturbed 1- and 2-device runs are")

        # a 3-row flight (max_batch 3 on 3 devices) restored onto two
        reqs = [restore_request(0), restore_request(1, rel_tol=1e-1), restore_request(2)]
        base = service(3, 3)
        for r in reqs:
            base.submit(r)
        base = drained(base)
        svc = service(3, 3)
        rec = ServiceRecovery(svc, os.path.join(tmp, "b"), every=1)
        for r in reqs:
            svc.submit(r)
        svc.step()
        svc.step()
        rec.maybe_checkpoint()
        (fl,) = svc._flights.values()
        old = (fl.bucket, [None if s is None else s.ticket for s in fl.slots])
        svc = service(2, 3)
        if not ServiceRecovery(svc, os.path.join(tmp, "b")).restore():
            raise SystemExit("no checkpoint to restore from")
        (fl,) = svc._flights.values()
        new = (fl.bucket, [None if s is None else s.ticket for s in fl.slots])
        rebuckets = svc.stats["rebuckets"]
        got = drained(svc)
        kept = [t for t in (0, 2) if old[1].index(t) == new[1].index(t)]
        moved = [t for t in (0, 2) if t not in kept]
        flags = all((got[t].iterations, got[t].converged) == (b.iterations, b.converged)
                    for t, b in base.items()) and set(got) == set(base)
        kept_ok = all(np.array_equal(got[t].x, base[t].x)
                      and got[t].final_rel_norm == base[t].final_rel_norm for t in kept)
        moved_rel = max(float(np.abs(got[t].x - base[t].x).max() / np.abs(base[t].x).max())
                        for t in moved)
        print(f"[mesh restore] 3-row flight (bucket, tickets by slot) {old} on 3 virtual "
              f"devices restored onto 2 as {new}, rebuckets {rebuckets}: iterations and flags "
              f"equal {flags}; kept tickets {kept} bitwise {kept_ok}; moved tickets {moved} "
              f"within {moved_rel:.3e} of max |x|")
        if old != (3, [0, None, 2]) or new != (2, [0, 2]) or rebuckets != 1:
            raise SystemExit("the restore onto two devices did not take the re-bucket branch")
        if not (flags and kept_ok and moved_rel <= MESH_X_REL):
            raise SystemExit("the re-bucketed restore differs from the undisturbed run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def devices_cli_check() -> subprocess.Popen:
    """Phase 14 (e): ``serve_solve --devices N`` with one more card than the
    host has; started here, beside the phase's other checks, and held by
    :func:`devices_cli_result`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_solve", "--devices",
         str(torch.cuda.device_count() + 1), "--n-requests", "2", "--p", "1", "--refine", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def devices_cli_result(proc: subprocess.Popen) -> None:
    """Phase 14 (e)'s run raised, naming the card count."""
    n = torch.cuda.device_count()
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    last = (err.strip().splitlines() or [""])[-1]
    print(f"[mesh cli] serve_solve --devices {n + 1} on {n} card(s): exit {proc.returncode}, "
          f"{last}")
    if proc.returncode == 0 or f"the host has {n}" not in last:
        raise SystemExit("serve_solve --devices past the host's cards did not raise")


def multidevice_phase(card: str, batch_iters: list[int], fixed: list, gen: list) -> int:
    """Phase 14: the multi-device solver side on virtual devices of the
    card; returns the PAop launches of one DD apply."""
    t_phase = time.perf_counter()
    cli = devices_cli_check()
    try:
        launches = dd_phase(card)
        print(f"[dd] (a), (b) done at {time.perf_counter() - t_phase} s of the phase")
        sharded_batched_check(batch_iters, card)
        print(f"[mesh batched] (c) done at {time.perf_counter() - t_phase} s of the phase")
        sharded_service_check(fixed, gen, card)
        sharded_restore_check()
        print(f"[mesh restore] (d) done at {time.perf_counter() - t_phase} s of the phase")
    except BaseException:
        cli.kill()
        cli.wait()
        raise
    devices_cli_result(cli)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the LM side on a mesh of virtual devices of the card
# ---------------------------------------------------------------------------
def mesh_train_reckoning(cfg, batch: int, mesh) -> tuple[int, str]:
    """The reckoned training peak of ``cfg`` at ``batch`` x TRAIN_SEQ on
    ``mesh``, in bytes, and its printed terms: :func:`train_reckoning`'s
    (the state and the stacked gradient split into blocks that sum to the
    whole), with the residual kept between blocks and one block's
    transients once a model device (each keeps and computes its replica of
    its data row's rows), every device's gather of one layer's weights in
    the forward and again in the backward (at most the whole layer each),
    and each data row's first device's gather of the embedding or head
    (its weight and its gradient)."""
    need, terms = train_reckoning(cfg, batch)
    M, n = mesh.shape.get("model", 1), mesh.size
    D = n // M
    shapes = param_shapes(cfg)
    layer = sum(math.prod(sh[1:]) for sh in _leaves(shapes["blocks"])) * 2
    saved = cfg.n_layers * batch * TRAIN_SEQ * cfg.d_model * 2 * (M - 1)
    block = ffn_transients(cfg, batch, TRAIN_SEQ) * (M - 1)
    head = 2 * D * math.prod(shapes.get("lm_head", shapes["embed"])) * 2
    gathers = 2 * n * layer
    extra = saved + block + gathers + head
    return need + extra, (f"{terms} + on the {mesh.shape} mesh: replicas kept between blocks "
                          f"{saved / 1e9:.2f} GB + replicas' block transients {block / 1e9:.2f} "
                          f"GB + gathered layer weights {gathers / 1e9:.2f} GB + gathered head "
                          f"{head / 1e9:.2f} GB")


def clone_state(state):
    """A copy of a train state on a mesh, block for block."""
    def clone(x):
        if isinstance(x, Sharded):
            return Sharded([b.detach().clone().requires_grad_(b.requires_grad)
                            for b in x.blocks], x.spec, x.mesh, x.shape)
        return x.clone() if isinstance(x, torch.Tensor) else x

    return dataclasses.replace(state, params=_tree_map(clone, state.params),
                               opt_state=_tree_map(clone, state.opt_state),
                               step=state.step.clone())


def state_blocks(state) -> list:
    """Every tensor of a train state on a mesh: each leaf's blocks, and the
    counters."""
    return [b for x in _leaves([state.params, state.opt_state, state.step])
            for b in (x.blocks if isinstance(x, Sharded) else (x,))]


def mesh_batch(cfg, shape, step: int) -> dict:
    return {k: torch.from_numpy(a) for k, a in make_batch(cfg, shape, step, SEED).items()}


def mesh_steps(cfg, shape, state, mesh, steps, opt, card: str = "", profile=False
               ) -> list[float]:
    """Steps ``steps`` (batch indices) of ``state`` on ``mesh``, in place;
    returns their losses.  With ``profile`` the first runs under the
    profiler: its device time by category, the collectives (each gather
    with its backward's reduce-scatter, each all-reduce both ways) and the
    replica sums by their ranges."""
    step_fn = make_train_step(cfg, opt, mesh=mesh)
    losses = []
    for j, i in enumerate(steps):
        batch = mesh_batch(cfg, shape, i)
        out = []

        def one():
            out.append(step_fn(state, batch))
            torch.cuda.synchronize()

        if profile and j == 0:
            ms, count, busy, top = device_time_by_category(
                one, TRAIN_CATEGORIES, {
                    "replica sums": "train.reduce_replicas",
                    "all-gathers and their reduce-scatters": "collective.all_gather",
                    "all-reduces": "collective.all_reduce", "AdamW": "train.optimizer"},
                other="elementwise/copies")
            parts = ", ".join(f"{c} {ms[c]} ms ({100 * ms[c] / busy:.1f}%, x{count[c]})"
                              for c in ms)
            print(f"[lm mesh] profile of step {i + 1} on {mesh.shape}: device busy {busy} ms: "
                  f"{parts} ({card})")
            for c, rows in top.items():
                for name, t, calls in rows[:TRAIN_TOP_KERNELS]:
                    print(f"[lm mesh]   {c}: {t:9.3f} ms x{calls:<5d} {name[:110]}")
        else:
            one()
        new, m = out[0]
        losses.append(float(m["loss"]))
        state.params, state.opt_state, state.step = new.params, new.opt_state, new.step
    return losses


def lm_mesh_train(card: str) -> tuple[dict, list]:
    """Phase 15(a): phase 9's cell through ``train_loop(mesh=)`` on a (2, 2)
    mesh of four virtual devices.  First one step twice from one state
    (bitwise); then one warm-up and TRAIN_STEPS - 1 timed steps, each
    counted (4 devices x (2L forward + L backward) wgmma launches, no plain
    call), the losses held to phase 9's; one more step profiled (the
    collectives' share).  Returns the launches over the counted run and
    its logged steps."""
    cfg = get_config(TRAIN_ARCH)
    mesh = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES)
    shape = ShapeConfig(f"train_4k, global batch 256 cut to {TRAIN_BATCH}", "train", TRAIN_SEQ,
                        TRAIN_BATCH)
    opt = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 20, 1))
    need, terms = mesh_train_reckoning(cfg, TRAIN_BATCH, mesh)
    free, total = torch.cuda.mem_get_info()
    print(f"[lm mesh] (a) {cfg.name} B={TRAIN_BATCH} S={TRAIN_SEQ} on {mesh}: reckoned {terms} "
          f"= {need / 1e9:.2f} GB; {free / 1e9:.2f} GB free of {total / 1e9:.2f} GB ({card})")

    # step 1 twice from one state
    t0 = time.perf_counter()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(SEED), cfg, mesh=mesh)
    twin = clone_state(state)
    runs = []
    for st in (state, twin):
        runs.append(mesh_steps(cfg, shape, st, mesh, [0], opt))
    same = runs[0] == runs[1] and all(
        torch.equal(a, b) for a, b in zip(state_blocks(state), state_blocks(twin)))
    del state, twin
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm mesh] (a) step 1 twice from one state on {mesh.shape}: loss {runs[0][0]!r}; "
          f"loss, parameters and moments {'bitwise equal' if same else 'DIFFER'} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise SystemExit("a train step on the mesh is not bitwise repeatable")

    per_step = []

    @contextlib.contextmanager
    def counted(i):
        reset_all_counts()
        yield
        per_step.append((all_counts(), dict(flash_ops.route_launches),
                         dict(flash_ops.bwd_route_launches)))

    L, n = cfg.n_layers, mesh.size
    t0 = time.perf_counter()
    state, history = train_loop(cfg, shape, steps=TRAIN_STEPS, log_every=1, seed=SEED,
                                opt=opt, mesh=mesh, step_context=counted)
    t_loop = time.perf_counter() - t0
    print(f"[lm mesh] (a) train_loop wall {t_loop:.1f} s, of which steps "
          f"{sum(m['step_s'] for m in history):.1f} s; the rest is the state's init and layout")
    want = {"flash_attention": (n * 2 * L, 0), "flash_attention_bwd": (n * L, 0)}
    for i, (counts, routes, bwd_routes) in enumerate(per_step):
        got = {k: counts[k] for k in want}
        print(f"[lm mesh] (a) step {i + 1} counts (launches, plain_calls): {got}; forward "
              f"routes {routes}, backward routes {bwd_routes}")
        if got != want or routes["wgmma"] != n * 2 * L or bwd_routes["wgmma"] != n * L:
            raise SystemExit(f"mesh train step {i + 1}: {got}, routes {routes}, {bwd_routes}; "
                             f"expected {want} on wgmma")
    ref = TRAIN_HISTORY[cfg.name]
    rel = [abs(m["loss"] - r["loss"]) / abs(r["loss"]) for m, r in zip(history, ref)]
    timed = history[1:]
    step_s = statistics.median(m["step_s"] for m in timed)
    ref_s = statistics.median(r["step_s"] for r in ref[1:])
    T = TRAIN_BATCH * TRAIN_SEQ
    print(f"[lm mesh] (a) {cfg.name} bf16 L={L} on {mesh.shape} ({n} virtual devices of one "
          f"card, local flash shape ({TRAIN_BATCH // (n // LM_MESH_MP)}, {TRAIN_SEQ}, "
          f"{cfg.n_heads // LM_MESH_MP}, {cfg.n_kv_heads // LM_MESH_MP}, {cfg.head_dim_})): "
          f"losses {[m['loss'] for m in history]}, phase 9's {[r['loss'] for r in ref]}, rel "
          f"diff {rel} (limit {LM_MESH_LOSS_REL}); grad norms {[m['grad_norm'] for m in history]}"
          f" (phase 9's {[r['grad_norm'] for r in ref]}); timed steps 2-{TRAIN_STEPS}: step s "
          f"{[m['step_s'] for m in timed]}, median {step_s} s, {T / step_s} tokens/s, "
          f"{step_s / ref_s}x phase 9's {ref_s} s; peak {max(m['peak_gib'] for m in history)} "
          f"GiB ({card}; traffic between cards not measured: one card)")
    if len(history) != TRAIN_STEPS or max(rel) > LM_MESH_LOSS_REL or not all(
            np.isfinite(m["grad_norm"]) for m in history):
        raise SystemExit(f"the mesh run's losses are off phase 9's: {rel}")
    if history[0]["loss"] != runs[0][0]:
        raise SystemExit(f"train_loop's step 1 {history[0]['loss']!r} is not the repeated "
                         f"step's {runs[0][0]!r}")
    launches = {k: sum(c[k][0] for c, _, _ in per_step) for k in want}
    LM_MESH_PEAK.append(max(m["peak_gib"] for m in history))
    loss = mesh_steps(cfg, shape, state, mesh, [TRAIN_STEPS], opt, card, profile=True)
    print(f"[lm mesh] (a) the profiled step {TRAIN_STEPS + 1}: loss {loss[0]!r} ({card})")
    if not np.isfinite(loss[0]):
        raise SystemExit(f"15(a)'s profiled step: loss {loss[0]}")
    return launches, history


def moe_layer_check(cfg, mesh, card: str) -> None:
    """Phase 15(b): one MoE layer of ``cfg`` at full width in bf16, random
    weights and input (B = MOE_TRAIN_BATCH, S = TRAIN_SEQ), through
    ``moe_mesh_apply`` on ``mesh`` (its leaves laid out by
    ``param_pspecs``, each data row's rows on its devices) against
    ``moe_apply`` run unsharded on each data row's rows: the expert ids
    identical and the outputs within LM_MESH_LOSS_REL of max |unsharded|
    (capacity is per batch row, so a row's routing and drops do not depend
    on the other rows); the global aux loss against ``moe_apply`` on the
    whole batch to the same tolerance.  The ids of ``moe_apply`` on the
    whole batch are compared too and printed: the router's f32 product
    rounds differently at another row count, and random-init gates are
    near uniform, so some flip."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    p = moe_module.moe_init(g, cfg, torch.bfloat16)
    x = torch.randn((MOE_TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), device="cuda",
                    generator=g).to(torch.bfloat16)
    sh = place({"moe": p}, param_pspecs({"moe": p}, mesh), mesh)["moe"]
    rows = x.chunk(mesh.shape["data"])
    leaders = mesh.leaders()
    kept, inner = record_routes()
    try:
        with torch.no_grad():
            per_row = [moe_module.moe_apply(p, r, cfg)[0] for r in rows]
            y_all, aux = moe_module.moe_apply(p, x, cfg)
            ys, aux_m = moe_module.moe_mesh_apply(
                sh, [rows[mesh.coords(k)["data"]] for k in range(mesh.size)], cfg, mesh)
    finally:
        moe_module.route = inner
    nr = len(rows)
    ids_rows, ids_all, ids_mesh = kept[:nr], kept[nr], kept[nr + 1:]
    same = all(torch.equal(ids_mesh[k], ids_rows[mesh.coords(k)["data"]])
               for k in range(mesh.size))
    y_m, y_r = torch.cat([ys[k] for k in leaders]), torch.cat(per_row)
    y_err = float((y_m.float() - y_r.float()).abs().max()) / float(y_r.float().abs().max())
    bitwise = "bitwise" if torch.equal(y_m, y_r) else "not bitwise"
    aux_err = abs(float(aux_m) - float(aux)) / abs(float(aux))
    whole = torch.cat([ids_mesh[k] for k in leaders])
    print(f"[lm mesh] (b) one {cfg.name} MoE layer (B={MOE_TRAIN_BATCH}, S={TRAIN_SEQ}, bf16) on "
          f"{mesh.shape}, expert parallel: expert ids on every device "
          f"{'identical to' if same else 'DIFFER from'} moe_apply's on its data row's rows; "
          f"outputs max abs err {y_err:.3e} of max ({bitwise}); "
          f"aux {float(aux_m)!r}, moe_apply's on the whole batch {float(aux)!r} (rel "
          f"{aux_err:.3e}); ids equal to moe_apply's on the whole batch: "
          f"{int((whole == ids_all).sum())} of {whole.numel()} (the router at another row "
          f"count) ({card})")
    if not same or y_err > LM_MESH_LOSS_REL or aux_err > LM_MESH_LOSS_REL:
        raise SystemExit("the expert-parallel MoE layer disagrees with moe_apply")
    # 15(f): the same layer under sequence parallelism, as mesh_loss_fn runs
    # it: each device's block of positions of its data row's rows, gathered
    # along the sequence, the MoE on the whole, each device keeping its block
    blocks = [mesh_block(rows[mesh.coords(k)["data"]], mesh, k, 1) for k in range(mesh.size)]
    kept, inner = record_routes()
    try:
        with torch.no_grad():
            ys_sp, aux_sp = moe_module.moe_mesh_apply(sh, mesh_all_gather(blocks, mesh, 1), cfg,
                                                      mesh)
    finally:
        moe_module.route = inner
    same_sp = all(torch.equal(a, b) for a, b in zip(kept, ids_mesh))
    out_sp = all(torch.equal(mesh_block(a, mesh, k, 1), mesh_block(b, mesh, k, 1))
                 for k, (a, b) in enumerate(zip(ys_sp, ys)))
    print(f"[lm mesh] (f) the same {cfg.name} MoE layer on {mesh.shape} under sequence "
          f"parallelism (blocks of {TRAIN_SEQ // mesh.shape['model']} positions gathered along "
          f"the sequence): expert ids on every device {'identical to' if same_sp else 'DIFFER from'}"
          f" (b)'s; each device's block of the output {'bitwise equal to' if out_sp else 'DIFFERS from'}"
          f" (b)'s; aux {'bitwise equal' if torch.equal(aux_sp, aux_m) else 'DIFFERS'} ({card})")
    if not same_sp or not out_sp:
        raise SystemExit("the MoE layer under sequence parallelism is not (b)'s")


def lm_mesh_moe(card: str) -> None:
    """Phase 15(b): olmoe-1b-7b in bf16 on a (2, 2) mesh: one full-width MoE
    layer against ``moe_apply`` (:func:`moe_layer_check`); then the model at
    the depth its mesh reckoning allows, two steps through ``train_loop``,
    the expert branch, step 1's loss (with the global aux) against the
    unsharded forward's on the same weights and batch, and the share of
    the expert ids of each layer's forward (each data row's first device's,
    concatenated) equal to the unsharded forward's, printed; then the same
    for reduced olmoe in f32 on the same mesh of the card."""
    t0 = time.perf_counter()
    mesh = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES)
    full = get_config(MOE_TRAIN_ARCH)
    branch = moe_module.moe_branch(full, TRAIN_SEQ, mesh.shape["model"])
    if branch != "expert":
        raise SystemExit(f"olmoe on {mesh.shape} took the {branch!r} branch")
    moe_layer_check(full, mesh, card)
    cfg = first_fit("lm mesh", layer_cuts(full),
                    lambda cut: mesh_train_reckoning(cut, MOE_TRAIN_BATCH, mesh), card)
    print(f"[lm mesh] (b) {cfg.name} {cfg.n_layers} of {full.n_layers} layers, B="
          f"{MOE_TRAIN_BATCH} S={TRAIN_SEQ} on {mesh.shape}: MoE branch {branch!r} "
          f"({cfg.n_experts} experts over a model axis of {mesh.shape['model']}) ({card})")
    for tag, c, sh in (("full width bf16", cfg, ShapeConfig("t", "train", TRAIN_SEQ,
                                                             MOE_TRAIN_BATCH)),
                       ("reduced f32", dataclasses.replace(get_reduced(MOE_TRAIN_ARCH),
                                                           dtype="float32"),
                        ShapeConfig("t", "train", 64, 4))):
        params = init_params(torch.Generator(device="cuda").manual_seed(SEED), c)
        batch = {k: v.cuda() for k, v in mesh_batch(c, sh, 0).items()}
        kept, inner = record_routes()
        try:
            with torch.no_grad():
                ref_loss = float(loss_fn(params, batch, c))
        finally:
            moe_module.route = inner
        ref_ids = kept
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        kept, inner = record_routes()
        try:
            _, history = train_loop(c, sh, steps=2 if c is cfg else 1, log_every=1, seed=SEED,
                                    mesh=mesh)
        finally:
            moe_module.route = inner
        gc.collect()
        torch.cuda.empty_cache()
        n, L = mesh.size, c.n_layers
        fwd = kept[:n * L]  # step 1's forward: a call a device a layer
        same = sets = total = rows = 0
        for layer in range(L):
            got = torch.cat([fwd[layer * n + k] for k in mesh.leaders()])
            same += int((got == ref_ids[layer]).sum())
            sets += int((got.sort(-1).values == ref_ids[layer].sort(-1).values).all(-1).sum())
            total, rows = total + got.numel(), rows + got[..., 0].numel()
        loss_rel = abs(history[0]["loss"] - ref_loss) / abs(ref_loss)
        print(f"[lm mesh] (b) {c.name} {tag}: step 1 loss {history[0]['loss']!r} (global aux "
              f"included), unsharded forward {ref_loss!r}, rel diff {loss_rel:.3e}; expert ids "
              f"of the {L} layers' forward: {same} of {total} equal ({same / total:.6f}), the "
              f"top-{c.top_k} sets of {sets} of {rows} tokens ({sets / rows:.6f}); steps "
              f"{[m['step_s'] for m in history]} s, peak "
              f"{max(m['peak_gib'] or 0 for m in history)} GiB ({card})")
        if loss_rel > LM_MESH_LOSS_REL:
            raise SystemExit(f"{c.name} {tag} on the mesh: loss rel {loss_rel}")
    print(f"[lm mesh] (b) wall {time.perf_counter() - t0} s ({card})")


def lm_mesh_pipeline(card: str) -> None:
    """Phase 15(c): ``pipeline_apply`` of qwen3-1.7b's blocks as
    PIPE_STAGES stages on as many virtual devices, forward only, at
    PIPE_BATCH x PIPE_SEQ in PIPE_MICRO microbatches: bitwise equal to the
    sequential apply of the same microbatches, each timed between fences,
    with the flash launches counted."""
    cfg = get_config(TRAIN_ARCH)
    params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    tokens = torch.randint(0, cfg.vocab, (PIPE_BATCH, PIPE_SEQ), device="cuda", generator=g)
    x = params["embed"][tokens]
    pos = model_positions({"tokens": tokens[:PIPE_BATCH // PIPE_MICRO]}, cfg)
    per = cfg.n_layers // PIPE_STAGES

    def stage(p, xm):
        for layer in model_unstack(p, per):
            xm = model_block(layer, xm, cfg, pos)[0]
        return xm

    staged = split_stages(params["blocks"], PIPE_STAGES)
    devs = np.empty(PIPE_STAGES, dtype=object)
    devs[:] = ["cuda:0"] * PIPE_STAGES
    mesh = LMMesh(devs.reshape(PIPE_STAGES, 1, 1), ("pod", "data", "model"))

    def piped():
        return pipeline_apply(stage, staged, x, mesh=mesh, n_micro=PIPE_MICRO)

    def sequential():
        outs = []
        for xm in x.reshape(PIPE_MICRO, -1, *x.shape[1:]):
            for s_ in range(PIPE_STAGES):
                xm = stage(_tree_map(lambda t, s_=s_: t[s_], staged), xm)
            outs.append(xm)
        return torch.stack(outs).reshape(x.shape)

    with torch.no_grad():
        reset_all_counts()
        got = piped()
        torch.cuda.synchronize()
        launches = all_counts()["flash_attention"]
        want = sequential()
        same = torch.equal(got, want)
        t_pipe, t_seq = fenced_ms(piped, 3), fenced_ms(sequential, 3)
    bubble = bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    print(f"[lm mesh] (c) pipeline_apply of {cfg.name}'s {cfg.n_layers} blocks as {PIPE_STAGES} "
          f"stages of {per} on {PIPE_STAGES} virtual devices, B={PIPE_BATCH} S={PIPE_SEQ} bf16 in "
          f"{PIPE_MICRO} microbatches, forward: {'bitwise equal to' if same else 'DIFFERS from'} "
          f"the sequential apply; flash (launches, plain) {launches}; bubble fraction {bubble} "
          f"(a schedule's idle share across {PIPE_STAGES} cards; here the stages queue on one); "
          f"wall {t_pipe} ms against the sequential {t_seq} ms ({t_pipe / t_seq}x), median of 3 "
          f"fenced ({card})")
    if not same or launches != (cfg.n_layers * PIPE_MICRO, 0):
        raise SystemExit(f"pipeline_apply: bitwise {same}, launches {launches}")


def lm_mesh_restart(card: str) -> None:
    """Phase 15(d): (a)'s cell at full width, its depth cut to
    LM_RESTART_LAYERS, trained LM_RESTART_STEPS steps on (2, 2) through
    ``train_loop`` with a gathered checkpoint of its last step; 2 of the 4
    devices fail and ``elastic_remesh`` gives (1, 2).  The undisturbed run:
    the final state resharded in memory onto (1, 2) and stepped
    LM_MESH_RESUME_STEPS times.  The restart: the checkpoint restored on the
    host and ``reshard_state``-d onto (1, 2), the same steps: bitwise equal
    to the undisturbed run, and within LM_MESH_LOSS_REL of the state's own
    continuation on (2, 2)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=LM_RESTART_LAYERS)
    shape = ShapeConfig("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    m22 = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES)
    opt = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 20, 1))
    ckpt = tempfile.mkdtemp(prefix="lm_mesh_ckpt_")
    try:
        print(f"[lm mesh] (d) checkpoint directory {ckpt}: "
              f"{shutil.disk_usage(ckpt).free / 1e9:.1f} GB free")
        state, history = train_loop(cfg, shape, steps=LM_RESTART_STEPS, seed=SEED, opt=opt,
                                    mesh=m22, ckpt_dir=ckpt)
        t_loop = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ckpt) for f in fs)
        print(f"[lm mesh] (d) {cfg.name} {LM_RESTART_LAYERS} of "
              f"{get_config(TRAIN_ARCH).n_layers} layers on {m22.shape}: train_loop wall "
              f"{t_loop:.1f} s, of which steps {sum(m['step_s'] for m in history):.1f} s; the "
              f"rest is the state's init and layout and the gathered checkpoint of step "
              f"{LM_RESTART_STEPS} ({ck_bytes / 1e9:.2f} GB on disk, the unsharded format) "
              f"({card})")
        alive = simulate_failures(list(m22.flat), 2)
        m12 = elastic_remesh(alive, model_parallel=LM_MESH_MP)
        steps = list(range(LM_RESTART_STEPS, LM_RESTART_STEPS + LM_MESH_RESUME_STEPS))
        und = reshard_state(state, state_pspecs(state, m12), m12)
        _requires_grad(und.params)
        cont = mesh_steps(cfg, shape, state, m22, steps, opt)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        und_losses = mesh_steps(cfg, shape, und, m12, steps, opt)
        t1 = time.perf_counter()
        restored, _, at = CheckpointManager(ckpt).restore_latest(_host_like(und))
        t_restore = time.perf_counter() - t1
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    res = reshard_state(restored, state_pspecs(restored, m12), m12)
    del restored
    _requires_grad(res.params)
    res_losses = mesh_steps(cfg, shape, res, m12, steps, opt)
    same = und_losses == res_losses and all(
        torch.equal(a, b) for a, b in zip(state_blocks(und), state_blocks(res)))
    rel = [abs(a - b) / abs(b) for a, b in zip(res_losses, cont)]
    print(f"[lm mesh] (d) {len(alive)} of {m22.size} devices alive -> elastic_remesh "
          f"{m12.shape}; checkpoint of step {at} restored in {t_restore:.1f} s and resharded: "
          f"steps {[i + 1 for i in steps]} losses {res_losses}, "
          f"{'bitwise equal to' if same else 'DIFFER from'} the undisturbed (1, 2) run's "
          f"{und_losses} (parameters and moments too); the continuation on {m22.shape} "
          f"{cont}, rel diff {rel} (limit {LM_MESH_LOSS_REL}); wall "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    if not same or max(rel) > LM_MESH_LOSS_REL or at != LM_RESTART_STEPS:
        raise SystemExit("the elastic restart on (1, 2) is off")
    del und, res
    gc.collect()
    torch.cuda.empty_cache()


def lm_mesh_seq_parallel(card: str, ref_a: list) -> dict:
    """Phase 15(f): phase 9's cell on (a)'s (2, 2) mesh through
    ``make_train_step(mesh=, act_spec=act_pspec(axes), logits_spec=P(dp,
    None, "model"))``: step 1 twice from one state (bitwise), then
    LM_SP_STEPS timed steps, each step counted (4 devices x (2L forward +
    L backward) wgmma launches, no plain call) and fenced, its peak read;
    the losses held to phase 9's and to (a)'s (``ref_a``, its logged
    steps); one more step profiled: the ``collective.*`` ranges' share of
    the device time.  Returns the flash launches of the counted steps."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    mesh = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES)
    shape = ShapeConfig(f"train_4k, global batch 256 cut to {TRAIN_BATCH}", "train", TRAIN_SEQ,
                        TRAIN_BATCH)
    opt = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 20, 1))
    specs = {"act_spec": act_pspec(mesh.axis_names),
             "logits_spec": P(dp_axes(mesh), None, "model")}
    step_fn = make_train_step(cfg, opt, mesh=mesh, **specs)
    L, n = cfg.n_layers, mesh.size
    want = {"flash_attention": (n * 2 * L, 0), "flash_attention_bwd": (n * L, 0)}
    launches = {k: 0 for k in want}
    ranges = {"all-gathers and their reduce-scatters": "collective.all_gather",
              "reduce-scatters and their all-gathers": "collective.reduce_scatter",
              "all-reduces": "collective.all_reduce", "replica sums": "train.reduce_replicas",
              "AdamW": "train.optimizer"}

    def run(state, i, profile=False):
        got = counted_step(step_fn, state, mesh_batch(cfg, shape, i), want,
                           f"15(f) step {i + 1}", ranges if profile else None)
        for k in want:
            launches[k] += got[5][k]
        return got[:5]

    state = train_state_init(torch.Generator(device="cuda").manual_seed(SEED), cfg, mesh=mesh)
    twin = clone_state(state)
    first = [run(st, 0) for st in (state, twin)]
    same = first[0][:2] == first[1][:2] and all(
        torch.equal(a, b) for a, b in zip(state_blocks(state), state_blocks(twin)))
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm mesh] (f) {cfg.name} bf16 L={L} B={TRAIN_BATCH} S={TRAIN_SEQ} on {mesh.shape} "
          f"with act_spec {specs['act_spec']} and logits_spec {specs['logits_spec']}: step 1 "
          f"twice from one state: loss {first[0][0]!r}; loss, parameters and moments "
          f"{'bitwise equal' if same else 'DIFFER'}; step s {first[0][2]}, {first[1][2]} ({card})")
    if not same:
        raise SystemExit("a sequence-parallel train step is not bitwise repeatable")
    hist = [first[0]] + [run(state, i) for i in range(1, 1 + LM_SP_STEPS)]
    losses = [h[0] for h in hist]
    ref9 = [r["loss"] for r in TRAIN_HISTORY[cfg.name]][:len(hist)]
    refa = [r["loss"] for r in ref_a][:len(hist)]
    rel9 = [abs(a - b) / abs(b) for a, b in zip(losses, ref9)]
    rela = [abs(a - b) / abs(b) for a, b in zip(losses, refa)]
    timed = [h[2] for h in hist[1:]]
    step_s = statistics.median(timed)
    peak = max(h[3] for h in hist)
    ref_s = statistics.median(r["step_s"] for r in ref_a[1:])
    print(f"[lm mesh] (f) steps 1-{len(hist)} losses {losses}; phase 9's {ref9} (rel diff "
          f"{rel9}), (a)'s {refa} (rel diff {rela}), limit {LM_MESH_LOSS_REL}; grad norms "
          f"{[h[1] for h in hist]}; timed steps 2-{len(hist)}: step s {timed}, median {step_s} "
          f"s, {TRAIN_BATCH * TRAIN_SEQ / step_s} tokens/s, {step_s / ref_s}x (a)'s {ref_s} s; "
          f"peak of the card {peak} GiB against (a)'s {LM_MESH_PEAK[-1]} GiB "
          f"({peak - LM_MESH_PEAK[-1]:+.3f}; four virtual devices on one card) ({card})")
    if max(rel9 + rela) > LM_MESH_LOSS_REL or not all(np.isfinite(h[1]) for h in hist):
        raise SystemExit(f"15(f)'s losses are off phase 9's or (a)'s: {rel9}, {rela}")
    LM_SP_PEAK.append(peak)
    loss, _, s_prof, _, (ms, count, busy, _) = run(state, len(hist), profile=True)
    coll = sum(ms.get(c, 0.0) for c in ms if "gather" in c or "scatter" in c or "reduces" in c)
    parts = ", ".join(f"{c} {ms[c]} ms ({100 * ms[c] / busy:.1f}%, x{count[c]})" for c in ms)
    print(f"[lm mesh] (f) profile of step {len(hist) + 1} (loss {loss!r}, {s_prof} s under the "
          f"profiler): device busy {busy} ms; the collective.* ranges {coll} ms, "
          f"{100 * coll / busy:.2f}% of it; {parts} ({card})")
    print(f"[lm mesh] (f) wall {time.perf_counter() - t0} s; launches counted {launches} "
          f"({card})")
    return launches


def counted_step(step_fn, state, batch, want: dict, tag: str, ranges=None) -> tuple:
    """One step of ``step_fn`` on ``state`` (updated in place), fenced, with
    every count zeroed just before and read just after: the flash launches
    must be ``want`` ((launches, plain calls) by kernel), all on the wgmma
    routes; with ``ranges`` under the profiler (device time by category and
    by those ``record_function`` ranges).  Returns (loss, grad norm, step
    s, peak GiB, the profile or None, the launches by kernel)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    out = []

    def one():
        out.append(step_fn(state, batch))
        torch.cuda.synchronize()

    ts = time.perf_counter()
    prof = None
    if ranges:
        prof = device_time_by_category(one, TRAIN_CATEGORIES, ranges, other="elementwise/copies")
    else:
        one()
    step_s = time.perf_counter() - ts
    counts = all_counts()
    got = {k: counts[k] for k in want}
    routes = (flash_ops.route_launches["wgmma"], flash_ops.bwd_route_launches["wgmma"])
    if got != want or routes != (want["flash_attention"][0], want["flash_attention_bwd"][0]):
        raise SystemExit(f"{tag}: {got}, wgmma routes {routes}; expected {want} on wgmma")
    new, m = out[0]
    state.params, state.opt_state, state.step = new.params, new.opt_state, new.step
    return (float(m["loss"]), float(m["grad_norm"]), step_s,
            torch.cuda.max_memory_allocated() / 2**30, prof, {k: got[k][0] for k in want})


@contextlib.contextmanager
def tp_mixer_calls():
    """The model-axis size of every recurrent mixer that ran tensor parallel
    by heads inside the block (``transformer._mixer_tp_views``' calls)."""
    seen, inner = [], transformer_module._mixer_tp_views

    def counting(p, mesh, ranges):
        seen.append(mesh.shape["model"])
        return inner(p, mesh, ranges)

    transformer_module._mixer_tp_views = counting
    try:
        yield seen
    finally:
        transformer_module._mixer_tp_views = inner


def mixer_tp_against_unsharded(tag: str, cfg, shape, mesh, specs, card: str) -> dict:
    """15(g)'s runs of ``cfg`` on ``mesh`` (with ``specs``): step 1 twice
    from one state (bitwise), then MIXER_TP_TIMED timed steps (zamba2) or
    MIXER_TP_REF - 1 more (xLSTM) and, for zamba2, one profiled, each
    counted; then MIXER_TP_REF unsharded steps of the same model from the
    same seed, its losses the reference.  Returns the launches over the
    counted mesh steps, by kernel."""
    opt = AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=max(TRAIN_STEPS // 20, 1))
    n_attn, n = attention_layers(cfg), mesh.size
    mamba = cfg.block_pattern == "zamba2"
    want = {"flash_attention": (n * 2 * n_attn, 0), "flash_attention_bwd": (n * n_attn, 0)}
    launches = {k: 0 for k in want}
    step_fn = make_train_step(cfg, opt, mesh=mesh, **specs)
    batches = [mesh_batch(cfg, shape, i) for i in range(MIXER_TP_TIMED + 2)]

    def run(state, i, ranges=None):
        got = counted_step(step_fn, state, batches[i], want, f"15(g) {tag} step {i + 1}", ranges)
        for k in want:
            launches[k] += got[5][k]
        return got[:5]

    state = train_state_init(torch.Generator(device="cuda").manual_seed(SEED), cfg, mesh=mesh)
    twin = clone_state(state)
    with tp_mixer_calls() as calls:
        first = [run(st, 0) for st in (state, twin)]
    same = first[0][:2] == first[1][:2] and all(
        torch.equal(a, b) for a, b in zip(state_blocks(state), state_blocks(twin)))
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    M = mesh.shape["model"]
    print(f"[mixer tp] ({tag}) {cfg.name} {cfg.dtype} L={cfg.n_layers} B={shape.global_batch} "
          f"S={shape.seq_len} on {mesh.shape}{f' with {specs}' if specs else ''}: step 1 twice "
          f"from one state: loss {first[0][0]!r}; loss, parameters and moments "
          f"{'bitwise equal' if same else 'DIFFER'}; step s {first[0][2]}, {first[1][2]}; the "
          f"mixers ran tensor parallel {len(calls)} times over both, on model axes {set(calls)} "
          f"({card})")
    if not same or not calls or set(calls) != {M}:
        raise SystemExit(f"15(g) {tag}: step 1 not bitwise repeatable ({same}) or the mixers "
                         f"did not run tensor parallel ({calls})")
    more = MIXER_TP_TIMED if mamba else MIXER_TP_REF - 1
    hist = [first[0]] + [run(state, i) for i in range(1, 1 + more)]
    prof = None
    if mamba:
        ranges = {"Mamba2 SSD": "mamba.ssd", "Mamba2 conv": "mamba.conv",
                  "all-gathers and their reduce-scatters": "collective.all_gather",
                  "reduce-scatters and their all-gathers": "collective.reduce_scatter",
                  "all-reduces": "collective.all_reduce",
                  "replica sums": "train.reduce_replicas", "AdamW": "train.optimizer"}
        prof = run(state, len(hist), ranges)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    ustate = train_state_init(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    ustep = make_train_step(cfg, opt)
    uwant = {k: (v[0] // n, 0) for k, v in want.items()}
    ref = [counted_step(ustep, ustate, {k: v.cuda() for k, v in batches[i].items()}, uwant,
                        f"15(g) {tag} unsharded step {i + 1}")[:4] for i in range(MIXER_TP_REF)]
    del ustate
    gc.collect()
    torch.cuda.empty_cache()
    losses = [h[0] for h in hist]
    rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(hist, ref)]
    timed = [h[2] for h in hist[1:]]
    step_s = statistics.median(timed)
    print(f"[mixer tp] ({tag}) losses {losses}, the unsharded steps' {[r[0] for r in ref]} (rel "
          f"diff {rel}, limit {LM_MESH_LOSS_REL}); grad norms {[h[1] for h in hist]} (unsharded "
          f"{[r[1] for r in ref]}); steps 2-{len(hist)}: step s {timed}, median {step_s} s, "
          f"{shape.global_batch * shape.seq_len / step_s} tokens/s; unsharded step s {[r[2] for r in ref]}; peak of the card "
          f"{max(h[3] for h in hist)} GiB on the mesh ({n} virtual devices), "
          f"{max(r[3] for r in ref)} GiB unsharded ({card})")
    if max(rel) > LM_MESH_LOSS_REL or not all(np.isfinite(h[0]) and np.isfinite(h[1])
                                              for h in hist + ref):
        raise SystemExit(f"15(g) {tag}: losses off the unsharded steps' or not finite: {rel}, "
                         f"{hist}, {ref}")
    if prof is not None:
        loss, _, s_prof, _, (ms, count, busy, _) = prof
        coll = sum(ms[c] for c in ms if "gather" in c or "scatter" in c or "reduces" in c)
        parts = ", ".join(f"{c} {ms[c]} ms ({100 * ms[c] / busy:.1f}%, x{count[c]})"
                          for c in ms)
        print(f"[mixer tp] ({tag}) profile of step {len(hist) + 1} (loss {loss!r}, {s_prof} s "
              f"under the profiler): device busy {busy} ms; the collective.* ranges {coll} ms "
              f"({100 * coll / busy:.2f}%); {parts} ({card})")
        layers12, ms12 = TRAIN_PROFILE[SSM_ARCH]
        share = ms12["Mamba2 SSD"] * cfg.n_layers / layers12
        lo, hi = MIXER_TP_SSD_PREDICTED
        print(f"[mixer tp] ({tag}) mamba.ssd device time summed over the {n} devices "
              f"{ms['Mamba2 SSD']} ms against phase 12's {ms12['Mamba2 SSD']} ms at {layers12} "
              f"layers x {cfg.n_layers}/{layers12} = {share} ms: {ms['Mamba2 SSD'] / share}x "
              f"(predicted {lo}-{hi}x; the gathered-whole layout ~2x); mamba.conv "
              f"{ms['Mamba2 conv']} ms against phase 12's "
              f"{ms12['Mamba2 conv'] * cfg.n_layers / layers12} ms at the same share ({card})")
    return launches


def lm_mesh_mixer_tp(card: str) -> dict:
    """Phase 15(g): the Mamba2, mLSTM and sLSTM mixers tensor parallel by
    heads in the mesh train step (``[mixer tp]`` lines): zamba2-2.7b at
    full width cut to MIXER_TP_LAYERS on (a)'s (2, 2) mesh with (f)'s
    specs, xlstm-125m at full width cut to XLSTM_TRAIN_LAYERS on (1, 2),
    each against its unsharded steps (``mixer_tp_against_unsharded``).
    Returns (a)'s flash launches by JSON entry (the D = 80 wgmma kernels)."""
    t0 = time.perf_counter()
    full = get_config(SSM_ARCH)
    cfg = dataclasses.replace(full, n_layers=MIXER_TP_LAYERS)
    mesh = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES)
    print(f"[mixer tp] (a) {cfg.name} at {cfg.n_layers} of {full.n_layers} layers (one group "
          f"of {cfg.shared_attn_every} Mamba2 layers, one application of the shared block), "
          f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim // LM_MESH_MP} of "
          f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} Mamba2 heads a model device "
          f"({card})")
    shape = ShapeConfig(f"train_4k, global batch 256 cut to {SSM_TRAIN_BATCH}", "train",
                        TRAIN_SEQ, SSM_TRAIN_BATCH)
    specs = {"act_spec": act_pspec(mesh.axis_names),
             "logits_spec": P(dp_axes(mesh), None, "model")}
    got = mixer_tp_against_unsharded("a", cfg, shape, mesh, specs, card)
    t1 = time.perf_counter()
    xfull = get_config(XLSTM_ARCH)
    xcfg = dataclasses.replace(xfull, n_layers=XLSTM_TRAIN_LAYERS, slstm_indices=tuple(
        i for i in xfull.slstm_indices if i < XLSTM_TRAIN_LAYERS))
    xmesh = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES[:LM_MESH_MP])
    print(f"[mixer tp] (b) {xcfg.name} at {xcfg.n_layers} of {xfull.n_layers} layers (sLSTM at "
          f"{xcfg.slstm_indices}), {xcfg.n_heads // LM_MESH_MP} of {xcfg.n_heads} heads a model "
          f"device, S = {XLSTM_FINITE_SEQ} ({card})")
    xshape = ShapeConfig(f"S = {XLSTM_FINITE_SEQ}", "train", XLSTM_FINITE_SEQ,
                         MIXER_TP_XLSTM_BATCH)
    mixer_tp_against_unsharded("b", xcfg, xshape, xmesh, {}, card)
    print(f"[mixer tp] wall (a) {t1 - t0} s, (b) {time.perf_counter() - t1} s ({card})")
    return {"flash_attention_wgmma_d80": got["flash_attention"],
            "flash_attention_bwd_wgmma_d80": got["flash_attention_bwd"]}


def lm_mesh_bad_card() -> None:
    """Phase 15(e): a mesh naming one more card than the host has raises,
    naming the host's count."""
    n = torch.cuda.device_count()
    try:
        make_local_mesh(LM_MESH_MP, devices=(f"cuda:{n}",) * 4)
    except ValueError as e:
        print(f"[lm mesh] (e) make_local_mesh on cuda:{n}: {e}")
        if f"the host has {n}" not in str(e):
            raise SystemExit(f"the error does not name the host's {n} card(s): {e}")
        return
    raise SystemExit(f"a mesh naming cuda:{n} did not raise")


def lm_mesh_phase(card: str) -> tuple[dict, dict]:
    """Phase 15; returns (a)'s and (f)'s flash launches over their runs,
    and (g)'s by JSON entry."""
    t_phase = time.perf_counter()
    launches, hist_a = lm_mesh_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh_restart(card)
    for k, v in lm_mesh_seq_parallel(card, hist_a).items():
        launches[k] += v
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh_moe(card)
    lm_mesh_pipeline(card)
    lm_mesh_bad_card()
    t0 = time.perf_counter()
    tp_launches = lm_mesh_mixer_tp(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[wall] phase 15 (g): {time.perf_counter() - t0} s")
    print(f"[lm mesh] phase wall {time.perf_counter() - t_phase} s ({card})")
    return launches, tp_launches


def mesh_serve_check(card: str) -> int:
    """Phase 16(a): phase 6's requests served on (2, 2) virtual devices
    through mesh_prefill and mesh_decode_step, teacher-forced on phase 6's
    tokens; returns the prefill's flash launches."""
    cfg = get_config(SERVE_ARCH)
    prompts, tokens, want = SERVE_RECORD[cfg.name]
    mesh = make_local_mesh(LM_MESH_MP, devices=LM_MESH_DEVICES)
    n, L = mesh.size, cfg.n_layers
    max_len = SERVE_PROMPT + SERVE_NEW + 8  # phase 6's engine's
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        params = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg)
        sp = place(params, param_pspecs(params, mesh), mesh)
        del params
        toks = torch.as_tensor(prompts, device="cuda").long()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(2):  # the second is the counted run, the first its warm-up twin
            reset_all_counts()
            t0 = time.perf_counter()
            runs.append(mesh_prefill(sp, {"tokens": toks}, cfg, mesh, max_len))
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        counts, routes = all_counts()["flash_attention"], dict(flash_ops.route_launches)
        (lg0, st0), (logits, state) = runs
        same = torch.equal(lg0, logits) and all(
            torch.equal(a, b) for sa, sb in zip(_leaves(st0), _leaves(state))
            for a, b in zip(sa.blocks, sb.blocks))
        del runs, lg0, st0
        got, step_s = [logits], []
        for i in range(SERVE_NEW - 1):
            tok = torch.as_tensor(tokens[:, i], device="cuda").long()[:, None]
            t0 = time.perf_counter()
            logits, state = mesh_decode_step(sp, tok, state, SERVE_PROMPT + i, cfg, mesh)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            got.append(logits)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = [g.float().cpu().numpy() for g in got]
    del sp, state
    gc.collect()
    torch.cuda.empty_cache()
    rel, flips, sure = [], 0, 0
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        rel.append(float(np.abs(g - w).max()) / scale)
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > MESH_SERVE_TOL * scale
        sure += int(clear.sum())
        flips += int((clear & (g.argmax(-1) != w.argmax(-1))).sum())
    print(f"[mesh serve] (a) {cfg.name} bf16 on {mesh.shape} ({n} virtual devices of one "
          f"card), phase 6's {len(prompts)} x {SERVE_PROMPT} prompts + {SERVE_NEW}: prefill "
          f"{prefill_s} s, decode {statistics.median(step_s)} s a step (median of "
          f"{len(step_s)}, teacher-forced on phase 6's tokens), peak {peak} GiB ({card})")
    print(f"[mesh serve] (a) prefill flash (launches, plain) {counts}, routes {routes} "
          f"(want {n} x {L} on wgmma); a repeated prefill's logits and state "
          f"{'bitwise equal' if same else 'DIFFER'}")
    print(f"[mesh serve] (a) logits against phase 6's, each step's max abs diff over max "
          f"|logit|: max {max(rel)} (limit {MESH_SERVE_TOL}); greedy tokens where phase 6's "
          f"top-2 margin exceeds the limit: {sure - flips} of {sure} equal")
    if counts != (n * L, 0) or routes["wgmma"] != n * L:
        raise SystemExit(f"mesh prefill flash launches {counts}, routes {routes}")
    if not same:
        raise SystemExit("a repeated mesh prefill is not bitwise equal")
    if max(rel) > MESH_SERVE_TOL or flips or not all(np.isfinite(g).all() for g in got):
        raise SystemExit(f"mesh serving disagrees with phase 6: rel {max(rel)}, {flips} flips")
    return counts[0]


def cell_record(out_dir: str, arch: str, shape: str, tag: str, mesh, **kw) -> dict:
    """The dry-run record of a cell (``run_cell``), failing the phase on a
    failed trace."""
    rec = run_cell(arch, shape, tag, out_dir, mesh=mesh, force=True, **kw)
    if rec["status"] != "ok":
        raise SystemExit(f"dry-run of {arch} {shape} on {tag} failed: {rec['error']}\n"
                         f"{rec['traceback']}")
    return rec


def measured(rec: dict, out_dir: str, seconds: float, card: str, devices: int = 1) -> float:
    """Write a measured time into a dry-run record; returns the fraction of
    its bound that the time reached."""
    rec.update(measured_s=seconds, measured_on=card, measured_devices=devices)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape'].replace(':', '_')}__"
                                 f"{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return measured_fraction(rec)


def measured_cells(card: str, out_dir: str) -> dict[str, int]:
    """Phase 16(b): the elasticity cells on the card, against the operator
    and their dry-run bounds; returns the PAop and probe launches."""
    launches = dict.fromkeys(("pa_elasticity", "probe"), 0)
    card_dev = LM_MESH_DEVICES[0]
    one, meta_one = (make_local_mesh(1, devices=(d,)) for d in (card_dev, "meta"))
    four, meta_four = (make_local_mesh(2, devices=(d,) * 4) for d in (card_dev, "meta"))
    for name in CELL_SHAPES + (DD_CELL,):
        dd = name == DD_CELL
        mesh = four if dd else one
        gc.collect()
        torch.cuda.empty_cache()
        reset_all_counts()
        cell = build_cell("elasticity", name, mesh, assembly="paop_cuda", seed=SEED)
        ys = cell.run()
        torch.cuda.synchronize()
        counts = all_counts()
        shards = mesh.size if dd else 1
        if counts["pa_elasticity"] != (shards, 0) or counts["probe"] != (1, 0):
            raise SystemExit(f"cell {name}: (launches, plain) {counts}")
        for k in launches:
            launches[k] += counts[k][0]
        if dd:
            decomp = cell.fn.__self__
            x, y = decomp.from_blocks(cell.args[0]), decomp.from_blocks(ys)
            space = decomp.space
        else:
            x, y = cell.args[0][0], ys[0]
            space = H1Space(beam_hex().refined(ELASTICITY_SHAPES[name].n_h_refine),
                            ELASTICITY_SHAPES[name].p)
        ref = ElasticityOperator(space, "paop_cuda", dtype=torch.float32,
                                 device=card_dev).apply(x)
        rel = float((y - ref).abs().max()) / float(ref.abs().max())
        del x, y, ref, ys
        t = fenced_ms(cell.run, CELL_ROUNDS) / 1e3
        del cell
        rec = cell_record(out_dir, "elasticity", name, "2x2" if dd else "1x1",
                          meta_four if dd else meta_one, assembly="paop_cuda")
        frac = measured(rec, out_dir, t, card, shards)
        terms = terms_of(rec)
        print(f"[cells] (b) elasticity {name} f32 paop_cuda on {mesh.shape} "
              f"({'four virtual devices of one card' if dd else 'the card'}): {space.ndof} "
              f"DoFs, (launches, plain) {counts['pa_elasticity']}; against ElasticityOperator's "
              f"apply: max abs diff {rel:.3e} of max |y| (limit {CELL_REL}); AddMult {t * 1e3} "
              f"ms fenced (median of {CELL_ROUNDS}); dry-run bound {terms.bound_s * shards * 1e3}"
              f" ms a card ({terms.dominant}), reached {frac:.4f} of it ({card})")
        if rel > CELL_REL:
            raise SystemExit(f"cell {name} disagrees with ElasticityOperator: {rel}")
    return launches


BACKGROUND: list = []  # processes started beside the phases, stopped on exit
BACKGROUND_DIRS: list = []  # their output directories, removed on exit


def start_dryrun(out_dir: str) -> subprocess.Popen:
    """Phase 16(c), started after the build: the cells of DRYRUN_CELLS
    traced one after the other on their meta production meshes
    (``launch/dryrun.py::run_cell``, the dry-run CLI's) in one process of
    its own at a lower priority, with no card visible, each record written
    to ``out_dir``.  A trace runs on the host alone, so the process runs
    beside phases 3-15; :func:`capped_dryrun` holds it."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    cells_ = [(kind, *cell) for kind, cs in DRYRUN_CELLS.items() for cell in cs]
    code = ("import json, os, sys\n"
            "os.nice(10)\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            "for kind, arch, shape, assembly in json.loads(sys.argv[2]):\n"
            "    run_cell(arch, shape, kind, sys.argv[1], assembly=assembly, force=True)\n")
    BACKGROUND_DIRS.append(out_dir)
    proc = subprocess.Popen([sys.executable, "-c", code, out_dir, json.dumps(cells_)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    BACKGROUND.append(proc)
    return proc


def capped_dryrun(card: str, out_dir: str, proc: subprocess.Popen) -> None:
    """Phase 16(c): DRYRUN_CELLS traced on the meta production meshes by
    the process of :func:`start_dryrun`, which must exit 0 with an ``ok``
    record of every cell."""
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired as e:
        raise SystemExit("the dry-run of DRYRUN_CELLS still ran after 600 s") from e
    for kind, cells_ in DRYRUN_CELLS.items():
        for arch, shape, _ in cells_:
            path = os.path.join(out_dir, f"{arch}__{shape.replace(':', '_')}__{kind}.json")
            rec = {}
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            if proc.returncode != 0 or rec.get("status") != "ok":
                raise SystemExit(f"dry-run of {arch} {shape} on {kind} failed (exit "
                                 f"{proc.returncode}): {rec.get('error')}\n{out[-4000:]}")
            mem = rec["memory"]
            print(f"[dryrun] (c) {arch} {shape} on {rec['mesh_shape']} (meta): build "
                  f"{rec['t_build_s']} s, trace {rec['t_trace_s']} s (host: {card}; traced in "
                  f"a process of its own beside phases 3-15); "
                  f"flops/dev {rec['cost']['flops_per_dev']:.4e}, bytes/dev "
                  f"{rec['cost']['bytes_per_dev']:.4e}, link bytes/dev "
                  f"{rec['collectives']['link_bytes']:.4e} {rec['collectives']['per_op']}, "
                  f"peak {mem['peak_bytes_per_device'] / 2**30:.3f} GiB/dev (arguments "
                  f"{mem['argument_bytes'] / 2**30:.3f}, temp estimate "
                  f"{mem['temp_bytes'] / 2**30:.3f})")


def memory_model_check(card: str, out_dir: str) -> None:
    """Phase 16(d): phase 15's (2, 2) train cell dry-run on meta devices
    (with the reference's act_spec and logits_spec: 15(f)'s step), its peak
    a device x 4 beside 15(f)'s and 15(a)'s measured peaks on the card."""
    shape = ShapeConfig("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    mesh = make_local_mesh(LM_MESH_MP, devices=("meta",) * 4)
    rec = cell_record(out_dir, "qwen3_17b", "train_4k", "lm_mesh_2x2", mesh, shape_cfg=shape)
    mem = rec["memory"]
    predicted = 4 * mem["peak_bytes_per_device"] / 2**30
    sp, got = LM_SP_PEAK[-1], LM_MESH_PEAK[-1]
    specs = {k: tuple(rec["meta"][k]) for k in ("act_spec", "logits_spec")} \
        if "act_spec" in rec.get("meta", {}) else "not recorded"
    print(f"[dryrun] (d) qwen3-1.7b train B={TRAIN_BATCH} S={TRAIN_SEQ} on {mesh.shape} "
          f"({specs}): trace {rec['t_trace_s']} s; dry-run peak "
          f"{mem['peak_bytes_per_device'] / 2**30:.3f} GiB a device (arguments "
          f"{mem['argument_bytes'] / 2**30:.3f}, temp estimate "
          f"{mem['temp_bytes'] / 2**30:.3f}) x 4 = {predicted:.3f} GiB against 15(f)'s measured "
          f"peak {sp:.3f} GiB on the card (ratio {predicted / sp:.3f}) and 15(a)'s, without "
          f"the specs, {got:.3f} GiB (ratio {predicted / got:.3f}) ({card})")


def grid_phase(card: str, out_dir: str, dryrun: subprocess.Popen) -> dict[str, int]:
    """Phase 16, its records in ``out_dir`` (where the process ``dryrun``
    writes (c)'s); returns its launches by kernel."""
    t_phase = time.perf_counter()
    try:
        launches = {"flash_attention": mesh_serve_check(card)}
        print(f"[wall] phase 16 (a): {time.perf_counter() - t_phase} s")
        launches.update(measured_cells(card, out_dir))
        print(f"[wall] phase 16 (b): {time.perf_counter() - t_phase} s")
        capped_dryrun(card, out_dir, dryrun)
        print(f"[wall] phase 16 (c): {time.perf_counter() - t_phase} s")
        memory_model_check(card, out_dir)
        recs = load_records(out_dir)
        print(f"[dryrun] {card}\n" + render_dryrun(recs))
        for kind in sorted({r["mesh"] for r in recs}):
            print(f"[roofline] {kind} mesh, {H100_SXM.name} ({card})\n"
                  + render_roofline(recs, kind))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[cells] phase wall {time.perf_counter() - t_phase} s ({card})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # ---- 1. the card
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build (both libraries at once) + probe
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(build.load), pool.submit(flash_build.load)]
        kl, fl = (b.result() for b in builds)
    for lib, smem, cfg, bwd_smem in (
            (kl, None, kl.config, None),
            (fl, fl.lib.flash_attention_wgmma_smem_bytes, None,
             fl.lib.flash_attention_bwd_wgmma_smem_bytes)):
        print(f"[build] {lib.path.name}: {lib.build_seconds:.1f} s (0 = cached)")
        for row in ptxas_summary(lib.log, smem, cfg, bwd_smem):
            print(row)
    px = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
    po = ops.probe(px)
    probe_err = float((po - probe_ref(px)).abs().max())
    if probe_err != 0.0:
        raise SystemExit(f"probe kernel disagrees with 2*x: {probe_err}")
    print(f"[probe] o = 2x on (8, 128) f32: max abs err {probe_err}")
    dryrun_dir = tempfile.mkdtemp(prefix="dryrun_")
    dryrun = start_dryrun(dryrun_dir)
    wall("1-2 (card, build, probe)")

    # ---- 3. kernel vs plain on the card
    main_shapes = [
        (sp.p, sp.nelem)
        for sp in hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)
    ]
    cases = [(dt, p, ne) for dt in (torch.float64, torch.float32)
             for p in ops.SUPPORTED_P for ne in (1, 7, 4096)]
    cases += [(torch.float64, p, ne) for p, ne in main_shapes]
    n_coarse = hierarchy_spaces(beam_hex(), MAIN_REFINE, MAIN_P)[0].nscalar * 3
    cases += [(torch.float64, p, BATCH_S * ne) for p, ne in main_shapes]
    cases.append((torch.float64, 1, n_coarse * BATCH_S * main_shapes[0][1]))
    # phase 8's sweep: every (p, NE) that paop_cuda is timed at
    sweep = {(p, beam_hex().nelem * 8**r) for p, r in ABLATION_REFINE.items()}
    big = ELASTICITY_SHAPES["beam_p8_51m"]
    sweep.add((big.p, beam_hex().nelem * 8**big.n_h_refine))
    cases += [(torch.float64, p, ne) for p, ne in sorted(sweep)]
    # phase 5d: bfloat16 at every p and NE, unaligned views, and the V-cycle
    # levels of its solves (S = 1 and 8, and the small service's buckets);
    # the batched coarse probe runs the f32 kernel on the bfloat16 fields
    cases += [(torch.bfloat16, p, ne) for p in ops.SUPPORTED_P for ne in (1, 7, 4096)]
    cases += [(torch.bfloat16, p, ne, off) for p in ops.SUPPORTED_P for ne in (7, 4096)
              for off in (1, 3)]
    cases += [(torch.bfloat16, p, s * ne) for s in (1, BATCH_S) for p, ne in main_shapes[1:]]
    cases.append((torch.float32, 1, n_coarse * BATCH_S * main_shapes[0][1]))
    small = [(sp.p, sp.nelem) for sp in hierarchy_spaces(beam_hex(), 1, 2)]
    cases += [(torch.bfloat16, p, s * ne) for s in (1, 2, 4) for p, ne in small[1:]]
    # phase 14's shards: the DD's elements a shard (f32 at 51.17M DoFs, f64
    # at phase 4's size) and the sharded batch's S / n rows a level
    cases.append((torch.float32, big.p, beam_hex().nelem * 8**big.n_h_refine // DD_SHARDS))
    cases += [(torch.float64, MAIN_P, main_shapes[-1][1] // n) for n in DD_F64_SHARDS[1:]]
    cases += [(torch.float64, p, BATCH_S // n * ne) for n in MESH_SIZES for p, ne in main_shapes]
    cases += [(torch.float64, 1, n_coarse * BATCH_S // n * main_shapes[0][1]) for n in MESH_SIZES]
    bad = []
    for dt, p, ne, *off in cases:
        args = pa_inputs(p, ne, dt, gen, *off)
        y = ops.pa_elasticity(*args)
        torch.cuda.synchronize()
        _, rel, ok = compare(y, paop_ref(*args), dt)
        tag = DT_TAG[dt] + (f" offset {off[0]}" if off else "")
        print(f"[paop vs plain] p={p} {tag} NE={ne}: max rel err {rel:.3e} "
              f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            bad.append((p, tag, ne, rel))
    if bad:
        raise SystemExit(f"PAop kernel disagrees with its plain version: {bad}")

    flash_cases = [(c, dt, 0) for c in FLASH_CASES for dt in (torch.float32, torch.bfloat16)]
    flash_cases += [((2, 100, 16, 8, 128, None), dt, 2) for dt in (torch.float32, torch.bfloat16)]
    flash_cases.append(((*FLASH_MAIN, None), torch.bfloat16, 0))
    for (B, S, H, K, D, window), dt, pad in flash_cases:
        q, k, v = flash_inputs(B, S, H, K, D, dt, gen, pad)
        want = expected_route(dt, D, pad)
        before = dict(flash_ops.route_launches)
        o = flash_ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        moved = [r for r in flash_ops.ROUTES if flash_ops.route_launches[r] != before[r]]
        flash_err, row_rel, ok = flash_check(o, flash_ref(q, k, v, window=window), dt)
        print(f"[flash vs plain] (B,S,H,K,D)=({B},{S},{H},{K},{D}) window={window} "
              f"{str(dt)[6:]}{' strided' if pad else ''} route {moved}: max abs err "
              f"{flash_err:.3e}, max row rel err {row_rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if moved != [want]:
            bad.append(((B, S, H, K, D, window), str(dt), pad, f"route {moved}, expected {want}"))
        elif not ok:
            bad.append(((B, S, H, K, D, window), str(dt), pad, flash_err))
    if bad:
        raise SystemExit(f"flash kernel disagrees with its plain version: {bad}")
    flash_main_err = flash_err  # the last case is the serve path's shape
    del q, k, v, o
    torch.cuda.empty_cache()
    d80_errs = d80_kernel_checks(gen)
    wall("3 (kernels vs plain)")

    # ---- 4. the solve path, counted
    reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    rep = solve_beam(MAIN_P, MAIN_REFINE, precision="f64", device="cuda",
                     keep_solution=True)
    f64_solve = {"iters": rep.iterations, "t_solve": rep.t_solve,
                 "peak": torch.cuda.max_memory_allocated()}
    solve_counts = all_counts()
    main_counts = {k: solve_counts[k] for k in ops.counts}
    print(f"[solve] p={rep.p} refine={MAIN_REFINE} nelem={rep.nelem} "
          f"ndof={rep.ndof} iters={rep.iterations} rel={rep.final_rel_norm:.3e} "
          f"converged={rep.converged}")
    print(f"[solve] prec={rep.t_precond}s form={rep.t_form_ls}s "
          f"solve={rep.t_solve}s total={rep.t_total}s "
          f"DoF/s(solve)={rep.ndof / rep.t_solve} "
          f"DoF*iter/s={rep.ndof * rep.iterations / rep.t_solve}")
    print(f"[solve] counts (launches, plain_calls): {solve_counts}")
    if not (rep.converged and rep.final_rel_norm <= 1e-6):
        raise SystemExit("main-path solve did not converge to 1e-6")
    for name, (launches, plain) in main_counts.items():
        if launches == 0 or plain != 0:
            raise SystemExit(f"main path did not run only through {name}: "
                             f"launches={launches} plain_calls={plain}")
    x = rep.x
    if tuple(x.shape) != (rep.ndof // 3, 3) or not bool(torch.isfinite(x).all()):
        raise SystemExit("main-path solution is not finite of shape (nscalar, 3)")
    print(f"[solve] max |u_z| = {float(x[:, 2].abs().max()):.6e}")
    del x, rep
    torch.cuda.empty_cache()

    # A small solve on the card against the same solve on the CPU (plain
    # version), from the same power-iteration start vectors.
    spaces = hierarchy_spaces(beam_hex(), 1, 2)
    cpu_gen = torch.Generator().manual_seed(SEED)
    sv = [torch.randn((sp.nscalar, 3), generator=cpu_gen, dtype=torch.float64)
          for sp in spaces[1:]]
    small_gpu = solve_beam(2, 1, device="cuda", start_vectors=sv, keep_solution=True)
    small_cpu = solve_beam(2, 1, device="cpu", start_vectors=sv, keep_solution=True)
    sdiff = float((small_gpu.x.cpu() - small_cpu.x).abs().max())
    sscale = float(small_cpu.x.abs().max())
    print(f"[small solve] p=2 refine=1 iters card/cpu "
          f"{small_gpu.iterations}/{small_cpu.iterations}, max rel diff "
          f"{sdiff / sscale:.3e}")
    if small_gpu.iterations != small_cpu.iterations or sdiff > 1e-10 * sscale:
        raise SystemExit("small solve on the card disagrees with the CPU")
    del small_gpu, small_cpu
    torch.cuda.empty_cache()
    wall("4 (solve)")

    # ---- 5. the batched solve path, counted
    batch_counts, batch_iters = batched_phase()
    small_batched_check()
    torch.cuda.empty_cache()
    wall("5 (batched solve)")

    # ---- 5b. the solve service, counted
    fixed, t_fixed, gen_reports = service_phase(batch_iters)
    small_service_check()
    torch.cuda.empty_cache()
    wall("5b (service)")

    # ---- 5c. recovery, counted
    recovery_phase(fixed, t_fixed, card)
    wall("5c (recovery)")

    # ---- 5d. the mixed-bf16 policy, counted
    bf16_launches = bf16_phase(f64_solve, batch_iters, card)
    torch.cuda.empty_cache()
    wall("5d (mixed-bf16)")

    # ---- 6. the serve path, counted: qwen3-1.7b at full width, bf16
    rng = np.random.default_rng(SEED)
    serve_counts = serve_full_width(get_config(SERVE_ARCH), SERVE_REQUESTS, rng, card)
    # A reduced qwen3 in f32 on the card against the CPU, same weights.
    small_serve_check(SERVE_ARCH, rng)
    wall("6 (serve)")

    # ---- 7. time the PAop apply (kernel, baseline, plain) and the flash kernel
    ne = main_shapes[-1][1]
    pa_t = {}
    for p in PA_TIME_P:
        args = pa_inputs(p, ne, torch.float64, gen)
        y = ops.pa_elasticity(*args)
        ref = paop_ref(*args)
        max_abs, rel, ok = compare(y, ref, torch.float64)
        _, base_rel, base_ok = compare(ops.launch_baseline(*args), ref, torch.float64)
        # the f32 and bfloat16 instantiations, timed in the same rounds
        low = {dt: pa_inputs(p, ne, dt, gen) for dt in (torch.float32, torch.bfloat16)}
        low_y = {dt: ops.pa_elasticity(*a) for dt, a in low.items()}
        low_err = {dt: compare(low_y[dt], paop_ref(*a), dt) for dt, a in low.items()}
        if not (ok and base_ok and all(e[2] for e in low_err.values())):
            raise SystemExit(f"p={p} NE={ne} apply out of tolerance: kernel {rel}, "
                             f"baseline {base_rel}, f32/bf16 {low_err}")
        del ref
        a32, a16 = low[torch.float32], low[torch.bfloat16]
        fns = {"kernel": lambda: ops.pa_elasticity(*args),
               "baseline": lambda: ops.launch_baseline(*args),
               "plain": lambda: paop_ref(*args),
               "f32": lambda: ops.pa_elasticity(*a32),
               "bf16": lambda: ops.pa_elasticity(*a16)}
        if p == MAIN_P:  # the kernels line's plain versions
            fns.update({"plain f32": lambda: paop_ref(*a32),
                        "plain bf16": lambda: paop_ref(*a16)})
        t = event_ms(fns, n=10, rounds=5)
        bound_ms, bound_by = paop_bound(args, y, p)
        b32_ms, b32_by = paop_bound(a32, low_y[torch.float32], p)
        b16_ms, b16_by = paop_bound(a16, low_y[torch.bfloat16], p)
        pa_t[p] = {**t, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs": max_abs,
                   "f32_bound_ms": b32_ms, "f32_bound_by": b32_by,
                   "f32_max_abs": low_err[torch.float32][0],
                   "bf16_bound_ms": b16_ms, "bf16_bound_by": b16_by,
                   "bf16_max_abs": low_err[torch.bfloat16][0]}
        print(f"[time] pa_elasticity p={p} NE={ne} f64, in turns, median of 5 rounds of 10: "
              f"kernel {t['kernel']} ms ({100 * bound_ms / t['kernel']}% of bound), baseline "
              f"{t['baseline']} ms ({100 * bound_ms / t['baseline']}% of bound), plain "
              f"{t['plain']} ms; bound {bound_ms} ms ({bound_by}); kernel "
              f"{t['baseline'] / t['kernel']}x faster than the baseline; max rel err "
              f"kernel {rel:.3e}, baseline {base_rel:.3e}")
        print(f"[time] pa_elasticity p={p} NE={ne} f32 and bf16, the same rounds: f32 "
              f"{t['f32']} ms ({100 * b32_ms / t['f32']}% of its bound {b32_ms} ms, "
              f"{b32_by}); bf16 {t['bf16']} ms ({100 * b16_ms / t['bf16']}% of its bound "
              f"{b16_ms} ms, {b16_by}), plain f32/bf16 {t.get('plain f32', 'not timed')}/"
              f"{t.get('plain bf16', 'not timed')} ms; bf16 "
              f"{t['f32'] / t['bf16']}x f32's speed, {t['kernel'] / t['bf16']}x f64's; "
              f"max rel err f32 {low_err[torch.float32][1]:.3e}, bf16 "
              f"{low_err[torch.bfloat16][1]:.3e}; {card}")
        del args, y, low, low_y, a32, a16
    main_t = pa_t[MAIN_P]
    flash_args = flash_inputs(*FLASH_MAIN, torch.bfloat16, gen)
    if flash_ops.route(*flash_args) != "wgmma":
        raise SystemExit("the serve shape's timing inputs do not take the wgmma route")
    # SDPA wants (B, H, S, D); the layout change stays outside the timing.
    sdpa_args = [t.transpose(1, 2).contiguous() for t in flash_args]
    flash_t = event_ms({
        "wgmma": lambda: flash_ops.launch("wgmma", *flash_args),
        "wgmma + LSE": lambda: flash_ops.launch("wgmma", *flash_args, lse=True),
        "sdpa": lambda: F.scaled_dot_product_attention(*sdpa_args, is_causal=True,
                                                       enable_gqa=True),
        "mma_sync": lambda: flash_ops.launch("mma_sync", *flash_args),
    }, n=20, rounds=5)
    flash_ms, flash_lib_ms, flash_old_ms = flash_t["wgmma"], flash_t["sdpa"], flash_t["mma_sync"]
    flash_plain_ms = event_ms({"plain": lambda: flash_ref(*flash_args)}, n=3, rounds=3)["plain"]
    flash_bound_ms, flash_bound_by = flash_bound(*flash_args)
    print(f"[time] flash_attention (B,S,H,K,D)={FLASH_MAIN} bf16, in turns, median of 5 "
          f"rounds of 20: wgmma kernel {flash_ms} ms, the same writing the LSE "
          f"{flash_t['wgmma + LSE']} ms ({flash_t['wgmma + LSE'] / flash_ms}x), SDPA "
          f"{flash_lib_ms} ms, mma_sync kernel {flash_old_ms} ms; plain {flash_plain_ms} ms "
          f"(median of 3 rounds of 3); "
          f"bound {flash_bound_ms} ms ({flash_bound_by}): wgmma {100 * flash_bound_ms / flash_ms}% "
          f"of bound, {flash_ms / flash_lib_ms}x SDPA's time; mma_sync "
          f"{100 * flash_bound_ms / flash_old_ms}% of bound")
    pa_args = pa_inputs(MAIN_P, ne, torch.float64, gen)
    po = torch.empty_like(px)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (px.data_ptr(), po.data_ptr(), px.numel())
    host = {
        "ops.probe": host_us(lambda: ops.probe(px)),
        "torch.mul": host_us(lambda: torch.mul(px, 2.0)),
        f"ops.pa_elasticity p={MAIN_P}": host_us(lambda: ops.pa_elasticity(*pa_args)),
        "flash_ops.launch wgmma": host_us(lambda: flash_ops.launch("wgmma", *flash_args)),
    }
    probe_parts = {
        "build.load()": host_us(build.load),
        "checks (dtype, is_contiguous, is_cuda)": host_us(
            lambda: (px.dtype != torch.float32, px.is_contiguous(), px.is_cuda)),
        "torch.empty_like": host_us(lambda: torch.empty_like(px)),
        "get_device() == current_device()": host_us(
            lambda: px.get_device() == torch.cuda.current_device()),
        "raw current stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "current_stream().cuda_stream (not used)": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "2 x data_ptr()": host_us(lambda: (px.data_ptr(), po.data_ptr())),
        "ctypes call": host_us(lambda: kl.probe(*ptrs, stream)),
    }
    print(f"[host] us per call, mean of 200 back-to-back calls after 20, no sync inside: "
          f"{host}; the probe wrapper's parts: {probe_parts}")
    del flash_args, sdpa_args, pa_args
    probe_t = event_ms({"kernel": lambda: ops.probe(px), "plain": lambda: probe_ref(px),
                        "library": lambda: torch.mul(px, 2.0)}, n=100, rounds=5)
    probe_ms, probe_plain_ms, probe_lib_ms = probe_t["kernel"], probe_t["plain"], probe_t["library"]
    probe_bound = 2 * px.numel() * px.element_size() / MEM_BYTES_PER_S * 1e3
    print(f"[time] probe (8, 128) f32, in turns, median of 5 rounds of 100: kernel "
          f"{probe_ms} ms, plain {probe_plain_ms} ms, torch.mul {probe_lib_ms} ms")
    wall("7 (times)")

    # ---- 8. the ablation: the paper's assembly ladder on the card
    ablation_phase(card)
    wall("8 (ablation)")

    # ---- 9. training: qwen3-1.7b at full width, bf16, through the flash
    # forward and backward kernels
    bwd_entries = train_phase(gen, card)
    wall("9 (training)")

    # ---- 10. the attention families without experts at full width, and
    # gradient compression
    slice_phase(card)
    wall("10 (granite-8b, qwen3-32b, qwen1.5-32b, qwen2-vl-7b, musicgen-medium)")

    # ---- 11. the mixtures of experts: olmoe-1b-7b and mixtral-8x7b
    moe_phase(card)
    wall("11 (olmoe-1b-7b, mixtral-8x7b)")

    # ---- 12. Mamba2 and the zamba2 hybrid: zamba2-2.7b at full width and
    # depth, the flash kernels at its head dim of 80
    d80_entries = ssm_phase(card, d80_errs)
    wall("12 (zamba2-2.7b, Mamba2)")

    # ---- 13. xLSTM: xlstm-125m at full width and depth, served and trained
    xlstm_phase(card)
    wall("13 (xlstm-125m)")

    # ---- 14. the solver side over a scenario mesh of virtual devices
    multidevice_phase(card, batch_iters, fixed, gen_reports)
    del fixed, gen_reports
    wall("14 (multi-device solver)")

    # ---- 15. the LM side on a (data, model) mesh of virtual devices
    mesh_launches, tp_launches = lm_mesh_phase(card)
    wall("15 (multi-device LM)")

    # ---- 16. serving on a mesh, the cells measured, the dry-run on meta meshes
    grid_launches = grid_phase(card, dryrun_dir, dryrun)
    wall("16 (cells, mesh serving, dry-run)")

    kernels = [
        {
            "name": "pa_elasticity",
            "route": "cuda",
            "source": "src/repro_torch/kernels/pa_elasticity/csrc/pa_elasticity.cu",
            "replaces": "src/repro/kernels/pa_elasticity/pa_elasticity.py:85",
            "launches": main_counts["pa_elasticity"][0],
            "max_abs_err": main_t["max_abs"],
            "ms": main_t["kernel"],
            "plain_ms": main_t["plain"],
            "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": None,
        },
        *(
            {
                "name": f"pa_elasticity_{tag}",
                "route": "cuda",
                "source": "src/repro_torch/kernels/pa_elasticity/csrc/pa_elasticity.cu",
                "replaces": "src/repro/kernels/pa_elasticity/pa_elasticity.py:85",
                "launches": bf16_launches[dt],
                "max_abs_err": main_t[f"{tag}_max_abs"],
                "ms": main_t[tag],
                "plain_ms": main_t[f"plain {tag}"],
                "bound_ms": main_t[f"{tag}_bound_ms"],
                "bound_by": main_t[f"{tag}_bound_by"],
                "library_ms": None,
            }
            for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))
        ),
        {
            "name": "probe",
            "route": "cuda",
            "source": "src/repro_torch/kernels/pa_elasticity/csrc/probe.cu",
            "replaces": "src/repro/kernels/pa_elasticity/ops.py:60",
            "launches": main_counts["probe"][0],
            "max_abs_err": probe_err,
            "ms": probe_ms,
            "plain_ms": probe_plain_ms,
            "bound_ms": probe_bound,
            "bound_by": "bytes",
            "library_ms": probe_lib_ms,
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:42",
            "launches": serve_counts["flash_attention"][0],
            "max_abs_err": flash_main_err,
            "ms": flash_ms,
            "plain_ms": flash_plain_ms,
            "bound_ms": flash_bound_ms,
            "bound_by": flash_bound_by,
            "library_ms": flash_lib_ms,
        },
        *bwd_entries,
        *d80_entries,
    ]
    # phase 15's launches (its (a) and (f) runs on the mesh) added to the main paths'
    for entry in kernels:
        entry["launches"] += {"flash_attention": mesh_launches["flash_attention"],
                              "flash_attention_bwd_wgmma":
                              mesh_launches["flash_attention_bwd"]}.get(entry["name"], 0)
    print(f"[lm mesh] phase 15 (a)'s and (f)'s launches added to the kernels line: "
          f"{mesh_launches}")
    for entry in kernels:
        entry["launches"] += tp_launches.get(entry["name"], 0)
    print(f"[mixer tp] phase 15 (g)'s launches added to the kernels line: {tp_launches}")
    for entry in kernels:
        entry["launches"] += grid_launches.get(entry["name"], 0)
    print(f"[cells] phase 16's launches added to the kernels line: {grid_launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for proc in BACKGROUND:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for d in BACKGROUND_DIRS:
            shutil.rmtree(d, ignore_errors=True)
