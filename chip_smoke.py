#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py          (from the repository root)

Phases, each printing one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions.
2. ``build``: nvcc builds ``csrc/*.cu`` for sm_90a from this checkout.
3. ``kernel_vs_plain``: the CUDA block kernel against its plain
   PyTorch version on the same card tensors, unit-normal inputs from a
   fixed seed (``BLOCK_CASES``: ragged 37 x 53, sources on tile seams
   and field edges, k = 1, 3, 4, 8, 600 x 600, 4096 x 4096 S=4 k=8,
   the striped engine's window shapes ``WINDOW_CASES`` with zero
   amplitudes on clipped columns, and the 2-D entry); fails unless
   every output is bitwise equal.
4. ``step_vs_plain``: the CUDA step kernel likewise, bitwise
   (``STEP_CASES``: ragged 37 x 53, 64 x 96, NX of 3, 3 rows, 600 x 600,
   600 x 128, 601 x 598, NX % 4 of 1, 2 and 3 at 4096 rows, inputs offset from
   16-byte alignment, 4096 x 4096 at S=1 and S=4; S=1 also through the
   2-D entry).
5. ``session``: the main path at the paper's size (``FWIConfig()``:
   600 x 600, 4 shots, 600 steps) — ``ElasticOrchestrator`` drives
   ``fwi_session_factory(stripes_for=elastic_stripes_for(1, 2),
   device="cuda")`` through a scripted GROW onto 2 stripes and a RETIRE
   back to 1 (checkpoint -> new session -> restore), a
   ``PreemptionGuard`` snapshot is saved on 2 stripes and resumed on 1
   to the end.  The kernel's launch count must equal the sessions'
   (blocks × stripes), and the final field must be bitwise equal to
   the plain version's on the CPU.
6. ``striped``: the striped domain (``fwi/domain.py``) at the paper's
   size, 600 steps, k = 4: 2 and 4 stripes under each schedule, bitwise
   against the single-stripe block runner on the card, the launch
   count (blocks × stripes × 1 for "fused", × 3 for the split
   schedules), host ms per step and a profile's device ms per step
   split into the kernel's and the copies'.
7. ``shot_split`` (4 shots over 3 shards, bitwise against the block
   runner) and ``seam`` (``measure_seam_latency`` at 600² and 4096², 2
   and 4 stripes).
7b. ``deadline_squeeze``: the paper's deadline-aware loop at the
   paper's size — ``PlanAutoscaler`` drives the session through a
   mid-run deadline squeeze and its relaxation (``SQUEEZE``: the JAX
   package's end-to-end schedule ×5), so it GROWs onto a cloud pod (2
   stripes) and RETIREs back to 1.  Fails unless the deadline is met,
   the decisions equal the same schedule's on the CPU at 48 x 96, the
   launches equal the sessions' and the final field is bitwise equal to
   the card's unscaled ``run_forward`` and the CPU's; prints the host
   ms of the policy's ``decide``, the checkpoints, the restores and the
   blocks.  ``fleet``: ``FleetSim`` over every default and queued
   scenario under every per-job policy with the card's probe in
   ``OVERHEADS``, and the fleet demo's claims.  ``shot_batch_probe``:
   the seam probe at 600², 2 stripes, k = 4, and the block engine's
   seconds a step at 600², k = 8, S = 1, 2, 4 and four S = 1 launches
   a block, printed as ``repro_torch/sim/scenarios.py``'s
   ``SEAM_PROBE`` and ``SHOT_BATCH_PROBE``, with the card's name.
8. ``scan_vs_block``: the step-at-a-time engine (``make_scan_runner``,
   one step-kernel launch per step) against the block engine over all
   600 steps at the paper's size: bitwise, traces included.
9. ``calibration``: the paper's pre-processing phase on the card — the
   gamma sweep and its linear fit at the paper's height (nz=600) and a
   production height (nz=4096), then capacity models fitted from a
   measured step time drive ``BurstPlanner`` and
   ``ElasticOrchestrator`` through a congested 600-step run that must
   burst.
10. ``production``: ``run_forward`` at 4096 x 4096, 4 shots, 200 steps
   (k = 8): ms per block against the card's bound, one block held
   bitwise to the plain version on the card; then
   ``striped_production``: 4 stripes, "fused" and "pipeline", as
   ``striped``.
11. ``autotune``: the tile sweeps of both kernels at 600 x 600 and
   4096 x 4096 (S=4), every candidate held bitwise to the plain version
   at 600 x 600, and a short ``FWISession(autotune=True)`` run.
12. ``rmsnorm_vs_plain``: the fused residual-add + RMSNorm kernel
    against its plain version (``RMS_CASES``: the shapes of
    ``tests/test_kernels.py``, Yi-6B's prefill and decode rows, a ragged
    row count, the 8192 prefill rows of Jamba-v0.1, DeepSeek-V2 and -V3,
    mamba2-370m and qwen2-vl, decode rows (4, d) at every model width and
    (1, 8192), a width no 16-byte access divides and an x off 16-byte
    alignment; f32 and bf16):
    |got - want| <= atol + rtol·|want| with (1e-6, 1e-6) in f32 and
    (2e-2, 2^-8) in bf16 on out, h bitwise; each case names the kernel
    instantiation it ran.  Each bf16 case timed beside its bytes bound
    and the composition ``x + res`` then ``F.rms_norm``.
13. ``attention_vs_plain``: the flash-attention kernel against its
    plain version (the shapes of ``tests/test_kernels.py``, non-causal,
    Yi-6B's prefill in the model's layout, ragged S=300, S=1 and S=64
    at D=32 and 128, non-causal in the model's layout, Jamba-v0.1's
    prefill (4, 32, 8, 2048, 128) in the model's layout, MLA's pair
    of q·k 192 and v 128 at H = KH = 128, S = 1, 63, 65 and 2048, causal
    and not, f32 and bf16, v the strided half of a (B, S, H, 256)
    product as ``models/mla.py`` passes it, and in the model's layout
    whisper's encoder (8, 20, 20, 1500, 64, not causal), its
    cross-attention (Sq = 128 queries against Sk = 1500 frames), a
    ragged Sq = 7 against Sk = 65 and qwen2-vl's causal (4, 64, 8, 2048,
    128), f32 and bf16): atol 2e-5 in f32, 3e-2 in bf16.  Then with the
    logit soft-cap (``SOFTCAP_CASES``: Yi-6B's prefill and a non-causal
    case in the model's layout, ragged S=300, S=1, one query against 512
    keys, whisper's encoder and cross-attention, MLA's pair at S=65; q
    scaled by 8; f32 and bf16; caps 50 and 5), each within the same
    tolerance, and at cap 5 each case whose queries see more than one
    key more than 100 tolerances from the uncapped kernel.
14. ``serve_vs_cpu``: Yi-6B at full width, 2 layers, f32 (no TF32):
    the same weights serve on the card (kernels) and on the CPU (plain
    versions), B=2, prompt 128, 4 greedy steps: logits within
    1e-3·max|logit|, identical tokens, the predicted launch counts; then
    the same with the logit soft-cap at 50 (Gemma 2's), whose CPU run
    records each layer's largest score (above the cap at both), and
    its distance from the uncapped run.
15. ``serve``: Yi-6B at full width and depth in bf16 through
    ``launch/serve.py``'s functions: 4 requests of 512 prompt tokens and
    32 greedy tokens each, with prefill and decode times, peak memory,
    the kernels' launches per prefill and per decode step (equal to
    ``launches_per_pass``) and a profile of each phase.  Every kernel
    call of one prefill and one decode step of the served model is held
    to its plain version on the same activations, and the serving
    invariant (full prefill against prefill(S-1) + one decode step) is
    held at all 32 layers in bf16 within 5e-2·max|logit|, with the
    attention projections drawn at the fan-in of their contraction
    (``well_conditioned``).  Then the same model at a logit soft-cap of
    50 on the same params: one prefill and 4 decode steps (finite
    logits, 32 flash launches a prefill, the predicted launches) and the
    invariant within 5e-2·max|logit| on the served params themselves
    (the cap keeps the init rule's scores within ±50).
16. ``ssd_vs_plain``: the SSD chunk kernel against its plain version
    on ``SSD_CASES`` (the shapes of ``tests/test_kernels.py`` in f32 and
    bf16, a ragged Q=96, the largest N and P, mamba2-370m's served
    prefill in bf16 on the model's views (B and C stride-0 head
    broadcasts, xdt the model's permuted view) and with per-head B and
    C, ragged Q and odd H on the model's views, two groups repeated per
    head, Jamba-v0.1's served prefill (32, 128, 256, 16, 64) on the
    model's views, N = 16 with one group stride-0 over 128 heads): atol
    1e-5 in f32; in bf16 y within 2^-8·max|y| + 2^-7·|y| and the state
    within 1e-5; device ms at mamba2's served shape in both layouts and
    at Jamba's against their bounds, the launch the wrapper made and the
    plain version's ms.
17. ``mamba_vs_cpu``: mamba2-370m at full width and all 48 layers, f32
    (no TF32): the same weights serve on the card (kernels) and on the
    CPU (plain versions), B=2, prompt 300 (one full chunk, one padded),
    4 greedy steps: logits within 1e-3·max|logit|, identical tokens, the
    launch counts of ``launches_per_pass``, and the card's prefill vs
    prefill(S-1) + decode within 1e-4·max|logit|.
18. ``mamba_serve``: mamba2-370m at full size in bf16 through
    ``launch/serve.py``'s functions: 4 requests of 2048 prompt tokens
    and 32 greedy tokens, with prefill and decode times, peak memory,
    launches per prefill and per step and a profile of each phase.
    Every SSD and norm call of one prefill and decode step is held to
    its plain version on the served activations, and the 48-layer bf16
    invariant within 0.1·max|logit| under the init rule itself.
18b. ``dense_vs_cpu``: Yi-9B, Granite-8B and Minitron-8B (squared-ReLU
    MLP) each at full width, 2 layers, f32, in ``serve_vs_cpu``'s form:
    logits within 1e-3·max|logit|, identical tokens, the launch counts.
18c. ``jamba_vs_cpu``: Jamba-v0.1 at full width, f32 (no TF32), cut to
    3 layers that keep one of each kind of its period, (mamba, dense),
    (mamba, moe) and (attn, dense), as one block: the same weights serve
    on the card and on the CPU, B=2, prompt 300, 4 greedy steps: logits
    within 1e-3·max|logit|, identical tokens, identical expert choices
    wherever the k-th and (k+1)-th router probabilities part by more
    than 1e-5 (the count below printed), equal dropped (token, expert)
    assignments, the launch counts, and the card's prefill vs
    prefill(S-1) + decode within 1e-4·max|logit| on the requests that
    lost no assignment in either prefill (at least one).
18d. ``jamba_serve``: Jamba-v0.1 at full width in bf16 cut to one
    period (8 layers: ``reduced`` 32 -> 8; 103 GB in bf16 do not fit 80)
    through ``launch/serve.py``'s functions: 4 requests of 2048 prompt
    tokens (two MoE groups of 4096, C = 640) and 32 greedy tokens, with
    prefill and decode times against their bounds (the prefill's
    products counted by ``jamba_prefill_flops``, the weights' bytes per
    decode step), tokens/s, peak memory, launches per prefill and per
    step, dropped assignments per MoE layer and request, and a profile
    of each phase by kind (with the MoE ranges' device ms: dispatch,
    experts, combine).  Every flash, SSD and norm call of one prefill
    and one decode step is held to its plain version on the served
    activations, and the 8-layer bf16 invariant within 5e-2·max|logit|
    with ``well_conditioned`` attention weights on the requests that
    lost no assignment and turned no expert at a router gap below
    ``ROUTER_NEAR_TIE`` (the figure under the init rule printed).
18e. ``deepseek_vs_cpu``: DeepSeek-V2 at full width, f32 (no TF32),
    cut to 2 layers (its dense layer and one MoE layer; 5.36 B
    parameters): the same weights serve on the card and on the CPU, B=2,
    prompt 300 (one MoE group of 600, C = 28), 4 greedy steps: logits
    within 1e-3·max|logit|, identical tokens, identical expert choices
    wherever the 6th and 7th router probabilities part by more than
    1e-5, equal dropped assignments, the launch counts.
18f. ``deepseek_serve``: DeepSeek-V2 at full width in bf16 cut to 4
    layers (``reduced`` 60 -> 4: blocks repeat 1 + 59 -> 1 + 3; 13.30 B
    parameters, 26.6 GB) through ``launch/serve.py``'s functions: 4
    requests of 2048 prompt tokens (one MoE group of 8192, C = 384) and
    32 greedy tokens, with prefill and decode times against their bounds
    (``deepseek_prefill_flops``, the weights' bytes), tokens/s, peak
    memory, launches per prefill and per step, the routing and drops of
    each MoE layer, a profile of each phase by kind with the MoE ranges
    and the queue scan's device ms; every flash and norm call of one
    prefill and one decode step is held to its plain version on the
    served activations, and the 4-layer bf16 invariant is held within
    5e-2·max|logit| under the init rule on the requests that lost no
    assignment, or within the norm's plain version's reading on the
    same requests plus ``NORM_FORM_SHARE`` (with ``well_conditioned``
    MLA weights every request loses some: printed).  Then DeepSeek-V3 at
    full width cut to 2 layers (61 -> 2: blocks 3 + 58 -> 1 + 1; 14.63 B
    parameters with the MTP head, 29.3 GB): a prefill and 8 decode steps
    at 4 x 2048 (256 experts, top-8, C = 320; the norm at d = 7168),
    its launches, routing, and every flash and norm call held.
18g. ``encdec_vs_cpu``: whisper-large-v3 at full width (d 1280, 20
    heads of 64, d_ff 5120, vocab 51866) cut to 4 encoder and 4 decoder
    layers, f32 (no TF32), with ``well_conditioned`` attention weights:
    B=2, 1500 frames, a 32-token prompt, 8 greedy steps on the card and
    on the CPU: logits within 1e-4·max|logit|, identical tokens, 12
    flash launches a prefill and no norm launch; the same under the
    init rule printed, not held (its near one-hot attention over 1500
    frames turns f32 roundings into O(1) differences).
18h. ``whisper_serve``: whisper-large-v3 whole (32 + 32 layers, 1.53 B
    parameters) in bf16 through ``launch/serve.py``'s functions: B=8,
    1500 frames, 128-token prompts, 64 greedy tokens (max_seq 192):
    prefill and decode times against their bounds
    (``whisper_prefill_flops``; ``decode_read_bytes``: the decoder's
    weights and the caches, the 2 GB cross cache among them), tokens/s,
    peak memory, launches (96 flash a prefill, none a step, no norm
    launch), every flash call of one prefill held to its plain version
    on the served activations, the 32-layer bf16 invariant within
    5e-2·max|logit| with ``well_conditioned`` attention (the init rule's
    figure printed), and a profile of each phase by kind with
    layernorm's device time (``LayerNormRanges``).
18i. ``qwen2vl_vs_cpu``: qwen2-vl-72b at full width (d 8192, 64 / 8
    heads, d_ff 29568, vocab 152064) cut to 2 layers, f32, with
    ``well_conditioned`` attention: B=1, 512 embedding positions of a
    prompt with one 16 x 16 image (``launch/serve.py::image_positions``:
    the three M-RoPE rows differ), 8 greedy steps whose positions trail
    the cache index: logits within 1e-4·max|logit|, identical tokens,
    launches.
18j. ``qwen2vl_serve``: qwen2-vl-72b at full width in bf16 cut to 4 of
    80 layers (6.00 B parameters; 80 are 145 GB): B=4, 2048 embedding
    positions with the image's positions, 32 greedy tokens, as
    ``whisper_serve`` (launches 4 flash and 9 norm a prefill, 9 norm a
    step).
19. ``train_grad_vs_plain``: each autograd Function of the LM kernels
    (the kernel forward, the plain backward) against autograd through
    the plain version on the same inputs and output gradients: Yi-6B's
    (2048, 4096) bf16 norm rows and (4, 32, 4, 512, 128) bf16 attention
    in the model's layout, mamba2's bf16 SSD shape with stride-0 B and C,
    and one f32 case each (attention also an f32 case soft-capped at 5),
    within the forwards' tolerances; the Function's forward must launch
    its kernel once.
20. ``train_vs_cpu``: Yi-6B and mamba2-370m at full width, 2 layers, f32
    (no TF32), B=2, S=256: loss and every gradient leaf on the card
    (kernels through their Functions, remat "full") against the CPU
    (plain versions): loss within 1e-4 relative, each leaf within
    1e-3·max|g| (the worst leaf printed), launches as
    ``launches_per_pass(cfg, "train", "full")`` predicts.
21. ``train``: Yi-6B at full width cut to 4 layers, f32 parameters and
    bf16 compute, train_4k's sequence of 4096 with the global batch cut
    to 8 in microbatches of 2, loss chunks of 512, remat "full", AdamW,
    8 steps through ``launch/train.py::train``: each step's loss (all
    finite), host ms a step, tokens/s, peak memory, launches a step
    (equal to ``launches_per_pass``'s prediction: each layer's twice,
    the final norm once, per microbatch) and a profile of one
    microbatch's step (device ms by kind, and the device ms inside the
    Functions' ``*_plain_backward`` ranges).  Then 4 steps through
    ``train`` into a checkpoint, its restore by the port's manager and 4
    more steps, against the 8 straight: ``bitwise`` or the largest
    difference of the state.  Then ``build_train_step(..., donate=True)``
    against ``donate=False``, 2 steps each from the seeded state: fails
    unless every leaf is bitwise equal; prints both ways the update's
    own bytes above the state and the gradients and the whole step's
    peak.
22. ``mamba_train``: mamba2-370m whole (48 layers), f32 parameters and
    bf16 compute, B=4, S=2048 in microbatches of 1, remat "full", AdamW,
    4 steps: the same prints and checks.
22a. ``moe_train``: the train CLI's donated step (``build_session`` on
    the one-rank NCCL mesh) at full width in bf16, remat "full", each
    config's optimizer, 2 steps a cell: DeepSeek-V2 cut to 2 layers
    (5.36 B parameters, 8-bit AdamW, B x S = ``MOE_TRAIN_V2``) and
    Jamba-v0.1 cut to 3 (3.95 B, AdamW with its f32 master,
    ``MOE_TRAIN_JAMBA``), at a constant rate of 1e-2.  The first step
    runs as the step runs it, split to measure: the gradient pass, then
    the in-place update, before which every leaf's first and last rows
    (at most 4 Mi elements each) and, where the update cuts the leaf
    into chunks, the rows about the first chunk boundary are cloned with
    their gradients, moments and master and run through the plain
    ``update``; fails unless those rows of the in-place result are
    bitwise equal, every range with a nonzero gradient has its
    parameters, master and first moment moved (so an unwritten leaf
    would show), the update adds at most 2 GiB above the state and the
    gradients, the losses are finite and each step launches what
    ``launches_per_pass`` predicts.  Prints the parameters, ``reduced``,
    the state's bytes (parameters, master, moments, scales), the
    gradients' bytes, the pass's and the step's peaks, the second step's
    rise over what is allocated before it (``launch_cost`` holds the
    dry run's against it), the update's own bytes and the host ms of
    the pass, the update and the second step.
22d. ``pipeline_train``: the ``train`` cell (AdamW at a constant 1e-4,
    no loss mask) through ``runtime/pipeline.py``'s GPipe step with its
    stages in one process and its state donated (as ``launch/perf.py``
    builds it), 4 microbatches of 2 rows, 2 steps at 2
    stages and 2 at 4, each from the seeded state, against
    ``build_train_step`` in microbatches of 2: losses within
    ``PIPELINE_LOSS_RTOL``, each leaf's update within
    ``PIPELINE_UPDATE_RL2`` relative L2 (the worst leaf of each step
    printed), launches a step equal both ways (32 flash, 68 norm), the
    hops' bytes a step (2 × (stages − 1) × B × S × d bf16 each way)
    beside each stage's and the model's f32 gradient bytes and the int8
    wire bytes, host ms a step and peak memory both ways, the bubble
    share.
22e. ``elastic_burst``: the train run moved between worlds of ranks
    (``launch/world.py``, ``launch/elastic.py``): Granite-8B at full
    width cut to 4 layers (``reduced`` 36 -> 4: 36 layers of f32 state
    do not fit), the train cell's S = 4096, B = 8 in microbatches of 2,
    remat "full", AdamW at a constant 1e-4; a one-rank NCCL world on (1,
    1) takes 2 steps from the seeded state, saves a generation, takes 2
    more (the un-moved run) and closes; a one-rank world on (1, 1, 1)
    ("pod", "data", "model") restores the generation onto its pod
    placements and takes the same 2.  Fails unless the losses and every
    leaf's CRC-32 are equal, every restored leaf is at its placement and
    each step launches 32 flash and 68 norm kernels; prints host ms a
    step and peak memory in each world, the parent's allocated bytes,
    the seconds and bytes of the save, the teardown and restart and the
    restore beside the demo's modelled overheads.
    ``examples/torch_elastic_burst_demo.py --meshes 1x1,1x1x1`` runs on
    the card at the CPU test's cut (24 steps, congestion from step 14)
    alongside the first world's start, setup and seeded state; its
    events must equal its modelled clock's.
22f. ``launch_cost``: the launch layer's cost tools on the card.
    ``launch/hw.py::spec_for`` of the card's name beside its
    ``total_memory``; Yi-6B whole (32 layers, bf16, B = 4, P = 512, as
    in ``serve``): one prefill and one decode step under
    ``launch/op_cost.py::OpCostMode``, the counted prefill FLOPs within
    1 % of ``qwen2vl_prefill_flops`` (the dense GQA products),
    the decode step's bytes read from the weights and the cache
    (``input_read_bytes``) within 1 % of ``decode_read_bytes``, its
    launch-boundary bytes (``hbm_bytes``) beside them,
    ``roofline_terms`` with the card's spec within 1 % of the bounds
    those formulas give, the logits bitwise equal with and without the
    mode, the launches those of ``launches_per_pass`` (32 flash and 65
    norm a prefill); each registered LM op bitwise equal to its bare
    ctypes call, and the norm's host µs a call at the decode row
    through the op and through the ctypes call; and, in subprocesses
    on the host, ``python -m repro_torch.launch.dryrun`` of ``yi-6b ×
    decode_32k × single`` on a fake 256-rank group (its roofline and
    peak GiB a rank), and the donated train steps of
    ``LAUNCH_COST_TRAIN`` through ``dryrun_cell`` on the card's torch:
    yi-6b, mamba2-370m, Jamba-v0.1, DeepSeek-V2 and whisper-large-v3
    on (16, 16) and DeepSeek-V2 on (2, 16, 16), each cut to one layer
    of each kind (Jamba and V2 on (16, 16) in two microbatches), the
    cut its ``reduced``; fails unless every cell is ``ok`` (no view of a
    DTensor refused), and prints each one's trace seconds, peak GiB a
    rank and dominant roofline term.  The peak is held to the card: the
    ``HELD_STEPS`` (``moe_train``'s two donated steps, and one prefill
    of Yi-6B at 4 x 512 under the serve rules on the one-rank NCCL mesh,
    measured here after a warm-up) are traced in three more
    subprocesses by ``dryrun.dryrun_step`` on a one-rank fake world;
    fails unless each one's rise over its arguments
    (``launch/live_bytes.py``'s peak less the arguments' bytes) is
    within ``PEAK_TOL`` (5 %) of the card's (``max_memory_allocated``
    less ``memory_allocated`` before the step), and prints both rises,
    both peaks and the gap.
22g. ``lint``: the port's lint suite (``repro_torch.analysis``) held to
    the card, last of the phases.  It lints the default paths and
    requires no finding; calls each library's shared-memory size query
    (``wave_block_smem_bytes``, ``flash_smem_query``,
    ``ssd_smem_query``, ``rmsnorm_smem_query``) through ``ctypes`` at
    every configuration ``smem-budget`` checks, and requires query =
    Python formula = the rule's static value; requires each kernel
    instantiation's ptxas ``bytes smem`` (the ``<library>.log`` that
    ``kernels/build.py`` keeps) to equal the rule's count of its static
    ``__shared__`` bytes, and ``MAX_SMEM_BYTES`` to equal the card's
    ``shared_memory_per_block_optin``; and runs four paths under
    ``torch.cuda.set_sync_debug_mode("warn")`` — the FWI block runner
    at 600², 4 shots, 8 blocks; Yi-6B at full width, 2 layers, one 4 ×
    512 prefill and 4 decode steps; mamba2-370m at full width, 2
    layers, one 4 × 2048 prefill and 2 decode steps; one
    ``build_train_step`` step of Yi-6B and of mamba2-370m at full width,
    2 layers, B = 2, S = 256 (the three autograd Functions) — each once
    before, unwatched, so caches and libraries are built outside the
    watched run.  Every sync PyTorch reports is recorded by its
    innermost frame in ``src/repro_torch``; each must be a ``host-sync``
    finding or a suppressed line, and none may come from outside the
    port.  Held to 30 s.
23. ``kernels``: ``{"kernels": [...]}``, one entry per hand-written
    kernel with its time, launches, error, bound and plain-version time
    (the block kernel's launches in the session, in calibration, in
    ``production``, ``striped``, ``striped_production``,
    ``shot_split`` and ``deadline_squeeze``, and its device ms at each window shape; the step kernel's in the nz=600 and nz=4096 gamma
    sweeps and in ``scan_vs_block``, its device ms at every gamma-sweep
    shape beside the bound and the launch the wrapper made (``sweep``,
    each shape first held bitwise to the plain version) and its
    ``design``);
    flash attention also at a long prompt (``ms_long``,
    ``library_ms_long``, ``bound_ms_long`` at (1, 32, 4, 4096, 128)),
    with the soft-cap at Yi-6B's shape (``ms_softcap``,
    ``plain_ms_softcap``) and its bf16 ``design``; the SSD kernel also with per-head B and C
    (``ms_per_head``, ``bound_ms_per_head``), the heads a CTA took at
    the served shape (``heads_per_cta``) and its ``design``; each LM
    kernel also its launches in ``train`` and ``mamba_train``
    (``launches_train``, ``launches_train_per_step``, ...) and in
    ``jamba_serve`` (``launches_jamba``, ``..._per_prefill``,
    ``..._per_step``), and its device ms, plain ms, bound and library ms
    at Jamba-v0.1's served shape (``ms_jamba``, ...); flash and the norm
    also their launches in ``deepseek_serve`` (``launches_deepseek``,
    ...) and their times at DeepSeek's shapes (``ms_mla``, ... at (4,
    128, 128, 2048, 192 / 128); ``ms_deepseek_v2`` and
    ``ms_deepseek_v3``, ... at 8192 rows of 5120 and 7168); flash also
    its times at whisper's encoder, its cross-attention and qwen2-vl's
    prefill (``ms_whisper_enc``, ``ms_cross``, ``ms_qwen2vl``, each with
    its plain, SDPA and bound ms), the norm at qwen2-vl's 8192 rows of
    8192 (``ms_qwen2vl``, ...), both their launches in ``whisper_serve``
    and ``qwen2vl_serve`` (``launches_whisper``, ``..._per_prefill``,
    ``..._per_step``, ``launches_qwen2vl``, ...); the LM kernels also
    their launches in ``sharded_train``, ``deepseek_sharded_train``,
    ``moe_train``, ``sharded_serve``, ``compressed_train`` and
    ``pipeline_train``
    (``launches_pipeline_train``, both stage counts' steps) and
    ``elastic_burst`` (``launches_elastic_burst``) and ``launch_cost``
    (``launches_launch_cost``); the norm also the card's launch floor
    (``launch_floor_ms``: a one-element ``torch.add`` timed as the
    kernels are) and its host µs a decode-row call through the
    registered op and through the bare ctypes call (``host_us_op``,
    ``host_us_ctypes``), its ``design``, the composition's time at the
    Yi-6B rows (``composition_ms``, ``composition_ms_decode``) and the
    bf16 times of ``rmsnorm_vs_plain`` (``timed_bf16``).

Each phase line carries ``elapsed_s``, the script's seconds so far.
Then the card's ``nvidia-smi`` line, and last the contract line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before it; without a CUDA card, or outside the repository, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
TOL = 1e-5

#: rmsnorm (atol, rtol) by dtype: f32 sums in another order round an ulp
#: or two apart; a bf16 output may round to its neighbour (2^-8)
RMS_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2e-2, 2.0 ** -8)}
#: attention atol by dtype (tests/test_kernels.py)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: the bf16 flash kernel is timed at Yi-6B's prefill and at a long
#: prompt, (B, H, KH, S, D), causal, where the work is compute-bound
FLASH_SHAPE = (4, 32, 4, 512, 128)
FLASH_SHAPE_LONG = (1, 32, 4, 4096, 128)
#: the attention logit soft-cap (``attn_logit_softcap``): no config of
#: the repository sets one, so the full-width path takes Gemma 2's
#: published ``attn_logit_softcapping`` (arXiv:2408.00118) on Yi-6B, and
#: the kernel cases also a cap of 5.  Capped kernel cases scale q by
#: SOFTCAP_GAIN (exact in bf16), so the scaled scores have a std of 8
#: and both caps bite; at cap 5 each case must move the kernel's output
#: by more than SOFTCAP_BITE tolerances from the uncapped kernel's.
#: Such scores make a row's weights near one-hot, so an output is near
#: one of v's values: v is drawn uniform within ±SOFTCAP_V, and every
#: output stays below 4, where a bf16 step is 2^-6 and the two versions'
#: roundings part by one step at most.  (Unit-normal v reaches 5, where a
#: step, 2^-5, is above ATTN_TOL: a capped bf16 case at Yi-6B's shape
#: read 0.03125 so.)
SOFTCAP = 50.0
SOFTCAP_CASE_CAPS = (50.0, 5.0)
SOFTCAP_GAIN = 8.0
SOFTCAP_V = 3.5
SOFTCAP_BITE = 100
#: serve_vs_cpu: f32 logits on the card within this share of max|logit|
SERVE_F32_TOL = 1e-3
#: flash attention on the served model's activations: |got - want| <=
#: this share of max|v|.  The kernel rounds its probabilities to bf16
#: before it divides by their sum, the plain version after; each
#: rounding is within 2^-9 and each output is rounded once more, so the
#: two part by up to 2^-7·max|v|, and max|v| is ~150 under the init rule
#: (v's std is 32).  The limit is twice that bound.
ATTN_ACT_SHARE = 2.0 ** -6
#: serve: full prefill vs prefill(S-1) + decode at full depth in bf16,
#: as a share of max|logit|, with ``well_conditioned`` weights.  Under
#: the init rule itself the attention is one-hot (scores with a std in
#: the hundreds) and each layer multiplies a rounding difference at the
#: new position by ~5-10, in f32 as in bf16 and in the JAX package as in
#: the port (tools/serve_depth_witness.py).
SERVE_INV_TOL = 5e-2
#: jamba_serve's bf16 invariant leaves out a request whose last position
#: took other experts in the decode step than in the full prefill where
#: the k-th and (k+1)-th router probabilities lie within this gap: a
#: near-tie that the rounding of a bf16 activation turns, under the
#: norm's plain version as under its kernel, and a turned top-2 expert
#: moves its request's logits 8x (tools/norm_invariant_probe.py); a
#: request whose experts turned at a wider gap stays compared.  No other
#: invariant leaves out turned experts
ROUTER_NEAR_TIE = 2.0 ** -8
#: ssd_vs_plain: f32 atol (tests/test_kernels.py); bf16 y within
#: (share of max|y|, rtol): both versions round (C·Bᵀ)∘L to bf16 after f32
#: sums in other orders (a flipped rounding moves a term by one bf16
#: step) and round y once (one step, 2^-7·|y| at most); the state is f32
#: in both (the kernel carries B·to_end as three bf16 parts, ~2^-24)
SSD_TOL = 1e-5
SSD_BF16_Y = (2.0 ** -8, 2.0 ** -7)
#: the SSD kernel on the served activations, against bounds computed
#: from the same inputs: y within 2^-7·|y| + 2^-7·(|(C·Bᵀ)∘L|·|xdt|) (the
#: bf16 roundings above, term by term: one bf16 step is at most 2^-7 of
#: a value); the state within
#: 2^-15·(|B·to_end|ᵀ·|xdt|): two f32 sums of Q ≤ 256 products in other
#: orders each err by at most Q·2^-24 of the sum of |terms|
SSD_ACT_Y = (2.0 ** -7, 2.0 ** -7)
SSD_ACT_STATE = 2.0 ** -15
#: mamba_vs_cpu: f32 logits on the card within this share of max|logit|
#: of the CPU's, and the card's own prefill-vs-decode invariant
MAMBA_F32_TOL = 1e-3
MAMBA_F32_INV = 1e-4
#: mamba_serve: the 48-layer bf16 invariant as a share of max|logit|
#: (the JAX package: 3.5 % at B=2, S=300 under the same init rule)
MAMBA_INV_TOL = 0.1
#: deepseek_serve: the 4-layer bf16 invariant (held under the init rule)
#: is held within SERVE_INV_TOL·max|logit|, or within the reading of the
#: norm's plain version on the same weights, prompts and requests plus
#: this share of max|logit|.  Every valid form of the norm (its kernel,
#: its plain version, its plain version with an f64 sum, an earlier
#: kernel) reads 4.5 to 6.9 % at three prompt seeds, -1.2 to +1.1 % from
#: the plain version; the norm's decode rows scaled by 1 + 2^-7 or
#: 1 + 2^-5 read +2.2 to +4.0 % above it, the decode step at the wrong
#: position +72 to +90 % (tools/norm_invariant_probe.py --arch deepseek
#: --seeds 3 --faults)
NORM_FORM_SHARE = 1.5e-2
#: Jamba-v0.1 served at 4 x 2048 tokens: the flash call (B, H, KH, S, D),
#: causal, no RoPE; the SSD chunk call (BC, H, Q, N, P) on the model's
#: views (B and C one group, stride 0 over 128 heads); the norm's rows
FLASH_SHAPE_JAMBA = (4, 32, 8, 2048, 128)
SSD_JAMBA = (32, 128, 256, 16, 64)
RMS_ROWS_JAMBA = (8192, 4096)
#: DeepSeek-V2 served at 4 x 2048 tokens: MLA's flash call (B, H, KH, S,
#: Dqk, Dv), causal, v the strided half of the wkv_b product (its first
#: MLA_NOPE columns are k's nope part); the norm's rows at V2's d = 5120
#: and V3's 7168
MLA_NOPE, MLA_DV = 128, 128
FLASH_SHAPE_MLA = (4, 128, 128, 2048, 192, MLA_DV)
RMS_ROWS_DEEPSEEK = ((8192, 5120), (8192, 7168))
#: whisper-large-v3 served at B = 8, 1500 frames, a 128-token prompt and
#: qwen2-vl-72b at B = 4, 2048 positions: the flash calls (B, H, KH, Sq,
#: D), causal or not, and Sk where it is not Sq — the encoder's
#: non-causal self-attention, the decoder's cross-attention (decoder
#: queries against the frames), qwen2-vl's causal GQA prefill
FLASH_WHISPER_ENC = ((8, 20, 20, 1500, 64), False, None)
FLASH_CROSS = ((8, 20, 20, 128, 64), False, 1500)
FLASH_QWEN2VL = ((4, 64, 8, 2048, 128), True, None)
#: jamba_vs_cpu: f32 logits on the card within this share of max|logit|
#: of the CPU's, and the card's own prefill-vs-decode invariant; expert
#: choices are compared where the k-th and (k+1)-th router probabilities
#: part by more than ROUTER_GAP (f32 roundings move a probability by
#: ~1e-7, so a closer pair may swap on either device)
JAMBA_F32_TOL = 1e-3
JAMBA_F32_INV = 1e-4
ROUTER_GAP = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


#: the script's start on the host clock; each phase line carries the
#: seconds since (``elapsed_s``)
T0 = time.monotonic()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.monotonic() - T0, 3))
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[float, float, float]:
    """The card's published peaks (NVIDIA data sheets) from
    ``repro_torch/launch/hw.py::spec_for``: HBM bytes/s, f32 FLOP/s
    without tensor cores, dense bf16 tensor-core FLOP/s."""
    from repro_torch.launch.hw import spec_for

    try:
        spec = spec_for(name)
    except KeyError as e:
        raise SmokeFailure(str(e)) from None
    return spec.hbm_bw, spec.peak_flops_f32, spec.peak_flops_bf16


def block_inputs(rng, dev, ns, nz, nx, k, *, per_shot=True, src=None,
                 zero=()):
    """Unit-normal wavefields, positive model fields, per-shot (or
    shared) amplitudes and source cells (drawn, or ``src``) from
    ``rng``, on ``dev``: the block kernel's seven inputs.  The shots in
    ``zero`` get zero amplitudes (a stripe window that does not cover
    their source)."""
    p = rng.standard_normal((ns, nz, nx), dtype=np.float32)
    pp = rng.standard_normal((ns, nz, nx), dtype=np.float32)
    v2 = rng.uniform(0.05, 0.2, (nz, nx)).astype(np.float32)
    sp = rng.uniform(0.9, 1.0, (nz, nx)).astype(np.float32)
    sv = rng.standard_normal((ns, k) if per_shot else (k,),
                             dtype=np.float32)
    sv[list(zero)] = 0.0
    if src is None:
        src = (rng.integers(0, nz, ns), rng.integers(0, nx, ns))
    sz = np.asarray(src[0], np.int32)
    sx = np.asarray(src[1], np.int32)
    return [torch.from_numpy(a).to(dev) for a in (p, pp, v2, sp, sv, sz, sx)]


def max_diff(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def compare_block(ops, ref, args, receiver_row) -> tuple[float, bool]:
    """(max |kernel - plain|, bitwise) of one block through the
    dispatch (the kernel at its default tile)."""
    got = ops.wave_block(*args, receiver_row=receiver_row)
    want = ref.wave_block_shots_ref(*args, receiver_row=receiver_row)
    torch.cuda.synchronize()
    return max_diff(got, want), all(
        torch.equal(g, w) for g, w in zip(got, want))


#: the striped engine's windows (``fwi/domain.py``): label, (S, NZ, NX,
#: k), source cells.  Shots 0 and 1 sit on the window's first and last
#: column with zero amplitudes, as a window that does not cover a shot
#: gives them (its clipped column); the boundary windows (3·k·HALO
#: columns) are narrower than one CTA tile.
WINDOW_CASES = [
    ("stripe window 600/2 k=4", (4, 600, 316, 4),
     ([4, 4, 300, 599], [0, 315, 7, 158])),
    ("stripe window 600/4 k=4", (4, 600, 166, 4),
     ([4, 4, 0, 599], [0, 165, 83, 31])),
    ("boundary window 600 k=4", (4, 600, 24, 4),
     ([4, 4, 300, 599], [0, 23, 12, 8])),
    ("stripe window 4096/4 k=8", (4, 4096, 1056, 8),
     ([4, 4, 2048, 4095], [0, 1055, 528, 31])),
    ("boundary window 4096 k=8", (4, 4096, 48, 8),
     ([4, 4, 2048, 0], [0, 47, 24, 16])),
]

#: kernel_vs_plain cases of the block kernel: label, (S, NZ, NX, k),
#: input options, receiver row.  Sources sit on tile seams (rows and
#: columns 32, 64, 2048 and one before them, seams of every
#: power-of-two tile) and on the field's edges.
BLOCK_CASES = [
    ("ragged tiny", (1, 37, 53, 1), dict(per_shot=False), 2),
    ("(S,k) amplitudes", (3, 64, 96, 3), {}, 2),
    ("paper size k=4", (4, 600, 600, 4), {}, 2),
    ("seams and edges k=8", (4, 600, 600, 8),
     dict(src=([32, 31, 0, 599], [64, 0, 599, 33])), 32),
    ("seams and edges k=1", (4, 600, 600, 1),
     dict(src=([64, 63, 0, 599], [128, 0, 599, 65])), 64),
    ("ragged seams k=3", (3, 130, 203, 3),
     dict(src=([64, 129, 31], [63, 202, 128])), 63),
    ("production size k=8", (4, 4096, 4096, 8),
     dict(src=([2048, 2047, 0, 4095], [2048, 0, 4095, 2047])), 2048),
    *[(label, shape, dict(src=src, zero=(0, 1)), 2)
      for label, shape, src in WINDOW_CASES],
]


def run_block_vs_plain(dev, rng) -> list[dict]:
    """The block kernel against its plain version on ``BLOCK_CASES``
    and the 2-D entry: every case must be bitwise equal."""
    from repro_torch.kernels.stencil import ops, ref

    cases = []
    for label, (ns, nz, nx, k), kw, rrow in BLOCK_CASES:
        args = block_inputs(rng, dev, ns, nz, nx, k, **kw)
        err, exact = compare_block(ops, ref, args, rrow)
        del args
        cases.append({"case": label, "S": ns, "nz": nz, "nx": nx, "k": k,
                      "receiver_row": rrow, "max_abs_diff": err,
                      "bitwise": exact})
        check(exact, f"kernel vs plain {label}: not bitwise "
                     f"(max |diff| {err})")
    torch.cuda.empty_cache()
    p, pp, v2, sp, sv, sz, sx = block_inputs(rng, dev, 1, 600, 600, 8,
                                             per_shot=False)
    got = ops.wave_block(p[0], pp[0], v2, sp, sv, int(sz[0]), int(sx[0]),
                         receiver_row=2)
    want = ref.wave_block_ref(p[0], pp[0], v2, sp, sv, int(sz[0]),
                              int(sx[0]), receiver_row=2)
    torch.cuda.synchronize()
    err = max_diff(got, want)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    cases.append({"case": "2-D entry k=8", "S": 1, "nz": 600, "nx": 600,
                  "k": 8, "receiver_row": 2, "max_abs_diff": err,
                  "bitwise": exact})
    check(exact, f"kernel vs plain 2-D entry: not bitwise (max |diff| "
                 f"{err})")
    return cases


def step_inputs(rng, dev, ns, nz, nx, *, offset=0):
    """Unit-normal wavefields and positive model fields from ``rng`` on
    ``dev``: the step kernel's four inputs.  ``offset`` > 0 places each
    one that many floats into its own allocation (a contiguous view whose
    address is only 4-byte aligned)."""
    p = rng.standard_normal((ns, nz, nx), dtype=np.float32)
    pp = rng.standard_normal((ns, nz, nx), dtype=np.float32)
    v2 = rng.uniform(0.05, 0.2, (nz, nx)).astype(np.float32)
    sp = rng.uniform(0.9, 1.0, (nz, nx)).astype(np.float32)
    out = []
    for a in (p, pp, v2, sp):
        t = torch.from_numpy(a).to(dev)
        if offset:
            buf = torch.empty(t.numel() + offset, device=dev)
            buf[offset:].copy_(t.reshape(-1))
            t = buf[offset:].view(t.shape)
        out.append(t)
    return out


#: step_vs_plain cases of the step kernel: label, (S, NZ, NX), offset of
#: the inputs in floats.  NX % 4 of 1, 2 and 3 and offset inputs take
#: the kernel's 1- and 2-column paths; 601 rows end in a part strip, 3
#: rows are fewer than one strip, 600 x 128 (the narrowest gamma-sweep
#: width) takes 2-row strips; the S=1 cases also go through the 2-D
#: entry.
STEP_CASES = [
    ("ragged tiny", (1, 37, 53), 0),
    ("small batch", (3, 64, 96), 0),
    ("narrow", (2, 9, 3), 0),
    ("fewer rows than a strip", (2, 3, 260), 0),
    ("2-row strips", (4, 600, 128), 0),
    ("paper size", (4, 600, 600), 0),
    ("ragged strips", (4, 601, 598), 0),
    ("NX % 4 = 1", (2, 4096, 1025), 0),
    ("NX % 4 = 2", (2, 4096, 1026), 0),
    ("NX % 4 = 3", (2, 4096, 1027), 0),
    ("offset inputs", (2, 600, 600), 1),
    ("offset inputs, even", (2, 600, 600), 2),
    ("single shot", (1, 4096, 4096), 0),
    ("production size", (4, 4096, 4096), 0),
]


def run_step_vs_plain(dev, rng) -> list[dict]:
    """The step kernel against its plain version on ``STEP_CASES``,
    through the dispatch at the default tile: every case must be
    bitwise equal, the S=1 ones through the 2-D entry too."""
    from repro_torch.kernels.stencil import ops, ref

    cases = []
    for label, (ns, nz, nx), offset in STEP_CASES:
        args = step_inputs(rng, dev, ns, nz, nx, offset=offset)
        got = ops.wave_step(*args)
        want = ref.wave_step_ref(*args)
        torch.cuda.synchronize()
        err = max_diff(got, want)
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        cases.append({"case": label, "S": ns, "nz": nz, "nx": nx,
                      "offset": offset, "max_abs_diff": err,
                      "bitwise": exact})
        check(exact, f"step kernel vs plain {label}: not bitwise "
                     f"(max |diff| {err})")
        if ns == 1:                                  # the 2-D entry
            got2 = ops.wave_step(args[0][0], args[1][0], *args[2:])
            check(all(torch.equal(g[None], w) for g, w in zip(got2, got)),
                  f"2-D wave_step differs from the S=1 batch ({label})")
        del args, got, want
    torch.cuda.empty_cache()
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.stencil import kernel, ops, ref, tune

    dev = torch.device("cuda", 0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, f32, bf16 = peaks_for(name)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peak_bytes_per_s": bw,
          "peak_f32_flops": f32, "peak_bf16_tensor_flops": bf16})

    # 2. build
    t0 = time.monotonic()
    libs = build.build_all()
    build_s = time.monotonic() - t0
    kernel._lib()
    ptxas = [ln.strip() for lib in libs.values()
             for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": sorted(str(p.relative_to(ROOT))
                              for p in libs.values()),
          "ptxas": ptxas})

    rng = np.random.default_rng(SEED)

    def inputs(ns, nz, nx, k, **kw):
        return block_inputs(rng, dev, ns, nz, nx, k, **kw)

    def compare(args, receiver_row):
        return compare_block(ops, ref, args, receiver_row)

    # 3. kernel_vs_plain
    cases = run_block_vs_plain(dev, rng)
    emit({"phase": "kernel_vs_plain", "contract": "bitwise",
          "tolerance": 0.0, "cases": cases})

    def step_args(ns, nz, nx):
        return step_inputs(rng, dev, ns, nz, nx)

    # 4. step_vs_plain
    cases = run_step_vs_plain(dev, rng)
    step_err = max(c["max_abs_diff"] for c in cases)
    emit({"phase": "step_vs_plain", "contract": "bitwise",
          "tolerance": 0.0, "cases": cases})

    # 5. session: the main path
    session_launches, refs, session = run_session(dev)
    emit(session)

    # 6. striped: this slice's path, the domain split into stripes
    striped_launches, striped = run_striped(dev)
    emit(striped)

    # 7. shot_split and seam
    split_launches, split = run_shot_split(dev)
    emit(split)
    seam = run_seam(dev)
    emit(seam)

    # 7b. the paper's deadline-aware loop, the fleet and the probes
    squeeze_launches, squeeze = run_deadline_squeeze(
        dev, refs, session["engine_ms_per_step"])
    emit(squeeze)
    emit(run_fleet())
    emit(run_shot_batch_probe(dev, smi, seam["probes"]))

    # 8. scan_vs_block
    scan = run_scan_vs_block(dev)
    emit(scan)

    # 9. calibration: the paper's pre-processing phase
    calib = run_calibration(dev)
    emit(calib)

    # 10. production, and striped at production size
    production = run_production(dev, bw, f32)
    emit(production)
    sprod_launches, sprod = run_striped_production(dev)
    emit(sprod)

    # 11. autotune
    emit(run_autotune(dev, step_args, inputs))

    # 12.-15. the LM serving slice
    torch.backends.cuda.matmul.allow_tf32 = False
    rms = run_rmsnorm_vs_plain(dev, rng, bw, f32)
    emit(rms)
    att = run_attention_vs_plain(dev, rng)
    emit(att)
    emit(run_serve_vs_cpu(dev))
    served = run_serve(dev)
    emit(served)

    # 16.-18. the Mamba-2 serving slice
    ssd = run_ssd_vs_plain(dev, rng, bw, bf16)
    emit(ssd)
    emit(run_mamba_vs_cpu(dev))
    mserved = run_mamba_serve(dev)
    emit(mserved)

    # 18b.-18d. the other dense archs, and the Jamba hybrid with MoE
    emit(run_dense_vs_cpu(dev))
    emit(run_jamba_vs_cpu(dev))
    jserved = run_jamba_serve(dev)
    emit(jserved)

    # 18e.-18f. DeepSeek: MLA over MoE layers
    emit(run_deepseek_vs_cpu(dev))
    dserved = run_deepseek_serve(dev)
    emit(dserved)

    # 18g.-18j. whisper (encoder, cross-attention, layernorm) and
    # qwen2-vl (M-RoPE over patch embeddings)
    emit(run_encdec_vs_cpu(dev))
    wserved = run_whisper_serve(dev)
    emit(wserved)
    emit(run_qwen2vl_vs_cpu(dev))
    qserved = run_qwen2vl_serve(dev)
    emit(qserved)

    # 19.-22. the training slice
    emit(run_train_grad_vs_plain(dev))
    emit(run_train_vs_cpu(dev))
    trained = run_train(dev, smi)
    emit(trained)
    mtrained = run_mamba_train(dev, smi)
    emit(mtrained)
    strained = run_sharded_train(dev, smi)
    emit(strained)
    dstrained = run_deepseek_sharded_train(dev, smi)
    emit(dstrained)
    # 22a. the donated step: DeepSeek-V2's and Jamba's full-width updates
    moetrained = run_moe_train(dev, smi)
    emit(moetrained)

    # 22b.-22c. sharded serving and the compressed cross-pod step
    sserved = run_sharded_serve(dev, smi)
    emit(sserved)
    ctrained = run_compressed_train(dev, smi)
    emit(ctrained)
    # 22d. GPipe over "pod", its stages in one process
    ptrained = run_pipeline_train(dev, smi)
    emit(ptrained)
    # 22e. the elastic burst: the train run moved between worlds
    eburst = run_elastic_burst(dev, smi)
    emit(eburst)
    # 22f. the launch layer's cost tools
    lcost = run_launch_cost(dev, moetrained)
    emit(lcost)
    # 22g. the lint suite, held to the card
    emit(run_lint(dev, smi))

    lm_entries = lm_kernel_entries(dev, bw, f32, bf16, rms, att, served)
    lm_entries[1]["launches_mamba"] = mserved["launches"]["rmsnorm_residual"]
    lm_entries.append(ssd_kernel_entry(ssd, mserved))
    jfields = jamba_kernel_fields(dev, bw, f32, bf16, ssd, jserved)
    dfields = deepseek_kernel_fields(dev, bw, f32, bf16, dserved)
    sfields = slice15_kernel_fields(dev, bw, f32, bf16, wserved, qserved)
    for entry in lm_entries:
        entry.update(jfields[entry["name"]])
        entry.update(dfields.get(entry["name"], {}))
        entry.update(sfields.get(entry["name"], {}))
    for entry in lm_entries:
        for key, cell in (("train", trained), ("mamba_train", mtrained)):
            if entry["name"] in cell["launches_predicted"]:
                entry[f"launches_{key}"] = cell["launches"][entry["name"]]
                entry[f"launches_{key}_per_step"] = \
                    cell["launches_per_step"][entry["name"]]
        entry["launches_sharded_train"] = strained["launches"].get(
            entry["name"], 0)
        entry["launches_deepseek_sharded_train"] = \
            dstrained["launches"].get(entry["name"], 0)
        entry["launches_moe_train"] = moetrained["launches"].get(
            entry["name"], 0)
        entry["launches_sharded_serve"] = sserved["launches"].get(
            entry["name"], 0)
        entry["launches_compressed_train"] = ctrained["launches"].get(
            entry["name"], 0)
        entry["launches_pipeline_train"] = ptrained["launches"].get(
            entry["name"], 0)
        entry["launches_elastic_burst"] = eburst["launches"].get(
            entry["name"], 0)
        entry["launches_launch_cost"] = lcost["launches"].get(
            entry["name"], 0)
    lm_entries[1].update(lcost["norm_host_us"])

    # 23. kernels
    windows = window_timings(dev, rng, bw, f32)
    timings = {}
    for label, (ns, nz, nx, k) in (("600", (4, 600, 600, 4)),
                                   ("4096", (4, 4096, 4096, 8)),
                                   ("600 S=1", (1, 600, 600, 4)),
                                   ("4096 S=1", (1, 4096, 4096, 8))):
        args = inputs(ns, nz, nx, k)
        err, exact = compare(args, 2)
        check(exact, f"kernel vs plain at {label}: not bitwise ({err})")
        small = label.startswith("600")
        ms = tune.device_time_ms(lambda: kernel.wave_block_shots_cuda(
            *args, receiver_row=2), reps=50 if small else 10)
        plain_ms = tune.device_time_ms(lambda: ref.wave_block_shots_ref(
            *args, receiver_row=2), reps=5 if small else 2)
        bound, by = bound_ms(kernel.block_bytes(ns, nz, nx, k),
                             kernel.block_flops(ns, nz, nx, k), bw, f32)
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, max_abs_err=err)
        del args
        torch.cuda.empty_cache()
    steps_t = {}
    for label, (ns, nz, nx) in (("600", (4, 600, 600)),
                                ("4096", (4, 4096, 4096))):
        args = step_args(ns, nz, nx)
        got = kernel.wave_step_cuda(*args)
        want = ref.wave_step_ref(*args)
        torch.cuda.synchronize()
        err = max_diff(got, want)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"step kernel vs plain at {label}: not bitwise ({err})")
        del got, want
        small = label == "600"
        ms = tune.device_time_ms(lambda: kernel.wave_step_cuda(*args),
                                 reps=200 if small else 20)
        plain_ms = tune.device_time_ms(lambda: ref.wave_step_ref(*args),
                                       reps=20 if small else 3)
        bound, by = bound_ms(kernel.step_bytes(ns, nz, nx),
                             kernel.step_flops(ns, nz, nx), bw, f32)
        steps_t[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by, max_abs_err=err)
        del args
        torch.cuda.empty_cache()
    step_sweep = run_step_sweep(dev, step_args, bw, f32)
    t6, t4k = timings["600"], timings["4096"]
    s6, s4k = timings["600 S=1"], timings["4096 S=1"]
    w6, w4k = steps_t["600"], steps_t["4096"]
    entry = {
        "name": "wave_block_shots",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stencil/csrc/wave_block.cu",
        "replaces": "src/repro/kernels/stencil/kernel.py:806",
        "also_replaces": [
            "src/repro/kernels/stencil/kernel.py:673",
            "src/repro/kernels/stencil/kernel.py:501",
            "src/repro/kernels/stencil/kernel.py:375",
        ],
        "launches": session_launches,
        "launches_calibration": calib["wave_block_launches"],
        "launches_production": production["kernel_launches"],
        "launches_striped": striped_launches,
        "launches_striped_production": sprod_launches,
        "launches_shot_split": split_launches,
        "launches_deadline_squeeze": squeeze_launches,
        "max_abs_err": max(t["max_abs_err"]
                           for t in [*timings.values(), *windows]),
        "ms": t6["ms"],
        "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"],
        "bound_by": t6["bound_by"],
        "library_ms": None,
        "shape": "S=4, 600x600, k=4 (the session's block)",
        "ms_4096": t4k["ms"],
        "plain_ms_4096": t4k["plain_ms"],
        "bound_ms_4096": t4k["bound_ms"],
        "shape_4096": "S=4, 4096x4096, k=8",
        "ms_s1": s6["ms"], "plain_ms_s1": s6["plain_ms"],
        "bound_ms_s1": s6["bound_ms"],
        "ms_s1_4096": s4k["ms"], "plain_ms_s1_4096": s4k["plain_ms"],
        "bound_ms_s1_4096": s4k["bound_ms"],
        "shape_s1": "S=1, 600x600, k=4 / S=1, 4096x4096, k=8 (the "
                    "single-shot entries)",
        "windows": windows,
        "library": "none: no single PyTorch call computes the k-step block",
    }
    step_entry = {
        "name": "wave_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/stencil/csrc/wave_step.cu",
        "replaces": "src/repro/kernels/stencil/kernel.py:157",
        "launches": calib["wave_step_launches"],
        "launches_600": calib["gamma"]["paper"]["wave_step_launches"],
        "launches_4096": calib["gamma"]["production"]["wave_step_launches"],
        "launches_scan": scan["wave_step_launches"],
        "max_abs_err": max(step_err, w6["max_abs_err"], w4k["max_abs_err"]),
        "ms": w6["ms"],
        "plain_ms": w6["plain_ms"],
        "bound_ms": w6["bound_ms"],
        "bound_by": w6["bound_by"],
        "library_ms": None,
        "shape": "S=4, 600x600 (the calibration sweep's paper height)",
        "ms_4096": w4k["ms"],
        "plain_ms_4096": w4k["plain_ms"],
        "bound_ms_4096": w4k["bound_ms"],
        "shape_4096": "S=4, 4096x4096",
        "sweep": step_sweep,
        "design": "streaming, no shared memory and no barrier: a thread "
                  "walks a strip of 4 (2 on narrow fields) rows of 4 "
                  "(2, 1) columns with p's five rows in registers and "
                  "one row of loads in flight; x neighbours by warp "
                  "shuffles; one shot a CTA, the shot the fastest block "
                  "index",
        "library": "none: no single PyTorch call computes the damped "
                   "leapfrog step with its 4th-order Laplacian",
    }
    print(smi, flush=True)
    emit({"kernels": [entry, step_entry, *lm_entries]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


#: the gamma sweeps' (S, NZ, NX) (``run_calibration``)
GAMMA_SHAPES = [(4, 4096, w) for w in (512, 1024, 2048, 4096)] \
    + [(4, 600, w) for w in (128, 192, 256, 384, 512, 600)]


def run_step_sweep(dev, step_args, bw, f32) -> list[dict]:
    """The step kernel at every gamma-sweep shape: bitwise against its
    plain version, then its device ms beside its bound and the launch
    the wrapper made (columns and rows a thread)."""
    from repro_torch.kernels.stencil import kernel, ref, tune

    out = []
    for ns, nz, nx in GAMMA_SHAPES:
        args = step_args(ns, nz, nx)
        got = kernel.wave_step_cuda(*args)
        launch = kernel.wave_step_cuda.last_launch
        want = ref.wave_step_ref(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"step sweep {nz}x{nx}: not bitwise "
              f"(max |diff| {max_diff(got, want)})")
        del got, want
        ms = tune.device_time_ms(lambda: kernel.wave_step_cuda(*args),
                                 reps=200 if nz == 600 else 20)
        bound, _ = bound_ms(kernel.step_bytes(ns, nz, nx),
                            kernel.step_flops(ns, nz, nx), bw, f32)
        check(math.isfinite(ms) and ms > 0, f"step sweep {nz}x{nx}: {ms}")
        out.append({"nz": nz, "nx": nx, "ms": ms, "bound_ms": bound,
                    "vec": launch["vec"], "rows": launch["rows"],
                    "bitwise": True})
        del args
    torch.cuda.empty_cache()
    return out


def bound_ms(nbytes, flops, bw, peak) -> tuple[float, str]:
    """Least time of one launch and what sets it: the larger of its
    bytes over the card's memory rate and its operations over the card's
    peak for their type."""
    by_bytes = nbytes / bw
    by_ops = flops / peak
    if by_ops > by_bytes:
        return by_ops * 1e3, "operations"
    return by_bytes * 1e3, "bytes"


class ScriptedPolicy:
    """GROW at one step, RETIRE at a later one; at ``snap_at`` the
    current session's state is published to a PreemptionGuard and saved
    as a SIGTERM handler would."""

    name = "scripted"

    def __init__(self, grow_at, retire_at, snap_at, sessions, guard):
        self.grow_at, self.retire_at = grow_at, retire_at
        self.snap_at, self.sessions, self.guard = snap_at, sessions, guard

    def decide(self, ctx):
        from repro_torch.core import ScaleAction

        if ctx.step == self.snap_at:
            self.guard.publish(self.sessions[-1], ctx.step)
            self.guard.save()
        if ctx.step == self.grow_at:
            return ScaleAction("grow", chips=64, slowdown=1.4)
        if ctx.step == self.retire_at:
            return ScaleAction("retire")
        return ScaleAction("hold")


def run_session(dev):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import (
        BurstPlanner,
        DeadlinePredictor,
        ElasticOrchestrator,
        LogCapacityModel,
        OverheadModel,
        PodSpec,
        Resources,
    )
    from repro_torch.fwi.driver import (
        FWISession,
        PreemptionGuard,
        TimeModel,
        elastic_stripes_for,
        fwi_session_factory,
        load_session_snapshot,
    )
    from repro_torch.fwi.solver import FWIConfig, run_forward
    from repro_torch.kernels.stencil.kernel import wave_block_shots_cuda

    cfg = FWIConfig()
    steps = cfg.timesteps
    legal = [16, 32, 64, 128]
    model = LogCapacityModel.fit(legal, [64.0 / c for c in legal])
    planner = BurstPlanner(
        cluster_model=model, cloud_model=model, chips_cluster=64,
        legal_slices=legal,
        overheads=OverheadModel(ckpt_s=5.0, provision_s=10.0,
                                restart_s=5.0))
    orch = ElasticOrchestrator(
        planner=planner, predictor=DeadlinePredictor(10_000.0),
        check_every=8, ckpt_every=96, cloud_slowdown=1.4)
    tm = TimeModel(chip_seconds_per_step=64.0, jitter=0.01)
    base = fwi_session_factory(cfg, tm, seed=SEED,
                               stripes_for=elastic_stripes_for(1, 2),
                               device=dev)
    sessions = []

    def factory(res, start_step, restored):
        s = base(res, start_step, restored)
        sessions.append(s)
        return s

    initial = Resources(pods=[PodSpec(64, name="cluster")], shares=[1.0])
    with tempfile.TemporaryDirectory() as tmp:
        guard = PreemptionGuard(CheckpointManager(tmp, async_save=False))
        policy = ScriptedPolicy(200, 400, 296, sessions, guard)
        wave_block_shots_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rec = orch.run(session_factory=factory, initial=initial,
                       steps_total=steps, autoscaler=policy)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = wave_block_shots_cuda.launches
        restored, snap_step = load_session_snapshot(guard.manager)

    kinds = [e.detail["kind"] for e in rec.events if e.kind == "scale"]
    check(rec.completed, "orchestrated run did not complete")
    check(kinds == ["grow", "retire"], f"scale events {kinds}")
    check(len(sessions) == 3, f"{len(sessions)} sessions, expected 3")
    stripes = [s.n_stripes for s in sessions]
    check(stripes == [1, 2, 1], f"sessions ran on {stripes} stripes, "
                                f"expected the GROW onto 2")
    blocks = sum(s.blocks for s in sessions)
    want = sum(s.launches for s in sessions)
    check(launches > 0 and launches == want,
          f"kernel launches {launches} != {want} for {blocks} blocks "
          f"on {stripes} stripes")
    last = sessions[-1]
    check(last.t == steps, f"session ended at t={last.t}, not {steps}")
    p = last.p.cpu()
    check(bool(torch.isfinite(p).all()), "non-finite wavefield")
    t0 = time.monotonic()
    ref, _ = run_forward(cfg, steps=last.t, k=last.k, device="cpu")
    cpu_s = time.monotonic() - t0
    scale = float(ref.p.abs().max())
    err = float((p - ref.p).abs().max())
    check(scale > 0 and torch.equal(p, ref.p),
          f"final field vs CPU plain run: not bitwise (max |diff| {err})")

    # the guard's snapshot, taken on 2 stripes, resumes on 1 to the same
    # final field
    check(snap_step == 296 and restored["res_sig"][0] == 2,
          f"snapshot at step {snap_step} on {restored['res_sig'][0]} "
          f"stripes")
    resumed = FWISession(cfg, initial, snap_step, restored,
                         time_model=tm, rng=np.random.default_rng(SEED),
                         device=dev)
    for step in range(snap_step, steps):
        resumed.run_step(step)
    check(resumed.t == last.t and torch.equal(resumed.p.cpu(), p),
          "run resumed from the PreemptionGuard snapshot diverged")

    # the engine alone: 600 steps through run_forward on the card
    run_forward(cfg, steps=8, k=last.k, device=dev)       # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    card, _ = run_forward(cfg, steps=steps, k=last.k, device=dev)
    torch.cuda.synchronize()
    engine_s = time.monotonic() - t0
    # the unscaled final fields, on the CPU and on the card, that
    # ``deadline_squeeze`` holds its run to
    refs = {"cpu": ref.p, "card": card.p.cpu(), "k": last.k}
    return launches, refs, {
        "phase": "session", "nz": cfg.nz, "nx": cfg.nx,
        "shots": cfg.n_shots, "steps": steps, "k": last.k,
        "scale_events": kinds, "sessions": len(sessions),
        "stripes": stripes, "grown_schedule": sessions[1].runner.schedule,
        "kernel_launches": launches, "blocks_dispatched": blocks,
        "final_max_abs_diff_vs_cpu": err, "final_max_abs_ref": scale,
        "bitwise_vs_cpu": bool(torch.equal(p, ref.p)),
        "snapshot_step": snap_step,
        "orchestrated_ms_per_step": wall / steps * 1e3,
        "engine_ms_per_step": engine_s / steps * 1e3,
        "cpu_plain_s": cpu_s,
    }


def run_production(dev, bw, f32):
    from repro_torch.fwi.solver import (
        FWIConfig,
        _block_amps,
        model_fields,
        run_forward,
    )
    from repro_torch.kernels.stencil import kernel, ref
    from repro_torch.kernels.stencil.ops import pick_k

    cfg = FWIConfig(nz=4096, nx=4096, n_shots=4, timesteps=200)
    k = pick_k(cfg.nz)
    blocks = -(-cfg.timesteps // k)
    run_forward(cfg, steps=k, k=k, device=dev)             # warm-up
    torch.cuda.synchronize()
    before = kernel.wave_block_shots_cuda.launches
    t0 = time.monotonic()
    st, traces = run_forward(cfg, k=k, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernel.wave_block_shots_cuda.launches - before
    check(launches == blocks, f"{launches} launches for {blocks} blocks")
    check(bool(torch.isfinite(st.p).all()) and bool(
        torch.isfinite(traces).all()), "non-finite production output")
    check(tuple(traces.shape) == (4, cfg.timesteps, cfg.nx),
          f"traces shape {tuple(traces.shape)}")
    mf = model_fields(cfg, dev)
    args = (st.p, st.p_prev, mf.v2dt2, mf.sponge,
            _block_amps(mf, st.t, k, cfg.timesteps), mf.src_z, mf.src_x)
    got = kernel.wave_block_shots_cuda(*args,
                                       receiver_row=cfg.receiver_depth)
    want = ref.wave_block_shots_ref(*args, receiver_row=cfg.receiver_depth)
    torch.cuda.synchronize()
    err = max_diff(got, want)
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    check(exact, f"production block vs plain: not bitwise ({err})")
    ms_block = wall / blocks * 1e3
    bound, _ = bound_ms(kernel.block_bytes(4, cfg.nz, cfg.nx, k),
                        kernel.block_flops(4, cfg.nz, cfg.nx, k), bw, f32)
    return {
        "phase": "production", "nz": cfg.nz, "nx": cfg.nx, "shots": 4,
        "steps": cfg.timesteps, "k": k, "blocks": blocks,
        "wavefield_bytes": 2 * st.p.numel() * 4,
        "ms_per_block": ms_block, "bound_ms_per_block": bound,
        "share_of_bound": bound / ms_block,
        "block_max_abs_diff_vs_plain": err,
        "block_bitwise_vs_plain": exact, "kernel_launches": launches,
        "max_abs_p": float(st.p.abs().max()),
    }


def _copy_split(prof: dict, steps: int) -> dict:
    """A profile's device ms per step: the block kernel's, the rest
    (the exchange's and the stitch's copies and fills), and their
    share."""
    if not prof["by_kernel_ms"]:                     # ``event_timed``'s
        return {"device_ms_per_step": prof["device_ms"] / steps,
                "kernel_ms_per_step": None, "copy_ms_per_step": None,
                "copy_share": None, "busy_share": None,
                "launches_per_step": None,
                "device_time_from": prof["device_time_from"]}
    kern = sum(v for key, v in prof["by_kernel_ms"].items()
               if "wave_block" in key)
    rest = prof["device_ms"] - kern
    return {"device_ms_per_step": prof["device_ms"] / steps,
            "kernel_ms_per_step": kern / steps,
            "copy_ms_per_step": rest / steps,
            "copy_share": rest / prof["device_ms"],
            "busy_share": prof["busy_share"],
            "launches_per_step": prof["kernels_per_call"]}


def run_striped_cfg(dev, cfg, k, stripes, schedules, prof_blocks):
    """The striped engine at ``cfg`` against the single-stripe block
    engine on the card: every (n, schedule) bitwise in p, p_prev and
    traces, with the block kernel's launches counted from 0 around the
    timed run (blocks × n × 1 for "fused", × 3 for the split
    schedules), host ms per step, and a profile of ``prof_blocks``
    blocks split into kernel and copy time.  Returns (launches, rows,
    single-stripe row)."""
    from repro_torch.fwi import domain
    from repro_torch.fwi.solver import ShotState, make_block_runner
    from repro_torch.kernels.stencil.kernel import wave_block_shots_cuda

    steps = cfg.timesteps
    st = ShotState.init(cfg, dev)
    one = make_block_runner(cfg, k=k, device=dev)
    one(st.p, st.p_prev, 0, 2 * k)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ref = one(st.p, st.p_prev, 0, steps)
    torch.cuda.synchronize()
    one_row = {"n": 1, "schedule": "block runner",
               "host_ms_per_step": (time.monotonic() - t0) / steps * 1e3,
               **_copy_split(profile_device(
                   lambda: one(st.p, st.p_prev, 0, prof_blocks * k),
                   prof_blocks * k), prof_blocks * k)}
    check(float(ref[0].abs().max()) > 0, "the reference field is zero")
    total, rows = 0, []
    for n in stripes:
        mesh = domain.stripe_mesh(n, dev)
        for schedule in schedules:
            run, place, kk = domain.make_sharded_scan_runner(
                cfg, mesh, k=k, overlap=schedule)
            check(kk == k, f"{n} stripes clamp k={k} to {kk}")
            blocks = steps // k
            p, pp = place((st.p, st.p_prev))
            run(p, pp, 0, 2)                             # warm-up
            torch.cuda.synchronize()
            wave_block_shots_cuda.launches = 0
            t0 = time.monotonic()
            out = run(p, pp, 0, blocks)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = wave_block_shots_cuda.launches
            per = 1 if schedule == "fused" else 3
            check(launches == blocks * n * per,
                  f"{n} stripes {schedule}: {launches} launches for "
                  f"{blocks} blocks")
            total += launches
            got = (run.gather(out[0]), run.gather(out[1]), out[2])
            same = [torch.equal(g, r) for g, r in zip(got, ref)]
            check(all(same), f"{n} stripes {schedule} vs one stripe: not "
                             f"bitwise {same} (max |diff| "
                             f"{max_diff(got, ref)})")
            del out, got
            prof = profile_device(lambda: run(p, pp, 0, prof_blocks),
                                  prof_blocks * k)
            rows.append({"n": n, "schedule": schedule, "launches": launches,
                         "bitwise": True,
                         "host_ms_per_step": wall / steps * 1e3,
                         **_copy_split(prof, prof_blocks * k)})
            del p, pp
    torch.cuda.empty_cache()
    return total, rows, one_row


def run_striped(dev):
    """The striped domain at the paper's size, 600 steps, k = 4: 2 and 4
    stripes under each schedule, all on the one card."""
    from repro_torch.fwi.domain import SCHEDULES, pick_schedule
    from repro_torch.fwi.solver import FWIConfig

    cfg = FWIConfig()
    launches, rows, one = run_striped_cfg(dev, cfg, 4, (2, 4), SCHEDULES,
                                          25)
    fastest = {n: min((r for r in rows if r["n"] == n),
                      key=lambda r: r["host_ms_per_step"])["schedule"]
               for n in (2, 4)}
    return launches, {
        "phase": "striped", "nz": cfg.nz, "nx": cfg.nx,
        "shots": cfg.n_shots, "steps": cfg.timesteps, "k": 4,
        "contract": "bitwise vs the single-stripe block runner",
        "single_stripe": one, "runs": rows,
        "fastest_host_schedule": fastest,
        "pick_schedule": pick_schedule(dev),
    }


def run_striped_production(dev):
    """The striped domain at 4096², 200 steps, k = 8: 4 stripes,
    "fused" and "pipeline", bitwise against the production run."""
    from repro_torch.fwi.solver import FWIConfig

    cfg = FWIConfig(nz=4096, nx=4096, n_shots=4, timesteps=200)
    launches, rows, one = run_striped_cfg(dev, cfg, 8, (4,),
                                          ("fused", "pipeline"), 5)
    return launches, {
        "phase": "striped_production", "nz": cfg.nz, "nx": cfg.nx,
        "shots": cfg.n_shots, "steps": cfg.timesteps, "k": 8,
        "contract": "bitwise vs the single-stripe block runner",
        "single_stripe": one, "runs": rows,
    }


def run_shot_split(dev):
    """4 shots over 3 shards (padded with a copy of shot 0) at the
    paper's size, all shards on the card: bitwise against the block
    runner, 150 blocks × 3 shards launches."""
    from repro_torch.fwi.solver import (
        FWIConfig,
        ShotState,
        make_block_runner,
        make_shot_parallel_runner,
    )
    from repro_torch.kernels.stencil.kernel import wave_block_shots_cuda

    cfg = FWIConfig()
    k, shards, steps = 4, 3, cfg.timesteps
    st = ShotState.init(cfg, dev)
    ref = make_block_runner(cfg, k=k, device=dev)(st.p, st.p_prev, 0, steps)
    run, place = make_shot_parallel_runner(cfg, shards, k=k, devices=dev)
    p, pp = place((st.p, st.p_prev))
    check(p.shape[0] == 6, f"padded batch {tuple(p.shape)}")
    run(p, pp, 0, 2 * k)                                 # warm-up
    torch.cuda.synchronize()
    wave_block_shots_cuda.launches = 0
    t0 = time.monotonic()
    out = run(p, pp, 0, steps)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = wave_block_shots_cuda.launches
    check(launches == steps // k * shards,
          f"shot split: {launches} launches for {steps // k} blocks")
    same = [torch.equal(g, r) for g, r in zip(out, ref)]
    check(all(same) and out[0].shape[0] == 4,
          f"shot split vs block runner: not bitwise {same}")
    return launches, {
        "phase": "shot_split", "nz": cfg.nz, "nx": cfg.nx, "shots": 4,
        "shards": shards, "padded_shots": 6, "steps": steps, "k": k,
        "launches": launches, "bitwise": True,
        "host_ms_per_step": wall / steps * 1e3,
    }


def run_seam(dev):
    """The seam probe on the card at 600² (k = 4) and 4096² (k = 8),
    2 and 4 stripes."""
    from repro_torch.fwi.calibrate import measure_seam_latency
    from repro_torch.fwi.solver import FWIConfig

    rows = []
    for cfg, k in ((FWIConfig(), 4),
                   (FWIConfig(nz=4096, nx=4096, timesteps=200), 8)):
        for n in (2, 4):
            r = measure_seam_latency(cfg, n_stripes=n, k=k, iters=30,
                                     blocks=8, device=dev)
            check(r["backend"] == "cuda" and r["ppermute_latency_s"] > 0
                  and r["interior_compute_s_per_step"] > 0,
                  f"seam probe {cfg.nx}² n={n}: {r}")
            rows.append({"nz": cfg.nz, "nx": cfg.nx, **r})
    return {"phase": "seam", "probes": rows}


#: the deadline squeeze at the paper's size: the schedule of the JAX
#: package's end-to-end test (``tests/test_real_elastic.py``: 120 steps,
#: 1 s a step on 64 chips) with every time and step count x5
SQUEEZE = dict(
    legal=[16, 32, 64, 128], chips=64, chip_s_per_step=64.0, slowdown=1.4,
    ckpt_s=25.0, provision_s=50.0, restart_s=25.0, deadline_s=2000.0,
    deadline_changes=[(100.0, 525.0), (300.0, 2000.0)], eval_interval_s=35.0,
    ckpt_every=200, check_every=40,
)


class TimedPolicy:
    """Wraps a policy and adds up the host time of its ``decide``."""

    def __init__(self, policy):
        self.policy, self.name = policy, policy.name
        self.calls, self.seconds = 0, 0.0

    def decide(self, ctx):
        t0 = time.perf_counter()
        action = self.policy.decide(ctx)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return action


def squeeze_orchestrator(cfg, dev):
    """``SQUEEZE``'s orchestrator, initial resources and session factory
    for ``cfg`` on ``dev`` (sessions on ``elastic_stripes_for(1, 2)``)."""
    from repro_torch.core import (
        BurstPlanner,
        DeadlinePredictor,
        ElasticOrchestrator,
        LogCapacityModel,
        OverheadModel,
        PodSpec,
        Resources,
    )
    from repro_torch.fwi.driver import (
        TimeModel,
        elastic_stripes_for,
        fwi_session_factory,
    )

    q = SQUEEZE
    w, k_cloud, legal = q["chip_s_per_step"], q["slowdown"], q["legal"]
    cs = sorted(set(legal) | {q["chips"]})
    planner = BurstPlanner(
        cluster_model=LogCapacityModel.fit(cs, [w / c for c in cs]),
        cloud_model=LogCapacityModel.fit(cs, [k_cloud * w / c for c in cs]),
        chips_cluster=q["chips"], legal_slices=legal,
        overheads=OverheadModel(ckpt_s=q["ckpt_s"],
                                provision_s=q["provision_s"],
                                restart_s=q["restart_s"]),
        price_per_chip_hour=3.0, cost_weight=0.5)
    orch = ElasticOrchestrator(
        planner=planner, predictor=DeadlinePredictor(q["deadline_s"]),
        check_every=q["check_every"], ckpt_every=q["ckpt_every"],
        eval_interval_s=q["eval_interval_s"], cloud_slowdown=k_cloud)
    initial = Resources(pods=[PodSpec(q["chips"], name="cluster")],
                        shares=[1.0])
    base = fwi_session_factory(
        cfg, TimeModel(chip_seconds_per_step=w, jitter=0.01), seed=SEED,
        stripes_for=elastic_stripes_for(1, 2), device=dev)
    return orch, initial, base


def scale_events(rec) -> list[tuple[str, int, int]]:
    return [(e.detail["kind"], e.step, e.detail["cloud_chips"])
            for e in rec.events if e.kind == "scale"]


def run_deadline_squeeze(dev, refs, engine_ms_per_step):
    """The paper's decision loop on the card: ``PlanAutoscaler`` sizes a
    burst when the deadline is squeezed mid-run and retires it when the
    deadline relaxes, each resize a checkpoint, a new session on the
    stripes ``elastic_stripes_for(1, 2)`` gives it and a restore.  Host
    time goes to the policy's ``decide``, the sessions' checkpoints and
    restores and their blocks, each timed by a wrapper here.  A step's
    time comes from the platform model, so the decisions must equal
    those of the same schedule on the CPU at a cut grid."""
    from repro_torch.core import elastic_chips
    from repro_torch.fwi.solver import FWIConfig
    from repro_torch.kernels.stencil.kernel import wave_block_shots_cuda
    from repro_torch.sim import PlanAutoscaler

    q = SQUEEZE
    cfg = FWIConfig()
    steps = cfg.timesteps
    orch, initial, base = squeeze_orchestrator(cfg, dev)
    sessions, host = [], {"restore_s": 0.0, "first_session_s": 0.0,
                          "checkpoint_s": 0.0, "checkpoints": 0,
                          "blocks_s": 0.0}

    def timed(fn, key, count=None):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[key] += time.perf_counter() - t0
            if count:
                host[count] += 1
            return out
        return call

    def factory(res, start_step, restored):
        t0 = time.perf_counter()
        s = base(res, start_step, restored)
        host["restore_s" if restored is not None
             else "first_session_s"] += time.perf_counter() - t0
        s.checkpoint = timed(s.checkpoint, "checkpoint_s", "checkpoints")
        s._advance_block = timed(s._advance_block, "blocks_s")
        sessions.append(s)
        return s

    policy = TimedPolicy(PlanAutoscaler())
    wave_block_shots_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = orch.run(session_factory=factory, initial=initial,
                   steps_total=steps, autoscaler=policy,
                   deadline_changes=q["deadline_changes"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wave_block_shots_cuda.launches

    # the same schedule on the CPU, one shot of 48 x 96
    small = FWIConfig(nz=48, nx=96, timesteps=steps, n_shots=1,
                      sponge_width=8)
    corch, cinit, cbase = squeeze_orchestrator(small, "cpu")
    cpu_rec = corch.run(session_factory=cbase, initial=cinit,
                        steps_total=steps, autoscaler=PlanAutoscaler(),
                        deadline_changes=q["deadline_changes"])
    scale = scale_events(rec)
    check(scale == scale_events(cpu_rec)
          and rec.elapsed_s == cpu_rec.elapsed_s,
          f"decisions on the card {scale}, {rec.elapsed_s} s differ from "
          f"the CPU's {scale_events(cpu_rec)}, {cpu_rec.elapsed_s} s")
    kinds = [kind for kind, _, _ in scale]
    stripes = [s.n_stripes for s in sessions]
    check(rec.completed, "the plan-driven run did not complete")
    check("grow" in kinds and ("retire" in kinds or "shrink" in kinds),
          f"plan did not grow and retire under the squeeze: {scale}")
    check(rec.met_deadline,
          f"deadline missed: {rec.elapsed_s} s against {rec.deadline_s}")
    check(elastic_chips(rec.final_resources) == 0,
          "the cloud pod was not retired")
    check(stripes[0] == 1 and max(stripes) == 2 and stripes[-1] == 1,
          f"sessions ran on {stripes} stripes, expected 1, then 2, then 1")
    blocks = sum(s.blocks for s in sessions)
    want = sum(s.launches for s in sessions)
    check(launches > 0 and launches == want,
          f"kernel launches {launches} != {want} for {blocks} blocks on "
          f"{stripes} stripes")
    last = sessions[-1]
    check(last.t == steps and last.k == refs["k"],
          f"session ended at t={last.t}, k={last.k}")
    p = last.p.cpu()
    check(bool(torch.isfinite(p).all()), "non-finite wavefield")
    err = float((p - refs["cpu"]).abs().max())
    check(torch.equal(p, refs["card"]),
          "final field vs the card's unscaled run_forward: not bitwise "
          f"(max |diff| {float((p - refs['card']).abs().max())})")
    check(torch.equal(p, refs["cpu"]),
          f"final field vs the CPU plain run: not bitwise ({err})")
    orch_ms = wall / steps * 1e3
    other_s = wall - sum(host[key] for key in (
        "restore_s", "first_session_s", "checkpoint_s", "blocks_s")) \
        - policy.seconds
    return launches, {
        "phase": "deadline_squeeze", "nz": cfg.nz, "nx": cfg.nx,
        "shots": cfg.n_shots, "steps": steps, "k": last.k,
        "schedule": {key: q[key] for key in (
            "chip_s_per_step", "chips", "slowdown", "ckpt_s",
            "provision_s", "restart_s", "deadline_s", "deadline_changes",
            "eval_interval_s", "ckpt_every")},
        "scale_events": [{"kind": kd, "step": st, "cloud_chips": ch}
                         for kd, st, ch in scale],
        "met_deadline": rec.met_deadline, "elapsed_s": rec.elapsed_s,
        "deadline_s": rec.deadline_s, "cloud_chip_s": rec.cloud_chip_s,
        "stripes": stripes,
        "sessions": [{"stripes": s.n_stripes, "blocks": s.blocks,
                      "launches": s.launches} for s in sessions],
        "kernel_launches": launches, "blocks_dispatched": blocks,
        "decisions_equal_cpu_48x96": True,
        "bitwise_vs_card_unscaled": True, "bitwise_vs_cpu": True,
        "final_max_abs_diff_vs_cpu": err,
        "orchestrated_ms_per_step": orch_ms,
        "engine_ms_per_step": engine_ms_per_step,
        "host_ms": {
            "decide": policy.seconds * 1e3, "decide_calls": policy.calls,
            "checkpoint": host["checkpoint_s"] * 1e3,
            "checkpoints": host["checkpoints"],
            "restore": host["restore_s"] * 1e3,
            "first_session": host["first_session_s"] * 1e3,
            "blocks": host["blocks_s"] * 1e3,
            "other": other_s * 1e3, "wall": wall * 1e3,
        },
    }


def run_fleet():
    """The fleet simulator over every default and queued scenario under
    every per-job policy, with the card's probe in ``OVERHEADS`` (the
    scenarios' default), and the fleet demo's claims."""
    from repro_torch.sim import POLICY_FACTORIES, FleetSim
    from repro_torch.sim.scenarios import (
        OVERHEADS,
        default_scenarios,
        queued_scenarios,
    )

    t0 = time.perf_counter()
    cells, recs = [], {}
    for sc in (*default_scenarios(0), *queued_scenarios(0)):
        check(sc.overheads == OVERHEADS, f"{sc.name}: not the card's probe")
        for pname, pf in POLICY_FACTORIES.items():
            rec = FleetSim(sc, pf, seed=0).run()
            recs[sc.name, pname] = rec
            check(math.isfinite(rec.cloud_cost) and 0 <= rec.hit_rate <= 1,
                  f"{sc.name}/{pname}: {rec.hit_rate}, {rec.cloud_cost}")
            cells.append({"scenario": sc.name, "policy": pname,
                          "hit_rate": rec.hit_rate,
                          "cloud_usd": rec.cloud_cost,
                          "makespan_s": rec.makespan_s})
    host_s = time.perf_counter() - t0
    plan, nb, ab = (recs["overload_ramp", x]
                    for x in ("plan", "no-burst", "always-burst"))
    check(plan.hit_rate > nb.hit_rate,
          f"overload_ramp: plan {plan.hit_rate} <= no-burst {nb.hit_rate}")
    check(plan.cloud_cost < ab.cloud_cost,
          f"overload_ramp: plan ${plan.cloud_cost} >= always-burst "
          f"${ab.cloud_cost}")
    spike = recs["transient_spike", "plan"].cloud_timeline
    check(spike[-1][1] == 0, "transient_spike: the cloud pod was not "
                             "retired once the spike cleared")
    return {"phase": "fleet", "cells": cells, "host_s": host_s,
            "seam_latency_s": OVERHEADS.seam_latency_s,
            "seam_s_per_step": OVERHEADS.seam_s_per_step()}


def time_block_runs(runs, steps: int, reps: int = 4) -> float:
    """Best of ``reps`` host-clock runs of ``steps`` steps, each run
    calling every ``(runner, p, p_prev)`` of ``runs`` once per k-step
    block, to the card's end; seconds per step."""
    k = runs[0][0].k
    best = math.inf
    for _ in range(reps + 1):                   # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(0, steps, k):
            for run, p, pp in runs:
                run(p, pp, t, k)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / steps


def run_shot_batch_probe(dev, smi, seam_rows):
    """The planner's two probes as the card gives them, in the form of
    the literals in ``repro_torch/sim/scenarios.py``: the seam probe at
    600², 2 stripes, k = 4 (from phase ``seam``) and the block engine's
    seconds per step at 600², k = 8, for S = 1, 2, 4 shots a launch and
    for four S = 1 launches a block."""
    from repro_torch.fwi.solver import FWIConfig, ShotState, \
        make_block_runner
    from repro_torch.kernels.stencil.kernel import BLOCK_TILE

    seam = next(dict(r) for r in seam_rows
                if r["nx"] == 600 and r["n_stripes"] == 2)
    del seam["nz"], seam["nx"]
    k, steps = 8, FWIConfig().timesteps

    def runner(ns):
        cfg = FWIConfig(n_shots=ns)
        st = ShotState.init(cfg, dev)
        run = make_block_runner(cfg, k=k, collect_traces=False, device=dev)
        return run, st.p, st.p_prev

    s_values = (1, 2, 4)
    t_step = tuple(time_block_runs([runner(ns)], steps) for ns in s_values)
    t_vmapped = time_block_runs([runner(1) for _ in range(4)], steps)
    for t in (*t_step, t_vmapped):
        check(math.isfinite(t) and t > 0, f"shot-batch probe: {t}")
    batch = {
        "config": {"nz": 600, "nx": 600, "k": k, "bz": BLOCK_TILE[0],
                   "engine": "wave_block_shots_cuda", "backend": "cuda"},
        "s_values": s_values,
        "t_step_s": t_step,
        "t_step_vmapped_s4": t_vmapped,
        "batched_vs_vmapped": t_vmapped / t_step[-1],
    }
    return {"phase": "shot_batch_probe", "card": smi,
            "SEAM_PROBE": seam, "SHOT_BATCH_PROBE": batch}


def window_timings(dev, rng, bw, f32) -> list[dict]:
    """The block kernel at each ``WINDOW_CASES`` shape: bitwise against
    its plain version, then device ms beside its bound and the plain
    version's ms."""
    from repro_torch.kernels.stencil import kernel, ops, ref, tune

    out = []
    for label, (ns, nz, nx, k), src in WINDOW_CASES:
        args = block_inputs(rng, dev, ns, nz, nx, k, src=src, zero=(0, 1))
        err, exact = compare_block(ops, ref, args, 2)
        check(exact, f"{label}: not bitwise ({err})")
        small = nz == 600
        ms = tune.device_time_ms(lambda: kernel.wave_block_shots_cuda(
            *args, receiver_row=2), reps=100 if small else 20)
        plain_ms = tune.device_time_ms(lambda: ref.wave_block_shots_ref(
            *args, receiver_row=2), reps=5 if small else 2)
        bound, by = bound_ms(kernel.block_bytes(ns, nz, nx, k),
                             kernel.block_flops(ns, nz, nx, k), bw, f32)
        out.append({"window": label, "S": ns, "nz": nz, "nx": nx, "k": k,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "max_abs_err": err})
        del args
    torch.cuda.empty_cache()
    return out


def run_scan_vs_block(dev):
    """All 600 steps at the paper's size through the step engine and
    the block engine: one answer, bitwise, traces included."""
    from repro_torch.fwi.solver import (
        FWIConfig,
        ShotState,
        make_block_runner,
        make_scan_runner,
    )
    from repro_torch.kernels.stencil.kernel import (
        wave_block_shots_cuda,
        wave_step_cuda,
    )

    cfg = FWIConfig()
    steps, k = cfg.timesteps, 4
    st = ShotState.init(cfg, dev)
    scan = make_scan_runner(cfg, collect_traces=True, device=dev)
    bare = make_scan_runner(cfg, device=dev)     # as the gamma sweep runs
    block = make_block_runner(cfg, k=k, device=dev)

    def timed(run):
        """(output, seconds, (step launches, block launches)) of one
        run of all the steps, after a warm-up."""
        run(st.p, st.p_prev, 0, 8)
        torch.cuda.synchronize()
        wave_step_cuda.launches = 0
        wave_block_shots_cuda.launches = 0
        t0 = time.monotonic()
        out = run(st.p, st.p_prev, 0, steps)
        torch.cuda.synchronize()
        return out, time.monotonic() - t0, (
            wave_step_cuda.launches, wave_block_shots_cuda.launches)

    a, scan_s, (step_launches, _) = timed(scan)
    b, block_s, (_, block_launches) = timed(block)
    _, bare_s, _ = timed(bare)
    check(step_launches == steps,
          f"{step_launches} step-kernel launches for {steps} steps")
    check(block_launches == steps // k,
          f"{block_launches} block-kernel launches for {steps // k} blocks")
    check(tuple(a[2].shape) == (cfg.n_shots, steps, cfg.nx),
          f"traces shape {tuple(a[2].shape)}")
    check(all(bool(torch.isfinite(x).all()) for x in a),
          "non-finite scan-runner output")
    check(float(a[0].abs().max()) > 0, "the scan runner's field is zero")
    same = [torch.equal(x, y) for x, y in zip(a, b)]
    check(all(same), f"scan runner vs block runner not bitwise: {same}")
    busy = profile_device(lambda: bare(st.p, st.p_prev, 0, 100), 100)
    busy_block = profile_device(lambda: block(st.p, st.p_prev, 0, 100),
                                100 // k)
    idx_s = time_index_put_scan(cfg, dev, steps, b[:2])
    return {
        "phase": "scan_vs_block", "nz": cfg.nz, "nx": cfg.nx,
        "shots": cfg.n_shots, "steps": steps, "block_k": k,
        "wave_step_launches": step_launches,
        "wave_block_launches": block_launches,
        "bitwise_p_pprev_traces": same,
        "scan_ms_per_step": scan_s / steps * 1e3,
        "scan_no_traces_ms_per_step": bare_s / steps * 1e3,
        "block_ms_per_step": block_s / steps * 1e3,
        "scan_profile_100_steps": busy,
        "block_profile_25_blocks": busy_block,
        "scan_index_put_ms_per_step": idx_s / steps * 1e3,
        "max_abs_p": float(a[0].abs().max()),
    }


#: the profiler ranges of the LM kernels' plain backward
#: (``kernels/autograd.py``): their device ms are the kernels' inside them
PLAIN_BACKWARD = "_plain_backward"
#: profiler ranges the smoke itself opens (``LayerNormRanges``)
SMOKE_RANGES = ("layernorm",)


#: traces ``profile_device`` takes before it times the call with CUDA
#: events instead: on the card's machine a ``torch.profiler`` trace of a
#: few milliseconds has now and then held no device activity at all
PROFILE_TRIES = 3


def event_timed(fn) -> dict:
    """``profile_device``'s fallback: wall ms and the device ms from a
    CUDA event before the first launch of one call of ``fn`` to one
    after its last (idle gaps included, so no busy share), with no
    split by kernel or range."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    device_ms = start.elapsed_time(end)
    check(device_ms > 0, "neither the profiler nor CUDA events saw "
                         "device time")
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": None, "kernels_per_call": None,
            "by_kernel_ms": {}, "profiler_tries": PROFILE_TRIES,
            "device_time_from": "cuda events (first to last launch): "
                                "the profiler saw no device activity"}


def profile_device(fn, calls: int) -> dict:
    """``torch.profiler`` over one synchronised call of ``fn`` (warmed
    up first): wall ms, the kernels' device ms and launches per call
    (``calls`` steps or blocks), the device's busy share, and the device
    ms inside each ``*_plain_backward`` range and each MoE range
    (``models/moe.py::MOE_RANGES``).  After ``PROFILE_TRIES`` traces
    with no device activity, ``event_timed``'s CUDA-event span instead."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.moe import MOE_RANGES

    def is_range(key):
        return key.endswith(PLAIN_BACKWARD) or key in MOE_RANGES \
            or key in SMOKE_RANGES

    fn()
    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        events = prof.key_averages()
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not is_range(e.key)]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if device_ms > 0:
            break
    else:
        return event_timed(fn)
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.device_type == torch.autograd.DeviceType.CPU
              and is_range(e.key)}
    # names cut to 48 characters: kernels that share a prefix are summed
    by_kernel: dict = {}
    for e in kernels:
        key = e.key[:48]
        by_kernel[key] = by_kernel.get(key, 0.0) \
            + e.self_device_time_total / 1e3
    out = {"wall_ms": wall * 1e3, "device_ms": device_ms,
           "busy_share": device_ms / (wall * 1e3),
           "kernels_per_call": sum(e.count for e in kernels) / calls,
           "by_kernel_ms": by_kernel, "profiler_tries": tries}
    backward = {k: v for k, v in ranges.items() if k.endswith(PLAIN_BACKWARD)}
    if backward:
        out["plain_backward_ms"] = backward
    moe = {k: v / calls for k, v in ranges.items() if k in MOE_RANGES}
    if moe:
        out["moe_ms_per_call"] = moe
    own = {k: v / calls for k, v in ranges.items() if k in SMOKE_RANGES}
    if own:
        out["ranges_ms_per_call"] = own
    return out


def time_index_put_scan(cfg, dev, steps, want) -> float:
    """Seconds for ``steps`` scan steps with the source added by an
    accumulating ``index_put_`` (the form the solver avoids); the
    result must equal the engine's bitwise."""
    from repro_torch.fwi.solver import model_fields
    from repro_torch.kernels.stencil.ops import wave_step

    mf = model_fields(cfg, dev)
    idx = (torch.arange(cfg.n_shots, device=dev), mf.src_z.long(),
           mf.src_x.long())

    def run(n):
        p = torch.zeros((cfg.n_shots, cfg.nz, cfg.nx), device=dev)
        pp = torch.zeros_like(p)
        for t in range(n):
            p, pp = wave_step(p, pp, mf.v2dt2, mf.sponge)
            p.index_put_(idx, mf.amps[min(t, cfg.timesteps - 1)].expand(
                cfg.n_shots), accumulate=True)
        return p, pp

    run(8)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = run(steps)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    check(all(torch.equal(x, y) for x, y in zip(out, want)),
          "index_put_ injection differs from the engine")
    return secs


def run_calibration(dev):
    """The paper's pre-processing phase (§3.2) on the card: t(γ) at two
    heights, then fitted capacity models drive a congested adaptive
    run that must burst."""
    from repro_torch.core import (
        BurstPlanner,
        DeadlinePredictor,
        ElasticOrchestrator,
        GammaModel,
        OverheadModel,
        PodSpec,
        Resources,
    )
    from repro_torch.fwi.calibrate import (
        fit_capacity_models,
        measure_gamma_sweep,
    )
    from repro_torch.fwi.driver import TimeModel, fwi_session_factory
    from repro_torch.fwi.solver import FWIConfig
    from repro_torch.kernels.stencil.kernel import (
        wave_block_shots_cuda,
        wave_step_cuda,
    )

    heights, expected = {}, 0
    wave_step_cuda.launches = 0
    wave_block_shots_cuda.launches = 0
    for label, base, widths, steps in (
        ("paper", FWIConfig(), [128, 192, 256, 384, 512, 600], 30),
        ("production", FWIConfig(nz=4096, nx=4096, n_shots=4),
         [512, 1024, 2048, 4096], 20),
    ):
        # fit_gamma_model's two steps, kept apart so the samples print
        before = wave_step_cuda.launches
        g, t = measure_gamma_sweep(base, widths, steps=steps, device=dev)
        launches = wave_step_cuda.launches - before
        model = GammaModel.fit(g, t, name="fwi-width")
        check(all(math.isfinite(x) and x > 0 for x in t),
              f"gamma sweep at {label} height: times {t}")
        if label == "production":
            check(model.a > 0, f"t(gamma) does not grow with width at "
                               f"nz={base.nz}: a = {model.a}")
        want = len(widths) * 3 * steps            # warm-up + 2 repeats
        check(launches == want, f"gamma sweep at {label} height: "
                                f"{launches} step launches, not {want}")
        expected += want
        heights[label] = {"nz": base.nz, "shots": base.n_shots,
                          "steps": steps, "widths": g, "s_per_step": t,
                          "a": model.a, "b": model.b,
                          "r2": model.r2(g, t),
                          "wave_step_launches": launches}
    step_launches = wave_step_cuda.launches
    check(step_launches == expected,
          f"gamma sweep: {step_launches} step launches, not {expected}")
    check(wave_block_shots_cuda.launches == 0,
          "the gamma sweep ran the block kernel")

    # the calibrated adaptive run (tests/test_system.py, at full width)
    cfg = FWIConfig()
    wave_block_shots_cuda.launches = 0
    t0 = time.monotonic()
    cluster, cloud, samples = fit_capacity_models(
        cfg, cloud_slowdown=1.4, chip_counts=(8, 16, 32, 64, 128),
        device=dev)
    r2 = cluster.r2(samples["chips"], samples["t_cluster"])
    check(r2 > 0.99, f"capacity fit r2 {r2}")
    work = samples["t1_measured"]
    check(math.isfinite(work) and work > 0, f"measured step {work}")
    tm = TimeModel(chip_seconds_per_step=work, congestion_from=30,
                   congestion_factor=2.0, jitter=0.01)
    deadline = work / 64 * cfg.timesteps * 1.35
    planner = BurstPlanner(
        cluster_model=cluster, cloud_model=cloud, chips_cluster=64,
        legal_slices=[8, 16, 32, 64, 128],
        overheads=OverheadModel(ckpt_s=work / 64 * 2,
                                provision_s=work / 64 * 6,
                                restart_s=work / 64 * 2),
    )
    orch = ElasticOrchestrator(
        planner=planner, predictor=DeadlinePredictor(deadline),
        check_every=6, ckpt_every=40,
    )
    rec = orch.run(
        session_factory=fwi_session_factory(cfg, tm, seed=SEED, device=dev),
        initial=Resources(pods=[PodSpec(chips=64, name="cluster")],
                          shares=[1.0]),
        steps_total=cfg.timesteps,
    )
    torch.cuda.synchronize()
    adaptive_s = time.monotonic() - t0
    block_launches = wave_block_shots_cuda.launches
    bursts = [e for e in rec.events if e.kind == "burst"]
    check(rec.completed, "calibrated adaptive run did not complete")
    check(bursts, "calibrated adaptive run never burst")
    check(block_launches > 0, "the adaptive run launched no block kernel")
    return {
        "phase": "calibration", "gamma": heights,
        "wave_step_launches": step_launches,
        "capacity": {"t1_measured_s": work, "cluster_A": cluster.A,
                     "cluster_B": cluster.B, "cloud_A": cloud.A,
                     "cloud_B": cloud.B, "cluster_r2": r2},
        "adaptive": {"steps": cfg.timesteps, "deadline_s": deadline,
                     "met_deadline": bool(rec.met_deadline),
                     "bursts": len(bursts),
                     "events": [e.kind for e in rec.events],
                     "wall_s": adaptive_s},
        "wave_block_launches": block_launches,
    }


def run_autotune(dev, step_args, block_inputs):
    """Both tile sweeps at 600² and 4096² (S=4); every candidate held
    bitwise to the plain version at 600²; a short tuned session."""
    from repro_torch.core import PodSpec, Resources
    from repro_torch.fwi.driver import FWISession, TimeModel
    from repro_torch.fwi.solver import FWIConfig, run_forward
    from repro_torch.kernels.stencil import kernel, ref, tune

    default = tuple(kernel.BLOCK_TILE)
    step_default = (kernel.TILE_Z, kernel.TILE_X)
    out = {"phase": "autotune", "default_tile": list(default),
           "step_default_tile": list(step_default)}
    for label, n, kdef in (("600", 600, 4), ("4096", 4096, 8)):
        t0 = time.monotonic()
        blk = tune.sweep_block(n, n, 4, device=dev)
        bt, bk = tune.autotune_block(n, n, 4, device=dev)
        stp = tune.sweep_step_tile(n, n, 4, device=dev)
        st = tune.autotune_step_tile(n, n, 4, device=dev)
        sweep_s = time.monotonic() - t0
        check(all(math.isfinite(v) and v > 0
                  for v in [*blk.values(), *stp.values()]),
              f"non-positive sweep time at {label}")
        out[label] = {
            "shots": 4, "sweep_s": sweep_s,
            "block_candidates": len(blk),
            "block_winner": {"tile": list(bt), "k": bk,
                             "ms_per_step": blk[(bt, bk)]},
            "block_default": {"tile": list(default), "k": kdef,
                              "ms_per_step": blk[(default, kdef)]},
            "step_candidates": len(stp),
            "step_winner": {"tile": list(st), "ms": stp[st]},
            "step_default": {"tile": list(step_default),
                             "ms": stp[step_default]},
        }

    args = step_args(4, 600, 600)
    want = ref.wave_step_ref(*args)
    for t in tune.step_candidates():
        got = kernel.wave_step_cuda(*args, tile=t)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"step kernel at tile {t} is not bitwise")
    bargs = block_inputs(4, 600, 600, 8,
                         src=([32, 31, 0, 599], [64, 0, 599, 33]))
    for t, k in tune.block_candidates():
        a = bargs[:4] + [bargs[4][:, :k].contiguous()] + bargs[5:]
        got = kernel.wave_block_shots_cuda(*a, receiver_row=32, tile=t)
        want = ref.wave_block_shots_ref(*a, receiver_row=32)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"block kernel at tile {t}, k={k} is not bitwise")
    torch.cuda.synchronize()
    out["bitwise_600"] = {"step_tiles": len(tune.step_candidates()),
                          "block_pairs": len(tune.block_candidates())}

    cfg = FWIConfig()
    res = Resources(pods=[PodSpec(1, name="cluster")], shares=[1.0])
    sess = FWISession(cfg, res, 0, None, time_model=TimeModel(jitter=0.0),
                      rng=np.random.default_rng(SEED), autotune=True,
                      device=dev)
    tile, k = tune.autotune_block(cfg.nz, cfg.nx, cfg.n_shots, device=dev)
    check(sess.tile == tile and sess.k == max(1, min(k, cfg.nx // 4)),
          f"session runs tile {sess.tile}, k={sess.k}; tuned {tile}, k={k}")
    kernel.wave_block_shots_cuda.launches = 0
    for step in range(64):
        sess.run_step(step)
    torch.cuda.synchronize()
    launches = kernel.wave_block_shots_cuda.launches
    check(launches == sess.blocks and launches > 0,
          f"tuned session: {launches} launches, {sess.blocks} blocks")
    want, _ = run_forward(cfg, steps=sess.t, k=sess.k, device="cpu")
    scale = float(want.p.abs().max())
    err = float((sess.p.cpu() - want.p).abs().max())
    check(scale > 0 and err <= TOL * scale,
          f"tuned session vs CPU plain run: {err} > {TOL} * {scale}")
    out["session"] = {"tile": list(sess.tile), "k": sess.k, "t": sess.t,
                      "launches": launches, "max_abs_diff_vs_cpu": err,
                      "bitwise_vs_cpu": bool(torch.equal(sess.p.cpu(),
                                                         want.p))}
    return out


def _close(got, want, atol, rtol=0.0) -> tuple[float, bool]:
    """(max |got - want| over the pairs, every element within
    atol + rtol·|want|)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= atol + rtol * w.float().abs()).all())
    return err, ok


#: rmsnorm_vs_plain's cases: (label, (N, d), a scale near one, elements
#: x lies off 16-byte alignment)
RMS_CASES = [
    ("test_kernels 512x256", (512, 256), False, 0),
    ("test_kernels 64x640", (64, 640), False, 0),
    ("test_kernels 256x1024", (256, 1024), False, 0),
    ("Yi-6B prefill rows", (2048, 4096), True, 0),
    ("Yi-6B decode rows", (4, 4096), True, 0),
    ("ragged rows", (37, 4096), True, 0),
    ("Jamba-v0.1 prefill rows", RMS_ROWS_JAMBA, True, 0),
    ("DeepSeek-V2 prefill rows", RMS_ROWS_DEEPSEEK[0], True, 0),
    ("DeepSeek-V3 prefill rows", RMS_ROWS_DEEPSEEK[1], True, 0),
    ("mamba2-370m prefill rows", (8192, 1024), True, 0),
    ("qwen2-vl prefill rows", (8192, 8192), True, 0),
    ("mamba2-370m decode rows", (4, 1024), True, 0),
    ("DeepSeek-V2 decode rows", (4, 5120), True, 0),
    ("DeepSeek-V3 decode rows", (4, 7168), True, 0),
    ("qwen2-vl decode rows", (4, 8192), True, 0),
    ("one decode row", (1, 8192), True, 0),
    ("a width no vector divides", (37, 4100), True, 0),
    ("x off 16-byte alignment", (37, 4096), True, 1),
]

def _rms_case_inputs(rng, dev, n, d, near_one, offset):
    """(x, res, scale) of a case as numpy-seeded card tensors, and a
    function giving them in a dtype; x ``offset`` elements into its
    buffer."""
    x = rng.standard_normal((n, d), dtype=np.float32)
    r = rng.standard_normal((n, d), dtype=np.float32)
    sc = rng.standard_normal(d, dtype=np.float32)
    if near_one:
        sc = (1.0 + 0.1 * sc).astype(np.float32)
    st = torch.from_numpy(sc).to(dev)

    def in_dtype(dtype):
        xt = torch.from_numpy(x).to(dev, dtype)
        if offset:
            buf = torch.empty(n * d + offset, dtype=dtype, device=dev)
            buf[offset:] = xt.reshape(-1)
            xt = buf[offset:].view(n, d)
        return xt, torch.from_numpy(r).to(dev, dtype), st

    return in_dtype


def composition_ms(x, r, sc, reps) -> float:
    """Device ms of what a user would write for the two outputs:
    ``x + res``, then ``F.rms_norm`` with the scale in x's dtype (the
    yardstick beside the kernel; no single call gives both outputs)."""
    from repro_torch.kernels.stencil.tune import device_time_ms

    w = sc.to(x.dtype)
    d = x.shape[-1]
    return device_time_ms(lambda: torch.nn.functional.rms_norm(
        x + r, (d,), w, 1e-5), reps)


def run_rmsnorm_vs_plain(dev, rng, bw, f32):
    """The fused residual-add + RMSNorm kernel against its plain version
    on card tensors from the seed (``RMS_CASES``), f32 and bf16: out
    within ``RMS_TOL``, h bitwise, each case with the kernel
    instantiation its launch ran.  The shapes of tests/test_kernels.py
    take a unit-normal scale as there; the model rows a scale of 1 +
    0.1·N(0, 1), as the model's scales start at 1.  Each bf16 case is
    timed beside its bytes bound and ``composition_ms``."""
    from repro_torch.kernels.rmsnorm import kernel, ref
    from repro_torch.kernels.stencil.tune import device_time_ms

    t0 = time.monotonic()
    cases, timed, worst = [], [], 0.0
    # the cases after the first nine draw from their own generator, so
    # the phases after this one see the seed's stream as before
    extra = np.random.default_rng(SEED + 1)

    def held(got, want, label):
        atol, rtol = RMS_TOL[got[0].dtype]
        err, ok = _close(got, want, atol, rtol)
        bitwise = bool(torch.equal(got[1], want[1]))
        check(ok and bitwise, f"rmsnorm kernel vs plain {label}: {err} "
                              f"outside atol {atol} + rtol {rtol}, or h "
                              f"not bitwise ({bitwise})")
        return err

    for i, (label, (n, d), near_one, offset) in enumerate(RMS_CASES):
        in_dtype = _rms_case_inputs(rng if i < 9 else extra, dev, n, d,
                                    near_one, offset)
        for dtype in (torch.float32, torch.bfloat16):
            xt, rt, st = in_dtype(dtype)
            got = kernel.rmsnorm_residual_cuda(xt, rt, st)
            shape = kernel.rmsnorm_residual_cuda.last_launch
            want = ref.rmsnorm_residual_ref(xt, rt, st)
            torch.cuda.synchronize()
            err = held(got, want, f"{label} {dtype}")
            worst = max(worst, err)
            cases.append({"case": label, "N": n, "d": d,
                          "dtype": str(dtype).split(".")[-1],
                          "max_abs_diff": err, "h_bitwise": True,
                          "instantiation": kernel.instantiation(dtype,
                                                                shape),
                          "threads": [shape["tpr"], shape["rows"]],
                          "grid": shape["grid"]})
            del got, want
            if dtype != torch.bfloat16:
                continue
            big = n * d >= 1 << 24
            ms = device_time_ms(
                lambda: kernel.rmsnorm_residual_cuda(xt, rt, st),
                50 if big else 200)
            bound, _ = bound_ms(kernel.rmsnorm_bytes(n, d, 2),
                                kernel.rmsnorm_flops(n, d), bw, f32)
            row = {"case": label, "N": n, "d": d, "ms": ms,
                   "bound_ms": bound, "share": bound / ms,
                   "composition_ms": composition_ms(
                       xt, rt, st, 20 if big else 200),
                   "instantiation": cases[-1]["instantiation"]}
            timed.append(row)
            del xt, rt
        torch.cuda.empty_cache()
    return {"phase": "rmsnorm_vs_plain", "tolerance": {
        "float32": RMS_TOL[torch.float32],
        "bfloat16": RMS_TOL[torch.bfloat16]},
        "h": "bitwise", "max_abs_err": worst, "cases": cases,
        "timed_bf16": timed, "design": kernel.DESIGN,
        "seconds": time.monotonic() - t0}


def _attn_inputs(rng, dev, dtype, b, h, kh, s, d, model_layout=False,
                 sk=None):
    """q (``s`` rows), k and v (``sk`` rows, default s) from the seed;
    with ``model_layout`` they are (B, S, H, D) tensors seen as (B, H, S,
    D), as the model hands them over.  With
    ``model_layout="mla"`` q and k are so, D = 192, and v is the last
    ``MLA_DV`` columns of a (B, S, KH, 128 + MLA_DV) tensor, the strided
    half of the ``wkv_b`` product that ``models/mla.py`` passes."""
    out = []
    mla = model_layout == "mla"
    for i, heads in enumerate((h, kh, kh)):
        w = MLA_NOPE + MLA_DV if mla and i == 2 else d
        n = s if i == 0 or sk is None else sk
        a = rng.standard_normal((b, n, heads, w) if model_layout
                                else (b, heads, n, w), dtype=np.float32)
        t = torch.from_numpy(a).to(dev, dtype)
        if mla and i == 2:
            t = t[..., MLA_NOPE:]
        out.append(t.transpose(1, 2) if model_layout else t)
    return out


def run_attention_vs_plain(dev, rng):
    from repro_torch.kernels.flash_attention import kernel, ref

    cases, worst = [], 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    plan = [(f"test_kernels {shape}", shape, dt, True, False)
            for shape in ((2, 4, 2, 256, 64), (1, 8, 8, 128, 128),
                          (2, 4, 1, 64, 32), (1, 2, 2, 512, 64))
            for dt in (f32, bf16)]
    plan += [("non-causal", (1, 2, 2, 128, 64), dt, False, False)
             for dt in (f32, bf16)]
    plan += [("Yi-6B prefill, model layout", (4, 32, 4, 512, 128), bf16,
              True, True)]
    plan += [("ragged S=300", (1, 8, 2, 300, 128), dt, True, False)
             for dt in (f32, bf16)]
    plan += [(f"S={s}", (2, 4, 2, s, d), dt, True, False)
             for s in (1, 64) for d in (32, 128) for dt in (f32, bf16)]
    plan += [("non-causal, model layout", (2, 32, 4, 300, 128), bf16,
              False, True)]
    plan += [("Jamba-v0.1 prefill (KH=8, no RoPE), model layout",
              FLASH_SHAPE_JAMBA, bf16, True, True)]
    # MLA's prefill: q·k over 192, v 128 wide, H = KH = 128, v the
    # strided half of the wkv_b product
    plan += [(f"MLA 192/128 S={s}", (1 if s == 2048 else 2, 128, 128, s,
                                      192), dt, causal, "mla")
             for s in (1, 63, 65, 2048) for dt in (f32, bf16)
             for causal in (True, False)]
    # whisper (D = 64: the encoder's 1500 frames, not causal; the
    # decoder's cross-attention, Sq = 128 queries against Sk = 1500
    # frames, the last key tile ragged; a short ragged pair) and
    # qwen2-vl's causal GQA prefill, shapes (B, H, KH, Sq, D[, Sk])
    for label, (shape, causal, sk) in (
            ("whisper encoder", FLASH_WHISPER_ENC),
            ("whisper cross-attention", FLASH_CROSS),
            ("ragged Sq=7, Sk=65", ((2, 4, 4, 7, 64), False, 65)),
            ("qwen2-vl prefill", FLASH_QWEN2VL)):
        plan += [(f"{label}, model layout", (*shape, sk), dt, causal, True)
                 for dt in (f32, bf16)]
    for label, shape, dtype, causal, layout in plan:
        b, h, kh, s, d = shape[:5]
        sk = shape[5] if len(shape) > 5 and shape[5] else s
        q, k, v = _attn_inputs(rng, dev, dtype, b, h, kh, s, d, layout, sk)
        want = ref.attention_ref(q, k, v, causal=causal)
        got = kernel.flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, ok = _close([got], [want], ATTN_TOL[dtype])
        worst = max(worst, err)
        cases.append({"case": label, "B": b, "H": h, "KH": kh, "S": s,
                      "Sk": sk, "D": d, "Dv": v.shape[-1],
                      "dtype": str(dtype).split(".")[-1],
                      "causal": causal, "max_abs_diff": err})
        check(ok, f"attention kernel vs plain {label} {dtype}: {err} > "
                  f"{ATTN_TOL[dtype]}")
        del q, k, v, want, got
    capped, worst_cap = capped_attention_cases(dev, rng)
    return {"phase": "attention_vs_plain", "tolerance": {
        "float32": ATTN_TOL[f32], "bfloat16": ATTN_TOL[bf16]},
        "max_abs_err": max(worst, worst_cap), "cases": cases,
        "softcap_cases": capped, "softcap_gain": SOFTCAP_GAIN,
        "softcap_bite": SOFTCAP_BITE}


#: capped attention_vs_plain cases: (label, (B, H, KH, Sq, D[, Sk]),
#: causal, layout) in f32 and bf16 at each of SOFTCAP_CASE_CAPS
SOFTCAP_CASES = [
    ("Yi-6B prefill, model layout", FLASH_SHAPE, True, True),
    ("non-causal, model layout", (2, 32, 4, 300, 128), False, True),
    ("ragged S=300", (1, 8, 2, 300, 128), True, False),
    ("S=1", (2, 4, 2, 1, 128), True, False),
    ("S=1 against Sk=512", (8, 32, 4, 1, 128, 512), False, False),
    ("whisper encoder, model layout", (*FLASH_WHISPER_ENC[0], None), False,
     True),
    ("whisper cross-attention, model layout", (*FLASH_CROSS[0], 1500),
     False, True),
    ("MLA 192/128 S=65", (2, 128, 128, 65, 192), True, "mla"),
]


def capped_attention_cases(dev, rng) -> tuple[list[dict], float]:
    """``SOFTCAP_CASES`` through the kernel with a soft-cap against the
    plain version, each within ATTN_TOL; at cap 5 each where a query
    sees more than one key must also part from the uncapped kernel by
    more than SOFTCAP_BITE tolerances (a single key takes all the
    weight whatever its score).  Returns the cases and the worst
    error."""
    from repro_torch.kernels.flash_attention import kernel, ref

    cases, worst = [], 0.0
    for label, shape, causal, layout in SOFTCAP_CASES:
        b, h, kh, s, d = shape[:5]
        sk = shape[5] if len(shape) > 5 and shape[5] else s
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(rng, dev, dtype, b, h, kh, s, d, layout,
                                   sk)
            q.mul_(SOFTCAP_GAIN)
            v.copy_(torch.from_numpy(rng.uniform(
                -SOFTCAP_V, SOFTCAP_V, v.shape).astype(np.float32)))
            tol = ATTN_TOL[dtype]
            for cap in SOFTCAP_CASE_CAPS:
                want = ref.attention_ref(q, k, v, causal=causal, softcap=cap)
                got = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                  softcap=cap)
                torch.cuda.synchronize()
                err, ok = _close([got], [want], tol)
                worst = max(worst, err)
                row = {"case": label, "B": b, "H": h, "KH": kh, "S": s,
                       "Sk": sk, "D": d, "Dv": v.shape[-1],
                       "dtype": str(dtype).split(".")[-1], "causal": causal,
                       "softcap": cap, "max_abs_diff": err}
                check(ok, f"capped attention kernel vs plain {label} "
                          f"{dtype} cap {cap}: {err} > {tol}")
                if cap == min(SOFTCAP_CASE_CAPS):
                    free = kernel.flash_attention_cuda(q, k, v,
                                                       causal=causal)
                    row["moved_from_uncapped"] = float(
                        (got.float() - free.float()).abs().max())
                    one_key = sk == 1 or (causal and s == 1)
                    check(one_key or row["moved_from_uncapped"]
                          > SOFTCAP_BITE * tol,
                          f"cap {cap} moves {label} {dtype} by "
                          f"{row['moved_from_uncapped']} only")
                    del free
                cases.append(row)
                del want, got
            del q, k, v
    torch.cuda.empty_cache()
    return cases, worst


def _counts_zero():
    from repro_torch.launch.serve import KERNELS

    for fn in KERNELS.values():
        fn.launches = 0


def _counts():
    from repro_torch.launch.serve import KERNELS

    return {name: fn.launches for name, fn in KERNELS.items()}


def run_serve_vs_cpu(dev, arch="yi-6b"):
    """``arch`` (a dense decoder) at full width cut to 2 layers, f32: one
    set of weights from one generator serves on the card and on the
    CPU."""
    import dataclasses

    from repro_torch.configs import dense_blocks, get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_map

    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              blocks=dense_blocks(2),
                              compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(M.schema(cfg), gen, dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 128)))
    steps = 4
    _counts_zero()
    got = serve.serve(cfg, params, prompts.to(dev), steps + 1)
    launches = _counts()
    t0 = time.monotonic()
    want = serve.serve(cfg, cpu_params, prompts, steps + 1)
    cpu_s = time.monotonic() - t0
    scale = float(want.first_logits.abs().max())
    errs = [float((g.cpu() - w).abs().max()) for g, w in (
        (got.first_logits, want.first_logits),
        (got.last_logits, want.last_logits))]
    pre = M.launches_per_pass(cfg, "prefill")
    dec = {k: steps * v for k, v in M.launches_per_pass(cfg, "decode").items()}
    check(all(bool(torch.isfinite(t).all()) for t in (
        got.first_logits, got.last_logits)), "non-finite logits on the card")
    check(max(errs) <= SERVE_F32_TOL * scale,
          f"card vs CPU logits: {errs} > {SERVE_F32_TOL} * {scale}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"greedy tokens differ: {got.tokens.tolist()} vs "
          f"{want.tokens.tolist()}")
    check(got.launches == {"prefill": pre, "decode": dec},
          f"launches {got.launches}, predicted prefill {pre} decode {dec}")
    check(launches == {k: pre.get(k, 0) + dec.get(k, 0) for k in launches},
          f"counted launches {launches}")
    capped = capped_serve_vs_cpu(cfg, params, cpu_params, prompts, steps,
                                 got, dev)
    return {"phase": "serve_vs_cpu", "arch": cfg.name, "layers": 2,
            "d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "mlp_act": cfg.mlp_act, "vocab": cfg.vocab_size,
            "compute_dtype": cfg.compute_dtype,
            "batch": 2, "prompt": 128, "decode_steps": steps,
            "max_abs_logit": scale, "logit_max_abs_diff": errs,
            "tolerance": SERVE_F32_TOL * scale,
            "tokens_equal": True, "launches": got.launches,
            "card_prefill_s": got.prefill_s, "cpu_s": cpu_s,
            "softcap": capped}


class ScoreRecorder:
    """Within its ``with``, each attention call of the model's prefill
    (``models/attention.py``'s ``attention``) also records its largest
    |scaled score| q·kᵀ·D^-½ before any cap, computed beside the call:
    where it exceeds the cap, the cap moves that score by at least
    (1 - tanh 1)·cap, a quarter of the cap."""

    def __init__(self):
        self.max_abs_scores: list[float] = []

    def __enter__(self):
        from repro_torch.models import attention as am

        self._mod, self._fn = am, am.attention

        def recorded(q, k, v, **kw):
            rep = q.shape[1] // k.shape[1]
            kk = k.repeat_interleave(rep, dim=1).float()
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) \
                * q.shape[-1] ** -0.5
            self.max_abs_scores.append(float(s.abs().max()))
            del s, kk
            return self._fn(q, k, v, **kw)

        am.attention = recorded
        return self

    def __exit__(self, *exc):
        self._mod.attention = self._fn


def capped_serve_vs_cpu(cfg, params, cpu_params, prompts, steps, free, dev):
    """serve_vs_cpu's second serve, on the same params and prompts, with
    ``attn_logit_softcap = SOFTCAP``: the card within
    SERVE_F32_TOL·max|logit| of the CPU, the same tokens, the predicted
    launches; the CPU's prefill records each layer's largest score,
    which must exceed the cap at both layers (the cap bites at each)."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import model as M

    capped = dataclasses.replace(cfg, attn_logit_softcap=SOFTCAP)
    _counts_zero()
    got = serve.serve(capped, params, prompts.to(dev), steps + 1)
    launches = _counts()
    with ScoreRecorder() as rec:
        want = serve.serve(capped, cpu_params, prompts, steps + 1)
    scale = float(want.first_logits.abs().max())
    errs = [float((g.cpu() - w).abs().max()) for g, w in (
        (got.first_logits, want.first_logits),
        (got.last_logits, want.last_logits))]
    pre = M.launches_per_pass(capped, "prefill")
    dec = {k: steps * v
           for k, v in M.launches_per_pass(capped, "decode").items()}
    check(all(bool(torch.isfinite(t).all()) for t in (
        got.first_logits, got.last_logits)),
          "non-finite capped logits on the card")
    check(max(errs) <= SERVE_F32_TOL * scale,
          f"capped card vs CPU logits: {errs} > {SERVE_F32_TOL} * {scale}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"capped greedy tokens differ: {got.tokens.tolist()} vs "
          f"{want.tokens.tolist()}")
    check(got.launches == {"prefill": pre, "decode": dec},
          f"capped launches {got.launches}, predicted prefill {pre} "
          f"decode {dec}")
    check(launches == {k: pre.get(k, 0) + dec.get(k, 0) for k in launches},
          f"capped counted launches {launches}")
    layer_scores = rec.max_abs_scores[:cfg.num_layers]
    check(len(layer_scores) == cfg.num_layers
          and min(layer_scores) > SOFTCAP,
          f"the cap {SOFTCAP} does not bite at every layer: largest "
          f"scores {layer_scores}")
    return {"cap": SOFTCAP, "max_abs_logit": scale,
            "logit_max_abs_diff": errs, "tolerance": SERVE_F32_TOL * scale,
            "tokens_equal": True, "launches": got.launches,
            "layer_max_abs_score": layer_scores,
            "from_uncapped_first_logits_max_abs_diff": float(
                (got.first_logits - free.first_logits).abs().max()),
            "from_uncapped_tokens_equal": bool(torch.equal(
                got.tokens, free.tokens))}


def _category(name: str) -> str:
    low = name.lower()
    if "flash" in low:
        return "flash_attention"
    if "rmsnorm" in low:
        return "rmsnorm_residual"
    if "ssd" in low:
        return "ssd_chunk"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "gemv",
                              "splitk")):
        return "matmul"
    return "other"


def by_kind(profile: dict, calls: int) -> dict:
    """``profile_device``'s device ms (totals over ``calls`` calls) per
    call, summed by kind of kernel: the LM kernels, cuBLAS matmuls,
    everything else."""
    kinds: dict = {}
    for name, ms in profile["by_kernel_ms"].items():
        kind = _category(name)
        kinds[kind] = kinds.get(kind, 0.0) + ms / calls
    return dict(profile, by_kind_ms_per_call=kinds,
                wall_ms_per_call=profile["wall_ms"] / calls,
                device_ms_per_call=profile["device_ms"] / calls)


def _check_served(cfg, res, launches, B, G) -> dict:
    """Hold a ``serve.serve`` result of B requests and G tokens: the
    launches per prefill and per decode step (``res.launches``) and the
    counted total (``launches``) equal ``launches_per_pass``, the logits'
    and tokens' shapes, finite logits, token ids in range.  Returns the
    launches per decode step."""
    from repro_torch.models import model as M

    pre = M.launches_per_pass(cfg, "prefill")
    dec = M.launches_per_pass(cfg, "decode")
    steps = res.decode_steps
    per_step = {k: v / steps for k, v in res.launches["decode"].items()}
    check(res.launches["prefill"] == pre,
          f"prefill launches {res.launches['prefill']}, predicted {pre}")
    check(per_step == dec, f"decode launches per step {per_step}, "
                           f"predicted {dec}")
    check(launches == {k: pre.get(k, 0) + steps * dec.get(k, 0)
                       for k in launches},
          f"counted launches {launches}")
    V = cfg.vocab_size
    check(tuple(res.first_logits.shape) == (B, V)
          and tuple(res.tokens.shape) == (B, G), "serve output shapes")
    check(bool(torch.isfinite(res.first_logits).all())
          and bool(torch.isfinite(res.last_logits).all()),
          "non-finite serve logits")
    check(bool(((res.tokens >= 0) & (res.tokens < V)).all()),
          "token ids out of range")
    return per_step


def run_serve(dev):
    """Yi-6B, full width and depth, bf16: 4 requests of 512 prompt tokens
    and 32 greedy tokens through launch/serve.py's functions."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.runtime import serve_step

    cfg = get_config("yi-6b")
    B, P, G = 4, 512, 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = serve.make_params(cfg, dev, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_bytes = torch.cuda.memory_allocated(dev)
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = serve.make_prompts(cfg, B, P, rng)
    serve.serve(cfg, params, prompts, 2)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    _counts_zero()
    res = serve.serve(cfg, params, prompts, G)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev)

    steps, per_step = res.decode_steps, _check_served(cfg, res, launches,
                                                      B, G)

    on_acts = kernels_on_activations(cfg, params, prompts,
                                     "kernels_on_activations")

    # the serving invariant: full prefill vs prefill(S-1) + one decode
    # step, all 32 layers, bf16, well-conditioned attention weights
    wc = well_conditioned(cfg, params)
    inv = serve_invariant(cfg, wc, prompts)
    del wc
    torch.cuda.empty_cache()
    check(inv["max_abs_diff"] <= SERVE_INV_TOL * inv["max_abs_logit"],
          f"bf16 prefill vs prefill+decode at {cfg.num_layers} layers: "
          f"{inv}")
    capped = capped_serve(cfg, params, prompts)
    decode = serve_step.build_decode(cfg)

    # where the time goes
    full = serve_step.build_prefill(cfg, max_seq=P + G)
    _, cache = full(params, {"tokens": prompts})
    tok = res.tokens[:, 0]
    prof_prefill = by_kind(profile_device(
        lambda: full(params, {"tokens": prompts}), 1), 1)
    prof_decode = by_kind(profile_device(
        lambda: [decode(params, cache, {"token": tok, "pos": P})
                 for _ in range(4)], 4), 4)
    del cache
    total_s = res.prefill_s + res.decode_s
    return {
        "phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
        "params": count_params(M.schema(cfg)),
        "weights_bytes": weights_bytes, "init_s": init_s,
        "batch": B, "prompt": P, "generated": G, "decode_steps": steps,
        "prefill_ms": res.prefill_s * 1e3,
        "decode_ms_per_step": res.decode_s / steps * 1e3,
        "decode_tokens_per_s": steps * B / res.decode_s,
        "end_to_end_tokens_per_s": G * B / total_s,
        "prefill_tokens_per_s": P * B / res.prefill_s,
        "peak_memory_bytes": peak,
        "launches_per_prefill": res.launches["prefill"],
        "launches_per_decode_step": per_step,
        "launches": launches,
        "kernels_on_activations": on_acts,
        "invariant": inv,
        "softcap": capped,
        "profile_prefill": prof_prefill,
        "profile_decode_step": prof_decode,
        "sample_ids": res.tokens[0, :12].tolist(),
    }


def serve_invariant(cfg, weights, prompts) -> dict:
    """Full prefill of ``prompts`` (B, P) against prefill(P-1) + one
    decode step of the last token, all layers: the logits' largest
    difference beside max|logit|, their argmax agreement, and the first
    layer's cached k (its prefix and the new position by layer)."""
    from repro_torch.runtime import serve_step

    P = prompts.shape[1]
    lf, cf = serve_step.build_prefill(cfg)(weights, {"tokens": prompts})
    _, cache = serve_step.build_prefill(cfg, max_seq=P)(
        weights, {"tokens": prompts[:, :P - 1]})
    ld, cache = serve_step.build_decode(cfg)(
        weights, cache, {"token": prompts[:, P - 1], "pos": P - 1})
    kf = cf["b0"]["l0"]["mixer"]["k"].float()
    kd = cache["b0"]["l0"]["mixer"]["k"].float()
    inv = {"layers": cfg.num_layers, "compute_dtype": cfg.compute_dtype,
           "max_abs_diff": float((lf - ld).abs().max()),
           "max_abs_logit": float(lf.abs().max()),
           "tolerance_share": SERVE_INV_TOL,
           "argmax_agreement": float((lf.argmax(-1) == ld.argmax(-1))
                                     .float().mean()),
           "cache_prefix_max_abs_diff": float(
               (kf[:, :, :P - 1] - kd[:, :, :P - 1]).abs().max()),
           "k_new_max_abs_diff_by_layer": (
               kf[:, :, P - 1] - kd[:, :, P - 1]).abs().amax(
                   dim=(1, 2, 3)).tolist()}
    del cf, cache, kf, kd
    torch.cuda.empty_cache()
    return inv


#: serve's soft-capped run: one prefill and this many decode steps
SOFTCAP_SERVE_STEPS = 4


def capped_serve(cfg, params, prompts) -> dict:
    """The served model at ``attn_logit_softcap = SOFTCAP`` on the same
    params and prompts: one prefill and SOFTCAP_SERVE_STEPS decode
    steps (finite logits, the predicted launches: one flash call per
    layer in the prefill, none in a step), and the bf16 invariant held
    within SERVE_INV_TOL·max|logit| on the served params themselves.
    Their scores reach ~2000 under the init rule; the uncapped
    invariant needs ``well_conditioned`` weights (its one-hot rows
    multiply a rounding at each layer), the capped one does not (every
    score within ±50)."""
    import dataclasses

    from repro_torch.launch import serve

    capped = dataclasses.replace(cfg, attn_logit_softcap=SOFTCAP)
    B = prompts.shape[0]
    G = SOFTCAP_SERVE_STEPS + 1
    _counts_zero()
    res = serve.serve(capped, params, prompts, G)
    per_step = _check_served(capped, res, _counts(), B, G)
    check(res.launches["prefill"]["flash_attention"] == cfg.num_layers,
          f"capped prefill flash launches {res.launches['prefill']}")
    inv = serve_invariant(capped, params, prompts)
    check(inv["max_abs_diff"] <= SERVE_INV_TOL * inv["max_abs_logit"],
          f"capped bf16 prefill vs prefill+decode at {cfg.num_layers} "
          f"layers: {inv}")
    return {"cap": SOFTCAP, "invariant_weights": "init rule",
            "decode_steps": res.decode_steps,
            "prefill_ms": res.prefill_s * 1e3,
            "decode_ms_per_step": res.decode_s / res.decode_steps * 1e3,
            "launches_per_prefill": res.launches["prefill"],
            "launches_per_decode_step": per_step,
            "max_abs_first_logit": float(res.first_logits.abs().max()),
            "sample_ids": res.tokens[0].tolist(), "invariant": inv}


def well_conditioned(cfg, params):
    """``params`` with every attention and MLA layer's projections
    rescaled to the fan-in of their contraction: d for wq, wk and wv,
    heads·head_dim for wo; MLA's wq_b to q_lora_rank, wkv_b to
    kv_lora_rank, wo to heads·v_head_dim (wq_a and wkv_a already contract
    over axis -2, d).  The init rule takes axis -2, the head count or
    head_dim.  A cross-attention's projections and the encoder's
    attention layers are rescaled as attention layers are."""
    H, KH, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    gains = {"attn": {"wq": (H / d) ** 0.5, "wk": (KH / d) ** 0.5,
                      "wv": (KH / d) ** 0.5, "wo": H ** -0.5}}
    if cfg.mla is not None:
        m = cfg.mla
        gains["mla"] = {"wq": (H / d) ** 0.5, "wkv_b": (H / m.kv_lora_rank)
                        ** 0.5, "wo": H ** -0.5}
        if m.q_lora_rank:
            gains["mla"]["wq_b"] = (H / m.q_lora_rank) ** 0.5
    def scaled(proj, gain):
        return {k: w * gain[k] if k in gain else w for k, w in proj.items()}

    out = dict(params)
    for i, bdef in enumerate(cfg.blocks):
        blk = dict(params[f"b{i}"])
        for j, (mixer, _) in enumerate(bdef.pattern):
            lp = dict(blk[f"l{j}"])
            if mixer in gains:
                lp["mixer"] = scaled(lp["mixer"], gains[mixer])
            if "cross" in lp:
                lp["cross"] = scaled(lp["cross"], gains["attn"])
            blk[f"l{j}"] = lp
        out[f"b{i}"] = blk
    if "encoder" in params:
        enc = params["encoder"]["blocks"]["l0"]
        out["encoder"] = dict(params["encoder"], blocks={
            "l0": dict(enc, mixer=scaled(enc["mixer"], gains["attn"]))})
    return out


def kernels_on_activations(cfg, params, prompts, phase, inputs=None):
    """One prefill and one decode step of the served model (with the
    prefill's other ``inputs``, ``launch/serve.py::make_inputs``), each
    call of the LM kernels its layers run also made through its plain
    version on the same inputs: flash held to ``ATTN_ACT_SHARE``·max|v|,
    SSD to ``SSD_ACT_*`` against the bounds ``_ssd_bounds`` computes
    from the same inputs, the norm to ``RMS_TOL``.  Emits the phase line
    ``phase`` with every call's error; returns the calls and the worst
    error per kernel."""
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.rmsnorm import ref as rr
    from repro_torch.kernels.ssd import ref as sr
    from repro_torch.models import attention as am
    from repro_torch.models import mamba2 as mm
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tm
    from repro_torch.runtime import serve_step

    attn0, ssd0, norm0 = am.attention, mm.ssd_chunk, tm.rmsnorm_residual
    pre, dec = (M.launches_per_pass(cfg, ph) for ph in ("prefill", "decode"))
    # (error, within tolerance, extra figures) per call
    seen = {name: [] for name in pre}

    def attention(q, k, v, *, causal=True, softcap=0.0):
        out = attn0(q, k, v, causal=causal, softcap=softcap)
        # the plain version a request at a time: at MLA's 128 heads one
        # (B, H, S, S) f32 score tensor is 8.6 GB at B=4, S=2048
        want = torch.cat([fr.attention_ref(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], causal=causal,
                                           softcap=softcap)
                          for i in range(q.shape[0])])
        vmax = float(v.abs().max())
        err, ok = _close([out], [want], ATTN_ACT_SHARE * vmax)
        seen["flash_attention"].append((err, ok, {"max_abs_v": vmax}))
        return out

    def ssd_chunk(xdt, b, c, csum):
        out = ssd0(xdt, b, c, csum)
        want = sr.ssd_chunk_ref(xdt, b, c, csum)
        ya, sa = _ssd_bounds(xdt, b, c, csum)
        dy = (out[0].float() - want[0].float()).abs()
        ds = (out[1] - want[1]).abs()
        ok = bool((dy <= SSD_ACT_Y[0] * want[0].float().abs()
                   + SSD_ACT_Y[1] * ya).all()) \
            and bool((ds <= SSD_ACT_STATE * sa).all())
        seen["ssd_chunk"].append(
            ([float(dy.max()), float(ds.max())], ok,
             {"max_abs_y_state": [float(want[0].float().abs().max()),
                                  float(want[1].abs().max())]}))
        del want, ya, sa, dy, ds
        return out

    def rmsnorm_residual(x, res, scale, eps=1e-5):
        out = norm0(x, res, scale, eps)
        err, ok = _close(out, rr.rmsnorm_residual_ref(x, res, scale, eps),
                         *RMS_TOL[x.dtype])
        seen["rmsnorm_residual"].append((err, ok, {}))
        return out

    P = prompts.shape[1]
    inputs = inputs or {}
    step = {"token": prompts[:, -1], "pos": P}
    if "positions" in inputs:
        step["positions"] = (inputs["positions"].amax(dim=(1, 2))
                             + 1)[:, None].expand(-1, 3)
    am.attention, mm.ssd_chunk, tm.rmsnorm_residual = \
        attention, ssd_chunk, rmsnorm_residual
    try:
        _, cache = serve_step.build_prefill(cfg, max_seq=P + 1)(
            params, {"tokens": prompts, **inputs})
        serve_step.build_decode(cfg)(params, cache, step)
        torch.cuda.synchronize()
    finally:
        am.attention, mm.ssd_chunk, tm.rmsnorm_residual = \
            attn0, ssd0, norm0
    tolerance = {"flash_attention": {
        "flash_attention_share_of_max_abs_v": ATTN_ACT_SHARE},
        "ssd_chunk": {"ssd_chunk_y": SSD_ACT_Y,
                      "ssd_chunk_state": SSD_ACT_STATE},
        "rmsnorm_residual": {"rmsnorm_residual": RMS_TOL[cfg.cdtype]}}
    out = {"tolerance": {k: v for name in seen
                         for k, v in tolerance[name].items()}}
    for name, calls in seen.items():
        out[name] = {"calls": len(calls),
                     "max_abs_diff": [e for e, _, _ in calls],
                     "bad_calls": [i for i, c in enumerate(calls)
                                   if not c[1]]}
        for key in (calls[0][2] if calls else {}):
            out[name][key] = [x[key] for _, _, x in calls]
    emit({"phase": phase, **out})
    for name, calls in seen.items():
        want = pre[name] + dec[name]
        check(len(calls) == want,
              f"{name}: {len(calls)} calls checked, expected {want}")
        check(not out[name]["bad_calls"], f"{name} vs plain on the served "
                                         f"activations: {out[name]}")
    return {name: {"calls": len(calls),
                   "max_abs_diff": max((np.max(e) for e, _, _ in calls),
                                       default=None)}
            for name, calls in seen.items()} | {"tolerance": out["tolerance"]}


def flash_timing(dev, shape, bw, peak, g, causal=True, sk=None,
                 softcap=0.0) -> dict:
    """The bf16 flash kernel at ``shape`` = (B, H, KH, S, D) or (B, H,
    KH, S, D, Dv), causal or not, S queries against ``sk`` keys (default
    S), on the model's (B, S, H, D) views from ``g`` (with a Dv, v the
    last Dv columns of a (B, S, KH, 128 + Dv) tensor, as MLA passes it),
    its scores capped by ``softcap`` (0: none): held to its plain
    version within ATTN_TOL, its device ms, the plain version's, SDPA's
    (the yardstick, never called by the port; None with a cap, which no
    single PyTorch call applies) and the bound (the same with a cap:
    products and bytes only)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr
    from repro_torch.kernels.stencil.tune import device_time_ms

    B, H, KH, S, D = shape[:5]
    Dv = shape[5] if len(shape) > 5 else D
    Sk = S if sk is None else sk
    bt = torch.bfloat16
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(bt) \
        .transpose(1, 2)
    k = torch.randn((B, Sk, KH, D), generator=g, device=dev).to(bt) \
        .transpose(1, 2)
    if Dv == D:
        v = torch.randn((B, Sk, KH, D), generator=g, device=dev).to(bt) \
            .transpose(1, 2)
    else:
        v = torch.randn((B, Sk, KH, MLA_NOPE + Dv), generator=g,
                        device=dev).to(bt)[..., MLA_NOPE:].transpose(1, 2)
    want = fr.attention_ref(q, k, v, causal=causal, softcap=softcap)
    err, ok = _close([fk.flash_attention_cuda(q, k, v, causal=causal,
                                              softcap=softcap)],
                     [want], ATTN_TOL[bt])
    check(ok, f"flash at {shape}, Sk={Sk}, cap {softcap}: {err} > "
              f"{ATTN_TOL[bt]}")
    del want
    reps = max(5, 50 * 512 // S)
    ms = device_time_ms(
        lambda: fk.flash_attention_cuda(q, k, v, causal=causal,
                                        softcap=softcap), reps)
    plain_ms = device_time_ms(
        lambda: fr.attention_ref(q, k, v, causal=causal, softcap=softcap),
        10 if S <= 512 else 3)
    lib_ms = None if softcap else device_time_ms(
        lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps)
    fb, fby = bound_ms(fk.attention_bytes(B, H, KH, S, D, 2, Dv, Sk),
                       fk.attention_flops(B, H, S, D, causal, Dv, Sk), bw,
                       peak)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": fb, "bound_by": fby, "max_abs_err": err}


def lm_kernel_entries(dev, bw, f32, bf16, rms, att, served):
    """The kernels-line entries of the two LM kernels, timed at Yi-6B's
    shapes; launches from the serve phase's run."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    from repro_torch.kernels.stencil.tune import device_time_ms

    g = torch.Generator(device=dev).manual_seed(SEED)
    B, H, KH, S, D = FLASH_SHAPE
    bt = torch.bfloat16
    main = flash_timing(dev, FLASH_SHAPE, bw, bf16, g)
    capped = flash_timing(dev, FLASH_SHAPE, bw, bf16, g, softcap=SOFTCAP)
    long = flash_timing(dev, FLASH_SHAPE_LONG, bw, bf16, g)
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
        "launches": served["launches"]["flash_attention"],
        "max_abs_err": max(att["max_abs_err"], main["max_abs_err"],
                           capped["max_abs_err"], long["max_abs_err"]),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "ms_softcap": capped["ms"], "plain_ms_softcap": capped["plain_ms"],
        "softcap": SOFTCAP,
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "shape": "B=4, H=32, KH=4, S=512, D=128, bf16, causal (Yi-6B "
                 "prefill, the model's strided views)",
        "design": fk.DESIGN,
        "ms_long": long["ms"], "library_ms_long": long["library_ms"],
        "bound_ms_long": long["bound_ms"], "bound_by_long": long["bound_by"],
        "plain_ms_long": long["plain_ms"],
        "shape_long": "B=1, H=32, KH=4, S=4096, D=128, bf16, causal (the "
                      "model's strided views)",
        "launches_per_prefill": served["launches_per_prefill"][
            "flash_attention"],
        "max_abs_err_served": served["kernels_on_activations"][
            "flash_attention"]["max_abs_diff"],
    }

    N, d = B * S, 4096
    x = torch.randn((N, d), generator=g, device=dev).to(bt)
    r = torch.randn((N, d), generator=g, device=dev).to(bt)
    sc = 1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
    err, ok = _close(rk.rmsnorm_residual_cuda(x, r, sc),
                     rr.rmsnorm_residual_ref(x, r, sc), *RMS_TOL[bt])
    check(ok, f"rmsnorm at Yi-6B shape: {err}")
    r_ms = device_time_ms(lambda: rk.rmsnorm_residual_cuda(x, r, sc), 100)
    r_plain = device_time_ms(lambda: rr.rmsnorm_residual_ref(x, r, sc), 20)
    rb, rby = bound_ms(rk.rmsnorm_bytes(N, d, 2), rk.rmsnorm_flops(N, d),
                       bw, f32)
    r_comp = composition_ms(x, r, sc, 100)
    xd, rd = x[:B].contiguous(), r[:B].contiguous()
    d_ms = device_time_ms(lambda: rk.rmsnorm_residual_cuda(xd, rd, sc), 200)
    d_plain = device_time_ms(lambda: rr.rmsnorm_residual_ref(xd, rd, sc), 50)
    d_comp = composition_ms(xd, rd, sc, 200)
    db, _ = bound_ms(rk.rmsnorm_bytes(B, d, 2), rk.rmsnorm_flops(B, d),
                     bw, f32)
    one = torch.ones((1,), device=dev)
    floor_ms = device_time_ms(lambda: torch.add(one, one), 200)
    norm = {
        "name": "rmsnorm_residual", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/"
                  "rmsnorm_residual.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:29",
        "launches": served["launches"]["rmsnorm_residual"],
        "max_abs_err": max(rms["max_abs_err"], err),
        "ms": r_ms, "plain_ms": r_plain, "bound_ms": rb, "bound_by": rby,
        "library_ms": None,
        "library": "none: no single PyTorch call computes residual-add + "
                   "RMSNorm with both outputs",
        "shape": "N=2048, d=4096, bf16 (Yi-6B prefill rows)",
        "design": rk.DESIGN,
        "composition_ms": r_comp, "composition_ms_decode": d_comp,
        "composition": "x + res, then F.rms_norm(., (d,), scale in x's "
                       "dtype, eps): a yardstick, not one call",
        "timed_bf16": rms["timed_bf16"],
        "ms_decode": d_ms, "plain_ms_decode": d_plain,
        "bound_ms_decode": db,
        "shape_decode": "N=4, d=4096, bf16 (Yi-6B decode rows)",
        "launch_floor_ms": floor_ms,
        "launch_floor": "a one-element torch.add timed as the kernels are "
                        "(queued behind the sleep kernel): the card's "
                        "time for a launch that does next to no work",
        "launches_per_pass": served["launches_per_prefill"][
            "rmsnorm_residual"],
        "max_abs_err_served": served["kernels_on_activations"][
            "rmsnorm_residual"]["max_abs_diff"],
    }
    return [flash, norm]


#: ssd_vs_plain's cases: (label, (BC, H, Q, N, P), dtypes, layout, rtol).
#: Layouts (``_ssd_inputs``): "contiguous" per-head tensors; "model" the
#: views ssd_chunked hands over (xdt a (BC, H, Q, P) view of (BC, Q, H,
#: P), B and C one group seen by every head with stride 0); "groups2"
#: the model's xdt with two groups of B and C repeated per head as
#: ``models/mamba2.py::_heads`` builds them for G > 1
SSD_CASES = [
    *((f"test_kernels {shape}", shape, ("float32", "bfloat16"),
       "contiguous", 0.0)
      for shape in ((4, 2, 64, 32, 64), (2, 4, 128, 128, 64),
                    (3, 1, 32, 16, 16))),
    ("ragged Q=96", (2, 4, 96, 128, 64), ("float32", "bfloat16"),
     "contiguous", 1e-6),
    ("largest N and P", (2, 8, 256, 256, 128), ("bfloat16",), "contiguous",
     1e-6),
    ("ragged Q=96, model views", (2, 6, 96, 128, 64), ("bfloat16",), "model",
     1e-6),
    ("ragged Q=96, odd H, model views", (2, 5, 96, 128, 64), ("bfloat16",),
     "model", 1e-6),
    ("two groups, repeated per head", (4, 8, 256, 128, 64), ("bfloat16",),
     "groups2", 1e-6),
    ("mamba2-370m prefill, per-head B/C", (32, 32, 256, 128, 64),
     ("bfloat16",), "contiguous", 1e-6),
    ("mamba2-370m prefill, model views", (32, 32, 256, 128, 64),
     ("bfloat16",), "model", 1e-6),
    ("Jamba-v0.1 prefill, model views", SSD_JAMBA, ("bfloat16",), "model",
     1e-6),
]
#: the served shape (mamba2-370m, 4 x 2048 tokens), timed in both layouts
SSD_SERVED = (32, 32, 256, 128, 64)


def _ssd_inputs(rng, dev, dtype, bc, h, q, n, p, layout="contiguous"):
    """xdt, B, C and csum from the seed as tests/test_kernels.py builds
    them (unit normals, csum = -cumsum(uniform)), in one of
    ``SSD_CASES``' layouts."""
    def dev_t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    if layout == "contiguous":
        x = dev_t(rng.standard_normal((bc, h, q, p), dtype=np.float32))
        b, c = (dev_t(rng.standard_normal((bc, h, q, n), dtype=np.float32))
                for _ in range(2))
    else:
        x = dev_t(rng.standard_normal((bc, q, h, p), dtype=np.float32)
                  ).transpose(1, 2)
        g = 1 if layout == "model" else 2
        b, c = (dev_t(rng.standard_normal((bc, g, q, n), dtype=np.float32))
                for _ in range(2))
        b, c = ((t.expand(bc, h, q, n) for t in (b, c)) if g == 1 else
                (t.repeat_interleave(h // g, dim=1) for t in (b, c)))
    cs = -np.cumsum(rng.uniform(size=(bc, h, q)).astype(np.float32), -1)
    return x, b, c, dev_t(cs, torch.float32)


def _ssd_ok(dtype, got, want, rtol=0.0) -> tuple[float, bool]:
    """``ssd_vs_plain``'s tolerances on (y, state)."""
    ey, oky = _close([got[0]], [want[0]], SSD_TOL, rtol) \
        if dtype == torch.float32 else _close(
            [got[0]], [want[0]],
            SSD_BF16_Y[0] * float(want[0].float().abs().max()), SSD_BF16_Y[1])
    es, oks = _close([got[1]], [want[1]], SSD_TOL, rtol)
    return max(ey, es), oky and oks


def check_ssd_cases(dev, rng) -> tuple[list[dict], float]:
    """Every ``SSD_CASES`` case through the kernel's wrapper against the
    plain version; raises on the first that fails.  Returns the cases
    and the worst error."""
    from repro_torch.kernels.ssd import kernel, ref

    cases, worst = [], 0.0
    for label, shape, dtypes, layout, rtol in SSD_CASES:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            args = _ssd_inputs(rng, dev, dtype, *shape, layout=layout)
            got = kernel.ssd_chunk_cuda(*args)
            launch = kernel.ssd_chunk_cuda.last_launch
            want = ref.ssd_chunk_ref(*args)
            torch.cuda.synchronize()
            err, ok = _ssd_ok(dtype, got, want, rtol)
            worst = max(worst, err)
            cases.append({"case": label, "BC_H_Q_N_P": list(shape),
                          "dtype": dt, "layout": layout,
                          "heads_per_cta": launch["heads_per_cta"],
                          "max_abs_diff_y_state": [
                              float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want)],
                          "max_abs_y": float(want[0].float().abs().max())})
            check(ok, f"ssd kernel vs plain {label} {dtype}: {cases[-1]}")
            del args, got, want
    torch.cuda.empty_cache()
    return cases, worst


def run_ssd_vs_plain(dev, rng, bw, bf16):
    """The SSD chunk kernel against its plain version on card tensors
    from the seed; times the served shape on the model's views and with
    per-head B and C."""
    from repro_torch.kernels.ssd import kernel, ref
    from repro_torch.kernels.stencil.tune import device_time_ms

    cases, worst = check_ssd_cases(dev, rng)
    BC, H, Q, N, P = SSD_SERVED
    timed = _ssd_inputs(rng, dev, torch.bfloat16, *SSD_SERVED,
                        layout="model")
    ms = device_time_ms(lambda: kernel.ssd_chunk_cuda(*timed), 50)
    launch = kernel.ssd_chunk_cuda.last_launch
    plain_ms = device_time_ms(lambda: ref.ssd_chunk_ref(*timed), 5)
    del timed
    per_head = _ssd_inputs(rng, dev, torch.bfloat16, *SSD_SERVED)
    ms_per_head = device_time_ms(lambda: kernel.ssd_chunk_cuda(*per_head),
                                 50)
    launch_per_head = kernel.ssd_chunk_cuda.last_launch
    del per_head
    bound, by = bound_ms(kernel.ssd_bytes(BC, H, Q, N, P, 2, 1),
                         kernel.ssd_flops(BC, H, Q, N, P), bw, bf16)
    bound_ph, by_ph = bound_ms(kernel.ssd_bytes(BC, H, Q, N, P, 2, H),
                               kernel.ssd_flops(BC, H, Q, N, P), bw, bf16)
    jamba = _ssd_inputs(rng, dev, torch.bfloat16, *SSD_JAMBA, layout="model")
    ms_j = device_time_ms(lambda: kernel.ssd_chunk_cuda(*jamba), 50)
    launch_j = kernel.ssd_chunk_cuda.last_launch
    plain_j = device_time_ms(lambda: ref.ssd_chunk_ref(*jamba), 5)
    del jamba
    bound_j, by_j = bound_ms(kernel.ssd_bytes(*SSD_JAMBA, 2, 1),
                             kernel.ssd_flops(*SSD_JAMBA), bw, bf16)
    torch.cuda.empty_cache()
    return {"phase": "ssd_vs_plain",
            "tolerance": {"float32": SSD_TOL, "bfloat16_y": SSD_BF16_Y,
                          "bfloat16_state": SSD_TOL},
            "max_abs_err": worst, "cases": cases,
            "timed": {"shape": "BC=32, H=32, Q=256, N=128, P=64, bf16, "
                               "B/C stride-0 over heads, xdt the model's "
                               "view (mamba2-370m, 4 x 2048 tokens)",
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "launch": launch,
                      "ms_per_head": ms_per_head,
                      "bound_ms_per_head": bound_ph,
                      "bound_by_per_head": by_ph,
                      "launch_per_head": launch_per_head,
                      "bytes": kernel.ssd_bytes(BC, H, Q, N, P, 2, 1),
                      "flops": kernel.ssd_flops(BC, H, Q, N, P)},
            "timed_jamba": {"shape": "BC=32, H=128, Q=256, N=16, P=64, "
                                     "bf16, B/C one group stride-0 over "
                                     "128 heads, xdt the model's view "
                                     "(Jamba-v0.1, 4 x 2048 tokens)",
                            "ms": ms_j, "plain_ms": plain_j,
                            "bound_ms": bound_j, "bound_by": by_j,
                            "launch": launch_j}}


def _mamba_invariant(cfg, params, prompts):
    """Full prefill against prefill(S-1) + one decode step: logits and
    the last layer's SSD state."""
    from repro_torch.runtime import serve_step

    P = prompts.shape[1]
    lf, cf = serve_step.build_prefill(cfg)(params, {"tokens": prompts})
    _, cache = serve_step.build_prefill(cfg, max_seq=P)(
        params, {"tokens": prompts[:, :P - 1]})
    ld, cache = serve_step.build_decode(cfg)(
        params, cache, {"token": prompts[:, P - 1], "pos": P - 1})
    sf = cf["b0"]["l0"]["mixer"]["state"][-1]
    sd = cache["b0"]["l0"]["mixer"]["state"][-1]
    return {"layers": cfg.num_layers, "compute_dtype": cfg.compute_dtype,
            "batch": prompts.shape[0], "prompt": P,
            "max_abs_diff": float((lf - ld).abs().max()),
            "max_abs_logit": float(lf.abs().max()),
            "argmax_agreement": float((lf.argmax(-1) == ld.argmax(-1))
                                      .float().mean()),
            "last_layer_state_max_abs_diff": float((sf - sd).abs().max()),
            "last_layer_state_max_abs": float(sf.abs().max())}


def run_mamba_vs_cpu(dev):
    """mamba2-370m at full width and depth, f32: one set of weights from
    one generator serves on the card and on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_map

    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(M.schema(cfg), gen, dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 300)))
    steps = 4
    _counts_zero()
    got = serve.serve(cfg, params, prompts.to(dev), steps + 1)
    launches = _counts()
    t0 = time.monotonic()
    want = serve.serve(cfg, cpu_params, prompts, steps + 1)
    cpu_s = time.monotonic() - t0
    del cpu_params
    scale = float(want.first_logits.abs().max())
    errs = [float((g.cpu() - w).abs().max()) for g, w in (
        (got.first_logits, want.first_logits),
        (got.last_logits, want.last_logits))]
    pre = M.launches_per_pass(cfg, "prefill")
    dec = {k: steps * v for k, v in M.launches_per_pass(cfg, "decode").items()}
    check(all(bool(torch.isfinite(t).all()) for t in (
        got.first_logits, got.last_logits)), "non-finite logits on the card")
    check(max(errs) <= MAMBA_F32_TOL * scale,
          f"card vs CPU logits: {errs} > {MAMBA_F32_TOL} * {scale}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"greedy tokens differ: {got.tokens.tolist()} vs "
          f"{want.tokens.tolist()}")
    check(pre == {"rmsnorm_residual": cfg.num_layers + 1,
                  "ssd_chunk": cfg.num_layers}, f"launches_per_pass {pre}")
    check(got.launches == {"prefill": pre, "decode": dec},
          f"launches {got.launches}, predicted prefill {pre} decode {dec}")
    check(launches == {k: pre.get(k, 0) + dec.get(k, 0) for k in launches},
          f"counted launches {launches}")
    inv = _mamba_invariant(cfg, params, prompts.to(dev))
    check(inv["max_abs_diff"] <= MAMBA_F32_INV * inv["max_abs_logit"],
          f"f32 prefill vs prefill+decode at 48 layers: {inv}")
    return {"phase": "mamba_vs_cpu", "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "compute_dtype": cfg.compute_dtype, "batch": 2, "prompt": 300,
            "decode_steps": steps, "max_abs_logit": scale,
            "logit_max_abs_diff": errs,
            "tolerance": MAMBA_F32_TOL * scale, "tokens_equal": True,
            "launches": got.launches, "invariant": inv,
            "invariant_tolerance_share": MAMBA_F32_INV,
            "card_prefill_s": got.prefill_s, "cpu_s": cpu_s}


def run_mamba_serve(dev):
    """mamba2-370m, full width and depth, bf16: 4 requests of 2048
    prompt tokens and 32 greedy tokens through launch/serve.py's
    functions."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.runtime import serve_step

    cfg = get_config("mamba2-370m")
    B, P, G = 4, 2048, 32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    params = serve.make_params(cfg, dev, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_bytes = torch.cuda.memory_allocated(dev) - base
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = serve.make_prompts(cfg, B, P, rng)
    serve.serve(cfg, params, prompts, 2)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    _counts_zero()
    res = serve.serve(cfg, params, prompts, G)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev) - base

    steps, per_step = res.decode_steps, _check_served(cfg, res, launches,
                                                      B, G)

    on_acts = kernels_on_activations(cfg, params, prompts,
                                     "mamba_kernels_on_activations")

    inv = _mamba_invariant(cfg, params, prompts)
    inv["tolerance_share"] = MAMBA_INV_TOL
    torch.cuda.empty_cache()
    check(inv["max_abs_diff"] <= MAMBA_INV_TOL * inv["max_abs_logit"],
          f"bf16 prefill vs prefill+decode at {cfg.num_layers} layers: "
          f"{inv}")

    # where the time goes
    full = serve_step.build_prefill(cfg, max_seq=P + G)
    decode = serve_step.build_decode(cfg)
    _, cache = full(params, {"tokens": prompts})
    tok = res.tokens[:, 0]
    prof_prefill = by_kind(profile_device(
        lambda: full(params, {"tokens": prompts}), 1), 1)
    prof_decode = by_kind(profile_device(
        lambda: [decode(params, cache, {"token": tok, "pos": P})
                 for _ in range(4)], 4), 4)
    del cache
    total_s = res.prefill_s + res.decode_s
    return {
        "phase": "mamba_serve", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
        "params": count_params(M.schema(cfg)),
        "weights_bytes": weights_bytes, "init_s": init_s,
        "batch": B, "prompt": P, "generated": G, "decode_steps": steps,
        "prefill_ms": res.prefill_s * 1e3,
        "decode_ms_per_step": res.decode_s / steps * 1e3,
        "decode_tokens_per_s": steps * B / res.decode_s,
        "end_to_end_tokens_per_s": G * B / total_s,
        "prefill_tokens_per_s": P * B / res.prefill_s,
        "peak_memory_bytes": peak,
        "launches_per_prefill": res.launches["prefill"],
        "launches_per_decode_step": per_step,
        "launches": launches,
        "kernels_on_activations": on_acts,
        "invariant": inv,
        "profile_prefill": prof_prefill,
        "profile_decode_step": prof_decode,
        "sample_ids": res.tokens[0, :12].tolist(),
    }


def _ssd_bounds(xdt, b, c, csum):
    """The plain version's arithmetic on absolute values: |(C·Bᵀ)∘L|·|xdt|
    and |B·to_end|ᵀ·|xdt| in f32, the scales of ``SSD_ACT_*``."""
    f32 = torch.float32
    cb = torch.einsum("...qn,...tn->...qt", c.to(f32), b.to(f32)).abs_()
    Q = xdt.shape[-2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xdt.device))
    decay = torch.where(mask, torch.exp(csum[..., :, None]
                                        - csum[..., None, :]), 0.0)
    xa = xdt.to(f32).abs()
    ya = torch.einsum("...qt,...tp->...qp", cb.mul_(decay), xa)
    to_end = torch.exp(csum[..., -1:] - csum)
    sa = torch.einsum("...tn,...tp->...np",
                      (b.to(f32) * to_end[..., None]).abs(), xa)
    return ya, sa


def ssd_kernel_entry(ssd, mserved):
    """The kernels-line entry of the SSD chunk kernel, timed at
    mamba2-370m's served prefill shape in ``ssd_vs_plain``; launches from
    the mamba_serve phase's run."""
    from repro_torch.kernels.ssd import kernel

    t = ssd["timed"]
    return {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:51",
        "launches": mserved["launches"]["ssd_chunk"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "ms_per_head": t["ms_per_head"],
        "bound_ms_per_head": t["bound_ms_per_head"],
        "heads_per_cta": t["launch"]["heads_per_cta"],
        "design": kernel.DESIGN,
        "library": "none: no single PyTorch call computes the masked-decay "
                   "chunk and its state",
        "shape": t["shape"],
        "launches_per_prefill": mserved["launches_per_prefill"]["ssd_chunk"],
        "max_abs_err_served": mserved["kernels_on_activations"][
            "ssd_chunk"]["max_abs_diff"],
    }


# ---------------------------------------------------------------------------
# the Jamba slice: MoE and the hybrid period, and the other dense archs
# ---------------------------------------------------------------------------


class MoERecorder:
    """While active, records what every MoE layer's routing did, beside
    the layer's own computation: ``models/moe.py``'s grouped path and
    its einsum group function are wrapped (the model's arithmetic is
    untouched; the routing is computed again from the same inputs).  Per
    layer call: (B, S), each group's capacity C, each token's expert ids
    and the gap between its k-th and (k+1)-th router probability, and
    the (token, expert) assignments dropped, per request."""

    def __init__(self):
        self.layers = []

    def __enter__(self):
        from repro_torch.models import moe

        self._moe = moe
        self._grouped = moe._apply_moe_grouped
        self._group = moe._GROUP_FNS["einsum"]

        def grouped(cfg, p, x):
            self.layers.append({"B": x.shape[0], "S": x.shape[1],
                                "calls": []})
            return self._grouped(cfg, p, x)

        def group(cfg, p, x_g, C):
            k = cfg.moe.top_k
            xf = x_g.to(torch.float32)
            _, idx, mask, _, _ = moe.route(cfg, p, xf)
            probs = torch.softmax(xf @ p["router"].to(torch.float32), -1)
            top = torch.sort(probs, dim=-1, descending=True).values
            dropped = (moe._positions_in_expert(mask) >= C).sum(-1)
            self.layers[-1]["calls"].append(
                (idx.reshape(-1, k), (top[..., k - 1] - top[..., k])
                 .reshape(-1), dropped.reshape(-1), C))
            return self._group(cfg, p, x_g, C)

        moe._apply_moe_grouped = grouped
        moe._GROUP_FNS["einsum"] = group
        return self

    def __exit__(self, *exc):
        self._moe._apply_moe_grouped = self._grouped
        self._moe._GROUP_FNS["einsum"] = self._group
        return False

    def summary(self) -> list[dict]:
        """Per layer call, on the host: ``idx`` (B·S, k), ``gap``
        (B·S), ``C`` per group, ``dropped`` in all and per request."""
        out = []
        for layer in self.layers:
            calls = layer["calls"]
            drop = torch.cat([c[2] for c in calls]).cpu().reshape(
                layer["B"], layer["S"])
            out.append({"idx": torch.cat([c[0] for c in calls]).cpu(),
                        "gap": torch.cat([c[1] for c in calls]).cpu(),
                        "C": [c[3] for c in calls],
                        "dropped": int(drop.sum()),
                        "dropped_per_request": drop.sum(1).tolist()})
        return out


def _split_inputs(params, prompts, inputs):
    """The inputs of the serving invariant's three passes: the full
    prefill, prefill(S-1) and the decode step of position S-1, each with
    its share of the other ``inputs`` (embeddings and M-RoPE positions
    cut at S-1, the frames whole).  Embeddings become the prompt tokens'
    rows of the table, so that the last position may be decoded as a
    token."""
    P = prompts.shape[1]
    extra = dict(inputs or {})
    if "embeds" in extra:
        extra["embeds"] = params["embed"][prompts].to(extra["embeds"].dtype)
    cut = {"embeds": lambda t: t[:, :P - 1],
           "positions": lambda t: t[..., :P - 1]}
    short = {k: cut.get(k, lambda t: t)(v) for k, v in extra.items()}
    step = {"token": prompts[:, P - 1], "pos": P - 1}
    if "positions" in extra:
        step["positions"] = extra["positions"][..., P - 1]
    return ({"tokens": prompts, **extra},
            {"tokens": prompts[:, :P - 1], **short}, step)


def route_turns(full_moe: list[dict], dec_moe: list[dict], B: int,
                S: int) -> dict:
    """{request: [[MoE layer, gap], ...]} where the last position took
    other experts in the decode step than in the full prefill
    (``MoERecorder`` summaries of the two passes: row r·S + S - 1 of the
    full prefill, row r of the step), the gap the smaller of the two
    passes'."""
    turns = {}
    last = torch.arange(B) * S + S - 1
    for layer, (f, d) in enumerate(zip(full_moe, dec_moe)):
        ef = f["idx"][last].sort(-1).values
        ed = d["idx"].sort(-1).values
        gap = torch.minimum(f["gap"][last], d["gap"])
        for r in (ef != ed).any(-1).nonzero().flatten().tolist():
            turns.setdefault(r, []).append([layer, float(gap[r])])
    return turns


def _held_invariant(cfg, params, prompts, tol_share, require=True,
                    inputs=None, near_tie=0.0):
    """The serving invariant (full prefill against prefill(S-1) + one
    decode step, ``_split_inputs``) on the requests that lost no MoE
    assignment in either prefill: a drop changes its own request's
    output and no other's, and the two prefills group their tokens
    differently.  Where ``near_tie`` is above 0, a request whose last
    position took other experts in the decode step than in the full
    prefill at router gaps all below it is left out as well (a caller
    passes the gap that its compute dtype's rounding was shown to turn;
    a turn at a wider gap stays compared).  Returns the figures, the
    difference of every request, the drops of each pass per MoE layer
    and the turned experts; fails if every request is left out, unless
    ``require`` is false (then the figures are ``None`` and
    ``requests_held`` empty)."""
    from repro_torch.runtime import serve_step

    B, P = prompts.shape
    full, short, step = _split_inputs(params, prompts, inputs)
    with MoERecorder() as full_rec:
        lf, _ = serve_step.build_prefill(cfg)(params, full)
    with MoERecorder() as short_rec:
        _, cache = serve_step.build_prefill(cfg, max_seq=P)(params, short)
    with MoERecorder() as dec_rec:
        ld, cache = serve_step.build_decode(cfg)(params, cache, step)
    del cache
    full_moe, short_moe = full_rec.summary(), short_rec.summary()
    drops = {name: [x["dropped_per_request"] for x in rec]
             for name, rec in (("prefill", full_moe),
                               ("prefill_s_minus_1", short_moe))}
    turns = route_turns(full_moe, dec_rec.summary(), B, P)
    near = {r for r, t in turns.items()
            if all(gap < near_tie for _, gap in t)}
    lost = {r for per_layer in drops.values() for layer in per_layer
            for r, n in enumerate(layer) if n} | near
    held = [r for r in range(B) if r not in lost]
    check(len(held) >= 1 or not require,
          f"every request lost an MoE assignment: {drops}")
    diff = (lf.float() - ld.float()).abs().amax(-1)
    scale = lf.float().abs().amax(-1)
    lf, ld = lf[held].float(), ld[held].float()
    inv = {"layers": cfg.num_layers, "compute_dtype": cfg.compute_dtype,
           "batch": B, "prompt": P, "requests_held": held,
           "requests_left_out": B - len(held),
           "max_abs_diff": float((lf - ld).abs().max()) if held else None,
           "max_abs_logit": float(lf.abs().max()) if held else None,
           "tolerance_share": tol_share,
           "argmax_agreement": float((lf.argmax(-1) == ld.argmax(-1))
                                     .float().mean()) if held else None,
           "max_abs_diff_per_request": diff.tolist(),
           "max_abs_logit_per_request": scale.tolist(),
           "dropped_per_layer": drops,
           "experts_turned": turns,
           "near_tie": near_tie,
           "left_out_at_near_tie": sorted(near)}
    if full_moe:
        inv["capacity"] = {"prefill": full_moe[0]["C"],
                           "prefill_s_minus_1": short_moe[0]["C"]}
    return inv


def _jamba_cut(layers: int, dtype: str):
    """Jamba-v0.1 at full width: the whole period (8 layers) or a
    3-layer cut of it with one layer of each kind, in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockDef

    cfg = get_config("jamba-v0.1-52b")
    if layers == 8:
        blocks = (BlockDef(pattern=cfg.blocks[0].pattern, repeat=1),)
    else:
        blocks = (BlockDef(pattern=(("mamba", "dense"), ("mamba", "moe"),
                                    ("attn", "dense")), repeat=1),)
    return dataclasses.replace(cfg, num_layers=layers, blocks=blocks,
                               compute_dtype=dtype, param_dtype=dtype)


def run_jamba_vs_cpu(dev):
    """Jamba-v0.1 at full width, f32 (no TF32), cut to 3 layers that keep
    one of each kind ((mamba, dense), (mamba, moe), (attn, dense), one
    BlockDef): one set of weights from one generator serves on the card
    and on the CPU, B=2, prompt 300 (one full SSD chunk and one padded),
    4 greedy steps."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.params import tree_map

    cfg = _jamba_cut(3, "float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(M.schema(cfg), gen, dev)
    t0 = time.monotonic()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    copy_s = time.monotonic() - t0
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 300)))
    steps = 4
    _counts_zero()
    with MoERecorder() as card_rec:
        got = serve.serve(cfg, params, prompts.to(dev), steps + 1)
    launches = _counts()
    t0 = time.monotonic()
    with MoERecorder() as cpu_rec:
        want = serve.serve(cfg, cpu_params, prompts, steps + 1)
    cpu_s = time.monotonic() - t0
    del cpu_params
    scale = float(want.first_logits.abs().max())
    errs = [float((g.cpu() - w).abs().max()) for g, w in (
        (got.first_logits, want.first_logits),
        (got.last_logits, want.last_logits))]
    pre = M.launches_per_pass(cfg, "prefill")
    dec = {k: steps * v for k, v in M.launches_per_pass(cfg, "decode").items()}
    check(all(bool(torch.isfinite(t).all()) for t in (
        got.first_logits, got.last_logits)), "non-finite logits on the card")
    check(max(errs) <= JAMBA_F32_TOL * scale,
          f"card vs CPU logits: {errs} > {JAMBA_F32_TOL} * {scale}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"greedy tokens differ: {got.tokens.tolist()} vs "
          f"{want.tokens.tolist()}")
    check(pre == {"flash_attention": 1, "rmsnorm_residual": 7,
                  "ssd_chunk": 2}, f"launches_per_pass {pre}")
    check(got.launches == {"prefill": pre, "decode": dec},
          f"launches {got.launches}, predicted prefill {pre} decode {dec}")
    check(launches == {k: pre.get(k, 0) + dec.get(k, 0) for k in launches},
          f"counted launches {launches}")
    # routing: the same experts wherever the choice is not a near-tie,
    # the same drops
    card, cpu = card_rec.summary(), cpu_rec.summary()
    check(len(card) == len(cpu) == 1 + steps,
          f"MoE layer calls {len(card)} card, {len(cpu)} CPU")
    near, compared, drops = 0, 0, []
    for a, b in zip(card, cpu):
        clear = (a["gap"] > ROUTER_GAP) & (b["gap"] > ROUTER_GAP)
        near += int((~clear).sum())
        compared += int(clear.sum())
        check(torch.equal(a["idx"][clear], b["idx"][clear]),
              "expert choices differ between the card and the CPU")
        check(a["dropped"] == b["dropped"] and a["C"] == b["C"],
              f"drops {a['dropped']} (C {a['C']}) on the card, "
              f"{b['dropped']} (C {b['C']}) on the CPU")
        drops.append(a["dropped_per_request"])
    inv = _held_invariant(cfg, params, prompts.to(dev), JAMBA_F32_INV)
    check(inv["max_abs_diff"] <= JAMBA_F32_INV * inv["max_abs_logit"],
          f"f32 prefill vs prefill+decode: {inv}")
    return {"phase": "jamba_vs_cpu", "arch": cfg.name,
            "layers": cfg.num_layers,
            "pattern": [list(k) for k in cfg.blocks[0].pattern],
            "d_model": cfg.d_model, "params": count_params(M.schema(cfg)),
            "compute_dtype": cfg.compute_dtype, "batch": 2, "prompt": 300,
            "decode_steps": steps, "max_abs_logit": scale,
            "logit_max_abs_diff": errs,
            "tolerance": JAMBA_F32_TOL * scale, "tokens_equal": True,
            "launches": got.launches,
            "routing": {"tokens_compared": compared,
                        "near_ties_below_gap": near,
                        "gap": ROUTER_GAP, "experts_equal": True,
                        "capacity_prefill": card[0]["C"],
                        "dropped_per_request_prefill": drops[0],
                        "dropped_decode": sum(map(sum, drops[1:])),
                        "drops_equal": True},
            "invariant": inv, "invariant_tolerance_share": JAMBA_F32_INV,
            "card_prefill_s": got.prefill_s, "cpu_s": cpu_s,
            "copy_to_host_s": copy_s}


def jamba_prefill_flops(cfg, B: int, S: int) -> dict:
    """The matrix products of one prefill of B x S tokens, by part, as
    the model computes them: the experts over every slot of every group
    (2 x 3 x d x d_ff per slot), the dispatch and combine einsums (2 x
    T x E x C x d each per group), the dense MLPs, the Mamba and
    attention projections, causal attention and the last token's
    unembedding."""
    from repro_torch.models import moe

    m, d, N = cfg.moe, cfg.d_model, B * S
    g_eff = min(m.group_size, N)
    n_iter = N // g_eff
    if N % g_eff:
        n_iter, g_eff = 1, N
    C = moe.expert_capacity(g_eff, cfg)
    kinds = [k for b in cfg.blocks for _ in range(b.repeat)
             for k in b.pattern]
    n_moe = sum(mlp == "moe" for _, mlp in kinds)
    n_dense = sum(mlp == "dense" for _, mlp in kinds)
    n_mamba = sum(mix == "mamba" for mix, _ in kinds)
    n_attn = sum(mix == "attn" for mix, _ in kinds)
    d_in = cfg.ssm.d_inner(d)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {
        "experts": n_moe * n_iter * m.num_experts * C * 6 * d * m.d_ff,
        "dispatch_combine": n_moe * n_iter * 2 * 2 * g_eff
        * m.num_experts * C * d,
        "dense_mlp": n_dense * N * 6 * d * cfg.d_ff,
        "mamba_projections": n_mamba * N * 2 * d * (
            3 * d_in + 2 * gn + cfg.ssm.n_heads(d)),
        "attention": n_attn * (N * 2 * d * Dh * (2 * H + 2 * KH)
                               + 4 * B * H * Dh * S * (S + 1) // 2),
        "unembed": B * 2 * d * cfg.vocab_size,
    }
    out["total"] = sum(out.values())
    out["groups"], out["capacity"] = n_iter, C
    return out


def run_jamba_serve(dev):
    """Jamba-v0.1 at full width in bf16 cut to one period (8 layers; 32
    in bf16 are ~103 GB, more than the card holds), 4 requests of 2048
    prompt tokens and 32 greedy tokens through launch/serve.py's
    functions."""
    cfg = _jamba_cut(8, "bfloat16")
    B, P, G = 4, 2048, 32
    params, prompts, res, fig = _serve_cell(dev, cfg, B, P, G,
                                            jamba_prefill_flops)
    check(fig["launches_per_prefill"] == {
        "flash_attention": 1, "rmsnorm_residual": 17, "ssd_chunk": 7},
        f"launches per prefill {fig['launches_per_prefill']}")
    on_acts = kernels_on_activations(cfg, params, prompts,
                                     "jamba_kernels_on_activations")

    # the invariant under the init rule (one attention layer makes its
    # attention near one-hot, ROADMAP caveat 6: printed), then held with
    # well-conditioned attention weights
    inv_drawn = _held_invariant(cfg, params, prompts, SERVE_INV_TOL,
                                near_tie=ROUTER_NEAR_TIE)
    wc = well_conditioned(cfg, params)
    inv = _held_invariant(cfg, wc, prompts, SERVE_INV_TOL,
                          near_tie=ROUTER_NEAR_TIE)
    del wc
    torch.cuda.empty_cache()
    check(inv["max_abs_diff"] <= SERVE_INV_TOL * inv["max_abs_logit"],
          f"bf16 prefill vs prefill+decode at {cfg.num_layers} layers: "
          f"{inv}")
    prof_prefill, prof_decode = _serve_profiles(cfg, params, prompts,
                                                res.tokens[:, 0], G)
    return {
        "phase": "jamba_serve", **fig,
        "reduced": {"num_layers": "32 -> 8 (blocks repeat 4 -> 1: one "
                                  "whole period; 32 layers in bf16 are "
                                  "~103 GB)"},
        "pattern": [list(k) for k in cfg.blocks[0].pattern],
        "kernels_on_activations": on_acts,
        "dropped_per_moe_layer_prefill": inv_drawn["dropped_per_layer"][
            "prefill"],
        "invariant": inv, "invariant_weights": "well_conditioned",
        "invariant_init_rule": inv_drawn,
        "profile_prefill": prof_prefill,
        "profile_decode_step": prof_decode,
    }


def jamba_kernel_fields(dev, bw, f32, bf16, ssd, jserved) -> dict:
    """Each LM kernel's kernels-line fields at Jamba-v0.1's served
    shapes: its launches in ``jamba_serve`` (all, per prefill, per
    decode step), its device ms, the plain version's, the bound and,
    for flash, SDPA's (``enable_gqa``)."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    from repro_torch.kernels.stencil.tune import device_time_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    flash = flash_timing(dev, FLASH_SHAPE_JAMBA, bw, bf16, g)
    flash["shape"] = "B=4, H=32, KH=8, S=2048, D=128, bf16, causal, no " \
                     "RoPE (Jamba-v0.1 prefill, the model's strided views)"
    N, d = RMS_ROWS_JAMBA
    bt = torch.bfloat16
    x = torch.randn((N, d), generator=g, device=dev).to(bt)
    r = torch.randn((N, d), generator=g, device=dev).to(bt)
    sc = 1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
    err, ok = _close(rk.rmsnorm_residual_cuda(x, r, sc),
                     rr.rmsnorm_residual_ref(x, r, sc), *RMS_TOL[bt])
    check(ok, f"rmsnorm at Jamba's rows: {err}")
    rb, rby = bound_ms(rk.rmsnorm_bytes(N, d, 2), rk.rmsnorm_flops(N, d),
                       bw, f32)
    norm = {"ms": device_time_ms(lambda: rk.rmsnorm_residual_cuda(x, r, sc),
                                 100),
            "plain_ms": device_time_ms(
                lambda: rr.rmsnorm_residual_ref(x, r, sc), 20),
            "bound_ms": rb, "bound_by": rby, "library_ms": None,
            "max_abs_err": err,
            "shape": "N=8192, d=4096, bf16 (Jamba-v0.1 prefill rows)"}
    del x, r
    t = ssd["timed_jamba"]
    ssd_f = {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "shape")} | {"library_ms": None}
    out = {}
    for name, f in (("flash_attention", flash), ("rmsnorm_residual", norm),
                    ("ssd_chunk", ssd_f)):
        out[name] = {f"{k}_jamba": v for k, v in f.items()} | {
            "launches_jamba": jserved["launches"][name],
            "launches_jamba_per_prefill":
                jserved["launches_per_prefill"][name],
            "launches_jamba_per_step":
                jserved["launches_per_decode_step"][name],
            "max_abs_err_jamba_served":
                jserved["kernels_on_activations"][name]["max_abs_diff"]}
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# DeepSeek: multi-head latent attention over mixture-of-experts layers
# ---------------------------------------------------------------------------

V2, V3 = "deepseek-v2-236b", "deepseek-v3-671b"
#: deepseek_vs_cpu: f32 logits on the card within this share of max|logit|
#: of the CPU's
DEEPSEEK_F32_TOL = 1e-3


def _deepseek_cut(arch: str, dense: int, moe: int, dtype: str):
    """``arch`` at full width cut to ``dense`` leading (mla, dense) layers
    and ``moe`` (mla, moe) layers (the two blocks of its config, repeats
    cut), in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockDef

    cfg = get_config(arch)
    blocks = (BlockDef(pattern=(("mla", "dense"),), repeat=dense),
              BlockDef(pattern=(("mla", "moe"),), repeat=moe))
    check(tuple(b.pattern for b in cfg.blocks)
          == tuple(b.pattern for b in blocks), f"{arch}: blocks {cfg.blocks}")
    return dataclasses.replace(cfg, num_layers=dense + moe, blocks=blocks,
                               compute_dtype=dtype, param_dtype=dtype)


def _reduced(cfg, cut) -> str:
    full = [b.repeat for b in cfg.blocks]
    return (f"{sum(full)} -> {sum(cut)} layers (blocks repeat "
            f"{' + '.join(map(str, full))} -> {' + '.join(map(str, cut))})")


def run_deepseek_vs_cpu(dev):
    """DeepSeek-V2 at full width, f32 (no TF32), cut to 2 layers (its
    dense layer and one MoE layer): one set of weights from one generator
    serves on the card and on the CPU, B=2, prompt 300 (one MoE group of
    600 tokens, C = 28), 4 greedy steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.params import tree_map

    cfg = _deepseek_cut(V2, 1, 1, "float32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(M.schema(cfg), gen, dev)
    t0 = time.monotonic()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    copy_s = time.monotonic() - t0
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 300)))
    steps = 4
    _counts_zero()
    with MoERecorder() as card_rec:
        got = serve.serve(cfg, params, prompts.to(dev), steps + 1)
    launches = _counts()
    t0 = time.monotonic()
    with MoERecorder() as cpu_rec:
        want = serve.serve(cfg, cpu_params, prompts, steps + 1)
    cpu_s = time.monotonic() - t0
    del cpu_params
    scale = float(want.first_logits.abs().max())
    errs = [float((g.cpu() - w).abs().max()) for g, w in (
        (got.first_logits, want.first_logits),
        (got.last_logits, want.last_logits))]
    pre = M.launches_per_pass(cfg, "prefill")
    dec = {k: steps * v for k, v in M.launches_per_pass(cfg, "decode").items()}
    check(all(bool(torch.isfinite(t).all()) for t in (
        got.first_logits, got.last_logits)), "non-finite logits on the card")
    check(max(errs) <= DEEPSEEK_F32_TOL * scale,
          f"card vs CPU logits: {errs} > {DEEPSEEK_F32_TOL} * {scale}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"greedy tokens differ: {got.tokens.tolist()} vs "
          f"{want.tokens.tolist()}")
    check(pre == {"flash_attention": 2, "rmsnorm_residual": 5},
          f"launches_per_pass {pre}")
    check(got.launches == {"prefill": pre, "decode": dec},
          f"launches {got.launches}, predicted prefill {pre} decode {dec}")
    check(launches == {k: pre.get(k, 0) + dec.get(k, 0) for k in launches},
          f"counted launches {launches}")
    card, cpu = card_rec.summary(), cpu_rec.summary()
    check(len(card) == len(cpu) == 1 + steps,
          f"MoE layer calls {len(card)} card, {len(cpu)} CPU")
    near, compared, drops = 0, 0, []
    for a, b in zip(card, cpu):
        clear = (a["gap"] > ROUTER_GAP) & (b["gap"] > ROUTER_GAP)
        near += int((~clear).sum())
        compared += int(clear.sum())
        check(torch.equal(a["idx"][clear], b["idx"][clear]),
              "expert choices differ between the card and the CPU")
        check(a["dropped"] == b["dropped"] and a["C"] == b["C"],
              f"drops {a['dropped']} (C {a['C']}) on the card, "
              f"{b['dropped']} (C {b['C']}) on the CPU")
        drops.append(a["dropped_per_request"])
    return {"phase": "deepseek_vs_cpu", "arch": cfg.name,
            "layers": cfg.num_layers,
            "reduced": _reduced(get_config(V2), (1, 1)),
            "d_model": cfg.d_model, "params": count_params(M.schema(cfg)),
            "compute_dtype": cfg.compute_dtype, "batch": 2, "prompt": 300,
            "decode_steps": steps, "max_abs_logit": scale,
            "logit_max_abs_diff": errs,
            "tolerance": DEEPSEEK_F32_TOL * scale, "tokens_equal": True,
            "launches": got.launches,
            "routing": {"top_k": cfg.moe.top_k,
                        "tokens_compared": compared,
                        "near_ties_below_gap": near,
                        "gap": ROUTER_GAP, "experts_equal": True,
                        "capacity_prefill": card[0]["C"],
                        "dropped_per_request_prefill": drops[0],
                        "dropped_decode": sum(map(sum, drops[1:])),
                        "drops_equal": True},
            "card_prefill_s": got.prefill_s, "cpu_s": cpu_s,
            "copy_to_host_s": copy_s}


def deepseek_prefill_flops(cfg, B: int, S: int) -> dict:
    """The matrix products of one DeepSeek prefill of B x S tokens, by
    part, as the model computes them: MLA's projections (wq_a, wq_b,
    wkv_a, wkv_b, wo) and its causal attention (q·k over nope + rope,
    p·v over v), the dense layers' MLPs, the routed experts over every
    slot of every group (2 x 3 x d x d_ff per slot), the shared experts,
    the router, the dispatch and combine einsums (2 x T x E x C x d each
    per group) and the last token's unembedding."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import moe

    m, a, d, N = cfg.moe, cfg.mla, cfg.d_model, B * S
    g_eff = min(m.group_size, N)
    n_iter = N // g_eff
    if N % g_eff:
        n_iter, g_eff = 1, N
    C = moe.expert_capacity(g_eff, cfg)
    kinds = [k for b in cfg.blocks for _ in range(b.repeat)
             for k in b.pattern]
    n_moe = sum(mlp == "moe" for _, mlp in kinds)
    n_dense = sum(mlp == "dense" for _, mlp in kinds)
    H, qk = cfg.num_heads, a.qk_nope_head_dim + a.qk_rope_head_dim
    q_proj = (d * a.q_lora_rank + a.q_lora_rank * H * qk if a.q_lora_rank
              else d * H * qk)
    per_token = (q_proj + d * (a.kv_lora_rank + a.qk_rope_head_dim)
                 + a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim)
                 + H * a.v_head_dim * d)
    E = m.num_experts
    out = {
        "mla_projections": len(kinds) * N * 2 * per_token,
        "attention": len(kinds) * fk.attention_flops(
            B, H, S, qk, True, a.v_head_dim),
        "dense_mlp": n_dense * N * 6 * d * cfg.d_ff,
        "experts": n_moe * n_iter * E * C * 6 * d * m.d_ff,
        "shared_experts": n_moe * N * 6 * d * m.num_shared_experts * m.d_ff,
        "router": n_moe * N * 2 * d * E,
        "dispatch_combine": n_moe * n_iter * 2 * 2 * g_eff * E * C * d,
        "unembed": B * 2 * d * cfg.vocab_size,
    }
    out["total"] = sum(out.values())
    out["groups"], out["capacity"] = n_iter, C
    return out


def _serve_cell(dev, cfg, B, P, G, prefill_flops):
    """A MoE model served on the card through launch/serve.py's
    functions: weights drawn on the card, a warm-up serve of 2 tokens
    under a ``MoERecorder``, then the timed ``serve`` of G tokens with
    the launches counted and held to ``launches_per_pass``.  Returns
    (params, prompts, result, figures): times against their bounds (the
    prefill's products by ``prefill_flops(cfg, B, P)``, the weights'
    bytes per decode step), tokens/s, peak memory, launches, and the
    warm-up prefill's routing and drops per MoE layer."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    params = serve.make_params(cfg, dev, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_bytes = torch.cuda.memory_allocated(dev) - base
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = serve.make_prompts(cfg, B, P, rng)
    with MoERecorder() as rec:
        serve.serve(cfg, params, prompts, 2)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _counts_zero()
    res = serve.serve(cfg, params, prompts, G)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev) - base

    steps, per_step = res.decode_steps, _check_served(cfg, res, launches,
                                                      B, G)
    # the warm-up's prefill, then its decode step, layer by layer
    n_moe = sum(b.repeat * sum(mlp == "moe" for _, mlp in b.pattern)
                for b in cfg.blocks)
    moe = rec.summary()
    check(len(moe) == 2 * n_moe, f"MoE layer calls {len(moe)}")
    moe = moe[:n_moe]
    bw, _, bf16 = peaks_for(torch.cuda.get_device_name(0))
    flops = prefill_flops(cfg, B, P)
    total_s = res.prefill_s + res.decode_s
    fig = {
        "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
        "params": count_params(M.schema(cfg)),
        "weights_bytes": weights_bytes, "init_s": init_s,
        "batch": B, "prompt": P, "generated": G, "decode_steps": steps,
        "prefill_ms": res.prefill_s * 1e3,
        "decode_ms_per_step": res.decode_s / steps * 1e3,
        "decode_tokens_per_s": steps * B / res.decode_s,
        "end_to_end_tokens_per_s": G * B / total_s,
        "prefill_tokens_per_s": P * B / res.prefill_s,
        "prefill_flops": flops,
        "prefill_bound_ms": flops["total"] / bf16 * 1e3,
        "decode_bound_ms": weights_bytes / bw * 1e3,
        "peak_memory_bytes": peak,
        "launches_per_prefill": res.launches["prefill"],
        "launches_per_decode_step": per_step,
        "launches": launches,
        "routing_prefill": {
            "top_k": cfg.moe.top_k, "experts": cfg.moe.num_experts,
            "capacity": moe[0]["C"],
            "dropped_per_moe_layer": [x["dropped"] for x in moe],
            "dropped_per_request": [x["dropped_per_request"] for x in moe],
            "expert_load_max": [int(torch.bincount(
                x["idx"].reshape(-1), minlength=cfg.moe.num_experts).max())
                for x in moe]},
        "sample_ids": res.tokens[0, :12].tolist(),
    }
    return params, prompts, res, fig


def _serve_profiles(cfg, params, prompts, tok, G):
    """Profiles of one prefill into a cache of P + G positions and of 4
    decode steps at position P, by kind (``by_kind``)."""
    from repro_torch.runtime import serve_step

    P = prompts.shape[1]
    full = serve_step.build_prefill(cfg, max_seq=P + G)
    decode = serve_step.build_decode(cfg)
    _, cache = full(params, {"tokens": prompts})
    prof_prefill = by_kind(profile_device(
        lambda: full(params, {"tokens": prompts}), 1), 1)
    prof_decode = by_kind(profile_device(
        lambda: [decode(params, cache, {"token": tok, "pos": P})
                 for _ in range(4)], 4), 4)
    return prof_prefill, prof_decode


def _scan_ms(profile: dict) -> float:
    """Device ms of the MoE queue's cumulative sums in a profile."""
    return sum(ms for name, ms in profile["by_kernel_ms"].items()
               if "scan" in name.lower())


def held_against_plain_norm(cfg, params, prompts) -> dict:
    """The bf16 serving invariant (``_held_invariant``) as served, the
    norm's kernel in every layer, and again with the norm's plain
    version in its place, on the same weights and prompts; each read on
    the requests both runs hold, as a share of their max|logit|.  Fails
    unless the kernel's share is within ``SERVE_INV_TOL`` or within the
    plain version's share plus ``NORM_FORM_SHARE``.  The norm is the one
    hand-written kernel on the decode step; the path's own code is held
    to the JAX package by tests/test_torch_deepseek.py."""
    from repro_torch.kernels.rmsnorm import ref
    from repro_torch.models import transformer as tm

    inv = _held_invariant(cfg, params, prompts, SERVE_INV_TOL)
    kept = tm.rmsnorm_residual
    tm.rmsnorm_residual = ref.rmsnorm_residual_ref
    try:
        plain = _held_invariant(cfg, params, prompts, SERVE_INV_TOL)
    finally:
        tm.rmsnorm_residual = kept
    both = sorted(set(inv["requests_held"]) & set(plain["requests_held"]))
    check(len(both) >= 1, f"no request held by both the kernel's and the "
                          f"plain norm's runs: {inv} {plain}")

    def share(run):
        return max(run["max_abs_diff_per_request"][r] for r in both) / max(
            run["max_abs_logit_per_request"][r] for r in both)

    got, want = share(inv), share(plain)
    inv |= {"requests_compared_with_plain": both, "share": got,
            "plain_norm_share": want, "norm_form_share": NORM_FORM_SHARE,
            "plain_norm_requests_held": plain["requests_held"]}
    check(got <= max(SERVE_INV_TOL, want + NORM_FORM_SHARE),
          f"bf16 prefill vs prefill+decode at {cfg.num_layers} layers: "
          f"{got} of max|logit|, the plain norm's {want}: {inv}")
    return inv


def run_deepseek_serve(dev):
    """DeepSeek-V2 at full width in bf16 cut to 4 layers (its dense layer
    and 3 MoE layers; 60 in bf16 are ~471 GB) through launch/serve.py's
    functions: 4 requests of 2048 prompt tokens (one MoE group of 8192,
    C = 384) and 32 greedy tokens, with prefill and decode times against
    their bounds, tokens/s, peak memory, launches, routing and drops, a
    profile of each phase by kind with the MoE ranges, every flash and
    norm call of one prefill and decode step held to its plain version,
    and the 4-layer bf16 invariant (held under the init rule, printed
    with ``well_conditioned`` MLA weights).  Then DeepSeek-V3 at full
    width cut to 2 layers (one
    dense, one MoE; the MTP head drawn, unused in serving): a prefill and
    8 decode steps at 4 x 2048, 256 experts top-8, the norm at d =
    7168."""
    from repro_torch.configs import get_config

    B, P, G = 4, 2048, 32
    cfg = _deepseek_cut(V2, 1, 3, "bfloat16")
    params, prompts, res, v2 = _serve_cell(dev, cfg, B, P, G,
                                           deepseek_prefill_flops)
    check(res.launches["prefill"] == {"flash_attention": 4,
                                      "rmsnorm_residual": 9},
          f"V2 prefill launches {res.launches['prefill']}")
    on_acts = kernels_on_activations(cfg, params, prompts,
                                     "deepseek_kernels_on_activations")
    # the invariant is held under the init rule: MLA's q.k runs through
    # normed latents (a score std of ~6 by the init rule's fan-ins at
    # these widths, not the hundreds of Yi's one-hot attention, ROADMAP
    # caveat 6).  With well_conditioned weights the attention is
    # diffuse at init, the tokens of a request share one direction and
    # route alike, and every request loses assignments: printed
    inv = held_against_plain_norm(cfg, params, prompts)
    wc = well_conditioned(cfg, params)
    inv_wc = _held_invariant(cfg, wc, prompts, SERVE_INV_TOL,
                             require=False)
    del wc
    torch.cuda.empty_cache()
    prof_prefill, prof_decode = _serve_profiles(cfg, params, prompts,
                                                res.tokens[:, 0], G)
    del params
    torch.cuda.empty_cache()
    v2 |= {"reduced": _reduced(get_config(V2), (1, 3)),
           "kernels_on_activations": on_acts,
           "invariant": inv, "invariant_weights": "init rule",
           "invariant_well_conditioned": inv_wc,
           "profile_prefill": prof_prefill,
           "profile_decode_step": prof_decode,
           "moe_scan_ms_prefill": _scan_ms(prof_prefill)}

    cfg3 = _deepseek_cut(V3, 1, 1, "bfloat16")
    params, prompts, _, v3 = _serve_cell(dev, cfg3, B, P, 9,
                                         deepseek_prefill_flops)
    check(v3["launches_per_prefill"] == {"flash_attention": 2,
                                         "rmsnorm_residual": 5},
          f"V3 prefill launches {v3['launches_per_prefill']}")
    check("mtp" in params, "V3's MTP head was not drawn")
    v3["kernels_on_activations"] = kernels_on_activations(
        cfg3, params, prompts, "deepseek_v3_kernels_on_activations")
    v3["reduced"] = _reduced(get_config(V3), (1, 1))
    del params
    torch.cuda.empty_cache()
    return {"phase": "deepseek_serve", "v2": v2, "v3": v3}


def deepseek_kernel_fields(dev, bw, f32, bf16, dserved) -> dict:
    """The flash and norm kernels' kernels-line fields at DeepSeek's
    served shapes: their launches in ``deepseek_serve`` (V2: all, per
    prefill, per decode step; V3 per prefill), flash's device ms, plain
    ms, bound and SDPA ms at (4, 128, 128, 2048, 192 / 128) and the
    norm's at 8192 rows of d = 5120 (V2) and 7168 (V3)."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    from repro_torch.kernels.stencil.tune import device_time_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    flash = flash_timing(dev, FLASH_SHAPE_MLA, bw, bf16, g)
    flash["shape"] = "B=4, H=KH=128, S=2048, q.k 192, v 128 (the strided " \
                     "half of the wkv_b product), bf16, causal (DeepSeek-V2 " \
                     "prefill, the model's views)"
    torch.cuda.empty_cache()
    norms = {}
    bt = torch.bfloat16
    for tag, (N, d) in zip(("v2", "v3"), RMS_ROWS_DEEPSEEK):
        x = torch.randn((N, d), generator=g, device=dev).to(bt)
        r = torch.randn((N, d), generator=g, device=dev).to(bt)
        sc = 1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
        err, ok = _close(rk.rmsnorm_residual_cuda(x, r, sc),
                         rr.rmsnorm_residual_ref(x, r, sc), *RMS_TOL[bt])
        check(ok, f"rmsnorm at DeepSeek's rows {N}x{d}: {err}")
        rb, rby = bound_ms(rk.rmsnorm_bytes(N, d, 2),
                           rk.rmsnorm_flops(N, d), bw, f32)
        norms[tag] = {
            "ms": device_time_ms(
                lambda: rk.rmsnorm_residual_cuda(x, r, sc), 100),
            "plain_ms": device_time_ms(
                lambda: rr.rmsnorm_residual_ref(x, r, sc), 20),
            "bound_ms": rb, "bound_by": rby, "library_ms": None,
            "max_abs_err": err,
            "shape": f"N={N}, d={d}, bf16 (DeepSeek-{tag.upper()} prefill "
                     f"rows)"}
        del x, r
    v2, v3 = dserved["v2"], dserved["v3"]
    out = {}
    for name, fields in (("flash_attention", {"mla": flash}),
                         ("rmsnorm_residual", {"deepseek_v2": norms["v2"],
                                               "deepseek_v3": norms["v3"]})):
        out[name] = {f"{k}_{tag}": v for tag, f in fields.items()
                     for k, v in f.items()} | {
            "launches_deepseek": v2["launches"][name],
            "launches_deepseek_per_prefill":
                v2["launches_per_prefill"][name],
            "launches_deepseek_per_step": v2["launches_per_decode_step"][name],
            "launches_deepseek_v3_per_prefill":
                v3["launches_per_prefill"][name],
            "max_abs_err_deepseek_served":
                v2["kernels_on_activations"][name]["max_abs_diff"]}
    torch.cuda.empty_cache()
    return out


#: dense_vs_cpu: the dense archs beside Yi-6B, each in serve_vs_cpu's form
DENSE_ARCHS = ("yi-9b", "granite-8b", "minitron-8b")


def run_dense_vs_cpu(dev):
    """Yi-9B, Granite-8B and Minitron-8B (squared ReLU) at full width, 2
    layers, f32: card against CPU as ``serve_vs_cpu``."""
    out = []
    for arch in DENSE_ARCHS:
        rec = run_serve_vs_cpu(dev, arch)
        rec.pop("phase")
        out.append(rec)
        torch.cuda.empty_cache()
    return {"phase": "dense_vs_cpu", "tolerance_share": SERVE_F32_TOL,
            "archs": out}


# ---------------------------------------------------------------------------
# whisper-large-v3 (encoder, cross-attention, layernorm) and qwen2-vl-72b
# (M-RoPE over patch embeddings)
# ---------------------------------------------------------------------------

WHISPER, QWEN2VL = "whisper-large-v3", "qwen2-vl-72b"
#: encdec_vs_cpu / qwen2vl_vs_cpu: f32 logits on the card within this
#: share of max|logit| of the CPU's
ENCDEC_F32_TOL = 1e-4
QWEN2VL_F32_TOL = 1e-4
#: qwen2-vl's prompts: 16 text tokens, one image of 16 x 16 merged
#: patches, then text (``launch/serve.py::image_positions``)
QWEN2VL_IMAGE = (16, 16, 16)


def _whisper_cut(layers: int, dtype: str):
    """whisper-large-v3 at full width with ``layers`` encoder and
    ``layers`` decoder layers, in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockDef

    cfg = get_config(WHISPER)
    return dataclasses.replace(
        cfg, num_layers=layers, encoder_layers=layers,
        blocks=(BlockDef(pattern=cfg.blocks[0].pattern, repeat=layers),),
        compute_dtype=dtype, param_dtype=dtype)


def _qwen2vl_cut(layers: int, dtype: str):
    import dataclasses

    from repro_torch.configs import dense_blocks, get_config

    return dataclasses.replace(get_config(QWEN2VL), num_layers=layers,
                               blocks=dense_blocks(layers),
                               compute_dtype=dtype, param_dtype=dtype)


def _vlm_inputs(cfg, B, P, rng):
    """``make_inputs`` with the image's M-RoPE positions in place of the
    JAX CLI's one arange (which is RoPE itself and would hide a mix-up
    of the sections)."""
    from repro_torch.launch import serve

    inputs = serve.make_inputs(cfg, B, P, rng)
    t, h, w = QWEN2VL_IMAGE
    inputs["positions"] = serve.image_positions(B, t, h, w, P - t - h * w,
                                                rng.device)
    return inputs


def _card_vs_cpu(dev, cfg, B, P, steps, tol, make_inputs, init_rule=False):
    """One set of weights from one generator, with ``well_conditioned``
    attention projections, serves on the card and on the CPU (f32, no
    TF32): the first and last logits within ``tol`` of max|logit|,
    identical greedy tokens, launches as predicted.  Under the init rule
    itself the attention is near one-hot (scores with a std of ~64 at
    whisper's widths, ~128 at qwen2-vl's), and an f32 rounding that
    flips a near tie among 1500 frames moves a row by O(1): with
    ``init_rule`` the figures under it are printed too, not held."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.params import tree_map

    gen = torch.Generator(device=dev).manual_seed(SEED)
    init = init_params(M.schema(cfg), gen, dev)
    params = well_conditioned(cfg, init)
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = serve.make_prompts(cfg, B, P, rng)
    inputs = make_inputs(cfg, B, P, rng)
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}

    def errors(got, want):
        return [float((g.cpu() - w).abs().max()) for g, w in (
            (got.first_logits, want.first_logits),
            (got.last_logits, want.last_logits))]

    extra = {}
    if init_rule:
        a = serve.serve(cfg, init, prompts, steps + 1, inputs=inputs)
        b = serve.serve(cfg, tree_map(lambda t: t.cpu(), init),
                        prompts.cpu(), steps + 1, inputs=cpu_inputs)
        extra["init_rule"] = {
            "logit_max_abs_diff": errors(a, b),
            "max_abs_logit": float(b.first_logits.abs().max()),
            "tokens_equal": bool(torch.equal(a.tokens.cpu(), b.tokens))}
        del a, b
    del init
    t0 = time.monotonic()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    copy_s = time.monotonic() - t0
    _counts_zero()
    got = serve.serve(cfg, params, prompts, steps + 1, inputs=inputs)
    launches = _counts()
    del params
    t0 = time.monotonic()
    want = serve.serve(cfg, cpu_params, prompts.cpu(), steps + 1,
                       inputs=cpu_inputs)
    cpu_s = time.monotonic() - t0
    del cpu_params
    torch.cuda.empty_cache()
    scale = float(want.first_logits.abs().max())
    errs = errors(got, want)
    pre = M.launches_per_pass(cfg, "prefill")
    dec = {k: steps * v for k, v in M.launches_per_pass(cfg, "decode").items()}
    check(all(bool(torch.isfinite(t).all()) for t in (
        got.first_logits, got.last_logits)), "non-finite logits on the card")
    check(max(errs) <= tol * scale,
          f"{cfg.name}: card vs CPU logits {errs} > {tol} * {scale}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"{cfg.name}: greedy tokens differ: {got.tokens.tolist()} vs "
          f"{want.tokens.tolist()}")
    check(got.launches == {"prefill": pre, "decode": dec},
          f"launches {got.launches}, predicted prefill {pre} decode {dec}")
    check(launches == {k: pre.get(k, 0) + dec.get(k, 0) for k in launches},
          f"counted launches {launches}")
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
            "params": count_params(M.schema(cfg)),
            "compute_dtype": cfg.compute_dtype, "batch": B, "prompt": P,
            "decode_steps": steps, "max_abs_logit": scale,
            "logit_max_abs_diff": errs, "logit_share": max(errs) / scale,
            "tolerance": tol * scale, "tokens_equal": True,
            "weights": "well_conditioned",
            "launches": got.launches, "card_prefill_s": got.prefill_s,
            "cpu_s": cpu_s, "copy_to_host_s": copy_s, **extra}


def run_encdec_vs_cpu(dev):
    """whisper-large-v3 at full width, 4 encoder and 4 decoder layers,
    f32: B=2, 1500 frames, a 32-token prompt, 8 greedy steps, card
    against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = _whisper_cut(4, "float32")
    rec = _card_vs_cpu(dev, cfg, 2, 32, 8, ENCDEC_F32_TOL, serve.make_inputs,
                       init_rule=True)
    check(rec["launches"]["prefill"] == {"flash_attention": 12,
                                         "rmsnorm_residual": 0},
          f"whisper prefill launches {rec['launches']['prefill']}")
    full = get_config(WHISPER)
    return {"phase": "encdec_vs_cpu", "frames": cfg.encoder_frames,
            "reduced": f"{full.encoder_layers} + {full.num_layers} -> 4 + 4 "
                       f"layers", **rec}


def run_qwen2vl_vs_cpu(dev):
    """qwen2-vl-72b at full width cut to 2 layers, f32: B=1, 512
    embedding positions of one image's prompt (the M-RoPE rows differ),
    8 greedy steps whose positions trail the cache index, card against
    CPU."""
    from repro_torch.configs import get_config

    cfg = _qwen2vl_cut(2, "float32")
    rec = _card_vs_cpu(dev, cfg, 1, 512, 8, QWEN2VL_F32_TOL, _vlm_inputs)
    check(rec["launches"]["prefill"] == {"flash_attention": 2,
                                         "rmsnorm_residual": 5},
          f"qwen2-vl prefill launches {rec['launches']['prefill']}")
    t, h, w = QWEN2VL_IMAGE
    return {"phase": "qwen2vl_vs_cpu",
            "reduced": f"{get_config(QWEN2VL).num_layers} -> 2 layers",
            "image": {"text_before": t, "grid": [h, w],
                      "text_after": 512 - t - h * w,
                      "first_decode_position": t + max(h, w)
                      + 512 - t - h * w, "first_decode_index": 512},
            **rec}


def whisper_prefill_flops(cfg, B: int, P: int) -> dict:
    """The matrix products of one whisper prefill of B requests of
    ``encoder_frames`` frames and P prompt tokens, by part: the encoder's
    projections and MLPs and its non-causal attention, the decoder's
    cross k/v projections over the frames, its other projections and
    MLPs, its causal self-attention, its cross-attention (P queries
    against the frames) and the last token's unembedding."""
    from repro_torch.kernels.flash_attention import kernel as fk

    d, f, F = cfg.d_model, cfg.d_ff, cfg.encoder_frames
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E, L = cfg.encoder_layers, cfg.num_layers
    attn = d * (H + 2 * KH) * Dh + H * Dh * d
    mlp = (3 if cfg.mlp_act == "swiglu" else 2) * d * f
    out = {
        "encoder_matrices": E * B * F * 2 * (attn + mlp),
        "encoder_attention": E * fk.attention_flops(B, H, F, Dh, False),
        "cross_kv": L * B * F * 2 * 2 * d * KH * Dh,
        "decoder_matrices": L * B * P * 2 * (attn + 2 * d * H * Dh + mlp),
        "decoder_attention": L * fk.attention_flops(B, H, P, Dh, True),
        "cross_attention": L * fk.attention_flops(B, H, P, Dh, False,
                                                  sk=F),
        "unembed": B * 2 * d * cfg.vocab_size,
    }
    out["total"] = sum(out.values())
    return out


def qwen2vl_prefill_flops(cfg, B: int, P: int) -> dict:
    """The matrix products of one dense GQA prefill of B x P positions:
    the projections and SwiGLU MLPs, the causal attention and the last
    token's unembedding."""
    from repro_torch.kernels.flash_attention import kernel as fk

    d, H, KH, Dh, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.num_layers)
    out = {
        "matrices": L * B * P * 2 * (d * (H + 2 * KH) * Dh + H * Dh * d
                                     + 3 * d * cfg.d_ff),
        "attention": L * fk.attention_flops(B, H, P, Dh, True),
        "unembed": B * 2 * d * cfg.vocab_size,
    }
    out["total"] = sum(out.values())
    return out


def decode_read_bytes(cfg, params, cache) -> int:
    """Least bytes one decode step reads: every weight it uses once (not
    the encoder's, not the cross k/v projections, which prefill alone
    runs, and of an untied token table only the B rows it looks up) and
    the whole cache (the step attends over every position, masked)."""
    from repro_torch.models.params import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    total = nbytes({k: v for k, v in params.items()
                    if k not in ("encoder", "mtp")})
    if not cfg.tie_embeddings:
        total -= nbytes(params["embed"])
    if cfg.cross_attention:
        for blk in (v for k, v in params.items() if k.startswith("b")):
            for layer in blk.values():
                total -= nbytes({k: layer["cross"][k] for k in ("wk", "wv")})
    return total + nbytes(cache)


class LayerNormRanges:
    """Opens the profiler range ``layernorm`` around every
    ``models/layers.py::layer_norm`` call while it is entered, so a
    profile shows layernorm's device time (its plain torch ops)."""

    def __enter__(self):
        from repro_torch.models import layers

        self._layers, self._fn = layers, layers.layer_norm

        def layer_norm(*a, **kw):
            with torch.profiler.record_function("layernorm"):
                return self._fn(*a, **kw)

        layers.layer_norm = layer_norm
        return self

    def __exit__(self, *exc):
        self._layers.layer_norm = self._fn


def _lm_serve_cell(dev, cfg, B, P, G, prefill_flops, make_inputs,
                   phase_acts):
    """A dense model served on the card through launch/serve.py's
    functions, its stubbed frontend's inputs from ``make_inputs``:
    weights drawn on the card, a warm-up serve of 2 tokens, the timed
    serve of G tokens with the launches counted and held to
    ``launches_per_pass``, every kernel call of one prefill and decode
    step held to its plain version on the served activations, the bf16
    invariant (``_held_invariant``) within ``SERVE_INV_TOL`` with
    ``well_conditioned`` attention weights (the init rule's figure
    printed beside it), and profiles of a prefill and of 4 decode steps
    by kind, with layernorm's range.  Times against their bounds: the
    prefill's products (``prefill_flops``) at the bf16 peak, the bytes a
    decode step reads (``decode_read_bytes``) at the memory rate."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.runtime import serve_step

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    params = serve.make_params(cfg, dev, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weights_bytes = torch.cuda.memory_allocated(dev) - base
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = serve.make_prompts(cfg, B, P, rng)
    inputs = make_inputs(cfg, B, P, rng)
    serve.serve(cfg, params, prompts, 2, inputs=inputs)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _counts_zero()
    res = serve.serve(cfg, params, prompts, G, inputs=inputs)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev) - base

    steps, per_step = res.decode_steps, _check_served(cfg, res, launches,
                                                      B, G)

    on_acts = kernels_on_activations(cfg, params, prompts, phase_acts,
                                     inputs)
    wc = well_conditioned(cfg, params)
    inv = _held_invariant(cfg, wc, prompts, SERVE_INV_TOL, inputs=inputs)
    del wc
    check(inv["max_abs_diff"] <= SERVE_INV_TOL * inv["max_abs_logit"],
          f"bf16 prefill vs prefill+decode at {cfg.num_layers} layers: "
          f"{inv}")
    inv_init = _held_invariant(cfg, params, prompts, SERVE_INV_TOL,
                               inputs=inputs)
    torch.cuda.empty_cache()

    full = serve_step.build_prefill(cfg, max_seq=P + G)
    decode = serve_step.build_decode(cfg)
    _, cache = full(params, {"tokens": prompts, **inputs})
    step = {"token": res.tokens[:, 0], "pos": P}
    if "positions" in inputs:
        step["positions"] = (inputs["positions"].amax(dim=(1, 2))
                             + 1)[:, None].expand(-1, 3)
    read_bytes = decode_read_bytes(cfg, params, cache)
    with LayerNormRanges():
        prof_prefill = by_kind(profile_device(
            lambda: full(params, {"tokens": prompts, **inputs}), 1), 1)
        prof_decode = by_kind(profile_device(
            lambda: [decode(params, cache, step) for _ in range(4)], 4), 4)
    del cache, params
    torch.cuda.empty_cache()
    bw, _, bf16 = peaks_for(torch.cuda.get_device_name(0))
    flops = prefill_flops(cfg, B, P)
    total_s = res.prefill_s + res.decode_s
    return {
        "arch": cfg.name, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
        "compute_dtype": cfg.compute_dtype,
        "params": count_params(M.schema(cfg)),
        "weights_bytes": weights_bytes, "init_s": init_s,
        "batch": B, "prompt": P, "generated": G, "decode_steps": steps,
        "prefill_ms": res.prefill_s * 1e3,
        "decode_ms_per_step": res.decode_s / steps * 1e3,
        "decode_tokens_per_s": steps * B / res.decode_s,
        "end_to_end_tokens_per_s": G * B / total_s,
        "prefill_tokens_per_s": P * B / res.prefill_s,
        "prefill_flops": flops,
        "prefill_bound_ms": flops["total"] / bf16 * 1e3,
        "decode_read_bytes": read_bytes,
        "decode_bound_ms": read_bytes / bw * 1e3,
        "peak_memory_bytes": peak,
        "peak_memory_gb": peak / 1e9,
        "launches_per_prefill": res.launches["prefill"],
        "launches_per_decode_step": per_step,
        "launches": launches,
        "kernels_on_activations": on_acts,
        "invariant": inv, "invariant_weights": "well_conditioned",
        "invariant_init_rule": inv_init,
        "profile_prefill": prof_prefill,
        "profile_decode_step": prof_decode,
        "sample_ids": res.tokens[0, :12].tolist(),
    }


def run_whisper_serve(dev):
    """whisper-large-v3 whole (32 + 32 layers) in bf16: B=8 requests of
    1500 frames and a 128-token prompt, 64 greedy tokens (max_seq 192,
    inside whisper's 448-token decoder context)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = _whisper_cut(32, "bfloat16")
    check(cfg.num_layers == get_config(WHISPER).num_layers
          and cfg.encoder_layers == get_config(WHISPER).encoder_layers,
          "whisper_serve runs the whole model")
    rec = _lm_serve_cell(dev, cfg, 8, 128, 64, whisper_prefill_flops,
                         serve.make_inputs, "whisper_kernels_on_activations")
    check(rec["launches_per_prefill"] == {"flash_attention": 96,
                                          "rmsnorm_residual": 0},
          f"whisper prefill launches {rec['launches_per_prefill']}")
    return {"phase": "whisper_serve", "frames": cfg.encoder_frames,
            "max_seq": 128 + 64, **rec}


def run_qwen2vl_serve(dev):
    """qwen2-vl-72b at full width in bf16 cut to 4 of 80 layers (80 are
    145 GB): B=4 prompts of 2048 embedding positions (one image each,
    the M-RoPE rows differ), 32 greedy tokens."""
    from repro_torch.configs import get_config

    cfg = _qwen2vl_cut(4, "bfloat16")
    rec = _lm_serve_cell(dev, cfg, 4, 2048, 32, qwen2vl_prefill_flops,
                         _vlm_inputs, "qwen2vl_kernels_on_activations")
    check(rec["launches_per_prefill"] == {"flash_attention": 4,
                                          "rmsnorm_residual": 9}
          and rec["launches_per_decode_step"] == {"flash_attention": 0,
                                                  "rmsnorm_residual": 9},
          f"qwen2-vl launches {rec['launches_per_prefill']}, "
          f"{rec['launches_per_decode_step']}")
    return {"phase": "qwen2vl_serve",
            "reduced": f"{get_config(QWEN2VL).num_layers} -> 4 layers",
            "image": list(QWEN2VL_IMAGE), **rec}


def slice15_kernel_fields(dev, bw, f32, bf16, wserved, qserved) -> dict:
    """The flash and norm kernels' kernels-line fields at this slice's
    shapes: flash's device ms, plain ms, bound and SDPA ms at whisper's
    encoder (8, 20, 20, 1500, 64, not causal), its cross-attention (Sq =
    128 against Sk = 1500) and qwen2-vl's prefill (4, 64, 8, 2048, 128,
    causal); the norm's at qwen2-vl's 8192 prefill rows of 8192; both
    kernels' launches in ``whisper_serve`` and ``qwen2vl_serve``."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ref as rr
    from repro_torch.kernels.stencil.tune import device_time_ms

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    flash = {}
    for tag, (shape, causal, sk), what in (
            ("whisper_enc", FLASH_WHISPER_ENC, "whisper encoder"),
            ("cross", FLASH_CROSS, "whisper cross-attention"),
            ("qwen2vl", FLASH_QWEN2VL, "qwen2-vl prefill")):
        flash[tag] = flash_timing(dev, shape, bw, bf16, g, causal, sk)
        B, H, KH, S, D = shape
        flash[tag]["shape"] = (f"B={B}, H={H}, KH={KH}, Sq={S}, "
                               f"Sk={sk or S}, D={D}, bf16, "
                               f"{'causal' if causal else 'not causal'} "
                               f"({what}, the model's views)")
        torch.cuda.empty_cache()
    bt = torch.bfloat16
    N, d = 4 * 2048, 8192
    x = torch.randn((N, d), generator=g, device=dev).to(bt)
    r = torch.randn((N, d), generator=g, device=dev).to(bt)
    sc = 1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
    err, ok = _close(rk.rmsnorm_residual_cuda(x, r, sc),
                     rr.rmsnorm_residual_ref(x, r, sc), *RMS_TOL[bt])
    check(ok, f"rmsnorm at qwen2-vl's rows {N}x{d}: {err}")
    rb, rby = bound_ms(rk.rmsnorm_bytes(N, d, 2), rk.rmsnorm_flops(N, d),
                       bw, f32)
    norm = {"ms": device_time_ms(lambda: rk.rmsnorm_residual_cuda(x, r, sc),
                                 100),
            "plain_ms": device_time_ms(
                lambda: rr.rmsnorm_residual_ref(x, r, sc), 20),
            "bound_ms": rb, "bound_by": rby, "library_ms": None,
            "max_abs_err": err,
            "shape": f"N={N}, d={d}, bf16 (qwen2-vl prefill rows)"}
    del x, r
    torch.cuda.empty_cache()
    out = {}
    for name, fields in (("flash_attention", flash),
                         ("rmsnorm_residual", {"qwen2vl": norm})):
        out[name] = {f"{k}_{tag}": v for tag, f in fields.items()
                     for k, v in f.items()}
        for cell, rec in (("whisper", wserved), ("qwen2vl", qserved)):
            out[name] |= {
                f"launches_{cell}": rec["launches"][name],
                f"launches_{cell}_per_prefill":
                    rec["launches_per_prefill"][name],
                f"launches_{cell}_per_step":
                    rec["launches_per_decode_step"][name],
                f"max_abs_err_{cell}_served":
                    rec["kernels_on_activations"][name]["max_abs_diff"]}
    return out


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

#: train_vs_cpu: f32 loss on the card within this relative share of the
#: CPU's, each gradient leaf within this share of its max |g|
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_SHARE = 1e-3
#: the train cell: Yi-6B at full width cut to TRAIN_LAYERS layers,
#: train_4k's sequence, the global batch cut to TRAIN_BATCH in
#: microbatches of TRAIN_MB
TRAIN_LAYERS = 4
TRAIN_SEQ = 4096
TRAIN_BATCH = 8
TRAIN_MB = 2
TRAIN_STEPS = 8


def _grad_case(label, fn, ref, args, kw, tols, seed):
    """One Function against autograd through its plain version on the
    same inputs and output gradients: the forward within the forward's
    tolerance, each input gradient within ``tols`` (atol, rtol), and the
    kernel launched by the Function's forward."""
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    leaves = [a.detach().requires_grad_() for a in args]
    before = _counts()
    outs = fn(*leaves, **kw)
    launched = {k: v - before[k] for k, v in _counts().items()}
    outs = outs if isinstance(outs, tuple) else (outs,)
    check(all(o.grad_fn is not None for o in outs),
          f"{label}: the kernel's output has no grad_fn")
    seeds = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
             for o in outs]
    got = torch.autograd.grad(outs, leaves, seeds)
    plain = [a.detach().requires_grad_() for a in args]
    want_outs = ref(*plain, **kw)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    want = torch.autograd.grad(want_outs, plain, seeds)
    torch.cuda.synchronize()
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want)]
    ok = all(bool(((a.float() - b.float()).abs()
                   <= tols[0] + tols[1] * b.float().abs()).all())
             for a, b in zip(got, want))
    fwd_err = max(float((a.detach().float() - b.detach().float())
                        .abs().max()) for a, b in zip(outs, want_outs))
    check(ok, f"{label}: backward vs plain autograd {errs} outside {tols}")
    return {"case": label, "grad_max_abs_diff": errs,
            "forward_max_abs_diff": fwd_err,
            "launches": {k: v for k, v in launched.items() if v},
            "tolerance": list(tols)}


def run_train_grad_vs_plain(dev):
    """Each autograd Function on the card (the kernel forward, the plain
    backward) against autograd through the plain version: Yi-6B's norm
    rows and attention, mamba2's SSD on the model's stride-0 views, bf16,
    and one f32 case each.  Tolerances: the forwards' (``RMS_TOL``,
    ``ATTN_TOL``, ``SSD_TOL`` / ``SSD_BF16_Y``)."""
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as ro
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_residual_ref
    from repro_torch.kernels.ssd import ops as so
    from repro_torch.kernels.ssd.ref import ssd_chunk_ref

    rng = np.random.default_rng(SEED + 7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for n, d, dtype in ((2048, 4096, bf16), (256, 1024, f32)):
        x, r = (torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)
                                 ).to(dev, dtype) for _ in range(2))
        sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
            np.float32)).to(dev)
        cases.append(_grad_case(
            f"rmsnorm ({n}, {d}) {dtype}", ro.rmsnorm_residual,
            rmsnorm_residual_ref, (x, r, sc), {}, RMS_TOL[dtype], 1))
    for shape, dtype in ((FLASH_SHAPE, bf16), ((2, 8, 2, 256, 64), f32)):
        b, h, kh, s, d = shape
        q, k, v = _attn_inputs(rng, dev, dtype, b, h, kh, s, d,
                               model_layout=True)
        # scores of unit-normal q, k scaled by D^-1/2 keep the softmax
        # broad; the gradient of bf16 probabilities is held like them
        cases.append(_grad_case(
            f"attention {shape} {dtype}", fo.attention, attention_ref,
            (q, k, v), {"causal": True}, (ATTN_TOL[dtype], 0.0), 2))
    # the soft-capped forward and the capped plain backward, f32, the
    # scores spread so that cap 5 bites
    q, k, v = _attn_inputs(rng, dev, f32, 2, 8, 2, 256, 64,
                           model_layout=True)
    q.mul_(SOFTCAP_GAIN)
    cases.append(_grad_case(
        f"attention (2, 8, 2, 256, 64) {f32}, softcap 5", fo.attention,
        attention_ref, (q, k, v), {"causal": True, "softcap": 5.0},
        (ATTN_TOL[f32], 0.0), 2))
    del q, k, v
    for shape, dtype in ((SSD_SERVED, bf16), ((4, 2, 64, 32, 64), f32)):
        xdt, b, c, csum = _ssd_inputs(rng, dev, dtype, *shape,
                                      layout="model")
        tols = (SSD_TOL, 0.0) if dtype == f32 else (
            SSD_BF16_Y[0], SSD_BF16_Y[1])
        cases.append(_grad_case(
            f"ssd {shape} {dtype}, B/C stride 0", so.ssd_chunk,
            ssd_chunk_ref, (xdt, b, c, csum), {}, tols, 3))
        del xdt, b, c, csum
    torch.cuda.empty_cache()
    for c in cases:
        check(len(c["launches"]) == 1 and sum(c["launches"].values()) == 1,
              f"{c['case']}: the Function's forward launched "
              f"{c['launches']}")
    return {"phase": "train_grad_vs_plain", "cases": cases}


def _train_cfg(name, layers=None, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockDef

    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=layers,
            blocks=tuple(BlockDef(b.pattern, layers) for b in cfg.blocks))
    return dataclasses.replace(cfg, **kw)


def _grads_vs_cpu(cfg, params, batch, dev, label):
    """One set of weights on the card (kernels through their Functions,
    remat "full") and on the CPU (plain versions, remat "none"): the
    losses, each leaf's max |diff| as a share of its max |g|, the
    launches against ``launches_per_pass``."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.runtime import train_step as ts

    cpu_params = tree_map(lambda t: t.cpu(), params)
    _counts_zero()
    gl, _, gg = ts.loss_and_grads(
        cfg, RunConfig(loss_chunk=256, remat="full"), params,
        {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = _counts()
    t0 = time.monotonic()
    wl, _, wg = ts.loss_and_grads(
        cfg, RunConfig(loss_chunk=256, remat="none"), cpu_params, batch)
    cpu_s = time.monotonic() - t0
    shares = {}
    for nm, g, w in zip(_leaf_names(M.train_schema(cfg)), tree_leaves(gg),
                        tree_leaves(wg)):
        scale = float(w.abs().max())
        shares[nm] = float((g.cpu() - w).abs().max()) / scale if scale \
            else 0.0
    worst = max(shares, key=shares.get)
    want = M.launches_per_pass(cfg, "train", remat="full")
    check(math.isfinite(gl.item()) and all(
        bool(torch.isfinite(g).all()) for g in tree_leaves(gg)),
        f"{label}: non-finite loss or gradients on the card")
    check({k: launches[k] for k in want} == want,
          f"{label}: launches {launches}, predicted {want}")
    return {"weights": label, "loss_card": gl.item(), "loss_cpu": wl.item(),
            "loss_rel_diff": abs(gl.item() - wl.item()) / abs(wl.item()),
            "worst_leaf": worst, "worst_leaf_share": shares[worst],
            "leaf_shares": shares, "launches": launches,
            "launches_predicted": want, "cpu_s": cpu_s}


def run_train_vs_cpu(dev):
    """Yi-6B and mamba2-370m at full width, 2 layers, f32 (no TF32), B=2,
    S=256: the card's loss and every gradient leaf (kernels in the
    forward through their Functions, remat "full") against the CPU's
    (plain versions, remat "none"; the CPU's remat modes are bitwise
    equal).  Yi-6B's weights as drawn give near one-hot attention
    (scores with a std ~120, ROADMAP caveat 6), whose gradient with
    respect to k amplifies the forward's roundings; its leaves are held
    to TRAIN_GRAD_SHARE with ``well_conditioned`` attention weights, and
    the weights as drawn are reported with their loss held."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params

    out = []
    for name in ("yi-6b", "mamba2-370m"):
        cfg = _train_cfg(name, layers=2, compute_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(M.train_schema(cfg), gen, dev)
        batch = SyntheticLMPipeline(cfg, ShapeConfig("t", "train", 256, 2)
                                    ).batch_at(0)
        runs = [_grads_vs_cpu(cfg, params, batch, dev, "as drawn")]
        if name == "yi-6b":
            runs.append(_grads_vs_cpu(cfg, well_conditioned(cfg, params),
                                      batch, dev, "well_conditioned"))
        for rec in runs:
            check(rec["loss_rel_diff"] <= TRAIN_LOSS_TOL,
                  f"{name} {rec['weights']}: loss {rec}")
        held = runs[-1]
        check(held["worst_leaf_share"] <= TRAIN_GRAD_SHARE,
              f"{name} {held['weights']}: gradients {held}")
        out.append({"arch": name, "layers": 2, "d_model": cfg.d_model,
                    "batch": 2, "seq": 256, "held": held["weights"],
                    "runs": runs})
        del params
        torch.cuda.empty_cache()
    return {"phase": "train_vs_cpu",
            "tolerance": {"loss_rel": TRAIN_LOSS_TOL,
                          "grad_share_of_max": TRAIN_GRAD_SHARE},
            "archs": out}


def _leaf_names(schema) -> list[str]:
    from repro_torch.models.params import map_specs, tree_leaves

    return tree_leaves(map_specs(lambda path, _: "/".join(path), schema))


def _state_diff(a, b) -> float:
    """Largest |a - b| over the leaves of two states (a on the card, b on
    the host; each leaf of b brought over in turn)."""
    from repro_torch.models.params import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y.to(x.device, non_blocking=True)
        if not torch.equal(x, y):
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def _train_cell(dev, cfg, run, shape, steps, smi):
    """``launch.train.train`` on ``cfg``: losses, host ms a step (the
    first step, which warms the caches, left out of the mean), tokens/s,
    peak memory, launches per step against ``launches_per_pass``, and a
    profile of one microbatch's forward and backward and the optimizer's
    update (``profile_device``, by kind)."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.runtime import train_step as ts

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _counts_zero()
    res = train_mod.train(cfg, run, shape, steps=steps, device=dev,
                          log_every=1)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_mb = shape.global_batch // (run.microbatch or shape.global_batch)
    per_mb = M.launches_per_pass(cfg, "train", remat=run.remat)
    want = {k: steps * n_mb * v for k, v in per_mb.items()}
    check(res.launches == launches, f"launches {res.launches} vs {launches}")
    check({k: launches[k] for k in want} == want,
          f"train launches {launches}, predicted {want}")
    check(all(math.isfinite(x) for x in res.losses),
          f"non-finite losses {res.losses}")
    tokens = shape.global_batch * shape.seq_len
    host_ms = [s * 1e3 for s in res.step_s]
    steady = host_ms[1:] if len(host_ms) > 1 else host_ms
    ms = sum(steady) / len(steady)
    opt = make_optimizer(run.optimizer or cfg.optimizer,
                         warmup_cosine(total_steps=steps))
    batch = SyntheticLMPipeline(cfg, shape, device=dev).batch_at(steps)
    mb = {k: v[:run.microbatch or shape.global_batch]
          for k, v in batch.items()}
    step_fn = ts.build_train_step(cfg, run, opt)
    t0 = time.monotonic()
    prof = by_kind(profile_device(lambda: step_fn(res.state, mb), 1), 1)
    prof["host_s_with_trace"] = time.monotonic() - t0
    return res, {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": count_params(M.train_schema(cfg)),
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "seq": shape.seq_len, "global_batch": shape.global_batch,
        "microbatch": run.microbatch, "loss_chunk": run.loss_chunk,
        "remat": run.remat, "optimizer": run.optimizer or cfg.optimizer,
        "steps": steps, "losses": res.losses, "host_ms_per_step": host_ms,
        "host_ms_per_step_mean": ms, "tokens_per_s": tokens / ms * 1e3,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "launches_predicted": want, "profile_step": prof,
        "nvidia_smi": smi}


def run_train(dev, smi):
    """Yi-6B at full width, 4 layers, f32 params and bf16 compute, S=4096,
    B=8 in microbatches of 2, remat "full", AdamW, 8 steps through
    ``launch.train.train``; then 4 steps into a checkpoint, a restore
    and 4 more against the 8 straight (``_resume_check``)."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.models.params import tree_map

    cfg = _train_cfg("yi-6b", layers=TRAIN_LAYERS)
    run = RunConfig(microbatch=TRAIN_MB, loss_chunk=512, remat="full",
                    optimizer="adamw")
    shape = ShapeConfig("train_4k_cut", "train", TRAIN_SEQ, TRAIN_BATCH)
    res, rec = _train_cell(dev, cfg, run, shape, TRAIN_STEPS, smi)
    straight = tree_map(lambda t: t.to("cpu", non_blocking=True), res.state)
    torch.cuda.synchronize()
    del res
    torch.cuda.empty_cache()
    rec["resume"] = _resume_check(dev, cfg, run, shape, straight,
                                  rec["losses"])
    del straight
    torch.cuda.empty_cache()
    check(math.isfinite(rec["resume"]["state_max_abs_diff"]),
          f"resume diverged: {rec['resume']}")
    rec["donated"] = _donate_check(dev, cfg, run, shape)
    check(rec["donated"]["bitwise"],
          f"donated step vs plain: {rec['donated']['state_max_abs_diff']}")
    return {"phase": "train", **rec}


#: steps of the donated step against the plain one (``_donate_check``),
#: at a constant rate: the train cell's warm-up would run the first at 0
DONATE_STEPS = 2
DONATE_LR = 1e-4
#: elements of each parameter leaf held to the seeded state's
DONATE_SEEN = 4096


def _donate_check(dev, cfg, run, shape) -> dict:
    """``build_train_step(..., donate=True)`` against ``donate=False``,
    ``DONATE_STEPS`` steps each from the seeded state: every leaf
    bitwise; both ways the update's own bytes above the state and the
    gradients (the first step split into ``compute_grads`` and the
    update, as the step runs them) and the whole step's peak (the second
    step) above what the side found allocated, and their host ms.  The
    plain side's last state stays on the card for the comparison; every
    parameter leaf of it must have moved from the seeded state (its
    first ``DONATE_SEEN`` elements), so that a leaf the donated step
    left unwritten would part from it."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train_step as ts

    opt = make_optimizer(run.optimizer or cfg.optimizer,
                         constant(DONATE_LR))
    sch = ts.state_schema(cfg, run, opt)
    pipe = SyntheticLMPipeline(cfg, shape, device=dev)
    batches = [pipe.batch_at(i) for i in range(DONATE_STEPS)]

    def side(donate):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = ts.new_state(ts.init_state(sch, gen, dev), opt)
        seeded = [t.reshape(-1)[:DONATE_SEEN].clone()
                  for t in tree_leaves(state["params"])]
        grads, _ = ts.compute_grads(cfg, run, state["params"], batches[0])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        if donate:
            ts.donated_update_(opt, grads, state)
        else:
            new_p, new_o = opt.update(grads, state["opt"], state["params"],
                                      state["step"])
            state = {"params": new_p, "opt": new_o,
                     "step": state["step"] + 1}
            del new_p, new_o
        torch.cuda.synchronize()
        rec = {"update_added_bytes":
               torch.cuda.max_memory_allocated(dev) - base,
               "host_ms_update": (time.monotonic() - t0) * 1e3}
        del grads
        step = ts.build_train_step(cfg, run, opt, donate=donate)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        state, m = step(state, batches[1])
        rec["loss"] = float(m["loss"])
        rec["host_ms_step"] = (time.monotonic() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        # above what the side found on the card (the plain side's last
        # state, kept for the comparison, when the donated side runs)
        rec.update(held_bytes=held, step_peak_bytes=peak - held)
        rec["leaves_moved"] = sum(
            not torch.equal(t.reshape(-1)[:DONATE_SEEN], r)
            for t, r in zip(tree_leaves(state["params"]), seeded))
        rec["leaves"] = len(seeded)
        del seeded
        return state, rec

    plain, prec = side(False)
    donated, drec = side(True)
    worst = 0.0
    for a, b in zip(tree_leaves(donated), tree_leaves(plain)):
        if not torch.equal(a, b):
            worst = max(worst, float((a.double() - b.double()).abs().max()))
    del plain, donated
    torch.cuda.empty_cache()
    check(prec["leaves_moved"] == prec["leaves"],
          f"the plain step moved {prec['leaves_moved']} of "
          f"{prec['leaves']} parameter leaves")
    return {"steps": DONATE_STEPS, "lr": DONATE_LR,
            "bitwise": worst == 0.0, "state_max_abs_diff": worst,
            "plain": prec, "donated": drec}


def _resume_check(dev, cfg, run, shape, straight, losses) -> dict:
    """``launch.train.train`` for half the steps into a checkpoint, then
    that checkpoint restored by the port's manager (the newest intact
    generation, as ``train(resume=True)`` restores it) and the other half
    run from it: the state against the straight run's (on the host)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models.params import tree_map
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.runtime import train_step as ts

    steps = len(losses)
    half = steps // 2
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as ckpt:
        train_mod.train(cfg, run, shape, steps=half, device=dev,
                        ckpt_dir=ckpt, log_every=half)
        saved_s = time.monotonic() - t0
        t1 = time.monotonic()
        opt = make_optimizer(run.optimizer or cfg.optimizer,
                             warmup_cosine(total_steps=steps))
        state, extra = CheckpointManager(ckpt).restore(
            ts.state_schema(cfg, run, opt))
        state = tree_map(lambda t: t.to(dev), state)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t1
    check(int(extra["data_step"]) == half, f"restored {extra}")
    pipe = SyntheticLMPipeline(cfg, shape, device=dev)
    step_fn = ts.build_train_step(cfg, run, opt)
    resumed = []
    for i in range(half, steps):
        state, m = step_fn(state, pipe.batch_at(i))
        resumed.append(float(m["loss"]))
    diff = _state_diff(state, straight)
    return {"bitwise": diff == 0.0, "state_max_abs_diff": diff,
            "loss_max_abs_diff": max(abs(a - b) for a, b in
                                     zip(resumed, losses[half:])),
            "train_and_save_s": saved_s, "restore_s": restore_s}


def run_mamba_train(dev, smi):
    """mamba2-370m whole (48 layers), f32 params and bf16 compute, B=4,
    S=2048, microbatch 1, remat "full", AdamW, 4 steps through
    ``launch.train.train``."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig

    cfg = _train_cfg("mamba2-370m")
    run = RunConfig(microbatch=1, loss_chunk=512, remat="full",
                    optimizer="adamw")
    shape = ShapeConfig("mamba_train", "train", 2048, 4)
    res, rec = _train_cell(dev, cfg, run, shape, 4, smi)
    del res
    torch.cuda.empty_cache()
    return {"phase": "mamba_train", **rec}


#: the sharded step against the unsharded one on the one-rank mesh
SHARDED_LOSS_RTOL = 1e-6
SHARDED_STEPS = 2


def _sharded_cell(dev, cfg, run, shape, smi):
    """``SHARDED_STEPS`` steps of the unsharded step and of
    ``launch.train.build_session``'s on ``make_host_mesh()``, each from
    the seeded state (drawn anew for each, so at most two states are on
    the card at once, as in ``train``): losses, the gradients of the
    first microbatch (held on the host), the launches of each step and
    the host ms a step both ways."""
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels.local import LOCAL_MAP_CALLS
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding.rules import axis_rules, distribute_params
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = make_host_mesh(device=dev)
    check(tuple(mesh.shape) == (1, 1) and mesh.device_type == dev.type,
          f"host mesh {mesh}")
    opt, sch, shardings, step, rules = train_mod.build_session(
        cfg, run, mesh, SHARDED_STEPS)
    plain = ts.build_train_step(cfg, run, opt)
    pipe = SyntheticLMPipeline(cfg, shape, device=dev)
    batches = [pipe.batch_at(i) for i in range(SHARDED_STEPS)]
    mb = {k: v[:run.microbatch or shape.global_batch]
          for k, v in batches[0].items()}

    def state0():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ts.new_state(ts.init_state(sch, gen, dev), opt)

    def host_grads(params, batch, ctx, gsh=None):
        with ctx:
            g, _ = ts.compute_grads(cfg, run, params, batch, gsh)
        out = [ts.full_tensor(x).to("cpu") for x in tree_leaves(g)]
        del g
        torch.cuda.empty_cache()
        return out

    def run_steps(fn, holder, bs):
        """The steps from ``holder``'s one state, which they consume."""
        state = holder.pop()
        losses, ms, per_step = [], [], []
        for b in bs:
            _counts_zero()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
            ms.append((time.monotonic() - t0) * 1e3)
            per_step.append(_counts())
        del state
        torch.cuda.empty_cache()
        return losses, ms, per_step

    holder = [state0()]
    want_g = host_grads(holder[0]["params"], mb, contextlib.nullcontext())
    want_l, want_ms, want_n = run_steps(plain, holder, batches)
    holder = [distribute_params(state0(), shardings)]
    dbatches = [ts.distribute_batch(b, rules) for b in batches]
    dmb = ts.distribute_batch(mb, rules)
    calls0 = dict(LOCAL_MAP_CALLS)
    ctx = contextlib.ExitStack()
    ctx.enter_context(axis_rules(rules))
    ctx.enter_context(implicit_replication())
    got_g = host_grads(holder[0]["params"], dmb, ctx, shardings["params"])
    got_l, got_ms, got_n = run_steps(step, holder, dbatches)
    calls = {k: LOCAL_MAP_CALLS[k] - calls0[k] for k in calls0}
    shares, bitwise_g = {}, True
    for nm, g, w in zip(_leaf_names(M.train_schema(cfg)), got_g, want_g):
        scale = float(w.abs().max())
        bitwise_g = bitwise_g and torch.equal(g, w)
        shares[nm] = float((g - w).abs().max()) / scale if scale else 0.0
    worst = max(shares, key=shares.get)
    rel = [abs(a - b) / abs(b) for a, b in zip(got_l, want_l)]
    n_mb = shape.global_batch // (run.microbatch or shape.global_batch)
    per_step = {k: n_mb * v for k, v in
                M.launches_per_pass(cfg, "train", remat=run.remat).items()}
    for i in range(SHARDED_STEPS):
        check({k: got_n[i][k] for k in per_step} == per_step
              == {k: want_n[i][k] for k in per_step},
              f"{cfg.name} step {i}: launches sharded {got_n[i]}, "
              f"unsharded {want_n[i]}, predicted {per_step}")
    check(all(r <= SHARDED_LOSS_RTOL for r in rel),
          f"{cfg.name}: losses sharded {got_l} unsharded {want_l}")
    check(shares[worst] <= TRAIN_GRAD_SHARE,
          f"{cfg.name}: gradient {worst} parts by {shares[worst]}")
    check(all(calls[k] > 0 for k in per_step),
          f"{cfg.name}: local_map branch calls {calls}")
    del dbatches, dmb, got_g, want_g
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "seq": shape.seq_len,
            "global_batch": shape.global_batch,
            "microbatch": run.microbatch, "mesh": list(mesh.shape),
            "losses_sharded": got_l, "losses_unsharded": want_l,
            "losses_bitwise": got_l == want_l, "loss_rel_diff": rel,
            "grads_bitwise": bitwise_g, "worst_leaf": worst,
            "worst_leaf_share": shares[worst],
            "host_ms_per_step_sharded": got_ms,
            "host_ms_per_step_unsharded": want_ms,
            "launches_per_step": got_n, "launches_per_step_unsharded":
            want_n, "launches_predicted_per_step": per_step,
            "local_map_calls": calls, "nvidia_smi": smi}


def run_sharded_train(dev, smi):
    """The sharded train step (``build_session`` on a one-rank NCCL
    mesh, every placement ``Replicate()``) against the unsharded step
    from the same state, at the ``train`` phase's Yi-6B cell (full
    width, 4 layers, S=4096, B=8 in microbatches of 2) and the
    ``mamba_train`` phase's mamba2-370m cell, ``SHARDED_STEPS`` steps
    each: losses within ``SHARDED_LOSS_RTOL``, gradients within
    ``TRAIN_GRAD_SHARE``·max|g|, each kernel launched as often a step
    both ways (the kernels ran under DTensor, through their
    ``local_map`` branch).  The launches of the whole phase feed the
    kernels line."""
    import torch.distributed as dist

    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig

    cells = (
        (_train_cfg("yi-6b", layers=TRAIN_LAYERS),
         RunConfig(microbatch=TRAIN_MB, loss_chunk=512, remat="full",
                   optimizer="adamw"),
         ShapeConfig("train_4k_cut", "train", TRAIN_SEQ, TRAIN_BATCH)),
        (_train_cfg("mamba2-370m"),
         RunConfig(microbatch=1, loss_chunk=512, remat="full",
                   optimizer="adamw"),
         ShapeConfig("mamba_train", "train", 2048, 4)),
    )
    check(not dist.is_initialized(), "a process group is already running")
    out, launches = [], {}
    try:
        for cfg, run, shape in cells:
            rec = _sharded_cell(dev, cfg, run, shape, smi)
            for n in rec["launches_per_step"]:
                for k, v in n.items():
                    launches[k] = launches.get(k, 0) + v
            out.append(rec)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"phase": "sharded_train", "steps": SHARDED_STEPS,
            "tolerance": {"loss_rel": SHARDED_LOSS_RTOL,
                          "grad_share_of_max": TRAIN_GRAD_SHARE},
            "cells": out, "launches": launches, "nvidia_smi": smi}



#: DeepSeek-V2 under expert parallelism against the grouped einsum path:
#: EP adds each token's gated expert outputs one by one in bf16 where the
#: einsum sums them in one f32 contraction, so the two part by bf16
#: roundings, carried into bf16 gradients (one bf16 ulp at a leaf's
#: largest gradient is 2^-8 = 3.9e-3 of it; a leaf's relative L2 is
#: reported, not held: a small leaf summed over 8192 tokens cancels)
DS_SHARDED_LOSS_RTOL = 1e-3
DS_SHARDED_GRAD_SHARE = 5e-2
#: (B, S): N = 4096 tokens, one MoE group (the config's 8192 cut to the
#: tokens there are), C = 192.  At B = 4 the plain attention backward's
#: f32 (B, 128, 2048, 2048) scores (8.6 GB a tensor, ~45 GB at its peak)
#: on top of 21 GB of parameters and gradients come near the card's 80
DS_SHARDED_SHAPE = (2, 2048)


def run_deepseek_sharded_train(dev, smi):
    """DeepSeek-V2 at full width cut to 2 layers, (mla, dense) and (mla,
    moe) (160 experts, top-6, 2 shared), bf16 as the config, remat
    "full", B x S = 2 x 2048: ``SHARDED_STEPS`` gradient passes of the
    train step through ``launch.train.build_session``'s rules and
    placements on the one-rank NCCL mesh (the MoE layer on the
    expert-parallel path) against the unsharded pass (the grouped einsum
    path), each side from the seeded parameters drawn anew: losses
    within ``DS_SHARDED_LOSS_RTOL``, every gradient leaf within
    ``DS_SHARDED_GRAD_SHARE``·max|g|, drops per MoE call equal, every MoE call on its path,
    each kernel launched as often a pass both ways (the sharded side's
    through its ``local_map`` branch), host ms a pass, peak memory and a
    profile of one pass with the device ms of the three MoE ranges.  The
    step's update (the config's 8-bit AdamW) runs in ``moe_train``, the
    donated step, which writes the one state in place: the old and the
    new state of 5.36 B parameters (43 GB each) do not fit the card's 80
    GB together."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels.local import LOCAL_MAP_CALLS
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.params import count_params, tree_leaves
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding.rules import axis_rules, distribute_params

    cfg = _deepseek_cut(V2, 1, 1, "bfloat16")
    run = RunConfig(loss_chunk=512, remat="full")
    B, S = DS_SHARDED_SHAPE
    n_moe = sum(mlp == "moe" for b in cfg.blocks for _ in range(b.repeat)
                for _, mlp in b.pattern)
    per_pass = M.launches_per_pass(cfg, "train", remat=run.remat)
    check(not dist.is_initialized(), "a process group is already running")

    def side(params, batch, ctx, gsh, path):
        """``SHARDED_STEPS`` gradient passes and a profiled one: losses,
        host ms, launches, MoE path calls, the first pass's drops and
        gradients (on the host), peak memory."""
        def grads():
            with ctx():
                return ts.compute_grads(cfg, run, params, batch, gsh)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms, launches, calls = [], [], [], []
        first = None
        for i in range(SHARDED_STEPS):
            _counts_zero()
            c0 = dict(moe.MOE_CALLS)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with moe.record_drops() as log:
                g, m = grads()
                losses.append(float(ts.full_tensor(m["loss"])))
            ms.append((time.monotonic() - t0) * 1e3)
            launches.append(_counts())
            calls.append({k: moe.MOE_CALLS[k] - c0[k] for k in c0})
            if first is None:
                first = ([ts.full_tensor(x).to("cpu") for x in
                          tree_leaves(g)], [(p_, int(n)) for p_, n in log])
            del g
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        prof = by_kind(profile_device(grads, 1), 1)
        prof["host_s_with_trace"] = time.monotonic() - t0
        torch.cuda.empty_cache()
        for c in calls:
            check(c == {"grouped": 0, "ep": 0, path: 2 * n_moe},
                  f"MoE calls a pass {c}, want {2 * n_moe} on {path}")
        for n in launches:
            check({k: n[k] for k in per_pass} == per_pass,
                  f"launches a pass {n}, predicted {per_pass}")
        return {"losses": losses, "host_ms_per_pass": ms,
                "launches_per_pass": launches, "moe_calls_per_pass": calls,
                "drops": [n for _, n in first[1]],
                "drop_paths": [p_ for p_, _ in first[1]],
                "peak_memory_bytes": peak, "profile_pass": prof}, first[0]

    out = {}
    try:
        mesh = make_host_mesh(device=dev)
        check(tuple(mesh.shape) == (1, 1), f"host mesh {mesh}")
        opt, sch, shardings, _, rules = train_mod.build_session(
            cfg, run, mesh, SHARDED_STEPS)
        batch = SyntheticLMPipeline(cfg, ShapeConfig(
            "deepseek_sharded", "train", S, B), device=dev).batch_at(0)

        def params0():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            return ts.init_state(sch, gen, dev)

        params = params0()
        plain, want_g = side(params, batch, contextlib.nullcontext, None,
                             "grouped")
        del params
        torch.cuda.empty_cache()
        dparams = distribute_params(params0(), shardings["params"])
        dbatch = ts.distribute_batch(batch, rules)
        calls0 = dict(LOCAL_MAP_CALLS)

        def ctx():
            stack = contextlib.ExitStack()
            stack.enter_context(axis_rules(rules))
            stack.enter_context(implicit_replication())
            return stack

        sharded, got_g = side(dparams, dbatch, ctx, shardings["params"],
                              "ep")
        local = {k: LOCAL_MAP_CALLS[k] - calls0[k] for k in calls0}
        del dparams
        shares, rel_l2 = {}, {}
        names = _leaf_names(M.train_schema(cfg))
        for nm, g, w in zip(names, got_g, want_g):
            g, w = g.to(dev).float(), w.to(dev).float()
            diff = g - w
            scale = float(w.abs().max())
            shares[nm] = float(diff.abs().max()) / scale if scale else 0.0
            norm = float(w.norm())
            rel_l2[nm] = float(diff.norm()) / norm if norm else 0.0
            del g, w, diff
        del got_g, want_g
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    worst = max(shares, key=shares.get)
    worst_l2 = max(rel_l2, key=rel_l2.get)
    rel = [abs(a - b) / abs(b) for a, b in zip(sharded["losses"],
                                               plain["losses"])]
    check(all(r <= DS_SHARDED_LOSS_RTOL for r in rel),
          f"losses sharded {sharded['losses']} unsharded {plain['losses']}")
    check(shares[worst] <= DS_SHARDED_GRAD_SHARE,
          f"gradient {worst} parts by {shares[worst]} of its max")
    check(sharded["drops"] == plain["drops"]
          and len(plain["drops"]) == 2 * n_moe,
          f"drops sharded {sharded['drops']} unsharded {plain['drops']}")
    check(sharded["launches_per_pass"] == plain["launches_per_pass"],
          "launches a pass differ")
    check(all(local[k] > 0 for k in per_pass if per_pass[k]),
          f"local_map branch calls {local}")
    launches = {}
    for n in sharded["launches_per_pass"]:
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    out = {"phase": "deepseek_sharded_train", "arch": cfg.name,
           "reduced": _reduced(get_config(V2), (1, 1)),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
           "params": count_params(M.train_schema(cfg)),
           "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "batch": B, "seq": S,
           "capacity": moe.expert_capacity(B * S, cfg),
           "remat": run.remat, "optimizer": run.optimizer or cfg.optimizer,
           "update": "run in phase moe_train (the donated step)",
           "mesh": list(mesh.shape), "passes": SHARDED_STEPS,
           "tolerance": {"loss_rel": DS_SHARDED_LOSS_RTOL,
                         "grad_share_of_max": DS_SHARDED_GRAD_SHARE},
           "loss_rel_diff": rel, "worst_leaf": worst,
           "worst_leaf_share": shares[worst], "worst_leaf_l2": worst_l2,
           "worst_leaf_rel_l2": rel_l2[worst_l2],
           "sharded": sharded, "unsharded": plain,
           "local_map_calls": local, "launches_predicted_per_pass":
           per_pass, "launches": launches, "nvidia_smi": smi}
    return out


#: moe_train: the donated step (``launch.train.build_session``) on the
#: one-rank NCCL mesh, 2 steps a cell, remat "full", each config's own
#: optimizer: DeepSeek-V2 cut to 2 layers (8-bit AdamW) and Jamba-v0.1
#: cut to 3 (AdamW with its f32 master), bf16.  (B, S) a cell: V2's
#: 43.4 GB of state and 10.7 GB of gradients leave room for one row of
#: 2048 (at 2 rows the pass adds ~32 GB: ~86 GB in all); no microbatch
#: (an f32 gradient sum of V2 would be 21.4 GB more)
MOE_TRAIN_STEPS = 2
MOE_TRAIN_V2 = (1, 2048)
MOE_TRAIN_JAMBA = (2, 2048)
#: the update's own memory above the state and the gradients
MOE_UPDATE_LIMIT = 2 << 30
#: the cells' optimizer rate, constant: one step moves every bf16
#: parameter whose gradient is nonzero (a norm scale at 1.0 by more than
#: 2^-9, a mamba dt bias near -3 by more than 2^-7), so that the sample
#: (below) tells a written parameter from one left as it was
MOE_TRAIN_LR = 1e-2
#: elements a row range of a leaf's sample holds at most: the first
#: rows along the leading dims, the last rows and, for a leaf that
#: ``update_`` cuts into chunks, the rows about the first chunk
#: boundary, cloned before the update and run through the plain
#: ``update``
SAMPLE_ELEMENTS = 4 << 20


def _placed_state(sch, opt, shardings, dev):
    """The seeded step-0 state at its placements (``distribute_params``
    on the one-rank mesh: each DTensor's local tensor is the leaf
    itself, so a 43 GB state is never held twice)."""
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding.rules import distribute_params

    gen = torch.Generator(device=dev).manual_seed(SEED)
    return distribute_params(
        ts.new_state(ts.init_state(sch, gen, dev), opt), shardings)


def _local_bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.inplace import local

    return sum(local(t).nbytes for t in tree_leaves(tree)
               if t is not None)


def _state_bytes(state) -> dict:
    """The state's bytes: parameters, f32 master, moments (the int8 or
    f32 codes, or Adafactor's statistics) and int8 scales."""
    from repro_torch.optim.inplace import leaf_paths, at

    opt = state["opt"]
    out = {"params": _local_bytes(state["params"]),
           "master": _local_bytes(opt.get("master", {})),
           "moments": 0, "scales": 0}
    for key in ("m", "v", "stats"):
        for path in leaf_paths(opt.get(key, {})):
            # an int8 moment is a dict: its codes "q" and their scales
            codes = at(opt[key], path[:-1])
            kind = "scales" if "q" in codes and path[-1] != "q" \
                else "moments"
            out[kind] += _local_bytes(at(opt[key], path))
    out["total"] = sum(out.values())
    return out


def _sample_ranges(shape) -> tuple[int, int, list]:
    """``(lead, rows, ranges)``: a leaf of ``shape`` seen as ``rows``
    rows of its ``lead`` leading dims, and the row ranges of its sample:
    the first rows and the last (at most ``SAMPLE_ELEMENTS`` elements
    each) and, where ``update_`` cuts the leaf into chunks of
    ``adamw.CHUNK_BYTES`` (as f32), as many rows about the first chunk
    boundary."""
    from repro_torch.optim import adamw

    lead = max(len(shape) - 1, 0)
    last = shape[-1] if len(shape) else 1
    rows = math.prod(shape) // last
    take = min(rows, max(1, SAMPLE_ELEMENTS // last))
    ranges = [(0, take)]
    if rows > take:
        ranges.append((rows - take, rows))
    per = max(1, adamw.CHUNK_BYTES // (4 * last))
    if rows * last * 4 > adamw.CHUNK_BYTES and rows > per:
        lo = max(per - max(take // 2, 1), 0)
        ranges.append((lo, min(lo + max(take, 2), rows)))
    return lead, rows, ranges


def _rows(x, lead: int, rows: int, lo: int, hi: int):
    """Rows ``lo:hi`` of ``x`` (a leaf of the state or the gradients, a
    DTensor's local tensor) seen as ``rows`` rows of its ``lead``
    leading dims, cloned."""
    from repro_torch.optim.inplace import local

    x = local(x)
    return x.reshape((rows,) + tuple(x.shape[lead:]))[lo:hi].clone()


def _update_sample(state, grads) -> dict:
    """Of every leaf: the row ranges of ``_sample_ranges``, with their
    gradients, moments (codes and scales) and master, and the step and
    count, cloned as they stand before the update: the plain
    ``update``'s inputs, one entry a range."""
    from repro_torch.optim.inplace import at, leaf_paths, local

    opt = state["opt"]
    keys = [k for k in ("m", "v", "master") if k in opt]
    out = {"params": {}, "grads": {}, "opt": {k: {} for k in keys},
           "cut": {}}
    for path in leaf_paths(state["params"]):
        p = at(state["params"], path)
        lead, rows, ranges = _sample_ranges(tuple(p.shape))
        for lo, hi in ranges:
            name = f"{'/'.join(path)}@{lo}:{hi}"
            out["cut"][name] = (path, lead, rows, lo, hi)
            out["params"][name] = _rows(p, lead, rows, lo, hi)
            out["grads"][name] = _rows(at(grads, path), lead, rows, lo, hi)
            for k in keys:
                st = at(opt[k], path)
                out["opt"][k][name] = (
                    {j: _rows(v, lead, rows, lo, hi) for j, v in st.items()}
                    if isinstance(st, dict)
                    else _rows(st, lead, rows, lo, hi))
    out["opt"]["count"] = local(opt["count"]).clone()
    out["step"] = local(state["step"]).clone()
    return out


def _check_update_sample(opt, sample, state) -> dict:
    """The plain ``update`` of the sample against the same rows of the
    state the in-place update wrote: every range bitwise.  And every
    range whose gradient is nonzero somewhere has its parameters, its
    master and its first moment moved from their clones, so that a leaf
    the in-place update left unwritten parts from the plain one."""
    from repro_torch.optim.inplace import at, local

    want_p, want_o = opt.update(sample["grads"], sample["opt"],
                                sample["params"], sample["step"])
    worst, n = 0.0, 0
    kinds = [k for k in ("params", "master", "m")
             if k == "params" or k in want_o]
    moved = {k: 0 for k in kinds}
    live, still = 0, []
    for name, (path, lead, rows, lo, hi) in sample["cut"].items():
        pairs = [(at(state["params"], path), want_p[name])]
        for k in ("m", "v", "master"):
            if k in want_o:
                got, w = at(state["opt"][k], path), want_o[k][name]
                pairs += ([(got[j], w[j]) for j in got]
                          if isinstance(got, dict) else [(got, w)])
        for got, w in pairs:
            got = _rows(got, lead, rows, lo, hi)
            n += 1
            if not torch.equal(got, w):
                worst = max(worst, float((got.double() - w.double())
                                         .abs().max()))
        if not bool(sample["grads"][name].any()):
            continue
        live += 1
        for k in kinds:
            old, new = ((sample["params"][name], want_p[name])
                        if k == "params" else
                        (sample["opt"][k][name], want_o[k][name]))
            if isinstance(old, dict):
                old, new = old["q"], new["q"]
            if torch.equal(old, new):
                still.append(f"{name} {k}")
            else:
                moved[k] += 1
    check(torch.equal(local(state["opt"]["count"]), want_o["count"]),
          "count after the in-place update")
    return {"tensors": n, "ranges": len(sample["cut"]),
            "bitwise": worst == 0.0, "max_abs_diff": worst,
            "ranges_with_gradient": live, "moved": moved, "still": still}


def moe_train_cells() -> list[tuple]:
    """``moe_train``'s cells: (config, (B, S), ``reduced``)."""
    from repro_torch.configs import get_config

    return [
        (_deepseek_cut(V2, 1, 1, "bfloat16"), MOE_TRAIN_V2,
         _reduced(get_config(V2), (1, 1)) + "; B x S 2 x 2048 -> "
         f"{MOE_TRAIN_V2[0]} x {MOE_TRAIN_V2[1]} (at 2 x 2048 the "
         "gradient pass runs out of memory: tools/donate_probe.py)"),
        (_jamba_cut(3, "bfloat16"), MOE_TRAIN_JAMBA,
         "32 -> 3 layers ((mamba, dense), (mamba, moe), (attn, dense) of "
         "the period)"),
    ]


def moe_train_run():
    """``moe_train``'s run: remat "full", the loss in chunks of 512."""
    from repro_torch.configs import RunConfig

    return RunConfig(loss_chunk=512, remat="full")


def moe_train_optimizer(cfg, run):
    """``moe_train``'s optimizer: the config's at ``MOE_TRAIN_LR``."""
    from repro_torch.optim import constant, make_optimizer

    return make_optimizer(run.optimizer or cfg.optimizer,
                          constant(MOE_TRAIN_LR))


def _moe_train_cell(dev, smi, cfg, run, B, S, reduced):
    """2 steps of ``build_session``'s donated step on ``cfg``, the
    config's optimizer at ``MOE_TRAIN_LR``: the first as the step runs
    it, split to measure (``compute_grads``, then ``donated_update_``,
    with a sample of every leaf held to the plain ``update``), the
    second through the step itself."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding.rules import axis_rules

    mesh = make_host_mesh(device=dev)
    check(tuple(mesh.shape) == (1, 1), f"host mesh {mesh}")
    opt, sch, shardings, step_fn, rules = train_mod.build_session(
        cfg, run, mesh, MOE_TRAIN_STEPS, moe_train_optimizer(cfg, run))
    ush = ts.update_shardings(cfg, run, rules) if run.zero1 else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    state = _placed_state(sch, opt, shardings, dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    sizes = _state_bytes(state)
    pipe = SyntheticLMPipeline(cfg, ShapeConfig("moe_train", "train", S, B),
                               device=dev)
    batches = [ts.distribute_batch(pipe.batch_at(i), rules)
               for i in range(MOE_TRAIN_STEPS)]
    batch_bytes = _local_bytes(batches[1])
    per_pass = M.launches_per_pass(cfg, "train", remat=run.remat)
    losses, launches, host_ms = [], [], []

    # step 1, as the donated step runs it, measured part by part
    _counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    with axis_rules(rules), implicit_replication():
        grads, metrics = ts.compute_grads(cfg, run, state["params"],
                                          batches[0], shardings["params"])
    torch.cuda.synchronize()
    pass_ms = (time.monotonic() - t0) * 1e3
    pass_peak = torch.cuda.max_memory_allocated(dev)
    grad_bytes = _local_bytes(grads)
    sample = _update_sample(state, grads)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    with axis_rules(rules), implicit_replication():
        ts.donated_update_(opt, grads, state, ush)
    torch.cuda.synchronize()
    update_ms = (time.monotonic() - t0) * 1e3
    update_add = torch.cuda.max_memory_allocated(dev) - base
    del grads
    losses.append(float(ts.full_tensor(metrics["loss"])))
    launches.append(_counts())
    host_ms.append(pass_ms + update_ms)
    held = _check_update_sample(opt, sample, state)
    del sample
    check(held["bitwise"], f"{cfg.name}: the in-place update parts from "
          f"update by {held['max_abs_diff']}")
    check(held["ranges_with_gradient"] > 0 and not held["still"],
          f"{cfg.name}: the update left sampled rows as they were: "
          f"{held['still'][:8]} ({held['ranges_with_gradient']} ranges "
          f"with a gradient)")
    check(update_add <= MOE_UPDATE_LIMIT,
          f"{cfg.name}: the update adds {update_add} bytes")

    # step 2, the donated step itself
    torch.cuda.empty_cache()
    _counts_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_base = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    out, m = step_fn(state, batches[1])
    losses.append(float(m["loss"]))
    host_ms.append((time.monotonic() - t0) * 1e3)
    step_peak = torch.cuda.max_memory_allocated(dev)
    launches.append(_counts())
    check(out is state, "the donated step returned another state")
    check(int(ts.full_tensor(state["step"])) == MOE_TRAIN_STEPS,
          f"step counter {state['step']}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for n in launches:
        check({k: n[k] for k in per_pass} == per_pass,
              f"{cfg.name}: launches a step {n}, predicted {per_pass}")
    del out, state, batches
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "reduced": reduced, "layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "params": count_params(M.train_schema(cfg)),
            "param_dtype": cfg.param_dtype, "remat": run.remat,
            "optimizer": run.optimizer or cfg.optimizer,
            "lr": MOE_TRAIN_LR, "batch": B,
            "seq": S, "microbatch": run.microbatch,
            "mesh": list(mesh.shape), "steps": MOE_TRAIN_STEPS,
            "state_bytes": sizes, "grad_bytes": grad_bytes,
            "state_init_s": init_s,
            "pass_peak_bytes": pass_peak, "step_peak_bytes": step_peak,
            "step_base_bytes": step_base,
            "step_rise_bytes": step_peak - step_base,
            "step_argument_bytes": sizes["total"] + batch_bytes,
            "update_added_bytes": update_add,
            "update_limit_bytes": MOE_UPDATE_LIMIT,
            "host_ms_pass": pass_ms, "host_ms_update": update_ms,
            "host_ms_per_step": host_ms, "losses": losses,
            "launches_per_step": launches,
            "launches_predicted_per_step": per_pass,
            "update_vs_plain": held, "nvidia_smi": smi}


def run_moe_train(dev, smi):
    """DeepSeek-V2 (2 layers, 8-bit AdamW) and Jamba-v0.1 (3 layers, one
    of each kind, AdamW with its f32 master) at full width in bf16, each
    2 updates of the train CLI's donated step (``build_session`` on the
    one-rank NCCL mesh), remat "full": state, gradient and peak bytes,
    the update's own bytes (at most ``MOE_UPDATE_LIMIT``), the host ms
    of the pass, the update and the step, finite losses, launches a step
    as ``launches_per_pass`` predicts, and every leaf's sampled rows
    (``_sample_ranges``) after the in-place update bitwise those of the
    plain ``update`` on the same rows (the update is elementwise, its
    int8 blocks along the last dim), each range with a gradient moved."""
    import torch.distributed as dist

    check(not dist.is_initialized(), "a process group is already running")
    out, launches = [], {}
    try:
        for cfg, (B, S), reduced in moe_train_cells():
            rec = _moe_train_cell(dev, smi, cfg, moe_train_run(), B, S,
                                  reduced)
            for n in rec["launches_per_step"]:
                for k, v in n.items():
                    launches[k] = launches.get(k, 0) + v
            out.append(rec)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"phase": "moe_train", "cells": out, "launches": launches,
            "nvidia_smi": smi}


#: sharded_serve: DeepSeek-V2 served under the serve rules (its MoE
#: layers on the expert-parallel path) against the plain serve (the
#: grouped einsum path), as a share of max|logit|: EP adds a token's
#: gated expert outputs in bf16 where the einsum sums them in f32 (the
#: deepseek_sharded_train phase's 1.6e-6 loss gap in f32 grows to bf16
#: roundings here), well under a wrong expert's or a wrong cache slot's
DS_SERVE_SHARE = 5e-2
#: sharded_serve's cells: Yi-6B whole, the serve cell's 4 x 512 prompts
#: and 32 tokens; DeepSeek-V2 at deepseek_serve's 4-layer cut, 4 x 512
#: prompts and 8 tokens
SHARDED_SERVE_YI = (4, 512, 32)
SHARDED_SERVE_DS = (4, 512, 8)


def _serve_both(dev, cfg, B, P, G):
    """``serve`` of ``cfg`` on plain tensors and under
    ``make_rules(make_host_mesh(), "serve")`` (a one-rank NCCL group,
    started and closed here), each after a warm-up of 2 tokens, from the
    same seeded weights and prompts: the two results, host ms of the
    prefill and a decode step, launches per prefill and decode step,
    the drops of every MoE call, ``local_map`` calls and peak memory;
    and the last logits of the decode steps under the rules fed the
    plain serve's tokens (``forced_last_logits``)."""
    import torch.distributed as dist

    from repro_torch.kernels.local import LOCAL_MAP_CALLS
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.runtime import serve_step
    from repro_torch.sharding.rules import make_rules

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = serve.make_params(cfg, dev, seed=SEED)
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = serve.make_prompts(cfg, B, P, rng)
    check(not dist.is_initialized(), "a process group is already running")

    def one(rules):
        serve.serve(cfg, params, prompts, 2, rules=rules)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _counts_zero()
        calls0, moe0 = dict(LOCAL_MAP_CALLS), dict(moe.MOE_CALLS)
        with moe.record_drops() as log:
            res = serve.serve(cfg, params, prompts, G, rules=rules)
        steps = res.decode_steps
        return res, {
            "prefill_ms": res.prefill_s * 1e3,
            "decode_ms_per_step": res.decode_s / steps * 1e3,
            "launches_per_prefill": res.launches["prefill"],
            "launches_per_decode_step": {
                k: v / steps for k, v in res.launches["decode"].items()},
            "launches": _counts(),
            "local_map_calls": {k: LOCAL_MAP_CALLS[k] - calls0[k]
                                for k in calls0},
            "moe_calls": {k: moe.MOE_CALLS[k] - moe0[k] for k in moe0},
            "drops": [int(n) for _, n in log],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}

    def forced(rules, tokens):
        """The last logits of the decode steps under ``rules`` fed the
        plain serve's ``tokens`` (teacher forcing)."""
        prefill = serve_step.build_prefill(cfg, rules, max_seq=P + G)
        decode = serve_step.build_decode(cfg, rules)
        dparams = serve_step.place_params(cfg, params, rules)
        _, cache = prefill(dparams, serve_step.place_inputs(
            {"tokens": prompts}, rules))
        for i in range(G - 1):
            lg, cache = decode(dparams, cache, serve_step.place_inputs(
                {"token": tokens[:, i], "pos": P + i}, rules))
        return lg.full_tensor()

    plain, p_rec = one(None)
    try:
        mesh = make_host_mesh(device=dev)
        check(tuple(mesh.shape) == (1, 1), f"host mesh {mesh}")
        rules = make_rules(mesh, "serve")
        placed, s_rec = one(rules)
        s_rec["forced_last_logits"] = forced(rules, plain.tokens)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    del params
    torch.cuda.empty_cache()
    check(type(placed.last_logits) is torch.Tensor,
          "serve under rules returned a DTensor")
    check(s_rec["launches_per_prefill"] == p_rec["launches_per_prefill"]
          and s_rec["launches_per_decode_step"]
          == p_rec["launches_per_decode_step"],
          f"launches under rules {s_rec['launches_per_prefill']} "
          f"{s_rec['launches_per_decode_step']}, plain "
          f"{p_rec['launches_per_prefill']} "
          f"{p_rec['launches_per_decode_step']}")
    check(all(s_rec["local_map_calls"][k] > 0
              for k, v in p_rec["launches"].items() if v),
          f"local_map calls {s_rec['local_map_calls']}")
    return plain, placed, {"plain": p_rec, "sharded": s_rec}


def run_sharded_serve(dev, smi):
    """Serving under the serve rules on the one-rank NCCL mesh (every
    placement ``Replicate()``): Yi-6B whole, bf16, the ``serve`` cell
    (4 x 512 prompts, 32 tokens), through ``serve(..., rules=...)``
    against ``serve(...)`` from the same seeded weights: tokens equal,
    first and last logits bitwise, launches equal; then DeepSeek-V2 at
    ``deepseek_serve``'s 4-layer cut, bf16, 4 x 512 prompts and 8
    tokens: the MoE layers on the expert-parallel path under the rules
    and on the grouped path without, the drops of the prefill's first
    MoE layer equal (the later layers' printed), logits within
    ``DS_SERVE_SHARE``·max|logit|.  Host ms of the prefill and a decode
    step, launches, ``local_map`` calls and peak memory both ways."""
    from repro_torch.configs import get_config

    cfg = get_config("yi-6b")
    B, P, G = SHARDED_SERVE_YI
    plain, placed, yi = _serve_both(dev, cfg, B, P, G)
    forced_last = yi["sharded"].pop("forced_last_logits")
    yi |= {"forced_last_logits_bitwise": torch.equal(forced_last,
                                                     plain.last_logits),
           "arch": cfg.name, "layers": cfg.num_layers,
           "compute_dtype": cfg.compute_dtype, "batch": B, "prompt": P,
           "generated": G,
           "tokens_equal": torch.equal(placed.tokens, plain.tokens),
           "first_logits_bitwise": torch.equal(placed.first_logits,
                                               plain.first_logits),
           "last_logits_bitwise": torch.equal(placed.last_logits,
                                              plain.last_logits),
           "decode_host_ms_ratio": yi["sharded"]["decode_ms_per_step"]
           / yi["plain"]["decode_ms_per_step"],
           "sample_ids": placed.tokens[0, :12].tolist()}
    check(yi["tokens_equal"] and yi["first_logits_bitwise"]
          and yi["last_logits_bitwise"]
          and yi["forced_last_logits_bitwise"],
          f"Yi-6B under the serve rules: tokens "
          f"{yi['tokens_equal']}, logits {yi['first_logits_bitwise']} "
          f"{yi['last_logits_bitwise']}")
    del plain, placed, forced_last

    dcfg = _deepseek_cut(V2, 1, 3, "bfloat16")
    B, P, G = SHARDED_SERVE_DS
    plain, placed, ds = _serve_both(dev, dcfg, B, P, G)
    n_moe = 3
    # the prefill's logits, and the last step's with the decode steps
    # fed the plain serve's tokens: greedy tokens may part at a near-tie
    # of the top two logits, and then the free-running last logits are
    # those of other sequences (printed)
    forced_last = ds["sharded"].pop("forced_last_logits")
    diffs = [float((a - b).abs().max()) for a, b in (
        (placed.first_logits, plain.first_logits),
        (forced_last, plain.last_logits))]
    scale = max(float(plain.first_logits.abs().max()),
                float(plain.last_logits.abs().max()))
    ds |= {"arch": dcfg.name, "reduced": _reduced(get_config(V2), (1, 3)),
           "layers": dcfg.num_layers, "compute_dtype": dcfg.compute_dtype,
           "batch": B, "prompt": P, "generated": G,
           "tolerance_share": DS_SERVE_SHARE,
           "logits_max_abs_diff": diffs, "max_abs_logit": scale,
           "free_running_last_logits_max_abs_diff": float(
               (placed.last_logits - plain.last_logits).abs().max()),
           "token_agreement": float((placed.tokens == plain.tokens)
                                    .float().mean()),
           "decode_host_ms_ratio": ds["sharded"]["decode_ms_per_step"]
           / ds["plain"]["decode_ms_per_step"]}
    calls = G * n_moe
    check(ds["plain"]["moe_calls"] == {"grouped": calls, "ep": 0}
          and ds["sharded"]["moe_calls"] == {"grouped": 0, "ep": calls},
          f"MoE paths plain {ds['plain']['moe_calls']} sharded "
          f"{ds['sharded']['moe_calls']}")
    # the first MoE layer of the prefill sees bitwise-equal inputs both
    # ways (the dense layer and MLA run alike); later layers see the
    # bf16 roundings of the paths' gated sums, and a router near-tie
    # among 160 experts may then move an assignment: printed
    ds["drops_first_moe_layer_equal"] = \
        ds["sharded"]["drops"][0] == ds["plain"]["drops"][0]
    ds["drops_equal"] = ds["sharded"]["drops"] == ds["plain"]["drops"]
    check(ds["drops_first_moe_layer_equal"]
          and len(ds["sharded"]["drops"]) == len(ds["plain"]["drops"]),
          f"drops sharded {ds['sharded']['drops']} plain "
          f"{ds['plain']['drops']}")
    check(max(diffs) <= DS_SERVE_SHARE * scale,
          f"DeepSeek-V2 logits under the rules part by {diffs} "
          f"(max|logit| {scale})")
    del plain, placed
    torch.cuda.empty_cache()
    launches = {}
    for cell in (yi, ds):
        for k, v in cell["sharded"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"phase": "sharded_serve", "mesh": [1, 1], "yi": yi,
            "deepseek_v2": ds, "launches": launches, "nvidia_smi": smi}


#: compressed_train: the step's losses and parameters against
#: build_train_step's: with one pod no hop is made and the gradients are
#: scaled by the token count and divided by it again
COMPRESSED_LOSS_RTOL = 1e-6
COMPRESSED_PARAM_SHARE = 1e-6
COMPRESSED_STEPS = 2


def run_compressed_train(dev, smi):
    """The train cell (Yi-6B at full width, 4 layers, S=4096, B=8 in
    microbatches of 2, AdamW at a constant 1e-4, remat "full"):
    ``COMPRESSED_STEPS`` steps
    of ``build_compressed_train_step`` with int8 compression, its state
    donated (as ``launch/dryrun.py`` builds it), on a (1, 1, 1) ("pod",
    "data", "model") NCCL mesh against ``build_train_step``
    on plain tensors, each from the seeded state: losses within
    ``COMPRESSED_LOSS_RTOL``, every parameter leaf within
    ``COMPRESSED_PARAM_SHARE``·max|w|, no byte through the exchange, the
    launches of a step equal.  Then one microbatch's gradients through
    ``_q8`` / ``_dq8`` on the card: the wire bytes against f32, each
    leaf's round-trip error against absmax/127, and the quantiser's
    device ms against its bytes bound (the f32 read, the int8 write and
    the scales at the card's memory rate)."""
    import torch.distributed as dist

    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.kernels.local import LOCAL_MAP_CALLS
    from repro_torch.launch.mesh import ensure_process_group, make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import compression as comp
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import train_step as ts
    from repro_torch.sharding.rules import distribute_params, make_rules

    cfg = _train_cfg("yi-6b", layers=TRAIN_LAYERS)
    run = RunConfig(microbatch=TRAIN_MB, loss_chunk=512, remat="full",
                    optimizer="adamw", gradient_compression="int8")
    shape = ShapeConfig("train_4k_cut", "train", TRAIN_SEQ, TRAIN_BATCH)
    # a constant 1e-4: the train cell's warm-up would move the first
    # steps by ~1e-6 and leave the comparison nothing to see
    opt = make_optimizer("adamw", constant(1e-4))
    sch = ts.state_schema(cfg, run, opt)
    pipe = SyntheticLMPipeline(cfg, shape, device=dev)
    batches = [pipe.batch_at(i) for i in range(COMPRESSED_STEPS)]
    bw = peaks_for(torch.cuda.get_device_name(0))[0]

    def state0():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ts.new_state(ts.init_state(sch, gen, dev), opt)

    def steps(fn, state, bs):
        losses, ms, per_step = [], [], []
        for b in bs:
            _counts_zero()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
            per_step.append(_counts())
        return state, losses, ms, per_step

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    state, want_l, want_ms, want_n = steps(
        ts.build_train_step(cfg, run, opt), state0(), batches)
    want_p = [t.to("cpu") for t in tree_leaves(state["params"])]
    del state
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "a process group is already running")
    try:
        ensure_process_group(dev)
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), dev)
        rules = make_rules(mesh, "train")
        sh = ts.state_shardings(sch, rules, run)
        step = ts.build_compressed_train_step(cfg, run, opt, rules,
                                              donate=True)
        dbatches = [ts.distribute_batch(b, rules) for b in batches]
        sent0, calls0 = dict(comp.SENT), dict(LOCAL_MAP_CALLS)
        torch.cuda.reset_peak_memory_stats(dev)
        state, got_l, got_ms, got_n = steps(
            step, distribute_params(state0(), sh), dbatches)
        peak = torch.cuda.max_memory_allocated(dev)
        sent = {k: comp.SENT[k] - sent0[k] for k in sent0}
        calls = {k: LOCAL_MAP_CALLS[k] - calls0[k] for k in calls0}
        placed = all(tuple(t.placements) == s.placements for t, s in
                     zip(tree_leaves(state), tree_leaves(sh)))
        shares = {}
        for nm, g, w in zip(_leaf_names(M.train_schema(cfg)),
                            tree_leaves(state["params"]), want_p):
            w = w.to(dev)
            scale = float(w.abs().max())
            shares[nm] = float((g.to_local() - w).abs().max()) / scale \
                if scale else 0.0
        del state, dbatches
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    del want_p
    worst = max(shares, key=shares.get)
    rel = [abs(a - b) / abs(b) for a, b in zip(got_l, want_l)]
    bitwise = got_l == want_l and shares[worst] == 0.0
    check(all(r <= COMPRESSED_LOSS_RTOL for r in rel),
          f"compressed losses {got_l}, train step {want_l}")
    check(shares[worst] <= COMPRESSED_PARAM_SHARE,
          f"parameter {worst} parts by {shares[worst]} of its max")
    check(sent == {"int8": 0, "float32": 0}, f"one pod sent {sent}")
    check(got_n == want_n, f"launches compressed {got_n}, plain {want_n}")
    check(placed, "the new state left its placements")

    # the quantiser on one microbatch's gradients
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = ts.init_state(sch, gen, dev)
    mb = {k: v[:TRAIN_MB] for k, v in batches[0].items()}
    grads, _ = ts.compute_grads(cfg, RunConfig(loss_chunk=512,
                                               remat="full"), params, mb)
    del params
    torch.cuda.empty_cache()
    leaves = [g.float() for g in tree_leaves(grads)]
    del grads
    n = sum(g.numel() for g in leaves)
    int8_bytes = sum(comp.compressed_bytes(g.numel())[0] for g in leaves)
    worst_err = 0.0
    for g in leaves:
        q, s, k = comp._q8(g)
        err = float((comp._dq8(q, s, k, g.shape) - g).abs().max())
        bound = float(g.abs().max()) / 127.0
        check(err <= bound, f"int8 round trip {err} > absmax/127 {bound}")
        worst_err = max(worst_err, err / bound if bound else 0.0)
        del q, s
    blocks = sum((g.numel() + comp.CBLOCK - 1) // comp.CBLOCK
                 for g in leaves)
    q_bytes = 4 * n + n + 4 * blocks
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 3
    for g in leaves:                                        # warm-up
        comp._q8(g)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        for g in leaves:
            comp._q8(g)
    end.record()
    torch.cuda.synchronize()
    q_ms = start.elapsed_time(end) / reps
    del leaves
    torch.cuda.empty_cache()
    launches = {}
    for c in got_n:
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    return {"phase": "compressed_train", "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "seq": shape.seq_len, "global_batch": shape.global_batch,
            "microbatch": run.microbatch, "remat": run.remat,
            "optimizer": "adamw", "compression": run.gradient_compression,
            "mesh": {"pod": 1, "data": 1, "model": 1},
            "steps": COMPRESSED_STEPS,
            "tolerance": {"loss_rel": COMPRESSED_LOSS_RTOL,
                          "param_share_of_max": COMPRESSED_PARAM_SHARE},
            "losses_compressed": got_l, "losses_train_step": want_l,
            "loss_rel_diff": rel, "worst_leaf": worst,
            "worst_leaf_share": shares[worst], "bitwise": bitwise,
            "host_ms_per_step_compressed": got_ms,
            "host_ms_per_step_train_step": want_ms,
            "launches_per_step": got_n, "launches": launches,
            "local_map_calls": calls, "exchange_bytes_sent": sent,
            "peak_memory_bytes": peak,
            "quantiser": {
                "grad_values": n, "leaves": len(tree_leaves(sch["params"])),
                "wire_bytes_int8": int8_bytes, "wire_bytes_f32": 4 * n,
                "wire_ratio": 4 * n / int8_bytes,
                "worst_round_trip_share_of_bound": worst_err,
                "device_ms": q_ms, "bytes_moved": q_bytes,
                "bound_ms": q_bytes / bw * 1e3, "bound_by": "bytes",
                "route": "plain torch ops (XLA code in the JAX package, "
                         "no Pallas kernel)"},
            "nvidia_smi": smi}


#: pipeline_train: the one-process GPipe step against the train step,
#: each from the seeded state; the bounds were stated before the first
#: run on the card
PIPELINE_STAGES = (2, 4)
PIPELINE_MICRO = 4
PIPELINE_STEPS = 2
PIPELINE_LOSS_RTOL = 1e-4
PIPELINE_UPDATE_RL2 = 5e-2


def run_pipeline_train(dev, smi):
    """The train cell (Yi-6B at full width, 4 layers, S=4096, B=8, remat
    "full", AdamW at a constant 1e-4) through
    ``runtime/pipeline.py::build_pipeline_train_step`` with its stages in
    one process (``rules=None``) and its state donated (as
    ``launch/perf.py`` builds it), ``PIPELINE_MICRO`` microbatches of 2
    rows: ``PIPELINE_STEPS`` steps at each stage count of
    ``PIPELINE_STAGES`` (2 layers a stage, then one: the middle stages
    receive and send), each from the seeded state, against
    ``build_train_step`` in microbatches of 2 from the same state.  The
    batches carry no loss mask, so every microbatch counts the same
    tokens and the train step's mean of its microbatches' means is the
    pipeline's mean over the batch (the synthetic mask's document
    lengths would part the two by percents).  Checks: losses within
    ``PIPELINE_LOSS_RTOL``, each parameter leaf's update within
    ``PIPELINE_UPDATE_RL2`` relative L2 of the train step's (the worst
    leaf of each step printed), the launches of a step equal both ways
    and to ``launches_per_pass``, the hops' bytes a step 2 tensors ×
    (stages − 1) × B × S × d in the compute dtype (bf16) each way.  Prints host ms a step
    and peak memory both ways, the hops' bytes beside the f32 gradient
    bytes of each stage and of the whole model and the int8 wire bytes
    of ``compressed_train``'s exchange, and the bubble share (stages −
    1) / (n_micro + stages − 1), which one process does not spend:
    it skips the inactive ticks."""
    import dataclasses

    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params, tree_leaves
    from repro_torch.optim import compression as comp
    from repro_torch.optim import constant, make_optimizer
    from repro_torch.runtime import pipeline as pp
    from repro_torch.runtime import train_step as ts

    cfg = _train_cfg("yi-6b", layers=TRAIN_LAYERS)
    run = RunConfig(microbatch=TRAIN_MB, loss_chunk=512, remat="full",
                    optimizer="adamw", pp_microbatches=PIPELINE_MICRO)
    check(TRAIN_BATCH // PIPELINE_MICRO == TRAIN_MB,
          "a pipeline microbatch is not the train cell's")
    shape = ShapeConfig("train_4k_cut", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt = make_optimizer("adamw", constant(1e-4))
    sch = ts.state_schema(cfg, run, opt)
    pipe = SyntheticLMPipeline(cfg, shape, device=dev)
    batches = [{"tokens": pipe.batch_at(i)["tokens"]}
               for i in range(PIPELINE_STEPS)]
    names = _leaf_names(M.train_schema(cfg))
    per_step = {k: (TRAIN_BATCH // TRAIN_MB) * v for k, v in
                M.launches_per_pass(cfg, "train", remat=run.remat).items()}

    def state0():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ts.new_state(ts.init_state(sch, gen, dev), opt)

    def steps(fn, keep):
        state = state0()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out = {"losses": [], "host_ms": [], "launches": [], "hop_bytes": [],
               "kept": []}
        for i, b in enumerate(batches):
            sent0 = {d: dict(v) for d, v in pp.SENT.items()}
            _counts_zero()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, m = fn(state, b)
            out["losses"].append(float(m["loss"]))
            torch.cuda.synchronize()
            out["host_ms"].append((time.monotonic() - t0) * 1e3)
            out["launches"].append(_counts())
            out["hop_bytes"].append(
                {d: {k: n - sent0[d].get(k, 0) for k, n in v.items()}
                 for d, v in pp.SENT.items()})
            out["kept"].append(keep(i, state["params"]))
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        del state
        torch.cuda.empty_cache()
        return out

    base = [t.to("cpu") for t in tree_leaves(state0()["params"])]
    torch.cuda.empty_cache()
    want = steps(ts.build_train_step(cfg, run, opt),
                 lambda i, p: [t.to("cpu") for t in tree_leaves(p)])

    def update_rl2(i, params):
        """Each leaf's |Δ − Δ_train| / |Δ_train| in L2, Δ its update from
        the seeded state."""
        out = {}
        for nm, g, w, b in zip(names, tree_leaves(params), want["kept"][i],
                               base):
            w, b = w.to(dev), b.to(dev)
            ref = torch.linalg.vector_norm(w - b, dtype=torch.float64)
            err = torch.linalg.vector_norm(g - w, dtype=torch.float64)
            out[nm] = float(err / ref) if float(ref) else float(err)
        return out

    runs, launches = [], {}
    for stages in PIPELINE_STAGES:
        prun = dataclasses.replace(run, pipeline_stages=stages)
        step, sh = pp.build_pipeline_train_step(cfg, prun, opt, donate=True)
        check(sh is None, "the one-process form returned placements")
        got = steps(step, update_rl2)
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"])]
        worst = [max(r.items(), key=lambda kv: kv[1]) for r in got["kept"]]
        hop = 2 * (stages - 1) * TRAIN_BATCH * TRAIN_SEQ * cfg.d_model \
            * torch.empty((), dtype=cfg.cdtype).element_size()
        dtype = str(cfg.cdtype).removeprefix("torch.")
        check(all(r <= PIPELINE_LOSS_RTOL for r in rel),
              f"{stages} stages: losses {got['losses']}, train step "
              f"{want['losses']}")
        check(all(w <= PIPELINE_UPDATE_RL2 for _, w in worst),
              f"{stages} stages: worst leaves {worst}")
        for i in range(PIPELINE_STEPS):
            n = got["launches"][i]
            check({k: n[k] for k in per_step} == per_step
                  == {k: want["launches"][i][k] for k in per_step},
                  f"{stages} stages, step {i}: launches {n}, train step "
                  f"{want['launches'][i]}, predicted {per_step}")
            check(got["hop_bytes"][i] == {"forward": {dtype: hop},
                                          "backward": {dtype: hop}},
                  f"{stages} stages: hop bytes {got['hop_bytes'][i]}, "
                  f"predicted {hop} {dtype} each way")
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
        layers = cfg.num_layers // stages
        runs.append({
            "stages": stages, "layers_per_stage": layers,
            "losses_pipeline": got["losses"],
            "losses_train_step": want["losses"], "loss_rel_diff": rel,
            "worst_leaf_per_step": [{"leaf": k, "update_rel_l2": v}
                                    for k, v in worst],
            "host_ms_per_step_pipeline": got["host_ms"],
            "host_ms_per_step_train_step": want["host_ms"],
            "peak_memory_bytes_pipeline": got["peak_memory_bytes"],
            "peak_memory_bytes_train_step": want["peak_memory_bytes"],
            "launches_per_step": got["launches"],
            "launches_per_step_train_step": want["launches"],
            "hop_bytes_per_step": got["hop_bytes"][0],
            "bubble_share": (stages - 1) / (PIPELINE_MICRO + stages - 1)})
    del base, want
    torch.cuda.empty_cache()
    psch = M.train_schema(cfg)
    layer = count_params(psch["b0"]) // cfg.num_layers
    shared = {k: count_params(v) for k, v in psch.items() if k != "b0"}
    stage_bytes = {}
    for stages in PIPELINE_STAGES:
        n = [layer * (cfg.num_layers // stages)] * stages
        n[0] += shared["embed"]
        n[-1] += shared["final_norm"] + shared.get("unembed", 0)
        stage_bytes[str(stages)] = [4 * x for x in n]
    return {"phase": "pipeline_train", "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "seq": shape.seq_len, "global_batch": shape.global_batch,
            "pp_microbatches": PIPELINE_MICRO,
            "train_step_microbatch": run.microbatch, "remat": run.remat,
            "optimizer": "adamw", "lr": 1e-4, "steps": PIPELINE_STEPS,
            "loss_mask": "none (every token counts)",
            "tolerance": {"loss_rel": PIPELINE_LOSS_RTOL,
                          "update_rel_l2": PIPELINE_UPDATE_RL2},
            "runs": runs, "launches": launches,
            "launches_predicted_per_step": per_step,
            "grad_bytes_f32_per_stage": stage_bytes,
            "grad_bytes_f32_model": 4 * count_params(psch),
            "int8_wire_bytes_model": sum(
                comp.compressed_bytes(s.size)[0]
                for s in tree_leaves(psch)),
            "nvidia_smi": smi}


#: elastic_burst: the move of the train cell's Granite-8B cut between two
#: one-rank worlds; steps before the save, and after it in each world
ELASTIC_STEPS = 2
ELASTIC_LR = 1e-4
#: the demo's modelled overheads (``OverheadModel``): checkpoint, then
#: provision and restart, each in modelled steps of 1 s
ELASTIC_MODELLED = {"ckpt_s": 1.0, "provision_s": 4.0, "restart_s": 4.0,
                    "step_s": 1.0}
#: the demo's run on the card: ``tests/test_torch_elastic.py``'s cut
#: (steps, congestion from), whose events it holds to the JAX demo's; the
#: full 120 steps would take ~60 s of the phase's 150
ELASTIC_DEMO_CUT = (24, 14)


def _load_elastic_demo():
    import importlib.util

    path = ROOT / "examples" / "torch_elastic_burst_demo.py"
    spec = importlib.util.spec_from_file_location("torch_elastic_demo",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _world_steps(world, E, steps) -> list[dict]:
    """``steps`` steps on ``world``'s rank, each with its loss, host ms
    and the kernels' launches (counts set to 0 just before the step and
    read just after)."""
    out = []
    for i in steps:
        world.call(E.zero_counts)
        got = world.call(E.step, i)
        out.append({"step": i, "loss": got["loss"],
                    "host_ms": got["host_s"] * 1e3,
                    "launches": world.call(E.counts)})
    return out


def run_elastic_burst(dev, smi):
    """The elastic burst on the card: Granite-8B at full width cut to 4
    layers (the train cell's S = 4096, B = 8 in microbatches of 2,
    remat "full", AdamW at a constant 1e-4) in a one-rank NCCL
    ``World`` on (1, 1) ("data", "model"): ``ELASTIC_STEPS`` steps from
    the seeded state, a ``CheckpointManager`` generation, then
    ``ELASTIC_STEPS`` more (the un-moved run; its losses and every
    leaf's CRC-32 kept); the world closed; a new one-rank world on (1,
    1, 1) ("pod", "data", "model") restores the generation onto its pod
    placements and takes the same steps.  Checks: losses and every
    leaf's CRC equal, every restored leaf at its placement, launches a
    step equal to ``launches_per_pass``'s (32 flash, 68 norm), the
    demo on the card (at ``ELASTIC_DEMO_CUT``, run alongside the first
    world's start, setup and seeded state, which are no term of the
    move) equal to the modelled clock's events.  Prints the
    parent's allocated bytes, host ms a step and peak memory in each
    world, and the seconds and bytes of the save, the teardown and
    restart (close, spawn with NCCL and the mesh, the step's build) and
    the restore, beside the demo's modelled overheads (9 s against a
    1 s step)."""
    import io
    import threading

    from repro_torch.configs import RunConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import elastic as E
    from repro_torch.launch.world import World
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params

    t_phase = time.monotonic()
    cfg = _train_cfg("granite-8b", layers=TRAIN_LAYERS)
    run = RunConfig(microbatch=TRAIN_MB, loss_chunk=512, remat="full",
                    optimizer="adamw")
    shape = ShapeConfig("train_4k_cut", "train", TRAIN_SEQ, TRAIN_BATCH)
    spec = E.TrainSpec(cfg, run, shape, ELASTIC_LR)
    per_step = {k: (TRAIN_BATCH // TRAIN_MB) * v for k, v in
                M.launches_per_pass(cfg, "train", remat=run.remat).items()}
    n = ELASTIC_STEPS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parent = {"allocated_bytes": torch.cuda.memory_allocated(dev),
              "reserved_bytes": torch.cuda.memory_reserved(dev)}
    # the demo on the card (one-rank worlds) runs alongside the start of
    # the first world, whose seconds are no term of the move; it ends
    # before the first step.  Its events are held to the modelled
    # clock's, which the JAX demo's equal (tests/test_torch_elastic.py)
    demo = _load_elastic_demo()
    steps, congestion_from = ELASTIC_DEMO_CUT
    buf, box = io.StringIO(), {}

    def run_demo():
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(buf):
                box["card"] = demo.main([
                    "--meshes", "1x1,1x1x1", "--steps", str(steps),
                    "--congestion-from", str(congestion_from)])
        except BaseException as e:                       # noqa: BLE001
            box["error"] = e
        box["seconds"] = time.monotonic() - t0

    demo_thread = threading.Thread(target=run_demo)
    demo_thread.start()
    worlds = {}
    with tempfile.TemporaryDirectory() as ckpt:
        w = None
        try:
            w = World((1, 1), ("data", "model"), dev)
            rec = {"mesh": w.call(E.setup, spec)["mesh"],
                   "start_s": w.start_s, **w.start_info,
                   "started_alongside_the_demo": True}
            rec["init_s"] = w.call(E.init, SEED)["seconds"]
        except BaseException:
            if w is not None:
                w.close()
            raise
        finally:
            demo_thread.join()
        try:
            if "error" in box:
                raise box["error"]
            w.call(E.memory, True)
            rec["steps"] = _world_steps(w, E, range(n))
            rec["save"] = w.call(E.save, ckpt, n)
            rec["steps"] += _world_steps(w, E, range(n, 2 * n))
            rec["peak_memory_bytes"] = w.call(E.memory)["peak_bytes"]
            t0 = time.monotonic()
            crc_want = w.call(E.state_crcs)
            rec["crc_s"] = time.monotonic() - t0
        finally:
            t0 = time.monotonic()
            w.close()
            rec["close_s"] = time.monotonic() - t0
        worlds["1x1"] = rec
        w = World((1, 1, 1), ("pod", "data", "model"), dev)
        try:
            # the first call imports the train stack on the new rank: a
            # part of the restart, timed on the parent's clock
            t0 = time.monotonic()
            got = w.call(E.setup, spec)
            rec = {"mesh": got["mesh"], "start_s": w.start_s,
                   **w.start_info, "setup_s": time.monotonic() - t0,
                   "build_s": got["seconds"]}
            rec["restore"] = w.call(E.restore, ckpt, n)
            rec["placed"] = w.call(E.placed)
            w.call(E.memory, True)
            rec["steps"] = _world_steps(w, E, range(n, 2 * n))
            rec["peak_memory_bytes"] = w.call(E.memory)["peak_bytes"]
            crc_got = w.call(E.state_crcs)
        finally:
            t0 = time.monotonic()
            w.close()
            rec["close_s"] = time.monotonic() - t0
        worlds["1x1x1"] = rec
    first, moved = worlds["1x1"], worlds["1x1x1"]
    want_l = [s["loss"] for s in first["steps"][n:]]
    got_l = [s["loss"] for s in moved["steps"]]
    differ = sorted(k for k in crc_want if crc_got.get(k) != crc_want[k])
    check(moved["restore"]["data_step"] == n,
          f"restored data_step {moved['restore']}")
    check(moved["placed"], "a restored leaf is not at its placement")
    check(all(math.isfinite(x) for x in want_l + got_l),
          f"losses {want_l} {got_l}")
    check(got_l == want_l, f"moved losses {got_l}, un-moved {want_l}")
    check(set(crc_got) == set(crc_want) and not differ,
          f"leaves differ after the move: {differ[:5]}")
    for rec in worlds.values():
        for s in rec["steps"]:
            check({k: s["launches"][k] for k in per_step} == per_step,
                  f"step {s['step']}: launches {s['launches']}, "
                  f"predicted {per_step}")
    save_s = first["save"]["seconds"]
    restart_s = first["close_s"] + moved["start_s"] + moved["setup_s"]
    restore_s = moved["restore"]["seconds"]
    step_ms = [s["host_ms"] for s in first["steps"][1:] + moved["steps"][1:]]
    step_s = sum(step_ms) / len(step_ms) / 1e3
    overhead_s = save_s + restart_s + restore_s
    launches = {}
    for rec in worlds.values():
        for s in rec["steps"]:
            for k, v in s["launches"].items():
                launches[k] = launches.get(k, 0) + v

    card, demo_s = box["card"], box["seconds"]
    clock = demo.clock_record(steps, congestion_from)

    def events(r):
        return [[e.step, e.kind, e.detail] for e in r.events]

    out = buf.getvalue().strip().splitlines()
    check(out[-1] == "elastic_burst_demo OK", f"demo ended {out[-3:]}")
    check(events(card) == events(clock)
          and card.elapsed_s == clock.elapsed_s
          and card.met_deadline is clock.met_deadline is True,
          f"card demo events {events(card)}, clock {events(clock)}")
    burst = [e for e in card.events if e.kind == "burst"]
    return {"phase": "elastic_burst", "arch": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "reduced": f"36 -> {cfg.num_layers} layers",
            "params": count_params(M.train_schema(cfg)),
            "seq": shape.seq_len, "global_batch": shape.global_batch,
            "microbatch": run.microbatch, "remat": run.remat,
            "optimizer": "adamw", "lr": ELASTIC_LR,
            "parent_cuda": parent, "worlds": worlds,
            "losses_unmoved": want_l, "losses_moved": got_l,
            "leaves": len(crc_want), "leaves_differing": len(differ),
            "bitwise": got_l == want_l and not differ,
            "launches_predicted_per_step": per_step, "launches": launches,
            "checkpoint_bytes": first["save"]["bytes"],
            "save_s": save_s, "restart_s": restart_s,
            "restore_s": restore_s, "overhead_s": overhead_s,
            "host_ms_per_step": step_s * 1e3,
            "overhead_in_steps": overhead_s / step_s,
            "modelled": {**ELASTIC_MODELLED,
                         "overhead_s": sum(ELASTIC_MODELLED[k] for k in (
                             "ckpt_s", "provision_s", "restart_s")),
                         "overhead_in_steps": 9.0},
            "demo": {"meshes": "1x1,1x1x1", "steps": steps,
                     "congestion_from": congestion_from, "seconds": demo_s,
                     "events_equal_clock": True,
                     "burst": [[e.step, e.detail] for e in burst],
                     "elapsed_s": card.elapsed_s,
                     "deadline_s": card.deadline_s,
                     "met_deadline": card.met_deadline,
                     "lines": [ln for ln in out if ln.strip().startswith(
                         ("[session]", "step ", "elapsed ", "final loss"))]},
            "seconds": time.monotonic() - t_phase,
            "nvidia_smi": smi}


#: launch_cost: counted prefill FLOPs and decode bytes against the
#: smoke's formulas, and the roofline terms against their bounds, as a
#: share of the formula
COST_TOL = 0.01


def _host_us(fn, calls: int = 2000) -> float:
    """Host µs a call of ``fn`` over ``calls`` calls, the card's queue
    left to run behind them (drained before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _ops_vs_ctypes(dev) -> dict:
    """Each registered LM op against its bare ctypes call on the same
    card tensors: bitwise, at small bf16 shapes the kernels take."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.ssd import kernel as sk

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x, res, scale = rand(64, 4096), rand(64, 4096), rand(4096,
                                                         dtype=torch.float32)
    q, k, v = rand(2, 8, 128, 128), rand(2, 2, 128, 128), rand(2, 2, 128, 128)
    xdt, b, c = rand(4, 8, 64, 64), rand(4, 8, 64, 64), rand(4, 8, 64, 64)
    csum = torch.cumsum(-rand(4, 8, 64, dtype=torch.float32).abs(), -1)
    pairs = {
        "rmsnorm_residual": (rk.rmsnorm_residual_op(x, res, scale, 1e-5),
                             rk.rmsnorm_residual_cuda(x, res, scale, 1e-5)),
        "flash_attention": ((fk.flash_attention_op(q, k, v, True),),
                            (fk.flash_attention_cuda(q, k, v, causal=True),)),
        "ssd_chunk": (sk.ssd_chunk_op(xdt, b, c, csum),
                      sk.ssd_chunk_cuda(xdt, b, c, csum)),
    }
    torch.cuda.synchronize()
    out = {}
    for name, (got, want) in pairs.items():
        same = all(torch.equal(a, w) and a.stride() == w.stride()
                   for a, w in zip(got, want))
        check(same, f"registered op {name} is not bitwise its ctypes call")
        out[name] = "bitwise"
    return out


#: launch_cost's train cells, on the dry run's fake ranks: (arch, two
#: pods, microbatch or None for the arch's own), each at full width cut
#: to one layer of each kind (``dryrun.cut_depth``); one cell a site
#: family on (16, 16) — the attention projections, mamba's chunk views,
#: the sequence-sharded norm with MoE and mamba, MLA with the
#: expert-parallel MoE, whisper's embedding — and DeepSeek-V2 on
#: (2, 16, 16) at its own 16 rows a microbatch, fewer than the 32
#: ("pod", "data") ranks
LAUNCH_COST_TRAIN = (("yi-6b", False, None), ("mamba2-370m", False, None),
                     ("jamba-v0.1-52b", False, 128),
                     ("deepseek-v2-236b", False, 128),
                     ("whisper-large-v3", False, None),
                     ("deepseek-v2-236b", True, None))

_TRAIN_CELL = r"""
import dataclasses, json, sys
from pathlib import Path
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as dr

arch, multi, mb, out = (sys.argv[1], sys.argv[2] == "multi",
                        json.loads(sys.argv[3]), sys.argv[4])
cfg = get_config(arch)
cut = dr.cut_depth(cfg)
run = dr.run_config(cut, SHAPES["train_4k"])
cut_run = run if mb is None else dataclasses.replace(run, microbatch=mb)
dr.dryrun_cell(arch, "train_4k", multi, Path(out), cfg=cut, run=cut_run,
               reduced=dr.reduced_note(cfg, cut, run, cut_run))
"""


#: launch_cost's prefill (Yi-6B whole, bf16): batch, prompt
LAUNCH_COST_PREFILL = (4, 512)
#: launch_cost's held steps: ``moe_train``'s donated step of each of its
#: cells and one prefill of ``LAUNCH_COST_PREFILL`` under the serve
#: rules, each traced by ``dryrun.dryrun_step`` in a subprocess
HELD_STEPS = (V2, "jamba-v0.1-52b", "yi-6b-prefill")
#: the dry run's rise over a held step's arguments against the card's
#: allocator's (``max_memory_allocated`` less ``memory_allocated``
#: before the step), as a share of the card's
PEAK_TOL = 0.05

_HELD_STEP = r"""
import json, sys
from pathlib import Path
import chip_smoke

name, out = sys.argv[1], Path(sys.argv[2])
out.write_text(json.dumps(chip_smoke.held_dryrun(name)))
"""


def held_dryrun(name: str) -> dict:
    """``dryrun.dryrun_step`` of the held step ``name`` (``HELD_STEPS``)
    on a one-rank fake world and a (1, 1) mesh on ``cuda``: ``moe_train``'s
    donated step of the cell of that arch (its config, B x S, run and
    optimizer), or the serve rules' prefill of Yi-6B's bf16 weights at
    ``LAUNCH_COST_PREFILL``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun as dr

    if name == "yi-6b-prefill":
        B, P = LAUNCH_COST_PREFILL
        rec = dr.dryrun_step(get_config("yi-6b"),
                             ShapeConfig(name, "prefill", P, B))
    else:
        cfg, (B, S), _ = next(c for c in moe_train_cells()
                              if c[0].name == name)
        run = moe_train_run()
        rec = dr.dryrun_step(cfg, ShapeConfig("moe_train", "train", S, B),
                             run, opt=moe_train_optimizer(cfg, run))
    return {"memory": rec["memory"], "trace_s": rec["trace_s"]}


def _held_prefill(dev, cfg, params, prompts) -> dict:
    """The allocator's rise over one prefill of ``params`` (Yi-6B's bf16
    weights) and ``prompts`` under the serve rules on the one-rank NCCL
    mesh (a group started and closed here), after a warm-up, as
    ``held_dryrun("yi-6b-prefill")`` traces it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import serve_step
    from repro_torch.sharding.rules import make_rules

    check(not dist.is_initialized(), "a process group is already running")
    try:
        mesh = make_host_mesh(device=dev)
        check(tuple(mesh.shape) == (1, 1), f"host mesh {mesh}")
        rules = make_rules(mesh, "serve")
        dparams = serve_step.place_params(cfg, params, rules)
        inputs = serve_step.place_inputs(
            {"tokens": prompts.to(torch.int32)}, rules)
        prefill = serve_step.build_prefill(cfg, rules)
        prefill(dparams, inputs)                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = prefill(dparams, inputs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        del out
        args = _local_bytes(dparams) + _local_bytes(inputs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"step_base_bytes": base, "step_peak_bytes": peak,
            "step_rise_bytes": peak - base, "step_argument_bytes": args}


def held_peaks(card_steps: dict, dry: dict) -> list[dict]:
    """Each held step's rise over its arguments on the card
    (``card_steps``: the ``moe_train`` cells' and the prefill's records)
    and in the dry run (``dry``: ``held_dryrun``'s), the absolute peaks
    beside them, and the gap as a share of the card's rise."""
    out = []
    for name in HELD_STEPS:
        c, mem = card_steps[name], dry[name]["memory"]
        gap = mem["rise_bytes"] - c["step_rise_bytes"]
        out.append({
            "step": name, "card_rise_bytes": c["step_rise_bytes"],
            "dryrun_rise_bytes": mem["rise_bytes"], "gap_bytes": gap,
            "gap_share": gap / c["step_rise_bytes"],
            "card_peak_bytes": c["step_peak_bytes"],
            "dryrun_peak_bytes": mem["peak_bytes_per_device"],
            "card_base_bytes": c["step_base_bytes"],
            "card_argument_bytes": c["step_argument_bytes"],
            "dryrun_argument_bytes": mem["argument_size_in_bytes"],
            "dryrun_trace_s": dry[name]["trace_s"]})
    return out


def run_launch_cost(dev, moetrained):
    """The launch layer's cost tools on the card (module docstring,
    22f): Yi-6B whole under ``OpCostMode`` against the smoke's formulas,
    the registered ops against their ctypes calls, the norm's host cost
    a call both ways, the held prefill's rise (``_held_prefill``), and
    on the host in subprocesses started first the dry run of yi-6b ×
    decode_32k, of the ``LAUNCH_COST_TRAIN`` cells and of the
    ``HELD_STEPS``, each held step's rise against the card's
    (``moetrained``: phase ``moe_train``'s record)."""
    import os

    t_start = time.monotonic()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "yi-6b", "--shape", "decode_32k", "--mesh", "single", "--force",
             "--out", tmp],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)]
        procs += [subprocess.Popen(
            [sys.executable, "-c", _TRAIN_CELL, arch,
             "multi" if multi else "single", json.dumps(mb), tmp],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for arch, multi, mb in LAUNCH_COST_TRAIN]
        procs += [subprocess.Popen(
            [sys.executable, "-c", _HELD_STEP, name,
             str(Path(tmp) / f"held_{name}.json")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for name in HELD_STEPS]
        try:
            card = _launch_cost_card(dev)
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            check(p.returncode == 0, f"dry run exited {p.returncode}: "
                                     f"{log[-2000:]}")
        rec = json.loads((Path(tmp) / "single" / "yi-6b" /
                          "decode_32k.json").read_text())
        trains = [json.loads((Path(tmp) / ("multi" if multi else "single")
                              / arch / "train_4k.json").read_text())
                  for arch, multi, _ in LAUNCH_COST_TRAIN]
        dry = {name: json.loads((Path(tmp) / f"held_{name}.json")
                                .read_text()) for name in HELD_STEPS}
    check(rec["status"] == "ok", f"dry run cell: {rec.get('error')}")
    peak = rec["memory"]["peak_bytes_per_device"]
    card["dryrun"] = {
        "cell": "yi-6b × decode_32k × single", "chips": rec["chips"],
        "trace_s": rec["trace_s"], "roofline": rec["roofline"],
        "hlo_flops_per_dev": rec["hlo_flops_per_dev"],
        "hlo_bytes_per_dev": rec["hlo_bytes_per_dev"],
        "input_read_bytes_per_dev": rec["input_read_bytes_per_dev"],
        "collectives": rec["collectives"],
        "peak_gib_per_rank": peak / 2**30,
        "hbm_budget_ok": rec["hbm_budget_ok"], "chip": rec["chip"],
        "log_tail": logs[0].strip().splitlines()[-1:]}
    card["train_cells"] = []
    for t in trains:
        cell = f"{t['arch']} × train_4k × {t['mesh']}"
        check(t["status"] == "ok",
              f"dry run {cell}: {t.get('error')} {t.get('traceback')}")
        card["train_cells"].append({
            "cell": cell, "reduced": t["reduced"], "chips": t["chips"],
            "trace_s": t["trace_s"],
            "peak_gib_per_rank": t["memory"]["peak_bytes_per_device"] / 2**30,
            "dominant": t["roofline"]["dominant"],
            "hbm_budget_ok": t["hbm_budget_ok"],
            "useful_compute_ratio": t["useful_compute_ratio"]})
    steps = {c["arch"]: c for c in moetrained["cells"]}
    steps["yi-6b-prefill"] = card.pop("held_prefill")
    held = held_peaks(steps, dry)
    card["held_peaks"] = {"tolerance": PEAK_TOL, "steps": held}
    check(all(abs(h["gap_share"]) <= PEAK_TOL for h in held),
          f"dry-run rises against the card's: {held}")
    card["seconds"] = time.monotonic() - t_start
    return card


#: phase lint: its time limit, and the paths it watches for syncs
LINT_LIMIT_S = 30.0
LINT_SERVE = (4, 512, 4)          # Yi-6B: batch, prompt, decode steps
LINT_MAMBA = (4, 2048, 2)         # mamba2-370m: batch, prompt, decode steps
LINT_TRAIN = (2, 256)             # build_train_step: batch, sequence
LINT_FWI_BLOCKS = 8


def _ptxas_entries(log: str) -> list[tuple[str, int]]:
    """(mangled kernel, static shared bytes) of every entry function in
    an nvcc ``-Xptxas -v`` report."""
    import re

    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry and "Used" in line and "registers" in line:
            m = re.search(r"(\d+) bytes smem", line)
            out.append((entry, int(m.group(1)) if m else 0))
            entry = None
    return out


def _demangle_kernel(mangled: str) -> tuple[str, list]:
    """(name, template arguments) of a mangled kernel in a namespace,
    such as ``_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi128ELi128EEEv...``:
    ints from ``Li<n>E``, ``float`` from ``f``, a class by its name."""
    i = 3 if mangled.startswith("_ZN") else 2
    names = []

    def ident(i):
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        return mangled[j:j + n], j + n

    while mangled[i].isdigit():
        name, i = ident(i)
        names.append(name)
    targs = []
    if mangled[i] == "I":
        i += 1
        while mangled[i] != "E":
            if mangled[i] == "L":
                j = mangled.index("E", i)
                targs.append(int(mangled[i + 2:j]))
                i = j + 1
            elif mangled[i].isdigit():
                name, i = ident(i)
                targs.append(name)
            elif mangled[i] == "f":
                targs.append("float")
                i += 1
            else:
                raise SmokeFailure(f"cannot read template arguments of "
                                   f"{mangled}")
    return names[-1], targs


def lint_sizes(dev) -> dict:
    """Phase lint, part 2: the libraries' size queries against the
    Python formulas and ``smem-budget``'s static values, ptxas' static
    shared memory against the rule's count."""
    import ctypes

    from repro_torch.analysis.csrc import CudaSource
    from repro_torch.analysis.smem_budget import (
        launch_table,
        static_smem_bytes,
    )
    from repro_torch.kernels import build

    kdir = SRC / "repro_torch" / "kernels"
    libs = build.build_all()
    rows = launch_table(kdir)
    checked: dict[str, int] = {}
    for row in rows:
        stem = Path(row["source"]).stem
        qname, keys = row["query"]
        fn = getattr(ctypes.CDLL(str(libs[stem])), qname)
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_int] * len(keys)
        got = fn(*[int(row["config"][k]) for k in keys])
        check(got == row["python"] == row["dynamic"],
              f"{stem} {row['launch']} at {row['config']}: query {got}, "
              f"Python {row['python']}, rule {row['dynamic']}")
        checked[qname] = checked.get(qname, 0) + 1
    ptxas = []
    for stem, lib in sorted(libs.items()):
        src = CudaSource(build.sources()[stem])
        for mangled, smem in _ptxas_entries(
                lib.with_suffix(".log").read_text()):
            name, targs = _demangle_kernel(mangled)
            want = static_smem_bytes(src, name, targs)
            check(smem == want, f"{stem} {name}<{targs}>: ptxas {smem} B "
                                f"static shared memory, the rule {want}")
            ptxas.append({"kernel": f"{name}<{', '.join(map(str, targs))}>",
                          "ptxas_smem": smem, "rule_smem": want})
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    check(optin == build.MAX_SMEM_BYTES,
          f"the card's opt-in shared memory a block is {optin}, "
          f"MAX_SMEM_BYTES {build.MAX_SMEM_BYTES}")
    return {"queries": checked, "configurations": len(rows),
            "ptxas": ptxas, "smem_per_block_optin": optin}


def _sync_paths(dev):
    """Phase lint, part 3: the four watched paths, each as (name, setup
    -> run) with the setup unwatched."""
    import dataclasses

    from repro_torch.configs import RunConfig, dense_blocks, get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLMPipeline
    from repro_torch.fwi.solver import FWIConfig, make_block_runner
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import serve_step
    from repro_torch.runtime import train_step as ts

    def fwi():
        cfg = FWIConfig()
        run = make_block_runner(cfg, device=dev)
        p = torch.zeros((cfg.n_shots, cfg.nz, cfg.nx), device=dev)
        steps = LINT_FWI_BLOCKS * run.k
        return lambda: run(p, p.clone(), 0, steps)

    def serve(arch, B, P, steps):
        cfg = get_config(arch)
        cfg = dataclasses.replace(
            cfg, num_layers=2, blocks=(dataclasses.replace(
                cfg.blocks[0], repeat=2),) if arch != "yi-6b"
            else dense_blocks(2))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(M.schema(cfg), gen, dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                                generator=gen)
        prefill = serve_step.build_prefill(cfg, max_seq=P + steps)
        decode = serve_step.build_decode(cfg)

        def go():
            lg, cache = prefill(params, {"tokens": prompts})
            for i in range(steps):
                tok = torch.argmax(lg, -1)
                lg, cache = decode(params, cache, {"token": tok,
                                                   "pos": P + i})
            return lg
        return go

    def train(arch):
        cfg = _train_cfg(arch, layers=2)
        B, S = LINT_TRAIN
        run = RunConfig(loss_chunk=256, remat="full")
        opt = make_optimizer(cfg.optimizer)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(M.train_schema(cfg), gen, dev)
        state = ts.new_state(params, opt)
        batch = SyntheticLMPipeline(cfg, ShapeConfig("t", "train", S, B),
                                    device=dev).batch_at(0)
        step = ts.build_train_step(cfg, run, opt)
        return lambda: step(state, batch)

    return [("fwi_block_runner", fwi),
            ("yi6b_serve", lambda: serve("yi-6b", *LINT_SERVE)),
            ("mamba2_serve", lambda: serve("mamba2-370m", *LINT_MAMBA)),
            ("train_step", lambda: (train("yi-6b"), train("mamba2-370m")))]


def _watched(fn) -> dict[str, int]:
    """{site: syncs} PyTorch's sync-debug mode reports while ``fn``
    runs, each by its innermost frame in ``src/repro_torch`` (``outside:
    file:line`` where the port has none on the stack)."""
    import traceback
    import warnings

    port = str(SRC / "repro_torch") + "/"
    sites: dict[str, int] = {}
    active = [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        if not active[0] or "synchroniz" not in str(message):
            return
        where = None
        if str(filename).startswith(port):
            where = f"{Path(filename).relative_to(ROOT)}:{lineno}"
        else:
            for fr in reversed(traceback.extract_stack()):
                if fr.filename.startswith(port):
                    where = f"{Path(fr.filename).relative_to(ROOT)}:" \
                            f"{fr.lineno}"
                    break
        if where is None:
            where = "outside: " + " < ".join(
                f"{Path(fr.filename).name}:{fr.lineno}"
                for fr in reversed(traceback.extract_stack()[-8:-1]))
        sites[where] = sites.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        active[0] = True
        try:
            fn()
        finally:
            active[0] = False
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def lint_syncs(dev) -> dict:
    """Phase lint, part 3: every sync PyTorch reports on the watched
    paths is a ``host-sync`` finding or a suppressed line."""
    from repro_torch.analysis import Analyzer, HostSyncRule
    from repro_torch.analysis.__main__ import default_paths

    analyzer = Analyzer([HostSyncRule()], ROOT)
    ctxs = analyzer.load(default_paths(ROOT))
    by_rel = {c.rel: c for c in ctxs}
    flagged = {f"{f.file}:{f.line}" for rule in analyzer.rules
               for f in rule.run(ctxs, ROOT)}
    paths, missed = {}, {}
    for name, make in _sync_paths(dev):
        made = make()
        runs = made if isinstance(made, tuple) else (made,)
        for run in runs:                 # unwatched: caches, libraries
            run()
        sites: dict[str, int] = {}
        for run in runs:
            for k, v in _watched(run).items():
                sites[k] = sites.get(k, 0) + v
        del made, runs
        torch.cuda.empty_cache()
        paths[name] = sites
        for site in sites:
            rel, _, line = site.rpartition(":")
            ctx = by_rel.get(rel)
            covered = site in flagged or (
                ctx is not None and ctx.suppressed("host-sync", int(line)))
            if not covered:
                missed.setdefault(name, []).append(site)
        print(json.dumps({"lint_sync_sites": name, "sites": sites}),
              flush=True)
    check(not missed, f"syncs host-sync neither flags nor suppresses: "
                      f"{missed}")
    return {"paths": paths, "static_findings": sorted(flagged)}


def run_lint(dev, smi) -> dict:
    """Phase lint (module docstring, 22g)."""
    from repro_torch.analysis import Analyzer, default_rules, render_human
    from repro_torch.analysis.__main__ import default_paths

    t0 = time.monotonic()
    analyzer = Analyzer(default_rules(), ROOT)
    ctxs = analyzer.load(default_paths(ROOT))
    findings = analyzer.run(ctxs)
    lint_s = time.monotonic() - t0
    check(not findings, "lint findings:\n" + render_human(findings))
    t1 = time.monotonic()
    sizes = lint_sizes(dev)
    sizes_s = time.monotonic() - t1
    t2 = time.monotonic()
    syncs = lint_syncs(dev)
    syncs_s = time.monotonic() - t2
    seconds = time.monotonic() - t0
    check(seconds <= LINT_LIMIT_S,
          f"phase lint took {seconds:.1f} s, more than {LINT_LIMIT_S}")
    return {"phase": "lint", "files": len(ctxs),
            "rules": [r.name for r in analyzer.rules], "findings": 0,
            "lint_s": lint_s, "sizes": sizes, "sizes_s": sizes_s,
            "syncs": syncs, "syncs_s": syncs_s, "seconds": seconds,
            "nvidia_smi": smi}


def _launch_cost_card(dev) -> dict:
    """``launch_cost``'s work on the card (``run_launch_cost``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.launch import serve
    from repro_torch.launch.hw import spec_for
    from repro_torch.launch.op_cost import OpCostMode
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.models import model as M
    from repro_torch.runtime import serve_step

    name = torch.cuda.get_device_name(0)
    spec = spec_for(name)
    total_memory = torch.cuda.get_device_properties(dev).total_memory
    cfg = get_config("yi-6b")
    B, P = LAUNCH_COST_PREFILL
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = serve.make_params(cfg, dev, seed=SEED)
    prompts = serve.make_prompts(
        cfg, B, P, torch.Generator(device=dev).manual_seed(SEED + 1))
    prefill = serve_step.build_prefill(cfg, max_seq=P + 1)
    decode = serve_step.build_decode(cfg)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.monotonic() - t0) * 1e3

    prefill(params, {"tokens": prompts})                      # warm-up
    (want_pre, cache), pre_ms = timed(
        lambda: prefill(params, {"tokens": prompts}))
    tok = want_pre.argmax(-1)
    step = {"token": tok, "pos": P}
    # warm-up: writes position P, as every later call at this step does
    decode(params, cache, step)
    want_dec, dec_ms = timed(lambda: decode(params, cache, step)[0])
    _counts_zero()
    with OpCostMode() as pm:
        (got_pre, cache2), pre_mode_ms = timed(
            lambda: prefill(params, {"tokens": prompts}))
    launches_pre = _counts()
    _counts_zero()
    with OpCostMode() as dm:
        got_dec, dec_mode_ms = timed(lambda: decode(params, cache2, step)[0])
    launches_dec = _counts()
    check(torch.equal(got_pre, want_pre),
          "prefill logits differ under OpCostMode")
    check(torch.equal(got_dec, want_dec),
          "decode logits differ under OpCostMode")
    want_pre_l = M.launches_per_pass(cfg, "prefill")
    want_dec_l = M.launches_per_pass(cfg, "decode")
    check(launches_pre == {k: want_pre_l.get(k, 0) for k in launches_pre},
          f"prefill launches {launches_pre}, predicted {want_pre_l}")
    check(launches_dec == {k: want_dec_l.get(k, 0) for k in launches_dec},
          f"decode launches {launches_dec}, predicted {want_dec_l}")

    flops = qwen2vl_prefill_flops(cfg, B, P)
    read_bytes = decode_read_bytes(cfg, params, cache2)
    bw, bf16 = spec.hbm_bw, spec.peak_flops_bf16
    flops_share = pm.flops / flops["total"] - 1
    bytes_share = dm.input_read_bytes / read_bytes - 1
    check(abs(flops_share) <= COST_TOL,
          f"counted prefill FLOPs {pm.flops} vs {flops['total']}")
    check(abs(bytes_share) <= COST_TOL,
          f"counted decode bytes {dm.input_read_bytes} vs {read_bytes}")
    rl_pre = roofline_terms(pm.flops, pm.hbm_bytes, pm.result(), chip=spec)
    rl_dec = roofline_terms(dm.flops, dm.input_read_bytes, dm.result(),
                            chip=spec)
    rl_dec_launch = roofline_terms(dm.flops, dm.hbm_bytes, dm.result(),
                                   chip=spec)
    pre_bound_ms = flops["total"] / bf16 * 1e3
    dec_bound_ms = read_bytes / bw * 1e3
    check(abs(rl_pre["compute"] * 1e3 / pre_bound_ms - 1) <= COST_TOL,
          f"prefill compute term {rl_pre['compute']} s vs {pre_bound_ms} ms")
    check(abs(rl_dec["memory"] * 1e3 / dec_bound_ms - 1) <= COST_TOL,
          f"decode memory term {rl_dec['memory']} s vs {dec_bound_ms} ms")
    ops_check = _ops_vs_ctypes(dev)
    del cache, cache2
    held_prefill = _held_prefill(dev, cfg, params, prompts)
    del params
    torch.cuda.empty_cache()

    # the norm at a decode row (B rows of d) through the registered op and
    # through the bare ctypes call, alternated
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((B, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    r = torch.randn((B, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    sc = torch.ones(cfg.d_model, device=dev)
    via_op, via_ctypes = [], []
    for _ in range(3):
        via_op.append(_host_us(lambda: rk.rmsnorm_residual_op(x, r, sc,
                                                               1e-5)))
        via_ctypes.append(_host_us(lambda: rk.rmsnorm_residual_cuda(
            x, r, sc, 1e-5)))
    op_us, ct_us = float(np.median(via_op)), float(np.median(via_ctypes))
    return {
        "phase": "launch_cost",
        "spec": {"name": spec.name,
                 "peak_flops_bf16": spec.peak_flops_bf16,
                 "peak_flops_f32": spec.peak_flops_f32,
                 "hbm_bw": spec.hbm_bw, "hbm_bytes": spec.hbm_bytes,
                 "ici_link_bw": spec.ici_link_bw,
                 "ici_links": spec.ici_links, "dci_bw": spec.dci_bw},
        "card": name, "total_memory": total_memory,
        "arch": cfg.name, "layers": cfg.num_layers, "batch": B, "prompt": P,
        "prefill": {"counted_flops": pm.flops,
                    "formula_flops": flops["total"],
                    "share_off": flops_share,
                    "flops_by_op": pm.result()["flops_by_op"],
                    "hbm_bytes": pm.hbm_bytes,
                    "roofline": rl_pre, "bound_ms": pre_bound_ms,
                    "host_ms": pre_ms, "host_ms_under_mode": pre_mode_ms},
        "decode": {"input_read_bytes": dm.input_read_bytes,
                   "decode_read_bytes": read_bytes,
                   "share_off": bytes_share,
                   "hbm_bytes": dm.hbm_bytes,
                   "hbm_over_read": dm.hbm_bytes / read_bytes,
                   "roofline": rl_dec,
                   "roofline_launch_bytes": rl_dec_launch,
                   "bound_ms": dec_bound_ms,
                   "host_ms": dec_ms, "host_ms_under_mode": dec_mode_ms},
        "tolerance": COST_TOL,
        "logits_bitwise_under_mode": True,
        "launches": {k: launches_pre.get(k, 0) + launches_dec.get(k, 0)
                     for k in launches_pre},
        "launches_prefill": launches_pre, "launches_decode": launches_dec,
        "ops_vs_ctypes": ops_check,
        "held_prefill": held_prefill,
        "norm_host_us": {"host_us_op": op_us, "host_us_ctypes": ct_us,
                         "host_us_op_rounds": via_op,
                         "host_us_ctypes_rounds": via_ctypes,
                         "host_us_shape": [B, cfg.d_model]},
    }


if __name__ == "__main__":
    sys.exit(main())
