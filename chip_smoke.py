#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lft_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

1. builds the hand-written CUDA kernels from `lft_torch/csrc/` (nvcc,
   sm_90a, into `lft_torch/build/`) and prints their register/spill report;
2. loads the full-width 4x demo checkpoint (C=64, 5x5 views) onto the card;
3. makes two 5x5 scenes of 128x128 LR views from `--seed` (synthetic light
   fields, LR by Matlab-bicubic imresize);
4. runs `evaluate_dataset` (tiled SR, patch 32, stride 16, 16 patches per
   forward: 64 patches = 4 chunks a scene) with every launch counter at 0,
   and prints PSNR/SSIM of the model and of the bicubic skip alone;
5. runs the same scenes through the port's plain path on the card (the
   same forward with the blocks' plain PyTorch versions) and requires
   max |SR diff| <= 1e-3 and |dPSNR| <= 0.01 dB: the two sum f32 products
   in a different order, nothing more;
6. holds every kernel against its plain version at the shapes the main
   path gives it (K1 [16384, 25, 64], K2 [400, 32, 32, 64]) and times both
   with CUDA events (median after warm-up), beside the card's bound; the
   kernels that run their products 3xTF32 on the tensor cores (K1
   `ang_block`, K2's tokenization `spa_tokenize_ln`, `spa_qkv`,
   `spa_outproj_ln` and `spa_ffn_out`: bound on the tensor cores, K1's
   attention on the FP32 pipes, the FP32 pipes' whole bound printed beside)
   must keep each output within twice the f32 plain version's error against
   float64 and repeat bitwise, and so must the window step
   `spa_window_attn`; cuDNN's `F.conv2d` of the same memory (the
   tokenization's conv part only) and the cuBLAS f32 products of `spa_qkv`
   and `spa_outproj_ln` are timed beside them;
7. trains: the 4x recipe (Adam 2e-4, batch 4 of 32x32-view patches made on
   the card by `synth_batch` from `--seed`, a 160x160 LR mosaic) from the
   same checkpoint, through `make_train_step`: one step through the kernels
   (K1/K2 with residuals, K4/K3 backwards) against one through the plain
   blocks and backwards (|dloss| <= 1e-5 |loss|; under a smooth loss every
   parameter's max |dgrad| <= 5e-4 max |grad| + 2e-9), the kernel step
   repeated from the same state (bitwise equal gradients and params), 5
   further steps (finite loss), and the median ms a step of both paths;
8. holds every training kernel against its plain version at the training
   shapes (K1/K4 [4096, 25, 64], K2/K3 [100, 32, 32, 64]), max |diff| <=
   5e-4 max |plain| per output, and times them (the window step with stats
   beside one masked `scaled_dot_product_attention`, K3.e `spa_tokenize_bwd`
   beside cuDNN's `conv_transpose2d`; it, `ang_block_res`, K4
   `ang_block_bwd` (every output, each version from its own forward's
   residuals), K3.a `spa_ffn_out_bwd` (dx2, dattn, y, dy, xn2, the LN2
   sums) and K3.d `spa_qkv_ln_bwd` (dtok, dtokpe, the LN1 sums), bound
   as 3xTF32 (K4's attention on the FP32 pipes), and the window step with
   stats (attn, m, l) held to twice the f32 plain version's float64 error
   and a bitwise repeat); then `wgrad` at every
   product of the fused step (8 shapes, 56 launches a step) and `colsum` at
   its three shapes, timed in device time (a profiler trace of 20 calls,
   the host's launch path left out) beside `x.t() @ dy` / `a.sum(0)`, with
   `wgrad`'s error against float64 held to twice the f32 product's and both
   repeated bitwise;
9. runs the same two scenes through the unfused per-op branch
   (`fused=False`: LayerNorms, projections and FFNs as torch ops around the
   attention kernels K7 and K5): within 1e-3 / 0.01 dB of the plain unfused
   path (tiled torch attention) and of the fused kernel path, exactly 16
   `ang_attn` and 16 `spa_attn_hp` launches a scene and none of the fused
   blocks' kernels, and times a scene on both kernel paths;
10. trains one step with `--train_fused false` through the per-op kernels
    against the same step through the plain unfused path (the bounds of
    step 7), repeats it bitwise, counts exactly 4 launches a step of each of
    `ang_attn_res`, `ang_attn_bwd`, `spa_attn_hp_res`, `spa_attn_hp_bwd`,
    and times 5 further steps;
11. holds K7 and K5 (forward, forward with m and l, backward) against their
    plain versions at the serving shapes (K7 [16384, 25, 64], K5
    [400, 32, 32, 128]) and the training shapes ([4096, 25, 64],
    [100, 32, 32, 128]), times them beside their bound and one
    `scaled_dot_product_attention` call, and K5 in turns with K2's and K3's
    window steps at the same shape; K5's forward (K2.3's kernel) must equal
    K2.3's window step bit for bit, and K5's backward (from K5 res's m and
    l) keep dq, dk and dv within twice the f32 plain version's error
    against float64 and repeat bitwise; so must K7's outputs (out; out, m,
    l; dq, dk, dv from K7 res's own m and l);
12. holds K7 against its plain version at A2 = 81 (9x9 views), its outputs
    against float64 as in step 11, and trains at
    angRes 9 (batch 4 of 16x16-view patches) through `make_train_step`: with
    `--train_fused true` the fused blocks take it, 4 `ang_block_res` and 4
    `ang_block_bwd128` launches a step (K4 counted past 64 views) beside
    K2's and K3's kernels and no per-op kernel, gradients against the plain
    blocks within the bounds of step 7 (or twice the two plain paths' own
    difference), bitwise repeatable; the same step with `--train_fused false`
    through K7/K5; inference at angRes 9 stays fused;
13. runs the first scene through the unfused branch with the environment
    knobs `LFT_ANG_VARIANT=sweep` + `LFT_SPA_VARIANT=offset` (K8 and K9:
    exactly 16 `ang_attn_sweep` and 16 `spa_attn_offset` launches and no
    other kernel) and with `LFT_SPA_VARIANT=mxu` (16 `ang_attn` and 16
    `spa_attn_mxu`), each within 1e-3 / 0.01 dB of the plain unfused path
    and of step 9's K7/K5 result, and times a scene;
14. trains one `--train_fused false` step under each of the two settings
    against the plain unfused step (the bounds of step 7), repeats it
    bitwise, counts exactly 4 launches a step of each `_res` and `_bwd`
    kernel of the families in play and of nothing else, and times further
    steps;
15. drives the geometries that reach K8, K6 and K9 with the knobs unset: a
    12x12-view light field (A2 = 144, 48x48 LR views) through
    `evaluate_dataset` with default arguments (the gates send it to K8 + K5)
    and a train step there; a 5x5 scene at patch 64 (64x64 views: K7 + K6)
    and at patch 30 (no tile divides it: K7 + K9) through the unfused branch,
    and a train step on such patches; each SR result against the plain
    unfused path, each train step as in step 14;
16. holds every K8, K9 and K6 kernel (forward, with stats, backward) against
    its plain version at the serving and training shapes of steps 13-15,
    times each beside its bound and one `scaled_dot_product_attention` call,
    and K5, K6, K9, K10 and K2.3 (backwards: K5, K6, K9) in turns at one shape
    (K6, K9 and K10 launch K5's kernels: their outputs, all three forms of
    K6 and K9, must equal K5's bit for bit), and K6 against K10 in turns at
    [400, 64, 64, 128] (bit for bit too); K8 also at [2048, 144,
    64] (the 12x12-view step's batch), its outputs against float64 as K7's
    in step 11 (the backward from K8 res's own out, m, l), and at A2 = 25
    (K7's kernels under K8's names: the forward to 128 views, the backward
    to 32) bit for bit K7's;
17. runs the first scene through the tile-halo kernel K10: under
    `LFT_SPA_VARIANT=tile` at patch 32 (16 `ang_attn` + 16 `spa_attn_tile`
    launches) and under `LFT_SPA_VARIANT=offset` at patch 64 (64x64 = 4096 >
    2048 pixels: the large-view fallback, 4 + 4 launches), each within 1e-3 /
    0.01 dB of the plain unfused path, the first also of step 9's K7/K5 result;
18. runs K11, the fused SpaTrans forward on a pixel-major buffer, at
    [16, 32, 32, 25, 64] (the AngTrans output of the first scene's first chunk,
    block 0's weights): against its plain version and against view-major K2 on
    a permuted copy, exactly one launch of each of its five kernels, no more
    device memory than K2 itself takes, and times it in turns with "permute +
    K2 + permute back";
19. holds K10 at [400, 32, 32, 128] and [400, 64, 64, 128] (and bit for
    bit to K5's forward there), K4 at the
    angRes-9 step's [1024, 81, 64] (held to float64 and a bitwise repeat as
    in step 8) and, with a ragged last tile, at A2 = 121 and 128, and K11's
    two `_pm` kernels against their plain versions, timed beside their
    bounds (K10 also beside one `scaled_dot_product_attention` call;
    `spa_tokenize_ln_pm` and `spa_ffn_out_pm` held to float64 and a bitwise
    repeat as K2.1 and K2.5);
20. drives the user entry points below their h5 readers, with the demo
    checkpoint: (a) the test CLI's body (`lft_torch.test.evaluate_sets`) on
    step 3's scenes as an in-memory test set (stored transposed as the h5
    files hold them, with `scene_name` and `scene_shape`), logging into a
    temporary `--path_log`: one log line a scene, the `Test on` and `Mean
    over datasets` lines, PSNR/SSIM equal to step 4's bit for bit, 16
    launches of each fused forward kernel a scene and no other kernel;
    (b) the same with `--profile_dir`: its trace must name `ang_block` and
    `spa_window_attn` (its idle share printed); (c) the train CLI
    (`lft_torch.train.main`) for 2 epochs of 2 steps (batch 4 of 8
    `synth_batch` patches of 32x32 views from `--seed`, `--train_fused
    auto`) from the checkpoint's weights: finite losses, both epoch
    checkpoints under lft_tpu's names, 4 launches a step of each per-op
    training kernel, and a resume from the epoch-1 file that ends on the
    uninterrupted run's parameters bit for bit; (d) without h5py, `python
    -m lft_torch.test` on an h5 path must fail naming h5py; (e) the test
    CLI's ms a scene with and without the prefetch thread, in turns, and
    an unprefetched scene's read, copy to the card, SR and metrics apart;
21. data parallelism (`lft_torch/parallel/`) on the one card: (a) with
    `--num_devices 1 --coordinator localhost:<free port> --num_processes 1`
    through `maybe_initialize` (nccl, world size 1), two Adam steps of the
    4x recipe (batch 4 of step 7's `synth_batch` patches, the demo
    checkpoint) through `make_dp_train_step` bitwise equal to
    `make_train_step`'s (loss, PSNR, SSIM, grads, params), 4 launches a step
    of each per-op training kernel and no other; (b) two gloo ranks spawned
    on the card (NCCL refuses two ranks a card), the batch split 2 + 2:
    under SGD two DP steps within |dloss| 1e-6 and max |dparam| 1e-6 of
    one process's steps on all 4 (under step 7's smooth loss: the L1
    loss's sign flips at residuals within f32 noise of 0 would set the
    difference), the DP step's averaged gradient bitwise the mean of the
    two shares' gradients taken in one process, under Adam both ranks'
    params bitwise
    equal after two steps, each rank's DP step 4 launches of each per-op
    training kernel and no other; (c) step 3's first scene super-resolved
    with its patch grid split over the two ranks (16 launches of each
    fused forward kernel a rank, the same mosaic on both) within 1e-3 max
    |diff| and 0.01 dB of step 4's; (d) the device ms a step of (a)'s DP
    step and of `make_train_step`, in turns (a b b a), and the kernels
    whose device time differs most between the two in a trace: the cost of
    the flat buffer and its all-reduce. The ranks are joined with a timeout;
22. `--dtype mixed` (lft_tpu's per-site plans: the forward at `all`, the
    fused backward at `none`, every product over bf16 operands): (c) step
    3's scenes under `mixed` bitwise equal to step 4's (mosaics, PSNR,
    SSIM), only the forward kernels launched; (e) scene 0 under
    `--matmul_precision high` against `highest`, max |diff| and dPSNR
    printed; (b) the fused train step of the 4x recipe under `mixed`
    through the kernels against the plain blocks under the plan: the loss
    within 1e-5, the smooth loss's gradients as one vector within 1e-3
    L2-relative and 0.1 of the plain mixed-vs-f32 distance, each
    parameter's within half of it; a bitwise repeat; each bf16 instance of
    K3's five steps and K4 launched 4 times a step, `wgrad_bf16` 56, no f32
    K3, K4 or `wgrad`, K1 res and K2 res as before; the ms a step beside the
    f32 fused step's in turns (f32, mixed, mixed, f32); the same checks of
    two mixed steps at angRes 9 (batch 4 of 16x16-view patches), where K4
    takes its 128-row form (`ang_block_bwd128_bf16`); (a) each bf16
    instance against its plain version under the plan at the step's shapes
    (K3 [100, 32, 32, 64], K4 [4096, 25, 64] and [1024, 81, 64], `wgrad` at
    the 8 products): per output 1e-3 L2-relative and 0.1 of the plain
    mixed-vs-f32 distance, a bitwise repeat, timed beside its bound (one
    TF32 pass over the products); (d) each one's device ms beside its f32
    instance's in turns, the card's name and power limit printed;
23. `--dtype bfloat16` serving (lft_tpu's all-bf16 mode: the fused blocks'
    `_bf16io` kernels, bf16 activations and weights): (b) step 3's scenes
    under `bfloat16` through `evaluate_dataset` with every count at 0: 16
    launches a scene of each `_bf16io` kernel and no other kernel of the
    port; the scenes against the plain blocks under `bfloat16` on the card
    (|dPSNR| <= 0.01 dB; each scene's distance from the f32 scene within
    BF16_SCENE_TOL of the plain blocks', and its L2 from theirs within
    BF16_SCENE_L2 of that distance: four blocks of bf16 roundings leave the
    two as far apart as either is from f32, tests/test_torch_bf16.py), the
    dPSNR against the f32 scenes beside lft_tpu's -0.20 dB, the test CLI's
    body under `bfloat16` (PSNR/SSIM equal to (b)'s), the device ms of the
    f32 and the bf16 scene in turns (f32, bf16, bf16, f32) and the bf16
    scene's device ms by kernel; (a) each `_bf16io` instance against its
    plain bf16 version at the main path's shapes (K1 [16384, 25, 64], K2
    [400, 32, 32, 64], each step fed its plain predecessor's output):
    per output L2 within BF16_GAP of the plain bf16-vs-f32 distance and no
    element off by more than BF16_ULPS bf16 ulps of max |plain|, a bitwise
    repeat, timed beside its bound (bf16 bytes, every operation at the bf16
    rate) and the bf16 library calls; the redesigned kernels at the widths
    and views the main path does not give them (`window_width_checks`,
    `ang_bf16_width_checks`, `ffn_bf16io_width_checks`,
    `tok_bf16_width_checks`: K2.1 / K11.1 at every C and 32 x 32, 30 x 30,
    64 x 64 views, the pixel-major form bit for bit the view-major one);
24. `--dtype bfloat16` training (lft_tpu's fused bf16 train step: K1 res,
    K2 res, K4, K3 and `wgrad` in their `_bf16io` instances, the master
    weights and Adam state f32): (a) the fused train step of the 4x recipe
    from the demo checkpoint under `bfloat16` (`--train_fused auto`) through
    the kernels against the same step through the plain blocks: |dloss|
    within BF16T_LOSS |loss|, the smooth loss's gradient (one vector) within
    BF16T_TOL of the plain step's distance from the f32 step's and within
    BF16T_L2 of that distance from the plain step's gradient, the master
    weights f32, a bitwise repeat, and 4 launches a step of each of
    `ang_block_res_bf16io`, `spa_window_attn_res_bf16io`,
    `ang_block_bwd_bf16io`, K3's five `_bf16io` steps and K2's other four
    `_bf16io` steps, 56 of `wgrad_bf16io`, 16 of `colsum` (its inputs are
    f32 partial sums) and no f32 or `_bf16` form; (b) two such steps at
    angRes 9 and patch 16, where K4 takes its 128-row form
    (`ang_block_bwd128_bf16io`); (c) each new kernel against its plain bf16
    version at the step's shapes (K1 res and K4 [4096, 25, 64], K4 [1024,
    81, 64], K2.3 res and K3 [100, 32, 32, 64], `wgrad_bf16io` at the 8
    products and with an f32 dy), the plain f32 version on the same values
    the yardstick (`bf16t_err`), K1 res's out and K2.3 res's attn bit for bit
    the serving kernels', a bitwise repeat, each timed in device time beside
    its bound (bf16 bytes, the bf16 rate), `wgrad_bf16io` also beside
    `torch.mm(x.t(), dy, out_dtype=torch.float32)` (warm, and with L2
    flushed by a 512 MB write before each call), then beside its f32 and
    `_bf16` instances in turns; (d) the step's ms under float32, mixed and
    bfloat16, in turns; (e) the train CLI's body under `bfloat16` for 2
    epochs of 2 steps (f32 checkpoints; a resume from the epoch-1 file ends
    on the uninterrupted run's parameters bit for bit);
25. `--dtype bfloat16` serving through the unfused per-op branch (lft_tpu's
    bf16 unfused branch: the per-op forwards' `_bf16io` kernels, the torch
    ops around them at lft_tpu's rounding points): (a) the demo checkpoint's
    bf16 scenes through `make_scene_sr` on step 15's geometries, each with
    every count at 0: 5x5 with `fused=False` (K7 + K5), 12x12 views with
    default arguments (K8's sweep + K5), 30x30-view patches (K7 + K9),
    64x64-view patches (K7 + K6), and `LFT_SPA_VARIANT=tile` with
    `LFT_ANG_VARIANT=sweep` at 5x5 (K10 + K8 through K7's f32-inside
    instance): exactly the expected `_bf16io` launches and no other kernel,
    a bitwise repeat, |dPSNR| <= 0.01 dB against the same scene through the
    kernels' plain versions on the card (`plain_blocks=True`), its distance
    from the f32 scene within BF16_SCENE_TOL of theirs and its L2 from
    theirs within BF16_SCENE_L2 of that distance, and the ms of the f32 and
    the bf16 scene in turns (f32, bf16, bf16, f32; CUDA events around two
    back-to-back scenes); (b) each of the
    six instances against its plain bf16 version at its scene's shapes (K7
    and K8 [16384, 25, 64], K8 [9216, 144, 64], K5 and K10 [400, 32, 32,
    128], K9 [400, 30, 30, 128], K6 [400, 64, 64, 128]): L2 within BF16_GAP
    of the plain bf16-vs-f32 distance and BF16_ULPS bf16 ulp, a bitwise
    repeat, timed by CUDA events around back-to-back calls beside its bound
    (bf16 bytes; operations on the FP32 pipes), the plain version and bf16
    `scaled_dot_product_attention` (a window mask for the spatial ones),
    then in turns with its f32 instance (f32, bf16, bf16, f32);
26. `--dtype bfloat16` training through the unfused per-op branch
    (lft_tpu's bf16 unfused train step: the `_res` forms and backwards of
    K5-K9 in their `_bf16io` instances, the torch ops around them under
    torch's autograd in bf16, the master weights and Adam state f32): (a)
    the 4x recipe's `--train_fused false` step from the demo checkpoint
    under `bfloat16` through the kernels against the same step with the
    kernels' plain versions on the card (`common.plain_versions()`): |dloss|
    within BF16T_LOSS |loss|, the smooth loss's gradient within BF16T_TOL
    of the plain step's distance from the f32 plain step's and within
    BF16T_L2 of that distance from the plain step's gradient, the master
    weights f32, a bitwise repeat, and exactly 4 launches a step of each
    expected `_res_bf16io` and `_bwd_bf16io` instance and of no other
    kernel (no f32 form), on four geometries that between them launch all
    ten: 5x5 views at patch 32 (K7 + K5), `LFT_SPA_VARIANT=mxu` (K7 + K6),
    `LFT_ANG_VARIANT=sweep` + `LFT_SPA_VARIANT=offset` (K8 through K7's
    f32-inside instance at A2 = 25 and the streamed backward, + K9), angRes
    12 at batch 2 (K8's sweep past 128 views + K5); (b) the data-parallel
    bf16 step at world size 1 (an nccl group of one rank) bitwise equal to
    (a)'s first step; (c) each of the ten instances against its plain bf16
    version at the step's shapes (K5, K6, K9 [100, 32, 32, 128], K7 and K8
    [4096, 25, 64], K8 [2048, 144, 64]; each backward fed the plain `_res`
    form's out, m, l), the plain f32 version on the same values the
    yardstick (`bf16t_err`), a bitwise repeat, timed by CUDA events beside
    its bound (bf16 bytes; operations on the FP32 pipes), the plain version
    and (the `_res` forms) bf16 `scaled_dot_product_attention`, then in
    turns with its f32 instance; (d) the per-op step's ms under float32 and
    bfloat16 in turns; (e) the train CLI's body under `bfloat16
    --train_fused false` for 2 epochs of 2 steps, a resume from the epoch-1
    file ending on the uninterrupted run's parameters bit for bit;
27. the last forward forms of the fused blocks (`fwdforms_phase`): (a) K11
    on a bf16 pixel-major buffer [16, 32, 32, 25, 64] with block 0's
    weights in bf16: one launch of each of its five `_bf16io` kernels, the
    chain bitwise view-major K2 bf16io's on a permuted copy, K11's two
    `_pm_bf16io` kernels against their plain versions with step 23's
    bounds and a bitwise repeat; K11 on the f32 buffer under
    LFT_MM_HP_SITES=none likewise (its five `_bf16` kernels); (b) step 3's
    scenes under `--dtype mixed` with LFT_MM_HP_SITES=none: 16 launches a
    scene of each of the six `_bf16` forwards and no other kernel, |dPSNR|
    <= 0.01 dB against the same scenes through the plain blocks under the
    plan, the distance from the f32 scene within 10% of theirs and the L2
    from theirs within 1.5 of it, a bitwise repeat, dPSNR against f32; (c)
    each of the eight `_bf16` kernels against its plain version under the
    plan (step 22's bounds) at the main path's shapes, a bitwise repeat,
    timed by CUDA events beside its bound (f32 bytes, the products at the
    bf16 rate), K1's and K2.1's at the widths and views the main path does
    not give them (`ang_bf16_width_checks`, `tok_bf16_width_checks`); (d) a
    train step and a forward under a site subset of the
    backward plan (`qk,ffn`) run, each launch as `common.card_plan` names
    it (the backward's `_sites` instances: step 30); (e) each
    new kernel in turns with its f32 instance (K11's `_pm_bf16io` with
    view-major K2 bf16io's), and the `none` scene with the f32 scene
    (device busy, CUDA-event time, idle share);
28. `--dtype mixed` training under LFT_MM_HP_SITES=none (`none_train_steps`):
    (a) the 4x recipe's fused step (C=64, batch 4 of 32x32-view patches)
    through the kernels against the plain blocks under the same plans:
    |dloss| <= 1e-3 |loss|, under the smooth loss the gradient's distance
    from the plain f32 step's within 10% of the plain step's and its L2
    from the plain step's within 1.5 of it, a bitwise repeat; (b) the same
    under LFT_MM_HP_BWD_SITES=all; (c) both at angRes 9, patch 16; (d) the
    launches a step: `ang_block_res_bf16`, `spa_window_attn_res_bf16` and
    K2's other four `_bf16` steps 4 each, no f32 forward step, the
    backward's `_bf16` instances under `none` (K4 as `ang_block_bwd128_bf16`
    at angRes 9) and its f32 kernels under `all`, K4 as `ang_block_bwd_dp`
    (`ang_block_bwd128_dp`: D from its own p); (e) K1 res and K2.3 res in
    their `_bf16` forms and K4's `_dp` instance against their plain versions
    at the step's shapes (`none_kernel_checks`), timed beside their bound
    and in turns with their f32 forms; (f) the train CLI's body under
    `--dtype mixed` for 2 epochs of 2 steps, a resume from the epoch-1 file
    ending on the uninterrupted run's parameters bit for bit; (g) the step's
    ms under `none` beside `all` in turns; (h) SSIM under `--matmul_precision
    high` bitwise equal to SSIM under `highest`;
29. `--dtype mixed` under the LFT_MM_HP_SITES subsets S1 = `qk,score,ffn,
    aqkv,aav,wo` and its complement S2 (`sites_phase`; ROADMAP 9h): (a) K11
    on the f32 buffer [16, 32, 32, 25, 64] under S1, its launches bitwise
    view-major K2's chain under S1; (b) step 3's scenes under each subset:
    16 launches a scene of each fused step's instance as `common.card_fwd`
    names it (under S1 `ang_block_sites`, `spa_qkv_sites`,
    `spa_window_attn_sites`, `spa_ffn_out_sites`, K2.1 `_bf16` and K2.4
    f32) and no other kernel, |dPSNR| <= 0.01 dB against the plain blocks
    under the subset, the distance from the f32 scene within 10% of theirs
    and the L2 from theirs within 1.5 of it, a bitwise repeat; (c) the fused
    train step under S1 with the backward plans `none` and `all`, held as
    step 28 holds `none` (K1 res and K2.3 res as `_sites`); (d) each of the
    seven `_sites` kernels under S1 and S2 against its plain version at the
    main path's shapes (step 27's bounds; the `_res` forms also step 28's
    bf16 ulps, m and l, and attn of bf16 values exactly where `awo` / `wo`
    rounds), a bitwise repeat, timed by CUDA events beside its bound (f32
    bytes, each product at the bf16 rate where its site rounds and as
    3xTF32 where it does not), and K1's (csrc/ang_sites.cuh) under S1, S2
    and M3 (`aqkv` and `awo` round) at every C and 25, 81, 121 views, out
    and attn held to float64 at the plain version's rounding points
    (`ang_sites_width_checks`, `f64_mixed_err`); (e) each `_sites` kernel in
    turns with its f32 and `_bf16` instances;
30. `--dtype mixed` training under the LFT_MM_HP_BWD_SITES subsets S1 and
    S2 (`bwd_sites_phase`; ROADMAP 9h-b): (b) the fused train step under
    (forward `none`, backward S1), (S2, S2) and (`none`,
    `aqkv,ascore,aav,awo,affn`), and under (`none`, S1) at angRes 9, held as
    step 28 holds `none`: its gradient's distance from the plain step's as
    a fraction of the plain step's distance from f32, and each launch as
    `common.card_plan` names it (K3.a-K3.d and K4 as `_sites`, K3.e and the
    weight gradients by their own sites; K4 as `ang_block_bwd_dp` under the
    third); (c) the train CLI's body under (`none`, S1) for 2 epochs of 2
    steps, a resume from the epoch-1 file ending on the uninterrupted run's
    parameters bit for bit; (a) each of the six backward `_sites` kernels
    under S1 and S2 against its plain version at the step's shapes (step
    29's bounds), a bitwise repeat, timed by CUDA events beside its bound;
    (d) each in turns with its f32 and `_bf16` instances;
31. prints the script's seconds, the `kernels` JSON line (every kernel, old
    and new), the card's name and power limit, and last `{"ok": true,
    "device": {...}}`.

The plain and library versions of the large shapes of steps 16 and 19 are
timed over 3 launches instead of 10.

Launch counts are per phase: the SR run must launch every forward kernel
and no training kernel, the training run every training kernel, the per-op
runs only the per-op kernels.

Every check raises; the script exits non-zero on any failure, without a
CUDA card, and when run outside the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "examples", "synth_demo", "LFT_5x5_4x_synth3000.pth")
# Published dense rates (FP32 FLOP/s without tensor cores, memory B/s, TF32
# and bf16 FLOP/s on the tensor cores), keyed by a fragment of the card's
# name; an H100 SXM unless named.
PEAKS = {"PCIe": (51e12, 2.0e12, 378e12, 756e12), "NVL": (60e12, 3.9e12, 417.5e12, 835e12)}
PEAK_SXM = (67e12, 3.35e12, 495e12, 989e12)
# per kernel: max |kernel - plain| <= KERNEL_ATOL * max(1, max |plain|); both sum
# the same f32 products in another order
KERNEL_ATOL = 1e-4
# the training kernels, per output: max |kernel - plain| <= TRAIN_REL * max |plain|
# (the JAX package's fused-vs-unfused gradient bound, tests/test_kernels.py:428)
TRAIN_REL = 5e-4
TRAIN_STEPS = 5          # kernel-path steps after the compared and repeated ones
# `--dtype mixed`'s bf16-operand instances, per output: L2-relative to the plain
# version under the plan, and that distance over the plain mixed-vs-f32 one (a
# kernel that ran f32 lies within ~2% of mixed)
MIXED_REL, MIXED_GAP = 1e-3, 0.1
# `--dtype bfloat16`'s `_bf16io` instances, per output: L2 from the plain bf16
# version over the plain bf16-vs-f32 distance, and max |diff| in bf16 ulps of
# max |plain| (an f32 sum in another order rounds to the neighbouring bf16
# value now and then: one ulp at an element's own magnitude); the bf16
# scene: its distance from the f32 scene against the plain blocks', and its
# L2 from the plain blocks' scene over that distance
BF16_GAP, BF16_ULPS = 0.1, 1.0
BF16_SCENE_TOL, BF16_SCENE_L2 = 0.1, 1.5
# `--dtype bfloat16` training: a kernel output whose plain bf16 and f32
# versions run the same f32 arithmetic (dtokpe, the LN partial sums) within
# BF16T_F32_REL L2-relative of the plain bf16 one; the step against the plain
# blocks: |dloss| within BF16T_LOSS |loss|, the kernel gradient's distance
# from the f32 step's within BF16T_TOL of the plain step's, and its L2 from
# the plain step's within BF16T_L2 of that distance (four blocks of bf16
# roundings decorrelate: tests/test_torch_bf16train.py)
BF16T_F32_REL = 1e-4
BF16T_LOSS, BF16T_TOL, BF16T_L2 = 1e-3, 0.1, 1.5
# ... and an element of a bf16 output within BF16T_ULPS bf16 ulps of max
# |plain|: a backward's bf16 intermediate (ds, p, dpre) that rounds to its
# neighbouring bf16 value in one of the two moves the sums it enters by
# its own ulp, which cancellation can leave above the output's (K4's dq,
# 1.75 ulps at [4096, 25, 64] on an H100; L2 0.016 of the distance)
BF16T_ULPS = 4.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for frag, p in PEAKS.items():
        if frag in name:
            return p
    return PEAK_SXM


def timed(fn, reps: int = 10, warmup: int = 2):
    """Median milliseconds of `fn()` over `reps` launches, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_err(got, ref, rel=None):
    """(max |got - ref| over the outputs, whether every output is within
    KERNEL_ATOL * max(1, max |ref|), or rel * max |ref| where given). A
    failure prints every output's error."""
    import torch
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst, ok, report = 0.0, True, []
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"bad kernel output: shape {tuple(g.shape)} vs {tuple(r.shape)}")
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        lim = KERNEL_ATOL * max(1.0, scale) if rel is None else rel * scale
        ok = ok and err <= lim
        worst = max(worst, err)
        report.append(f"#{i} {tuple(g.shape)}: {err:.3e} (limit {lim:.3e})")
    if not ok:
        print("  per output: " + "; ".join(report), flush=True)
    return worst, ok


def l2_rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def mixed_err(got, ref, ref32):
    """A bf16-operand instance against its plain version under the mixed
    plan: (max |got - ref|, whether every output is within MIXED_REL
    L2-relative of ref and within MIXED_GAP of the plain f32 version's
    distance from ref, so that a kernel that ran f32 fails; an output the
    plan leaves f32, the plain versions' bit for bit, MIXED_REL alone: K3.b's
    xn, LN1 of f32 inputs). Prints every output's distances."""
    import torch
    if isinstance(got, torch.Tensor):
        got, ref, ref32 = (got,), (ref,), (ref32,)
    worst, ok, report = 0.0, True, []
    for i, (g, r, r32) in enumerate(zip(got, ref, ref32)):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise AssertionError(f"bad kernel output: shape {tuple(g.shape)} vs {tuple(r.shape)}")
        d, gap, f32_only = l2_rel(g, r), l2_rel(r32, r), torch.equal(r32, r)
        ok = ok and d <= MIXED_REL and (d <= MIXED_GAP * gap or f32_only)
        worst = max(worst, float((g - r).abs().max()))
        report.append(f"#{i} {tuple(g.shape)}: L2 {d:.3e}, " + (
            "the plan leaves it f32" if f32_only else
            f"mixed-vs-f32 {gap:.3e} ({d / gap:.4f} of it)"))
    print("  per output: " + "; ".join(report), flush=True)
    return worst, ok


def bf16_err(got, ref, ref32, ulps_max=BF16_ULPS, f32_rel=0.0):
    """A `_bf16io` instance against its plain bf16 version: (max |got -
    ref|, whether every output is within BF16_GAP of the plain bf16-vs-f32
    distance (L2) and, where it is bf16, `ulps_max` bf16 ulps of max |ref|).
    An output whose plain bf16 and f32 versions agree within `f32_rel` (the
    same f32 arithmetic on the same values: a bf16-training kernel's
    dtokpe and LN sums, `bf16t_err`) is held within `f32_rel` L2 of the
    plain bf16 one instead. Prints every output's distances."""
    import torch
    if isinstance(got, torch.Tensor):
        got, ref, ref32 = (got,), (ref,), (ref32,)
    worst, ok, report = 0.0, True, []
    for i, (g, r, r32) in enumerate(zip(got, ref, ref32)):
        if g.shape != r.shape or g.dtype != r.dtype or not torch.isfinite(g).all():
            raise AssertionError(f"bad kernel output: {g.dtype} {tuple(g.shape)} vs {r.dtype} "
                                 f"{tuple(r.shape)}")
        d, gap = l2_rel(g, r), l2_rel(r32, r)
        err = float((g.float() - r.float()).abs().max())
        worst = max(worst, err)
        if gap <= f32_rel:
            ok = ok and d <= f32_rel
            report.append(f"#{i} {tuple(g.shape)} {str(g.dtype)[6:]}: L2 {d:.3e} (f32 "
                          f"arithmetic in both: limit {f32_rel:g})")
            continue
        ulps = err / 2.0 ** (math.floor(math.log2(float(r.float().abs().max()))) - 7)
        ok = ok and d <= BF16_GAP * gap and (ulps <= ulps_max or g.dtype != torch.bfloat16)
        report.append(f"#{i} {tuple(g.shape)} {str(g.dtype)[6:]}: L2 {d:.3e}, bf16-vs-f32 "
                      f"{gap:.3e} ({d / gap:.4f} of it), max |diff| {ulps:.2f} bf16 ulps of "
                      f"max |plain|")
    print("  per output: " + "; ".join(report), flush=True)
    return worst, ok


def f64_err(got, ref, ref32, exact) -> bool:
    """A bf16-IO output whose plain version is no yardstick at BF16_GAP
    (`ang_bf16_width_checks`): whether it lies no further from `exact`
    (its function in float64, rounded to bf16 where the plain version
    rounds) than the plain version does, plus BF16_GAP of the plain
    bf16-vs-f32 distance, and within BF16_ULPS bf16 ulps of max |plain| of
    the plain version. Prints the distances and the share of the plain
    version's."""
    import torch
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"bad kernel output: {got.dtype} {tuple(got.shape)}")
    gap, d, d_ref = l2_rel(ref32, ref), l2_rel(got, exact), l2_rel(ref, exact)
    err = float((got.float() - ref.float()).abs().max())
    ulps = err / 2.0 ** (math.floor(math.log2(float(ref.float().abs().max()))) - 7)
    print(f"  out {tuple(got.shape)}: from float64 at the plain version's rounding points "
          f"{d / gap:.4f} of the bf16-vs-f32 distance, the plain version {d_ref / gap:.4f} "
          f"(limit it + {BF16_GAP}); from the plain version {l2_rel(got, ref) / gap:.4f}; max "
          f"|diff| {ulps:.2f} bf16 ulps of max |plain|", flush=True)
    return d <= d_ref + BF16_GAP * gap and ulps <= BF16_ULPS


def bf16t_err(got, ref, ref32):
    """A bf16-training kernel against its plain bf16 version: `bf16_err`
    with BF16T_ULPS and BF16T_F32_REL."""
    return bf16_err(got, ref, ref32, BF16T_ULPS, BF16T_F32_REL)


def calm_relu(dout, hid_k, hid_p, what: str):
    """dout with a zero cotangent for the tokens where a ReLU of the FFN is
    on in one version and off in the other (its input within f32 rounding
    of 0). dpre = (hid > 0) dhid jumps there, by design and not by the
    kernel's arithmetic; with dout zero on those tokens their dhid is zero
    and the jump no longer enters the comparison. They must stay rare."""
    flips = ((hid_k > 0) != (hid_p > 0)).reshape(-1, hid_k.shape[-1]).any(-1)
    n = int(flips.sum())
    print(f"  {what}: {n} of {flips.numel()} tokens with a ReLU on in one version and off "
          f"in the other (limit 1e-4 of them), given a zero cotangent", flush=True)
    if n > 1e-4 * flips.numel():
        raise AssertionError(f"{what}: {n} ReLU flips")
    dout = dout.clone()
    dout.reshape(-1, dout.shape[-1])[flips] = 0.0
    return dout


def valid_window_pairs(h: int, w: int, r: int) -> int:
    """(query, key) pairs of a (2r+1)^2 window inside an h x w image."""
    cy = sum(min(y + r, h - 1) - max(y - r, 0) + 1 for y in range(h))
    cx = sum(min(x + r, w - 1) - max(x - r, 0) + 1 for x in range(w))
    return cy * cx


class Recorder:
    """Checks a kernel against its plain version, times both and records
    the `kernels` JSON row with the card's bound."""

    def __init__(self, card: str, launches: dict, per: float, unit: str):
        self.flops_peak, self.bw_peak, self.tf32_peak, self.bf16_peak = peaks(card)
        self.launches, self.per, self.unit = launches, per, unit
        self.rows = []

    def bound(self, flops, nbytes, peak=None):
        t_ops = flops / (peak or self.flops_peak) * 1e3
        t_mem = nbytes / self.bw_peak * 1e3
        return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")

    def record(self, name, src, replaces, got, ref, fn_k, fn_p, flops, io, lib_fn=None,
               rel=None, shape=None, slow_reps=10, device_time=False, tf32_products=0,
               bf16_products=False, fp32_flops=0, ref32=None, bf16_ref32=None,
               bf16t_ref32=None, timer=None, site_flops=None):
        """With `shape` the check is one more shape of a kernel that has its
        row already: compared, timed and printed, not added to the rows.
        `slow_reps`: launches timed of the plain and library versions.
        `device_time`: time all three by `device_ms` instead of CUDA events
        around one call. `tf32_products`: the kernel runs its `flops` as
        that many TF32 tensor-core products each (3xTF32): the bound is then
        the tensor cores' (the least time for the same f32 result), and the
        FP32 pipes' is printed beside it. `bf16_products`: the kernel's
        products take bf16-valued operands (a `mixed` instance, one TF32 pass
        each, or its attention on the FP32 pipes): the bound is then all its
        operations, `fp32_flops` too, at the tensor cores' bf16 rate, the
        least time for the same products. `fp32_flops`: more operations the
        kernel runs on the FP32 pipes beside those products (K1's attention),
        whose time at their peak adds to the tensor cores'. `ref32`: the f32
        plain version's outputs, for a bf16-operand instance held by
        `mixed_err` (`ref` is then the plain version under the mixed plan).
        `bf16_ref32`: the plain f32 version's outputs, for a `_bf16io`
        instance held by `bf16_err` (`ref` the plain bf16 version's);
        `bf16t_ref32` likewise for a bf16-training instance, `bf16t_err`.
        `timer(fn, reps)`: times all three in place of `device_time`'s or
        the CUDA events around one call. `site_flops`: a `_sites` instance's
        operations as (flops, rounds) pairs, one a product site: the bound
        then takes those of a rounding site at the bf16 rate and the others
        as 3xTF32 (3 TF32 products each), the least time for the same
        products."""
        if bf16t_ref32 is not None:
            err, ok = bf16t_err(got, ref, bf16t_ref32)
        elif bf16_ref32 is not None:
            err, ok = bf16_err(got, ref, bf16_ref32)
        else:
            err, ok = max_err(got, ref, rel) if ref32 is None else mixed_err(got, ref, ref32)
        warm = 2 if slow_reps >= 10 else 1
        if timer is not None:
            ms_k, ms_p = timer(fn_k, 20), timer(fn_p, slow_reps)
            ms_l = timer(lib_fn, slow_reps) if lib_fn is not None else None
        elif device_time:
            from lft_torch.profile_scene import device_ms
            ms_k, ms_p = device_ms(fn_k), device_ms(fn_p, slow_reps)
            ms_l = device_ms(lib_fn, slow_reps) if lib_fn is not None else None
        else:
            ms_k, ms_p = timed(fn_k), timed(fn_p, slow_reps, warm)
            ms_l = timed(lib_fn, slow_reps, warm) if lib_fn is not None else None
        b_ms, b_by = self.bound(flops + fp32_flops, io)
        fp32_note = ""
        if site_flops is not None:
            fp32_note = f", FP32-pipe bound {b_ms:.4f} ms ({b_by})"
            t_ops = sum(f_ / (self.bf16_peak if r_ else self.tf32_peak / 3)
                        for f_, r_ in site_flops) * 1e3
            b_ms, b_by = max((t_ops, "operations"), self.bound(0, io))
        elif tf32_products or bf16_products:
            fp32_note = f", FP32-pipe bound {b_ms:.4f} ms ({b_by})"
            if bf16_products:
                b_ms, b_by = self.bound(flops + fp32_flops, io, self.bf16_peak)
            else:
                b_ms, b_by = self.bound(tf32_products * flops + fp32_flops * self.tf32_peak
                                        / self.flops_peak, io, self.tf32_peak)
        n = self.launches[name]
        if shape is None:
            self.rows.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                                  launches=n, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=ms_l))
        limit = (f"per output L2-relative {MIXED_REL:g} and {MIXED_GAP:g} of mixed-vs-f32"
                 if ref32 is not None else
                 f"per output {BF16_GAP:g} of bf16-vs-f32 and {BF16_ULPS:g} bf16 ulp"
                 if bf16_ref32 is not None else
                 f"per output {BF16_GAP:g} of bf16-vs-f32 and {BF16T_ULPS:g} bf16 ulps"
                 if bf16t_ref32 is not None else
                 f"{KERNEL_ATOL:g} x max(1, max|ref|)" if rel is None else f"{rel:g} x max|ref|")
        print(f"kernel {name}{'' if shape is None else f' at {list(shape)}'}: "
              f"max_abs_err {err:.3e} (limit {limit}) "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}){fp32_note}, library {'-' if ms_l is None else f'{ms_l:.4f} ms'}, "
              f"launches {n} ({n / self.per:g}/{self.unit})"
              f"{' [device time]' if device_time and timer is None else ''}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(max |diff| {err:.3e})")
        return ms_k, ms_p, ms_l


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def k3a_out_bytes(T: int, D: int) -> int:
    """The bytes K3.a's f32-output instances write: dx2, dattn, y, dy, xn2
    (D wide) and hid, dpre (2D wide), 9 D floats a token, and the LN2
    partial sums, two D-wide rows a 128-row tile."""
    from lft_torch.kernels.spa_block import ffn_out_bwd_tiles
    return 9 * T * D * 4 + ffn_out_bwd_tiles(T) * 2 * D * 4


def f64_check(name: str, got, ref, exact, repeats: bool) -> None:
    """A kernel (its products 3xTF32 on the tensor cores, or on the FP32
    pipes): its max error against float64 must be at most twice the f32
    plain version's (TF32 off), and a second call must equal the first bit
    for bit."""
    e_k, e_f32 = (float((t.double() - exact).abs().max()) for t in (got, ref))
    print(f"  {name}: max |kernel - float64| {e_k:.3e}, max |f32 plain (TF32 off) - float64| "
          f"{e_f32:.3e} (limit 2x: {e_k / max(e_f32, 1e-30):.3f}x); repeated bitwise: {repeats}",
          flush=True)
    if not e_k <= 2 * e_f32:
        raise AssertionError(f"{name}: error against float64 {e_k:.3e} is more than twice the "
                             f"f32 plain version's {e_f32:.3e}")
    if not repeats:
        raise AssertionError(f"{name} does not repeat bitwise")


def k7_f64_checks(q, k, v, dout, ref, got, ref_b, got_b, where: str = "") -> None:
    """K7's outputs against float64: the forward's (`ang_attn`'s out, or
    `ang_attn_res`'s out, m, l) and, with dout, the backward's (dq, dk, dv,
    run from the kernel forward's own (m, l); the float64 backward from the
    float64 forward's, the f32 plain one from the f32 plain forward's). Each
    at most twice the f32 plain version's error, and a second call equal to
    the first bit for bit."""
    import torch
    from lft_torch.kernels import ang_attn_mxu as am
    H = 8
    x64 = [t.double() for t in (q, k, v)]
    e_fwd = am.ang_attention_blockdiag_plain(*x64, H)
    if dout is None:
        again = am.ang_attn_fwd(q, k, v, H)
        f64_check(f"ang_attn{where} out", got, ref[0], e_fwd[0], torch.equal(got, again))
        return
    again = am.ang_attn_fwd(q, k, v, H, True)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g_, r_, e_ in zip(("out", "m", "l"), got, ref, e_fwd):
        f64_check(f"ang_attn_res{where} {name}", g_, r_, e_, repeats)
    e_bwd = am.ang_attention_blockdiag_bwd_plain(*x64, *e_fwd[1:], dout.double(), H)
    again = am.ang_attn_bwd(q, k, v, *got[1:], dout, H)
    repeats = all(torch.equal(a, b) for a, b in zip(got_b, again))
    for name, g_, r_, e_ in zip(("dq", "dk", "dv"), got_b, ref_b, e_bwd):
        f64_check(f"ang_attn_bwd{where} {name} (from its own m, l)", g_, r_, e_, repeats)


def k8_f64_checks(q, k, v, dout, ref, got, ref_b, got_b, where: str = "") -> None:
    """K8's outputs against float64, as `k7_f64_checks`: the forward's
    (`ang_attn_sweep`'s out, or `ang_attn_sweep_res`'s out, m, l) and, with
    dout, the backward's (dq, dk, dv, run from the kernel forward's own (out,
    m, l); the float64 backward from the float64 forward's, the f32 plain one
    from the f32 plain forward's). The float64 versions go 1024 pixels at a
    time. Each at most twice the f32 plain version's error, and a second call
    equal to the first bit for bit."""
    import torch
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.kernels import ang_attn_vjp as av
    H, n = 8, 1024
    cat = lambda parts: tuple(torch.cat(p) for p in zip(*parts))
    x64 = [t.double() for t in (q, k, v)]
    e_fwd = cat([am.ang_attention_blockdiag_plain(*(t[i:i + n] for t in x64), H)
                 for i in range(0, q.shape[0], n)])
    if dout is None:
        again = av.ang_attn_sweep_fwd(q, k, v, H)
        f64_check(f"ang_attn_sweep{where} out", got, ref[0], e_fwd[0], torch.equal(got, again))
        return
    again = av.ang_attn_sweep_fwd(q, k, v, H, True)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g_, r_, e_ in zip(("out", "m", "l"), got, ref, e_fwd):
        f64_check(f"ang_attn_sweep_res{where} {name}", g_, r_, e_, repeats)
    x64.append(dout.double())
    e_bwd = cat([av.ang_attention_sweep_bwd_plain(*(t[i:i + n] for t in x64[:3]),
                                                  *(t[i:i + n] for t in e_fwd), x64[3][i:i + n],
                                                  H) for i in range(0, q.shape[0], n)])
    again = av.ang_attn_sweep_bwd(q, k, v, *got, dout, H)
    repeats = all(torch.equal(a, b) for a, b in zip(got_b, again))
    for name, g_, r_, e_ in zip(("dq", "dk", "dv"), got_b, ref_b, e_bwd):
        f64_check(f"ang_attn_sweep_bwd{where} {name} (from its own out, m, l)", g_, r_, e_,
                  repeats)


def kernel_checks(params, card: str, launches: dict, n_scenes: int, seed: int) -> list:
    """Each SR kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask, windowed_attention
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    N = 16 * h * w              # pixels of one chunk of 16 patches
    V = 16 * A2                 # views of one chunk
    T = V * h * w
    rec = Recorder(card, launches, n_scenes, "scene")
    record = rec.record

    # K1 at [16384, 25, 64] with the checkpoint's block-0 weights
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    x = torch.randn(N, A2, C, device=dev, generator=g)
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    got = ab.ang_block(x, pe, wa, H)
    ref = ab.ang_block_plain(x, pe, wa, H)
    io = nbytes(x, pe, got, *wa.values())
    record("ang_block", "lft_torch/csrc/ang_block.cu", "lft_tpu/kernels/ang_block.py:188",
           got, ref, lambda: ab.ang_block(x, pe, wa, H),
           lambda: ab.ang_block_plain(x, pe, wa, H), 2 * N * A2 * 8 * C * C, io,
           tf32_products=3, fp32_flops=4 * N * A2 * A2 * C)
    f64_check("ang_block out", got, ref,
              ab.ang_block_plain(x.double(), pe.double(), {k: v.double() for k, v in wa.items()},
                                 H),
              torch.equal(got, ab.ang_block(x, pe, wa, H)))
    del got, ref

    # K2's five steps at [400, 32, 32, 64], each fed its plain predecessor's output
    ws = sb.spa_weights(params, "altblock.0.spa_trans.")
    xs = torch.randn(V, h, w, C, device=dev, generator=g)
    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev)
    pe_tok = unfold3x3_linear(spa_pe[None], ws["mlp"])[0].contiguous()
    wbytes = lambda *k: sum(nbytes(ws[n]) for n in k)
    rep = "lft_tpu/kernels/spa_block.py:248"
    src = "lft_torch/csrc/spa_block.cu"

    tok, xn = sb.tokenize_ln_plain(xs, pe_tok, ws)
    got = sb.tokenize_ln(xs, pe_tok, ws)
    ms_k, _, _ = record("spa_tokenize_ln", src, rep, got, (tok, xn),
                        lambda: sb.tokenize_ln(xs, pe_tok, ws),
                        lambda: sb.tokenize_ln_plain(xs, pe_tok, ws),
                        2 * C * D * V * valid_window_pairs(h, w, 1),
                        nbytes(xs, pe_tok, tok, xn) + wbytes("wu", "ln"), tf32_products=3)
    again = sb.tokenize_ln(xs, pe_tok, ws)
    f64_check("spa_tokenize_ln tok", got[0], tok,
              unfold3x3_linear(xs.double(), ws["mlp"].double()),
              all(torch.equal(a, b) for a, b in zip(got, again)))
    del got, again
    xs_nchw, w_nchw = xs.permute(0, 3, 1, 2), ws["mlp"].reshape(D, C, 3, 3)
    ms_conv = timed(lambda: F.conv2d(xs_nchw, w_nchw, padding=1))
    print(f"  spa_tokenize_ln conv part only (cuDNN F.conv2d on the same memory, TF32 off; no PE, "
          f"no LN1) at {[V, h, w, C]}: {ms_conv:.4f} ms, the kernel {ms_k:.4f} ms", flush=True)

    ws64 = {k_: v_.double() for k_, v_ in ws.items()}
    q, k, v = sb.qkv_plain(xn, tok, ws)
    got = sb.qkv(xn, tok, ws)
    ms_k, _, _ = record("spa_qkv", src, rep, got, (q, k, v),
                        lambda: sb.qkv(xn, tok, ws), lambda: sb.qkv_plain(xn, tok, ws),
                        2 * T * D * 3 * D, nbytes(xn, tok, q, k, v) + wbytes("wqk", "wv"),
                        tf32_products=3)
    again = sb.qkv(xn, tok, ws)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g_, r_, e_ in zip("qkv", got, (q, k, v),
                                sb.qkv_plain(xn.double(), tok.double(), ws64)):
        f64_check(f"spa_qkv {name}", g_, r_, e_, repeats)
    del got, again
    ms_lib = timed(lambda: (xn @ ws["wqk"], tok @ ws["wv"]))
    print(f"  spa_qkv: its two cuBLAS f32 products (xn @ wqk, tok @ wv) on the same memory "
          f"{ms_lib:.4f} ms, the kernel {ms_k:.4f} ms", flush=True)

    attn = windowed_attention(q, k, v, H, K)
    pairs = V * valid_window_pairs(h, w, K // 2)
    mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
    heads = lambda t: t.reshape(V, h * w, H, D // H).transpose(1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)
    got = sb.window_attn(q, k, v, H, K)
    record("spa_window_attn", src, rep, got, attn,
           lambda: sb.window_attn(q, k, v, H, K),
           lambda: windowed_attention(q, k, v, H, K),
           4 * D * pairs, nbytes(q, k, v, attn),
           lib_fn=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    f64_check("spa_window_attn attn", got, attn,
              windowed_attention(q.double(), k.double(), v.double(), H, K),
              torch.equal(got, sb.window_attn(q, k, v, H, K)))
    del got, qh, kh, vh

    x2, xn2 = sb.outproj_ln_plain(attn, tok, ws)
    got = sb.outproj_ln(attn, tok, ws)
    ms_k, _, _ = record("spa_outproj_ln", src, rep, got, (x2, xn2),
                        lambda: sb.outproj_ln(attn, tok, ws),
                        lambda: sb.outproj_ln_plain(attn, tok, ws),
                        2 * T * D * D, nbytes(attn, tok, x2, xn2) + wbytes("wo", "ln"),
                        tf32_products=3)
    again = sb.outproj_ln(attn, tok, ws)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g_, r_, e_ in zip(("x2", "xn2"), got, (x2, xn2),
                                sb.outproj_ln_plain(attn.double(), tok.double(), ws64)):
        f64_check(f"spa_outproj_ln {name}", g_, r_, e_, repeats)
    del got, again
    ms_lib = timed(lambda: torch.addmm(tok.reshape(-1, D), attn.reshape(-1, D), ws["wo"]))
    print(f"  spa_outproj_ln: its cuBLAS f32 product with the residual (addmm(tok, attn, wo), "
          f"no LN2) on the same memory {ms_lib:.4f} ms, the kernel {ms_k:.4f} ms", flush=True)

    out = sb.ffn_out_plain(xn2, x2, ws)
    got = sb.ffn_out(xn2, x2, ws)
    record("spa_ffn_out", src, rep, got, out,
           lambda: sb.ffn_out(xn2, x2, ws), lambda: sb.ffn_out_plain(xn2, x2, ws),
           2 * T * (4 * D * D + D * C), nbytes(xn2, x2, out) + wbytes("w1", "w2", "wlin"),
           tf32_products=3)
    f64_check("spa_ffn_out out", got, out,
              sb.ffn_out_plain(xn2.double(), x2.double(), {k: v.double() for k, v in ws.items()}),
              torch.equal(got, sb.ffn_out(xn2, x2, ws)))
    del got

    # the whole K2 block, kernels chained against plain chained
    got = sb.spa_block(xs, pe_tok, ws, H, K)
    err, ok = max_err(got, out)
    ms_k = timed(lambda: sb.spa_block(xs, pe_tok, ws, H, K))
    ms_p = timed(lambda: sb.spa_block_plain(xs, pe_tok, ws, H, K))
    print(f"block spa_trans (5 kernels chained): max_abs_err {err:.3e} "
          f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"chained K2 disagrees with its plain version ({err:.3e})")
    return rec.rows


PEROP_TRAIN = ("ang_attn_res", "ang_attn_bwd", "spa_attn_hp_res", "spa_attn_hp_bwd")
VARIANT_KNOBS = ("LFT_ANG_VARIANT", "LFT_SPA_VARIANT")


@contextlib.contextmanager
def variants(ang=None, spa=None):
    """The two environment knobs of the per-op dispatchers set for the block
    (None: unset), and put back after it."""
    before = {k: os.environ.pop(k, None) for k in VARIANT_KNOBS}
    os.environ.update({k: v for k, v in zip(VARIANT_KNOBS, (ang, spa)) if v is not None})
    try:
        yield
    finally:
        for k, v in before.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def plain_attention_impl(h: int, w: int) -> str:
    """The plain torch window attention that takes an h x w view."""
    from lft_torch.ops.attention import _pick_tile
    return "tiled" if _pick_tile(h, w) is not None else "dense"


def train_phase(params, seed: int, unfused: bool = False, *, what=None, ang_res: int = 5,
                patch: int = 32, batch: int = 4, train_fused=None, expect=PEROP_TRAIN,
                steps: int = TRAIN_STEPS, other_plain=None):
    """The 4x recipe's train step through the kernels against the plain
    path, its bitwise repeat, and a few more steps: the fused blocks against
    their plain versions, or with `unfused` the per-op branch
    (`--train_fused false`, or `train_fused` as given where the gates send
    the geometry there) against the same branch with the plain torch
    attention; `expect` names the kernels that branch must launch 4 times a
    step, and no other; the fused steps must launch 4 times a step K1 with
    residuals and the K4 form of the view count (`ang_block_bwd`, or
    `ang_block_bwd128` past 64 views), every other training kernel, and no
    per-op kernel. `other_plain`: keywords of a second plain forward; where
    the two plain paths differ by more than half a gradient's bound (small
    batches: sums that nearly cancel), the gradient is held to twice their
    difference instead. Returns the launch counts of the kernel-path steps,
    their number and the median ms of a kernel-path step."""
    import dataclasses
    import functools

    import torch
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import (LAUNCHES, MIXED, PEROP, SWEEPS, TAIL, TRAINING,
                                   reset_launches)
    from lft_torch.models.lft import forward
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    args = Args(angRes=ang_res, scale_factor=4, channels=64, batch_size=batch, lr=2e-4,
                n_steps=15, gamma=0.5, epoch=50,
                train_fused=train_fused or ("false" if unfused else "true"))
    model = get_model(args)
    plain_kw = (dict(attention_impl=plain_attention_impl(patch, patch)) if unfused
                else dict(plain_blocks=True))
    plain_model = dataclasses.replace(model, apply=functools.partial(forward, **plain_kw))
    what = what or ("per-op train" if unfused else "train")
    gen = torch.Generator(device=dev).manual_seed(seed)
    new_batch = lambda: synth_batch(gen, batch=batch, ang_res=ang_res, patch=patch, scale=4)
    lr, hr = new_batch()
    print(f"train batch: lr {tuple(lr.shape)} hr {tuple(hr.shape)} (synth_batch, seed {seed})",
          flush=True)

    def fresh(m):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        opt = make_optimizer(p, args, steps_per_epoch=1000)
        return p, make_train_step(m, opt, args)

    def grads(p):
        return {k: v.grad.detach().clone() for k, v in p.items()}

    # The gradients are compared under a smooth loss, as the JAX package
    # compares its fused and unfused gradients (tests/test_kernels.py:446-461):
    # the L1 loss's d|r|/dr flips sign where the two paths' outputs straddle
    # the label by f32 noise, and those flips, not the kernels, would set
    # the difference of small gradients.
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()

    # the plain blocks and backwards launch no kernel
    torch.cuda.synchronize()
    reset_launches()
    pp, step_p = fresh(plain_model)
    loss_p, _, _ = step_p(pp, lr, hr)
    ps, step_ps = fresh(dataclasses.replace(plain_model, loss=smooth))
    step_ps(ps, lr, hr)
    g_p = grads(ps)
    del ps
    g_o = None
    if other_plain is not None:
        # these keywords win over the train step's own (`fused`)
        po, step_po = fresh(dataclasses.replace(
            model, apply=lambda p, x, a_, **kw: forward(p, x, a_, **{**kw, **other_plain}),
            loss=smooth))
        step_po(po, lr, hr)
        g_o = grads(po)
        del po
    torch.cuda.synchronize()
    if any(LAUNCHES.values()):
        raise AssertionError(f"the plain path launched kernels: {dict(LAUNCHES)}")

    # the main path: counts at 0, kernel-path steps, counts read right after
    reset_launches()
    pa, step_a = fresh(model)
    loss_a, psnr_a, ssim_a = step_a(pa, lr, hr)
    g_r = grads(pa)
    pb, step_b = fresh(model)
    loss_b, _, _ = step_b(pb, lr, hr)
    same = (float(loss_b) == float(loss_a)
            and all(torch.equal(g_r[k], pb[k].grad) for k in g_r)
            and all(torch.equal(pa[k], pb[k]) for k in pa))
    del pb, g_r
    pk, step_k = fresh(dataclasses.replace(model, loss=smooth))
    step_k(pk, lr, hr)
    g_a = grads(pk)
    del pk
    times, losses = [], []
    for _ in range(steps):
        lr, hr = new_batch()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        loss, _, _ = step_a(pa, lr, hr)
        ev1.record()
        ev1.synchronize()
        times.append(ev0.elapsed_time(ev1))
        losses.append(float(loss))
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    n_steps = 3 + steps

    la, lp = float(loss_a), float(loss_p)
    print(f"{what} step 1: loss kernels {la:.8f} plain {lp:.8f} (|d| {abs(la - lp):.3e}, "
          f"limit 1e-5 |loss|); train PSNR {float(psnr_a):.4f} dB SSIM {float(ssim_a):.4f}",
          flush=True)
    if not abs(la - lp) <= 1e-5 * abs(lp):
        raise AssertionError("kernel-path loss disagrees with the plain path")
    worst, floored = (0.0, ""), []
    for k in g_p:
        d = float((g_a[k] - g_p[k]).abs().max())
        lim = 5e-4 * float(g_p[k].abs().max()) + 2e-9
        if g_o is not None:
            floor = 2.0 * float((g_o[k] - g_p[k]).abs().max())
            if floor > lim:
                floored.append(k)
                lim = floor
        if not d <= lim:
            raise AssertionError(f"grad of {k}: max |kernel - plain| {d:.3e} > {lim:.3e}")
        worst = max(worst, (d / lim, k))
    print(f"{what} step 1 (smooth loss): every grad within 5e-4 max|grad| + 2e-9 of the "
          f"plain path (worst {worst[1]} at {worst[0]:.3f} of its limit)"
          + ("" if g_o is None else f"; {len(floored)} of {len(g_p)} held to twice the two "
             f"plain paths' own difference instead: {floored}"), flush=True)
    if not same:
        raise AssertionError("a repeated kernel-path step is not bitwise equal")
    print(f"{what} step repeated from the same state: loss, grads and params bitwise equal",
          flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss in the further steps: {losses}")
    times.sort()
    ms_k = times[len(times) // 2]

    p_times = []
    for _ in range(3):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        step_p(pp, lr, hr)
        ev1.record()
        ev1.synchronize()
        p_times.append(ev0.elapsed_time(ev1))
    p_times.sort()
    print(f"{what} steps: losses {losses}; median {ms_k:.3f} ms/step through the kernels "
          f"(all {[round(t, 3) for t in times]}), {p_times[1]:.3f} ms/step through the plain "
          f"path (all {[round(t, 3) for t in p_times]}); batch {batch} of {patch}x{patch}-view "
          f"patches, {ang_res}x{ang_res} views, 4x, C=64", flush=True)
    print(f"launches in the {what} run ({n_steps} kernel-path steps): {counts}", flush=True)
    if unfused:
        # one launch of each per-op training kernel per AltFilter block and step
        wrong = {k: counts[k] for k in LAUNCHES
                 if counts[k] != (4 * n_steps if k in expect else 0)}
        if wrong:
            raise AssertionError(f"{what} steps: expected 4 launches a step of each of "
                                 f"{expect} and no other kernel, got {wrong}")
    else:
        wide = ang_res * ang_res > 64
        k4, other_k4 = (("ang_block_bwd128", "ang_block_bwd") if wide
                        else ("ang_block_bwd", "ang_block_bwd128"))
        missing = [k for k in TRAINING + (k4,) if counts[k] == 0 and k != other_k4]
        if missing:
            raise AssertionError(f"training kernels not launched on the training path: {missing}")
        extra = [k for k in PEROP + SWEEPS + TAIL + MIXED + (other_k4,) if counts[k] and k != k4]
        if extra:
            raise AssertionError(f"kernels of another path launched by the fused train steps: "
                                 f"{extra}")
        if counts["ang_block_res"] != 4 * n_steps or counts[k4] != 4 * n_steps:
            raise AssertionError(f"{what} steps: expected 4 ang_block_res and 4 {k4} launches a "
                                 f"step, got {counts['ang_block_res']} and {counts[k4]} in "
                                 f"{n_steps} steps")
        # a block's backward: K4 with 6 wgrad + 1 colsum, K3 with 8 + 3
        if counts["wgrad"] != 56 * n_steps or counts["colsum"] != 16 * n_steps:
            raise AssertionError(f"{what} steps: expected 56 wgrad and 16 colsum launches a "
                                 f"step, got {counts['wgrad']} and {counts['colsum']} in "
                                 f"{n_steps} steps")
    return counts, n_steps, ms_k


def train_kernel_checks(params, card: str, launches: dict, n_steps: int, seed: int) -> list:
    """Each training kernel against its plain version at the train step's
    shapes: batch 4 of 32x32-view patches, K1/K4 [4096, 25, 64], K2/K3
    [100, 32, 32, 64] (block 0's weights of the checkpoint)."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    N = 4 * h * w               # pixels of the batch
    V = 4 * A2                  # views of the batch
    T = V * h * w               # tokens, = N * A2
    rec = Recorder(card, launches, n_steps, "train step")
    rel = TRAIN_REL
    src_a, src_s = "lft_torch/csrc/ang_block.cu", "lft_torch/csrc/spa_block_bwd.cu"
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    with_sum = lambda ops: (*ops[:-1], ops[-1].sum(0))   # partial LN sums -> totals

    # K1 with residuals, K4
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    wa_b = sum(nbytes(t) for t in wa.values())
    x = rand(N, A2, C)
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    ref = ab.ang_block_plain(x, pe, wa, H, with_res=True)
    got = ab.ang_block(x, pe, wa, H, with_res=True)
    rec.record("ang_block_res", src_a, "lft_tpu/kernels/ang_block.py:233", got, ref,
               lambda: ab.ang_block(x, pe, wa, H, with_res=True),
               lambda: ab.ang_block_plain(x, pe, wa, H, with_res=True),
               2 * N * A2 * 8 * C * C, nbytes(x, pe, *ref) + wa_b, rel=rel, tf32_products=3,
               fp32_flops=4 * N * A2 * A2 * C)
    again = ab.ang_block(x, pe, wa, H, with_res=True)
    f64_check("ang_block_res out", got[0], ref[0],
              ab.ang_block_plain(x.double(), pe.double(), {k: v.double() for k, v in wa.items()},
                                 H),
              all(torch.equal(a, b) for a, b in zip(got, again)))
    del got, again, ref
    bwd_in = k4_check(rec, "ang_block_bwd", x, pe, wa, rand(N, A2, C), rel)
    got = ab.ang_block_bwd(*bwd_in)
    ref = ab.ang_block_bwd_plain(*bwd_in)
    err, ok = max_err(got, ref, rel)
    ms_k = timed(lambda: ab.ang_block_bwd(*bwd_in))
    ms_p = timed(lambda: ab.ang_block_bwd_plain(*bwd_in))
    print(f"block ang_trans backward (K4 + 6 wgrad + colsum): max_abs_err {err:.3e} "
          f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"the AngTrans backward disagrees with its plain version ({err:.3e})")

    # K2's window step with stats, K3's five steps
    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    wbytes = lambda *k: sum(nbytes(ws[n]) for n in k)
    xs = rand(V, h, w, C)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                              ws["mlp"])[0].contiguous()
    _, tok, m, l, attn = sb.spa_block_plain(xs, pe_tok, ws, H, K, with_res=True)
    xn, q, k, v = sb.ln_qkv_plain(tok, pe_tok, ws)
    pairs = V * valid_window_pairs(h, w, K // 2)
    ref = sb.window_attn_plain(q, k, v, H, K)
    mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
    heads = lambda t: t.reshape(V, h * w, H, D // H).transpose(1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)
    got = sb.window_attn(q, k, v, H, K, True)
    rec.record("spa_window_attn_res", "lft_torch/csrc/spa_block.cu",
               "lft_tpu/kernels/spa_block.py:339", got, ref,
               lambda: sb.window_attn(q, k, v, H, K, True),
               lambda: sb.window_attn_plain(q, k, v, H, K), 4 * D * pairs,
               nbytes(q, k, v, *ref), rel=rel,
               lib_fn=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    del qh, kh, vh
    again = sb.window_attn(q, k, v, H, K, True)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g_, r_, e_ in zip(("attn", "m", "l"), got, ref,
                                sb.window_attn_plain(q.double(), k.double(), v.double(), H, K)):
        f64_check(f"spa_window_attn_res {name}", g_, r_, e_, repeats)
    del got, again
    rep = "lft_tpu/kernels/spa_block.py:602"
    dout = rand(V, h, w, C)
    dout = calm_relu(dout, sb.ffn_out_bwd(attn, tok, dout, ws)[4],
                     sb.ffn_out_bwd_plain(attn, tok, dout, ws)[4], "spa_ffn_out_bwd")
    ref = sb.ffn_out_bwd_plain(attn, tok, dout, ws)
    got = sb.ffn_out_bwd(attn, tok, dout, ws)
    rec.record("spa_ffn_out_bwd", src_s, rep, with_sum(got),
               (*ref[:-1], ref[-1][0]), lambda: sb.ffn_out_bwd(attn, tok, dout, ws),
               lambda: sb.ffn_out_bwd_plain(attn, tok, dout, ws), T * (20 * D * D + 2 * C * D),
               nbytes(attn, tok, dout, *ref[:-1])
               + wbytes("ln", "wo", "w1", "w2", "wlin") * 2, rel=rel, tf32_products=3)
    repeats = all(torch.equal(a, b) for a, b in zip(got, sb.ffn_out_bwd(attn, tok, dout, ws)))
    exact = sb.ffn_out_bwd_plain(attn.double(), tok.double(), dout.double(),
                                 {k_: v_.double() for k_, v_ in ws.items()})
    summed = with_sum(got)
    for i, name in ((0, "dx2"), (1, "dattn"), (2, "y"), (3, "dy"), (6, "xn2"), (7, "dln2 sums")):
        f64_check(f"spa_ffn_out_bwd {name}", summed[i], ref[i].reshape(summed[i].shape),
                  exact[i].reshape(summed[i].shape), repeats)
    del got, summed, exact
    dx2, dattn = ref[0], ref[1]
    # K3.b from K2.1's tok (the kernel's): its (xn, q, k, v) must be K2.1's xn
    # and K2.2's (q, k, v) bit for bit
    tok_k, xn_k = sb.tokenize_ln(xs, pe_tok, ws)
    fwd = (xn_k, *sb.qkv(xn_k, tok_k, ws))
    ref = sb.ln_qkv_plain(tok_k, pe_tok, ws)
    got = sb.ln_qkv(tok_k, pe_tok, ws)
    rec.record("spa_ln_qkv", "lft_torch/csrc/spa_block.cu", rep, got, ref,
               lambda: sb.ln_qkv(tok_k, pe_tok, ws), lambda: sb.ln_qkv_plain(tok_k, pe_tok, ws),
               6 * T * D * D, nbytes(tok_k, pe_tok, *ref) + wbytes("ln", "wqk", "wv"), rel=rel,
               tf32_products=3)
    same = all(torch.equal(a, b) for a, b in zip(got, fwd))
    repeats = all(torch.equal(a, b) for a, b in zip(got, sb.ln_qkv(tok_k, pe_tok, ws)))
    print(f"  spa_ln_qkv: (xn, q, k, v) bitwise equal to K2.1's xn and K2.2's (q, k, v) from "
          f"K2.1's tok: {same}; repeated bitwise: {repeats}", flush=True)
    if not (same and repeats):
        raise AssertionError("spa_ln_qkv does not recompute the forward's xn, q, k, v bit for "
                             "bit, or does not repeat bitwise")
    del tok_k, xn_k, fwd, ref
    # K3.c on K3.b's q, k, v with K2.3 res's (m, l) on them (a backward is
    # tested with its own forward's residuals): K5's backward under K3's name
    q_k, k_k, v_k = got[1:]
    del got
    attn_k, m_k, l_k = sb.window_attn(q_k, k_k, v_k, H, K, True)
    args_c = (q_k, k_k, v_k, attn_k, dattn, m_k, l_k, H, K)
    ref = sb.window_attn_bwd_plain(*args_c)
    got = sb.window_attn_bwd(*args_c)
    rec.record("spa_window_attn_bwd", "lft_torch/csrc/spa_attn_hp.cu", rep, got, ref,
               lambda: sb.window_attn_bwd(*args_c), lambda: sb.window_attn_bwd_plain(*args_c),
               10 * D * pairs, nbytes(q_k, k_k, v_k, dattn, m_k, l_k, *ref), rel=rel)
    same = all(torch.equal(a, b) for a, b in
               zip(got, hp.spa_attn_hp_bwd(q_k, k_k, v_k, m_k, l_k, dattn, H, K)))
    repeats = all(torch.equal(a, b) for a, b in zip(got, sb.window_attn_bwd(*args_c)))
    print(f"  spa_window_attn_bwd: bitwise equal to spa_attn_hp_bwd on the same inputs: {same}",
          flush=True)
    if not same:
        raise AssertionError("spa_window_attn_bwd is not K5's backward bit for bit")
    # against float64, each version from its own forward's (m, l)
    a_p, m_p, l_p = sb.window_attn_plain(q_k, k_k, v_k, H, K)
    plain_f32 = sb.window_attn_bwd_plain(q_k, k_k, v_k, a_p, dattn, m_p, l_p, H, K)
    del a_p, m_p, l_p
    x64 = [t_.double() for t_ in (q_k, k_k, v_k)]
    a64, m64, l64 = sb.window_attn_plain(*x64, H, K)
    exact = sb.window_attn_bwd_plain(*x64, a64, dattn.double(), m64, l64, H, K)
    del x64, a64, m64, l64
    for name, g_, r_, e_ in zip(("dq", "dk", "dv"), got, plain_f32, exact):
        f64_check(f"spa_window_attn_bwd {name}", g_, r_, e_, repeats)
    del got, plain_f32, exact, q_k, k_k, v_k, attn_k, m_k, l_k, args_c
    dq, dk, dv = ref
    args_d = (tok, pe_tok, dq, dk, dv, dx2, ws)
    ref = sb.qkv_ln_bwd_plain(*args_d)
    got = sb.qkv_ln_bwd(*args_d)
    rec.record("spa_qkv_ln_bwd", src_s, rep, with_sum(got),
               (*ref[:-1], ref[-1][0]), lambda: sb.qkv_ln_bwd(*args_d),
               lambda: sb.qkv_ln_bwd_plain(*args_d), 6 * T * D * D,
               nbytes(tok, pe_tok, dq, dk, dv, dx2, *ref[:-1]) + wbytes("ln", "wqk", "wv"),
               rel=rel, tf32_products=3)
    repeats = all(torch.equal(a, b) for a, b in zip(got, sb.qkv_ln_bwd(*args_d)))
    exact = sb.qkv_ln_bwd_plain(*(t.double() for t in args_d[:-1]),
                                {k_: v_.double() for k_, v_ in ws.items()})
    summed = with_sum(got)
    for i, name in ((0, "dtok"), (1, "dtokpe"), (2, "dln1 sums")):
        f64_check(f"spa_qkv_ln_bwd {name}", summed[i], ref[i].reshape(summed[i].shape),
                  exact[i].reshape(summed[i].shape), repeats)
    del got, summed, exact
    dtok = ref[0]
    ref = sb.tokenize_bwd_plain(dtok, ws)
    dtok_nchw, w_t = dtok.permute(0, 3, 1, 2), ws["mlp"].reshape(D, C, 3, 3)
    got = sb.tokenize_bwd(dtok, ws)
    rec.record("spa_tokenize_bwd", src_s, rep, got, ref,
               lambda: sb.tokenize_bwd(dtok, ws), lambda: sb.tokenize_bwd_plain(dtok, ws),
               2 * D * C * V * valid_window_pairs(h, w, 1), nbytes(dtok, ref) + wbytes("wu"),
               lib_fn=lambda: F.conv_transpose2d(dtok_nchw, w_t, padding=1), rel=rel,
               tf32_products=3)
    f64_check("spa_tokenize_bwd dx", got, ref,
              sb.tokenize_bwd_plain(dtok.double(), dict(mlp=ws["mlp"].double())),
              torch.equal(got, sb.tokenize_bwd(dtok, ws)))
    del got
    got = sb.spa_block_bwd(xs, pe_tok, ws, tok, m, l, attn, dout, H, K)
    ref = sb.spa_block_bwd_plain(xs, pe_tok, ws, tok, m, l, attn, dout, H, K)
    err, ok = max_err(got, ref, rel)
    ms_k = timed(lambda: sb.spa_block_bwd(xs, pe_tok, ws, tok, m, l, attn, dout, H, K))
    ms_p = timed(lambda: sb.spa_block_bwd_plain(xs, pe_tok, ws, tok, m, l, attn, dout, H, K))
    print(f"block spa_trans backward (K3's 5 kernels + 8 wgrad + 3 colsum): max_abs_err "
          f"{err:.3e} kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms", flush=True)
    if not ok:
        raise AssertionError(f"the SpaTrans backward disagrees with its plain version ({err:.3e})")

    return rec.rows + reduction_checks(card, launches, n_steps, g)


def k4_check(rec, name: str, x, pe, wa, dout, rel, shape=None):
    """K4 (`ang_block_bwd_ops`) against its plain version at x [N, A2, C]
    with block 0's weights, both from K1 res's residuals (m, l, attn, as in
    a train step): the `kernels` row (or, with `shape`, one more shape of
    it), bound as 3xTF32 products on the tensor cores beside the attention
    on the FP32 pipes. Then every output held to twice the f32 plain
    version's float64 error (the LN sums summed over their rows), each
    version from its own forward's residuals (the softmax (m, l) fits the
    scores of the forward that made it: K1's for the kernel), and a bitwise
    repeat. Returns the backward's inputs, dout zero on the tokens of a ReLU
    flip."""
    import torch
    from lft_torch.kernels import ang_block as ab

    N, A2, C = x.shape
    T, H = N * A2, 8
    w64 = {k: v.double() for k, v in wa.items()}
    res_k = ab.ang_block(x, pe, wa, H, with_res=True)[1:]
    res_p = ab.ang_block_plain(x, pe, wa, H, with_res=True)[1:]
    res_e = ab.ang_block_plain(x.double(), pe.double(), w64, H, with_res=True)[1:]
    hid_k = ab.ang_block_bwd_ops(x, pe, wa, *res_k, dout, H)[8]
    dout = calm_relu(dout, hid_k, ab.ang_block_bwd_ops_plain(x, pe, wa, *res_p, dout, H)[8],
                     f"{name} at A2 = {A2}")
    dout = calm_relu(dout, hid_k, ab.ang_block_bwd_ops_plain(x.double(), pe.double(), w64,
                                                             *res_e, dout.double(), H)[8],
                     f"{name} at A2 = {A2} against float64")
    del hid_k
    bwd_in = (x, pe, wa, *res_k, dout, H)
    ref = ab.ang_block_bwd_ops_plain(*bwd_in)
    got = ab.ang_block_bwd_ops(*bwd_in)
    summed = (*got[:-1], got[-1].sum(0))
    call = ":432" if name == "ang_block_bwd" else ":477"
    rec.record(name, "lft_torch/csrc/ang_block.cu", "lft_tpu/kernels/ang_block.py" + call,
               summed, (*ref[:-1], ref[-1][0]), lambda: ab.ang_block_bwd_ops(*bwd_in),
               lambda: ab.ang_block_bwd_ops_plain(*bwd_in), 28 * T * C * C,
               nbytes(x, pe, *res_k, dout, *ref[:-1]) + 2 * sum(nbytes(t) for t in wa.values()),
               rel=rel, shape=shape, slow_reps=10 if shape is None and A2 <= 64 else 3,
               tf32_products=3, fp32_flops=10 * C * N * A2 * A2)
    repeats = all(torch.equal(a, b) for a, b in zip(got, ab.ang_block_bwd_ops(*bwd_in)))
    own = ab.ang_block_bwd_ops_plain(x, pe, wa, *res_p, dout, H)
    exact = ab.ang_block_bwd_ops_plain(x.double(), pe.double(), w64, *res_e, dout.double(), H)
    for i, out in enumerate(("dx", "xn", "dq", "dk", "dv", "dx2", "xn2", "dpre", "hid",
                             "dln sums")):
        f64_check(f"{name} at A2 = {A2} {out}", summed[i], own[i].reshape(summed[i].shape),
                  exact[i].reshape(summed[i].shape), repeats)
    return bwd_in


def reduction_checks(card: str, launches: dict, n_steps: int, g) -> list:
    """`wgrad` at every product of the fused train step and `colsum` at its
    three shapes, against the plain version and timed in device time
    (`device_ms`) beside one PyTorch call for the same function: `x.t() @ dy`
    (for dwu cuDNN's conv weight grad on the same memory) and `a.sum(0)`.
    `wgrad` runs 3xTF32 on the tensor cores: its max error against float64
    must be at most twice that of the plain f32 product (TF32 off)."""
    import torch
    from lft_torch.compare_wgrad import STEP_PRODUCTS, STEP_SUMS
    from lft_torch.kernels import wgrad as wg

    dev = torch.device("cuda")
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    rec = Recorder(card, launches, n_steps, "train step")
    src, rep = "lft_torch/csrc/wgrad.cu", "lft_tpu/kernels/spa_block.py:570"
    V, h, w = 100, 32, 32
    T = V * h * w
    sum_k = sum_l = 0.0
    for i, (what, K, N, image, per_step) in enumerate(STEP_PRODUCTS):
        x, dy = rand(T, K), rand(T, N)
        got, ref = wg.wgrad(x, dy, image), wg.wgrad_plain(x, dy, image)
        exact = wg.wgrad_plain(x.double(), dy.double(), image)
        e_k, e_f32 = (float((t.double() - exact).abs().max()) for t in (got, ref))
        del exact
        if image is None:
            lib = lambda x=x, dy=dy: x.t() @ dy
            pairs = T
        else:
            xi = x.view(V, h, w, K).permute(0, 3, 1, 2)
            gi = dy.view(V, h, w, N).permute(0, 3, 1, 2)
            lib = lambda xi=xi, gi=gi, K=K, N=N: torch.nn.grad.conv2d_weight(
                xi, (N, K, 3, 3), gi, padding=1)
            pairs = V * valid_window_pairs(h, w, 1)
        ms_k, _, ms_l = rec.record(
            "wgrad", src, rep, got, ref, lambda x=x, dy=dy, im=image: wg.wgrad(x, dy, im),
            lambda x=x, dy=dy, im=image: wg.wgrad_plain(x, dy, im), 2 * pairs * K * N,
            nbytes(x, dy, got), lib_fn=lib, rel=TRAIN_REL,
            shape=None if i == 0 else (T, K, N) + (image or ()), device_time=True,
            tf32_products=3)
        same = torch.equal(got, wg.wgrad(x, dy, image))
        sum_k += per_step * ms_k
        sum_l += per_step * ms_l
        print(f"  {what} [{T}, {K}]ᵀ[{T}, {N}]{'' if image is None else f' taps of {image}'}: "
              f"max |wgrad - float64| {e_k:.3e}, max |f32 product (TF32 off) - float64| "
              f"{e_f32:.3e} (limit 2x: {e_k / max(e_f32, 1e-30):.3f}x); {per_step} a step; "
              f"repeated bitwise: {same}", flush=True)
        if not e_k <= 2 * e_f32:
            raise AssertionError(f"wgrad {what}: error against float64 {e_k:.3e} is more than "
                                 f"twice the f32 product's {e_f32:.3e}")
        if not same:
            raise AssertionError(f"wgrad {what} does not repeat bitwise")
        del x, dy, got, ref
    print(f"wgrad over a fused step's 56 launches: {sum_k:.4f} ms device time, one PyTorch call "
          f"each {sum_l:.4f} ms", flush=True)
    if sum_k > sum_l:
        print("  (the kernels are slower than the library calls in sum)", flush=True)
    for i, (what, R, N, per_step) in enumerate(STEP_SUMS):
        a = rand(R, N)
        ref = wg.colsum_plain(a)
        got = wg.colsum(a)
        rec.record("colsum", src, rep, got, ref, lambda a=a: wg.colsum(a),
                   lambda a=a: wg.colsum_plain(a), a.numel(), nbytes(a, ref),
                   lib_fn=lambda a=a: a.sum(0), rel=TRAIN_REL,
                   shape=None if i == 0 else (R, N), device_time=True)
        print(f"  colsum {what} [{R}, {N}]: {per_step} a step; repeated bitwise: "
              f"{torch.equal(got, wg.colsum(a))}", flush=True)
        if not torch.equal(got, wg.colsum(a)):
            raise AssertionError("colsum does not repeat bitwise")
    return rec.rows


def perop_sr_phase(params, args, scenes, fused_cache, fused_psnr: float):
    """The two scenes through the unfused per-op branch, against the plain
    unfused path and the fused kernel path. Returns the launch counts of
    the per-op run and the first scene's mosaics through the plain unfused
    path and the per-op kernels."""
    import time

    import torch
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.models.lft import forward

    dev = torch.device("cuda")
    n = len(scenes)
    perop = ScenePipelineCache(forward, args, eval_batch=16, fused=False)
    tiled = ScenePipelineCache(forward, args, eval_batch=16, fused=False, attention_impl="tiled")
    torch.cuda.synchronize()
    reset_launches()
    psnr, ssim, _ = evaluate_dataset(forward, params, args, scenes, cache=perop)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"per-op SR: PSNR {psnr:.6f} dB SSIM {ssim:.6f}; launches {counts}", flush=True)
    wrong = {k: c for k, c in counts.items()
             if c != (16 * n if k in ("ang_attn", "spa_attn_hp") else 0)}
    if wrong:
        raise AssertionError(f"per-op SR: expected 16 ang_attn and 16 spa_attn_hp launches a "
                             f"scene and no other kernel, got {wrong}")
    t_psnr, _, _ = evaluate_dataset(forward, params, args, scenes, cache=tiled)
    d_tiled = d_fused = 0.0
    first = None
    for lr, _ in scenes:
        lr_t = torch.from_numpy(lr).to(dev)
        sr, sr_t = perop(params, lr_t), tiled(params, lr_t)
        if sr.shape != (lr.shape[0] * 4, lr.shape[1] * 4) or not torch.isfinite(sr).all():
            raise AssertionError(f"bad per-op SR mosaic {tuple(sr.shape)}")
        first = first or {"the plain unfused path": sr_t, "the K7/K5 per-op path": sr}
        d_tiled = max(d_tiled, float((sr - sr_t).abs().max()))
        d_fused = max(d_fused, float((sr - fused_cache(params, lr_t)).abs().max()))
    print(f"per-op kernel path vs plain unfused path: max |SR diff| {d_tiled:.3e} (limit 1e-3), "
          f"dPSNR {psnr - t_psnr:+.3e} dB (limit 0.01); vs the fused kernel path: max |SR diff| "
          f"{d_fused:.3e}, dPSNR {psnr - fused_psnr:+.3e} dB", flush=True)
    if max(d_tiled, d_fused) > 1e-3 or max(abs(psnr - t_psnr), abs(psnr - fused_psnr)) > 0.01:
        raise AssertionError("the per-op kernel path disagrees with the plain or the fused path")

    def ms_scene(cache):
        times = []
        for lr, _ in scenes * 2:
            lr_t = torch.from_numpy(lr).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache(params, lr_t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    a, b = ms_scene(perop), ms_scene(fused_cache)
    print(f"scene SR, median of {2 * n} steady-state scenes: {a:.2f} ms/scene per-op kernels, "
          f"{b:.2f} ms/scene fused kernels, {ms_scene(tiled):.2f} ms/scene plain unfused",
          flush=True)
    return counts, first


def scene_phase(params, args, scene, what: str, expect: dict, refs=None, plain_impl=None,
                default_call: bool = False, ang=None, spa=None):
    """One scene through `evaluate_dataset` on the unfused branch (or, with
    `default_call`, with default arguments, where the gates choose the
    branch), the dispatchers' knobs set to `ang` / `spa`: the launches of the
    run must be exactly `expect` (kernel -> count), the mosaic is held
    against the mosaics of `refs` and, with `plain_impl`, against the plain
    unfused path with that torch attention (max |diff| 1e-3, |dPSNR| 0.01 dB),
    and a scene is timed. Returns the launch counts and the ms a scene."""
    import time

    import torch
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.ops.metrics import cal_metrics

    dev = torch.device("cuda")
    lr, hr = scene
    lr_t, hr_t = torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)
    with variants(ang, spa):
        cache = (ScenePipelineCache(forward, args) if default_call
                 else ScenePipelineCache(forward, args, fused=False))
        torch.cuda.synchronize()
        reset_launches()
        if default_call:
            psnr, ssim, _ = evaluate_dataset(forward, params, args, [scene])
        else:
            psnr, ssim, _ = evaluate_dataset(forward, params, args, [scene], cache=cache)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        print(f"{what}: PSNR {psnr:.6f} dB SSIM {ssim:.6f}; launches "
              f"{ {k: c for k, c in counts.items() if c} }", flush=True)
        wrong = {k: c for k, c in counts.items() if c != expect.get(k, 0)}
        if wrong:
            raise AssertionError(f"{what}: expected exactly {expect} launches, got {wrong}")
        sr = cache(params, lr_t)
        if sr.shape != hr_t.shape or not torch.isfinite(sr).all():
            raise AssertionError(f"{what}: bad SR mosaic {tuple(sr.shape)}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache(params, lr_t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    refs = dict(refs or {})
    ms_p = None
    if plain_impl is not None:
        plain = ScenePipelineCache(forward, args, fused=False, attention_impl=plain_impl)
        refs[f"the plain unfused path ({plain_impl} torch attention)"] = plain(params, lr_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain(params, lr_t)
        torch.cuda.synchronize()
        ms_p = (time.perf_counter() - t0) * 1e3
    for name, ref in refs.items():
        d = float((sr - ref).abs().max())
        dp = psnr - float(cal_metrics(hr_t, ref, args.angRes)[0])
        print(f"{what} vs {name}: max |SR diff| {d:.3e} (limit 1e-3), dPSNR {dp:+.3e} dB "
              f"(limit 0.01)", flush=True)
        if d > 1e-3 or abs(dp) > 0.01:
            raise AssertionError(f"{what} disagrees with {name}")
    ms = sorted(times)[1]
    print(f"{what}: {ms:.2f} ms/scene (median of 3, all {[round(t, 2) for t in times]})"
          + ("" if ms_p is None else f"; the plain unfused path {ms_p:.2f} ms/scene (one run)"),
          flush=True)
    return counts, ms


def perop_kernel_checks(card: str, sr_counts: dict, n_scenes: int, train_counts: dict,
                        n_steps: int, seed: int) -> list:
    """K7 and K5 against their plain versions: the primal at the serving
    shapes, the forward with (m, l) and the backward at the training shapes;
    then K5 in turns with K2.3 (its forward kernel) at the serving shape."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    E = 2 * C
    src_a, src_s = "lft_torch/csrc/ang_attn.cu", "lft_torch/csrc/spa_attn_hp.cu"
    mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
    rows = []
    for serving in (True, False):
        rec = (Recorder(card, sr_counts, n_scenes, "scene") if serving
               else Recorder(card, train_counts, n_steps, "train step"))
        patches = 16 if serving else 4
        N, V = patches * h * w, patches * A2

        # K7
        q, k, v = rand(N, A2, C), rand(N, A2, C), rand(N, A2, C)
        ref = am.ang_attention_blockdiag_plain(q, k, v, H)
        heads = lambda t: t.reshape(N, A2, H, C // H).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        fl = 4 * N * A2 * A2 * C
        if serving:
            got = am.ang_attn_fwd(q, k, v, H)
            rec.record("ang_attn", src_a, "lft_tpu/kernels/ang_attn_mxu.py:234", got, ref[0],
                       lambda: am.ang_attn_fwd(q, k, v, H),
                       lambda: am.ang_attention_blockdiag_plain(q, k, v, H), fl,
                       nbytes(q, k, v, ref[0]), lib_fn=sdpa)
            k7_f64_checks(q, k, v, None, ref, got, None, None)
        else:
            got = am.ang_attn_fwd(q, k, v, H, True)
            rec.record("ang_attn_res", src_a, "lft_tpu/kernels/ang_attn_mxu.py:244", got, ref,
                       lambda: am.ang_attn_fwd(q, k, v, H, True),
                       lambda: am.ang_attention_blockdiag_plain(q, k, v, H), fl,
                       nbytes(q, k, v, *ref), lib_fn=sdpa)
            fwd = ref
            _, m, l = ref
            dout = rand(N, A2, C)
            ref = am.ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, H)
            rec.record("ang_attn_bwd", src_a, "lft_tpu/kernels/ang_attn_mxu.py:289",
                       am.ang_attn_bwd(q, k, v, m, l, dout, H), ref,
                       lambda: am.ang_attn_bwd(q, k, v, m, l, dout, H),
                       lambda: am.ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, H),
                       10 * N * A2 * A2 * C, nbytes(q, k, v, dout, m, l, *ref), rel=TRAIN_REL)
            k7_f64_checks(q, k, v, dout, fwd, got, ref,
                          am.ang_attn_bwd(q, k, v, *got[1:], dout, H))
            del fwd, m, l, dout
        del q, k, v, ref, qh, kh, vh, got

        # K5
        q, k, v = rand(V, h, w, E), rand(V, h, w, E), rand(V, h, w, E)
        ref = hp.windowed_attention_headpacked_plain(q, k, v, H, K)
        pairs = V * valid_window_pairs(h, w, K // 2)
        heads = lambda t: t.reshape(V, h * w, H, E // H).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        if serving:
            rec.record("spa_attn_hp", src_s, "lft_tpu/kernels/spa_attn_hp.py:419",
                       hp.spa_attn_hp_fwd(q, k, v, H, K), ref[0],
                       lambda: hp.spa_attn_hp_fwd(q, k, v, H, K),
                       lambda: hp.windowed_attention_headpacked_plain(q, k, v, H, K),
                       4 * E * pairs, nbytes(q, k, v, ref[0]), lib_fn=sdpa)
            same = torch.equal(hp.spa_attn_hp_fwd(q, k, v, H, K), sb.window_attn(q, k, v, H, K))
            print(f"  spa_attn_hp: bitwise equal to K2.3's spa_window_attn on the same inputs: "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError("spa_attn_hp is not K2.3's window step bit for bit")
            turns = [("K5 spa_attn_hp", lambda: hp.spa_attn_hp_fwd(q, k, v, H, K)),
                     ("K2.3 spa_window_attn", lambda: sb.window_attn(q, k, v, H, K))]
        else:
            rec.record("spa_attn_hp_res", src_s, "lft_tpu/kernels/spa_attn_hp.py:433",
                       hp.spa_attn_hp_fwd(q, k, v, H, K, True), ref,
                       lambda: hp.spa_attn_hp_fwd(q, k, v, H, K, True),
                       lambda: hp.windowed_attention_headpacked_plain(q, k, v, H, K),
                       4 * E * pairs, nbytes(q, k, v, *ref), lib_fn=sdpa)
            out, m, l = ref
            dout = rand(V, h, w, E)
            ref = hp.windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout, H, K)
            rec.record("spa_attn_hp_bwd", src_s, "lft_tpu/kernels/spa_attn_hp.py:514",
                       hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K), ref,
                       lambda: hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K),
                       lambda: hp.windowed_attention_headpacked_bwd_plain(q, k, v, m, l, dout,
                                                                          H, K),
                       10 * E * pairs, nbytes(q, k, v, dout, m, l, *ref), rel=TRAIN_REL)
            # against float64, each backward from its own forward's (m, l)
            res_k = hp.spa_attn_hp_fwd(q, k, v, H, K, True)[1:]
            got = hp.spa_attn_hp_bwd(q, k, v, *res_k, dout, H, K)
            repeats = all(torch.equal(a, b) for a, b in
                          zip(got, hp.spa_attn_hp_bwd(q, k, v, *res_k, dout, H, K)))
            x64 = [t.double() for t in (q, k, v, dout)]
            exact = hp.windowed_attention_headpacked_bwd_plain(
                *x64[:3], *hp.windowed_attention_headpacked_plain(*x64[:3], H, K)[1:], x64[3],
                H, K)
            del x64
            for name, g_, r_, e_ in zip(("dq", "dk", "dv"), got, ref, exact):
                f64_check(f"spa_attn_hp_bwd {name}", g_, r_, e_, repeats)
            del got, exact
        if serving:
            # K5 beside K2's window step, the same function at the same shape,
            # in turns (K5's forward is K2.3's kernel; K3.c is K5's backward,
            # so that pair is not timed again)
            (na, fa), (nb, fb) = turns
            ta, tb, tb2, ta2 = timed(fa), timed(fb), timed(fb), timed(fa)
            print(f"at {[V, h, w, E]}: {na} {ta:.4f} / {ta2:.4f} ms, {nb} {tb:.4f} / {tb2:.4f} "
                  f"ms (turns a b b a, median of 10 each)", flush=True)
        rows += rec.rows
    return rows


def sweep_kernel_checks(card: str, sr_counts: dict, train_counts: dict, n_steps: int,
                        seed: int) -> list:
    """K8, K9 and K6 against their plain versions. The rows of the `kernels`
    line: the primal at the serving shapes of the 5x5 scene (K8
    [16384, 25, 64], K9 and K6 [400, 32, 32, 128]) with the launches of the
    forced-variant scenes, the forward with (m, l) and the backward at the
    training shapes ([4096, 25, 64], [100, 32, 32, 128]) with the launches of
    the forced-variant train steps. Then the other shapes the paths give
    them, all three forms each; then K5, K6, K9, K10 and K2.3 in turns (the
    backwards without K10, which has none), K6, K9 and K10 held bitwise to
    K5, whose kernels they launch; then K6 and K10 in turns at 64x64 views,
    held bitwise to each other."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.kernels import ang_attn_vjp as av
    from lft_torch.kernels import local_attn as la
    from lft_torch.kernels import local_attn_vjp as lv
    from lft_torch.kernels import spa_attn as sa
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    H, K = 8, 5
    # K9 and K6 launch K5's kernels
    src8, src9, src6 = ("lft_torch/csrc/ang_attn_sweep.cu", "lft_torch/csrc/spa_attn_hp.cu",
                        "lft_torch/csrc/spa_attn_hp.cu")
    rec_sr = Recorder(card, sr_counts, 1, "scene")
    rec_tr = Recorder(card, train_counts, n_steps, "train step")

    def k8(N, A2, C, forms, shape=None, reps=10):
        q, k, v = rand(N, A2, C), rand(N, A2, C), rand(N, A2, C)
        ref = av.ang_attention_sweep_plain(q, k, v, H)
        heads = lambda t: t.reshape(N, A2, H, C // H).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
        plain = lambda: av.ang_attention_sweep_plain(q, k, v, H)
        fl = 4 * N * A2 * A2 * C
        kw = dict(shape=shape, slow_reps=reps)
        where = f" at {[N, A2, C]}"
        if "fwd" in forms:
            got = av.ang_attn_sweep_fwd(q, k, v, H)
            rec_sr.record("ang_attn_sweep", src8, "lft_tpu/kernels/ang_attn_vjp.py:129", got,
                          ref[0], lambda: av.ang_attn_sweep_fwd(q, k, v, H), plain, fl,
                          nbytes(q, k, v, ref[0]), lib_fn=sdpa, **kw)
            k8_f64_checks(q, k, v, None, ref, got, None, None, where)
            if A2 <= 128:   # K7's kernel under K8's name
                same = torch.equal(got, am.ang_attn_fwd(q, k, v, H))
                print(f"  ang_attn_sweep{where}: bitwise equal to K7's ang_attn: {same}",
                      flush=True)
                if not same:
                    raise AssertionError("ang_attn_sweep is not K7's ang_attn bit for bit")
        if "res" in forms:
            got = av.ang_attn_sweep_fwd(q, k, v, H, True)
            rec_tr.record("ang_attn_sweep_res", src8, "lft_tpu/kernels/ang_attn_vjp.py:129",
                          got, ref, lambda: av.ang_attn_sweep_fwd(q, k, v, H, True), plain, fl,
                          nbytes(q, k, v, *ref), lib_fn=sdpa, **kw)
            if A2 <= 128:
                same = all(torch.equal(a, b) for a, b in zip(got, am.ang_attn_fwd(q, k, v, H,
                                                                                  True)))
                print(f"  ang_attn_sweep_res{where}: bitwise equal to K7's ang_attn_res: {same}",
                      flush=True)
                if not same:
                    raise AssertionError("ang_attn_sweep_res is not K7's ang_attn_res bit for bit")
        if "bwd" in forms:
            out, m, l = ref
            dout = rand(N, A2, C)
            ref_b = av.ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, H)
            rec_tr.record("ang_attn_sweep_bwd", src8, "lft_tpu/kernels/ang_attn_vjp.py:158",
                          av.ang_attn_sweep_bwd(q, k, v, out, m, l, dout, H), ref_b,
                          lambda: av.ang_attn_sweep_bwd(q, k, v, out, m, l, dout, H),
                          lambda: av.ang_attention_sweep_bwd_plain(q, k, v, out, m, l, dout, H),
                          10 * N * A2 * A2 * C, nbytes(q, k, v, dout, out, m, l, *ref_b),
                          rel=TRAIN_REL, **kw)
            got_r = av.ang_attn_sweep_fwd(q, k, v, H, True)
            got_b = av.ang_attn_sweep_bwd(q, k, v, *got_r, dout, H)
            k8_f64_checks(q, k, v, dout, ref, got_r, ref_b, got_b, where)
            if A2 <= av.K7_BWD_MAX:   # K7's backward kernel under K8's name
                same = all(torch.equal(a, b) for a, b in zip(
                    got_b, am.ang_attn_bwd(q, k, v, *got_r[1:], dout, H)))
                print(f"  ang_attn_sweep_bwd{where}: bitwise equal to K7's ang_attn_bwd: {same}",
                      flush=True)
                if not same:
                    raise AssertionError("ang_attn_sweep_bwd is not K7's ang_attn_bwd bit for bit")
        del q, k, v, ref, qh, kh, vh
        torch.cuda.empty_cache()

    def window(which, V, h, w, E, forms, shape=None, reps=10):
        """K9 (which = 9) or K6 (which = 6) at [V, h, w, E]."""
        q, k, v = rand(V, h, w, E), rand(V, h, w, E), rand(V, h, w, E)
        pairs = V * valid_window_pairs(h, w, K // 2)
        mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
        heads = lambda t: t.reshape(V, h * w, H, E // H).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        # no library time where a dense [V, H, hw, hw] score tensor, should the call
        # materialise one, would not fit beside the rest (the 64x64 views)
        sdpa = (lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)) \
            if V * H * (h * w) ** 2 * 4 <= 16e9 else None
        kw = dict(shape=shape, slow_reps=reps)
        if which == 9:
            name, src, rep_f, rep_b = ("spa_attn_offset", src9,
                                       "lft_tpu/kernels/local_attn_vjp.py:257",
                                       "lft_tpu/kernels/local_attn_vjp.py:314")
            fwd, plain = lv.spa_attn_offset_fwd, lv.windowed_attention_offset_plain
        else:
            name, src, rep_f, rep_b = ("spa_attn_mxu", src6, "lft_tpu/kernels/spa_attn.py:233",
                                       "lft_tpu/kernels/spa_attn.py:271")
            fwd, plain = sa.spa_attn_mxu_fwd, sa.windowed_attention_mxu_plain
        ref = plain(q, k, v, H, K)
        if "fwd" in forms:
            rec_sr.record(name, src, rep_f, fwd(q, k, v, H, K), ref[0],
                          lambda: fwd(q, k, v, H, K), lambda: plain(q, k, v, H, K),
                          4 * E * pairs, nbytes(q, k, v, ref[0]), lib_fn=sdpa, **kw)
        if "res" in forms:
            rep_r = rep_f if which == 9 else "lft_tpu/kernels/spa_attn.py:220"
            rec_tr.record(name + "_res", src, rep_r, fwd(q, k, v, H, K, True), ref,
                          lambda: fwd(q, k, v, H, K, True), lambda: plain(q, k, v, H, K),
                          4 * E * pairs, nbytes(q, k, v, *ref), lib_fn=sdpa, **kw)
        if "bwd" in forms:
            out, m, l = ref
            dout = rand(V, h, w, E)
            if which == 9:
                res = (q, k, v, out, m, l, dout, H, K)
                bwd, bwd_plain = lv.spa_attn_offset_bwd, lv.windowed_attention_offset_bwd_plain
            else:
                res = (q, k, v, m, l, dout, H, K)
                bwd, bwd_plain = sa.spa_attn_mxu_bwd, sa.windowed_attention_mxu_bwd_plain
            ref = bwd_plain(*res)
            # both read q, k, v, m, l, dout (K9's D comes from them, not from out)
            rec_tr.record(name + "_bwd", src, rep_b, bwd(*res), ref, lambda: bwd(*res),
                          lambda: bwd_plain(*res), 10 * E * pairs,
                          nbytes(q, k, v, m, l, dout, *ref), rel=TRAIN_REL, **kw)

    # the rows: the 5x5 scene's chunk of 16 patches, the recipe's batch of 4
    k8(16384, 25, 64, ("fwd",))
    k8(4096, 25, 64, ("res", "bwd"))
    for which in (9, 6):
        window(which, 400, 32, 32, 128, ("fwd",))
        window(which, 100, 32, 32, 128, ("res", "bwd"))
    # the other shapes of the paths, every form: the 12x12-view scene's chunk
    # of 9 patches, the 12x12-view step's batch of 2 and a 13x13-view chunk of
    # a pixel count no group divides; the
    # 30x30, 7x7 and 8x101 views that reach K9; the 64x64 and 8x101 views that
    # reach K6 (the scene's chunk of 16 patches, and 9 of them)
    all_forms = ("fwd", "res", "bwd")
    k8(9216, 144, 64, all_forms, shape=(9216, 144, 64), reps=3)
    k8(2048, 144, 64, all_forms, shape=(2048, 144, 64), reps=3)
    k8(1001, 169, 64, all_forms, shape=(1001, 169, 64), reps=3)
    for V, h, w in ((400, 30, 30), (400, 7, 7), (100, 8, 101)):
        window(9, V, h, w, 128, all_forms, shape=(V, h, w, 128), reps=3)
    for V, h, w in ((400, 64, 64), (225, 64, 64), (100, 8, 101)):
        window(6, V, h, w, 128, all_forms, shape=(V, h, w, 128), reps=3)

    # one function by three kernels (five forward, K5 and K2.3 one kernel): in
    # turns a b c .. c b a at one shape (K3.c is K5's backward: not timed again)
    for V, bwd in ((400, False), (100, True)):
        q, k, v, dout = (rand(V, 32, 32, 128) for _ in range(4))
        if bwd:
            out, m, l = hp.windowed_attention_headpacked_plain(q, k, v, H, K)
            want = (*hp.spa_attn_hp_fwd(q, k, v, H, K, True),
                    *hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K))
            forms = {"K6": (*sa.spa_attn_mxu_fwd(q, k, v, H, K, True),
                            *sa.spa_attn_mxu_bwd(q, k, v, m, l, dout, H, K)),
                     "K9": (*lv.spa_attn_offset_fwd(q, k, v, H, K, True),
                            *lv.spa_attn_offset_bwd(q, k, v, out, m, l, dout, H, K))}
        else:
            want = (hp.spa_attn_hp_fwd(q, k, v, H, K),)
            forms = {"K6": (sa.spa_attn_mxu_fwd(q, k, v, H, K),),
                     "K9": (lv.spa_attn_offset_fwd(q, k, v, H, K),),
                     "K10": (la.windowed_attention_tile(q, k, v, H, K),)}
        for who, got in forms.items():
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"{who} equals K5 bit for bit at {[V, 32, 32, 128]} "
                  f"({'_res, _bwd' if bwd else 'forward'}): {same}", flush=True)
            if not same:
                raise AssertionError(f"{who} launches K5's kernels: its outputs must equal K5's")
        del want, forms
        if bwd:
            turns = [("K5 spa_attn_hp_bwd", lambda: hp.spa_attn_hp_bwd(q, k, v, m, l, dout, H, K)),
                     ("K6 spa_attn_mxu_bwd", lambda: sa.spa_attn_mxu_bwd(q, k, v, m, l, dout, H, K)),
                     ("K9 spa_attn_offset_bwd",
                      lambda: lv.spa_attn_offset_bwd(q, k, v, out, m, l, dout, H, K))]
        else:
            turns = [("K5 spa_attn_hp", lambda: hp.spa_attn_hp_fwd(q, k, v, H, K)),
                     ("K6 spa_attn_mxu", lambda: sa.spa_attn_mxu_fwd(q, k, v, H, K)),
                     ("K9 spa_attn_offset", lambda: lv.spa_attn_offset_fwd(q, k, v, H, K)),
                     ("K10 spa_attn_tile", lambda: la.windowed_attention_tile(q, k, v, H, K)),
                     ("K2.3 spa_window_attn", lambda: sb.window_attn(q, k, v, H, K))]
        first = [timed(fn) for _, fn in turns]
        second = [timed(fn) for _, fn in reversed(turns)][::-1]
        print(f"at {[V, 32, 32, 128]} (turns a b .. b a, median of 10 each): "
              + ", ".join(f"{n} {a:.4f} / {b:.4f} ms"
                          for (n, _), a, b in zip(turns, first, second)), flush=True)
    # at 64x64 views the dispatch sends inference to K6 (lft_tpu's gate); K10
    # is the forward-only alternative the `offset` variant takes there
    q, k, v = (rand(400, 64, 64, 128) for _ in range(3))
    turns = [("K6 spa_attn_mxu", lambda: sa.spa_attn_mxu_fwd(q, k, v, H, K)),
             ("K10 spa_attn_tile", lambda: la.windowed_attention_tile(q, k, v, H, K))]
    if not torch.equal(turns[0][1](), turns[1][1]()):
        raise AssertionError("K6 and K10 launch K5's forward kernel: they must agree bit for bit")
    tm = [timed(turns[0][1]), timed(turns[1][1]), timed(turns[1][1]), timed(turns[0][1])]
    print(f"at [400, 64, 64, 128] (turns a b b a, median of 10 each; bit for bit equal): K6 "
          f"spa_attn_mxu {tm[0]:.4f} / {tm[3]:.4f} ms, K10 spa_attn_tile {tm[1]:.4f} / "
          f"{tm[2]:.4f} ms", flush=True)
    return rec_sr.rows + rec_tr.rows


def angres9_phase(params, seed: int):
    """K7 at A2 = 81 against its plain version; train steps at angRes 9 (the
    demo checkpoint's weights do not depend on the view count; batch 4 of
    16x16-view patches): `--train_fused true` through the fused blocks, whose
    backward is K4's three-kernel form `ang_block_bwd128` there, and
    `--train_fused false` through the per-op kernels K7/K5; inference at
    angRes 9 stays fused. Returns the fused steps' launch counts and their
    number.

    The gradient bound is that of the train steps, 5e-4 max|grad| + 2e-9,
    with one allowance: a 9x9-view batch of this size has a fifth of the
    recipe batch's tokens, and the smallest gradients (the attentions'
    pre-norms, sums that nearly cancel) then differ by more than that
    between two PLAIN f32 paths, the unfused branch with the tiled torch
    attention and the fused branch's plain blocks. So both plain paths run,
    and where their own difference is larger a gradient is held to twice
    that difference instead."""
    import torch
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.models.lft import forward

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    N, A2, C, H = 1024, 81, 64, 8
    q, k, v, dout = (torch.randn(N, A2, C, device=dev, generator=g) for _ in range(4))
    ref = am.ang_attention_blockdiag_plain(q, k, v, H)
    e_f, ok_f = max_err(am.ang_attn_fwd(q, k, v, H, True), ref)
    _, m, l = ref
    ref_b = am.ang_attention_blockdiag_bwd_plain(q, k, v, m, l, dout, H)
    e_b, ok_b = max_err(am.ang_attn_bwd(q, k, v, m, l, dout, H), ref_b, TRAIN_REL)
    ms_f = timed(lambda: am.ang_attn_fwd(q, k, v, H, True))
    ms_b = timed(lambda: am.ang_attn_bwd(q, k, v, m, l, dout, H))
    print(f"K7 at A2 = 81 [{N}, 81, 64]: forward with stats max_abs_err {e_f:.3e} "
          f"({ms_f:.4f} ms), backward {e_b:.3e} ({ms_b:.4f} ms)", flush=True)
    if not (ok_f and ok_b):
        raise AssertionError("K7 at A2 = 81 disagrees with its plain version")
    got = am.ang_attn_fwd(q, k, v, H, True)
    k7_f64_checks(q, k, v, dout, ref, got, ref_b, am.ang_attn_bwd(q, k, v, *got[1:], dout, H),
                  " at A2 = 81")
    del q, k, v, dout, ref, m, l, ref_b, got

    counts, n_steps, ms_fused = train_phase(
        params, seed, what="angRes-9 fused train (K1, K4 128-row, K2, K3)", ang_res=9, patch=16,
        batch=4, other_plain=dict(fused=False, attention_impl="tiled"))
    _, _, ms_perop = train_phase(
        params, seed, unfused=True, what="angRes-9 per-op train (K7, K5)", ang_res=9, patch=16,
        batch=4, other_plain=dict(fused=True, plain_blocks=True))
    print(f"train step at angRes 9 (batch 4 of 16x16 views), medians: {ms_fused:.3f} ms fused "
          f"(--train_fused true), {ms_perop:.3f} ms per-op (--train_fused false)", flush=True)

    args = Args(angRes=9, scale_factor=4, channels=64)
    lr, _ = synth_batch(g, batch=4, ang_res=9, patch=16, scale=4)
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        sr_i = forward(params, lr, args)
        torch.cuda.synchronize()
        if LAUNCHES["ang_block"] != 4 or LAUNCHES["ang_attn"]:
            raise AssertionError(f"inference at angRes 9 must stay fused: {dict(LAUNCHES)}")
        d_i = float((sr_i - forward(params, lr, args, fused=False,
                                    attention_impl="tiled")).abs().max())
    print(f"inference at angRes 9 stays on the fused kernels (4 ang_block launches), max |SR "
          f"diff| to the plain unfused path {d_i:.3e} (limit 1e-4)", flush=True)
    if d_i > 1e-4:
        raise AssertionError("angRes 9: the fused forward disagrees with the plain path")
    return counts, n_steps


def pixel_major_phase(params, cache, scene, card: str) -> list:
    """K11 at full width: the AngTrans output of the scene's first chunk
    [16, 32, 32, 25, 64], pixel-major as K1 leaves it, through
    `spa_trans_block_fused(pixel_major=True)` with block 0's weights: against
    its plain version and against view-major K2 on a permuted copy, the
    launches, the device memory it takes, and its time in turns with "permute
    + K2 + permute back". Then its two `_pm` kernels against their plain
    versions. Returns their rows of the `kernels` line."""
    import torch
    import lft_torch.models.lft as model
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.posenc import spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear

    dev = torch.device("cuda")
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    # the first AngTrans output of the scene, taken where the forward makes it
    taken = []
    block = model.ang_trans_block_fused

    def keep_first(t, *a, **kw):
        out = block(t, *a, **kw)
        if not taken:
            taken.append(out.detach().clone())
        return out

    model.ang_trans_block_fused = keep_first
    try:
        cache(params, torch.from_numpy(scene[0]).to(dev))
    finally:
        model.ang_trans_block_fused = block
    x = taken[0].reshape(-1, h, w, A2, C)
    Bb = x.shape[0]
    if tuple(x.shape) != (16, h, w, A2, C):
        raise AssertionError(f"K11: unexpected chunk shape {tuple(x.shape)}")
    prefix = "altblock.0.spa_trans."
    ws = sb.spa_weights(params, prefix)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                              ws["mlp"])[0].contiguous()
    to_vm = lambda t: t.permute(0, 3, 1, 2, 4).reshape(Bb * A2, h, w, C).contiguous()
    to_pm = lambda t: t.reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
    k11 = lambda: sb.spa_trans_block_fused(x, pe_tok, params, prefix, H, K, pixel_major=True)
    k2 = lambda t: sb.spa_trans_block_fused(t, pe_tok, params, prefix, H, K)
    copied = lambda: to_pm(k2(to_vm(x)))

    def extra_memory(fn):
        """Peak device memory above what is held before the call, in bytes."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - before

    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launches()
        got = k11()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        expect = dict.fromkeys(("spa_tokenize_ln_pm", "spa_qkv", "spa_window_attn",
                                "spa_outproj_ln", "spa_ffn_out_pm"), 1)
        if {k_: c for k_, c in counts.items() if c} != expect:
            raise AssertionError(f"K11: expected one launch of each of {tuple(expect)}, got "
                                 f"{ {k_: c for k_, c in counts.items() if c} }")
        ref = sb.spa_trans_block_plain(x, pe_tok, params, prefix, H, K, pixel_major=True)
        err, ok = max_err(got, ref)
        xv = to_vm(x)
        d_vm = float((got - to_pm(k2(xv))).abs().max())
        mem_pm, mem_vm = extra_memory(k11), extra_memory(lambda: k2(xv))
        mem_cp = extra_memory(copied)
        del xv
        mib = 2.0 ** -20
        print(f"K11 spa_trans pixel-major at {list(x.shape)}: max_abs_err {err:.3e} to its plain "
              f"version (limit {KERNEL_ATOL:g} x max(1, max|ref|)), max |diff| {d_vm:.3e} to "
              f"view-major K2 on a permuted copy; launches {expect}; device memory above the "
              f"input: {mem_pm * mib:.1f} MiB, view-major K2 {mem_vm * mib:.1f} MiB, permute + K2 "
              f"+ permute back {mem_cp * mib:.1f} MiB (the buffer is {nbytes(x) * mib:.1f} MiB)",
              flush=True)
        if not ok or d_vm > KERNEL_ATOL:
            raise AssertionError("K11 disagrees with its plain version or with view-major K2")
        if mem_pm > mem_vm + (1 << 20):
            raise AssertionError("K11 takes more device memory than view-major K2: a copy of "
                                 "the buffer was made")
        ta, tb = timed(k11), timed(copied)
        tb2, ta2 = timed(copied), timed(k11)
        ms_p = timed(lambda: sb.spa_trans_block_plain(x, pe_tok, params, prefix, H, K,
                                                      pixel_major=True), 3, 1)
        print(f"K11 chained (5 kernels) {ta:.4f} / {ta2:.4f} ms, permute + K2 + permute back "
              f"{tb:.4f} / {tb2:.4f} ms (turns a b b a, median of 10 each), plain {ms_p:.4f} ms",
              flush=True)

        # the two kernels K11 adds, each fed its plain predecessor's output
        rec = Recorder(card, counts, 1, "call")
        T = Bb * A2 * h * w
        wbytes = lambda *k_: sum(nbytes(ws[n]) for n in k_)
        src, rep = "lft_torch/csrc/spa_block.cu", "lft_tpu/kernels/spa_block.py:309"
        tok, xn = sb.tokenize_ln_plain(to_vm(x), pe_tok, ws)
        got = sb.tokenize_ln(x, pe_tok, ws, True)
        rec.record("spa_tokenize_ln_pm", src, rep, got, (tok, xn),
                   lambda: sb.tokenize_ln(x, pe_tok, ws, True),
                   lambda: sb.tokenize_ln_plain(to_vm(x), pe_tok, ws),
                   2 * C * D * Bb * A2 * valid_window_pairs(h, w, 1),
                   nbytes(x, pe_tok, tok, xn) + wbytes("wu", "ln"), tf32_products=3)
        again = sb.tokenize_ln(x, pe_tok, ws, True)
        f64_check("spa_tokenize_ln_pm tok", got[0], tok,
                  unfold3x3_linear(to_vm(x).double(), ws["mlp"].double()),
                  all(torch.equal(a, b) for a, b in zip(got, again)))
        del got, again
        q, kk, v = sb.qkv_plain(xn, tok, ws)
        x2, xn2 = sb.outproj_ln_plain(sb.window_attn(q, kk, v, H, K), tok, ws)
        del q, kk, v, tok, xn
        out = to_pm(sb.ffn_out_plain(xn2, x2, ws))
        got = sb.ffn_out(xn2, x2, ws, A2)
        rec.record("spa_ffn_out_pm", src, rep, got, out,
                   lambda: sb.ffn_out(xn2, x2, ws, A2),
                   lambda: to_pm(sb.ffn_out_plain(xn2, x2, ws)),
                   2 * T * (4 * D * D + D * C), nbytes(xn2, x2, out) + wbytes("w1", "w2", "wlin"),
                   tf32_products=3)
        f64_check("spa_ffn_out_pm out", got, out,
                  to_pm(sb.ffn_out_plain(xn2.double(), x2.double(),
                                         {k: v.double() for k, v in ws.items()})),
                  torch.equal(got, sb.ffn_out(xn2, x2, ws, A2)))
        del got
    return rec.rows


def tail_kernel_checks(params, card: str, tile_counts: dict, tile64_counts: dict,
                       a9_counts: dict, a9_steps: int, seed: int) -> list:
    """K10 and the 128-row K4 against their plain versions. The rows of the
    `kernels` line: K10 at the tile scene's [400, 32, 32, 128] with that
    scene's launches, K4 at the angRes-9 step's [1024, 81, 64] (block 0's
    weights) with those steps' launches. Then K10 at the patch-64 scene's
    [400, 64, 64, 128] beside that scene's launches, and K4 at A2 = 121 and
    128 with a ragged last block. K10 launches K5's forward kernel: it is
    held bit for bit to K5's at both shapes."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import local_attn as la
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.ops.posenc import angular_position

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    H, K, C, E = 8, 5, 64, 128
    rec_sr = Recorder(card, tile_counts, 1, "scene")
    rec_sr64 = Recorder(card, tile64_counts, 1, "scene")
    rec_tr = Recorder(card, a9_counts, a9_steps, "train step")

    for V, h, w, shape in ((400, 32, 32, None), (400, 64, 64, (400, 64, 64, E))):
        q, k, v = rand(V, h, w, E), rand(V, h, w, E), rand(V, h, w, E)
        ref = la.windowed_attention_tile_plain(q, k, v, H, K)
        sdpa = None
        if shape is None:       # a dense [V, H, hw, hw] score tensor fits only at 32x32 views
            mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
            heads = lambda t: t.reshape(V, h * w, H, E // H).transpose(1, 2)
            qh, kh, vh = heads(q), heads(k), heads(v)
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        (rec_sr if shape is None else rec_sr64).record(
            "spa_attn_tile", "lft_torch/csrc/spa_attn_hp.cu",
            "lft_tpu/kernels/local_attn.py:99", la.windowed_attention_tile(q, k, v, H, K), ref,
            lambda: la.windowed_attention_tile(q, k, v, H, K),
            lambda: la.windowed_attention_tile_plain(q, k, v, H, K),
            4 * E * V * valid_window_pairs(h, w, K // 2), nbytes(q, k, v, ref),
            lib_fn=sdpa, shape=shape, slow_reps=3)
        same = torch.equal(la.windowed_attention_tile(q, k, v, H, K),
                           hp.spa_attn_hp_fwd(q, k, v, H, K))
        print(f"K10 equals K5 bit for bit at {[V, h, w, E]}: {same}", flush=True)
        if not same:
            raise AssertionError("K10 launches K5's forward kernel: its output must equal K5's")
        del q, k, v, ref

    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    for N, A2, shape in ((1024, 81, None), (1001, 121, (1001, 121, C)), (333, 128, (333, 128, C))):
        pe = torch.from_numpy(angular_position(A2, C)).to(dev)
        bwd_in = k4_check(rec_tr, "ang_block_bwd128", rand(N, A2, C), pe, wa, rand(N, A2, C),
                          TRAIN_REL, shape)
        if shape is None:
            full, full_p = ab.ang_block_bwd(*bwd_in), ab.ang_block_bwd_plain(*bwd_in)
            err, ok = max_err(full, full_p, TRAIN_REL)
            same = all(torch.equal(a, b) for a, b in zip(full, ab.ang_block_bwd(*bwd_in)))
            ms_k = timed(lambda: ab.ang_block_bwd(*bwd_in))
            print(f"block ang_trans backward at {[N, A2, C]} (K4 128-row + 6 wgrad + colsum): "
                  f"max_abs_err {err:.3e}, {ms_k:.4f} ms, repeated bitwise: {same}", flush=True)
            if not (ok and same):
                raise AssertionError("the AngTrans backward at A2 = 81 disagrees with its plain "
                                     "version or does not repeat")
    return rec_sr.rows + rec_tr.rows


class MemTestSet:
    """Scenes as `TestDataset` holds them, without h5 files: stored
    transposed (Matlab's column-major layout), read back with its (1, 0)
    transpose, named and shaped as it names and shapes them."""

    def __init__(self, scenes):
        import numpy as np
        self.stored = [(np.ascontiguousarray(lr.T), np.ascontiguousarray(hr.T))
                       for lr, hr in scenes]

    def __len__(self):
        return len(self.stored)

    def scene_name(self, i):
        return f"scene_{i:02d}"

    def scene_shape(self, i):
        s = self.stored[i][0].shape
        return (s[1], s[0])

    def __getitem__(self, i):
        import numpy as np
        return tuple(np.ascontiguousarray(t.transpose(1, 0), dtype=np.float32)
                     for t in self.stored[i])


class MemTrainSet:
    """Training patches in memory, as `TrainDataset` serves them: `item`
    applies the reference's augmentation with the given rng; `seed` makes
    the batches reproducible."""

    def __init__(self, lr, hr, seed: int):
        self.lr, self.hr, self.seed = lr, hr, seed

    def __len__(self):
        return len(self.lr)

    def item(self, index, rng):
        import numpy as np
        from lft_torch.data.datasets import augmentation
        d, l = augmentation(self.lr[index, 0], self.hr[index, 0], rng)
        return np.ascontiguousarray(d)[None], np.ascontiguousarray(l)[None]


def trace_stats(path: str):
    """(kernel names, wall ms, device busy ms) of a Chrome trace: the wall
    from its first to its last event, busy the union of its kernels."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e and "dur" in e]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("cat") == "kernel")
    busy, end = 0.0, -math.inf
    for t0, t1 in kernels:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    wall = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events)) if events else 0.0
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    return names, wall / 1e3, busy / 1e3


def cli_phase(args, scenes, step4, card: str, seed: int) -> None:
    """Step 20: the test and train CLIs' bodies on the card (module
    docstring)."""
    import dataclasses
    import tempfile
    import time

    import torch
    from lft_torch import test as test_cli
    from lft_torch import train as train_cli
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import FORWARD, LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from lft_torch.utils.logging import Logger, create_dir

    psnr, ssim, scene_rows = step4
    n_scenes = len(scenes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        t_args = dataclasses.replace(args, path_pre_pth=CKPT, data_name="Synth",
                                     path_log=os.path.join(tmp, "test"))
        # (a) cuDNN as a fresh process has it (the train phases above made it
        # deterministic; train steps set that again), as in step 4
        torch.backends.cudnn.deterministic = False
        _, _, log_dir = create_dir(t_args)
        torch.cuda.synchronize()
        reset_launches()
        p_sets, s_sets = test_cli.evaluate_sets(t_args, ["Synth"], [MemTestSet(scenes)],
                                                Logger(log_dir, t_args))
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        print(f"test CLI: PSNR {p_sets[0]!r} SSIM {s_sets[0]!r}, step 4 {psnr!r} {ssim!r}; "
              f"launches {counts}", flush=True)
        if (p_sets, s_sets) != ([psnr], [ssim]):
            raise AssertionError("the test CLI's PSNR/SSIM differ from step 4's")
        wrong = {k: v for k, v in counts.items()
                 if v != (16 * n_scenes if k in FORWARD else 0)}
        if wrong:
            raise AssertionError(f"test CLI: expected {16 * n_scenes} launches of each "
                                 f"forward kernel and no other, got {wrong}")
        with open(os.path.join(log_dir, "LFT.txt")) as f:
            log = [line.rstrip("\n").split(" - INFO - ", 1)[-1] for line in f]
        want = (["  Synth/scene_%02d: psnr/ssim %.2f/%.3f" % (i, p, s)
                 for i, (_, p, s) in enumerate(scene_rows)]
                + ["Test on Synth, psnr/ssim is %.2f/%.3f" % (psnr, ssim),
                   "Mean over datasets: psnr/ssim is %.2f/%.3f" % (psnr, ssim)])
        if log[-len(want):] != want:
            raise AssertionError(f"test CLI log ends {log[-len(want):]}, want {want}")
        print(f"test CLI log: {len(log)} lines, ending as step 4's results", flush=True)

        # (b) the same under --profile_dir; CUPTI now and then hands the
        # profiler no kernel records, so a trace without them is taken again
        p_args = dataclasses.replace(t_args, profile_dir=os.path.join(tmp, "trace"))
        for _ in range(3):
            test_cli.evaluate_sets(p_args, ["Synth"], [MemTestSet(scenes)],
                                   Logger(log_dir, p_args))
            names, wall, busy = trace_stats(os.path.join(p_args.profile_dir,
                                                         "test.pt.trace.json"))
            if names:
                break
            print("test CLI trace: no kernel records, tracing again", flush=True)
        for want_k in ("ang_block", "spa_window_attn"):
            if not any(want_k in n for n in names):
                raise AssertionError(f"the --profile_dir trace names no {want_k!r} kernel")
        print(f"test CLI under --profile_dir: trace wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f} ({len(names)} kernel "
              f"names)", flush=True)

        # (e) ms a scene of the test CLI's sweep, with and without prefetch
        cache = ScenePipelineCache(forward, t_args, eval_batch=t_args.eval_batch,
                                   scene_batch=t_args.scene_batch)
        params, _, _ = load_checkpoint(CKPT)
        mem_set = MemTestSet(scenes)
        ms = {True: [], False: []}
        for prefetch in (True, False, False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_dataset(forward, params, t_args, mem_set, cache=cache, prefetch=prefetch)
            torch.cuda.synchronize()
            ms[prefetch].append((time.perf_counter() - t0) * 1e3 / n_scenes)
        print(f"test CLI sweep, ms a scene ({n_scenes} scenes, in turns): prefetch "
              f"{ms[True]}, no prefetch {ms[False]}; {card}", flush=True)
        # where an unprefetched scene's time goes, each part synchronised
        dev = next(iter(params.values())).device
        parts = {"read (transposes)": 0.0, "to the card": 0.0, "SR": 0.0, "metrics": 0.0}
        for i in range(n_scenes):
            t = [time.perf_counter()]
            lr, hr = mem_set[i]
            t.append(time.perf_counter())
            lr, hr = (torch.as_tensor(x, device=dev) for x in (lr, hr))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            sr = cache(params, lr)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            p, s = cal_metrics(hr, sr, t_args.angRes)
            float(p), float(s)  # on the host, as evaluate_dataset reads them
            t.append(time.perf_counter())
            for k, t0, t1 in zip(parts, t, t[1:]):
                parts[k] += (t1 - t0) * 1e3 / n_scenes
        print("test CLI scene parts, ms a scene without prefetch: "
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + f"; {card}", flush=True)

        # (c) the train CLI, 2 epochs of 2 steps, from the checkpoint's weights
        lr, hr = synth_batch(torch.Generator(device=dev).manual_seed(seed), batch=8, ang_res=5,
                             patch=32, scale=4)
        trainset = MemTrainSet(lr.cpu().numpy(), hr.cpu().numpy(), seed)
        start = os.path.join(tmp, "start.npz")
        save_checkpoint(start, params, 0)
        tr_args = dataclasses.replace(t_args, batch_size=4, epoch=2, train_fused="auto",
                                      use_pre_pth=True, path_pre_pth=start, seed=seed,
                                      path_log=os.path.join(tmp, "train"))
        torch.cuda.synchronize()
        reset_launches()
        full, hist = train_cli.main(tr_args, dataset=trainset)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        losses = [h["loss"] for h in hist]
        print(f"train CLI: epoch means {hist}; launches {counts}", flush=True)
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train CLI: bad losses {losses}")
        n_steps = 2 * len(trainset) // tr_args.batch_size
        wrong = {k: v for k, v in counts.items()
                 if v != (4 * n_steps if k in PEROP_TRAIN else 0)}
        if wrong:
            raise AssertionError(f"train CLI: expected {4 * n_steps} launches of each of "
                                 f"{PEROP_TRAIN} and no other, got {wrong}")
        ck_dir = os.path.join(tr_args.path_log, "SR_5x5_4x", "LFT", "Synth", "checkpoints")
        names = sorted(os.listdir(ck_dir))
        if names != ["LFT_5x5_4x_epoch_01_model.npz", "LFT_5x5_4x_epoch_02_model.npz"]:
            raise AssertionError(f"train CLI checkpoints: {names}")
        r_args = dataclasses.replace(tr_args, path_pre_pth=os.path.join(ck_dir, names[0]),
                                     path_log=os.path.join(tmp, "resume"))
        resumed, _ = train_cli.main(r_args, dataset=trainset)
        differ = [k for k in full if not torch.equal(full[k], resumed[k])]
        if differ:
            raise AssertionError(f"train CLI: resumed from epoch 1, {len(differ)} parameters "
                                 f"differ from the uninterrupted run's, e.g. {differ[:3]}")
        print("train CLI: checkpoints " + ", ".join(names) + "; resumed from epoch 1, every "
              "epoch-2 parameter equals the uninterrupted run's bit for bit", flush=True)

        # (d) the h5 reader's missing module is named
        try:
            import h5py  # noqa: F401
            print("step 20 d skipped: h5py is installed on this machine", flush=True)
        except ImportError:
            h5_dir = os.path.join(tmp, "h5", "SR_5x5_4x", "Synth")
            os.makedirs(h5_dir)
            open(os.path.join(h5_dir, "scene_00.h5"), "wb").close()
            out = subprocess.run(
                [sys.executable, "-m", "lft_torch.test", "--path_for_test",
                 os.path.join(tmp, "h5"), "--path_log", os.path.join(tmp, "h5log"),
                 "--path_pre_pth", CKPT], cwd=REPO, capture_output=True, text=True,
                timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
            last = (out.stderr.strip().splitlines() or [""])[-1]
            if out.returncode == 0 or "h5py" not in last:
                raise AssertionError(f"python -m lft_torch.test without h5py: rc "
                                     f"{out.returncode}, last line {last!r}")
            print(f"python -m lft_torch.test without h5py: rc {out.returncode}, {last}",
                  flush=True)


DP_SGD_LR = 0.1          # SGD isolates the gradient average (tests/_dp_check.py)


def dp_args(**kw):
    from lft_torch.config import Args
    return Args(angRes=5, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
                gamma=0.5, epoch=50, **kw)


def dp_rank(mesh, lr_np, seed: int) -> dict:
    """Step 21 b and c on one of two gloo ranks sharing the card (module
    docstring); raises on a failed check. Rank 0's result goes back to the
    parent: its launch counts, the SGD differences and its SR mosaic."""
    import dataclasses
    import functools

    import torch
    import torch.distributed as dist
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.inference.tiled import ScenePipelineCache
    from lft_torch.kernels import FORWARD, LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.parallel.mesh import make_dp_train_step
    from lft_torch.registry import get_model
    from lft_torch.training.optim import SGD, make_optimizer
    from lft_torch.training.trainer import make_train_step
    from lft_torch.utils.checkpoint import load_checkpoint

    dev = mesh.device
    params, _, _ = load_checkpoint(CKPT, device=dev)
    args = dp_args()
    model = get_model(args)
    lr, hr = synth_batch(torch.Generator(device=dev).manual_seed(seed), batch=4, ang_res=5,
                         patch=32, scale=4)
    per = lr.shape[0] // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def fresh():
        return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    def same_on_every_rank(t) -> bool:
        ref = t.clone()
        dist.broadcast(ref, 0)
        ok = torch.tensor([float(torch.equal(ref, t))], device=dev)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        return bool(ok.item())

    # (b) under SGD: the DP step on this rank's 2 patches against one
    # process's step on all 4, two steps each, under the smooth loss of step
    # 7: cuDNN sums 2 rows otherwise than 4, and the L1 loss's sign flips
    # where the two paths' outputs straddle the label by that f32 noise
    # (2 / 1.6 M of a pixel's gradient each) are what it would compare
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()
    smooth_model = dataclasses.replace(model, loss=smooth)
    p1, pd = fresh(), fresh()
    step1 = make_train_step(smooth_model, SGD(p1, DP_SGD_LR), args, with_metrics=False)
    stepd = make_dp_train_step(smooth_model, SGD(pd, DP_SGD_LR), args, mesh,
                               with_metrics=False)

    def rel_dgrad(pa, pb):
        """The largest max |dgrad| / max |grad| over the parameters."""
        return max(float((pa[k].grad - pb[k].grad).abs().max())
                   / max(float(pa[k].grad.abs().max()), 1e-30) for k in pa)

    for it in range(2):
        loss1, _, _ = step1(p1, lr, hr)
        lossd, _, _ = stepd(pd, lr[mine], hr[mine])
        if it == 0:
            rel_smooth = rel_dgrad(p1, pd)
            g_dp = {k: v.grad.clone() for k, v in pd.items()}
    dloss = abs(float(loss1) - float(lossd))
    dparam = max(float((p1[k] - pd[k]).detach().abs().max()) for k in p1)
    if not (dloss <= 1e-6 and dparam <= 1e-6):
        raise AssertionError(f"rank {mesh.rank}: DP SGD steps vs one process: |dloss| "
                             f"{dloss:.3e}, max |dparam| {dparam:.3e} (limits 1e-6)")
    # what sets those differences is the batch split, not the DP step: its
    # averaged gradient equals the ranks' shares' gradients taken one by one
    # in this process, summed and divided as the all-reduce does, bit for bit
    halves = []
    for r in range(mesh.size):
        ph = fresh()
        make_train_step(smooth_model, SGD(ph, DP_SGD_LR), args, with_metrics=False)(
            ph, lr[r * per:(r + 1) * per], hr[r * per:(r + 1) * per])
        halves.append({k: v.grad for k, v in ph.items()})
    split_exact = all(torch.equal(g_dp[k], functools.reduce(torch.add, [h[k] for h in halves])
                                  / mesh.size) for k in g_dp)
    if not split_exact:
        raise AssertionError(f"rank {mesh.rank}: the DP gradient is not the mean of the shares' "
                             f"gradients taken in one process")
    del halves, g_dp
    # the same first step's gradients under the L1 loss, for the record
    p1, pd = fresh(), fresh()
    make_train_step(model, SGD(p1, DP_SGD_LR), args, with_metrics=False)(p1, lr, hr)
    make_dp_train_step(model, SGD(pd, DP_SGD_LR), args, mesh, with_metrics=False)(
        pd, lr[mine], hr[mine])
    rel_l1 = rel_dgrad(p1, pd)
    del p1, pd

    # under Adam: every rank's params bitwise equal after 2 steps; the
    # launches of one DP step counted
    pa = fresh()
    stepa = make_dp_train_step(model, make_optimizer(pa, args, steps_per_epoch=1000), args,
                               mesh)
    torch.cuda.synchronize()
    reset_launches()
    stepa(pa, lr[mine], hr[mine])
    torch.cuda.synchronize()
    step_counts = dict(LAUNCHES)
    stepa(pa, lr[mine], hr[mine])
    flat = torch.cat([pa[k].detach().reshape(-1) for k in sorted(pa)])
    if not same_on_every_rank(flat):
        raise AssertionError(f"rank {mesh.rank}: params differ between the ranks after two "
                             f"DP Adam steps")
    wrong = {k: v for k, v in step_counts.items() if v != (4 if k in PEROP_TRAIN else 0)}
    if wrong:
        raise AssertionError(f"rank {mesh.rank}: a DP step must launch 4 of each of "
                             f"{PEROP_TRAIN} and no other kernel, got {wrong}")
    del pa, stepa

    # (c) the scene's patch grid split over the ranks
    sr_args = dataclasses.replace(args, patch_size_for_test=32, stride_for_test=16,
                                  eval_batch=16)
    cache = ScenePipelineCache(forward, sr_args, eval_batch=16, mesh=mesh)
    lr_t = torch.from_numpy(lr_np).to(dev)
    cache(params, lr_t)                          # warm-up
    torch.cuda.synchronize()
    reset_launches()
    sr = cache(params, lr_t)
    torch.cuda.synchronize()
    sr_counts = dict(LAUNCHES)
    if not same_on_every_rank(sr):
        raise AssertionError(f"rank {mesh.rank}: the sharded SR mosaic differs between ranks")
    wrong = {k: v for k, v in sr_counts.items() if v != (16 if k in FORWARD else 0)}
    if wrong:
        raise AssertionError(f"rank {mesh.rank}: the sharded scene must launch 16 of each "
                             f"forward kernel a rank and no other, got {wrong}")
    return dict(dloss=dloss, dparam=dparam, rel_smooth=rel_smooth, rel_l1=rel_l1,
                step_counts=step_counts, sr_counts=sr_counts,
                sr=sr.cpu().numpy())


def dp_phase(params, scenes, cache, card: str, seed: int) -> None:
    """Step 21: data parallelism on the card (module docstring)."""
    import socket
    import time

    import torch
    import torch.distributed as dist
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.parallel.distributed import maybe_initialize, spawn_ranks
    from lft_torch.parallel.mesh import get_mesh, make_dp_train_step
    from lft_torch.profile_scene import device_ms, kernel_times
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    # (a) one rank through --coordinator / --num_devices 1, on nccl
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    args = dp_args(num_devices=1, coordinator=f"localhost:{port}", num_processes=1,
                   process_id=0)
    if not maybe_initialize(args):
        raise AssertionError("maybe_initialize did not start a process group")
    try:
        mesh = get_mesh(args.num_devices)
        backend = dist.get_backend()
        if backend != "nccl" or mesh.size != 1:
            raise AssertionError(f"world size 1 on the card: backend {backend}, {mesh.size} "
                                 f"ranks")
        dev = mesh.device
        model = get_model(args)
        gen = torch.Generator(device=dev).manual_seed(seed)
        batches = [synth_batch(gen, batch=4, ang_res=5, patch=32, scale=4) for _ in range(2)]

        def fresh():
            p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
            return p, make_optimizer(p, args, steps_per_epoch=1000)

        ps, opt_s = fresh()
        pd, opt_d = fresh()
        step_s = make_train_step(model, opt_s, args)
        step_d = make_dp_train_step(model, opt_d, args, mesh)
        torch.cuda.synchronize()
        outs_s = [step_s(ps, lr, hr) for lr, hr in batches]
        torch.cuda.synchronize()
        reset_launches()
        outs_d = [step_d(pd, lr, hr) for lr, hr in batches]
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        same = (all(torch.equal(a, b) for oa, ob in zip(outs_s, outs_d) for a, b in zip(oa, ob))
                and all(torch.equal(ps[k], pd[k]) for k in ps)
                and all(torch.equal(ps[k].grad, pd[k].grad) for k in ps))
        print(f"DP step at world size 1 ({backend}, through maybe_initialize): 2 Adam steps, "
              f"losses {[float(o[0]) for o in outs_d]}; loss, PSNR, SSIM, grads and params "
              f"bitwise equal to make_train_step's: {same}; launches {counts}", flush=True)
        if not same:
            raise AssertionError("the DP step at world size 1 differs from make_train_step")
        wrong = {k: v for k, v in counts.items() if v != (8 if k in PEROP_TRAIN else 0)}
        if wrong:
            raise AssertionError(f"the DP steps must launch 4 a step of each of {PEROP_TRAIN} "
                                 f"and no other kernel, got {wrong}")

        # (d) device ms a step, in turns: the flat buffer and its all-reduce
        lr, hr = batches[0]
        ms = {"make_train_step": [], "DP step": []}
        for who in ("make_train_step", "DP step", "DP step", "make_train_step"):
            fn = (lambda: step_s(ps, lr, hr)) if who == "make_train_step" else \
                (lambda: step_d(pd, lr, hr))
            ms[who].append(device_ms(fn, reps=10))
        ev = {"make_train_step": timed(lambda: step_s(ps, lr, hr), reps=5),
              "DP step": timed(lambda: step_d(pd, lr, hr), reps=5)}
        print(f"train step at world size 1, device ms in turns (a b b a, 10 steps each): "
              f"make_train_step {ms['make_train_step']}, DP step {ms['DP step']}; CUDA events, "
              f"median of 5: {ev['make_train_step']:.3f} / {ev['DP step']:.3f} ms; {card}",
              flush=True)
        # where the difference goes: device ms a step by kernel name, traced
        by_kernel = {}
        for who, fn in (("make_train_step", lambda: step_s(ps, lr, hr)),
                        ("DP step", lambda: step_d(pd, lr, hr))):
            by_kernel[who] = kernel_times(fn, reps=5)
        if not all(by_kernel.values()):
            print("DP step - make_train_step by kernel: not measured (the profiler saw no "
                  "device time in 3 traces of "
                  f"{[w for w, r in by_kernel.items() if not r]})", flush=True)
        else:
            names = set(by_kernel["make_train_step"]) | set(by_kernel["DP step"])
            diff = sorted(((by_kernel["DP step"].get(k, (0.0, 0))[0]
                            - by_kernel["make_train_step"].get(k, (0.0, 0))[0], k)
                           for k in names), key=lambda r: -abs(r[0]))
            print("DP step - make_train_step, device ms a step by kernel (traced, 5 steps "
                  "each; largest 6): " + "; ".join(
                      f"{d:+.4f} {k[:70]} (launches "
                      f"{by_kernel['make_train_step'].get(k, (0, 0))[1]} -> "
                      f"{by_kernel['DP step'].get(k, (0, 0))[1]})" for d, k in diff[:6]),
                  flush=True)
        del ps, pd, opt_s, opt_d, step_s, step_d, batches
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b), (c): two gloo ranks on the one card (NCCL refuses two ranks a card)
    lr_np, hr_np = scenes[0]
    t0 = time.time()
    r0 = spawn_ranks(dp_rank, 2, (lr_np, seed), device=dev, timeout=300)   # gloo
    print(f"2 gloo ranks on the card ({time.time() - t0:.1f} s with their start): SGD, 2 DP "
          f"steps of 2 + 2 patches against one process's of 4: |dloss| {r0['dloss']:.3e}, "
          f"max |dparam| {r0['dparam']:.3e} (limits 1e-6), step 1's max |dgrad| / max |grad| "
          f"{r0['rel_smooth']:.3e} (under the L1 loss {r0['rel_l1']:.3e}), the DP gradient "
          f"bitwise the mean of the 2 shares' gradients taken in one process; Adam: both ranks' "
          f"params bitwise equal; launches of one DP step on rank 0 "
          f"{ {k: v for k, v in r0['step_counts'].items() if v} }", flush=True)
    sr = torch.from_numpy(r0["sr"]).to(dev)
    ref = cache(params, torch.from_numpy(lr_np).to(dev))
    hr = torch.from_numpy(hr_np).to(dev)
    d = float((sr - ref).abs().max())
    dp = float(cal_metrics(hr, sr, 5)[0]) - float(cal_metrics(hr, ref, 5)[0])
    print(f"sharded SR of scene 0 over the 2 ranks vs step 4's: max |diff| {d!r} (limit 1e-3), "
          f"dPSNR {dp:+.3e} dB (limit 0.01); launches on rank 0 "
          f"{ {k: v for k, v in r0['sr_counts'].items() if v} }", flush=True)
    if not (d <= 1e-3 and abs(dp) <= 0.01):
        raise AssertionError("the sharded SR disagrees with step 4's")


def mixed_kernel_checks(params, card: str, launches: dict, n_steps: int, launches9: dict,
                        n_steps9: int, seed: int) -> list:
    """Step 22 a and d: each bf16-operand instance of `--dtype mixed`'s
    backward (the plan `none`: every product's operands rounded to bf16)
    against its plain version under that plan at the train step's shapes (K3
    [100, 32, 32, 64], K4 [4096, 25, 64] and [1024, 81, 64], `wgrad` at the
    step's 8 products), each output within MIXED_REL L2-relative and
    MIXED_GAP of the plain mixed-vs-f32 distance, and a bitwise repeat; the
    `kernels` rows, bound as one TF32 pass over the products (K4's attention
    and K3.c on the FP32 pipes); then each instance's device time beside its
    f32 instance's on the same inputs, in turns (f32, bf16, bf16, f32).
    `launches9`: the angRes-9 mixed steps' counts (K4's 128-row form)."""
    import torch
    from lft_torch.compare_wgrad import STEP_PRODUCTS
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import common
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels import wgrad as wg
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    plan = common.mm_site_plan(True, frozenset())      # LFT_MM_HP_BWD_SITES=none
    C, h, w, H, K = 64, 32, 32, 8, 5
    D = 2 * C
    V = 100
    T = V * h * w
    rec = Recorder(card, launches, n_steps, "mixed train step")
    rec9 = Recorder(card, launches9, n_steps9, "angRes-9 mixed train step")
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    with_sum = lambda ops: (*ops[:-1], ops[-1].sum(0))
    src_s, rep = "lft_torch/csrc/spa_block_bwd.cu", "lft_tpu/kernels/spa_block.py:602"
    turns = []

    def check(name, src, fn, args, flops, io, summed=False, recorder=rec, **kw):
        """One instance against its plain version (`fn(*args, plan=)` is the
        wrapper on CUDA tensors; `plain`: its plain version)."""
        plain = kw.pop("plain")
        got, ref, ref32 = fn(*args, plan=plan), plain(*args, plan=plan), plain(*args)
        again = fn(*args, plan=plan)
        if summed:
            got, again = with_sum(got), with_sum(again)
            ref, ref32 = ((*r[:-1], r[-1][0]) for r in (ref, ref32))
        recorder.record(name, src, kw.pop("replaces", rep), got, ref,
                        lambda: fn(*args, plan=plan), lambda: plain(*args, plan=plan), flops, io,
                        ref32=ref32, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  {name}: repeated bitwise: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} does not repeat bitwise")
        turns.append((name, lambda: fn(*args), lambda: fn(*args, plan=plan)))
        return ref

    # K3's five steps, each from the plain chain's inputs under the plan (the
    # forward is f32: the forward's plan is `all`)
    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    wbytes = lambda *k: sum(nbytes(ws[n]) for n in k)
    xs = rand(V, h, w, C)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                              ws["mlp"])[0].contiguous()
    _, tok, m, l, attn = sb.spa_block_plain(xs, pe_tok, ws, H, K, with_res=True)
    dout = rand(V, h, w, C)
    dout = calm_relu(dout, sb.ffn_out_bwd(attn, tok, dout, ws, plan=plan)[4],
                     sb.ffn_out_bwd_plain(attn, tok, dout, ws, plan=plan)[4],
                     "spa_ffn_out_bwd_bf16")
    ref = check("spa_ffn_out_bwd_bf16", src_s, sb.ffn_out_bwd, (attn, tok, dout, ws),
                T * (20 * D * D + 2 * C * D),
                nbytes(attn, tok, dout) + k3a_out_bytes(T, D) + wbytes("ln", "wo", "w1", "w2", "wlin"),
                summed=True, plain=sb.ffn_out_bwd_plain, bf16_products=True)
    dx2, dattn = ref[0], ref[1]
    xn, q, k, v = check("spa_ln_qkv_bf16", "lft_torch/csrc/spa_block.cu", sb.ln_qkv,
                        (tok, pe_tok, ws), 6 * T * D * D,
                        nbytes(tok, pe_tok) + 4 * T * D * 4 + wbytes("ln", "wqk", "wv"),
                        plain=sb.ln_qkv_plain, bf16_products=True)
    pairs = V * valid_window_pairs(h, w, K // 2)
    dq, dk, dv = check("spa_window_attn_bwd_bf16", "lft_torch/csrc/spa_attn_hp.cu",
                       sb.window_attn_bwd, (q, k, v, attn, dattn, m, l, H, K), 10 * D * pairs,
                       nbytes(q, k, v, dattn, m, l) + 3 * T * D * 4,
                       plain=sb.window_attn_bwd_plain, bf16_products=True)
    dtok = check("spa_qkv_ln_bwd_bf16", src_s, sb.qkv_ln_bwd, (tok, pe_tok, dq, dk, dv, dx2, ws),
                 6 * T * D * D, nbytes(tok, pe_tok, dq, dk, dv, dx2) + 2 * T * D * 4
                 + wbytes("ln", "wqk", "wv"), summed=True, plain=sb.qkv_ln_bwd_plain,
                 bf16_products=True)[0]
    check("spa_tokenize_bwd_bf16", src_s, sb.tokenize_bwd, (dtok, ws),
          2 * D * C * V * valid_window_pairs(h, w, 1), nbytes(dtok) + T * C * 4 + wbytes("wu"),
          plain=sb.tokenize_bwd_plain, bf16_products=True)
    del xs, pe_tok, tok, m, l, attn, dout, ref, dx2, dattn, xn, q, k, v, dq, dk, dv, dtok

    # K4, both forms, from the f32 forward's residuals (K1 res's plain version)
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    for N, A2, name in ((4096, 25, "ang_block_bwd_bf16"), (1024, 81, "ang_block_bwd128_bf16")):
        x = rand(N, A2, C)
        pe = torch.from_numpy(angular_position(A2, C)).to(dev)
        res = ab.ang_block_plain(x, pe, wa, H, with_res=True)[1:]
        dout = rand(N, A2, C)
        dout = calm_relu(dout, ab.ang_block_bwd_ops(x, pe, wa, *res, dout, H, plan=plan)[8],
                         ab.ang_block_bwd_ops_plain(x, pe, wa, *res, dout, H, plan=plan)[8],
                         f"{name} at A2 = {A2}")
        Tk = N * A2
        check(name, "lft_torch/csrc/ang_block.cu", ab.ang_block_bwd_ops,
              (x, pe, wa, *res, dout, H), 28 * Tk * C * C,
              nbytes(x, pe, *res, dout) + 11 * Tk * C * 4
              + 2 * sum(nbytes(t) for t in wa.values()),
              replaces="lft_tpu/kernels/ang_block.py:432" if A2 <= 64 else
              "lft_tpu/kernels/ang_block.py:477", summed=True, plain=ab.ang_block_bwd_ops_plain,
              bf16_products=True, fp32_flops=10 * C * N * A2 * A2,
              slow_reps=10 if A2 <= 64 else 3, recorder=rec if A2 <= 64 else rec9)
        del x, pe, res, dout

    # wgrad at the step's 8 products, beside the same function in PyTorch: the
    # two casts of the f32 inputs to bf16 and cuBLAS's bf16 product with an f32
    # output (`torch.mm(..., out_dtype=)`, where this torch has it), timed
    # together; the product alone on copies cast before is printed beside
    def lib_mm(xb, db):
        return torch.mm(xb.t(), db, out_dtype=torch.float32)
    try:
        lib_mm(torch.ones(8, 8, device=dev, dtype=torch.bfloat16),
               torch.ones(8, 8, device=dev, dtype=torch.bfloat16))
        has_lib = True
    except (TypeError, RuntimeError) as e:
        has_lib = False
        print(f"  torch.mm(..., out_dtype=float32) of bf16 operands is not available ({e}); "
              f"wgrad_bf16's library time is null", flush=True)
    Tw = 100 * 32 * 32
    for i, (what, Kw, Nw, image, per_step) in enumerate(STEP_PRODUCTS):
        x, dy = rand(Tw, Kw), rand(Tw, Nw)
        got, again = wg.wgrad(x, dy, image, half=True), wg.wgrad(x, dy, image, half=True)
        ref, ref32 = wg.wgrad_plain(x, dy, image, half=True), wg.wgrad_plain(x, dy, image)
        lib = None
        if has_lib and image is None:
            xb, db = x.bfloat16(), dy.bfloat16()
            lib = lambda x=x, dy=dy: lib_mm(x.bfloat16(), dy.bfloat16())
            print(f"  wgrad_bf16 {what}: cuBLAS's bf16 product alone, on copies cast before "
                  f"(device time) {device_ms(lambda xb=xb, db=db: lib_mm(xb, db)):.4f} ms",
                  flush=True)
            del xb, db
        pairs_w = Tw if image is None else 100 * valid_window_pairs(32, 32, 1)
        rec.record("wgrad_bf16", "lft_torch/csrc/wgrad.cu", "lft_tpu/kernels/spa_block.py:570",
                   got, ref, lambda x=x, dy=dy, im=image: wg.wgrad(x, dy, im, half=True),
                   lambda x=x, dy=dy, im=image: wg.wgrad_plain(x, dy, im, half=True),
                   2 * pairs_w * Kw * Nw, nbytes(x, dy, got), lib_fn=lib, ref32=ref32,
                   shape=None if i == 0 else (Tw, Kw, Nw) + (image or ()), device_time=True,
                   bf16_products=True)
        print(f"  wgrad_bf16 {what}: {per_step} a step; repeated bitwise: "
              f"{torch.equal(got, again)}", flush=True)
        if not torch.equal(got, again):
            raise AssertionError(f"wgrad_bf16 {what} does not repeat bitwise")
        if i in (0, 1):
            turns.append((f"wgrad_bf16 {what}", lambda x=x, dy=dy, im=image: wg.wgrad(x, dy, im),
                          lambda x=x, dy=dy, im=image: wg.wgrad(x, dy, im, half=True)))
        else:
            del x, dy
        del got, again, ref, ref32

    print(f"{card_line()}: device ms of each bf16-operand instance beside its f32 instance on "
          f"the same inputs, in turns f32, bf16, bf16, f32 (device_ms, 20 calls):", flush=True)
    for name, f32_fn, bf_fn in turns:
        t = [device_ms(f32_fn), device_ms(bf_fn), device_ms(bf_fn), device_ms(f32_fn)]
        print(f"  {name}: f32 {t[0]:.4f} / {t[3]:.4f} ms, bf16 {t[1]:.4f} / {t[2]:.4f} ms "
              f"(bf16 / f32 {(t[1] + t[2]) / (t[0] + t[3]):.3f})", flush=True)
    return rec.rows + rec9.rows


def mixed_train_phase(params, seed: int, steps: int = TRAIN_STEPS, ang_res: int = 5,
                      patch: int = 32, timing: bool = True):
    """Step 22 b and d: the fused train step of the 4x recipe under `--dtype
    mixed` through the kernels against the same step through the plain
    blocks under the plan (the loss within 1e-5, under a smooth loss the
    gradients as one vector within MIXED_REL L2-relative and MIXED_GAP of
    the plain mixed-vs-f32 distance, each parameter's nearer the plain
    mixed one than the f32 one by half their distance), its bitwise repeat,
    the launches (each bf16 K3/K4 instance 4 a step, K4 in the form of the
    view count, and `wgrad_bf16` 56; no f32 K3/K4 or `wgrad`, the forward's
    f32 K1 res and K2 res as before), and with `timing` the ms per step
    beside the f32 fused step's in turns (f32, mixed, mixed, f32). Returns
    the launch counts and their steps."""
    import dataclasses
    import functools

    import torch
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, MIXED, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    a32 = Args(angRes=ang_res, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
               gamma=0.5, epoch=50, train_fused="true")
    am = dataclasses.replace(a32, dtype="mixed")
    model = get_model(am)
    plain = dataclasses.replace(model, apply=functools.partial(forward, plain_blocks=True))
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    new_batch = lambda: synth_batch(gen, batch=4, ang_res=ang_res, patch=patch, scale=4)
    k4, other = (("ang_block_bwd128_bf16", "ang_block_bwd_bf16") if ang_res * ang_res > 64
                 else ("ang_block_bwd_bf16", "ang_block_bwd128_bf16"))
    what = f"mixed train ({ang_res}x{ang_res} views, patch {patch})"
    lr, hr = new_batch()

    def step(m, args, loss=None):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        fn = make_train_step(m if loss is None else dataclasses.replace(m, loss=loss),
                             make_optimizer(p, args, steps_per_epoch=1000), args)
        out = float(fn(p, lr, hr)[0])
        return out, {k: v.grad.detach().clone() for k, v in p.items()}, p, fn

    reset_launches()
    loss_p, _, _, _ = step(plain, am)
    _, g_p, _, _ = step(plain, am, smooth)
    _, g_f, _, _ = step(plain, a32, smooth)
    torch.cuda.synchronize()
    if any(LAUNCHES.values()):
        raise AssertionError(f"the plain mixed path launched kernels: {dict(LAUNCHES)}")
    reset_launches()
    loss_k, g_r, p_a, step_a = step(model, am)
    p_a1 = {k_: v.detach().clone() for k_, v in p_a.items()}
    loss_b, g_b, p_b, _ = step(model, am)
    _, g_k, _, _ = step(model, am, smooth)
    for _ in range(steps):
        step_a(p_a, *new_batch())
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    n = 3 + steps
    print(f"{what} step 1: loss kernels {loss_k:.8f} plain {loss_p:.8f} "
          f"(|d| {abs(loss_k - loss_p):.3e}, limit 1e-5 |loss|)", flush=True)
    if not abs(loss_k - loss_p) <= 1e-5 * abs(loss_p):
        raise AssertionError("mixed kernel-path loss disagrees with the plain path")
    cat = lambda gr: torch.cat([gr[k_].reshape(-1) for k_ in sorted(gr)])
    d, gap = l2_rel(cat(g_k), cat(g_p)), l2_rel(cat(g_f), cat(g_p))
    worst = max((l2_rel(g_k[k_], g_p[k_]) / max(l2_rel(g_f[k_], g_p[k_]), 1e-30), k_)
                for k_ in g_p if not torch.equal(g_f[k_], g_p[k_]))
    print(f"{what} step 1 (smooth loss): gradients L2-relative {d:.3e} from the plain mixed "
          f"path, mixed-vs-f32 {gap:.3e} ({d / gap:.4f} of it; limits {MIXED_REL:g} and "
          f"{MIXED_GAP:g}); per parameter at most {worst[0]:.4f} of its mixed-vs-f32 distance "
          f"({worst[1]}, limit 0.5)", flush=True)
    if not (d <= MIXED_REL and d <= MIXED_GAP * gap and worst[0] <= 0.5):
        raise AssertionError("the mixed kernel path's gradients disagree with the plain path")
    same = (loss_b == loss_k and all(torch.equal(g_r[k_], g_b[k_]) for k_ in g_r)
            and all(torch.equal(p_a1[k_], p_b[k_]) for k_ in p_b))
    print(f"{what} step repeated from the same state: loss, grads and params bitwise "
          f"equal: {same}", flush=True)
    if not same:
        raise AssertionError("a repeated mixed kernel-path step is not bitwise equal")
    print(f"launches in the {what} run ({n} kernel-path steps): "
          f"{ {k_: v for k_, v in counts.items() if v} }", flush=True)
    want = {k_: 4 * n for k_ in MIXED if k_ not in (other, "wgrad_bf16")}
    want.update(wgrad_bf16=56 * n, colsum=16 * n, ang_block_res=4 * n,
                spa_window_attn_res=4 * n, spa_tokenize_ln=4 * n, spa_qkv=4 * n,
                spa_outproj_ln=4 * n, spa_ffn_out=4 * n)
    wrong = {k_: counts[k_] for k_ in LAUNCHES if counts[k_] != want.get(k_, 0)}
    if wrong:
        raise AssertionError(f"{what} steps: expected {want} and no other launch (no f32 "
                             f"K3, K4 or wgrad), got {wrong}")
    if not timing:
        return counts, n

    fns = {}
    for what, args in (("f32", a32), ("mixed", am)):
        p = {k_: v.detach().clone().requires_grad_(True) for k_, v in params.items()}
        fns[what] = (p, make_train_step(model, make_optimizer(p, args, 1000), args))
    times = {"f32": [], "mixed": []}
    for what in ("f32", "mixed", "mixed", "f32"):
        p, fn = fns[what]
        fn(p, lr, hr)                                    # warm-up
        for _ in range(3):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            fn(p, lr, hr)
            ev1.record()
            ev1.synchronize()
            times[what].append(ev0.elapsed_time(ev1))
    med = {k_: sorted(v)[len(v) // 2] for k_, v in times.items()}
    print(f"{card_line()}: fused train step, batch 4 of 32x32-view patches, 5x5 views, 4x, C=64, "
          f"in turns f32, mixed, mixed, f32 (3 steps each): median {med['f32']:.3f} ms f32, "
          f"{med['mixed']:.3f} ms mixed (all f32 {[round(t, 3) for t in times['f32']]}, mixed "
          f"{[round(t, 3) for t in times['mixed']]})", flush=True)
    return counts, n


def mixed_scene_phase(params, args, scenes, cache, step4) -> None:
    """Step 22 c and e: the scenes of step 3 under `--dtype mixed` (the
    forward's plan is `all`: the f32 kernels) bitwise equal to step 4's, SR
    mosaics and PSNR/SSIM; then scene 0 under `--matmul_precision high` (TF32
    for the torch convolutions and matmuls around the kernels) against
    `highest`: its max |diff| and dPSNR are printed."""
    import dataclasses

    import torch
    from lft_torch.device import resolve_device
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import FORWARD, LAUNCHES, MIXED, MIXED_FWD, TRAINING, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.ops.metrics import cal_metrics

    dev = torch.device("cuda")
    am = dataclasses.replace(args, dtype="mixed")
    cache_m = ScenePipelineCache(forward, am, eval_batch=16)
    reset_launches()
    psnr, ssim, rows = evaluate_dataset(forward, params, am, scenes, cache=cache_m)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    same = all(torch.equal(cache_m(params, torch.from_numpy(lr_).to(dev)),
                           cache(params, torch.from_numpy(lr_).to(dev))) for lr_, _ in scenes)
    print(f"SR under --dtype mixed: PSNR {psnr:.6f} dB SSIM {ssim:.6f} (step 4: "
          f"{step4[0]:.6f} / {step4[1]:.6f}); SR mosaics bitwise equal to step 4's: {same}; "
          f"launches {counts}", flush=True)
    if not (same and psnr == step4[0] and ssim == step4[1] and rows == step4[2]):
        raise AssertionError("the mixed scenes are not the float32 scenes bit for bit")
    if any(counts[k_] == 0 for k_ in FORWARD) or any(counts[k_] for k_ in TRAINING + MIXED
                                                     + MIXED_FWD):
        raise AssertionError(f"the mixed SR run launched the wrong kernels: {counts}")
    lr0, hr0 = (torch.from_numpy(t).to(dev) for t in scenes[0])
    ref = cache(params, lr0)
    try:
        resolve_device(dev, "high")
        resolve_device(dev)         # a loader's call leaves the run's precision
        if not (torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32):
            raise AssertionError("resolve_device without a precision turned TF32 off")
        high = cache(params, lr0)
    finally:
        resolve_device(dev, "highest")
    p_ref = float(cal_metrics(hr0, ref, args.angRes)[0])
    p_high = float(cal_metrics(hr0, high, args.angRes)[0])
    print(f"scene 0 under --matmul_precision high (TF32 for the torch ops around the kernels) "
          f"against highest: max |SR diff| {float((high - ref).abs().max()):.3e}, dPSNR "
          f"{p_high - p_ref:+.3e} dB", flush=True)
    if not torch.isfinite(high).all():
        raise AssertionError("non-finite SR under --matmul_precision high")


def bf16_kernel_checks(params, card: str, launches: dict, n_scenes: int, seed: int) -> list:
    """Step 23 a: each `_bf16io` instance against its plain bf16 version at
    the main path's shapes, the demo checkpoint's weights cast to bf16 (the
    bf16 model's), each K2 step fed its plain predecessor's bf16 output; the
    plain f32 version on the same values is the yardstick (`bf16_err`)."""
    import torch
    import torch.nn.functional as F
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    N, V = 16 * h * w, 16 * A2
    T = V * h * w
    rec = Recorder(card, launches, n_scenes, "bf16 scene")
    pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
    f32 = lambda ts: tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)
    rows = lambda o: o if isinstance(o, tuple) else (o,)

    def check(name, fn, plain, args, args32, flops, io, lib=None, lib_what="", **kw):
        """`fn(*args)` (the wrapper) against `plain(*args)`; `plain(*args32)`
        is the f32 yardstick; `lib`: bf16 library calls timed beside."""
        got, ref, ref32 = fn(*args), plain(*args), plain(*args32)
        again = fn(*args)
        ms_k, _, ms_l = rec.record(name, "lft_torch/csrc/" + kw.pop("src", "spa_block.cu"),
                                   kw.pop("replaces", "lft_tpu/kernels/spa_block.py:352"),
                                   rows(got), rows(ref), lambda: fn(*args), lambda: plain(*args),
                                   flops, io, bf16_products=True, bf16_ref32=rows(ref32), **kw)
        same = all(torch.equal(a, b) for a, b in zip(rows(got), rows(again)))
        print(f"  {name}: repeated bitwise: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} does not repeat bitwise")
        if lib is not None:
            print(f"  {name}: {lib_what} (bf16, TF32 off) {timed(lib):.4f} ms, the kernel "
                  f"{ms_k:.4f} ms", flush=True)
        return ref

    # K1 at [16384, 25, 64], block 0's weights
    wa, wa32 = (ab.ang_weights(p, "altblock.0.ang_trans.") for p in (pb, params))
    wa32 = {k: v.to(torch.bfloat16).float() for k, v in wa32.items()}
    x = torch.randn(N, A2, C, device=dev, generator=g).to(torch.bfloat16)
    pe = torch.from_numpy(angular_position(A2, C)).to(dev)
    tok1 = x.reshape(-1, C)
    hid1 = torch.cat([tok1, tok1], 1)
    check("ang_block_bf16io", lambda *a: ab.ang_block(*a, H), lambda *a: ab.ang_block_plain(*a, H),
          (x, pe, wa), (x.float(), pe, wa32), 2 * N * A2 * 8 * C * C,
          nbytes(x, pe, x, *wa.values()),
          lib=lambda: [tok1 @ wa[n] for n in ("wq", "wk", "wv", "wo", "w1")] + [hid1 @ wa["w2"]],
          lib_what="its six cuBLAS products", src="ang_bf16.cuh",
          replaces="lft_tpu/kernels/ang_block.py:249", fp32_flops=4 * N * A2 * A2 * C)
    del x, tok1, hid1

    # K2's five steps at [400, 32, 32, 64], block 0's weights
    ws, ws32 = (sb.spa_weights(p, "altblock.0.spa_trans.") for p in (pb, params))
    ws32 = {k: v.to(torch.bfloat16).float() for k, v in ws32.items()}
    wbytes = lambda *k: sum(nbytes(ws[n]) for n in k)
    xs = torch.randn(V, h, w, C, device=dev, generator=g).to(torch.bfloat16)
    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev).to(torch.bfloat16)
    pe_tok = unfold3x3_linear(spa_pe[None], ws["mlp"])[0].contiguous()
    tok, xn = check("spa_tokenize_ln_bf16io", sb.tokenize_ln, sb.tokenize_ln_plain,
                    (xs, pe_tok, ws), (*f32((xs, pe_tok)), ws32),
                    2 * C * D * V * valid_window_pairs(h, w, 1),
                    nbytes(xs, pe_tok, xs, xs, xs, xs) + wbytes("wu", "ln"),
                    lib=lambda: F.conv2d(xs.permute(0, 3, 1, 2), ws["mlp"].reshape(D, C, 3, 3),
                                         padding=1),
                    lib_what="its conv part only, cuDNN's F.conv2d", src="tok_bf16.cuh")
    q, k, v = check("spa_qkv_bf16io", sb.qkv, sb.qkv_plain, (xn, tok, ws),
                    (*f32((xn, tok)), ws32), 2 * T * D * 3 * D,
                    nbytes(xn, tok, xn, tok, xn) + wbytes("wqk", "wv"),
                    lib=lambda: (xn @ ws["wqk"], tok @ ws["wv"]),
                    lib_what="its two cuBLAS products")
    mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
    heads = lambda t: t.reshape(V, h * w, H, D // H).transpose(1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)
    pairs = V * valid_window_pairs(h, w, K // 2)
    attn = check("spa_window_attn_bf16io", lambda *a: sb.window_attn(*a, H, K),
                 lambda *a: sb.window_attn_plain(*a, H, K)[0], (q, k, v), f32((q, k, v)),
                 4 * D * pairs, nbytes(q, k, v, q), src="window_mma.cuh",
                 lib_fn=lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    del qh, kh, vh
    window_width_checks(g)
    ang_bf16_width_checks(g)
    ffn_bf16io_width_checks(g)
    tok_bf16_width_checks(g)
    x2, xn2 = check("spa_outproj_ln_bf16io", sb.outproj_ln, sb.outproj_ln_plain,
                    (attn, tok, ws), (*f32((attn, tok)), ws32), 2 * T * D * D,
                    nbytes(attn, tok, attn, tok) + wbytes("wo", "ln"),
                    lib=lambda: torch.addmm(tok.reshape(-1, D), attn.reshape(-1, D), ws["wo"]),
                    lib_what="its cuBLAS product with the residual (addmm, no LN2)")
    hid = torch.empty(T, 2 * D, device=dev, dtype=torch.bfloat16)
    check("spa_ffn_out_bf16io", sb.ffn_out, sb.ffn_out_plain, (xn2, x2, ws),
          (*f32((xn2, x2)), ws32), 2 * T * (4 * D * D + D * C),
          nbytes(xn2, x2) + T * C * 2 + wbytes("w1", "w2", "wlin"),
          lib=lambda: (torch.mm(xn2.reshape(-1, D), ws["w1"], out=hid),
                       hid @ ws["w2"], x2.reshape(-1, D) @ ws["wlin"]),
          lib_what="its three cuBLAS products", src="ffn_bf16.cuh")
    return rec.rows


def window_width_checks(g) -> None:
    """Step 23 a: the bf16-IO window kernel (csrc/window_mma.cuh) at the
    head widths the main path does not give it, DH = 4 and 8 (D = 32, 64),
    and at DH = 16 on ragged views: `spa_window_attn_bf16io` and its `_res`
    form and K5's `spa_attn_hp_bf16io` against the plain bf16 version
    (`bf16_err`: BF16_GAP of the plain bf16-vs-f32 distance, BF16_ULPS), m
    and l within 1e-5 / 1e-4, a bitwise repeat, the `_res` form's and K5's
    attn bit for bit the forward's. Not timed (the main shapes are)."""
    import torch
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels import spa_block as sb

    H, K = 8, 5
    for shape in ((40, 32, 32, 32), (40, 32, 32, 64), (7, 17, 23, 32), (7, 17, 23, 64),
                  (5, 9, 30, 128)):
        q, k, v = (torch.randn(*shape, device="cuda", generator=g) * sc for sc in (1.5, 1.5, 1))
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = sb.window_attn(q, k, v, H, K)
        res = sb.window_attn(q, k, v, H, K, with_stats=True)
        ref = sb.window_attn_plain(q, k, v, H, K)
        ref32 = sb.window_attn_plain(q.float(), k.float(), v.float(), H, K)[0]
        _, ok = bf16_err(got, ref[0], ref32)
        stat = max(float(((a - b).abs() / (b.abs() + 0.1)).max()) for a, b in zip(res[1:], ref[1:]))
        same = (torch.equal(got, sb.window_attn(q, k, v, H, K)) and torch.equal(res[0], got)
                and torch.equal(hp.spa_attn_hp_fwd(q, k, v, H, K), got)
                and all(torch.equal(a, b) for a, b in zip(hp.spa_attn_hp_fwd(q, k, v, H, K, True),
                                                          res)))
        print(f"  the bf16-IO window kernel at {list(shape)} (DH = {shape[3] // H}): within "
              f"limits {ok}; m, l max relative {stat:.2e} (limit 1e-4, 1e-5 absolute near 0); "
              f"repeated, `_res` and K5 bit for bit: {same}", flush=True)
        if not (ok and stat <= 1e-4 and same):
            raise AssertionError(f"the bf16-IO window kernel at {list(shape)} disagrees")


def ang_bf16_width_checks(g, plan=None) -> None:
    """Step 23 a (bf16 IO) and step 27 (`plan`: LFT_MM_HP_SITES=none, f32
    IO): K1's all-bf16 kernel (csrc/ang_bf16.cuh) at the widths the main
    path does not give it, C = 16 and 32, and at the main path's C = 64 at
    the view counts it does not give it, at pixels of 25, 81 and 121 views,
    random weights, on 256 pixels of 25 views (the last tile partly filled)
    and 64 of 81 or 121 (a tile one pixel, its last rows empty): the forward
    and its `_res` form against the plain version (bf16 IO: `bf16_err`,
    `bf16t_err` for the `_res` outputs; f32 IO: `mixed_err` for out and
    attn, m and l within L2 1e-3), a bitwise repeat, the `_res` form's out
    bit for bit the forward's. Enough pixels that one q, k or v value
    rounding the other way in one version, which moves the bf16 roundings
    of many of its pixel's outputs, does not decide the share. In bf16 IO
    at C = 64, where on these weights the plain version's own out lies
    0.06-0.13 of its bf16-vs-f32 distance from float64 at its rounding
    points (`probe_variants --accuracy` on an H100), so that no version
    summing in another order, exact arithmetic included, keeps within
    BF16_GAP of it, out is held to float64 instead (`f64_err`). Not timed
    (the main shapes are)."""
    import torch
    from lft_torch.kernels import ang_block as ab
    from lft_torch.ops.posenc import angular_position

    H = 8
    l2 = lambda a, b: float((a - b).double().norm() / b.double().norm())
    for C, A2, N in ((16, 25, 256), (32, 25, 256), (16, 81, 64), (32, 81, 64), (64, 81, 64),
                     (16, 121, 64), (32, 121, 64), (64, 121, 64)):
        rnd = lambda *s_: torch.randn(*s_, device="cuda", generator=g)
        wts = {n: rnd(*s_) / s_[0] ** 0.5 for n, s_ in (
            ("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)), ("w1", (C, 2 * C)),
            ("w2", (2 * C, C)))}
        wts["ln"] = torch.stack([1 + 0.2 * rnd(C), 0.2 * rnd(C), 1 + 0.2 * rnd(C), 0.2 * rnd(C)])
        x = rnd(N, A2, C)
        pe = torch.from_numpy(angular_position(A2, C)).to("cuda")
        if plan is None:
            wts = {n: t.to(torch.bfloat16) for n, t in wts.items()}
            w32 = {n: t.float() for n, t in wts.items()}
            x = x.to(torch.bfloat16)
            what = "ang_block_bf16io and ang_block_res_bf16io"
            got, res = ab.ang_block(x, pe, wts, H), ab.ang_block(x, pe, wts, H, with_res=True)
            ref, ref32 = (ab.ang_block_plain(x_, pe, w_, H, with_res=True)
                          for x_, w_ in ((x, wts), (x.float(), w32)))
            if C == 64:
                ok = f64_err(got, ref[0], ref32[0], ab.ang_block_bf16io_f64(x, pe, w32, H))
                _, ok_r = bf16t_err(res[1:], ref[1:], ref32[1:])
            else:
                _, ok = bf16_err(got, ref[0], ref32[0])
                _, ok_r = bf16t_err(res, ref, ref32)
            ok = ok and ok_r
        else:
            what = "ang_block_bf16 and ang_block_res_bf16"
            got = ab.ang_block(x, pe, wts, H, plan=plan)
            res = ab.ang_block(x, pe, wts, H, with_res=True, plan=plan)
            ref = ab.ang_block_plain(x, pe, wts, H, with_res=True, plan=plan)
            ref32 = ab.ang_block_plain(x, pe, wts, H, with_res=True)
            _, ok = mixed_err((got, res[3]), (ref[0], ref[3]), (ref32[0], ref32[3]))
            ok = ok and l2(res[1], ref[1]) <= 1e-3 and l2(res[2], ref[2]) <= 1e-3
        again = ab.ang_block(x, pe, wts, H, with_res=True, plan=plan)
        same = (torch.equal(got, ab.ang_block(x, pe, wts, H, plan=plan))
                and all(torch.equal(a, b) for a, b in zip(res, again))
                and torch.equal(res[0], got))
        print(f"  {what} at [{N}, {A2}, {C}]: within limits {ok}; repeated, `_res` out bit "
              f"for bit the forward's: {same}", flush=True)
        if not (ok and same):
            raise AssertionError(f"{what} at [{N}, {A2}, {C}] disagrees")


def ffn_bf16io_width_checks(g) -> None:
    """Step 23 a: K2.5's and K11.5's bf16-IO instances (csrc/ffn_bf16.cuh's
    kernel on bf16 rows) at the widths the main path does not give them, C
    = 16 and 32 (random weights), on ragged rows: against the plain bf16
    version (`bf16_err`), a bitwise repeat, K11.5's output the view-major
    one's pixel-major bit for bit. Not timed (the main shapes are)."""
    import torch
    from lft_torch.kernels import spa_block as sb

    for C in (16, 32):
        D = 2 * C
        wts = {n: (torch.randn(*s_, device="cuda", generator=g) / s_[0] ** 0.5).to(torch.bfloat16)
               for n, s_ in (("w1", (D, 2 * D)), ("w2", (2 * D, D)), ("wlin", (D, C)))}
        w32 = {n: t.float() for n, t in wts.items()}
        xn2, x2 = (torch.randn(50, 17, 23, D, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(2))
        got = sb.ffn_out(xn2, x2, wts)
        _, ok = bf16_err(got, sb.ffn_out_plain(xn2, x2, wts),
                         sb.ffn_out_plain(xn2.float(), x2.float(), w32))
        same = (torch.equal(got, sb.ffn_out(xn2, x2, wts)) and
                torch.equal(sb.ffn_out(xn2, x2, wts, 25), sb._to_pixel_major(got, 25)))
        print(f"  spa_ffn_out_bf16io at [50, 17, 23, {C}]: within limits {ok}; repeated and "
              f"K11.5 bit for bit: {same}", flush=True)
        if not (ok and same):
            raise AssertionError(f"spa_ffn_out_bf16io at C = {C} disagrees")


def f64_mixed_err(got, ref, ref32, exact) -> bool:
    """An f32-IO output of a `_sites` instance at C = 64
    (`ang_sites_width_checks`), where on random weights the plain version's
    own f32 error is a share of its mixed-vs-f32 distance: whether it lies
    no further from `exact` (its function in float64, rounded to bf16 where
    the plain version rounds) than the plain version does, plus MIXED_GAP
    of that distance, and within MIXED_REL L2 of the plain version. Prints
    the distances and the shares."""
    import torch
    if got.shape != ref.shape or got.dtype != torch.float32 or not torch.isfinite(got).all():
        raise AssertionError(f"bad kernel output: {got.dtype} {tuple(got.shape)}")
    gap, d, d_ref, d_plain = l2_rel(ref32, ref), l2_rel(got, exact), l2_rel(ref, exact), \
        l2_rel(got, ref)
    print(f"  {tuple(got.shape)}: from float64 at the plain version's rounding points "
          f"{d / gap:.4f} of the mixed-vs-f32 distance, the plain version {d_ref / gap:.4f} "
          f"(limit it + {MIXED_GAP}); from the plain version {d_plain / gap:.4f}, L2 "
          f"{d_plain:.3e} (limit {MIXED_REL:g})", flush=True)
    return d <= d_ref + MIXED_GAP * gap and d_plain <= MIXED_REL


# Step 29's third K1 mask beside S1 and S2: `aqkv` and `awo` round, the
# attention's scores and e v both f32 (S1: bf16 scores, f32 e v; S2 the
# reverse), the FFN f32.
SITES_M3 = "tok,qk,v,score,av,wo,ffn,lin,ascore,aav,affn"


def ang_sites_width_checks(g) -> None:
    """Step 29 d: K1's `_sites` kernel (csrc/ang_sites.cuh) under S1, S2 and
    M3 at every width, C = 16, 32 and 64, at 25, 81 and 121 views (256
    pixels of 25, 64 of 81 or 121: a tile one pixel, its last rows empty;
    enough that one q, k or v value rounding the other way does not decide
    a share), random weights: `ang_block_sites` and `ang_block_res_sites`
    against the plain version under the subset, out and attn no further
    from float64 at the plain version's rounding points than the plain
    version plus MIXED_GAP of its mixed-vs-f32 distance (`f64_mixed_err`:
    the f32 sites' 3xTF32 accuracy and the rounded sites' roundings) and,
    below C = 64, within `mixed_err`'s limits (at C = 64 the plain version's
    own f32 error is a share of that distance: `ang_bf16_width_checks`); m
    and l within L2 MIXED_REL; attn bf16 values exactly where `awo` rounds;
    a bitwise repeat; the `_res` form's out bit for bit the forward's. Not
    timed (the main shapes are)."""
    import torch
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import common
    from lft_torch.ops.posenc import angular_position

    H = 8
    for spec, what in ((SITES_S1, "S1"), (SITES_S2, "S2"), (SITES_M3, "M3")):
        plan = common.mm_site_plan(True, frozenset(spec.split(",")))
        for C, A2, N in ((16, 25, 256), (32, 25, 256), (64, 25, 256), (16, 81, 64),
                         (32, 81, 64), (64, 81, 64), (16, 121, 64), (32, 121, 64),
                         (64, 121, 64)):
            rnd = lambda *s_: torch.randn(*s_, device="cuda", generator=g)
            wts = {n: rnd(*s_) / s_[0] ** 0.5 for n, s_ in (
                ("wq", (C, C)), ("wk", (C, C)), ("wv", (C, C)), ("wo", (C, C)),
                ("w1", (C, 2 * C)), ("w2", (2 * C, C)))}
            wts["ln"] = torch.stack([1 + 0.2 * rnd(C), 0.2 * rnd(C), 1 + 0.2 * rnd(C),
                                     0.2 * rnd(C)])
            x = rnd(N, A2, C)
            pe = torch.from_numpy(angular_position(A2, C)).to("cuda")
            got = ab.ang_block(x, pe, wts, H, plan=plan)
            res = ab.ang_block(x, pe, wts, H, with_res=True, plan=plan)
            ref = ab.ang_block_plain(x, pe, wts, H, with_res=True, plan=plan)
            ref32 = ab.ang_block_plain(x, pe, wts, H, with_res=True)
            exact = ab.ang_block_plain(x.double(), pe.double(),
                                       {k: v.double() for k, v in wts.items()}, H,
                                       with_res=True, plan=plan)
            ok = all(f64_mixed_err(res[i], ref[i], ref32[i], exact[i]) for i in (0, 3))
            if C < 64:
                ok = mixed_err((res[0], res[3]), (ref[0], ref[3]), (ref32[0], ref32[3]))[1] \
                    and ok
            ok = ok and l2_rel(res[1], ref[1]) <= MIXED_REL and l2_rel(res[2], ref[2]) <= \
                MIXED_REL and torch.equal(res[3], common.bf16_round(res[3])) == plan["awo"]
            again = ab.ang_block(x, pe, wts, H, with_res=True, plan=plan)
            same = (torch.equal(got, ab.ang_block(x, pe, wts, H, plan=plan))
                    and all(torch.equal(a, b) for a, b in zip(res, again))
                    and torch.equal(res[0], got))
            print(f"  ang_block_sites and ang_block_res_sites under {what} at [{N}, {A2}, {C}]: "
                  f"within limits {ok}; repeated, `_res` out bit for bit the forward's: {same}",
                  flush=True)
            if not (ok and same):
                raise AssertionError(f"ang_block_sites under {what} at [{N}, {A2}, {C}] "
                                     f"disagrees")


def tok_bf16_width_checks(g, plan=None) -> None:
    """Step 23 a (bf16 IO) and step 27 (`plan`: LFT_MM_HP_SITES=none, f32
    IO): K2.1's and K11.1's bf16 forms (csrc/tok_bf16.cuh) at every width,
    C = 16, 32 and 64, and at 32 x 32, 30 x 30 and 64 x 64 views (tiles of
    `spa_block.tok_bf16_tile`, partly outside a 30 x 30 view), random
    weights: the view-major form against the plain version (bf16 IO
    `bf16_err`, f32 IO `mixed_err`), the pixel-major form bit for bit the
    view-major one on the permuted copy, a bitwise repeat. Not timed (the
    main shapes are)."""
    import torch
    from lft_torch.kernels import spa_block as sb

    for C in (16, 32, 64):
        D = 2 * C
        for V, h, w, A2 in ((6, 32, 32, 3), (4, 30, 30, 2), (2, 64, 64, 2)):
            rnd = lambda *s_: torch.randn(*s_, device="cuda", generator=g)
            wts = sb._with_mlp({"wu": rnd(9, C, D) / (3 * C ** 0.5),
                                "ln": torch.stack([1 + 0.2 * rnd(D), 0.2 * rnd(D)])})
            x, pe = rnd(V, h, w, C), rnd(h, w, D)
            if plan is None:
                wts, x, pe = {k: v.bfloat16() for k, v in wts.items()}, x.bfloat16(), pe.bfloat16()
                what = "spa_tokenize_ln_bf16io and spa_tokenize_ln_pm_bf16io"
                got = sb.tokenize_ln(x, pe, wts)
                _, ok = bf16_err(got, sb.tokenize_ln_plain(x, pe, wts),
                                 sb.tokenize_ln_plain(x.float(), pe.float(),
                                                      {k: v.float() for k, v in wts.items()}))
            else:
                what = "spa_tokenize_ln_bf16 and spa_tokenize_ln_pm_bf16"
                got = sb.tokenize_ln(x, pe, wts, plan=plan)
                _, ok = mixed_err(got, sb.tokenize_ln_plain(x, pe, wts, plan),
                                  sb.tokenize_ln_plain(x, pe, wts))
            pm = x.reshape(V // A2, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
            same = (all(torch.equal(a, b) for a, b in zip(got, sb.tokenize_ln(x, pe, wts,
                                                                                plan=plan)))
                    and all(torch.equal(a, b) for a, b in zip(got, sb.tokenize_ln(
                        pm, pe, wts, pixel_major=True, plan=plan))))
            print(f"  {what} at [{V}, {h}, {w}, {C}]: within limits {ok}; repeated and the "
                  f"pixel-major form bit for bit: {same}", flush=True)
            if not (ok and same):
                raise AssertionError(f"{what} at [{V}, {h}, {w}, {C}] disagrees")


def ffn_sites_width_checks(plan, what: str, g) -> None:
    """Step 29 d: K2.5's and K11.5's `_sites` kernels (csrc/ffn_sites.cuh)
    at the widths the main path does not give them, C = 16 and 32 (random
    weights), on ragged rows: against the plain version under the subset
    (`mixed_err`), a bitwise repeat, K11.5's output the view-major one's
    pixel-major bit for bit. Not timed (the main shapes are)."""
    import torch
    from lft_torch.kernels import spa_block as sb

    for C in (16, 32):
        D = 2 * C
        wts = {n: torch.randn(*s_, device="cuda", generator=g) / s_[0] ** 0.5
               for n, s_ in (("w1", (D, 2 * D)), ("w2", (2 * D, D)), ("wlin", (D, C)))}
        xn2, x2 = (torch.randn(50, 17, 23, D, device="cuda", generator=g) for _ in range(2))
        got = sb.ffn_out(xn2, x2, wts, plan=plan)
        _, ok = mixed_err(got, sb.ffn_out_plain(xn2, x2, wts, plan), sb.ffn_out_plain(xn2, x2, wts))
        same = (torch.equal(got, sb.ffn_out(xn2, x2, wts, plan=plan)) and
                torch.equal(sb.ffn_out(xn2, x2, wts, 25, plan=plan), sb._to_pixel_major(got, 25)))
        print(f"  spa_ffn_out_sites under {what} at [50, 17, 23, {C}]: within limits {ok}; "
              f"repeated and K11.5 bit for bit: {same}", flush=True)
        if not (ok and same):
            raise AssertionError(f"spa_ffn_out_sites under {what} at C = {C} disagrees")


def bf16_scene_phase(params, args, scenes, cache, card: str) -> dict:
    """Step 23 b: step 3's scenes under `--dtype bfloat16` (module
    docstring). Returns the SR run's launch counts."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from lft_torch import test as test_cli
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import BF16IO, LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.profile_scene import device_ms, kernel_times
    from lft_torch.utils.logging import Logger, create_dir

    dev = torch.device("cuda")
    n = len(scenes)
    ab_ = dataclasses.replace(args, dtype="bfloat16")
    cache_b = ScenePipelineCache(forward, ab_, eval_batch=16)
    torch.cuda.synchronize()
    reset_launches()
    psnr, ssim, rows = evaluate_dataset(forward, params, ab_, scenes, cache=cache_b)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    print(f"SR under --dtype bfloat16: PSNR {psnr:.6f} dB SSIM {ssim:.6f}; per scene {rows}; "
          f"launches {counts}", flush=True)
    wrong = {k_: c for k_, c in counts.items() if c != (16 * n if k_ in BF16IO else 0)}
    if wrong:
        raise AssertionError(f"the bf16 SR run: expected {16 * n} launches of each bf16-IO "
                             f"kernel and no other, got {wrong}")
    plain = ScenePipelineCache(forward, ab_, eval_batch=16, plain_blocks=True)
    for i, (lr, hr) in enumerate(scenes):
        lr_t, hr_t = torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)
        sr_k, sr_p, sr_f = cache_b(params, lr_t), plain(params, lr_t), cache(params, lr_t)
        if sr_k.dtype != torch.float32 or sr_k.shape != sr_f.shape \
                or not torch.isfinite(sr_k).all():
            raise AssertionError(f"bad bf16 SR mosaic {sr_k.dtype} {tuple(sr_k.shape)}")
        gap_k, gap_p, d = l2_rel(sr_k, sr_f), l2_rel(sr_p, sr_f), l2_rel(sr_k, sr_p)
        p_k, p_p, p_f = (float(cal_metrics(hr_t, t, args.angRes)[0]) for t in (sr_k, sr_p, sr_f))
        print(f"scene {i} under bfloat16: kernels vs the plain blocks dPSNR {p_k - p_p:+.3e} dB "
              f"(limit 0.01), L2 {d:.3e}; distance from the f32 scene: kernels {gap_k:.3e}, "
              f"plain blocks {gap_p:.3e} ({gap_k / gap_p:.4f}, limit 1 +- {BF16_SCENE_TOL:g}; "
              f"L2 {d / gap_p:.4f} of it, limit {BF16_SCENE_L2:g}); dPSNR against f32 "
              f"{p_k - p_f:+.4f} dB (lft_tpu's bf16 mode: -0.20 dB, lft_tpu/models/lft.py:268-270)",
              flush=True)
        if abs(p_k - p_p) > 0.01 or abs(gap_k / gap_p - 1) > BF16_SCENE_TOL \
                or d > BF16_SCENE_L2 * gap_p:
            raise AssertionError(f"scene {i}: the bf16 kernels disagree with the plain blocks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        t_args = dataclasses.replace(ab_, path_pre_pth=CKPT, data_name="Synth",
                                     path_log=os.path.join(tmp, "test"))
        _, _, log_dir = create_dir(t_args)
        p_sets, s_sets = test_cli.evaluate_sets(t_args, ["Synth"], [MemTestSet(scenes)],
                                                Logger(log_dir, t_args))
    print(f"test CLI under --dtype bfloat16: PSNR {p_sets[0]!r} SSIM {s_sets[0]!r} (the SR "
          f"run: {psnr!r} {ssim!r})", flush=True)
    if (p_sets, s_sets) != ([psnr], [ssim]):
        raise AssertionError("the bf16 test CLI's PSNR/SSIM differ from the bf16 SR run's")
    lr0 = torch.from_numpy(scenes[0][0]).to(dev)
    f32_fn, bf_fn = (lambda: cache(params, lr0)), (lambda: cache_b(params, lr0))
    t = [device_ms(f32_fn, 3), device_ms(bf_fn, 3), device_ms(bf_fn, 3), device_ms(f32_fn, 3)]
    print(f"{card_line()}: device ms a scene, in turns f32 / bf16 / bf16 / f32: "
          + " / ".join(f"{x:.2f}" for x in t) + f" (bf16 / f32 {(t[1] + t[2]) / (t[0] + t[3]):.3f})",
          flush=True)
    by = sorted(kernel_times(bf_fn, 3).items(), key=lambda kv: -kv[1][0])
    print("bf16 scene, device ms a scene by kernel: " + "; ".join(
        f"{k_[:60]} {ms:.2f} ({c:g})" for k_, (ms, c) in by[:14]), flush=True)
    return counts


def bf16_train_phase(params, seed: int, steps: int = TRAIN_STEPS, ang_res: int = 5,
                     patch: int = 32):
    """Step 24 a and b: the fused train step of the 4x recipe under `--dtype
    bfloat16` (`--train_fused auto`) through the kernels against the same
    step through the plain blocks (module docstring), its bitwise repeat
    and its launches. Returns (the launch counts, their steps, the
    kernel step's (params, step fn, batch) for the timing of d)."""
    import dataclasses
    import functools

    import torch
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import BF16IO, BF16TRAIN, LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    ab_ = Args(angRes=ang_res, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
               gamma=0.5, epoch=50, dtype="bfloat16")
    a32 = dataclasses.replace(ab_, dtype="float32", train_fused="true")
    model = get_model(ab_)
    plain = dataclasses.replace(model, apply=functools.partial(forward, plain_blocks=True))
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    new_batch = lambda: synth_batch(gen, batch=4, ang_res=ang_res, patch=patch, scale=4)
    k4, other = (("ang_block_bwd128_bf16io", "ang_block_bwd_bf16io") if ang_res ** 2 > 64
                 else ("ang_block_bwd_bf16io", "ang_block_bwd128_bf16io"))
    what = f"bf16 train ({ang_res}x{ang_res} views, patch {patch})"
    lr, hr = new_batch()

    def step(m, args, loss=None):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        fn = make_train_step(m if loss is None else dataclasses.replace(m, loss=loss),
                             make_optimizer(p, args, steps_per_epoch=1000), args)
        out = float(fn(p, lr, hr)[0])
        return out, torch.cat([p[k].grad.reshape(-1) for k in sorted(p)]), p, fn

    reset_launches()
    loss_p, _, _, _ = step(plain, ab_)
    _, g_p, _, _ = step(plain, ab_, smooth)
    _, g_f, _, _ = step(plain, a32, smooth)
    torch.cuda.synchronize()
    if any(LAUNCHES.values()):
        raise AssertionError(f"the plain bf16 path launched kernels: {dict(LAUNCHES)}")
    reset_launches()
    loss_k, g_r, p_a, step_a = step(model, ab_)
    p_a1 = {k_: v.detach().clone() for k_, v in p_a.items()}
    loss_b, g_b, p_b, _ = step(model, ab_)
    _, g_k, _, _ = step(model, ab_, smooth)
    for _ in range(steps):
        step_a(p_a, *new_batch())
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    n = 3 + steps
    print(f"{what} step 1: loss kernels {loss_k:.8f} plain {loss_p:.8f} "
          f"(|d| {abs(loss_k - loss_p):.3e}, limit {BF16T_LOSS:g} |loss|)", flush=True)
    if not abs(loss_k - loss_p) <= BF16T_LOSS * abs(loss_p):
        raise AssertionError("bf16 kernel-path loss disagrees with the plain path")
    gap, own, d = l2_rel(g_p, g_f), l2_rel(g_k, g_f), l2_rel(g_k, g_p)
    print(f"{what} step 1 (smooth loss): the gradient's distance from the f32 step's "
          f"{own:.4e}, the plain blocks' {gap:.4e} ({own / gap:.4f}, limit 1 +- {BF16T_TOL:g}); "
          f"L2 from the plain step's gradient {d:.4e} ({d / gap:.4f} of its distance, limit "
          f"{BF16T_L2:g})", flush=True)
    if not (abs(own / gap - 1) <= BF16T_TOL and d <= BF16T_L2 * gap):
        raise AssertionError("the bf16 kernel path's gradient disagrees with the plain path")
    if not all(v.dtype == torch.float32 for v in p_a.values()):
        raise AssertionError("bf16 training: the master parameters left f32")
    same = (loss_b == loss_k and torch.equal(g_r, g_b)
            and all(torch.equal(p_a1[k_], p_b[k_]) for k_ in p_b))
    print(f"{what} step repeated from the same state: loss, grads and params bitwise "
          f"equal: {same}", flush=True)
    if not same:
        raise AssertionError("a repeated bf16 kernel-path step is not bitwise equal")
    print(f"launches in the {what} run ({n} kernel-path steps): "
          f"{ {k_: v for k_, v in counts.items() if v} }", flush=True)
    want = {k_: 4 * n for k_ in BF16TRAIN if k_ not in (other, "wgrad_bf16io")}
    want.update({k_: 4 * n for k_ in BF16IO if k_ not in ("ang_block_bf16io",
                                                          "spa_window_attn_bf16io")})
    want.update(wgrad_bf16io=56 * n, colsum=16 * n)
    wrong = {k_: counts[k_] for k_ in LAUNCHES if counts[k_] != want.get(k_, 0)}
    if wrong:
        raise AssertionError(f"{what} steps: expected {want} and no other launch (no f32 or "
                             f"_bf16 form), got {wrong}")
    return counts, n, (p_a, step_a, lr, hr)


def bf16_step_times(params, kernel_step, seed: int) -> None:
    """Step 24 d: the fused train step's ms under float32, mixed and
    bfloat16, in turns (f32, mixed, bf16, bf16, mixed, f32), 3 steps each
    after a warm-up, CUDA events."""
    import dataclasses

    import torch
    from lft_torch.config import Args
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    _, _, lr, hr = kernel_step
    base = Args(angRes=5, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
                gamma=0.5, epoch=50, train_fused="true")
    fns = {}
    for dt in ("float32", "mixed", "bfloat16"):
        args = dataclasses.replace(base, dtype=dt)
        p = {k_: v.detach().clone().requires_grad_(True) for k_, v in params.items()}
        fns[dt] = (p, make_train_step(get_model(args), make_optimizer(p, args, 1000), args))
    times = {k_: [] for k_ in fns}
    for dt in ("float32", "mixed", "bfloat16", "bfloat16", "mixed", "float32"):
        p, fn = fns[dt]
        fn(p, lr, hr)                                    # warm-up
        for _ in range(3):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            fn(p, lr, hr)
            ev1.record()
            ev1.synchronize()
            times[dt].append(ev0.elapsed_time(ev1))
    med = {k_: sorted(v)[len(v) // 2] for k_, v in times.items()}
    print(f"{card_line()}: fused train step, batch 4 of 32x32-view patches, 5x5 views, 4x, C=64, "
          f"in turns f32, mixed, bf16, bf16, mixed, f32 (3 steps each, CUDA events): median "
          + ", ".join(f"{k_} {v:.3f} ms" for k_, v in med.items())
          + "; all " + "; ".join(f"{k_} {[round(t, 3) for t in v]}" for k_, v in times.items()),
          flush=True)


def bf16_train_kernel_checks(params, card: str, launches: dict, n_steps: int, launches9: dict,
                             n_steps9: int, seed: int) -> list:
    """Step 24 c: each bf16-training instance against its plain bf16
    version at the train step's shapes (K1 res and K4 [4096, 25, 64], K4
    also [1024, 81, 64], K2.3 res and K3 [100, 32, 32, 64], `wgrad_bf16io`
    at the step's 8 products and K3's dwo on an f32 dx2, each beside its
    bound and cuBLAS, warm and with L2 flushed between calls), the demo
    checkpoint's weights cast to bf16,
    each step fed its plain predecessor's output; the plain f32 version on
    the same values is the yardstick (`bf16t_err`); a bitwise repeat; the
    `kernels` rows, bound at the bf16 rate on bf16 bytes; then each one's
    device ms beside its f32 instance's and its `_bf16` one's (where it has
    one) on the same values, in turns."""
    import torch
    from lft_torch.compare_wgrad import STEP_PRODUCTS
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import common
    from lft_torch.kernels import spa_block as sb
    from lft_torch.kernels import wgrad as wg
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import cold_ms, device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    plan = common.mm_site_plan(True, frozenset())      # `mixed`'s backward plan `none`
    C, h, w, H, K = 64, 32, 32, 8, 5
    D, V, T = 2 * C, 100, 100 * 32 * 32
    rec = Recorder(card, launches, n_steps, "bf16 train step")
    rec9 = Recorder(card, launches9, n_steps9, "angRes-9 bf16 train step")
    pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
    f32 = lambda ts: tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    summed = lambda o: (*o[:-1], o[-1].sum(0))
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g).to(torch.bfloat16)
    turns = []

    def check(name, src, replaces, fn, plain, args, args32, flops, io, half=None, sums=False,
              recorder=rec, **kw):
        """`fn(*args)` (the wrapper on bf16 tensors) against `plain(*args)`,
        `plain(*args32)` the f32 yardstick; `half(*args32)` its `_bf16`
        instance (the mixed backward's) and `fn(*args32)` its f32 one."""
        got, ref, ref32 = (as_tuple(t) for t in (fn(*args), plain(*args), plain(*args32)))
        again = as_tuple(fn(*args))
        if sums:
            got, again, ref, ref32 = (summed(t) for t in (got, again, ref, ref32))
        recorder.record(name, "lft_torch/csrc/" + src, replaces, got, ref, lambda: fn(*args),
                        lambda: plain(*args), flops, io, bf16_products=True, bf16t_ref32=ref32,
                        device_time=True, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  {name}: repeated bitwise: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} does not repeat bitwise")
        forms = [("f32", lambda: fn(*args32))]
        if half is not None:
            forms.append(("_bf16", lambda: half(*args32)))
        turns.append((name, forms + [("_bf16io", lambda: fn(*args))]))
        return ref

    # K1 res and K4 at [4096, 25, 64], K4 also at [1024, 81, 64], block 0's weights
    wa = ab.ang_weights(pb, "altblock.0.ang_trans.")
    wa32 = {k: v.float() for k, v in wa.items()}
    wab = sum(nbytes(t) for t in wa.values())
    for N, A2 in ((4096, 25), (1024, 81)):
        x, dout = rand(N, A2, C), rand(N, A2, C)
        pe = torch.from_numpy(angular_position(A2, C)).to(dev)
        Tk = N * A2
        if A2 <= 64:
            res = check("ang_block_res_bf16io", "ang_bf16.cuh", "lft_tpu/kernels/ang_block.py:233",
                        lambda *a: ab.ang_block(*a, H, with_res=True),
                        lambda *a: ab.ang_block_plain(*a, H, with_res=True), (x, pe, wa),
                        (x.float(), pe, wa32), 2 * Tk * 8 * C * C, nbytes(x, pe, x, x)
                        + 8 * Tk * H + wab, fp32_flops=4 * Tk * A2 * C)
            if not torch.equal(ab.ang_block(x, pe, wa, H, with_res=True)[0],
                               ab.ang_block(x, pe, wa, H)):
                raise AssertionError("ang_block_res_bf16io's out is not ang_block_bf16io's")
            print("  ang_block_res_bf16io: out bit for bit ang_block_bf16io's", flush=True)
        else:
            res = ab.ang_block_plain(x, pe, wa, H, with_res=True)
        _, m, l, attn = res
        name = "ang_block_bwd_bf16io" if A2 <= 64 else "ang_block_bwd128_bf16io"
        dout = calm_relu(dout, ab.ang_block_bwd_ops(x, pe, wa, m, l, attn, dout, H)[8],
                         ab.ang_block_bwd_ops_plain(x, pe, wa, m, l, attn, dout, H)[8],
                         f"{name} at A2 = {A2}")
        check(name, "ang_block.cu", "lft_tpu/kernels/ang_block.py:477",
              lambda *a: ab.ang_block_bwd_ops(*a, H), lambda *a: ab.ang_block_bwd_ops_plain(*a, H),
              (x, pe, wa, m, l, attn, dout), (x.float(), pe, wa32, m, l, attn.float(),
                                              dout.float()),
              28 * Tk * C * C, nbytes(x, pe, m, l, attn, dout) + Tk * C * (6 * 2 + 4)
              + 2 * Tk * 2 * C * 2 + wab, half=lambda *a: ab.ang_block_bwd_ops(*a, H, plan=plan),
              sums=True, fp32_flops=10 * C * N * A2 * A2, recorder=rec if A2 <= 64 else rec9)
        del x, dout, res, m, l, attn

    # K2.3 res and K3's five steps at [100, 32, 32, 64], block 0's weights
    ws = sb._with_mlp(sb.spa_weights(pb, "altblock.0.spa_trans."))
    ws32 = {k: v.float() for k, v in ws.items()}
    wbytes = lambda *k: sum(nbytes(ws[n]) for n in k)
    src, rep = "spa_block_bwd.cu", "lft_tpu/kernels/spa_block.py:667"
    xs = rand(V, h, w, C)
    spa_pe = torch.from_numpy(spatial_position(h, w, C)).to(dev).to(torch.bfloat16)
    pe_tok = unfold3x3_linear(spa_pe[None], ws["mlp"])[0].contiguous()
    tok, xn = sb.tokenize_ln_plain(xs, pe_tok, ws)
    q, k, v = sb.qkv_plain(xn, tok, ws)
    pairs = V * valid_window_pairs(h, w, K // 2)
    attn, m, l = check("spa_window_attn_res_bf16io", "window_mma.cuh",
                       "lft_tpu/kernels/spa_block.py:339",
                       lambda *a: sb.window_attn(*a, H, K, with_stats=True),
                       lambda *a: sb.window_attn_plain(*a, H, K), (q, k, v), f32((q, k, v)),
                       4 * D * pairs, nbytes(q, k, v, q) + 2 * T * H * 4)
    if not torch.equal(sb.window_attn(q, k, v, H, K, with_stats=True)[0],
                       sb.window_attn(q, k, v, H, K)):
        raise AssertionError("spa_window_attn_res_bf16io's attn is not spa_window_attn_bf16io's")
    print("  spa_window_attn_res_bf16io: attn bit for bit spa_window_attn_bf16io's", flush=True)
    dout = rand(V, h, w, C)
    dout = calm_relu(dout, sb.ffn_out_bwd(attn, tok, dout, ws)[4],
                     sb.ffn_out_bwd_plain(attn, tok, dout, ws)[4], "spa_ffn_out_bwd_bf16io")
    dx2, dattn, *_ = check("spa_ffn_out_bwd_bf16io", src, rep, sb.ffn_out_bwd, sb.ffn_out_bwd_plain,
                           (attn, tok, dout, ws), (*f32((attn, tok, dout)), ws32),
                           T * (20 * D * D + 2 * C * D), nbytes(attn, tok, dout) + T * D * 4
                           + T * D * 2 * 8 + wbytes("ln", "wo", "w1", "w2", "wlin"),
                           half=lambda *a: sb.ffn_out_bwd(*a, plan=plan), sums=True)
    xn, q, k, v = check("spa_ln_qkv_bf16io", "spa_block.cu", rep, sb.ln_qkv, sb.ln_qkv_plain,
                        (tok, pe_tok, ws), (*f32((tok, pe_tok)), ws32), 6 * T * D * D,
                        nbytes(tok, pe_tok) + 5 * T * D * 2 + wbytes("ln", "wqk", "wv"),
                        half=lambda *a: sb.ln_qkv(*a, plan=plan))
    dq, dk, dv = check("spa_window_attn_bwd_bf16io", "spa_attn_hp.cu", rep,
                       lambda *a, m=m, l=l: sb.window_attn_bwd(*a, m, l, H, K),
                       lambda *a, m=m, l=l: sb.window_attn_bwd_plain(*a, m, l, H, K),
                       (q, k, v, attn, dattn), f32((q, k, v, attn, dattn)), 10 * D * pairs,
                       nbytes(q, k, v, dattn, m, l) + 3 * T * D * 2,
                       half=lambda *a, m=m, l=l: sb.window_attn_bwd(*a, m, l, H, K, plan=plan))
    dtok = check("spa_qkv_ln_bwd_bf16io", src, rep, sb.qkv_ln_bwd, sb.qkv_ln_bwd_plain,
                 (tok, pe_tok, dq, dk, dv, dx2, ws), (*f32((tok, pe_tok, dq, dk, dv, dx2)), ws32),
                 6 * T * D * D, nbytes(tok, pe_tok, dq, dk, dv, dx2) + T * D * (2 + 4)
                 + wbytes("ln", "wqk", "wv"), half=lambda *a: sb.qkv_ln_bwd(*a, plan=plan),
                 sums=True)[0]
    check("spa_tokenize_bwd_bf16io", src, rep, sb.tokenize_bwd, sb.tokenize_bwd_plain,
          (dtok, ws), (dtok.float(), ws32), 2 * D * C * V * valid_window_pairs(h, w, 1),
          nbytes(dtok) + T * C * 2 + wbytes("wu"), half=lambda *a: sb.tokenize_bwd(*a, plan=plan))
    del xs, tok, xn, q, k, v, attn, m, l, dout, dx2, dattn, dq, dk, dv, dtok

    # wgrad_bf16io at the step's 8 products (bf16 x and dy; the dwo products
    # take dx2 in f32, timed as one more shape), beside cuBLAS's bf16 product
    # with an f32 output on the same bf16 tensors
    def lib_mm(xb, db):
        return torch.mm(xb.t(), db, out_dtype=torch.float32)
    try:
        lib_mm(torch.ones(8, 8, device=dev, dtype=torch.bfloat16),
               torch.ones(8, 8, device=dev, dtype=torch.bfloat16))
        has_lib = True
    except (TypeError, RuntimeError) as e:
        has_lib = False
        print(f"  torch.mm(..., out_dtype=float32) of bf16 operands is not available ({e}); "
              f"wgrad_bf16io's library time is null", flush=True)
    # (the f32 dy of dwo: the cast to bf16 and the product, two calls timed
    # together; dwu's taps: no one cuBLAS call). Each also with L2 flushed
    # by a 512 MB write before every call (`cold_ms`), as a step finds its
    # inputs after the kernels between.
    rows = list(STEP_PRODUCTS) + [("K3 dwo, dy = dx2 in f32", 128, 128, None, 4)]
    for i, (what, Kw, Nw, image, per_step) in enumerate(rows):
        x = rand(T, Kw)
        dy = rand(T, Nw) if i < len(STEP_PRODUCTS) else rand(T, Nw).float()
        got, again = wg.wgrad(x, dy, image), wg.wgrad(x, dy, image)
        ref, ref32 = wg.wgrad_plain(x, dy, image), wg.wgrad_plain(x.float(), dy.float(), image)
        lib = None
        if has_lib and image is None:
            lib = lambda x=x, dy=dy: lib_mm(x, dy if dy.dtype == torch.bfloat16 else dy.bfloat16())
        pairs_w = T if image is None else V * valid_window_pairs(h, w, 1)
        kern = lambda x=x, dy=dy, im=image: wg.wgrad(x, dy, im)
        flops, io = 2 * pairs_w * Kw * Nw, nbytes(x, dy, got)
        ms_k, _, ms_l = rec.record(
            "wgrad_bf16io", "lft_torch/csrc/wgrad.cu", "lft_tpu/kernels/spa_block.py:570",
            (got,), (ref,), kern, lambda x=x, dy=dy, im=image: wg.wgrad_plain(x, dy, im), flops,
            io, lib_fn=lib if i < len(STEP_PRODUCTS) else None, bf16t_ref32=(ref32,),
            shape=None if i == 0 else (T, Kw, Nw) + (image or ()), device_time=True,
            bf16_products=True)
        if i == len(STEP_PRODUCTS) and lib is not None:
            ms_l = device_ms(lib)
        b_ms, b_by = rec.bound(flops, io, rec.bf16_peak)
        c_k, c_l = cold_ms(kern), None if lib is None else cold_ms(lib)
        print(f"  wgrad_bf16io {what} [{T}, {Kw}]ᵀ[{T}, {Nw}]{'' if image is None else ' 9 taps'}"
              f" ({card_line()}): bound {b_ms:.4f} ms ({b_by}); warm: kernel {ms_k:.4f} ms, "
              f"cuBLAS {'-' if ms_l is None else f'{ms_l:.4f} ms'}; L2 flushed: kernel "
              f"{c_k:.4f} ms, cuBLAS {'-' if c_l is None else f'{c_l:.4f} ms'}; {per_step} a "
              f"step; repeated bitwise: {torch.equal(got, again)}", flush=True)
        if not torch.equal(got, again):
            raise AssertionError(f"wgrad_bf16io {what} does not repeat bitwise")
        if i in (0, 1):
            xf, dyf = x.float(), dy.float()
            turns.append((f"wgrad_bf16io {what}", [
                ("f32", lambda xf=xf, dyf=dyf, im=image: wg.wgrad(xf, dyf, im)),
                ("_bf16", lambda xf=xf, dyf=dyf, im=image: wg.wgrad(xf, dyf, im, half=True)),
                ("_bf16io", lambda x=x, dy=dy, im=image: wg.wgrad(x, dy, im))]))
        else:
            del x, dy
        del got, again, ref, ref32

    print(f"{card_line()}: device ms of each bf16-training instance beside its f32 instance "
          f"and its _bf16 one on the same values, in turns (forward, then backward; "
          f"device_ms, 20 calls):", flush=True)
    for name, forms in turns:
        t = {label: [] for label, _ in forms}
        for label, fn in forms + forms[::-1]:
            t[label].append(device_ms(fn))
        print(f"  {name}: " + ", ".join(f"{label} {a:.4f} / {b:.4f} ms" for label, (a, b)
                                        in t.items()), flush=True)
    return rec.rows + rec9.rows


def bf16_train_cli(params, seed: int) -> None:
    """Step 24 e: `python -m lft_torch.train --dtype bfloat16` (its `main`)
    for 2 epochs of 2 steps from the checkpoint's weights, then a resume
    from the epoch-1 file that must end on the uninterrupted run's
    parameters bit for bit."""
    from lft_torch.kernels import BF16TRAIN
    per_step = {k: 4 for k in BF16TRAIN if k not in ("wgrad_bf16io", "ang_block_bwd128_bf16io")}
    per_step["wgrad_bf16io"] = 56
    train_cli_resume(params, seed, "bfloat16", per_step, ("ang_block_bwd", "wgrad", "spa_qkv"))


def train_cli_resume(params, seed: int, dtype: str, per_step: dict, absent) -> None:
    """`python -m lft_torch.train --dtype <dtype>` (its `main`) for 2 epochs
    of 2 steps from the checkpoint's weights: each kernel of `per_step`
    launched that many times a step and none of `absent`, f32 checkpoints;
    then a resume from the epoch-1 file that must end on the uninterrupted
    run's parameters bit for bit."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from lft_torch import train as train_cli
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.utils.checkpoint import save_checkpoint

    dev = next(iter(params.values())).device
    lr, hr = synth_batch(torch.Generator(device=dev).manual_seed(seed + 8), batch=8, ang_res=5,
                         patch=32, scale=4)
    trainset = MemTrainSet(lr.cpu().numpy(), hr.cpu().numpy(), seed)
    what = f"train CLI under --dtype {dtype}"
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{dtype}_train_") as tmp:
        start = os.path.join(tmp, "start.npz")
        save_checkpoint(start, params, 0)
        args = Args(angRes=5, scale_factor=4, channels=64, batch_size=4, epoch=2, lr=2e-4,
                    n_steps=15, gamma=0.5, dtype=dtype, use_pre_pth=True,
                    path_pre_pth=start, seed=seed, data_name="Synth", num_workers=0,
                    path_log=os.path.join(tmp, "train"))
        torch.cuda.synchronize()
        reset_launches()
        full, hist = train_cli.main(args, dataset=trainset)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        losses = [hh["loss"] for hh in hist]
        print(f"{what}: epoch means {hist}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{what}: bad losses {losses}")
        n = 2 * len(trainset) // args.batch_size
        if any(counts[k] != c * n for k, c in per_step.items()) or any(counts[k] for k in absent):
            raise AssertionError(f"{what}: expected {per_step} launches a step and none of "
                                 f"{absent}, got {counts}")
        ck_dir = os.path.join(args.path_log, "SR_5x5_4x", "LFT", "Synth", "checkpoints")
        names = sorted(os.listdir(ck_dir))
        if names != ["LFT_5x5_4x_epoch_01_model.npz", "LFT_5x5_4x_epoch_02_model.npz"]:
            raise AssertionError(f"{what} checkpoints: {names}")
        z1 = np.load(os.path.join(ck_dir, names[0]))
        if not all(z1[f].dtype == np.float32 for f in z1.files
                   if not f.startswith("__") and z1[f].ndim):
            raise AssertionError(f"{what}: a checkpoint parameter is not f32")
        r_args = dataclasses.replace(args, path_pre_pth=os.path.join(ck_dir, names[0]),
                                     path_log=os.path.join(tmp, "resume"))
        resumed, _ = train_cli.main(r_args, dataset=trainset)
        differ = [k for k in full if not torch.equal(full[k], resumed[k])]
        if differ:
            raise AssertionError(f"{what}: resumed from epoch 1, {len(differ)} parameters "
                                 f"differ from the uninterrupted run's, e.g. {differ[:3]}")
        print(f"{what}: checkpoints " + ", ".join(names) + " (f32); resumed from epoch 1, "
              "every epoch-2 parameter equals the uninterrupted run's bit for bit", flush=True)


def bf16_perop_phase(params, scenes, card: str, seed: int) -> dict:
    """Step 25 a (module docstring). Returns the launches of each instance
    over its scene, for step 25 b's rows."""
    import dataclasses

    import torch
    from lft_torch.config import Args
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.profile_scene import events_ms

    dev = torch.device("cuda")
    geometries = [
        # what, angRes, LR view, patch, stride, fused, (ang, spa) knobs, launches a scene
        ("5x5, fused=False (K7, K5)", 5, 128, 32, 16, False, (None, None),
         {"ang_attn_bf16io": 16, "spa_attn_hp_bf16io": 16}),
        ("12x12 views, default arguments (K8, K5)", 12, 48, 32, 16, None, (None, None),
         {"ang_attn_sweep_bf16io": 4, "spa_attn_hp_bf16io": 4}),
        ("30x30-view patches (K7, K9)", 5, 128, 30, 16, False, (None, None),
         {"ang_attn_bf16io": 16, "spa_attn_offset_bf16io": 16}),
        ("64x64-view patches (K7, K6)", 5, 128, 64, 32, False, (None, None),
         {"ang_attn_bf16io": 4, "spa_attn_mxu_bf16io": 4}),
        ("5x5, tile + sweep (K8 as K7's f32-inside instance, K10)", 5, 128, 32, 16, False,
         ("sweep", "tile"), {"ang_attn_sweep_bf16io": 16, "spa_attn_tile_bf16io": 16}),
    ]
    per_scene = {}
    for what, ang_res, view, patch, stride, fused, (ang, spa), expect in geometries:
        a32 = Args(angRes=ang_res, scale_factor=4, channels=64, patch_size_for_test=patch,
                   stride_for_test=stride, eval_batch=16)
        ab_ = dataclasses.replace(a32, dtype="bfloat16")
        lr, hr = (scenes[0] if ang_res == 5 else
                  lr_hr_pair(synth_lf_scene(ang_res, 4 * view, 4 * view, seed=seed), 4))
        lr_t, hr_t = torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)
        kw = {} if fused is None else {"fused": fused}
        with variants(ang, spa):
            cache_b = ScenePipelineCache(forward, ab_, **kw)
            torch.cuda.synchronize()
            reset_launches()
            psnr, ssim, _ = evaluate_dataset(forward, params, ab_, [(lr, hr)], cache=cache_b)
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            print(f"bf16 per-op SR, {what}: PSNR {psnr:.6f} dB SSIM {ssim:.6f}; launches "
                  f"{ {k: c for k, c in counts.items() if c} }", flush=True)
            wrong = {k: c for k, c in counts.items() if c != expect.get(k, 0)}
            if wrong:
                raise AssertionError(f"bf16 per-op SR, {what}: expected exactly {expect} "
                                     f"launches, got {wrong}")
            for k, c in expect.items():
                per_scene[k] = max(per_scene.get(k, 0), c)
            sr_k, again = cache_b(params, lr_t), cache_b(params, lr_t)
            sr_p = ScenePipelineCache(forward, ab_, plain_blocks=True, **kw)(params, lr_t)
            cache_f = ScenePipelineCache(forward, a32, **kw)
            sr_f = cache_f(params, lr_t)
            if sr_k.dtype != torch.float32 or sr_k.shape != hr_t.shape \
                    or not torch.isfinite(sr_k).all():
                raise AssertionError(f"{what}: bad bf16 SR mosaic {sr_k.dtype} "
                                     f"{tuple(sr_k.shape)}")
            if not torch.equal(sr_k, again):
                raise AssertionError(f"{what}: the bf16 scene does not repeat bitwise")
            gap_k, gap_p, d = l2_rel(sr_k, sr_f), l2_rel(sr_p, sr_f), l2_rel(sr_k, sr_p)
            p_k, p_p, p_f = (float(cal_metrics(hr_t, t, ang_res)[0]) for t in (sr_k, sr_p, sr_f))
            print(f"  {what}: repeated bitwise; kernels vs their plain versions dPSNR "
                  f"{p_k - p_p:+.3e} dB (limit 0.01), L2 {d:.3e}; distance from the f32 scene: "
                  f"kernels {gap_k:.3e}, plain {gap_p:.3e} ({gap_k / gap_p:.4f}, limit 1 +- "
                  f"{BF16_SCENE_TOL:g}; L2 {d / gap_p:.4f} of it, limit {BF16_SCENE_L2:g}); "
                  f"dPSNR against f32 {p_k - p_f:+.4f} dB", flush=True)
            if abs(p_k - p_p) > 0.01 or abs(gap_k / gap_p - 1) > BF16_SCENE_TOL \
                    or d > BF16_SCENE_L2 * gap_p:
                raise AssertionError(f"{what}: the bf16 per-op kernels disagree with their "
                                     f"plain versions")
            f_fn, b_fn = (lambda: cache_f(params, lr_t)), (lambda: cache_b(params, lr_t))
            t = [events_ms(f_fn, 2), events_ms(b_fn, 2), events_ms(b_fn, 2), events_ms(f_fn, 2)]
            print(f"  {card}: {what}, ms a scene (CUDA events, 2 back-to-back scenes) in turns "
                  f"f32 / bf16 / bf16 / f32: "
                  + " / ".join(f"{x:.2f}" for x in t)
                  + f" (bf16 / f32 {(t[1] + t[2]) / (t[0] + t[3]):.3f})", flush=True)
        del cache_b, cache_f, sr_p
        torch.cuda.empty_cache()
    return per_scene


def bf16_perop_kernel_checks(card: str, per_scene: dict, seed: int) -> list:
    """Step 25 b (module docstring): the six per-op `_bf16io` instances
    against their plain versions, on the card inside `plain_versions()`.
    Timed by CUDA events around back-to-back calls (`events_ms`): late in
    this long process the profiler's traces lose kernel records (a kernel
    counted fewer times than launched, or timed at half its time)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from lft_torch.kernels import ang_attn_mxu, ang_attn_vjp, local_attn, local_attn_vjp
    from lft_torch.kernels import spa_attn, spa_attn_hp
    from lft_torch.kernels.common import plain_versions
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.profile_scene import events_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 25)
    rec = Recorder(card, per_scene, 1, "bf16 per-op scene")
    H, K = 8, 5
    cases = [
        # name, wrapper, shape, source, TPU kernel replaced
        ("ang_attn_bf16io", lambda q, k, v: ang_attn_mxu.ang_attn_fwd(q, k, v, H),
         (16384, 25, 64), "ang_attn.cu", "lft_tpu/kernels/ang_attn_mxu.py:234"),
        ("ang_attn_sweep_bf16io", lambda q, k, v: ang_attn_vjp.ang_attn_sweep_fwd(q, k, v, H),
         (16384, 25, 64), "ang_attn.cu", "lft_tpu/kernels/ang_attn_vjp.py:129"),
        ("spa_attn_hp_bf16io", lambda q, k, v: spa_attn_hp.spa_attn_hp_fwd(q, k, v, H, K),
         (400, 32, 32, 128), "window_mma.cuh", "lft_tpu/kernels/spa_attn_hp.py:419"),
        ("spa_attn_mxu_bf16io", lambda q, k, v: spa_attn.spa_attn_mxu_fwd(q, k, v, H, K),
         (400, 64, 64, 128), "spa_attn_hp.cu", "lft_tpu/kernels/spa_attn.py:233"),
        ("spa_attn_offset_bf16io",
         lambda q, k, v: local_attn_vjp.spa_attn_offset_fwd(q, k, v, H, K),
         (400, 30, 30, 128), "spa_attn_hp.cu", "lft_tpu/kernels/local_attn_vjp.py:257"),
        ("spa_attn_tile_bf16io",
         lambda q, k, v: local_attn.windowed_attention_tile(q, k, v, H, K, 8),
         (400, 32, 32, 128), "spa_attn_hp.cu", "lft_tpu/kernels/local_attn.py:99"),
    ]
    extra = [("ang_attn_sweep_bf16io", cases[1][1], (9216, 144, 64), "ang_attn_sweep.cu",
              cases[1][4])]
    seen = set()
    for name, fn, shape, src, replaces in cases + extra:
        q, k, v = (torch.randn(*shape, device=dev, generator=g) * sc for sc in (1.5, 1.5, 1.0))
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        q32, k32, v32 = q.float(), k.float(), v.float()
        got, again = fn(q, k, v), fn(q, k, v)
        with plain_versions():
            ref, ref32 = fn(q, k, v), fn(q32, k32, v32)

        def plain():
            with plain_versions():
                return fn(q, k, v)
        if len(shape) == 3:
            N, A2, C = shape
            heads = lambda t: t.reshape(N, A2, H, C // H).transpose(1, 2)
            qh, kh, vh = heads(q), heads(k), heads(v)
            lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)
            flops = 4 * N * A2 * A2 * C
        else:
            B, h, w, E = shape
            heads = lambda t: t.reshape(B, h * w, H, E // H).transpose(1, 2)
            qh, kh, vh = heads(q), heads(k), heads(v)
            mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)

            def lib():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
            flops = 4 * E * B * valid_window_pairs(h, w, K // 2)
        rec.record(name, "lft_torch/csrc/" + src, replaces, got, ref, lambda: fn(q, k, v), plain,
                   flops, nbytes(q, k, v, got), lib_fn=lib, slow_reps=3, timer=events_ms,
                   bf16_ref32=ref32, shape=shape if name in seen else None)
        seen.add(name)
        if not torch.equal(got, again):
            raise AssertionError(f"{name} at {list(shape)} does not repeat bitwise")
        f32_fn, bf_fn = (lambda: fn(q32, k32, v32)), (lambda: fn(q, k, v))
        t = [events_ms(f32_fn), events_ms(bf_fn), events_ms(bf_fn), events_ms(f32_fn)]
        print(f"  {name} at {list(shape)}: repeated bitwise; {card}: ms (CUDA events, 20 "
              f"back-to-back calls) in turns with its f32 instance, f32 / bf16 / bf16 / f32: "
              + " / ".join(f"{x:.4f}" for x in t), flush=True)
        del q, k, v, q32, k32, v32, got, again, ref, ref32, qh, kh, vh
        torch.cuda.empty_cache()
    return rec.rows

# step 26's geometries: what, angRes, view of a patch, batch, (ang, spa) knobs,
# the kernels whose `_res_bf16io` and `_bwd_bf16io` instances a step launches
PEROP_BF16_TRAIN_GEOMETRIES = [
    ("5x5 views, patch 32 (K7, K5)", 5, 32, 4, (None, None), ("ang_attn", "spa_attn_hp")),
    ("mxu (K7, K6)", 5, 32, 4, (None, "mxu"), ("ang_attn", "spa_attn_mxu")),
    ("sweep + offset (K8 as K7's f32-inside instance at A2 = 25, K9)", 5, 32, 4,
     ("sweep", "offset"), ("ang_attn_sweep", "spa_attn_offset")),
    ("12x12 views, batch 2 (K8 past 128 views, K5)", 12, 32, 2, (None, None),
     ("ang_attn_sweep", "spa_attn_hp")),
]


def bf16_perop_train_phase(params, seed: int, steps: int = 2):
    """Step 26 a and b (module docstring). Returns (each instance's launches
    over (a), the first geometry's first step for b and d: (lr, hr, loss,
    gradient, params after))."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.kernels.common import plain_if
    from lft_torch.parallel.mesh import get_mesh, make_dp_train_step
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()
    totals, first = {}, None
    for what, ang_res, patch, batch, (ang, spa), bases in PEROP_BF16_TRAIN_GEOMETRIES:
        ab_ = Args(angRes=ang_res, scale_factor=4, channels=64, batch_size=batch, lr=2e-4,
                   n_steps=15, gamma=0.5, epoch=50, dtype="bfloat16", train_fused="false")
        a32 = dataclasses.replace(ab_, dtype="float32")
        model = get_model(ab_)
        gen = torch.Generator(device=dev).manual_seed(seed + 26)
        new_batch = lambda: synth_batch(gen, batch=batch, ang_res=ang_res, patch=patch, scale=4)
        lr, hr = new_batch()
        what = f"bf16 per-op train, {what}"

        def step(args, loss=None, plain=False, mesh=None):
            p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
            m = model if loss is None else dataclasses.replace(model, loss=loss)
            opt = make_optimizer(p, args, steps_per_epoch=1000)
            fn = (make_train_step(m, opt, args) if mesh is None
                  else make_dp_train_step(m, opt, args, mesh))
            with plain_if(plain):
                out = float(fn(p, lr, hr)[0])
            return out, torch.cat([p[k].grad.reshape(-1) for k in sorted(p)]), p, fn

        with variants(ang, spa):
            reset_launches()
            loss_p, _, _, _ = step(ab_, plain=True)
            _, g_p, _, _ = step(ab_, smooth, plain=True)
            _, g_f, _, _ = step(a32, smooth, plain=True)
            torch.cuda.synchronize()
            if any(LAUNCHES.values()):
                raise AssertionError(f"{what}: the plain path launched kernels: "
                                     f"{ {k: v for k, v in LAUNCHES.items() if v} }")
            reset_launches()
            loss_k, g_r, p_a, step_a = step(ab_)
            p_a1 = {k_: v.detach().clone() for k_, v in p_a.items()}
            loss_b, g_b, p_b, _ = step(ab_)
            _, g_k, _, _ = step(ab_, smooth)
            for _ in range(steps):
                step_a(p_a, *new_batch())
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
        n = 3 + steps
        print(f"{what} step 1: loss kernels {loss_k:.8f} plain {loss_p:.8f} "
              f"(|d| {abs(loss_k - loss_p):.3e}, limit {BF16T_LOSS:g} |loss|)", flush=True)
        if not abs(loss_k - loss_p) <= BF16T_LOSS * abs(loss_p):
            raise AssertionError(f"{what}: the kernel path's loss disagrees with the plain path")
        gap, own, d = l2_rel(g_p, g_f), l2_rel(g_k, g_f), l2_rel(g_k, g_p)
        print(f"{what} step 1 (smooth loss): the gradient's distance from the f32 step's "
              f"{own:.4e}, the plain versions' {gap:.4e} ({own / gap:.4f}, limit 1 +- "
              f"{BF16T_TOL:g}); L2 from the plain step's gradient {d:.4e} ({d / gap:.4f} of its "
              f"distance, limit {BF16T_L2:g})", flush=True)
        if not (abs(own / gap - 1) <= BF16T_TOL and d <= BF16T_L2 * gap):
            raise AssertionError(f"{what}: the kernel path's gradient disagrees with the plain "
                                 f"path")
        if not all(v.dtype == torch.float32 for v in p_a.values()):
            raise AssertionError(f"{what}: the master parameters left f32")
        same = (loss_b == loss_k and torch.equal(g_r, g_b)
                and all(torch.equal(p_a1[k_], p_b[k_]) for k_ in p_b))
        print(f"{what} step repeated from the same state: loss, grads and params bitwise "
              f"equal: {same}", flush=True)
        if not same:
            raise AssertionError(f"{what}: a repeated step is not bitwise equal")
        want = {f"{b}_{f}_bf16io": 4 * n for b in bases for f in ("res", "bwd")}
        wrong = {k_: counts[k_] for k_ in LAUNCHES if counts[k_] != want.get(k_, 0)}
        print(f"launches in the {what} run ({n} kernel-path steps): "
              f"{ {k_: v for k_, v in counts.items() if v} }", flush=True)
        if wrong:
            raise AssertionError(f"{what}: expected {want} and no other launch (no f32 form), "
                                 f"got {wrong}")
        for k_, v in want.items():
            totals[k_] = totals.get(k_, 0) + v
        if first is None:
            first = (lr, hr, loss_k, g_r, p_a1)
            # (b) the data-parallel step at world size 1, on an nccl group of one rank
            with socket.socket() as s_:
                s_.bind(("127.0.0.1", 0))
                port = s_.getsockname()[1]
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                    world_size=1)
            try:
                mesh = get_mesh()
                loss_d, g_d, p_d, _ = step(ab_, mesh=mesh)
                torch.cuda.synchronize()
            finally:
                dist.destroy_process_group()
            same = (mesh.size == 1 and mesh.group is not None and loss_d == loss_k
                    and torch.equal(g_d, g_r) and all(torch.equal(p_a1[k_], p_d[k_])
                                                       for k_ in p_d))
            print(f"data-parallel bf16 step at world size 1 (nccl): loss, grads and params "
                  f"bitwise equal to the first step's: {same}", flush=True)
            if not same:
                raise AssertionError("the data-parallel bf16 step at world size 1 differs from "
                                     "make_train_step's")
        torch.cuda.empty_cache()
    return totals, first


def bf16_perop_train_kernel_checks(card: str, launches: dict, seed: int) -> list:
    """Step 26 c (module docstring): the ten `_bf16io` instances against
    their plain versions on the card (`plain_versions()`), timed by CUDA
    events around back-to-back calls (late in the process, as step 25)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from lft_torch.kernels import ang_attn_mxu as am
    from lft_torch.kernels import ang_attn_vjp as av
    from lft_torch.kernels import local_attn_vjp as lv
    from lft_torch.kernels import spa_attn as sa
    from lft_torch.kernels import spa_attn_hp as hp
    from lft_torch.kernels.common import plain_versions
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.profile_scene import events_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 126)
    rec = Recorder(card, launches, 1, "step-26a run")
    H, K = 8, 5
    src_a, src_w = "lft_torch/csrc/ang_attn.cu", "lft_torch/csrc/spa_attn_hp.cu"
    tpu = "lft_tpu/kernels/"
    cases = [
        # base name, _res form, backward (q, k, v, out, m, l, dout), shape, sources, replaces
        ("ang_attn", lambda q, k, v: am.ang_attn_fwd(q, k, v, H, True),
         lambda q, k, v, o, m, l, d: am.ang_attn_bwd(q, k, v, m, l, d, H), (4096, 25, 64),
         (src_a, src_a), (tpu + "ang_attn_mxu.py:244", tpu + "ang_attn_mxu.py:289")),
        ("ang_attn_sweep", lambda q, k, v: av.ang_attn_sweep_fwd(q, k, v, H, True),
         lambda q, k, v, o, m, l, d: av.ang_attn_sweep_bwd(q, k, v, o, m, l, d, H),
         (4096, 25, 64), (src_a, "lft_torch/csrc/ang_attn_sweep.cu"),
         (tpu + "ang_attn_vjp.py:129", tpu + "ang_attn_vjp.py:158")),
        ("spa_attn_hp", lambda q, k, v: hp.spa_attn_hp_fwd(q, k, v, H, K, True),
         lambda q, k, v, o, m, l, d: hp.spa_attn_hp_bwd(q, k, v, m, l, d, H, K),
         (100, 32, 32, 128), ("lft_torch/csrc/window_mma.cuh", src_w),
         (tpu + "spa_attn_hp.py:433", tpu + "spa_attn_hp.py:514")),
        ("spa_attn_mxu", lambda q, k, v: sa.spa_attn_mxu_fwd(q, k, v, H, K, True),
         lambda q, k, v, o, m, l, d: sa.spa_attn_mxu_bwd(q, k, v, m, l, d, H, K),
         (100, 32, 32, 128), (src_w, src_w), (tpu + "spa_attn.py:220", tpu + "spa_attn.py:271")),
        ("spa_attn_offset", lambda q, k, v: lv.spa_attn_offset_fwd(q, k, v, H, K, True),
         lambda q, k, v, o, m, l, d: lv.spa_attn_offset_bwd(q, k, v, o, m, l, d, H, K),
         (100, 32, 32, 128), (src_w, src_w),
         (tpu + "local_attn_vjp.py:257", tpu + "local_attn_vjp.py:314")),
    ]
    cases.append(("ang_attn_sweep", cases[1][1], cases[1][2], (2048, 144, 64),
                  ("lft_torch/csrc/ang_attn_sweep.cu", "lft_torch/csrc/ang_attn_sweep.cu"),
                  cases[1][5]))
    seen = set()
    for base, res_fn, bwd_fn, shape, (src_r, src_b), (rep_r, rep_b) in cases:
        q, k, v, dout = (torch.randn(*shape, device=dev, generator=g) * sc
                         for sc in (1.5, 1.5, 1.0, 1.0))
        q, k, v, dout = q.bfloat16(), k.bfloat16(), v.bfloat16(), dout.bfloat16()
        q32, k32, v32, d32 = q.float(), k.float(), v.float(), dout.float()
        if len(shape) == 3:
            N, A2, C = shape
            heads = lambda t: t.reshape(N, A2, H, C // H).transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
            flops = N * A2 * A2 * C
        else:
            B, h, w, E = shape
            heads = lambda t: t.reshape(B, h * w, H, E // H).transpose(1, 2)
            mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)

            def lib():
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                          attn_mask=mask)
            flops = E * B * valid_window_pairs(h, w, K // 2)

        # the `_res` form
        name = base + "_res_bf16io"
        got, again = res_fn(q, k, v), res_fn(q, k, v)
        with plain_versions():
            ref, ref32 = res_fn(q, k, v), res_fn(q32, k32, v32)

        def plain_res():
            with plain_versions():
                return res_fn(q, k, v)
        rec.record(name, src_r, rep_r, got, ref, lambda: res_fn(q, k, v), plain_res, 4 * flops,
                   nbytes(q, k, v, *got), lib_fn=lib, slow_reps=3, timer=events_ms,
                   bf16t_ref32=ref32, shape=shape if name in seen else None)
        seen.add(name)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} at {list(shape)} does not repeat bitwise")
        f32_fn, bf_fn = (lambda: res_fn(q32, k32, v32)), (lambda: res_fn(q, k, v))
        t = [events_ms(f32_fn), events_ms(bf_fn), events_ms(bf_fn), events_ms(f32_fn)]
        print(f"  {name} at {list(shape)}: repeated bitwise; {card}: ms (CUDA events, 20 "
              f"back-to-back calls) in turns with its f32 instance, f32 / bf16 / bf16 / f32: "
              + " / ".join(f"{x:.4f}" for x in t), flush=True)

        # the backward, fed the plain `_res` form's out, m, l
        name = base + "_bwd_bf16io"
        res, res32 = ref, ref32
        got = bwd_fn(q, k, v, *res, dout)
        again = bwd_fn(q, k, v, *res, dout)
        with plain_versions():
            ref, ref32 = bwd_fn(q, k, v, *res, dout), bwd_fn(q32, k32, v32, *res32, d32)

        def plain_bwd():
            with plain_versions():
                return bwd_fn(q, k, v, *res, dout)
        reads = (q, k, v, dout, *res[1:]) + ((res[0],) if "offset" in base or "sweep" in base
                                              else ())
        rec.record(name, src_b, rep_b, got, ref, lambda: bwd_fn(q, k, v, *res, dout), plain_bwd,
                   10 * flops, nbytes(*reads, *got), slow_reps=3, timer=events_ms,
                   bf16t_ref32=ref32, shape=shape if name in seen else None)
        seen.add(name)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} at {list(shape)} does not repeat bitwise")
        f32_fn = lambda: bwd_fn(q32, k32, v32, *res32, d32)
        bf_fn = lambda: bwd_fn(q, k, v, *res, dout)
        t = [events_ms(f32_fn), events_ms(bf_fn), events_ms(bf_fn), events_ms(f32_fn)]
        print(f"  {name} at {list(shape)}: repeated bitwise; {card}: ms (CUDA events, 20 "
              f"back-to-back calls) in turns with its f32 instance, f32 / bf16 / bf16 / f32: "
              + " / ".join(f"{x:.4f}" for x in t), flush=True)
        del q, k, v, dout, q32, k32, v32, d32, got, again, ref, ref32, res, res32
        torch.cuda.empty_cache()
    return rec.rows


def bf16_perop_step_times(params, first) -> None:
    """Step 26 d: the per-op train step's ms (5x5 views, K7 + K5) under
    float32 and bfloat16 in turns (f32, bf16, bf16, f32), 3 steps each
    after a warm-up, CUDA events."""
    import dataclasses

    import torch
    from lft_torch.config import Args
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    lr, hr = first[:2]
    base = Args(angRes=5, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
                gamma=0.5, epoch=50, train_fused="false")
    fns = {}
    for dt in ("float32", "bfloat16"):
        args = dataclasses.replace(base, dtype=dt)
        p = {k_: v.detach().clone().requires_grad_(True) for k_, v in params.items()}
        fns[dt] = (p, make_train_step(get_model(args), make_optimizer(p, args, 1000), args))
    times = {k_: [] for k_ in fns}
    for dt in ("float32", "bfloat16", "bfloat16", "float32"):
        p, fn = fns[dt]
        fn(p, lr, hr)                                    # warm-up
        for _ in range(3):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            fn(p, lr, hr)
            ev1.record()
            ev1.synchronize()
            times[dt].append(ev0.elapsed_time(ev1))
    med = {k_: sorted(v)[len(v) // 2] for k_, v in times.items()}
    print(f"{card_line()}: per-op train step (--train_fused false, K7 + K5), batch 4 of "
          f"32x32-view patches, 5x5 views, 4x, C=64, in turns f32, bf16, bf16, f32 (3 steps "
          f"each, CUDA events): median "
          + ", ".join(f"{k_} {v:.3f} ms" for k_, v in med.items())
          + "; all " + "; ".join(f"{k_} {[round(t, 3) for t in v]}" for k_, v in times.items()),
          flush=True)


def bf16_perop_train_cli(params, seed: int) -> None:
    """Step 26 e: `python -m lft_torch.train --dtype bfloat16 --train_fused
    false` (its `main`) for 2 epochs of 2 steps from the checkpoint's
    weights, then a resume from the epoch-1 file that must end on the
    uninterrupted run's parameters bit for bit."""
    import dataclasses
    import tempfile

    import torch
    from lft_torch import train as train_cli
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, reset_launches
    from lft_torch.utils.checkpoint import save_checkpoint

    dev = next(iter(params.values())).device
    lr, hr = synth_batch(torch.Generator(device=dev).manual_seed(seed + 27), batch=8, ang_res=5,
                         patch=32, scale=4)
    trainset = MemTrainSet(lr.cpu().numpy(), hr.cpu().numpy(), seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_perop_train_") as tmp:
        start = os.path.join(tmp, "start.npz")
        save_checkpoint(start, params, 0)
        args = Args(angRes=5, scale_factor=4, channels=64, batch_size=4, epoch=2, lr=2e-4,
                    n_steps=15, gamma=0.5, dtype="bfloat16", train_fused="false",
                    use_pre_pth=True, path_pre_pth=start, seed=seed, data_name="Synth",
                    num_workers=0, path_log=os.path.join(tmp, "train"))
        torch.cuda.synchronize()
        reset_launches()
        full, hist = train_cli.main(args, dataset=trainset)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        losses = [hh["loss"] for hh in hist]
        print(f"train CLI under --dtype bfloat16 --train_fused false: epoch means {hist}; "
              f"launches { {k: v for k, v in counts.items() if v} }", flush=True)
        if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"bf16 per-op train CLI: bad losses {losses}")
        n = 2 * len(trainset) // args.batch_size
        want = {f"{b}_{f}_bf16io": 4 * n for b in ("ang_attn", "spa_attn_hp")
                for f in ("res", "bwd")}
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"bf16 per-op train CLI: expected launches {want}, got {counts}")
        ck_dir = os.path.join(args.path_log, "SR_5x5_4x", "LFT", "Synth", "checkpoints")
        names = sorted(os.listdir(ck_dir))
        if names != ["LFT_5x5_4x_epoch_01_model.npz", "LFT_5x5_4x_epoch_02_model.npz"]:
            raise AssertionError(f"bf16 per-op train CLI checkpoints: {names}")
        r_args = dataclasses.replace(args, path_pre_pth=os.path.join(ck_dir, names[0]),
                                     path_log=os.path.join(tmp, "resume"))
        resumed, _ = train_cli.main(r_args, dataset=trainset)
        differ = [k for k in full if not torch.equal(full[k], resumed[k])
                  or full[k].dtype != torch.float32]
        if differ:
            raise AssertionError(f"bf16 per-op train CLI: resumed from epoch 1, {len(differ)} "
                                 f"parameters differ from the uninterrupted run's (or left "
                                 f"f32), e.g. {differ[:3]}")
        print("train CLI under --dtype bfloat16 --train_fused false: checkpoints "
              + ", ".join(names) + "; resumed from epoch 1, every epoch-2 parameter (f32) equals "
              "the uninterrupted run's bit for bit", flush=True)


@contextlib.contextmanager
def mm_sites(spec: str, env: str = "LFT_MM_HP_SITES"):
    """The plan variable `env` set to `spec` for the block, and put back after it."""
    before = os.environ.get(env)
    os.environ[env] = spec
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = before


def fwdforms_phase(params, args, scenes, cache, card: str, seed: int) -> list:
    """Step 27, the last forward forms of the fused blocks.
    a: K11 on a bf16 pixel-major buffer [16, 32, 32, 25, 64] (block 0's
    weights in bf16): one launch of each of its five `_bf16io` kernels, the
    chain bitwise view-major K2 bf16io's on a permuted copy, its two `_pm`
    kernels against their plain versions with step 23's bounds and a
    bitwise repeat; then K11 on the f32 buffer under LFT_MM_HP_SITES=none
    (the five `_bf16` kernels, bitwise the view-major `_bf16` chain).
    b: step 3's scenes under `--dtype mixed` with LFT_MM_HP_SITES=none: 16
    launches a scene of each of the six `_bf16` forwards and no other
    kernel; against the same scenes through the plain blocks under the plan
    (|dPSNR| within 0.01 dB, the distance from the f32 scene within 10% of
    the plain path's, the L2 from the plain path's within 1.5 of it), a
    bitwise repeat, dPSNR against f32. c: each of the eight `_bf16` kernels
    against its plain version under the plan with step 22's bounds at the
    main path's shapes, a bitwise repeat. d: a train step and a forward
    under a site subset of the backward plan raise before any launch. e:
    each new kernel in turns with its f32 (or view-major `_bf16io`)
    instance, and the `none` scene with the f32 scene (device busy,
    CUDA-event wall time, idle share). Returns the ten rows of the
    `kernels` line."""
    import dataclasses

    import torch
    from lft_torch.config import Args
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import FORWARD, LAUNCHES, MIXED_FWD, common, reset_launches
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.models.lft import forward
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import events_ms, kernel_times
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 27)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    Bb = 16
    V, N = Bb * A2, Bb * h * w
    T = V * h * w
    plan = common.mm_site_plan(True, frozenset())          # LFT_MM_HP_SITES=none
    prefix = "altblock.0.spa_trans."
    src, rep = "lft_torch/csrc/spa_block.cu", "lft_tpu/kernels/spa_block.py:309"
    to_vm = lambda t: t.permute(0, 3, 1, 2, 4).reshape(V, h, w, C).contiguous()
    to_pm = lambda t: t.reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
    tup = lambda o: o if isinstance(o, tuple) else (o,)
    rows, turns = [], []

    def nearest(name, what, fn):
        """The nearest library calls (on bf16 copies cast before), timed
        beside a kernel that no one library call computes."""
        print(f"  {name}: nearest library calls, {what}: {events_ms(fn, 10):.4f} ms (bf16, "
              f"CUDA events)", flush=True)

    def repeats(name, fn, got):
        same = all(torch.equal(a_, b_) for a_, b_ in zip(tup(got), tup(fn())))
        print(f"  {name}: repeated bitwise: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} does not repeat bitwise")

    def k11_chain(x, pe_tok, p, form, pl):
        """K11 on x through the entry point: its launches, the chain against
        view-major K2's same instances on a permuted copy (bitwise)."""
        names = ("spa_tokenize_ln_pm", "spa_qkv", "spa_window_attn", "spa_outproj_ln",
                 "spa_ffn_out_pm")
        torch.cuda.synchronize()
        reset_launches()
        got = sb.spa_trans_block_fused(x, pe_tok, p, prefix, H, K, pixel_major=True, plan=pl)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        expect = {f"{n}_{form}": 1 for n in names}
        if {k_: c for k_, c in counts.items() if c} != expect:
            raise AssertionError(f"K11 {form}: expected one launch of each of {tuple(expect)}, "
                                 f"got { {k_: c for k_, c in counts.items() if c} }")
        vm = to_pm(sb.spa_trans_block_fused(to_vm(x), pe_tok, p, prefix, H, K, plan=pl))
        same = torch.equal(got, vm)
        print(f"K11 {form} at {list(x.shape)} {str(x.dtype)[6:]}: launches {expect}; bitwise "
              f"view-major K2's {form} chain on a permuted copy: {same}; finite "
              f"{bool(torch.isfinite(got.float()).all())}", flush=True)
        if not same or got.dtype != x.dtype or not torch.isfinite(got.float()).all():
            raise AssertionError(f"K11 {form} disagrees with view-major K2 {form}")
        return counts

    # a: K11 on bf16, then on f32 under the plan
    pb = {k_: v_.to(torch.bfloat16) for k_, v_ in params.items()}
    wsb = sb.spa_weights(pb, prefix)
    ws32b = {k_: v_.float() for k_, v_ in wsb.items()}
    xb = torch.randn(Bb, h, w, A2, C, device=dev, generator=g).to(torch.bfloat16)
    pe_b = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None]
                            .to(torch.bfloat16), wsb["mlp"])[0].contiguous()
    counts_b = k11_chain(xb, pe_b, pb, "bf16io", None)
    rec_b = Recorder(card, counts_b, 1, "K11 call")
    xvb = to_vm(xb)
    tok, xn = sb.tokenize_ln_plain(xvb, pe_b, wsb)
    tok32 = sb.tokenize_ln_plain(xvb.float(), pe_b.float(), ws32b)
    fn_t = lambda xb=xb, pe_b=pe_b, wsb=wsb: sb.tokenize_ln(xb, pe_b, wsb, True)
    got = fn_t()
    rec_b.record("spa_tokenize_ln_pm_bf16io", "lft_torch/csrc/tok_bf16.cuh", rep, got,
                 (tok, xn), fn_t,
                 lambda: sb.tokenize_ln_plain(to_vm(xb), pe_b, wsb),
                 2 * C * D * V * valid_window_pairs(h, w, 1),
                 nbytes(xb, pe_b, tok, xn) + sum(nbytes(wsb[n]) for n in ("wu", "ln")),
                 bf16_products=True, bf16_ref32=tok32)
    repeats("spa_tokenize_ln_pm_bf16io", fn_t, got)
    conv_b = lambda xvb=xvb, wsb=wsb: torch.nn.functional.conv2d(
        xvb.permute(0, 3, 1, 2), wsb["mlp"].reshape(D, C, 3, 3), padding=1)
    nearest("spa_tokenize_ln_pm_bf16io", "its conv part only on a view-major copy, cuDNN's "
            "F.conv2d", conv_b)
    turns.append(("spa_tokenize_ln_pm_bf16io vs spa_tokenize_ln_bf16io",
                  lambda xvb=xvb, pe_b=pe_b, wsb=wsb: sb.tokenize_ln(xvb, pe_b, wsb), fn_t))
    q, k, v = sb.qkv_plain(xn, tok, wsb)
    x2, xn2 = sb.outproj_ln_plain(sb.window_attn_plain(q, k, v, H, K)[0], tok, wsb)
    del q, k, v, tok32
    out = to_pm(sb.ffn_out_plain(xn2, x2, wsb))
    out32 = to_pm(sb.ffn_out_plain(xn2.float(), x2.float(), ws32b))
    fn_o = lambda xn2=xn2, x2=x2, wsb=wsb: sb.ffn_out(xn2, x2, wsb, A2)
    got = fn_o()
    rec_b.record("spa_ffn_out_pm_bf16io", "lft_torch/csrc/ffn_bf16.cuh", rep, got, out, fn_o,
                 lambda: to_pm(sb.ffn_out_plain(xn2, x2, wsb)), 2 * T * (4 * D * D + D * C),
                 nbytes(xn2, x2, out) + sum(nbytes(wsb[n]) for n in ("w1", "w2", "wlin")),
                 bf16_products=True, bf16_ref32=out32)
    repeats("spa_ffn_out_pm_bf16io", fn_o, got)
    hid_b = torch.empty(T, 2 * D, device=dev, dtype=torch.bfloat16)
    ffn_b = lambda xn2=xn2, x2=x2, wsb=wsb: (
        torch.mm(xn2.reshape(-1, D), wsb["w1"], out=hid_b), hid_b @ wsb["w2"],
        x2.reshape(-1, D) @ wsb["wlin"])
    nearest("spa_ffn_out_pm_bf16io", "its three cuBLAS products", ffn_b)
    turns.append(("spa_ffn_out_pm_bf16io vs spa_ffn_out_bf16io",
                  lambda xn2=xn2, x2=x2, wsb=wsb: sb.ffn_out(xn2, x2, wsb), fn_o))
    rows += rec_b.rows
    del got, out, out32

    ws = sb._with_mlp(sb.spa_weights(params, prefix))
    xf = torch.randn(Bb, h, w, A2, C, device=dev, generator=g)
    pe_f = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                            ws["mlp"])[0].contiguous()
    counts_pm = k11_chain(xf, pe_f, params, "bf16", plan)

    # b: the scenes under --dtype mixed with LFT_MM_HP_SITES=none
    n = len(scenes)
    am = dataclasses.replace(args, dtype="mixed")
    with mm_sites("none"):
        cache_m = ScenePipelineCache(forward, am, eval_batch=16)
        torch.cuda.synchronize()
        reset_launches()
        psnr, ssim, per = evaluate_dataset(forward, params, am, scenes, cache=cache_m)
        torch.cuda.synchronize()
        counts_s = dict(LAUNCHES)
        print(f"SR under --dtype mixed, LFT_MM_HP_SITES=none: PSNR {psnr:.6f} dB SSIM {ssim:.6f}; "
              f"per scene {per}; launches { {k_: c for k_, c in counts_s.items() if c} }",
              flush=True)
        wrong = {k_: c for k_, c in counts_s.items()
                 if c != (16 * n if k_ in MIXED_FWD[:6] else 0)}
        if wrong:
            raise AssertionError(f"the mixed none SR run: expected {16 * n} launches of each "
                                 f"`_bf16` forward kernel and no other, got {wrong}")
        plain = ScenePipelineCache(forward, am, eval_batch=16, plain_blocks=True)
        for i, (lr_np, hr_np) in enumerate(scenes):
            lr_t, hr_t = torch.from_numpy(lr_np).to(dev), torch.from_numpy(hr_np).to(dev)
            sr_k, sr_p, sr_f = cache_m(params, lr_t), plain(params, lr_t), cache(params, lr_t)
            again = cache_m(params, lr_t)
            if sr_k.dtype != torch.float32 or sr_k.shape != sr_f.shape \
                    or not torch.isfinite(sr_k).all():
                raise AssertionError(f"bad mixed SR mosaic {sr_k.dtype} {tuple(sr_k.shape)}")
            gap_k, gap_p, d = l2_rel(sr_k, sr_f), l2_rel(sr_p, sr_f), l2_rel(sr_k, sr_p)
            p_k, p_p, p_f = (float(cal_metrics(hr_t, t_, args.angRes)[0])
                             for t_ in (sr_k, sr_p, sr_f))
            print(f"scene {i} under mixed none: kernels vs the plain blocks dPSNR "
                  f"{p_k - p_p:+.3e} dB (limit 0.01), L2 {d:.3e}; distance from the f32 scene: "
                  f"kernels {gap_k:.3e}, plain blocks {gap_p:.3e} ({gap_k / gap_p:.4f}, limit 1 "
                  f"+- 0.1; L2 {d / gap_p:.4f} of it, limit 1.5); repeated bitwise "
                  f"{torch.equal(sr_k, again)}; dPSNR against f32 {p_k - p_f:+.5f} dB", flush=True)
            if abs(p_k - p_p) > 0.01 or abs(gap_k / gap_p - 1) > 0.1 or d > 1.5 * gap_p \
                    or not torch.equal(sr_k, again):
                raise AssertionError(f"scene {i}: the mixed none kernels disagree with the "
                                     f"plain blocks")
        del plain
        lr0 = torch.from_numpy(scenes[0][0]).to(dev)
        scene_fns = (("f32", lambda: cache(params, lr0)), ("none", lambda: cache_m(params, lr0)))

    # c: the eight `_bf16` kernels against their plain versions under the plan
    rec = Recorder(card, counts_s, n, "scene")
    rec_pm = Recorder(card, counts_pm, 1, "K11 call")
    wbytes = lambda *k_: sum(nbytes(ws[n_]) for n_ in k_)

    def check(name, fn, plain_fn, ins, flops, io, recorder=rec, lib=None, **kw):
        got, ref, ref32 = fn(*ins, plan=plan), plain_fn(*ins, plan=plan), plain_fn(*ins)
        recorder.record(name, "lft_torch/csrc/" + kw.pop("src_", "spa_block.cu"),
                        kw.pop("replaces", "lft_tpu/kernels/spa_block.py:352"), tup(got),
                        tup(ref), lambda: fn(*ins, plan=plan),
                        lambda: plain_fn(*ins, plan=plan), flops, io, ref32=tup(ref32),
                        bf16_products=True, timer=events_ms, **kw)
        repeats(name, lambda: fn(*ins, plan=plan), got)
        if lib is not None:
            nearest(name, *lib)
        turns.append((f"{name} vs {name[:-5]}", lambda: fn(*ins), lambda: fn(*ins, plan=plan)))
        return ref

    with torch.no_grad():
        wa = ab.ang_weights(params, "altblock.0.ang_trans.")
        x1 = torch.randn(N, A2, C, device=dev, generator=g)
        pe1 = torch.from_numpy(angular_position(A2, C)).to(dev)
        ang = lambda x_, pe_, wa_, plan=None: ab.ang_block(x_, pe_, wa_, H, plan=plan)
        ang_p = lambda x_, pe_, wa_, plan=None: ab.ang_block_plain(x_, pe_, wa_, H, plan=plan)
        tok1 = x1.reshape(-1, C).to(torch.bfloat16)
        hid1, wab = torch.cat([tok1, tok1], 1), {k_: v_.to(torch.bfloat16) for k_, v_ in wa.items()}
        check("ang_block_bf16", ang, ang_p, (x1, pe1, wa), 2 * N * A2 * 8 * C * C,
              nbytes(x1, pe1, x1, *wa.values()), src_="ang_bf16.cuh",
              replaces="lft_tpu/kernels/ang_block.py:188", fp32_flops=4 * N * A2 * A2 * C,
              lib=("its six cuBLAS products",
                   lambda: [tok1 @ wab[n_] for n_ in ("wq", "wk", "wv", "wo", "w1")]
                   + [hid1 @ wab["w2"]]))
        del x1, tok1, hid1
        ang_bf16_width_checks(g, plan)
        xs = torch.randn(V, h, w, C, device=dev, generator=g)
        bf = lambda t_: t_.to(torch.bfloat16)
        wsb = {k_: bf(v_) for k_, v_ in ws.items()}
        conv = ("its conv part only, cuDNN's F.conv2d",
                lambda xsb=bf(xs): torch.nn.functional.conv2d(
                    xsb.permute(0, 3, 1, 2), wsb["mlp"].reshape(D, C, 3, 3), padding=1))
        tok, xn = check("spa_tokenize_ln_bf16", sb.tokenize_ln, sb.tokenize_ln_plain,
                        (xs, pe_f, ws), 2 * C * D * V * valid_window_pairs(h, w, 1),
                        nbytes(xs, pe_f) + 2 * T * D * 4 + wbytes("wu", "ln"), lib=conv,
                        src_="tok_bf16.cuh")
        tok_bf16_width_checks(g, plan)
        q, k, v = check("spa_qkv_bf16", sb.qkv, sb.qkv_plain, (xn, tok, ws), 2 * T * D * 3 * D,
                        nbytes(xn, tok) + 3 * T * D * 4 + wbytes("wqk", "wv"),
                        lib=("its two cuBLAS products", lambda xnb=bf(xn), tokb=bf(tok): (
                            xnb @ wsb["wqk"], tokb @ wsb["wv"])))
        win = lambda *a_, plan=None: sb.window_attn(*a_, H, K, plan=plan)
        win_p = lambda *a_, plan=None: sb.window_attn_plain(*a_, H, K, plan=plan)[0]
        mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
        heads = lambda t_: t_.reshape(V, h * w, H, D // H).transpose(1, 2).to(torch.bfloat16)
        qh, kh, vh = heads(q), heads(k), heads(v)
        pairs = V * valid_window_pairs(h, w, K // 2)
        attn = check("spa_window_attn_bf16", win, win_p, (q, k, v), 4 * D * pairs,
                     nbytes(q, k, v, q),
                     lib_fn=lambda: torch.nn.functional.scaled_dot_product_attention(
                         qh, kh, vh, attn_mask=mask))
        del qh, kh, vh, q, k, v
        x2, xn2 = check("spa_outproj_ln_bf16", sb.outproj_ln, sb.outproj_ln_plain,
                        (attn, tok, ws), 2 * T * D * D,
                        nbytes(attn, tok) + 2 * T * D * 4 + wbytes("wo", "ln"),
                        lib=("its cuBLAS product with the residual (addmm, no LN2)",
                             lambda ab_=bf(attn), tb=bf(tok): torch.addmm(
                                 tb.reshape(-1, D), ab_.reshape(-1, D), wsb["wo"])))
        ffn = ("its three cuBLAS products", lambda xb_=bf(xn2), x2b=bf(x2): (
            torch.mm(xb_.reshape(-1, D), wsb["w1"], out=hid_b), hid_b @ wsb["w2"],
            x2b.reshape(-1, D) @ wsb["wlin"]))
        check("spa_ffn_out_bf16", sb.ffn_out, sb.ffn_out_plain, (xn2, x2, ws),
              2 * T * (4 * D * D + D * C), nbytes(xn2, x2) + T * C * 4
              + wbytes("w1", "w2", "wlin"), lib=ffn, src_="ffn_bf16.cuh")
        # K11's two on the f32 buffer: x pixel-major, the output pixel-major
        tokp = lambda x_, pe_, ws_, plan=None: sb.tokenize_ln(x_, pe_, ws_, True, plan=plan)
        tokp_p = lambda x_, pe_, ws_, plan=None: sb.tokenize_ln_plain(to_vm(x_), pe_, ws_, plan)
        check("spa_tokenize_ln_pm_bf16", tokp, tokp_p, (xf, pe_f, ws),
              2 * C * D * V * valid_window_pairs(h, w, 1),
              nbytes(xf, pe_f) + 2 * T * D * 4 + wbytes("wu", "ln"), replaces=rep,
              recorder=rec_pm, lib=conv, src_="tok_bf16.cuh")
        ffp = lambda a_, b_, ws_, plan=None: sb.ffn_out(a_, b_, ws_, A2, plan=plan)
        ffp_p = lambda a_, b_, ws_, plan=None: to_pm(sb.ffn_out_plain(a_, b_, ws_, plan))
        check("spa_ffn_out_pm_bf16", ffp, ffp_p, (xn2, x2, ws), 2 * T * (4 * D * D + D * C),
              nbytes(xn2, x2) + T * C * 4 + wbytes("w1", "w2", "wlin"), replaces=rep,
              recorder=rec_pm, lib=ffn, src_="ffn_bf16.cuh")
        rows += rec.rows + rec_pm.rows
        del xs, tok, xn, attn, x2, xn2, xf, conv, ffn, wsb

        # d: a train step and a forward under a site subset of the backward
        # plan run (ROADMAP 9h-b, step 30), each launch named by `card_plan`
        a4 = Args(angRes=5, scale_factor=4, channels=64, batch_size=1, train_fused="true",
                  dtype="mixed")
        lr_t = torch.rand(1, 1, 160, 160, device=dev, generator=g)
        hr_t = torch.rand(1, 1, 640, 640, device=dev, generator=g)
    spec = "qk,ffn"
    for what, grad in (("a train step", True), ("a forward", False)):
        with mm_sites("none"), mm_sites(spec, "LFT_MM_HP_BWD_SITES"):
            bplan = common.active(common.mm_site_plan(True, common.mm_hp_sites(
                "LFT_MM_HP_BWD_SITES", "none")))
            torch.cuda.synchronize()
            reset_launches()
            if grad:
                pg = {k_: v_.detach().clone().requires_grad_(True) for k_, v_ in params.items()}
                loss = make_train_step(get_model(a4), make_optimizer(pg, a4, 10), a4)(pg, lr_t,
                                                                                      hr_t)[0]
                want = step_launches(plan, bplan, "ang_block_bwd")
            else:
                with torch.no_grad():
                    loss = forward(params, lr_t, a4).mean()
                want = {k_ + "_bf16": 4 for k_ in FORWARD}
            torch.cuda.synchronize()
            got = {k_: c for k_, c in LAUNCHES.items() if c}
            print(f"{what} under LFT_MM_HP_SITES=none, LFT_MM_HP_BWD_SITES={spec}: "
                  f"{float(loss):.6f}; launches {got}", flush=True)
            if got != want or not math.isfinite(float(loss)):
                raise AssertionError(f"{what} under LFT_MM_HP_BWD_SITES={spec}: expected {want}, "
                                     f"got {got}")

    # e: in turns, CUDA events around back-to-back calls (late in the process)
    print(f"{card_line()}: ms of each new instance beside its f32 (or view-major `_bf16io`) "
          f"instance on the same inputs, in turns (other, new, new, other; CUDA events around "
          f"20 back-to-back calls):", flush=True)
    for name, other_fn, new_fn in turns:
        t_ = [events_ms(other_fn), events_ms(new_fn), events_ms(new_fn), events_ms(other_fn)]
        print(f"  {name}: other {t_[0]:.4f} / {t_[3]:.4f} ms, new {t_[1]:.4f} / {t_[2]:.4f} ms "
              f"(new / other {(t_[1] + t_[2]) / (t_[0] + t_[3]):.3f})", flush=True)
    turns.clear()
    with mm_sites("none"):
        busy = []
        for what, fn in scene_fns + scene_fns[::-1]:
            kt = kernel_times(fn, 3)
            busy.append((what, sum(ms for ms, _ in kt.values()) if kt else None,
                         events_ms(fn, 3)))
    print(f"{card_line()}: scene 0, in turns f32 / none / none / f32 (device busy: the "
          f"kernels of a profiler trace of 3 scenes; CUDA events around 3 back-to-back "
          f"scenes): " + "; ".join(
              f"{w_} CUDA events {e_:.2f} ms, device busy " + (
                  "not measured (every trace lost kernel records)" if d_ is None else
                  f"{d_:.2f} ms, idle share {1 - d_ / e_:.3f}") for w_, d_, e_ in busy),
          flush=True)
    return rows


# The sites of the 14 weight gradients of an AltFilter block's backward, in
# `wgrad` call order (spa_block._bwd, ang_block._bwd): each takes its
# `_bf16` instance where its site rounds.
WGRAD_SITES = ("tok", "qk", "qk", "v", "wo", "ffn", "ffn", "lin", "aqkv", "aqkv", "aqkv", "awo",
               "affn", "affn")


def step_launches(plan, bplan, k4: str) -> dict:
    """The launches of one fused train step of the 4-block model under the
    forward plan `plan` and the backward plan `bplan`, each kernel named as
    the wrappers name it (`common.card_plan`): K1 res, K2's five steps (the
    window step's `_res` form), K3's five and K4 (`k4`: its form at the
    step's view count) 4 times each, the 14 weight gradients of each block
    pair at their sites' instances and 16 `colsum`s."""
    from lft_torch.kernels import common
    names = common.card_plan(plan, bplan)
    want = {names[k]: 4 for k in ("ang_block_res", "spa_tokenize_ln", "spa_qkv",
                                  "spa_window_attn_res", "spa_outproj_ln", "spa_ffn_out",
                                  "spa_ffn_out_bwd", "spa_ln_qkv", "spa_window_attn_bwd",
                                  "spa_qkv_ln_bwd", "spa_tokenize_bwd", k4)}
    nb = sum(common.rounds(bplan, s_) for s_ in WGRAD_SITES)
    want.update({k: 4 * c for k, c in (("wgrad_bf16", nb), ("wgrad", len(WGRAD_SITES) - nb))
                 if c})
    want["colsum"] = 16
    return want


def none_train_phase(params, seed: int, bwd: str = "none", steps: int = 2, ang_res: int = 5,
                     patch: int = 32, fwd: str = "none"):
    """Step 28 a-d: the fused train step of the 4x recipe under `--dtype
    mixed` with LFT_MM_HP_SITES=`fwd` (step 29 c: a site subset, whose
    forward launches each step's instance as `common.card_fwd` names it)
    and LFT_MM_HP_BWD_SITES=`bwd` (step 30: a site subset, whose backward
    launches each kernel's instance as `common.card_bwd` names it) through
    the kernels against the same step through the plain blocks under the
    same plans, at the bf16 training limits (BF16T_LOSS, BF16T_TOL,
    BF16T_L2: the gradient as one vector under the smooth loss, against
    the plain f32 step), its bitwise repeat and its launches a step: K1 res
    and K2.3 res as `_bf16` (`kernels.MIXED_TRAIN`), K2's other steps as
    theirs, no f32 forward; the backward's `_bf16` instances under `none`,
    its f32 kernels under `all` (K4 as its `_dp` instance: step b forms D
    from its own p, as lft_tpu's does, where the saved attn is the rounded
    forward's). Returns (the launch counts, their steps)."""
    import dataclasses
    import functools

    import torch
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.kernels import LAUNCHES, common, reset_launches
    from lft_torch.models.lft import forward
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    with mm_sites(fwd), mm_sites(bwd, "LFT_MM_HP_BWD_SITES"):
        plan = common.active(common.mm_site_plan(True, common.mm_hp_sites()))
        bplan = common.active(common.mm_site_plan(True, common.mm_hp_sites(
            "LFT_MM_HP_BWD_SITES", "none")))
    a32 = Args(angRes=ang_res, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
               gamma=0.5, epoch=50, train_fused="true")
    am = dataclasses.replace(a32, dtype="mixed")
    model = get_model(am)
    plain = dataclasses.replace(model, apply=functools.partial(forward, plain_blocks=True))
    smooth = lambda sr, y: ((sr - y) * torch.cos(3.0 * (sr - y))).mean()
    gen = torch.Generator(device=dev).manual_seed(seed + 28)
    new_batch = lambda: synth_batch(gen, batch=4, ang_res=ang_res, patch=patch, scale=4)
    k4 = "ang_block_bwd128" if ang_res * ang_res > 64 else "ang_block_bwd"
    what = (f"mixed {fwd} train, backward plan {bwd} ({ang_res}x{ang_res} views, patch "
            f"{patch})")
    lr, hr = new_batch()

    def step(m, args, loss=None):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        fn = make_train_step(m if loss is None else dataclasses.replace(m, loss=loss),
                             make_optimizer(p, args, steps_per_epoch=1000), args)
        out = float(fn(p, lr, hr)[0])
        return out, torch.cat([p[k].grad.reshape(-1) for k in sorted(p)]), p, fn

    with mm_sites(fwd), mm_sites(bwd, "LFT_MM_HP_BWD_SITES"):
        reset_launches()
        loss_p, _, _, _ = step(plain, am)
        _, g_p, _, _ = step(plain, am, smooth)
        _, g_f, _, _ = step(plain, a32, smooth)
        torch.cuda.synchronize()
        if any(LAUNCHES.values()):
            raise AssertionError(f"the plain {what} path launched kernels: {dict(LAUNCHES)}")
        reset_launches()
        loss_k, g_r, p_a, step_a = step(model, am)
        p_a1 = {k_: v.detach().clone() for k_, v in p_a.items()}
        loss_b, g_b, p_b, _ = step(model, am)
        _, g_k, _, _ = step(model, am, smooth)
        for _ in range(steps):
            step_a(p_a, *new_batch())
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    n = 3 + steps
    print(f"{what} step 1: loss kernels {loss_k:.8f} plain {loss_p:.8f} "
          f"(|d| {abs(loss_k - loss_p):.3e}, limit {BF16T_LOSS:g} |loss|)", flush=True)
    if not abs(loss_k - loss_p) <= BF16T_LOSS * abs(loss_p):
        raise AssertionError(f"{what}: the kernel-path loss disagrees with the plain path")
    gap, own, d = l2_rel(g_p, g_f), l2_rel(g_k, g_f), l2_rel(g_k, g_p)
    print(f"{what} step 1 (smooth loss): the gradient's distance from the f32 step's "
          f"{own:.4e}, the plain blocks' {gap:.4e} ({own / gap:.4f}, limit 1 +- {BF16T_TOL:g}); "
          f"L2 from the plain step's gradient {d:.4e} ({d / gap:.4f} of its distance, limit "
          f"{BF16T_L2:g})", flush=True)
    if not (abs(own / gap - 1) <= BF16T_TOL and d <= BF16T_L2 * gap):
        raise AssertionError(f"{what}: the kernel path's gradient disagrees with the plain path")
    same = (loss_b == loss_k and torch.equal(g_r, g_b)
            and all(torch.equal(p_a1[k_], p_b[k_]) for k_ in p_b))
    print(f"{what} step repeated from the same state: loss, grads and params bitwise "
          f"equal: {same}", flush=True)
    if not same:
        raise AssertionError(f"{what}: a repeated kernel-path step is not bitwise equal")
    print(f"launches in the {what} run ({n} kernel-path steps): "
          f"{ {k_: v for k_, v in counts.items() if v} }", flush=True)
    want = {k_: c * n for k_, c in step_launches(plan, bplan, k4).items()}
    wrong = {k_: counts[k_] for k_ in LAUNCHES if counts[k_] != want.get(k_, 0)}
    if wrong:
        raise AssertionError(f"{what} steps: expected {want} and no other launch (no f32 "
                             f"forward step), got {wrong}")
    return counts, n


def none_kernel_checks(params, card: str, runs: dict, seed: int) -> list:
    """Step 28 e: K1 res and K2.3 res in their `_bf16` forms against their
    plain versions under the plan at the step's shapes ([4096, 25, 64];
    q, k, v [100, 32, 32, 128] from the plain K2.1 and K2.2 under the plan
    with block 0's weights): out and attn within MIXED_REL and MIXED_GAP of
    the plain mixed-vs-f32 distance and BF16T_ULPS bf16 ulps of max |plain|,
    attn of bf16 values (K2.3 res's: bf16(the serving `_bf16` kernel's attn)
    bit for bit), out K1 `_bf16`'s bit for bit; m and l within MIXED_REL
    (L2) of the plain version's (q and k round to bf16 in both, so an f32
    sum in another order flips a rounding now and then); a bitwise repeat;
    timed by CUDA events beside the bound (f32 bytes, the products at the
    bf16 rate), then in turns with the f32 `_res` form. K4's `_dp` instance
    at [4096, 25, 64] and [1024, 81, 64] from K1 res `_bf16`'s residuals
    against its plain version (`d_from_p`) within TRAIN_REL, a bitwise
    repeat, beside the f32 instance in turns. `runs`: kernel -> (launch
    counts, steps) of the run that launched it. Returns the four rows of the
    `kernels` line."""
    import torch
    from lft_torch.kernels import common
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.attention import local_window_mask
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import events_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 280)
    C, A2, H, K = 64, 25, 8, 5
    D = 2 * C
    N, V, h, w = 4096, 100, 32, 32
    plan = common.mm_site_plan(True, frozenset())          # LFT_MM_HP_SITES=none
    recs = {k_: Recorder(card, c_, n_, "step") for k_, (c_, n_) in runs.items()}
    turns = []

    def extra(name, got, ref, stats, stats_ref):
        ulps = max(float((g_ - r_).abs().max()) / 2.0 ** (
            math.floor(math.log2(float(r_.abs().max()))) - 7) for g_, r_ in zip(got, ref))
        d_s = [l2_rel(g_, r_) for g_, r_ in zip(stats, stats_ref)]
        attn = got[-1]
        rounded = torch.equal(attn, common.bf16_round(attn))
        print(f"  {name}: out/attn at most {ulps:.2f} bf16 ulps of max |plain| (limit "
              f"{BF16T_ULPS:g}); m, l L2 {d_s[0]:.3e}, {d_s[1]:.3e} from the plain version's "
              f"(limit {MIXED_REL:g}); attn holds bf16 values: {rounded}", flush=True)
        if ulps > BF16T_ULPS or max(d_s) > MIXED_REL or not rounded:
            raise AssertionError(f"{name} disagrees with its plain version")

    with torch.no_grad():
        wa = ab.ang_weights(params, "altblock.0.ang_trans.")
        x = torch.randn(N, A2, C, device=dev, generator=g)
        pe = torch.from_numpy(angular_position(A2, C)).to(dev)
        fn = lambda x=x, pe=pe: ab.ang_block(x, pe, wa, H, with_res=True, plan=plan)
        out, m, l, attn = fn()
        out_p, m_p, l_p, attn_p = ab.ang_block_plain(x, pe, wa, H, with_res=True, plan=plan)
        out32, _, _, attn32 = ab.ang_block_plain(x, pe, wa, H, with_res=True)
        recs["ang_block_res_bf16"].record("ang_block_res_bf16", "lft_torch/csrc/ang_bf16.cuh",
                   "lft_tpu/kernels/ang_block.py:233", (out, attn), (out_p, attn_p), fn,
                   lambda: ab.ang_block_plain(x, pe, wa, H, with_res=True, plan=plan),
                   2 * N * A2 * 8 * C * C, nbytes(x, pe, out, m, l, attn, *wa.values()),
                   ref32=(out32, attn32), bf16_products=True, fp32_flops=4 * N * A2 * A2 * C,
                   timer=events_ms)
        extra("ang_block_res_bf16", (out, attn), (out_p, attn_p), (m, l), (m_p, l_p))
        same = (all(torch.equal(a_, b_) for a_, b_ in zip((out, m, l, attn), fn()))
                and torch.equal(out, ab.ang_block(x, pe, wa, H, plan=plan)))
        print(f"  ang_block_res_bf16: repeated bitwise, out bitwise ang_block_bf16's: {same}",
              flush=True)
        if not same:
            raise AssertionError("ang_block_res_bf16 does not repeat, or its out is not "
                                 "ang_block_bf16's")
        turns.append(("ang_block_res_bf16 vs ang_block_res",
                      lambda x=x, pe=pe: ab.ang_block(x, pe, wa, H, with_res=True), fn))
        del out, m, l, attn, out_p, m_p, l_p, attn_p, out32, attn32

        ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
        xs = torch.randn(V, h, w, C, device=dev, generator=g)
        pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                                  ws["mlp"])[0].contiguous()
        tok, xn = sb.tokenize_ln_plain(xs, pe_tok, ws, plan)
        q, k, v = sb.qkv_plain(xn, tok, ws, plan)
        del xs, tok, xn
        fn = lambda q=q, k=k, v=v: sb.window_attn(q, k, v, H, K, with_stats=True, plan=plan)
        attn, m, l = fn()
        attn_p, m_p, l_p = sb.window_attn_plain(q, k, v, H, K, plan, res=True)
        attn32 = sb.window_attn_plain(q, k, v, H, K)[0]
        mask = torch.from_numpy(local_window_mask(h, w, K) == 0).to(dev)
        heads = lambda t_: t_.reshape(V, h * w, H, D // H).transpose(1, 2).to(torch.bfloat16)
        qh, kh, vh = heads(q), heads(k), heads(v)
        recs["spa_window_attn_res_bf16"].record("spa_window_attn_res_bf16",
                                                "lft_torch/csrc/spa_block.cu",
                   "lft_tpu/kernels/spa_block.py:339", (attn,), (attn_p,), fn,
                   lambda: sb.window_attn_plain(q, k, v, H, K, plan, res=True),
                   4 * D * V * valid_window_pairs(h, w, K // 2), nbytes(q, k, v, attn, m, l),
                   ref32=(attn32,), bf16_products=True, timer=events_ms,
                   lib_fn=lambda: torch.nn.functional.scaled_dot_product_attention(
                       qh, kh, vh, attn_mask=mask))
        extra("spa_window_attn_res_bf16", (attn,), (attn_p,), (m, l), (m_p, l_p))
        same = (all(torch.equal(a_, b_) for a_, b_ in zip((attn, m, l), fn()))
                and torch.equal(attn, common.bf16_round(sb.window_attn(q, k, v, H, K,
                                                                        plan=plan))))
        print(f"  spa_window_attn_res_bf16: repeated bitwise, attn bitwise bf16(the serving "
              f"spa_window_attn_bf16's): {same}", flush=True)
        if not same:
            raise AssertionError("spa_window_attn_res_bf16 does not repeat, or its attn is not "
                                 "the serving kernel's rounded")
        turns.append(("spa_window_attn_res_bf16 vs spa_window_attn_res",
                      lambda q=q, k=k, v=v: sb.window_attn(q, k, v, H, K, with_stats=True), fn))
        del qh, kh, vh, attn_p, m_p, l_p, attn32, q, k, v

        for name, N_, A2_ in (("ang_block_bwd_dp", 4096, 25), ("ang_block_bwd128_dp", 1024, 81)):
            T = N_ * A2_
            x = torch.randn(N_, A2_, C, device=dev, generator=g)
            pe = torch.from_numpy(angular_position(A2_, C)).to(dev)
            dout = torch.randn(N_, A2_, C, device=dev, generator=g)
            res = ab.ang_block(x, pe, wa, H, with_res=True, plan=plan)[1:]
            fns = lambda x, pe, res, dout: (
                lambda: ab.ang_block_bwd_ops(x, pe, wa, *res, dout, H, d_from_p=True),
                lambda: ab.ang_block_bwd_ops_plain(x, pe, wa, *res, dout, H, d_from_p=True),
                lambda: ab.ang_block_bwd_ops(x, pe, wa, *res, dout, H))
            kern, plain, _ = fns(x, pe, res, dout)
            dout = calm_relu(dout, kern()[8], plain()[8], f"{name} at A2 = {A2_}")
            kern, plain, f32_fn = fns(x, pe, res, dout)
            got, ref = kern(), plain()
            recs[name].record(name, "lft_torch/csrc/ang_block.cu",
                              "lft_tpu/kernels/ang_block.py:477", (*got[:-1], got[-1].sum(0)),
                              (*ref[:-1], ref[-1][0]), kern, plain, 28 * T * C * C,
                              nbytes(x, pe, *res, dout, *ref[:-1])
                              + 2 * sum(nbytes(t) for t in wa.values()), rel=TRAIN_REL,
                              slow_reps=10 if A2_ <= 64 else 3, tf32_products=3,
                              fp32_flops=10 * C * T * A2_, timer=events_ms)
            same = all(torch.equal(a_, b_) for a_, b_ in zip(got, kern()))
            print(f"  {name}: repeated bitwise: {same}", flush=True)
            if not same:
                raise AssertionError(f"{name} does not repeat bitwise")
            turns.append((f"{name} vs {name[:-3]}", f32_fn, kern))
            del got, ref
        print(f"{card_line()}: ms of each new form beside its f32 `_res` form on the same "
              f"inputs, in turns (f32, new, new, f32; CUDA events around 20 back-to-back "
              f"calls):", flush=True)
        for name, f32_fn, new_fn in turns:
            t_ = [events_ms(f32_fn), events_ms(new_fn), events_ms(new_fn), events_ms(f32_fn)]
            print(f"  {name}: f32 {t_[0]:.4f} / {t_[3]:.4f} ms, new {t_[1]:.4f} / {t_[2]:.4f} ms "
                  f"(new / f32 {(t_[1] + t_[2]) / (t_[0] + t_[3]):.3f})", flush=True)
    return [r_ for rec in recs.values() for r_ in rec.rows]


def none_step_times(params, seed: int) -> None:
    """Step 28 g: the fused mixed train step's ms under LFT_MM_HP_SITES=none
    beside `all`, in turns (all, none, none, all), 3 steps each after a
    warm-up, CUDA events (late in the process the profiler loses records)."""
    import torch
    from lft_torch.config import Args
    from lft_torch.data.device_synth import synth_batch
    from lft_torch.registry import get_model
    from lft_torch.training.optim import make_optimizer
    from lft_torch.training.trainer import make_train_step

    dev = torch.device("cuda")
    args = Args(angRes=5, scale_factor=4, channels=64, batch_size=4, lr=2e-4, n_steps=15,
                gamma=0.5, epoch=50, train_fused="true", dtype="mixed")
    lr, hr = synth_batch(torch.Generator(device=dev).manual_seed(seed + 29), batch=4, ang_res=5,
                         patch=32, scale=4)
    fns = {}
    for spec in ("all", "none"):
        p = {k_: v.detach().clone().requires_grad_(True) for k_, v in params.items()}
        fns[spec] = (p, make_train_step(get_model(args), make_optimizer(p, args, 1000), args))
    times = {"all": [], "none": []}
    for spec in ("all", "none", "none", "all"):
        p, fn = fns[spec]
        with mm_sites(spec):
            fn(p, lr, hr)                                # warm-up
            for _ in range(3):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                fn(p, lr, hr)
                ev1.record()
                ev1.synchronize()
                times[spec].append(ev0.elapsed_time(ev1))
    med = {k_: sorted(v)[len(v) // 2] for k_, v in times.items()}
    print(f"{card_line()}: fused mixed train step, batch 4 of 32x32-view patches, 5x5 views, 4x, "
          f"C=64, in turns LFT_MM_HP_SITES=all, none, none, all (3 steps each, CUDA events): "
          f"median {med['all']:.3f} ms all, {med['none']:.3f} ms none (all "
          f"{[round(t, 3) for t in times['all']]}, none "
          f"{[round(t, 3) for t in times['none']]})", flush=True)


def ssim_tf32_check(seed: int) -> None:
    """Step 28 h: SSIM of a 5x5x32^2 pair under `--matmul_precision high`
    (TF32 on for cuDNN) equals SSIM under `highest` bit for bit: its filter
    runs in full f32 whatever the flag (lft_tpu's at HIGHEST)."""
    import torch
    from lft_torch import device as port_device
    from lft_torch.ops.metrics import cal_metrics

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 30)
    label = torch.rand(160, 160, device=dev, generator=g)
    out = (label + 0.05 * torch.randn(160, 160, device=dev, generator=g)).clamp(0, 1)
    before = port_device._precision or "highest"
    try:
        res = {}
        for prec in ("high", "highest"):
            port_device.resolve_device(dev, prec)
            res[prec] = cal_metrics(label, out, 5)
            if torch.backends.cudnn.allow_tf32 != (prec == "high"):
                raise AssertionError(f"SSIM changed the cuDNN TF32 flag under {prec}")
    finally:
        port_device.resolve_device(dev, before)
    same = all(torch.equal(a_, b_) for a_, b_ in zip(res["high"], res["highest"]))
    print(f"SSIM of a 5x5x32^2 pair: {float(res['high'][1]):.9f} under --matmul_precision high, "
          f"{float(res['highest'][1]):.9f} under highest; bitwise equal (PSNR too): {same}",
          flush=True)
    if not same:
        raise AssertionError("SSIM under --matmul_precision high differs from highest")


def none_train_steps(params, card: str, seed: int) -> list:
    """Step 28: `--dtype mixed` training under LFT_MM_HP_SITES=none (module
    docstring). Returns the four rows of the `kernels` line."""
    from lft_torch.kernels import MIXED, MIXED_TRAIN
    run_a = none_train_phase(params, seed)
    run_b = none_train_phase(params, seed, bwd="all", steps=0)
    none_train_phase(params, seed, steps=2, ang_res=9, patch=16)
    run_c = none_train_phase(params, seed, bwd="all", steps=0, ang_res=9, patch=16)
    rows = none_kernel_checks(params, card, {
        "ang_block_res_bf16": run_a, "spa_window_attn_res_bf16": run_a,
        "ang_block_bwd_dp": run_b, "ang_block_bwd128_dp": run_c}, seed)
    per_step = {k: 4 for k in MIXED_TRAIN[:2] + ("spa_tokenize_ln_bf16", "spa_qkv_bf16",
                                                 "spa_outproj_ln_bf16", "spa_ffn_out_bf16",
                                                 "ang_block_bwd_bf16")}
    per_step.update({k: 4 for k in MIXED if k.startswith("spa_")}, wgrad_bf16=56)
    with mm_sites("none"):
        train_cli_resume(params, seed, "mixed", per_step,
                         ("ang_block_res", "spa_window_attn_res", "spa_qkv", "wgrad"))
    none_step_times(params, seed)
    ssim_tf32_check(seed)
    return rows


# The two complementary site subsets of step 29 (tests/_torch_sites_ref.py):
# S1 keeps these sites f32 and rounds the rest, S2 the other way round.
SITES_S1 = "qk,score,ffn,aqkv,aav,wo"
SITES_S2 = "tok,v,av,lin,ascore,awo,affn"


def sites_phase(params, args, scenes, cache, card: str, seed: int) -> list:
    """Step 29: `--dtype mixed` under the LFT_MM_HP_SITES subsets S1 and S2
    (module docstring). Returns the seven rows of the `kernels` line, each
    from S1's run of its path (the scenes; the train step for the `_res`
    forms; a K11 call for `spa_ffn_out_pm_sites`)."""
    import dataclasses

    import torch
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import FORWARD, LAUNCHES, MIXED_SITES, common, reset_launches
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.models.lft import forward
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import events_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 29)
    C, A2, h, w, H, K = 64, 25, 32, 32, 8, 5
    D = 2 * C
    Bb = 16
    V, N = Bb * A2, Bb * h * w
    T = V * h * w
    plans = {sp: common.mm_site_plan(True, frozenset(sp.split(","))) for sp in
             (SITES_S1, SITES_S2)}
    name_of = {SITES_S1: "S1", SITES_S2: "S2"}
    prefix = "altblock.0.spa_trans."
    tup = lambda o: o if isinstance(o, tuple) else (o,)
    counted = lambda: {k_: c for k_, c in LAUNCHES.items() if c}

    # a: K11 under S1 through the entry point, bitwise view-major K2's chain
    ws = sb._with_mlp(sb.spa_weights(params, prefix))
    xf = torch.randn(Bb, h, w, A2, C, device=dev, generator=g)
    pe_f = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                            ws["mlp"])[0].contiguous()
    s1 = plans[SITES_S1]
    torch.cuda.synchronize()
    reset_launches()
    got = sb.spa_trans_block_fused(xf, pe_f, params, prefix, H, K, pixel_major=True, plan=s1)
    torch.cuda.synchronize()
    counts_pm = dict(LAUNCHES)
    expect = {n_ + common.card_fwd(s1, n_): 1 for n_ in (
        "spa_tokenize_ln_pm", "spa_qkv", "spa_window_attn", "spa_outproj_ln", "spa_ffn_out_pm")}
    to_vm = lambda t: t.permute(0, 3, 1, 2, 4).reshape(V, h, w, C).contiguous()
    vm = sb.spa_trans_block_fused(to_vm(xf), pe_f, params, prefix, H, K, plan=s1)
    same = torch.equal(got, vm.reshape(Bb, A2, h, w, C).permute(0, 2, 3, 1, 4))
    print(f"K11 under S1 at {list(xf.shape)}: launches "
          f"{ {k_: c for k_, c in counts_pm.items() if c} }; bitwise "
          f"view-major K2's S1 chain on a permuted copy: {same}", flush=True)
    if {k_: c for k_, c in counts_pm.items() if c} != expect or not same:
        raise AssertionError(f"K11 under S1: expected {expect} and view-major K2's output")
    del got, vm

    # b: the scenes under each subset
    n = len(scenes)
    am = dataclasses.replace(args, dtype="mixed")
    counts_s = {}
    for spec, plan in plans.items():
        with mm_sites(spec):
            cache_m = ScenePipelineCache(forward, am, eval_batch=16)
            torch.cuda.synchronize()
            reset_launches()
            psnr, ssim, per = evaluate_dataset(forward, params, am, scenes, cache=cache_m)
            torch.cuda.synchronize()
            counts_s[spec] = dict(LAUNCHES)
            print(f"SR under --dtype mixed, LFT_MM_HP_SITES={spec} ({name_of[spec]}): PSNR "
                  f"{psnr:.6f} dB SSIM {ssim:.6f}; per scene {per}; launches {counted()}",
                  flush=True)
            want = {k_ + common.card_fwd(plan, k_): 16 * n for k_ in FORWARD}
            if counted() != want:
                raise AssertionError(f"the {name_of[spec]} SR run: expected {want} and no other "
                                     f"launch, got {counted()}")
            plain = ScenePipelineCache(forward, am, eval_batch=16, plain_blocks=True)
            for i, (lr_np, hr_np) in enumerate(scenes):
                lr_t, hr_t = torch.from_numpy(lr_np).to(dev), torch.from_numpy(hr_np).to(dev)
                sr_k, sr_p, sr_f = cache_m(params, lr_t), plain(params, lr_t), cache(params, lr_t)
                again = cache_m(params, lr_t)
                if sr_k.dtype != torch.float32 or sr_k.shape != sr_f.shape \
                        or not torch.isfinite(sr_k).all():
                    raise AssertionError(f"bad mixed SR mosaic {sr_k.dtype} {tuple(sr_k.shape)}")
                gap_k, gap_p, d = l2_rel(sr_k, sr_f), l2_rel(sr_p, sr_f), l2_rel(sr_k, sr_p)
                p_k, p_p, p_f = (float(cal_metrics(hr_t, t_, args.angRes)[0])
                                 for t_ in (sr_k, sr_p, sr_f))
                print(f"scene {i} under {name_of[spec]}: kernels vs the plain blocks dPSNR "
                      f"{p_k - p_p:+.3e} dB (limit 0.01), L2 {d:.3e}; distance from the f32 "
                      f"scene: kernels {gap_k:.3e}, plain blocks {gap_p:.3e} ({gap_k / gap_p:.4f},"
                      f" limit 1 +- 0.1; L2 {d / gap_p:.4f} of it, limit 1.5); repeated bitwise "
                      f"{torch.equal(sr_k, again)}; dPSNR against f32 {p_k - p_f:+.5f} dB",
                      flush=True)
                if abs(p_k - p_p) > 0.01 or abs(gap_k / gap_p - 1) > 0.1 or d > 1.5 * gap_p \
                        or not torch.equal(sr_k, again):
                    raise AssertionError(f"scene {i}: the {name_of[spec]} kernels disagree with "
                                         f"the plain blocks")
            del plain, cache_m

    # c: the train step under S1, backward plans `none` and `all`
    run_n = none_train_phase(params, seed, fwd=SITES_S1)
    none_train_phase(params, seed, bwd="all", steps=0, fwd=SITES_S1)

    # d: each `_sites` kernel against its plain version, S1's run giving the row
    recs = {SITES_S1: {"scene": Recorder(card, counts_s[SITES_S1], n, "scene"),
                       "step": Recorder(card, run_n[0], run_n[1], "step"),
                       "pm": Recorder(card, counts_pm, 1, "K11 call")},
            SITES_S2: {"scene": Recorder(card, counts_s[SITES_S2], n, "scene"),
                       "step": Recorder(card, counts_s[SITES_S2], n, "scene"),
                       "pm": Recorder(card, counts_pm, 1, "K11 call")}}
    wbytes = lambda *k_: sum(nbytes(ws[n_]) for n_ in k_)
    turns = []

    def check(spec, rec, name, fn, plain_fn, ins, site_flops, io, outs=None, res=None, **kw):
        """One `_sites` kernel under `spec` against its plain version; `outs`:
        the outputs held by `mixed_err` (all by default); `res`: (m, l
        positions, attn position, its site) of a `_res` form."""
        plan = plans[spec]
        got, ref, ref32 = (tup(f_(*ins, plan=p_)) for f_, p_ in ((fn, plan), (plain_fn, plan),
                                                                 (plain_fn, None)))
        pick = lambda t_: t_ if outs is None else tuple(t_[i_] for i_ in outs)
        flops = [(f_, plan[s_]) for f_, s_ in site_flops]
        recs[spec][rec].record(
            name, "lft_torch/csrc/" + kw.pop("src_", "spa_block.cu"),
            kw.pop("replaces", "lft_tpu/kernels/spa_block.py:352"), pick(got), pick(ref),
            lambda: fn(*ins, plan=plan), lambda: plain_fn(*ins, plan=plan),
            sum(f_ for f_, _ in flops), io, ref32=pick(ref32), site_flops=flops,
            timer=events_ms, shape=None if spec == SITES_S1 else (name_of[spec],), **kw)
        if res is not None:   # step 28's limits on a `_res` form
            stats, a_i, site = res
            ulps = max(float((g_ - r_).abs().max()) / 2.0 ** (
                math.floor(math.log2(float(r_.abs().max()))) - 7)
                for g_, r_ in zip(pick(got), pick(ref)))
            d_s = [l2_rel(got[i_], ref[i_]) for i_ in stats]
            rounded = torch.equal(got[a_i], common.bf16_round(got[a_i]))
            print(f"  {name} under {name_of[spec]}: outputs at most {ulps:.2f} bf16 ulps of max "
                  f"|plain| (limit {BF16T_ULPS:g}); m, l L2 {d_s[0]:.3e}, {d_s[1]:.3e} (limit "
                  f"{MIXED_REL:g}); attn holds bf16 values: {rounded} (its site `{site}` "
                  f"rounds: {plan[site]})", flush=True)
            if ulps > BF16T_ULPS or max(d_s) > MIXED_REL or rounded != plan[site]:
                raise AssertionError(f"{name} under {name_of[spec]} disagrees with its plain "
                                     f"version")
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, tup(fn(*ins, plan=plan))))
        print(f"  {name} under {name_of[spec]}: repeated bitwise: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} under {name_of[spec]} does not repeat bitwise")
        if spec == SITES_S1:
            half = common.mm_site_plan(True, frozenset())
            turns.append((name, lambda: fn(*ins), lambda: fn(*ins, plan=half),
                          lambda: fn(*ins, plan=plan)))
        return ref if len(ref) > 1 else ref[0]

    with torch.no_grad():
        wa = ab.ang_weights(params, "altblock.0.ang_trans.")
        x1 = torch.randn(N, A2, C, device=dev, generator=g)
        pe1 = torch.from_numpy(angular_position(A2, C)).to(dev)
        xr = torch.randn(4096, A2, C, device=dev, generator=g)
        ang = lambda x_, pe_, wa_, plan=None: ab.ang_block(x_, pe_, wa_, H, plan=plan)
        ang_p = lambda x_, pe_, wa_, plan=None: ab.ang_block_plain(x_, pe_, wa_, H, plan=plan)
        angr = lambda x_, pe_, wa_, plan=None: ab.ang_block(x_, pe_, wa_, H, True, plan=plan)
        angr_p = lambda x_, pe_, wa_, plan=None: ab.ang_block_plain(x_, pe_, wa_, H, True, plan)
        # K1's six products, then its attention (q k, e v)
        k1_flops = lambda n_: [(2 * n_ * A2 * C * C * 3, "aqkv"), (2 * n_ * A2 * C * C, "awo"),
                               (2 * n_ * A2 * C * C * 4, "affn"), (2 * n_ * A2 * A2 * C, "ascore"),
                               (2 * n_ * A2 * A2 * C, "aav")]
        xs = torch.randn(V, h, w, C, device=dev, generator=g)
        pairs = V * valid_window_pairs(h, w, K // 2)
        win = lambda *a_, plan=None: sb.window_attn(*a_, H, K, plan=plan)
        win_p = lambda *a_, plan=None: sb.window_attn_plain(*a_, H, K, plan=plan)[0]
        winr = lambda *a_, plan=None: sb.window_attn(*a_, H, K, with_stats=True, plan=plan)
        winr_p = lambda *a_, plan=None: sb.window_attn_plain(*a_, H, K, plan, res=True)
        ffp = lambda a_, b_, ws_, plan=None: sb.ffn_out(a_, b_, ws_, A2, plan=plan)
        ffp_p = lambda a_, b_, ws_, plan=None: sb.ffn_out_plain(a_, b_, ws_, plan).reshape(
            Bb, A2, h, w, C).permute(0, 2, 3, 1, 4).contiguous()
        ffn_flops = [(2 * T * 4 * D * D, "ffn"), (2 * T * D * C, "lin")]
        for spec, plan in plans.items():
            print(f"the `_sites` kernels under {name_of[spec]} (LFT_MM_HP_SITES={spec}):",
                  flush=True)
            check(spec, "scene", "ang_block_sites", ang, ang_p, (x1, pe1, wa), k1_flops(N),
                  nbytes(x1, pe1, x1, *wa.values()), src_="ang_sites.cuh",
                  replaces="lft_tpu/kernels/ang_block.py:188")
            Tr = 4096 * A2
            check(spec, "step", "ang_block_res_sites", angr, angr_p, (xr, pe1, wa),
                  k1_flops(4096), nbytes(xr, pe1, xr, xr) + Tr * H * 8
                  + sum(nbytes(t_) for t_ in wa.values()), outs=(0, 3),
                  res=((1, 2), 3, "awo"), src_="ang_sites.cuh",
                  replaces="lft_tpu/kernels/ang_block.py:233")
            tok, xn = sb.tokenize_ln_plain(xs, pe_f, ws, plan)
            q, k, v = check(spec, "scene", "spa_qkv_sites", sb.qkv, sb.qkv_plain, (xn, tok, ws),
                            [(2 * T * D * 2 * D, "qk"), (2 * T * D * D, "v")],
                            nbytes(xn, tok) + 3 * T * D * 4 + wbytes("wqk", "wv"))
            attn = check(spec, "scene", "spa_window_attn_sites", win, win_p, (q, k, v),
                         [(2 * D * pairs, "score"), (2 * D * pairs, "av")], nbytes(q, k, v, q))
            qr, kr, vr = (t_[:100].contiguous() for t_ in (q, k, v))
            check(spec, "step", "spa_window_attn_res_sites", winr, winr_p, (qr, kr, vr),
                  [(2 * D * pairs // 4, "score"), (2 * D * pairs // 4, "av")],
                  nbytes(qr, kr, vr, qr) + 100 * h * w * H * 8, outs=(0,),
                  res=((1, 2), 0, "wo"), replaces="lft_tpu/kernels/spa_block.py:339")
            del q, k, v, qr, kr, vr
            x2, xn2 = sb.outproj_ln_plain(attn, tok, ws, plan)
            del attn, tok, xn
            check(spec, "scene", "spa_ffn_out_sites", sb.ffn_out, sb.ffn_out_plain,
                  (xn2, x2, ws), ffn_flops, nbytes(xn2, x2) + T * C * 4
                  + wbytes("w1", "w2", "wlin"), src_="ffn_sites.cuh")
            check(spec, "pm", "spa_ffn_out_pm_sites", ffp, ffp_p, (xn2, x2, ws), ffn_flops,
                  nbytes(xn2, x2) + T * C * 4 + wbytes("w1", "w2", "wlin"),
                  replaces="lft_tpu/kernels/spa_block.py:309", src_="ffn_sites.cuh")
            del x2, xn2
            ffn_sites_width_checks(plan, name_of[spec], g)
        ang_sites_width_checks(g)

        # e: in turns with the f32 and `_bf16` instances, CUDA events
        print(f"{card_line()}: ms of each `_sites` instance (S1) beside its f32 and `_bf16` "
              f"instances on the same inputs, in turns (f32, bf16, sites, sites, bf16, f32; "
              f"CUDA events around 20 back-to-back calls):", flush=True)
        for name, f32_fn, half_fn, sites_fn in turns:
            t_ = [events_ms(f_) for f_ in (f32_fn, half_fn, sites_fn, sites_fn, half_fn, f32_fn)]
            print(f"  {name}: f32 {t_[0]:.4f} / {t_[5]:.4f} ms, bf16 {t_[1]:.4f} / {t_[4]:.4f} "
                  f"ms, sites {t_[2]:.4f} / {t_[3]:.4f} ms", flush=True)
    rows = [r_ for by in recs[SITES_S1].values() for r_ in by.rows]
    if sorted(r_["name"] for r_ in rows) != sorted(MIXED_SITES):
        raise AssertionError(f"step 29's rows {[r_['name'] for r_ in rows]} are not "
                             f"{MIXED_SITES}")
    return rows


# Step 30's third backward plan: K4's five sites f32, every spatial one
# rounded; after a forward under `none` K4 takes its `_dp` instance.
BWD_K4_F32 = "aqkv,ascore,aav,awo,affn"


def bwd_sites_kernel_checks(params, card: str, runs: dict, seed: int) -> list:
    """Step 30 a and d: each `_sites` instance of the backward (K3.a-K3.d at
    [100, 32, 32, 64], K4 at [4096, 25, 64] and [1024, 81, 64]) under the
    backward subsets S1 and S2 against its plain version under the subset,
    from the plain f32 forward's residuals and the plain chain's inputs
    under the subset: each output within MIXED_REL and MIXED_GAP of the
    plain mixed-vs-f32 distance (step 29's limits; the LN partial sums
    summed), a bitwise repeat, timed by CUDA events beside its bound (f32
    bytes, each product at the bf16 rate where its site rounds and as
    3xTF32 where it does not), S1's run giving the row; then each in turns
    with its f32 and `_bf16` instances. `runs`: kernel -> (launch counts,
    steps) of the S1 train run that launched it."""
    import torch
    from lft_torch.kernels import MIXED_BWD_SITES, common
    from lft_torch.kernels import ang_block as ab
    from lft_torch.kernels import spa_block as sb
    from lft_torch.ops.posenc import angular_position, spatial_position
    from lft_torch.ops.unfold import unfold3x3_linear
    from lft_torch.profile_scene import events_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 300)
    C, h, w, H, K = 64, 32, 32, 8, 5
    D = 2 * C
    V = 100
    T = V * h * w
    plans = {sp: common.mm_site_plan(True, frozenset(sp.split(","))) for sp in
             (SITES_S1, SITES_S2)}
    half = common.mm_site_plan(True, frozenset())
    name_of = {SITES_S1: "S1", SITES_S2: "S2"}
    recs = {k_: Recorder(card, c_, n_, "step") for k_, (c_, n_) in runs.items()}
    rand = lambda *s_: torch.randn(*s_, device=dev, generator=g)
    with_sum = lambda ops: (*ops[:-1], ops[-1].sum(0))
    src_s, rep = "lft_torch/csrc/spa_block_bwd.cu", "lft_tpu/kernels/spa_block.py:602"
    turns = []

    def check(spec, name, src, fn, plain, args, site_flops, io, summed=False, **kw):
        """One `_sites` instance under `spec` against its plain version
        (`fn(*args, plan=)` the wrapper on CUDA tensors)."""
        plan = plans[spec]
        got, ref, ref32 = fn(*args, plan=plan), plain(*args, plan=plan), plain(*args)
        again = fn(*args, plan=plan)
        if summed:
            got, again = with_sum(got), with_sum(again)
            ref, ref32 = ((*r[:-1], r[-1][0]) for r in (ref, ref32))
        flops = [(f_, plan[s_]) for f_, s_ in site_flops]
        recs[name].record(name, src, kw.pop("replaces", rep), got, ref,
                          lambda: fn(*args, plan=plan), lambda: plain(*args, plan=plan),
                          sum(f_ for f_, _ in flops), io, ref32=ref32, site_flops=flops,
                          timer=events_ms, shape=None if spec == SITES_S1 else (name_of[spec],),
                          **kw)
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        print(f"  {name} under {name_of[spec]}: repeated bitwise: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} under {name_of[spec]} does not repeat bitwise")
        if spec == SITES_S1:
            turns.append((name, lambda: fn(*args), lambda: fn(*args, plan=half),
                          lambda: fn(*args, plan=plan)))
        return ref

    ws = sb._with_mlp(sb.spa_weights(params, "altblock.0.spa_trans."))
    wbytes = lambda *k_: sum(nbytes(ws[n_]) for n_ in k_)
    xs = rand(V, h, w, C)
    pe_tok = unfold3x3_linear(torch.from_numpy(spatial_position(h, w, C)).to(dev)[None],
                              ws["mlp"])[0].contiguous()
    _, tok, m, l, attn = sb.spa_block_plain(xs, pe_tok, ws, H, K, with_res=True)
    del xs
    pairs = V * valid_window_pairs(h, w, K // 2)
    wa = ab.ang_weights(params, "altblock.0.ang_trans.")
    for spec in (SITES_S1, SITES_S2):
        plan = plans[spec]
        print(f"the backward's `_sites` kernels under {name_of[spec]} "
              f"(LFT_MM_HP_BWD_SITES={spec}):", flush=True)
        dout = rand(V, h, w, C)
        dout = calm_relu(dout, sb.ffn_out_bwd(attn, tok, dout, ws, plan=plan)[4],
                         sb.ffn_out_bwd_plain(attn, tok, dout, ws, plan=plan)[4],
                         f"spa_ffn_out_bwd_sites under {name_of[spec]}")
        # K3.a: x2 and dattn (wo), the FFN's four (ffn), dy (lin)
        ref = check(spec, "spa_ffn_out_bwd_sites", src_s, sb.ffn_out_bwd, sb.ffn_out_bwd_plain,
                    (attn, tok, dout, ws),
                    [(4 * T * D * D, "wo"), (16 * T * D * D, "ffn"), (2 * T * C * D, "lin")],
                    nbytes(attn, tok, dout) + k3a_out_bytes(T, D)
                    + wbytes("ln", "wo", "w1", "w2", "wlin"), summed=True)
        dx2, dattn = ref[0], ref[1]
        xn, q, k, v = check(spec, "spa_ln_qkv_sites", "lft_torch/csrc/spa_block.cu", sb.ln_qkv,
                            sb.ln_qkv_plain, (tok, pe_tok, ws),
                            [(4 * T * D * D, "qk"), (2 * T * D * D, "v")],
                            nbytes(tok, pe_tok) + 4 * T * D * 4 + wbytes("ln", "wqk", "wv"))
        dq, dk, dv = check(spec, "spa_window_attn_bwd_sites", "lft_torch/csrc/spa_attn_hp.cu",
                           sb.window_attn_bwd, sb.window_attn_bwd_plain,
                           (q, k, v, attn, dattn, m, l, H, K),
                           [(6 * D * pairs, "score"), (4 * D * pairs, "av")],
                           nbytes(q, k, v, dattn, m, l) + 3 * T * D * 4)
        check(spec, "spa_qkv_ln_bwd_sites", src_s, sb.qkv_ln_bwd, sb.qkv_ln_bwd_plain,
              (tok, pe_tok, dq, dk, dv, dx2, ws), [(4 * T * D * D, "qk"), (2 * T * D * D, "v")],
              nbytes(tok, pe_tok, dq, dk, dv, dx2) + 2 * T * D * 4 + wbytes("ln", "wqk", "wv"),
              summed=True)
        del dout, ref, dx2, dattn, xn, q, k, v, dq, dk, dv
        # K4, both forms, from the f32 forward's residuals
        for N, A2, name in ((4096, 25, "ang_block_bwd_sites"),
                            (1024, 81, "ang_block_bwd128_sites")):
            x = rand(N, A2, C)
            pe = torch.from_numpy(angular_position(A2, C)).to(dev)
            res = ab.ang_block_plain(x, pe, wa, H, with_res=True)[1:]
            dout = rand(N, A2, C)
            dout = calm_relu(dout, ab.ang_block_bwd_ops(x, pe, wa, *res, dout, H, plan=plan)[8],
                             ab.ang_block_bwd_ops_plain(x, pe, wa, *res, dout, H, plan=plan)[8],
                             f"{name} under {name_of[spec]}")
            Tk = N * A2
            # a: q, k, v (aqkv), x2 and dattn (awo), the FFN's three (affn); b:
            # s, dp, D (ascore), dq, dk (ascore), dv (aav); c: dxn, dx (aqkv)
            check(spec, name, "lft_torch/csrc/ang_block.cu", ab.ang_block_bwd_ops,
                  ab.ang_block_bwd_ops_plain, (x, pe, wa, *res, dout, H),
                  [(12 * Tk * C * C, "aqkv"), (4 * Tk * C * C, "awo"), (12 * Tk * C * C, "affn"),
                   (6 * Tk * A2 * C, "ascore"), (4 * Tk * A2 * C, "aav")],
                  nbytes(x, pe, *res, dout) + 11 * Tk * C * 4
                  + 2 * sum(nbytes(t_) for t_ in wa.values()),
                  replaces="lft_tpu/kernels/ang_block.py:432" if A2 <= 64 else
                  "lft_tpu/kernels/ang_block.py:477", summed=True,
                  slow_reps=10 if A2 <= 64 else 3)
            del x, pe, res, dout
    del tok, m, l, attn

    print(f"{card_line()}: ms of each backward `_sites` instance (S1) beside its f32 and "
          f"`_bf16` instances on the same inputs, in turns (f32, bf16, sites, sites, bf16, f32; "
          f"CUDA events around 20 back-to-back calls):", flush=True)
    for name, f32_fn, half_fn, sites_fn in turns:
        t_ = [events_ms(f_) for f_ in (f32_fn, half_fn, sites_fn, sites_fn, half_fn, f32_fn)]
        print(f"  {name}: f32 {t_[0]:.4f} / {t_[5]:.4f} ms, bf16 {t_[1]:.4f} / {t_[4]:.4f} ms, "
              f"sites {t_[2]:.4f} / {t_[3]:.4f} ms", flush=True)
    turns.clear()
    rows = [r_ for rec in recs.values() for r_ in rec.rows]
    if sorted(r_["name"] for r_ in rows) != sorted(MIXED_BWD_SITES):
        raise AssertionError(f"step 30's rows {[r_['name'] for r_ in rows]} are not "
                             f"{MIXED_BWD_SITES}")
    return rows


def bwd_sites_phase(params, card: str, seed: int) -> list:
    """Step 30: `--dtype mixed` training under LFT_MM_HP_BWD_SITES subsets
    (module docstring). Returns the six rows of the `kernels` line, each
    from the S1 train run that launched it (K4's 128-row form: angRes 9)."""
    from lft_torch.kernels import common
    # b: the fused train step under three pairs of plans, and S1 at angRes 9
    run_1 = none_train_phase(params, seed, bwd=SITES_S1)
    none_train_phase(params, seed, bwd=SITES_S2, steps=0, fwd=SITES_S2)
    none_train_phase(params, seed, bwd=BWD_K4_F32, steps=0)
    run_9 = none_train_phase(params, seed, bwd=SITES_S1, steps=0, ang_res=9, patch=16)
    # c: the train CLI under (none, S1), resumed bitwise
    half = common.mm_site_plan(True, frozenset())
    s1 = common.mm_site_plan(True, frozenset(SITES_S1.split(",")))
    with mm_sites("none"), mm_sites(SITES_S1, "LFT_MM_HP_BWD_SITES"):
        train_cli_resume(params, seed, "mixed", step_launches(half, s1, "ang_block_bwd"),
                         ("spa_ffn_out_bwd", "spa_ffn_out_bwd_bf16", "ang_block_bwd",
                          "ang_block_bwd_bf16", "ang_block_bwd_dp"))
    # a, d: the kernels against their plain versions, then in turns
    runs = {k_: run_1 for k_ in ("spa_ffn_out_bwd_sites", "spa_ln_qkv_sites",
                                 "spa_window_attn_bwd_sites", "spa_qkv_ln_bwd_sites",
                                 "ang_block_bwd_sites")}
    runs["ang_block_bwd128_sites"] = run_9
    return bwd_sites_kernel_checks(params, card, runs, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import lft_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lft_torch package is missing beside this script ({e})",
              file=sys.stderr)
        return 1
    import time
    t_start = time.time()

    import numpy as np
    from lft_torch.config import Args
    from lft_torch.data.synth import lr_hr_pair, synth_lf_scene
    from lft_torch.device import resolve_device
    from lft_torch.inference.tiled import ScenePipelineCache, evaluate_dataset
    from lft_torch.kernels import (BF16IO, BF16TRAIN, FORWARD, LAUNCHES, MIXED,
                                   MIXED_BWD_SITES, MIXED_FWD, MIXED_SITES, MIXED_TRAIN, PEROP,
                                   PEROP_BF16IO, PEROP_BF16TRAIN, SWEEPS, TAIL, TAIL_BF16IO,
                                   TRAINING, build_all, reset_launches)
    from lft_torch.models.lft import forward
    from lft_torch.ops.bicubic import bicubic_upscale_views
    from lft_torch.ops.metrics import cal_metrics
    from lft_torch.utils.checkpoint import load_checkpoint

    for knob in VARIANT_KNOBS:          # every phase sets the knobs it runs under
        os.environ.pop(knob, None)
    card = card_line()
    print(card, flush=True)
    dev = resolve_device()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    paths = build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for p in paths.values():
        with open(p + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "error" in line.lower():
                    print("  " + line.strip())

    params, _, _ = load_checkpoint(CKPT, device=dev)
    args = Args(angRes=5, scale_factor=4, channels=64, patch_size_for_test=32,
                stride_for_test=16, eval_batch=16)
    n_scenes = 2

    scenes = [lr_hr_pair(synth_lf_scene(5, 512, 512, seed=a.seed + i), 4)
              for i in range(n_scenes)]
    cache = ScenePipelineCache(forward, args, eval_batch=16)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    psnr, ssim, scene_rows = evaluate_dataset(forward, params, args, scenes, cache=cache)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(LAUNCHES)
    print(f"SR model: PSNR {psnr:.6f} dB SSIM {ssim:.6f} over {n_scenes} scenes "
          f"({wall:.3f} s incl. first calls); per scene {scene_rows}", flush=True)
    print(f"launches in the SR run: {counts}", flush=True)
    missing = [k for k in FORWARD if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    extra = [k for k in TRAINING + PEROP + SWEEPS + TAIL + MIXED + BF16IO + BF16TRAIN
             + PEROP_BF16IO + PEROP_BF16TRAIN + MIXED_FWD + MIXED_TRAIN + MIXED_SITES
             + MIXED_BWD_SITES + TAIL_BF16IO if counts[k]]
    if extra:
        raise AssertionError(f"training or per-op kernels launched by the SR run: {extra}")

    bic = [cal_metrics(torch.from_numpy(hr).to(dev),
                       bicubic_upscale_views(torch.from_numpy(lr).to(dev), 5, 4), 5)
           for lr, hr in scenes]
    bic_psnr = float(np.mean([float(p) for p, _ in bic]))
    bic_ssim = float(np.mean([float(s) for _, s in bic]))
    print(f"bicubic skip alone: PSNR {bic_psnr:.6f} dB SSIM {bic_ssim:.6f}", flush=True)
    if not (math.isfinite(psnr) and psnr > bic_psnr):
        raise AssertionError(f"model PSNR {psnr} does not beat bicubic {bic_psnr}")

    plain = ScenePipelineCache(forward, args, eval_batch=16, plain_blocks=True)
    p_psnr, _, _ = evaluate_dataset(forward, params, args, scenes, cache=plain)
    worst = 0.0
    for lr, hr in scenes:
        lr_t = torch.from_numpy(lr).to(dev)
        sr_k, sr_p = cache(params, lr_t), plain(params, lr_t)
        if sr_k.shape != (lr.shape[0] * 4, lr.shape[1] * 4) \
                or not torch.isfinite(sr_k).all():
            raise AssertionError(f"bad SR mosaic {tuple(sr_k.shape)}")
        worst = max(worst, float((sr_k - sr_p).abs().max()))
    print(f"kernel path vs plain path on the card: max |SR diff| {worst:.3e} "
          f"(limit 1e-3), dPSNR {psnr - p_psnr:+.3e} dB (limit 0.01)", flush=True)
    if worst > 1e-3 or abs(psnr - p_psnr) > 0.01:
        raise AssertionError("kernel path disagrees with the plain path")

    rows = kernel_checks(params, card, counts, n_scenes, a.seed)
    torch.cuda.synchronize()

    t0 = time.time()
    train_counts, n_steps, ms_fused = train_phase(params, a.seed)
    rows += train_kernel_checks(params, card, train_counts, n_steps, a.seed)
    torch.cuda.synchronize()
    print(f"training phase: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    sr_counts, first = perop_sr_phase(params, args, scenes, cache, psnr)
    perop_counts, n_steps, ms_perop = train_phase(params, a.seed, unfused=True)
    print(f"train step, medians: {ms_perop:.3f} ms through the per-op kernels, {ms_fused:.3f} ms "
          f"through the fused blocks' kernels", flush=True)
    rows += perop_kernel_checks(card, sr_counts, n_scenes, perop_counts, n_steps, a.seed)
    torch.cuda.synchronize()
    print(f"per-op phases: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    a9_counts, a9_steps = angres9_phase(params, a.seed)
    torch.cuda.synchronize()
    print(f"angRes-9 phase: {time.time() - t0:.1f} s", flush=True)

    # steps 13-14: K8 + K9, then K7 + K6, forced through the dispatchers' knobs
    t0 = time.time()
    sweep_sr, ms_sweep = scene_phase(
        params, args, scenes[0], "per-op SR, sweep + offset (K8, K9)",
        {"ang_attn_sweep": 16, "spa_attn_offset": 16}, refs=first, ang="sweep", spa="offset")
    mxu_sr, ms_mxu = scene_phase(
        params, args, scenes[0], "per-op SR, mxu (K7, K6)",
        {"ang_attn": 16, "spa_attn_mxu": 16}, refs=first, spa="mxu")
    with variants("sweep", "offset"):
        sweep_tr, n_steps, ms_sweep_tr = train_phase(
            params, a.seed, unfused=True, what="sweep + offset train (K8, K9)",
            expect=("ang_attn_sweep_res", "ang_attn_sweep_bwd", "spa_attn_offset_res",
                    "spa_attn_offset_bwd"))
    with variants(spa="mxu"):
        mxu_tr, _, ms_mxu_tr = train_phase(
            params, a.seed, unfused=True, what="mxu train (K7, K6)",
            expect=("ang_attn_res", "ang_attn_bwd", "spa_attn_mxu_res", "spa_attn_mxu_bwd"))
    print(f"per-op branch, 5x5 views at patch 32: K7/K5 (see above), K8/K9 {ms_sweep:.2f} "
          f"ms/scene and {ms_sweep_tr:.3f} ms/step, K7/K6 {ms_mxu:.2f} ms/scene and "
          f"{ms_mxu_tr:.3f} ms/step", flush=True)
    print(f"forced-variant phases: {time.time() - t0:.1f} s", flush=True)

    # step 15: the geometries that reach K8, K6 and K9 with the knobs unset
    t0 = time.time()
    geometries = [
        # what, angRes, LR view, patch, stride, default call, SR launches, train kernels, batch
        ("12x12 views (K8, K5)", 12, 48, 32, 16, True,
         {"ang_attn_sweep": 4, "spa_attn_hp": 4},
         ("ang_attn_sweep_res", "ang_attn_sweep_bwd", "spa_attn_hp_res", "spa_attn_hp_bwd"), 2),
        ("64x64-view patches (K7, K6)", 5, 128, 64, 32, False,
         {"ang_attn": 4, "spa_attn_mxu": 4},
         ("ang_attn_res", "ang_attn_bwd", "spa_attn_mxu_res", "spa_attn_mxu_bwd"), 2),
        ("30x30-view patches (K7, K9)", 5, 128, 30, 16, False,
         {"ang_attn": 16, "spa_attn_offset": 16},
         ("ang_attn_res", "ang_attn_bwd", "spa_attn_offset_res", "spa_attn_offset_bwd"), 4),
    ]
    for what, ang_res, view, patch, stride, default_call, expect, train_expect, batch in geometries:
        g_args = Args(angRes=ang_res, scale_factor=4, channels=64, patch_size_for_test=patch,
                      stride_for_test=stride, eval_batch=16)
        scene = (scenes[0] if ang_res == 5 else
                 lr_hr_pair(synth_lf_scene(ang_res, 4 * view, 4 * view, seed=a.seed), 4))
        scene_phase(params, g_args, scene, f"SR, {what}", expect,
                    plain_impl=plain_attention_impl(patch, patch), default_call=default_call)
        train_phase(params, a.seed, unfused=True, what=f"train, {what}", ang_res=ang_res,
                    patch=patch, batch=batch, train_fused="auto" if default_call else "false",
                    expect=train_expect, steps=2)
        torch.cuda.empty_cache()
    print(f"geometry phases: {time.time() - t0:.1f} s", flush=True)

    # step 16: every K8, K9, K6 kernel against its plain version
    t0 = time.time()
    rows += sweep_kernel_checks(card, {**sweep_sr, "spa_attn_mxu": mxu_sr["spa_attn_mxu"]},
                                {**sweep_tr, **{k: mxu_tr[k] for k in
                                                ("spa_attn_mxu_res", "spa_attn_mxu_bwd")}},
                                n_steps, a.seed)
    torch.cuda.synchronize()
    print(f"sweep kernel checks: {time.time() - t0:.1f} s", flush=True)

    # step 17: K10, forced at patch 32 and as the large-view fallback at patch 64
    t0 = time.time()
    tile_sr, ms_tile = scene_phase(
        params, args, scenes[0], "per-op SR, tile (K7, K10)",
        {"ang_attn": 16, "spa_attn_tile": 16}, refs=first, spa="tile")
    del first
    args64 = Args(angRes=5, scale_factor=4, channels=64, patch_size_for_test=64,
                  stride_for_test=32, eval_batch=16)
    tile64_sr, ms_tile64 = scene_phase(
        params, args64, scenes[0], "per-op SR, offset at 64x64-view patches (K7, K10)",
        {"ang_attn": 4, "spa_attn_tile": 4}, plain_impl="tiled", spa="offset")
    print(f"K10 scenes: {ms_tile:.2f} ms/scene at patch 32 (tile), {ms_tile64:.2f} ms/scene at "
          f"patch 64 (offset)", flush=True)
    torch.cuda.empty_cache()
    print(f"tile-halo scene phases: {time.time() - t0:.1f} s", flush=True)

    # step 18: K11; step 19: K10 and the 128-row K4 against their plain versions
    t0 = time.time()
    rows += pixel_major_phase(params, cache, scenes[0], card)
    torch.cuda.empty_cache()
    print(f"pixel-major phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += tail_kernel_checks(params, card, tile_sr, tile64_sr, a9_counts, a9_steps, a.seed)
    torch.cuda.synchronize()
    print(f"tail kernel checks: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    cli_phase(args, scenes, (psnr, ssim, scene_rows), card, a.seed)
    torch.cuda.empty_cache()
    print(f"CLI phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    dp_phase(params, scenes, cache, card, a.seed)
    torch.cuda.empty_cache()
    print(f"data-parallel phase: {time.time() - t0:.1f} s", flush=True)
    # step 22: --dtype mixed
    t0 = time.time()
    mixed_scene_phase(params, args, scenes, cache, (psnr, ssim, scene_rows))
    mixed_counts, n_mixed = mixed_train_phase(params, a.seed)
    mixed9_counts, n_mixed9 = mixed_train_phase(params, a.seed, steps=2, ang_res=9, patch=16,
                                                timing=False)
    rows += mixed_kernel_checks(params, card, mixed_counts, n_mixed, mixed9_counts, n_mixed9,
                                a.seed)
    torch.cuda.empty_cache()
    print(f"mixed phase: {time.time() - t0:.1f} s", flush=True)
    # step 23: --dtype bfloat16 serving
    t0 = time.time()
    bf16_counts = bf16_scene_phase(params, args, scenes, cache, card)
    rows += bf16_kernel_checks(params, card, bf16_counts, n_scenes, a.seed)
    torch.cuda.empty_cache()
    print(f"bf16 phase: {time.time() - t0:.1f} s", flush=True)
    # step 24: --dtype bfloat16 training
    t0 = time.time()
    bt_counts, n_bt, kernel_step = bf16_train_phase(params, a.seed)
    bt9_counts, n_bt9, _ = bf16_train_phase(params, a.seed, steps=2, ang_res=9, patch=16)
    rows += bf16_train_kernel_checks(params, card, bt_counts, n_bt, bt9_counts, n_bt9, a.seed)
    bf16_step_times(params, kernel_step, a.seed)
    del kernel_step
    bf16_train_cli(params, a.seed)
    torch.cuda.empty_cache()
    print(f"bf16 training phase: {time.time() - t0:.1f} s", flush=True)
    # step 25: --dtype bfloat16 serving through the unfused per-op branch
    t0 = time.time()
    perop_bf16_counts = bf16_perop_phase(params, scenes, card, a.seed)
    rows += bf16_perop_kernel_checks(card, perop_bf16_counts, a.seed)
    torch.cuda.empty_cache()
    print(f"bf16 per-op phase: {time.time() - t0:.1f} s", flush=True)
    # step 26: --dtype bfloat16 training through the unfused per-op branch
    t0 = time.time()
    pt_counts, pt_first = bf16_perop_train_phase(params, a.seed)
    rows += bf16_perop_train_kernel_checks(card, pt_counts, a.seed)
    bf16_perop_step_times(params, pt_first)
    del pt_first
    bf16_perop_train_cli(params, a.seed)
    torch.cuda.empty_cache()
    print(f"bf16 per-op training phase: {time.time() - t0:.1f} s", flush=True)
    # step 27: the last forward forms (K11 on bf16, the forward plan `none`)
    t0 = time.time()
    rows += fwdforms_phase(params, args, scenes, cache, card, a.seed)
    torch.cuda.empty_cache()
    print(f"forward-forms phase: {time.time() - t0:.1f} s", flush=True)
    # step 28: --dtype mixed training under LFT_MM_HP_SITES=none
    t0 = time.time()
    rows += none_train_steps(params, card, a.seed)
    torch.cuda.empty_cache()
    print(f"mixed none training phase: {time.time() - t0:.1f} s", flush=True)
    # step 29: --dtype mixed under LFT_MM_HP_SITES subsets
    t0 = time.time()
    rows += sites_phase(params, args, scenes, cache, card, a.seed)
    torch.cuda.empty_cache()
    print(f"mixed site-subset phase: {time.time() - t0:.1f} s", flush=True)
    # step 30: --dtype mixed training under LFT_MM_HP_BWD_SITES subsets
    t0 = time.time()
    rows += bwd_sites_phase(params, card, a.seed)
    torch.cuda.empty_cache()
    print(f"mixed backward site-subset phase: {time.time() - t0:.1f} s", flush=True)
    missing = sorted(set(LAUNCHES) - {r["name"] for r in rows})
    if missing:
        raise AssertionError(f"kernels without a row in the kernels line: {missing}")
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
