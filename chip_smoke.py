#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mlagg_unet_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``) and
``nvidia-smi``; it imports neither JAX nor the JAX package. Phases, any
failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), the host's
   CPU model and logical cores; TF32 off;
2. build: nvcc builds every kernel of the serving and training paths from
   ``csrc/`` into ``mlagg_unet_torch/_build/``, one nvcc per source, in
   parallel, and g++ the native resampler (``csrc/resample.cpp``) beside
   them. Then a side process that cannot see the card (``HostPrep``) starts
   the host-bound work of the later phases beside the card's, in the order
   they need it, on 2 spawned workers of 2 threads: phase 8's dataset,
   phase 9's raw dataset with its ``plan_and_preprocess`` and the native vs
   scipy comparison, phase 10's raw dataset with ``plan_and_preprocess -c
   3d_fullres`` and the cascade's 3d_lowres preprocessing, phase 11's
   dataset (phases 14 and 15 copy it), and the CPU sides of the
   card-vs-CPU checks of phases 7 and 10-15 (the same seeded networks and
   inputs built on the CPU). Each phase copies its folder or takes its
   result and prints the side process's lines, their seconds its own;
3. kernels: each kernel against its plain PyTorch twin at the flagship's
   shapes (serving: model batch 16, tile 256x224; the scan backward: the
   training batch 10), fp32 and bf16 I/O, with the tolerances stated below,
   and timed with CUDA events (median of 20). K1 (scan forward: three
   kernels per call) with its launch plan and resident CTAs per SM printed,
   against the chunked scan and against the twin that splits the work over
   groups of tiles as K1 does, two runs bit-equal, each of its kernels timed
   (torch.profiler); at the training batch K1 with its tile-entry states
   must give a y bit-equal to K1 without them and states equal to the plain
   scan's, each kernel timed again; K5 (scan backward: three kernels per
   call) two runs bit-equal,
   each of its kernels timed (torch.profiler) beside a model estimate of
   the bytes it requests, and held against autograd through the
   step-by-step scan and against the twin that splits the work over tiles
   as K5 does at b = 2, L = 1024. K4 (pooled-branch attention) on both
   head-group views at the four stage shapes and at edge shapes (lq
   not a multiple of 64, lk > 64 with a ragged last key block, head dims 8
   to 128, b * h > 65535), its bf16 tensor-core kernel two runs bit-equal,
   beside SDPA and a PyTorch copy of the same strided bytes. K2 and K3
   (MLLA block front and tail) in bf16, their tensor-core kernels, against
   the bf16 twins and the twins that round where the kernels round, two
   runs bit-equal, timed per stage beside cuBLAS doing their two or three
   products alone. K6 (fused local attention) at the four stages' local
   halves, its bf16 tensor-core kernel against the twin, two runs
   bit-equal, timed per stage beside cuBLAS doing its three projections
   alone; K7 and K8 (fused
   instance norm stats and apply) at the UNETR head's (16, 256, 224, 48) in
   modes 0, 1 and 2 with and without the activation, two runs bit-equal, and
   autograd through them against autograd through the plain twin;
4. model: the full-width flagship (``bench.py``'s config, seeded random
   weights) on one tile, fp32 on the card (kernels) against the CPU (plain
   twins); then a bf16 forward at model batch 16. The same weights in the
   fused configuration (``fused_local_attn`` and ``fused_instance_norm``
   on) against the default one on the card, fp32, and its bf16 forward;
5. serve: ``VolumePredictor`` on ``bench.py``'s workload (8 volumes of
   1x10x320x260, mirror TTA over both in-plane axes, bf16), volumes/s and
   peak memory, in the default configuration (K1-K4 must each be launched,
   K6-K8 never) and then the fused one (K1-K4 and K6-K8 must each be); a
   profile of one volume in each: device time by kernel and each port
   kernel's total, where each of K1's three kernels must run 20 times (2
   calls per forward, 10 forwards), K2 and K3 must be the tensor-core
   ``front_mma_kernel`` and ``tail_mma_kernel`` 80 times each (8 per
   forward) and the scalar ``front_kernel`` and ``tail_kernel`` never; K6
   in the fused serve the tensor-core ``local_attn_mma_kernel`` 80 times
   and the scalar ``local_attn_kernel`` never, neither in the default one.
   The trace of a volume must hold as many K1, K2, K3 and K6 launches as
   their wrappers counted in it (exactly 20 of each K1 kernel, 80, 80 and
   80 or 0): a trace that holds fewer lost device records in torch.profiler
   and is taken again, up to three times;
6. predict: the port's predict verb (``predict_from_modelfolder_entry``,
   bf16, mirror TTA, automatic tile batch) on a trained-model folder the
   phase writes (a 2d plan at 256x224, ZScore, NiftiIO, 4 labels, the
   seeded flagship's checkpoint in the JAX package's format) over 4 cases
   of 1x10x320x260 ``.nii.gz``: every output's shape and labels, each case
   at least 99.9 % equal to the argmax of the predictor's own
   ``VolumePredictor`` on the preprocessed case, K1-K4 launched and K5-K8
   never; cases/s through ``predict_from_files`` after a warm-up pass,
   over the 4 cases and over 8 (the last 4 outputs' write times give the
   steady rate); on one case that predictor (bf16, the tile batch the
   verb chose) and an fp32 one at the same batch against themselves with
   every kernel wrapper switched to its plain twin on the card (bf16: rel
   L2 within 5e-2; fp32: within 1e-3 x max; K1 launched at that model
   batch only, its launch plans printed);
   the host-accumulator fallback on one volume (fp32, tile batch 4, a
   budget too small for the accumulator) within 1e-5 x max of the device
   path;
   ``bench.py``'s configuration (automatic tile batch, bf16 transfer, 8
   volumes after 1 warm-up): volumes/s, the chosen tile batch, each
   autotune candidate's ms per tile and the peak memory;
7. train: the ``nnUNetTrainer_MLAgg_2D_dt_MS`` recipe on the full-width
   flagship. One fp32 batch (batch 1, drop path off) on the card against a
   CPU copy of the network: the loss and every parameter gradient. Then 2
   warm-up and 10 timed bf16 steps at batch 10, 256x224, 4 classes, drop
   path on, on one seeded synthetic batch whose label is a fixed function of
   the image: ms per step, images/s, peak memory, the first and last loss
   (the last must be lower), a profile of one step, and one validation
   step, whose trace must hold each of K1's and K5's three kernels twice
   (one call per scan direction) (a trace short of them is taken again, up
   to three times). K1, K4 and K5 must
   each be launched in the timed steps, no other.
   Then the fp32 batch with ``fused_instance_norm`` on, held against the
   default network on the card: K1, K4, K5, K7 and K8 must each be
   launched in it, K2, K3 and K6 never (no timed steps);
8. train verb: the port's ``train_entry`` on the card, default
   configuration, fold 0 of a dataset the side process writes (10 cases of
   1x10x320x260 ``.nii.gz`` from ``RandomState(0)``, smooth blobs labelled
   by 3 thresholds of the image, preprocessed by the port's
   ``run_case_save``; the predict phase's 2d plan at 256x224, batch 10, 4
   labels), with the flagship recipe cut to 2 epochs of 6 steps, 2
   validation steps and 1 warm-up epoch (registered here only). Every loss
   finite; checkpoint_final, _best and _latest written; a Dice per label in
   ``validation/summary.json``; K1, K4 and K5 launched in the training
   steps and no other kernel; K1-K4 in the validation steps and the final
   validation and K5-K8 not; K2 and K3 nowhere else. Then ``--c`` with the
   recipe at 3 epochs: it loads checkpoint_final, trains one epoch of 6
   steps and keeps the logger's first two epochs. Then the predict verb on
   the folder it wrote: shape and labels. On the first training batch the
   verb's loader produced, from the verb's final weights, the fp32 loss and
   every parameter gradient with the kernels against every wrapper
   switched to its plain twin on the card (phase 7's tolerances), and the
   first validation batch's logits in bf16 (rel L2 within 5e-2) and fp32
   (within 1e-3 x max). Printed beside the card's name and power limit:
   seconds per epoch, ms per step and images/s with the loader (median over
   epoch 2), the step on one cached batch, the loader's batches/s alone
   on threads (a worker that hangs fails the phase),
   the device busy share of 2 profiled steps fed by the loader, the peak
   memory, the losses and pseudo dice per epoch and the final validation's
   seconds per case;
9. pipeline: the nnU-Net pipeline through the port's verbs in this
   process, from raw files to an evaluated, postprocessed test prediction.
   A raw dataset of 10 training and 2 test cases of 1x10x320x260
   ``.nii.gz`` from ``RandomState(1)`` (smooth blobs labelled by 3
   thresholds of the image; in-plane spacing 0.75 to 0.85 mm from case to
   case at 3 mm in z, so the 2d preprocessing resamples them through the
   native resampler); ``plan_and_preprocess_entry`` (``-c 2d
   --verify_dataset_integrity``, 8 spawned workers): the fingerprint, a 2d
   configuration with a patch divisible by 32, 10 ``.npz``/``.pkl`` pairs
   and ``gt_segmentations/``; the first case preprocessed again in this
   process with ``MLAGG_DISABLE_NATIVE=1`` (scipy) against the verb's
   native output (seg equal, data within 1e-6 x max|data|), one case
   resampled in this process both ways, and what a spawned worker pays to
   import the package (it must not open the card). Two flagship recipes
   cut to 1 and 2 epochs of 3 steps and 2 validation steps (registered
   here only) train fold 0 with ``--npz`` through ``train_entry``
   at the planner's patch and batch: K1, K4 and K5 launched in the training
   steps and no other kernel, K1-K4 in the validation steps and the final
   validations, K6-K8 never; on the first recipe's first training batch the
   loss and every gradient, and the first validation batch's logits,
   against every wrapper switched to its plain twin (phase 8's helper and
   tolerances).
   ``find_best_configuration_entry`` over both recipes and their ensemble:
   ``inference_information.json`` names the best and its
   ``postprocessing.pkl`` exists. The predict verb on the test cases for
   both recipes (fold 0, probabilities saved); the first recipe's
   verb's own fold-0 ``VolumePredictor`` (bf16, the planner's patch, the
   tile batch it chose) and an fp32 one at that batch on a test case, and
   the final validation's (bf16, tile batch 4) and an fp32 one at tile
   batch 4 on a validation case of fold 0, each against itself with every
   wrapper switched to its plain twin (phase 6's tolerances; K1 at the
   model batch only, its launch plans printed); ``ensemble_entry``,
   ``apply_postprocessing_entry`` with the chosen pkl on the chosen
   prediction and ``evaluate_simple_entry`` against the test labels:
   shapes, labels in {0..3}, a finite Dice. ``export_model_entry`` of the
   first recipe (in a thread beside the predict verbs, once the best
   configuration is found), ``install_model_entry`` into a fresh results
   root and the predict verb there: segmentations at least 99.9 % equal to
   the first prediction's. Each stage's seconds and the peak memory; what a
   spawned worker pays to start is measured in a thread beside the phase;
10. unet3d: the default nnU-Net recipe in 3-D, on the plans' ``PlainConvUNet``
    at ``tools/bench_3d_unet.py``'s topology (6 stages, features 32 to 320,
    3x3x3 kernels, strides [1,1,1], [2,2,2] x 4, [1,2,2]). fp32 with TF32
    off: one 64x128x128 tile card against CPU (1e-3 x max).
    ``nnUNetTrainer``'s loss (1e-5 relative) and every gradient (1e-3 x max
    + 1e-6) at batch 1 of 32x64x64, the patch cut for the CPU, card against
    CPU in fp64; in fp32 the loss (1e-5), and each side's largest gradient
    error against fp64 printed (in fp32 neither side reaches 1e-3 x max on
    this network, the CPU no more than the card). The tool's
    workload on ``VolumePredictor``: 2 volumes of 1x96x192x192 after 1
    warm-up, tile 64x128x128, step 0.5, Gaussian, mirror (0, 1, 2), bf16
    compute and transfer, automatic tile batch: volumes/s, the chosen batch,
    each candidate's ms per tile, peak memory, the device busy share of one
    profiled volume, and bf16 against fp32 rel L2 of volume 0 (5e-2).
    ``nnUNetTrainerBN`` for 3 bf16 steps on a cached batch: its fp32 running
    statistics must move; its eval forward card against CPU. The train verb:
    5 training cases and 1 test case of 1x96x192x192 at 1 mm (seeded blobs, 3
    labels) through ``plan_and_preprocess_entry -c 3d_fullres`` (the plan
    printed), ``nnUNetTrainer`` cut to 1 epoch of 4 steps and 2 validation
    steps on fold 0 (seconds per epoch, ms per step with the loader against
    one cached batch, peak memory), the predict verb on the test case (the
    verbs' predictors at the memory budget's tile batch, not autotuned). The
    cascade: a hand-written 3d_lowres at 2 mm and 3d_cascade_fullres after
    it; lowres trains one epoch of 2 steps on fold ``all`` and its final
    validation writes every case's ``predicted_next_stage``; the cascade
    stage (1 + 2 input channels) trains one epoch on fold 0; the predict
    verbs, lowres then the cascade with ``-prev_stage_predictions``. The
    phase launches none of K1-K8;
11. mamba: the Mamba zoo's first family on nnU-Net's default 2d plan at
    320x320 (7 stages, features 32 to 512, batch 4): the six trainers'
    networks (U-Mamba Bot and Enc, VM-UNet, Mamba-UNet, Swin-UMamba and
    Swin-UMamba-D) at full width, seeded. (a) One fp32 forward and backward
    of each at batch 4, and of an SS2D v04 cell in bf16, record every
    (b, g, d, L, n, dtype, reverse) at which K1 and K5 run (L 25 to 102,400,
    g = 2 reversed, bf16); at each, K1 with its states and K5 against their
    plain twins (phase 3's tolerances); K1 and K5 timed at U-Mamba Enc's
    stage 0 at batch 4 beside their plain twins and bound. (b) Each
    network's tile, fp32, card vs CPU (1e-3 x max): the U-Mambas' at
    320x320 (their channel-token stages norm over the plan's token count),
    the others' on 128x128, cut for the CPU; VM-UNet served by
    ``VolumePredictor`` (2 volumes of 1x10x320x320 after 1 warm-up, step
    0.5, mirror (0, 1), bf16, automatic tile batch): volumes/s, peak
    memory, K1 launches per volume, the warm-up volume with the kernels
    against the plain twins in bf16 (rel L2 5e-2) and in fp32 at the chosen
    batch (1e-3 x max), bf16 against fp32 (5e-2). (c)
    ``nnUNetTrainerUMambaEnc`` through ``train_entry`` on phase 8's 10 cases
    with that plan, cut to 1 epoch of 5 steps and 2 validation steps on fold
    0; the gradient gates (ROADMAP C2): the network-level gate on the
    network's seeded initial weights and a seeded batch of blobs at batch 4
    (``seeded_grad_gate``: the same weights and batch in every run, cuDNN
    deterministic; the network in fp64 around the fp32 scans and in fp32:
    the loss kernels against plain twins (1e-5), the gradients against the
    network and scans in fp64 (``hold_mamba_grads``: the whole gradient to
    twice the twins' distance, each to a quarter of its max or twice the
    twins' distance), and K1 / K5 on that batch's own operands against their
    twins), and the per-call gate on the verb's final weights and first
    training batch (``scan_calls_vs_fp64``: each K1 y and K5 gradient within
    max(32 x the fp32 twin's distance to the fp64 twin, 4e-5 x max|fp64|));
    ms per step with the loader and on one cached batch, the predict verb on
    its folder for 1 case. Only K1 and K5 run;
12. ss3d: the families that scan at d_state 1 and in 12 directions, at
    full width, seeded: U-Mamba Bot and Enc SS3D and VM-UNet-3D in its three
    forms (``vmunet3d``, ``vmunet3d_new``, ``vmunet3d_swint``) on phase 10's
    3-D plan (64x128x128, 6 stages, 32-320 features, 3 classes), MSVM-UNet
    (``tiny_0230s``) on phase 11's 2d plan (320x320, 4 classes). (a) One
    fp32 forward and backward of each (3-D at batch 2, MSVM at 4) and one
    bf16 MSVM forward record every (b, g, d, L, n, dtype, reverse) at which
    K1 and K5 run (n = 1 at g = 12 and L = 1,048,576; n = 16 at g = 12; g =
    2 reversed; bf16), each network's peak memory beside it; at each, K1
    with its states and K5 against their plain twins (phase 3's
    tolerances); both timed at U-Mamba Enc SS3D's stage 0 at batch 2 beside
    their plain twins (one run) and bound. (b) Each network on one tile,
    fp32, card vs CPU (1e-3 x max); the 3-D ones on a tile cut for the CPU
    (U-Mambas 16x64x64, VM-UNet-3D 8x32x32; at 64x128x128 their CPU forwards
    took 144 s). (c) U-Mamba Enc SS3D served on 1 volume of 1x96x192x192
    (tile 64x128x128, mirror (0, 1, 2); the memory budget's tile batch, not
    autotuned; a one-tile warm-up volume, 1x64x128x128, on which the
    kernels are held to their twins: the plain scans of a whole volume took
    ~60 s a network), bf16, as phase 11 serves (bf16 vs fp32 within 5e-2; no
    profile). (d) ``nnUNetTrainerUMambaEnc_SS3D`` through ``train_entry`` on
    phase 10's cases (its preprocessed folder; preprocessed here under
    ``--only``) and its test case, trained on phase 10's 3-D plan at batch
    2, cut to 1 epoch of 3 steps and 2 validation steps on fold 0, without
    mirroring (its final validation and the predict verb too): launches; the gradient gates as phase 11's at batch 1 of 32x64x64 (the
    network in fp64 does not fit the card at 2 cases, and takes minutes at
    the full patch; the per-call gate on the centre of the first training
    batch's first case); ms per step with the loader and on one cached
    batch; the predict verb on the test case. Only K1 and K5 run;
13. variants: the networks of ``models/mamba_variants.py`` at full width,
    seeded: SegMamba and nnMamba on phase 10's 3-D plan (3 classes; nnMamba's
    strides its pools [1:5], four times 2x2x2), LightM-UNet and UltraLight
    VM-UNet on phase 11's 2d plan (4 classes). (a) One fp32 forward and
    backward of each in training mode (3-D at batch 2, 2-D at 4) records
    every (b, g, d, L, n, dtype, reverse) at which K1 and K5 run (SegMamba's
    L = 262,144 at d = 96 and UltraLight's d = 12 must be among them), each
    network's peak memory beside it; at each shape phases 11 and 12 did not
    hold in this run, K1 with its states and K5 against their plain twins
    (phase 3's tolerances; the skipped shapes printed); both timed at
    SegMamba's stage 0 beside their plain twins (one run) and bound. (b)
    Each network on one tile, fp32, card vs CPU (1e-3 x max), cut for the
    CPU: the 3-D ones on phase 12's CPU tile, the 2-D ones on 128x128. (c)
    SegMamba served on 1 volume of 1x96x192x192 as phase 12 serves; bf16
    against fp32 within twice JAX's own gap (``SEGMAMBA_BF16_TOL``). (d)
    ``nnUNetTrainer_SegMamba`` through ``train_entry`` as phase 12 (d)
    trains U-Mamba Enc SS3D: phase 10's cases and plan, 1 epoch of 3 steps
    and 2 validation steps on fold 0, launches, the gradient gates at batch
    1 of 32x64x64, ms per step with the loader and cached, the predict verb
    on the test case. Only K1 and K5 run;
14. lkm-mednext: LKM-UNet and MedNeXt B k3, with and without its Mamba
    skip, at full width, seeded, on phase 11's 2d plan; LKM-UNet also in 3-D
    on phase 10's plan. (a) One fp32 forward and backward in training mode
    at batch 4 of LKM-UNet and MedNeXt Mambaskip, and of the 3-D LKM-UNet at
    batch 1 of 32x64x64 (its pixel layers take the whole-volume fallback),
    record every (b, g, d, L, n, dtype, reverse) at which K1 and K5 run (L =
    1, LKM-UNet's stage-0 pixel layer at L = 64, b = 6,400, and the Mamba
    skip's five scales at L = 136,400, g = 2, both directions, must be among
    them); at each shape an earlier phase did not hold in this run, K1 with
    its states and K5 against their plain twins; both timed at that stage-0
    pixel shape beside their plain twins and bound. (b) Each of the three on
    one 128x128 tile, fp32, card vs CPU (1e-3 x max; LKM-UNet's pixel layers
    take their whole-map fallback there). (c) LKM-UNet and
    MedNeXt Mambaskip served on 1 volume of 1x10x320x320 at the budget's
    tile batch, mirror (0, 1), bf16, the kernels held to their twins on a
    one-slice warm-up volume, bf16 against fp32 within twice JAX's own gap
    (``LKM_BF16_TOL``). (d) ``nnUNetTrainer_LKM_UNet`` through
    ``train_entry`` on phase 8's cases with that plan, 1 epoch of 5 steps
    and 2 validation steps, with phase 11's gradient gates at batch 2 (the
    seeded batch; the first two of the verb's first batch), ms per step, the
    predict verb on its folder for 1 case; MedNeXt Mambaskip's gates through
    ``Trainer``: the seeded gate, then 2 bf16 steps on one cached batch and
    the per-call gate on the weights they leave. Only K1 and K5 run;
15. transformers: the zoo's transformer baselines at full width, seeded, on
    phase 11's 2d plan: SwinUNETR, Swin-TUNet, TransUNet (R50-ViT-B/16) and
    MLLA-UNet, each parameter count against JAX's. (a) Each on one 320x320
    tile, fp32, card vs CPU (1e-3 x max; TransUNet's position embedding is
    the patch's, so the whole tile). (b) TransUNet and MLLA-UNet served on
    1 volume of 1x10x320x320 at the budget's tile batch, mirror (0, 1),
    bf16: volumes/s, peak memory, bf16 against fp32 within twice JAX's own
    gap (``TRANSFORMER_BF16_TOL``). (c) ``nnUNetTrainer_MLLA_UNet`` through
    ``train_entry`` on phase 8's cases with that plan, 1 epoch of 5 steps and
    2 validation steps, ms per step, the predict verb on its folder for 1
    case; its loss and every gradient at batch 1 of 128x128 (the tile cut for
    the CPU), seeded, drop path off, card vs CPU in fp64 (loss 1e-5, each
    gradient 1e-3 x max + 1e-6). None of K1-K8 may run in the phase;
16. a ``{"kernels": [...]}`` line, then the card's ``nvidia-smi`` line, then
    ``{"ok": true, "device": {...}}`` as the last line.

Every line of the run's output is led by the seconds since the start. In
phases 11-15 each network's tile runs on the card right after the network
is built, on its seeded weights, as its CPU side does.
``--only predict`` runs phases 1, 2 and 6 alone, ``--only train-verb``
phases 1, 2 and 8, ``--only pipeline`` phases 1, 2 and 9, ``--only unet3d``
phases 1, 2 and 10, ``--only mamba`` phases 1, 2 and 11, ``--only ss3d``
phases 1, 2 and 12, ``--only variants`` phases 1, 2 and 13, ``--only lkm-mednext``
phases 1, 2 and 14, ``--only transformers`` phases 1, 2 and 15 (each makes
what it needs of the side process's work in this process); ``--only
grad-gates`` runs phases 1 and 2 and then the network-level gradient gates
of phases 11-14 alone (run it twice in one call:
both runs give the same verdicts and figures); ``--only serve-timing``
runs phases 1 and 2 and then phase 5's default timing alone, in two
windows, from the package under ``--root`` (default: this script's
directory): run it for two checkouts in turns in one call to compare them.
None of them prints the last two lines.

Kernel times in the JSON line are per flagship forward at model batch 16,
the sum over the launches one forward makes (K1 2, K2 8, K3 8, K4 16, K6 8,
K7 6, K8 4), and for K5 per training step at batch 10 (2 launches, one per
scan direction). ``bound_ms`` is the larger of the bytes over 3.35 TB/s
and the operations: the FLOPs over the peak rate of their type and, for K1
and K5, one exp per (row, d, n, step), split between the SFU (16 per SM per
clock at ``nvidia-smi``'s maximum SM clock) and an 8-instruction polynomial
on the FP32 pipe beside the kernel's own fp32 FLOPs, so that both finish
together. ``library_ms`` is SDPA for K4, six ``F.instance_norm``
calls for K7 + K8, and for K2, K3 and K6 "GEMMs alone": cuBLAS doing the
kernel's two or three products in bf16 with no LN, GELU, residuals or
window (K6: ``F.linear`` for q and for k, v). A
kernel's ``launches`` is its count in the serve run that runs it (K1-K4 the
default one, K6-K8 the fused one), K5's in the default timed train run.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor core; fp32 FMA
SFU_PER_SM_PER_CLOCK = 16   # exp2 (MUFU.EX2) results per SM per clock, sm_90
# an exp2 on the FP32 pipe instead, at fp32 accuracy: range reduction (2),
# a degree-5 polynomial (5 FMA) and the exponent's insertion (1)
POLY_EXP_FP32_OPS = 8

BM = 16                                  # model batch: 4 tiles x 4 mirrors
TILE = (256, 224)
STAGE_C = (96, 192, 384, 768)
STAGE_N = (14336, 3584, 896, 224)        # tokens per tile at each stage
POOL_HEADS = (1, 2, 4, 8)                # differential heads of the pooled half
HEAD_DIM, POOL_LK = 24, 56
SCAN_D, SCAN_N, SCAN_L = 96, 16, sum(STAGE_N)
DEPTH = 2                                # blocks per stage

# tolerances, relative to the reference output's max |value|
SLEEP_CYCLES = 2_000_000                 # ~1 ms of SM clock ahead of each timed call

TOL_FP32 = 1e-4    # fp32 I/O: only the order of fp32 sums differs
TOL_BF16 = 2e-2    # bf16 I/O: one bf16 rounding of the output and of the
                   # plain twin's intermediates
TOL_K3_OPERANDS = 4e-3  # K3 bf16 against the twin rounding where it rounds: half
                        # a bf16 ulp of the output plus the odd operand rounded
                        # the other way after sums in another order
TOL_K2_OPERANDS = 4e-3  # K2 bf16 against the twin rounding where it rounds: the
                        # same (half an ulp of a or h, an element of y rounded
                        # the other way after LN sums in another order)
TOL_K6_TWIN = 1e-2  # K6 bf16 against its twin, which rounds where it rounds
                    # (k, v, the output): one bf16 ulp of the output's largest
                    # element (<= 2^-7 of it), flipped by fp32 sums in another
                    # order, as are some roundings of k and v
TOL_SCAN = 1e-4    # the scan's output is fp32 for either input type
TOL_MODEL = 1e-3   # fp32 flagship card vs CPU: ~40 layers of re-ordered fp32
                   # sums, __expf in the scan, renormalised by LN/GroupNorm
TOL_SERVE_REL_L2 = 5e-2  # bf16 serving vs fp32 serving of one volume
TOL_SCAN_GRAD = 2e-4  # scan gradients, fp32 operands (PARITY.md:70): the
                      # adjoint sums over L and d in another order
TOL_SCAN_GRAD_BF16 = 2e-2  # bf16 operands: du, ddelta, dB, dC rounded to bf16
TOL_TRAIN_LOSS = 1e-5  # fp32 training batch, card vs CPU, relative
TOL_TRAIN_GRAD = 1e-3  # each gradient, relative to its max |value| (+1e-6)

TRAIN_BATCH = 10                         # the 2d plan's batch (bench_train_step.py)
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
SERVE_FIRST_VOLUMES_PER_S = 1.1404       # the serving slice's first run (PERF.md), H100 80GB HBM3 at 700 W
SERVE_KERNELS = ("selective_scan_fwd", "mlla_front", "mlla_tail", "flash_attn_fwd")
TRAIN_KERNELS = ("selective_scan_fwd", "flash_attn_fwd", "selective_scan_bwd")
NORM_KERNELS = ("instance_norm_stats", "instance_norm_apply")
FUSED_KERNELS = ("local_attn_fused",) + NORM_KERNELS   # the fused config's alone
K1_KERNELS = ("scan_fwd_group_kernel", "scan_fwd_carry_kernel", "scan_fwd_out_kernel")
K5_KERNELS = ("scan_bwd_group_kernel", "scan_bwd_carry_kernel", "scan_bwd_tile_kernel")
K1_FIRST_MS = 8.151    # K1 bf16 per forward before its redesign (PERF.md, H100 80GB HBM3, 700 W)
K5_FIRST_MS = 17.717   # K5 bf16 per train step before its redesign (PERF.md, H100 80GB HBM3, 700 W)
PORT_KERNEL_NAMES = (*K1_KERNELS, *K5_KERNELS, "front_kernel",
                     "front_mma_kernel", "tail_kernel", "tail_mma_kernel", "flash_fwd_mma_kernel",
                     "flash_fwd_fp32_kernel",
                     "local_attn_kernel", "local_attn_mma_kernel",
                     "stats_partial_kernel", "stats_finalize_kernel", "apply_kernel")
DEFAULT = dict(fused_local_attn=False, fused_instance_norm=False, fused_tail=True)
FUSED = dict(fused_local_attn=True, fused_instance_norm=True, fused_tail=True)
# K4 edge shapes (b, h, lq, lk, dk, dv): lq not a multiple of 64, lk > 64 with
# a ragged last key block, the widest and narrowest head dims, b * h > 65535
ATTN_EDGES = ((2, 3, 1000, 56, 24, 48), (2, 3, 33, 56, 24, 48), (2, 3, 130, 200, 32, 32),
              (2, 3, 1000, 130, 24, 48), (2, 3, 256, 64, 128, 128), (2, 3, 100, 20, 8, 16),
              (2, 35000, 10, 12, 8, 16))
LOCAL_SHAPES = ((128, 112, 48, 1), (64, 56, 96, 2), (32, 28, 192, 4), (16, 14, 384, 8))
NORM_C = 48                              # the UNETR head's width (embed 96 / 2)
NORM_STATS, NORM_APPLY = 6, (2, 2)       # per forward: K7 launches; K8 mode 0, mode 2
FORWARDS_PER_VOLUME = 10                 # 10 slices x 4 tiles x 4 mirrors / model batch 16
# the serve profile's kernels by wrapper: each call launches one of its two
# kernels (tensor-core, scalar), so a complete trace of a volume holds as
# many of them as the wrapper counted launches
PROFILED = {"mlla_front": ("front_mma_kernel", "front_kernel"),
            "mlla_tail": ("tail_mma_kernel", "tail_kernel"),
            "local_attn_fused": ("local_attn_mma_kernel", "local_attn_kernel")}
PROFILE_TRIES = 3  # torch.profiler can drop device records: a trace that
                   # holds fewer launches than the wrappers counted is taken again
PREDICT_CASES = 4                        # cases of 1x10x320x260 through the predict verb
PREDICT_STEADY_CASES = 8                 # over twice the 3 export threads: a steady-state cases/s
PREDICT_SPACING = (5.0, 1.0, 1.0)        # (z, y, x): the plan's in-plane spacing, no resampling
TOL_PREDICT_AGREE = 0.999                # share of voxels equal to the predictor's own argmax
TOL_HOST_FALLBACK = 1e-5                 # host accumulator vs the device one, fp32, x max|ref|
# the trained-model folder the predict phase writes (a 2d plan at bench.py's
# tile, ZScore, NiftiIO, 4 labels)
PREDICT_PLANS = {
    "dataset_name": "Dataset998_ChipSmoke", "plans_name": "nnUNetPlans",
    "image_reader_writer": "NiftiIO", "transpose_forward": [0, 1, 2],
    "transpose_backward": [0, 1, 2],
    "original_median_spacing_after_transp": list(PREDICT_SPACING),
    "original_median_shape_after_transp": [10, 320, 260],
    "foreground_intensity_properties_per_channel": {"0": {
        "mean": 0.5, "std": 0.29, "percentile_00_5": 0.005, "percentile_99_5": 0.995}},
    "configurations": {"2d": {
        "data_identifier": "nnUNetPlans_2d", "preprocessor_name": "DefaultPreprocessor",
        "batch_size": 10, "patch_size": list(TILE), "spacing": list(PREDICT_SPACING[1:]),
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": {"is_seg": False, "order": 3, "order_z": 0,
                                      "force_separate_z": None},
        "resampling_fn_seg": "resample_data_or_seg_to_shape",
        "resampling_fn_seg_kwargs": {"is_seg": True, "order": 1, "order_z": 0,
                                     "force_separate_z": None},
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": {"is_seg": False, "order": 1, "order_z": 0,
                                               "force_separate_z": None},
        "batch_dice": True}},
}
PREDICT_DATASET = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz",
                   "numTraining": 0,
                   "labels": {"background": 0, "a": 1, "b": 2, "c": 3}}
# the train verb's dataset: 10 cases of 1x10x320x260 (smooth seeded blobs,
# labels = 3 thresholds of the image), the predict phase's 2d plan (batch 10,
# 256x224, 4 labels), the flagship recipe cut to 2 epochs of 6 steps
TRAIN_VERB_DATASET = "Dataset996_ChipSmokeTrain"
TRAIN_VERB_CASES = 10
TRAIN_VERB_THRESHOLDS = (-0.5, 0.3, 1.0)
TRAIN_VERB_RECIPE = "nnUNetTrainer_MLAgg_2D_dt_MS_chip_smoke"
TRAIN_VERB_EPOCHS, TRAIN_VERB_STEPS, TRAIN_VERB_VAL_STEPS, TRAIN_VERB_WARMUP = 2, 6, 2, 1
TRAIN_VERB_PROFILED_STEPS = 2
LOADER_RATE_BATCHES = 20                 # timed after the prefetch queue (6) is drained
# the pipeline phase: a raw dataset of 10 training and 2 test cases of
# 1x10x320x260 (smooth seeded blobs, labels = 3 thresholds of the image) whose
# in-plane spacing differs from case to case, so that the 2d preprocessing
# resamples them; two cut flagship recipes on the plan the planner writes
PIPELINE_DATASET, PIPELINE_ID = "Dataset994_ChipSmokePipeline", "994"
PIPELINE_CASES, PIPELINE_TEST_CASES = 10, 2
PIPELINE_Z_SPACING, PIPELINE_INPLANE = 3.0, (0.75, 0.85)   # mm
PIPELINE_RECIPES = (("nnUNetTrainer_MLAgg_2D_dt_MS_chip_pipeline_A", 1),
                    ("nnUNetTrainer_MLAgg_2D_dt_MS_chip_pipeline_B", 2))   # (name, epochs)
PIPELINE_STEPS, PIPELINE_VAL_STEPS = 3, 2
PIPELINE_FOLDS = ("0",)
TOL_NATIVE_PREPROCESS = 1e-6             # native vs scipy preprocessed data, x max|data|
# phase 10: the default nnU-Net recipe in 3-D. The network: tools/bench_3d_unet.py's
# topology (6 stages, features 32-320, 3x3x3 kernels) at its tile; the serve: that
# tool's workload; the train verb: a dataset of 1 mm isotropic volumes planned by the
# port, nnUNetTrainer cut to 1 epoch of 4 steps and 2 validation steps (from 1000
# epochs of 250 + 50); the cascade: a hand-written 3d_lowres at 2 mm before it
UNET3D_TILE = (64, 128, 128)
UNET3D_FEATURES = (32, 64, 128, 256, 320, 320)
UNET3D_POOLS = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2))
UNET3D_GRAD_PATCH = (32, 64, 64)         # the loss and gradients: the patch cut for the CPU
UNET3D_VOLUME, UNET3D_VOLUMES = (1, 96, 192, 192), 2
UNET3D_THRESHOLDS = (0.3, 1.0)           # 3 labels: two thresholds of the image
UNET3D_DATASET, UNET3D_ID = "Dataset993_ChipSmokeUNet3D", "993"
UNET3D_DATASET_JSON = {"channel_names": {"0": "MRI"}, "file_ending": ".nii.gz",
                       "numTraining": 0, "labels": {"background": 0, "a": 1, "b": 2}}
UNET3D_CASES, UNET3D_TEST_CASES = 5, 1
UNET3D_RECIPE = "nnUNetTrainer_chip_smoke_3d"
UNET3D_EPOCHS, UNET3D_STEPS, UNET3D_VAL_STEPS = 1, 4, 2
UNET3D_BN_STEPS = 3
# phase 11: the Mamba zoo's first family. Its plan: nnU-Net's default 2d
# topology at 320x320 as phase 9's planner wrote it (7 stages, features 32 to
# 512, 3x3 kernels, batch 4); U-Mamba Enc scans 102,400 tokens at stage 0, 6,400
# at stage 2 and channels at stages 4 and 6, U-Mamba Bot the 5x5 bottleneck
MAMBA_PATCH, MAMBA_BATCH = (320, 320), 4
MAMBA_POOLS = ((1, 1),) + ((2, 2),) * 6
MAMBA_FEATURES = (32, 512)               # base, max
MAMBA_CLASSES = 4
MAMBA_TRAINERS = ("nnUNetTrainerUMambaBot", "nnUNetTrainerUMambaEnc", "nnUNetTrainer_VMUNet",
                  "nnUNetTrainer_MambaUNet", "nnUNetTrainerSwinUMambaScratch",
                  "nnUNetTrainerSwinUMambaDScratch")
# one served network (30 K1 launches a volume); phase 12 serves U-Mamba Enc's
# 3-D form
MAMBA_SERVED = ("nnUNetTrainer_VMUNet",)
MAMBA_VOLUME, MAMBA_VOLUMES = (1, 10, 320, 320), 2
# the 2-D networks' tile for the card vs CPU check of phases 11 and 14, cut
# for the CPU (the 7-stage plan takes multiples of 64; LKM-UNet's pixel layers
# take their whole-map fallback there, their sub-grids only at multiples of
# 320); the scans at 320x320 are held in (a)
ZOO_CPU_TILE_2D = (128, 128)
# The gradient gates of phases 11-14 (ROADMAP C2). The network-level gate
# holds a batch's loss and gradients against the network and scans in fp64.
# fp32 scans do not determine single gradients to TOL_TRAIN_GRAD x max: with
# the kernels and with the plain twins they sat up to ~120x that from the
# reference on an H100 80GB HBM3 at 700 W. So the whole gradient is held to
# MAMBA_GRAD_TWIN_FACTOR times the twins' rel L2, and each gradient to
# MAMBA_GRAD_LEAF_TOL x its max or MAMBA_GRAD_TWIN_FACTOR times the twins'
# distance, which a scan gradient wired to the wrong operand or direction
# would exceed (hold_mamba_grads). On trained weights either run's distance
# varied with the weights (up to 10x), which differ from run to run, and the
# network amplifies fp32 rounding there: the gate refused one run in twelve
# with no kernel at fault. So it runs on the network's seeded initial
# weights and a seeded batch (GATE_SEED), the same in every run, cuDNN
# deterministic (seeded_grad_gate); and each scan call on the trained weights
# is gated on its own (scan_calls_vs_fp64): K1's y and each K5 gradient
# within max(SCAN_CALL_TWIN_FACTOR x the fp32 twin's distance to the fp64
# twin, SCAN_CALL_FLOOR), both over max|fp64|. The highest seen before the
# gate, on an H100 80GB HBM3 at 700 W: 14.19x (U-Mamba Enc SS3D's dA at n =
# 1, 2.25e-06 against 1.58e-07; 6.11x for SegMamba's dD in another run) and
# 1.77e-05 (U-Mamba Enc SS3D's dbias; MedNeXt Mambaskip's dbias 1.72e-05, its
# fp32 twin 1.94e-05): fp32 rounding; the limits stand over twice those.
MAMBA_GRAD_TWIN_FACTOR = 2.0
GATE_SEED = 21
SCAN_CALL_TWIN_FACTOR, SCAN_CALL_FLOOR = 32.0, 4e-5
# the 2-D gates' batch: the fp64 reference and the plain twins at phase 11's
# batch of 4 took 24 s for U-Mamba Enc alone
GATE_BATCH_2D = 2
# where keep_grad_fault keeps a refused gradient check's case for replay
GRAD_FAULT_DIR = Path(__file__).resolve().parent / "chip_smoke_out" / "grad_fault"
MAMBA_GRAD_LEAF_TOL = 0.25
# a conv bias that a norm follows (ROADMAP C3): its gradient is zero in exact
# arithmetic, so the fp64 reference holds only rounding and the leaf bound
# above is a few fp32 ulps. Such a leaf, by its trainer's name pattern, is
# held to NORM_FED_TOL x max|its kernel's fp64 gradient| + 1e-6 (the CPU
# tests' check_grads), provided its own fp64 gradient is rounding there: within
# NORM_FED_FP64 x that max, else the gate fails (a real gradient)
NORM_FED_BIASES = {"nnUNetTrainer_MedNeXt_Mambaskip": (
    r"(^(enc_block|dec_block|bottleneck|down|up)_[\d_]+\.conv1|\.conv_branch\d+)\.bias$")}
NORM_FED_TOL, NORM_FED_FP64 = 2e-4, 1e-9
MAMBA_GRAD_BATCH = MAMBA_BATCH           # the forward and backward that record the scan shapes
MAMBA_KERNELS = ("selective_scan_fwd", "selective_scan_bwd")
MAMBA_DATASET, MAMBA_ID = "Dataset990_ChipSmokeMamba", "990"
MAMBA_RECIPE = "nnUNetTrainerUMambaEnc_chip_smoke"
MAMBA_STEPS, MAMBA_VAL_STEPS, MAMBA_CACHED_STEPS = 5, 2, 3
MAMBA_PLANS = copy.deepcopy(PREDICT_PLANS)
MAMBA_PLANS["configurations"]["2d"].update(
    patch_size=list(MAMBA_PATCH), batch_size=MAMBA_BATCH,
    UNet_base_num_features=MAMBA_FEATURES[0], unet_max_num_features=MAMBA_FEATURES[1],
    conv_kernel_sizes=[[3, 3]] * len(MAMBA_POOLS),
    pool_op_kernel_sizes=[list(p) for p in MAMBA_POOLS],
    n_conv_per_stage_encoder=[2] * len(MAMBA_POOLS),
    n_conv_per_stage_decoder=[2] * (len(MAMBA_POOLS) - 1))
# phase 12: the families that scan at d_state 1 and in 12 directions, at full
# width: the SS3D U-Mambas and VM-UNet-3D's three forms on phase 10's 3-D
# plan (UNET3D_TILE, 6 stages, 32-320 features, batch 2; 3 classes), and
# MSVM-UNet (tiny_0230s) on phase 11's 2d plan (320x320, batch 4; 4 classes)
SS3D_NETWORKS = ("nnUNetTrainerUMambaBot_SS3D", "nnUNetTrainerUMambaEnc_SS3D",
                 "nnUNetTrainer_VMUNet3D", "nnUNetTrainer_VMUNet3D_woinit_new",
                 "nnUNetTrainer_VMUNet3D_woinit_new_SwinT", "nnUNetTrainer_MSVM_UNet")
MSVM_TRAINER = "nnUNetTrainer_MSVM_UNet"
SS3D_3D = tuple(n for n in SS3D_NETWORKS if n != MSVM_TRAINER)
SS3D_BATCH, SS3D_CLASSES = 2, 3
SS3D_SERVED = ("nnUNetTrainerUMambaEnc_SS3D",)   # 88 K1 launches a volume
SS3D_VOLUMES = 1                         # of UNET3D_VOLUME
# the largest scan: U-Mamba Enc SS3D's stage 0 at the training batch
SS3D_LARGEST = (SS3D_BATCH, 12, 2 * UNET3D_FEATURES[0], UNET3D_TILE[0] * UNET3D_TILE[1]
                * UNET3D_TILE[2], 1)
SS3D_RECIPE = "nnUNetTrainerUMambaEnc_SS3D_chip_smoke"
# the 3-D networks' tiles for the card vs CPU check, cut for the CPU (at
# 64x128x128 their CPU forwards took 144 s): U-Mambas 16x64x64, VM-UNet-3D
# 8x32x32 (its stage 3 then 1x1x1)
SS3D_CPU_TILE, VMUNET3D_CPU_TILE = (16, 64, 64), (8, 32, 32)
SS3D_STEPS, SS3D_VAL_STEPS, SS3D_CACHED_STEPS = 3, 2, 2
SS3D_GRAD_BATCH = 1                      # the gradient check: the first training batch's first
# bf16 against fp32 serving is held to TOL_SERVE_REL_L2: bf16 moves JAX's own
# served network of the phase less than that (U-Mamba Enc SS3D 2.773e-02 at
# full width on 16x64x64, on the CPU: tests/port_bf16_gap.py)
# phase 13: the networks of models/mamba_variants.py at full width, seeded:
# SegMamba and nnMamba on phase 10's 3-D plan (nnMamba's strides from its
# pools[1:5]), LightM-UNet and UltraLight VM-UNet on phase 11's 2d plan
VARIANT_NETWORKS = ("nnUNetTrainer_SegMamba", "nnUNetTrainer_nnMamba",
                    "nnUNetTrainer_LightMUNet", "nnUNetTrainer_UltraLightVMUNet")
VARIANT_3D = ("nnUNetTrainer_SegMamba", "nnUNetTrainer_nnMamba")
VARIANT_TRAINER = "nnUNetTrainer_SegMamba"
VARIANT_RECIPE = "nnUNetTrainer_SegMamba_chip_smoke"
VARIANT_VOLUMES = 1
# the 2-D networks' tile for the card vs CPU check, cut for the CPU (LightM-UNet's
# 21 Mamba layers at L = 102,400 made its 320x320 CPU forward the phase's
# slowest step); the scans at 320x320 are held in (a)
VARIANT_CPU_TILE_2D = (128, 128)
# SegMamba's stage 0 at the training batch: 2 x 64 x 64 x 64 tokens, d_inner 96
SEGMAMBA_LARGEST = (SS3D_BATCH, 1, 96, UNET3D_TILE[0] * UNET3D_TILE[1] * UNET3D_TILE[2] // 4, 16)
# SegMamba's bf16 against fp32 serving: within twice the distance bf16 moves
# JAX's own network (full width, on the CPU: 6.196e-02 on 16x64x64;
# tests/port_bf16_gap.py)
SEGMAMBA_BF16_TOL = 2 * 6.196e-02
# phase 14: LKM-UNet and MedNeXt B k3 with and without its Mamba skip at full
# width, seeded, on phase 11's 2d plan (320x320, 4 classes), and LKM-UNet in
# 3-D on phase 10's plan at batch 1 of UNET3D_GRAD_PATCH (its pixel layers
# take the whole-volume fallback there). LKM-UNet's pixel layer at stage 0
# scans 40 x 40 sub-grids of 8 x 8 tokens a patch (d_inner 64), at stage 6 one
# token; the Mamba skip scans its five scales at once
LKM_TRAINER, MEDNEXT_SKIP_TRAINER = "nnUNetTrainer_LKM_UNet", "nnUNetTrainer_MedNeXt_Mambaskip"
LKM_NETWORKS = (LKM_TRAINER, "nnUNetTrainer_MedNeXt", MEDNEXT_SKIP_TRAINER)
LKM_SCANNED = (LKM_TRAINER, MEDNEXT_SKIP_TRAINER)   # the two that call K1 / K5
LKM_RECIPE = "nnUNetTrainer_LKM_UNet_chip_smoke"
LKM_STEPS, LKM_CACHED_STEPS = 5, 2
MEDNEXT_SKIP_STEPS = 2                   # bf16 steps on the cached batch before its per-call gate
LKM_PIXEL_STAGE0 = (MAMBA_BATCH * 40 * 40, 1, 2 * MAMBA_FEATURES[0], 64, 16)
MSMM_L = sum((MAMBA_PATCH[0] >> i) * (MAMBA_PATCH[1] >> i) for i in range(5))   # 136,400
# bf16 against fp32 serving: within twice the distance bf16 moves JAX's own
# network (full width, on the CPU: LKM-UNet 5.463e-02 on a 160x160 6-stage cut
# of the plan, MedNeXt B k3 with its Mamba skip 2.554e-02 on 160x160;
# tests/port_bf16_gap.py)
LKM_BF16_TOL = {LKM_TRAINER: 2 * 5.463e-02, MEDNEXT_SKIP_TRAINER: 2 * 2.554e-02}
# phase 15: the zoo's transformer baselines at full width, seeded, on phase
# 11's 2d plan (320x320, 4 classes): SwinUNETR (feature size 96), Swin-TUNet
# (embed 48), TransUNet (R50-ViT-B/16; its position embedding is the 320x320
# patch's, so its tile is the whole patch, on the CPU too) and MLLA-UNet
# (embed 64). Their attention is plain PyTorch, as in JAX: none reaches a port
# kernel
TRANSFORMER_NETWORKS = ("nnUNetTrainerSwinUNETR_2d", "nnUNetTrainer_SwinTUNet",
                        "nnUNetTrainerTransUNet", "nnUNetTrainer_MLLA_UNet")
# JAX's parameter counts at this plan (tests/test_torch_port_zoo_<network>.py)
TRANSFORMER_JAX_PARAMS = {"nnUNetTrainerSwinUNETR_2d": 100_485_358,
                          "nnUNetTrainer_SwinTUNet": 6_106_915,
                          "nnUNetTrainerTransUNet": 105_426_756,
                          "nnUNetTrainer_MLLA_UNet": 28_504_416}
TRANSFORMER_SERVED = ("nnUNetTrainerTransUNet", "nnUNetTrainer_MLLA_UNet")
TRANSFORMER_TRAINER = "nnUNetTrainer_MLLA_UNet"
TRANSFORMER_RECIPE = "nnUNetTrainer_MLLA_UNet_chip_smoke"
TRANSFORMER_STEPS = 5
TRANSFORMER_GRAD_TILE = (128, 128)       # the fp64 loss and gradients: the tile cut for the CPU
# bf16 against fp32 serving: within twice the distance bf16 moves JAX's own
# network (full width on 160x160, on the CPU: TransUNet 1.531e-02, MLLA-UNet
# 2.537e-02; tests/port_bf16_gap.py)
TRANSFORMER_BF16_TOL = {"nnUNetTrainerTransUNet": 2 * 1.531e-02,
                        "nnUNetTrainer_MLLA_UNet": 2 * 2.537e-02}
# the host-bound preparation (HostPrep): the parts in the order the phases
# need them, made by a side process on PREP_WORKERS spawned workers of
# PREP_THREADS threads (writers, the native resampler) beside phases 3-8
PREP_PARTS = ("train", "flagship_grads", "pipeline", "unet3d", "unet3d_refs", "mamba",
              "tiles_mamba", "tiles_ss3d", "tiles_variants", "tiles_lkm-mednext",
              "tiles_transformers", "mlla_unet_grads")
PREP_WORKERS, PREP_THREADS = 2, 2
HOST_PREP = None                         # main's HostPrep
UNET3D_CASCADE_RECIPE, UNET3D_CASCADE_STEPS = "nnUNetTrainer_chip_smoke_cascade", 2
UNET3D_LOWRES_SPACING = 2.0              # mm: 48x96x96 cases, the patch their size
UNET3D_LOWRES_POOLS = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()
LOG_SINK = None   # a list that takes the lines instead of stdout (the side process, HostPrep)


def log(msg: str) -> None:
    """A line of the run's output, led by the seconds since the script
    started (where each step's time goes)."""
    if LOG_SINK is not None:
        LOG_SINK.append(msg)
        return
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median over ``reps`` of one call's CUDA-event time. A device-side
    sleep of ~1 ms ahead of each call holds the stream while the host
    enqueues the call, so a short kernel's time is its own and not the
    host's launch overhead (which the GPU would otherwise idle through)."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def bound_ms(nbytes: float, flops: float, kind: str, exps: float, exp_per_s: float) -> tuple:
    """The least time for the work: bytes over the memory rate, or the
    operations: FLOPs over the peak rate of their type, with the exps split
    between the SFU and a polynomial on the FP32 pipe so that both end
    together (the pipe also runs the fp32 FLOPs)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind]
    if exps:
        own = flops / PEAK_FLOPS["fp32"] if kind == "fp32" else 0.0
        per_exp = POLY_EXP_FP32_OPS / (PEAK_FLOPS["fp32"] / 2)   # FMA = 2 FLOPs
        t_ops = max(t_ops, (own + exps * per_exp) / (1 + exp_per_s * per_exp))
    t_ops *= 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sfu_exp_per_s(torch) -> float:
    """The card's exp rate: 16 per SM per clock at the maximum SM clock that
    ``nvidia-smi`` reports."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    if not out:
        fail("nvidia-smi gave no clocks.max.sm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = SFU_PER_SM_PER_CLOCK * sms * float(out[0]) * 1e6
    log(f"[device] {sms} SMs, max SM clock {out[0]} MHz: {rate:.4g} exp/s")
    return rate


class Report:
    """Per-kernel numbers of one run, summed per flagship forward."""

    def __init__(self, exp_per_s: float):
        self.rows = {}
        self.exp_per_s = exp_per_s

    def add(self, name, source, replaces, kind="bf16", **vals):
        row = self.rows.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces, kind=kind,
            launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bytes=0.0, flops=0.0, exps=0.0, library_ms=None))
        for k, v in vals.items():
            if k == "max_abs_err":
                row[k] = max(row[k], v)
            elif k == "library_ms":
                row[k] = (row[k] or 0.0) + v
            else:
                row[k] += v

    def finish(self, launches):
        out = []
        for row in self.rows.values():
            t, by = bound_ms(row.pop("bytes"), row.pop("flops"), row.pop("kind"),
                             row.pop("exps"), self.exp_per_s)
            row.update(bound_ms=t, bound_by=by, launches=launches[row["name"]])
            out.append(row)
        return out


def check(label, got, ref, tol) -> float:
    d, r = rel_err(got, ref)
    log(f"  {label}: max_abs_err {d:.3e}  rel {r:.3e}  (tol {tol:g})")
    if not math.isfinite(r) or r > tol:
        fail(f"{label}: relative error {r:.3e} > {tol:g}")
    return d


def phase_kernels(torch, report: Report) -> None:
    from mlagg_unet_torch.ops.flash_attention import attention_reference, flash_attention
    from mlagg_unet_torch.ops.mlla_fused import (
        mlla_front, mlla_front_bf16_operands_plain, mlla_front_plain, mlla_tail,
        mlla_tail_bf16_operands_plain, mlla_tail_plain)
    from mlagg_unet_torch.ops.selective_scan import (
        selective_scan_fwd_tiled_plain, selective_scan_seq_ref)
    from mlagg_unet_torch.ops.selective_scan_cuda import (
        STATE_EVERY, scan_fwd_launch_plan, scan_fwd_occupancy, scan_fwd_plain, selective_scan_fwd)

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    # ---- K1 selective scan forward: (16, 2, 96, 19040), both directions
    log("[kernels] K1 selective_scan_fwd")
    b, g, d, n, L = BM, 2, SCAN_D, SCAN_N, SCAN_L
    A = T(-np.tile(np.arange(1, n + 1, dtype=np.float32), (g, d, 1)))
    dt0 = np.exp(rs.rand(g, d) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = T(dt0 + np.log(-np.expm1(-dt0)))
    Dp = T(1 + 0.1 * rs.randn(g, d))
    full = [T(rs.randn(b, g, d, L) * s) for s in (1.0, 0.5)] + \
           [T(rs.randn(b, g, n, L)) for _ in range(2)]
    props = torch.cuda.get_device_properties(dev)
    k1_ms = 0.0
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        u, dl, Bm, Cm = (t.to(dtype) for t in full)
        plan = scan_fwd_launch_plan(b, g, d, L, dtype, props.multi_processor_count,
                                    props.shared_memory_per_block_optin,
                                    (u, dl, A, Bm, Cm, Dp, bias))
        log(f"  K1 plan ({tag}): {plan}")
        occ = scan_fwd_occupancy(dtype, False, plan.threads[0])
        log(f"  K1 {tag} resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
            + ", ".join(f"{k} {v['ctas_per_sm']} CTAs of {plan.threads[0]} threads = "
                        f"{v['ctas_per_sm'] * plan.threads[0] // 32} warps at {v['registers']} "
                        "registers" for k, v in occ.items()))
        for rev in (False, True):
            args = (u, dl, A, Bm, Cm, Dp, bias, True, rev)
            got, again = selective_scan_fwd(*args), selective_scan_fwd(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"K1 {tag} reverse={rev}: two runs differ")
            tile = STATE_EVERY * plan.tiles_per_cta
            tiled = torch.cat([selective_scan_fwd_tiled_plain(
                *(t[i:i + 4] if t.dim() == 4 else t for t in args[:7]), True, rev, tile)
                for i in range(0, b, 4)])
            err = max(check(f"K1 {tag} reverse={rev} vs plain chunked (bit-equal twice)",
                            got, scan_fwd_plain(*args), TOL_SCAN),
                      check(f"K1 {tag} reverse={rev} vs the tiled twin (tiles of {tile} steps)",
                            got, tiled, TOL_SCAN))
            del got, again, tiled
            if tag == "bf16":
                ms = time_ms(lambda: selective_scan_fwd(*args))
                pms = time_ms(lambda: scan_fwd_plain(*args), reps=5, warmup=1)
                counts, times = profile(torch, f"5 K1 calls (bf16 reverse={rev})",
                                        lambda: ([selective_scan_fwd(*args) for _ in range(5)],
                                                 torch.cuda.synchronize()))
                per = {k: times[k] / counts[k] if counts and counts[k] else None
                       for k in K1_KERNELS}
                k1_ms += ms
                el = b * g * d * L
                nbytes = 2 * el * 2 + 2 * b * g * n * L * 2 + el * 4
                flops = el * (6 * n + 7)
                exps = el * n   # a_t = exp(delta_t A) per (row, d, n, t)
                log(f"  K1 bf16 reverse={rev}: {ms:.4f} ms, plain {pms:.3f} ms; per kernel "
                    + ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f} ms'}"
                                for k, v in per.items())
                    + f"; fp32 scratch {plan.scratch_bytes / 1e6:.1f} MB")
                # elementwise recurrence: no tensor-core form, fp32 rate
                report.add("selective_scan_fwd", "mlagg_unet_torch/csrc/selective_scan_fwd.cu",
                           "mlagg_unet_tpu/ops/selective_scan_pallas.py:172", kind="fp32",
                           max_abs_err=err, ms=ms, plain_ms=pms,
                           bytes=nbytes, flops=flops, exps=exps)
    log(f"  K1 bf16: {k1_ms:.4f} ms per forward (2 launches; {K1_FIRST_MS} ms before its "
        "redesign, H100 80GB HBM3 at 700 W)")
    short = [t[:2, ..., :1024].contiguous() for t in full]
    for rev in (False, True):
        args = (*short[:2], A, *short[2:], Dp, bias, True, rev)
        check(f"K1 fp32 reverse={rev} vs step reference (L=1024)",
              selective_scan_fwd(*args),
              selective_scan_seq_ref(*args[:8], reverse=rev), TOL_SCAN)
    del full, short

    # ---- K2 / K3 MLLA front / tail at every stage, 2 blocks per stage
    for C, N in zip(STAGE_C, STAGE_N):
        M, Hd = BM * N, 2 * C
        log(f"[kernels] K2/K3 mlla front/tail C={C} tokens={M}")
        wsc = 1 / math.sqrt(C)
        raw = dict(x=rs.randn(M, C), lw=1 + 0.1 * rs.randn(C), lb=0.1 * rs.randn(C),
                   wa=rs.randn(C, C) * wsc, ba=0.1 * rs.randn(C),
                   wi=rs.randn(C, C) * wsc, bi=0.1 * rs.randn(C),
                   h=rs.randn(M, C), a=rs.randn(M, C), s=rs.randn(M, C),
                   wo=rs.randn(C, C) * wsc, bo=0.1 * rs.randn(C),
                   w1=rs.randn(Hd, C) * wsc, b1=0.1 * rs.randn(Hd),
                   w2=rs.randn(C, Hd) / math.sqrt(Hd), b2=0.1 * rs.randn(C))
        for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            t = {k: T(v, dtype) for k, v in raw.items()}
            fa = (t["x"], t["lw"], t["lb"], t["wa"], t["ba"], t["wi"], t["bi"])
            ta = (t["h"], t["a"], t["s"], t["wo"], t["bo"], t["lw"], t["lb"],
                  t["w1"], t["b1"], t["w2"], t["b2"])
            got_f, ref = mlla_front(*fa), mlla_front_plain(*fa)
            e_f = max(check(f"K2 {tag} C={C} a", got_f[0], ref[0], tol),
                      check(f"K2 {tag} C={C} h", got_f[1], ref[1], tol))
            got_t = mlla_tail(*ta)
            e_t = check(f"K3 {tag} C={C}", got_t, mlla_tail_plain(*ta), tol)
            if tag != "bf16":
                continue
            again_f, again_t = mlla_front(*fa), mlla_tail(*ta)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got_f, again_f)):
                fail(f"K2 bf16 C={C}: two runs differ")
            if not torch.equal(got_t, again_t):
                fail(f"K3 bf16 C={C}: two runs differ")
            e_f = max(e_f, *(check(f"K2 bf16 C={C} {nm} vs the twin rounding where the kernel "
                                   "does (bit-equal twice)", g, r, TOL_K2_OPERANDS)
                             for nm, g, r in zip("ah", got_f, mlla_front_bf16_operands_plain(*fa))))
            e_t = max(e_t, check(f"K3 bf16 C={C} vs the twin rounding where the kernel does "
                                 "(bit-equal twice)", got_t,
                                 mlla_tail_bf16_operands_plain(*ta), TOL_K3_OPERANDS))
            del got_f, got_t, again_f, again_t
            # the yardstick: cuBLAS doing the same products alone (no LN,
            # GELU, biases or residuals), on inputs of the same shapes
            lin = torch.nn.functional.linear
            zin = T(rs.randn(M, Hd), dtype)
            gemms = {"mlla_front": lambda: (lin(t["x"], t["wa"]), lin(t["x"], t["wi"])),
                     "mlla_tail": lambda: (lin(t["h"], t["wo"]), lin(t["s"], t["w1"]),
                                           lin(zin, t["w2"]))}
            isz = 2
            for name, fn, pfn, args, err, nbytes, flops, rep in (
                    ("mlla_front", mlla_front, mlla_front_plain, fa, e_f,
                     (3 * M * C + 2 * C * C + 6 * C) * isz, 4 * M * C * C,
                     "mlagg_unet_tpu/ops/mlla_fused.py:76"),
                    ("mlla_tail", mlla_tail, mlla_tail_plain, ta, e_t,
                     (4 * M * C + C * C + 2 * C * Hd + 5 * C + Hd) * isz,
                     2 * M * C * C + 4 * M * C * Hd,
                     "mlagg_unet_tpu/ops/mlla_fused.py:48")):
                ms = time_ms(lambda: fn(*args))
                pms = time_ms(lambda: pfn(*args))
                gms = time_ms(gemms[name])
                log(f"  {name} bf16 C={C}: {ms:.4f} ms, plain {pms:.4f} ms, GEMMs alone "
                    f"{gms:.4f} ms (x{DEPTH} per forward)")
                report.add(name, "mlagg_unet_torch/csrc/mlla_fused.cu", rep,
                           max_abs_err=err, ms=DEPTH * ms, plain_ms=DEPTH * pms,
                           library_ms=DEPTH * gms, bytes=DEPTH * nbytes, flops=DEPTH * flops)
            del zin
        del raw, t

    # ---- K4 attention on the pooled branch: 2 calls per block, one per head group
    tiny = torch.zeros(1, device=dev)
    log(f"[kernels] timing floor: one 1-element add {time_ms(lambda: tiny.add_(1)):.4f} ms")
    for C, N, nh in zip(STAGE_C, STAGE_N, POOL_HEADS):
        hd, P = HEAD_DIM, POOL_LK
        scale = hd ** -0.5
        log(f"[kernels] K4 flash_attn_fwd q=({BM},{nh},{N},{hd}) k=({P},{hd}) v=({P},{2 * hd})")
        rq = rs.randn(BM, N, nh, 2, hd) * scale
        rk = rs.randn(BM, P, nh, 2, hd)
        rv = rs.randn(BM, P, nh, 2 * hd)
        for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            qg, kg, v = T(rq, dtype), T(rk, dtype), T(rv, dtype).transpose(1, 2)
            err = 0.0
            for group in (0, 1):
                # the strided head views the model hands the kernel
                q, k = qg[:, :, :, group].transpose(1, 2), kg[:, :, :, group].transpose(1, 2)
                err = max(err, check_attention(torch, f"K4 {tag} nh={nh} group {group}",
                                               q, k, v, scale, tol))
            if tag != "bf16":
                continue
            calls = 2 * DEPTH
            ms = time_ms(lambda: flash_attention(q, k, v, scale))
            pms = time_ms(lambda: attention_reference(q, k, v, scale))
            lms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
            # the same bytes moved by PyTorch: q's strided view read, twice its
            # size written (the output's bytes), no math
            out = torch.empty(BM, nh, N, 2, hd, device=dev, dtype=dtype)
            cms = time_ms(lambda: out.copy_(q.unsqueeze(3).expand(BM, nh, N, 2, hd)))
            log(f"  K4 bf16 nh={nh}: {ms:.4f} ms, plain {pms:.4f} ms, sdpa {lms:.4f} ms, "
                f"copy of the same bytes {cms:.4f} ms (x{calls} per forward)")
            nbytes = (q.numel() + k.numel() + v.numel() + BM * nh * N * 2 * hd) * 2
            flops = 2 * BM * nh * N * P * (hd + 2 * hd)
            report.add("flash_attn_fwd", "mlagg_unet_torch/csrc/flash_attn_fwd.cu",
                       "mlagg_unet_tpu/ops/flash_attention.py:64",
                       max_abs_err=err, ms=calls * ms, plain_ms=calls * pms,
                       library_ms=calls * lms, bytes=calls * nbytes,
                       flops=calls * flops)
        del rq, qg, out
    for b, h, lq, lk, dk, dv in ATTN_EDGES:
        for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            q = T(rs.randn(b, h, lq, dk) * dk ** -0.5, dtype)
            k, v = T(rs.randn(b, h, lk, dk), dtype), T(rs.randn(b, h, lk, dv), dtype)
            check_attention(torch, f"K4 {tag} edge b={b} h={h} lq={lq} lk={lk} dk={dk} dv={dv}",
                            q, k, v, 0.3, tol)


def check_attention(torch, label, q, k, v, scale, tol) -> float:
    """K4 against its plain twin; in bf16 (the tensor-core kernel) also two
    runs bit-equal."""
    from mlagg_unet_torch.ops.flash_attention import attention_reference, flash_attention

    got = flash_attention(q, k, v, scale)
    if q.dtype == torch.bfloat16:
        again = flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{label}: two runs differ")
        label += " (bit-equal twice)"
    return check(label, got, attention_reference(q, k, v, scale), tol)


def phase_scan_train(torch, report: Report) -> None:
    """K1 with states and K5 at the training shapes: batch 10, both scan
    directions, fp32 and bf16 operands, fp32 gy."""
    from mlagg_unet_torch.ops.selective_scan import (
        selective_scan_bwd_plain, selective_scan_bwd_tiled_plain, selective_scan_seq_ref,
        selective_scan_states)
    from mlagg_unet_torch.ops.selective_scan_cuda import (
        STATE_EVERY, scan_bwd_launch_plan, scan_fwd_launch_plan, selective_scan_bwd,
        selective_scan_fwd, selective_scan_fwd_states)

    dev = torch.device("cuda")
    rs = np.random.RandomState(1)

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    b, g, d, n, L = TRAIN_BATCH, 2, SCAN_D, SCAN_N, SCAN_L
    log(f"[kernels] K1 with states and K5 selective_scan_bwd at ({b}, {g}, {d}, {L})")
    props = torch.cuda.get_device_properties(dev)
    plan = scan_bwd_launch_plan(b, g, d, L, torch.bfloat16, props.multi_processor_count,
                                props.shared_memory_per_block_optin)
    log(f"  K5 plan (bf16): {plan}")
    log("  K1 plan (bf16): " + str(scan_fwd_launch_plan(
        b, g, d, L, torch.bfloat16, props.multi_processor_count,
        props.shared_memory_per_block_optin)))
    A = T(-np.tile(np.arange(1, n + 1, dtype=np.float32), (g, d, 1)))
    dt0 = np.exp(rs.rand(g, d) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = T(dt0 + np.log(-np.expm1(-dt0)))
    Dp = T(1 + 0.1 * rs.randn(g, d))
    full = [T(rs.randn(b, g, d, L) * s) for s in (1.0, 0.5)] + \
           [T(rs.randn(b, g, n, L)) for _ in range(2)]
    gy = T(rs.randn(b, g, d, L))
    k5_ms = 0.0
    for dtype, tag, tol in ((torch.float32, "fp32", TOL_SCAN_GRAD),
                            (torch.bfloat16, "bf16", TOL_SCAN_GRAD_BF16)):
        u, dl, Bm, Cm = (t.to(dtype) for t in full)
        for rev in (False, True):
            args = (u, dl, A, Bm, Cm, Dp, bias, True, rev)
            y_s, states = selective_scan_fwd_states(*args)
            y = selective_scan_fwd(*args)
            torch.cuda.synchronize()
            if not torch.equal(y_s, y):
                fail(f"K1 {tag} reverse={rev}: y with states differs from y without")
            log(f"  K1 {tag} reverse={rev}: y with states bit-equal to y without")
            check(f"K1 {tag} reverse={rev} states vs plain scan at tile entries",
                  states, selective_scan_states(u, dl, A, Bm, Cm, bias, True,
                                                STATE_EVERY, rev), TOL_SCAN)
            got = selective_scan_bwd(*args, gy, states)
            again = selective_scan_bwd(*args, gy, states)
            torch.cuda.synchronize()
            if not all(torch.equal(x, a) for x, a in zip(got, again)):
                fail(f"K5 {tag} reverse={rev}: two runs differ")
            del again
            ref = selective_scan_bwd_plain(*args, gy)
            err = max(check(f"K5 {tag} reverse={rev} {nm} (bit-equal twice)", g_, r_, tol)
                      for nm, g_, r_ in zip(names, got, ref))
            del got, ref
            if tag != "bf16":
                continue
            ms = time_ms(lambda: selective_scan_bwd(*args, gy, states))
            pms = time_ms(lambda: selective_scan_bwd_plain(*args, gy), reps=3, warmup=1)
            k1s = time_ms(lambda: selective_scan_fwd_states(*args))
            k1 = time_ms(lambda: selective_scan_fwd(*args))
            c1, t1 = profile(torch, f"5 K1 calls with states (bf16 reverse={rev})",
                             lambda: ([selective_scan_fwd_states(*args) for _ in range(5)],
                                      torch.cuda.synchronize()))
            log(f"  K1 bf16 reverse={rev} at this batch: {k1:.4f} ms, with states {k1s:.4f} ms; "
                "per kernel with states: "
                + ", ".join(f"{k} {t1[k] / c1[k]:.4f} ms" if c1 and c1[k] else f"{k} not measured"
                            for k in K1_KERNELS))
            counts, times = profile(
                torch, f"5 K5 calls (bf16 reverse={rev})",
                lambda: ([selective_scan_bwd(*args, gy, states) for _ in range(5)],
                         torch.cuda.synchronize()))
            per = {k: times[k] / counts[k] if counts and counts[k] else None
                   for k in K5_KERNELS}
            k5_ms += ms
            log(f"  K5 bf16 reverse={rev}: {ms:.4f} ms, plain {pms:.3f} ms; per kernel "
                + ", ".join(f"{k} {'not measured' if v is None else f'{v:.4f} ms'}"
                            for k, v in per.items()))
            el, bc = b * g * d * L, b * g * n * L
            n_tiles = math.ceil(L / STATE_EVERY)
            # each input read once (u, delta, B, C in bf16, gy and the states
            # in fp32, the per-channel parameters), each output written once
            nbytes = (2 * el * 2 + 2 * bc * 2 + el * 4 + b * g * n_tiles * d * n * 4
                      + 2 * (g * d * n + 2 * g * d) * 4 + 2 * el * 2 + 2 * bc * 2)
            # a model of what the kernels request besides, not a measurement:
            # phase 1 reads delta, gy and (per chunk of 32 channels) C again;
            # the fp32 carry, product and dA partials (S bytes each) are
            # written and read once, the carry and dA once more per further
            # tile of a group; dD and dbias partials. The scratch may stay in
            # L2, so this is what the kernels ask of L2 and HBM, at most.
            scratch = b * g * plan.groups * d * n * 4
            asked = (nbytes + el * (2 + 4) + bc * 2 * math.ceil(d / 32)
                     + scratch * (8 + 4 * (plan.tiles_per_cta - 1))
                     + 4 * b * g * plan.groups * d * 4)
            log(f"  K5 bf16 reverse={rev}: model estimate (not measured) of the bytes "
                f"requested: {asked / 1e6:.1f} MB, the function's {nbytes / 1e6:.1f} and "
                f"{(asked - nbytes) / 1e6:.1f} more (phase 1's second read of delta, gy "
                f"and C; {scratch / 1e6:.1f} MB of fp32 scratch per array, and partials)")
            # ~15 fp32 operations per (row, channel, state, step) for the h
            # recompute, the adjoint and the contractions; ~10 per channel
            # step; at least one exp per (row, channel, state, step)
            report.add("selective_scan_bwd", "mlagg_unet_torch/csrc/selective_scan_bwd.cu",
                       "mlagg_unet_tpu/ops/selective_scan_pallas.py:274", kind="fp32",
                       max_abs_err=err, ms=ms, plain_ms=pms, bytes=nbytes,
                       flops=15 * el * n + 10 * el, exps=el * n)
    log(f"  K5 bf16: {k5_ms:.4f} ms per train step (2 launches; {K5_FIRST_MS} ms before "
        "its redesign, H100 80GB HBM3 at 700 W)")
    del full, gy

    # K5 against autograd through the step-by-step scan (ground truth) and
    # against the twin that splits the work over tiles as K5 does
    short = [T(rs.randn(2, g, d, 1024) * s) for s in (1.0, 0.5)] + \
            [T(rs.randn(2, g, n, 1024)) for _ in range(2)]
    gs = T(rs.randn(2, g, d, 1024))
    for rev in (False, True):
        leaves = [t.clone().requires_grad_() for t in (*short[:2], A, *short[2:], Dp, bias)]
        y = selective_scan_seq_ref(*leaves, delta_softplus=True, reverse=rev)
        ref = torch.autograd.grad(y, leaves, gs)
        ops = (*short[:2], A, *short[2:], Dp, bias, True, rev)
        _, states = selective_scan_fwd_states(*ops)
        got = selective_scan_bwd(*ops, gs, states)
        tiled = selective_scan_bwd_tiled_plain(*ops, gs)
        for nm, g_, r_, t_ in zip(names, got, ref, tiled):
            check(f"K5 fp32 reverse={rev} {nm} vs autograd of the step scan (L=1024)",
                  g_, r_, TOL_SCAN_GRAD)
            check(f"K5 fp32 reverse={rev} {nm} vs the tiled twin (L=1024)", g_, t_,
                  TOL_SCAN_GRAD)


def phase_fused_kernels(torch, report: Report) -> None:
    """K6 at the four stages' local halves, K7 and K8 at the UNETR head."""
    from mlagg_unet_torch.ops.fused_norm import (
        fused_instance_norm, instance_norm_apply, instance_norm_apply_plain,
        instance_norm_plain, instance_norm_stats, instance_norm_stats_plain)
    from mlagg_unet_torch.ops.mlla_attn_fused import (
        local_aggregated_attention_fused, local_attention_fused_plain)

    dev = torch.device("cuda")
    rs = np.random.RandomState(2)

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    # ---- K6 fused local attention: the local half of each block, 2 per stage
    lam = torch.tensor(0.37, device=dev)
    lin = torch.nn.functional.linear
    for H, W, ch, nh in LOCAL_SHAPES:
        hd = ch // nh // 2
        log(f"[kernels] K6 local_attn_fused ({BM}, {H}, {W}, {ch}) nh={nh}")
        raw = (rs.randn(BM, H, W, ch) * 0.5, rs.randn(ch, ch) / math.sqrt(ch),
               0.1 * rs.randn(ch), rs.randn(2 * ch, ch) / math.sqrt(ch),
               0.1 * rs.randn(2 * ch), 1 + 0.2 * rs.randn(2 * hd),
               rs.randn(ch, 1, 3, 3) / 3, 0.1 * rs.randn(ch))
        for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            args = (*(T(a, dtype) for a in raw), lam, nh)
            got = local_aggregated_attention_fused(*args)
            ref = local_attention_fused_plain(*args)
            err = check(f"K6 {tag} ch={ch}", got, ref, tol)
            if tag != "bf16":
                continue
            again = local_aggregated_attention_fused(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"K6 bf16 ch={ch}: two runs differ")
            err = max(err, check(f"K6 bf16 ch={ch} vs the twin, which rounds where the kernel "
                                 "does (bit-equal twice)", got, ref, TOL_K6_TWIN))
            del got, again, ref
            x, wq, bq, wkv, bkv = args[:5]
            ms = time_ms(lambda: local_aggregated_attention_fused(*args))
            pms = time_ms(lambda: local_attention_fused_plain(*args), reps=5, warmup=1)
            # the yardstick: cuBLAS doing the three projections alone
            gms = time_ms(lambda: (lin(x, wq, bq), lin(x, wkv, bkv)))
            log(f"  K6 bf16 ch={ch}: {ms:.4f} ms, plain {pms:.3f} ms, GEMMs alone {gms:.4f} ms "
                f"(x{DEPTH} per forward)")
            tok = BM * H * W
            # x read once, the output written once, the weights read once
            nbytes = (2 * tok * ch + 3 * ch * ch + 14 * ch + 2 * hd) * 2
            # q, k, v projections; per head and token 9 taps of the two
            # branches' logits, the combine and the LePE over 2 hd channels
            flops = 6 * tok * ch * ch + tok * nh * 9 * 3 * 2 * (2 * hd)
            report.add("local_attn_fused", "mlagg_unet_torch/csrc/mlla_local_attn.cu",
                       "mlagg_unet_tpu/ops/mlla_attn_fused.py:46",
                       max_abs_err=err, ms=DEPTH * ms, plain_ms=DEPTH * pms,
                       library_ms=DEPTH * gms, bytes=DEPTH * nbytes, flops=DEPTH * flops)
        del args

    # ---- K7 / K8 fused instance norm at the UNETR head: (16, 256, 224, 48)
    shape = (BM, *TILE, NORM_C)
    log(f"[kernels] K7/K8 instance norm {shape}")
    raw_x, raw_r = rs.randn(*shape) * 2 + 0.5, rs.randn(*shape) - 0.3
    vec = [T(1 + 0.2 * rs.randn(NORM_C)), T(0.1 * rs.randn(NORM_C)),
           T(1 + 0.2 * rs.randn(NORM_C)), T(0.1 * rs.randn(NORM_C))]

    def modes(r):
        return ((0, {}), (1, dict(residual=r)),
                (2, dict(residual=r, res_scale=vec[2], res_bias=vec[3])))

    for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                            (torch.bfloat16, "bf16", TOL_BF16)):
        x, r = T(raw_x, dtype), T(raw_r, dtype)
        x3, r3 = x.view(BM, -1, NORM_C), r.view(BM, -1, NORM_C)
        st = instance_norm_stats(x3)
        e7 = check(f"K7 {tag} stats", st, instance_norm_stats_plain(x3), TOL_FP32)
        rst = instance_norm_stats(r3)
        e8 = 0.0
        for mode, kw in modes(r):
            for act in (False, True):
                got = fused_instance_norm(x, *vec[:2], act=act, **kw)
                again = fused_instance_norm(x, *vec[:2], act=act, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"K7+K8 {tag} mode={mode} act={act}: two runs differ")
                e8 = max(e8, check(f"K7+K8 {tag} mode={mode} act={act} (bit-equal twice)",
                                   got, instance_norm_plain(x, *vec[:2], act=act, **kw), tol))
        if tag == "fp32":
            for mode, kw in modes(r):   # autograd on the card: K7 + K8 forward
                leaves = [t.clone().requires_grad_() for t in (x, *vec[:2], *kw.values())]
                go = T(rs.randn(*shape))
                grads = []
                for fn in (fused_instance_norm, instance_norm_plain):
                    out = fn(*leaves[:3], act=True, **dict(zip(kw, leaves[3:])))
                    grads.append(torch.autograd.grad(out, leaves, go))
                for i, (g_, r_) in enumerate(zip(*grads)):
                    check(f"K7+K8 autograd mode={mode} grad {i}", g_, r_, TOL_FP32)
            continue
        a0 = (x3, st, *vec[:2])
        a2 = (x3, st, *vec[:2], r3, rst, *vec[2:])
        e8 = max(e8, check("K8 bf16 mode 2 alone", instance_norm_apply(*a2, act=True),
                           instance_norm_apply_plain(*a2, act=True), tol))
        t7 = time_ms(lambda: instance_norm_stats(x3))
        p7 = time_ms(lambda: instance_norm_stats_plain(x3))
        t8 = [time_ms(lambda: instance_norm_apply(*a, act=True)) for a in (a0, a2)]
        p8 = [time_ms(lambda: instance_norm_apply_plain(*a, act=True)) for a in (a0, a2)]
        xp = x.permute(0, 3, 1, 2)
        w16, b16 = vec[0].to(dtype), vec[1].to(dtype)
        lib = time_ms(lambda: torch.nn.functional.instance_norm(xp, weight=w16, bias=b16,
                                                                eps=1e-5))
        log(f"  K7 bf16: {t7:.3f} ms, plain {p7:.3f} ms (x{NORM_STATS} per forward); "
            f"K8 bf16 mode 0 / 2: {t8[0]:.3f} / {t8[1]:.3f} ms, plain {p8[0]:.3f} / "
            f"{p8[1]:.3f} ms (x{NORM_APPLY[0]} / x{NORM_APPLY[1]}); "
            f"F.instance_norm {lib:.3f} ms (x{NORM_STATS})")
        el = x.numel()
        report.add("instance_norm_stats", "mlagg_unet_torch/csrc/fused_norm.cu",
                   "mlagg_unet_tpu/ops/fused_norm.py:68", kind="fp32",
                   max_abs_err=e7, ms=NORM_STATS * t7, plain_ms=NORM_STATS * p7,
                   bytes=NORM_STATS * (el * 2 + BM * 2 * NORM_C * 4),
                   flops=NORM_STATS * 3 * el)
        # mode 0 reads x and writes y; mode 2 also reads the residual; ~8
        # operations per element and normalised tensor
        n0, n2 = NORM_APPLY
        report.add("instance_norm_apply", "mlagg_unet_torch/csrc/fused_norm.cu",
                   "mlagg_unet_tpu/ops/fused_norm.py:88", kind="fp32",
                   max_abs_err=e8, ms=n0 * t8[0] + n2 * t8[1],
                   plain_ms=n0 * p8[0] + n2 * p8[1],
                   # six F.instance_norm calls, stats included: the library's
                   # cost of the forward's six normalisations (compare K7 + K8)
                   library_ms=NORM_STATS * lib,
                   bytes=(n0 * 2 + n2 * 3) * el * 2, flops=(n0 * 8 + n2 * 17) * el)
    del x, r, x3, r3


def phase_model(torch):
    from mlagg_unet_torch import build_flagship

    log("[model] full-width flagship, one 256x224 tile, fp32 card vs CPU")
    model = build_flagship(num_classes=4, seed=0, device="cuda", **DEFAULT)
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  params: {nparams}")
    x = np.random.RandomState(0).randn(1, *TILE, 1).astype(np.float32)
    with torch.inference_mode():
        gpu = model(torch.from_numpy(x).cuda())
        t0 = time.perf_counter()
        cpu = copy.deepcopy(model).cpu()(torch.from_numpy(x))
        log(f"  CPU forward: {time.perf_counter() - t0:.1f} s")
    if len(gpu) != 5:
        fail(f"expected 5 outputs, got {len(gpu)}")
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        if g.shape != c.shape or not torch.isfinite(g).all():
            fail(f"output {i}: shape {tuple(g.shape)} vs {tuple(c.shape)} or not finite")
        check(f"output {i} {tuple(g.shape)}", g.cpu(), c, TOL_MODEL)
    with torch.inference_mode():
        xb = torch.from_numpy(np.random.RandomState(1).rand(BM, *TILE, 1)
                              .astype(np.float32)).cuda().bfloat16()
        model16 = copy.deepcopy(model).bfloat16()
        outs = model16(xb)
        torch.cuda.synchronize()
        for i, o in enumerate(outs):
            if o.dtype != torch.bfloat16 or not torch.isfinite(o).all():
                fail(f"bf16 batch-{BM} output {i}: {o.dtype}, "
                     f"finite={bool(torch.isfinite(o).all())}")
        fwd_ms = time_ms(lambda: model16(xb), reps=5, warmup=1)
    log(f"  bf16 forward at model batch {BM}: 5 finite outputs, out0 "
        f"{tuple(outs[0].shape)}, {fwd_ms:.2f} ms (median of 5)")
    return model


def phase_model_fused(torch, model):
    """The same seeded weights in the fused configuration: fp32 on the card
    against the default configuration on the card, then a bf16 forward."""
    from mlagg_unet_torch import build_flagship

    log("[model] fused configuration (fused_local_attn, fused_instance_norm), "
        "one tile, fp32, against the default configuration on the card")
    fused = build_flagship(num_classes=4, seed=0, device="cuda", **FUSED)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, *TILE, 1)
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        got, ref = fused(x), model(x)
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"fused output {i}: shape {tuple(g.shape)} vs {tuple(r.shape)} or not finite")
        check(f"fused vs default output {i} {tuple(g.shape)}", g, r, TOL_MODEL)
    with torch.inference_mode():
        xb = torch.from_numpy(np.random.RandomState(1).rand(BM, *TILE, 1)
                              .astype(np.float32)).cuda().bfloat16()
        f16, d16 = copy.deepcopy(fused).bfloat16(), copy.deepcopy(model).bfloat16()
        for o in f16(xb):
            if o.dtype != torch.bfloat16 or not torch.isfinite(o).all():
                fail(f"fused bf16 batch-{BM} output: {o.dtype}, "
                     f"finite={bool(torch.isfinite(o).all())}")
        # in turns, on one card: default, fused, fused, default
        d_ms = [time_ms(lambda: d16(xb), reps=5, warmup=1)]
        f_ms = [time_ms(lambda: f16(xb), reps=5, warmup=1) for _ in range(2)]
        d_ms.append(time_ms(lambda: d16(xb), reps=5, warmup=1))
    log(f"  bf16 forward at model batch {BM}: fused {f_ms[0]:.2f} / {f_ms[1]:.2f} ms, "
        f"default {d_ms[0]:.2f} / {d_ms[1]:.2f} ms (medians of 5; default, fused, "
        f"fused, default)")
    del f16, d16
    return fused


def is_port_kernel(key: str, name: str) -> bool:
    """Whether a profiler key is the port's kernel ``name``: every port
    kernel is in an anonymous namespace (a bare substring also matches
    PyTorch's own kernels, e.g. ``apply_kernel``). A template kernel's key
    starts with its return type, ``void``; a plain function's has none."""
    return re.match(rf"(void )?\(anonymous namespace\)::{name}[<(]", key) is not None


def profile(torch, label, fn, stats: dict = None) -> tuple:
    """Device time by kernel over one call of ``fn`` (which ends in a sync),
    the port's kernels against the rest, and the device's busy share of the
    wall time (torch.profiler, whose own host overhead is in the wall time).
    Returns two dicts, each port kernel's launch count and device ms in the
    trace ((None, None): no device time recorded); ``stats``, when given,
    receives the wall and busy ms. The device events (kernels, copies,
    memsets) are summed by name from the trace's raw events: the same sums
    as ``key_averages()``'s device rows, without the event tree it builds
    first, which took most of a long trace's time. A torch whose profiler
    has no raw events (``kineto_results`` is private) is read through
    ``key_averages()``."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    else:
        by_name = defaultdict(lambda: [0.0, 0])
        for e in raw.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                row = by_name[e.name()]
                row[0] += e.duration_ns() / 1e6
                row[1] += 1
        dev = [(k, t, c) for k, (t, c) in by_name.items()]
    if not dev:
        log("  profile: no device time recorded (not measured)")
        return None, None
    busy_ms = sum(t for _, t, _ in dev)
    if stats is not None:
        stats.update(wall_ms=wall_ms, busy_ms=busy_ms)
    ours = sum(t for k, t, _ in dev if any(is_port_kernel(k, n) for n in PORT_KERNEL_NAMES))
    log(f"  profile of {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(c for *_, c in dev)} device ops; "
        f"port kernels {ours:.1f} ms ({100 * ours / busy_ms:.1f}% of busy)")
    for key, t, count in sorted(dev, key=lambda r: -r[1])[:15]:
        log(f"    {t:9.2f} ms {100 * t / busy_ms:5.1f}% x{count:<5d} {key[:100]}")
    counts, times = {}, {}
    for name in PORT_KERNEL_NAMES:   # each port kernel, all its instantiations
        t, count = (sum(r[i] for r in dev if is_port_kernel(r[0], name)) for i in (1, 2))
        counts[name], times[name] = count, t
        if count:
            log(f"    port {name}: {t:.2f} ms ({100 * t / busy_ms:.1f}% of busy) x{count}")
    return counts, times


def phase_serve(torch, model, label, required, forbidden=()):
    from mlagg_unet_torch import VolumePredictor
    from mlagg_unet_torch.ops import _ext

    log(f"[serve] {label} configuration: VolumePredictor, 8 volumes of 1x10x320x260, "
        "mirror (0, 1), bf16")
    rng = np.random.RandomState(0)
    volumes = [rng.rand(1, 10, 320, 260).astype(np.float32) for _ in range(8)]
    pred = VolumePredictor(model, TILE, 4, mirror_axes=(0, 1), tile_batch_size=4,
                           compute_dtype=torch.bfloat16, device="cuda")
    ref32 = VolumePredictor(model, TILE, 4, mirror_axes=(0, 1), tile_batch_size=4,
                            device="cuda")(volumes[0])
    first = pred(volumes[0])                     # warm-up
    d = np.linalg.norm(first - ref32) / np.linalg.norm(ref32)
    log(f"  bf16 vs fp32 serving of volume 0: rel L2 {d:.3e} (tol {TOL_SERVE_REL_L2:g})")
    if not d <= TOL_SERVE_REL_L2:
        fail(f"bf16 serving disagrees with fp32 serving: rel L2 {d:.3e}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    outs, elapsed, queued = serve_window(pred, volumes)
    launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for o in outs:
        if o.shape != (4, 10, 320, 260) or not np.isfinite(o).all():
            fail(f"serve output {o.shape}, finite={bool(np.isfinite(o).all())}")
    vps = len(volumes) / elapsed
    log(f"  {vps:.4f} volumes/s ({elapsed:.3f} s for {len(volumes)}; the serving slice's first run "
        f"measured {SERVE_FIRST_VOLUMES_PER_S} on an H100 80GB HBM3 at 700 W), peak memory "
        f"{peak:.2f} GiB, model batch {pred.model_batch}")
    log(f"  host ms of each predict_device call (queueing): "
        f"{', '.join(f'{q:.1f}' for q in queued)}")
    log(f"  launches in the serve run: {launches}")
    for name in required:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {label} serving path")
    for name in forbidden:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the {label} serving path")
    # bf16 serving runs K2 and K3 as the tensor-core kernels, 8 each per forward
    want = DEPTH * len(STAGE_C) * FORWARDS_PER_VOLUME
    fused = "local_attn_fused" in required
    for attempt in range(1, PROFILE_TRIES + 1):
        _ext.reset_launch_counts()
        counts, _ = profile(torch, f"one volume ({label})", lambda: pred(volumes[1]))  # returns on the host
        if counts is None:
            fail(f"{label} serve profile: no device time recorded")
        wrapped = {k.name: k.launches for k in _ext.ALL_KERNELS}
        short = {w: wrapped[w] - sum(counts[n] for n in names) for w, names in PROFILED.items()}
        short.update({k: wrapped["selective_scan_fwd"] - counts[k] for k in K1_KERNELS})
        if any(v < 0 for v in short.values()):
            fail(f"{label} serve profile: the trace holds more launches than the wrappers "
                 f"made ({short})")
        if not any(short.values()):
            break
        log(f"  trace {attempt} of {PROFILE_TRIES} lost device records: it is short of "
            f"the wrappers' launches by {short}; tracing the volume again")
    else:
        fail(f"{label} serve profile: no complete trace in {PROFILE_TRIES} tries")
    k1_want = 2 * FORWARDS_PER_VOLUME   # one call per scan direction and forward
    if wrapped["selective_scan_fwd"] != k1_want or any(counts[k] != k1_want for k in K1_KERNELS):
        fail(f"{label} serve profile: K1 called {wrapped['selective_scan_fwd']} times, its "
             f"kernels ran {[counts[k] for k in K1_KERNELS]} times (want {k1_want} each)")
    for name, n in (("mlla_front", want), ("mlla_tail", want),
                    ("local_attn_fused", want if fused else 0)):
        if wrapped[name] != n:
            fail(f"{label} serve profile: {name} launched {wrapped[name]} times in one "
                 f"volume (want {n})")
    for k, mma, scalar in (("K2", "front_mma_kernel", "front_kernel"),
                           ("K3", "tail_mma_kernel", "tail_kernel")):
        if counts[mma] != want or counts[scalar] != 0:
            fail(f"{label} serve profile: {k} ran as {mma} {counts[mma]} times "
                 f"(want {want}) and as the scalar {scalar} {counts[scalar]} "
                 "times (want 0)")
    # K6 runs only in the fused configuration, as the tensor-core kernel
    k6 = {"local_attn_mma_kernel": want if fused else 0, "local_attn_kernel": 0}
    if any(counts[k] != n for k, n in k6.items()):
        fail(f"{label} serve profile: K6 ran as local_attn_mma_kernel "
             f"{counts['local_attn_mma_kernel']} times and as the scalar local_attn_kernel "
             f"{counts['local_attn_kernel']} times (want {k6})")
    log(f"  profile: {', '.join(K1_KERNELS)} x{k1_want} each, "
        f"front_mma_kernel and tail_mma_kernel x{want}, front_kernel and "
        f"tail_kernel x0, local_attn_mma_kernel x{k6['local_attn_mma_kernel']}, "
        "local_attn_kernel x0, as required")
    return launches, vps


def serve_window(pred, volumes) -> tuple:
    """Every volume queued (``predict_device``), then each fetched: the
    outputs, the seconds, and the host ms of each queueing call."""
    queued, pending = [], []
    t0 = time.perf_counter()
    for v in volumes:
        t = time.perf_counter()
        pending.append(pred.predict_device(v))
        queued.append(1e3 * (time.perf_counter() - t))
    outs = [pred.finalize(p) for p in pending]
    return outs, time.perf_counter() - t0, queued


def serve_timing(torch, card: str) -> None:
    """Phase 5's default serve timing alone, from the package under
    ``REPO`` (``--root``): the flagship, 8 volumes of 1x10x320x260, tile
    batch 4, bf16, mirror (0, 1), 1 warm-up volume, then two windows of the
    8 volumes queued and fetched. The first window is phase 5's figure.
    Run it for two trees in turns in one call to compare them."""
    from mlagg_unet_torch import VolumePredictor, build_flagship

    model = build_flagship(num_classes=4, seed=0, device="cuda", **DEFAULT)
    rng = np.random.RandomState(0)
    volumes = [rng.rand(1, 10, 320, 260).astype(np.float32) for _ in range(8)]
    pred = VolumePredictor(model, TILE, 4, mirror_axes=(0, 1), tile_batch_size=4,
                           compute_dtype=torch.bfloat16, device="cuda")
    pred(volumes[0])
    for window in (1, 2):
        torch.cuda.synchronize()
        _, elapsed, queued = serve_window(pred, volumes)
        log(f"[serve timing] {REPO}: window {window}: {len(volumes) / elapsed:.4f} volumes/s "
            f"({elapsed:.3f} s for {len(volumes)}); host ms of each predict_device call "
            f"{', '.join(f'{q:.1f}' for q in queued)} | {card}")


@contextlib.contextmanager
def plain_twins(_ext):
    """Every kernel wrapper runs its plain PyTorch twin, on the card too."""
    use_plain = _ext.use_plain
    _ext.use_plain = lambda t: True
    try:
        yield
    finally:
        _ext.use_plain = use_plain


@contextlib.contextmanager
def recording_scan_plans(plans: dict):
    """While active, K1's wrapper keeps each launch plan it makes in
    ``plans``, keyed by (b, g, d, L, dtype) of its input u."""
    from mlagg_unet_torch.ops import selective_scan_cuda

    make = selective_scan_cuda.scan_fwd_launch_plan

    def recording(b, g, d, L, dtype, *args, **kwargs):
        plan = make(b, g, d, L, dtype, *args, **kwargs)
        plans[(b, g, d, L, str(dtype).replace("torch.", ""))] = plan
        return plan

    selective_scan_cuda.scan_fwd_launch_plan = recording
    try:
        yield
    finally:
        selective_scan_cuda.scan_fwd_launch_plan = make


def predictors_vs_twins(torch, card: str, label: str, predictors, data, model_batch: int):
    """Each (tag, VolumePredictor) of ``predictors`` on ``data`` with the
    kernels, then with every kernel wrapper switched to its plain twin on
    the card: bf16 within TOL_SERVE_REL_L2 (rel L2), fp32 within TOL_MODEL x
    max|ref|. Fails unless the kernel run launched each of K1-K4, K1 only at
    ``model_batch``, and the plain run launched nothing; logs K1's launch
    plans."""
    from mlagg_unet_torch.ops import _ext

    for tag, p in predictors:
        plans = {}
        _ext.reset_launch_counts()
        with recording_scan_plans(plans):
            got = p(data)
        ran = {k.name: k.launches for k in _ext.ALL_KERNELS}
        _ext.reset_launch_counts()
        with plain_twins(_ext):
            ref = p(data)
        if any(k.launches for k in _ext.ALL_KERNELS):
            fail(f"the plain-twin run of the {tag} predictor launched a kernel")
        for shape, plan in plans.items():
            log(f"  K1 plan at (b, g, d, L, dtype) {shape} ({tag}): {plan}")
        batches = sorted({shape[0] for shape in plans})
        if any(ran[name] <= 0 for name in SERVE_KERNELS) or p.model_batch != model_batch \
                or batches != [model_batch]:
            fail(f"the {tag} predictor ran K1-K4 {[ran[n] for n in SERVE_KERNELS]} times, "
                 f"K1 at batches {batches}, at model batch {p.model_batch} (want > 0 each, "
                 f"at {model_batch})")
        err, peak = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        l2 = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        agree = float((got.argmax(0) == ref.argmax(0)).mean())
        ok = l2 <= TOL_SERVE_REL_L2 if tag == "bf16" else err <= TOL_MODEL * peak
        log(f"  {label}, {tag}, model batch {p.model_batch}: kernels (K1-K4 "
            f"{[ran[n] for n in SERVE_KERNELS]} launches) vs plain twins on the card: rel L2 "
            f"{l2:.3e}, max|diff| {err:.3e} of max {peak:.3e}, argmax {100 * agree:.4f} % "
            f"equal (tol "
            + (f"rel L2 {TOL_SERVE_REL_L2:g})" if tag == "bf16" else f"{TOL_MODEL:g} x max)")
            + f" | {card}")
        if not ok:
            fail(f"{label}, {tag}: the kernels at model batch {p.model_batch} disagree with "
                 f"their plain twins")


@contextlib.contextmanager
def recording_selves(cls, method: str, selves: list):
    """While active, each call of ``cls.method`` appends its instance to
    ``selves``."""
    orig = getattr(cls, method)

    def wrapped(self, *args, **kwargs):
        selves.append(self)
        return orig(self, *args, **kwargs)

    setattr(cls, method, wrapped)
    try:
        yield
    finally:
        setattr(cls, method, orig)


def synthetic_batch(torch, batch: int, seed: int = 0):
    """A seeded (batch, 256, 224, 1) image of smooth blobs and its 4-class
    label, a fixed function of the image (three thresholds)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 1, *TILE, generator=g)
    for _ in range(3):  # smooth: blobs a few pixels wide
        x = torch.nn.functional.avg_pool2d(x, 9, stride=1, padding=4,
                                           count_include_pad=False)
    x = ((x - x.mean()) / x.std()).permute(0, 2, 3, 1).contiguous()
    y = torch.bucketize(x[..., 0], torch.tensor([-0.5, 0.3, 1.0]))
    return x, y


def train_grads(trainer, network, x, y):
    """Loss and every parameter's gradient of one batch through ``network``
    with the trainer's loss (a parameter the loss does not reach, such as
    the head of a deep-supervision output of weight 0, has none)."""
    network.zero_grad(set_to_none=True)
    loss = trainer.loss(network(x), y)
    loss.backward()
    return loss.item(), {k: p.grad.float().cpu() for k, p in network.named_parameters()
                         if p.grad is not None}


def compare_grads(torch, label, l_got, g_got, l_ref, g_ref) -> None:
    d = abs(l_got - l_ref) / abs(l_ref)
    log(f"  loss {label}: {l_got:.7f} vs {l_ref:.7f}: rel {d:.3e} (tol {TOL_TRAIN_LOSS:g})")
    if not d <= TOL_TRAIN_LOSS:
        fail(f"fp32 training loss {label}: rel {d:.3e}")
    worst = (0.0, "")
    for k, r in g_ref.items():
        g = g_got[k]
        if not torch.isfinite(g).all():
            fail(f"gradient {k} not finite ({label})")
        err = (g - r).abs().max().item()
        bound = TOL_TRAIN_GRAD * r.abs().max().item() + 1e-6
        if not err <= bound:
            fail(f"gradient {k} ({label}): max |diff| {err:.3e} > {bound:.3e}")
        worst = max(worst, (err / bound, k))
    log(f"  {len(g_ref)} parameter gradients within {TOL_TRAIN_GRAD:g} x max|ref| + 1e-6; "
        f"closest to its bound: {worst[1]} at {worst[0]:.3f} of it")


def flagship_cpu_grads(torch):
    """Phase 7's CPU side: the default configuration's fp32 batch (the
    seeded flagship, drop path off; ``synthetic_batch`` seed 1) on the CPU:
    (loss, gradients) and the seconds."""
    from mlagg_unet_torch import Trainer

    t0 = time.perf_counter()
    tr = Trainer("nnUNetTrainer_MLAgg_2D_dt_MS", TILE, 1, 1, 4, seed=0, device="cpu",
                 compute_dtype=torch.float32,
                 network_overrides=dict(drop_path_rate=0.0, skip_drop_path=0.0, **DEFAULT))
    x, y = synthetic_batch(torch, 1, seed=1)
    return train_grads(tr, tr.network, x, y), time.perf_counter() - t0


def phase_train(torch, fused_in: bool = False):
    """The default configuration (fp32 batch held against the CPU), then
    the timed bf16 steps; or with ``fused_instance_norm`` the fp32 batch
    alone, held against the default network on the card (the same seeded
    weights), with its launches: K1, K4, K5, K7 and K8, and no other."""
    from mlagg_unet_torch import Trainer
    from mlagg_unet_torch.ops import _ext

    name = "nnUNetTrainer_MLAgg_2D_dt_MS"
    label = "fused_instance_norm" if fused_in else "default"
    config = dict(DEFAULT, fused_instance_norm=fused_in)
    no_drop = dict(drop_path_rate=0.0, skip_drop_path=0.0)
    required = TRAIN_KERNELS + (NORM_KERNELS if fused_in else ())
    log(f"[train] {label} configuration: {name}, full-width flagship, fp32 batch 1 "
        f"(drop path off), card vs {'default on the card' if fused_in else 'CPU'}")
    tr = Trainer(name, TILE, 1, 1, 4, seed=0, device="cuda", compute_dtype=torch.float32,
                 network_overrides=dict(no_drop, **config))
    x, y = synthetic_batch(torch, 1, seed=1)
    _ext.reset_launch_counts()
    l_got, g_got = train_grads(tr, tr.network, x.cuda(), y.cuda())
    launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
    t0 = time.perf_counter()
    if fused_in:
        ref = Trainer(name, TILE, 1, 1, 4, seed=0, device="cuda",
                      compute_dtype=torch.float32,
                      network_overrides=dict(no_drop, **DEFAULT))
        l_ref, g_ref = train_grads(ref, ref.network, x.cuda(), y.cuda())
        del ref
    else:   # the same seeded network and batch on the CPU, made by HostPrep
        (l_ref, g_ref), cpu_s = HOST_PREP.folder("flagship_grads")[1]
        log(f"  CPU forward + backward: {cpu_s:.1f} s (the network built on the CPU)")
    compare_grads(torch, "card vs " + ("default" if fused_in else "CPU"), l_got, g_got, l_ref, g_ref)
    del tr, g_got, g_ref
    if fused_in:
        log(f"  launches in the fp32 batch: {launches}")
        if any(launches[k] <= 0 for k in required) or any(
                v for k, v in launches.items() if k not in required):
            fail(f"the {label} training batch launched {launches} (want {required} only)")
        return launches, None

    log(f"[train] {label}: bf16 steps at batch {TRAIN_BATCH}, {TILE[0]}x{TILE[1]}, drop path on")
    tr = Trainer(name, TILE, TRAIN_BATCH, 1, 4, seed=0, device="cuda",
                 network_overrides=config)
    x, y = (t.cuda() for t in synthetic_batch(torch, TRAIN_BATCH, seed=2))
    warm = tr.run_steps([(x, y)] * TRAIN_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    timed = tr.run_steps([(x, y)] * TRAIN_STEPS)   # ends in a host sync
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + timed
    ms = elapsed / TRAIN_STEPS * 1e3
    log(f"  {ms:.2f} ms per step, {TRAIN_BATCH * TRAIN_STEPS / elapsed:.3f} images/s "
        f"(10 steps in {elapsed:.3f} s), peak memory {peak:.2f} GiB")
    log(f"  losses: first {losses[0]:.5f}, last {losses[-1]:.5f}; all {['%.5f' % v for v in losses]}")
    log(f"  launches in the {TRAIN_STEPS} timed steps: {launches}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall ({label}): first {losses[0]}, last {losses[-1]}")
    for k in required:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {label} training path")
    for k in set(launches) - set(required):
        if launches[k] != 0:
            fail(f"kernel {k} (no backward) was launched on the {label} training path")
    # a step runs K5 once per scan direction, each call its three kernels; a
    # trace that holds fewer of them than the wrapper counted lost device
    # records in torch.profiler and is taken again
    for attempt in range(1, PROFILE_TRIES + 1):
        _ext.reset_launch_counts()
        counts, _ = profile(torch, f"one train step ({label})",
                         lambda: (tr.train_step(x, y), torch.cuda.synchronize()))
        if counts is None:
            fail(f"{label} train profile: no device time recorded")
        calls = next(k.launches for k in _ext.ALL_KERNELS if k.name == "selective_scan_bwd")
        calls_fwd = next(k.launches for k in _ext.ALL_KERNELS if k.name == "selective_scan_fwd")
        short = {k: calls - counts[k] for k in K5_KERNELS}
        short.update({k: calls_fwd - counts[k] for k in K1_KERNELS})
        if any(v < 0 for v in short.values()):
            fail(f"{label} train profile: the trace holds more K1 or K5 launches than the "
                 f"wrappers made ({short})")
        if not any(short.values()):
            break
        log(f"  trace {attempt} of {PROFILE_TRIES} lost device records: it is short of "
            f"the wrappers' K1 and K5 launches by {short}; tracing the step again")
    else:
        fail(f"{label} train profile: no complete trace in {PROFILE_TRIES} tries")
    if calls != 2 or calls_fwd != 2:
        fail(f"{label} train profile: K1 called {calls_fwd} and K5 {calls} times in one "
             "step (want 2 each)")
    log(f"  profile: {', '.join(K1_KERNELS + K5_KERNELS)} x2 each per step, as required")
    loss, tp, fp, fn = tr.val_step(x, y)
    dice = (2 * tp / (2 * tp + fp + fn).clamp(min=1)).tolist()
    log(f"  validation step: loss {loss.item():.5f}, pseudo dice per class "
        f"{['%.4f' % v for v in dice]}")
    return launches, ms


def phase_predict(torch, card: str) -> dict:
    """The predict verb on a trained-model folder this phase writes, then
    bench.py's VolumePredictor configuration (automatic tile batch, bf16
    transfer), the host-accumulator fallback against the device path, and
    cases/s through ``predict_from_files``. Returns the verb run's launches."""
    import tempfile

    from mlagg_unet_torch import VolumePredictor, build_flagship
    from mlagg_unet_torch.cli.entrypoints import predict_from_modelfolder_entry
    from mlagg_unet_torch.imageio.nifti_io import NiftiIO, write_nifti
    from mlagg_unet_torch.inference.export import export_prediction_from_logits
    from mlagg_unet_torch.inference.predictor import NNUNetPredictor
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
    from mlagg_unet_torch.training.checkpoint import save_checkpoint
    from mlagg_unet_torch.utils.helpers import save_json
    from mlagg_unet_torch.weights import state_dict_to_jax_tree

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_predict_") as tmp:
        tmp = Path(tmp)
        folder = tmp / "nnUNetTrainer_MLAgg_2D_dt_MS__nnUNetPlans__2d"
        (folder / "fold_0").mkdir(parents=True)
        save_json(PREDICT_PLANS, str(folder / "plans.json"))
        save_json(PREDICT_DATASET, str(folder / "dataset.json"))
        net = build_flagship(num_classes=4, seed=1, device="cpu", deep_supervision=True)
        save_checkpoint({
            "network_weights": state_dict_to_jax_tree(net.state_dict()),
            "trainer_name": "nnUNetTrainer_MLAgg_2D_dt_MS",
            "init_args": {"configuration": "2d", "fold": 0},
            "inference_allowed_mirroring_axes": (0, 1)},
            str(folder / "fold_0" / "checkpoint_final.ckpt"))
        del net
        cases = tmp / "imagesTs"
        cases.mkdir()
        rng = np.random.RandomState(0)
        for i in range(PREDICT_CASES):
            vol = rng.rand(10, 320, 260).astype(np.float32)
            write_nifti(str(cases / f"case_{i:03d}_0000.nii.gz"), vol.transpose(2, 1, 0),
                        PREDICT_SPACING[::-1])
        # the steady-state folder repeats the 4 cases under new names
        steady = tmp / "imagesTs_steady"
        steady.mkdir()
        for i in range(PREDICT_STEADY_CASES):
            shutil.copyfile(cases / f"case_{i % PREDICT_CASES:03d}_0000.nii.gz",
                            steady / f"case_{i:03d}_0000.nii.gz")
        log(f"[predict] model folder (full-width flagship, seeded; 2d plan at "
            f"{TILE[0]}x{TILE[1]}, ZScore, NiftiIO, 4 labels) and {PREDICT_CASES} cases of "
            f"1x10x320x260 written in {time.perf_counter() - t_phase:.1f} s")

        # the verb, as a user runs it: bf16, mirror TTA, automatic tile batch
        out = tmp / "out"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _ext.reset_launch_counts()
        t0 = time.perf_counter()
        predict_from_modelfolder_entry(["-i", str(cases), "-o", str(out), "-m", str(folder),
                                        "-device", "cuda"])
        verb_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
        verb_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  verb predict_from_modelfolder: {PREDICT_CASES} cases in {verb_s:.3f} s "
            f"(model build, checkpoint load, memory probe and autotune included), peak "
            f"memory {verb_peak:.2f} GiB | {card}")
        log(f"  launches in the verb run: {launches}")
        for name in SERVE_KERNELS:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched on the predict verb's path")
        for name in ("selective_scan_bwd",) + FUSED_KERNELS:
            if launches[name] != 0:
                fail(f"kernel {name} was launched on the predict verb's path")

        # the same predictor on the same folder: its outputs against the
        # argmax of its VolumePredictor's own logits, then cases/s
        pred = NNUNetPredictor()
        pred.initialize_from_trained_model_folder(str(folder), None)
        pred.predict_from_files(str(cases), str(tmp / "warm"))      # probe + autotune
        vp = pred._ensure_volume_predictors()[0]
        log(f"  NNUNetPredictor: tile batch {vp.last_tile_batch} (model batch "
            f"{vp.model_batch}); autotune ms per tile {vp.autotune_ms} | {card}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_from_files(str(cases), str(tmp / "timed"))
        cases_s = PREDICT_CASES / (time.perf_counter() - t0)
        log(f"  cases/s through predict_from_files: {cases_s:.4f} ({PREDICT_CASES} cases of "
            f"1x10x320x260, bf16, mirror (0, 1), read, preprocess, export .nii.gz; "
            f"latency-bound: the first read and the last export are in the window) | {card}")
        # steady state: the rate at which the last cases were written, the first
        # PREDICT_CASES left out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict_from_files(str(steady), str(tmp / "steady"))
        window = time.perf_counter() - t0
        done_at = sorted(f.stat().st_mtime for f in (tmp / "steady").glob("*.nii.gz"))
        if len(done_at) != PREDICT_STEADY_CASES:
            fail(f"steady-state run wrote {len(done_at)} of {PREDICT_STEADY_CASES} cases")
        last = PREDICT_STEADY_CASES - PREDICT_CASES
        log(f"  cases/s through predict_from_files over {PREDICT_STEADY_CASES} cases: "
            f"{PREDICT_STEADY_CASES / window:.4f} over the window ({window:.3f} s), "
            f"{last / (done_at[-1] - done_at[PREDICT_CASES - 1]):.4f} steady (the last "
            f"{last} outputs' write times) | {card}")
        # the host stages of one case, one after another: which sets the pace
        rw, pre = NiftiIO(), DefaultPreprocessor()
        stages, t0 = {}, time.perf_counter()
        img, props = rw.read_images([str(cases / "case_000_0000.nii.gz")])
        stages["read"], t0 = time.perf_counter() - t0, time.perf_counter()
        data, _, props = pre.run_case_npy(img, None, props, pred.plans_manager,
                                          pred.configuration_manager, pred.dataset_json)
        stages["preprocess"], t0 = time.perf_counter() - t0, time.perf_counter()
        logits = pred.predict_logits_from_preprocessed_data(data)
        stages["volume (card, waited for)"], t0 = time.perf_counter() - t0, time.perf_counter()
        export_prediction_from_logits(logits, props, pred.configuration_manager,
                                      pred.plans_manager, pred.dataset_json,
                                      str(tmp / "stage_case"))
        stages["export"] = time.perf_counter() - t0
        log("  host stages of case 0 run one after another (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()) + f" | {card}")
        for i in range(PREDICT_CASES):
            seg, props = rw.read_seg(str(out / f"case_{i:03d}.nii.gz"))
            if seg.shape != (1, 10, 320, 260) or not set(np.unique(seg)) <= {0, 1, 2, 3}:
                fail(f"predict output {i}: shape {seg.shape}, labels {np.unique(seg)}")
            data, _, _ = pre.run_case([str(cases / f"case_{i:03d}_0000.nii.gz")], None,
                                      pred.plans_manager, pred.configuration_manager,
                                      pred.dataset_json)
            agree = float((vp(data).argmax(0) == seg[0]).mean())
            log(f"  case {i}: {seg.shape}, labels {np.unique(seg).tolist()}, "
                f"{100 * agree:.4f} % of voxels equal the VolumePredictor's argmax "
                f"(tol {100 * TOL_PREDICT_AGREE:g} %)")
            if not agree >= TOL_PREDICT_AGREE:
                fail(f"predict case {i}: only {agree:.6f} of voxels agree")

        # the kernels at the shapes the verb gave them, against their plain
        # twins: the verb's own predictor (bf16, the tile batch it chose) and
        # an fp32 one at that batch, each with every kernel wrapper switched
        # to its plain twin on the card
        vp32 = VolumePredictor(pred.network, TILE, 4, (0, 1),
                               tile_batch_size=vp.last_tile_batch, device="cuda")
        predictors_vs_twins(torch, card, f"case {PREDICT_CASES - 1}",
                            (("bf16", vp), ("fp32", vp32)), data, vp.model_batch)
        del vp32

        # the host-accumulator fallback on one volume: fp32, pinned batch, a
        # budget too small for the accumulator, against the device path
        vol = data
        dev = VolumePredictor(pred.network, TILE, 4, (0, 1), tile_batch_size=4, device="cuda")
        host = VolumePredictor(pred.network, TILE, 4, (0, 1), tile_batch_size=4,
                               budget_fraction=1e-6, device="cuda")
        calls = []
        run_host = host._run_host
        host._run_host = lambda *a: calls.append(1) or run_host(*a)
        ref, got = dev(vol), host(vol)
        if calls != [1]:
            fail(f"the host-accumulator fallback ran {len(calls)} times (want 1)")
        err = float(np.abs(got - ref).max())
        bound = TOL_HOST_FALLBACK * float(np.abs(ref).max())
        log(f"  host accumulator vs device, fp32, tile batch 4: max|diff| {err:.3e} "
            f"(tol {bound:.3e} = {TOL_HOST_FALLBACK:g} x max|ref|) | {card}")
        if not err <= bound:
            fail(f"host-accumulator fallback disagrees: {err:.3e} > {bound:.3e}")
        del dev, host

        # bench.py's configuration: automatic tile batch, bf16 compute and
        # transfer, 8 volumes after 1 warm-up, every volume queued then fetched
        rng = np.random.RandomState(0)
        volumes = [rng.rand(1, 10, 320, 260).astype(np.float32) for _ in range(8)]
        bench = VolumePredictor(pred.network, TILE, 4, (0, 1), compute_dtype=torch.bfloat16,
                                transfer_dtype=torch.bfloat16, device="cuda")
        bench(volumes[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pending = [bench.predict_device(v) for v in volumes]
        outs = [bench.finalize(p) for p in pending]
        bench_vps = len(volumes) / (time.perf_counter() - t0)
        bench_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if any(o.shape != (4, 10, 320, 260) or not np.isfinite(o).all() for o in outs):
            fail("bench-configuration output not finite or misshapen")
        log(f"  bench.py configuration: {bench_vps:.4f} volumes/s, tile batch "
            f"{bench.last_tile_batch} (model batch {bench.model_batch}), autotune ms per "
            f"tile {bench.autotune_ms}, peak memory {bench_peak:.2f} GiB | {card}")
        del pred, vp, bench
    log(f"[predict] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def write_train_dataset(root: Path, name: str = TRAIN_VERB_DATASET, plans: dict = None,
                        threads: int = 8) -> None:
    """The train verb's raw dataset (imagesTr, labelsTr), its ground truth and
    its preprocessed 2d cases (the port's ``run_case_save``), written on
    ``threads`` threads, under ``name`` with ``plans`` (default: the predict
    phase's)."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy.ndimage import gaussian_filter

    from mlagg_unet_torch.imageio.nifti_io import write_nifti
    from mlagg_unet_torch.plans.plans_handler import PlansManager
    from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
    from mlagg_unet_torch.utils.helpers import save_json

    plans = dict(plans or PREDICT_PLANS, dataset_name=name)
    dataset = dict(PREDICT_DATASET, numTraining=TRAIN_VERB_CASES)
    raw, pre = root / "raw" / name, root / "preprocessed" / name
    for d in (raw / "imagesTr", raw / "labelsTr", pre / "gt_segmentations",
              pre / "nnUNetPlans_2d"):
        d.mkdir(parents=True)
    save_json(plans, str(pre / "nnUNetPlans.json"), sort_keys=False)
    save_json(dataset, str(pre / "dataset.json"), sort_keys=False)
    rng = np.random.RandomState(0)
    images = []
    for _ in range(TRAIN_VERB_CASES):   # smooth blobs a few pixels wide, unit std
        img = gaussian_filter(rng.randn(10, 320, 260).astype(np.float32), (0, 4, 4))
        images.append(img / img.std())
    pm = PlansManager(plans)
    cm = pm.get_configuration("2d")
    spacing = PREDICT_SPACING[::-1]

    def write(i):
        img = images[i]
        lab = np.digitize(img, TRAIN_VERB_THRESHOLDS).astype(np.uint8)
        name = f"case_{i:03d}"
        write_nifti(str(raw / "imagesTr" / f"{name}_0000.nii.gz"), img.transpose(2, 1, 0), spacing)
        write_nifti(str(raw / "labelsTr" / f"{name}.nii.gz"), lab.transpose(2, 1, 0), spacing)
        shutil.copyfile(raw / "labelsTr" / f"{name}.nii.gz",
                        pre / "gt_segmentations" / f"{name}.nii.gz")
        DefaultPreprocessor().run_case_save(
            str(pre / "nnUNetPlans_2d" / name), [str(raw / "imagesTr" / f"{name}_0000.nii.gz")],
            str(raw / "labelsTr" / f"{name}.nii.gz"), pm, cm, dataset)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(TRAIN_VERB_CASES)))


def register_train_verb_recipe(epochs: int) -> None:
    """The flagship recipe cut to ``epochs`` epochs of TRAIN_VERB_STEPS steps,
    TRAIN_VERB_VAL_STEPS validation steps and TRAIN_VERB_WARMUP warm-up
    epochs, under its own name (registered here only)."""
    from dataclasses import replace

    from mlagg_unet_torch.training import registry

    registry.register_trainer(replace(
        registry.get_trainer_config("nnUNetTrainer_MLAgg_2D_dt_MS"), name=TRAIN_VERB_RECIPE,
        num_epochs=epochs, num_iterations_per_epoch=TRAIN_VERB_STEPS,
        num_val_iterations_per_epoch=TRAIN_VERB_VAL_STEPS, warmup_epochs=TRAIN_VERB_WARMUP))


@contextlib.contextmanager
def attribute_launches(_ext, cls, method, counts: dict, calls: list = None):
    """While active, each call of ``cls.method`` adds the kernel launches it
    made to ``counts`` (a wrapper launches in the calling thread), and its
    host (start, end) times to ``calls``."""
    orig = getattr(cls, method)

    def wrapped(*args, **kwargs):
        before = {k.name: k.launches for k in _ext.ALL_KERNELS}
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            if calls is not None:
                calls.append((t0, time.perf_counter()))
            for k in _ext.ALL_KERNELS:
                counts[k.name] = counts.get(k.name, 0) + k.launches - before[k.name]

    setattr(cls, method, wrapped)
    try:
        yield
    finally:
        setattr(cls, method, orig)


@contextlib.contextmanager
def recording_first_batches(first: dict):
    """While active, the loaders of ``NNUNetTrainer.get_dataloaders`` keep
    the first training and validation batch they hand out in ``first``."""
    from mlagg_unet_torch.training.trainer import NNUNetTrainer

    get_loaders = NNUNetTrainer.get_dataloaders

    def recording_loaders(self):
        loaders = get_loaders(self)
        for key, loader in zip(("train", "val"), loaders):
            def get_batch(get=loader.get_batch, key=key):
                batch = get()
                first.setdefault(key, batch)
                return batch
            loader.get_batch = get_batch
        return loaders

    NNUNetTrainer.get_dataloaders = recording_loaders
    try:
        yield
    finally:
        NNUNetTrainer.get_dataloaders = get_loaders


def loader_figures(torch, trainer) -> dict:
    """The training loader on threads (the 2D default): its batches/s with
    nothing consuming them (after its prefetch queue is drained,
    LOADER_RATE_BATCHES batches timed; a loader that has not delivered them
    within 120 s, a hung worker, fails the phase), then the ms per step of
    TRAIN_STEPS steps it feeds (after TRAIN_WARMUP), and a profile of
    TRAIN_VERB_PROFILED_STEPS more (``stats``: wall and device busy ms)."""
    import threading

    old = os.environ.get("MLAGG_DA_BACKEND")
    os.environ["MLAGG_DA_BACKEND"] = "threads"
    try:
        train, val = trainer.get_dataloaders()
    finally:
        if old is None:
            del os.environ["MLAGG_DA_BACKEND"]
        else:
            os.environ["MLAGG_DA_BACKEND"] = old
    val.stop()
    out = {}

    def drain():
        for _ in range(6):
            train.get_batch()
        t0 = time.perf_counter()
        for _ in range(LOADER_RATE_BATCHES):
            train.get_batch()
        out["rate"] = LOADER_RATE_BATCHES / (time.perf_counter() - t0)

    def steps(n):
        for _ in range(n):
            trainer.step.train_step(*trainer.feed.batch(train.get_batch()))
        torch.cuda.synchronize()

    try:
        worker = threading.Thread(target=drain, daemon=True)
        worker.start()
        worker.join(timeout=120)
        if "rate" not in out:
            fail(f"the training loader delivered no {6 + LOADER_RATE_BATCHES} batches in 120 s")
        steps(TRAIN_WARMUP)
        t0 = time.perf_counter()
        steps(TRAIN_STEPS)
        out["step_ms"] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        out["stats"] = {}
        counts, _ = profile(torch, f"{TRAIN_VERB_PROFILED_STEPS} training steps fed by the "
                            "loader", lambda: steps(TRAIN_VERB_PROFILED_STEPS), out["stats"])
        if counts is None:
            fail("the profile of the training steps fed by the loader recorded no device time")
    finally:
        train.stop()
    return out


def phase_train_verb(torch, card: str, cached_step_ms=None) -> dict:
    """The port's train verb end to end on the card on a dataset this phase
    writes, its resume and the predict verb on the folder it wrote; the
    kernels at the verb's own batch against their plain twins; the loader,
    step and epoch figures. Returns the verb run's launches."""
    t_phase = time.perf_counter()
    with verb_paths("chip_smoke_train_", HOST_PREP.folder("train")[0]) as tmp:
        launches, first, step_ms = train_verb_run(torch, card, tmp)
        train_verb_kernels(torch, card, first,
                           _verb_folder(tmp) / "fold_0" / "checkpoint_final.ckpt")
        train_verb_timing(torch, card, tmp, first, step_ms, cached_step_ms)
    log(f"[train verb] phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def _verb_folder(tmp: Path) -> Path:
    return tmp / "results" / TRAIN_VERB_DATASET / f"{TRAIN_VERB_RECIPE}__nnUNetPlans__2d"


def train_verb_run(torch, card: str, tmp: Path):
    """The verb, its resume and the predict verb, with their checks. Returns
    the verb run's launches, the first training and validation batches its
    loaders produced, and its ms per step with the loader."""
    from mlagg_unet_torch.cli.entrypoints import predict_from_modelfolder_entry, train_entry
    from mlagg_unet_torch.imageio.nifti_io import NiftiIO
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.training.trainer import NNUNetTrainer, Trainer
    from mlagg_unet_torch.utils.helpers import load_json

    verb = ["996", "2d", "0", "-tr", TRAIN_VERB_RECIPE, "-device", "cuda"]
    folder = _verb_folder(tmp) / "fold_0"
    first, steps, finals = {}, [], []
    register_train_verb_recipe(TRAIN_VERB_EPOCHS)
    train_c, val_c, final_c = {}, {}, {}
    with recording_first_batches(first), \
            attribute_launches(_ext, Trainer, "train_step", train_c, steps), \
            attribute_launches(_ext, Trainer, "val_step", val_c), \
            attribute_launches(_ext, NNUNetTrainer, "perform_actual_validation", final_c,
                               finals):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _ext.reset_launch_counts()
        t0 = time.perf_counter()
        train_entry(verb)
        verb_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ck = load_checkpoint(str(folder / "checkpoint_final.ckpt"))
    lg = ck["logging"]
    epoch_s = [e - s for s, e in zip(lg["epoch_start_timestamps"], lg["epoch_end_timestamps"])]
    log(f"  verb train {' '.join(verb)}: {verb_s:.1f} s ({TRAIN_VERB_EPOCHS} epochs of "
        f"{TRAIN_VERB_STEPS} steps + {TRAIN_VERB_VAL_STEPS} validation steps, unpacking, "
        f"checkpoints and the final validation), peak memory {peak:.2f} GiB | {card}")
    log(f"  seconds per epoch (training and validation steps): "
        f"{', '.join(f'{t:.3f}' for t in epoch_s)} | {card}")
    log(f"  mean loss per epoch: train {['%.5f' % v for v in lg['train_losses']]}, "
        f"validation {['%.5f' % v for v in lg['val_losses']]}; pseudo dice "
        f"{['%.4f' % v for v in lg['mean_fg_dice']]}, EMA {['%.4f' % v for v in lg['ema_fg_dice']]}")
    log(f"  launches in the verb run: {launches}")
    log(f"  of them in the {len(steps)} training steps: {train_c}")
    log(f"  in the validation steps: {val_c}")
    log(f"  in the final validation: {final_c}")
    if len(steps) != TRAIN_VERB_EPOCHS * TRAIN_VERB_STEPS:
        fail(f"the verb ran {len(steps)} training steps (want "
             f"{TRAIN_VERB_EPOCHS * TRAIN_VERB_STEPS})")
    if not all(math.isfinite(v) for v in lg["train_losses"] + lg["val_losses"]):
        fail(f"a loss of the verb run is not finite: {lg['train_losses']} {lg['val_losses']}")
    if ck["current_epoch"] != TRAIN_VERB_EPOCHS:
        fail(f"checkpoint_final holds epoch {ck['current_epoch']} (want {TRAIN_VERB_EPOCHS})")
    for name in ("checkpoint_final.ckpt", "checkpoint_best.ckpt", "checkpoint_latest.ckpt"):
        if not (folder / name).is_file():
            fail(f"the verb wrote no {name}")
    summary = load_json(str(folder / "validation" / "summary.json"))
    dice = {k: v["Dice"] for k, v in summary["mean"].items()}
    log(f"  validation/summary.json: {len(summary['metric_per_case'])} cases, mean Dice per "
        f"label {dice}, foreground mean {summary['foreground_mean']['Dice']:.4f}")
    if sorted(dice) != ["1", "2", "3"]:
        fail(f"summary.json has Dice for labels {sorted(dice)} (want 1, 2, 3)")
    for name in TRAIN_KERNELS:
        if train_c.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched in the verb's training steps")
    for name in set(launches) - set(TRAIN_KERNELS):
        if train_c.get(name, 0) != 0:
            fail(f"kernel {name} was launched in the verb's training steps")
    for counts, where in ((val_c, "validation steps"), (final_c, "final validation")):
        for name in SERVE_KERNELS:
            if counts.get(name, 0) <= 0:
                fail(f"kernel {name} was not launched in the verb's {where}")
        for name in ("selective_scan_bwd",) + FUSED_KERNELS:
            if counts.get(name, 0) != 0:
                fail(f"kernel {name} was launched in the verb's {where}")
    for name in ("mlla_front", "mlla_tail"):
        if launches[name] != val_c[name] + final_c[name]:
            fail(f"kernel {name} was launched outside the validation steps and the final "
                 f"validation ({launches[name]} against {val_c[name]} + {final_c[name]})")
    for name in FUSED_KERNELS:
        if launches[name] != 0:
            fail(f"kernel {name} was launched in the verb run")

    # ms per step with the real loader: the steps' start-to-start times after
    # the first epoch (each epoch's first step waits on its loader's start)
    per_epoch = [[t for t, _ in steps[e * TRAIN_VERB_STEPS:(e + 1) * TRAIN_VERB_STEPS]]
                 for e in range(TRAIN_VERB_EPOCHS)]
    gaps = [1e3 * (b - a) for ep in per_epoch[1:] for a, b in zip(ep, ep[1:])]
    step_ms = statistics.median(gaps)
    n_val = len(summary["metric_per_case"])
    log(f"  ms per training step with the loader (median of {len(gaps)} in epoch 2): "
        f"{step_ms:.2f}, {TRAIN_BATCH * 1e3 / step_ms:.3f} images/s | {card}")

    # the resume: one more epoch in the recipe, --c loads checkpoint_final
    register_train_verb_recipe(TRAIN_VERB_EPOCHS + 1)
    resumed, resumed_steps = {}, []
    try:
        with attribute_launches(_ext, Trainer, "train_step", resumed, resumed_steps), \
                attribute_launches(_ext, NNUNetTrainer, "perform_actual_validation", {},
                                   finals):
            train_entry(verb + ["--c"])
    finally:
        register_train_verb_recipe(TRAIN_VERB_EPOCHS)
    ck2 = load_checkpoint(str(folder / "checkpoint_final.ckpt"))
    lg2 = ck2["logging"]
    n_new = len(resumed_steps)
    log(f"  resumed with --c: checkpoint_final of epoch {ck['current_epoch']}, trained "
        f"{n_new} steps, now epoch {ck2['current_epoch']}; train losses "
        f"{['%.5f' % v for v in lg2['train_losses']]}")
    if n_new != TRAIN_VERB_STEPS or ck2["current_epoch"] != TRAIN_VERB_EPOCHS + 1:
        fail(f"the resume trained {n_new} steps to epoch {ck2['current_epoch']} (want "
             f"{TRAIN_VERB_STEPS} to {TRAIN_VERB_EPOCHS + 1})")
    for key in ("train_losses", "val_losses", "mean_fg_dice", "ema_fg_dice",
                "epoch_start_timestamps"):
        if lg2[key][:TRAIN_VERB_EPOCHS] != lg[key] or len(lg2[key]) != TRAIN_VERB_EPOCHS + 1:
            fail(f"the resumed logger's {key} does not continue the first run's")
    if not math.isfinite(lg2["train_losses"][-1]):
        fail("the resumed epoch's loss is not finite")
    val_s = [b - a for a, b in finals]
    log(f"  final validation of {n_val} cases (bf16, tile batch 4, mirror (0, 1), export and "
        f"evaluation included): {', '.join(f'{t:.2f}' for t in val_s)} s in the first run and "
        f"the resume, {val_s[-1] / n_val:.3f} s per case in the resume | {card}")

    # the predict verb on the folder the train verb wrote
    cases = tmp / "imagesTs"
    cases.mkdir()
    for i in range(2):
        shutil.copyfile(tmp / "raw" / TRAIN_VERB_DATASET / "imagesTr" / f"case_{i:03d}_0000.nii.gz",
                        cases / f"case_{i:03d}_0000.nii.gz")
    out = tmp / "predicted"
    t0 = time.perf_counter()
    predict_from_modelfolder_entry(["-i", str(cases), "-o", str(out), "-m",
                                    str(_verb_folder(tmp)), "-f", "0", "-device", "cuda"])
    for i in range(2):
        seg, _ = NiftiIO().read_seg(str(out / f"case_{i:03d}.nii.gz"))
        labels = np.unique(seg)
        if seg.shape != (1, 10, 320, 260) or not set(labels) <= {0, 1, 2, 3}:
            fail(f"predict verb on the trained folder, case {i}: {seg.shape}, labels {labels}")
    log(f"  predict verb on the trained folder: 2 cases in {time.perf_counter() - t0:.1f} s, "
        f"shape (1, 10, 320, 260), labels {labels.tolist()}")
    return launches, first, step_ms


def train_verb_kernels(torch, card: str, first: dict, ckpt: Path, recipe: str = TRAIN_VERB_RECIPE,
                       patch=TILE, batch: int = TRAIN_BATCH, tag: str = "train verb") -> None:
    """The kernels at the verb's own batches against their plain twins on
    the card, from the verb's weights in ``ckpt``: the fp32 loss and every
    parameter gradient of the first training batch its loader produced (drop
    path off), and the first validation batch's logits in bf16 and fp32."""
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.training.trainer import DeviceFeeder, Trainer
    from mlagg_unet_torch.weights import jax_tree_to_state_dict

    ck = load_checkpoint(str(ckpt))
    tr = Trainer(recipe, tuple(patch), batch, 1, 4, batch_dice=True, seed=0,
                 device="cuda", compute_dtype=torch.float32,
                 network_overrides=dict(drop_path_rate=0.0, skip_drop_path=0.0))
    tr.network.load_state_dict(jax_tree_to_state_dict(ck["network_weights"]), strict=True)
    feed = DeviceFeeder(torch.device("cuda"))
    x, y = feed.batch(first["train"])
    log(f"[{tag}] kernels vs plain twins on the verb's first training batch "
        f"{tuple(x.shape)} (augmented; labels {torch.unique(y).tolist()}), fp32, drop path off")
    _ext.reset_launch_counts()
    l_got, g_got = train_grads(tr, tr.network, x, y)
    ran = {k.name: k.launches for k in _ext.ALL_KERNELS}
    _ext.reset_launch_counts()
    with plain_twins(_ext):
        l_ref, g_ref = train_grads(tr, tr.network, x, y)
    if any(k.launches for k in _ext.ALL_KERNELS):
        fail("the plain-twin run of the training batch launched a kernel")
    if any(ran[n] <= 0 for n in TRAIN_KERNELS):
        fail(f"the training batch ran K1, K4, K5 {[ran[n] for n in TRAIN_KERNELS]} times")
    log(f"  launches with the kernels: {ran}")
    compare_grads(torch, "kernels vs plain twins at the verb's batch", l_got, g_got, l_ref, g_ref)
    del g_got, g_ref
    xv, _ = feed.batch(first["val"])
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        net = copy.deepcopy(tr.network).to(dtype).eval()
        with torch.no_grad():
            _ext.reset_launch_counts()
            got = net(xv.to(dtype))[0].float()
            ran = {k.name: k.launches for k in _ext.ALL_KERNELS}
            _ext.reset_launch_counts()
            with plain_twins(_ext):
                ref = net(xv.to(dtype))[0].float()
        if any(k.launches for k in _ext.ALL_KERNELS):
            fail(f"the plain-twin run of the {tag} validation batch launched a kernel")
        if any(ran[n] <= 0 for n in SERVE_KERNELS):
            fail(f"the {tag} validation batch ran K1-K4 {[ran[n] for n in SERVE_KERNELS]} times")
        err, peak = (got - ref).abs().max().item(), ref.abs().max().item()
        l2 = ((got - ref).norm() / ref.norm()).item()
        ok = l2 <= TOL_SERVE_REL_L2 if tag == "bf16" else err <= TOL_MODEL * peak
        log(f"  validation batch {tuple(xv.shape)}, {tag}, eval: kernels (K1-K4 "
            f"{[ran[n] for n in SERVE_KERNELS]} launches) vs plain twins: rel L2 {l2:.3e}, "
            f"max|diff| {err:.3e} of max {peak:.3e} (tol "
            + (f"rel L2 {TOL_SERVE_REL_L2:g})" if tag == "bf16" else f"{TOL_MODEL:g} x max)")
            + f" | {card}")
        if not ok:
            fail(f"the {tag} validation batch's logits disagree with the plain twins'")
        del net, got, ref
    del tr


def train_verb_timing(torch, card: str, tmp: Path, first: dict, step_ms: float,
                      cached_step_ms) -> None:
    """The verb's training loader on threads (alone, then feeding steps; a
    profiled span of steps), and the step on one cached batch."""
    from mlagg_unet_torch.training.trainer import NNUNetTrainer
    from mlagg_unet_torch.utils.helpers import load_json

    pre = tmp / "preprocessed" / TRAIN_VERB_DATASET
    tr = NNUNetTrainer(load_json(str(pre / "nnUNetPlans.json")), "2d", 0,
                       load_json(str(pre / "dataset.json")), trainer_name=TRAIN_VERB_RECIPE,
                       device="cuda")
    tr.initialize()
    f = loader_figures(torch, tr)
    log(f"  training loader on threads (the 2D default), 4 workers, batch {TRAIN_BATCH}, "
        f"augmented: {f['rate']:.3f} batches/s alone; {f['step_ms']:.2f} ms per step fed by it "
        f"({TRAIN_STEPS} steps) | {card}")
    stats = f["stats"]
    busy = stats["busy_ms"] / TRAIN_VERB_PROFILED_STEPS
    log(f"  device busy share of {TRAIN_VERB_PROFILED_STEPS} steps fed by the loader: "
        f"{100 * stats['busy_ms'] / stats['wall_ms']:.1f} % of the profiled wall time "
        f"(profiler overhead included); {busy:.1f} ms busy per step = "
        f"{100 * busy / step_ms:.1f} % of the verb's {step_ms:.2f} ms step | "
        f"{card}")
    x, y = tr.feed.batch(first["train"])
    tr.step.run_steps([(x, y)] * TRAIN_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.step.run_steps([(x, y)] * TRAIN_STEPS)   # ends in a host sync
    cached = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    log(f"  ms per step: {step_ms:.2f} with the loader (the verb's epoch 2), "
        f"{cached:.2f} on its first batch cached on the card"
        + (f", phase 7's cached synthetic batch {cached_step_ms:.2f}" if cached_step_ms else "")
        + f" | {card}")
    del tr


def write_pipeline_raw(root: Path, threads: int = 8) -> Path:
    """The pipeline's raw dataset under ``root/raw`` and its test labels in
    ``root/labelsTs``, written on ``threads`` threads; returns the dataset's
    folder."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy.ndimage import gaussian_filter

    from mlagg_unet_torch.imageio.nifti_io import write_nifti
    from mlagg_unet_torch.utils.helpers import save_json

    raw = root / "raw" / PIPELINE_DATASET
    for d in (raw / "imagesTr", raw / "labelsTr", raw / "imagesTs", root / "labelsTs"):
        d.mkdir(parents=True)
    save_json(dict(PREDICT_DATASET, numTraining=PIPELINE_CASES), str(raw / "dataset.json"),
              sort_keys=False)
    rng = np.random.RandomState(1)
    n = PIPELINE_CASES + PIPELINE_TEST_CASES
    noise = [rng.randn(10, 320, 260).astype(np.float32) for _ in range(n)]
    lo, hi = PIPELINE_INPLANE

    def write(i):
        img = gaussian_filter(noise[i], (0, 4, 4))
        img /= img.std()
        lab = np.digitize(img, TRAIN_VERB_THRESHOLDS).astype(np.uint8)
        inplane = lo + (hi - lo) * i / (n - 1)
        spacing = (inplane, inplane, PIPELINE_Z_SPACING)   # (x, y, z) on disk
        test = i >= PIPELINE_CASES
        name = f"case_{i:03d}"
        write_nifti(str(raw / ("imagesTs" if test else "imagesTr") / f"{name}_0000.nii.gz"),
                    img.transpose(2, 1, 0), spacing)
        write_nifti(str((root / "labelsTs" if test else raw / "labelsTr") / f"{name}.nii.gz"),
                    lab.transpose(2, 1, 0), spacing)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(n)))
    return raw


def register_pipeline_recipes() -> None:
    """The flagship recipe cut to each of PIPELINE_RECIPES' epochs of
    PIPELINE_STEPS steps and PIPELINE_VAL_STEPS validation steps (registered
    here only)."""
    from dataclasses import replace

    from mlagg_unet_torch.training import registry

    for name, epochs in PIPELINE_RECIPES:
        registry.register_trainer(replace(
            registry.get_trainer_config("nnUNetTrainer_MLAgg_2D_dt_MS"), name=name,
            num_epochs=epochs, num_iterations_per_epoch=PIPELINE_STEPS,
            num_val_iterations_per_epoch=PIPELINE_VAL_STEPS, warmup_epochs=TRAIN_VERB_WARMUP))


def spawn_worker_probe() -> tuple:
    """Run in a spawned preprocessing worker: what it has loaded and whether
    it opened the card."""

    import torch

    return ("mlagg_unet_torch" in sys.modules, torch.cuda.is_initialized(),
            os.environ.get("CUDA_VISIBLE_DEVICES"))


def pipeline_worker_cost() -> None:
    """What a spawned preprocessing worker pays to start (a pool of 1 to its
    first result); a worker of the pool must not open the card."""

    from mlagg_unet_torch.preprocessing.preprocessor import _spawn_worker_init

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1, initializer=_spawn_worker_init) as pool:
        loaded, cuda, visible = pool.apply(spawn_worker_probe)
    first = time.perf_counter() - t0
    log(f"  a spawned preprocessing worker: a pool of 1 to its first result {first:.2f} s; in "
        f"the worker CUDA_VISIBLE_DEVICES={visible!r}, torch.cuda.is_initialized() {cuda}")
    if not loaded or cuda or visible != "":
        fail(f"a spawned preprocessing worker touched the card or lacks the package "
             f"(package loaded {loaded}, CUDA initialised {cuda}, visible {visible!r})")


def resample_alone(npz: Path, card: str) -> None:
    """One preprocessed case resampled in this process by the native
    resampler and by scipy (best of 2 each): what the resampler alone saves
    on this host."""

    from mlagg_unet_torch.preprocessing.resampling import resample_data_or_seg_to_shape

    data = np.load(npz)["data"]
    kw = dict(new_shape=(10, 320, 260), current_spacing=(3.0, 0.75, 0.75),
              new_spacing=(3.0, 0.79, 0.79), is_seg=False, order=3, order_z=0,
              force_separate_z=None)
    best = {}
    for tag in ("native", "scipy", "native", "scipy"):
        if tag == "scipy":
            os.environ["MLAGG_DISABLE_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            out = resample_data_or_seg_to_shape(data, **kw)
            best[tag] = min(best.get(tag, math.inf), time.perf_counter() - t0)
        finally:
            os.environ.pop("MLAGG_DISABLE_NATIVE", None)
    log(f"  one case {data.shape} -> {out.shape} (order 3 in-plane, separate z) in this "
        f"process: native {best['native'] * 1e3:.1f} ms, scipy {best['scipy'] * 1e3:.1f} ms "
        f"(best of 2 each, {os.cpu_count()} host cores, OpenMP threads "
        f"{os.environ.get('OMP_NUM_THREADS', 'all')}) | {card}")


def check_launches(counts: dict, want, never, where: str) -> None:
    for name in want:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched in the pipeline's {where}")
    for name in never:
        if counts.get(name, 0) != 0:
            fail(f"kernel {name} was launched in the pipeline's {where}")


def read_segs(folder: Path) -> dict:
    from mlagg_unet_torch.imageio.nifti_io import NiftiIO

    return {p.name: NiftiIO().read_seg(str(p))[0] for p in sorted(folder.glob("*.nii.gz"))}


def predict_vs_twins(torch, card: str, verb_preds: list, raw: Path, cases: Path,
                     pre: Path) -> None:
    """The kernels at the shapes the pipeline's serving paths give them,
    against their plain twins on the card: the first recipe's predict verb's
    own fold-0 VolumePredictor (bf16, the planner's patch, the tile batch it
    chose) and an fp32 one at that batch on the first test case; then the
    final validation's predictor (fold 0's weights, bf16, tile batch 4) and
    an fp32 one at tile batch 4 on fold 0's first validation case."""
    from mlagg_unet_torch import VolumePredictor
    from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
    from mlagg_unet_torch.utils.helpers import load_json

    if len(verb_preds) != 1:
        fail(f"the first recipe's predict verb ran {len(verb_preds)} predictors (want 1)")
    pred = verb_preds[0]
    vp = pred._ensure_volume_predictors()[0]
    patch = tuple(pred.configuration_manager.patch_size)
    heads = pred.label_manager.num_segmentation_heads
    mirror = tuple(pred.allowed_mirroring_axes)
    case = sorted((raw / "imagesTs").glob("*.nii.gz"))[0]
    data, _, _ = DefaultPreprocessor().run_case([str(case)], None, pred.plans_manager,
                                                pred.configuration_manager, pred.dataset_json)
    pred.network.load_state_dict(pred.list_of_parameters[0], strict=True)   # fold 0
    vp32 = VolumePredictor(pred.network, patch, heads, mirror,
                           tile_batch_size=vp.last_tile_batch, device="cuda")
    predictors_vs_twins(torch, card, f"{case.name} {data.shape}, the predict verb's fold-0 "
                        f"predictor (patch {list(patch)}, tile batch {vp.last_tile_batch})",
                        (("bf16", vp), ("fp32", vp32)), data, vp.model_batch)
    del vp32
    key = load_json(str(pre / "splits_final.json"))[0]["val"][0]
    data = np.load(cases / f"{key}.npz")["data"]
    final = [(tag, VolumePredictor(pred.network, patch, heads, mirror, tile_batch_size=4,
                                   compute_dtype=dtype, device="cuda"))
             for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))]
    predictors_vs_twins(torch, card, f"fold 0's validation case {key} {data.shape} at the "
                        f"final validation's tile batch 4", final, data, 4 * 2 ** len(mirror))


def prepare_pipeline(root: Path, card: str, workers: int, threads: int) -> dict:
    """Phase 9's raw dataset under ``root`` (``threads`` writer threads),
    ``plan_and_preprocess_entry -c 2d --verify_dataset_integrity`` on
    ``workers`` spawned workers (native resampler) with its checks, the first
    case preprocessed again with scipy against the verb's native output, and
    one case resampled both ways. Returns the stages' seconds."""
    from mlagg_unet_torch.cli import entrypoints as cli
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.plans.plans_handler import PlansManager
    from mlagg_unet_torch.preprocessing.preprocessor import DefaultPreprocessor
    from mlagg_unet_torch.utils.helpers import load_json

    secs = {}
    with paths_at(root):
        t0 = time.perf_counter()
        raw = write_pipeline_raw(root, threads)
        secs["write raw"] = time.perf_counter() - t0
        log(f"[pipeline] {PIPELINE_CASES} training and {PIPELINE_TEST_CASES} test cases of "
            f"1x10x320x260 written (in-plane spacing {PIPELINE_INPLANE[0]}-"
            f"{PIPELINE_INPLANE[1]} mm, z {PIPELINE_Z_SPACING} mm) in "
            f"{secs['write raw']:.1f} s")
        pre = root / "preprocessed" / PIPELINE_DATASET
        runs = []
        t0 = time.perf_counter()
        with attribute_launches(_ext, DefaultPreprocessor, "run", {}, runs):
            cli.plan_and_preprocess_entry(["-d", PIPELINE_ID, "-c", "2d",
                                           "--verify_dataset_integrity", "-np", str(workers)])
        secs["plan_and_preprocess"] = time.perf_counter() - t0
        native_s = runs[0][1] - runs[0][0]
        plans = load_json(str(pre / "nnUNetPlans.json"))
        cfg = plans["configurations"].get("2d")
        if not (pre / "dataset_fingerprint.json").is_file() or cfg is None:
            fail("plan_and_preprocess wrote no fingerprint or no 2d configuration")
        npz = sorted((pre / cfg["data_identifier"]).glob("*.npz"))
        if len(npz) != PIPELINE_CASES or not all(p.with_suffix(".pkl").is_file() for p in npz):
            fail(f"plan_and_preprocess wrote {len(npz)} .npz/.pkl pairs "
                 f"(want {PIPELINE_CASES})")
        if len(list((pre / "gt_segmentations").glob("*.nii.gz"))) != PIPELINE_CASES:
            fail("plan_and_preprocess copied no gt_segmentations")
        patch, batch = cfg["patch_size"], cfg["batch_size"]
        log(f"  plan_and_preprocess -c 2d --verify_dataset_integrity: "
            f"{secs['plan_and_preprocess']:.1f} s, of it the preprocessing "
            f"({workers} spawned workers, native resampler) {native_s:.1f} s")
        log(f"  the planner's 2d configuration: patch {patch}, batch {batch}, spacing "
            f"{cfg['spacing']}, median shape {cfg['median_image_size_in_voxels']}, "
            f"{len(cfg['pool_op_kernel_sizes'])} stages")
        if any(p % 32 for p in patch):
            fail(f"the planner's 2d patch {patch} is not divisible by 32")
        shapes = sorted({np.load(p)["data"].shape[2:] for p in npz})
        log(f"  preprocessed in-plane shapes: {shapes}")
        if len(shapes) < 2:
            fail("no case was resampled by the 2d preprocessing")
        # the native resampler against scipy: the first case preprocessed
        # again in this process with MLAGG_DISABLE_NATIVE=1 (read at each
        # call), against the verb's native output
        case = npz[0].stem
        os.environ["MLAGG_DISABLE_NATIVE"] = "1"
        t0 = time.perf_counter()
        try:
            pm = PlansManager(plans)
            data, seg, _ = DefaultPreprocessor().run_case(
                [str(raw / "imagesTr" / f"{case}_0000.nii.gz")],
                str(raw / "labelsTr" / f"{case}.nii.gz"), pm, pm.get_configuration("2d"),
                load_json(str(pre / "dataset.json")))
        finally:
            os.environ.pop("MLAGG_DISABLE_NATIVE", None)
        scipy_s = time.perf_counter() - t0
        native = np.load(npz[0])
        if not np.array_equal(native["seg"], seg):
            fail(f"{case}: the native preprocessing's seg differs from scipy's")
        worst = float(np.abs(native["data"].astype(np.float64) - data).max()
                      / np.abs(data).max())
        log(f"  the preprocess verb's native output against scipy's for {case} (in this "
            f"process, {scipy_s:.1f} s): seg equal, data within {worst:.2e} x max|data| "
            f"(tol {TOL_NATIVE_PREPROCESS:g})")
        if worst > TOL_NATIVE_PREPROCESS:
            fail(f"{case}: native vs scipy preprocessed data differ by {worst:.3e} x "
                 "max|data|")
        resample_alone(npz[-1], card)
    return {"secs": secs}


def phase_pipeline(torch, card: str) -> dict:
    """The nnU-Net pipeline through the port's verbs in this process, from
    raw files to an evaluated, postprocessed test prediction: plan and
    preprocess (native resampler; one case again with scipy), two cut
    recipes trained on fold 0, find_best_configuration, predict,
    ensemble, apply_postprocessing and evaluate_simple on the test cases,
    and the export/install zip round trip. Returns the phase's launches."""
    from concurrent.futures import ThreadPoolExecutor

    from mlagg_unet_torch import paths
    from mlagg_unet_torch.cli import entrypoints as cli
    from mlagg_unet_torch.inference.predictor import NNUNetPredictor
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training.trainer import NNUNetTrainer, Trainer
    from mlagg_unet_torch.utils.helpers import load_json

    t_phase = time.perf_counter()
    recipes = [name for name, _ in PIPELINE_RECIPES]
    # a spawned worker's start-up, measured in a thread beside the phase (it
    # waits on the worker's imports)
    probe = ThreadPoolExecutor(1)
    worker_cost = probe.submit(pipeline_worker_cost)
    probe.shutdown(wait=False)
    prepared, prep = HOST_PREP.folder("pipeline")
    secs = dict(prep["secs"])
    with verb_paths("chip_smoke_pipeline_", prepared) as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _ext.reset_launch_counts()
        raw = tmp / "raw" / PIPELINE_DATASET
        pre = tmp / "preprocessed" / PIPELINE_DATASET
        plans = load_json(str(pre / "nnUNetPlans.json"))
        cfg = plans["configurations"]["2d"]
        patch, batch = cfg["patch_size"], cfg["batch_size"]

        # 2. train both recipes on fold 0, with the planner's batch
        register_pipeline_recipes()
        train_c, val_c, final_c, first, steps = {}, {}, {}, {}, []
        t0 = time.perf_counter()
        for name in recipes:
            for fold in PIPELINE_FOLDS:
                tf = time.perf_counter()
                rec = first if (name, fold) == (recipes[0], "0") else {}
                with recording_first_batches(rec), \
                        attribute_launches(_ext, Trainer, "train_step", train_c, steps), \
                        attribute_launches(_ext, Trainer, "val_step", val_c), \
                        attribute_launches(_ext, NNUNetTrainer, "perform_actual_validation",
                                           final_c):
                    cli.train_entry([PIPELINE_ID, "2d", fold, "-tr", name, "--npz"])
                log(f"  train {name} fold {fold} --npz: {time.perf_counter() - tf:.1f} s")
        secs["train (2 recipes x 2 folds)"] = time.perf_counter() - t0
        verbs = {k.name: k.launches for k in _ext.ALL_KERNELS}   # before the comparison
        want_steps = sum(e for _, e in PIPELINE_RECIPES) * len(PIPELINE_FOLDS) * PIPELINE_STEPS
        log(f"  launches in the {len(steps)} training steps: {train_c}")
        log(f"  in the validation steps: {val_c}")
        log(f"  in the final validations: {final_c}")
        if len(steps) != want_steps:
            fail(f"the pipeline trained {len(steps)} steps (want {want_steps})")
        check_launches(train_c, TRAIN_KERNELS,
                       set(SERVE_KERNELS + FUSED_KERNELS) - set(TRAIN_KERNELS),
                       "training steps")
        for counts, where in ((val_c, "validation steps"), (final_c, "final validations")):
            check_launches(counts, SERVE_KERNELS, ("selective_scan_bwd",) + FUSED_KERNELS,
                           where)
        results = tmp / "results" / PIPELINE_DATASET
        t0 = time.perf_counter()
        train_verb_kernels(torch, card, first,
                           results / f"{recipes[0]}__nnUNetPlans__2d" / "fold_0"
                           / "checkpoint_final.ckpt",
                           recipes[0], patch, batch, tag="pipeline")
        secs["kernels vs plain twins"] = time.perf_counter() - t0
        _ext.reset_launch_counts()   # the comparison's launches are not the pipeline's

        # 3. find the best configuration
        t0 = time.perf_counter()
        cli.find_best_configuration_entry([PIPELINE_ID, "-c", "2d", "-tr", *recipes,
                                           "-f", *PIPELINE_FOLDS])
        secs["find_best_configuration"] = time.perf_counter() - t0
        info = load_json(str(results / "inference_information.json"))
        best = info["best_model_or_ensemble"]
        models = [f"{r}__nnUNetPlans__2d" for r in recipes]
        ensemble = f"ensemble___{models[0]}___{models[1]}___{'_'.join(PIPELINE_FOLDS)}"
        log(f"  find_best_configuration: {secs['find_best_configuration']:.1f} s; mean "
            f"foreground Dice {({k: round(v['mean_fg_dice'], 4) for k, v in info['all_results'].items()})}"
            f"; best {best['identifier']}")
        if best["identifier"] not in models + [ensemble] or \
                set(info["all_results"]) != set(models + [ensemble]):
            fail(f"inference_information.json: best {best['identifier']}, results "
                 f"{sorted(info['all_results'])}")
        pp_file = Path(best["postprocessing_file"])
        if not pp_file.is_file():
            fail(f"no {pp_file}")
        # the export of recipe A (deflating its checkpoints on the host; zlib
        # lets go of the GIL) in a thread beside the predict verbs below,
        # which read its folder and write elsewhere; install and predict once
        # it is done
        zip_file = tmp / "model_A.zip"
        exporter = ThreadPoolExecutor(1)

        def export():
            t_export = time.perf_counter()
            cli.export_model_entry(["-d", PIPELINE_DATASET, "-o", str(zip_file), "-c", "2d",
                                    "-tr", recipes[0], "-f", *PIPELINE_FOLDS])
            return time.perf_counter() - t_export

        exported = exporter.submit(export)
        exporter.shutdown(wait=False)

        # 4. predict the test cases with both recipes, ensemble, postprocess, evaluate
        preds = {}
        predict_c = {}
        verb_preds = []
        t0 = time.perf_counter()
        for name, model in zip(recipes, models):
            preds[model] = tmp / f"predicted_{name}"
            before = {k.name: k.launches for k in _ext.ALL_KERNELS}
            with recording_selves(NNUNetPredictor, "predict_from_files",
                                  verb_preds if name == recipes[0] else []):
                cli.predict_entry(["-i", str(raw / "imagesTs"), "-o", str(preds[model]),
                                   "-d", PIPELINE_DATASET, "-c", "2d", "-tr", name,
                                   "-f", *PIPELINE_FOLDS, "--save_probabilities"])
            for k in _ext.ALL_KERNELS:
                predict_c[k.name] = predict_c.get(k.name, 0) + k.launches - before[k.name]
            # the ensembling verb reads plans.json and dataset.json in its
            # input folders, as the JAX package's does
            for f in ("plans.json", "dataset.json"):
                shutil.copyfile(results / model / f, preds[model] / f)
        secs["predict (2 recipes)"] = time.perf_counter() - t0
        check_launches(predict_c, SERVE_KERNELS, ("selective_scan_bwd",) + FUSED_KERNELS,
                       "predict verbs")
        t0 = time.perf_counter()
        counted = {k.name: k.launches for k in _ext.ALL_KERNELS}
        predict_vs_twins(torch, card, verb_preds, raw, pre / cfg["data_identifier"], pre)
        for k in _ext.ALL_KERNELS:   # the comparison's launches are not the pipeline's
            k.launches = counted[k.name]
        secs["predict kernels vs plain twins"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds[ensemble] = tmp / "predicted_ensemble"
        cli.ensemble_entry(["-i", *(str(preds[m]) for m in models),
                            "-o", str(preds[ensemble])])
        final = tmp / "predicted_final"
        cli.apply_postprocessing_entry(["-i", str(preds[best["identifier"]]), "-o",
                                        str(final), "-pp_pkl_file", str(pp_file)])
        cli.evaluate_simple_entry([str(tmp / "labelsTs"), str(final), "-l", "1", "2", "3",
                                   "-o", str(final / "summary.json")])
        secs["ensemble, postprocess, evaluate"] = time.perf_counter() - t0
        pp = load_json(str(pp_file.parent / "postprocessing.json"))
        for folder in (preds[models[0]], preds[models[1]], preds[ensemble], final):
            segs = read_segs(folder)
            if len(segs) != PIPELINE_TEST_CASES:
                fail(f"{folder.name} holds {len(segs)} segmentations")
            for n, seg in segs.items():
                if seg.shape != (1, 10, 320, 260) or not set(np.unique(seg)) <= {0, 1, 2, 3}:
                    fail(f"{folder.name}/{n}: shape {seg.shape}, labels {np.unique(seg)}")
        summary = load_json(str(final / "summary.json"))
        dice = summary["foreground_mean"]["Dice"]
        log(f"  test cases: predicted by both recipes (fold {' '.join(PIPELINE_FOLDS)}, "
            "probabilities saved) in "
            f"{secs['predict (2 recipes)']:.1f} s, ensembled, postprocessed with "
            f"{pp['postprocessing_fns']} ({best['identifier']}) and evaluated in "
            f"{secs['ensemble, postprocess, evaluate']:.1f} s: mean foreground Dice "
            f"{dice:.4f}, per label "
            f"{({k: round(v['Dice'], 4) for k, v in summary['mean'].items()})} | {card}")
        if not math.isfinite(dice):
            fail(f"the test cases' mean foreground Dice is {dice}")

        # 5. recipe A's export (begun in step 3), installed into a fresh results
        # root, predicted again
        t0 = time.perf_counter()
        secs["export (beside step 4)"] = exported.result()
        waited = time.perf_counter() - t0
        paths.nnUNet_results = str(tmp / "results_installed")
        cli.install_model_entry([str(zip_file)])
        again = tmp / "predicted_installed"
        cli.predict_entry(["-i", str(raw / "imagesTs"), "-o", str(again), "-d",
                           PIPELINE_DATASET, "-c", "2d", "-tr", recipes[0],
                           "-f", *PIPELINE_FOLDS])
        secs["install, predict"] = time.perf_counter() - t0 - waited
        ref, got = read_segs(preds[models[0]]), read_segs(again)
        agree = min(float((got[n] == ref[n]).mean()) for n in ref) if \
            set(got) == set(ref) else 0.0
        log(f"  export_model_to_zip ({zip_file.stat().st_size / 2 ** 20:.1f} MiB) "
            f"{secs['export (beside step 4)']:.1f} s in a thread beside step 4 ({waited:.1f} s "
            f"waited for it after), install_pretrained_model_from_zip into a fresh results "
            f"root and the predict verb there {secs['install, predict']:.1f} s; segmentations "
            f"{100 * agree:.3f} % equal to the first prediction's (tol "
            f"{100 * TOL_PREDICT_AGREE:g} %)")
        if agree < TOL_PREDICT_AGREE:
            fail(f"the installed model's segmentations are {100 * agree:.3f} % equal")
        launches = {k.name: verbs[k.name] + k.launches for k in _ext.ALL_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    worker_cost.result()
    check_launches(launches, SERVE_KERNELS + ("selective_scan_bwd",), FUSED_KERNELS,
                   "run")
    total = time.perf_counter() - t_phase
    log(f"  seconds per stage: {({k: round(v, 1) for k, v in secs.items()})}; the phase "
        f"{total:.1f} s, peak memory {peak:.2f} GiB | {card}")
    log(f"  launches in the pipeline run: {launches}")
    log(f"[pipeline] phase done in {total:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 10: the 3-D U-Net
def unet3d_configuration(patch, batch: int = 2):
    """A ConfigurationManager of tools/bench_3d_unet.py's topology at
    ``patch`` (the plans' U-Net at full width)."""
    from mlagg_unet_torch.plans.plans_handler import ConfigurationManager

    return ConfigurationManager({
        "patch_size": list(patch), "batch_size": batch, "batch_dice": False,
        "UNet_base_num_features": UNET3D_FEATURES[0],
        "unet_max_num_features": UNET3D_FEATURES[-1],
        "conv_kernel_sizes": [[3, 3, 3]] * len(UNET3D_POOLS),
        "pool_op_kernel_sizes": [list(p) for p in UNET3D_POOLS],
        "n_conv_per_stage_encoder": [2] * len(UNET3D_POOLS),
        "n_conv_per_stage_decoder": [2] * (len(UNET3D_POOLS) - 1)})


def blobs_3d(torch, shape, seed: int):
    """A seeded (*shape, 1) image of smooth 3-D blobs, unit std, and its
    3-class label (two thresholds)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape[0], 1, *shape[1:], generator=g)
    for _ in range(2):
        x = torch.nn.functional.avg_pool3d(x, 7, stride=1, padding=3, count_include_pad=False)
    x = ((x - x.mean()) / x.std()).permute(0, 2, 3, 4, 1).contiguous()
    return x, torch.bucketize(x[..., 0], torch.tensor(UNET3D_THRESHOLDS))


def unet3d_grads(torch, dev: str, dtype):
    """nnUNetTrainer's loss and every gradient at batch 1 of UNET3D_GRAD_PATCH
    (seeded network and blobs) on ``dev`` in ``dtype``."""
    from mlagg_unet_torch.training.trainer import Trainer

    xb, yb = blobs_3d(torch, (1, *UNET3D_GRAD_PATCH), seed=1)
    tr = Trainer("nnUNetTrainer", batch_size=1, num_input_channels=1, num_classes=3, seed=0,
                 device=dev, compute_dtype=torch.float32,
                 configuration_manager=unet3d_configuration(UNET3D_GRAD_PATCH, batch=1))
    net = tr.network.to(dtype)
    return train_grads(tr, net, xb.to(tr.device, dtype), yb.to(tr.device))


def unet3d_cpu_refs(torch) -> dict:
    """Phase 10's CPU side: the bench topology's fp32 forward on the seeded
    tile (with its seconds), and ``unet3d_grads`` on the CPU in fp64 and
    fp32."""
    from mlagg_unet_torch.training.registry import get_network_builder

    net = get_network_builder("plans_unet")(unet3d_configuration(UNET3D_TILE), 1, 3, False,
                                            seed=0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, *UNET3D_TILE, 1).astype(np.float32))
    t0 = time.perf_counter()
    with torch.inference_mode():
        tile = (net(x), time.perf_counter() - t0)
    return {"tile": tile, "fp64": unet3d_grads(torch, "cpu", torch.float64),
            "fp32": unet3d_grads(torch, "cpu", torch.float32)}


def unet3d_agreement(torch, card: str) -> None:
    """The bench topology's forward on one tile, fp32 with TF32 off, card
    against CPU; the default recipe's loss and every gradient at batch 1 of
    UNET3D_GRAD_PATCH, card against CPU in fp64, and in fp32 the loss, with
    each side's gradient error against fp64 printed; the CPU's made by
    HostPrep (``unet3d_cpu_refs``)."""
    from mlagg_unet_torch.training.registry import get_network_builder

    net = get_network_builder("plans_unet")(unet3d_configuration(UNET3D_TILE), 1, 3, False,
                                            seed=0, device="cuda")
    log(f"  the bench topology (tools/bench_3d_unet.py): {len(UNET3D_POOLS)} stages, features "
        f"{list(UNET3D_FEATURES)}, 3x3x3 kernels, strides {[list(p) for p in UNET3D_POOLS]}: "
        f"{sum(p.numel() for p in net.parameters())} params")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, *UNET3D_TILE, 1).astype(np.float32))
    convs = [m for m in net.modules() if type(m).__name__ in ("Conv", "TransposedConvND")]
    contiguous = []
    hooks = [m.register_forward_hook(lambda m, i, o: contiguous.append(o.is_contiguous()))
             for m in convs]
    with torch.inference_mode():
        gpu = net(x.cuda())
        for h in hooks:
            h.remove()
    refs = HOST_PREP.folder("unet3d_refs")[1]   # the same seeded network on the CPU
    cpu, cpu_s = refs["tile"]
    if gpu.shape != (1, *UNET3D_TILE, 3) or not torch.isfinite(gpu).all():
        fail(f"3-D U-Net output {tuple(gpu.shape)}, finite={bool(torch.isfinite(gpu).all())}")
    log(f"  fp32 forward of one {UNET3D_TILE} tile, card vs CPU ({cpu_s:.1f} s on the CPU); "
        f"{sum(contiguous)} of {len(contiguous)} conv outputs on the card came back "
        f"channels_last_3d (the (B, D, H, W, C) view contiguous, no copy)")
    check(f"3-D U-Net tile {tuple(gpu.shape)}", gpu.cpu(), cpu, TOL_MODEL)
    del net, gpu, cpu

    # the loss and gradients: the card against the CPU in fp64, where both
    # compute the same numbers; in fp32 neither reaches 1e-3 x max against
    # fp64 on this network (PERF.md, PR 15), so the fp32 pair is held to the
    # loss tolerance and its gradients' errors against fp64 are printed
    res = {("cuda", dtype): unet3d_grads(torch, "cuda", dtype)
           for dtype in (torch.float64, torch.float32)}
    res["cpu", torch.float64], res["cpu", torch.float32] = refs["fp64"], refs["fp32"]
    log(f"  nnUNetTrainer's loss (DC+CE, deep supervision at the plans' scales) and every "
        f"gradient at batch 1 of {UNET3D_GRAD_PATCH} (the patch cut for the CPU)")
    compare_grads(torch, "3-D U-Net, fp64, card vs CPU", *res["cuda", torch.float64],
                  *res["cpu", torch.float64])
    (l_card, g_card), (l_cpu, g_cpu) = res["cuda", torch.float32], res["cpu", torch.float32]
    d = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"  loss 3-D U-Net, fp32, card vs CPU: {l_card:.7f} vs {l_cpu:.7f}: rel {d:.3e} "
        f"(tol {TOL_TRAIN_LOSS:g})")
    if not d <= TOL_TRAIN_LOSS or not all(torch.isfinite(g).all() for g in g_card.values()):
        fail(f"fp32 3-D U-Net loss, card vs CPU: rel {d:.3e}, or a gradient not finite")
    exact = res["cpu", torch.float64][1]
    for label, grads in (("card", g_card), ("CPU", g_cpu)):
        # the conv biases' gradients are zero but for rounding (a norm follows)
        errs = [((grads[k] - r).abs().max().item() / r.abs().max().item(),
                 ((grads[k] - r).norm() / r.norm()).item(), k)
                for k, r in exact.items() if k.endswith("weight") and r.abs().max() > 0]
        worst = max(errs)
        log(f"  fp32 {label} weight gradients against fp64: the largest |diff| / max|ref| "
            f"{worst[0]:.3e} ({worst[2]}), the largest rel L2 {max(e[1] for e in errs):.3e}")


def unet3d_serve(torch, card: str) -> None:
    """tools/bench_3d_unet.py's workload on the port: VolumePredictor, bf16
    compute and transfer, automatic tile batch, mirror (0, 1, 2), Gaussian,
    step 0.5; 4 volumes after 1 warm-up."""
    from mlagg_unet_torch import VolumePredictor
    from mlagg_unet_torch.training.registry import get_network_builder

    net = get_network_builder("plans_unet")(unet3d_configuration(UNET3D_TILE), 1, 3, False,
                                            seed=0, device="cuda")
    rng = np.random.RandomState(0)
    volumes = [rng.rand(*UNET3D_VOLUME).astype(np.float32) for _ in range(UNET3D_VOLUMES)]
    pred = VolumePredictor(net, UNET3D_TILE, 3, (0, 1, 2), None, compute_dtype=torch.bfloat16,
                           transfer_dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    first = pred(volumes[0])   # warm-up: the budget probe and the autotune
    warm_s = time.perf_counter() - t0
    tb = pred.last_tile_batch
    ms = {t: round(v, 4) for t, v in next(iter(pred.autotune_ms.values()), {}).items()}
    ref32 = VolumePredictor(net, UNET3D_TILE, 3, (0, 1, 2), tb, device="cuda")(volumes[0])
    d = float(np.linalg.norm(first - ref32) / np.linalg.norm(ref32))
    log(f"  warm-up volume {time.perf_counter() - t0:.1f} s ({warm_s:.1f} s with the probe and "
        f"the autotune): tile batch {tb} (model batch {tb * 8}); ms per tile of each candidate "
        f"{ms}; bf16 vs fp32 serving of volume 0: rel L2 {d:.3e} (tol {TOL_SERVE_REL_L2:g})")
    if not d <= TOL_SERVE_REL_L2:
        fail(f"3-D bf16 serving disagrees with fp32 serving: rel L2 {d:.3e}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, elapsed, queued = serve_window(pred, volumes)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for o in outs:
        if o.shape != (3, *UNET3D_VOLUME[1:]) or not np.isfinite(o).all():
            fail(f"3-D serve output {o.shape}, finite={bool(np.isfinite(o).all())}")
    stats = {}
    profile(torch, "one 3-D volume", lambda: pred(volumes[1]), stats)
    busy = f"{100 * stats['busy_ms'] / stats['wall_ms']:.1f} %" if stats else "not measured"
    log(f"  {UNET3D_VOLUMES} volumes of {'x'.join(map(str, UNET3D_VOLUME))}, tile "
        f"{UNET3D_TILE}, step 0.5, Gaussian, mirror (0, 1, 2), bf16 compute and transfer: "
        f"{UNET3D_VOLUMES / elapsed:.4f} volumes/s ({elapsed:.3f} s), tile batch {tb}, peak "
        f"memory {peak:.2f} GiB, device busy {busy} of one profiled volume | {card}")


def unet3d_batchnorm(torch, card: str) -> None:
    """nnUNetTrainerBN for UNET3D_BN_STEPS bf16 steps on one cached batch at
    the bench tile: the running statistics must move; then the eval forward
    (on them) card against CPU, fp32, at UNET3D_GRAD_PATCH."""
    from mlagg_unet_torch.training.trainer import Trainer

    tr = Trainer("nnUNetTrainerBN", batch_size=2, num_input_channels=1, num_classes=3, seed=0,
                 device="cuda", configuration_manager=unet3d_configuration(UNET3D_TILE))
    before = {k: b.clone() for k, b in tr.network.named_buffers()}
    x, y = blobs_3d(torch, (2, *UNET3D_TILE), seed=2)
    x, y = x.cuda(), y.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = tr.run_steps([(x, y)] * UNET3D_BN_STEPS)
    step_ms = 1e3 * (time.perf_counter() - t0) / UNET3D_BN_STEPS
    moved = {k: (b - before[k]).abs().max().item() for k, b in tr.network.named_buffers()}
    dtypes = {b.dtype for b in tr.network.buffers()}
    log(f"  nnUNetTrainerBN, {UNET3D_BN_STEPS} bf16 steps at batch 2 of {UNET3D_TILE} on one "
        f"cached batch: losses {['%.5f' % v for v in losses]}, {step_ms:.1f} ms per step with "
        f"the first; {len(moved)} running buffers ({dtypes}), each moved by at least "
        f"{min(moved.values()):.3e} | {card}")
    if dtypes != {torch.float32} or not min(moved.values()) > 0:
        fail(f"the BatchNorm running statistics did not move in fp32: {dtypes}, {moved}")
    xe, _ = blobs_3d(torch, (1, *UNET3D_GRAD_PATCH), seed=3)
    net = tr.network.eval()
    with torch.inference_mode():
        gpu = net(xe.cuda())[0]
        cpu = copy.deepcopy(net).cpu()(xe)[0]
    check(f"BatchNorm eval forward (running statistics) {tuple(gpu.shape)}, card vs CPU",
          gpu.cpu(), cpu, TOL_MODEL)


def write_unet3d_raw(root: Path, threads: int = 8) -> Path:
    """The 3-D dataset: UNET3D_CASES training and UNET3D_TEST_CASES test cases
    of UNET3D_VOLUME at 1 mm isotropic (seeded smooth blobs, 3 labels),
    written on ``threads`` threads."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy.ndimage import gaussian_filter

    from mlagg_unet_torch.imageio.nifti_io import write_nifti
    from mlagg_unet_torch.utils.helpers import save_json

    raw = root / "raw" / UNET3D_DATASET
    for d in (raw / "imagesTr", raw / "labelsTr", raw / "imagesTs"):
        d.mkdir(parents=True)
    save_json(dict(UNET3D_DATASET_JSON, numTraining=UNET3D_CASES), str(raw / "dataset.json"),
              sort_keys=False)
    rng = np.random.RandomState(2)
    n = UNET3D_CASES + UNET3D_TEST_CASES
    noise = [rng.randn(*UNET3D_VOLUME[1:]).astype(np.float32) for _ in range(n)]

    def write(i):
        img = gaussian_filter(noise[i], 4)
        img /= img.std()
        name = f"case_{i:03d}"
        test = i >= UNET3D_CASES
        write_nifti(str(raw / ("imagesTs" if test else "imagesTr") / f"{name}_0000.nii.gz"),
                    img.transpose(2, 1, 0), (1.0, 1.0, 1.0))
        if not test:
            lab = np.digitize(img, UNET3D_THRESHOLDS).astype(np.uint8)
            write_nifti(str(raw / "labelsTr" / f"{name}.nii.gz"), lab.transpose(2, 1, 0),
                        (1.0, 1.0, 1.0))

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(n)))
    return raw


def register_unet3d_recipe(name: str, epochs: int, steps: int, val_steps: int) -> None:
    """nnUNetTrainer cut to ``epochs`` epochs of ``steps`` steps and
    ``val_steps`` validation steps (registered here only)."""
    from dataclasses import replace

    from mlagg_unet_torch.training import registry

    registry.register_trainer(replace(
        registry.get_trainer_config("nnUNetTrainer"), name=name, num_epochs=epochs,
        num_iterations_per_epoch=steps, num_val_iterations_per_epoch=val_steps))


def check_segs(folder: Path, names, where: str) -> None:
    segs = read_segs(folder)
    if sorted(segs) != sorted(names):
        fail(f"{where}: {sorted(segs)} written (want {sorted(names)})")
    for n, seg in segs.items():
        if seg.shape != UNET3D_VOLUME or not set(np.unique(seg)) <= {0, 1, 2}:
            fail(f"{where}, {n}: shape {seg.shape}, labels {np.unique(seg)}")


def prepare_unet3d(root: Path, workers: int, threads: int) -> dict:
    """Phase 10's 3-D dataset under ``root`` (``threads`` writer threads),
    ``plan_and_preprocess_entry -c 3d_fullres`` on ``workers`` spawned
    workers, and the cascade's 3d_lowres preprocessed from the plans with
    ``cascade_plans`` added, the plans file then put back as the planner
    wrote it (``unet3d_cascade`` adds them again)."""
    from mlagg_unet_torch.cli import entrypoints as cli
    from mlagg_unet_torch.utils.helpers import load_json, save_json

    with paths_at(root):
        t0 = time.perf_counter()
        write_unet3d_raw(root, threads)
        log(f"[unet3d] the train verb: {UNET3D_CASES} training and {UNET3D_TEST_CASES} "
            f"test cases of {'x'.join(map(str, UNET3D_VOLUME))} at 1 mm written in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli.plan_and_preprocess_entry(["-d", UNET3D_ID, "-c", "3d_fullres", "-np", str(workers)])
        plans_file = root / "preprocessed" / UNET3D_DATASET / "nnUNetPlans.json"
        planned = plans_file.read_text()
        plans = load_json(str(plans_file))
        cfg = plans["configurations"]["3d_fullres"]
        log(f"  plan_and_preprocess -c 3d_fullres ({workers} spawned workers): "
            f"{time.perf_counter() - t0:.1f} s; the plan's "
            f"3d_fullres: patch {cfg['patch_size']}, batch {cfg['batch_size']}, spacing "
            f"{cfg['spacing']}, {len(cfg['pool_op_kernel_sizes'])} stages, pools "
            f"{cfg['pool_op_kernel_sizes']}, kernels {cfg['conv_kernel_sizes']}, features "
            f"{cfg['UNet_base_num_features']}-{cfg['unet_max_num_features']}")
        save_json(cascade_plans(plans), str(plans_file), sort_keys=False)
        t0 = time.perf_counter()
        cli.preprocess_entry(["-d", UNET3D_ID, "-c", "3d_lowres", "-np", str(workers)])
        plans_file.write_text(planned)
        log(f"  3d_lowres at {UNET3D_LOWRES_SPACING} mm (patch {cascade_shape()}, "
            f"{len(UNET3D_LOWRES_POOLS)} stages) preprocessed in "
            f"{time.perf_counter() - t0:.1f} s ({workers} spawned workers)")
    return {}


def unet3d_train_verb(torch, card: str, tmp: Path, raw: Path) -> None:
    """The train verb (nnUNetTrainer cut to UNET3D_EPOCHS epochs of
    UNET3D_STEPS steps) on fold 0 of the cases ``prepare_unet3d``
    preprocessed, the predict verb on the test cases; the step on one cached
    batch."""
    from mlagg_unet_torch.cli import entrypoints as cli
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.plans.plans_handler import PlansManager
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.training.trainer import Trainer
    from mlagg_unet_torch.utils.helpers import load_json

    pre = tmp / "preprocessed" / UNET3D_DATASET
    plans = load_json(str(pre / "nnUNetPlans.json"))
    register_unet3d_recipe(UNET3D_RECIPE, UNET3D_EPOCHS, UNET3D_STEPS, UNET3D_VAL_STEPS)
    first, steps = {}, []
    verb = [UNET3D_ID, "3d_fullres", "0", "-tr", UNET3D_RECIPE]
    with recording_first_batches(first), \
            attribute_launches(_ext, Trainer, "train_step", {}, steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.train_entry(verb)
        verb_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    folder = tmp / "results" / UNET3D_DATASET / f"{UNET3D_RECIPE}__nnUNetPlans__3d_fullres"
    ck = load_checkpoint(str(folder / "fold_0" / "checkpoint_final.ckpt"))
    lg = ck["logging"]
    epoch_s = [e - s for s, e in zip(lg["epoch_start_timestamps"], lg["epoch_end_timestamps"])]
    if len(steps) != UNET3D_EPOCHS * UNET3D_STEPS or not all(
            math.isfinite(v) for v in lg["train_losses"] + lg["val_losses"]):
        fail(f"the 3-D train verb ran {len(steps)} steps, losses {lg['train_losses']} "
             f"{lg['val_losses']}")
    summary = load_json(str(folder / "fold_0" / "validation" / "summary.json"))
    last = steps[(UNET3D_EPOCHS - 1) * UNET3D_STEPS:]   # the last epoch's, without its first
    gaps = [1e3 * (b[0] - a[0]) for a, b in zip(last[1:], last[2:])]
    step_ms = statistics.median(gaps)
    # the same step on one cached batch: the loader's first, on the card
    cm = PlansManager(plans).get_configuration("3d_fullres")
    tr = Trainer(UNET3D_RECIPE, num_input_channels=1, num_classes=3, seed=0, device="cuda",
                 batch_size=cm.batch_size, batch_dice=cm.batch_dice, configuration_manager=cm)
    x = torch.from_numpy(np.ascontiguousarray(first["train"]["data"])).cuda()
    y = torch.from_numpy(np.ascontiguousarray(first["train"]["target"])).cuda()
    tr.run_steps([(x, y)] * 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.run_steps([(x, y)] * UNET3D_STEPS)
    cached_ms = 1e3 * (time.perf_counter() - t1) / UNET3D_STEPS
    log(f"  train verb {' '.join(verb)}: {verb_s:.1f} s ({UNET3D_EPOCHS} epochs of "
        f"{UNET3D_STEPS} steps + {UNET3D_VAL_STEPS} validation steps, unpacking, checkpoints "
        f"and the final validation of {len(summary['metric_per_case'])} cases); seconds per "
        f"epoch {', '.join(f'{t:.3f}' for t in epoch_s)}; ms per step with the loader "
        f"(median of {len(gaps)} in the last epoch) {step_ms:.1f}, on one cached batch "
        f"{cached_ms:.1f}; peak memory {peak:.2f} GiB | {card}")
    log(f"  losses: train {['%.5f' % v for v in lg['train_losses']]}, validation "
        f"{['%.5f' % v for v in lg['val_losses']]}; pseudo dice "
        f"{['%.4f' % v for v in lg['mean_fg_dice']]}; final validation mean foreground Dice "
        f"{summary['foreground_mean']['Dice']:.4f}")
    del tr, x, y
    out = tmp / "predicted_3d"
    t0 = time.perf_counter()
    cli.predict_entry(["-i", str(raw / "imagesTs"), "-o", str(out), "-d", UNET3D_ID, "-c",
                       "3d_fullres", "-tr", UNET3D_RECIPE, "-f", "0"])
    check_segs(out, [f"case_{i:03d}.nii.gz" for i in range(UNET3D_CASES, UNET3D_CASES +
                                                           UNET3D_TEST_CASES)],
               "the 3-D predict verb")
    log(f"  predict verb (bf16, the budget's tile batch, mirror (0, 1, 2)) on the "
        f"{UNET3D_TEST_CASES} test case(s): {time.perf_counter() - t0:.1f} s | {card}")


def cascade_shape() -> list:
    """The 3d_lowres cases' shape at UNET3D_LOWRES_SPACING: the patch."""
    return [int(round(s / UNET3D_LOWRES_SPACING)) for s in UNET3D_VOLUME[1:]]


def cascade_plans(plans: dict) -> dict:
    """``plans`` with a hand-written 3d_lowres (at UNET3D_LOWRES_SPACING,
    the patch the cases' size) and 3d_cascade_fullres after it."""
    plans = copy.deepcopy(plans)
    full = plans["configurations"]["3d_fullres"]
    shape = cascade_shape()
    plans["configurations"]["3d_lowres"] = {
        **full, "data_identifier": "nnUNetPlans_3d_lowres", "batch_size": 2,
        "spacing": [UNET3D_LOWRES_SPACING] * 3, "median_image_size_in_voxels": shape,
        "patch_size": shape, "pool_op_kernel_sizes": [list(p) for p in UNET3D_LOWRES_POOLS],
        "conv_kernel_sizes": [[3, 3, 3]] * len(UNET3D_LOWRES_POOLS),
        "n_conv_per_stage_encoder": [2] * len(UNET3D_LOWRES_POOLS),
        "n_conv_per_stage_decoder": [2] * (len(UNET3D_LOWRES_POOLS) - 1),
        "batch_dice": False, "next_stage": "3d_cascade_fullres"}
    plans["configurations"]["3d_cascade_fullres"] = {"inherits_from": "3d_fullres",
                                                     "previous_stage": "3d_lowres"}
    return plans


def unet3d_cascade(torch, card: str, tmp: Path, raw: Path) -> None:
    """The 3d_lowres and 3d_cascade_fullres pair of ``cascade_plans`` (the
    lowres cases preprocessed by ``prepare_unet3d``): the lowres stage trains
    one short epoch on all cases (fold 'all') and its final validation
    writes predicted_next_stage for every case; the cascade stage trains one
    short epoch on fold 0 from them; then the predict verbs: lowres, then the
    cascade with -prev_stage_predictions."""
    from mlagg_unet_torch.cli import entrypoints as cli
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.utils.helpers import load_json, save_json

    pre = tmp / "preprocessed" / UNET3D_DATASET
    save_json(cascade_plans(load_json(str(pre / "nnUNetPlans.json"))),
              str(pre / "nnUNetPlans.json"), sort_keys=False)
    log("  3d_lowres and 3d_cascade_fullres after it written into the plans")
    register_unet3d_recipe(UNET3D_CASCADE_RECIPE, 1, UNET3D_CASCADE_STEPS, 1)
    secs = {}
    t0 = time.perf_counter()
    cli.train_entry([UNET3D_ID, "3d_lowres", "all", "-tr", UNET3D_CASCADE_RECIPE])
    secs["3d_lowres train + validation (fold all)"] = time.perf_counter() - t0
    base = tmp / "results" / UNET3D_DATASET
    nxt = base / f"{UNET3D_CASCADE_RECIPE}__nnUNetPlans__3d_lowres" / "predicted_next_stage" \
        / "3d_cascade_fullres"
    written = sorted(p.name for p in nxt.glob("*.npz"))
    if len(written) != UNET3D_CASES:
        fail(f"the lowres stage wrote {len(written)} next-stage segmentations (want "
             f"{UNET3D_CASES})")
    seg = np.load(nxt / written[0])["seg"]
    if seg.shape != (1, *UNET3D_VOLUME[1:]) or not set(np.unique(seg)) <= {0, 1, 2}:
        fail(f"next-stage segmentation {written[0]}: shape {seg.shape}, labels {np.unique(seg)}")
    t0 = time.perf_counter()
    cli.train_entry([UNET3D_ID, "3d_cascade_fullres", "0", "-tr", UNET3D_CASCADE_RECIPE])
    secs["3d_cascade_fullres train + validation (fold 0)"] = time.perf_counter() - t0
    cas = base / f"{UNET3D_CASCADE_RECIPE}__nnUNetPlans__3d_cascade_fullres" / "fold_0"
    w = load_checkpoint(str(cas / "checkpoint_final.ckpt"))["network_weights"][
        "encoder_stage0"]["conv0"]["conv"]["kernel"]
    summary = load_json(str(cas / "validation" / "summary.json"))
    if w.shape[3] != 1 + 2:
        fail(f"the cascade stage's first conv takes {w.shape[3]} channels (want 1 + 2)")
    low_out, cas_out = tmp / "predicted_lowres", tmp / "predicted_cascade"
    t0 = time.perf_counter()
    cli.predict_entry(["-i", str(raw / "imagesTs"), "-o", str(low_out), "-d", UNET3D_ID, "-c",
                       "3d_lowres", "-tr", UNET3D_CASCADE_RECIPE, "-f", "all"])
    cli.predict_entry(["-i", str(raw / "imagesTs"), "-o", str(cas_out), "-d", UNET3D_ID, "-c",
                       "3d_cascade_fullres", "-tr", UNET3D_CASCADE_RECIPE, "-f", "0",
                       "-prev_stage_predictions", str(low_out)])
    secs["predict lowres, then cascade"] = time.perf_counter() - t0
    names = [f"case_{i:03d}.nii.gz" for i in range(UNET3D_CASES, UNET3D_CASES + UNET3D_TEST_CASES)]
    check_segs(low_out, names, "the lowres predict verb")
    check_segs(cas_out, names, "the cascade predict verb")
    log(f"  cascade: {len(written)} next-stage segmentations of {seg.shape[1:]}; the cascade "
        f"stage's input 1 + 2 channels, its final validation mean foreground Dice "
        f"{summary['foreground_mean']['Dice']:.4f}; seconds "
        f"{({k: round(v, 1) for k, v in secs.items()})} | {card}")


def phase_unet3d(torch, card: str, keep: Path = None) -> None:
    """Phase 10: the default nnU-Net recipe in 3-D on the card. None of
    K1-K8 may be launched. ``keep``: where the preprocessed 3d_fullres cases
    and the raw test cases are copied for phase 12."""
    from mlagg_unet_torch.ops import _ext

    t_phase = time.perf_counter()
    _ext.reset_launch_counts()
    log("[unet3d] the plans U-Net at full width: fp32 agreement, card vs CPU")
    unet3d_agreement(torch, card)
    log(f"[unet3d] serve (tools/bench_3d_unet.py's workload) | {card}")
    unet3d_serve(torch, card)
    log(f"[unet3d] BatchNorm (nnUNetTrainerBN) | {card}")
    unet3d_batchnorm(torch, card)
    torch.cuda.empty_cache()
    with verb_paths("chip_smoke_unet3d_", HOST_PREP.folder("unet3d")[0]) as tmp:
        raw = tmp / "raw" / UNET3D_DATASET
        # the verbs' predictors take the budget's tile batch: the serve
        # step above times the autotune's candidates, which each new
        # predictor would time again (~5 s a 3-D network)
        with no_autotune():
            unet3d_train_verb(torch, card, tmp, raw)
            if keep is not None:   # the 3d_fullres cases, not the lowres ones
                shutil.copytree(tmp / "preprocessed" / UNET3D_DATASET, keep / "preprocessed",
                                ignore=shutil.ignore_patterns("nnUNetPlans_3d_lowres"))
                shutil.copytree(raw, keep / "raw")
            log("[unet3d] the cascade: 3d_lowres -> 3d_cascade_fullres")
            unet3d_cascade(torch, card, tmp, raw)
    launched = {k.name: k.launches for k in _ext.ALL_KERNELS if k.launches}
    if launched:
        fail(f"the 3-D U-Net phase launched port kernels: {launched}")
    log(f"  launches of K1-K8 in the phase: none of {len(_ext.ALL_KERNELS)} | {card}")
    log(f"[unet3d] phase done in {time.perf_counter() - t_phase:.1f} s")


def mamba_configuration(batch: int = MAMBA_BATCH):
    """The ConfigurationManager of the family's 2d plan (MAMBA_PLANS)."""
    from mlagg_unet_torch.plans.plans_handler import ConfigurationManager

    return ConfigurationManager(dict(MAMBA_PLANS["configurations"]["2d"], batch_size=batch))


@contextlib.contextmanager
def recording_scan_calls(calls: dict):
    """While active, every K1 launch (``_launch_fwd``) and K5 call
    (``selective_scan_bwd``) adds its kernel to ``calls[(b, g, d, L, n,
    dtype, reverse)]``."""
    from mlagg_unet_torch.ops import selective_scan_cuda as ssc

    fwd, bwd = ssc._launch_fwd, ssc.selective_scan_bwd

    def key(u, A, reverse):
        return (*u.shape, A.shape[-1], str(u.dtype).replace("torch.", ""), bool(reverse))

    def rec_fwd(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse, with_states):
        calls.setdefault(key(u, A, reverse), set()).add("K1")
        return fwd(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse, with_states)

    def rec_bwd(u, *args, **kwargs):
        reverse = kwargs["reverse"] if "reverse" in kwargs else args[7]
        A = kwargs["A"] if "A" in kwargs else args[1]
        calls.setdefault(key(u, A, reverse), set()).add("K5")
        return bwd(u, *args, **kwargs)

    ssc._launch_fwd, ssc.selective_scan_bwd = rec_fwd, rec_bwd
    try:
        yield
    finally:
        ssc._launch_fwd, ssc.selective_scan_bwd = fwd, bwd


@contextlib.contextmanager
def fp64_plain_scans():
    """While active, the scan's plain twins compute in fp64: their operands
    widened, y returned in fp64 and the gradients in the operands' dtypes.
    The exact scan of the operands a network hands them."""
    import torch

    from mlagg_unet_torch.ops import selective_scan_cuda as ssc

    fwd, bwd = ssc.selective_scan, ssc.selective_scan_bwd_plain

    def wide(args):
        return [a.double() if torch.is_tensor(a) else a for a in args]

    def bwd64(*args, **kwargs):
        grads = bwd(*wide(args), **dict(zip(kwargs, wide(kwargs.values()))))
        return tuple(None if g is None else g.to(a.dtype) for g, a in zip(grads, args))

    ssc.selective_scan = lambda *args, **kwargs: fwd(*wide(args), **kwargs)
    ssc.selective_scan_bwd_plain = bwd64
    try:
        yield
    finally:
        ssc.selective_scan, ssc.selective_scan_bwd_plain = fwd, bwd


@contextlib.contextmanager
def plain_scan_half_chunks():
    """While active, the scan's plain twins run in chunks of half their
    default (``default_chunk``: 128 steps up to L = 16,384): the same
    function, summed in another order."""
    from mlagg_unet_torch.ops import selective_scan_cuda as ssc
    from mlagg_unet_torch.ops.selective_scan import default_chunk

    fwd, bwd = ssc.selective_scan, ssc.selective_scan_bwd_plain

    def half(fn):
        return lambda u, *a, **k: fn(u, *a, chunk_size=default_chunk(u.shape[-1]) // 2, **k)

    ssc.selective_scan, ssc.selective_scan_bwd_plain = half(fwd), half(bwd)
    try:
        yield
    finally:
        ssc.selective_scan, ssc.selective_scan_bwd_plain = fwd, bwd


@contextlib.contextmanager
def keeping_scan_bwd_calls(kept: list):
    """While active, each K5 call's operands and flags are appended to
    ``kept``."""
    from mlagg_unet_torch.ops import selective_scan_cuda as ssc

    bwd = ssc.selective_scan_bwd

    def keeping(*args, **kwargs):
        kept.append((args, kwargs))
        return bwd(*args, **kwargs)

    ssc.selective_scan_bwd = keeping
    try:
        yield
    finally:
        ssc.selective_scan_bwd = bwd


def scan_fp64(u, delta, A, B, C, D, delta_bias, delta_softplus, reverse):
    """The scan's y in fp64 (the plain twin on fp64 operands): the yardstick
    of both fp32 scans' rounding."""
    from mlagg_unet_torch.ops.selective_scan import selective_scan

    return selective_scan(*(None if t is None else t.double()
                            for t in (u, delta, A, B, C, D, delta_bias)),
                          delta_softplus, reverse=reverse)


def scan_calls_vs_twins(torch, kept: list) -> None:
    """K1 (with states) and K5 on the operands a network handed them,
    against their plain twins (phase 3's tolerances), and both scans' y
    against the scan in fp64. No autograd: the kept operands are tensors of
    the network's graph."""
    log(f"    device memory: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    with torch.no_grad():
        for args, kwargs in kept:
            scan_call_vs_twins(torch, args[:9], args[9] if len(args) > 9 else kwargs["gy"])


def scan_call_vs_twins(torch, ops: tuple, gy) -> None:
    from mlagg_unet_torch.ops.selective_scan import selective_scan_bwd_plain
    from mlagg_unet_torch.ops.selective_scan_cuda import (
        scan_fwd_plain, selective_scan_bwd, selective_scan_fwd_states)

    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    y, states = selective_scan_fwd_states(*ops)
    y_plain = scan_fwd_plain(*ops)
    e1 = rel_err(y, y_plain)[1]
    got = selective_scan_bwd(*ops, gy, states)
    ref = selective_scan_bwd_plain(*ops, gy.float())
    errs = {nm: rel_err(a, r_)[1] for nm, a, r_ in zip(names, got, ref) if a is not None}
    del got, ref, states
    delta = torch.nn.functional.softplus(ops[1].float() + ops[6].float()[None, :, :, None])
    y64 = scan_fp64(*ops)
    log(f"    on the network's operands {tuple(ops[0].shape)} {ops[0].dtype}: K1 rel "
        f"{e1:.2e}; K5 " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; softplus(delta) in [{delta.min().item():.2e}, {delta.max().item():.2e}]; "
        f"y against the scan in fp64: K1 rel {rel_err(y, y64)[1]:.2e}, plain twin "
        f"{rel_err(y_plain, y64)[1]:.2e}")
    tol = TOL_SCAN_GRAD if ops[0].dtype == torch.float32 else TOL_SCAN_GRAD_BF16
    if not (e1 <= TOL_SCAN and all(v <= tol for v in errs.values())):
        fail(f"K1/K5 on the network's operands {tuple(ops[0].shape)}: K1 {e1:.3e}, K5 {errs}")


def mamba_scan_shapes(torch, nets: dict) -> dict:
    """Every (b, g, d, L, dtype, reverse) at which one fp32 forward and one
    backward of each network at batch MAMBA_GRAD_BATCH (and of the SS2D
    cell's bf16 scan type v04 at VM-UNet's first stage) calls K1 and K5."""
    from mlagg_unet_torch.models.layers import init_parameters
    from mlagg_unet_torch.models.mamba_block import SS2D

    calls, per_model = {}, {}
    g = torch.Generator().manual_seed(3)
    x = torch.randn(MAMBA_GRAD_BATCH, *MAMBA_PATCH, 1, generator=g).cuda()
    for name, net in nets.items():
        seen = {}
        with recording_scan_calls(seen):
            outs = net(x)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            sum(o.float().square().mean() for o in outs).backward()
        net.zero_grad(set_to_none=True)
        per_model[name] = sorted(seen)
        for k, v in seen.items():
            calls.setdefault(k, set()).update(v)
    cell = init_parameters(SS2D(96, forward_type="v04"), torch.Generator().manual_seed(0))
    cell = cell.to("cuda", torch.bfloat16)
    xc = torch.randn(MAMBA_GRAD_BATCH, 80, 80, 96, generator=g).to("cuda", torch.bfloat16)
    seen = {}
    with recording_scan_calls(seen):
        cell(xc).float().square().mean().backward()
    per_model["SS2D v04 (bf16 scan) at VM-UNet's stage 0"] = sorted(seen)
    for k, v in seen.items():
        calls.setdefault(k, set()).update(v)
    torch.cuda.synchronize()
    for name, keys in per_model.items():
        log(f"  {name}: K1/K5 at (b, g, d, L, dtype, reverse) " + ", ".join(map(str, keys)))
    return calls


def mamba_scan_checks(torch, card: str, calls: dict, held: set) -> None:
    """K1 (with its tile-entry states) and K5 against their plain twins at
    every recorded shape, phase 3's tolerances; the shapes must include L <
    64, L % 8 != 0, L >= 1e5, g = 2 reversed and a bf16 scan. Then K1 and K5
    timed at the family's largest shape (U-Mamba Enc's stage 0 at the
    training batch) beside their plain twins and their bound."""
    want = {"L < 64": lambda k: k[3] < 64, "L % 8 != 0": lambda k: k[3] % 8 != 0,
            "L >= 1e5": lambda k: k[3] >= 100_000, "g = 2 reversed": lambda k: k[1] == 2 and k[6],
            "bf16": lambda k: k[5] == "bfloat16"}
    missing = [w for w, f in want.items() if not any(f(k) for k in calls)]
    if missing or any(v != {"K1", "K5"} for v in calls.values()):
        fail(f"the family's scans miss {missing} or a shape ran K1 or K5 only: {calls}")
    scan_shape_checks(torch, calls, held)
    # the largest shape: U-Mamba Enc's stage 0 at the training batch
    scan_timing(torch, card, (MAMBA_BATCH, 1, 2 * MAMBA_FEATURES[0],
                              MAMBA_PATCH[0] * MAMBA_PATCH[1], 16),
                "U-Mamba Enc stage 0, training batch")


def scan_operands(torch, b, g, d, L, n, dtype, seed):
    """Seeded scan operands on the card at (b, g, d, L) with n states: A the
    S4D init, delta's bias the softplus-inverse of dt in [1e-3, 0.1], D
    near 1; and an fp32 output gradient."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(g, d, n).contiguous()
    dt0 = torch.exp(torch.rand(g, d, generator=gen, device=dev)
                    * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias, Dp = dt0 + torch.log(-torch.expm1(-dt0)), 1 + 0.1 * rnd(g, d)
    u, dl = rnd(b, g, d, L, dt=dtype), rnd(b, g, d, L, scale=0.5, dt=dtype)
    Bm, Cm = rnd(b, g, n, L, dt=dtype), rnd(b, g, n, L, dt=dtype)
    return (u, dl, A, Bm, Cm, Dp, bias), rnd(b, g, d, L)


def scan_shape_checks(torch, calls: dict, held: set) -> None:
    """K1 (with its tile-entry states) and K5 against their plain twins at
    every recorded (b, g, d, L, n, dtype, reverse) not in ``held`` (the
    shapes an earlier phase of this run held), phase 3's tolerances; each
    shape held is added to ``held``."""
    from mlagg_unet_torch.ops.selective_scan import selective_scan_bwd_plain
    from mlagg_unet_torch.ops.selective_scan_cuda import (
        scan_fwd_plain, selective_scan_bwd, selective_scan_fwd_states)

    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    skipped = sorted(k for k in calls if k in held)
    log(f"  {len(calls)} distinct shapes; {len(skipped)} held by an earlier phase of this run "
        f"and skipped {skipped}; holding K1 and K5 to their plain twins at each of the others")
    for i, (b, g, d, L, n, dt, rev) in enumerate(sorted(calls)):
        if (b, g, d, L, n, dt, rev) in held:
            continue
        held.add((b, g, d, L, n, dt, rev))
        dtype = getattr(torch, dt)
        ops, gy = scan_operands(torch, b, g, d, L, n, dtype, seed=11 + i)
        args = (*ops, True, rev)
        t0 = time.perf_counter()
        y, states = selective_scan_fwd_states(*args)
        e1 = rel_err(y, scan_fwd_plain(*args))[1]
        del y
        got = selective_scan_bwd(*args, gy, states)
        ref = selective_scan_bwd_plain(*args, gy)
        errs = {nm: rel_err(a, r_)[1] for nm, a, r_ in zip(names, got, ref)}
        tol = TOL_SCAN_GRAD if dtype == torch.float32 else TOL_SCAN_GRAD_BF16
        log(f"    ({b}, {g}, {d}, {L}) n={n} {dt} reverse={rev}: K1 rel {e1:.2e} (tol "
            f"{TOL_SCAN:g}); K5 worst {max(errs, key=errs.get)} rel {max(errs.values()):.2e} "
            f"(tol {tol:g}); {time.perf_counter() - t0:.1f} s with the twins")
        if not (e1 <= TOL_SCAN and all(math.isfinite(v) and v <= tol for v in errs.values())):
            fail(f"K1/K5 at ({b}, {g}, {d}, {L}) n={n} {dt} reverse={rev}: K1 {e1:.3e}, "
                 f"K5 {errs}")
        del states, got, ref, ops, gy
        torch.cuda.empty_cache()


def scan_timing(torch, card: str, shape, label: str, plain_reps: int = 3) -> None:
    """K1 with states and K5 at (b, g, d, L, n) fp32, each timed beside its
    plain twin and its bound."""
    from mlagg_unet_torch.ops.selective_scan import selective_scan_bwd_plain
    from mlagg_unet_torch.ops.selective_scan_cuda import (
        STATE_EVERY, scan_fwd_plain, selective_scan_bwd, selective_scan_fwd_states)

    b, g, d, L, n = shape
    ops, gy = scan_operands(torch, b, g, d, L, n, torch.float32, seed=7)
    args = (*ops, True, False)
    _, states = selective_scan_fwd_states(*args)
    k1 = time_ms(lambda: selective_scan_fwd_states(*args), reps=10)
    k5 = time_ms(lambda: selective_scan_bwd(*args, gy, states), reps=10)
    p1 = time_ms(lambda: scan_fwd_plain(*args), reps=plain_reps, warmup=min(1, plain_reps - 1))
    p5 = time_ms(lambda: selective_scan_bwd_plain(*args, gy), reps=plain_reps,
                 warmup=min(1, plain_reps - 1))
    el, bc = b * g * d * L, b * g * n * L
    st = b * g * math.ceil(L / STATE_EVERY) * d * n * 4
    par = (g * d * n + 2 * g * d) * 4
    exp_rate = sfu_exp_per_s(torch)
    # each input read once and each output written once, fp32 operands;
    # K1 writes y and the tile-entry states, K5 reads them and gy and writes
    # the seven gradients
    b1 = bound_ms(2 * el * 4 + 2 * bc * 4 + par + el * 4 + st, el * (6 * n + 7), "fp32",
                  el * n, exp_rate)
    b5 = bound_ms(2 * el * 4 + 2 * bc * 4 + el * 4 + st + 2 * par + 2 * el * 4 + 2 * bc * 4,
                  15 * el * n + 10 * el, "fp32", el * n, exp_rate)
    log(f"  K1 with states at ({b}, {g}, {d}, {L}) n={n} fp32 ({label}): {k1:.4f} ms, plain "
        f"{p1:.3f} ms, bound {b1[0]:.4f} ms ({b1[1]}) | {card}")
    log(f"  K5 at ({b}, {g}, {d}, {L}) n={n} fp32: {k5:.4f} ms, plain {p5:.3f} ms, bound "
        f"{b5[0]:.4f} ms ({b5[1]}) | {card}")
    del ops, gy, states
    torch.cuda.empty_cache()


def tile_groups(tag: str) -> list:
    """The card-vs-CPU tiles of zoo phase ``tag``: (trainer names, those of
    them on phase 10's 3-D plan, tile, classes) groups. The 3-D networks and
    the 2-D ones but the U-Mambas and MSVM-UNet take tiles cut for the CPU;
    TransUNet's position embedding is the plan's patch, and the transformers
    take it whole."""
    umambas = [k for k in MAMBA_TRAINERS if "UMamba" in k and "Swin" not in k]
    ss3d_umambas = [k for k in SS3D_3D if "UMamba" in k]
    return {
        "mamba": [(umambas, (), MAMBA_PATCH, MAMBA_CLASSES),
                  ([k for k in MAMBA_TRAINERS if k not in umambas], (), ZOO_CPU_TILE_2D,
                   MAMBA_CLASSES)],
        "ss3d": [(ss3d_umambas, SS3D_3D, SS3D_CPU_TILE, SS3D_CLASSES),
                 ([k for k in SS3D_3D if k not in ss3d_umambas], SS3D_3D, VMUNET3D_CPU_TILE,
                  SS3D_CLASSES),
                 ((MSVM_TRAINER,), (), MAMBA_PATCH, MAMBA_CLASSES)],
        "variants": [(VARIANT_3D, VARIANT_3D, SS3D_CPU_TILE, SS3D_CLASSES),
                     ([k for k in VARIANT_NETWORKS if k not in VARIANT_3D], (),
                      VARIANT_CPU_TILE_2D, MAMBA_CLASSES)],
        "lkm-mednext": [(LKM_NETWORKS, (), ZOO_CPU_TILE_2D, MAMBA_CLASSES)],
        "transformers": [(TRANSFORMER_NETWORKS, (), MAMBA_PATCH, MAMBA_CLASSES)],
    }[tag]


def seeded_tile(torch, patch):
    return torch.from_numpy(np.random.RandomState(5).randn(1, *patch, 1).astype(np.float32))


def first_output(o):
    return o[0] if isinstance(o, (list, tuple)) else o


def cpu_tiles(torch, tag: str) -> dict:
    """The CPU side of ``tile_agreement``: each network of ``tile_groups(tag)``
    built as its trainer builds it (seed 0), on the CPU, and its first
    output on the seeded tile, with the seconds it took."""
    out = {}
    for names, three_d, patch, _ in tile_groups(tag):
        x = seeded_tile(torch, patch)
        for name in names:
            net = zoo_network(name, three_d, "cpu")
            t0 = time.perf_counter()
            with torch.inference_mode():
                out[name] = (first_output(net(x)), time.perf_counter() - t0)
            del net
    return out


def tile_agreement(torch, tag: str, nets: dict):
    """Each network of zoo phase ``tag`` on one seeded tile, fp32 with TF32
    off, card (the kernels) against the CPU (the plain twins), on the
    seeded weights: the card's outputs now, the CPU's made by HostPrep
    (``cpu_tiles``, the side process in a whole run). Returns ``finish()``,
    which holds each network's first output within 1e-3 x max."""
    card = {}
    for names, _, patch, classes in tile_groups(tag):
        x = seeded_tile(torch, patch).cuda()
        for name in names:
            with torch.inference_mode():
                card[name] = (first_output(nets[name](x)).cpu(), patch, classes)
    torch.cuda.empty_cache()

    def finish():
        cpu = HOST_PREP.folder("tiles_" + tag)[1]
        for name, (gpu, patch, classes) in card.items():
            ref, cpu_s = cpu[name]
            if gpu.shape != (1, *patch, classes) or not torch.isfinite(gpu).all():
                fail(f"{name}: output {tuple(gpu.shape)}, "
                     f"finite={bool(torch.isfinite(gpu).all())}")
            check(f"{name} one {patch} tile fp32, card vs CPU ({cpu_s:.1f} s on the CPU)",
                  gpu, ref, TOL_MODEL)

    return finish


def mamba_serve(torch, card: str, name: str, net, patch=MAMBA_PATCH,
                classes: int = MAMBA_CLASSES, mirror=(0, 1), volume=MAMBA_VOLUME,
                n_volumes: int = MAMBA_VOLUMES, bf16_tol: float = TOL_SERVE_REL_L2,
                profiled: bool = True, fp32_own_batch: bool = False,
                warmup_volume=None) -> None:
    """VolumePredictor on ``n_volumes`` volumes of ``volume`` after one
    warm-up (of ``warmup_volume``'s shape where given): tile ``patch``, step
    0.5, Gaussian, ``mirror``, bf16 compute and transfer, automatic tile
    batch; the warm-up volume with the kernels against every wrapper on its
    plain twin, in bf16 and in fp32 at the chosen batch (``fp32_own_batch``:
    at the fp32 budget's own, where the bf16 batch does not fit in fp32),
    and bf16 against fp32 serving (``bf16_tol``); K1's launches per volume
    in the timed window, and no other kernel; with ``profiled`` the device
    busy share of one more volume."""
    from mlagg_unet_torch import VolumePredictor
    from mlagg_unet_torch.ops import _ext

    gc.collect()
    torch.cuda.empty_cache()   # the last network's blocks
    t_all = time.perf_counter()
    rng = np.random.RandomState(6)
    volumes = [rng.rand(*shape).astype(np.float32)
               for shape in [warmup_volume or volume] + [volume] * n_volumes]
    pred = VolumePredictor(net, patch, classes, mirror, None,
                           compute_dtype=torch.bfloat16, transfer_dtype=torch.bfloat16,
                           device="cuda")
    t0 = time.perf_counter()
    first = pred(volumes[0])   # warm-up: the budget probe and the autotune
    warm_s = time.perf_counter() - t0
    ms = {t: round(v, 4) for t, v in next(iter(pred.autotune_ms.values()), {}).items()}
    with plain_twins(_ext):
        twins16 = pred(volumes[0])
    d16 = float(np.linalg.norm(first - twins16) / np.linalg.norm(twins16))
    pred32 = VolumePredictor(net, patch, classes, mirror,
                             None if fp32_own_batch else pred.last_tile_batch, device="cuda")
    ref32 = pred32(volumes[0])
    tb32 = pred32.last_tile_batch
    d = float(np.linalg.norm(first - ref32) / np.linalg.norm(ref32))
    with plain_twins(_ext):
        twins = pred32(volumes[0])
    dk, peak32 = float(np.abs(ref32 - twins).max()), float(np.abs(twins).max())
    del pred32, ref32, twins, twins16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    outs, elapsed, _ = serve_window(pred, volumes[1:])
    ran = {k.name: k.launches for k in _ext.ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tb = pred.last_tile_batch
    for o in outs:
        if o.shape != (classes, *volume[1:]) or not np.isfinite(o).all():
            fail(f"{name} serve output {o.shape}, finite={bool(np.isfinite(o).all())}")
    warm = f" of {'x'.join(map(str, warmup_volume))}" if warmup_volume else ""
    log(f"  {name}: {n_volumes} volumes of {'x'.join(map(str, volume))} after 1 "
        f"warm-up{warm} ({warm_s:.1f} s with the probe and the autotune), step 0.5, mirror "
        f"{mirror}, "
        f"bf16: {n_volumes / elapsed:.4f} volumes/s ({elapsed:.3f} s), tile batch {tb} "
        f"(model batch {2 ** len(mirror) * tb}), ms per tile of each candidate {ms}, peak "
        f"memory {peak:.2f} GiB, K1 launches per volume "
        f"{ran['selective_scan_fwd'] / n_volumes:g}; the warm-up volume, kernels vs every "
        f"wrapper on its plain twin: bf16 rel L2 {d16:.3e} (tol {TOL_SERVE_REL_L2:g}), fp32 at "
        f"tile batch {tb32} max|diff| {dk:.3e} of max {peak32:.3e} (tol {TOL_MODEL:g} x max); bf16 vs "
        f"fp32 serving: rel L2 {d:.3e} (tol {bf16_tol:g}); {time.perf_counter() - t_all:.1f} s "
        f"in all | {card}")
    if not (dk <= TOL_MODEL * peak32 and d16 <= TOL_SERVE_REL_L2):
        fail(f"{name}: serving with the kernels disagrees with the plain twins: fp32 "
             f"{dk:.3e}, bf16 rel L2 {d16:.3e}")
    if not d <= bf16_tol:
        fail(f"{name}: bf16 serving disagrees with fp32 serving: rel L2 {d:.3e}")
    others = {k: v for k, v in ran.items() if v and k != "selective_scan_fwd"}
    if ran["selective_scan_fwd"] <= 0 or others:
        fail(f"{name} serving launched K1 {ran['selective_scan_fwd']} times and {others}")
    if not profiled:
        del pred, outs
        return
    stats = {}
    profile(torch, f"one {name} volume", lambda: pred(volumes[1]), stats)
    log(f"  {name}: device busy "
        + (f"{100 * stats['busy_ms'] / stats['wall_ms']:.1f} %" if stats else "not measured")
        + f" of one profiled volume | {card}")
    del pred, outs


def hold_mamba_grads(torch, label: str, kernels, twins, reordered, ref, card: str,
                     norm_fed: str = None) -> bool:
    """The loss with the kernels against the plain twins' (TOL_TRAIN_LOSS);
    the whole gradient with the kernels against the reference (the network
    and the scans in fp64): its rel L2 within TOL_TRAIN_GRAD, or
    MAMBA_GRAD_TWIN_FACTOR times the twins'; each gradient within
    MAMBA_GRAD_LEAF_TOL x max|ref| + 1e-6 of it, or MAMBA_GRAD_TWIN_FACTOR
    times the twins' distance; a bias matching ``norm_fed`` (a conv's that
    a norm follows) within NORM_FED_TOL x max|its kernel's reference| + 1e-6,
    if its reference is rounding (NORM_FED_FP64). Reported beside them: how
    many gradients lie within TOL_TRAIN_GRAD x max + 1e-6 of the reference,
    and the largest distance with the kernels, and with ``reordered`` (the
    twins' scans summed in chunks of half their size), against twice the
    twins'. Logs,
    and returns whether the gated part held."""
    (l_k, g_k), (l_t, g_t), (_, g_o), (_, g_r) = kernels, twins, reordered, ref
    d = abs(l_k - l_t) / abs(l_t)
    f = MAMBA_GRAD_TWIN_FACTOR
    rows, moved, sq, fed = [], [], np.zeros(3), []
    for k, r in g_r.items():
        if not torch.isfinite(g_k[k]).all():
            fail(f"gradient {k} not finite ({label})")
        top = r.abs().max().item()
        bound = TOL_TRAIN_GRAD * top + 1e-6
        e_k, e_t, e_o = ((g[k] - r).abs().max().item() for g in (g_k, g_t, g_o))
        leaf = max(MAMBA_GRAD_LEAF_TOL * top + 1e-6, f * e_t)
        if norm_fed and re.search(norm_fed, k):
            k_top = g_r[k[:-len("bias")] + "weight"].abs().max().item()
            leaf = NORM_FED_TOL * k_top + 1e-6
            fed.append((top / k_top, e_k / k_top, e_t / k_top, k))
            if top > NORM_FED_FP64 * k_top:   # a real gradient: held as any other leaf
                leaf = max(MAMBA_GRAD_LEAF_TOL * top + 1e-6, f * e_t)
        rows.append((e_k / leaf, k, e_k / bound, e_t / bound, e_k / max(bound, f * e_t)))
        moved.append(e_o / max(bound, f * e_t))
        sq += [(g[k].double() - r.double()).pow(2).sum().item() for g in (g_k, g_t)] + [
            r.double().pow(2).sum().item()]
    r_k, r_t = (math.sqrt(v / sq[2]) for v in sq[:2])
    rows.sort(reverse=True)
    if fed:
        real = [k for q, _, _, k in fed if q > NORM_FED_FP64]
        log(f"  {label}: {len(fed)} conv biases a norm follows: max|gradient| / max|its kernel's "
            f"gradient| in fp64 up to {max(q for q, *_ in fed):.3e} (rounding at most "
            f"{NORM_FED_FP64:g}; above it: {real or 'none'}); max|diff| to fp64 / that max: "
            f"kernels up to {max(e for _, e, _, _ in fed):.3e}, twins up to "
            f"{max(t for _, _, t, _ in fed):.3e} (tol {NORM_FED_TOL:g}); "
            f"{max(fed)[3]}: fp64 {max(fed)[0]:.3e}")
    log(f"  {label}: loss kernels vs twins {l_k:.9f} vs {l_t:.9f}: rel {d:.3e} (tol "
        f"{TOL_TRAIN_LOSS:g}); the whole gradient's rel L2 to the fp64 reference: kernels "
        f"{r_k:.3e}, twins {r_t:.3e} (limit {max(TOL_TRAIN_GRAD, f * r_t):.3e}); each gradient "
        f"within max({MAMBA_GRAD_LEAF_TOL:g} x max + 1e-6, {f:g} x the twins' distance) of it: "
        "the closest " + ", ".join(
            f"{k} {q:.3f} of that ({e:.2f} / {t:.2f} x {TOL_TRAIN_GRAD:g} x max, kernels / "
            "twins)" for q, k, e, t, _ in rows[:3])
        + f"; within {TOL_TRAIN_GRAD:g} x max + 1e-6: {sum(e <= 1 for _, _, e, _, _ in rows)} "
        f"of {len(rows)} with the kernels, {sum(t <= 1 for _, _, _, t, _ in rows)} with the "
        f"twins; beyond max(that, {f:g} x the twins' distance) (not gated): "
        f"{sum(x > 1 for *_, x in rows)} with the kernels (largest {max(x for *_, x in rows):.3f}), "
        f"{sum(m > 1 for m in moved)} with the twins summed in half-size chunks (largest "
        f"{max(moved):.3f}) | {card}")
    return d <= TOL_TRAIN_LOSS and rows[0][0] <= 1.0 and r_k <= max(TOL_TRAIN_GRAD, f * r_t)


def scan_calls_vs_fp64(torch, label: str, trainer, net, x, y) -> tuple:
    """ROADMAP C2's per-call gate: the kernels' fp32 pass of the batch
    again, keeping each K5 call's operands; at each call K1's y and K5's
    gradients against the plain twin in fp64, beside the fp32 twin's
    distance to it (distances over max|fp64|). A call is refused where K1 or
    K5 lies beyond max(SCAN_CALL_TWIN_FACTOR x the fp32 twin's distance,
    SCAN_CALL_FLOOR), or beyond phase 3's tolerances of the fp32 twin.
    Returns the kept calls, the index of the one where K1 or K5 stands
    furthest out against the fp32 twin, and the refused (call, output,
    distance, twin's distance)."""
    from mlagg_unet_torch.ops.selective_scan import selective_scan_bwd_plain
    from mlagg_unet_torch.ops.selective_scan_cuda import (
        scan_fwd_plain, selective_scan_bwd, selective_scan_fwd_states)

    def dist(got, ref):
        return ((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()

    kept, names = [], ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias")
    t0 = time.perf_counter()
    with keeping_scan_bwd_calls(kept):
        train_grads(trainer, net, x, y)
    worst, refused, top = (-1.0, 0), [], (0.0, 0.0)
    with torch.no_grad():
        for i, (args, kwargs) in enumerate(kept):
            ops, gy = args[:9], args[9] if len(args) > 9 else kwargs["gy"]
            y32, states = selective_scan_fwd_states(*ops)
            y_plain = scan_fwd_plain(*ops)
            y64 = scan_fp64(*ops)
            rows = {"y": (dist(y32, y64), dist(y_plain, y64))}
            near = {"y": rel_err(y32, y_plain)[1] <= TOL_SCAN}
            del y32, y64, y_plain
            got = selective_scan_bwd(*ops, gy, states)
            twin = selective_scan_bwd_plain(*ops, gy.float())
            ref = selective_scan_bwd_plain(*(t.double() if torch.is_tensor(t) else t
                                             for t in ops), gy.double())
            tol = TOL_SCAN_GRAD if ops[0].dtype == torch.float32 else TOL_SCAN_GRAD_BF16
            for nm, a, t, r in zip(names, got, twin, ref):
                if a is not None:
                    rows[nm] = (dist(a, r), dist(t, r))
                    near[nm] = rel_err(a, t)[1] <= tol
            del got, twin, ref, states
            for nm, (k, t) in rows.items():
                top = max(top[0], k / max(t, 1e-12)), max(top[1], k)
                if not (k <= max(SCAN_CALL_TWIN_FACTOR * t, SCAN_CALL_FLOOR) and near[nm]):
                    refused.append((i, nm, k, t))
            ratio, nm = max((k / max(t, 1e-12), nm) for nm, (k, t) in rows.items())
            log(f"    call {i} {tuple(ops[0].shape)} n={ops[2].shape[-1]} reverse={ops[8]}: "
                + ", ".join(f"{nm} {k:.2e} / {t:.2e}" for nm, (k, t) in rows.items())
                + f"; furthest out: {nm} at {ratio:.2f}x the twin's")
            worst = max(worst, (ratio, i))
    log(f"  {label}: its {len(kept)} K5 calls on the network's operands against the plain twin "
        "in fp64 (distance / max|fp64|, K1 or K5 / the fp32 twin, above): furthest out at call "
        f"{worst[1]}, {worst[0]:.2f}x the fp32 twin's distance; the largest distance {top[1]:.2e}; "
        f"each within max({SCAN_CALL_TWIN_FACTOR:g} x the twin's, {SCAN_CALL_FLOOR:g}) and phase "
        f"3's tolerances of the fp32 twin: {len(refused)} refused "
        f"{[(i, nm, f'{k:.2e}', f'{t:.2e}') for i, nm, k, t in refused[:4]]}; "
        f"{time.perf_counter() - t0:.1f} s")
    return kept, worst[1], refused


def scan_calls_gate(torch, label: str, trainer, net, x, y) -> None:
    """``scan_calls_vs_fp64`` on a network's trained weights and a batch;
    a refused call keeps its case for replay (``keep_grad_fault``) and
    fails."""
    kept, worst, refused = scan_calls_vs_fp64(torch, label, trainer, net, x, y)
    if refused:
        keep_grad_fault(torch, label, net, x, y, kept, refused[0][0])
        fail(f"{label}: K1/K5 calls on its trained weights beyond their limits: {refused}")
    del kept


def keep_grad_fault(torch, label: str, net, x, y, kept: list, worst: int) -> None:
    """After a gradient gate refused the kernels, the case kept for replay:
    the network's weights in GRAD_FAULT_DIR/<label>_weights.pt; the batch,
    and the operands and output gradient of scan call ``worst`` (of
    ``scan_calls_vs_fp64``'s kept calls), in <label>_case.pt."""
    def cpu(t):
        return t.detach().cpu() if torch.is_tensor(t) else t

    GRAD_FAULT_DIR.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"\W+", "_", label)
    torch.save({k: cpu(v) for k, v in net.state_dict().items()},
               GRAD_FAULT_DIR / f"{tag}_weights.pt")
    args, kwargs = kept[worst]
    torch.save({"x": cpu(x), "y": cpu(y), "call": worst,
                "scan_operands": [cpu(t) for t in args[:9]],
                "gy": cpu(args[9] if len(args) > 9 else kwargs["gy"])},
               GRAD_FAULT_DIR / f"{tag}_case.pt")
    log(f"  {label}: the refused case kept in {GRAD_FAULT_DIR} for replay")


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """While active, cuDNN takes deterministic algorithms only (a conv's
    weight gradient may otherwise sum its parts in an order that differs
    from run to run)."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


def seeded_blobs(torch, batch: int, patch, seed: int, device: str = "cuda"):
    """A seeded (batch, *patch, 1) image of smooth blobs, unit std, and its
    label on ``device``: in 2-D four classes (TRAIN_VERB_THRESHOLDS), in 3-D
    three (``blobs_3d``)."""
    if len(patch) == 3:
        x, y = blobs_3d(torch, (batch, *patch), seed)
        return x.to(device), y.to(device)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 1, *patch, generator=g)
    for _ in range(3):  # smooth: blobs a few pixels wide
        x = torch.nn.functional.avg_pool2d(x, 9, stride=1, padding=4, count_include_pad=False)
    x = ((x - x.mean()) / x.std()).permute(0, 2, 3, 1).contiguous()
    y = torch.bucketize(x[..., 0], torch.tensor(TRAIN_VERB_THRESHOLDS))
    return x.to(device), y.to(device)


def drop_path_off(net) -> None:
    """Every stochastic-depth layer of ``net`` at rate 0 (the identity)."""
    from mlagg_unet_torch.models.layers import DropPath

    for m in net.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0


def seeded_grad_gate(torch, card: str, label: str, trainer: str, cm, classes: int,
                     batch_dice: bool = False, fp64_around: bool = False) -> None:
    """ROADMAP C2's network-level gate, on the same weights and batch in every
    run: the trainer's network as it builds it from ``cm`` (seed 0; drop
    path off), a seeded batch of blobs at the configuration's patch and
    batch (GATE_SEED), cuDNN deterministic. The reference is the network in
    fp64 with the plain scans in fp64; the loss and gradients of the fp32
    network with the kernels, with the plain twins and with the twins in
    half-size chunks are held to it (``hold_mamba_grads``). With
    ``fp64_around`` the same first with the network in fp64 around the fp32
    scans, and K1 / K5 on that pass's own operands against their twins. The
    trainer's conv biases that a norm follows (NORM_FED_BIASES) are held to
    their kernel's gradient scale. A refused gate keeps its case
    (``keep_grad_fault``) and fails."""
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    tr = Trainer(trainer, batch_size=cm.batch_size, num_input_channels=1, num_classes=classes,
                 batch_dice=batch_dice, seed=0, device="cuda", compute_dtype=torch.float32,
                 configuration_manager=cm)
    drop_path_off(tr.network)
    x, y = seeded_blobs(torch, cm.batch_size, cm.patch_size, GATE_SEED)
    held = []
    with deterministic_cudnn(torch):
        net = tr.network.to(torch.float64)
        with plain_twins(_ext), fp64_plain_scans():
            ref = train_grads(tr, net, x.double(), y)
        for dtype in ((torch.float64,) if fp64_around else ()) + (torch.float32,):
            net, k5_calls = tr.network.to(dtype), []
            _ext.reset_launch_counts()
            with keeping_scan_bwd_calls(k5_calls if dtype == torch.float64 else []):
                kernels = train_grads(tr, net, x.to(dtype), y)
            if k5_calls:   # K1 / K5 on this pass's own operands, then let go
                scan_calls_vs_twins(torch, k5_calls)
                k5_calls.clear()
            ran = {k.name: k.launches for k in _ext.ALL_KERNELS}
            _ext.reset_launch_counts()
            with plain_twins(_ext):
                twins = train_grads(tr, net, x.to(dtype), y)
                with plain_scan_half_chunks():
                    reordered = train_grads(tr, net, x.to(dtype), y)
            if any(k.launches for k in _ext.ALL_KERNELS) or any(ran[k] <= 0 for k in MAMBA_KERNELS):
                fail(f"{label}'s gated batch ran {ran} with the kernels, or the plain run "
                     "launched one")
            where = "fp64 around the scans" if dtype == torch.float64 else "fp32"
            held.append(hold_mamba_grads(torch, f"{label}, seeded weights, {where}", kernels,
                                         twins, reordered, ref, card,
                                         NORM_FED_BIASES.get(trainer)))
        log(f"  {label}: the gate's seeded batch {tuple(x.shape)} at the network's seeded "
            f"initial weights ({ran['selective_scan_fwd']} K1, {ran['selective_scan_bwd']} K5 "
            f"launches with the kernels), {time.perf_counter() - t0:.1f} s with the reference "
            f"in fp64: {'held' if all(held) else 'REFUSED'}")
        if not all(held):
            net = tr.network.to(torch.float32)
            kept, worst, _ = scan_calls_vs_fp64(torch, label, tr, net, x, y)
            keep_grad_fault(torch, label, net, x, y, kept, worst)
            fail(f"{label}'s loss or gradients with the kernels beyond their limits (above)")
    tr.network.zero_grad(set_to_none=True)
    del tr, net, ref, kernels, twins, reordered
    gc.collect()
    torch.cuda.empty_cache()


def train_verb_2d(torch, card: str, tmp: Path, trainer: str, recipe: str, label: str,
                  steps: int, cached_steps: int, test_cases: int, profiled: bool = False,
                  fp64_around: bool = False, gate_batch: int = MAMBA_BATCH) -> None:
    """``trainer`` through the train verb on the train verb's 10 cases with
    phase 11's 2d plan (``tmp``: a copy of HOST_PREP's "mamba" folder), cut
    to 1 epoch of ``steps`` steps and MAMBA_VAL_STEPS
    validation steps on fold 0: launches; the network-level gradient gate on
    the network's seeded weights (``seeded_grad_gate``) and the per-call gate
    on the verb's final weights and first training batch
    (``scan_calls_gate``); ms per step with the loader and on one cached
    batch (with ``profiled``, a profile of one step); then the predict verb
    on its folder for ``test_cases`` cases. The gates run at ``gate_batch``
    (the seeded batch's size; the first of the verb's batch)."""
    from dataclasses import replace

    from mlagg_unet_torch.cli.entrypoints import predict_from_modelfolder_entry, train_entry
    from mlagg_unet_torch.imageio.nifti_io import NiftiIO
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training import registry
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.training.trainer import DeviceFeeder, NNUNetTrainer, Trainer
    from mlagg_unet_torch.utils.helpers import load_json
    from mlagg_unet_torch.weights import jax_tree_to_state_dict

    registry.register_trainer(replace(
        registry.get_trainer_config(trainer), name=recipe, num_epochs=1,
        num_iterations_per_epoch=steps, num_val_iterations_per_epoch=MAMBA_VAL_STEPS))
    base = tmp / "results" / MAMBA_DATASET / f"{recipe}__nnUNetPlans__2d"
    first, times = {}, []
    train_c, val_c, final_c = {}, {}, {}
    with recording_first_batches(first), \
            attribute_launches(_ext, Trainer, "train_step", train_c, times), \
            attribute_launches(_ext, Trainer, "val_step", val_c), \
            attribute_launches(_ext, NNUNetTrainer, "perform_actual_validation", final_c):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _ext.reset_launch_counts()
        t0 = time.perf_counter()
        train_entry([MAMBA_ID, "2d", "0", "-tr", recipe, "-device", "cuda"])
        verb_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    ck = load_checkpoint(str(base / "fold_0" / "checkpoint_final.ckpt"))
    lg = ck["logging"]
    gaps = [1e3 * (b[0] - a[0]) for a, b in zip(times[1:], times[2:])]
    step_ms = statistics.median(gaps)
    summary = load_json(str(base / "fold_0" / "validation" / "summary.json"))
    log(f"  verb train {MAMBA_ID} 2d 0 -tr {recipe}: {verb_s:.1f} s (1 epoch of "
        f"{steps} steps at batch {MAMBA_BATCH} of {MAMBA_PATCH} + {MAMBA_VAL_STEPS} "
        f"validation steps, the final validation of {len(summary['metric_per_case'])} cases), "
        f"peak memory {peak:.2f} GiB; loss train {lg['train_losses']}, validation "
        f"{lg['val_losses']}, pseudo dice {lg['mean_fg_dice']}; foreground Dice "
        f"{summary['foreground_mean']['Dice']:.4f} | {card}")
    log(f"  launches in the training steps {train_c}, the validation steps {val_c}, the final "
        f"validation {final_c}")
    if len(times) != steps or not all(math.isfinite(v) for v in
                                      lg["train_losses"] + lg["val_losses"]):
        fail(f"the {label} verb ran {len(times)} steps, losses {lg['train_losses']} "
             f"{lg['val_losses']}")
    for counts, where, want in ((train_c, "training steps", MAMBA_KERNELS),
                                (val_c, "validation steps", ("selective_scan_fwd",)),
                                (final_c, "final validation", ("selective_scan_fwd",))):
        bad = {k: v for k, v in counts.items() if v and k not in want}
        if bad or any(counts.get(k, 0) <= 0 for k in want):
            fail(f"the {label} verb's {where} launched {counts} (want {want} only)")
    if any(v for k, v in launches.items() if k not in MAMBA_KERNELS):
        fail(f"the {label} verb run launched {launches}")

    # the gradient gates (ROADMAP C2): the network's on its seeded weights,
    # each scan call's on the verb's final weights and first training batch
    gate_cm = mamba_configuration(gate_batch)
    seeded_grad_gate(torch, card, label, recipe, gate_cm, MAMBA_CLASSES, batch_dice=True,
                     fp64_around=fp64_around)
    tr = Trainer(recipe, batch_size=gate_batch, num_input_channels=1,
                 num_classes=MAMBA_CLASSES, batch_dice=True, seed=0, device="cuda",
                 compute_dtype=torch.float32, configuration_manager=gate_cm)
    tr.network.load_state_dict(jax_tree_to_state_dict(ck["network_weights"]), strict=True)
    drop_path_off(tr.network)
    x, y = (t[:gate_batch] for t in DeviceFeeder(torch.device("cuda")).batch(first["train"]))
    scan_calls_gate(torch, f"{label} (the verb's final weights)", tr, tr.network, x, y)
    tr.network.zero_grad(set_to_none=True)
    del tr, x, y
    gc.collect()
    torch.cuda.empty_cache()

    # ms per step: the verb's with the loader, and one cached batch
    plans, dataset = (load_json(str(tmp / "preprocessed" / MAMBA_DATASET / f))
                      for f in ("nnUNetPlans.json", "dataset.json"))
    vt = NNUNetTrainer(plans, "2d", 0, dataset, trainer_name=recipe, device="cuda")
    vt.initialize()
    xb, yb = vt.feed.batch(first["train"])
    vt.step.run_steps([(xb, yb)] * 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vt.step.run_steps([(xb, yb)] * cached_steps)
    cached = (time.perf_counter() - t0) / cached_steps * 1e3
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = {}
    if profiled:
        profile(torch, f"one cached {label} step", lambda: vt.step.run_steps([(xb, yb)]), stats)
    log(f"  ms per step (bf16, batch {MAMBA_BATCH} of {MAMBA_PATCH}): {step_ms:.2f} with the "
        f"loader (median of the verb's steps 2-{steps}), {cached:.2f} on its first batch "
        f"cached on the card, peak memory of the cached steps {step_peak:.2f} GiB"
        + (f" (device busy {stats['busy_ms']:.1f} ms of one profiled step)" if stats else "")
        + f"; {MAMBA_BATCH * 1e3 / step_ms:.3f} images/s; "
        f"{len(multiprocessing.active_children())} child processes alive | {card}")
    del vt, xb, yb
    gc.collect()
    torch.cuda.empty_cache()

    cases = tmp / "verb_imagesTs"
    cases.mkdir()
    for i in range(test_cases):
        shutil.copyfile(tmp / "raw" / MAMBA_DATASET / "imagesTr" / f"case_{i:03d}_0000.nii.gz",
                        cases / f"case_{i:03d}_0000.nii.gz")
    out = tmp / "verb_predicted"
    t0 = time.perf_counter()
    _ext.reset_launch_counts()
    predict_from_modelfolder_entry(["-i", str(cases), "-o", str(out), "-m", str(base), "-f", "0",
                                    "-device", "cuda"])
    ran = {k.name: k.launches for k in _ext.ALL_KERNELS if k.launches}
    for i in range(test_cases):
        seg, _ = NiftiIO().read_seg(str(out / f"case_{i:03d}.nii.gz"))
        labels = np.unique(seg)
        if seg.shape != (1, 10, 320, 260) or not set(labels) <= set(range(MAMBA_CLASSES)):
            fail(f"predict verb on the {label} folder, case {i}: {seg.shape}, labels {labels}")
    if set(ran) != {"selective_scan_fwd"}:
        fail(f"the predict verb on the {label} folder launched {ran}")
    log(f"  predict verb on the {label} folder: {test_cases} case(s) in "
        f"{time.perf_counter() - t0:.1f} s, shape (1, 10, 320, 260), labels {labels.tolist()}, "
        f"launches {ran} | {card}")


def zoo_phase(torch, card: str, tag: str, steps, held: set = None, *args,
              kernels=MAMBA_KERNELS) -> None:
    """``steps(torch, card, held, *args)``, one phase of the model zoo
    (``held``: the scan shapes earlier phases of this run held, to which it
    adds its own), with the port kernels' launches summed over the resets
    its checks make: only ``kernels`` (K1 and K5) may be launched, and each
    must be."""
    from mlagg_unet_torch.ops import _ext

    t_phase = time.perf_counter()
    _ext.reset_launch_counts()
    total = {}
    reset = _ext.reset_launch_counts

    def reset_keeping_total():   # the checks reset the counts: keep the phase's sum
        for k in _ext.ALL_KERNELS:
            total[k.name] = total.get(k.name, 0) + k.launches
        reset()

    _ext.reset_launch_counts = reset_keeping_total
    try:
        steps(torch, card, set() if held is None else held, *args)
    finally:
        _ext.reset_launch_counts = reset
    reset_keeping_total()
    launched = {k: v for k, v in total.items() if v}
    if set(launched) != set(kernels):
        fail(f"the {tag} phase launched {launched} (want {list(kernels) or 'none'})")
    log(f"  launches of the port's kernels in the phase: {launched} | {card}")
    log(f"[{tag}] phase done in {time.perf_counter() - t_phase:.1f} s")


def phase_mamba(torch, card: str, held: set = None) -> None:
    """Phase 11: the Mamba zoo's first family on the card."""
    zoo_phase(torch, card, "mamba", mamba_phase_steps, held)


def mamba_phase_steps(torch, card: str, held: set) -> None:
    """Phase 11's steps (a), (b) and (c)."""
    log(f"[mamba] the six networks at full width on the {MAMBA_PATCH} plan")
    nets = zoo_networks(torch, MAMBA_TRAINERS, ())
    tiles = tile_agreement(torch, "mamba", nets)
    log("[mamba] (a) K1 and K5 at every shape one forward and backward of each network emits")
    mamba_scan_checks(torch, card, mamba_scan_shapes(torch, nets), held)
    torch.cuda.empty_cache()
    log(f"[mamba] (b) one tile, fp32, card vs CPU (the U-Mambas on {MAMBA_PATCH}: their "
        f"channel-token stages norm over the plan's tokens; the others on {ZOO_CPU_TILE_2D}: "
        "cut for the CPU)")
    tiles()
    log(f"[mamba] (b) serve | {card}")
    for name in MAMBA_SERVED:
        mamba_serve(torch, card, name, nets[name])
    del nets
    torch.cuda.empty_cache()
    log(f"[mamba] (c) the train verb: nnUNetTrainerUMambaEnc | {card}")
    with verb_paths("chip_smoke_mamba_", HOST_PREP.folder("mamba")[0]) as tmp:
        train_verb_2d(torch, card, tmp, "nnUNetTrainerUMambaEnc", MAMBA_RECIPE, "U-Mamba Enc",
                      MAMBA_STEPS, MAMBA_CACHED_STEPS, 1, profiled=True, fp64_around=True,
                      gate_batch=GATE_BATCH_2D)


@contextlib.contextmanager
def paths_at(root: Path):
    """While active, the verbs' raw, preprocessed and results folders lie
    under ``root``."""
    from mlagg_unet_torch import paths

    saved = (paths.nnUNet_raw, paths.nnUNet_preprocessed, paths.nnUNet_results)
    paths.nnUNet_raw, paths.nnUNet_preprocessed, paths.nnUNet_results = (
        str(root / "raw"), str(root / "preprocessed"), str(root / "results"))
    try:
        yield root
    finally:
        paths.nnUNet_raw, paths.nnUNet_preprocessed, paths.nnUNet_results = saved


@contextlib.contextmanager
def verb_paths(prefix: str, prepared: Path = None):
    """While active, the verbs' raw, preprocessed and results folders lie in
    a fresh temporary directory, which it yields; with ``prepared`` (a
    ``HostPrep`` folder) a copy of it in there first."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
        tmp = Path(tmp)
        if prepared is not None:
            shutil.copytree(prepared, tmp, dirs_exist_ok=True)
        with paths_at(tmp):
            yield tmp


# ---------------------------------------------------------------- host-bound preparation
def prepare_part(part: str, root: Path, card: str, workers: int, threads: int):
    """One of PREP_PARTS under ``root``: phase 8's dataset ("train"), phase
    11's ("mamba": phases 11, 14 and 15 copy it), phase 9's raw dataset and
    preprocessing ("pipeline"), phase 10's ("unet3d"); or the CPU side of a
    card-vs-CPU check, on the seeded networks and inputs the card takes:
    phase 7's gradients ("flagship_grads"), phase 10's tile and gradients
    ("unet3d_refs"), each zoo phase's tiles ("tiles_<phase>"), phase 15's
    fp64 gradients ("mlla_unet_grads"). Returns what the phase reads of it
    besides the folder."""
    import torch

    refs = {"flagship_grads": flagship_cpu_grads, "unet3d_refs": unet3d_cpu_refs,
            "mlla_unet_grads": lambda torch: mlla_unet_grads(torch, "cpu")}
    if part in refs:
        return refs[part](torch)
    if part.startswith("tiles_"):
        return cpu_tiles(torch, part[len("tiles_"):])
    t0 = time.perf_counter()
    if part in ("train", "mamba"):
        write_train_dataset(root, *((MAMBA_DATASET, MAMBA_PLANS) if part == "mamba" else ()),
                            threads=threads)
        log(f"  {TRAIN_VERB_CASES} cases of 1x10x320x260 written and preprocessed "
            f"({'phase 11' if part == 'mamba' else 'the predict phase'}'s 2d plan) in "
            f"{time.perf_counter() - t0:.1f} s")
        return {}
    if part == "pipeline":
        return prepare_pipeline(root, card, workers, threads)
    if part == "unet3d":
        return prepare_unet3d(root, workers, threads)
    raise ValueError(f"no such part: {part}")


def _prep_main(root: str, repo: str, card: str, parts, out) -> None:
    """The side process of ``HostPrep``: each part made in turn, its result
    saved beside its folder (``root/<part>.pt``: tensors by value, not
    through shared memory), then its log lines and seconds put on ``out``;
    a failure put there too."""
    global LOG_SINK
    import traceback

    sys.path.insert(0, repo)
    # the native resampler's threads, here and in the workers
    os.environ["OMP_NUM_THREADS"] = str(PREP_THREADS)
    import torch

    torch.set_num_threads(PREP_THREADS)
    t_start = time.perf_counter()
    for part in parts:
        LOG_SINK = []
        t0 = time.perf_counter()
        try:
            info = prepare_part(part, Path(root) / part, card, PREP_WORKERS, PREP_THREADS)
        except SystemExit:   # fail() printed its line
            out.put({"part": part, "error": "its FAIL line above", "log": LOG_SINK})
            raise
        except Exception:
            out.put({"part": part, "error": traceback.format_exc(), "log": LOG_SINK})
            raise
        torch.save(info, Path(root) / f"{part}.pt")
        out.put({"part": part, "log": LOG_SINK, "seconds": time.perf_counter() - t0,
                 "at": time.perf_counter() - t_start})


class HostPrep:
    """The host-bound preparation of phases 8-11, 14 and 15 and the CPU
    sides of phases 7 and 10-15's card-vs-CPU checks (PREP_PARTS) under
    ``root``. With ``background``, a spawned process that cannot see the
    card (CUDA_VISIBLE_DEVICES empty: numpy, nibabel, the native resampler
    and the port's plain twins need none) makes the parts in order, beside
    the card's work (PREP_WORKERS workers of PREP_THREADS threads, so that
    the host-paced phases keep most of the cores); else each part is made in
    this process when first asked for. ``folder(part)`` waits for the part, prints its log
    lines (their seconds the side process's own, marked so) and returns its
    folder and result."""

    def __init__(self, root: Path, card: str, background: bool):
        self.root, self.card, self.ready, self.proc = root, card, {}, None
        if not background:
            return
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        old = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""   # the child's, read when it starts
        try:
            # not a daemon: its preprocessing spawns workers of its own
            self.proc = ctx.Process(target=_prep_main, args=(
                str(root), str(REPO), card, PREP_PARTS, self.queue))
            self.proc.start()
        finally:
            if old is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES")
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = old
        log(f"[prep] a side process (no card) makes {', '.join(PREP_PARTS)} beside the "
            f"phases, on {PREP_WORKERS} workers of {PREP_THREADS} threads")

    def folder(self, part: str):
        import queue

        import torch

        if part not in self.ready and self.proc is None:
            self.ready[part] = prepare_part(part, self.root / part, self.card, 8, 8)
        elif part not in self.ready:
            t0 = time.perf_counter()
            while part not in self.ready:
                try:
                    msg = self.queue.get(timeout=5)
                except queue.Empty:
                    if not self.proc.is_alive():
                        fail(f"the side process ended (exit code {self.proc.exitcode}) "
                             f"before it made {part}")
                    continue
                for line in msg["log"]:
                    log(f"{line} [side process]")
                if "error" in msg:
                    fail(f"the side process failed making {msg['part']}: {msg['error']}")
                log(f"[prep] {msg['part']} made in {msg['seconds']:.1f} s, "
                    f"{msg['at']:.1f} s after the side process started")
                self.ready[msg["part"]] = torch.load(self.root / f"{msg['part']}.pt",
                                                     weights_only=False)
            log(f"[prep] {part}: waited {time.perf_counter() - t0:.1f} s for it")
        return self.root / part, self.ready[part]

    def close(self, failed: bool = False) -> None:
        """Wait for the side process to end (it ends after its last part),
        or with ``failed`` stop it; its queue drained first, so that its
        feeder thread can finish."""
        import queue

        if self.proc is None:
            return
        if failed:
            self.proc.terminate()
        t0 = time.perf_counter()
        while self.proc.is_alive() and time.perf_counter() - t0 < 60:
            try:
                self.queue.get(timeout=1)
            except queue.Empty:
                pass
        self.proc.join(timeout=5)
        if self.proc.is_alive():
            self.proc.kill()
            fail("the side process did not end")


@contextlib.contextmanager
def no_autotune():
    """While active, ``VolumePredictor`` takes the memory budget's tile batch
    without timing candidates (``MLAGG_AUTOTUNE_TB=0``): its autotune times
    ~80 tiles, 75 s for U-Mamba Enc SS3D at ~0.95 s a 3-D tile."""
    old = os.environ.get("MLAGG_AUTOTUNE_TB")
    os.environ["MLAGG_AUTOTUNE_TB"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MLAGG_AUTOTUNE_TB")
        else:
            os.environ["MLAGG_AUTOTUNE_TB"] = old


def ss3d_configuration(batch: int = SS3D_BATCH):
    """Phase 10's 3-D plan (the bench topology at UNET3D_TILE) at ``batch``."""
    return unet3d_configuration(UNET3D_TILE, batch)


def zoo_network(name: str, three_d, device: str):
    """The trainer ``name``'s network at full width, seeded (0), fp32, on
    ``device``, as its trainer builds it: for phase 10's 3-D plan
    (SS3D_CLASSES) if ``name`` is in ``three_d``, else phase 11's 2d plan."""
    from mlagg_unet_torch.training.registry import get_network_builder, get_trainer_config

    cfg = get_trainer_config(name)
    return get_network_builder(cfg.network)(
        ss3d_configuration() if name in three_d else mamba_configuration(), 1,
        SS3D_CLASSES if name in three_d else MAMBA_CLASSES, cfg.enable_deep_supervision,
        seed=0, device=device)


def zoo_networks(torch, names, three_d) -> dict:
    """The named trainers' networks on the card (``zoo_network``)."""
    from mlagg_unet_torch.training.registry import get_trainer_config

    nets = {}
    for name in names:
        nets[name] = net = zoo_network(name, three_d, "cuda")
        log(f"  {name} ({get_trainer_config(name).network}): "
            f"{sum(p.numel() for p in net.parameters())} params, {type(net).__name__}")
    return nets


def zoo_scan_shapes(torch, nets: dict, three_d, g, calls: dict, per_model: dict,
                    train_mode: bool = False, batch_3d: int = SS3D_BATCH,
                    tile_3d=UNET3D_TILE) -> None:
    """Adds to ``calls`` every (b, g, d, L, n, dtype, reverse) at which one
    fp32 forward and backward of each network (3-D at ``batch_3d`` of
    ``tile_3d``, 2-D at MAMBA_BATCH of MAMBA_PATCH; in training mode, its
    stochastic depth drawing from a seeded generator, with ``train_mode``)
    calls K1 and K5, and to ``per_model`` each network's shapes under a
    label with its seconds and peak memory. Inputs from the generator
    ``g``."""
    drops = torch.Generator(device="cuda").manual_seed(0)
    for name, net in nets.items():
        x = torch.randn(batch_3d if name in three_d else MAMBA_BATCH,
                        *(tile_3d if name in three_d else MAMBA_PATCH), 1,
                        generator=g).cuda()
        seen = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net.train(train_mode)
        with recording_scan_calls(seen):
            outs = net(x, drops)
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            sum(o.float().square().mean() for o in outs).backward()
            del outs
        net.eval()
        torch.cuda.synchronize()
        net.zero_grad(set_to_none=True)
        per_model[f"{name} (fp32 forward and backward at batch {x.shape[0]}"
                  + (", training mode" if train_mode else "")
                  + f", {time.perf_counter() - t0:.1f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)"] = sorted(seen)
        for k, v in seen.items():
            calls.setdefault(k, set()).update(v)
        del x
        torch.cuda.empty_cache()


def log_scan_shapes(per_model: dict) -> None:
    for name, keys in per_model.items():
        log(f"  {name}: K1/K5 at (b, g, d, L, n, dtype, reverse) " + ", ".join(map(str, keys)))


def ss3d_scan_shapes(torch, nets: dict) -> dict:
    """Every (b, g, d, L, n, dtype, reverse) at which one fp32 forward and
    backward of each network (3-D at batch SS3D_BATCH, MSVM-UNet at
    MAMBA_BATCH) and one bf16 forward of MSVM-UNet (its scan in the input
    dtype) call K1 and K5; each network's peak memory beside it."""
    calls, per_model = {}, {}
    g = torch.Generator().manual_seed(3)
    zoo_scan_shapes(torch, nets, SS3D_3D, g, calls, per_model)
    x = torch.randn(MAMBA_BATCH, *MAMBA_PATCH, 1, generator=g).to("cuda", torch.bfloat16)
    seen = {}
    with torch.no_grad(), recording_scan_calls(seen):
        copy.deepcopy(nets[MSVM_TRAINER]).to(torch.bfloat16)(x)
    per_model[f"{MSVM_TRAINER} (bf16 forward)"] = sorted(seen)
    for k, v in seen.items():
        calls.setdefault(k, set()).update(v)
    torch.cuda.empty_cache()
    log_scan_shapes(per_model)
    return calls


def ss3d_scan_checks(torch, card: str, calls: dict, held: set) -> None:
    """K1 and K5 against their plain twins at every recorded shape (phase
    3's tolerances); the shapes must include n = 1 at g = 12 and L =
    SS3D_LARGEST's, n = 16 at g = 12, a reverse and a bf16 scan, and every
    fp32 shape must have run both kernels. Then both timed at SS3D_LARGEST
    beside their plain twins (one run each) and their bound."""
    want = {"n = 1, g = 12, L = 1,048,576": lambda k: k[4] == 1 and k[1] == 12
            and k[3] == SS3D_LARGEST[3], "n = 16, g = 12": lambda k: k[4] == 16 and k[1] == 12,
            "reverse": lambda k: k[6], "bf16": lambda k: k[5] == "bfloat16"}
    missing = [w for w, f in want.items() if not any(f(k) for k in calls)]
    both = [k for k, v in calls.items() if k[5] == "float32" and v != {"K1", "K5"}]
    if missing or both:
        fail(f"phase 12's scans miss {missing}, or ran K1 or K5 only at {both}: {calls}")
    scan_shape_checks(torch, calls, held)
    scan_timing(torch, card, SS3D_LARGEST, "U-Mamba Enc SS3D stage 0, training batch",
                plain_reps=1)


def train_verb_3d(torch, card: str, tmp: Path, shared: Path, trainer: str, recipe: str,
                  label: str) -> None:
    """``trainer`` (a 3-D Mamba recipe) through the train verb on phase 10's 3-D
    cases (``shared``: phase 10's preprocessed folder and raw test cases;
    else written and preprocessed here), trained on phase 10's 3-D plan at
    batch SS3D_BATCH, cut to 1 epoch of SS3D_STEPS steps and SS3D_VAL_STEPS
    validation steps on fold 0: launches; the gradient gates at batch
    SS3D_GRAD_BATCH of UNET3D_GRAD_PATCH, the network's on its seeded weights
    (``seeded_grad_gate``) and each scan call's on the verb's final weights
    and the centre of the first training batch's first case
    (``scan_calls_gate``); ms per step with the loader and on one cached
    batch; the predict verb on the test cases."""
    from dataclasses import replace

    from mlagg_unet_torch.cli import entrypoints as cli
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training import registry
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.training.trainer import NNUNetTrainer, Trainer
    from mlagg_unet_torch.utils.helpers import load_json, save_json
    from mlagg_unet_torch.weights import jax_tree_to_state_dict

    t0 = time.perf_counter()
    if shared is None:
        raw = write_unet3d_raw(tmp)
        cli.plan_and_preprocess_entry(["-d", UNET3D_ID, "-c", "3d_fullres"])
    else:
        raw = tmp / "raw" / UNET3D_DATASET
        shutil.copytree(shared / "raw", raw)
        shutil.copytree(shared / "preprocessed", tmp / "preprocessed" / UNET3D_DATASET)
    pre = tmp / "preprocessed" / UNET3D_DATASET
    plans = load_json(str(pre / "nnUNetPlans.json"))
    cfg = plans["configurations"]["3d_fullres"]
    planned = (cfg["patch_size"], cfg["batch_size"])
    cfg.update(ss3d_configuration().configuration)
    save_json(plans, str(pre / "nnUNetPlans.json"), sort_keys=False)
    log(f"  {UNET3D_CASES} cases of {'x'.join(map(str, UNET3D_VOLUME))} "
        + ("written and preprocessed (-c 3d_fullres)" if shared is None
           else "preprocessed by phase 10, copied") +
        f" in {time.perf_counter() - t0:.1f} s; the planner's patch "
        f"{planned[0]} at batch {planned[1]} replaced by phase 10's plan: patch "
        f"{list(UNET3D_TILE)}, batch {SS3D_BATCH}, features {list(UNET3D_FEATURES)}")
    registry.register_trainer(replace(
        registry.get_trainer_config(trainer), name=recipe,
        num_epochs=1, num_iterations_per_epoch=SS3D_STEPS,
        num_val_iterations_per_epoch=SS3D_VAL_STEPS, disable_mirroring=True))
    base = tmp / "results" / UNET3D_DATASET / f"{recipe}__nnUNetPlans__3d_fullres"
    first, steps = {}, []
    train_c, val_c, final_c = {}, {}, {}
    with recording_first_batches(first), \
            attribute_launches(_ext, Trainer, "train_step", train_c, steps), \
            attribute_launches(_ext, Trainer, "val_step", val_c), \
            attribute_launches(_ext, NNUNetTrainer, "perform_actual_validation", final_c):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _ext.reset_launch_counts()
        t0 = time.perf_counter()
        cli.train_entry([UNET3D_ID, "3d_fullres", "0", "-tr", recipe, "-device", "cuda"])
        verb_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    ck = load_checkpoint(str(base / "fold_0" / "checkpoint_final.ckpt"))
    lg = ck["logging"]
    gaps = [1e3 * (b[0] - a[0]) for a, b in zip(steps[1:], steps[2:])]
    step_ms = statistics.median(gaps)
    summary = load_json(str(base / "fold_0" / "validation" / "summary.json"))
    log(f"  verb train {UNET3D_ID} 3d_fullres 0 -tr {recipe}: {verb_s:.1f} s (1 epoch of "
        f"{SS3D_STEPS} steps at batch {SS3D_BATCH} of {UNET3D_TILE} + {SS3D_VAL_STEPS} "
        f"validation steps, the final validation of {len(summary['metric_per_case'])} cases), "
        f"peak memory {peak:.2f} GiB; loss train {lg['train_losses']}, validation "
        f"{lg['val_losses']}, pseudo dice {lg['mean_fg_dice']}; foreground Dice "
        f"{summary['foreground_mean']['Dice']:.4f} | {card}")
    log(f"  launches in the training steps {train_c}, the validation steps {val_c}, the final "
        f"validation {final_c}")
    if len(steps) != SS3D_STEPS or not all(math.isfinite(v) for v in
                                           lg["train_losses"] + lg["val_losses"]):
        fail(f"the {label} verb ran {len(steps)} steps, losses {lg['train_losses']} "
             f"{lg['val_losses']}")
    for counts, where, want in ((train_c, "training steps", MAMBA_KERNELS),
                                (val_c, "validation steps", ("selective_scan_fwd",)),
                                (final_c, "final validation", ("selective_scan_fwd",))):
        bad = {k: v for k, v in counts.items() if v and k not in want}
        if bad or any(counts.get(k, 0) <= 0 for k in want):
            fail(f"the {label} verb's {where} launched {counts} (want {want} only)")
    if any(v for k, v in launches.items() if k not in MAMBA_KERNELS):
        fail(f"the {label} verb run launched {launches}")

    # the gradient gates (ROADMAP C2) at batch 1 of UNET3D_GRAD_PATCH (the
    # reference's fp64 network does not fit the card at the batch of 2, and
    # takes minutes at the full patch): the network's on its seeded weights;
    # each scan call's on the verb's final weights and the centre of the
    # first training batch's first case
    grad_cm = unet3d_configuration(UNET3D_GRAD_PATCH, SS3D_GRAD_BATCH)
    seeded_grad_gate(torch, card, label, recipe, grad_cm, SS3D_CLASSES)
    tr = Trainer(recipe, batch_size=SS3D_GRAD_BATCH, num_input_channels=1,
                 num_classes=SS3D_CLASSES, batch_dice=False, seed=0, device="cuda",
                 compute_dtype=torch.float32, configuration_manager=grad_cm)
    tr.network.load_state_dict(jax_tree_to_state_dict(ck["network_weights"]), strict=True)
    drop_path_off(tr.network)
    cut = tuple(slice((t - c) // 2, (t - c) // 2 + c) for t, c in zip(UNET3D_TILE,
                                                                     UNET3D_GRAD_PATCH))
    x = torch.from_numpy(np.ascontiguousarray(
        first["train"]["data"][(slice(SS3D_GRAD_BATCH), *cut)])).cuda()
    y = torch.from_numpy(np.ascontiguousarray(
        first["train"]["target"][(slice(SS3D_GRAD_BATCH), *cut)])).cuda()
    scan_calls_gate(torch, f"{label} (the verb's final weights)", tr, tr.network, x, y)
    tr.network.zero_grad(set_to_none=True)
    del tr, x, y
    gc.collect()
    torch.cuda.empty_cache()

    # ms per step: the verb's with the loader, and one cached batch
    plans, dataset = (load_json(str(pre / f)) for f in ("nnUNetPlans.json", "dataset.json"))
    vt = NNUNetTrainer(plans, "3d_fullres", 0, dataset, trainer_name=recipe, device="cuda")
    vt.initialize()
    xb, yb = vt.feed.batch(first["train"])
    vt.step.run_steps([(xb, yb)] * 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vt.step.run_steps([(xb, yb)] * SS3D_CACHED_STEPS)
    cached = (time.perf_counter() - t0) / SS3D_CACHED_STEPS * 1e3
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  ms per step (bf16, batch {SS3D_BATCH} of {UNET3D_TILE}): {step_ms:.2f} with the "
        f"loader (median of the verb's steps 2-{SS3D_STEPS}), {cached:.2f} on its first batch "
        f"cached on the card, peak memory of the cached steps {step_peak:.2f} GiB; "
        f"{SS3D_BATCH * 1e3 / step_ms:.3f} patches/s | {card}")
    del vt, xb, yb
    gc.collect()
    torch.cuda.empty_cache()

    # the predict verb on the test cases (a 3-D volume takes ~7 s)
    out = tmp / f"{recipe}_predicted"
    t0 = time.perf_counter()
    _ext.reset_launch_counts()
    cli.predict_entry(["-i", str(raw / "imagesTs"), "-o", str(out), "-d", UNET3D_ID, "-c",
                       "3d_fullres", "-tr", recipe, "-f", "0"])
    ran = {k.name: k.launches for k in _ext.ALL_KERNELS if k.launches}
    check_segs(out, [f"case_{i:03d}.nii.gz" for i in range(UNET3D_CASES, UNET3D_CASES
                                                            + UNET3D_TEST_CASES)],
               f"the {label} predict verb")
    if set(ran) != {"selective_scan_fwd"}:
        fail(f"the predict verb on the {label} folder launched {ran}")
    log(f"  predict verb (bf16, the budget's tile batch, no mirroring: the recipe disables "
        f"it) on the {UNET3D_TEST_CASES} test case(s): {time.perf_counter() - t0:.1f} s, "
        f"launches {ran} | {card}")


def phase_ss3d(torch, card: str, held: set = None, shared: Path = None) -> None:
    """Phase 12: the SS3D U-Mambas, VM-UNet-3D and MSVM-UNet on the card
    (``shared``: phase 10's preprocessed 3-D cases, for the train verb)."""
    zoo_phase(torch, card, "ss3d", ss3d_phase_steps, held, shared)


def ss3d_phase_steps(torch, card: str, held: set, shared: Path = None) -> None:
    """Phase 12's steps (a)-(d)."""
    def stamp(t0):
        return f"{time.perf_counter() - t0:.1f} s"

    t0 = time.perf_counter()
    log(f"[ss3d] the six networks at full width: 3-D on the {UNET3D_TILE} plan, MSVM-UNet on "
        f"the {MAMBA_PATCH} plan")
    nets = zoo_networks(torch, SS3D_NETWORKS, SS3D_3D)
    tiles = tile_agreement(torch, "ss3d", nets)
    log("[ss3d] (a) K1 and K5 at every shape one forward and backward of each network emits")
    ss3d_scan_checks(torch, card, ss3d_scan_shapes(torch, nets), held)
    log(f"  (a) done in {stamp(t0)}")
    t0 = time.perf_counter()
    log(f"[ss3d] (b) one tile, fp32, card vs CPU (U-Mambas {SS3D_CPU_TILE}, VM-UNet-3D "
        f"{VMUNET3D_CPU_TILE}: cut for the CPU)")
    tiles()
    log(f"  (b) done in {stamp(t0)}")
    t0 = time.perf_counter()
    log(f"[ss3d] (c) serve | {card}")
    with no_autotune():
        for name in SS3D_SERVED:
            mamba_serve(torch, card, name, nets[name], UNET3D_TILE, SS3D_CLASSES, (0, 1, 2),
                        UNET3D_VOLUME, SS3D_VOLUMES, profiled=False, fp32_own_batch=True,
                        warmup_volume=(1, *UNET3D_TILE))
    log(f"  (c) done in {stamp(t0)}")
    del nets
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[ss3d] (d) the train verb: nnUNetTrainerUMambaEnc_SS3D | {card}")
    with verb_paths("chip_smoke_ss3d_") as tmp, no_autotune():
        train_verb_3d(torch, card, tmp, shared, "nnUNetTrainerUMambaEnc_SS3D", SS3D_RECIPE, "U-Mamba Enc SS3D")
    log(f"  (d) done in {stamp(t0)}")


def variant_scan_checks(torch, card: str, calls: dict, held: set) -> None:
    """K1 and K5 against their plain twins at every recorded shape an
    earlier phase did not hold (phase 3's tolerances); the shapes must
    include SegMamba's L = 262,144 and UltraLight's d = 12, and every shape
    must have run both kernels. Then both timed at SegMamba's stage 0
    beside their plain twins (one run each) and their bound."""
    want = {"L = 262,144": lambda k: k[3] == SEGMAMBA_LARGEST[3], "d = 12": lambda k: k[2] == 12}
    missing = [w for w, f in want.items() if not any(f(k) for k in calls)]
    both = [k for k, v in calls.items() if v != {"K1", "K5"}]
    if missing or both:
        fail(f"phase 13's scans miss {missing}, or ran K1 or K5 only at {both}: {calls}")
    scan_shape_checks(torch, calls, held)
    scan_timing(torch, card, SEGMAMBA_LARGEST, "SegMamba stage 0, training batch",
                plain_reps=1)


def phase_variants(torch, card: str, held: set = None, shared: Path = None) -> None:
    """Phase 13: SegMamba, nnMamba, LightM-UNet and UltraLight VM-UNet on
    the card (``shared``: phase 10's preprocessed 3-D cases, for the train
    verb)."""
    zoo_phase(torch, card, "variants", variant_phase_steps, held, shared)


def variant_phase_steps(torch, card: str, held: set, shared: Path = None) -> None:
    """Phase 13's steps (a)-(d)."""
    def stamp(t0):
        return f"{time.perf_counter() - t0:.1f} s"

    t0 = time.perf_counter()
    log(f"[variants] the four networks at full width: 3-D on the {UNET3D_TILE} plan, 2-D on "
        f"the {MAMBA_PATCH} plan")
    nets = zoo_networks(torch, VARIANT_NETWORKS, VARIANT_3D)
    # on the seeded weights and running statistics, before (a)'s training-mode passes
    tiles = tile_agreement(torch, "variants", nets)
    log("[variants] (a) K1 and K5 at every shape one forward and backward of each network "
        "emits, in training mode (nnMamba's BatchNorm on the batch's statistics)")
    calls, per_model = {}, {}
    zoo_scan_shapes(torch, nets, VARIANT_3D, torch.Generator().manual_seed(3), calls, per_model,
                    train_mode=True)
    log_scan_shapes(per_model)
    variant_scan_checks(torch, card, calls, held)
    log(f"  (a) done in {stamp(t0)}")
    t0 = time.perf_counter()
    log(f"[variants] (b) one tile, fp32, card vs CPU (cut for the CPU: 3-D on {SS3D_CPU_TILE}, "
        f"2-D on {VARIANT_CPU_TILE_2D})")
    tiles()
    log(f"  (b) done in {stamp(t0)}")
    t0 = time.perf_counter()
    log(f"[variants] (c) serve | {card}")
    with no_autotune():
        mamba_serve(torch, card, VARIANT_TRAINER, nets[VARIANT_TRAINER], UNET3D_TILE,
                    SS3D_CLASSES, (0, 1, 2), UNET3D_VOLUME, VARIANT_VOLUMES,
                    bf16_tol=SEGMAMBA_BF16_TOL, profiled=False,
                    fp32_own_batch=True, warmup_volume=(1, *UNET3D_TILE))
    log(f"  (c) done in {stamp(t0)}")
    del nets
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[variants] (d) the train verb: {VARIANT_TRAINER} | {card}")
    with verb_paths("chip_smoke_variants_") as tmp, no_autotune():
        train_verb_3d(torch, card, tmp, shared, VARIANT_TRAINER, VARIANT_RECIPE, "SegMamba")
    log(f"  (d) done in {stamp(t0)}")


def lkm_scan_checks(torch, card: str, calls: dict, held: set) -> None:
    """K1 and K5 against their plain twins at every recorded shape an
    earlier phase did not hold (phase 3's tolerances); the shapes must
    include L = 1, LKM-UNet's stage-0 pixel shape (L = 64 at b =
    LKM_PIXEL_STAGE0's) and the Mamba skip's L = MSMM_L at g = 2 in both
    directions, and every shape must have run both kernels. Then both timed
    at LKM-UNet's stage-0 pixel shape beside their plain twins (one run each)
    and their bound."""
    want = {"L = 1": lambda k: k[3] == 1,
            f"L = 64 at b = {LKM_PIXEL_STAGE0[0]}": lambda k: k[:4] == LKM_PIXEL_STAGE0[:4],
            f"L = {MSMM_L} at g = 2": lambda k: k[1] == 2 and k[3] == MSMM_L and not k[6],
            f"L = {MSMM_L} at g = 2 reversed": lambda k: k[1] == 2 and k[3] == MSMM_L and k[6]}
    missing = [w for w, f in want.items() if not any(f(k) for k in calls)]
    both = [k for k, v in calls.items() if v != {"K1", "K5"}]
    if missing or both:
        fail(f"phase 14's scans miss {missing}, or ran K1 or K5 only at {both}: {calls}")
    scan_shape_checks(torch, calls, held)
    scan_timing(torch, card, LKM_PIXEL_STAGE0, "LKM-UNet stage-0 pixel layer, training batch",
                plain_reps=1)


def mednext_skip_gates(torch, card: str) -> None:
    """MedNeXt_Mambaskip's gradient gates through ``Trainer`` on one cached
    batch: the network-level gate on its seeded weights
    (``seeded_grad_gate``); then MEDNEXT_SKIP_STEPS bf16 steps of its recipe on
    a seeded batch (ms per step) and the per-call gate on the weights they
    leave (``scan_calls_gate``), all at batch GATE_BATCH_2D."""
    from mlagg_unet_torch.training.trainer import Trainer

    cm = mamba_configuration(GATE_BATCH_2D)
    seeded_grad_gate(torch, card, "MedNeXt Mambaskip", MEDNEXT_SKIP_TRAINER, cm, MAMBA_CLASSES,
                     batch_dice=True)
    tr = Trainer(MEDNEXT_SKIP_TRAINER, batch_size=cm.batch_size, num_input_channels=1,
                 num_classes=MAMBA_CLASSES, batch_dice=True, seed=0, device="cuda",
                 configuration_manager=cm)
    x, y = seeded_blobs(torch, cm.batch_size, cm.patch_size, GATE_SEED + 1)
    tr.run_steps([(x, y)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = tr.run_steps([(x, y)] * (MEDNEXT_SKIP_STEPS - 1))
    step_ms = (time.perf_counter() - t0) / (MEDNEXT_SKIP_STEPS - 1) * 1e3
    log(f"  MedNeXt Mambaskip: {MEDNEXT_SKIP_STEPS} bf16 steps of its recipe at batch "
        f"{cm.batch_size} of {MAMBA_PATCH} on one cached batch: {step_ms:.2f} ms per step after "
        f"the first, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, losses "
        f"{['%.5f' % v for v in losses]} | {card}")
    drop_path_off(tr.network)
    scan_calls_gate(torch, "MedNeXt Mambaskip (its trained weights)", tr, tr.network, x, y)
    tr.network.zero_grad(set_to_none=True)
    del tr, x, y
    gc.collect()
    torch.cuda.empty_cache()


def phase_lkm(torch, card: str, held: set = None) -> None:
    """Phase 14: LKM-UNet and MedNeXt, with and without its Mamba skip, on
    the card."""
    zoo_phase(torch, card, "lkm-mednext", lkm_phase_steps, held)


def lkm_phase_steps(torch, card: str, held: set) -> None:
    """Phase 14's steps (a)-(d)."""
    from mlagg_unet_torch.training.registry import get_network_builder

    def stamp(t0):
        return f"{time.perf_counter() - t0:.1f} s"

    t0 = time.perf_counter()
    log(f"[lkm-mednext] the three networks at full width on the {MAMBA_PATCH} plan")
    nets = zoo_networks(torch, LKM_NETWORKS, ())
    tiles = tile_agreement(torch, "lkm-mednext", nets)
    log("[lkm-mednext] (a) K1 and K5 at every shape one forward and backward of LKM-UNet and "
        f"MedNeXt Mambaskip emits, in training mode, and of LKM-UNet in 3-D at batch 1 of "
        f"{UNET3D_GRAD_PATCH} on phase 10's plan")
    calls, per_model = {}, {}
    g = torch.Generator().manual_seed(3)
    zoo_scan_shapes(torch, {k: nets[k] for k in LKM_SCANNED}, (), g, calls, per_model,
                    train_mode=True)
    lkm3d = get_network_builder("lkm_unet")(unet3d_configuration(UNET3D_GRAD_PATCH, 1), 1,
                                            SS3D_CLASSES, True, seed=0, device="cuda")
    zoo_scan_shapes(torch, {"LKM-UNet 3-D": lkm3d}, ("LKM-UNet 3-D",), g, calls, per_model,
                    train_mode=True, batch_3d=1, tile_3d=UNET3D_GRAD_PATCH)
    del lkm3d
    log_scan_shapes(per_model)
    lkm_scan_checks(torch, card, calls, held)
    log(f"  (a) done in {stamp(t0)}")
    t0 = time.perf_counter()
    log(f"[lkm-mednext] (b) one tile, fp32, card vs CPU (on {ZOO_CPU_TILE_2D}: cut for the CPU)")
    tiles()
    log(f"  (b) done in {stamp(t0)}")
    t0 = time.perf_counter()
    log(f"[lkm-mednext] (c) serve | {card}")
    with no_autotune():
        for name in LKM_SCANNED:   # the kernels vs twins on a one-slice warm-up volume
            mamba_serve(torch, card, name, nets[name], n_volumes=1,
                        bf16_tol=LKM_BF16_TOL[name], profiled=False, fp32_own_batch=True,
                        warmup_volume=(1, 1, *MAMBA_PATCH))
    log(f"  (c) done in {stamp(t0)}")
    del nets
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[lkm-mednext] (d) the train verb: {LKM_TRAINER}; MedNeXt Mambaskip's gates through "
        f"Trainer | {card}")
    with verb_paths("chip_smoke_lkm_", HOST_PREP.folder("mamba")[0]) as tmp, no_autotune():
        train_verb_2d(torch, card, tmp, LKM_TRAINER, LKM_RECIPE, "LKM-UNet", LKM_STEPS,
                      LKM_CACHED_STEPS, 1, gate_batch=GATE_BATCH_2D)
    mednext_skip_gates(torch, card)
    log(f"  (d) done in {stamp(t0)}")


def transformer_serve(torch, card: str, name: str, net) -> None:
    """VolumePredictor on one MAMBA_VOLUME after a one-slice warm-up: tile
    MAMBA_PATCH, step 0.5, Gaussian, mirror (0, 1), bf16 compute and
    transfer, the memory budget's tile batch; volumes/s, peak memory, bf16
    against fp32 serving of the same volume (TRANSFORMER_BF16_TOL). No port
    kernel may run."""
    from mlagg_unet_torch import VolumePredictor
    from mlagg_unet_torch.ops import _ext

    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    rng = np.random.RandomState(6)
    warm = rng.rand(1, 1, *MAMBA_PATCH).astype(np.float32)
    volume = rng.rand(*MAMBA_VOLUME).astype(np.float32)
    pred = VolumePredictor(net, MAMBA_PATCH, MAMBA_CLASSES, (0, 1), None,
                           compute_dtype=torch.bfloat16, transfer_dtype=torch.bfloat16,
                           device="cuda")
    pred(warm)   # the budget probe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    outs, elapsed, _ = serve_window(pred, [volume])
    ran = {k.name: k.launches for k in _ext.ALL_KERNELS if k.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tb = pred.last_tile_batch
    ref32 = VolumePredictor(net, MAMBA_PATCH, MAMBA_CLASSES, (0, 1), None, device="cuda")(volume)
    d = float(np.linalg.norm(outs[0] - ref32) / np.linalg.norm(ref32))
    if outs[0].shape != (MAMBA_CLASSES, *MAMBA_VOLUME[1:]) or not np.isfinite(outs[0]).all():
        fail(f"{name} serve output {outs[0].shape}, finite={bool(np.isfinite(outs[0]).all())}")
    log(f"  {name}: 1 volume of {'x'.join(map(str, MAMBA_VOLUME))} after a one-slice warm-up, "
        f"step 0.5, mirror (0, 1), bf16: {1 / elapsed:.4f} volumes/s ({elapsed:.3f} s), tile "
        f"batch {tb} (model batch {4 * tb}), peak memory {peak:.2f} GiB; bf16 vs fp32 serving: "
        f"rel L2 {d:.3e} (tol {TRANSFORMER_BF16_TOL[name]:g}: twice JAX's own); "
        f"{time.perf_counter() - t_all:.1f} s in all | {card}")
    if not d <= TRANSFORMER_BF16_TOL[name]:
        fail(f"{name}: bf16 serving disagrees with fp32 serving: rel L2 {d:.3e}")
    if ran:
        fail(f"{name} serving launched port kernels: {ran}")
    del pred, outs, ref32


def transformer_train_verb(torch, card: str, tmp: Path) -> None:
    """TRANSFORMER_TRAINER through the train verb on the train verb's 10
    cases with phase 11's 2d plan (``tmp``: a copy of HOST_PREP's "mamba"
    folder), cut to 1 epoch of TRANSFORMER_STEPS steps and MAMBA_VAL_STEPS
    validation steps on fold 0 (its recipe: the flagship's AdamW, cosine
    warm-up, lr 1e-4, no deep supervision): losses, ms per step with the
    loader, no port kernel; then the predict verb on its folder for one
    case."""
    from dataclasses import replace

    from mlagg_unet_torch.cli.entrypoints import predict_from_modelfolder_entry, train_entry
    from mlagg_unet_torch.imageio.nifti_io import NiftiIO
    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.training import registry
    from mlagg_unet_torch.training.checkpoint import load_checkpoint
    from mlagg_unet_torch.training.trainer import NNUNetTrainer, Trainer
    from mlagg_unet_torch.utils.helpers import load_json

    registry.register_trainer(replace(
        registry.get_trainer_config(TRANSFORMER_TRAINER), name=TRANSFORMER_RECIPE, num_epochs=1,
        num_iterations_per_epoch=TRANSFORMER_STEPS, num_val_iterations_per_epoch=MAMBA_VAL_STEPS))
    base = tmp / "results" / MAMBA_DATASET / f"{TRANSFORMER_RECIPE}__nnUNetPlans__2d"
    times, counts = [], {}
    with attribute_launches(_ext, Trainer, "train_step", counts, times), \
            attribute_launches(_ext, Trainer, "val_step", counts), \
            attribute_launches(_ext, NNUNetTrainer, "perform_actual_validation", counts):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_entry([MAMBA_ID, "2d", "0", "-tr", TRANSFORMER_RECIPE, "-device", "cuda"])
        verb_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lg = load_checkpoint(str(base / "fold_0" / "checkpoint_final.ckpt"))["logging"]
    summary = load_json(str(base / "fold_0" / "validation" / "summary.json"))
    if len(times) != TRANSFORMER_STEPS or not all(
            math.isfinite(v) for v in lg["train_losses"] + lg["val_losses"]):
        fail(f"the MLLA-UNet verb ran {len(times)} steps, losses {lg['train_losses']} "
             f"{lg['val_losses']}")
    step_ms = statistics.median(1e3 * (b[0] - a[0]) for a, b in zip(times[1:], times[2:]))
    epoch_s = lg["epoch_end_timestamps"][0] - lg["epoch_start_timestamps"][0]
    log(f"  verb train {MAMBA_ID} 2d 0 -tr {TRANSFORMER_RECIPE}: {verb_s:.1f} s (1 epoch of "
        f"{TRANSFORMER_STEPS} steps at batch {MAMBA_BATCH} of {MAMBA_PATCH} + {MAMBA_VAL_STEPS} "
        f"validation steps, {epoch_s:.1f} s, the final validation of "
        f"{len(summary['metric_per_case'])} cases), "
        f"{step_ms:.2f} ms per step with the loader (median of steps 2-{TRANSFORMER_STEPS}), "
        f"peak memory {peak:.2f} GiB; loss train {lg['train_losses']}, validation "
        f"{lg['val_losses']}, pseudo dice {lg['mean_fg_dice']}; foreground Dice "
        f"{summary['foreground_mean']['Dice']:.4f} | {card}")
    if any(counts.values()):
        fail(f"the MLLA-UNet verb launched port kernels: {counts}")
    cases, out = tmp / "verb_imagesTs", tmp / "verb_predicted"
    cases.mkdir()
    shutil.copyfile(tmp / "raw" / MAMBA_DATASET / "imagesTr" / "case_000_0000.nii.gz",
                    cases / "case_000_0000.nii.gz")
    t0 = time.perf_counter()
    predict_from_modelfolder_entry(["-i", str(cases), "-o", str(out), "-m", str(base), "-f", "0",
                                    "-device", "cuda"])
    seg, _ = NiftiIO().read_seg(str(out / "case_000.nii.gz"))
    labels = np.unique(seg)
    if seg.shape != (1, 10, 320, 260) or not set(labels) <= set(range(MAMBA_CLASSES)):
        fail(f"predict verb on the MLLA-UNet folder: {seg.shape}, labels {labels}")
    log(f"  predict verb on the MLLA-UNet folder: 1 case in {time.perf_counter() - t0:.1f} s, "
        f"shape (1, 10, 320, 260), labels {labels.tolist()} | {card}")


def mlla_unet_grads(torch, dev: str):
    """TRANSFORMER_TRAINER's loss (DC+CE, no deep supervision) and every
    parameter gradient at batch 1 of TRANSFORMER_GRAD_TILE in fp64 on
    ``dev``, on the seeded network (drop path off; BatchNorm on the batch's
    statistics) and a seeded batch of blobs; and the seconds."""
    from mlagg_unet_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    x, y = seeded_blobs(torch, 1, TRANSFORMER_GRAD_TILE, GATE_SEED, dev)
    tr = Trainer(TRANSFORMER_TRAINER, TRANSFORMER_GRAD_TILE, 1, 1, MAMBA_CLASSES, seed=0,
                 device=dev, compute_dtype=torch.float32)
    drop_path_off(tr.network)
    net = tr.network.to(torch.float64)
    return train_grads(tr, net, x.to(torch.float64), y), time.perf_counter() - t0


def transformer_grads(torch) -> None:
    """``mlla_unet_grads`` card against CPU (the CPU's made by HostPrep), as
    phase 10 holds the 3-D U-Net: the loss within 1e-5, each gradient
    within 1e-3 x max + 1e-6."""
    got, card_s = mlla_unet_grads(torch, "cuda")
    ref, cpu_s = HOST_PREP.folder("mlla_unet_grads")[1]
    log(f"  MLLA-UNet's loss and every gradient at batch 1 of {TRANSFORMER_GRAD_TILE} (the tile "
        f"cut for the CPU), fp64: card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    compare_grads(torch, "MLLA-UNet, fp64, card vs CPU", *got, *ref)


def phase_transformers(torch, card: str, held: set = None) -> None:
    """Phase 15: SwinUNETR, Swin-TUNet, TransUNet and MLLA-UNet on the card;
    none of K1-K8 may run in it."""
    zoo_phase(torch, card, "transformers", transformer_phase_steps, held, kernels=())


def transformer_phase_steps(torch, card: str, held: set) -> None:
    """Phase 15's steps (a)-(c)."""
    def stamp(t0):
        return f"{time.perf_counter() - t0:.1f} s"

    t0 = time.perf_counter()
    log(f"[transformers] the four networks at full width on the {MAMBA_PATCH} plan")
    nets = zoo_networks(torch, TRANSFORMER_NETWORKS, ())
    counts = {k: sum(p.numel() for p in v.parameters()) for k, v in nets.items()}
    log(f"  parameters, the port's against JAX's: "
        f"{({k: (v, TRANSFORMER_JAX_PARAMS[k]) for k, v in counts.items()})}")
    if any(v != TRANSFORMER_JAX_PARAMS[k] for k, v in counts.items()):
        fail(f"a network's parameter count differs from JAX's: {counts}")
    log(f"[transformers] (a) one {MAMBA_PATCH} tile each, fp32, card vs CPU")
    tiles = tile_agreement(torch, "transformers", nets)
    log(f"[transformers] (b) serve | {card}")
    with no_autotune():
        for name in TRANSFORMER_SERVED:
            transformer_serve(torch, card, name, nets[name])
    tiles()
    log(f"  (a), (b) done in {stamp(t0)}")
    del nets
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[transformers] (c) the train verb: {TRANSFORMER_TRAINER}; its fp64 gradients, card vs "
        f"CPU | {card}")
    with verb_paths("chip_smoke_transformers_", HOST_PREP.folder("mamba")[0]) as tmp, \
            no_autotune():
        transformer_train_verb(torch, card, tmp)
    transformer_grads(torch)
    log(f"  (c) done in {stamp(t0)}")


def phase_grad_gates(torch, card: str) -> None:
    """The network-level gradient gates of phases 11-14 alone, on their
    seeded weights and batches (``seeded_grad_gate``): U-Mamba Enc in 2-D
    (also with the network in fp64 around the scans), U-Mamba Enc SS3D and
    SegMamba at batch 1 of UNET3D_GRAD_PATCH, LKM-UNet and MedNeXt
    Mambaskip in 2-D. Run twice, each run gives the same verdicts and
    figures."""
    from mlagg_unet_torch.ops import _ext

    t0 = time.perf_counter()
    _ext.reset_launch_counts()
    cm3 = unet3d_configuration(UNET3D_GRAD_PATCH, SS3D_GRAD_BATCH)
    seeded_grad_gate(torch, card, "U-Mamba Enc", "nnUNetTrainerUMambaEnc",
                     mamba_configuration(GATE_BATCH_2D), MAMBA_CLASSES, batch_dice=True,
                     fp64_around=True)
    for trainer, label in (("nnUNetTrainerUMambaEnc_SS3D", "U-Mamba Enc SS3D"),
                           (VARIANT_TRAINER, "SegMamba")):
        seeded_grad_gate(torch, card, label, trainer, cm3, SS3D_CLASSES)
    for trainer, label in ((LKM_TRAINER, "LKM-UNet"), (MEDNEXT_SKIP_TRAINER, "MedNeXt Mambaskip")):
        seeded_grad_gate(torch, card, label, trainer, mamba_configuration(GATE_BATCH_2D),
                         MAMBA_CLASSES, batch_dice=True)
    log(f"[grad-gates] the five gates held in {time.perf_counter() - t0:.1f} s | {card}")


def host_cpu() -> str:
    """The host's CPU model (``/proc/cpuinfo``'s model name, or its vendor,
    family, model and stepping where the name is hidden) and logical cores."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if not name or name == "unknown":
        name = " ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model",
                                                      "stepping", "cpu MHz", "bogomips")
                        if k in fields) or "not readable"
    return f"{name}; {os.cpu_count()} logical cores"


def main() -> None:
    global REPO, HOST_PREP
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--only", choices=("predict", "serve-timing", "train-verb", "pipeline",
                                       "unet3d", "mamba", "ss3d", "variants", "lkm-mednext",
                                       "transformers", "grad-gates"),
                    help="run the device and build phases and this one alone, with no "
                         "kernels line and no final line")
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose mlagg_unet_torch is imported (default: this "
                         "script's directory)")
    opts = ap.parse_args()
    REPO = opts.root.resolve()
    # the 3-D networks of phases 10 and 12 allocate tensors of several GiB;
    # without expandable segments the caching allocator's blocks fragment
    # until a served tile batch the budget allows no longer fits (phase 12
    # ran out of memory with 17.4 GiB reserved but unallocated)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (REPO / "mlagg_unet_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository (no mlagg_unet_torch/csrc)")
    sys.path.insert(0, str(REPO))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi: no output"
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[host] {host_cpu()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.ops import (  # noqa: F401  (registers every kernel)
        flash_attention, fused_norm, mlla_attn_fused, mlla_fused, selective_scan_cuda)

    from concurrent.futures import ThreadPoolExecutor

    from mlagg_unet_torch import native

    with ThreadPoolExecutor(1) as pool:   # g++ beside the nvcc builds
        t0 = time.perf_counter()
        resampler = pool.submit(native.build)
        secs = _ext.build_all()
        resampler.result()
        native_s = time.perf_counter() - t0
    log(f"[build] {len(_ext.ALL_KERNELS)} kernels from "
        f"{len({id(k.lib) for k in _ext.ALL_KERNELS})} sources in {secs:.1f} s; the native "
        f"resampler ({native.library_path().name}) beside them, all done in {native_s:.1f} s")

    def done(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prep_") as prep_root:
        # the datasets and preprocessing of phases 8-11, 14 and 15: beside the
        # phases in a side process in the whole run, in this process under --only
        HOST_PREP = HostPrep(Path(prep_root), card, background=not opts.only)
        try:
            run_phases(torch, card, opts.only, done)
        except BaseException:
            HOST_PREP.close(failed=True)
            raise
        HOST_PREP.close()


def run_phases(torch, card: str, only, done) -> None:
    """The phases after the build: ``only`` one of them, else all, then the
    kernels line, the card's line and the last line."""
    if only:
        {"serve-timing": serve_timing, "predict": phase_predict,
         "train-verb": phase_train_verb, "pipeline": phase_pipeline,
         "unet3d": phase_unet3d, "mamba": phase_mamba,
         "ss3d": phase_ss3d, "variants": phase_variants, "lkm-mednext": phase_lkm,
         "transformers": phase_transformers,
         "grad-gates": phase_grad_gates}[only](torch, card)
        done(only)
        return
    report = Report(sfu_exp_per_s(torch))
    phase_kernels(torch, report)
    phase_scan_train(torch, report)
    phase_fused_kernels(torch, report)
    done("kernels")
    model = phase_model(torch)
    fused = phase_model_fused(torch, model)
    done("model")
    serve, vps = phase_serve(torch, model, "default", SERVE_KERNELS, FUSED_KERNELS)
    del model
    serve_f, vps_f = phase_serve(torch, fused, "fused", SERVE_KERNELS + FUSED_KERNELS)
    del fused
    done("serve")
    predict = phase_predict(torch, card)
    done("predict")
    train, step_ms = phase_train(torch)
    done("train (default)")
    train_f, _ = phase_train(torch, fused_in=True)
    done("train (fused_instance_norm)")
    verb = phase_train_verb(torch, card, step_ms)
    done("train verb")
    pipeline = phase_pipeline(torch, card)
    done("pipeline")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_3d_") as shared3d:
        phase_unet3d(torch, card, Path(shared3d))
        done("unet3d")
        held = set()   # the scan shapes phases 11-13 held K1 and K5 at
        phase_mamba(torch, card, held)
        done("mamba")
        phase_ss3d(torch, card, held, Path(shared3d))
        done("ss3d")
        phase_variants(torch, card, held, Path(shared3d))
        done("variants")
        phase_lkm(torch, card, held)
        done("lkm-mednext")
    phase_transformers(torch, card)
    done("transformers")

    launches = {**serve, "selective_scan_bwd": train["selective_scan_bwd"],
                **{k: serve_f[k] for k in FUSED_KERNELS}}
    kernels = report.finish(launches)
    if {k["name"] for k in kernels} != set(launches):
        fail(f"kernels measured {sorted(r['name'] for r in kernels)} != built {sorted(launches)}")
    log(f"[serve] volumes_per_s default {vps} fused {vps_f}")
    log(f"[train] ms_per_step default {step_ms}")
    log(f"[predict] verb launches K1 {predict['selective_scan_fwd']}, K2 "
        f"{predict['mlla_front']}, K3 {predict['mlla_tail']}, K4 {predict['flash_attn_fwd']}")
    log(f"[train verb] verb launches K1 {verb['selective_scan_fwd']}, K2 {verb['mlla_front']}, "
        f"K3 {verb['mlla_tail']}, K4 {verb['flash_attn_fwd']}, K5 {verb['selective_scan_bwd']}")
    log(f"[pipeline] launches K1 {pipeline['selective_scan_fwd']}, K2 "
        f"{pipeline['mlla_front']}, K3 {pipeline['mlla_tail']}, K4 "
        f"{pipeline['flash_attn_fwd']}, K5 {pipeline['selective_scan_bwd']}")
    log(f"[train] fused_instance_norm launches in one fp32 step: K7 "
        f"{train_f['instance_norm_stats']}, K8 {train_f['instance_norm_apply']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
