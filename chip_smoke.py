#!/usr/bin/env python3
"""Drive the PyTorch port's serving, train step, encoder distillation and
dataset-to-AP CLIs once on one CUDA card: the flagship (deformable
encoder) in f32 and bf16, its from-scratch recipe (trainable BatchNorm),
its windowed-encoder variant, the Swin-L and T=5 configs, flip and
multi-scale test-time augmentation, the distillation CLI, the PETR
family (PETR R50 and HRNet-W48 on COCO, PETR Swin-L on CrowdPose, HRNet-W48
video pretraining) with COCO-format data through the CLIs, and SOIT and
DK-DETR (instance masks, text-embedding classes) with instance scenes and
a VOC tree through the test CLI; data parallelism over two ranks on the
card against one process, the CLIs under a launcher, and reference
``.pth`` checkpoints; InsPose (star deformable convolutions on the msda
kernels) serving, training, from a ``.pth`` and through the test CLI.

    python3 chip_smoke.py
    python3 chip_smoke.py --parent DIR   # only phases 1-3 and the comparison

Phases (one printed line each or more; any failure raises and exits
non-zero):

1. device: a CUDA card is required; prints nvidia-smi's name and power limit.
2. build:  compiles every ``csrc/*.cu`` (msda forward and backward, window
   attention forward and backward) with nvcc, in parallel, and prints each
   build time and ptxas's registers, spills and shared memory per kernel.
3. capture: the inputs of the 11 msda calls of one flagship
   ``forward_test`` (seed 0, a synthetic clip in the 800x1344 bucket), run
   on the plain path, and the encoder call of one T=5 clip (its five
   frames folded into the batch). With ``--parent DIR`` (a checkout of an
   earlier commit) the run then times that commit's msda kernels against
   this tree's on the encoder call, in-model and uniform-random, and
   stops.
4. msda forward kernel against its plain PyTorch version at the main-path
   shapes (encoder, pose decoder, serving joint decoder Q=300, train joint
   decoder Q=450) on uniform-random inputs, plus edge levels (1-row,
   1-column, 1x1), the other head sizes at the encoder call (SOIT's seg
   encoder, one 256-channel head at B=1; D=16 and D=64 over 8 heads), the
   T=5 encoder call (B*T=5), the PETR family's calls (the encoder at
   B*T=1, the one-level heatmap encoder over level 0 with Q=N=16800, the
   pose decoder at P=17 and P=14), and the 14 captured calls (with a PETR
   clip's first encoder and pose-decoder calls); value in f32 and bf16;
   times from CUDA events, median of 20.
5. msda backward kernel against autograd of the plain version at the
   encoder, pose decoder and train joint decoder shapes, the edge levels,
   the other head sizes and the PETR family's calls, and on the captured
   calls (g seeded), f32 and bf16; backward times of both.
6. msda probes, at the encoder call in-model and random, f32 and bf16:
   each kernel, its empty-body twin, the forward without corner loads, the
   forward with every query of a block on its first query's locations
   (perfect row sharing, the TPU merged-window probe's counterpart), the
   backward without grad_value reductions (all, shared-table, direct) and
   without per-tap sums, each kernel with nothing staged, and the
   wrapper's host checks per call.
7. window attention: the forward and backward kernels, one launch over an
   encoder layer's level rasters, against the plain version and its
   autograd level by level: the four flagship levels (B=3, C=256, 8 heads)
   unshifted and shifted, with bucket padding and one fully masked window
   per level; a 1x2 level; head size 8 (C=64) at the tiny config's levels;
   head sizes 16 and 64 (C=128, 512) at the flagship levels (the f32
   backward at 64 through the kernel's recomputing layout); f32 and
   bf16. Times per layer of kernel, plain (a loop over the levels),
   ``scaled_dot_product_attention`` on the partitioned layout (its level
   calls in turn; timed only) and the bound; then a per-level breakdown.
8. flagship serve, f32 then bf16: ``init_detector`` (random weights from a
   seed) and ``inference_detector`` on 3 synthetic 720x1280 clips (800x1344
   bucket): shapes, finiteness, exactly 11 msda launches per clip (in bf16
   all 11 on bf16 values); then ``impl="cuda"`` against ``impl="torch"``
   with TF32 off: f32 keypoints within 1e-2 px and keep equal on the plain
   path's top-k, the kernels' own top-k equal to it or a tie to rounding
   (proposal scores within 1e-5); bf16 stage by stage (memory, proposal scores, the decoders given the plain path's
   top-k and poses) within ``BF16_STAGE_TOL``.
9. flagship train, f32 then bf16: ``init_trainer``, 8 mini-steps of
   ``dummy_clip_batch(train=True)`` at 800x1344, B=1, 30 GT slots, which is
   one applied update: finite losses, exactly 11+11 msda launches per
   mini-step (bf16 values in the bf16 run), frozen parameters unchanged,
   every other parameter with a gradient changed; ms/step, host matching
   share, peak memory; then one mini-step cuda against torch on the
   weights as initialised: f32 the same matches, losses within 1e-4,
   gradient norm within 1e-3; bf16 on the plain path's top-k and matches,
   losses within ``BF16_LOSS_TOL``, gradient norm within
   ``BF16_NORM_TOL``.
10. from-scratch train: the synthetic recipe (trainable BatchNorm, nothing
   frozen, backbone at the full lr, no accumulation) at its own 448x768,
   B=2: 8 mini-steps = 8 updates, 11+11 msda launches each, every
   parameter with a gradient changed (stem and layer1 included) and every
   BatchNorm running statistic; then one mini-step cuda against torch
   (losses 1e-4, gradient norm 1e-3, running statistics 1e-5).
11. windowed serve: phase 8 on the windowed config, f32 and bf16, 6
   window-attention (one per encoder layer, over its 4 levels) and 5 msda
   launches per clip.
12. windowed train: phase 9 on the windowed config in f32, 6+6
   window-attention and 5+5 msda launches per mini-step; the cuda-vs-torch
   mini-step each path on its own top-k, and again both on the plain
   path's top-k, both at 1e-4.
13. distill: the flagship teacher and the windowed student
   (``create_distill_state``), 4 steps at 800x1344, B=1: exactly 6 msda
   forward and 6+6 window-attention launches per step, finite MSE, every
   entry outside the encoder bit-identical to the teacher's, the encoder
   weights changed; then one step cuda against torch (MSE and rel within
   1e-5, gradient norm within 1e-3).

14. dataset to AP: writes synthetic PoseTrack scenes at 448x768 (6 train
   and 3 val videos of 4 frames) under ``build/chip_data/``; trains the
   from-scratch recipe through ``pavenet_tpu_torch.tools.train.main``
   (``ClipLoader``, the uint8 feed normalised on the card) for 8
   mini-steps, 11+11 msda launches each, then again with
   ``--auto-resume`` to step 10 (the update count and the schedule's lr
   continue from the checkpoint); tests the checkpoint through
   ``tools.test.main`` in f32 and bf16, 11 msda launches per clip, with the
   eval loop's ms/clip (host pipeline included) and the metrics; holds
   ``impl="cuda"`` against ``impl="torch"`` (TF32 off): clip by clip on
   the plain path's top-k (the head's ``topk_idx``), keep equal,
   keypoints within 1e-2 px and scores within 1e-5; ``run_inference``
   each on its own top-k, Mean AP within 0.1 point; and ``apis/prep.py``
   on the card against the host Normalize chain (1e-5).
15. Swin-L serve: phase 8 on ``pavenet_swin_frames3_posetrack18.py``
   (Swin-L backbone, 800x1344 bucket, T=3, 300 queries, 6/3/2 head
   layers), f32 and bf16, 11 msda launches per clip, with peak memory.
16. Swin-L train: phase 9 on the same config in f32 (8 mini-steps, one
   update, 11+11 msda launches per mini-step, peak memory) and its
   cuda-vs-torch mini-step at phase 9's limits.
17. T=5: phases 8 and 9 on ``pavenet_r50_frames5_posetrack17.py`` in f32,
   11 msda launches per clip and 11+11 per mini-step (the encoder at
   B*T=5), with the cuda-vs-torch checks; the mini-step's on the plain
   path's top-k (seed 0's proposals hold a tie to rounding, checked).
18. (inside phase 14) ``tools.test.main --flip-test`` and ``--flip-test
   --aug-scales 1.0 0.75`` on the checkpoint: 22 and 44 msda launches per
   clip, eval ms/clip; cuda against torch clip by clip, every pass
   (``forward_test_aug``, the 0.75 scale in the 384x640 bucket, its own
   msda levels) on the plain path's top-k for the clip it runs, keypoints
   within 1e-2 px and scores within 1e-5, and the merged detections keep
   equal within the same limits; ``run_inference`` with the same options
   each on its own top-k, Mean AP within 0.1 point; ``tools.distill.main``
   from the checkpoint to the recipe's windowed student, 4 steps: 6 msda
   and 6+6 window-attention launches per step, every entry outside the
   encoder bit-identical to the teacher's and every encoder weight moved;
   ``tools.test.main`` on the student (5 msda and 6 window launches per
   clip) and the student cuda against torch clip by clip as the
   checkpoint.
19. PETR R50 on COCO (``configs/petr/petr_r50_16x2_100e_coco.py``: T=1,
   K=17, 300 queries, 6/3/2 layers, max_per_img 40, no rescoring, no NMS):
   phase 8 in f32 and bf16 (11 msda launches per clip, every detection
   kept with unit keypoint scores) and phase 9 in f32 (8 mini-steps, 12+12
   launches each: the one-level heatmap encoder adds one), the
   cuda-vs-torch mini-step on the plain path's top-k (losses with
   ``loss_hm``, ``loss_oks`` and ``d*.loss_oks_refine`` within 1e-4).
20. PETR HRNet-W48 (``petr_hrnetw48_16x2_100e_coco.py``): phases 8 and 9
   in f32 with the checks of 19, peak memory.
21. HRNet-W48 video pretraining
   (``pretrained/petr_hrnet_num_frame_3_bs16_20e_coco_rle.py``: T=3,
   K=17, RLE, heatmap weight 0): serve (11 per clip), train 16
   mini-steps = its one update (11+11 each), cuda against torch.
22. PETR Swin-L on CrowdPose (K=14, the pose decoder at P=14): serve in
   f32, 11 per clip, cuda against torch.
23. COCO-format data through the CLIs: seeded scenes at 448x768 with a
   K=17 json under ``build/chip_data/coco/``; ``tools.train.main`` on the
   PETR R50 config for 4 mini-steps (12+12 launches each),
   ``tools.test.main`` on its checkpoint (11 per clip, ``coco/`` metrics,
   eval ms/clip), ``tools.eval_metric.main`` on the dumped detections
   (the same metrics), and cuda against torch clip by clip on the plain
   path's top-k.

24. SOIT R50 (``configs/soit/soit_r50_16x2_50e_coco.py``: 80 classes, 300
   queries, 6/6 layers, 100 detections): ``init_detector`` and
   ``inference_detector`` on 3 synthetic 720x1280 images (800x1344
   bucket), f32 and bf16: exactly 13 msda launches per image (6 encoder,
   the one-head seg encoder, 6 box-reference decoder layers; the dynamic
   mask calls run the plain version, as JAX's ``impl='xla'``, and launch
   nothing), peak memory, the dynamic-mask call's time and bound; cuda
   against torch (TF32 off) on the plain path's proposals and detections:
   boxes within 1e-2 px, scores 1e-4, mask probabilities 1e-3, labels
   equal, the kernels' own proposals a tie at most; bf16 stage by stage
   within ``BF16_STAGE_TOL``. The msda kernels against the plain version
   on the captured in-model calls: the seg encoder (B=1 serving, B=2 in
   train mode) and the first and last decoder layers, forward and
   backward, f32 and bf16, with the share of sampling locations outside
   [0, 1]. Train: ``init_trainer``, 8 mini-steps (one update) at 800x1344,
   B=2 (the config's), 30 GT slots with seeded boxes, labels and box masks:
   13+13 launches each, ms per step, peak memory; one mini-step cuda
   against torch on the plain path's proposals: the same matches in all 7
   sets, every loss (``loss_mask_dice``, ``loss_mask_bce``, ``enc_loss_*``)
   within 1e-4, the gradient norm within 1e-3.
25. DK-DETR R50 LVIS (``configs/dk-detr/dkd_r50_70e_lvis.py``: 1203 classes,
   seeded (1203, 512) text embeddings read from a ``.npy`` by
   ``PseudoTextEncoder``, temperature 0.05, trainable BatchNorm, 300
   detections): phase 24 in f32, at its B=1; every trainable BatchNorm's
   running statistics move, and match the plain path's within 1e-5.
26. The test CLI on instance scenes (3 categories, polygon masks) at
   448x768 and a VOC2007 tree of them: seed-0 checkpoints of SOIT, of
   ``dkd_r50_70e_test_coco.py`` with 80 text rows and of
   ``dkd_r50_70e_test_voc.py`` with 20 (fewer than the model's 1203
   classes: every label within the rows) through ``tools.test.main``,
   every detection kept: 13 launches per image, bbox and segm AP or VOC
   mAP, ms per image.

27. data parallelism on the one card: two ranks (``chip_smoke.py
   --rank-worker``, gloo on ``cuda:0`` with CUDA tensors, a ``file://``
   store) against one process on the same global batch, run first and
   freed: the flagship at 800x1344 (B=1 a rank, B=2 in one process) and the
   from-scratch recipe at 448x768 (B=2 a rank, B=4; trainable BatchNorm,
   its accumulation set to 8), 8 mini-steps = one update, dropout 0, TF32
   off, the ranks on the single process's proposals and matches (near-ties
   at the initial parameters): every mini-step's losses (all at the
   initial parameters), the summed accumulated gradient per tensor, the
   running statistics and the parameters after the update, each worst
   error printed beside its limit (``DDP_*``) and beside the single
   process's own spread (the same batch, rows reversed); 88+88 msda
   launches on each rank. Their times are of two processes sharing one
   card: a correctness run, not a scaling number.
28. the CLIs over ranks: ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` runs ``tools.train`` on the from-scratch scenes with
   the NCCL backend for 2 mini-steps (a group at world size 1, the
   production launcher path; 11+11 launches each); ``tools.test`` at world
   size 2 over gloo on phase 14's checkpoint gives the detections of world
   size 1 (phase 14's ``dets_f32.json``), image by image, scores within
   1e-5 and keypoints within 1e-2 px, 11 launches per clip on each rank.
29. reference ``.pth`` checkpoints of the flagship, PETR R50 and SOIT R50 at
   full width: a reference-named state dict of a seed-1 init (the port's
   rule table, ``utils/reference_convert.py``, inverted) through
   ``init_detector(checkpoint=...)`` at seed 0 on the card: every entry
   equal to the source's bit for bit (PETR's sigma branches, absent from
   its reference tree, the model's init), and ``forward_test`` on a
   synthetic clip equal to the model built from that state dict, 11 (SOIT
   13) launches.

30. InsPose R50 (``configs/inspose/inspose_r50_8x4_3x_coco.py``: FPN, 256-
   and 512-wide towers, star deformable convolutions, dynamic keypoint
   FCNs, K=17, 100 detections, soft-NMS): ``init_detector`` and
   ``inference_detector`` on 3 synthetic 720x1280 images (800x1344
   bucket), f32 and bf16: 100 detections of 17 keypoints, finite, exactly
   10 msda launches per image (``cls_star`` and ``ctr_star`` on 5 levels,
   the 9 taps of each folded onto one call's queries); cuda against torch
   (TF32 off) on the plain path's top-k: level outputs, shared map and
   heatmap logits within ``INSPOSE_TOL`` (bf16 ``BF16_STAGE_TOL``), in f32
   keypoints within 1e-2 px off heatmap ties and soft-NMS scores within
   1e-4; every soft-NMS score at most its top-k score. The msda kernels
   against the plain version on the captured level-0 (Q = 151200) and
   level-4 star calls, forward and backward, f32 and bf16, with their
   bounds.
31. InsPose train, f32: ``init_trainer``, 8 mini-steps (one update) at
   800x1344, B=2 (the config's), 30 GT slots of seeded boxes and
   keypoints: 10+10 launches each, ms per step, peak memory; one mini-step
   cuda against torch: every loss within 1e-4, gradient norm within 1e-3.
32. an InsPose reference ``.pth`` through ``init_detector`` (phase 29's
   checks) and ``tools.test.main`` with it on phase 23's COCO scenes: 10
   launches per image, boxes of category 1 without masks, box AP (as the
   JAX CLI scores InsPose).

Each run sets every launch count to 0 just before it and reads them just
after. The last two lines are the kernels' JSON record (launches by run,
bf16 launches beside them) and the contract line
``{"ok": true, "device": {...}}``.
"""
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = "configs/videopose/pavenet_r50_frames3_posetrack17.py"
# PAVE-Net's Swin-L config (PoseTrack18) and the T=5 config
SWIN_CONFIG = "configs/videopose/pavenet_swin_frames3_posetrack18.py"
FRAMES5_CONFIG = "configs/videopose/pavenet_r50_frames5_posetrack17.py"
# the PETR family: PETR R50 and HRNet-W48 on COCO, PETR Swin-L on
# CrowdPose, HRNet-W48 video pretraining on fake COCO clips (T=3)
PETR_CONFIG = "configs/petr/petr_r50_16x2_100e_coco.py"
PETR_HRNET_CONFIG = "configs/petr/petr_hrnetw48_16x2_100e_coco.py"
PETR_CROWDPOSE_CONFIG = (
    "configs/petr/petr_swin-l-p4-w7-224-22kto1k_16x1_100e_crowdpose.py")
HRNET_PRETRAIN_CONFIG = ("configs/petr/pretrained/"
                         "petr_hrnet_num_frame_3_bs16_20e_coco_rle.py")
FLAGSHIP_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))  # 800x1344
EDGE_LEVELS = ((6, 9), (3, 5), (1, 3), (2, 1))
WINDOWED_CONFIG = ("configs/videopose/"
                   "pavenet_r50_frames3_posetrack17_windowed.py")
CLIPS = 3
CALLS_PER_CLIP = 11   # 6 encoder + 3 pose-decoder + 2 joint-decoder layers
# a PETR train mini-step adds the one-level heatmap encoder's call
PETR_TRAIN_CALLS = CALLS_PER_CLIP + 1
TRAIN_STEPS = 8       # = cumulative_iters of the flagship config (16 for
                      # the video-pretraining configs: one update)
# the windowed variant: 6 encoder layers of window attention, one launch
# per layer over its four pyramid levels; msda only in the 3 pose-decoder
# and 2 joint-decoder layers
WINDOW_CALLS, WINDOWED_MSDA_CALLS = 6, 5
DISTILL_STEPS = 4
# the from-scratch recipe (trainable BatchNorm, nothing frozen, one update
# per mini-step) at its own size
SYNTHETIC_CONFIG = "configs/videopose/pavenet_r50_frames3_synthetic_sm.py"
SYNTHETIC_WINDOWED_CONFIG = ("configs/videopose/"
                             "pavenet_r50_frames3_synthetic_sm_windowed.py")
SYNTHETIC_HW, SYNTHETIC_BATCH = (448, 768), 2
# bf16 against the plain path, stage by stage: max abs error within this
# fraction of the plain output's largest value (bf16 keeps 8 bits: a value
# moves by up to 0.4% per rounding, and the encoder's memory of either
# path sits 3-4% of its largest from the f32 memory, tests/test_torch_bf16.py),
# and the mini-step's losses and gradient norm relative to the plain ones
BF16_STAGE_TOL = 6e-2
BF16_LOSS_TOL, BF16_NORM_TOL = 1e-2, 5e-2
WINDOW = (8, 16)
IMG_SHAPE = (750, 1333)   # a 720x1280 clip resized into the 800x1344 bucket
EDGE_WINDOW_LEVEL = (1, 2)
TINY_LEVELS = ((12, 20), (6, 10), (3, 5), (2, 3))   # tiny configs, 96x160
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 flop/s outside the
# tensor cores, and the dense TF32 and bf16 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# flops per in-range tap and channel, corner weights counted once per tap:
# forward 4 corner FMAs + the weighted sum; backward the bilinear value,
# its x and y derivatives, three dot products and four scaled atomics
FWD_FLOPS, BWD_FLOPS = 10, 34
# phase 14: the scenes and the two train runs' mini-steps
CHIP_DATA = ROOT / "build" / "chip_data"
CHIP_WORK = ROOT / "build" / "chip_work"
E2E_SCENES = ["--train-videos", "6", "--val-videos", "3", "--frames", "4",
              "--height", "448", "--width", "768", "--seed", "0"]
E2E_STEPS, E2E_RESUMED_STEPS = 8, 10
# phase 23: COCO-format scenes (K=17) and PETR's train CLI mini-steps
COCO_DATA = CHIP_DATA / "coco"
COCO_IMAGES = {"train": 6, "val": 3}
COCO_HW = (448, 768)
COCO_STEPS = 4
# phase 18: the test CLI's test-time augmentation runs (name, flip test,
# scales) and the distillation CLI's steps
TTA_RUNS = (("flip", True, None), ("flip_scales", True, (1.0, 0.75)))
E2E_DISTILL_STEPS = 4
# phases 24-26: SOIT R50 and DK-DETR R50 LVIS (13 msda calls per image:
# 6 encoder layers, the one-head seg encoder over level 0, 6 box-refining
# decoder layers; the per-instance mask attention runs the plain version,
# as the JAX package's impl='xla'), their test configs through the test
# CLI on instance scenes with 3 categories and a VOC2007 tree
SOIT_CONFIG = "configs/soit/soit_r50_16x2_50e_coco.py"
DKDETR_CONFIG = "configs/dk-detr/dkd_r50_70e_lvis.py"
DKDETR_TEST_CONFIGS = (("coco", "configs/dk-detr/dkd_r50_70e_test_coco.py",
                        80),
                       ("voc", "configs/dk-detr/dkd_r50_70e_test_voc.py",
                        20))
SOIT_CALLS = 13
DET_DATA = CHIP_DATA / "instances"
DET_CATEGORIES = 3
# cuda vs torch on SOIT serving: boxes (px), scores, mask probabilities
SOIT_TOL = dict(boxes=1e-2, scores=1e-4, masks=1e-3)
# phases 27-29: two ranks on the one card (gloo) against one process on
# the same global batch, 8 mini-steps = one update, dropout 0, TF32 off:
# the flagship at B=1 a rank, the from-scratch recipe (trainable
# BatchNorm) at B=2 a rank with its accumulation set to 8, so that every
# mini-step's loss is at the initial parameters
DDP_WORLD = 2
DDP_RUNS = (("flagship", CONFIG, (800, 1344), 1, {}, 1e-2),
            ("synthetic", SYNTHETIC_CONFIG, SYNTHETIC_HW, 2,
             {"optimizer_config.cumulative_iters": TRAIN_STEPS}, 3e-2))
NO_DROPOUT = {
    "model.bbox_head.transformer.encoder.transformerlayers.ffn_dropout": 0.0}
# losses: |a - b| within 1e-4 + 1e-4 |a| (tests/test_parallel.py);
# running statistics within 1e-4 of their largest; parameters after the
# update within twice their lr and two float32 spacings (the sign flips
# that tests/test_parallel.py explains). The summed gradient, per tensor,
# within the run's limit (last above) of its largest |g|, that largest
# taken at least 1e-6 of the largest |g| of any tensor (a tensor whose
# gradient is zero in exact arithmetic, such as an attention key bias,
# since softmax ignores a shift common to all keys, holds rounding noise
# alone), or within ``DDP_SPREAD_FACTOR`` times the single process's own
# spread, taken tensor by tensor from the same batch with its rows
# reversed. The sampling offsets take their gradient through the bilinear
# taps' derivative, which steps where a tap crosses a pixel: a batch of 1
# and a batch of 2 run other GEMM and convolution kernels, and a location
# moved by rounding across a pixel in a 300-query decoder layer moves that
# layer's gradient by about 1/300 of its largest, hence 1e-2 with frozen
# BatchNorm. With trainable BatchNorm, flax's float32 E[x^2] - E[x]^2
# moves gradients by up to 2.65e-2 of a tensor's largest (JAX's own
# float32 against float64, tests/test_torch_trainable_bn.py), hence 3e-2,
# and moves enough locations that the offsets' gradients differ even
# within one process when only the order of the batch's rows changes:
# the spread term holds them
DDP_LOSS_TOL = (1e-4, 1e-4)
DDP_GRAD_FLOOR, DDP_STATS_TOL = 1e-6, 1e-4
DDP_SPREAD_FACTOR = 10
DDP_TIMEOUT_S = 600
CLI_DDP_STEPS = 2
# the reference .pth loads: name, config, msda launches of one forward_test
REFERENCE_RUNS = (("flagship", CONFIG, CALLS_PER_CLIP),
                  ("petr", PETR_CONFIG, CALLS_PER_CLIP),
                  ("soit", SOIT_CONFIG, SOIT_CALLS))
INSPOSE_CONFIG = "configs/inspose/inspose_r50_8x4_3x_coco.py"
INSPOSE_CALLS = 10    # cls_star and ctr_star on each of the 5 FPN levels
# the star convolutions whose msda calls the kernels are checked on
INSPOSE_CAPTURE = ("inspose_l0_cls_star", "inspose_l4_cls_star")
# f32 serving, kernels vs plain: level outputs and heatmap logits (relative
# to their largest), keypoints (px) and soft-NMS scores
INSPOSE_TOL = dict(stages=1e-4, kpts=1e-2, scores=1e-4)
# msda kernel vs plain: max abs error within these fractions of the plain
# version's max |out| (|grad|), f32 and bf16
MSDA_FWD_TOL = (("float32", 1e-5), ("bfloat16", 1e-2))
MSDA_BWD_TOL = (("float32", 1e-4), ("bfloat16", 2e-2))


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def msda_inputs(gen, B, levels, Q, H, P, D, dtype):
    import torch
    N = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.randn(B, N, H, D, device="cuda", generator=gen).to(dtype)
    loc = torch.rand(B, Q, H, L, P, 2, device="cuda", generator=gen)
    loc = loc * 1.2 - 0.1                      # some taps out of range
    attn = torch.rand(B, Q, H, L * P, device="cuda", generator=gen)
    attn = attn.softmax(-1).view(B, Q, H, L, P)
    return value, loc, attn


def pixel_coords(loc, levels):
    """Sampling coordinates ``loc * (W, H) - 0.5`` per level, (..., L, P)."""
    import torch
    wh = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32,
                      device=loc.device)
    xy = loc * wh[:, None, :] - 0.5
    return xy[..., 0], xy[..., 1], wh


def msda_bound(backward, value, levels, loc):
    """Least time of one call on an H100: each input read once and each
    output written once over the HBM rate, against the flops of the taps
    that lie in range (this run's data) over the f32 rate."""
    B, N, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    x, y, wh = pixel_coords(loc, levels)
    taps = ((x > -1) & (y > -1) & (x < wh[:, 0, None])
            & (y < wh[:, 1, None])).sum().item()
    vb = value.element_size()
    value_bytes = B * N * H * D * vb
    loc_attn_bytes = B * Q * H * L * P * 3 * 4
    if backward:   # + g (f32) in; grad_value, grad_loc, grad_attn out
        nbytes = 2 * value_bytes + 2 * loc_attn_bytes + B * Q * H * D * 4
        flops = taps * D * BWD_FLOPS
    else:          # + out
        nbytes = value_bytes + loc_attn_bytes + B * Q * H * D * vb
        flops = taps * D * FWD_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_cases():
    """(name, B, levels, Q, H, P, D) of the msda checks: the flagship's
    calls, edge levels, the other head sizes at the encoder call (the
    flagship levels): SOIT's seg encoder (one 256-channel head, B=1), 128
    and 512 channels over 8 heads (D=16, 64); and the T=5 config's encoder
    call (its five frames folded into the batch); the PETR family's calls:
    the encoder at B*T=1, the one-level heatmap encoder (level 0 alone,
    train only) and the pose decoder at P=17 (COCO) and P=14
    (CrowdPose)."""
    N = sum(h * w for h, w in FLAGSHIP_LEVELS)
    n0 = FLAGSHIP_LEVELS[0][0] * FLAGSHIP_LEVELS[0][1]
    return [("encoder", 3, FLAGSHIP_LEVELS, N, 8, 4, 32),
            ("pose_decoder", 3, FLAGSHIP_LEVELS, 300, 8, 15, 32),
            ("joint_decoder", 3, FLAGSHIP_LEVELS, 300, 8, 4, 32),
            ("joint_decoder_train", 3, FLAGSHIP_LEVELS, 450, 8, 4, 32),
            ("edge_levels", 2, EDGE_LEVELS, 7, 2, 15, 4),
            ("encoder_h1_d256", 1, FLAGSHIP_LEVELS, N, 1, 4, 256),
            ("encoder_d16", 3, FLAGSHIP_LEVELS, N, 8, 4, 16),
            ("encoder_d64", 3, FLAGSHIP_LEVELS, N, 8, 4, 64),
            ("encoder_frames5", 5, FLAGSHIP_LEVELS, N, 8, 4, 32),
            ("petr_encoder", 1, FLAGSHIP_LEVELS, N, 8, 4, 32),
            ("petr_heatmap", 1, FLAGSHIP_LEVELS[:1], n0, 8, 4, 32),
            ("pose_decoder_k17", 1, FLAGSHIP_LEVELS, 300, 8, 17, 32),
            ("pose_decoder_k14", 1, FLAGSHIP_LEVELS, 300, 8, 14, 32)]


def forward_record(case, v, levels, loc, attn, rel_tol, ms_deform_attn,
                   ms_deform_attn_torch):
    """One forward case: kernel vs plain at ``rel_tol`` of max|out|, both
    timed, with the bound."""
    import torch
    got = ms_deform_attn(v, levels, loc, attn, impl="cuda").float()
    torch.cuda.synchronize()
    want = ms_deform_attn_torch(v.float(), levels, loc, attn)
    err = (got - want).abs().max().item()
    tol = rel_tol * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"msda fwd {case} {v.dtype}: max abs err {err} "
                             f"> {tol}")
    bound_ms, bound_by = msda_bound(False, v, levels, loc)
    B, _, H, D = v.shape
    _, Q, _, L, P, _ = loc.shape
    rec = dict(case=case, dtype=str(v.dtype).replace("torch.", ""), B=B,
               Q=Q, H=H, L=L, P=P, D=D, max_abs_err=err, tol=tol,
               ms=cuda_ms(lambda: ms_deform_attn(v, levels, loc, attn,
                                                 impl="cuda")),
               plain_ms=cuda_ms(lambda: ms_deform_attn(v, levels, loc, attn,
                                                       impl="torch")),
               bound_ms=bound_ms, bound_by=bound_by)
    print("kernel fwd", json.dumps(rec), flush=True)
    return rec


def check_forward(ms_deform_attn, ms_deform_attn_torch, captured):
    """Forward kernel vs plain on uniform-random inputs at each main-path
    shape and on the captured in-model calls, f32 and bf16; returns
    per-case records."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for name, B, levels, Q, H, P, D in kernel_cases():
        for dtype, rel_tol in MSDA_FWD_TOL:
            v, loc, attn = msda_inputs(gen, B, levels, Q, H, P, D,
                                       getattr(torch, dtype))
            records.append(forward_record(name, v, levels, loc, attn,
                                          rel_tol, ms_deform_attn,
                                          ms_deform_attn_torch))
    for name, v, levels, loc, attn in captured:
        for dtype, rel_tol in MSDA_FWD_TOL:
            records.append(forward_record(name, v.to(getattr(torch, dtype)),
                                          levels, loc, attn, rel_tol,
                                          ms_deform_attn,
                                          ms_deform_attn_torch))
    return records


def backward_record(case, ext, v, levels, loc, attn, g, rel_tol,
                    ms_deform_attn_torch):
    """One backward case: kernel vs autograd of the plain version at
    ``rel_tol`` of each gradient's max; grad_loc is compared away from
    pixel boundaries (within 1e-3 px of an integer coordinate the
    derivative jumps, and the two versions round the coordinate
    differently)."""
    import torch
    got = ext.msda_bwd(v, levels, loc, attn, g)
    torch.cuda.synchronize()
    inputs = [t.float().requires_grad_() for t in (v, loc, attn)]
    out = ms_deform_attn_torch(inputs[0], levels, *inputs[1:])
    want = torch.autograd.grad(out, inputs, g, retain_graph=True)
    x, y, _ = pixel_coords(loc, levels)
    smooth = (((x - x.round()).abs() > 1e-3)
              & ((y - y.round()).abs() > 1e-3))[..., None]
    errs = {}
    for k, a, b in zip(("value", "loc", "attn"), got, want):
        diff = (a.float() - b).abs()
        if k == "loc":
            diff = diff * smooth
        tol = rel_tol * b.abs().max().item()
        errs[k] = diff.max().item()
        if not errs[k] <= tol:
            raise AssertionError(f"msda bwd {case} {v.dtype} grad_{k}: max "
                                 f"abs err {errs[k]} > {tol}")
    bound_ms, bound_by = msda_bound(True, v, levels, loc)
    B, _, H, D = v.shape
    _, Q, _, L, P, _ = loc.shape
    rec = dict(case=case, dtype=str(v.dtype).replace("torch.", ""), B=B,
               Q=Q, H=H, L=L, P=P, D=D, max_abs_err=max(errs.values()),
               errs=errs, rel_tol=rel_tol,
               ms=cuda_ms(lambda: ext.msda_bwd(v, levels, loc, attn, g)),
               plain_ms=cuda_ms(lambda: torch.autograd.grad(
                   out, inputs, g, retain_graph=True)),
               bound_ms=bound_ms, bound_by=bound_by,
               loc_taps_near_boundary=int((~smooth).sum().item()))
    print("kernel bwd", json.dumps(rec), flush=True)
    return rec


def check_backward(ext, ms_deform_attn_torch, captured):
    """Backward kernel vs autograd of the plain version on uniform-random
    inputs at the main-path shapes that train and on the captured in-model
    calls (g from a seeded generator), f32 and bf16; returns per-case
    records."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    records = []
    for name, B, levels, Q, H, P, D in kernel_cases():
        if name == "joint_decoder":       # serving only: no backward
            continue
        for dtype, rel_tol in MSDA_BWD_TOL:
            v, loc, attn = msda_inputs(gen, B, levels, Q, H, P, D,
                                       getattr(torch, dtype))
            g = torch.randn(B, Q, H * D, device="cuda", generator=gen)
            records.append(backward_record(name, ext, v, levels, loc, attn,
                                           g, rel_tol, ms_deform_attn_torch))
    for name, v, levels, loc, attn in captured:
        B, _, H, D = v.shape
        g = torch.randn(B, loc.shape[1], H * D, device="cuda", generator=gen)
        for dtype, rel_tol in MSDA_BWD_TOL:
            records.append(backward_record(name, ext,
                                           v.to(getattr(torch, dtype)),
                                           levels, loc, attn, g, rel_tol,
                                           ms_deform_attn_torch))
    return records


def capture_in_model(config=CONFIG, prefix=""):
    """The inputs of every msda call of one ``forward_test`` of ``config``
    (seed 0, the first timed synthetic clip in the 800x1344 bucket), run on
    the plain path so that no kernel takes part: ``[(name, value, levels,
    loc, attn)]``, named ``prefix`` + encoder0-5, pose_decoder0-2,
    joint_decoder0-1 in call order (the pose decoder's P is K)."""
    import torch
    from pavenet_tpu_torch.apis import init_detector
    from pavenet_tpu_torch.apis.inference import host_batch
    from pavenet_tpu_torch.models.attention import deformable

    model = init_detector(str(ROOT / config), device="cuda", seed=0,
                          impl="torch")
    T = model.num_frames
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in host_batch(synthetic_clips(frames=T)[1], T,
                                    (1333, 800)).items()}
    calls, dispatch = [], deformable.ms_deform_attn

    def record(value, shapes, loc, attn, **kw):
        calls.append((value.detach().clone(), tuple(map(tuple, shapes)),
                      loc.detach().float().clone(),
                      attn.detach().float().clone()))
        return dispatch(value, shapes, loc, attn, **kw)

    deformable.ms_deform_attn = record
    try:
        with torch.no_grad():
            model.forward_test(batch)
    finally:
        deformable.ms_deform_attn = dispatch
    if len(calls) != CALLS_PER_CLIP:
        raise AssertionError(f"{len(calls)} msda calls in one forward_test")
    captured, seen = [], {}
    for v, levels, loc, attn in calls:
        kind = ("encoder" if loc.shape[1] == v.shape[1] else
                "pose_decoder" if loc.shape[4] == model.num_keypoints
                else "joint_decoder")
        captured.append((f"{prefix}{kind}{seen.get(kind, 0)}", v, levels,
                         loc, attn))
        seen[kind] = seen.get(kind, 0) + 1
    del model
    torch.cuda.empty_cache()
    return captured


def probe_inputs(captured):
    """The encoder calls the probes and the parent comparison time: the
    first captured encoder call and the uniform-random encoder case of the
    kernel checks (the same generator seeds), f32, each as ``((v, loc,
    attn), (v, loc, attn, g), levels)``, forward and backward inputs."""
    import torch
    _, B, levels, Q, H, P, D = kernel_cases()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd = msda_inputs(gen, B, levels, Q, H, P, D, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    bwd = msda_inputs(gen, B, levels, Q, H, P, D, torch.float32)
    g = torch.randn(B, Q, H * D, device="cuda", generator=gen)
    _, v, in_levels, loc, attn = captured[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    g_in = torch.randn(B, Q, H * D, device="cuda", generator=gen)
    return {"in_model": ((v, loc, attn), (v, loc, attn, g_in), in_levels),
            "random": (fwd, (*bwd, g), levels)}


def check_probes(ext, captured):
    """What bounds each msda kernel at the encoder call, in-model and
    random, f32 and bf16: the kernel through its C entry (plan as the
    wrapper makes it), its empty-body twin (same arguments and grid: the
    launch and operand floor), the forward without its corner loads, the
    forward with every query of a block on its first query's locations
    (perfect row sharing: the counterpart of the TPU merged-window probe,
    what locality can still buy), the backward without its grad_value
    reductions (all of them, those into the shared table, those made
    directly) and without its per-tap sums, and the kernel with nothing
    staged in shared memory; plus the wrapper's host checks and plan per
    call. The ablation entry points are wrong on purpose and only this
    phase calls them. Returns records."""
    import ctypes
    import torch
    fwd_lib, bwd_lib = ext._load("msda_fwd"), ext._load("msda_bwd")
    for lib, name in ((fwd_lib, "msda_fwd"), (bwd_lib, "msda_bwd")):
        fn = getattr(lib, f"{name}_ablate")
        fn.argtypes = ext._ARGTYPES[name][:-1] + [ctypes.c_int,
                                                  ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def timed(fn, *args):
        def run():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
        return cuda_ms(run)

    records = []
    for inputs, (fwd_in, bwd_in, levels) in probe_inputs(captured).items():
        for dtype in (torch.float32, torch.bfloat16):
            v, loc, attn = fwd_in
            v = v.to(dtype)
            B, _, H, D = v.shape
            out = torch.empty(B, loc.shape[1], H * D, dtype=dtype,
                              device="cuda")
            ptrs = [t.data_ptr() for t in (v, loc, attn, out)]
            args = ext.msda_args("msda_fwd", v, levels, loc, attn)
            bare = ext.msda_args("msda_fwd", v, levels, loc, attn,
                                 smem_bytes=0)
            reps = 200
            t0 = time.perf_counter()
            for _ in range(reps):
                ext.msda_args("msda_fwd", v, levels, loc, attn)
            host_us = (time.perf_counter() - t0) / reps * 1e6
            rec = dict(inputs=inputs, dtype=str(dtype).replace("torch.", ""),
                       fwd_ms=timed(fwd_lib.msda_fwd, *ptrs, *args),
                       fwd_empty_ms=timed(fwd_lib.msda_fwd_ablate, *ptrs,
                                          *args, 1),
                       fwd_no_loads_ms=timed(fwd_lib.msda_fwd_ablate, *ptrs,
                                             *args, 2),
                       fwd_merged_ms=timed(fwd_lib.msda_fwd_ablate, *ptrs,
                                           *args, 7),
                       fwd_unstaged_ms=timed(fwd_lib.msda_fwd, *ptrs, *bare),
                       fwd_host_us=host_us)
            v, loc, attn, g = bwd_in
            v = v.to(dtype)
            grads = [torch.zeros(v.shape, device="cuda"),
                     torch.empty_like(loc), torch.empty_like(attn)]
            ptrs = [t.data_ptr() for t in (v, loc, attn, g, *grads)]
            args = ext.msda_args("msda_bwd", v, levels, loc, attn,
                                 backward=True)
            bare = ext.msda_args("msda_bwd", v, levels, loc, attn,
                                 backward=True, smem_bytes=0)
            rec.update(bwd_ms=timed(bwd_lib.msda_bwd, *ptrs, *args),
                       bwd_empty_ms=timed(bwd_lib.msda_bwd_ablate, *ptrs,
                                          *args, 1),
                       bwd_no_scatter_ms=timed(bwd_lib.msda_bwd_ablate,
                                               *ptrs, *args, 3),
                       bwd_no_shared_ms=timed(bwd_lib.msda_bwd_ablate,
                                              *ptrs, *args, 5),
                       bwd_no_direct_ms=timed(bwd_lib.msda_bwd_ablate,
                                              *ptrs, *args, 6),
                       bwd_no_sums_ms=timed(bwd_lib.msda_bwd_ablate, *ptrs,
                                            *args, 4),
                       bwd_unstaged_ms=timed(bwd_lib.msda_bwd, *ptrs, *bare))
            print("probe", json.dumps(rec), flush=True)
            records.append(rec)
    return records


def compare_parent(ext, parent, captured):
    """An earlier commit's msda kernels (built from ``parent``'s own
    ``csrc/`` by its own loader, whose wrappers take the level table as
    (L, 2) shapes and (L,) level-start int32 tensors on the card) against
    this tree's on the same encoder inputs, in turns: parent, this, this,
    parent; wrappers called directly, f32. Returns records."""
    import importlib.util
    import torch
    spec = importlib.util.spec_from_file_location(
        "parent_ext", Path(parent) / "pavenet_tpu_torch/ops/_ext.py")
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    for name, seconds in old.build_all(("msda_fwd", "msda_bwd")).items():
        print(f"build: parent csrc/{name}.cu in {seconds:.2f} s", flush=True)
    records = []
    for inputs, (fwd_in, bwd_in, levels) in probe_inputs(captured).items():
        starts = [0]
        for h, w in levels[:-1]:
            starts.append(starts[-1] + h * w)
        shapes = torch.tensor(levels, dtype=torch.int32, device="cuda")
        level_start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        v, loc, attn = fwd_in
        runs = {"fwd": (lambda: old.msda_fwd(v, shapes, level_start, loc,
                                             attn),
                        lambda: ext.msda_fwd(v, levels, loc, attn))}
        bv, bloc, battn, g = bwd_in
        runs["bwd"] = (lambda: old.msda_bwd(bv, shapes, level_start, bloc,
                                            battn, g),
                       lambda: ext.msda_bwd(bv, levels, bloc, battn, g))
        rec = dict(inputs=inputs, dtype="float32")
        for key, (parent_fn, this_fn) in runs.items():
            a, b = parent_fn(), this_fn()
            torch.cuda.synchronize()
            # out, or grad_value and grad_attn (grad_loc jumps at pixel
            # boundaries, where the two may round differently)
            pairs = [(a, b)] if key == "fwd" else [(a[0], b[0]), (a[2], b[2])]
            rec[f"{key}_max_abs_diff"] = max(
                (x - y).abs().max().item() for x, y in pairs)
            times = [cuda_ms(f) for f in (parent_fn, this_fn, this_fn,
                                          parent_fn)]
            rec[f"{key}_parent_ms"] = (times[0] + times[3]) / 2
            rec[f"{key}_ms"] = (times[1] + times[2]) / 2
            rec[f"{key}_times"] = times
        print("parent", json.dumps(rec), flush=True)
        records.append(rec)
    return records


def window_cases():
    """(name, levels (Hl, Wl), B, C, heads, shift) of the window-attention
    launches, each one call over its levels as an encoder layer makes it:
    the four flagship level rasters unshifted and shifted, an edge level
    smaller than one window, head size 8 (C=64, 8 heads) at the tiny
    windowed config's levels, and head sizes 16 and 64 (C=128, 512) at the
    flagship levels."""
    return [("layer", FLAGSHIP_LEVELS, 3, 256, 8, False),
            ("layer_shifted", FLAGSHIP_LEVELS, 3, 256, 8, True),
            ("edge", (EDGE_WINDOW_LEVEL,), 3, 256, 8, False),
            ("d8", TINY_LEVELS, 2, 64, 8, True),
            ("d16", FLAGSHIP_LEVELS, 3, 128, 8, False),
            ("d64", FLAGSHIP_LEVELS, 3, 512, 8, False)]


def window_inputs(gen, level, B, C, shift, dtype):
    """Padded rasters q, k, v and the keep mask of one level, as the
    windowed encoder builds them: bucket padding from IMG_SHAPE, window
    padding, the half-window roll when ``shift``; plus one fully masked
    window (batch 0, the first window)."""
    import torch
    Hl, Wl = level
    wh, ww = WINDOW
    Hp, Wp = -(-Hl // wh) * wh, -(-Wl // ww) * ww
    rows = torch.arange(Hl, device="cuda") < IMG_SHAPE[0] * Hl / 800
    cols = torch.arange(Wl, device="cuda") < IMG_SHAPE[1] * Wl / 1344
    keep = (rows[:, None] & cols[None, :]).float().expand(B, Hl, Wl)
    if shift:
        keep = torch.roll(keep, (-(wh // 2), -(ww // 2)), dims=(1, 2))
    keep = torch.nn.functional.pad(keep, (0, Wp - Wl, 0, Hp - Hl))
    keep[0, :wh, :ww] = 0.0
    q, k, v = (torch.randn(B, Hp, Wp, C, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    return q, k, v, keep.contiguous()


def window_bound(backward, qs):
    """Least time of one launch over the level rasters ``qs`` on an H100:
    q, k, v (and g) read once, the output(s) written once and keep read
    once over the HBM rate, against the score and value products (two per
    window and head forward, five backward) over the tensor-core rate of
    the dtype: f32 as 3xTF32 (three TF32 products per product), bf16 at its
    own rate. Every window of the padded rasters counts: the function is
    defined on them."""
    import torch
    S = WINDOW[0] * WINDOW[1]
    nbytes = flops = 0
    for q in qs:
        B, Hp, Wp, C = q.shape
        nbytes += ((7 if backward else 4) * q.numel() * q.element_size()
                   + B * Hp * Wp * 4)
        windows = B * (Hp // WINDOW[0]) * (Wp // WINDOW[1])
        flops += windows * (5 if backward else 2) * 2 * S * S * C
    rate = TF32_FLOPS / 3 if qs[0].dtype == torch.float32 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(q, k, v, keep, heads):
    """The partitioned (nW, heads, S, D) layout and an additive float mask
    (0, or -1e9 at masked keys) for the library yardstick; made outside the
    timed window."""
    import torch
    from pavenet_tpu_torch.models.layers.windowed import window_partition
    B, Hp, Wp, C = q.shape

    def part(x):
        w = window_partition(x.reshape(B, Hp * Wp, -1), Hp, Wp, *WINDOW)
        return w.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()

    keep_w = window_partition(keep.reshape(B, Hp * Wp, 1), Hp, Wp,
                              *WINDOW)[..., 0]
    mask = torch.zeros_like(keep_w, dtype=q.dtype).masked_fill(
        keep_w < 0.5, -1e9)[:, None, None, :]
    return [part(x).requires_grad_() for x in (q, k, v)], mask


class Sdpa:
    """The library yardstick on one level: ``scaled_dot_product_attention``
    on the partitioned layout, its output and an output gradient."""

    def __init__(self, gen, q, k, v, keep, heads):
        import torch
        self.ins, self.mask = sdpa_inputs(q, k, v, keep, heads)
        self.out = self()
        self.grad = torch.randn(self.out.shape, device="cuda",
                                generator=gen).to(q.dtype)

    def __call__(self):
        import torch.nn.functional as F
        return F.scaled_dot_product_attention(*self.ins, attn_mask=self.mask)

    def backward(self):
        import torch
        return torch.autograd.grad(self.out, self.ins, self.grad,
                                   retain_graph=True)

    def forward_backward(self):
        import torch
        return torch.autograd.grad(self(), self.ins, self.grad)


def check_window(ext):
    """Window-attention forward and backward kernels, one launch over each
    case's levels, against the plain version (forward) and autograd of it
    (backward) level by level, f32 and bf16; times of kernel, plain (a loop
    over the levels), SDPA (its level calls in turn) and the bound. For the
    flagship layer also a per-level breakdown (one-level launches). Returns
    (forward records, backward records, per-level records)."""
    import torch
    from pavenet_tpu_torch.ops.window_attn import window_attention_torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    fwd, bwd, per_level = [], [], []
    for name, levels, B, C, heads, shift in window_cases():
        for dtype, fwd_tol, bwd_tol in ((torch.float32, 1e-5, 1e-4),
                                        (torch.bfloat16, 2e-2, 2e-2)):
            qs, ks, vs, keeps = map(list, zip(*(
                window_inputs(gen, lv, B, C, shift, dtype) for lv in levels)))
            gs = [torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
                  for q in qs]
            base = dict(case=name, levels=[list(lv) for lv in levels],
                        rasters=[list(q.shape[1:3]) for q in qs], shift=shift,
                        dtype=str(dtype).replace("torch.", ""), B=B, C=C,
                        heads=heads)
            got = ext.window_attn_fwd(qs, ks, vs, keeps, heads)
            torch.cuda.synchronize()
            ins = [[x.float().requires_grad_() for x in lv]
                   for lv in zip(qs, ks, vs)]
            want = [window_attention_torch(*x, keep, heads)
                    for x, keep in zip(ins, keeps)]
            err = 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                e = (a.float() - b).abs().max().item()
                tol = fwd_tol * b.abs().max().item()
                if not e <= tol:
                    raise AssertionError(f"window fwd {name} level {i} "
                                         f"{dtype}: max abs err {e} > {tol}")
                err = max(err, e)
            sdpa = [Sdpa(gen, *lv, heads) for lv in zip(qs, ks, vs, keeps)]
            bound_ms, bound_by = window_bound(False, qs)
            rec = dict(base, max_abs_err=err, rel_tol=fwd_tol,
                       ms=cuda_ms(lambda: ext.window_attn_fwd(
                           qs, ks, vs, keeps, heads)),
                       plain_ms=cuda_ms(lambda: [
                           window_attention_torch(*lv, heads)
                           for lv in zip(qs, ks, vs, keeps)]),
                       library_ms=cuda_ms(lambda: [f() for f in sdpa]),
                       library_fwd_bwd_ms=cuda_ms(lambda: [
                           f.forward_backward() for f in sdpa]),
                       bound_ms=bound_ms, bound_by=bound_by)
            print("window fwd", json.dumps(rec), flush=True)
            fwd.append(rec)

            got = ext.window_attn_bwd(qs, ks, vs, keeps, gs, heads)
            torch.cuda.synchronize()
            flat = [x for lv in ins for x in lv]
            grads = torch.autograd.grad(want, flat, [g.float() for g in gs],
                                        retain_graph=True)
            errs = {}
            for i in range(len(qs)):
                for j, key in enumerate(("dq", "dk", "dv")):
                    a, b = got[j][i], grads[3 * i + j]
                    e = (a.float() - b).abs().max().item()
                    tol = bwd_tol * b.abs().max().item()
                    if not e <= tol:
                        raise AssertionError(f"window bwd {name} level {i} "
                                             f"{dtype} {key}: max abs err "
                                             f"{e} > {tol}")
                    errs[key] = max(errs.get(key, 0.0), e)
            bound_ms, bound_by = window_bound(True, qs)
            rec = dict(base, max_abs_err=max(errs.values()), errs=errs,
                       rel_tol=bwd_tol,
                       ms=cuda_ms(lambda: ext.window_attn_bwd(
                           qs, ks, vs, keeps, gs, heads)),
                       plain_ms=cuda_ms(lambda: torch.autograd.grad(
                           want, flat, [g.float() for g in gs],
                           retain_graph=True)),
                       library_ms=cuda_ms(lambda: [f.backward()
                                                   for f in sdpa]),
                       bound_ms=bound_ms, bound_by=bound_by)
            print("window bwd", json.dumps(rec), flush=True)
            bwd.append(rec)
            if name != "layer":
                continue
            for i, lv in enumerate(zip(qs, ks, vs, keeps)):
                one = [[x] for x in lv]
                rec = dict(case=f"level{i}", level=list(levels[i]),
                           raster=list(qs[i].shape[1:3]), dtype=base["dtype"],
                           fwd_ms=cuda_ms(lambda: ext.window_attn_fwd(
                               *one, heads)),
                           fwd_sdpa_ms=cuda_ms(sdpa[i]),
                           fwd_bound_ms=window_bound(False, one[0])[0],
                           bwd_ms=cuda_ms(lambda: ext.window_attn_bwd(
                               *one, [gs[i]], heads)),
                           bwd_sdpa_ms=cuda_ms(sdpa[i].backward),
                           bwd_bound_ms=window_bound(True, one[0])[0])
                print("window level", json.dumps(rec), flush=True)
                per_level.append(rec)
    return fwd, bwd, per_level


def synthetic_clips(seed=0, frames=3):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, 256, (720, 1280, 3), dtype=np.uint8)
             for _ in range(frames)] for _ in range(CLIPS + 1)]


def check_detections(out, M=20, K=15, keep_all=False):
    """Shapes and finite values of one clip's detections; ``keep_all``: no
    NMS (PETR), every detection kept with unit keypoint scores."""
    import numpy as np
    shapes = {k: out[k].shape for k in ("det_kpts", "det_bboxes", "keep")}
    if shapes != {"det_kpts": (M, K, 3), "det_bboxes": (M, 5), "keep": (M,)}:
        raise AssertionError(f"unexpected output shapes {shapes}")
    for k in ("det_kpts", "det_bboxes"):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f"{k} has non-finite values")
    if keep_all and not (out["keep"].all()
                         and (out["det_kpts"][..., 2] == 1).all()):
        raise AssertionError("PETR detections: keep not all True or "
                             "keypoint scores not 1")


def reset_launches():
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from pavenet_tpu_torch.ops.window_attn import window_attention_levels
    for fn in (ms_deform_attn, window_attention_levels):
        fn.launches = fn.backward_launches = 0
        fn.bf16_launches = fn.bf16_backward_launches = 0


def read_launches():
    """Kernel launches since ``reset_launches``, by kernel, and those of
    them that took bf16 values (``*_bf16``)."""
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from pavenet_tpu_torch.ops.window_attn import window_attention_levels
    out = {}
    for name, fn in (("msda", ms_deform_attn),
                     ("window_attn", window_attention_levels)):
        out.update({f"{name}_fwd": fn.launches,
                    f"{name}_bwd": fn.backward_launches,
                    f"{name}_fwd_bf16": fn.bf16_launches,
                    f"{name}_bwd_bf16": fn.bf16_backward_launches})
    return out


def expect(per_step, dtype):
    """Expected launches per clip or step: in bf16 every launch is a bf16
    one."""
    if dtype != "bf16":
        return per_step
    return {**per_step, **{f"{k}_bf16": v for k, v in per_step.items()}}


def check_launches(what, got, per_step, steps):
    want = {k: per_step.get(k, 0) * steps for k in got}
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")


def tf32(on):
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False


def serve(smi, config, per_clip, dtype="f32"):
    """Serving in ``dtype`` and its cuda-vs-torch parity on ``config``;
    returns the serving run's launches and ms/clip."""
    import torch
    from pavenet_tpu_torch.apis import inference_detector, init_detector
    from pavenet_tpu_torch.apis.inference import host_batch

    model = init_detector(str(ROOT / config), device="cuda", seed=0,
                          dtype=dtype)
    T = model.num_frames
    shape = dict(M=model.max_per_img, K=model.num_keypoints,
                 keep_all=not model.with_nms)
    clips = synthetic_clips(frames=T)
    check_detections(inference_detector(model, clips[0]), **shape)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [inference_detector(model, clip) for clip in clips[1:]]
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    clip_ms = start.elapsed_time(end) / CLIPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for out in outs:
        check_detections(out, **shape)
    check_launches(f"serve {config} {dtype}, {CLIPS} clips", launches,
                   expect(per_clip, dtype), CLIPS)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in host_batch(clips[1], T, (1333, 800)).items()}
    model_ms = cuda_ms(lambda: model.forward_test(batch), reps=5, warmup=1)
    print(f"serve {config}: {CLIPS} clips of T={T} at "
          f"{tuple(batch['img'].shape[2:4])}, {dtype}, launches "
          f"{json.dumps(launches)}; {clip_ms:.2f} ms/clip end to end (host "
          f"pipeline included), {model_ms:.2f} ms/clip forward_test; peak "
          f"memory {peak_gb:.2f} GiB | {smi}", flush=True)

    serve_parity(config, model, batch, dtype)
    return launches, model_ms


def serve_parity(config, model, batch, dtype):
    """Full-model parity, TF32 off: a plain model with ``model``'s weights
    (``impl='torch'``) against ``model``'s kernels on ``batch``; returns
    the plain model."""
    from pavenet_tpu_torch.apis import init_detector
    tf32(False)
    plain = init_detector(str(ROOT / config), device="cuda", impl="torch",
                          dtype=dtype)
    plain.load_state_dict(model.state_dict())
    if dtype == "bf16":
        serve_parity_bf16(config, model, plain, batch)
    else:
        serve_parity_f32(config, model, plain, batch)
    tf32(True)
    return plain


def forward_kwargs(batch):
    """The batch's keys ``forward_outputs`` takes beside the images:
    DK-DETR's ``text_feats``."""
    return {k: batch[k] for k in ("text_feats",) if k in batch}


def serve_parity_f32(config, model, plain, batch):
    """f32 serving, kernels against the plain path, both on the plain
    path's top-k proposals (and SOIT's on its detections, ``det_idx``):
    keypoints within 1e-2 px and the keep mask equal; SOIT's boxes, scores
    and mask probabilities within ``SOIT_TOL`` and the labels equal. Where
    the kernels' own top-k differs from the plain path's, the difference
    must be a tie to rounding: the encoder's proposal scores of the two
    paths within 1e-5 of their largest, and at every rank the two
    selections' plain scores as close (the decoder's query slots carry
    learned embeddings, so two proposals that swap places change both
    slots' outputs)."""
    import torch
    fwd = forward_kwargs(batch)
    det = hasattr(plain, "select_detections")
    with torch.inference_mode():
        want_outs = plain.forward_outputs(batch["img"], batch["img_shape"],
                                          **fwd)
        own_outs = model.forward_outputs(batch["img"], batch["img_shape"],
                                         **fwd)
        pin = dict(topk_idx=want_outs["topk_idx"])
        if det:
            pin["det_idx"] = plain.select_detections(want_outs)[1]
        got = model.forward_test(batch, **pin)
        want = plain.forward_test(batch, **pin)
    same, score_err, rank_gap = topk_tie(own_outs, want_outs)
    if det:
        errs = dict(
            boxes=(got["det_bboxes"][..., :4]
                   - want["det_bboxes"][..., :4]).abs().max().item(),
            scores=(got["det_bboxes"][..., 4]
                    - want["det_bboxes"][..., 4]).abs().max().item(),
            masks=(got["det_masks"] - want["det_masks"]).abs().max().item())
        limits, equal = SOIT_TOL, ("labels", torch.equal(
            got["det_labels"], want["det_labels"]))
    else:
        errs = dict(det_kpts=(got["det_kpts"][..., :2]
                              - want["det_kpts"][..., :2]).abs().max().item())
        limits, equal = dict(det_kpts=1e-2), ("keep", torch.equal(
            got["keep"], want["keep"]) and (model.with_nms
                                             or bool(got["keep"].all())))
    if not (all(errs[k] <= limits[k] for k in errs) and equal[1]
            and score_err <= 1e-5 and rank_gap <= 1e-5):
        raise AssertionError(
            f"cuda vs torch model {config}: max abs errors {errs} (limits "
            f"{limits}), {equal[0]} equal {equal[1]}; proposal scores "
            f"{score_err}, own top-k {'equal' if same else 'differs'}, rank "
            f"score gap {rank_gap}")
    print(f"parity {config}: impl=cuda vs impl=torch on the full model, "
          f"TF32 off, on the plain path's "
          f"{'proposals and detections' if det else 'top-k'}: max abs err "
          f"{json.dumps(errs)} (limits {json.dumps(limits)}), {equal[0]} "
          f"equal; proposal scores within {score_err:.3e}; the kernels' own "
          f"top-k "
          f"{'equal' if same else f'a tie (rank score gap {rank_gap:.3e})'}",
          flush=True)


def topk_tie(own_outs, want_outs):
    """Whether the kernels' own top-k proposals equal the plain path's,
    the two paths' proposal scores apart (max abs error over the plain
    path's largest), and at each rank the gap between the plain scores of
    the two selections (over the same largest): both near 0 when the two
    selections differ only by a tie to rounding."""
    import torch
    own, topk = own_outs["topk_idx"], want_outs["topk_idx"]
    scores = want_outs["enc_cls_scores"][..., 0].float()
    rank_gap = ((scores.gather(1, own) - scores.gather(1, topk)).abs().max()
                / scores.abs().max()).item()
    return (torch.equal(own, topk),
            rel_err(own_outs["enc_cls_scores"], want_outs["enc_cls_scores"]),
            rank_gap)


def rel_err(a, b):
    """max |a - b| over max |b|, in f32."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def serve_parity_bf16(config, model, plain, batch):
    """bf16 serving, kernels against the plain path, stage by stage: the
    encoder memory and proposal scores; the decoder given the plain path's
    top-k (bf16 proposal scores tie, and a tie decided the other way
    changes the queries, not the kernels' error); then PAVE-Net's and
    PETR's joint decoder on the plain path's best ``max_per_img`` poses,
    or SOIT's boxes and masks on the plain path's detections. Each within
    ``BF16_STAGE_TOL`` of the plain output's largest value."""
    import torch
    fwd = forward_kwargs(batch)
    det = hasattr(plain, "select_detections")
    with torch.inference_mode():
        want = plain.forward_outputs(batch["img"], batch["img_shape"], **fwd)
        own = model.forward_outputs(batch["img"], batch["img_shape"], **fwd)
        got = model.forward_outputs(batch["img"], batch["img_shape"],
                                    topk_idx=want["topk_idx"], **fwd)
        if det:
            keys = ("memory", "mask_feat", "enc_cls_scores",
                    "all_cls_scores", "all_bbox_preds", "all_dyn_params")
            pin = dict(topk_idx=want["topk_idx"],
                       det_idx=plain.select_detections(want)[1])
            dets = [m.forward_test(batch, **pin) for m in (model, plain)]
            final = dict(det_bboxes=rel_err(*(d["det_bboxes"][..., :4]
                                              for d in dets)),
                         det_masks=rel_err(*(d["det_masks"] for d in dets)))
        else:
            keys = ("memory", "enc_cls_scores", "all_cls_scores",
                    "all_kpt_preds", "all_sigma_preds", "frame_kpt_preds")
            M = plain.max_per_img
            best = want["all_cls_scores"][-1][..., 0].float().topk(
                M, 1).indices
            frames = want["frame_kpt_preds"]
            B, T = frames.shape[:2]
            ref = torch.gather(frames, 2, best[:, None, :, None].expand(
                B, T, M, frames.shape[-1])).transpose(1, 2)
            refined = [m.head.forward_refine(o["memory"], o["mask_flatten"],
                                             o["valid_ratios"], ref,
                                             o["spatial_shapes"])
                       for m, o in ((model, got), (plain, want))]
            final = {f"refine_{k}": rel_err(a, b) for k, a, b in zip(
                ("kpts", "scores", "sigmas"), *refined)}
    errs = {k: rel_err(got[k], want[k]) for k in keys}
    errs.update(final)
    bad = {k: e for k, e in errs.items() if not e <= BF16_STAGE_TOL}
    if bad:
        raise AssertionError(f"bf16 cuda vs torch {config}: {errs}")
    same = torch.stack([torch.isin(o, w) for o, w in zip(
        own["topk_idx"], want["topk_idx"])]).float().mean().item()
    print(f"parity {config} bf16: impl=cuda vs impl=torch stage by stage, "
          f"max abs err / max |plain|: {json.dumps(errs)} (limit "
          f"{BF16_STAGE_TOL}); the kernels' own top-k shares "
          f"{100 * same:.1f}% of the plain path's selected proposals",
          flush=True)


def train(smi, config, per_step, dtype="f32", hw=(800, 1344),
          batch_size=1, batch_fn=None):
    """``TRAIN_STEPS`` mini-steps (or the config's accumulation, where it
    accumulates more) of ``dummy_clip_batch(train=True)`` at ``hw`` (or of
    ``batch_fn(rng, batch_size, hw)``, a detection batch), in ``dtype``,
    on ``config``: one applied update where the config accumulates 8 (or
    16) mini-steps, eight where it accumulates none.
    Frozen parameters stay, every parameter with a gradient moves, and
    every trainable BatchNorm's running statistics move. Returns the run's
    launches."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis import init_trainer, train_step
    from pavenet_tpu_torch.apis.train import param_labels
    from pavenet_tpu_torch.core.assigner import hungarian_assign
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch

    state = init_trainer(str(ROOT / config), device="cuda", seed=0,
                         dtype=dtype)
    k = state.accumulate_steps
    steps = max(TRAIN_STEPS, k)
    if steps % k:
        raise AssertionError(f"cumulative_iters {k}")
    model = state.model
    labels = param_labels(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = bn_stats(model)
    rng = np.random.RandomState(0)
    batches = [dummy_clip_batch(rng, batch_size, model.num_frames,
                                height=hw[0], width=hw[1],
                                num_keypoints=model.num_keypoints,
                                max_gt=state.max_gt, train=True)
               if batch_fn is None else batch_fn(rng, batch_size, hw)
               for _ in range(steps)]
    # with one update per mini-step: the parameters whose first gradient
    # is well above Adam's eps must move (hooks on the first step only)
    first_grad, hooks = {}, []
    if k == 1:
        hooks = [p.register_hook(lambda g, n=n: first_grad.__setitem__(
            n, g.detach().abs().max())) for n, p in model.named_parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hungarian_assign.seconds = 0.0
    step_ms, wall_s, grads_seen = [], [], None
    for i, batch in enumerate(batches):
        if k > 1 and i == steps - 1:
            # parameters whose clipped mean gradient so far is well above
            # Adam's eps: the update must move them
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(a) for a in state.acc])).item()
            scale = min(1.0, state.grad_clip / norm)
            grads_seen = {n for (n, _), a in zip(model.named_parameters(),
                                                  state.acc)
                          if a.abs().max().item() * scale > 1e-5}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.perf_counter() - t0)
        step_ms.append(start.elapsed_time(end))
        for h in hooks:
            h.remove()
        hooks = []
        bad = {k: v.item() for k, v in losses.items()
               if not torch.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite losses at step {i}: {bad}")
    launches = read_launches()
    match_s = hungarian_assign.seconds
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches(f"train {config} {dtype}, {steps} mini-steps",
                   launches, expect(per_step, dtype), steps)
    if (state.updates, state.mini_step) != (steps // k, 0):
        raise AssertionError(f"{state.updates} updates, mini-step "
                             f"{state.mini_step}: expected {steps // k}")
    if k == 1:
        grads_seen = {n for n, g in first_grad.items() if g.item() > 1e-6}
    # AdamW's first steps move an element by about its group's lr: a
    # tensor must move where that is at least one float32 ulp of one of
    # its elements (a warmup's first lr, 1e-3 of the base, is not, on
    # offset biases of magnitude 4)
    group_lr = {id(q): g["lr"] for g in state.optimizer.param_groups
                for q in g["params"]}
    grads_seen = {n for n, q in model.named_parameters() if n in grads_seen
                  and (before[n].abs() * 2.0 ** -23
                       < group_lr.get(id(q), 0.0)).any()}
    frozen_moved, stuck = [], []
    for n, p in model.named_parameters():
        moved = not torch.equal(before[n], p.detach())
        if labels[n] == "frozen":
            if moved:
                frozen_moved.append(n)
        elif n in grads_seen and not moved:
            stuck.append(n)
    stats_stuck = [n for n, b in stats.items()
                   if torch.equal(b, model.get_buffer(n).float())]
    if frozen_moved or stuck or stats_stuck:
        raise AssertionError(f"frozen parameters changed: {frozen_moved}; "
                             f"parameters with a gradient unchanged: {stuck}"
                             f"; running statistics unchanged: "
                             f"{stats_stuck}")
    n_frozen = sum(v == "frozen" for v in labels.values())
    early = sum(n.startswith(("backbone.conv1", "backbone.bn1",
                              "backbone.layer1_")) for n in grads_seen)
    print(f"train {config} {dtype} losses (last mini-step): "
          + json.dumps({k: round(v.item(), 5) for k, v in losses.items()}),
          flush=True)
    print(f"train {config}: {steps} mini-steps at {hw[0]}x{hw[1]}, "
          f"B={batch_size}, T={model.num_frames}, {dtype}, {state.max_gt} "
          f"GT slots, "
          f"{state.updates} applied update(s); launches "
          f"{json.dumps(launches)}; "
          f"{statistics.median(step_ms[1:]):.2f} ms/step (median of steps "
          f"2-{steps}, CUDA events; {min(step_ms[1:]):.2f}-"
          f"{max(step_ms[1:]):.2f}); matching on the host "
          f"{match_s * 1e3 / steps:.2f} ms/step = "
          f"{100 * match_s / sum(wall_s):.2f}% of the wall time; peak "
          f"memory {peak_gb:.2f} GiB; {n_frozen} frozen tensors unchanged, "
          f"all {len(grads_seen)} of {len(before) - n_frozen} trained tensors "
          f"with a clear gradient changed ({early} in the stem and layer1), "
          f"all {len(stats)} trainable BatchNorm statistics changed | {smi}",
          flush=True)
    return launches, statistics.median(step_ms[1:])


def bn_stats(model):
    """Trainable BatchNorm's running statistics by name, copied, f32."""
    from pavenet_tpu_torch.models.backbones.resnet import BatchNorm
    return {n: b.detach().float().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))
            and isinstance(model.get_submodule(n.rsplit(".", 1)[0]),
                           BatchNorm)}


def train_parity(config, max_gt=30, dtype="f32", hw=(800, 1344),
                 batch_size=1, fixed_topk=False, limits=(1e-4, 1e-3),
                 batch_fn=None):
    """impl=cuda vs impl=torch on one mini-step of the model as initialised
    from seed 0 (the trained weights depend on the order of the msda
    backward's atomics, so a run would compare other weights each time),
    dropout 0 (eval mode), TF32 off, on ``dummy_clip_batch(train=True)``
    or ``batch_fn(rng, batch_size, hw)``'s detection batch: the same
    matches in every set, the losses within ``limits[0]`` and the gradient
    norm within ``limits[1]`` relative, and trainable BatchNorm's running
    statistics all moved, the two paths' within 1e-5 of their scale.
    ``fixed_topk``: both paths take the plain path's top-k proposals
    (``topk_idx``, taken in train mode with the running statistics put
    back after), so that a near-tie of two proposal scores cannot pick
    other queries; the kernels' own top-k must then equal the plain path's
    or differ by a tie (``topk_tie`` within 1e-5). In bf16 both paths take
    the plain path's top-k and matches (bf16 scores and costs tie), and
    the kernels' own matches are reported. Returns the largest loss
    error."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.apis.train import to_device
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch

    tf32(False)
    cuda_model, plain = (build_model(str(ROOT / config), impl=impl,
                                     dtype=dtype).cuda().eval()
                         for impl in ("cuda", "torch"))
    rng = np.random.RandomState(1)
    batch = to_device(dummy_clip_batch(
        rng, batch_size, plain.num_frames, height=hw[0], width=hw[1],
        num_keypoints=plain.num_keypoints, max_gt=max_gt, train=True)
        if batch_fn is None else batch_fn(rng, batch_size, hw), "cuda")
    fwd = forward_kwargs(batch)
    bf16 = dtype == "bf16"
    before = bn_stats(plain)
    topk, tie = None, None
    if fixed_topk or bf16:
        with torch.no_grad():
            want_outs = plain.forward_outputs(batch["img"],
                                              batch["img_shape"], train=True,
                                              **fwd)
            topk = want_outs["topk_idx"]
            if not bf16:   # the kernels' own top-k: equal, or a tie
                tie = topk_tie(cuda_model.forward_outputs(
                    batch["img"], batch["img_shape"], train=True, **fwd),
                    want_outs)
                if not (tie[1] <= 1e-5 and tie[2] <= 1e-5):
                    raise AssertionError(f"cuda vs torch {config}: the "
                                         f"kernels' own top-k is no tie: "
                                         f"{tie}")
        del want_outs
        for m in (plain, cuda_model):
            for n, b in before.items():
                m.get_buffer(n).copy_(b)
    results, outs, used = {}, {}, {}
    for name, model in (("torch", plain), ("cuda", cuda_model)):
        with torch.no_grad():
            outs[name] = model.forward_outputs(batch["img"],
                                               batch["img_shape"],
                                               topk_idx=topk, **fwd)
            own = model.match(outs[name], batch) if bf16 else None
        match = model.match

        def record(o, b, name=name, match=match):
            """The matches the loss uses: in bf16 the plain path's."""
            used[name] = (used["torch"] if bf16 and name == "cuda"
                          else match(o, b))
            return used[name]
        model.match = record
        model.zero_grad(set_to_none=True)
        losses = model.forward_train(batch, topk_idx=topk)
        losses["loss"].backward()
        del model.match
        norm = torch.linalg.vector_norm(torch.stack([
            p.grad.norm() for p in model.parameters() if p.grad is not None]))
        results[name] = ([getattr(t, "query_idx", t)
                          for t in (own if bf16 else used[name])],
                         {k: v.item() for k, v in losses.items()},
                         norm.item(), bn_stats(model))
        model.zero_grad(set_to_none=True)
    (idx_c, loss_c, norm_c, st_c), (idx_t, loss_t, norm_t, st_t) = (
        results["cuda"], results["torch"])
    same = all(torch.equal(a, b) for a, b in zip(idx_c, idx_t))
    if not same and not bf16:
        raise AssertionError("cuda and torch train steps matched different "
                             "queries")
    # where the two outputs part: the encoder memory, the proposal scores
    # (before top-k), the top-k proposals (init_reference) and the last
    # decoder layer's scores, as max abs error over max abs value
    parts = {k: rel_err(outs["cuda"][k], outs["torch"][k])
             for k in ("memory", "enc_cls_scores", "init_reference",
                       "all_cls_scores") if k in outs["torch"]}
    rel = {k: abs(loss_c[k] - loss_t[k]) / abs(loss_t[k]) for k in loss_t}
    worst = max(rel, key=rel.get)
    bad = {k: r for k, r in rel.items() if not r <= limits[0]}
    norm_rel = abs(norm_c - norm_t) / norm_t
    st_err = max([rel_err(st_c[n], st_t[n]) for n in st_t] + [0.0])
    moved = sum(not torch.equal(st_t[n], before[n]) for n in st_t)
    if (bad or not norm_rel <= limits[1] or not st_err <= 1e-5
            or moved != len(st_t)):
        raise AssertionError(f"cuda vs torch train step: loss rel errors "
                             f"{rel}, grad norm {norm_c} vs {norm_t}; "
                             f"running statistics {st_err} ({moved} of "
                             f"{len(st_t)} moved); outputs {parts}")
    how = ("both on the plain path's top-k and matches" if bf16 else
           "both on the plain path's top-k (the kernels' own "
           + ("equal" if tie[0] else f"a tie: proposal scores within "
              f"{tie[1]:.3e}, rank score gap {tie[2]:.3e}") + ")"
           if fixed_topk else "each path its own top-k")
    print(f"train parity {config} {dtype}: impl=cuda vs impl=torch, one "
          f"mini-step at {hw[0]}x{hw[1]}, B={batch_size}, dropout 0, TF32 "
          f"off, {how}: matched queries {'equal' if same else 'differ'} in "
          f"{len(idx_c)} sets (the kernels' own), max loss rel err "
          f"{rel[worst]:.3e} ({worst}) over {len(rel)} losses (limit "
          f"{limits[0]}), grad norm {norm_c:.6g} vs {norm_t:.6g} (rel "
          f"{norm_rel:.3e}, limit {limits[1]}); {len(st_t)} running "
          f"statistics moved, within {st_err:.3e}; outputs "
          f"{json.dumps(parts)}", flush=True)
    del cuda_model, plain, batch, outs
    torch.cuda.empty_cache()
    tf32(True)
    return rel[worst]


def distill(smi):
    """Encoder distillation: the flagship deformable teacher and the
    windowed student, ``DISTILL_STEPS`` steps at 800x1344, B=1; then one
    cuda-vs-torch step. Returns the run's launches."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis import create_distill_state, distill_step
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch

    teacher = build_model(str(ROOT / CONFIG), seed=0).cuda()
    state = create_distill_state(str(ROOT / WINDOWED_CONFIG), teacher,
                                 seed=1)
    student = state.student
    before = {k: v.clone() for k, v in student.state_dict().items()}
    rng = np.random.RandomState(2)
    batches = [dummy_clip_batch(rng) for _ in range(DISTILL_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, mse = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logs = distill_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        mse.append(logs["distill_mse"].item())
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches(f"distill, {DISTILL_STEPS} steps", launches,
                   {"msda_fwd": 6, "window_attn_fwd": WINDOW_CALLS,
                    "window_attn_bwd": WINDOW_CALLS}, DISTILL_STEPS)
    if not all(np.isfinite(mse)):
        raise AssertionError(f"non-finite distill_mse {mse}")
    t_sd = teacher.state_dict()
    copied_moved, enc_moved, enc_stuck = [], 0, []
    for k, v in student.state_dict().items():
        if k.startswith("head.encoder_layer"):
            moved = not torch.equal(v, before[k])
            enc_moved += moved
            if not moved and k.endswith("weight"):
                enc_stuck.append(k)
        elif not torch.equal(v, t_sd[k]):
            copied_moved.append(k)
    if copied_moved or enc_stuck:
        raise AssertionError(f"entries copied from the teacher changed: "
                             f"{copied_moved}; encoder weights unchanged: "
                             f"{enc_stuck}")
    n_enc = sum(k.startswith("head.encoder_layer") for k in before)
    print(f"distill: flagship deformable teacher -> windowed student, "
          f"{DISTILL_STEPS} steps at 800x1344, B=1, f32; launches "
          f"{json.dumps(launches)}; distill_mse "
          f"{', '.join(f'{m:.5g}' for m in mse)}; "
          f"{statistics.median(step_ms[1:]):.2f} ms/step (median of steps "
          f"2-{DISTILL_STEPS}, CUDA events; {min(step_ms[1:]):.2f}-"
          f"{max(step_ms[1:]):.2f}); peak memory {peak_gb:.2f} GiB; "
          f"{len(before) - n_enc} teacher entries bit-identical, "
          f"{enc_moved} of {n_enc} encoder entries changed (every weight) "
          f"| {smi}", flush=True)

    # one step through the kernels and through the plain versions
    tf32(False)
    batch = dummy_clip_batch(np.random.RandomState(3))
    results = []
    for impl in ("cuda", "torch"):
        t_model = build_model(str(ROOT / CONFIG), impl=impl).cuda()
        t_model.load_state_dict(t_sd)
        s_model = build_model(str(ROOT / WINDOWED_CONFIG), impl=impl).cuda()
        s_model.load_state_dict(student.state_dict())
        logs = distill_step(create_distill_state(s_model, t_model), batch)
        results.append({k: v.item() for k, v in logs.items()})
    rel = {k: abs(results[0][k] - results[1][k]) / abs(results[1][k])
           for k in results[1]}
    if not (rel["distill_mse"] <= 1e-5 and rel["distill_rel"] <= 1e-5
            and rel["grad_norm"] <= 1e-3):
        raise AssertionError(f"cuda vs torch distill step: {results}")
    print(f"distill parity: impl=cuda vs impl=torch, one step, TF32 off: "
          f"{json.dumps(results[0])} vs {json.dumps(results[1])}; relative "
          f"errors {json.dumps(rel)}", flush=True)
    tf32(True)
    return launches


def e2e_options():
    """``--cfg-options`` pointing the config's three splits at the
    scenes."""
    return ["--cfg-options"] + [
        f"data.{split}.{key}={CHIP_DATA}/{value}"
        for split, json_name in (("train", "train"), ("val", "val"),
                                 ("test", "val"))
        for key, value in (("ann_file", f"{json_name}.json"),
                           ("img_prefix", ""))]


def tta_flags(flip_test, aug_scales):
    """The test CLI's flags for one of ``TTA_RUNS``."""
    return ((["--flip-test"] if flip_test else [])
            + (["--aug-scales"] + [str(r) for r in aug_scales]
               if aug_scales else []))


def tta_passes(flip_test, aug_scales):
    """Forward passes per clip (each 11 msda launches) under the options."""
    return (2 if flip_test else 1) * max(1, len(aug_scales or ()))


def plain_topk_parity(models, dataset, img_norm, flip_test=False,
                      aug_scales=None):
    """``models["cuda"]`` against ``models["torch"]`` clip by clip, each
    pass that ``run_inference`` makes with the options (one, or one per
    scale and flip) on the plain path's top-k for the clip that the pass
    runs (the flipped one on a flip pass): the pass's keypoints within
    1e-2 px and scores within 1e-5; then the clip's detections
    (``forward_test``'s OKS-NMS, or the passes merged by
    ``merge_aug_detections``, the merge ``forward_test_flip`` makes):
    keep equal, the kept entries' keypoints and scores within the same
    limits. The decoder's query slots carry learned embeddings, so two
    proposal scores tied to float rounding that swap places in the top-k
    change every output of the two slots. Returns the largest gaps and
    how many passes had the same own top-k."""
    import torch
    from pavenet_tpu_torch.apis.test import FEED_KEYS, _rescale_batch
    from pavenet_tpu_torch.apis.train import model_feed
    from pavenet_tpu_torch.datasets import ClipLoader

    tta = bool(flip_test or aug_scales)

    def one_pass(model, feed, flip, topk):
        if tta:
            return model.forward_test_aug(feed, flip=flip, topk_idx=topk)
        out = model.forward_test(feed, topk_idx=topk)
        return dict(out, scores=out["det_bboxes"][..., 4])

    def gaps(got, want, sel=Ellipsis):
        return ((got["det_kpts"][..., :2] - want["det_kpts"][..., :2])[sel]
                .abs().max().item(),
                (got["scores"] - want["scores"])[sel].abs().max().item())

    device = next(models["torch"].parameters()).device
    kpt_err = score_err = 0.0
    own_topk = n_passes = 0
    for batch in ClipLoader(dataset, batch_size=1, shuffle=False,
                            drop_last=False,
                            num_keypoints=dataset.NUM_KEYPOINTS):
        host = {k: batch[k] for k in FEED_KEYS}
        passes = {impl: [] for impl in models}
        with torch.inference_mode():
            for ratio in aug_scales or (1.0,):
                feed = model_feed(_rescale_batch(host, float(ratio)), device,
                                  img_norm)
                for flip in ((False, True) if flip_test else (False,)):
                    seen = models["torch"]._flip_images(feed) if flip else feed
                    topk = {impl: m.forward_outputs(
                        seen["img"], seen["img_shape"])["topk_idx"]
                        for impl, m in models.items()}
                    own_topk += torch.equal(topk["cuda"], topk["torch"])
                    n_passes += 1
                    for impl, m in models.items():
                        passes[impl].append(one_pass(m, feed, flip,
                                                     topk["torch"]))
                    kpt, score = gaps(passes["cuda"][-1],
                                      passes["torch"][-1])
                    kpt_err, score_err = (max(kpt_err, kpt),
                                          max(score_err, score))
            got, want = ({**out, "scores": out["det_bboxes"][..., 4]}
                         for out in (models[impl].merge_aug_detections(
                             passes[impl]) if tta else passes[impl][0]
                             for impl in ("cuda", "torch")))
        if not torch.equal(got["keep"], want["keep"]):
            raise AssertionError(f"cuda vs torch, image {batch['image_id']}"
                                 f": keep {got['keep']} vs {want['keep']}")
        if got["keep"].any():
            kpt, score = gaps(got, want, got["keep"])
            kpt_err, score_err = max(kpt_err, kpt), max(score_err, score)
        if not (kpt_err <= 1e-2 and score_err <= 1e-5):
            raise AssertionError(
                f"cuda vs torch, image {batch['image_id']}, flip_test "
                f"{flip_test}, aug_scales {aug_scales}: keypoints {kpt_err} "
                f"px (limit 1e-2), scores {score_err} (limit 1e-5)")
    return dict(kpt_err=kpt_err, score_err=score_err, own_topk=own_topk,
                passes=n_passes)


def dataset_to_ap(smi):
    """Phase 14: scenes, the train CLI, its resume, the test CLI in f32 and
    bf16, cuda against torch on the checkpoint, and the prep on the card;
    phase 18: the test CLI with flip and multi-scale test-time
    augmentation (cuda against torch), the distillation CLI from the
    checkpoint and the test CLI on its student. Returns the runs'
    launches."""
    import shutil
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.apis.prep import device_prep
    from pavenet_tpu_torch.apis.test import evaluate_dataset, run_inference
    from pavenet_tpu_torch.datasets import ClipLoader, synthetic
    from pavenet_tpu_torch.datasets.pipelines import build_test_pipeline
    from pavenet_tpu_torch.tools import distill as distill_cli
    from pavenet_tpu_torch.tools import test as test_cli
    from pavenet_tpu_torch.tools import train as train_cli
    from pavenet_tpu_torch.utils.checkpoint import restore_variables

    for d in (CHIP_DATA, CHIP_WORK):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.main(["--root", str(CHIP_DATA)] + E2E_SCENES)
    print(f"scenes: {time.perf_counter() - t0:.2f} s to write "
          f"{' '.join(E2E_SCENES)}", flush=True)
    config = str(ROOT / SYNTHETIC_CONFIG)
    opts = e2e_options()
    per_step = {"msda_fwd": CALLS_PER_CLIP, "msda_bwd": CALLS_PER_CLIP}
    runs, trained = {}, {}
    for name, steps in (("e2e_train_f32", ["--max-steps", str(E2E_STEPS)]),
                        ("e2e_resume_f32", ["--auto-resume", "--max-steps",
                                            str(E2E_RESUMED_STEPS)])):
        reset_launches()
        res = train_cli.main([config, "--work-dir", str(CHIP_WORK)] + steps
                             + opts)
        runs[name] = read_launches()
        check_launches(f"{name}, {res['steps_run']} mini-steps", runs[name],
                       per_step, res["steps_run"])
        trained[name] = res
        print(f"{name}: tools.train.main {' '.join(steps)}: step "
              f"{res['steps']}, {res['updates']} updates, next lr "
              f"{res['lr']:.6g}, resumed from {res['resumed_from']}; "
              f"launches {json.dumps(runs[name])}; {res['step_ms']:.2f} ms "
              f"per mini-step (median, host clock, loader wait included), "
              f"data_time {res['data_time_ms']:.2f} ms (median host wait on "
              f"the loader); losses {json.dumps(res['losses'])} | {smi}",
              flush=True)
    first, second = trained["e2e_train_f32"], trained["e2e_resume_f32"]
    # the synthetic recipe: one update per mini-step, linear warmup over 500
    base_lr, warmup, ratio = 1e-4, 500, 0.001
    want_lr = base_lr * (1 - (1 - E2E_RESUMED_STEPS / warmup) * (1 - ratio))
    if not (first["steps"] == first["updates"] == E2E_STEPS
            and second["resumed_from"] == first["checkpoint"]
            and second["steps_run"] == E2E_RESUMED_STEPS - E2E_STEPS
            and second["updates"] == E2E_RESUMED_STEPS
            and abs(second["lr"] - want_lr) <= 1e-12):
        raise AssertionError(f"resume did not continue the run: {first} -> "
                             f"{second}; lr expected {want_lr}")
    ckpt = second["checkpoint"]

    eval_ms = {}
    for dtype in ("f32", "bf16"):
        reset_launches()
        res = test_cli.main([config, ckpt, "--dtype", dtype, "--out",
                             str(CHIP_WORK / f"dets_{dtype}.json")] + opts)
        name = f"e2e_test_{dtype}"
        runs[name] = read_launches()
        check_launches(f"{name}, {res['clips']} clips", runs[name],
                       expect({"msda_fwd": CALLS_PER_CLIP}, dtype),
                       res["clips"])
        eval_ms[dtype] = res["ms_per_clip"]
        print(f"{name}: tools.test.main on {os.path.basename(ckpt)}: "
              f"{res['clips']} clips, {res['detections']} detections, "
              f"launches {json.dumps(runs[name])}; eval loop "
              f"{res['ms_per_clip']:.2f} ms/clip (host pipeline included; "
              f"first clip {res['first_clip_s']:.2f} s); metrics "
              f"{json.dumps(res['metrics'])} | {smi}", flush=True)

    # 18. test-time augmentation: 2 passes per clip (flip), 4 (two scales,
    # each plain and flipped), each pass 11 msda launches
    for tta, flip_test, aug_scales in TTA_RUNS:
        flags = tta_flags(flip_test, aug_scales)
        reset_launches()
        res = test_cli.main([config, ckpt, "--dtype", "f32"] + flags
                            + opts)
        name = f"e2e_test_{tta}"
        runs[name] = read_launches()
        check_launches(f"{name}, {res['clips']} clips", runs[name],
                       {"msda_fwd": tta_passes(flip_test, aug_scales)
                        * CALLS_PER_CLIP}, res["clips"])
        eval_ms[tta] = res["ms_per_clip"]
        print(f"{name}: tools.test.main {' '.join(flags)} on "
              f"{os.path.basename(ckpt)}: {res['clips']} clips, "
              f"{res['detections']} detections, launches "
              f"{json.dumps(runs[name])}; eval loop {res['ms_per_clip']:.2f}"
              f" ms/clip (host pipeline included; first clip "
              f"{res['first_clip_s']:.2f} s); metrics "
              f"{json.dumps(res['metrics'])} | {smi}", flush=True)

    # cuda against torch on the checkpoint, TF32 off: clip by clip on the
    # plain path's top-k, pass by pass (plain_topk_parity); then, as an
    # extra check, the eval loop end to end, each path on its own top-k
    # (Mean AP)
    tf32(False)
    cfg = train_cli.load_config(config, opts[1:])
    kwargs, img_norm = train_cli.eval_pipeline_kwargs(cfg)
    dataset = train_cli.build_dataset(cfg, "test",
                                      build_test_pipeline(**kwargs))
    models, metrics = {}, {}
    for impl in ("cuda", "torch"):
        models[impl] = build_model(cfg, impl=impl).cuda().eval()
        models[impl].load_state_dict(restore_variables(ckpt))
        metrics[impl] = evaluate_dataset(dataset, run_inference(
            models[impl], ClipLoader(dataset, batch_size=1, shuffle=False,
                                     drop_last=False), img_norm=img_norm))
    par = plain_topk_parity(models, dataset, img_norm)
    ap = {impl: m["posetrack/Mean"] for impl, m in metrics.items()}
    if not abs(ap["cuda"] - ap["torch"]) <= 0.1:
        raise AssertionError(f"cuda vs torch on {ckpt}: Mean AP {ap}")
    print(f"e2e parity: impl=cuda vs impl=torch on {os.path.basename(ckpt)},"
          f" TF32 off: on the plain path's top-k, keep equal, keypoints "
          f"within {par['kpt_err']:.3e} px (limit 1e-2), scores within "
          f"{par['score_err']:.3e} (limit 1e-5), {par['own_topk']} of "
          f"{par['passes']} passes with the same own top-k; run_inference "
          f"posetrack/Mean {ap['cuda']:.4f} vs {ap['torch']:.4f} (limit "
          f"0.1)", flush=True)
    for tta, flip_test, aug_scales in TTA_RUNS:
        par = plain_topk_parity(models, dataset, img_norm, flip_test,
                                aug_scales)
        ap = {impl: evaluate_dataset(dataset, run_inference(
            models[impl], ClipLoader(dataset, batch_size=1, shuffle=False,
                                     drop_last=False), img_norm=img_norm,
            flip_test=flip_test, aug_scales=aug_scales))["posetrack/Mean"]
            for impl in ("cuda", "torch")}
        flags = " ".join(tta_flags(flip_test, aug_scales))
        if not abs(ap["cuda"] - ap["torch"]) <= 0.1:
            raise AssertionError(f"cuda vs torch, {flags}: Mean AP {ap}")
        print(f"e2e parity {flags}: on the plain path's top-k, "
              f"{par['passes']} passes ({par['own_topk']} with the same own "
              f"top-k): keypoints within {par['kpt_err']:.3e} px (limit "
              f"1e-2), scores within {par['score_err']:.3e} (limit 1e-5); "
              f"the merged detections keep equal, within the same limits; "
              f"run_inference posetrack/Mean {ap['cuda']:.4f} vs "
              f"{ap['torch']:.4f} (limit 0.1, each path its own top-k)",
              flush=True)
    del models
    tf32(True)

    # the uint8 feed normalised on the card against the host chain
    u8, host = (next(iter(ClipLoader(train_cli.build_dataset(
        cfg, "test", build_test_pipeline(**dict(
            kwargs, normalize_on_device=on))), batch_size=2,
        shuffle=False, prefetch=0))) for on in (True, False))
    got = device_prep({k: torch.from_numpy(u8[k]).cuda()
                       for k in ("img", "img_shape")}, img_norm)["img"]
    err = (got.cpu() - torch.from_numpy(host["img"])).abs().max().item()
    if not (u8["img"].dtype == np.uint8 and err <= 1e-5):
        raise AssertionError(f"prep on the card vs host Normalize: {err}")
    print(f"prep: uint8 {tuple(u8['img'].shape)} normalised on the card vs "
          f"the host Normalize -> PadToBucket chain: max abs err {err:.3e} "
          f"(limit 1e-5); eval ms/clip f32 {eval_ms['f32']:.2f}, bf16 "
          f"{eval_ms['bf16']:.2f} | {smi}", flush=True)

    # 18. the distillation CLI: the windowed student of the same recipe
    # from the checkpoint, then the test CLI on the student
    student_cfg = str(ROOT / SYNTHETIC_WINDOWED_CONFIG)
    reset_launches()
    res = distill_cli.main([student_cfg, ckpt, "--work-dir",
                            str(CHIP_WORK / "distill"), "--steps",
                            str(E2E_DISTILL_STEPS), "--log-interval", "1",
                            "--dtype", "f32"] + opts)
    runs["e2e_distill_f32"] = read_launches()
    check_launches(f"e2e_distill_f32, {res['steps']} steps",
                   runs["e2e_distill_f32"],
                   {"msda_fwd": 6, "window_attn_fwd": WINDOW_CALLS,
                    "window_attn_bwd": WINDOW_CALLS}, res["steps"])
    teacher_sd = restore_variables(ckpt)
    student_sd = restore_variables(res["checkpoint"])
    init = build_model(train_cli.load_config(student_cfg, opts[1:]),
                       seed=0).state_dict()
    enc = [k for k in student_sd if k.startswith("head.encoder_layer")]
    copied_moved = [k for k in student_sd if k not in enc
                    and not torch.equal(student_sd[k], teacher_sd[k])]
    enc_stuck = [k for k in enc if k.endswith("weight")
                 and torch.equal(student_sd[k], init[k])]
    if (res["steps"] != E2E_DISTILL_STEPS or copied_moved or enc_stuck
            or not np.isfinite(res["distill_mse"])):
        raise AssertionError(f"distill CLI: {res}; entries copied from the "
                             f"teacher changed: {copied_moved}; encoder "
                             f"weights unchanged: {enc_stuck}")
    print(f"e2e_distill_f32: tools.distill.main from "
          f"{os.path.basename(ckpt)}: {res['steps']} steps, launches "
          f"{json.dumps(runs['e2e_distill_f32'])}; {res['step_ms']:.2f} ms "
          f"per step (median, host clock, loader wait included); "
          f"distill_mse {res['distill_mse']:.5g}; {len(student_sd) - len(enc)}"
          f" teacher entries bit-identical, every encoder weight changed "
          f"| {smi}", flush=True)
    reset_launches()
    out = test_cli.main([student_cfg, res["checkpoint"], "--dtype", "f32"]
                        + opts)
    runs["e2e_test_student_f32"] = read_launches()
    check_launches(f"e2e_test_student_f32, {out['clips']} clips",
                   runs["e2e_test_student_f32"],
                   {"msda_fwd": WINDOWED_MSDA_CALLS,
                    "window_attn_fwd": WINDOW_CALLS}, out["clips"])
    print(f"e2e_test_student_f32: tools.test.main on the student: "
          f"{out['clips']} clips, {out['detections']} detections, launches "
          f"{json.dumps(runs['e2e_test_student_f32'])}; eval loop "
          f"{out['ms_per_clip']:.2f} ms/clip; metrics "
          f"{json.dumps(out['metrics'])} | {smi}", flush=True)
    # the student cuda against torch, TF32 off, as the checkpoint above
    tf32(False)
    cfg = train_cli.load_config(student_cfg, opts[1:])
    kwargs, img_norm = train_cli.eval_pipeline_kwargs(cfg)
    models = {}
    for impl in ("cuda", "torch"):
        models[impl] = build_model(cfg, impl=impl).cuda().eval()
        models[impl].load_state_dict(student_sd)
    par = plain_topk_parity(models, train_cli.build_dataset(
        cfg, "test", build_test_pipeline(**kwargs)), img_norm)
    del models
    tf32(True)
    print(f"student parity: impl=cuda vs impl=torch, TF32 off: on the plain "
          f"path's top-k, keep equal, keypoints within {par['kpt_err']:.3e} "
          f"px (limit 1e-2), scores within {par['score_err']:.3e} (limit "
          f"1e-5), {par['own_topk']} of {par['passes']} clips with the same "
          f"own top-k", flush=True)
    return runs


def write_coco_scenes(root, seed=0, categories=0):
    """COCO-format scenes at ``COCO_HW``: per split of ``COCO_IMAGES``,
    seeded noise images with 1-3 objects each, and the json as
    ``<root>/<split>.json``. Keypoint scenes (K=17, ``categories`` 0): a
    person is a filled box with its keypoints drawn inside (visibility 2
    or 0), the json with bbox, area and num_keypoints. Instance scenes
    (``categories`` > 0): an object of category 1..``categories`` is a
    filled hexagon inside its box, the json with its polygon
    ``segmentation``, bbox and area."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    H, W = COCO_HW
    for split, n in COCO_IMAGES.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        images, anns = [], []
        for i in range(n):
            img = rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
            name = f"{split}/{i:06d}.jpg"
            images.append(dict(id=i + 1, file_name=name, height=H, width=W))
            for _ in range(rng.randint(1, 4)):
                bw, bh = rng.uniform(80, 300), rng.uniform(150, 400)
                x0, y0 = rng.uniform(0, W - bw), rng.uniform(0, H - bh)
                if categories:
                    color = tuple(int(c) for c in rng.randint(0, 256, 3))
                    ang = np.linspace(0, 2 * np.pi, 7)[:-1] + rng.rand()
                    poly = np.stack([x0 + bw / 2 * (1 + np.cos(ang)),
                                     y0 + bh / 2 * (1 + np.sin(ang))], 1)
                    cv2.fillPoly(img, [poly.round().astype(np.int32)], color)
                    x, y = poly[:, 0], poly[:, 1]
                    anns.append(dict(
                        id=len(anns) + 1, image_id=i + 1,
                        category_id=int(rng.randint(1, categories + 1)),
                        segmentation=[poly.reshape(-1).round(2).tolist()],
                        bbox=[x.min(), y.min(), x.max() - x.min(),
                              y.max() - y.min()],
                        area=0.5 * abs(np.dot(x, np.roll(y, 1))
                                       - np.dot(y, np.roll(x, 1))),
                        iscrowd=0))
                    continue
                k = np.stack([x0 + rng.rand(17) * bw, y0 + rng.rand(17) * bh,
                              (rng.rand(17) > 0.2) * 2.0], 1)
                cv2.rectangle(img, (int(x0), int(y0)),
                              (int(x0 + bw), int(y0 + bh)),
                              tuple(int(c) for c in rng.randint(0, 256, 3)),
                              -1)
                for x, y, v in k:
                    if v:
                        cv2.circle(img, (int(x), int(y)), 4,
                                   (255, 255, 255), -1)
                anns.append(dict(
                    id=len(anns) + 1, image_id=i + 1, category_id=1,
                    keypoints=k.reshape(-1).round(2).tolist(),
                    num_keypoints=int((k[:, 2] > 0).sum()),
                    bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0))
            cv2.imwrite(str(root / name), img)
        cats = ([dict(id=c, name=f"class{c}")
                 for c in range(1, categories + 1)] if categories
                else [dict(id=1, name="person")])
        with open(root / f"{split}.json", "w") as f:
            json.dump(dict(images=images, annotations=anns,
                           categories=cats), f)


def petr_cli(smi):
    """Phase 23: COCO-format scenes through the CLIs on the PETR R50
    config: ``tools.train`` 4 mini-steps (12+12 msda launches each),
    ``tools.test`` on its checkpoint (11 per clip; ``coco/`` metrics, eval
    ms/clip), ``tools.eval_metric`` on the dumped detections (the same
    metrics), then cuda against torch clip by clip on the plain path's
    top-k. Returns the runs' launches."""
    import shutil
    import torch
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.datasets.pipelines import build_test_pipeline
    from pavenet_tpu_torch.tools import eval_metric as eval_cli
    from pavenet_tpu_torch.tools import test as test_cli
    from pavenet_tpu_torch.tools import train as train_cli
    from pavenet_tpu_torch.utils.checkpoint import restore_variables

    work = CHIP_WORK / "petr"
    for d in (COCO_DATA, work):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    write_coco_scenes(COCO_DATA)
    print(f"coco scenes: {time.perf_counter() - t0:.2f} s to write "
          f"{COCO_IMAGES} images at {COCO_HW[0]}x{COCO_HW[1]}", flush=True)
    config = str(ROOT / PETR_CONFIG)
    opts = ["--cfg-options", "data.samples_per_gpu=1"] + [
        f"data.{split}.{key}={value}"
        for split, name in (("train", "train"), ("val", "val"),
                            ("test", "val"))
        for key, value in (("ann_file", f"{COCO_DATA}/{name}.json"),
                           ("img_prefix", f"{COCO_DATA}/"))]
    runs = {}
    reset_launches()
    res = train_cli.main([config, "--work-dir", str(work), "--max-steps",
                          str(COCO_STEPS), "--no-validate"] + opts)
    runs["petr_cli_train_f32"] = read_launches()
    check_launches(f"petr_cli_train_f32, {res['steps_run']} mini-steps",
                   runs["petr_cli_train_f32"],
                   {"msda_fwd": PETR_TRAIN_CALLS,
                    "msda_bwd": PETR_TRAIN_CALLS}, res["steps_run"])
    if res["steps"] != COCO_STEPS or "loss_hm" not in res["losses"]:
        raise AssertionError(f"PETR train CLI: {res}")
    ckpt = res["checkpoint"]
    print(f"petr_cli_train_f32: tools.train.main --max-steps {COCO_STEPS} "
          f"on {PETR_CONFIG}: step {res['steps']}, {res['updates']} "
          f"updates; launches {json.dumps(runs['petr_cli_train_f32'])}; "
          f"{res['step_ms']:.2f} ms per mini-step (median, host clock, "
          f"loader wait included), data_time {res['data_time_ms']:.2f} ms; "
          f"losses {json.dumps(res['losses'])} | {smi}", flush=True)
    dets = work / "dets.json"
    reset_launches()
    out = test_cli.main([config, ckpt, "--dtype", "f32", "--out",
                         str(dets)] + opts)
    runs["petr_cli_test_f32"] = read_launches()
    check_launches(f"petr_cli_test_f32, {out['clips']} clips",
                   runs["petr_cli_test_f32"], {"msda_fwd": CALLS_PER_CLIP},
                   out["clips"])
    metrics = eval_cli.main([config, str(dets)] + opts)
    if not (out["metrics"] and "coco/AP" in out["metrics"]
            and metrics == out["metrics"]):
        raise AssertionError(f"PETR test CLI metrics {out['metrics']}, "
                             f"eval_metric {metrics}")
    print(f"petr_cli_test_f32: tools.test.main on {os.path.basename(ckpt)}: "
          f"{out['clips']} clips, {out['detections']} detections (no NMS, "
          f"max_per_img 40), launches "
          f"{json.dumps(runs['petr_cli_test_f32'])}; eval loop "
          f"{out['ms_per_clip']:.2f} ms/clip (host pipeline included; first "
          f"clip {out['first_clip_s']:.2f} s); metrics "
          f"{json.dumps(out['metrics'])}; tools.eval_metric.main on the "
          f"dumped detections: the same {len(metrics)} metrics | {smi}",
          flush=True)
    tf32(False)
    cfg = train_cli.load_config(config, opts[1:])
    kwargs, img_norm = train_cli.eval_pipeline_kwargs(cfg)
    models = {}
    for impl in ("cuda", "torch"):
        models[impl] = build_model(cfg, impl=impl).cuda().eval()
        models[impl].load_state_dict(restore_variables(ckpt))
    par = plain_topk_parity(models, train_cli.build_dataset(
        cfg, "test", build_test_pipeline(**kwargs)), img_norm)
    del models
    torch.cuda.empty_cache()
    tf32(True)
    print(f"petr cli parity: impl=cuda vs impl=torch on "
          f"{os.path.basename(ckpt)}, TF32 off: on the plain path's top-k, "
          f"keep equal (all True), keypoints within {par['kpt_err']:.3e} px "
          f"(limit 1e-2), scores within {par['score_err']:.3e} (limit "
          f"1e-5), {par['own_topk']} of {par['passes']} clips with the same "
          f"own top-k", flush=True)
    return runs


def det_text_feats(rows):
    """Seeded (rows, 512) class embeddings, written to a ``.npy`` under
    ``CHIP_WORK`` and read back by ``PseudoTextEncoder``; None for 0
    rows (SOIT)."""
    import numpy as np
    from pavenet_tpu_torch.models.text_encoder import PseudoTextEncoder
    if not rows:
        return None, None
    path = CHIP_WORK / "text" / f"text_{rows}.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.random.RandomState(rows).randn(rows, 512).astype(
        np.float32))
    return PseudoTextEncoder(str(path), 512).get_text_feat(), path


def det_batch_fn(num_classes, text_feats, G=30):
    """``train``'s detection batches: noise images at ``hw``, G boxes
    inside the valid region (``img_shape`` (H, W - 11)) with seeded labels,
    each box's mask the filled box at the input size, the first 3/4 of the
    slots valid; DK-DETR's ``text_feats`` beside them."""
    import numpy as np

    def make(rng, B, hw):
        H, W = hw
        x0 = rng.uniform(0, (W - 11) * 0.7, (B, G))
        y0 = rng.uniform(0, H * 0.7, (B, G))
        bw = rng.uniform(32, (W - 11) * 0.3, (B, G))
        bh = rng.uniform(32, H * 0.3, (B, G))
        ys = np.arange(H)[:, None]
        xs = np.arange(W)[None, :]
        masks = np.empty((B, G, H, W), np.uint8)
        for b in range(B):
            for g in range(G):
                masks[b, g] = ((ys >= y0[b, g]) & (ys < y0[b, g] + bh[b, g])
                               & (xs >= x0[b, g]) & (xs < x0[b, g] + bw[b, g]))
        valid = np.zeros((B, G), bool)
        valid[:, : G * 3 // 4] = True
        batch = dict(
            img=rng.randn(B, H, W, 3).astype(np.float32),
            img_shape=np.tile(np.array([[H, W - 11]], np.int32), (B, 1)),
            scale_factor=np.ones((B, 2), np.float32),
            gt_boxes=np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(
                np.float32),
            gt_labels=rng.randint(0, num_classes, (B, G)).astype(np.int64),
            gt_masks=masks, gt_valid=valid)
        if text_feats is not None:
            batch["text_feats"] = text_feats
        return batch
    return make


def det_feed(img, text_feats):
    """One synthetic image's serving batch on the card (the test pipeline
    into the 800x1344 bucket), as ``inference_detector`` makes it."""
    import torch
    from pavenet_tpu_torch.apis.inference import host_batch
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in host_batch(img, 1, (1333, 800)).items()}
    batch["img"] = batch["img"][:, 0]
    if text_feats is not None:
        batch["text_feats"] = torch.from_numpy(text_feats).cuda()
    return batch


def capture_det_calls(model, batch, prefix, keep, train=False):
    """The inputs of the named kernel msda calls (``keep``) of one
    ``forward_outputs`` of ``model`` on the plain path:
    ``[(name, value, levels, loc, attn)]``, named ``prefix`` +
    encoder0-5, seg_encoder, decoder0-5 in call order."""
    import torch
    from pavenet_tpu_torch.models.attention import deformable
    names = ([f"{prefix}encoder{i}" for i in range(6)]
             + [f"{prefix}seg_encoder"]
             + [f"{prefix}decoder{i}" for i in range(6)])
    calls, dispatch = [], deformable.ms_deform_attn

    def record(value, shapes, loc, attn, **kw):
        name = names[len(calls)]
        calls.append(name)
        if name in keep:
            captured.append((name, value.detach().clone(),
                             tuple(map(tuple, shapes)),
                             loc.detach().float().clone(),
                             attn.detach().float().clone()))
        return dispatch(value, shapes, loc, attn, **kw)

    captured = []
    deformable.ms_deform_attn = record
    try:
        with torch.no_grad():
            model.forward_outputs(batch["img"], batch["img_shape"],
                                  train=train,
                                  text_feats=batch.get("text_feats"))
    finally:
        deformable.ms_deform_attn = dispatch
    if len(calls) != SOIT_CALLS:
        raise AssertionError(f"{len(calls)} msda calls in one forward")
    return captured


def check_captured(captured, fwd, bwd, backward=True):
    """The msda kernels against their plain versions on captured in-model
    calls, f32 and bf16 (forward, and backward with a seeded g), each
    record appended to ``fwd`` / ``bwd``; prints the share of sampling
    locations outside [0, 1] (zero-padded taps)."""
    import torch
    from pavenet_tpu_torch.ops import _ext
    from pavenet_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                      ms_deform_attn_torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, v, levels, loc, attn in captured:
        outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
        print(f"captured {name} {tuple(loc.shape)}: {100 * outside:.2f}% of "
              "sampling locations outside [0, 1]", flush=True)
        for dtype, tol in MSDA_FWD_TOL:
            fwd.append(forward_record(name, v.to(getattr(torch, dtype)),
                                      levels, loc, attn, tol, ms_deform_attn,
                                      ms_deform_attn_torch))
        if not backward:
            continue
        B, _, H, D = v.shape
        g = torch.randn(B, loc.shape[1], H * D, device="cuda", generator=gen)
        for dtype, tol in MSDA_BWD_TOL:
            bwd.append(backward_record(name, _ext,
                                       v.to(getattr(torch, dtype)), levels,
                                       loc, attn, g, tol,
                                       ms_deform_attn_torch))


def mask_call_record(model, batch, name):
    """The dynamic-mask msda call of one ``forward_test`` (the plain
    version, JAX's ``impl='xla'``): its shape, time (CUDA events) and
    bound."""
    import torch
    from pavenet_tpu_torch.models.detectors import soit
    calls, plain = [], soit.ms_deform_attn_torch

    def record(value, shapes, loc, attn):
        calls.append((value, shapes, loc, attn))
        return plain(value, shapes, loc, attn)

    soit.ms_deform_attn_torch = record
    try:
        model.forward_test(batch)
    finally:
        soit.ms_deform_attn_torch = plain
    (v, levels, loc, attn), = calls
    bound_ms, bound_by = msda_bound(False, v, levels, loc)
    B, _, H, D = v.shape
    rec = dict(case=name, B=B, Q=loc.shape[1], H=H, L=loc.shape[3],
               P=loc.shape[4], D=D, instances=loc.shape[1] // v.shape[1],
               plain_ms=cuda_ms(lambda: plain(v, levels, loc, attn)),
               bound_ms=bound_ms, bound_by=bound_by)
    print("mask call", json.dumps(rec), flush=True)
    del calls
    torch.cuda.empty_cache()
    return rec


def check_det_output(out, M, rows, hw=(400, 672)):
    """One image's detections: shapes, finite, labels below the class
    count, mask probabilities in [0, 1]."""
    import numpy as np
    shapes = {k: v.shape for k, v in out.items()}
    want = {"det_bboxes": (M, 5), "det_labels": (M,), "det_masks": (M, *hw)}
    if shapes != want:
        raise AssertionError(f"detections {shapes}, expected {want}")
    if not all(np.isfinite(out[k]).all() for k in ("det_bboxes",
                                                     "det_masks")):
        raise AssertionError("non-finite detections")
    m = out["det_masks"]
    if not (0 <= out["det_labels"].min() and out["det_labels"].max() < rows
            and m.min() >= 0 and m.max() <= 1):
        raise AssertionError(f"labels {out['det_labels']} of {rows}, masks "
                             f"in [{m.min()}, {m.max()}]")


def det_serve(smi, config, dtype="f32", text_rows=0):
    """SOIT or DK-DETR serving: ``init_detector`` and
    ``inference_detector`` on ``CLIPS`` synthetic 720x1280 images (800x1344
    bucket), 13 msda launches each, then cuda against torch with TF32 off.
    Returns the launches, ``forward_test`` ms, the dynamic-mask call's
    record and a plain model with the batch (for the captures)."""
    import torch
    from pavenet_tpu_torch.apis import inference_detector, init_detector

    text_feats, _ = det_text_feats(text_rows)
    model = init_detector(str(ROOT / config), device="cuda", seed=0,
                          dtype=dtype)
    rows = text_rows or model.num_classes
    imgs = [clip[0] for clip in synthetic_clips(frames=1)]
    check_det_output(inference_detector(model, imgs[0],
                                        text_feats=text_feats),
                     model.max_per_img, rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [inference_detector(model, img, text_feats=text_feats)
            for img in imgs[1:]]
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    img_ms = start.elapsed_time(end) / CLIPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for out in outs:
        check_det_output(out, model.max_per_img, rows)
    check_launches(f"serve {config} {dtype}, {CLIPS} images", launches,
                   expect({"msda_fwd": SOIT_CALLS}, dtype), CLIPS)
    batch = det_feed(imgs[1], text_feats)
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model.forward_test(batch), reps=5,
                           warmup=1)
        mask = mask_call_record(model, batch, f"{config} {dtype}")
    print(f"serve {config}: {CLIPS} images at "
          f"{tuple(batch['img'].shape[1:3])}, {dtype}, "
          f"{model.max_per_img} detections with masks, {rows} classes; "
          f"launches {json.dumps(launches)}; {img_ms:.2f} ms/image end to "
          f"end (host pipeline included), {model_ms:.2f} ms/image "
          f"forward_test; peak memory {peak_gb:.2f} GiB | {smi}", flush=True)
    plain = serve_parity(config, model, batch, dtype)
    del model
    torch.cuda.empty_cache()
    return launches, model_ms, mask, plain, batch


def write_voc_tree(voc, scenes, split="val"):
    """A VOC2007 tree of the instance scenes of ``split``: its images as
    ``JPEGImages``, each object as an XML ``object`` named by VOC's class
    of its category (1 -> aeroplane, ...) with a 1-based box, every third
    object marked difficult, and ``ImageSets/Main/test.txt``."""
    import shutil
    import xml.etree.ElementTree as ET
    from pavenet_tpu_torch.datasets import VOCDataset
    ann = json.load(open(scenes / f"{split}.json"))
    for d in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (voc / d).mkdir(parents=True, exist_ok=True)
    stems = []
    for img in ann["images"]:
        stem = f"{img['id']:06d}"
        stems.append(stem)
        shutil.copy(scenes / img["file_name"], voc / "JPEGImages" /
                    f"{stem}.jpg")
        root = ET.Element("annotation")
        for k, a in enumerate(a for a in ann["annotations"]
                              if a["image_id"] == img["id"]):
            obj = ET.SubElement(root, "object")
            ET.SubElement(obj, "name").text = VOCDataset.CLASSES[
                a["category_id"] - 1]
            ET.SubElement(obj, "difficult").text = str(int(k % 3 == 2))
            box = ET.SubElement(obj, "bndbox")
            x, y, w, h = a["bbox"]
            for tag, v in (("xmin", x), ("ymin", y), ("xmax", x + w),
                           ("ymax", y + h)):
                ET.SubElement(box, tag).text = str(int(round(v)) + 1)
        ET.ElementTree(root).write(voc / "Annotations" / f"{stem}.xml")
    (voc / "ImageSets/Main/test.txt").write_text("\n".join(stems) + "\n")


def det_cli(smi):
    """Phase 26: instance scenes (3 categories, polygon masks) at 448x768
    and a VOC2007 tree of them; a seed-0 checkpoint of each config through
    ``tools.test.main`` at 448x768 with every detection kept: SOIT (bbox
    and segm AP), DK-DETR's COCO test config with 80 text rows and its VOC
    config with 20 (fewer than its 1203 classes; every label within the
    rows; VOC mAP). 13 msda launches per image. Returns the runs'
    launches."""
    import shutil
    import torch
    from pavenet_tpu_torch.apis import init_trainer
    from pavenet_tpu_torch.tools import test as test_cli
    from pavenet_tpu_torch.utils.checkpoint import save_checkpoint

    work = CHIP_WORK / "soit"
    for d in (DET_DATA, work):
        shutil.rmtree(d, ignore_errors=True)
    work.mkdir(parents=True)
    write_coco_scenes(DET_DATA, seed=1, categories=DET_CATEGORIES)
    voc = DET_DATA / "VOCdevkit" / "VOC2007"
    write_voc_tree(voc, DET_DATA)
    coco = dict(ann_file=f"{DET_DATA}/val.json", img_prefix=f"{DET_DATA}/")
    runs = {}
    for name, config, rows, data in (
            ("soit_cli", SOIT_CONFIG, 0, coco),
            *((f"dkdetr_{ds}_cli", path, rows,
               coco if ds == "coco" else dict(
                   ann_file=f"{voc}/ImageSets/Main/test.txt",
                   img_prefix=f"{voc}/"))
              for ds, path, rows in DKDETR_TEST_CONFIGS)):
        _, text_path = det_text_feats(rows)
        text = (f"text_encoder=dict(text_feat_path={str(text_path)!r}), "
                if rows else "")
        cfg = work / f"{name}.py"
        cfg.write_text(
            f"_base_ = {str(ROOT / config)!r}\n"
            f"model = dict({text}test_cfg=dict(score_thr=0.0))\n"
            f"data = dict(test=dict(ann_file={data['ann_file']!r}, "
            f"img_prefix={data['img_prefix']!r}))\n"
            f"test_pipeline_kwargs = dict(img_scale={COCO_HW[::-1]!r}, "
            f"buckets=({COCO_HW!r},))\n")
        ckpt = save_checkpoint(str(work / name), init_trainer(
            str(cfg), device="cuda", seed=0), 0)
        dets = work / f"{name}.json"
        reset_launches()
        out = test_cli.main([str(cfg), ckpt, "--out", str(dets)])
        runs[name] = read_launches()
        check_launches(f"{name}, {out['clips']} images", runs[name],
                       {"msda_fwd": SOIT_CALLS}, out["clips"])
        labels = {d["category_id"] for d in json.load(open(dets))}
        want = {"mAP50"} if "voc" in name else {"bbox/AP", "segm/AP"}
        if not (want <= set(out["metrics"] or {}) and labels
                and max(labels) <= (rows or 80) and min(labels) >= 1):
            raise AssertionError(f"{name}: metrics {out['metrics']}, "
                                 f"labels {sorted(labels)} of {rows or 80}")
        print(f"{name}: tools.test.main on {os.path.basename(config)} "
              f"({rows or 80} classes) at {COCO_HW[0]}x{COCO_HW[1]}: "
              f"{out['clips']} images, {out['detections']} detections, "
              f"labels {min(labels)}-{max(labels)}, launches "
              f"{json.dumps(runs[name])}; eval loop {out['ms_per_clip']:.2f} "
              f"ms/image (host included, masks resized to the image; first "
              f"{out['first_clip_s']:.2f} s); metrics "
              f"{json.dumps(out['metrics'])} | {smi}", flush=True)
        torch.cuda.empty_cache()
    return runs


def soit_family(smi, runs, serve_ms, fwd, bwd):
    """Phases 24-25: SOIT R50 (serve f32 and bf16) and DK-DETR R50 LVIS
    (serve f32) at 800x1344; the kernels on their in-model calls (the seg
    encoder at the config's train batch, forward and backward; the
    box-reference decoder's first and last layers); 8 train mini-steps at
    the config's batch size and one cuda-vs-torch mini-step. Adds to
    ``runs``, ``serve_ms``, ``fwd`` and ``bwd``; returns the dynamic-mask
    calls' records."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.config import Config
    masks = []
    for name, config, dtypes, rows in (
            ("soit", SOIT_CONFIG, ("f32", "bf16"), 0),
            ("dkdetr", DKDETR_CONFIG, ("f32",), 1203)):
        cfg = Config.fromfile(str(ROOT / config))
        batch_size = cfg.data.samples_per_gpu
        num_classes = cfg.model.bbox_head.num_classes
        for dtype in dtypes:
            runs[f"{name}_serve_{dtype}"], serve_ms[(name, dtype)], mask, \
                plain, batch = det_serve(smi, config, dtype, rows)
            masks.append(mask)
            if dtype != "f32":
                del plain, batch
                continue
            captured = capture_det_calls(
                plain, batch, f"{name}_",
                {f"{name}_seg_encoder", f"{name}_decoder0",
                 f"{name}_decoder5"})
            text_feats, _ = det_text_feats(rows)
            train_batch = {k: torch.as_tensor(v).cuda() for k, v in
                           det_batch_fn(num_classes, text_feats)(
                               np.random.RandomState(2), batch_size,
                               (800, 1344)).items()}
            captured += capture_det_calls(
                plain, train_batch, f"{name}_train_",
                {f"{name}_train_seg_encoder", f"{name}_train_decoder5"},
                train=True)
            del plain, batch, train_batch
            torch.cuda.empty_cache()
            check_captured(captured, fwd, bwd)
            del captured
            torch.cuda.empty_cache()
        text_feats, _ = det_text_feats(rows)
        runs[f"{name}_train_f32"], _ = train(
            smi, config, {"msda_fwd": SOIT_CALLS, "msda_bwd": SOIT_CALLS},
            batch_size=batch_size,
            batch_fn=det_batch_fn(num_classes, text_feats))
        torch.cuda.empty_cache()
        train_parity(config, batch_size=batch_size, fixed_topk=True,
                     batch_fn=det_batch_fn(num_classes, text_feats))
    return masks


# ---------------------------------------------------------------------------
# phases 27-29: data parallelism over ranks and reference checkpoints
# ---------------------------------------------------------------------------
def ddp_steps(config, hw, rows, overrides, pins=None, order=None):
    """``TRAIN_STEPS`` mini-steps (one update) of ``config`` with dropout 0
    and TF32 off, on this rank's ``rows`` of seeded global batches of
    ``rows * world_size`` (one process: the whole batch), or on the global
    batch's rows in ``order`` (a permutation, in one process). ``pins``, the
    single process's proposals (the head's ``topk_idx``) and matches of
    each mini-step, are given to a rank for its rows: at the initial
    parameters both are full of near-ties that rounding can break either
    way, and the check is of the synchronisation, not of tie-breaking; a
    rank counts the match sets it would have chosen otherwise. Returns the
    losses of each mini-step, the summed accumulated gradient (captured
    where ``apply_update`` all-reduces it), the parameters after the update
    with their group's lr, trainable BatchNorm's running statistics, the
    proposals and matches used, the launches, the wall time and the peak
    memory."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis import init_trainer, train_step
    from pavenet_tpu_torch.config import Config
    from pavenet_tpu_torch.models.detectors import videopose
    from pavenet_tpu_torch.models.zoo import dummy_clip_batch
    from pavenet_tpu_torch.parallel import dist

    cfg = Config.fromfile(str(ROOT / config))
    cfg.merge_from_dict(dict(NO_DROPOUT, **overrides))
    tf32(False)
    state = init_trainer(cfg, device="cuda", seed=0)
    model = state.model
    if state.accumulate_steps != TRAIN_STEPS:
        raise AssertionError(f"{config}: {state.accumulate_steps} mini-steps "
                             f"an update")
    rank, world = dist.rank(), dist.world_size()
    mine = np.asarray(order if order is not None
                      else range(rank * rows, (rank + 1) * rows))
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(TRAIN_STEPS):
        b = dummy_clip_batch(rng, len(mine) * world, model.num_frames,
                             height=hw[0], width=hw[1],
                             num_keypoints=model.num_keypoints,
                             max_gt=state.max_gt, train=True)
        batches.append({k: v[mine] for k, v in b.items()})
    used = dict(topk=[], match=[], summed=None, own_match_differ=0)
    forward_outputs, assign = model.forward_outputs, videopose.hungarian_assign
    all_reduce_grads = dist.all_reduce_grads

    def outputs(*args, topk_idx=None, **kwargs):
        if pins is not None:
            topk_idx = pins["topk"][len(used["topk"])][mine].cuda()
        outs = forward_outputs(*args, topk_idx=topk_idx, **kwargs)
        used["topk"].append(outs["topk_idx"].cpu())
        return outs

    def match(costs, gt_valid):
        own = assign(costs, gt_valid)
        if pins is not None:
            pinned = [q[mine].to(gt_valid.device)
                      for q in pins["match"][len(used["match"])]]
            used["own_match_differ"] += sum(
                not torch.equal(a, b) for a, b in zip(own, pinned))
            own = pinned
        used["match"].append([q.cpu() for q in own])
        return own

    def capture(tensors):
        out = all_reduce_grads(tensors)
        used["summed"] = [t.detach().clone() for t in out]
        return out

    model.forward_outputs = outputs
    videopose.hungarian_assign = match
    dist.all_reduce_grads = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        losses = [{k: v.item() for k, v in train_step(state, b).items()}
                  for b in batches]
        torch.cuda.synchronize()
    finally:
        del model.forward_outputs
        videopose.hungarian_assign = assign
        dist.all_reduce_grads = all_reduce_grads
    wall = time.perf_counter() - t0
    launches = read_launches()
    tf32(True)
    if state.updates != 1:
        raise AssertionError(f"{state.updates} updates")
    lr = {id(p): g["lr"] for g in state.optimizer.param_groups
          for p in g["params"]}
    named = list(model.named_parameters())
    return dict(losses=losses, launches=launches, wall_s=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                grads={n: g for (n, _), g in zip(named, used["summed"])},
                params={n: p.detach() for n, p in named},
                lr={n: lr.get(id(p), 0.0) for n, p in named},
                stats=bn_stats(model), topk=used["topk"],
                match=used["match"],
                own_match_differ=used["own_match_differ"])


def ddp_errors(ref, got, grad_tol=None):
    """Each quantity's worst error against the single process's, with
    where it sits: losses over their limit (``1e-4 + 1e-4 |a|``); the
    summed gradient per tensor over its largest |g| (at least
    ``DDP_GRAD_FLOOR`` of the largest of any tensor), and, given
    ``grad_tol`` and the single process's own spread per tensor
    (``ref['spread']``), over the larger of ``grad_tol`` times that and
    ``DDP_SPREAD_FACTOR`` times the spread; the running statistics per
    tensor over their largest; the parameters after the update over twice
    their group's lr plus two float32 spacings of the parameter (AdamW's
    first update moves an element by about its lr times the sign of g:
    where g sits at rounding level the sign may flip)."""
    loss = max((abs(a - g[k]) / (DDP_LOSS_TOL[0] + DDP_LOSS_TOL[1] * abs(a)),
                f"step {i} {k}: {a:.7g} vs {g[k]:.7g}")
               for i, (r, g) in enumerate(zip(ref["losses"], got["losses"]))
               for k, a in r.items())
    grad, limited, param = (0.0, ""), (0.0, ""), (0.0, "")
    flipped, total = 0, 0
    floor = DDP_GRAD_FLOOR * max(g.abs().max().item()
                                 for g in ref["grads"].values())
    for n, g in ref["grads"].items():
        g = g.cuda()
        scale = max(g.abs().max().item(), floor)
        err = (got["grads"][n] - g).abs().max().item()
        grad = max(grad, (err / scale, f"{n} (max |g| {scale:.3e})"))
        if grad_tol is not None:
            limit = max(grad_tol * scale,
                        DDP_SPREAD_FACTOR * ref["spread"][n])
            limited = max(limited, (err / limit, f"{n} (limit "
                                    f"{limit:.3e})"))
        p = ref["params"][n].cuda()
        d = (got["params"][n] - p).abs()
        lr = ref["lr"][n]
        if lr:
            over = ((d - 2.0 ** -22 * p.abs()) / (2 * lr)).max().item()
        else:
            over = 0.0 if d.max().item() == 0 else float("inf")
        param = max(param, (over, n))
        flipped += int((d > 1e-7).sum())
        total += d.numel()
    stats = max([(rel_err(got["stats"][n], s.cuda()), n)
                 for n, s in ref["stats"].items()] + [(0.0, "")])
    return dict(loss_over_limit=loss[0], worst_loss=loss[1],
                grad_rel=grad[0], worst_grad=grad[1],
                grad_over_limit=limited[0], worst_grad_limit=limited[1],
                params_over_2lr=param[0], worst_param=param[1],
                params_off_1e7=f"{flipped} of {total}", stats_rel=stats[0],
                worst_stats=stats[1], max_lr=max(ref["lr"].values()),
                own_match_sets_differ=(f"{got['own_match_differ']} of "
                                       f"{sum(map(len, got['match']))}"))


def ddp_check(name, errs):
    """The failure message of ``errs`` beyond their limits, or None."""
    if not (errs["loss_over_limit"] <= 1 and errs["grad_over_limit"] <= 1
            and errs["params_over_2lr"] <= 1
            and errs["stats_rel"] <= DDP_STATS_TOL):
        return f"{name}: two ranks differ from one process: {errs}"
    return None


def spawn_ranks(kind, spec, world, env=None, launcher=()):
    """``world`` processes of ``chip_smoke.py --rank-worker kind`` (ranks
    0.. of a ``file://`` store), or one under ``launcher``; waits for all,
    each within ``DDP_TIMEOUT_S``, kills every one left when one fails,
    and returns each rank's JSON result."""
    import shutil
    import tempfile
    CHIP_WORK.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{kind}_", dir=CHIP_WORK))
    (work / "spec.json").write_text(json.dumps(spec))
    cmd = [sys.executable, *launcher, str(ROOT / "chip_smoke.py"),
           "--rank-worker", kind, str(work)]
    procs = []
    for r in range(world):
        penv = dict(os.environ, **(env or {}))
        if not launcher:
            penv.update(RANK=str(r), LOCAL_RANK="0", WORLD_SIZE=str(world),
                        PAVENET_DIST_INIT=f"file://{work}/store",
                        PAVENET_DIST_TIMEOUT=str(DDP_TIMEOUT_S))
        # a process group of its own: a failure kills the launcher's
        # workers too
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, env=penv, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True))
    logs = [None] * world
    try:
        for i, p in enumerate(procs):
            logs[i] = p.communicate(timeout=DDP_TIMEOUT_S)[0]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{kind} rank {r} exited {p.returncode}:\n"
                                 f"{(log or '')[-6000:]}")
    out = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(world)]
    for r, log in enumerate(logs):
        out[r]["log"] = log
    shutil.rmtree(work / "store", ignore_errors=True)
    return out


def rank_worker(kind, work):
    """One rank of a phase 27-28 run (``chip_smoke.py --rank-worker``):
    ``ddp-train`` the mini-steps of ``ddp_steps`` on its rows, held
    against the single process's saved result; ``cli-train`` and
    ``cli-test`` the CLI's ``main`` with the spec's arguments. Writes
    ``rank<r>.json``."""
    import torch
    work = Path(work)
    spec = json.loads((work / "spec.json").read_text())
    sys.path.insert(0, str(ROOT))
    from pavenet_tpu_torch.parallel import dist
    if kind == "ddp-train":
        if not dist.maybe_init_distributed(backend="gloo", device="cuda:0"):
            raise SystemExit("ddp-train: no process group")
        ref = torch.load(spec["ref"], map_location="cpu", weights_only=True)
        got = ddp_steps(spec["config"], tuple(spec["hw"]), spec["rows"],
                        spec["overrides"], pins=ref)
        result = dict(errors=ddp_errors(ref, got, spec["grad_tol"]),
                      launches=got["launches"],
                      wall_s=got["wall_s"], peak_gb=got["peak_gb"],
                      losses=got["losses"][-1], rank=dist.rank(),
                      world=dist.world_size(), backend=dist.backend())
        dist.destroy()
    else:
        from pavenet_tpu_torch.tools import test as test_cli
        from pavenet_tpu_torch.tools import train as train_cli
        reset_launches()
        res = (train_cli if kind == "cli-train" else test_cli).main(
            spec["argv"])
        result = dict(summary={k: v for k, v in res.items()
                               if k != "metrics"},
                      launches=read_launches(),
                      rank=int(os.environ.get("RANK", 0)))
    (work / f"rank{result['rank']}.json").write_text(json.dumps(result))


def ddp_train(smi):
    """Phase 27: two ranks on the one card over gloo against one process
    on the same global batch, the flagship at 800x1344 (B=1 a rank) and
    the from-scratch recipe at 448x768 (B=2 a rank, trainable BatchNorm).
    Returns each rank's launches."""
    import torch
    runs, failures = {}, []
    for name, config, hw, rows, overrides, grad_tol in DDP_RUNS:
        ref = ddp_steps(config, hw, rows * DDP_WORLD, overrides)
        single = dict(launches=ref.pop("launches"), wall_s=ref.pop("wall_s"),
                      peak_gb=ref.pop("peak_gb"))
        ref.pop("own_match_differ")
        # the single process's own rounding spread, tensor by tensor: the
        # same global batch with its rows reversed (the same proposals and
        # matches, permuted)
        again = ddp_steps(config, hw, rows * DDP_WORLD, overrides, pins=ref,
                          order=range(rows * DDP_WORLD)[::-1])
        spread = ddp_errors(ref, again)
        ref["spread"] = {n: (again["grads"][n] - g).abs().max().item()
                         for n, g in ref["grads"].items()}
        del again
        ref_path = CHIP_WORK / f"ddp_{name}_single.pt"
        ref_path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: ({n: t.cpu() for n, t in v.items()}
                        if k in ("grads", "params", "stats") else v)
                    for k, v in ref.items()}, ref_path)
        del ref
        torch.cuda.empty_cache()
        check_launches(f"ddp {name} single process", single["launches"],
                       {"msda_fwd": CALLS_PER_CLIP,
                        "msda_bwd": CALLS_PER_CLIP}, TRAIN_STEPS)
        ranks = spawn_ranks("ddp-train", dict(
            config=config, hw=hw, rows=rows, overrides=overrides,
            ref=str(ref_path), grad_tol=grad_tol), DDP_WORLD)
        ref_path.unlink()
        for res in ranks:
            if (res["world"], res["backend"]) != (DDP_WORLD, "gloo"):
                raise AssertionError(f"ddp {name}: {res}")
            check_launches(f"ddp {name} rank {res['rank']}",
                           res["launches"], {"msda_fwd": CALLS_PER_CLIP,
                                             "msda_bwd": CALLS_PER_CLIP},
                           TRAIN_STEPS)
            failures.append(ddp_check(f"ddp {name} rank {res['rank']}",
                                      res["errors"]))
            runs[f"ddp_{name}_rank{res['rank']}"] = res["launches"]
        print(f"ddp {name}: {config} at {hw[0]}x{hw[1]}, {TRAIN_STEPS} "
              f"mini-steps (one update), dropout 0, TF32 off: {DDP_WORLD} "
              f"ranks of B={rows} on one card (gloo, CUDA tensors) against "
              f"one process of B={rows * DDP_WORLD}; worst errors "
              + "; ".join(f"rank {res['rank']} {json.dumps(res['errors'])}"
                          for res in ranks)
              + f" (limits: loss_over_limit, grad_over_limit and "
              f"params_over_2lr 1, the loss limit {DDP_LOSS_TOL[0]} + "
              f"{DDP_LOSS_TOL[1]} |a|, the gradient limit the larger of "
              f"{grad_tol} of the tensor's largest and {DDP_SPREAD_FACTOR} "
              f"times the single process's own spread; stats_rel "
              f"{DDP_STATS_TOL}); the single process against itself with the "
              f"batch's rows reversed: {json.dumps(spread)}; launches per "
              f"rank {json.dumps(ranks[0]['launches'])}; correctness run, not "
              f"a scaling number (two processes share one card): "
              f"{TRAIN_STEPS} mini-steps in {single['wall_s']:.2f} s (one "
              f"process, peak {single['peak_gb']:.2f} GiB), "
              + ", ".join(f"rank {res['rank']} {res['wall_s']:.2f} s (peak "
                          f"{res['peak_gb']:.2f} GiB)" for res in ranks)
              + f" | {smi}", flush=True)
    failures = [f for f in failures if f]
    if failures:
        raise AssertionError("; ".join(failures))
    return runs


def dist_cli(smi):
    """Phase 28: ``tools.train`` under ``torch.distributed.run`` at world
    size 1 with the NCCL backend (the production launcher path), and
    ``tools.test`` at world size 2 over gloo on phase 14's checkpoint
    against its world-size-1 detections. Returns each run's launches."""
    import numpy as np
    config = str(ROOT / SYNTHETIC_CONFIG)
    opts = e2e_options()
    runs = {}
    work = CHIP_WORK / "nccl"
    res, = spawn_ranks("cli-train", dict(argv=[
        config, "--work-dir", str(work), "--max-steps", str(CLI_DDP_STEPS),
        "--no-validate", "--dist-backend", "nccl"] + opts), 1,
        env=dict(PAVENET_DISTRIBUTED="1"),
        launcher=("-m", "torch.distributed.run", "--standalone",
                  "--nproc_per_node", "1"))
    s = res["summary"]
    if not (s["world_size"] == 1 and s["backend"] == "nccl"
            and s["steps_run"] == CLI_DDP_STEPS
            and Path(s["checkpoint"]).exists()):
        raise AssertionError(f"train CLI under torch.distributed.run: {s}")
    check_launches("train CLI under torch.distributed.run", res["launches"],
                   {"msda_fwd": CALLS_PER_CLIP, "msda_bwd": CALLS_PER_CLIP},
                   CLI_DDP_STEPS)
    runs["cli_nccl_train"] = res["launches"]
    print(f"cli_nccl_train: python -m torch.distributed.run --standalone "
          f"--nproc_per_node 1 ... tools.train --dist-backend nccl: world "
          f"size {s['world_size']}, backend {s['backend']}, "
          f"{s['steps_run']} mini-steps, {s['updates']} updates, checkpoint "
          f"{os.path.basename(s['checkpoint'])}, losses "
          f"{json.dumps(s['losses'])}; launches "
          f"{json.dumps(res['launches'])}; {s['step_ms']:.2f} ms per "
          f"mini-step (median, host clock) | {smi}", flush=True)

    ckpt = CHIP_WORK / f"step_{E2E_RESUMED_STEPS}.pt"
    one = json.loads((CHIP_WORK / "dets_f32.json").read_text())
    out = CHIP_WORK / "dets_ws2.json"
    ranks = spawn_ranks("cli-test", dict(argv=[
        config, str(ckpt), "--device", "cuda:0", "--dist-backend", "gloo",
        "--out", str(out)] + opts), DDP_WORLD)
    two = json.loads(out.read_text())
    by_image = {}
    for name, dets in (("one", one), ("two", two)):
        for d in dets:
            by_image.setdefault(d["image_id"], {}).setdefault(
                name, []).append(d)
    score_err, kpt_err = 0.0, 0.0
    for image, pair in by_image.items():
        a, b = pair.get("one", []), pair.get("two", [])
        if len(a) != len(b):
            raise AssertionError(f"test CLI over 2 ranks: image {image} has "
                                 f"{len(b)} detections, one process "
                                 f"{len(a)}")
        for x, y in zip(a, b):
            score_err = max(score_err, abs(x["score"] - y["score"]))
            kpt_err = max(kpt_err, float(np.abs(
                np.asarray(x["keypoints"]) - np.asarray(y["keypoints"]))
                .max()))
    if not (score_err <= 1e-5 and kpt_err <= 1e-2 and len(one) == len(two)):
        raise AssertionError(f"test CLI over 2 ranks: scores within "
                             f"{score_err}, keypoints within {kpt_err}")
    clips = 0
    for res in ranks:
        n = res["summary"]["clips"]
        clips += n
        check_launches(f"test CLI rank {res['rank']}", res["launches"],
                       {"msda_fwd": CALLS_PER_CLIP}, n)
        runs[f"cli_test_ws2_rank{res['rank']}"] = res["launches"]
    metrics = ranks[0]["summary"]
    print(f"cli_test_ws2: tools.test on {ckpt.name} over {DDP_WORLD} ranks "
          f"(gloo, one card): {clips} clips ("
          + ", ".join(f"rank {r['rank']} {r['summary']['clips']}"
                      for r in ranks)
          + f"), {len(two)} detections gathered, equal to one process's "
          f"{len(one)} by image: scores within {score_err:.3e} (limit "
          f"1e-5), keypoints within {kpt_err:.3e} px (limit 1e-2); rank 0 "
          f"wrote {out.name}, {metrics['detections']} detections; launches "
          f"per rank " + json.dumps([r["launches"] for r in ranks])
          + f" | {smi}", flush=True)
    return runs


def invert_rules(rules, state, seed=0):
    """The reference-named state dict that ``rules``
    (``utils/reference_convert.py``) turn into ``state``; a port key the
    model lacks (the video tree's ``fc_hm``) gets seeded values."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    out = {}
    for rule in rules:
        vals = []
        for p in rule.ports:
            if p not in state:
                K, C2 = state["head.refine_query_embedding"].shape
                shape = (K, C2 // 2) if p.endswith("weight") else (K,)
                state = dict(state, **{p: torch.from_numpy(
                    rng.randn(*shape).astype(np.float32))})
            vals.append(state[p])
        if rule.kind == "copy":
            out[rule.refs[0]] = vals[0]
        elif rule.kind == "cat":
            out.update(zip(rule.refs, vals[0].chunk(len(rule.refs), 0)))
        elif rule.kind == "split":
            out[rule.refs[0]] = torch.cat(vals, 0)
        elif rule.kind == "dcn":    # Linear (o, 9i) -> DCN (o, i, 3, 3)
            w = vals[0]
            out[rule.refs[0]] = w.reshape(w.shape[0], 3, 3, -1).permute(
                0, 3, 1, 2)
        else:
            perm, axis = rule.arg
            inv = torch.empty_like(vals[0])
            inv.index_copy_(axis, torch.as_tensor(perm), vals[0])
            out[rule.refs[0]] = inv
    return {k: v.contiguous() for k, v in out.items()}


def reference_pth(smi, specs=REFERENCE_RUNS):
    """Phase 29: a reference-named ``.pth`` of each of ``specs`` (name,
    config, msda launches of one ``forward_test``; the flagship, PETR R50
    and SOIT R50; phase 32: InsPose) at full width (the port's seed-1 init
    through the inverted rule table) loaded by
    ``init_detector(checkpoint=...)`` on the card (seed 0, so that a key
    left unloaded would show): the state dict equal to the source bit for
    bit (PETR's sigma branches, which the reference tree lacks, the
    model's own seed-0 init), and ``forward_test`` on a synthetic clip (an
    image) equal to a model built from that state dict. Returns the
    launches."""
    import torch
    from pavenet_tpu_torch.apis.inference import (build_model, host_batch,
                                                  init_detector)
    from pavenet_tpu_torch.models.detectors import (InsPoseDetector,
                                                    SOITDetector)
    from pavenet_tpu_torch.utils.reference_convert import (
        convert_reference_state_dict, reference_rules)

    runs = {}
    folder = CHIP_WORK / "reference"
    folder.mkdir(parents=True, exist_ok=True)
    for name, config, calls in specs:
        path = str(ROOT / config)
        src = build_model(path, seed=1)
        state = src.state_dict()
        rules, _ = reference_rules(src)
        ref = invert_rules(rules, state)
        pth = folder / f"{name}.pth"
        torch.save({"meta": {"source": "seed 1"}, "state_dict": ref}, pth)
        converted, unused = convert_reference_state_dict(src, ref,
                                                         strict=True)
        t0 = time.perf_counter()
        model = init_detector(path, device="cuda", seed=0,
                              checkpoint=str(pth))
        load_s = time.perf_counter() - t0
        built = build_model(path, seed=0)
        own = {k: v.clone() for k, v in built.state_dict().items()}
        loaded = model.state_dict()
        lacking = [k for k in loaded if k not in converted]
        wrong = [k for k, v in loaded.items()
                 if not torch.equal(v.cpu(), state[k] if k in converted
                                    else own[k])]
        if wrong or unused or (bool(lacking) != (name == "petr")):
            raise AssertionError(f"{name}.pth: {len(wrong)} entries differ "
                                 f"({wrong[:5]}), unused {unused[:5]}, "
                                 f"kept from the init {lacking[:5]}")
        built.load_state_dict({k: state[k] for k in converted if k in own},
                              strict=False)
        built = built.cuda().eval()
        clip = synthetic_clips(frames=model.num_frames)[1]
        batch = {k: torch.from_numpy(v).cuda() for k, v in host_batch(
            clip, model.num_frames, (1333, 800)).items()}
        if isinstance(model, (SOITDetector, InsPoseDetector)):
            batch["img"] = batch["img"][:, 0]
        reset_launches()
        with torch.inference_mode():
            out = model.forward_test(batch)
        torch.cuda.synchronize()
        runs[f"pth_{name}"] = read_launches()
        check_launches(f"{name}.pth forward_test", runs[f"pth_{name}"],
                       {"msda_fwd": calls}, 1)
        with torch.inference_mode():
            want = built.forward_test(batch)
        err = max((out[k].float() - want[k].float()).abs().max().item()
                  for k in want)
        if not all(torch.equal(out[k], want[k]) for k in want):
            raise AssertionError(f"{name}.pth: forward_test differs from the "
                                 f"model built from its state dict by {err}")
        print(f"pth_{name}: {config}: a reference-named state dict of "
              f"{len(ref)} keys ({len(rules)} rules) through "
              f"init_detector(checkpoint=...) in {load_s:.2f} s: all "
              f"{len(loaded)} entries equal to the source's bit for bit "
              f"({len(lacking)} kept from the init), no unused key; "
              f"forward_test on the card equal to the model built from the "
              f"state dict (max abs err {err:.3e}); launches "
              f"{json.dumps(runs[f'pth_{name}'])} | {smi}", flush=True)
        del model, built, src, ref
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# phases 30-32: InsPose
# ---------------------------------------------------------------------------
def inspose_batch_fn(K=17, G=30):
    """``train``'s InsPose batches: noise images at ``hw``, G boxes inside
    the valid region (``img_shape`` (H, W - 11)), K keypoints inside each
    box (a fifth of them invisible), the first 3/4 of the slots valid."""
    import numpy as np

    def make(rng, B, hw):
        H, W = hw
        x0 = rng.uniform(0, (W - 11) * 0.7, (B, G))
        y0 = rng.uniform(0, H * 0.7, (B, G))
        bw = rng.uniform(32, (W - 11) * 0.3, (B, G))
        bh = rng.uniform(32, H * 0.3, (B, G))
        kpts = np.empty((B, G, K, 3), np.float32)
        kpts[..., 0] = x0[..., None] + rng.rand(B, G, K) * bw[..., None]
        kpts[..., 1] = y0[..., None] + rng.rand(B, G, K) * bh[..., None]
        kpts[..., 2] = (rng.rand(B, G, K) > 0.2) * 2.0
        valid = np.zeros((B, G), bool)
        valid[:, : G * 3 // 4] = True
        return dict(
            img=rng.randn(B, H, W, 3).astype(np.float32),
            img_shape=np.tile(np.array([[H, W - 11]], np.int32), (B, 1)),
            scale_factor=np.ones((B, 2), np.float32),
            gt_boxes=np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(
                np.float32),
            gt_keypoints=kpts, gt_valid=valid)
    return make


def check_inspose_output(out, M, K):
    """One image's InsPose detections: shapes, finite, labels 0, soft-NMS
    scores in [0, 1]."""
    import numpy as np
    shapes = {k: v.shape for k, v in out.items()}
    want = {"det_kpts": (M, K, 3), "det_bboxes": (M, 5), "det_labels": (M,),
            "keep": (M,)}
    if shapes != want:
        raise AssertionError(f"detections {shapes}, expected {want}")
    s = out["det_bboxes"][:, 4]
    if not (np.isfinite(out["det_kpts"]).all()
            and np.isfinite(out["det_bboxes"]).all()
            and (out["det_labels"] == 0).all() and s.min() >= 0
            and s.max() <= 1):
        raise AssertionError(f"InsPose detections: scores in [{s.min()}, "
                             f"{s.max()}], labels {set(out['det_labels'])}")


def inspose_outputs(model, batch, topk_idx=None):
    """One InsPose forward's stages on ``batch``: the flattened levels'
    ``cls``, ``dyn`` and ``off``, the ``shared`` map, the top-k (or
    ``topk_idx``) and its scores, the top-k's dynamic heatmap logits
    ``hm`` (B, M, h0*w0, K), and ``forward_test`` on that top-k."""
    import torch
    with torch.inference_mode():
        outs, shared, _ = model.forward_levels(batch["img"], with_hm=False)
        cls, dyn, off, pts, strd = model.flatten_levels(outs)
        scores = cls.sigmoid()[..., 0]
        if topk_idx is None:
            topk_idx = scores.topk(model.max_per_img, dim=1).indices
        M = topk_idx.shape[1]
        d = torch.gather(dyn, 1, topk_idx[..., None].expand(-1, M,
                                                            dyn.shape[-1]))
        hm = model.dynamic_heatmaps(
            d, shared, pts[topk_idx],
            normalize=strd[topk_idx] * (64.0 / model.strides[0]))
        det = model.forward_test(batch, topk_idx=topk_idx)
    return dict(cls=cls, dyn=dyn, off=off, shared=shared, topk_idx=topk_idx,
                top_scores=torch.gather(scores, 1, topk_idx), hm=hm, **det)


def inspose_parity(model, batch, dtype):
    """Kernels against the plain model (its weights, ``impl='torch'``),
    TF32 off, both on the plain path's top-k: every stage (level outputs,
    shared map, heatmap logits) within ``INSPOSE_TOL['stages']`` of its
    largest in f32 (``BF16_STAGE_TOL`` in bf16); in f32 the keypoints
    within 1e-2 px except where the plain heatmap's argmax or its 0.1
    threshold is a tie (1e-4), the soft-NMS scores within 1e-4 and the
    kernels' own top-k scores within 1e-5 of the plain path's. The soft-NMS
    score never exceeds its top-k score. Returns the plain model."""
    import torch
    from pavenet_tpu_torch.apis import init_detector
    tf32(False)
    plain = init_detector(str(ROOT / INSPOSE_CONFIG), device="cuda",
                          impl="torch", dtype=dtype)
    plain.load_state_dict(model.state_dict())
    want = inspose_outputs(plain, batch)
    got = inspose_outputs(model, batch, want["topk_idx"])
    f32 = dtype == "f32"
    tol = INSPOSE_TOL["stages"] if f32 else BF16_STAGE_TOL
    errs = {k: rel_err(got[k], want[k])
            for k in ("cls", "dyn", "off", "shared", "hm")}
    bad = {k: e for k, e in errs.items() if not e <= tol}
    over = (want["det_bboxes"][..., 4] > want["top_scores"].float()
            + 1e-6).sum().item()
    ties = flips = 0
    score_err = own_err = None
    if f32:
        hm = want["hm"].float()
        peak = hm.amax(2)                                   # (B, M, K)
        at_got = torch.gather(hm, 2, got["hm"].argmax(2)[:, :, None])[:, :, 0]
        tie = ((peak - at_got).abs() <= 1e-4 * hm.abs().max()) | (
            (torch.sigmoid(peak) - 0.1).abs() <= 1e-4)
        far = (got["det_kpts"][..., :2] - want["det_kpts"][..., :2]).abs() \
            .amax(-1) > INSPOSE_TOL["kpts"]
        flips = (far & ~tie).sum().item()
        ties = (far & tie).sum().item()
        score_err = (got["det_bboxes"][..., 4]
                     - want["det_bboxes"][..., 4]).abs().max().item()
        own = inspose_outputs(model, batch)
        own_err = (own["top_scores"].float().sort(-1).values
                   - want["top_scores"].float().sort(-1).values
                   ).abs().max().item()
        if not (score_err <= INSPOSE_TOL["scores"] or ties):
            bad["scores"] = score_err
        if not own_err <= 1e-5:
            bad["own_topk"] = own_err
        del own
    if bad or flips or over:
        raise AssertionError(f"InsPose cuda vs torch {dtype}: {bad}; "
                             f"{flips} keypoints apart off a tie; {over} "
                             f"soft-NMS scores above their top-k score; "
                             f"stages {errs}")
    print(f"serve parity {INSPOSE_CONFIG} {dtype}: impl=cuda vs impl=torch, "
          f"TF32 off, on the plain path's top-k: stage errors (of their "
          f"largest) {json.dumps(errs)} (limit {tol})"
          + (f"; keypoints within {INSPOSE_TOL['kpts']} px ({ties} apart on "
             f"a heatmap tie), soft-NMS scores within {score_err:.3e}, the "
             f"kernels' own top-k scores within {own_err:.3e}" if f32
             else "") + "; every soft-NMS score at most its top-k score",
          flush=True)
    del got, want
    tf32(True)
    return plain


def capture_star_calls(model, batch, keep=INSPOSE_CAPTURE):
    """The inputs of the named star-convolution msda calls (``keep``) of
    one ``forward_test`` of ``model`` (the plain path):
    ``[(name, value, levels, loc, attn)]``, named
    ``inspose_l{level}_{cls,ctr}_star`` in call order."""
    import torch
    from pavenet_tpu_torch.models.detectors import inspose
    names = [f"inspose_l{lvl}_{b}_star" for lvl in range(5)
             for b in ("cls", "ctr")]
    calls, captured, dispatch = [], [], inspose.ms_deform_attn

    def record(value, shapes, loc, attn, **kw):
        name = names[len(calls)]
        calls.append(name)
        if name in keep:   # the value is a view of the NCHW map: copied
            captured.append((name, value.detach().clone(
                memory_format=torch.contiguous_format),
                tuple(map(tuple, shapes)), loc.detach().float().clone(),
                attn.detach().float().clone()))
        return dispatch(value, shapes, loc, attn, **kw)

    inspose.ms_deform_attn = record
    try:
        with torch.no_grad():
            model.forward_test(batch)
    finally:
        inspose.ms_deform_attn = dispatch
    if len(calls) != INSPOSE_CALLS:
        raise AssertionError(f"{len(calls)} star msda calls in one forward")
    return captured


def inspose_serve(smi, dtype):
    """InsPose serving: ``init_detector`` and ``inference_detector`` on
    ``CLIPS`` synthetic 720x1280 images (800x1344 bucket), exactly
    ``INSPOSE_CALLS`` msda launches each, then ``inspose_parity``. Returns
    the launches, ``forward_test`` ms, and the plain model with the batch
    (for the captures)."""
    import torch
    from pavenet_tpu_torch.apis import inference_detector, init_detector
    model = init_detector(str(ROOT / INSPOSE_CONFIG), device="cuda", seed=0,
                          dtype=dtype)
    M, K = model.max_per_img, model.num_keypoints
    imgs = [clip[0] for clip in synthetic_clips(frames=1)]
    check_inspose_output(inference_detector(model, imgs[0]), M, K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [inference_detector(model, img) for img in imgs[1:]]
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    img_ms = start.elapsed_time(end) / CLIPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for out in outs:
        check_inspose_output(out, M, K)
    check_launches(f"serve {INSPOSE_CONFIG} {dtype}, {CLIPS} images",
                   launches, expect({"msda_fwd": INSPOSE_CALLS}, dtype),
                   CLIPS)
    batch = det_feed(imgs[1], None)
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: model.forward_test(batch), reps=5,
                           warmup=1)
    kept = int(sum(out["keep"].sum() for out in outs))
    print(f"serve {INSPOSE_CONFIG}: {CLIPS} images at "
          f"{tuple(batch['img'].shape[1:3])}, {dtype}, {M} detections of "
          f"{K} keypoints ({kept} above score_thr after soft-NMS); launches "
          f"{json.dumps(launches)}; {img_ms:.2f} ms/image end to end (host "
          f"pipeline and soft-NMS included), {model_ms:.2f} ms/image "
          f"forward_test; peak memory {peak_gb:.2f} GiB | {smi}", flush=True)
    plain = inspose_parity(model, batch, dtype)
    del model
    torch.cuda.empty_cache()
    return launches, model_ms, plain, batch


def inspose_train_parity(batch_size):
    """impl=cuda vs impl=torch on one mini-step of the model as initialised
    from seed 0, TF32 off, on a seeded InsPose batch: every loss within
    1e-4 and the gradient norm within 1e-3 relative (phase 9's limits);
    the kernels launched in the cuda step only. Only ``loss_cls`` and
    ``loss_keypoint`` see the star convolutions."""
    import numpy as np
    import torch
    from pavenet_tpu_torch.apis.inference import build_model
    from pavenet_tpu_torch.apis.train import to_device
    tf32(False)
    batch = to_device(inspose_batch_fn()(np.random.RandomState(1),
                                         batch_size, (800, 1344)), "cuda")
    results = {}
    for impl in ("torch", "cuda"):
        model = build_model(str(ROOT / INSPOSE_CONFIG),
                            impl=impl).cuda().train()
        reset_launches()
        losses = model.forward_train(batch)
        losses["loss"].backward()
        launches = read_launches()
        check_launches(f"InsPose train parity, impl={impl}", launches,
                       {"msda_fwd": INSPOSE_CALLS,
                        "msda_bwd": INSPOSE_CALLS} if impl == "cuda"
                       else {}, 1)
        norm = torch.linalg.vector_norm(torch.stack([
            p.grad.norm() for p in model.parameters() if p.grad is not None]))
        results[impl] = ({k: v.item() for k, v in losses.items()},
                         norm.item())
        del model, losses
        torch.cuda.empty_cache()
    (loss_t, norm_t), (loss_c, norm_c) = results["torch"], results["cuda"]
    rel = {k: abs(loss_c[k] - loss_t[k]) / abs(loss_t[k]) for k in loss_t}
    worst = max(rel, key=rel.get)
    norm_rel = abs(norm_c - norm_t) / norm_t
    if not (all(r <= 1e-4 for r in rel.values()) and norm_rel <= 1e-3):
        raise AssertionError(f"InsPose cuda vs torch train step: loss rel "
                             f"errors {rel}, grad norm {norm_c} vs {norm_t}")
    print(f"train parity {INSPOSE_CONFIG} f32: impl=cuda vs impl=torch, one "
          f"mini-step at 800x1344, B={batch_size}, TF32 off: max loss rel "
          f"err {rel[worst]:.3e} ({worst}) over {len(rel)} losses (limit "
          f"1e-4), grad norm {norm_c:.6g} vs {norm_t:.6g} (rel "
          f"{norm_rel:.3e}, limit 1e-3)", flush=True)
    tf32(True)
    return rel[worst]


def inspose_cli(smi, pth):
    """Phase 32's test CLI: ``tools.test.main`` with the InsPose ``.pth`` on
    phase 23's COCO keypoint scenes at 448x768, every detection kept
    (``score_thr`` 0): ``INSPOSE_CALLS`` launches per image, boxes with
    ``category_id`` 1 and no mask, box AP (JAX's CLI scores InsPose so).
    Returns the launches."""
    from pavenet_tpu_torch.tools import test as test_cli
    if not (COCO_DATA / "val.json").exists():
        write_coco_scenes(COCO_DATA)
    work = CHIP_WORK / "inspose"
    work.mkdir(parents=True, exist_ok=True)
    cfg = work / "inspose_cli.py"
    cfg.write_text(
        f"_base_ = {str(ROOT / INSPOSE_CONFIG)!r}\n"
        "model = dict(test_cfg=dict(score_thr=0.0))\n"
        f"data = dict(test=dict(ann_file={str(COCO_DATA / 'val.json')!r}, "
        f"img_prefix={str(COCO_DATA) + '/'!r}))\n"
        f"test_pipeline_kwargs = dict(img_scale={COCO_HW[::-1]!r}, "
        f"buckets=({COCO_HW!r},))\n")
    dets = work / "dets.json"
    reset_launches()
    out = test_cli.main([str(cfg), str(pth), "--out", str(dets)])
    launches = read_launches()
    check_launches(f"inspose_cli, {out['clips']} images", launches,
                   {"msda_fwd": INSPOSE_CALLS}, out["clips"])
    dumped = json.load(open(dets))
    metrics = out["metrics"] or {}
    if not ("bbox/AP" in metrics and "segm/AP" not in metrics
            and len(dumped) == out["detections"] == 100 * out["clips"]
            and all(d["category_id"] == 1 and len(d["bbox"]) == 4
                    and "keypoints" not in d for d in dumped)):
        raise AssertionError(f"inspose_cli: metrics {metrics}, "
                             f"{len(dumped)} detections")
    print(f"inspose_cli: tools.test.main on {os.path.basename(str(cfg))} "
          f"with the reference .pth at {COCO_HW[0]}x{COCO_HW[1]}: "
          f"{out['clips']} images, {out['detections']} boxes (category 1, "
          f"no mask), launches {json.dumps(launches)}; eval loop "
          f"{out['ms_per_clip']:.2f} ms/image (host included; first "
          f"{out['first_clip_s']:.2f} s); box metrics "
          f"{json.dumps(metrics)} | {smi}", flush=True)
    return launches


def inspose_family(smi, runs, serve_ms, fwd, bwd):
    """Phases 30-32: InsPose serve (f32, bf16) with the kernels on the
    captured level-0 and level-4 star calls, forward and backward; train
    (f32, the config's B=2, 30 GT slots, one update) and its cuda-vs-torch
    mini-step; the ``.pth`` through ``init_detector`` and the test CLI.
    Adds to ``runs``, ``serve_ms``, ``fwd`` and ``bwd``."""
    import torch
    from pavenet_tpu_torch.config import Config
    for dtype in ("f32", "bf16"):
        runs[f"inspose_serve_{dtype}"], serve_ms[("inspose", dtype)], plain, \
            batch = inspose_serve(smi, dtype)
        if dtype == "f32":
            captured = capture_star_calls(plain, batch)
            del plain, batch
            torch.cuda.empty_cache()
            check_captured(captured, fwd, bwd)
            del captured
        else:
            del plain, batch
        torch.cuda.empty_cache()
    # 31. train
    batch_size = Config.fromfile(str(ROOT / INSPOSE_CONFIG)).data \
        .samples_per_gpu
    runs["inspose_train_f32"], _ = train(
        smi, INSPOSE_CONFIG, {"msda_fwd": INSPOSE_CALLS,
                              "msda_bwd": INSPOSE_CALLS},
        batch_size=batch_size, batch_fn=inspose_batch_fn())
    torch.cuda.empty_cache()
    inspose_train_parity(batch_size)
    torch.cuda.empty_cache()
    # 32. the .pth and the test CLI
    runs.update(reference_pth(smi, (("inspose", INSPOSE_CONFIG,
                                     INSPOSE_CALLS),)))
    runs["inspose_cli"] = inspose_cli(
        smi, CHIP_WORK / "reference" / "inspose.pth")
    torch.cuda.empty_cache()


def kernel_record(name, records, launches, replaces, **extra):
    """The kernel's line: ``ms``, ``plain_ms``, ``library_ms`` and
    ``bound_ms`` of one main-path call (msda: the encoder call on
    uniform-random inputs, and with the suffix ``_in_model`` the first
    captured encoder call; window attention: one encoder layer, the four
    flagship levels unshifted), f32; ``max_abs_err`` the largest of every
    checked shape and dtype."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    msda = name.startswith("msda")
    rec, = [r for r in records if r["dtype"] == "float32"
            and r["case"] == ("encoder" if msda else "layer")]
    line = {"name": name, "route": "cuda",
            "source": f"pavenet_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in records),
            **{k: rec.get(k) for k in keys}}
    if msda:
        rec, = [r for r in records if r["dtype"] == "float32"
                and r["case"] == "encoder0"]
        line.update({f"{k}_in_model": rec[k] for k in keys[:4]})
    return {**line, **extra}


def main(argv=None):
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="a checkout of an earlier commit: build its msda "
                        "kernels and time them against this tree's on the "
                        "encoder inputs (only that phase runs)")
    parser.add_argument("--rank-worker", nargs=2, metavar=("KIND", "DIR"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_worker:
        return rank_worker(*args.rank_worker)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    t_start = time.perf_counter()

    def lap(phases):
        """The script's clock at the end of ``phases``: where the run's
        time goes, for a later slice that must cut depth to fit."""
        print(f"time: phases {phases} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    sys.path.insert(0, str(ROOT))
    from pavenet_tpu_torch.ops import _ext
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn_torch
    from pavenet_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build (every kernel at once)
    for name, seconds in _ext.build_all().items():
        print(f"build: csrc/{name}.cu in {seconds:.2f} s", flush=True)
        for line in _ext.build_log(name).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # 3. the msda calls of one flagship clip, on the plain path, and the
    # encoder call of one T=5 clip
    captured = capture_in_model()
    captured.append(capture_in_model(FRAMES5_CONFIG, "frames5_")[0])
    captured.extend(c for c in capture_in_model(PETR_CONFIG, "petr_")
                    if c[0] in ("petr_encoder0", "petr_pose_decoder0"))
    print("captured: " + ", ".join(
        f"{n} {tuple(loc.shape)}" for n, _, _, loc, _ in captured),
        flush=True)
    if args.parent:
        compare_parent(_ext, args.parent, captured)
        return

    # 4-7. kernels vs plain, then what bounds the msda kernels
    fwd = check_forward(ms_deform_attn, ms_deform_attn_torch, captured)
    bwd = check_backward(_ext, ms_deform_attn_torch, captured)
    probes = check_probes(_ext, captured)
    del captured
    torch.cuda.empty_cache()
    win_fwd, win_bwd, _ = check_window(_ext)
    lap("1-7")

    # 8-9. flagship (deformable) serve and train, f32 then bf16
    flagship = {"msda_fwd": CALLS_PER_CLIP, "msda_bwd": CALLS_PER_CLIP}
    runs = {}
    serve_ms = {}
    for dtype in ("f32", "bf16"):
        runs[f"flagship_serve_{dtype}"], serve_ms[("flagship", dtype)] = \
            serve(smi, CONFIG, {"msda_fwd": CALLS_PER_CLIP}, dtype)
    runs["flagship_train_f32"], _ = train(smi, CONFIG, flagship)
    train_parity(CONFIG)
    runs["flagship_train_bf16"], _ = train(smi, CONFIG, flagship, "bf16")
    train_parity(CONFIG, dtype="bf16", limits=(BF16_LOSS_TOL, BF16_NORM_TOL))
    torch.cuda.empty_cache()
    lap("8-9")

    # 10. the from-scratch recipe: trainable BatchNorm, nothing frozen
    runs["synthetic_train_f32"], _ = train(
        smi, SYNTHETIC_CONFIG, flagship, hw=SYNTHETIC_HW,
        batch_size=SYNTHETIC_BATCH)
    train_parity(SYNTHETIC_CONFIG, hw=SYNTHETIC_HW,
                 batch_size=SYNTHETIC_BATCH)
    torch.cuda.empty_cache()

    # 11-13. the windowed variant: serve (f32, bf16), train, distill
    windowed = {"msda_fwd": WINDOWED_MSDA_CALLS,
                "window_attn_fwd": WINDOW_CALLS}
    for dtype in ("f32", "bf16"):
        runs[f"windowed_serve_{dtype}"], serve_ms[("windowed", dtype)] = \
            serve(smi, WINDOWED_CONFIG, windowed, dtype)
    runs["windowed_train_f32"], _ = train(smi, WINDOWED_CONFIG, dict(
        windowed, msda_bwd=WINDOWED_MSDA_CALLS,
        window_attn_bwd=WINDOW_CALLS))
    train_parity(WINDOWED_CONFIG)
    train_parity(WINDOWED_CONFIG, fixed_topk=True)
    torch.cuda.empty_cache()
    runs["distill_f32"] = distill(smi)
    torch.cuda.empty_cache()
    lap("10-13")

    # 14, 18. dataset to AP through the CLIs, with test-time augmentation
    # and the distillation CLI
    runs.update(dataset_to_ap(smi))
    torch.cuda.empty_cache()
    lap("14, 18")

    # 15-16. Swin-L PAVE-Net: serve (f32, bf16), train (f32)
    for dtype in ("f32", "bf16"):
        runs[f"swin_serve_{dtype}"], serve_ms[("swin", dtype)] = serve(
            smi, SWIN_CONFIG, {"msda_fwd": CALLS_PER_CLIP}, dtype)
        torch.cuda.empty_cache()
    runs["swin_train_f32"], _ = train(smi, SWIN_CONFIG, flagship)
    torch.cuda.empty_cache()
    train_parity(SWIN_CONFIG)
    torch.cuda.empty_cache()

    # 17. T=5: serve and train, f32
    runs["frames5_serve_f32"], serve_ms[("frames5", "f32")] = serve(
        smi, FRAMES5_CONFIG, {"msda_fwd": CALLS_PER_CLIP})
    runs["frames5_train_f32"], _ = train(smi, FRAMES5_CONFIG, flagship)
    # seed 0's T=5 proposals hold a tie to rounding (serve parity above):
    # both paths on the plain path's top-k, the tie checked
    train_parity(FRAMES5_CONFIG, fixed_topk=True)
    torch.cuda.empty_cache()
    lap("15-17")

    # 19-22. the PETR family: PETR R50 on COCO (serve f32 and bf16, train
    # with the heatmap encoder's call), PETR HRNet-W48, HRNet-W48 video
    # pretraining (T=3, one update of 16 mini-steps), PETR Swin-L on
    # CrowdPose (K=14); each with its cuda-vs-torch checks, the train
    # mini-steps on the plain path's top-k
    petr = {"msda_fwd": PETR_TRAIN_CALLS, "msda_bwd": PETR_TRAIN_CALLS}
    serve_one = {"msda_fwd": CALLS_PER_CLIP}
    for dtype in ("f32", "bf16"):
        runs[f"petr_serve_{dtype}"], serve_ms[("petr", dtype)] = serve(
            smi, PETR_CONFIG, serve_one, dtype)
    runs["petr_train_f32"], _ = train(smi, PETR_CONFIG, petr)
    train_parity(PETR_CONFIG, fixed_topk=True)
    torch.cuda.empty_cache()
    runs["petr_hrnet_serve_f32"], serve_ms[("petr_hrnet", "f32")] = serve(
        smi, PETR_HRNET_CONFIG, serve_one)
    runs["petr_hrnet_train_f32"], _ = train(smi, PETR_HRNET_CONFIG, petr)
    train_parity(PETR_HRNET_CONFIG, fixed_topk=True)
    torch.cuda.empty_cache()
    runs["hrnet_pretrain_serve_f32"], serve_ms[("hrnet_pretrain", "f32")] \
        = serve(smi, HRNET_PRETRAIN_CONFIG, serve_one)
    runs["hrnet_pretrain_train_f32"], _ = train(smi, HRNET_PRETRAIN_CONFIG,
                                                flagship)
    train_parity(HRNET_PRETRAIN_CONFIG, fixed_topk=True)
    torch.cuda.empty_cache()
    runs["petr_crowdpose_serve_f32"], serve_ms[("petr_crowdpose", "f32")] \
        = serve(smi, PETR_CROWDPOSE_CONFIG, serve_one)
    torch.cuda.empty_cache()
    # 23. COCO-format data through the CLIs
    runs.update(petr_cli(smi))
    torch.cuda.empty_cache()
    lap("19-23")
    # 24-25. SOIT R50 and DK-DETR R50 LVIS: serve, the kernels on their
    # in-model calls, train, cuda against torch
    mask_calls = soit_family(smi, runs, serve_ms, fwd, bwd)
    torch.cuda.empty_cache()
    # 26. instance scenes and a VOC tree through the test CLI
    runs.update(det_cli(smi))
    torch.cuda.empty_cache()
    lap("24-26")
    # 27. two ranks on the one card against one process: the flagship and
    # the from-scratch recipe
    runs.update(ddp_train(smi))
    torch.cuda.empty_cache()
    # 28. the train CLI under torch.distributed.run (NCCL) and the test CLI
    # over two ranks
    runs.update(dist_cli(smi))
    # 29. reference .pth checkpoints of the flagship, PETR R50 and SOIT R50
    runs.update(reference_pth(smi))
    torch.cuda.empty_cache()
    lap("27-29")
    # 30-32. InsPose: serve (f32, bf16) with its star calls on the kernels,
    # train, a reference .pth and the test CLI
    inspose_family(smi, runs, serve_ms, fwd, bwd)
    torch.cuda.empty_cache()
    lap("30-32")
    print("serve forward_test ms/clip, f32 / bf16: " + ", ".join(
        f"{m} {serve_ms[(m, 'f32')]:.2f} / "
        + (f"{serve_ms[(m, 'bf16')]:.2f}" if (m, "bf16") in serve_ms
           else "-") for m in ("flagship", "windowed", "swin", "frames5",
                               "petr", "petr_hrnet", "hrnet_pretrain",
                               "petr_crowdpose", "soit", "dkdetr",
                               "inspose"))
        + f" | {smi}", flush=True)

    def by_run(name):
        return {run: {"launches": counts[name],
                      "bf16_launches": counts[f"{name}_bf16"]}
                for run, counts in runs.items()}

    merged, = [r for r in probes if r["inputs"] == "in_model"
               and r["dtype"] == "float32"]

    def frames5(records):
        """The T=5 encoder call's numbers, in-model, f32, the PETR family's
        calls (random and in-model), SOIT's and DK-DETR's in-model seg
        encoder and box-reference decoder calls and InsPose's level-0 and
        level-4 star calls, f32."""
        out = {}
        for case, suffix in (("frames5_encoder0", "frames5_in_model"),
                             ("petr_encoder", "petr_encoder"),
                             ("petr_heatmap", "petr_heatmap"),
                             ("pose_decoder_k17", "pose_decoder_k17"),
                             ("pose_decoder_k14", "pose_decoder_k14"),
                             ("petr_encoder0", "petr_encoder_in_model"),
                             ("petr_pose_decoder0",
                              "petr_pose_decoder_in_model"),
                             ("soit_seg_encoder", "soit_seg_encoder_in_model"),
                             ("soit_train_seg_encoder",
                              "soit_seg_encoder_b2_in_model"),
                             ("dkdetr_train_seg_encoder",
                              "dkdetr_seg_encoder_in_model"),
                             ("soit_decoder0", "soit_decoder0_in_model"),
                             ("soit_decoder5", "soit_decoder5_in_model"),
                             ("soit_train_decoder5",
                              "soit_decoder5_b2_in_model"),
                             ("inspose_l0_cls_star",
                              "inspose_star_l0_in_model"),
                             ("inspose_l4_cls_star",
                              "inspose_star_l4_in_model")):
            recs = [r for r in records if r["dtype"] == "float32"
                    and r["case"] == case]
            if recs:
                out.update({f"{k}_{suffix}": recs[0][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by")})
        return out
    print(f"chip_smoke: phases 1-32 passed in "
          f"{time.perf_counter() - t_start:.1f} s | {smi}", flush=True)
    print(json.dumps({"kernels": [
        kernel_record("msda_fwd", fwd,
                      runs["flagship_train_f32"]["msda_fwd"],
                      "pavenet_tpu/ops/pallas/msda_cs.py:398, "
                      "pavenet_tpu/ops/pallas/msda.py:334",
                      launches_by_run=by_run("msda_fwd"),
                      merged_probe_ms_in_model=merged["fwd_merged_ms"],
                      dynamic_mask_plain=mask_calls, **frames5(fwd)),
        kernel_record("msda_bwd", bwd,
                      runs["flagship_train_f32"]["msda_bwd"],
                      "pavenet_tpu/ops/pallas/msda_cs.py:662, "
                      "pavenet_tpu/ops/pallas/msda.py:490",
                      launches_by_run=by_run("msda_bwd"), **frames5(bwd)),
        kernel_record("window_attn_fwd", win_fwd,
                      runs["windowed_train_f32"]["window_attn_fwd"],
                      "pavenet_tpu/ops/pallas/window_attn.py:173",
                      launches_by_run=by_run("window_attn_fwd")),
        kernel_record("window_attn_bwd", win_bwd,
                      runs["windowed_train_f32"]["window_attn_bwd"],
                      "pavenet_tpu/ops/pallas/window_attn.py:193",
                      launches_by_run=by_run("window_attn_bwd")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
