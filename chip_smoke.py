#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (yolo_dbl_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build  - compile every CUDA kernel of the main paths from csrc/ (one nvcc
              per source, all started together); ptxas registers, spills and
              static shared bytes per kernel, and the dynamic shared bytes of
              the kernels that take them;
  2. k1     - letterbox kernel vs its plain PyTorch version at 8x512x768 -> 640^2,
              float32 and bfloat16 out (each timed beside its own byte bound), and
              at one odd geometry (odd canvas width, a batch starting mid-chunk);
  3. k2     - DySample sampler kernel vs its plain version at the three
              YOLO-DBL-s DySample sites and two of YOLO-DBL2-l's (20x20x1024
              -> 40^2, 256 channels a group; 40x40x512, 128), both padding
              modes;
  4. k2_backward - the sampler's backward kernel vs autograd through the plain
              version, and its forward kernel vs the plain forward, at the three
              sites at training batch 16 (and the two YOLO-DBL2-l sites),
              both padding modes, DySample and uniform coordinates; the share
              of taps that missed their tile's
              window of dx; the zero fill of dx timed alone; F.grid_sample's
              backward kernel as the library yardstick;
  5. k3     - area attention forward kernel (3xTF32 on the tensor cores) vs
              its plain version (the einsum path) at the two YOLOv13-s A2C2f
              sites at serving batch 8, on the packed qkv views AAttn passes;
              a second run on the same inputs must give the same bits;
              lse vs logsumexp; both float32 sides read against float64; SDPA
              as the library yardstick; the bound is the largest of the bytes,
              the products (on their cheapest route at the accuracy the bars
              ask for) and the exponentials on the special-function units;
  6. k3_backward - the dq and dkv kernels (3xTF32 on the tensor cores) vs
              autograd through the plain version, and the forward kernel vs
              the plain forward, at the two sites at training batch 16; a
              second backward on the same inputs must give the same bits;
              SDPA's backward as the yardstick;
  7. main   - YOLO-DBL-s (nc=3, 640, f32, seeded random weights, FullPAD gates
              0.5, Detect class biases 0) serving requests of 8 distinct uint8
              512x768 frames through DetectionPredictor; launch counts of every
              kernel are read around these requests;
  8. profile - device time of a request by kernel and by part of the path
              (torch.profiler), and the device's busy share;
  9. train  - YOLO-DBL-s (nc=3, 640, f32, batch 16, default training config)
              taking 2 warm-up and 5 timed steps through Trainer.step on
              seeded synthetic batches; losses, step times, peak memory, launch
              counts of every kernel (K2 forward and backward 3 each per step),
              then the device time of one step by part and the device's busy
              share (train_profile);
 10. main_v13, profile_v13 - as main and profile for the stock YOLOv13-s
              (nc=80, the config's own): K1 once and K3 8 times per request;
 11. train_v13 - as train for YOLOv13-s (nc=80, batch 16, 2 warm-up and 3
              timed steps): each K3 kernel 8 times per step (train_profile_v13);
 12. parity, parity_v13 - the same weights and 2 frames on the CPU (plain
              versions) and on the card (kernels, TF32 off): decoded boxes
              < 0.05 px, scores <= 1e-3;
 13. train_parity, train_parity_v13 - one train-mode loss and backward of the
              same weights on a batch of 2 at 256 px on the CPU and on the card
              (TF32 off, dropout off on both): loss items within 1e-4 relative,
              the gradient of every leaf within 1e-3 of that leaf's largest
              (plus 1e-10 of the model's largest, for leaves whose exact
              gradient is 0) against the float64 gradient of the CPU's
              weights (computed on the card through the plain versions,
              `plain_kernels`), and card against
              CPU for named leaves (YOLO-DBL: the DySample offset convs, m0 and
              a Detect conv; YOLOv13: the 8 attn.qkv convs, whose gradient
              comes only through K3's backward and pe, m0 and a Detect conv);
              BatchNorm running statistics within 1e-4.
The bfloat16 policy (DetectionModel(..., dtype=torch.bfloat16): float32
parameters, bfloat16 compute), beside each float32 phase:
 14. k2_bf16, k2_backward_bf16, k3_bf16, k3_backward_bf16 - phases 3-6 for
              the bfloat16 kernels (bfloat16 in and out, float32 inside; the
              three K3 kernels on bfloat16 tensor cores), with
              the same inputs rounded to bfloat16, against the bfloat16 plain
              versions (float32 on the upcast inputs, rounded once): within
              one bfloat16 step of the result plus 1e-6 of the terms' scale;
              the library yardsticks in bfloat16;
 15. main_bf16, profile_bf16, main_v13_bf16, profile_v13_bf16 - the requests
              of main with a bfloat16 model: K1 writes bfloat16, and the K2 or
              K3 bfloat16 kernels run, no float32 kernel;
 16. train_bf16, train_profile_bf16, train_v13_bf16, train_profile_v13_bf16 -
              as train, with bfloat16 models (float32 loss, optimizer, EMA);
 17. parity_bf16, parity_v13_bf16 - the card's bfloat16 decode against the
              CPU's float32 one at the same weights and frames, within
              check_amp's bars (yolo_dbl_tpu/utils/checks.py:43-45: boxes 0.02
              of imgsz, scores 0.05); card bfloat16 against CPU bfloat16 printed
              beside the CPU's own bfloat16-against-float32 spread;
 18. train_parity_bf16, train_parity_v13_bf16 - one train-mode backward at 256
              px of bfloat16 models on the CPU and the card: the leaves K2 or
              K3 feed against the float64 reference (on the card through
              the plain versions), within 4x the CPU bfloat16's own
              distance from it; the loss items likewise, as medians over
              three batches (one batch's is noise).
The engine slice (DetectionValidator over 4 batches of 16 seeded 640x640
images with 1-3 filled rectangles each, conf 0.001, iou 0.7, max_det 300, the
COCO 12 stats; random weights, so the mAP is no quality claim):
 19. val      - YOLO-DBL-s (nc=3, f32; main's weights with the Detect class
              biases of the model's own init): metrics, img/s, K2 launches (3 a
              batch); gate: the first 2 images through the same validator on
              the CPU (TF32 off): the same kept count per image, rows within
              0.05 px and 1e-3, each metric within 1e-3;
 20. val_bf16 - the same with a bfloat16 model (the bfloat16 K2 kernel only),
              its metrics beside the float32 ones; gate: its decode on 2 images
              against the CPU's float32 within check_amp's bars;
 21. v8       - yolov8n (nc=3, f32, 3,011,417 parameters; no hand kernel):
              card decode against the CPU's on 2 images (0.05 px, 1e-3), 2
              warm-up and 5 timed Trainer.steps at batch 16 (step ms, img/s,
              peak memory), then the validator over the val batches.
The engine slice, part 2 (the facade; needs cv2, through tests/fixtures.py):
 22. facade   - YOLO-DBL-s (nc=3, 640, f32, full width and depth) through
              YOLO on a seeded shapes set (32 train, 16 val images): train 1
              epoch (batch 16), then resume=True to 2 (it must continue at
              epoch 1 and step 2); YOLO(best.ckpt) validates (the native val
              lane where the native loader built) and predicts a directory of
              12 JPEG frames of two sizes (two buckets; K1 once a bucket, the
              K2 forward 3 times a forward, its backward 3 times a train step),
              with classes=[1] and agnostic_nms=True; request ms, launches,
              loader lane, checkpoint bytes and wall seconds; gate: 2 frames
              through the same checkpoint on the CPU (TF32 off, conf 0.001):
              the decode NMS is handed within 0.05 px and 1e-3 at every
              anchor, the card's NMS on it equal to the CPU's NMS on it, and
              each frame's kept counts equal with boxes < 0.05 px, scores
              <= 1e-3 and equal classes, or parted at an NMS decision that
              the two decodes take on either side of its threshold (a
              float32 near-tie: a score at conf, two candidates' order, an
              IoU at iou), which the gate names with both values; and
              `python -m yolo_dbl_tpu_torch detect predict` in a process of
              its own prints the same counts;
 23. converge - the convergence run of record through the facade: yolov8n
              from random init on the shapes set (32 train, 16 val at 160 px),
              60 epochs, tests/test_convergence.py's arguments; gate: best val
              mAP50 >= 0.8 and best fitness > 0.2.
The rest of the v13/DBL family:
 24. main_dbl2, profile_dbl2, train_dbl2, train_profile_dbl2, parity_dbl2
              and their _bf16 phases (parity_dbl2_bf16: parity_bf16's bars) -
              YOLO-DBL2-l (yolov13l_DBL2, C3Ghost, nc=3, 640) as main,
              profile, train and parity: K1 and 3 K2 forward launches a
              request, 3 K2 forward and 3 backward launches a step (DySample
              at 128, 256 and 128 channels a group);
 25. family   - the other six configs (edit9, edit10, v3edit5_attn,
              v3edit5_attn2, v3edit6, edit_template) at scale s and 320:
              card decode against the CPU's on 2 frames (TF32 off; 0.05 px,
              1e-3) and one train step at batch 4 each, with each config's
              launches (edit9: K2; v3edit6, edit_template: K3; edit10 runs
              DLU, the v3edit5 pair SLA, neither a kernel); SLA's first
              module also card against CPU with non-zero proj_l and out_proj
              (inert at init) and its block top-k margin;
 26. facade_dbl2 - YOLO-DBL2-l through YOLO on the shapes set: train 1
              epoch (2 steps at batch 16, 640), val, predict 8 frames from
              memory; gate as facade's.
The stock detect families (v3, v5, v6, v8, 11, v12):
 27. main_v12, profile_v12, train_v12, train_profile_v12, parity_v12,
              train_parity_v12 and their _bf16 phases - YOLOv12-s
              (yolov12s.yaml, nc=80, 640; C3k2, A2C2f) as the YOLOv13-s
              phases: K1 once and K3 8 times a request (A2C2f rows 6 and 8,
              YOLOv13-s's two sites), each K3 kernel 8 times a step;
 28. main_v11, profile_v11, train_v11, train_profile_v11, parity_v11 -
              yolo11-s (nc=80, 640; C3k2, C2PSA) in float32: K1 once a
              request, no hand kernel in a step (C2PSA's attention is plain
              PyTorch, as in JAX);
 29. zoo      - the other 15 configs of the families (scale n where the YAML
              has scales; the YOLOv3 family has none) at nc=80 and 320: card
              decode against the CPU's on 2 frames (TF32 off; 0.05 px, 1e-3),
              K1 once a forward (yolov3_edit3's A2C2f rows: K3 16 times a
              forward, each K3 kernel 16 times a step), and one train step
              at batch 4 with finite losses; seconds a config.
Data parallel (parallel/, Trainer(mesh=...); rank bodies in tests/torch_ranks.py):
 30. dp       - YOLO-DBL-s (nc=3, 640, global batch 16, 2 steps, TF32 off)
              through Trainer(mesh=...) against the one-process Trainer on
              the same weights and batches: NCCL at world 1 in this process,
              and Gloo at world 2 in two processes on this one card (8 rows
              each; NCCL refuses two ranks on one card, which the phase
              tries and prints), in float32 and bfloat16; loss items 1e-4,
              the first step's gradient 1e-3 of each leaf's largest (float64
              CPU where a leaf misses it by float32 order), BatchNorm
              statistics 1e-4, the parameters bit for bit equal on the
              ranks; bfloat16 within 4x the one-process bfloat16 step's
              distance from the float32 one; K2 forward and backward 3
              launches a step on every rank; per rank step ms, all-reduce ms
              and device-busy share.
The mesh's 'model' axis (parallel/shardings.py, tensor.py, spatial.py):
 31. tp       - YOLO-DBL-s (nc=3, 640, float32, TF32 off) tensor-parallel
              over Gloo on this one card: a 1x2 mesh (2 processes) and a 2x2
              mesh (4) train 2 steps at global batch 8 through
              Trainer(mesh=...) against the one-process Trainer, at dp's
              bars (replicated leaves and whole gathered parameters bit for
              bit equal on the ranks); each rank holds the specs' share of
              the parameter, EMA and moment bytes; then the 1x2 ranks serve
              a request of 8 u8 frames through a `shard_variables` model in
              float32 and bfloat16 (decode against the one-process float32
              one: 0.05 px and 1e-3, bf16 at parity_bf16's bars; float32
              kept counts equal); the collectives a step by kind and bytes,
              with the column -> row pairing and without it (one more step);
              K2 forward and backward 3 launches a step, K1 once and K2 3
              times a request, on every rank;
 32. sp       - YOLO-DBL-s (nc=3, 640, float32) spatial-parallel over Gloo
              1x2 on this card: a request of 8 u8 frames through
              `spatial(model, mesh)` (320 image rows a rank, halo
              exchanges, DySample and the hypergraph on gathered maps),
              held as tp's serving; halo and gather bytes a request.
The v10, v9 and v7 families (nc=80, 640, seeded random weights; the paths
run after main_v11 and train_v11, their parities after the others):
 33. main_v10, profile_v10, train_v10, train_profile_v10, parity_v10,
              train_parity_v10 and their _bf16 phases - YOLOv10-s
              (yolov10s.yaml, 8,128,256 parameters; SCDown, C2fCIB, PSA and
              the NMS-free v10Detect) as the YOLOv12-s phases: K1 once a
              request, no hand kernel in a step; the predictor decodes the
              one2one branch and runs NMS, as JAX's does; the class biases
              of both branches are 0; train_v10 also holds the trainer's
              loss to e2e_detect_loss's one2many term plus its one2one term
              (TAL top-10 and top-1); parity_v10 also runs v10_postprocess
              (the NMS-free top-300) on the card against the CPU;
              train_parity's named leaves are PSA's qkv conv (the plain
              attention's backward) and both branches' first-level outputs;
 34. main_v9, profile_v9, train_v9, train_profile_v9, parity_v9 - YOLOv9-s
              (yolov9s.yaml; ELAN1, AConv, RepNCSPELAN4, SPPELAN) in
              float32: K1 once a request, no hand kernel in a step;
 35. main_v7, profile_v7, parity_v7 - YOLOv7 (yolov7.yaml, 37,622,682
              parameters; MP, SPPCSPC, RepConv, IDetect) serving in float32
              through decode_v7 (scores in [0, 1]): K1 once a request. It
              does not train: the JAX package has no IDetect loss;
 36. zoo_v9v10 - the v9 and v10 families' other 10 configs (yolov9t, m, c,
              e; yolov10.yaml at n, yolov10n, m, b, l, x) as zoo: card decode
              against the CPU's at 320 on 2 frames, K1 once a forward, one
              train step at batch 4 with finite losses.
The segment, pose and classify heads (seeded random weights; the Segment
head's own BatchNorms calibrated on a probe, `calibrate_mask_head`, so its
mask probabilities are no float32 tie at 0.5; TF32 off in the parity phases):
 37. main_seg, profile_seg, train_seg, train_profile_seg and their _bf16
              phases - YOLO11-s-seg (yolo11s-seg.yaml, nc=80, 10,113,232
              parameters) as main and train: requests of 8 uint8 512x768
              frames through SegmentationPredictor (K1, forward, decode, NMS
              with anchor indices, up to 300 masks an image made at the
              frame's size on the card and copied to the host; the masks'
              ms and their copy's apart, `mask_parts`), steps of 16 at 640
              through segmentation_loss (gt_masks at 160 drawn from the
              boxes; the mask term's ms apart, `task_term`) with peak memory;
              main_pose, profile_pose, train_pose, train_profile_pose -
              YOLO11-s-pose (nc=1, 17 keypoints) in float32; main_cls,
              profile_cls - YOLO11-s-cls (nc=1000) serving at 224 (K1
              letterboxes 512x768 to 224^2, also held to its plain version
              in `k1`); K1 once a request on each;
 38. parity_seg, parity_pose, parity_cls - card against CPU on 2 frames in
              the facade gate's form (the decode at every anchor, the card's
              NMS equal to the CPU's on one decode, each frame's rows alike
              or parted at named decisions), the coefficients, prototypes or
              keypoint maps within 1e-4 of their largest, and on the rows
              kept alike the mask probabilities (1e-3) and frame masks
              (IoU >= 0.99) or the keypoints (0.05 px, visibility 1e-3); the
              classifier's probabilities and logits within 1e-4, top-1
              equal; parity_seg_bf16 at parity_bf16's bars, with the kept
              rows' mask probabilities held as the scores;
              train_parity_seg, train_parity_pose - as train_parity (loss
              items with mask, kpt, kobj; Proto's leaves named);
 39. zoo_tasks - yolov8n-seg, yolov9c-seg, yolov9e-seg, yolov8n-pose and
              yolov8n-cls at 320: card decode and every task output against
              the CPU on 2 frames, K1 once a forward, one train step at
              batch 4 (not the classifier: it does not train);
 40. facade_tasks - yolo11n-seg and yolo11n-pose (nc=2) through YOLO on a
              task shapes set at 320: train 1 epoch (2 steps), val (box and
              mask or pose mAP), predict 8 frames from memory; gate: the
              facade gate at 320, with the masks or keypoints of the rows
              both devices keep (a class and a box within 0.05 px).
The OBB head (YOLO11-s-obb, yolo11s-obb.yaml, nc=15 as DOTAv1, seeded random
weights, Detect class biases 0; TF32 off in the parity phases):
 41. main_obb, profile_obb, train_obb, train_profile_obb and their _bf16
              phases - requests of 8 uint8 1024x1024 tiles at imgsz 1024
              through OBBPredictor (K1 at gain 1, forward, decode_obb, the
              rotated fast-NMS in float32), steps of 16 at 1024 through
              obb_loss (8-64 rotated GTs a tile: the rotated TAL's
              (16, 64, 21504) tensors) with peak memory; K1 once a request,
              no hand kernel in a step; k1 also holds K1 against its plain
              version at 1024^2 in both types and times it (`canvas_1024`);
 42. parity_obb - card against CPU on 2 tiles: the decode at every anchor
              (xywh 0.05 px, angle 1e-4, scores 1e-3), the angle maps 1e-4
              of their largest, the card's rotated NMS equal to the CPU's on
              one decode, each frame's kept rows alike (angles 1e-4) or
              parted at decisions `_nms_partings_rotated` names;
              train_parity_obb - train_parity at 256 (loss items, every
              leaf against the float64 reference on the card, the angle
              branch's first output conv named);
 43. zoo_tasks also runs yolov8n-obb (nc=15) and the three -cls-resnet
              configs (yolo11n-cls-resnet18, yolov8-cls-resnet50 and -101;
              serving only); facade_tasks also runs yolov8n-obb (train,
              val with the rbox mAP, predict; the gate with rotated rows).
The module pools' configs and YOLO-World (nc=80, 640, seeded random weights;
the world heads' contrastive bias 0, the others' class biases 0; TF32 off in
the parity phases):
 44. main_world, profile_world, train_world, train_profile_world and their
              _bf16 phases - YOLOv8-s-worldv2 (yolov8s-worldv2.yaml,
              12,759,864 parameters; C2fAttn, WorldDetect with the
              BNContrastiveHead) scoring against its seeded `txt_feats` (80
              prompts) in requests of 8 uint8 512x768 frames, and training
              on the zero text (as JAX's step does) at batch 16; main_emac,
              profile_emac, train_emac, train_profile_emac (float32) and
              main_emac_bf16, profile_emac_bf16 - YOLO-EMAC at its default
              (s) scale (13,008,914 parameters; C3k2_EAMC, M2C2f's window
              attention at 3, 5 and 7); K1 once a request, no hand kernel in
              a step;
 45. parity_world, parity_emac - parity's bars, and each frame's kept rows
              (conf 0.25) alike or parted at decisions `_frames_alike`
              names; parity_world_bf16 at parity_bf16's bars;
              train_parity_world, train_parity_emac - train_parity (the
              C2fAttn attention's projection convs, or M2C2f's window-3
              qkv Dense, named);
 46. zoo_pools - yolov8n-world, FFCA-YOLO (its default scale), FFCA-YOLO-L and
              yolo11n-C3k2_EFE-IRSTE at 320, as zoo; facade_tasks also runs
              yolov8n-worldv2 (nc=2: train, val, predict; its checkpoint
              reloads as a plain DetectionModel, as in JAX, so the gate
              scores the reloaded weights in a WorldModel with its seeded
              text and the contrastive bias 0).
RT-DETR (RT-DETR-l, rt-detr/rtdetr-l.yaml, nc=80, 32,970,476 parameters,
seeded random weights; TF32 off in the parity phases):
 47. main_rtdetr, profile_rtdetr, train_rtdetr, train_profile_rtdetr and
              main_rtdetr_bf16, profile_rtdetr_bf16 - requests of 8 uint8
              512x768 frames through `RTDETRRequests` (K1, the forward,
              rtdetr_postprocess's 300 sorted rows, those above conf 0.25
              rescaled to each frame; no NMS; the port's predictor refuses
              RT-DETR), steps of 16 at 640 through rtdetr_loss on 8-64 GTs an
              image, with the host solve's ms a step (the costs' copy,
              scipy's 112 matchings, the indices back) and peak memory; K1
              once and K2 18 times a request (6 decoder layers x 3 levels;
              the bfloat16 model samples with the float32 kernel), K2's
              forward and backward 18 times a step; k2 and k2_backward also
              hold K2 at the first decoder layer's three MSDeformAttn sites
              (80², 40², 20² of 256 channels in 8 groups, 1,200 points,
              zeros padding, the seeded decoder's own coordinates,
              `rtdetr_sites`) against its plain version, with the off-map
              share, the window misses and F.grid_sample (zeros) beside it;
 48. parity_rtdetr - card against CPU on 2 frames, query by query (each
              device's top-300 recorded; where they part, each parted
              token named and held to a near-tie, and the card's forward
              taken again under the CPU's selection): the final layer's
              boxes within 0.05 px, scores 1e-3, equal classes;
              parity_rtdetr_bf16 at parity_bf16's bars under the CPU float32's
              selection; train_parity_rtdetr - train_parity at 256 from
              zeroed final box layers (`rtdetr_anchor_boxes`, RT-DETR's
              published decoder initialization) under the CPU's selection
              and matchings (the card's own recorded: the count that
              differ, each a named near-tie): the loss items and BatchNorm
              statistics at train_parity's bars, every leaf within half its
              largest of float64 (RTDETR_LEAF_BAR: no float32 run reaches
              1e-3 of it on this step); train_parity_decoder_rtdetr - the
              decoder and its loss alone on one float32 pyramid, at
              train_parity's rules: the items within 1e-4, the last decoder
              layer's MSDeformAttn leaves card against CPU within 1e-3 of
              their largest, every decoder leaf against float64;
 49. facade_rtdetr - DetectionPredictor, DetectionValidator and
              YOLO.train/val/predict refuse RT-DETR on the card (ROADMAP
              Queue 3);
 50. zoo_rtdetr - rtdetr-x, rtdetr-resnet50 and rtdetr-resnet101 at 320 as
              zoo (decode query by query as parity_rtdetr; K1 once and K2
              18 times a forward, K2's forward and backward 18 times a step).
The module catalogue (utils/benchmarks.py: 9 upsamplers, 26 attentions):
 51. k2, k2_backward (float32) also at DAttention's sites in the catalogue's
              DeBiAttention_YOLO (`dattention_sites`: x 4x256x256x64 and
              1x64x64x64, two channel groups of 32, 128x128 or 32x32 points
              a group from its offset network, border padding, clipped
              coordinates) against the plain versions at TOL, with the
              bound on the bytes the taps need beside the whole map's and
              F.grid_sample's time (border);
 52. catalogue - each of the 35 entries card against CPU at a small shape
              (TF32 off, within 1e-4 of the CPU's largest), then timed with
              CUDA events at the reference shape (2x64x64x64, 4x256x256x64)
              or, where `catalogue_score_bytes` reckons its score tensors
              above half the card's memory before anything runs (MHSA,
              BoTAttention, HiLo, DeBiAttention_YOLO), at 1x64x64x64; ms a
              call, peak bytes, and K2's launches a call (DySample and
              DeBiAttention_YOLO once, every other entry none; then one
              forward and backward of those two: K2's forward and backward
              once each); counts set to 0 before each entry's calls and read
              after them.
The pools' last rows (LDA-DBL-s: yolov13_DBL.yaml at s with its three
DySample rows written as LDA_AQU, tests/torch_fixtures.py `lda_dbl`, nc=3, 9,611,997 parameters,
seeded random weights; TF32 off in the parity phases):
 53. k2, k2_backward (float32) also at LDA-DBL-s's six K2 sites (`lda_sites`:
              rows 13, 18, 22; the keys (B, h, w, C/4) and the input (B, h,
              w, C) each at 9 taps a 2x query in 2 groups, border padding,
              the seeded model's own coordinates at batch 8 and 16) and at
              DLUPack's (`dlupack_sites`: the 2x64x64x25 kernel field at
              128² align-corners points) against the plain versions at TOL,
              with the taps' and the whole map's bounds, the output bytes,
              the off-map share, the window misses and F.grid_sample
              (border; align_corners=True for DLUPack);
 54. pools    - the pools' other modules (21 entries: CARAFEplusplus up and
              down, CAA, WTConv2d, C2f_PIG n=1 and 4, C2f_WT, GhostModuleV2,
              GhostBottleneckV2, ASFF at 3 levels and ASFFmobile,
              PSAModule, CPCA, Outlooker, EdgeAwareAttentionV2 in both alpha
              modes, LDA_AQU, DLUPack, LoftUp) card against CPU at batch 1
              on 16 px (TF32 off, 1e-4 of the CPU's largest), then timed with
              CUDA events at batch 2 on 64 px; K2's launches a call (LDA_AQU
              2, DLUPack 1; then one forward and backward each);
 55. main_lda, profile_lda, train_lda, train_profile_lda, parity_lda,
              train_parity_lda - LDA-DBL-s as main, profile, train and
              parity in float32: K1 once and K2 6 times a request, K2's
              forward and backward 6 times a step; train_parity_lda under
              the CPU's tap cells (`pinned_cells`: the card's and the float64
              reference's taps that round across a pixel boundary move into
              the CPU's cell, each by at most LDA_PIN_PX).
The `nn/structures` rows (tests/torch_fixtures.py `swin_giraffe`):
 56. main_swin, profile_swin, train_swin, train_profile_swin, parity_swin,
              train_parity_swin - Swin-T-Giraffe (a Swin-T backbone at its
              published widths, C 96, depths 2-2-6-2, window 7, into
              DAMO-YOLO-S's GiraffeNeckV2, nc=3) as main, profile, train
              and parity in float32: K1 once a request, no kernel in a step;
              train_parity_swin names the 12 window attentions' qkv Dense
              leaves (their gradient through the plain attention);
 57. structures - the other 15 structure rows' modules (Index, UIB, MQA,
              MFA, RepViTBlock, GhostModuleV3, GhostBottleneckV3,
              RepGhostBottleneck, RepLKBlock, GGhostBottleneck, GGhostStage,
              EffBlock, MBConv, ScConv, APConv) at their sources' published
              widths and MobileNetV3-large: card against CPU at batch 1 on a
              quarter of the side (TF32 off, within 1e-4 of the CPU's
              largest), then timed with CUDA events at batch 8 on the P3, P4
              or P5 map of a 640 detector (MobileNetV3-large on 224 images):
              ms a call, peak bytes; no kernel launches.
Then a line counting the profiler traces the kernel times took again ("timing"),
the kernel table line ({"kernels": [...]}, each row's `time_sources` saying
whether a time is the profiler's device time or, where three traces lost
kernel events, CUDA-event time), the card's name and power limit
from nvidia-smi, and last {"ok": true, "device": {...}}. Any failure raises and
exits non-zero before the result lines; without CUDA it exits 2.
"""

import contextlib
import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_PASSES = 3  # 3xTF32: float32-accurate products on the tensor cores
MUFU_PER_CLOCK = 16  # exponentials a clock per SM on the special-function units (sm_90)
# bfloat16 terms a float32 P or dS is split into, for its product with a
# bfloat16 input to meet the bars: the fewest, as csrc/attention.cu ships them
# (tests/test_torch_attention_split.py emulates the forward's P V, dq's dS K
# and dkv's dV and dK, and holds this line to the source)
BF16_TERMS = {"forward": 2, "dq": 3, "dkv": 3}
TOL = 1e-5
B, SRC_HW, IMGSZ, NC = 8, (512, 768), 640, 3
REQUESTS, WARMUP = 5, 2
TRAIN_B, TRAIN_M, TRAIN_WARMUP, TRAIN_STEPS = 16, 16, 2, 5
# (H, W, C) of the DySample inputs of YOLO-DBL-s at 640 (rows 13, 18, 22); scale 2, 4 groups
DYSAMPLE_SITES = {"row13": (40, 40, 256), "row18": (20, 20, 512), "row22": (40, 40, 256)}
GROUPS = 4
# (H, W, C) of two of YOLO-DBL2-l's DySample inputs at 640 (rows 18 and 13;
# row 22 is row 13's shape): 256 and 128 channels a group
DBL2_SITES = {"dbl2_row18": (20, 20, 1024), "dbl2_row13": (40, 40, 512)}
DBL, V13, DBL2 = ("yolov13s_DBL.yaml", NC), ("yolov13s.yaml", 80), ("yolov13l_DBL2.yaml", NC)
# the stock detect families' full-width paths, at the configs' own nc
V12, V11 = ("yolov12s.yaml", 80), ("yolo11s.yaml", 80)
# the v10, v9 and v7 families' full-width paths: YOLOv10-s (v10Detect and its
# e2e loss), YOLOv9-s, YOLOv7 (IDetect: serving only, JAX has no loss for it)
V10, V9, V7 = ("yolov10s.yaml", 80), ("yolov9s.yaml", 80), ("yolov7.yaml", 80)
# the task heads' full-width paths: yolo11-s with Segment (nc=80) and Pose
# (nc=1, 17 keypoints of 3), and the classifier (nc=1000) at its 224
SEG, POSE, CLS = ("yolo11s-seg.yaml", 80), ("yolo11s-pose.yaml", 1), ("yolo11s-cls.yaml", 1000)
CLS_IMGSZ = 224
# the OBB head's full-width path: YOLO11-s-obb at DOTAv1's 15 classes, serving
# 1024x1024 uint8 tiles at imgsz 1024 (gain 1, no padding) and training on
# them with up to 64 rotated GTs a tile (Ultralytics' OBB models' imgsz)
OBB = ("yolo11s-obb.yaml", 15)
OBB_IMGSZ, OBB_M = 1024, 64
# the module pools' full-width paths: YOLOv8-s-worldv2 with 80 seeded prompts,
# and YOLO-EMAC at its default (s) scale
WORLD, EMAC = ("yolov8s-worldv2.yaml", 80), ("YOLO-EMAC.yaml", 80)
# RT-DETR's full-width path: RT-DETR-l (HGNetV2, AIFI, the deformable decoder)
# at COCO's 80 classes, served through DetectionModel.predict (K1, the forward,
# rtdetr_postprocess: no NMS) and trained with rtdetr_loss on 8-64 GTs an image
RTDETR = ("rtdetr-l.yaml", 80)
RTDETR_M = 64
# MSDeformAttn's K2 sites in RT-DETR-l at 640: the P3-P5 maps (H, W) of 256
# channels in 8 heads of 32, sampled at 300 queries x 4 points a head, once a
# level in each of the 6 decoder layers
RTDETR_LEVELS = {"p3": (80, 80), "p4": (40, 40), "p5": (20, 20)}
RTDETR_HEADS, RTDETR_LAYERS = 8, 6
# LDA-DBL-s: YOLO-DBL-s with its three DySample rows (13, 18, 22) written as
# LDA_AQU, built from the port's YAML in memory (tests/torch_fixtures.py
# `lda_dbl`): K2 samples the
# keys and the input at 9 taps a hi-res query, 2 groups, border padding
LDA = ("yolov13s_DBL_LDA.yaml", NC)
LDA_ROWS = (13, 18, 22)
# Swin-T-Giraffe: a Swin-T backbone into DAMO-YOLO-S's GiraffeNeckV2 at their
# published widths (tests/torch_fixtures.py `swin_giraffe`), built from its dict
SWIN = ("swin-t-giraffe.yaml", NC)
# the farthest train_parity_lda may move a tap into another run's cell: twice
# the farthest float32 put a K2 coordinate of LDA-DBL-s's train step from
# float64 on the CPU (tools/exp_lda_conditioning.py, seeds (0, 2), (0, 3),
# (1, 2), (1, 5): 1.07e-3 px at 6 threads, 3.66e-3 px at 1), since two float32
# runs may each sit that far from float64, on either side of a boundary
LDA_PIN_PX = 7.5e-3
SUFFIX = {DBL: "", LDA: "_lda", V13: "_v13", DBL2: "_dbl2", V12: "_v12", V11: "_v11", V10: "_v10", V9: "_v9",
          V7: "_v7", SEG: "_seg", POSE: "_pose", CLS: "_cls", OBB: "_obb", WORLD: "_world",
          EMAC: "_emac", RTDETR: "_rtdetr", SWIN: "_swin"}
# YOLOv13-s A2C2f sites at 640: (areas, N, heads) per image; each site runs
# 4 AAttn (2 repeats x 2 ABlocks), hd 32. Row 6: 40x40 tokens in 4 areas.
# YOLOv12-s's rows 6 and 8 are the same two sites.
K3_SITES = {"row6": (4, 400, 4), "row8": (1, 400, 8)}
K3_CALLS_PER_SITE = 4
HD = 32
# kernel launches per request (serving) and per step (training) on each path
BF16 = torch.bfloat16
KERNELS = ("letterbox_normalize", "sample_bilinear", "sample_bilinear_backward",
           "area_attention", "area_attention_backward_dq", "area_attention_backward_dkv")
NO_LAUNCH = {name + suffix: 0 for suffix in ("", "_bf16") for name in KERNELS}


def _launches(counts, dtype):
    """Launch counts of the kernels of `dtype` ({name: n}), every other 0."""
    suffix = "_bf16" if dtype == BF16 else ""
    return {**NO_LAUNCH, **{name + suffix: n for name, n in counts.items()}}


PER_REQUEST = {(cfg, dt): _launches(c, dt) for dt in (torch.float32, BF16) for cfg, c in (
    (DBL, {"letterbox_normalize": 1, "sample_bilinear": 3}),
    (DBL2, {"letterbox_normalize": 1, "sample_bilinear": 3}),
    (V13, {"letterbox_normalize": 1, "area_attention": 8}),
    (V12, {"letterbox_normalize": 1, "area_attention": 8}),
    (V11, {"letterbox_normalize": 1}), (V10, {"letterbox_normalize": 1}),
    (V9, {"letterbox_normalize": 1}), (V7, {"letterbox_normalize": 1}),
    (SEG, {"letterbox_normalize": 1}), (POSE, {"letterbox_normalize": 1}),
    (CLS, {"letterbox_normalize": 1}), (OBB, {"letterbox_normalize": 1}),
    (WORLD, {"letterbox_normalize": 1}), (EMAC, {"letterbox_normalize": 1}),
    (SWIN, {"letterbox_normalize": 1}))}
# LDA-DBL-s: two K2 launches (keys, input) at each of the three LDA_AQU rows
PER_REQUEST[LDA, torch.float32] = _launches({"letterbox_normalize": 1, "sample_bilinear": 6},
                                            torch.float32)
PER_STEP = {(cfg, dt): _launches(c, dt) for dt in (torch.float32, BF16) for cfg, c in (
    (DBL, {"sample_bilinear": 3, "sample_bilinear_backward": 3}),
    (DBL2, {"sample_bilinear": 3, "sample_bilinear_backward": 3}),
    (V13, {"area_attention": 8, "area_attention_backward_dq": 8,
           "area_attention_backward_dkv": 8}),
    (V12, {"area_attention": 8, "area_attention_backward_dq": 8,
           "area_attention_backward_dkv": 8}),
    (V11, {}), (V10, {}), (V9, {}), (SEG, {}), (POSE, {}), (OBB, {}), (WORLD, {}),
    (EMAC, {}), (SWIN, {}))}
# RT-DETR: K2 (zeros) once a level in each decoder layer, 18 a forward; a
# bfloat16 model samples its upcast value with the float32 kernel at float32
# coordinates, as JAX promotes that sample (models/rtdetr.py); it trains in
# float32 only
RTDETR_K2 = RTDETR_LAYERS * len(RTDETR_LEVELS)
PER_REQUEST[RTDETR, torch.float32] = _launches({"letterbox_normalize": 1,
                                                "sample_bilinear": RTDETR_K2}, torch.float32)
PER_REQUEST[RTDETR, BF16] = {**NO_LAUNCH, "letterbox_normalize_bf16": 1,
                             "sample_bilinear": RTDETR_K2}
PER_STEP[RTDETR, torch.float32] = _launches({"sample_bilinear": RTDETR_K2,
                                             "sample_bilinear_backward": RTDETR_K2}, torch.float32)
PER_STEP[LDA, torch.float32] = _launches({"sample_bilinear": 6, "sample_bilinear_backward": 6},
                                         torch.float32)


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(what)


def _device_events(prof):
    """The device's kernel, copy and fill events of a trace: not the
    annotations that span a profiler step (`ProfilerStep*`), whose device
    time is the whole step's."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def _trace(fn, calls):
    """The device events of fn(0), ..., fn(calls - 1), traced by
    torch.profiler. Tracing starts one warm-up call before the recorded ones
    (the profiler's schedule), so no recorded call runs while the profiler
    sets itself up."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn(0)
        torch.cuda.synchronize()
        prof.step()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        prof.step()
    return _device_events(prof)


# traces timings took, those it took again, and the times it gave from CUDA events
TRACES = {"traces": 0, "retaken": 0, "cuda_event_times": 0}
SECONDS = {}  # wall seconds of each part of main, printed in the "timing" line


@contextlib.contextmanager
def took(name):
    """Time a part of main: its wall seconds go to SECONDS and to stderr."""
    t0 = time.perf_counter()
    yield
    SECONDS[name] = time.perf_counter() - t0
    print(f"chip_smoke: {name} took {SECONDS[name]:.1f} s", file=sys.stderr, flush=True)


def timings(fn, iters, warmup=3, only=None):
    """(device_ms, call_ms, source) per call of fn(i). device_ms sums the
    device time of the kernels a call runs (torch.profiler), or of those
    whose name holds `only`, so host launch overhead does not count;
    call_ms is CUDA-event time over back-to-back calls, which does include
    it when the host is slower than the card. Every call launches the same
    kernels, so in a trace that kept them all each kernel's events number a
    multiple of `iters` (a check of the total alone passed a trace that had
    lost whole calls' records); one that did not is taken again, and after
    three such traces device_ms is call_ms and `source` says "cuda_event"
    (else "profiler")."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    for attempt in range(3):
        TRACES["traces"] += 1
        TRACES["retaken"] += attempt > 0
        events = [e for e in _trace(fn, iters) if only is None or only in e.key]
        n_events = sum(e.count for e in events)
        device_us = sum(e.self_device_time_total for e in events)
        short = [(e.key[:60], e.count) for e in events if e.count % iters]
        if n_events and not short and device_us > 0:
            return device_us / 1e3 / iters, call_ms, "profiler"
        print(f"chip_smoke: a trace of {iters} calls held {n_events} kernel events, these not a "
              f"multiple of the calls: {short[:6]}", file=sys.stderr)
    TRACES["cuda_event_times"] += 1
    print("chip_smoke: torch.profiler lost kernel events in three traces; CUDA-event time "
          "used", file=sys.stderr)
    return call_ms, call_ms, "cuda_event"


def source_of(*sources):
    """One source for a time summed from timings of these sources (None: a
    site where that time was not taken)."""
    return "profiler" if set(sources) - {None} == {"profiler"} else "cuda_event"


def _larger(t_bytes, t_ops):
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(n_bytes, n_flops, peak_flops=PEAK_FP32_FLOPS):
    return _larger(n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops)


@functools.cache
def sm_clock_max_mhz():
    """The card's top SM clock, as nvidia-smi gives it (clocks.max.sm)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def mufu_per_s():
    """Exponentials a second on the card's special-function units:
    MUFU_PER_CLOCK a clock per SM at the top SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_CLOCK * sms * sm_clock_max_mhz() * 1e6


def bound_products(dtype, n_bytes, input_flops, mixed_flops, exps, terms):
    """{bound_ms, bound_by, bound_route, bound_simt_ms, bound_mufu_ms} of
    area attention: the largest of three times. The bytes. The matrix
    products at the accuracy the bars ask for, on the faster of two routes:
    `input_flops` are products of two inputs (q kT, dO vT), `mixed_flops`
    products of a float32 intermediate (P, dS) and an input. On the CUDA
    cores fp32 FMAs (bound_simt_ms: that route with the bytes). On the
    tensor cores float32 inputs take 3 TF32 passes a product (3xTF32).
    bfloat16 inputs are exact in bfloat16, and the product of two is exact
    in float32: one bfloat16 pass; a float32 intermediate times a bfloat16
    input takes one bfloat16 pass a term of the intermediate, `terms` the
    fewest that meet the bars (BF16_TERMS; 2 or 3 bfloat16 passes beat the
    2 TF32 passes, each at half the bfloat16 rate, that the same product
    takes with its bfloat16 input exact in TF32). And the `exps`
    exponentials (one a score) on the special-function units
    (bound_mufu_ms, at mufu_per_s). bound_by is "bytes" or "operations";
    bound_route says which of bytes, products and mufu sets the bound."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    if dtype == BF16:
        t_tensor = (input_flops + terms * mixed_flops) / PEAK_BF16_FLOPS
    else:
        t_tensor = TF32_PASSES * (input_flops + mixed_flops) / PEAK_TF32_FLOPS
    t_products = min(t_tensor, (input_flops + mixed_flops) / PEAK_FP32_FLOPS)
    t_mufu = exps / mufu_per_s()
    bound_ms, bound_by = _larger(t_bytes, max(t_products, t_mufu))
    route = ("bytes" if bound_by == "bytes" else "products" if t_products >= t_mufu else "mufu")
    return dict(bound_ms=bound_ms, bound_by=bound_by, bound_route=route,
                bound_simt_ms=bound(n_bytes, input_flops + mixed_flops)[0],
                bound_mufu_ms=t_mufu * 1e3)


def bf16_excess(got, want, scale):
    """(max |got - want|, the largest excess over one bfloat16 step of `want`
    plus 1e-6 of `scale`: <= 0 passes). Both are float32 results of the same
    sums in other orders, each rounded once to bfloat16; near 0 the rounding
    of the float32 sums' last bits shows, hence the floor."""
    require(got.dtype == want.dtype == BF16, f"expected bfloat16, got {got.dtype}, {want.dtype}")
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    d = (g - w).abs()
    return float(d.max()), float((d - ulp - 1e-6 * scale).max())


def meets_bar(got, want, f32_bar, scale):
    """Whether a kernel's result meets its bar against the plain version's:
    float32 within `f32_bar`; bfloat16 within one bfloat16 step of `want`
    plus 1e-6 of `scale` (bf16_excess)."""
    if got.dtype == BF16:
        return bf16_excess(got, want, scale)[1] <= 0
    return float((got - want).abs().max()) <= f32_bar


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def _kphase(base, dtype):
    """The name of kernel phase `base` for a type: `k2`, `k2_bf16`, ..."""
    return base + ("_bf16" if dtype == BF16 else "")


BF16_BAR = "one bfloat16 step + 1e-6 of the terms' scale"


def copies_for(n_bytes):
    """Input copies to rotate through so a timed loop reads past the 50 MB L2."""
    return max(2, int(np.ceil(100e6 / n_bytes)))


# (batch, frame, canvas) of the odd geometry k1 checks: canvas width 330, 4
# rows of top pad, 333 x 3 bytes a frame row, frames starting mid-chunk
K1_ODD = (2, (251, 333), (257, 330))


def k1_source_bytes(b, hw, new_h):
    """The uint8 source bytes K1 must read for `b` frames of `hw` resized to
    `new_h` rows: each distinct source row the row taps touch, whole. At a
    gain below 1/2 the taps skip rows (224^2 from 512 rows: 298 of them);
    within a row the column taps skip pixels too, but their pairs lie about
    10 bytes apart, so every 32-byte sector the card reads holds one."""
    from yolo_dbl_tpu_torch.kernels.preprocess import _taps

    y0, y1, _ = _taps(new_h, hw[0], "cpu")
    return b * len(set(y0.tolist()) | set(y1.tolist())) * hw[1] * 3


def _k1_at_1024(gen):
    """K1 at the OBB path's shape: 8 uint8 1024x1024 tiles → 1024² (gain 1,
    no padding), float32 and bfloat16 out, against its plain version
    (float32 within 1e-5, bfloat16 within 4e-3) and timed beside its byte
    bound, the plain version and the library's bilinear resize and /255."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize, letterbox_normalize_plain

    hw = (OBB_IMGSZ, OBB_IMGSZ)
    tiles = [torch.randint(0, 256, (B, *hw, 3), dtype=torch.uint8, generator=gen).cuda()
             for _ in range(copies_for(B * OBB_IMGSZ ** 2 * 3))]
    n = len(tiles)

    def library(f, dt):
        x = F.interpolate(f.permute(0, 3, 1, 2).float(), size=hw, mode="bilinear",
                          align_corners=False, antialias=False)
        return (x / 255.0).to(dt)  # gain 1: no padding

    out = {}
    for dt, tol in ((torch.float32, TOL), (torch.bfloat16, 4e-3)):
        err = float((letterbox_normalize(tiles[0], hw, out_dtype=dt).float()
                     - letterbox_normalize_plain(tiles[0], hw, out_dtype=dt).float()).abs().max())
        require(err <= tol, f"letterbox kernel vs plain at 1024^2 ({dt}): max |d| {err}")
        ms, call_ms, s1 = timings(lambda i: letterbox_normalize(tiles[i % n], hw, out_dtype=dt), 50)
        plain_ms, _, s2 = timings(lambda i: letterbox_normalize_plain(tiles[i % n], hw,
                                                                      out_dtype=dt), 10)
        library_ms, _, s3 = timings(lambda i: library(tiles[i % n], dt), 20)
        n_out = B * OBB_IMGSZ ** 2 * 3
        bound_ms, bound_by = bound(k1_source_bytes(B, hw, OBB_IMGSZ) + n_out * dt.itemsize,
                                   n_out * 10)
        out[str(dt).split(".")[-1]] = dict(
            shape=[B, *hw, 3], max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            time_sources=_time_sources([(s1, s2, s3)]))
    del tiles
    torch.cuda.empty_cache()
    return out


def phase_k1(gen):
    from yolo_dbl_tpu_torch.kernels.preprocess import (letterbox_geometry, letterbox_normalize,
                                                       letterbox_normalize_plain)

    frames = [torch.randint(0, 256, (B, *SRC_HW, 3), dtype=torch.uint8, generator=gen).cuda()
              for _ in range(copies_for(B * SRC_HW[0] * SRC_HW[1] * 3))]
    out = letterbox_normalize(frames[0], (IMGSZ, IMGSZ))
    ref = letterbox_normalize_plain(frames[0], (IMGSZ, IMGSZ))
    err = float((out - ref).abs().max())
    err_bf16 = float((letterbox_normalize(frames[0], (IMGSZ, IMGSZ), out_dtype=torch.bfloat16).float()
                      - ref.to(torch.bfloat16).float()).abs().max())
    require(err <= TOL, f"letterbox kernel vs plain: max |d| {err} > {TOL}")
    require(err_bf16 <= 4e-3, f"letterbox kernel bf16 vs plain: max |d| {err_bf16}")
    ob, o_in, o_out = K1_ODD
    odd = torch.randint(0, 256, (ob + 1, *o_in, 3), dtype=torch.uint8, generator=gen).cuda()[1:]
    odd_err = {str(dt).split(".")[-1]: float((letterbox_normalize(odd, o_out, out_dtype=dt).float()
                                              - letterbox_normalize_plain(odd, o_out, out_dtype=dt)
                                              .float()).abs().max())
               for dt in (torch.float32, torch.bfloat16)}
    require(odd_err["float32"] <= TOL and odd_err["bfloat16"] <= 4e-3,
            f"letterbox kernel vs plain at {K1_ODD}: {odd_err}")

    _, new_h, new_w, top, left = letterbox_geometry(*SRC_HW, IMGSZ, IMGSZ, scaleup=False)

    def library(f):
        x = F.interpolate(f.permute(0, 3, 1, 2).float(), size=(new_h, new_w), mode="bilinear",
                          align_corners=False, antialias=False)
        x = F.pad(x, (left, IMGSZ - new_w - left, top, IMGSZ - new_h - top), value=114.0)
        return x / 255.0

    lib_err = float((library(frames[0]).permute(0, 2, 3, 1) - out).abs().max())
    n = len(frames)
    ms, call_ms, s1 = timings(lambda i: letterbox_normalize(frames[i % n], (IMGSZ, IMGSZ)), 50)
    ms_bf16, call_ms_bf16, s1_bf16 = timings(lambda i: letterbox_normalize(
        frames[i % n], (IMGSZ, IMGSZ), out_dtype=torch.bfloat16), 50)
    plain_ms, plain_call_ms, s2 = timings(
        lambda i: letterbox_normalize_plain(frames[i % n], (IMGSZ, IMGSZ)), 10)
    plain_ms_bf16, _, s2_bf16 = timings(lambda i: letterbox_normalize_plain(
        frames[i % n], (IMGSZ, IMGSZ), out_dtype=torch.bfloat16), 10)
    library_ms, library_call_ms, s3 = timings(lambda i: library(frames[i % n]), 20)
    library_ms_bf16, _, s3_bf16 = timings(lambda i: library(frames[i % n]).to(torch.bfloat16), 20)
    n_in, n_out = k1_source_bytes(B, SRC_HW, new_h), B * IMGSZ * IMGSZ * 3
    # per output value: 2 row blends + 1 column blend (3 ops each) and the /255
    bound_ms, bound_by = bound(n_in + n_out * 4, B * new_h * new_w * 3 * 10)
    bound_ms_bf16, bound_by_bf16 = bound(n_in + n_out * 2, B * new_h * new_w * 3 * 10)
    # the classifier's canvas: 512x768 -> 224^2 (float32)
    c224 = (CLS_IMGSZ, CLS_IMGSZ)
    err_224 = float((letterbox_normalize(frames[0], c224)
                     - letterbox_normalize_plain(frames[0], c224)).abs().max())
    require(err_224 <= TOL, f"letterbox kernel vs plain at 224: max |d| {err_224} > {TOL}")
    ms_224, call_ms_224, s_224 = timings(lambda i: letterbox_normalize(frames[i % n], c224), 50)
    plain_ms_224, _, _ = timings(lambda i: letterbox_normalize_plain(frames[i % n], c224), 10)
    _, h224, w224, _, _ = letterbox_geometry(*SRC_HW, *c224, scaleup=False)
    bound_224, bound_by_224 = bound(k1_source_bytes(B, SRC_HW, h224) + B * CLS_IMGSZ ** 2 * 3 * 4,
                                    B * h224 * w224 * 3 * 10)
    canvas_1024 = _k1_at_1024(gen)
    common = dict(route="cuda", source="yolo_dbl_tpu_torch/csrc/preprocess.cu",
                  replaces="yolo_dbl_tpu/kernels/preprocess.py:144")
    row = dict(name="letterbox_normalize", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               time_sources=_time_sources([(s1, s2, s3)]), canvas_1024=canvas_1024["float32"],
               **common)
    row_bf16 = dict(name="letterbox_normalize_bf16", max_abs_err=err_bf16, ms=ms_bf16,
                    plain_ms=plain_ms_bf16, bound_ms=bound_ms_bf16, bound_by=bound_by_bf16,
                    library_ms=library_ms_bf16,
                    time_sources=_time_sources([(s1_bf16, s2_bf16, s3_bf16)]),
                    canvas_1024=canvas_1024["bfloat16"], **common)
    emit({"phase": "k1", "shape": [B, *SRC_HW, 3], "out": [B, IMGSZ, IMGSZ, 3],
          "max_abs_err_f32": err, "max_abs_err_bf16": err_bf16, "library_vs_kernel": lib_err,
          "odd_geometry": {"batch": ob, "frame": list(o_in), "canvas": list(o_out),
                           "max_abs_err": odd_err},
          "canvas_224": {"max_abs_err": err_224, "ms": ms_224, "call_ms": call_ms_224,
                         "plain_ms": plain_ms_224, "bound_ms": bound_224,
                         "bound_by": bound_by_224, "time_source": s_224},
          "canvas_1024": canvas_1024,
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
          "ms_bf16": ms_bf16, "bound_ms_bf16": bound_ms_bf16, "plain_ms_bf16": plain_ms_bf16,
          "library_ms_bf16": library_ms_bf16,
          "call_ms": call_ms, "call_ms_bf16": call_ms_bf16, "plain_call_ms": plain_call_ms,
          "library_call_ms": library_call_ms})
    return row, row_bf16


def _site_coords(gen, h, w, s=2, b=B, dtype=torch.float32):
    """DySample-like pixel coordinates (B, N, G) in `dtype`: each output point
    near its source position with offsets of about a pixel, so edges clip."""
    oy = (torch.arange(h * s, dtype=torch.float32) + 0.5) / s - 0.5
    ox = (torch.arange(w * s, dtype=torch.float32) + 0.5) / s - 0.5
    gy, gx = torch.meshgrid(oy, ox, indexing="ij")
    shape = (b, h * s * w * s, GROUPS)
    gy = gy.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    gx = gx.reshape(1, -1, 1) + torch.randn(shape, generator=gen) * 0.75
    return gy.cuda().to(dtype).contiguous(), gx.cuda().to(dtype).contiguous()


def _site_inputs(gen, b, h, w, c, dtype, n_bytes):
    """Copies of a site's x (B, H, W, C) in `dtype`, to rotate through so a
    timed loop reads past L2 (`n_bytes` a copy, with what is read beside it)."""
    return [torch.randn((b, h, w, c), generator=gen).cuda().to(dtype)
            for _ in range(copies_for(n_bytes))]


def _uniform_coords(gen, gy, h, w, dtype):
    """Coordinates drawn uniformly over the image and a pixel past its edges."""
    uy = (torch.rand(gy.shape, generator=gen) * (h + 2) - 1.5).cuda().to(dtype)
    ux = (torch.rand(gy.shape, generator=gen) * (w + 2) - 1.5).cuda().to(dtype)
    return uy, ux


def _library_layout(xs, gy, gx):
    """The library yardstick's layout: F.grid_sample over (B*G, C/G, H, W)
    planes of each NHWC x, with one normalized grid per group, in x's type
    (formed in float32)."""
    b, h, w, c = xs[0].shape
    cg = c // GROUPS
    planes = [x.reshape(b, h, w, GROUPS, cg).permute(0, 3, 4, 1, 2).reshape(b * GROUPS, cg, h, w)
              .contiguous() for x in xs]
    gy, gx = gy.float(), gx.float()
    grid = torch.stack([(gx + 0.5) * 2 / w - 1, (gy + 0.5) * 2 / h - 1], -1)
    grid = grid.permute(0, 2, 1, 3).reshape(b * GROUPS, 2 * h, 2 * w, 2).to(xs[0].dtype)
    return planes, grid.contiguous()


def _by(rows, key="bound_by"):
    return "bytes" if {r[key] for r in rows} == {"bytes"} else "operations"


def _route(rows, prefix=""):
    """The route that bounds every site, or "mixed"."""
    routes = {r[prefix + "bound_route"] for r in rows}
    return routes.pop() if len(routes) == 1 else "mixed"


def phase_k2(gen, dtype=torch.float32, deform=None, dattention=None, lda=None, dlupack=None):
    """The sampler's forward kernel of `dtype` against its plain version at
    the three sites at serving batch 8, both padding modes, DySample and
    uniform coordinates; F.grid_sample in `dtype` as the yardstick. With
    `deform` (`rtdetr_sites`' batch 8), also at MSDeformAttn's three sites
    (`deform_k2_sites`; float32: RT-DETR samples in float32 in either type);
    with `dattention` (`dattention_sites`), at DAttention's two (border);
    with `lda` (`lda_sites`' batch 8), at LDA-DBL-s's six (three rows, keys
    and input; border); with `dlupack` (`dlupack_sites`), at DLUPack's
    (align corners, border)."""
    from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear, sample_bilinear_plain

    es, sites, worst, src = dtype.itemsize, {}, 0.0, []
    for site, (h, w, c) in {**DYSAMPLE_SITES, **DBL2_SITES}.items():
        n_x = B * h * w * c
        xs = _site_inputs(gen, B, h, w, c, dtype, n_x * es)
        gy, gx = _site_coords(gen, h, w, dtype=dtype)
        uy, ux = _uniform_coords(gen, gy, h, w, dtype)
        x_max, errs, ok = float(xs[0].abs().max()), {}, True
        for mode in ("border", "zeros"):
            for name, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                got = sample_bilinear(xs[0], cy, cx, mode)
                want = sample_bilinear_plain(xs[0], cy, cx, mode)
                errs[f"{mode}/{name}"] = max_abs(got, want)
                ok = ok and meets_bar(got, want, TOL, x_max)
        require(ok, f"sampler kernel vs plain at {site} ({dtype}): {errs}")
        worst = max(worst, max(errs.values()))

        cg, n = c // GROUPS, gy.shape[1]
        planes, grid = _library_layout(xs, gy, gx)

        def library(p):
            return F.grid_sample(p, grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        lib = library(planes[0]).reshape(B, GROUPS, cg, n).permute(0, 3, 1, 2).reshape(B, n, c)
        lib_err = max_abs(lib, sample_bilinear(xs[0], gy, gx))
        k = len(xs)
        ms, call_ms, s1 = timings(lambda i: sample_bilinear(xs[i % k], gy, gx), 50)
        plain_ms, plain_call_ms, s2 = timings(lambda i: sample_bilinear_plain(xs[i % k], gy, gx),
                                              10)
        library_ms, library_call_ms, s3 = timings(lambda i: library(planes[i % k]), 50)
        src.append((s1, s2, s3))
        # x read, out written, the coordinates read
        n_bytes = (n_x + B * n * c + 2 * B * n * GROUPS) * es
        bound_ms, bound_by = bound(n_bytes, B * n * c * 11)
        sites[site] = dict(x=[B, h, w, c], n=n, groups=GROUPS, max_abs_err=errs,
                           library_vs_kernel=lib_err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           call_ms=call_ms, plain_call_ms=plain_call_ms,
                           library_call_ms=library_call_ms)
    extra = {}
    if deform is not None:
        deform_rows, deform_src = deform_k2_sites(deform)
        extra["rtdetr_l_sites"] = _rtdetr_row(deform_rows)
        src += deform_src
        worst = max(worst, max(r["max_abs_err"] for r in deform_rows.values()))
    if dattention is not None:
        rows_d, src_d = deform_k2_sites(dattention, "border", "DAttention")
        extra["dattention_sites"] = {"sites": rows_d, "bound_by": _by(rows_d.values())}
        src += src_d
        worst = max(worst, max(r["max_abs_err"] for r in rows_d.values()))
    if lda is not None:
        rows_l, src_l = deform_k2_sites(lda, "border", "LDA_AQU")
        extra["lda_dbl_s_sites"] = _lda_row(rows_l, "per_request")
        src += src_l
        worst = max(worst, max(r["max_abs_err"] for r in rows_l.values()))
    if dlupack is not None:
        rows_p, src_p = deform_k2_sites(dlupack, "border", "DLUPack", align_corners=True)
        extra["dlupack_sites"] = {"sites": rows_p, "bound_by": _by(rows_p.values())}
        src += src_p
        worst = max(worst, max(r["max_abs_err"] for r in rows_p.values()))
    emit({"phase": _kphase("k2", dtype), "sites": sites, **extra,
          **({"tolerance": BF16_BAR} if dtype == BF16 else {})})
    total = {key: sum(sites[s][key] for s in DYSAMPLE_SITES)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(name=_kphase("sample_bilinear", dtype), route="cuda",
                source="yolo_dbl_tpu_torch/csrc/sampling.cu",
                replaces="yolo_dbl_tpu/kernels/sampling.py:102", max_abs_err=worst,
                bound_by=_by(sites[s] for s in DYSAMPLE_SITES), time_sources=_time_sources(src),
                dbl2_l_sites=_dbl2_sites(sites, ("max_abs_err", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")), **extra, **total)


def _dbl2_sites(sites, keys):
    """The YOLO-DBL2-l sites' numbers for a kernel row (its own totals are
    YOLO-DBL-s's three sites, a request or step of its path)."""
    return {site: {"x": sites[site]["x"], "channels_a_group": sites[site]["x"][3] // GROUPS,
                   **{k: sites[site][k] for k in keys}} for site in DBL2_SITES}


def _time_sources(src, keys=("ms", "plain_ms", "library_ms")):
    """{row time: its source} from the sites' (source, ...) tuples."""
    return {key: source_of(*col) for key, col in zip(keys, zip(*src))}


def phase_k2_backward(gen, dtype=torch.float32, deform=None, dattention=None, lda=None,
                      dlupack=None):
    """The sampler's backward kernel of `dtype` at the three sites at
    training batch 16, and its forward kernel at the same shapes (the train
    step runs both), against their plain versions; with `deform`
    (`rtdetr_sites`' batch 16), at MSDeformAttn's three sites too
    (`deform_k2_backward_sites`); with `dattention`, at DAttention's two
    (border); with `lda` (`lda_sites`' batch 16), at LDA-DBL-s's six; with
    `dlupack`, at DLUPack's. Returns the backward's kernel row and the
    forward's worst error here."""
    from yolo_dbl_tpu_torch.kernels.sampling import (backward_shared_bytes,
                                                     backward_window_misses, sample_bilinear,
                                                     sample_bilinear_backward,
                                                     sample_bilinear_backward_plain,
                                                     sample_bilinear_plain)

    b, es, sites, src = TRAIN_B, dtype.itemsize, {}, []
    worst, worst_fwd = {"dx": 0.0, "dgy_rel": 0.0, "dgx_rel": 0.0}, 0.0
    for site, (h, w, c) in {**DYSAMPLE_SITES, **DBL2_SITES}.items():
        n_x, n, cg = b * h * w * c, 4 * h * w, c // GROUPS
        xs = _site_inputs(gen, b, h, w, c, dtype, (n_x + b * n * c) * es)
        k = len(xs)
        gs = [torch.randn((b, n, c), generator=gen).cuda().to(dtype) for _ in range(k)]
        gy, gx = _site_coords(gen, h, w, b=b, dtype=dtype)
        uy, ux = _uniform_coords(gen, gy, h, w, dtype)
        x_max, g_max = float(xs[0].abs().max()), float(gs[0].abs().max())
        errs, fwd_errs, missed, ok = {}, {}, {}, True
        for mode in ("border", "zeros"):
            for name, (cy, cx) in {"dysample": (gy, gx), "uniform": (uy, ux)}.items():
                case = f"{mode}/{name}"
                got = sample_bilinear(xs[0], cy, cx, mode)
                want = sample_bilinear_plain(xs[0], cy, cx, mode)
                fwd_errs[case] = max_abs(got, want)
                require(meets_bar(got, want, TOL, x_max),
                        f"sampler kernel vs plain at {site}, batch {b} ({dtype}): {case} "
                        f"{fwd_errs[case]}")
                # the window is the coordinates' (the kernels form taps in
                # float32 from either type): read on the counted float32 build
                taps, miss = backward_window_misses(*(t.float() for t in (xs[0], cy, cx, gs[0])),
                                                    mode)
                missed[case] = miss / taps
                got = sample_bilinear_backward(xs[0], cy, cx, gs[0], mode)
                want = sample_bilinear_backward_plain(xs[0], cy, cx, gs[0], mode)
                e = {"dx": max_abs(got[0], want[0])}
                e.update({f"{nm}_rel": max_abs(a, r) / float(r.float().abs().max())
                          for nm, a, r in zip(("dgy", "dgx"), got[1:], want[1:])})
                errs[case] = e
                worst = {key: max(worst[key], e[key]) for key in worst}
                ok = ok and meets_bar(got[0], want[0], 1e-4, 4 * g_max) and all(
                    meets_bar(a, r, 1e-4 * float(r.abs().max()), cg * g_max * x_max)
                    for a, r in zip(got[1:], want[1:]))
        require(ok, f"sampler backward kernel vs plain at {site} ({dtype}): {errs}")
        worst_fwd = max(worst_fwd, max(fwd_errs.values()))

        planes, grid = _library_layout(xs, gy, gx)
        planes = [p.requires_grad_() for p in planes]
        grid.requires_grad_()
        g_planes = [g.reshape(b, 2 * h, 2 * w, GROUPS, cg).permute(0, 3, 4, 1, 2)
                    .reshape(b * GROUPS, cg, 2 * h, 2 * w).contiguous() for g in gs]

        def library(i):
            out = F.grid_sample(planes[i % k], grid, mode="bilinear", padding_mode="border",
                                align_corners=False)
            return torch.autograd.grad(out, (planes[i % k], grid), g_planes[i % k])

        ms, call_ms, s1 = timings(lambda i: sample_bilinear_backward(xs[i % k], gy, gx, gs[i % k]),
                                  30)
        plain_ms, plain_call_ms, s2 = timings(
            lambda i: sample_bilinear_backward_plain(xs[i % k], gy, gx, gs[i % k]), 5)
        library_ms, _, s3 = timings(library, 20, only="grid_sampler_2d_backward")
        # the zero fill of the float32 sums that the window sums and missed
        # taps are added into (dx itself for float32); it is part of `ms`
        zero_fill_ms, _, s4 = timings(lambda i: torch.zeros(xs[i % k].shape, device="cuda"), 30)
        src.append((s1, s2, s3, s4))
        # the function's own I/O: x and g read, dx written, coordinates read
        # and their gradients written; bfloat16 adds its float32 sums (the
        # zero fill writes them, the rounding pass reads them), float32's
        # zero fill is this design's cost
        n_bytes = (n_x + b * n * c + n_x + 4 * b * n * GROUPS) * es
        scratch = 8 * n_x if dtype == BF16 else 0
        bound_ms, bound_by = bound(n_bytes + scratch, b * n * c * 24)
        sites[site] = dict(x=[b, h, w, c], n=n, groups=GROUPS, errors=errs,
                           forward_errors=fwd_errs, window_missed_share=missed,
                           shared_bytes=backward_shared_bytes(c, GROUPS), ms=ms,
                           zero_fill_ms=zero_fill_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=n_bytes + scratch, call_ms=call_ms,
                           plain_call_ms=plain_call_ms)
        if scratch:
            sites[site]["bound_ms_without_scratch"] = bound(n_bytes, b * n * c * 24)[0]
    extra = {}
    if deform is not None:
        deform_rows, deform_src = deform_k2_backward_sites(deform, gen)
        extra["rtdetr_l_sites"] = _rtdetr_row(deform_rows)
        src += [(*t, None) for t in deform_src]  # the zero fill is timed at DySample's sites
        worst_fwd = max(worst_fwd, max(r["errors"]["forward"] for r in deform_rows.values()))
        worst["dx"] = max(worst["dx"], max(r["errors"]["dx"] for r in deform_rows.values()))
    if dattention is not None:
        rows_d, src_d = deform_k2_backward_sites(dattention, gen, "border", "DAttention")
        extra["dattention_sites"] = {"sites": rows_d, "bound_by": _by(rows_d.values())}
        src += [(*t, None) for t in src_d]
        worst_fwd = max(worst_fwd, max(r["errors"]["forward"] for r in rows_d.values()))
        worst["dx"] = max(worst["dx"], max(r["errors"]["dx"] for r in rows_d.values()))
    for key, sites_, what, corners in (("lda_dbl_s_sites", lda, "LDA_AQU", False),
                                       ("dlupack_sites", dlupack, "DLUPack", True)):
        if sites_ is None:
            continue
        rows_x, src_x = deform_k2_backward_sites(sites_, gen, "border", what, corners)
        extra[key] = (_lda_row(rows_x, "per_step") if key == "lda_dbl_s_sites"
                      else {"sites": rows_x, "bound_by": _by(rows_x.values())})
        src += [(*t, None) for t in src_x]
        worst_fwd = max(worst_fwd, max(r["errors"]["forward"] for r in rows_x.values()))
        worst["dx"] = max(worst["dx"], max(r["errors"]["dx"] for r in rows_x.values()))
    tolerance = BF16_BAR if dtype == BF16 else {"dx": 1e-4, "dg_rel": 1e-4, "forward": TOL}
    emit({"phase": _kphase("k2_backward", dtype), "batch": b, "tolerance": tolerance,
          "forward_max_abs_err": worst_fwd, "sites": sites, **extra})
    keys = ("ms", "zero_fill_ms", "plain_ms", "library_ms", "bound_ms")
    if dtype == BF16:
        keys += ("bound_ms_without_scratch",)
    total = {key: sum(sites[st][key] for st in DYSAMPLE_SITES) for key in keys}
    return dict(name=_kphase("sample_bilinear_backward", dtype), route="cuda",
                source="yolo_dbl_tpu_torch/csrc/sampling.cu",
                replaces="yolo_dbl_tpu/kernels/sampling.py:142", max_abs_err=worst["dx"],
                max_rel_err_dgy_dgx=max(worst["dgy_rel"], worst["dgx_rel"]),
                bound_by=_by(sites[st] for st in DYSAMPLE_SITES),
                dbl2_l_sites=_dbl2_sites(sites, ("ms", "zero_fill_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "window_missed_share",
                                                 "shared_bytes")),
                time_sources=_time_sources(src, ("ms", "plain_ms", "library_ms", "zero_fill_ms")),
                **extra, **total), worst_fwd


def _k3_inputs(gen, b, site, dtype=torch.float32):
    """Copies (to rotate past L2) of AAttn's packed (BB, N, H, 3 x 32) qkv
    tensor in `dtype` at one site, as (q, k, v) views, and the shape
    (BB, N, H)."""
    areas, n, h = K3_SITES[site]
    bb = b * areas
    k = copies_for(bb * n * h * 3 * HD * dtype.itemsize)
    packs = [torch.randn((bb, n, h, 3 * HD), generator=gen).cuda().to(dtype) for _ in range(k)]
    return [p.split(HD, -1) for p in packs], (bb, n, h)


def _sdpa_layout(qkvs):
    """The library yardstick's layout: contiguous (BB, H, N, hd) copies."""
    return [tuple(t.transpose(1, 2).contiguous() for t in qkv) for qkv in qkvs]


K3_REPLACES = "yolo_dbl_tpu/nn/blocks.py:883 -> jax 0.9.0 pallas/ops/tpu/flash_attention.py:"


def phase_k3(gen, dtype=torch.float32):
    """The forward kernel of `dtype` at the two YOLOv13-s A2C2f sites at
    serving batch 8, on the packed qkv views AAttn passes. Times are per
    call; the row sums the 8 calls of a request."""
    from yolo_dbl_tpu_torch.kernels.attention import (area_attention_forward,
                                                      area_attention_lse_plain,
                                                      area_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums in full fp32
    es, sites, worst, src = dtype.itemsize, {}, 0.0, []
    for site in K3_SITES:
        qkvs, (bb, n, h) = _k3_inputs(gen, B, site, dtype)
        o, lse = area_attention_forward(*qkvs[0])
        plain, plain_lse = area_attention_plain(*qkvs[0]), area_attention_lse_plain(*qkvs[0][:2])
        err, lse_err = max_abs(o, plain), max_abs(lse, plain_lse)
        require(meets_bar(o, plain, TOL, float(qkvs[0][2].abs().max())) and lse_err <= TOL,
                f"area attention kernel vs plain at {site} ({dtype}): out {err}, lse {lse_err}")
        worst = max(worst, err)
        again = area_attention_forward(*qkvs[0])
        require(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
                f"area attention forward at {site} ({dtype}): a second run gave other bits")
        # both sides against float64 (read, not gated)
        qkv64 = [t.double() for t in qkvs[0]]
        o64, lse64 = area_attention_plain(*qkv64), area_attention_lse_plain(*qkv64[:2])
        vs64 = {name: [float((a.double() - r).abs().max()) for a in pair]
                for name, pair, r in (("o", (o, plain), o64), ("lse", (lse, plain_lse), lse64))}
        lib = _sdpa_layout(qkvs)
        lib_err = max_abs(F.scaled_dot_product_attention(*lib[0]).transpose(1, 2), o)
        k = len(qkvs)
        ms, call_ms, s1 = timings(lambda i: area_attention_forward(*qkvs[i % k]), 50)
        plain_ms, plain_call_ms, s2 = timings(lambda i: area_attention_plain(*qkvs[i % k]), 10)
        library_ms, library_call_ms, s3 = timings(
            lambda i: F.scaled_dot_product_attention(*lib[i % k]), 50)
        src.append((s1, s2, s3))
        tokens, rows = bb * n * h * HD, bb * h * n
        # q, k, v read, o written, lse (float32) written; the products q kT
        # (two inputs) and P v (P float32), 2 N^2 hd each per sequence-head
        # (one exponential a score)
        product = bb * h * 2 * n * n * HD
        bounds = bound_products(dtype, 4 * tokens * es + rows * 4, product, product, bb * h * n * n,
                                BF16_TERMS["forward"])
        sites[site] = dict(qkv=[bb, n, h, HD], calls_per_request=K3_CALLS_PER_SITE,
                           max_abs_err=err, lse_max_abs_err=lse_err, bitwise_repeat=True,
                           kernel_and_plain_max_abs_vs_float64=vs64, library_vs_kernel=lib_err,
                           ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bounds,
                           call_ms=call_ms, plain_call_ms=plain_call_ms,
                           library_call_ms=library_call_ms)
    tolerance = {"o": BF16_BAR, "lse": TOL} if dtype == BF16 else TOL
    emit({"phase": _kphase("k3", dtype), "batch": B, "tolerance": tolerance, "tf32_matmul": False,
          "sites": sites})
    total = {key: K3_CALLS_PER_SITE * sum(st[key] for st in sites.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_simt_ms",
                         "bound_mufu_ms")}
    return dict(name=_kphase("area_attention", dtype), route="cuda",
                source="yolo_dbl_tpu_torch/csrc/attention.cu",
                replaces=K3_REPLACES + "758 (forward)", max_abs_err=worst,
                bound_by=_by(sites.values()), bound_route=_route(sites.values()),
                time_sources=_time_sources(src), **total)


def phase_k3_backward(gen, dtype=torch.float32):
    """The dq and dkv kernels (and the forward kernel) of `dtype` at the two
    sites at training batch 16, against the plain versions; a second
    backward on the same inputs must give the same bits. Returns the dkv and
    dq kernel rows (times summed over the 8 calls of a step) and the
    forward's worst error at these shapes."""
    from yolo_dbl_tpu_torch.kernels.attention import (area_attention_backward,
                                                      area_attention_backward_plain,
                                                      area_attention_forward,
                                                      area_attention_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    b, es, sites, src = TRAIN_B, dtype.itemsize, {}, []
    worst, worst_fwd = {"dq": 0.0, "dk": 0.0, "dv": 0.0}, 0.0
    worst_rel = dict(worst)
    for site in K3_SITES:
        qkvs, (bb, n, h) = _k3_inputs(gen, b, site, dtype)
        k = len(qkvs)
        grads = [torch.randn((bb, n, h, HD), generator=gen).cuda().to(dtype) for _ in range(k)]
        fwd = [area_attention_forward(*qkv, residual=True) for qkv in qkvs]
        saved = [(o32, lse) for _, lse, o32 in fwd]  # what the backward reads
        o, plain_o = fwd[0][0], area_attention_plain(*qkvs[0])
        fwd_err = max_abs(o, plain_o)
        require(meets_bar(o, plain_o, TOL, float(qkvs[0][2].abs().max())),
                f"area attention kernel vs plain at {site}, batch {b} ({dtype}): {fwd_err}")
        worst_fwd = max(worst_fwd, fwd_err)
        got = area_attention_backward(*qkvs[0], *saved[0], grads[0])
        want = area_attention_backward_plain(*qkvs[0], grads[0])
        errs = {name: max_abs(a, r) for name, a, r in zip(("dq", "dk", "dv"), got, want)}
        rel = {name: errs[name] / float(r.float().abs().max()) for name, r in zip(errs, want)}
        # dq and dk are near 0 where a row's attention is near uniform: their
        # bfloat16 bar's floor is 1e-6 of 1e-2 of dv's largest
        floor = 1e-2 * float(want[2].float().abs().max())
        require(all(meets_bar(a, r, 1e-4 * float(r.abs().max()),
                              max(float(r.float().abs().max()), floor))
                    for a, r in zip(got, want)),
                f"area attention backward kernels vs plain at {site} ({dtype}): {errs}, of "
                f"each largest {rel}")
        again = area_attention_backward(*qkvs[0], *saved[0], grads[0])
        require(all(torch.equal(a, r) for a, r in zip(got, again)),
                f"area attention backward at {site} ({dtype}): a second run gave other bits")
        # both sides against float64 autograd (read, not gated)
        leaves64 = [t.detach().double().requires_grad_() for t in qkvs[0]]
        want64 = torch.autograd.grad(area_attention_plain(*leaves64), leaves64, grads[0].double())
        rel64 = {name: [float((x.double() - r).abs().max() / r.abs().max()) for x in (a, w)]
                 for name, a, w, r in zip(errs, got, want, want64)}
        worst = {key: max(worst[key], errs[key]) for key in worst}
        worst_rel = {key: max(worst_rel[key], rel[key]) for key in worst_rel}

        def backward(i):
            return area_attention_backward(*qkvs[i % k], *saved[i % k], grads[i % k])

        def plain(i, wrt):
            qkv = [t.detach().requires_grad_(j in wrt) for j, t in enumerate(qkvs[i % k])]
            return torch.autograd.grad(area_attention_plain(*qkv), [qkv[j] for j in wrt],
                                       grads[i % k])

        lib = [tuple(t.requires_grad_() for t in qkv) for qkv in _sdpa_layout(qkvs)]
        lib_g = [g.transpose(1, 2).contiguous() for g in grads]

        def library(i):
            out = F.scaled_dot_product_attention(*lib[i % k])
            return torch.autograd.grad(out, lib[i % k], lib_g[i % k])

        dq_ms, call_ms, s1 = timings(backward, 30, only="attention_bwd_dq_kernel")
        dkv_ms, _, s2 = timings(backward, 30, only="attention_bwd_dkv_kernel")
        plain_dq_ms, _, s3 = timings(lambda i: plain(i, (0,)), 5)
        plain_dkv_ms, _, s4 = timings(lambda i: plain(i, (1, 2)), 5)
        lib_total_ms, _, s5 = timings(library, 20)
        lib_fwd_ms, _, s6 = timings(lambda i: F.scaled_dot_product_attention(*lib[i % k]), 20)
        src.append((s1, s2, s3, s4, source_of(s5, s6)))
        tokens, rows = bb * n * h * HD, bb * h * n
        # The products each kernel must form from its inputs, 2 N^2 hd each
        # per sequence-head: dq: S = q kT and dP = dO vT (two inputs), dQ =
        # dS k (dS float32); dkv: S and dP again, dV = PT dO and dK = dST q.
        # dq: q, k, v, dO read and dq written in the inputs' type, o (float32)
        # and lse read, delta written; dkv: q, k, v, dO read and dk, dv
        # written in the inputs' type, lse and delta read
        # Each forms P again: one exponential a score.
        product, scores = bb * h * 2 * n * n * HD, bb * h * n * n
        dq_bytes = 5 * tokens * es + tokens * 4 + 2 * rows * 4
        dq_b = bound_products(dtype, dq_bytes, 2 * product, product, scores, BF16_TERMS["dq"])
        dkv_b = bound_products(dtype, 6 * tokens * es + 2 * rows * 4, 2 * product, 2 * product,
                               scores, BF16_TERMS["dkv"])
        sites[site] = dict(qkv=[bb, n, h, HD], calls_per_step=K3_CALLS_PER_SITE,
                           max_abs_errors=errs, rel_errors_of_largest=rel, bitwise_repeat=True,
                           kernel_and_plain_rel_errors_vs_float64=rel64,
                           forward_max_abs_err=fwd_err,
                           dq_ms=dq_ms, dkv_ms=dkv_ms, backward_call_ms=call_ms,
                           plain_dq_ms=plain_dq_ms, plain_dkv_ms=plain_dkv_ms,
                           library_backward_ms=lib_total_ms - lib_fwd_ms,
                           library_forward_backward_ms=lib_total_ms,
                           **{f"dq_{key}": val for key, val in dq_b.items()},
                           **{f"dkv_{key}": val for key, val in dkv_b.items()})
    tolerance = ({"d": BF16_BAR + " (floor: 1e-2 of dv's largest)", "forward": BF16_BAR}
                 if dtype == BF16 else {"d_rel_of_largest": 1e-4, "forward": TOL})
    emit({"phase": _kphase("k3_backward", dtype), "batch": b, "tf32_matmul": False,
          "tolerance": tolerance, "forward_max_abs_err": worst_fwd, "sites": sites})

    def total(key):
        return K3_CALLS_PER_SITE * sum(st[key] for st in sites.values())

    common = dict(route="cuda", source="yolo_dbl_tpu_torch/csrc/attention.cu",
                  library_ms=total("library_backward_ms"),
                  library_scope="SDPA backward, dq dk dv together")
    dkv = dict(name=_kphase("area_attention_backward_dkv", dtype),
               replaces=K3_REPLACES + "1121 (bwd dkv)",
               max_abs_err=max(worst["dk"], worst["dv"]),
               max_rel_err_of_largest=max(worst_rel["dk"], worst_rel["dv"]),
               ms=total("dkv_ms"), plain_ms=total("plain_dkv_ms"), bound_ms=total("dkv_bound_ms"),
               bound_by=_by(sites.values(), "dkv_bound_by"),
               bound_route=_route(sites.values(), "dkv_"),
               bound_simt_ms=total("dkv_bound_simt_ms"), bound_mufu_ms=total("dkv_bound_mufu_ms"),
               time_sources=_time_sources([(s[1], s[3], s[4]) for s in src]), **common)
    dq = dict(name=_kphase("area_attention_backward_dq", dtype),
              replaces=K3_REPLACES + "1456 (bwd dq)",
              max_abs_err=worst["dq"], max_rel_err_of_largest=worst_rel["dq"],
              ms=total("dq_ms"), plain_ms=total("plain_dq_ms"), bound_ms=total("dq_bound_ms"),
              bound_by=_by(sites.values(), "dq_bound_by"),
              bound_route=_route(sites.values(), "dq_"),
              bound_simt_ms=total("dq_bound_simt_ms"), bound_mufu_ms=total("dq_bound_mufu_ms"),
              time_sources=_time_sources([(s[0], s[2], s[4]) for s in src]), **common)
    return dkv, dq, worst_fwd


def model_class(name):
    """The model class of a config name: ClassificationModel for "-cls",
    WorldModel for "world", else DetectionModel (as YOLO picks them)."""
    from yolo_dbl_tpu_torch import ClassificationModel, DetectionModel, WorldModel

    return (ClassificationModel if "-cls" in name else WorldModel if "world" in name
            else DetectionModel)


def seeded_model(cfg, dtype=torch.float32):
    """The model of `cfg` computing in `dtype` on the CPU, its weights drawn
    from seed 0 (the model's own init); LDA-DBL-s and Swin-T-Giraffe from
    their dicts."""
    from tests.torch_fixtures import lda_dbl, swin_giraffe

    name, nc = cfg
    built = {LDA: lda_dbl, SWIN: lambda: swin_giraffe(nc)}
    return model_class(name)(built[cfg]() if cfg in built else name, nc=nc, device="cpu",
                             generator=torch.Generator().manual_seed(0), dtype=dtype)


def on_card(model):
    """A copy of a CPU model on the card, as a model built there is
    (channels_last, in its mode): the weights are drawn once."""
    return copy.deepcopy(model).to("cuda").to(memory_format=torch.channels_last)


def build_models(cfg, dtype=torch.float32, zero_class_bias=True, seeded=None):
    """One seeded model of `cfg` computing in `dtype` on the CPU with the
    smoke settings (a copy of `seeded`, `seeded_model`'s, where given), and
    its copy on the card (the same weights in both
    types: parameters are float32). `zero_class_bias=False` keeps the Detect
    class biases of the model's own init (the stride-aware prior), whose
    spread of scores keeps NMS away from near-ties at a low threshold.
    YOLOv7's IDetect has no class bias to zero: its scores are σ(obj)σ(cls);
    a classifier (a "-cls" name: ClassificationModel) has no Detect; a
    world model's contrastive bias is zeroed instead (-10 at init)."""
    from yolo_dbl_tpu_torch.nn.blocks import FullPAD_Tunnel

    cpu = seeded_model(cfg, dtype) if seeded is None else copy.deepcopy(seeded)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, FullPAD_Tunnel):
                mod.gate.fill_(0.5)  # gates start at 0, which would hide the tunnel inputs
    if zero_class_bias:
        cpu.zero_class_biases()  # give NMS real candidates (both v10Detect branches)
    if cpu.head_name == "Segment":
        calibrate_mask_head(cpu)
    return cpu, on_card(cpu)


def calibrate_mask_head(model, imgsz=256, seed=3):
    """Set the running statistics of a Segment head's own BatchNorms (Proto
    and the coefficient branches, not its Detect) to those of one forward of
    2 seeded random images with those BatchNorms alone in train mode (the
    rest in eval mode, as serving runs it). At the seeded init the activations
    shrink layer by layer: the coefficients and prototypes come out near
    1e-4, their products near 1e-7, and every mask probability rounds to 0.5
    in float32, where the > 0.5 threshold is a tie; calibrated, they are of
    order 0.1-1 and the mask probabilities spread over about 0.1-0.9 (yolo11s-seg at
    320 on the CPU). The forward runs in
    float32 whatever the model's compute type, so a bfloat16 model gets its
    float32 twin's statistics."""
    layers = [m for name, m in model.detect.named_modules()
              if isinstance(m, torch.nn.BatchNorm2d) and not name.startswith("detect.")]
    saved = [m.momentum for m in layers], model._dtype
    x = torch.rand((2, imgsz, imgsz, 3), generator=torch.Generator().manual_seed(seed))
    model.eval()  # the trunk and the Detect keep their statistics and feed eval activations
    for m in layers:
        m.train()
    model._dtype = torch.float32
    with torch.no_grad():
        for m in layers:
            m.momentum = 1.0
        model(x.to(model.device))
    for m, momentum in zip(layers, saved[0]):
        m.momentum = momentum
    model._dtype = saved[1]
    model.eval()


def _phase(base, cfg, dtype=torch.float32):
    """The phase name of `base` for a model and type: `main`, `main_v13`,
    `main_dbl2`, `main_bf16`, `main_v13_bf16`, ..."""
    return base + SUFFIX[cfg] + ("_bf16" if dtype == BF16 else "")


def imgsz_of(model):
    """The smoke's serving and training size of a model: 640, a classifier's
    224, an OBB model's 1024."""
    return {"Classify": CLS_IMGSZ, "OBB": OBB_IMGSZ}.get(model.head_name, IMGSZ)


def frames_hw(model):
    """The (H, W) of the frames a model's requests carry: 512x768, or an OBB
    model's 1024x1024 tiles."""
    return (OBB_IMGSZ, OBB_IMGSZ) if model.head_name == "OBB" else SRC_HW


class RTDETRRequests:
    """RT-DETR's requests through the port's entry points, as Ultralytics'
    RTDETRPredictor serves them: K1's letterbox (`letterbox_normalize`),
    `DetectionModel.predict` (the forward and rtdetr_postprocess's sorted
    rows; no NMS) and the rows above `conf` rescaled to each frame. The
    port's predictor refuses RT-DETR (ROADMAP Queue 3)."""

    def __init__(self, model, conf=0.25, imgsz=IMGSZ):
        self.model, self.conf, self.imgsz = model, conf, imgsz

    def __call__(self, frames):
        from yolo_dbl_tpu_torch.engine.predictor import BasePredictor
        from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_geometry, letterbox_normalize

        frames = torch.as_tensor(frames)
        h, w = frames.shape[1:3]
        gain, _, _, top, left = letterbox_geometry(h, w, self.imgsz, self.imgsz, scaleup=False)
        img = letterbox_normalize(frames.to(self.model.device).contiguous(),
                                  (self.imgsz, self.imgsz), scaleup=False,
                                  out_dtype=self.model.dtype)
        dets = self.model.predict(img).float().cpu().numpy()
        return [BasePredictor._rescale_boxes(d[d[:, 4] > self.conf], gain,
                                             (float(left), float(top)), (h, w)) for d in dets]


def _predictor(model, **kw):
    """The model's task predictor (engine/predictor.py TASK_PREDICTORS) at
    the smoke's serving settings: conf 0.25, iou 0.45, max_det 300, at
    `imgsz_of`; RT-DETR's requests (`RTDETRRequests`, conf 0.25)."""
    from yolo_dbl_tpu_torch.engine import predictor as P

    if model.head_name == "RTDETRDecoder":
        return RTDETRRequests(model, imgsz=imgsz_of(model))
    cls = {"Segment": P.SegmentationPredictor, "Pose": P.PosePredictor, "OBB": P.OBBPredictor,
           "Classify": P.ClassificationPredictor}.get(model.head_name, P.DetectionPredictor)
    return cls(model, **{**dict(conf=0.25, iou=0.45, max_det=300, imgsz=imgsz_of(model)), **kw})


def _request_counts(model, out):
    """Each image's kept rows of a device-lane request (a classifier: 1),
    after checking the outputs' form: (n, 6) finite rows; with them (n, H, W)
    bool masks (Segment) or (n, 17, 3) finite keypoints (Pose); an OBB
    model's (n, 7) finite rows with positive sides and angles in
    [-π/4, 3π/4]; a classifier's (B, nc) probabilities summing to 1."""
    if model.head_name == "Classify":
        require(out.shape == (B, model.nc) and np.isfinite(out).all()
                and np.abs(out.sum(-1) - 1).max() < 1e-4, f"probabilities {out.shape}")
        return [1] * B
    if model.head_name == "OBB":
        require(len(out) == B and all(
            o.shape[1] == 7 and np.isfinite(o).all() and (o[:, 2:4] > 0).all()
            and (o[:, 4] >= -np.pi / 4).all() and (o[:, 4] <= 3 * np.pi / 4).all() for o in out),
                "predictor output: expected 8 finite (n, 7) rotated rows")
        return [len(o) for o in out]
    rows = [o[0] for o in out] if model.head_name in ("Segment", "Pose") else out
    require(len(out) == B and all(o.shape[1] == 6 and np.isfinite(o).all() for o in rows),
            "predictor output: expected 8 finite (n, 6) arrays")
    if model.head_name == "Segment":
        require(all(m.dtype == bool and m.shape == (len(r), *SRC_HW) for r, m in out),
                "masks: expected (n, H, W) bool arrays")
    if model.head_name == "Pose":
        require(all(k.shape == (len(r), 17, 3) and np.isfinite(k).all() for r, k in out),
                "keypoints: expected finite (n, 17, 3) arrays")
    return [len(r) for r in rows]


def phase_main(cfg, gpu_model, rng, card):
    from yolo_dbl_tpu_torch import kernels

    t_start = time.perf_counter()
    pred = _predictor(gpu_model)
    hw = frames_hw(gpu_model)
    requests = [rng.integers(0, 256, (B, *hw, 3), dtype=np.uint8)
                for _ in range(WARMUP + REQUESTS)]
    for frames in requests[:WARMUP]:
        pred(frames)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    lat, n_boxes = [], []
    for frames in requests[WARMUP:]:
        t0 = time.perf_counter()
        out = pred(frames)
        lat.append(time.perf_counter() - t0)
        n_boxes.append(_request_counts(gpu_model, out))
    launches = dict(kernels.launches)
    dtype = gpu_model.dtype
    want = {k: v * REQUESTS for k, v in PER_REQUEST[cfg, dtype].items()}
    require(launches == want, f"launches in {REQUESTS} requests: {launches}, expected {want}")
    require(sum(map(sum, n_boxes)) > 0, "no detections: NMS saw no candidates")
    med = statistics.median(lat)
    extra = {"mask_parts": _mask_parts(pred, requests[WARMUP])} if gpu_model.head_name == "Segment" \
        else {}
    emit({"phase": _phase("main", cfg, dtype), "model": cfg[0][:-5], "nc": cfg[1],
          "dtype": str(dtype).split(".")[-1], "imgsz": pred.imgsz, **extra,
          "batch": B, "frames": list(hw), "requests": REQUESTS,
          "latency_ms": [t * 1e3 for t in lat], "median_ms": med * 1e3, "img_per_s": B / med,
          "boxes_per_image": n_boxes, "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "tf32_conv": torch.backends.cudnn.allow_tf32,
          "seconds": time.perf_counter() - t_start, "card": card})
    return launches, requests[WARMUP][:2], pred, med


# substrings of device event names → the part of a path they belong to (first match)
_CATEGORIES = (("letterbox", "k1 letterbox"), ("upsample_bilinear", "mask resize"),
               ("sample_bilinear_backward", "k2 sampler backward"),
               ("sample_bilinear", "k2 sampler"), ("attention_bwd", "k3 attention backward"),
               ("attention_fwd", "k3 attention"), ("memcpy", "memcpy"), ("memset", "memset"),
               ("bn_fw", "batchnorm"), ("bn_bw", "batchnorm"), ("batch_norm", "batchnorm"),
               ("batchnorm", "batchnorm"), ("conv", "convolution"), ("xmma", "convolution"),
               ("cudnn::cnn", "convolution"), ("gemm", "matmul"),
               ("multi_tensor", "optimizer/EMA (foreach)"), ("sort", "sort/topk"),
               ("reduce", "reduction"), ("softmax", "reduction"), ("elementwise", "elementwise"),
               ("cat", "concat/copy"), ("copy", "concat/copy"), ("scatter", "gather/index"),
               ("gather", "gather/index"), ("index", "gather/index"))


def by_part(fn, calls):
    """Device time per call of fn(i) by kernel and by part (torch.profiler)."""
    return _parts(_trace(fn, calls), calls)


def traced_once(fn):
    """(fn()'s device time by kernel and by part, its result): one call
    under torch.profiler, with no warm-up call, for work that cannot run
    twice (a training run that resumes from its own checkpoint). Only the
    card's activity is traced: the host's ops would slow a host-bound run
    several-fold and with it the busy share read against its wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return _parts(_device_events(prof), 1), out


def _parts(events, calls):
    per_kernel, per_part, n_ops = {}, {}, 0
    for evt in events:
        ms = evt.self_device_time_total / 1e3 / calls
        n_ops += evt.count
        per_kernel[evt.key] = per_kernel.get(evt.key, 0.0) + ms
        part = next((p for s, p in _CATEGORIES if s in evt.key.lower()), "other")
        per_part[part] = per_part.get(part, 0.0) + ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(device_ms=sum(per_kernel.values()), device_ops=n_ops / calls,
                by_part_ms=dict(sorted(per_part.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=[[k[:90], v] for k, v in top])


def phase_profile(cfg, pred, rng, median_ms, requests=1):
    """Device time of one request by kernel and by part of the path."""
    t_start = time.perf_counter()
    frames = [rng.integers(0, 256, (B, *frames_hw(pred.model), 3), dtype=np.uint8)
              for _ in range(requests)]
    p = by_part(lambda i: pred(frames[i]), requests)
    emit({"phase": _phase("profile", cfg, pred.model.dtype), "requests": requests,
          "seconds": time.perf_counter() - t_start,
          "device_ms_per_request": p["device_ms"],
          "device_ops_per_request": p["device_ops"], "unprofiled_median_ms": median_ms,
          "device_busy_share": p["device_ms"] / median_ms, "by_part_ms": p["by_part_ms"],
          "top_kernels_ms": p["top_kernels_ms"]})


def train_batches(rng, n, b=TRAIN_B, imgsz=IMGSZ, m=TRAIN_M, nc=NC, task="detect", real=(1, 9)):
    """Seeded synthetic batches of the loss's batch contract: uint8 images,
    `real` (low, high + 1) real boxes per image, 1-8 unless given
    (normalized xywh, classes 0..nc-1) padded to m;
    for `task` "segment" also each box's rectangle as its mask at a quarter
    of imgsz (`gt_masks`), for "pose" 17 keypoints inside each box, a fifth
    of them invisible (`gt_kpts`, xy in [0, 1]); for "obb" m // 8 to m real
    rotated boxes an image, aerial-sized (1-12% of a side), with angles in
    [-π/4, 3π/4) (`gt_boxes` (b, m, 5))."""
    if task == "obb":
        return [_obb_batch(rng, b, imgsz, m, nc) for _ in range(n)]
    out, span = [], real
    for _ in range(n):
        real = rng.integers(*span, b)
        xy = rng.uniform(0.15, 0.85, (b, m, 2))
        wh = rng.uniform(0.04, 0.3, (b, m, 2))
        batch = dict(img=rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
                     gt_boxes=np.concatenate([xy, wh], -1).astype(np.float32),
                     gt_cls=rng.integers(0, nc, (b, m)).astype(np.int32),
                     gt_mask=(np.arange(m)[None] < real[:, None]).astype(np.float32))
        if task == "segment":
            hm = imgsz // 4
            lo = np.floor((xy - wh / 2) * hm).astype(int).clip(0, hm)
            hi = np.ceil((xy + wh / 2) * hm).astype(int).clip(0, hm)
            cells = np.arange(hm)
            inside = [(cells >= lo[..., k, None]) & (cells < hi[..., k, None]) for k in (0, 1)]
            batch["gt_masks"] = (inside[1][..., :, None] & inside[0][..., None, :]
                                 & batch["gt_mask"][..., None, None].astype(bool)).astype(np.float32)
        elif task == "pose":
            k = xy[:, :, None] + (rng.random((b, m, 17, 2)) - 0.5) * wh[:, :, None]
            vis = np.where(rng.random((b, m, 17, 1)) < 0.2, 0.0, 2.0)
            batch["gt_kpts"] = (np.concatenate([k, vis], -1)
                                * batch["gt_mask"][..., None, None]).astype(np.float32)
        out.append(batch)
    return out


def _obb_batch(rng, b, imgsz, m, nc):
    real = rng.integers(max(m // 8, 1), m + 1, b)
    gt = np.concatenate([rng.uniform(0.05, 0.95, (b, m, 2)), rng.uniform(0.01, 0.12, (b, m, 2)),
                         rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, m, 1))], -1)
    mask = (np.arange(m)[None] < real[:, None]).astype(np.float32)
    return dict(img=rng.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8),
                gt_boxes=(gt * mask[..., None]).astype(np.float32),
                gt_cls=rng.integers(0, nc, (b, m)).astype(np.int32), gt_mask=mask)


def _task(model):
    """The loss's batch task of a model: segment, pose, obb or detect."""
    return {"Segment": "segment", "Pose": "pose", "OBB": "obb"}.get(model.head_name, "detect")


def e2e_terms(model, train_cfg, batch):
    """{loss, one2many, one2one, items} of v10Detect's train-mode loss of
    `batch` on the model's device, without a backward: the trainer's loss
    (`task_loss`) must equal the sum of e2e_detect_loss's two terms (each
    its items' sum times the batch), and its items must be one2many's."""
    from yolo_dbl_tpu_torch.engine.trainer import task_loss
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize
    from yolo_dbl_tpu_torch.losses.extra import e2e_detect_loss

    b = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    was_training = model.training
    model.train()
    with torch.no_grad():
        feats = model(device_normalize(b["img"], model.dtype))
        loss, items = task_loss(model, train_cfg, feats, b)
        _, terms = e2e_detect_loss(feats, b, model.strides, model.nc, box_gain=train_cfg.box,
                                   cls_gain=train_cfg.cls, dfl_gain=train_cfg.dfl)
    model.train(was_training)
    n = b["img"].shape[0]
    out = {"loss": float(loss), **{k: float(sum(v)) * n for k, v in terms.items()},
           "items": {k: float(v) for k, v in items._asdict().items()},
           "one2one_items": {k: float(v) for k, v in terms["one2one"]._asdict().items()}}
    out["loss_minus_terms"] = out["loss"] - out["one2many"] - out["one2one"]
    require(np.isfinite(out["loss"]) and abs(out["loss_minus_terms"]) <= 1e-5 * abs(out["loss"])
            and all(abs(float(a) - float(b)) <= 1e-6 * abs(float(b))
                    for a, b in zip(items, terms["one2many"])),
            f"e2e loss: the trainer's loss is not one2many's term plus one2one's: {out}")
    return out


def zero_grad_leaves(model, train_cfg, batch):
    """The names of the parameters whose gradient of the train-mode loss of
    `batch` is exactly 0. A world model trains on the zero text (JAX's step
    applies the module without one), so every class logit is its
    contrastive `bias` alone: the head's class-embedding branches and the
    guide Dense kernels get no gradient, nor does a level no target is
    assigned to."""
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    names, params = zip(*model.named_parameters())
    loss, _ = train_loss(model, train_cfg, {k: torch.as_tensor(v).to(model.device)
                                           for k, v in batch.items()})
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return {n for n, g in zip(names, grads) if not bool(g.any())}


def phase_train(cfg, card, dtype=torch.float32, seeded=None):
    """Training steps of `cfg` computing in `dtype` on the card through
    Trainer.step, from the seeded weights (a copy of `seeded`,
    `seeded_model`'s, where given)."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    t_start = time.perf_counter()
    name, nc = cfg
    model = on_card(seeded_model(cfg, dtype) if seeded is None else seeded)
    trainer = Trainer(model, {"batch": TRAIN_B}).setup(steps_per_epoch=100)
    imgsz = imgsz_of(model)
    detr = model.head_name == "RTDETRDecoder"
    m = {"OBB": OBB_M, "RTDETRDecoder": RTDETR_M}.get(model.head_name, TRAIN_M)
    batches = train_batches(np.random.default_rng(1), TRAIN_WARMUP + TRAIN_STEPS + 1, nc=nc,
                            imgsz=imgsz, m=m, task=_task(model),
                            real=(8, RTDETR_M + 1) if detr else (1, 9))
    params = [p for _, p in model.named_parameters()]
    losses, step_ms = [], []
    solve = host_solve_timer() if detr else contextlib.nullcontext([])
    with solve as solve_ms:
        for i, batch in enumerate(batches[:TRAIN_WARMUP + TRAIN_STEPS]):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                after_first = [p.detach().clone() for p in params]
                ema_first = [e.clone() for e in trainer.ema]
                kernels.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                solve_ms.clear()
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in trainer.step(batch).items()}
            torch.cuda.synchronize()
            if i >= TRAIN_WARMUP:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(metrics)
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(v) for m in losses for v in m.values()), f"non-finite losses {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in params + trainer.ema),
            "non-finite parameters or EMA after training")
    # a world model trains on the zero text: the leaves it leaves without a
    # gradient do not move
    dead = zero_grad_leaves(model, trainer.cfg, batches[-1]) if model.takes_text else set()
    live = [i for i, (n, _) in enumerate(model.named_parameters()) if n not in dead]
    moved = sum(not torch.equal(after_first[i], params[i]) for i in live)
    ema_moved = sum(not torch.equal(ema_first[i], trainer.ema[i]) for i in live)
    require(moved > 0.9 * len(live) and ema_moved > 0.9 * len(live),
            f"{moved} parameters and {ema_moved} EMA tensors of {len(live)} changed "
            f"({len(dead)} without a gradient on the zero text left out)")
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP[cfg, dtype].items()}
    require(launches == want, f"launches in {TRAIN_STEPS} steps: {launches}, expected {want}")
    require(all(t.dtype == torch.float32 for t in params + trainer.ema),
            "parameters and EMA must stay float32")
    extra = ({"e2e": e2e_terms(model, trainer.cfg, batches[-1])}
             if model.head_name == "v10Detect" else {})
    if model.head_name in ("Segment", "Pose"):
        extra["task_term"] = _task_term_ms(model, trainer.cfg, batches[-1])
    if model.head_name in ("OBB", "RTDETRDecoder"):
        extra["gt_per_image"] = float(np.mean([b["gt_mask"].sum(1).mean() for b in batches]))
    if detr:  # the host's part of each timed step: the costs' copy, scipy, the indices back
        require(len(solve_ms) == TRAIN_STEPS, f"host solves in {TRAIN_STEPS} steps: {solve_ms}")
        extra.update(host_solve_ms=solve_ms, host_solve_median_ms=statistics.median(solve_ms),
                     matchings_per_step=TRAIN_B * (RTDETR_LAYERS + 1))
    med = statistics.median(step_ms)
    emit({"phase": _phase("train", cfg, dtype), "model": name[:-5], "nc": nc,
          "dtype": str(dtype).split(".")[-1], "imgsz": imgsz,
          "batch": TRAIN_B, "optimizer": trainer.optimizer.name, "steps": TRAIN_STEPS,
          "step_ms": step_ms, "median_ms": med, "img_per_s": TRAIN_B / (med / 1e3),
          "losses": losses, "max_memory_allocated_bytes": peak, "launches": launches,
          "params_changed": moved, "ema_changed": ema_moved, "n_params": len(params),
          "zero_grad_leaves": len(dead),
          "tf32_conv": torch.backends.cudnn.allow_tf32, **extra, "card": card})
    last = batches[-1]
    p = by_part(lambda i: (trainer.step(last), torch.cuda.synchronize()), 1)
    emit({"phase": _phase("train_profile", cfg, dtype), "steps": 1,
          "device_ms_per_step": p["device_ms"],
          "device_ops_per_step": p["device_ops"], "unprofiled_median_ms": med,
          "device_busy_share": p["device_ms"] / med, "by_part_ms": p["by_part_ms"],
          "top_kernels_ms": p["top_kernels_ms"],
          "seconds_train_and_profile": time.perf_counter() - t_start})
    return launches


def n_anchors(model, imgsz):
    """The decode's A at a square `imgsz`: a cell a level, IDetect's na each."""
    na = model.detect.na if model.head_name == "IDetect" else 1
    return na * sum((imgsz // s) ** 2 for s in model.strides)


def v10_postprocess_check(pred_c, pred_card, nc, max_det=300):
    """v10_postprocess (the NMS-free top-k) on the card against the CPU: on
    the CPU's decode moved to the card, equal rows (the same input, a
    stable sort on both); on each device's own decode, the sorted top-k
    scores within 1e-3, and each card row whose score clears the CPU's k-th
    by twice the decodes' largest score difference e matching a CPU row of
    its class within 0.05 px. Such a pair scores above the k-th on the CPU
    too, so it is in the CPU's top-k (its anchor's best score is above the
    k-th, which is at least the first pass's threshold); a row within 2e of
    the k-th may trade places across it."""
    from yolo_dbl_tpu_torch.nn.heads import v10_postprocess

    want = v10_postprocess(pred_c, max_det, nc)
    same_input = v10_postprocess(pred_c.to(pred_card.device), max_det, nc).cpu()
    got = v10_postprocess(pred_card, max_det, nc).cpu()
    row_err = max_abs(same_input, want)
    score_err = max_abs(got[..., 4], want[..., 4])
    band = 2 * max_abs(pred_card[:, 4:].cpu(), pred_c[:, 4:])
    box_err, checked = 0.0, 0
    for g, w in zip(got, want):
        floor = float(w[-1, 4]) + band
        for row in g[g[:, 4] > floor]:
            same = w[w[:, 5] == row[5]]
            box_err = max(box_err, float((same[:, :4] - row[:4]).abs().amax(-1).min())
                          if len(same) else float("inf"))
            checked += 1
    out = {"k": int(want.shape[1]), "same_input_max_abs": row_err, "score_max_abs": score_err,
           "band": band, "rows_checked": checked, "box_max_abs_px": box_err,
           "top_score": float(want[..., 4].max()), "kth_score": float(want[:, -1, 4].min())}
    require(row_err <= 1e-6 and score_err <= 1e-3 and box_err < 0.05 and checked > 0,
            f"v10_postprocess card vs CPU: {out}")
    return out


def phase_parity(cfg, cpu_model, gpu_model, frames):
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    u8 = torch.from_numpy(frames)
    pred_c = cpu_model.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ)))
    pred_card = gpu_model.predict(letterbox_normalize(u8.cuda(), (IMGSZ, IMGSZ)))
    pred_g = pred_card.cpu()
    anchors = n_anchors(gpu_model, IMGSZ)
    require(pred_g.shape == pred_c.shape == (2, 4 + cfg[1], anchors)
            and torch.isfinite(pred_g).all(),
            f"predictions: card {tuple(pred_g.shape)}, CPU {tuple(pred_c.shape)}")
    box_err = float((pred_g[:, :4] - pred_c[:, :4]).abs().max())
    score_err = float((pred_g[:, 4:] - pred_c[:, 4:]).abs().max())
    extra = {}
    if gpu_model.head_name == "v10Detect":
        extra["v10_postprocess"] = v10_postprocess_check(pred_c, pred_card, cfg[1])
    if gpu_model.head_name == "IDetect":  # decode_v7: σ(obj)σ(cls)
        extra["score_range"] = [float(pred_g[:, 4:].min()), float(pred_g[:, 4:].max())]
        require(0.0 <= extra["score_range"][0] and extra["score_range"][1] <= 1.0,
                f"decode_v7 scores outside [0, 1]: {extra['score_range']}")
    named = True
    if cfg in (WORLD, EMAC):
        extra["kept_rows"], named = _kept_rows_alike(pred_card, pred_c, cfg[1])
    emit({"phase": _phase("parity", cfg), "frames": 2, "box_max_abs_px": box_err,
          "score_max_abs": score_err, "max_score": float(pred_c[:, 4:].max()),
          "head": gpu_model.head_name, **extra, "seconds": time.perf_counter() - t_start})
    require(box_err < 0.05 and score_err <= 1e-3,
            f"card vs CPU: boxes {box_err} px (< 0.05), scores {score_err} (<= 1e-3)")
    if cfg in (WORLD, EMAC):
        rows = extra["kept_rows"]
        require(sum(rows["kept_cpu"]) > 0 and rows["box_max_abs_px"] < 0.05
                and rows["score_max_abs"] <= 1e-3 and rows["classes_equal"] and named,
                f"kept rows card vs CPU: {rows}")


def _kept_rows_alike(pred_card, pred_cpu, nc, conf=0.25, iou=0.45):
    """Each frame's rows that NMS (conf 0.25, iou 0.45, as the predictor's)
    keeps of the card's decode on the card and of the CPU's on the CPU,
    through `_frames_alike`: ({kept_card, kept_cpu, box_max_abs_px, ...},
    whether every parted frame's partings are named)."""
    from yolo_dbl_tpu_torch.ops.nms import non_max_suppression

    kept = []
    for pred in (pred_card, pred_cpu):
        dets, num = non_max_suppression(pred, conf_thres=conf, iou_thres=iou, nc=nc)
        dets, num = dets.cpu().numpy(), num.cpu().tolist()
        kept.append([dets[i, :k] for i, k in enumerate(num)])
    rows, named = _frames_alike(kept[0], kept[1], pred_card.cpu(), pred_cpu.cpu(), conf, iou)
    return {"kept_card": [len(k) for k in kept[0]], "kept_cpu": [len(k) for k in kept[1]],
            "conf": conf, "iou": iou, **rows}, named


@contextlib.contextmanager
def plain_kernels():
    """The models' kernel call sites (the sampler in ops/resample.py, the
    area attention in nn/blocks.py) bound to the plain versions, which take
    float64 on any device: a float64 reference on the card. The kernels'
    launch counts do not move."""
    from yolo_dbl_tpu_torch.kernels import attention, sampling
    from yolo_dbl_tpu_torch.nn import blocks
    from yolo_dbl_tpu_torch.ops import resample

    saved = resample.sample_bilinear, blocks.area_attention
    resample.sample_bilinear = sampling.sample_bilinear_plain
    blocks.area_attention = attention.area_attention_plain
    try:
        yield
    finally:
        resample.sample_bilinear, blocks.area_attention = saved


def _float64_grads(cpu_model, cfg, batch, grads=True, device="cpu", cells=None):
    """({loss item: value}, {name: gradient on the CPU}) of the train-mode
    loss of a float64 copy of the CPU model on `device` (the plain sampler
    and attention take float64; on the card through `plain_kernels`):
    train_loss's steps, with the images normalized to float64.
    `grads=False`: the loss items alone (and None). The forward is the
    trainer's (`forward_text`: a world model on the zero text). `cells`: a
    `pinned_cells` record that K2's taps are held to (returned beside)."""
    from yolo_dbl_tpu_torch.engine.trainer import task_loss
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize

    model = copy.deepcopy(cpu_model).double().train().to(device)
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    names, params = zip(*model.named_parameters())
    with (plain_kernels() if model.device.type == "cuda" else contextlib.nullcontext()), \
            (pinned_cells(cells) if cells is not None else contextlib.nullcontext([])) as moved, \
            torch.set_grad_enabled(grads):
        loss, items = task_loss(model, cfg, model.forward_text(
            device_normalize(batch["img"], torch.float64)), batch)
    values = dict(loss=float(loss.detach()),
                  **{k: float(v.detach()) for k, v in items._asdict().items()})
    if not grads:
        return values, None
    out = {n: g.cpu() for n, g in zip(names, torch.autograd.grad(
        loss, params, materialize_grads=True))}
    return (values, out, moved) if cells is not None else (values, out)


# leaves named in train_parity, whose gradient comes only through a kernel's
# backward: the DySample offset convs (K2), the AAttn qkv convs (K3, and pe);
# YOLOv10-s has no hand kernel in a step: its PSA's qkv conv, whose gradient
# comes through the plain attention's two products and softmax; likewise
# YOLOv8-s-worldv2's C2fAttn attention projection convs (through the max-sigmoid
# text gate; their BatchNorm biases' gradients nearly cancel in the next
# train-mode BatchNorm where the gate is near one value, so they are not
# named) and YOLO-EMAC's window-3 qkv Dense (through the window attention);
# RT-DETR-l's last decoder layer's MSDeformAttn Dense layers, whose
# sampling offsets and value projection get their gradient through K2's
# backward (dgy, dgx and dx), its attention weights and output projection
# through K2's forward (held on the decoder's own step: RTDETR_LEAF_BAR)
# LDA-DBL-s's offset convs (through K2's dgy, dgx) and key projections (dx);
# Swin-T-Giraffe has no hand kernel in a step: its 12 window attentions' qkv
# Dense layers (weight and bias), whose gradient comes through the plain
# attention's two products and softmax
KERNEL_FED_LEAVES = {DBL: (".offset.conv.", 6), LDA: ((".off_pw.conv.", ".proj_k.conv."), 9),
                     SWIN: (".attn.qkv.", 24),
                     V13: (".attn.qkv.conv.", 8),
                     RTDETR: (".decoder_layers_5.cross_attn.", 8),
                     V12: (".attn.qkv.conv.", 8), V10: (".attn.qkv.conv.", 1),
                     SEG: (".proto.", 11), POSE: (".cv4_0_2.", 2), OBB: (".cv4_0_2.", 2),
                     WORLD: (".attn.proj_conv.conv.", 4), EMAC: (".win3.qkv.", 8)}


def grads_rel(card, cpu, names):
    """{name: max |card - cpu| over the CPU gradient's max |g|} for `names`;
    a leaf whose CPU gradient is 0 (a world head's embedding conv on the zero
    text) reads 0 where the card's is 0 too, and past any bar where not."""
    return {n: float((card[n] - cpu[n]).abs().max()) / max(float(cpu[n].abs().max()), 1e-30)
            for n in names}


def phase_train_parity(cfg, cpu_model, gpu_model):
    """One train-mode loss and backward of the same weights on the CPU (plain
    versions) and on the card (kernels, TF32 off). Dropout is off on both:
    the two devices draw different random bits. RT-DETR's card step and the
    float64 reference take the CPU's query selection and Hungarian
    matchings (`pinned_queries`, `pinned_matching`); the card's own are
    recorded, and where one parts from the CPU's it must be a near-tie,
    named with its scores or its two assignments' costs. RT-DETR's leaves
    are held at RTDETR_LEAF_BAR of their largest, its named leaves on its
    decoder's own step (`phase_train_parity_decoder`)."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.cfg import get_cfg
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_cfg = get_cfg()
    batch = train_batches(np.random.default_rng(2), 1, b=2, imgsz=256, nc=cfg[1],
                          task=_task(cpu_model))[0]
    results, detr = {}, cpu_model.head_name == "RTDETRDecoder"
    pins = {"queries": None, "matching": None}
    # LDA_AQU's taps: the card and the float64 reference take the CPU's cells
    lda = cfg == LDA
    cells = {"cpu": None}
    for model in (cpu_model, gpu_model):
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
        dev = model.device
        names, params = zip(*model.named_parameters())
        kernels.reset_launches()
        with (pinned_queries(pins["queries"]) if detr else contextlib.nullcontext([])) as sq, \
                (pinned_matching(pins["matching"]) if detr else contextlib.nullcontext([])) as sm, \
                (pinned_cells(cells["cpu"]) if lda else contextlib.nullcontext([])) as sc:
            loss, items = train_loss(model, train_cfg,
                                     {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        cells[dev.type] = sc
        if detr and dev.type == "cpu":
            pins = {"queries": sq[0][0], "matching": sm[0][0], "own": (sq[0], sm[0])}
        elif detr:
            pins["partings"] = _rtdetr_partings(sq[0], sm[0], pins["own"])
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        # copies: a CPU model's statistics are its live buffers
        stats = {k: v.cpu().clone() for k, v in model.state_dict().items()
                 if k.endswith(("_mean", "_var"))}
        results[dev.type] = (dict(loss=float(loss.detach()),
                                  **{k: float(v.detach()) for k, v in items._asdict().items()}),
                             dict(zip(names, (g.cpu() for g in grads))), stats,
                             dict(kernels.launches))
    (lc, gc, sc, _), (lg, gg, sg, launches) = results["cpu"], results["cuda"]
    require(launches == PER_STEP[cfg, torch.float32], f"launches in one card step: {launches}")
    loss_rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
    detect = f"m{len(gpu_model.spec.layers) - 1}."
    fed, n_fed = KERNEL_FED_LEAVES[cfg]
    fed = fed if isinstance(fed, tuple) else (fed,)
    # the first level's box and class output convs (of both v10Detect branches)
    checked = [n for n in gc if any(f in n for f in fed) or n.startswith("m0.")
               or (n.startswith(detect) and any(f".{cv}_0_2." in "." + n[len(detect):]
                                                for cv in ("cv2", "cv3")))]
    grad_rel = grads_rel(gg, gc, checked)
    # Every leaf against the float64 gradient (g64) of the same weights and
    # batch on the CPU: the card within 1e-3 of the leaf's largest |g64|, or,
    # where float32 itself does not reach that (a leaf whose gradient is a sum
    # that cancels), within 4x the CPU float32's own distance from g64; plus
    # 1e-10 of the model's largest |g64| for leaves whose exact gradient is 0.
    with (pinned_queries(pins["queries"]) if detr else contextlib.nullcontext()), \
            (pinned_matching(pins["matching"]) if detr else contextlib.nullcontext()):
        l64, g64, *moved64 = _float64_grads(cpu_model, train_cfg, batch, device="cuda",
                                            cells=cells["cpu"] if lda else None)
    if lda:  # the taps each run moved into the CPU's cells, and the largest move
        extra_cells = {"pinned_cells": {
            side: {"moved": [mv for _, mv, _ in rec],
                   "largest_move_px": max(ld for _, _, ld in rec)}
            for side, rec in (("card", cells["cuda"]), ("float64", moved64[0]))}}
    g_max = max(float(g.abs().max()) for g in g64.values())
    leaves = {}
    for n, ref in g64.items():
        card, cpu = (float((g[n].double() - ref).abs().max()) for g in (gg, gc))
        m = float(ref.abs().max())
        tol = max(1e-3 * m, 4 * cpu) + 1e-10 * g_max
        if detr and m > 1e-12 * g_max:
            tol = RTDETR_LEAF_BAR * m
        leaves[n] = dict(card_err=card, cpu_err=cpu, leaf_max=m, tol=tol,
                         card_vs_cpu=float((gg[n] - gc[n]).abs().max()))
    failing = {n: e for n, e in leaves.items() if e["card_err"] > e["tol"]}
    # the worst of the leaves whose float64 gradient is not 0
    worst = sorted(((n, e) for n, e in leaves.items() if e["leaf_max"] > 1e-12 * g_max),
                   key=lambda kv: -kv[1]["card_err"] / kv[1]["leaf_max"])
    stats_err = max(float(((sg[k] - sc[k]).abs() / (1 + sc[k].abs())).max()) for k in sc)
    past = {side: sum(e[f"{side}_err"] > 1e-3 * e["leaf_max"] + 1e-10 * g_max
                      for e in leaves.values()) for side in ("card", "cpu")}
    extra, near = pins["partings"] if detr else ({}, True)
    if lda:
        extra = extra_cells
        near = all(e["largest_move_px"] <= LDA_PIN_PX for e in extra["pinned_cells"].values())
    emit({"phase": _phase("train_parity", cfg), "batch": 2, "imgsz": 256, "losses_cpu": lc,
          "losses_card": lg, "losses_float64": l64, "loss_rel": loss_rel,
          "grad_rel_of_leaf_max": grad_rel, "model_max_abs_grad": g_max, "leaves": len(leaves),
          "zero_leaves": sum(e["leaf_max"] == 0 for e in leaves.values()),
          "leaves_past_1e-3_of_leaf_max": past["card"],
          "cpu_leaves_past_1e-3_of_leaf_max": past["cpu"],
          "worst_leaves_vs_float64": [dict(name=n, **e) for n, e in worst[:5]],
          "bn_stats_rel": stats_err, "launches": launches, **extra,
          "seconds": time.perf_counter() - t_start})
    require(near, f"RT-DETR selection or matching, or an LDA_AQU tap's cell, parted away from "
            f"a near-tie: {extra}")
    require(max(loss_rel.values()) <= 1e-4, f"loss items card vs CPU: {loss_rel}")
    # RT-DETR's named leaves are held at 1e-3 on its decoder's own step
    require(len([n for n in checked if any(f in n for f in fed)]) == n_fed
            and (detr or max(grad_rel.values()) <= 1e-3),
            f"gradients card vs CPU (of each leaf's max |g|): {grad_rel}")
    require(set(leaves) == set(gg) and not failing,
            f"leaf gradients on the card vs float64 past their tolerance: {failing}")
    require(stats_err <= 1e-4, f"BatchNorm running statistics card vs CPU: {stats_err}")


def _boxes_scores(a, b):
    """(max |d| of the boxes in px, max |d| of the scores) of two (B, 4+nc, A) decodes."""
    a, b = a.float(), b.float()
    return float((a[:, :4] - b[:, :4]).abs().max()), float((a[:, 4:] - b[:, 4:]).abs().max())


def _forward_decode(model, x):
    """(raw outputs, decode) of one inference forward: `predict`'s decode
    with the outputs a task head adds."""
    with torch.inference_mode():
        outs = model(x)
        return outs, model.decode_outputs(outs)


def _to_cpu(outs):
    return torch.utils._pytree.tree_map(lambda t: t.cpu(), outs)


def _kept_masks(outs, dets, idx, imgsz=IMGSZ):
    """Mask probabilities (prototype resolution) of kept rows: each image's
    coefficients at the kept anchors with its prototypes, cut to the boxes."""
    from yolo_dbl_tpu_torch.nn.heads import decode_masks, flatten_levels, gather_anchors

    kept = gather_anchors(flatten_levels(outs[1]), idx.to(outs[2].device))
    return [decode_masks(kept[i].float(), outs[2][i].float(), dets[i, :, :4].to(kept.device),
                         (imgsz, imgsz)) for i in range(len(dets))]


def phase_parity_bf16(cfg, cpu32, cpu16, gpu16, frames):
    """The card's bfloat16 decode against the CPU's float32 one at the same
    weights and frames, within check_amp's bars; card bfloat16 against CPU
    bfloat16 beside the CPU's own bfloat16-against-float32 spread. A Segment
    model's mask probabilities are held as its scores: on the rows the CPU's
    float32 NMS keeps (conf 0.25), each model's coefficients at those anchors
    with its own prototypes, cut to the CPU float32 boxes."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dbl_tpu_torch.ops.nms import non_max_suppression

    t_start = time.perf_counter()
    u8 = torch.from_numpy(frames)
    outs32, pred32 = _forward_decode(cpu32, letterbox_normalize(u8, (IMGSZ, IMGSZ)))
    outs_c16, pred_c16 = _forward_decode(cpu16, letterbox_normalize(u8, (IMGSZ, IMGSZ),
                                                                    out_dtype=BF16))
    outs_g16, pred_g16 = _forward_decode(gpu16, letterbox_normalize(u8.cuda(), (IMGSZ, IMGSZ),
                                                                    out_dtype=BF16))
    outs_g16, pred_g16 = _to_cpu(outs_g16), pred_g16.cpu()
    anchors = sum((IMGSZ // s) ** 2 for s in gpu16.strides)
    require(pred_g16.dtype == pred_c16.dtype == BF16
            and pred_g16.shape == pred32.shape == (2, 4 + cfg[1], anchors)
            and bool(torch.isfinite(pred_g16.float()).all()),
            f"bf16 predictions: card {pred_g16.dtype} {tuple(pred_g16.shape)}")
    card_vs_f32 = _boxes_scores(pred_g16, pred32)
    card_vs_cpu16 = _boxes_scores(pred_g16, pred_c16)
    cpu16_vs_f32 = _boxes_scores(pred_c16, pred32)
    box_bar, score_bar = 0.02 * IMGSZ, 0.05
    extra = {}
    if gpu16.head_name == "Segment":
        dets, num, idx = non_max_suppression(pred32, conf_thres=0.25, iou_thres=0.45,
                                             nc=cfg[1], return_idx=True)
        m32, mc16, mg16 = (_kept_masks(o, dets, idx) for o in (outs32, outs_c16, outs_g16))
        spread = [max(float((a[i][:k] - b[i][:k]).abs().max()) if k else 0.0
                      for i, k in enumerate(num.tolist())) for a, b in ((mg16, m32), (mc16, m32))]
        extra["mask_probability_max_abs"] = {"rows": int(num.sum()), "card_bf16_vs_cpu_f32":
                                             spread[0], "cpu_bf16_vs_cpu_f32": spread[1]}
    emit({"phase": _phase("parity", cfg, BF16), "frames": 2,
          "card_bf16_vs_cpu_f32": {"box_px": card_vs_f32[0], "score": card_vs_f32[1]},
          "card_bf16_vs_cpu_bf16": {"box_px": card_vs_cpu16[0], "score": card_vs_cpu16[1]},
          "cpu_bf16_vs_cpu_f32": {"box_px": cpu16_vs_f32[0], "score": cpu16_vs_f32[1]},
          "bars": {"box_px": box_bar, "score": score_bar}, **extra,
          "max_score": float(pred32[:, 4:].max()), "seconds": time.perf_counter() - t_start})
    require(card_vs_f32[0] < box_bar and card_vs_f32[1] < score_bar,
            f"card bf16 vs CPU f32: boxes {card_vs_f32[0]} px (< {box_bar}), scores "
            f"{card_vs_f32[1]} (< {score_bar})")
    if extra:
        require(extra["mask_probability_max_abs"]["rows"] > 0 and spread[0] < score_bar,
                f"card bf16 vs CPU f32 mask probabilities: {extra}")


# the batches (seeds) whose bfloat16 loss items train_parity_bf16 reads: a
# loss item's bfloat16 distance from float64 on one batch is noise (at
# nc=80 the class loss sums ~1M terms), on the card and on the CPU alike,
# and with the plain attention in place of K3 too
# (tools/exp_bf16_loss_layers.py), so the bar holds the medians over three
BF16_LOSS_SEEDS = (2, 3, 4)
# YOLOv10-s's e2e total adds the one2one term, whose TAL top-1 normalizer is
# the noisiest: over seeds 2-16 its bf16 loss sat 4.3-9,029 from float64 on
# the card and 18-11,509 on the CPU (medians 1,186 and 731; layer by layer
# one distance, v10Detect 0.359 and 0.370 of its largest), where seeds 2-4
# alone gave medians 1,602 and 165 (tools/exp_bf16_loss_layers.py v10
# --seeds 15), so its medians take fifteen batches
BF16_LOSS_SEEDS_BY_MODEL = {V10: tuple(range(2, 17))}


def _loss_items(model, train_cfg, batch):
    """The train-mode loss items of `batch`, without a backward."""
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    with torch.no_grad():
        loss, items = train_loss(model, train_cfg, {k: torch.as_tensor(v).to(model.device)
                                                    for k, v in batch.items()})
    return dict(loss=float(loss), **{k: float(v) for k, v in items._asdict().items()})


def phase_train_parity_bf16(cfg, cpu32, cpu16, gpu16):
    """One train-mode loss and backward of bfloat16 models on the CPU (plain
    versions) and on the card (kernels): the leaves a kernel's backward
    feeds against the CPU's float64, within 4x the CPU bfloat16's own
    distance from it; the loss items likewise, the medians of the
    distances over the BF16_LOSS_SEEDS batches (the model's own in
    BF16_LOSS_SEEDS_BY_MODEL)."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.cfg import get_cfg
    from yolo_dbl_tpu_torch.engine.trainer import train_loss

    t_start = time.perf_counter()
    train_cfg = get_cfg()
    batch = train_batches(np.random.default_rng(2), 1, b=2, imgsz=256, nc=cfg[1])[0]
    results = []
    for model in (cpu32, cpu16, gpu16):
        for mod in model.modules():
            if isinstance(mod, torch.nn.Dropout):
                mod.p = 0.0
    for model in (cpu16, gpu16):
        dev = model.device
        names, params = zip(*model.named_parameters())
        kernels.reset_launches()
        loss, items = train_loss(model, train_cfg,
                                 {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        results.append((dict(loss=float(loss.detach()),
                             **{k: float(v.detach()) for k, v in items._asdict().items()}),
                        dict(zip(names, (g.cpu() for g in grads))), dict(kernels.launches)))
    (lc, gc, _), (lg, gg, launches) = results
    require(launches == PER_STEP[cfg, BF16], f"launches in one bf16 card step: {launches}")
    l64, g64 = _float64_grads(cpu32, train_cfg, batch, device="cuda")
    runs = [(lg, lc, l64)]
    seeds = BF16_LOSS_SEEDS_BY_MODEL.get(cfg, BF16_LOSS_SEEDS)
    for seed in seeds[1:]:
        more = train_batches(np.random.default_rng(seed), 1, b=2, imgsz=256, nc=cfg[1])[0]
        runs.append((_loss_items(gpu16, train_cfg, more), _loss_items(cpu16, train_cfg, more),
                     _float64_grads(cpu32, train_cfg, more, grads=False, device="cuda")[0]))
    loss_d = {k: dict(card=[abs(g[k] - r[k]) for g, _, r in runs],
                      cpu_bf16=[abs(c[k] - r[k]) for _, c, r in runs],
                      float64=[r[k] for _, _, r in runs]) for k in l64}
    for e in loss_d.values():
        e["median_card"], e["median_cpu_bf16"] = (statistics.median(e["card"]),
                                                  statistics.median(e["cpu_bf16"]))
    fed, n_fed = KERNEL_FED_LEAVES[cfg]
    g_max = max(float(g.abs().max()) for g in g64.values())
    leaves = {n: dict(card=float((gg[n].double() - g64[n]).abs().max()),
                      cpu_bf16=float((gc[n].double() - g64[n]).abs().max()),
                      leaf_max=float(g64[n].abs().max()))
              for n in g64 if fed in n}
    emit({"phase": _phase("train_parity", cfg, BF16), "batch": 2, "imgsz": 256,
          "loss_seeds": seeds, "loss_distance_from_float64": loss_d,
          "kernel_fed_leaves": leaves,
          "model_max_abs_grad": g_max, "launches": launches,
          "seconds": time.perf_counter() - t_start})
    require(len(leaves) == n_fed and all(
        e["card"] <= 4 * e["cpu_bf16"] + 1e-10 * g_max for e in leaves.values()),
        f"kernel-fed leaves, card bf16 vs CPU float64 past 4x the CPU bf16's distance: {leaves}")
    require(all(e["median_card"] <= 4 * e["median_cpu_bf16"] for e in loss_d.values()),
            f"loss items, card bf16 vs CPU float64 (medians over the seeds): {loss_d}")

# validation: 4 batches of 16 seeded 640x640 images, each with 1-3 filled
# rectangles of a class colour on a noise background
VAL_BATCHES, VAL_B = 4, 16
VAL_COLOURS = ((230, 200, 60), (60, 220, 220), (10, 10, 120))
V8, V8_PARAMS = ("yolov8n.yaml", NC), 3011417
METRIC_KEYS = ("mAP50", "mAP50-95", "precision", "recall")
NOT_A_QUALITY_CLAIM = "random weights: the mAP shows the path runs, it is no quality claim"


@contextlib.contextmanager
def host_solve_timer():
    """Wall ms of each RT-DETR host solve (losses/detr.py `assign`: the
    costs' copy to the host, scipy, the indices back on the card), the card
    synchronised first so that the forward's tail does not count."""
    from yolo_dbl_tpu_torch.losses import detr

    times, inner = [], detr.assign

    def timed(cost, counts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(cost, counts)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    detr.assign = timed
    try:
        yield times
    finally:
        detr.assign = inner


@contextlib.contextmanager
def tf32_off():
    """TF32 off for a card-against-CPU check; the previous settings after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def val_batches(rng, n=VAL_BATCHES, b=VAL_B, imgsz=IMGSZ, m=TRAIN_M, nc=NC):
    """Seeded validation batches: uint8 images with 1-3 filled rectangles
    each (drawn by slicing) and their boxes in the loss's form (normalized
    xywh, classes, mask; padded to m)."""
    out = []
    for _ in range(n):
        img = rng.integers(30, 70, (b, imgsz, imgsz, 3), dtype=np.uint8)
        boxes = np.zeros((b, m, 4), np.float32)
        cls = np.zeros((b, m), np.int32)
        mask = np.zeros((b, m), np.float32)
        for i in range(b):
            for j in range(int(rng.integers(1, 4))):
                w, h = (int(v) for v in rng.integers(imgsz // 10, imgsz // 3, 2))
                x1, y1 = int(rng.integers(0, imgsz - w)), int(rng.integers(0, imgsz - h))
                c = int(rng.integers(0, nc))
                img[i, y1:y1 + h, x1:x1 + w] = VAL_COLOURS[c]
                boxes[i, j] = ((x1 + w / 2) / imgsz, (y1 + h / 2) / imgsz, w / imgsz, h / imgsz)
                cls[i, j], mask[i, j] = c, 1.0
        out.append(dict(img=img, gt_boxes=boxes, gt_cls=cls, gt_mask=mask))
    return out


def _first_images(batch, n=2):
    return {k: v[:n] for k, v in batch.items()}


def _metrics(res):
    return {**{k: res[k] for k in METRIC_KEYS}, **res["coco_stats"]}


def run_validator(model, batches):
    """The port's DetectionValidator over `batches` (conf 0.001, iou 0.7,
    max_det 300, the COCO 12 stats) after one warm-up batch: its results,
    the kernels it launched, its wall seconds, the loop's img/s, and the
    device time of one batch's inference by part (`infer`: /255, forward,
    decode, NMS) with the device's busy share over the loop's inference."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.validator import DetectionValidator

    val = DetectionValidator(model, conf=0.001, iou=0.7, max_det=300, use_coco_stats=True)
    val(batches[:1])
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = val(batches)
    wall = time.perf_counter() - t0
    speed = res["speed_ms_per_image"]
    launches = dict(kernels.launches)
    img = torch.from_numpy(batches[-1]["img"]).to(model.device)
    p = by_part(lambda i: val.infer(img), 1)
    per_batch_ms = speed["inference"] * len(batches[-1]["img"])
    profile = {"device_ms_per_batch": p["device_ms"], "device_ops_per_batch": p["device_ops"],
               "inference_ms_per_batch": per_batch_ms,
               "device_busy_share": p["device_ms"] / per_batch_ms, "by_part_ms": p["by_part_ms"],
               "top_kernels_ms": p["top_kernels_ms"][:6]}
    return res, launches, wall, 1e3 / (speed["inference"] + speed["postprocess"]), profile


def _gt_near(dets, counts, rng, top=6):
    """Ground truth next to detections: each image's top `top` rows, moved
    by 2 px and given another class now and then. Random weights score 0 on
    the drawn rectangles; against these boxes the metrics compared are not 0."""
    labels = []
    for d, k in zip(dets, counts):
        d = d[:min(int(k), top)].astype(np.float64)
        cls = np.where(rng.random(len(d)) < 0.8, d[:, 5], rng.integers(0, NC, len(d)))
        labels.append({"boxes": (d[:, :4] + rng.normal(0, 2, (len(d), 4))).astype(np.float32),
                       "cls": cls.astype(np.int32)})
    return labels


def check_val_against_cpu(gpu_model, cpu_model, batch):
    """The first 2 images through the validator on the card and on the CPU
    (TF32 off): the same kept count per image, rows within 0.05 px and 1e-3,
    each metric and COCO stat within 1e-3, against the drawn rectangles and
    against boxes next to the CPU's detections (where the metrics are not 0)."""
    from yolo_dbl_tpu_torch.engine.validator import DetectionValidator

    two = _first_images(batch)
    with tf32_off():
        vals = [DetectionValidator(m, conf=0.001, iou=0.7, max_det=300, use_coco_stats=True)
                for m in (gpu_model, cpu_model)]
        (dg, ng), (dc, nc) = ([t.cpu().numpy() for t in v.infer(torch.from_numpy(two["img"])
                                                                  .to(v.model.device))]
                              for v in vals)
        near = [{"img": two["img"], "labels": _gt_near(dc, nc, np.random.default_rng(5))}]
        mg, mc = ({**_metrics(v([two])), **{f"near_{k}": x for k, x in _metrics(v(near)).items()}}
                  for v in vals)
    require(np.array_equal(ng, nc) and nc.sum() > 0,
            f"kept per image, card {ng.tolist()} vs CPU {nc.tolist()} (some must be kept)")
    box_err = max(float(np.abs(dg[i, :k, :4] - dc[i, :k, :4]).max(initial=0))
                  for i, k in enumerate(nc))
    score_err = max(float(np.abs(dg[i, :k, 4] - dc[i, :k, 4]).max(initial=0))
                    for i, k in enumerate(nc))
    cls_equal = all(np.array_equal(dg[i, :k, 5], dc[i, :k, 5]) for i, k in enumerate(nc))
    metric_err = max(abs(mg[k] - mc[k]) for k in mc)
    gate = {"images": 2, "kept": nc.tolist(), "box_max_abs_px": box_err,
            "score_max_abs": score_err, "classes_equal": cls_equal,
            "metric_max_abs": metric_err, "tf32": False,
            "metrics_gt_near_detections_cpu": {k[5:]: v for k, v in mc.items()
                                               if k.startswith("near_")}}
    require(box_err < 0.05 and score_err <= 1e-3 and cls_equal and metric_err <= 1e-3
            and mc["near_mAP50"] > 0, f"validator card vs CPU on 2 images: {gate}")
    return gate


def phase_val(card, dtype=torch.float32, cpu32=None, f32_metrics=None):
    """YOLO-DBL-s (nc=3, 640) through DetectionValidator on the card: the
    main phase's seeded weights with the Detect class biases of the model's
    own init. Float32: gated against the CPU on 2 images; bfloat16: its
    decode on 2 images against the CPU's float32 within check_amp's bars.
    Returns the CPU float32 model, the metrics and the launches."""
    batches = val_batches(np.random.default_rng(4))
    cpu, gpu = build_models(DBL, dtype, zero_class_bias=False)
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    res, launches, wall, img_s, profile = run_validator(gpu, batches)
    want = _launches({"sample_bilinear": 3 * VAL_BATCHES}, dtype)
    require(launches == want, f"launches in {VAL_BATCHES} val batches: {launches}, expected {want}")
    require(res["images"] == VAL_BATCHES * VAL_B and all(np.isfinite(v) and v >= -1
                                                         for v in _metrics(res).values()),
            f"validator results {res}")
    if dtype == torch.float32:
        cpu32, gate = cpu, check_val_against_cpu(gpu, cpu, batches[0])
    else:
        from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize

        img = torch.from_numpy(batches[0]["img"][:2])
        with tf32_off():
            pred32 = cpu32.predict(device_normalize(img))
            pred16 = gpu.predict(device_normalize(img.cuda(), BF16)).cpu()
        box, score = _boxes_scores(pred16, pred32)
        gate = {"images": 2, "card_bf16_vs_cpu_f32": {"box_px": box, "score": score},
                "bars": {"box_px": 0.02 * IMGSZ, "score": 0.05}}
        require(box < 0.02 * IMGSZ and score < 0.05, f"val bf16 decode vs CPU f32: {gate}")
    metrics = _metrics(res)
    emit({"phase": "val" + ("_bf16" if dtype == BF16 else ""), "model": DBL[0][:-5], "nc": NC,
          "dtype": str(dtype).split(".")[-1], "imgsz": IMGSZ, "batches": VAL_BATCHES,
          "batch": VAL_B, "images": res["images"], "conf": 0.001, "iou": 0.7, "max_det": 300,
          **{k: res[k] for k in METRIC_KEYS}, "coco_stats": res["coco_stats"],
          **({"float32": f32_metrics} if f32_metrics else {}),
          "speed_ms_per_image": res["speed_ms_per_image"], "img_per_s": img_s,
          "validator_seconds": wall, "launches": launches, "profile": profile, "gate": gate,
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM,
          "card": card})
    return cpu32, metrics, launches


def phase_v8(card):
    """yolov8n (nc=3, 640, float32): card decode against the CPU's on 2
    images, training steps through Trainer.step, then the validator over
    the val batches. No hand kernel runs on this model."""
    from yolo_dbl_tpu_torch import DetectionModel, kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize

    name, nc = V8
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = DetectionModel(name, nc=nc, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    n_params = sum(p.numel() for p in gpu.parameters())
    require(n_params == V8_PARAMS, f"yolov8n parameters {n_params}, expected {V8_PARAMS}")
    batches = val_batches(np.random.default_rng(4))
    img = torch.from_numpy(batches[0]["img"][:2])
    kernels.reset_launches()
    with tf32_off():
        pred_c = cpu.predict(device_normalize(img))
        pred_g = gpu.predict(device_normalize(img.cuda())).cpu()
    require(pred_g.shape == pred_c.shape and bool(torch.isfinite(pred_g).all()),
            f"yolov8n predictions {tuple(pred_g.shape)}")
    box_err, score_err = _boxes_scores(pred_g, pred_c)
    require(box_err < 0.05 and score_err <= 1e-3,
            f"yolov8n card vs CPU: boxes {box_err} px (< 0.05), scores {score_err} (<= 1e-3)")

    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    trainer = Trainer(gpu, {"batch": TRAIN_B}).setup(steps_per_epoch=100)
    train = train_batches(np.random.default_rng(1), TRAIN_WARMUP + TRAIN_STEPS, nc=nc)
    losses, step_ms = [], []
    for i, batch in enumerate(train):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.step(batch).items()}
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(v) for m in losses for v in m.values()), f"non-finite losses {losses}")
    step_profile = by_part(lambda i: (trainer.step(train[-1]), torch.cuda.synchronize()), 1)
    res, val_launches, wall, img_s, val_profile = run_validator(gpu, batches)
    launches = dict(kernels.launches)
    require(launches == NO_LAUNCH and val_launches == NO_LAUNCH,
            f"a hand kernel ran on yolov8n: {launches}, {val_launches}")
    require(res["images"] == VAL_BATCHES * VAL_B, f"validator results {res}")
    med = statistics.median(step_ms)
    emit({"phase": "v8", "model": name[:-5], "nc": nc, "dtype": "float32", "imgsz": IMGSZ,
          "n_params": n_params, "parity": {"frames": 2, "box_max_abs_px": box_err,
                                           "score_max_abs": score_err, "tf32": False},
          "train": {"batch": TRAIN_B, "optimizer": trainer.optimizer.name,
                    "steps": TRAIN_STEPS, "step_ms": step_ms, "median_ms": med,
                    "img_per_s": TRAIN_B / (med / 1e3), "losses": losses,
                    "max_memory_allocated_bytes": peak,
                    "profile": {"device_ms_per_step": step_profile["device_ms"],
                                "device_ops_per_step": step_profile["device_ops"],
                                "device_busy_share": step_profile["device_ms"] / med,
                                "by_part_ms": step_profile["by_part_ms"],
                                "top_kernels_ms": step_profile["top_kernels_ms"][:6]}},
          "val": {"images": res["images"], **{k: res[k] for k in METRIC_KEYS},
                  "coco_stats": res["coco_stats"], "speed_ms_per_image": res["speed_ms_per_image"],
                  "img_per_s": img_s, "validator_seconds": wall, "profile": val_profile,
                  "note": NOT_A_QUALITY_CLAIM},
          "launches": launches, "hand_kernels": "none: yolov8n runs no hand kernel",
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})


# the facade phase: YOLO-DBL-s through YOLO at full width and depth on a
# shapes set at 640 (32 train, 16 val images), batch 16; then the best
# checkpoint validates and predicts 12 JPEG frames of two sizes (two buckets)
FACADE_TRAIN, FACADE_VAL, FACADE_B = 32, 16, 16
FACADE_SIZES, FACADE_FRAMES, FACADE_REQUESTS = ((512, 768), (480, 640)), 12, 3
# the convergence run of record (tests/test_convergence.py's arguments)
CONVERGE = dict(epochs=60, batch=8, imgsz=160, lr0=0.01, patience=61, mosaic=1.0, close_mosaic=15,
                warmup_epochs=3.0, workers=0, plots=False, verbose=False)


def _counts(results):
    return [len(r) for r in results]


def _predict_recorded(yolo, frames, conf, iou, imgsz=IMGSZ):
    """`yolo.predict(frames)` at `conf`, `iou` and `imgsz`, and the decode
    each chunk handed NMS, one (4+nc, A) float32 tensor an image on the
    host, in the order of the predictor's chunks: the frames' own order for
    two frames of one size or of two. Every predictor decodes through the
    model's `decode_outputs` (the detect one inside `predict`)."""
    raw, decode = [], yolo.model.decode_outputs

    def recorded(feats, **kw):
        out = decode(feats, **kw)
        raw.extend(out.float().cpu())
        return out

    yolo.model.decode_outputs = recorded
    try:
        return yolo.predict(frames, conf=conf, iou=iou, imgsz=imgsz), raw
    finally:
        del yolo.model.decode_outputs


def _nms_decisions(pred, conf, pre_nms_topk=1024):
    """What ops/nms.py decides from on one image's decode (4+nc, A) on the
    host, class-aware and multi-label: the flat (anchor, class) scores,
    whose comparison with `conf` picks the candidates; the flat indices of
    the top `pre_nms_topk` of those, in order; and each flat entry's box
    with its class offset, whose IoUs decide the suppression."""
    from yolo_dbl_tpu_torch.ops.boxes import xywh2xyxy
    from yolo_dbl_tpu_torch.ops.nms import MAX_WH, _topk

    nc = pred.shape[0] - 4
    flat = pred[4:].T.reshape(-1)
    vals, idx = _topk(torch.where(flat > conf, flat, -torch.inf), min(pre_nms_topk, flat.numel()))
    cls = torch.arange(nc, dtype=torch.float32).repeat(pred.shape[1])
    boxes = xywh2xyxy(pred[:4].T).repeat_interleave(nc, 0) + cls[:, None] * MAX_WH
    return flat, idx[vals > -torch.inf], boxes


def _nms_partings(card, cpu, conf, iou):
    """The decisions of NMS that part the card's decode of an image from
    the CPU's, by kind, each with its count and its first case's values on
    both devices: scores on the other side of `conf`; the top candidates
    (the pre-NMS cut); the order of two candidates of both (a near-tie of
    their scores); an IoU of two candidates of both on the other side of
    `iou`. Empty when NMS decides alike on both: then it keeps the same
    rows."""
    from yolo_dbl_tpu_torch.ops.boxes import box_iou

    (fa, ia, ba), (fb, ib, bb) = (_nms_decisions(p, conf) for p in (card, cpu))
    out = {}
    over = ((fa > conf) != (fb > conf)).nonzero()[:, 0]
    if len(over):
        j = int(over[0])
        out["score > conf"] = {"count": len(over), "conf": conf, "card": float(fa[j]),
                               "cpu": float(fb[j])}
    moved = set(ia.tolist()) ^ set(ib.tolist())
    if moved:
        out["top candidates"] = {"count": len(moved)}
    rank_card = {f: r for r, f in enumerate(ia.tolist())}
    both = [f for f in ib.tolist() if f in rank_card]  # in the CPU's order
    swaps = [i for i in range(len(both) - 1) if rank_card[both[i]] > rank_card[both[i + 1]]]
    if swaps:
        f, g = both[swaps[0]], both[swaps[0] + 1]
        out["candidate order"] = {"count": len(swaps), "card": [float(fa[f]), float(fa[g])],
                                  "cpu": [float(fb[f]), float(fb[g])]}
    idx = torch.tensor(both, dtype=torch.long)
    ua, ub = (box_iou(x[idx], x[idx]).tril(-1) for x in (ba, bb))
    part = ((ua > iou) != (ub > iou)).nonzero()
    if len(part):
        i, j = part[0].tolist()
        out["iou > iou_thres"] = {"count": len(part), "iou_thres": iou, "card": float(ua[i, j]),
                                  "cpu": float(ub[i, j])}
    return out


def _facade_gate(best, frames, conf=0.001, iou=0.45, imgsz=IMGSZ, load=None):
    """The best checkpoint on the card and on the CPU (TF32 off) over 2
    frames at conf 0.001: the decode handed NMS within 0.05 px of the canvas
    and 1e-3 at every anchor; the card's NMS on its decode equal to the
    CPU's NMS on that decode; and in each frame equal kept counts with boxes
    within 0.05 px, scores within 1e-3 and equal classes, or kept rows
    that part at decisions `_nms_partings` names on the two decodes. An OBB
    checkpoint's rows and NMS are the rotated ones (angles 1e-4,
    `_nms_partings_rotated`), and its decode's angle row is held at 1e-4. NMS is
    discrete: a score or an IoU within float32 rounding of its threshold
    may fall on either side of it on the two devices; the decode's bars
    bound how far. `load(best, device=)` builds the YOLO of each device
    (default `YOLO`)."""
    from yolo_dbl_tpu_torch.engine.model import YOLO
    from yolo_dbl_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_rotated

    load = load or YOLO
    with tf32_off():
        got, raw_got = _predict_recorded(load(best), frames, conf, iou, imgsz)
        want, raw_want = _predict_recorded(load(best, device="cpu"), frames, conf, iou, imgsz)
    obb = got[0].obb is not None
    nms_fn = non_max_suppression_rotated if obb else non_max_suppression
    require(len(raw_got) == len(raw_want) == len(frames),
            f"decodes recorded: {len(raw_got)} card, {len(raw_want)} CPU, {len(frames)} frames")
    decode_box = max(float((g[:4] - w[:4]).abs().max()) for g, w in zip(raw_got, raw_want))
    last = -1 if obb else None  # an OBB decode's angle row, held apart
    decode_score = max(float((g[4:last] - w[4:last]).abs().max())
                       for g, w in zip(raw_got, raw_want))
    decode_angle = max(float((g[-1] - w[-1]).abs().max()) for g, w in zip(raw_got, raw_want)) \
        if obb else 0.0
    nms_equal = True
    for g in raw_got:
        (dc, nc), (dh, nh) = (nms_fn(g[None].to(dev), conf_thres=conf, iou_thres=iou)
                              for dev in ("cuda", "cpu"))
        nms_equal &= torch.equal(nc.cpu(), nh) and torch.equal(dc.cpu(), dh)
    def rows(r):
        if obb:  # [x, y, w, h, angle, conf, cls] in frame pixels
            return r.obb.data
        return np.concatenate([r.boxes.xyxy, r.boxes.conf[:, None], r.boxes.cls[:, None]], 1)

    frames_gate, named = _frames_alike([rows(r) for r in got], [rows(r) for r in want],
                                       raw_got, raw_want, conf, iou)
    gate = {"frames": len(frames), "conf": conf, "iou": iou, "kept_card": _counts(got),
            "kept_cpu": _counts(want), "decode_box_max_abs_px": decode_box,
            "decode_score_max_abs": decode_score, "nms_card_equals_cpu": nms_equal,
            **frames_gate, "tf32": False}
    if obb:
        gate["decode_angle_max_abs"] = decode_angle
    task = got[0].masks is not None or got[0].keypoints is not None
    if task:
        gate["rows_kept_alike"] = _facade_task_rows(best, frames, conf, iou, imgsz)
    require(decode_box < 0.05 and decode_score <= 1e-3 and decode_angle <= 1e-4 and nms_equal
            and sum(_counts(want)) > 0
            and frames_gate["box_max_abs_px"] < 0.05 and frames_gate["score_max_abs"] <= 1e-3
            and frames_gate["classes_equal"] and named
            and (not task or _task_rows_ok(gate["rows_kept_alike"])), f"facade card vs CPU: {gate}")
    return gate


def _rotated_nms_decisions(pred, conf, pre_nms_topk=1024):
    """What ops/nms.py's rotated NMS decides from on one image's OBB decode
    (4+nc+1, A) on the host: each anchor's best score, whose comparison with
    `conf` picks the candidates; its best class; the anchors of the top
    `pre_nms_topk` candidates, in order; and each anchor's rotated box."""
    from yolo_dbl_tpu_torch.ops.nms import _topk

    scores = pred[4:-1]
    best = scores.amax(0)
    vals, idx = _topk(torch.where(best >= conf, best, -torch.inf), min(pre_nms_topk, len(best)))
    return best, scores.argmax(0), idx[vals > -torch.inf], torch.cat([pred[:4], pred[-1:]]).T


def _nms_partings_rotated(card, cpu, conf, iou):
    """`_nms_partings` for the rotated fast-NMS of two OBB decodes of an
    image: best scores on the other side of `conf` (>=), a best class that
    differs, the top candidates, two candidates' order, and a probiou of two
    candidates of both on the other side of `iou` (>=; every earlier live
    candidate counts, kept or not)."""
    from yolo_dbl_tpu_torch.losses.extra import probiou

    (fa, ca, ia, ba), (fb, cb, ib, bb) = (_rotated_nms_decisions(p, conf) for p in (card, cpu))
    out = {}
    over = ((fa >= conf) != (fb >= conf)).nonzero()[:, 0]
    if len(over):
        j = int(over[0])
        out["score >= conf"] = {"count": len(over), "conf": conf, "card": float(fa[j]),
                                "cpu": float(fb[j])}
    flipped = [int(j) for j in ia.tolist() if int(ca[j]) != int(cb[j])]
    if flipped:
        j = flipped[0]
        out["best class"] = {"count": len(flipped), "card": [int(ca[j]), float(fa[j])],
                             "cpu": [int(cb[j]), float(fb[j])]}
    moved = set(ia.tolist()) ^ set(ib.tolist())
    if moved:
        out["top candidates"] = {"count": len(moved)}
    rank_card = {f: r for r, f in enumerate(ia.tolist())}
    both = [f for f in ib.tolist() if f in rank_card]  # in the CPU's order
    swaps = [i for i in range(len(both) - 1) if rank_card[both[i]] > rank_card[both[i + 1]]]
    if swaps:
        f, g = both[swaps[0]], both[swaps[0] + 1]
        out["candidate order"] = {"count": len(swaps), "card": [float(fa[f]), float(fa[g])],
                                  "cpu": [float(fb[f]), float(fb[g])]}
    idx = torch.tensor(both, dtype=torch.long)
    ua, ub = (probiou(x[idx][:, None], x[idx][None]).triu(1) for x in (ba, bb))
    part = ((ua >= iou) != (ub >= iou)).nonzero()
    if len(part):
        i, j = part[0].tolist()
        out["probiou >= iou_thres"] = {"count": len(part), "iou_thres": iou,
                                       "card": float(ua[i, j]), "cpu": float(ub[i, j])}
    return out


def _frames_alike(card_rows, cpu_rows, card_decodes, cpu_decodes, conf, iou):
    """Each frame's kept rows on the card against the CPU's, each an (n, 6)
    array [x1, y1, x2, y2, conf, cls], or an OBB model's (n, 7) [x, y, w, h,
    angle, conf, cls]: alike (equal counts, boxes within 0.05 px, angles
    within 1e-4, scores within 1e-3, equal classes), or parted, with the
    decisions `_nms_partings` (`_nms_partings_rotated`) names on the frame's
    two decodes ({} for an alike frame). Returns ({box_max_abs_px,
    score_max_abs, classes_equal} (and angle_max_abs) over the alike frames,
    frames_parted, partings) and whether every parted frame's partings are
    named."""
    box = score = angle = 0.0
    cls_equal, parted, partings, rotated = True, [], [], False
    for i, (g, w) in enumerate(zip(card_rows, cpu_rows)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        rotated = g.shape[-1] == 7
        alike = len(g) == len(w)
        if alike:
            fb = float(np.abs(g[:, :4] - w[:, :4]).max(initial=0))
            fa = float(np.abs(g[:, 4] - w[:, 4]).max(initial=0)) if rotated else 0.0
            fs = float(np.abs(g[:, -2] - w[:, -2]).max(initial=0))
            fc = bool(np.array_equal(g[:, -1], w[:, -1]))
            alike = fb < 0.05 and fa <= 1e-4 and fs <= 1e-3 and fc
        if alike:
            box, angle, score = max(box, fb), max(angle, fa), max(score, fs)
            cls_equal = cls_equal and fc
        else:
            parted.append(i)
        names = _nms_partings_rotated if rotated else _nms_partings
        partings.append({} if alike else names(card_decodes[i], cpu_decodes[i], conf, iou))
    out = {"box_max_abs_px": box, "score_max_abs": score, "classes_equal": cls_equal,
           "frames_parted": parted, "partings": partings}
    if rotated:
        out["angle_max_abs"] = angle
    return out, all(partings[i] for i in parted)


def _mask_iou(a, b):
    """Pooled IoU of two stacks of bool masks (1 where both are empty)."""
    union = int((a | b).sum())
    return int((a & b).sum()) / union if union else 1.0


def _facade_task_rows(best, frames, conf, iou, imgsz):
    """`_task_rows` of the best checkpoint's outputs of the same frames (one
    size) on the card and on the CPU (TF32 off), each NMS'd at `conf` and
    `iou` with its anchor indices: the masks or keypoints of the rows both
    keep. (The facade's `Results` carry no anchor index, and boxes clipped
    to the frame coincide too often to pair the rows by box.)"""
    from yolo_dbl_tpu_torch.engine.model import YOLO
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dbl_tpu_torch.ops.nms import non_max_suppression

    card, cpu = YOLO(best).model, YOLO(best, device="cpu").model
    u8, size = torch.from_numpy(np.stack(frames)), (imgsz, imgsz)
    with tf32_off():
        oc, pc = _forward_decode(cpu, letterbox_normalize(u8, size))
        og, pg = _forward_decode(card, letterbox_normalize(u8.cuda(), size))
    kept = [_to_cpu(non_max_suppression(p, conf_thres=conf, iou_thres=iou, nc=cpu.nc,
                                        return_idx=True)) for p in (pg, pc)]
    return _task_rows(cpu, _to_cpu(og), oc, *kept, imgsz, frames[0].shape[:2])


def phase_facade(card):
    """YOLO-DBL-s (nc=3, 640, float32, full width and depth) through the
    facade on the card: train 1 epoch, resume to 2, then the best checkpoint
    validates and predicts (plain, classes=[1], agnostic_nms), and the CLI
    predicts in a process of its own. Returns the launches by path."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO
    from yolo_dbl_tpu_torch.native import loader as native

    from tests.fixtures import make_shapes_dataset
    from tests.torch_fixtures import write_jpeg_frames

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    launches, wall = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = make_shapes_dataset(tmp / "shapes", n_train=FACADE_TRAIN, n_val=FACADE_VAL,
                                   imgsz=IMGSZ)
        frames_dir = tmp / "frames"
        paths = write_jpeg_frames(frames_dir, FACADE_SIZES, FACADE_FRAMES, seed=6)
        args = dict(batch=FACADE_B, imgsz=IMGSZ, project=str(tmp / "runs"), name="facade",
                    workers=0, plots=False, verbose=False)
        legs = []
        for epochs, extra in ((1, {}), (2, {"resume": True})):
            y = YOLO(DBL[0], nc=NC)
            kernels.reset_launches()
            t0 = time.perf_counter()
            if extra:  # the resumed epoch runs under the profiler: its device time by part
                epoch_profile, out = traced_once(lambda: y.train(data, epochs=epochs, **args,
                                                                 **extra))
            else:
                out = y.train(data, epochs=epochs, **args)
            torch.cuda.synchronize()
            wall[f"train_epochs_{epochs}"] = time.perf_counter() - t0
            legs.append((out, y.trainer.steps, dict(kernels.launches)))
        (out1, steps1, l1), (out2, steps2, l2) = legs
        epoch_profile["device_busy_share"] = epoch_profile["device_ms"] / (wall["train_epochs_2"] * 1e3)
        per_epoch = FACADE_TRAIN // FACADE_B  # steps; the val set is one batch
        want = _launches({"sample_bilinear": 3 * (per_epoch + 1),
                          "sample_bilinear_backward": 3 * per_epoch}, torch.float32)
        require([h["epoch"] for h in out1["history"]] == [0]
                and [h["epoch"] for h in out2["history"]] == [1]
                and (steps1, steps2) == (per_epoch, 2 * per_epoch),
                f"resume: epochs {out1['history']}, {out2['history']}, steps {steps1}, {steps2}")
        require(l1 == want and l2 == want, f"train launches {l1}, {l2}, expected {want} an epoch")
        require(all(np.isfinite(v) for h in out1["history"] + out2["history"] for v in h.values()),
                "non-finite train history")
        launches["facade_train"] = {k: l1[k] + l2[k] for k in l1}
        run = Path(out2["run_dir"])
        best = run / "best.ckpt"
        ckpt_bytes = {f.name: f.stat().st_size for f in sorted(run.glob("*.ckpt"))}

        yb = YOLO(best)
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = yb.val(data, imgsz=IMGSZ, batch=FACADE_B)
        torch.cuda.synchronize()
        wall["val"] = time.perf_counter() - t0
        launches["facade_val"] = dict(kernels.launches)
        require(launches["facade_val"] == _launches({"sample_bilinear": 3}, torch.float32)
                and metrics["images"] == FACADE_VAL, f"val: {metrics}, {launches['facade_val']}")
        # the val loader's lane: native wherever the native loader built and is not turned off
        lane = ("native" if native.is_available() and os.environ.get("YOLO_DBL_NATIVE_LOADER") != "0"
                else "python")

        per_request = _launches({"letterbox_normalize": len(FACADE_SIZES),
                                 "sample_bilinear": 3 * len(FACADE_SIZES)}, torch.float32)
        yb.predict(frames_dir)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        request_ms, counts = [], []
        for _ in range(FACADE_REQUESTS):
            t0 = time.perf_counter()
            res = yb.predict(frames_dir)
            request_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(_counts(res))
        launches["facade_predict"] = dict(kernels.launches)
        require(launches["facade_predict"] == {k: v * FACADE_REQUESTS for k, v in per_request.items()}
                and len(res) == FACADE_FRAMES
                and [r.orig_shape for r in res] == [FACADE_SIZES[i % 2] for i in range(FACADE_FRAMES)],
                f"predict: {launches['facade_predict']}, {[r.orig_shape for r in res]}")
        request_profile = by_part(lambda i: yb.predict(frames_dir), 1)
        request_profile["device_busy_share"] = (request_profile["device_ms"]
                                                / statistics.median(request_ms))
        frames = [r.orig_img for r in res]
        t0 = time.perf_counter()
        decoded = yb.predict(frames)
        list_ms = (time.perf_counter() - t0) * 1e3
        require(_counts(decoded) == counts[-1], "predict on decoded frames vs on the directory")

        plain, one_class, agnostic = (yb.predict(frames_dir, conf=0.001, **kw) for kw in
                                      ({}, {"classes": [1]}, {"agnostic_nms": True}))
        require(sum(_counts(one_class)) > 0 and all((r.boxes.cls == 1).all() for r in one_class),
                "classes=[1] must keep class 1 only")
        require(sum(_counts(agnostic)) <= sum(_counts(plain)), "agnostic NMS kept more boxes")
        gate = _facade_gate(best, frames[:2])

        # the CLI in a process of its own, against this process at its settings
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "yolo_dbl_tpu_torch", "detect", "predict",
                              f"model={best}", f"source={frames_dir}", "conf=0.001"],
                             capture_output=True, text=True, cwd=Path(__file__).resolve().parent)
        wall["cli_predict"] = time.perf_counter() - t0
        cli_counts = [int(ln.split()[-2]) for ln in cli.stdout.splitlines()
                      if ln.endswith(" detections")]
        require(cli.returncode == 0 and cli_counts == _counts(plain),
                f"CLI predict: rc {cli.returncode}, counts {cli_counts} vs {_counts(plain)}; "
                f"{cli.stderr[-2000:]}")
    emit({"phase": "facade", "model": DBL[0][:-5], "nc": NC, "dtype": "float32", "imgsz": IMGSZ,
          "train": {"images": FACADE_TRAIN, "batch": FACADE_B, "steps": [steps1, steps2],
                    "history": out1["history"] + out2["history"], "resumed_at_epoch": 1},
          "val": {"images": metrics["images"], **{k: metrics[k] for k in METRIC_KEYS},
                  "speed_ms_per_image": metrics["speed_ms_per_image"], "loader_lane": lane,
                  "native_build_error": (native.build_error() or "")[-500:]},
          "predict": {"frames": FACADE_FRAMES, "sizes": FACADE_SIZES, "requests": FACADE_REQUESTS,
                      "request_ms": request_ms, "median_request_ms": statistics.median(request_ms),
                      "decoded_frames_request_ms": list_ms, "boxes_per_image": counts[-1],
                      "conf_0.001_boxes": sum(_counts(plain)),
                      "classes_1_boxes": sum(_counts(one_class)),
                      "agnostic_boxes": sum(_counts(agnostic))},
          "cli": {"rc": cli.returncode, "counts": cli_counts},
          "profile": {"request": request_profile,
                      "resumed_epoch": {"steps": per_epoch, "val_batches": 1, **epoch_profile}},
          "checkpoint_bytes": ckpt_bytes, "launches": launches, "gate": gate,
          "wall_s": {**wall, "phase": time.perf_counter() - t_start},
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM, "card": card})
    return launches


def phase_converge(card):
    """yolov8n (nc=3) from random init on the shapes set (32 train, 16 val
    images at 160 px) through the facade for 60 epochs: the convergence run
    of record, gated at best val mAP50 >= 0.8 and best fitness > 0.2."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.fixtures import make_shapes_dataset

    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        data = make_shapes_dataset(Path(tmp) / "shapes", n_train=32, n_val=16,
                                   imgsz=CONVERGE["imgsz"], seed=0, max_objects=3)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = YOLO(V8[0], nc=NC).train(data, project=str(Path(tmp) / "runs"), name="conv",
                                       **CONVERGE)
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    hist = out["history"]
    map50 = [h["val_mAP50"] for h in hist]
    best = int(np.argmax(map50))
    first = next((h["epoch"] for h in hist if h["val_mAP50"] >= 0.8), None)
    emit({"phase": "converge", "model": V8[0][:-5], "nc": NC, "args": CONVERGE,
          "epochs_run": len(hist), "first_epoch_at_0.8": first, "best_mAP50": map50[best],
          "best_epoch": hist[best]["epoch"], "best_fitness": out["best_fitness"],
          "seconds_per_epoch": statistics.median(h["seconds"] for h in hist), "wall_s": wall,
          "mAP50_by_epoch": map50, "mAP50-95_by_epoch": [h["val_mAP50-95"] for h in hist],
          "loss_by_epoch": [h["loss"] for h in hist], "launches": launches,
          "jax_record": {"first_epoch_at_0.8": 19, "best_mAP50": 0.9514, "best_epoch": 44,
                         "source": "runs/convergence_r5/results.csv"},
          "tf32_conv": torch.backends.cudnn.allow_tf32, "card": card})
    require(map50[best] >= 0.8 and out["best_fitness"] > 0.2,
            f"no convergence: best val mAP50 {map50[best]} (epoch {hist[best]['epoch']}), "
            f"best fitness {out['best_fitness']}")
    require(launches == NO_LAUNCH, f"a hand kernel ran on yolov8n: {launches}")
    return launches


# the other six configs of the family at scale s and 320: {name: the
# kernels a forward launches and a train step launches}
FAMILY_IMGSZ, FAMILY_TRAIN_B = 320, 4
FAMILY = {
    "yolov13s_edit9.yaml": ({"letterbox_normalize": 1, "sample_bilinear": 3},
                            {"sample_bilinear": 3, "sample_bilinear_backward": 3}),
    "yolov13s_edit10.yaml": ({"letterbox_normalize": 1}, {}),
    "yolov13s_v3edit5_attn.yaml": ({"letterbox_normalize": 1}, {}),
    "yolov13s_v3edit5_attn2.yaml": ({"letterbox_normalize": 1}, {}),
    "yolov13s_v3edit6.yaml": ({"letterbox_normalize": 1, "area_attention": 8},
                              {"area_attention": 8, "area_attention_backward_dq": 8,
                               "area_attention_backward_dkv": 8}),
    "yolov13s_edit_template.yaml": ({"letterbox_normalize": 1, "area_attention": 8},
                                    {"area_attention": 8, "area_attention_backward_dq": 8,
                                     "area_attention_backward_dkv": 8}),
}


def _sla_check(cpu_model, gpu_model, gen):
    """The first SLA module (P3) of a config, card against CPU (TF32 off) on
    its own input shape with random non-zero proj_l and out_proj (both zero
    at init, where the block is inert): the same key blocks picked on both
    devices (a near-tie between the k-th and (k+1)-th block scores could
    part them; the smallest gap, over the scores' scale, is printed), then
    the outputs within 1e-4 of their largest."""
    from yolo_dbl_tpu_torch.nn.attention.sla import SLA, block_mask

    name, cpu = next((n, m) for n, m in cpu_model.named_modules() if isinstance(m, SLA))
    gpu = gpu_model.get_submodule(name)
    c = cpu.out_proj.in_channels
    hw = FAMILY_IMGSZ // 8
    x = torch.randn((2, c, hw, hw), generator=gen)
    with torch.no_grad():
        for p in (cpu.out_proj.weight, cpu.proj_l.weight, cpu.proj_l.bias):
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
        gpu.load_state_dict(cpu.state_dict())
        with tf32_off():
            masks = []
            x_card = x.cuda().contiguous(memory_format=torch.channels_last)
            for mod, xd in ((cpu, x), (gpu, x_card)):
                qkv = mod.qkv_proj(xd).flatten(2).transpose(1, 2)
                q, k, _ = (t.reshape(2, hw * hw, mod.num_heads, mod.head_dim).transpose(1, 2)
                           for t in qkv.split(c, -1))
                mask, score = block_mask(q, k, mod.topk, mod.blkq, mod.blkk)
                masks.append(mask.cpu())
            want, got = cpu(x), gpu(x_card).cpu()
        topk = int(masks[0].sum(-1).max())
        top = score.cpu().topk(topk + 1, -1).values
        gap = float((top[..., topk - 1] - top[..., topk]).min() / top.abs().max())
    err = float((got - want).abs().max() / want.abs().max())
    out = {"module": name, "tokens": hw * hw, "key_blocks": score.shape[-1], "topk": topk,
           "same_key_blocks": torch.equal(*masks), "topk_gap_of_scale": gap,
           "max_rel_err": err, "max_abs_out": float(want.abs().max())}
    require(out["same_key_blocks"] and err <= 1e-4 and float(want.abs().max()) > 0,
            f"SLA card vs CPU with non-zero projections: {out}")
    return out


def _config_decode(name, cpu, gpu, frames, imgsz, per_forward):
    """({params, box_max_abs_px, score_max_abs, max_score, forward_launches},
    launches) of one config's decode of `frames` letterboxed to `imgsz` on
    the card against the CPU's (TF32 off; boxes 0.05 px, scores 1e-3), whose
    launches must be `per_forward`'s."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    if cpu.head_name == "RTDETRDecoder":
        row, near = rtdetr_card_vs_cpu(cpu, gpu, frames, imgsz)
        row["params"] = sum(p.numel() for p in gpu.parameters())
        fwd = row["forward_launches"]
        require(row["box_max_abs_px"] < 0.05 and row["score_max_abs"] <= 1e-3
                and row["classes_equal"] and near
                and fwd == _launches(per_forward, torch.float32), f"{name} card vs CPU: {row}")
        return row, fwd
    size = (imgsz, imgsz)
    kernels.reset_launches()
    with tf32_off():
        pred_c = cpu.predict(letterbox_normalize(frames, size))
        pred_g = gpu.predict(letterbox_normalize(frames.cuda(), size)).cpu()
    fwd = dict(kernels.launches)
    anchors = sum((imgsz // st) ** 2 for st in gpu.strides)
    require(pred_g.shape == pred_c.shape == (2, 4 + cpu.nc, anchors)
            and bool(torch.isfinite(pred_g).all()), f"{name}: predictions {pred_g.shape}")
    box, score = _boxes_scores(pred_g, pred_c)
    row = {"params": sum(p.numel() for p in gpu.parameters()), "box_max_abs_px": box,
           "score_max_abs": score, "max_score": float(pred_c[:, 4:].max()),
           "forward_launches": fwd}
    require(box < 0.05 and score <= 1e-3 and fwd == _launches(per_forward, torch.float32),
            f"{name} card vs CPU: {row}")
    return row, fwd


def _config_step(name, gpu, rng, imgsz, batch_size, per_step):
    """({step_ms, losses, step_launches}, launches) of one Trainer.step of
    `gpu` on a seeded batch (TF32 convolutions on, as in the timed phases):
    finite losses, and `per_step`'s launches."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = True
    trainer = Trainer(gpu, {"batch": batch_size}).setup(steps_per_epoch=100)
    batch = train_batches(rng, 1, b=batch_size, imgsz=imgsz, nc=gpu.nc, task=_task(gpu))[0]
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = {k: float(v) for k, v in trainer.step(batch).items()}
    torch.cuda.synchronize()
    row = {"step_ms": (time.perf_counter() - t0) * 1e3, "losses": losses,
           "step_launches": dict(kernels.launches)}
    require(all(np.isfinite(v) for v in losses.values())
            and row["step_launches"] == _launches(per_step, torch.float32),
            f"{name} train step: {row}")
    return row, row["step_launches"]


def phase_family(card):
    """The other six configs of the family at scale s and 320: the card's
    decode against the CPU's on 2 frames (TF32 off; boxes 0.05 px, scores
    1e-3), launches of a forward, and one train step at batch 4 each."""
    t_start = time.perf_counter()
    rng, gen = np.random.default_rng(8), torch.Generator().manual_seed(8)
    frames = torch.from_numpy(rng.integers(0, 256, (2, *SRC_HW, 3), dtype=np.uint8))
    out, launches = {}, {}
    for name, (per_forward, per_step) in FAMILY.items():
        cpu, gpu = build_models((name, NC))
        row, fwd = _config_decode(name, cpu, gpu, frames, FAMILY_IMGSZ, per_forward)
        if any(m.__class__.__name__ == "SLA" for m in cpu.modules()):
            row["sla"] = _sla_check(cpu, gpu, gen)
        step_row, step = _config_step(name, gpu, rng, FAMILY_IMGSZ, FAMILY_TRAIN_B, per_step)
        row.update(step_row)
        launches[name] = {k: fwd[k] + step[k] for k in fwd}
        out[name[:-5]] = row
        del cpu, gpu
    emit({"phase": "family", "imgsz": FAMILY_IMGSZ, "nc": NC, "frames": 2,
          "train_batch": FAMILY_TRAIN_B, "configs": out, "tf32_parity": False,
          "seconds": time.perf_counter() - t_start, "card": card})
    return launches


# the stock detect families' other 15 configs (scale n where the YAML has
# scales), at nc=80 and 320: {name: the kernels a forward launches and a
# train step launches}. yolov3_edit3's two A2C2f rows (no scales: 4 repeats,
# 8 and 16 heads) take K3 16 times; the others K1 alone.
ZOO_IMGSZ, ZOO_TRAIN_B = 320, 4
ZOO = {name: ({"letterbox_normalize": 1}, {}) for name in (
    "yolov3.yaml", "yolov3_edit1.yaml", "yolov3_edit2.yaml", "yolov3n_edit5.yaml",
    "yolov3-tiny.yaml", "yolov3-spp.yaml", "yolov5n.yaml", "yolov5n-p6.yaml", "yolov6n.yaml",
    "yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov8n-ghost.yaml", "yolov8n-ghost-p2.yaml",
    "yolov8n-ghost-p6.yaml")}
ZOO["yolov3_edit3.yaml"] = ({"letterbox_normalize": 1, "area_attention": 16},
                            {"area_attention": 16, "area_attention_backward_dq": 16,
                             "area_attention_backward_dkv": 16})
# the v9 and v10 families' other 10 configs (yolov10.yaml at its first scale,
# n), at nc=80 and 320: K1 alone (no DySample, no area attention)
ZOO_V9V10 = {name: ({"letterbox_normalize": 1}, {}) for name in (
    "yolov9t.yaml", "yolov9m.yaml", "yolov9c.yaml", "yolov9e.yaml", "yolov10.yaml",
    "yolov10n.yaml", "yolov10m.yaml", "yolov10b.yaml", "yolov10l.yaml", "yolov10x.yaml")}
# the module pools' other four configs (yolov8-world at n; FFCA-YOLO at its
# default scale; FFCA-YOLO-L has none), at nc=80 and 320: K1 alone
ZOO_POOLS = {name: ({"letterbox_normalize": 1}, {}) for name in (
    "yolov8n-world.yaml", "FFCA-YOLO.yaml", "FFCA-YOLO-L.yaml", "yolo11n-C3k2_EFE-IRSTE.yaml")}
# RT-DETR's other three configs, at nc=80 and 320 (2,100 tokens for 300
# queries): K1 and K2 18 times a forward, K2 forward and backward 18 times a step
ZOO_RTDETR = {name: ({"letterbox_normalize": 1, "sample_bilinear": RTDETR_K2},
                     {"sample_bilinear": RTDETR_K2, "sample_bilinear_backward": RTDETR_K2})
              for name in ("rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml")}


def phase_zoo(card, zoo=ZOO, phase="zoo"):
    """A family's other configs at 320: the card's decode against the CPU's
    on 2 frames (TF32 off; boxes 0.05 px, scores 1e-3), launches of a
    forward and of one train step at batch 4 each, with finite losses.
    Detect class biases 0 (both v10Detect branches), as in `family`. The
    card's model is a copy of the CPU's: the YOLOv3 family's 48-114 M
    weights are drawn once."""
    t_start = time.perf_counter()
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.integers(0, 256, (2, *SRC_HW, 3), dtype=np.uint8))
    out, launches = {}, {}
    for name, (per_forward, per_step) in zoo.items():
        t0 = time.perf_counter()
        cpu = model_class(name)(name, nc=80, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        cpu.zero_class_biases()  # scores near 0.5, not the prior's ~1e-4 (a world head's ~5e-5)
        gpu = copy.deepcopy(cpu).to("cuda").to(memory_format=torch.channels_last)
        row, fwd = _config_decode(name, cpu, gpu, frames, ZOO_IMGSZ, per_forward)
        row.update(strides=list(gpu.strides),
                   activation=cpu.yaml.get("activation", "nn.SiLU() (default)"))
        step_row, step = _config_step(name, gpu, rng, ZOO_IMGSZ, ZOO_TRAIN_B, per_step)
        row.update(step_row, seconds=time.perf_counter() - t0)
        launches[name] = {k: fwd[k] + step[k] for k in fwd}
        out[name[:-5]] = row
        del cpu, gpu
        torch.cuda.empty_cache()
    emit({"phase": phase, "imgsz": ZOO_IMGSZ, "nc": 80, "frames": 2, "train_batch": ZOO_TRAIN_B,
          "configs": out, "tf32_parity": False, "seconds": time.perf_counter() - t_start,
          "card": card})
    return launches


def _mask_parts(pred, frames):
    """CUDA-event ms of one Segment request's masks: `frame_masks` of every
    kept row (prototype resolution, two bilinear resizes, > 0.5) and the
    copy of the bool masks to the host, apart from the rest of the request
    (K1, forward, decode, NMS, the gathers)."""
    from yolo_dbl_tpu_torch.engine.predictor import frame_masks
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_geometry

    _, _, _, top, left = letterbox_geometry(*SRC_HW, IMGSZ, IMGSZ, scaleup=False)
    with torch.inference_mode():
        dets, num, kept, protos = pred.infer(torch.from_numpy(frames).cuda())
        counts = num.tolist()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        masks = [frame_masks(kept[i, :k], protos[i], dets[i, :k, :4], IMGSZ, (left, top), SRC_HW)
                 for i, k in enumerate(counts)]
        ev[1].record()
        host = [m.cpu() for m in masks]
        ev[2].record()
        torch.cuda.synchronize()
    return {"rows": sum(counts), "masks_ms": ev[0].elapsed_time(ev[1]),
            "masks_to_host_ms": ev[1].elapsed_time(ev[2]),
            "mask_bytes": sum(m.numel() for m in host)}


def _task_term_ms(model, train_cfg, batch, reps=5):
    """CUDA-event ms (median of `reps`) of the forward and backward of the
    model's task loss and of `detection_loss` alone, on one batch's
    train-mode outputs: their difference is what the mask term (Segment)
    or the keypoint terms (Pose) and their second TAL cost a step."""
    from yolo_dbl_tpu_torch.engine.trainer import task_loss
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize
    from yolo_dbl_tpu_torch.losses.detection import detection_loss

    b = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    was_training = model.training
    model.train()
    with torch.no_grad():
        outs = model(device_normalize(b["img"], model.dtype))
    model.train(was_training)
    outs = torch.utils._pytree.tree_map(lambda t: t.detach().requires_grad_(), outs)
    leaves = torch.utils._pytree.tree_leaves(outs)
    gains = dict(box_gain=train_cfg.box, cls_gain=train_cfg.cls, dfl_gain=train_cfg.dfl)

    def timed(fn):
        ms = []
        for i in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss = fn()
            torch.autograd.grad(loss, [t for t in leaves if t.requires_grad], allow_unused=True)
            ev[1].record()
            torch.cuda.synchronize()
            ms += [ev[0].elapsed_time(ev[1])] if i else []
        return statistics.median(ms)

    task_ms = timed(lambda: task_loss(model, train_cfg, outs, b)[0])
    det_ms = timed(lambda: detection_loss(outs[0], b, model.strides, model.nc, **gains)[0])
    return {"task_loss_ms": task_ms, "detection_loss_ms": det_ms,
            "task_term_ms": task_ms - det_ms}


def _match_rows(idx_a, dets_a, k_a, idx_b, dets_b, k_b):
    """Pairs (i, j) of an image's kept rows with the same anchor and class."""
    where = {(int(idx_b[j]), int(dets_b[j, 5])): j for j in range(k_b)}
    return [(i, where[key]) for i in range(k_a)
            if (key := (int(idx_a[i]), int(dets_a[i, 5]))) in where]


def _task_rows(model, og, oc, card, cpu, imgsz, hw):
    """A Segment or Pose model's outputs of the same frames on the card
    (moved to the host) and on the CPU, and each device's NMS of its own
    decode (dets, counts, anchor indices): on the rows both keep with one
    anchor and class, the mask probabilities (each side's coefficients and
    prototypes, cut to the CPU row's box on both: a box edge a float32
    rounding from a pixel edge moves that pixel in or out of the crop,
    which the IoU holds) and the frame-size masks' pooled IoU (the least
    over the frames), or the keypoints and their visibility."""
    from yolo_dbl_tpu_torch.engine.predictor import frame_masks
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_geometry
    from yolo_dbl_tpu_torch.nn.heads import (decode_keypoints, decode_masks, flatten_levels,
                                             gather_anchors)

    (dg, ng, ig), (dc, nc_, ic) = card, cpu
    seg = model.head_name == "Segment"
    if seg:
        cg, cc = (gather_anchors(flatten_levels(o[1]), i) for o, i in ((og, ig), (oc, ic)))
        _, _, _, top, left = letterbox_geometry(*hw, imgsz, imgsz, scaleup=False)
    else:
        kg, kc = (gather_anchors(decode_keypoints(o[0], o[1], model.strides,
                                                  model.detect.kpt_shape), i)
                  for o, i in ((og, ig), (oc, ic)))
    rows, prob_err, kpt_err, vis_err, ious = 0, 0.0, 0.0, 0.0, []
    for i in range(len(dg)):
        pairs = _match_rows(ig[i], dg[i], int(ng[i]), ic[i], dc[i], int(nc_[i]))
        if not pairs:
            continue
        a, b = (torch.tensor(x) for x in zip(*pairs))
        rows += len(pairs)
        if seg:
            pm = [decode_masks(k[i][r].float(), o[2][i].float(), dc[i, b, :4], (imgsz, imgsz))
                  for k, o, r in ((cg, og, a), (cc, oc, b))]
            prob_err = max(prob_err, float((pm[0] - pm[1]).abs().max()))
            fm = [frame_masks(k[i][r], o[2][i], d[i, r, :4], imgsz, (left, top), hw)
                  for k, o, d, r in ((cg, og, dg, a), (cc, oc, dc, b))]
            ious.append(_mask_iou(*fm))
        else:
            d = (kg[i][a] - kc[i][b]).abs()
            kpt_err = max(kpt_err, float(d[..., :2].max()))
            vis_err = max(vis_err, float(d[..., 2].max()))
    out = {"rows": rows}
    out.update({"mask_probability_max_abs": prob_err, "mask_iou_min": min(ious, default=0.0)}
               if seg else {"keypoint_max_abs_px": kpt_err, "visibility_max_abs": vis_err})
    return out


def _task_rows_ok(out):
    """`_task_rows`'s bars: some rows; mask probabilities 1e-3 and IoU >=
    0.99, or keypoints 0.05 px and visibility 1e-3."""
    if "mask_iou_min" in out:
        return out["rows"] > 0 and out["mask_probability_max_abs"] <= 1e-3 \
            and out["mask_iou_min"] >= 0.99
    return out["rows"] > 0 and out["keypoint_max_abs_px"] < 0.05 \
        and out["visibility_max_abs"] <= 1e-3


def phase_parity_task(cfg, cpu_model, gpu_model, frames):
    """A task model's card against CPU on 2 frames (TF32 off). Classify: the
    probabilities at 224 within 1e-4 (the logits within 1e-4 of their
    largest: at the seeded init the probabilities sit near 1/nc) and the
    same top-1 unless the CPU's top two are within 1e-4. Segment and Pose,
    in the facade gate's form:
    the decode at every anchor (0.05 px, 1e-3), the card's NMS on its decode
    equal to the CPU's NMS on it (rows, counts, anchor indices), and each
    frame's kept rows alike (counts, 0.05 px, 1e-3, classes) or parted at
    decisions `_nms_partings` names; the side outputs within 1e-4 of their
    largest (coefficients and prototypes, or keypoint maps); on the rows
    kept alike (the same anchor and class on both), the mask probabilities
    within 1e-3 (each side's coefficients and prototypes, cut to the CPU
    row's box on both: a box edge a float32 rounding from a pixel edge moves
    that pixel in or out of the crop, which the IoU bar holds) and the
    frame-size masks at pooled IoU >= 0.99, or the keypoints within 0.05 px
    and their visibility within 1e-3."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dbl_tpu_torch.ops.nms import non_max_suppression

    t_start = time.perf_counter()
    u8 = torch.from_numpy(frames)
    head = gpu_model.head_name
    with tf32_off():
        if head == "Classify":
            size = (CLS_IMGSZ, CLS_IMGSZ)
            with torch.inference_mode():
                logits_c = cpu_model(letterbox_normalize(u8, size))
                logits_g = gpu_model(letterbox_normalize(u8.cuda(), size)).cpu()
            want, got = logits_c.softmax(-1), logits_g.softmax(-1)
            err = float((got - want).abs().max())
            logit_rel = float((logits_g - logits_c).abs().max() / logits_c.abs().max())
            top2 = want.topk(2, -1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-4
            top1_equal = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
            emit({"phase": _phase("parity", cfg), "frames": 2, "imgsz": CLS_IMGSZ,
                  "prob_max_abs": err, "logit_max_abs_of_largest": logit_rel,
                  "top1_card": got.argmax(-1).tolist(),
                  "top1_cpu": want.argmax(-1).tolist(), "top1_clear": clear.tolist(),
                  "max_prob": float(want.max()), "seconds": time.perf_counter() - t_start})
            require(got.shape == (2, cfg[1]) and err <= 1e-4 and logit_rel <= 1e-4 and top1_equal,
                    f"classify card vs CPU: prob {err} (<= 1e-4), logits {logit_rel} of their "
                    f"largest (<= 1e-4), top-1 equal {top1_equal}")
            return
        oc, pred_c = _forward_decode(cpu_model, letterbox_normalize(u8, (IMGSZ, IMGSZ)))
        og, pred_card = _forward_decode(gpu_model, letterbox_normalize(u8.cuda(), (IMGSZ, IMGSZ)))
        og_c, pred_g = _to_cpu(og), pred_card.cpu()
        nms = functools.partial(non_max_suppression, conf_thres=0.25, iou_thres=0.45, max_det=300,
                                nc=cfg[1], return_idx=True)
        (dg, ng, ig), (dh, nh, ih), (dc, nc_, ic) = (
            _to_cpu(nms(p)) for p in (pred_card, pred_g, pred_c))
        if head == "Segment":
            side = {f"coefficients_{i}": (g, c) for i, (g, c) in enumerate(zip(og_c[1], oc[1]))}
            side["prototypes"] = (og_c[2], oc[2])
        else:
            side = {f"keypoints_{i}": (g, c) for i, (g, c) in enumerate(zip(og_c[1], oc[1]))}
        rows = _task_rows(gpu_model, og_c, oc, (dg, ng, ig), (dc, nc_, ic), IMGSZ, SRC_HW)
    box_err, score_err = _boxes_scores(pred_g, pred_c)
    side_rel = {k: float((g - c).abs().max() / c.abs().max()) for k, (g, c) in side.items()}
    nms_equal = torch.equal(dg, dh) and torch.equal(ng, nh) and torch.equal(ig, ih)
    frames_gate, named = _frames_alike([d[:int(k)] for d, k in zip(dg, ng)],
                                       [d[:int(k)] for d, k in zip(dc, nc_)],
                                       pred_g, pred_c, 0.25, 0.45)
    out = {"phase": _phase("parity", cfg), "frames": 2, "head": head, "box_max_abs_px": box_err,
           "score_max_abs": score_err, "side_max_abs_of_largest": side_rel,
           "nms_card_equals_cpu": nms_equal, "kept_card": ng.tolist(), "kept_cpu": nc_.tolist(),
           "kept_rows": frames_gate, "rows_kept_alike": rows,
           "seconds": time.perf_counter() - t_start}
    emit(out)
    require(box_err < 0.05 and score_err <= 1e-3 and nms_equal
            and max(side_rel.values()) <= 1e-4 and named,
            f"{head} card vs CPU: {out}")
    require(_task_rows_ok(rows), f"{head} outputs card vs CPU: {out}")


def phase_parity_obb(cfg, cpu_model, gpu_model, frames):
    """An OBB model's card against CPU on 2 frames of 1024x1024 at imgsz
    1024 (TF32 off), in the facade gate's form: the decode at every anchor
    (xywh 0.05 px, angle 1e-4, scores 1e-3) and the angle maps within 1e-4
    of their largest; the card's rotated NMS on its decode equal to the
    CPU's on it; and each frame's kept rows alike (counts, boxes 0.05 px,
    angles 1e-4, scores 1e-3, classes) or parted at decisions
    `_nms_partings_rotated` names."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize
    from yolo_dbl_tpu_torch.ops.nms import non_max_suppression_rotated

    t_start = time.perf_counter()
    u8, size = torch.from_numpy(frames), (OBB_IMGSZ, OBB_IMGSZ)
    with tf32_off():
        oc, pred_c = _forward_decode(cpu_model, letterbox_normalize(u8, size))
        og, pred_card = _forward_decode(gpu_model, letterbox_normalize(u8.cuda(), size))
        og_c, pred_g = _to_cpu(og), pred_card.cpu()
        nms = functools.partial(non_max_suppression_rotated, conf_thres=0.25, iou_thres=0.45,
                                max_det=300, nc=cfg[1])
        (dg, ng), (dh, nh), (dc, nc_) = (_to_cpu(nms(p)) for p in (pred_card, pred_g, pred_c))
    anchors = n_anchors(gpu_model, OBB_IMGSZ)
    require(pred_g.shape == pred_c.shape == (2, 4 + cfg[1] + 1, anchors)
            and bool(torch.isfinite(pred_g).all()),
            f"OBB decode: card {tuple(pred_g.shape)}, CPU {tuple(pred_c.shape)}")
    box_err = float((pred_g[:, :4] - pred_c[:, :4]).abs().max())
    angle_err = float((pred_g[:, -1] - pred_c[:, -1]).abs().max())
    score_err = float((pred_g[:, 4:-1] - pred_c[:, 4:-1]).abs().max())
    angle_rel = max(float((g - c).abs().max() / c.abs().max()) for g, c in zip(og_c[1], oc[1]))
    nms_equal = torch.equal(dg, dh) and torch.equal(ng, nh)
    frames_gate, named = _frames_alike([d[:int(k)] for d, k in zip(dg, ng)],
                                       [d[:int(k)] for d, k in zip(dc, nc_)],
                                       pred_g, pred_c, 0.25, 0.45)
    out = {"phase": _phase("parity", cfg), "frames": 2, "imgsz": OBB_IMGSZ, "head": "OBB",
           "box_max_abs_px": box_err, "angle_max_abs": angle_err, "score_max_abs": score_err,
           "angle_maps_max_abs_of_largest": angle_rel, "nms_card_equals_cpu": nms_equal,
           "kept_card": ng.tolist(), "kept_cpu": nc_.tolist(), "kept_rows": frames_gate,
           "seconds": time.perf_counter() - t_start}
    emit(out)
    require(box_err < 0.05 and angle_err <= 1e-4 and score_err <= 1e-3 and angle_rel <= 1e-4
            and nms_equal and sum(nc_.tolist()) > 0 and named, f"OBB card vs CPU: {out}")


# the task heads' other configs, at 320 (as zoo_v9v10): the configs' own nc
ZOO_TASKS = {"yolov8n-seg.yaml": 80, "yolov9c-seg.yaml": 80, "yolov9e-seg.yaml": 80,
             "yolov8n-pose.yaml": 1, "yolov8n-cls.yaml": 1000, "yolov8n-obb.yaml": 15,
             "yolo11n-cls-resnet18.yaml": 10, "yolov8-cls-resnet50.yaml": 1000,
             "yolov8-cls-resnet101.yaml": 1000}


def phase_zoo_tasks(card):
    """The task heads' other configs at 320: on 2 frames, the card's decode
    against the CPU's (TF32 off; 0.05 px, 1e-3, an OBB decode's angle 1e-4)
    and every task output (coefficients, prototypes, keypoint or angle maps)
    within 1e-4 of its largest, or a classifier's probabilities (yolov8n-cls
    and the three ResNet classifiers) within 1e-4; K1 once a forward; one
    train step at batch 4 with finite losses (not the classifiers: they do
    not train)."""
    from yolo_dbl_tpu_torch import ClassificationModel, DetectionModel, kernels
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    t_start = time.perf_counter()
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(rng.integers(0, 256, (2, *SRC_HW, 3), dtype=np.uint8))
    size = (ZOO_IMGSZ, ZOO_IMGSZ)
    out, launches = {}, {}
    for name, nc in ZOO_TASKS.items():
        t0 = time.perf_counter()
        cls = "-cls" in name
        cpu = (ClassificationModel if cls else DetectionModel)(
            name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
        cpu.zero_class_biases()
        gpu = copy.deepcopy(cpu).to("cuda").to(memory_format=torch.channels_last)
        kernels.reset_launches()
        with tf32_off():
            if cls:
                want = cpu.predict(letterbox_normalize(frames, size))
                got = gpu.predict(letterbox_normalize(frames.cuda(), size)).cpu()
                row = {"prob_max_abs": float((got - want).abs().max())}
                ok = row["prob_max_abs"] <= 1e-4
            else:
                oc, pc = _forward_decode(cpu, letterbox_normalize(frames, size))
                og, pg = _forward_decode(gpu, letterbox_normalize(frames.cuda(), size))
                og = _to_cpu(og)
                pg = pg.cpu()
                obb = gpu.head_name == "OBB"  # the angle is its decode's last row
                box, score = _boxes_scores(pg[:, :-1] if obb else pg, pc[:, :-1] if obb else pc)
                maps = [(g, c) for g, c in zip(torch.utils._pytree.tree_leaves(og[1:]),
                                               torch.utils._pytree.tree_leaves(oc[1:]))]
                side = max(float((g - c).abs().max() / c.abs().max()) for g, c in maps)
                row = {"box_max_abs_px": box, "score_max_abs": score,
                       "task_output_max_abs_of_largest": side, "task_maps": len(maps)}
                if obb:
                    row["angle_max_abs"] = float((pg[:, -1] - pc[:, -1]).abs().max())
                ok = box < 0.05 and score <= 1e-3 and side <= 1e-4 \
                    and row.get("angle_max_abs", 0.0) <= 1e-4
        fwd = dict(kernels.launches)
        row.update(params=sum(p.numel() for p in gpu.parameters()), head=gpu.head_name,
                   forward_launches=fwd)
        require(ok and fwd == _launches({"letterbox_normalize": 1}, torch.float32),
                f"{name} card vs CPU: {row}")
        step = dict(NO_LAUNCH)
        if not cls:
            step_row, step = _config_step(name, gpu, rng, ZOO_IMGSZ, ZOO_TRAIN_B, {})
            row.update(step_row)
        row["seconds"] = time.perf_counter() - t0
        launches[name] = {k: fwd[k] + step[k] for k in fwd}
        out[name[:-5]] = row
        del cpu, gpu
        torch.cuda.empty_cache()
    emit({"phase": "zoo_tasks", "imgsz": ZOO_IMGSZ, "frames": 2, "train_batch": ZOO_TRAIN_B,
          "configs": out, "tf32_parity": False, "seconds": time.perf_counter() - t_start,
          "card": card})
    return launches


# the facade's task cells: a task shapes set at 320 (8 train, 4 val), batch 4
FACADE_TASKS = (("segment", "yolo11n-seg.yaml"), ("pose", "yolo11n-pose.yaml"),
                ("obb", "yolov8n-obb.yaml"), ("world", "yolov8n-worldv2.yaml"))
FT_IMGSZ, FT_TRAIN, FT_VAL, FT_B = 320, 8, 4, 4


def _world_yolo(best, device=None):
    """YOLO(best) with the checkpoint's weights in a WorldModel (its seeded
    `txt_feats`) with the contrastive bias 0: the checkpoint alone reloads
    as a plain DetectionModel on the zero text, whose every score is
    sigmoid(bias), one value at every anchor (JAX's facade reloads it so)."""
    from yolo_dbl_tpu_torch import WorldModel
    from yolo_dbl_tpu_torch.engine.model import YOLO

    y = YOLO(best, device=device)
    world = WorldModel(y.model.yaml, nc=y.model.nc, device=device)
    world.load_state_dict(y.model.state_dict())
    world.zero_class_biases()
    y.model = world
    return y


def phase_facade_tasks(card):
    """yolo11n-seg, yolo11n-pose, yolov8n-obb and yolov8n-worldv2 (nc=2)
    through YOLO on the card: train 1 epoch (2 steps of 4 at 320), validate
    (box and mask, pose or rbox mAP), predict 8 uint8 512x768 frames from
    memory; gate: `_facade_gate` at 320 over 2 frames, with the masks or
    keypoints of the rows both devices keep (the OBB rows themselves
    rotated; the world checkpoint in `_world_yolo`)."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.fixtures import make_shapes_dataset, make_task_dataset

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    frames = list(np.random.default_rng(11).integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8))
    cells, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for task, name in FACADE_TASKS:
            wall = {}
            data = (make_shapes_dataset(tmp / task, n_train=FT_TRAIN, n_val=FT_VAL, imgsz=FT_IMGSZ)
                    if task == "world" else
                    make_task_dataset(tmp / task, task=task, n_train=FT_TRAIN, n_val=FT_VAL,
                                      imgsz=FT_IMGSZ))
            y = YOLO(name, nc=2)
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = y.train(data, epochs=1, batch=FT_B, imgsz=FT_IMGSZ, project=str(tmp / "runs"),
                          name=task, workers=0, plots=False, verbose=False)
            torch.cuda.synchronize()
            wall["train_epoch"] = time.perf_counter() - t0
            key = {"segment": "mask_", "pose": "pose_", "obb": "rbox_", "world": ""}[task]
            launches[f"facade_{task}_train"] = dict(kernels.launches)
            require(y.trainer.steps == FT_TRAIN // FT_B
                    and all(np.isfinite(v) for h in out["history"] for v in h.values())
                    and launches[f"facade_{task}_train"] == NO_LAUNCH,
                    f"{task} train: {out['history']}, {launches[f'facade_{task}_train']}")
            best = Path(out["run_dir"]) / "best.ckpt"
            yb = YOLO(best)
            t0 = time.perf_counter()
            metrics = yb.val(data, imgsz=FT_IMGSZ, batch=FT_B)
            wall["val"] = time.perf_counter() - t0
            require(metrics["images"] == FT_VAL and f"{key}mAP50-95" in metrics,
                    f"{task} val: {metrics}")
            yb.predict(frames, imgsz=FT_IMGSZ)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launches()
            request_ms = []
            for _ in range(FACADE_REQUESTS):
                t0 = time.perf_counter()
                res = yb.predict(frames, imgsz=FT_IMGSZ)
                request_ms.append((time.perf_counter() - t0) * 1e3)
            launches[f"facade_{task}_predict"] = dict(kernels.launches)
            extra = [{"segment": r.masks, "pose": r.keypoints, "obb": r.obb,
                      "world": r.boxes}[task] for r in res]
            require(launches[f"facade_{task}_predict"] == _launches(
                {"letterbox_normalize": FACADE_REQUESTS}, torch.float32) and len(res) == B
                and all(len(e) == len(r) for e, r in zip(extra, res)),
                f"{task} predict: {launches[f'facade_{task}_predict']}")
            gate = _facade_gate(best, frames[:2], imgsz=FT_IMGSZ,
                                load=_world_yolo if task == "world" else None)
            cells[task] = {"model": name[:-5], "train": {"steps": y.trainer.steps,
                                                         "history": out["history"]},
                           "val": {k: metrics[k] for k in (*METRIC_KEYS, f"{key}mAP50",
                                                           f"{key}mAP50-95", "images")},
                           "predict": {"request_ms": request_ms,
                                       "median_request_ms": statistics.median(request_ms),
                                       "boxes_per_image": _counts(res)},
                           "gate": gate, "wall_s": wall}
    emit({"phase": "facade_tasks", "nc": 2, "imgsz": FT_IMGSZ, "frames": B, "cells": cells,
          "launches": launches, "seconds": time.perf_counter() - t_start,
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM, "card": card})
    return launches


def phase_facade_dbl2(card):
    """YOLO-DBL2-l (nc=3, 640, float32) through the facade on the card:
    train 1 epoch (2 steps of 16), validate, predict 8 frames from memory;
    gate: the best checkpoint on the card and on the CPU over 2 frames."""
    import tempfile

    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.engine.model import YOLO

    from tests.fixtures import make_shapes_dataset

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # as in the timed float32 phases
    frames = list(np.random.default_rng(9).integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8))
    launches, wall = {}, {}
    per_epoch = FACADE_TRAIN // FACADE_B
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = make_shapes_dataset(tmp / "shapes", n_train=FACADE_TRAIN, n_val=FACADE_VAL,
                                   imgsz=IMGSZ)
        y = YOLO(DBL2[0], nc=NC)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = y.train(data, epochs=1, batch=FACADE_B, imgsz=IMGSZ, project=str(tmp / "runs"),
                      name="dbl2", workers=0, plots=False, verbose=False)
        torch.cuda.synchronize()
        wall["train_epoch"] = time.perf_counter() - t0
        launches["facade_dbl2_train"] = dict(kernels.launches)
        want = _launches({"sample_bilinear": 3 * (per_epoch + 1),
                          "sample_bilinear_backward": 3 * per_epoch}, torch.float32)
        require(launches["facade_dbl2_train"] == want and y.trainer.steps == per_epoch
                and all(np.isfinite(v) for h in out["history"] for v in h.values()),
                f"train: {out['history']}, launches {launches['facade_dbl2_train']}")
        best = Path(out["run_dir"]) / "best.ckpt"
        ckpt_bytes = {f.name: f.stat().st_size for f in sorted(best.parent.glob("*.ckpt"))}
        yb = YOLO(best)
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics = yb.val(data, imgsz=IMGSZ, batch=FACADE_B)
        torch.cuda.synchronize()
        wall["val"] = time.perf_counter() - t0
        launches["facade_dbl2_val"] = dict(kernels.launches)
        require(launches["facade_dbl2_val"] == _launches({"sample_bilinear": 3}, torch.float32)
                and metrics["images"] == FACADE_VAL, f"val: {metrics}")
        yb.predict(frames)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        request_ms = []
        for _ in range(FACADE_REQUESTS):
            t0 = time.perf_counter()
            res = yb.predict(frames)
            request_ms.append((time.perf_counter() - t0) * 1e3)
        launches["facade_dbl2_predict"] = dict(kernels.launches)
        require(launches["facade_dbl2_predict"] == {
            k: v * FACADE_REQUESTS for k, v in PER_REQUEST[DBL2, torch.float32].items()}
            and len(res) == B, f"predict: {launches['facade_dbl2_predict']}")
        gate = _facade_gate(best, frames[:2])
    emit({"phase": "facade_dbl2", "model": DBL2[0][:-5], "nc": NC, "dtype": "float32",
          "imgsz": IMGSZ, "train": {"images": FACADE_TRAIN, "batch": FACADE_B,
                                    "steps": per_epoch, "history": out["history"]},
          "val": {"images": metrics["images"], **{k: metrics[k] for k in METRIC_KEYS},
                  "speed_ms_per_image": metrics["speed_ms_per_image"]},
          "predict": {"frames": B, "requests": FACADE_REQUESTS, "request_ms": request_ms,
                      "median_request_ms": statistics.median(request_ms),
                      "boxes_per_image": _counts(res)},
          "checkpoint_bytes": ckpt_bytes, "launches": launches, "gate": gate,
          "wall_s": {**wall, "phase": time.perf_counter() - t_start},
          "tf32_conv": torch.backends.cudnn.allow_tf32, "note": NOT_A_QUALITY_CLAIM, "card": card})
    return launches


DP_B, DP_STEPS = 16, 2


def _float64_reference(cpu, batch):
    """(get, memo): `get()` gives `_float64_grads`' gradients of `batch`,
    computed on the card on the first call only (the dp and tp checks ask
    for them only for a leaf that misses the float32 bar: on the CPU a
    batch of 16 at 640 in float64 takes minutes); memo["seconds"] is what
    they took."""
    memo = {}

    def get():
        if "grads" not in memo:
            from yolo_dbl_tpu_torch.cfg import get_cfg

            t0 = time.perf_counter()
            memo["grads"] = _float64_grads(cpu, get_cfg(), batch, device="cuda")[1]
            torch.cuda.empty_cache()
            memo["seconds"] = time.perf_counter() - t0
        return memo["grads"]

    return get, memo


def phase_dp(card):
    """Data-parallel training of YOLO-DBL-s (nc=3, 640, global batch 16, 2
    steps) through `Trainer(mesh=...)` against the one-process Trainer on the
    same weights and batches, TF32 off on both: (a) NCCL at world 1 in this
    process; (b) Gloo at world 2, two processes on this one card, 8 rows
    each (NCCL refuses two ranks on one card: "Duplicate GPU detected",
    tried and printed here); (c) (b) in bfloat16. Bars: loss items 1e-4
    relative; the first step's gradient 1e-3 of each leaf's largest (a leaf
    that misses it by float32 order: both runs against the float64
    gradient, as train_parity); BatchNorm statistics after the steps 1e-4;
    the parameters bit for bit equal on the ranks; bfloat16: loss items and
    the K2-fed leaves within 4x the one-process bfloat16 step's distance from
    the float32 one. K2's forward and backward launch 3 times a step on
    every rank. Per rank: step ms, the gradient all-reduce's ms a step (CUDA
    events) and the device-busy share of one more step."""
    import tempfile

    import torch.distributed as dist

    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.parallel import distributed_init, make_mesh

    from tests.torch_ranks import (all_reduce_rank, card_steps, check_dp_bf16, check_dp_float32,
                                   dp_card_rank, launch)

    t_start = time.perf_counter()
    name, nc = DBL
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod in cpu.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0  # as card_steps sets it on the card's models
    batches = train_batches(np.random.default_rng(5), DP_STEPS, b=DP_B)
    fed, n_fed = KERNEL_FED_LEAVES[DBL]
    per_step = {dt: {k: v * DP_STEPS for k, v in PER_STEP[DBL, dt].items() if v}
                for dt in (torch.float32, BF16)}
    float64, f64 = _float64_reference(cpu, batches[0])

    def on_card(dtype):
        model = DetectionModel(name, nc=nc, device="cuda", dtype=dtype)
        model.load_state_dict(cpu.state_dict())
        return model

    with tempfile.TemporaryDirectory() as tmp, tf32_off():
        state_path = str(Path(tmp) / "state.pt")
        torch.save(cpu.state_dict(), state_path)
        one = card_steps(on_card(torch.float32), batches, profile=True)
        one16 = card_steps(on_card(BF16), batches[:1])
        torch.cuda.empty_cache()
        # (a) NCCL at world 1: the group, cross-rank BatchNorm and the bucket all-reduce
        distributed_init(f"file://{Path(tmp) / 'nccl_store'}", 1, 0, "nccl")
        try:
            nccl = dp_card_rank(make_mesh(), name, nc, ["float32"], state_path, batches,
                                True)["float32"]
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        nccl_two_ranks = None  # NCCL's refusal of two ranks on one card, which (b) works around
        try:
            launch(all_reduce_rank, 2, devices="cuda:0", backend="nccl", timeout=120, workdir=tmp)
        except (RuntimeError, TimeoutError) as err:
            lines = str(err).splitlines()
            nccl_two_ranks = next((ln.strip() for ln in lines if "Duplicate GPU" in ln),
                                  lines[-1] if lines else repr(err))
        require(nccl_two_ranks is not None, "NCCL ran two ranks on one card: (b) could use it")
        # (b), (c): Gloo at world 2 on this card
        ranks = launch(dp_card_rank, 2, name, nc, ["float32", "bfloat16"], state_path, batches,
                       True, devices="cuda:0", backend="gloo", timeout=900, workdir=tmp)
    f32 = {"nccl_world1": check_dp_float32(one, [nccl], float64),
           "gloo_world2": check_dp_float32(one, [r["float32"] for r in ranks], float64)}
    bf16 = check_dp_bf16(one, one16, ranks[0]["bfloat16"], fed, n_fed)
    sums16 = {r["bfloat16"]["checksum"] for r in ranks}
    runs = {"one_process": one, "nccl_world1": nccl,
            **{f"gloo_rank{i}": r["float32"] for i, r in enumerate(ranks)},
            **{f"gloo_bf16_rank{i}": r["bfloat16"] for i, r in enumerate(ranks)}}

    def timing(r):
        return {"step_ms": r["step_ms"], "median_ms": statistics.median(r["step_ms"][1:]),
                "allreduce_ms": r["allreduce_ms"], "device_ms": r["device_ms"],
                "profiled_step_ms": r["profiled_step_ms"],
                "device_busy_share": r["device_busy_share"], "top_host_ms": r["top_host_ms"]}

    launches = {k: r["launches"] for k, r in runs.items() if k != "one_process"}
    emit({"phase": "dp", "model": name[:-5], "nc": nc, "imgsz": IMGSZ, "global_batch": DP_B,
          "steps": DP_STEPS, "world": {"nccl": 1, "gloo": 2}, "tf32": False,
          "nccl_two_ranks_one_card": nccl_two_ranks,
          "float32": {k: v[0] for k, v in f32.items()}, "bfloat16": bf16[0],
          "bf16_param_checksums_equal": len(sums16) == 1, "launches": launches,
          "timing": {k: timing(r) for k, r in runs.items() if "device_ms" in r},
          "float64_seconds": f64.get("seconds"), "wall_s": time.perf_counter() - t_start,
          "card": card})
    for k, (_, failures) in f32.items():
        require(not failures, f"dp {k} against the one-process step: {failures}")
    require(not bf16[1], f"dp bf16 against the one-process bf16 step: {bf16[1]}")
    require(len(sums16) == 1, f"dp bf16: the ranks' parameters differ: {sums16}")
    for k, got in launches.items():
        want = per_step[BF16 if "bf16" in k else torch.float32]
        require(got == want, f"dp {k}: launches {got}, expected {want} in {DP_STEPS} steps")
    return launches


TP_B, TP_STEPS, TP_REQUESTS = 8, 2, 1


def _parallel_models(tmp):
    """The tp and sp phases' YOLO-DBL-s (nc=3, seeded, dropout off) saved to
    `tmp` for training and, with main's serving settings (`build_models`:
    FullPAD gates 0.5, Detect class biases 0, so that NMS keeps boxes), for
    serving; its global batches, 8 u8 frames, and the one-process card
    decode of their K1 batch in float32 and bfloat16 (TF32 off)."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    name, nc = DBL
    cpu = DetectionModel(name, nc=nc, device="cpu", generator=torch.Generator().manual_seed(0))
    for mod in cpu.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    state_path = str(Path(tmp) / "parallel_state.pt")
    torch.save(cpu.state_dict(), state_path)
    serve_path = str(Path(tmp) / "parallel_serve_state.pt")
    serve_state = build_models(DBL)[0].state_dict()
    torch.save(serve_state, serve_path)
    frames = np.random.default_rng(8).integers(0, 256, (B, *SRC_HW, 3), dtype=np.uint8)
    refs, kept = {}, {}
    with tf32_off(), torch.no_grad():
        for dtype in (torch.float32, BF16):
            model = DetectionModel(name, nc=nc, device="cuda", dtype=dtype).eval()
            model.load_state_dict(serve_state)
            u8 = torch.from_numpy(frames).cuda()
            refs[dtype] = model.predict(letterbox_normalize(u8, (IMGSZ, IMGSZ),
                                                            out_dtype=dtype)).float().cpu()
            kept[dtype] = [len(o) for o in DetectionPredictor(
                model, conf=0.25, iou=0.45, max_det=300, imgsz=IMGSZ)(frames)]
            del model
    torch.cuda.empty_cache()
    return dict(cpu=cpu, state_path=state_path, serve_path=serve_path, frames=frames, refs=refs,
                kept=kept,
                batches=train_batches(np.random.default_rng(7), TP_STEPS, b=TP_B))


def _serve_checks(tag, res, setup, dtype, requests, launches_per_request):
    """The serving bars of a rank's `_serve` result against the one-process
    float32 decode: float32 boxes < 0.05 px, scores <= 1e-3 and the boxes
    NMS keeps per image; bfloat16 at parity_bf16's bars (boxes 0.02 of
    imgsz, scores 0.05); the launches."""
    ref32 = setup["refs"][torch.float32]
    want_kept = setup["kept"][dtype]
    require(sum(res["kept"]) > 0, f"{tag}: no detections: NMS saw no candidates")
    if dtype == torch.float32:
        require(res["kept"] == want_kept, f"{tag}: kept {res['kept']}, one process {want_kept}")
    if res["decode"] is not None:
        box, score = _boxes_scores(res["decode"], ref32)
        res["box_max_abs_px"], res["score_max_abs"] = box, score
        bars = (0.05, 1e-3) if dtype == torch.float32 else (0.02 * IMGSZ, 0.05)
        require(res["decode"].shape == ref32.shape and bool(torch.isfinite(res["decode"]).all()),
                f"{tag}: decode {tuple(res['decode'].shape)}, one process {tuple(ref32.shape)}")
        require(box < bars[0] and score <= bars[1],
                f"{tag}: boxes {box} px (< {bars[0]}), scores {score} (<= {bars[1]}) "
                "against the one-process float32 decode")
        res["decode"] = None
    want = {k: v * requests for k, v in launches_per_request.items() if v}
    require(res["launches"] == want, f"{tag}: launches {res['launches']}, expected {want}")


def _model_bytes_share(cpu, n_model):
    """The share of the parameter bytes a rank holds under the specs at
    n_model: the replicated leaves whole, the sharded ones 1 / n_model."""
    from yolo_dbl_tpu_torch.parallel import Mesh, model_parallel_shardings

    specs = model_parallel_shardings(cpu, Mesh(0, n_model, torch.device("cpu"), n_model=n_model))
    whole = {n: p.numel() * p.element_size() for n, p in cpu.named_parameters()}
    return sum(b / (n_model if specs[n] else 1) for n, b in whole.items()) / sum(whole.values())


def phase_tp(card, tmp, setup):
    """Tensor parallelism of YOLO-DBL-s (nc=3, 640) over Gloo ranks on this
    one card (NCCL refuses two ranks on one card): (a) a 1x2 mesh (2
    processes) and (b) a 2x2 mesh (4 processes) train 2 steps at global
    batch 8, float32 with TF32 off, against the one-process Trainer on the
    same weights and batches at the dp phase's bars (`check_dp_float32`);
    (a) then serves a request of 8 u8 frames in float32 and bfloat16
    through a model `shard_variables` sharded (K1, the forward, decode,
    NMS): its decode against the one-process float32 decode at the parity
    bars (bfloat16: parity_bf16's). K2 forward and backward launch 3 times
    a step on every rank, K1 once and K2 3 times a request. Printed: each
    rank's bytes of parameters, EMA and moments against the one-process
    bytes, the collectives a step by kind and bytes with and without the
    column -> row pairing, step and request ms and device-busy shares."""
    from tests.torch_ranks import (card_steps, check_dp_float32, launch, tp_card_rank,
                                   tp_sp_card_rank)

    t_start = time.perf_counter()
    name, nc = DBL
    cpu, batches, frames = setup["cpu"], setup["batches"], setup["frames"]
    float64, f64 = _float64_reference(cpu, batches[0])

    from yolo_dbl_tpu_torch import DetectionModel

    with tf32_off():
        model = DetectionModel(name, nc=nc, device="cuda")
        model.load_state_dict(cpu.state_dict())
        one = card_steps(model, batches, profile=True)
        del model
        torch.cuda.empty_cache()
        tp_args = (name, nc, setup["state_path"], batches, frames, IMGSZ, TP_REQUESTS)
        kw = dict(devices="cuda:0", backend="gloo", timeout=900, workdir=tmp, n_model=2)
        # the 1x2 processes then run the sp phase's requests (`phase_sp` checks them)
        both = launch(tp_sp_card_rank, 2, (*tp_args, True, setup["serve_path"]),
                      (name, nc, setup["serve_path"], frames, IMGSZ, TP_REQUESTS), **kw)
        setup["sp_ranks"] = [r["sp"] for r in both]
        runs = {"1x2": [r["tp"] for r in both],
                "2x2": launch(tp_card_rank, 4, *tp_args, False, setup["serve_path"], **kw)}
    checks = {k: check_dp_float32(one, [r["train"] for r in ranks], float64, n_model=2)
              for k, ranks in runs.items()}
    share = _model_bytes_share(cpu, 2)
    per_step = {k: v * TP_STEPS for k, v in PER_STEP[DBL, torch.float32].items() if v}
    launches, serving, memory, collectives, timing = {}, {}, {}, {}, {}
    for mesh_name, ranks in runs.items():
        for i, r in enumerate(ranks):
            tag = f"tp_{mesh_name}_rank{i}"
            t = r["train"]
            launches[f"{mesh_name}_train_rank{i}"] = t["launches"]
            require(t["launches"] == per_step,
                    f"{tag}: train launches {t['launches']}, expected {per_step} in {TP_STEPS} steps")
            memory[tag] = {"local_bytes": t["local_bytes"], "whole_bytes": t["whole_bytes"],
                           "share": t["local_bytes"] / t["whole_bytes"]}
            require(abs(t["local_bytes"] / t["whole_bytes"] - share) < 1e-6,
                    f"{tag}: holds {t['local_bytes'] / t['whole_bytes']} of the bytes, the specs "
                    f"give {share}")
            timing[tag] = {"step_ms": t["step_ms"], "median_ms": statistics.median(t["step_ms"][1:]),
                           "allreduce_ms": t["allreduce_ms"], "device_ms": t["device_ms"],
                           "profiled_step_ms": t["profiled_step_ms"],
                           "device_busy_share": t["device_busy_share"]}
            if i == 0:
                collectives[mesh_name] = {
                    "paired_per_step": {k: [v[0] / TP_STEPS, v[1] / TP_STEPS]
                                        for k, v in t["collectives"].items()},
                    "unpaired_per_step": r["unpaired"], "pairs": len(t["pairs"]),
                    "sharded_leaves": t["sharded"]}
            for dt in ("float32", "bfloat16"):
                if dt not in r:
                    continue
                dtype = getattr(torch, dt)
                res = r[dt]
                _serve_checks(f"{tag} {dt}", res, setup, dtype, TP_REQUESTS, PER_REQUEST[DBL, dtype])
                if res.get("box_max_abs_px") is not None and dtype == BF16:
                    res["one_process_bf16_vs_f32"] = _boxes_scores(setup["refs"][BF16],
                                                                   setup["refs"][torch.float32])
                launches[f"{mesh_name}_serve_{dt}_rank{i}"] = res["launches"]
                serving[f"{tag}_{dt}"] = {k: v for k, v in res.items() if k not in ("decode", "launches")}
    emit({"phase": "tp", "model": name[:-5], "nc": nc, "imgsz": IMGSZ, "global_batch": TP_B,
          "steps": TP_STEPS, "requests": TP_REQUESTS, "backend": "gloo", "tf32": False,
          "meshes": {k: len(v) for k, v in runs.items()},
          "float32": {k: v[0] for k, v in checks.items()}, "bytes_share_of_specs": share,
          "memory": memory, "collectives": collectives, "serve": serving,
          "timing": {"one_process": {"step_ms": one["step_ms"],
                                     "median_ms": statistics.median(one["step_ms"][1:]),
                                     "device_ms": one["device_ms"],
                                     "device_busy_share": one["device_busy_share"]}, **timing},
          "launches": launches, "float64_seconds": f64.get("seconds"),
          "wall_s": time.perf_counter() - t_start, "card": card})
    for k, (_, failures) in checks.items():
        require(not failures, f"tp {k} against the one-process step: {failures}")
    return launches


def phase_sp(card, setup):
    """Spatial parallelism of YOLO-DBL-s (nc=3, 640, float32, TF32 off) over
    Gloo at world 2 on this one card (a 1x2 mesh, 320 image rows a rank):
    a request of 8 u8 frames through `spatial(model, mesh)` (K1 on the
    whole frames, the forward on row shards with halos, DySample and the
    hypergraph on gathered maps: K2 3 times a request on every rank); its
    decode against the one-process float32 decode at the parity bars. Prints
    the halo and gather bytes a request, request ms and device-busy share.
    The requests ran in `phase_tp`'s 1x2 processes, after tp's (`sp_ranks`
    of `setup`): this phase checks them."""
    t_start = time.perf_counter()
    name, nc = DBL
    ranks = setup["sp_ranks"]
    launches = {}
    for i, res in enumerate(ranks):
        _serve_checks(f"sp rank{i}", res, setup, torch.float32, TP_REQUESTS,
                      PER_REQUEST[DBL, torch.float32])
        launches[f"serve_rank{i}"] = res.pop("launches")
        res.pop("decode")
    emit({"phase": "sp", "model": name[:-5], "nc": nc, "imgsz": IMGSZ, "batch": B,
          "requests": TP_REQUESTS, "backend": "gloo", "world": 2, "mesh": "1x2", "tf32": False,
          "ranks": ranks, "launches": launches, "wall_s": time.perf_counter() - t_start,
          "card": card})
    return launches


@contextlib.contextmanager
def wrapped_sampler(wrap):
    """K2's call site (ops/resample.py `sample_bilinear`) inside the block
    calls wrap(inner, x, gy, gx, mode) instead, `inner` being the sampler
    bound there when the block starts."""
    from yolo_dbl_tpu_torch.ops import resample

    inner = resample.sample_bilinear
    resample.sample_bilinear = functools.partial(wrap, inner)
    try:
        yield
    finally:
        resample.sample_bilinear = inner


@contextlib.contextmanager
def recording_sampler(first=None):
    """The list of K2's calls inside the block, each (x, gy, gx, mode) with
    copies of its tensors: all of them, or the first `first`. Every call
    still samples."""
    calls = []

    def record(inner, x, gy, gx, mode):
        if first is None or len(calls) < first:
            calls.append((*(t.detach().clone() for t in (x, gy, gx)), mode))
        return inner(x, gy, gx, mode)

    with wrapped_sampler(record):
        yield calls


@contextlib.contextmanager
def pinned_cells(forced=None):
    """K2's taps inside the block, each held in a recorded cell: every call
    of the sampler (ops/resample.py `sample_bilinear`) records the cells
    (the floors of its pixel coordinates) on the CPU, in call order; with
    `forced` (such a record) a coordinate whose cell differs from the forced
    one moves the least amount into it, its gradient path kept, and the
    call records how many taps moved and the largest move. Bilinear
    sampling's coordinate gradient jumps where a tap crosses a pixel
    boundary. LDA_AQU's taps sit at up to ±26 px, and float32 places them
    0.4-3.7e-3 px from float64 on the CPU (the offset network's float32
    error times the ±11 px reach, not the rounding of one coordinate:
    `tools/exp_lda_conditioning.py`): a tap that close to a boundary lands
    on either side in two runs, and one such tap moves the offset
    network's gradient by percents (`train_parity_lda`)."""
    seen = []

    def pin(t, cell):
        lo = cell.to(t.device, t.dtype)
        target = torch.minimum(torch.maximum(t.detach(), lo), torch.nextafter(lo + 1, lo))
        # the value is `target` exactly (t - t is 0), the gradient t's
        return target + (t - t.detach()), (target != t.detach()), (target - t.detach()).abs()

    def sample(inner, x, gy, gx, mode):
        cells = (torch.floor(gy.detach()).cpu(), torch.floor(gx.detach()).cpu())
        moved, largest = 0, 0.0
        if forced is not None:
            fy, fx = forced[len(seen)][0]
            gy, my, dy = pin(gy, fy)
            gx, mx, dx = pin(gx, fx)
            moved, largest = int((my | mx).sum()), float(torch.maximum(dy.max(), dx.max()))
        seen.append((cells, moved, largest))
        return inner(x, gy, gx, mode)

    with wrapped_sampler(sample):
        yield seen


# ---------------------------------------------------------------- RT-DETR

@contextlib.contextmanager
def pinned_queries(forced=None):
    """Every RT-DETR decoder's query selection inside the block, recorded as
    (selected token indices (B, nq), every token's best encoder score (B, S))
    on the CPU, in call order; with `forced` ((B, nq)) the decoders take
    those tokens instead of their own (which are still recorded)."""
    from yolo_dbl_tpu_torch.models.rtdetr import RTDETRDecoder

    own, seen = RTDETRDecoder.select_queries, []

    def select(self, enc_scores):
        topi = own(self, enc_scores)
        seen.append((topi.cpu(), enc_scores.detach().amax(-1).float().cpu()))
        return topi if forced is None else forced.to(topi.device)

    RTDETRDecoder.select_queries = select
    try:
        yield seen
    finally:
        RTDETRDecoder.select_queries = own


@contextlib.contextmanager
def pinned_matching(forced=None):
    """Every RT-DETR Hungarian matching inside the block (losses/detr.py
    `assign`), recorded as (own query indices (N, M), the costs (N, Q, M))
    on the CPU; with `forced` the loss takes those indices instead."""
    from yolo_dbl_tpu_torch.losses import detr

    own, seen = detr.assign, []

    def assign(cost, counts):
        idx = own(cost, counts)
        seen.append((idx.cpu(), cost.float().cpu(), counts.long().cpu()))
        return idx if forced is None else forced.to(idx.device)

    detr.assign = assign
    try:
        yield seen
    finally:
        detr.assign = own


def _selection_partings(card, cpu, bar=1e-3):
    """Where two devices' top-k query selections part: each rank at which
    they hold different tokens (a swap of two near-equal scores, or a
    token at the k-th that only one side keeps), named with both tokens'
    best encoder scores on both devices. `card`, `cpu`: (selected (B, nq),
    best scores (B, S)). Returns (partings, whether the encoder's scores
    agree within `bar` (the score bar) and each parting is a near-tie: its two
    tokens' scores within 2e of each other on each device, e the largest
    score difference between the devices, since two tokens can change
    places only where their scores lie within e of each other)."""
    (sel_g, best_g), (sel_c, best_c) = card, cpu
    e = float((best_g - best_c).abs().max())
    out, near = [], e <= bar
    for i in range(sel_g.shape[0]):
        for rank in torch.nonzero(sel_g[i] != sel_c[i]).flatten().tolist():
            a, b = int(sel_g[i, rank]), int(sel_c[i, rank])
            sg, sc = [float(best_g[i, a]), float(best_g[i, b])], [float(best_c[i, a]),
                                                                   float(best_c[i, b])]
            out.append({"frame": i, "rank": rank, "token_card": a, "token_cpu": b,
                        "scores_card": sg, "scores_cpu": sc})
            near = near and abs(sg[0] - sg[1]) <= 2 * e and abs(sc[0] - sc[1]) <= 2 * e
    return out, near


def _rtdetr_rows_alike(card, cpu, imgsz):
    """The final decoder layer's rows of two decodes under one query
    selection, query by query: {box_max_abs_px (xyxy in pixels of the
    square `imgsz`), score_max_abs (sigmoid), classes_equal (each query's
    best class)}. `card`, `cpu`: (dec_bboxes, dec_scores) on the CPU."""
    from yolo_dbl_tpu_torch.ops.boxes import xywh2xyxy

    (bg, sg), (bc, sc) = ((b[:, -1].double(), torch.sigmoid(s[:, -1].double())) for b, s in (card, cpu))
    return {"box_max_abs_px": float((xywh2xyxy(bg) - xywh2xyxy(bc)).abs().max()) * imgsz,
            "score_max_abs": float((sg - sc).abs().max()),
            "classes_equal": bool(torch.equal(sg.argmax(-1), sc.argmax(-1)))}


def rtdetr_card_vs_cpu(cpu, gpu, u8, imgsz):
    """RT-DETR's decode of uint8 frames letterboxed to `imgsz` on the card
    against the CPU's (TF32 off), query by query: each device's own top-k
    selection, the tokens where they part (`_selection_partings`), and the
    final layer's rows under the CPU's selection (the card's forward again
    with it where they part: rows are compared query by query, and one
    different query changes every query's self-attention). Also `predict`'s (B, Q, 6) rows, finite and sorted.
    Returns ({box_max_abs_px, score_max_abs, classes_equal,
    selection_partings, ...}, whether every parting is a near-tie)."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    size = (imgsz, imgsz)
    with tf32_off(), torch.inference_mode():
        x_c = letterbox_normalize(u8, size)
        with pinned_queries() as sc:
            out_c = cpu(x_c)
        kernels.reset_launches()
        x_g = letterbox_normalize(u8.cuda(), size)
        with pinned_queries() as sg:
            out_g = gpu(x_g)
        launches = dict(kernels.launches)
        partings, near = _selection_partings(sg[0], sc[0])
        if partings:
            with pinned_queries(sc[0][0]):
                out_g = gpu(x_g)
        dets = gpu.decode_outputs(out_g, img_size=imgsz).cpu()
    out_g = [o.cpu() for o in out_g]
    require(all(bool(torch.isfinite(o).all()) for o in out_g) and dets.shape[-1] == 6
            and bool((dets[..., 4].diff(dim=1) <= 0).all()),
            f"RT-DETR decode: outputs {[tuple(o.shape) for o in out_g]}, rows {tuple(dets.shape)}")
    row = _rtdetr_rows_alike(out_g[:2], out_c[:2], imgsz)
    row.update(forward_launches=launches, queries=int(out_c[0].shape[2]),
               tokens=int(sc[0][1].shape[1]),
               selection_partings=partings, max_score=float(torch.sigmoid(out_c[1][:, -1]).max()),
               rows_above_conf=[int((d[:, 4] > 0.25).sum()) for d in dets])
    return row, near


def phase_parity_rtdetr(cfg, cpu_model, gpu_model, frames):
    """RT-DETR-l's decode of 2 frames on the card against the CPU (TF32 off):
    the final layer's rows, query by query, within 0.05 px and 1e-3 with
    equal classes, under one selection; where the two top-300s part, each
    parted token named with both devices' scores and k-th scores, and
    required to be such a near-tie."""
    t_start = time.perf_counter()
    row, near = rtdetr_card_vs_cpu(cpu_model, gpu_model, torch.from_numpy(frames), IMGSZ)
    emit({"phase": _phase("parity", cfg), "frames": 2, **row, "tf32": False,
          "seconds": time.perf_counter() - t_start})
    require(row["box_max_abs_px"] < 0.05 and row["score_max_abs"] <= 1e-3
            and row["classes_equal"] and near, f"RT-DETR card vs CPU: {row}")


def phase_parity_bf16_rtdetr(cfg, cpu32, cpu16, gpu16, frames):
    """The card's bfloat16 RT-DETR-l against the CPU's float32 at the same
    weights and frames, within check_amp's bars (boxes 0.02 of imgsz, scores
    0.05), query by query under the CPU float32's selection (bfloat16
    encoder scores tie and reorder the top-300: the share of the card's own
    selection that the float32 one holds is printed); card bfloat16 against
    CPU bfloat16 beside the CPU's own bfloat16-against-float32 spread."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    t_start = time.perf_counter()
    u8 = torch.from_numpy(frames)
    size = (IMGSZ, IMGSZ)
    with torch.inference_mode():
        with pinned_queries() as s32:
            out32 = cpu32(letterbox_normalize(u8, size))
        sel = s32[0][0]
        with pinned_queries(sel) as s16:
            outs = {"cpu16": cpu16(letterbox_normalize(u8, size, out_dtype=BF16)),
                    "card16": [o.cpu() for o in gpu16(letterbox_normalize(u8.cuda(), size,
                                                                           out_dtype=BF16))]}
    own16 = s16[1][0]
    kept = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(a)
                          for a, b in zip(own16, sel)]))
    require(all(bool(torch.isfinite(o.float()).all()) for o in outs["card16"])
            and outs["card16"][1].dtype == BF16, "bf16 RT-DETR outputs")
    pair = {k: _rtdetr_rows_alike(outs[a][:2], b[:2], IMGSZ) for k, a, b in (
        ("card_bf16_vs_cpu_f32", "card16", out32), ("card_bf16_vs_cpu_bf16", "card16",
                                                    outs["cpu16"]),
        ("cpu_bf16_vs_cpu_f32", "cpu16", out32))}
    box_bar, score_bar = 0.02 * IMGSZ, 0.05
    emit({"phase": _phase("parity", cfg, BF16), "frames": 2, **pair,
          "card_bf16_own_selection_share_in_f32": kept,
          "bars": {"box_px": box_bar, "score": score_bar},
          "seconds": time.perf_counter() - t_start})
    got = pair["card_bf16_vs_cpu_f32"]
    require(got["box_max_abs_px"] < box_bar and got["score_max_abs"] < score_bar,
            f"card bf16 vs CPU f32 (RT-DETR): {got}")


def _matching_partings(card, cpu):
    """The Hungarian matchings in which the card's own assignment differs
    from the CPU's, both solved on their own device's costs of the same
    queries. `card`, `cpu`: (indices (N, M), costs (N, Q, M), GT counts
    (N,)). Each is named with both assignments' total costs on the card's
    costs and the costs' largest difference d between the devices; it is a
    near-tie where the CPU's assignment costs at most 2 k d more than the
    card's optimum on the card's costs (k GTs), the most that costs moved
    by d can part two optima. Returns (partings, whether each is a
    near-tie)."""
    (idx, cost, counts), (forced, cost_cpu, _) = card, cpu
    out, near = [], True
    for n in range(idx.shape[0]):
        k = int(counts[n])
        a, b = idx[n, :k], forced[n, :k]
        if torch.equal(a, b):
            continue
        c = cost[n, :, :k].double()
        d = float((c - cost_cpu[n, :, :k].double()).abs().max())
        cols = torch.arange(k)
        ca, cb = float(c[a, cols].sum()), float(c[b, cols].sum())
        out.append({"matching": n, "gts": k, "own_cost": ca, "cpu_cost": cb,
                    "cost_max_abs_diff": d})
        near = near and cb - ca <= 2 * k * d
    return out, near


def _rtdetr_partings(card_queries, card_matchings, cpu_own):
    """({selection_partings, matchings, matchings_differing,
    matching_partings, held_under}, whether each is a near-tie) of the
    card's own query selection and matchings (`pinned_queries`' and
    `pinned_matching`'s records) against the CPU's; train-mode scores part
    by float32 order, so the score bar is 1e-3 of their largest."""
    bar = 1e-3 * float(cpu_own[0][1].abs().max())
    (sel, sel_near), (match, match_near) = (_selection_partings(card_queries, cpu_own[0], bar),
                                            _matching_partings(card_matchings, cpu_own[1]))
    return ({"selection_partings": sel, "matchings": int(cpu_own[1][0].shape[0]),
             "matchings_differing": len(match), "matching_partings": match,
             "held_under": "the CPU's selection and matchings"}, sel_near and match_near)


# RT-DETR-l's seeded train step is held at two levels. Its trunk's
# train-mode BatchNorms multiply a relative change of the input ~1e3-fold
# by P5 in float64 (in eval mode ~1-fold), and the ReLU and bilinear kinks
# behind them turn that into gradients that no float32 run reaches within
# 1e-3 of a leaf's largest: two CPU runs in 8 and 1 threads part from
# float64 by up to 13% and 23% of a leaf's largest at 256 px, and one
# leaf's distance on the card and on the CPU can differ 4-fold
# (tools/exp_rtdetr_conditioning.py). The whole step's leaves are held
# against float64 at half of their largest (a zeroed, sign-flipped or
# doubled gradient fails), its loss items and BatchNorm statistics at the
# bars of every model; the decoder alone, fed one float32 pyramid, at
# train_parity's rules (`phase_train_parity_decoder`)
RTDETR_LEAF_BAR = 0.5


def rtdetr_anchor_boxes(model):
    """Zero the final Dense of each box head of an RT-DETR model (the
    encoder's and each decoder layer's), as RT-DETR's published decoder
    initialization does: each layer's box starts as its query's anchor. The
    seeded final layers make the six layers' box refinement amplify
    float32's rounding ~4-fold a layer; the train parity phases start
    here."""
    dec = model.detect
    with torch.no_grad():
        for head in (dec.enc_bbox_head, *(getattr(dec, f"dec_bbox_head_{i}")
                                          for i in range(dec.ndl))):
            last = getattr(head, f"layers_{head.n - 1}")
            last.weight.zero_()
            last.bias.zero_()


def phase_train_parity_decoder(cfg, cpu_model, gpu_model):
    """RT-DETR's decoder and set loss alone, in train mode, fed one float32
    pyramid on every side (the CPU trunk's train-mode P3-P5 of
    train_parity's batch): the CPU (plain versions), the card (K2's forward
    and backward, TF32 off) and float64 on the card through `plain_kernels`,
    the card and float64 under the CPU's selection and matchings (the
    card's own recorded, each parting a named near-tie). Held at
    train_parity's rules: the loss items card against CPU within 1e-4
    relative; the last decoder layer's MSDeformAttn leaves
    (KERNEL_FED_LEAVES) card against CPU within 1e-3 of their largest; every
    decoder leaf and each level's input gradient against float64 within
    1e-3 of its largest |g64| or 4x the CPU's own distance (a ReLU or a
    bilinear tap at a kink that float32 puts on the other side moves a
    leaf up to ~1% of its largest on either device), plus 1e-10 of the
    largest of all."""
    from yolo_dbl_tpu_torch import kernels
    from yolo_dbl_tpu_torch.kernels.preprocess import device_normalize
    from yolo_dbl_tpu_torch.losses.detr import rtdetr_loss

    t_start = time.perf_counter()
    batch = train_batches(np.random.default_rng(2), 1, b=2, imgsz=256, nc=cfg[1])[0]
    trunk, pyramid = copy.deepcopy(cpu_model).train(), []
    hook = trunk.detect.register_forward_pre_hook(lambda mod, args: pyramid.extend(args[0]))
    with torch.no_grad():
        trunk(device_normalize(torch.from_numpy(batch["img"]), torch.float32))
    hook.remove()
    del trunk
    sides, pins, own, partings, launches = {}, (None, None), None, None, None
    for side, dec, dev, dt in (("cpu", cpu_model.detect, "cpu", torch.float32),
                               ("card", gpu_model.detect, "cuda", torch.float32),
                               ("float64", cpu_model.detect, "cuda", torch.float64)):
        dec = copy.deepcopy(dec).to(device=dev, dtype=dt).train()
        feats = [f.to(dev, dt).requires_grad_() for f in pyramid]
        targets = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        kernels.reset_launches()
        with tf32_off(), (plain_kernels() if dt == torch.float64 else contextlib.nullcontext()), \
                pinned_queries(pins[0]) as sq, pinned_matching(pins[1]) as sm:
            loss, items = rtdetr_loss(dec(feats), targets, cfg[1])
            names, params = zip(*dec.named_parameters())
            grads = torch.autograd.grad(loss, [*params, *feats], materialize_grads=True)
        if side == "cpu":
            pins, own = (sq[0][0], sm[0][0]), (sq[0], sm[0])
        elif side == "card":
            partings, launches = _rtdetr_partings(sq[0], sm[0], own), dict(kernels.launches)
        sides[side] = (dict(loss=float(loss.detach()),
                            **{k: float(v.detach()) for k, v in items._asdict().items()}),
                       dict(zip([*names, "P3", "P4", "P5"], (g.cpu() for g in grads))))
    (lc, gc), (lg, gg), (l64, g64) = sides["cpu"], sides["card"], sides["float64"]
    loss_rel = {k: abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc}
    fed, n_fed = KERNEL_FED_LEAVES[cfg]
    named = [n for n in gc if fed in "." + n]
    grad_rel = grads_rel(gg, gc, named)
    g_max = max(float(g.abs().max()) for g in g64.values())
    leaves = {}
    for n, ref in g64.items():
        card, cpu = (float((g[n].double() - ref).abs().max()) for g in (gg, gc))
        m = float(ref.abs().max())
        leaves[n] = dict(card_err=card, cpu_err=cpu, leaf_max=m,
                         tol=max(1e-3 * m, 4 * cpu) + 1e-10 * g_max)
    failing = {n: e for n, e in leaves.items() if e["card_err"] > e["tol"]}
    worst = sorted(leaves.items(), key=lambda kv: -kv[1]["card_err"] / max(kv[1]["leaf_max"], 1e-30))
    past = {side: sum(e[f"{side}_err"] > 1e-3 * e["leaf_max"] + 1e-10 * g_max
                      for e in leaves.values()) for side in ("card", "cpu")}
    extra, near = partings
    emit({"phase": _phase("train_parity_decoder", cfg), "batch": 2, "imgsz": 256,
          "losses_cpu": lc, "losses_card": lg, "losses_float64": l64, "loss_rel": loss_rel,
          "grad_rel_of_leaf_max": grad_rel, "model_max_abs_grad": g_max, "leaves": len(leaves),
          "zero_leaves": sum(e["leaf_max"] == 0 for e in leaves.values()),
          "leaves_past_1e-3_of_leaf_max": past["card"],
          "cpu_leaves_past_1e-3_of_leaf_max": past["cpu"],
          "worst_leaves_vs_float64": [dict(name=n, **e) for n, e in worst[:5]],
          "launches": launches, **extra, "seconds": time.perf_counter() - t_start})
    require(near, f"RT-DETR selection or matching, or an LDA_AQU tap's cell, parted away from "
            f"a near-tie: {extra}")
    require(launches == PER_STEP[cfg, torch.float32], f"launches in one decoder step: {launches}")
    require(max(loss_rel.values()) <= 1e-4, f"decoder loss items card vs CPU: {loss_rel}")
    require(len(named) == n_fed and max(grad_rel.values()) <= 1e-3,
            f"decoder gradients card vs CPU (of each leaf's max |g|): {grad_rel}")
    require(set(leaves) == set(gg) and not failing,
            f"decoder leaf gradients on the card vs float64 past their tolerance: {failing}")


def phase_facade_rtdetr(card, gpu_model):
    """The port's predictor, validator and YOLO.train/val/predict refuse
    RT-DETR on the card (ROADMAP Queue 3: JAX's run NMS over the decode's
    sorted rows); `DetectionModel.predict` serves it (the main_rtdetr
    phases)."""
    from yolo_dbl_tpu_torch import DetectionModel
    from yolo_dbl_tpu_torch.engine.model import YOLO
    from yolo_dbl_tpu_torch.engine.predictor import DetectionPredictor
    from yolo_dbl_tpu_torch.engine.validator import DetectionValidator

    init = DetectionModel.init_weights
    DetectionModel.init_weights = lambda self, generator: None  # a refusal needs no weights
    try:
        yolo = YOLO(RTDETR[0], nc=RTDETR[1], device="cuda")
    finally:
        DetectionModel.init_weights = init
    frame = np.zeros((*SRC_HW, 3), np.uint8)
    calls = {"DetectionPredictor": lambda: DetectionPredictor(gpu_model),
             "DetectionValidator": lambda: DetectionValidator(gpu_model),
             "YOLO.train": lambda: yolo.train("no-dataset", epochs=1),
             "YOLO.val": lambda: yolo.val("no-dataset"),
             "YOLO.predict": lambda: yolo.predict(frame)}
    refused = {}
    for name, fn in calls.items():
        try:
            fn()
            refused[name] = None
        except NotImplementedError as e:
            refused[name] = str(e)
    emit({"phase": "facade_rtdetr", "refused": refused, "device": str(yolo.model.device),
          "card": card})
    require(all(v and "ROADMAP Queue 3" in v for v in refused.values())
            and yolo.trainer is None, f"RT-DETR refusals: {refused}")


def rtdetr_sites(model, rng):
    """{batch: {level: (x, gy, gx)}}: the K2 inputs of the first decoder
    layer's MSDeformAttn (the projected value (B, H, W, 256), coordinates
    (B, 1200, 8) in pixels, points off the map among them) in one eval
    forward of the seeded RT-DETR-l on the card, on random uint8 frames at
    640, at serving batch 8 and training batch 16."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    out = {}
    for b in (B, TRAIN_B):
        frames = torch.from_numpy(rng.integers(0, 256, (b, *SRC_HW, 3), dtype=np.uint8))
        with recording_sampler(first=len(RTDETR_LEVELS)) as calls, torch.no_grad():
            model(letterbox_normalize(frames.cuda(), (IMGSZ, IMGSZ)))
        modes = {mode for *_, mode in calls}
        require(modes == {"zeros"}, f"MSDeformAttn samples with {modes}")
        out[b] = dict(zip(RTDETR_LEVELS, (call[:3] for call in calls)))
    return out


def _point_taps(x, gy, gx):
    """(off-map share: points none of whose 4 taps lands on the map, bytes
    of x the in-map taps need: each distinct pixel and group's C/G values
    once)."""
    b, h, w, c = x.shape
    g = gy.shape[-1]
    y0, x0 = torch.floor(gy).long(), torch.floor(gx).long()
    keys, hit = [], torch.zeros_like(y0, dtype=torch.bool)
    bi = torch.arange(b, device=x.device).view(b, 1, 1)
    gi = torch.arange(g, device=x.device).view(1, 1, g)
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            hit |= inb
            keys.append((((bi * h + yy) * w + xx) * g + gi)[inb])
    touched = int(torch.unique(torch.cat(keys)).numel())
    return float(1.0 - hit.float().mean()), touched * (c // g) * x.element_size()


def _grid_layout(xs, gy, gx, align_corners=False):
    """F.grid_sample's layout for point sites: (B*G, C/G, H, W) planes of
    each NHWC x and a (B*G, 1, N, 2) normalized grid, one a group (for
    `align_corners`, the corner pixels' centres at -1 and 1)."""
    b, h, w, c = xs[0].shape
    g = gy.shape[-1]
    planes = [x.reshape(b, h, w, g, c // g).permute(0, 3, 4, 1, 2).reshape(b * g, c // g, h, w)
              .contiguous() for x in xs]
    if align_corners:
        grid = torch.stack([gx * 2 / (w - 1) - 1, gy * 2 / (h - 1) - 1], -1)
    else:
        grid = torch.stack([(gx + 0.5) * 2 / w - 1, (gy + 0.5) * 2 / h - 1], -1)
    return planes, grid.permute(0, 2, 1, 3).reshape(b * g, 1, -1, 2).contiguous()


def deform_k2_sites(sites, mode="zeros", what="MSDeformAttn", align_corners=False):
    """The forward kernel against its plain version at point sites with
    their own coordinates (MSDeformAttn's three at serving batch 8, zeros
    padding; DAttention's, LDA_AQU's and DLUPack's, border): max error, the
    off-map share, times (kernel, plain, F.grid_sample with the same padding,
    and for DLUPack's align-corners grid with align_corners=True) and the
    bound on the bytes the in-map taps need (each touched pixel's group read
    once, the output written, the coordinates read); the whole map's bound
    and the output's bytes beside it."""
    from yolo_dbl_tpu_torch.kernels.sampling import sample_bilinear, sample_bilinear_plain

    rows, src = {}, []
    for level, (x, gy, gx) in sites.items():
        b, h, w, c = x.shape
        n, g = gy.shape[1:]
        xs = [x] + [x.clone() for _ in range(copies_for(x.numel() * 4) - 1)]
        got, want = sample_bilinear(x, gy, gx, mode), sample_bilinear_plain(x, gy, gx, mode)
        err = max_abs(got, want)
        require(err <= TOL, f"sampler kernel vs plain at {what} {level}: {err}")
        off, x_bytes = _point_taps(x, gy, gx)
        planes, grid = _grid_layout(xs, gy, gx, align_corners)

        def library(i):
            return F.grid_sample(planes[i % len(xs)], grid, mode="bilinear", padding_mode=mode,
                                 align_corners=align_corners)

        lib = library(0).reshape(b, g, c // g, n).permute(0, 3, 1, 2).reshape(b, n, c)
        k = len(xs)
        ms, _, s1 = timings(lambda i: sample_bilinear(xs[i % k], gy, gx, mode), 50)
        plain_ms, _, s2 = timings(lambda i: sample_bilinear_plain(xs[i % k], gy, gx, mode), 10)
        library_ms, _, s3 = timings(library, 50)
        src.append((s1, s2, s3))
        io = (b * n * c + 2 * b * n * g) * 4
        bound_ms, bound_by = bound(x_bytes + io, b * n * c * 11)
        rows[level] = dict(x=[b, h, w, c], n=n, groups=g, max_abs_err=err,
                           library_vs_kernel=max_abs(lib, got), off_map_share=off,
                           tapped_x_bytes=x_bytes, out_bytes=b * n * c * 4, ms=ms,
                           plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                           bound_ms_whole_map=bound(x.numel() * 4 + io, b * n * c * 11)[0])
    return rows, src


def deform_k2_backward_sites(sites, gen, mode="zeros", what="MSDeformAttn",
                             align_corners=False):
    """The backward kernel (and the forward) against the plain versions at
    point sites (MSDeformAttn's three at training batch 16, zeros padding;
    DAttention's, LDA_AQU's and DLUPack's, border), with their own
    coordinates and a random output
    gradient: errors, the share of taps that missed their tile's window,
    times (kernel, plain, F.grid_sample's backward with the same padding)
    and the bound: the in-map taps' bytes of x, g read, dx written whole,
    the coordinates read and their gradients written."""
    from yolo_dbl_tpu_torch.kernels.sampling import (backward_window_misses, sample_bilinear,
                                                     sample_bilinear_backward,
                                                     sample_bilinear_backward_plain,
                                                     sample_bilinear_plain)

    rows, src = {}, []
    for level, (x, gy, gx) in sites.items():
        b, h, w, c = x.shape
        n, g = gy.shape[1:]
        k = copies_for((x.numel() + b * n * c) * 4)
        xs = [x] + [x.clone() for _ in range(k - 1)]
        gs = [torch.randn((b, n, c), generator=gen).cuda() for _ in range(k)]
        fwd = max_abs(sample_bilinear(x, gy, gx, mode), sample_bilinear_plain(x, gy, gx, mode))
        got = sample_bilinear_backward(x, gy, gx, gs[0], mode)
        want = sample_bilinear_backward_plain(x, gy, gx, gs[0], mode)
        errs = {"dx": max_abs(got[0], want[0]), "forward": fwd}
        errs.update({f"{nm}_rel": max_abs(a, r) / float(r.abs().max())
                     for nm, a, r in zip(("dgy", "dgx"), got[1:], want[1:])})
        require(fwd <= TOL and errs["dx"] <= 1e-4 and errs["dgy_rel"] <= 1e-4
                and errs["dgx_rel"] <= 1e-4, f"sampler backward vs plain at {what} {level}: "
                f"{errs}")
        taps, miss = backward_window_misses(x, gy, gx, gs[0], mode)
        off, x_bytes = _point_taps(x, gy, gx)
        planes, grid = _grid_layout(xs, gy, gx, align_corners)
        planes = [p.requires_grad_() for p in planes]
        grid.requires_grad_()
        g_planes = [t.reshape(b, n, g, c // g).permute(0, 2, 3, 1).reshape(b * g, c // g, 1, n)
                    .contiguous() for t in gs]

        def library(i):
            out = F.grid_sample(planes[i % k], grid, mode="bilinear", padding_mode=mode,
                                align_corners=align_corners)
            return torch.autograd.grad(out, (planes[i % k], grid), g_planes[i % k])

        ms, _, s1 = timings(lambda i: sample_bilinear_backward(xs[i % k], gy, gx, gs[i % k],
                                                               mode), 30)
        plain_ms, _, s2 = timings(lambda i: sample_bilinear_backward_plain(
            xs[i % k], gy, gx, gs[i % k], mode), 5)
        library_ms, _, s3 = timings(library, 20, only="grid_sampler_2d_backward")
        src.append((s1, s2, s3))
        io = (b * n * c + x.numel() + 4 * b * n * g) * 4
        bound_ms, bound_by = bound(x_bytes + io, b * n * c * 24)
        rows[level] = dict(x=[b, h, w, c], n=n, groups=g, errors=errs, off_map_share=off,
                           window_missed_share=miss / taps, taps=taps, tapped_x_bytes=x_bytes,
                           grad_bytes=b * n * c * 4, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by,
                           bound_ms_whole_map=bound(x.numel() * 4 + io, b * n * c * 24)[0])
    return rows, src


def _rtdetr_row(rows):
    """A kernel row's summary of the MSDeformAttn sites: each site's numbers
    and, for a forward of RT-DETR-l, their sums times the 6 decoder layers
    (each layer samples the same shapes)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    return {"sites": rows, "per_forward": {k: RTDETR_LAYERS * sum(r[k] for r in rows.values())
                                           for k in keys},
            "bound_by": _by(rows.values())}



def _lda_row(rows, per):
    """A kernel row's summary of LDA-DBL-s's six sites: each site's numbers
    and their sums, a request's (forward) or a step's (backward) K2 work."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ms_whole_map")
    return {"sites": rows, per: {k: sum(r[k] for r in rows.values()) for k in keys},
            "bound_by": _by(rows.values())}


def lda_sites(model, rng):
    """{batch: {site: (x, gy, gx)}}: K2's six inputs in one eval forward of
    the seeded LDA-DBL-s on the card, on random uint8 frames at 640, at
    serving batch 8 and training batch 16: at rows 13, 18 and 22 the keys
    (`_k`, (B, h, w, C/4)) and the input (`_v`, (B, h, w, C)), both at the
    (B, 4hw·9, 2) pixel coordinates of the 2x map's 9 taps a query in 2
    groups, taps off the map among them (border padding)."""
    from yolo_dbl_tpu_torch.kernels.preprocess import letterbox_normalize

    out = {}
    names = [f"row{r}_{kv}" for r in LDA_ROWS for kv in ("k", "v")]
    for b in (B, TRAIN_B):
        frames = torch.from_numpy(rng.integers(0, 256, (b, *SRC_HW, 3), dtype=np.uint8))
        with recording_sampler() as calls, torch.no_grad():
            model(letterbox_normalize(frames.cuda(), (IMGSZ, IMGSZ)))
        require(len(calls) == len(names), f"LDA-DBL-s sampled {len(calls)} times a forward")
        modes = {mode for *_, mode in calls}
        require(modes == {"border"}, f"LDA_AQU samples with {modes}")
        out[b] = dict(zip(names, (call[:3] for call in calls)))
    return out


DLUPACK_SHAPE = (2, 64, 64, 64)  # NHWC input: the upsample catalogue's reference shape


def dlupack_module(c=DLUPACK_SHAPE[-1]):
    """DLUPack at `c` channels on the CPU, flax's defaults from seed 0 with
    its zero-initialized `conv_offset` redrawn (normal, 0.05; seed 1), so
    the kernel lookup samples between the lattice points."""
    from yolo_dbl_tpu_torch.nn.tasks import init_flax_defaults
    from yolo_dbl_tpu_torch.nn.upsample.loftup_dlu import DLUPack

    module = DLUPack(c)
    init_flax_defaults(module, torch.Generator().manual_seed(0))
    with torch.no_grad():
        module.conv_offset.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    return module.eval()


def dlupack_sites():
    """{site: (x, gy, gx)}: K2's input in DLUPack (`dlupack_module`) on the
    reference input: the softmaxed (2, 64, 64, 25) kernel field at the
    (2, 128·128, 1) align-corners pixel coordinates of the 2x lattice plus
    its offsets."""
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    module = on_card(dlupack_module())
    with recording_sampler() as calls, torch.no_grad():
        module(bm.reference_input(DLUPACK_SHAPE, "cuda"))
    require(len(calls) == 1, f"DLUPack sampled {len(calls)} times a call")
    return {"reference": calls[0][:3]}


# the module catalogue (utils/benchmarks.py): the shapes its entries are held
# card against CPU at, the bar, the timed calls, and the share of the card's
# memory an entry's score tensors may reckon at the reference shape
CATALOGUE_CHECK = {"upsample": (1, 16, 16, 64), "attention": (1, 32, 32, 64)}
CATALOGUE_BAR = 1e-4  # of the CPU output's largest |value|
CATALOGUE_CALLS, CATALOGUE_WARMUP = 10, 2
CATALOGUE_MEMORY_SHARE = 0.5
# K2's forward launches a call of each catalogue entry (every other entry: none)
CATALOGUE_K2 = {"DySample": 1, "DeBiAttention_YOLO": 1}


def catalogue_score_bytes(name, shape):
    """Bytes of the float32 attention score tensors catalogue entry `name`
    holds at once on an NHWC `shape` input, the port's as JAX writes them
    (the whole (heads, N, M) tensor): the scores and their softmax; for
    BoTAttention its q·k and q·position terms and their sum; for
    DeBiAttention_YOLO the larger of DAttention's (4 heads over the
    stride-2 grid's points) and BiFormer's dense masked scores (its input
    padded to 7x7 regions; the scores, the masked copy and the softmax).
    0 for an entry without a global score tensor."""
    b, h, w, _ = shape
    n, f32 = h * w, 4
    if name == "MHSA":  # 4 heads, N x N
        return 2 * b * 4 * n * n * f32
    if name == "BoTAttention":  # 4 heads: q·k, q·pos, their sum; then the softmax
        return 3 * b * 4 * n * n * f32
    if name == "HiLo":  # the 4 low-frequency heads over the 2x2-pooled keys
        return 2 * b * 4 * n * ((h // 2) * (w // 2)) * f32
    if name == "NonLocalBlock2D":  # one head over the 2x2 max-pooled keys
        return 2 * b * n * ((h // 2) * (w // 2)) * f32
    if name == "DeBiAttention_YOLO":
        points = -(-h // 2) * -(-w // 2)
        tokens = 49 * -(-h // 7) * -(-w // 7)
        return max(2 * b * 4 * n * points * f32, 3 * b * 4 * tokens * tokens * f32)
    return 0


def catalogue_plan(memory_bytes):
    """[(kind, name, shape, reckoned bytes)] for every catalogue entry, in
    the catalogue's order: the reference shape, or the quick one where the
    reckoning passes `CATALOGUE_MEMORY_SHARE` of `memory_bytes`. Decided
    before any entry runs."""
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    plan = [("upsample", name, bm.UPSAMPLE_SHAPE, 0) for name, _ in bm.upsample_catalogue()]
    for name, _ in bm.attention_catalogue():
        need = catalogue_score_bytes(name, bm.ATTENTION_SHAPE)
        shape = (bm.ATTENTION_QUICK_SHAPE if need > CATALOGUE_MEMORY_SHARE * memory_bytes
                 else bm.ATTENTION_SHAPE)
        plan.append(("attention", name, shape, need))
    return plan


def _catalogue_module(kind, name, shape, device):
    """Catalogue entry `name` built for an NHWC `shape` (BoTAttention's
    tables sized to it) with seed 0's weights on `device`."""
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    entries = bm.upsample_catalogue() if kind == "upsample" else bm.attention_catalogue(
        hw=shape[1:3])
    return bm.prepare(dict(entries)[name], device)


def _catalogue_out_shape(kind, name, shape):
    """The NHWC output shape of an entry: an upsampler doubles H and W
    (ResBlock_CBAM keeps them), an attention keeps its input's."""
    b, h, w, c = shape
    return (b, 2 * h, 2 * w, c) if kind == "upsample" and name != "ResBlock_CBAM" else shape


def phase_catalogue(card):
    """Every catalogue entry card against CPU at `CATALOGUE_CHECK`'s shape
    (TF32 off), then timed with CUDA events at `catalogue_plan`'s shape:
    ms a call, peak bytes above the input, K2's launches a call (the counts
    set to 0 before the entry's calls and read after them). No error is
    caught. For DySample and DeBiAttention_YOLO, one forward and backward
    then reads K2's launches in training. Returns {entry: its launches a
    call, entry_train: a forward and backward's} for the kernels line."""
    from yolo_dbl_tpu_torch.kernels import launches, reset_launches
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    total = torch.cuda.get_device_properties(0).total_memory
    plan = catalogue_plan(total)
    emit({"phase": "catalogue_plan", "memory_bytes": total, "share": CATALOGUE_MEMORY_SHARE,
          "entries": {name: {"shape": list(shape), "score_bytes_at_reference": need}
                      for _, name, shape, need in plan}})
    rows, counts = {}, {}
    for kind, name, shape, need in plan:
        small = CATALOGUE_CHECK[kind]
        cpu = _catalogue_module(kind, name, small, "cpu")
        gpu = copy.deepcopy(cpu).cuda().to(memory_format=torch.channels_last)
        x = bm.reference_input(small, "cpu")
        with torch.no_grad(), tf32_off():
            want = cpu(x).permute(0, 2, 3, 1)
            got = gpu(x.cuda()).permute(0, 2, 3, 1).cpu()
        err = max_abs(got, want) / float(want.abs().max())
        require(tuple(got.shape) == _catalogue_out_shape(kind, name, small)
                and bool(torch.isfinite(got).all()) and err <= CATALOGUE_BAR,
                f"catalogue {name}: card vs CPU at {small}: {err} of the largest, shape "
                f"{tuple(got.shape)}")
        del cpu, gpu
        module = _catalogue_module(kind, name, shape, "cuda")
        x = bm.reference_input(shape, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            for _ in range(CATALOGUE_WARMUP):
                out = module(x)
            start.record()
            for _ in range(CATALOGUE_CALLS):
                out = module(x)
            end.record()
        end.synchronize()
        calls = CATALOGUE_WARMUP + CATALOGUE_CALLS
        counts[name] = {k: v // calls for k, v in launches.items() if v}
        require(all(v % calls == 0 for v in launches.values())
                and counts[name].get("sample_bilinear", 0) == CATALOGUE_K2.get(name, 0),
                f"catalogue {name}: K2 launches {dict(launches)} over {calls} calls")
        out_shape = tuple(out.permute(0, 2, 3, 1).shape)
        require(out_shape == _catalogue_out_shape(kind, name, shape)
                and bool(torch.isfinite(out).all()), f"catalogue {name}: output {out_shape}")
        rows[name] = dict(kind=kind, shape=list(shape), out_shape=list(out_shape),
                          ms=start.elapsed_time(end) / CATALOGUE_CALLS,
                          peak_bytes=torch.cuda.max_memory_allocated() - base,
                          score_bytes=catalogue_score_bytes(name, shape),
                          score_bytes_at_reference=need, card_vs_cpu_rel=err,
                          launches_a_call=counts[name])
        if name in CATALOGUE_K2:  # a YAML row that trains: one backward through K2's
            reset_launches()
            module(x.requires_grad_()).square().sum().backward()
            torch.cuda.synchronize()
            counts[f"{name}_train"] = {k: v for k, v in launches.items() if v}
            require(counts[f"{name}_train"] == {"sample_bilinear": 1,
                                                "sample_bilinear_backward": 1},
                    f"catalogue {name}: a forward and backward launched {dict(launches)}")
            rows[name]["launches_a_train_call"] = counts[f"{name}_train"]
        del module, x, out
        torch.cuda.empty_cache()
    emit({"phase": "catalogue", "card": card, "calls": CATALOGUE_CALLS,
          "warmup": CATALOGUE_WARMUP, "check_shapes": CATALOGUE_CHECK, "bar": CATALOGUE_BAR,
          "entries": rows})
    return counts


# the pools' other modules (nn/upsample/{batch3,misc,pig,loftup_dlu}.py,
# nn/attention/{extra,bigarch,spatial}.py, GhostNetV2's blocks): each held card
# against CPU at batch 1 on a 16 px map and timed at batch 2 on a 64 px map
# (an ASFF's largest level; LoftUp's image, its low-res map a quarter the side)
POOLS_CHECK, POOLS_TIMED = (1, 16), (2, 64)
# K2's forward launches a call (every other entry: none)
POOLS_K2 = {"LDA_AQU": 2, "DLUPack": 1}


def _pool_entries():
    """{entry: (build() on the CPU, shapes(b, s): its NHWC inputs, whether
    the inputs go as one list)}."""
    from yolo_dbl_tpu_torch.nn.attention import bigarch as AB
    from yolo_dbl_tpu_torch.nn.attention import extra as AE
    from yolo_dbl_tpu_torch.nn.attention import spatial as AS
    from yolo_dbl_tpu_torch.nn.structures import blocks as S
    from yolo_dbl_tpu_torch.nn.upsample import batch3 as U3
    from yolo_dbl_tpu_torch.nn.upsample import loftup_dlu as UL
    from yolo_dbl_tpu_torch.nn.upsample import misc as UM
    from yolo_dbl_tpu_torch.nn.upsample import pig as UP

    def one(c=64):
        return lambda b, s: [(b, s, s, c)]

    def asff(cls, level):
        widths = [cls.DIMS[i] if i == level else 64 for i in range(3)]
        shapes = lambda b, s: [(b, s // 4, s // 4, widths[0]), (b, s // 2, s // 2, widths[1]),
                               (b, s, s, widths[2])]
        return (lambda: cls(level, ch=widths), shapes, True)

    return {
        "LDA_AQU": (lambda: U3.LDA_AQU(64), one(), False),
        "CARAFEplusplus_up": (lambda: U3.CARAFEplusplus(64), one(), False),
        "CARAFEplusplus_down": (lambda: U3.CARAFEplusplus(64, 2, "down"), one(), False),
        "CAA": (lambda: UM.CAA(64), one(), False),
        "WTConv2d": (lambda: UP.WTConv2d(64), one(), False),
        "C2f_PIG_n1": (lambda: UP.C2f_PIG(64, 64, 1, True), one(), False),
        "C2f_PIG_n4": (lambda: UP.C2f_PIG(64, 64, 4), one(), False),
        "C2f_WT": (lambda: UP.C2f_WT(64, 64, 1, True), one(), False),
        "GhostModuleV2_attn": (lambda: S.GhostModuleV2(64, 64, mode="attn"), one(), False),
        "GhostBottleneckV2": (lambda: S.GhostBottleneckV2(64, 64, 64), one(), False),
        "ASFF_level0": asff(AE.ASFF, 0), "ASFF_level1": asff(AE.ASFF, 1),
        "ASFF_level2": asff(AE.ASFF, 2), "ASFFmobile_level2": asff(AE.ASFFmobile, 2),
        "PSAModule": (lambda: AE.PSAModule(64, 64), one(), False),
        "CPCA": (lambda: AE.CPCA(64, 128), one(), False),
        "Outlooker": (lambda: AB.Outlooker(64, 64, 3, 8), one(), False),
        "EdgeAwareAttentionV2_scalar": (lambda: AS.EdgeAwareAttentionV2(64), one(), False),
        "EdgeAwareAttentionV2_map": (lambda: AS.EdgeAwareAttentionV2(64, alpha_mode="map"),
                                     one(), False),
        "DLUPack": (dlupack_module, one(), False),
        "LoftUp": (lambda: UL.LoftUp(64), lambda b, s: [(b, s // 4, s // 4, 64), (b, s, s, 3)],
                   False),
    }


def _pool_inputs(shapes, device):
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    return [bm.reference_input(shape, device, seed=i) for i, shape in enumerate(shapes)]


def _pool_call(module, xs, as_list):
    return module(xs) if as_list else module(*xs)


def phase_pools(card):
    """Every other module of the pools' last rows card against CPU at
    POOLS_CHECK (TF32 off, within 1e-4 of the CPU's largest), then timed
    with CUDA events at POOLS_TIMED: ms a call, peak bytes, K2's launches a
    call (counts set to 0 before the entry's calls and read after them);
    LDA_AQU and DLUPack then take one forward and backward, which reads
    K2's backward launches. Weights: flax's defaults from seed 0
    (`utils/benchmarks.py` `prepare`; DLUPack's offsets redrawn). No error
    is caught. Returns {entry: its launches a call, entry_train: a forward
    and backward's} for the kernels line."""
    from yolo_dbl_tpu_torch.kernels import launches, reset_launches
    from yolo_dbl_tpu_torch.nn.tasks import init_flax_defaults

    t_start = time.perf_counter()
    rows, counts = {}, {}
    for name, (build, shapes, as_list) in _pool_entries().items():
        cpu = build()
        if name != "DLUPack":  # its offsets are dlupack_module's
            init_flax_defaults(cpu, torch.Generator().manual_seed(0))
        cpu.eval()
        gpu = on_card(cpu)
        small = shapes(*POOLS_CHECK)
        xs = _pool_inputs(small, "cpu")
        with torch.no_grad(), tf32_off():
            want = _pool_call(cpu, xs, as_list).permute(0, 2, 3, 1)
            got = _pool_call(gpu, [x.cuda().contiguous(memory_format=torch.channels_last)
                                   for x in xs], as_list).permute(0, 2, 3, 1).cpu()
        err = max_abs(got, want) / float(want.abs().max())
        require(got.shape == want.shape and bool(torch.isfinite(got).all())
                and err <= CATALOGUE_BAR,
                f"pools {name}: card vs CPU at {small}: {err} of the largest, shape "
                f"{tuple(got.shape)}")
        del cpu
        timed = shapes(*POOLS_TIMED)
        xs = _pool_inputs(timed, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            for _ in range(CATALOGUE_WARMUP):
                out = _pool_call(gpu, xs, as_list)
            start.record()
            for _ in range(CATALOGUE_CALLS):
                out = _pool_call(gpu, xs, as_list)
            end.record()
        end.synchronize()
        calls = CATALOGUE_WARMUP + CATALOGUE_CALLS
        counts[name] = {k: v // calls for k, v in launches.items() if v}
        require(all(v % calls == 0 for v in launches.values())
                and counts[name].get("sample_bilinear", 0) == POOLS_K2.get(name, 0),
                f"pools {name}: K2 launches {dict(launches)} over {calls} calls")
        require(bool(torch.isfinite(out).all()), f"pools {name}: non-finite output")
        rows[name] = dict(inputs=[list(t) for t in timed],
                          out_shape=list(out.permute(0, 2, 3, 1).shape),
                          ms=start.elapsed_time(end) / CATALOGUE_CALLS,
                          peak_bytes=torch.cuda.max_memory_allocated() - base,
                          card_vs_cpu_rel=err, check_inputs=[list(t) for t in small],
                          launches_a_call=counts[name])
        if name in POOLS_K2:  # one forward and backward through K2's backward
            reset_launches()
            _pool_call(gpu, [x.requires_grad_() for x in xs], as_list).square().sum().backward()
            torch.cuda.synchronize()
            counts[f"{name}_train"] = {k: v for k, v in launches.items() if v}
            n = POOLS_K2[name]
            require(counts[f"{name}_train"] == {"sample_bilinear": n,
                                                "sample_bilinear_backward": n},
                    f"pools {name}: a forward and backward launched {dict(launches)}")
            rows[name]["launches_a_train_call"] = counts[f"{name}_train"]
        del gpu, xs, out
        torch.cuda.empty_cache()
    emit({"phase": "pools", "card": card, "calls": CATALOGUE_CALLS, "warmup": CATALOGUE_WARMUP,
          "check": {"batch": POOLS_CHECK[0], "side": POOLS_CHECK[1]},
          "timed": {"batch": POOLS_TIMED[0], "side": POOLS_TIMED[1]}, "bar": CATALOGUE_BAR,
          "entries": rows, "seconds": time.perf_counter() - t_start})
    return counts


# the other structure rows' modules (nn/structures/{blocks,mobile}.py) and
# MobileNetV3-large: each held card against CPU at batch 1 on a quarter of the
# timed side (at least 8 px), and timed at batch 8 on the map of a 640
# detector its source puts it on (P3 80x80, P4 40x40, P5 20x20) at its
# published widths; MobileNetV3-large on 224 images
STRUCTURES_CHECK_B, STRUCTURES_TIMED_B = 1, 8


def _structure_entries():
    """{entry: (build() on the CPU, its NHWC input shapes at batch b and a
    side divided by `div`, whether the inputs go as one list, its source)}."""
    from yolo_dbl_tpu_torch.nn import structures as S

    def at(*maps):
        return lambda b, div: [(b, max(s // div, 8), max(s // div, 8), c) for s, c in maps]

    p3, p4, p5 = 80, 40, 20
    return {
        "Index": (lambda: S.ExtractLayer(1), at((p3, 256), (p4, 512), (p5, 1024)), True,
                  "a level of a P3-P5 list"),
        "UIB": (lambda: S.UIB(160, 160, 3, 3, False, 1, 4.0), at((p4, 160)), False,
                "MobileNetV4-Conv-M stage 4"),
        "MQA": (lambda: S.MQA(160, 4, 64, 64, 1, 1, 2), at((p4, 160)), False,
                "MobileNetV4-Hybrid-M stage 4"),
        "MFA": (lambda: S.MFA((160, 256), 256, 20, 2.0), at((p4, 160), (p5, 256)), True,
                "MobileNetV5's fusion of the last two stages"),
        "RepViTBlock": (lambda: S.RepViTBlock(256, 512, 256, 3, 1, True, True), at((p4, 256)),
                        False, "RepViT-M1.1 stage 3"),
        "GhostModuleV3": (lambda: S.GhostModuleV3(112, 672), at((p4, 112)), False,
                          "GhostNetV3 stage 5's expansion"),
        "GhostBottleneckV3": (lambda: S.GhostBottleneckV3(112, 160, 672, 5, 2, 0.25),
                              at((p4, 112)), False, "GhostNetV3 112 -> 160, s 2"),
        "RepGhostBottleneck": (lambda: S.RepGhostBottleneck(112, 336, 112, 3, 1, 0.25),
                               at((p4, 112)), False, "RepGhostNet-1.0x stage 5"),
        "RepLKBlock": (lambda: S.RepLKBlock(512, 512, 31, 5), at((p4, 512)), False,
                       "RepLKNet-31B stage 3"),
        "GGhostBottleneck": (lambda: S.GGhostBottleneck(408, 408, 1, 24), at((p4, 408)), False,
                             "G-Ghost RegNetX-1.6GF stage 3"),
        # RegNetX-1.6GF's group width 24 leaves the raw blocks' width 198 (JAX's
        # truncations) indivisible by its 8 groups: the module's default 48
        "GGhostStage": (lambda: S.GGhostStage(168, 408, 4, 2, 48, 0.5), at((p3, 168)), False,
                        "G-Ghost RegNetX-1.6GF stage 3, 4 blocks, group width 48"),
        "EffBlock": (lambda: S.EffBlock(160, 160, 9, 1, 6, 1), at((p4, 160)), False,
                     "EfficientNetV2-S stage 5"),
        "MBConv": (lambda: S.MBConv(64, 64, 1, 4.0, False), at((p3, 64)), False,
                   "EfficientNetV2-S fused stage 3"),
        "ScConv": (lambda: S.ScConv(256), at((p3, 256)), False, "ScConv at P3 of 256"),
        "APConv": (lambda: S.APConvPinwheel(128, 256, 3, 2), at((p3, 128)), False,
                   "a pinwheel downsample P3 -> P4"),
        "MobileNetV3_large": (lambda: S.mobilenetv3_large(), at((224, 3)), False,
                              "MobileNetV3-large at 224"),
    }


def phase_structures(card):
    """Every structures entry card against CPU at batch 1 on a quarter of
    the side (TF32 off, within 1e-4 of the CPU's largest), then timed with
    CUDA events at batch 8 at its full shape: ms a call, peak bytes above
    the inputs; no kernel launches (counts set to 0 before the entry's calls
    and read after them). Weights: flax's defaults from seed 0
    (`init_flax_defaults`). No error is caught."""
    from yolo_dbl_tpu_torch.kernels import launches, reset_launches
    from yolo_dbl_tpu_torch.nn.tasks import init_flax_defaults

    t_start = time.perf_counter()
    rows = {}
    for name, (build, shapes, as_list, source) in _structure_entries().items():
        cpu = build()
        init_flax_defaults(cpu, torch.Generator().manual_seed(0))
        cpu.eval()
        gpu = on_card(cpu)
        small = shapes(STRUCTURES_CHECK_B, 4)
        xs = _pool_inputs(small, "cpu")
        with torch.no_grad(), tf32_off():
            want = _pool_call(cpu, xs, as_list)
            got = _pool_call(gpu, [x.cuda().contiguous(memory_format=torch.channels_last)
                                   for x in xs], as_list).cpu()
        err = max_abs(got, want) / float(want.abs().max())
        require(got.shape == want.shape and bool(torch.isfinite(got).all())
                and err <= CATALOGUE_BAR,
                f"structures {name}: card vs CPU at {small}: {err} of the largest, shape "
                f"{tuple(got.shape)}")
        del cpu
        timed = shapes(STRUCTURES_TIMED_B, 1)
        xs = _pool_inputs(timed, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            for _ in range(CATALOGUE_WARMUP):
                out = _pool_call(gpu, xs, as_list)
            start.record()
            for _ in range(CATALOGUE_CALLS):
                out = _pool_call(gpu, xs, as_list)
            end.record()
        end.synchronize()
        require(not any(launches.values()), f"structures {name}: launches {dict(launches)}")
        require(bool(torch.isfinite(out).all()), f"structures {name}: non-finite output")
        rows[name] = dict(source=source, inputs=[list(t) for t in timed],
                          out_shape=list(out.shape), ms=start.elapsed_time(end) / CATALOGUE_CALLS,
                          peak_bytes=torch.cuda.max_memory_allocated() - base,
                          params=sum(p.numel() for p in gpu.parameters()),
                          card_vs_cpu_rel=err, check_inputs=[list(t) for t in small])
        del gpu, xs, out
        torch.cuda.empty_cache()
    emit({"phase": "structures", "card": card, "calls": CATALOGUE_CALLS,
          "warmup": CATALOGUE_WARMUP, "check_batch": STRUCTURES_CHECK_B,
          "timed_batch": STRUCTURES_TIMED_B, "bar": CATALOGUE_BAR, "entries": rows,
          "seconds": time.perf_counter() - t_start})


def dattention_sites(device="cuda", shapes=None):
    """{site: (x, gy, gx)}: K2's inputs in the catalogue's DeBiAttention_YOLO
    (seed 0's weights, as the catalogue draws them) on its reference and
    quick inputs: x the NHWC input, gy and gx (B, Hk·Wk, 2) the pixel
    coordinates of its two channel groups, from DAttention's offset network
    (`DAttention.grid`, clipped) through `pixel_coords`, as its forward
    hands them to the sampler."""
    from yolo_dbl_tpu_torch.nn.attention.bigarch import DeBiAttention_YOLO
    from yolo_dbl_tpu_torch.ops.resample import pixel_coords
    from yolo_dbl_tpu_torch.utils import benchmarks as bm

    deform = bm.prepare(DeBiAttention_YOLO(64, 64, num_heads=4), device).attn.deform
    shapes = shapes or {"reference": bm.ATTENTION_SHAPE, "quick": bm.ATTENTION_QUICK_SHAPE}
    out = {}
    for site, (b, h, w, c) in shapes.items():
        x = bm.reference_input((b, h, w, c), device)
        with torch.no_grad():
            grid = deform.grid(deform.proj_q(x))
        gy, gx = pixel_coords(grid, h, w)
        g = grid.shape[-1]
        out[site] = (x.permute(0, 2, 3, 1).contiguous(), gy.reshape(b, -1, g).contiguous(),
                     gx.reshape(b, -1, g).contiguous())
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from yolo_dbl_tpu_torch.kernels import attention, build, preprocess, sampling

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    report = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                        if "entry function" in ln or "registers" in ln or "spill" in ln]
                    for k, v in report.items()},
          "dynamic_shared_bytes": {
              "letterbox_kernel": {str(dt).split(".")[-1]: preprocess.shared_bytes(
                  SRC_HW, (IMGSZ, IMGSZ), B, out_dtype=dt) for dt in (torch.float32, torch.bfloat16)},
              **attention.shared_bytes(),
              "sample_bilinear_backward_kernel": {
                  **{f"C/G={c // GROUPS}": sampling.backward_shared_bytes(c, GROUPS)
                     for c in sorted({c for _, _, c in (*DYSAMPLE_SITES.values(),
                                                        *DBL2_SITES.values())})},
                  "C/G=32 (MSDeformAttn)": sampling.backward_shared_bytes(256, RTDETR_HEADS)}},
          "card": card, "sm_clock_max_mhz": sm_clock_max_mhz(),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    gen = torch.Generator().manual_seed(0)
    rows = []
    with took("rtdetr_sites"):
        # RT-DETR-l's weights, drawn once for the K2 sites and its float32 path
        seeded_rtdetr = seeded_model(RTDETR)
        deform = rtdetr_sites(on_card(seeded_rtdetr), np.random.default_rng(10))
        torch.cuda.empty_cache()
    with took("lda_sites"):
        # LDA-DBL-s's weights, drawn once for the K2 sites and its path
        seeded_lda = seeded_model(LDA)
        lsites = lda_sites(on_card(seeded_lda), np.random.default_rng(11))
        torch.cuda.empty_cache()
    with took("dattention_sites"):
        dsites = dattention_sites()
        psites = dlupack_sites()
    with took("kernels"):
        for dtype, k1_row in zip((torch.float32, BF16), phase_k1(gen)):
            f32 = dtype == torch.float32
            k2_row = phase_k2(gen, dtype, deform[B] if f32 else None, dsites if f32 else None,
                              lsites[B] if f32 else None, psites if f32 else None)
            k2_backward_row, k2_train_err = phase_k2_backward(
                gen, dtype, deform[TRAIN_B] if f32 else None, dsites if f32 else None,
                lsites[TRAIN_B] if f32 else None, psites if f32 else None)
            k3_row = phase_k3(gen, dtype)
            k3_dkv_row, k3_dq_row, k3_train_err = phase_k3_backward(gen, dtype)
            for row, train_err in ((k2_row, k2_train_err), (k3_row, k3_train_err)):
                row["max_abs_err_by_path"] = {"serve": row["max_abs_err"], "train": train_err}
                row["max_abs_err"] = max(row["max_abs_err"], train_err)
            rows += [k1_row, k2_row, k2_backward_row, k3_row, k3_dkv_row, k3_dq_row]
    del dsites, lsites, psites
    torch.cuda.empty_cache()
    with took("catalogue"):
        catalogue = phase_catalogue(card)
    with took("pools"):
        pools = phase_pools(card)
    with took("structures"):
        phase_structures(card)
    for row in rows:  # K2's launches a call of DAttention's module (forward; or a train call)
        if "dattention_sites" in row:
            row["dattention_sites"]["launches_a_call"] = catalogue[
                "DeBiAttention_YOLO_train" if "backward" in row["name"]
                else "DeBiAttention_YOLO"].get(row["name"], 0)
        if "dlupack_sites" in row:
            row["dlupack_sites"]["launches_a_call"] = pools[
                "DLUPack_train" if "backward" in row["name"] else "DLUPack"].get(row["name"], 0)
    rng = np.random.default_rng(0)
    serve, train, models = {}, {}, {}
    paths = (DBL, LDA, V13, DBL2, V12, V11, V10, V9, V7, SEG, POSE, CLS, OBB, WORLD, EMAC,
             RTDETR, SWIN)
    for cfg in paths:
        for dtype in ((torch.float32,) if cfg in (LDA, V11, V9, V7, POSE, CLS, SWIN)
                      else (torch.float32, BF16)):
            with took(_phase("path", cfg, dtype)):
                # drawn once for serving and training
                seeded = {(RTDETR, torch.float32): seeded_rtdetr,
                          (LDA, torch.float32): seeded_lda}.get((cfg, dtype))
                if seeded is None:
                    seeded = seeded_model(cfg, dtype)
                cpu_model, gpu_model = build_models(cfg, dtype, seeded=seeded)
                serve[cfg, dtype], frames, predictor, median_ms = phase_main(cfg, gpu_model, rng,
                                                                             card)
                phase_profile(cfg, predictor, rng, median_ms * 1e3)
                # IDetect and Classify do not train (no JAX loss for them); YOLO-EMAC
                # and RT-DETR train in float32 only
                if cfg not in (V7, CLS) and (cfg, dtype) not in ((EMAC, BF16), (RTDETR, BF16)):
                    train[cfg, dtype] = phase_train(cfg, card, dtype, seeded)
                del seeded
                models[cfg, dtype] = (cpu_model, gpu_model, frames)
    del seeded_rtdetr, seeded_lda
    with took("parity"):
        for cfg in paths:
            if cfg == OBB:
                phase_parity_obb(cfg, *models[cfg, torch.float32])
            elif cfg == RTDETR:
                phase_parity_rtdetr(cfg, *models[cfg, torch.float32])
            elif cfg in (SEG, POSE, CLS):
                phase_parity_task(cfg, *models[cfg, torch.float32])
            else:
                phase_parity(cfg, *models[cfg, torch.float32])
    with took("parity_bf16"):
        for cfg in (DBL, V13, DBL2, V12, V10, SEG, WORLD, RTDETR):
            cpu32, _, frames = models[cfg, torch.float32]
            cpu16, gpu16, _ = models[cfg, BF16]
            (phase_parity_bf16_rtdetr if cfg == RTDETR else phase_parity_bf16)(
                cfg, cpu32, cpu16, gpu16, frames)
    with took("train_parity"):
        for model in models[RTDETR, torch.float32][:2]:
            rtdetr_anchor_boxes(model)
        for cfg in (DBL, LDA, V13, V12, V10, SEG, POSE, OBB, WORLD, EMAC, RTDETR, SWIN):
            phase_train_parity(cfg, *models[cfg, torch.float32][:2])
        phase_train_parity_decoder(RTDETR, *models[RTDETR, torch.float32][:2])
    with took("train_parity_bf16"):
        for cfg in (DBL, V13, V12, V10):
            phase_train_parity_bf16(cfg, models[cfg, torch.float32][0], *models[cfg, BF16][:2])
    with took("facade_rtdetr"):
        phase_facade_rtdetr(card, models[RTDETR, torch.float32][1])
    del models
    with took("val"):
        cpu32, f32_metrics, val = phase_val(card)
        _, _, val_bf16 = phase_val(card, BF16, cpu32, f32_metrics)
    with took("v8"):
        phase_v8(card)
    with took("facade"):
        facade = phase_facade(card)
    with took("converge"):
        converge = phase_converge(card)
    with took("family"):
        family = phase_family(card)
    with took("zoo"):
        zoo = phase_zoo(card)
    with took("zoo_v9v10"):
        zoo.update(phase_zoo(card, ZOO_V9V10, "zoo_v9v10"))
    with took("zoo_tasks"):
        zoo.update(phase_zoo_tasks(card))
    with took("zoo_pools"):
        zoo.update(phase_zoo(card, ZOO_POOLS, "zoo_pools"))
    with took("zoo_rtdetr"):
        zoo.update(phase_zoo(card, ZOO_RTDETR, "zoo_rtdetr"))
    with took("facade_dbl2"):
        facade.update(phase_facade_dbl2(card))
    with took("facade_tasks"):
        facade.update(phase_facade_tasks(card))
    with took("dp"):
        dp = phase_dp(card)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        with took("parallel_models"):
            setup = _parallel_models(tmp)
        with took("tp"):
            tp = phase_tp(card, tmp, setup)
        with took("sp"):
            sp = phase_sp(card, setup)
        del setup
    # launches: per the path's run (5 requests; 5 train steps) on the path each row serves
    f32, bf16 = torch.float32, BF16
    home = {"letterbox_normalize": serve[DBL, f32], "sample_bilinear": serve[DBL, f32],
            "sample_bilinear_backward": train[DBL, f32], "area_attention": serve[V13, f32],
            "area_attention_backward_dkv": train[V13, f32],
            "area_attention_backward_dq": train[V13, f32],
            "letterbox_normalize_bf16": serve[DBL, bf16], "sample_bilinear_bf16": serve[DBL, bf16],
            "sample_bilinear_backward_bf16": train[DBL, bf16],
            "area_attention_bf16": serve[V13, bf16],
            "area_attention_backward_dkv_bf16": train[V13, bf16],
            "area_attention_backward_dq_bf16": train[V13, bf16]}
    for row in rows:
        name = row["name"]
        if "lda_dbl_s_sites" in row:  # K2's launches in LDA-DBL-s's timed requests or steps
            runs = train if "backward" in row["name"] else serve
            row["lda_dbl_s_sites"]["launches_on_path"] = runs[LDA, f32][name]
        row["launches"] = home[name][name]
        require(row["launches"] > 0, f"{name} was not launched on its path")
        row["launches_by_path"] = {_phase(path, cfg, dt): counts[name]
                                   for path, runs in (("serve", serve), ("train", train))
                                   for (cfg, dt), counts in runs.items()}
        row["launches_by_path"].update(val=val[name], val_bf16=val_bf16[name],
                                       converge=converge[name],
                                       **{path: runs[name] for path, runs in facade.items()},
                                       **{f"family_{cfg[9:-5]}": runs.get(name, 0)
                                          for cfg, runs in family.items()},
                                       **{f"zoo_{cfg[:-5]}": runs[name]
                                          for cfg, runs in zoo.items()},
                                       **{f"dp_{path}": runs.get(name, 0)
                                          for path, runs in dp.items()},
                                       **{f"tp_{path}": runs.get(name, 0)
                                          for path, runs in tp.items()},
                                       **{f"sp_{path}": runs.get(name, 0)
                                          for path, runs in sp.items()},
                                       **{f"catalogue_{entry}": runs.get(name, 0)
                                          for entry, runs in catalogue.items()},
                                       **{f"pools_{entry}": runs.get(name, 0)
                                          for entry, runs in pools.items()})
    # how often torch.profiler's trace had to be taken again, or gave way
    # to CUDA-event time (each row's `time_sources` says which it holds)
    emit({"phase": "timing", **TRACES, "seconds": SECONDS})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
